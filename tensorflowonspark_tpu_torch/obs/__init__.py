"""Observability (copies of the JAX package's ``obs`` modules): host
spans (:mod:`.spans`, bridged into ``torch.profiler`` ranges), the
metrics registry (:mod:`.registry`), the cluster plane (:mod:`.cluster`),
the failure flight recorder (:mod:`.flightrec`) and request tracing
(:mod:`.reqtrace`)."""
