"""PyTorch/CUDA port of :mod:`tensorflowonspark_tpu`, held to it as the reference.

The first slice is the single-GPU Llama training step:
``models.llama`` → ``ops.attention`` → ``ops.flash_attention`` (hand-written
CUDA kernels in ``csrc/``) → ``compute.optim`` → ``compute.train``.
Importing the package imports nothing heavy and builds no kernel.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. With no CUDA device and no ``device`` given this raises: the
    port never moves to the CPU quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
