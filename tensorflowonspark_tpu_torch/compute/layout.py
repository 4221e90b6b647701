"""The sharding layout table: the one source of placements (port of
:mod:`tensorflowonspark_tpu.compute.layout`).

The tables are the JAX package's, copied as literals
(``tests/test_torch_layout.py`` pins them equal): :data:`LAYOUT_TABLES`
maps a parameter's path to a spec, :data:`ACTIVATION_SPECS` names the
activation and input specs by role. A *spec* is what a JAX
``PartitionSpec`` holds, as a plain tuple: one entry per tensor dim, each
``None``, an axis name, or a tuple of axis names (their extents multiply,
the first one outermost).

The rule engine (:class:`SpecLayout`, :func:`optimizer_state_spec`) is the
JAX package's, returning spec tuples. :func:`sharding` turns a spec into
the DTensor placements over a mesh (:class:`Sharding`): one placement per
mesh dim, ``Shard(d)`` where the spec puts that axis on tensor dim ``d``
and the axis is wider than 1, else ``Replicate()``.

Paths and shapes are the JAX leaves': a table names flax paths
(``layer0/attn/q_proj/kernel``) and gives specs for ``(in, out)``
kernels. :func:`param_shardings` takes a ``view`` that maps each port
parameter to its JAX leaf (``models.convert.jax_leaf``) and permutes the
spec back onto the port's dims, so the tables stay the only source.

The decode and serve cache specs wait for ROADMAP A9b.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Mapping, NamedTuple

# - ``data``  — pure data parallel (replicated params, sharded batch)
# - ``fsdp``  — data parallel with sharded params/optimizer state
# - ``pipe``  — pipeline parallel (ROADMAP A10)
# - ``expert`` — expert parallel (ROADMAP A10)
# - ``model`` — tensor parallel (Megatron column/row shardings)
# - ``seq``   — sequence/context parallel (ROADMAP A10)
MESH_AXES = ("data", "fsdp", "pipe", "expert", "model", "seq")

# Batch dimension shards over every data-like axis.
BATCH_AXES = ("data", "fsdp")

# Rule keys (as in the JAX package):
#   pattern    — regex, re.search()ed against the '/'-joined param path
#   spec       — per-dim axis assignment: an axis name, None, or a
#                tuple of axis names (multi-axis dim)
#   ndim       — rule applies only to leaves of exactly this rank
#   max_ndim   — … of at most this rank
#   divisible  — "strict" (default): the spec applies as it is, and
#                divisibility is the caller's contract; "require": the
#                rule matches only if every named dim divides its axis
#                extent, else the next rule is tried; "drop_or_unit":
#                keep the rule but null out any axis whose extent is 1
#                or does not divide the dim.
# First match wins; every table ends in a catch-all.

LAYOUT_TABLES = {
    # Megatron layout on ('fsdp', 'model'); biases/norms replicated.
    # With mesh model=1 this degrades to pure FSDP (the Llama-2-7B
    # baseline config); with fsdp=1 to pure TP. LoRA factors inside a
    # wrapped kernel: the base shards like the kernel it replaces; 'a'
    # (in, r) keeps the input half of the base pair, 'b' (r, out) the
    # output half — consistent with the TP math (the rank dim stays
    # replicated; it is tiny by construction). For a multi-LoRA BANK
    # the same halves apply behind the leading K slots dim (replicated
    # — every chip serves every adapter).
    "llama": (
        {"pattern": r".*", "max_ndim": 1, "spec": ()},
        # LoRA 'a' factors: input half of the enclosing kernel's pair
        {"pattern": r".*(o_proj|down_proj).*/a$", "ndim": 2,
         "spec": ("model", None)},
        {"pattern": r".*/a$", "ndim": 2, "spec": ("fsdp", None)},
        {"pattern": r".*(o_proj|down_proj).*/a$", "ndim": 3,
         "spec": (None, "model", None)},
        {"pattern": r".*/a$", "ndim": 3, "spec": (None, "fsdp", None)},
        # LoRA 'b' factors: output half
        {"pattern":
         r".*(embed|lm_head|q_proj|k_proj|v_proj|gate_proj|up_proj).*/b$",
         "ndim": 2, "spec": (None, "model")},
        {"pattern": r".*(o_proj|down_proj).*/b$", "ndim": 2,
         "spec": (None, "fsdp")},
        {"pattern": r".*/b$", "ndim": 2, "spec": ()},
        {"pattern":
         r".*(embed|lm_head|q_proj|k_proj|v_proj|gate_proj|up_proj).*/b$",
         "ndim": 3, "spec": (None, None, "model")},
        {"pattern": r".*(o_proj|down_proj).*/b$", "ndim": 3,
         "spec": (None, None, "fsdp")},
        {"pattern": r".*/b$", "ndim": 3, "spec": ()},
        # MoE expert banks are the remaining ndim-3 leaves: stacked dim
        # on 'expert', FFN hidden on 'model', the rest on 'fsdp'
        {"pattern": r".*w_down.*", "ndim": 3,
         "spec": ("expert", "model", "fsdp")},
        {"pattern": r".*", "ndim": 3, "spec": ("expert", "fsdp", "model")},
        {"pattern": r".*router.*", "spec": ()},
        # column-parallel projections
        {"pattern":
         r".*(embed|lm_head|q_proj|k_proj|v_proj|gate_proj|up_proj).*",
         "spec": ("fsdp", "model")},
        # row-parallel projections
        {"pattern": r".*(o_proj|down_proj).*", "spec": ("model", "fsdp")},
        {"pattern": r".*", "spec": ("fsdp", None)},
    ),
    # Megatron-style rules keyed on bert param names; a rule whose
    # named dims don't divide the mesh extents falls through.
    "bert": (
        {"pattern": r".*(query|key|value|ffn_in).*", "ndim": 2,
         "spec": ("fsdp", "model"), "divisible": "require"},
        {"pattern": r".*(attn_out|ffn_out).*", "ndim": 2,
         "spec": ("model", "fsdp"), "divisible": "require"},
        {"pattern": r".*", "ndim": 2, "spec": ("fsdp", None),
         "divisible": "require"},
        {"pattern": r".*", "spec": ()},
    ),
    # 2D kernels over ('fsdp','model'); a dim that does not divide its
    # mesh axis (or whose axis extent is 1) falls back to replication
    # for THAT dim (e.g. the (hidden, 10) classifier head under
    # model>1) rather than erroring at device_put.
    "vit": (
        {"pattern": r".*", "ndim": 2, "spec": ("fsdp", "model"),
         "divisible": "drop_or_unit"},
        {"pattern": r".*", "ndim": 4,  # patch-embed conv kernel
         "spec": (None, None, None, "model"), "divisible": "drop_or_unit"},
        {"pattern": r".*", "spec": ()},
    ),
    # FSDP rules: shard large kernels' output-channel dim over 'fsdp';
    # replicate BN scale/bias (tiny). Shared by resnet/inception/vgg.
    "resnet": (
        {"pattern": r".*", "ndim": 4, "spec": (None, None, None, "fsdp"),
         "divisible": "require"},
        {"pattern": r".*", "ndim": 2, "spec": ("fsdp", None),
         "divisible": "require"},
        {"pattern": r".*", "spec": ()},
    ),
    # conv kernels' output channels over 'fsdp' where divisible.
    "unet": (
        {"pattern": r".*", "ndim": 4, "spec": (None, None, None, "fsdp"),
         "divisible": "require"},
        {"pattern": r".*", "spec": ()},
    ),
    # MoEMLP param tree: expert banks on ('expert','fsdp'/'model'),
    # router replicated. llama's ndim-3 rules delegate here in spirit —
    # the two tables MUST stay in lockstep (tests/test_layout.py pins
    # them equal).
    "moe": (
        {"pattern": r".*w_down.*", "ndim": 3,
         "spec": ("expert", "model", "fsdp")},
        {"pattern": r".*", "ndim": 3, "spec": ("expert", "fsdp", "model")},
        {"pattern": r".*", "spec": ()},
    ),
    # Optimizer-state rules — the ZeRO-style cross-replica weight-update
    # partition (PAPERS.md, arXiv 2004.13336). Patterns match the
    # '/'-joined opt-state field path PREFIXED to the param path (an
    # Adam moment for a wrapped kernel reads '0/mu/layer0/attn/q_proj/
    # kernel'); unlike the model tables above, a matching rule's spec is
    # MERGED onto the param leaf's own table spec dim-by-dim by
    # :func:`optimizer_state_spec` — the rule names the EXTRA axes the
    # state leaf shards over, not its full layout. Per-param state
    # (Adam moments mu/nu, mixed-precision fp32 masters, SGD momentum
    # traces — and the in-step gradient 'update' tensors feeding them)
    # additionally partitions its leading dim over the 'data' replica
    # axis, so the weight update computes on 1/data_extent of each leaf
    # instead of redundantly on every replica; 'drop_or_unit' keeps the
    # existing divisibility semantics — an indivisible (or data=1) leaf
    # drops back to mirroring its param. Scalars (Adam's bias-correction
    # 'count') and any undeclared field mirror/replicate unchanged.
    "optimizer": (
        {"pattern": r".*", "max_ndim": 0, "spec": ()},
        {"pattern": r"(^|/)(mu|nu|master|trace|momentum|update)(/|$)",
         "spec": ("data",), "divisible": "drop_or_unit"},
        {"pattern": r".*", "spec": ()},
    ),
}

# The optimizer table's per-param-state field pattern, for the code that
# needs the role without a shape (train.state_shardings). It must stay
# textually equal to the 'optimizer' table's rule above.
OPTIMIZER_PARAM_STATE_PATTERN = (
    r"(^|/)(mu|nu|master|trace|momentum|update)(/|$)"
)

# Activation / host-IO placements, by role.
ACTIVATION_SPECS = {
    # leading (batch) dim over every data-like axis, rest replicated
    "batch": (("data", "fsdp"),),
    # (B, S) token prompts: batch on 'data', positions replicated
    "prompt": ("data", None),
    # (B,) per-row planes (prompt lengths, row flags)
    "per_row": ("data",),
    # scalars / rng keys / whole-tree replication
    "replicated": (),
    # (B, S, H, D) attention operands under mesh flash-attention
    # shard_map: batch over the data axes, heads TP on 'model'
    "attn_bshd": (("data", "fsdp"), None, "model", None),
}


# ---------------------------------------------------------------------------
# rule engine
# ---------------------------------------------------------------------------


def _axis_extent(axis_sizes: Mapping[str, int], entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        return math.prod(_axis_extent(axis_sizes, a) for a in entry)
    return int(axis_sizes.get(entry, 1))


def _apply_divisibility(
    spec: tuple, shape: tuple, axis_sizes: Mapping[str, int], mode: str
) -> tuple | None:
    """Resolve a rule's spec against a leaf shape. Returns the concrete
    spec tuple, or None when mode='require' and a named dim does not
    divide (the rule falls through)."""
    if mode == "strict":
        return spec
    out = []
    for d, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        extent = _axis_extent(axis_sizes, entry)
        size = shape[d] if d < len(shape) else 0
        if mode == "require":
            if extent and size % extent:
                return None
            out.append(entry)
        elif mode == "drop_or_unit":
            out.append(entry if extent > 1 and size % extent == 0 else None)
        else:
            raise ValueError(f"unknown divisibility mode {mode!r}")
    return tuple(out)


class SpecLayout:
    """One compiled layout table: pattern rules, first match wins."""

    def __init__(self, name: str, rules: tuple):
        self.name = name
        self._rules = tuple(
            (
                re.compile(r["pattern"]),
                tuple(r["spec"]),
                r.get("ndim"),
                r.get("max_ndim"),
                r.get("divisible", "strict"),
            )
            for r in rules
        )

    def spec(self, path_name: str, shape: tuple,
             axis_sizes: Mapping[str, int] | None = None) -> tuple:
        """The spec of one leaf: the first rule whose pattern matches
        ``path_name`` and whose rank filter admits ``shape`` (subject to
        the rule's divisibility mode)."""
        ndim = len(shape)
        axis_sizes = axis_sizes or {}
        for pat, spec, r_ndim, r_max, divisible in self._rules:
            if r_ndim is not None and ndim != r_ndim:
                continue
            if r_max is not None and ndim > r_max:
                continue
            if not pat.search(path_name):
                continue
            resolved = _apply_divisibility(spec, shape, axis_sizes, divisible)
            if resolved is None:
                continue  # 'require' rule fell through
            return resolved
        raise ValueError(
            f"layout table {self.name!r} has no rule for {path_name!r} "
            f"(shape {shape}); tables must end in a catch-all"
        )


_LAYOUTS: dict[str, SpecLayout] = {}


def get_layout(name: str) -> SpecLayout:
    """The compiled :class:`SpecLayout` for one table (cached)."""
    layout = _LAYOUTS.get(name)
    if layout is None:
        try:
            rules = LAYOUT_TABLES[name]
        except KeyError:
            raise KeyError(
                f"unknown layout table {name!r}; declared: {sorted(LAYOUT_TABLES)}"
            ) from None
        layout = _LAYOUTS[name] = SpecLayout(name, rules)
    return layout


def _dim_axes(entry) -> tuple:
    """One spec dim entry as a flat tuple of axis names."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def optimizer_state_spec(path_name: str, shape: tuple, base_spec: tuple,
                         axis_sizes: Mapping[str, int] | None = None) -> tuple:
    """The spec of one optimizer-state leaf: the 'optimizer' table's first
    matching rule merged onto the leaf's mirrored param spec
    (``base_spec``) dim by dim.

    A rule dim naming an axis prepends that axis to the base dim's axes;
    under ``drop_or_unit`` it is kept only when its extent is > 1 and the
    dim divides the combined extent, else the dim keeps the base. A leaf
    where nothing merged returns the base as it is, so that it compares
    equal to its param's spec.
    """
    axis_sizes = axis_sizes or {}
    base = tuple(base_spec)
    ndim = len(shape)
    for pat, spec, r_ndim, r_max, divisible in get_layout("optimizer")._rules:
        if r_ndim is not None and ndim != r_ndim:
            continue
        if r_max is not None and ndim > r_max:
            continue
        if not pat.search(path_name):
            continue
        out = []
        fell_through = False
        changed = False
        for d in range(ndim):
            base_entry = base[d] if d < len(base) else None
            add = spec[d] if d < len(spec) else None
            base_axes = _dim_axes(base_entry)
            if add is None or add in base_axes:
                out.append(base_entry)
                continue
            add_extent = _axis_extent(axis_sizes, add)
            combined = add_extent * _axis_extent(axis_sizes, base_axes or None)
            divides = combined > 0 and shape[d] % combined == 0
            if divisible == "drop_or_unit":
                if add_extent <= 1 or not divides:
                    out.append(base_entry)
                    continue
            elif divisible == "require":
                if not divides:
                    fell_through = True
                    break
            out.append((add, *base_axes) if base_axes else add)
            changed = True
        if fell_through:
            continue
        if not changed:
            return base
        while out and out[-1] is None:
            out.pop()
        return tuple(out)
    raise ValueError(
        f"optimizer layout table has no rule for {path_name!r} "
        f"(shape {shape}); tables must end in a catch-all"
    )


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------


class Sharding(NamedTuple):
    """A spec and its DTensor placements over ``mesh``, a
    :func:`dtensor_mesh` (the port's ``NamedSharding``)."""

    mesh: object
    spec: tuple
    placements: tuple


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis: extent}`` of a ``DeviceMesh`` with named dims (all six for a
    mesh of ``compute.mesh.make_mesh``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def dtensor_mesh(mesh):
    """The mesh that DTensors are placed on: ``mesh`` cut to its axes wider
    than 1 (``data`` alone when none is). DTensor expands each operator's
    sharding strategies over every mesh dim, a cost that grows as a power
    of the dim count: on all six names one indexing op took longer than
    20 s on the CPU. The axes of extent 1 shard nothing, so dropping them
    changes no placement."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if tuple(names) != MESH_AXES:
        return mesh  # already cut (or a mesh of the caller's own)
    sub = _SUBMESHES.get(id(mesh))
    if sub is None or sub[0] is not mesh:
        sizes = axis_sizes(mesh)
        keep = tuple(a for a in MESH_AXES if sizes[a] > 1) or ("data",)
        sub = _SUBMESHES[id(mesh)] = (mesh, mesh[keep])
    return sub[1]


_SUBMESHES: dict[int, tuple] = {}


def drop_submeshes() -> None:
    """Forget every cut mesh: after the process group is destroyed and
    joined again (an elastic rebind) they span a group that is gone."""
    _SUBMESHES.clear()


def placements(mesh, spec: tuple) -> tuple:
    """The DTensor placements of ``spec`` over ``dtensor_mesh(mesh)``:
    ``Shard(d)`` on each of its dims that the spec puts on tensor dim
    ``d``, ``Replicate()`` on the others (an axis missing from it has
    extent 1). Axes that share a tensor dim must come in the mesh's order
    (DTensor shards them outermost first, as JAX does the spec's order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(dtensor_mesh(mesh).mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _dim_axes(entry)
        for a in axes:
            if a not in MESH_AXES:
                raise ValueError(f"spec {spec} names an unknown axis {a!r}")
        order = [MESH_AXES.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not in mesh order")
        for a in axes:
            if a in names:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def sharding(mesh, spec: tuple) -> Sharding:
    """Wrap a spec for ``mesh``: the placements are over
    :func:`dtensor_mesh`, which ``Sharding.mesh`` holds."""
    spec = tuple(spec)
    return Sharding(dtensor_mesh(mesh), spec, placements(mesh, spec))


def check_divisible(name: str, shape: tuple, spec: tuple, sizes: Mapping[str, int]) -> None:
    """Raise unless every sharded dim of ``shape`` divides its extent (JAX
    refuses such a placement at ``device_put``; DTensor would pad)."""
    for d, entry in enumerate(spec):
        extent = _axis_extent(sizes, entry)
        if d < len(shape) and shape[d] % extent:
            raise ValueError(
                f"{name}: dim {d} of shape {tuple(shape)} does not divide "
                f"over {entry!r} (extent {extent})"
            )


# view(port name, port shape) -> (JAX path, JAX shape, perm) with port dim i
# = JAX dim perm[i]; None keeps the name, the shape and the dims
LeafView = Callable[[str, tuple], tuple]


def leaf_spec(table: SpecLayout, name: str, shape: tuple, sizes: Mapping[str, int],
              view: LeafView | None = None) -> tuple:
    """The spec of one port parameter: the table's spec of its JAX leaf,
    permuted onto the port's dims."""
    if view is None:
        return table.spec(name, tuple(shape), sizes)
    path, jax_shape, perm = view(name, tuple(shape))
    jspec = table.spec(path, tuple(jax_shape), sizes)
    jspec = tuple(jspec) + (None,) * (len(jax_shape) - len(jspec))
    return tuple(jspec[p] for p in perm)


def param_specs(params: Mapping, sizes: Mapping[str, int], layout: str | SpecLayout,
                view: LeafView | None = None) -> dict[str, tuple]:
    """``{name: spec}`` for a dict of parameters from one table, given only
    the axis extents (no mesh, no process group)."""
    table = layout if isinstance(layout, SpecLayout) else get_layout(layout)
    return {n: leaf_spec(table, n, tuple(p.shape), sizes, view) for n, p in params.items()}


def param_shardings(params: Mapping, mesh, layout: str | SpecLayout,
                    view: LeafView | None = None) -> dict[str, Sharding]:
    """``{name: Sharding}`` for a dict of parameters from one table, over
    a mesh of ``compute.mesh.make_mesh``."""
    sizes = axis_sizes(mesh)
    return {n: sharding(mesh, s) for n, s in param_specs(params, sizes, layout, view).items()}


# ---------------------------------------------------------------------------
# role helpers
# ---------------------------------------------------------------------------


def activation_spec(role: str, ndim: int | None = None) -> tuple:
    """The declared activation/IO spec for one role; ``ndim`` pads
    trailing dims with None."""
    try:
        spec = ACTIVATION_SPECS[role]
    except KeyError:
        raise KeyError(
            f"unknown activation role {role!r}; declared: {sorted(ACTIVATION_SPECS)}"
        ) from None
    if ndim is not None and ndim > len(spec):
        spec = tuple(spec) + (None,) * (ndim - len(spec))
    return tuple(spec)


def batch_spec(ndim: int = 1) -> tuple:
    """Batch leaf: leading dim over ('data', 'fsdp'), rest replicated."""
    return activation_spec("batch", ndim)


def batch_sharding(mesh, ndim: int = 1) -> Sharding:
    return sharding(mesh, batch_spec(ndim))


def replicated(mesh) -> Sharding:
    return sharding(mesh, ())


def expert_bank_spec(param_name: str) -> tuple:
    """The spec of one 3-dim MoE expert bank leaf (a flax path), from the
    'moe' table: the one source, which the 'llama' table's ndim-3 rules
    repeat so that model-level and module-level specs cannot diverge."""
    return get_layout("moe").spec(param_name, (0, 0, 0))


def fsdp_leaf_spec(shape: tuple, n_shard: int, axis: str = "fsdp",
                   min_shard_elements: int = 1024) -> tuple:
    """The generic shape-driven FSDP rule: shard the largest dim divisible
    by the fsdp extent; tiny tensors (biases, norms) stay replicated."""
    if n_shard == 1 or math.prod(shape) < min_shard_elements:
        return ()
    for d in sorted(range(len(shape)), key=lambda i: shape[i], reverse=True):
        if shape[d] % n_shard == 0:
            spec = [None] * len(shape)
            spec[d] = axis
            return tuple(spec)
    return ()


def tp_only(mesh, sh: Sharding) -> Sharding:
    """Project a sharding onto the 'model' (TP) axis only: the serving
    engine's weight placement (ROADMAP A9b)."""

    def keep(ax):
        if isinstance(ax, (tuple, list)):
            kept = tuple(a for a in ax if a == "model")
            return kept[0] if kept else None
        return ax if ax == "model" else None

    return sharding(mesh, tuple(keep(ax) for ax in sh.spec))
