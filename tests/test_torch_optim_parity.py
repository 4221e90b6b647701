"""The port's ``warmup_cosine_decay_schedule`` and ``clip_by_global_norm``
against optax's, which the JAX package's Llama example chains in front of
its optimizer.

The schedule is held over 130 counts, past the end of the decay, to 1e-6
relative: both sides compute in fp32 and differ by at most one rounding
of the cosine (3e-8 relative when this was written). Where optax refuses
a schedule (``decay_steps`` not above ``warmup_steps``) the port raises
``ValueError`` too. The clip is held on random trees above and below the
norm to 1e-6 relative: both scale every leaf by the same fp32 factor.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_tpu_torch.compute import optim

SCHEDULES = [
    (0.0, 1e-4, 10, 100, 1e-5),
    (0.0, 1.0, 5, 50, 0.1),
    (0.5, 1.0, 0, 20, 0.0),  # no warm-up
    (0.0, 0.0, 3, 10, 0.2),  # peak 0: optax's alpha is 0
    (1e-3, 3e-4, 7, 23, 1e-6),  # warm-up downwards
    (0.0, 3e-4, 1, 2, 3e-5),
]


@pytest.mark.parametrize("args", SCHEDULES, ids=lambda a: "-".join(map(str, a)))
def test_warmup_cosine_schedule_matches_optax(args):
    want = optax.warmup_cosine_decay_schedule(*args)
    got = optim.warmup_cosine_decay_schedule(*args)
    counts = np.arange(0, 130)
    w = np.array([float(want(int(c))) for c in counts])
    g = np.array([float(got(torch.tensor(int(c), dtype=torch.int32))) for c in counts])
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12)
    # the count the optimizer state carries is an int32 tensor; a Python int works too
    assert float(got(7)) == pytest.approx(float(want(7)), rel=1e-6)


@pytest.mark.parametrize("args", [(0, 1, 5, 5, 0.1), (0, 1, 10, 3, 0), (0.0, 1e-4, 0, 0, 0.0)])
def test_warmup_cosine_schedule_raises_where_optax_raises(args):
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(*args)
    with pytest.raises(ValueError, match="positive decay_steps"):
        optim.warmup_cosine_decay_schedule(*args)


def _tree(seed, scale):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("scale, max_norm", [(10.0, 1.0), (0.01, 1.0), (1.0, 6.0), (3.0, 0.5)])
def test_clip_by_global_norm_matches_optax(scale, max_norm):
    tree = _tree(int(scale * 100), scale)
    want, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(v) for k, v in tree.items()}, optax.EmptyState())
    clip = optim.clip_by_global_norm(max_norm)
    got, _ = clip.update({k: torch.from_numpy(v) for k, v in tree.items()},
                         clip.init(None))
    norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in tree.values()))
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)
        if norm < max_norm:  # below the norm the updates pass untouched
            np.testing.assert_array_equal(got[k].numpy(), tree[k])
