"""MNIST models (port of :mod:`tensorflowonspark_tpu.models.mnist`), the
canonical first example of TensorFlowOnSpark.

``MLP`` (512-512-10) and ``CNN`` (conv-pool ×2, dense 128, dense 10) take
``(B, 28, 28, 1)`` images (or ``(B, 28, 28)``) and return logits in
``dtype``. Parameter names are the flax paths (``Dense_0.weight``,
``Conv_1.bias`` …), so :mod:`models.convert` maps the trees leaf by leaf.
The CNN keeps its maps NHWC (``models.conv``), so its flatten before
``Dense_0`` orders the features (h, w, c) as the JAX package's does.

Divergence: :func:`synthetic_batch` draws from a ``torch.Generator``
seeded with ``rng``; its values are not those of the JAX package's
``jax.random`` draws (the two generators differ), only their shapes,
ranges and dtypes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tensorflowonspark_tpu_torch import resolve_device
from tensorflowonspark_tpu_torch.models.conv import Conv, Dense, FlaxNamed, init_weights, max_pool


class MLP(FlaxNamed):
    """512-512-10 dense net (the reference example's Keras model)."""

    def __init__(self, hidden: int = 512, dtype=torch.float32, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.child(Dense(784, hidden, dtype, device))
        self.child(Dense(hidden, hidden, dtype, device))
        self.child(Dense(hidden, 10, dtype, device))
        init_weights(self, seed, device)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


class CNN(FlaxNamed):
    """Small convnet: conv 32 → pool → conv 64 → pool → dense 128 → 10."""

    def __init__(self, dtype=torch.float32, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.child(Conv(1, 32, (3, 3), dtype=dtype, device=device, bias=True))
        self.child(Conv(32, 64, (3, 3), dtype=dtype, device=device, bias=True))
        self.child(Dense(7 * 7 * 64, 128, dtype, device))
        self.child(Dense(128, 10, dtype, device))
        init_weights(self, seed, device)

    def forward(self, x):
        if x.dim() == 3:
            x = x[..., None]
        x = x.to(self.dtype)
        x = max_pool(F.relu(self.Conv_0(x)), 2, 2)
        x = max_pool(F.relu(self.Conv_1(x)), 2, 2)
        x = x.reshape(x.shape[0], -1)  # NHWC: features in (h, w, c) order
        return self.Dense_1(F.relu(self.Dense_0(x)))


def loss_fn(model):
    """``loss(params, batch)`` for batches ``{'image', 'label'}``: mean
    softmax cross entropy on integer labels, ``model`` run with ``params``
    in place of its own tensors."""

    def loss(params, batch):
        logits = torch.func.functional_call(model, params, (batch["image"],))
        return F.cross_entropy(logits.float(), batch["label"].long())

    return loss


def accuracy(model, params, batch) -> torch.Tensor:
    with torch.no_grad():
        logits = torch.func.functional_call(model, params, (batch["image"],))
    return (logits.argmax(-1) == batch["label"].to(logits.device)).float().mean()


def synthetic_batch(rng: int | torch.Generator, batch_size: int, device=None):
    """A fake MNIST batch: ``image`` uniform in [0, 1) ``(B, 28, 28, 1)``,
    ``label`` int in [0, 10), drawn from a ``torch.Generator`` (``rng`` a
    seed or a generator on ``device``); not the JAX package's values."""
    device = resolve_device(device)
    gen = rng
    if not isinstance(rng, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(rng)
    return {
        "image": torch.rand(batch_size, 28, 28, 1, generator=gen, device=device),
        "label": torch.randint(0, 10, (batch_size,), generator=gen, device=device),
    }
