"""Synthetic dataset generators (port of ``repro/data/synthetic.py``).

Drawn from a ``torch.Generator``: the numbers differ from jax's for the
same seed, the distributions are the same.
"""
from __future__ import annotations

import math

import torch


def make_tabular(generator, n, n_features=22, n_classes=22, sep=2.0):
    """Crop-Recommendation-like: Gaussian blobs in feature space."""
    dev = generator.device
    centers = sep * torch.randn(n_classes, n_features, generator=generator,
                                device=dev)
    y = torch.randint(0, n_classes, (n,), generator=generator, device=dev)
    x = centers[y] + torch.randn(n, n_features, generator=generator,
                                 device=dev)
    return x.float(), y.int()


def make_images(generator, n, size=28, n_classes=10, sep=1.5):
    """MNIST/X-ray-like: per-class low-rank template + pixel noise,
    values in [0, 1], shape (n, size, size, 1)."""
    dev = generator.device
    rank = 4
    u = torch.randn(n_classes, size, rank, generator=generator, device=dev)
    v = torch.randn(n_classes, rank, size, generator=generator, device=dev)
    templates = torch.einsum("csr,crt->cst", u, v) / math.sqrt(rank)
    y = torch.randint(0, n_classes, (n,), generator=generator, device=dev)
    x = sep * templates[y] + torch.randn(n, size, size, generator=generator,
                                         device=dev)
    return torch.sigmoid(x)[..., None].float(), y.int()
