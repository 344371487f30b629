"""Synthetic dataset generators (port of ``repro/data/synthetic.py``).

Drawn from a ``torch.Generator``: the numbers differ from jax's for the
same seed, the distributions are the same.  ``make_lm_tokens`` is split
into its draws and a pure function of them, so a test can feed the pure
function JAX's own draws.
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


def draw_lm_tokens(generator, n_seqs, seq_len, vocab, n_latent=32):
    """The draws of ``make_lm_tokens``: (z (n,), cand (n_latent, vocab, 8),
    first (n,), choice (n, seq_len - 1)), all int64."""
    dev = generator.device
    r = lambda hi, shape: torch.randint(0, hi, shape, generator=generator,
                                        device=dev)
    return (r(n_latent, (n_seqs,)), r(vocab, (n_latent, vocab, 8)),
            r(vocab, (n_seqs,)), r(8, (n_seqs, seq_len - 1)))


def lm_tokens_from_draws(z, cand, first, choice):
    """Token streams from the draws: sequence i starts at ``first[i]`` and
    steps to ``cand[z[i], tok, choice[i, s]]``, one of its latent chain's 8
    candidates.  (n, seq_len) int64."""
    toks = [first]
    for s in range(choice.shape[1]):
        toks.append(cand[z, toks[-1], choice[:, s]])
    return torch.stack(toks, 1)


def make_lm_tokens(generator, n_seqs, seq_len, vocab, n_latent=32):
    """Synthetic LM corpus: mixture-of-Markov-chains token streams.  Each
    sequence follows one latent chain whose transition rows are sparse (8
    candidates a token): learnable structure, so a ~100M model's loss
    actually decreases."""
    return lm_tokens_from_draws(*draw_lm_tokens(generator, n_seqs, seq_len,
                                                vocab, n_latent))
