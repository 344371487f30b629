"""FedFiTS fitness metrics (paper §III-A, §V) — port of
``repro/core/fitness.py``.

  theta_k     Eq. (1): Quality-of-Learning angle between the (loss, acc)
              midpoint of global/local models and the loss unit vector.
  score_k     Eq. (2): alpha * q_k + (1 - alpha) * theta_k.
  threshold   Eq. (3): mean(score) * (1 - beta).
  dynamic alpha  Eqs. (18)-(19): alpha = mean_k 1[q_k > theta_k].

All functions take a client-availability mask so unavailable clients never
contribute to means/thresholds.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def theta(gl, ga, ll, la, *, paper_exact=False):
    """Eq. (1), the geometric reading: arccos((GL+LL) / |M|) of the
    midpoint M; ``paper_exact=True`` is the literal printed formula."""
    num = gl + ll
    if paper_exact:
        den = torch.sqrt(torch.square(gl + ga) + torch.square(ll + la))
    else:
        den = torch.sqrt(torch.square(gl + ll) + torch.square(ga + la))
    arg = torch.clamp(num / torch.clamp(den, min=_EPS), -1.0, 1.0)
    return torch.arccos(arg)


def data_quality(n_k, mask=None):
    """q_k = n_k / n over available clients."""
    n_k = n_k.float()
    if mask is not None:
        n_k = n_k * mask
    return n_k / torch.clamp(n_k.sum(), min=_EPS)


def score(q, th, alpha):
    """Eq. (2)."""
    return alpha * q + (1.0 - alpha) * th


def threshold(scores, beta, mask=None):
    """Eq. (3): mean of available clients' scores * (1 - beta)."""
    if mask is None:
        mask = torch.ones_like(scores)
    mean = (scores * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return mean * (1.0 - beta)


def dynamic_alpha(q, th, mask=None):
    """Eqs. (18)-(19): mean_k 1[q_k > theta_k] over available clients."""
    if mask is None:
        mask = torch.ones_like(q)
    ind = (q > th).float() * mask
    return ind.sum() / torch.clamp(mask.sum(), min=1.0)


def team_theta(th, team_mask):
    """theta(t) = sum_{k in S_t} theta_k (Algorithm 1)."""
    return (th * team_mask).sum()
