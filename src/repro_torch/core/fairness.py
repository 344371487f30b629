"""Fairness reporting for the round metrics (port of
``repro/core/fairness.py``), mask-aware:

  accuracy_variance    Var_k[acc_k] over available clients.
  worst_decile         mean accuracy of the worst ceil(0.1 * n_avail).
  participation_gini   Gini coefficient of cumulative selection counts.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def accuracy_variance(acc, mask=None):
    """Variance of per-client accuracy over masked-in clients."""
    if mask is None:
        mask = torch.ones_like(acc)
    n = torch.clamp(mask.sum(), min=1.0)
    mu = (acc * mask).sum() / n
    return (mask * torch.square(acc - mu)).sum() / n


def worst_decile(acc, mask=None):
    """Mean accuracy of the bottom ceil(10%) of masked-in clients."""
    if mask is None:
        mask = torch.ones_like(acc)
    n = mask.sum()
    d = torch.clamp(torch.ceil(0.1 * n), min=1.0)
    vals = torch.sort(torch.where(mask > 0, acc,
                                  torch.full_like(acc, float("inf")))).values
    take = (torch.arange(acc.shape[0], dtype=torch.float32,
                         device=acc.device) < d).float()
    finite = torch.where(torch.isfinite(vals), vals, torch.zeros_like(vals))
    worst = (finite * take).sum() / d
    return torch.where(n > 0, worst, torch.zeros_like(worst))


def participation_gini(cum_selected):
    """Gini coefficient of the per-client cumulative selection counts."""
    x = torch.sort(cum_selected.float()).values
    n = float(x.shape[0])
    tot = x.sum()
    i = torch.arange(1, x.shape[0] + 1, dtype=torch.float32, device=x.device)
    g = 2.0 * (i * x).sum() / (n * torch.clamp(tot, min=_EPS)) \
        - (n + 1.0) / n
    return torch.where(tot > 0, g, torch.zeros_like(g))


def round_fairness(acc, avail, cum_selected):
    """The per-round fairness block of the metrics dict."""
    return {
        "fair_acc_var": accuracy_variance(acc, avail),
        "fair_worst_decile": worst_decile(acc, avail),
        "fair_part_gini": participation_gini(cum_selected),
    }
