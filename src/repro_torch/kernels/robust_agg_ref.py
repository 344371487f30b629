"""Sort-based oracle of the robust aggregation kernel (port of
``repro/kernels/robust_agg_ref.py``): it delegates to the core
aggregators, the one statement of the contract."""
from __future__ import annotations

from repro_torch.core import aggregation


def robust_agg_ref(x, mask, *, mode="trimmed", trim_frac=0.2):
    """x: (C, N) f32, or a tree of (C, ...) leaves; mask: (C,) -> (N,), or
    the tree of (...) leaves."""
    if mode == "trimmed":
        return aggregation.trimmed_mean(x, mask, trim_frac)
    return aggregation.median(x, mask)
