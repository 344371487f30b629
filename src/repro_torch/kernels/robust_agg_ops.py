"""Robust aggregation over trees of client updates (port of
``repro/kernels/robust_agg_ops.py``): every (C, ...) leaf, of any float
dtype, is flattened into one fp32 (C, N) matrix, aggregated by K5
(``robust_agg.robust_agg_fwd``; its plain version for a CPU tensor), and
split back into leaves, each cast to its own dtype."""
from __future__ import annotations

from repro_torch import tree
from repro_torch.kernels.robust_agg import robust_agg_fwd
from repro_torch.kernels.robust_agg_ref import \
    robust_agg_ref as robust_aggregate_tree_ref  # the oracle takes trees too
from repro_torch.kernels.robust_pipeline import _split


def robust_aggregate_tree(updates, mask, *, mode="trimmed", trim_frac=0.2):
    """updates: tree of (C, ...) leaves; mask: (C,) -> tree of (...)."""
    agg = robust_agg_fwd(tree.flatten_rows(updates).float(), mask.float(),
                         mode=mode, trim_frac=trim_frac)
    return _split(agg, updates, 1)
