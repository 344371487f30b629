"""Every kernel wrapper's launch counter, read and advanced as one.

Each wrapper of the port's CUDA kernels adds one to its ``.launches``
(an int, or a dict by mode) where it launches its kernel, on the host.
A body captured as a CUDA graph runs its wrappers once, while it is
captured, and never again: a replay launches the kernels without running
any Python.  So whoever replays a graph (``core/driver.py``,
``serve/engine.py``) takes ``snapshot()`` before the capture, keeps
``since(before)`` (the launches the capture recorded) and sets the
counters back with ``restore(before)``, since the capture itself launched
nothing; then ``add(recorded)`` after each replay keeps every count
equal to the launches the card ran.
"""
from __future__ import annotations

from repro_torch.comm.kernels import comm_codecs as cc
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_decode as pd
from repro_torch.kernels import population_select as ps
from repro_torch.kernels import robust_agg as ra
from repro_torch.kernels import robust_pipeline as rp


def _wrappers():
    return (rp.cosine_gate_partials, rp.gated_combine, rp.pairwise_gram,
            rp.cosine_gate_partials_flat, rp.gated_combine_flat,
            rp.pairwise_sq_dists_blocked, cc.dequant_gate_partials,
            cc.dequant_gated_combine, cc.dequant_pairwise_gram,
            ra.robust_agg_fwd, ps.block_topd, pd.paged_flash_decode,
            fa.flash_attention_fwd)


def snapshot():
    """{(wrapper, mode or None): launches} of every counter."""
    out = {}
    for fn in _wrappers():
        if isinstance(fn.launches, dict):
            out.update({(fn, m): n for m, n in fn.launches.items()})
        else:
            out[(fn, None)] = fn.launches
    return out


def since(before):
    """The launches counted after ``before`` (a ``snapshot``), by counter;
    only the counters that moved."""
    return {k: n - before.get(k, 0) for k, n in snapshot().items()
            if n != before.get(k, 0)}


def restore(before):
    """Every counter back to its value in ``before``."""
    for (fn, mode), n in before.items():
        if mode is None:
            fn.launches = n
        else:
            fn.launches[mode] = n


def add(counts, times=1):
    """Adds ``times`` x ``counts`` (from ``since``) to the counters."""
    for (fn, mode), n in counts.items():
        if mode is None:
            fn.launches += n * times
        else:
            fn.launches[mode] += n * times
