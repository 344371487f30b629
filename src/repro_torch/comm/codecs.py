"""Measured byte accounting of the dense uplink/downlink (the part of
``repro/comm/codecs.py`` that billing needs; the codecs themselves come
with ROADMAP queue 1 item 9)."""
from __future__ import annotations

from repro_torch import tree


def dense_bytes_per_client(updates) -> float:
    """Uncompressed uplink bytes per client of a (K, ...) update tree, from
    the leaves' actual dtype itemsizes."""
    ls = tree.leaves(updates)
    k = ls[0].shape[0]
    return float(sum(l.numel() * l.element_size() for l in ls)) / float(k)


def param_bytes(params) -> float:
    """Downlink bytes of one dense global-model broadcast."""
    return float(sum(l.numel() * l.element_size()
                     for l in tree.leaves(params)))
