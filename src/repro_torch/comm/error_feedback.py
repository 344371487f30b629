"""Error-feedback (EF) residuals for the compressed uplink — port of
``repro/comm/error_feedback.py``.

Biased codecs (quantization, top-k) drop part of every update; EF keeps
the dropped part as a per-client residual and re-injects it into the next
round's update before encoding:

    target_t   = update_t + residual_{t-1}
    wire_t     = encode(target_t)
    residual_t = target_t - decode(wire_t)

The residual lives client-side, so it adds no wire traffic.  Here it is one
(K, N) fp32 buffer in the round's column order (``ClientStore.ef``), and
``compress`` works on the round's (K, N) update buffer and its
``codecs.WireLayout``.
"""
from __future__ import annotations

import torch


def init(updates):
    """Zero residuals shaped like a (K, N) update buffer."""
    return torch.zeros_like(updates, dtype=torch.float32)


def compress(codec, updates, layout, residual=None, gen=None):
    """One client->server boundary crossing of a (K, N) buffer.

    Returns ``(enc, dec, new_residual)``: the wire record, its (K, N) fp32
    decode (what a decode-then-aggregate server aggregates), and the
    updated residual (``None`` in, ``None`` out: EF off).  ``gen`` is the
    generator randk draws from."""
    target = updates if residual is None else updates + residual
    enc = codec.encode_flat(target, layout, gen)
    dec = codec.decode_flat(enc, layout)
    if residual is None:
        return enc, dec, None
    return enc, dec, target - dec
