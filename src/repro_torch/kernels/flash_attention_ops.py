"""Public wrapper of K9 in the model layout (port of
``repro/kernels/flash_attention_ops.py``).

It takes (B, S, H, dh), transposes to the kernel's (B, H, S, dh) as the
JAX wrapper does (here as strided views, no copy) and back.  The TPU
wrapper's fallback to the oracle for S or dh not a multiple of 128 is not
carried over: K9 takes every S and dh <= 256, and the oracle computes the
same function.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention_fwd


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: (B, S, Hq, dh); k/v: (B, S, Hkv, dh) -> (B, S, Hq, dh)."""
    out = flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window)
    return out.transpose(1, 2)
