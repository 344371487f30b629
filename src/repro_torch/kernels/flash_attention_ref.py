"""Plain oracle for flash attention (port of
``repro/kernels/flash_attention_ref.py``, same contract): the whole
(S, S) score matrix, masked and softmaxed in fp32."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def band_mask(s, causal, window, device=None):
    """(S, S) boolean: query row i sees key j (causal, sliding window)."""
    rows = torch.arange(s, device=device)[:, None]
    cols = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= cols <= rows
    if window:
        mask &= cols > rows - window
    return mask


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: (B, Hq, S, dh); k/v: (B, Hkv, S, dh) -> (B, Hq, S, dh)."""
    B, Hq, S, dh = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, S, dh).float() * dh ** -0.5
    scores = torch.einsum("bhgsd,bhtd->bhgst", qg, k.float())
    scores = torch.where(band_mask(S, causal, window, q.device), scores,
                         NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", probs, v.float())
    return out.reshape(B, Hq, S, dh).to(q.dtype)
