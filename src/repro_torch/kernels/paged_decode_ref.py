"""Dense reference for paged flash-decode (port of
``repro/kernels/paged_decode_ref.py``, the parity oracle).

Gathers every slot's pages into a contiguous (S, T, Hkv, dh) K/V block
through the page table, then runs plain fp32 softmax attention.

Contract shared with K8 (``kernels/paged_decode.py``):
  q        (S, Hq, dh)        one query token per slot (GQA: Hq = g*Hkv)
  kp, vp   (N, page, Hkv, dh) page pools (fp32, or int8 codes)
  table    (S, maxp) int32    per-slot page table; every entry a valid pool
                              index (unallocated entries are 0, masked out
                              by ``lengths``)
  lengths  (S,) int32         visible keys per slot including the token
                              appended this step; <= 0 -> zero output
  k_scale, v_scale (N, page, Hkv) fp32  per-(row, head) absmax scales of
                              the int8 pools (qblk = dh)
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def gather_pages(pool, table):
    """pool (N, page, ...) gathered to (S, maxp*page, ...) via table."""
    s, maxp = table.shape
    page = pool.shape[1]
    return pool[table].reshape((s, maxp * page) + tuple(pool.shape[2:]))


def dequant_pool(codes, scale):
    """int8 page pool -> fp32: the exact ``codes * scale`` multiply of the
    codec's decode, the scale broadcast over the head dim."""
    return codes.float() * scale[..., None]


def paged_decode_ref(q, kp, vp, table, lengths, *, k_scale=None,
                     v_scale=None):
    """Returns (S, Hq, dh) fp32 attention outputs (module contract)."""
    s, hq, dh = q.shape
    hkv = kp.shape[2]
    g = hq // hkv
    if k_scale is not None:
        kp = dequant_pool(kp, k_scale)
        vp = dequant_pool(vp, v_scale)
    k = gather_pages(kp, table).float()                 # (S, T, Hkv, dh)
    v = gather_pages(vp, table).float()
    t = k.shape[1]
    qg = q.reshape(s, hkv, g, dh).float() * dh ** -0.5
    scores = torch.einsum("shgd,sthd->shgt", qg, k)
    visible = torch.arange(t, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(visible[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("shgt,sthd->shgd", probs, v)
    out = torch.where((lengths > 0)[:, None, None, None], out, 0.0)
    return out.reshape(s, hq, dh)
