"""Paged flash-decode (K8) — the port of
``repro/kernels/paged_decode.py:paged_flash_decode`` onto a hand-written
CUDA kernel (``csrc/paged_decode.cu``).  Same contract as
``paged_decode_ref`` (see there).

One query token a slot attends over that slot's pages, read straight from
the (N, page, Hkv, dh) pools through the page table: no contiguous K/V
copy.  The softmax is online in fp32 (running max m, sum l, output acc,
rescaled by exp(m_old - m_new)), keys past ``lengths[s]`` are dead, and a
slot with ``lengths <= 0`` gives exactly 0.  The int8 path multiplies each
code by its (row, head) fp32 scale right after the load: the exact
``codes * scale`` of ``dequant_pool``.

The kernel splits each slot's live keys into work items of a fixed size
and spreads the items over a grid sized from the shapes and the SM count
(``decode_splits``; never from ``lengths``, which the kernel reads on the
device), then merges each slot's (m, l, acc) partials by the log-sum-exp
rule in the same launch (``merge_split_partials_plain`` is that merge in
torch ops, for the tests).  Its item counters live in one int32 buffer a
device, zeroed once, which every launch leaves at 0; so calls on one
device go on one stream at a time, as the serving engine makes them.

Dispatch: a CUDA tensor launches the kernel or the wrapper raises; a CPU
tensor runs ``paged_flash_decode_plain``.  ``paged_flash_decode.launches``
counts the launches by pool type (``fp32`` / ``int8``).  Unlike the TPU
wrapper there is no fallback for dh % 128 != 0: the kernel takes any head
dim up to 256, any page size and any group.
"""
from __future__ import annotations

import torch

from repro_torch import device
from repro_torch.kernels import _build
from repro_torch.kernels.paged_decode_ref import NEG_INF, dequant_pool
from repro_torch.kernels.robust_pipeline import SMEM_LIMIT, sm_count

WARPS = 4                # K8: warps a CTA, each owning a subset of its keys
MAX_ROWS = 8             # query rows a CTA holds in registers (its row block)
SPLIT_KEYS = 32          # key positions a work item (a split of a slot)
CTAS_PER_SM = 5          # decode_splits sizes the grid to this many CTAs a SM
MAX_DH = 256
_QTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_partials_plain(q, kp, vp, table, lengths, pages=None, *,
                                k_scale=None, v_scale=None):
    """The TPU kernel's page-by-page online softmax in torch ops over the
    pages ``pages`` (a range of page-table columns, all of them by
    default): (m, l, acc) of shapes (S, Hkv, g, 1), (S, Hkv, g, 1),
    (S, Hkv, g, dh), fp32.  Keys past ``lengths`` get weight 0, so a range
    with no live key gives m = -1e30, l = 0, acc = 0."""
    s, hq, dh = q.shape
    hkv, page = kp.shape[2], kp.shape[1]
    g = hq // hkv
    if k_scale is not None:
        kp = dequant_pool(kp, k_scale)
        vp = dequant_pool(vp, v_scale)
    qg = q.reshape(s, hkv, g, dh).float() * dh ** -0.5
    m = torch.full((s, hkv, g, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(s, hkv, g, dh, device=q.device)
    lengths = lengths.to(device=q.device)
    for p in pages if pages is not None else range(table.shape[1]):
        k = kp[table[:, p]].float().permute(0, 2, 3, 1)   # (S, Hkv, dh, page)
        v = vp[table[:, p]].float().transpose(1, 2)       # (S, Hkv, page, dh)
        scores = qg @ k                                   # (S, Hkv, g, page)
        kpos = p * page + torch.arange(page, device=q.device)
        live = (kpos[None, :] < lengths[:, None])[:, None, None, :]
        scores = torch.where(live, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        pexp = torch.where(live, torch.exp(scores - m_new), 0.0)
        acc = acc * alpha + pexp @ v
        l = l * alpha + pexp.sum(-1, keepdim=True)
        m = m_new
    return m, l, acc


def _finish(acc, l, lengths):
    """(S, Hq, dh) output from merged (l, acc): acc / max(l, 1e-30), 0 for
    a slot with lengths <= 0."""
    s, hkv, g, dh = acc.shape
    out = acc / l.clamp_min(1e-30)
    out = torch.where((lengths.to(acc.device) > 0)[:, None, None, None], out,
                      0.0)
    return out.reshape(s, hkv * g, dh)


def paged_flash_decode_plain(q, kp, vp, table, lengths, *, k_scale=None,
                             v_scale=None):
    """The plain version of K8: the TPU kernel's page-by-page online
    softmax in torch ops over all ``maxp`` pages (a dead key has weight
    0, as a dead page's -1e30 scores give it after the first live page)."""
    _, l, acc = paged_decode_partials_plain(q, kp, vp, table, lengths,
                                            k_scale=k_scale, v_scale=v_scale)
    return _finish(acc, l, lengths)


def merge_split_partials_plain(parts, lengths):
    """K8's merge of split partials, in torch ops: ``parts`` is a list of
    (m, l, acc) over disjoint key ranges, in split order; by the log-sum-
    exp rule M = max m, L = sum l e^(m - M), A = sum acc e^(m - M), and the
    output is A / max(L, 1e-30) (0 for an inactive slot).  A range with no
    live key (m = -1e30, l = 0) adds nothing."""
    big_m = parts[0][0]
    for m, _, _ in parts[1:]:
        big_m = torch.maximum(big_m, m)
    big_l = torch.zeros_like(big_m)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        c = torch.exp(m - big_m)
        big_l = big_l + l * c
        acc = acc + a * c
    return _finish(acc, big_l, lengths)


def row_block(g):
    """Query rows a K8 CTA holds: the group rounded up to 1, 2, 3, 4 or 8;
    a group of more than 8 takes ceil(g / 8) CTAs of 8 rows."""
    return next(r for r in (1, 2, 3, 4, MAX_ROWS) if r >= min(g, MAX_ROWS))


def decode_splits(maxp, page, sms, s, hkv):
    """(splits, chunk, ctas) of K8.  A slot's key positions 0 .. maxp *
    page - 1 are cut into ``splits`` work items of ``chunk`` positions (the
    last one shorter, none empty); the kernel runs a live slot's
    ceil(min(lengths, maxp page) / chunk) items, found on the device, on a
    grid of ``ctas`` CTAs a kv head: no more than CTAS_PER_SM a SM of a
    card of ``sms`` SMs over the Hkv heads, nor than S * splits.  Known on
    the host from the shapes alone: no read of ``lengths``."""
    total = maxp * page
    chunk = min(SPLIT_KEYS, total)
    splits = -(-total // chunk)
    ctas = max(1, min(s * splits, CTAS_PER_SM * sms // hkv))
    return splits, chunk, ctas


def smem_bytes(g, dh):
    """K8's shared memory a CTA: each warp's (m, l) (static) and acc
    (dynamic) for the CTA's row block, fp32, and the last-item flag."""
    rows = row_block(g)
    return 4 * WARPS * rows * (dh + 2) + 4


_COUNTERS = {}
_OUTGROWN = []          # counters replaced by larger ones: a captured graph
                        # may still launch K8 on one, so none is freed


def _counter(device, n):
    """K8's item counters on ``device``: at least n int32, zeroed once and
    left at 0 by every launch (the last item of each slot resets its own).
    A step captured as a CUDA graph keeps the buffer its warm-up made; one
    first needed during capture raises, since a graph cannot make it."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("K8's item counters first needed during CUDA "
                               "graph capture; run one eager step first")
        if buf is not None:
            _OUTGROWN.append(buf)
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def paged_flash_decode(q, kp, vp, table, lengths, *, k_scale=None,
                       v_scale=None):
    """K8: (S, Hq, dh) fp32 attention outputs (``paged_decode_ref``'s
    contract).  q fp32 or bf16; pools fp32, or int8 with fp32 scales.

    Replaces ``repro/kernels/paged_decode.py:paged_flash_decode``
    (``_kernel``).  Bound: bytes (each live K and V row once, the int8
    scales, q and the output; the 4 dh flops a (query row, key) pair stay
    far under).  Design: register-resident and split over keys in
    proportion to each slot's length.  A kv head's live keys are cut into
    work items of ``chunk`` keys (``decode_splits``), and a fixed grid of
    CTAs walks them, each CTA finding its item's slot from ``lengths`` on
    the device.  In a CTA of 4 warps, warps own keys and lanes own head
    dims, so the scaled q rows (a row block of at most 8), each warp's
    (m, l, acc) and several keys' K and V rows (one vector load a lane;
    the item's page entries held one a lane) sit in registers, with no
    shared staging and no barrier in the key loop.  The warps merge in
    warp order; the last item of a slot to finish merges its items'
    partials in item order (``merge_split_partials_plain`` is that merge
    in torch ops), so two calls are bitwise equal.  One launch a call:
    ``.launches`` counts calls.
    """
    if device.plain_route(q):
        return paged_flash_decode_plain(q, kp, vp, table, lengths,
                                        k_scale=k_scale, v_scale=v_scale)
    s, hq, dh = q.shape
    n, page, hkv, _ = kp.shape
    int8 = k_scale is not None
    if q.dtype not in _QTYPES:
        raise TypeError(f"K8 takes fp32 or bf16 queries, got {q.dtype}")
    pool_dtype = torch.int8 if int8 else torch.float32
    if kp.dtype != pool_dtype or vp.dtype != pool_dtype:
        raise TypeError(f"K8 takes {pool_dtype} pools here, got {kp.dtype}, "
                        f"{vp.dtype}")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("K8 takes an int32 page table and int32 lengths")
    if (vp.shape != kp.shape or kp.shape[3] != dh or hq % hkv
            or table.shape[0] != s or lengths.shape != (s,)
            or dh > MAX_DH):
        raise ValueError(f"K8 shapes: q {tuple(q.shape)}, pools "
                         f"{tuple(kp.shape)}, table {tuple(table.shape)}")
    tensors = [q, kp, vp, table, lengths]
    if int8:
        if (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                or k_scale.shape != (n, page, hkv)
                or v_scale.shape != k_scale.shape):
            raise ValueError("K8 takes (N, page, Hkv) fp32 int8 scales")
        tensors += [k_scale, v_scale]
    if not all(t.is_contiguous() and t.device == q.device for t in tensors):
        raise ValueError("K8 takes contiguous tensors on one device")
    g = hq // hkv
    if smem_bytes(g, dh) > SMEM_LIMIT:
        raise ValueError(f"group {g} x head_dim {dh} exceeds shared memory")
    maxp = table.shape[1]
    splits, chunk, ctas = decode_splits(maxp, page, sm_count(q.device), s,
                                        hkv)
    out = torch.empty(s, hq, dh, device=q.device)
    part = counter = None
    if splits > 1:
        part = torch.empty(s * hq * splits * (dh + 2), device=q.device)
        counter = _counter(q.device, s * hkv * -(-g // MAX_ROWS))
    rc = _build.load().pd_decode(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        k_scale.data_ptr() if int8 else None,
        v_scale.data_ptr() if int8 else None, table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None,
        counter.data_ptr() if counter is not None else None,
        _QTYPES[q.dtype], int(int8), s, hq, hkv, dh, page, maxp, splits,
        chunk, ctas, float(dh ** -0.5),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pd_decode failed: CUDA error {rc}")
    paged_flash_decode.launches["int8" if int8 else "fp32"] += 1
    return out


def reset_launch_counts():
    paged_flash_decode.launches = {"fp32": 0, "int8": 0}


def launch_counts():
    """{kernel name: launches since the last reset}."""
    c = paged_flash_decode.launches
    return {"paged_flash_decode": c["fp32"],
            "paged_flash_decode[int8]": c["int8"]}


reset_launch_counts()
