"""Paged flash-decode (K8) — the port of
``repro/kernels/paged_decode.py:paged_flash_decode`` onto a hand-written
CUDA kernel (``csrc/paged_decode.cu``).  Same contract as
``paged_decode_ref`` (see there).

One query token a slot attends over that slot's pages, read straight from
the (N, page, Hkv, dh) pools through the page table: no contiguous K/V
copy.  The softmax is online in fp32 (running max m, sum l, output acc,
rescaled by exp(m_old - m_new)), keys past ``lengths[s]`` score -1e30,
and a slot with ``lengths <= 0`` gives exactly 0.  The int8 path
multiplies each code by its (row, head) fp32 scale right after the load:
the exact ``codes * scale`` of ``dequant_pool``.

Dispatch: a CUDA tensor launches the kernel or the wrapper raises; a CPU
tensor runs ``paged_flash_decode_plain``.  ``paged_flash_decode.launches``
counts the launches by pool type (``fp32`` / ``int8``).  Unlike the TPU
wrapper there is no fallback for dh % 128 != 0: the kernel takes any head
dim up to 256 and any page size.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_decode_ref import NEG_INF, dequant_pool
from repro_torch.kernels.robust_pipeline import SMEM_LIMIT

CHUNK = 64               # key rows K8 stages in shared memory at a time
MAX_DH = 256
_QTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_flash_decode_plain(q, kp, vp, table, lengths, *, k_scale=None,
                             v_scale=None):
    """The plain version of K8: the TPU kernel's page-by-page online
    softmax in torch ops, over all ``maxp`` pages (a dead page's keys all
    score -1e30, so after the first live page it changes nothing)."""
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
    for p in range(table.shape[1]):
        k = kp[table[:, p]].float().permute(0, 2, 3, 1)   # (S, Hkv, dh, page)
        v = vp[table[:, p]].float().transpose(1, 2)       # (S, Hkv, page, dh)
        scores = qg @ k                                   # (S, Hkv, g, page)
        kpos = p * page + torch.arange(page, device=q.device)
        live = (kpos[None, :] < lengths[:, None])[:, None, None, :]
        scores = torch.where(live, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(scores - m_new)
        acc = acc * alpha + pexp @ v
        l = l * alpha + pexp.sum(-1, keepdim=True)
        m = m_new
    out = acc / l.clamp_min(1e-30)
    out = torch.where((lengths > 0)[:, None, None, None], out, 0.0)
    return out.reshape(s, hq, dh)


def smem_bytes(g, dh):
    """K8's dynamic shared memory: q rows and their accumulators, the
    padded K chunk, the V chunk, the chunk's scores and 3 statistics a
    query row, fp32."""
    return 4 * (2 * g * dh + CHUNK * (dh + 1) + CHUNK * dh + g * CHUNK
                + 3 * g)


def paged_flash_decode(q, kp, vp, table, lengths, *, k_scale=None,
                       v_scale=None):
    """K8: (S, Hq, dh) fp32 attention outputs (``paged_decode_ref``'s
    contract).  q fp32 or bf16; pools fp32, or int8 with fp32 scales.

    Replaces ``repro/kernels/paged_decode.py:paged_flash_decode``
    (``_kernel``).  Bound: bytes (each live K and V row once, the int8
    scales, q and the output; the 4 dh flops a (query row, key) pair stay
    far under).  Design: one CTA of 256 threads a (slot, kv-head), holding
    the g query rows of its group; it walks the slot's live keys in
    64-row chunks, each gathered page by page through ``table[s, p]``
    into shared memory (rows past ``lengths[s]`` load as 0 and score
    -1e30), and stops at ``lengths[s]``, so dead pages cost nothing.
    """
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, kp, vp, table, lengths,
                                        k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
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
    if smem_bytes(hq // hkv, dh) > SMEM_LIMIT:
        raise ValueError(f"group {hq // hkv} x head_dim {dh} exceeds shared "
                         "memory")
    out = torch.empty(s, hq, dh, device=q.device)
    rc = _build.load().pd_decode(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        k_scale.data_ptr() if int8 else None,
        v_scale.data_ptr() if int8 else None, table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), _QTYPES[q.dtype], int(int8), s,
        hq, hkv, dh, page, table.shape[1], float(dh ** -0.5),
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
