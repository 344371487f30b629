"""Causal sliding-window flash attention forward (K9) — the port of
``repro/kernels/flash_attention.py:flash_attention_fwd`` onto a
hand-written CUDA kernel (``csrc/flash_attention.cu``).

Both versions here compute ``flash_attention_ref`` blockwise: tiles of
query rows (``q_tile``: 128 on the kernel's tensor-core body, 64 on its
FMA body) against tiles of BLK = 64 key rows, an online softmax in fp32
(running max m, sum l and output acc, rescaled by exp(m_old - m_new) a
tile), masked scores at -1e30, and key tiles that lie wholly outside the
causal / window band of a query tile skipped.  A row whose keys are all
masked inside a visited tile takes exp(0) = 1 weights there, exactly as
the TPU kernel's ``_flash_body`` does; the first live key sets m to a real
value and the rescale exp(-1e30 - m) = 0 wipes them, so the tiles change
only the order of the fp32 sums.  Unlike the TPU kernel, any S >= 1 (a
ragged last tile is masked) and any head dim up to 256 are taken.

Forward only, as the reference's Pallas kernel is (``jax.grad`` through
it raises): under grad, with an input that requires grad, both devices
raise rather than return an output that drops the attention's gradient;
the pod path trains with the plain attention.

Dispatch: a CUDA tensor launches the kernel or the wrapper raises; a CPU
tensor runs ``flash_attention_fwd_plain``.  ``flash_attention_fwd.launches``
counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import device
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention_ref import NEG_INF
from repro_torch.kernels.robust_pipeline import SMEM_LIMIT

BLK = 64                 # key rows a tile; query rows on the FMA body
MMA_Q_TILE = 128         # query rows a tile on the tensor-core body
MAX_DH = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def tensor_cores(dtype, dh):
    """Whether K9 takes its tensor-core body (wgmma, TMA) for this dtype
    and head dim: bf16 with dh a multiple of 16.  fp32 and other head dims
    take the FMA body."""
    return dtype == torch.bfloat16 and dh % 16 == 0


def q_tile(dtype, dh):
    """Query rows a tile on the body K9 takes."""
    return MMA_Q_TILE if tensor_cores(dtype, dh) else BLK


def kv_block_range(q0, q1, s, causal, window):
    """[lo, hi) of the key tiles that hold a live key for query rows
    [q0, q1): the tile's last key must reach the first row's window start
    q0 - window + 1, and (causal) its first key must not pass row q1 - 1."""
    lo = (q0 - window + 1) // BLK if window and q0 - window + 1 > 0 else 0
    hi = (q1 - 1) // BLK + 1 if causal else -(-s // BLK)
    return lo, hi


def flash_attention_fwd_plain(q, k, v, *, causal=True, window=0, tile=None):
    """The plain version of K9: the kernel's tiles and online softmax in
    torch ops.  q: (B, Hq, S, dh); k/v: (B, Hkv, S, dh) -> q's dtype.
    ``tile``: query rows a tile, by default those of the body the kernel
    takes for q's dtype and dh (``q_tile``)."""
    B, Hq, S, dh = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    tile = tile or q_tile(q.dtype, dh)
    qf = q.reshape(B, Hkv, g, S, dh).float() * dh ** -0.5
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    out = torch.empty(B, Hkv, g, S, dh, device=q.device)
    for q0 in range(0, S, tile):
        q1 = min(q0 + tile, S)
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        m = torch.full((B, Hkv, g, q1 - q0, 1), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, Hkv, g, q1 - q0, dh, device=q.device)
        lo, hi = kv_block_range(q0, q1, S, causal, window)
        for k0 in range(lo * BLK, min(hi * BLK, S), BLK):
            k1 = min(k0 + BLK, S)
            cols = torch.arange(k0, k1, device=q.device)[None, :]
            s = qf[..., q0:q1, :] @ kf[..., k0:k1, :].transpose(-1, -2)
            live = torch.ones(q1 - q0, k1 - k0, dtype=torch.bool,
                              device=q.device)
            if causal:
                live &= cols <= rows
            if window:
                live &= cols > rows - window
            s = torch.where(live, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p @ vf[..., k0:k1, :]
            m = m_new
        out[..., q0:q1, :] = acc / l.clamp_min(1e-30)
    return out.reshape(B, Hq, S, dh).to(q.dtype)


def flash_attention_fwd(q, k, v, *, causal=True, window=0):
    """K9.  q: (B, Hq, S, dh); k/v: (B, Hkv, S, dh), fp32 or bf16, any
    strides with a unit head-dim stride (the model layout's transposed
    views go in without a copy) -> (B, Hq, S, dh) in q's dtype, laid out
    as a transposed (B, S, Hq, dh) tensor.

    Replaces ``repro/kernels/flash_attention.py:flash_attention_fwd``
    (``_flash_body``).  Bound: operations (4 dh flops a live (row, key)
    pair; bytes are q, k, v and o once), at bf16's tensor-core rate on
    the tensor-core body.  Design (``csrc/flash_attention.cu``): bf16 with
    dh % 16 == 0 takes the tensor-core body: a persistent CTA a SM walks
    (batch, q head, 128-row q tile) items, the longest (last) q tiles
    first; a producer warp TMA-loads each item's Q and its 64-key K and V
    tiles into rings of shared-memory buffers, two consumer warpgroups run
    S = Q K^T and O += P V (P split into two bf16 halves) by ``wgmma`` and
    the online softmax in registers; its strides and pointers must be
    16-byte multiples.  fp32 and other head dims take the FMA body (a CTA
    a 64-row q tile, 4 x 4 score micro-tiles a thread, the longest tiles
    first).  Raises under grad with an input that requires grad (forward
    only).
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_fwd (K9) is forward only: it has no backward "
            "kernel (the reference's is forward only too), so its output "
            "would drop the gradient of q, k and v.  Call it under "
            "torch.no_grad() or on inputs that do not require grad.")
    if device.plain_route(q):
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         window=window)
    B, Hq, S, dh = q.shape
    Hkv = k.shape[1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"K9 takes fp32 or bf16 q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (B, Hkv, S, dh) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"K9 shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if dh > MAX_DH or min(t.stride(-1) for t in (q, k, v)) != 1:
        raise ValueError(f"K9 takes head_dim <= {MAX_DH} with unit stride")
    if smem_bytes(dh, q.dtype) > SMEM_LIMIT:
        raise ValueError(f"head_dim {dh}: the tiles exceed shared memory")
    if tensor_cores(q.dtype, dh) and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError("K9's tensor-core body takes 16-byte aligned "
                         "pointers and strides (TMA), got strides "
                         f"{[t.stride() for t in (q, k, v)]}")
    o = torch.empty(B, S, Hq, dh, dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, o) for st in t.stride()[:3]))
    rc = _build.load().fa_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
        _DTYPES[q.dtype], B, Hq, Hkv, S, dh, int(causal), int(window),
        float(dh ** -0.5), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fa_fwd failed: CUDA error {rc}")
    flash_attention_fwd.launches += 1
    return o


def smem_bytes(dh, dtype=torch.float32):
    """K9's dynamic shared memory for the body it takes at this dtype and
    dh.  Tensor-core body (``MmaTile``): 1,024 bytes of alignment slack,
    2 Q buffers (128 rows; 1 past dh 192) and 3 stages of K and V (64 rows;
    2 past dh 128) in bf16, dh rounded up to 64-column chunks, and their
    mbarriers.
    FMA body: padded Q and K tiles, the V tile and the (BLK, BLK + 1)
    probability tile, fp32."""
    if tensor_cores(dtype, dh):
        nch = -(-dh // 64)
        stages, qbufs = (3 if nch <= 2 else 2), (2 if nch <= 3 else 1)
        return (1024 + qbufs * nch * MMA_Q_TILE * 128
                + stages * 2 * nch * BLK * 128 + 8 * (2 * qbufs + 2 * stages))
    return 4 * (2 * BLK * (dh + 1) + BLK * dh + BLK * (BLK + 1))


def reset_launch_counts():
    flash_attention_fwd.launches = 0


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {"flash_attention_fwd": flash_attention_fwd.launches}


reset_launch_counts()
