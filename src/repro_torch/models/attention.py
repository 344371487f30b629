"""GQA self-attention (full / sliding-window), cross-attention and the KV
caches (port of ``repro/models/attention.py``).

Execution modes of ``attention_fwd``:
  * no cache (train / scoring): full-sequence causal attention, optional
    sliding window; ``attn_impl="pallas"`` at S >= 128 routes the
    score / softmax / value contraction to K9 (``kernels/flash_attention``),
    as the JAX package routes it to its Pallas kernel;
  * full cache: prefill-fill or decode against a (B, L, Hkv, dh) cache;
  * ring cache (sliding window): prefill fills the last min(S, W) slots of
    a (B, W, Hkv, dh) ring at ``pos mod W`` (a prefill starts at position
    0, as in the JAX package), decode writes one slot and masks the slots
    by the absolute position each holds;
  * cross-attention: prefill projects ``kv_source`` (the image embeddings)
    and stores it as the frozen ``ck`` / ``cv``, decode reuses them; no
    rope, no causal mask;
  * paged pools (serving): prefill scatter, and decode append + attend
    through K8 (``attn_impl="pallas"``) or the dense gather reference.

**In place.**  The JAX package returns new caches; here the K/V rows are
written into the caller's cache tensors (which may be views of the
transformer's stacked cache), a full cache's ``length`` and a ring's
``pos`` are advanced in place, and the same dict comes back.  A pool at full minitron width is
0.4-1.6 GB, so it is never copied.

**Dropped rows.**  The JAX scatters drop rows with ``mode="drop"``
(destination page ``n_pages``).  Here every paged pool holds one extra page
at index ``n_pages`` (``init_paged_kv_cache``) that no page table names:
dropped rows land there and are never read.  Only dropped rows can share a
destination, so the duplicates that ``index_put_`` resolves in no defined
order on CUDA all land on that page.
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import flash_attention_ops
from repro_torch.kernels.paged_decode import paged_flash_decode
from repro_torch.kernels.paged_decode_ref import paged_decode_ref
from repro_torch.models.layers import apply_rope, dense_init
from repro_torch.sharding import dtensor

NEG_INF = -1e30


def init_attention(generator, cfg, lead=(), cross=False):
    d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    p = {"wq": dense_init(generator, (d, hq * dh), lead=lead),
         "wk": dense_init(generator, (d, hkv * dh), lead=lead),
         "wv": dense_init(generator, (d, hkv * dh), lead=lead),
         "wo": dense_init(generator, (hq * dh, d), lead=lead)}
    if cfg.qkv_bias and not cross:
        for name, width in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros((*lead, width * dh),
                                  device=generator.device)
    return p


class _Heads(NamedTuple):
    """How this call's heads run.  On plain params, and wherever the kv
    heads split evenly over the projections' split (``n`` pieces of
    ``wq``'s columns), the q heads run in (hkv, g) groups as the reference
    writes them.  Where they do not (qwen2.5-14b's 8 kv heads on 16
    ranks), the q heads run one by one, padded with zero heads to ``hp``, a
    multiple of ``n``, as GSPMD pads such a split, and each q head reads its
    own copy of its kv head (``kv`` below): the projections' weights are
    read so (``dtensor.pad_units``), and the heads come out split evenly."""
    hq: int
    hkv: int
    g: int
    dh: int
    hp: int
    q: Optional[list]       # pad_units' index of the q heads (None: as is)
    kv: Optional[list]      # and of the k / v heads


def heads(params, cfg, pieces=None):
    """The ``_Heads`` a call on ``params`` runs in: padded where the kv
    heads do not split evenly over the ``pieces`` (default: the pieces
    ``wq``'s columns are split into over the mesh)."""
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = hq // hkv
    n = pieces or dtensor.split_count(params["wq"], -1)
    if hkv % n == 0:
        return _Heads(hq, hkv, g, dh, hq, None, None)
    hp = -(-hq // n) * n
    return _Heads(hq, hkv, g, dh, hp, dtensor.pad_index(hq, hp),
                  [j // g if j < hq else -1 for j in range(hp)])


def _proj(params, name, x, units, index, dh, dtype):
    """``x @ w<name> (+ b<name>)`` as (..., heads, dh), the weight's
    columns (``units`` heads) read as ``index`` names them
    (``dtensor.pad_units``)."""
    w = dtensor.pad_units(params["w" + name].to(dtype), -1, units, dh, index)
    y = x @ w
    if "b" + name in params:
        y = y + dtensor.pad_units(params["b" + name].to(dtype), -1, units,
                                  dh, index)
    return y.reshape(*x.shape[:-1], -1, dh)


def _keys_split(k):
    """Whether ``k`` is a placed cache split on its sequence over more than
    one rank (``specs.cache_specs``)."""
    return dtensor.is_dtensor(k) and dtensor.split_count(k, 1) > 1


def _sdpa(q, k, v, mask, hd):
    """q: (B, S, H, dh), H = hq or (heads run one by one) hd.hp; k/v: (B,
    T, Hkv', dh), Hkv' = hkv or (projected for each q head) H; mask
    broadcastable to (B, 1, 1, S, T), or None for no mask -> (B, S, hkv, g,
    dh) or (B, S, H, 1, dh) fp32.  Keys of a cache split on its sequence
    take ``_sdpa_split_keys``.  Otherwise, on DTensors, it runs on each
    rank's rows and heads (the einsums flatten a split head dim, which
    DTensor has no rule for; ROADMAP §3).  The rows follow q's split, so
    q's rows are first split over the data axes as a placed cache's are (a
    decode step's projection can leave them whole there, which would
    gather the cache over the data axes)."""
    if _keys_split(k):
        return _sdpa_split_keys(q, k, v, mask, hd)
    B, S, H, dh = q.shape
    if hd.kv is None:
        q = q.reshape(B, S, hd.hkv, hd.g, dh)
    else:
        k, v = (t if t.shape[2] == H else
                dtensor.pad_units(t, 2, hd.hkv, 1, hd.kv) for t in (k, v))
        q = q.reshape(B, S, H, 1, dh)
    return dtensor.local_op(_sdpa_local, dtensor.over_data(q, 0), k, v,
                            mask, rows=3, heads=(2, 2, 2))


def _sdpa_split_keys(q, k, v, mask, hd):
    """Attention over a cache split on its sequence dim over the mesh
    (decode, and prefill into a placed cache), as GSPMD partitions a
    softmax over a sharded dim: each rank attends over its own keys (its
    piece of T, the mask cut alike) with its local max, sum and
    un-normalised output; the max is all-reduced, each rank rescales, and
    the sums and the (B, S, Hkv, G, dh) outputs are all-reduced.  It moves
    B S Hq (dh + 2) floats a layer, never the cache.  q's heads are taken
    whole (a decode step's q is a few rows), the pad dropped; the output is
    whole over every mesh dim but the rows' data split.  Serving only: it
    runs no backward."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Shard
    mesh = k.device_mesh
    seq = [i for i, p in enumerate(k.placements) if p == Shard(1)]
    rows = dtensor._row_placements(k)
    T = k.shape[1]
    B, S, _, dh = q.shape
    ql = dtensor.redistribute(dtensor.over_data(q, 0), mesh,
                              rows).to_local()[:, :, :hd.hq]
    ql = ql.reshape(ql.shape[0], S, hd.hkv, hd.g, dh)
    kl, vl = k.to_local(), v.to_local()
    lo, n = dtensor.piece(mesh, k.placements, 1, T)
    scores = torch.einsum("bshgd,bthd->bhgst", ql.float() * dh ** -0.5,
                          kl.float())
    if mask is not None:
        mask = dtensor.plain(mask)
        mask = mask.narrow(-1, lo, n) if mask.shape[-1] == T else mask
        scores = torch.where(mask, scores, NEG_INF)

    def over_keys(t, op):
        for i in seq:
            t = funcol.all_reduce(t, op, (mesh, i))
        return funcol.wait_tensor(t)

    m = over_keys(scores.amax(-1, keepdim=True), "max")
    p = torch.exp(scores - m)
    den = over_keys(p.sum(-1), "sum")                     # (B, Hkv, G, S)
    o = over_keys(torch.einsum("bhgst,bthd->bshgd", p, vl.float()), "sum")
    out = o / den.permute(0, 3, 1, 2)[..., None]
    return DTensor.from_local(out, mesh, rows, run_check=False)


def _out_proj(params, out, dtype, hd):
    """(B, S, heads..., dh) -> (B, S, d): the heads merged and projected by
    ``wo``, whose rows are read as the heads run (``_Heads``)."""
    B, S = out.shape[:2]
    out = out.reshape(B, S, -1).to(dtype)
    index = hd.q if out.shape[-1] != hd.hq * hd.dh else None
    return out @ dtensor.pad_units(params["wo"].to(dtype), 0, hd.hq, hd.dh,
                                   index)


def _sdpa_local(q, k, v, mask):
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bshgd,bthd->bhgst", q.float() * scale, k.float())
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgst,bthd->bshgd", probs, v.float())


def causal_mask(s, t_offset=0, window=0, device=None):
    """(S, T) boolean; query i at absolute position i + t_offset attends
    key j."""
    qpos = torch.arange(s, device=device)[:, None] + t_offset
    kpos = torch.arange(s + t_offset, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


def attention_fwd(params, x, cfg, positions, *, window=0, cache=None,
                  kv_source=None, layer_idx=0, rope=None, hd=None):
    """Returns (out, cache).  x: (B, S, d); ``rope``: the positions'
    ``layers.rope_table``, if the caller computed it; ``kv_source``: (B, T,
    d) for cross-attention; ``hd``: the ``_Heads`` to run in (default
    ``heads(params, cfg)``; a padded one computes the same).  cache:
      None                     -> full sequence, no cache returned
      {"k","v","length"}       -> full cache decode / prefill-fill
      {"k","v","pos"} (ring)   -> sliding-window ring cache
      {"kp","vp","table",...}  -> paged pools (``init_paged_kv_cache``)
      {"ck","cv"}              -> frozen cross-attention KV
    """
    dtype = x.dtype
    hd = hd or heads(params, cfg)
    hq, hkv, dh = hd.hq, hd.hkv, hd.dh
    B, S, _ = x.shape

    q = _proj(params, "q", x, hq, hd.q, dh, dtype)
    if kv_source is not None or (cache is not None and "ck" in cache):
        return _cross_fwd(params, q, cache, kv_source, hd)
    q = apply_rope(q, positions, cfg.rope_theta, rope)
    k_new = apply_rope(_proj(params, "k", x, hkv, hd.kv, dh, dtype),
                       positions, cfg.rope_theta, rope)
    v_new = _proj(params, "v", x, hkv, hd.kv, dh, dtype)

    if cache is None:
        if cfg.attn_impl == "pallas" and S >= 128:
            out = flash_attention_ops.flash_attention(
                q, k_new, v_new, causal=True, window=window)
        else:
            mask = causal_mask(S, window=window, device=x.device)
            out = _sdpa(q, k_new, v_new, mask[None, None, None], hd)
        return _out_proj(params, out, dtype, hd), None

    if "table" in cache:
        return _paged_fwd(params, cache, q, k_new, v_new, cfg, hd, window)
    if "pos" in cache:
        return _ring_fwd(params, cache, q, k_new, v_new, hd, window)

    # ---- full cache: prefill-fill or decode ----
    k, v, length = cache["k"], cache["v"], cache["length"]
    L = k.shape[1]
    start = length.clamp(0, L - S)                # dynamic_update_slice
    dtensor.write_run_(k, 1, start, _cache_rows(k_new, hd, k.dtype))
    dtensor.write_run_(v, 1, start, _cache_rows(v_new, hd, v.dtype))
    kpos = torch.arange(L, device=x.device)
    qpos = length + torch.arange(S, device=x.device)
    mask = kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    out = _sdpa(q, k, v, mask[None, None, None], hd)
    out = _out_proj(params, out, dtype, hd)
    length.add_(S)
    return out, cache


def _cache_rows(x, hd, dtype):
    """New K / V rows as a cache holds them: the hkv real heads (where they
    were read once for each q head, the first of each group, gathered whole
    over the mesh's head split), in the cache's dtype."""
    if hd.kv is not None:
        x = dtensor.unpad_units(x, 2, x.shape[2], 1, range(0, hd.hq, hd.g))
    return x.to(dtype)


def _cross_fwd(params, q, cache, kv_source, hd):
    """Cross-attention: with ``kv_source`` (prefill, or no cache) K / V are
    its projections, stored into ``cache`` as ``ck`` / ``cv`` if there is
    one; without it (decode) they are the cache's.  Every query sees every
    key."""
    dtype = q.dtype
    if kv_source is None:
        k, v = cache["ck"], cache["cv"]
    else:
        # JAX's ``kv_source @ w.astype(dtype)`` promotes: the weights
        # rounded to the compute dtype, the product in the wider of the two
        ct = torch.promote_types(kv_source.dtype, dtype)
        kv = kv_source.to(ct)
        k, v = ((kv @ dtensor.pad_units(params["w" + n].to(dtype).to(ct),
                                        -1, hd.hkv, hd.dh, hd.kv)
                 ).reshape(*kv.shape[:2], -1, hd.dh) for n in ("k", "v"))
        if cache is not None:
            dtensor.copy_(cache["ck"], _cache_rows(k, hd, k.dtype))
            dtensor.copy_(cache["cv"], _cache_rows(v, hd, v.dtype))
    out = _sdpa(q, k, v, None, hd)
    return _out_proj(params, out, dtype, hd), cache


class _RingCheck(threading.local):
    on = True


_RING_CHECK = _RingCheck()


@contextlib.contextmanager
def fresh_ring_caches():
    """Within it a ring-cache prefill does not read the ring's position to
    the host to check that it is 0: for a caller whose caches are fresh
    from ``init_cache`` (the dry-run, whose fake tensors hold no value to
    read).  Everywhere else the check stands."""
    _RING_CHECK.on = False
    try:
        yield
    finally:
        _RING_CHECK.on = True


def _ring_fwd(params, cache, q, k_new, v_new, hd, window):
    """The sliding-window ring cache, (B, W, Hkv, dh) and the absolute
    position ``pos`` of the next token.

    Prefill (S > 1) starts at position 0 (it raises otherwise): windowed
    causal attention over the prompt, then its last min(S, W) keys and
    values into slots ``p mod W``.  Decode (S == 1) writes slot ``pos mod
    W`` and attends over the slots whose absolute position (the largest p
    <= pos with p = j mod W) lies in the window."""
    dtype = q.dtype
    S = q.shape[1]
    k, v, pos = cache["k"], cache["v"], cache["pos"]
    W = k.shape[1]
    dev = q.device
    if S > 1:
        if _RING_CHECK.on and int(pos) != 0:
            raise ValueError("a ring-cache prefill starts at position 0")
        mask = causal_mask(S, window=window, device=dev)
        out = _sdpa(q, k_new, v_new, mask[None, None, None], hd)
        take = min(S, W)                # slots (S - take + t) mod W
        dtensor.write_run_(k, 1, S - take,
                           _cache_rows(k_new[:, S - take:], hd, k.dtype))
        dtensor.write_run_(v, 1, S - take,
                           _cache_rows(v_new[:, S - take:], hd, v.dtype))
        pos.fill_(S)
    else:
        dtensor.write_run_(k, 1, pos % W, _cache_rows(k_new, hd, k.dtype))
        dtensor.write_run_(v, 1, pos % W, _cache_rows(v_new, hd, v.dtype))
        j = torch.arange(W, device=dev)
        abs_pos = pos - (pos - j) % W
        valid = (abs_pos >= 0) & (abs_pos <= pos)
        if window:
            valid &= abs_pos > pos - window
        out = _sdpa(q, k, v, valid[None, None, None, None, :], hd)
        pos.add_(1)
    return _out_proj(params, out, dtype, hd), cache


def _paged_quant(x):
    """int8 KV append quantisation: x (..., Hkv, dh) -> (codes int8 of
    x.shape, scales fp32 of x.shape[:-1]).  Blockwise absmax with
    qblk = dh and 127 levels, one scale a cache row and head, written as the
    codec's ``quant_encode``: ``amax / 127`` divided (eager JAX's value), a
    NaN quotient code 0."""
    flat = x.reshape(-1, x.shape[-1]).float()
    amax = flat.abs().amax(1)
    s = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                    torch.ones_like(amax))
    q = torch.clamp(torch.round(flat / s[:, None]), -127.0, 127.0)
    q = torch.nan_to_num(q, nan=0.0).to(torch.int8)
    return q.reshape(x.shape), s.reshape(x.shape[:-1])


def _paged_fwd(params, cache, q, k_new, v_new, cfg, hd, window):
    """Paged-pool branch of attention_fwd (serving; no sliding window, as
    in the JAX package).

    Cache contract (see ``init_paged_kv_cache``):
      kp, vp    (n_pages + 1, page, Hkv, dh)  shared pools (fp32 or int8
                                              codes); page n_pages drops
      ks, vs    (n_pages + 1, page, Hkv) fp32 per-(row, head) scales (int8)
      table     (A, maxp) int32     per-slot page table (unallocated = 0)
      length    (A,) int32          valid tokens already in the slot
      active    (A,) fp32           1 = slot holds a live request
      new_valid (A,) int32          prefill only: valid rows of x

    Prefill (S > 1) scatters rows [0, new_valid) into the slot's pages;
    decode (S == 1) appends one row at ``length`` a live slot and attends
    through K8 (``attn_impl="pallas"``) or the dense gather reference.
    """
    dtype = k_new.dtype
    hq, dh = hd.hq, hd.dh
    B, S = q.shape[0], q.shape[1]
    kp, vp, table = cache["kp"], cache["vp"], cache["table"]
    n_pages, page = kp.shape[0] - 1, kp.shape[1]
    maxp = table.shape[1]
    int8 = "ks" in cache
    length, active = cache["length"], cache["active"]
    dev = q.device

    if S > 1:
        mask = causal_mask(S, window=window, device=dev)
        out = _sdpa(q, k_new, v_new, mask[None, None, None],
                    hd).reshape(B, S, hq * dh)
        pos = torch.arange(S, device=dev)
        valid = pos[None, :] < cache["new_valid"][:, None]         # (B, S)
        prow = (pos // page).clamp(0, maxp - 1)
        pg = table.gather(1, prow[None].expand(B, S).long())
        dest = torch.where(valid, pg, n_pages)
        row = (pos % page).expand(B, S)
        _append(cache, dest, row, k_new, v_new, int8)
        out = out.to(dtype) @ params["wo"].to(dtype)
        return out, cache

    prow = (length // page).clamp(0, maxp - 1)
    pg = table.gather(1, prow[:, None].long())[:, 0]
    dest = torch.where(active > 0, pg, n_pages)
    _append(cache, dest, length % page, k_new[:, 0], v_new[:, 0], int8)
    n_keys = torch.where(active > 0, length + 1, 0).to(torch.int32)
    attend = paged_flash_decode if cfg.attn_impl == "pallas" \
        else paged_decode_ref
    out3 = attend(q[:, 0], kp, vp, table, n_keys,
                  k_scale=cache["ks"] if int8 else None,
                  v_scale=cache["vs"] if int8 else None)
    out = out3.reshape(B, 1, hq * dh).to(dtype) @ params["wo"].to(dtype)
    return out, cache


def _append(cache, dest, row, k, v, int8):
    """Write K/V rows at (page dest, row) of the pools, in place (int8:
    codes and scales)."""
    if int8:
        k, ks = _paged_quant(k)
        v, vs = _paged_quant(v)
        cache["ks"][dest, row] = ks
        cache["vs"][dest, row] = vs
    cache["kp"][dest, row] = k.to(cache["kp"].dtype)
    cache["vp"][dest, row] = v.to(cache["vp"].dtype)


def init_kv_cache(cfg, batch, max_len, *, ring=False, dtype=torch.bfloat16,
                  device=None):
    """A full cache of ``max_len`` rows, or with ``ring`` a ring of
    ``max_len`` slots (the caller passes the window)."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos" if ring else "length":
                torch.zeros((), dtype=torch.int32, device=device)}


def init_paged_kv_cache(cfg, slots, num_pages, page_size, max_pages, *,
                        int8=False, dtype=torch.float32, device=None):
    """One attention layer's paged pool cache (serving).  The pools hold
    ``num_pages + 1`` pages: the last is the drop page (module docstring).
    Unallocated table entries stay 0, a valid pool index masked out by
    length / active.  ``int8`` stores codes plus per-(row, head) fp32
    scales (see ``_paged_quant``)."""
    hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (num_pages + 1, page_size, hkv, dh)
    pool_dtype = torch.int8 if int8 else dtype
    c = {"kp": torch.zeros(shape, dtype=pool_dtype, device=device),
         "vp": torch.zeros(shape, dtype=pool_dtype, device=device),
         "table": torch.zeros((slots, max_pages), dtype=torch.int32,
                              device=device),
         "length": torch.zeros((slots,), dtype=torch.int32, device=device),
         "active": torch.zeros((slots,), device=device),
         "new_valid": torch.zeros((slots,), dtype=torch.int32,
                                  device=device)}
    if int8:
        c["ks"] = torch.ones(shape[:-1], device=device)
        c["vs"] = torch.ones(shape[:-1], device=device)
    return c
