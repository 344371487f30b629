"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory)
[arXiv:2405.04517] (port of ``repro/models/xlstm.py``).

  * mLSTM runs in *chunkwise-parallel* form: attention-like matmuls inside
    a chunk of ``cfg.scan_chunk`` steps and a recurrent carry (C_hat,
    n_hat, m) across chunks; the exponential gates are stabilised in log
    space by m, which starts at -1e30 (not -inf: -inf - -inf is NaN).
  * sLSTM keeps its sequential h-recurrence: a loop over time, vectorised
    over batch and heads.
Decode is one recurrent step for both.  The loops' trip counts are Python
ints of the static shapes and states are written in place, so a forward
is capture-safe.  ``jax.nn.gelu`` is the tanh approximation, and
``jax.nn.log_sigmoid`` is -softplus(-x) with softplus = logaddexp(x, 0);
both are written so here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (causal_conv_carried,
                                       causal_depthwise_conv, dense_init,
                                       group_norm)
from repro_torch.sharding import dtensor

M_INIT = -1e30          # the stabiliser's initial value


def _log_sigmoid(x):
    return -torch.logaddexp(-x, torch.zeros_like(x))


# ======================================================================
# mLSTM
# ======================================================================
def init_mlstm(generator, cfg, lead=()):
    d = cfg.d_model
    di = 2 * d                           # xLSTM pre-up-projection factor 2
    H = cfg.n_heads
    dev = generator.device
    full = lambda n, v: torch.full((*lead, n), v, device=dev)
    return {
        "up": dense_init(generator, (d, 2 * di), lead=lead),
        "conv_w": dense_init(generator, (cfg.ssm_conv, di), lead=lead),
        "conv_b": full(di, 0.0),
        "wq": dense_init(generator, (di, di), lead=lead),
        "wk": dense_init(generator, (di, di), lead=lead),
        "wv": dense_init(generator, (di, di), lead=lead),
        "wi": dense_init(generator, (di, H), lead=lead),
        "bi": full(H, 0.0),
        "wf": dense_init(generator, (di, H), lead=lead),
        "bf": full(H, 3.0),              # forget-gate bias init high
        "gn": full(di, 1.0),
        "down": dense_init(generator, (di, d), lead=lead),
    }


def _mlstm_heads(params, H):
    """The heads the mLSTM runs in: ``H`` rounded up to a multiple of the
    number of pieces ``wq``'s columns are split into over the mesh (GSPMD
    pads such a split; xlstm-350m's 4 heads on 16 ranks run as 16, the
    last 12 zero); ``H`` on plain params or an even split."""
    n = dtensor.split_count(params["wq"], -1)
    return -(-H // n) * n


def _mlstm_inputs(params, xm, H, Hp, dtype):
    """q, k / sqrt(dh), v as (..., Hp, dh) and the gates' logs (..., Hp):
    the projections' columns read padded from ``H`` to ``Hp`` heads
    (``dtensor.pad_units``: a pad head is zero in and takes no part in any
    result), so on a placed state the heads split evenly over "model"."""
    di = params["wq"].shape[0]
    dh = di // H
    lead = xm.shape[:-1]
    pad = dtensor.pad_index(H, Hp)
    q, k, v = ((xm @ dtensor.pad_units(params[w].to(dtype), -1, H, dh, pad))
               .reshape(*lead, Hp, dh) for w in ("wq", "wk", "wv"))
    gate = lambda w, b: dtensor.pad_units(
        (xm @ params[w].to(dtype)).float() + params[b], -1, H, 1, pad)
    li = gate("wi", "bi")
    lf = _log_sigmoid(gate("wf", "bf"))
    # jnp.sqrt(dh) in fp32, cast to the compute dtype (a device fill)
    root = torch.full((), dh ** 0.5, device=xm.device).to(dtype)
    return q, k / root, v, li, lf


def _mlstm_chunkwise(q, k, v, li, lf, C_prev, n_prev, m_prev, L):
    """The chunkwise-parallel mLSTM over (B, S, H, dh) q, k, v and (B, S,
    H) gates from the carry (C, n, m) -> (h (B, S, H dh) fp32, C, n, m)."""
    B, S, H, dh = q.shape
    n_chunks = -(-S // L)
    pad = n_chunks * L - S
    if pad:         # padded steps must not contribute: input gate -1e30
        li = torch.cat([li, li.new_full((B, pad, H), -1e30)], dim=1)
        lf = F.pad(lf, (0, 0, 0, pad))
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))

    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    hs = []
    for c in range(n_chunks):
        sl = slice(c * L, (c + 1) * L)
        q32, k32, v32 = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        li_, lf_ = li[:, sl], lf[:, sl]
        b = torch.cumsum(lf_, dim=1)          # (B, L, H) log decay in chunk
        g = torch.cummax(li_ - b, dim=1).values
        u = torch.maximum(m_prev[:, None], g)  # m_t = b_t + u_t
        wlog = (li_ - b)[:, None, :, :] - u[:, :, None, :]   # (B, T, S, H)
        w = torch.exp(torch.where(tri[None, :, :, None], wlog, -torch.inf))
        scores = torch.einsum("bthd,bshd->btsh", q32, k32)
        h_intra = torch.einsum("btsh,bshd->bthd", scores * w, v32)
        n_intra = torch.einsum("btsh,bshd->bthd", w, k32)
        c_int = torch.exp(m_prev[:, None] - u)                # (B, L, H)
        h_inter = torch.einsum("bthd,bhde->bthe", q32, C_prev) \
            * c_int[..., None]
        n_t = n_intra + n_prev[:, None] * c_int[..., None]
        m_t = b + u
        den = torch.maximum(torch.einsum("bthd,bthd->bth", n_t, q32).abs(),
                            torch.exp(-m_t))[..., None]
        hs.append((h_intra + h_inter) / den)                  # (B, L, H, dh)
        # the carry at the chunk's end: C_hat = C e^{-m}, m_new = bL + uL
        uL, bL = u[:, -1], b[:, -1]
        wC = torch.exp((li_ - b) - uL[:, None])               # (B, L, H)
        decay = torch.exp(m_prev - uL)
        C_prev = decay[..., None, None] * C_prev + torch.einsum(
            "bshd,bshe->bhde", wC[..., None] * k32, v32)
        n_prev = decay[..., None] * n_prev + torch.einsum(
            "bsh,bshd->bhd", wC, k32)
        m_prev = bL + uL
    h = torch.cat(hs, dim=1).reshape(B, n_chunks * L, H * dh)[:, :S]
    return h, C_prev, n_prev, m_prev


def _head_norm(h, scale, H):
    """The mLSTM's per-head group norm of (B, S, Hp dh) rows, the pad heads
    (past ``H``; ``_mlstm_heads``) dropped first.  On DTensors it runs on
    each rank's rows with the heads whole: the grad that comes back from
    ``down`` is split over "model" on the merged head dim, which DTensor
    cannot unflatten into H heads that do not split there (ROADMAP §3)."""
    n = scale.shape[-1]
    return dtensor.local_op(
        lambda h_, g_: group_norm(h_.narrow(-1, 0, n), g_, H), h, scale,
        rows=1)


def _state_heads(state, Hp):
    """The recurrent state ``state`` (C (B, H, dh, dh), n (B, H, dh), m (B,
    H)) padded to ``Hp`` heads (zeros: a pad head's output stays 0)."""
    H = state["m"].shape[1]
    return tuple(dtensor.pad_units(state[key], 1, H, 1,
                                   dtensor.pad_index(H, Hp))
                 for key in ("C", "n", "m"))


def _write_state(state, vals):
    """The carried (C, n, m, conv) written back into ``state``, the pad
    heads dropped."""
    H = state["m"].shape[1]
    for key, val in zip(("C", "n", "m", "conv"), vals):
        if key != "conv" and val.shape[1] != H:
            val = dtensor.unpad_units(val, 1, val.shape[1], 1, range(H))
        dtensor.copy_(state[key], val)


def _mlstm_step(q, k, v, li, lf, C0, n0, m0):
    """One recurrent mLSTM step on (B, H, ...) inputs and state -> (h (B,
    H, dh), C, n, m)."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    m_new = torch.maximum(lf + m0, li)                        # (B, H)
    fp = torch.exp(lf + m0 - m_new)[..., None]
    ip = torch.exp(li - m_new)[..., None]
    C = fp[..., None] * C0 \
        + ip[..., None] * (k32[..., None] * v32[..., None, :])
    n = fp * n0 + ip * k32
    num = torch.einsum("bhkv,bhk->bhv", C, q32)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, q32).abs(),
                        torch.exp(-m_new))[..., None]
    return num / den, C, n, m_new


def mlstm_fwd(params, x, cfg, state=None):
    """x: (B, S, d); state {"C", "n", "m", "conv"}: S == 1 is one recurrent
    step, S > 1 a prefill; both write ``state`` in place.  Returns (y,
    state or None)."""
    dtype = x.dtype
    H = cfg.n_heads
    Hp = _mlstm_heads(params, H)
    xm, z = (x @ params["up"].to(dtype)).chunk(2, dim=-1)

    if state is not None and x.shape[1] == 1:   # ---- one recurrent step
        xc, conv_state = causal_depthwise_conv(
            xm, params["conv_w"], params["conv_b"], state["conv"])
        xc = F.silu(xc)
        q, k, v, li, lf = _mlstm_inputs(params, xc[:, 0], H, Hp, dtype)
        # row-local and local to a head: on DTensors each rank runs its
        # rows and its heads (ROADMAP §3)
        h, C, n, m_new = dtensor.local_op(
            _mlstm_step, q, k, v, li, lf, *_state_heads(state, Hp), rows=8,
            heads=(1,) * 8, out_heads=(1, 1, 1, 1))
        h = h.reshape(x.shape[0], 1, -1).to(dtype)
        h = _head_norm(h, params["gn"], H)
        out = (h * F.silu(z)) @ params["down"].to(dtype)
        _write_state(state, (C, n, m_new, conv_state))
        return out, state

    # ---- chunkwise-parallel form (train, or prefill when state given)
    B, S, _ = x.shape
    if state is None:
        xc, conv_tail = causal_depthwise_conv(xm, params["conv_w"],
                                              params["conv_b"])
    else:
        xc, conv_tail = causal_conv_carried(xm, params["conv_w"],
                                            params["conv_b"], state["conv"])
    xc = F.silu(xc)
    # (B, S, Hp, dh), (B, S, Hp)
    q, k, v, li, lf = _mlstm_inputs(params, xc, H, Hp, dtype)
    dh = q.shape[-1]
    if state is not None:
        C_prev, n_prev, m_prev = _state_heads(state, Hp)
    else:
        C_prev = x.new_zeros((B, Hp, dh, dh), dtype=torch.float32)
        n_prev = x.new_zeros((B, Hp, dh), dtype=torch.float32)
        m_prev = x.new_full((B, Hp), M_INIT, dtype=torch.float32)
    # row-local and local to a head: on DTensors each rank runs its rows
    # and its heads (ROADMAP §3)
    h, C_prev, n_prev, m_prev = dtensor.local_op(
        lambda *a: _mlstm_chunkwise(*a, min(cfg.scan_chunk, S)),
        q, k, v, li, lf, C_prev, n_prev, m_prev, rows=8,
        heads=(2, 2, 2, 2, 2, 1, 1, 1), out_heads=(2, 1, 1, 1))
    h = _head_norm(h.to(dtype), params["gn"], H)
    out = (h * F.silu(z)) @ params["down"].to(dtype)
    if state is not None:
        _write_state(state, (C_prev, n_prev, m_prev, conv_tail))
        return out, state
    return out, None


def init_mlstm_state(cfg, batch, dtype=torch.float32, device=None):
    H, di = cfg.n_heads, 2 * cfg.d_model
    dh = di // H
    return {"C": torch.zeros((batch, H, dh, dh), device=device),
            "n": torch.zeros((batch, H, dh), device=device),
            "m": torch.full((batch, H), M_INIT, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype,
                                device=device)}


# ======================================================================
# sLSTM
# ======================================================================
def init_slstm(generator, cfg, lead=()):
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    dev = generator.device
    dff = -(-int(d * 4 / 3) // 128) * 128   # 128-aligned
    bias = torch.cat([torch.zeros(d), torch.full((d,), 3.0),
                      torch.zeros(2 * d)]).to(dev)
    return {
        "w": dense_init(generator, (d, 4 * d), lead=lead),   # i,f,z,o from x
        "r": dense_init(generator, (H, dh, 4 * dh), lead=lead),
        "b": bias.expand(*lead, 4 * d).clone(),
        "gn": torch.ones((*lead, d), device=dev),
        "up_g": dense_init(generator, (d, dff), lead=lead),
        "up_u": dense_init(generator, (d, dff), lead=lead),
        "down": dense_init(generator, (dff, d), lead=lead),
    }


def _slstm_step(params, carry, gx, H):
    """gx: (B, 4d) pre-activations from x as [i|f|z|o] blocks of d; carry
    (c, n, m, h), each (B, H, dh)."""
    c, n, m, h = carry
    B = gx.shape[0]
    dh = h.shape[-1]
    rec = torch.einsum("bhd,hde->bhe", h, params["r"])   # (B, H, 4dh)
    g = gx.reshape(B, 4, H, dh) \
        + rec.reshape(B, H, 4, dh).movedim(2, 1) \
        + params["b"].reshape(4, H, dh)
    gi, gf, gz, go = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
    lf = _log_sigmoid(gf)
    m_new = torch.maximum(lf + m, gi)
    ip = torch.exp(gi - m_new)
    fp = torch.exp(lf + m - m_new)
    c_new = fp * c + ip * torch.tanh(gz)
    n_new = fp * n + ip
    h_new = torch.sigmoid(go) * c_new / n_new.clamp_min(1.0)
    return c_new, n_new, m_new, h_new


def _slstm_scan(gx, carry, r, b, H):
    """The sLSTM recurrence over (B, S, 4d) pre-activations from the carry
    -> (h (B, S, d), c, n, m, h)."""
    B, S, d4 = gx.shape
    hs = []
    for t in range(S):
        carry = _slstm_step({"r": r, "b": b}, carry, gx[:, t], H)
        hs.append(carry[3])
    return (torch.stack(hs, dim=1).reshape(B, S, d4 // 4),) + tuple(carry)


def slstm_fwd(params, x, cfg, state=None):
    """x: (B, S, d); state {"c", "n", "m", "h"} is advanced in place.
    Returns (y, state or None)."""
    dtype = x.dtype
    B, _, d = x.shape
    H = cfg.n_heads
    dh = d // H
    gx = (x @ params["w"].to(dtype)).float()            # (B, S, 4d)
    if state is not None:
        carry = (state["c"], state["n"], state["m"], state["h"])
    else:
        zero = x.new_zeros((B, H, dh), dtype=torch.float32)
        carry = (zero, zero, x.new_full((B, H, dh), M_INIT,
                                        dtype=torch.float32), zero)
    # row-local; on DTensors the recurrence runs on gathered heads and
    # weights (ROADMAP §3)
    hseq, *carry = dtensor.local_op(
        lambda g, c, n, m, h, r, b: _slstm_scan(g, (c, n, m, h), r, b, H),
        gx, *carry, params["r"], params["b"], rows=5)
    if state is not None:
        for key, val in zip(("c", "n", "m", "h"), carry):
            dtensor.copy_(state[key], val)
    y = group_norm(hseq.to(dtype), params["gn"], H)
    # post-up-projection (factor 4/3, GLU)
    u = F.gelu(y @ params["up_g"].to(dtype), approximate="tanh") \
        * (y @ params["up_u"].to(dtype))
    return u @ params["down"].to(dtype), state


def init_slstm_state(cfg, batch, device=None):
    H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    z = lambda: torch.zeros((batch, H, dh), device=device)
    return {"c": z(), "n": z(), "m": torch.full((batch, H, dh), M_INIT,
                                                device=device), "h": z()}
