"""Mamba-style selective SSM block (port of ``repro/models/ssm.py``; used
inside hymba's hybrid layers).

The selective scan runs as a *chunked associative scan*: a loop over
chunks of ``cfg.scan_chunk`` steps carrying the hidden state, with the
JAX package's ``lax.associative_scan`` recursion inside each chunk
(``associative_scan``: pairs combined, the half-length scan recursed, the
even positions filled in; the same combines in the same tree).  Padded
steps of the last chunk get dt = 0, identity transitions (a = 1, b = 0)
that leave the carried state as it is.  The chunk count is a Python int of
the static shapes, so a forward is capture-safe.

``jax.nn.softplus`` is ``logaddexp(x, 0)``; so is ``_softplus`` (torch's
``softplus`` switches to x past its threshold).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (DTYPES, causal_conv_carried,
                                       causal_depthwise_conv, dense_init)
from repro_torch.sharding import dtensor


def init_mamba(generator, cfg, d_model=None, lead=()):
    d = d_model or cfg.d_model
    di = cfg.ssm_expand * d
    st, dtr, K = cfg.ssm_state, cfg.resolved_dt_rank, cfg.ssm_conv
    dev = generator.device
    full = lambda shape, v: torch.full((*lead, *shape), v, device=dev)
    # S4D-real A initialisation: A = -(1..state)
    a = torch.arange(1, st + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(generator, (d, 2 * di), lead=lead),
        "conv_w": dense_init(generator, (K, di), lead=lead),
        "conv_b": full((di,), 0.0),
        "x_proj": dense_init(generator, (di, dtr + 2 * st), lead=lead),
        "dt_proj": dense_init(generator, (dtr, di), lead=lead),
        "dt_bias": full((di,), 0.0).add_(
            torch.log(torch.expm1(torch.tensor(0.01, device=dev)))),
        "A_log": torch.log(a).expand(*lead, di, st).clone(),
        "D": full((di,), 1.0),
        "out_proj": dense_init(generator, (di, d), lead=lead),
    }


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssm_coeffs(params, xc, cfg, dtype, step_mask=None):
    """xc: (..., di) conv output -> (decay a, input b) in the scan dtype,
    and C for the readout.  ``step_mask`` zeroes dt on padded steps."""
    st, dtr = cfg.ssm_state, cfg.resolved_dt_rank
    dbc = (xc @ params["x_proj"].to(dtype)).float()
    dt_r, Bm, Cm = torch.split(dbc, [dtr, st, st], dim=-1)
    dt = _softplus(dt_r @ params["dt_proj"].float() + params["dt_bias"])
    if step_mask is not None:
        dt = dt * step_mask
    A = -torch.exp(params["A_log"])                            # (di, st)
    a = torch.exp(dt[..., None] * A)                           # (..., di, st)
    b = (dt * xc.float())[..., None] * Bm[..., None, :]
    sd = DTYPES[cfg.ssm_scan_dtype]
    return a.to(sd), b.to(sd), Cm


def _decode_step(params, xc, h0, cfg, dtype):
    """One recurrence step: (new state (B, di, st), readout (B, di) fp32)."""
    a, b, Cm = _ssm_coeffs(params, xc, cfg, dtype)
    h = a * h0 + b                                 # (B, di, st)
    y = torch.einsum("bds,bs->bd", h.float(), Cm) + params["D"] * xc.float()
    return h, y


def _combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, ar * bl + br


def _interleave(even, odd):
    """even at positions 0, 2, ..., odd at 1, 3, ... along dim 1."""
    n = even.shape[1] + odd.shape[1]
    if odd.shape[1] < even.shape[1]:
        odd = torch.cat([odd, torch.zeros_like(odd[:, :1])], dim=1)
    return torch.stack([even, odd], dim=2).flatten(1, 2)[:, :n]


def associative_scan(elems):
    """The inclusive scan of (a, b) pairs along dim 1 under ``_combine``,
    by ``lax.associative_scan``'s recursion."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:n - 1:2] for e in elems],
                       [e[:, 1::2] for e in elems])
    odd = associative_scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd],
                        [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _scan_seq(params, xc, h0, cfg, dtype):
    """The selective scan of a full sequence xc (B, S, di) from the carried
    state h0 (None: zeros) -> (y (B, S, di) fp32 with the skip term, the
    last state)."""
    B, S, di = xc.shape
    chunk = min(cfg.scan_chunk, S)
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    xc_p = F.pad(xc, (0, 0, 0, pad))
    smask = (torch.arange(n_chunks * chunk, device=xc.device) < S).float()

    sd = DTYPES[cfg.ssm_scan_dtype]
    h = (h0.to(sd) if h0 is not None
         else torch.zeros((B, di, cfg.ssm_state), dtype=sd,
                          device=xc.device))
    ys = []
    for c in range(n_chunks):
        xck = xc_p[:, c * chunk:(c + 1) * chunk]
        mk = smask[c * chunk:(c + 1) * chunk].reshape(1, chunk, 1)
        a, b, Cm = _ssm_coeffs(params, xck, cfg, dtype, step_mask=mk)
        # the carried state as step 0's contribution: h_t = a_t h_{t-1} + b_t
        b = torch.cat([b[:, :1] + a[:, :1] * h[:, None], b[:, 1:]], dim=1)
        _, hh = associative_scan([a, b])
        ys.append(torch.einsum("bcds,bcs->bcd", hh.float(), Cm))
        h = hh[:, -1]
    y = torch.cat(ys, dim=1)[:, :S]
    return y + params["D"] * xc.float(), h


def mamba_fwd(params, x, cfg, state=None):
    """x: (B, S, d).  state {"h": (B, di, st), "conv": (B, K - 1, di)}:
    S == 1 is a one-step decode, S > 1 a prefill from the carried state;
    both write the new state into ``state`` in place.  Returns (y, state or
    None)."""
    dtype = x.dtype
    xin, z = (x @ params["in_proj"].to(dtype)).chunk(2, dim=-1)

    if state is not None and x.shape[1] == 1:      # ---- one-step decode
        xc, conv_state = causal_depthwise_conv(
            xin, params["conv_w"], params["conv_b"], state["conv"])
        xc = F.silu(xc)[:, 0]                      # (B, di)
        keys = ("x_proj", "dt_proj", "dt_bias", "A_log", "D")
        # on DTensors the step runs on each rank's rows with its channels
        # and the SSM weights gathered, as the scan does (ROADMAP §3)
        h, y = dtensor.local_op(
            lambda xc_, h0_, *w: _decode_step(dict(zip(keys, w)), xc_, h0_,
                                              cfg, dtype),
            xc, state["h"], *(params[k] for k in keys), rows=2)
        y = (y.to(dtype) * F.silu(z[:, 0]))[:, None]
        out = y @ params["out_proj"].to(dtype)
        dtensor.copy_(state["h"], h)
        dtensor.copy_(state["conv"], conv_state)
        return out, state

    # ---- full sequence (train, or prefill when state is given)
    if state is not None:
        xc, conv_tail = causal_conv_carried(xin, params["conv_w"],
                                            params["conv_b"], state["conv"])
    else:
        xc, _ = causal_depthwise_conv(xin, params["conv_w"],
                                      params["conv_b"])
    xc = F.silu(xc)
    h0 = state["h"] if state is not None else None
    keys = ("x_proj", "dt_proj", "dt_bias", "A_log", "D")
    # on DTensors the chunked scan runs on each rank's rows with its
    # channels and weights gathered (ROADMAP §3)
    y, h = dtensor.local_op(
        lambda xc_, h0_, *w: _scan_seq(dict(zip(keys, w)), xc_, h0_, cfg,
                                       dtype),
        xc, h0, *(params[k] for k in keys), rows=2)
    y = y.to(dtype) * F.silu(z)
    out = y @ params["out_proj"].to(dtype)
    if state is not None:
        dtensor.copy_(state["h"], h)
        dtensor.copy_(state["conv"], conv_tail)
        return out, state
    return out, None


def init_mamba_state(cfg, batch, dtype=torch.float32, device=None):
    di, K = cfg.d_inner, cfg.ssm_conv
    return {"h": torch.zeros((batch, di, cfg.ssm_state), device=device),
            "conv": torch.zeros((batch, K - 1, di), dtype=dtype,
                                device=device)}
