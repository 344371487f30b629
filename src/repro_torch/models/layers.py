"""Parameter init helpers and primitive layers (port of
``repro/models/layers.py``).

Init helpers take a ``lead`` shape: the transformer's (n_units,) layer
stack is drawn in one stacked tensor, not stacked after the fact, so a
full-width model is never held twice.  ``in_axis`` counts from behind the
lead axes.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _ShapeOnly:
    """A stand-in for the init's generator: every leaf is made on the
    ``meta`` device and nothing is drawn, so an init on it allocates
    nothing and gives the shapes and dtypes of a full-width model (the
    counterpart of ``jax.eval_shape`` of the init)."""
    device = torch.device("meta")


SHAPE_ONLY = _ShapeOnly()


def dense_init(generator: torch.Generator, shape, in_axis=0,
               dtype=torch.float32, lead=()):
    """Truncated-normal fan-in init (LeCun-style): a standard normal cut at
    ±2, scaled by 1/sqrt(fan_in), drawn on the generator's device."""
    fan_in = int(np.prod([shape[i] for i in np.atleast_1d(in_axis)]))
    std = 1.0 / np.sqrt(max(fan_in, 1))
    w = torch.empty((*lead, *shape), dtype=dtype, device=generator.device)
    if w.is_meta:
        return w
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(std)


def embed_init(generator: torch.Generator, shape, dtype=torch.float32):
    w = torch.empty(shape, dtype=dtype, device=generator.device)
    if w.is_meta:
        return w
    return w.normal_(generator=generator).mul_(0.02)


def rms_norm(x, scale, eps=1e-5):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def init_rms_norm(d, device, lead=()):
    return {"scale": torch.ones((*lead, d), device=device)}


def group_norm(x, scale, n_groups, eps=1e-5):
    """Per-head group norm of the xLSTM cells.  x: (..., d)."""
    *lead, d = x.shape
    x32 = x.float().reshape(*lead, n_groups, d // n_groups)
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    y = ((x32 - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (y * scale.float()).to(x.dtype)


def rope_freqs(head_dim, theta, device=None):
    """fp32 theta^-(2i / head_dim); the Python base stays a scalar, so no
    host-to-device copy (and no stream sync) happens here."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def rope_table(positions, head_dim, theta):
    """(cos, sin) of the rotary angles, each (B or 1, S, 1, dh/2) fp32, for
    positions (B, S) or (S,).  A forward computes it once and hands it to
    every layer (JAX's XLA folds the per-layer recomputation the same way)."""
    freqs = rope_freqs(head_dim, theta, positions.device)    # (dh/2,)
    angles = positions[..., None].float() * freqs
    if angles.dim() == 2:                                    # (S, dh/2)
        angles = angles[None]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x, positions, theta, table=None):
    """x: (B, S, H, dh); positions: (B, S) or (S,) integers; ``table`` the
    positions' ``rope_table`` if it is at hand."""
    cos, sin = table or rope_table(positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(generator, d_model, d_ff, lead=()):
    return {"wg": dense_init(generator, (d_model, d_ff), lead=lead),
            "wu": dense_init(generator, (d_model, d_ff), lead=lead),
            "wo": dense_init(generator, (d_ff, d_model), lead=lead)}


def mlp_fwd(params, x, dtype):
    """SwiGLU: (silu(x Wg) * x Wu) Wo, in ``dtype``."""
    h = F.silu(x @ params["wg"].to(dtype)) * (x @ params["wu"].to(dtype))
    return h @ params["wo"].to(dtype)


def _taps(window, kernel):
    """sum_k window[:, k:k + S] * kernel[k] in fp32, k in order: the causal
    depthwise conv of a (B, S + K - 1, C) window."""
    K = kernel.shape[0]
    S = window.shape[1] - K + 1
    w, kern = window.float(), kernel.float()
    y = w[:, 0:S] * kern[0]
    for k in range(1, K):
        y = y + w[:, k:k + S] * kern[k]
    return y


def causal_depthwise_conv(x, kernel, bias, state=None):
    """Causal depthwise 1D conv.  x: (B, S, C); kernel: (K, C).

    With ``state`` (B, K - 1, C), a one-step decode update: returns (y,
    new_state) with S == 1.  Else the left-padded sequence conv and None."""
    K = kernel.shape[0]
    if state is not None:
        window = torch.cat([state.to(x.dtype), x], dim=1)     # (B, K, C)
        y = (_taps(window, kernel) + bias.float()).to(x.dtype)
        return y, window[:, 1:]
    pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    y = _taps(torch.cat([pad, x], dim=1), kernel)
    return (y + bias.float()).to(x.dtype), None


def causal_conv_carried(x, kernel, bias, conv_state):
    """The causal conv of a sequence x (B, S, C) seeded with the carried
    left context ``conv_state`` (B, K - 1, C) in place of zeros (a prefill
    after earlier steps) -> (conv out, the new conv state: the last K - 1
    inputs)."""
    K = kernel.shape[0]
    ext = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y, _ = causal_depthwise_conv(ext, kernel, bias)
    return y[:, K - 1:], ext[:, -(K - 1):]
