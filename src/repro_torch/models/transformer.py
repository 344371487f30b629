"""Composable decoder-only transformer covering every assigned
architecture (port of ``repro/models/transformer.py``).

Block kinds (``cfg.layers``):
  attn    pre-norm self-attention + SwiGLU MLP           (dense archs)
  moe     pre-norm self-attention + top-k MoE FFN        (granite, dbrx)
  hybrid  pre-norm parallel attention | mamba + MLP      (hymba)
  mlstm   matrix-memory xLSTM block                      (xlstm)
  slstm   scalar-memory xLSTM block                      (xlstm)
  xattn   pre-norm cross-attention (image) + MLP         (llama-3.2-vision)

Parameters keep the JAX layout: each leaf of ``params["layers"]`` is
stacked over the layer *units* (a unit is one repetition of
``layer_cycle``), (n_units, ...).  ``forward`` is JAX's ``scan_unroll``
branch, the same function as its ``lax.scan``: a Python loop over the
units, each stacked leaf unbound once into its units' views (no copy).
With ``cfg.remat`` a unit runs under ``torch.utils.checkpoint`` when grad
is on, as the reference wraps its unit in ``jax.checkpoint``.  The MoE
layers' auxiliary losses are summed over the layers.

Modes:
  full sequence : ``forward(cache=None)`` (scoring, the loss)
  prefill       : ``forward(cache=...)`` fills a full, ring, paged,
                  cross-attention, mamba or xLSTM cache
  decode        : S = 1 against the cache
Caches are updated in place (``models/attention.py``, ``ssm.py``,
``xlstm.py``) and ``forward`` returns the same cache object.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.sharding import dtensor
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import (DTYPES, dense_init, embed_init,
                                       init_mlp, init_rms_norm, mlp_fwd,
                                       rms_norm, rope_table)
# leaves the forward reads in fp32 (never cast to the compute dtype)
FP32_LEAVES = frozenset({"scale", "A_log", "dt_bias", "D", "conv_w",
                         "conv_b", "dt_proj", "bi", "bf", "gn", "r", "b",
                         "gate"})
ATTENTION_KINDS = ("attn", "moe", "hybrid")


def layer_cycle(cfg):
    """The repeating unit of cfg.layers; (cycle, n_units)."""
    pattern = cfg.layers
    n = len(pattern)
    for c in range(1, n + 1):
        if n % c == 0 and pattern == pattern[:c] * (n // c):
            return pattern[:c], n // c
    return pattern, 1


def _init_block(generator, kind, cfg, lead):
    d, dev = cfg.d_model, generator.device
    norm = lambda: init_rms_norm(d, dev, lead)
    if kind == "attn":
        return {"ln1": norm(),
                "attn": attn_lib.init_attention(generator, cfg, lead),
                "ln2": norm(),
                "mlp": init_mlp(generator, d, cfg.d_ff, lead)}
    if kind == "moe":
        return {"ln1": norm(),
                "attn": attn_lib.init_attention(generator, cfg, lead),
                "ln2": norm(),
                "moe": moe_lib.init_moe(generator, cfg, lead)}
    if kind == "hybrid":
        return {"ln1": norm(),
                "attn": attn_lib.init_attention(generator, cfg, lead),
                "mamba": ssm_lib.init_mamba(generator, cfg, lead=lead),
                "lna": norm(), "lnm": norm(), "ln2": norm(),
                "mlp": init_mlp(generator, d, cfg.d_ff, lead)}
    if kind == "xattn":
        return {"ln1": norm(),
                "xattn": attn_lib.init_attention(generator, cfg, lead,
                                                 cross=True),
                "gate": torch.zeros(lead, device=dev),  # zero-init gate
                "ln2": norm(),
                "mlp": init_mlp(generator, d, cfg.d_ff, lead)}
    if kind == "mlstm":
        return {"ln1": norm(),
                "mlstm": xlstm_lib.init_mlstm(generator, cfg, lead)}
    if kind == "slstm":
        return {"ln1": norm(),
                "slstm": xlstm_lib.init_slstm(generator, cfg, lead)}
    raise ValueError(kind)


def init_transformer(generator, cfg):
    """Random init on the generator's device, every unit's leaves drawn
    stacked (n_units, ...)."""
    cycle, n_units = layer_cycle(cfg)
    d, lead = cfg.d_model, (n_units,)
    layers = {f"b{i}": _init_block(generator, kind, cfg, lead)
              for i, kind in enumerate(cycle)}
    params = {"layers": layers,
              "ln_f": init_rms_norm(d, generator.device)}
    if cfg.embed_inputs:
        params["embed"] = embed_init(generator, (cfg.padded_vocab, d))
    if not cfg.tie_embeddings or not cfg.embed_inputs:
        params["lm_head"] = dense_init(generator, (d, cfg.padded_vocab))
    return params


def cast_params(params, cfg):
    """Every leaf the forward casts to the compute dtype (matmul weights,
    biases, the embedding), cast once; the leaves it reads in fp32
    (``FP32_LEAVES``: norm scales, the SSM's decay, step and conv, the
    xLSTM gates' biases, the cross-attention gate) stay.  The forward's
    ``.to(dtype)`` of a cast leaf is then the leaf itself, so the result is
    the per-call cast's, bit for bit.  At fp32 nothing is copied."""
    dtype = DTYPES[cfg.dtype]

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        return t if key in FP32_LEAVES else t.to(dtype)

    return walk(params)


def _block_fwd(bp, kind, x, cfg, positions, cache, image_embeds, window,
               rope):
    """One block -> (x, aux loss or None).  On DTensors the residual sum
    ahead of the second norm is brought to the stream's layout
    (``dtensor.residual``): the attention's output projection leaves a
    partial sum over "model", and a norm passes a partial sum on, so
    without it the FFN would run on every rank's partial sum with its
    weights gathered whole (GSPMD reduces it there too)."""
    eps = cfg.norm_eps
    if kind in ("attn", "moe"):
        h, _ = attn_lib.attention_fwd(
            bp["attn"], rms_norm(x, bp["ln1"]["scale"], eps), cfg,
            positions, window=window, cache=cache, rope=rope)
        x = dtensor.residual(x + h)
        y = rms_norm(x, bp["ln2"]["scale"], eps)
        if kind == "moe":
            m, aux = moe_lib.moe_fwd(bp["moe"], y, cfg)
            return x + m, aux
        return x + mlp_fwd(bp["mlp"], y, x.dtype), None
    if kind == "hybrid":
        y = rms_norm(x, bp["ln1"]["scale"], eps)
        ha, _ = attn_lib.attention_fwd(
            bp["attn"], y, cfg, positions, window=window,
            cache=None if cache is None else cache["attn"], rope=rope)
        hm, _ = ssm_lib.mamba_fwd(
            bp["mamba"], y, cfg,
            state=None if cache is None else cache["mamba"])
        h = 0.5 * (rms_norm(ha, bp["lna"]["scale"], eps)
                   + rms_norm(hm, bp["lnm"]["scale"], eps))
        x = dtensor.residual(x + h)
        y = rms_norm(x, bp["ln2"]["scale"], eps)
        return x + mlp_fwd(bp["mlp"], y, x.dtype), None
    if kind == "xattn":
        h, _ = attn_lib.attention_fwd(
            bp["xattn"], rms_norm(x, bp["ln1"]["scale"], eps), cfg,
            positions, cache=cache, kv_source=image_embeds)
        x = dtensor.residual(x + torch.tanh(bp["gate"]).to(x.dtype) * h)
        y = rms_norm(x, bp["ln2"]["scale"], eps)
        return x + mlp_fwd(bp["mlp"], y, x.dtype), None
    if kind in ("mlstm", "slstm"):
        fwd = xlstm_lib.mlstm_fwd if kind == "mlstm" else xlstm_lib.slstm_fwd
        h, _ = fwd(bp[kind], rms_norm(x, bp["ln1"]["scale"], eps), cfg,
                   state=cache)
        return x + h, None
    raise ValueError(kind)


def init_cache(cfg, batch, max_len, *, ring=False, dtype=torch.bfloat16,
               device=None):
    """Stacked (n_units-leading) cache of every block kind; a ring cache
    holds W = min(max_len, window) slots."""
    cycle, n_units = layer_cycle(cfg)
    W = min(max_len, cfg.sliding_window) if (ring and cfg.sliding_window) \
        else max_len

    def one(kind):
        kv = lambda: attn_lib.init_kv_cache(cfg, batch, W, ring=ring,
                                            dtype=dtype, device=device)
        if kind in ("attn", "moe"):
            return kv()
        if kind == "hybrid":
            return {"attn": kv(),
                    "mamba": ssm_lib.init_mamba_state(cfg, batch, dtype,
                                                      device)}
        if kind == "xattn":
            shape = (batch, cfg.n_image_tokens, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            return {"ck": torch.zeros(shape, dtype=dtype, device=device),
                    "cv": torch.zeros(shape, dtype=dtype, device=device)}
        if kind == "mlstm":
            return xlstm_lib.init_mlstm_state(cfg, batch, dtype, device)
        if kind == "slstm":
            return xlstm_lib.init_slstm_state(cfg, batch, device)
        raise ValueError(kind)

    return {f"b{i}": tree.map(lambda x: x.expand(n_units, *x.shape).clone(),
                              one(kind))
            for i, kind in enumerate(cycle)}


def forward(params, cfg, *, tokens=None, embeds=None, image_embeds=None,
            positions=None, cache=None, collect_logits=True):
    """Returns (logits or hidden, cache, aux_loss).

    tokens: (B, S) integers, or embeds: (B, S, d) when cfg.embed_inputs is
    False; image_embeds: (B, T, d) for the cross-attention layers (prefill
    and the full sequence; decode reads their cache).  The embedding rows
    are gathered, then cast (the same values as JAX's cast-then-gather)."""
    cycle, n_units = layer_cycle(cfg)
    dtype = DTYPES[cfg.dtype]
    # the embedding's gather (and its backward's index_put) on each rank's
    # rows, the table gathered, on DTensors (ROADMAP §3)
    x = (dtensor.local_op(lambda t, e: e[t], tokens, params["embed"], rows=1)
         if embeds is None else embeds).to(dtype)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    rope = (rope_table(positions, cfg.resolved_head_dim, cfg.rope_theta)
            if any(k in ATTENTION_KINDS for k in cycle) else None)
    aux = torch.zeros((), device=x.device)
    stacks = params["layers"]
    # each stacked leaf unbound once: its backward writes the stack once
    units = list(zip(*(l.unbind(0) for l in tree.leaves(stacks))))

    def unit_fwd(u, x, aux, *leaves):
        up = tree.unflatten(stacks, list(leaves))
        for i, kind in enumerate(cycle):
            c = (None if cache is None
                 else tree.map(lambda l: l[u], cache[f"b{i}"]))
            x, a = _block_fwd(up[f"b{i}"], kind, dtensor.residual(x), cfg,
                              positions, c, image_embeds, cfg.sliding_window,
                              rope)
            if a is not None:
                aux = aux + a
        return x, aux

    # per-unit rematerialisation (``jax.checkpoint(unit_fwd)``): a unit's
    # activations are recomputed in the backward, its FSDP weights gathered
    # again; no RNG state is saved (nothing draws in the forward, and
    # reading the CUDA RNG state cannot be captured in a CUDA graph)
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    for u in range(n_units):
        if remat:
            x, aux = checkpoint(unit_fwd, u, x, aux, *units[u],
                                use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = unit_fwd(u, x, aux, *units[u])
    x = rms_norm(dtensor.residual(x), params["ln_f"]["scale"], cfg.norm_eps)
    if not collect_logits:
        return x, cache, aux
    return lm_head(params, cfg, x), cache, aux


def lm_head(params, cfg, x):
    dtype = x.dtype
    if "lm_head" in params:
        logits = x @ params["lm_head"].to(dtype)
    else:
        logits = x @ params["embed"].to(dtype).T
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(pad, logits, -1e30)     # in the logits' dtype
    return logits


def token_ce(logits, targets):
    """Per-token (logz - gold, correct) in fp32.  On DTensors the vocab
    dim is gathered around the gather and the argmax (no sharding
    strategy over a vocab-sharded dim); the batch rows keep their split."""
    def ce(lg, tg):
        lg = lg.float()
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, tg[..., None].long())[..., 0]
        return logz - gold, (lg.argmax(-1) == tg).float()

    return dtensor.local_op(ce, logits, targets, rows=2)


def cross_entropy(logits, targets, mask=None):
    """Mean CE over valid tokens and the accuracy, in fp32."""
    ll, correct = token_ce(logits, targets)
    if mask is None:
        mask = torch.ones_like(ll)
    denom = mask.sum().clamp_min(1.0)
    return (ll * mask).sum() / denom, (correct * mask).sum() / denom


def loss_fn(params, cfg, batch):
    """batch: {tokens | embeds, targets, [image_embeds], [mask]} -> (loss,
    metrics), the loss with the MoE layers' aux loss added.
    cfg.loss_chunk > 0 runs the LM head and the CE a sequence chunk
    at a time, never holding (B, S, vocab) logits."""
    hidden, _, aux = forward(params, cfg, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"),
                             image_embeds=batch.get("image_embeds"),
                             collect_logits=False)
    targets = batch["targets"]
    mask = batch.get("mask")
    S = hidden.shape[1]
    chunk = cfg.loss_chunk
    if chunk and S > chunk and S % chunk == 0:
        zero = torch.zeros((), device=hidden.device)
        ls, accs, ms = zero, zero, zero
        for c0 in range(0, S, chunk):
            tc = targets[:, c0:c0 + chunk]
            mc = (mask[:, c0:c0 + chunk] if mask is not None
                  else torch.ones_like(tc, dtype=torch.float32))
            ll, correct = token_ce(
                lm_head(params, cfg, hidden[:, c0:c0 + chunk]), tc)
            ls = ls + (ll * mc).sum()
            accs = accs + (correct * mc).sum()
            ms = ms + mc.sum()
        loss = ls / ms.clamp_min(1.0)
        acc = accs / ms.clamp_min(1.0)
    else:
        loss, acc = cross_entropy(lm_head(params, cfg, hidden), targets,
                                  mask)
    return loss + aux, {"loss": loss, "acc": acc, "aux": aux}
