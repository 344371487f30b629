"""Decoder-only transformer (port of ``repro/models/transformer.py``: the
dense ``attn`` block; moe, hybrid, xattn and the xLSTM blocks come with
ROADMAP queue 1 item 13).

Parameters keep the JAX layout: each leaf of ``params["layers"]`` is
stacked over the layer *units* (a unit is one repetition of
``layer_cycle``), (n_units, ...).  ``forward`` is JAX's ``scan_unroll``
branch, the same function as its ``lax.scan``: a Python loop over the
units, each unit's leaves indexed out of the stack (views, no copy).

Modes:
  full sequence : ``forward(cache=None)`` (scoring, the loss)
  prefill       : ``forward(cache=...)`` fills a full or paged cache
  decode        : S = 1 against the cache
Caches are updated in place (``models/attention.py``) and ``forward``
returns the same cache object.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (dense_init, embed_init, init_mlp,
                                       init_rms_norm, mlp_fwd, rms_norm,
                                       rope_table)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def layer_cycle(cfg):
    """The repeating unit of cfg.layers; (cycle, n_units)."""
    pattern = cfg.layers
    n = len(pattern)
    for c in range(1, n + 1):
        if n % c == 0 and pattern == pattern[:c] * (n // c):
            return pattern[:c], n // c
    return pattern, 1


def _check_kinds(cycle):
    for kind in cycle:
        if kind != "attn":
            raise NotImplementedError(
                f"block kind {kind!r} comes with ROADMAP queue 1 item 13")


def init_transformer(generator, cfg):
    """Random init on the generator's device, every unit's leaves drawn
    stacked (n_units, ...)."""
    cycle, n_units = layer_cycle(cfg)
    _check_kinds(cycle)
    d, dev, lead = cfg.d_model, generator.device, (n_units,)
    layers = {f"b{i}": {"ln1": init_rms_norm(d, dev, lead),
                        "attn": attn_lib.init_attention(generator, cfg, lead),
                        "ln2": init_rms_norm(d, dev, lead),
                        "mlp": init_mlp(generator, d, cfg.d_ff, lead)}
              for i in range(len(cycle))}
    params = {"layers": layers, "ln_f": init_rms_norm(d, dev)}
    if cfg.embed_inputs:
        params["embed"] = embed_init(generator, (cfg.padded_vocab, d))
    if not cfg.tie_embeddings or not cfg.embed_inputs:
        params["lm_head"] = dense_init(generator, (d, cfg.padded_vocab))
    return params


def cast_params(params, cfg):
    """Every leaf the forward casts to the compute dtype (matmul weights,
    biases, the embedding), cast once; the norm scales, read in fp32, stay.
    The forward's ``.to(dtype)`` of a cast leaf is then the leaf itself, so
    the result is the per-call cast's, bit for bit.  At fp32 nothing is
    copied."""
    dtype = DTYPES[cfg.dtype]

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        return t if key == "scale" else t.to(dtype)

    return walk(params)


def _block_fwd(bp, kind, x, cfg, positions, cache, window, rope):
    h, new_cache = attn_lib.attention_fwd(
        bp["attn"], rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps), cfg,
        positions, window=window, cache=cache, rope=rope)
    x = x + h
    y = rms_norm(x, bp["ln2"]["scale"], cfg.norm_eps)
    return x + mlp_fwd(bp["mlp"], y, x.dtype), new_cache


def init_cache(cfg, batch, max_len, *, ring=False, dtype=torch.bfloat16,
               device=None):
    """Stacked (n_units-leading) full KV cache."""
    cycle, n_units = layer_cycle(cfg)
    _check_kinds(cycle)
    one = attn_lib.init_kv_cache(cfg, batch, max_len, ring=ring, dtype=dtype,
                                 device=device)
    return {f"b{i}": tree.map(lambda x: x.expand(n_units, *x.shape).clone(),
                              one)
            for i in range(len(cycle))}


def forward(params, cfg, *, tokens=None, embeds=None, image_embeds=None,
            positions=None, cache=None, collect_logits=True):
    """Returns (logits or hidden, cache, aux_loss).

    tokens: (B, S) integers, or embeds: (B, S, d) when cfg.embed_inputs is
    False.  The embedding rows are gathered, then cast (the same values as
    JAX's cast-then-gather)."""
    if image_embeds is not None:
        raise NotImplementedError(
            "image embeddings (vlm) come with ROADMAP queue 1 item 13")
    cycle, n_units = layer_cycle(cfg)
    _check_kinds(cycle)
    dtype = DTYPES[cfg.dtype]
    x = (params["embed"][tokens] if embeds is None else embeds).to(dtype)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    rope = rope_table(positions, cfg.resolved_head_dim, cfg.rope_theta)
    for u in range(n_units):
        for i, kind in enumerate(cycle):
            bp = tree.map(lambda l: l[u], params["layers"][f"b{i}"])
            c = (None if cache is None
                 else tree.map(lambda l: l[u], cache[f"b{i}"]))
            x, _ = _block_fwd(bp, kind, x, cfg, positions, c,
                              cfg.sliding_window, rope)
    aux = torch.zeros((), device=x.device)
    x = rms_norm(x, params["ln_f"]["scale"], cfg.norm_eps)
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


def cross_entropy(logits, targets, mask=None):
    """Mean CE over valid tokens and the accuracy, in fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    ll = logz - gold
    correct = (logits.argmax(-1) == targets).float()
    if mask is None:
        mask = torch.ones_like(ll)
    denom = mask.sum().clamp_min(1.0)
    return (ll * mask).sum() / denom, (correct * mask).sum() / denom


def loss_fn(params, cfg, batch):
    """batch: {tokens | embeds, targets, [mask]} -> (loss, metrics); forward
    only.  cfg.loss_chunk > 0 runs the LM head and the CE a sequence chunk
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
            logits = lm_head(params, cfg, hidden[:, c0:c0 + chunk]).float()
            tc = targets[:, c0:c0 + chunk]
            mc = (mask[:, c0:c0 + chunk] if mask is not None
                  else torch.ones_like(tc, dtype=torch.float32))
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, tc[..., None].long())[..., 0]
            correct = (logits.argmax(-1) == tc).float()
            ls = ls + ((logz - gold) * mc).sum()
            accs = accs + (correct * mc).sum()
            ms = ms + mc.sum()
        loss = ls / ms.clamp_min(1.0)
        acc = accs / ms.clamp_min(1.0)
    else:
        loss, acc = cross_entropy(lm_head(params, cfg, hidden), targets,
                                  mask)
    return loss + aux, {"loss": loss, "acc": acc, "aux": aux}
