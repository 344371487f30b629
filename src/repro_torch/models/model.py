"""Model facade (port of ``repro/models/model.py``: the paper models and
the decoder transformer of every assigned architecture).

``build(cfg)`` returns a ``Model`` with
  init(generator)               -> params (on the generator's device)
  loss(params, batch)           -> (loss, metrics)
  forward(params, batch)        -> logits (full sequence)
and, for the transformer,
  init_cache(batch, max_len)    -> the cache of every block (``ring``:
                                   sliding-window rings)
  prefill(params, batch, cache) -> (last-position logits, cache)
  decode(params, batch, cache, pos) -> (logits, cache)
A batch holds ``tokens`` or ``embeds`` (musicgen's frontend stub), and
``image_embeds`` for the cross-attention layers (prefill and the full
sequence; decode reads their cache).  ``prefill`` and ``decode`` also run
on params placed by ``param_specs`` or ``param_specs_tp``, a cache placed
by ``cache_specs`` and a batch placed by ``batch_specs``: the serving
side of the sharded layouts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch import tree
from repro_torch.models import small, transformer
from repro_torch.sharding import dtensor


@dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable
    loss: Callable
    forward: Callable
    init_cache: Callable = None
    prefill: Callable = None
    decode: Callable = None


def build(cfg) -> Model:
    if cfg.arch_type == "cnn":
        init = lambda g: small.init_cnn(g, cfg)
        fwd = small.cnn_fwd
    elif cfg.arch_type == "mlp":
        init = lambda g: small.init_mlp_clf(g, cfg)
        fwd = small.mlp_clf_fwd
    else:
        return _transformer_model(cfg)

    def loss(params, batch):
        l, a = small.classifier_loss(fwd(params, batch["x"]), batch["y"])
        return l, {"loss": l, "acc": a}

    return Model(cfg, init, loss, forward=lambda p, b: fwd(p, b["x"]))


def _placed(params):
    """On params placed as DTensors (``sharding/specs.py`` layouts), plain
    tensors (positions, masks) enter their ops as replicated operands."""
    return dtensor.mixing(dtensor.is_dtensor(tree.leaves(params)[0]))


def _transformer_model(cfg) -> Model:
    def forward(params, batch):
        logits, _, _ = transformer.forward(
            params, cfg, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"),
            image_embeds=batch.get("image_embeds"))
        return logits

    def init_cache(batch_size, max_len, ring=False, dtype=torch.bfloat16,
                   device=None):
        return transformer.init_cache(cfg, batch_size, max_len, ring=ring,
                                      dtype=dtype, device=device)

    def prefill(params, batch, cache):
        # last-position logits only: nothing downstream reads the others
        with _placed(params):
            hidden, cache, _ = transformer.forward(
                params, cfg, tokens=batch.get("tokens"),
                embeds=batch.get("embeds"),
                image_embeds=batch.get("image_embeds"), cache=cache,
                collect_logits=False)
            return transformer.lm_head(params, cfg, hidden[:, -1:]), cache

    def decode(params, batch, cache, pos):
        """batch: {tokens: (B, 1)} or {embeds: (B, 1, d)}; pos: the
        position of the token (an int or a 0-d tensor)."""
        x = batch.get("tokens")
        x = x if x is not None else batch.get("embeds")
        positions = (torch.full((x.shape[0], 1), pos, device=x.device)
                     if isinstance(pos, int)
                     else pos.to(x.device).expand(x.shape[0], 1))
        with _placed(params):
            logits, cache, _ = transformer.forward(
                params, cfg, tokens=batch.get("tokens"),
                embeds=batch.get("embeds"), positions=positions, cache=cache)
        return logits, cache

    return Model(cfg, lambda g: transformer.init_transformer(g, cfg),
                 lambda p, b: transformer.loss_fn(p, cfg, b), forward,
                 init_cache, prefill, decode)
