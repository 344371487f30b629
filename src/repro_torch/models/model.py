"""Model facade (port of ``repro/models/model.py`` for the paper models).

``build(cfg)`` returns a ``Model`` with
  init(generator)          -> params (on the generator's device)
  loss(params, batch)      -> (loss, {"loss", "acc"})
  forward(params, batch)   -> logits
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.models import small


@dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable
    loss: Callable
    forward: Callable


def build(cfg) -> Model:
    if cfg.arch_type == "cnn":
        init = lambda g: small.init_cnn(g, cfg)
        fwd = small.cnn_fwd
    elif cfg.arch_type == "mlp":
        init = lambda g: small.init_mlp_clf(g, cfg)
        fwd = small.mlp_clf_fwd
    else:
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r}: the transformer stack comes with "
            "ROADMAP queue 1 item 13")

    def loss(params, batch):
        l, a = small.classifier_loss(fwd(params, batch["x"]), batch["y"])
        return l, {"loss": l, "acc": a}

    return Model(cfg, init, loss, forward=lambda p, b: fwd(p, b["x"]))
