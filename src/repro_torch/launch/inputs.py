"""Shape and dtype stand-ins for the pod trainer's inputs (no allocation) —
the train-side part of ``repro/launch/inputs.py``.

``ShapeDtype`` is the counterpart of ``jax.ShapeDtypeStruct``: a shape
tuple and a torch dtype.  The [audio] and [vlm] frontends are stubs, as in
the JAX package: a batch carries frame embeddings (``embeds``, (B, S, d))
in place of tokens, or patch embeddings (``image_embeds``, (B, T, d))
beside them.  ``batch_shardings`` gives the ``NamedSharding``
of each batch leaf over a mesh, which the pod driver's staging cuts each
rank's rows with (``core/driver.py``).  The decode-side specs
(``infer_batch_specs``, ``cache_specs_struct``) come with the dry-run,
ROADMAP queue 1 item g'.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig


@dataclass(frozen=True)
class ShapeDtype:
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def ndim(self):
        return len(self.shape)


def shape_variant(cfg: ModelConfig, shape_name: str) -> ModelConfig:
    """Per-shape config adjustments: a training shape chunks the LM-head
    loss (full (B, S, V) logits at vocab 152k would dominate activation
    memory); long_500k switches a full-attention arch to its
    sliding-window variant (window 8192)."""
    shape = INPUT_SHAPES[shape_name]
    kw = {}
    if shape.kind == "train":
        kw["loss_chunk"] = 512
    if shape_name == "long_500k" and cfg.arch_type not in ("ssm",):
        if not cfg.sliding_window:
            kw["sliding_window"] = 8192
    return cfg.replace(**kw) if kw else cfg


def train_batch_specs(cfg: ModelConfig, shape_name: str):
    shape = INPUT_SHAPES[shape_name]
    gb, s = shape.global_batch, shape.seq_len
    batch = {"targets": ShapeDtype((gb, s), torch.int32)}
    if cfg.embed_inputs:
        batch["tokens"] = ShapeDtype((gb, s), torch.int32)
    else:
        batch["embeds"] = ShapeDtype((gb, s, cfg.d_model), torch.bfloat16)
    if cfg.arch_type == "vlm":
        batch["image_embeds"] = ShapeDtype((gb, cfg.n_image_tokens,
                                            cfg.d_model), torch.bfloat16)
    return batch


def batch_shardings(batch, mesh):
    """``NamedSharding`` tree for a train batch tree (tensors or
    ``ShapeDtype``s): the leading global-batch dim shards over the pod +
    data mesh axes, so each rank stages only its clients' rows."""
    from repro_torch.sharding import specs as sh

    return sh.named(mesh, sh.batch_specs(batch, mesh))
