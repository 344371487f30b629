"""Shape and dtype stand-ins for the pod trainer's inputs (no allocation) —
the train-side part of ``repro/launch/inputs.py``.

``ShapeDtype`` is the counterpart of ``jax.ShapeDtypeStruct``: a shape
tuple and a torch dtype.  The [audio] and [vlm] frontends are stubs, as in
the JAX package: a batch carries frame embeddings (``embeds``, (B, S, d))
in place of tokens, or patch embeddings (``image_embeds``, (B, T, d))
beside them.  ``batch_shardings`` gives the ``NamedSharding``
of each batch leaf over a mesh (its data axes; a "model" axis holds the
rows whole), which the pod driver's staging cuts each rank's rows with
(``core/driver.py``).  ``infer_batch_specs`` and ``cache_specs_struct``
are the serving side's stand-ins: the prefill / decode batch and the
stacked cache as shapes (the cache built on the ``meta`` device, which
allocates nothing).
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


def _shape(shape_name):
    """An ``InputShape`` from its name, or the shape itself."""
    return (INPUT_SHAPES[shape_name] if isinstance(shape_name, str)
            else shape_name)


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


def train_batch_specs(cfg: ModelConfig, shape_name):
    """The train batch of an input shape (its name, or an ``InputShape``)
    as ``ShapeDtype`` leaves."""
    shape = _shape(shape_name)
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


def infer_batch_specs(cfg: ModelConfig, shape_name: str, *, decode=False):
    """The serving batch of an input shape: tokens (or frame embeddings)
    of the whole prompt, or of one step with ``decode``; a VLM's patch
    embeddings with the prompt."""
    shape = _shape(shape_name)
    gb = shape.global_batch
    s = 1 if decode else shape.seq_len
    batch = {}
    if cfg.embed_inputs:
        batch["tokens"] = ShapeDtype((gb, s), torch.int32)
    else:
        batch["embeds"] = ShapeDtype((gb, s, cfg.d_model), torch.bfloat16)
    if cfg.arch_type == "vlm" and not decode:
        batch["image_embeds"] = ShapeDtype((gb, cfg.n_image_tokens,
                                            cfg.d_model), torch.bfloat16)
    return batch


def cache_specs_struct(cfg: ModelConfig, shape_name: str):
    """The stacked cache of an input shape (``transformer.init_cache``, a
    ring cache for long_500k's sliding window) as ``ShapeDtype`` leaves."""
    from repro_torch import tree
    from repro_torch.models import transformer

    shape = _shape(shape_name)
    ring = bool(cfg.sliding_window) and shape.name == "long_500k"
    cache = transformer.init_cache(cfg, shape.global_batch, shape.seq_len,
                                   ring=ring, dtype=torch.bfloat16,
                                   device="meta")
    return tree.map(lambda x: ShapeDtype(tuple(x.shape), x.dtype), cache)


def batch_shardings(batch, mesh):
    """``NamedSharding`` tree for a train batch tree (tensors or
    ``ShapeDtype``s): the leading global-batch dim shards over the pod +
    data mesh axes, so each rank stages only its clients' rows."""
    from repro_torch.sharding import specs as sh

    return sh.named(mesh, sh.batch_specs(batch, mesh))
