"""Registry of the architectures the port runs (copy of the dense part of
``repro/configs/registry.py``).

``get_config`` covers the dense decoders and the paper's own models.  The
other assigned architectures (MoE, hybrid, SSM, VLM, audio) run no TPU
kernel and come with ROADMAP queue 1 item 13: their names raise
``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.internlm2_20b import CONFIG as _internlm2_20b
from repro_torch.configs.minitron_4b import CONFIG as _minitron_4b
from repro_torch.configs.paper_models import CNN_CONFIG, MLP_CONFIG, TINY_LM
from repro_torch.configs.qwen25_14b import CONFIG as _qwen25_14b
from repro_torch.configs.qwen2_72b import CONFIG as _qwen2_72b

ARCHS = {
    "qwen2.5-14b": _qwen25_14b,
    "qwen2-72b": _qwen2_72b,
    "minitron-4b": _minitron_4b,
    "internlm2-20b": _internlm2_20b,
    "paper-cnn": CNN_CONFIG,
    "paper-mlp": MLP_CONFIG,
    "tiny-lm": TINY_LM,
}

LATER = ("musicgen-large", "granite-moe-1b-a400m", "hymba-1.5b",
         "llama-3.2-vision-90b", "dbrx-132b", "xlstm-350m")


def get_config(name: str) -> ModelConfig:
    if name in LATER:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: moe, hybrid, ssm, vlm and "
            "audio come with ROADMAP queue 1 item 13")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
