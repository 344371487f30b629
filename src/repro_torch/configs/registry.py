"""Registry of the 10 assigned architectures + the paper's own models (copy
of ``repro/configs/registry.py``).

Each entry cites its public source config in ``source``.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx_132b
from repro_torch.configs.granite_moe_1b import CONFIG as _granite_moe_1b
from repro_torch.configs.hymba_15b import CONFIG as _hymba_15b
from repro_torch.configs.internlm2_20b import CONFIG as _internlm2_20b
from repro_torch.configs.llama32_vision_90b import \
    CONFIG as _llama32_vision_90b
from repro_torch.configs.minitron_4b import CONFIG as _minitron_4b
from repro_torch.configs.musicgen_large import CONFIG as _musicgen_large
from repro_torch.configs.paper_models import CNN_CONFIG, MLP_CONFIG, TINY_LM
from repro_torch.configs.qwen25_14b import CONFIG as _qwen25_14b
from repro_torch.configs.qwen2_72b import CONFIG as _qwen2_72b
from repro_torch.configs.xlstm_350m import CONFIG as _xlstm_350m

ARCHS = {
    "qwen2.5-14b": _qwen25_14b,
    "musicgen-large": _musicgen_large,
    "qwen2-72b": _qwen2_72b,
    "granite-moe-1b-a400m": _granite_moe_1b,
    "hymba-1.5b": _hymba_15b,
    "minitron-4b": _minitron_4b,
    "llama-3.2-vision-90b": _llama32_vision_90b,
    "internlm2-20b": _internlm2_20b,
    "dbrx-132b": _dbrx_132b,
    "xlstm-350m": _xlstm_350m,
    # the paper's own model scale (healthcare FL experiments)
    "paper-cnn": CNN_CONFIG,
    "paper-mlp": MLP_CONFIG,
    "tiny-lm": TINY_LM,
}

ASSIGNED = [k for k in ARCHS if not k.startswith(("paper-", "tiny-"))]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
