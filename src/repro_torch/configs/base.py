"""Model and federated configuration — the port's copy of
``repro/configs/base.py``.

``ModelConfig`` keeps the fields the paper models read.  ``FedConfig``
keeps every field of the JAX one, with the same defaults, so a config
written for one package reads the same in the other; the options this
slice does not run raise ``NotImplementedError`` in
``core.fedfits.make_round``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # cnn | mlp in this slice
    n_layers: int                     # conv blocks (cnn) / dense layers (mlp)
    d_model: int                      # base channels (cnn) / n_features (mlp)
    n_heads: int
    n_kv_heads: int
    d_ff: int                         # dense width
    vocab_size: int                   # n_classes
    dtype: str = "float32"
    param_dtype: str = "float32"
    remat: bool = False
    source: str = ""                  # citation of the public config

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class FedConfig:
    n_clients: int = 16               # C: sim clients
    alpha: float = 0.5                # Eq.(2) data-quality vs performance
    dynamic_alpha: bool = True        # §V Eqs.(18-19)
    beta: float = 0.1                 # Eq.(3) threshold openness
    msl: int = 5                      # Maximum Slot Length
    pft: int = 2                      # Performance Fluctuation Threshold
    local_epochs: int = 1             # E
    local_lr: float = 0.1             # eta_l
    participation_floor: float = 0.0  # A4: Pr(i in S_t) >= p_min
    explore_eps: float = 0.0          # eps-greedy inclusion
    # trust & robustness
    trust_decay: float = 0.9          # EWMA decay of trust and gate_trust
    trust_in_fitness: bool = True     # gate_trust scales the fitness scores
    cosine_outlier_thresh: float = -0.5   # gradient-cosine outlier gate
    aggregator: str = "fedavg"        # fedavg|median|trimmed_mean|krum
    trim_frac: float = 0.2            # trimmed-mean fraction per side
    krum_f: int = 1                   # assumed byzantine count for Krum
    fused_agg: bool = True            # Eq.-11 through the CUDA kernels
                                      # (False -> plain reference)
    agg_blk: Optional[int] = None     # TPU VMEM block size; no CUDA meaning
    paper_exact_agg: bool = False     # Algorithm 1's n_k-weighted FedAvg
    # compressed client->server transport
    compress: str = "none"            # none|int8|int4|signsgd|topk|randk
    compress_qblk: int = 128
    compress_topk_frac: float = 0.05
    error_feedback: bool = True
    fused_dequant: bool = True
    # aggregation-boundary guard
    update_guard: bool = True
    guard_norm_mult: float = 1e4      # reject ||u|| > mult * median ||u||
    # population-scale / buffered-async engine
    population: int = 0
    async_deadline: float = 1.0
    async_max_retries: int = 2
    async_backoff: float = 1.5
    staleness_decay: float = 0.5
    select_method: str = "segmented"
    # selection algorithm: fedfits|fedavg|fedrand|fedpow
    algorithm: str = "fedfits"
    prox_mu: float = 0.0              # FedProx proximal term
    avail_prob: float = 1.0           # client availability
    stale_weight: float = 0.0         # stale catch-up weight
    fedrand_c: float = 0.5            # FedRand: m = cK
    fedpow_d: int = 0                 # FedPow candidates d (0 -> K)
    fedpow_m: int = 0                 # FedPow selected m (0 -> K/2)
    fitness_every: int = 1            # rounds between fitness evaluations

    def __post_init__(self):
        if self.population > 0 and self.compress != "none":
            raise ValueError(
                f"compress={self.compress!r} is not supported by the "
                f"buffered-async engine (population={self.population})")
