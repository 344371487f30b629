"""Model and federated configuration — the port's copy of
``repro/configs/base.py``.

``ModelConfig`` keeps every field of the JAX one, with its defaults
(``remat``: each layer unit's activations recomputed in the backward,
``models/transformer.forward``).  ``FedConfig``
keeps every field of the JAX one, with the same defaults, so a config
written for one package reads the same in the other; the options this
slice does not run raise ``NotImplementedError`` in
``core.fedfits.make_round``.  ``TrainConfig``, ``MeshConfig`` and the
input shapes are the pod trainer's (``core/pod.py``, ``launch/train.py``);
the JAX file's TPU roofline constants have no place here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense|moe|ssm|hybrid|vlm|audio|cnn|mlp
    n_layers: int                     # blocks (dense) / conv blocks (cnn) /
                                      # dense layers (mlp)
    d_model: int                      # width / base channels / n_features
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int                   # vocabulary / n_classes
    head_dim: int = 0                 # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1.0e4
    norm_eps: float = 1.0e-5
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0              # 0 -> ceil(d_model/16)
    scan_chunk: int = 256             # chunked associative scan (memory cap)
    scan_unroll: bool = False         # accepted for parity with JAX's
                                      # configs and ignored: its two values
                                      # compute the same function, and the
                                      # port has one layer loop
    ssm_scan_dtype: str = "float32"   # mamba scan state/coeff dtype
    # --- block layout ---
    block_pattern: Tuple[str, ...] = ()   # empty -> derived from arch_type
    # --- VLM ---
    cross_attn_every: int = 0         # every Nth layer is 'xattn'
    n_image_tokens: int = 0           # frontend-stub token count
    # --- audio ---
    n_codebooks: int = 0              # frontend stub sums codebook embeddings
    embed_inputs: bool = True         # False: the caller passes embeddings
    sliding_window: int = 0           # 0 = full attention
    attn_impl: str = "xla"            # xla (plain) | pallas (K9 on the card)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True                # per-unit activation recomputation
    loss_chunk: int = 0               # chunk the LM loss over the sequence
    source: str = ""                  # citation of the public config

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 128 (padded logits masked to -1e30)."""
        return -(-self.vocab_size // 128) * 128

    @property
    def resolved_dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def layers(self) -> Tuple[str, ...]:
        """Per-layer block kinds (derives the default pattern)."""
        if self.block_pattern:
            if len(self.block_pattern) != self.n_layers:
                raise ValueError("block_pattern needs one kind a layer")
            return self.block_pattern
        if self.arch_type in ("dense", "audio"):
            return ("attn",) * self.n_layers
        if self.arch_type == "moe":
            return ("moe",) * self.n_layers
        if self.arch_type == "hybrid":
            return ("hybrid",) * self.n_layers
        if self.arch_type == "ssm":
            # xLSTM[7:1]: every 8th block sLSTM, rest mLSTM (arXiv:2405.04517)
            return tuple("slstm" if (i % 8) == 7 else "mlstm"
                         for i in range(self.n_layers))
        if self.arch_type == "vlm":
            every = self.cross_attn_every or 5
            return tuple("xattn" if (i % every) == (every - 1) else "attn"
                         for i in range(self.n_layers))
        raise ValueError(f"unknown arch_type {self.arch_type}")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model <= 256, <= 4 experts
        (JAX's)."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        kw = dict(
            n_layers=2, d_model=d_model, n_heads=n_heads,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=d_model // n_heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_image_tokens=min(self.n_image_tokens, 16),
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else 0),
            block_pattern=(), remat=False, dtype="float32")
        if self.n_experts:
            kw["n_experts"] = min(self.n_experts, 4)
            kw["top_k"] = min(self.top_k, 2)
            # no-drop capacity: keeps decode-vs-full comparisons exact
            kw["capacity_factor"] = float(kw["n_experts"])
        if self.arch_type == "ssm":
            kw["block_pattern"] = ("mlstm", "slstm")   # one of each kind
        return self.replace(**kw)


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


@dataclass(frozen=True)
class TrainConfig:
    """The pod trainer's optimisation settings (the JAX package's
    defaults)."""
    global_batch: int = 256
    seq_len: int = 4096
    lr: float = 3.0e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    optimizer: str = "adamw"          # sgd|adam|adamw
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1.0e-8
    seed: int = 0
    microbatch: int = 0               # 0 = no accumulation
    eval_batch: int = 0               # per-client fitness-eval examples (0 -> gb//C)


@dataclass(frozen=True)
class MeshConfig:
    data: int = 16
    model: int = 16
    pods: int = 1                     # >1 adds leading "pod" axis

    @property
    def axis_names(self):
        return ("pod", "data", "model") if self.pods > 1 else ("data", "model")

    @property
    def shape(self):
        return (
            (self.pods, self.data, self.model)
            if self.pods > 1
            else (self.data, self.model)
        )


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
