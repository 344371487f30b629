"""The audited entry points (port of ``repro/analysis/entrypoints.py``).

Each :class:`EntryPoint` lazily builds a :class:`Target` on a device: a
callable + its arguments at the reference entries' linter scale (tiny
models, small cohorts, the same C, k, m, B, S and tree shapes: the
invariants under audit are structural, not scale-dependent) plus the
entry's declared expectations: copy-lint mode and threshold, collective
byte allowlist, the carried buffers that must be written in place, the
rng-advance check, and the kernel launches one call makes.

A round entry runs its body as ``ScanDriver``'s replayed step runs it:
the new state copied into the carried one (``core/driver.copy_into``), the
port's counterpart of a donated carry.  Registering a new entry point (see the
package docstring for the full guide)::

    @register_entry("my_entry", min_devices=1)
    def _build(device):
        fn, args = ...
        return Target(fn, args, copy_mode="engine",
                      copy_threshold=max_param_leaf, ...)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree


@dataclasses.dataclass
class Target:
    """One audited call: the fn, its example args, and expectations."""
    fn: Callable
    args: Tuple
    carry: Dict[int, int] = dataclasses.field(default_factory=dict)
                                        # arg position -> output position
                                        # of each carried state
    copy_mode: str = "off"              # "strict" | "engine" | "off"
    copy_threshold: int = 0
    collective_allowlist: Optional[Dict[str, int]] = None
    donate_must_alias: Tuple = ()       # ((arg position, path), ...)
    check_rng_advance: bool = False
    rules_off: Tuple[str, ...] = ()
    expected_launches: Optional[Dict[str, int]] = None   # fusion_count:
                                        # {launch counter: launches a call}
    hbm_payload_bytes: int = 0          # one pass worth of bytes


@dataclasses.dataclass
class EntryPoint:
    name: str
    build: Callable[[torch.device], Target]
    min_devices: int = 1
    doc: str = ""


ENTRYPOINTS: Dict[str, EntryPoint] = {}


def register_entry(name: str, *, min_devices: int = 1, doc: str = ""):
    def deco(build_fn):
        ENTRYPOINTS[name] = EntryPoint(name, build_fn, min_devices, doc)
        return build_fn
    return deco


def paths(obj, prefix=""):
    """(path, leaf) of every leaf of a tree of NamedTuples, dicts, lists
    and tuples, in the reference's key-path notation (``.params['w1']``)."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for f in obj._fields:
            yield from paths(getattr(obj, f), f"{prefix}.{f}")
    elif isinstance(obj, dict):
        for k in obj:
            yield from paths(obj[k], f"{prefix}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, obj


def _leaf_sizes(t):
    return [x.numel() for x in tree.leaves(t) if isinstance(x, torch.Tensor)]


def _leaf_bytes(t):
    return sum(x.numel() * x.element_size() for x in tree.leaves(t)
               if isinstance(x, torch.Tensor))


def _must_alias(arg, state, prefixes):
    """((arg position, path), ...) of the heavy carried tensors, named by
    path prefix: bookkeeping scalars the round rebuilds are not the
    contract."""
    return tuple((arg, p) for p, leaf in paths(state)
                 if isinstance(leaf, torch.Tensor)
                 and any(p.startswith(q) for q in prefixes))


def _committed(body):
    """``body(state, *rest) -> (state, metrics)`` as ``ScanDriver``'s
    replayed step runs it: the new state copied into the carried one."""
    from repro_torch.core.driver import copy_into

    def fn(state, *rest):
        new, metrics = body(state, *rest)
        copy_into(state, new)
        return state, metrics

    return fn


def _gen(device, seed):
    return torch.Generator(device).manual_seed(seed)


def _normal(rng, shape, dtype, device):
    return torch.as_tensor(rng.standard_normal(shape),
                           dtype=torch.float32).to(dtype).to(device)


# --------------------------------------------------------------------- #
# aggregation kernels (strict copy lint: the no-flatten contract)        #
# --------------------------------------------------------------------- #

def _mixed_tree(c, device, seed=0):
    """The reference guard's multi-leaf mixed-dtype odd-size tree."""
    rng = np.random.default_rng(seed)
    return {"a": _normal(rng, (c, 13, 7), torch.float32, device),
            "b": _normal(rng, (c, 301), torch.bfloat16, device),
            "c": _normal(rng, (c, 5), torch.float32, device),
            "d": _normal(rng, (c, 192), torch.float16, device)}


@register_entry("aggregate", doc="fused Eq.-11 tree aggregation")
def _build_aggregate(device):
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import aggregation

    c = 8
    t = _mixed_tree(c, device)
    cfg = FedConfig(n_clients=c, aggregator="trimmed_mean")
    w = torch.ones(c, device=device)
    mask = torch.ones(c, device=device)
    mask[2] = 0.0

    def fn(u, ww, m):
        return aggregation.aggregate(u, ww, m, cfg)

    # the leaves stream in place through the segment table: one pass 1
    # and one trimmed pass 2 for the whole tree
    return Target(fn, (t, w, mask), copy_mode="strict",
                  copy_threshold=min(_leaf_sizes(t)),
                  collective_allowlist={},
                  expected_launches={"cosine_gate_partials": 1,
                                     "gated_combine[trimmed]": 1},
                  hbm_payload_bytes=_leaf_bytes(t))


@register_entry("two_stage", doc="cohort-batched two-stage aggregation")
def _build_two_stage(device):
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import aggregation

    g, k = 3, 8
    rng = np.random.default_rng(0)
    upd = {"w": _normal(rng, (g, k, 57), torch.float32, device),
           "b": _normal(rng, (g, k, 5, 3), torch.float32, device)}
    sw = torch.ones(g, k, device=device)
    sm = torch.ones(g, k, device=device)
    sm[0, 3] = 0.0
    cfg = FedConfig(aggregator="trimmed_mean")

    def fn(u, w, m):
        return aggregation.two_stage(u, w, m, cfg)

    # the G cohorts and the leaves ride one pass 1 and one pass 2
    return Target(fn, (upd, sw, sm), copy_mode="strict",
                  copy_threshold=min(_leaf_sizes(upd)),
                  collective_allowlist={},
                  expected_launches={"cosine_gate_partials": 1,
                                     "gated_combine[trimmed]": 1},
                  hbm_payload_bytes=_leaf_bytes(upd))


@register_entry("aggregate_sharded", min_devices=2,
                doc="mesh-sharded Eq.-11 aggregation")
def _build_aggregate_sharded(device):
    """Rank 0 of a 2-rank fake process group (``launch/mesh.fake_group``,
    started by the linter), on real tensors: collectives move nothing, and
    their bytes are what this rank would send.

    The audited call is ``aggregate_sharded``'s body,
    ``aggregation.aggregate_columns`` (the counterpart of the reference's
    ``shard_map``), on the reference's tree in the layout it takes: every
    client's rows of this rank's column block of each split leaf, and the
    leaves that stay whole.  The reference's entry hands every device all
    the rows, so its ``with_sharding_constraint`` ahead of the body is a
    local slice.  The port's program hands each rank its own clients' rows,
    and its reshard (``ColumnShards.to_columns``, one all_to_all at W > 1)
    runs ahead of the body; that all_to_all is an open fault (ROADMAP §3),
    which the twin in ``tests/test_torch_analysis.py`` shows this rule
    finds."""
    import torch.distributed as dist

    from repro_torch.configs.base import FedConfig
    from repro_torch.core import aggregation
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import collectives, specs

    c = 8
    rng = np.random.default_rng(0)
    t = {"w": _normal(rng, (c, 64, 8), torch.float32, device),
         "r": _normal(rng, (c, 301), torch.float32, device),
         "b": _normal(rng, (c, 5), torch.float32, device),
         "h": _normal(rng, (c, 256), torch.bfloat16, device)}
    cfg = FedConfig(n_clients=c, aggregator="trimmed_mean")
    w = torch.ones(c, device=device)
    mask = torch.ones(c, device=device)
    mesh = Mesh(("data",), (dist.get_world_size(),), None, dist.get_rank())
    sub = mesh.over(("data",))
    like = tree.map(lambda l: l[0], t)
    sizes = _leaf_sizes(like)
    _, flags = specs.client_flat_specs(sizes, sub, sub.axis_names)
    cols = collectives.ColumnShards(sizes, flags, sub)
    rows = [l.reshape(c, -1).float() for l in tree.leaves(t)]
    sh = torch.cat([x.chunk(sub.size, 1)[sub.rank]
                    for x, f in zip(rows, flags) if f], 1)
    rep = torch.cat([x for x, f in zip(rows, flags) if not f], 1)

    def fn(s, r, ww, m):
        return aggregation.aggregate_columns(s, r, cols, ww, m, cfg, like)

    # only the (C,) cosine partials (and Krum's (C, C) Gram) may be summed
    # across ranks, and each split leaf's aggregated block gathered back;
    # an all-to-all would mean the body resharded the rows: forbidden
    payload = sum(_leaf_sizes(t)) * 4
    return Target(fn, (sh, rep, w, mask), copy_mode="strict",
                  copy_threshold=min(_leaf_sizes(t)),
                  collective_allowlist={"all-reduce": 16 * 1024,
                                        "all-gather": payload,
                                        "reduce-scatter": payload,
                                        "collective-permute": payload},
                  expected_launches={"cosine_gate_partials": 2,
                                     "gated_combine[trimmed]": 2},
                  hbm_payload_bytes=_leaf_bytes(t))


# --------------------------------------------------------------------- #
# round engines (engine copy lint, rng discipline, donation)            #
# --------------------------------------------------------------------- #

_ONE_TRIMMED = {"cosine_gate_partials": 1, "gated_combine[trimmed]": 1}


@register_entry("fedfits.make_round",
                doc="synchronous FedFiTS round body (Algorithm 1+2)")
def _build_sync_round(device):
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core import fedfits
    from repro_torch.data.pipeline import build_federation
    from repro_torch.models.model import build

    k = 6
    model = build(ARCHS["paper-mlp"])
    fed, _ = build_federation(0, kind="tabular", n=240, n_clients=k,
                              batch_size=8, n_classes=10, device=device)
    cfg = FedConfig(n_clients=k, algorithm="fedfits", local_epochs=1,
                    local_lr=0.05, avail_prob=0.7,
                    aggregator="trimmed_mean")
    state = fedfits.init_state(model.init(_gen(device, 0)), k, cfg,
                               _gen(device, 1))
    batch = dict(fed.data_fn(1, _gen(device, 2)))
    batch["avail"] = torch.ones(k, device=device)
    return Target(_committed(fedfits.make_round(model, cfg)),
                  (state, batch), carry={0: 0}, copy_mode="engine",
                  copy_threshold=max(_leaf_sizes(state.params)),
                  collective_allowlist={}, check_rng_advance=True,
                  donate_must_alias=_must_alias(
                      0, state, (".params", ".clients.ef")),
                  expected_launches=_ONE_TRIMMED)


def _async_target(model, cfg, fed, state, batch_size):
    from repro_torch.core import async_engine

    draw, round_fn = async_engine.make_async_round(
        model, cfg, fed.data, batch_size=batch_size)
    return Target(_committed(lambda st, batch: round_fn(st, draw(st))),
                  (state, {}), carry={0: 0}, copy_mode="engine",
                  copy_threshold=max(_leaf_sizes(state.params)),
                  collective_allowlist={}, check_rng_advance=True,
                  donate_must_alias=_must_alias(
                      0, state, (".params", ".buf.rows")),
                  expected_launches=_ONE_TRIMMED)


@register_entry("async_engine.make_async_round",
                doc="buffered-async round body")
def _build_async_round(device):
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core import async_engine
    from repro_torch.data.pipeline import build_federation
    from repro_torch.models.model import build

    m, c = 12, 4
    model = build(ARCHS["paper-mlp"])
    fed, _ = build_federation(0, kind="tabular", n=360, n_clients=m,
                              batch_size=8, n_classes=10, device=device)
    cfg = FedConfig(n_clients=c, population=m, algorithm="fedavg",
                    aggregator="trimmed_mean", async_max_retries=2,
                    staleness_decay=0.5)
    state = async_engine.init_async_state(model.init(_gen(device, 0)), cfg,
                                          _gen(device, 1))
    return _async_target(model, cfg, fed, state, 8)


@register_entry("pod.make_train_step",
                doc="pod SPMD train step (robust per-client aggregation)")
def _build_pod_step(device):
    from repro_torch.configs.base import FedConfig, TrainConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core import pod
    from repro_torch.data import synthetic
    from repro_torch.models import transformer
    from repro_torch.optim import optimizers

    cfg = ARCHS["tiny-lm"].replace(n_layers=2, d_model=64, n_heads=4,
                                   n_kv_heads=2, d_ff=128, vocab_size=128,
                                   head_dim=16)
    C, B, S = 4, 8, 32
    fed = FedConfig(n_clients=C, aggregator="trimmed_mean")
    tc = TrainConfig(global_batch=B, seq_len=S, total_steps=4,
                     warmup_steps=1)
    params = transformer.init_transformer(_gen(device, 0), cfg)
    opt_init, _ = optimizers.make_optimizer(tc)
    state = pod.init_pod_state(params, opt_init, C, fed, _gen(device, 1))
    toks = synthetic.make_lm_tokens(_gen(device, 2), B, S + 1,
                                    cfg.vocab_size, n_latent=2)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    step = pod.make_train_step(cfg, fed, tc, robust="per_client")
    # the transformer legitimately concatenates at single-activation size
    # (rotate-half, head merges), so the threshold is whole-tree scale:
    # only a flatten of the full parameter tree can trip it
    return Target(_committed(step), (state, batch), carry={0: 0},
                  copy_mode="engine",
                  copy_threshold=sum(_leaf_sizes(params)),
                  collective_allowlist={}, check_rng_advance=True,
                  donate_must_alias=_must_alias(
                      0, state, (".params", ".opt_state")),
                  expected_launches=_ONE_TRIMMED)


@register_entry("examples.async_healthcare.round",
                doc="walkthrough async round with the telemetry column "
                    "riding the carry")
def _build_example_round(device):
    """The round of ``examples/async_healthcare.py:make_telemetry_round``
    (m = 12 clinics, c = 4, n = 360, batch 8, the walkthrough's config,
    the ``obs/`` counter column on the carry), built from the port's own
    modules: that example is the JAX package's, and its port is the
    benchmark's work.  The counter column must not break the in-place
    carry."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core import async_engine
    from repro_torch.data.pipeline import build_federation
    from repro_torch.models.model import build
    from repro_torch.obs import counters as obs_counters

    m, c, n, bsz = 12, 4, 360, 8
    model = build(ARCHS["paper-mlp"])
    fed, _ = build_federation(0, kind="tabular", n=n, n_clients=m,
                              batch_size=bsz, n_classes=10, sep=1.0,
                              dirichlet_alpha=1.0, device=device)
    cfg = FedConfig(n_clients=c, population=m, algorithm="fedavg",
                    aggregator="trimmed_mean", local_epochs=2,
                    local_lr=0.2, async_deadline=1.0, async_max_retries=2,
                    async_backoff=1.5, staleness_decay=0.5)
    state = async_engine.init_async_state(model.init(_gen(device, 0)), cfg,
                                          _gen(device, 1))
    state = state._replace(tele=obs_counters.init_column("async", cfg,
                                                         device))
    return _async_target(model, cfg, fed, state, bsz)


# --------------------------------------------------------------------- #
# comm codec round-trips (rng + dtype discipline on the wire boundary)  #
# --------------------------------------------------------------------- #

def _codec_entry(name, device):
    """The tree goes into the round's (K, N) fp32 update buffer, then one
    crossing of the wire through error feedback, whose residual is the
    round's (K, N) buffer (``comm/error_feedback.py``)."""
    from repro_torch.comm import codecs as comm_codecs, error_feedback
    from repro_torch.configs.base import FedConfig

    cfg = FedConfig(n_clients=4, compress=name)
    codec = comm_codecs.make_codec(cfg)
    t = _mixed_tree(4, device)
    layout = codec.layout(_leaf_sizes({k: v[0] for k, v in t.items()}))
    residual = error_feedback.init(tree.flatten_rows(t))

    def fn(u, r, gen):
        return error_feedback.compress(
            codec, tree.flatten_rows(u).float(), layout, r,
            gen if codec.stochastic else None)

    return Target(fn, (t, residual, _gen(device, 3)), copy_mode="off",
                  collective_allowlist={},
                  copy_threshold=max(_leaf_sizes(t)),
                  expected_launches={})


for _name in ("int8", "int4", "signsgd", "topk", "randk"):
    register_entry(f"comm.codec.{_name}",
                   doc=f"{_name} wire round-trip through EF")(
        lambda device, _n=_name: _codec_entry(_n, device))


# --------------------------------------------------------------------- #
# serving                                                               #
# --------------------------------------------------------------------- #

@register_entry("serve.decode_step",
                doc="autoregressive decode+sample step (launch/serve.py)")
def _build_decode_step(device):
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import make_decode_step
    from repro_torch.models.model import build

    cfg = get_config("tiny-lm").reduced()
    model = build(cfg)
    params = model.init(_gen(device, 0))
    B, P = 2, 16
    cache = model.init_cache(B, P + 8, dtype=torch.float32, device=device)
    # prefill positions [0, P) so the decode step sees a warm cache
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=_gen(device, 1), device=device)
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": prompts}, cache)
    tok = torch.zeros((B, 1), dtype=torch.int64, device=device)
    step = make_decode_step(model, temperature=1.0)
    pos = torch.tensor(P, dtype=torch.int32, device=device)
    return Target(step, (params, tok, cache, pos, _gen(device, 7)),
                  copy_mode="engine",
                  copy_threshold=max(_leaf_sizes(params)),
                  collective_allowlist={}, check_rng_advance=True,
                  expected_launches={})


@register_entry("serve.paged_decode_step",
                doc="continuous-batching paged decode step "
                    "(serve/engine.py: the paged decode kernel, the pools "
                    "and the slot carry written in place)")
def _build_paged_decode_step(device):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.driver import copy_into
    from repro_torch.models.model import build
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_config("tiny-lm").reduced()
    model = build(cfg)
    params = model.init(_gen(device, 0))
    scfg = ServeConfig(max_slots=4, page_size=8, max_len=32,
                       prompt_pad=8, temperature=1.0, attn="pallas")
    engine = ServeEngine(cfg, scfg, params, seed=1, device=device)
    # warm two slots through the real admit path so the audited step
    # sees live page tables
    cache, st = engine.fresh_state()
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for rid in range(2):
            prompt = torch.zeros(scfg.prompt_pad, dtype=torch.int64,
                                 device=device)
            prompt[:4] = torch.as_tensor(rng.randint(0, cfg.vocab_size, 4))
            cache, st, _ = engine._admit(params, cache, st, prompt, 4, 8,
                                         rid)

    def fn(p, pools, slots):
        pools, new, out = engine._decode(p, pools, slots)
        copy_into(slots, new)
        return pools, slots, out

    pool_alias = tuple((1, p) for p, leaf in paths(cache)
                       if isinstance(leaf, torch.Tensor)
                       and any(f"'{k}'" in p for k in ("kp", "vp")))
    return Target(fn, (params, cache, st), carry={1: 0, 2: 1},
                  copy_mode="engine",
                  copy_threshold=max(_leaf_sizes(params)),
                  collective_allowlist={}, check_rng_advance=True,
                  donate_must_alias=pool_alias,
                  expected_launches={"paged_flash_decode": cfg.n_layers})


def get_entry(name: str) -> EntryPoint:
    return ENTRYPOINTS[name]
