"""On-device counter registry of the telemetry layer — the port of
``repro/obs/counters.py``.

Every telemetry signal is declared once as a :class:`CounterSpec` (name,
kind, engines, shape, unit), with the JAX package's names, so one JSONL
stream reads the same from either package.  The engines publish them
through two channels:

  * **the counter column**: cumulative counters ride the round state as
    one flat ``{name: tensor}`` dict (``FedState.tele``,
    ``AsyncState.tele``, ``SlotState.tele``), built by :func:`init_column`
    and updated by :func:`accumulate` each round.  Under the chunked
    driver it is part of the static state a captured round copies into,
    so its totals survive chunks and replays like every other leaf;
  * **per-round metrics**: the round's own values, under ``obs/<name>``
    keys (:func:`metric_keys`), ride the history row to the one host read
    a chunk.

Telemetry is a pure readout: every value is computed from tensors the
round already produces, and nothing downstream reads it back, so model
state, generators and billing are bit for bit the same with it on or
off.  Every function here is safe to capture as a CUDA graph: no host
read, no copy from host memory, only static indices.

Naming (``<subsystem>/<signal>``): ``gate/`` cosine-gate outcomes,
``guard/`` sanitize rejections by kind, ``buffer/`` the async delivery
buffer, ``delivery/`` on-time vs late, ``agg/`` aggregation-weight mass,
``cohort/`` [p10, p50, p90] gauges, ``select/`` team and availability,
``wire/`` measured bytes, ``fault/`` injected losses, ``serve/`` the
serving engine, a row a decode step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

METRIC_PREFIX = "obs/"

KIND_COUNTER = "counter"      # monotonic; the column accumulates
KIND_GAUGE = "gauge"          # instantaneous; the column holds the last


@dataclasses.dataclass(frozen=True)
class CounterSpec:
    """One registered telemetry signal."""
    name: str                           # "<subsystem>/<signal>"
    kind: str                           # counter | gauge
    doc: str
    engines: Tuple[str, ...] = ("sync", "async")
    shape: Tuple[int, ...] = ()         # () scalar; config-dependent
                                        # lengths come from shape_for
    unit: str = "count"


REGISTRY: Dict[str, CounterSpec] = {}


def register(spec: CounterSpec) -> CounterSpec:
    if spec.name in REGISTRY:
        raise ValueError(f"duplicate counter {spec.name!r}")
    REGISTRY[spec.name] = spec
    return spec


def _r(name, kind, doc, engines=("sync", "async"), unit="count"):
    return register(CounterSpec(name, kind, doc, tuple(engines), (), unit))


# quantile gauges are fixed [p10, p50, p90] vectors
QUANTILE_PROBS = (0.1, 0.5, 0.9)

# ---- gate / guard ----------------------------------------------------
_r("gate/cosine_rejected", KIND_COUNTER,
   "participants whose update fell under the cosine-gate threshold")
_r("guard/nonfinite", KIND_COUNTER,
   "deliveries rejected by the sanitize boundary for NaN/Inf")
_r("guard/norm", KIND_COUNTER,
   "deliveries rejected for an absurd norm (> mult x masked median)")
# ---- selection / delivery -------------------------------------------
_r("select/team_size", KIND_GAUGE, "cohort/team rows this round")
_r("select/available", KIND_GAUGE, "available clients this round",
   engines=("sync",))
_r("delivery/on_time", KIND_COUNTER,
   "cohort deliveries that beat the round deadline", engines=("async",))
_r("delivery/late", KIND_COUNTER,
   "cohort deliveries that missed the deadline", engines=("async",))
# ---- async buffer ----------------------------------------------------
_r("buffer/occupancy", KIND_GAUGE,
   "DeliveryBuffer rows active after this round's update",
   engines=("async",), unit="rows")
_r("buffer/parked", KIND_COUNTER,
   "late deliveries parked into the buffer this round",
   engines=("async",))
_r("buffer/overflow", KIND_COUNTER,
   "late deliveries dropped because the buffer was full",
   engines=("async",))
_r("buffer/exhausted", KIND_COUNTER,
   "buffered rows abandoned after their retry budget ran out",
   engines=("async",))
register(CounterSpec(
    "buffer/age_hist", KIND_GAUGE,
    "active buffered rows by retry age (bucket i = age i+1)",
    ("async",), (), "rows"))
# ---- aggregation mass ------------------------------------------------
_r("agg/fresh_mass", KIND_GAUGE,
   "aggregation-weight mass of on-time deliveries", unit="mass")
_r("agg/stale_mass", KIND_GAUGE,
   "aggregation-weight mass of stale/buffered catch-up deliveries",
   unit="mass")
# ---- cohort state quantiles -----------------------------------------
register(CounterSpec("cohort/trust_q", KIND_GAUGE,
                     "cohort trust [p10, p50, p90]",
                     ("sync", "async"), (3,), "trust"))
register(CounterSpec("cohort/gate_trust_q", KIND_GAUGE,
                     "cohort gate-trust EWMA [p10, p50, p90]",
                     ("sync", "async"), (3,), "trust"))
register(CounterSpec("cohort/fitness_q", KIND_GAUGE,
                     "cohort fitness score [p10, p50, p90]",
                     ("sync", "async"), (3,), "score"))
# ---- measured wire bytes --------------------------------------------
_r("wire/bytes_up", KIND_COUNTER,
   "measured uplink bytes billed this round", unit="bytes")
_r("wire/bytes_down", KIND_COUNTER,
   "measured downlink bytes billed this round", unit="bytes")
# ---- fault injection -------------------------------------------------
_r("fault/lost", KIND_COUNTER,
   "selected clients whose update was lost mid-round",
   engines=("sync",))
# ---- serving (rows are per decode step, not round) -------------------
_r("serve/admitted", KIND_COUNTER,
   "requests admitted into decode slots this step", engines=("serve",),
   unit="requests")
_r("serve/evicted", KIND_COUNTER,
   "requests evicted (EOS / length budget) this step",
   engines=("serve",), unit="requests")
_r("serve/tokens", KIND_COUNTER,
   "tokens decoded this step", engines=("serve",), unit="tokens")
_r("serve/slot_occupancy", KIND_GAUGE,
   "decode slots holding a live request after this step",
   engines=("serve",), unit="slots")
_r("serve/pages_in_use", KIND_GAUGE,
   "KV pages allocated out of the pool after this step",
   engines=("serve",), unit="pages")
_r("serve/tokens_per_s", KIND_GAUGE,
   "measured decode throughput (host wall clock, filled at drain)",
   engines=("serve",), unit="tok/s")


def age_hist_len(fed_cfg) -> int:
    """Static retry-age histogram length: ages 1..max_retries (a row older
    than its budget is abandoned, never buffered)."""
    return max(int(getattr(fed_cfg, "async_max_retries", 0)), 1)


def shape_for(spec: CounterSpec, fed_cfg) -> Tuple[int, ...]:
    if spec.name == "buffer/age_hist":
        return (age_hist_len(fed_cfg),)
    return spec.shape


def specs_for(engine: str) -> Dict[str, CounterSpec]:
    """The registry slice one engine publishes."""
    return {n: s for n, s in REGISTRY.items() if engine in s.engines}


def init_column(engine: str, fed_cfg, device=None) -> Dict[str, torch.Tensor]:
    """The counter column: one zeroed fp32 tensor a registered signal of
    ``engine``, on ``device``."""
    return {n: torch.zeros(shape_for(s, fed_cfg), device=device)
            for n, s in specs_for(engine).items()}


def accumulate(tele: Dict[str, torch.Tensor],
               round_values: Dict[str, torch.Tensor],
               engine: str) -> Dict[str, torch.Tensor]:
    """One round's values folded into the column: counters add, gauges
    overwrite.  ``round_values`` must cover the engine's slice (the
    column's keys), each a tensor on the column's device."""
    out = {}
    for name, spec in specs_for(engine).items():
        v = round_values[name].float()
        out[name] = tele[name] + v if spec.kind == KIND_COUNTER else v
    return out


def metric_keys(round_values: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """Per-round history entries: ``obs/<name>`` -> fp32 tensor."""
    return {METRIC_PREFIX + n: v.float() for n, v in round_values.items()}


def _quantile_plan(n: int):
    """``jnp.quantile``'s linear method at QUANTILE_PROBS over n sorted
    values, worked out on the host in fp32 as JAX does it: for each
    probability q, the ranks floor and ceil of q (n - 1), clamped to
    [0, n - 1], and the weights 1 - w and w, w = q (n - 1) - floor."""
    q = np.asarray(QUANTILE_PROBS, np.float32) * np.float32(n - 1)
    lo, hi = np.floor(q), np.ceil(q)
    hw = (q - lo).astype(np.float32)
    lw = (np.float32(1.0) - hw).astype(np.float32)
    lo = np.clip(lo, 0, n - 1).astype(np.int64)
    hi = np.clip(hi, 0, n - 1).astype(np.int64)
    return [(int(a), int(b), float(c), float(d))
            for a, b, c, d in zip(lo, hi, lw, hw)]


def quantiles(x: torch.Tensor) -> torch.Tensor:
    """[p10, p50, p90] gauge of a cohort column, bitwise ``jnp.quantile``
    (linear): a NaN anywhere makes every quantile NaN; the values are
    sorted stably by the order-preserving image of their bits with -0.0
    folded into +0.0 (``lax.sort`` ties the two, the first stays first);
    each quantile is high w + low (1 - w) from static ranks and host
    weights, so no host read and no host copy.  XLA's CPU backend contracts
    that sum into one fused multiply-add, fma(high, w, fp32(low (1 - w))),
    so the port forms high w exactly in float64, adds, and rounds once to
    fp32 (the same value unless the float64 sum is itself rounded onto an
    fp32 midpoint, which needs operands 2^29 apart).  ``torch.quantile`` is
    not used: it interpolates by ``lerp``, which rounds otherwise."""
    x = x.float().reshape(-1)
    x = torch.where(torch.isnan(x).any(), torch.full_like(x, float("nan")),
                    x)
    bits = (x + 0.0).contiguous().view(torch.int32)     # -0.0 + 0.0 = +0.0
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    s = x.gather(0, torch.sort(key, stable=True).indices)
    return torch.stack([(s[hi].double() * hw + (s[lo] * lw).double()).float()
                        for lo, hi, lw, hw in _quantile_plan(x.shape[0])])


def age_histogram(age: torch.Tensor, active: torch.Tensor,
                  fed_cfg) -> torch.Tensor:
    """Active buffered rows bucketed by retry age: bucket i counts rows
    aged i + 1 (ages start at 1 when a row parks)."""
    n = age_hist_len(fed_cfg)
    buckets = torch.arange(1, n + 1, device=age.device)
    onehot = (age[:, None] == buckets[None, :]).float()
    return (onehot * active[:, None]).sum(dim=0)


def row_obs(row: dict) -> dict:
    """The ``obs/`` slice of one drained history row, prefix stripped."""
    return {k[len(METRIC_PREFIX):]: v for k, v in row.items()
            if isinstance(k, str) and k.startswith(METRIC_PREFIX)}
