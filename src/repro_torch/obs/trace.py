"""Phase-level trace emitter: Chrome/Perfetto trace-event JSON (port of
``repro/obs/trace.py``).

Rounds replay inside one captured CUDA graph a chunk, so the host cannot
clock a round's phases without a host read a phase.  The emitter keeps
two tiers, and says which is which:

  * **measured spans**: what the host clock sees.  The chunked driver
    emits a chunk's ``stage`` (building the next chunk's batches),
    ``compute`` (dispatching the replays), ``drain`` (the one host read)
    and ``chunk`` (dispatch through drain) spans; the per-round loops and
    the serving engine, which read the host once a round or step, emit a
    measured ``round`` span each (``emit_rounds(measured=True)``; real
    ``perf_counter`` timestamps, no ``attributed`` flag).
  * **attributed spans**: inside a chunk, each round's share of the window
    is split into the engine's phases (selection -> client_update ->
    delivery -> sanitize -> aggregate -> writeback) by the static weights
    below.  The boundaries are attribution (``args.attributed``); each
    span's ``args`` carry that round's real drained ``obs/`` values.

For device timelines pass ``profiler_dir`` to ``Telemetry``: the run is
wrapped in ``torch.profiler`` (CPU and CUDA activity) and a Chrome trace
is written there.  Inside a round, :func:`annotate` names a phase with
``torch.profiler.record_function`` and an NVTX range, both host-side
metadata: no device op is added, so telemetry on stays bit for bit the
run with it off, and a captured graph is unchanged.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

# The phase sequence (name, sync weight, async weight): the static split of
# a round's window, estimates rather than measurements (client_update, the
# vmapped local epochs, dominates).
PHASES: Tuple[Tuple[str, float, float], ...] = (
    ("selection", 0.05, 0.08),
    ("client_update", 0.60, 0.52),
    ("delivery", 0.05, 0.12),
    ("sanitize", 0.05, 0.05),
    ("aggregate", 0.15, 0.13),
    ("writeback", 0.10, 0.10),
)

PHASE_NAMES: Tuple[str, ...] = tuple(p[0] for p in PHASES)


def phase_weights(engine: str) -> Dict[str, float]:
    col = 1 if engine == "sync" else 2
    w = {p[0]: p[col] for p in PHASES}
    total = sum(w.values())
    return {k: v / total for k, v in w.items()}


def counter_tracks() -> Tuple[str, ...]:
    """The registered scalar gauges exported as Perfetto counter ("C")
    tracks: the async buffer occupancy and every serve/* gauge."""
    from repro_torch.obs import counters as obs_counters
    return tuple(
        n for n, s in obs_counters.REGISTRY.items()
        if s.kind == obs_counters.KIND_GAUGE and s.shape == ()
        and (n == "buffer/occupancy" or n.startswith("serve/")))


@contextlib.contextmanager
def annotate(name: str):
    """A phase's name for profiler traces: ``record_function`` (the
    ``torch.profiler`` CPU span) and, on a CUDA build with a device, an
    NVTX range.  Host-side metadata only."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class TraceRecorder:
    """Collects trace events and writes ``{"traceEvents": [...]}``.

    Events use the Chrome trace-event "X" (complete) phase with
    microsecond timestamps; ``pid`` groups engines, ``tid`` separates the
    driver track (0) from the round track (1).
    """

    DRIVER_TID = 0
    ROUND_TID = 1

    def __init__(self, engine: str = "sync"):
        self.engine = engine
        self.events: List[dict] = []
        self._t0 = time.perf_counter()
        self._weights = phase_weights(engine)
        self._open: Dict[str, float] = {}

    # -- measured spans (host wall clock) -----------------------------
    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def begin(self, name: str) -> None:
        self._open[name] = self.now_us()

    def end(self, name: str, **args) -> None:
        start = self._open.pop(name, None)
        if start is None:
            return
        self.span(name, start, self.now_us() - start,
                  tid=self.DRIVER_TID, **args)

    def span(self, name: str, ts_us: float, dur_us: float, *,
             tid: int = 0, **args) -> None:
        self.events.append({
            "name": name, "ph": "X", "pid": 0, "tid": tid,
            "ts": ts_us, "dur": max(dur_us, 0.01),
            "args": args,
        })

    # -- per-round spans (measured and/or attributed) -----------------
    def emit_rounds(self, window_start_us: float, window_dur_us: float,
                    rows: Sequence[dict], *, measured: bool = False,
                    phases: bool = True) -> None:
        """Splits a measured window (a chunk, or one round of a per-round
        loop) over its rounds, and each round over the engine's phases;
        each phase span carries the round's ``obs/`` values in ``args``.
        ``measured=True``: the window is one real host measurement a row,
        so each round also gets a measured ``round`` span.
        ``phases=False`` drops the attributed split (serving has no FL
        phases).  Scalar gauges of :func:`counter_tracks` become counter
        ("C") events at each round's start."""
        if not rows:
            return
        tracks = counter_tracks()
        per_round = window_dur_us / len(rows)
        for j, row in enumerate(rows):
            r0 = window_start_us + j * per_round
            rnd = row.get("round", row.get("step", j))
            obs = {k: _num(v) for k, v in row.items()
                   if isinstance(k, str) and k.startswith("obs/")}
            if measured:
                self.span("round", r0, per_round, tid=self.ROUND_TID,
                          round=_num(rnd), **obs)
            for name in tracks:
                v = obs.get("obs/" + name)
                if isinstance(v, (int, float)):
                    self.events.append({
                        "name": name, "ph": "C", "pid": 0,
                        "tid": self.ROUND_TID, "ts": r0,
                        "args": {"value": v}})
            if not phases:
                continue
            off = 0.0
            for name in PHASE_NAMES:
                dur = per_round * self._weights[name]
                self.span(name, r0 + off, dur, tid=self.ROUND_TID,
                          round=_num(rnd), attributed=True, **obs)
                off += dur

    def to_json(self) -> dict:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "otherData": {"engine": self.engine,
                              "phase_weights": self._weights}}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
        return path


def _num(v):
    """A drained value as a JSON number (a list for a vector)."""
    if hasattr(v, "ndim") and v.ndim > 0:
        return [_num(x) for x in v.tolist()]
    try:
        f = float(v)
    except (TypeError, ValueError):
        return str(v)
    return int(f) if f == int(f) else f


@contextlib.contextmanager
def profiler_session(profiler_dir: Optional[str]):
    """The device-timeline escape hatch: with a directory, the run under
    ``torch.profiler`` (CPU activity, and CUDA activity where a device
    is present), its Chrome trace written to ``profiler_dir/trace.json``
    at the end; else a no-op."""
    if not profiler_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profiler_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profiler_dir, "trace.json"))
