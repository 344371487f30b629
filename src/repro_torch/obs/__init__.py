"""Round-trace telemetry (the obs layer): counters, traces, monitors and
sinks — the port of ``repro/obs``.

:class:`Telemetry` is the one object callers hand to ``fedfits.run``,
``async_engine.run_async``, ``ScanDriver.run`` / ``run_chunked``,
``run_scenario`` and ``ServeEngine.run``.  It owns

  * the **counter column** switch (``counters=True``): the round bodies
    publish the registered signals as a column of the round state and
    ``obs/`` history keys (``obs/counters.py``), a pure readout that
    leaves the run bit for bit as it is with telemetry off;
  * the **trace recorder** (``trace_path=...``): Perfetto trace-event
    JSON with measured driver spans and attributed per-round phase spans
    (``obs/trace.py``), and ``profiler_dir``, which wraps a run in
    ``torch.profiler`` (``profiled()``);
  * the **sinks and drift monitors**: every drained row becomes a
    ``kind="metrics"`` record, every monitor trip a ``kind="warning"``
    record, fanned out to the sinks (``obs/sinks.py``,
    ``obs/monitors.py``).

Everything host-side runs where the rows reach the host anyway: at a
chunk's drain under the chunked driver, after a round's or step's one
host read in the per-round loops and the serving engine.  Telemetry adds
no host read, and under a captured graph no launch from the host.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

from repro_torch.obs import counters
from repro_torch.obs.counters import METRIC_PREFIX
from repro_torch.obs.monitors import Monitor, MonitorBank, default_monitors
from repro_torch.obs.sinks import (JsonlSink, MemorySink, MultiSink, Sink,
                                   StdoutSink, jsonable)
from repro_torch.obs.trace import (PHASE_NAMES, TraceRecorder, annotate,
                                   phase_weights, profiler_session)

__all__ = [
    "Telemetry", "Monitor", "MonitorBank", "default_monitors",
    "Sink", "JsonlSink", "MemorySink", "MultiSink", "StdoutSink",
    "TraceRecorder", "annotate", "profiler_session", "jsonable",
    "PHASE_NAMES", "METRIC_PREFIX", "counters",
]


class Telemetry:
    """Facade wiring counters, traces, sinks and monitors together.

    Construct once per run; the engines route it to the driver and the
    metric drain.  ``engine`` is set by whichever run() consumes it.
    """

    def __init__(self, *,
                 counters: bool = True,
                 sinks: Optional[Sequence[Sink]] = None,
                 monitors: Optional[Sequence[Monitor]] = None,
                 trace_path: Optional[str] = None,
                 profiler_dir: Optional[str] = None,
                 run_name: str = "run"):
        self.counters = counters
        self.sink: Sink = MultiSink(sinks or [])
        self.bank = MonitorBank(monitors)
        self.trace_path = trace_path
        self.profiler_dir = profiler_dir
        self.run_name = run_name
        self.engine: str = "sync"
        self.tracer: Optional[TraceRecorder] = (
            TraceRecorder() if trace_path else None)
        self.rows_seen = 0
        self._finished = False

    # -- engine hooks --------------------------------------------------
    def bind_engine(self, engine: str) -> "Telemetry":
        """Called by the consuming run(): fixes the engine's phase
        weights and counter slice."""
        self.engine = engine
        if self.tracer is not None:
            self.tracer.engine = engine
            self.tracer._weights = phase_weights(engine)
        return self

    def observe_rows(self, rows: Sequence[dict],
                     window_start_us: Optional[float] = None,
                     window_dur_us: Optional[float] = None, *,
                     measured: bool = False,
                     phases: bool = True) -> None:
        """Drain boundary: one call per chunk (scan) or round (python).
        Emits metrics records, runs monitors, and — when tracing —
        attributes the measured window across rounds and phases.
        ``measured=True`` marks the window as one real host measurement
        per row (python driver, serving engine): each round gets a
        measured ``round`` span; ``phases=False`` skips the attributed
        phase split (see TraceRecorder.emit_rounds)."""
        rows = list(rows)
        if not rows:
            return
        for row in rows:
            self.rows_seen += 1
            if self.sink.sinks:     # a row to JSON only for a sink to take
                rec = {"kind": "metrics", "engine": self.engine,
                       "run": self.run_name}
                rec.update(jsonable(row))
                self.sink.emit(rec)
            for w in self.bank.observe(row):
                w = dict(w)
                w["engine"] = self.engine
                w["run"] = self.run_name
                self.sink.emit(w)
        if self.tracer is not None:
            if window_dur_us is None:
                # no measured window handed in: a marker window of one
                # microsecond a row
                window_start_us = self.tracer.now_us()
                window_dur_us = float(len(rows))
            self.tracer.emit_rounds(window_start_us, window_dur_us, rows,
                                    measured=measured, phases=phases)

    # driver-measured spans pass straight through to the recorder
    def begin(self, name: str) -> None:
        if self.tracer is not None:
            self.tracer.begin(name)

    def end(self, name: str, **args) -> None:
        if self.tracer is not None:
            self.tracer.end(name, **args)

    def now_us(self) -> float:
        return self.tracer.now_us() if self.tracer is not None else \
            time.perf_counter() * 1e6

    # -- lifecycle -----------------------------------------------------
    def profiled(self):
        """Context manager for the ``torch.profiler`` escape hatch."""
        return profiler_session(self.profiler_dir)

    def summary(self) -> dict:
        return {"kind": "summary", "engine": self.engine,
                "run": self.run_name, "rows": self.rows_seen,
                "warnings": self.bank.counts(),
                "n_warnings": len(self.bank.warnings)}

    def finish(self) -> dict:
        """Flush sinks, write the trace file; idempotent."""
        s = self.summary()
        if self._finished:
            return s
        self._finished = True
        self.sink.emit(s)
        if self.tracer is not None and self.trace_path:
            self.tracer.save(self.trace_path)
        self.sink.close()
        return s
