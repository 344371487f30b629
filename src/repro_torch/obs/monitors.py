"""Drift monitors: threshold tripwires over the drained metric stream (port
of ``repro/obs/monitors.py``, with the same monitors, thresholds and
streaks).

A :class:`Monitor` watches one derived per-round value and fires after
the predicate holds for ``k_consecutive`` rounds — the "gate rejected
>50% of the cohort for 3 straight rounds" class of silent degradation
the end-of-run summary can't surface.  Warnings are structured records
(``kind="warning"``) emitted into the same sink stream as the metrics,
so a JSONL tail or the scenario summary sees them in order.

Monitors run host-side on already-drained rows: they cannot perturb the
run, and they see exactly what the engine measured.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Callable, Dict, List, Optional, Sequence

OPS = {">": operator.gt, ">=": operator.ge,
       "<": operator.lt, "<=": operator.le}


@dataclasses.dataclass
class Monitor:
    """Fire when ``value(row) op threshold`` holds k rounds running."""
    name: str
    value: Callable[[dict], Optional[float]]   # None = not applicable
    op: str
    threshold: float
    k_consecutive: int = 1
    doc: str = ""
    # internal streak state
    _streak: int = dataclasses.field(default=0, init=False)
    _fired: int = dataclasses.field(default=0, init=False)

    def observe(self, row: dict) -> Optional[dict]:
        v = self.value(row)
        if v is None:
            return None
        v = float(v)
        if OPS[self.op](v, self.threshold):
            self._streak += 1
        else:
            self._streak = 0
            return None
        if self._streak < self.k_consecutive:
            return None
        self._fired += 1
        return {
            "kind": "warning", "monitor": self.name,
            "round": _round_of(row), "value": v,
            "threshold": self.threshold, "op": self.op,
            "streak": self._streak, "doc": self.doc,
        }


def _round_of(row: dict):
    for k in ("round", "step"):
        if k in row:
            try:
                return int(float(row[k]))
            except (TypeError, ValueError):
                return row[k]
    return None


def _obs(row: dict, name: str) -> Optional[float]:
    v = row.get("obs/" + name)
    return None if v is None else float(v)


def _ratio(num: Optional[float], den: Optional[float]) -> Optional[float]:
    if num is None or den is None or den <= 0:
        return None
    return num / den


def _gate_frac(row):
    return _ratio(_obs(row, "gate/cosine_rejected"),
                  _obs(row, "select/team_size"))


def _guard_frac(row):
    g = [_obs(row, "guard/nonfinite"), _obs(row, "guard/norm")]
    if any(x is None for x in g):
        return None
    return _ratio(sum(g), _obs(row, "select/team_size"))


def _overflow_frac(row):
    o = _obs(row, "buffer/overflow")
    p = _obs(row, "buffer/parked")
    if o is None or p is None:
        return None
    return _ratio(o, o + p) if (o + p) > 0 else 0.0


def _trust_p50(row):
    q = row.get("obs/cohort/trust_q")
    if q is None:
        return None
    try:
        return float(q[1])
    except (TypeError, IndexError):
        return None


def default_monitors() -> List[Monitor]:
    """The stock tripwires; callers extend or replace freely."""
    return [
        Monitor("gate_rejecting_majority", _gate_frac, ">", 0.5,
                k_consecutive=3,
                doc="cosine gate rejected >50% of the cohort for 3 "
                    "consecutive rounds — model drift or gate "
                    "miscalibration"),
        Monitor("guard_rejecting_majority", _guard_frac, ">", 0.5,
                k_consecutive=2,
                doc="sanitize boundary rejected >50% of deliveries for "
                    "2 consecutive rounds — poisoning or numeric "
                    "blow-up upstream"),
        Monitor("buffer_overflowing", _overflow_frac, ">", 0.25,
                k_consecutive=2,
                doc=">25% of late deliveries dropped for lack of buffer "
                    "slots — raise async_max_retries or the deadline"),
        Monitor("cohort_trust_collapsed", _trust_p50, "<", 0.1,
                k_consecutive=3,
                doc="median cohort trust under 0.1 for 3 consecutive "
                    "rounds — the scheduler is starving"),
    ]


class MonitorBank:
    """Runs a monitor set over each drained row, collecting warnings."""

    def __init__(self, monitors: Optional[Sequence[Monitor]] = None):
        self.monitors = list(monitors if monitors is not None
                             else default_monitors())
        self.warnings: List[dict] = []

    def observe(self, row: dict) -> List[dict]:
        fired = []
        for m in self.monitors:
            w = m.observe(row)
            if w is not None:
                fired.append(w)
        self.warnings.extend(fired)
        return fired

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for w in self.warnings:
            out[w["monitor"]] = out.get(w["monitor"], 0) + 1
        return out
