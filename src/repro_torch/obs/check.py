"""Schema check for emitted telemetry artifacts — the port of
``repro/obs/check.py``, the same rules, runnable where jax is absent.

  PYTHONPATH=src python -m repro_torch.obs.check \
      --trace out.json --jsonl metrics.jsonl [--min-phases 5] \
      [--require-obs] [--engine async]

Validates that

  * the trace file is Chrome/Perfetto-loadable trace-event JSON (a
    ``traceEvents`` list of complete "X" events with name/ts/dur), and
    that every round on the round track carries at least
    ``--min-phases`` DISTINCT phase spans (the acceptance bar is 5);
  * the JSONL stream is one JSON object per line with a known ``kind``
    (metrics | warning | summary), metrics rows carry a round/step
    index, and — with ``--require-obs`` — the registered counters of
    ``--engine`` are all present on every metrics row.

Exit code 0 = clean; 1 = findings (printed one per line).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.obs import counters as obs_counters
from repro_torch.obs.trace import PHASE_NAMES

KINDS = {"metrics", "warning", "summary"}


def check_trace(trace, *, min_phases: int = 5) -> List[str]:
    """Validate a trace-event dict (or path); returns finding strings."""
    errs: List[str] = []
    if isinstance(trace, str):
        try:
            with open(trace) as f:
                trace = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return [f"trace: unreadable ({e})"]
    evs = trace.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["trace: no traceEvents list"]
    per_round: dict = {}
    measured_rounds: set = set()
    for i, e in enumerate(evs):
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in e:
                errs.append(f"trace: event {i} missing {field!r}")
                break
        else:
            if e["ph"] == "X" and ("dur" not in e or e["dur"] <= 0):
                errs.append(
                    f"trace: event {i} ({e['name']}) X-phase without "
                    "positive dur")
            args = e.get("args", {})
            if e["name"] in PHASE_NAMES and "round" in args:
                per_round.setdefault(args["round"], set()).add(e["name"])
            elif e["name"] == "round" and "round" in args:
                # measured per-round span (python driver / serving
                # engine) — counts as round coverage without a phase
                # split
                measured_rounds.add(args["round"])
    if not per_round and not measured_rounds:
        errs.append("trace: no per-round spans (expected phase names "
                    f"from {list(PHASE_NAMES)} or measured 'round' "
                    "spans)")
    for rnd, names in sorted(per_round.items()):
        if len(names) < min_phases:
            errs.append(
                f"trace: round {rnd} has {len(names)} distinct phase "
                f"spans ({sorted(names)}), need >= {min_phases}")
    return errs


def check_jsonl(path: str, *, require_obs: bool = False,
                engine: Optional[str] = None) -> List[str]:
    """Validate a telemetry JSONL stream; returns finding strings."""
    errs: List[str] = []
    want = None
    if require_obs:
        want = {obs_counters.METRIC_PREFIX + n
                for n in obs_counters.specs_for(engine or "sync")}
    n_metrics = n_summary = 0
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError as e:
        return [f"jsonl: unreadable ({e})"]
    for i, line in enumerate(lines, 1):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            errs.append(f"jsonl:{i}: not JSON ({e})")
            continue
        kind = rec.get("kind")
        if kind not in KINDS:
            errs.append(f"jsonl:{i}: unknown kind {kind!r}")
            continue
        if kind == "metrics":
            n_metrics += 1
            if "round" not in rec and "step" not in rec:
                errs.append(f"jsonl:{i}: metrics row without round/step")
            if want is not None:
                missing = want - set(rec)
                if missing:
                    errs.append(f"jsonl:{i}: metrics row missing "
                                f"{sorted(missing)[:3]}"
                                f"{'...' if len(missing) > 3 else ''}")
        elif kind == "warning":
            for field in ("monitor", "value", "threshold"):
                if field not in rec:
                    errs.append(f"jsonl:{i}: warning without {field!r}")
        else:
            n_summary += 1
    if n_metrics == 0:
        errs.append("jsonl: no metrics records")
    if n_summary == 0:
        errs.append("jsonl: no summary record (run not finished?)")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.check",
        description="Schema-check telemetry trace/JSONL artifacts")
    ap.add_argument("--trace", default=None)
    ap.add_argument("--jsonl", default=None)
    ap.add_argument("--min-phases", type=int, default=5)
    ap.add_argument("--require-obs", action="store_true",
                    help="metrics rows must carry every registered "
                         "counter of --engine")
    ap.add_argument("--engine", default="sync",
                    choices=["sync", "async", "serve"])
    args = ap.parse_args(argv)
    if not (args.trace or args.jsonl):
        ap.error("nothing to check: pass --trace and/or --jsonl")
    errs: List[str] = []
    if args.trace:
        errs += check_trace(args.trace, min_phases=args.min_phases)
    if args.jsonl:
        errs += check_jsonl(args.jsonl, require_obs=args.require_obs,
                            engine=args.engine)
    for e in errs:
        print(e)
    if not errs:
        checked = [p for p in (args.trace, args.jsonl) if p]
        print(f"ok: {', '.join(checked)}")
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
