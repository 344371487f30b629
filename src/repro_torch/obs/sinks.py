"""Telemetry sinks: where drained metric rows and monitor warnings go (port
of ``repro/obs/sinks.py``).

A sink consumes records already on the host (the driver has drained the
chunk, rows are numpy values), so sinks never touch device state and
cannot perturb the run.  Protocol: ``emit(record)``, ``flush()``,
``close()``.  Implementations:

  * :class:`JsonlSink` — one JSON object per line, the machine-readable
    stream ``obs/check.py`` schema-checks.
  * :class:`MemorySink` — bounded in-memory ring for tests and the
    scenario engine (every matrix cell keeps its telemetry record
    without touching disk).
  * :class:`StdoutSink` — prefixed human-readable lines.
  * :class:`MultiSink` — fan-out.
"""
from __future__ import annotations

import collections
import json
import sys
from typing import IO, Iterable, List, Optional

import numpy as np
import torch


def jsonable(v):
    """Coerce numpy and torch scalars and arrays into JSON-native values."""
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        v = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    if isinstance(v, dict):
        return {k: jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [jsonable(x) for x in v]
    arr = np.asarray(v)
    if arr.ndim == 0:
        f = float(arr)
        return int(f) if float(f).is_integer() and abs(f) < 2**53 else f
    return [jsonable(x) for x in arr.tolist()]


class Sink:
    """Base sink: subclass and override ``emit``."""

    def emit(self, record: dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.flush()


class JsonlSink(Sink):
    def __init__(self, path: str):
        self.path = path
        self._f: Optional[IO[str]] = open(path, "w")

    def emit(self, record: dict) -> None:
        if self._f is None:
            raise ValueError(f"JsonlSink({self.path}) already closed")
        self._f.write(json.dumps(jsonable(record)) + "\n")

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class MemorySink(Sink):
    def __init__(self, capacity: int = 4096):
        self.records: collections.deque = collections.deque(maxlen=capacity)

    def emit(self, record: dict) -> None:
        self.records.append(jsonable(record))

    def by_kind(self, kind: str) -> List[dict]:
        return [r for r in self.records if r.get("kind") == kind]


class StdoutSink(Sink):
    def __init__(self, stream: Optional[IO[str]] = None, prefix: str = "# obs "):
        self.stream = stream or sys.stdout
        self.prefix = prefix

    def emit(self, record: dict) -> None:
        self.stream.write(self.prefix + json.dumps(jsonable(record)) + "\n")

    def flush(self) -> None:
        self.stream.flush()


class MultiSink(Sink):
    def __init__(self, sinks: Iterable[Sink]):
        self.sinks = list(sinks)

    def emit(self, record: dict) -> None:
        for s in self.sinks:
            s.emit(record)

    def flush(self) -> None:
        for s in self.sinks:
            s.flush()

    def close(self) -> None:
        for s in self.sinks:
            s.close()
