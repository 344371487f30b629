"""Finding / report types for the invariant linter (port of
``repro/analysis/report.py``: the same fields and the same JSON schema).

A `Finding` is one rule violation pinned to an entry point, with the
provenance of the offending aten op when the rule works at the op level.
A `Report` collects per-entry results plus informational notes (e.g. each
kernel's shared memory at the entry's shapes) and serializes to the JSON
artifact a CI gate uploads.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

SEV_ERROR = "error"
SEV_NOTE = "note"


@dataclasses.dataclass
class Finding:
    rule: str                       # registry name of the firing rule
    entry: str                      # entry-point name
    message: str
    severity: str = SEV_ERROR
    provenance: str = "?"           # file:line (fn) of the offending op
    primitive: Optional[str] = None
    shape: Optional[str] = None

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    def __str__(self) -> str:
        loc = f" @ {self.provenance}" if self.provenance != "?" else ""
        return (f"[{self.severity}] {self.entry} :: {self.rule}: "
                f"{self.message}{loc}")


@dataclasses.dataclass
class EntryResult:
    entry: str
    status: str = "ok"              # ok | findings | skipped
    findings: List[Finding] = dataclasses.field(default_factory=list)
    notes: List[str] = dataclasses.field(default_factory=list)
    skipped_reason: Optional[str] = None

    def to_dict(self) -> dict:
        d = {"entry": self.entry, "status": self.status,
             "findings": [f.to_dict() for f in self.findings],
             "notes": self.notes}
        if self.skipped_reason:
            d["skipped_reason"] = self.skipped_reason
        return d


@dataclasses.dataclass
class Report:
    results: List[EntryResult] = dataclasses.field(default_factory=list)
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def add(self, result: EntryResult) -> None:
        self.results.append(result)

    @property
    def findings(self) -> List[Finding]:
        return [f for r in self.results for f in r.findings]

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEV_ERROR]

    def to_dict(self) -> dict:
        return {
            "meta": self.meta,
            "summary": {
                "entries": len(self.results),
                "skipped": sum(r.status == "skipped" for r in self.results),
                "errors": len(self.errors()),
                "notes": (sum(len(r.notes) for r in self.results)
                          + sum(f.severity == SEV_NOTE
                                for f in self.findings)),
            },
            "results": [r.to_dict() for r in self.results],
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)
