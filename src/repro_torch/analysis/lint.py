"""Entry-point audit CLI (port of ``repro/analysis/lint.py``).

  PYTHONPATH=src python -m repro_torch.analysis.lint --all [--json report.json]
  PYTHONPATH=src python -m repro_torch.analysis.lint --entry aggregate --device cpu
  PYTHONPATH=src python -m repro_torch.analysis.lint --list

Builds every registered entry point (``analysis/entrypoints.py``) on the
device, runs it once under ``traversal.OpLog`` (its aten ops, kernel
regions and counts; on the card also its kernel launches, read from the
launch counters), runs the rule registry (``analysis/rules.py``) over
that, prints findings, and exits nonzero when any finding at/above
--fail-on severity survives.  ``--device`` defaults to the card
(``device.resolve``: it raises without one); ``--device cpu`` audits the
plain versions of the kernels.  An entry that needs more ranks than one
process has (``aggregate_sharded``) runs as rank 0 of a fake process group
of that many (``launch/mesh.fake_group``); where a process group already
exists, no fake one can stand in, and the entry is SKIPPED with that
reason.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch

from repro_torch import device as device_mod
from repro_torch.analysis import entrypoints as ep
from repro_torch.analysis import rules as rules_mod
from repro_torch.analysis import traversal as tv
from repro_torch.analysis.report import EntryResult, Report


def _at(obj, path):
    for p, leaf in ep.paths(obj):
        if p == path:
            return leaf
    raise KeyError(f"no leaf at {path}")


def _capture(target):
    """The entry as a captured step: one eager warm-up on a side stream,
    then ``torch.cuda.graph`` on that stream with the arguments'
    generators registered, and one replay; the launch counters are set
    back (a capture and a replay are not calls of the entry)."""
    from repro_torch.kernels import launches
    before = launches.snapshot()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    try:
        with torch.cuda.stream(stream):
            target.fn(*target.args)
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        for g in tv.generators(target.args):
            if g.device.type == "cuda":
                graph.register_generator_state(g)
        with torch.cuda.graph(graph, stream=stream):
            target.fn(*target.args)
        graph.replay()
        torch.cuda.synchronize()
    finally:
        launches.restore(before)


def run_target(name, target, dev, result=None) -> rules_mod.RuleContext:
    """One call of ``target`` under the op log, and the rule context that
    reads it (the rules are not run)."""
    from repro_torch.kernels import launches
    result = result or EntryResult(entry=name)
    args = target.args
    gens = [(f"args{p}", g) for p, g in ep.paths(args)
            if isinstance(g, torch.Generator)]
    gen_before = [tv.gen_state(g) for _, g in gens]
    alias = [(i, p, tv.storage_of(_at(args[i], p)))
             for i, p in target.donate_must_alias]
    cuda = dev.type == "cuda"
    before = launches.snapshot() if cuda else None
    log = tv.OpLog()
    with log:
        out = target.fn(*args)
    launched = None
    if cuda:
        torch.cuda.synchronize()
        launched = {tv.launch_name(fn, mode): n
                    for (fn, mode), n in launches.since(before).items()}
    outs = out if isinstance(out, tuple) else (out,)
    n_half = sum(1 for _, x in ep.paths(outs)
                 if isinstance(x, torch.Tensor) and x.dtype in tv.HALF)
    return rules_mod.RuleContext(
        entry_name=name, log=log, result=result, device=dev,
        copy_mode=target.copy_mode, copy_threshold=target.copy_threshold,
        collective_allowlist=target.collective_allowlist,
        donate_must_alias=tuple(
            (f"args[{i}]{p}", s,
             tv.storage_of(_at(outs[target.carry[i]], p)))
            for i, p, s in alias),
        check_rng_advance=target.check_rng_advance,
        carry_generators=tuple(
            (label, g, b, tv.gen_state(g))
            for (label, g), b in zip(gens, gen_before)),
        rules_off=target.rules_off,
        expected_launches=target.expected_launches, launched=launched,
        hbm_payload_bytes=target.hbm_payload_bytes, n_half_out=n_half,
        capture=((lambda: _capture(target))
                 if cuda and target.donate_must_alias else None))


def _group(entry):
    """The fake process group an entry of ``min_devices`` ranks runs in,
    or the reason it cannot."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    if entry.min_devices <= 1:
        return contextlib.nullcontext(), None
    if not dist.is_available():
        return None, "torch.distributed is not available"
    if dist.is_initialized():
        return None, (f"needs {entry.min_devices} ranks: a default process "
                      "group exists in this process, and the fake group "
                      "that stands in for them needs a process of its own")
    return mesh_mod.fake_group(entry.min_devices), None


def audit_entry(entry: ep.EntryPoint, dev, meta=None) -> EntryResult:
    """Build one entry, run it once under the op log, run every rule.
    ``meta`` (a report's meta), if given, gains the entry's launches (the
    card's counters, or the CPU's kernel regions), its expected launches
    and each kernel's shared memory at its shapes."""
    result = EntryResult(entry=entry.name)
    group, reason = _group(entry)
    if group is None:
        result.status = "skipped"
        result.skipped_reason = reason
        return result
    with group:
        target = entry.build(dev)
        ctx = run_target(entry.name, target, dev, result)
        rules_mod.run_rules(ctx)
    if meta is not None:
        meta["launches"][entry.name] = (ctx.launched if ctx.launched
                                        is not None else ctx.log.launches())
        meta["expected_launches"][entry.name] = target.expected_launches
        meta["smem"][entry.name] = sorted(
            {(r.launch, r.smem) for r in ctx.log.regions},
            key=lambda x: (x[0], x[1] or 0))
    return result


def run(names=None, device=None) -> Report:
    dev = device_mod.resolve(device)
    report = Report(meta={
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "torch": torch.__version__,
        "rules": sorted(rules_mod.RULES),
        "seconds": {}, "launches": {}, "expected_launches": {}, "smem": {},
    })
    if dev.type == "cuda":
        from repro_torch.kernels import robust_pipeline as rp
        report.meta["smem_limit"] = rp.SMEM_LIMIT
        report.meta["smem_optin"] = torch.cuda.get_device_properties(
            dev).shared_memory_per_block_optin
    for name, entry in ep.ENTRYPOINTS.items():
        if names and name not in names:
            continue
        t = time.perf_counter()
        report.add(audit_entry(entry, dev, report.meta))
        report.meta["seconds"][name] = time.perf_counter() - t
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="aten-op invariant linter over the registered entry "
                    "points")
    ap.add_argument("--all", action="store_true",
                    help="audit every registered entry point")
    ap.add_argument("--entry", action="append", default=[],
                    help="audit one entry (repeatable); see --list")
    ap.add_argument("--list", action="store_true",
                    help="list registered entry points and exit")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the JSON report here")
    ap.add_argument("--fail-on", choices=["error", "note"],
                    default="error",
                    help="exit nonzero on findings at/above this severity")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the entries run (default: the card, which "
                         "must be there)")
    args = ap.parse_args(argv)

    if args.list:
        for name, entry in ep.ENTRYPOINTS.items():
            gate = (f" [>= {entry.min_devices} devices]"
                    if entry.min_devices > 1 else "")
            print(f"{name:32s} {entry.doc}{gate}")
        return 0
    if not args.all and not args.entry:
        ap.error("pick --all, --entry NAME, or --list")
    unknown = [n for n in args.entry if n not in ep.ENTRYPOINTS]
    if unknown:
        ap.error(f"unknown entries {unknown}; see --list")

    report = run(set(args.entry) or None, args.device)
    if args.json:
        with open(args.json, "w") as f:
            f.write(report.to_json())

    for res in report.results:
        if res.status == "skipped":
            print(f"SKIP {res.entry}: {res.skipped_reason}")
            continue
        mark = "FAIL" if res.findings else "ok  "
        print(f"{mark} {res.entry} "
              f"({report.meta['seconds'][res.entry]:.2f} s)")
        for note in res.notes:
            print(f"       note: {note}")
        for f in res.findings:
            print(f"       {f}")

    failing = report.errors() if args.fail_on == "error" \
        else report.findings
    n_err = len(failing)
    n_skip = sum(r.status == "skipped" for r in report.results)
    print(f"\n{len(report.results)} entries audited "
          f"({n_skip} skipped), {n_err} finding(s) on "
          f"{report.meta['device']}")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
