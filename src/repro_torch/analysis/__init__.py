"""Static analysis of the port's entry points: the invariant linter behind
``python -m repro_torch.analysis.lint`` (port of ``repro/analysis``).

The port's performance and trustworthiness rest on structural invariants
(no flatten materialization on the aggregation path, explicit generators,
carried state written in place and safe to capture, fp32 accumulation
with TF32 off, kernels inside the card's shared memory, bounded
collectives).  This package makes them checked facts on every entry point:

  traversal.py    ``OpLog``: one call's aten ops under a TorchDispatchMode
                  built on ``launch/roofline.CostCounter``, with each op's
                  provenance and each kernel call as one opaque region
  report.py       Finding / EntryResult / Report (the JSON artifact; the
                  reference's schema)
  rules.py        the rule registry (copy lint, rng discipline and
                  advance, donation audit with the card's capture, dtype
                  discipline, the shared-memory budget, launch counts,
                  collective allowlists)
  entrypoints.py  the audited entry points, built lazily at linter scale
                  on a device
  lint.py         the CLI: ``--all | --entry NAME | --list``, ``--device``,
                  JSON report, nonzero exit on findings

``repro/analysis/hlo.py`` has no twin: collective bytes come from
``CostCounter.collectives`` and the alias map from storages compared
before and after the call (``traversal``'s docstring).

Rule-author guide
-----------------

**Registering an entry point** (entrypoints.py): decorate a function of
one argument, the device, returning a
:class:`~repro_torch.analysis.entrypoints.Target`::

    @register_entry("my_engine.make_step", min_devices=1,
                    doc="one-line description for --list")
    def _build(device):
        fn, args = ...            # a callable + SMALL example args there
        return Target(fn, args,
                      carry={0: 0},               # arg 0 comes back as
                                                  # output 0
                      donate_must_alias=_must_alias(   # carried buffers
                          0, state, (".params",)),     # written in place
                      copy_mode="engine",         # or "strict" / "off"
                      copy_threshold=max_leaf,    # op output size that
                                                  # counts
                      collective_allowlist={},    # {} = none allowed
                      check_rng_advance=True,     # carried generators
                                                  # must move
                      expected_launches={         # one call's launches
                          "cosine_gate_partials": 1,
                          "gated_combine[trimmed]": 1})

Keep these functions lazy (imports inside) and tiny: the invariants are
structural, so linter-scale models keep ``--all`` cheap.  A round body
runs as ``ScanDriver``'s replayed step runs it (``_committed``: the new
state copied into the carried one).  An entry whose invariants bite only across
ranks sets ``min_devices``: the linter runs it as rank 0 of a fake process
group of that many (collectives move nothing; their bytes are counted),
and reports it skipped, with the reason, where a process group exists.

**Writing a rule** (rules.py): decorate a function over a
:class:`~repro_torch.analysis.rules.RuleContext`::

    @register_rule("my_rule")
    def my_rule(ctx):
        for op in ctx.log.ops:             # traversal.Op: name, ins, outs,
            if bad(op):                    # provenance, dim, random, ...
                ctx.finding("my_rule", "what broke and why it matters",
                            op)            # provenance attached

``ctx.log.regions`` holds the kernel calls (launch counter name,
arguments, shared memory); ``ctx.launched`` the card's launches by
counter (None on the CPU); ``ctx.log.collectives`` and ``ctx.log.bytes``
``CostCounter``'s counts.  Emit ``ctx.note(...)`` for non-gating
diagnostics (each kernel's shared memory, the launches, what the card
alone can check).  A rule must give one verdict on both devices: read the
ops outside kernel regions, and keep what only the card can see in notes,
or in findings that flag a fault there.  Per-entry opt-outs go through
``Target.rules_off``; prefer tightening the rule over opting out.

**Marking a kernel region.**  A function where a kernel launches on a CUDA
tensor and its plain version runs on a CPU one goes into
``traversal.kernel_sites``: its function, ``counter(args) -> (launch
counter wrapper, mode)`` (the wrapper whose ``.launches`` the launch
adds to) and ``smem(args) -> (bytes or None, note)`` from the kernel's
own size function.  Its calls are then one region each on both devices:
nothing inside is logged, its arguments and result count once.

**Setting a collective allowlist**: ``collective_allowlist`` maps
collective kind -> max total bytes on this rank; kinds absent from the
dict are forbidden outright, ``{}`` forbids all collectives, and ``None``
disables the rule for that entry.  Derive caps from what the entry
legitimately moves (e.g. (C,) partials and the (C, C) Gram for
``aggregate_sharded``) with modest headroom: a param-sized operand
crossing the interconnect should always trip the cap.

Every rule must show BOTH directions in tests/test_torch_analysis.py:
silent on the clean entry points, firing on a deliberately violating
twin program.
"""
from repro_torch.analysis import report, traversal  # noqa: F401
from repro_torch.analysis.report import Finding, Report  # noqa: F401
from repro_torch.analysis.traversal import OpLog  # noqa: F401
