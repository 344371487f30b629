"""The invariant rule registry (port of ``repro/analysis/rules.py``).

Each rule is a function over a :class:`RuleContext` (one entry point run
once under ``traversal.OpLog``: its aten ops, its kernel regions, its
counts, and the entry's declared expectations) that appends
:class:`~repro_torch.analysis.report.Finding`\\ s.  Register with
``@register_rule(name)``.  The names are the reference's, so the two
packages' reports compare.

Rules shipped here:

``copy_lint``        no leaf-sized flatten on the aggregation path, outside
                     kernel regions.  ``strict``: any ``cat`` / ``stack``
                     or ``copy_`` whose output is leaf-sized fires (a
                     rebuilt (C, N) matrix, by concatenation or by copies
                     into a buffer).  ``engine``: a ``cat`` / ``stack``
                     along any axis but the leading one fires, while the
                     async buffer's row concatenation and ``copy_`` into a
                     buffer that exists (the rounds write client rows and
                     the carry in place) stay legal.  Both: a leaf-sized
                     ``clone`` (``contiguous``) of a permuted layout, a
                     relayout copy, as the reference flags a transpose-fed
                     reshape.
``rng_discipline``   every random aten op draws from an explicit
                     ``torch.Generator`` (none from the global default
                     one), and no two draws start from one generator state
                     (a state restored in between: key reuse).
``rng_advance``      a carried generator the call drew from comes back
                     advanced: its state after the call differs from its
                     state before (a restored state replays its bits in
                     the next call).  One the call did not draw from has
                     spent nothing, and is noted.
``donation_audit``   the entry's ``donate_must_alias`` buffers keep their
                     storage across the call (the state is written in
                     place, the port's counterpart of donation into a
                     replayed graph's static buffers); on the card the
                     entry is also captured once by ``torch.cuda.graph``
                     after an eager warm-up, and a capture that fails is a
                     finding (ROADMAP's capture-safety rule).
``dtype_discipline`` accumulation stays fp32: no leaf-sized reduction or
                     matmul producing half precision, no more leaf-sized
                     fp32->half casts than half-precision outputs (a
                     mid-chain round trip), and TF32 off at every matmul
                     and convolution of the call.
``pallas_budget``    each kernel region's dynamic shared memory at the
                     entry's shapes, from the kernels' own size functions,
                     against ``SMEM_LIMIT``: a note under it, a finding
                     over it; on the card ``SMEM_LIMIT`` against the
                     card's opt-in limit a block.
``fusion_count``     the kernel launches of one call (on the card the
                     launch counters, ``kernels/launches.py``; on the CPU
                     the kernel regions) equal the entry's expected
                     launches; the unfused aten bytes
                     (``CostCounter.bytes``) in multiples of the payload
                     are a note.
``collective_lint``  per-entry byte allowlists over ``CostCounter``'s
                     collective bytes by kind (e.g. ``aggregate_sharded``
                     may all-reduce (C,) partials but never all-to-all).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.analysis import traversal as tv
from repro_torch.analysis.report import SEV_ERROR, EntryResult, Finding

# ops whose output dtype is the accumulator's
ACCUMULATORS = {"sum", "mean", "nansum", "cumsum", "var", "std", "norm",
                "linalg_vector_norm", "prod", "einsum"} \
    | tv.MATMULS | tv.CONVS


@dataclasses.dataclass
class Rule:
    name: str
    fn: Callable


RULES: Dict[str, Rule] = {}


def register_rule(name: str):
    """Register an invariant rule. The decorated fn takes a RuleContext
    and appends findings/notes to it.  (The reference's ``kind`` told jaxpr
    rules from HLO ones; here every rule reads the same op log.)"""
    def deco(fn):
        RULES[name] = Rule(name, fn)
        return fn
    return deco


@dataclasses.dataclass
class RuleContext:
    """One entry point under analysis, as seen by the rules."""
    entry_name: str
    log: tv.OpLog                           # the call's ops and regions
    result: EntryResult
    device: torch.device = torch.device("cpu")
    # entry expectations (set by the entry-point registry):
    copy_mode: str = "off"                  # "strict" | "engine" | "off"
    copy_threshold: int = 0                 # op output size that counts
    collective_allowlist: Optional[Dict[str, int]] = None
    donate_must_alias: tuple = ()           # (path, storage before, storage
                                            # after) of each carried buffer
    check_rng_advance: bool = False
    carry_generators: tuple = ()            # (label, generator, state
                                            # before, state after)
    rules_off: tuple = ()                   # rule names disabled per entry
    expected_launches: Optional[Dict[str, int]] = None   # fusion_count
    launched: Optional[Dict[str, int]] = None   # the card's counters
    hbm_payload_bytes: int = 0              # one pass worth of bytes
    n_half_out: int = 0                     # half-precision outputs
    capture: Optional[Callable[[], None]] = None   # the card's capture

    def finding(self, rule, message, op=None, severity=SEV_ERROR):
        self.result.findings.append(Finding(
            rule=rule, entry=self.entry_name, message=message,
            severity=severity,
            provenance=op.provenance if op is not None else "?",
            primitive=op.name if op is not None else None,
            shape=str(op.out) if op is not None and op.out else None))

    def note(self, message):
        self.result.notes.append(message)


# --------------------------------------------------------------------- #
# 1. copy lint                                                          #
# --------------------------------------------------------------------- #

@register_rule("copy_lint")
def copy_lint(ctx: RuleContext) -> None:
    """No leaf-sized flatten materialization on the aggregation path.

    strict (kernels): any ``cat`` / ``stack`` or ``copy_`` with output >=
    threshold fires: the leaf-streaming engines must never rebuild a (C,
    N) flat matrix.  engine (round engines): only a concatenation off the
    leading axis fires (a flatten glues leaves along a minor axis); the
    async delivery buffer's leading-axis row concatenation and the rounds'
    writes into their own buffers are legitimate.  Both modes flag a
    leaf-sized ``clone`` of a permuted layout (``contiguous`` after a
    transpose): a relayout copy.  Ops inside kernel regions are not seen.
    """
    if ctx.copy_mode == "off":
        return
    for op in ctx.log.ops:
        out = op.out
        if out is None or out.numel < ctx.copy_threshold:
            continue
        if op.name in ("cat", "stack") and (ctx.copy_mode == "strict"
                                            or op.dim != 0):
            ctx.finding(
                "copy_lint",
                f"leaf-sized {op.name} (axis {op.dim} of "
                f"{len(out.shape)}d, {out.numel} elems >= "
                f"{ctx.copy_threshold}): flatten materialization on the "
                "aggregation path", op)
        elif op.name == "copy_" and ctx.copy_mode == "strict":
            ctx.finding(
                "copy_lint",
                f"leaf-sized copy_ into a buffer ({out.numel} elems >= "
                f"{ctx.copy_threshold}): the tree is flattened by copies",
                op)
        elif op.name == "clone" and op.ins and op.ins[0].permuted:
            ctx.finding(
                "copy_lint",
                f"leaf-sized clone of a permuted layout ({out.numel} "
                "elems): forces a relayout copy", op)


# --------------------------------------------------------------------- #
# 2. RNG discipline                                                     #
# --------------------------------------------------------------------- #

def _draws(log):
    return [op for op in log.ops if op.random]


@register_rule("rng_discipline")
def rng_discipline(ctx: RuleContext) -> None:
    """Every random op draws from an explicit ``torch.Generator``, and no
    generator state is drawn from twice.  A draw from the global default
    generator is outside the entry's carry (a replayed graph does not
    advance it, and parity with the reference's fed draws breaks); two
    draws from one state (the generator's state set back in between, or
    two generators seeded alike) are two correlated streams, the bug class
    that breaks the scan == python bit-parity contract."""
    seen = {}
    for op in _draws(ctx.log):
        if not op.explicit:
            ctx.finding(
                "rng_discipline",
                f"{op.name} draws from the global default generator: every "
                "draw takes the entry's explicit torch.Generator", op)
            continue
        first = seen.setdefault(op.gen_state, op)
        if first is not op:
            ctx.finding(
                "rng_discipline",
                f"generator state drawn from twice ({first.name} @ "
                f"{first.provenance}, then {op.name}): the state was "
                "restored in between, so the two draws repeat their bits",
                op)


@register_rule("rng_advance")
def rng_advance(ctx: RuleContext) -> None:
    """A carried generator the call drew from must come back advanced: if
    its state after the call equals its state before, the next call
    replays identical random bits.  The call drew from it if a draw
    started from its state before the call.  A carried generator the call
    did not draw from has spent nothing and is noted, not flagged."""
    if not ctx.check_rng_advance:
        return
    starts = {op.gen_state for op in _draws(ctx.log) if op.explicit}
    for label, _gen, before, after in ctx.carry_generators:
        if before not in starts and before != after:
            continue                    # advanced outside a logged draw
        if before not in starts:
            ctx.note(f"rng_advance: carried generator {label} not drawn "
                     "from in this call")
        elif before == after:
            ctx.finding(
                "rng_advance",
                f"carried generator {label} returned unadvanced (drawn "
                "from, state after the call == state before): the next "
                "call replays identical random bits")


# --------------------------------------------------------------------- #
# 3. donation audit                                                     #
# --------------------------------------------------------------------- #

@register_rule("donation_audit")
def donation_audit(ctx: RuleContext) -> None:
    """Carried buffers are written in place.  The port's counterpart of
    ``donate_argnums`` is the replayed graph's static state: ``ScanDriver``
    and the serving engine copy each step's new state into it
    (``core/driver.copy_into``), and a body may update a buffer in place.
    Either way a carried buffer's storage after the call must be its
    storage before; a state rebuilt out of place is a fresh allocation
    every step, which a replayed graph cannot carry.  The entry names
    WHICH buffers (the heavy carry: params, optimizer state, EF residuals,
    delivery rows, KV pools).  On the card the entry is also captured once
    as a CUDA graph after an eager warm-up; a capture that raises is a
    finding (reading the host, pageable copies, unregistered generators,
    a buffer first made during capture)."""
    if not ctx.donate_must_alias:
        return
    missing = [path for path, before, after in ctx.donate_must_alias
               if before != after]
    if missing:
        ctx.finding(
            "donation_audit",
            f"carried buffers NOT written in place: {missing} (carry path) "
            "- the state is rebuilt out of place and a replayed graph "
            "cannot carry it")
    if ctx.capture is not None:
        try:
            ctx.capture()
        except Exception as e:              # the finding is the result
            ctx.finding(
                "donation_audit",
                f"capture as a CUDA graph failed: {type(e).__name__}: {e}")
        else:
            ctx.note("donation_audit: captured once as a CUDA graph after "
                     "an eager warm-up, and replayed")


# --------------------------------------------------------------------- #
# 4. dtype discipline                                                   #
# --------------------------------------------------------------------- #

@register_rule("dtype_discipline")
def dtype_discipline(ctx: RuleContext) -> None:
    """Accumulation chains stay fp32, one cast per leaf at the write.
    (a) any leaf-sized reduction or matmul producing a half dtype is a
    half-precision accumulation; (b) more leaf-sized fp32->half casts than
    half-precision outputs means per-slice round-trip casts inside the
    chain; (c) TF32 on at a matmul or convolution of the call (either
    ``torch.backends.cuda.matmul.allow_tf32`` or
    ``torch.backends.cudnn.allow_tf32``) drops fp32 products to 10-bit
    mantissas, which the port's parity with the reference forbids."""
    threshold = max(ctx.copy_threshold, 1)
    half_casts = []
    tf32 = None
    for op in ctx.log.ops:
        out = op.out
        if op.tf32 and tf32 is None:
            tf32 = op
        if out is None or out.numel < threshold:
            continue
        if op.name in ACCUMULATORS and out.dtype in tv.HALF:
            ctx.finding(
                "dtype_discipline",
                f"half-precision accumulation: {op.name} -> {out} "
                "(accumulate fp32, cast at the write)", op)
        elif (op.name in ("_to_copy", "copy_") and out.dtype in tv.HALF
              and op.ins[-1].dtype == torch.float32):
            half_casts.append(op)
    if len(half_casts) > ctx.n_half_out:
        ctx.finding(
            "dtype_discipline",
            f"{len(half_casts)} leaf-sized fp32->half casts for "
            f"{ctx.n_half_out} half-precision outputs: more than one cast "
            "per leaf means mid-chain precision round-trips",
            half_casts[-1])
    if tf32 is not None:
        ctx.finding(
            "dtype_discipline",
            f"TF32 on at {tf32.name} (torch.backends.cuda.matmul."
            "allow_tf32 / cudnn.allow_tf32): fp32 matmuls and convolutions "
            "must run in full fp32", tf32)


# --------------------------------------------------------------------- #
# 5. shared-memory budget                                               #
# --------------------------------------------------------------------- #

@register_rule("pallas_budget")
def pallas_budget(ctx: RuleContext) -> None:
    """Each kernel region's dynamic shared memory a block at the entry's
    shapes (``robust_pipeline.pass1_smem_bytes`` / ``combine_smem_bytes``,
    ``paged_decode.smem_bytes``, ``flash_attention.smem_bytes``,
    ``population_select.smem_bytes``, the twin of ``lib.ps_topd_smem``)
    against ``SMEM_LIMIT``, the most a Hopper block may opt into: a note
    under it, a finding over it.  On the card ``SMEM_LIMIT`` is held to the
    card's own opt-in limit, and K7's figure to ``lib.ps_topd_smem``."""
    from repro_torch.kernels import robust_pipeline as rp
    seen = set()
    for r in ctx.log.regions:
        shapes = tuple((k, str(v)) for k, v in sorted(r.args.items()))
        if (r.launch, shapes) in seen:
            continue
        seen.add((r.launch, shapes))
        where = ", ".join(f"{k}={v}" for k, v in shapes)
        if r.smem is None:
            ctx.note(f"kernel {r.launch} ({where}): {r.smem_note}")
            continue
        ctx.note(f"kernel {r.launch} ({where}): shared memory {r.smem} B "
                 f"a block of {rp.SMEM_LIMIT} B ({r.smem_note})")
        if r.smem > rp.SMEM_LIMIT:
            ctx.finding(
                "pallas_budget",
                f"kernel {r.launch} ({where}) needs {r.smem} B of shared "
                f"memory a block, past SMEM_LIMIT = {rp.SMEM_LIMIT} B: "
                "shrink its tile or split its rows")
        if ctx.device.type == "cuda" and r.launch == "block_topd":
            _topd_on_card(ctx, r)
    if ctx.device.type == "cuda":
        optin = torch.cuda.get_device_properties(
            ctx.device).shared_memory_per_block_optin
        ctx.note(f"card: shared_memory_per_block_optin {optin} B, "
                 f"SMEM_LIMIT {rp.SMEM_LIMIT} B")
        if rp.SMEM_LIMIT > optin:
            ctx.finding(
                "pallas_budget",
                f"SMEM_LIMIT = {rp.SMEM_LIMIT} B exceeds this card's opt-in "
                f"limit of {optin} B a block")


def _topd_on_card(ctx, r):
    """K7's Python size function against the built library's own."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import population_select as ps
    d = int(r.scalars["d"])
    blk = max(int(r.scalars["blk"]), d)
    lib = _build.load().ps_topd_smem(blk, d)
    if lib != ps.smem_bytes(blk, d):
        ctx.finding("pallas_budget",
                    f"K7 at blk={blk}, d={d}: lib.ps_topd_smem {lib} B, "
                    f"population_select.smem_bytes {ps.smem_bytes(blk, d)} B")


# --------------------------------------------------------------------- #
# 6. fusion count                                                       #
# --------------------------------------------------------------------- #

@register_rule("fusion_count")
def fusion_count(ctx: RuleContext) -> None:
    """The aggregation path launches the kernels it is built from, and
    only those: the launches of one call, by launch counter (on the card
    the counters of ``kernels/launches.py``, on the CPU the kernel regions
    the call entered), must equal the entry's expected launches.  A path
    that falls off its kernels, or one that launches a kernel twice,
    breaks it.  The unfused aten bytes of the call (``CostCounter.bytes``,
    the kernel regions counted by their arguments and results) in
    multiples of the payload are a note: they are not XLA's fused count,
    and nothing gates on them."""
    if ctx.expected_launches is None:
        return
    got = ctx.launched if ctx.launched is not None else ctx.log.launches()
    got = {k: n for k, n in got.items() if n}
    want = {k: n for k, n in ctx.expected_launches.items() if n}
    how = "on the card" if ctx.launched is not None else "kernel regions"
    ctx.note(f"launches ({how}): "
             + (", ".join(f"{k}={n}" for k, n in sorted(got.items()))
                or "none"))
    if got != want:
        ctx.finding(
            "fusion_count",
            f"kernel launches {got} ({how}), expected {want}: the path "
            "left its fused kernels or launched one more than once")
    if ctx.hbm_payload_bytes:
        ctx.note(f"aten bytes: {ctx.log.bytes / ctx.hbm_payload_bytes:.2f}x "
                 f"payload ({ctx.log.bytes} B unfused, payload "
                 f"{ctx.hbm_payload_bytes} B)")


# --------------------------------------------------------------------- #
# 7. collective lint                                                    #
# --------------------------------------------------------------------- #

@register_rule("collective_lint")
def collective_lint(ctx: RuleContext) -> None:
    """Per-entry collective allowlist over ``CostCounter``'s collective
    bytes on this rank: each kind's total must stay under the entry's
    declared cap; kinds absent from the allowlist are forbidden outright
    (``aggregate_sharded`` may all-reduce (C,) partials but must never
    all-to-all or all-gather a param-sized operand)."""
    if ctx.collective_allowlist is None:
        return
    totals = {k: n for k, n in ctx.log.collectives.items() if n}
    for kind, total in sorted(totals.items()):
        cap = ctx.collective_allowlist.get(kind)
        if cap is None:
            ctx.finding(
                "collective_lint",
                f"forbidden collective {kind} ({total} bytes/rank): not in "
                f"this entry's allowlist {sorted(ctx.collective_allowlist)}")
        elif total > cap:
            ctx.finding(
                "collective_lint",
                f"{kind} moves {total} bytes/rank, allowlist caps it at "
                f"{cap}: a param-sized operand is crossing the interconnect")
    if totals:
        ctx.note("collectives/rank: " + ", ".join(
            f"{k}={v}B" for k, v in sorted(totals.items())))


def run_rules(ctx: RuleContext) -> EntryResult:
    """Run every registered rule (minus the entry's rules_off) over one
    context."""
    for rule in RULES.values():
        if rule.name in ctx.rules_off:
            continue
        rule.fn(ctx)
    if ctx.result.findings:
        ctx.result.status = "findings"
    return ctx.result
