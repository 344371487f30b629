"""Both directions of every rule of the port's static analysis
(``repro_torch.analysis``): each rule is silent on a clean program and
fires on a violating twin, the twins mirroring tests/test_analysis.py's.
The programs run once on the CPU under ``traversal.OpLog``; the entries
themselves are audited in tests/test_torch_analysis_entries.py."""
import pytest
import torch

from repro_torch import tree
from repro_torch.analysis import entrypoints as ep
from repro_torch.analysis import lint
from repro_torch.analysis.report import EntryResult, Finding, Report
from repro_torch.analysis.rules import RULES, run_rules
from repro_torch.kernels import robust_pipeline as rp

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ctx(fn, args, **kw):
    return lint.run_target("fixture", ep.Target(fn, args, **kw), CPU)


def _findings(ctx, rule):
    RULES[rule].fn(ctx)
    return [f for f in ctx.result.findings if f.rule == rule]


def _tree(c=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(c, 8, generator=g),
            "b": torch.randn(c, 16, generator=g)}


# --------------------------------------------------------------------- #
# the op log                                                            #
# --------------------------------------------------------------------- #

def test_oplog_records_ops_with_provenance():
    ctx = _ctx(lambda x: torch.cat([x, x]), (torch.ones(4),))
    op = next(o for o in ctx.log.ops if o.name == "cat")
    assert "test_torch_analysis.py:" in op.provenance
    assert op.dim == 0 and op.out.shape == (8,)
    from repro_torch.core import aggregation
    ctx = _ctx(aggregation.normalize_weights, (torch.ones(4), torch.ones(4)))
    assert all(o.provenance.startswith("repro_torch/core/aggregation.py:")
               for o in ctx.log.ops)


def test_kernel_call_is_one_opaque_region():
    """On the CPU the plain version's own ops (its chunked writes, its
    ranks) never reach the log: ``rp.gated_combine``'s trimmed mode at the
    ``aggregate`` entry's shapes is one region, and a strict copy lint with
    a threshold of one element sees nothing of it, where the same plain
    version called bare writes its output by copies."""
    x = torch.randn(1, 8, 91, generator=torch.Generator().manual_seed(1))
    m = torch.ones(1, 8)
    m[0, 2] = 0.0
    ctx = _ctx(lambda a, b: rp.gated_combine(a, b, b, mode="trimmed"),
               (x, m), copy_mode="strict", copy_threshold=1)
    assert not _findings(ctx, "copy_lint")
    assert [(r.launch, r.args["x"].shape) for r in ctx.log.regions] == \
        [("gated_combine[trimmed]", (1, 8, 91))]
    assert ctx.log.launches() == {"gated_combine[trimmed]": 1}
    assert not ctx.log.ops
    bare = _ctx(lambda a, b: rp.gated_combine_plain(a, b, b, mode="trimmed"),
                (x, m), copy_mode="strict", copy_threshold=1)
    assert _findings(bare, "copy_lint") and not bare.log.regions
    # the region's bytes: its arguments read once, its result written once
    assert ctx.log.bytes == (x.numel() + 2 * m.numel() + 91) * 4


# --------------------------------------------------------------------- #
# copy lint                                                             #
# --------------------------------------------------------------------- #

def test_copy_lint_strict_fires_on_flatten_cat():
    def flatten(t):
        return torch.cat([l.reshape(-1) for l in t.values()])

    ctx = _ctx(flatten, (_tree(),), copy_mode="strict", copy_threshold=16)
    f = _findings(ctx, "copy_lint")
    assert f and "cat" in f[0].message and f[0].primitive == "cat"
    assert "test_torch_analysis.py" in f[0].provenance


def test_copy_lint_strict_fires_on_flatten_by_copies():
    def into_buffer(t):
        buf = torch.empty(4, 24)
        buf[:, :8].copy_(t["a"])
        buf[:, 8:].copy_(t["b"])
        return buf

    ctx = _ctx(into_buffer, (_tree(),), copy_mode="strict",
               copy_threshold=32)
    f = _findings(ctx, "copy_lint")
    assert f and "copy_" in f[0].message
    # the same writes are the engines' design: legal under engine
    ctx = _ctx(into_buffer, (_tree(),), copy_mode="engine",
               copy_threshold=32)
    assert not _findings(ctx, "copy_lint")


def test_copy_lint_strict_silent_on_leaf_streaming():
    def stream(t, w):
        return {k: torch.einsum("c,c...->...", w, v) for k, v in t.items()}

    ctx = _ctx(stream, (_tree(), torch.ones(4)), copy_mode="strict",
               copy_threshold=8)
    assert not _findings(ctx, "copy_lint")


def test_copy_lint_engine_allows_leading_axis_row_concat():
    # the async delivery buffer's (rows, ...) stacking is legitimate
    ctx = _ctx(lambda rows, stack: torch.cat([rows, stack], 0),
               (torch.ones(3, 64), torch.ones(2, 64)), copy_mode="engine",
               copy_threshold=64)
    assert not _findings(ctx, "copy_lint")
    ctx = _ctx(lambda a, b: torch.stack([a, b]),
               (torch.ones(3, 64), torch.ones(3, 64)), copy_mode="engine",
               copy_threshold=64)
    assert not _findings(ctx, "copy_lint")


def test_copy_lint_engine_fires_on_minor_axis_concat():
    ctx = _ctx(lambda a, b: torch.cat([a, b], -1),
               (torch.ones(3, 64), torch.ones(3, 64)), copy_mode="engine",
               copy_threshold=64)
    f = _findings(ctx, "copy_lint")
    assert f and "axis 1 of 2d" in f[0].message


def test_copy_lint_flags_relayout_copies_both_modes():
    for mode in ("strict", "engine"):
        for relayout in (lambda x: x.t().reshape(-1),
                         lambda x: x.t().contiguous()):
            ctx = _ctx(relayout, (torch.ones(16, 32),), copy_mode=mode,
                       copy_threshold=512)
            f = _findings(ctx, "copy_lint")
            assert f and "relayout" in f[0].message
    # a plain reshape is a free view; a column block made contiguous is a
    # gather of rows, not a relayout
    for fn in (lambda x: x.reshape(-1), lambda x: x[:, :16].contiguous()):
        ctx = _ctx(fn, (torch.ones(16, 32),), copy_mode="strict",
                   copy_threshold=256)
        assert not _findings(ctx, "copy_lint")


def test_copy_lint_off_is_silent():
    ctx = _ctx(lambda t: torch.cat(list(t.values()), 1), (_tree(),))
    assert not _findings(ctx, "copy_lint")


# --------------------------------------------------------------------- #
# rng discipline and advance                                            #
# --------------------------------------------------------------------- #

def test_rng_discipline_fires_on_the_global_generator():
    ctx = _ctx(lambda x: x + torch.rand(4), (torch.ones(4),))
    f = _findings(ctx, "rng_discipline")
    assert f and "global default generator" in f[0].message


def test_rng_discipline_fires_on_a_reused_state():
    def reuse(g):
        s = g.get_state()
        a = torch.randn(4, generator=g)
        g.set_state(s)
        return a + torch.rand(4, generator=g)

    ctx = _ctx(reuse, (torch.Generator().manual_seed(0),))
    f = _findings(ctx, "rng_discipline")
    assert f and "drawn from twice" in f[0].message


def test_rng_discipline_silent_on_a_stream_of_draws():
    def clean(g, h):
        return (torch.randn(4, generator=g) + torch.rand(4, generator=g)
                + torch.randint(0, 5, (4,), generator=h))

    ctx = _ctx(clean, (torch.Generator().manual_seed(0),
                       torch.Generator().manual_seed(1)))
    assert not _findings(ctx, "rng_discipline")
    # two generators seeded alike draw the same bits: a reuse too
    ctx = _ctx(clean, (torch.Generator().manual_seed(0),
                       torch.Generator().manual_seed(0)))
    assert _findings(ctx, "rng_discipline")


def test_rng_advance_fires_on_an_unadvanced_carry():
    def stale(g, x):
        s = g.get_state()
        y = x * torch.rand(4, generator=g)
        g.set_state(s)
        return g, y

    ctx = _ctx(stale, (torch.Generator().manual_seed(0), torch.ones(4)),
               check_rng_advance=True)
    f = _findings(ctx, "rng_advance")
    assert f and "unadvanced" in f[0].message


def test_rng_advance_silent_on_an_advanced_or_unused_carry():
    def fresh(g, x):
        return g, x * torch.rand(4, generator=g)

    ctx = _ctx(fresh, (torch.Generator().manual_seed(0), torch.ones(4)),
               check_rng_advance=True)
    assert not _findings(ctx, "rng_advance")
    ctx = _ctx(lambda g, x: (g, x * 2.0),
               (torch.Generator().manual_seed(0), torch.ones(4)),
               check_rng_advance=True)
    assert not _findings(ctx, "rng_advance")
    assert any("not drawn from" in n for n in ctx.result.notes)


# --------------------------------------------------------------------- #
# donation audit                                                        #
# --------------------------------------------------------------------- #

def _state():
    return {"params": {"w": torch.ones(8, 4)}, "step": torch.zeros(())}


def test_donation_audit_fires_on_a_state_rebuilt_out_of_place():
    def rebuilt(st):
        return {"params": {"w": st["params"]["w"] + 1.0},
                "step": st["step"] + 1}, {}

    st = _state()
    ctx = _ctx(rebuilt, (st,), carry={0: 0},
               donate_must_alias=ep._must_alias(0, st, ("['params']",)))
    f = _findings(ctx, "donation_audit")
    assert f and "['params']['w']" in f[0].message


def test_donation_audit_silent_on_a_state_written_in_place():
    def body(st):
        return {"params": {"w": st["params"]["w"] + 1.0},
                "step": st["step"] + 1}, {}

    st = _state()
    ctx = _ctx(ep._committed(body), (st,), carry={0: 0},
               donate_must_alias=ep._must_alias(0, st, ("['params']",)))
    assert not _findings(ctx, "donation_audit")
    assert torch.equal(st["params"]["w"], torch.full((8, 4), 2.0))


# --------------------------------------------------------------------- #
# dtype discipline                                                      #
# --------------------------------------------------------------------- #

def test_dtype_discipline_fires_on_half_accumulation():
    ctx = _ctx(lambda a, b: a @ b, (torch.ones(8, 64, dtype=torch.bfloat16),
                                    torch.ones(64, 256,
                                               dtype=torch.bfloat16)),
               copy_threshold=2048)
    f = _findings(ctx, "dtype_discipline")
    assert f and "half-precision accumulation" in f[0].message
    ctx = _ctx(lambda x: x.sum(0), (torch.ones(8, 256,
                                               dtype=torch.float16),),
               copy_threshold=256)
    assert _findings(ctx, "dtype_discipline")


def test_dtype_discipline_silent_on_fp32_accum_single_cast():
    ctx = _ctx(lambda x: x.sum(0).to(torch.bfloat16),
               (torch.ones(8, 256),), copy_threshold=256)
    assert not _findings(ctx, "dtype_discipline")


def test_dtype_discipline_fires_on_midchain_round_trips():
    def chatty(x):
        y = x.to(torch.bfloat16)                         # cast 1
        return (y.float() * 2.0).to(torch.bfloat16)      # cast 2

    ctx = _ctx(chatty, (torch.ones(512),), copy_threshold=512)
    f = _findings(ctx, "dtype_discipline")
    assert f and "round-trips" in f[0].message


def test_dtype_discipline_fires_on_tf32():
    fn, args = (lambda a, b: a @ b), (torch.ones(8, 8), torch.ones(8, 8))
    assert not _findings(_ctx(fn, args), "dtype_discipline")
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        f = _findings(_ctx(fn, args), "dtype_discipline")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert f and "TF32" in f[0].message and f[0].primitive == "mm"


# --------------------------------------------------------------------- #
# shared-memory budget                                                  #
# --------------------------------------------------------------------- #

def test_pallas_budget_notes_each_kernel_under_the_limit():
    x = torch.randn(1, 8, 91)
    ctx = _ctx(lambda a, m: rp.cosine_gate_partials(a, m),
               (x, torch.ones(1, 8)))
    assert not _findings(ctx, "pallas_budget")
    want = rp.pass1_smem_bytes(8, 91)
    assert any(f"shared memory {want} B" in n for n in ctx.result.notes)


def test_pallas_budget_fires_past_smem_limit():
    """Past about 450 rows the pass-1 and rank tiles outgrow a block's
    shared memory; the kernels raise there on the card, and the rule finds
    it on the CPU from the size functions."""
    c, n = 500, 8
    assert rp.pass1_smem_bytes(c, n) > rp.SMEM_LIMIT
    assert rp.combine_smem_bytes(c, n, "trimmed") > rp.SMEM_LIMIT
    assert rp.combine_smem_bytes(c, n, "mean") == 0
    x = torch.randn(1, c, n, generator=torch.Generator().manual_seed(2))
    m = torch.ones(1, c)
    ctx = _ctx(lambda a, mm: rp.gated_combine(a, mm, mm, mode="trimmed"),
               (x, m))
    f = _findings(ctx, "pallas_budget")
    assert f and "past SMEM_LIMIT" in f[0].message
    from repro_torch.kernels import population_select as ps
    assert ps.smem_bytes(16384, 16384) <= rp.SMEM_LIMIT \
        < ps.smem_bytes(16385, 16385)


# --------------------------------------------------------------------- #
# fusion count                                                          #
# --------------------------------------------------------------------- #

def _agg(fused, times=1):
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import aggregation
    cfg = FedConfig(n_clients=4, aggregator="trimmed_mean", fused_agg=fused)

    def fn(u, w, m):
        for _ in range(times):
            out = aggregation.aggregate(u, w, m, cfg)
        return out

    return fn, ({"w": torch.randn(4, 64)}, torch.ones(4), torch.ones(4))


def test_fusion_count_silent_on_the_fused_path():
    fn, args = _agg(True)
    ctx = _ctx(fn, args, expected_launches=ep._ONE_TRIMMED,
               hbm_payload_bytes=4 * 64 * 4)
    assert not _findings(ctx, "fusion_count")
    assert any("aten bytes" in n for n in ctx.result.notes)


def test_fusion_count_fires_off_the_kernels_or_on_a_second_launch():
    for fn, args in (_agg(False), _agg(True, times=2)):
        ctx = _ctx(fn, args, expected_launches=ep._ONE_TRIMMED)
        f = _findings(ctx, "fusion_count")
        assert f and "expected" in f[0].message


def test_fusion_count_noop_without_expectation():
    fn, args = _agg(False)
    assert not _findings(_ctx(fn, args), "fusion_count")


# --------------------------------------------------------------------- #
# collective lint (fake process group)                                  #
# --------------------------------------------------------------------- #

def _sharded(body):
    """``aggregate_sharded`` at this rank of the group: its body alone on
    the column layout (``body``), or the whole call on this rank's clients'
    rows, whose reshard is one all_to_all (the open fault of ROADMAP §3)."""
    import torch.distributed as dist
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import aggregation
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import collectives, specs
    cfg = FedConfig(n_clients=8, aggregator="trimmed_mean")
    mesh = Mesh(("data",), (dist.get_world_size(),), None, dist.get_rank())
    w = mesh.size
    t = {"w": torch.randn(8, 64, 8), "r": torch.randn(8, 301)}
    if not body:
        rows = {k: v[mesh.rank * 8 // w:(mesh.rank + 1) * 8 // w]
                for k, v in t.items()}
        return (lambda u, ww, m: aggregation.aggregate_sharded(
            u, ww, m, cfg, mesh, axes=("data",)),
            (rows, torch.ones(8), torch.ones(8)))
    like = {k: v[0] for k, v in t.items()}
    sizes = [l.numel() for l in tree.leaves(like)]
    _, flags = specs.client_flat_specs(sizes, mesh, ("data",))
    cols = collectives.ColumnShards(sizes, flags, mesh)
    xs = [l.reshape(8, -1) for l in tree.leaves(t)]
    sh = torch.cat([x.chunk(w, 1)[mesh.rank]
                    for x, f in zip(xs, flags) if f], 1)
    rep = torch.cat([x for x, f in zip(xs, flags) if not f], 1)
    return (lambda s, r, ww, m: aggregation.aggregate_columns(
        s, r, cols, ww, m, cfg, like),
        (sh, rep, torch.ones(8), torch.ones(8)))


def _allowlist():
    """``aggregate_sharded``'s caps at this tree's payload."""
    payload = 8 * (512 + 301) * 4
    return {"all-reduce": 16 * 1024, "all-gather": payload,
            "reduce-scatter": payload, "collective-permute": payload}


def test_collective_lint_fires_on_an_all_to_all_and_over_its_cap():
    from repro_torch.launch.mesh import fake_group
    with fake_group(2):
        # rows of this rank's clients only: resharded by an all_to_all
        fn, args = _sharded(body=False)
        ctx = _ctx(fn, args, collective_allowlist=_allowlist())
        f = _findings(ctx, "collective_lint")
        assert any("forbidden collective all-to-all" in x.message
                   for x in f)
        # the whole payload gathered: past the all-gather cap

        def gather_all(u):
            import torch.distributed as dist
            x = torch.cat([l.reshape(8, -1) for l in u.values()], 1)
            out = x.new_empty(2 * x.shape[0], x.shape[1])
            dist.all_gather_into_tensor(out, x.contiguous())
            return out

        ctx = _ctx(gather_all, ({"w": torch.randn(8, 64, 8),
                                 "r": torch.randn(8, 301)},),
                   collective_allowlist=_allowlist())
        f = _findings(ctx, "collective_lint")
        assert f and "allowlist caps it" in f[0].message


def test_collective_lint_silent_under_its_caps():
    from repro_torch.launch.mesh import fake_group
    with fake_group(2):
        fn, args = _sharded(body=True)
        ctx = _ctx(fn, args, collective_allowlist=_allowlist())
        assert not _findings(ctx, "collective_lint")
        assert ctx.log.collectives["all-to-all"] == 0
        assert 0 < ctx.log.collectives["all-reduce"] <= 16 * 1024
    # no collective at all: {} forbids every kind, None turns the rule off
    ctx = _ctx(lambda x: x + 1, (torch.ones(4),), collective_allowlist={})
    assert not _findings(ctx, "collective_lint")


# --------------------------------------------------------------------- #
# report                                                                #
# --------------------------------------------------------------------- #

def test_report_schema_equals_the_reference():
    from repro.analysis import report as ref

    def build(mod):
        r = mod.Report(meta={"rules": ["copy_lint"]})
        res = mod.EntryResult(entry="aggregate")
        res.findings.append(mod.Finding(
            rule="copy_lint", entry="aggregate", message="m",
            provenance="x.py:1 (f)", primitive="cat", shape="f32[8]"))
        res.findings.append(mod.Finding(rule="pallas_budget",
                                        entry="aggregate", message="n",
                                        severity=mod.SEV_NOTE))
        res.notes.append("note")
        res.status = "findings"
        r.add(res)
        r.add(mod.EntryResult(entry="aggregate_sharded", status="skipped",
                              skipped_reason="why"))
        return r

    port = build(__import__("repro_torch.analysis.report",
                            fromlist=["Report"]))
    assert port.to_dict() == build(ref).to_dict()
    assert port.to_json() == build(ref).to_json()
    assert len(port.errors()) == 1 and str(port.findings[0]).startswith(
        "[error] aggregate :: copy_lint")


def test_run_rules_sets_findings_status():
    res = EntryResult(entry="fixture")
    ctx = lint.run_target(
        "fixture", ep.Target(lambda a, b: torch.cat([a, b], 1),
                             (torch.ones(3, 64), torch.ones(3, 64)),
                             copy_mode="engine", copy_threshold=64), CPU,
        res)
    assert run_rules(ctx).status == "findings"
    rep = Report()
    rep.add(res)
    assert rep.errors() and isinstance(rep.errors()[0], Finding)
