"""The port's linter over its registered entry points on the CPU
(``python -m repro_torch.analysis.lint --device cpu``): every entry clean,
the CLI's contract, the reference's entry names and argument shapes, and
``aggregate_sharded``'s collectives within the reference's caps."""
import contextlib
import json

import pytest
import torch

from repro_torch import tree
from repro_torch.analysis import entrypoints as ep
from repro_torch.analysis import lint
from repro_torch.analysis.rules import RULES

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cli_report(tmp_path_factory):
    path = tmp_path_factory.mktemp("lint") / "r.json"
    rc = lint.main(["--all", "--device", "cpu", "--json", str(path)])
    with open(path) as f:
        return rc, json.load(f)


def test_lint_all_on_the_cpu_is_clean(cli_report, capsys):
    rc, rep = cli_report
    assert rc == 0
    s = rep["summary"]
    assert (s["entries"], s["skipped"], s["errors"]) == (14, 0, 0)
    assert [r["entry"] for r in rep["results"]] == list(ep.ENTRYPOINTS)
    # every rule ran and stayed silent: no finding of any severity
    assert all(r["status"] == "ok" and not r["findings"]
               for r in rep["results"])
    assert rep["meta"]["rules"] == sorted(RULES) and len(RULES) == 8
    assert rep["meta"]["device"] == "cpu"


def test_no_entry_turns_a_rule_off_and_each_states_its_launches():
    from repro_torch.launch.mesh import fake_group
    names = set()
    for name, entry in ep.ENTRYPOINTS.items():
        with fake_group(2) if entry.min_devices > 1 else \
                contextlib.nullcontext():
            target = entry.build(CPU)
        assert target.rules_off == (), name
        assert target.expected_launches is not None, name
        names |= set(target.expected_launches)
    assert names == {"cosine_gate_partials", "gated_combine[trimmed]",
                     "paged_flash_decode"}


def test_list_equals_the_reference_entry_names(capsys):
    from repro.analysis import entrypoints as ref
    assert lint.main(["--list"]) == 0
    listed = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert listed == list(ref.ENTRYPOINTS) == list(ep.ENTRYPOINTS)
    assert {n: e.min_devices for n, e in ep.ENTRYPOINTS.items()} == \
        {n: e.min_devices for n, e in ref.ENTRYPOINTS.items()}


def test_cli_refuses_an_unknown_entry_and_no_selection():
    for argv in (["--entry", "no.such.entry", "--device", "cpu"],
                 ["--device", "cpu"]):
        with pytest.raises(SystemExit) as e:
            lint.main(argv)
        assert e.value.code == 2


def test_one_entry_exits_nonzero_on_a_finding(monkeypatch, capsys):
    """``--fail-on``: an entry whose expected launches are wrong fails the
    run with exit 1."""
    build = ep.ENTRYPOINTS["two_stage"].build

    def wrong(device):
        t = build(device)
        t.expected_launches = {"cosine_gate_partials": 1}
        return t

    monkeypatch.setattr(ep.ENTRYPOINTS["two_stage"], "build", wrong)
    assert lint.main(["--entry", "two_stage", "--device", "cpu"]) == 1
    assert "FAIL two_stage" in capsys.readouterr().out


# --------------------------------------------------------------------- #
# the reference's entries: the same leaf shapes and dtypes             #
# --------------------------------------------------------------------- #

def _ref_leaves(t):
    import jax
    return {jax.tree_util.keystr(p): (tuple(l.shape), str(l.dtype))
            for p, l in jax.tree_util.tree_leaves_with_path(t)
            if hasattr(l, "shape")}


def _port_leaves(t):
    return {p: (tuple(l.shape), str(l.dtype).replace("torch.", ""))
            for p, l in ep.paths(t) if isinstance(l, torch.Tensor)}


# leaves the port holds otherwise: the reference's PRNG key is a
# torch.Generator; the async delivery buffer is one (C + B + 1, N) fp32
# matrix whose (B, N) parked rows (``buf.upd``) hold the reference's
# ``.buf.upd`` tree; a codec's EF residual is the round's (K, N) buffer;
# the eval batch is min(32, the fewest held-out rows of a client), which
# follows each package's own synthetic draw
_REF_ONLY = {".rng"}


@pytest.mark.parametrize("name", ["aggregate", "two_stage",
                                  "fedfits.make_round",
                                  "async_engine.make_async_round",
                                  "comm.codec.int8", "comm.codec.int4",
                                  "comm.codec.signsgd", "comm.codec.topk",
                                  "comm.codec.randk"])
def test_entry_args_have_the_reference_entries_leaves(name):
    from repro.analysis import entrypoints as ref
    r = ref.ENTRYPOINTS[name].build()          # built, not traced
    p = ep.ENTRYPOINTS[name].build(CPU)
    assert len(r.args) == len(p.args)
    for i, (a, b) in enumerate(zip(r.args, p.args)):
        ra, pb = _ref_leaves(a), _port_leaves(b)
        if name.startswith("comm.codec") and i > 0:
            if i == 1:                          # the (K, N) EF residual
                k = {s[0][0] for s in ra.values()}
                n = sum(int(torch.tensor(s[0][1:]).prod()) for s in
                        ra.values())
                assert set(pb.values()) == {((*k, n), "float32")}
            continue
        if name.startswith("async") and i == 0:
            upd = {k: v for k, v in ra.items() if k.startswith(".buf.upd")}
            ra = {k: v for k, v in ra.items() if k not in upd}
            b_rows = {s[0][0] for s in upd.values()}
            n = sum(int(torch.tensor(s[0][1:]).prod()) for s in
                    upd.values())
            assert tuple(b.buf.upd.shape) == (*b_rows, n)
            pb.pop(".buf.rows")
        if name == "fedfits.make_round" and i == 1:
            for key in ("['eval_x']", "['eval_y']"):
                (rs, rd), (ps, pd) = ra.pop(key), pb.pop(key)
                assert (rs[0], rs[2:], rd) == (ps[0], ps[2:], pd)
        assert set(ra) - set(pb) <= _REF_ONLY, name
        assert set(pb) <= set(ra), name
        assert {k: ra[k] for k in pb} == pb, name


# --------------------------------------------------------------------- #
# aggregate_sharded over a fake group of two ranks                      #
# --------------------------------------------------------------------- #

def test_aggregate_sharded_collectives_within_the_reference_caps():
    from repro_torch.launch.mesh import fake_group
    entry = ep.ENTRYPOINTS["aggregate_sharded"]
    with fake_group(entry.min_devices):
        target = entry.build(CPU)
        ctx = lint.run_target(entry.name, target, CPU)
    coll = ctx.log.collectives
    payload = target.collective_allowlist["all-gather"]
    assert coll["all-to-all"] == 0 and coll["reduce-scatter"] == 0
    assert 0 < coll["all-reduce"] <= 16 * 1024
    assert 0 < coll["all-gather"] <= payload
    # the (C,) partials once, and each split leaf's aggregate gathered
    assert coll["all-reduce"] == (2 * 8 + 1) * 4
    assert coll["all-gather"] == (512 + 256) * 4


def test_aggregate_sharded_is_skipped_where_a_group_exists():
    from repro_torch.launch.mesh import host_mesh
    with host_mesh(device="cpu"):
        res = lint.audit_entry(ep.ENTRYPOINTS["aggregate_sharded"], CPU)
    assert res.status == "skipped" and "process group exists" in \
        res.skipped_reason


def test_aggregate_sharded_equals_aggregate_at_one_rank():
    """At W = 1 ``aggregate_sharded``, on the tree and on the pod step's
    (C, N) buffer with ``like``, is ``aggregate`` bit for bit: its body
    streams the one matrix, ``aggregate`` the leaves side by side."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import aggregation
    from repro_torch.launch.mesh import host_mesh
    t = ep._mixed_tree(8, CPU, seed=3)
    like = tree.map(lambda l: l[0], t)
    buf = tree.flatten_rows(t).float()
    w, m = torch.rand(8, generator=torch.Generator().manual_seed(4)), \
        torch.ones(8)
    m[5] = 0.0
    for agg in ("fedavg", "trimmed_mean", "median", "krum"):
        cfg = FedConfig(n_clients=8, aggregator=agg)
        want = aggregation.aggregate(t, w, m, cfg)
        with host_mesh(device="cpu") as mesh:
            got = aggregation.aggregate_sharded(t, w, m, cfg, mesh)
            got_buf = aggregation.aggregate_sharded(buf, w, m, cfg, mesh,
                                                    like=like)
        for k in t:
            assert torch.equal(got[k], want[k]), (agg, k)
            assert torch.equal(got_buf[k], want[k]), (agg, k)
