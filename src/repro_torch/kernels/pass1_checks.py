"""Card checks of pass 1 (K1 ``cosine_gate_partials``, K4a
``cosine_gate_partials_flat`` and K6a ``dequant_gate_partials``), shared by
``tests/test_torch_cuda.py`` and phase 2 of ``chip_smoke.py``.

Each check raises ``AssertionError`` naming the case when it fails, and
returns the largest absolute error of K1 and of K6a against their plain
versions as ``{"cosine_gate_partials": e, "dequant_gate_partials": e}``.
"""
from __future__ import annotations

import numpy as np
import torch

NSUM_REL = 1e-5          # a sum over N against the largest of its plain value
QBLK = 128
PARTS = ("dots", "sqnorms", "refsq")


def unaligned(t):
    """A contiguous copy of t that starts one element past an aligned
    address, so that no vector load of its rows is aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def bitwise(name, out, ref, what):
    """Bitwise equality, NaN equal to NaN."""
    same = (out.view(torch.int32) == ref.view(torch.int32)) \
        | (out.isnan() & ref.isnan())
    if not bool(same.all()):
        raise AssertionError(f"{name}: not bitwise equal to {what}")


def close_nan(name, out, ref):
    """NaN and inf where ref has them, the rest within NSUM_REL of ref's
    largest finite magnitude; returns the largest error."""
    fin, nan = torch.isfinite(ref), torch.isnan(ref)
    if not (torch.equal(torch.isnan(out), nan)
            and torch.equal(out[~fin & ~nan], ref[~fin & ~nan])):
        raise AssertionError(f"{name}: its NaN and inf are not the plain "
                             "version's")
    if not bool(fin.any()):
        return 0.0
    err = float((out[fin] - ref[fin]).abs().max())
    if err > NSUM_REL * float(ref[fin].abs().max()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e})")
    return err


def inputs(c, n, seed, device):
    """G = 3 cohorts of (C, N) updates: one with a masked-out row and a tie
    in every column, an empty one and a lone one; their int8 record over
    three leaves whose boundaries cut a vector group."""
    from repro_torch.comm import codecs
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((3, c, n), np.float32) * 1e-2)
    if c >= 4:
        x[:, 3] = x[:, 2]
    m = torch.ones(3, c)
    if c > 2:
        m[0, 1] = 0.0
    m[1] = 0.0
    m[2] = 0.0
    m[2, c // 2] = 1.0
    x, m = x.to(device), m.to(device)
    layout = codecs.WireLayout((7_001, 5, n - 7_006), QBLK)
    enc = codecs.Codec("int8", qblk=QBLK).encode_flat(x.reshape(3 * c, n),
                                                      layout)
    return x, m, enc.q.view(3, c, n), enc.s.view(3, c, -1), layout


def family(label, x, m, q, s, layout):
    """K1 and K6a against their plain versions (NaN where those are NaN),
    K4a bitwise K1, K6a bitwise K1 on the masked decode, and a second call
    of K1 and K6a bitwise the first; returns K1's outputs and the errors."""
    from repro_torch.comm.kernels import comm_codecs as cc
    from repro_torch.kernels import robust_pipeline as rp
    k1 = rp.cosine_gate_partials(x, m)
    k6 = cc.dequant_gate_partials(q, s, layout, m)
    errs = {}
    for key, out, ref in (
            ("cosine_gate_partials", k1, rp.cosine_gate_partials_plain(x, m)),
            ("dequant_gate_partials", k6,
             cc.dequant_gate_partials_plain(q, s, layout, m))):
        errs[key] = max(close_nan(f"{key}/{part} {label}", o, r)
                        for part, o, r in zip(PARTS, out, ref))
    xm = cc.dequant_masked(q, s, layout, m)
    for part, again, flat, k6_again, k1_xm, a, b in zip(
            PARTS, rp.cosine_gate_partials(x, m),
            rp.cosine_gate_partials_flat(x, m),
            cc.dequant_gate_partials(q, s, layout, m),
            rp.cosine_gate_partials(xm, m), k1, k6):
        bitwise(f"cosine_gate_partials/{part} {label}", again, a,
                "its first call")
        bitwise(f"cosine_gate_partials_flat/{part} {label}", flat, a, "K1")
        bitwise(f"dequant_gate_partials/{part} {label}", k6_again, b,
                "its first call")
        bitwise(f"dequant_gate_partials/{part} {label}", b, k1_xm,
                "K1 on the masked decode")
    return k1, errs


def _merge(errs, more):
    for key, e in more.items():
        errs[key] = max(errs.get(key, 0.0), e)
    return errs


def edge_case(c, nmod, device):
    """Pass 1 at C rows and N = 20,000 + nmod columns (``family``): the
    empty cohort's dots and refsq exactly 0, the lone member's three sums
    equal (its median is its row), and unaligned copies of x and the codes
    giving the same bits (the plan does not follow the alignment)."""
    n = 20_000 + nmod
    x, m, q, s, layout = inputs(c, n, c + nmod, device)
    label = f"(3, {c}, {n})"
    k1, errs = family(label, x, m, q, s, layout)
    dots, sqn, refsq = k1
    if float(dots[1].abs().max()) != 0.0 \
            or float(refsq[1].abs().max()) != 0.0:
        raise AssertionError(f"cosine_gate_partials {label}: the empty "
                             "cohort's dots or refsq is not 0")
    lone = c // 2
    bitwise(f"cosine_gate_partials {label} lone dot", dots[2, lone],
            sqn[2, lone], "its sqnorm")
    bitwise(f"cosine_gate_partials {label} lone refsq", refsq[2, 0],
            sqn[2, lone], "its sqnorm")
    xu, qu = unaligned(x), unaligned(q)
    if not (xu.data_ptr() % 8 and qu.data_ptr() % 2):
        raise AssertionError("the unaligned copies are aligned")
    ku, eu = family(label + " unaligned", xu, m, qu, s, layout)
    for part, o, r in zip(PARTS, ku, k1):
        bitwise(f"cosine_gate_partials/{part} {label} unaligned", o, r,
                "the aligned call")
    return _merge(errs, eu)


def nonfinite(c, device):
    """A masked-out row of inf and a masked-in NaN.

    This holds a departure of the port from the plain versions and from
    the JAX reference (ROADMAP section 3): those pick the median by summing
    x times a 0/1 mask, so a dead row of inf (inf times 0 is NaN) turns
    every median NaN, where the kernels select the median's rows, as K2
    does, and stay finite.  So the dead row of inf is held to the kernel
    with that row zeroed: it never reaches the median (the live rows'
    partials and refsq bitwise those of the zeroed call, its own sqnorm
    inf), and in K6a its inf scales decode to 0 (held to the plain
    version).  A lone cohort whose member carries the NaN gives the plain
    version's NaNs and values; in a full cohort only the NaN's row is NaN;
    both repeatable, K6a bitwise K1 on the masked decode."""
    from repro_torch.comm.kernels import comm_codecs as cc
    from repro_torch.kernels import robust_pipeline as rp
    n = 20_003
    x, m, q, s, layout = inputs(c, n, c, device)
    label = f"(3, {c}, {n}) non-finite"
    zeroed = x.clone()
    zeroed[0, 1] = 0.0
    x[0, 1] = float("inf")
    s[0, 1] = float("inf")
    out, ref = rp.cosine_gate_partials(x, m), rp.cosine_gate_partials(zeroed, m)
    live = m[0] > 0
    for part, o, r in zip(PARTS[:2], out, ref):
        bitwise(f"cosine_gate_partials/{part} {label}", o[0, live],
                r[0, live], "the call with the dead row zeroed")
    bitwise(f"cosine_gate_partials/refsq {label}", out[2], ref[2],
            "the call with the dead row zeroed")
    if float(out[1][0, 1]) != float("inf"):
        raise AssertionError(f"cosine_gate_partials {label}: the dead row's "
                             "sqnorm is not inf")
    _, errs = family(label + ", K6a", zeroed, m, q, s, layout)
    lone = c // 2
    x[2, lone, 11] = float("nan")
    x[0, 2, 11] = float("nan")
    s[0, 2, 0] = float("nan")
    s[2, lone, 0] = float("nan")
    k1 = rp.cosine_gate_partials(x, m)
    for part, o, r in zip(PARTS, k1, rp.cosine_gate_partials_plain(x, m)):
        close_nan(f"cosine_gate_partials/{part} {label} lone", o[2], r[2])
    dots, sqn, refsq = k1
    others = live & (torch.arange(c, device=x.device) != 2)
    if not (bool(dots[0, 2].isnan()) and bool(sqn[0, 2].isnan())
            and bool(torch.isfinite(refsq[0]).all())
            and bool(torch.isfinite(dots[0, others]).all())
            and bool(torch.isfinite(sqn[0, others]).all())):
        raise AssertionError(f"cosine_gate_partials {label}: a live NaN "
                             "reached other rows than its own")
    xm = cc.dequant_masked(q, s, layout, m)
    for part, again, a, k6, k1_xm in zip(
            PARTS, rp.cosine_gate_partials(x, m), k1,
            cc.dequant_gate_partials(q, s, layout, m),
            rp.cosine_gate_partials(xm, m)):
        bitwise(f"cosine_gate_partials/{part} {label}", again, a,
                "its first call")
        bitwise(f"dequant_gate_partials/{part} {label}", k6, k1_xm,
                "K1 on the masked decode")
    return errs
