"""The port's ABFT (``ft/abft.py`` and ``GemmPolicy.abft``) against the JAX
package's, on the CPU.

The chaos arms of ``tests/test_abft_online.py`` run on the port's
``torch-ref`` executor (the kernels' plain versions): a clean "verify"
output is bit-equal to the unguarded one, "verify" under an injected
fault is all NaN, and "correct" repairs it bit for bit against the
fault-free oracle, which itself matches JAX's interpret-mode output at
``tests/test_torch_kernels.py``'s tolerances (f32 rtol=1e-3, atol=1e-4
grown by sqrt(depth / 1024); int8 at the quant tests' max-norm 5%). The
checksum math (``tolerance``, ``detect``, ``_snap_to_bitflip``,
``locate_and_correct``) must equal JAX's exactly on the same numpy inputs:
masks, chosen row and repaired values. The offline tree path is held
against JAX's on flips the f32 ramp can localize, and the reference's own
limit (``[70000,8]``, row 7, +1.5) is recorded.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import contracts as jcontracts
from repro.core import tsmm as jtsmm
from repro.ft import abft as jabft
from repro.ft import inject as jinject
from repro_torch.analysis import contracts
from repro_torch.core import tsmm
from repro_torch.ft import abft, inject

INT8_REL = 0.05


def _operands(kind, shape, seed=0):
    m, d1, d2 = shape
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (m, d1)).astype(np.float32)
    y = rng.uniform(-1, 1, (m, d2) if kind == "tsmt" else (d1, d2)
                    ).astype(np.float32)
    return x, y


def _call(kind, x, y):
    return tsmm.tsmm_t(x, y) if kind == "tsmt" else tsmm.tsmm(x, y)


def _jcall(kind, x, y):
    return jtsmm.tsmm_t(x, y) if kind == "tsmt" else jtsmm.tsmm(x, y)


def _max_cell(arr):
    r, c = np.unravel_index(np.argmax(np.abs(np.asarray(arr, np.float32))),
                            arr.shape)
    return int(r), int(c)


def _same(a, b):
    """Bit-equal, NaN in the same places."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


# -- policy plumbing --------------------------------------------------------

def test_policy_validates_abft():
    assert tsmm.GemmPolicy().abft == jtsmm.GemmPolicy().abft == "none"
    for mode in ("none", "verify", "correct"):
        assert tsmm.GemmPolicy(abft=mode).abft == mode
    with pytest.raises(ValueError, match="abft"):
        tsmm.GemmPolicy(abft="retry")


def test_backward_policy_preserves_abft():
    for mode in ("none", "verify", "correct"):
        p = tsmm.GemmPolicy(abft=mode, quant="int8", split=2)
        bp = tsmm.backward_policy(p)
        assert bp.abft == mode and bp.split == "auto"
        assert not contracts.check_backward_policy(p, bp)
    with tsmm.policy(abft="correct"):
        assert tsmm.current_policy().abft == "correct"
    assert tsmm.current_policy().abft == "none"


def test_abft_policy_contract_flags_drift():
    p = tsmm.GemmPolicy(abft="verify")
    drifted = dataclasses.replace(tsmm.backward_policy(p), abft="none")
    rules = [v.rule for v in contracts.check_backward_policy(p, drifted)]
    jp = jtsmm.GemmPolicy(abft="verify")
    jdrifted = dataclasses.replace(jtsmm.backward_policy(jp), abft="none")
    jrules = [v.rule for v in jcontracts.check_backward_policy(jp, jdrifted)]
    assert "abft-policy" in rules and "abft-policy" in jrules


@pytest.mark.parametrize("kind,shape,s", [
    ("tsm2r", (4096, 512, 8), 2), ("tsm2l", (8192, 16, 16), 2),
    ("tsmt", (65536, 16, 16), 3), ("tsmt", (65024, 4096, 4), 2),
    ("tsm2r", (65024, 4096, 4), 2), ("tsm2r", (4096, 4096, 256), 2)])
def test_abft_stage_shapes_match_jax(kind, shape, s):
    assert contracts.abft_stage_shapes(kind, shape, s) == \
        jcontracts.abft_stage_shapes(kind, shape, s)
    assert contracts.ABFT_TOL_FACTOR == jcontracts.ABFT_TOL_FACTOR == 16.0


def test_abft_stage_shapes_errors():
    with pytest.raises(ValueError, match="s >= 2"):
        contracts.abft_stage_shapes("tsm2r", (4096, 512, 8), s=1)
    with pytest.raises(ValueError, match="unknown kind"):
        contracts.abft_stage_shapes("dense", (4096, 512, 8))


# -- dispatch events --------------------------------------------------------

def test_abft_none_zero_overhead():
    x, y = map(torch.from_numpy, _operands("tsm2r", (4096, 512, 8)))
    with tsmm.record_dispatches() as log:
        tsmm.tsmm(x, y)
    assert len(log) == 1 and log[0].abft == "none" and log[0].faults == ()


@pytest.mark.parametrize("kind,shape", [("tsm2r", (4096, 512, 8)),
                                        ("tsm2l", (8192, 16, 16)),
                                        ("tsmt", (16384, 16, 16))])
@pytest.mark.parametrize("mode", ["verify", "correct"])
def test_one_guarded_event_per_protected_call_as_jax(kind, shape, mode):
    """The protected GEMM and the three checksum stages of
    ``abft_stage_shapes``, routed as the JAX package routes them."""
    x, y = _operands(kind, shape)
    with tsmm.record_dispatches() as log, tsmm.policy(abft=mode):
        _call(kind, torch.from_numpy(x), torch.from_numpy(y))
    with jtsmm.record_dispatches() as jlog, \
            jtsmm.policy(interpret=True, abft=mode):
        _jcall(kind, jnp.asarray(x), jnp.asarray(y))
    assert [(e.entry, e.kind, e.shape, e.abft) for e in log] == \
        [(e.entry, e.kind, e.shape, e.abft) for e in jlog]
    assert [e.abft for e in log] == [mode, "none", "none", "none"]
    stages = contracts.abft_stage_shapes(kind, shape)
    assert [(e.entry, e.shape) for e in log[1:]] == list(stages)


def test_injected_fault_stamped_on_event():
    x, y = map(torch.from_numpy, _operands("tsm2r", (4096, 512, 8)))
    f = inject.GemmFault(site=0, operand="out", row=3, col=2, bit=29)
    with tsmm.record_dispatches() as log, tsmm.policy(abft="verify"), \
            inject.faults(f) as scope:
        tsmm.tsmm(x, y)
    assert scope.applied == [f]
    assert [e.faults for e in log] == [(f,), (), (), ()]


# -- chaos: detect + correct per kind and executor arm ----------------------

CHAOS_ARMS = [
    ("tsm2r", (4096, 512, 8), {}),
    ("tsm2l", (8192, 16, 16), {}),
    ("tsmt", (100000, 16, 16), {}),
    ("tsm2r", (4096, 512, 8), {"split": 2}),       # split-K partials arm
    ("tsm2r", (4096, 512, 8), {"quant": "int8"}),  # quantized arm
]


@pytest.mark.parametrize("kind,shape,extra", CHAOS_ARMS,
                         ids=[f"{k}-{'-'.join(map(str, e.values())) or 'base'}"
                              for k, _, e in CHAOS_ARMS])
def test_chaos_detect_and_correct(kind, shape, extra):
    xn, yn = _operands(kind, shape)
    x, y = torch.from_numpy(xn), torch.from_numpy(yn)
    with tsmm.policy(**extra), tsmm.record_dispatches() as log:
        oracle = _call(kind, x, y)
    assert log[0].executor == "torch-ref" and log[0].kind == kind
    with jtsmm.policy(interpret=True, **extra):
        want = np.asarray(_jcall(kind, jnp.asarray(xn), jnp.asarray(yn)))
    if extra.get("quant") == "int8":
        rel = np.abs(oracle.numpy() - want).max() / np.abs(want).max()
        assert rel <= INT8_REL
    else:
        depth = shape[0] if kind == "tsmt" else shape[1]
        np.testing.assert_allclose(
            oracle.numpy(), want, rtol=1e-3,
            atol=1e-4 * max(1.0, (depth / 1024) ** 0.5))
    r, c = _max_cell(oracle.numpy())
    fault = inject.GemmFault(site=0, operand="out", row=r, col=c, bit=29)

    with tsmm.policy(abft="verify", **extra):
        clean = _call(kind, x, y)
    assert _same(clean, oracle)
    with tsmm.policy(abft="verify", **extra), inject.faults(fault) as scope:
        poisoned = _call(kind, x, y)
    assert scope.applied == [fault]
    assert torch.isnan(poisoned).all()
    with tsmm.policy(abft="correct", **extra), inject.faults(fault):
        fixed = _call(kind, x, y)
    assert _same(fixed, oracle)


@pytest.mark.parametrize("operand", ["a", "b"])
def test_operand_fault_detected(operand):
    x, y = map(torch.from_numpy, _operands("tsm2r", (4096, 512, 8)))
    f = inject.GemmFault(site=0, operand=operand, row=5, col=3, bit=29)
    with tsmm.policy(abft="verify"), inject.faults(f):
        out = tsmm.tsmm(x, y)
    assert torch.isnan(out).all()
    assert torch.equal(x, torch.from_numpy(_operands("tsm2r",
                                                     (4096, 512, 8))[0]))


def test_bf16_clean_and_corrected():
    x, y = (torch.from_numpy(t).bfloat16()
            for t in _operands("tsm2r", (4096, 512, 8)))
    oracle = tsmm.tsmm(x, y)
    with tsmm.policy(abft="verify"):
        assert _same(tsmm.tsmm(x, y).view(torch.int16),
                     oracle.view(torch.int16))
    r, c = _max_cell(oracle.float().numpy())
    fault = inject.GemmFault(site=0, operand="out", row=r, col=c, bit=13)
    with tsmm.policy(abft="correct"), inject.faults(fault):
        fixed = tsmm.tsmm(x, y)
    assert torch.equal(fixed.view(torch.int16), oracle.view(torch.int16))


@pytest.mark.parametrize("kind,shape", [("tsm2r", (4096, 512, 8)),
                                        ("tsmt", (16384, 16, 8))])
def test_grad_identity_on_clean_runs(kind, shape):
    xn, yn = _operands(kind, shape)

    def grads(mode):
        x = torch.from_numpy(xn).requires_grad_(True)
        y = torch.from_numpy(yn).requires_grad_(True)
        with tsmm.policy(abft=mode):
            loss = (_call(kind, x, y) ** 2).sum()
        return torch.autograd.grad(loss, (x, y))

    g_none = grads("none")
    for mode in ("verify", "correct"):
        for g, g0 in zip(grads(mode), g_none):
            assert torch.equal(g, g0)


def test_multi_row_fault_poisons_not_mends():
    """Two damaged rows (each column's own largest cell, distinct rows)
    cannot be explained by a single-row repair: poison, not a mend."""
    x, y = map(torch.from_numpy, _operands("tsm2r", (4096, 512, 8)))
    oracle = tsmm.tsmm(x, y).numpy()
    r0 = int(np.argmax(np.abs(oracle[:, 0])))
    col1 = np.abs(oracle[:, 1]).copy()
    col1[r0] = -np.inf
    r1 = int(np.argmax(col1))
    plan = (inject.GemmFault(site=0, operand="out", row=r0, col=0, bit=29),
            inject.GemmFault(site=0, operand="out", row=r1, col=1, bit=29))
    with tsmm.policy(abft="correct"), inject.faults(*plan):
        out = tsmm.tsmm(x, y)
    assert torch.isnan(out).all()


# -- the checksum math against JAX's, exactly -------------------------------

@pytest.mark.parametrize("cols", [4, 7, 8, 16])
def test_tolerance_equals_jax(cols):
    """An even column count takes jnp.median's mean of the two middle
    values, which torch.median does not."""
    rng = np.random.default_rng(cols)
    amax = rng.uniform(0.5, 50.0, cols).astype(np.float32)
    for eps in (abft.tolerance_eps(torch.float32),
                abft.tolerance_eps(torch.bfloat16),
                abft.tolerance_eps(torch.float32, "int8")):
        got = abft.tolerance(4096, 512, eps, torch.from_numpy(amax)).numpy()
        want = np.asarray(jabft.tolerance(4096, 512, eps, jnp.asarray(amax)))
        assert _same(got, want)
    if cols % 2 == 0:
        mid = np.sort(amax)[cols // 2 - 1]
        assert float(torch.from_numpy(amax).median()) == mid
        assert float(abft._median(torch.from_numpy(amax))) != mid
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        for q in ("none", "int8"):
            assert abft.tolerance_eps(dt, q) == jabft.tolerance_eps(jdt, q)


def test_tolerance_robust_to_corrupted_amax():
    eps = abft.tolerance_eps(torch.float32, "int8")
    amax = np.array([40.0, 45.0, 2.4e20, 42.0], np.float32)
    tol = abft.tolerance(4096, 512, eps, torch.from_numpy(amax)).numpy()
    assert tol[2] < 1e7
    clean = abft.tolerance(4096, 512, eps, torch.tensor(
        [40.0, 45.0, 41.0, 42.0])).numpy()
    assert tol[2] / clean[2] < 100.0
    assert _same(tol, np.asarray(jabft.tolerance(4096, 512, eps,
                                                 jnp.asarray(amax))))
    nan_amax = np.array([1.0, np.nan, 2.0, 3.0], np.float32)
    assert _same(abft.tolerance(64, 64, eps, torch.from_numpy(nan_amax)),
                 jabft.tolerance(64, 64, eps, jnp.asarray(nan_amax)))


def _checksums(out, rows, seed, bad_cols=(), scale=1e-6):
    """c_out from ``out`` and c_ref with small noise, plus big deviations
    in ``bad_cols``: the same numpy inputs for both packages."""
    rng = np.random.default_rng(seed)
    e = np.stack([np.ones(rows), (np.arange(rows) + 1.0) / rows], 1)
    c_out = (out.astype(np.float64).T @ e).astype(np.float32)
    c_ref = c_out + rng.normal(0, scale, c_out.shape).astype(np.float32)
    for j in bad_cols:
        c_ref[j] += np.float32(1e3)
    return c_out, c_ref


@pytest.mark.parametrize("bad_cols", [(), (1,), (0, 3)])
def test_detect_equals_jax(bad_cols):
    out = np.random.default_rng(1).normal(size=(512, 6)).astype(np.float32)
    c_out, c_ref = _checksums(out, 512, 2, bad_cols)
    amax = np.abs(out).max(0)
    kw = dict(rows=512, reduction=256, eps=abft.tolerance_eps(torch.float32))
    bad, tol = abft.detect(torch.from_numpy(c_out), torch.from_numpy(c_ref),
                           amax=torch.from_numpy(amax), **kw)
    jbad, jtol = jabft.detect(jnp.asarray(c_out), jnp.asarray(c_ref),
                              amax=jnp.asarray(amax), **kw)
    assert _same(bad, jbad) and _same(tol, jtol)
    assert sorted(np.flatnonzero(bad.numpy())) == list(bad_cols)


@pytest.mark.parametrize("dtype,jdt,bits", [
    (torch.float32, jnp.float32, (0, 5, 22, 23, 29, 30, 31)),
    (torch.bfloat16, jnp.bfloat16, (0, 6, 7, 13, 14, 15))])
def test_snap_to_bitflip_equals_jax(dtype, jdt, bits):
    rng = np.random.default_rng(3)
    true = rng.normal(0, 3, len(bits)).astype(np.float32)
    t_true = torch.from_numpy(true).to(dtype)
    row = torch.stack([inject.flip_bit(t_true[None], 0, j, b)[0, j]
                       for j, b in enumerate(bits)])
    noise = rng.normal(0, 1e-3, len(bits)).astype(np.float32)
    est = t_true.float() + torch.from_numpy(noise)
    est[1] = float("nan")                   # a non-finite estimate
    for snap_tol in (1e-2, 1e-6):
        tol = torch.full((len(bits),), snap_tol)
        got = abft._snap_to_bitflip(row, est, tol)
        want = jabft._snap_to_bitflip(
            jnp.asarray(row.float().numpy()).astype(jdt),
            jnp.asarray(est.numpy()), jnp.asarray(tol.numpy()))
        assert _same(got.float().numpy(), np.asarray(want, np.float32))
    # A flip of a high bit is undone exactly; near a low bit's flip other
    # candidates lie closer to the estimate than its noise.
    snapped = abft._snap_to_bitflip(row, est, torch.full((len(bits),), 1e-2))
    high = 22 if dtype == torch.float32 else 6
    keep = [j for j, b in enumerate(bits) if j != 1 and b >= high]
    assert torch.equal(snapped[keep], t_true[keep])


def _fault_case(rows, cols, seed, bit, dtype, second):
    """A clean output, its exact checksums (f64 rounded to f32), and the
    output with one bit of its largest cell flipped (and, with ``second``,
    the largest cell of the next column damaged too, on another row)."""
    rng = np.random.default_rng(seed)
    clean = np.asarray(jnp.asarray(rng.normal(0, 2, (rows, cols)).astype(
        np.float32)).astype(dtype).astype(jnp.float32))
    r, c = _max_cell(clean)
    e = np.stack([np.ones(rows), (np.arange(rows) + 1.0) / rows], 1)
    c_ref = (clean.astype(np.float64).T @ e).astype(np.float32)
    jbad = jinject.flip_bit(jnp.asarray(clean).astype(dtype), r, c, bit)
    if second:
        c2 = (c + 1) % cols
        col = np.abs(clean[:, c2]).copy()
        col[r] = -np.inf
        r2 = int(np.argmax(col))
        jbad = jbad.at[r2, c2].set(jbad[r2, c2] * 3 + 1)
    c_out = (np.asarray(jbad.astype(jnp.float32)).astype(np.float64).T
             @ e).astype(np.float32)
    return clean, jbad, c_out, c_ref


# case: (dtype, bit, dense row recompute, second damaged row, outcome of
# "correct"). A flip that shrinks the cell (f32 bit 30) is repaired from
# the checksums alone; one that grows it by 2^64 (f32 bit 29, bf16 bit 13)
# needs the row recompute, as the online guard passes it.
LOCATE_CASES = {
    "f32": (jnp.float32, 30, False, False, "restored"),
    "f32-ref-row": (jnp.float32, 29, True, False, "restored"),
    "bf16-ref-row": (jnp.bfloat16, 13, True, False, "restored"),
    "two-rows": (jnp.float32, 29, True, True, "poisoned"),
    "clean": (jnp.float32, None, False, False, "restored"),
}


@pytest.mark.parametrize("mode", ["verify", "correct"])
@pytest.mark.parametrize("case", list(LOCATE_CASES))
def test_locate_and_correct_equals_jax(case, mode):
    """Masks, the chosen row and the repaired values equal JAX's on the
    same numpy inputs, with and without the dense row recompute."""
    dtype, bit, use_ref_row, second, outcome = LOCATE_CASES[case]
    rows, cols = 1024, 8
    clean, jbad, c_out, c_ref = _fault_case(rows, cols, 5, bit or 0, dtype,
                                            second)
    if bit is None:
        jbad, c_out = jnp.asarray(clean), c_ref
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    out = torch.from_numpy(np.asarray(jbad.astype(jnp.float32))).to(tdt)
    kw = dict(rows=rows, reduction=rows, mode=mode,
              eps=abft.tolerance_eps(tdt))
    ref_row = jref_row = None
    if use_ref_row:
        def ref_row(i):
            return torch.from_numpy(clean)[i]

        def jref_row(i):
            return jnp.asarray(clean)[i]
    got = abft.locate_and_correct(out, torch.from_numpy(c_out),
                                  torch.from_numpy(c_ref), ref_row=ref_row,
                                  **kw)
    want = jabft.locate_and_correct(jbad, jnp.asarray(c_out),
                                    jnp.asarray(c_ref), ref_row=jref_row,
                                    **kw)
    assert _same(got.float().numpy(), np.asarray(want, np.float32))
    if mode == "verify" and bit is not None:
        outcome = "poisoned"
    if outcome == "restored":
        assert np.array_equal(got.float().numpy(), clean)
    else:
        assert torch.isnan(got).all()


def test_locate_and_correct_mode_validated():
    with pytest.raises(ValueError, match=r"\[abft-mode\]"):
        abft.locate_and_correct(torch.zeros(4, 2), torch.zeros(2, 2),
                                torch.zeros(2, 2), rows=4, reduction=4,
                                mode="retry", eps=1e-7)


# -- offline tree API --------------------------------------------------------

def _leaf(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_checksum_weights_and_encode_equal_jax():
    for d1, s in ((7, 2), (70000, 3)):
        assert _same(abft.checksum_weights(d1, s),
                     jabft.checksum_weights(d1, s))
    w = _leaf((70000, 16), 11)
    np.testing.assert_allclose(
        abft.encode_leaf(torch.from_numpy(w)).numpy(),
        np.asarray(jabft.encode_leaf(jnp.asarray(w), interpret=True)),
        rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("bit", [22, 25, 27, 30])
def test_offline_correct_leaf_repairs_a_flip_as_jax(bit):
    """A flip of the largest cell that the f32 ramp localizes: both
    packages restore the leaf bit for bit."""
    w = _leaf((70000, 16), 11)
    t = torch.from_numpy(w)
    c = abft.encode_leaf(t)
    jc = jabft.encode_leaf(jnp.asarray(w), interpret=True)
    r, col = _max_cell(w)
    bad = inject.flip_bit(t, r, col, bit)
    ok, fixed = abft.correct_leaf(bad, c)
    jok, jfixed = jabft.correct_leaf(
        jinject.flip_bit(jnp.asarray(w), r, col, bit), jc, interpret=True)
    assert not bool(ok) and not bool(jok)
    assert torch.equal(fixed, t) and _same(jfixed, w)
    ok2, same = abft.correct_leaf(t, c)
    assert bool(ok2) and torch.equal(same, t)


def test_offline_tree_verify_and_correct():
    """The reference's tree test, on a fault the f32 ramp can localize (a
    bit-30 flip of w's largest cell): detected, restored bit for bit; the
    leaf below the checksum threshold passes through."""
    w = _leaf((70000, 8), 12)
    tree = {"w": torch.from_numpy(w), "tiny": torch.ones(4, 4)}
    cs = abft.encode_tree(tree)
    assert cs["tiny"] is None and cs["w"].shape == (8, 2)
    ok, devs = abft.verify_tree(tree, cs)
    assert bool(ok) and float(devs["w"]) == 0.0
    ok, same = abft.verify_and_correct_tree(tree, cs)
    assert bool(ok) and torch.equal(same["w"], tree["w"])
    r, c = _max_cell(w)
    corrupted = {**tree, "w": inject.flip_bit(tree["w"], r, c, 30)}
    ok, _ = abft.verify_tree(corrupted, cs)
    assert not bool(ok)
    ok2, fixed = abft.verify_and_correct_tree(corrupted, cs)
    assert not bool(ok2)
    assert torch.equal(fixed["w"], tree["w"])
    assert fixed["tiny"] is tree["tiny"]
    jtree = {"w": jnp.asarray(w), "tiny": jnp.ones((4, 4))}
    jcs = jabft.encode_tree(jtree, interpret=True)
    jok, jfixed = jabft.verify_and_correct_tree(
        {**jtree, "w": jinject.flip_bit(jtree["w"], r, c, 30)}, jcs,
        interpret=True)
    assert not bool(jok) and _same(jfixed["w"], w)


def test_offline_tree_takes_a_modules_parameters():
    mod = torch.nn.Linear(512, 256)
    cs = abft.encode_tree(mod)
    assert sorted(cs) == ["bias", "weight"] and cs["bias"] is None
    ok, fixed = abft.verify_and_correct_tree(mod, cs)
    assert bool(ok) and torch.equal(fixed["weight"], mod.weight)


def test_reference_offline_limit_row_7():
    """The reference's own limit (its ``test_offline_tree_verify_and_
    correct``): on a ``[70000,8]`` N(0,1) leaf, +1.5 at (7, 3) moves the
    ramp checksum by 1.5 * 8/70000, below what its f32 rounding resolves,
    so the locate step picks a neighbour of row 7 and neither package
    restores the cell within atol 1e-4. The leaf is the reference test's
    own draw."""
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(12), (70000, 8)))
    bad = w.copy()
    bad[7, 3] += np.float32(1.5)
    cs = abft.encode_tree({"w": torch.from_numpy(w)})
    ok, fixed = abft.verify_and_correct_tree({"w": torch.from_numpy(bad)}, cs)
    jcs = jabft.encode_tree({"w": jnp.asarray(w)}, interpret=True)
    jok, jfixed = jabft.verify_and_correct_tree({"w": jnp.asarray(bad)}, jcs,
                                                interpret=True)
    assert not bool(ok) and not bool(jok)
    for got in (fixed["w"].numpy(), np.asarray(jfixed["w"])):
        wrong = {tuple(ix) for ix in np.argwhere(np.abs(got - w) > 1e-4)}
        # the cell stays damaged, and a neighbour takes the "repair"
        assert len(wrong) == 2 and (7, 3) in wrong
        assert wrong - {(7, 3)} <= {(6, 3), (8, 3)}
