"""Split-reduction (split-K) in the port against the JAX package, on the
CPU.

Under a pinned ``split=S`` on both sides, the port's ``ops.tsm2r``/
``ops.tsmt`` (plain versions of the split kernels and of the epilogue)
match the JAX package's (Pallas in interpret mode) on the shapes of
``tests/test_split.py``, ragged ones included: f32 at rtol = atol = 1e-4,
bf16 at 2e-2 (``test_split.py:46,68``). One case per kernel lies above
``JNP_REDUCE_MAX_ELEMS``, so both sides run their partials-sum kernel's
plain version. Dispatch kinds agree, and the resolved S agrees wherever
the JAX package honours the pin. Then the policy knob, ``backward_policy``
and the split chooser in pure Python at 132 SMs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tsmm as jtsmm
from repro.kernels import reduce as jreduce
from repro_torch.core import perf_model, tsmm
from repro_torch.kernels import ops, reduce, ref

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _tol(name):
    return (dict(rtol=2e-2, atol=2e-2) if name == "bf16"
            else dict(rtol=1e-4, atol=1e-4))


def _pair(seed, shape, name):
    x = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    tdt, jdt = DTYPES[name]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def _splits(log, kind):
    return [lm.splits for e in log for lm in e.launches if lm.kind == kind]


def _run(entry, x, y, jx, jy, splits):
    fn, jfn = ((tsmm.tsmm, jtsmm.tsmm) if entry == "mm"
               else (tsmm.tsmm_t, jtsmm.tsmm_t))
    mode = "tsm2r" if entry == "mm" else "tsmt"
    with jtsmm.policy(split=splits, interpret=True), \
            jtsmm.record_dispatches() as jlog:
        want = jfn(jx, jy, mode=mode)
    with tsmm.policy(split=splits), tsmm.record_dispatches() as log:
        got = fn(x, y, mode=mode)
    assert [e.kind for e in log] == [e.kind for e in jlog] == [mode]
    s, js = _splits(log, mode), _splits(jlog, mode)
    assert len(s) == len(js) == 1
    if js[0] == splits:
        assert s[0] == splits
    return got, want, log


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("splits", [2, 4, 8])
@pytest.mark.parametrize("m,a,b", [
    (8192, 128, 8),       # PowerSGD Q = G^T P with r=8
    (10000, 300, 16),     # non-divisible everywhere
    (4100, 1, 1),         # degenerate skinny: the occupancy-starved case
])
def test_tsmt_split_matches_jax(m, a, b, splits, name):
    x, jx = _pair(m + a, (m, a), name)
    y, jy = _pair(m + b, (m, b), name)
    got, want, _ = _run("mmt", x, y, jx, jy, splits)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(name))


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("splits", [2, 4, 8])
@pytest.mark.parametrize("m,k,n", [
    (2048, 1024, 4),
    (1000, 777, 16),      # ragged m and k
])
def test_tsm2r_split_matches_jax(m, k, n, splits, name):
    a, ja = _pair(m + k, (m, k), name)
    b, jb = _pair(m + n, (k, n), name)
    got, want, _ = _run("mm", a, b, ja, jb, splits)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(name))


@pytest.mark.parametrize("entry,shape,splits", [
    ("mm", (16384, 512, 16), 2),       # (2, 16384, 16) partials > 2^18
    ("mmt", (16384, 512, 256), 4),     # (4, 512, 256) partials > 2^18
])
def test_partials_sum_kernel_runs_on_both_sides(entry, shape, splits):
    m, d1, d2 = shape
    x, jx = _pair(1, (m, d1), "f32")
    y, jy = _pair(2, (d1, d2) if entry == "mm" else (m, d2), "f32")
    rows, cols = (m, d2) if entry == "mm" else (d1, d2)
    assert splits * rows * cols > reduce.JNP_REDUCE_MAX_ELEMS
    assert reduce.JNP_REDUCE_MAX_ELEMS == jreduce.JNP_REDUCE_MAX_ELEMS
    got, want, log = _run(entry, x, y, jx, jy, splits)
    assert [lm.kind for lm in log[0].launches][-1] == "reduce"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_split_plain_versions_sum_to_the_product():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(-1, 1, (300, 777)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-1, 1, (777, 5)).astype(np.float32))
    parts = ref.tsm2r_split_ref(a, b, 8, 32)
    assert parts.shape == (8, 300, 5) and parts.dtype == torch.float32
    torch.testing.assert_close(ref.sum_partials_ref(parts, torch.float32),
                               ref.tsm2r_ref(a, b), rtol=1e-4, atol=1e-4)
    parts = ref.tsmt_split_ref(a, a[:, :5].contiguous(), 3, 8)
    assert parts.shape == (3, 777, 5)
    torch.testing.assert_close(parts.sum(0), ref.tsmt_ref(a, a[:, :5]),
                               rtol=1e-4, atol=1e-4)
    # Slices are contiguous, of whole 8-row blocks: 300 rows in 3 slices
    # of 104, 104 and 92.
    torch.testing.assert_close(parts[2], ref.tsmt_ref(a[208:], a[208:, :5]))


def test_policy_knob_and_per_call_pin():
    x = torch.randn(4096, 64)
    y = torch.randn(4096, 8)
    with tsmm.policy(split=4), tsmm.record_dispatches() as log:
        tsmm.tsmm_t(x, y)
    assert [e.split for e in log] == [4] and _splits(log, "tsmt") == [4]
    assert log[0].launches[0].grid == (1, 1, 4)
    with tsmm.policy(split=8):      # a per-call policy beats the scope's
        pin = tsmm.GemmPolicy(split=2)
        assert ops.resolve_params("tsmt", 4096, 64, 8, torch.float32,
                                  pin)["splits"] == 2
        with tsmm.record_dispatches() as log:
            got = tsmm.tsmm_t(x, y, policy=pin)
        assert _splits(log, "tsmt") == [2]
        torch.testing.assert_close(got, ref.tsmt_ref(x, y), rtol=1e-4,
                                   atol=1e-4)
        torch.testing.assert_close(ops.tsmt(x, y, policy=pin), got)
    with tsmm.policy(split="never"), tsmm.record_dispatches() as log:
        tsmm.tsmm_t(x, y)
    assert _splits(log, "tsmt") == [1]
    with tsmm.record_dispatches() as log:   # "auto" on the CPU: sequential
        tsmm.tsmm_t(x, y)
    assert log[0].split == "auto" and _splits(log, "tsmt") == [1]


def test_splits_clamped_to_whole_slices():
    """A pin past one block per slice runs the most slices the reduction
    admits: 16 on a 40-row sweep of 8-row blocks is 5."""
    p = tsmm.GemmPolicy(split=16)
    assert ops.resolve_params("tsmt", 40, 4, 4, torch.float32,
                              p)["splits"] == 5
    assert ops.resolve_params("tsm2r", 64, 100, 4, torch.float32,
                              p)["splits"] == 4
    assert ops.resolve_params("tsm2l", 64, 8, 4, torch.float32, p) == {}


def test_policy_split_validation():
    assert tsmm.GemmPolicy(split="auto").split == "auto"
    assert tsmm.GemmPolicy(split=4).split == 4
    assert tsmm.GemmPolicy(split="never").split == "never"
    for bad in ("sometimes", 0, True):
        with pytest.raises(ValueError, match="split"):
            tsmm.GemmPolicy(split=bad)


@pytest.mark.parametrize("split,want", [(4, "auto"), ("never", "never"),
                                        ("auto", "auto")])
def test_backward_policy_split(split, want):
    p = tsmm.GemmPolicy(split=split)
    bp, jbp = (tsmm.backward_policy(p),
               jtsmm.backward_policy(jtsmm.GemmPolicy(split=split)))
    assert bp.split == jbp.split == want
    if split == "auto":
        assert bp is p
    pinned = tsmm.backward_policy(tsmm.GemmPolicy(mode="tsm2r",
                                                  executor="cuda"))
    assert pinned.mode == "auto" and pinned.executor is None
    assert tsmm.backward_policy(tsmm.GemmPolicy(mode="dense")).mode == \
        "dense"


@pytest.mark.parametrize("kind,shape,split", [
    ("tsmt", (65024, 4096, 4), False),    # PowerSGD Q: the one launch
    ("tsmt", (1 << 20, 128, 4), False),   # one output tile, 264 slices
    ("tsmt", (65536, 256, 256), False),   # 64 x 64 tiles: never split
    ("tsmt", (65536, 4096, 256), False),  # 256 tiles
    ("tsm2r", (8192, 4096, 256), False),  # chatglm3's wk/wv prefill
    ("tsm2r", (65024, 4096, 4), False),   # PowerSGD P of chatglm3's embed
    ("tsm2r", (16384, 16384, 16), True),  # the paper's: 128 row tiles
])
def test_chooser_at_132_sms(kind, shape, split):
    choose = (perf_model.choose_splits_tsmt if kind == "tsmt"
              else perf_model.choose_splits_tsm2r)
    s = choose(*shape, perf_model.H100, torch.float32)
    assert (s > 1) == split, s
    assert perf_model.H100.n_sms == 132
    # S = 1 at tsmt is the one-launch kernel at its own plan of slices.
    runs = (perf_model.tsmt_slices(*shape)[0] if kind == "tsmt" and s == 1
            else s)
    grid = (perf_model.tsmt_grid if kind == "tsmt"
            else perf_model.tsm2r_grid)(*shape, runs)
    if split or kind == "tsmt":   # the slices fill the card
        assert grid[0] * grid[1] * runs >= perf_model.H100.n_sms // 2
    else:   # a sequential grid already does, or its output is wider than
        # the split kernels are run at
        assert (grid[0] * grid[1] >= perf_model.H100.n_sms
                or shape[2] > perf_model.SPLIT_MAX_WIDTH)


def test_chooser_ties_go_to_one_slice():
    # A one-block reduction admits no split at all.
    assert perf_model.choose_splits_tsmt(8, 4, 4) == 1
    assert perf_model.occupancy(33) == 33 / 132
    assert perf_model.split_partials_bytes(1, 10, 10) == 0
    assert perf_model.split_partials_bytes(4, 10, 10) == 2 * 4 * 100 * 4
    # The epilogue's kernel runs only past the plain sum's threshold.
    assert not perf_model.reduce_kernel_runs(1, 1 << 20, 16)
    assert not perf_model.reduce_kernel_runs(4, 256, 256)
    assert perf_model.reduce_kernel_runs(2, 16384, 16)
