"""The port's contract layer (``repro_torch.analysis.contracts``), the
``GemmPolicy.verify_contracts`` check and the bound classifier, on the
CPU.

* Each rule fires on a configuration that breaks it and stays quiet on
  one that keeps it, with the numbers pinned.
* Agreement: every S the choosers emit and every launch ``resolve_params``
  resolves over a sweep of shapes (f32, bf16, int8) is contract-clean;
  ``verify_contracts`` never raises on default resolution and raises
  before launching a violating one; every grid ``record_dispatches``
  records is ``launch_grid`` of its params; ``check_backward_policy``
  holds on the port's real policies and catches drift.
* Against the JAX package: ``t2_threshold`` / ``arithmetic_intensity``
  equal its formula given the same peak and bandwidth, and the bound
  classes of a pinned table of H100 shapes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import contracts as jcontracts
from repro.core import perf_model as jperf
from repro.core import tsmm as jtsmm
from repro_torch.analysis import contracts
from repro_torch.core import perf_model, tsmm
from repro_torch.kernels import ops

F32, BF16, I8 = torch.float32, torch.bfloat16, torch.int8
LIM = contracts.H100_LIMITS


def _rules(violations):
    return [v.rule for v in violations]


def _params(kind, shape, dtype=F32, s=1, **over):
    """``perf_model.kernel_params`` at S = ``s``, with ``over`` put over
    it."""
    p = perf_model.kernel_params(kind, *shape, dtype, s)
    p.update(over)
    return p


# ---------------------------------------------------------------------------
# Each rule
# ---------------------------------------------------------------------------

def test_clean_configs_keep_every_rule():
    for kind, shape, dtype, s in [
            ("tsm2r", (8192, 4096, 256), BF16, 1),
            ("tsm2r", (65024, 4096, 4), F32, 1),
            ("tsm2r", (16384, 16384, 16), F32, 2),
            ("tsm2r", (8192, 4096, 256), I8, 1),
            ("tsm2l", (1 << 20, 16, 16), F32, 1),
            ("tsm2l", (10000, 300, 20), BF16, 1),
            ("tsmt", (65024, 4096, 4), F32, 1),
            ("tsmt", (65024, 4096, 4), F32, 8),
            ("tsmt", (65024, 4096, 4), I8, 1),
            ("tsmt", (65536, 256, 256), F32, 1)]:
        p = _params(kind, shape, dtype, s)
        assert contracts.check_kernel_config(kind, shape, p, dtype) == []
        assert contracts.check_grid(kind, shape, p) == []
        assert contracts.feasible(kind, shape, p, dtype)


def test_unknown_kind_and_missing_params():
    assert _rules(contracts.check_kernel_config(
        "tsm3", (64, 64, 4), {}, F32)) == ["unknown-kind"]
    p = _params("tsm2r", (4096, 4096, 8))
    del p["smem"]
    vios = contracts.check_kernel_config("tsm2r", (4096, 4096, 8), p, F32)
    assert _rules(vios) == ["missing-params"] and "smem" in vios[0].detail
    for kind in contracts.KINDS:
        assert set(contracts.PARAM_KEYS[kind]) <= set(
            _params(kind, (4096, 64, 16)))


@pytest.mark.parametrize("key,value", [("splits", 0), ("block_k", -32),
                                       ("splits", True), ("smem", -1),
                                       ("tile", (128,)), ("splits", 2.0)])
def test_bad_param(key, value):
    p = _params("tsm2r", (4096, 4096, 8), **{key: value})
    assert "bad-param" in _rules(contracts.check_kernel_config(
        "tsm2r", (4096, 4096, 8), p, F32))


def test_split_unsupported_on_tsm2l():
    shape = (1 << 20, 16, 16)
    p = _params("tsm2l", shape, splits=2)
    assert _rules(contracts.check_kernel_config(
        "tsm2l", shape, p, F32)) == ["split-unsupported"]
    assert contracts.check_kernel_config(
        "tsm2l", shape, _params("tsm2l", shape), F32) == []


def test_split_whole_slice():
    # k = 100 holds ceil_mult(100, 32) / 32 = 4 slices of 32.
    shape = (4096, 100, 4)
    assert "split-whole-slice" in _rules(contracts.check_kernel_config(
        "tsm2r", shape, _params("tsm2r", shape, s=5), F32))
    assert "split-whole-slice" not in _rules(contracts.check_kernel_config(
        "tsm2r", shape, _params("tsm2r", shape, s=4), F32))
    shape = (40, 4, 4)      # 5 blocks of 8 rows
    assert "split-whole-slice" in _rules(contracts.check_kernel_config(
        "tsmt", shape, _params("tsmt", shape, s=6), F32))


def test_accumulator_limit_is_not_a_candidate_filter():
    shape = (65536, 16, 600)
    p = _params("tsmt", shape)
    assert "accumulator-limit" in _rules(contracts.check_kernel_config(
        "tsmt", shape, p, F32))
    assert contracts.check_kernel_config("tsmt", shape, p, F32,
                                         max_b=1024) == []
    assert contracts.feasible("tsmt", shape, p, F32)
    assert ops.TSMT_MAX_B == contracts.TSMT_MAX_B == jcontracts.TSMT_MAX_B


def test_grid_limit():
    # 78,125 column tiles of 64 in grid y: past CUDA's 65,535.
    shape = (4096, 4096, 5_000_000)
    vios = contracts.check_kernel_config("tsm2r", shape,
                                         _params("tsm2r", shape), F32)
    assert _rules(vios) == ["grid-limit"] and "78125" in vios[0].detail
    shape = (1 << 20, 4096, 4_194_240)     # 65,535 tiles: the last legal
    assert contracts.check_kernel_config(
        "tsm2r", shape, _params("tsm2r", shape), F32) == []
    shape = (2**31, 16, 16)                # m past a 32-bit int
    assert "grid-limit" in _rules(contracts.check_kernel_config(
        "tsm2l", shape, _params("tsm2l", shape), F32))


def test_smem_budget_per_block_and_per_sm():
    shape = (1 << 20, 16, 16)
    p = _params("tsm2l", shape)
    assert p["blocks_per_sm"] == perf_model.STREAM_BLOCKS_PER_SM
    assert p["smem"] <= perf_model.STREAM_SMEM_BYTES
    # the stream body's two blocks an SM fit 228 KB, not 190 KB
    assert contracts.check_kernel_config("tsm2l", shape, p, F32) == []
    small = dataclasses.replace(LIM, smem_per_sm=190 * 1024)
    vios = contracts.check_kernel_config("tsm2l", shape, p, F32, small)
    assert _rules(vios) == ["smem-budget"] and "resident" in vios[0].detail
    # one block past the opt-in limit
    big = dict(p, smem=LIM.smem_per_block + 16)
    vios = contracts.check_kernel_config("tsm2l", shape, big, F32)
    assert _rules(vios) == ["smem-budget"] and "opt-in" in vios[0].detail


def test_smem_mirrors():
    """Each body's bytes from its Python mirror: the wgmma rings' stages
    x stage bytes, the skinny ring, the stream body's geometry."""
    assert perf_model.body_smem("tsm2r", "wgmma", 4096, 256, BF16) == \
        4 * (64 * 64 * 2 + 64 * 128 * 2) + 1024
    assert perf_model.body_smem("tsm2r", "wgmma", 4096, 256, I8) == \
        4 * (64 * 128 + 128 * 128) + 1024
    # skinny: 3 stages of 16 KB of A and 32 k x 16 columns x 4 B of B
    assert perf_model.body_smem("tsm2r", "skinny", 4096, 16, F32) == \
        3 * (16384 + 32 * 16 * 4) + 1024
    assert perf_model.body_smem("tsm2r", "skinny", 4096, 4, I8) == \
        3 * (16384 + 128 * 4) + 1024
    geo = perf_model.tsm2l_stream_geometry(16, 16, F32)
    assert perf_model.body_smem("tsm2l", "stream", 16, 16, F32) == \
        geo["smem"]
    # the static buffers of the simt tiles stay within CUDA's 48 KB
    for kind, shape, dtype in [("tsm2r", (4096, 777, 200), F32),
                               ("tsmt", (10000, 300, 20), I8)]:
        p = _params(kind, shape, dtype)
        assert p["body"] == "simt" and p["smem"] <= 48 * 1024, (kind, p)
    # tsm2l's tile body: 256 k values of B beside 64 rows of A, 4-byte words
    assert _params("tsm2l", (10000, 300, 20))["smem"] == \
        4 * (256 * 64 + 64 * 257)


@pytest.mark.parametrize("kind,shape,dtype,over", [
    ("tsm2r", (8192, 4096, 250), BF16, {"body": "wgmma"}),   # n % 8
    ("tsm2r", (8192, 4096, 16), BF16, {"body": "wgmma"}),    # n <= 16
    ("tsm2r", (8192, 4096, 256), BF16,
     {"ptrs": {"a": 8, "b": 0}}),                            # misaligned A
    ("tsm2r", (8192, 4096, 256), I8, {"b_kmajor": False}),   # row-major B
    ("tsm2r", (4096, 777, 16), F32, {"body": "skinny"}),     # k*4 % 16
    ("tsm2r", (4096, 4096, 16), F32,
     {"ptrs": {"a": 4, "b": 0}}),                            # misaligned A
    ("tsm2l", (4096, 300, 16), F32, {"body": "stream"}),     # k > 256
    ("tsm2l", (4096, 16, 20), F32, {"body": "stream"}),      # n > 16
    ("tsm2l", (4096, 16, 16), F32, {"ptrs": {"a": 4}}),      # misaligned A
    ("tsmt", (65536, 128, 6), I8, {"body": "packed"}),       # b = 6
    ("tsmt", (65536, 100, 4), I8, {"body": "packed"}),       # a % 16
    ("tsmt", (65536, 128, 4), F32, {"body": "packed"}),      # not int8
    ("tsmt", (65536, 128, 4), I8, {"ptrs": {"x": 0, "y": 4}}),
    ("tsm2l", (4096, 16, 16), F32, {"body": "wgmma"}),       # not tsm2l's
])
def test_body_preconditions(kind, shape, dtype, over):
    clean = _params(kind, shape, dtype)
    assert "body-preconditions" not in _rules(contracts.check_kernel_config(
        kind, shape, clean, dtype))
    bad = dict(clean, **over)
    if "body" not in over:      # keep the body the aligned plan named
        bad["body"] = clean["body"]
    assert "body-preconditions" in _rules(contracts.check_kernel_config(
        kind, shape, bad, dtype))


def test_body_choice_is_the_contract_predicates():
    """perf_model picks each body with the contracts' predicates, so the
    plan it names always meets them."""
    for k, n, dtype, pa, pb in [(4096, 256, BF16, 0, 0), (4096, 250, BF16,
                                                          0, 0),
                                (4096, 16, F32, 0, 0), (777, 16, F32, 0, 0),
                                (4096, 256, I8, 0, 0), (4096, 256, I8, 0, 8),
                                (4096, 4, F32, 4, 0)]:
        body = perf_model.tsm2r_body(k, n, dtype, pa, pb)
        assert (body == "wgmma") == contracts.wgmma_fits(k, n, dtype, pa, pb)
        assert (body == "skinny") == contracts.skinny_fits(k, n, dtype, pa)
    assert perf_model.tsm2l_body(16, 16, F32) == "stream"
    assert not contracts.stream_fits(257, 16, F32)
    assert perf_model.tsmt_q8_body(128, 4) == "packed"
    assert not contracts.packed_fits(128, 4, 0, 4)


def test_band_quantum():
    shape = (65024, 4096, 4)
    p = _params("tsmt", shape, I8)
    assert p["band"] == perf_model.Q8_BAND and p["slices"] > 1
    assert contracts.check_kernel_config("tsmt", shape, p, I8) == []
    for over in ({"slice": 8128}, {"block_m": 8}, {"band": None}):
        bad = {k: v for k, v in dict(p, **over).items() if v is not None}
        assert "band-quantum" in _rules(contracts.check_kernel_config(
            "tsmt", shape, bad, I8)), over


def test_check_grid_in_the_ports_padding_terms():
    shape = (65024, 4096, 4)
    p = _params("tsmt", shape, s=8)
    assert contracts.check_grid("tsmt", shape, p) == []
    for slice_ in (8100, 4000, 9296):   # not whole blocks; short; one empty
        assert _rules(contracts.check_grid(
            "tsmt", shape, dict(p, slice=slice_))) == ["grid-divisibility"]
    shape = (4096, 4000, 16)            # S = 5 slices of 800 k values
    p = _params("tsm2r", shape, s=5)
    assert p["slice"] == 800 and contracts.check_grid("tsm2r", shape, p) == []
    assert contracts.check_grid("reduce", (2, 1001, 3), {"vec": 1}) == []
    assert _rules(contracts.check_grid("reduce", (2, 1001, 3),
                                       {"vec": 2})) == ["grid-divisibility"]


def test_card_limits_default_to_the_data_sheet():
    assert contracts.card_limits() is LIM
    assert contracts.card_limits(torch.device("cpu")) is LIM
    assert LIM.smem_per_block == 232448 and LIM.smem_per_sm == 233472


# ---------------------------------------------------------------------------
# Agreement: the choosers, resolve_params, verify_contracts, the records
# ---------------------------------------------------------------------------

SWEEP = [(8192, 4096, 256), (4096, 4096, 256), (65024, 4096, 4),
         (16384, 16384, 16), (4096, 65536, 16), (1000, 777, 17),
         (65536, 128, 4), (1 << 20, 128, 4), (65536, 256, 256),
         (10000, 300, 20), (65024, 4, 4), (1 << 20, 16, 16), (40, 4, 4),
         (2048, 256, 4), (4096, 4000, 16)]


@pytest.mark.parametrize("dtype", [F32, BF16, I8])
def test_every_chooser_s_is_contract_clean(dtype):
    for shape in SWEEP:
        for kind, choose in (("tsm2r", perf_model.choose_splits_tsm2r),
                             ("tsmt", perf_model.choose_splits_tsmt)):
            s = choose(*shape, perf_model.H100, dtype)
            p = perf_model.kernel_params(kind, *shape, dtype, s)
            assert contracts.feasible(kind, shape, p, dtype), (kind, shape)
            assert contracts.check_grid(kind, shape, p) == []


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("split", ["auto", "never", 2, 8, 128])
def test_resolve_params_sweep_is_contract_clean(quant, split):
    pol = tsmm.GemmPolicy(quant=quant, split=split, verify_contracts=True)
    for dtype in (F32, BF16):
        for shape in SWEEP:
            for kind in contracts.KINDS:
                got = ops.resolve_params(kind, *shape, dtype, pol)
                plain = ops.resolve_params(
                    kind, *shape, dtype,
                    dataclasses.replace(pol, verify_contracts=False))
                assert got == plain


def test_verify_contracts_raises_before_launching():
    pol = tsmm.GemmPolicy(verify_contracts=True)
    with pytest.raises(ValueError, match=r"\[accumulator-limit\]"):
        ops.resolve_params("tsmt", 65536, 16, 600, F32, pol)
    with pytest.raises(ValueError, match=r"\[grid-limit\] grid"):
        ops.resolve_params("tsm2r", 4096, 4096, 5_000_000, F32, pol)
    # without the flag the same shape resolves, as before
    assert ops.resolve_params("tsmt", 65536, 16, 600, F32,
                              tsmm.GemmPolicy())["splits"] == 1
    # a forced tsm2l whose tile grid has 65,537 column tiles: the dispatch
    # raises before the kernel (here its plain version) runs
    a, b = torch.zeros(1, 1), torch.zeros(1, 65537 * 64)
    with tsmm.record_dispatches() as log, \
            pytest.raises(ValueError, match=r"\[grid-limit\]"):
        tsmm.tsmm(a, b, mode="tsm2l", policy=pol)
    assert log == []
    assert tsmm.tsmm(a, b, mode="tsm2l").shape == (1, 65537 * 64)


def test_verify_contracts_is_scope_wide_intent():
    p = tsmm.GemmPolicy(verify_contracts=True, mode="tsm2r", split=4)
    assert not tsmm.GemmPolicy().verify_contracts
    assert tsmm.backward_policy(p).verify_contracts


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_recorded_grids_are_launch_grid(quant):
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    with tsmm.policy(quant=quant, split="auto", verify_contracts=True), \
            tsmm.record_dispatches() as log:
        tsmm.tsmm(t(4096, 512), t(512, 4))
        tsmm.tsmm(t(4096, 16), t(16, 16))
        tsmm.tsmm_t(t(4096, 128), t(4096, 4))
        with tsmm.policy(split=4):
            tsmm.tsmm_t(t(4096, 128), t(4096, 4))
            tsmm.tsmm(t(4096, 512), t(512, 4))
    launches = [lm for e in log for lm in e.launches]
    assert len(launches) == 5
    for lm in launches:
        base = lm.kind.removesuffix("_q8")
        assert lm.dtype == (I8 if quant == "int8" else F32)
        assert lm.grid == contracts.launch_grid(base, lm.shape, lm.params)
        assert contracts.check_kernel_config(base, lm.shape, lm.params,
                                             lm.dtype) == []
    # the one-launch tsmt's grid is its own plan of m slices
    tsmt = [lm for lm in launches if lm.kind.startswith("tsmt")]
    assert tsmt[0].splits == 1 and tsmt[0].grid[2] == \
        perf_model.tsmt_slices(4096, 128, 4, dtype=tsmt[0].dtype)[0]
    assert tsmt[1].splits == tsmt[1].grid[2] == 4


def test_perf_model_grids_are_launch_grid():
    for m, k, n in SWEEP:
        assert perf_model.tsm2r_grid(m, k, n) == contracts.launch_grid(
            "tsm2r", (m, k, n), perf_model.kernel_params("tsm2r", m, k, n,
                                                         F32))
        assert perf_model.tsmt_grid(m, k, n, 3) == contracts.launch_grid(
            "tsmt", (m, k, n), perf_model.kernel_params("tsmt", m, k, n,
                                                        F32, 3))
        body, grid = perf_model.tsm2l_plan(m, k, n, F32)
        p = perf_model.kernel_params("tsm2l", m, k, n, F32)
        assert (body, grid) == (p["body"], contracts.launch_grid(
            "tsm2l", (m, k, n), p))
    grid, threads, vec, _ = perf_model.reduce_plan(2, 16384, 16, F32)
    assert grid == contracts.launch_grid(
        "reduce", (2, 16384, 16),
        {"vec": vec, "threads": threads,
         "max_blocks": perf_model.REDUCE_BLOCKS_PER_SM * 132})


@pytest.mark.parametrize("fwd", [
    tsmm.GemmPolicy(), tsmm.GemmPolicy(mode="dense"),
    tsmm.GemmPolicy(mode="tsm2r", executor="cuda", split=4),
    tsmm.GemmPolicy(mode="tsmt", split="never", quant="int8"),
    tsmm.GemmPolicy(split=8, quant="int8", verify_contracts=True)])
def test_check_backward_policy_on_real_policies(fwd):
    assert contracts.check_backward_policy(fwd,
                                           tsmm.backward_policy(fwd)) == []


def test_check_backward_policy_catches_drift():
    fwd = tsmm.GemmPolicy(mode="tsm2r", executor="cuda", split=4,
                          quant="int8")
    good = tsmm.backward_policy(fwd)
    for over, rule in [({"split": 4}, "backward-split"),
                       ({"executor": "cuda"}, "backward-executor"),
                       ({"mode": "tsm2r"}, "backward-mode"),
                       ({"quant": "none"}, "backward-quant")]:
        bad = dataclasses.replace(good, **over)
        assert _rules(contracts.check_backward_policy(fwd, bad)) == [rule]


def test_qr_stage_shapes_match_jax():
    for m, r in [(8192, 16), (65024, 4), (100, 3)]:
        assert contracts.qr_stage_shapes(m, r) == \
            jcontracts.qr_stage_shapes(m, r)
    with pytest.raises(ValueError):
        contracts.qr_stage_shapes(100, 8, shards=0)
    # the tree TSQR's local stages, and the reference's non-tiling error
    assert contracts.qr_stage_shapes(8192, 16, shards=4) == \
        jcontracts.qr_stage_shapes(8192, 16, shards=4)
    with pytest.raises(ValueError, match="tile") as got:
        contracts.qr_stage_shapes(100, 8, shards=3)
    with pytest.raises(ValueError) as want:
        jcontracts.qr_stage_shapes(100, 8, shards=3)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("rows,shards", [(64, 2), (63, 2), (64, 1),
                                         (8, 16), (0, 4), (12, 0)])
def test_check_scatter_matches_jax(rows, shards):
    assert contracts.scatter_divisible(rows, shards) == \
        jcontracts.scatter_divisible(rows, shards)
    got = contracts.check_scatter(rows, shards)
    want = jcontracts.check_scatter(rows, shards)
    assert [(v.rule, v.subject, v.detail) for v in got] == \
        [(v.rule, v.subject, v.detail) for v in want]


@pytest.mark.parametrize("name", ["torch-dense", "cuda", "torch-ref",
                                  "shard_map", "shard_map-scatter"])
def test_executor_reduce_ok_matches_jax(name):
    jname = {"torch-dense": "dense-xla", "cuda": "pallas-tpu",
             "torch-ref": "interpret"}.get(name, name)
    declared = tsmm.executor_reduce_contract(name)
    for mode in ("psum", "psum_scatter", "none"):
        assert contracts.executor_reduce_ok(declared, mode) == \
            jcontracts.executor_reduce_ok(
                jtsmm.executor_reduce_contract(jname), mode)


def test_backward_reduce_rule_as_jax():
    for reduce_ in ("psum", "psum_scatter", "none"):
        fwd = tsmm.GemmPolicy(reduce=reduce_, executor="shard_map")
        assert contracts.check_backward_policy(
            fwd, tsmm.backward_policy(fwd)) == []
    fwd = tsmm.GemmPolicy(reduce="none", executor="shard_map")
    bad = dataclasses.replace(tsmm.backward_policy(fwd), reduce="none")
    jfwd = jtsmm.GemmPolicy(reduce="none", executor="shard_map")
    jbad = dataclasses.replace(jtsmm.backward_policy(jfwd), reduce="none")
    assert _rules(contracts.check_backward_policy(fwd, bad)) == \
        _rules(jcontracts.check_backward_policy(jfwd, jbad)) == \
        ["backward-reduce"]


def test_ceil_mult_and_reduction_axis_match_jax():
    for x, q in [(0, 8), (1, 8), (8, 8), (65024, 256), (777, 32)]:
        assert contracts.ceil_mult(x, q) == jcontracts.ceil_mult(x, q)
    assert contracts.reduction_axis("tsm2r", (1, 2, 3)) == ("block_k", 2)
    assert contracts.reduction_axis("tsmt", (1, 2, 3)) == ("block_m", 1)
    with pytest.raises(ValueError):
        contracts.reduction_axis("tsm2l", (1, 2, 3))
    v = contracts.Violation("smem-budget", "s", "d")
    assert v.to_json() == jcontracts.Violation("smem-budget", "s",
                                               "d").to_json()


# ---------------------------------------------------------------------------
# The bound classifier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,jdtype", [(BF16, jnp.bfloat16),
                                          (F32, jnp.float32),
                                          (I8, jnp.int8)])
def test_t2_threshold_and_intensity_follow_the_jax_formula(dtype, jdtype):
    h = perf_model.H100
    peak = h.peak_flops(dtype)
    jspec = dataclasses.replace(jperf.V5E, peak_flops_bf16=peak,
                                peak_flops_f32=peak, hbm_bw=h.hbm_bw)
    assert perf_model.t2_threshold(h, dtype) == pytest.approx(
        jperf.t2_threshold(jspec, jdtype), rel=1e-12)
    for m, k, n in [(8192, 4096, 256), (65024, 4096, 4), (1 << 20, 16, 16),
                    (4, 65024, 4)]:
        assert perf_model.arithmetic_intensity(m, k, n, dtype) == \
            pytest.approx(jperf.arithmetic_intensity(m, k, n, jdtype),
                          rel=1e-12)


def test_h100_ridges():
    h = perf_model.H100
    assert perf_model.t2_threshold(h, BF16) == pytest.approx(590.4, abs=0.1)
    assert perf_model.t2_threshold(h, F32) == pytest.approx(80.0)
    assert perf_model.t2_threshold(h, I8) == pytest.approx(590.7, abs=0.1)
    assert h.peak_flops(I8) == h.peak_ops_int8


@pytest.mark.parametrize("shape,dtype,want", [
    ((8192, 4096, 256), BF16, "memory"),      # chatglm3's wk/wv prefill
    ((8192, 4096, 1024), BF16, "compute"),    # past the ridge (~330 wide)
    ((65024, 4096, 4), F32, "memory"),        # PowerSGD's P
    ((4096, 65024, 4), F32, "memory"),        # PowerSGD's Q, as X^T Y
    ((4, 65024, 4), F32, "memory"),           # the TSQR Gram
    ((65024, 4, 4), F32, "latency"),          # the TSQR apply
    ((1 << 20, 16, 16), F32, "latency"),      # the paper's TSM2L
    ((1 << 20, 16, 16), BF16, "latency"),
    ((1 << 20, 256, 16), F32, "memory"),      # rows of 1 KB: a full ring
    ((1 << 20, 128, 4), F32, "memory"),       # k > 16 n
    ((8192, 4096, 256), I8, "memory"),
    ((8192, 4096, 4096), F32, "compute"),
])
def test_bound_class_on_h100_shapes(shape, dtype, want):
    assert tsmm.bound_class(*shape, dtype) == want
    assert perf_model.classify(*shape, perf_model.H100, dtype) == want


def test_bound_class_under_int8_policy():
    # f32 compute-bound at 64 wide (31 flop/B over a ridge of 20); int8
    # moves a quarter of the bytes (125 op/B) under a ridge of 591
    shape = (8192, 4096, 64)
    assert tsmm.bound_class(*shape, F32) == "compute"
    assert tsmm.bound_class(*shape, F32,
                            tsmm.GemmPolicy(quant="int8")) == "memory"
