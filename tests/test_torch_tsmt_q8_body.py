"""The int8 TSMT kernels' choice of block body, on the CPU.

tsmt_q8 and tsmt_q8_split run one of two block bodies, decided before the
launch from the operands alone: "packed" (``csrc/tsmt_q8_packed.cuh``:
8 bytes of a row of X a thread in one load, four rows a ``__dp4a`` after
a 4 x 4 byte transpose) for b in {4, 8, 12, 16} with a a multiple of 16
and 16-byte aligned X and Y; "simt" (``csrc/common.cuh``'s
``tsmt_block``) for every other call. The rule reads neither m nor the
number of slices, so both kernels take the same body for the same
operands, which keeps tsmt_q8 bit-equal to tsmt_q8_split's partials summed
in slice order. The C queries ``tsmt_q8_plan`` and ``tsmt_q8_split_plan``
run only on the card, where ``chip_smoke.py`` holds them against
``perf_model.tsmt_q8_plan``. Here: that mirror case by case (the
``chip_smoke.py`` cases against its ``TSMT_Q8_PACKED``), what it does to
the performance model and the chooser, and the layout probe's exact
answer on the plain version, held against the JAX package's int8 TSMT
(Pallas in interpret mode) bit for bit: every product is a code times 0
or 1, so the f32 sums are exact.
"""

import importlib.util
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as jquant
from repro_torch.core import perf_model
from repro_torch.kernels import ref

I8 = torch.int8
BAND = perf_model.Q8_BAND
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_consts", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)    # defines constants; runs no phase
    return mod


# chip_smoke.py's int8 TSMT cases, (m, a, b, S): tsmt_q8 at S = 1 (its
# own plan sets the slices) and tsmt_q8_split at a pinned S.
CHIP_CASES = [(65536, 128, 4, 1), (10000, 300, 20, 1), (300000, 16, 4, 1),
              (1000, 100, 3, 1), (65024, 4096, 4, 8), (1 << 20, 128, 4, 32),
              (10000, 300, 20, 3), (300000, 16, 4, 2)]


@pytest.mark.parametrize("m,a,b,splits", CHIP_CASES)
def test_chip_smoke_cases_take_the_body_it_expects(m, a, b, splits):
    packed = _chip_smoke().TSMT_Q8_PACKED
    want = "packed" if (m, a, b) in packed else "simt"
    body, grid = perf_model.tsmt_q8_plan(m, a, b)
    assert body == want
    assert grid == perf_model.tsmt_grid(m, a, b, splits)[:2]


def test_powersgd_q_and_the_dispatch_shape_take_the_packed_body():
    assert perf_model.tsmt_q8_body(4096, 4) == "packed"     # Q, rank 4
    assert perf_model.tsmt_q8_body(128, 4) == "packed"      # dispatch path
    assert _chip_smoke().TSMT_Q8_SPLIT_MAX_MS < 0.266       # the simt body's


@pytest.mark.parametrize("b,body", [
    (1, "simt"), (2, "simt"), (3, "simt"), (4, "packed"), (5, "simt"),
    (6, "simt"), (8, "packed"), (12, "packed"), (15, "simt"),
    (16, "packed"), (17, "simt"), (20, "simt"), (64, "simt"),
])
def test_body_by_output_width(b, body):
    assert perf_model.tsmt_q8_body(4096, b) == body


@pytest.mark.parametrize("a,body", [
    (16, "packed"), (128, "packed"), (144, "packed"), (4096, "packed"),
    (8, "simt"), (100, "simt"), (136, "simt"), (300, "simt"), (0, "simt"),
])
def test_body_needs_rows_of_x_in_whole_16_bytes(a, body):
    assert perf_model.tsmt_q8_body(a, 4) == body


@pytest.mark.parametrize("ptr_x,ptr_y,body", [
    (0, 0, "packed"), (16, 48, "packed"), (8, 0, "simt"), (4, 0, "simt"),
    (0, 4, "simt"), (0, 8, "simt"), (1, 1, "simt"),
])
def test_body_needs_aligned_bases(ptr_x, ptr_y, body):
    assert perf_model.tsmt_q8_body(128, 4, ptr_x, ptr_y) == body


@pytest.mark.parametrize("operand", ["x", "y"])
def test_misaligned_view_keeps_the_simt_body(operand):
    flat = torch.zeros(64 * 128 + 16, dtype=I8)
    off = flat[8:8 + 64 * 128]
    x = off.view(64, 128) if operand == "x" else torch.zeros((64, 128),
                                                              dtype=I8)
    y = off[:64 * 4].view(64, 4) if operand == "y" else torch.zeros(
        (64, 4), dtype=I8)
    assert x.is_contiguous() and y.is_contiguous()
    assert perf_model.tsmt_q8_body(128, 4, x.data_ptr(),
                                   y.data_ptr()) == "simt"
    back = flat[16:16 + 63 * 128]           # back on the 16-byte grid
    x2 = back.view(63, 128) if operand == "x" else x
    y2 = back[:63 * 4].view(63, 4) if operand == "y" else y[:63]
    assert perf_model.tsmt_q8_body(128, 4, x2.data_ptr(),
                                   y2.data_ptr()) == "packed"


@pytest.mark.parametrize("splits", [1, 2, 8, 32, 128])
@pytest.mark.parametrize("m", [1000, 65024, 65536, 1 << 20])
def test_body_reads_neither_m_nor_the_slices(m, splits):
    params = inspect.signature(perf_model.tsmt_q8_body).parameters
    assert list(params) == ["a", "b", "ptr_x", "ptr_y"]
    for a, b in [(4096, 4), (128, 4), (300, 20), (100, 3), (64, 16)]:
        body, grid = perf_model.tsmt_q8_plan(m, a, b)
        assert body == perf_model.tsmt_q8_plan(1, a, b)[0]
        assert grid == perf_model.tsmt_grid(m, a, b, splits)[:2]


def test_chooser_and_slice_plan_stay_where_they_were():
    """PowerSGD's Q resolves to the one-launch tsmt_q8 (S = 1), whose own
    plan is the 8 slices the split kernel ran at, now that S = 1 is
    priced as that kernel runs; tsmt_q8's plan at the dispatch path's
    shape stays where it was."""
    spec = perf_model.H100
    assert perf_model.choose_splits_tsmt(65024, 4096, 4, spec, I8) == 1
    assert perf_model.tsmt_slices(65024, 4096, 4, spec, I8) == (8, 8192)
    assert perf_model.tsmt_slices(65536, 128, 4, spec, I8,
                                  quantum=BAND) == (128, 512)


def test_model_prices_the_packed_body_at_the_dp4a_rate():
    spec = perf_model.H100
    m, a, b = 65024, 4096, 4
    ga, gb, _ = perf_model.tsmt_grid(m, a, b, 8)
    nbytes = (m * a * gb + m * b * ga + a * b
              + perf_model.split_partials_bytes(8, a, b))
    t_comp = 2.0 * m * a * b / spec.peak_ops_dp4a
    # The split kernel and its epilogue op: two launches.
    want = max(nbytes / spec.hbm_bw, t_comp) + 2 * spec.launch_s
    assert perf_model.tsmt_model_time(m, a, b, spec, I8,
                                      splits=8) == pytest.approx(want)
    # S = 1 is the one-launch kernel at its plan of the same 8 slices: the
    # same bytes, one launch.
    assert perf_model.tsmt_model_time(m, a, b, spec, I8) == \
        pytest.approx(want - spec.launch_s)
    # The simt body (b = 20) keeps one multiply-add a product.
    simt = perf_model.tsmt_model_time(8192, 4096, 20, spec, I8)
    assert simt >= 2.0 * 8192 * 4096 * 20 / spec.peak_ops_imad


def _probe_rows(b, m=1000):
    """chip_smoke.py's probe rows: every position of a 4-row packet, and
    different groups, packets and bands of the default variant."""
    ta, tb = perf_model.tsmt_tile(b)
    groups = 256 // ((ta // 8) * (tb // 4))
    sel = [BAND * (j if b == 4 else j // 4)
           + 4 * ((3 * j + 1) % groups + groups * (3 * j % 4)) + j % 4
           for j in range(b)]
    assert len(set(sel)) == b and max(sel) < m
    return sel, groups


@pytest.mark.parametrize("b", [4, 16])
def test_layout_probe_rows_cover_packet_positions_and_groups(b):
    sel, groups = _probe_rows(b)
    assert groups == (16 if b == 4 else 8)
    assert sorted({r % 4 for r in sel}) == [0, 1, 2, 3]
    band_groups = {(r // BAND, (r % BAND) // 4 % groups) for r in sel}
    assert len(band_groups) == b          # no two rows share a group's band


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("b", [4, 16])
def test_layout_probe_is_exact_on_the_plain_version_and_jax(b, splits):
    m, a = 1000, 144
    sel, _ = _probe_rows(b, m)
    rows = np.arange(m)[:, None]
    x = ((rows * 13 + np.arange(a) * 5) % 255 - 127).astype(np.int8)
    y = np.zeros((m, b), np.int8)
    y[sel, np.arange(b)] = 1
    ones = np.ones((-(-m // BAND), 1), np.float32)
    t = [torch.from_numpy(v) for v in (x, y, ones, ones)]
    want = x[sel].T.astype(np.float32)
    got = ref.tsmt_q8_split_ref(*t, BAND, splits).sum(0)
    np.testing.assert_array_equal(got.numpy(), want)
    jax_out = jquant.tsmt_q8_pallas(
        jnp.asarray(np.pad(x, ((0, 24), (0, 0)))),
        jnp.asarray(np.pad(y, ((0, 24), (0, 0)))), jnp.asarray(ones),
        jnp.asarray(ones), out_dtype=jnp.float32, block_m=BAND,
        block_a=16, interpret=True)
    np.testing.assert_array_equal(np.asarray(jax_out), want)


def test_resource_report_is_parsed_kernel_by_kernel():
    """``chip_smoke.py`` gates on ``_build.resource_usage``: no int8 TSMT
    kernel may spill. Its parser on ptxas's report of two kernels."""
    from repro_torch.kernels import _build

    name = ("_ZN43_GLOBAL__N__0848233c_10_tsmt_q8_cu_da0e7f3414tsmt_q8_kernel"
            "I13__nv_bfloat16Li128ELi4ELi4ELi4ELi8ELb1ELb1EEEvPKaS2_PT_iiiii"
            "PfPjN5tsm2x8BandFoldE")
    split = ("_ZN49_GLOBAL__N__8ed6e03a_16_tsmt_q8_split_cu_c7e4804220tsmt_q8"
             "_split_kernelILi64ELi16ELi4ELi4ELi4ELb0ELi8ELi16EEEvPKaS2_Pf"
             "iiiiN5tsm2x8BandFoldE")
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
        f"ptxas info    : Function properties for {name}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 124 registers, used 1 barriers, 32769 bytes "
        "smem, 400 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{split}' for 'sm_90a'",
        f"ptxas info    : Function properties for {split}",
        "    8 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 16384 bytes smem",
    ])
    assert _build.parse_resources("x", log) == [
        {"source": "x", "kernel": "tsmt_q8_kernel<bf16,128,4,4,4,8,1,1>",
         "spilled_bytes": 0, "registers": 124, "static_shared_bytes": 32769},
        {"source": "x", "kernel": "tsmt_q8_split_kernel<64,16,4,4,4,0,8,16>",
         "spilled_bytes": 12, "registers": 128,
         "static_shared_bytes": 16384}]
