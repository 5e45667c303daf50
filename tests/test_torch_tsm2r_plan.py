"""tsm2r's, tsm2r_split's and tsm2r_q8's choice of body, on the CPU.

The sequential tsm2r kernel runs one of three bodies, decided from the
shape, the dtype and the operands' alignment before the launch: "wgmma"
(TMA loads and tensor-core products, ``csrc/tsm2r_wgmma.cuh``) for bf16
outputs wider than 16 whose k and n are multiples of 8 and whose bases
are 16-byte aligned; "skinny" (TMA-fed, each thread all n outputs of its
rows, ``csrc/tsm2r_skinny.cuh``) for f32 and bf16 outputs at most 16
wide whose rows of A are whole 16-byte chunks and whose A is 16-byte
aligned; "simt" (the CUDA-core body of ``csrc/common.cuh``) for
everything else. The split kernel takes "skinny" under the same
conditions at any S (its slices are multiples of 32 k), else "simt".
tsm2r_q8 likewise: "wgmma" (``csrc/tsm2r_q8_wgmma.cuh``) for int8 outputs
wider than 16 whose k is a multiple of 16, with aligned bases of A and
of the K-major B it reads; "skinny" (the streaming body's int8 stage)
for int8 outputs at most 16 wide whose k is a multiple of 16 and whose A
is 16-byte aligned, sequential or split; else "simt". The C queries
``tsm2r_plan``, ``tsm2r_split_plan``, ``tsm2r_q8_plan`` and
``tsm2r_q8_split_plan`` run only on the card, where ``chip_smoke.py``
holds them against ``perf_model.tsm2r_plan``. Here:
that mirror's bodies and grids case by case, what it does to the
performance model and the dispatch record, and the plain versions against
the JAX package's kernels (Pallas in interpret mode) at shapes the wgmma
and the skinny bodies take: tsm2r at bf16's rtol = atol = 2e-2 and f32's
1e-4, the int8 tsm2r_q8 and tsm2r_q8_split bit for bit (k <= 1,024 keeps
every partial sum below 2^24, so the JAX kernels' f32 sums are exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tsmm as jtsmm
from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro_torch.core import perf_model, tsmm
from repro_torch.kernels import ops, ref

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("shape,dtype,ptrs,body,grid", [
    # bf16, n > 16, aligned: the wgmma body, 64 x 128 tiles.
    ((8192, 4096, 256), BF16, (0, 0), "wgmma", (128, 2, 1)),   # serving
    ((4096, 4096, 256), BF16, (0, 0), "wgmma", (64, 2, 1)),    # training
    ((1000, 776, 200), BF16, (64, 1024), "wgmma", (16, 2, 1)),  # ragged
    ((4096, 4096, 24), BF16, (0, 0), "wgmma", (64, 1, 1)),     # narrowest
    # f32: simt, 64 x 64 tiles past n = 16.
    ((8192, 4096, 256), F32, (0, 0), "simt", (128, 4, 1)),
    # n <= 16: the skinny body, 128-row blocks (the simt table's grid).
    ((65024, 4096, 4), F32, (0, 0), "skinny", (508, 1, 1)),     # P
    ((4096, 4096, 16), BF16, (0, 0), "skinny", (32, 1, 1)),
    ((16384, 16384, 16), BF16, (0, 0), "skinny", (128, 1, 1)),
    ((512, 512, 1), BF16, (0, 0), "skinny", (4, 1, 1)),
    # k or n not a multiple of 8: TMA's 16-byte strides fail.
    ((1000, 777, 200), BF16, (0, 0), "simt", (16, 4, 1)),
    ((4096, 4096, 20), BF16, (0, 0), "simt", (64, 1, 1)),
    # a base address off the 16-byte grid.
    ((1024, 1024, 256), BF16, (2, 0), "simt", (16, 4, 1)),
    ((1024, 1024, 256), BF16, (0, 8), "simt", (16, 4, 1)),
    # k = 0 has nothing to load.
    ((64, 0, 256), BF16, (0, 0), "simt", (1, 4, 1)),
])
def test_plan_body_and_grid(shape, dtype, ptrs, body, grid):
    assert perf_model.tsm2r_plan(*shape, dtype, *ptrs) == (body, grid)


def test_main_path_shapes_fill_the_card():
    blocks = {shape: int(np.prod(perf_model.tsm2r_plan(*shape, BF16)[1]))
              for shape in [(8192, 4096, 256), (4096, 4096, 256)]}
    assert blocks == {(8192, 4096, 256): 256, (4096, 4096, 256): 128}
    assert min(blocks.values()) >= perf_model.H100.n_sms * 0.95


def test_misaligned_view_takes_the_simt_body():
    flat = torch.zeros(64 * 64 + 1, dtype=BF16)
    a, b = flat[1:].view(64, 64), torch.zeros((64, 32), dtype=BF16)
    assert a.is_contiguous() and a.data_ptr() % 16 == 2
    assert perf_model.tsm2r_plan(64, 64, 32, BF16, a.data_ptr(),
                                 b.data_ptr())[0] == "simt"
    a = torch.zeros((64, 64), dtype=BF16)
    assert perf_model.tsm2r_plan(64, 64, 32, BF16, a.data_ptr(),
                                 b.data_ptr())[0] == "wgmma"


def test_split_and_int8_launches_keep_the_simt_table():
    # Split launches at n <= 16 take the skinny body, f32, bf16 and int8
    # alike, on the simt table's grid; split launches past n = 16 keep the
    # simt body and its table; the sequential int8 kernel at n > 16 runs
    # its wgmma body's 64 x 128 tiles.
    for dtype in (F32, BF16):
        assert perf_model.tsm2r_plan(16384, 16384, 16, dtype, splits=2) == (
            "skinny", (128, 1, 2))
        assert perf_model.tsm2r_plan(8192, 4096, 256, dtype, splits=4) == (
            "simt", (128, 4, 4))
    assert perf_model.tsm2r_plan(16384, 16384, 16, torch.int8,
                                 splits=2) == ("skinny", (128, 1, 2))
    assert perf_model.tsm2r_grid(8192, 4096, 256, 4, BF16) == (128, 4, 4)
    assert perf_model.tsm2r_grid(8192, 4096, 256, 4, torch.int8) == (
        128, 4, 4)
    assert perf_model.tsm2r_grid(8192, 4096, 256, 1, torch.int8) == (
        128, 2, 1)
    assert perf_model.tsm2r_grid(8192, 4096, 256) == (128, 4, 1)


def test_model_prices_each_body_at_its_rate():
    spec = perf_model.H100
    m, k, n = 8192, 4096, 256
    flops = 2.0 * m * k * n
    wide = perf_model.tsm2r_model_time(m, k, n, spec, BF16)
    simt = perf_model.tsm2r_model_time(m, k, n, spec, F32)
    # f32 is at least its FMA floor; bf16's tensor-core body is priced by
    # its bytes (A per column tile, B per row tile), below that floor.
    assert simt >= flops / spec.peak_flops_f32
    assert m * k * 2 / spec.hbm_bw <= wide < flops / spec.peak_flops_f32
    gm, gn, _ = perf_model.tsm2r_grid(m, k, n, 1, BF16)
    nbytes = 2 * (m * k * gn + k * n * gm + m * n)
    assert wide == pytest.approx(nbytes / spec.hbm_bw + spec.launch_s)


@pytest.mark.parametrize("shape,dtype,split", [
    ((8192, 4096, 256), BF16, False),
    ((4096, 4096, 256), BF16, False),
    ((65024, 4096, 4), F32, False),
    ((16384, 16384, 16), F32, True),
    ((16384, 16384, 16), BF16, True),
])
def test_split_chooser_routes_as_before(shape, dtype, split):
    """S > 1 is offered only at n <= 16 (SPLIT_MAX_WIDTH), where the body
    is simt either way, so pricing the wgmma body moves no route."""
    s = perf_model.choose_splits_tsm2r(*shape, perf_model.H100, dtype)
    assert (s > 1) == split


def test_dispatch_records_the_planned_grid():
    a = torch.zeros((1024, 512), dtype=BF16)
    b = torch.zeros((512, 32), dtype=BF16)
    with tsmm.policy(split="never", max_skinny=32, min_tall=32,
                     skinny_ratio=2), tsmm.record_dispatches() as log:
        tsmm.tsmm(a, b)
    (launch,) = log[0].launches
    assert launch.kind == "tsm2r"
    assert launch.grid == perf_model.tsm2r_plan(1024, 512, 32, BF16)[1] == (
        16, 1, 1)


@pytest.mark.parametrize("m,k,n", [(200, 136, 24), (130, 64, 136)])
def test_plain_version_matches_jax_at_wgmma_shapes(m, k, n):
    assert perf_model.tsm2r_plan(m, k, n, BF16)[0] == "wgmma"
    rng = np.random.default_rng(m + n)
    x = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    y = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    got = ops.tsm2r(torch.from_numpy(x).to(BF16), torch.from_numpy(y).to(BF16))
    want = jops.tsm2r(jnp.asarray(x).astype(jnp.bfloat16),
                      jnp.asarray(y).astype(jnp.bfloat16), interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


# ---------------------------------------------------------------------------
# The skinny body: f32 and bf16 at n <= 16, sequential and split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("splits", [1, 2, 8])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("n,body", [(1, "skinny"), (4, "skinny"),
                                    (16, "skinny"), (17, "simt")])
def test_skinny_body_by_dtype_and_width(n, body, dtype, splits):
    # n = 17 is past the body's widths; bf16 n = 17 is no multiple of 8,
    # so no wgmma either, and the split kernel has no wgmma body.
    bm = 128 if n <= 16 else 64                  # the simt table past 16
    assert perf_model.tsm2r_plan(4096, 4096, n, dtype, splits=splits) == (
        body, (4096 // bm, 1, splits))


@pytest.mark.parametrize("splits", [1, 2, 8])
@pytest.mark.parametrize("shape,dtype,body", [
    ((1000, 777, 16), F32, "simt"),      # 777 x 4 bytes: off the grid
    ((1000, 776, 16), F32, "skinny"),    # 776 x 4 = 3104: on it
    ((1000, 772, 16), BF16, "simt"),     # 772 x 2 = 1544: off it
    ((1000, 776, 16), BF16, "skinny"),
    ((1000, 4, 3), F32, "skinny"),       # one 16-byte chunk of k
    ((4096, 4000, 16), BF16, "skinny"),  # S = 5 slices of 800: mid-box
    ((64, 0, 16), F32, "simt"),          # k = 0 has nothing to stream
])
def test_skinny_body_needs_whole_chunks_of_k(shape, dtype, body, splits):
    assert perf_model.tsm2r_body(*shape[1:], dtype, splits=splits) == body
    assert perf_model.tsm2r_plan(*shape, dtype, splits=splits)[1] == (
        -(-shape[0] // 128), 1, splits)


@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("dtype,ptr_a,ptr_b,body", [
    (F32, 0, 0, "skinny"), (F32, 32, 0, "skinny"),
    (F32, 4, 0, "simt"), (F32, 8, 0, "simt"), (BF16, 2, 0, "simt"),
    # B is loaded by the threads: its base may lie anywhere.
    (F32, 0, 4, "skinny"), (BF16, 0, 2, "skinny"),
])
def test_skinny_body_needs_an_aligned_a(dtype, ptr_a, ptr_b, body, splits):
    assert perf_model.tsm2r_body(4096, 16, dtype, ptr_a, ptr_b,
                                 splits) == body


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_misaligned_view_of_a_leaves_the_skinny_body(dtype):
    flat = torch.zeros(64 * 64 + 1, dtype=dtype)
    a, b = flat[1:].view(64, 64), torch.zeros((64, 16), dtype=dtype)
    assert a.is_contiguous() and a.data_ptr() % 16 != 0
    for splits in (1, 2):
        assert perf_model.tsm2r_plan(64, 64, 16, dtype, a.data_ptr(),
                                     b.data_ptr(), splits)[0] == "simt"
        assert perf_model.tsm2r_plan(64, 64, 16, dtype, 0, b.data_ptr(),
                                     splits)[0] == "skinny"


@pytest.mark.parametrize("splits", [1, 2, 8])
def test_skinny_body_keeps_the_grid_and_the_price(splits):
    # 128 rows a block, as the simt table at n <= 16: the chooser's block
    # counts and its price do not move.
    for dtype in (F32, BF16):
        for shape in [(16384, 16384, 16), (65024, 4096, 4), (4096, 4000, 3)]:
            body, grid = perf_model.tsm2r_plan(*shape, dtype, splits=splits)
            assert body == "skinny"
            assert grid == perf_model.tsm2r_grid(*shape, splits) == (
                -(-shape[0] // 128), 1, splits)
            t = perf_model.tsm2r_model_time(*shape, perf_model.H100, dtype,
                                            splits=splits)
            m, k, n = shape
            assert t >= 2.0 * m * k * n / perf_model.H100.peak_flops_f32


@pytest.mark.parametrize("name,dtype,tol", [("f32", F32, 1e-4),
                                            ("bf16", BF16, 2e-2)])
@pytest.mark.parametrize("m,k,n,splits", [
    (200, 400, 3, 5),      # 96-deep slices: bf16's start mid-box
    (130, 1000, 1, 3),     # ragged m, a part box at the end
    (256, 512, 16, 1),     # the sequential kernel
    (300, 800, 4, 2),
])
def test_plain_version_matches_jax_at_skinny_shapes(m, k, n, splits, name,
                                                    dtype, tol):
    assert perf_model.tsm2r_plan(m, k, n, dtype, splits=splits)[0] == (
        "skinny")
    rng = np.random.default_rng(m + k + n)
    x = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    y = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    with tsmm.policy(split=splits, mode="tsm2r"), \
            tsmm.record_dispatches() as log:
        got = tsmm.tsmm(torch.from_numpy(x).to(dtype),
                        torch.from_numpy(y).to(dtype))
    with jtsmm.policy(split=splits, interpret=True, mode="tsm2r"):
        want = jtsmm.tsmm(jnp.asarray(x).astype(jdt),
                          jnp.asarray(y).astype(jdt))
    assert [(lm.kind, lm.splits) for lm in log[0].launches][0] == (
        "tsm2r", splits)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# tsm2r_q8: the int8 wgmma and skinny bodies
# ---------------------------------------------------------------------------

I8 = torch.int8


@pytest.mark.parametrize("shape,ptrs,body,grid", [
    # n > 16, k % 16 == 0, aligned: the wgmma body, 64 x 128 tiles.
    ((8192, 4096, 256), (0, 0), "wgmma", (128, 2, 1)),     # serve-int8
    ((4096, 4096, 256), (0, 0), "wgmma", (64, 2, 1)),      # train-int8
    ((1000, 784, 200), (64, 1024), "wgmma", (16, 2, 1)),   # ragged
    ((256, 270000, 32), (0, 0), "wgmma", (4, 1, 1)),       # past one s32
    ((4096, 4096, 17), (0, 0), "wgmma", (64, 1, 1)),       # any n > 16
    # n <= 16, k % 16 == 0, an aligned A: skinny, the simt table's grid.
    ((65024, 4096, 4), (0, 0), "skinny", (508, 1, 1)),     # PowerSGD's P
    ((4096, 4096, 16), (0, 0), "skinny", (32, 1, 1)),
    ((4096, 4096, 16), (0, 8), "skinny", (32, 1, 1)),      # B's base: any
    # k % 16 != 0: TMA's 16-byte strides of int8 fail.
    ((1000, 777, 17), (0, 0), "simt", (16, 1, 1)),
    ((1000, 776, 200), (0, 0), "simt", (16, 4, 1)),
    ((1000, 776, 16), (0, 0), "simt", (8, 1, 1)),
    # a base address off the 16-byte grid, of A or of the K-major B.
    ((1024, 1024, 256), (4, 0), "simt", (16, 4, 1)),
    ((1024, 1024, 256), (0, 8), "simt", (16, 4, 1)),
    ((1024, 1024, 16), (4, 0), "simt", (8, 1, 1)),
    ((64, 0, 256), (0, 0), "simt", (1, 4, 1)),
    ((64, 0, 16), (0, 0), "simt", (1, 1, 1)),
])
def test_int8_plan_body_and_grid(shape, ptrs, body, grid):
    assert perf_model.tsm2r_plan(*shape, I8, *ptrs) == (body, grid)


@pytest.mark.parametrize("shape,splits,body,grid", [
    ((65024, 4096, 4), 1, "skinny", (508, 1, 1)),      # train-int8's P
    ((16384, 16384, 16), 2, "skinny", (128, 1, 2)),
    ((4096, 65536, 16), 4, "skinny", (32, 1, 4)),      # tsm2r_q8_split
    ((8192, 4096, 256), 1, "wgmma", (128, 2, 1)),
    ((8192, 4096, 256), 4, "simt", (128, 4, 4)),
])
def test_int8_plans_take_the_skinny_body_at_n_le_16(shape, splits, body,
                                                    grid):
    assert perf_model.tsm2r_plan(*shape, I8, splits=splits) == (body, grid)


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("shape,body", [
    ((4096, 4096, 1), "skinny"),
    ((4096, 4096, 3), "skinny"),
    ((4096, 4096, 8), "skinny"),
    ((4096, 4096, 16), "skinny"),
    ((4096, 4000, 16), "skinny"),     # S = 5: 800-deep slices, mid-box
    ((1000, 1008, 4), "skinny"),      # a part box at the end
    ((1000, 776, 16), "simt"),        # k % 16 != 0
    ((1000, 777, 4), "simt"),
    ((4096, 4096, 17), "simt"),       # past the body's widths
])
def test_int8_skinny_body_by_width_and_chunks(shape, body, splits):
    # n = 17 runs the sequential kernel's wgmma body; the split kernel has
    # none, so it keeps the simt body and its 64-row tiles.
    m, k, n = shape
    want = "wgmma" if n > 16 and splits == 1 else body
    bm = 64 if want == "simt" and n > 16 else 128
    grid = (64, 1, 1) if want == "wgmma" else (-(-m // bm), 1, splits)
    assert perf_model.tsm2r_plan(*shape, I8, splits=splits) == (want, grid)


@pytest.mark.parametrize("splits", [1, 3])
def test_int8_misaligned_view_of_a_leaves_the_skinny_body(splits):
    flat = torch.zeros(64 * 64 + 16, dtype=I8)
    a, b = flat[4:4 + 64 * 64].view(64, 64), torch.zeros((64, 16), dtype=I8)
    assert a.is_contiguous() and a.data_ptr() % 16 == 4
    assert perf_model.tsm2r_plan(64, 64, 16, I8, a.data_ptr(), b.data_ptr(),
                                 splits)[0] == "simt"
    a = flat[16:16 + 63 * 64].view(63, 64)             # back on the grid
    assert a.data_ptr() % 16 == 0
    assert perf_model.tsm2r_plan(63, 64, 16, I8, a.data_ptr(), b.data_ptr(),
                                 splits)[0] == "skinny"


def test_int8_split_launches_run_simt():
    for s in (2, 4, 8):
        assert perf_model.tsm2r_body(4096, 256, I8, splits=s) == "simt"
        assert perf_model.tsm2r_grid(4096, 4096, 256, s, I8) == (64, 4, s)


def test_int8_misaligned_view_takes_the_simt_body():
    flat = torch.zeros(64 * 64 + 4, dtype=I8)
    a, bt = flat[4:].view(64, 64), torch.zeros((32, 64), dtype=I8)
    b = bt.t()                                # K-major [k, n]
    assert a.data_ptr() % 16 == 4 and b.data_ptr() % 16 == 0
    assert perf_model.tsm2r_plan(64, 64, 32, I8, a.data_ptr(),
                                 b.data_ptr())[0] == "simt"
    assert perf_model.tsm2r_plan(64, 64, 32, I8, 0, b.data_ptr())[0] == (
        "wgmma")
    b_off = flat[4:4 + 64 * 32].view(32, 64).t()
    assert perf_model.tsm2r_plan(64, 64, 32, I8, 0, b_off.data_ptr())[0] == (
        "simt")


def test_model_prices_int8_wgmma_at_the_int8_tensor_core_rate():
    spec = perf_model.H100
    assert spec.peak_ops_int8 == 1979e12
    m, k, n = 8192, 4096, 256
    ops_ = 2.0 * m * k * n
    wide = perf_model.tsm2r_model_time(m, k, n, spec, I8)
    gm, gn, _ = perf_model.tsm2r_grid(m, k, n, 1, I8)
    assert (gm, gn) == (128, 2)
    nbytes = m * k * gn + k * n * gm + m * n
    t_comp = ops_ / spec.peak_ops_int8
    assert wide == pytest.approx(max(nbytes / spec.hbm_bw, t_comp)
                                 + spec.launch_s)
    # The dp4a body (n <= 16, or k % 16 != 0) keeps its CUDA-core rate.
    narrow = perf_model.tsm2r_model_time(m, 4096, 16, spec, I8)
    assert narrow >= 2.0 * m * 4096 * 16 / spec.peak_ops_dp4a
    odd = perf_model.tsm2r_model_time(m, 4104, 256, spec, I8)
    assert odd >= 2.0 * m * 4104 * 256 / spec.peak_ops_dp4a > wide


@pytest.mark.parametrize("shape,split", [
    ((8192, 4096, 256), False),     # serve-int8 wk/wv
    ((4096, 4096, 256), False),     # train-int8 wk/wv
    ((65024, 4096, 4), False),      # train-int8 P
    ((16384, 16384, 16), False),    # the paper's shape: S = 1 under int8
    ((4096, 65536, 16), True),      # 32 row tiles: split
])
def test_int8_chooser_routes_as_before(shape, split):
    """Pricing the int8 bodies moves no route: S > 1 is offered only at
    n <= 16, where the skinny and the simt body are both priced at
    ``__dp4a``'s rate."""
    s = perf_model.choose_splits_tsm2r(*shape, perf_model.H100, I8)
    assert (s > 1) == split


def test_int8_dispatch_records_the_wgmma_grid_and_a_kmajor_b(monkeypatch):
    seen = []
    real = ops._tsm2r.tsm2r_q8

    def spy(a, b, *rest):
        seen.append(b.stride())
        return real(a, b, *rest)

    monkeypatch.setattr(ops._tsm2r, "tsm2r_q8", spy)
    a = torch.zeros((1024, 512), dtype=BF16)
    b = torch.zeros((512, 32), dtype=BF16)
    with tsmm.policy(split="never", quant="int8", max_skinny=32, min_tall=32,
                     skinny_ratio=2), tsmm.record_dispatches() as log:
        tsmm.tsmm(a, b)
        tsmm.tsmm(a, b[:, :16])
    assert log[0].launches[0].grid == (16, 1, 1)          # 64 x 128 tiles
    assert log[1].launches[0].grid == (8, 1, 1)           # 128-row skinny
    assert seen == [(1, 512), (16, 1)]       # K-major B, then row-major B


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 3, 4, 16])
@pytest.mark.parametrize("k,splits", [(1024, 1), (800, 5)])
def test_plain_int8_matches_jax_at_skinny_shapes(k, splits, n, out):
    """ref.tsm2r_q8_ref / tsm2r_q8_split_ref against the JAX int8 kernels in
    interpret mode, bit for bit: with k <= 1,024 every partial sum of
    int8 products stays below 2^24, so the JAX kernels' f32 sums are
    exact and both sides round the same integer once before the fold. The
    split case's 160-deep slices (S = 5 of k = 800) start in the middle of
    the skinny body's 128-deep int8 box."""
    m, band = 256, 64
    assert perf_model.tsm2r_plan(m, k, n, I8, splits=splits)[0] == "skinny"
    assert ref.split_len(k, splits, perf_model.TSM2R_BLOCK_K) * splits == k
    rng = np.random.default_rng(m + k + n)
    x = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    y = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    xq, xs = jquant.quantize_blocks(jnp.asarray(x), band)
    yq, ys = jquant.quantize_tensor(jnp.asarray(y))
    t = [torch.from_numpy(np.array(v)) for v in (xq, yq, xs, ys)]
    tdt, jdt = (BF16, jnp.bfloat16) if out == "bf16" else (F32, jnp.float32)
    if splits == 1:
        got = ref.tsm2r_q8_ref(*t, band, tdt)
        want = jquant.tsm2r_q8_pallas(xq, yq, xs, ys, out_dtype=jdt,
                                      block_m=band, block_k=128,
                                      interpret=True)
    else:
        # One k step a slice: the JAX kernel's per-step fold is then the
        # plain version's one fold of each slice's exact sum.
        got = ref.tsm2r_q8_split_ref(*t, band, splits,
                                     perf_model.TSM2R_BLOCK_K).to(tdt)
        want = jquant.tsm2r_q8_pallas_split(
            xq, yq, xs, ys, block_m=band, block_k=k // splits, splits=splits,
            interpret=True).astype(jdt)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
