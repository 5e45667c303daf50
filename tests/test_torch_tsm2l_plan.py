"""tsm2l's and tsm2l_q8's choice of body, on the CPU.

Both kernels run one of two bodies, decided from the shape, the dtype and
A's alignment before the launch: "stream" (``csrc/tsm2l_stream.cuh``:
persistent blocks, row tiles of A through a ring of 1-D bulk copies, each
thread all n outputs of its rows) for n in 1..16 and k in 1..256 with a
16-byte aligned A, in f32, bf16 and int8; "tile" (``csrc/common.cuh``'s
``tsm2l_kernel``) for everything else. The C queries ``tsm2l_plan`` and
``tsm2l_q8_plan`` run only on the card, where ``chip_smoke.py`` holds
them against ``perf_model.tsm2l_plan``. Here: that mirror's bodies, grids
and stream geometry case by case, the launch record a dispatch leaves,
and the plain versions against the JAX package's kernels (Pallas in
interpret mode) at the stream body's shapes: f32 at rtol 1e-3, atol 1e-4
and bf16 at rtol = atol = 2e-2 (the JAX kernel tests'), int8 bit for bit
(k <= 256 keeps every integer sum exact in f32 on the JAX side).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as jquant
from repro.kernels.tsm2l import tsm2l_pallas
from repro_torch.core import perf_model, tsmm
from repro_torch.kernels import ref

F32, BF16, I8 = torch.float32, torch.bfloat16, torch.int8
SIZES = {F32: 4, BF16: 2, I8: 1}
SMS = perf_model.H100.n_sms     # 132: 264 persistent blocks


@pytest.mark.parametrize("dtype", [F32, BF16, I8], ids=str)
@pytest.mark.parametrize("n", [1, 3, 4, 8, 16, 17])
@pytest.mark.parametrize("k", [1, 4, 16, 77, 256, 300])
def test_body_and_grid_case_by_case(k, n, dtype):
    m = 10000                                   # ragged at every tile
    body, grid = perf_model.tsm2l_plan(m, k, n, dtype)
    if n <= 16 and k <= 256:
        geo = perf_model.tsm2l_stream_geometry(k, n, dtype)
        assert body == "stream"
        assert grid == (min(-(-m // geo["block_m"]), 2 * SMS), 1, 1)
    else:
        bm, bn = perf_model.tsm2l_tile(n)
        assert body == "tile"
        assert grid == (-(-m // bm), -(-n // bn), 1)


@pytest.mark.parametrize("dtype", [F32, BF16, I8], ids=str)
@pytest.mark.parametrize("ptr_a", [0, 16, 4096, 2, 4, 8])
def test_a_misaligned_base_takes_the_tile_body(ptr_a, dtype):
    body, grid = perf_model.tsm2l_plan(4096, 16, 16, dtype, ptr_a)
    assert body == ("stream" if ptr_a % 16 == 0 else "tile")
    if body == "tile":
        assert grid == (16, 1, 1)


def test_a_misaligned_view_takes_the_tile_body():
    buf = torch.zeros(4096 * 16 + 4)
    view = buf[4:].view(4096, 16)       # 16 bytes in: still aligned
    off = buf[1:4097 * 16 - 15].view(4096, 16)   # 4 bytes in
    assert view.data_ptr() % 16 == buf.data_ptr() % 16 == 0
    assert perf_model.tsm2l_body(16, 16, F32, view.data_ptr()) == "stream"
    assert perf_model.tsm2l_body(16, 16, F32, off.data_ptr()) == "tile"


@pytest.mark.parametrize("m,want", [
    (1, 1), (256, 1), (257, 2), (102400, 264), (10 ** 7, 264),
    (264 * 256, 264), (263 * 256 + 1, 264), (100 * 256 - 3, 100)])
def test_stream_grid_is_persistent_over_ragged_m(m, want):
    # k = n = 16 f32: 256-row tiles (2 rows a thread of 64 bytes, one
    # group).
    assert perf_model.tsm2l_plan(m, 16, 16, F32)[1] == (want, 1, 1)


def test_stream_grid_follows_the_cards_sms():
    spec = perf_model.GPUSpec(n_sms=114)
    assert perf_model.tsm2l_plan(10 ** 7, 16, 16, F32, spec=spec)[1] == (
        228, 1, 1)


@pytest.mark.parametrize("dtype,out", [(F32, None), (BF16, None),
                                       (I8, F32), (I8, BF16)], ids=str)
@pytest.mark.parametrize("k", [1, 3, 4, 8, 16, 33, 64, 77, 128, 129, 255,
                               256])
@pytest.mark.parametrize("n", [1, 3, 16])
def test_stream_geometry_keeps_its_invariants(k, n, dtype, out):
    g = perf_model.tsm2l_stream_geometry(k, n, dtype, out)
    rs = k * SIZES[dtype]
    assert g["rows"] == (4 if rs <= 32 else 2 if rs <= 256 else 1)
    assert g["groups"] in (1, 2, 4)
    assert g["block_m"] == 128 // g["groups"] * g["rows"]
    # Every full eighth of a tile is whole 16-byte units: one bulk copy.
    assert g["block_m"] // 8 * rs % 16 == 0
    assert g["vec"] == (rs % 16 == 0)
    assert 2 <= g["stages"] <= 6
    assert g["smem"] <= perf_model.STREAM_SMEM_BYTES   # two blocks an SM
    # A stage aims at 16 KB; past it only at four groups, or where twice
    # the groups would cut the tile into eighths of odd bytes.
    assert g["block_m"] * rs <= 16384 or g["groups"] == 4 or (
        g["block_m"] // 16 * rs % 16)


@pytest.mark.parametrize("k,n,dtype,want", [
    (16, 16, F32, (2, 1, 256)),     # the paper's shape: 16 KB stages
    (16, 16, BF16, (4, 1, 512)),    # 32-byte rows: 4 rows a thread
    (16, 16, I8, (4, 1, 512)),
    (4, 4, F32, (4, 1, 512)),       # the table's launch-bound shape
    (33, 3, F32, (2, 4, 64)),
    (64, 16, F32, (2, 4, 64)),      # 256-byte rows: four groups
    (77, 1, F32, (1, 4, 32)),       # 308-byte rows: one row a thread
    (256, 16, F32, (1, 4, 32)),
    (129, 16, BF16, (1, 2, 64)),    # eighths of 32 odd rows: two groups
    (255, 9, I8, (2, 2, 128)),
    (1, 16, F32, (4, 1, 512)),
])
def test_stream_geometry_cases(k, n, dtype, want):
    g = perf_model.tsm2l_stream_geometry(k, n, dtype)
    assert (g["rows"], g["groups"], g["block_m"]) == want


def test_sweep_rows_override_the_default():
    for rows, groups in ((1, 1), (2, 1), (4, 2), (8, 4)):
        g = perf_model.tsm2l_stream_geometry(16, 16, F32, rows=rows)
        assert (g["rows"], g["groups"]) == (rows, groups)
        assert g["block_m"] * 64 <= 16384


@pytest.mark.parametrize("quant,kind", [("none", "tsm2l"),
                                        ("int8", "tsm2l_q8")])
def test_dispatch_records_the_plans_grid(quant, kind):
    a, b = torch.randn(102400, 4), torch.randn(4, 4)
    with tsmm.policy(quant=quant), tsmm.record_dispatches() as log:
        tsmm.tsmm(a, b)
    (launch,) = log[0].launches
    assert launch.kind == kind and launch.splits == 1
    # 200 row tiles of 512 rows (f32's and int8's rows of 16 and 4 bytes:
    # 4 rows a thread), one a block.
    assert launch.grid == (200, 1, 1)


def test_dispatch_records_the_tile_grid_past_the_stream_body():
    a, b = torch.randn(4096, 64), torch.randn(64, 32)
    with tsmm.record_dispatches() as log:
        tsmm.tsmm(a, b, mode="tsm2l")
    assert log[0].launches[0].grid == (64, 1, 1)


def _pair(seed, shape, dtype):
    x = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    return torch.from_numpy(x).to(dtype), jnp.asarray(x).astype(jdt)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=str)
@pytest.mark.parametrize("k,n", [(16, 16), (8, 8), (4, 4), (1, 16),
                                 (77, 1), (3, 5), (256, 16), (129, 3)])
def test_plain_version_matches_tsm2l_pallas(k, n, dtype):
    m = 1024
    a, ja = _pair(k * 31 + n, (m, k), dtype)
    b, jb = _pair(k * 31 + n + 1, (k, n), dtype)
    assert perf_model.tsm2l_body(k, n, dtype) == "stream"
    want = tsm2l_pallas(ja, jb, block_m=256, interpret=True)
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == BF16
           else dict(rtol=1e-3, atol=1e-4))
    np.testing.assert_allclose(ref.tsm2l_ref(a, b).float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def _t(x):
    arr = np.array(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@pytest.mark.parametrize("out", [F32, BF16], ids=str)
@pytest.mark.parametrize("k,n", [(16, 16), (4, 4), (1, 16), (77, 1),
                                 (256, 16), (255, 9)])
def test_q8_plain_version_is_bit_equal_to_tsm2l_q8_pallas(k, n, out):
    m, band = 1024, 256
    _, ja = _pair(k * 17 + n, (m, k), F32)
    _, jb = _pair(k * 17 + n + 1, (k, n), F32)
    jaq, jas = jquant.quantize_blocks(ja, band)
    jbq, jbs = jquant.quantize_tensor(jb)
    assert perf_model.tsm2l_body(k, n, I8) == "stream"
    jdt = jnp.bfloat16 if out == BF16 else jnp.float32
    want = jquant.tsm2l_q8_pallas(jaq, jbq, jas, jbs, out_dtype=jdt,
                                  block_m=band, interpret=True)
    got = ref.tsm2l_q8_ref(*(_t(v) for v in (jaq, jbq, jas, jbs)), band, out)
    assert got.dtype == out
    assert torch.equal(got, _t(want))
