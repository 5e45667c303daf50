"""The sequential TSMT kernels' plan of m slices, on the CPU.

``tsmt`` and ``tsmt_q8`` spread the m reduction over the card in one
launch: ``perf_model.tsmt_slices`` plans S slices, each block reduces its
slice into f32 partials, and each output tile's last block sums the S
partials in slice order from zero and casts once. The CUDA kernels run
only on the card (``chip_smoke.py`` holds them bit for bit against the
split kernels' partials summed that way). Here: the plan's invariants at
the data sheet's 132 SMs, and that order emulated with the split kernels'
plain versions against the JAX package's ``tsmt`` and int8 ``tsmt``
(Pallas in interpret mode, as ``tests/test_torch_kernels.py`` and
``tests/test_torch_quant.py`` run them). Tolerances are the JAX kernel
tests': f32 rtol=1e-3, atol=1e-4; bf16 rtol=atol=2e-2. The two sum the
same products in another order, so they agree to f32 rounding.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro_torch.core import perf_model, tsmm
from repro_torch.kernels import ref
from repro_torch.kernels import tsmt as k_tsmt

H100 = perf_model.H100
BAND = perf_model.Q8_BAND
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
SHAPES = [(65536, 128, 4), (1 << 20, 128, 4), (65536, 256, 256),
          (65024, 4096, 4), (4099, 100, 1), (10000, 300, 20), (300, 16, 4),
          (0, 8, 4), (8, 4, 4), (65536, 8192, 256)]


def _tol(name):
    return (dict(rtol=2e-2, atol=2e-2) if name == "bf16"
            else dict(rtol=1e-3, atol=1e-4))


def _np(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _tiles(a, b):
    ga, gb, _ = perf_model.tsmt_grid(0, a, b)
    return ga * gb


def _in_order(parts, dtype):
    """The last block's sum: slice by slice from f32 zeros, cast once."""
    acc = torch.zeros_like(parts[0])
    for p in parts:
        acc += p
    return acc.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("shape", SHAPES)
def test_slices_are_whole_quanta_and_cover_m(shape, dtype):
    m, a, b = shape
    s, slice_ = perf_model.tsmt_slices(m, a, b, H100, dtype)
    quantum = BAND if dtype == torch.int8 else perf_model.TSMT_BLOCK_M
    assert s >= 1 and slice_ % quantum == 0
    # The split kernels' convention, so they cut m the same way.
    assert slice_ == ref.split_len(m, s, quantum)
    assert s * slice_ >= m
    assert (s - 1) * slice_ < m or s == 1      # no slice is empty
    if s > 1:
        assert slice_ >= perf_model.TSMT_MIN_SLICE_ROWS


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("shape", SHAPES)
def test_grid_stays_within_the_target_wave(shape, dtype):
    m, a, b = shape
    s, _ = perf_model.tsmt_slices(m, a, b, H100, dtype)
    assert H100.n_sms == 132
    assert s == 1 or _tiles(a, b) * s <= (perf_model.TSMT_BLOCKS_PER_SM
                                          * H100.n_sms)


@pytest.mark.parametrize("m,a,b,why", [
    (perf_model.TSMT_MIN_SLICE_ROWS * 2 - 8, 128, 4, "short m"),
    (300, 16, 4, "short m"),
    (1 << 20, 8192, 256, "512 tiles fill the card"),
    (65536, 16384, 16, "256 tiles fill the card"),
])
def test_one_slice_for_short_m_or_a_full_grid(m, a, b, why):
    assert perf_model.tsmt_slices(m, a, b, H100) == (1, ref.split_len(
        m, 1, perf_model.TSMT_BLOCK_M)), why


def test_one_tile_spreads_over_the_card():
    s, _ = perf_model.tsmt_slices(65536, 128, 4, H100)
    s8, _ = perf_model.tsmt_slices(65536, 128, 4, H100, torch.int8)
    assert s > 1 and s8 > 1
    # Fewer SMs, fewer slices; an int8 plan honours the band it is given.
    small = dataclasses.replace(H100, n_sms=8)
    assert perf_model.tsmt_slices(65536, 128, 4, small)[0] <= (
        perf_model.TSMT_BLOCKS_PER_SM * 8)
    assert perf_model.tsmt_slices(65536, 128, 4, H100, torch.int8,
                                  quantum=64)[1] % 64 == 0


def test_workspace_holds_partials_and_counters():
    assert k_tsmt._workspace(1, 128, 4, torch.device("cpu")) is None
    ws = k_tsmt._workspace(5, 100, 20, torch.device("cpu"))
    assert ws.dtype == torch.float32
    assert ws.numel() == 5 * 100 * 20 + _tiles(100, 20)


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("m,a,b", [
    (8192, 64, 4),        # one output tile
    (10000, 300, 16),     # ragged everywhere, 5 tiles
    (8192, 16, 1),
])
def test_slice_order_matches_jax_tsmt(m, a, b, name):
    x = _np(m + a + b, (m, a))
    y = _np(m + a + b + 1, (m, b))
    tdt, jdt = DTYPES[name]
    tx, ty = torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt)
    s, _ = perf_model.tsmt_slices(m, a, b, H100, tdt)
    assert s > 1
    got = _in_order(ref.tsmt_split_ref(tx, ty, s, perf_model.TSMT_BLOCK_M),
                    tdt)
    want = jops.tsmt(jnp.asarray(x).astype(jdt), jnp.asarray(y).astype(jdt),
                     interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(name))


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("m,a,b", [(8192, 128, 8), (5120, 128, 4)])
def test_slice_order_matches_jax_int8_tsmt(m, a, b, out):
    jx = jnp.asarray(_np(m + a, (m, a)))
    jy = jnp.asarray(_np(m + a + 1, (m, b)))
    (jxq, jxs), (jyq, jys) = (jquant.quantize_blocks(jx, BAND),
                              jquant.quantize_blocks(jy, BAND))
    t = [torch.from_numpy(np.array(v)) for v in (jxq, jyq, jxs, jys)]
    tdt, jdt = DTYPES[out]
    s, slice_ = perf_model.tsmt_slices(m, a, b, H100, torch.int8)
    assert s > 1 and slice_ % BAND == 0
    got = _in_order(ref.tsmt_q8_split_ref(*t, BAND, s), tdt)
    want = jquant.tsmt_q8_pallas(jxq, jyq, jxs, jys, out_dtype=jdt,
                                 block_m=BAND, block_a=128, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **_tol(out))


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("split", ["never", "auto", 1])
def test_dispatch_records_the_planned_grid(split, quant):
    x = torch.from_numpy(_np(1, (8192, 64)))
    y = torch.from_numpy(_np(2, (8192, 4)))
    dtype = torch.int8 if quant == "int8" else torch.float32
    s, _ = perf_model.tsmt_slices(8192, 64, 4, H100, dtype)
    with tsmm.policy(split=split, quant=quant), \
            tsmm.record_dispatches() as log:
        tsmm.tsmm_t(x, y)
    (launch,) = log[0].launches
    assert launch.kind == ("tsmt_q8" if quant == "int8" else "tsmt")
    # No split-K op: the sequential kernel's own plan sets the grid.
    assert launch.splits == 1 and s > 1
    assert launch.grid == (1, 1, s)


def test_dispatch_records_a_split_as_before():
    x = torch.from_numpy(_np(3, (8192, 64)))
    y = torch.from_numpy(_np(4, (8192, 4)))
    with tsmm.policy(split=4), tsmm.record_dispatches() as log:
        tsmm.tsmm_t(x, y)
    assert [(lm.kind, lm.grid, lm.splits) for lm in log[0].launches] == [
        ("tsmt", (1, 1, 4), 4)]
