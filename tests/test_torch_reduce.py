"""sum_partials in the port, on the CPU: its launch plan and its sums.

The kernel (``csrc/reduce.cu``) runs only on the card, where
``chip_smoke.py`` holds it bit for bit against the slice-order sum and
its C plan query against ``perf_model.reduce_plan``. Here:

* that mirror pinned at the stacks the card's sweep times: one vector of
  outputs a thread on the flat index (4 wide where rows * cols and the
  pointers allow, else 2, else 1), 128 threads a block, at most 8 blocks
  an SM, 8 slices a chunk; and the grid a dispatch records for the
  epilogue;
* the plain version as the slice-order sum, bit for bit against numpy's
  f32 adds in that order (the kernel's order, so its bits);
* the port's ``reduce.reduce_partials`` and ``reduce.sum_partials`` (its
  plain version on the CPU) against the JAX package's ``reduce_partials``
  and ``sum_partials_pallas`` in interpret mode, on inputs from numpy with
  a seed. Tolerances: f32 rtol = atol = 1e-5 (``tests/test_split.py``'s
  for these sums, which differ only in the order of at most 8 f32 adds),
  bf16 rtol = atol = 2e-2 (the JAX kernel tests' for bf16 outputs: one
  bf16 step is 2^-8 of the value, and two f32 sums in another order may
  round to neighbouring steps).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.reduce import reduce_partials as j_reduce_partials
from repro.kernels.reduce import sum_partials_pallas
from repro_torch.core import perf_model, tsmm
from repro_torch.kernels import reduce, ref

F32, BF16 = torch.float32, torch.bfloat16
DTYPES = {"f32": (F32, jnp.float32), "bf16": (BF16, jnp.bfloat16)}
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2,
                                                      atol=2e-2)}
CAP = perf_model.REDUCE_BLOCKS_PER_SM * perf_model.H100.n_sms   # 1,056


@pytest.mark.parametrize("stack,blocks", [
    ((2, 64, 16), 2),             # the launch floor: 256 vectors
    ((2, 16384, 16), 512),        # the dispatch path's stack
    ((8, 16384, 16), 512),
    ((5, 4096, 16), 128),
    ((16, 256, 256), 128),
    ((4, 8192, 256), CAP),        # past 8 blocks an SM: grid-stride
    ((4, 65536, 64), CAP),
])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=str)
def test_plan_at_the_sweep_stacks(stack, blocks, dtype):
    grid, threads, vec, chunk = perf_model.reduce_plan(*stack, dtype)
    assert (grid, threads, vec, chunk) == ((blocks, 1, 1), 128, 4, 8)


@pytest.mark.parametrize("rows,cols,vec", [
    (1000, 2, 4), (1001, 2, 2),                  # cols 2
    (1000, 3, 4), (1002, 3, 2), (1001, 3, 1),    # cols 3
    (1000, 5, 4), (1002, 5, 2), (999, 5, 1),     # cols 5
    (4097, 1, 1), (4096, 4, 4), (4095, 16, 4),
])
def test_vector_width_follows_the_flat_index(rows, cols, vec):
    (blocks, _, _), threads, got, _ = perf_model.reduce_plan(3, rows, cols,
                                                             F32)
    assert got == vec
    assert blocks == -(-(rows * cols // vec) // threads)


@pytest.mark.parametrize("dtype,ptr_p,ptr_c,vec", [
    (F32, 0, 0, 4), (F32, 4, 0, 1), (F32, 8, 0, 2), (F32, 16, 0, 4),
    (F32, 0, 8, 2), (F32, 0, 4, 1),
    (BF16, 0, 8, 4),              # four bf16 take an 8-byte store
    (BF16, 0, 4, 2), (BF16, 0, 2, 1), (BF16, 8, 8, 2),
])
def test_vector_width_follows_the_alignment(dtype, ptr_p, ptr_c, vec):
    assert perf_model.reduce_plan(2, 16384, 16, dtype, ptr_p,
                                  ptr_c)[2] == vec


def test_grid_does_not_depend_on_s_and_follows_the_card():
    assert {perf_model.reduce_plan(s, 4096, 16, F32)[0]
            for s in (2, 3, 8, 9, 64)} == {(128, 1, 1)}
    pcie = dataclasses.replace(perf_model.H100, n_sms=114)
    assert perf_model.reduce_plan(4, 65536, 64, F32,
                                  spec=pcie)[0] == (8 * 114, 1, 1)
    assert perf_model.reduce_plan(2, 1, 1, F32)[0] == (1, 1, 1)


def test_plan_of_tensors_reads_their_pointers():
    buf = torch.zeros(2 * 1000 * 2 + 2)
    p = buf[2:].view(2, 1000, 2)          # 8 bytes in: 2-wide vectors
    out = torch.empty(1000, 2)
    assert reduce.plan(p, out)[2] == 2
    assert reduce.plan(buf[:4000].view(2, 1000, 2), out)[2] == 4


def _stack(seed, shape):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


# (stack, block_r for the JAX kernel: a divisor of rows)
STACKS = [((4, 128, 8), 128),          # small: the plain-sum path
          ((4, 65536, 8), 4096),       # the kernel path on both sides
          ((8, 256, 16), 64),
          ((3, 1000, 5), 200)]         # ragged: 5 columns, odd slices


@pytest.mark.parametrize("stack,block_r", STACKS)
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_reduce_partials_against_jax(stack, block_r, name):
    tdt, jdt = DTYPES[name]
    p, jp = _stack(1, stack)
    got, plan = reduce.reduce_partials(p, tdt)
    want = j_reduce_partials(jp, jdt, block_r=block_r, vmem_budget=1 << 22,
                             interpret=True)
    assert got.dtype == tdt and got.shape == stack[1:]
    assert (plan is not None) == perf_model.reduce_kernel_runs(*stack)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[name])


@pytest.mark.parametrize("stack,block_r", STACKS)
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_sum_partials_against_the_jax_kernel(stack, block_r, name):
    tdt, jdt = DTYPES[name]
    p, jp = _stack(2, stack)
    got = reduce.sum_partials(p, tdt)
    want = sum_partials_pallas(jp, block_r=block_r, out_dtype=jdt,
                               interpret=True)
    assert got.dtype == tdt
    torch.testing.assert_close(got, ref.sum_partials_ref(p, tdt), rtol=0,
                               atol=0)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[name])


@pytest.mark.parametrize("stack", [(2, 64, 16), (9, 100, 3), (17, 33, 5)])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=str)
def test_plain_version_is_the_slice_order_sum(stack, dtype):
    """The plain version adds slice 0, 1, ..., S-1 to +0.0 in f32, as the
    kernel does, so the two give the same bits (numpy's f32 adds here)."""
    p, _ = _stack(5, stack)
    acc = np.zeros(stack[1:], np.float32)
    for part in p.numpy():
        acc += part
    want = torch.from_numpy(acc).to(dtype)
    got = ref.sum_partials_ref(p, dtype)
    assert got.dtype == dtype and torch.equal(got, want)


def test_one_slice_and_small_stacks_launch_nothing():
    p, _ = _stack(3, (1, 65536, 16))
    got, plan = reduce.reduce_partials(p, BF16)
    assert plan is None and torch.equal(got, p[0].to(BF16))
    assert reduce.reduce_partials(_stack(3, (4, 128, 8))[0], F32)[1] is None


def test_dispatch_records_the_plans_grid():
    """A split TSM2R whose (2, 16384, 16) partials pass JNP_REDUCE_MAX_ELEMS
    records the epilogue launch at the plan's grid: 512 blocks of 128
    threads, one 4-wide vector each."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.uniform(-1, 1, (16384, 64)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-1, 1, (64, 16)).astype(np.float32))
    with tsmm.policy(split=2), tsmm.record_dispatches() as log:
        got = tsmm.tsmm(a, b, mode="tsm2r")
    launch = log[0].launches[-1]
    assert (launch.kind, launch.grid, launch.splits) == ("reduce",
                                                         (512, 1, 1), 2)
    torch.testing.assert_close(got, ref.tsm2r_ref(a, b), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("bad", ["dtype", "rank", "stride"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    p = torch.zeros(2, 64, 16)
    if bad == "dtype":
        p = p.to(BF16)
    elif bad == "rank":
        p = p[0]
    else:
        p = p.transpose(1, 2)
    with pytest.raises(ValueError):
        reduce.sum_partials(p, F32)
    with pytest.raises(TypeError):
        reduce.sum_partials(torch.zeros(2, 64, 16), torch.float16)
