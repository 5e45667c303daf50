"""The port's ``tsmm`` / ``tsmm_t`` on mixed float32/bfloat16 pairs and on
float16, against the JAX package's, on the CPU.

The JAX package accumulates every route in f32 and writes the left
operand's dtype (``src/repro/core/tsmm.py:708-716``; its kernels'
``jnp.dot`` promotes a mixed pair), and its VJPs return each operand's
own dtype (``src/repro/kernels/ops.py:420,480``). The port widens a mixed
pair, and float16, to float32 before its kernels (which take float32 or
bfloat16 of one dtype) and casts the output once. Inputs come from numpy
with a seed; the JAX side runs its Pallas kernels in interpret mode.

Tolerances and why:

* without quantization, the JAX kernel tests': f32 outputs rtol 1e-3,
  atol 1e-4; 2-byte outputs (bf16, f16) rtol = atol = 2e-2, one rounding
  of an f32 sum on both sides (f16's step is finer than bf16's);
  gradients rtol = atol = 1e-3 in f32 (``tests/test_grads.py``) and 2e-2
  in a 2-byte dtype;
* under ``quant="int8"``, the JAX int8 tests' criterion against the f32
  product, max-norm relative 5% (6% for a 2-byte output) and 10% for
  gradients, on each side: the port quantizes in its own 256-row bands,
  JAX in its resolved block, so the two int8 results differ by more than
  a rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tsmm as jtsmm
from repro_torch.core import tsmm

# The routes and shapes of ROADMAP's F2: (entry, lhs, rhs).
ROUTES = {"tsm2r": ("mm", (4096, 512), (512, 8)),
          "tsm2l": ("mm", (4096, 8), (8, 8)),
          "dense": ("mm", (64, 64), (64, 64)),
          "tsmt": ("mmt", (8192, 16), (8192, 4))}
PAIRS = [("bf16", "f32"), ("f32", "bf16"), ("f16", "f16")]
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
JAX = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
Q8_REL = {4: 0.05, 2: 0.06}     # by the output's bytes an element
Q8_GRAD_REL = 0.1


def _tol(dtype):
    return (dict(rtol=1e-3, atol=1e-4) if dtype == torch.float32
            else dict(rtol=2e-2, atol=2e-2))


def _grad_tol(dtype):
    return (dict(rtol=1e-3, atol=1e-3) if dtype == torch.float32
            else dict(rtol=2e-2, atol=2e-2))


def _inputs(route, pair):
    entry, sa, sb = ROUTES[route]
    x = np.random.default_rng(len(route)).uniform(-1, 1, sa).astype(
        np.float32)
    y = np.random.default_rng(len(route) + 1).uniform(-1, 1, sb).astype(
        np.float32)
    (da, db) = pair
    return (entry, torch.from_numpy(x).to(TORCH[da]),
            torch.from_numpy(y).to(TORCH[db]), jnp.asarray(x).astype(JAX[da]),
            jnp.asarray(y).astype(JAX[db]))


def _ops(entry):
    return ((tsmm.tsmm, jtsmm.tsmm) if entry == "mm"
            else (tsmm.tsmm_t, jtsmm.tsmm_t))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _oracle(entry, a, b):
    a, b = a.float(), b.float()
    return (a @ b if entry == "mm" else a.t() @ b).double().numpy()


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "x".join(p))
@pytest.mark.parametrize("route", list(ROUTES))
def test_output_dtype_and_values_match_jax(route, pair, quant):
    entry, tx, ty, jx, jy = _inputs(route, pair)
    op, jop = _ops(entry)
    with jtsmm.record_dispatches() as jlog:
        want = jop(jx, jy, policy=jtsmm.GemmPolicy(interpret=True,
                                                   quant=quant))
    with tsmm.record_dispatches() as log:
        got = op(tx, ty, policy=tsmm.GemmPolicy(quant=quant))
    assert [e.kind for e in log] == [e.kind for e in jlog] == [route]
    assert got.dtype == tx.dtype
    assert str(want.dtype) == str(tx.dtype).removeprefix("torch.")
    if quant == "none":
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   **_tol(got.dtype))
    else:
        limit = Q8_REL[got.element_size()]
        oracle = _oracle(entry, tx, ty)
        assert _rel(got.float().numpy(), oracle) <= limit
        assert _rel(_np(want), oracle) <= limit


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "x".join(p))
@pytest.mark.parametrize("route", list(ROUTES))
def test_grads_come_back_in_each_operands_dtype(route, pair, quant):
    entry, tx, ty, jx, jy = _inputs(route, pair)
    op, jop = _ops(entry)
    jp = jtsmm.GemmPolicy(interpret=True, quant=quant)
    out, vjp = jax.vjp(lambda u, v: jop(u, v, policy=jp), jx, jy)
    ct = np.random.default_rng(7).uniform(-1, 1, out.shape).astype(
        np.float32)
    jdx, jdy = vjp(jnp.asarray(ct).astype(out.dtype))
    tx.requires_grad_(True)
    ty.requires_grad_(True)
    got = op(tx, ty, policy=tsmm.GemmPolicy(quant=quant))
    got.backward(torch.from_numpy(ct).to(got.dtype))
    for grad, jgrad, operand in ((tx.grad, jdx, tx), (ty.grad, jdy, ty)):
        assert grad.dtype == operand.dtype
        assert str(jgrad.dtype) == str(operand.dtype).removeprefix("torch.")
        if quant == "none":
            np.testing.assert_allclose(grad.float().numpy(), _np(jgrad),
                                       **_grad_tol(grad.dtype))
        else:
            assert _rel(grad.float().numpy(), _np(jgrad)) <= Q8_GRAD_REL
