"""Autograd through the port's kernel entries, against the JAX package's
custom VJPs, on the CPU.

For each op, the port's ``torch.autograd.Function`` and ``jax.vjp`` of
``repro.kernels.ops.*`` (Pallas in interpret mode) take the same inputs
and cotangent, made with numpy from a seed, at ``tests/test_grads.py``'s
shapes and tolerance (rtol = atol = 1e-3). The backward's dispatches
agree on both sides: tsm2r's Bbar and tsm2l's Bbar go to tsmt, tsm2l's
Abar to tsm2l, tsmt's cotangent products to tsm2l. The directional finite
difference of a tsm2l-routed loss is held against a float64 oracle
(rtol 1e-2), not against the JAX package, whose own version of that test
fails on this tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tsmm as jtsmm
from repro.kernels import ops as jops
from repro_torch.core import tsmm
from repro_torch.kernels import ops

TOL = dict(rtol=1e-3, atol=1e-3)


def _arr(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("op,shapes", [
    ("tsm2r", ((4096, 2048), (2048, 8), (4096, 8))),   # m ~ k >> n
    ("tsm2l", ((4096, 16), (16, 8), (4096, 8))),       # m >> k ~ n
    ("tsmt", ((4096, 32), (4096, 8), (32, 8))),        # reduction over m
])
def test_grads_match_jax_vjp(op, shapes):
    x, y, ct = (_arr(i, s) for i, s in enumerate(shapes))
    jfn = getattr(jops, op)
    with jtsmm.record_dispatches() as jlog:
        out, vjp = jax.vjp(lambda u, v: jfn(u, v, interpret=True),
                           jnp.asarray(x), jnp.asarray(y))
        jdx, jdy = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    with tsmm.record_dispatches() as log:
        got = getattr(ops, op)(tx, ty)
        got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jdy), **TOL)
    kinds = [(e.entry, e.kind, e.shape) for e in log]
    assert kinds == [(e.entry, e.kind, e.shape) for e in jlog]
    assert len(kinds) == 2 and all(e.executor == "torch-ref" or
                                   e.kind == "dense" for e in log)


def test_backward_routes_stay_tall_skinny():
    """The TSM2L backward re-enters the dispatcher: Abar to tsm2l, Bbar
    to tsmt; tsmt's cotangent products are TSM2L-shaped."""
    a = torch.randn(4096, 16, requires_grad=True)
    b = torch.randn(16, 8, requires_grad=True)
    with tsmm.record_dispatches() as log:
        tsmm.tsmm(a, b).sum().backward()
    assert [(e.entry, e.kind) for e in log] == [
        ("mm", "tsm2l"), ("mm", "tsm2l"), ("mmt", "tsmt")]
    x = torch.randn(4096, 32, requires_grad=True)
    y = torch.randn(4096, 8, requires_grad=True)
    with tsmm.record_dispatches() as log:
        tsmm.tsmm_t(x, y).sum().backward()
    assert [(e.entry, e.kind) for e in log] == [
        ("mmt", "tsmt"), ("mm", "tsm2l"), ("mm", "tsm2l")]


def test_backward_policy_is_captured_at_forward():
    """The backward runs under the forward's scope, not the one around
    ``backward()``; an int split pin goes back to "auto" there."""
    a = torch.randn(4096, 16, requires_grad=True)
    b = torch.randn(16, 8, requires_grad=True)
    with tsmm.policy(split=2):
        out = tsmm.tsmm(a, b)
    with tsmm.policy(mode="dense"), tsmm.record_dispatches() as log:
        out.sum().backward()
    assert [e.kind for e in log] == ["tsm2l", "tsmt"]
    assert [e.split for e in log] == ["auto", "auto"]


def test_only_needed_grads_are_computed():
    a = torch.randn(4096, 16, requires_grad=True)
    b = torch.randn(16, 8)
    with tsmm.record_dispatches() as log:
        tsmm.tsmm(a, b).sum().backward()
    assert [e.entry for e in log] == ["mm", "mm"]
    assert b.grad is None and a.grad.shape == a.shape


def test_finite_difference_directional_against_oracle():
    m, k, n = 2048, 8, 8
    assert tsmm.classify_gemm(m, k, n) == "tsm2l"
    a, b = _arr(10, (m, k)), _arr(11, (k, n))
    direction = _arr(12, (m, k)) / m

    def oracle(a64):
        return float(np.tanh(a64 @ b.astype(np.float64)).sum())

    eps = 1e-2
    a64, d64 = a.astype(np.float64), direction.astype(np.float64)
    fd = (oracle(a64 + eps * d64) - oracle(a64 - eps * d64)) / (2 * eps)
    ta = torch.from_numpy(a).requires_grad_(True)
    with tsmm.record_dispatches() as log:
        torch.tanh(tsmm.tsmm(ta, torch.from_numpy(b))).sum().backward()
    assert log[0].kind == "tsm2l"
    analytic = float((ta.grad.double() * torch.from_numpy(d64)).sum())
    np.testing.assert_allclose(analytic, fd, rtol=1e-2)
