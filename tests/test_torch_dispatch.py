"""The port's dispatcher against the JAX package's, on the CPU.

Classification must agree shape for shape under default and custom
thresholds; ``tsmm``/``tsmm_t`` outputs on N-d lhs inputs must match in
``mode="auto"`` (JAX: Pallas interpret; port: the plain versions) and
``mode="dense"``, and ``record_dispatches`` must show the same routes.
f32 tolerance as the JAX kernel tests: rtol=1e-3, atol=1e-4.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tsmm as jtsmm
from repro_torch.core import tsmm

SIZES = (1, 4, 16, 64, 128, 256, 300, 512, 1024, 2048, 4096, 16384)
CUSTOM = dict(min_tall=512, max_skinny=64, skinny_ratio=4, max_skinny_t=128,
              skinny_ratio_t=2)
TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("custom", [False, True])
def test_classifiers_agree(custom):
    kw = CUSTOM if custom else {}
    pol, jpol = tsmm.GemmPolicy(**kw), jtsmm.GemmPolicy(**kw)
    for m, d1, d2 in itertools.product(SIZES, repeat=3):
        assert (tsmm.classify_gemm(m, d1, d2, pol)
                == jtsmm.classify_gemm(m, d1, d2, jpol)), (m, d1, d2)
        assert (tsmm.classify_gemm_t(m, d1, d2, pol)
                == jtsmm.classify_gemm_t(m, d1, d2, jpol)), (m, d1, d2)


def _pair(seed, shape):
    x = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


MM_CASES = [((2, 1024, 512), (512, 8), "tsm2r"),
            ((4, 1024, 8), (8, 8), "tsm2l"),
            ((2, 3, 16, 32), (32, 32), "dense")]
MMT_CASES = [((2, 1024, 64), (2, 1024, 4), "tsmt"),
             ((2, 16, 32), (2, 16, 8), "dense")]


@pytest.mark.parametrize("mode", ["auto", "dense"])
@pytest.mark.parametrize("lhs,rhs,kind", MM_CASES)
def test_tsmm_matches_jax(lhs, rhs, kind, mode):
    a, ja = _pair(1, lhs)
    b, jb = _pair(2, rhs)
    with jtsmm.policy(mode=mode), jtsmm.record_dispatches() as jlog:
        want = jtsmm.tsmm(ja, jb)
    with tsmm.policy(mode=mode), tsmm.record_dispatches() as log:
        got = tsmm.tsmm(a, b)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert [(e.entry, e.kind, e.shape) for e in log] == \
        [(e.entry, e.kind, e.shape) for e in jlog]
    assert log[0].kind == (kind if mode == "auto" else "dense")
    assert log[0].executor == ("torch-ref" if log[0].kind != "dense"
                               else "torch-dense")


@pytest.mark.parametrize("mode", ["auto", "dense"])
@pytest.mark.parametrize("lhs,rhs,kind", MMT_CASES)
def test_tsmm_t_matches_jax(lhs, rhs, kind, mode):
    x, jx = _pair(3, lhs)
    y, jy = _pair(4, rhs)
    with jtsmm.policy(mode=mode), jtsmm.record_dispatches() as jlog:
        want = jtsmm.tsmm_t(jx, jy)
    with tsmm.policy(mode=mode), tsmm.record_dispatches() as log:
        got = tsmm.tsmm_t(x, y)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert [(e.entry, e.kind, e.shape) for e in log] == \
        [(e.entry, e.kind, e.shape) for e in jlog]
    assert log[0].kind == (kind if mode == "auto" else "dense")


def test_forced_kind_and_errors():
    a, b = torch.randn(64, 32), torch.randn(32, 4)
    with tsmm.record_dispatches() as log:
        tsmm.tsmm(a, b, mode="tsm2r")
        with tsmm.policy(mode="tsmt"):      # the other entry stays on auto
            tsmm.tsmm(a, b)
    assert [e.kind for e in log] == ["tsm2r", "dense"]
    with pytest.raises(ValueError, match="unknown kind"):
        tsmm.tsmm(a, b, mode="tsmt")
    with pytest.raises(ValueError, match="unknown GemmPolicy mode"):
        tsmm.GemmPolicy(mode="bogus")
    with pytest.raises(ValueError, match="contraction mismatch"):
        tsmm.tsmm(a, torch.randn(31, 4))


def test_executor_pins():
    a, b = torch.randn(4096, 64), torch.randn(64, 4)
    with tsmm.policy(executor="cuda"), pytest.raises(ValueError,
                                                     match="CUDA tensors"):
        tsmm.tsmm(a, b)
    with tsmm.policy(executor="nope"), pytest.raises(ValueError,
                                                     match="not registered"):
        tsmm.tsmm(a, b)
    with tsmm.policy(executor="torch-dense"), \
            tsmm.record_dispatches() as log:
        out = tsmm.tsmm(a, b)
    assert log[0].executor == "torch-dense" and log[0].kind == "tsm2l"
    torch.testing.assert_close(out, a @ b)


def test_policy_scopes_nest_and_restore():
    base = tsmm.current_policy()
    with tsmm.policy(mode="dense") as p:
        assert tsmm.current_policy() is p
        with tsmm.policy(min_tall=8):
            assert tsmm.current_policy().mode == "dense"
            assert tsmm.current_policy().min_tall == 8
    assert tsmm.current_policy() is base
