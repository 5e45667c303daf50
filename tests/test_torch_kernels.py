"""The port's kernel entries against the JAX package's, on the CPU.

On the CPU the port's ``ops.tsm2r/tsm2l/tsmt`` run their plain versions
(the CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against the same plain versions); the JAX side runs its Pallas kernels in
interpret mode, as its own tests do. Inputs come from numpy with a seed;
bf16 rounds the same f32 array to nearest even on both sides. Shapes are
``tests/test_kernels.py``'s lists cut in size, keeping the ragged and
``n = 1`` cases. Tolerances are the JAX tests': f32 rtol=1e-3, atol=1e-4;
bf16 rtol=atol=2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build, ops, ref

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _tol(name):
    return (dict(rtol=2e-2, atol=2e-2) if name == "bf16"
            else dict(rtol=1e-3, atol=1e-4))


def _pair(seed, shape, name):
    x = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    tdt, jdt = DTYPES[name]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def _check(got, want, name):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(name))


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [
    (512, 512, 2),
    (768, 512, 8),
    (1000, 777, 16),      # non-divisible everywhere
    (1024, 256, 32),
    (512, 512, 1),        # n = 1 (GEMV edge)
])
def test_tsm2r_matches_jax(m, k, n, name):
    a, ja = _pair(m * 7 + n, (m, k), name)
    b, jb = _pair(m * 7 + n + 1, (k, n), name)
    _check(ops.tsm2r(a, b), jops.tsm2r(ja, jb, interpret=True), name)


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [
    (4096, 8, 8),
    (10000, 16, 8),       # non-divisible m
    (4096, 4, 4),         # the paper's 102400x4 @ 4x4 case, scaled
    (4096, 16, 2),
])
def test_tsm2l_matches_jax(m, k, n, name):
    a, ja = _pair(m + n, (m, k), name)
    b, jb = _pair(m + n + 1, (k, n), name)
    _check(ops.tsm2l(a, b), jops.tsm2l(ja, jb, interpret=True), name)


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("m,a,b", [
    (4096, 128, 8),       # PowerSGD Q = G^T P with r = 8
    (10000, 300, 16),     # non-divisible everywhere
    (4096, 64, 2),        # ABFT checksum verify
    (2048, 16, 1),
])
def test_tsmt_matches_jax(m, a, b, name):
    x, jx = _pair(m + a + b, (m, a), name)
    y, jy = _pair(m + a + b + 1, (m, b), name)
    _check(ops.tsmt(x, y), jops.tsmt(jx, jy, interpret=True), name)


def test_tsmt_max_b_raises():
    x, y = torch.zeros(64, 8), torch.zeros(64, ops.TSMT_MAX_B + 1)
    with pytest.raises(ValueError, match="exceeds the limit"):
        ops.tsmt(x, y)


def test_cpu_calls_never_touch_the_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU call reached the CUDA build")

    for fn in ("build", "library", "launcher", "nvcc"):
        monkeypatch.setattr(_build, fn, refuse)
    a, b = torch.randn(256, 64), torch.randn(64, 4)
    torch.testing.assert_close(ops.tsm2r(a, b), ref.tsm2r_ref(a, b))
    torch.testing.assert_close(ops.tsm2l(a, b), ref.tsm2l_ref(a, b))
    torch.testing.assert_close(ops.tsmt(a, a), ref.tsmt_ref(a, a))


@pytest.mark.parametrize("case", ["dtype", "mixed", "shape", "rank"])
def test_wrapper_rejects_bad_operands(case):
    from repro_torch.kernels import tsm2r

    a, b = torch.randn(64, 32), torch.randn(32, 4)
    bad = {"dtype": (a.double(), b.double()),
           "mixed": (a, b.to(torch.bfloat16)),
           "shape": (a, torch.randn(31, 4)),
           "rank": (a[None], b)}[case]
    with pytest.raises((TypeError, ValueError)):
        tsm2r.tsm2r(*bad)


def test_wrapper_rejects_non_contiguous():
    from repro_torch.kernels import tsmt

    x = torch.randn(32, 64).t()
    with pytest.raises(ValueError, match="contiguous"):
        tsmt.tsmt(x, torch.randn(64, 4))


def test_wrapper_on_a_non_cpu_tensor_launches_or_raises():
    from repro_torch.kernels import tsm2l

    a = torch.empty(64, 8, device="meta")
    before = tsm2l.launches
    with pytest.raises(ValueError, match="CUDA"):
        tsm2l.tsm2l(a, torch.empty(8, 4, device="meta"))
    assert tsm2l.launches == before
