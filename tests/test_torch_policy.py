"""The rest of the port's ``GemmPolicy`` and dispatcher API against the JAX
package's, on the CPU: the process default from the deprecated
environment variables, ``enabled``, the executor registry
(``register_executor`` / ``unregister_executor`` / ``executors`` /
``executor_reduce_contract``), ``param_dtype_grads`` (the ``_dense_pg``
layer variant: gradient values at the JAX dispatch tests' f32 tolerance,
rtol=1e-3, atol=1e-4, or the bf16 one, 2e-2, their dtypes, and the
backward's routes) and ``layers.dense`` on a 1-D input.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tsmm as jtsmm
from repro.models import layers as jlayers
from repro_torch.analysis import contracts
from repro_torch.core import tsmm
from repro_torch.kernels import ref
from repro_torch.models import layers

TOL = {"f32": dict(rtol=1e-3, atol=1e-4), "bf16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture
def env_default(monkeypatch):
    """Set the deprecated variables for one test; the process default is
    read again afterwards, so no later test in this worker runs dense."""
    yield monkeypatch
    monkeypatch.undo()
    tsmm.refresh_default_policy()
    jtsmm.refresh_default_policy()


def test_new_fields_default_as_jax():
    fields = {f.name: f.default for f in dataclasses.fields(tsmm.GemmPolicy)}
    jfields = {f.name: f.default
               for f in dataclasses.fields(jtsmm.GemmPolicy)}
    for name in ("param_dtype_grads", "abft", "mode", "split", "quant",
                 "verify_contracts", "shard_map", "dp_axes", "reduce"):
        assert fields[name] == jfields[name]
    p = tsmm.GemmPolicy(param_dtype_grads=True, abft="verify", mode="tsm2r",
                        executor="torch-ref", split=4)
    bp = tsmm.backward_policy(p)
    assert bp.param_dtype_grads and bp.abft == "verify"
    assert not contracts.check_backward_policy(p, bp)


@pytest.mark.parametrize("env,want", [
    ({"REPRO_TSMM": "off"}, dict(mode="dense")),
    ({"REPRO_TSMM": "on"}, dict()),
    ({"REPRO_BF16_PARAM_GRADS": "1"}, dict(param_dtype_grads=True)),
    ({"REPRO_TSMM": "0", "REPRO_BF16_PARAM_GRADS": "0"}, dict(mode="dense")),
])
def test_env_default_policy_as_jax(env_default, env, want):
    for name in ("REPRO_TSMM", "REPRO_BF16_PARAM_GRADS"):
        env_default.delenv(name, raising=False)
    for name, value in env.items():
        env_default.setenv(name, value)
    with pytest.warns(DeprecationWarning):
        p = tsmm.refresh_default_policy()
    with pytest.warns(DeprecationWarning):
        jp = jtsmm.refresh_default_policy()
    assert tsmm.default_policy() is p and tsmm.current_policy() is p
    assert p == tsmm.GemmPolicy(**want)
    assert (p.mode, p.param_dtype_grads) == (jp.mode, jp.param_dtype_grads)
    assert tsmm.enabled() == jtsmm.enabled() == (p.mode != "dense")


def test_default_policy_without_env(env_default):
    for name in ("REPRO_TSMM", "REPRO_BF16_PARAM_GRADS"):
        env_default.delenv(name, raising=False)
    assert tsmm.refresh_default_policy() == tsmm.GemmPolicy()


def test_import_reads_no_environment():
    """The deprecated variables reach the process default only through
    ``refresh_default_policy``: a fresh import with both set still
    defaults to ``GemmPolicy()`` (the JAX package reads them at import)."""
    env = {**os.environ, "REPRO_TSMM": "off", "REPRO_BF16_PARAM_GRADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(pathlib.Path(__file__).resolve().parents[1] / "src"),
                os.environ.get("PYTHONPATH", "")])}
    code = ("import warnings; warnings.simplefilter('error'); "
            "from repro_torch.core import tsmm; "
            "print(tsmm.default_policy() == tsmm.GemmPolicy(), "
            "tsmm.enabled())")
    got = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert got.returncode == 0, got.stderr
    assert got.stdout.split() == ["True", "True"]


def test_enabled_is_policy_alias():
    assert tsmm.enabled()
    with tsmm.policy(mode="dense"):
        assert not tsmm.enabled()
    with tsmm.policy(mode="tsm2r"):
        assert tsmm.enabled()


def test_builtin_executors_and_contracts():
    names = tsmm.executors()
    assert {"cuda", "torch-ref", "torch-dense"} <= set(names)
    for name in ("cuda", "torch-ref", "torch-dense"):
        assert tsmm.executor_reduce_contract(name) == \
            jtsmm.executor_reduce_contract("dense-xla")
    names.pop("cuda")                          # a snapshot, not the registry
    assert "cuda" in tsmm.executors()
    with pytest.raises(ValueError, match="not registered"):
        tsmm.executor_reduce_contract("nope")


def test_register_pin_and_unregister_executor():
    calls = []

    def traced_ref(entry, kind, a, b, p):
        calls.append((entry, kind))
        return tsmm.executors()["torch-ref"](entry, kind, a, b, p)

    assert tsmm.register_executor("test-ref", traced_ref,
                                  reduce=("psum", "none")) is traced_ref
    try:
        with pytest.raises(ValueError, match="already registered"):
            tsmm.register_executor("test-ref", traced_ref)
        assert tsmm.executor_reduce_contract("test-ref") == ("psum", "none")
        tsmm.register_executor("test-ref", traced_ref, overwrite=True)
        assert tsmm.executor_reduce_contract("test-ref") == \
            ("psum", "psum_scatter", "none")
        a = torch.from_numpy(np.random.default_rng(0).normal(
            size=(4096, 16)).astype(np.float32))
        b = torch.from_numpy(np.random.default_rng(1).normal(
            size=(16, 8)).astype(np.float32))
        with tsmm.policy(executor="test-ref"), \
                tsmm.record_dispatches() as log:
            out = tsmm.tsmm(a, b)
        assert calls == [("mm", "tsm2l")]
        assert [(e.kind, e.executor) for e in log] == [("tsm2l", "test-ref")]
        torch.testing.assert_close(out, ref.tsm2l_ref(a, b), **TOL["f32"])
    finally:
        tsmm.unregister_executor("test-ref")
    assert "test-ref" not in tsmm.executors()
    with tsmm.policy(executor="test-ref"), \
            pytest.raises(ValueError, match="not registered"):
        tsmm.tsmm(torch.ones(8, 4), torch.ones(4, 2))


def test_register_validates_reduce_modes_as_jax():
    for mod in (tsmm, jtsmm):
        with pytest.raises(ValueError, match="unknown reduce modes"):
            mod.register_executor("test-bad", lambda *a: None,
                                  reduce=("allreduce",))
        assert "test-bad" not in mod.executors()


# -- param_dtype_grads: the _dense_pg variant --------------------------------

PG_CASES = [((2, 1024, 512), (512, 8), "tsm2r"),      # kernel route
            ((4, 1024, 16), (16, 8), "tsm2l"),
            ((2, 16, 32), (32, 24), "dense")]


def _pair(seed, shape, name):
    x = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    tdt, jdt = DTYPES[name]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("xs,ws,kind", PG_CASES)
def test_param_dtype_grads_as_jax(xs, ws, kind, name):
    x, jx = _pair(1, xs, name)
    w, jw = _pair(2, ws, name)
    ct = np.random.default_rng(3).normal(size=xs[:-1] + ws[1:]).astype(
        np.float32)

    def jloss(w_, x_):
        return jnp.sum(jlayers.dense(w_, x_).astype(jnp.float32) * ct)

    with jtsmm.policy(param_dtype_grads=True, interpret=True), \
            jtsmm.record_dispatches() as jlog:
        jdw, jdx = jax.grad(jloss, argnums=(0, 1))(jw, jx)
    x.requires_grad_(True)
    w.requires_grad_(True)
    with tsmm.policy(param_dtype_grads=True), \
            tsmm.record_dispatches() as log:
        out = layers.dense(w, x)
        dw, dx = torch.autograd.grad(
            (out.float() * torch.from_numpy(ct)).sum(), (w, x))
    assert dw.dtype == w.dtype and dx.dtype == x.dtype
    assert jdw.dtype == jw.dtype and jdx.dtype == jx.dtype
    np.testing.assert_allclose(dw.float().numpy(),
                               np.asarray(jdw, np.float32), **TOL[name])
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx, np.float32), **TOL[name])
    # forward, then the backward's own pair: dw = tsmm_t(x, dy) first
    routes = [(e.entry, e.kind, e.shape) for e in log]
    assert routes == [(e.entry, e.kind, e.shape) for e in jlog]
    assert [(r[0], r[1]) for r in routes][0] == ("mm", kind)
    assert [r[0] for r in routes] == ["mm", "mmt", "mm"]


def test_param_dtype_grads_changes_the_backward_routes_only():
    """Without the knob a dense-kind projection's backward is autograd's
    own (no dispatch); with it, the backward's pair dispatches, and the
    values agree."""
    x, _ = _pair(4, (2, 16, 32), "f32")
    w, _ = _pair(5, (32, 24), "f32")
    grads = {}
    for pg in (False, True):
        xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        with tsmm.policy(param_dtype_grads=pg), \
                tsmm.record_dispatches() as log:
            gs = torch.autograd.grad(layers.dense(ws, xs).square().sum(),
                                     (ws, xs))
        grads[pg] = gs
        assert len(log) == (3 if pg else 1)
    for g, g0 in zip(grads[True], grads[False]):
        torch.testing.assert_close(g, g0, **TOL["f32"])


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_dense_on_a_1d_input_as_jax(name):
    x, jx = _pair(6, (32,), name)
    w, jw = _pair(7, (32, 24), name)
    with tsmm.record_dispatches() as log:
        got = layers.dense(w, x)
    want = jlayers.dense(jw, jx)
    assert log == [] and got.shape == (24,) and got.dtype == x.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[name])
