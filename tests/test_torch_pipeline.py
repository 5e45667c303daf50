"""The port's GPipe schedule against the JAX package's, on the CPU.

``distributed.pipeline.pipeline_apply`` over a stack of ``tanh(x w + b)``
layers, split into stages by ``split_stages`` and walked by
``make_stage_fn``:

* the reference's four ``(n_layers, n_stages, n_micro)`` cases against the
  JAX package's ``pipeline_apply`` (``stage_axis=None``, jitted) at
  rtol = atol = 1e-5, and bit for bit against the stages applied in
  sequence (the bubbles the port skips are never read);
* the reference's gradient test, and the gradients against ``jax.grad``
  of the JAX schedule at the same tolerance;
* a two-rank gloo world with the stage axis sharded (``tests/
  torch_dist_harness.py``): each rank runs its own stage, the buffer
  rotates by ``compat.ppermute``, and both ranks return the one-process
  schedule's outputs bit for bit.

The ranks import this module, so JAX is imported inside the tests.
"""

import numpy as np
import pytest
import torch

import torch_dist_harness as harness
from repro_torch.distributed import pipeline

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [(8, 4, 4), (8, 2, 3), (6, 3, 1), (4, 4, 5)]


def _layer_fn(lp, x):
    return torch.tanh(x @ lp["w"] + lp["b"])


def _inputs(n_layers, n_micro, d, b, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n_layers, d, d)) * 0.5).astype(np.float32)
    x = rng.standard_normal((n_micro, b, d)).astype(np.float32)
    return w, np.zeros((n_layers, d), np.float32), x


def _layers(w, bias, requires_grad=False):
    return [{"w": torch.tensor(w[i], requires_grad=requires_grad),
             "b": torch.tensor(bias[i], requires_grad=requires_grad)}
            for i in range(len(w))]


def _jax_pipeline(w, bias, x, n_stages):
    import jax
    import jax.numpy as jnp

    from repro.distributed import pipeline as jpipeline

    def layer(lp, h):
        return jnp.tanh(h @ lp["w"] + lp["b"])

    stages = jpipeline.split_stages({"w": jnp.asarray(w),
                                     "b": jnp.asarray(bias)}, n_stages)
    stage_fn = jpipeline.make_stage_fn(layer)

    def loss(sp, mb):
        out = jpipeline.pipeline_apply(stage_fn, sp, mb, stage_axis=None)
        return jnp.sum(out ** 2), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        stages, jnp.asarray(x))
    return (np.asarray(out),
            {k: np.asarray(v).reshape(w.shape[0], *v.shape[2:])
             for k, v in g.items()})


@pytest.mark.parametrize("n_layers,n_stages,n_micro", CASES)
def test_pipeline_matches_jax_and_sequential(n_layers, n_stages, n_micro):
    d, b = 16, 4
    w, bias, x = _inputs(n_layers, n_micro, d, b, seed=n_layers * 10
                         + n_stages)
    layers = _layers(w, bias)
    stages = pipeline.split_stages(layers, n_stages)
    assert [len(s) for s in stages] == [n_layers // n_stages] * n_stages
    stage_fn = pipeline.make_stage_fn(_layer_fn)
    got = pipeline.pipeline_apply(stage_fn, stages, torch.from_numpy(x),
                                  stage_axis=None)
    assert got.shape == (n_micro, b, d)
    want, _ = _jax_pipeline(w, bias, x, n_stages)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    seq = torch.stack([stage_fn(layers, mb) for mb in torch.from_numpy(x)])
    assert torch.equal(got, seq)


def test_pipeline_gradients_flow_as_jax():
    d = 8
    w, bias, x = _inputs(4, 3, d, 2, seed=2)
    layers = _layers(w, bias, requires_grad=True)
    stages = pipeline.split_stages(layers, 2)
    stage_fn = pipeline.make_stage_fn(_layer_fn)
    out = pipeline.pipeline_apply(stage_fn, stages, torch.from_numpy(x))
    (out ** 2).sum().backward()
    _, jgrad = _jax_pipeline(w, bias, x, 2)
    for key in ("w", "b"):
        g = torch.stack([lp[key].grad for lp in layers])
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), jgrad[key], **TOL)
    assert float(torch.stack([lp["w"].grad for lp in layers]).abs().max()) \
        > 0


def test_split_stages_refuses_uneven():
    with pytest.raises(ValueError, match="do not split"):
        pipeline.split_stages(list(range(6)), 4)


def test_stage_axis_needs_its_mesh():
    with pytest.raises(ValueError, match="needs the mesh"):
        pipeline.pipeline_apply(lambda p, x: x, [[], []],
                                torch.zeros(2, 1), stage_axis="stage")


# ---------------------------------------------------------------------------
# Two ranks, the stage axis sharded
# ---------------------------------------------------------------------------

SHARDED = (4, 2, 3)          # layers, stages, microbatches


def port_rank(rank, work):
    from torch.distributed.device_mesh import init_device_mesh

    inp = dict(np.load(work / "inputs.npz"))
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("stage",))
    stages = pipeline.split_stages(_layers(inp["w"], inp["b"]), SHARDED[1])
    stage_fn = pipeline.make_stage_fn(_layer_fn)
    x = torch.from_numpy(inp["x"])
    with torch.no_grad():
        sharded = pipeline.pipeline_apply(stage_fn, stages, x,
                                          stage_axis="stage", mesh=mesh)
        local = pipeline.pipeline_apply(stage_fn, stages, x)
    return {"sharded": sharded, "local": local}


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("pipeline")
    w, bias, x = _inputs(SHARDED[0], SHARDED[2], 16, 4, seed=5)
    np.savez(work / "inputs.npz", w=w, b=bias, x=x)
    ranks = harness.join_world(harness.start_world(port_rank, work), work,
                               timeout=240)
    return ranks, (w, bias, x)


def test_sharded_stage_axis_equals_one_process(sharded_runs):
    ranks, (w, bias, x) = sharded_runs
    want, _ = _jax_pipeline(w, bias, x, SHARDED[1])
    for r in ranks:
        assert torch.equal(r["sharded"], r["local"])
        np.testing.assert_allclose(r["sharded"].numpy(), want, **TOL)
