"""The port's examples (``examples/torch/``): each ``main`` on the CPU at a
small size, its own check passing; each refusing the CPU unasked; and
k-means' step and the randomized SVD against the JAX package's examples
on the same numpy data."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "torch"
NAMES = ("quickstart", "powersgd_abft", "train_lm", "serve_lm", "rsvd",
         "kmeans")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example(name):
    return _load(EXAMPLES / f"{name}.py", f"torch_example_{name}")


# (argv on the CPU at a small size, the line its own check prints)
RUNS = {
    "quickstart": ([], "OK"),
    "powersgd_abft": (["--d", "256"], "ABFT after single-element "
                      "corruption: detected=True"),
    "train_lm": (["--steps", "2"], "[train] done: 2 steps"),
    "serve_lm": ([], "KV-cache decode == teacher-forced forward: OK"),
    "rsvd": (["--n", "20000"], "OK"),
    "kmeans": (["--n", "20000"], "OK"),
}


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_cpu(name, capsys):
    argv, check = RUNS[name]
    assert _example(name).main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert check in out, out[-2000:]


@pytest.mark.parametrize("name", NAMES)
def test_example_refuses_the_cpu_unasked(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(RUNS[name][0])


def test_kmeans_step_matches_the_jax_example():
    import jax.numpy as jnp

    port = _example("kmeans")
    ref = _load(ROOT / "examples" / "kmeans.py", "jax_example_kmeans")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4096, 64)).astype(np.float32)
    c = (rng.standard_normal((8, 64)) * 2).astype(np.float32)
    new_c, assign, inertia = port.kmeans_step(torch.from_numpy(x),
                                              torch.from_numpy(c))
    j_c, j_assign, j_inertia = ref.kmeans_step(jnp.asarray(x),
                                               jnp.asarray(c))
    np.testing.assert_array_equal(assign.numpy(), np.asarray(j_assign))
    np.testing.assert_allclose(new_c.numpy(), np.asarray(j_c), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(float(inertia), float(j_inertia), rtol=1e-3)


def test_kmeanspp_and_blobs_recover_the_centers():
    port = _example("kmeans")
    gen = torch.Generator().manual_seed(3)
    x, true_c = port.make_blobs(gen, 4096, 16, 4)
    c = port.kmeanspp_init(gen, x, 4)
    for _ in range(4):
        c, _, _ = port.kmeans_step(x, c)
    d = torch.cdist(true_c, c).min(dim=1).values
    assert float(d.max()) < 0.5


def test_rsvd_singular_values_against_numpy_and_the_jax_example():
    import jax
    import jax.numpy as jnp

    port = _example("rsvd")
    ref = _load(ROOT / "examples" / "rsvd.py", "jax_example_rsvd")
    n, d, rank = 8192, 256, port.RANK
    rng = np.random.default_rng(0)
    u, _ = np.linalg.qr(rng.standard_normal((n, rank)))
    v, _ = np.linalg.qr(rng.standard_normal((d, rank)))
    s_true = np.geomspace(100.0, 1.0, rank)
    a = ((u * s_true) @ v.T + 1e-3 * rng.standard_normal((n, d))).astype(
        np.float32)
    want = np.linalg.svd(a.astype(np.float64), compute_uv=False)[:rank]
    # the reference script's own bar: Weyl's bound on the noise
    floor = 1e-3 * (n ** 0.5 + d ** 0.5)
    _, s, _ = port.rsvd(torch.Generator().manual_seed(1),
                        torch.from_numpy(a), rank)
    _, j_s, _ = ref.rsvd(jax.random.PRNGKey(1), jnp.asarray(a), rank)
    assert np.abs(s.numpy() - want).max() < floor
    assert np.abs(np.asarray(j_s) - want).max() < floor
    assert np.abs(s.numpy() - np.asarray(j_s)).max() < floor


def test_make_low_rank_has_the_stated_spectrum():
    port = _example("rsvd")
    a, s = port.make_low_rank(torch.Generator().manual_seed(0), 4096, 64)
    got = torch.linalg.svdvals(a)[:port.RANK]
    assert float((got - s).abs().max()) < 1e-3 * (4096 ** 0.5 + 64 ** 0.5)
