"""The port's shard_map executors against the JAX package's on two devices.

A two-rank gloo world runs the port's ``tsmm`` / ``tsmm_t`` on DTensor
operands over a ``("data",)`` mesh; a subprocess with two host devices
runs the JAX package's under ``with mesh:``, as ``tests/test_shard_map.py``
and ``tests/test_scatter_shard_map.py`` do. Both read the same seeded
numpy inputs, once per module (``torch_dist_harness.run_both``). The tests
read the two records:

* routes: the outer ``shard_map`` / ``shard_map-scatter`` event at the
  global shape and the inner ``torch-ref`` events at the local one, the
  same events as the reference's (``pallas-tpu`` there), backward
  included;
* values at the JAX tests' 2e-3: the mm entry (a 2-D and a 3-D lhs),
  ``tsmm_t`` under each reduce mode with its local shapes, the gradients
  of both operands (the replicated B too), ``layers.dense``'s weight
  gradient under ``reduce="psum_scatter"``, which arrives row-sharded;
* the fallbacks (rows that do not divide the ranks, scatter rows that do
  not, ``shard_map="never"``, a dp_axes override naming no dim) and the
  errors of ``"require"`` and of pinned executors, with the reference's
  texts;
* the per-shard ABFT guard (one guarded event a shard, none outer);
* split per shard, a mesh named "replica", and a mesh of one rank, whose
  DTensors take the one-process route;
* in this process: ``derive_dp_axes`` on the reference's mesh-name cases,
  the policy fields' validation, ``backward_policy``'s reduce, and the
  errors a pinned executor raises before any collective.
"""

import types

import numpy as np
import pytest
import torch

import torch_dist_harness as harness
from repro_torch.core import tsmm

TOL = dict(rtol=2e-3, atol=2e-3)


def _inputs():
    rng = np.random.default_rng(0)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"a": n(8192, 512), "b": n(512, 8), "a3": n(2, 4096, 512),
            "al": n(8192, 16), "bl": n(16, 8), "x": n(8192, 64),
            "y": n(8192, 8), "w": n(256, 8), "xs": n(8192, 256)}


# ---------------------------------------------------------------------------
# The port's side: run on each rank of the world
# ---------------------------------------------------------------------------

def _error_text(fn):
    try:
        fn()
    except (RuntimeError, ValueError) as e:
        return str(e)
    raise AssertionError("no error raised")


def port_rank(rank, work):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.models import layers

    inp = {k: torch.from_numpy(v) for k, v in
           np.load(work / "inputs.npz").items()}
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
    out, ev, txt, meta = {}, {}, {}, {}

    def rows(t, m=mesh):
        return distribute_tensor(t, m, [Shard(0)])

    def rep(t, m=mesh):
        return distribute_tensor(t, m, [Replicate()])

    def record(name, fn):
        with tsmm.record_dispatches() as log:
            res = fn()
        ev[name] = harness.port_events(log)
        return res

    def keep(name, res):
        meta[name] = (type(res).__name__, tuple(res.to_local().shape),
                      [repr(p) for p in res.placements])
        out[name] = res.full_tensor()

    a, b = rows(inp["a"]), rep(inp["b"])
    keep("mm", record("mm", lambda: tsmm.tsmm(a, b)))
    keep("mm3", record("mm3", lambda: tsmm.tsmm(rows(inp["a3"]), b)))

    # gradients of both operands: the tsm2r shape and the tsm2l one
    for tag, (ka, kb) in (("grad_r", ("a", "b")), ("grad_l", ("al", "bl"))):
        ga = rows(inp[ka]).requires_grad_()
        gb = rep(inp[kb]).requires_grad_()
        with tsmm.record_dispatches() as log:
            tsmm.tsmm(ga, gb).sum().backward()
        ev[tag] = harness.port_events(log)
        keep(f"{tag}_da", ga.grad)
        keep(f"{tag}_db", gb.grad)

    x, y = rows(inp["x"]), rows(inp["y"])
    for red in ("psum", "none", "psum_scatter"):
        with tsmm.policy(reduce=red):
            keep(f"mmt_{red}", record(f"mmt_{red}",
                                      lambda: tsmm.tsmm_t(x, y)))
    for red in ("psum", "psum_scatter"):
        with tsmm.policy(reduce=red, split=2):
            keep(f"split_{red}", record(f"split_{red}",
                                        lambda: tsmm.tsmm_t(x, y)))

    # the weight gradient of layers.dense, row-sharded
    w = rep(inp["w"]).requires_grad_()
    xs = rows(inp["xs"])
    pol = tsmm.GemmPolicy(reduce="psum_scatter", param_dtype_grads=True)
    with tsmm.policy(pol), tsmm.record_dispatches() as log:
        layers.dense(w, xs).sum().backward()
    ev["dense_grad"] = harness.port_events(log)
    keep("dense_dw", w.grad)

    # the per-shard ABFT guard
    with tsmm.policy(abft="verify"):
        keep("abft_mm", record("abft_mm", lambda: tsmm.tsmm(a, b)))
        keep("abft_mmt", record("abft_mmt", lambda: tsmm.tsmm_t(x, y)))

    # fallbacks and errors
    a_odd = rows(inp["a"][:8191])
    x63 = rows(inp["x"][:, :63].contiguous())
    keep("odd", record("odd", lambda: tsmm.tsmm(a_odd, b)))
    with tsmm.policy(abft="verify"):     # the guard on a dense fallback
        keep("abft_odd", record("abft_odd", lambda: tsmm.tsmm(a_odd, b)))
    with tsmm.policy(shard_map="never"):
        keep("never", record("never", lambda: tsmm.tsmm(a, b)))
    with tsmm.policy(reduce="psum_scatter"):
        keep("x63", record("x63", lambda: tsmm.tsmm_t(x63, y)))
        with tsmm.policy(shard_map="require"):
            txt["require_scatter"] = _error_text(
                lambda: tsmm.tsmm_t(x63, y))
        with tsmm.policy(executor="shard_map"):
            txt["pin_shard_map_scatter"] = _error_text(
                lambda: tsmm.tsmm_t(x, y))
        with tsmm.policy(executor="shard_map-scatter"):
            txt["pin_scatter_rows"] = _error_text(
                lambda: tsmm.tsmm_t(x63, y))
    with tsmm.policy(shard_map="require"):
        txt["require"] = _error_text(lambda: tsmm.tsmm(a_odd, b))
    with tsmm.policy(executor="shard_map-scatter"):
        txt["pin_scatter_mm"] = _error_text(lambda: tsmm.tsmm(a, b))
        txt["pin_scatter_psum"] = _error_text(lambda: tsmm.tsmm_t(x, y))
    txt["mixed"] = _error_text(lambda: tsmm.tsmm(a, inp["b"]))

    # a mesh named "replica", and a dp_axes override naming no dim of it
    mesh_r = init_device_mesh("cpu", (2,), mesh_dim_names=("replica",))
    xr, yr = rows(inp["x"], mesh_r), rows(inp["y"], mesh_r)
    meta["derived_replica"] = tsmm.derive_dp_axes(mesh_r)
    with tsmm.policy(reduce="psum_scatter"):
        keep("replica", record("replica", lambda: tsmm.tsmm_t(xr, yr)))
        with tsmm.policy(dp_axes=("data",)):
            keep("replica_override", record(
                "replica_override", lambda: tsmm.tsmm_t(xr, yr)))

    # a mesh of one rank: the one-process route, local tensors rewrapped
    mesh1 = init_device_mesh("cpu", (2, 1),
                             mesh_dim_names=("pair", "data"))["data"]
    a1, b1 = rows(inp["a"], mesh1), rep(inp["b"], mesh1)
    one = record("one", lambda: tsmm.tsmm(a1, b1))
    meta["one"] = (type(one).__name__, one.device_mesh.size())
    out["one"] = one.to_local()
    out["plain"] = tsmm.tsmm(inp["a"], inp["b"])
    assert isinstance(one, DTensor)
    return {"out": out, "events": ev, "errors": txt, "meta": meta}


# ---------------------------------------------------------------------------
# The JAX package's side, on two host devices
# ---------------------------------------------------------------------------

JAX_SCRIPT = harness.JAX_PRELUDE + r"""
from repro.models import layers

I = INP
ev, txt = {}, {}


def run(name, fn, *args):
    with mesh, tsmm.record_dispatches() as log:
        OUT[name] = jax.jit(fn)(*args)
    ev[name] = events(log)


run("mm", lambda a, b: tsmm.tsmm(a, b), I["a"], I["b"])
run("mm3", lambda a, b: tsmm.tsmm(a, b), I["a3"], I["b"])
for tag, (ka, kb) in (("grad_r", ("a", "b")), ("grad_l", ("al", "bl"))):
    with mesh, tsmm.record_dispatches() as log:
        da, db = jax.jit(jax.grad(lambda a, b: jnp.sum(tsmm.tsmm(a, b)),
                                  (0, 1)))(I[ka], I[kb])
    ev[tag] = events(log)
    OUT[tag + "_da"], OUT[tag + "_db"] = da, db
for red in ("psum", "none", "psum_scatter"):
    with tsmm.policy(reduce=red):
        run("mmt_" + red, lambda x, y: tsmm.tsmm_t(x, y), I["x"], I["y"])
for red in ("psum", "psum_scatter"):
    with tsmm.policy(reduce=red, split=2):
        run("split_" + red, lambda x, y: tsmm.tsmm_t(x, y), I["x"], I["y"])
pol = tsmm.GemmPolicy(reduce="psum_scatter", param_dtype_grads=True)
with mesh, tsmm.policy(pol), tsmm.record_dispatches() as log:
    OUT["dense_dw"] = jax.jit(jax.grad(
        lambda w, x: jnp.sum(layers.dense(w, x))))(I["w"], I["xs"])
ev["dense_grad"] = events(log)
with tsmm.policy(abft="verify"):
    run("abft_mm", lambda a, b: tsmm.tsmm(a, b), I["a"], I["b"])
    run("abft_mmt", lambda x, y: tsmm.tsmm_t(x, y), I["x"], I["y"])

a_odd, x63 = I["a"][:8191], I["x"][:, :63]
run("odd", lambda a, b: tsmm.tsmm(a, b), a_odd, I["b"])
with tsmm.policy(abft="verify"):
    run("abft_odd", lambda a, b: tsmm.tsmm(a, b), a_odd, I["b"])
with tsmm.policy(shard_map="never"):
    run("never", lambda a, b: tsmm.tsmm(a, b), I["a"], I["b"])
with mesh:
    with tsmm.policy(reduce="psum_scatter"):
        with tsmm.policy(shard_map="require"):
            txt["require_scatter"] = error_text(
                lambda: tsmm.tsmm_t(x63, I["y"]))
        with tsmm.policy(executor="shard_map"):
            txt["pin_shard_map_scatter"] = error_text(
                lambda: tsmm.tsmm_t(I["x"], I["y"]))
        with tsmm.policy(executor="shard_map-scatter"):
            txt["pin_scatter_rows"] = error_text(
                lambda: tsmm.tsmm_t(x63, I["y"]))
    with tsmm.policy(shard_map="require"):
        txt["require"] = error_text(lambda: tsmm.tsmm(a_odd, I["b"]))
    with tsmm.policy(executor="shard_map-scatter"):
        txt["pin_scatter_mm"] = error_text(lambda: tsmm.tsmm(I["a"], I["b"]))
        txt["pin_scatter_psum"] = error_text(
            lambda: tsmm.tsmm_t(I["x"], I["y"]))
with tsmm.policy(reduce="psum_scatter"):
    run("x63", lambda x, y: tsmm.tsmm_t(x, y), x63, I["y"])

mesh_r = Mesh(np.array(devs), ("replica",))
REC["derived_replica"] = list(tsmm.derive_dp_axes(mesh_r))
for name, over in (("replica", {}), ("replica_override",
                                     {"dp_axes": ("data",)})):
    with mesh_r, tsmm.policy(reduce="psum_scatter", **over), \
            tsmm.record_dispatches() as log:
        OUT[name] = jax.jit(lambda x, y: tsmm.tsmm_t(x, y))(I["x"], I["y"])
    ev[name] = events(log)
REC["events"], REC["errors"] = ev, txt
save()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("shard_map")
    ranks, arrays, record = harness.run_both(port_rank, JAX_SCRIPT,
                                             _inputs(), work)
    return types.SimpleNamespace(ranks=ranks, jax=arrays, rec=record)


def _events(runs, name):
    port = [r["events"][name] for r in runs.ranks]
    assert port[0] == port[1], "the ranks routed differently"
    return port[0], harness.jax_events(runs.rec["events"][name])


def _close(runs, name, jname=None):
    want = torch.from_numpy(runs.jax[jname or name])
    for r in runs.ranks:
        torch.testing.assert_close(r["out"][name], want, **TOL)


# ---------------------------------------------------------------------------
# Routes and values
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,local", [("mm", (4096, 512, 8)),
                                        ("mm3", (4096, 512, 8))])
def test_mm_routes_per_shard_as_jax(runs, name, local):
    port, jax_ev = _events(runs, name)
    assert port == jax_ev
    assert ("mm", "tsm2r", "shard_map", (8192, 512, 8), "auto",
            "none") in port
    assert ("mm", "tsm2r", "pallas-tpu", local, "auto", "none") in port
    _close(runs, name)
    for r in runs.ranks:
        kind, shape, places = r["meta"][name]
        assert kind == "DTensor" and places == ["Shard(dim=0)"]
        assert shape == ((4096, 8) if name == "mm" else (1, 4096, 8))


@pytest.mark.parametrize("tag", ["grad_r", "grad_l"])
def test_gradients_of_both_operands_as_jax(runs, tag):
    port, jax_ev = _events(runs, tag)
    assert sorted(set(port)) == sorted(set(jax_ev))
    kinds = {(e[0], e[1]) for e in port}
    assert ("mmt", "tsmt") in kinds           # B's gradient, per shard
    if tag == "grad_l":
        assert ("mm", "tsm2l") in kinds
    _close(runs, f"{tag}_da")
    # the replicated operand's gradient is the sum over both shards
    _close(runs, f"{tag}_db")
    for r in runs.ranks:
        assert r["meta"][f"{tag}_da"][2] == ["Shard(dim=0)"]


@pytest.mark.parametrize("red,executor,global_shape,local_shape,places", [
    ("psum", "shard_map", (64, 8), (64, 8), ["Replicate()"]),
    ("none", "shard_map", (128, 8), (64, 8), ["Shard(dim=0)"]),
    ("psum_scatter", "shard_map-scatter", (64, 8), (32, 8),
     ["Shard(dim=0)"])])
def test_tsmm_t_reduce_modes_as_jax(runs, red, executor, global_shape,
                                    local_shape, places):
    name = f"mmt_{red}"
    port, jax_ev = _events(runs, name)
    assert port == jax_ev
    assert ("mmt", "tsmt", executor, (8192, 64, 8), "auto", "none") in port
    assert ("mmt", "tsmt", "pallas-tpu", (4096, 64, 8), "auto",
            "none") in port
    assert runs.jax[name].shape == global_shape
    _close(runs, name)
    for r in runs.ranks:
        assert r["out"][name].shape == global_shape
        assert r["meta"][name][1:] == (local_shape, places)
    if red == "none":     # the stacked partials sum to the product
        total = runs.ranks[0]["out"][name].view(2, 64, 8).sum(0)
        torch.testing.assert_close(total,
                                   runs.ranks[0]["out"]["mmt_psum"], **TOL)


@pytest.mark.parametrize("red,executor,local_shape", [
    ("psum", "shard_map", (64, 8)),
    ("psum_scatter", "shard_map-scatter", (32, 8))])
def test_split_per_shard_keeps_the_collective(runs, red, executor,
                                              local_shape):
    name = f"split_{red}"
    port, jax_ev = _events(runs, name)
    assert port == jax_ev
    pairs = {(e[2], e[4]) for e in port}
    assert (executor, 2) in pairs and ("pallas-tpu", 2) in pairs
    _close(runs, name)
    for r in runs.ranks:
        assert r["meta"][name][1] == local_shape


def test_dense_weight_gradient_arrives_row_sharded(runs):
    port, jax_ev = _events(runs, "dense_grad")
    assert sorted(set(port)) == sorted(set(jax_ev))
    assert ("mmt", "tsmt", "shard_map-scatter") in {e[:3] for e in port}
    _close(runs, "dense_dw")
    for r in runs.ranks:
        assert r["meta"]["dense_dw"][1:] == ((128, 8), ["Shard(dim=0)"])


@pytest.mark.parametrize("name,outer", [("abft_mm", "shard_map"),
                                        ("abft_mmt", "shard_map")])
def test_abft_guards_each_shard_not_the_outer_event(runs, name, outer):
    port, jax_ev = _events(runs, name)
    assert port == jax_ev
    guarded = [e for e in port if e[5] == "verify"]
    assert len(guarded) == 1 and guarded[0][2] == "pallas-tpu"
    assert guarded[0][3][0] == 4096                # the local shape
    assert [e[5] for e in port if e[2] == outer] == ["none"]
    _close(runs, name)
    for r in runs.ranks:
        torch.testing.assert_close(
            r["out"][name], r["out"]["mm" if name == "abft_mm"
                                     else "mmt_psum"], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Fallbacks and errors
# ---------------------------------------------------------------------------

def test_abft_guards_a_dense_fallback_as_jax(runs):
    """The guard wraps the fallback's dispatch (on the gathered operands
    here, under GSPMD in the reference); its checksum GEMMs route by
    their own shapes, so only the guarded event is compared."""
    port, jax_ev = _events(runs, "abft_odd")
    guarded = ("mm", "tsm2r", "dense-xla", (8191, 512, 8), "auto",
               "verify")
    assert [e for e in port if e[5] != "none"] == [guarded]
    assert [e for e in jax_ev if e[5] != "none"] == [guarded]
    _close(runs, "abft_odd")
    for r in runs.ranks:
        torch.testing.assert_close(r["out"]["abft_odd"], r["out"]["odd"],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("name", ["odd", "never", "x63",
                                  "replica_override"])
def test_fallbacks_take_the_dense_route_as_jax(runs, name):
    port, jax_ev = _events(runs, name)
    assert port == jax_ev
    assert [e[2] for e in port] == ["dense-xla"]
    _close(runs, name)


def test_replica_mesh_derives_its_dp_dim(runs):
    assert runs.rec["derived_replica"] == ["replica"]
    port, jax_ev = _events(runs, "replica")
    assert port == jax_ev
    assert "shard_map-scatter" in {e[2] for e in port}
    _close(runs, "replica")
    for r in runs.ranks:
        assert r["meta"]["derived_replica"] == ("replica",)


@pytest.mark.parametrize("name", ["require", "require_scatter",
                                  "pin_scatter_mm", "pin_scatter_rows"])
def test_errors_carry_the_reference_text(runs, name):
    want = runs.rec["errors"][name]
    for r in runs.ranks:
        assert r["errors"][name] == want


@pytest.mark.parametrize("name", ["pin_shard_map_scatter",
                                  "pin_scatter_psum"])
def test_pinned_contract_errors_as_jax(runs, name):
    """The texts match up to the list of executors declaring the mode,
    whose names differ between the packages."""
    want = runs.rec["errors"][name].split("Executors declaring")[0]
    for r in runs.ranks:
        got = r["errors"][name]
        assert got.split("Executors declaring")[0] == want
        assert "declared reduce contract" in got


def test_mesh_of_one_rank_takes_the_one_process_route(runs):
    for r in runs.ranks:
        assert r["meta"]["one"] == ("DTensor", 1)
        assert [e[2:4] for e in r["events"]["one"]] == [
            ("pallas-tpu", (8192, 512, 8))]
        torch.testing.assert_close(r["out"]["one"], r["out"]["plain"],
                                   rtol=0, atol=0)


# ---------------------------------------------------------------------------
# In this process: names, fields and pins (no collective reached)
# ---------------------------------------------------------------------------

_MESH_NAMES = [("anything",), ("model",), ("tp",), ("pod", "data", "model"),
               ("batch", "model"), ("nodes", "tensor"), ("model", "pipe"),
               ("replica", "model"), ("data",), ("dp", "pp", "sp")]


@pytest.mark.parametrize("names", _MESH_NAMES, ids="-".join)
def test_derive_dp_axes_as_jax(names):
    from repro.core import tsmm as jtsmm
    from repro.kernels import compat as jcompat

    jmesh = jcompat.abstract_mesh((2,) * len(names), names)
    mesh = types.SimpleNamespace(mesh_dim_names=names)
    assert tsmm.derive_dp_axes(mesh) == jtsmm.derive_dp_axes(jmesh)


@pytest.mark.parametrize("field,value", [("shard_map", "sometimes"),
                                         ("reduce", "all_reduce")])
def test_policy_fields_validate_as_jax(field, value):
    from repro.core import tsmm as jtsmm

    with pytest.raises(ValueError) as got:
        tsmm.GemmPolicy(**{field: value})
    with pytest.raises(ValueError) as want:
        jtsmm.GemmPolicy(**{field: value})
    assert str(got.value) == str(want.value)
    p = tsmm.GemmPolicy().with_(shard_map="local", dp_axes=("data",))
    assert (p.shard_map, p.dp_axes) == ("local", ("data",))


@pytest.mark.parametrize("reduce_", ["psum", "psum_scatter", "none"])
def test_backward_policy_reduce_as_jax(reduce_):
    from repro.core import tsmm as jtsmm

    p = tsmm.GemmPolicy(reduce=reduce_, executor="shard_map", split=2)
    jp = jtsmm.GemmPolicy(reduce=reduce_, executor="shard_map", split=2)
    bp, jbp = tsmm.backward_policy(p), jtsmm.backward_policy(jp)
    assert (bp.reduce, bp.executor, bp.split) == \
        (jbp.reduce, jbp.executor, jbp.split)


def test_pinned_shard_map_on_plain_tensors_raises_as_jax():
    from repro.core import tsmm as jtsmm
    import jax.numpy as jnp

    a, b = torch.ones(4096, 512), torch.ones(512, 8)
    with tsmm.policy(executor="shard_map"):
        with pytest.raises(RuntimeError) as got:
            tsmm.tsmm(a, b)
    with jtsmm.policy(executor="shard_map"):
        with pytest.raises(RuntimeError) as want:
            jtsmm.tsmm(jnp.ones((4096, 512)), jnp.ones((512, 8)))
    assert str(got.value).startswith(str(want.value))
    # the reduce contract is checked first, on any operands
    with tsmm.policy(executor="shard_map", reduce="psum_scatter"):
        with pytest.raises(RuntimeError, match="declared reduce contract"):
            tsmm.tsmm_t(torch.ones(4096, 64), torch.ones(4096, 8))


def test_dtensor_and_plain_tensor_do_not_mix(runs):
    for r in runs.ranks:
        assert "DTensor and a plain tensor" in r["errors"]["mixed"]


def test_shard_map_executors_registered_with_reference_contracts():
    from repro.core import tsmm as jtsmm

    for name in ("shard_map", "shard_map-scatter"):
        assert tsmm.executor_reduce_contract(name) == \
            jtsmm.executor_reduce_contract(name)
