"""The port's sharded PowerSGD against the JAX package's on two devices.

As the PowerSGD part of ``tests/test_scatter_shard_map.py`` does for the
reference: each rank of a two-rank gloo world holds its own gradient of a
``[4096,512]`` leaf, and the port's ``shard_state`` /
``compress_one_sharded`` / ``compress_tree_sharded`` run on it over the
``"data"`` dim of a mesh; a subprocess with two host devices runs the JAX
package's inside a shard_map (``torch_dist_harness.run_both``, once for
the module). Q's first value comes into both packages from numpy (the
reference's ``init`` salts its draw with Python's ``hash``). Held:

* under ``orth="gram_schmidt"`` and ``"tsqr"``: the decompressed
  gradient and the new Q against the replicated protocol on the mean
  gradient (``compress_one``) and against the JAX package's sharded
  result at 1e-4, Q row-sharded ``(d2/2, r)``; under ``"tsqr"`` every
  GEMM on the kernel executors, at the local shapes the reference
  records;
* under ``compress="int8"``: within the reference test's quantization
  envelope (2e-2 of the largest value) of the replicated protocol and of
  the JAX package's sharded result;
* ``compress_tree_sharded`` on a tree with a compressed leaf, a stacked
  3-D leaf and a stacked vector (both mean-reduced dense), and
  ``compress_tree(psum=)`` with a mean over the ranks, against the JAX
  package's;
* on a mesh dim of one rank, ``compress_tree_sharded`` equal to
  ``compress_tree`` bit for bit, under all three configurations.
"""

import types

import numpy as np
import pytest
import torch

import torch_dist_harness as harness
from repro_torch.optim import powersgd

D1, D2, RANK = 4096, 512, 4
CFGS = {"gs": dict(), "tsqr": dict(orth="tsqr"), "int8": dict(compress="int8")}
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg(tag, **over):
    return powersgd.PowerSGDConfig(**{"rank": RANK, "min_size": 0,
                                      **CFGS[tag], **over})


def _inputs():
    rng = np.random.default_rng(0)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"grads": n(2, D1, D2), "q0": n(D2, RANK),
            "bq": n(2, 2, 64), "wq": n(2, 2, 512, 256)}


def _tree(inp, rank):
    """Rank ``rank``'s gradients under the port's names: a compressed
    leaf, a stacked 3-D leaf and a stacked vector (each dense)."""
    return {"embed.table": inp["grads"][rank],
            "layers.0.attn.bq": inp["bq"][rank, 0],
            "layers.1.attn.bq": inp["bq"][rank, 1],
            "layers.0.attn.wq": inp["wq"][rank, 0],
            "layers.1.attn.wq": inp["wq"][rank, 1]}


def port_rank(rank, work):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import tsmm
    from repro_torch.kernels import compat

    inp = {k: torch.from_numpy(v) for k, v in
           np.load(work / "inputs.npz").items()}
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
    state0 = {"w": {"err": torch.zeros(D1, D2), "q": inp["q0"]}}
    g = inp["grads"][rank]
    res = {}
    for tag in CFGS:
        cfg = _cfg(tag)
        st = powersgd.shard_state(state0, mesh=mesh, axis="data")["w"]
        with tsmm.record_dispatches() as log:
            approx, st2 = powersgd.compress_one_sharded(
                cfg, g, st, mesh=mesh, axis="data")
        oracle, st_o = powersgd.compress_one(cfg, inp["grads"].mean(0),
                                             state0["w"])
        res[tag] = {"approx": approx, "q": st2["q"], "q_shard": st["q"],
                    "err": st2["err"], "oracle": oracle,
                    "oracle_q": st_o["q"],
                    "events": harness.port_events(log)}

    # compress_tree_sharded over a tree, and compress_tree with psum=
    cfg = powersgd.PowerSGDConfig(rank=RANK, min_size=4096)
    tree = _tree(inp, rank)
    tstate = {"embed.table": dict(state0["w"])}
    out, st2, met = powersgd.compress_tree_sharded(
        cfg, tree, powersgd.shard_state(tstate, mesh=mesh, axis="data"),
        mesh=mesh, axis="data")
    res["tree"] = {"out": out, "q": st2["embed.table"]["q"], "metrics": met}
    out, st2, met = powersgd.compress_tree(
        cfg, tree, tstate, psum=lambda t: compat.pmean(t, mesh, "data"))
    res["psum"] = {"out": out, "q": st2["embed.table"]["q"], "metrics": met}

    # a dim of one rank: the sharded protocol is the replicated one
    mesh1 = init_device_mesh("cpu", (2, 1),
                             mesh_dim_names=("pair", "data"))
    same = {}
    for tag in CFGS:
        cfg = _cfg(tag, min_size=4096)
        a, sa, ma = powersgd.compress_tree(cfg, tree, tstate)
        b, sb, mb = powersgd.compress_tree_sharded(
            cfg, tree, powersgd.shard_state(tstate, mesh=mesh1, axis="data"),
            mesh=mesh1, axis="data")
        same[tag] = (all(torch.equal(a[n], b[n]) for n in tree)
                     and all(torch.equal(sa["embed.table"][k],
                                         sb["embed.table"][k])
                             for k in ("q", "err")) and ma == mb)
    res["one_rank"] = same
    return res


JAX_SCRIPT = harness.JAX_PRELUDE + r"""
from jax import lax

from repro.kernels import compat
from repro.optim import powersgd

grads, q0 = INP["grads"], INP["q0"]
state0 = {"w": {"err": jnp.zeros(grads.shape[1:]), "q": q0}}
ev = {}
CFGS = {"gs": {}, "tsqr": {"orth": "tsqr"}, "int8": {"compress": "int8"}}
for tag, over in CFGS.items():
    cfg = powersgd.PowerSGDConfig(rank=4, min_size=0, **over)

    def body(g_local):
        st = powersgd.shard_state(state0, "data")["w"]
        approx, st2 = powersgd.compress_one_sharded(cfg, g_local[0], st,
                                                    axis="data")
        return approx, st2["q"]

    f = compat.shard_map(body, mesh=mesh, in_specs=(P("data", None, None),),
                         out_specs=(P(None, None), P("data", None)))
    with mesh, tsmm.record_dispatches() as log:
        OUT[tag + "_approx"], OUT[tag + "_q"] = jax.jit(f)(grads)
    ev[tag] = events(log)

cfg = powersgd.PowerSGDConfig(rank=4, min_size=4096)
tree = {"embed": {"table": grads}, "bq": INP["bq"], "wq": INP["wq"]}
tstate = {"embed": {"table": dict(state0["w"])}, "bq": None, "wq": None}
specs = {"embed": {"table": P("data", None, None)},
         "bq": P("data", None, None), "wq": P("data", None, None, None)}
out_specs = {"embed": {"table": P(None, None)}, "bq": P(None, None),
             "wq": P(None, None, None)}


def local(t):
    return jax.tree.map(lambda x: x[0], t)


def tree_body(gt):
    st = powersgd.shard_state(tstate, "data")
    out, st2, met = powersgd.compress_tree_sharded(cfg, local(gt), st,
                                                   axis="data")
    return out, st2["embed"]["table"]["q"], met["powersgd_compression"]


def psum_body(gt):
    # inside its own shard_map the replicated protocol dispatches locally
    out, st2, met = powersgd.compress_tree(
        cfg, local(gt), tstate, psum=lambda t: lax.pmean(t, "data"),
        policy=tsmm.GemmPolicy(shard_map="local"))
    return out, st2["embed"]["table"]["q"], met["powersgd_compression"]


for name, body, q_spec in (("tree", tree_body, P("data", None)),
                           ("psum", psum_body, P(None, None))):
    f = compat.shard_map(body, mesh=mesh, in_specs=(specs,),
                         out_specs=(out_specs, q_spec, P()))
    with mesh:
        out, q, met = jax.jit(f)(tree)
    OUT[name + "_embed"], OUT[name + "_bq"] = out["embed"]["table"], out["bq"]
    OUT[name + "_wq"], OUT[name + "_q"] = out["wq"], q
    REC[name + "_metric"] = float(met)
REC["events"] = ev
save()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("powersgd_sharded")
    ranks, arrays, record = harness.run_both(port_rank, JAX_SCRIPT,
                                             _inputs(), work)
    return types.SimpleNamespace(ranks=ranks, jax=arrays, rec=record)


def _jax(runs, name):
    return torch.from_numpy(runs.jax[name])


@pytest.mark.parametrize("tag", ["gs", "tsqr"])
def test_sharded_protocol_matches_oracle_and_jax(runs, tag):
    q = torch.cat([r[tag]["q"] for r in runs.ranks])
    for r in runs.ranks:
        assert tuple(r[tag]["q"].shape) == (D2 // 2, RANK)
        assert tuple(r[tag]["q_shard"].shape) == (D2 // 2, RANK)
        torch.testing.assert_close(r[tag]["approx"], r[tag]["oracle"], **TOL)
        torch.testing.assert_close(r[tag]["approx"],
                                   _jax(runs, f"{tag}_approx"), **TOL)
    torch.testing.assert_close(q, runs.ranks[0][tag]["oracle_q"], **TOL)
    torch.testing.assert_close(q, _jax(runs, f"{tag}_q"), **TOL)
    # error feedback keeps each rank's own residual
    g = torch.from_numpy(_inputs()["grads"])
    for rank, r in enumerate(runs.ranks):
        torch.testing.assert_close(r[tag]["err"], g[rank] - r[tag]["approx"],
                                   rtol=0, atol=0)


def test_tsqr_protocol_stays_on_the_kernels_as_jax(runs):
    port = [r["tsqr"]["events"] for r in runs.ranks]
    assert port[0] == port[1]
    assert {e[2] for e in port[0]} == {"pallas-tpu"}     # torch-ref here
    assert sorted(set(port[0])) == sorted(set(
        harness.jax_events(runs.rec["events"]["tsqr"])))


def test_int8_within_the_quantization_envelope(runs):
    for r in runs.ranks:
        for got, want in ((r["int8"]["approx"], r["int8"]["oracle"]),
                          (r["int8"]["approx"], _jax(runs, "int8_approx"))):
            assert float((got - want).abs().max()) <= \
                2e-2 * float(want.abs().max())
        assert tuple(r["int8"]["q"].shape) == (D2 // 2, RANK)
    q = torch.cat([r["int8"]["q"] for r in runs.ranks])
    for want in (runs.ranks[0]["int8"]["oracle_q"], _jax(runs, "int8_q")):
        assert float((q - want).abs().max()) <= 2e-2 * float(want.abs().max())


@pytest.mark.parametrize("name", ["tree", "psum"])
def test_compress_tree_over_the_ranks_as_jax(runs, name):
    for r in runs.ranks:
        out = r[name]["out"]
        torch.testing.assert_close(out["embed.table"],
                                   _jax(runs, f"{name}_embed"), **TOL)
        bq = torch.stack([out["layers.0.attn.bq"], out["layers.1.attn.bq"]])
        wq = torch.stack([out["layers.0.attn.wq"], out["layers.1.attn.wq"]])
        torch.testing.assert_close(bq, _jax(runs, f"{name}_bq"), **TOL)
        torch.testing.assert_close(wq, _jax(runs, f"{name}_wq"), **TOL)
        assert r[name]["metrics"]["powersgd_compression"] == \
            pytest.approx(runs.rec[f"{name}_metric"], rel=1e-6)
    q = [r[name]["q"] for r in runs.ranks]
    q = torch.cat(q) if name == "tree" else q[0]
    torch.testing.assert_close(q, _jax(runs, f"{name}_q"), **TOL)


@pytest.mark.parametrize("tag", list(CFGS))
def test_one_rank_equals_the_replicated_protocol_bit_for_bit(runs, tag):
    assert all(r["one_rank"][tag] for r in runs.ranks)
