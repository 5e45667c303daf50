"""The port's ``linalg.tree_tsqr`` against the JAX package's on two devices.

As ``tests/test_linalg_shard_map.py`` does for the reference: a two-rank
gloo world runs both schedules of ``tree_tsqr`` on each rank's row block
of a conditioned ``[8192,16]`` f32 operand, and a subprocess with two host
devices runs the JAX package's inside a shard_map
(``torch_dist_harness.run_both``, once for the module). Held, at the JAX
test's 1e-4:

* the gathered Q and the R of "butterfly", "gather" and "auto" against
  the JAX package's tree result and against the replicated
  ``linalg.tsqr`` of both packages (the sign convention makes the
  factorization unique); R the same on both ranks, diagonal >= 0;
* at cond 1e6: ``|Q^T Q - I| <= 1e-4``, R against the oracle at
  rtol 1e-3, reconstruction within 1e-5;
* the dispatch: the local CholeskyQR2 stages and the tree's apply on the
  kernel executors at the local row count, the events the reference
  records, and ``contracts.qr_stage_shapes(m, r, shards=2)``'s stages;
* a dim of one rank returns the local factorization;
* ``reduce=`` validation, and the butterfly's power-of-two rule.
"""

import types

import numpy as np
import pytest
import torch

import torch_dist_harness as harness
from repro_torch import linalg
from repro_torch.analysis import contracts

M, R = 8192, 16
SCHEDULES = ("butterfly", "gather", "auto")


def conditioned(cond, key):
    rng = np.random.default_rng(key)
    u, _ = np.linalg.qr(rng.standard_normal((M, R)))
    v, _ = np.linalg.qr(rng.standard_normal((R, R)))
    s = np.logspace(0, -np.log10(cond), R)
    return ((u * s) @ v.T).astype(np.float32)


def orth_err(q) -> float:
    q = q.double()
    return float((q.T @ q - torch.eye(q.shape[1], dtype=q.dtype)).abs()
                 .max())


def port_rank(rank, work):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import tsmm

    inp = {k: torch.from_numpy(v) for k, v in
           np.load(work / "inputs.npz").items()}
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
    rows = slice(rank * M // 2, (rank + 1) * M // 2)
    res = {}
    for key in ("a2", "a6"):
        for sched in SCHEDULES:
            with tsmm.record_dispatches() as log:
                q, r = linalg.tree_tsqr(inp[key][rows], mesh=mesh,
                                        axis="data", reduce=sched)
            res[f"{key}_{sched}"] = (q, r, harness.port_events(log))
    mesh1 = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    res["size1"] = linalg.tree_tsqr(inp["a2"], mesh=mesh1, axis="model")
    return res


JAX_SCRIPT = harness.JAX_PRELUDE + r"""
from repro import linalg
from repro.kernels import compat

ev = {}


def run_tree(a, reduce_):
    def body(a_loc):
        return linalg.tree_tsqr(a_loc, axis="data", reduce=reduce_)

    f = compat.shard_map(body, mesh=mesh, in_specs=(P("data", None),),
                         out_specs=(P("data", None), P(None, None)))
    with mesh:
        return jax.jit(f)(a)


for key in ("a2", "a6"):
    OUT[key + "_oracle_q"], OUT[key + "_oracle_r"] = linalg.tsqr(INP[key])
    for sched in ("butterfly", "gather", "auto"):
        with tsmm.record_dispatches() as log:
            OUT[f"{key}_{sched}_q"], OUT[f"{key}_{sched}_r"] = run_tree(
                INP[key], sched)
        ev[f"{key}_{sched}"] = events(log)
REC["events"] = ev
save()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("tree_tsqr")
    inputs = {"a2": conditioned(1e2, 0), "a6": conditioned(1e6, 1)}
    ranks, arrays, record = harness.run_both(port_rank, JAX_SCRIPT, inputs,
                                             work)
    return types.SimpleNamespace(ranks=ranks, jax=arrays, rec=record,
                                 inputs=inputs)


def _gathered(runs, name):
    q = torch.cat([r[name][0] for r in runs.ranks])
    rs = [r[name][1] for r in runs.ranks]
    torch.testing.assert_close(rs[0], rs[1], rtol=0, atol=0)
    return q, rs[0]


@pytest.mark.parametrize("sched", SCHEDULES)
def test_schedules_match_jax_and_the_oracle(runs, sched):
    q, r = _gathered(runs, f"a2_{sched}")
    for rank in runs.ranks:
        assert tuple(rank[f"a2_{sched}"][0].shape) == (M // 2, R)
    assert float(torch.diagonal(r).min()) >= 0.0
    tol = dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(q, torch.from_numpy(runs.jax[f"a2_{sched}_q"]),
                               **tol)
    torch.testing.assert_close(r, torch.from_numpy(runs.jax[f"a2_{sched}_r"]),
                               **tol)
    q_ref, r_ref = linalg.tsqr(torch.from_numpy(runs.inputs["a2"]))
    torch.testing.assert_close(q, q_ref, **tol)
    torch.testing.assert_close(r, r_ref, **tol)
    torch.testing.assert_close(q_ref, torch.from_numpy(runs.jax["a2_oracle_q"]),
                               **tol)


@pytest.mark.parametrize("sched", ("butterfly", "gather"))
def test_orthogonality_at_cond_1e6(runs, sched):
    q, r = _gathered(runs, f"a6_{sched}")
    assert orth_err(q) <= 1e-4
    a = torch.from_numpy(runs.inputs["a6"])
    _, r_ref = linalg.tsqr(a)
    torch.testing.assert_close(r, r_ref, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(r, torch.from_numpy(runs.jax[f"a6_{sched}_r"]),
                               rtol=1e-3, atol=1e-4)
    rec = float(torch.linalg.norm(q @ r - a) / torch.linalg.norm(a))
    assert rec <= 1e-5


@pytest.mark.parametrize("sched", SCHEDULES)
def test_local_stages_stay_on_the_kernels_as_jax(runs, sched):
    port = [r[f"a2_{sched}"][2] for r in runs.ranks]
    assert port[0] == port[1]
    assert port[0] == harness.jax_events(runs.rec["events"][f"a2_{sched}"])
    assert {e[2] for e in port[0]} == {"pallas-tpu"}    # torch-ref here
    assert {e[1] for e in port[0]} == {"tsm2l", "tsmt"}
    assert {e[3][0] for e in port[0]} == {M // 2}
    stages = set(contracts.qr_stage_shapes(M, R, shards=2))
    assert {(e[1], e[3]) for e in port[0]} == stages


def test_dim_of_one_rank_is_the_local_factorization(runs):
    q_ref, r_ref = linalg.tsqr(torch.from_numpy(runs.inputs["a2"]))
    for rank in runs.ranks:
        q, r = rank["size1"]
        torch.testing.assert_close(q, q_ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(r, r_ref, rtol=1e-5, atol=1e-5)


def test_reduce_validation():
    a = torch.ones(64, 4)
    with pytest.raises(ValueError, match="reduce"):
        linalg.tree_tsqr(a, mesh=None, axis="data", reduce="bogus")
    three = types.SimpleNamespace(mesh_dim_names=("data",), size=lambda: 3,
                                  get_local_rank=lambda: 0)
    a = torch.from_numpy(conditioned(1e2, 0)[:2048])
    with pytest.raises(ValueError, match="power-of-two"):
        linalg.tree_tsqr(a, mesh=three, axis="data", reduce="butterfly")
