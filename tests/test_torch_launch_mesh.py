"""The port's launcher under ``--distributed`` (``repro_torch.launch.train``)
in a two-rank gloo world, against the JAX launcher on two host devices.

Each rank runs ``main`` as torchrun would start it (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``; a port
a run), with ``--device cpu``, so the launcher starts its own gloo group
from that environment, places the state on ``make_host_mesh`` by the
sharding rules and destroys the group when it returns. Both packages
start from the JAX package's initial train state (the port's
``init_train_state`` returns it carried over by ``convert.
state_from_jax``, as ``tests/test_torch_launch.py`` does), at the chatglm3
smoke size with that file's batch:

* ``--model-axis 1`` (mesh (2, 1)) and ``--model-axis 2`` (mesh (1, 2)),
  a NaN before step 3: the rollback happens once, the ``[chaos]`` /
  ``[ft]`` lines are the JAX launcher's, and the final loss is its
  (rtol 1e-4, ``tests/test_torch_train.py``'s tolerance);
* a checkpoint written by the (1, 2) world after step 2 resumes in the
  (2, 1) world (``elastic.restore_state`` places its full leaves) and
  ends on the uninterrupted run's final loss (the reference's rescale
  invariant, up to the reduction order: rtol 1e-4);
* both ranks report the same results, and no group is left up;
* ``rescale_plan`` refuses an empty device set (``[rescale-mesh]``);
* ``--abft-every 1`` on the rwkv6 smoke config (the port's own initial
  state; ``abft.MIN_LEAF`` lowered so its leaves get checksums): the
  offline check before each save runs on the DTensor parameters and
  passes, and a parameter poisoned between the encode and the verify
  (``ft.inject.poison_tree``) makes the launcher refuse to save.

The ranks import this module, so it imports no JAX.
"""

import contextlib
import io
import os
import pickle
import socket
import types

import numpy as np
import pytest

import torch_dist_harness as harness

BASE = ["--arch", "chatglm3-6b", "--smoke", "--global-batch", "4",
        "--seq-len", "32", "--log-every", "100"]
RUNS = {"m1": ["--model-axis", "1", "--steps", "6", "--chaos-step", "3"],
        "m2": ["--model-axis", "2", "--steps", "6", "--chaos-step", "3"],
        "save12": ["--model-axis", "2", "--steps", "3", "--ckpt-every",
                   "1"],
        "resume21": ["--model-axis", "1", "--steps", "6", "--ckpt-every",
                     "100"]}
TOL = dict(rtol=1e-4)
ABFT_BASE = ["--arch", "rwkv6-1.6b", "--smoke", "--global-batch", "4",
             "--seq-len", "32", "--log-every", "100", "--model-axis", "2",
             "--steps", "2", "--abft-every", "1", "--ckpt-every", "1"]
ABFT_RUNS = ("abft_clean", "abft_poisoned")


def _lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("[ft]", "[chaos]", "[train] restored"))]


def launcher_rank(rank, work):
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.launch import train
    from repro_torch.train import train_step

    with open(work / "jstate.pkl", "rb") as f:
        jstate = pickle.load(f)

    def from_jax(seed, cfg, opt_cfg, extra=None, *, device=None):
        assert seed == 0 and extra is None
        return convert.state_from_jax(cfg, jstate, device=device)

    own_init = train_step.init_train_state
    train_step.init_train_state = from_jax    # this rank's process only
    ports = np.load(work / "inputs.npz")["ports"]
    out = {}
    for port, (tag, extra) in zip(ports, RUNS.items()):
        _environ(rank, port)
        if tag in ("save12", "resume21"):
            extra = extra + ["--ckpt-dir", str(work / "ckpt")]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = train.main(BASE + ["--device", "cpu", "--distributed"]
                             + extra)
        out[tag] = {"result": res, "lines": _lines(buf.getvalue()),
                    "group_left_up": dist.is_initialized()}
    train_step.init_train_state = own_init
    for port, tag in zip(ports[len(RUNS):], ABFT_RUNS):
        _environ(rank, port)
        out[tag] = _abft_run(tag, work)
    return out


def _environ(rank, port):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(harness.WORLD),
                      LOCAL_RANK=str(rank))


def _abft_run(tag, work):
    """The launcher under ``--abft-every 1``: each check's verdict and
    whether its leaves were DTensors; in the poisoned run the parameters
    are poisoned right after the encode, so the verify must catch it."""
    from unittest import mock

    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.ft import abft, inject, is_dtensor
    from repro_torch.launch import train

    checks = []
    encode, verify = abft.encode_tree, abft.verify_tree

    def encode_tree(tree, *a, **kw):
        sums = encode(tree, *a, **kw)
        if tag == "abft_poisoned":
            inject.poison_tree(tree)
        return sums

    def verify_tree(tree, sums, *a, **kw):
        ok, devs = verify(tree, sums, *a, **kw)
        checks.append((bool(ok), len(devs), all(
            is_dtensor(c) for c in sums.values() if c is not None)))
        return ok, devs

    ckpt_dir = work / f"ckpt_{tag}"
    argv = ABFT_BASE + ["--device", "cpu", "--distributed", "--ckpt-dir",
                        str(ckpt_dir)]
    err = res = None
    with mock.patch.object(abft, "MIN_LEAF", 1024), \
            mock.patch.object(abft, "encode_tree", encode_tree), \
            mock.patch.object(abft, "verify_tree", verify_tree), \
            contextlib.redirect_stdout(io.StringIO()):
        try:
            res = train.main(argv)
        except RuntimeError as e:
            err = str(e)
    return {"result": res, "error": err, "checks": checks,
            "saved": Checkpointer(str(ckpt_dir)).all_steps(),
            "group_left_up": dist.is_initialized()}


JAX_SCRIPT = harness.JAX_PRELUDE + r"""
import contextlib, io

from repro.launch import train

BASE = %r
for tag, model_axis in (("m1", "1"), ("m2", "2")):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = train.main(BASE + ["--model-axis", model_axis, "--steps", "6",
                                 "--chaos-step", "3"])
    REC[tag] = {"result": {k: v for k, v in res.items()},
                "lines": [ln for ln in buf.getvalue().splitlines()
                          if ln.startswith(("[ft]", "[chaos]"))]}
save()
""" % (BASE,)


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("localhost", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.configs import registry as jregistry
    from repro.optim import adamw as jadamw
    from repro.train import train_step as jts

    work = tmp_path_factory.mktemp("launch_mesh")
    jcfg = jregistry.get_config("chatglm3-6b", smoke=True)
    jstate = jts.init_train_state(jax.random.PRNGKey(0), jcfg,
                                  jadamw.AdamWConfig())
    with open(work / "jstate.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, jstate), f)
    ranks, _, record = harness.run_both(
        launcher_rank, JAX_SCRIPT,
        {"ports": np.array(_free_ports(len(RUNS) + len(ABFT_RUNS)))}, work,
        timeout=400,
        init=False)
    return types.SimpleNamespace(ranks=ranks, rec=record)


def test_ranks_agree_and_leave_no_group(runs):
    a, b = runs.ranks
    for tag in RUNS:
        assert a[tag]["result"] == b[tag]["result"], tag
        assert not a[tag]["group_left_up"] and not b[tag]["group_left_up"]


@pytest.mark.parametrize("tag", ["m1", "m2"])
def test_distributed_launcher_matches_jax(runs, tag):
    want = runs.rec[tag]
    for r in runs.ranks:
        got = r[tag]
        assert got["lines"] == want["lines"] and len(got["lines"]) == 2
        assert (got["result"]["fault_retries"],
                got["result"]["fault_events"]) == (1, 1)
        assert got["result"]["final_step"] == want["result"]["final_step"]
        np.testing.assert_allclose(got["result"]["final_loss"],
                                   want["result"]["final_loss"], **TOL)


def test_chaos_rollback_under_distributed(runs):
    for r in runs.ranks:
        for tag in ("m1", "m2"):
            assert r[tag]["lines"][0] == "[chaos] poisoned state before step 3"
            assert r[tag]["lines"][1].startswith(
                "[ft] step 3 fault: rolled back to snapshot at step 2")


def test_checkpoint_of_one_mesh_resumes_on_another(runs):
    for r in runs.ranks:
        assert r["save12"]["result"]["final_step"] == 2
        assert r["resume21"]["lines"] == [
            "[train] restored checkpoint at step 2"]
        assert r["resume21"]["result"]["fault_retries"] == 0
        np.testing.assert_allclose(r["resume21"]["result"]["final_loss"],
                                   r["m1"]["result"]["final_loss"], **TOL)


def test_rescale_plan_refuses_an_empty_device_set():
    from repro_torch.ft import elastic
    with pytest.raises(ValueError, match=r"\[rescale-mesh\] no surviving"):
        elastic.rescale_plan(devices=[])
    plan = elastic.rescale_plan(devices=["cpu"])
    assert plan.mesh is None and plan.shape == (1, 1)


def test_abft_check_before_each_save_under_distributed(runs):
    for r in runs.ranks:
        clean = r["abft_clean"]
        assert clean["error"] is None and not clean["group_left_up"]
        assert clean["result"]["final_step"] == 1
        # one check a save, each on DTensor leaves with checksums, all clean
        assert [c[0] for c in clean["checks"]] == [True, True]
        assert all(n > 0 and on_mesh for _, n, on_mesh in clean["checks"])
        assert clean["saved"] == [0, 1]


def test_abft_poisoned_parameters_are_not_saved(runs):
    for r in runs.ranks:
        bad = r["abft_poisoned"]
        assert bad["result"] is None and not bad["group_left_up"]
        assert "[abft] silent data corruption detected" in bad["error"]
        assert [c[0] for c in bad["checks"]] == [False]
        assert bad["saved"] == []
