"""The port's dry run (``repro_torch/launch/dryrun.py``) and report
(``repro_torch/roofline/report.py``).

Two subprocesses, started together (a fake process group never lives in a
test worker, which runs other files after this one):

* one cell end to end through the command line, cut to 2 layers on a
  fake world of 16 ((2, 8) ("data", "model")): the reference's JSON keys,
  the op log that ``--reanalyze`` reprices to the same terms, and the
  report's tables from it;
* chatglm3-6b at full width, 2 layers, on a fake (2, 8) mesh: its two kv
  heads under a model axis of 8 through a prefill with caches from
  ``init_cache(mesh=)``, a decode step and a train step of 3 microbatches
  over 2 dp ranks (``attention.split_heads``, ``heads.local_heads``,
  ``train_step._rows_whole``), counted, with wk / wv per shard on the
  shape-only TSM2X route under lowered thresholds; then, on a (2, 4, 2)
  mesh with "pod", batches under its 8 dp ranks through tsm2r
  (``tsmm._rows_unflatten``) and a mixtral MoE layer (``moe.moe_fwd``).

In this process: the depth cuts' coefficients, ``pick_hillclimb`` against
the reference's on the same cell dicts, and AdamW's bf16 moments
(``state_dtype``) against the JAX update. ~25 s.
"""

import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.roofline import report

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEYS = {"cost_flops", "cost_bytes", "roofline", "collective_counts",
        "collective_by_kind", "tsm2x_calls", "memory", "status", "count_s",
        "torch", "placements", "n_chips", "mesh", "arch", "shape"}
ROOFLINE = {"compute_s", "memory_s", "collective_s", "dominant",
            "collective_bytes", "useful_flops_ratio"}

AXIS8 = r"""
import dataclasses, json
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs import registry
from repro_torch.core import tsmm
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.roofline import analyze
from repro_torch.train import train_step

META = torch.device("meta")
out = {}
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
try:
    mesh = make_production_mesh(device_type="cuda")
    cfg = dataclasses.replace(registry.get_config("chatglm3-6b"), n_layers=2)
    lm = model.LM(cfg, META)
    specs = sharding.make_param_specs(cfg, lm, mesh)
    sharding.named(mesh, specs, lm)
    out["wk"] = [repr(p) for p in lm.layers[0].attn.wk.placements]

    def place(batch):
        return sharding.named(mesh, sharding.batch_specs(cfg, mesh, batch),
                              batch)

    b, s = 6, 64
    toks = place({"tokens": torch.empty(b, s, dtype=torch.int64,
                                        device=META)})
    cache = model.init_cache(cfg, b, s + 8, device=META, mesh=mesh)
    out["cache_k"] = [repr(p) for p in cache[0]["k"].placements]
    logits, cache = model.prefill(lm, cfg, toks, cache)
    out["prefill"] = [list(logits.shape), [repr(p) for p in
                                           logits.placements]]
    one = place({"tokens": torch.empty(b, 1, dtype=torch.int64,
                                       device=META)})["tokens"]
    logits, cache = model.decode_step(lm, cfg, one, s, cache)
    out["decode"] = list(logits.shape)

    lm.requires_grad_(True)
    opt = adamw.AdamWConfig()
    state = {"params": lm, "opt": adamw.init(opt, lm)}
    step = train_step.make_train_step(
        cfg, opt, n_micro=3, acc_shardings=sharding.named(mesh, specs),
        mesh=mesh)
    batch = place({"tokens": torch.empty(b, 512, dtype=torch.int64,
                                         device=META),
                   "targets": torch.empty(b, 512, dtype=torch.int64,
                                          device=META)})
    with tsmm.policy(min_tall=256, skinny_ratio=2):
        (state, metrics), log = dryrun.count(step, state, batch)
    out["metrics"] = sorted(metrics)
    out["grad_wk"] = [repr(p) for p in lm.layers[0].attn.wk.placements]
    out["tsm2x"] = [[e["kernel"], e["shape"], e["n"], e["executor"]]
                    for e in log.entries if e["cls"] == "tsm2x"]
    out["flops"] = analyze.cost(log)["flops"]
    out["collectives"] = analyze.collectives(log).counts

    # batches under the dp ranks of a (2, 4, 2) mesh with "pod": 4 and 2
    # sequences over 8, whose per-shard rows cut across sequences
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    mesh3 = init_device_mesh("cuda", (2, 4, 2),
                             mesh_dim_names=("pod", "data", "model"))
    x = DTensor.from_local(torch.empty(4, 1024, 512, device=META), mesh3,
                           [Replicate()] * 3, run_check=False)
    w = DTensor.from_local(torch.empty(512, 16, device=META), mesh3,
                           [Replicate()] * 3, run_check=False)
    with tsmm.policy(min_tall=256):
        y, log = dryrun.count(tsmm.tsmm, x, w)
    out["short_batch"] = [list(y.shape), [
        [e["kernel"], e["shape"]] for e in log.entries
        if e["cls"] == "tsm2x"]]
    mcfg = dataclasses.replace(registry.get_config("mixtral-8x7b"),
                               n_layers=1)
    lm = model.LM(mcfg, META)
    sharding.named(mesh3, sharding.make_param_specs(mcfg, lm, mesh3), lm)
    toks = torch.empty(2, 64, dtype=torch.int64, device=META)
    logits, _ = model.prefill(
        lm, mcfg, sharding.named(mesh3, sharding.batch_specs(
            mcfg, mesh3, {"tokens": toks}), {"tokens": toks}),
        model.init_cache(mcfg, 2, 64, device=META, mesh=mesh3))
    out["moe_short_batch"] = list(logits.shape)
finally:
    dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cli = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "chatglm3-6b", "--shape", "decode_32k", "--mesh", "single",
           "--world", "16", "--layers", "2", "--out", str(out)]
    procs = [subprocess.Popen(args, env=env, cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for args in (cli, [sys.executable, "-c", AXIS8])]
    res = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, res):
        assert p.returncode == 0, err[-4000:]
    path = out / "chatglm3-6b__decode_32k__single.json"
    cell = json.loads(path.read_text())
    again = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--reanalyze",
         "--out", str(out)], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert again.returncode == 0, again.stderr[-4000:]
    return types.SimpleNamespace(
        cell=cell, reanalyzed=json.loads(path.read_text()), dir=out,
        axis8=json.loads(res[1][0].strip().splitlines()[-1]))


def test_cell_writes_the_reference_keys(runs):
    c = runs.cell
    assert KEYS <= c.keys() and ROOFLINE <= c["roofline"].keys()
    assert c["status"] == "ok" and c["mesh"] == "2x8" and c["n_chips"] == 16
    assert c["torch"] == torch.__version__
    assert c["placements"] == "placements proven under this torch only"
    assert c["device"] == "meta" and c["world"] == "fake"
    assert c["cost_flops"] > 0 and c["cost_bytes"] > c["cost_flops"]
    assert set(c["collective_by_kind"]) == set(c["collective_counts"])
    assert c["collective_counts"]["all-gather"] > 0
    assert c["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert [cut["coef"] for cut in c["cuts"]] == [0, 1]   # 2 layers: 2 x 1
    mem = c["memory"]
    assert mem["total_bytes"] == sum(mem[k] for k in (
        "param_bytes", "opt_bytes", "cache_bytes", "batch_bytes"))
    assert mem["fits_80gb_hbm"] is True and mem["cache_bytes"] > 0
    assert (runs.dir / "chatglm3-6b__decode_32k__single.ops.json.gz"
            ).exists()


def test_reanalyze_reprices_to_the_same_terms(runs):
    for key in ("cost_flops", "cost_bytes", "roofline", "collective_by_kind",
                "tsm2x_calls"):
        assert runs.reanalyzed[key] == runs.cell[key], key


def test_report_tables(runs):
    cells = report.load(runs.dir)
    dry = report.dryrun_table(cells).splitlines()
    assert dry[0].startswith("| arch | shape | mesh | status | count")
    assert "fits 80G" in dry[0]
    assert dry[2].startswith("| chatglm3-6b | decode_32k | 2x8 | ok |")
    roof = report.roofline_table(cells, mesh="2x8").splitlines()
    assert len(roof) == 3 and f"**{runs.cell['roofline']['dominant']}**" \
        in roof[2]
    assert report.roofline_table(cells).count("\n") == 1   # none at 32x8
    both = report.both_meshes_table(cells, meshes=("2x8", "32x8"))
    row = both.splitlines()[2]
    assert row.startswith("| chatglm3-6b | decode_32k | ")
    assert f"| {runs.cell['roofline']['dominant']} / — |" in row
    assert report.fmt_s(2.5) == "2.50s" and report.fmt_s(3e-3) == "3.00ms"


def _cell(arch, shape, c, m, coll, mesh):
    dom = max((c, "compute"), (m, "memory"), (coll, "collective"))[1]
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
            "roofline": {"compute_s": c, "memory_s": m, "collective_s": coll,
                         "dominant": dom}}


def test_pick_hillclimb_as_jax(runs):
    from repro.roofline import report as jreport
    rows = [("a", "train_4k", 1.0, 0.5, 0.1), ("b", "decode_32k", 0.01, 0.2,
                                                0.3),
            ("c", "prefill_32k", 0.3, 0.9, 0.05), ("d", "train_4k", 2.0, 1.0,
                                                   1.9)]
    port = [_cell(*r, mesh="32x8") for r in rows]
    ref = [_cell(*r, mesh="16x16") for r in rows]
    got = [(d["arch"], d["shape"]) for d in report.pick_hillclimb(port)]
    want = [(d["arch"], d["shape"]) for d in jreport.pick_hillclimb(ref)]
    assert got == want
    # and on the end-to-end cell beside them
    cell = dict(runs.cell, mesh="32x8")
    got = report.pick_hillclimb(port + [cell])
    want = jreport.pick_hillclimb(ref + [dict(runs.cell, mesh="16x16")])
    assert [d["arch"] for d in got] == [d["arch"] for d in want]


def test_chatglm3_at_model_axis_8(runs):
    """Fails at ``k.reshape(b, s, n_kv, head_dim)`` without the repair: two
    kv heads do not unflatten from a feature dim split 8 ways."""
    a = runs.axis8
    assert a["wk"] == ["Replicate()", "Shard(dim=1)"]
    # two kv heads under 8 ranks: the caches shard their sequence
    assert a["cache_k"] == ["Shard(dim=0)", "Shard(dim=1)"]
    vocab = registry.get_config("chatglm3-6b").vocab_size
    assert a["prefill"][0] == [6, vocab] and a["decode"] == [6, vocab]
    assert {"loss", "grad_norm", "step_ok"} <= set(a["metrics"])
    assert a["grad_wk"] == a["wk"]
    # wk and wv of 2 layers, each microbatch's forward and its remat
    # recompute: 2 x 2 x 3 x 2 per-shard tsm2r calls of 512 rows
    (call,) = a["tsm2x"]
    assert call[0] == "tsm2r" and call[1] == [512, 4096, 256]
    assert call[2] == 24 and call[3] == dryrun.SHAPE_ONLY
    assert a["flops"] > 0 and a["collectives"]["all-reduce"] > 0


def test_per_shard_rows_of_a_batch_under_the_dp_ranks(runs):
    """A (4, 1024, 512) lhs on tsm2r over the 8 dp ranks of (2, 4, 2): each
    rank's 512 rows are half a sequence, which DTensor cannot unflatten
    back to (4, 1024, 16) (``tsmm._rows_unflatten`` gathers them; the
    parent tree raised, as rwkv6's prefill_32k, 32 sequences over 64
    ranks, did on (2, 32, 8))."""
    shape, calls = runs.axis8["short_batch"]
    assert shape == [4, 1024, 16]
    # a MoE layer's output rows likewise, 2 sequences over 8
    # (``moe.moe_fwd``)
    vocab = registry.get_config("mixtral-8x7b").vocab_size
    assert runs.axis8["moe_short_batch"] == [2, vocab]
    assert calls == [["tsm2r_split", [512, 512, 16]]]   # the chooser's S


@pytest.mark.parametrize("arch", registry.ARCH_NAMES)
def test_depth_cuts_recover_the_layer_counts(arch):
    cfg = registry.get_config(arch)
    cuts = dryrun.depth_cuts(cfg)
    total = [sum(c * x for c, x in zip(
        [c for c, _ in cuts], col)) for col in zip(
        *[(1, *dryrun.layer_counts(cut)) for _, cut in cuts])]
    assert total == [1, *dryrun.layer_counts(cfg)]
    assert all(cut.n_layers <= 4 for _, cut in cuts)


def test_adamw_bf16_moments_as_jax():
    """``AdamWConfig.state_dtype``: the moments stored in bf16, the update
    in f32 from them, as the reference's (the dry run's choice past 1e11
    parameters)."""
    import jax.numpy as jnp

    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw

    rng = np.random.default_rng(0)
    w = rng.normal(size=(8, 16)).astype(np.float32)
    grads = [rng.normal(size=(8, 16)).astype(np.float32) for _ in range(3)]
    jcfg = jadamw.AdamWConfig(lr=1e-2, state_dtype="bfloat16")
    jp = {"w": jnp.asarray(w)}
    jst = jadamw.init(jcfg, jp)
    params = torch.nn.ParameterDict({"w": torch.nn.Parameter(
        torch.from_numpy(w.copy()))})
    cfg = adamw.AdamWConfig(lr=1e-2, state_dtype="bfloat16")
    st = adamw.init(cfg, params)
    assert st["moments"]["w"]["m"].dtype == torch.bfloat16
    for g in grads:
        jp, jst, _ = jadamw.update(jcfg, jp, {"w": jnp.asarray(g)}, jst)
        adamw.update(cfg, params, {"w": torch.from_numpy(g)}, st)
    np.testing.assert_allclose(params["w"].detach().numpy(),
                               np.asarray(jp["w"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        st["moments"]["w"]["v"].float().numpy(),
        np.asarray(jst["moments"]["w"]["v"], np.float32))
