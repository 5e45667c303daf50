"""The port's roofline counters (``repro_torch/roofline/analyze.py``) against
hand counts and the JAX package's ``repro/roofline/analyze.py``: the
counterparts of ``tests/test_roofline.py``.

On meta tensors, in this process: a single product's FLOPs and bytes, a
loop's bytes, an L-layer model's count equal to its cut depths combined
(one layer of each kind, then one more), and a TSM2X call priced from
``record_dispatches``. In one subprocess over fake process groups (a
fake group never lives in a test worker, which runs other files after
this one): an all-reduce's wire bytes, a collective inside a repeated
layer, and the per-rank FLOPs of sharded and replicated products on a
(2, 8) mesh, with llama3.2-3b's one-layer decode held within 2x of the
plain count over the ranks that split it. Against JAX: ``_wire_bytes``,
``model_flops`` and ``roofline_terms`` equal, and the chatglm3 smoke
prefill's counted FLOPs against the JAX ``hlo_cost`` of the same prefill.
~35 s.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun
from repro_torch.roofline import analyze

ROOT = pathlib.Path(__file__).resolve().parents[1]
META = torch.device("meta")
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def _empty(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def test_single_product_flops_and_bytes():
    a, b = _empty(64, 128), _empty(128, 32)
    out, log = dryrun.count(lambda: a @ b)
    assert out.shape == (64, 32)
    cost = analyze.cost(log)
    assert cost["flops"] == 2 * 64 * 128 * 32
    assert cost["bytes accessed"] == (64 * 128 + 128 * 32 + 64 * 32) * 4


def test_bytes_scale_with_repeats():
    x = _empty(1024, 1024)

    def body(n):
        y = x
        for _ in range(n):
            y = y * 2.0 + 1.0
        return y

    one = analyze.cost(dryrun.count(body, 1)[1])["bytes accessed"]
    ten = analyze.cost(dryrun.count(body, 10)[1])["bytes accessed"]
    # each op reads and writes 4 MiB; nothing is fused
    assert one == 2 * 2 * 1024 * 1024 * 4
    assert ten == 10 * one


def test_views_and_allocations_move_nothing():
    x = _empty(256, 64)
    _, log = dryrun.count(lambda: (x.t().reshape(64, 256)[:, :8],
                                   torch.empty(1 << 20, device=META)))
    assert analyze.cost(log) == {"flops": 0.0, "bytes accessed": 0.0}
    # a batched lhs folds into one mm, its result unflattened by
    # _unsafe_view, which moves nothing: the bytes are the mm's
    a, w = _empty(4, 64, 32), _empty(32, 16)
    _, log = dryrun.count(lambda: torch.matmul(a, w))
    assert analyze.cost(log)["bytes accessed"] == 4 * (256 * 32 + 32 * 16
                                                       + 256 * 16)


def _train_count(cfg):
    """A train step of ``cfg`` (AdamW, remat) on meta tensors, counted."""
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train import train_step
    lm = model.LM(cfg, META).requires_grad_(True)
    opt = adamw.AdamWConfig()
    state = {"params": lm, "opt": adamw.init(opt, lm)}
    b, s = 2, 32
    batch = {"tokens": torch.empty(b, s, dtype=torch.int64, device=META),
             "targets": torch.empty(b, s, dtype=torch.int64, device=META)}
    if cfg.family == "vlm":
        batch["image_embeds"] = _empty(b, cfg.vision_seq, cfg.vision_dim)
    step = train_step.make_train_step(cfg, opt)
    return dryrun.count(step, state, batch)[1]


def _entries(log):
    return {analyze._key(e): (e["n"], e["flops"], e["bytes"])
            for e in log.entries}


@pytest.mark.parametrize("arch,depth", [
    ("llama3.2-3b", dict(n_layers=5)),
    ("zamba2-1.2b", dict(n_layers=5, hybrid_period=2)),
    ("llama-3.2-vision-11b", dict(n_layers=6, cross_attn_period=3)),
    ("deepseek-v3-671b", dict(n_layers=4, first_k_dense=2))])
def test_layer_count_is_layers_times_one_plus_the_rest(arch, depth):
    """The count at full depth equals the cut depths' counts combined (each
    distinct layer once, times its repeats): op by op, every number."""
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True), **depth)
    cuts = dryrun.depth_cuts(cfg)
    assert sum(c for c, _ in cuts) == 1
    full = _train_count(cfg)
    combined = analyze.combine((c, _train_count(cut)) for c, cut in cuts)
    got, want = _entries(combined), _entries(full)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-6), k


def test_one_more_layer_adds_one_layer():
    cfg = registry.get_config("llama3.2-3b", smoke=True)
    c = [analyze.cost(_train_count(dataclasses.replace(cfg, n_layers=n)))
         for n in (1, 2, 3)]
    for key in ("flops", "bytes accessed"):
        assert c[2][key] - c[1][key] == c[1][key] - c[0][key] > 0


def test_tsm2x_call_priced_from_the_record():
    from repro_torch.core import perf_model, tsmm
    a = _empty(8192, 4096, dtype=torch.bfloat16)
    b = _empty(4096, 256, dtype=torch.bfloat16)
    out, log = dryrun.count(tsmm.tsmm, a, b)
    assert out.shape == (8192, 256) and out.dtype == torch.bfloat16
    (e,) = [e for e in log.entries if e["cls"] == "tsm2x"]
    assert e["kernel"] == "tsm2r" and e["body"] == "wgmma" and e["S"] == 1
    assert e["shape"] == [8192, 4096, 256]
    assert e["flops"] == 2 * 8192 * 4096 * 256
    # the bound's bytes: A, B and the output once; the kernel's model
    # reads A once a column tile and B once a row tile, kept beside them
    assert e["bytes"] == 2 * (8192 * 4096 + 4096 * 256 + 8192 * 256)
    assert e["model_bytes"] == perf_model.tsm2r_model_bytes(
        8192, 4096, 256, torch.bfloat16) >= e["bytes"]
    assert e["executor"] == dryrun.SHAPE_ONLY == "meta"
    # a split call: PowerSGD's P at S > 1 in f32, priced with its partials'
    # f32 round trip
    a, b = _empty(16384, 16384), _empty(16384, 16)
    _, log = dryrun.count(lambda: tsmm.tsmm(
        a, b, policy=tsmm.current_policy().with_(split=2)))
    (e,) = [e for e in log.entries if e["cls"] == "tsm2x"]
    assert e["kernel"] == "tsm2r_split" and e["S"] == 2
    assert e["body"] == "skinny"
    assert e["bytes"] == 4 * (16384 * 16384 + 16384 * 16 + 16384 * 16) \
        + 2 * 2 * 16384 * 16 * 4
    assert e["model_bytes"] == perf_model.tsm2r_model_bytes(
        16384, 16384, 16, splits=2)
    # tsmt: X and Y once, the (a, b) output once
    x, y = _empty(65536, 64), _empty(65536, 2)
    _, log = dryrun.count(tsmm.tsmm_t, x, y)
    (e,) = [e for e in log.entries if e["cls"] == "tsm2x"]
    assert e["kernel"].startswith("tsmt")
    assert e["bytes"] == analyze.tsm2x_bytes("tsmt", 65536, 64, 2,
                                             torch.float32, e["S"]) \
        >= 4 * (65536 * 66 + 64 * 2)
    # the TSM2X class's bound reads the product's bytes
    c = analyze.by_class(log)["TSM2X kernels"]
    assert c["bytes"] == e["bytes"] and c["model_bytes"] == e["model_bytes"]


def test_tsm2x_backward_goes_through_tsmm():
    """The shape-only route's backward dispatches its cotangent GEMMs, as
    the kernels' autograd does: a wk-shaped product's dA and dB."""
    from repro_torch.core import tsmm
    a = _empty(8192, 4096, dtype=torch.bfloat16).requires_grad_(True)
    b = _empty(4096, 256, dtype=torch.bfloat16).requires_grad_(True)

    def step():
        da, db = torch.autograd.grad(tsmm.tsmm(a, b).float().sum(), [a, b])
        return da, db

    (da, db), log = dryrun.count(step)
    assert da.shape == a.shape and db.shape == b.shape
    kinds = sorted(e["kernel"] for e in log.entries if e["cls"] == "tsm2x")
    assert kinds == ["tsm2r"]        # dB = tsmm_t(a, ct) is dense here
    mm = [e for e in log.entries if e["op"] == "aten.mm"]
    assert sum(e["flops"] for e in mm) == 2 * 2 * 8192 * 4096 * 256


def test_model_flops_shapes():
    cfg = registry.get_config("llama3.2-3b")
    t = analyze.model_flops(cfg, SHAPES["train_4k"])
    assert t == pytest.approx(6 * cfg.param_count() * 4096 * 256, rel=1e-6)
    d = analyze.model_flops(cfg, SHAPES["decode_32k"])
    assert d == pytest.approx(2 * cfg.param_count() * 128, rel=1e-6)


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 2, 4, 16])
def test_wire_bytes_as_jax(g):
    from repro.roofline import analyze as janalyze
    for kind in KINDS:
        assert analyze._wire_bytes(kind, 12345.0, g) == \
            janalyze._wire_bytes(kind, 12345.0, g)


@pytest.mark.parametrize("arch", registry.ARCH_NAMES)
def test_model_flops_as_jax(arch):
    from repro.configs import registry as jregistry
    from repro.configs.base import SHAPES as JSHAPES
    from repro.roofline import analyze as janalyze
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    for name in SHAPES:
        assert analyze.model_flops(cfg, SHAPES[name]) == \
            janalyze.model_flops(jcfg, JSHAPES[name])


def test_roofline_terms_as_jax():
    from repro.roofline import analyze as janalyze
    cost = {"flops": 3.1e15, "bytes accessed": 7.7e12}
    for wire in (0.0, 2.5e11):
        coll = analyze.CollectiveStats(wire, {"all-reduce": 3},
                                       {"all-reduce": wire})
        jcoll = janalyze.CollectiveStats(wire, {"all-reduce": 3},
                                         {"all-reduce": wire})
        v5e = janalyze.V5E
        got = analyze.roofline_terms(cost, coll, 256, hw=v5e,
                                     link_bw=v5e["ici_bw"] * 4)
        assert got == janalyze.roofline_terms(cost, jcoll, 256)


def test_chatglm3_smoke_prefill_flops_against_jax_hlo_cost():
    """The port's count of the smoke prefill against the JAX package's
    loop-aware ``hlo_cost`` of the same prefill compiled on one CPU device
    (its dots: 2 x result x contracted). Over three 16-token tiles the
    port skips the three tiles above the diagonal that JAX computes and
    masks (``chunked_attention``), and the counts differ by exactly those
    tiles' two einsums a layer (port / JAX = 0.9526 at 48 tokens; at one
    tile, 16 tokens, the two are equal)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jregistry
    from repro.models import model as jmodel
    from repro.roofline import analyze as janalyze
    from repro_torch.models import model

    b, s, skipped = 2, 48, 3
    jcfg = jregistry.get_config("chatglm3-6b", smoke=True)
    params = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jcfg))
    cache = jax.eval_shape(lambda: jmodel.init_cache(jcfg, b, s))
    toks = jax.ShapeDtypeStruct((b, s), jnp.int32)
    hlo = jax.jit(lambda p, t, c: jmodel.prefill(p, jcfg, {"tokens": t}, c)
                  ).lower(params, toks, cache).compile().as_text()
    want = janalyze.hlo_cost(hlo)["flops"]

    cfg = registry.get_config("chatglm3-6b", smoke=True)
    lm = model.LM(cfg, META)
    cache = model.init_cache(cfg, b, s, device=META)
    batch = {"tokens": torch.empty(b, s, dtype=torch.int64, device=META)}
    _, log = dryrun.count(model.prefill, lm, cfg, batch, cache)
    got = analyze.cost(log)["flops"]
    qc, hd = cfg.q_chunk, cfg.resolved_head_dim
    tile = 2 * (2 * b * cfg.n_heads * qc * qc * hd)   # scores and p @ v
    assert want - got == cfg.n_layers * skipped * tile


# ---------------------------------------------------------------------------
# Fake process groups, in one subprocess
# ---------------------------------------------------------------------------

FAKE_SCRIPT = r"""
import dataclasses, json
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.launch import dryrun
from repro_torch.roofline import analyze

META = torch.device("meta")
out = {}
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
try:
    # an all-reduce of f32[128, 256] over a group of 4
    mesh4 = init_device_mesh("cuda", (4, 4), mesh_dim_names=("data", "model"))
    x = torch.empty(128, 256, device=META)

    def reduce(n):
        from torch.distributed._functional_collectives import all_reduce
        y = x
        for _ in range(n):
            y = all_reduce(y, "sum", (mesh4, 1))
        return y

    stats = [analyze.collectives(dryrun.count(reduce, n)[1]) for n in (1, 2)]
    out["ar_wire"] = stats[0].wire_bytes
    out["ar_counts"] = stats[0].counts
    # the collective inside a repeated layer: 6 repeats from 1 and 2
    six = analyze.combine([(-4, dryrun.count(reduce, 1)[1]),
                           (5, dryrun.count(reduce, 2)[1])])
    out["ar_six"] = analyze.collectives(six).wire_bytes

    # per-rank FLOPs on a (2, 8) mesh
    mesh = init_device_mesh("cuda", (2, 8), mesh_dim_names=("data", "model"))
    a = DTensor.from_local(torch.empty(256, 1024, device=META), mesh,
                           [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(1024, 64, device=META), mesh,
                           [Replicate(), Shard(1)], run_check=False)
    r = DTensor.from_local(torch.empty(64, 32, device=META), mesh,
                           [Replicate(), Replicate()], run_check=False)
    out["sharded"] = analyze.cost(dryrun.count(lambda: a @ w)[1])
    out["replicated"] = analyze.cost(dryrun.count(lambda: r @ r.t())[1])

    # llama3.2-3b, one layer, a small decode: the mesh count against the
    # plain one
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding
    from repro_torch.models import model
    cfg = dataclasses.replace(registry.get_config("llama3.2-3b"), n_layers=1)
    b, s = 16, 1024

    def decode(lm, tokens, cache):
        return dryrun.count(model.decode_step, lm, cfg, tokens, s - 1,
                            cache)[1]

    lm = model.LM(cfg, META)
    toks = torch.empty(b, 1, dtype=torch.int64, device=META)
    plain = decode(lm, toks, model.init_cache(cfg, b, s, device=META))
    sharding.named(mesh, sharding.make_param_specs(cfg, lm, mesh), lm)
    toks = sharding.named(mesh, sharding.batch_specs(
        cfg, mesh, {"tokens": toks}), {"tokens": toks})["tokens"]
    placed = decode(lm, toks, model.init_cache(cfg, b, s, device=META,
                                               mesh=mesh))
    out["llama_plain"] = analyze.cost(plain)["flops"]
    out["llama_mesh"] = analyze.cost(placed)["flops"]
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        model.decode_step(lm, cfg, toks, s - 1,
                          model.init_cache(cfg, b, s, device=META, mesh=mesh))
    out["llama_flop_counter_mode"] = fc.get_total_flops()
finally:
    dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", FAKE_SCRIPT], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_all_reduce_wire_bytes(fake):
    rbytes = 128 * 256 * 4
    assert fake["ar_wire"] == pytest.approx(2 * (4 - 1) / 4 * rbytes)
    assert fake["ar_counts"] == {"all-reduce": 1}


def test_collective_inside_a_repeated_layer_multiplied(fake):
    assert fake["ar_six"] == pytest.approx(6 * fake["ar_wire"])


def test_sharded_product_counts_its_local_product(fake):
    # A [512,1024] with its rows over 2, B [1024,512] with its columns
    # over 8: each rank's [256,1024]x[1024,64]
    assert fake["sharded"]["flops"] == 2 * 256 * 1024 * 64


def test_replicated_product_counts_whole_on_every_rank(fake):
    assert fake["replicated"]["flops"] == 2 * 64 * 32 * 64


def test_mesh_decode_counts_the_rank_share(fake):
    """llama3.2-3b's one-layer decode on (2, 8): within 2x of the plain
    count over the 16 ranks that split it (the replicated norms and the
    head's own share keep it off exactly 1/16), where torch's
    FlopCounterMode reads DTensor ops at their global shapes."""
    share = fake["llama_plain"] / 16
    assert share / 2 <= fake["llama_mesh"] <= 2 * share
    assert fake["llama_flop_counter_mode"] > 4 * fake["llama_mesh"]
