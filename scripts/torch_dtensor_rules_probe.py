#!/usr/bin/env python3
"""Which DTensor rules does this torch take for the ops of the RWKV6 and
Mamba2 chunk scans, the MoE dispatch and MLA's absorbed decode?

    python3 scripts/torch_dtensor_rules_probe.py            # one card, NCCL
    python3 scripts/torch_dtensor_rules_probe.py --device cpu --world 2

The port runs both scans on local tensors over each rank's heads
(``models/heads.py``), so none of these ops meets a DTensor on its
paths. This probe hands each one to DTensor directly, on a ``("data",
"model")`` mesh of ``(1, world)`` with the head dim sharded over "model"
as the projections leave it: ``torch.split`` of a ``Shard(-1)`` tensor
at Mamba2's split points, the head reshape of a sharded last dim and its
flatten, a Python ``sum`` that starts from 0 (``_causal_conv``),
``masked_fill_`` and ``torch.where`` with a plain bool mask
(``_segsum_decay``, RWKV6's ``strict``; alone, and under
``implicit_replication`` as the model runs them), ``cumsum`` over the
sequence,
the scans' ``einsum``, and ``torch.multinomial`` (``sample_token``).

The MoE layer and MLA's decode run on local tensors too
(``models/moe.py``, ``models/attention.py``). Their tries: on a ``(world,
1)`` mesh with the dispatch groups sharded over "data", ``searchsorted``,
the stable ``argsort``, ``scatter``, ``gather`` and the advanced-index
gather into the expert batch (``_dispatch_indices``, ``_experts_fwd``);
on the ``(1, world)`` mesh, the ``(G, E, C, d)`` batch's flatten to
``(E, G*C, d)`` with E over "model" (``_expert_mm``; four groups and
one),
``aten::bmm.dtype`` on expert-sharded stacks (``_ExpertMM``), MLA's
rope key broadcast and concatenated onto head-sharded ``k_nope``,
``wukv``'s reshape to ``(kv_lora, H, nope + v)``, the absorbed
decode's four f32 einsums and the non-absorbed decode's expansion of the
cache with the heads over "model" and the latent cache's sequence over
"model" (``sharding.cache_specs``).
Each try prints one JSON line: ``ok`` with the output's placements and
whether its full value equals the plain op's, or the error's first line.
World 1 runs in this process (NCCL on ``cuda:0``, gloo on the CPU); a
world of 2 (gloo, CPU only: NCCL puts no two ranks on one card) spawns
its ranks, and rank 0 prints. Exits 0 when every try ran, whatever each
one's outcome.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# Mamba2's projection [x, z, B, C, dt] at a width divisible by 2 whose
# shard boundary misses every split point; 4 heads of 8 for the scans.
SPLITS = [64, 64, 8, 8, 4]
HEADS, HEAD_DIM, SEQ = 4, 8, 6
# The MoE tries: 4 groups of 12 entries, 4 experts of 3 slots, width 8;
# MLA's: latent 16, nope 8, rope 4, v 8.
GROUPS, ENTRIES, EXPERTS, CAP, WIDTH = 4, 12, 4, 3, 8
LATENT, NOPE, ROPE, V = 16, 8, 4, 8


def _tries(dev, mesh, dp_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    gen = torch.Generator(device=dev).manual_seed(0)

    def dt(shape, places):
        t = torch.randn(shape, generator=gen, device=dev)
        return t, distribute_tensor(t, mesh, places)

    cols = [Replicate(), Shard(2)]
    proj, proj_d = dt((2, SEQ, sum(SPLITS)), cols)
    yield "split of Shard(-1) at Mamba2's split points", (
        lambda: torch.split(proj_d, SPLITS, dim=-1),
        lambda: torch.split(proj, SPLITS, dim=-1))
    r, r_d = dt((2, SEQ, HEADS * HEAD_DIM), cols)
    yield "reshape of a sharded last dim to (heads, head_dim)", (
        lambda: r_d.reshape(2, SEQ, HEADS, HEAD_DIM),
        lambda: r.reshape(2, SEQ, HEADS, HEAD_DIM))
    heads, heads_d = dt((2, SEQ, HEADS, HEAD_DIM), [Replicate(), Shard(2)])
    yield "flatten of sharded heads to heads * head_dim", (
        lambda: heads_d.reshape(2, SEQ, HEADS * HEAD_DIM),
        lambda: heads.reshape(2, SEQ, HEADS * HEAD_DIM))
    w, w_d = dt((4, HEADS * HEAD_DIM), [Replicate(), Shard(1)])
    yield "Python sum from 0 (_causal_conv)", (
        lambda: sum(r_d[:, i:i + 3] * w_d[i] for i in range(3)),
        lambda: sum(r[:, i:i + 3] * w[i] for i in range(3)))
    seg, seg_d = dt((2, SEQ, SEQ, HEADS), [Replicate(), Shard(3)])
    tri = torch.tril(torch.ones((SEQ, SEQ), dtype=torch.bool, device=dev))
    yield "masked_fill_ with a plain bool mask (_segsum_decay)", (
        lambda: seg_d.clone().masked_fill_(~tri[None, :, :, None], -1.0),
        lambda: seg.clone().masked_fill_(~tri[None, :, :, None], -1.0))
    yield "where with a plain bool mask (RWKV6's strict)", (
        lambda: torch.where(tri[None, :, :, None], seg_d, 0.0),
        lambda: torch.where(tri[None, :, :, None], seg, 0.0))
    from torch.distributed.tensor.experimental import implicit_replication

    def replicated(fn):
        # the model runs under sharding.replicate_constants: a plain
        # tensor beside DTensors counts as replicated
        def run():
            with implicit_replication():
                return fn()
        return run

    yield "masked_fill_ with a plain mask, implicit replication", (
        replicated(lambda: seg_d.clone().masked_fill_(
            ~tri[None, :, :, None], -1.0)),
        lambda: seg.clone().masked_fill_(~tri[None, :, :, None], -1.0))
    yield "where with a plain mask, implicit replication", (
        replicated(lambda: torch.where(tri[None, :, :, None], seg_d, 0.0)),
        lambda: torch.where(tri[None, :, :, None], seg, 0.0))
    yield "cumsum over the sequence of sharded heads", (
        lambda: torch.cumsum(heads_d, dim=1),
        lambda: torch.cumsum(heads, dim=1))
    scores, scores_d = dt((2, SEQ, SEQ, HEADS), [Replicate(), Shard(3)])
    yield "einsum btsh,bshd->bthd (the WKV intra-chunk product)", (
        lambda: torch.einsum("btsh,bshd->bthd", scores_d, heads_d),
        lambda: torch.einsum("btsh,bshd->bthd", scores, heads))
    probs = torch.softmax(torch.randn((2, 16), generator=gen, device=dev),
                          -1)
    probs_d = distribute_tensor(probs, mesh, [Replicate(), Shard(1)])
    yield "multinomial of vocab-sharded probabilities", (
        lambda: torch.multinomial(
            probs_d, 1, generator=torch.Generator(device=dev).manual_seed(1)),
        lambda: torch.multinomial(
            probs, 1, generator=torch.Generator(device=dev).manual_seed(1)))
    yield from _moe_mla_tries(dev, mesh, dp_mesh, gen)


def _moe_mla_tries(dev, mesh, dp_mesh, gen):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    def dp(t):          # the dispatch groups over "data"
        return distribute_tensor(t, dp_mesh, [Shard(0), Replicate()])

    ge = torch.randint(0, EXPERTS, (GROUPS, ENTRIES), generator=gen,
                       device=dev)
    se = torch.sort(ge, dim=-1).values
    probe = torch.arange(EXPERTS, device=dev).repeat(GROUPS, 1)
    yield "searchsorted of dp-sharded sorted expert ids", (
        lambda: torch.searchsorted(dp(se), dp(probe)),
        lambda: torch.searchsorted(se, probe))
    yield "stable argsort of dp-sharded expert ids", (
        lambda: torch.argsort(dp(ge), dim=-1, stable=True),
        lambda: torch.argsort(ge, dim=-1, stable=True))
    dest = torch.stack([torch.randperm(EXPERTS * CAP, generator=gen,
                                       device=dev)[:ENTRIES]
                        for _ in range(GROUPS)])
    buf = torch.zeros((GROUPS, EXPERTS * CAP), dtype=torch.int64,
                      device=dev)
    yield "scatter into a dp-sharded index buffer", (
        lambda: dp(buf).scatter(1, dp(dest), dp(ge)),
        lambda: buf.scatter(1, dest, ge))
    yield "gather of dp-sharded entries", (
        lambda: torch.gather(dp(ge), 1, dp(dest % ENTRIES)),
        lambda: torch.gather(ge, 1, dest % ENTRIES))
    xg = torch.randn((GROUPS, ENTRIES + 1, WIDTH), generator=gen,
                     device=dev)
    rows = torch.arange(GROUPS, device=dev)[:, None]
    tok = dest % (ENTRIES + 1)
    yield "advanced-index gather into the expert batch, groups over dp", (
        lambda: dp(xg)[dp(rows), dp(tok)],
        lambda: xg[rows, tok])
    batch = torch.randn((GROUPS, EXPERTS, CAP, WIDTH), generator=gen,
                        device=dev)
    batch_d = distribute_tensor(batch, mesh, [Shard(0), Shard(1)])
    yield "flatten of the (G, E, C, d) batch to (E, G*C, d), G over data, " \
          "E over model", (
        lambda: batch_d.transpose(0, 1).reshape(EXPERTS, GROUPS * CAP,
                                                WIDTH),
        lambda: batch.transpose(0, 1).reshape(EXPERTS, GROUPS * CAP, WIDTH))
    one = batch[:1]         # one dispatch group, as on a (1, 2) mesh
    one_d = distribute_tensor(one, mesh, [Shard(0), Shard(1)])
    yield "the same flatten of one group", (
        lambda: one_d.transpose(0, 1).reshape(EXPERTS, CAP, WIDTH),
        lambda: one.transpose(0, 1).reshape(EXPERTS, CAP, WIDTH))
    a = torch.randn((EXPERTS, GROUPS * CAP, WIDTH), generator=gen,
                    device=dev).bfloat16()
    w = torch.randn((EXPERTS, WIDTH, 2 * WIDTH), generator=gen,
                    device=dev).bfloat16()
    experts = [Replicate(), Shard(0)]
    yield "bmm.dtype (f32 sums) on expert-sharded bf16 stacks", (
        lambda: torch.bmm(distribute_tensor(a, mesh, experts),
                          distribute_tensor(w, mesh, experts),
                          out_dtype=torch.float32),
        lambda: torch.bmm(a, w, out_dtype=torch.float32))
    k_nope, k_nope_d = _dt(gen, dev, mesh, (2, SEQ, HEADS, NOPE),
                           [Replicate(), Shard(2)])
    k_pe = torch.randn((2, SEQ, 1, ROPE), generator=gen, device=dev)
    k_pe_d = distribute_tensor(k_pe, mesh, [Replicate(), Replicate()])
    yield "MLA's rope key broadcast onto head-sharded k_nope (cat)", (
        lambda: torch.cat([k_nope_d, k_pe_d.expand(2, SEQ, HEADS, ROPE)],
                          dim=-1),
        lambda: torch.cat([k_nope, k_pe.expand(2, SEQ, HEADS, ROPE)],
                          dim=-1))
    wukv, wukv_d = _dt(gen, dev, mesh, (LATENT, HEADS * (NOPE + V)),
                       [Replicate(), Shard(1)])
    yield "wukv's reshape of sharded columns to (kv_lora, H, nope + v)", (
        lambda: wukv_d.reshape(LATENT, HEADS, NOPE + V),
        lambda: wukv.reshape(LATENT, HEADS, NOPE + V))
    wuk = wukv.reshape(LATENT, HEADS, NOPE + V)[..., :NOPE]
    wuk_d = distribute_tensor(wuk.contiguous(), mesh,
                              [Replicate(), Shard(1)])
    q, q_d = _dt(gen, dev, mesh, (2, HEADS, NOPE), [Replicate(), Shard(1)])
    yield "absorbed decode: einsum bhd,lhd->bhl over sharded heads", (
        lambda: torch.einsum("bhd,lhd->bhl", q_d, wuk_d),
        lambda: torch.einsum("bhd,lhd->bhl", q, wuk))
    qc, qc_d = _dt(gen, dev, mesh, (2, HEADS, LATENT),
                   [Replicate(), Shard(1)])
    cc, cc_d = _dt(gen, dev, mesh, (2, 2 * SEQ, LATENT),
                   [Replicate(), Shard(1)])
    yield "absorbed decode: einsum bhl,bsl->bhs, the cache's sequence " \
          "over model", (
              lambda: torch.einsum("bhl,bsl->bhs", qc_d, cc_d),
              lambda: torch.einsum("bhl,bsl->bhs", qc, cc))
    prob, prob_d = _dt(gen, dev, mesh, (2, HEADS, 2 * SEQ),
                       [Replicate(), Shard(1)])
    yield "absorbed decode: einsum bhs,bsl->bhl, the cache's sequence " \
          "over model", (
              lambda: torch.einsum("bhs,bsl->bhl", prob_d, cc_d),
              lambda: torch.einsum("bhs,bsl->bhl", prob, cc))
    wukv3_d = distribute_tensor(wukv.reshape(LATENT, HEADS, NOPE + V), mesh,
                                [Replicate(), Shard(1)])
    yield "non-absorbed decode: einsum bsl,lhd->bshd, the cache's " \
          "sequence over model", (
              lambda: torch.einsum("bsl,lhd->bshd", cc_d, wukv3_d),
              lambda: torch.einsum("bsl,lhd->bshd", cc,
                                   wukv.reshape(LATENT, HEADS, NOPE + V)))
    wuv = wukv.reshape(LATENT, HEADS, NOPE + V)[..., NOPE:]
    wuv_d = distribute_tensor(wuv.contiguous(), mesh,
                              [Replicate(), Shard(1)])
    yield "absorbed decode: einsum bhl,lhd->bhd over sharded heads", (
        lambda: torch.einsum("bhl,lhd->bhd", qc_d, wuv_d),
        lambda: torch.einsum("bhl,lhd->bhd", qc, wuv))


def _dt(gen, dev, mesh, shape, places):
    """A seeded tensor and its DTensor in ``places``."""
    from torch.distributed.tensor import distribute_tensor
    t = torch.randn(shape, generator=gen, device=dev)
    return t, distribute_tensor(t, mesh, places)


def _outcome(fn, plain):
    try:
        got = fn()
    except Exception as e:          # the probe reports whatever refuses
        return {"ok": False, "error": f"{type(e).__name__}: "
                + (str(e).strip().splitlines() or [""])[0][:300]}
    outs = got if isinstance(got, (tuple, list)) else [got]
    wants = plain()
    wants = wants if isinstance(wants, (tuple, list)) else [wants]
    full = [o.full_tensor() if hasattr(o, "full_tensor") else o
            for o in outs]
    return {"ok": True,
            "placements": [[repr(p) for p in o.placements] for o in outs
                           if hasattr(o, "placements")],
            "equal": all(torch.equal(f, w) for f, w in zip(full, wants))}


def _rank(rank, world, device, init_file):
    from torch.distributed.device_mesh import init_device_mesh

    backend = "nccl" if device == "cuda" else "gloo"
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(
        "cpu")
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh(device, (1, world),
                                mesh_dim_names=("data", "model"))
        dp_mesh = init_device_mesh(device, (world, 1),
                                   mesh_dim_names=("data", "model"))
        for what, (fn, plain) in _tries(dev, mesh, dp_mesh):
            rec = {"try": what, **_outcome(fn, plain)}
            if rank == 0:
                print(json.dumps(rec), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--world", type=int, default=1)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    if args.device == "cuda" and args.world != 1:
        print("NCCL puts no two ranks on one card: --world 1 on cuda",
              file=sys.stderr)
        return 2
    card = None
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(json.dumps({"torch": torch.__version__, "device": args.device,
                      "world": args.world, "card": card}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        init = str(Path(tmp) / "init")
        if args.world == 1:
            _rank(0, 1, args.device, init)
        else:
            mp.start_processes(_rank, args=(args.world, args.device, init),
                               nprocs=args.world, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
