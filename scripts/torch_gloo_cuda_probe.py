#!/usr/bin/env python3
"""Can two gloo ranks on one CUDA card run the port's collectives?

    python3 scripts/torch_gloo_cuda_probe.py [--out FILE]

NCCL refuses two ranks on one device, so the port's two-rank parity runs
on the CPU over gloo. This probe starts two processes that join one gloo
world (``init_method="file://"``) with every tensor on ``cuda:0``, and
tries, one at a time, each collective the shard_map executors, tree TSQR
and sharded PowerSGD call: ``all_reduce``, ``reduce_scatter_tensor``,
``all_gather_into_tensor``, ``batch_isend_irecv``, then through DTensor
(``kernels/compat.py``'s psum, psum_scatter, all_gather and ppermute) and
the port's own entries (``tsmm`` / ``tsmm_t`` on DTensors, ``tree_tsqr``,
``compress_one_sharded``). Each try prints ``ok``, or the error's first
line, each in a world of its own (a rank that dies, as by a signal, is
reported so); a collective that hangs ends at the group's 60 s timeout.
Prints one JSON line a try and the report; exits 0 only when every try
succeeded on both ranks.
"""

from __future__ import annotations

import argparse
import datetime
import json
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]


def _tries(rank):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch import linalg
    from repro_torch.core import tsmm
    from repro_torch.kernels import compat
    from repro_torch.optim import powersgd

    dev = torch.device("cuda", 0)
    group = dist.group.WORLD
    t = torch.full((8, 4), float(rank + 1), device=dev)
    yield "all_reduce", lambda: dist.all_reduce(t.clone())
    yield "reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
        torch.empty((4, 4), device=dev), t)
    yield "all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
        torch.empty((16, 4), device=dev), t)

    def p2p():
        out = torch.empty_like(t)
        peer = 1 - rank
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, t, peer, group),
                dist.P2POp(dist.irecv, out, peer, group)]):
            req.wait()
    yield "batch_isend_irecv", p2p
    mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("data",))
    yield "compat.psum", lambda: compat.psum(t, mesh, "data")
    yield "compat.psum_scatter", lambda: compat.psum_scatter(t, mesh, "data")
    yield "compat.all_gather", lambda: compat.all_gather(t, mesh, "data")
    yield "compat.ppermute", lambda: compat.ppermute(
        t, mesh, "data", [(0, 1), (1, 0)])
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((8192, 512), generator=gen, device=dev)
    b = torch.randn((512, 8), generator=gen, device=dev)
    a_d = distribute_tensor(a, mesh, [Shard(0)])
    b_d = distribute_tensor(b, mesh, [Replicate()])
    yield "tsmm shard_map", lambda: tsmm.tsmm(a_d, b_d).full_tensor()
    for red in ("psum", "psum_scatter"):
        def mmt(red=red):
            with tsmm.policy(reduce=red):
                return tsmm.tsmm_t(a_d, a_d[:, :8]).full_tensor()
        yield f"tsmm_t {red}", mmt
    rows = a[rank * 4096:(rank + 1) * 4096, :16]
    for sched in ("butterfly", "gather"):
        yield f"tree_tsqr {sched}", lambda sched=sched: linalg.tree_tsqr(
            rows, mesh=mesh, axis="data", reduce=sched)
    cfg = powersgd.PowerSGDConfig(rank=4, min_size=0, orth="tsqr")
    st = powersgd.shard_state(
        {"w": {"err": torch.zeros((4096, 512), device=dev),
               "q": torch.randn((512, 4), generator=gen, device=dev)}},
        mesh=mesh, axis="data")["w"]
    yield "compress_one_sharded", lambda: powersgd.compress_one_sharded(
        cfg, a[:4096], st, mesh=mesh, axis="data")


def _rank(rank, init_file, out_dir, only):
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    result = f"no try named {only!r}"
    try:
        for name, fn in _tries(rank):
            if name != only:
                continue
            try:
                fn()
                torch.cuda.synchronize()
                result = "ok"
            except Exception as e:    # record the refusal
                result = (f"{type(e).__name__}: "
                          + (str(e).strip().splitlines() or [""])[0])
    finally:
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(result))
        dist.destroy_process_group()


def _try_names():
    # _tries' names (it needs the world to build its operands); a name it
    # does not yield is reported as such.
    return ["all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
            "batch_isend_irecv", "compat.psum", "compat.psum_scatter",
            "compat.all_gather", "compat.ppermute", "tsmm shard_map",
            "tsmm_t psum", "tsmm_t psum_scatter", "tree_tsqr butterfly",
            "tree_tsqr gather", "compress_one_sharded"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    results = {}
    for name in _try_names():      # a world of its own for each try
        with tempfile.TemporaryDirectory() as tmp:
            try:
                mp.start_processes(_rank, args=(f"{tmp}/init", tmp, name),
                                   nprocs=2, start_method="spawn")
            except Exception as e:    # a rank died: a signal, or raised
                results[name] = [f"{type(e).__name__}: "
                                 + (str(e).strip().splitlines() or [""])[0]]
                continue
            results[name] = [json.loads((Path(tmp) / f"rank{r}.json")
                                        .read_text()) for r in range(2)]
        print(json.dumps({name: results[name]}), flush=True)
    report = {"torch": torch.__version__,
              "card": torch.cuda.get_device_name(0), "tries": results}
    print(json.dumps(report))
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0 if all(v == ["ok", "ok"] for v in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
