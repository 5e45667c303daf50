"""Harness of the port's multi-process tests: a two-rank gloo world on the
CPU, and the JAX package's two-device run it is held against.

* :func:`run_both` starts ``fn(rank, workdir)`` in two processes
  (``torch.multiprocessing`` with the spawn method) that join one gloo
  world through ``init_method="file://"`` on a file of the caller's
  temporary directory, so concurrent test workers never share a port.
  Each rank saves what ``fn`` returns; the parent loads both. The world
  has a time limit: a hang kills the ranks and fails the tests that read
  them, instead of running the suite into its own limit.
* beside it, a script of the JAX package runs in a subprocess with
  ``--xla_force_host_platform_device_count=2`` (JAX fixes its device count
  when the backend first starts), as ``tests/test_shard_map.py`` does.
  The script reads the seeded inputs from ``inputs.npz`` in the work
  directory and writes ``jax_out.npz`` and ``jax_out.json`` there.

Nothing here imports JAX: the ranks import the test module that names
``fn``, and must not load it.
"""

import json
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 2
# Per-rank CPU threads: three test files may each run a world and a JAX
# subprocess at once.
THREADS = 2

# The port's executors under the names of their JAX counterparts.
JAX_EXECUTOR = {"torch-ref": "pallas-tpu", "torch-dense": "dense-xla",
                "shard_map": "shard_map",
                "shard_map-scatter": "shard_map-scatter"}


def _rank_main(rank, fn, init_file, out_dir):
    torch.set_num_threads(THREADS)
    if init_file is None:
        result = fn(rank, pathlib.Path(out_dir))
    else:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=WORLD)
        try:
            result = fn(rank, pathlib.Path(out_dir))
        finally:
            dist.destroy_process_group()
    torch.save(result, pathlib.Path(out_dir) / f"rank{rank}.pt")


def start_world(fn, workdir: pathlib.Path, init: bool = True):
    """Start ``fn(rank, workdir)`` on ``WORLD`` gloo ranks; returns the
    context that :func:`join_world` waits for. ``init=False`` starts the
    processes without a process group, for a ``fn`` that starts its own
    (the launcher's ``--distributed``, from torchrun's environment)."""
    init_file = str(workdir / "init") if init else None
    return mp.start_processes(
        _rank_main, args=(fn, init_file, str(workdir)),
        nprocs=WORLD, join=False, start_method="spawn")


def join_world(ctx, workdir: pathlib.Path, timeout: float) -> list:
    """Wait for the ranks at most ``timeout`` seconds (then kill them and
    raise); returns each rank's result, in rank order."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the gloo world did not finish in "
                               f"{timeout} s")
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(len(ctx.processes))]


def _jax_env():
    env = dict(os.environ)
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                   env.get("XLA_FLAGS", ""))
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={WORLD} "
                        f"{flags}").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    env.pop("REPRO_TSMM", None)
    return env


def start_jax(script: str, workdir: pathlib.Path) -> subprocess.Popen:
    """Start the JAX package's side on two host devices."""
    return subprocess.Popen(
        [sys.executable, "-c", script, str(workdir)], env=_jax_env(),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def join_jax(proc: subprocess.Popen, workdir: pathlib.Path,
             timeout: float):
    """Wait for the JAX side (killed past ``timeout``); returns its arrays
    and its JSON record."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err}"
    arrays = dict(np.load(workdir / "jax_out.npz"))
    record = json.loads((workdir / "jax_out.json").read_text())
    return arrays, record


def run_both(fn, script: str, inputs: dict, workdir: pathlib.Path,
             timeout: float = 300.0, init: bool = True):
    """Save ``inputs``, run the JAX side and the gloo world at once, and
    return ``(port results per rank, JAX arrays, JAX record)``."""
    np.savez(workdir / "inputs.npz", **inputs)
    proc = start_jax(script, workdir)
    try:
        ranks = join_world(start_world(fn, workdir, init), workdir, timeout)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    arrays, record = join_jax(proc, workdir, timeout)
    return ranks, arrays, record


def port_events(log) -> list:
    """DispatchEvents as ``(entry, kind, JAX executor name, shape, split,
    abft)`` tuples, comparable with the JAX side's."""
    return [(e.entry, e.kind, JAX_EXECUTOR.get(e.executor, e.executor),
             tuple(e.shape), e.split, e.abft) for e in log]


# What the JAX scripts define to record their dispatch events the same
# way (prepended to each script).
JAX_PRELUDE = r"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from repro.core import tsmm

WORK = sys.argv[1]
INP = {k: jnp.asarray(v) for k, v in np.load(WORK + "/inputs.npz").items()}
devs = jax.devices()
assert len(devs) == 2, f"expected 2 host devices, got {len(devs)}"
mesh = Mesh(np.array(devs), ("data",))
OUT, REC = {}, {}


def events(log):
    return [[e.entry, e.kind, e.executor, list(e.shape), e.split, e.abft]
            for e in log]


def error_text(fn):
    try:
        fn()
    except (RuntimeError, ValueError) as e:
        return str(e)
    raise AssertionError("no error raised")


def save():
    np.savez(WORK + "/jax_out.npz",
             **{k: np.asarray(v, np.float32) for k, v in OUT.items()})
    with open(WORK + "/jax_out.json", "w") as f:
        json.dump(REC, f)
"""


def jax_events(rec) -> list:
    return [(e[0], e[1], e[2], tuple(e[3]), e[4], e[5]) for e in rec]
