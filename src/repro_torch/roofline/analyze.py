"""Roofline analysis of the port from one eager call on meta tensors (no
card and no wall clock needed).

Counterpart of ``src/repro/roofline/analyze.py``. Three terms a rank, in
seconds:

    compute    = FLOPs      / peak FLOP/s (bf16, the reference's pricing)
    memory     = bytes      / HBM bandwidth
    collective = wire_bytes / link bandwidth

There is no HLO to parse. The counts come from :class:`OpCounter`, a
dispatch mode over one eager call of the step on meta tensors (the dry
run, ``launch/dryrun.py``; ``chip_smoke.py``'s ``roofline`` phase):

* **FLOPs a rank** are each op's on its *local* shapes (torch's
  ``flop_counter`` formulas: the products, as the reference counts its
  dots). The mode steps aside for a DTensor op, so DTensor runs it and
  the mode sees the local ops and the collectives it issues; the global
  shapes that DTensor's sharding propagation runs under its own fake
  mode are not counted. A product sharded over a dim counts its local
  product, a replicated one counts whole on every rank.
* **Bytes** are every op's operand and result bytes on local shapes
  (views and bare allocations move none). Nothing is fused, so this is an
  upper bound, the counterpart of the reference's top-level instruction
  bytes.
* **Collective wire bytes by kind** come from the functional collectives
  DTensor issues (``all_gather_into_tensor``, ``all_reduce``,
  ``reduce_scatter_tensor``, ``all_to_all_single``; a point-to-point
  ``send`` is a collective-permute), with g the size of the group the op
  runs over, through the reference's ring formulas (:func:`_wire_bytes`).
* **TSM2X calls** launch through ctypes, which no dispatch mode sees:
  each is priced from the dispatcher's own record
  (``tsmm.record_dispatches``): 2·m·k·n FLOPs and the bytes the product
  needs (:func:`tsm2x_bytes`), with its route (kernel, body) and S, and
  beside them the bytes of ``core/perf_model.py``'s model of the kernel
  (``model_bytes``), which reads an operand once per tile of the other.

The counts are kept as an op log (:class:`OpLog`): entries aggregated by
op, class, dtype and collective, which sum linearly. The dry run counts
each distinct layer of a model once and multiplies it by its repeats by
combining the logs of a few cut depths (:func:`combine`), the
counterpart of the reference's loop trip counts.

``H100`` holds NVIDIA's data-sheet values for the H100 SXM; no value in
it was measured.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
# repro: allow-torch-private-import (pytree's flatten of an op's
# arguments has no public path in torch 2.11-2.13)
from torch.utils import _pytree as pytree
# repro: allow-torch-private-import (TorchDispatchMode, the hook that
# sees every op with its shapes, has no public path in torch 2.11-2.13)
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

from repro_torch.core import perf_model

# NVIDIA H100 SXM data sheet (none measured): the rates ``perf_model``
# holds (dense bf16 and int8 tensor cores, f32 on the CUDA cores, HBM3),
# 80 GiB, and NVLink 4's 900 GB/s a GPU counted both ways: 450 GB/s each
# way, which a ring collective sees.
H100 = {
    "peak_flops_bf16": perf_model.H100.peak_flops_bf16,
    "peak_flops_f32": perf_model.H100.peak_flops_f32,
    "peak_ops_int8": perf_model.H100.peak_ops_int8,
    "hbm_bw": perf_model.H100.hbm_bw,
    "link_bw": 450e9,
    "hbm_per_chip": 80 * 2**30,
}

_COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d")
# Ops that move no bytes: a collective's wait, a received buffer (its
# bytes are the send's), autograd plumbing, a reshape that only
# relabels a fresh result (``matmul``'s ``_unsafe_view``) and bare
# allocations.
_NO_TRAFFIC = {"_c10d_functional.wait_tensor",
               "_c10d_functional._wrap_tensor_autograd", "c10d.recv_",
               "aten.detach", "aten.alias", "aten.lift_fresh",
               "aten._unsafe_view",
               "aten.empty", "aten.empty_strided", "aten.empty_like",
               "aten.new_empty", "aten.new_empty_strided"}


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0
    counts: dict = dataclasses.field(default_factory=dict)
    by_kind_bytes: dict = dataclasses.field(default_factory=dict)


def _wire_bytes(kind: str, rbytes: float, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * rbytes
    if kind == "all-gather":
        return (g - 1) / g * rbytes
    if kind == "reduce-scatter":
        return (g - 1) * rbytes
    if kind == "all-to-all":
        return (g - 1) / g * rbytes
    return rbytes  # collective-permute


def peak_flops(dtype: str, hw=H100) -> float:
    """The peak rate of ``dtype``'s products (a dtype name): the tensor
    cores' for bf16, f16 and int8, the CUDA cores' for everything else."""
    if dtype in ("bfloat16", "float16"):
        return hw["peak_flops_bf16"]
    if dtype == "int8":
        return hw["peak_ops_int8"]
    return hw["peak_flops_f32"]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _group_size(name: str) -> int:
    from torch.distributed import distributed_c10d
    return distributed_c10d._resolve_process_group(name).size()


def _collective(op: str, args, ins, outs) -> tuple[str, float, int]:
    """(kind, result bytes, group size) of a collective, in the
    reference's terms: the gathered result of an all-gather, the shard of
    a reduce-scatter, the reduced tensor of an all-reduce, the sent one of
    a permute."""
    kind = _COLLECTIVE_KINDS[op]
    if kind == "all-gather":
        return kind, _nbytes(outs), int(args[1])
    if kind == "reduce-scatter":
        return kind, _nbytes(outs), int(args[2])
    if kind == "all-reduce":
        return kind, _nbytes(ins), _group_size(args[-1])
    if kind == "all-to-all":
        return kind, _nbytes(outs), _group_size(args[3])
    return kind, _nbytes(ins), 2


def _fake_active(types) -> bool:
    """Whether the op runs for DTensor's sharding propagation (global
    shapes under a fake mode), which is not the rank's work."""
    # repro: allow-torch-private-import (FakeTensorMode marks DTensor's
    # sharding propagation; torch has no public path to it)
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    return (any(issubclass(t, FakeTensor) for t in types)
            or any(isinstance(m, FakeTensorMode)
                   for m in _get_current_dispatch_mode_stack()))


@functools.cache
def _composite(func) -> bool:
    """Whether ``func`` has a CompositeImplicitAutograd kernel (one made of
    other ops)."""
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), "CompositeImplicitAutograd")


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


class OpCounter(TorchDispatchMode):
    """Counts every op of the scope on local shapes into ``entries``
    (``{key: entry}``, see :class:`OpLog`). DTensor ops are left to
    DTensor (``NotImplemented``), which runs them as local ops and
    collectives under this mode."""

    def __init__(self):
        super().__init__()
        self.entries: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _fake_active(types):
            return func(*args, **kwargs)
        if any(issubclass(t, _dtensor()) for t in types):
            return NotImplemented
        # A composite op (``matmul`` under inference mode) runs as the ops
        # it is made of, which are counted, as FlopCounterMode does.
        if _composite(func):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry
        op = str(func._overloadpacket)
        if func.is_view or op in _NO_TRAFFIC:
            return
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        first = (ins or outs or [None])[0]
        dtype = _dtype_name(first.dtype) if first is not None else "none"
        kind, rbytes, g = None, 0.0, 1
        name = op.split(".", 1)[-1]
        flops = 0.0
        if func.namespace in _COLLECTIVE_NAMESPACES and \
                name in _COLLECTIVE_KINDS:
            kind, rbytes, g = _collective(name, args, ins, outs)
            cls = "collective"
        elif func._overloadpacket in flop_registry:
            flops = float(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
            cls = "gemm"
        else:
            cls = "other"
        key = (op, cls, dtype, kind, g)
        e = self.entries.setdefault(key, {
            "op": op, "cls": cls, "dtype": dtype, "kind": kind, "g": g,
            "n": 0.0, "flops": 0.0, "bytes": 0.0, "rbytes": 0.0})
        e["n"] += 1
        e["flops"] += flops
        e["bytes"] += _nbytes(ins) + _nbytes(outs)
        e["rbytes"] += rbytes


def tsm2x_bytes(kind: str, m: int, d1: int, d2: int, dtype,
                splits: int = 1) -> int:
    """The device-memory bytes a TSM2X call needs, whatever kernel runs
    it: each operand read once and the output written once (f32 from
    int8; the quantization scales are left out), and under a split
    (S > 1) the f32 partials' round trip. ``kind``: tsm2r or tsm2l
    (A[m,d1] @ B[d1,d2]) or tsmt (X[m,d1]^T Y[m,d2])."""
    b = dtype.itemsize
    out = 4 if dtype == torch.int8 else b
    if kind == "tsmt":
        ins, rows = m * d1 * b + m * d2 * b, d1
    else:
        ins, rows = m * d1 * b + d1 * d2 * b, m
    return (ins + rows * d2 * out
            + perf_model.split_partials_bytes(splits, rows, d2))


def _model_bytes(kind: str, m: int, d1: int, d2: int, dtype,
                 splits: int) -> int:
    """The bytes ``core/perf_model.py``'s model of the kernel moves."""
    if kind == "tsm2r":
        return perf_model.tsm2r_model_bytes(m, d1, d2, dtype, splits=splits)
    if kind == "tsmt":
        return perf_model.tsmt_model_bytes(m, d1, d2, perf_model.H100,
                                           dtype, splits=splits)
    return perf_model.tsm2l_model_bytes(m, d1, d2, dtype)


def tsm2x_entries(events) -> dict:
    """The TSM2X calls of ``tsmm.record_dispatches`` events, priced: one
    entry a distinct (kernel, shape, dtype, executor, S, body), with 2·m·k·n
    FLOPs and :func:`tsm2x_bytes` a call, and ``model_bytes``, what
    ``core/perf_model.py``'s model of the kernel moves. A split call's
    sum_partials launch is priced inside the split call's bytes (the
    partials' round trip)."""
    out: dict = {}
    for ev in events:
        for ln in ev.launches:
            if ln.kind == "reduce":
                continue
            m, d1, d2 = ln.shape
            base = ln.kind.removesuffix("_q8")
            s = ln.splits
            kernel = ln.kind if s == 1 or base == "tsm2l" else \
                ln.kind + "_split"
            body = (ln.params or {}).get("body")
            dtype = _dtype_name(ln.dtype)
            key = ("tsm2x/" + kernel, (m, d1, d2), dtype, ev.executor, s,
                   body)
            e = out.setdefault(key, {
                "op": "tsm2x/" + kernel, "cls": "tsm2x", "dtype": dtype,
                "kind": None, "g": 1, "kernel": kernel,
                "shape": [m, d1, d2], "executor": ev.executor, "S": s,
                "body": body, "n": 0.0, "flops": 0.0, "bytes": 0.0,
                "rbytes": 0.0, "model_bytes": 0.0})
            e["n"] += 1
            e["flops"] += 2.0 * m * d1 * d2
            e["bytes"] += tsm2x_bytes(base, m, d1, d2, ln.dtype, s)
            e["model_bytes"] += _model_bytes(base, m, d1, d2, ln.dtype, s)
    return out


_NUMBERS = ("n", "flops", "bytes", "rbytes", "model_bytes")


def _key(e) -> tuple:
    return tuple((k, tuple(v) if isinstance(v, list) else v)
                 for k, v in sorted(e.items()) if k not in _NUMBERS)


@dataclasses.dataclass
class OpLog:
    """What one counted call (or a combination of them) did: ``entries``,
    each an op (or a TSM2X call) with its identity (``op``, ``cls``:
    "gemm", "tsm2x", "collective" or "other", ``dtype``, a collective's
    ``kind`` and group size ``g``; a TSM2X call's ``kernel``, ``shape``,
    ``executor``, ``S`` and ``body``) and the sums ``n`` (calls),
    ``flops``, ``bytes``, ``rbytes`` (a collective's result bytes) and,
    for a TSM2X call, ``model_bytes``."""
    entries: list

    @classmethod
    def of(cls, counter: OpCounter, events=()) -> "OpLog":
        return cls(list(counter.entries.values())
                   + list(tsm2x_entries(events).values()))


def combine(parts) -> OpLog:
    """Σ coef · log over ``parts`` (pairs of a number and an OpLog),
    entry by entry: the full model's count from cut depths."""
    acc: dict = {}
    for coef, log in parts:
        for e in log.entries:
            k = _key(e)
            if k not in acc:
                acc[k] = {**e, **{f: 0.0 for f in _NUMBERS if f in e}}
            for f in _NUMBERS:
                if f in e:
                    acc[k][f] += coef * e[f]
    return OpLog([e for e in acc.values()
                  if any(abs(e.get(f, 0.0)) > 1e-6 for f in _NUMBERS)])


def cost(log: OpLog) -> dict:
    """{"flops", "bytes accessed"}: the rank's counted FLOPs (the products
    and the TSM2X calls) and bytes (every op, an unfused upper bound)."""
    return {"flops": sum(e["flops"] for e in log.entries),
            "bytes accessed": sum(e["bytes"] for e in log.entries)}


def collectives(log: OpLog) -> CollectiveStats:
    """The rank's collectives: wire bytes (``_wire_bytes`` at each op's
    group size), the number of calls and the wire bytes by kind."""
    stats = CollectiveStats()
    for e in log.entries:
        if e["cls"] != "collective":
            continue
        kind = e["kind"]
        wb = _wire_bytes(kind, e["rbytes"], e["g"])
        stats.wire_bytes += wb
        stats.counts[kind] = stats.counts.get(kind, 0) + int(round(e["n"]))
        stats.by_kind_bytes[kind] = stats.by_kind_bytes.get(kind, 0.0) + wb
    return stats


CLASSES = {"gemm": "library GEMM", "tsm2x": "TSM2X kernels",
           "other": "elementwise", "collective": "collective"}


def by_class(log: OpLog, hw=H100) -> dict:
    """Per class (library GEMM, TSM2X kernels, elementwise, collective):
    the counted FLOPs and bytes, ``compute_s`` at each dtype's peak
    (:func:`peak_flops`), ``memory_s`` at the HBM rate and ``bound_s``,
    the larger. A TSM2X call runs on the tensor cores only on tsm2r's
    wgmma bodies; its other bodies run on the CUDA cores, priced at the
    f32 rate as ``core/perf_model.py`` prices them. The TSM2X class also
    sums ``model_bytes``, which its bound does not read."""
    out = {name: {"flops": 0.0, "bytes": 0.0, "compute_s": 0.0}
           for name in CLASSES.values()}
    out[CLASSES["tsm2x"]]["model_bytes"] = 0.0
    for e in log.entries:
        c = out[CLASSES[e["cls"]]]
        c["flops"] += e["flops"]
        c["bytes"] += e["bytes"]
        if e["cls"] == "tsm2x":
            c["model_bytes"] += e["model_bytes"]
        dtype = e["dtype"]
        if e["cls"] == "tsm2x" and e.get("body") != "wgmma":
            dtype = "float32"
        if e["flops"]:
            c["compute_s"] += e["flops"] / peak_flops(dtype, hw)
    for c in out.values():
        c["memory_s"] = c["bytes"] / hw["hbm_bw"]
        c["bound_s"] = max(c["compute_s"], c["memory_s"])
    return out


def roofline_terms(cost: dict, coll: CollectiveStats, n_chips: int,
                   link_bw: float | None = None, hw=H100) -> dict:
    """cost: :func:`cost` of a rank's log. ``link_bw`` (default
    ``hw["link_bw"]``, NVLink's rate each way) takes the place of the
    reference's ``ici_bw * links``. The keys are the reference's
    (``hlo_flops`` and ``hlo_bytes`` hold the counted FLOPs and bytes)."""
    del n_chips
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    bw = hw["link_bw"] if link_bw is None else link_bw
    t_compute = flops / hw["peak_flops_bf16"]
    t_memory = byts / hw["hbm_bw"]
    t_coll = coll.wire_bytes / bw
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_coll, "collective"))[1]
    return {
        "compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll,
        "dominant": dominant,
        "hlo_flops": flops, "hlo_bytes": byts,
        "collective_bytes": coll.wire_bytes,
        "collective_counts": coll.counts,
        "collective_by_kind": coll.by_kind_bytes,
    }


def model_flops(cfg, shape, n_tokens: int | None = None) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode: D = batch tokens."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n * tokens      # forward only
    tokens = shape.global_batch       # one new token per sequence
    return 2.0 * n * tokens
