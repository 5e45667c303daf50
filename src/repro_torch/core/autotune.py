"""Measured autotuning of the TSM2X split factor on the H100.

Counterpart of ``src/repro/core/autotune.py``. The paper's Algorithm 5
has two halves: pick the launch from the analytic performance model, then
*profile* to correct it. ``core.perf_model`` is the analytic half; this
module is the measured half:

* :func:`autotune_shape` times the kernel op on the card over exactly the
  split factors S the chooser scores (``perf_model.split_candidates``)
  and records the measured winner beside the model's pick and error.
  The port's kernels fix their tiles per shape, so S is the one tuned
  parameter: a record's ``params`` is ``{"splits": S}`` for tsm2r and
  tsmt and ``{}`` for tsm2l, which has no reduction to split.
* :class:`TuningTable` is the persistent (JSON) cache of those records,
  keyed by ``(kernel kind, shape bucket, dtype, spec name, executor)``.
  Hang it on a policy -- ``with tsmm.policy(tuning_table=tbl)`` -- and
  ``kernels/ops.resolve_params`` takes a record's S before it runs the
  chooser (a pinned ``split`` still wins).
* :func:`calibrate` / :func:`fit_spec` fit the model's free constants,
  ``GPUSpec.launch_s`` (the fixed cost a launch adds) and
  ``GPUSpec.hbm_bw`` (the stream rate the kernels reach), to the
  measurements, so the chooser improves for shapes that are not in the
  table too (``TuningTable.fitted_spec``).

Keys are the JAX package's strings: dims up to one lane tile (128) are
kept exact and larger ones round up to the next power of two, and dtypes
are named as numpy names them ("float32", "bfloat16", "int8"). A record
is made under the card's spec (``perf_model.device_spec(H100, device)``,
named "h100") and the executor the call runs under: "cuda" on the card,
"torch-ref" for CPU tensors. Under ``GemmPolicy(quant="int8")`` the key's
dtype is the effective "int8", as the chooser prices it.

Timing (:func:`time_call`). On the card it measures device time: a
single eager op here is host-bound, so events around one call would time
Python. A ``torch.cuda._sleep`` first holds the stream while the host
enqueues every timed call, each between two events, so each interval is
one call's device time (both kernels and the epilogue of a split arm).
The calls cycle through copies of the operands, enough that more than
twice the card's L2 passes between two reads of one copy. On the CPU it
takes ``time.perf_counter`` around each call, as the reference does;
those numbers exercise the mechanism only.

Each arm runs its own policy: the caller's with ``split`` pinned to the
candidate, no table and no ABFT guard, so no ambient pin or table steers
it (the reference's ``jit_isolated`` guards its jit cache against the
same leak), and its one run inside ``tsmm.record_dispatches`` must launch
at that S.
Candidates that the resolution clamps to one S are one arm. A candidate
the contracts accept must run: a failure raises (no arm is skipped).
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
import warnings
from typing import Callable, Iterable

import torch

from repro_torch import resolve_device
from repro_torch.core import perf_model
from repro_torch.kernels import ops

__all__ = [
    "TABLE_SCHEMA",
    "TuningRecord",
    "TuningTable",
    "SpecFit",
    "Observation",
    "CalibrationResult",
    "bucket_dim",
    "bucket_shape",
    "record_key",
    "fit_key",
    "record_launch",
    "run_isolated",
    "time_call",
    "autotune_shape",
    "build_table",
    "observations_from_table",
    "fit_spec",
    "calibrate",
]

# The port's own schema. The JAX loader refuses it ("not a tuning
# table"); ``TuningTable.from_json`` also reads the JAX package's
# "repro-tsm2x-tuning/" tables, whose fit cells it drops.
TABLE_SCHEMA = "repro-tsm2x-tuning-gpu/1"
JAX_SCHEMA_PREFIX = "repro-tsm2x-tuning/"

KINDS = ("tsm2r", "tsm2l", "tsmt")


# ---------------------------------------------------------------------------
# Shape bucketing + keys
# ---------------------------------------------------------------------------

def bucket_dim(d: int, lane: int = 128) -> int:
    """Bucket one dim: exact up to a lane tile, next power of two above."""
    if d <= lane:
        return d
    return 1 << (d - 1).bit_length()


def bucket_shape(m: int, d1: int, d2: int,
                 lane: int = 128) -> tuple[int, int, int]:
    return (bucket_dim(m, lane), bucket_dim(d1, lane), bucket_dim(d2, lane))


def record_key(kind: str, bucket: tuple[int, int, int], dtype: str,
               spec_name: str, executor: str) -> str:
    """Stable string form of the table key (also the on-disk JSON key)."""
    bm, b1, b2 = bucket
    return f"{kind}|{bm}x{b1}x{b2}|{dtype}|{spec_name}|{executor}"


# Wildcard cell for the table-wide (global) calibration fit.
GLOBAL_FIT = ("*", (0, 0, 0), "*")


def fit_key(kind: str, bucket: tuple[int, int, int], dtype: str,
            spec_name: str) -> str:
    """Key of one fitted-constants cell (no executor: the fit corrects the
    *model*, which is executor-blind)."""
    bm, b1, b2 = bucket
    return f"{kind}|{bm}x{b1}x{b2}|{dtype}|{spec_name}"


def _dtype_name(dtype) -> str:
    """numpy's name of ``dtype`` (a torch dtype or its name): "float32",
    "bfloat16", "int8", as the JAX package keys them."""
    name = str(dtype).removeprefix("torch.")
    if not isinstance(getattr(torch, name, None), torch.dtype):
        raise ValueError(f"not a dtype: {dtype!r}")
    return name


def _torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, _dtype_name(dtype))


def _params_tuple(params) -> tuple[tuple[str, int], ...]:
    return tuple(sorted(dict(params).items()))


# ---------------------------------------------------------------------------
# Table
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TuningRecord:
    """One tuned entry: the measured-best S for one (kind, bucket, dtype,
    spec, executor) cell, plus everything needed to audit the model."""

    kind: str                                   # "tsm2r" | "tsm2l" | "tsmt"
    bucket: tuple[int, int, int]                # bucketed (tall, d1, d2)
    dtype: str                                  # numpy dtype name
    spec_name: str                              # GPUSpec.name
    executor: str                               # "cuda" | "torch-ref"
    shape: tuple[int, int, int]                 # the shape actually measured
    params: tuple[tuple[str, int], ...]         # (("splits", S),) or ()
    measured_us: float                          # time of those params
    model_us: float                             # model's prediction for them
    model_error: float                          # |model - measured|/measured
    model_pick: tuple[tuple[str, int], ...]     # the chooser's pick
    model_pick_measured_us: float               # its measured time

    @property
    def params_dict(self) -> dict[str, int]:
        return dict(self.params)

    @property
    def key(self) -> str:
        return record_key(self.kind, self.bucket, self.dtype, self.spec_name,
                          self.executor)

    @property
    def pick_matches(self) -> bool:
        """Did the chooser already pick the measured winner?"""
        return self.params == self.model_pick


@dataclasses.dataclass(frozen=True)
class SpecFit:
    """Fitted model constants for one shape bucket (or the table-wide
    ``GLOBAL_FIT`` wildcard cell): the ``calibrate()`` output, stored so
    ``GemmPolicy.tuning_table`` consumers run the chooser under the
    constants measured near the shape at hand instead of one global
    compromise (a launch-bound ABFT stage and a streaming PowerSGD
    projection want very different corrections)."""

    kind: str                       # kernel kind, or "*" for the global fit
    bucket: tuple[int, int, int]    # bucketed shape; (0, 0, 0) for global
    dtype: str                      # numpy dtype name, or "*" for global
    spec_name: str                  # GPUSpec.name the fit corrects
    launch_s: float
    hbm_bw: float

    @property
    def key(self) -> str:
        return fit_key(self.kind, self.bucket, self.dtype, self.spec_name)


@dataclasses.dataclass(frozen=True)
class TuningTable:
    """Immutable, hashable set of tuning records (+ fitted model specs).

    Hashability matters: the table rides on ``GemmPolicy.tuning_table``,
    which must stay hashable. ``add`` returns a new table (same-key
    records are replaced).

    ``fits`` carries per-bucket fitted model constants plus the global
    fit (``calibrate`` writes them); :meth:`fitted_spec` is the consumer
    view -- bucket-local fit first, global fit second, caller's spec as-is
    when the table has neither.
    """

    records: tuple[TuningRecord, ...] = ()
    fits: tuple[SpecFit, ...] = ()
    _index: dict | None = dataclasses.field(
        default=None, compare=False, repr=False)
    _fit_index: dict | None = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "_index", {r.key: r for r in self.records})
        object.__setattr__(self, "_fit_index",
                           {f.key: f for f in self.fits})

    @classmethod
    def from_records(cls, records: Iterable[TuningRecord],
                     fits: Iterable[SpecFit] = ()) -> "TuningTable":
        merged: dict[str, TuningRecord] = {}
        for r in records:
            merged[r.key] = r
        fmerged: dict[str, SpecFit] = {}
        for f in fits:
            fmerged[f.key] = f
        return cls(records=tuple(merged.values()),
                   fits=tuple(fmerged.values()))

    def add(self, record: TuningRecord) -> "TuningTable":
        return self.from_records((*self.records, record), self.fits)

    def with_fits(self, fits: Iterable[SpecFit]) -> "TuningTable":
        """New table with ``fits`` merged over the existing ones."""
        return self.from_records(self.records, (*self.fits, *fits))

    def lookup(self, kind: str, m: int, d1: int, d2: int, *, dtype,
               spec: str, executor: str) -> TuningRecord | None:
        key = record_key(kind, bucket_shape(m, d1, d2), _dtype_name(dtype),
                         spec, executor)
        return self._index.get(key)

    def fitted_spec(self, kind: str, m: int, d1: int, d2: int, *, dtype,
                    spec: perf_model.GPUSpec) -> perf_model.GPUSpec:
        """``spec`` with this shape-bucket's fitted ``launch_s`` and
        ``hbm_bw`` -- bucket-local cell first, the global wildcard second,
        unchanged when the table carries no fits at all. The rest of
        ``spec`` (the card's SM count) stays as given."""
        fit = self._fit_index.get(
            fit_key(kind, bucket_shape(m, d1, d2), _dtype_name(dtype),
                    spec.name))
        if fit is None:
            fit = self._fit_index.get(fit_key(*GLOBAL_FIT, spec.name))
        if fit is None:
            return spec
        return dataclasses.replace(spec, launch_s=fit.launch_s,
                                   hbm_bw=fit.hbm_bw)

    # -- JSON round trip ----------------------------------------------------

    def to_json(self) -> dict:
        return {
            "schema": TABLE_SCHEMA,
            "fits": [
                {
                    "kind": f.kind,
                    "bucket": list(f.bucket),
                    "dtype": f.dtype,
                    "spec": f.spec_name,
                    "launch_s": f.launch_s,
                    "hbm_bw": f.hbm_bw,
                }
                for f in self.fits
            ],
            "records": [
                {
                    "key": r.key,
                    "kind": r.kind,
                    "bucket": list(r.bucket),
                    "dtype": r.dtype,
                    "spec": r.spec_name,
                    "executor": r.executor,
                    "shape": list(r.shape),
                    "params": dict(r.params),
                    "measured_us": r.measured_us,
                    "model_us": r.model_us,
                    "model_error": r.model_error,
                    "model_pick": dict(r.model_pick),
                    "model_pick_measured_us": r.model_pick_measured_us,
                }
                for r in self.records
            ],
        }

    @classmethod
    def from_json(cls, data: dict) -> "TuningTable":
        """A table from :meth:`to_json`'s form, or from a JAX package
        table (any "repro-tsm2x-tuning/" schema). Of a JAX table the
        records are kept as they are -- their TPU spec name and executor
        ("pallas-tpu", "interpret") match no lookup of the port, so they
        steer nothing -- and the fit cells are dropped: they hold the
        TPU's constants (step overhead, DMA latency), not the card's."""
        schema = data.get("schema", "")
        if schema == TABLE_SCHEMA:
            fits = tuple(
                SpecFit(kind=f["kind"], bucket=tuple(f["bucket"]),
                        dtype=f["dtype"], spec_name=f["spec"],
                        launch_s=f["launch_s"], hbm_bw=f["hbm_bw"])
                for f in data.get("fits", ()))
        elif schema.startswith(JAX_SCHEMA_PREFIX):
            fits = ()
        else:
            raise ValueError(f"not a tuning table (schema={schema!r})")
        return cls.from_records((
            TuningRecord(
                kind=d["kind"],
                bucket=tuple(d["bucket"]),
                dtype=d["dtype"],
                spec_name=d["spec"],
                executor=d["executor"],
                shape=tuple(d["shape"]),
                params=_params_tuple(d["params"]),
                measured_us=d["measured_us"],
                model_us=d["model_us"],
                model_error=d["model_error"],
                model_pick=_params_tuple(d["model_pick"]),
                model_pick_measured_us=d["model_pick_measured_us"],
            )
            for d in data["records"]), fits)

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path) -> "TuningTable":
        with open(path) as f:
            return cls.from_json(json.load(f))


def record_launch(record: TuningRecord,
                  spec: perf_model.GPUSpec = perf_model.H100) -> dict:
    """The launch a record stands for, in ``analysis/contracts.py``'s
    terms (``perf_model.kernel_params`` at its shape, dtype and S), as
    ``contracts.check_tuning_record`` takes it."""
    return perf_model.kernel_params(
        record.kind, *record.shape, _torch_dtype(record.dtype),
        record.params_dict.get("splits", 1), spec)


# ---------------------------------------------------------------------------
# Timing harness
# ---------------------------------------------------------------------------

# The clock the gate's sleep is sized at: the H100 SXM's boost clock, so a
# lower clock only lengthens the sleep.
_SLEEP_HZ = 1.98e9
# Gates tried, each 4x longer, before a host that outruns them is an error.
_GATE_TRIES = 4
# Operand copies at most: only operands under ~100 KB need more than this
# to pass twice the L2 between two reads of one copy.
_MAX_COPIES = 1024


def _median(ts: list[float]) -> float:
    ts = sorted(ts)
    mid = len(ts) // 2
    # True median: even rep counts average the middle pair (upper-middle
    # alone would report the *worse* of two samples at reps=2).
    return ts[mid] if len(ts) % 2 else (ts[mid - 1] + ts[mid]) / 2


def time_call(fn: Callable, *args, reps: int = 3, warmup: int = 1) -> float:
    """Median time (seconds) of one ``fn(*args)``: device time when a
    tensor of ``args`` lies on a card (the sleep-gated event intervals of
    the module docstring, over copies of the tensors), else host wall time
    around each call."""
    on_card = [a for a in args if isinstance(a, torch.Tensor) and a.is_cuda]
    if on_card:
        return _device_time(fn, args, reps, warmup, on_card[0].device)
    for _ in range(warmup):
        fn(*args)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        ts.append(time.perf_counter() - t0)
    return _median(ts)


def _operand_sets(args, device) -> list[tuple]:
    """``args`` and copies of its tensors: enough sets that more than
    twice the card's L2 is read between two reads of one set."""
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    n = min(_MAX_COPIES, 2 * l2 // max(nbytes, 1) + 2)
    return [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args) for _ in range(n - 1)]


def _device_time(fn, args, reps: int, warmup: int, device) -> float:
    sets = _operand_sets(args, device)
    calls = iter(range(1 << 62))

    def call():
        fn(*sets[next(calls) % len(sets)])

    with torch.cuda.device(device):
        for _ in range(max(warmup, 1)):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()                      # the host's enqueue time of one call
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        gate = 2.0 * (reps + 1) * host + 1e-3
        for _ in range(_GATE_TRIES):
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(reps + 1)]
            torch.cuda._sleep(int(gate * _SLEEP_HZ))
            for e in ev[:-1]:
                e.record()
                call()
            ev[-1].record()
            # Still asleep once every call is enqueued: no call waited on
            # the host, so each interval is device time alone.
            gated = not ev[0].query()
            ev[-1].synchronize()
            if gated:
                break
            gate *= 4
        else:
            raise RuntimeError(
                f"time_call: the host took longer than a {gate / 4:.4f} s "
                f"gate to enqueue {reps} calls; the intervals would time "
                "the host")
    return _median([ev[i].elapsed_time(ev[i + 1]) / 1e3
                    for i in range(reps)])


def _call_for(kind: str, policy) -> Callable:
    """The op of ``kind`` through the dispatcher (its kind forced, so the
    kernel executor of the operands' device runs ``ops.tsm2r`` /
    ``ops.tsm2l`` / ``ops.tsmt`` and ``record_dispatches`` sees the
    launch) under ``policy``."""
    from repro_torch.core import tsmm  # deferred: tsmm imports kernels.ops
    if kind == "tsmt":
        return lambda x, y: tsmm.tsmm_t(x, y, mode="tsmt", policy=policy)
    return lambda a, b: tsmm.tsmm(a, b, mode=kind, policy=policy)


def _arm_policy(policy, splits: int | None):
    """The policy of one arm: the caller's with no table, no ABFT guard
    (its checksum GEMMs are dispatches of other shapes) and, for the kinds
    that split, ``split`` pinned to the candidate."""
    if splits is None:
        return policy.with_(tuning_table=None, abft="none")
    return policy.with_(split=splits, tuning_table=None, abft="none")


def run_isolated(kind: str, operands, policy, splits: int | None):
    """One arm run once: ``(fn, dispatch_log)``, where ``fn`` is the op of
    ``kind`` under its own policy (:func:`_arm_policy`) and the log the
    ``tsmm.record_dispatches`` record of that run, from which the caller
    checks the launch."""
    from repro_torch.core import tsmm
    fn = _call_for(kind, _arm_policy(policy, splits))
    with tsmm.record_dispatches() as log:
        fn(*operands)
    return fn, log


def _launched_splits(log, kind: str) -> int:
    """The S the one dispatch of ``log`` launched ``kind``'s kernel at."""
    runs = [lm.splits for e in log if e.kind == kind
            for lm in e.launches if lm.kind != "reduce"]
    if len(log) != 1 or len(runs) != 1:
        raise RuntimeError(
            f"autotune: one {kind} launch expected, the arm dispatched "
            f"{[(e.kind, e.executor, len(e.launches)) for e in log]}")
    return runs[0]


# ---------------------------------------------------------------------------
# Per-shape autotuning
# ---------------------------------------------------------------------------

def _kind_plan(kind: str, m: int, d1: int, d2: int, spec, dtype):
    """(candidates as param dicts, model-time fn, the chooser's pick) per
    kind, ``dtype`` the effective one (int8 under quant): the S that
    ``perf_model.split_candidates`` scores, ``[{}]`` for tsm2l."""
    if kind == "tsm2l":
        return ([{}],
                lambda p: perf_model.tsm2l_model_time(m, d1, d2, spec, dtype),
                {})
    if kind == "tsm2r":
        model_fn, choose = (perf_model.tsm2r_model_time,
                            perf_model.choose_splits_tsm2r)
    elif kind == "tsmt":
        model_fn, choose = (perf_model.tsmt_model_time,
                            perf_model.choose_splits_tsmt)
    else:
        raise ValueError(f"unknown kernel kind {kind!r}: valid kinds are "
                         f"{', '.join(KINDS)}")

    def model(p):
        return model_fn(m, d1, d2, spec, dtype, splits=p["splits"])

    cands = [{"splits": s} for s in perf_model.split_candidates(
        kind, m, d1, d2, spec, dtype)]
    return cands, model, {"splits": choose(m, d1, d2, spec, dtype)}


def _operands(kind: str, m: int, d1: int, d2: int, dtype, device,
              seed: int = 0):
    g = torch.Generator(device=device).manual_seed(seed)
    if kind == "tsmt":  # X[m, a], Y[m, b]
        shapes = ((m, d1), (m, d2))
    else:               # A[m, k], B[k, n]
        shapes = ((m, d1), (d1, d2))
    return tuple(
        torch.empty(s, device=device).uniform_(-1, 1, generator=g).to(dtype)
        for s in shapes)


def _resolved(kind, m, d1, d2, dtype, policy, params, device) -> dict:
    """``params`` as the resolution runs them on ``device`` (a pinned S
    clamped to whole, non-empty slices)."""
    if kind == "tsm2l":
        return {}
    p = ops.resolve_params(kind, m, d1, d2, dtype,
                           _arm_policy(policy, params["splits"]),
                           device=device)
    return {"splits": p["splits"]}


def autotune_shape(kind: str, m: int, d1: int, d2: int, *,
                   dtype=torch.float32, policy=None, device=None,
                   spec: perf_model.GPUSpec | None = None, reps: int = 3,
                   warmup: int = 1) -> TuningRecord:
    """Measure every candidate S for one shape; return the record.

    ``(d1, d2)`` are ``(k, n)`` for tsm2r/tsm2l and ``(a, b)`` for tsmt;
    the operands are drawn in ``dtype`` on ``device`` (default: the
    current card). ``policy`` (default: the current scope) is the scope
    every arm starts from; its ``quant`` sets the effective dtype.
    ``spec`` (default: ``perf_model.device_spec(H100, device)``) scores
    the candidates, the chooser's pick and the model's times. Each arm
    runs once inside ``record_dispatches``, must launch at its S, and is
    then timed by :func:`time_call`.
    """
    from repro_torch.core import tsmm

    pol = policy if policy is not None else tsmm.current_policy()
    device = resolve_device(device)
    if spec is None:
        spec = perf_model.device_spec(perf_model.H100, device)
    eff = torch.int8 if pol.quant == "int8" else dtype
    cands, model, pick = _kind_plan(kind, m, d1, d2, spec, eff)
    arms: list[dict] = []
    for params in (*cands, pick):
        p = _resolved(kind, m, d1, d2, dtype, pol, params, device)
        if p not in arms:
            arms.append(p)
    pick = _resolved(kind, m, d1, d2, dtype, pol, pick, device)
    operands = _operands(kind, m, d1, d2, dtype, device)

    measured: list[tuple[float, dict]] = []
    for params in arms:
        s = params.get("splits")
        fn, log = run_isolated(kind, operands, pol, s)
        got = _launched_splits(log, kind)
        if got != (s or 1):
            raise RuntimeError(f"autotune: the {kind} arm at S = {s} "
                               f"launched at S = {got}")
        measured.append((time_call(fn, *operands, reps=reps, warmup=warmup),
                         params))
    best_t, best_p = min(measured, key=lambda r: r[0])
    pick_t = next(t for t, p in measured if p == pick)
    model_s = model(best_p)
    return TuningRecord(
        kind=kind,
        bucket=bucket_shape(m, d1, d2),
        dtype=_dtype_name(eff),
        spec_name=spec.name,
        executor=ops.executor_name(device),
        shape=(m, d1, d2),
        params=_params_tuple(best_p),
        measured_us=best_t * 1e6,
        model_us=model_s * 1e6,
        model_error=abs(model_s - best_t) / best_t,
        model_pick=_params_tuple(pick),
        model_pick_measured_us=pick_t * 1e6,
    )


def build_table(shapes: Iterable[tuple[str, int, int, int]], *,
                dtype=torch.float32, policy=None, device=None,
                spec: perf_model.GPUSpec | None = None, reps: int = 3,
                warmup: int = 1) -> TuningTable:
    """Autotune ``(kind, m, d1, d2)`` shapes into one TuningTable.

    Shapes that land in the same table bucket are merged by keeping the
    faster measured winner -- with a warning, since the extra measurement
    was wasted and the caller probably wanted distinct buckets.
    """
    by_key: dict[str, TuningRecord] = {}
    for kind, m, d1, d2 in shapes:
        rec = autotune_shape(kind, m, d1, d2, dtype=dtype, policy=policy,
                             device=device, spec=spec, reps=reps,
                             warmup=warmup)
        prev = by_key.get(rec.key)
        if prev is not None:
            warnings.warn(
                f"autotune shapes {prev.shape} and {rec.shape} share table "
                f"bucket {rec.key}; keeping the faster winner", stacklevel=2)
            if prev.measured_us <= rec.measured_us:
                continue
        by_key[rec.key] = rec
    return TuningTable(records=tuple(by_key.values()))


# ---------------------------------------------------------------------------
# Model calibration: fit the free GPUSpec constants to measurements
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Observation:
    """One (shape, params) -> measured-seconds data point."""

    kind: str
    m: int
    d1: int
    d2: int
    dtype: str
    params: tuple[tuple[str, int], ...]
    measured_s: float

    def model_s(self, spec) -> float:
        dtype = _torch_dtype(self.dtype)
        s = dict(self.params).get("splits", 1)
        if self.kind == "tsm2r":
            return perf_model.tsm2r_model_time(self.m, self.d1, self.d2,
                                               spec, dtype, splits=s)
        if self.kind == "tsm2l":
            return perf_model.tsm2l_model_time(self.m, self.d1, self.d2,
                                               spec, dtype)
        return perf_model.tsmt_model_time(self.m, self.d1, self.d2, spec,
                                          dtype, splits=s)


def observations_from_table(table: TuningTable) -> list[Observation]:
    """Both timings each record holds (measured winner + the chooser's
    pick) become calibration points."""
    obs = []
    for r in table.records:
        m, d1, d2 = r.shape
        obs.append(Observation(r.kind, m, d1, d2, r.dtype, r.params,
                               r.measured_us / 1e6))
        if (r.model_pick != r.params
                and r.model_pick_measured_us == r.model_pick_measured_us):
            obs.append(Observation(r.kind, m, d1, d2, r.dtype, r.model_pick,
                                   r.model_pick_measured_us / 1e6))
    return obs


def _mean_log_err(spec, observations) -> float:
    tot = 0.0
    for o in observations:
        tot += abs(math.log(max(o.model_s(spec), 1e-12)
                            / max(o.measured_s, 1e-12)))
    return tot / max(len(observations), 1)


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    spec: perf_model.GPUSpec       # the fitted spec
    error_before: float            # mean |log(model/measured)| pre-fit
    error_after: float             # ... post-fit
    table: TuningTable | None = None


# Coordinate-descent grids: coarse powers of two first, then refinement.
_FIT_GRIDS = (
    tuple(2.0 ** i for i in range(-5, 6)),
    (0.5, 0.7, 0.85, 1.0, 1.2, 1.5, 2.0),
    (0.9, 0.95, 1.0, 1.05, 1.1),
)


def fit_spec(spec: perf_model.GPUSpec, observations: list[Observation], *,
             fit: tuple[str, ...] = ("launch_s", "hbm_bw"),
             ) -> CalibrationResult:
    """Fit free model constants against measurements (pure, no timing).

    ``launch_s`` (a launch's fixed cost, added per launch) and ``hbm_bw``
    (the stream rate, dividing the bytes) are fit by coordinate descent
    on multiplicative scales, minimizing the mean absolute log
    model/measured ratio. The port's contracts are hard limits of the
    card, not a modelled budget, so there is no feasibility constant to
    raise (the reference's ``vmem_usable``).
    """
    before = _mean_log_err(spec, observations)
    cur = spec
    if observations:
        for grid in _FIT_GRIDS:
            for name in fit:
                base = getattr(cur, name)
                best_v, best_e = base, _mean_log_err(cur, observations)
                for mult in grid:
                    trial = dataclasses.replace(cur, **{name: base * mult})
                    e = _mean_log_err(trial, observations)
                    if e < best_e - 1e-15:
                        best_v, best_e = base * mult, e
                cur = dataclasses.replace(cur, **{name: best_v})
    return CalibrationResult(spec=cur, error_before=before,
                             error_after=_mean_log_err(cur, observations))


DEFAULT_CALIBRATION_SHAPES = (
    ("tsm2r", 2048, 512, 8),
    ("tsm2r", 4096, 1024, 16),
    ("tsm2l", 8192, 16, 16),
    ("tsmt", 4096, 64, 8),
)


def calibrate(shapes=DEFAULT_CALIBRATION_SHAPES, *, spec=None,
              dtype=torch.float32, policy=None, device=None, reps: int = 3,
              warmup: int = 1,
              base_table: TuningTable | None = None) -> CalibrationResult:
    """Measure + fit in one step: the ``calibrate(spec)`` entry point.

    Autotunes ``shapes`` on ``device`` (default: the current card) under
    ``policy`` (or the current scope), then fits the free constants of
    ``spec`` (default: ``perf_model.device_spec(H100, device)``) to the
    measurements -- once globally over every observation, and once per
    shape bucket. Both land on the returned table (``TuningTable.fits``),
    so consumers hanging the table on ``GemmPolicy.tuning_table`` get
    bucket-local model constants for off-table shapes in a measured bucket
    (``kernels/ops`` prefers the bucket-local fit; the global fit is the
    fallback cell). Returns the globally fitted spec, before/after error,
    and the table.

    ``base_table`` makes a *partial re-calibration* incremental: the
    returned table carries the base records merged under the fresh ones
    (same-bucket records are replaced by the new measurement), while the
    ``fits`` are ONLY this run's -- stale per-bucket ``SpecFit`` cells from
    the base age out rather than silently steering the chooser with
    constants an older run (another card, power limit or build)
    measured. Fitted constants must come from one coherent measurement
    pass; records are per-bucket facts and merge safely.
    """
    device = resolve_device(device)
    if spec is None:
        spec = perf_model.device_spec(perf_model.H100, device)
    table = build_table(shapes, dtype=dtype, policy=policy, device=device,
                        spec=spec, reps=reps, warmup=warmup)
    obs = observations_from_table(table)
    fitted = fit_spec(spec, obs)
    fits = [SpecFit(*GLOBAL_FIT, spec.name, fitted.spec.launch_s,
                    fitted.spec.hbm_bw)]
    groups: dict[tuple, list[Observation]] = {}
    for o in obs:
        key = (o.kind, bucket_shape(o.m, o.d1, o.d2), o.dtype)
        groups.setdefault(key, []).append(o)
    for (kind, bucket, dt), group in groups.items():
        local = fit_spec(spec, group)
        fits.append(SpecFit(kind, bucket, dt, spec.name,
                            local.spec.launch_s, local.spec.hbm_bw))
    if base_table is not None:
        # base fits intentionally dropped (see docstring); records merge
        # with this run's measurements winning shared buckets.
        table = TuningTable.from_records(
            (*base_table.records, *table.records))
    return dataclasses.replace(fitted, table=table.with_fits(fits))
