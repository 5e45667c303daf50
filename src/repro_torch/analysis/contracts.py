"""Kernel-launch contracts of the H100 port: every feasibility rule, in one
pure module.

Counterpart of ``src/repro/analysis/contracts.py``. The TPU rules were
VMEM budgets and sublane/lane quanta; on the H100 a launch is legal when
the kernel body it names accepts its operands, the body's shared memory
fits the card, the grid fits CUDA's limits, and the reduction is cut into
whole blocks (whole scale bands under int8). The performance model, the
dispatcher and the kernels must agree on that set, so the predicates live
here and both halves import them:

* ``core/perf_model.py`` picks each body with the predicates below
  (``wgmma_fits``, ``skinny_fits``, ``stream_fits``, ``packed_fits``),
  states every grid through :func:`launch_grid`, and filters the
  choosers' S candidates with :func:`feasible`;
* ``kernels/ops.py`` (under ``GemmPolicy.verify_contracts``) checks each
  resolved configuration with :func:`check_kernel_config` before it
  launches;
* ``chip_smoke.py`` checks every launch that ``record_dispatches``
  records on the card's paths against the card's own limits.

Import discipline: stdlib and ``torch`` (dtypes and the card's properties
only), nothing else of ``repro_torch``, so every layer can import it
without cycles. Limits are duck-typed :class:`CardLimits`.

Shapes are ``(m, d1, d2)`` triples: ``(m, k, n)`` for tsm2r/tsm2l, ``(m,
a, b)`` for tsmt (the reduction is k for tsm2r, m for tsmt; tsm2l reads
its whole contraction a row at a time). ``dtype`` is what the operand
tiles stream as (int8 under ``GemmPolicy(quant="int8")``). Params are the
split resolution's (``splits``, ``block_k`` / ``block_m``, as
``ops.resolve_params`` returns them) plus the plan's
(``perf_model.kernel_params``):

* ``body``: the block body the launch runs (:data:`BODIES`);
* ``tile``: (rows, cols) of the output a block owns (tsm2r: (BM, BN);
  tsmt: (BA, BB); tsm2l: the stream body's (rows a tile, n) or the tile
  body's (BM, BN));
* ``smem``: bytes of shared memory a block takes, dynamic and static;
* optional: ``blocks_per_sm`` (the residency the body is designed for,
  default 1), ``max_blocks`` (a persistent grid's cap), ``slices`` and
  ``slice`` (tsmt: the grid's slices of m and their rows; tsm2r: the
  k-slice), ``ptrs`` (``{"a"|"b"|"x"|"y": address}``, of which only the
  value mod 16 matters), ``b_kmajor`` (int8 tsm2r), ``band`` (int8).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

__all__ = [
    "KINDS",
    "BODIES",
    "PARAM_KEYS",
    "Violation",
    "CardLimits",
    "H100_LIMITS",
    "card_limits",
    "ceil_mult",
    "wgmma_fits",
    "skinny_fits",
    "stream_fits",
    "packed_fits",
    "reduction_axis",
    "feasible",
    "check_kernel_config",
    "check_grid",
    "launch_grid",
    "check_backward_policy",
    "check_tuning_record",
    "SPLIT_CANDIDATES",
    "scatter_divisible",
    "check_scatter",
    "executor_reduce_ok",
    "qr_stage_shapes",
    "abft_stage_shapes",
    "TSMT_MAX_B",
    "ABFT_TOL_FACTOR",
]

KINDS = ("tsm2r", "tsm2l", "tsmt")

# The TSMT kernels size their per-block partials for a small output dim;
# past this the shape belongs to the dense path (the JAX package's
# accumulator limit, kept so both packages refuse the same shapes;
# ``kernels/ops.py`` re-exports it).
TSMT_MAX_B = 512

# Safety margin on the online-ABFT detection tolerance (``ft/abft.py``'s
# ``tolerance``): the threshold is ABFT_TOL_FACTOR * eps * (sqrt(rows) +
# sqrt(reduction) + 32) * column_magnitude, the JAX package's value. The
# sqrt terms are random-walk rounding growth over the checksum reduction
# and the protected GEMM's own contraction; the factor absorbs the tail.
ABFT_TOL_FACTOR = 16.0

# The bodies each kind's kernels choose between (``csrc/``): tsm2r's
# tensor-core "wgmma", streaming "skinny" and tile "simt"; tsm2l's
# streaming "stream" and tile "tile"; tsmt's "simt" tile and, for int8
# operands, the "packed" ``__dp4a`` body.
BODIES = {"tsm2r": ("wgmma", "skinny", "simt"),
          "tsm2l": ("stream", "tile"),
          "tsmt": ("simt", "packed")}

# Required param keys per kind: the split resolution's and the plan's.
PARAM_KEYS = {
    "tsm2r": ("splits", "block_k", "body", "tile", "smem"),
    "tsm2l": ("body", "tile", "smem"),
    "tsmt": ("splits", "block_m", "body", "tile", "smem", "slices"),
}

# Operand bytes a body reads as one 16-byte unit: TMA's global strides and
# the vector loads of every streaming body need 16-byte aligned bases.
ALIGN = 16
# tsm2r: outputs wider than this run on the tensor cores ("wgmma", bf16
# and int8); at most this wide the "skinny" body streams A.
WGMMA_MIN_WIDTH = 16
SKINNY_MAX_WIDTH = 16
# tsm2l's "stream" body: n in 1..16 and k in 1..256 (every k the
# classifier routes to TSM2L at its default ``max_skinny``).
STREAM_MAX_WIDTH = 16
STREAM_MAX_K = 256
# Output widths of int8 TSMT's "packed" body: each row of Y whole 32-bit
# words, within the b <= 16 tiles.
PACKED_WIDTHS = (4, 8, 12, 16)
_STREAMED = (torch.float32, torch.bfloat16, torch.int8)
# The split factors S the choosers score (``perf_model``): powers of two
# up to 128, since a tsmt whose output is one tile needs about n_sms
# slices to occupy a 132-SM card (the JAX package's 1..16 was sized for a
# 2-core TPU). A tuning record's S must be one of them.
SPLIT_CANDIDATES = (1, 2, 4, 8, 16, 32, 64, 128)
# The widest CUDA dims: the grid's x, its y and z, and a kernel's int dims.
_INT_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken contract: which rule, on what subject, and why."""

    rule: str        # stable rule id, e.g. "smem-budget", "grid-limit"
    subject: str     # what was checked, e.g. "tsm2r (4096, 4096, 16) f32"
    detail: str      # human-readable explanation with the numbers

    def to_json(self) -> dict:
        return {"rule": self.rule, "subject": self.subject,
                "detail": self.detail}


@dataclasses.dataclass(frozen=True)
class CardLimits:
    """What one launch must fit on a card. The defaults are the H100 SXM's
    (CUDA's compute capability 9.0 table): 227 KB of shared memory a block
    by opt-in, 228 KB an SM, of which the runtime keeps 1 KB for each
    resident block, and grid dims of 2^31 - 1 (x) and 65,535 (y, z)."""

    name: str = "h100"
    smem_per_block: int = 227 * 1024
    smem_per_sm: int = 228 * 1024
    smem_reserved: int = 1024
    max_grid_x: int = _INT_MAX
    max_grid_yz: int = 65535


H100_LIMITS = CardLimits()


@functools.lru_cache(maxsize=None)
def _device_limits(index: int) -> CardLimits:
    props = torch.cuda.get_device_properties(index)
    return dataclasses.replace(
        H100_LIMITS, name=props.name,
        smem_per_block=getattr(props, "shared_memory_per_block_optin",
                               H100_LIMITS.smem_per_block),
        smem_per_sm=getattr(props, "shared_memory_per_multiprocessor",
                            H100_LIMITS.smem_per_sm))


def card_limits(device=None) -> CardLimits:
    """The limits of ``device`` when it is a card (its properties' opt-in
    and per-SM shared memory), else the H100 data sheet's."""
    if device is None:
        return H100_LIMITS
    device = torch.device(device)
    if device.type != "cuda":
        return H100_LIMITS
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return _device_limits(index)


def ceil_mult(x: int, q: int) -> int:
    """Smallest multiple of ``q`` >= ``x`` (the quantization primitive)."""
    return ((x + q - 1) // q) * q


def _aligned(ptr: int) -> bool:
    return ptr % ALIGN == 0


def _name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# The bodies' preconditions (``fits`` of each header in ``csrc/``)
# ---------------------------------------------------------------------------

def wgmma_fits(k: int, n: int, dtype, ptr_a: int = 0, ptr_b: int = 0,
               splits: int = 1) -> bool:
    """tsm2r's tensor-core body: the sequential kernel (S = 1), n > 16,
    k > 0, 16-byte aligned A and B (TMA's 16-byte global strides); bf16
    (``wgmma::fits``) with k and n multiples of 8; int8 (``wgmma_s8::
    fits``, B read K-major, so ``ptr_b`` is the K-major B's and n needs
    no multiple) with k a multiple of 16."""
    if (splits != 1 or n <= WGMMA_MIN_WIDTH or k <= 0
            or not _aligned(ptr_a) or not _aligned(ptr_b)):
        return False
    if dtype == torch.bfloat16:
        return k % 8 == 0 and n % 8 == 0
    if dtype == torch.int8:
        return k % 16 == 0
    return False


def skinny_fits(k: int, n: int, dtype, ptr_a: int = 0,
                slice_: int | None = None) -> bool:
    """tsm2r's streaming body (``skinny::fits``), f32, bf16 or int8,
    sequential or split: n in 1..16, k > 0, A's rows and each k-slice
    (``slice_``, default k) whole 16-byte chunks, A 16-byte aligned."""
    if dtype not in _STREAMED:
        return False
    size = dtype.itemsize
    s = k if slice_ is None else slice_
    return (1 <= n <= SKINNY_MAX_WIDTH and k > 0 and s > 0
            and k * size % ALIGN == 0 and s * size % ALIGN == 0
            and _aligned(ptr_a))


def stream_fits(k: int, n: int, dtype, ptr_a: int = 0) -> bool:
    """tsm2l's streaming row-owner body (``stream::fits``): n in 1..16, k
    in 1..256, A 16-byte aligned."""
    return (dtype in _STREAMED and 1 <= n <= STREAM_MAX_WIDTH
            and 1 <= k <= STREAM_MAX_K and _aligned(ptr_a))


def packed_fits(a: int, b: int, ptr_x: int = 0, ptr_y: int = 0) -> bool:
    """int8 TSMT's packed body (``packed::fits``): b in {4, 8, 12, 16}, a
    a multiple of 16, X and Y 16-byte aligned."""
    return (b in PACKED_WIDTHS and a > 0 and a % 16 == 0
            and _aligned(ptr_x) and _aligned(ptr_y))


def _body_misses(kind, shape, p, dtype) -> list[str]:
    """Why the body ``p`` names does not accept these operands (empty when
    it does)."""
    _, d1, d2 = shape
    body, ptrs = p["body"], p.get("ptrs") or {}
    pa, pb = ptrs.get("a", ptrs.get("x", 0)), ptrs.get("b", ptrs.get("y", 0))
    if body not in BODIES[kind]:
        return [f"{kind} has no body {body!r} (bodies: "
                f"{', '.join(BODIES[kind])})"]
    if body == "wgmma":
        why = []
        if not wgmma_fits(d1, d2, dtype, pa, pb, p.get("splits", 1)):
            why.append(f"wgmma needs S = 1, n > {WGMMA_MIN_WIDTH}, bf16 "
                       "with k and n multiples of 8 or int8 with k a "
                       f"multiple of 16, and aligned A and B; got k={d1} "
                       f"n={d2} {_name(dtype)} S={p.get('splits', 1)} "
                       f"A@{pa % ALIGN} B@{pb % ALIGN}")
        if dtype == torch.int8 and not p.get("b_kmajor", False):
            why.append("the int8 wgmma body reads B K-major; the plan's B "
                       "is row-major")
        return why
    if body == "skinny":
        s = p.get("slice", d1)
        if not skinny_fits(d1, d2, dtype, pa, s):
            return [f"skinny needs n in 1..{SKINNY_MAX_WIDTH}, k * size "
                    "and the slice * size whole 16-byte chunks and an "
                    f"aligned A; got k={d1} slice={s} n={d2} "
                    f"{_name(dtype)} A@{pa % ALIGN}"]
    if body == "stream" and not stream_fits(d1, d2, dtype, pa):
        return [f"stream needs n in 1..{STREAM_MAX_WIDTH}, k in "
                f"1..{STREAM_MAX_K} and an aligned A; got k={d1} n={d2} "
                f"A@{pa % ALIGN}"]
    if body == "packed":
        if dtype != torch.int8 or not packed_fits(d1, d2, pa, pb):
            return [f"packed needs int8, b in {PACKED_WIDTHS}, a % 16 == "
                    f"0 and aligned X and Y; got a={d1} b={d2} "
                    f"{_name(dtype)} X@{pa % ALIGN} Y@{pb % ALIGN}"]
    return []


# ---------------------------------------------------------------------------
# Grids: the single statement of each kernel's grid
# ---------------------------------------------------------------------------

def launch_grid(kind: str, shape, params) -> tuple[int, int, int]:
    """The CUDA grid ``kind`` launches at ``shape`` under ``params``: the
    one statement of each grid, which ``perf_model``'s plan functions (and
    so every ``LaunchMeta.grid`` that ``record_dispatches`` records)
    return.

    * tsm2r / tsm2r_split: (row tiles, column tiles, S) of ``tile``;
    * tsm2l: the stream body's persistent blocks, one a row tile up to
      ``max_blocks``; the tile body's (row tiles, column tiles, 1);
    * tsmt: (a-tiles, b-tiles, ``slices``): the one-launch kernel's plan
      of m slices, or the split kernel's S;
    * "reduce": ``shape`` is the ``(S, rows, cols)`` stack, one ``vec``
      of outputs a thread, ``threads`` a block, up to ``max_blocks``.
    """
    p = dict(params)
    if kind == "reduce":
        _, rows, cols = shape
        n = rows * cols // p["vec"]
        return (max(1, min(-(-n // p["threads"]), p["max_blocks"])), 1, 1)
    m, d1, d2 = shape
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}: valid kinds are "
                         f"{', '.join(KINDS + ('reduce',))}")
    r, c = p["tile"]
    if kind == "tsm2r":
        return (-(-m // r), -(-d2 // c), p.get("splits", 1))
    if kind == "tsmt":
        return (-(-d1 // r), -(-d2 // c), p["slices"])
    if p["body"] == "stream":
        return (min(-(-m // r), p["max_blocks"]), 1, 1)
    return (-(-m // r), -(-d2 // c), 1)


def reduction_axis(kind: str, shape) -> tuple[str, int]:
    """(param name of the reduction block, reduction dim) for the kinds
    whose reduction is cut into slices; tsm2l has no split dimension."""
    m, d1, _ = shape
    if kind == "tsm2r":
        return "block_k", d1
    if kind == "tsmt":
        return "block_m", m
    raise ValueError(f"kind {kind!r} has no sliced reduction axis")


def check_grid(kind: str, shape, params) -> list[Violation]:
    """Grid-divisibility in the port's terms. The port pads nothing (the
    kernels mask ragged edges, which is exact for a GEMM); instead a
    reduction is cut into slices of whole blocks (``ref.split_len``), and
    the contract is that those slices cover it with none empty:
    ``slice % block == 0``, ``S * slice >= depth`` and ``(S - 1) * slice
    < depth``. For ``kind="reduce"`` (``shape`` the ``(S, rows, cols)``
    stack) the vector width divides ``rows * cols``."""
    p = dict(params)
    subject = f"{kind} {tuple(shape)} {p}"
    if kind == "reduce":
        _, rows, cols = shape
        if (rows * cols) % p["vec"]:
            return [Violation(
                "grid-divisibility", subject,
                f"vector width {p['vec']} does not divide rows * cols = "
                f"{rows * cols}: a slab of the stack would start mid-vector")]
        return []
    if kind == "tsm2l":
        return []
    rname, depth = reduction_axis(kind, shape)
    s = p.get("slices", p["splits"]) if kind == "tsmt" else p["splits"]
    if s <= 1:
        return []
    blk, sl = p[rname], p.get("slice")
    out = []
    if sl is None or sl % blk:
        out.append(Violation(
            "grid-divisibility", subject,
            f"slice={sl} is not a whole number of {rname}={blk}"))
    elif s * sl < depth or (s - 1) * sl >= depth:
        out.append(Violation(
            "grid-divisibility", subject,
            f"{s} slices of {sl} do not cover depth {depth} with none "
            "empty"))
    return out


# ---------------------------------------------------------------------------
# Feasibility (the candidate filter the choosers share)
# ---------------------------------------------------------------------------

def feasible(kind: str, shape, params, dtype, limits=None,
             out_dtype=None) -> bool:
    """True iff ``params`` is a launchable configuration for ``kind`` at
    ``shape`` on a card with ``limits``: the predicate the perf model's
    choosers filter their S candidates with, so the model scores only
    what the kernels accept. The TSMT accumulator limit is deliberately
    not part of it, as in the JAX package: it is a contract on the shape
    (``ops.tsmt`` refuses before resolution), not on a candidate."""
    return not [v for v in check_kernel_config(kind, shape, params, dtype,
                                               limits, out_dtype=out_dtype)
                if v.rule != "accumulator-limit"]


def check_kernel_config(kind: str, shape, params, dtype, limits=None, *,
                        max_b: int | None = None,
                        out_dtype=None) -> list[Violation]:
    """Every contract violation of ``params`` (empty list == feasible),
    against ``limits`` (default: the H100 data sheet's).

    ``max_b`` raises the TSMT accumulator limit past :data:`TSMT_MAX_B`
    (a ``GemmPolicy.max_skinny_t`` scope can). ``out_dtype`` is what the
    kernel stores where it differs from ``dtype`` (the int8 kernels);
    it only names the subject, since ``params["smem"]`` already prices it.
    """
    lim = limits if limits is not None else H100_LIMITS
    m, d1, d2 = shape
    p = dict(params)
    subject = f"{kind} {tuple(shape)} {_name(dtype)}"
    if out_dtype is not None:
        subject += f"->{_name(out_dtype)}"
    subject += f" {p}"
    out: list[Violation] = []

    if kind not in KINDS:
        return [Violation("unknown-kind", subject,
                          f"unknown kernel kind {kind!r}")]
    missing = [k for k in PARAM_KEYS[kind] if k not in p]
    if missing:
        return [Violation("missing-params", subject,
                          f"missing required params {missing}")]

    # -- positivity / integrality -------------------------------------------
    ints = {k: v for k, v in p.items()
            if k.startswith("block") or k in ("splits", "slices",
                                              "blocks_per_sm", "max_blocks")}
    for name, v in ints.items():
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            out.append(Violation("bad-param", subject,
                                 f"{name}={v!r} must be a positive int"))
    tile = p["tile"]
    if not (isinstance(tile, tuple) and len(tile) == 2
            and all(isinstance(t, int) and t >= 1 for t in tile)):
        out.append(Violation("bad-param", subject,
                             f"tile={tile!r} must be two positive ints"))
    if not isinstance(p["smem"], int) or p["smem"] < 0:
        out.append(Violation("bad-param", subject,
                             f"smem={p['smem']!r} must be a byte count"))
    if out:
        return out
    splits = p.get("splits", 1)

    # -- the body the plan names accepts the operands -----------------------
    out.extend(Violation("body-preconditions", subject, why)
               for why in _body_misses(kind, shape, p, dtype))

    # -- shared memory: a block, and the blocks resident on an SM -----------
    smem, per_sm = p["smem"], p.get("blocks_per_sm", 1)
    if smem > lim.smem_per_block:
        out.append(Violation(
            "smem-budget", subject,
            f"{p['body']} takes {smem} B of shared memory a block > the "
            f"card's {lim.smem_per_block} B opt-in limit ({lim.name})"))
    elif per_sm * (smem + lim.smem_reserved) > lim.smem_per_sm:
        out.append(Violation(
            "smem-budget", subject,
            f"{per_sm} resident blocks x ({smem} + {lim.smem_reserved}) B "
            f"> the card's {lim.smem_per_sm} B an SM ({lim.name})"))

    # -- the grid and the dims fit CUDA's limits ----------------------------
    grid = launch_grid(kind, shape, p)
    if (grid[0] > lim.max_grid_x or grid[1] > lim.max_grid_yz
            or grid[2] > lim.max_grid_yz):
        out.append(Violation(
            "grid-limit", subject,
            f"grid {grid} exceeds ({lim.max_grid_x}, {lim.max_grid_yz}, "
            f"{lim.max_grid_yz})"))
    if max(m, d1, d2) > _INT_MAX:
        out.append(Violation(
            "grid-limit", subject,
            f"dims {tuple(shape)} do not fit the kernels' 32-bit ints"))

    # -- split-K whole-slice feasibility ------------------------------------
    if kind == "tsm2l":
        if splits != 1:
            out.append(Violation(
                "split-unsupported", subject,
                f"splits={splits}: tsm2l reads each row's whole "
                "contraction and has no split dimension"))
    elif splits > 1:
        rname, rdim = reduction_axis(kind, shape)
        blk = p[rname]
        if splits * blk > ceil_mult(rdim, blk):
            out.append(Violation(
                "split-whole-slice", subject,
                f"splits={splits} x {rname}={blk} > ceil_mult({rdim}, "
                f"{blk})={ceil_mult(rdim, blk)}: slices past the "
                "reduction are empty"))

    # -- int8 TSMT slices are whole scale bands -----------------------------
    if kind == "tsmt" and dtype == torch.int8:
        band = p.get("band")
        if band is None:
            out.append(Violation("band-quantum", subject,
                                 "an int8 tsmt launch names no scale band"))
        else:
            for name in ("block_m", "slice"):
                v = p.get(name)
                if v is not None and p["slices"] > 1 and v % band:
                    out.append(Violation(
                        "band-quantum", subject,
                        f"{name}={v} is not a whole number of {band}-row "
                        "scale bands: a band would straddle two slices"))

    # -- TSMT partials limit ------------------------------------------------
    if kind == "tsmt":
        limit = max(TSMT_MAX_B, max_b or 0)
        if d2 > limit:
            out.append(Violation(
                "accumulator-limit", subject,
                f"tsmt small output dim b={d2} exceeds the per-block "
                f"partials limit ({limit})"))
    return out


# ---------------------------------------------------------------------------
# Collective-layout contracts
# ---------------------------------------------------------------------------

def scatter_divisible(rows: int, shards: int) -> bool:
    """psum_scatter's existence condition: the scattered output rows must
    tile exactly over the dp shards (the dispatcher falls back to dense
    otherwise; a pinned scatter executor raises)."""
    return shards >= 1 and rows % shards == 0


def check_scatter(rows: int, shards: int) -> list[Violation]:
    if scatter_divisible(rows, shards):
        return []
    return [Violation(
        "psum-scatter-divisibility", f"rows={rows} shards={shards}",
        f"psum_scatter output rows ({rows}) do not divide the {shards} "
        "shards: the row-sharded layout cannot exist")]


def executor_reduce_ok(declared, reduce: str) -> bool:
    """Does an executor whose declared reduce contract is ``declared``
    (an iterable of mode names) implement ``reduce``?"""
    return reduce in tuple(declared)


# ---------------------------------------------------------------------------
# Policy contracts
# ---------------------------------------------------------------------------

def check_backward_policy(fwd, bwd) -> list[Violation]:
    """The re-dispatch invariants ``tsmm.backward_policy`` must honour
    (duck-typed on the GemmPolicy fields, so this layer stays pure):

    * ``reduce`` is kept, but "none" becomes "psum" (stacked partials
      would give the cotangent another shape than its primal);
    * an int ``split`` pin goes back to "auto" (it was chosen for the
      forward shape), while "auto"/"never" are kept (scope-wide intent);
    * the executor pin is dropped (cotangent shapes re-select);
    * a forward-kind force becomes "auto"; "dense"/"auto" stay;
    * ``quant`` is kept (scope-wide numeric intent);
    * ``abft`` is kept (scope-wide integrity intent: the cotangent GEMMs
      of a verify/correct scope get their own checksums).
    """
    subject = f"backward_policy({fwd!r})"
    out = []
    want_reduce = "psum" if fwd.reduce == "none" else fwd.reduce
    if bwd.reduce != want_reduce:
        out.append(Violation(
            "backward-reduce", subject,
            f"backward reduce={bwd.reduce!r}, expected {want_reduce!r} "
            f"(forward reduce={fwd.reduce!r})"))
    want_split = "auto" if isinstance(fwd.split, int) else fwd.split
    if bwd.split != want_split:
        out.append(Violation(
            "backward-split", subject,
            f"backward split={bwd.split!r}, expected {want_split!r} "
            f"(forward split={fwd.split!r})"))
    if bwd.executor is not None:
        out.append(Violation(
            "backward-executor", subject,
            f"backward keeps executor pin {bwd.executor!r}; the backward "
            "must re-select"))
    want_mode = fwd.mode if fwd.mode in ("auto", "dense") else "auto"
    if bwd.mode != want_mode:
        out.append(Violation(
            "backward-mode", subject,
            f"backward mode={bwd.mode!r}, expected {want_mode!r} "
            f"(forward mode={fwd.mode!r})"))
    want_quant = getattr(fwd, "quant", "none")
    if getattr(bwd, "quant", "none") != want_quant:
        out.append(Violation(
            "backward-quant", subject,
            f"backward quant={getattr(bwd, 'quant', 'none')!r}, expected "
            f"{want_quant!r}: quant is scope-wide numeric intent and must "
            "survive the backward's re-dispatch"))
    want_abft = getattr(fwd, "abft", "none")
    if getattr(bwd, "abft", "none") != want_abft:
        out.append(Violation(
            "abft-policy", subject,
            f"backward abft={getattr(bwd, 'abft', 'none')!r}, expected "
            f"{want_abft!r}: abft is scope-wide integrity intent and must "
            "survive the backward's re-dispatch"))
    return out


# ---------------------------------------------------------------------------
# Tuning-table contracts
# ---------------------------------------------------------------------------

_MALFORMED = ("unknown-kind", "missing-params", "bad-param")


def check_tuning_record(kind: str, shape, params, dtype, limits=None, *,
                        executor: str = "",
                        known_executors=()) -> list[Violation]:
    """Contract check of one ``TuningTable`` record (``core/autotune.py``).

    ``params`` is the record's launch in this module's terms: the caller
    expands the record's S with ``perf_model.kernel_params`` (this layer
    imports no perf model; ``autotune.record_launch`` does it). The launch
    must keep every rule of :func:`check_kernel_config` on a card with
    ``limits`` and cut its reduction as :func:`check_grid` says; the
    record's ``executor`` must be one of ``known_executors`` (when given:
    ``unknown-executor``); and its S must be one of
    :data:`SPLIT_CANDIDATES` within the recorded shape's whole blocks
    (``tuning-splits``): ``ops.resolve_params`` would clamp any other S
    quietly, so such a record is stale or corrupt."""
    out = check_kernel_config(kind, shape, params, dtype, limits)
    malformed = any(v.rule in _MALFORMED for v in out)
    if not malformed:
        out += check_grid(kind, shape, params)
    if known_executors and executor not in known_executors:
        out.append(Violation(
            "unknown-executor",
            f"{kind} {tuple(shape)} executor={executor!r}",
            f"record's executor {executor!r} is not registered "
            f"(known: {sorted(known_executors)})"))
    if malformed or kind == "tsm2l":
        return out
    p = dict(params)
    rname, depth = reduction_axis(kind, shape)
    s, most = p["splits"], max(1, -(-depth // p[rname]))
    if s not in SPLIT_CANDIDATES or s > most:
        out.append(Violation(
            "tuning-splits", f"{kind} {tuple(shape)} {_name(dtype)} "
            f"splits={s}",
            f"the record's S = {s} is not one of {SPLIT_CANDIDATES} up to "
            f"the {most} slices of whole {rname}={p[rname]} blocks that "
            f"depth {depth} admits: the resolution would clamp it"))
    return out


# ---------------------------------------------------------------------------
# Tall-skinny QR stage contracts
# ---------------------------------------------------------------------------

def qr_stage_shapes(m: int, r: int, *, shards: int = 1
                    ) -> tuple[tuple[str, tuple[int, int, int]], ...]:
    """The GEMM-stage (kind, shape) pairs one tall-skinny QR pass
    resolves: ``repro_torch.linalg``'s CholeskyQR2 factors an ``(m, r)``
    operand through the Gram ``A^T A`` (a tsmt at ``(m, r, r)``) and the
    ``R^-1`` apply (a tsm2l at ``(m, r, r)``); the small Cholesky and
    triangular solve between them never reach the kernels. ``shards > 1``
    describes ``linalg.tree_tsqr``, whose local factor runs the same two
    stages on the per-shard row count (``m`` must tile over the shards,
    the divisibility the shard_map executors require)."""
    if shards < 1 or (shards > 1 and m % shards != 0):
        raise ValueError(
            f"qr_stage_shapes: m={m} does not tile over shards={shards} "
            "(tree-TSQR requires the tall dim to divide the shard count)")
    m_loc = m // shards
    return (("tsmt", (m_loc, r, r)), ("tsm2l", (m_loc, r, r)))


# ---------------------------------------------------------------------------
# Online-ABFT stage contracts
# ---------------------------------------------------------------------------

def abft_stage_shapes(kind: str, shape, s: int = 2
                      ) -> tuple[tuple[str, tuple[int, int, int]], ...]:
    """The checksum-GEMM (entry, shape) pairs the online ABFT guard
    (``core/tsmm.py``, ``GemmPolicy.abft``) dispatches around one
    protected ``(kind, (m, d1, d2))`` GEMM, with ``s`` checksum columns
    (>= 2: the plain column and the ramp; fewer cannot localize).

    For ``tsm2r``/``tsm2l`` (``A(m,k) @ B(k,n)``, shape ``(m, k, n)``):
    ``u = A^T e`` (mmt over m), ``c_ref = B^T u`` (mmt over k),
    ``c_out = C^T e`` (mmt over m). For ``tsmt`` (``X(m,a)^T Y(m,b)``,
    shape ``(m, a, b)``): ``v = X e`` (mm over m), ``c_ref^T = v^T Y``
    (mmt over m), ``c_out = C^T e`` (mmt over a).
    """
    if s < 2:
        raise ValueError(
            f"abft_stage_shapes: s={s} checksum columns cannot localize "
            "(need the plain column AND the ramp: s >= 2)")
    m, d1, d2 = shape
    if kind in ("tsm2r", "tsm2l"):
        return (("mmt", (m, d1, s)),       # u = A^T e
                ("mmt", (d1, d2, s)),      # c_ref = B^T u
                ("mmt", (m, d2, s)))       # c_out = C^T e
    if kind == "tsmt":
        return (("mm", (m, d1, s)),        # v = X e
                ("mmt", (m, s, d2)),       # c_ref^T = v^T Y
                ("mmt", (d1, d2, s)))      # c_out = C^T e
    raise ValueError(
        f"abft_stage_shapes: unknown kind {kind!r}: the online guard only "
        f"protects {', '.join(KINDS)}")
