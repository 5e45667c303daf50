"""Dataflow verifier of the port's CUDA launches: which output tile each
block writes, which reduction it sums, what it reads, and in what
accumulator.

Counterpart of ``src/repro/analysis/kernel_verify.py``. The reference
captures each ``pallas_call``'s grid and BlockSpec index maps and
evaluates the maps over the grid. The port's kernels have no such
objects: every block computes its tile and its slice of the reduction
inside the CUDA source. So the verifier has two halves.

* **The statement.** :func:`block_map` states, for every grid cell (and
  for a persistent body every tile it visits), the :class:`Block` it
  writes: the output buffer (``"C"``; ``"P"`` and a slot for the split
  kernels' partials and the one-launch tsmt's workspace; ``"amax"``,
  ``"scale"`` and ``"q"`` for the quantize pass), the rows and columns,
  the reduction range ``[lo, hi)``, the accumulator, and for the
  one-launch tsmt the block that sums the tile's slices into C. It is
  built from the port's plans, never from a copy of them:
  ``contracts.launch_grid`` and the ``tile`` / ``splits`` / ``slice`` /
  ``slices`` / ``max_blocks`` params of ``perf_model.kernel_params``
  (``tsm2l_stream_geometry`` inside it), ``perf_model.reduce_plan`` and
  ``perf_model.quantize_plan``.
* **The tie to the kernels.** Built with ``-DTSM2X_BLOCK_MAP``
  (``kernels/_build.py``'s block-map libraries, ``csrc/block_map.cuh``),
  thread 0 of every block records the same facts from the variables the
  kernel computes them with. ``chip_smoke.py``'s dataflow phase turns the
  card's records into :class:`Block` s (:func:`from_records`), holds them
  against :func:`block_map` set for set (:func:`compare`) and runs
  :func:`check_blocks` on them. On the CPU alone the checks prove the
  statement consistent; only the card's records prove that the kernels
  do what it says.

The checks (one stable rule id each; :func:`check_blocks`):

====================  ====================================================
``write-race``        two records write one element of one buffer slot
                      (``amax`` excepted: its chunks combine by atomicMax)
``coverage``          every element of each written buffer slot is
                      written (the port pads nothing and masks ragged
                      edges, so this replaces the padded-shape rules)
``reduction-slices``  each output tile's slices cover its depth whole,
                      disjoint, none empty
``index-bounds``      nothing read or written outside the operands' true
                      dims, no slot past S
``accumulator-dtype`` f32 for f32 and bf16 operands; exact int32 tiles
                      (then f32) for int8; f32 for the sums of partials
``finalize-once``     the one-launch tsmt sums each tile into C exactly
                      once, in the block that drew the last ticket, after
                      all S slices wrote their partials
``launch-meta-drift`` the grid the records come from equals
                      ``contracts.launch_grid`` (and the recorded
                      ``LaunchMeta.grid`` when given)
====================  ====================================================

Above :data:`EXHAUSTIVE_CELL_LIMIT` grid cells :func:`verify_kernel_config`
corner-samples the x and y block coordinates (first, second, middle, last
two) and keeps every z: each sampled tile keeps all its slices, so the
reduction and finalize rules still hold whole, while ``coverage`` is
skipped. The report marks such a run ``sampled``: evidence, not proof.

Import discipline: stdlib, ``torch`` and the port's ``contracts`` and
``perf_model``.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import Counter

import torch

from repro_torch.analysis import contracts
from repro_torch.analysis.contracts import Violation
from repro_torch.core import perf_model

__all__ = [
    "EXHAUSTIVE_CELL_LIMIT",
    "BODY_CODES",
    "RECORD_INTS",
    "Block",
    "Report",
    "block_map",
    "sample_cells",
    "check_blocks",
    "compare",
    "from_records",
    "verify_kernel_config",
]

EXHAUSTIVE_CELL_LIMIT = 4096

# ``csrc/block_map.cuh``'s Body codes, by (kind, body).
BODY_CODES = {
    ("tsm2r", "simt"): 1, ("tsm2r", "wgmma"): 2, ("tsm2r", "wgmma-s8"): 3,
    ("tsm2r", "skinny"): 4, ("tsm2l", "tile"): 5, ("tsm2l", "stream"): 6,
    ("tsmt", "simt"): 7, ("tsmt", "packed"): 8, ("tsmt", "final"): 9,
    ("reduce", "sum"): 10, ("quantize", "absmax"): 11,
    ("quantize", "codes"): 12, ("quantize", "kmajor"): 13,
    ("quantize", "scales"): 14, ("transpose", "copy"): 15,
}
# int32 words of a record (``block_map::Record``: the u64 dst, then 18).
RECORD_INTS = 20
_FIELDS = ("body", "bx", "by", "bz", "gx", "gy", "gz", "r0", "r1", "c0",
           "c1", "lo", "hi", "acc_bytes", "acc_int", "final", "ticket",
           "tile")
# Records whose accumulator sums f32 values whatever the operands.
_F32_SUMS = (9, 10, 11)
KINDS = contracts.KINDS + ("reduce", "quantize", "transpose")


@dataclasses.dataclass(frozen=True)
class Block:
    """One visit of one block to one output tile (``csrc/block_map.cuh``'s
    Record): ``buf`` and ``slot`` name the matrix written, ``rows`` and
    ``cols`` the rectangle of it, ``red`` the reduction range summed,
    ``acc`` the accumulator's (bytes, is integer); ``block`` is (x, y, z),
    z = -1 for the tsmt tile's finalizer, which any of its S blocks may
    be; ``grid`` the launch's grid; ``ticket`` the ticket a finalizer
    drew; ``tile`` a persistent body's tile index (-1 elsewhere)."""

    body: int
    block: tuple
    grid: tuple
    buf: str
    slot: int
    rows: tuple
    cols: tuple
    red: tuple
    acc: tuple
    final: bool = False
    ticket: int = 0
    tile: int = -1

    def key(self) -> tuple:
        """What :func:`compare` matches a card record on: everything but
        the grid (``launch-meta-drift`` reads that)."""
        return (self.body, self.block, self.buf, self.slot, self.rows,
                self.cols, self.red, self.acc, self.final, self.ticket,
                self.tile)


class Report(list):
    """``list[Violation]`` of one :func:`verify_kernel_config` run, with
    ``subject``, ``grid``, ``cells`` (grid cells the launch has),
    ``sampled`` (whether the cells were corner-sampled) and ``blocks``
    (records checked)."""

    subject = ""
    grid: tuple = ()
    cells = 0
    sampled = False
    blocks = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _acc(dtype) -> tuple:
    """The accumulator the contract wants of a block over ``dtype``
    operands: exact int32 for int8, f32 otherwise."""
    return (4, 1) if dtype == torch.int8 else (4, 0)


def _operand_dtype(dtype, quant: str):
    return torch.int8 if quant == "int8" else dtype


def _slice(z: int, sl: int, depth: int) -> tuple:
    lo = min(z * sl, depth)
    return lo, min(lo + sl, depth)


def _span(i: int, size: int, dim: int) -> tuple:
    return i * size, min((i + 1) * size, dim)


# ---------------------------------------------------------------------------
# The statement: each kind's blocks from its plan
# ---------------------------------------------------------------------------

def grid_of(kind: str, shape, params) -> tuple:
    """The grid the statement's blocks run over: ``contracts.launch_grid``
    for the kernels, ``perf_model.quantize_plan``'s absmax launch for the
    quantize pass (its codes launch: ``quantize_plan``'s ``codes_grid``),
    ``perf_model.transpose_q8_grid`` for the int8 layout copy. A tsm2l
    tile body's x dim is capped at ``params["resident"]`` where given:
    its launcher runs at most the blocks resident on the card over the
    row tiles (``perf_model.tsm2l_plan``)."""
    if kind == "quantize":
        return perf_model.quantize_plan(*shape, params["kmajor"])[
            "absmax_grid"]
    if kind == "transpose":
        return perf_model.transpose_q8_grid(*shape)
    g = contracts.launch_grid(kind, shape, params)
    if kind == "tsm2l" and params["body"] == "tile" and params.get(
            "resident"):
        g = (min(g[0], params["resident"]), *g[1:])
    return tuple(g)


def sample_cells(grid, limit: int = EXHAUSTIVE_CELL_LIMIT):
    """The (x, y) block coordinates to enumerate: all of them up to
    ``limit`` cells (x * y * z), else the corners of each dim (first,
    second, middle, last two), where ``i * tile``-style arithmetic drifts
    first. Returns (coordinates, sampled)."""
    gx, gy, gz = grid
    if gx * gy * gz <= limit:
        return list(itertools.product(range(gx), range(gy))), False

    def corners(n):
        return sorted({i for i in (0, 1, n // 2, n - 2, n - 1)
                       if 0 <= i < n})
    return list(itertools.product(corners(gx), corners(gy))), True


def _tsm2r(shape, p, dtype, cells, grid):
    m, k, n = shape
    s, body = p.get("splits", 1), p["body"]
    bm, bn = p["tile"]
    name = "wgmma-s8" if body == "wgmma" and dtype == torch.int8 else body
    code = BODY_CODES[("tsm2r", name)]
    acc = _acc(dtype)
    for (i, j), z in itertools.product(cells, range(grid[2])):
        red = _slice(z, p["slice"], k) if s > 1 else (0, k)
        yield Block(code, (i, j, z), grid, "P" if s > 1 else "C", z,
                    _span(i, bm, m), _span(j, bn, n), red, acc)


def _tsm2l(shape, p, dtype, cells, grid):
    m, k, n = shape
    bm, bn = p["tile"]
    code = BODY_CODES[("tsm2l", p["body"])]
    acc, tiles = _acc(dtype), _cdiv(m, bm)
    for i, j in cells:
        for t in range(i, tiles, grid[0]):
            yield Block(code, (i, j, 0), grid, "C", 0, _span(t, bm, m),
                        _span(j, bn, n), (0, k), acc, tile=t)


def _tsmt(shape, p, dtype, cells, grid):
    m, a, b = shape
    split = p.get("splits", 1) > 1
    s = grid[2]
    ba, bb = p["tile"]
    code = BODY_CODES[("tsmt", p["body"])]
    acc = _acc(dtype)
    for i, j in cells:
        rows, cols = _span(i, ba, a), _span(j, bb, b)
        for z in range(s):
            red = _slice(z, p["slice"], m) if s > 1 else (0, m)
            yield Block(code, (i, j, z), grid, "P" if s > 1 else "C", z,
                        rows, cols, red, acc)
        if s > 1 and not split:
            yield Block(BODY_CODES[("tsmt", "final")], (i, j, -1), grid,
                        "C", 0, rows, cols, (0, m), (4, 0), final=True,
                        ticket=s - 1)


def _reduce(shape, p, dtype, cells, grid):
    s, rows, cols = shape
    vec, nt = p["vec"], p["threads"]
    n_vec = rows * cols // vec
    for i, _ in cells:
        for t in range(i, _cdiv(n_vec, nt), grid[0]):
            yield Block(BODY_CODES[("reduce", "sum")], (i, 0, 0), grid, "C",
                        0, (t * nt * vec, min((t + 1) * nt, n_vec) * vec),
                        (0, 1), (0, s), (4, 0), tile=t)


def _quantize(shape, p, dtype, cells, grid):
    rows, cols, band = shape
    q = perf_model.quantize_plan(rows, cols, band, p["kmajor"])
    chunk, tile = q["chunk"], q["tile"]
    codes_grid = q["codes_grid"]
    for b, _ in cells:
        bnd, c = divmod(b, q["chunks"])
        end_of_band = min((bnd + 1) * q["band_elems"], q["total"])
        begin = bnd * q["band_elems"] + c * chunk
        end = min(begin + chunk, end_of_band)
        if begin >= end:
            continue
        yield Block(BODY_CODES[("quantize", "absmax")], (b, 0, 0), grid,
                    "amax", 0, (bnd, bnd + 1), (0, 1), (begin, end), (4, 0))
        if not p["kmajor"]:
            yield Block(BODY_CODES[("quantize", "codes")], (b, 0, 0),
                        codes_grid, "q", 0, (begin, end), (0, 1), (0, 0),
                        (0, 0))
    if p["kmajor"]:
        for i, j in itertools.product(range(codes_grid[0]),
                                      range(codes_grid[1])):
            yield Block(BODY_CODES[("quantize", "kmajor")], (i, j, 0),
                        codes_grid, "q", 0, _span(i, tile, cols),
                        _span(j, tile, rows), (0, 0), (0, 0))
    if any(b == 0 for b, _ in cells):
        yield Block(BODY_CODES[("quantize", "scales")], (0, 0, 0),
                    codes_grid, "scale", 0,
                    (0, 1 if p["kmajor"] else q["bands"]), (0, 1), (0, 0),
                    (0, 0))


def _transpose(shape, p, dtype, cells, grid):
    rows, cols = shape
    tile = perf_model.QUANT_TILE
    for i, j in cells:
        yield Block(BODY_CODES[("transpose", "copy")], (i, j, 0), grid, "q",
                    0, _span(i, tile, cols), _span(j, tile, rows), (0, 0),
                    (0, 0))


_MAPS = {"tsm2r": _tsm2r, "tsm2l": _tsm2l, "tsmt": _tsmt,
         "reduce": _reduce, "quantize": _quantize, "transpose": _transpose}


def block_map(kind: str, shape, params, dtype=torch.float32, *,
              quant: str = "none", cells=None) -> list[Block]:
    """Every block record of one launch of ``kind`` at ``shape`` under
    ``params`` (``perf_model.kernel_params``' for the kernels; the reduce
    epilogue's ``{"vec", "threads", "max_blocks"}`` at its ``(S, rows,
    cols)`` stack; ``{"kmajor"}`` for the quantize pass at ``(rows, cols,
    band)``; ``{}`` for the int8 layout copy at ``(rows, cols)``), for
    ``dtype`` operands (int8 under ``quant="int8"``). ``cells``: the (x,
    y) block coordinates to state (default: all); every z of each."""
    if kind not in _MAPS:
        raise ValueError(f"unknown kernel kind {kind!r}: valid kinds are "
                         f"{', '.join(KINDS)}")
    grid = grid_of(kind, shape, params)
    if cells is None:
        cells = list(itertools.product(range(grid[0]), range(grid[1])))
    return list(_MAPS[kind](tuple(shape), dict(params),
                            _operand_dtype(dtype, quant), cells, grid))


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------

def _outputs(kind, shape, params, grid) -> dict:
    """(rows, cols) of each buffer a launch writes, and the slots of the
    slotted one."""
    if kind == "reduce":
        s, rows, cols = shape
        return {"C": (rows * cols, 1, 1)}
    if kind == "quantize":
        rows, cols, band = shape
        q = perf_model.quantize_plan(rows, cols, band, params["kmajor"])
        return {"amax": (q["bands"], 1, 1),
                "scale": (1 if params["kmajor"] else q["bands"], 1, 1),
                "q": (cols, rows, 1) if params["kmajor"] else
                     (rows * cols, 1, 1)}
    if kind == "transpose":
        rows, cols = shape
        return {"q": (cols, rows, 1)}
    m, d1, d2 = shape
    out = (d1, d2) if kind == "tsmt" else (m, d2)
    s = grid[2] if kind != "tsm2l" else 1
    if s > 1:
        bufs = {"P": (*out, s)}
        if kind == "tsmt" and params.get("splits", 1) == 1:
            bufs["C"] = (*out, 1)
        return bufs
    return {"C": (*out, 1)}


def _depth(kind, shape) -> int:
    if kind == "tsm2r" or kind == "tsm2l":
        return shape[1]
    if kind == "tsmt":
        return shape[0]
    if kind == "reduce":
        return shape[0]
    return 0


def _reads(kind, b: Block, shape) -> list:
    """(operand, (row range), (col range), (operand rows, cols)) of what a
    block reads, from its record."""
    (r0, r1), (c0, c1), (lo, hi) = b.rows, b.cols, b.red
    if kind in ("tsm2r", "tsm2l"):
        m, k, n = shape
        return [("A", (r0, r1), (lo, hi), (m, k)),
                ("B", (lo, hi), (c0, c1), (k, n))]
    if kind == "tsmt":
        m, a, bdim = shape
        if b.final:
            return []
        return [("X", (lo, hi), (r0, r1), (m, a)),
                ("Y", (lo, hi), (c0, c1), (m, bdim))]
    if kind == "reduce":
        s, rows, cols = shape
        return [("P", (lo, hi), (r0, r1), (s, rows * cols))]
    if kind == "quantize":
        rows, cols, _ = shape
        flat = (rows * cols, 1)
        if b.buf == "amax":
            return [("x", (lo, hi), (0, 1), flat)]
        if b.buf == "q" and b.cols == (0, 1) and b.body == 12:
            return [("x", (r0, r1), (0, 1), flat)]
        if b.body == 13:
            return [("x", (c0, c1), (r0, r1), (rows, cols))]
        return []
    if kind == "transpose":
        rows, cols = shape
        return [("src", (c0, c1), (r0, r1), (rows, cols))]
    return []


def _intervals(spans, lo, hi):
    """(overlaps, gaps) of half-open ``spans`` against [lo, hi)."""
    overlaps, gaps, at = [], [], lo
    for a, b in sorted(spans):
        if a < at:
            overlaps.append((a, b))
        elif a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < hi:
        gaps.append((at, hi))
    return overlaps, gaps


def check_blocks(kind: str, shape, params, dtype, blocks, *,
                 quant: str = "none", recorded_grid=None,
                 complete: bool = True, subject: str = "") -> list[Violation]:
    """Every rule above over ``blocks`` (the statement's or the card's
    records of one launch). ``complete``: the blocks are every cell's,
    so ``coverage`` applies (a corner-sampled set is not)."""
    dtype = _operand_dtype(dtype, quant)
    p = dict(params)
    subject = subject or f"{kind} {tuple(shape)} {contracts._name(dtype)}"
    grid = grid_of(kind, shape, p)
    outs = _outputs(kind, shape, p, grid)
    depth = _depth(kind, shape)
    out: list[Violation] = []

    def bad(rule, detail):
        out.append(Violation(rule, subject, detail))

    # launch-meta-drift: each record's grid against its launch's plan
    want = tuple(grid)
    codes = (perf_model.quantize_plan(*shape, p["kmajor"])["codes_grid"]
             if kind == "quantize" else want)
    drift = set()
    for b in blocks:
        g = codes if b.body in (12, 13, 14) else want
        if kind == "tsm2l" and p["body"] == "tile":
            # the card caps x at its resident blocks (grid_of)
            full = contracts.launch_grid(kind, shape, p)
            if b.grid[0] > full[0] or tuple(b.grid[1:]) != tuple(full[1:]):
                drift.add(b.grid)
        elif tuple(b.grid) != tuple(g):
            drift.add(b.grid)
    if drift:
        bad("launch-meta-drift", f"records come from grids {sorted(drift)}; "
            f"the plan's grid is {want}")
    if recorded_grid is not None and kind in contracts.KINDS + ("reduce",):
        stated = tuple(contracts.launch_grid(kind, shape, p))
        if tuple(recorded_grid) != stated:
            bad("launch-meta-drift", f"LaunchMeta.grid "
                f"{tuple(recorded_grid)} is not launch_grid {stated}")

    # index-bounds and accumulator-dtype, block by block
    for b in blocks:
        dims = outs.get(b.buf)
        if dims is None:
            bad("index-bounds", f"block {b.block} writes {b.buf!r}, which "
                f"this launch does not write ({sorted(outs)})")
            continue
        nr, nc, ns = dims
        (r0, r1), (c0, c1), (lo, hi) = b.rows, b.cols, b.red
        if not (0 <= r0 < r1 <= nr and 0 <= c0 < c1 <= nc
                and 0 <= b.slot < ns):
            bad("index-bounds", f"block {b.block} writes {b.buf}[{b.slot}]"
                f"[{r0}:{r1}, {c0}:{c1}] of a {ns} x {nr} x {nc} buffer")
        if b.acc[0] and depth and not (0 <= lo <= hi <= depth):
            bad("index-bounds", f"block {b.block} sums [{lo}, {hi}) of a "
                f"depth of {depth}")
        for name, (a0, a1), (e0, e1), (dr, dc) in _reads(kind, b, shape):
            if not (0 <= a0 <= a1 <= dr and 0 <= e0 <= e1 <= dc):
                bad("index-bounds", f"block {b.block} reads {name}[{a0}:"
                    f"{a1}, {e0}:{e1}] of a {dr} x {dc} operand")
        if b.acc[0]:
            acc_want = (4, 0) if b.body in _F32_SUMS else _acc(dtype)
            if tuple(b.acc) != acc_want:
                kind_of = lambda a: (f"int{8 * a[0]}" if a[1]
                                     else f"f{8 * a[0]}")
                bad("accumulator-dtype", f"block {b.block} accumulates in "
                    f"{kind_of(b.acc)}; {contracts._name(dtype)} operands "
                    f"want {kind_of(acc_want)}")

    # write-race and coverage, per buffer slot, row band by row band
    by_slot: dict = {}
    for b in blocks:
        if b.buf in outs and b.buf != "amax":
            by_slot.setdefault((b.buf, b.slot), []).append(b)
    for buf, (nr, nc, ns) in outs.items():
        if buf == "amax":
            continue
        for slot in range(ns):
            rects = by_slot.get((buf, slot), [])
            bands: dict = {}
            for b in rects:
                bands.setdefault(b.rows, []).append(b)
            for rows, group in bands.items():
                overlaps, gaps = _intervals([g.cols for g in group], 0, nc)
                if overlaps:
                    bad("write-race", f"{buf}[{slot}] rows {rows}: columns "
                        f"{overlaps[:3]} written by more than one block")
                if gaps and complete:
                    bad("coverage", f"{buf}[{slot}] rows {rows}: columns "
                        f"{gaps[:3]} written by no block")
            overlaps, gaps = _intervals(list(bands), 0, nr)
            if overlaps:
                bad("write-race", f"{buf}[{slot}]: rows {overlaps[:3]} "
                    "written by more than one band of blocks")
            if gaps and complete:
                bad("coverage", f"{buf}[{slot}]: rows {gaps[:3]} written "
                    "by no block")

    # reduction-slices: each output tile's slices (its records across
    # slots), and the quantize pass's chunks of each band
    tiles: dict = {}
    for b in blocks:
        if b.acc[0] and not b.final and b.buf != "scale":
            tiles.setdefault((b.rows, b.cols), []).append(b.red)
    if kind == "quantize":
        q = perf_model.quantize_plan(*shape, p["kmajor"])
        span = lambda rows: (rows[0] * q["band_elems"],
                             min(rows[1] * q["band_elems"], q["total"]))
    else:
        span = lambda rows: (0, depth)
    if complete or kind not in ("quantize", "reduce"):
        for (rows, cols), reds in tiles.items():
            lo, hi = span(rows)
            empty = [r for r in reds if r[0] >= r[1]]
            overlaps, gaps = _intervals(reds, lo, hi)
            if empty or overlaps or gaps:
                bad("reduction-slices", f"tile rows {rows} cols {cols}: "
                    f"slices {sorted(reds)[:6]} of [{lo}, {hi}) "
                    + ", ".join(f"{w} {v[:3]}" for w, v in (
                        ("empty", empty), ("overlapping", overlaps),
                        ("missing", gaps)) if v))

    # finalize-once (the one-launch tsmt)
    one_launch = kind == "tsmt" and p.get("splits", 1) == 1 and grid[2] > 1
    finals: dict = {}
    for b in blocks:
        if b.final:
            finals.setdefault((b.rows, b.cols), []).append(b)
    if kind == "tsmt" and not one_launch and finals:
        bad("finalize-once", f"{len(finals)} tiles finalized by a launch "
            "without slices to sum")
    if one_launch:
        s = grid[2]
        for rect, group in finals.items():
            if len(group) != 1:
                bad("finalize-once", f"tile {rect} finalized "
                    f"{len(group)} times")
            slots = sorted(b.slot for b in blocks
                           if not b.final and (b.rows, b.cols) == rect)
            if group[0].ticket != s - 1 or slots != list(range(s)):
                bad("finalize-once", f"tile {rect} finalized on ticket "
                    f"{group[0].ticket} after slices {slots[:8]} of {s}")
        missing = {(b.rows, b.cols) for b in blocks if not b.final} - set(
            finals)
        if missing:
            bad("finalize-once", f"tiles {sorted(missing)[:3]} never "
                "summed into C")
    return out


def verify_kernel_config(kind: str, shape, params, dtype=torch.float32, *,
                         quant: str = "none", recorded_grid=None,
                         limit: int = EXHAUSTIVE_CELL_LIMIT) -> Report:
    """:func:`check_blocks` over :func:`block_map` of one launch, every
    cell up to ``limit`` cells and corner-sampled above it. Returns the
    violations as a :class:`Report`."""
    grid = grid_of(kind, shape, params)
    cells, sampled = sample_cells(grid, limit)
    rep = Report()
    rep.subject = (f"{kind} {tuple(shape)} "
                   f"{contracts._name(_operand_dtype(dtype, quant))} "
                   f"body={dict(params).get('body', '-')}")
    rep.grid, rep.sampled = tuple(grid), sampled
    rep.cells = grid[0] * grid[1] * grid[2]
    blocks = block_map(kind, shape, params, dtype, quant=quant, cells=cells)
    rep.blocks = len(blocks)
    rep.extend(check_blocks(kind, shape, params, dtype, blocks, quant=quant,
                            recorded_grid=recorded_grid,
                            complete=not sampled, subject=rep.subject))
    return rep


# ---------------------------------------------------------------------------
# The card's records
# ---------------------------------------------------------------------------

def from_records(words: torch.Tensor, bases: dict) -> list[Block]:
    """:class:`Block` s of the card's records: ``words`` an int32 tensor of
    ``RECORD_INTS`` words a record (the u64 dst, then the Record's ints),
    ``bases`` ``{buf: (address, slot bytes, slots)}`` of the launch's
    buffers (slot bytes 0 and slots 1 for an unslotted one). A dst that is
    no buffer's base (or slot's) gets buf "?". A
    finalizer's z becomes -1 once it is checked to lie within the grid
    (else it keeps its z and fails :func:`compare`)."""
    rows = words.reshape(-1, RECORD_INTS).to(torch.int64).tolist()
    out = []
    for w in rows:
        dst = (w[0] & 0xFFFFFFFF) | ((w[1] & 0xFFFFFFFF) << 32)
        f = dict(zip(_FIELDS, w[2:]))
        buf, slot = "?", 0
        for name, (base, step, slots) in bases.items():
            off = dst - base
            if off == 0 or (step and 0 < off < step * slots
                            and off % step == 0):
                buf, slot = name, off // step if step else 0
                break
        z = f["bz"]
        if f["final"] and 0 <= z < f["gz"]:
            z = -1
        out.append(Block(f["body"], (f["bx"], f["by"], z),
                         (f["gx"], f["gy"], f["gz"]), buf, slot,
                         (f["r0"], f["r1"]), (f["c0"], f["c1"]),
                         (f["lo"], f["hi"]), (f["acc_bytes"], f["acc_int"]),
                         bool(f["final"]), f["ticket"], f["tile"]))
    return out


def compare(card: list[Block], stated: list[Block],
            subject: str = "") -> list[Violation]:
    """The card's records against the statement's, set for set (a block
    recorded twice counts twice)."""
    got, want = Counter(b.key() for b in card), Counter(
        b.key() for b in stated)
    extra, missing = got - want, want - got
    if not extra and not missing:
        return []
    return [Violation(
        "block-map-mismatch", subject,
        f"{sum(extra.values())} card records not in the statement (first: "
        f"{list(extra)[:2]}), {sum(missing.values())} stated blocks the "
        f"card did not record (first: {list(missing)[:2]})")]
