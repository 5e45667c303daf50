"""What the split-reduction chooser needs of a performance model, for the
H100.

Counterpart of the split half of ``src/repro/core/perf_model.py``
(``occupancy`` :151, ``split_partials_bytes`` :165, the modelled times
:184-270 and the choosers :352-404). The TPU model counted grid cells
against TensorCores; here blocks are counted against streaming
multiprocessors, from the port's own tile tables (``csrc/common.cuh``,
mirrored by ``tsm2r_tile``/``tsmt_tile`` below, and ``tsm2r_plan``'s
choice of body). The sequential TSM2R runs bf16 and int8 outputs wider
than 16 on the tensor cores (its "wgmma" bodies, priced at the bf16 and
int8 tensor-core rates); every other kernel, and TSM2R's "skinny" and
"simt" bodies, runs on the CUDA cores: FMAs in f32 for f32 and bf16
inputs, so the f32 rate bounds their arithmetic at either input dtype,
and ``__dp4a`` for int8 (both non-wgmma bodies priced at its rate, so
the skinny body moves no route or resolved S). Block sizes are fixed
per tile shape inside the kernels, so the only parameter chosen here is
the split factor S.

Under ``GemmPolicy(quant="int8")`` the choosers price int8 operands, as
the JAX package resolves under the int8 effective dtype (``ops.py:303``):
1 byte an element, and the rate of the int8 body that runs (TSM2R's
``__dp4a`` or its int8 wgmma, TSMT's packed ``__dp4a`` body or its int32
multiply-add, ``tsmt_q8_body``; pricing the packed body moves no resolved
S at PowerSGD's shapes). The TSMT slice
quantum is then the scale band ``Q8_BAND``, so no band straddles two
slices.

The launch rules (each body's preconditions, its shared memory against
the card's limits, the grid) live in ``analysis/contracts.py``: the body
choices below are its predicates, every grid is its ``launch_grid``, and
the choosers score only the S candidates its ``feasible`` accepts.
``kernel_params`` states a launch in the contracts' terms.

The paper's bound classifier (section 3.1.8: memory, compute or latency
bound) is ``classify``, over this card's ridges. The dispatch thresholds
stay the JAX package's (``core/tsmm.py``); re-deriving them from H100
measurements is later work.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.analysis import contracts
from repro_torch.kernels.ref import split_len


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    """Hardware constants of one card (NVIDIA's H100 SXM data sheet)."""

    name: str = "h100"
    n_sms: int = 132
    hbm_bw: float = 3.35e12
    peak_flops_bf16: float = 989e12     # dense tensor cores
    peak_flops_f32: float = 67e12       # CUDA cores, no tensor cores
    # The int8 kernels' CUDA-core rates: 64 int32 lanes an SM a clock (half
    # the f32 FMA lanes) at the f32 figure's clock; __dp4a does 4 products
    # an instruction (TSM2R, TSM2L, TSMT's packed body), a plain
    # multiply-add one (TSMT's simt body).
    peak_ops_dp4a: float = 134e12
    peak_ops_imad: float = 33.5e12
    peak_ops_int8: float = 1979e12     # dense tensor cores, s8 x s8 -> s32
    launch_s: float = 4e-6              # one extra kernel launch

    def peak_flops(self, dtype) -> float:
        """Peak rate of ``dtype``'s multiply-adds: the tensor cores' for
        bf16 and int8, the CUDA cores' for f32."""
        if dtype == torch.int8:
            return self.peak_ops_int8
        return (self.peak_flops_bf16 if dtype == torch.bfloat16
                else self.peak_flops_f32)


H100 = GPUSpec()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_spec(spec: GPUSpec, device: torch.device) -> GPUSpec:
    """``spec`` with the SM count of ``device`` when it is a card; CPU
    tensors (the tests) keep the spec as it is."""
    if device.type != "cuda":
        return spec
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    n = _sm_count(index)
    return spec if n == spec.n_sms else dataclasses.replace(spec, n_sms=n)


# ---------------------------------------------------------------------------
# Tile tables (mirrors of csrc/common.cuh) and launch grids
# ---------------------------------------------------------------------------

# Reduction quantum of each split kernel: a slice owns a whole number of
# these (tsm2r: the BK-deep k tile of both tile shapes; tsmt: 8 rows, the
# JAX package's f32 sublane, so both packages cut m alike).
TSM2R_BLOCK_K = 32
TSMT_BLOCK_M = 8
# Rows of the tall operand that share one int8 scale, in every int8
# kernel: the JAX ``quantize_param`` default and a multiple of the JAX
# int8 32-row tile quantum. The JAX kernels' band is their resolved
# block_m; the port's tiles differ, so it passes this band explicitly.
Q8_BAND = 256


# The sequential TSM2R's tensor-core bodies (``csrc/tsm2r_wgmma.cuh`` for
# bf16, ``csrc/tsm2r_q8_wgmma.cuh`` for int8): their one output tile, and
# the widest output that stays on the CUDA cores.
TSM2R_WGMMA_TILE = (64, 128)
WGMMA_MIN_WIDTH = contracts.WGMMA_MIN_WIDTH
# TSM2R's streaming body for outputs at most 16 wide
# (``csrc/tsm2r_skinny.cuh``): f32, bf16 and int8 (tsm2r_q8), sequential
# and split. Its blocks own 128 rows, the simt table's tile at n <= 16, so
# the grid does not depend on which of the two runs.
SKINNY_MAX_WIDTH = contracts.SKINNY_MAX_WIDTH


def skinny_fits(k: int, n: int, dtype, ptr_a: int = 0,
                splits: int = 1) -> bool:
    """Whether a TSM2R launch (f32, bf16, or int8 through tsm2r_q8 and
    tsm2r_q8_split) takes the skinny body (``skinny::fits``): n in 1..16,
    k > 0, A's rows and each slice whole 16-byte chunks (TMA's strides; k
    a multiple of 16 at int8's 1 byte an element), A's base ``ptr_a``
    16-byte aligned. A split launch's slice is ``split_len(k, splits,
    TSM2R_BLOCK_K)``, the sequential kernel's is k
    (``contracts.skinny_fits``)."""
    return contracts.skinny_fits(k, n, dtype, ptr_a,
                                 tsm2r_slice(k, splits))


def tsm2r_slice(k: int, splits: int) -> int:
    """The k values a TSM2R launch's slice holds: k for the sequential
    kernel, else ``split_len(k, S, TSM2R_BLOCK_K)``."""
    return k if splits == 1 else split_len(k, splits, TSM2R_BLOCK_K)


def tsm2r_body(k: int, n: int, dtype, ptr_a: int = 0, ptr_b: int = 0,
               splits: int = 1) -> str:
    """The body a TSM2R launch runs. "skinny" for f32, bf16 and int8
    launches, sequential or split, that ``skinny_fits`` (int8 at n <= 16
    with k a multiple of 16 and an aligned A). "wgmma" for the sequential
    kernel (S = 1) with n > 16, k > 0 and 16-byte aligned base addresses
    ``ptr_a``/``ptr_b``, where TMA's 16-byte global strides hold: for bf16
    (``wgmma::fits``) k and n multiples of 8; for int8 (tsm2r_q8,
    ``wgmma_s8::fits``, whose B is read K-major, so ``ptr_b`` is the
    K-major B's address and n needs no multiple) k a multiple of 16. Else
    "simt": f32 past n = 16, split launches past n = 16, and whatever
    misses the skinny body's chunks or alignment."""
    if skinny_fits(k, n, dtype, ptr_a, splits):
        return "skinny"
    if contracts.wgmma_fits(k, n, dtype, ptr_a, ptr_b, splits):
        return "wgmma"
    return "simt"


def tsm2r_tile(n: int, body: str = "simt") -> tuple[int, int]:
    """(BM, BN) of TSM2R at output width n: the wgmma body's one tile, or
    the simt table (``with_tsm2r_tile``), whose n <= 16 tile the skinny
    body shares."""
    if body == "wgmma":
        return TSM2R_WGMMA_TILE
    return (128, 16) if n <= 16 else (64, 64)


def tsmt_tile(b: int) -> tuple[int, int]:
    """(BA, BB) of TSMT at output width b (``with_tsmt_tile``)."""
    if b <= 4:
        return (128, 4)
    if b <= 16:
        return (64, 16)
    return (64, 64)


def tsm2r_grid(m: int, k: int, n: int, splits: int = 1,
               dtype=torch.float32, ptr_a: int = 0, ptr_b: int = 0) -> tuple:
    """The launch grid of TSM2R (S = 1) or its split kernel, for the body
    that ``tsm2r_body`` gives these operands."""
    return contracts.launch_grid("tsm2r", (m, k, n), kernel_params(
        "tsm2r", m, k, n, dtype, splits, ptrs=(ptr_a, ptr_b)))


def tsm2r_plan(m: int, k: int, n: int, dtype, ptr_a: int = 0,
               ptr_b: int = 0, splits: int = 1) -> tuple[str, tuple]:
    """(body, grid) of the sequential TSM2R (``splits`` 1) or its split
    kernel: the mirror of the C queries ``tsm2r_plan`` (f32, bf16),
    ``tsm2r_q8_plan`` (int8), ``tsm2r_split_plan`` (f32, bf16) and
    ``tsm2r_q8_split_plan`` (int8), the split ones at S slices of
    ``split_len(k, S, TSM2R_BLOCK_K)`` (``kernels/_build.plan``,
    ``kernels/_build.split_plan``)."""
    return (tsm2r_body(k, n, dtype, ptr_a, ptr_b, splits),
            tsm2r_grid(m, k, n, splits, dtype, ptr_a, ptr_b))


# ---------------------------------------------------------------------------
# TSM2L: the stream body (csrc/tsm2l_stream.cuh) and the tile body
# (csrc/common.cuh's tsm2l_kernel), for tsm2l and tsm2l_q8 alike
# ---------------------------------------------------------------------------

# The stream body takes n in 1..16, k in 1..256 (every k the classifier
# routes to TSM2L at its default ``max_skinny``) and a 16-byte aligned A.
TSM2L_STREAM_MAX_WIDTH = contracts.STREAM_MAX_WIDTH
TSM2L_STREAM_MAX_K = contracts.STREAM_MAX_K
# Its constants (``stream::`` in the header): consumer threads a block, the
# bulk copies a stage of A is cut into, the bytes of A a stage aims at,
# the dynamic shared memory a block may take (two blocks an SM), the
# deepest ring, the rows a thread of A's rows of 33 to 256 bytes (the
# paper's tcf; 4 below, 1 above) and blocks an SM.
STREAM_CONSUMERS = 128
STREAM_PIECES = 8
STREAM_STAGE_BYTES = 16384
STREAM_SMEM_BYTES = 110 * 1024
STREAM_MAX_STAGES = 6
STREAM_ROWS_DEFAULT = 2
STREAM_BLOCKS_PER_SM = 2
_STREAM_SIZES = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}


def tsm2l_body(k: int, n: int, dtype, ptr_a: int = 0) -> str:
    """The body a tsm2l (f32, bf16) or tsm2l_q8 (int8) launch runs:
    "stream" for n in 1..16 and k in 1..256 with A's base ``ptr_a``
    16-byte aligned (``stream::fits``, ``contracts.stream_fits``), else
    "tile"."""
    return "stream" if contracts.stream_fits(k, n, dtype, ptr_a) else "tile"


def _up16(x: int) -> int:
    return -(-x // 16) * 16


def _odd16(x: int) -> int:
    """x rounded up to 16 bytes, then to an odd number of 16-byte units."""
    x = _up16(x)
    return x if (x // 16) % 2 else x + 16


def tsm2l_stream_geometry(k: int, n: int, dtype, out_dtype=None,
                          rows: int | None = None) -> dict:
    """The stream body's launch at k, n (``stream::plan``): ``rows`` a
    thread (default: 4 for rows of A of at most 32 bytes, 2 of at most
    256, else 1), ``groups`` of
    threads splitting each row's k (the fewest of 1, 2, 4 that keep a
    stage within ``STREAM_STAGE_BYTES``, halving until an eighth of a
    tile is whole 16-byte units), ``block_m`` = 128 / groups x rows rows
    a tile, ``stages`` of the ring (as many as fit ``STREAM_SMEM_BYTES``
    beside the output tile, B and the groups' partials, 2 to 6), ``vec`` (rows of A whole 16-byte chunks, read 16
    bytes at a time; else one 32-bit word at a time) and ``smem``, the
    dynamic shared memory a block. ``out_dtype`` is what the kernel
    writes (default: A's dtype, f32 for int8)."""
    size = _STREAM_SIZES[dtype]
    out_dtype = out_dtype or (torch.float32 if dtype == torch.int8
                              else dtype)
    usize = out_dtype.itemsize
    rs = k * size
    vec = rs % 16 == 0
    units = rs // 16 if vec else -(-rs // 4)
    kp = units * (16 if vec else 4) // size
    r = rows or (4 if rs <= 32 else STREAM_ROWS_DEFAULT if rs <= 256 else 1)
    g = next((g for g in (1, 2, 4)
              if STREAM_CONSUMERS // g * r * rs <= STREAM_STAGE_BYTES), 4)
    while g > 1 and (g > units
                     or STREAM_CONSUMERS // g * r // STREAM_PIECES * rs % 16):
        g //= 2
    bm = STREAM_CONSUMERS // g * r
    bmp = bm // STREAM_PIECES
    stage = STREAM_PIECES * _odd16(bmp * rs)
    nw = 1 << max(0, (n - 1).bit_length())
    b_bytes = _up16(kp * nw * 4 if size > 1 else -(-kp // 4) * nw * 4)
    cb = n * usize
    c_bytes = (STREAM_PIECES * _odd16(bmp * cb) if bmp * cb % 16 == 0
               else _up16(bm * cb))
    fixed = c_bytes + b_bytes + (g - 1) * bm * nw * 4 + 128 + 16
    stages = max(2, min(STREAM_MAX_STAGES,
                        (STREAM_SMEM_BYTES - fixed) // stage))
    return {"rows": r, "groups": g, "block_m": bm, "stages": stages,
            "vec": vec, "smem": stages * stage + fixed}


def tsm2l_tile(n: int) -> tuple[int, int]:
    """(BM, BN) of TSM2L's tile body at output width n
    (``tsm2l_dispatch``)."""
    if n <= 4:
        return (512, 4)
    if n <= 16:
        return (256, 16)
    return (64, 64)


def tsm2l_plan(m: int, k: int, n: int, dtype, ptr_a: int = 0,
               spec: GPUSpec = H100, out_dtype=None) -> tuple[str, tuple]:
    """(body, grid) of a tsm2l or tsm2l_q8 call (``dtype`` the input's,
    ``out_dtype`` what the kernel writes): the mirror of the C queries
    ``tsm2l_plan`` and ``tsm2l_q8_plan`` (``kernels/_build.tsm2l_plan``).
    The stream body's grid is its persistent blocks, ``STREAM_BLOCKS_PER_SM``
    an SM or one a row tile if fewer; the tile body's is its table's row
    and column tiles (the launch runs at most the blocks resident on the
    card over the row tiles, by the card's occupancy query)."""
    p = kernel_params("tsm2l", m, k, n, dtype, 1, spec, ptrs=(ptr_a, 0),
                      out_dtype=out_dtype)
    return p["body"], contracts.launch_grid("tsm2l", (m, k, n), p)


def tsmt_grid(m: int, a: int, b: int, splits: int = 1) -> tuple:
    """(a-tiles, b-tiles, ``splits``) of TSMT: the split kernel's grid at
    S = ``splits``, or the one-launch kernel's at its plan's S."""
    return contracts.launch_grid("tsmt", (m, a, b),
                                 {"tile": tsmt_tile(b), "slices": splits})


# Output widths at which the int8 TSMT kernels (tsmt_q8 and tsmt_q8_split
# alike) run their packed body (``csrc/tsmt_q8_packed.cuh``): each row of
# Y whole 32-bit words, within the b <= 16 tiles.
TSMT_Q8_PACKED_WIDTHS = contracts.PACKED_WIDTHS


def tsmt_q8_body(a: int, b: int, ptr_x: int = 0, ptr_y: int = 0) -> str:
    """The body an int8 TSMT launch runs, at any m and S (``packed::fits``):
    "packed" for b in ``TSMT_Q8_PACKED_WIDTHS`` with a a multiple of 16
    and X's and Y's bases ``ptr_x``/``ptr_y`` 16-byte aligned, else
    "simt"."""
    return "packed" if contracts.packed_fits(a, b, ptr_x, ptr_y) else "simt"


def tsmt_q8_plan(m: int, a: int, b: int, ptr_x: int = 0,
                 ptr_y: int = 0) -> tuple[str, tuple]:
    """(body, (a-tiles, b-tiles)) of a tsmt_q8 or tsmt_q8_split call: the
    mirror of the C queries ``tsmt_q8_plan`` and ``tsmt_q8_split_plan``
    (``kernels/_build.tsmt_q8_plan``)."""
    return tsmt_q8_body(a, b, ptr_x, ptr_y), tsmt_grid(m, a, b)[:2]


# The sequential TSMT kernel spreads m over S slices in one launch
# (``csrc/common.cuh`` tsmt_slices_run), planned by ``tsmt_slices``.
# Blocks per SM its grid aims for: tiles x S ~ this x n_sms. Two is what
# fits (85-128 registers x 256 threads a block), and on the card it beat
# one and four blocks per SM at [2^20,128]^T [2^20,4] in f32 and int8
# (PERF.md §6, the tsmt sweep).
TSMT_BLOCKS_PER_SM = 2
# Rows a slice keeps at least: past S ~ 128 slices of one tile, the last
# block's ordered sum of the S partials outgrows what more blocks save
# (at [65536,128]^T [65536,4], 512-row slices ran 10% faster than 256-row
# ones in f32 and 23% in int8; PERF.md §6, the tsmt sweep).
TSMT_MIN_SLICE_ROWS = 512


def tsmt_slices(m: int, a: int, b: int, spec: GPUSpec = H100,
                dtype=torch.float32, *,
                quantum: int | None = None) -> tuple[int, int]:
    """(S, slice) of the sequential TSMT kernel at X[m,a]^T Y[m,b]: S
    slices of ``slice`` rows (``ref.split_len``, the split kernels' own
    convention; none empty), so that the output tiles x S stay within
    ``TSMT_BLOCKS_PER_SM`` x ``spec.n_sms`` blocks, every slice keeps at
    least ``TSMT_MIN_SLICE_ROWS`` rows, and slices are whole ``quantum``s
    (default ``tsmt_block_m(dtype)``: 8 rows, or whole scale bands for
    int8). S = 1 (a direct store, no workspace) when the tiles alone fill
    the card or m is short."""
    q = quantum or tsmt_block_m(dtype)
    ga, gb, _ = tsmt_grid(m, a, b)
    s = max(1, TSMT_BLOCKS_PER_SM * spec.n_sms // (ga * gb))
    s = max(1, min(s, m // TSMT_MIN_SLICE_ROWS, max_splits(m, q)))
    # Whole-quantum slices may cover m in fewer than S: drop the empty ones.
    s = max(1, -(-m // split_len(m, s, q)))
    return s, split_len(m, s, q)


# ---------------------------------------------------------------------------
# Shared memory of each body, and a launch in the contracts' terms
# ---------------------------------------------------------------------------

# The wgmma bodies' ring (``tsm2r_wgmma.cuh``, ``tsm2r_q8_wgmma.cuh``): 4
# stages of a 64-row A tile and a 128-column B tile, 24 KB either way (bf16
# 64 k values a stage, int8 128), and 1 KB of alignment slack.
WGMMA_STAGES = 4
WGMMA_STAGE_BYTES = 24576
# The skinny body's ring (``tsm2r_skinny.cuh``): a stage is 128 rows x 128
# bytes of A and its k values' staged B (4 bytes a value and column at
# f32 and bf16, a byte at int8); its default is 3 stages and 2 k groups,
# whose partial tiles reuse the ring after the last stage.
SKINNY_STAGES = 3
SKINNY_GROUPS = 2
SKINNY_A_BYTES = 128 * 128
_SKINNY_STAGE_K = {torch.float32: 32, torch.bfloat16: 64, torch.int8: 128}
# The static partials of TSMT's simt tile (``common.cuh``: "a 16 KB
# partials buffer in every shape") and of the packed int8 body.
TSMT_SIMT_SMEM = 16384
TSMT_PACKED_SMEM = 32768
# TSM2L's tile body: k values of B resident a chunk at each tile width
# (``with_tsm2l_tile``'s KC).
_TSM2L_TILE_KC = {4: 32, 16: 64, 64: 256}


def _width(n: int) -> int:
    """The template width that holds n outputs (``with_width``)."""
    return 1 << max(0, (n - 1).bit_length())


def body_smem(kind: str, body: str, k: int, n: int, dtype,
              out_dtype=None) -> int:
    """Bytes of shared memory (dynamic and static) one block of ``kind``'s
    ``body`` takes at k (tsmt: a), n (tsmt: b) for ``dtype`` operands:
    the mirror of each launcher's size."""
    if body == "wgmma":
        return WGMMA_STAGES * WGMMA_STAGE_BYTES + 1024
    if body == "skinny":
        nw = _width(n)
        stage_b = 1 if dtype == torch.int8 else 4
        ring = SKINNY_STAGES * (SKINNY_A_BYTES
                                + _SKINNY_STAGE_K[dtype] * nw * stage_b)
        return max(ring, SKINNY_GROUPS * 128 * nw * 4) + 1024
    if body == "stream":
        return tsm2l_stream_geometry(k, n, dtype, out_dtype)["smem"]
    if body == "packed":
        return TSMT_PACKED_SMEM
    if kind == "tsmt":
        return TSMT_SIMT_SMEM
    pack = 4 if dtype == torch.int8 else 1       # k values a 4-byte word
    if kind == "tsm2l":
        bm, bn = tsm2l_tile(n)
        kw = -(-min(k, _TSM2L_TILE_KC[bn]) // pack)
        return 4 * (kw * bn + bm * (kw + 1))
    bm, bn = tsm2r_tile(n, body)                 # tsm2r's simt tile
    kw = TSM2R_BLOCK_K // pack
    return 4 * (bm * (kw + 1) + kw * bn)


def kernel_params(kind: str, m: int, d1: int, d2: int, dtype,
                  splits: int = 1, spec: GPUSpec = H100, *,
                  ptrs: tuple[int, int] = (0, 0),
                  out_dtype=None) -> dict:
    """The launch of ``kind`` (``dtype`` int8 for its int8 kernel) at
    (m, d1, d2) and S = ``splits``, in the terms of
    ``analysis/contracts.py``: the split resolution's ``splits`` and
    block, the plan's ``body``, ``tile``, ``smem``, ``blocks_per_sm``
    (the residency each body is built for), the slices of the reduction,
    ``ptrs`` (the operands' base addresses; fresh allocations are
    aligned), and under int8 the scale ``band`` (and for tsm2r whether B
    is quantized K-major, as ``kernels/ops.py`` does for the wgmma body).
    ``contracts.launch_grid`` of it is the grid the launch runs."""
    pa, pb = ptrs
    q8 = dtype == torch.int8
    if kind == "tsm2r":
        body = tsm2r_body(d1, d2, dtype, pa, pb, splits)
        p = {"splits": splits, "block_k": TSM2R_BLOCK_K,
             "slice": tsm2r_slice(d1, splits), "body": body,
             "tile": tsm2r_tile(d2, body), "ptrs": {"a": pa, "b": pb}}
        if q8:
            p.update(b_kmajor=body == "wgmma", band=Q8_BAND)
    elif kind == "tsm2l":
        body = tsm2l_body(d1, d2, dtype, pa)
        p = {"body": body, "ptrs": {"a": pa},
             "max_blocks": STREAM_BLOCKS_PER_SM * spec.n_sms,
             "tile": (tsm2l_stream_geometry(d1, d2, dtype,
                                            out_dtype)["block_m"], d2)
                     if body == "stream" else tsm2l_tile(d2),
             "blocks_per_sm": STREAM_BLOCKS_PER_SM if body == "stream"
             else 1}
        if q8:
            p["band"] = Q8_BAND
        if out_dtype is not None:
            p["out_dtype"] = out_dtype
    elif kind == "tsmt":
        q = tsmt_block_m(dtype)
        slices, slice_ = (tsmt_slices(m, d1, d2, spec, dtype) if splits == 1
                          else (splits, split_len(m, splits, q)))
        body = tsmt_q8_body(d1, d2, pa, pb) if q8 else "simt"
        p = {"splits": splits, "block_m": q, "slices": slices,
             "slice": slice_, "body": body, "tile": tsmt_tile(d2),
             "blocks_per_sm": TSMT_BLOCKS_PER_SM, "ptrs": {"x": pa, "y": pb}}
        if q8:
            p["band"] = Q8_BAND
    else:
        raise ValueError(f"unknown kernel kind {kind!r}: valid kinds are "
                         f"{', '.join(contracts.KINDS)}")
    p["smem"] = body_smem(kind, p["body"], d1, d2, dtype, out_dtype)
    return p


# ---------------------------------------------------------------------------
# Modelled times
# ---------------------------------------------------------------------------

def occupancy(blocks: int, spec: GPUSpec = H100) -> float:
    """Share of the SMs a grid of ``blocks`` keeps busy:
    ``min(n_sms, blocks) / n_sms``. Splitting the reduction multiplies the
    blocks by S at the cost of the partials' round trip."""
    return min(spec.n_sms, max(blocks, 1)) / spec.n_sms


def split_partials_bytes(splits: int, rows: int, cols: int) -> int:
    """Extra device-memory traffic of an S-way split: the (S, rows, cols)
    f32 partials are written once and read once by the epilogue (S = 1
    writes the output directly)."""
    if splits <= 1:
        return 0
    return 2 * splits * rows * cols * 4


# Below this many f32 partial elements the split epilogue is a plain sum,
# above it the sum_partials kernel (the JAX package's threshold: 1 MiB of
# partials covers every skinny-output case).
JNP_REDUCE_MAX_ELEMS = 1 << 18


def reduce_kernel_runs(splits: int, rows: int, cols: int) -> bool:
    """Whether the epilogue of an S-way split launches the sum_partials
    kernel (``kernels/reduce.py`` runs it exactly then)."""
    return splits > 1 and splits * rows * cols > JNP_REDUCE_MAX_ELEMS


# The sum_partials kernel's launch (``csrc/reduce.cu``): threads a block,
# the most blocks an SM before its grid-stride loop, and the slices whose
# loads are all issued before their adds.
REDUCE_THREADS = 128
REDUCE_BLOCKS_PER_SM = 8
REDUCE_CHUNK = 8


def reduce_vector_width(n: int, ptr_p: int = 0, ptr_c: int = 0,
                        out_size: int = 4) -> int:
    """Outputs a sum_partials thread owns: the widest of 4, 2 and 1 that
    divides the ``n`` = rows * cols outputs (so every slab of the stack
    starts on a vector) and to whose vectors the partials at ``ptr_p``
    (f32) and the output at ``ptr_c`` (``out_size`` bytes an element) are
    aligned."""
    return next((w for w in (4, 2) if n % w == 0 and ptr_p % (4 * w) == 0
                 and ptr_c % (out_size * w) == 0), 1)


def reduce_plan(s: int, rows: int, cols: int, out_dtype, ptr_p: int = 0,
                ptr_c: int = 0, spec: GPUSpec = H100) -> tuple:
    """(grid, threads a block, vector width, slices a chunk) of a
    sum_partials launch on an ``(s, rows, cols)`` stack writing
    ``out_dtype``: the mirror of the C query ``reduce_plan``
    (``kernels/_build.reduce_plan``). One vector a thread, at most
    ``REDUCE_BLOCKS_PER_SM`` blocks an SM (the kernel strides past that);
    the grid does not depend on S."""
    n = rows * cols
    vec = reduce_vector_width(n, ptr_p, ptr_c, out_dtype.itemsize)
    grid = contracts.launch_grid(
        "reduce", (s, rows, cols),
        {"vec": vec, "threads": REDUCE_THREADS,
         "max_blocks": REDUCE_BLOCKS_PER_SM * spec.n_sms})
    return grid, REDUCE_THREADS, vec, REDUCE_CHUNK


# The int8 quantize pass's launches (``csrc/quantize.cu``): elements a
# block of the absmax and codes launches (a chunk never straddles a band),
# and the side of the K-major codes' tiles; tsm2r_q8's int8 layout copy
# (``csrc/tsm2r_q8.cu``) tiles by the same side.
QUANT_CHUNK = 8192
QUANT_TILE = 64


def quantize_plan(rows: int, cols: int, band: int,
                  kmajor: bool = False) -> dict:
    """The quantize pass's launches over a [rows, cols] operand in
    ``band``-row bands: the mirror of ``quantize.cu``'s ``run_v``.
    ``bands``, ``chunks`` (blocks a band), ``band_elems`` and ``total``
    (elements), the grid of the absmax launch and of the codes launch
    (the same (band, chunk) blocks, or with ``kmajor`` the [cols, rows]
    tiles of ``QUANT_TILE``)."""
    band_elems, total = band * cols, rows * cols
    chunks = -(-band_elems // QUANT_CHUNK)
    bands = -(-rows // band)
    flat = (bands * chunks, 1, 1)
    tiled = (-(-cols // QUANT_TILE), -(-rows // QUANT_TILE), 1)
    return {"bands": bands, "chunks": chunks, "band_elems": band_elems,
            "total": total, "chunk": QUANT_CHUNK, "tile": QUANT_TILE,
            "absmax_grid": flat, "codes_grid": tiled if kmajor else flat}


def transpose_q8_grid(rows: int, cols: int) -> tuple:
    """The grid of tsm2r_q8's int8 [rows, cols] -> [cols, rows] copy: one
    block a ``QUANT_TILE`` x ``QUANT_TILE`` tile, x over cols."""
    return (-(-cols // QUANT_TILE), -(-rows // QUANT_TILE), 1)


def tsm2r_model_bytes(m: int, k: int, n: int, dtype=torch.float32, *,
                      splits: int = 1) -> int:
    """The device-memory bytes ``tsm2r_model_time`` prices: A once per
    column tile, B once per row tile, the output once and the partials'
    round trip (``split_partials_bytes``)."""
    b = dtype.itemsize
    gm, gn, _ = tsm2r_grid(m, k, n, splits, dtype)
    return (m * k * b * gn + k * n * b * gm + m * n * b
            + split_partials_bytes(splits, m, n))


def tsm2r_model_time(m: int, k: int, n: int, spec: GPUSpec = H100,
                     dtype=torch.float32, *, splits: int = 1) -> float:
    """Modelled seconds of TSM2R (S = 1) or its split variant: A streamed
    once per column tile, B once per row tile, the output and the
    partials' round trip, over the bandwidth of the busy SMs' share;
    multiply-adds on the same share at the rate of the body that runs
    (``tsm2r_body``: for "wgmma" the bf16 or int8 tensor-core rate, for
    "skinny" and "simt" the f32 rate, ``__dp4a``'s at int8, both bodies
    alike); one launch
    per kernel."""
    wide = tsm2r_body(k, n, dtype, splits=splits) == "wgmma"
    if dtype == torch.int8:
        rate = spec.peak_ops_int8 if wide else spec.peak_ops_dp4a
    elif wide:
        rate = spec.peak_flops_bf16
    else:
        rate = spec.peak_flops_f32
    gm, gn, _ = tsm2r_grid(m, k, n, splits, dtype)
    nbytes = tsm2r_model_bytes(m, k, n, dtype, splits=splits)
    occ = occupancy(gm * gn * splits, spec)
    t_mem = nbytes / (spec.hbm_bw * occ)
    t_comp = 2.0 * m * k * n / (rate * occ)
    launches = 1 + reduce_kernel_runs(splits, m, n)
    return max(t_mem, t_comp) + launches * spec.launch_s


def tsm2l_model_bytes(m: int, k: int, n: int, dtype=torch.float32) -> int:
    """The bytes ``tsm2l_model_time`` prices: A and B read once, the output
    (f32 from int8) written once."""
    b = dtype.itemsize
    out = 4 if dtype == torch.int8 else b
    return m * k * b + k * n * b + m * n * out


def tsm2l_model_time(m: int, k: int, n: int, spec: GPUSpec = H100,
                     dtype=torch.float32) -> float:
    """Modelled seconds of TSM2L (its one launch; no split): A read once,
    B (tiny) once, the output written once, over the bandwidth of the busy
    SMs' share, the grid of the body that ``tsm2l_body`` picks (the stream
    body's persistent blocks, at most ``STREAM_BLOCKS_PER_SM`` an SM; the
    tile body's row and column tiles); FMAs on the same share at the f32
    rate (``__dp4a``'s at int8, whose kernel writes f32); one launch."""
    rate = spec.peak_ops_dp4a if dtype == torch.int8 else spec.peak_flops_f32
    p = kernel_params("tsm2l", m, k, n, dtype, 1, spec)
    gm, gn, _ = contracts.launch_grid("tsm2l", (m, k, n), p)
    occ = occupancy(gm * gn, spec)
    t_mem = tsm2l_model_bytes(m, k, n, dtype) / (spec.hbm_bw * occ)
    t_comp = 2.0 * m * k * n / (rate * occ)
    return max(t_mem, t_comp) + spec.launch_s


def tsmt_model_bytes(m: int, a: int, bdim: int, spec: GPUSpec = H100,
                     dtype=torch.float32, *, splits: int = 1) -> int:
    """The bytes ``tsmt_model_time`` prices: X once per column tile, Y once
    per row tile, the output once and the partials' round trip, over the
    one-launch kernel's plan of slices at S = 1."""
    b = dtype.itemsize
    slices = tsmt_slices(m, a, bdim, spec, dtype)[0] if splits == 1 \
        else splits
    ga, gb, _ = tsmt_grid(m, a, bdim, slices)
    return (m * a * b * gb + m * bdim * b * ga + a * bdim * b
            + split_partials_bytes(slices, a, bdim))


def tsmt_model_time(m: int, a: int, bdim: int, spec: GPUSpec = H100,
                    dtype=torch.float32, *, splits: int = 1) -> float:
    """Modelled seconds of TSMT (S = 1) or its split variant: X once per
    column tile, Y once per row tile, the output and the partials' round
    trip, over the bandwidth of the busy SMs' share; FMAs at the f32 rate
    (at int8 the rate of the body that runs, ``tsmt_q8_body`` at aligned
    operands: ``__dp4a``'s for "packed", one int32 multiply-add a product
    for "simt").

    S = 1 is priced as the one-launch kernel runs it: the plan of
    ``tsmt_slices`` (its tiles x slices counted against the SMs), its f32
    partials written and read inside the launch, and one launch, since
    each tile's last block sums the slices in order itself. S > 1 is the
    split kernel's S slices plus the epilogue op that sums its partials
    (``torch.sum`` or sum_partials): two launches. At equal slices the
    two move the same bytes, so S = 1 wins unless a split buys blocks
    the plan does not have (a short m, whose slices the plan keeps at
    ``TSMT_MIN_SLICE_ROWS`` or more)."""
    if dtype != torch.int8:
        rate = spec.peak_flops_f32
    elif tsmt_q8_body(a, bdim) == "packed":
        rate = spec.peak_ops_dp4a
    else:
        rate = spec.peak_ops_imad
    slices = tsmt_slices(m, a, bdim, spec, dtype)[0] if splits == 1 \
        else splits
    ga, gb, _ = tsmt_grid(m, a, bdim, slices)
    nbytes = tsmt_model_bytes(m, a, bdim, spec, dtype, splits=splits)
    occ = occupancy(ga * gb * slices, spec)
    t_mem = nbytes / (spec.hbm_bw * occ)
    t_comp = 2.0 * m * a * bdim / (rate * occ)
    launches = 1 if splits == 1 else 2
    return max(t_mem, t_comp) + launches * spec.launch_s


# ---------------------------------------------------------------------------
# The split choosers
# ---------------------------------------------------------------------------

# Powers of two up to 128 (``contracts.SPLIT_CANDIDATES``, which audits
# a tuning record's S against them).
SPLIT_CANDIDATES = contracts.SPLIT_CANDIDATES
# Splitting is offered only for the narrow tiles (output width <= 16).
# TSM2R: the split kernel's 64 x 64 tile ran no faster at S = 4 than the
# sequential kernel, and both wgmma bodies (n > 16) run only at S = 1, so
# wide outputs stay sequential. TSMT: the one-launch kernel spreads m over
# the card itself and is priced so (``tsmt_model_time``), which puts S = 1
# below every split wherever its plan fills the card; the cap still keeps
# wide outputs off the split TSMT's 64 x 64 tile, whose build issues the
# loads of a row one after another (about 3.8x slower a row), a cost the
# model does not price.
SPLIT_MAX_WIDTH = 16
_TIE_EPS = 1e-12


def max_splits(depth: int, block: int) -> int:
    """The most slices a reduction of ``depth`` admits if every slice is
    to own at least one ``block`` of it (the JAX package's clamp,
    ``ops.py:220,266``)."""
    return max(1, -(-depth // block))


def _argmin(scored) -> int:
    """Least modelled time; ties (within _TIE_EPS) go to the smaller S, so
    S = 1 wins unless a split is modelled strictly faster (the JAX rule,
    ``perf_model.py:371,404``)."""
    best = min(t for t, _ in scored)
    return min(s for t, s in scored if t <= best + _TIE_EPS)


def _candidates(kind, m, d1, d2, spec, dtype, cap) -> list[int]:
    """The S candidates up to ``cap`` whose launch the contracts accept
    (aligned operands, the data sheet's limits) and whose whole-block
    slices cover the reduction with none empty (``contracts.check_grid``:
    past that ``ops.resolve_params`` launches fewer slices than the model
    would have scored). Where none is, all are scored, and
    ``GemmPolicy.verify_contracts`` reports the launch."""
    cands = [s for s in SPLIT_CANDIDATES if s <= cap]

    def runs_as_scored(s):
        p = kernel_params(kind, m, d1, d2, dtype, s, spec)
        return (contracts.feasible(kind, (m, d1, d2), p, dtype)
                and not contracts.check_grid(kind, (m, d1, d2), p))
    return [s for s in cands if runs_as_scored(s)] or cands


def split_candidates(kind: str, m: int, d1: int, d2: int,
                     spec: GPUSpec = H100, dtype=torch.float32) -> list[int]:
    """The S the chooser of ``kind`` ("tsm2r" or "tsmt") scores at (m, d1,
    d2): ``_candidates`` up to its cap, one block of the reduction a slice
    for outputs at most ``SPLIT_MAX_WIDTH`` wide, else S = 1 alone (the
    grid ``autotune`` measures)."""
    if kind == "tsm2r":
        depth, block = d1, TSM2R_BLOCK_K
    else:
        depth, block = m, tsmt_block_m(dtype)
    cap = max_splits(depth, block) if d2 <= SPLIT_MAX_WIDTH else 1
    return _candidates(kind, m, d1, d2, spec, dtype, cap)


def choose_splits_tsm2r(m: int, k: int, n: int, spec: GPUSpec = H100,
                        dtype=torch.float32) -> int:
    return _argmin([(tsm2r_model_time(m, k, n, spec, dtype, splits=s), s)
                    for s in split_candidates("tsm2r", m, k, n, spec,
                                              dtype)])


def tsmt_block_m(dtype) -> int:
    """The TSMT slice quantum: the scale band for int8 operands."""
    return Q8_BAND if dtype == torch.int8 else TSMT_BLOCK_M


def choose_splits_tsmt(m: int, a: int, bdim: int, spec: GPUSpec = H100,
                       dtype=torch.float32) -> int:
    return _argmin([(tsmt_model_time(m, a, bdim, spec, dtype, splits=s), s)
                    for s in split_candidates("tsmt", m, a, bdim, spec,
                                              dtype)])


# ---------------------------------------------------------------------------
# The bound classifier (the paper's section 3.1.8)
# ---------------------------------------------------------------------------

# The latency test's two constants. A streaming body reads A through a
# ring of 128-byte rows of k (one TMA box row of the skinny body, eight
# 16-byte chunks of the stream body), 3 to 6 stages deep. To hide one
# device-memory round trip (~0.6 us) at its share of the bandwidth
# (3.35 TB/s over 132 SMs), an SM keeps ~15 KB of loads in flight, which
# those rings hold only when a block has more stages of work than ring
# slots. A reduction of at most LATENCY_ROW_BYTES (four such rows) ends
# before a block's ring is full; and with k at most LATENCY_K_PER_N times
# n (the m >> k ~ n regime, short of TSM2R's skinny ratio) each row's few
# loads feed n-wide multiply-adds at once. The time is then how many rows
# are in flight, not the bytes or the operations.
LATENCY_ROW_BYTES = 4 * 128
LATENCY_K_PER_N = 16


def t2_threshold(spec: GPUSpec = H100, dtype=torch.bfloat16) -> float:
    """The paper's boundary value of t2 (here: of n): below it a TSM2
    problem is memory-bound. On the H100 it is the ridge (peak rate over
    the memory rate) times the element's bytes: bf16 989 / 3.35 = 295
    flop/B, so ~590; f32 on the CUDA cores ~20 flop/B, so ~80; int8 ~591
    op/B at 1 byte, so ~591."""
    return spec.peak_flops(dtype) / spec.hbm_bw * dtype.itemsize


def arithmetic_intensity(m: int, k: int, n: int,
                         dtype=torch.bfloat16) -> float:
    """Operations per device-memory byte, each operand moved once."""
    flops = 2.0 * m * k * n
    return flops / ((m * k + k * n + m * n) * dtype.itemsize)


def classify(m: int, k: int, n: int, spec: GPUSpec = H100,
             dtype=torch.bfloat16) -> str:
    """The paper's three regimes of a tall-and-skinny ``[m,k]·[k,n]``:

    * "latency": k so shallow that a block cannot hide a memory round
      trip (k * size <= ``LATENCY_ROW_BYTES`` and k <= ``LATENCY_K_PER_N``
      * n; the TSM2L case, m >> k ~ n; derivation at the constants);
    * "memory": arithmetic intensity below the card's ridge for
      ``dtype`` (``spec.peak_flops(dtype) / spec.hbm_bw``): TSM2R's main
      case;
    * "compute": at or above the ridge.
    """
    if (k * dtype.itemsize <= LATENCY_ROW_BYTES
            and k <= LATENCY_K_PER_N * n):
        return "latency"
    ridge = spec.peak_flops(dtype) / spec.hbm_bw
    if arithmetic_intensity(m, k, n, dtype) < ridge:
        return "memory"
    return "compute"

