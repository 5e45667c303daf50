"""What the split-reduction chooser needs of a performance model, for the
H100.

Counterpart of the split half of ``src/repro/core/perf_model.py``
(``occupancy`` :151, ``split_partials_bytes`` :165, the modelled times
:184-270 and the choosers :352-404). The TPU model counted grid cells
against TensorCores; here blocks are counted against streaming
multiprocessors, from the port's own tile tables (``csrc/common.cuh``,
mirrored by ``tsm2r_tile``/``tsmt_tile`` below). The kernels run their
FMAs on the CUDA cores in f32, so the f32 rate bounds their arithmetic at
either input dtype. Block sizes are fixed per tile shape inside the
kernels, so the only parameter chosen here is the split factor S.

Under ``GemmPolicy(quant="int8")`` the choosers price int8 operands, as
the JAX package resolves under the int8 effective dtype (``ops.py:303``):
1 byte an element, and the int8 kernels' own instruction rate (TSM2R's
``__dp4a``, TSMT's int32 multiply-add). The TSMT slice quantum is then
the scale band ``Q8_BAND``, so no band straddles two slices.

The classifier thresholds stay the JAX package's (``core/tsmm.py``);
re-deriving them from H100 measurements is later work.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

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
    # an instruction (TSM2R, TSM2L), a plain multiply-add one (TSMT).
    peak_ops_dp4a: float = 134e12
    peak_ops_imad: float = 33.5e12
    launch_s: float = 4e-6              # one extra kernel launch

    def peak_flops(self, dtype) -> float:
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


def tsm2r_tile(n: int) -> tuple[int, int]:
    """(BM, BN) of TSM2R at output width n (``with_tsm2r_tile``)."""
    return (128, 16) if n <= 16 else (64, 64)


def tsmt_tile(b: int) -> tuple[int, int]:
    """(BA, BB) of TSMT at output width b (``with_tsmt_tile``)."""
    if b <= 4:
        return (128, 4)
    if b <= 16:
        return (64, 16)
    return (64, 64)


def tsm2r_grid(m: int, k: int, n: int, splits: int = 1) -> tuple:
    del k
    bm, bn = tsm2r_tile(n)
    return (-(-m // bm), -(-n // bn), splits)


def tsmt_grid(m: int, a: int, b: int, splits: int = 1) -> tuple:
    del m
    ba, bb = tsmt_tile(b)
    return (-(-a // ba), -(-b // bb), splits)


# The sequential TSMT kernel spreads m over S slices in one launch
# (``csrc/common.cuh`` tsmt_slices_block), planned by ``tsmt_slices``.
# Blocks per SM its grid aims for: tiles x S ~ this x n_sms. Two is what
# fits (86-119 registers x 256 threads a block), and on the card it beat
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


def tsm2r_model_time(m: int, k: int, n: int, spec: GPUSpec = H100,
                     dtype=torch.float32, *, splits: int = 1) -> float:
    """Modelled seconds of TSM2R (S = 1) or its split variant: A streamed
    once per column tile, B once per row tile, the output and the
    partials' round trip, over the bandwidth of the busy SMs' share;
    FMAs at the f32 rate (``__dp4a`` at int8) on the same share; one
    launch per kernel."""
    b = torch.empty((), dtype=dtype).element_size()
    rate = spec.peak_ops_dp4a if dtype == torch.int8 else spec.peak_flops_f32
    gm, gn, _ = tsm2r_grid(m, k, n, splits)
    nbytes = (m * k * b * gn + k * n * b * gm + m * n * b
              + split_partials_bytes(splits, m, n))
    occ = occupancy(gm * gn * splits, spec)
    t_mem = nbytes / (spec.hbm_bw * occ)
    t_comp = 2.0 * m * k * n / (rate * occ)
    launches = 1 + reduce_kernel_runs(splits, m, n)
    return max(t_mem, t_comp) + launches * spec.launch_s


def tsmt_model_time(m: int, a: int, bdim: int, spec: GPUSpec = H100,
                    dtype=torch.float32, *, splits: int = 1) -> float:
    """Modelled seconds of TSMT or its split variant: X once per column
    tile, Y once per row tile, the output and the partials' round trip;
    FMAs at the f32 rate (int32 multiply-adds at int8). S = 1 is priced
    as one block per output tile, which the sequential kernel no longer
    is: it spreads m over the card itself (``tsmt_slices``), so at
    PowerSGD and ABFT shapes (b <= 16) this model overprices S = 1."""
    b = torch.empty((), dtype=dtype).element_size()
    rate = spec.peak_ops_imad if dtype == torch.int8 else spec.peak_flops_f32
    ga, gb, _ = tsmt_grid(m, a, bdim, splits)
    nbytes = (m * a * b * gb + m * bdim * b * ga + a * bdim * b
              + split_partials_bytes(splits, a, bdim))
    occ = occupancy(ga * gb * splits, spec)
    t_mem = nbytes / (spec.hbm_bw * occ)
    t_comp = 2.0 * m * a * bdim / (rate * occ)
    launches = 1 + reduce_kernel_runs(splits, a, bdim)
    return max(t_mem, t_comp) + launches * spec.launch_s


# ---------------------------------------------------------------------------
# The split choosers
# ---------------------------------------------------------------------------

# Powers of two up to 128: a tsmt whose output is one tile needs about
# n_sms slices to occupy a 132-SM card (the JAX package's 1..16 was sized
# for a 2-core TPU).
SPLIT_CANDIDATES = (1, 2, 4, 8, 16, 32, 64, 128)
# Splitting is offered only for the narrow tiles (output width <= 16),
# where the card ran the split kernels faster than the sequential ones
# (PERF.md: tsmt 5.2x at b = 4, 22x at one tile). The split TSMT's 64 x 64
# tile runs each row about 3.8x slower than the sequential kernel (its
# build issues the loads of a row one after another), so a split of a wide
# output pays only past S ~ 4, and the split TSM2R's 64 x 64 tile ran no
# faster at S = 4; wider outputs stay sequential until that is fixed.
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


def choose_splits_tsm2r(m: int, k: int, n: int, spec: GPUSpec = H100,
                        dtype=torch.float32) -> int:
    cap = max_splits(k, TSM2R_BLOCK_K) if n <= SPLIT_MAX_WIDTH else 1
    return _argmin([(tsm2r_model_time(m, k, n, spec, dtype, splits=s), s)
                    for s in SPLIT_CANDIDATES if s <= cap])


def tsmt_block_m(dtype) -> int:
    """The TSMT slice quantum: the scale band for int8 operands."""
    return Q8_BAND if dtype == torch.int8 else TSMT_BLOCK_M


def choose_splits_tsmt(m: int, a: int, bdim: int, spec: GPUSpec = H100,
                       dtype=torch.float32) -> int:
    cap = (max_splits(m, tsmt_block_m(dtype)) if bdim <= SPLIT_MAX_WIDTH
           else 1)
    return _argmin([(tsmt_model_time(m, a, bdim, spec, dtype, splits=s), s)
                    for s in SPLIT_CANDIDATES if s <= cap])

