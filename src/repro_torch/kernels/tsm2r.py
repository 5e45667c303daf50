"""TSM2R wrapper: C[m,n] = A[m,k] @ B[k,n] with m ~ k >> n.

Replaces the TPU kernel ``src/repro/kernels/tsm2r.py::tsm2r_pallas`` with
the CUDA kernel in ``csrc/tsm2r.cu``, which runs one of three bodies,
chosen from the shape, dtype and alignment before the launch (``plan``;
mirrored by ``core/perf_model.py::tsm2r_plan``):

* "wgmma" (``csrc/tsm2r_wgmma.cuh``): bf16 with n > 16, k and n multiples
  of 8 and 16-byte aligned operands, such as chatglm3's wk/wv projections
  (n = 256). TMA loads swizzled tiles into a 4-stage shared-memory ring
  and one warpgroup multiplies them on the tensor cores into f32
  registers. Bound by the bytes of A plus B's re-reads from L2, one per
  64-row tile.
* "skinny" (``csrc/tsm2r_skinny.cuh``): f32 or bf16 with n <= 16, k * size
  a multiple of 16 bytes and a 16-byte aligned A, such as PowerSGD's P at
  n = 4 and the paper's n = 16. TMA streams 128-row boxes of A through a
  3-stage ring fed by two producer warps; each thread keeps all n outputs
  (rounded up to 1, 2, 4, 8 or 16) of its rows and reads B broadcast from
  shared memory; groups of threads split each stage's k and sum their
  tiles in a fixed order. Bound by the bytes of A.
* "simt" (``csrc/common.cuh``): every other call (f32 past n = 16; a
  ragged k such as 777 or a misaligned view, which TMA cannot take). It
  stages B and the next A tile through registers and shared memory (paper
  Algorithm 4) and runs its FMAs on the CUDA cores in f32: bound by the
  f32 FMA rate at wide n.

``tsm2r_split`` replaces ``tsm2r.py::tsm2r_pallas_split`` with
``csrc/tsm2r_split.cu``: a body over one of S contiguous k slices per grid
z index, writing (S, m, n) f32 partials, the body picked as for the
sequential kernel (``split_plan``: "skinny" where it fits, else "simt").
It is bound by the bytes of A plus the partials' round trip, and pays off
where the output tiles alone leave SMs idle (the paper's
[16384^2]·[16384,16] has 128 row tiles for 132 SMs); ``kernels/reduce.py``
sums the partials.

``tsm2r_q8`` replaces ``quant.py::tsm2r_q8_pallas`` with
``csrc/tsm2r_q8.cu``: int8 A (per-band scales) and B (one scale), exact
integer sums, sA[band of row] * sB folded into the stored tile, bound by
the bytes of A at 1 byte an element. Three bodies, chosen before the
launch (``q8_plan``; mirrored by ``perf_model.tsm2r_plan`` at int8):

* "wgmma" (``csrc/tsm2r_q8_wgmma.cuh``): n > 16, k a multiple of 16 and
  16-byte aligned operands, such as chatglm3's wk/wv at int8. TMA feeds
  the bf16 body's ring with 128-byte rows of A and of a K-major B, and
  ``wgmma.m64n128k32.s32.s8.s8`` sums on the tensor cores, folded into
  f32 every 131,072 k: bit-equal to the plain version up to that depth.
  It reads B K-major, a [k, n] tensor whose transpose is contiguous, as
  ``quant.quantize_tensor(b, kmajor=True)`` writes it; given a row-major
  B, the wrapper makes the K-major copy with the library's transpose
  kernel (``q8_transpose_launches``).
* "skinny" (``csrc/tsm2r_skinny.cuh``'s int8 stage): n <= 16 with k a
  multiple of 16 and a 16-byte aligned A, such as PowerSGD's P at n = 4,
  with a row-major B. The f32/bf16 skinny body's TMA ring at 128 int8 k
  values a box; the producer warps stage B as packed words (four k values
  of a column each) and every ``__dp4a`` does four exact products into
  int32 sums that fold into f32 only past 131,072 k: bit-equal to the
  plain version below that depth.
* "simt" (``csrc/common.cuh``): every other call (k % 16 != 0; a
  misaligned A; n > 16 where the wgmma body does not fit): four int8
  products a ``__dp4a`` into exact int32 tile sums. It and the skinny
  body read a row-major B (a K-major one is copied back the same way).

``tsm2r_q8_split`` replaces ``quant.py::tsm2r_q8_pallas_split`` with
``csrc/tsm2r_q8_split.cu``: the skinny or the simt int8 body over one of S
k slices (``q8_split_plan``: "skinny" where it fits, as for
``tsm2r_split``).

CPU tensors take the plain versions (``ref.tsm2r_ref``,
``ref.tsm2r_split_ref``, ``ref.tsm2r_q8_ref``, ``ref.tsm2r_q8_split_ref``);
CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _launch, ref

launches = 0         # tsm2r kernel launches; chip_smoke.py resets and reads
split_launches = 0   # tsm2r_split kernel launches, likewise
q8_launches = 0      # tsm2r_q8 kernel launches, likewise
q8_split_launches = 0   # tsm2r_q8_split kernel launches, likewise
q8_transpose_launches = 0   # tsm2r_q8's changes of B's layout, likewise


def tsm2r(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    global launches
    _launch.check("tsm2r", a, b, "mm")
    if a.device.type == "cpu":
        return ref.tsm2r_ref(a, b)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    _launch.launch("tsm2r", a.dtype, a, b, out, m, k, n)
    launches += 1
    return out


def plan(a: torch.Tensor, b: torch.Tensor) -> tuple[str, tuple]:
    """(body, grid) that ``tsm2r(a, b)`` launches for these CUDA operands,
    as the kernel's library decides them (``tsm2r_plan``)."""
    _launch.check("tsm2r", a, b, "mm")
    (m, k), n = a.shape, b.shape[1]
    return _build.plan(m, k, n, _launch._DTYPE_TAG[a.dtype], a.data_ptr(),
                       b.data_ptr())


def split_plan(a: torch.Tensor, b: torch.Tensor, splits: int,
               block_k: int) -> tuple[str, tuple]:
    """(body, grid) that ``tsm2r_split(a, b, splits, block_k)`` launches for
    these CUDA operands, as the kernel's library decides them
    (``tsm2r_split_plan``)."""
    _launch.check("tsm2r_split", a, b, "mm")
    (m, k), n = a.shape, b.shape[1]
    return _build.split_plan(m, k, n, splits, ref.split_len(k, splits,
                                                            block_k),
                             _launch._DTYPE_TAG[a.dtype], a.data_ptr())


def tsm2r_split(a: torch.Tensor, b: torch.Tensor, splits: int,
                block_k: int) -> torch.Tensor:
    """(S, m, n) f32 partials of A @ B over S contiguous k slices of
    ``ref.split_len(k, S, block_k)`` rows each."""
    global split_launches
    _launch.check("tsm2r_split", a, b, "mm")
    if a.device.type == "cpu":
        return ref.tsm2r_split_ref(a, b, splits, block_k)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    _launch.launch("tsm2r_split", a.dtype, a, b, out, m, k, n, splits,
                   ref.split_len(k, splits, block_k))
    split_launches += 1
    return out


def is_kmajor(b: torch.Tensor) -> bool:
    """Whether [k, n] ``b`` is laid out K-major (its transpose contiguous,
    itself not), the layout the int8 wgmma body reads."""
    return b.dim() == 2 and not b.is_contiguous() and b.t().is_contiguous()


def q8_plan(a: torch.Tensor, b: torch.Tensor) -> tuple[str, tuple]:
    """(body, grid) that ``tsm2r_q8(a, b, ...)`` launches for these CUDA
    operands, as the kernel's library decides them (``tsm2r_q8_plan``). A
    row-major B is planned at the address of the K-major copy the wrapper
    would make, which the allocator aligns (pointer 0 stands for it)."""
    (m, k), n = a.shape, b.shape[1]
    return _build.plan(m, k, n, "int8", a.data_ptr(),
                       b.data_ptr() if is_kmajor(b) else 0)


def q8_split_plan(a: torch.Tensor, b: torch.Tensor, splits: int,
                  block_k: int) -> tuple[str, tuple]:
    """(body, grid) that ``tsm2r_q8_split(a, b, ..., splits, block_k)``
    launches for these CUDA operands, as the kernel's library decides them
    (``tsm2r_q8_split_plan``)."""
    (m, k), n = a.shape, b.shape[1]
    return _build.split_plan(m, k, n, splits, ref.split_len(k, splits,
                                                            block_k),
                             "int8", a.data_ptr())


def q8_transpose(b: torch.Tensor) -> torch.Tensor:
    """The same int8 [k, n] matrix in the other layout (row-major <->
    K-major), copied by tsm2r_q8's transpose kernel."""
    global q8_transpose_launches
    src = b.t() if is_kmajor(b) else b           # contiguous [rows, cols]
    rows, cols = src.shape
    dst = torch.empty((cols, rows), dtype=torch.int8, device=b.device)
    if dst.numel():
        with torch.cuda.device(b.device):
            err = _build.transpose_q8(
                src.data_ptr(), dst.data_ptr(), rows, cols,
                torch.cuda.current_stream(b.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"tsm2r_q8_transpose launch failed: "
                               f"cudaError_t {err}")
        q8_transpose_launches += 1
    return dst if is_kmajor(b) else dst.t()


def tsm2r_q8(a: torch.Tensor, b: torch.Tensor, a_scale: torch.Tensor,
             b_scale: torch.Tensor, band: int, out_dtype) -> torch.Tensor:
    """C[m,n] = int32(A8 @ B8) * sA[row // band] * sB in ``out_dtype``:
    ``a``/``b`` int8, ``b`` row-major or K-major (``is_kmajor``),
    ``a_scale`` ceil(m / band) f32 band scales, ``b_scale`` one f32
    scale."""
    global q8_launches
    (m, k), n = a.shape, b.shape[1]
    _launch.check_q8("tsm2r_q8", a, b, a_scale, b_scale, -(-m // band), 1,
                     out_dtype, y_kmajor=is_kmajor(b))
    if a.device.type == "cpu":
        return ref.tsm2r_q8_ref(a, b, a_scale, b_scale, band, out_dtype)
    _launch.require_cuda("tsm2r_q8", a.device)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    wide = q8_plan(a, b)[0] == "wgmma"
    if wide != is_kmajor(b):         # the layout the planned body reads
        b = q8_transpose(b)
    _launch.launch("tsm2r_q8", out_dtype, a, b, a_scale, b_scale, out, m, k,
                   n, band, int(wide))
    q8_launches += 1
    return out


def tsm2r_q8_split(a: torch.Tensor, b: torch.Tensor, a_scale: torch.Tensor,
                   b_scale: torch.Tensor, band: int, splits: int,
                   block_k: int) -> torch.Tensor:
    """(S, m, n) f32 partials of ``tsm2r_q8`` over S contiguous k slices of
    ``ref.split_len(k, S, block_k)`` rows each, already scaled."""
    global q8_split_launches
    (m, k), n = a.shape, b.shape[1]
    _launch.check_q8("tsm2r_q8_split", a, b, a_scale, b_scale,
                     -(-m // band), 1, torch.float32)
    if a.device.type == "cpu":
        return ref.tsm2r_q8_split_ref(a, b, a_scale, b_scale, band, splits,
                                      block_k)
    out = torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    _launch.launch("tsm2r_q8_split", torch.float32, a, b, a_scale, b_scale,
                   out, m, k, n, band, splits,
                   ref.split_len(k, splits, block_k))
    q8_split_launches += 1
    return out
