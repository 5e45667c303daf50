"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so csrc/<name>.cu

* Build directory: ``build/repro_torch/`` at the repository root (listed
  in ``.gitignore``).
* Rebuild trigger: ``<hash>`` is a SHA-256 over the kernel's source, every
  ``csrc/*.cuh`` header and the nvcc flags, so an edit to any of them
  builds a new library at the next first use; an unchanged tree loads the
  existing one.
* ``nvcc`` is ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``,
  else the one on ``PATH``.
* A failed build raises ``RuntimeError`` with nvcc's output. Nothing falls
  back to the plain PyTorch versions: those run only for CPU tensors.

Every launcher ``<kernel>_<tag>`` returns the ``cudaError_t`` of its
launch (or of the memset before it); its C signature is
``SIGNATURES[kernel]``, each ending in the stream: two inputs, one output
and three dims for tsm2r and tsm2l; the same plus ``splits`` and the
slice length for the split kernels; for tsmt those plus the workspace
pointer (the (S, a, b) f32 partials, then one int32 counter per output
tile; null at S = 1); one input, one output, ``splits``, rows and cols
for ``reduce``. The int8 kernels (``*_q8*``) take two int8
inputs, their two f32 scale sidecars, the output, the three dims and the
band length of the tall operand's scales (the split ones and tsmt_q8
then ``splits`` and the slice length; tsmt_q8 then the workspace
pointer; tsm2r_q8 then whether B is K-major, which its plan's body must
match). ``quantize`` (not a TPU kernel: the int8 kernels' quantize pass)
takes the operand, a u32 absmax workspace of one slot a band, the f32
scales, the int8 codes, rows, cols, the band length and whether the codes
go out K-major. ``tag`` is "f32" or "bf16": the input dtype of the
f32/bf16 kernels and of ``quantize``, the output dtype of the int8 ones
(``TAGS``: the int8 split kernels write f32 partials only).
The split libraries also export ``<kernel>_grid(int, int, int, int, int*
out)``, the launch grid their tile table gives (``grid``); the tsm2r
library ``tsm2r_plan(m, k, n, dtype tag, A, B, int* out)``: the body
(0 "simt", 1 "wgmma", 2 "skinny") and grid a call launches (``plan``);
the tsm2r_split library ``tsm2r_split_plan(m, k, n, splits, slice, dtype
tag, A, int* out)`` likewise for a split launch (``split_plan``), and the
skinny body's sweep: ``tsm2r_split_sweep_variant(i, int* out)``, variant
i's (rows a thread, groups, stages, producer warps), and
``tsm2r_split_sweep_f32(i, ...)``,
the f32 split launcher's arguments after i (``sweep_variants``,
``sweep_launch``); the tsm2r_q8 library ``tsm2r_q8_plan(m, k, n, A, B,
int* out)`` likewise (``plan`` with dtype tag "int8") and
``tsm2r_q8_transpose(src, dst, rows, cols, stream)``, an int8 [rows,
cols] to [cols, rows] copy (``transpose_q8``); the tsm2r_q8_split library
``tsm2r_q8_split_plan(m, k, n, splits, slice, A, int* out)``
(``split_plan`` with dtype tag "int8") and
``tsm2r_q8_split_sweep_f32(i, ...)``, the int8 split launcher's arguments
after i (``sweep_launch_q8``); the tsmt_q8 and tsmt_q8_split libraries
``tsmt_q8_plan(m, a, b, X, Y, int* out)`` and ``tsmt_q8_split_plan``
likewise: the body (0 "simt", 1 "packed") and the (a, b) tiles
(``tsmt_q8_plan``), and the tsmt_q8_split library
``tsmt_q8_split_sweep_variant(i, int* out)``, the packed body's variant i
(bytes of a row of X a thread, rows in flight) and
``tsmt_q8_split_sweep_f32(i, ...)``, the
launcher's arguments after i (``tsmt_q8_sweep_variants``,
``tsmt_q8_sweep_launch``); the tsm2l and tsm2l_q8 libraries
``tsm2l_plan(m, k, n, dtype tag, A, int* out)`` and ``tsm2l_q8_plan(m,
k, n, output tag, A, int* out)``: the body (0 "tile", 1 "stream"), grid
and stream geometry a call launches (``tsm2l_plan``), and the tsm2l
library the stream body's sweep, ``tsm2l_sweep_variant(i, int* out)``
(variant i's rows a thread) and ``tsm2l_variant_<tag>(rows, ...)``, the
stream body at a chosen rows a thread (``tsm2l_sweep_variants``,
``tsm2l_variant_launch``),
and the tile body alone, ``tsm2l_tile_f32(...)`` with the f32 launcher's
arguments (``tsm2l_tile_launch``); the reduce library ``reduce_plan(splits,
rows, cols, output tag, P, C, int* out)``: the grid, threads a block,
vector width and slices a chunk a call launches (``reduce_plan``), its
sweep, ``reduce_sweep_variant(i, int* out)`` (variant i's threads a block,
blocks an SM, slices a chunk and streaming loads) and
``reduce_sweep_f32(i, ...)`` with the f32 launcher's arguments after i
(``reduce_sweep_variants``, ``reduce_sweep_launch``), and the first body,
``reduce_rows_<tag>(...)`` with the launcher's arguments
(``reduce_rows_launch``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("tsm2r", "tsm2l", "tsmt", "tsm2r_split", "tsmt_split", "reduce",
           "tsm2r_q8", "tsm2l_q8", "tsmt_q8", "tsm2r_q8_split",
           "tsmt_q8_split", "quantize")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_P, _I = ctypes.c_void_p, ctypes.c_int
_SEQ = [_P, _P, _P, _I, _I, _I, _P]
_SPLIT = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
_SEQ_Q8 = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_SPLIT_Q8 = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_SLICES = [*_SPLIT[:-1], _P, _P]         # the split's, then the workspace
_SLICES_Q8 = [*_SPLIT_Q8[:-1], _P, _P]
SIGNATURES = {"tsm2r": _SEQ, "tsm2l": _SEQ, "tsmt": _SLICES,
              "tsm2r_split": _SPLIT, "tsmt_split": _SPLIT,
              "reduce": [_P, _P, _I, _I, _I, _P],
              "tsm2r_q8": [*_SEQ_Q8[:-1], _I, _P], "tsm2l_q8": _SEQ_Q8,
              "tsmt_q8": _SLICES_Q8, "tsm2r_q8_split": _SPLIT_Q8,
              "tsmt_q8_split": _SPLIT_Q8,
              "quantize": [_P, _P, _P, _P, _I, _I, _I, _I, _P]}
TAGS = {name: ("f32",) if name.endswith("q8_split") else ("f32", "bf16")
        for name in KERNELS}
_GRID_QUERIES = ("tsm2r_split", "tsmt_split", "tsm2r_q8_split",
                 "tsmt_q8_split")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    return CSRC.parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the repro_torch CUDA kernels")


def source_hash(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"{name}-{source_hash(name)}.so"


def _start(name: str):
    """Start nvcc for one kernel unless its library exists; returns
    (output path, temp path, process or None)."""
    out = library_path(name)
    if out.exists():
        return out, None, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path | None, proc) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic: a reader never sees a partial library


def build(names=KERNELS) -> dict[str, float]:
    """Build the named kernels, one nvcc process each, all started together.
    Returns, per kernel, the seconds from the start until its library was
    in place (0.0 for one already built)."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    secs, errors = {}, []
    for n, (out, tmp, proc) in started.items():
        try:   # wait for every nvcc before raising, so none outlives us
            _finish(n, out, tmp, proc)
        except RuntimeError as e:
            errors.append(str(e))
        secs[n] = 0.0 if proc is None else time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def resource_usage(names) -> list[dict]:
    """What ptxas reports for every kernel of the named sources (nvcc
    ``--resource-usage``, one process each, all started together):
    registers a thread, static shared bytes and spilled bytes (stores)
    a thread, the kernel named by its template and its template
    arguments. Raises with nvcc's output if one fails."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {n: subprocess.Popen(
        [nvcc(), *NVCC_FLAGS[:4], "--resource-usage", "-c", "-o",
         str(build_dir() / f"{n}.{os.getpid()}.resources.o"),
         str(CSRC / f"{n}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n in names}
    found, errors = [], []
    for n, proc in procs.items():
        log, _ = proc.communicate()
        (build_dir() / f"{n}.{os.getpid()}.resources.o").unlink(
            missing_ok=True)
        if proc.returncode != 0:
            errors.append(f"nvcc --resource-usage {n}.cu failed:\n{log}")
        found += parse_resources(n, log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return found


def parse_resources(source: str, log: str) -> list[dict]:
    """``resource_usage``'s records from ptxas's report of one source:
    each kernel's "Compiling entry function" line, then its spill line,
    then its "Used N registers, ..., S bytes smem" line."""
    found, kernel = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = _kernel_label(entry.group(1))
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and kernel:
            found.append({"source": source, "kernel": kernel,
                          "spilled_bytes": int(spill.group(1))})
        used = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if used and found and found[-1]["kernel"] == kernel:
            found[-1].update(registers=int(used.group(1)),
                             static_shared_bytes=int(used.group(2)))
            kernel = None
    return found


def _kernel_label(mangled: str) -> str:
    """``name<args>`` from an Itanium-mangled kernel template: its
    integer and bool arguments in order, ``bf16`` first for a bf16
    output."""
    name = mangled
    for at in re.finditer(r"(?=(\d+))", mangled):   # a length, then a name
        start = at.start() + len(at.group(1))
        cand = mangled[start:start + int(at.group(1))]
        if cand.endswith("_kernel") and mangled[start + len(cand):][:1] == "I":
            name = cand
            break
    args = re.findall(r"L[ib](\d+)E", mangled)
    dtype = "bf16," if "bfloat16" in mangled else ""
    return f"{name}<{dtype}{','.join(args)}>"


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for dt in TAGS[name]:
                fn = getattr(lib, f"{name}_{dt}")
                fn.argtypes = SIGNATURES[name]
                fn.restype = ctypes.c_int
            if name in _GRID_QUERIES:
                fn = getattr(lib, f"{name}_grid")
                fn.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
                fn.restype = ctypes.c_int
            if name == "tsm2r":
                lib.tsm2r_plan.argtypes = [_I, _I, _I, _I, _P, _P,
                                           ctypes.POINTER(_I)]
                lib.tsm2r_plan.restype = ctypes.c_int
            if name == "tsm2r_split":
                lib.tsm2r_split_plan.argtypes = [_I, _I, _I, _I, _I, _I, _P,
                                                 ctypes.POINTER(_I)]
                lib.tsm2r_split_plan.restype = ctypes.c_int
                lib.tsm2r_split_sweep_variant.argtypes = [_I,
                                                          ctypes.POINTER(_I)]
                lib.tsm2r_split_sweep_variant.restype = ctypes.c_int
                lib.tsm2r_split_sweep_f32.argtypes = [_I, *_SPLIT]
                lib.tsm2r_split_sweep_f32.restype = ctypes.c_int
            if name == "tsm2r_q8":
                lib.tsm2r_q8_plan.argtypes = [_I, _I, _I, _P, _P,
                                              ctypes.POINTER(_I)]
                lib.tsm2r_q8_plan.restype = ctypes.c_int
                lib.tsm2r_q8_transpose.argtypes = [_P, _P, _I, _I, _P]
                lib.tsm2r_q8_transpose.restype = ctypes.c_int
            if name == "tsm2r_q8_split":
                lib.tsm2r_q8_split_plan.argtypes = [_I, _I, _I, _I, _I, _P,
                                                    ctypes.POINTER(_I)]
                lib.tsm2r_q8_split_plan.restype = ctypes.c_int
                lib.tsm2r_q8_split_sweep_f32.argtypes = [_I, *_SPLIT_Q8]
                lib.tsm2r_q8_split_sweep_f32.restype = ctypes.c_int
            if name in ("tsm2l", "tsm2l_q8"):
                fn = getattr(lib, f"{name}_plan")
                fn.argtypes = [_I, _I, _I, _I, _P, ctypes.POINTER(_I)]
                fn.restype = ctypes.c_int
            if name == "tsm2l":
                lib.tsm2l_sweep_variant.argtypes = [_I, ctypes.POINTER(_I)]
                lib.tsm2l_sweep_variant.restype = ctypes.c_int
                lib.tsm2l_tile_f32.argtypes = _SEQ
                lib.tsm2l_tile_f32.restype = ctypes.c_int
                for tag in ("f32", "bf16"):
                    fn = getattr(lib, f"tsm2l_variant_{tag}")
                    fn.argtypes = [_I, *_SEQ]
                    fn.restype = ctypes.c_int
            if name in ("tsmt_q8", "tsmt_q8_split"):
                fn = getattr(lib, f"{name}_plan")
                fn.argtypes = [_I, _I, _I, _P, _P, ctypes.POINTER(_I)]
                fn.restype = ctypes.c_int
            if name == "tsmt_q8_split":
                lib.tsmt_q8_split_sweep_variant.argtypes = [
                    _I, ctypes.POINTER(_I)]
                lib.tsmt_q8_split_sweep_variant.restype = ctypes.c_int
                lib.tsmt_q8_split_sweep_f32.argtypes = [_I, *_SPLIT_Q8]
                lib.tsmt_q8_split_sweep_f32.restype = ctypes.c_int
            if name == "reduce":
                lib.reduce_plan.argtypes = [_I, _I, _I, _I, _P, _P,
                                            ctypes.POINTER(_I)]
                lib.reduce_plan.restype = ctypes.c_int
                lib.reduce_sweep_variant.argtypes = [_I, ctypes.POINTER(_I)]
                lib.reduce_sweep_variant.restype = ctypes.c_int
                lib.reduce_sweep_f32.argtypes = [_I, *SIGNATURES["reduce"]]
                lib.reduce_sweep_f32.restype = ctypes.c_int
                for tag in ("f32", "bf16"):
                    fn = getattr(lib, f"reduce_rows_{tag}")
                    fn.argtypes = SIGNATURES["reduce"]
                    fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def launcher(name: str, dtype_tag: str):
    """The C launcher ``<name>_<dtype_tag>`` ("f32" or "bf16")."""
    return getattr(library(name), f"{name}_{dtype_tag}")


PLAN_TAGS = {"f32": 0, "bf16": 1}
PLAN_BODIES = ("simt", "wgmma", "skinny")


def plan(m: int, k: int, n: int, dtype_tag: str, ptr_a: int,
         ptr_b: int) -> tuple:
    """(body, grid) of a sequential tsm2r call on operands at ``ptr_a`` and
    ``ptr_b``, as its library decides them: the f32/bf16 kernel's for
    ``dtype_tag`` "f32" or "bf16", tsm2r_q8's for "int8" (``ptr_b`` then
    the K-major B's address)."""
    out = (ctypes.c_int * 4)()
    if dtype_tag == "int8":
        err = library("tsm2r_q8").tsm2r_q8_plan(m, k, n, ptr_a, ptr_b, out)
    else:
        err = library("tsm2r").tsm2r_plan(m, k, n, PLAN_TAGS[dtype_tag],
                                          ptr_a, ptr_b, out)
    if err != 0:
        raise RuntimeError(f"tsm2r plan query failed: {err}")
    return PLAN_BODIES[out[0]], tuple(out[1:])


def split_plan(m: int, k: int, n: int, splits: int, slice_: int,
               dtype_tag: str, ptr_a: int) -> tuple:
    """(body, grid) of a tsm2r_split launch of ``splits`` slices of
    ``slice_`` k values on an A at ``ptr_a``, as its library decides them
    (``dtype_tag`` "f32" or "bf16"; "int8" for tsm2r_q8_split's)."""
    out = (ctypes.c_int * 4)()
    if dtype_tag == "int8":
        err = library("tsm2r_q8_split").tsm2r_q8_split_plan(
            m, k, n, splits, slice_, ptr_a, out)
    else:
        err = library("tsm2r_split").tsm2r_split_plan(
            m, k, n, splits, slice_, PLAN_TAGS[dtype_tag], ptr_a, out)
    if err != 0:
        raise RuntimeError(f"tsm2r_split plan query failed: {err}")
    return PLAN_BODIES[out[0]], tuple(out[1:])


def sweep_variants() -> list[tuple[int, int, int, int]]:
    """The skinny body's sweep variants, (rows a thread, k-splitting
    groups, stages, producer warps) each, as the tsm2r_split library lists
    them; the first is the default."""
    lib, out, found = library("tsm2r_split"), (ctypes.c_int * 4)(), []
    while lib.tsm2r_split_sweep_variant(len(found), out) == 0:
        found.append(tuple(out))
    return found


def sweep_launch(variant: int, *args) -> int:
    """Launch the f32 split kernel's skinny body at sweep ``variant`` with
    the f32 launcher's arguments (pointers, m, k, n = 4 or 16, splits,
    slice, stream); returns its cudaError_t."""
    return library("tsm2r_split").tsm2r_split_sweep_f32(variant, *args)


def sweep_launch_q8(variant: int, *args) -> int:
    """Launch tsm2r_q8_split's skinny body at sweep ``variant`` with its
    launcher's arguments (int8 A and B, their scales, the f32 partials, m,
    k, n = 4 or 16, band, splits, slice, stream); returns its
    cudaError_t."""
    return library("tsm2r_q8_split").tsm2r_q8_split_sweep_f32(variant, *args)


TSMT_Q8_BODIES = ("simt", "packed")


def tsmt_q8_plan(m: int, a: int, b: int, ptr_x: int, ptr_y: int,
                 split: bool = False) -> tuple:
    """(body, (a-tiles, b-tiles)) of a tsmt_q8 call (``split``: a
    tsmt_q8_split call) on X at ``ptr_x`` and Y at ``ptr_y``, as its
    library decides them."""
    name = "tsmt_q8_split" if split else "tsmt_q8"
    out = (ctypes.c_int * 3)()
    err = getattr(library(name), f"{name}_plan")(m, a, b, ptr_x, ptr_y, out)
    if err != 0:
        raise RuntimeError(f"{name} plan query failed: {err}")
    return TSMT_Q8_BODIES[out[0]], tuple(out[1:])


def tsmt_q8_sweep_variants() -> list[tuple[int, int]]:
    """The packed int8 TSMT body's sweep variants, (bytes of a row of X a
    thread, rows loaded before any is multiplied) each, as the
    tsmt_q8_split library lists them; the first is the default."""
    lib, out, found = library("tsmt_q8_split"), (ctypes.c_int * 2)(), []
    while lib.tsmt_q8_split_sweep_variant(len(found), out) == 0:
        found.append(tuple(out))
    return found


def tsmt_q8_sweep_launch(variant: int, *args) -> int:
    """Launch tsmt_q8_split's packed body at sweep ``variant`` with its
    launcher's arguments (int8 X and Y, their scales, the f32 partials, m,
    a, b, band, splits, slice, stream); returns its cudaError_t."""
    return library("tsmt_q8_split").tsmt_q8_split_sweep_f32(variant, *args)


TSM2L_BODIES = ("tile", "stream")


def tsm2l_plan(m: int, k: int, n: int, dtype_tag: str, ptr_a: int,
               out_tag: str = "f32") -> tuple:
    """(body, grid, (rows a thread, groups, rows a tile, stages)) of a tsm2l
    call (``dtype_tag`` "f32" or "bf16") or a tsm2l_q8 call (``dtype_tag``
    "int8", writing ``out_tag``) on an A at ``ptr_a``, as its library
    decides them on the current card (the tile body's geometry is (0, 0,
    BM, 0))."""
    out = (ctypes.c_int * 8)()
    if dtype_tag == "int8":
        err = library("tsm2l_q8").tsm2l_q8_plan(m, k, n, PLAN_TAGS[out_tag],
                                                ptr_a, out)
    else:
        err = library("tsm2l").tsm2l_plan(m, k, n, PLAN_TAGS[dtype_tag],
                                          ptr_a, out)
    if err != 0:
        raise RuntimeError(f"tsm2l plan query failed: {err}")
    return TSM2L_BODIES[out[0]], tuple(out[1:4]), tuple(out[4:])


def tsm2l_sweep_variants() -> list[int]:
    """Rows a thread of the stream body's sweep variants, as the tsm2l
    library lists them; the first is the default."""
    lib, out, found = library("tsm2l"), (ctypes.c_int * 1)(), []
    while lib.tsm2l_sweep_variant(len(found), out) == 0:
        found.append(out[0])
    return found


def tsm2l_variant_launch(dtype_tag: str, rows: int, *args) -> int:
    """Launch tsm2l's stream body in ``dtype_tag`` ("f32" or "bf16") at
    ``rows`` a thread (1, 2, 4 or 8) with the launcher's arguments (A, B,
    C, m, k, n = 16 with 16-byte rows, stream); returns its
    cudaError_t."""
    return getattr(library("tsm2l"), f"tsm2l_variant_{dtype_tag}")(rows,
                                                                    *args)


def tsm2l_tile_launch(*args) -> int:
    """Launch tsm2l's f32 tile body at any shape with the f32 launcher's
    arguments; returns its cudaError_t."""
    return library("tsm2l").tsm2l_tile_f32(*args)


def reduce_plan(splits: int, rows: int, cols: int, out_tag: str,
                ptr_p: int, ptr_c: int) -> tuple:
    """(grid, threads a block, vector width, slices a chunk) of a
    sum_partials call writing ``out_tag`` ("f32" or "bf16") from partials
    at ``ptr_p`` into an output at ``ptr_c``, as its library decides them
    on the current card."""
    out = (ctypes.c_int * 4)()
    err = library("reduce").reduce_plan(splits, rows, cols,
                                        PLAN_TAGS[out_tag], ptr_p, ptr_c, out)
    if err != 0:
        raise RuntimeError(f"reduce plan query failed: {err}")
    return (out[0], 1, 1), out[1], out[2], out[3]


def reduce_sweep_variants() -> list[tuple[int, int, int, bool]]:
    """sum_partials' sweep variants, (threads a block, blocks an SM,
    slices a chunk, streaming loads) each, as the reduce library lists
    them; the first is the plan's."""
    lib, out, found = library("reduce"), (ctypes.c_int * 4)(), []
    while lib.reduce_sweep_variant(len(found), out) == 0:
        found.append((out[0], out[1], out[2], bool(out[3])))
    return found


def reduce_sweep_launch(variant: int, *args) -> int:
    """Launch sum_partials' f32 body at sweep ``variant`` with the f32
    launcher's arguments (P, C, splits, rows, cols, stream); returns its
    cudaError_t."""
    return library("reduce").reduce_sweep_f32(variant, *args)


def reduce_rows_launch(out_tag: str, *args) -> int:
    """Launch sum_partials' first body (block_r rows of all cols a
    block) writing ``out_tag`` with the launcher's arguments; returns its
    cudaError_t."""
    return getattr(library("reduce"), f"reduce_rows_{out_tag}")(*args)


def transpose_q8(src: int, dst: int, rows: int, cols: int,
                 stream: int) -> int:
    """Launch tsm2r_q8's int8 [rows, cols] -> [cols, rows] copy; returns
    its cudaError_t."""
    return library("tsm2r_q8").tsm2r_q8_transpose(src, dst, rows, cols,
                                                  stream)


def grid(name: str, m: int, d1: int, d2: int, splits: int) -> tuple:
    """The launch grid the split kernel ``name`` uses for (m, d1, d2) and
    ``splits``, as its library computes it from the tile table."""
    out = (ctypes.c_int * 3)()
    err = getattr(library(name), f"{name}_grid")(m, d1, d2, splits, out)
    if err != 0:
        raise RuntimeError(f"{name}_grid failed: {err}")
    return tuple(out)
