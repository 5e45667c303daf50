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
tile; null at S = 1); one input, one output, ``splits``, rows, cols and
rows per block for ``reduce``. The int8 kernels (``*_q8*``) take two int8
inputs, their two f32 scale sidecars, the output, the three dims and the
band length of the tall operand's scales (the split ones and tsmt_q8
then ``splits`` and the slice length; tsmt_q8 then the workspace
pointer). ``tag`` is "f32"
or "bf16": the input dtype of the f32/bf16 kernels, the output dtype of
the int8 ones (``TAGS``: the int8 split kernels write f32 partials only).
The split libraries also export ``<kernel>_grid(int, int, int, int, int*
out)``, the launch grid their tile table gives (``grid``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("tsm2r", "tsm2l", "tsmt", "tsm2r_split", "tsmt_split", "reduce",
           "tsm2r_q8", "tsm2l_q8", "tsmt_q8", "tsm2r_q8_split",
           "tsmt_q8_split")
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
              "reduce": [_P, _P, _I, _I, _I, _I, _P],
              "tsm2r_q8": _SEQ_Q8, "tsm2l_q8": _SEQ_Q8, "tsmt_q8": _SLICES_Q8,
              "tsm2r_q8_split": _SPLIT_Q8, "tsmt_q8_split": _SPLIT_Q8}
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
            _LIBS[name] = lib
        return lib


def launcher(name: str, dtype_tag: str):
    """The C launcher ``<name>_<dtype_tag>`` ("f32" or "bf16")."""
    return getattr(library(name), f"{name}_{dtype_tag}")


def grid(name: str, m: int, d1: int, d2: int, splits: int) -> tuple:
    """The launch grid the split kernel ``name`` uses for (m, d1, d2) and
    ``splits``, as its library computes it from the tile table."""
    out = (ctypes.c_int * 3)()
    err = getattr(library(name), f"{name}_grid")(m, d1, d2, splits, out)
    if err != 0:
        raise RuntimeError(f"{name}_grid failed: {err}")
    return tuple(out)
