"""Build and load the hand-written CUDA kernels in ``csrc/``.

All ``csrc/*.cu`` files are compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and linked into ONE shared
library with a plain C interface, loaded with ``ctypes``. The build happens
at first use (never at import), into ``x_multi_agent_torch/_build/``, and is
keyed by a hash of the sources and flags, so an edited kernel is rebuilt and
an unchanged one is loaded as it is. A failed build raises with nvcc's
stderr; there is no fallback. ``build_log`` keeps ptxas's report of each
kernel's registers, shared memory and spills.

Each kernel's Python wrapper owns a :class:`Kernel`, which counts the
wrapper's launches (a plain integer: the count a run reads to prove that its
main path went through the kernel).
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

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None  # wall time of the last nvcc build (None: loaded as built)
build_log = ""  # ptxas report of the last build


def _sources(csrc: Path = CSRC):
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256()
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir / f"libxmat_kernels_{h.hexdigest()[:16]}.so"


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``csrc/*.cu`` into the hashed library (no-op when present):
    one ``nvcc -c`` per source in parallel, then one link. ``csrc`` and
    ``build_dir`` default to this package's (another checkout's sources can
    be built beside them for a comparison)."""
    global build_seconds, build_log
    out = library_path(csrc, build_dir)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(csrc.glob("*.cu")):
        obj = build_dir / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    cmds = [(cmd, proc.communicate()[1], proc.returncode) for cmd, proc in procs]
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
           *[str(o) for o in objs]]
    if all(rc == 0 for _, _, rc in cmds):
        link = subprocess.run(cmd, capture_output=True, text=True)
        cmds.append((cmd, link.stderr, link.returncode))
    for obj in objs:
        obj.unlink(missing_ok=True)
    for cmd, err, rc in cmds:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{err}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(err for _, err, _ in cmds)
    return out


def load(path) -> ctypes.CDLL:
    """A built kernel library with its entry points' signatures set."""
    cdll = ctypes.CDLL(str(path))
    for name, n_ptr, n_int, n_float in _SIGNATURES:
        fn = getattr(cdll, name)
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptr
            + [ctypes.c_int] * n_int
            + [ctypes.c_float] * n_float
            + [ctypes.c_void_p]  # stream
        )
        fn.restype = ctypes.c_int
    return cdll


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
    return _lib


# (C symbol, #pointers, #ints, #floats) — every entry point takes its
# pointers, then ints, then floats, then the CUDA stream, and returns
# cudaGetLastError() after the launch
_SIGNATURES = (
    ("xmat_fast_score_nms", 2, 4, 1),
    ("xmat_lk_level", 8, 6, 2),
)


KERNELS: list = []  # every Kernel, in the order the wrappers made them


class Kernel:
    """Launch counter of one hand-written kernel's wrapper, whose device
    function is ``<name>_kernel`` (a compiled program's replays add the
    launches of it that its graph holds: ``utils/graph.py``)."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source  # path in the repo
        self.replaces = replaces  # file:line of the Pallas kernel it replaces
        self.launches = 0
        KERNELS.append(self)

    def launch(self, symbol: str, *args) -> None:
        import torch

        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib(), symbol)(*args, ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error {err}")
        self.launches += 1


def check_cuda_tensor(name: str, t, dtype, shape=None) -> None:
    """Validate a kernel operand: CUDA, dtype, contiguity and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
