"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
alone into ``_build/lib<name>-<hash>.so`` (no PyTorch headers, so a build
takes seconds), then loaded with ``ctypes``. The hash covers the source and
the flags, so a stale library is never loaded. Nothing is built when this
module is imported: the first launch of a kernel builds it, and
``build_all`` builds every kernel at once, one ``nvcc`` per source, all
started together. Loading and building hold one process-wide lock, and each
build writes a temporary file named by process and thread, so threads that
reach a kernel's first launch together build it once.

``--fmad=false`` keeps ``a*b+c`` as two rounded operations, so the float
bits match the plain PyTorch twins and the reference. ``-Xptxas=-v`` puts
each kernel's registers and shared memory into the build log.
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
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("select_candidates", "move_score", "wave_admission", "segment_sum",
           "leadership_score", "swap", "disk_move", "preferred_leader", "replica_keys",
           "session_finalize", "seeded_probe", "forecast")

_loaded: dict[str, ctypes.CDLL] = {}
# one load-or-build at a time in this process: the server's handler threads,
# the pipeline's stage threads and the fleet's precompute thread may all
# reach a kernel's first launch together
_build_lock = threading.RLock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names=SOURCES) -> dict:
    """Build every named kernel library that is not built yet, in parallel.
    Returns {"seconds": wall, "built": [...], "log": {name: nvcc output}}."""
    t0 = time.monotonic()
    with _build_lock:
        started = {n: _start(n) for n in names if not _target(n).exists()}
        logs = {}
        try:
            for n, (proc, tmp, out) in started.items():
                logs[n] = _finish(n, proc, tmp, out)
        finally:
            for proc, _tmp, _out in started.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return {"seconds": time.monotonic() - t0, "built": list(started),
            "log": logs}


P, I = ctypes.c_void_p, ctypes.c_int    # pointer / int argument types
LL = ctypes.c_longlong
IP = ctypes.POINTER(ctypes.c_int)       # an int the entry point writes (host memory)


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use.
    ``signatures`` maps each C entry point to its argument types; every
    entry point returns its launch's ``cudaError_t`` as an int."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _build_lock:
        lib = _loaded.get(name)
        if lib is None:
            if not _target(name).exists():
                build_all((name,))
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = I
            _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError {err}")


def stack_lanes(vals: list, what: str):
    """One argument of a lane launch from the lanes' solo values: the
    tensors stacked on a new leading axis (contiguous), tuples member-wise,
    None when every lane passes None."""
    if all(v is None for v in vals):
        return None
    if any(v is None for v in vals):
        raise ValueError(f"{what}: an argument is None in some lanes only")
    if isinstance(vals[0], tuple):
        return tuple(stack_lanes([v[i] for v in vals], what) for i in range(len(vals[0])))
    import torch
    return torch.stack(vals).contiguous()


def lane_operand(vals: list, what: str):
    """One operand of a launch over ``len(vals)`` lanes: a single lane's
    value as it is (its memory is a one-lane stack's), else
    ``stack_lanes``."""
    if len(vals) == 1:
        return vals[0]
    return stack_lanes(vals, what)


_host_ints: dict = {}


def host_ints(values, device, dtype=None):
    """A small host list of ints (a lane index list, the lanes' stalls) as
    a tensor on ``device``, copied once per (device, dtype, values) and kept:
    a copy from pageable host memory waits for the stream to drain, so the
    pass loop must not make one per launch."""
    import torch
    dtype = torch.int64 if dtype is None else dtype
    key = (str(device), dtype, tuple(int(v) for v in values))
    t = _host_ints.get(key)
    if t is None:
        if len(_host_ints) >= 4096:
            _host_ints.clear()
        t = _host_ints[key] = torch.tensor(key[2], dtype=dtype, device=device)
    return t


def lane_index(lanes, device):
    """i64[La] on ``device``: the lane index list ``lanes`` of a lane stack
    (``host_ints``)."""
    return host_ints(lanes, device)


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (``None`` -> NULL)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_ptr() -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


class Kernel:
    """One hand-written kernel: where it lives, which reference function it
    replaces, and how often its wrapper launched it (``launches`` counts
    calls on the card only, ``shapes`` splits them by launch shape; the
    plain twin on the CPU counts nothing). ``cuda_launches`` sums the CUDA
    launches the calls made, for the wrappers whose entry point reports
    them (K1 and ``segment_sum``)."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.cuda_launches = 0
        self.shapes: dict[str, int] = {}

    def count(self, shape: str = "", cuda_launches: int = 0) -> None:
        """Record one launch of the kernel (called right after it) and the
        CUDA launches it took."""
        self.launches += 1
        self.cuda_launches += cuda_launches
        self.shapes[shape] = self.shapes.get(shape, 0) + 1


KERNELS: dict[str, Kernel] = {}


def register(name: str, source: str, replaces: str) -> Kernel:
    k = Kernel(name, source, replaces)
    KERNELS[name] = k
    return k
