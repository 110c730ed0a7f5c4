"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/<name>.cu`` has a plain C interface and compiles, on its own,
into ``build/otfusion_tpu_torch/lib<name>-<hash>.so`` at the repository root
(``.gitignore`` lists ``build/``). The hash covers the source and the
compiler flags, so an edited kernel is rebuilt and an unchanged one is
loaded as it is. ``build_all`` starts one ``nvcc`` per source, all at once.

Nothing is built when a module is imported: the first call that needs a
kernel builds it. Without ``nvcc`` the build raises.
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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "otfusion_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of otfusion_tpu_torch are built "
        "from csrc/ at first use and need the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, float]:
    """Compile every source not built yet, one ``nvcc`` each, in parallel.

    Returns {name: seconds} for the sources compiled by this call; the
    ptxas report (registers, shared memory, spills) lands in ``<lib>.log``.
    """
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        log = open(target.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       tmp, target, log, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, target, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (rc {rc}):\n"
                          + target.with_suffix(".log").read_text()[-4000:])
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            target = _target(name)
            if not target.exists():
                build_all([name])
            lib = ctypes.CDLL(str(target))
            lib.otf_error_string.argtypes = [ctypes.c_int]
            lib.otf_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


class LaunchCounter:
    """Plain-integer count of a kernel's launches (``chip_smoke.py`` resets
    it before driving the main path and reads it after)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0


def _arg(value):
    if isinstance(value, torch.Tensor):
        return ctypes.c_void_p(value.data_ptr())
    if isinstance(value, bool):
        return ctypes.c_int(int(value))
    if isinstance(value, int):
        return ctypes.c_int(value)
    if isinstance(value, float):
        return ctypes.c_float(value)
    if value is None:
        return ctypes.c_void_p(None)
    raise TypeError(f"unsupported kernel argument {type(value).__name__}")


def launch(lib: ctypes.CDLL, fn_name: str, counter: LaunchCounter,
           *args) -> None:
    """Call ``fn_name`` with ``args`` plus the current CUDA stream; raise on
    a CUDA error and count the launch (each C entry point launches exactly
    one kernel). ``argtypes`` are declared from the
    Python types, so pointers and the stream travel as ``c_void_p``."""
    fn = getattr(lib, fn_name)
    c_args = [_arg(a) for a in args]
    c_args.append(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    fn.argtypes = [type(a) for a in c_args]
    fn.restype = ctypes.c_int
    rc = fn(*c_args)
    if rc != 0:
        raise RuntimeError(
            f"{fn_name}: CUDA error {rc} "
            f"({lib.otf_error_string(rc).decode()})")
    counter.count += 1


def require_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """Check that every tensor is a contiguous fp32 CUDA tensor on one
    device."""
    device = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name}: expected CUDA tensors on {device}, "
                             f"got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
