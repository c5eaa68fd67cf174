"""Build, load and count the hand-written CUDA kernels under ``csrc/``.

Every ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``) with ``nvcc``
into one shared library with a plain C interface, loaded with ``ctypes``;
``csrc/*.cuh`` are headers the sources include (``hopper.cuh``: TMA,
mbarriers and ``wgmma``), never compiled on their own.
The build runs at first use, never at import (the CPU test suite imports
every module on a machine without ``nvcc``), one ``nvcc`` per source, all
started together, then one link.  The library lands in ``.kernel_build/``
at the repository root under a name that carries a hash of every file under
``csrc/`` (sources and headers) and of the flags, so an edited source or
header rebuilds and an unchanged tree loads at once.  A
failed build raises with ``nvcc``'s error output.

:data:`LAUNCHES` counts, per kernel, the launches the wrappers made: each
wrapper adds one where it launches its kernel and nowhere else, so a run
can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".kernel_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {
    "rms_norm_fwd": 0, "rms_norm_bwd": 0,
    "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
    "adam8_fused": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C signatures (csrc/*.cu): every pointer and the stream as c_void_p, or
# ctypes would pass them as 32-bit ints and cut them
_SIGNATURES = {
    "tpunet_rms_norm_fwd": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
    "tpunet_rms_norm_bwd": [_P] * 7 + [_I] * 4 + [_P],
    "tpunet_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I]
    + [_LL] * 12 + [_F, _I, _P],
    "tpunet_flash_bwd_dq": [_P] * 7 + [_I] * 6 + [_LL] * 15
    + [_F, _I, _I, _P],
    "tpunet_flash_bwd_dkv": [_P] * 8 + [_I] * 6 + [_LL] * 18
    + [_F, _I, _I, _P],
    "tpunet_adam8_fused": [_P] * 7 + [_LL, _I] + [_F] * 9 + [_I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _sources():
    """The files compiled: one object each."""
    return sorted(CSRC.glob("*.cu"))


def _inputs():
    """Every file the build reads: the sources and the headers they
    include."""
    return sorted(p for p in CSRC.iterdir()
                  if p.is_file() and p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _inputs():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libtpunet_kernels_{digest.hexdigest()[:16]}.so"


def _run(cmds, what: str) -> None:
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for c in cmds
    ]
    errors = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"$ {' '.join(cmd)}\n{out}{err}")
    if errors:
        raise RuntimeError(f"kernel {what} failed:\n" + "\n".join(errors))


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in _sources()]
        _run([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
              for src, obj in zip(_sources(), objs)], "compile")
        partial = Path(tmp) / target.name
        _run([[nvcc, "-shared", *NVCC_FLAGS, *map(str, objs),
               "-o", str(partial)]], "link")
        os.replace(partial, target)
    return target


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
