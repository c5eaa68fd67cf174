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
failed build raises with ``nvcc``'s error output.  The sources compile
with ``-Xptxas -v``: ptxas's report (registers, spills, and its notes
that it serialized a kernel's ``wgmma`` instructions) is kept beside the
library and read by :func:`ptxas_report`.

:data:`LAUNCHES` counts, per kernel, the launches the wrappers made: each
wrapper adds one where it launches its kernel and nowhere else, so a run
can show that its path went through the kernels.  A CUDA graph's capture
launches nothing: :func:`captured` takes its counts back out and returns
them, and :func:`replayed` adds them for each replay, so a replayed step
counts as the eager one does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".kernel_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {
    "rms_norm_fwd": 0, "rms_norm_bwd": 0,
    "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
    "adam8_fused": 0, "decode_attn": 0, "adamw_fused": 0,
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
    + [_LL] * 12 + [_F, _I, _I, _P],
    "tpunet_flash_bwd_dq": [_P] * 7 + [_I] * 6 + [_LL] * 15
    + [_F, _I, _I, _I, _P],
    "tpunet_flash_bwd_dkv": [_P] * 8 + [_I] * 6 + [_LL] * 18
    + [_F, _I, _I, _I, _P],
    "tpunet_adam8_fused": [_P, _I] + [_F] * 9 + [_P],
    "tpunet_decode_attn": [_P] * 6 + [_I] * 5 + [_P, _I, _I] + [_LL] * 10
    + [_F, _I, _P],
    "tpunet_adamw_fused": [_P, _I, _P, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def captured(capture: Callable[[], None]) -> Dict[str, int]:
    """Run ``capture``, a CUDA graph's capture (which launches nothing):
    the launches the wrappers counted in it, taken back out of
    :data:`LAUNCHES`.  Each replay of the graph launches them
    (:func:`replayed`)."""
    before = dict(LAUNCHES)
    try:
        capture()
    finally:
        made = {n: c - before[n] for n, c in LAUNCHES.items()
                if c != before[n]}
        LAUNCHES.update(before)
    return made


def replayed(counts: Dict[str, int]) -> None:
    """Count one replay of a graph whose capture :func:`captured`
    returned ``counts``."""
    for name, n in counts.items():
        LAUNCHES[name] += n


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


def _run(cmds, what: str) -> List[str]:
    """Run the commands at once; their output, or raise with the
    failures'."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for c in cmds
    ]
    outputs, errors = [], []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        outputs.append(out + err)
        if proc.returncode != 0:
            errors.append(f"$ {' '.join(cmd)}\n{out}{err}")
    if errors:
        raise RuntimeError(f"kernel {what} failed:\n" + "\n".join(errors))
    return outputs


def _log_path(target: Path) -> Path:
    return target.with_suffix(".ptxas.txt")


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in _sources()]
        logs = _run([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                     for src, obj in zip(_sources(), objs)], "compile")
        _log_path(target).write_text("".join(
            f"== {src.name}\n{log}" for src, log in zip(_sources(), logs)))
        partial = Path(tmp) / target.name
        _run([[nvcc, "-shared", *NVCC_FLAGS, *map(str, objs),
               "-o", str(partial)]], "link")
        os.replace(partial, target)
    return target


def _demangle(name: str) -> str:
    """A kernel's readable name from its mangled one: the function and
    its template arguments (types, integer and bool literals), e.g.
    ``flash_bwd_dq_kernel<64>``; the name as given if it is not of that
    form."""
    m = re.match(r"_ZN?", name)
    rest, ident = name[m.end():] if m else "", None
    while rest[:1].isdigit():          # the nested names; the last is ours
        n = re.match(r"\d+", rest)
        ident = rest[n.end():n.end() + int(n.group())]
        rest = rest[n.end() + int(n.group()):]
    if ident is None:
        return name
    if not rest.startswith("I"):
        return ident
    args, rest = [], rest[1:]
    builtins = {"f": "float", "i": "int", "b": "bool", "d": "double"}
    while rest and rest[0] != "E":
        lit = re.match(r"L[ib](\d+)E", rest)
        cls = re.match(r"(\d+)", rest)
        if lit:
            args.append(lit.group(1))
            rest = rest[lit.end():]
        elif cls:
            n = int(cls.group(1))
            args.append(rest[cls.end():cls.end() + n])
            rest = rest[cls.end() + n:]
        elif rest[0] in builtins:
            args.append(builtins[rest[0]])
            rest = rest[1:]
        else:
            return name
    return f"{ident}<{','.join(args)}>"


def parse_ptxas(log: str) -> dict:
    """ptxas's ``-v`` report: per kernel entry, its registers and spilled
    bytes; and every note that it serialized ``wgmma`` instructions
    (C7513, C7515, C7520 and kin), which voids their overlap."""
    kernels, notes, current = {}, [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            current = _demangle(entry.group(1))
            kernels[current] = {}
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill and current:
            kernels[current]["spill_stores"] = int(spill.group(1))
            kernels[current]["spill_loads"] = int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used and current:
            kernels[current]["registers"] = int(used.group(1))
        if re.search(r"\(C75\d\d\)", line) and "wgmma" in line:
            notes.append(line.strip())
    return {"kernels": kernels, "wgmma_serialized": notes}


def ptxas_report() -> Optional[dict]:
    """:func:`parse_ptxas` of the built library's compile log (None if
    the library was built without one)."""
    log = _log_path(library_path())
    return parse_ptxas(log.read_text()) if log.exists() else None


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
