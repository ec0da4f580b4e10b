"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source is compiled on its own by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, which is loaded with
``ctypes``: no PyTorch headers, so a build takes seconds. Libraries land
in a content-hashed directory under ``kernels/build/`` (listed in
``.gitignore``), keyed by the source bytes and the flags, so an edited
source rebuilds and an unchanged one is reused. Nothing is built when a
module is imported: the first launch builds what it needs, and
:func:`build` compiles several sources at once (one ``nvcc`` process per
source, all started together).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("paged_attention", "sampling", "flash_attention", "rmsnorm",
           "paged_ssm", "ssm_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, else ``PATH``, else the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(the kernels build only where the CUDA toolkit is)")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / h.hexdigest()[:16] / f"lib{name}.so"


def build(names: Optional[Iterable[str]] = None) \
        -> Dict[str, Tuple[float, str]]:
    """Compile every named source that has no up-to-date library, all
    ``nvcc`` processes at once. Returns ``{name: (seconds, ptxas log)}``
    for the sources compiled by this call; raises with the compiler's
    output if any build fails."""
    todo = [n for n in (names or SOURCES) if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        out = library_path(name)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n"
                          f"{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)              # atomic: readers never see half
        done[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


def stream_ptr(t) -> int:
    """The handle of PyTorch's current CUDA stream on ``t``'s device, for a
    launcher's ``cudaStream_t`` argument: the raw handle, without building
    a ``torch.cuda.Stream`` object (about 0.3 us against 5 us a call)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher (the C
    side returns ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
