"""Build the CUDA kernels of ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exports plain C functions (pointers and the stream
as ``void*``) and compiles on its own with ``nvcc`` into
``build/diffusionvid_torch/lib<name>-<hash>.so`` under the repository root;
it may include the shared headers ``csrc/*.cuh``.  The hash covers the
source, every header and the compiler flags, so a stale library is never
loaded.  ``build_all`` starts one ``nvcc`` per source, all at once,
and waits for every one of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "diffusionvid_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> loaded library; a library stays loaded for the life of the process
_LIBS: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile every missing library in parallel; returns each source's
    ``ptxas`` report (registers, shared memory, spills).  Raises with the
    compiler's output if any build fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch.  Every
    library exports ``error_string`` (``cudaGetErrorString``)."""
    if err != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: launch failed with cudaError {err} ({msg})")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
