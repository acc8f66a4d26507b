"""Build the CUDA kernels of ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exports plain C functions (pointers and the stream
as ``void*``) and compiles on its own with ``nvcc`` into
``build/diffusionvid_torch/lib<name>-<hash>.so`` under the repository root;
it may include the shared headers ``csrc/*.cuh``.  The hash covers the
source, every header and the compiler flags, so a stale library is never
loaded.  ``build_all`` starts one ``nvcc`` per source, all at once,
and waits for every one of them.

The host library ``csrc/vidkit.cpp`` (seq-NMS's chain search and the
evaluator's matching, ``native.py``) compiles with ``g++`` into
``build/diffusionvid_torch/libvidkit-<hash>.so`` the same way, by
``load_host``; ``sources`` lists the ``.cu`` files only.
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
# no -march=native: the library must load on any x86-64 host; no
# floating-point contraction: an FMA would round the IoU differently from numpy
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off", "-Wall"]

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


def host_target(name: str) -> Path:
    """The library file of the host source ``csrc/<name>.cpp``."""
    src = (CSRC / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of the host source ``csrc/<name>.cpp``, compiled
    with ``g++`` (``$CXX``) first if needed.  Raises with the compiler's
    output if the build fails."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    out = host_target(name)
    if not out.exists():
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError(f"no C++ compiler to build csrc/{name}.cpp: set CXX")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *GXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{Path(cxx).name} failed on csrc/{name}.cpp "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    lib = _LIBS[name] = ctypes.CDLL(str(out))
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
    """The current stream of ``device``, on which a wrapper launches its
    kernel through ctypes.  The launch goes to the current device, so a
    tensor on another card raises: its stream would be invalid there."""
    device = torch.device(device)
    current = torch.cuda.current_device()
    if device.index is not None and device.index != current:
        raise RuntimeError(
            f"a kernel's input is on {device} but the current device is cuda:{current}: "
            f"call torch.cuda.set_device({device.index}) first (under torchrun, "
            "parallel.dist.initialize does)")
    return torch.cuda.current_stream(device).cuda_stream
