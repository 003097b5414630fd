"""Device resolution and the build of the hand-written CUDA kernels.

Entry points run on the card unless the caller asks for the CPU:
``resolve_device(None)`` is ``cuda``, and it raises when there is no card
rather than carrying on on the CPU.

Each kernel package holds one CUDA C++ source, ``<name>/csrc/<name>.cu``,
with a plain C interface. It is compiled with ``nvcc`` for ``sm_90a`` into a
shared library under ``kernels/_build/`` (named by the source's hash, so an
edited source is rebuilt) and loaded with ``ctypes``. The build happens at
first use; ``build`` compiles several sources at once, one ``nvcc`` each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, List, Optional, Sequence

import torch

KERNELS_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(KERNELS_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, ctypes._CFuncPtr] = {}


def resolve_device(device: Optional[str]) -> torch.device:
    """``None`` means the card. Asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; this entry point runs on the card "
            "unless the CPU is asked for explicitly (device='cpu' / --device cpu)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def source_path(name: str) -> str:
    return os.path.join(KERNELS_DIR, name, "csrc", f"{name}.cu")


def library_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    found = path if os.path.exists(path) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {path} and on PATH)")
    return found


def build(names: Iterable[str]) -> List[str]:
    """Compile every listed kernel whose library is missing, all at once.

    Returns the names that were compiled. Raises with the compiler's output
    if any build fails. The compiler's report (registers, spills) is kept
    beside each library as ``<lib>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        lib = library_path(name)
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append((name, lib, tmp, p))
    failed = []
    for name, lib, tmp, p in procs:
        log, _ = p.communicate()
        with open(f"{lib}.log", "w") as f:
            f.write(log)
        if p.returncode != 0:
            failed.append(f"{name}: nvcc exited {p.returncode}\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return [name for name, *_ in procs]


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(library_path(name))
    return lib


def c_function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """A C entry point of kernel ``name`` with its argument types set (pointers
    and the stream as ``c_void_p``, so they are not cut to 32 bits). Every
    entry point returns ``cudaGetLastError()`` after its launch."""
    fn = _FNS.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


def check_launch(symbol: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed with cudaError {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    """Validate what a kernel is given, before any pointer reaches it."""
    if not cond:
        raise ValueError(msg)


def require_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
                        device: Optional[torch.device] = None) -> None:
    require(t.is_cuda, f"{name} must be a CUDA tensor, got {t.device}")
    require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    require(t.dim() == ndim, f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    require(t.is_contiguous(), f"{name} must be contiguous")
    if dtype == torch.float32:  # the kernels read float4
        require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    if device is not None:
        require(t.device == device, f"{name} is on {t.device}, expected {device}")
