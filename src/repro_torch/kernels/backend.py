"""Device resolution and the build of the hand-written CUDA kernels.

Entry points run on the card unless the caller asks for the CPU:
``resolve_device(None)`` is ``cuda``, and it raises when there is no card
rather than carrying on on the CPU.

Each kernel package holds one CUDA C++ source, ``<name>/csrc/<name>.cu``,
with a plain C interface. It is compiled with ``nvcc`` for ``sm_90a`` into a
shared library under ``kernels/_build/`` (named by the source's hash, so an
edited source is rebuilt) and loaded with ``ctypes``. The build happens at
first use; ``build`` compiles several sources at once, one ``nvcc`` each.

Threads: trainer threads may reach their first kernel at the same time, so
``build``, ``load`` and ``c_function`` run under one module lock (each
library is built and loaded once per process), and ``count_launch`` bumps a
wrapper's launch counter under a lock of its own, so counts stay exact.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

KERNELS_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(KERNELS_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, ctypes._CFuncPtr] = {}
# Re-entrant: ``load`` calls ``build`` and ``c_function`` calls ``load``.
_BUILD_LOCK = threading.RLock()
_COUNT_LOCK = threading.Lock()
# Small int32 index vectors (replica ids), made once per (device, ids), and
# the host ids of each such tensor, by its id() (the tensors live as long as
# the module, so no other tensor takes that id()).
_INDEX: Dict[tuple, torch.Tensor] = {}
_HOST_IDS: Dict[int, Tuple[torch.Tensor, Tuple[int, ...]]] = {}
_INDEX_LOCK = threading.Lock()


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


def sources() -> List[str]:
    """Every kernel source of the port: each ``<name>`` under this directory
    that holds ``<name>/csrc/<name>.cu``."""
    return sorted(n for n in os.listdir(KERNELS_DIR) if os.path.exists(source_path(n)))


def library_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def cuda_tool(name: str) -> str:
    """A CUDA toolkit program (``nvcc``, ``cuobjdump``): under ``$CUDA_HOME``
    (or ``$CUDA_PATH``, or /usr/local/cuda), else on PATH."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", name)
    found = path if os.path.exists(path) else shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found (looked in {path} and on PATH)")
    return found


def build(names: Iterable[str]) -> List[str]:
    """Compile every listed kernel whose library is missing, all at once.

    Returns the names that were compiled. Raises with the compiler's output
    if any build fails. The compiler's report (registers, spills) is kept
    beside each library as ``<lib>.log``."""
    with _BUILD_LOCK:
        return _build(names)


# holds-lock: _BUILD_LOCK; lock-blocking: ok — the build is what the lock
# serializes: a thread that needs the library waits for it either way
def _build(names: Iterable[str]) -> List[str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        lib = library_path(name)
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", tmp, source_path(name)]
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
    with _BUILD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(library_path(name))
        return lib


def c_function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """A C entry point of kernel ``name`` with its argument types set (pointers
    and the stream as ``c_void_p``, so they are not cut to 32 bits). Every
    entry point returns ``cudaGetLastError()`` after its launch."""
    with _BUILD_LOCK:
        fn = _FNS.get(symbol)
        if fn is None:
            fn = getattr(load(name), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _FNS[symbol] = fn
        return fn


def count_launch(op) -> None:
    """One more launch of ``op``'s kernel. ``op.launches`` stays a plain int
    (callers reset it to 0), and the increment is exact under threads."""
    with _COUNT_LOCK:
        op.launches += 1


_TRACE = threading.local()  # a dry run's trace, per thread (``tracing``)


class tracing:
    """The work of the kernels that wrappers stand for on ``meta`` tensors
    while a dry run traces a step (``launch/dryrun.py``): the meta twins
    stand for the card, so where the card would launch a kernel, its
    wrapper returns the output's shape and reports the kernel's work here
    (``trace_work``). ``work`` is {kernel: [calls, flops, bytes]}."""

    def __enter__(self):
        self.prev = getattr(_TRACE, "work", None)
        _TRACE.work = self.work = {}
        return self

    def __exit__(self, *exc):
        _TRACE.work = self.prev
        return False


def trace_work(name: str, flops: int, nbytes: int) -> None:
    """Count one kernel's work in the active ``tracing``. A wrapper given a
    meta tensor outside a trace has nothing to run, so this raises there."""
    work = getattr(_TRACE, "work", None)
    if work is None:
        raise RuntimeError(f"{name}: a meta tensor outside a dry run's trace (backend.tracing)")
    calls = work.setdefault(name, [0, 0, 0])
    calls[0] += 1
    calls[1] += flops
    calls[2] += nbytes


def check_launch(symbol: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed with cudaError {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def index_tensor(ids: Sequence[int], device: torch.device) -> torch.Tensor:
    """``ids`` as an int32 tensor on ``device``, made once per (device, ids)
    and kept: the replica-id lists of the sync kernels (all rows, the live
    rows, a gossip round's participants) come from a handful of
    memberships, so a landing copies no ids to the card after the first."""
    key = (str(device), tuple(int(i) for i in ids))
    with _INDEX_LOCK:
        t = _INDEX.get(key)
    if t is not None:
        return t
    # the copy to the card runs outside the lock; a racing first use of the
    # same ids keeps the tensor that was stored first
    new = torch.tensor(key[1], dtype=torch.int32).to(device)
    with _INDEX_LOCK:
        t = _INDEX.setdefault(key, new)
        if t is new:
            _HOST_IDS[id(t)] = (t, key[1])
        return t


def host_ids(t: torch.Tensor) -> Tuple[int, ...]:
    """The ids of a 1-D int tensor as host ints: for a tensor that
    ``index_tensor`` made, the ids it was made from (no read from the card);
    for any other, a read back (which waits for the card)."""
    with _INDEX_LOCK:
        hit = _HOST_IDS.get(id(t))
    if hit is not None and hit[0] is t:
        return hit[1]
    return tuple(int(i) for i in t.tolist())


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors' memory ranges overlap (a view and its base do)."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


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
