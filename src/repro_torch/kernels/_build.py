"""Build the CUDA kernels of ``repro_torch/csrc`` at first use, and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (``build/repro_torch/<hash>/lib<name>.so`` at the
repository root, a directory ``.gitignore`` lists), and loaded with
``ctypes``.  ``<hash>`` covers every source and header and the flags, so an
edited kernel is rebuilt and a stale library is never loaded.  All sources
compile in parallel, one ``nvcc`` each.  A failed build or load raises.
A process builds and loads each library once, whichever thread asks first
(the serving tier launches kernels from its dispatcher threads): the miss
path of :func:`load` runs under one lock, and every ``nvcc`` writes a
temporary file of its own before the rename.

Nothing is built at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import uuid
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
#: held while a library is built and loaded (``load``'s miss path)
_LOAD_LOCK = threading.Lock()
#: declared C launchers by (library, function name)
_FUNCS: dict[tuple, ctypes._CFuncPtr] = {}
#: ``nvcc`` output (``-Xptxas -v``: registers, shared memory, spills) of the
#: builds this process ran, by source name.
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH, /usr/local/cuda/bin): the CUDA kernels of "
        "repro_torch build at first use and need the CUDA toolkit"
    )


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built; returns {name: library}.

    The compilers run in parallel; each writes a temporary file, unique to
    the call, that is renamed into place only when it succeeded.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out / f"lib{src.stem}.so" for src in sources()}
    todo = [(src, libs[src.stem]) for src in sources() if not libs[src.stem].exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = []
    for src, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.{uuid.uuid4().hex}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOGS[src.stem] = log
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)  # another thread may have loaded it
            if lib is None:
                path = build_all()[name]
                lib = ctypes.CDLL(str(path))
                _LIBS[name] = lib
    return lib


def c_function(lib_name: str, fn_name: str, n_pointers: int, n_ints: int):
    """A C launcher ``int fn(void* x n_pointers, int x n_ints, void* stream)``
    with its ``argtypes``/``restype`` declared (a pointer passed without
    ``c_void_p`` would be cut to 32 bits).  Declared once per (library,
    function) and memoized: a launch looks it up and declares nothing."""
    lib = load(lib_name)
    fn = _FUNCS.get((lib, fn_name))
    if fn is None:
        fn = getattr(lib, fn_name)
        fn.argtypes = (
            [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _FUNCS[(lib, fn_name)] = fn
    return fn


def on_meta(t: torch.Tensor) -> bool:
    """A wrapper's third branch, for the dry-run: True only for a tensor on
    ``meta``, whose call computes nothing and charges its kernel's cost
    model (:func:`dry_launch`).  Never true for a CPU or CUDA tensor."""
    return t.device.type == "meta"


def dry_launch(name: str, cost: dict, out: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The meta path's result: ``out`` (an empty meta tensor of the plain
    version's shape and dtype), after charging ``cost`` (a
    ``kernels.costs`` model's flops and bytes) to the active
    ``launch.meta_cost`` counter.  It counts no launch."""
    from repro_torch.launch import meta_cost

    meta_cost.charge_kernel(name, cost["flops"], cost["hbm_bytes"], dtype)
    return out


def on_card(t: torch.Tensor, name: str) -> bool:
    """A wrapper's dispatch: True for a CUDA tensor (launch the kernel),
    False for a CPU tensor (run the plain version); other devices raise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def check(t, name: str, dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (a ``None`` in ``shape`` matches any size)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    size = t.shape
    if size != shape and (len(size) != len(shape) or any(
        want is not None and got != want for got, want in zip(size, shape)
    )):
        raise ValueError(f"{name}: shape {tuple(size)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch(fn, tensors, ints, device) -> None:
    """Call a C launcher on ``device``'s current stream; a ``None`` in
    ``tensors`` is a null pointer.  Raise on a non-zero ``cudaError_t`` (a
    refused launch never runs, and a later synchronize would not report
    it).  The device is switched only when it is not the current one."""
    idx = device.index
    args = [None if t is None else t.data_ptr() for t in tensors]
    if torch.cuda.current_device() == idx:
        err = fn(*args, *ints, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(device):
            err = fn(*args, *ints, torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} returned cudaError_t {err}")
