"""Builder and loader for the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled, at
first use, into its own shared library::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

``<hash>`` covers the flags, the ``.cu`` source and every shared ``.cuh``, so
an edited source is rebuilt and a stale library is never loaded.  The
libraries are loaded with ``ctypes``: pointers and the stream are passed as
``c_void_p``, sizes as ``c_int``, and every entry point returns
``cudaGetLastError()``, which ``launch`` turns into an exception.

``build()`` compiles several libraries at once (one ``nvcc`` process per
source, all started together); ``chip_smoke.py`` calls it before its first
phase.  Nothing is compiled or loaded when this module is imported.

Each kernel's launcher is also a registered operator, ``repro_torch::<name>``
(``register_op``): its CUDA implementation is the launcher itself, and its
fake form gives outputs of the kernel's shapes and dtypes and touches no
data, so a program that calls the kernels traces under ``FakeTensorMode``
(the dry run, ``configs.cells``).  The fake form runs only under a fake
mode; a real CUDA tensor always reaches the launcher.  Each kernel module
keeps a cost function beside its operator (``COSTS``), the FLOPs and bytes
a call costs from its shapes alone, which the dry run's accounting charges
in place of the operations inside the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# <checkout>/build/kernels — src/repro_torch/kernels/_cuda.py is 4 levels down
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gather_dist", "expand", "distance", "distance_bf16", "distance_wgmma", "tile_topk")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# Kernel launches on the card, by kernel name; a bf16 or int8 variant counts
# under its own name, and the tensor-core form of the bf16-operand pairwise
# kernel under ``pairwise_distance.bf16_wgmma`` besides.  Each wrapper adds
# one where it launches its kernel and nowhere else; the plain versions
# never count.
LAUNCHES = {
    "gather_distance": 0, "gather_distance.bf16": 0, "gather_distance.int8": 0,
    "fused_expand": 0, "fused_expand.bf16": 0, "fused_expand.int8": 0,
    "pairwise_distance": 0, "pairwise_distance.bf16": 0, "pairwise_distance.bf16_wgmma": 0,
    "tile_topk": 0,
}

# candidate-table storage type -> (the kernels' DType code in
# csrc/row_distance.cuh, the suffix of the variant's launch count)
TABLE_DTYPES = {
    torch.float32: (0, ""), torch.bfloat16: (1, ".bf16"), torch.int8: (2, ".int8"),
}

_loaded: dict = {}

# operator name -> cost(*args) of the registered kernels (``register_op``)
COSTS: dict = {}

# The operators are defined through a ``torch.library.Library``, with plain
# implementations per dispatch key: ``torch.library.custom_op``'s Python
# wrapper costs host time on every launch, which the host-bound EHC loop
# pays once per expansion (PERF.md compares the two on the card)
_LIB = torch.library.Library("repro_torch", "DEF")


def register_op(name: str, schema: str, real, fake, cost):
    """Define ``repro_torch::<name>`` by ``schema`` (writes declared in it,
    ``Tensor(a!)``): ``real``, the kernel's launcher, implements it for CUDA
    tensors and for CPU ones (which it refuses), ``fake`` for the Meta key,
    which fake tensors run; ``cost(*args)`` gives the FLOPs and bytes of one
    call (``kernel_cost``).  Returns the operator."""
    _LIB.define(name + schema)
    for key in ("CUDA", "CPU"):
        _LIB.impl(name, real, key)
    _LIB.impl(name, fake, "Meta")
    packet = getattr(torch.ops.repro_torch, name)
    COSTS[packet.default] = cost
    return packet.default


def kernel_cost(flops: float, dtype: torch.dtype, bytes_read: float, bytes_written: float) -> dict:
    """One kernel call's cost as the dry run's accounting reads it: FLOPs
    charged at the peak of ``dtype`` (the type the kernel computes in),
    bytes read and written once each."""
    return {"flops": {dtype: float(flops)}, "bytes_read": float(bytes_read),
            "bytes_written": float(bytes_written)}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and on PATH)")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> dict:
    """Compile every missing library in ``names``, all nvcc runs in parallel.

    Returns {name: library path}; raises with nvcc's output if any source
    fails to compile."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    out = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = path
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (path, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = path
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def function(lib: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of library ``lib``, built and loaded on first use."""
    key = (lib, symbol)
    if key not in _loaded:
        path = library_path(lib)
        if not path.exists():
            build([lib])
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _loaded[key] = fn
    return _loaded[key]


def launch(kernel, fn: ctypes._CFuncPtr, device: torch.device, *args,
           count: bool = True) -> None:
    """Call a C launcher on ``device``'s current stream; raise on a CUDA
    error.  ``kernel`` is the launch count's name, or a tuple of names that
    each count it (a form that also counts under its own name).
    ``count=False`` for a launch that is not the kernel's own (an empty
    kernel timed at its grid)."""
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{names[-1]}: CUDA error {err} at launch")
    if count:
        for name in names:
            LAUNCHES[name] += 1


def require_cuda(kernel: str, *tensors: Optional[torch.Tensor]) -> None:
    """Kernels take contiguous CUDA tensors on one device, nothing else
    (None stands for an operand the kernel does not read)."""
    tensors = [t for t in tensors if t is not None]
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{kernel}: needs CUDA tensors on one device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: needs contiguous tensors")


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """A tensor's device pointer; NULL for None."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def table_operands(kernel: str, x: torch.Tensor, sq_norms, row_scale):
    """Check a candidate table and its int8 operands: returns (the kernel's
    dtype code, the variant's launch-count name, the contiguous float32
    scale table or None).  int8 needs both the exact ``sq_norms`` cache and
    the ``row_scale`` table (the reference's gather_dist.py:295, :306-308)."""
    if x.dtype not in TABLE_DTYPES:
        raise ValueError(f"{kernel}: x must be float32, bfloat16 or int8, got {x.dtype}")
    code, suffix = TABLE_DTYPES[x.dtype]
    if x.dtype != torch.int8:
        return code, kernel + suffix, None
    if sq_norms is None:
        raise ValueError(f"{kernel}: int8 tables need the exact sq_norms cache")
    if row_scale is None:
        raise ValueError(f"{kernel}: int8 tables need the row_scale table")
    return code, kernel + suffix, row_scale.float().contiguous()
