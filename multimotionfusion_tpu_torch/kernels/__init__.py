"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled at first use into its own shared library
with a plain C interface (one ``nvcc`` per source, all started together; the
shared ``csrc/*.cuh`` headers are part of every source's build key)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -Xptxas -v -shared -Xcompiler -fPIC \
         -o build/mmf_torch_kernels/<name>-<hash>.so csrc/<name>.cu

and loaded with ``ctypes``. ``-fmad=false`` keeps every ``a * b + c`` rounded
twice, as PyTorch's separate elementwise ops round it, so a kernel and its
plain version agree to the last bit wherever they evaluate the same
expression in the same order (the kernels are bound by memory, not by
arithmetic). ``BUILD_LOG`` keeps each compiler's output (registers, spills).
Each C entry point enqueues its kernels on the stream it is given (PyTorch's
current stream), allocates nothing and returns ``cudaGetLastError()``;
``call`` raises when that is not 0.

``LAUNCHES`` counts, per kernel, the wrapper calls that went to the CUDA kernel
(incremented only where a wrapper launches). ``start_capture`` /
``stop_capture`` let a caller record the first set of inputs each wrapper sees,
to replay them against the plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "mmf_torch_kernels"

# kernel name -> launches through its CUDA wrapper
LAUNCHES: Dict[str, int] = {}
# kernel key -> recorded inputs, or None while no capture is running
_captured: Optional[Dict[str, dict]] = None
_capture_keys: Optional[frozenset] = None  # the keys a capture records (None: every key)

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}  # (library, entry point) -> ctypes function, typed
BUILD_LOG: Dict[str, str] = {}

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_long  # a C long (64 bits): strides that may exceed 2^31
F = ctypes.c_float
D = ctypes.c_double


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")


def build_all() -> float:
    """Compile (in parallel) and load every ``csrc/*.cu``; returns seconds taken."""
    t0 = time.time()
    sources = sorted(CSRC.glob("*.cu"))
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    todo = []
    for src in sources:
        if src.stem in _libs:
            continue
        digest = hashlib.sha1(src.read_bytes() + headers).hexdigest()[:12]
        out = BUILD_DIR / f"{src.stem}-{digest}.so"
        todo.append((src, out))
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src, out in todo:
        if out.exists():
            procs.append((src, out, None))
            continue
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
            "-o", str(out) + ".tmp", str(src),
        ]
        procs.append((src, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, out, proc in procs:
        if proc is not None:
            log, _ = proc.communicate()
            BUILD_LOG[src.stem] = log
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
                continue
            os.replace(str(out) + ".tmp", out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    for src, out, _ in procs:
        _libs[src.stem] = ctypes.CDLL(str(out))
    return time.time() - t0


def fn(lib: str, name: str, argtypes):
    """ctypes entry point ``name`` of ``csrc/<lib>.cu`` (built on first use),
    its argument types set once per loaded library."""
    if lib not in _libs:
        build_all()
    so = _libs[lib]
    f = _fns.get((so, name))
    if f is None:
        f = getattr(so, name)
        f.argtypes = list(argtypes) + [P]  # every entry point ends with the stream
        f.restype = I
        _fns[(so, name)] = f
    return f


def call(kernel: str, f, *args) -> None:
    """Launch ``f(*args, stream)``, raise on a CUDA error, count the launch."""
    err = f(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: cudaError {err}")
    LAUNCHES[kernel] = LAUNCHES.get(kernel, 0) + 1


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def check(t: torch.Tensor, dtype, name: str, contiguous: bool = True) -> None:
    """Validate a tensor handed to a kernel."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_SCRATCH: Dict[tuple, torch.Tensor] = {}


def scratch(name: str, n: int, dtype, device, fill=0) -> torch.Tensor:
    """The first ``n`` elements of a persistent buffer of ``device`` named
    ``name``: made with ``fill``, and made anew with ``fill`` when a call
    needs more. The kernel that uses it states what it holds between calls."""
    key = (name, torch.device(device))
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n or buf.dtype != dtype:
        buf = torch.full((max(n, 1),), fill, dtype=dtype, device=device)
        _SCRATCH[key] = buf
    return buf[:n]


def reset_launches() -> None:
    for k in list(LAUNCHES):
        LAUNCHES[k] = 0


def start_capture(keys=None) -> None:
    """Record the first inputs each wrapper sees until ``stop_capture``;
    with ``keys``, only those wrappers' inputs."""
    global _captured, _capture_keys
    _captured, _capture_keys = {}, None if keys is None else frozenset(keys)


def stop_capture() -> Dict[str, dict]:
    global _captured
    out, _captured = _captured or {}, None
    return out


def _snapshot(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, tuple) and hasattr(v, "_fields"):  # NamedTuple of tensors
        return type(v)(*(_snapshot(x) for x in v))
    if isinstance(v, (list, tuple)):
        return type(v)(_snapshot(x) for x in v)
    return v


def capturing(key: str) -> bool:
    """True while a capture runs that records ``key``'s first inputs (a
    wrapper may then compute inputs it records)."""
    return _captured is not None and key not in _captured and (
        _capture_keys is None or key in _capture_keys)


def record(key: str, **inputs) -> None:
    """Called by a wrapper with its inputs; stores clones while capturing."""
    if not capturing(key):
        return
    _captured[key] = {k: _snapshot(v) for k, v in inputs.items()}
