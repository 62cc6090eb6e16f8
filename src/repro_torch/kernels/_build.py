"""Build and load the CUDA kernels of ``csrc/`` at first use.

Every ``csrc/*.cu`` file compiles with its own ``nvcc`` process, all
started together, into an object file; one more ``nvcc`` links them into a
shared library with a plain C interface, loaded with ``ctypes``. No
PyTorch header is compiled, so a build takes seconds. The library goes
into ``build/`` at the repository root under a name keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
loaded as it is. Nothing here runs when the package is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
# every entry returns cudaGetLastError() after its launch
_SIGNATURES = {
    "sam_scatter_workspace_f32": [_P, _P, _P, _LL, _I, _I, _I, _P],
    "sam_scatter_workspace_f64": [_P, _P, _P, _LL, _I, _I, _I, _P],
    "sam_segment_reduce_f32": [_P, _P, _P, _LL, _I, _I, _P],
    "sam_segment_reduce_f64": [_P, _P, _P, _LL, _I, _I, _P],
    "sam_segment_reduce_mul_f32": [_P, _P, _P, _P, _P, _LL, _I, _P],
    "sam_segment_reduce_mul_f64": [_P, _P, _P, _P, _P, _LL, _I, _P],
    "sam_fused_imr_f32": [_P, _P, _P, _P, _P, _P, _LL, _LL, _P],
    "sam_fused_imr_f64": [_P, _P, _P, _P, _P, _P, _LL, _LL, _P],
    "sam_spmm_bsr_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _I, _P],
    "sam_spmm_bsr_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _I, _P],
    "sam_spmm_bsr_tc_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _I, _P],
    "sam_spmm_bsr_tc_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _I,
                             _P],
    "sam_sddmm_bsr_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _P],
    "sam_sddmm_bsr_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _P],
    "sam_sddmm_bsr_tc_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _P],
    "sam_sddmm_bsr_tc_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _P],
    "sam_bsr_attention_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _F, _I, _P],
    "sam_bsr_attention_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _F, _I, _P],
    "sam_bsr_attention_tc_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _F, _I, _P],
    "sam_bsr_attention_tc_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _F, _I, _P],
    "sam_coo_levels": [_P, _P, _LL, _I, _LL, _P, _P, _P, _P],
}

_LOCK = threading.Lock()
_LIB = None
# per-source compiler output (ptxas register/spill lines) of this
# process's build; empty when the library was already built
BUILD_LOG: Dict[str, str] = {}


def acc_dtype(dtype, kernel: str):
    """The type a kernel accumulates in: float64 for float64 payloads (the
    kernels' double instantiation), float32 for float32/float16/bfloat16
    (as the reference accumulates), and no integer payloads at all."""
    if dtype == torch.float64:
        return torch.float64
    if dtype in (torch.float32, torch.float16, torch.bfloat16):
        return torch.float32
    raise TypeError(f"{kernel} takes float payloads, not {dtype}")


def sources() -> List[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libsam_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def build() -> pathlib.Path:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((src, obj, proc))
        errors = []
        for src, _, proc in jobs:
            log, _ = proc.communicate()
            BUILD_LOG[src.name] = log
            if proc.returncode:
                errors.append(f"--- {src.name}\n{log}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_so = os.path.join(tmp, out.name)
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *(o for _, o, _ in jobs),
             "-o", tmp_so], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_so, out)       # atomic: a reader never sees half a file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def call(name: str, device: torch.device, *args) -> None:
    """Launch one kernel entry on ``device`` (its operands' CUDA device),
    on that device's current stream, whichever device is current in the
    calling thread; raise on error. The entry launches on the thread's
    current device, so it is made ``device`` for the launch."""
    fn = getattr(library(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")
