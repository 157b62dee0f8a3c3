"""Build and load the port's native code at first use: the CUDA kernels
(csrc/*.cu) and the host-side bitstream parser (runtime/*.c).

A kernel source is compiled by nvcc for sm_90a, a host source by the host C
compiler, each into a shared library with a plain C interface that is
loaded with ctypes.  The library's file name carries a hash of the source
and the flags, so an edited source is never served by a stale build.
Libraries go to build/icspcodec_torch/ at the root of the checkout
(.gitignore lists build/).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
RUNTIME = _PKG / "runtime"
BUILD_DIR = _PKG.parent / "build" / "icspcodec_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_CC_FLAGS = ["-O2", "-shared", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use "
                       "and need the CUDA toolkit")


def host_cc() -> str:
    for cand in ("cc", "gcc"):
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C compiler (cc or gcc) found: the bitstream parser "
                       "is built at first use")


def _source(name: str):
    """(source path, flags) of a name: csrc/<name>.cu, else runtime/<name>.c."""
    cu = CSRC / f"{name}.cu"
    if cu.exists():
        return cu, NVCC_FLAGS
    return RUNTIME / f"{name}.c", HOST_CC_FLAGS


def _target(name: str) -> pathlib.Path:
    src, flags = _source(name)
    tag = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str):
    """Start the compiler for the named source unless its library exists;
    returns (target, process or None)."""
    out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    src, flags = _source(name)
    compiler = nvcc() if src.suffix == ".cu" else host_cc()
    cmd = [compiler, *flags, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(name: str, out: pathlib.Path, job) -> str:
    if job is None:
        return ""
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"building {_source(name)[0].name} failed:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build sees the old file or the new, never half
    return log


def build(names) -> dict[str, str]:
    """Compile the named sources, all compiler processes at once; returns
    each one's compiler output ("" when the library was already built)."""
    jobs = {n: _start(n) for n in names}
    return {n: _finish(n, out, job) for n, (out, job) in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of the named source, built first if needed."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
