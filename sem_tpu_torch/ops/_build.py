"""Build and load the hand-written CUDA kernels of the package.

The ``.cu`` files under ``sem_tpu_torch/csrc`` have a plain C interface.  At
first use, :func:`library` compiles them with ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and links them into one
shared library under ``build/sem_tpu_torch/`` at the root of the checkout
(git-ignored; ``SEM_TPU_TORCH_BUILD_DIR`` overrides it), named by a hash of the
sources and flags, and loads it with ``ctypes``.  A later process with the same
sources loads the existing library without compiling.  Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

__all__ = ["library", "build_dir", "NVCC_FLAGS", "last_build_seconds"]

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

#: wall seconds of the compile in this process (0.0 when the library was
#: already built); set by :func:`library`
last_build_seconds = 0.0

# ctypes signatures of the C entry points: every pointer and the stream are
# c_void_p (a bare Python int would be passed as a 32-bit int), the return
# value is the cudaError_t of the launch
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # out, u, v, w, kgx, kgy, m1x, m1y, coef, Ngx, Ngy, P, stream
    "sem_apply_system_f32": [_P] * 8 + [_F, _I, _I, _I, _P],
    # out, q, ul, vl, jxx, jxy, jyx, jyy, mb, kgx, kgy, m1x, m1y, coef, Ngx,
    # Ngy, P, stream
    "sem_apply_coupled_system_f32": [_P] * 13 + [_F, _I, _I, _I, _P],
    # out, u, v, w_ext, kgx, kgy, m1x, m1y, coef, r0, nrows, tile0, ntiles,
    # Ngx, Ngy, P, stream
    "sem_apply_system_strip_f32": [_P] * 8 + [_F] + [_I] * 7 + [_P],
    # out, q_ext, ul, vl, jxx, jxy, jyx, jyy, mb, kgx, kgy, m1x, m1y, coef,
    # r0, nrows, tile0, ntiles, Ngx, Ngy, P, stream
    "sem_apply_coupled_system_strip_f32": [_P] * 13 + [_F] + [_I] * 7 + [_P],
}
# the bf16 entry points take the same arguments: bf16 fields and outputs,
# the bf16 band blocks bx, by in the place of kgx, kgy, and bf16-rounded f32
# masses
_SIGNATURES.update({name[:-3] + "bf16": args
                    for name, args in list(_SIGNATURES.items())})
# P, out[3]: the tensor-core kernels' staged geometry (mma.cuh)
_SIGNATURES["sem_mma_geometry"] = [_I, _P]
# params (a PassParams, ops/gemm.py's _PassParams), merge, grid, stream
_SIGNATURES["sem_evenodd_pass_f32"] = [_P, _I, _I, _P]


def build_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get(
        "SEM_TPU_TORCH_BUILD_DIR",
        _CSRC.parent.parent / "build" / "sem_tpu_torch"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of sem_tpu_torch "
                       "need the CUDA toolkit (set CUDA_HOME)")


def _run_all(cmds):
    """Start every command at once and wait for all; raise with the output
    of the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; raises on failure."""
    global last_build_seconds
    sources = sorted(_CSRC.glob("*.cu"))
    headers = sorted(_CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out_dir = build_dir()
    lib_path = out_dir / f"libsem_tpu_torch_{h.hexdigest()[:16]}.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = f"tmp{os.getpid()}"
        tmp = lib_path.with_suffix(f".{tag}.so")
        t0 = time.perf_counter()
        nvcc = _nvcc()
        objs = [out_dir / f"{src.stem}.{h.hexdigest()[:16]}.{tag}.o"
                for src in sources]
        _run_all([[nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c", str(src),
                   "-o", str(obj)] for src, obj in zip(sources, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        for obj in objs:
            obj.unlink()
        os.replace(tmp, lib_path)
        last_build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
