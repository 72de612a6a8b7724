"""Where the device time of kernel B2 at bf16 (the tensor-core kernel of
``csrc/coupled_system.cu`` and ``csrc/mma.cuh``) goes, on the card.

Run from the root of a checkout: ``python -m sem_tpu_torch.study.tc_phases``
(a CUDA card is required; the script exits non-zero without one).  It builds
patched copies of the kernel sources under the build directory
(``sem_tpu_torch.ops._build.build_dir() / "tc_phases"``), each into a
library of its own, and drives them through the same C entry point as the
port, on the inputs ``chip_smoke.py`` gives B2 at P16 64×64 (seed
``grid.N``, a 1-in-7 Dirichlet mask, ``coef`` 37):

* ``[tc_phases_clock]``: the kernel with ``clock64`` stamps taken by thread
  0 of every block at each phase boundary (copies issued, copies landed,
  rows shifted into place, band products, epilogue, stores; each phase
  ends at the block barrier that follows it), the mean and the 10th and
  90th percentiles of each phase over the blocks in SM cycles, once on the
  whole grid (1089 tiles, three blocks per SM) and once on the strip of
  rows 0..127 (132 tiles: one block per SM, no neighbour on the SM);
  ``[tc_phases_waves]`` the blocks' start times (``%globaltimer``);
* ``[tc_phases]``: device µs (a CUDA graph of 20 calls, median of 20
  replays) of the kernel and of variants that leave out one part, against
  the f32 kernel in the same call: ``no_products`` (no ldmatrix or mma),
  ``no_stores`` (no global store), ``copies_only`` (the copies and their
  wait alone).  A variant's outputs are wrong by design; only the full
  kernel is checked (against the plain version, within one bf16 ulp or
  1e-5·max|ref|).

The patches are anchored on the kernel's source text as this study
measured it: once an edit of the kernel moves an anchor, ``patched`` raises
and names it, and the patch is to be brought up to date with the kernel.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess

import numpy as np
import torch

from sem_tpu_torch.mesh import Grid2D
from sem_tpu_torch.ops import _build, kernels, sharded

SOURCES = ("coupled_system.cu", "mma.cuh", "tile.cuh")
CS = "coupled_system.cu"
_NO_PRODUCTS = [("mma.cuh", "    if (chunk_range(ib, 16,",
                 "    if (false && chunk_range(ib, 16,"),
                ("mma.cuh", "    if (chunk_range(jb, 8,",
                 "    if (false && chunk_range(jb, 8,")]
_NO_ALIGN = (CS, "    tc::align_fields<3>(L, fld, W, i0, j0, Ngx, Ngy);\n",
             "    __syncthreads();\n")
_NO_EPILOGUE = (CS, "        if (i < W.r0 || i >= W.r1) continue;\n"
                    "        const bf16* centre",
                "        if (P < 1000) continue;\n        const bf16* centre")
_NO_STORES = (CS, "        if (i >= W.r0 && i < W.r1 && j < Ngy)\n"
                  "            out[",
              "        if (P > 1000)\n            out[")
#: variant -> (file, anchor, replacement) patches
VARIANTS = {
    "full": [],
    "no_products": _NO_PRODUCTS,
    "no_stores": [_NO_STORES],
    "copies_only": [_NO_ALIGN, _NO_EPILOGUE, _NO_STORES] + _NO_PRODUCTS,
}
PHASES = ("copies_issued", "copies_landed", "rows_shifted", "products",
          "epilogue", "stores")
_STAMP = ("if (threadIdx.x == 0) tc_stamp[(blockIdx.y * gridDim.x "
          "+ blockIdx.x) * 8 + {}] = clock64();\n")
_KERNEL_END = "    }\n}\n\ntemplate <int PT>\nint launch_bf16("
#: the clock stamps (slot 7: the block's start on %globaltimer)
CLOCK = [
    (CS, "using sem_tpu_torch::mma::bf16;\n",
     "using sem_tpu_torch::mma::bf16;\n"
     "__device__ long long tc_stamp[2048 * 8];\n"),
    (CS, "    if (threadIdx.x == 0) tc::mbar_init(",
     "    if (threadIdx.x == 0) {\n        long long g;\n"
     "        asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g));\n"
     "        tc_stamp[(blockIdx.y * gridDim.x + blockIdx.x) * 8 + 7] = g;\n"
     "    }\n    " + _STAMP.format(0)
     + "    if (threadIdx.x == 0) tc::mbar_init("),
    (CS, "    tc::mbar_arrive(S.bar);\n    tc::mbar_wait(S.bar, 0);\n",
     "    " + _STAMP.format(1) + "    tc::mbar_arrive(S.bar);\n"
     "    tc::mbar_wait(S.bar, 0);\n    __syncthreads();\n    "
     + _STAMP.format(2)),
    (CS, "    float ax[3][2][4], ay[3][2][4];\n",
     "    " + _STAMP.format(3) + "    float ax[3][2][4], ay[3][2][4];\n"),
    (CS, "    __syncthreads();   // cx, cy are read: the output tile takes "
         "their place\n",
     "    __syncthreads();   // cx, cy are read: the output tile takes "
     "their place\n    " + _STAMP.format(4)),
    (CS, "    __syncthreads();\n    // a warp stores one row of an output",
     "    __syncthreads();\n    " + _STAMP.format(5)
     + "    // a warp stores one row of an output"),
    (CS, _KERNEL_END, "    }\n    __syncthreads();\n    " + _STAMP.format(6)
     + "}\n\ntemplate <int PT>\nint launch_bf16("),
]
_READ_STAMPS = ('\nextern "C" int sem_tc_stamps(void* dst)\n{\n'
                '    return (int)cudaMemcpyFromSymbol(dst, tc_stamp, '
                'sizeof(tc_stamp));\n}\n')


def patched(patches) -> dict:
    """The kernel sources with ``patches`` applied; raises if an anchor is
    missing or not unique."""
    csrc = os.path.join(os.path.dirname(_build.__file__), "..", "csrc")
    files = {f: open(os.path.join(csrc, f)).read() for f in SOURCES}
    for f, anchor, new in patches:
        if files[f].count(anchor) != 1:
            raise ValueError(f"{f}: anchor not found once: {anchor!r}")
        files[f] = files[f].replace(anchor, new)
    return files


def build_all(variants: dict) -> dict:
    """Build each variant's library (all nvcc at once); name -> CDLL."""
    root = _build.build_dir() / "tc_phases"
    procs = {}
    for name, files in variants.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(d),
             "-o", str(d / "lib.so"), str(d / CS)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        for entry in ("sem_apply_coupled_system_bf16",
                      "sem_apply_coupled_system_strip_bf16"):
            getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
        libs[name] = lib
    return libs


def device_us(fn, k=20, reps=20) -> float:
    """Device µs per call: k calls in one CUDA graph, median of reps."""
    for _ in range(3):
        fn()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        for _ in range(k):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    times = []
    for _ in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(1e3 * e0.elapsed_time(e1) / k)
    return statistics.median(times)


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("tc_phases needs a CUDA card "
                         "(torch.cuda.is_available() is false)")
    dev = torch.device("cuda", torch.cuda.current_device())
    grid = Grid2D(16, 64, 64, 1.0, 1.0)
    rng = np.random.default_rng(grid.N)
    N = grid.N

    def t(a):
        return torch.as_tensor(a, device=dev).to(torch.bfloat16)

    u, v, _ = (t(rng.standard_normal(N)) for _ in range(3))
    q = t(rng.standard_normal(3 * N))
    jac = tuple(t(rng.standard_normal(N)) for _ in range(4))
    m = np.zeros(N, bool)
    m[rng.choice(N, size=N // 7, replace=False)] = True
    mb = torch.as_tensor(m, device=dev)
    ptrs = kernels._band_ptrs(grid, dev, torch.bfloat16, blocks=True)
    coef = 37.0
    out = torch.empty_like(q)

    def whole(lib):
        fn = lib.sem_apply_coupled_system_bf16
        args = (out.data_ptr(), q.data_ptr(), u.data_ptr(), v.data_ptr(),
                *(j.data_ptr() for j in jac), mb.data_ptr(), *ptrs, coef,
                grid.Ngx, grid.Ngy, grid.P)

        def call():
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
            if err:
                raise RuntimeError(f"launch failed (cudaError {err})")
        return call

    variants = {name: patched(p) for name, p in VARIANTS.items()}
    clock = patched(CLOCK)
    clock[CS] += _READ_STAMPS
    variants["clock"] = clock
    libs = build_all(variants)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()

    ref = kernels.apply_coupled_system_plain(grid, q, u, v, jac, mb, 37.0)
    whole(libs["full"])()
    torch.cuda.synchronize()
    err = (out.double() - ref.double()).abs()
    scale = float(ref.double().abs().max())
    if not bool((err <= 2.0 ** -7 * ref.double().abs()
                 + 1e-5 * scale).all()):
        raise AssertionError("the full kernel differs from the plain "
                             "version by more than one bf16 ulp")
    f32 = [a.float() for a in (q, u, v)]
    jac32 = tuple(j.float() for j in jac)
    times = {name: device_us(whole(libs[name])) for name in VARIANTS}
    times["f32_kernel"] = device_us(
        lambda: kernels.apply_coupled_system_kernel(grid, *f32, jac32, mb,
                                                    37.0))
    print("[tc_phases] grid=P16_64x64 " + " ".join(
        f"{k}_us={v:.2f}" for k, v in times.items()) + f" smi='{smi}'",
        flush=True)

    stamps = np.zeros(2048 * 8, np.int64)
    lib = libs["clock"]

    def read(nblocks):
        torch.cuda.synchronize()
        if lib.sem_tc_stamps(ctypes.c_void_p(stamps.ctypes.data)):
            raise RuntimeError("reading the stamps failed")
        return stamps[:nblocks * 8].reshape(nblocks, 8).copy()

    def show(tag, st):
        d = np.diff(st[:, :7], axis=1)
        print(f"[tc_phases_clock] {tag} blocks={len(st)} " + " ".join(
            f"{p}={d[:, k].mean():.0f}({np.percentile(d[:, k], 10):.0f}-"
            f"{np.percentile(d[:, k], 90):.0f})"
            for k, p in enumerate(PHASES))
            + f" block_total={(st[:, 6] - st[:, 0]).mean():.0f}"
            + " unit=SM_cycles_mean(p10-p90)", flush=True)

    whole(lib)()
    st = read((grid.Ngx + 31) // 32 * ((grid.Ngy + 31) // 32))
    show("grid=P16_64x64", st)
    g = st[:, 7] - st[:, 7].min()
    hist, edges = np.histogram(g, bins=12)
    print(f"[tc_phases_waves] block_start_ns_histogram={hist.tolist()} "
          f"bin_ns={edges[1] - edges[0]:.0f}", flush=True)

    rows = (0, 128)
    n = (rows[1] - rows[0]) * grid.Ngy
    qe = sharded.strip_with_halo(grid, rows, q, 3)
    pw = [a[:n].contiguous() for a in (u, v, *jac, mb)]
    so = torch.empty(3 * n, dtype=torch.bfloat16, device=dev)
    err = lib.sem_apply_coupled_system_strip_bf16(
        so.data_ptr(), qe.data_ptr(), *(a.data_ptr() for a in pw), *ptrs,
        coef, rows[0], n // grid.Ngy, *kernels.row_window_tiles(*rows),
        grid.Ngx, grid.Ngy, grid.P,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        raise RuntimeError(f"strip launch failed (cudaError {err})")
    show("strip=0:128_one_block_per_SM", read(
        kernels.row_window_tiles(*rows)[1] * ((grid.Ngy + 31) // 32)))


if __name__ == "__main__":
    main()
