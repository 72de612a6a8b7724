"""Where the device time of the tensor-core kernels B1 and B2 at bf16 (the
bf16 kernels of ``csrc/apply_system.cu`` and ``csrc/coupled_system.cu`` on
``csrc/mma.cuh``) goes, on the card.

Run from the root of a checkout: ``python -m sem_tpu_torch.study.tc_phases
[--kernels B1 B2]`` (both by default; a CUDA card is required, the script
exits non-zero without one).  It builds patched copies of each kernel's
sources under the build directory
(``sem_tpu_torch.ops._build.build_dir() / "tc_phases"``), each into a
library of its own, and drives them through the same C entry points as the
port, on the inputs ``chip_smoke.py`` gives them (seed ``grid.N``; B1 at
P16 32×32 with ``coef`` 7.5, B2 at P16 64×64 with a 1-in-7 Dirichlet mask
and ``coef`` 37):

* ``[tc_phases]``: device µs (a CUDA graph of 20 calls, median of 20
  replays) of the kernel and of variants of it, against the f32 kernel in
  the same call, for B1 on the whole grid and on rank 0's strip of two
  (B3's main-path shape): ``empty`` (each block returns before its
  copies: the launch's floor), ``no_products`` (no ldmatrix or mma),
  ``no_stores`` (no global store), ``no_band_blocks`` (no copy of the band
  blocks: what staging them costs), ``copies_only`` (the copies and their
  wait alone), and ``cta_fence`` (the mbarrier's initialization made
  visible to the copies by ``fence.proxy.async`` at the block's scope
  instead of ``fence.mbarrier_init`` at the cluster's).  The outputs of
  the variants that leave a part out are wrong by design; ``full`` and
  ``cta_fence`` are checked (against the plain version, within one bf16
  ulp or 1e-5·max|ref|);
* ``[tc_phases_clock]``: the kernel with ``clock64`` stamps taken by thread
  0 of every block at each phase boundary (copies issued, copies landed,
  rows shifted into place, band products, epilogue, stores; each phase
  ends at the block barrier that follows it), the mean and the 10th and
  90th percentiles of each phase over the blocks in SM cycles: B2 on the
  whole grid (1089 tiles, three blocks per SM) and on the strip of rows
  0..127 (132 tiles: one block per SM, no neighbour on the SM); B1 on the
  whole grid at P16 32×32 (289 tiles) and 64×64 (1089) and on rank 0's
  strip of two at 32×32 (153); ``[tc_phases_waves]`` the blocks' start
  times (``%globaltimer``) on the first of them.

The patches are anchored on the kernels' source text as this study
measured it: once an edit of a kernel moves an anchor, ``patched`` raises
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
from sem_tpu_torch.parallel import row_strips

MMA = "mma.cuh"
_NO_PRODUCTS = [(MMA, "    if (chunk_range(ib, 16,",
                 "    if (false && chunk_range(ib, 16,"),
                (MMA, "    if (chunk_range(jb, 8,",
                 "    if (false && chunk_range(jb, 8,")]
_NO_BAND_BLOCKS = [(MMA, "    if (threadIdx.x == 0) bulk_copy(L.cx,",
                    "    if (false) bulk_copy(L.cx,"),
                   (MMA, "    if (threadIdx.x == 1) bulk_copy(L.cy,",
                    "    if (false) bulk_copy(L.cy,")]
_CTA_FENCE = (MMA, '"fence.mbarrier_init.release.cluster;\\n"',
              '"fence.proxy.async.shared::cta;\\n"')
_NO_STORES = (MMA, "        if (i >= W.r0 && i < W.r1 && j < Ngy)\n"
                   "            out[",
              "        if (Ngy < 0)\n            out[")
#: the variants whose outputs are right (checked against the plain version)
RIGHT = ("full", "cta_fence")
PHASES = ("copies_issued", "copies_landed", "rows_shifted", "products",
          "epilogue", "stores")
_STAMP = ("if (threadIdx.x == 0) tc_stamp[(blockIdx.y * gridDim.x "
          "+ blockIdx.x) * 8 + {}] = clock64();\n")
_READ_STAMPS = ('\nextern "C" int sem_tc_stamps(void* dst)\n{\n'
                '    return (int)cudaMemcpyFromSymbol(dst, tc_stamp, '
                'sizeof(tc_stamp));\n}\n')

#: per kernel: its source, the number of staged fields, its mbarrier, the
#: last statement of its body, its entry points and the epilogue patch
#: (anchor, replacement) that skips the epilogue
KERNELS = {
    "B2": dict(
        source="coupled_system.cu", nf=3, bar="S.bar",
        last="    tc::store_tiles<3>(out, N, S.out, W, i0, j0, Ngy);\n}\n",
        entries=("sem_apply_coupled_system_bf16",
                 "sem_apply_coupled_system_strip_bf16"),
        no_epilogue=("        if (i < W.r0 || i >= W.r1) continue;\n"
                     "        const bf16* centre",
                     "        if (P < 1000) continue;\n"
                     "        const bf16* centre")),
    "B1": dict(
        source="apply_system.cu", nf=1, bar="bar",
        last="    tc::store_tiles<1>(out, 0, o, W, i0, j0, Ngy);\n}\n",
        entries=("sem_apply_system_bf16", "sem_apply_system_strip_bf16"),
        no_epilogue=("            const int r = 2 * h + e;\n"
                     "            store(o",
                     "            const int r = 2 * h + e;\n"
                     "            if (P < 1000) continue;\n"
                     "            store(o")),
}


def variants(k: dict) -> dict:
    """variant -> the (file, anchor, replacement) patches of kernel k."""
    src = k["source"]
    no_align = (src, f"    tc::align_fields<{k['nf']}>(L, fld, W, i0, j0, "
                     "Ngx, Ngy);\n", "    __syncthreads();\n")
    return {"full": [],
            "empty": [(src, "    if (threadIdx.x == 0) tc::mbar_init(",
                       "    if (P > 0) return;\n"
                       "    if (threadIdx.x == 0) tc::mbar_init(")],
            "no_products": _NO_PRODUCTS,
            "no_stores": [_NO_STORES],
            "no_band_blocks": _NO_BAND_BLOCKS,
            "cta_fence": [_CTA_FENCE],
            "copies_only": [no_align, (src, *k["no_epilogue"]), _NO_STORES]
            + _NO_PRODUCTS}


def clock(k: dict) -> list:
    """The clock-stamp patches of kernel k (slot 7: the block's start on
    %globaltimer).  Thread 0 stores each stamp as it takes it: held in
    registers, the stamps cost B2 a block per SM, and a static shared array
    fails B2's launch, which asks for all the dynamic shared memory a block
    may have.  So the release of the mbarrier's initialization waits for the
    first stamps' stores, and ``copies_issued`` includes that wait."""
    src, nf, bar = k["source"], k["nf"], k["bar"]
    return [
        (src, "using sem_tpu_torch::mma::bf16;\n",
         "using sem_tpu_torch::mma::bf16;\n"
         "__device__ long long tc_stamp[2048 * 8];\n"),
        (src, "    if (threadIdx.x == 0) tc::mbar_init(",
         "    if (threadIdx.x == 0) {\n        long long g;\n"
         "        asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g));\n"
         "        tc_stamp[(blockIdx.y * gridDim.x + blockIdx.x) * 8 + 7] = g;"
         "\n    }\n    " + _STAMP.format(0)
         + "    if (threadIdx.x == 0) tc::mbar_init("),
        (src, f"    tc::mbar_arrive({bar});\n",
         "    " + _STAMP.format(1) + f"    tc::mbar_arrive({bar});\n"),
        (src, f"    tc::mbar_wait({bar}, 0);\n",
         f"    tc::mbar_wait({bar}, 0);\n    __syncthreads();\n    "
         + _STAMP.format(2)),
        (src, f"    float ax[{nf}][2][4], ay[{nf}][2][4];\n",
         "    " + _STAMP.format(3)
         + f"    float ax[{nf}][2][4], ay[{nf}][2][4];\n"),
        (src, "    __syncthreads();   // cx, cy are read: the output tile "
              "takes their place\n",
         "    __syncthreads();   // cx, cy are read: the output tile takes "
         "their place\n    " + _STAMP.format(4)),
        (src, "    __syncthreads();\n    tc::store_tiles<",
         "    __syncthreads();\n    " + _STAMP.format(5)
         + "    tc::store_tiles<"),
        (src, k["last"], k["last"][:-2] + "    __syncthreads();\n    "
         + _STAMP.format(6) + "}\n"),
    ]


def patched(source: str, patches) -> dict:
    """The sources of the kernel in ``source`` (with the headers it
    includes) with ``patches`` applied; raises if an anchor is missing or
    not unique."""
    csrc = os.path.join(os.path.dirname(_build.__file__), "..", "csrc")
    files = {f: open(os.path.join(csrc, f)).read()
             for f in (source, MMA, "tile.cuh")}
    for f, anchor, new in patches:
        if files[f].count(anchor) != 1:
            raise ValueError(f"{f}: anchor not found once: {anchor!r}")
        files[f] = files[f].replace(anchor, new)
    return files


def build_all(source: str, entries, libs_src: dict) -> dict:
    """Build each variant's library of ``source`` (all nvcc at once); name
    -> CDLL with the argument types of ``entries``."""
    root = _build.build_dir() / "tc_phases" / source.split(".")[0]
    procs = {}
    for name, files in libs_src.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(d),
             "-o", str(d / "lib.so"), str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        for entry in entries:
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


class Case:
    """One launch shape of a kernel: ``call(lib)`` launches it through lib's
    entry point (whole grid or row strip), ``plain()`` is its plain
    version's output, ``f32()`` the f32 kernel on the same inputs,
    ``ntiles`` its blocks."""

    def __init__(self, tag, call, out, plain, f32, ntiles):
        self.tag, self.call, self.out = tag, call, out
        self.plain, self.f32, self.ntiles = plain, f32, ntiles


def _launcher(fn, args, dev):
    def call():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
        if err:
            raise RuntimeError(f"launch failed (cudaError {err})")
    return call


def b2_cases(dev) -> list:
    """B2 whole grid at P16 64×64 (timed) and its rows 0..127 (clock)."""
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
    ptrs = kernels._band_ptrs(grid, dev, torch.bfloat16)
    out = torch.empty_like(q)
    ntc = (grid.Ngy + 31) // 32

    def whole(lib):
        return _launcher(lib.sem_apply_coupled_system_bf16, (
            out.data_ptr(), q.data_ptr(), u.data_ptr(), v.data_ptr(),
            *(j.data_ptr() for j in jac), mb.data_ptr(), *ptrs, 37.0,
            grid.Ngx, grid.Ngy, grid.P), dev)

    rows = (0, 128)
    n = (rows[1] - rows[0]) * grid.Ngy
    qe = sharded.strip_with_halo(grid, rows, q, 3)
    pw = [a[:n].contiguous() for a in (u, v, *jac, mb)]
    so = torch.empty(3 * n, dtype=torch.bfloat16, device=dev)

    def strip(lib):
        return _launcher(lib.sem_apply_coupled_system_strip_bf16, (
            so.data_ptr(), qe.data_ptr(), *(a.data_ptr() for a in pw),
            *ptrs, 37.0, rows[0], n // grid.Ngy,
            *kernels.row_window_tiles(*rows), grid.Ngx, grid.Ngy, grid.P),
            dev)

    f32 = [a.float() for a in (q, u, v)]
    jac32 = tuple(j.float() for j in jac)
    return [
        Case(f"grid={grid.tag}", whole, out,
             lambda: kernels.apply_coupled_system_plain(grid, q, u, v, jac,
                                                        mb, 37.0),
             lambda: kernels.apply_coupled_system_kernel(grid, *f32, jac32,
                                                         mb, 37.0),
             (grid.Ngx + 31) // 32 * ntc),
        Case("strip=0:128_one_block_per_SM", strip, so, None, None,
             kernels.row_window_tiles(*rows)[1] * ntc)]


def b1_cases(dev) -> list:
    """B1 whole grid at P16 32×32 and B3 on rank 0's strip of two there
    (timed), and B1 at P16 64×64 (clock)."""
    cases = []
    for grid in (Grid2D(16, 32, 32, 1.0, 1.0), Grid2D(16, 64, 64, 1.0, 1.0)):
        rng = np.random.default_rng(grid.N)
        u, v, w = (torch.as_tensor(rng.standard_normal(grid.N), device=dev
                                   ).to(torch.bfloat16) for _ in range(3))
        ptrs = kernels._band_ptrs(grid, dev, torch.bfloat16)
        ntc = (grid.Ngy + 31) // 32
        out = torch.empty_like(w)
        f32 = [a.float() for a in (u, v, w)]

        def whole(lib, out=out, u=u, v=v, w=w, ptrs=ptrs, grid=grid):
            return _launcher(lib.sem_apply_system_bf16, (
                out.data_ptr(), u.data_ptr(), v.data_ptr(), w.data_ptr(),
                *ptrs, 7.5, grid.Ngx, grid.Ngy, grid.P), dev)

        cases.append(Case(
            f"grid={grid.tag}", whole, out,
            lambda grid=grid, u=u, v=v, w=w: kernels.apply_system_plain(
                grid, u, v, w, 7.5),
            lambda grid=grid, f32=f32: kernels.apply_system_kernel(
                grid, *f32, 7.5),
            (grid.Ngx + 31) // 32 * ntc))
        if grid.N_ex != 32:
            continue
        rows = row_strips(grid.Ngx, 2, grid.P)[0]
        sl = slice(rows[0] * grid.Ngy, rows[1] * grid.Ngy)
        a = (grid, rows, u[sl], v[sl],
             sharded.strip_with_halo(grid, rows, w))
        a32 = (grid, rows, f32[0][sl], f32[1][sl],
               sharded.strip_with_halo(grid, rows, f32[2]))
        so = torch.empty_like(a[2])

        def strip(lib, so=so, a=a, ptrs=ptrs, grid=grid, rows=rows):
            return _launcher(lib.sem_apply_system_strip_bf16, (
                so.data_ptr(), a[2].data_ptr(), a[3].data_ptr(),
                a[4].data_ptr(), *ptrs, 7.5, rows[0], rows[1] - rows[0],
                *kernels.row_window_tiles(*rows), grid.Ngx, grid.Ngy,
                grid.P), dev)

        cases.append(Case(
            f"strip={rows[0]}:{rows[1]}_of_{grid.tag}", strip, so,
            lambda a=a: sharded.apply_system_sharded_plain(*a, 7.5),
            lambda a32=a32: sharded.apply_system_sharded(*a32, 7.5),
            kernels.row_window_tiles(*rows)[1] * ntc))
    return cases


def run(name: str, dev, smi: str) -> None:
    """Every measurement of kernel ``name`` (module docstring)."""
    k = KERNELS[name]
    cases = (b1_cases if name == "B1" else b2_cases)(dev)
    srcs = {v: patched(k["source"], p) for v, p in variants(k).items()}
    clk = patched(k["source"], clock(k))
    clk[k["source"]] += _READ_STAMPS
    srcs["clock"] = clk
    libs = build_all(k["source"], k["entries"], srcs)

    for case in cases:
        if case.plain is None:
            continue
        ref = case.plain()
        for v in RIGHT:
            case.call(libs[v])()
            torch.cuda.synchronize()
            err = (case.out.double() - ref.double()).abs()
            scale = float(ref.double().abs().max())
            if not bool((err <= 2.0 ** -7 * ref.double().abs()
                         + 1e-5 * scale).all()):
                raise AssertionError(f"{name} {case.tag}: the {v} kernel "
                                     f"differs from the plain version by "
                                     f"more than one bf16 ulp")
        if name == "B1" and "64x64" in case.tag:
            continue                      # clock only
        times = {v: device_us(case.call(libs[v])) for v in variants(k)}
        times["f32_kernel"] = device_us(case.f32)
        print(f"[tc_phases] kernel={name} {case.tag} " + " ".join(
            f"{key}_us={val:.2f}" for key, val in times.items())
            + f" smi='{smi}'", flush=True)

    stamps = np.zeros(2048 * 8, np.int64)
    lib = libs["clock"]
    for n, case in enumerate(cases):
        case.call(lib)()
        torch.cuda.synchronize()
        if lib.sem_tc_stamps(ctypes.c_void_p(stamps.ctypes.data)):
            raise RuntimeError("reading the stamps failed")
        st = stamps[:case.ntiles * 8].reshape(case.ntiles, 8).copy()
        d = np.diff(st[:, :7], axis=1)
        print(f"[tc_phases_clock] kernel={name} {case.tag} blocks={len(st)} "
              + " ".join(
                  f"{p}={d[:, i].mean():.0f}({np.percentile(d[:, i], 10):.0f}"
                  f"-{np.percentile(d[:, i], 90):.0f})"
                  for i, p in enumerate(PHASES))
              + f" block_total={(st[:, 6] - st[:, 0]).mean():.0f}"
              + " unit=SM_cycles_mean(p10-p90)", flush=True)
        if n == 0:
            g = st[:, 7] - st[:, 7].min()
            hist, edges = np.histogram(g, bins=12)
            print(f"[tc_phases_waves] kernel={name} {case.tag} "
                  f"block_start_ns_histogram={hist.tolist()} "
                  f"bin_ns={edges[1] - edges[0]:.0f}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", nargs="+", choices=sorted(KERNELS),
                    default=["B1", "B2"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tc_phases needs a CUDA card "
                         "(torch.cuda.is_available() is false)")
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for name in args.kernels:
        run(name, dev, smi)


if __name__ == "__main__":
    main()
