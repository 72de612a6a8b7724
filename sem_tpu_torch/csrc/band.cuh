// Device helper of the row-strip system-apply kernels B3/B4
// (apply_system_strip.cu, coupled_system_strip.cu): the four band sums of
// one output node, one thread per node over every tap of the band (the
// untiled design, which B1/B2 ran first; the whole-grid kernels now use the
// tiled sums of tile.cuh, which give the same bits).
//
// The assembled 1D operators K1x, G1x, K1y, G1y of the C0 spectral-element
// grid are banded with half-band P (an interface row couples the two
// elements that share it).  Each is stored compactly, built on the host:
//   x-direction  AB[i*(2P+1) + t]  = A[i, i-P+t]       (row-major, one row per i)
//   y-direction  ABT[t*Ngy + j]    = A[j, j-P+t]       (transposed, so that the
//                                                      threads of a warp, which
//                                                      walk along j, read
//                                                      neighbouring addresses)
// with zeros where i-P+t (j-P+t) falls outside the grid.
#pragma once

#include <cuda_runtime.h>

namespace sem_tpu_torch {

// For node (i, j) of a row strip holding global rows r0..r0+nrows-1
// (i = r0 + il):
//   kx = (K1x f)[i, j],  gx = (G1x f)[i, j]    (down column j)
//   ky = (f K1yᵀ)[i, j], gy = (f G1yᵀ)[i, j]   (along row i)
// accumulated in f32, taps in ascending order.
//   f_ext     the strip's field with P halo rows on each side, row-major
//             ((nrows + 2P) × Ngy): global row g sits at row g - r0 + P; halo
//             rows beyond the grid's edges are zero (and never read)
//   kxs, gxs  the x-band coefficient rows of the strip (row il ↔ global i)
// The loop bounds come from the global row i, so with r0 = 0, nrows = Ngx
// this is the whole grid.
__device__ __forceinline__ void band_sums_strip(
    const float* __restrict__ f_ext,
    const float* __restrict__ kxs, const float* __restrict__ gxs,
    const float* __restrict__ kybT, const float* __restrict__ gybT,
    int il, int i, int j, int Ngx, int Ngy, int P,
    float& kx, float& gx, float& ky, float& gy)
{
    const int nb = 2 * P + 1;
    kx = 0.f; gx = 0.f; ky = 0.f; gy = 0.f;
    const int tx0 = max(0, P - i), tx1 = min(nb, Ngx + P - i);
    const float* kr = kxs + (size_t)il * nb;
    const float* gr = gxs + (size_t)il * nb;
    for (int t = tx0; t < tx1; ++t) {
        // global row i-P+t is strip row il+t of f_ext
        const float w = __ldg(f_ext + (size_t)(il + t) * Ngy + j);
        kx = fmaf(__ldg(kr + t), w, kx);
        gx = fmaf(__ldg(gr + t), w, gx);
    }
    const int ty0 = max(0, P - j), ty1 = min(nb, Ngy + P - j);
    const size_t row = (size_t)(il + P) * Ngy;
    for (int t = ty0; t < ty1; ++t) {
        const float w = __ldg(f_ext + row + (j - P + t));
        ky = fmaf(__ldg(kybT + (size_t)t * Ngy + j), w, ky);
        gy = fmaf(__ldg(gybT + (size_t)t * Ngy + j), w, gy);
    }
}

}  // namespace sem_tpu_torch
