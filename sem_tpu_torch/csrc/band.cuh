// Shared device helper of the two SEM system-apply kernels (apply_system.cu,
// coupled_system.cu): the four band sums of one output node.
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

// For node (i, j) of the row-major (Ngx, Ngy) field f:
//   kx = (K1x f)[i, j],  gx = (G1x f)[i, j]    (down column j)
//   ky = (f K1yᵀ)[i, j], gy = (f G1yᵀ)[i, j]   (along row i)
// accumulated in f32.
__device__ __forceinline__ void band_sums(
    const float* __restrict__ f,
    const float* __restrict__ kxb, const float* __restrict__ gxb,
    const float* __restrict__ kybT, const float* __restrict__ gybT,
    int i, int j, int Ngx, int Ngy, int P,
    float& kx, float& gx, float& ky, float& gy)
{
    const int nb = 2 * P + 1;
    kx = 0.f; gx = 0.f; ky = 0.f; gy = 0.f;
    const int tx0 = max(0, P - i), tx1 = min(nb, Ngx + P - i);
    const float* kr = kxb + (size_t)i * nb;
    const float* gr = gxb + (size_t)i * nb;
    for (int t = tx0; t < tx1; ++t) {
        const float w = __ldg(f + (size_t)(i - P + t) * Ngy + j);
        kx = fmaf(__ldg(kr + t), w, kx);
        gx = fmaf(__ldg(gr + t), w, gx);
    }
    const int ty0 = max(0, P - j), ty1 = min(nb, Ngy + P - j);
    const size_t row = (size_t)i * Ngy;
    for (int t = ty0; t < ty1; ++t) {
        const float w = __ldg(f + row + (j - P + t));
        ky = fmaf(__ldg(kybT + (size_t)t * Ngy + j), w, ky);
        gy = fmaf(__ldg(gybT + (size_t)t * Ngy + j), w, gy);
    }
}

}  // namespace sem_tpu_torch
