// Kernel B3: kernel B1 on one rank's row strip (sm_90a), f32.
//
// Rows [r0, r0+nrows) of y = (K + c·(u∂x + v∂y)) w, from
//   w_ext       the strip of w with P halo rows on each side, (nrows+2P) × Ngy
//               (the halo exchange delivers the neighbours' boundary rows,
//               zeros beyond the grid's edges);
//   u, v        the strip's own rows, nrows × Ngy;
//   kxs, gxs    the x-band coefficients (2P+1 per row) of the strip's rows;
//   m1xs        the x mass of the strip's rows;
//   kybT, gybT  the transposed y-band coefficients, whole ((2P+1) × Ngy);
//   m1y         the y mass, whole.
//
// Replaces the TPU kernel sem_tpu/ops/pallas_kernels.py: _kernel(nby) under
// shard_map, launched by apply_system_pallas_sharded.  There each device
// swaps a 64-row half-block halo (ppermute) and runs B1's 128-row staggered
// blocks on its strip, padded to a multiple of the device count; none of
// that is carried over: the C0 band has half-width P, so the halo is P rows.
//
// Bound on the H100: the same as B1 (apply_system.cu) per node — issue- and
// latency-bound on the 2·(2P+1) L1-served loads of w per node, not on the
// ~16 bytes of device traffic.  Design: B1's, one thread per output node,
// threadIdx.x along j (coalesced loads, broadcast x-band rows), the band
// sums of band.cuh's band_sums_strip, which keep B1's loop order so that a
// strip reproduces B1's bits.
#include <cuda_runtime.h>

#include "band.cuh"

namespace {

__global__ void apply_system_strip_kernel(
    float* __restrict__ out, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ w_ext,
    const float* __restrict__ kxs, const float* __restrict__ gxs,
    const float* __restrict__ kybT, const float* __restrict__ gybT,
    const float* __restrict__ m1xs, const float* __restrict__ m1y,
    float coef, int r0, int nrows, int Ngx, int Ngy, int P)
{
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int il = blockIdx.y * blockDim.y + threadIdx.y;
    if (il >= nrows || j >= Ngy) return;
    float kx, gx, ky, gy;
    sem_tpu_torch::band_sums_strip(w_ext, kxs, gxs, kybT, gybT, il, r0 + il,
                                   j, Ngx, Ngy, P, kx, gx, ky, gy);
    const float mx = m1xs[il], my = m1y[j];
    const size_t n = (size_t)il * Ngy + j;
    out[n] = (kx * my + mx * ky) + coef * (u[n] * (gx * my)
                                           + v[n] * (mx * gy));
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int sem_apply_system_strip_f32(
    void* out, const void* u, const void* v, const void* w_ext,
    const void* kxs, const void* gxs, const void* kybT, const void* gybT,
    const void* m1xs, const void* m1y, float coef, int r0, int nrows,
    int Ngx, int Ngy, int P, void* stream)
{
    const dim3 block(32, 8);
    const dim3 grid((Ngy + block.x - 1) / block.x,
                    (nrows + block.y - 1) / block.y);
    apply_system_strip_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (float*)out, (const float*)u, (const float*)v, (const float*)w_ext,
        (const float*)kxs, (const float*)gxs, (const float*)kybT,
        (const float*)gybT, (const float*)m1xs, (const float*)m1y,
        coef, r0, nrows, Ngx, Ngy, P);
    return (int)cudaGetLastError();
}
