// Kernel B4: kernel B2 (the NS tangent saddle matvec) on one rank's row
// strip (sm_90a), f32.
//
// Rows [r0, r0+nrows) of (dru, drv, drc) (see coupled_system.cu), from
//   q_ext       du, dv, dp stacked, each the strip with P halo rows on each
//               side: 3 × (nrows+2P) × Ngy;
//   ul, vl, jxx, jxy, jyx, jyy, mb
//               the strip's own rows (nrows × Ngy each): the linearization
//               fields need no halo;
//   kxs, gxs, m1xs  the strip's x-band coefficient rows and x mass;
//   kybT, gybT, m1y the y-direction constants, whole.
// Output: dru | drv | drc of the strip's rows, 3 × nrows × Ngy (the local
// layout of the decomposed Krylov vector).  Dirichlet rows (mb) follow B2:
// du, dv, and K dp.  The pressure-pin row is the caller's.
//
// Replaces the TPU kernel sem_tpu/ops/pallas_kernels.py: _coupled_kernel()
// under shard_map, launched by apply_coupled_system_pallas_sharded (64-row
// ppermute halos of du/dv/dp around 128×128 staggered tiles; not carried
// over: the halo here is the band's half-width P).
//
// Bound on the H100: as B2, device traffic of ~49 bytes per node and
// 6·(2P+1) L1-served band taps.  Design: B2's, one thread per node,
// threadIdx.x along j, with the band sums of band.cuh's band_sums_strip
// (B2's loop order, so a strip reproduces B2's bits) and the Jacobian and
// mask epilogue in registers.
#include <cuda_runtime.h>

#include "band.cuh"

namespace {

__global__ void coupled_system_strip_kernel(
    float* __restrict__ out, const float* __restrict__ q_ext,
    const float* __restrict__ ul, const float* __restrict__ vl,
    const float* __restrict__ jxx, const float* __restrict__ jxy,
    const float* __restrict__ jyx, const float* __restrict__ jyy,
    const unsigned char* __restrict__ mb,
    const float* __restrict__ kxs, const float* __restrict__ gxs,
    const float* __restrict__ kybT, const float* __restrict__ gybT,
    const float* __restrict__ m1xs, const float* __restrict__ m1y,
    float coef, int r0, int nrows, int Ngx, int Ngy, int P)
{
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int il = blockIdx.y * blockDim.y + threadIdx.y;
    if (il >= nrows || j >= Ngy) return;
    const int i = r0 + il;
    const size_t Ne = (size_t)(nrows + 2 * P) * Ngy;  // one extended field
    const size_t Nl = (size_t)nrows * Ngy;            // one strip field
    const float* du = q_ext;
    const float* dv = q_ext + Ne;
    const float* dp = q_ext + 2 * Ne;
    float kxu, gxu, kyu, gyu, kxv, gxv, kyv, gyv, kxp, gxp, kyp, gyp;
    sem_tpu_torch::band_sums_strip(du, kxs, gxs, kybT, gybT, il, i, j, Ngx,
                                   Ngy, P, kxu, gxu, kyu, gyu);
    sem_tpu_torch::band_sums_strip(dv, kxs, gxs, kybT, gybT, il, i, j, Ngx,
                                   Ngy, P, kxv, gxv, kyv, gyv);
    sem_tpu_torch::band_sums_strip(dp, kxs, gxs, kybT, gybT, il, i, j, Ngx,
                                   Ngy, P, kxp, gxp, kyp, gyp);
    const float mx = m1xs[il], my = m1y[j];
    const size_t n = (size_t)il * Ngy + j;              // strip-local node
    const size_t c = (size_t)(il + P) * Ngy + j;        // same node in q_ext
    const float dun = du[c], dvn = dv[c];
    if (mb[n]) {
        out[n] = dun;
        out[Nl + n] = dvn;
        out[2 * Nl + n] = kxp * my + mx * kyp;
        return;
    }
    // mass-weighted products, as in the dense reference path
    const float Ku = kxu * my + mx * kyu, Kv = kxv * my + mx * kyv;
    const float gxu_ = gxu * my, gyu_ = mx * gyu;
    const float gxv_ = gxv * my, gyv_ = mx * gyv;
    const float uln = ul[n], vln = vl[n];
    out[n] = Ku + coef * (uln * gxu_ + vln * gyu_)
        + jxx[n] * dun + jxy[n] * dvn + gxp * my;
    out[Nl + n] = Kv + coef * (uln * gxv_ + vln * gyv_)
        + jyx[n] * dun + jyy[n] * dvn + mx * gyp;
    out[2 * Nl + n] = gxu_ + gyv_;
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int sem_apply_coupled_system_strip_f32(
    void* out, const void* q_ext, const void* ul, const void* vl,
    const void* jxx, const void* jxy, const void* jyx, const void* jyy,
    const void* mb, const void* kxs, const void* gxs, const void* kybT,
    const void* gybT, const void* m1xs, const void* m1y, float coef,
    int r0, int nrows, int Ngx, int Ngy, int P, void* stream)
{
    const dim3 block(32, 8);
    const dim3 grid((Ngy + block.x - 1) / block.x,
                    (nrows + block.y - 1) / block.y);
    coupled_system_strip_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (float*)out, (const float*)q_ext, (const float*)ul,
        (const float*)vl, (const float*)jxx, (const float*)jxy,
        (const float*)jyx, (const float*)jyy, (const unsigned char*)mb,
        (const float*)kxs, (const float*)gxs, (const float*)kybT,
        (const float*)gybT, (const float*)m1xs, (const float*)m1y, coef,
        r0, nrows, Ngx, Ngy, P);
    return (int)cudaGetLastError();
}
