// Kernel B2: the Navier-Stokes tangent saddle matvec on Hopper (sm_90a), f32.
//
// For q = (du, dv, dp) with the frozen linearization (ul, vl), the convection
// Jacobian diagonals (jxx, jxy, jyx, jyy) and the Dirichlet-row mask mb:
//   dru = K du + c(ul·Gx du + vl·Gy du) + jxx du + jxy dv + Gx dp
//   drv = K dv + c(ul·Gx dv + vl·Gy dv) + jyx du + jyy dv + Gy dp
//   drc = Gx du + Gy dv
// and on Dirichlet rows (mb) dru = du, drv = dv, drc = K dp (the artificial
// ∂ₙp = 0 rows).  The pressure-pin row is left to the caller.  Output is the
// stacked (3N,) vector dru | drv | drc.
//
// Replaces the TPU kernel sem_tpu/ops/pallas_kernels.py: _coupled_kernel(),
// launched by apply_coupled_system_pallas (a 2D grid of 128×128 tiles with
// 64-row staggered band blocks, shaped for the MXU; not carried over).
//
// What bounds it on the H100: device memory traffic.  Per node it reads 9
// f32 fields (du, dv, dp, ul, vl, jxx, jxy, jyx, jyy) and the 1-byte mask and
// writes 3 fields: ~49 bytes, against 12·(2P+1) multiply-adds (396 at P=16,
// ~16 flop/byte, near the card's f32 balance).  An ideal apply at p16 64×64
// moves ~52 MB, ~15 µs at 3.35 TB/s.  The 6·(2P+1) band taps per node hit
// L1/L2, as in kernel B1.
//
// Design: as kernel B1 (band.cuh) — one thread per node, threadIdx.x along
// j, coalesced loads, transposed y-band coefficients — with the band sums of
// the three fields, the Jacobian-diagonal terms and the row mask all applied
// in registers, so each input is read once from device memory and each
// output written once.
#include <cuda_runtime.h>

#include "band.cuh"

namespace {

__global__ void coupled_system_kernel(
    float* __restrict__ out, const float* __restrict__ q,
    const float* __restrict__ ul, const float* __restrict__ vl,
    const float* __restrict__ jxx, const float* __restrict__ jxy,
    const float* __restrict__ jyx, const float* __restrict__ jyy,
    const unsigned char* __restrict__ mb,
    const float* __restrict__ kxb, const float* __restrict__ gxb,
    const float* __restrict__ kybT, const float* __restrict__ gybT,
    const float* __restrict__ m1x, const float* __restrict__ m1y,
    float coef, int Ngx, int Ngy, int P)
{
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int i = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= Ngx || j >= Ngy) return;
    const size_t N = (size_t)Ngx * Ngy;
    const float* du = q;
    const float* dv = q + N;
    const float* dp = q + 2 * N;
    float kxu, gxu, kyu, gyu, kxv, gxv, kyv, gyv, kxp, gxp, kyp, gyp;
    sem_tpu_torch::band_sums(du, kxb, gxb, kybT, gybT, i, j, Ngx, Ngy, P,
                             kxu, gxu, kyu, gyu);
    sem_tpu_torch::band_sums(dv, kxb, gxb, kybT, gybT, i, j, Ngx, Ngy, P,
                             kxv, gxv, kyv, gyv);
    sem_tpu_torch::band_sums(dp, kxb, gxb, kybT, gybT, i, j, Ngx, Ngy, P,
                             kxp, gxp, kyp, gyp);
    const float mx = m1x[i], my = m1y[j];
    const size_t n = (size_t)i * Ngy + j;
    const float dun = du[n], dvn = dv[n];
    if (mb[n]) {
        out[n] = dun;
        out[N + n] = dvn;
        out[2 * N + n] = kxp * my + mx * kyp;
        return;
    }
    // mass-weighted products, as in the dense reference path
    const float Ku = kxu * my + mx * kyu, Kv = kxv * my + mx * kyv;
    const float gxu_ = gxu * my, gyu_ = mx * gyu;
    const float gxv_ = gxv * my, gyv_ = mx * gyv;
    const float uln = ul[n], vln = vl[n];
    out[n] = Ku + coef * (uln * gxu_ + vln * gyu_)
        + jxx[n] * dun + jxy[n] * dvn + gxp * my;
    out[N + n] = Kv + coef * (uln * gxv_ + vln * gyv_)
        + jyx[n] * dun + jyy[n] * dvn + mx * gyp;
    out[2 * N + n] = gxu_ + gyv_;
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int sem_apply_coupled_system_f32(
    void* out, const void* q, const void* ul, const void* vl,
    const void* jxx, const void* jxy, const void* jyx, const void* jyy,
    const void* mb, const void* kxb, const void* gxb, const void* kybT,
    const void* gybT, const void* m1x, const void* m1y, float coef,
    int Ngx, int Ngy, int P, void* stream)
{
    const dim3 block(32, 8);
    const dim3 grid((Ngy + block.x - 1) / block.x,
                    (Ngx + block.y - 1) / block.y);
    coupled_system_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (float*)out, (const float*)q, (const float*)ul, (const float*)vl,
        (const float*)jxx, (const float*)jxy, (const float*)jyx,
        (const float*)jyy, (const unsigned char*)mb, (const float*)kxb,
        (const float*)gxb, (const float*)kybT, (const float*)gybT,
        (const float*)m1x, (const float*)m1y, coef, Ngx, Ngy, P);
    return (int)cudaGetLastError();
}
