// Kernel B1: the fused SEM system apply on Hopper (sm_90a), f32.
//
//   y = (K + c·(u∂x + v∂y)) w
//     = (K1x W)·m1y + m1x·(W K1yᵀ) + c·[u∘(G1x W)·m1y + v∘m1x·(W G1yᵀ)]
//
// Replaces the TPU kernel sem_tpu/ops/pallas_kernels.py: _kernel(nby),
// launched by apply_system_pallas.  The TPU version tiles the grid into
// 128-row programs with a 64-row stagger so that its band products fit the
// 128×128 MXU; none of that carries over here.
//
// What bounds it on the H100.  Per node it reads 3 fields (u, v, w) and
// writes 1: 16 bytes of device traffic against 4·(2P+1) multiply-adds (132
// at P=16, 264 flops), ~16 flop/byte, close to the card's f32 CUDA-core
// balance (67 TFLOP/s over 3.35 TB/s ≈ 20).  An ideal apply at p16 64×64
// (1.05 M nodes) therefore takes ~5 µs by either bound.  In this design each
// node also issues 2·(2P+1) loads of w; they overlap their neighbours' and
// are served from L1/L2, and that load traffic (~280 MB at p16) is what
// bounds the kernel in practice.
//
// Design: one thread per output node (i, j) of the row-major (Ngx, Ngy)
// field, threadIdx.x along j, so every load of a warp (w, u, v, the
// transposed y-band coefficients) is coalesced and the x-band coefficients of
// row i are a broadcast.  The four band sums accumulate in f32 registers and
// the mass/convection epilogue is applied in registers; the result is written
// once.  A shared-memory tile with a P-wide halo, or tensor-core band blocks,
// are later optimisations.
#include <cuda_runtime.h>

#include "band.cuh"

namespace {

__global__ void apply_system_kernel(
    float* __restrict__ out, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ kxb, const float* __restrict__ gxb,
    const float* __restrict__ kybT, const float* __restrict__ gybT,
    const float* __restrict__ m1x, const float* __restrict__ m1y,
    float coef, int Ngx, int Ngy, int P)
{
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int i = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= Ngx || j >= Ngy) return;
    float kx, gx, ky, gy;
    sem_tpu_torch::band_sums(w, kxb, gxb, kybT, gybT, i, j, Ngx, Ngy, P,
                             kx, gx, ky, gy);
    const float mx = m1x[i], my = m1y[j];
    const size_t n = (size_t)i * Ngy + j;
    out[n] = (kx * my + mx * ky) + coef * (u[n] * (gx * my)
                                           + v[n] * (mx * gy));
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int sem_apply_system_f32(
    void* out, const void* u, const void* v, const void* w,
    const void* kxb, const void* gxb, const void* kybT, const void* gybT,
    const void* m1x, const void* m1y, float coef, int Ngx, int Ngy, int P,
    void* stream)
{
    const dim3 block(32, 8);
    const dim3 grid((Ngy + block.x - 1) / block.x,
                    (Ngx + block.y - 1) / block.y);
    apply_system_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (float*)out, (const float*)u, (const float*)v, (const float*)w,
        (const float*)kxb, (const float*)gxb, (const float*)kybT,
        (const float*)gybT, (const float*)m1x, (const float*)m1y,
        coef, Ngx, Ngy, P);
    return (int)cudaGetLastError();
}
