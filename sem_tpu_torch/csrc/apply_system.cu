// Kernels B1 and B3: the fused SEM system apply on Hopper (sm_90a), on f32
// or bf16 fields (tile.cuh: bf16 operands, f32 arithmetic, one rounding).
//
//   y = (K + c·(u∂x + v∂y)) w
//     = (K1x W)·m1y + m1x·(W K1yᵀ) + c·[u∘(G1x W)·m1y + v∘m1x·(W G1yᵀ)]
//
// B1 computes it on the whole grid, B3 on one rank's row strip (a row
// window of the same kernel, tile.cuh).
//
// Replaces the TPU kernels sem_tpu/ops/pallas_kernels.py: _kernel(nby),
// launched by apply_system_pallas (B1), and the same kernel under
// shard_map, launched by apply_system_pallas_sharded (B3).  The TPU version
// tiles the grid into 128-row programs with a 64-row stagger so that its
// band products fit the 128×128 MXU, and swaps 64-row halos between the
// strips; none of that carries over here: the C0 band has half-width P, so
// a strip's halo is P rows.
//
// What bounds it on the H100.  Per node it reads 3 fields (u, v, w) and
// writes 1: 16 bytes of device traffic, 4.2 MB at P16 32×32 (263,169 nodes,
// B1's main-path shape), 1.34 µs at 3.35 TB/s with the band coefficients;
// at rank 0's strip of two (257 of 513 rows at P16 32×32, 513 of 1025 at
// 64×64, with P halo rows of w) 0.71 and 2.67 µs.  The structurally nonzero
// taps (~18 per direction and node at P16: 17 in an element, 33 on an
// interface row) of its 4 band sums are ~0.04 GFLOP at 32×32, under 1 µs
// at 67 TFLOP/s f32.  So bytes bound it.  Measured by chip_smoke.py phases
// 4 and 8 on an NVIDIA H100 80GB HBM3 at 700.00 W: B1 6.90 µs of device
// time at P16 32×32 and 15.88–15.93 µs at 64×64 (bounds 1.34 and 5.18 µs),
// B3 5.46–5.48 and 9.82–10.00 µs at those strips (bounds 0.71 and 2.67 µs),
// 0.39–0.53 of the untiled design's time on the same strips (one thread per
// node over every tap of the band, runtime P, 2·(2P+1) loads of w per node
// from L1).  What is left is not traffic: a block's chain of staging, two
// tap phases and the epilogue, and the shared-memory reads of the tap loops
// (one coefficient pair per tap and node, one w per tap and 4 nodes); a
// strip that starts inside a tile runs that tile row twice, once per strip.
//
// Design (tile.cuh): 32×32 output tiles of 256 threads; w with P halo rows
// and columns, and the tile's coefficient pairs, staged once in shared
// memory with cp.async; the y sums with lane = row and the x sums with
// lane = column, so that the taps a warp runs (only the structurally
// nonzero ones) are the same for its 32 lanes and every coefficient read is
// a broadcast; one read of w feeds 4 nodes; P a template parameter for 4, 8
// and 16, and one runtime-P instantiation for the other orders up to 64.
// u, v and m1x are loaded into registers before the staging, so their
// latency hides behind it.  The sums keep the untiled design's fmaf chains
// (ascending taps) and the epilogue is tile.cuh's system_node, so the bits
// are the untiled design's, and a strip's rows are the whole grid's.  At
// bf16 the fields are read at 2 bytes (8 bytes per node of B1 instead of
// 16) and widened where they are staged; the tap loops and the epilogue are
// the f32 ones, on the bf16-rounded coefficients.
#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

using namespace sem_tpu_torch::tile;

constexpr int NG = 4;                     // nodes per thread along a sum
constexpr int THREADS = threads<NG>();

template <int PT, class T>
__global__ void __launch_bounds__(THREADS) apply_system_kernel(
    T* __restrict__ out, const T* __restrict__ u, const T* __restrict__ v,
    const T* __restrict__ w,
    const float2* __restrict__ kgx, const float2* __restrict__ kgy,
    const float* __restrict__ m1x, const float* __restrict__ m1y,
    float coef, Window W, int Ngx, int Ngy, int p_rt)
{
    extern __shared__ float4 smem4[];
    const int P = PT > 0 ? PT : p_rt;
    const Layout L(reinterpret_cast<float*>(smem4), 1, P);
    const int i0 = (W.tile0 + blockIdx.y) * TI, j0 = blockIdx.x * TJ;
    const int warp = threadIdx.x / 32, jj = threadIdx.x % 32, j = j0 + jj;
    // the epilogue's pointwise values, loaded while the tile is staged
    float un[NG], vn[NG], mx[NG];
#pragma unroll
    for (int r = 0; r < NG; ++r) {
        const int i = min(max(i0 + warp * NG + r, W.r0), W.r1 - 1);
        const size_t n = (size_t)(i - W.r0) * Ngy + min(j, Ngy - 1);
        un[r] = to_f(u[n]);
        vn[r] = to_f(v[n]);
        mx[r] = m1x[i];
    }
    const T* const fld[1] = {w};
    float kx[1][NG], gx[1][NG];
    tile_band_sums<PT, 1, NG, T>(L, fld, kgx, kgy, W, i0, j0, Ngx, Ngy, p_rt,
                                 kx, gx);
    if (j >= Ngy) return;
    const float my = m1y[j];
#pragma unroll
    for (int r = 0; r < NG; ++r) {
        const int ii = warp * NG + r, i = i0 + ii;
        if (i < W.r0) continue;
        if (i >= W.r1) break;
        store(out + (size_t)(i - W.r0) * Ngy + j, system_node(
            kx[0][r], gx[0][r], L.ysum(0, 0, ii, jj), L.ysum(0, 1, ii, jj),
            mx[r], my, un[r], vn[r], coef));
    }
}

template <int PT, class T>
int launch(T* out, const T* u, const T* v, const T* w, const float2* kgx,
           const float2* kgy, const float* m1x, const float* m1y, float coef,
           Window W, int ntiles, int Ngx, int Ngy, int P, cudaStream_t stream)
{
    static int smem_set[64];
    const size_t smem = Layout::bytes(1, P);
    cudaError_t err = allow_smem(apply_system_kernel<PT, T>, smem, smem_set);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Ngy + TJ - 1) / TJ, ntiles);
    apply_system_kernel<PT, T><<<grid, THREADS, smem, stream>>>(
        out, u, v, w, kgx, kgy, m1x, m1y, coef, W, Ngx, Ngy, P);
    return (int)cudaGetLastError();
}

template <class T>
int dispatch(void* out, const void* u, const void* v, const void* w,
             const void* kgx, const void* kgy, const void* m1x,
             const void* m1y, float coef, Window W, int ntiles, int Ngx,
             int Ngy, int P, void* stream)
{
    if (P < 1 || P > P_MAX || !W.covered(ntiles, Ngx))
        return (int)cudaErrorInvalidValue;
    auto* fn = launch<0, T>;
    switch (P) {
        case 4: fn = launch<4, T>; break;
        case 8: fn = launch<8, T>; break;
        case 16: fn = launch<16, T>; break;
        default: break;
    }
    return fn((T*)out, (const T*)u, (const T*)v, (const T*)w,
              (const float2*)kgx, (const float2*)kgy, (const float*)m1x,
              (const float*)m1y, coef, W, ntiles, Ngx, Ngy, P,
              (cudaStream_t)stream);
}

}  // namespace

// The entry points launch on `stream` and return the cudaError_t of the
// launch (0 = success, cudaErrorInvalidValue for an order outside
// 1..P_MAX or a row window that the tiles do not cover).  The *_bf16 ones
// take bf16 fields and output and the same f32 coefficient tables and
// masses, rounded to bf16 on the host, and round coef to bf16 themselves.

// B1: the whole grid.
extern "C" int sem_apply_system_f32(
    void* out, const void* u, const void* v, const void* w,
    const void* kgx, const void* kgy, const void* m1x, const void* m1y,
    float coef, int Ngx, int Ngy, int P,
    void* stream)
{
    return dispatch<float>(out, u, v, w, kgx, kgy, m1x, m1y, coef,
                           Window{0, Ngx, 0, 0}, (Ngx + TI - 1) / TI, Ngx,
                           Ngy, P, stream);
}

extern "C" int sem_apply_system_bf16(
    void* out, const void* u, const void* v, const void* w,
    const void* kgx, const void* kgy, const void* m1x, const void* m1y,
    float coef, int Ngx, int Ngy, int P,
    void* stream)
{
    return dispatch<__nv_bfloat16>(out, u, v, w, kgx, kgy, m1x, m1y,
                                   bf16_round(coef), Window{0, Ngx, 0, 0},
                                   (Ngx + TI - 1) / TI, Ngx, Ngy, P, stream);
}

// B3: rows [r0, r0+nrows) from w_ext, the strip of w with P halo rows per
// side ((nrows+2P) × Ngy, zeros beyond the grid), and u, v of the strip's
// rows; out holds the strip's rows.  The coefficient tables are B1's (grid
// rows).  Tile rows tile0 .. tile0+ntiles-1 cover the strip
// (sem_tpu_torch.ops.kernels.row_window_tiles).
extern "C" int sem_apply_system_strip_f32(
    void* out, const void* u, const void* v, const void* w_ext,
    const void* kgx, const void* kgy, const void* m1x, const void* m1y,
    float coef, int r0, int nrows, int tile0, int ntiles, int Ngx, int Ngy,
    int P, void* stream)
{
    return dispatch<float>(out, u, v, w_ext, kgx, kgy, m1x, m1y, coef,
                           Window{r0, r0 + nrows, r0 - P, tile0}, ntiles,
                           Ngx, Ngy, P, stream);
}

extern "C" int sem_apply_system_strip_bf16(
    void* out, const void* u, const void* v, const void* w_ext,
    const void* kgx, const void* kgy, const void* m1x, const void* m1y,
    float coef, int r0, int nrows, int tile0, int ntiles, int Ngx, int Ngy,
    int P, void* stream)
{
    return dispatch<__nv_bfloat16>(out, u, v, w_ext, kgx, kgy, m1x, m1y,
                                   bf16_round(coef),
                                   Window{r0, r0 + nrows, r0 - P, tile0},
                                   ntiles, Ngx, Ngy, P, stream);
}
