// Kernels B1 and B3: the fused SEM system apply on Hopper (sm_90a), on f32
// fields (tile.cuh's tap loops) or bf16 fields (mma.cuh's tensor-core band
// products).
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
// f32: what bounds it on the H100.  Per node it reads 3 fields (u, v, w) and
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
// f32 (apply_system_kernel; tile.cuh): 32×32 output tiles of 256 threads;
// w with P halo rows and columns, and the tile's coefficient pairs, staged
// once in shared memory with cp.async; the y sums with lane = row and the x
// sums with lane = column, so that the taps a warp runs (only the
// structurally nonzero ones) are the same for its 32 lanes and every
// coefficient read is a broadcast; one read of w feeds 4 nodes; P a
// template parameter for 4, 8 and 16, and one runtime-P instantiation for
// the other orders up to 64.  u, v and m1x are loaded into registers before
// the staging, so their latency hides behind it.  The sums keep the untiled
// design's fmaf chains (ascending taps) and the epilogue is tile.cuh's
// system_node, so the bits are the untiled design's, and a strip's rows are
// the whole grid's.
//
// bf16 (apply_system_mma_kernel) computes the reference kernel's bf16
// function: bf16 fields, band blocks and masses (rounded on the host) and
// coef (rounded by the entry point), the band products on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulation; mma.cuh with one
// field: B2's staging and products), system_node's f32 epilogue on the
// accumulators and one rounding to bf16 per output.  Per node 8 bytes move
// (u, v, w, out at 2 bytes), 0.67 µs at P16 32×32 with the compact band
// coefficients and masses at 2 bytes, 0.36 µs at rank 0's strip of two;
// the band products' nonzero taps take far less at the bf16 tensor-core
// rate, so the bound is the bytes.  w and the band blocks of the tile's rows
// and columns are staged as bf16 by bulk cp.async on one mbarrier, and a
// staged row is shifted into place by four threads (mma.cuh align_fields);
// u, v and the masses of a thread's four nodes are loaded into registers
// once its copies are started and it has arrived on the mbarrier, so their
// latency hides behind the copies' wait; the outputs go through a shared
// tile to coalesced stores (store_tiles).  Measured by chip_smoke.py phases
// 4, 8 and 8b on an NVIDIA H100 80GB HBM3 at 700.00 W: B1 5.90-5.99 µs at
// P16 32×32 and 13.19-13.23 µs at 64×64 (the f32 kernel 6.77-6.87 and
// 15.80-15.88 in the same calls; the widened f32 tap loops at bf16, before
// this design, 7.38-7.63 and 16.04-16.21), B3 4.92-5.04 and 8.11-8.18 µs at
// those strips.  What holds it there (sem_tpu_torch.study.tc_phases): a
// 32×32 tile is one block's chain of copies (~3.7 K SM cycles from the
// start to the copies' landing), the row shifts (~1.2 K), the products
// (~1.5 K) and the stores (~0.8 K), ~7.4 K a block, and the 289 tiles of
// P16 32×32 are all resident at once, so the chain, not the bytes, sets
// the time; leaving out the band blocks' copies saves 0.07-0.25 µs.
#include <cuda_runtime.h>

#include <type_traits>

#include "mma.cuh"
#include "tile.cuh"

namespace {

using namespace sem_tpu_torch::tile;

constexpr int NG = 4;                     // nodes per thread along a sum
constexpr int THREADS = threads<NG>();

template <int PT>
__global__ void __launch_bounds__(THREADS) apply_system_kernel(
    float* __restrict__ out, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ w,
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
        un[r] = u[n];
        vn[r] = v[n];
        mx[r] = m1x[i];
    }
    const float* const fld[1] = {w};
    float kx[1][NG], gx[1][NG];
    tile_band_sums<PT, 1, NG>(L, fld, kgx, kgy, W, i0, j0, Ngx, Ngy, p_rt, kx,
                              gx);
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

// The bf16 kernel (header).  bx and by are the band blocks of all tile rows
// and tile columns (sem_tpu_torch.ops.kernels.band_blocks).  P is a
// template parameter for the orders the repo runs (4, 8, 16): the staged
// window's geometry, the row divisions and the tap spans fold to
// constants; PT = 0 takes any order at run time.
using sem_tpu_torch::mma::bf16;
using sem_tpu_torch::mma::OUT_PITCH;

// Shared memory of the bf16 kernel: mma.cuh's Layout for one field, then
// the mbarrier of the block's copies.
__host__ size_t mma_smem_bytes(int P)
{
    return sem_tpu_torch::mma::Layout::bytes(1, P) + sizeof(uint64_t);
}

template <int PT>
__global__ void __launch_bounds__(sem_tpu_torch::mma::THREADS)
apply_system_mma_kernel(
    bf16* __restrict__ out, const bf16* __restrict__ u,
    const bf16* __restrict__ v, const bf16* __restrict__ w,
    const bf16* __restrict__ bx, const bf16* __restrict__ by,
    const float* __restrict__ m1x, const float* __restrict__ m1y,
    float coef, Window W, int Ngx, int Ngy, int p_rt)
{
    namespace tc = sem_tpu_torch::mma;
    const int P = PT > 0 ? PT : p_rt;
    extern __shared__ uint4 smem16[];
    const tc::Layout L(smem16, P);
    // Layout::bytes is a multiple of 16: the mbarrier follows it, aligned
    uint64_t* const bar = reinterpret_cast<uint64_t*>(L.s + L.rows * L.sp);
    const int t = W.tile0 + blockIdx.y;
    const int i0 = t * TI, j0 = blockIdx.x * TJ;
    const bf16* const fld[1] = {w};
    const size_t block = (size_t)2 * TI * L.sp;   // one tile's band block
    if (threadIdx.x == 0) tc::mbar_init(bar, tc::THREADS);
    __syncthreads();
    tc::copy_fields<1>(L, fld, bx + t * block, by + blockIdx.x * block, W, i0,
                       j0, Ngx, Ngy, bar);
    tc::mbar_arrive(bar);
    // this thread's nodes (mma::band_products): rows ib, ib + 8 and columns
    // jb, jb + 1 of the tile; their pointwise values and masses, loaded
    // while the copies land.  After the arrive, whose release semantics
    // would wait for them, and held as bf16 until the epilogue widens them,
    // so that no instruction before it waits on them.
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int ib = 16 * (warp & 1) + lane / 4;          // tile row (h = 0)
    const int jb = 8 * (warp >> 1) + 2 * (lane % 4);    // tile column (e = 0)
    float mx[2], my[2];
    bf16 un[2][2], vn[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int i = i0 + ib + 8 * h, j = j0 + jb + h;
        mx[h] = i < Ngx ? m1x[i] : 0.f;
        my[h] = j < Ngy ? m1y[j] : 0.f;
        const int ic = min(max(i, W.r0), W.r1 - 1);     // a row of the window
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const size_t n = (size_t)(ic - W.r0) * Ngy
                           + min(j0 + jb + e, Ngy - 1);
            un[h][e] = u[n];
            vn[h][e] = v[n];
        }
    }
    tc::mbar_wait(bar, 0);
    tc::align_fields<1>(L, fld, W, i0, j0, Ngx, Ngy);
    float ax[1][2][4], ay[1][2][4];
    tc::band_products<1>(L, W, i0, j0, Ngx, Ngy, P, ax, ay);
    __syncthreads();   // cx, cy are read: the output tile takes their place
    bf16* const o = L.cx;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int r = 2 * h + e;
            store(o + (ib + 8 * h) * OUT_PITCH + jb + e, system_node(
                ax[0][0][r], ax[0][1][r], ay[0][0][r], ay[0][1][r], mx[h],
                my[e], to_f(un[h][e]), to_f(vn[h][e]), coef));
        }
    __syncthreads();
    tc::store_tiles<1>(out, 0, o, W, i0, j0, Ngy);
}

// One launch on the tiles of W: the f32 kernel (T = float; kgx, kgy in cx,
// cy) or the bf16 tensor-core kernel (T = bf16; bx, by).
template <int PT, class T>
int launch(void* out, const void* u, const void* v, const void* w,
           const void* cx, const void* cy, const void* m1x, const void* m1y,
           float coef, Window W, int ntiles, int Ngx, int Ngy, int P,
           cudaStream_t stream)
{
    static int smem_set[64];
    const dim3 grid((Ngy + TJ - 1) / TJ, ntiles);
    using M = const float*;
    if constexpr (std::is_same<T, float>::value) {
        const size_t smem = Layout::bytes(1, P);
        cudaError_t err = allow_smem(apply_system_kernel<PT>, smem, smem_set);
        if (err != cudaSuccess) return (int)err;
        apply_system_kernel<PT><<<grid, THREADS, smem, stream>>>(
            (float*)out, M(u), M(v), M(w), (const float2*)cx,
            (const float2*)cy, M(m1x), M(m1y), coef, W, Ngx, Ngy, P);
    } else {
        using B = const bf16*;
        const size_t smem = mma_smem_bytes(P);
        cudaError_t err = allow_smem(apply_system_mma_kernel<PT>, smem,
                                     smem_set);
        if (err != cudaSuccess) return (int)err;
        apply_system_mma_kernel<PT>
            <<<grid, sem_tpu_torch::mma::THREADS, smem, stream>>>(
                (bf16*)out, B(u), B(v), B(w), B(cx), B(cy), M(m1x), M(m1y),
                coef, W, Ngx, Ngy, P);
    }
    return (int)cudaGetLastError();
}

template <class T>
int dispatch(void* out, const void* u, const void* v, const void* w,
             const void* cx, const void* cy, const void* m1x,
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
    return fn(out, u, v, w, cx, cy, m1x, m1y, coef, W, ntiles, Ngx, Ngy, P,
              (cudaStream_t)stream);
}

}  // namespace

// The entry points launch on `stream` and return the cudaError_t of the
// launch (0 = success, cudaErrorInvalidValue for an order outside
// 1..P_MAX or a row window that the tiles do not cover).  The *_f32 ones
// take the f32 coefficient pairs kgx, kgy (tile_coefficients); the *_bf16
// ones bf16 fields and output, the bf16 band blocks bx, by in their place
// (band_blocks), the masses rounded to bf16 on the host (held as f32), and
// round coef to bf16 themselves.

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
    const void* bx, const void* by, const void* m1x, const void* m1y,
    float coef, int Ngx, int Ngy, int P,
    void* stream)
{
    return dispatch<bf16>(out, u, v, w, bx, by, m1x, m1y, bf16_round(coef),
                          Window{0, Ngx, 0, 0}, (Ngx + TI - 1) / TI, Ngx,
                          Ngy, P, stream);
}

// B3: rows [r0, r0+nrows) from w_ext, the strip of w with P halo rows per
// side ((nrows+2P) × Ngy, zeros beyond the grid), and u, v of the strip's
// rows; out holds the strip's rows.  The coefficient tables are B1's (grid
// rows), the band blocks too.  Tile rows tile0 .. tile0+ntiles-1 cover the
// strip (sem_tpu_torch.ops.kernels.row_window_tiles).
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
    const void* bx, const void* by, const void* m1x, const void* m1y,
    float coef, int r0, int nrows, int tile0, int ntiles, int Ngx, int Ngy,
    int P, void* stream)
{
    return dispatch<bf16>(out, u, v, w_ext, bx, by, m1x, m1y,
                          bf16_round(coef),
                          Window{r0, r0 + nrows, r0 - P, tile0}, ntiles, Ngx,
                          Ngy, P, stream);
}
