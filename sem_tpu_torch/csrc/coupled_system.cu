// Kernels B2 and B4: the Navier-Stokes tangent saddle matvec on Hopper
// (sm_90a), on f32 fields (tile.cuh's tap loops) or bf16 fields (mma.cuh's
// tensor-core band products).
//
// For q = (du, dv, dp) with the frozen linearization (ul, vl), the convection
// Jacobian diagonals (jxx, jxy, jyx, jyy) and the Dirichlet-row mask mb:
//   dru = K du + c(ul·Gx du + vl·Gy du) + jxx du + jxy dv + Gx dp
//   drv = K dv + c(ul·Gx dv + vl·Gy dv) + jyx du + jyy dv + Gy dp
//   drc = Gx du + Gy dv
// and on Dirichlet rows (mb) dru = du, drv = dv, drc = K dp (the artificial
// ∂ₙp = 0 rows).  The pressure-pin row is left to the caller.  Output is the
// stacked vector dru | drv | drc.  B2 computes it on the whole grid, B4 on
// one rank's row strip (a row window of the same kernel, tile.cuh): only
// du, dv, dp carry halo rows, and the output is the strip's rows of the
// three fields, the local layout of the decomposed Krylov vector.
//
// Replaces the TPU kernels sem_tpu/ops/pallas_kernels.py: _coupled_kernel(),
// launched by apply_coupled_system_pallas (B2; a 2D grid of 128×128 tiles
// with 64-row staggered band blocks, shaped for the MXU; not carried over),
// and the same kernel under shard_map, launched by
// apply_coupled_system_pallas_sharded (B4; 64-row ppermute halos, where the
// band needs P rows).
//
// f32 (coupled_system_kernel).  What bounds it on the H100: device memory
// traffic.  Per node it reads 9
// f32 fields (du, dv, dp, ul, vl, jxx, jxy, jyx, jyy) and the 1-byte mask and
// writes 3 fields: 49 bytes, 51.5 MB at P16 64×64 (1,050,625 nodes, B2's
// main-path shape), 15.53 µs at 3.35 TB/s with the band coefficients; 7.93
// µs at rank 0's strip of two (513 of 1025 rows, with P halo rows of du, dv,
// dp).  The structurally nonzero taps of the 10 band sums a node needs (2 on
// a Dirichlet row) are ~0.4 GFLOP on the whole grid, ~6 µs at 67 TFLOP/s
// f32.  Measured by chip_smoke.py phases 4 and 8 on an NVIDIA H100 80GB
// HBM3 at 700.00 W: 42.50–42.52 µs of device time for B2, 22.12–22.14 µs
// for B4 at that strip, 0.28 of the untiled design's time on the same strip
// (one thread per node, 6·(2P+1) loads of the fields and as many of the
// coefficients per node from L1, runtime P, every tap of the band).  What
// is left is the tap loops' shared-memory reads, the staging, and the
// epilogue's eight pointwise loads per node.
//
// Design: kernel B1's (tile.cuh) for the three fields at once: du, dv, dp
// and their halos staged once in shared memory, each coefficient read feeds
// the three fields, each read of a field's w feeds 4 nodes, only
// structurally nonzero taps run, P a template parameter.  The sums keep
// the untiled design's fmaf chains and the epilogue is tile.cuh's
// coupled_node (Jacobian diagonals and row mask in registers, each
// pointwise field read once, each output written once, coalesced), so the
// bits are the untiled design's, and a strip's rows are the whole grid's.
//
// bf16 (coupled_system_mma_kernel) computes the reference kernel's bf16
// function: bf16 fields, band blocks and masses (rounded on the host) and
// coef (rounded by the entry point), the band products on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulation, mma.cuh), the same f32
// epilogue (coupled_node: the jxx·du products of two bf16 values stay f32)
// and one rounding to bf16 per output.  Per node 25 bytes move (9 fields and
// 3 outputs at 2 bytes, the mask), 7.92 µs at P16 64×64 with the band
// coefficients and masses at 2 bytes; the band products' ~0.4 GFLOP of
// nonzero taps take well under a µs at the bf16 tensor-core rate, so the
// bound is the bytes.  The three fields, the pointwise fields and both band
// blocks are staged in shared memory as bf16 by bulk cp.async, and each
// warp's 16 × 8 nodes take 2-3 of the 4 k chunks per sum.  Measured by
// chip_smoke.py phase 8b on an NVIDIA H100 80GB HBM3 at 700.00 W: 33.78-33.99
// µs for B2 (the f32 design at bf16: 38.24-38.71 µs; f32: 42.29-42.66 µs),
// 19.26-19.62 µs for B4 at rank 0's strip of two.  What holds it there
// (sem_tpu_torch.study.tc_phases): each 32×32 tile is one block that copies
// (~60 KB from L2, ~420 row copies), waits, shifts its rows into place, runs
// the products, the epilogue and the stores in turn, ~20 K SM cycles, 12 K
// with the SM to itself; three blocks fit an SM (registers, 63 KB), and the
// copies alone take 14 µs of the 33.
#include <cuda_runtime.h>

#include "mma.cuh"
#include "tile.cuh"

namespace {

using namespace sem_tpu_torch::tile;

constexpr int NG = 4;                     // nodes per thread along a sum
constexpr int THREADS = threads<NG>();

template <int PT>
__global__ void __launch_bounds__(THREADS) coupled_system_kernel(
    float* __restrict__ out, const float* __restrict__ q,
    const float* __restrict__ ul, const float* __restrict__ vl,
    const float* __restrict__ jxx, const float* __restrict__ jxy,
    const float* __restrict__ jyx, const float* __restrict__ jyy,
    const unsigned char* __restrict__ mb,
    const float2* __restrict__ kgx, const float2* __restrict__ kgy,
    const float* __restrict__ m1x, const float* __restrict__ m1y,
    float coef, Window W, int Ngx, int Ngy, int p_rt)
{
    extern __shared__ float4 smem4[];
    const int P = PT > 0 ? PT : p_rt;
    const Layout L(reinterpret_cast<float*>(smem4), 3, P);
    const int i0 = (W.tile0 + blockIdx.y) * TI, j0 = blockIdx.x * TJ;
    const size_t Nin = (size_t)(W.in_end() - W.g_in) * Ngy;  // input field
    const size_t N = (size_t)(W.r1 - W.r0) * Ngy;            // output field
    const float* const fld[3] = {q, q + Nin, q + 2 * Nin};
    float kx[3][NG], gx[3][NG];
    tile_band_sums<PT, 3, NG>(L, fld, kgx, kgy, W, i0, j0, Ngx, Ngy, p_rt,
                              kx, gx);
    const int warp = threadIdx.x / 32, jj = threadIdx.x % 32, j = j0 + jj;
    if (j >= Ngy) return;
    const float my = m1y[j];
#pragma unroll
    for (int r = 0; r < NG; ++r) {
        const int ii = warp * NG + r, i = i0 + ii;
        if (i < W.r0) continue;
        if (i >= W.r1) break;
        float s[12];
#pragma unroll
        for (int f = 0; f < 3; ++f) {
            s[4 * f] = kx[f][r];
            s[4 * f + 1] = gx[f][r];
            s[4 * f + 2] = L.ysum(f, 0, ii, jj);
            s[4 * f + 3] = L.ysum(f, 1, ii, jj);
        }
        const float mx = m1x[i];
        const size_t n = (size_t)(i - W.r0) * Ngy + j;    // output node
        const size_t c = (size_t)(i - W.g_in) * Ngy + j;  // same in q
        const float dun = to_f(fld[0][c]), dvn = to_f(fld[1][c]);
        float ru, rv, rc;
        if (mb[n]) {
            ru = dun;
            rv = dvn;
            rc = mass_k(s[8], s[10], mx, my);
        } else {
            coupled_node(s, mx, my, to_f(ul[n]), to_f(vl[n]), to_f(jxx[n]),
                         to_f(jxy[n]), to_f(jyx[n]), to_f(jyy[n]), dun, dvn,
                         coef, ru, rv, rc);
        }
        store(out + n, ru);
        store(out + N + n, rv);
        store(out + 2 * N + n, rc);
    }
}

// One launch of a kernel on the tiles of W; the f32 kernel and the bf16
// tensor-core kernel take the same arguments.
template <class Kernel, class T, class C>
int launch(Kernel kernel, size_t smem, int threads, int* smem_set, T* out,
           const T* q, const T* ul, const T* vl, const T* jxx, const T* jxy,
           const T* jyx, const T* jyy, const unsigned char* mb, const C* cx,
           const C* cy, const float* m1x, const float* m1y, float coef,
           Window W, int ntiles, int Ngx, int Ngy, int P, cudaStream_t stream)
{
    cudaError_t err = allow_smem(kernel, smem, smem_set);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Ngy + TJ - 1) / TJ, ntiles);
    kernel<<<grid, threads, smem, stream>>>(out, q, ul, vl, jxx, jxy, jyx,
                                            jyy, mb, cx, cy, m1x, m1y, coef,
                                            W, Ngx, Ngy, P);
    return (int)cudaGetLastError();
}

template <int PT>
int launch_f32(void* out, const void* q, const void* ul, const void* vl,
               const void* jxx, const void* jxy, const void* jyx,
               const void* jyy, const void* mb, const void* kgx,
               const void* kgy, const void* m1x, const void* m1y, float coef,
               Window W, int ntiles, int Ngx, int Ngy, int P,
               cudaStream_t stream)
{
    static int smem_set[64];
    using F = const float*;
    return launch(coupled_system_kernel<PT>, Layout::bytes(3, P), THREADS,
                  smem_set, (float*)out, F(q), F(ul), F(vl), F(jxx), F(jxy),
                  F(jyx), F(jyy), (const unsigned char*)mb,
                  (const float2*)kgx, (const float2*)kgy, F(m1x), F(m1y),
                  coef, W, ntiles, Ngx, Ngy, P, stream);
}

int dispatch_f32(void* out, const void* q, const void* ul, const void* vl,
                 const void* jxx, const void* jxy, const void* jyx,
                 const void* jyy, const void* mb, const void* kgx,
                 const void* kgy, const void* m1x, const void* m1y,
                 float coef, Window W, int ntiles, int Ngx, int Ngy, int P,
                 void* stream)
{
    if (P < 1 || P > P_MAX || !W.covered(ntiles, Ngx))
        return (int)cudaErrorInvalidValue;
    auto* fn = launch_f32<0>;
    switch (P) {
        case 4: fn = launch_f32<4>; break;
        case 8: fn = launch_f32<8>; break;
        case 16: fn = launch_f32<16>; break;
        default: break;
    }
    return fn(out, q, ul, vl, jxx, jxy, jyx, jyy, mb, kgx, kgy, m1x, m1y,
              coef, W, ntiles, Ngx, Ngy, P, (cudaStream_t)stream);
}

// The bf16 kernel.  Every global read is a bulk cp.async started at once,
// all completing on one mbarrier: the band blocks and du, dv, dp
// (mma.cuh), and the tile's rows of the six pointwise fields and of the
// mask, copied raw with each row's offset kept (pw, mk, off).  Then mma.cuh's band products; the f32 kernel's epilogue on
// the accumulators of this thread's four nodes, reading the staged tiles
// (the centre du, dv from the aligned field tile); the outputs go through a
// shared tile in the band blocks' place to coalesced stores along rows
// (mma.cuh's store_tiles).
// bx and by are the band blocks of all tile rows and tile columns
// (sem_tpu_torch.ops.kernels.band_blocks).  P is a template parameter for
// the orders the repo runs (4, 8, 16): the staged window's geometry, the
// row and task divisions and the tap spans fold to constants; PT = 0 takes
// any order at run time.
using sem_tpu_torch::mma::bf16;
using sem_tpu_torch::mma::OUT_PITCH;

constexpr int NPW = 6;        // ul, vl, jxx, jxy, jyx, jyy
constexpr int PW_CHUNKS = 5;  // a row's 32 values at any offset (80 bytes)
constexpr int MB_CHUNKS = 3;  // its 32 mask bytes at any offset (48 bytes)

// Shared memory of the bf16 kernel past mma.cuh's Layout.
struct Staged {
    bf16* pw;            // NPW × TI × 8·PW_CHUNKS  pointwise rows, raw
    unsigned char* mk;   // TI × 16·MB_CHUNKS       mask rows, raw
    uint64_t* bar;       // the mbarrier of the block's copies
    unsigned char* off;  // (NPW + 1) × TI          each row's offset (bytes)
    bf16* out;           // 3 × TI × OUT_PITCH      outputs, in cx/cy's place

    __host__ static size_t bytes(int P)
    {
        return sem_tpu_torch::mma::Layout::bytes(3, P)
            + sizeof(bf16) * NPW * TI * 8 * PW_CHUNKS
            + TI * 16 * MB_CHUNKS + sizeof(uint64_t) + (NPW + 1) * TI;
    }

    __device__ explicit Staged(const sem_tpu_torch::mma::Layout& L)
    {
        pw = L.s + 3 * L.rows * L.sp;
        mk = reinterpret_cast<unsigned char*>(pw + NPW * TI * 8 * PW_CHUNKS);
        bar = reinterpret_cast<uint64_t*>(mk + TI * 16 * MB_CHUNKS);
        off = reinterpret_cast<unsigned char*>(bar + 1);
        out = L.cx;      // 2·(2·TI·sp) >= 3·TI·OUT_PITCH values for sp >= 56
    }
};

template <int PT>
__global__ void __launch_bounds__(sem_tpu_torch::mma::THREADS)
coupled_system_mma_kernel(
    bf16* __restrict__ out, const bf16* __restrict__ q,
    const bf16* __restrict__ ul, const bf16* __restrict__ vl,
    const bf16* __restrict__ jxx, const bf16* __restrict__ jxy,
    const bf16* __restrict__ jyx, const bf16* __restrict__ jyy,
    const unsigned char* __restrict__ mb,
    const bf16* __restrict__ bx, const bf16* __restrict__ by,
    const float* __restrict__ m1x, const float* __restrict__ m1y,
    float coef, Window W, int Ngx, int Ngy, int p_rt)
{
    namespace tc = sem_tpu_torch::mma;
    // a compile-time order folds the staged window's geometry to constants
    const int P = PT > 0 ? PT : p_rt;
    extern __shared__ uint4 smem16[];
    const tc::Layout L(smem16, P);
    const Staged S(L);
    const int t = W.tile0 + blockIdx.y;
    const int i0 = t * TI, j0 = blockIdx.x * TJ;
    const size_t Nin = (size_t)(W.in_end() - W.g_in) * Ngy;  // input field
    const size_t N = (size_t)(W.r1 - W.r0) * Ngy;            // output field
    const bf16* const fld[3] = {q, q + Nin, q + 2 * Nin};
    const size_t block = (size_t)2 * TI * L.sp;   // one tile's band block
    // this thread's nodes (mma::band_products) and their masses, loaded
    // before the copies so that the epilogue does not wait on them
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int ib = 16 * (warp & 1) + lane / 4;          // tile row (h = 0)
    const int jb = 8 * (warp >> 1) + 2 * (lane % 4);    // tile column (e = 0)
    float mx[2], my[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int i = i0 + ib + 8 * h, j = j0 + jb + h;
        mx[h] = i < Ngx ? m1x[i] : 0.f;
        my[h] = j < Ngy ? m1y[j] : 0.f;
    }
    if (threadIdx.x == 0) tc::mbar_init(S.bar, tc::THREADS);
    __syncthreads();
    tc::copy_fields<3>(L, fld, bx + t * block, by + blockIdx.x * block, W,
                       i0, j0, Ngx, Ngy, S.bar);
    // the window's rows of the pointwise fields and of the mask, raw, one
    // thread per row
    const int ncols = min(TJ, Ngy - j0);
    for (int row = threadIdx.x; row < (NPW + 1) * TI; row += tc::THREADS) {
        const int f = row / TI, ii = row % TI, i = i0 + ii;
        const bool ok = i >= W.r0 && i < W.r1;
        const size_t n = (size_t)(ok ? i - W.r0 : 0) * Ngy + j0;
        const void* src = mb + n;           // the row's first value
        src = f == 0 ? (const void*)(ul + n) : src;
        src = f == 1 ? (const void*)(vl + n) : src;
        src = f == 2 ? (const void*)(jxx + n) : src;
        src = f == 3 ? (const void*)(jxy + n) : src;
        src = f == 4 ? (const void*)(jyx + n) : src;
        src = f == 5 ? (const void*)(jyy + n) : src;
        S.off[row] = (unsigned char)(f < NPW
            ? tc::copy_span(S.pw + row * 8 * PW_CHUNKS, src, 0,
                            ok ? 2 * ncols : 0, PW_CHUNKS, S.bar)
            : tc::copy_span(S.mk + ii * 16 * MB_CHUNKS, src, 0,
                            ok ? ncols : 0, MB_CHUNKS, S.bar));
    }
    tc::mbar_arrive(S.bar);
    tc::mbar_wait(S.bar, 0);
    tc::align_fields<3>(L, fld, W, i0, j0, Ngx, Ngy);
    float ax[3][2][4], ay[3][2][4];
    tc::band_products<3>(L, W, i0, j0, Ngx, Ngy, P, ax, ay);
    __syncthreads();   // cx, cy are read: the output tile takes their place
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int ii = ib + 8 * h, i = i0 + ii;
        if (i < W.r0 || i >= W.r1) continue;
        const bf16* centre = L.s + (L.Q + ii) * L.sp + L.Q;
        const bf16* pw[NPW];     // row ii of each pointwise field
#pragma unroll
        for (int f = 0; f < NPW; ++f)
            pw[f] = S.pw + (f * TI + ii) * 8 * PW_CHUNKS
                  + S.off[f * TI + ii] / 2;
        const unsigned char* mrow = S.mk + ii * 16 * MB_CHUNKS
                                  + S.off[NPW * TI + ii];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int jj = jb + e, j = j0 + jj;
            if (j >= Ngy) continue;
            const int r = 2 * h + e;
            float s[12];
#pragma unroll
            for (int f = 0; f < 3; ++f) {
                s[4 * f] = ax[f][0][r];
                s[4 * f + 1] = ax[f][1][r];
                s[4 * f + 2] = ay[f][0][r];
                s[4 * f + 3] = ay[f][1][r];
            }
            const float dun = to_f(centre[jj]);
            const float dvn = to_f(centre[L.rows * L.sp + jj]);
            // both rows' values, then the mask's choice: no load waits on it
            float ru, rv, rc;
            coupled_node(s, mx[h], my[e], to_f(pw[0][jj]), to_f(pw[1][jj]),
                         to_f(pw[2][jj]), to_f(pw[3][jj]), to_f(pw[4][jj]),
                         to_f(pw[5][jj]), dun, dvn, coef, ru, rv, rc);
            const bool dirichlet = mrow[jj];
            store(S.out + ii * OUT_PITCH + jj, dirichlet ? dun : ru);
            store(S.out + (TI + ii) * OUT_PITCH + jj, dirichlet ? dvn : rv);
            store(S.out + (2 * TI + ii) * OUT_PITCH + jj,
                  dirichlet ? mass_k(s[8], s[10], mx[h], my[e]) : rc);
        }
    }
    __syncthreads();
    tc::store_tiles<3>(out, N, S.out, W, i0, j0, Ngy);
}

template <int PT>
int launch_bf16(void* out, const void* q, const void* ul, const void* vl,
                const void* jxx, const void* jxy, const void* jyx,
                const void* jyy, const void* mb, const void* bx,
                const void* by, const void* m1x, const void* m1y, float coef,
                Window W, int ntiles, int Ngx, int Ngy, int P,
                cudaStream_t stream)
{
    static int smem_set[64];
    using B = const bf16*;
    return launch(coupled_system_mma_kernel<PT>, Staged::bytes(P),
                  sem_tpu_torch::mma::THREADS, smem_set, (bf16*)out, B(q),
                  B(ul), B(vl), B(jxx), B(jxy), B(jyx), B(jyy),
                  (const unsigned char*)mb, B(bx), B(by), (const float*)m1x,
                  (const float*)m1y, coef, W, ntiles, Ngx, Ngy, P, stream);
}

int dispatch_bf16(void* out, const void* q, const void* ul, const void* vl,
                  const void* jxx, const void* jxy, const void* jyx,
                  const void* jyy, const void* mb, const void* bx,
                  const void* by, const void* m1x, const void* m1y,
                  float coef, Window W, int ntiles, int Ngx, int Ngy, int P,
                  void* stream)
{
    if (P < 1 || P > P_MAX || !W.covered(ntiles, Ngx))
        return (int)cudaErrorInvalidValue;
    auto* fn = launch_bf16<0>;
    switch (P) {
        case 4: fn = launch_bf16<4>; break;
        case 8: fn = launch_bf16<8>; break;
        case 16: fn = launch_bf16<16>; break;
        default: break;
    }
    return fn(out, q, ul, vl, jxx, jxy, jyx, jyy, mb, bx, by, m1x, m1y, coef,
              W, ntiles, Ngx, Ngy, P, (cudaStream_t)stream);
}

}  // namespace

// The entry points launch on `stream` and return the cudaError_t of the
// launch (0 = success, cudaErrorInvalidValue for an order outside
// 1..P_MAX or a row window that the tiles do not cover).  The *_f32 ones
// take the f32 coefficient pairs kgx, kgy (tile_coefficients); the *_bf16
// ones bf16 fields and outputs, the bf16 band blocks bx, by in their place
// (band_blocks), the masses rounded to bf16 on the host (held as f32), and
// round coef to bf16 themselves.  sem_mma_geometry gives the staged
// geometry of the band blocks (mma.cuh) at order P, for the host's check of
// band_blocks' layout.

// B2: the whole grid; q and out are (3·Ngx·Ngy,).
extern "C" int sem_apply_coupled_system_f32(
    void* out, const void* q, const void* ul, const void* vl,
    const void* jxx, const void* jxy, const void* jyx, const void* jyy,
    const void* mb, const void* kgx, const void* kgy, const void* m1x,
    const void* m1y, float coef,
    int Ngx, int Ngy, int P, void* stream)
{
    return dispatch_f32(out, q, ul, vl, jxx, jxy, jyx, jyy, mb, kgx, kgy,
                        m1x, m1y, coef, Window{0, Ngx, 0, 0},
                        (Ngx + TI - 1) / TI, Ngx, Ngy, P, stream);
}

extern "C" int sem_apply_coupled_system_bf16(
    void* out, const void* q, const void* ul, const void* vl,
    const void* jxx, const void* jxy, const void* jyx, const void* jyy,
    const void* mb, const void* bx, const void* by, const void* m1x,
    const void* m1y, float coef,
    int Ngx, int Ngy, int P, void* stream)
{
    return dispatch_bf16(out, q, ul, vl, jxx, jxy, jyx, jyy, mb, bx, by,
                         m1x, m1y, bf16_round(coef), Window{0, Ngx, 0, 0},
                         (Ngx + TI - 1) / TI, Ngx, Ngy, P, stream);
}

// B4: rows [r0, r0+nrows) from q_ext, du, dv, dp stacked, each the strip
// with P halo rows per side (3 × (nrows+2P) × Ngy, zeros beyond the grid),
// and the pointwise fields and mask of the strip's rows; out is
// 3 × nrows × Ngy.  The coefficient tables are B2's (grid rows).  Tile rows
// tile0 .. tile0+ntiles-1 cover the strip
// (sem_tpu_torch.ops.kernels.row_window_tiles).
extern "C" int sem_apply_coupled_system_strip_f32(
    void* out, const void* q_ext, const void* ul, const void* vl,
    const void* jxx, const void* jxy, const void* jyx, const void* jyy,
    const void* mb, const void* kgx, const void* kgy, const void* m1x,
    const void* m1y, float coef, int r0, int nrows, int tile0, int ntiles,
    int Ngx, int Ngy, int P, void* stream)
{
    return dispatch_f32(out, q_ext, ul, vl, jxx, jxy, jyx, jyy, mb, kgx, kgy,
                        m1x, m1y, coef, Window{r0, r0 + nrows, r0 - P, tile0},
                        ntiles, Ngx, Ngy, P, stream);
}

extern "C" int sem_apply_coupled_system_strip_bf16(
    void* out, const void* q_ext, const void* ul, const void* vl,
    const void* jxx, const void* jxy, const void* jyx, const void* jyy,
    const void* mb, const void* bx, const void* by, const void* m1x,
    const void* m1y, float coef, int r0, int nrows, int tile0, int ntiles,
    int Ngx, int Ngy, int P, void* stream)
{
    return dispatch_bf16(out, q_ext, ul, vl, jxx, jxy, jyx, jyy, mb, bx, by,
                         m1x, m1y, bf16_round(coef),
                         Window{r0, r0 + nrows, r0 - P, tile0}, ntiles, Ngx,
                         Ngy, P, stream);
}

// Q, nk and pitch of mma.cuh (halo, chunks, pitch) at order P into out[3].
extern "C" int sem_mma_geometry(int P, int* out)
{
    namespace tc = sem_tpu_torch::mma;
    out[0] = tc::halo(P);
    out[1] = tc::chunks(P);
    out[2] = tc::pitch(P);
    return 0;
}
