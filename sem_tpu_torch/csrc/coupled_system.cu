// Kernels B2 and B4: the Navier-Stokes tangent saddle matvec on Hopper
// (sm_90a), on f32 or bf16 fields (tile.cuh: bf16 operands, f32
// arithmetic, one rounding per output).
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
// What bounds it on the H100: device memory traffic.  Per node it reads 9
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
// At bf16 the nine fields and three outputs move at 2 bytes (25 bytes per
// node instead of 49); sums and epilogue are the f32 ones.
#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

using namespace sem_tpu_torch::tile;

constexpr int NG = 4;                     // nodes per thread along a sum
constexpr int THREADS = threads<NG>();

template <int PT, class T>
__global__ void __launch_bounds__(THREADS) coupled_system_kernel(
    T* __restrict__ out, const T* __restrict__ q,
    const T* __restrict__ ul, const T* __restrict__ vl,
    const T* __restrict__ jxx, const T* __restrict__ jxy,
    const T* __restrict__ jyx, const T* __restrict__ jyy,
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
    const T* const fld[3] = {q, q + Nin, q + 2 * Nin};
    float kx[3][NG], gx[3][NG];
    tile_band_sums<PT, 3, NG, T>(L, fld, kgx, kgy, W, i0, j0, Ngx, Ngy, p_rt,
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

template <int PT, class T>
int launch(T* out, const T* q, const T* ul, const T* vl, const T* jxx,
           const T* jxy, const T* jyx, const T* jyy, const unsigned char* mb,
           const float2* kgx, const float2* kgy, const float* m1x,
           const float* m1y, float coef, Window W, int ntiles, int Ngx,
           int Ngy, int P, cudaStream_t stream)
{
    static int smem_set[64];
    const size_t smem = Layout::bytes(3, P);
    cudaError_t err = allow_smem(coupled_system_kernel<PT, T>, smem,
                                 smem_set);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Ngy + TJ - 1) / TJ, ntiles);
    coupled_system_kernel<PT, T><<<grid, THREADS, smem, stream>>>(
        out, q, ul, vl, jxx, jxy, jyx, jyy, mb, kgx, kgy, m1x, m1y, coef, W,
        Ngx, Ngy, P);
    return (int)cudaGetLastError();
}

template <class T>
int dispatch(void* out, const void* q, const void* ul, const void* vl,
             const void* jxx, const void* jxy, const void* jyx,
             const void* jyy, const void* mb, const void* kgx,
             const void* kgy, const void* m1x, const void* m1y, float coef,
             Window W, int ntiles, int Ngx, int Ngy, int P, void* stream)
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
    return fn((T*)out, (const T*)q, (const T*)ul, (const T*)vl,
              (const T*)jxx, (const T*)jxy, (const T*)jyx, (const T*)jyy,
              (const unsigned char*)mb, (const float2*)kgx,
              (const float2*)kgy, (const float*)m1x, (const float*)m1y, coef,
              W, ntiles, Ngx, Ngy, P, (cudaStream_t)stream);
}

}  // namespace

// The entry points launch on `stream` and return the cudaError_t of the
// launch (0 = success, cudaErrorInvalidValue for an order outside
// 1..P_MAX or a row window that the tiles do not cover).  The *_bf16 ones
// take bf16 fields and outputs and the same f32 coefficient tables, masses
// and coef, rounded to bf16 on the host.

// B2: the whole grid; q and out are (3·Ngx·Ngy,).
extern "C" int sem_apply_coupled_system_f32(
    void* out, const void* q, const void* ul, const void* vl,
    const void* jxx, const void* jxy, const void* jyx, const void* jyy,
    const void* mb, const void* kgx, const void* kgy, const void* m1x,
    const void* m1y, float coef,
    int Ngx, int Ngy, int P, void* stream)
{
    return dispatch<float>(out, q, ul, vl, jxx, jxy, jyx, jyy, mb, kgx, kgy,
                           m1x, m1y, coef, Window{0, Ngx, 0, 0},
                           (Ngx + TI - 1) / TI, Ngx, Ngy, P, stream);
}

extern "C" int sem_apply_coupled_system_bf16(
    void* out, const void* q, const void* ul, const void* vl,
    const void* jxx, const void* jxy, const void* jyx, const void* jyy,
    const void* mb, const void* kgx, const void* kgy, const void* m1x,
    const void* m1y, float coef,
    int Ngx, int Ngy, int P, void* stream)
{
    return dispatch<__nv_bfloat16>(out, q, ul, vl, jxx, jxy, jyx, jyy, mb,
                                   kgx, kgy, m1x, m1y, coef,
                                   Window{0, Ngx, 0, 0}, (Ngx + TI - 1) / TI,
                                   Ngx, Ngy, P, stream);
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
    return dispatch<float>(out, q_ext, ul, vl, jxx, jxy, jyx, jyy, mb, kgx,
                           kgy, m1x, m1y, coef,
                           Window{r0, r0 + nrows, r0 - P, tile0}, ntiles,
                           Ngx, Ngy, P, stream);
}

extern "C" int sem_apply_coupled_system_strip_bf16(
    void* out, const void* q_ext, const void* ul, const void* vl,
    const void* jxx, const void* jxy, const void* jyx, const void* jyy,
    const void* mb, const void* kgx, const void* kgy, const void* m1x,
    const void* m1y, float coef, int r0, int nrows, int tile0, int ntiles,
    int Ngx, int Ngy, int P, void* stream)
{
    return dispatch<__nv_bfloat16>(out, q_ext, ul, vl, jxx, jxy, jyx, jyy, mb,
                                   kgx, kgy, m1x, m1y, coef,
                                   Window{r0, r0 + nrows, r0 - P, tile0},
                                   ntiles, Ngx, Ngy, P, stream);
}
