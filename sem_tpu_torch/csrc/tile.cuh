// Shared-memory tiled band sums and the pointwise epilogues of the system
// applies: kernels B1 and B2 on the whole grid, and B3 and B4, the same
// kernels on one rank's row strip (apply_system.cu and coupled_system.cu).
//
// Coefficients.  kgx[(i*(2P+1) + t)] = (K1x[i, i-P+t], G1x[i, i-P+t]) and
// kgy[(j*(2P+1) + t)] = (K1y[j, j-P+t], G1y[j, j-P+t]) as float2 pairs, zero
// where i-P+t leaves the grid and on TI rows of padding past the last node
// (built on the host: sem_tpu_torch.ops.kernels.tile_coefficients).  The
// assembled C0 operators are block-diagonal with (P+1)×(P+1) element blocks
// that overlap at the interface nodes, so a node of local index
// l = i mod P ≠ 0 couples only the P+1 nodes of its own element (columns
// i-l .. i-l+P), and only an interface node (l = 0) couples 2P+1 (tap_span).
// Every other tap multiplies a structural zero and is skipped.  Adding or
// skipping a tap whose coefficient is an exact zero leaves an f32 sum of
// finite terms bit for bit unchanged (the accumulator starts at +0 and can
// never become -0), and the taps that are run go in ascending order into one
// fmaf chain per sum, as in the untiled design these kernels first had (one
// thread per node over every tap of the band).  So the sums keep that
// design's bits.
//
// Row window (Window).  A launch computes output rows [r0, r1): the whole
// grid, or one rank's row strip.  The input fields are a buffer whose first
// row is grid row g_in: the whole field (g_in = 0) or the strip with P halo
// rows per side (g_in = r0 - P, as the halo exchange delivers it); rows
// outside the buffer or the grid are staged as zeros.  The pointwise fields
// and the outputs hold the window's rows alone.  Tiles stay on the global
// TI-row lattice (the host passes the first tile row, ⌊r0/TI⌋): the
// compile-time tap loops below need a warp's nodes to lie in one element,
// which holds only for a tile that starts at a multiple of TI.  A tile that
// two windows share is computed by both, each writing its own rows.
//
// One block of threads<NG>() threads owns a TI × TJ tile of output nodes.
//   1. It stages each input field's tile with P halo rows (sx, for the x
//      sums) and with P halo columns (sy, for the y sums), and the
//      coefficient pairs of the tile's rows (cx) and columns (cy), in shared
//      memory, once, with coalesced asynchronous copies (cp.async; zeros
//      outside the grid).
//   2. y sums: lane = row of the tile, each warp takes NG consecutive
//      columns.  The taps depend on the column only, so they are the same
//      for the 32 lanes of a warp: no divergence, every coefficient read is
//      a broadcast, and sy's odd pitch puts the lanes' reads in distinct
//      banks.  One read of w serves the NG columns, one coefficient read the
//      NF fields.  After a barrier the sums go to sk, in sy's place.
//   3. x sums: lane = column of the tile, each warp takes NG consecutive
//      rows, the same way; the sums stay in registers.
//   4. After a barrier the caller's epilogue reads its nodes' y sums from sk
//      and writes the outputs, coalesced along j.
// P is a template parameter for the orders the repo runs (4, 8, 16).  There
// a warp's NG nodes lie in one element, so every tap loop has a trip count
// known at compile time and no per-tap test: the element's P+1 nodes for
// all NG, and before them the P nodes of the element on the left for an
// interface node (taps beyond the grid's edges read staged zeros with zero
// coefficients, which leaves the sums unchanged).  PT = 0 takes the order
// at run time and tests each tap against tap_span.
#pragma once

#include <cuda_runtime.h>

namespace sem_tpu_torch {
namespace tile {

constexpr int TI = 32, TJ = 32;         // output tile (rows i × columns j)
static_assert(TI == TJ, "the staging loops and the warps' split along "
              "rows and columns assume a square tile");
constexpr int P_MAX = 64;               // the reference's limit

// Threads of a block: TI/NG warps of NG rows (x sums) or columns (y sums).
template <int NG>
__host__ __device__ constexpr int threads() { return 32 * TI / NG; }

// The rows a launch computes and the rows its input buffer holds (see
// above); tile row blockIdx.y starts at grid row (tile0 + blockIdx.y)·TI.
struct Window {
    int r0, r1, g_in, tile0;

    // one past the grid row of the input buffer's last row
    __host__ __device__ int in_end() const { return r1 + (r0 - g_in); }

    // whether ntiles tile rows from tile0 cover the output rows, which lie
    // in an Ngx-row grid
    __host__ bool covered(int ntiles, int Ngx) const
    {
        return 0 <= r0 && r0 < r1 && r1 <= Ngx && 0 <= tile0
            && tile0 * TI <= r0 && (tile0 + ntiles) * TI >= r1;
    }
};

// First and last column k of row i (of an n-node 1D grid) whose coefficient
// can be nonzero.  Mirrored by sem_tpu_torch.ops.kernels.band_tap_ranges.
__device__ __forceinline__ void tap_span(int i, int P, int n, int& k0,
                                         int& k1)
{
    const int l = i % P;
    if (l == 0) {
        k0 = max(0, i - P);
        k1 = min(n - 1, i + P);
    } else {
        k0 = i - l;
        k1 = i - l + P;
    }
}

// 4-byte asynchronous copy global → shared; zero-fills when !valid (src is
// then not read, but must be a valid address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared-memory layout of a block for NF fields at order P (floats).
struct Layout {
    float2* cx;   // TI × nb                 pairs of rows i0 .. i0+TI-1
    float2* cy;   // TJ × nb                 pairs of columns j0 .. j0+TJ-1
    float* sx;    // NF × (TI+2P) × TJ       rows i0-P .. i0+TI+P-1
    float* sy;    // NF × TI × syp           columns j0-P .. j0+TJ+P-1
    float* sk;    // 2NF × TI × (TJ+1)       y sums K, G of each field, in
                  //                         sy's place once sy is read
    int syp;

    __host__ __device__ static size_t coef_floats(int P)
    {
        return (size_t)2 * (TI + TJ) * (2 * P + 1);
    }

    __host__ __device__ static size_t bytes(int NF, int P)
    {
        const size_t a = (size_t)NF * TI * (TJ + 2 * P + 1);
        const size_t b = (size_t)2 * NF * TI * (TJ + 1);
        return sizeof(float) * (coef_floats(P)
                                + (size_t)NF * (TI + 2 * P) * TJ
                                + (a > b ? a : b));
    }

    __device__ Layout(float* smem, int NF, int P)
    {
        syp = TJ + 2 * P + 1;  // odd: a warp's column reads are conflict-free
        cx = reinterpret_cast<float2*>(smem);
        cy = cx + TI * (2 * P + 1);
        sx = smem + coef_floats(P);
        sy = sx + NF * (TI + 2 * P) * TJ;
        sk = sy;
    }

    // y sum `which` (0 = K, 1 = G) of field f at tile node (ii, jj)
    __device__ float& ysum(int f, int which, int ii, int jj) const
    {
        return sk[((2 * f + which) * TI + ii) * (TJ + 1) + jj];
    }
};

// The K and G sums of NG consecutive nodes first .. first+NG-1 of one grid
// line (a column for the x sums, a row for the y sums) of an n-node
// direction; r0 = first minus the tile's first node.  w of field f at line
// index k is s[f*ld_f + (k - base)*ld_k]; the coefficient pair of node
// first+g at tap t is c[(r0 + g)*(2P+1) + t].
template <int PT, int NF, int NG>
__device__ __forceinline__ void line_sums(
    const float* s, int ld_k, int ld_f, int base, const float2* c, int r0,
    int first, int n, int p_rt, float (&ka)[NF][NG], float (&ga)[NF][NG])
{
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int g = 0; g < NG; ++g) ka[f][g] = ga[f][g] = 0.f;
    if constexpr (PT > 0) {
        static_assert(PT % NG == 0 && TI % PT == 0 && TJ % PT == 0,
                      "a warp's nodes must lie in one element");
        constexpr int P = PT, nb = 2 * PT + 1;
        const int l0 = first % P;     // local index of the first node
        const int e0 = first - l0;    // the element's first node
        if (l0 == 0) {
            // interface node: the P nodes of the element on its left first
#pragma unroll
            for (int kk = 0; kk < P; ++kk) {
                const int k = e0 - P + kk;
                const float2 cc = c[r0 * nb + kk];
#pragma unroll
                for (int f = 0; f < NF; ++f) {
                    const float w = s[f * ld_f + (k - base) * ld_k];
                    ka[f][0] = fmaf(cc.x, w, ka[f][0]);
                    ga[f][0] = fmaf(cc.y, w, ga[f][0]);
                }
            }
        }
#pragma unroll
        for (int kk = 0; kk <= P; ++kk) {
            const int k = e0 + kk;
            float w[NF];
#pragma unroll
            for (int f = 0; f < NF; ++f)
                w[f] = s[f * ld_f + (k - base) * ld_k];
#pragma unroll
            for (int g = 0; g < NG; ++g) {
                // tap t = k - (first + g) + P
                const float2 cc = c[(r0 + g) * nb + kk - l0 - g + P];
#pragma unroll
                for (int f = 0; f < NF; ++f) {
                    ka[f][g] = fmaf(cc.x, w[f], ka[f][g]);
                    ga[f][g] = fmaf(cc.y, w[f], ga[f][g]);
                }
            }
        }
    } else {
        const int P = p_rt, nb = 2 * p_rt + 1;
        int k0[NG], k1[NG];
        int kmin = n, kmax = -1;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
            if (first + g < n) {
                tap_span(first + g, P, n, k0[g], k1[g]);
                kmin = min(kmin, k0[g]);
                kmax = max(kmax, k1[g]);
            } else {
                k0[g] = 1; k1[g] = 0;  // empty
            }
        }
        for (int k = kmin; k <= kmax; ++k) {
            float w[NF];
#pragma unroll
            for (int f = 0; f < NF; ++f)
                w[f] = s[f * ld_f + (k - base) * ld_k];
#pragma unroll
            for (int g = 0; g < NG; ++g) {
                if (k >= k0[g] && k <= k1[g]) {
                    const float2 cc = c[(r0 + g) * nb + k - (first + g) + P];
#pragma unroll
                    for (int f = 0; f < NF; ++f) {
                        ka[f][g] = fmaf(cc.x, w[f], ka[f][g]);
                        ga[f][g] = fmaf(cc.y, w[f], ga[f][g]);
                    }
                }
            }
        }
    }
}

// Steps 1-3 above for the tile at (i0, j0), ending with a barrier; input
// row g of field f is fld[f] + (g - W.g_in)·Ngy.  Returns in kx/gx the x
// sums of this thread's nodes (i0 + warp*NG + g, j0 + lane); their y sums
// are L.ysum(f, 0/1, warp*NG + g, lane).
template <int PT, int NF, int NG>
__device__ __forceinline__ void tile_band_sums(
    const Layout& L, const float* const (&fld)[NF],
    const float2* __restrict__ kgx, const float2* __restrict__ kgy,
    const Window& W, int i0, int j0, int Ngx, int Ngy, int p_rt,
    float (&kx)[NF][NG], float (&gx)[NF][NG])
{
    constexpr int NWARP = TI / NG;
    const int P = PT > 0 ? PT : p_rt;
    const int nb = 2 * P + 1;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    // the input rows that are staged; every other row is staged as zeros
    const int g_lo = max(0, W.g_in), g_hi = min(Ngx, W.in_end());

    // ---- 1. stage (warps over rows, lanes along them) ----
    {
        // coefficient rows: TI (TJ) rows of nb pairs from the padded tables
        const float* gx0 = reinterpret_cast<const float*>(kgx + i0 * nb);
        const float* gy0 = reinterpret_cast<const float*>(kgy + j0 * nb);
        float* cx = reinterpret_cast<float*>(L.cx);
        float* cy = reinterpret_cast<float*>(L.cy);
        for (int e = threadIdx.x; e < 2 * TI * nb; e += 32 * NWARP) {
            cp_async4(cx + e, gx0 + e, true);
            cp_async4(cy + e, gy0 + e, true);
        }
        const int j = j0 + lane;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
            float* sx = L.sx + f * (TI + 2 * P) * TJ + lane;
#pragma unroll 4
            for (int a = warp; a < TI + 2 * P; a += NWARP) {
                const int i = i0 - P + a;
                const bool ok = i >= g_lo && i < g_hi && j < Ngy;
                cp_async4(sx + a * TJ,
                          ok ? fld[f] + (size_t)(i - W.g_in) * Ngy + j
                             : fld[f], ok);
            }
            for (int ii = warp; ii < TI; ii += NWARP) {
                const int i = i0 + ii;
                const bool row_ok = i >= g_lo && i < g_hi;
                float* sy = L.sy + f * TI * L.syp + ii * L.syp;
                const float* row =
                    fld[f] + (size_t)(row_ok ? i - W.g_in : 0) * Ngy;
#pragma unroll
                for (int b = lane; b < TJ + 2 * P; b += 32) {
                    const int jb = j0 - P + b;
                    const bool ok = row_ok && jb >= 0 && jb < Ngy;
                    cp_async4(sy + b, ok ? row + jb : fld[f], ok);
                }
            }
        }
    }
    cp_async_wait_all();
    __syncthreads();

    // ---- 2. y sums: lane = row, this warp's NG columns ----
    float ky[NF][NG], gy[NF][NG];
    line_sums<PT, NF, NG>(L.sy + lane * L.syp, 1, TI * L.syp, j0 - P, L.cy,
                          warp * NG, j0 + warp * NG, Ngy, p_rt, ky, gy);
    __syncthreads();   // sy is read: sk takes its place
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int g = 0; g < NG; ++g) {
            L.ysum(f, 0, lane, warp * NG + g) = ky[f][g];
            L.ysum(f, 1, lane, warp * NG + g) = gy[f][g];
        }

    // ---- 3. x sums: lane = column, this warp's NG rows ----
    line_sums<PT, NF, NG>(L.sx + lane, TJ, (TI + 2 * P) * TJ, i0 - P, L.cx,
                          warp * NG, i0 + warp * NG, Ngx, p_rt, kx, gx);
    __syncthreads();
}

// The epilogues take the four band sums of a node and its pointwise values.
// Every rounding is written out (__fmul_rn and __fmaf_rn are never
// contracted or reassociated), in the order in which nvcc contracted the
// plain expressions of the untiled design: written as plain expressions,
// the tiled kernels were contracted otherwise (1-ulp differences).

// Mass-weighted stiffness K w = (K1x W)·m1y + m1x·(W K1yᵀ) at one node.
__device__ __forceinline__ float mass_k(float kx, float ky, float mx,
                                        float my)
{
    return __fmaf_rn(ky, mx, __fmul_rn(kx, my));
}

// Kernel B1: (K + c·(u∂x + v∂y)) w at one node.
__device__ __forceinline__ float system_node(
    float kx, float gx, float ky, float gy, float mx, float my, float u,
    float v, float coef)
{
    const float conv = __fmaf_rn(__fmul_rn(gx, my), u,
                                 __fmul_rn(__fmul_rn(gy, mx), v));
    return __fmaf_rn(conv, coef, mass_k(kx, ky, mx, my));
}

// Kernel B2 off the Dirichlet rows: (dru, drv, drc) at one node from the
// band sums of du (s[0..3] = kx, gx, ky, gy), of dv (s[4..7]) and of dp
// (s[9] = gx, s[11] = gy; its K sums are used only on Dirichlet rows).
__device__ __forceinline__ void coupled_node(
    const float (&s)[12], float mx, float my, float ul, float vl, float jxx,
    float jxy, float jyx, float jyy, float du, float dv, float coef,
    float& ru, float& rv, float& rc)
{
    const float gxu = __fmul_rn(s[1], my), gyu = __fmul_rn(s[3], mx);
    const float gxv = __fmul_rn(s[5], my), gyv = __fmul_rn(s[7], mx);
    float r = __fmaf_rn(__fmaf_rn(gxu, ul, __fmul_rn(gyu, vl)), coef,
                        mass_k(s[0], s[2], mx, my));
    r = __fmaf_rn(du, jxx, r);
    r = __fmaf_rn(dv, jxy, r);
    ru = __fmaf_rn(s[9], my, r);
    r = __fmaf_rn(__fmaf_rn(gxv, ul, __fmul_rn(gyv, vl)), coef,
                  mass_k(s[4], s[6], mx, my));
    r = __fmaf_rn(du, jyx, r);
    r = __fmaf_rn(dv, jyy, r);
    rv = __fmaf_rn(s[11], mx, r);
    rc = __fadd_rn(gxu, gyv);
}

// Raise the kernel's dynamic shared-memory limit once per device when a
// launch needs more than the default 48 KB.
template <class Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes, int* done)
{
    if (bytes <= 48 * 1024) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (done[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               232448);  // all a block may have (227 KB)
    if (err == cudaSuccess) done[dev] = 1;
    return err;
}

}  // namespace tile
}  // namespace sem_tpu_torch
