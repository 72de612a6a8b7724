// Tensor-core band products on bf16 fields (sm_90a): the tiled kernels B1
// and B2 at bf16 and their row-strip forms B3 and B4 (apply_system.cu,
// coupled_system.cu), the products that the reference's Pallas kernels run
// as MXU matmuls on bf16 operands with f32 accumulation (pallas_kernels.py,
// _kernel and _coupled_kernel).
//
// A block owns the TI × TJ output tile at (i0, j0) of tile.cuh's lattice
// (Window, row strips and all).  Both directions are dense products of a
// band block with a tile of the field:
//   x sums  [K|G]x(i, j) = Σ_k [K1x|G1x](i, k) · W(k, j)
//   y sums  [K|G]y(i, j) = Σ_k W(i, k) · [K1y|G1y](j, k)
// with k over the band of the tile's nodes, and run on mma.sync m16n8k16
// (bf16 operands, f32 accumulators; the bf16 products are exact in f32).
//
// Staging (copy_fields, align_fields).  Shared memory holds, as bf16:
//   * s: each field's rows i0-Q .. i0-Q+16·nk-1 and columns j0-Q ..
//     j0-Q+16·nk-1 (zeros outside the input buffer and the grid), where
//     Q = halo(P) is P rounded up to 8 and nk = chunks(P) the number of
//     16-wide k chunks that cover Q + TI + P: the x sums read s's rows as
//     k, the y sums its columns;
//   * cx, cy: the band blocks of the tile's rows and columns,
//     bx[t, op, r, c] = [K1x|G1x](t·TI + r, t·TI - Q + c), built on the host
//     in this layout (sem_tpu_torch.ops.kernels.band_blocks) and copied flat.
// Every row has the pitch 16·nk + 8 values, an odd number of 16-byte units,
// so that the eight rows an ldmatrix phase reads fall in distinct banks.
// All copies are bulk cp.async (cp.async.bulk: Hopper's copy engine, 16-byte
// aligned, completing on an mbarrier): each band block in one copy, each
// staged row in one.  A field row of Ngy values rarely starts on a 16-byte
// boundary (Ngy = N_ey·P + 1 is odd), so a row's copy is the 16-byte-aligned
// chunks that cover it (copy_span), and once they have landed one thread
// per row (two or four for a single field) shifts it into place in shared
// memory (align_fields), zeroing the values beyond the grid's columns.
// (One copy per row, not one per 16-byte chunk: ~420 copy instructions per
// tile at P16 instead of ~3,900, and no zero-filled chunks.)
//
// Products (band_products).  Warp w computes the 16 × 8 nodes at rows
// i0 + 16·(w mod 2) and columns j0 + 8·(w div 2) for every field, the K and
// G sums of both directions: 4 f32 accumulators per sum, 16·NF per thread.
// A node couples only the nodes of its element(s) (tile::tap_span), so the
// k chunks run are those that hold a nonzero coefficient of the warp's rows
// (x) or columns (y); a skipped chunk would add exact zeros.  The chunks a
// node sums depend on the global tile lattice alone, so a strip's rows are
// the whole-grid launch's bits.
//
// Stores (store_tiles).  The caller's epilogue writes its outputs, rounded
// to bf16, into shared tiles of OUT_PITCH values per row in cx/cy's place;
// a warp then stores one row of an output at a time, lane = column.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile.cuh"

namespace sem_tpu_torch {
namespace mma {

using bf16 = __nv_bfloat16;
using tile::TI;
using tile::TJ;
using tile::Window;

constexpr int NWARP = 8;                 // 2 × 4 warps of 16 × 8 nodes
constexpr int THREADS = 32 * NWARP;
static_assert(TI == 32 && TJ == 32, "the warps' 16 x 8 blocks cover the tile");

// Left halo of a staged tile (P rounded up to 8: the tile's own rows and
// columns start on a 16-byte boundary), the 16-wide k chunks that cover
// it, the tile and the right halo, and the pitch of a staged row (values).
// Mirrored by sem_tpu_torch.ops.kernels.mma_geometry, which the host
// checks against sem_mma_geometry (coupled_system.cu) at first use.
__host__ __device__ constexpr int halo(int P) { return (P + 7) / 8 * 8; }
__host__ __device__ constexpr int chunks(int P)
{
    return (halo(P) + TI + P + 15) / 16;
}
__host__ __device__ constexpr int pitch(int P) { return 16 * chunks(P) + 8; }

// Shared-memory layout of a block for NF fields at order P.
struct Layout {
    bf16* cx;   // 2 × TI × sp     K1x, G1x rows of the tile's rows
    bf16* cy;   // 2 × TJ × sp     K1y, G1y rows of the tile's columns
    bf16* s;    // NF × rows × sp  field f at rows/columns i0-Q.., j0-Q..
    int Q, nk, rows, sp;

    __host__ static size_t bytes(int NF, int P)
    {
        return sizeof(bf16) * pitch(P)
            * (2 * TI + 2 * TJ + (size_t)NF * 16 * chunks(P));
    }

    __device__ Layout(void* smem, int P)
        : Q(halo(P)), nk(chunks(P)), rows(16 * chunks(P)), sp(pitch(P))
    {
        cx = static_cast<bf16*>(smem);
        cy = cx + 2 * TI * sp;
        s = cy + 2 * TJ * sp;
    }
};

__device__ __forceinline__ unsigned smem_u32(const void* p)
{
    return (unsigned)__cvta_generic_to_shared(p);
}

// The block's copies complete on one mbarrier in shared memory: every
// thread registers the bytes of its copies (expect_tx) before it starts
// them, then arrives once; the phase completes when every thread has
// arrived and every byte has landed.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned phase)
{
    unsigned done = 0;
    while (!done)
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_u32(bar)), "r"(phase)
                     : "memory");
}

// One bulk copy (cp.async.bulk, Hopper's copy engine) of `bytes` (a
// multiple of 16) global → shared, both 16-byte aligned, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar)
{
    asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                 "complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes),
                    "r"(smem_u32(bar))
                 : "memory");
}

// Start the bulk copy of the 16-byte-aligned chunks that cover the bytes
// [p + lo, p + hi) (none when lo >= hi) into the same chunks of dst, whose
// chunk 0 is p's chunk (at most n16 chunks); returns p's offset in its
// chunk (bytes).  dst's other chunks are left as they are.
__device__ __forceinline__ int copy_span(void* dst, const void* p, int lo,
                                         int hi, int n16, uint64_t* bar)
{
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const int s = (int)(a & 15);
    if (lo < hi) {
        const int c0 = (s + lo) >> 4, c1 = min((s + hi - 1) >> 4, n16 - 1);
        bulk_copy(static_cast<char*>(dst) + 16 * c0,
                  reinterpret_cast<const void*>((a & ~(uintptr_t)15)
                                                + 16 * c0),
                  16 * (c1 - c0 + 1), bar);
    }
    return s;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p)
{
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const bf16* p)
{
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 "
                 "{%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}

// d += a · b on the tensor cores: a 16 × 16 (row), b 16 × 8 (col), bf16
// operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                 "{%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
}

// Values s .. s+7 (0 <= s < 8) of the 16 values in two consecutive
// 16-byte chunks; s is the same for the lanes of a staged row.
__device__ __forceinline__ uint4 shift_chunk(uint4 lo, uint4 hi, int s)
{
    const uint32_t u[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const int h = s >> 1;
    uint32_t v[5];
#pragma unroll
    for (int m = 0; m < 5; ++m) {        // v[m] = u[h + m], without local
        uint32_t x = u[m];               // memory
        x = h == 1 ? u[m + 1] : x;
        x = h == 2 ? u[m + 2] : x;
        x = h == 3 ? u[m + 3] : x;
        v[m] = x;
    }
    uint32_t o[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
        o[m] = (s & 1) ? __byte_perm(v[m], v[m + 1], 0x5432) : v[m];
    return make_uint4(o[0], o[1], o[2], o[3]);
}

// Aligned chunk c of a staged row (copy_span; its first value at byte s
// of chunk 0) from its chunks c and c + 1, the values outside columns
// [lo, hi) zeroed.
__device__ __forceinline__ uint4 aligned_chunk(uint4 cur, uint4 nxt, int s,
                                               int c, int lo, int hi)
{
    uint4 v = shift_chunk(cur, nxt, s >> 1);
    if (8 * c < lo || 8 * c + 8 > hi) {          // the grid's edges
        // the halves of the word that holds columns b, b + 1
        auto keep = [lo, hi](int b) {
            return (b >= lo && b < hi ? 0x0000FFFFu : 0u)
                 | (b + 1 >= lo && b + 1 < hi ? 0xFFFF0000u : 0u);
        };
        v.x &= keep(8 * c);
        v.y &= keep(8 * c + 2);
        v.z &= keep(8 * c + 4);
        v.w &= keep(8 * c + 6);
    }
    return v;
}

// Shift a staged row of n + 1 chunks in place to n aligned chunks
// (aligned_chunk), every value zeroed when !ok (a row that was not
// copied); one thread per row, once the copies have landed.
__device__ __forceinline__ void align_row(bf16* row, int n, int s, int lo,
                                          int hi, bool ok)
{
    uint4* r = reinterpret_cast<uint4*>(row);
    if (!ok) {
        lo = hi = 0;                 // the chunks hold no value of the row
        s = 0;
    }
    uint4 cur = r[0];
#pragma unroll 8
    for (int c = 0; c < n; ++c) {
        const uint4 nxt = r[c + 1];
        r[c] = aligned_chunk(cur, nxt, s, c, lo, hi);
        cur = nxt;
    }
}

// Staged field row `row` of the tile at (i0, j0): row a = row mod L.rows of
// field f = row div L.rows, grid row i0 - Q + a, whose input row g is
// fld[f] + (g - W.g_in)·Ngy; its first value (column j0 - Q), whether it
// lies in the input buffer and the grid (ok), and the staged columns that
// are read and lie in the grid, [lo, hi) (a halo row's other columns, the
// window's corners, are read by no product: they are staged as zeros).
template <int NF>
struct FieldRow {
    const bf16* p;
    bool ok;
    int lo, hi;

    __device__ FieldRow(const Layout& L, const bf16* const (&fld)[NF],
                        int row, const Window& W, int i0, int j0, int Ngx,
                        int Ngy)
    {
        const int f = row / L.rows;
        const int i = i0 - L.Q + (row - f * L.rows);
        ok = i >= max(0, W.g_in) && i < min(Ngx, W.in_end());
        const bf16* field = fld[0];     // fld[f], kept in registers
#pragma unroll
        for (int k = 1; k < NF; ++k) field = f == k ? fld[k] : field;
        const int jstart = j0 - L.Q;
        p = field + ((ptrdiff_t)(ok ? i - W.g_in : 0) * Ngy + jstart);
        // a halo row is read by the x sums alone, at the tile's columns
        const bool halo = i < i0 || i >= i0 + TI;
        lo = max(halo ? L.Q : 0, -jstart);
        hi = min(halo ? L.Q + TJ : L.rows, Ngy - jstart);
    }
};

// Start the bulk copies of the band blocks bx (tile row) and by (tile
// column) and of the NF fields' rows of the tile at (i0, j0), one thread
// per staged row (the chunks that hold the row's read columns in the
// grid), all completing on bar.  The caller may start more copies, then
// arrives on bar, waits, and calls align_fields.
template <int NF>
__device__ __forceinline__ void copy_fields(
    const Layout& L, const bf16* const (&fld)[NF], const bf16* bx,
    const bf16* by, const Window& W, int i0, int j0, int Ngx, int Ngy,
    uint64_t* bar)
{
    const int block = 2 * TI * L.sp * (int)sizeof(bf16);
    if (threadIdx.x == 0) bulk_copy(L.cx, bx, block, bar);
    if (threadIdx.x == 1) bulk_copy(L.cy, by, block, bar);
    for (int row = threadIdx.x; row < NF * L.rows; row += THREADS) {
        const FieldRow<NF> r(L, fld, row, W, i0, j0, Ngx, Ngy);
        copy_span(L.s + row * L.sp, r.p, 2 * r.lo, r.ok ? 2 * r.hi : 0,
                  2 * L.nk + 1, bar);
    }
}

// Shift every staged field row into place and end with a barrier that
// makes the staged tile visible to every warp.  One thread per row where
// the rows are more than half the block's threads (B2's three fields);
// otherwise (one field) a row's 2·nk chunks are split among tpr = 2 or 4
// consecutive lanes, each of which reads its part and the next part's
// first chunk before any lane of the row writes.
template <int NF>
__device__ __forceinline__ void align_fields(
    const Layout& L, const bf16* const (&fld)[NF], const Window& W, int i0,
    int j0, int Ngx, int Ngy)
{
    const int nrows = NF * L.rows;
    if (2 * nrows > THREADS) {
        for (int row = threadIdx.x; row < nrows; row += THREADS) {
            const FieldRow<NF> r(L, fld, row, W, i0, j0, Ngx, Ngy);
            align_row(L.s + row * L.sp, 2 * L.nk,
                      (int)(reinterpret_cast<uintptr_t>(r.p) & 15), r.lo,
                      r.hi, r.ok);
        }
    } else {
        constexpr int MAXM = 8;    // 2·nk <= 16 here (nrows <= 128), tpr >= 2
        const int n = 2 * L.nk, tpr = 4 * nrows <= THREADS ? 4 : 2;
        const int m = (n + tpr - 1) / tpr;           // chunks per lane
        const unsigned lanes = ((1u << tpr) - 1u)
                             << (threadIdx.x % 32 & ~(tpr - 1));
        if ((int)threadIdx.x < nrows * tpr) {
            const int row = threadIdx.x / tpr, c0 = threadIdx.x % tpr * m;
            const FieldRow<NF> f(L, fld, row, W, i0, j0, Ngx, Ngy);
            uint4* r = reinterpret_cast<uint4*>(L.s + row * L.sp);
            uint4 v[MAXM + 1];
#pragma unroll
            for (int k = 0; k <= MAXM; ++k)
                if (k <= m) v[k] = r[min(c0 + k, n)];
            __syncwarp(lanes);
            int s = (int)(reinterpret_cast<uintptr_t>(f.p) & 15);
            int lo = f.lo, hi = f.hi;
            if (!f.ok) lo = hi = s = 0;
#pragma unroll
            for (int k = 0; k < MAXM; ++k)
                if (k < m && c0 + k < n)
                    r[c0 + k] = aligned_chunk(v[k], v[k + 1], s, c0 + k, lo,
                                              hi);
        }
    }
    __syncthreads();
}

// The k chunks (from the staged block's first row or column, grid node
// origin) that hold the nonzero coefficients of nodes first .. first+m-1
// of an n-node line; false when none of them is in the grid.
__device__ __forceinline__ bool chunk_range(int first, int m, int n, int P,
                                            int origin, int& c0, int& c1)
{
    if (first >= n) return false;
    const int last = min(first + m - 1, n - 1);
    int k0, k1, unused;
    tile::tap_span(first, P, n, k0, unused);   // both ends are monotone in
    tile::tap_span(last, P, n, unused, k1);    // the node
    c0 = (k0 - origin) >> 4;
    c1 = (k1 - origin) >> 4;
    return true;
}

// The band sums of warp w's 16 × 8 nodes (header) for NF staged fields:
// ax[f][0/1] the K/G x sums, ay[f][0/1] the K/G y sums, each an m16n8
// accumulator fragment (element 2h + e: row 16·(w mod 2) + lane/4 + 8h,
// column 8·(w div 2) + 2·(lane mod 4) + e of the tile).  A warp whose
// nodes lie outside rows [r0, r1) or the grid's columns leaves them zero.
template <int NF>
__device__ __forceinline__ void band_products(
    const Layout& L, const Window& W, int i0, int j0, int Ngx, int Ngy,
    int P, float (&ax)[NF][2][4], float (&ay)[NF][2][4])
{
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int mb = warp & 1, nb = warp >> 1;
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int op = 0; op < 2; ++op)
#pragma unroll
            for (int e = 0; e < 4; ++e) ax[f][op][e] = ay[f][op][e] = 0.f;
    const int ib = i0 + 16 * mb, jb = j0 + 8 * nb;
    if (ib >= W.r1 || ib + 16 <= W.r0 || jb >= Ngy) return;
    int c0, c1;
    // x sums: A = the block's rows (cx), B = s's rows k at the warp's
    // columns (transposed ldmatrix: s is k-major)
    // (the asm statements keep their order: every fragment of a chunk is
    // loaded before its products, so a warp waits once per chunk)
    if (chunk_range(ib, 16, Ngx, P, i0 - L.Q, c0, c1)) {
        for (int kc = c0; kc <= c1; ++kc) {
            uint32_t a[2][4], b[NF][2];
#pragma unroll
            for (int op = 0; op < 2; ++op)
                ldsm_x4(a[op], L.cx + (op * TI + 16 * mb + (lane & 15)) * L.sp
                                   + 16 * kc + 8 * (lane >> 4));
#pragma unroll
            for (int f = 0; f < NF; ++f)
                ldsm_x2_trans(b[f], L.s + (f * L.rows + 16 * kc
                                           + (lane & 15)) * L.sp
                                        + L.Q + 8 * nb);
#pragma unroll
            for (int f = 0; f < NF; ++f)
#pragma unroll
                for (int op = 0; op < 2; ++op)
                    mma_bf16(ax[f][op], a[op], b[f][0], b[f][1]);
        }
    }
    // y sums: A = s's rows at the warp's rows, k along them; B = the
    // block's rows of the warp's columns (K in b[0..1], G in b[2..3])
    if (chunk_range(jb, 8, Ngy, P, j0 - L.Q, c0, c1)) {
        for (int kc = c0; kc <= c1; ++kc) {
            uint32_t b[4], a[NF][4];
            ldsm_x4(b, L.cy + ((lane >> 4) * TJ + 8 * nb + (lane & 7)) * L.sp
                           + 16 * kc + 8 * ((lane >> 3) & 1));
#pragma unroll
            for (int f = 0; f < NF; ++f)
                ldsm_x4(a[f], L.s + (f * L.rows + L.Q + 16 * mb
                                     + (lane & 15)) * L.sp
                                  + 16 * kc + 8 * (lane >> 4));
#pragma unroll
            for (int f = 0; f < NF; ++f) {
                mma_bf16(ay[f][0], a[f], b[0], b[1]);
                mma_bf16(ay[f][1], a[f], b[2], b[3]);
            }
        }
    }
}

// Values per row of a staged output tile (store_tiles): 32 values and 8 of
// padding, so that the fragments' rows fall in distinct banks.
constexpr int OUT_PITCH = 40;

// Store the window's rows of NOUT staged output tiles, output f's tile row
// ii at tile + (f·TI + ii)·OUT_PITCH, to out + f·N (N: one output field of
// the window's rows), coalesced: a warp stores one row at a time, lane =
// column.
template <int NOUT>
__device__ __forceinline__ void store_tiles(bf16* __restrict__ out, size_t N,
                                            const bf16* tile, const Window& W,
                                            int i0, int j0, int Ngy)
{
#pragma unroll
    for (int task = threadIdx.x; task < NOUT * TI * TJ; task += THREADS) {
        const int fr = task / TJ, jj = task % TJ;   // output f's row ii
        const int f = fr / TI, ii = fr % TI, i = i0 + ii, j = j0 + jj;
        if (i >= W.r0 && i < W.r1 && j < Ngy)
            out[f * N + (size_t)(i - W.r0) * Ngy + j] =
                tile[fr * OUT_PITCH + jj];
    }
}

}  // namespace mma
}  // namespace sem_tpu_torch
