// The split and merge passes of the FDM's eigenbasis transform in even-odd
// form on Hopper (sm_90a):
//
//   U = Zx (D ∘ (Zxᵀ R Zy)) Zyᵀ
//
// of FDM2D.__call__ on float32 fields, chained by sem_tpu_torch/ops/gemm.py
// around four batched cuBLAS products of half the depth and width.
//
// It replaces no Pallas kernel: the reference package leaves these
// transforms to XLA.  Both passes are bound by memory: each reads a field
// and writes one (4 MB a 1023² f32 field, about 3 µs at 3.35 TB/s), and
// stands for the dozen elementwise ops the same work takes in PyTorch (the
// window's copy, the corrections, the sums and differences of mirrored rows
// and columns, their merge, the ring).  A block takes one output row at a
// time and its threads the row's consecutive columns, so the field's rows,
// their mirrors and the halves are read and written in whole lines, and
// the row's indices are decoded once, in 32-bit arithmetic (ops/gemm.py
// checks that the rows fit).
//
// split: the right-hand side R of the transform from a window of a field F
// (batch × Ngx × Ngy, element (f, x, y) at F + f·f_bs + x·f_ld + y; the
// window's rows x0 .. x0+p-1 and columns y0 .. y0+q-1) less FDM2D's
// Dirichlet corrections
//   R(i, j) = F(x0+i, y0+j) - (cw_i F(0, y0+j)) m1y_j
//             - (ce_i F(Ngx-1, y0+j)) m1y_j - (F(x0+i, 0) cs_j) m1x_i
//             - (F(x0+i, Ngy-1) cn_j) m1x_i
// (the terms whose coefficients are given, in this order, in FDM2D's f32
// operations), split per field and parity pair (ax, by) into the P × Q
// values (P = p - p/2, Q = q - q/2)
//   R̂(k, l) = Σ± R(k or p-1-k, l or q-1-l)
// (sums for the even parity, differences for the odd, the middle row or
// column alone in the even half and zero in the odd one), written in the
// order (ax, k, f, by, l) with k < Pp and l < Qp, zero past P and Q.
//
// merge: the output field O (strides o_bs, o_ld): in the window the
// products' result U, read in the order (by, ax, k, f, l), even part ± odd
// part, y first then x; the field F's values on the rest.
#include <cuda_runtime.h>

namespace {

struct PassParams {
    const float* f;            // the field F
    const float* u;            // merge: U
    float* out;                // split: R̂; merge: O
    const float* cw;           // Dirichlet corrections (null: none)
    const float* ce;
    const float* cs;
    const float* cn;
    const float* m1x;          // the window's masses (with the corrections)
    const float* m1y;
    long long f_bs, f_ld, o_bs, o_ld;
    int batch, Ngx, Ngy, x0, y0, p, q;
    int Pp, Qp;                // the halves' padded rows and columns
};

__device__ __forceinline__ float rhs(const PassParams& s, const float* F,
                                     int i, int j)
{
    const int x = s.x0 + i, y = s.y0 + j;
    float v = F[x * s.f_ld + y];
    if (s.cw)
        v = __fsub_rn(v, __fmul_rn(__fmul_rn(s.cw[i], F[y]), s.m1y[j]));
    if (s.ce)
        v = __fsub_rn(v, __fmul_rn(__fmul_rn(s.ce[i],
                                             F[(s.Ngx - 1) * s.f_ld + y]),
                                   s.m1y[j]));
    if (s.cs)
        v = __fsub_rn(v, __fmul_rn(__fmul_rn(F[x * s.f_ld], s.cs[j]),
                                   s.m1x[i]));
    if (s.cn)
        v = __fsub_rn(v, __fmul_rn(__fmul_rn(F[x * s.f_ld + s.Ngy - 1],
                                             s.cn[j]),
                                   s.m1x[i]));
    return v;
}

__global__ void sem_evenodd_split_kernel(const PassParams s)
{
    const int P = s.p - s.p / 2, Q = s.q - s.q / 2;
    const int rows = 4 * s.batch * s.Pp;
    for (int r = blockIdx.x; r < rows; r += gridDim.x) {
        // r = ((ax·Pp + k)·batch + f)·2 + by
        const int by = r % 2, fi = r / 2 % s.batch;
        const int k = r / (2 * s.batch) % s.Pp;
        const int ax = r / (2 * s.batch * s.Pp);
        float* o = s.out + (long long)r * s.Qp;
        const float* F = s.f + fi * s.f_bs;
        const int i1 = k, i2 = s.p - 1 - k;
        // rows first, then columns; the middle row or column (i1 == i2)
        // stands alone in the even half and is zero in the odd one
        const auto pair_rows = [&](int j) {
            if (i1 == i2)
                return ax ? 0.0f : rhs(s, F, i1, j);
            const float a = rhs(s, F, i1, j), b = rhs(s, F, i2, j);
            return ax ? __fsub_rn(a, b) : __fadd_rn(a, b);
        };
        for (int l = threadIdx.x; l < s.Qp; l += blockDim.x) {
            float v = 0.0f;
            if (k < P && l < Q) {
                const int j1 = l, j2 = s.q - 1 - l;
                if (j1 == j2) {
                    v = by ? 0.0f : pair_rows(j1);
                } else {
                    const float a = pair_rows(j1), b = pair_rows(j2);
                    v = by ? __fsub_rn(a, b) : __fadd_rn(a, b);
                }
            }
            o[l] = v;
        }
    }
}

__global__ void sem_evenodd_merge_kernel(const PassParams s)
{
    const int P = s.p - s.p / 2, Q = s.q - s.q / 2;
    const int rows = s.batch * s.Ngx;
    const long long pair = 2LL * s.Pp * s.batch * s.Qp;  // by's stride
    const long long half = (long long)s.Pp * s.batch * s.Qp;  // ax's
    for (int r = blockIdx.x; r < rows; r += gridDim.x) {
        const int fi = r / s.Ngx, x = r % s.Ngx;
        const float* F = s.f + fi * s.f_bs + x * s.f_ld;
        float* o = s.out + fi * s.o_bs + x * s.o_ld;
        // the half row, and whether x lies in the mirrored half
        const int i = x - s.x0;
        const bool window_row = i >= 0 && i < s.p, mx = i >= P;
        const int k = mx ? s.p - 1 - i : i;
        for (int y = threadIdx.x; y < s.Ngy; y += blockDim.x) {
            const int j = y - s.y0;
            float v;
            if (!window_row || j < 0 || j >= s.q) {
                v = F[y];
            } else {
                const bool my = j >= Q;
                const int l = my ? s.q - 1 - j : j;
                const float* u = s.u + ((long long)k * s.batch + fi) * s.Qp
                                 + l;
                // u[by * pair + ax * half]; the odd half is zero on the
                // middle row and column
                const float te = my ? __fsub_rn(u[0], u[pair])
                                    : __fadd_rn(u[0], u[pair]);
                const float to = my ? __fsub_rn(u[half], u[pair + half])
                                    : __fadd_rn(u[half], u[pair + half]);
                v = mx ? __fsub_rn(te, to) : __fadd_rn(te, to);
            }
            o[y] = v;
        }
    }
}

}  // namespace

// The transform's split (merge = 0) or merge (1) pass on `stream`, `grid`
// blocks of 256 threads striding over the output's rows; returns the
// launch's cudaError_t.
extern "C" int sem_evenodd_pass_f32(const void* params, int merge, int grid,
                                    void* stream)
{
    const PassParams& s = *static_cast<const PassParams*>(params);
    if (merge)
        sem_evenodd_merge_kernel<<<grid, 256, 0,
                                   static_cast<cudaStream_t>(stream)>>>(s);
    else
        sem_evenodd_split_kernel<<<grid, 256, 0,
                                   static_cast<cudaStream_t>(stream)>>>(s);
    return static_cast<int>(cudaGetLastError());
}
