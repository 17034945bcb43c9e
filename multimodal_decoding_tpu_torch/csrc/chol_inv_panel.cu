// Batched inverse Cholesky factor of SPD panels, for Hopper (sm_90a).
//
// Replaces the TPU kernel multimodal_decoding_tpu/ops/pallas_solvers.py::
// chol_inv_panel: for each [PB, PB] float32 SPD block A of a batch, write
// L^-1, where L = chol(A) is lower triangular (zeros above the diagonal).
// The callers form A^-1 = L^-T L^-1 with a GEMM.
//
// Bound on an H100 SXM at the main path's shape (B = 128, PB = 188): the
// launch reads the lower triangle of each block, PB (PB + 1) / 2 floats (all
// that chol(A) depends on), and writes the full block, so it moves
// 128 * (188 * 189 / 2 + 188^2) * 4 B = 27.2 MB (8.1 us at 3.35 TB/s); it
// does 2/3 * PB^3 * B = 0.57 GFLOP of float32 arithmetic (8.5 us at
// 67 TFLOP/s outside the tensor cores), so operations bound it at ~8.5 us.
// A launch holds 128 blocks for 132 SMs, so each block keeps one SM to
// itself and the kernel is bound by how fast one SM walks one block: by the
// chain of PB dependent column steps (a shuffle, an rsqrt, a multiply, an
// FMA each) and by the latency of the small products between them.
//
// Design: one CTA of 12 warps per matrix; the blocked (BLAS-3), right-looking
// form of the TPU kernel's recursion, in panels of NB = 32 columns.  The lower
// triangle of A lives in dynamic shared memory (PB <= 192: 192 x 196 floats,
// 147 KB), padded with zeros to PB rounded up to 4 rows, with a row stride
// LD = 4 mod 32 (16-byte aligned rows).  Zeros stay zeros: no step writes
// above the diagonal or past row PB, so every product runs over whole groups
// of 4 without masks.  L^-1 = M is formed in the same pass as L: for panel p,
// D_p = L_pp^-1 (the leaf) and M[p, :lo] = -D_p T_p, where
// T_p = sum_{q < p} L[p, q] M[q, :] accumulates in the rows below each panel q
// as q finishes (TPU: bl = -l22i l21 l11i).  Step p, one block barrier each:
//   A. All warps: M[p, :lo] = -D_p T_p over T_p (panel p's rows are then
//      final), and L21 = A21 D_p^T into a transposed 32 x LD panel buffer.
//   B. Warps 0 and 1 apply the trailing update to the next diagonal block
//      and warp 0 factors it (the next leaf) while the other warps store
//      panel p's rows and take 8 x 4 tiles of the rest from a shared counter:
//      A22 -= L21 L21^T (lower tiles) and T += L21 M[p, :] (over A21, in
//      panel p's columns, T = L21 D_p); warp 0 joins them after its leaf.
//      The serial leaf thus runs beside the step's products, not after them.
// Leaf (one warp, no block barrier): a Cholesky sweep over the 32 columns
// (lane i holds row i of the block, identity past a ragged edge; rsqrt per
// column, as the TPU kernel), then forward substitution for D (lane c holds
// column c of D); each is a loop with its registers shifted one place per
// column, so that every index is fixed and the code stays in the instruction
// cache; columns of L reach the lanes as 16-byte broadcast loads.
// Load: warp 0 copies the first diagonal block (cp.async) and factors it
// while the other warps copy the rest; each panel's rows go out to device
// memory during the next step.
// Every product reads 16-byte rows into 4 x 4 or 8 x 4 register tiles, so a
// float loaded from shared memory feeds 4 to 8 FMAs (the unblocked kernel it
// replaces did one shared read-modify-write per FMA).  Block barriers: 2 per
// panel, 12 at PB = 188 (the unblocked kernel: 2 per column, 752).  Strict
// float32 FFMA throughout; no tensor cores.  No pivoting: a block that is not
// SPD yields NaN, as the TPU kernel does.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libchol_inv_panel.so chol_inv_panel.cu

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPanel = 192;
constexpr int kNB = 32;         // panel width: one warp's leaf
constexpr int kLdD = kNB + 4;   // row stride of the D^T buffer (4 mod 32)

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void sts4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[ii][jj] += sum_{k0 <= k < k1} A[ii][k] * B[k][jj], A row-major from
// `a` (row stride lda), B from `b` (row stride ldb); k0, k1 multiples of 4.
__device__ __forceinline__ void tile_a_rows(const float* a, int lda, const float* b, int ldb,
                                            int k0, int k1, float (&acc)[4][4]) {
  for (int k = k0; k < k1; k += 4) {
    float4 av[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) av[ii] = lds4(a + ii * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 bv = lds4(b + (k + kk) * ldb);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float aik = comp(av[ii], kk);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(aik, comp(bv, jj), acc[ii][jj]);
      }
    }
  }
}

// acc[ii][jj] += sum_{k0 <= k < 32} At[k][ii] * B[k][jj] for an 8 x 4 tile,
// A given transposed: 3 loads of 16 bytes per 32 FMAs.
__device__ __forceinline__ void tile_a_cols(const float* at, int lda, const float* b, int ldb,
                                            int k0, float (&acc)[8][4]) {
#pragma unroll 2
  for (int k = k0; k < kNB; ++k) {
    const float4 a0 = lds4(at + k * lda);
    const float4 a1 = lds4(at + k * lda + 4);
    const float4 bv = lds4(b + k * ldb);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        acc[ii][jj] = fmaf(comp(a0, ii), comp(bv, jj), acc[ii][jj]);
        acc[ii + 4][jj] = fmaf(comp(a1, ii), comp(bv, jj), acc[ii + 4][jj]);
      }
    }
  }
}

// 4-byte asynchronous copy from device to shared memory (no register stop).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// Column j of the leaf's Cholesky sweep (below).  Lane i holds r[m] =
// A[i][j + m], its row of the block from column j on, updated through column
// j - 1 (RW entries live).  Column j of L goes to lc[j][m] = L[j + m][j] (the
// lanes <= j write the zeros that wrap around) and every lane reads it back
// as 16-byte broadcast loads; the row update shifts r left by one, so every
// register index stays fixed and the loop need not be unrolled.
template <int RW>
__device__ __forceinline__ void chol_column(int j, float (&r)[kNB], float& pivot, float* lc,
                                            float* inv_d, int lane) {
  const float djj = __shfl_sync(0xffffffffu, pivot, j);
  const float inv = rsqrtf(djj);
  if (lane == 0) inv_d[j] = inv;
  const float lj = (lane > j) ? r[0] * inv : 0.0f;
  // lane j + 1's next pivot from its own lj: the serial chain from one column
  // to the next is one shuffle, one rsqrt, one multiply and one FMA
  pivot = fmaf(-lj, lj, r[1]);
  float* col = lc + j * kNB;
  col[(lane - j) & (kNB - 1)] = lj;
  __syncwarp();
#pragma unroll
  for (int g = 0; g < RW / 4; ++g) {
    const float4 v = lds4(col + 4 * g);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (4 * g + q > 0) r[4 * g + q - 1] = fmaf(-lj, comp(v, q), r[4 * g + q]);
    }
  }
  r[RW - 1] = 0.0f;
}

// Column j of the leaf's triangular inverse: lane c holds y[m] = X[j + m][c]
// of its column of X = L^-1 under forward substitution (RW entries live);
// row j of X is final, and L's column j takes it out of the rows below.
template <int RW>
__device__ __forceinline__ void inv_column(int j, float (&y)[kNB], const float* lc,
                                           const float* inv_d, float* s, int ld, int lo, int w,
                                           float* dt, int lane) {
  const float xj = y[0] * inv_d[j];
  dt[lane * kLdD + j] = xj;  // D^T[c][j]
  if (lane <= j && j < w) s[(lo + j) * ld + lo + lane] = xj;
  const float* col = lc + j * kNB;
#pragma unroll
  for (int g = 0; g < RW / 4; ++g) {
    const float4 v = lds4(col + 4 * g);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (4 * g + q > 0) y[4 * g + q - 1] = fmaf(-comp(v, q), xj, y[4 * g + q]);
    }
  }
  y[RW - 1] = 0.0f;
}

// One warp: factor the w x w (w <= 32) diagonal block at s[lo][lo] and invert
// its factor.  D = chol(block)^-1 replaces the block (lower; the zeros above
// stay), D^T goes to dt [32][kLdD] (identity past w).  Two sweeps over the
// 32 columns, each a loop that runs from the instruction cache: the Cholesky
// factor (lane i holds row i of the block, identity past w; the columns of L
// go to lc [32][32]), then forward substitution for D (lane c holds column c
// of D).  Past column 16 a row has at most 16 entries left to update.
__device__ __forceinline__ void leaf(float* s, int ld, int lo, int w, float* dt, float* lc,
                                     float* inv_d, int lane) {
  float r[kNB];
#pragma unroll
  for (int k = 0; k < kNB; ++k) {
    r[k] = (lane < w && k <= lane) ? s[(lo + lane) * ld + lo + k]
                                   : (k == lane ? 1.0f : 0.0f);
  }
  float pivot = r[0];
#pragma unroll 4
  for (int j = 0; j < kNB / 2; ++j) chol_column<kNB>(j, r, pivot, lc, inv_d, lane);
#pragma unroll 4
  for (int j = kNB / 2; j < kNB; ++j) chol_column<kNB / 2>(j, r, pivot, lc, inv_d, lane);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kNB; ++k) r[k] = (k == lane) ? 1.0f : 0.0f;
#pragma unroll 4
  for (int j = 0; j < kNB / 2; ++j) inv_column<kNB>(j, r, lc, inv_d, s, ld, lo, w, dt, lane);
#pragma unroll 4
  for (int j = kNB / 2; j < kNB; ++j) {
    inv_column<kNB / 2>(j, r, lc, inv_d, s, ld, lo, w, dt, lane);
  }
}

// (d) 8 x 4 tile t of T[r, :r_lo] for the rows below panel p (at lo):
// T[r, :lo] += L21 M[p, :lo]; T[r, p] = L21 D_p, over A21.  pt holds L21^T.
__device__ __forceinline__ void t_tile(float* s, const float* pt, int ld, int n, int lo, int t) {
  const int r_lo = lo + kNB;
  const int n_cb = r_lo / 4;
  const int rb = t / n_cb;
  const int r0 = r_lo + 8 * rb;
  const int c0 = 4 * (t - rb * n_cb);
  const bool own = c0 >= lo;  // panel p's columns: D_p is lower
  float acc[8][4] = {};
  tile_a_cols(pt + r0, ld, s + lo * ld + c0, ld, own ? c0 - lo : 0, acc);
#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    if (r0 + ii < n) {
      float* d = s + (r0 + ii) * ld + c0;
      const float4 o = own ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : lds4(d);
      sts4(d, o.x + acc[ii][0], o.y + acc[ii][1], o.z + acc[ii][2], o.w + acc[ii][3]);
    }
  }
}

// (e) A22 -= L21 L21^T for the trailing block at r_lo, in lower 8 x 4 tiles:
// row tile rb (8 rows) has column tiles 0 .. 2 rb + 1, enumerated row by row.
__device__ __forceinline__ void syrk_tile(float* s, const float* pt, int ld, int n, int r_lo,
                                          int u) {
  int rb = static_cast<int>((sqrtf(4.0f * u + 1.0f) - 1.0f) * 0.5f);
  while (rb * (rb + 1) > u) --rb;
  while ((rb + 1) * (rb + 2) <= u) ++rb;
  const int r0 = r_lo + 8 * rb;
  const int c0 = r_lo + 4 * (u - rb * (rb + 1));
  float acc[8][4] = {};
  tile_a_cols(pt + r0, ld, pt + c0, ld, 0, acc);
  // rows of 16 bytes; entries above the diagonal keep their zeros.  A row the
  // tile does not reach (c0 > r) is not stored: where LD = PB rounded up to 4,
  // its columns would run past the row into the next one, which a T tile
  // updates at the same time
#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    const int r = r0 + ii;
    if (r < n && c0 <= r) {
      float* d = s + r * ld + c0;
      const float4 o = lds4(d);
      sts4(d, o.x - (c0 <= r ? acc[ii][0] : 0.0f), o.y - (c0 + 1 <= r ? acc[ii][1] : 0.0f),
           o.z - (c0 + 2 <= r ? acc[ii][2] : 0.0f), o.w - (c0 + 3 <= r ? acc[ii][3] : 0.0f));
    }
  }
}

// Rows [r_begin, r_end) of the result out: M's lower triangle, zeros above.
__device__ __forceinline__ void store_rows(float* dst, const float* s, int ld, int n, int r_begin,
                                           int r_end, int first_warp, int n_warps, int warp,
                                           int lane) {
  for (int i = r_begin + warp - first_warp; i < r_end; i += n_warps) {
    for (int k = lane; k < n; k += 32) dst[i * n + k] = (k <= i) ? s[i * ld + k] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
chol_inv_panel_kernel(const float* __restrict__ a, float* __restrict__ out, int n, int ld) {
  extern __shared__ __align__(16) float smem[];
  const int np = (n + 3) & ~3;  // rows rounded up to a tile
  float* s = smem;              // [np][ld]  A -> L -> L^-1, lower; zeros elsewhere
  float* pt = s + np * ld;      // [kNB][ld] L21^T of the current panel
  float* dt = pt + kNB * ld;    // [kNB][kLdD] D^T of the current panel
  float* lc = dt + kNB * kLdD;  // [kNB][kNB] the leaf's columns of L
  float* inv_d = lc + kNB * kNB;  // [kNB] the leaf's 1 / L[j][j]
  int* next_tile = reinterpret_cast<int*>(inv_d + kNB);  // work counter of step B

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t offset = static_cast<size_t>(blockIdx.x) * n * n;
  const float* src = a + offset;
  float* dst = out + offset;

  // A's lower triangle in; zeros elsewhere.  Warp 0 copies the first
  // diagonal block and factors it while the other warps copy the rest.
  if (warp == 0) {
    for (int i = 0; i < min(kNB, np); ++i) {
      if (i < n && lane <= i) {
        cp_async4(s + i * ld + lane, src + i * n + lane);
      } else if (lane < ld) {
        s[i * ld + lane] = 0.0f;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    leaf(s, ld, 0, min(kNB, n), dt, lc, inv_d, lane);
  } else {
    for (int i = warp - 1; i < np; i += kWarps - 1) {
      for (int k = (i < kNB ? kNB : 0) + lane; k < ld; k += 32) {
        if (i < n && k <= i) {
          cp_async4(s + i * ld + k, src + i * n + k);
        } else {
          s[i * ld + k] = 0.0f;
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  // Step p (columns lo..lo+32), with D_p = L_pp^-1 in place and in dt.
  // Rows below panel p hold A, then T_p = sum_{q < p} L[p, q] M[q, :].
  int lo = 0;
  for (;; lo += kNB) {
    const int wp = (min(kNB, n - lo) + 3) & ~3;
    const int r_lo = lo + kNB;  // first row below the panel

    // A. Work items of two 4 x 4 tiles each, tiles k and 7 - k of a strip, so
    //    that every item sums over 36 (not up to 32 + 32) and all fit in one
    //    round of the threads:
    //    (b) M[p, :lo] = -D_p T_p over T_p: item (column strip, q) owns rows
    //        lo + 4q.. and lo + 28 - 4q.., columns c0..c0+3.  D_p is lower: row
    //        r0 + ii needs T_p's rows below r0 + 4 only.  The 4 items of a
    //        strip read its rows and overwrite them, all in one warp: a
    //        __syncwarp orders it.
    //    (c) L21 = A21 D_p^T into pt: item (row strip, q) owns columns 4q..
    //        and 28 - 4q.. of rows r0..r0+3 (rows past n give zeros).
    const int n_b = lo;  // 4 items per column strip of 4
    const int n_strip = r_lo < n ? (np - r_lo) / 4 : 0;
    const int n_items = n_b + 4 * n_strip;
    for (int base = warp * 32; base < n_items; base += kThreads) {
      const int t = base + lane;
      float acc[2][4][4] = {};
      int r0[2], c0[2];
      if (t < n_b) {
        c0[0] = c0[1] = 4 * (t >> 2);
        r0[0] = 4 * (t & 3);
        r0[1] = 28 - r0[0];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (r0[h] < wp) {
            tile_a_rows(s + (lo + r0[h]) * ld + lo, ld, s + lo * ld + c0[h], ld, 0, r0[h] + 4,
                        acc[h]);
          }
        }
      } else if (t < n_items) {
        r0[0] = r0[1] = r_lo + 4 * ((t - n_b) >> 2);
        c0[0] = 4 * (t & 3);
        c0[1] = 28 - c0[0];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          tile_a_rows(s + r0[h] * ld + lo, ld, dt + c0[h], kLdD, 0, c0[h] + 4, acc[h]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            sts4(pt + (c0[h] + jj) * ld + r0[h], acc[h][0][jj], acc[h][1][jj], acc[h][2][jj],
                 acc[h][3][jj]);
          }
        }
      }
      __syncwarp();
      if (t < n_b) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            if (r0[h] < wp && lo + r0[h] + ii < n) {
              sts4(s + (lo + r0[h] + ii) * ld + c0[h], -acc[h][ii][0], -acc[h][ii][1],
                   -acc[h][ii][2], -acc[h][ii][3]);
            }
          }
        }
      }
    }
    if (tid == 0) *next_tile = 0;
    __syncthreads();
    if (r_lo >= n) break;

    // B.  The counter hands out 32 tiles to a warp at a time.
    const int nb8 = (n_strip + 1) / 2;           // 8-row tiles below the panel
    const int nd8 = min(4, nb8);                 // ... of the next diagonal block
    const int n_diag = nd8 * (nd8 + 1);
    const int n_t = nb8 * (r_lo / 4);            // 8 x 4 tiles of T's update
    const int n_work = n_t + nb8 * (nb8 + 1) - n_diag;
    if (warp < 2) {  // warps 0 and 1: the next diagonal block's tiles
      for (int u = tid; u < n_diag; u += 64) syrk_tile(s, pt, ld, n, r_lo, u);
      asm volatile("bar.sync 1, 64;\n" ::: "memory");
    }
    if (warp == 0) {
      leaf(s, ld, r_lo, min(kNB, n - r_lo), dt, lc, inv_d, lane);
    } else {
      store_rows(dst, s, ld, n, lo, r_lo, 1, kWarps - 1, warp, lane);
    }
    for (;;) {
      int base = 0;
      if (lane == 0) base = atomicAdd(next_tile, 32);
      base = __shfl_sync(0xffffffffu, base, 0);
      if (base >= n_work) break;
      const int t = base + lane;
      if (t < n_t) {
        t_tile(s, pt, ld, n, lo, t);
      } else if (t < n_work) {
        syrk_tile(s, pt, ld, n, r_lo, t - n_t + n_diag);
      }
    }
    __syncthreads();
  }

  // The last panel's rows out.
  store_rows(dst, s, ld, n, lo, n, 0, kWarps, warp, lane);
}

}  // namespace

// a, out: [batch, pb, pb] float32, contiguous, on the device; stream: the
// caller's cudaStream_t.  Returns the cudaError_t of the launch (0 = ok).
extern "C" int chol_inv_panel_launch(const void* a, void* out, int batch,
                                     int pb, void* stream) {
  if (batch <= 0 || pb <= 0 || pb > kMaxPanel) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int np = (pb + 3) & ~3;
  const int ld = ((np + 27) / 32) * 32 + 4;  // the least stride >= np that is 4 mod 32
  const size_t smem =
      (static_cast<size_t>(np + kNB) * ld + kNB * kLdD + kNB * kNB + kNB + 4) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      chol_inv_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_inv_panel_kernel<<<batch, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(out), pb, ld);
  return static_cast<int>(cudaGetLastError());
}
