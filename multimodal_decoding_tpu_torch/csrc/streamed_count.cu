// Streamed pairwise-accuracy counts for Hopper (sm_90a).
//
// Replaces the three TPU kernels of multimodal_decoding_tpu/ops/pallas_metrics.py:
//   streamed_pairwise_acc      (_count_kernel)        -> streamed_count_launch
//   streamed_acc_from_factors  (_factor_count_kernel) -> streamed_count_launch
//   streamed_acc_from_inv      (_inv_count_kernel)    -> gemm_store_launch (Z = inv U)
//                                                        + streamed_count_launch
// For each vertex b of a batch and each row i < nv they count
//   #{ j < nv : sim[b, i, j] < sim[b, i, i] },   sim[b] = A[b] Bm[b]  ([nv, kd] x [kd, nv]),
// and add the counts of all rows into counts[b] (int32; the caller zeroes it
// and divides by nv^2 - nv).  The [B, nv, nv] similarity never reaches device
// memory: each block reduces its tile to one integer.
//
// Operands are read through strides, so no caller pads or copies:
//   streamed_pairwise_acc:      A = preds [B, nv, D];  Bm[b, k, j] = y_unit[j, k]
//                               (latents with unit rows, batch stride 0);
//   streamed_acc_from_factors:  A = Xv_b [B, nv, K] (a transposed view of the
//                               fold's [nv, B, K] patches);  Bm = Z [B, K, nv];
//   streamed_acc_from_inv:      Z = inv [B, K, K] x U [B, K, nv] first, by the
//                               same GEMM core with a store epilogue, into a
//                               workspace the caller allocates; then as above.
//
// Bound on an H100 SXM (67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s)
// at the main path's shapes (B = 128, nv = 1639, D = 1024, K = 750):
//   streamed_pairwise_acc      2 B nv^2 D = 7.04e11 FLOP -> 10.5 ms; 0.87 GB -> 0.26 ms
//   streamed_acc_from_factors  2 B nv^2 K = 5.16e11 FLOP ->  7.7 ms; 1.26 GB -> 0.38 ms
//   streamed_acc_from_inv      + 2 B K^2 nv = 7.52e11 FLOP -> 11.2 ms; 1.55 GB -> 0.46 ms
// so operations bound all three, by a factor of ~25 over bytes.  The design
// keeps the work in float32 FMAs on the CUDA cores (no TF32: the counts decide
// the alpha selection, which is gated on strict float32) and moves each
// operand tile through shared memory once per output tile.
//
// Design (a first, simple kernel):
//   * GEMM core: one block of 256 threads per 128 x 128 output tile of one
//     vertex, grid (ceil(nv/128), ceil(nv/128), B), two blocks per SM.  k
//     advances 8 at a time through [8][128] shared-memory stages, two per
//     operand (rows padded by 4 floats, so the stores of either load order
//     are bank-conflict free): the next stage's global loads are issued
//     before the current stage's FMAs, so their latency hides behind them,
//     and are stored into the other stage, so one barrier per stage
//     suffices.  Each thread keeps an 8 x 8 micro-tile of accumulators in
//     registers, and sets up its load pointers once.  Ragged edges (rows,
//     columns, and k past the end) are masked at the load: out-of-range
//     elements are read as 0.
//   * The diagonal must be bit-identical to the (i, i) entry of the same
//     product (pallas_metrics.py:17-23: a diagonal rounded differently flipped
//     near-ties and dropped alpha agreement to 29% on the TPU).  Every entry,
//     in the tile and in the diagonal pass, is one float32 accumulator that
//     starts at 0 and takes __fmaf_rn(a_k, b_k, acc) for k ascending over the
//     same padded range, with no split over k.  A first pass (diag_kernel,
//     the diagonal tiles' stages, one thread per row) writes diag[b, i] that
//     way; the tile's epilogue compares against it.  Built without
//     --use_fast_math.
//   * Counting epilogue: each thread counts its entries with sim < diag under
//     the i < nv, j < nv mask, the block sums the counts (warp shuffles, then
//     shared memory) and does one atomicAdd into counts[b].  Integer sums do
//     not depend on order, so the result is deterministic.
//   * streamed_acc_from_inv keeps Z = inv U on chip on the TPU.  Here Z
//     (4.9 MB per vertex, 630 MB per call) does not fit in a block's 227 KB
//     of shared memory, so it makes a round trip through device memory:
//     630 MB written and read back by the count pass (~0.4 ms at 3.35 TB/s).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libstreamed_count.so streamed_count.cu

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;     // output rows and columns of a block
constexpr int kDepth = 8;      // k per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, an 8 x 8 micro-tile each
constexpr int kLd = kTile + 4;  // padded stage row
constexpr int kPerThread = kTile * kDepth / kThreads;  // stage elements a thread loads

// Element (b, o, k) of an operand lives at p[b * sb + o * so + k * sk]: o is
// the output row for A and the output column for Bm.
struct Operand {
  const float* p;
  long long sb, so, sk;
};

// Where element q of this thread's share of a stage sits: output row or
// column o, depth k.  Neighbouring threads walk the operand's unit-stride axis.
__device__ __forceinline__ void stage_coords(bool k_fast, int q, int& o, int& k) {
  const int e = threadIdx.x + q * kThreads;
  o = k_fast ? e / kDepth : e % kTile;
  k = k_fast ? e % kDepth : e / kTile;
}

// This thread's global loads of one operand, stage after stage: the pointers
// and the row mask are set up once, and each stage advances the pointers.
struct StageLoader {
  const float* ptr[kPerThread];
  bool row_ok[kPerThread];
  long long step;

  __device__ __forceinline__ StageLoader(const Operand& op, int b, int o0, int n_o,
                                         bool k_fast) {
    step = kDepth * op.sk;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      int o, k;
      stage_coords(k_fast, q, o, k);
      row_ok[q] = o0 + o < n_o;
      ptr[q] = op.p + b * op.sb + (o0 + o) * op.so + k * op.sk;
    }
  }

  // The stage at depth k0 into registers; out-of-range elements read as 0.
  __device__ __forceinline__ void load(int k0, int n_k, bool k_fast,
                                       float (&reg)[kPerThread]) {
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      int o, k;
      stage_coords(k_fast, q, o, k);
      reg[q] = (row_ok[q] && k0 + k < n_k) ? *ptr[q] : 0.0f;
      ptr[q] += step;
    }
  }
};

__device__ __forceinline__ void store_stage(float* stage, bool k_fast,
                                            const float (&reg)[kPerThread]) {
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    int o, k;
    stage_coords(k_fast, q, o, k);
    stage[k * kLd + o] = reg[q];
  }
}

// Micro-tile row r (0..7) of thread coordinate t (0..15) within the tile.
__device__ __forceinline__ int micro(int t, int r) { return (r < 4 ? 0 : 64) + t * 4 + (r & 3); }

// acc[r][c] = sum_k A[b, row(r), k] Bm[b, k, col(c)] over k in [0, ceil(kd / 8) * 8).
// Two shared-memory stages per operand: while the block computes on one,
// the next is loaded into registers and stored into the other, so one
// barrier per stage suffices.
__device__ __forceinline__ void gemm_tile(const Operand& a, bool a_k_fast, int m,
                                          const Operand& bm, bool b_k_fast, int n, int kd,
                                          float (&acc)[8][8]) {
  __shared__ __align__(16) float as[2][kDepth * kLd];
  __shared__ __align__(16) float bs[2][kDepth * kLd];
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  StageLoader la(a, b, blockIdx.y * kTile, m, a_k_fast);
  StageLoader lb(bm, b, blockIdx.x * kTile, n, b_k_fast);
  float ra[kPerThread], rb[kPerThread];
  la.load(0, kd, a_k_fast, ra);
  lb.load(0, kd, b_k_fast, rb);
  store_stage(as[0], a_k_fast, ra);
  store_stage(bs[0], b_k_fast, rb);
  __syncthreads();
  int cur = 0;
  for (int k0 = 0; k0 < kd; k0 += kDepth) {
    const bool more = k0 + kDepth < kd;
    if (more) {  // the next stage's loads are in flight during this one's FMAs
      la.load(k0 + kDepth, kd, a_k_fast, ra);
      lb.load(k0 + kDepth, kd, b_k_fast, rb);
    }
    const float* sa = as[cur];
    const float* sb = bs[cur];
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(sa + kk * kLd + ty * 4);
      const float4 a_hi = *reinterpret_cast<const float4*>(sa + kk * kLd + 64 + ty * 4);
      const float4 b_lo = *reinterpret_cast<const float4*>(sb + kk * kLd + tx * 4);
      const float4 b_hi = *reinterpret_cast<const float4*>(sb + kk * kLd + 64 + tx * 4);
      const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float bv[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = __fmaf_rn(av[r], bv[c], acc[r][c]);
    }
    if (more) {
      store_stage(as[cur ^ 1], a_k_fast, ra);
      store_stage(bs[cur ^ 1], b_k_fast, rb);
    }
    __syncthreads();
    cur ^= 1;
  }
}

// diag[b, i] = sum_k A[b, i, k] Bm[b, k, i], with the tile's exact arithmetic:
// one block per 128 rows, whose stages are those of the diagonal tile (rows
// and columns o0 .. o0 + 127, the same loads, the same zero padding of k);
// thread t < 128 accumulates row o0 + t.
__global__ void __launch_bounds__(kThreads)
diag_kernel(Operand a, bool a_k_fast, Operand bm, bool b_k_fast, int nv, int kd,
            float* __restrict__ diag) {
  __shared__ float as[kDepth * kLd];
  __shared__ float bs[kDepth * kLd];
  const int b = blockIdx.y;
  const int o0 = blockIdx.x * kTile;
  StageLoader la(a, b, o0, nv, a_k_fast);
  StageLoader lb(bm, b, o0, nv, b_k_fast);
  float ra[kPerThread], rb[kPerThread];
  float acc = 0.0f;
  for (int k0 = 0; k0 < kd; k0 += kDepth) {
    la.load(k0, kd, a_k_fast, ra);
    lb.load(k0, kd, b_k_fast, rb);
    store_stage(as, a_k_fast, ra);
    store_stage(bs, b_k_fast, rb);
    __syncthreads();
    if (threadIdx.x < kTile) {
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk)
        acc = __fmaf_rn(as[kk * kLd + threadIdx.x], bs[kk * kLd + threadIdx.x], acc);
    }
    __syncthreads();
  }
  const int i = o0 + threadIdx.x;
  if (threadIdx.x < kTile && i < nv) diag[static_cast<long long>(b) * nv + i] = acc;
}

__global__ void __launch_bounds__(kThreads, 2)
count_kernel(Operand a, bool a_k_fast, Operand bm, bool b_k_fast, int nv, int kd,
             const float* __restrict__ diag, int* __restrict__ counts) {
  float acc[8][8];
  gemm_tile(a, a_k_fast, nv, bm, b_k_fast, nv, kd, acc);

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  int count = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + micro(ty, r);
    if (i >= nv) continue;
    const float d = diag[static_cast<long long>(b) * nv + i];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = j0 + micro(tx, c);
      count += (j < nv && acc[r][c] < d) ? 1 : 0;
    }
  }

  __shared__ int warp_counts[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(0xffffffffu, count, off);
  if (threadIdx.x % 32 == 0) warp_counts[threadIdx.x / 32] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_counts[w];
    if (total != 0) atomicAdd(counts + b, total);
  }
}

// c[b, i, j] = sum_k A[b, i, k] Bm[b, k, j], c contiguous [B, m, n].
__global__ void __launch_bounds__(kThreads, 2)
gemm_store_kernel(Operand a, bool a_k_fast, Operand bm, bool b_k_fast, int m, int n,
                  int kd, float* __restrict__ c) {
  float acc[8][8];
  gemm_tile(a, a_k_fast, m, bm, b_k_fast, n, kd, acc);

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float* out = c + static_cast<long long>(b) * m * n;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + micro(ty, r);
    if (i >= m) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = j0 + micro(tx, q);
      if (j < n) out[static_cast<long long>(i) * n + j] = acc[r][q];
    }
  }
}

bool valid_grid(int batch, int rows, int cols) {
  return batch > 0 && batch <= 65535 && rows > 0 && cols > 0 &&
         (rows + kTile - 1) / kTile <= 65535;
}

}  // namespace

// counts[b] += #{(i, j) : i, j < nv, sim[b, i, j] < sim[b, i, i]} with
// sim[b] = A[b] Bm[b]; A[b, i, k] at a + b a_sb + i a_si + k a_sk and
// Bm[b, k, j] at bm + b b_sb + k b_sk + j b_sj (float32 elements, strides in
// elements).  diag: [batch, nv] float32 workspace; counts: [batch] int32,
// zeroed by the caller.  stream: the caller's cudaStream_t.  Returns the
// cudaError_t of the launches (0 = ok).
extern "C" int streamed_count_launch(const void* a, long long a_sb, long long a_si,
                                     long long a_sk, const void* bm, long long b_sb,
                                     long long b_sk, long long b_sj, int batch, int nv,
                                     int kd, void* diag, void* counts, void* stream) {
  if (!valid_grid(batch, nv, nv) || kd <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Operand op_a{static_cast<const float*>(a), a_sb, a_si, a_sk};
  const Operand op_b{static_cast<const float*>(bm), b_sb, b_sj, b_sk};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (nv + kTile - 1) / kTile;
  diag_kernel<<<dim3(tiles, batch), kThreads, 0, s>>>(op_a, a_sk == 1, op_b, b_sk == 1, nv,
                                                     kd, static_cast<float*>(diag));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  count_kernel<<<dim3(tiles, tiles, batch), kThreads, 0, s>>>(
      op_a, a_sk == 1, op_b, b_sk == 1, nv, kd, static_cast<const float*>(diag),
      static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// c[b] = A[b] Bm[b] for A [batch, m, kd] and Bm [batch, kd, n] (strides in
// elements, as above); c: contiguous [batch, m, n] float32.  Returns the
// cudaError_t of the launch (0 = ok).
extern "C" int gemm_store_launch(const void* a, long long a_sb, long long a_si,
                                 long long a_sk, const void* bm, long long b_sb,
                                 long long b_sk, long long b_sj, int batch, int m, int n,
                                 int kd, void* c, void* stream) {
  if (!valid_grid(batch, m, n) || kd <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Operand op_a{static_cast<const float*>(a), a_sb, a_si, a_sk};
  const Operand op_b{static_cast<const float*>(bm), b_sb, b_sj, b_sk};
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile, batch);
  gemm_store_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      op_a, a_sk == 1, op_b, b_sk == 1, m, n, kd, static_cast<float*>(c));
  return static_cast<int>(cudaGetLastError());
}
