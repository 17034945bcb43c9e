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
// Each matrix is a chain of PB dependent column steps, so in practice the
// kernel is bound by that latency chain, not by either rate.
//
// Design (a first, simple kernel): one CTA of 32 warps per matrix.  The
// whole block lives in dynamic shared memory (PB <= 192: 192 * 193 * 4 B =
// 148 KB, past the 48 KB default, so the launcher opts in), padded to an
// odd row stride so that threads walking down a column hit distinct banks.
// With one CTA per SM, 32 warps are what hides shared-memory latency.
// Only A's lower triangle is loaded: nothing below reads the upper one.
//   1. Right-looking Cholesky in place: for each column j, every thread
//      reads d = sqrt(A[j][j]); rows i > j are scaled by 1/d and copied to a
//      column buffer; after a barrier, warps take rows of the trailing
//      triangle and lanes take its columns (A[i][k] -= l_i l_k).  The
//      diagonal goes to a separate vector, so no thread overwrites A[j][j]
//      while others read it.
//   2. Triangular inverse in place (LAPACK trti2 order, j = PB-1 .. 0): the
//      trailing block already holds inv(L[j+1:, j+1:]); column j of L is
//      copied to the buffer, then one warp per row i > j forms
//      Linv[i][j] = -(sum_{j<k<=i} Linv[i][k] * l_k) / L[j][j], lanes
//      striding over k and a shuffle reduction summing them.
//   3. The lower triangle is written out, zeros above it.
// No pivoting: a block that is not SPD yields NaN, as the TPU kernel does.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libchol_inv_panel.so chol_inv_panel.cu

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxPanel = 192;

__global__ void __launch_bounds__(kThreads)
chol_inv_panel_kernel(const float* __restrict__ a, float* __restrict__ out,
                      int pb, int ld) {
  extern __shared__ float smem[];
  float* s = smem;              // [pb, ld] working block
  float* col = s + pb * ld;     // [pb] current column
  float* diag = col + pb;       // [pb] diagonal of L

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = kThreads / 32;
  const size_t offset = static_cast<size_t>(blockIdx.x) * pb * pb;
  const float* src = a + offset;
  float* dst = out + offset;

  for (int e = tid; e < pb * pb; e += kThreads) {
    const int i = e / pb;
    const int k = e - i * pb;
    if (k <= i) s[i * ld + k] = src[e];
  }
  __syncthreads();

  // 1. Cholesky, lower, in place.
  for (int j = 0; j < pb; ++j) {
    const float d = sqrtf(s[j * ld + j]);
    const float inv_d = 1.0f / d;
    for (int i = j + 1 + tid; i < pb; i += kThreads) {
      const float v = s[i * ld + j] * inv_d;
      s[i * ld + j] = v;
      col[i] = v;
    }
    if (tid == 0) diag[j] = d;
    __syncthreads();
    for (int i = j + 1 + warp; i < pb; i += n_warps) {
      const float li = col[i];
      for (int k = j + 1 + lane; k <= i; k += 32) {
        s[i * ld + k] -= li * col[k];
      }
    }
    __syncthreads();
  }

  // 2. L^-1 in place, last column first.
  for (int j = pb - 1; j >= 0; --j) {
    for (int i = j + 1 + tid; i < pb; i += kThreads) col[i] = s[i * ld + j];
    if (tid == 0) s[j * ld + j] = 1.0f / diag[j];
    __syncthreads();
    const float neg_inv_d = -1.0f / diag[j];
    for (int i = j + 1 + warp; i < pb; i += n_warps) {
      const float* row = s + i * ld;
      float acc = 0.0f;
      for (int k = j + 1 + lane; k <= i; k += 32) acc = fmaf(row[k], col[k], acc);
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) s[i * ld + j] = acc * neg_inv_d;
    }
    __syncthreads();
  }

  // 3. Lower triangle out, zeros above.
  for (int e = tid; e < pb * pb; e += kThreads) {
    const int i = e / pb;
    const int k = e - i * pb;
    dst[e] = (k <= i) ? s[i * ld + k] : 0.0f;
  }
}

}  // namespace

// a, out: [batch, pb, pb] float32, contiguous, on the device; stream: the
// caller's cudaStream_t.  Returns the cudaError_t of the launch (0 = ok).
extern "C" int chol_inv_panel_launch(const void* a, void* out, int batch,
                                     int pb, void* stream) {
  if (batch <= 0 || pb <= 0 || pb > kMaxPanel) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ld = pb | 1;  // odd row stride: column walks are bank-conflict free
  const size_t smem = (static_cast<size_t>(pb) * ld + 2 * pb) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      chol_inv_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_inv_panel_kernel<<<batch, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(out), pb, ld);
  return static_cast<int>(cudaGetLastError());
}
