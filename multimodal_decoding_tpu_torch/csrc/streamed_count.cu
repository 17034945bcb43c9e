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
// memory: each block reduces its tiles to one integer.
//
// Operands are read through strides, so the fold patches are never copied:
//   streamed_pairwise_acc:      A = preds [B, nv, D];  Bm[b, k, j] = y_unit[j, k]
//                               (latents with unit rows, stored [D, nv] by the
//                               wrapper, batch stride 0);
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
// so operations bind all three, by a factor of ~25 over bytes.  The work stays
// in float32 FMAs on the CUDA cores (no TF32: the counts decide the alpha
// selection, which is gated on strict float32), so the kernel is as fast as
// its FMA issue rate: everything that is not an FFMA in the consumers' loop,
// and every cycle they wait for data or for each other, is lost.  On an H100
// the kernel runs at about two thirds of that rate, and a tuning build with
// the copies switched off ran no faster: the consumers' loop is 93.5% FFMA
// in the SASS, and register-bank conflicts (ptxas allocates the registers)
// with two warps per scheduler leave the rest of the issue slots empty.
//
// Design:
//   * Work item: one block per (row tile of 128 rows, vertex), grid
//     (ceil(nv/128), B), one block per SM (148 KB of shared memory).  The
//     block walks every 128-wide column tile of its vertex, the diagonal tile
//     first, then the others in ascending order, so the blocks of one vertex
//     read the same column tile at about the same time (it is shared in L2).
//     At nv = 1639 that is 13 x 128 = 1664 equal blocks, 12.6 waves on 132
//     SMs: the last wave is 60% full, a 3% tail.  (Two blocks per SM would
//     make it 6.3 waves, a 10% tail, and halve each thread's registers.)
//   * The diagonal comes from the block's own tile, as on the TPU
//     (pallas_metrics.py:17-23,54-66: a diagonal rounded differently from the
//     entries it is compared with flipped near-ties and dropped alpha
//     agreement to 29% there).  After the diagonal tile the consumer threads
//     put its 128 (i, i) entries, their own accumulators, into shared memory,
//     and each keeps the 8 of its rows in registers for the remaining tiles.
//     The diagonal and the entries compared with it are the same arithmetic
//     by construction; no second pass and no [B, nv] workspace.
//   * Pipeline: a ring of 4 stages in dynamic shared memory, each 32 deep in k
//     (A and Bm tiles of 128 x 32), fed by one producer warpgroup with
//     cp.async and completed on mbarriers (cp.async.mbarrier.arrive.noinc on
//     a "full" barrier; the 8 consumer warps release a stage on its "empty"
//     barrier).  One producer warp per scheduler: a single producer warp
//     issuing every copy left the consumers waiting (the kernel ran at half
//     speed).
//     The producer runs up to 3 stages ahead, across column tiles too, so the
//     next tile's first stages arrive while the consumers count this one.
//     The consumers never meet at a block-wide barrier inside a tile: one
//     mbarrier wait per 32 k (24 per tile at K = 750) instead of a
//     __syncthreads per 8 k, and no load, address or predicate instruction in
//     their loop beyond the shared-memory fragment loads.
//   * Copy width per operand and per block, from the strides and the base
//     address the wrapper passes: 16-byte cp.async where the operand's
//     contiguous axis has unit stride and the other strides and the vertex's
//     base are 16-byte aligned, else 8 bytes, else 4 (any strides).  The fold
//     patches Xv_b (vertex stride K x 4 = 3000 bytes) take 16 bytes on even
//     vertices and 8 on odd ones; preds, the unit latents and the padded Z
//     and U (the port allocates them with rows of a multiple of 4 floats)
//     take 16.  Ragged edges (rows, columns, k past the end) are zero-filled
//     by cp.async's source size.  TMA is not used: Xv_b's vertex stride and
//     an unpadded Z's row stride are not multiples of 16 bytes, which a
//     tensor map requires, and cp.async needs no driver entry point.  With
//     the consumers' FMAs switched off (a tuning build) the copies alone
//     took well under half the kernel's time.
//   * Shared-memory layout follows the source: a k-contiguous operand is
//     stored [o][k] (rows of 32 + 4 floats) and read as float4 along k, an
//     o-contiguous one [k][o] (rows of 128 + 4) and read as float4 along o;
//     either way a thread loads 2 float4 per k for its 8 x 8 micro-tile
//     (64 FFMA per 4 LDS.128), without bank conflicts.
//   * Registers: at 384 threads ptxas budgets 168 a thread.  setmaxnreg
//     (sm_90a) drops the producers to 56 and lifts the consumers to 224, so
//     the 8 x 8 accumulators and a k-group of fragments (64 + 64 floats) fit
//     without spills; without it the same code ran slower.
//   * Arithmetic: every entry is one float32 accumulator that starts at 0 and
//     takes __fmaf_rn(a_k, b_k, acc) for k ascending (the zero-filled k past
//     the end adds +0); built without --use_fast_math.
//   * Counting epilogue: each thread counts its entries with sim < diag under
//     the i < nv, j < nv mask, over all column tiles; the block sums the
//     counts (warp shuffles, then shared memory) and does one atomicAdd into
//     counts[b].  Integer sums do not depend on order: deterministic.
//   * streamed_acc_from_inv keeps Z = inv U on chip on the TPU.  Here Z
//     (4.9 MB per vertex, 630 MB per call) does not fit in a block's 227 KB
//     of shared memory, so the same core writes it (store epilogue, blocks
//     per row tile of Z walking its column tiles) and the count kernel reads
//     it back: 630 MB each way (~0.4 ms at 3.35 TB/s).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libstreamed_count.so streamed_count.cu

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kTile = 128;                      // output rows and columns of a tile
constexpr int kStageK = 32;                     // k per pipeline stage
constexpr int kStages = 4;                      // ring depth
constexpr int kMicro = 8;                       // a consumer thread's 8 x 8 entries
constexpr int kSide = kTile / kMicro;           // 16 x 16 consumer threads
constexpr int kConsumers = kSide * kSide;
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kProducers = 128;                 // one producer warpgroup
constexpr int kThreads = kConsumers + kProducers;
// setmaxnreg moves registers from the producers to the consumers: at 384
// threads ptxas budgets 168 each; the producers give back 112 x 128, which
// lifts the consumers from 168 to 224.
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
static_assert(kProducers * kProducerRegs + kConsumers * kConsumerRegs <= 65536, "registers");
constexpr int kPitchO = kStageK + 4;               // [o][k] row, k-contiguous source
constexpr int kPitchK = kTile + 4;                 // [k][o] row, o-contiguous source
constexpr int kOperandFloats = kTile * kPitchO;    // >= kStageK * kPitchK
constexpr int kStageFloats = 2 * kOperandFloats;   // A, then Bm
constexpr int kRingBytes = kStages * kStageFloats * 4;
constexpr int kSmemBytes = kRingBytes + 2 * kStages * 8 + kTile * 4 + kConsumerWarps * 4;
static_assert(kStageK * kPitchK <= kOperandFloats, "stage too small for a [k][o] tile");

// Element (b, o, k) of an operand lives at p[b * sb + o * so + k * sk]: o is
// the output row for A and the output column for Bm.
struct Operand {
  const float* p;
  long long sb, so, sk;
};

// ---------------------------------------------------------------------------
// PTX helpers: cp.async and mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// W bytes from src to dst; bytes past src_bytes are written as 0.
template <int W>
__device__ __forceinline__ void cp_async(float* dst, const float* src, int src_bytes) {
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(W), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrives on bar once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of bar with the given parity has completed.  A wait
// takes microseconds; one that outlasts 2^24 tries is a fault, and the
// kernel traps (the launch reports an error) instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (int tries = 0; !mbar_try_wait(bar, parity); ++tries)
    if (tries == (1 << 24)) __trap();
}

// Barrier 1 among the consumer warps only (barrier 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// ---------------------------------------------------------------------------
// Producer: one stage of one operand into shared memory
// ---------------------------------------------------------------------------

// Copy width in bytes for this vertex's slice of an operand: 16 or 8 where the
// contiguous axis has unit stride and the base and the other stride are that
// aligned, else 4.  OMajor: k-contiguous (sk == 1); else o-contiguous.
template <bool OMajor>
__device__ __forceinline__ int copy_width(const Operand& op, int b) {
  const long long unit = OMajor ? op.sk : op.so;
  const long long line = OMajor ? op.so : op.sk;
  if (unit != 1) return 4;
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(op.p + b * op.sb) | static_cast<uintptr_t>(line * 4);
  return bits % 16 == 0 ? 16 : (bits % 8 == 0 ? 8 : 4);
}

// The [128 x 32] tile (o0.., k0..) of vertex base `p` into stage buffer `dst`,
// W bytes per cp.async, the producer threads (ptid 0..127) on neighbouring
// addresses along the operand's contiguous axis.  Each thread's copies are
// one line apart: its pointer, masks and destination are set up once, and a
// copy costs an add, a select and the cp.async.
template <bool OMajor, int W>
__device__ __forceinline__ void copy_tile(float* dst, const float* p, long long so,
                                          long long sk, int o0, int n_o, int k0, int kd,
                                          int ptid) {
  constexpr int v = W / 4;                                  // elements per copy
  constexpr int per_line = (OMajor ? kStageK : kTile) / v;  // copies along one line
  constexpr int lines_per_pass = kProducers / per_line;
  constexpr int passes = (OMajor ? kTile : kStageK) / lines_per_pass;
  constexpr int pitch = OMajor ? kPitchO : kPitchK;
  static_assert(kProducers % per_line == 0, "a pass covers whole lines");
  // OMajor: a line is a row o and pos runs along k; otherwise a line is a k
  // and pos runs along o.
  const int line0 = ptid / per_line;
  const int pos = (ptid % per_line) * v;
  const long long line_step = static_cast<long long>(lines_per_pass) * (OMajor ? so : sk);
  const float* src = p + (OMajor ? (o0 + line0) * so + (k0 + pos) * sk
                                 : (k0 + line0) * sk + (o0 + pos) * so);
  const int pos_left = OMajor ? kd - (k0 + pos) : n_o - (o0 + pos);
  const int lines_left = OMajor ? n_o - (o0 + line0) : kd - (k0 + line0);
  const int pos_valid = pos_left <= 0 ? 0 : (pos_left >= v ? v : pos_left);
  float* d = dst + line0 * pitch + pos;
#pragma unroll
  for (int q = 0; q < passes; ++q) {
    const int valid = q * lines_per_pass < lines_left ? pos_valid : 0;
    cp_async<W>(d + q * lines_per_pass * pitch, valid ? src : p, valid * 4);
    src += line_step;
  }
}

template <bool OMajor>
__device__ __forceinline__ void copy_operand(float* dst, const float* p, long long so,
                                             long long sk, int width, int o0, int n_o,
                                             int k0, int kd, int ptid) {
  if (width == 16) {
    copy_tile<OMajor, 16>(dst, p, so, sk, o0, n_o, k0, kd, ptid);
  } else if (width == 8) {
    copy_tile<OMajor, 8>(dst, p, so, sk, o0, n_o, k0, kd, ptid);
  } else {
    copy_tile<OMajor, 4>(dst, p, so, sk, o0, n_o, k0, kd, ptid);
  }
}

// ---------------------------------------------------------------------------
// Consumers: fragments and FMAs
// ---------------------------------------------------------------------------

// Tile-local row (A) or column (Bm) of micro index i (0..7) of thread
// coordinate t (0..15).  [o][k] stages interleave the 16 threads (no bank
// conflicts for float4 loads along k); [k][o] stages give each thread two
// runs of 4 (float4 loads along o).
template <bool OMajor>
__device__ __forceinline__ int micro(int t, int i) {
  return OMajor ? t + kSide * i : (i / 4) * (4 * kSide) + 4 * t + i % 4;
}

// f[i][kk] = operand(micro(t, i), 4 g + kk) from stage buffer s.
template <bool OMajor>
__device__ __forceinline__ void load_frags(const float* s, int g, int t,
                                           float (&f)[kMicro][4]) {
  if constexpr (OMajor) {
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(s + micro<true>(t, i) * kPitchO + 4 * g);
      f[i][0] = x.x;
      f[i][1] = x.y;
      f[i][2] = x.z;
      f[i][3] = x.w;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < kMicro / 4; ++h) {
        const float4 x = *reinterpret_cast<const float4*>(s + (4 * g + kk) * kPitchK +
                                                          micro<false>(t, 4 * h));
        f[4 * h][kk] = x.x;
        f[4 * h + 1][kk] = x.y;
        f[4 * h + 2][kk] = x.z;
        f[4 * h + 3][kk] = x.w;
      }
  }
}

// acc += the first `groups` groups of 4 k of a stage, k ascending for every
// entry.  The columns are walked back and forth on odd rows: ptxas then
// allocates the accumulators with fewer register-bank conflicts (this order
// ran faster than the plain one on the card).  Loading the next group's
// fragments ahead of this group's FMAs did not help: the other warp of the
// scheduler covers the shared-memory latency.
template <bool AO, bool BO>
__device__ __forceinline__ void fma_stage(const float* sa, const float* sb, int groups, int tx,
                                          int ty, float (&acc)[kMicro][kMicro]) {
#pragma unroll
  for (int g = 0; g < groups; ++g) {
    float a[kMicro][4], bv[kMicro][4];
    load_frags<AO>(sa, g, ty, a);
    load_frags<BO>(sb, g, tx, bv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int c = 0; c < kMicro; ++c) {
          const int cc = (r & 1) ? kMicro - 1 - c : c;
          acc[r][cc] = __fmaf_rn(a[r][kk], bv[cc][kk], acc[r][cc]);
        }
  }
}

// Column tile walked at step t by the block of row tile `row`: with the
// diagonal first (count), the diagonal tile, then the others ascending.
template <bool kCount>
__device__ __forceinline__ int column_tile(int t, int row) {
  if (!kCount) return t;
  return t == 0 ? row : (t - 1 < row ? t - 1 : t);
}

// kCount: counts[b] += #{i, j < m = n : sim[b, i, j] < sim[b, i, i]}.
// Otherwise c[b, i, j] = sim[b, i, j] for i < m, j < n (row stride ldc,
// batch stride m * ldc).
template <bool AO, bool BO, bool kCount>
__global__ void __launch_bounds__(kThreads, 1)
tile_kernel(Operand a, Operand bm, int m, int n, int kd, int* __restrict__ counts,
            float* __restrict__ c, long long ldc) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<char*>(smem) + kRingBytes);
  uint64_t* empty = full + kStages;
  float* diag_s = reinterpret_cast<float*>(empty + kStages);
  int* warp_counts = reinterpret_cast<int*>(diag_s + kTile);

  const int b = blockIdx.y;
  const int row_tile = blockIdx.x;
  const int i0 = row_tile * kTile;
  const int col_tiles = (n + kTile - 1) / kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, kProducers);        // the producer threads' copy arrivals
      mbar_init(empty + s, kConsumerWarps);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---- producer warpgroup: keeps up to kStages stages in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int ptid = threadIdx.x - kConsumers;
    const float* pa = a.p + b * a.sb;
    const float* pb = bm.p + b * bm.sb;
    const int wa = copy_width<AO>(a, b);
    const int wb = copy_width<BO>(bm, b);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < col_tiles; ++t) {
      const int j0 = column_tile<kCount>(t, row_tile) * kTile;
      for (int k0 = 0; k0 < kd; k0 += kStageK) {
        mbar_wait(empty + stage, phase ^ 1);
        float* sa = ring + stage * kStageFloats;
        copy_operand<AO>(sa, pa, a.so, a.sk, wa, i0, m, k0, kd, ptid);
        copy_operand<BO>(sa + kOperandFloats, pb, bm.so, bm.sk, wb, j0, n, k0, kd, ptid);
        mbar_arrive_on_copies(full + stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumer warps ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  int stage = 0;
  uint32_t phase = 0;
  float d[kMicro];  // count: the diagonal of this thread's rows (-inf past nv)
  int count = 0;
  for (int t = 0; t < col_tiles; ++t) {
    const int j0 = column_tile<kCount>(t, row_tile) * kTile;
    float acc[kMicro][kMicro];
#pragma unroll
    for (int r = 0; r < kMicro; ++r)
#pragma unroll
      for (int q = 0; q < kMicro; ++q) acc[r][q] = 0.0f;

    for (int k0 = 0; k0 < kd; k0 += kStageK) {
      mbar_wait(full + stage, phase);
      const float* sa = ring + stage * kStageFloats;
      const float* sb = sa + kOperandFloats;
      const int kv = kd - k0;
      // the last stage stops after the last group that holds valid k
      fma_stage<AO, BO>(sa, sb, kv >= kStageK ? kStageK / 4 : (kv + 3) / 4, tx, ty, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    if constexpr (kCount) {
      if (t == 0) {  // the diagonal tile: its (i, i) entries become the diagonal
#pragma unroll
        for (int r = 0; r < kMicro; ++r)
#pragma unroll
          for (int q = 0; q < kMicro; ++q)
            if (micro<AO>(ty, r) == micro<BO>(tx, q))
              diag_s[micro<AO>(ty, r)] = acc[r][q];
        consumers_sync();
#pragma unroll
        for (int r = 0; r < kMicro; ++r) {
          const int i = micro<AO>(ty, r);
          d[r] = i0 + i < m ? diag_s[i] : -INFINITY;
        }
      }
#pragma unroll
      for (int q = 0; q < kMicro; ++q) {
        if (j0 + micro<BO>(tx, q) >= n) continue;
#pragma unroll
        for (int r = 0; r < kMicro; ++r) count += acc[r][q] < d[r] ? 1 : 0;
      }
    } else {
      float* out = c + static_cast<long long>(b) * m * ldc;
#pragma unroll
      for (int r = 0; r < kMicro; ++r) {
        const int i = i0 + micro<AO>(ty, r);
        if (i >= m) continue;
#pragma unroll
        for (int q = 0; q < kMicro; ++q) {
          const int j = j0 + micro<BO>(tx, q);
          if (j < n) out[i * ldc + j] = acc[r][q];
        }
      }
    }
  }

  if constexpr (kCount) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(0xffffffffu, count, off);
    if (lane == 0) warp_counts[warp] = count;
    consumers_sync();
    if (threadIdx.x == 0) {
      int total = 0;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) total += warp_counts[w];
      if (total != 0) atomicAdd(counts + b, total);
    }
  }
}

template <bool AO, bool BO, bool kCount>
cudaError_t launch_tiles(const Operand& a, const Operand& bm, int batch, int m, int n,
                         int kd, int* counts, float* c, long long ldc, cudaStream_t s) {
  auto kernel = tile_kernel<AO, BO, kCount>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kTile - 1) / kTile, batch);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(a, bm, m, n, kd, counts, c, ldc);
  return cudaGetLastError();
}

// The instantiation for the operands' layouts: [o][k] stages for an operand
// whose k axis has unit stride, [k][o] otherwise.
template <bool kCount>
cudaError_t dispatch(const Operand& a, const Operand& bm, int batch, int m, int n, int kd,
                     int* counts, float* c, long long ldc, cudaStream_t s) {
  const bool ao = a.sk == 1, bo = bm.sk == 1;
  if (ao && bo) return launch_tiles<true, true, kCount>(a, bm, batch, m, n, kd, counts, c, ldc, s);
  if (ao) return launch_tiles<true, false, kCount>(a, bm, batch, m, n, kd, counts, c, ldc, s);
  if (bo) return launch_tiles<false, true, kCount>(a, bm, batch, m, n, kd, counts, c, ldc, s);
  return launch_tiles<false, false, kCount>(a, bm, batch, m, n, kd, counts, c, ldc, s);
}

bool valid_grid(int batch, int rows, int cols, int kd) {
  return batch > 0 && batch <= 65535 && rows > 0 && cols > 0 && kd > 0;
}

}  // namespace

// counts[b] += #{(i, j) : i, j < nv, sim[b, i, j] < sim[b, i, i]} with
// sim[b] = A[b] Bm[b]; A[b, i, k] at a + b a_sb + i a_si + k a_sk and
// Bm[b, k, j] at bm + b b_sb + k b_sk + j b_sj (float32 elements, strides in
// elements).  counts: [batch] int32, zeroed by the caller.  stream: the
// caller's cudaStream_t.  Returns the cudaError_t of the launch (0 = ok).
extern "C" int streamed_count_launch(const void* a, long long a_sb, long long a_si,
                                     long long a_sk, const void* bm, long long b_sb,
                                     long long b_sk, long long b_sj, int batch, int nv,
                                     int kd, void* counts, void* stream) {
  if (!valid_grid(batch, nv, nv, kd)) return static_cast<int>(cudaErrorInvalidValue);
  const Operand op_a{static_cast<const float*>(a), a_sb, a_si, a_sk};
  const Operand op_b{static_cast<const float*>(bm), b_sb, b_sj, b_sk};
  return static_cast<int>(dispatch<true>(op_a, op_b, batch, nv, nv, kd,
                                         static_cast<int*>(counts), nullptr, 0,
                                         static_cast<cudaStream_t>(stream)));
}

// c[b] = A[b] Bm[b] for A [batch, m, kd] and Bm [batch, kd, n] (strides in
// elements, as above); c: [batch, m, ldc] float32, ldc >= n, of which the
// first n columns are written.  Returns the cudaError_t of the launch (0 = ok).
extern "C" int gemm_store_launch(const void* a, long long a_sb, long long a_si,
                                 long long a_sk, const void* bm, long long b_sb,
                                 long long b_sk, long long b_sj, int batch, int m, int n,
                                 int kd, void* c, long long ldc, void* stream) {
  if (!valid_grid(batch, m, n, kd) || ldc < n) return static_cast<int>(cudaErrorInvalidValue);
  const Operand op_a{static_cast<const float*>(a), a_sb, a_si, a_sk};
  const Operand op_b{static_cast<const float*>(bm), b_sb, b_sj, b_sk};
  return static_cast<int>(dispatch<false>(op_a, op_b, batch, m, n, kd, nullptr,
                                          static_cast<float*>(c), ldc,
                                          static_cast<cudaStream_t>(stream)));
}
