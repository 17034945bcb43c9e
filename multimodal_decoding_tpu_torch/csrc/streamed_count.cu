// Streamed pairwise-accuracy counts for Hopper (sm_90a).
//
// Replaces the three TPU kernels of multimodal_decoding_tpu/ops/pallas_metrics.py:
//   streamed_pairwise_acc      (_count_kernel)        -> streamed_count_launch | tc_count_launch
//   streamed_acc_from_factors  (_factor_count_kernel) -> streamed_count_launch | tc_count_launch
//   streamed_acc_from_inv      (_inv_count_kernel)    -> gemm_store_launch | tc_store_launch
//                                                        (Z = inv U), then the count
// For each vertex b of a batch and each row i < nv they count
//   #{ j < nv : sim[b, i, j] < sim[b, i, i] },   sim[b] = A[b] Bm[b]  ([nv, kd] x [kd, nv]),
// and add the counts of all rows into counts[b] (int32; the caller zeroes it
// and divides by nv^2 - nv).  The [B, nv, nv] similarity never reaches device
// memory: each block reduces its tiles to integers.
//
// Precision, as the TPU kernels take it (pallas_metrics.py:38-47):
//   highest  float32 FMAs on the CUDA cores: the SIMT core (tile_kernel,
//            streamed_count_launch / gemm_store_launch);
//   default  one bf16 pass: operands rounded to bf16 (nearest even), exact
//            products, float32 sums: the tensor-core core (tc_kernel);
//   high     bf16 x 3: x = hi + lo, hi = bf16(x), lo = bf16(x - hi);
//            hi.hi, hi.lo and lo.hi into one accumulator (hi.hi and hi.lo
//            where the first operand is bf16: it has no low part).
// streamed_acc_from_inv at default rounds inv and U for Z, and Z once more
// for the count, as the TPU's two dots do.
//
// Bound on an H100 SXM at the main path's shapes (B = 128, nv = 1639,
// D = 1024, K = 750; 67 TFLOP/s float32 outside the tensor cores, 989
// TFLOP/s bf16 dense, 3.35 TB/s):
//   streamed_pairwise_acc      2 B nv^2 D  = 7.04e11 FLOP: 10.5 ms float32; 0.71 ms bf16
//   streamed_acc_from_factors  2 B nv^2 K  = 5.16e11 FLOP:  7.7 ms;         0.52 ms
//   streamed_acc_from_inv      + 2 B K^2 nv = 7.52e11 FLOP: 11.2 ms;         0.76 ms
// (high: x3, or x2 with a bf16 first operand; B4's Z GEMM keeps x3), against
// 0.26-0.46 ms for reading the float32 inputs once: operations bind every
// variant.
//
// The SIMT core (highest):
//   * Work item: one block per (row tile of 128 rows, vertex), grid
//     (ceil(nv/128), B), one block per SM (148 KB of shared memory).  The
//     block walks every 128-wide column tile of its vertex, the diagonal tile
//     first, then the others in ascending order, so the blocks of one vertex
//     read the same column tile at about the same time (it is shared in L2).
//   * The diagonal comes from the block's own tile, as on the TPU
//     (pallas_metrics.py:17-23,54-66: a diagonal rounded differently from the
//     entries it is compared with flipped near-ties and dropped alpha
//     agreement to 29% there).  After the diagonal tile the consumer threads
//     put its 128 (i, i) entries, their own accumulators, into shared memory,
//     and each keeps the 8 of its rows in registers for the remaining tiles.
//   * Pipeline: a ring of 4 stages, each 32 deep in k (A and Bm tiles of
//     128 x 32 float32), fed by one producer warpgroup with cp.async 16, 8 or
//     4 bytes wide by each operand's strides and alignment, completed on
//     mbarriers.  The 8 consumer warps (16 x 16 threads, an 8 x 8 micro-tile
//     each) never meet at a block-wide barrier inside a tile.
//   * Registers: setmaxnreg (sm_90a) drops the producers to 56 and lifts the
//     consumers to 224, so the 8 x 8 accumulators and a k-group of fragments
//     fit without spills.
//   * Arithmetic: every entry is one float32 accumulator that starts at 0 and
//     takes __fmaf_rn(a_k, b_k, acc) for k ascending; built without
//     --use_fast_math.  On an H100 the core runs at about two thirds of the
//     FFMA issue rate: its loop is 93.5% FFMA in the SASS, and register-bank
//     conflicts with two warps per scheduler leave the rest of the slots
//     empty.  A bf16 first operand stays bf16 in its stage and is widened
//     in the consumers.
//   * Counting epilogue: each thread counts its entries with sim < diag under
//     the i < nv, j < nv mask; the block sums the counts (warp shuffles, then
//     shared memory) and does one atomicAdd into counts[b].  Integer sums do
//     not depend on order: deterministic.
//   * streamed_acc_from_inv keeps Z = inv U on chip on the TPU.  Here Z
//     (4.9 MB per vertex, 630 MB per call) does not fit in a block's 227 KB
//     of shared memory, so the same core writes it (store epilogue) and the
//     count reads it back.
//
// The tensor-core core (default, high): tc_kernel.  A bf16 product reads
// 2 bytes an operand per 2 FLOP, so a tile has to be fed ~295 FLOP a byte
// from device memory and far more from shared memory than a float32 ring
// read through the register file can give: the earlier mma.sync core
// rounded every fragment in registers, once per fragment per column tile,
// and ran at 3.3-7.2x the bf16 bound.  This core:
//   * bf16 stages, rounded once per element.  Operands reach shared memory
//     already in bf16 planes (hi; and lo = bf16(x - hi) at high), in the
//     swizzled layouts wgmma's shared-memory descriptors read: A [128
//     rows][kK] (K-major; the 128-byte swizzle at kK = 64, the 64-byte one at
//     kK = 32), Bm [kK][256 columns] as 4 blocks of [kK][64 columns]
//     (MN-major, 128-byte swizzle).  kK, the k of a stage, is 64 at default
//     and 32 at high (below).  The wrapper
//     rounds a float32 operand once a call (split_bf16_kernel: the latents
//     of streamed_pairwise_acc, which every vertex shares, inv and U for Z, a
//     float32 first operand, a float32 Z handed to streamed_acc_from_factors);
//     the Z GEMM (tc_store_launch) writes Z = inv U straight into bf16 planes
//     from its accumulators (half the bytes of the float32 round trip):
//     inside streamed_acc_from_inv's call, and ahead of
//     streamed_acc_from_factors on the selection path
//     (hopper_metrics.factor_planes), which then reads Z's planes as they are
//     and rounds nothing in its call.  At
//     default that is what the count's rounding did: round-to-nearest-even,
//     once.  Planes have rows padded to 64 elements (128 bytes), so every
//     128-byte box row is one aligned L2 line (rows padded to 8 elements
//     straddled two lines and ran the counts 10-20% slower, PERF.md).
//   * wgmma.mma_async m64n256k16, bf16 x bf16, float32 accumulators: two
//     consumer warpgroups, each 64 rows of the 128 x 256 tile (128 floats a
//     thread), 4 k16 steps a stage, one wgmma per step and product (1 at
//     default, 2 or 3 at high).  Bm is MN-major (Z and the latents are [kd, nv]
//     with nv contiguous): the transpose bit of 16-bit wgmma.  The last
//     column tile computes only its columns, rounded up to a 64-column block
//     of Bm's stage (m64nWk16, W = 64, 128, 192 or 256, set at launch from
//     n): nv = 1639 is 6 tiles of 256 and one of 128, 1664 columns instead
//     of 1792.  Its box is still 4 blocks wide; the blocks past n are the
//     tensor map's zero fill, which reads nothing.
//   * TMA for every operand: a tensor map needs a 16-byte-aligned base and
//     strides that are multiples of 16 bytes.  Every plane the wrapper writes
//     has them, so do a bf16 preds [B, nv, 1024] and the engine's bf16 fold
//     patches (rows padded to 64 elements, hopper_metrics.padded_copy); a
//     bf16 first operand without them (the unpadded transposed view of [nv,
//     B, K] patches: a vertex stride of K x 2 = 1500 bytes) is copied so by
//     the wrapper (the rule on strides and alignment:
//     hopper_metrics.tma_eligible), and the entry point refuses an operand
//     a tensor map cannot describe.  One producer thread issues a stage's
//     loads onto the stage's "full" mbarrier with its byte count: A's [128 x
//     kK] box of a 4-d map (k, row, vertex, plane), Bm's 4 column blocks in
//     one box of a 5-d map (64 columns, k, column block, vertex, plane; one
//     load instead of four ran B3's count ~10% faster).  Ragged edges (rows,
//     columns, k past the end) are zero-filled by the tensor map's
//     out-of-bounds fill.
//   * A persistent schedule: one block per SM walks work items item =
//     blockIdx.x, + gridDim.x, ...  A count item is (vertex, row tile) and
//     walks the vertex's column tiles, diagonal first; items are numbered
//     vertex-major, so a vertex's row tiles run on neighbouring blocks at the
//     same time and share its Bm tiles in L2.  A store item is (vertex, row
//     tile, column tile).  The producer runs ahead across items, so the next
//     item's loads land while the consumers count this one.
//   * Ring: 4 stages of 48 KB at default (kK = 64), 5 of 40 KB or 4 of 48 KB
//     at high (kK = 32: with 64-deep stages of 80-96 KB only 2 fit in 227 KB,
//     and the loads and wgmmas of high did not overlap; 32 ran its counts
//     ~20% faster).
//     A consumer warpgroup issues a stage's wgmmas, commits them, waits for
//     the previous stage's group and releases that stage on its "empty"
//     mbarrier (wgmma.wait_group 1), so the tensor cores never wait for a
//     release.  setmaxnreg: producers 56, consumers 224 registers, 0 spills.
//   * The same counting rule: the diagonal tile of a 128-row tile lies in
//     one 256-wide column tile; its (i, i) entries, which lie in wgmma's
//     accumulator layout (thread 4 g + t of warp w holds rows 16 w + g and
//     + 8, columns 8 j + 2 t and + 1), go through shared memory as before.
//     Masks i < nv, j < nv; one atomicAdd per item into counts[b].
//   * Every mbarrier wait traps after 2^24 tries: a pipeline fault fails the
//     launch instead of holding the card.
// What binds it on an H100 (tools/tc_ablation.py, PERF.md): the loads.  With
// the wgmmas switched off a count takes as long as with them; with the
// loads switched off streamed_acc_from_factors' count takes ~80-85% of the
// time; with the count's epilogue switched off (no diagonal, no
// comparisons) as long as with it, so the epilogue that follows each
// column tile's drain is not on the critical path.  A stage's A box (16 KB)
// costs as much time as its Bm box (32 KB).  A's rows 1.5 KB apart instead
// of 192 KB ran 2-8% faster; an evict-last L2 policy on A, 128-byte L2
// promotion and a 2-block cluster that multicast each Bm tile into both
// blocks (a third fewer bytes from L2) ran no faster.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libstreamed_count.so streamed_count.cu

#include <cuda.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

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
// a bf16 A stage is [o][k] bf16 with rows of 32 + 8 elements (80 bytes: rows
// 16-byte aligned, and the m16n8k16 fragment words of a warp on 32 banks)
constexpr int kPitchH = kStageK + 8;
static_assert(kTile * kPitchH * 2 <= kOperandFloats * 4, "a bf16 A stage fits A's slot");
// precision variants (the `precision` argument of the entry points)
constexpr int kHighest = 0;

// Element (b, o, k) of an operand lives at p[b * sb + o * so + k * sk]: o is
// the output row for A and the output column for Bm.  T: float, or uint16_t
// holding bf16 bits (a bf16 A).
template <typename T>
struct Operand {
  const T* p;
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
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
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

// Copy width in bytes for this vertex's slice of an operand: 16, 8 or 4 where
// the contiguous axis has unit stride and the base and the other stride are
// that aligned, else one element.  OMajor: k-contiguous (sk == 1); else
// o-contiguous.
template <bool OMajor, typename T>
__device__ __forceinline__ int copy_width(const Operand<T>& op, int b) {
  constexpr int elem = sizeof(T);
  const long long unit = OMajor ? op.sk : op.so;
  const long long line = OMajor ? op.so : op.sk;
  if (unit != 1) return elem;
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(op.p + b * op.sb) | static_cast<uintptr_t>(line * elem);
  return bits % 16 == 0 ? 16 : (bits % 8 == 0 ? 8 : (bits % 4 == 0 ? 4 : elem));
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

// The [128 x 32] tile (o0.., k0..) of a k-contiguous bf16 operand (vertex base
// p, row stride so) into the bf16 stage buffer `dst` ([o][k], rows of
// kPitchH), W bytes (4, 8 or 16) per cp.async; ragged rows and k are
// zero-filled by the copies' source size.
template <int W>
__device__ __forceinline__ void copy_bf16_tile(uint16_t* dst, const uint16_t* p, long long so,
                                               int o0, int n_o, int k0, int kd, int ptid) {
  constexpr int v = W / 2;                              // elements per copy
  constexpr int per_line = kStageK / v;                 // copies along one row's k
  constexpr int lines_per_pass = kProducers / per_line;
  constexpr int passes = kTile / lines_per_pass;
  static_assert(kProducers % per_line == 0, "a pass covers whole lines");
  const int line0 = ptid / per_line;
  const int pos = (ptid % per_line) * v;
  const long long line_step = static_cast<long long>(lines_per_pass) * so;
  const uint16_t* src = p + (o0 + line0) * so + (k0 + pos);
  const int pos_left = kd - (k0 + pos);
  const int lines_left = n_o - (o0 + line0);
  const int pos_valid = pos_left <= 0 ? 0 : (pos_left >= v ? v : pos_left);
  uint16_t* d = dst + line0 * kPitchH + pos;
#pragma unroll
  for (int q = 0; q < passes; ++q) {
    const int valid = q * lines_per_pass < lines_left ? pos_valid : 0;
    cp_async<W>(d + q * lines_per_pass * kPitchH, valid ? src : p, valid * 2);
    src += line_step;
  }
}

// The same tile for a row start that is only 2-byte aligned (cp.async copies
// 4, 8 or 16 bytes): plain 2-byte loads and stores, one k per thread.
__device__ __forceinline__ void load_bf16_tile(uint16_t* dst, const uint16_t* p, long long so,
                                               int o0, int n_o, int k0, int kd, int ptid) {
  constexpr int lines_per_pass = kProducers / kStageK;
  const int line0 = ptid / kStageK;
  const int pos = ptid % kStageK;
  const bool k_ok = k0 + pos < kd;
#pragma unroll 8
  for (int q = 0; q < kTile / lines_per_pass; ++q) {
    const int o = line0 + q * lines_per_pass;
    dst[o * kPitchH + pos] = k_ok && o0 + o < n_o ? p[(o0 + o) * so + k0 + pos] : uint16_t(0);
  }
}

__device__ __forceinline__ void copy_bf16_operand(uint16_t* dst, const uint16_t* p, long long so,
                                                  int width, int o0, int n_o, int k0, int kd,
                                                  int ptid) {
  if (width == 16) {
    copy_bf16_tile<16>(dst, p, so, o0, n_o, k0, kd, ptid);
  } else if (width == 8) {
    copy_bf16_tile<8>(dst, p, so, o0, n_o, k0, kd, ptid);
  } else if (width == 4) {
    copy_bf16_tile<4>(dst, p, so, o0, n_o, k0, kd, ptid);
  } else {
    load_bf16_tile(dst, p, so, o0, n_o, k0, kd, ptid);
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

// f[i][kk] = A(micro(t, i), 4 g + kk) from a bf16 [o][k] stage, widened.
__device__ __forceinline__ void load_frags_bf16(const uint16_t* s, int g, int t,
                                                float (&f)[kMicro][4]) {
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const uint2 x = *reinterpret_cast<const uint2*>(s + micro<true>(t, i) * kPitchH + 4 * g);
    f[i][0] = __uint_as_float(x.x << 16);  // the lower address is the lower half
    f[i][1] = __uint_as_float(x.x & 0xffff0000u);
    f[i][2] = __uint_as_float(x.y << 16);
    f[i][3] = __uint_as_float(x.y & 0xffff0000u);
  }
}

// acc += the first `groups` groups of 4 k of a stage, k ascending for every
// entry.  The columns are walked back and forth on odd rows: ptxas then
// allocates the accumulators with fewer register-bank conflicts (this order
// ran faster than the plain one on the card).  Loading the next group's
// fragments ahead of this group's FMAs did not help: the other warp of the
// scheduler covers the shared-memory latency.
template <bool AO, bool BO, bool ABf16>
__device__ __forceinline__ void fma_stage(const float* sa, const float* sb, int groups, int tx,
                                          int ty, float (&acc)[kMicro][kMicro]) {
#pragma unroll
  for (int g = 0; g < groups; ++g) {
    float a[kMicro][4], bv[kMicro][4];
    if constexpr (ABf16) {
      load_frags_bf16(reinterpret_cast<const uint16_t*>(sa), g, ty, a);
    } else {
      load_frags<AO>(sa, g, ty, a);
    }
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

// The 8 consumer warps of a tile_kernel block at precision kPrec: walk the
// column tiles of row tile i0 in the producer's order, taking each stage off
// the ring, and count (kCount) or store each tile.  Returns the thread's count.
// diag_s: the block's 128 diagonal entries in shared memory.
template <bool AO, bool BO, bool kCount, int kPrec, bool ABf16>
__device__ __forceinline__ int consume(const float* ring, uint64_t* full, uint64_t* empty,
                                       float* diag_s, int b, int row_tile, int m, int n,
                                       int kd, float* __restrict__ c, long long ldc) {
  const int i0 = row_tile * kTile;
  const int col_tiles = (n + kTile - 1) / kTile;
  const int lane = threadIdx.x % 32;
  int stage = 0;
  uint32_t phase = 0;
  int count = 0;
  if constexpr (kPrec == kHighest) {
    const int tx = threadIdx.x % kSide;
    const int ty = threadIdx.x / kSide;
    float d[kMicro];  // count: the diagonal of this thread's rows (-inf past nv)
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
        fma_stage<AO, BO, ABf16>(sa, sb, kv >= kStageK ? kStageK / 4 : (kv + 3) / 4, tx, ty,
                                 acc);
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
  }
  return count;
}

// kCount: counts[b] += #{i, j < m = n : sim[b, i, j] < sim[b, i, i]}.
// Otherwise c[b, i, j] = sim[b, i, j] for i < m, j < n (row stride ldc,
// batch stride m * ldc).  ABf16: A holds bf16 (k-contiguous).
template <bool AO, bool BO, bool kCount, int kPrec, bool ABf16>
__global__ void __launch_bounds__(kThreads, 1)
tile_kernel(Operand<typename std::conditional<ABf16, uint16_t, float>::type> a,
            Operand<float> bm, int m, int n, int kd, int* __restrict__ counts,
            float* __restrict__ c, long long ldc) {
  static_assert(AO || !ABf16, "a bf16 A is read k-contiguous");
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
      // the producer threads' copy arrivals, and with a bf16 A one more
      // arrival each after its stores
      mbar_init(full + s, kProducers * (ABf16 ? 2 : 1));
      mbar_init(empty + s, kConsumerWarps);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---- producer warpgroup: keeps up to kStages stages in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int ptid = threadIdx.x - kConsumers;
    const auto* pa = a.p + b * a.sb;
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
        if constexpr (ABf16) {
          copy_bf16_operand(reinterpret_cast<uint16_t*>(sa), pa, a.so, wa, i0, m, k0, kd, ptid);
          // release: a plain-load tile's stores are seen after the wait (its
          // copies, if any, complete on the arrival below)
          mbar_arrive(full + stage);
        } else {
          copy_operand<AO>(sa, pa, a.so, a.sk, wa, i0, m, k0, kd, ptid);
        }
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
  int count = consume<AO, BO, kCount, kPrec, ABf16>(ring, full, empty, diag_s, b, row_tile, m,
                                                     n, kd, c, ldc);

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

template <bool AO, bool BO, bool kCount, int kPrec, bool ABf16, typename TA>
cudaError_t launch_tiles(const Operand<TA>& a, const Operand<float>& bm, int batch, int m,
                         int n, int kd, int* counts, float* c, long long ldc, cudaStream_t s) {
  auto kernel = tile_kernel<AO, BO, kCount, kPrec, ABf16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kTile - 1) / kTile, batch);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(a, bm, m, n, kd, counts, c, ldc);
  return cudaGetLastError();
}

// The instantiation for the operands' layouts: [o][k] stages for an operand
// whose k axis has unit stride, [k][o] otherwise.  A bf16 A must be
// k-contiguous.
template <bool kCount, int kPrec, typename TA>
cudaError_t dispatch_layout(const Operand<TA>& a, const Operand<float>& bm, int batch, int m,
                            int n, int kd, int* counts, float* c, long long ldc,
                            cudaStream_t s) {
  constexpr bool bf16 = std::is_same<TA, uint16_t>::value;
  const bool ao = a.sk == 1, bo = bm.sk == 1;
  if constexpr (bf16) {
    if (!ao) return cudaErrorInvalidValue;
    if (bo) return launch_tiles<true, true, kCount, kPrec, true>(a, bm, batch, m, n, kd, counts, c, ldc, s);
    return launch_tiles<true, false, kCount, kPrec, true>(a, bm, batch, m, n, kd, counts, c, ldc, s);
  } else {
    if (ao && bo) return launch_tiles<true, true, kCount, kPrec, false>(a, bm, batch, m, n, kd, counts, c, ldc, s);
    if (ao) return launch_tiles<true, false, kCount, kPrec, false>(a, bm, batch, m, n, kd, counts, c, ldc, s);
    if (bo) return launch_tiles<false, true, kCount, kPrec, false>(a, bm, batch, m, n, kd, counts, c, ldc, s);
    return launch_tiles<false, false, kCount, kPrec, false>(a, bm, batch, m, n, kd, counts, c, ldc, s);
  }
}

bool valid_grid(int batch, int rows, int cols, int kd) {
  return batch > 0 && batch <= 65535 && rows > 0 && cols > 0 && kd > 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core core: wgmma on bf16 stages (default, high)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kM = 128;                        // rows of a tile: two warpgroups of 64
constexpr int kN = 256;                        // columns of a tile
constexpr int kMaxStages = 6;
constexpr int kConsumers = 256;                // two warpgroups
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kProducers = 128;                // one warpgroup
constexpr int kThreads = kConsumers + kProducers;
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
static_assert(kProducers * kProducerRegs + kConsumers * kConsumerRegs <= 65536, "registers");
constexpr int kSmemMax = 232448;               // a block's dynamic shared memory on sm_90
constexpr int kTail = 2 * kMaxStages * 8 + kM * 4 + kConsumerWarps * 4;  // barriers, diagonal, counts

// k per stage: 64 (A's rows of 128 bytes, the 128-byte swizzle) with one
// plane of Bm, 32 (rows of 64 bytes, the 64-byte swizzle) with two, so the
// high ring holds 4-5 stages instead of 2 (measured: 2 stages left the
// loads and the wgmmas of high unoverlapped).
template <int PB>
constexpr int stage_k() {
  return PB == 2 ? 32 : 64;
}

template <int PA, int PB>
struct Ring {
  static constexpr int kK = stage_k<PB>();
  static constexpr int kABytes = kM * kK * 2;    // an A plane of a stage
  static constexpr int kBBlock = kK * 64 * 2;    // [kK][64 columns] of Bm
  static constexpr int kBBytes = kN * kK * 2;    // a Bm plane of a stage
  static constexpr int kStageBytes = PA * kABytes + PB * kBBytes;
  static constexpr int kFit = (kSmemMax - 1024 - kTail) / kStageBytes;
  static constexpr int kStages = kFit > kMaxStages ? kMaxStages : kFit;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kSmemBytes = 1024 + kRingBytes + kTail;  // + alignment slack
  static_assert(kStages >= 2, "two stages fit");
};

// What a launch hands the kernel besides its tensor maps.
struct Args {
  int b_shared;              // Bm is shared by every vertex (its vertex coordinate is 0)
  int batch, m, n, kd;
  int row_tiles, col_tiles, items;
  int tail;                  // columns computed in the last column tile: 64, 128, 192 or 256
  int* counts;               // count: [batch] int32
  uint16_t* c;               // store: bf16 planes [planes][batch][m][c_sr]
  long long c_sb, c_sr, c_plane;
};

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// The box at (c0, c1, c2, c3) of a 4-d tensor map into shared memory at dst,
// completing its bytes on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// The same for a 5-d tensor map.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, int c4, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
      "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory matrix descriptor of a swizzled operand at addr (bits 0-13
// addr / 16, 16-29 leading byte offset / 16, 32-45 stride byte offset / 16,
// 62-63 layout: 1 = SWIZZLE_128B, 2 = SWIZZLE_64B).  A (K-major, rows of KK
// x 2 bytes): 8-row groups 8 rows apart (stride), the leading offset
// unused.  Bm (MN-major, 128-byte rows of 64 columns): the 64-column blocks
// kK rows apart (leading), 8-k groups 1024 bytes apart (stride).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead, uint32_t stride,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) | (static_cast<uint64_t>(stride >> 4) << 32) |
         (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma's issue or wait.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A Bm for one m64nWk16 step (W = 64, 128, 192 or 256 columns, into
// d[0, W/2)): A K-major and Bm MN-major (transpose bit) in shared memory;
// scale_d 0 starts the sum.  Column 8 j + 2 t (+ 1) of rows g and g + 8 of
// a warp's 16 lies in d[4 j], d[4 j + 1] and d[4 j + 2], d[4 j + 3] of its
// thread 4 g + t at every W, so a narrower product is a prefix of d.
template <int W>
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[128], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[128], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<192>(float (&d)[128], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<256>(float (&d)[128], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]),
        "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// bf16x2 bits of (lo, hi), each rounded to nearest even; lo in the lower half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// The low parts of a pair packed by pack_bf16x2: bf16(x - hi), bf16(y - hi).
__device__ __forceinline__ uint32_t low_bf16x2(float x, float y, uint32_t hi) {
  return pack_bf16x2(x - __uint_as_float(hi << 16), y - __uint_as_float(hi & 0xffff0000u));
}

// Work item -> (vertex, row tile, first column tile).  A count item walks all
// column tiles of its (vertex, row tile); a store item is one column tile.
template <bool kCount>
__device__ __forceinline__ void decode(const Args& g, int item, int& b, int& r, int& c) {
  if constexpr (kCount) {
    b = item / g.row_tiles;
    r = item - b * g.row_tiles;
    c = 0;
  } else {
    const int q = item / g.col_tiles;
    c = item - q * g.col_tiles;
    b = q / g.row_tiles;
    r = q - b * g.row_tiles;
  }
}

// Column tile walked at step t of a count item of row tile r: the one that
// holds its diagonal first (rows r*128.. lie in columns (r/2)*256..), then
// the others ascending.
__device__ __forceinline__ int count_column(int t, int r) {
  const int dc = r * kM / kN;
  return t == 0 ? dc : (t - 1 < dc ? t - 1 : t);
}

// The products of one column tile W columns wide (kN; the last tile of a row
// W = g.tail): each stage of k is waited for, its m64nWk16 wgmmas (into
// acc[0, W/2)) issued and committed, and the stage before it released once
// its products are done (wgmma.wait_group 1, so the tensor cores never wait
// for a release).  Returns with the tile's products done and its last stage
// released.
template <int W, int PA, int PB>
__device__ __forceinline__ void tile_products(float (&acc)[128], uint32_t ring_u32,
                                              uint64_t* full, uint64_t* empty, int wg, int lane,
                                              int kd, int& stage, uint32_t& phase) {
  using R = Ring<PA, PB>;
  constexpr int kK = R::kK, kABytes = R::kABytes, kBBytes = R::kBBytes;
  constexpr uint64_t kALayout = kK == 64 ? 1 : 2;  // SWIZZLE_128B, SWIZZLE_64B
  int prev = -1;
  for (int k0 = 0; k0 < kd; k0 += kK) {
    mbar_wait(full + stage, phase);
    const uint32_t sa = ring_u32 + stage * R::kStageBytes + wg * (64 * kK * 2);
    const uint32_t sb = ring_u32 + stage * R::kStageBytes + PA * kABytes;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kK / 16; ++ks)
#pragma unroll
      for (int pa = 0; pa < PA; ++pa)
#pragma unroll
        for (int pb = 0; pb < PB; ++pb) {
          if (pa + pb > 1) continue;  // lo.lo is not a pass
          wgmma<W>(acc, smem_desc(sa + pa * kABytes + ks * 32, 16, 8 * kK * 2, kALayout),
                   smem_desc(sb + pb * kBBytes + ks * 16 * 128, R::kBBlock, 1024, 1),
                   (k0 > 0 || ks > 0 || pa + pb > 0) ? 1 : 0);
        }
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
    prev = stage;
    if (++stage == R::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (lane == 0) mbar_arrive(empty + prev);
}

// kCount: counts[b] += #{i, j < m = n : sim[b, i, j] < sim[b, i, i]};
// otherwise c[p][b, i, j] = plane p of sim[b, i, j] in bf16 (hi; lo at PB = 2).
// A: PA bf16 planes, K-major; Bm: PB planes, MN-major; both by TMA.  Products: every plane pair
// pa + pb <= 1 (hi.hi; hi.lo, lo.hi).
template <bool kCount, int PA, int PB>
__global__ void __launch_bounds__(kThreads, 1)
tc_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
          const Args g) {
  using R = Ring<PA, PB>;
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  // the ring 1024-byte aligned (the swizzle's period), then the barriers
  const uint32_t raw = smem_u32(tc_smem);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* ring = tc_smem + pad;
  const uint32_t ring_u32 = raw + pad;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::kRingBytes);
  uint64_t* empty = full + R::kStages;
  float* diag_s = reinterpret_cast<float*>(empty + R::kStages);
  int* warp_counts = reinterpret_cast<int*>(diag_s + kM);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kd = g.kd;
  const int tiles = kCount ? g.col_tiles : 1;  // column tiles an item walks

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(full + s, 1);  // the TMA thread's arrival with the bytes
      mbar_init(empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int ptid = threadIdx.x - kConsumers;
    if (ptid != 0) return;  // one thread issues the loads
    constexpr int kK = R::kK, kABytes = R::kABytes, kBBytes = R::kBBytes;
    constexpr uint32_t kTx = PA * kABytes + PB * kBBytes;
    int stage = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
      int b, r, c;
      decode<kCount>(g, item, b, r, c);
      const int i0 = r * kM;
      const int bb = g.b_shared ? 0 : b;
      for (int t = 0; t < tiles; ++t) {
        const int j0 = (kCount ? count_column(t, r) : c) * kN;
        for (int k0 = 0; k0 < kd; k0 += kK) {
          mbar_wait(empty + stage, phase ^ 1);
          const uint32_t sa = ring_u32 + stage * R::kStageBytes;
          const uint32_t sb = sa + PA * kABytes;
          mbar_expect_tx(full + stage, kTx);
#pragma unroll
          for (int p = 0; p < PA; ++p)
            tma_load(sa + p * kABytes, &map_a, k0, i0, b, p, full + stage);
#pragma unroll 1
          for (int p = 0; p < PB; ++p)  // the 4 column blocks in one box
            tma_load(sb + p * kBBytes, &map_b, 0, k0, j0 / 64, bb, p, full + stage);
          if (++stage == R::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4;
  // this thread's accumulator rows (tile-local): rbase and rbase + 8
  const int rbase = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int tg = lane % 4;
  float acc[128];
  int stage = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
    int b, r, c;
    decode<kCount>(g, item, b, r, c);
    const int i0 = r * kM;
    float d0 = 0.0f, d1 = 0.0f;  // count: the diagonal of rows rbase, rbase + 8
    int count = 0;
    for (int t = 0; t < tiles; ++t) {
      const int ct = kCount ? count_column(t, r) : c;
      const int j0 = ct * kN;
      // the last column tile computes its columns only, to the next 64 (a
      // block of Bm's stage); the accumulators past them are never read as
      // entries: their columns lie past n
      const int w = ct == g.col_tiles - 1 ? g.tail : kN;
      if (w == kN) {
        tile_products<kN, PA, PB>(acc, ring_u32, full, empty, wg, lane, kd, stage, phase);
      } else if (w == 192) {
        tile_products<192, PA, PB>(acc, ring_u32, full, empty, wg, lane, kd, stage, phase);
      } else if (w == 128) {
        tile_products<128, PA, PB>(acc, ring_u32, full, empty, wg, lane, kd, stage, phase);
      } else {
        tile_products<64, PA, PB>(acc, ring_u32, full, empty, wg, lane, kd, stage, phase);
      }

      if constexpr (kCount) {
        if (t == 0) {  // the diagonal tile: the thread holding (i, i) shares it
#pragma unroll
          for (int i = 0; i < 128; ++i) {
            const int row = rbase + 8 * ((i >> 1) & 1);
            const int col = 8 * (i >> 2) + 2 * tg + (i & 1);
            if (i0 + row == j0 + col) diag_s[row] = acc[i];
          }
          asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
          d0 = i0 + rbase < g.m ? diag_s[rbase] : -INFINITY;
          d1 = i0 + rbase + 8 < g.m ? diag_s[rbase + 8] : -INFINITY;
        }
#pragma unroll
        for (int i = 0; i < 128; ++i) {
          const int col = 8 * (i >> 2) + 2 * tg + (i & 1);
          if (j0 + col < g.n) count += acc[i] < (((i >> 1) & 1) ? d1 : d0) ? 1 : 0;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 128; i += 2) {
          const int row = i0 + rbase + 8 * ((i >> 1) & 1);
          const int col = j0 + 8 * (i >> 2) + 2 * tg;
          if (row >= g.m || col >= g.n) continue;
          uint16_t* out = g.c + b * g.c_sb + row * g.c_sr + col;
          const uint32_t hi = pack_bf16x2(acc[i], acc[i + 1]);
          const bool pair = col + 1 < g.n;
          if (pair) {
            *reinterpret_cast<uint32_t*>(out) = hi;
          } else {
            *out = static_cast<uint16_t>(hi & 0xffffu);
          }
          if constexpr (PB == 2) {
            const uint32_t lo = low_bf16x2(acc[i], acc[i + 1], hi);
            if (pair) {
              *reinterpret_cast<uint32_t*>(out + g.c_plane) = lo;
            } else {
              out[g.c_plane] = static_cast<uint16_t>(lo & 0xffffu);
            }
          }
        }
      }
    }
    if constexpr (kCount) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(0xffffffffu, count, off);
      if (lane == 0) warp_counts[warp] = count;
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      if (threadIdx.x == 0) {
        int total = 0;
#pragma unroll
        for (int w = 0; w < kConsumerWarps; ++w) total += warp_counts[w];
        if (total != 0) atomicAdd(g.counts + b, total);
      }
    }
  }
}

// out[p][b, r, c] = plane p of x[b, r, c] in bf16: hi = bf16(x) and, with two
// planes, lo = bf16(x - hi); x float32 at any strides, out rows of o_sr
// elements (a multiple of 4, 8-byte aligned).  One block per row (b, r),
// four columns a thread: one 16-byte load where the row is contiguous and
// 16-byte aligned, an 8-byte store per plane.
__global__ void split_bf16_kernel(const float* __restrict__ x, long long sb, long long sr,
                                  long long sc, int rows, int cols, uint16_t* __restrict__ out,
                                  long long o_sb, long long o_sr, long long o_plane, int planes) {
  const long long row = blockIdx.x;
  const long long b = row / rows, r = row - b * rows;
  const float* src = x + b * sb + r * sr;
  uint16_t* dst = out + b * o_sb + r * o_sr;
  const bool vec = sc == 1 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  for (int c = 4 * threadIdx.x; c < cols; c += 4 * blockDim.x) {
    const bool whole = c + 4 <= cols;
    float v[4];
    if (vec && whole) {
      const float4 f = *reinterpret_cast<const float4*>(src + c);
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = c + e < cols ? src[(c + e) * sc] : 0.0f;
    }
    const uint2 hi = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
    const uint2 lo = make_uint2(low_bf16x2(v[0], v[1], hi.x), low_bf16x2(v[2], v[3], hi.y));
    for (int p = 0; p < planes; ++p) {
      const uint2 h = p == 0 ? hi : lo;
      uint16_t* d = dst + p * o_plane + c;
      if (whole) {
        *reinterpret_cast<uint2*>(d) = h;
      } else {  // 1 to 3 columns left
        d[0] = static_cast<uint16_t>(h.x);
        if (c + 1 < cols) d[1] = static_cast<uint16_t>(h.x >> 16);
        if (c + 2 < cols) d[2] = static_cast<uint16_t>(h.y);
      }
    }
  }
}

// libcuda's cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                  : nullptr;
  }();
  return fn;
}

// A 4-d bf16 tensor map (inner, rows, vertices, planes) with boxes of (kk,
// box_rows, 1, 1), swizzled in rows of kk x 2 bytes (kk 64 or 32); strides
// in elements.  False where a
// tensor map cannot describe the operand: a base not 16-byte aligned, or a
// stride (of an axis longer than 1) not a positive multiple of 16 bytes.
bool make_map(CUtensorMap* map, const void* base, long long inner, long long rows,
              long long vertices, long long planes, long long s_row, long long s_vertex,
              long long s_plane, int kk, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0) return false;
  const long long extent[4] = {inner, rows, vertices, planes};
  long long stride[4] = {1, s_row, s_vertex, s_plane};
  cuuint64_t dims[4], strides[3];
  for (int i = 0; i < 4; ++i) dims[i] = static_cast<cuuint64_t>(extent[i]);
  for (int i = 1; i < 4; ++i) {
    // an axis of length 1 is never stepped along: give it a well-formed stride
    if (extent[i] == 1) stride[i] = ((stride[i - 1] * extent[i - 1] + 7) / 8) * 8;
    const long long bytes = stride[i] * 2;
    if (bytes <= 0 || bytes % 16 != 0 || bytes >= (1ll << 40)) return false;
    strides[i - 1] = static_cast<cuuint64_t>(bytes);
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kk), static_cast<cuuint32_t>(box_rows), 1,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                kk == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Bm's 5-d tensor map (64 columns, k, column block, vertices, planes): a
// box of (64, kk, 4, 1, 1) is a stage's [4 blocks][kk][64 columns] plane in
// one load.  The rows (s_k) must hold whole 64-column blocks
// (hopper_metrics.padded_planes pads them to 64 elements, 128 bytes, so
// every box row is one aligned 128-byte line); columns past n in the last
// block are read from the padding and never counted or stored.
bool make_map_b(CUtensorMap* map, const void* base, long long n, long long kd,
                long long vertices, long long planes, long long s_k, long long s_vertex,
                long long s_plane, int kk) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0 || s_k % 64 != 0 ||
      s_k < n)
    return false;
  const long long extent[5] = {64, kd, (n + 63) / 64, vertices, planes};
  long long stride[5] = {1, s_k, 64, s_vertex, s_plane};
  cuuint64_t dims[5], strides[4];
  for (int i = 0; i < 5; ++i) dims[i] = static_cast<cuuint64_t>(extent[i]);
  for (int i = 1; i < 5; ++i) {
    if (extent[i] == 1 && i >= 3) stride[i] = stride[1] * kd * (i == 4 ? extent[3] : 1);
    const long long bytes = stride[i] * 2;
    if (bytes <= 0 || bytes % 16 != 0 || bytes >= (1ll << 40)) return false;
    strides[i - 1] = static_cast<cuuint64_t>(bytes);
  }
  const cuuint32_t box[5] = {64, static_cast<cuuint32_t>(kk), kN / 64, 1, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

template <bool kCount, int PA, int PB>
cudaError_t launch(const CUtensorMap& map_a, const CUtensorMap& map_b, Args g, cudaStream_t s) {
  using R = Ring<PA, PB>;
  auto kernel = tc_kernel<kCount, PA, PB>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmemBytes);
  if (err != cudaSuccess) return err;
  g.row_tiles = (g.m + kM - 1) / kM;
  g.col_tiles = (g.n + kN - 1) / kN;
  g.tail = (g.n - (g.col_tiles - 1) * kN + 63) / 64 * 64;
  g.items = g.batch * g.row_tiles * (kCount ? 1 : g.col_tiles);
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = g.items < sms ? g.items : sms;
  kernel<<<grid, kThreads, R::kSmemBytes, s>>>(map_a, map_b, g);
  return cudaGetLastError();
}

}  // namespace tc

// counts[b] += #{(i, j) : i, j < nv, sim[b, i, j] < sim[b, i, i]} with
// sim[b] = A[b] Bm[b]; A[b, i, k] at a + b a_sb + i a_si + k a_sk and
// Bm[b, k, j] at bm + b b_sb + k b_sk + j b_sj (strides in elements; Bm
// float32, A float32 or, with a_bf16, bf16 with a_sk == 1), at highest
// (the SIMT core).  counts: [batch] int32, zeroed by the caller.
// stream: the caller's cudaStream_t.  Returns the cudaError_t of the launch
// (0 = ok).
extern "C" int streamed_count_launch(const void* a, long long a_sb, long long a_si,
                                     long long a_sk, const void* bm, long long b_sb,
                                     long long b_sk, long long b_sj, int batch, int nv,
                                     int kd, int a_bf16, void* counts, void* stream) {
  if (!valid_grid(batch, nv, nv, kd)) return static_cast<int>(cudaErrorInvalidValue);
  const Operand<float> op_b{static_cast<const float*>(bm), b_sb, b_sj, b_sk};
  const auto s = static_cast<cudaStream_t>(stream);
  int* cnt = static_cast<int*>(counts);
  if (a_bf16) {
    const Operand<uint16_t> op_a{static_cast<const uint16_t*>(a), a_sb, a_si, a_sk};
    return static_cast<int>(dispatch_layout<true, kHighest>(op_a, op_b, batch, nv, nv, kd, cnt,
                                                            nullptr, 0, s));
  }
  const Operand<float> op_a{static_cast<const float*>(a), a_sb, a_si, a_sk};
  return static_cast<int>(dispatch_layout<true, kHighest>(op_a, op_b, batch, nv, nv, kd, cnt,
                                                          nullptr, 0, s));
}

// c[b] = A[b] Bm[b] for float32 A [batch, m, kd] and Bm [batch, kd, n]
// (strides in elements, as above) at highest (the SIMT core); c: [batch, m,
// ldc] float32, ldc >= n, of which the first n columns are written.  Returns
// the cudaError_t of the launch (0 = ok).
extern "C" int gemm_store_launch(const void* a, long long a_sb, long long a_si,
                                 long long a_sk, const void* bm, long long b_sb,
                                 long long b_sk, long long b_sj, int batch, int m, int n,
                                 int kd, void* c, long long ldc, void* stream) {
  if (!valid_grid(batch, m, n, kd) || ldc < n) return static_cast<int>(cudaErrorInvalidValue);
  const Operand<float> op_a{static_cast<const float*>(a), a_sb, a_si, a_sk};
  const Operand<float> op_b{static_cast<const float*>(bm), b_sb, b_sj, b_sk};
  return static_cast<int>(dispatch_layout<false, kHighest>(op_a, op_b, batch, m, n, kd, nullptr,
                                                           static_cast<float*>(c), ldc,
                                                           static_cast<cudaStream_t>(stream)));
}


// ---------------------------------------------------------------------------
// The tensor-core entry points (default, high).  Operands are bf16 planes:
// plane p of element (b, o, k) of A at a + p a_plane + b a_sb + o a_si + k,
// of Bm (b, k, j) at bm + p b_plane + b b_sb + k b_sk + j (strides in
// elements).  a_planes / b_planes: 1 (default) or 2 (high: hi and lo; a bf16
// first operand has one).  Each returns the cudaError_t of its launch (0 ok).
// ---------------------------------------------------------------------------

namespace {

// The (PA, PB) instantiations the wrappers use: count (1, 1), (1, 2) and
// (2, 2); store (1, 1) and (2, 2).
template <bool kCount>
cudaError_t tc_dispatch(int a_planes, int b_planes, const CUtensorMap& map_a,
                        const CUtensorMap& map_b, const tc::Args& g, cudaStream_t s) {
  if (a_planes == 1 && b_planes == 1) return tc::launch<kCount, 1, 1>(map_a, map_b, g, s);
  if (a_planes == 2 && b_planes == 2) return tc::launch<kCount, 2, 2>(map_a, map_b, g, s);
  if constexpr (kCount) {
    if (a_planes == 1 && b_planes == 2) return tc::launch<true, 1, 2>(map_a, map_b, g, s);
  }
  return cudaErrorInvalidValue;
}

bool valid_planes(int a_planes, int b_planes) {
  return (a_planes == 1 || a_planes == 2) && (b_planes == 1 || b_planes == 2);
}

}  // namespace

// counts[b] += #{(i, j) : i, j < nv, sim[b, i, j] < sim[b, i, i]} with sim[b]
// the bf16 product of A [batch, nv, kd] and Bm [batch, kd, nv] (Bm's vertex
// coordinate is 0 where b_shared), both by tensor map (the wrapper's rule:
// hopper_metrics.tma_eligible; an operand a tensor map cannot describe is
// refused).  counts: [batch] int32, zeroed by the caller.
extern "C" int tc_count_launch(const void* a, long long a_sb, long long a_si, long long a_plane,
                               int a_planes, const void* bm, long long b_sb,
                               long long b_sk, long long b_plane, int b_planes, int b_shared,
                               int batch, int nv, int kd, void* counts, void* stream) {
  if (!valid_grid(batch, nv, nv, kd) || !valid_planes(a_planes, b_planes))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a{}, map_b{};
  const int kk = b_planes == 2 ? tc::stage_k<2>() : tc::stage_k<1>();
  if (!tc::make_map(&map_a, a, kd, nv, batch, a_planes, a_si, a_sb, a_plane, kk, tc::kM) ||
      !tc::make_map_b(&map_b, bm, nv, kd, b_shared ? 1 : batch, b_planes, b_sk, b_sb, b_plane,
                      kk))
    return static_cast<int>(cudaErrorInvalidValue);
  tc::Args g{};
  g.b_shared = b_shared;
  g.batch = batch;
  g.m = g.n = nv;
  g.kd = kd;
  g.counts = static_cast<int*>(counts);
  return static_cast<int>(
      tc_dispatch<true>(a_planes, b_planes, map_a, map_b, g, static_cast<cudaStream_t>(stream)));
}

// c planes [b, i, j] = the bf16 product of A [batch, m, kd] and Bm [batch,
// kd, n], written in bf16: plane 0 hi and, with two planes of each operand,
// plane 1 lo = bf16(sim - hi); c at c + p c_plane + b c_sb + i c_sr + j, rows
// of c_sr elements (an even number), of which the first n are written.
// streamed_acc_from_inv's Z = inv U.
extern "C" int tc_store_launch(const void* a, long long a_sb, long long a_si, long long a_plane,
                               int a_planes, const void* bm, long long b_sb, long long b_sk,
                               long long b_plane, int b_planes, int batch, int m, int n, int kd,
                               void* c, long long c_sb, long long c_sr, long long c_plane,
                               void* stream) {
  if (!valid_grid(batch, m, n, kd) || !valid_planes(a_planes, b_planes) || c_sr < n ||
      c_sr % 2 != 0 || reinterpret_cast<uintptr_t>(c) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a{}, map_b{};
  const int kk = b_planes == 2 ? tc::stage_k<2>() : tc::stage_k<1>();
  if (!tc::make_map(&map_a, a, kd, m, batch, a_planes, a_si, a_sb, a_plane, kk, tc::kM) ||
      !tc::make_map_b(&map_b, bm, n, kd, batch, b_planes, b_sk, b_sb, b_plane, kk))
    return static_cast<int>(cudaErrorInvalidValue);
  tc::Args g{};
  g.batch = batch;
  g.m = m;
  g.n = n;
  g.kd = kd;
  g.c = static_cast<uint16_t*>(c);
  g.c_sb = c_sb;
  g.c_sr = c_sr;
  g.c_plane = c_plane;
  return static_cast<int>(
      tc_dispatch<false>(a_planes, b_planes, map_a, map_b, g, static_cast<cudaStream_t>(stream)));
}

// out planes [b, r, c] = bf16(x) (plane 0) and bf16(x - bf16(x)) (plane 1,
// with planes = 2) of float32 x [batch, rows, cols] at strides (sb, sr, sc);
// out at out + p o_plane + b o_sb + r o_sr + c, 8-byte aligned, with o_sb,
// o_sr and o_plane multiples of 4.
extern "C" int split_bf16_launch(const void* x, long long sb, long long sr, long long sc,
                                 int batch, int rows, int cols, void* out, long long o_sb,
                                 long long o_sr, long long o_plane, int planes, void* stream) {
  const long long n_rows = static_cast<long long>(batch) * rows;
  if (batch <= 0 || rows <= 0 || cols <= 0 || n_rows >= (1ll << 31) || (planes != 1 && planes != 2) ||
      o_sb % 4 != 0 || o_sr % 4 != 0 || o_plane % 4 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = cols >= 1024 ? 256 : 128;
  tc::split_bf16_kernel<<<static_cast<unsigned>(n_rows), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), sb, sr, sc, rows, cols, static_cast<uint16_t*>(out), o_sb,
      o_sr, o_plane, planes);
  return static_cast<int>(cudaGetLastError());
}
