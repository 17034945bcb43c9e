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
// Precision, as the TPU kernels take it (pallas_metrics.py:38-47): every
// function comes in three variants, picked by the `precision` argument:
//   0 highest  float32 FMAs on the CUDA cores (the SIMT core below);
//   1 default  one bf16 pass: each operand rounded to bf16 (nearest even) in
//              registers, mma.sync.m16n8k16 bf16 x bf16 with float32
//              accumulators;
//   2 high     bf16 x 3: x = hi + lo, hi = bf16(x), lo = bf16(x - hi);
//              hi.hi, hi.lo and lo.hi issued into one accumulator.
// The first operand A may be bf16 (a_bf16; the selection path's bf16
// predictions and fold patches) at every precision: its values are exact.
// streamed_acc_from_inv at default rounds inv and U for Z and Z again for
// the count, as the TPU's two dots do.
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
// so operations bind all three, by a factor of ~25 over bytes.  At highest the
// work stays in float32 FMAs on the CUDA cores (no TF32: the counts decide the
// alpha selection, which is gated on strict float32), so the kernel is as fast
// as its FMA issue rate: everything that is not an FFMA in the consumers' loop,
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
//   * Arithmetic (highest): every entry is one float32 accumulator that
//     starts at 0 and takes __fmaf_rn(a_k, b_k, acc) for k ascending (the
//     zero-filled k past the end adds +0); built without --use_fast_math.
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
//
// The tensor-core variants (default, high).  Bound on an H100 SXM at 989
// TFLOP/s bf16 dense, same shapes; high is 3 passes of a float32 x float32
// product and 2 where the first operand is bf16 (the selection's case):
//   streamed_pairwise_acc      7.04e11 FLOP -> 0.71 ms  (high: 2.14 ms; 1.42 bf16 A)
//   streamed_acc_from_factors  5.16e11 FLOP -> 0.52 ms  (high: 1.56 ms; 1.04 bf16 A)
//   streamed_acc_from_inv      7.52e11 FLOP -> 0.76 ms  (high: 2.28 ms; 1.76 bf16 A,
//                              whose Z = inv U GEMM keeps its 3 passes)
// With float32 operands the bytes (0.26-0.46 ms) come within a factor of
// ~2-3 of that.  The design is the simplest right one: the same ring of
// float32 stages, the same producer warpgroup and the same diagonal rule;
// only the consumers change.  Each of the 8 consumer warps owns a 64 x 32
// block of the 128 x 128 tile (4 x 4 m16n8 accumulators, 64 floats a
// thread) and, per 16 k, reads its A and Bm fragments from the float32 stage
// as the m16n8k16 layout lays them out, rounds each pair to bf16x2 in
// registers (cvt.rn.bf16x2.f32) and issues 16 mma.sync (48 at high).
//   * The diagonal still comes from the block's own tile: the mma fragments
//     spread the (i, i) entries over the lanes, so the thread that holds one
//     puts it in shared memory and each thread reads back the 8 of its rows,
//     as the SIMT core does.  On integer inputs with |x| <= 16, which bf16
//     holds exactly and float32 sums exactly, every variant counts exactly.
//   * A bf16 first operand stays bf16 in its stage ([o][k], rows of 40
//     elements), copied 16, 8 or 4 bytes a cp.async by its alignment (Xv_b's
//     vertex stride K x 2 = 1500 bytes is 16-byte aligned only on every
//     fourth vertex), and with plain 2-byte loads where a row starts only
//     2-byte aligned (cp.async copies 4, 8 or 16 bytes).  The mma consumers
//     read its fragment words as they are (a bf16 value has no low part, so
//     high issues two MMAs), the SIMT consumers widen 4 values from one
//     8-byte load.  The producer thread arrives on the stage's "full"
//     barrier once after its A tile (a release for plain stores) and once
//     (cp.async ...noinc) when its copies land.  It takes a k-contiguous A
//     (the wrapper makes one).
//   * wgmma, TMA and a persistent schedule are left to a later change: this
//     core reads every fragment from shared memory through the register file.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libstreamed_count.so streamed_count.cu

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
constexpr int kHighest = 0, kDefault = 1, kHigh = 2;
// tensor-core consumers: 2 x 4 warps, each a 64 x 32 block of m16n8 tiles
constexpr int kWarpRows = 64, kWarpCols = 32;
constexpr int kMTiles = kWarpRows / 16, kNTiles = kWarpCols / 8;
static_assert((kTile / kWarpRows) * (kTile / kWarpCols) == kConsumerWarps, "warp grid");

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

// ---------------------------------------------------------------------------
// Tensor-core consumers: bf16 fragments and mma.sync
// ---------------------------------------------------------------------------

// Element (o, k) of a float32 stage buffer in its layout.
template <bool OMajor>
__device__ __forceinline__ float stage_at(const float* s, int o, int k) {
  return OMajor ? s[o * kPitchO + k] : s[k * kPitchK + o];
}

// bf16x2 bits of (lo, hi), each rounded to nearest even; lo in the lower half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// The fragment register of the pair (x, y): hi = bf16(x, y); at high also
// lo = bf16(x - hi, y - hi).
template <int kPrec>
__device__ __forceinline__ void frag(float x, float y, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16x2(x, y);
  if constexpr (kPrec == kHigh)
    lo = pack_bf16x2(x - __uint_as_float(hi << 16), y - __uint_as_float(hi & 0xffff0000u));
}

// c += a b for one m16n8k16 tile: a 4 and b 2 registers of bf16x2, c 4 floats.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += the first `steps` 16-deep k steps of a stage.  Warp (wm, wn) owns tile
// rows wm * 64 + [0, 64) and columns wn * 32 + [0, 32); lane = 4 g + t.  The
// m16n8k16 layouts: A register r holds (row g + 8 (r & 1), k 2t + 8 (r >> 1)
// + {0, 1}); B register r holds (k 2t + 8 r + {0, 1}, column g); accumulator
// q holds (row g + 8 (q >> 1), column 2t + (q & 1)).
template <bool AO, bool BO, int kPrec, bool ABf16>
__device__ __forceinline__ void mma_stage(const float* sa, const float* sb, int steps, int wm,
                                          int wn, int g, int t,
                                          float (&acc)[kMTiles][kNTiles][4]) {
#pragma unroll
  for (int ks = 0; ks < kStageK / 16; ++ks) {
    if (ks >= steps) break;
    const int k = ks * 16 + 2 * t;
    uint32_t a_hi[kMTiles][4], a_lo[kMTiles][4];
    uint32_t b_hi[kNTiles][2], b_lo[kNTiles][2];
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi) {
      const int r = wm * kWarpRows + mi * 16 + g;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rr = r + 8 * (q & 1), kk = k + 8 * (q >> 1);
        if constexpr (ABf16) {  // the stage holds the bf16 pair as it is; no low part
          a_hi[mi][q] = *reinterpret_cast<const uint32_t*>(
              reinterpret_cast<const uint16_t*>(sa) + rr * kPitchH + kk);
        } else {
          frag<kPrec>(stage_at<AO>(sa, rr, kk), stage_at<AO>(sa, rr, kk + 1), a_hi[mi][q],
                      a_lo[mi][q]);
        }
      }
    }
#pragma unroll
    for (int ni = 0; ni < kNTiles; ++ni) {
      const int c = wn * kWarpCols + ni * 8 + g;
#pragma unroll
      for (int q = 0; q < 2; ++q)
        frag<kPrec>(stage_at<BO>(sb, c, k + 8 * q), stage_at<BO>(sb, c, k + 8 * q + 1),
                    b_hi[ni][q], b_lo[ni][q]);
    }
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNTiles; ++ni) {
        mma_bf16(acc[mi][ni], a_hi[mi], b_hi[ni]);
        if constexpr (kPrec == kHigh) {
          mma_bf16(acc[mi][ni], a_hi[mi], b_lo[ni]);
          if constexpr (!ABf16) mma_bf16(acc[mi][ni], a_lo[mi], b_hi[ni]);  // else lo = 0
        }
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
  } else {
    const int warp = threadIdx.x / 32;
    const int wm = warp / (kTile / kWarpCols), wn = warp % (kTile / kWarpCols);
    const int g = lane / 4, tg = lane % 4;
    float d[kMTiles][2];  // count: the diagonal of this thread's 8 rows (-inf past nv)
    for (int t = 0; t < col_tiles; ++t) {
      const int j0 = column_tile<kCount>(t, row_tile) * kTile;
      float acc[kMTiles][kNTiles][4];
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNTiles; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0f;

      for (int k0 = 0; k0 < kd; k0 += kStageK) {
        mbar_wait(full + stage, phase);
        const float* sa = ring + stage * kStageFloats;
        const float* sb = sa + kOperandFloats;
        const int kv = kd - k0;
        // the last stage stops after the last 16 k that hold valid k
        mma_stage<AO, BO, kPrec, ABf16>(sa, sb, kv >= kStageK ? kStageK / 16 : (kv + 15) / 16,
                                        wm, wn, g, tg, acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }

      if constexpr (kCount) {
        if (t == 0) {  // the diagonal tile: the lane holding (i, i) shares it
#pragma unroll
          for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
            for (int ni = 0; ni < kNTiles; ++ni)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int i = wm * kWarpRows + mi * 16 + g + 8 * (q >> 1);
                if (i == wn * kWarpCols + ni * 8 + 2 * tg + (q & 1)) diag_s[i] = acc[mi][ni][q];
              }
          consumers_sync();
#pragma unroll
          for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = wm * kWarpRows + mi * 16 + g + 8 * h;
              d[mi][h] = i0 + i < m ? diag_s[i] : -INFINITY;
            }
        }
#pragma unroll
        for (int ni = 0; ni < kNTiles; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (j0 + wn * kWarpCols + ni * 8 + 2 * tg + e >= n) continue;
#pragma unroll
            for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
              for (int h = 0; h < 2; ++h) count += acc[mi][ni][2 * h + e] < d[mi][h] ? 1 : 0;
          }
      } else {
        float* out = c + static_cast<long long>(b) * m * ldc;
#pragma unroll
        for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + wm * kWarpRows + mi * 16 + g + 8 * (q >> 1);
            if (i >= m) continue;
#pragma unroll
            for (int ni = 0; ni < kNTiles; ++ni) {
              const int j = j0 + wn * kWarpCols + ni * 8 + 2 * tg + (q & 1);
              if (j < n) out[i * ldc + j] = acc[mi][ni][q];
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

template <bool kCount, typename TA>
cudaError_t dispatch(int precision, const Operand<TA>& a, const Operand<float>& bm, int batch,
                     int m, int n, int kd, int* counts, float* c, long long ldc,
                     cudaStream_t s) {
  switch (precision) {
    case kHighest:
      return dispatch_layout<kCount, kHighest>(a, bm, batch, m, n, kd, counts, c, ldc, s);
    case kDefault:
      return dispatch_layout<kCount, kDefault>(a, bm, batch, m, n, kd, counts, c, ldc, s);
    case kHigh:
      return dispatch_layout<kCount, kHigh>(a, bm, batch, m, n, kd, counts, c, ldc, s);
    default:
      return cudaErrorInvalidValue;
  }
}

bool valid_grid(int batch, int rows, int cols, int kd) {
  return batch > 0 && batch <= 65535 && rows > 0 && cols > 0 && kd > 0;
}

}  // namespace

// counts[b] += #{(i, j) : i, j < nv, sim[b, i, j] < sim[b, i, i]} with
// sim[b] = A[b] Bm[b]; A[b, i, k] at a + b a_sb + i a_si + k a_sk and
// Bm[b, k, j] at bm + b b_sb + k b_sk + j b_sj (strides in elements; Bm
// float32, A float32 or, with a_bf16, bf16 with a_sk == 1).  precision: 0
// highest, 1 default, 2 high.  counts: [batch] int32, zeroed by the caller.
// stream: the caller's cudaStream_t.  Returns the cudaError_t of the launch
// (0 = ok).
extern "C" int streamed_count_launch(const void* a, long long a_sb, long long a_si,
                                     long long a_sk, const void* bm, long long b_sb,
                                     long long b_sk, long long b_sj, int batch, int nv,
                                     int kd, int precision, int a_bf16, void* counts,
                                     void* stream) {
  if (!valid_grid(batch, nv, nv, kd)) return static_cast<int>(cudaErrorInvalidValue);
  const Operand<float> op_b{static_cast<const float*>(bm), b_sb, b_sj, b_sk};
  const auto s = static_cast<cudaStream_t>(stream);
  int* cnt = static_cast<int*>(counts);
  if (a_bf16) {
    const Operand<uint16_t> op_a{static_cast<const uint16_t*>(a), a_sb, a_si, a_sk};
    return static_cast<int>(dispatch<true>(precision, op_a, op_b, batch, nv, nv, kd, cnt,
                                           nullptr, 0, s));
  }
  const Operand<float> op_a{static_cast<const float*>(a), a_sb, a_si, a_sk};
  return static_cast<int>(dispatch<true>(precision, op_a, op_b, batch, nv, nv, kd, cnt,
                                         nullptr, 0, s));
}

// c[b] = A[b] Bm[b] for float32 A [batch, m, kd] and Bm [batch, kd, n]
// (strides in elements, as above) at precision (0 highest, 1 default, 2
// high); c: [batch, m, ldc] float32, ldc >= n, of which the first n columns
// are written.  Returns the cudaError_t of the launch (0 = ok).
extern "C" int gemm_store_launch(const void* a, long long a_sb, long long a_si,
                                 long long a_sk, const void* bm, long long b_sb,
                                 long long b_sk, long long b_sj, int batch, int m, int n,
                                 int kd, int precision, void* c, long long ldc, void* stream) {
  if (!valid_grid(batch, m, n, kd) || ldc < n) return static_cast<int>(cudaErrorInvalidValue);
  const Operand<float> op_a{static_cast<const float*>(a), a_sb, a_si, a_sk};
  const Operand<float> op_b{static_cast<const float*>(bm), b_sb, b_sj, b_sk};
  return static_cast<int>(dispatch<false>(precision, op_a, op_b, batch, m, n, kd, nullptr,
                                          static_cast<float*>(c), ldc,
                                          static_cast<cudaStream_t>(stream)));
}
