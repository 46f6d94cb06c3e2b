// The f32-x tensor-core loop (Loop kMmaF32, kernels/takum_matmul.py
// "mma_f32"): out[M, N] = x[M, K] @ decode(w_bits[K, N]) for an f32 x above
// M = 16, on Hopper's bf16 tensor cores through `wgmma`, warp-specialised.
// It runs K3 with f32 x (takum_matmul.cu, every flat and mx format) and
// K3's transposed launch, K5's backward dx = g @ decode(w_bits)^T
// (takum_matmul_wt.cu, WT: the stored weight [N, K] read in place).
//
// Replaces, for those launches, the Pallas kernel
// src/repro/kernels/takum_matmul.py:56 _mm_kernel (dual=False, entry
// takum_matmul :166 with f32 x; its mx branch :61-80, :111-132; its lut
// branch :139-142; its out_fmt epilogue :96-106) and the backward rule
// :211 _takum_matmul_bwd of takum_matmul_ad (:190), which runs _mm_kernel
// over w_bits.T.
//
// Bound on the H100: the products.  At M = 1024 over llama3-8b's wi
// (4096 x 14336) 2 M N K = 1.2e14 operations: 1.795 ms at the f32 rate
// outside the tensor cores (67 TFLOP/s, the FMA tile of matmul_tile.cuh
// this loop replaces, which reached about 30 % of it), 0.365 ms as three
// bf16 MMAs per product at 989 TFLOP/s, 0.730 ms as six (t16).  The bytes
// (x or g, the weight bits, the output) take 0.03 ms.  What the design
// does about the bound:
//
// - Exact products.  An f32 value is the exact sum of three bf16 parts:
//   hi = x with its low 16 bits cleared (truncation, so a finite x never
//   gives an infinite part); r = x - hi, exact; mid = r with its low 16
//   bits cleared; lo = r - mid, exact.  hi and mid are bf16 values by
//   construction; lo holds at most 8 significant bits, so it is one too
//   wherever it lies on bf16's grid, whose finest step is bf16's smallest
//   subnormal 2^-133.  lo is a multiple of x's ulp, so that holds for every
//   finite x with |x| >= 2^-110 (ulp >= 2^-133), and below 2^-110 exactly
//   for the x that are multiples of 2^-133 (0 among them).  A product of
//   two bf16 values (16 significant bits) is exact in f32 wherever it is
//   0 or at least 2^-133 and finite; so x * w is the exact sum of the
//   products of x's three parts with w's bf16 parts: one part for every
//   decoded t8, e4m3, e5m2, bf16 and mx value, hi and lo = w - hi for a
//   t16 value (matmul_mma.cuh): 3 MMAs per product, 6 for t16.
//   kernels/takum_matmul.py split3_bf16 is the plain twin of the split,
//   and tests/test_torch_split3.py holds it and the products on the CPU.
// - The vote.  A block whose operands the parts do not carry recomputes its
//   whole tile on the FMA tile (fma_tile of matmul_tile.cuh) before its
//   flush, as matmul_mma.cuh's tile does: an x (or g) that is +-inf, NaN,
//   or nonzero and not a multiple of 2^-133 below 2^-110 (its lo is off
//   bf16's grid); a weight whose bf16 parts do not sum to it (f32's largest
//   finite value, from the saturating t8 / t16 codes); and an infinite
//   weight, since a zero part of a finite x times inf is a NaN that x * inf
//   is not.  Each producer thread ORs its verdict into one shared flag
//   before its warp releases a stage; the consumers read it after the last
//   stage.  Nothing falls back outside the kernel.
// - Order.  The tensor cores' f32 accumulation truncates (PERF.md §6:
//   straight sums read 4e-5 of |x| @ |w| on all-positive t16 rows).
//   So each stage's kBK = 32 k terms go, through every part pair, into a
//   fresh partial that the first wgmma starts from zero (scale-d 0), which
//   is then added to the running f32 sum with one IEEE add.  The pairs run
//   smallest first (x lo, mid, hi; under t16 w lo before w hi), each over
//   both k16 halves, so only the last two wgmmas act at the partial's full
//   magnitude.  The order depends on the shape and the plan alone: lut ==
//   bits and run == run, bit for bit.
// - Warp specialisation.  The bf16-x tile of matmul_mma.cuh showed that
//   the MMAs are not its bound but the decode and staging around them,
//   alternating with them.
//   Here a block of BM x BN (128 x 128: 512 threads, one block per SM;
//   64 x 64: 256 threads, two per SM; kernels/takum_matmul.py mma_plan) is
//   BM / 64 consumer warpgroups, each running m64nBNk16 wgmmas for 64 rows,
//   and as many producer warpgroups (setmaxnreg moves registers from the
//   producers, 96, to the consumers, 160, at 128 x 128).  The producers
//   bring the raw f32 x tile and the weight bits into a kRaw-deep ring,
//   then decode the weight tile to bf16 and split the x tile into its three
//   bf16 A tiles, into a kSlots-deep ring that full / empty mbarriers hand
//   to the consumers.  While the consumers multiply stage s the producers
//   fill stage s + 1.  The raw copies take one of two instantiations,
//   chosen at launch (launch_wgmma):
//   - TMA: a flat format whose x rows and weight rows are 16-byte multiples
//     from 16-byte-aligned bases (K % 4 == 0; N * EB, or K * EB under WT,
//     % 16 == 0: every llama3-8b prefill and backward shape).
//     Producer thread 0 loads a stage with two 2-D tensor-map copies (x
//     [M, K]: a 32 x BM box, 128-byte swizzle; the weight: a BN x 32 box of
//     k rows, unswizzled, or under WT a 32 x BN box of stored n rows, 32- or
//     64-byte swizzle), counted on the raw slot's full mbarrier, and refills
//     a slot once every producer warp has arrived on its empty one.  The
//     copy engine zero-fills rows past M and N and k past K.  The swizzles
//     keep the producers' 16-byte shared loads free of bank conflicts.
//   - cp.async: 16-byte cp.async per producer thread, zero-filled at the
//     edges, and a named barrier of the producers per stage: any alignment
//     of a row (ragged K, odd N of 1-byte elements, 33-byte mx groups).
//   The tensor maps took about 15 % off K5's backward over wi on an H100
//   (PERF.md §6; tools/tile_variants.py f32_cpasync puts every launch on
//   cp.async).  One cp.async.bulk per staged row instead (f32_bulk:
//   160-256 requests a stage) was several times slower.
// - One shared-memory layout for B in both load modes.  A and B tiles are
//   K-major, in wgmma's unswizzled canonical layout: core matrices of 8 rows
//   x 8 k (16 bytes a row, 128 bytes each), the four along k 128 bytes
//   apart (LBO), successive 8-row groups 512 bytes apart (SBO).  A producer
//   thread decodes 8 consecutive k of one column n and stores them as one
//   16-byte row of a core matrix, whether the bits were staged as k rows
//   (K3: byte j from line kk) or as n rows (WT: 8 consecutive codes of one
//   line).  The wgmmas are then the same instructions over the same values
//   in both modes, so the transposed launch equals K3 over a transposed
//   copy of the bits bit for bit (and the fallback's fma_tile is equal in
//   both modes too).
// - Edges: x rows past M and k past K are staged as 0; a weight element
//   past K or N decodes as 0 whatever its staged bytes, so a NaN in padding
//   never meets a 0; M and N lanes outside the output are never stored.
// - Epilogue (the consumers alone; the producers have exited): the unfused
//   flush stores the f32 fragments; the FUSED twin stages the tile in shared
//   memory (over the rings) and calls repro::store_encoded_tile_by, so its
//   output is K2's encode of the unfused launch's.
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include "matmul_mma.cuh"

namespace repro_wg {

constexpr int kBK = repro_mma::kBK;  // k per stage, and per partial sum
constexpr int kRaw = 4;              // depth of the raw ring (x f32, weight bits)
constexpr int kSlots = 2;            // depth of the bf16 ring (producers -> consumers)
constexpr int kXParts = 3;           // x = hi + mid + lo
constexpr int kXPitch = kBK * 4 + 16;  // bytes per staged f32 x row, padded off its banks
constexpr int kProducerRegs = 96, kConsumerRegs = 160;  // setmaxnreg at 128 x 128
constexpr int kProducerBar = 1, kConsumerBar = 2;     // named barriers (0: __syncthreads)

// Pair i of a stage, smallest product first: x parts hi 0, mid 1, lo 2; w
// parts hi 0, lo 1 (t16).  Split: (lo, lo), (lo, hi), (mid, lo), (mid, hi),
// (hi, lo), (hi, hi); else x lo, mid, hi against w's one part.
__host__ __device__ constexpr int pair_x(bool split, int i) { return split ? 2 - i / 2 : 2 - i; }
__host__ __device__ constexpr int pair_w(bool split, int i) { return split ? 1 - i % 2 : 0; }

template <int FMT, bool WT, int BM>
struct Cfg {
  static constexpr int BN = BM;
  static constexpr bool kMx = repro::kIsMx<FMT>;
  static constexpr int kEB = repro::kElemBits<FMT> / 8;
  static constexpr bool kSplit = FMT == repro::kT16;
  static constexpr int kWParts = kSplit ? 2 : 1;
  static constexpr int kPairs = kSplit ? 6 : 3;
  static constexpr int kCWG = BM / 64;  // consumer warpgroups (64 rows each), then producers
  static constexpr int kCT = 128 * kCWG, kPT = 128 * kCWG, kNT = kCT + kPT;
  static constexpr int kMinBlocks = BM == 128 ? 1 : 2;
  // a staged weight line: K3 one k row's BN columns (mx: BN / 32 groups),
  // WT one stored n row's kBK k's
  static constexpr int kWSpan = WT ? kBK * kEB : (kMx ? BN / 32 * repro::kMxGroup : BN * kEB);
  static constexpr int kWPitch = 16 * repro::span_chunks(kWSpan);
  static constexpr int kWLines = WT ? BN : kBK;
  static constexpr int kWCh = kWPitch / 16;
  static constexpr int kWSlot = kWLines * kWPitch;
  static constexpr int kXSlot = BM * kXPitch;
  static constexpr int kATile = BM * kBK * 2;  // one bf16 part of the x tile
  static constexpr int kBTile = BN * kBK * 2;  // one bf16 part of the weight tile
  static constexpr int kSlot = kXParts * kATile + kWParts * kBTile;
  // byte offsets in the dynamic shared memory
  static constexpr int kOffRawX = kSlots * kSlot;
  static constexpr int kOffRawW = kOffRawX + kRaw * kXSlot;
  static constexpr int kRing = kOffRawW + kRaw * kWSlot;
  static constexpr int kOsPitch = BN + 4;  // floats per row of the staged output tile
  static constexpr int kOsBytes = BM * kOsPitch * 4;
  // the FMA fallback: 64 x 64 at a time, the consumers' threads as 16 x
  // (64 / kFTN) threads of 4 x kFTN outputs
  static constexpr int kFTN = 64 * 64 / 4 / kCT;
  static constexpr int kFmaBytes =
      static_cast<int>(sizeof(repro_mm::FmaSmem<64, 64, 16, WT>));
  static constexpr int kReuse =
      ((kRing > kOsBytes + kFmaBytes ? kRing : kOsBytes + kFmaBytes) + 127) / 128 * 128;
  static constexpr int kOffTab = kReuse;         // the 8-bit decode table, then the flagged one
  static constexpr int kOffReg = kReuse + 2048;  // t16's regime table
  // mbarriers: full and empty of the bf16 ring, full and empty of the raw
  // ring (TMA), then the vote
  static constexpr int kOffBar = kOffReg + 16 * repro::kT16Regimes;
  static constexpr int kSmem = kOffBar + 16 * (kSlots + kRaw) + 16;
  // TMA: the bytes of one stage's two boxes (x, the weight bits)
  static constexpr int kTmaBytes = BM * kBK * 4 + BN * kBK * kEB;
  // ... which fit the cp.async layout's padded slots, each 1024-byte aligned
  // (the 128-byte swizzle's period)
  static_assert(kOffRawX % 1024 == 0 && kXSlot % 1024 == 0 && kWSlot % (WT ? 512 : 128) == 0,
                "raw slots aligned for the tensor-map copies");
  static_assert(kOffBar % 8 == 0, "mbarriers are 8-byte aligned");
  static_assert(kSmem <= 232448 / kMinBlocks - 1024, "shared memory per block");
};

// byte offset of element row r, k-chunk kc (8 k) in a K-major tile of
// unswizzled core matrices
__device__ __forceinline__ int core_offset(int r, int kc) {
  return ((r >> 3) * (kBK / 8) + kc) * 128 + (r & 7) * 16;
}

// wgmma's shared-memory matrix descriptor: unswizzled (layout type 0), LBO
// 128 bytes between the core matrices along k, SBO 512 between 8-row groups
__device__ __forceinline__ uint64_t desc(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((kBK / 8 * 128) >> 4) << 32);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive, and expect `bytes` more of asynchronous copies in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// the box of tensor map `map` at coordinates (c0, c1) (innermost first)
// into shared memory at `dst`, completing its bytes on `bar`
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// where byte `off` of a box lands under the copy engine's swizzle: its
// 16-byte chunk index XORed with the bits above the 128-byte row (MASK 7:
// the 128-byte swizzle, 3: 64-byte, 1: 32-byte; the box 1024-byte aligned)
template <int MASK>
__device__ __forceinline__ int swz(int off) {
  return off ^ (((off >> 7) & MASK) << 4);
}

// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// d = a * b + (scale_d ? d : 0): one m64 x BN x k16 bf16 product of the
// warpgroup, A and B from shared memory (K-major descriptors), f32 sums
template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (BN == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  } else {
    static_assert(BN == 64, "m64n64 or m64n128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
}

// the registers a wgmma wrote are not read before its wait (and not moved
// across it): an empty asm that redefines each one
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) asm volatile("" : "+f"(d[r])::"memory");
}

// The three bf16 parts of 8 f32 values (bit patterns u): hi = u with its low
// 16 bits cleared, mid the same of r = u - hi, lo = r - mid (both
// subtractions exact); returns whether some value is not hi + mid + lo
// exactly in bf16 parts: not finite, or its lo off bf16's grid (the plain
// twin: kernels/takum_matmul.py split3_bf16).
__device__ __forceinline__ bool split3_8(const uint32_t (&u)[8], uint4& hi, uint4& mid,
                                         uint4& lo) {
  uint32_t m[8], l[8];
  bool bad = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float r = __uint_as_float(u[j]) - __uint_as_float(u[j] & 0xFFFF0000u);
    m[j] = __float_as_uint(r);
    l[j] = __float_as_uint(r - __uint_as_float(m[j] & 0xFFFF0000u));
    bad |= !repro_mma::finite_bits(u[j]) || (l[j] & 0xFFFFu) != 0u;
  }
  using repro_mma::bf16_pair;
  hi = make_uint4(bf16_pair(u[0], u[1]), bf16_pair(u[2], u[3]), bf16_pair(u[4], u[5]),
                  bf16_pair(u[6], u[7]));
  mid = make_uint4(bf16_pair(m[0], m[1]), bf16_pair(m[2], m[3]), bf16_pair(m[4], m[5]),
                   bf16_pair(m[6], m[7]));
  lo = make_uint4(bf16_pair(l[0], l[1]), bf16_pair(l[2], l[3]), bf16_pair(l[4], l[5]),
                  bf16_pair(l[6], l[7]));
  return bad;
}

__device__ __forceinline__ bool inf_bits(uint32_t u) { return (u & 0x7FFFFFFFu) == 0x7F800000u; }

// A flat 8-bit format under lut decodes through a second staged table
// (matmul_mma.cuh kFlagLut): the value's bf16 truncation, and in bit 0
// whether it is not carried under the x split (inexact, or infinite).
__device__ __forceinline__ uint32_t flagged_bf16(uint32_t u) {
  const bool flag = (repro_mma::finite_bits(u) && (u & 0xFFFFu) != 0u) || inf_bits(u);
  return (u & 0xFFFF0000u) | (flag ? 1u : 0u);
}

// TMA: the raw copies through tensor maps tmx (x) and tmw (the weight
// bits); else per-thread cp.async (the maps unused)
template <int FMT, int IMPL, bool WT, bool FUSED, int BM, bool TMA>
__global__ void __launch_bounds__((Cfg<FMT, WT, BM>::kNT), (Cfg<FMT, WT, BM>::kMinBlocks))
wgmma_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w, void* __restrict__ out,
             int M, int N, int K, int x_vec, const int* __restrict__ tab, repro::Epilogue ep,
             const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw) {
  using C = Cfg<FMT, WT, BM>;
  using T = typename repro::Wire<FMT>::storage;
  constexpr int BN = C::BN, EB = C::kEB;
  static_assert(!(WT && C::kMx), "an mx payload has no transposed load");
  static_assert(!(TMA && C::kMx), "an mx payload's 33-byte groups take cp.async");
  extern __shared__ __align__(128) uint8_t smem[];
  int* tab_s = reinterpret_cast<int*>(smem + C::kOffTab);
  uint32_t* qtab = reinterpret_cast<uint32_t*>(smem + C::kOffTab + 1024);
  uint4* regime_s = reinterpret_cast<uint4*>(smem + C::kOffReg);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kOffBar);
  uint64_t* empty = full + kSlots;
  uint64_t* raw_full = empty + kSlots;
  uint64_t* raw_empty = raw_full + kRaw;
  volatile int* vote = reinterpret_cast<volatile int*>(raw_empty + kRaw);
  const int* dtab = repro::stage_decode_table<FMT, IMPL>(tab, tab_s);
  const uint4* regimes = nullptr;
  if constexpr (repro_mv::kRegimes<FMT, IMPL>) regimes = repro::stage_t16_regimes(regime_s);
  if constexpr (repro_mma::kFlagLut<FMT, IMPL>) {
    for (int i = threadIdx.x; i < 256; i += C::kNT) {
      qtab[i] = flagged_bf16(static_cast<uint32_t>(dtab[i]));
    }
  }
  if (threadIdx.x == 0) {
    for (int d = 0; d < kSlots; ++d) {
      mbar_init(&full[d], C::kPT / 32);  // one arrival per warp
      mbar_init(&empty[d], C::kCT / 32);
    }
    for (int r = 0; r < kRaw; ++r) {
      mbar_init(&raw_full[r], 1);  // producer thread 0's expect_tx
      mbar_init(&raw_empty[r], C::kPT / 32);
    }
    *vote = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nst = (K + kBK - 1) / kBK;

  if (threadIdx.x >= C::kCT) {
    // ---- producers: copy, decode, split ----
    if constexpr (BM == 128) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    }
    const int pt = threadIdx.x - C::kCT;
    // K3: weight row k's span of the block's columns; WT: stored row n's
    // span of the stage's k
    const long long groups = (N + 31) / 32;
    const long long ldw = WT ? static_cast<long long>(K) * EB
                             : (C::kMx ? groups * repro::kMxGroup : static_cast<long long>(N) * EB);
    const long long w_col = WT ? 0
                               : (C::kMx ? static_cast<long long>(n0 / 32) * repro::kMxGroup
                                         : static_cast<long long>(n0) * EB);
    const int w_len = WT ? 0
                         : (C::kMx ? static_cast<int>(min(static_cast<long long>(BN / 32),
                                                          groups - n0 / 32)) * repro::kMxGroup
                                   : min(BN, N - n0) * EB);
    // where a staged line's first byte sits in it: the low four bits of its
    // source (in 32-bit arithmetic: they survive the wrap)
    const uint32_t w_lo = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(w)) +
                          static_cast<uint32_t>(w_col);
    const uint32_t w_ld = static_cast<uint32_t>(ldw);

    auto fetch = [&](int s) {
      if (s < nst) {
        const int k0 = s * kBK;
        uint8_t* xdst = smem + C::kOffRawX + (s % kRaw) * C::kXSlot;
#pragma unroll
        for (int i = 0; i < BM * 8 / C::kPT; ++i) {
          const int q = pt + C::kPT * i, m = q / 8, c = q % 8, gm = m0 + m, gk = k0 + 4 * c;
          uint8_t* d = xdst + m * kXPitch + 16 * c;
          const float* src = x + static_cast<long long>(gm) * K + gk;
          if (x_vec) {
            const bool ok = gm < M && gk < K;
            repro_mma::cp_async16_zfill(d, ok ? src : x, ok ? 16 : 0);
          } else {
            float v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = gm < M && gk + j < K ? src[j] : 0.0f;
            *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
          }
        }
        uint8_t* wdst = smem + C::kOffRawW + (s % kRaw) * C::kWSlot;
#pragma unroll
        for (int i = 0; i < (C::kWLines * C::kWCh + C::kPT - 1) / C::kPT; ++i) {
          const int q = pt + C::kPT * i;
          if (q < C::kWLines * C::kWCh) {
            const int line = q / C::kWCh, c = q % C::kWCh;
            const uint8_t* src;
            int len;
            if constexpr (WT) {
              const int gn = n0 + line;
              src = w + static_cast<long long>(gn) * ldw + static_cast<long long>(k0) * EB;
              len = gn < N ? min(kBK, K - k0) * EB : 0;
            } else {
              const int gk = k0 + line;
              src = w + static_cast<long long>(gk) * ldw + w_col;
              len = gk < K ? w_len : 0;
            }
            repro::stage_chunk(wdst + line * C::kWPitch, src, len, c);
          }
        }
      }
      repro::cp_async_commit();
    };

    // TMA, producer thread 0: stage s into raw slot s % kRaw, once every
    // producer warp has released the slot's last stage, s - kRaw
    auto fetch_tma = [&](int s) {
      if (s >= nst) return;
      const int r = s % kRaw;
      if (s >= kRaw) mbar_wait(&raw_empty[r], ((s / kRaw) & 1) ^ 1);
      mbar_expect_tx(&raw_full[r], C::kTmaBytes);
      tma_2d(smem + C::kOffRawX + r * C::kXSlot, &tmx, s * kBK, m0, &raw_full[r]);
      uint8_t* wdst = smem + C::kOffRawW + r * C::kWSlot;
      if constexpr (WT) {
        tma_2d(wdst, &tmw, s * kBK, n0, &raw_full[r]);
      } else {
        tma_2d(wdst, &tmw, n0, s * kBK, &raw_full[r]);
      }
    };

    // stage s from the raw ring into bf16 slot d; returns whether this
    // thread met a value the parts do not carry exactly
    auto decode = [&](int s, int d) -> bool {
      bool bad = false;
      const int k0 = s * kBK;
      uint8_t* slot = smem + d * C::kSlot;
      const uint8_t* xsrc = smem + C::kOffRawX + (s % kRaw) * C::kXSlot;
#pragma unroll
      for (int p = 0; p < BM * (kBK / 8) / C::kPT; ++p) {
        const int q = pt + C::kPT * p, m = q % BM, kc = q / BM;
        // TMA: dense 128-byte rows under the 128-byte swizzle
        const int x0 = TMA ? swz<7>(m * 128 + kc * 32) : m * kXPitch + kc * 32;
        const int x1 = TMA ? swz<7>(m * 128 + kc * 32 + 16) : m * kXPitch + kc * 32 + 16;
        const uint4 v0 = *reinterpret_cast<const uint4*>(xsrc + x0);
        const uint4 v1 = *reinterpret_cast<const uint4*>(xsrc + x1);
        const uint32_t u[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
        uint4 hi, mid, lo;
        bad |= split3_8(u, hi, mid, lo);
        const int off = core_offset(m, kc);
        *reinterpret_cast<uint4*>(slot + off) = hi;
        *reinterpret_cast<uint4*>(slot + C::kATile + off) = mid;
        *reinterpret_cast<uint4*>(slot + 2 * C::kATile + off) = lo;
      }
      const uint8_t* wsrc = smem + C::kOffRawW + (s % kRaw) * C::kWSlot;
      uint8_t* bdst = slot + kXParts * C::kATile;
#pragma unroll
      for (int p = 0; p < BN * (kBK / 8) / C::kPT; ++p) {
        const int q = pt + C::kPT * p, n = q % BN, kc = q / BN, gn = n0 + n;
        const int gk0 = k0 + kc * 8;
        uint32_t b[8], u[8];
        if constexpr (WT) {
          // 8 consecutive codes of stored row gn, staged as line n (TMA:
          // dense rows of kBK codes under the 32- or 64-byte swizzle)
          const uint32_t lo4 = (static_cast<uint32_t>(reinterpret_cast<uintptr_t>(w)) +
                                static_cast<uint32_t>(gn) * w_ld) & 15u;
          const int off = TMA ? swz<EB == 1 ? 1 : 3>((n * kBK + kc * 8) * EB)
                              : n * C::kWPitch + lo4 + kc * 8 * EB;
          repro_mma::load8_codes<FMT>(wsrc + off, b);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int gk = gk0 + j;
          const bool in = gk < K && gn < N;
          if constexpr (!WT) {
            // element (kk, n) of line kk, the row of k = gk
            // TMA: dense lines of BN codes
            const uint8_t* line =
                TMA ? wsrc + (kc * 8 + j) * (BN * EB)
                    : wsrc + (kc * 8 + j) * C::kWPitch +
                          ((w_lo + static_cast<uint32_t>(gk) * w_ld) & 15u);
            if constexpr (C::kMx) {
              const uint8_t* grp = line + (n / 32) * repro::kMxGroup;
              b[j] = grp[0];  // the group's scale byte, then its element below
              u[j] = in ? __float_as_uint(repro::mx_decode<FMT, IMPL>(
                              dtab, grp[1 + n % 32], repro::e8m0_decode(b[j])))
                        : 0u;
              continue;
            } else if constexpr (EB == 1) {
              b[j] = line[n];
            } else {
              b[j] = reinterpret_cast<const uint16_t*>(line)[n];
            }
          }
          if constexpr (repro_mma::kFlagLut<FMT, IMPL>) {
            u[j] = in ? qtab[b[j]] : 0u;
          } else if constexpr (!C::kMx) {
            u[j] = in ? __float_as_uint(repro_mv::decode_elem<FMT, IMPL>(dtab, regimes, b[j])) : 0u;
          }
        }
        uint4 hi, lo;
        if constexpr (repro_mma::kFlagLut<FMT, IMPL>) {
          uint32_t flag = 0u;
#pragma unroll
          for (int j = 0; j < 8; ++j) flag |= u[j];
          hi = make_uint4(repro_mma::bf16_pair(u[0], u[1]), repro_mma::bf16_pair(u[2], u[3]),
                          repro_mma::bf16_pair(u[4], u[5]), repro_mma::bf16_pair(u[6], u[7]));
          bad |= (flag & 1u) != 0u;
        } else {
          bad |= repro_mma::split8<C::kSplit>(u, hi, lo);
#pragma unroll
          for (int j = 0; j < 8; ++j) bad |= inf_bits(u[j]);
        }
        const int off = core_offset(n, kc);
        *reinterpret_cast<uint4*>(bdst + off) = hi;
        if constexpr (C::kSplit) *reinterpret_cast<uint4*>(bdst + C::kBTile + off) = lo;
      }
      return bad;
    };

    if constexpr (TMA) {
      if (pt == 0) {
        for (int s = 0; s < kRaw - 1; ++s) fetch_tma(s);
      }
    } else {
#pragma unroll
      for (int s = 0; s < kRaw - 1; ++s) fetch(s);
    }
    bool bad = false;
    for (int s = 0; s < nst; ++s) {
      if constexpr (TMA) {
        if (pt == 0) fetch_tma(s + kRaw - 1);
        mbar_wait(&raw_full[s % kRaw], (s / kRaw) & 1);
      } else {
        // stage s landed for every producer, and every producer is done
        // with the raw slot that stage s + kRaw - 1 refills
        repro::cp_async_wait<kRaw - 2>();
        repro_mm::block_sync<kProducerBar, C::kPT>();
        fetch(s + kRaw - 1);
      }
      const int d = s % kSlots;
      mbar_wait(&empty[d], ((s / kSlots) & 1) ^ 1);
      bad = decode(s, d) || bad;
      // the consumers' wgmmas read the slot through the async proxy; then
      // one arrival per warp, after all its lanes' writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (bad) *vote = 1;
      __syncwarp();
      if (pt % 32 == 0) {
        mbar_arrive(&full[d]);
        if constexpr (TMA) mbar_arrive(&raw_empty[s % kRaw]);
      }
    }
    if constexpr (!TMA) repro::cp_async_wait<0>();
  } else {
    // ---- consumers: wgmma over the ready stages, then the flush ----
    if constexpr (BM == 128) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    }
    const int ct = threadIdx.x, wg = ct / 128;
    float run[BN / 2], part[BN / 2];
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) run[r] = part[r] = 0.0f;
    const uint32_t base = smem_u32(smem);
    for (int s = 0; s < nst; ++s) {
      const int d = s % kSlots;
      mbar_wait(&full[d], (s / kSlots) & 1);
      const uint32_t a0 = base + d * C::kSlot + wg * (64 / 8) * (kBK / 8 * 128);
      const uint32_t b0 = base + d * C::kSlot + kXParts * C::kATile;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < C::kPairs; ++i) {
#pragma unroll
        for (int kh = 0; kh < kBK / 16; ++kh) {
          const uint64_t da = desc(a0 + pair_x(C::kSplit, i) * C::kATile + kh * 256);
          const uint64_t db = desc(b0 + pair_w(C::kSplit, i) * C::kBTile + kh * 256);
          wgmma<BN>(part, da, db, i == 0 && kh == 0 ? 0 : 1);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(part);
      __syncwarp();
      if (ct % 32 == 0) mbar_arrive(&empty[d]);
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) run[r] += part[r];
    }
    const bool bad = *vote != 0;
    // every consumer is past its last wgmma: the rings are free
    repro_mm::block_sync<kConsumerBar, C::kCT>();
    float* os = reinterpret_cast<float*>(smem);
    if (bad) {
      // a value the bf16 parts do not carry exactly: the whole tile on the
      // FMA tile, 64 x 64 at a time
      constexpr int TN = C::kFTN;
      auto& fsm = *reinterpret_cast<repro_mm::FmaSmem<64, 64, 16, WT>*>(
          smem + (FUSED ? C::kOsBytes : 0));
      const int tx = ct % (64 / TN), ty = ct / (64 / TN);
      for (int q = 0; q < (BM / 64) * (BN / 64); ++q) {
        const int qm = m0 + 64 * (q / (BN / 64)), qn = n0 + 64 * (q % (BN / 64));
        if (qm >= M || qn >= N) continue;
        float acc[4][TN];
        repro_mm::fma_tile<FMT, IMPL, repro_mm::kXF32, 64, 64, 16, 4, TN, WT, C::kCT,
                           kConsumerBar>(x, reinterpret_cast<const T*>(w), M, N, K, dtab, qm, qn,
                                         fsm, acc);
        if constexpr (FUSED) {
          repro_mm::put_sub_tile(acc, os + (qm - m0) * C::kOsPitch + (qn - n0), C::kOsPitch,
                                 ty * 4, tx * TN, 64, 64);
        } else {
          repro_mm::put_sub_tile(acc, static_cast<float*>(out) + static_cast<long long>(qm) * N + qn,
                                 N, ty * 4, tx * TN, M - qm, N - qn);
        }
      }
      if constexpr (FUSED) {
        repro_mm::block_sync<kConsumerBar, C::kCT>();
        repro::store_encoded_tile_by(ct, C::kCT, os, C::kOsPitch, min(BM, M - m0),
                                     min(BN, N - n0), out, m0, n0, ep);
      }
      return;
    }
    // fragment (j, h) of this thread: row 16 w4 + g + 8 h of its 64, columns
    // 8 j + t2 and + 1 (wgmma's m64nNk16 accumulator layout)
    const int lane = ct % 32, w4 = (ct / 32) % 4, g = lane / 4, t2 = (lane % 4) * 2;
    const int r0 = 64 * wg + 16 * w4 + g;
    if constexpr (FUSED) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<float2*>(os + (r0 + 8 * h) * C::kOsPitch + 8 * j + t2) =
              make_float2(run[4 * j + 2 * h], run[4 * j + 2 * h + 1]);
        }
      repro_mm::block_sync<kConsumerBar, C::kCT>();
      repro::store_encoded_tile_by(ct, C::kCT, os, C::kOsPitch, min(BM, M - m0), min(BN, N - n0),
                                   out, m0, n0, ep);
    } else {
      float* o = static_cast<float*>(out);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gm = m0 + r0 + 8 * h, gn = n0 + 8 * j + t2;
          if (gm >= M) continue;
          float* row = o + static_cast<long long>(gm) * N;
          if (gn < N) row[gn] = run[4 * j + 2 * h];
          if (gn + 1 < N) row[gn + 1] = run[4 * j + 2 * h + 1];
        }
    }
  }
}

// cuTensorMapEncodeTiled from libcuda, found at run time (dlopen: no link
// to libcuda at build time); null where it is missing
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// a 2-D tensor map over a row-major [rows, cols] array of `type`, row
// stride `ld` bytes, box box0 x box1 (innermost first), zeros out of bounds
inline bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, long long cols,
                      long long rows, long long ld, int box0, int box1, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  const cuuint64_t dim[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box0), static_cast<cuuint32_t>(box1)};
  const cuuint32_t step[2] = {1, 1};
  return encode != nullptr &&
         encode(map, type, 2, const_cast<void*>(base), dim, stride, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int FMT, int IMPL, bool WT, bool FUSED, int BM, bool TMA>
int launch_wgmma_as(const float* x, const void* w, void* out, int M, int N, int K, int x_vec,
                    const int* tab, const repro::Epilogue& ep, const CUtensorMap& tmx,
                    const CUtensorMap& tmw, cudaStream_t stream) {
  using C = Cfg<FMT, WT, BM>;
  auto* kernel = wgmma_kernel<FMT, IMPL, WT, FUSED, BM, TMA>;
  // the opt-in above 48 KiB, once per instantiation; a failure is returned
  // on every launch
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid((M + BM - 1) / BM, (N + C::BN - 1) / C::BN);
  kernel<<<grid, C::kNT, C::kSmem, stream>>>(x, static_cast<const uint8_t*>(w), out, M, N, K, x_vec,
                                             tab, ep, tmx, tmw);
  return static_cast<int>(cudaGetLastError());
}

// The TMA instantiation where the rows allow it (the notes above), else the
// cp.async one.  A tensor map that libcuda refuses, or a libcuda without
// cuTensorMapEncodeTiled, returns an error.
template <int FMT, int IMPL, bool WT, bool FUSED, int BM>
int launch_wgmma(const float* x, const void* w, void* out, int M, int N, int K, const int* tab,
                 const repro::Epilogue& ep, cudaStream_t stream) {
  using C = Cfg<FMT, WT, BM>;
  constexpr int EB = C::kEB;
  const int x_vec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15u) == 0u;
  const long long w_row = static_cast<long long>(WT ? K : N) * EB;
  const bool tma = x_vec && (reinterpret_cast<uintptr_t>(w) & 15u) == 0u && w_row % 16 == 0;
  CUtensorMap tmx{}, tmw{};
  if constexpr (!C::kMx) {
    if (tma) {
      const CUtensorMapDataType type =
          EB == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_UINT16;
      const bool ok =
          encode_2d(&tmx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, K, M, static_cast<long long>(K) * 4,
                    kBK, BM, CU_TENSOR_MAP_SWIZZLE_128B) &&
          (WT ? encode_2d(&tmw, type, w, K, N, w_row, kBK, C::BN,
                          EB == 1 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_64B)
              : encode_2d(&tmw, type, w, N, K, w_row, C::BN, kBK, CU_TENSOR_MAP_SWIZZLE_NONE));
      if (!ok) return static_cast<int>(cudaErrorInvalidValue);
      return launch_wgmma_as<FMT, IMPL, WT, FUSED, BM, true>(x, w, out, M, N, K, x_vec, tab, ep,
                                                              tmx, tmw, stream);
    }
  }
  return launch_wgmma_as<FMT, IMPL, WT, FUSED, BM, false>(x, w, out, M, N, K, x_vec, tab, ep, tmx,
                                                           tmw, stream);
}

}  // namespace repro_wg
