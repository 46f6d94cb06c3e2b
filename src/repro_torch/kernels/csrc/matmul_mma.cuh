// The tensor-core tile of K3 (bf16 x, M > 16) and K4 (M > 16, every format
// but t16): out[M, N] = X[M, K] @ decode(w_bits[K, N]) on Hopper's bf16
// tensor cores, f32 accumulation; and launch_loop, the one dispatch of K3,
// K4 and K3's transposed launch over their loops (the split-K matvec, the
// FMA tile, this tile, the f32-x tile of matmul_wgmma.cuh), as
// kernels/takum_matmul.py tile_for names them.
//
// Replaces, above M = 16, the Pallas kernel src/repro/kernels/takum_matmul.py:56
// _mm_kernel (dual=False: entry takum_matmul :166 with bf16 x; dual=True:
// entry takum_dual_matmul :227), its mx branch (:61-80, :111-132), both
// codecs and its out_fmt epilogue (:96-106).
//
// Bound on the H100: at the prefill's M = 1024 the products, 2 M N K
// operations at 989 TFLOP/s bf16 (wi, 4096 x 14336: 0.122 ms), twice that
// for t16 (two products per weight, 0.243 ms); the weight bytes read once
// are 0.0175 (t8) and 0.035 ms (t16).  The FMA tile it replaces reached
// 20 TFLOP/s.  What the design does about the bound:
//
// - Exactness first.  A product of two bf16 values is exact in f32, so the
//   tensor cores give K3's function wherever the decoded operands are exact
//   in bf16: every decoded t8, e4m3, e5m2, bf16 and mx value but one, f32's
//   largest finite magnitude, to which the saturating t8 / t16 codes
//   (characteristic > 127, which no encode of an f32 produces) decode.  A
//   t16 value w carries up to 12 significant bits: it is split into
//   hi = w with its low 16 bits cleared (truncation: never rounds up to
//   inf) and lo = w - hi (exact, at most 4 significant bits, never
//   subnormal: tests/test_torch_tiles.py holds all 65536 codes), and both
//   are multiplied by x into one accumulator (loop kMmaSplit: two MMAs per
//   fragment).  x * lo where x = +-inf and lo = 0 would give a NaN that
//   x * w does not, so under the split an infinite x is not carried either.
//   The decode votes, per stage and block (__syncthreads_or), whether it met
//   a value the parts do not carry exactly (a weight or K4 x element whose
//   bf16 parts do not sum to it; under the split, an infinite x); a block
//   that did recomputes its whole tile on the FMA tile (fma_tile of
//   matmul_tile.cuh) before its flush.  So every output is x @ decode(w)
//   with exact products; only the order of the sums differs.
// - Order.  The tensor cores' f32 accumulation truncates: summed straight
//   through K = 4096, all-positive t16 inputs read 4.0e-5 of |x| @ |w|
//   against the f64 sum, ten times K3's limit (tools/tile_variants.py,
//   variant direct, on chip_smoke.py's all-positive rows, on an H100).  So
//   each stage's kBK = 32 k terms go through two (t16: four) MMAs into a
//   fresh partial, the first from a zero accumulator, which is then added
//   to the running f32 sum with one IEEE add (the same inputs then read
//   1.0e-6).  The order depends on the
//   shape and plan alone, never on the codec or on the data outside the
//   fallback vote, and there are no atomics: lut == bits and run == run,
//   bit for bit.
// - mma.sync.m16n8k16 (bf16 in, f32 accumulators) over ldmatrix fragments,
//   warp tiles of 32 x 32 (32 x 16 at 64 x 64), so that a thread's partial
//   and running sums take 32 registers each and 128 registers do: 128 x 128
//   blocks of 16 warps, one per SM, or 64 x 64 blocks of 8 warps, two per
//   SM, where 128 x 128 leaves fewer blocks than SMs (kernels/takum_matmul.py
//   mma_plan).  With 64 + 64 registers of sums (64 x 32 warp tiles, 8
//   warps, one block per SM) the loop ran slower: too few warps to hide
//   the decode and the barrier.
// - A kStages-deep cp.async ring of raw bits, 16-byte chunks, each thread
//   copying fixed slots whose sources move on a stage at a time: the bf16 x
//   tile (K3: copied into its ldmatrix layout, zero-filled past M and K; an
//   x that is not 16-byte aligned along K is staged by plain loads), the
//   weight bits' rows (each row's BN-column span as the aligned chunks that
//   cover it, codec.cuh stage_chunk: any alignment, ragged N and mx rows of
//   33-byte groups alike), K4's x bits the same way.  While stages s + 2
//   and s + 3 are in flight, the block runs the MMAs of stage s and decodes
//   stage s + 1 into the other of two bf16 B tiles (K4: also its A tile),
//   [k][n] with rows padded by 16 bytes so that ldmatrix.trans reads
//   without bank conflicts; one block barrier per stage.  Decode goes
//   through elem_decode<FMT, IMPL> / mx_decode and the staged 8-bit table
//   (a flat 8-bit format under lut: a second staged table of bf16 values
//   with the vote's flag in bit 0), t16 under bits through its regime table
//   (codec.cuh t16_decode_regime).
// - What bounds it (tools/tile_variants.py, one H100): not the tensor cores
//   (with every MMA replaced by one integer op, t8 lut at M = 1024 on wi
//   still takes 91 % of its time) and not the copies' latency (a ring of 8
//   stages gains nothing); the work around the MMAs: decode (the flagged
//   table alone saves 14 %), staging, ldmatrix and one barrier a stage.
// - Edges: a k past K decodes as 0 on both operands (the weight whatever
//   its staged bytes, x zero-filled), so a NaN in padding never meets a 0;
//   M and N lanes outside the output are never stored.
// - Epilogue: the unfused flush stores the f32 fragments; the FUSED twin
//   stages the tile in shared memory (over the ring) and calls
//   repro::store_encoded_tile, so its output is K2's encode of the unfused
//   launch's.
#pragma once

#include "matvec_splitk.cuh"

namespace repro_mma {

constexpr int kBK = 32;       // k per stage, and per partial sum
constexpr int kStages = 4;    // depth of the raw-bits ring
constexpr int kXCh = kBK / 8;  // 16-byte chunks per row of an A tile
constexpr int kAPitch = (kBK + 8) * 2;  // bytes per row of an A tile: padded by 16 bytes

// the loop a launch runs: kernels/takum_matmul.py LOOPS
enum Loop : int { kMatvec = 0, kFma = 1, kMma = 2, kMmaSplit = 3, kMmaF32 = 4 };

template <int FMT, int XMODE, int BM, int BN>
struct Cfg {
  static constexpr bool kMx = repro::kIsMx<FMT>;
  static constexpr int kEB = repro::kElemBits<FMT> / 8;
  static constexpr bool kSplit = FMT == repro::kT16;
  static constexpr bool kWire = XMODE == repro_mm::kXWire;
  // 128 x 128: 16 warps of 32 x 32 outputs, one block per SM; 64 x 64: 8
  // warps of 32 x 16, two blocks per SM.  Either way a thread holds at most
  // 16 partial and 16 running sums, so 128 registers do.
  static constexpr int kNT = BM * BN >= 128 * 128 ? 512 : 256;  // threads
  static constexpr int kMinBlocks = kNT == 512 ? 1 : 2;
  static constexpr int kWarpsM = BM / 32, kWarpsN = kNT / 32 / kWarpsM;
  static constexpr int kWM = BM / kWarpsM, kWN = BN / kWarpsN;  // warp tile
  static constexpr int kMF = kWM / 16, kNF = kWN / 8;           // m16 and n8 fragments
  // the FMA fallback's tile: (FBM / 4) x (FBN / 4) threads of 4 x 4
  static constexpr int kFBM = kNT == 512 ? 128 : 64, kFBN = 64;
  // a staged weight row: the block's BN columns (mx: BN / 32 groups)
  static constexpr int kWSpan = kMx ? BN / 32 * repro::kMxGroup : BN * kEB;
  static constexpr int kWPitch = 16 * repro::span_chunks(kWSpan);
  static constexpr int kWSlot = kBK * kWPitch;
  // K3: the bf16 A tile itself; K4: a row's 32 k of x bits (mx: one group)
  static constexpr int kXSpan = kMx ? kBK / 32 * repro::kMxGroup : kBK * kEB;
  static constexpr int kXPitch = kWire ? 16 * repro::span_chunks(kXSpan) : kAPitch;
  static constexpr int kXSlot = BM * kXPitch;
  static constexpr int kASlot = BM * kAPitch;
  static constexpr int kBPitch = (BN + 8) * 2;
  static constexpr int kBSlot = kBK * kBPitch;
  static constexpr int kParts = kSplit ? 2 : 1;
  // byte offsets in the dynamic shared memory
  static constexpr int kOffW = kStages * kXSlot;
  static constexpr int kOffA = kOffW + kStages * kWSlot;  // K4: two decoded A tiles
  static constexpr int kOffB = kOffA + (kWire ? 2 * kASlot : 0);
  static constexpr int kRing = kOffB + 2 * kParts * kBSlot;
  static constexpr int kOsPitch = BN + 4;  // floats per row of the staged output tile
  static constexpr int kOsBytes = BM * kOsPitch * 4;
  static constexpr int kFmaBytes =
      static_cast<int>(sizeof(repro_mm::FmaSmem<kFBM, kFBN, 16, false>));
  static constexpr int kReuse =
      (kRing > kOsBytes + kFmaBytes ? kRing : kOsBytes + kFmaBytes + 15) / 16 * 16;
  static constexpr int kSmem = kReuse + 2048 + 16 * repro::kT16Regimes;  // + tables
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b: the first product of a partial, from a zero accumulator
__device__ __forceinline__ void mma_bf16_first(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

// 16 bytes from gmem, or (src_bytes 0) 16 zero bytes
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

// the high halves (bf16 truncations) of two f32 bit patterns, a in the low half
__device__ __forceinline__ uint32_t bf16_pair(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

__device__ __forceinline__ bool finite_bits(uint32_t u) {
  return (u & 0x7F800000u) != 0x7F800000u;
}

// the codes of 8 consecutive elements of a flat FMT row at p (any alignment
// of an element)
template <int FMT>
__device__ __forceinline__ void load8_codes(const uint8_t* p, uint32_t (&b)[8]) {
  const uint32_t a = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p));
  if constexpr (repro::kElemBits<FMT> == 8) {
    if ((a & 7u) == 0u) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = (v.x >> (8 * j)) & 0xFFu;
        b[4 + j] = (v.y >> (8 * j)) & 0xFFu;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = p[j];
    }
  } else {
    if ((a & 15u) == 0u) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[2 * j] = wd[j] & 0xFFFFu;
        b[2 * j + 1] = wd[j] >> 16;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = reinterpret_cast<const uint16_t*>(p)[j];
    }
  }
}

// 8 consecutive elements of a flat FMT row at p, decoded to f32 bits
template <int FMT, int IMPL>
__device__ __forceinline__ void decode8_flat(const uint8_t* p, const int* dtab,
                                             const uint4* regimes, uint32_t (&u)[8]) {
  uint32_t b[8];
  load8_codes<FMT>(p, b);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    u[j] = __float_as_uint(repro_mv::decode_elem<FMT, IMPL>(dtab, regimes, b[j]));
  }
}

// A flat 8-bit format under lut decodes through a second staged table whose
// entries hold the value's bf16 truncation in the high half and, in bit 0,
// whether that truncation is inexact: one table read, an OR and half a byte
// permute per element.
template <int FMT, int IMPL>
inline constexpr bool kFlagLut =
    IMPL == repro::kLut && !repro::kIsMx<FMT> && repro::kElemBits<FMT> == 8;

__device__ __forceinline__ uint32_t flagged_bf16(uint32_t u) {
  return (u & 0xFFFF0000u) | (finite_bits(u) && (u & 0xFFFFu) != 0u ? 1u : 0u);
}

// elements e .. e + 7 of the mx group at grp ([s, e0..e31]), decoded
template <int FMT, int IMPL>
__device__ __forceinline__ void decode8_mx(const uint8_t* grp, int e, const int* dtab,
                                           uint32_t (&u)[8]) {
  const float s = repro::e8m0_decode(grp[0]);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    u[j] = __float_as_uint(repro::mx_decode<FMT, IMPL>(dtab, grp[1 + e + j], s));
  }
}

// The bf16 parts of 8 decoded values: hi (truncation) and, with SPLIT (t16),
// lo = w - hi; returns whether a finite value is not their exact sum (NaN
// stays NaN, inf stays inf).
template <bool SPLIT>
__device__ __forceinline__ bool split8(const uint32_t (&u)[8], uint4& hi, uint4& lo) {
  bool bad = false;
  uint32_t l[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if constexpr (SPLIT) {
      // t16: lo = w - hi is exact in bf16 for every value but f32's largest
      // finite magnitude (tests/test_torch_tiles.py, all 65536 codes); a
      // NaN w gives a NaN lo beside its NaN hi, which changes no product
      l[j] = __float_as_uint(__uint_as_float(u[j]) - __uint_as_float(u[j] & 0xFFFF0000u));
      bad |= (u[j] & 0x7FFFFFFFu) == 0x7F7FFFFFu;
    } else {
      bad |= finite_bits(u[j]) && (u[j] & 0xFFFFu) != 0u;
    }
  }
  hi = make_uint4(bf16_pair(u[0], u[1]), bf16_pair(u[2], u[3]), bf16_pair(u[4], u[5]),
                  bf16_pair(u[6], u[7]));
  if constexpr (SPLIT) {
    lo = make_uint4(bf16_pair(l[0], l[1]), bf16_pair(l[2], l[3]), bf16_pair(l[4], l[5]),
                    bf16_pair(l[6], l[7]));
  }
  return bad;
}

// either half of a bf16 pair +-inf
__device__ __forceinline__ bool has_inf_bf16(uint32_t v) {
  return (v & 0x7FFFu) == 0x7F80u || (v & 0x7FFF0000u) == 0x7F800000u;
}

template <int FMT, int IMPL, int XMODE, bool FUSED, int BM, int BN>
__global__ void __launch_bounds__((Cfg<FMT, XMODE, BM, BN>::kNT),
                                  (Cfg<FMT, XMODE, BM, BN>::kMinBlocks))
mma_kernel(const void* __restrict__ x, const uint8_t* __restrict__ w, void* __restrict__ out,
           int M, int N, int K, int x_vec, const int* __restrict__ tab, repro::Epilogue ep) {
  using C = Cfg<FMT, XMODE, BM, BN>;
  using T = typename repro::Wire<FMT>::storage;
  constexpr int EB = C::kEB;
  static_assert(XMODE == repro_mm::kXBF16 || (C::kWire && !C::kSplit), "no tensor-core tile");
  constexpr int kThreads = C::kNT;
  extern __shared__ __align__(16) uint8_t smem[];
  int* tab_s = reinterpret_cast<int*>(smem + C::kReuse);
  uint32_t* qtab = reinterpret_cast<uint32_t*>(smem + C::kReuse + 1024);
  uint4* regime_s = reinterpret_cast<uint4*>(smem + C::kReuse + 2048);
  const int* dtab = repro::stage_decode_table<FMT, IMPL>(tab, tab_s);
  const uint4* regimes = nullptr;
  if constexpr (repro_mv::kRegimes<FMT, IMPL>) regimes = repro::stage_t16_regimes(regime_s);
  if constexpr (kFlagLut<FMT, IMPL>) {  // read after the prologue's barrier
    for (int i = threadIdx.x; i < 256; i += kThreads) {
      qtab[i] = flagged_bf16(static_cast<uint32_t>(dtab[i]));
    }
  }

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / C::kWarpsN, wn = warp % C::kWarpsN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nst = (K + kBK - 1) / kBK;
  const long long groups = (N + 31) / 32;
  const long long ldw =
      C::kMx ? groups * repro::kMxGroup : static_cast<long long>(N) * EB;  // bytes per row
  const long long w_col = C::kMx ? static_cast<long long>(n0 / 32) * repro::kMxGroup
                                 : static_cast<long long>(n0) * EB;
  const int w_len = C::kMx ? static_cast<int>(min(static_cast<long long>(BN / 32),
                                                  groups - n0 / 32)) * repro::kMxGroup
                           : min(BN, N - n0) * EB;
  // where row k's span starts in its staged line: (lo + k * ld) & 15 in
  // 32-bit arithmetic (the low four bits survive the wrap)
  const uint32_t w_lo = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(w)) +
                        static_cast<uint32_t>(w_col);
  const uint32_t w_ld = static_cast<uint32_t>(ldw);
  // K4: x bits [M, K] (mx: the payload [M, K / 32 * 33]), bytes per row
  const long long ldx = C::kMx ? static_cast<long long>(K / 32) * repro::kMxGroup
                               : static_cast<long long>(K) * EB;
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  const uint16_t* xh = static_cast<const uint16_t*>(x);

  // Each thread's copy slots are fixed: (row, chunk) of the weight's lines
  // and of the x tile, found once; their sources move on by one stage a
  // fetch (fetch is called for s = 0, 1, 2, ... in order).
  constexpr int kWCh = C::kWPitch / 16, kWSlots = (kBK * kWCh + kThreads - 1) / kThreads;
  constexpr int kXSCh = C::kWire ? C::kXPitch / 16 : kXCh;  // copy slots per x row
  constexpr int kXSlots = (BM * kXSCh + kThreads - 1) / kThreads;
  const uint8_t* w_src[kWSlots];
  int w_dst[kWSlots], w_row[kWSlots];
#pragma unroll
  for (int i = 0; i < kWSlots; ++i) {
    const int slot = tid + kThreads * i, kk = min(slot / kWCh, kBK - 1);
    w_row[i] = slot < kBK * kWCh ? kk : K;  // K: no slot (never copies)
    w_src[i] = w + kk * ldw + w_col;
    w_dst[i] = kk * C::kWPitch;
  }
  const uint8_t* x_src[kXSlots];
  int x_dst[kXSlots], x_col[kXSlots];
  bool x_row_ok[kXSlots];
#pragma unroll
  for (int i = 0; i < kXSlots; ++i) {
    const int slot = tid + kThreads * i, m = min(slot / kXSCh, BM - 1), gm = m0 + m;
    x_row_ok[i] = slot < BM * kXSCh && gm < M;
    x_col[i] = slot % kXSCh;
    x_dst[i] = m * C::kXPitch + (C::kWire ? 0 : 16 * x_col[i]);
    x_src[i] = C::kWire ? xb + gm * ldx : reinterpret_cast<const uint8_t*>(
                                              xh + static_cast<long long>(gm) * K + 8 * x_col[i]);
  }
  const long long w_step = kBK * ldw;
  const long long x_step = C::kWire ? C::kXSpan : kBK * 2;

  auto fetch = [&](int s) {
    if (s < nst) {
      const int k0 = s * kBK;
      uint8_t* wdst = smem + C::kOffW + (s % kStages) * C::kWSlot;
#pragma unroll
      for (int i = 0; i < kWSlots; ++i) {
        const int c = (tid + kThreads * i) % kWCh;
        repro::stage_chunk(wdst + w_dst[i], w_src[i], k0 + w_row[i] < K ? w_len : 0, c);
        w_src[i] += w_step;
      }
      uint8_t* xdst = smem + (s % kStages) * C::kXSlot;
      if constexpr (C::kWire) {
        const int len = C::kMx ? C::kXSpan : min(kBK, K - k0) * EB;
#pragma unroll
        for (int i = 0; i < kXSlots; ++i) {
          repro::stage_chunk(xdst + x_dst[i], x_src[i], x_row_ok[i] ? len : 0, x_col[i]);
          x_src[i] += x_step;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kXSlots; ++i) {
          uint8_t* d = xdst + x_dst[i];
          const int gk = k0 + 8 * x_col[i];
          const bool ok = x_row_ok[i] && gk < K;
          if (x_vec) {
            cp_async16_zfill(d, ok ? x_src[i] : xb, ok ? 16 : 0);
          } else {
            const uint16_t* p = reinterpret_cast<const uint16_t*>(x_src[i]);
            uint32_t h[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) h[j] = (x_row_ok[i] && gk + j < K) ? p[j] : 0u;
            *reinterpret_cast<uint4*>(d) =
                make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16,
                           h[6] | h[7] << 16);
          }
          x_src[i] += x_step;
        }
      }
    }
    repro::cp_async_commit();
  };

  // decode stage s into the B tiles of parity s % 2 (K4: and its A tile);
  // returns whether this thread met a value the parts do not carry exactly
  auto decode = [&](int s) -> bool {
    bool bad = false;
    const int k0 = s * kBK;
    const uint8_t* wsrc = smem + C::kOffW + (s % kStages) * C::kWSlot;
    uint8_t* bdst = smem + C::kOffB + (s % 2) * C::kParts * C::kBSlot;
#pragma unroll
    for (int p = 0; p < kBK * BN / 8 / kThreads; ++p) {
      const int q = tid + kThreads * p;
      const int kk = q / (BN / 8), c = (q % (BN / 8)) * 8;
      const int gk = k0 + kk;
      uint32_t u[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      const bool in = gk < K && n0 + c < N;
      const uint8_t* line =
          wsrc + kk * C::kWPitch + ((w_lo + static_cast<uint32_t>(gk) * w_ld) & 15u);
      uint4 hi, lo;
      if constexpr (kFlagLut<FMT, IMPL>) {
        uint32_t b[8], flag = 0u;
        if (in) load8_codes<FMT>(line + c, b);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          u[j] = in && n0 + c + j < N ? qtab[b[j]] : 0u;
          flag |= u[j];
        }
        hi = make_uint4(bf16_pair(u[0], u[1]), bf16_pair(u[2], u[3]), bf16_pair(u[4], u[5]),
                        bf16_pair(u[6], u[7]));
        bad |= (flag & 1u) != 0u;
      } else {
        if (in) {
          if constexpr (C::kMx) {
            decode8_mx<FMT, IMPL>(line + (c / 32) * repro::kMxGroup, c % 32, dtab, u);
          } else {
            decode8_flat<FMT, IMPL>(line + c * EB, dtab, regimes, u);
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (n0 + c + j >= N) u[j] = 0u;
          }
        }
        bad |= split8<C::kSplit>(u, hi, lo);
      }
      *reinterpret_cast<uint4*>(bdst + kk * C::kBPitch + c * 2) = hi;
      if constexpr (C::kSplit) {
        *reinterpret_cast<uint4*>(bdst + C::kBSlot + kk * C::kBPitch + c * 2) = lo;
      }
    }
    const uint8_t* xsrc = smem + (s % kStages) * C::kXSlot;
    if constexpr (C::kWire) {
      uint8_t* adst = smem + C::kOffA + (s % 2) * C::kASlot;
      const long long xcol = C::kMx ? static_cast<long long>(k0 / 32) * repro::kMxGroup
                                    : static_cast<long long>(k0) * EB;
#pragma unroll
      for (int p = 0; p < BM * kXCh / kThreads; ++p) {
        const int q = tid + kThreads * p;
        const int m = q / kXCh, c = (q % kXCh) * 8, gm = m0 + m;
        uint32_t u[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
        if (gm < M && k0 + c < K) {
          const uint8_t* line =
              xsrc + m * C::kXPitch + repro::span_offset(xb + gm * ldx + xcol);
          if constexpr (C::kMx) {
            decode8_mx<FMT, IMPL>(line + (c / 32) * repro::kMxGroup, c % 32, dtab, u);
          } else {
            decode8_flat<FMT, IMPL>(line + c * EB, dtab, regimes, u);
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (k0 + c + j >= K) u[j] = 0u;
          }
        }
        uint4 hi, lo;
        bad |= split8<false>(u, hi, lo);
        *reinterpret_cast<uint4*>(adst + m * kAPitch + c * 2) = hi;
      }
    } else if constexpr (C::kSplit) {
      // x * lo with x = +-inf and lo = 0 would be a NaN that x * w is not
#pragma unroll
      for (int p = 0; p < BM * kXCh / kThreads; ++p) {
        const int q = tid + kThreads * p;
        const uint4 v =
            *reinterpret_cast<const uint4*>(xsrc + (q / kXCh) * kAPitch + (q % kXCh) * 16);
        bad |= has_inf_bf16(v.x) || has_inf_bf16(v.y) || has_inf_bf16(v.z) || has_inf_bf16(v.w);
      }
    }
    return bad;
  };

  float run[C::kMF][C::kNF][4];
#pragma unroll
  for (int i = 0; i < C::kMF; ++i)
#pragma unroll
    for (int j = 0; j < C::kNF; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) run[i][j][r] = 0.0f;

  // the MMAs of stage s into a fresh partial, then one IEEE add into run
  auto mma_stage = [&](int s) {
    const uint8_t* abase = C::kWire ? smem + C::kOffA + (s % 2) * C::kASlot
                                    : smem + (s % kStages) * C::kXSlot;
    const uint8_t* bbase = smem + C::kOffB + (s % 2) * C::kParts * C::kBSlot;
    float part[C::kMF][C::kNF][4];
#pragma unroll
    for (int kh = 0; kh < kBK / 16; ++kh) {
      uint32_t a[C::kMF][4];
#pragma unroll
      for (int i = 0; i < C::kMF; ++i) {
        ldsm_x4(a[i], abase + (wm * C::kWM + i * 16 + (lane & 15)) * kAPitch +
                          (kh * 16 + (lane >> 4) * 8) * 2);
      }
#pragma unroll
      for (int part_i = 0; part_i < C::kParts; ++part_i) {
        uint32_t b[C::kNF][2];
#pragma unroll
        for (int j = 0; j < C::kNF / 2; ++j) {
          uint32_t r[4];
          ldsm_x4_t(r, bbase + part_i * C::kBSlot +
                           (kh * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * C::kBPitch +
                           (wn * C::kWN + j * 16 + (lane >> 4) * 8) * 2);
          b[2 * j][0] = r[0];
          b[2 * j][1] = r[1];
          b[2 * j + 1][0] = r[2];
          b[2 * j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < C::kMF; ++i)
#pragma unroll
          for (int j = 0; j < C::kNF; ++j) {
            if (kh == 0 && part_i == 0) {
              mma_bf16_first(part[i][j], a[i], b[j][0], b[j][1]);
            } else {
              mma_bf16(part[i][j], a[i], b[j][0], b[j][1]);
            }
          }
      }
    }
#pragma unroll
    for (int i = 0; i < C::kMF; ++i)
#pragma unroll
      for (int j = 0; j < C::kNF; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) run[i][j][r] += part[i][j][r];
  };

  // stages 0 .. kStages - 2 in flight; wait for 0 and 1, decode 0
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);
  repro::cp_async_wait<kStages - 3>();
  __syncthreads();
  bool bad = nst > 0 ? decode(0) : false;
  bad = __syncthreads_or(bad) != 0;
  // iteration s: stage s + 3 is fetched into the slot stage s - 1 left,
  // the MMAs of stage s run, stage s + 1 (landed and made visible by the
  // last barrier) is decoded into the other B tile; then wait for stage
  // s + 2 and one barrier, which also votes on the fallback
  for (int s = 0; s < nst; ++s) {
    fetch(s + kStages - 1);
    mma_stage(s);
    const bool b = s + 1 < nst ? decode(s + 1) : false;
    repro::cp_async_wait<kStages - 3>();
    bad = (__syncthreads_or(b) != 0) || bad;
  }
  repro::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the flush

  float* os = reinterpret_cast<float*>(smem);
  if (bad) {
    // a value the bf16 parts do not carry exactly: the whole tile on the
    // FMA tile, 64 x 64 at a time
    constexpr int FBM = C::kFBM, FBN = C::kFBN;
    auto& fsm = *reinterpret_cast<repro_mm::FmaSmem<FBM, FBN, 16, false>*>(
        smem + (FUSED ? C::kOsBytes : 0));
    const int tx = tid % (FBN / 4), ty = tid / (FBN / 4);
    for (int q = 0; q < (BM / FBM) * (BN / FBN); ++q) {
      const int qm = m0 + FBM * (q / (BN / FBN)), qn = n0 + FBN * (q % (BN / FBN));
      if (qm >= M || qn >= N) continue;
      float acc[4][4];
      repro_mm::fma_tile<FMT, IMPL, XMODE, FBM, FBN, 16, 4, 4, false, kThreads>(
          x, reinterpret_cast<const T*>(w), M, N, K, dtab, qm, qn, fsm, acc);
      if constexpr (FUSED) {
        repro_mm::put_sub_tile(acc, os + (qm - m0) * C::kOsPitch + (qn - n0), C::kOsPitch,
                               ty * 4, tx * 4, FBM, FBN);
      } else {
        repro_mm::put_sub_tile(acc, static_cast<float*>(out) + static_cast<long long>(qm) * N + qn,
                               N, ty * 4, tx * 4, M - qm, N - qn);
      }
    }
    if constexpr (FUSED) {
      __syncthreads();
      repro::store_encoded_tile(os, C::kOsPitch, min(BM, M - m0), min(BN, N - n0), out, m0, n0,
                                ep);
    }
    return;
  }
  const int g = lane / 4, t2 = (lane % 4) * 2;
  if constexpr (FUSED) {
#pragma unroll
    for (int i = 0; i < C::kMF; ++i)
#pragma unroll
      for (int j = 0; j < C::kNF; ++j) {
        const int r = wm * C::kWM + i * 16 + g, c = wn * C::kWN + j * 8 + t2;
        *reinterpret_cast<float2*>(os + r * C::kOsPitch + c) = make_float2(run[i][j][0], run[i][j][1]);
        *reinterpret_cast<float2*>(os + (r + 8) * C::kOsPitch + c) =
            make_float2(run[i][j][2], run[i][j][3]);
      }
    __syncthreads();
    repro::store_encoded_tile(os, C::kOsPitch, min(BM, M - m0), min(BN, N - n0), out, m0, n0, ep);
  } else {
    float* o = static_cast<float*>(out);
#pragma unroll
    for (int i = 0; i < C::kMF; ++i)
#pragma unroll
      for (int j = 0; j < C::kNF; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gm = m0 + wm * C::kWM + i * 16 + g + 8 * h;
          const int gn = n0 + wn * C::kWN + j * 8 + t2;
          if (gm >= M) continue;
          float* row = o + static_cast<long long>(gm) * N;
          if (gn < N) row[gn] = run[i][j][2 * h];
          if (gn + 1 < N) row[gn + 1] = run[i][j][2 * h + 1];
        }
  }
}

// Whether FMT and XMODE have a tensor-core tile: K3 with bf16 x, every
// format (t16 through the split); K4 over every format but t16.
template <int FMT, int XMODE, bool WT>
inline constexpr bool kHasMma =
    !WT && (XMODE == repro_mm::kXBF16 || (XMODE == repro_mm::kXWire && FMT != repro::kT16));
// Whether they have the FMA tile as a loop of its own: K4 over t16
// (unfused and fused), and K3 with f32 x unfused only, whose loop is the
// wgmma tile: the FMA loop stays launchable beside it as the reference its
// fallback blocks are held against (tests/test_torch_gpu.py).
template <int FMT, int XMODE, bool WT>
inline constexpr bool kHasFma =
    !WT && (XMODE == repro_mm::kXF32 || (XMODE == repro_mm::kXWire && FMT == repro::kT16));

}  // namespace repro_mma

namespace repro_wg {
// the f32-x tile's launch (matmul_wgmma.cuh, which the sources that launch
// it include: takum_matmul.cu, takum_matmul_wt.cu)
template <int FMT, int IMPL, bool WT, bool FUSED, int BM>
int launch_wgmma(const float* x, const void* w, void* out, int M, int N, int K, const int* tab,
                 const repro::Epilogue& ep, cudaStream_t stream);
}  // namespace repro_wg

namespace repro_mma {

template <int FMT, int IMPL, int XMODE, bool FUSED, int BM, int BN>
int launch_mma(const void* x, const void* w, void* out, int M, int N, int K, const int* tab,
               const repro::Epilogue& ep, cudaStream_t stream) {
  using C = Cfg<FMT, XMODE, BM, BN>;
  auto* kernel = mma_kernel<FMT, IMPL, XMODE, FUSED, BM, BN>;
  // the opt-in above 48 KiB, once per instantiation; a failure is returned
  // on every launch
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int x_vec = XMODE == repro_mm::kXBF16 && K % 8 == 0 &&
                    (reinterpret_cast<uintptr_t>(x) & 15u) == 0u;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, C::kNT, C::kSmem, stream>>>(x, static_cast<const uint8_t*>(w), out, M, N, K,
                                               x_vec, tab, ep);
  return static_cast<int>(cudaGetLastError());
}

// One launch of K3 (XMODE kXF32 / kXBF16), K4 (kXWire) or K3's transposed
// launch (WT) on the loop `loop` that the wrapper chose (tile_for), with
// `tile` the tensor-core tiles' block rows (mma_plan: 128 or 64); unfused
// or fused as ep asks.  A loop that FMT and XMODE do not have, a tile that
// does not exist, an M outside the loop's range or a refused shared-memory
// opt-in returns an error: nothing falls back to another loop.
template <int FMT, int IMPL, int XMODE, bool WT = false>
int launch_loop(int loop, int tile, const void* x, const void* w, void* out, float* ws, int M,
                int N, int K, int chunk, const void* tab, const repro::Epilogue& ep,
                cudaStream_t stream) {
  const int* t = static_cast<const int*>(tab);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (IMPL == repro::kLut && t == nullptr) return bad;
  if (!repro::epilogue_ok(ep) || (WT && ep.code != repro::kOutF32)) return bad;
  // mx out: whole 32-element groups, which no tile or combine block splits
  if (ep.code >= repro::kMXE4M3 && N % repro::kMxBlock) return bad;
  const bool fused = ep.code != repro::kOutF32;
  if (loop == kMatvec) {
    if (M > repro_mv::kMaxM) return bad;
    return repro_mv::launch_matvec<FMT, IMPL, XMODE, WT>(x, w, out, ws, M, N, K, chunk, t, ep,
                                                         stream);
  }
  if (M <= repro_mv::kMaxM) return bad;
  if (loop == kFma) {
    if constexpr (kHasFma<FMT, XMODE, WT>) {
      if (!fused) {
        return repro_mm::launch_tiled<FMT, IMPL, XMODE, false>(x, w, out, M, N, K, t, ep, stream);
      }
      if constexpr (XMODE == repro_mm::kXWire) {
        return repro_mm::launch_tiled<FMT, IMPL, XMODE, true>(x, w, out, M, N, K, t, ep, stream);
      }
    }
    return bad;
  }
  if (loop == kMmaF32) {
    if constexpr (XMODE == repro_mm::kXF32) {
      const float* xf = static_cast<const float*>(x);
      if constexpr (WT) {
        if (tile == 128) return repro_wg::launch_wgmma<FMT, IMPL, true, false, 128>(
            xf, w, out, M, N, K, t, ep, stream);
        if (tile == 64) return repro_wg::launch_wgmma<FMT, IMPL, true, false, 64>(
            xf, w, out, M, N, K, t, ep, stream);
      } else {
        if (tile == 128) {
          return fused ? repro_wg::launch_wgmma<FMT, IMPL, false, true, 128>(xf, w, out, M, N, K,
                                                                            t, ep, stream)
                       : repro_wg::launch_wgmma<FMT, IMPL, false, false, 128>(xf, w, out, M, N, K,
                                                                             t, ep, stream);
        }
        if (tile == 64) {
          return fused ? repro_wg::launch_wgmma<FMT, IMPL, false, true, 64>(xf, w, out, M, N, K, t,
                                                                           ep, stream)
                       : repro_wg::launch_wgmma<FMT, IMPL, false, false, 64>(xf, w, out, M, N, K,
                                                                            t, ep, stream);
        }
      }
    }
    return bad;
  }
  if constexpr (kHasMma<FMT, XMODE, WT>) {
    if (loop != (FMT == repro::kT16 ? kMmaSplit : kMma)) return bad;
    if (tile == 128) {
      return fused ? launch_mma<FMT, IMPL, XMODE, true, 128, 128>(x, w, out, M, N, K, t, ep, stream)
                   : launch_mma<FMT, IMPL, XMODE, false, 128, 128>(x, w, out, M, N, K, t, ep,
                                                                   stream);
    }
    if (tile == 64) {
      return fused ? launch_mma<FMT, IMPL, XMODE, true, 64, 64>(x, w, out, M, N, K, t, ep, stream)
                   : launch_mma<FMT, IMPL, XMODE, false, 64, 64>(x, w, out, M, N, K, t, ep,
                                                                 stream);
    }
  }
  return bad;
}

}  // namespace repro_mma
