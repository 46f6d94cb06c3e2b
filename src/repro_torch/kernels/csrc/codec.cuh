// K0: device codecs shared by every kernel of the port.
//
// Replaces the in-kernel codec bodies of the Pallas kernels:
//   src/repro/kernels/common.py:57  decode_takum_f32
//   src/repro/kernels/common.py:99  encode_takum_from_f32
//   src/repro/core/ofp8.py:40,184   encode_jnp / decode_jnp (field pack/unpack)
//   src/repro/core/formats.py:308   bf16 shift decode / RNE encode
//   src/repro/core/formats.py:345   f32 bitcast decode / encode (an f32 KV cache)
//   src/repro/kernels/lut.py:355    encode_epilogue's mx assembly,
//   src/repro/quant/blockscale.py   the OCP-MX container (E8M0 scale bytes,
//                                   element cap, 33-byte [s, e0..e31] groups), and
//   src/repro/kernels/lut.py:187-335 the table ("lut") codecs: decode_wire_lut,
//                                   _shift_round_rne, encode_takum8_lut,
//                                   encode_ofp8_lut, encode_takum16_lut
// Pure integer work on __float_as_uint / __uint_as_float, so the results do
// not depend on the float mode (the build uses no --use_fast_math: no FTZ).
// The mx helpers flush to zero explicitly, on the exponent field, where the
// reference (XLA's CPU backend, DAZ/FTZ) does.
// The plain PyTorch twins are repro_torch/core/{takum,ofp8,formats}.py and
// repro_torch/kernels/lut.py; the CPU tests hold those against repro bit for
// bit, and chip_smoke.py holds these against those.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

// format ids: repro_torch.core.formats.WireFormat.code.  kF32 (raw IEEE
// bits) is moved by K1, K2 and K6 only (REPRO_WIRE_DISPATCH_F32), never as
// a K3 / K4 weight or a producer's out format.
enum WireCode : int {
  kT8 = 0, kT16 = 1, kE4M3 = 2, kE5M2 = 3, kBF16 = 4, kMXE4M3 = 5, kMXE5M2 = 6, kMXT8 = 7,
  kF32 = 8
};

// ---- takum (linear), n in {8, 16} -------------------------------------------

// c > 127 saturates to f32 max-finite, c < -126 flushes to (signed) zero,
// NaR -> canonical NaN, zero -> +0.
template <int N>
__device__ __forceinline__ float takum_decode(uint32_t bits) {
  constexpr uint32_t kMask = (1u << N) - 1u;
  constexpr uint32_t kNaR = 1u << (N - 1);
  constexpr int kRem = N - 5;
  const uint32_t b = bits & kMask;
  if (b == 0u) return 0.0f;
  if (b == kNaR) return __uint_as_float(0x7FC00000u);
  const uint32_t neg = b >> (N - 1);
  const uint32_t mag = neg ? ((0u - b) & kMask) : b;
  const uint32_t D = (mag >> (N - 2)) & 1u;
  const int R = static_cast<int>((mag >> (N - 5)) & 7u);
  const int r = D ? R : 7 - R;
  const uint32_t rem_v = mag & ((1u << kRem) - 1u);
  const bool have = r <= kRem;
  const uint32_t C = have ? (rem_v >> (kRem - r)) : (rem_v << (r - kRem));
  const int p = have ? kRem - r : 0;
  const uint32_t M = have ? (rem_v & ((1u << p) - 1u)) : 0u;
  const int c = D ? ((1 << r) - 1 + static_cast<int>(C))
                  : (1 - (1 << (r + 1)) + static_cast<int>(C));
  uint32_t out;
  if (c > 127) {
    out = 0x7F7FFFFFu;
  } else if (c < -126) {
    out = 0u;
  } else {
    out = (static_cast<uint32_t>(c + 127) << 23) | (M << (23 - p));
  }
  return __uint_as_float(out | (neg << 31));
}

// t16 through a table of its regime headers (D, R): the same bits as
// takum_decode<16>, for a loop that decodes many elements and keeps the table
// in shared memory.  Entry h = |code| >> 11 holds x = (c + 127 - C) << 23
// (mod 2^32: the characteristic C then lands on the exponent field by the
// same shift that places the fraction) and y = 23 - p = 12 + r, then the
// saturation bound z and the sign mask w, so the decode is the magnitude,
// one table read, a shift, an add, an unsigned min, a flush-to-zero multiply
// and the sign: about half the integer work of takum_decode<16>, and no
// per-element special case.  body < 2^23 only where c < -126 (D = 0,
// r = 6, C = 0), and header 0 (D = 0, r = 7: c < -126 always) is entry
// (0, 0), whose body rem_v < 2^11 is flushed too; body > max-finite only
// where c > 127 (D = 1, r = 7).  Entry 16 is NaR's (|code| = 0x8000): body 0, and a "sign mask"
// that takes the canonical NaN's bits from the code's sign-extended bits
// (no float operation sees a NaN, so no payload is changed).
constexpr int kT16Regimes = 17;

__host__ __device__ inline uint4 t16_regime(uint32_t h) {
  const uint32_t D = (h >> 3) & 1u, R = h & 7u;
  const uint32_t r = D ? R : 7u - R;
  const uint32_t t = 1u << r;
  if (h >= 16u) return uint4{0u, 0u, 0u, 0x7FC00000u};  // NaR: the code's bits give the NaN
  if (h == 0u) return uint4{0u, 0u, 0x7F7FFFFFu, 0x80000000u};
  return uint4{(D ? t + 126u : 128u - 2u * t) << 23, 12u + r, 0x7F7FFFFFu, 0x80000000u};
}

// every thread of the block calls it; ends in __syncthreads
__device__ __forceinline__ const uint4* stage_t16_regimes(uint4* smem) {
  for (int h = threadIdx.x; h < kT16Regimes; h += blockDim.x) smem[h] = t16_regime(h);
  __syncthreads();
  return smem;
}

// f32 bits u with a subnormal flushed to (signed) zero
__device__ __forceinline__ uint32_t ftz_bits(uint32_t u) {
#ifdef __CUDA_ARCH__
  float f;
  asm("mul.ftz.f32 %0, %1, 0f3F800000;" : "=f"(f) : "f"(__uint_as_float(u)));
  return __float_as_uint(f);
#else
  return (u & 0x7F800000u) == 0u ? (u & 0x80000000u) : u;
#endif
}

__device__ __forceinline__ float t16_decode_regime(const uint4* regimes, uint32_t bits) {
  const int code = static_cast<int16_t>(bits & 0xFFFFu);
  const uint32_t mag = static_cast<uint32_t>(abs(code));  // 0x8000 for NaR
  const uint4 e = regimes[mag >> 11];
  const uint32_t body = min(e.x + ((mag & 0x7FFu) << e.y), e.z);
  return __uint_as_float(ftz_bits(body) | (static_cast<uint32_t>(code) & e.w));
}

// RNE on the left-aligned header|fraction body with guard and sticky bits,
// DAZ (|x| < 2^-126 -> 0), saturation to [1, 2^(N-1) - 1], NaN/Inf -> NaR.
template <int N>
__device__ __forceinline__ uint32_t takum_encode(float x) {
  constexpr uint32_t kMask = (1u << N) - 1u;
  const uint32_t u = __float_as_uint(x);
  const uint32_t a = u & 0x7FFFFFFFu;
  if (a < 0x00800000u) return 0u;
  if (a >= 0x7F800000u) return 1u << (N - 1);
  const int c = static_cast<int>(a >> 23) - 127;  // f32 never saturates takum
  const uint32_t m23 = a & 0x7FFFFFu;
  const bool cneg = c < 0;
  const uint32_t g = static_cast<uint32_t>(cneg ? -c : c + 1);  // in [1, 128]
  const int r = 31 - __clz(g);                                   // regime 0..7
  const uint32_t C = static_cast<uint32_t>(cneg ? c + (1 << (r + 1)) - 1 : c - ((1 << r) - 1));
  const uint32_t R = static_cast<uint32_t>(cneg ? 7 - r : r);
  const uint32_t D = cneg ? 0u : 1u;
  const uint32_t H = (D << (r + 3)) | (R << r) | C;  // 4 + r bits
  const uint64_t body = (static_cast<uint64_t>(H) << 23) | m23;
  const int t = 28 + r - N;  // discarded bits: >= 12 for N <= 16
  uint64_t kept = body >> t;
  const uint64_t guard = (body >> (t - 1)) & 1u;
  const bool sticky = (body & ((1ull << (t - 1)) - 1ull)) != 0ull;
  kept += (guard && (sticky || (kept & 1u))) ? 1u : 0u;
  uint32_t mag = static_cast<uint32_t>(kept);
  mag = mag < 1u ? 1u : mag;
  mag = mag > (kMask >> 1) ? (kMask >> 1) : mag;
  return (u >> 31) ? ((0u - mag) & kMask) : mag;
}

// ---- OFP8: E4M3 (bias 7, NaN only) and E5M2 (bias 15, Inf + NaN) ------------

template <int EB, int MB, int BIAS, bool HAS_INF>
__device__ __forceinline__ float ofp8_decode(uint32_t bits) {
  const uint32_t b = bits & 0xFFu;
  const uint32_t sign = b >> 7;
  const uint32_t e = (b >> MB) & ((1u << EB) - 1u);
  const uint32_t m = b & ((1u << MB) - 1u);
  float val;
  if (HAS_INF ? (e == (1u << EB) - 1u) : ((b & 0x7Fu) == 0x7Fu)) {
    val = (HAS_INF && m == 0u) ? __uint_as_float(0x7F800000u) : __uint_as_float(0x7FC00000u);
  } else if (e == 0u) {
    // m * 2^(1 - BIAS - MB): exact in f32
    val = static_cast<float>(m) * __uint_as_float(static_cast<uint32_t>(127 + 1 - BIAS - MB) << 23);
  } else {
    val = __uint_as_float((static_cast<uint32_t>(static_cast<int>(e) - BIAS + 127) << 23) |
                          (m << (23 - MB)));
  }
  return sign ? -val : val;
}

// RNE, non-saturating: finite overflow -> NaN (E4M3) or Inf (E5M2); f32
// subnormal inputs flush to signed zero.
template <int EB, int MB, int BIAS, bool HAS_INF>
__device__ __forceinline__ uint32_t ofp8_encode(float x) {
  constexpr uint32_t kMaxMag = HAS_INF ? 0x7Bu : 0x7Eu;
  constexpr uint32_t kNaNMag = 0x7Fu;
  constexpr uint32_t kInfMag = HAS_INF ? 0x7Cu : kNaNMag;
  const uint32_t u = __float_as_uint(x);
  const uint32_t sign = u >> 31;
  const uint32_t a = u & 0x7FFFFFFFu;
  uint32_t mag;
  if (a > 0x7F800000u) {
    mag = kNaNMag;
  } else if (a == 0x7F800000u) {
    mag = kInfMag;
  } else if (a < 0x00800000u) {
    mag = 0u;  // zero and f32 subnormals
  } else {
    const int e_t = static_cast<int>(a >> 23) - 127 + BIAS;
    const uint32_t m23 = a & 0x7FFFFFu;
    int extra = 1 - e_t;
    extra = extra < 0 ? 0 : (extra > 24 ? 24 : extra);
    const int t = (23 - MB) + extra;
    const uint32_t src = extra > 0 ? (m23 | (1u << 23)) : m23;
    const int tc = t < 1 ? 1 : (t > 31 ? 31 : t);
    uint32_t kept = src >> tc;
    const uint32_t guard = (src >> (tc - 1)) & 1u;
    const bool sticky = (src & ((1u << (tc - 1)) - 1u)) != 0u;
    kept += (guard && (sticky || (kept & 1u))) ? 1u : 0u;
    const int e_sub = extra > 0 ? 0 : e_t;
    mag = (static_cast<uint32_t>(e_sub < 0 ? 0 : e_sub) << MB) + kept;
    if (mag > kMaxMag) mag = kInfMag;
  }
  return (sign << 7) | mag;
}

// ---- bf16 --------------------------------------------------------------------

__device__ __forceinline__ float bf16_decode(uint32_t bits) {
  return __uint_as_float((bits & 0xFFFFu) << 16);
}

// RNE on the bits (subnormals kept); NaN -> sign | 0x7FC0.
__device__ __forceinline__ uint32_t bf16_encode(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return ((u >> 16) & 0x8000u) | 0x7FC0u;
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}

// ---- f32 ---------------------------------------------------------------------
//
// The reference stores an f32 cache as the values themselves
// (bitcast_convert_type both ways): no DAZ, subnormals, signed zeros and
// NaN payloads kept, unlike every other encode here.  No float operation
// touches the value, so no payload or subnormal changes on the way.

__device__ __forceinline__ float f32_decode(uint32_t bits) { return __uint_as_float(bits); }
__device__ __forceinline__ uint32_t f32_encode(float x) { return __float_as_uint(x); }

// ---- format traits -------------------------------------------------------------

template <int FMT>
struct Wire;

template <>
struct Wire<kT8> {
  using storage = uint8_t;
  static __device__ __forceinline__ float decode(uint32_t b) { return takum_decode<8>(b); }
  static __device__ __forceinline__ uint32_t encode(float x) { return takum_encode<8>(x); }
};

template <>
struct Wire<kT16> {
  using storage = uint16_t;
  static __device__ __forceinline__ float decode(uint32_t b) { return takum_decode<16>(b); }
  static __device__ __forceinline__ uint32_t encode(float x) { return takum_encode<16>(x); }
};

template <>
struct Wire<kE4M3> {
  using storage = uint8_t;
  static __device__ __forceinline__ float decode(uint32_t b) { return ofp8_decode<4, 3, 7, false>(b); }
  static __device__ __forceinline__ uint32_t encode(float x) { return ofp8_encode<4, 3, 7, false>(x); }
};

template <>
struct Wire<kE5M2> {
  using storage = uint8_t;
  static __device__ __forceinline__ float decode(uint32_t b) { return ofp8_decode<5, 2, 15, true>(b); }
  static __device__ __forceinline__ uint32_t encode(float x) { return ofp8_encode<5, 2, 15, true>(x); }
};

template <>
struct Wire<kBF16> {
  using storage = uint16_t;
  static __device__ __forceinline__ float decode(uint32_t b) { return bf16_decode(b); }
  static __device__ __forceinline__ uint32_t encode(float x) { return bf16_encode(x); }
};

template <>
struct Wire<kF32> {
  using storage = uint32_t;
  static __device__ __forceinline__ float decode(uint32_t b) { return f32_decode(b); }
  static __device__ __forceinline__ uint32_t encode(float x) { return f32_encode(x); }
};

// ---- OCP-MX block-scaled containers: mxe4m3, mxe5m2, mxt8 ----------------------
//
// A payload row is groups of kMxGroup bytes [s, e0..e31]: one E8M0 scale
// byte, then the 32 element bytes of its block.  Groups are 33 bytes, so
// element bytes are not word aligned: they are read one byte at a time.

constexpr int kMxBlock = 32;
constexpr int kMxGroup = 33;
constexpr uint32_t kE8M0NaN = 255u;

template <int FMT>
inline constexpr bool kIsMx = FMT == kMXE4M3 || FMT == kMXE5M2 || FMT == kMXT8;

// byte offsets, within a payload row, of element j's scale and of element j
__device__ __forceinline__ long long mx_scale_at(long long j) { return (j >> 5) * kMxGroup; }
__device__ __forceinline__ long long mx_elem_at(long long j) {
  return (j >> 5) * kMxGroup + 1 + (j & 31);
}

// E8M0 byte -> f32 scale 2^(b - 127); 255 -> NaN; 0 clamps to 2^-126
__device__ __forceinline__ float e8m0_decode(uint32_t byte) {
  if (byte == kE8M0NaN) return __uint_as_float(0x7FC00000u);
  return __uint_as_float((byte < 1u ? 1u : byte) << 23);
}

// Scale byte from the bits of a block's absmax (|x| bits, max-reduced as
// uint32: NaN > Inf > every finite value): the biased f32 exponent minus
// the element's emax, clipped to [1, 254]; 127 for a zero or subnormal
// absmax (the all-zero block); 255 for Inf or NaN (the NaN block).
__device__ __forceinline__ uint32_t mx_scale_byte(uint32_t amax_bits, int elem_emax) {
  const int e = static_cast<int>((amax_bits >> 23) & 0xFFu);
  if (e == 0) return 127u;
  if (e == 255) return kE8M0NaN;
  const int b = e - elem_emax;
  return static_cast<uint32_t>(b < 1 ? 1 : (b > 254 ? 254 : b));
}

// x * 2^k exactly, on the exponent field: a subnormal x, or an exact result
// below 2^-126, gives signed zero (DAZ in, FTZ out, tininess before
// rounding: what XLA's CPU backend gives for the reference's two-step pow2
// multiply).  Inf/NaN pass through (their block is a NaN block).
__device__ __forceinline__ float mul_pow2_ftz(float x, int k) {
  const uint32_t u = __float_as_uint(x);
  const int e = static_cast<int>((u >> 23) & 0xFFu);
  if (e == 255) return x;
  if (e == 0 || e + k <= 0) return __uint_as_float(u & 0x80000000u);
  if (e + k >= 255) return __uint_as_float((u & 0x80000000u) | 0x7F800000u);
  return __uint_as_float(u + (static_cast<uint32_t>(k) << 23));
}

// v * s in f32 with the product flushed to signed zero below 2^-126.  An
// element carries at most 4 significant bits, so a product that is not
// tiny is exact and one that is tiny cannot round up to 2^-126.
__device__ __forceinline__ float mul_ftz(float v, float s) {
  const uint32_t p = __float_as_uint(v * s);
  return __uint_as_float((p & 0x7F800000u) == 0u ? (p & 0x80000000u) : p);
}

template <>
struct Wire<kMXE4M3> {
  using storage = uint8_t;
  static constexpr int kEmax = 8;
  static __device__ __forceinline__ float cap() { return 448.0f; }
};

template <>
struct Wire<kMXE5M2> {
  using storage = uint8_t;
  static constexpr int kEmax = 15;
  static __device__ __forceinline__ float cap() { return 57344.0f; }
};

template <>
struct Wire<kMXT8> {
  using storage = uint8_t;
  static constexpr int kEmax = 0;
  static __device__ __forceinline__ float cap() { return 1.875f; }  // t8's top below 2
};

// ---- table codecs (the "lut" impl) ----------------------------------------------
//
// The tables come from repro_torch/core/tables.py as int32 arrays of uint32
// bit patterns and are read as such: a decode table holds the f32 bits of
// every code (reinterpreted with __int_as_float, so NaN payloads survive);
// an 8-bit encode pair (meta, thr) and the takum16 pair (meta, sub) are
// indexed by the f32 exponent byte (sub by the takum regime).

enum Impl : int { kBits = 0, kLut = 1 };  // repro_torch.kernels.common.IMPL_CODE

constexpr uint32_t kEnc8ThrFlag = 1u << 7;  // tables.ENC8_THR_FLAG

// the element format of FMT (an mx container's, else FMT itself), its width,
// and whether it has decode tables (every format of at most 16 bits) and
// encode tables (those but bf16)
template <int FMT>
inline constexpr int kElem = FMT == kMXE4M3 ? kE4M3 : FMT == kMXE5M2 ? kE5M2 : FMT == kMXT8 ? kT8 : FMT;
template <int FMT>
inline constexpr int kElemBits =
    kElem<FMT> == kF32 ? 32 : (kElem<FMT> == kT16 || kElem<FMT> == kBF16) ? 16 : 8;
template <int FMT>
inline constexpr bool kHasDecodeLut = kElemBits<FMT> <= 16;
template <int FMT>
inline constexpr bool kHasEncodeLut = kElem<FMT> != kBF16 && kElem<FMT> != kF32;

// Ints of shared memory a kernel of FMT under IMPL stages its decode table
// in: an 8-bit table (1 KiB) is copied per block; a 16-bit one (256 KiB,
// more than a block may hold) is read from global memory, where it stays
// L2-resident.  1, not 0, so the array declaration stays legal.
template <int FMT, int IMPL>
inline constexpr int kDecodeTabInts = (IMPL == kLut && kElemBits<FMT> == 8) ? 256 : 1;

// The table the decode of FMT under IMPL reads: for an 8-bit lut table,
// `smem` after every thread of the block has copied its share (ends in
// __syncthreads, so every thread must call it); else `tab` itself.
template <int FMT, int IMPL>
__device__ __forceinline__ const int* stage_decode_table(const int* __restrict__ tab, int* smem) {
  if constexpr (kDecodeTabInts<FMT, IMPL> == 256) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) smem[i] = tab[i];
    __syncthreads();
    return smem;
  } else {
    return tab;
  }
}

// one code through the decode table (lut.py decode_wire_lut)
template <int NBITS>
__device__ __forceinline__ float lut_decode(const int* tab, uint32_t b) {
  if constexpr (NBITS == 8) {
    return __int_as_float(tab[b & 0xFFu]);
  } else {
    return __int_as_float(__ldg(tab + (b & 0xFFFFu)));
  }
}

// one element of FMT (an mx container: of its element format) decoded by IMPL
template <int FMT, int IMPL>
__device__ __forceinline__ float elem_decode(const int* tab, uint32_t b) {
  if constexpr (IMPL == kLut) {
    return lut_decode<kElemBits<FMT>>(tab, b);
  } else {
    return Wire<kElem<FMT>>::decode(b);
  }
}

// one element of an mx block decoded by IMPL under its block's scale
template <int FMT, int IMPL>
__device__ __forceinline__ float mx_decode(const int* tab, uint32_t elem_bits, float scale) {
  return mul_ftz(elem_decode<FMT, IMPL>(tab, elem_bits), scale);
}

// base + RNE(m23 >> s) with ties to the even *code* (lut.py _shift_round_rne):
// takum codes and OFP8 magnitude codes are consecutive integers in value
// order, so a carry out of the mantissa lands on the next binade's bottom.
// s in [1, 23].
__device__ __forceinline__ uint32_t shift_round_rne(uint32_t base, uint32_t s, uint32_t m23) {
  const uint32_t kept = m23 >> s;
  const uint32_t guard = (m23 >> (s - 1u)) & 1u;
  const uint32_t below = m23 & ((1u << (s - 1u)) - 1u);
  const bool up = guard && (below != 0u || ((base + kept) & 1u));
  return base + kept + (up ? 1u : 0u);
}

// the 8-bit tail (lut.py _round_shift_or_threshold): finite |x| bits -> the
// magnitude code, by the threshold path or the shift path of its binade
__device__ __forceinline__ uint32_t encode8_lut_mag(uint32_t a, const uint32_t* meta, const int* thr) {
  const uint32_t e = a >> 23;
  const uint32_t m23 = a & 0x7FFFFFu;
  const uint32_t mt = meta[e];
  if (mt & kEnc8ThrFlag) return (mt >> 8) + (static_cast<int>(m23) > thr[e] ? 1u : 0u);
  return shift_round_rne(mt >> 8, mt & 0x7Fu, m23);
}

// f32 -> 8-bit code by table (lut.py encode_takum8_lut, encode_ofp8_lut).
// Takum8: NaR for Inf/NaN, two's-complement negatives, DAZ from the e = 0
// row.  OFP8: sign-magnitude; rounding past the top finite code is capped
// at the overflow pattern (E4M3 NaN, E5M2 Inf), Inf -> that pattern, NaN ->
// 0x7F.  Bit-identical to Wire<E>::encode.
template <int E>
__device__ __forceinline__ uint32_t encode8_lut(float x, const uint32_t* meta, const int* thr) {
  const uint32_t u = __float_as_uint(x);
  const uint32_t a = u & 0x7FFFFFFFu;
  if constexpr (E == kT8) {
    if (a >= 0x7F800000u) return 0x80u;
    const uint32_t mag = encode8_lut_mag(a, meta, thr);
    return (u >> 31) ? ((0u - mag) & 0xFFu) : mag;
  } else {
    static_assert(E == kE4M3 || E == kE5M2, "8-bit table encode: t8, e4m3, e5m2");
    constexpr uint32_t kOvf = E == kE4M3 ? 0x7Fu : 0x7Cu;  // tables.ofp8_overflow_code
    uint32_t mag;
    if (a > 0x7F800000u) {
      mag = 0x7Fu;
    } else if (a == 0x7F800000u) {
      mag = kOvf;
    } else {
      mag = encode8_lut_mag(a, meta, thr);
      mag = mag < kOvf ? mag : kOvf;
    }
    return ((u >> 31) << 7) | mag;
  }
}

// f32 -> takum16 by the two-level tables (lut.py encode_takum16_lut): meta
// gives (base << 8) | regime, sub the regime's mantissa shift; DAZ and NaR
// explicit, no saturation needed (|c| <= 128 after a carry)
__device__ __forceinline__ uint32_t encode16_lut(float x, const uint32_t* meta, const int* sub) {
  const uint32_t u = __float_as_uint(x);
  const uint32_t a = u & 0x7FFFFFFFu;
  if (a >= 0x7F800000u) return 0x8000u;
  if (a < 0x00800000u) return 0u;
  const uint32_t mt = meta[a >> 23];
  const uint32_t mag = shift_round_rne(mt >> 8, static_cast<uint32_t>(sub[mt & 0xFFu]), a & 0x7FFFFFu);
  return (u >> 31) ? ((0u - mag) & 0xFFFFu) : mag;
}

// one element of FMT (an mx container: of its element format) encoded by
// IMPL; `aux` is thr (8-bit) or sub (takum16)
template <int FMT, int IMPL>
__device__ __forceinline__ uint32_t elem_encode(float x, const uint32_t* meta, const int* aux) {
  constexpr int E = kElem<FMT>;
  if constexpr (IMPL == kLut) {
    if constexpr (E == kT16) {
      return encode16_lut(x, meta, aux);
    } else {
      return encode8_lut<E>(x, meta, aux);
    }
  } else {
    return Wire<E>::encode(x);
  }
}

// Ints of shared memory for the encode tables of FMT under IMPL: meta, and
// thr (256) or sub (128, takum16); 1 when bits reads none
template <int FMT, int IMPL>
inline constexpr int kEncodeTabInts = IMPL == kLut ? 256 : 1;
template <int FMT, int IMPL>
inline constexpr int kEncodeAuxInts = IMPL != kLut ? 1 : (kElem<FMT> == kT16 ? 128 : 256);

// Copy the encode tables into the block's shared arrays (lut; every thread
// must call it, it ends in __syncthreads); bits copies nothing.
template <int FMT, int IMPL>
__device__ __forceinline__ void stage_encode_tables(const uint32_t* __restrict__ meta,
                                                    const int* __restrict__ aux, uint32_t* meta_s,
                                                    int* aux_s) {
  if constexpr (IMPL == kLut) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) meta_s[i] = meta[i];
    for (int i = threadIdx.x; i < kEncodeAuxInts<FMT, IMPL>; i += blockDim.x) aux_s[i] = aux[i];
    __syncthreads();
  }
}

// one element of an mx block under scale byte `byte`: multiplied by
// 2^(127 - byte), clamped to the element cap (NaN stays NaN, -0 stays -0),
// encoded RNE by IMPL (after the clamp, so the non-saturating OFP8 table
// encode is exact here); a NaN block stores element bits 0
template <int FMT, int IMPL>
__device__ __forceinline__ uint32_t mx_encode(float x, uint32_t byte, const uint32_t* meta,
                                              const int* aux) {
  if (byte == kE8M0NaN) return 0u;
  float xs = mul_pow2_ftz(x, 127 - static_cast<int>(byte));
  const float cap = Wire<FMT>::cap();
  xs = xs > cap ? cap : (xs < -cap ? -cap : xs);
  return elem_encode<FMT, IMPL>(xs, meta, aux);
}

// ---- staging byte spans in shared memory (K3's small-M loop, K6) -----------------
//
// A span [p, p + len) of global bytes is staged as the aligned 16-byte chunks
// that cover it, each one cp.async (asynchronous, cached in L2 only); its
// first byte then sits at span_offset(p) in the staged copy.  A whole aligned
// chunk that holds one byte of the span never leaves that byte's page, so
// every alignment of p (a ragged N, an mx row of 33-byte groups) takes the
// same 16-byte path.

// chunks a staged span of len bytes may need, at its worst alignment
__host__ __device__ constexpr int span_chunks(int len) { return (len + 30) / 16; }

__device__ __forceinline__ int span_offset(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15u);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Chunk c of the span [p, p + len) into dst + 16 c (dst: 16-byte aligned
// shared memory), if the span reaches chunk c
__device__ __forceinline__ void stage_chunk(uint8_t* dst, const void* p, int len, int c) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t chunk = (a & ~static_cast<uintptr_t>(15)) + 16u * static_cast<uintptr_t>(c);
  if (len > 0 && chunk < a + static_cast<uintptr_t>(len)) {
    cp_async16(dst + 16 * c, reinterpret_cast<const void*>(chunk));
  }
}

// ---- the fused out_fmt epilogue of K3, K4 and K6 (lut.py:355 encode_epilogue) ----
//
// A producer that was asked for packed output stages its finished f32 tile
// in shared memory and hands it to store_encoded_tile, which encodes
// exactly those values, the ones the unfused launch writes, as K2 would:
// element by element through elem_encode for a flat format; for an mx
// format one warp per 32-element group, its E8M0 byte from the group's
// absmax (__reduce_max_sync over the |x| bits, as K2-mx), lane 0 writing
// the scale byte and lane i element byte 1 + i.  A group spans the
// registers of several threads (8 in the FMA tile, 4 in the tensor-core
// tile's 32 x 32 warp tiles, 32 in the matvec's combine pass), which is
// why the tile goes through shared memory first.
//
// The out format and its codec are runtime values: store_encoded_tile_by is
// compiled once per translation unit (__noinline__) and switches on them
// once per tile, so a producer has one fused instantiation per kernel
// instantiation, not one per out format and codec.  The encode tables are
// read from global memory, where L1 keeps them.

constexpr int kOutF32 = -1;  // Epilogue::code of an unfused launch: f32 output

struct Epilogue {
  int code;            // out format (WireCode), or kOutF32
  int impl;            // its encode codec (Impl)
  const uint32_t* meta;  // lut: the encode pair, else null
  const int* aux;
  long long ldo;       // output row stride: elements, or payload bytes for mx
};

// Whether a launch may run with `ep`: a known out format, and its tables
// when the codec is lut (bf16 has none).
inline bool epilogue_ok(const Epilogue& ep) {
  if (ep.code == kOutF32) return true;
  if (ep.code < kT8 || ep.code > kMXT8) return false;
  if (ep.impl == kBits) return true;
  return ep.impl == kLut && ep.code != kBF16 && ep.meta != nullptr && ep.aux != nullptr;
}

template <int OUT, int OIMPL>
__device__ __forceinline__ void encode_tile_as(int tid, int nt, const float* t, int ldt, int rows,
                                               int cols, void* out, long long row0, long long col0,
                                               const Epilogue& ep) {
  if constexpr (kIsMx<OUT>) {
    uint8_t* o = static_cast<uint8_t*>(out);
    const int lane = tid & 31;
    const int per_row = cols / kMxBlock;  // cols is whole groups
    for (int grp = tid / 32; grp < rows * per_row; grp += nt / 32) {
      const int r = grp / per_row, c = (grp % per_row) * kMxBlock;
      const float x = t[r * ldt + c + lane];
      const uint32_t amax = __reduce_max_sync(0xFFFFFFFFu, __float_as_uint(x) & 0x7FFFFFFFu);
      const uint32_t byte = mx_scale_byte(amax, Wire<OUT>::kEmax);
      uint8_t* g = o + (row0 + r) * ep.ldo + mx_scale_at(col0 + c);
      if (lane == 0) g[0] = static_cast<uint8_t>(byte);
      g[1 + lane] = static_cast<uint8_t>(mx_encode<OUT, OIMPL>(x, byte, ep.meta, ep.aux));
    }
  } else {
    using T = typename Wire<OUT>::storage;
    T* o = static_cast<T*>(out);
    for (int i = tid; i < rows * cols; i += nt) {
      const int r = i / cols, c = i % cols;
      o[(row0 + r) * ep.ldo + col0 + c] =
          static_cast<T>(elem_encode<OUT, OIMPL>(t[r * ldt + c], ep.meta, ep.aux));
    }
  }
}

// the tile through out format F's codec ep.impl (lut only where F has tables)
template <int F>
__device__ __forceinline__ int encode_tile_fmt(int tid, int nt, const float* t, int ldt, int rows,
                                               int cols, void* out, long long row0,
                                               long long col0, const Epilogue& ep) {
  if constexpr (kHasEncodeLut<F>) {
    if (ep.impl == kLut) {
      encode_tile_as<F, kLut>(tid, nt, t, ldt, rows, cols, out, row0, col0, ep);
      return 0;
    }
  }
  encode_tile_as<F, kBits>(tid, nt, t, ldt, rows, cols, out, row0, col0, ep);
  return 0;
}

}  // namespace repro

// Calls LAUNCH<FMT, IMPL>(args...) for a runtime codec id `impl`: unknown
// ids, and lut where FMT has no tables (HAS_LUT false), return
// cudaErrorInvalidValue from the enclosing launcher.
#define REPRO_IMPL_DISPATCH(impl, HAS_LUT, LAUNCH, FMT, ...)                              \
  if ((impl) == repro::kBits) return LAUNCH<FMT, repro::kBits>(__VA_ARGS__);               \
  if constexpr (HAS_LUT) {                                                                 \
    if ((impl) == repro::kLut) return LAUNCH<FMT, repro::kLut>(__VA_ARGS__);                \
  }                                                                                        \
  return static_cast<int>(cudaErrorInvalidValue);

// Calls LAUNCH<FMT>(args...) for a runtime format id; unknown ids return
// cudaErrorInvalidValue from the enclosing C entry.
#define REPRO_WIRE_DISPATCH(code, LAUNCH, ...)                        \
  switch (code) {                                                     \
    case repro::kT8: return LAUNCH<repro::kT8>(__VA_ARGS__);          \
    case repro::kT16: return LAUNCH<repro::kT16>(__VA_ARGS__);        \
    case repro::kE4M3: return LAUNCH<repro::kE4M3>(__VA_ARGS__);      \
    case repro::kE5M2: return LAUNCH<repro::kE5M2>(__VA_ARGS__);      \
    case repro::kBF16: return LAUNCH<repro::kBF16>(__VA_ARGS__);      \
    case repro::kMXE4M3: return LAUNCH<repro::kMXE4M3>(__VA_ARGS__);  \
    case repro::kMXE5M2: return LAUNCH<repro::kMXE5M2>(__VA_ARGS__);  \
    case repro::kMXT8: return LAUNCH<repro::kMXT8>(__VA_ARGS__);      \
    default: return static_cast<int>(cudaErrorInvalidValue);          \
  }

// REPRO_WIRE_DISPATCH, and kF32 as well: the entries of the kernels that
// move f32 bits (K1, K2, K6)
#define REPRO_WIRE_DISPATCH_F32(code, LAUNCH, ...)                                  \
  if ((code) == repro::kF32) return LAUNCH<repro::kF32>(__VA_ARGS__);               \
  REPRO_WIRE_DISPATCH(code, LAUNCH, __VA_ARGS__)

namespace repro {

// Encode the rows x cols tile `t` (row stride ldt floats) into rows row0..
// and columns col0.. of the packed output `out`, shared out among threads
// 0 .. nt - 1 (tid: the caller's index among them; nt a multiple of 32),
// which call this after a barrier that made `t` visible.  For an mx format
// col0 and cols are whole 32-element groups.  Returns nonzero only for an
// out format that epilogue_ok refuses before any launch.
inline __device__ __noinline__ int store_encoded_tile_by(int tid, int nt, const float* t, int ldt,
                                                         int rows, int cols, void* out,
                                                         long long row0, long long col0,
                                                         const Epilogue& ep) {
  REPRO_WIRE_DISPATCH(ep.code, encode_tile_fmt, tid, nt, t, ldt, rows, cols, out, row0, col0, ep)
}

// store_encoded_tile_by over every thread of the block
__device__ __forceinline__ int store_encoded_tile(const float* t, int ldt, int rows, int cols,
                                                  void* out, long long row0, long long col0,
                                                  const Epilogue& ep) {
  return store_encoded_tile_by(static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x), t,
                               ldt, rows, cols, out, row0, col0, ep);
}

}  // namespace repro
