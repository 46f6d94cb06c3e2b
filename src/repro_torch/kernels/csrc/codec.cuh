// K0: device codecs shared by every kernel of the port.
//
// Replaces the in-kernel codec bodies of the Pallas kernels:
//   src/repro/kernels/common.py:57  decode_takum_f32
//   src/repro/kernels/common.py:99  encode_takum_from_f32
//   src/repro/core/ofp8.py:40,184   encode_jnp / decode_jnp (field pack/unpack)
//   src/repro/core/formats.py:308   bf16 shift decode / RNE encode
//   src/repro/kernels/lut.py:355    encode_epilogue's mx assembly, and
//   src/repro/quant/blockscale.py   the OCP-MX container (E8M0 scale bytes,
//                                   element cap, 33-byte [s, e0..e31] groups)
// Pure integer work on __float_as_uint / __uint_as_float, so the results do
// not depend on the float mode (the build uses no --use_fast_math: no FTZ).
// The mx helpers flush to zero explicitly, on the exponent field, where the
// reference (XLA's CPU backend, DAZ/FTZ) does.
// The plain PyTorch twins are repro_torch/core/{takum,ofp8,formats}.py; the
// CPU tests hold those against repro bit for bit, and chip_smoke.py holds
// these against those.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

// format ids: repro_torch.core.formats.WireFormat.code
enum WireCode : int {
  kT8 = 0, kT16 = 1, kE4M3 = 2, kE5M2 = 3, kBF16 = 4, kMXE4M3 = 5, kMXE5M2 = 6, kMXT8 = 7
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
  using Elem = Wire<kE4M3>;
  static constexpr int kEmax = 8;
  static __device__ __forceinline__ float cap() { return 448.0f; }
};

template <>
struct Wire<kMXE5M2> {
  using storage = uint8_t;
  using Elem = Wire<kE5M2>;
  static constexpr int kEmax = 15;
  static __device__ __forceinline__ float cap() { return 57344.0f; }
};

template <>
struct Wire<kMXT8> {
  using storage = uint8_t;
  using Elem = Wire<kT8>;
  static constexpr int kEmax = 0;
  static __device__ __forceinline__ float cap() { return 1.875f; }  // t8's top below 2
};

// one element of an mx block, decoded under its block's scale
template <int FMT>
__device__ __forceinline__ float mx_decode(uint32_t elem_bits, float scale) {
  return mul_ftz(Wire<FMT>::Elem::decode(elem_bits), scale);
}

// one element of an mx block under scale byte `byte`: multiplied by
// 2^(127 - byte), clamped to the element cap (NaN stays NaN, -0 stays -0),
// encoded RNE; a NaN block stores element bits 0
template <int FMT>
__device__ __forceinline__ uint32_t mx_encode(float x, uint32_t byte) {
  if (byte == kE8M0NaN) return 0u;
  float xs = mul_pow2_ftz(x, 127 - static_cast<int>(byte));
  const float cap = Wire<FMT>::cap();
  xs = xs > cap ? cap : (xs < -cap ? -cap : xs);
  return Wire<FMT>::Elem::encode(xs);
}

}  // namespace repro

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
