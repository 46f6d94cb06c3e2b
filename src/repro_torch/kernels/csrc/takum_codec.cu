// K1 / K2: element-wise wire-format decode and encode (the VCVT family).
//
// Replaces the Pallas kernels
//   K1 src/repro/kernels/takum_codec.py:51 _decode_kernel (entry takum_decode_2d :85)
//   K2 src/repro/kernels/takum_codec.py:61 _encode_kernel (entry takum_encode_2d :123)
// for the flat formats (f32 too: raw bits both ways, for an f32 KV cache)
// and the mx payloads, with either codec: IMPL kBits
// (the branch-free codecs) or kLut (their `lut` branches, :52-54, :105-108,
// :140-145: a gather from the decode table; two gathers from the encode
// tables and an integer tail).  The TPU kernels cut [R, C] into VMEM tiles;
// here each element is independent and the kernels walk a flat range.
//
// Bound on the H100: bytes.  A decode reads 1-2 bytes and writes 2-4 per
// element, an encode the reverse, against ~40 integer ops: at 3.35 TB/s the
// memory is the limit, and at the decode step's few thousand elements the
// launch is.  So:
//   - Every thread moves 16 bytes per access on the narrow side: 16 codes a
//     trip for an 8-bit format (one uint4 of codes, four float4 of f32), 8
//     for a 16-bit one.  A head and a tail run element by element where a
//     pointer or n is not 16-byte aligned; the wrapper's plan
//     (takum_codec.codec_plan) says where, and a launch whose two pointers
//     cannot be aligned together runs the scalar loop over all of it.  The
//     C entries launch the plan they are given and refuse one the vector
//     path cannot take.
//   - The grid is persistent: at most SMs x (blocks an SM holds), from the
//     device (repro_codec_occupancy), so a lut block stages its tables
//     once, with 16-byte copies, and then runs many trips.
//   - mx payloads (33-byte groups [s, e0..e31]) go one warp per run of 32
//     groups (1056 bytes, 66 chunks of 16; 16, 8 or 4 where that leaves
//     too few warps to fill the card, as at the decode step): K1-mx stages the run's payload
//     through the aligned 16-byte chunks that cover it (any alignment) and
//     writes four decoded elements per lane and trip; K2-mx reads four
//     elements per lane, takes each group's absmax over its 8 lanes
//     (shuffles over |x| as uint32, which orders NaN above Inf above every
//     finite value: __reduce_max_sync's answer), assembles the run's bytes
//     in shared memory and stores them as 16-byte chunks where the
//     destination is aligned (else 8- or 4-byte words, then bytes).
//   - The launch path of the model (takum_codec.takum_encode_into /
//     takum_decode_rows) goes through the same kernels: an encode takes one
//     or two sources (blockIdx.y picks the pair: a layer's K and V in one
//     launch), f32 or bf16 (widened in registers, exactly), into a
//     destination of runs at a pitch (a slot range of the KV cache); a
//     decode takes a row index (the embedding rows of the token ids), the
//     per-tensor pow2 scale (an f32 multiply) and an f32 or bf16 output
//     (RNE, torch's own cast on the card).
// Neighbouring threads touch neighbouring 16-byte chunks, so every access
// is coalesced.  The 16-bit decode tables (256 KiB) stay in global memory,
// read through __ldg where the L2 keeps them; the lut gathers are random
// within a table, so shared-memory bank conflicts depend on the data.
#include <cuda_bf16.h>

#include "codec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMxRun = 32;  // the most groups of a warp's run (the plan's vec: 4, 8, 16 or 32)
constexpr int kMxRunBytes = kMxRun * repro::kMxGroup;              // 1056: 66 chunks
constexpr int kMxStageBytes = repro::span_chunks(kMxRunBytes) * 16;  // a run at any alignment

// dtype of the f32 side: a decode's output, an encode's sources
// (takum_codec.DTYPE_CODE)
enum SideDtype : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);  // bf16 -> f32, exact
}

template <typename T>
__device__ __forceinline__ T narrow(float y);
template <>
__device__ __forceinline__ float narrow<float>(float y) {
  return y;
}
template <>
__device__ __forceinline__ uint16_t narrow<uint16_t>(float y) {  // RNE, as torch's cast
  return __bfloat16_as_ushort(__float2bfloat16_rn(y));
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// one aligned access of BYTES bytes
template <int BYTES>
struct Chunk;
template <>
struct Chunk<4> {
  using type = uint32_t;
};
template <>
struct Chunk<8> {
  using type = uint2;
};
template <>
struct Chunk<16> {
  using type = uint4;
};
struct alignas(16) Uint4x2 {
  uint4 lo, hi;
};
template <>
struct Chunk<32> {  // eight f32 codes against eight bf16 values: two 16-byte accesses
  using type = Uint4x2;
};

// copy N 16-byte chunks from src to dst (both 16-byte aligned)
template <int N>
__device__ __forceinline__ void copy16(void* dst, const void* src) {
#pragma unroll
  for (int c = 0; c < N; ++c) static_cast<uint4*>(dst)[c] = static_cast<const uint4*>(src)[c];
}

// N elements of T moved as one access of N * sizeof(T) bytes (4, 8 or 16)
template <typename T, int N>
struct Pack {
  using C = typename Chunk<N * static_cast<int>(sizeof(T))>::type;
  union {
    C c;
    T e[N];
  };
  __device__ __forceinline__ void load(const T* p) { c = *reinterpret_cast<const C*>(p); }
  __device__ __forceinline__ void store(T* p) const { *reinterpret_cast<C*>(p) = c; }
};

// four neighbouring elements as one 16-byte (f32) or 8-byte (bf16) access
__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load4(const uint16_t* p, float* x) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  x[0] = widen(static_cast<uint16_t>(v.x)), x[1] = widen(static_cast<uint16_t>(v.x >> 16));
  x[2] = widen(static_cast<uint16_t>(v.y)), x[3] = widen(static_cast<uint16_t>(v.y >> 16));
}
__device__ __forceinline__ void store4(float* p, const float* y) {
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
}
__device__ __forceinline__ void store4(uint16_t* p, const uint16_t* y) {
  *reinterpret_cast<uint2*>(p) = make_uint2(y[0] | static_cast<uint32_t>(y[1]) << 16,
                                            y[2] | static_cast<uint32_t>(y[3]) << 16);
}

// elements a vector access moves: 16 bytes of the narrower side
template <typename A, typename B>
__host__ __device__ constexpr int vec_of() {
  return 16 / static_cast<int>(sizeof(A) < sizeof(B) ? sizeof(A) : sizeof(B));
}

// every thread of the block copies its share of `bytes` (a multiple of 16,
// both ends 16-byte aligned) as 16-byte chunks
__device__ __forceinline__ void copy_chunks(void* dst, const void* src, int bytes) {
  for (int c = threadIdx.x; c < bytes / 16; c += blockDim.x) {
    static_cast<uint4*>(dst)[c] = static_cast<const uint4*>(src)[c];
  }
}

// The decode table a block reads: an 8-bit lut table staged in shared
// memory (ends in __syncthreads), else `tab` itself.
template <int FMT, int IMPL>
__device__ __forceinline__ const int* stage_decode_table16(const int* tab, int* smem) {
  if constexpr (repro::kDecodeTabInts<FMT, IMPL> == 256) {
    copy_chunks(smem, tab, 1024);
    __syncthreads();
    return smem;
  } else {
    return tab;
  }
}

template <int FMT, int IMPL>
__device__ __forceinline__ void stage_encode_tables16(const uint32_t* meta, const int* aux,
                                                      uint32_t* meta_s, int* aux_s) {
  if constexpr (IMPL == repro::kLut) {
    copy_chunks(meta_s, meta, 1024);
    copy_chunks(aux_s, aux, 4 * repro::kEncodeAuxInts<FMT, IMPL>);
    __syncthreads();
  }
}

// ---- K1 ------------------------------------------------------------------------

// Output [nrows, cols] (f32 or bf16, contiguous); output row t decodes input
// row rows[t] (rows null: row t) of `in`, rows `pitch` storage elements
// (payload bytes for mx) apart.  A flat launch over one contiguous range is
// nrows 1, rows null.
struct DecodeArgs {
  const void* in;
  const void* rows;     // int32 or int64 ids (row_bytes 4 or 8), or null
  void* out;
  long long nrows, cols, pitch;
  long long nsrc;       // input rows: the bound on rows[]
  const float* scale;   // per-tensor scale (an f32 multiply), or null
  const int* tab;       // lut: the decode table
  long long head, tail;  // elements of the scalar loop before / after the vector body
  int vec;               // elements per vector access, or 1: the scalar loop does it all
  int row_bytes;         // width of one id in rows[]
};

// The input row of output row t: the id read at its own width, an id in
// [-nsrc, -1] wrapped by adding nsrc, then clamped to [0, nsrc - 1] (the
// reference's gather: ids [-1, 5, 7, -9] on 5 rows read rows 4, 4, 4, 0)
__device__ __forceinline__ long long input_row(const DecodeArgs& a, long long t) {
  if (a.rows == nullptr) return t;
  long long k = a.row_bytes == 8 ? static_cast<const long long*>(a.rows)[t]
                                 : static_cast<long long>(static_cast<const int*>(a.rows)[t]);
  if (k < 0) k += a.nsrc;
  return k < 0 ? 0 : (k >= a.nsrc ? a.nsrc - 1 : k);
}

template <int FMT, int IMPL, typename OutT>
__global__ void __launch_bounds__(kThreads) decode_kernel(const DecodeArgs a) {
  using InT = typename repro::Wire<FMT>::storage;
  constexpr int kVec = vec_of<InT, OutT>();
  __shared__ __align__(16) int tab_s[repro::kDecodeTabInts<FMT, IMPL>];
  const int* t = stage_decode_table16<FMT, IMPL>(a.tab, tab_s);
  const InT* in = static_cast<const InT*>(a.in);
  OutT* out = static_cast<OutT*>(a.out);
  const bool scaled = a.scale != nullptr;
  const float s = scaled ? *a.scale : 1.0f;
  const bool flat = a.nrows == 1 && a.rows == nullptr;
  const long long n = a.nrows * a.cols;
  auto conv = [&](uint32_t code) {
    float y = repro::elem_decode<FMT, IMPL>(t, code);
    if (scaled) y *= s;
    return narrow<OutT>(y);
  };
  auto src = [&](long long i) {  // the input element of output element i
    if (flat) return in + i;
    const long long r = i / a.cols;
    return in + input_row(a, r) * a.pitch + (i - r * a.cols);
  };
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = tid; j < a.head + a.tail; j += stride) {
    const long long i = j < a.head ? j : n - a.tail + (j - a.head);
    out[i] = conv(*src(i));
  }
  if (a.vec == 1) return;
  // warp tiles of 32 code chunks: lane l loads chunk l (16 bytes of codes;
  // 32 for f32 codes to bf16) into shared memory, then writes output chunks
  // l, l + 32, ..., so that every load and store instruction of the warp
  // covers contiguous bytes
  constexpr int kE = 16 / static_cast<int>(sizeof(OutT));  // outputs per 16-byte chunk
  constexpr int kInChunks = kVec * static_cast<int>(sizeof(InT)) / 16;
  __shared__ __align__(16) InT tile[kWarps][32 * kVec];
  InT* ts = tile[threadIdx.x / 32];
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const long long end = n - a.tail;
  for (long long base = a.head + (tid - lane) * kVec; base < end; base += stride * kVec) {
    const long long valid = end - base < 32 * kVec ? end - base : 32 * kVec;
    if (lane * kVec < valid) copy16<kInChunks>(ts + lane * kVec, src(base + lane * kVec));
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kVec / kE; ++k) {
      const int j = (32 * k + lane) * kE;
      if (j < valid) {
        Pack<InT, kE> c;
        Pack<OutT, kE> y;
        c.load(ts + j);
#pragma unroll
        for (int e = 0; e < kE; ++e) y.e[e] = conv(c.e[e]);
        y.store(out + base + j);
      }
    }
    __syncwarp();
  }
}

// One warp per run of up to 32 groups (the plan's vec) within an output
// row; cols is whole groups.  The run's payload is staged through the aligned 16-byte chunks
// that cover it; lane l then decodes quarter-groups l, l + 32, ... (four
// elements each), so a warp writes 512 contiguous bytes a trip.
template <int FMT, int IMPL, typename OutT>
__global__ void __launch_bounds__(kThreads) mx_decode_kernel(const DecodeArgs a) {
  __shared__ __align__(16) int tab_s[repro::kDecodeTabInts<FMT, IMPL>];
  __shared__ __align__(16) uint8_t stage[kWarps][kMxStageBytes];
  const int* t = stage_decode_table16<FMT, IMPL>(a.tab, tab_s);
  const uint8_t* in = static_cast<const uint8_t*>(a.in);
  OutT* out = static_cast<OutT*>(a.out);
  const int warp = static_cast<int>(threadIdx.x) / 32, lane = static_cast<int>(threadIdx.x) & 31;
  const long long gpr = a.cols / repro::kMxBlock;  // groups per row
  const int rg = a.vec;                              // groups per run
  const long long rpr = (gpr + rg - 1) / rg;         // runs per row
  const bool vout = (reinterpret_cast<uintptr_t>(out) & (4 * sizeof(OutT) - 1)) == 0;
  const bool scaled = a.scale != nullptr;
  const float s = scaled ? *a.scale : 1.0f;
  uint8_t* st = stage[warp];
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + warp; r < a.nrows * rpr;
       r += static_cast<long long>(gridDim.x) * kWarps) {
    const long long row = r / rpr, g0 = (r - row * rpr) * rg;
    const int cnt = static_cast<int>(gpr - g0 < rg ? gpr - g0 : rg);
    const uint8_t* p = in + input_row(a, row) * a.pitch + g0 * repro::kMxGroup;
    const int off = repro::span_offset(p);
    const uint4* chunk = reinterpret_cast<const uint4*>(p - off);
    for (int c = lane; c < (off + cnt * repro::kMxGroup + 15) / 16; c += 32) {
      reinterpret_cast<uint4*>(st)[c] = chunk[c];
    }
    __syncwarp();
    const uint8_t* g = st + off;
    OutT* o = out + row * a.cols + g0 * repro::kMxBlock;
    for (int j = lane; j < cnt * 8; j += 32) {
      const uint8_t* grp = g + (j >> 3) * repro::kMxGroup;
      const float scale = repro::e8m0_decode(grp[0]);
      OutT y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = repro::mx_decode<FMT, IMPL>(t, grp[1 + 4 * (j & 7) + e], scale);
        if (scaled) v *= s;
        y[e] = narrow<OutT>(v);
      }
      OutT* dst = o + 4 * j;
      if (vout) {
        store4(dst, y);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = y[e];
      }
    }
    __syncwarp();
  }
}

// ---- K2 ------------------------------------------------------------------------

// One or two sources (blockIdx.y picks the pair), each n contiguous
// elements (f32 or bf16), encoded into dst: runs of `run` storage elements
// (payload bytes for mx) whose starts lie `pitch` apart; run == n is one
// contiguous range.
struct EncodeArgs {
  const void* src[2];
  void* dst[2];
  long long n, run, pitch;
  const uint32_t* meta;  // lut: the encode pair (meta, thr | sub)
  const int* aux;
  long long head, tail;
  int vec;
};

template <int FMT, int IMPL, typename InT>
__global__ void __launch_bounds__(kThreads) encode_kernel(const EncodeArgs a) {
  using OutT = typename repro::Wire<FMT>::storage;
  constexpr int kVec = vec_of<InT, OutT>();
  __shared__ __align__(16) uint32_t meta_s[repro::kEncodeTabInts<FMT, IMPL>];
  __shared__ __align__(16) int aux_s[repro::kEncodeAuxInts<FMT, IMPL>];
  stage_encode_tables16<FMT, IMPL>(a.meta, a.aux, meta_s, aux_s);
  const InT* src = static_cast<const InT*>(blockIdx.y ? a.src[1] : a.src[0]);
  OutT* dst = static_cast<OutT*>(blockIdx.y ? a.dst[1] : a.dst[0]);
  const bool flat = a.run >= a.n;
  auto at = [&](long long i) {  // the storage element of element i
    if (flat) return dst + i;
    const long long q = i / a.run;
    return dst + q * a.pitch + (i - q * a.run);
  };
  auto enc = [&](InT x) {
    return static_cast<OutT>(repro::elem_encode<FMT, IMPL>(widen(x), meta_s, aux_s));
  };
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = tid; j < a.head + a.tail; j += stride) {
    const long long i = j < a.head ? j : a.n - a.tail + (j - a.head);
    *at(i) = enc(src[i]);
  }
  if (a.vec == 1) return;
  // warp tiles of 32 code chunks: lane l reads input chunks l, l + 32, ...
  // and puts their codes in shared memory, then stores code chunk l (16
  // bytes), so that every load and store instruction of the warp covers
  // contiguous bytes
  constexpr int kE = 16 / static_cast<int>(sizeof(InT));  // inputs per 16-byte chunk
  constexpr int kR = kVec / kE;
  constexpr int kOutChunks = kVec * static_cast<int>(sizeof(OutT)) / 16;  // 2: bf16 to f32
  __shared__ __align__(16) OutT tile[kWarps][32 * kVec];
  OutT* ts = tile[threadIdx.x / 32];
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const long long end = a.n - a.tail;
  for (long long base = a.head + (tid - lane) * kVec; base < end; base += stride * kVec) {
    const long long valid = end - base < 32 * kVec ? end - base : 32 * kVec;
    Pack<InT, kE> x[kR];
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int j = (32 * k + lane) * kE;
      if (j < valid) x[k].load(src + base + j);
    }
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int j = (32 * k + lane) * kE;
      if (j < valid) {
        Pack<OutT, kE> c;
#pragma unroll
        for (int e = 0; e < kE; ++e) c.e[e] = enc(x[k].e[e]);
        c.store(ts + j);
      }
    }
    __syncwarp();
    if (lane * kVec < valid) copy16<kOutChunks>(at(base + lane * kVec), ts + lane * kVec);
    __syncwarp();
  }
}

// The warp stores the first bytes of the 16-byte aligned `src` to `dst` as
// the widest words (16, 8 or 4 bytes) that `dst`'s alignment allows, lane l
// taking words l, l + 32, ...; returns the bytes stored (whole words).
__device__ __forceinline__ int store_words(uint8_t* dst, const uint8_t* src, int len, int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if ((a & 15u) == 0) {
    for (int c = lane; c < len / 16; c += 32) {
      reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(src)[c];
    }
    return len / 16 * 16;
  }
  if ((a & 7u) == 0) {
    for (int c = lane; c < len / 8; c += 32) {
      reinterpret_cast<uint2*>(dst)[c] = reinterpret_cast<const uint2*>(src)[c];
    }
    return len / 8 * 8;
  }
  if ((a & 3u) == 0) {
    for (int c = lane; c < len / 4; c += 32) {
      reinterpret_cast<uint32_t*>(dst)[c] = reinterpret_cast<const uint32_t*>(src)[c];
    }
    return len / 4 * 4;
  }
  return 0;
}

// One warp per run of up to 32 groups (the plan's vec) of the source (n a
// multiple of 32):
// lane l takes quarter-groups l, l + 32, ... (group l / 8 + 4 k), the
// group's absmax is a max over its 8 lanes, and the run's bytes are
// assembled in shared memory, then stored as the widest words the
// destination's alignment allows (16 bytes for whole runs of 32 or 16
// groups at an aligned start).
template <int FMT, int IMPL, typename InT>
__global__ void __launch_bounds__(kThreads) mx_encode_kernel(const EncodeArgs a) {
  __shared__ __align__(16) uint32_t meta_s[repro::kEncodeTabInts<FMT, IMPL>];
  __shared__ __align__(16) int aux_s[repro::kEncodeAuxInts<FMT, IMPL>];
  __shared__ __align__(16) uint8_t stage[kWarps][kMxRunBytes];
  stage_encode_tables16<FMT, IMPL>(a.meta, a.aux, meta_s, aux_s);
  const InT* src = static_cast<const InT*>(blockIdx.y ? a.src[1] : a.src[0]);
  uint8_t* dst = static_cast<uint8_t*>(blockIdx.y ? a.dst[1] : a.dst[0]);
  const int warp = static_cast<int>(threadIdx.x) / 32, lane = static_cast<int>(threadIdx.x) & 31;
  const long long groups = a.n / repro::kMxBlock;
  const long long gpr = a.run / repro::kMxGroup;  // groups per destination run
  const bool vin = (reinterpret_cast<uintptr_t>(src) & (4 * sizeof(InT) - 1)) == 0;
  uint8_t* st = stage[warp];
  auto group_at = [&](long long g) {  // the destination bytes of group g
    const long long q = g / gpr;
    return dst + q * a.pitch + (g - q * gpr) * repro::kMxGroup;
  };
  const int rg = a.vec;  // groups per run
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + warp; r * rg < groups;
       r += static_cast<long long>(gridDim.x) * kWarps) {
    const long long g0 = r * rg;
    const int cnt = static_cast<int>(groups - g0 < rg ? groups - g0 : rg);
    const int q = lane & 7;
    float x[kMxRun / 4][4];  // every load of the run in flight before any encode
#pragma unroll
    for (int k = 0; k < kMxRun / 4; ++k) {
      const int g = 4 * k + lane / 8;
#pragma unroll
      for (int e = 0; e < 4; ++e) x[k][e] = 0.0f;
      if (g < cnt) {
        const InT* p = src + (g0 + g) * repro::kMxBlock + 4 * q;
        if (vin) {
          load4(p, x[k]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) x[k][e] = widen(p[e]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMxRun / 4; ++k) {
      if (4 * k >= cnt) break;  // warp-uniform
      const int g = 4 * k + lane / 8;
      uint32_t amax = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) amax = max(amax, __float_as_uint(x[k][e]) & 0x7FFFFFFFu);
#pragma unroll
      for (int m = 1; m < 8; m <<= 1) amax = max(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, m));
      if (g < cnt) {
        const uint32_t byte = repro::mx_scale_byte(amax, repro::Wire<FMT>::kEmax);
        uint8_t* grp = st + g * repro::kMxGroup;
        if (q == 0) grp[0] = static_cast<uint8_t>(byte);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          grp[1 + 4 * q + e] =
              static_cast<uint8_t>(repro::mx_encode<FMT, IMPL>(x[k][e], byte, meta_s, aux_s));
        }
      }
    }
    __syncwarp();
    const int len = cnt * repro::kMxGroup;
    uint8_t* d = group_at(g0);
    if ((g0 % gpr) + cnt <= gpr) {  // inside one destination run: contiguous bytes
      const int w = store_words(d, st, len, lane);
      for (int b = w + lane; b < len; b += 32) d[b] = st[b];
    } else {
      for (int b = lane; b < len; b += 32) {
        group_at(g0 + b / repro::kMxGroup)[b % repro::kMxGroup] = st[b];
      }
    }
    __syncwarp();
  }
}

// ---- launches ------------------------------------------------------------------

// Whether the vector path of a launch with element sizes si / so may run:
// every vector access 16-byte aligned on both sides and inside one row or
// run (several rows / runs need head 0 and whole vectors per row, and
// pitches of whole chunks)
bool vector_ok(const void* in, const void* out, long long head, long long tail, long long n,
               int vec, int si, int so, bool multi, long long run, long long pitch_bytes_in,
               long long pitch_bytes_out) {
  if (vec == 1) return head + tail == n;
  if ((n - head - tail) % vec) return false;
  if (!aligned16(static_cast<const char*>(in) + head * si) ||
      !aligned16(static_cast<const char*>(out) + head * so)) {
    return false;
  }
  if (!multi) return true;
  return head == 0 && tail == 0 && run % vec == 0 && pitch_bytes_in % 16 == 0 &&
         pitch_bytes_out % 16 == 0;
}

// groups of an mx warp run: a power of two from 4 to kMxRun
bool mx_run_ok(int groups) { return groups >= 4 && groups <= kMxRun && !(groups & (groups - 1)); }

bool plan_ok(long long n, long long head, long long tail, int grid) {
  return grid >= 1 && head >= 0 && tail >= 0 && head + tail <= n;
}

template <int FMT, int IMPL>
int launch_decode_as(const DecodeArgs& a, int out_dtype, int grid, cudaStream_t stream) {
  const long long n = a.nrows * a.cols;
  if (a.nrows < 1 || a.cols < 1 || out_dtype < kF32 || out_dtype > kBF16 ||
      !plan_ok(n, a.head, a.tail, grid) ||
      (a.rows != nullptr && a.row_bytes != 4 && a.row_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (IMPL == repro::kLut && (a.tab == nullptr || !aligned16(a.tab))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (repro::kIsMx<FMT>) {
    if (a.cols % repro::kMxBlock || !mx_run_ok(a.vec) || a.head || a.tail) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (out_dtype == kBF16) {
      mx_decode_kernel<FMT, IMPL, uint16_t><<<grid, kThreads, 0, stream>>>(a);
    } else {
      mx_decode_kernel<FMT, IMPL, float><<<grid, kThreads, 0, stream>>>(a);
    }
  } else {
    using InT = typename repro::Wire<FMT>::storage;
    const int so = out_dtype == kBF16 ? 2 : 4;
    const int vec = out_dtype == kBF16 ? vec_of<InT, uint16_t>() : vec_of<InT, float>();
    const bool multi = !(a.nrows == 1 && a.rows == nullptr);
    if ((a.vec != 1 && a.vec != vec) ||
        !vector_ok(a.in, a.out, a.head, a.tail, n, a.vec, sizeof(InT), so, multi, a.cols,
                   a.pitch * static_cast<long long>(sizeof(InT)), a.cols * so)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (out_dtype == kBF16) {
      decode_kernel<FMT, IMPL, uint16_t><<<grid, kThreads, 0, stream>>>(a);
    } else {
      decode_kernel<FMT, IMPL, float><<<grid, kThreads, 0, stream>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <int FMT, int IMPL>
int launch_encode_as(const EncodeArgs& a, int pairs, int src_dtype, int grid,
                     cudaStream_t stream) {
  if (pairs < 1 || pairs > 2 || a.n < 1 || a.run < 1 || src_dtype < kF32 || src_dtype > kBF16 ||
      !plan_ok(a.n, a.head, a.tail, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (IMPL == repro::kLut && (a.meta == nullptr || a.aux == nullptr || !aligned16(a.meta) ||
                              !aligned16(a.aux))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 blocks(grid, pairs);
  if constexpr (repro::kIsMx<FMT>) {
    if (a.n % repro::kMxBlock || a.run % repro::kMxGroup || !mx_run_ok(a.vec) || a.head ||
        a.tail || (a.n / repro::kMxBlock) % (a.run / repro::kMxGroup) ||
        (a.run < a.n / repro::kMxBlock * repro::kMxGroup && a.pitch < a.run)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (src_dtype == kBF16) {
      mx_encode_kernel<FMT, IMPL, uint16_t><<<blocks, kThreads, 0, stream>>>(a);
    } else {
      mx_encode_kernel<FMT, IMPL, float><<<blocks, kThreads, 0, stream>>>(a);
    }
  } else {
    using OutT = typename repro::Wire<FMT>::storage;
    const int si = src_dtype == kBF16 ? 2 : 4;
    const int vec = src_dtype == kBF16 ? vec_of<uint16_t, OutT>() : vec_of<float, OutT>();
    const bool multi = a.run < a.n;
    if ((a.vec != 1 && a.vec != vec) || a.n % a.run || (multi && a.pitch < a.run)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int k = 0; k < pairs; ++k) {
      if (!vector_ok(a.src[k], a.dst[k], a.head, a.tail, a.n, a.vec, si, sizeof(OutT), multi,
                     a.run, a.run * si, a.pitch * static_cast<long long>(sizeof(OutT)))) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    if (src_dtype == kBF16) {
      encode_kernel<FMT, IMPL, uint16_t><<<blocks, kThreads, 0, stream>>>(a);
    } else {
      encode_kernel<FMT, IMPL, float><<<blocks, kThreads, 0, stream>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <int FMT>
int launch_decode(const DecodeArgs& a, int impl, int out_dtype, int grid, cudaStream_t stream) {
  REPRO_IMPL_DISPATCH(impl, repro::kHasDecodeLut<FMT>, launch_decode_as, FMT, a, out_dtype, grid,
                      stream)
}

template <int FMT>
int launch_encode(const EncodeArgs& a, int impl, int pairs, int src_dtype, int grid,
                  cudaStream_t stream) {
  REPRO_IMPL_DISPATCH(impl, repro::kHasEncodeLut<FMT>, launch_encode_as, FMT, a, pairs,
                      src_dtype, grid, stream)
}

template <typename K>
int blocks_per_sm(K kernel, int* blocks) {
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, 0));
}

template <int FMT, int IMPL>
int occupancy_decode(int dtype, int* blocks) {
  if constexpr (repro::kIsMx<FMT>) {
    return dtype == kBF16 ? blocks_per_sm(mx_decode_kernel<FMT, IMPL, uint16_t>, blocks)
                          : blocks_per_sm(mx_decode_kernel<FMT, IMPL, float>, blocks);
  } else {
    return dtype == kBF16 ? blocks_per_sm(decode_kernel<FMT, IMPL, uint16_t>, blocks)
                          : blocks_per_sm(decode_kernel<FMT, IMPL, float>, blocks);
  }
}

template <int FMT, int IMPL>
int occupancy_encode(int dtype, int* blocks) {
  if constexpr (repro::kIsMx<FMT>) {
    return dtype == kBF16 ? blocks_per_sm(mx_encode_kernel<FMT, IMPL, uint16_t>, blocks)
                          : blocks_per_sm(mx_encode_kernel<FMT, IMPL, float>, blocks);
  } else {
    return dtype == kBF16 ? blocks_per_sm(encode_kernel<FMT, IMPL, uint16_t>, blocks)
                          : blocks_per_sm(encode_kernel<FMT, IMPL, float>, blocks);
  }
}

template <int FMT>
int occupancy(int op, int impl, int dtype, int* blocks) {
  if (op == 0) {
    REPRO_IMPL_DISPATCH(impl, repro::kHasDecodeLut<FMT>, occupancy_decode, FMT, dtype, blocks)
  }
  REPRO_IMPL_DISPATCH(impl, repro::kHasEncodeLut<FMT>, occupancy_encode, FMT, dtype, blocks)
}

}  // namespace

// K1: output [nrows, cols] (f32 or bf16 by out_dtype) from `in`'s rows
// (through `rows` when not null: ids of row_bytes 4 or 8, wrapped and
// clamped as input_row says); for an mx format cols counts decoded
// elements (whole groups) and pitch payload bytes.  grid, vec, head and
// tail are the wrapper's plan (takum_codec.codec_plan); impl is
// repro::Impl; tab may be null for kBits.
extern "C" int repro_decode(const void* in, const void* rows, void* out, long long nrows,
                            long long cols, long long pitch, long long nsrc, const float* scale,
                            int out_dtype, int fmt, int impl, const void* tab, int grid, int vec,
                            long long head, long long tail, int row_bytes, void* stream) {
  const DecodeArgs a{in, rows, out, nrows, cols, pitch, nsrc, scale,
                     static_cast<const int*>(tab), head, tail, vec, row_bytes};
  REPRO_WIRE_DISPATCH_F32(fmt, launch_decode, a, impl, out_dtype, grid,
                          static_cast<cudaStream_t>(stream))
}

// K2: `pairs` sources (src1 unused for 1) of n elements each (f32 or bf16
// by src_dtype; for an mx format n is whole groups) into their
// destinations' runs of `run` storage elements at `pitch` (run == n: one
// contiguous range; mx: payload bytes); the plan as for K1.
extern "C" int repro_encode(const void* src0, const void* src1, void* dst0, void* dst1,
                            int pairs, long long n, long long run, long long pitch, int src_dtype,
                            int fmt, int impl, const void* meta, const void* aux, int grid,
                            int vec, long long head, long long tail, void* stream) {
  const EncodeArgs a{{src0, src1}, {dst0, dst1}, n, run, pitch,
                     static_cast<const uint32_t*>(meta), static_cast<const int*>(aux),
                     head, tail, vec};
  REPRO_WIRE_DISPATCH_F32(fmt, launch_encode, a, impl, pairs, src_dtype, grid,
                          static_cast<cudaStream_t>(stream))
}

// The current device's SM count and how many blocks of the kernel that
// (op 0 decode / 1 encode, fmt, impl, dtype of the f32 side) launches fit
// on one SM: the persistent grid's two factors.
extern "C" int repro_codec_occupancy(int op, int fmt, int impl, int dtype, int* sms,
                                     int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (op < 0 || op > 1 || dtype < kF32 || dtype > kBF16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  REPRO_WIRE_DISPATCH_F32(fmt, occupancy, op, impl, dtype, blocks)
}
