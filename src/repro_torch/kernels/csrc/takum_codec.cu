// K1 / K2: element-wise wire-format decode and encode (the VCVT family).
//
// Replaces the Pallas kernels
//   K1 src/repro/kernels/takum_codec.py:51 _decode_kernel (entry takum_decode_2d :85)
//   K2 src/repro/kernels/takum_codec.py:61 _encode_kernel (entry takum_encode_2d :123)
// for the flat formats and the mx payloads, with either codec: IMPL kBits
// (the branch-free codecs) or kLut (their `lut` branches, :52-54, :105-108,
// :140-145: a gather from the decode table; two gathers from the encode
// tables and an integer tail).  The TPU kernels cut [R, C] into VMEM tiles;
// here each element is independent, so one grid-stride loop covers the
// flattened [R * C] range and no edge needs a mask.  An mx payload row is
// whole 33-byte groups, so the flattened payload is the groups of every row
// back to back.
//
// Bound on the H100: bytes.  A decode reads 1-2 bytes and writes 4 per
// element, an encode the reverse, against ~40 integer ops: at 3.35 TB/s the
// memory is the limit.  Neighbouring threads touch neighbouring elements, so
// every load and store is coalesced.
//   lut: each block first copies its tables into shared memory (1 KiB for an
//     8-bit decode table, 2 KiB for an 8-bit encode pair, 1.5 KiB for the
//     takum16 pair) before its first element; the t16 and bf16 decode
//     tables (256 KiB) stay in global memory and are read through __ldg,
//     where the L2 keeps them.  The gathers are random within the table, so
//     shared-memory bank conflicts depend on the data.
//   mx decode (K1-mx): thread i decodes element i; the 32 lanes of a warp
//     read one group's 32 element bytes and its scale byte (one broadcast).
//   mx encode (K2-mx): one warp per 32-element block, lane i on element i.
//     __reduce_max_sync over the |x| bits (as uint32, monotone on
//     non-negative floats, NaN above Inf) gives the absmax's exponent field;
//     lane 0 writes the scale byte, lane i the element byte 1 + i.
#include "codec.cuh"

namespace {

constexpr int kThreads = 256;

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // enough blocks to fill every SM
  return static_cast<int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

template <int FMT, int IMPL>
__global__ void decode_kernel(const typename repro::Wire<FMT>::storage* __restrict__ in,
                              float* __restrict__ out, long long n, const int* __restrict__ tab) {
  __shared__ int tab_s[repro::kDecodeTabInts<FMT, IMPL>];
  const int* t = repro::stage_decode_table<FMT, IMPL>(tab, tab_s);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = repro::elem_decode<FMT, IMPL>(t, in[i]);
  }
}

template <int FMT, int IMPL>
__global__ void encode_kernel(const float* __restrict__ in,
                              typename repro::Wire<FMT>::storage* __restrict__ out, long long n,
                              const uint32_t* __restrict__ meta, const int* __restrict__ aux) {
  using T = typename repro::Wire<FMT>::storage;
  __shared__ uint32_t meta_s[repro::kEncodeTabInts<FMT, IMPL>];
  __shared__ int aux_s[repro::kEncodeAuxInts<FMT, IMPL>];
  repro::stage_encode_tables<FMT, IMPL>(meta, aux, meta_s, aux_s);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = static_cast<T>(repro::elem_encode<FMT, IMPL>(in[i], meta_s, aux_s));
  }
}

// n = decoded elements (a multiple of 32): payload groups n / 32
template <int FMT, int IMPL>
__global__ void mx_decode_kernel(const uint8_t* __restrict__ in, float* __restrict__ out,
                                 long long n, const int* __restrict__ tab) {
  __shared__ int tab_s[repro::kDecodeTabInts<FMT, IMPL>];
  const int* t = repro::stage_decode_table<FMT, IMPL>(tab, tab_s);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = repro::mx_decode<FMT, IMPL>(t, in[repro::mx_elem_at(i)],
                                         repro::e8m0_decode(in[repro::mx_scale_at(i)]));
  }
}

// n = input elements (a multiple of 32); one warp per block of 32.  The loop
// bound is uniform across a warp, so every lane reaches the reduction.
template <int FMT, int IMPL>
__global__ void mx_encode_kernel(const float* __restrict__ in, uint8_t* __restrict__ out,
                                 long long n, const uint32_t* __restrict__ meta,
                                 const int* __restrict__ aux) {
  __shared__ uint32_t meta_s[repro::kEncodeTabInts<FMT, IMPL>];
  __shared__ int aux_s[repro::kEncodeAuxInts<FMT, IMPL>];
  repro::stage_encode_tables<FMT, IMPL>(meta, aux, meta_s, aux_s);
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x / 32);
  for (long long b = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
       b < n / repro::kMxBlock; b += warps) {
    const float x = in[b * repro::kMxBlock + lane];
    const uint32_t amax = __reduce_max_sync(0xFFFFFFFFu, __float_as_uint(x) & 0x7FFFFFFFu);
    const uint32_t byte = repro::mx_scale_byte(amax, repro::Wire<FMT>::kEmax);
    uint8_t* grp = out + b * repro::kMxGroup;
    if (lane == 0) grp[0] = static_cast<uint8_t>(byte);
    grp[1 + lane] = static_cast<uint8_t>(repro::mx_encode<FMT, IMPL>(x, byte, meta_s, aux_s));
  }
}

template <int FMT, int IMPL>
int launch_decode_as(const void* in, void* out, long long n, const void* tab, cudaStream_t stream) {
  using T = typename repro::Wire<FMT>::storage;
  const int* t = static_cast<const int*>(tab);
  if (IMPL == repro::kLut && t == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (repro::kIsMx<FMT>) {
    mx_decode_kernel<FMT, IMPL><<<grid_for(n), kThreads, 0, stream>>>(
        static_cast<const uint8_t*>(in), static_cast<float*>(out), n, t);
  } else {
    decode_kernel<FMT, IMPL><<<grid_for(n), kThreads, 0, stream>>>(
        static_cast<const T*>(in), static_cast<float*>(out), n, t);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int FMT, int IMPL>
int launch_encode_as(const void* in, void* out, long long n, const void* meta, const void* aux,
                     cudaStream_t stream) {
  using T = typename repro::Wire<FMT>::storage;
  const uint32_t* m = static_cast<const uint32_t*>(meta);
  const int* a = static_cast<const int*>(aux);
  if (IMPL == repro::kLut && (m == nullptr || a == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (repro::kIsMx<FMT>) {
    if (n % repro::kMxBlock) return static_cast<int>(cudaErrorInvalidValue);
    mx_encode_kernel<FMT, IMPL><<<grid_for(n), kThreads, 0, stream>>>(
        static_cast<const float*>(in), static_cast<uint8_t*>(out), n, m, a);
  } else {
    encode_kernel<FMT, IMPL><<<grid_for(n), kThreads, 0, stream>>>(
        static_cast<const float*>(in), static_cast<T*>(out), n, m, a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int FMT>
int launch_decode(const void* in, void* out, long long n, int impl, const void* tab,
                  cudaStream_t stream) {
  REPRO_IMPL_DISPATCH(impl, true, launch_decode_as, FMT, in, out, n, tab, stream)
}

template <int FMT>
int launch_encode(const void* in, void* out, long long n, int impl, const void* meta,
                  const void* aux, cudaStream_t stream) {
  REPRO_IMPL_DISPATCH(impl, repro::kHasEncodeLut<FMT>, launch_encode_as, FMT, in, out, n, meta,
                      aux, stream)
}

}  // namespace

// n is the element count on the f32 side (for an mx format, 32 per payload
// group); impl is repro::Impl; the table pointers may be null for kBits
extern "C" int repro_decode(const void* in, void* out, long long n, int fmt, int impl,
                            const void* tab, void* stream) {
  REPRO_WIRE_DISPATCH(fmt, launch_decode, in, out, n, impl, tab, static_cast<cudaStream_t>(stream))
}

extern "C" int repro_encode(const void* in, void* out, long long n, int fmt, int impl,
                            const void* meta, const void* aux, void* stream) {
  REPRO_WIRE_DISPATCH(fmt, launch_encode, in, out, n, impl, meta, aux,
                      static_cast<cudaStream_t>(stream))
}
