// K1 / K2: element-wise wire-format decode and encode (the VCVT family).
//
// Replaces the Pallas kernels
//   K1 src/repro/kernels/takum_codec.py:51 _decode_kernel (entry takum_decode_2d :85)
//   K2 src/repro/kernels/takum_codec.py:61 _encode_kernel (entry takum_encode_2d :123)
// for the flat formats and the mx payloads, bits codec.  The TPU kernels cut
// [R, C] into VMEM tiles; here each element is independent, so one
// grid-stride loop covers the flattened [R * C] range and no edge needs a
// mask.  An mx payload row is whole 33-byte groups, so the flattened
// payload is the groups of every row back to back.
//
// Bound on the H100: bytes.  A decode reads 1-2 bytes and writes 4 per
// element, an encode the reverse, against ~40 integer ops: at 3.35 TB/s the
// memory is the limit.  Neighbouring threads touch neighbouring elements, so
// every load and store is coalesced.
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

template <int FMT>
__global__ void decode_kernel(const typename repro::Wire<FMT>::storage* __restrict__ in,
                              float* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = repro::Wire<FMT>::decode(in[i]);
  }
}

template <int FMT>
__global__ void encode_kernel(const float* __restrict__ in,
                              typename repro::Wire<FMT>::storage* __restrict__ out, long long n) {
  using T = typename repro::Wire<FMT>::storage;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = static_cast<T>(repro::Wire<FMT>::encode(in[i]));
  }
}

// n = decoded elements (a multiple of 32): payload groups n / 32
template <int FMT>
__global__ void mx_decode_kernel(const uint8_t* __restrict__ in, float* __restrict__ out,
                                 long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = repro::mx_decode<FMT>(in[repro::mx_elem_at(i)],
                                   repro::e8m0_decode(in[repro::mx_scale_at(i)]));
  }
}

// n = input elements (a multiple of 32); one warp per block of 32.  The loop
// bound is uniform across a warp, so every lane reaches the reduction.
template <int FMT>
__global__ void mx_encode_kernel(const float* __restrict__ in, uint8_t* __restrict__ out,
                                 long long n) {
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x / 32);
  for (long long b = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
       b < n / repro::kMxBlock; b += warps) {
    const float x = in[b * repro::kMxBlock + lane];
    const uint32_t amax = __reduce_max_sync(0xFFFFFFFFu, __float_as_uint(x) & 0x7FFFFFFFu);
    const uint32_t byte = repro::mx_scale_byte(amax, repro::Wire<FMT>::kEmax);
    uint8_t* grp = out + b * repro::kMxGroup;
    if (lane == 0) grp[0] = static_cast<uint8_t>(byte);
    grp[1 + lane] = static_cast<uint8_t>(repro::mx_encode<FMT>(x, byte));
  }
}

template <int FMT>
int launch_decode(const void* in, void* out, long long n, cudaStream_t stream) {
  using T = typename repro::Wire<FMT>::storage;
  if constexpr (repro::kIsMx<FMT>) {
    mx_decode_kernel<FMT><<<grid_for(n), kThreads, 0, stream>>>(static_cast<const uint8_t*>(in),
                                                               static_cast<float*>(out), n);
  } else {
    decode_kernel<FMT><<<grid_for(n), kThreads, 0, stream>>>(static_cast<const T*>(in),
                                                            static_cast<float*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int FMT>
int launch_encode(const void* in, void* out, long long n, cudaStream_t stream) {
  using T = typename repro::Wire<FMT>::storage;
  if constexpr (repro::kIsMx<FMT>) {
    if (n % repro::kMxBlock) return static_cast<int>(cudaErrorInvalidValue);
    mx_encode_kernel<FMT><<<grid_for(n), kThreads, 0, stream>>>(static_cast<const float*>(in),
                                                               static_cast<uint8_t*>(out), n);
  } else {
    encode_kernel<FMT><<<grid_for(n), kThreads, 0, stream>>>(static_cast<const float*>(in),
                                                            static_cast<T*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n is the element count on the f32 side (for an mx format, 32 per payload group)
extern "C" int repro_decode(const void* in, void* out, long long n, int fmt, void* stream) {
  REPRO_WIRE_DISPATCH(fmt, launch_decode, in, out, n, static_cast<cudaStream_t>(stream))
}

extern "C" int repro_encode(const void* in, void* out, long long n, int fmt, void* stream) {
  REPRO_WIRE_DISPATCH(fmt, launch_encode, in, out, n, static_cast<cudaStream_t>(stream))
}
