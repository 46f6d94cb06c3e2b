// K1 / K2: element-wise wire-format decode and encode (the VCVT family).
//
// Replaces the Pallas kernels
//   K1 src/repro/kernels/takum_codec.py:51 _decode_kernel (entry takum_decode_2d :85)
//   K2 src/repro/kernels/takum_codec.py:61 _encode_kernel (entry takum_encode_2d :123)
// for the flat formats, bits codec.  The TPU kernels cut [R, C] into VMEM
// tiles; here each element is independent, so one grid-stride loop covers
// the flattened [R * C] range and no edge needs a mask.
//
// Bound on the H100: bytes.  A decode reads 1-2 bytes and writes 4 per
// element, an encode the reverse, against ~40 integer ops: at 3.35 TB/s the
// memory is the limit.  Neighbouring threads touch neighbouring elements, so
// every load and store is coalesced.
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

template <int FMT>
int launch_decode(const void* in, void* out, long long n, cudaStream_t stream) {
  using T = typename repro::Wire<FMT>::storage;
  decode_kernel<FMT><<<grid_for(n), kThreads, 0, stream>>>(static_cast<const T*>(in),
                                                          static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

template <int FMT>
int launch_encode(const void* in, void* out, long long n, cudaStream_t stream) {
  using T = typename repro::Wire<FMT>::storage;
  encode_kernel<FMT><<<grid_for(n), kThreads, 0, stream>>>(static_cast<const float*>(in),
                                                          static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_decode(const void* in, void* out, long long n, int fmt, void* stream) {
  REPRO_WIRE_DISPATCH(fmt, launch_decode, in, out, n, static_cast<cudaStream_t>(stream))
}

extern "C" int repro_encode(const void* in, void* out, long long n, int fmt, void* stream) {
  REPRO_WIRE_DISPATCH(fmt, launch_encode, in, out, n, static_cast<cudaStream_t>(stream))
}
