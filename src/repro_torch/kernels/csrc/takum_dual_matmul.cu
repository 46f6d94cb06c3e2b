// K4: dual dequantising matmul out[M, N] = decode(x_bits[M, K]) @
// decode(w_bits[K, N]) (the VDPPT analogue), f32 accumulation, with an
// optional out_fmt epilogue: with out_fmt t16 over t8 operands it is the
// tiled form of the paper's widening dot product VDPPT8PT16, with out_fmt ==
// fmt the bits-in/bits-out requantising GEMM.
//
// Replaces the Pallas kernel src/repro/kernels/takum_matmul.py:56
// _mm_kernel(dual=True) (entry takum_dual_matmul :227).  It is K3's kernel
// (matmul_tile.cuh) with XMODE kXWire: the x tile is decoded into shared
// memory by the same elem_decode<FMT, IMPL> as the w tile; x and w share
// one format, as in the reference.  An mx x is the payload [M, K/32*33]
// blocked along K (K is whole groups); an x element outside K loads as 0.
// Instantiations: 8 formats x 2 codecs x 2 tiles, each unfused and fused.
// Bound: as K3; at M = 1024 with operands exact in bf16 (t8, e4m3, e5m2,
// bf16 and their mx containers) the bf16 tensor-core rate.
#include "matmul_tile.cuh"

namespace {

template <int FMT, int IMPL>
int launch_dual_as(const void* x, const void* w, void* out, int M, int N, int K, const void* tab,
                   const repro::Epilogue& ep, cudaStream_t stream) {
  if (repro::kIsMx<FMT> && K % repro::kMxBlock) return static_cast<int>(cudaErrorInvalidValue);
  return repro_mm::launch_mm_x<FMT, IMPL, repro_mm::kXWire>(x, w, out, M, N, K, tab, ep, stream);
}

template <int FMT>
int launch_dual(const void* x, const void* w, void* out, int M, int N, int K, int impl,
                const void* tab, const repro::Epilogue& ep, cudaStream_t stream) {
  REPRO_IMPL_DISPATCH(impl, true, launch_dual_as, FMT, x, w, out, M, N, K, tab, ep, stream)
}

}  // namespace

// K is the logical inner length (for an mx x, 32 per payload group); the
// other arguments as repro_matmul's
extern "C" int repro_dual_matmul(const void* x, const void* w, void* out, int M, int N, int K,
                                 int fmt, int impl, const void* tab, int out_code, int out_impl,
                                 const void* meta, const void* aux, void* stream) {
  const long long ldo =
      out_code >= repro::kMXE4M3 ? static_cast<long long>(N) / 32 * repro::kMxGroup : N;
  const repro::Epilogue ep{out_code, out_impl, static_cast<const uint32_t*>(meta),
                           static_cast<const int*>(aux), ldo};
  REPRO_WIRE_DISPATCH(fmt, launch_dual, x, w, out, M, N, K, impl, tab, ep,
                      static_cast<cudaStream_t>(stream))
}
