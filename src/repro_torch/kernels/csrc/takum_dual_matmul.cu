// K4: dual dequantising matmul out[M, N] = decode(x_bits[M, K]) @
// decode(w_bits[K, N]) (the VDPPT analogue), f32 accumulation, with an
// optional out_fmt epilogue: with out_fmt t16 over t8 operands it is the
// tiled form of the paper's widening dot product VDPPT8PT16, with out_fmt ==
// fmt the bits-in/bits-out requantising GEMM.
//
// Replaces the Pallas kernel src/repro/kernels/takum_matmul.py:56
// _mm_kernel(dual=True) (entry takum_dual_matmul :227).  It runs K3's loops
// with XMODE kXWire: x's bits are decoded by the same elem_decode<FMT, IMPL>
// as the weight's; x and w share one format, as in the reference.  An mx x
// is the payload [M, K/32*33] blocked along K (K is whole groups); an x
// element outside K loads as 0.  The loop comes from the wrapper
// (kernels/takum_matmul.py tile_for): at M <= 16 the split-K matvec of
// matvec_splitk.cuh (x decoded once per chunk into its staged rows), bound
// by the weight bytes; above it the tensor-core tile of matmul_mma.cuh (the
// x tile decoded into bf16 beside the weight's), bound by the bf16
// tensor-core rate, for every format but t16, whose two split operands
// would need four products per pair, so t16 keeps the 64 x 64 FMA tile of
// matmul_tile.cuh.  Instantiations, per format and codec: the matvec (MB 4
// and 16), and the tensor-core tile (128 x 128 and 64 x 64) or for t16 the
// FMA tile, each unfused and fused.
#include "matmul_mma.cuh"

namespace {

template <int FMT, int IMPL>
int launch_dual_as(int loop, int tile, const void* x, const void* w, void* out, float* ws, int M,
                   int N, int K, int chunk, const void* tab, const repro::Epilogue& ep,
                   cudaStream_t stream) {
  if (repro::kIsMx<FMT> && K % repro::kMxBlock) return static_cast<int>(cudaErrorInvalidValue);
  return repro_mma::launch_loop<FMT, IMPL, repro_mm::kXWire>(loop, tile, x, w, out, ws, M, N, K,
                                                            chunk, tab, ep, stream);
}

template <int FMT>
int launch_dual(int loop, int tile, const void* x, const void* w, void* out, float* ws, int M,
                int N, int K, int chunk, int impl, const void* tab, const repro::Epilogue& ep,
                cudaStream_t stream) {
  REPRO_IMPL_DISPATCH(impl, true, launch_dual_as, FMT, loop, tile, x, w, out, ws, M, N, K, chunk,
                      tab, ep, stream)
}

}  // namespace

// K is the logical inner length (for an mx x, 32 per payload group); the
// other arguments as repro_matmul's
extern "C" int repro_dual_matmul(const void* x, const void* w, void* out, void* ws, int M, int N,
                                 int K, int chunk, int loop, int tile, int fmt, int impl,
                                 const void* tab, int out_code, int out_impl, const void* meta,
                                 const void* aux, void* stream) {
  const long long ldo =
      out_code >= repro::kMXE4M3 ? static_cast<long long>(N) / 32 * repro::kMxGroup : N;
  const repro::Epilogue ep{out_code, out_impl, static_cast<const uint32_t*>(meta),
                           static_cast<const int*>(aux), ldo};
  REPRO_WIRE_DISPATCH(fmt, launch_dual, loop, tile, x, w, out, static_cast<float*>(ws), M, N, K,
                      chunk, impl, tab, ep, static_cast<cudaStream_t>(stream))
}
