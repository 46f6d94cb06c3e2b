// K3: dequantising matmul out[M, N] = x[M, K] @ decode(w_bits[K, N]), f32,
// with an optional out_fmt epilogue that stores out as packed bits.
//
// Replaces the Pallas kernel src/repro/kernels/takum_matmul.py:56
// _mm_kernel(dual=False) (entry takum_matmul :166); here x is f32 or bf16
// (XMODE kXF32 / kXBF16).  Two loops, chosen by M alone: at M <= 16 (the
// decode step) the split-K matvec of matvec_splitk.cuh, bound by the weight
// bytes; above it the 64 x 64 tile of matmul_tile.cuh (shared with K4),
// bound by the f32 products.  Instantiations: 8 formats x 2 codecs x 2 x
// dtypes, each with two matvec kernels (MB 4, 16) and the 64 x 64 tile
// unfused and fused (the fused tile and the fused combine pass call one
// epilogue helper that switches on the out format and codec at run time).
#include "matvec_splitk.cuh"

namespace {

template <int FMT, int IMPL>
int launch_mm_as(const void* x, const void* w, void* out, float* ws, int M, int N, int K,
                 int chunk, int x_bf16, const void* tab, const repro::Epilogue& ep,
                 cudaStream_t stream) {
  return x_bf16 ? repro_mv::launch_k3<FMT, IMPL, repro_mm::kXBF16>(x, w, out, ws, M, N, K, chunk,
                                                                   tab, ep, stream)
                : repro_mv::launch_k3<FMT, IMPL, repro_mm::kXF32>(x, w, out, ws, M, N, K, chunk,
                                                                  tab, ep, stream);
}

template <int FMT>
int launch_mm(const void* x, const void* w, void* out, float* ws, int M, int N, int K, int chunk,
              int x_bf16, int impl, const void* tab, const repro::Epilogue& ep,
              cudaStream_t stream) {
  REPRO_IMPL_DISPATCH(impl, true, launch_mm_as, FMT, x, w, out, ws, M, N, K, chunk, x_bf16, tab,
                      ep, stream)
}

}  // namespace

// N is the logical column count (for an mx weight, the payload row holds
// ceil(N/32) groups); at M <= 16, ws is the f32 workspace [splits, M, N] of
// the plan's K chunk `chunk` (kernels/takum_matmul.py matvec_plan), unused
// above.  impl is repro::Impl, tab the decode table (null for kBits).
// out_code is the out format (repro::kOutF32: f32 out), out_impl its encode
// codec, meta/aux its encode tables (null for kBits).
extern "C" int repro_matmul(const void* x, const void* w, void* out, void* ws, int M, int N,
                            int K, int chunk, int x_bf16, int fmt, int impl, const void* tab,
                            int out_code, int out_impl, const void* meta, const void* aux,
                            void* stream) {
  const long long ldo =
      out_code >= repro::kMXE4M3 ? static_cast<long long>(N) / 32 * repro::kMxGroup : N;
  const repro::Epilogue ep{out_code, out_impl, static_cast<const uint32_t*>(meta),
                           static_cast<const int*>(aux), ldo};
  REPRO_WIRE_DISPATCH(fmt, launch_mm, x, w, out, static_cast<float*>(ws), M, N, K, chunk, x_bf16,
                      impl, tab, ep, static_cast<cudaStream_t>(stream))
}
