// K3: dequantising matmul out[M, N] = x[M, K] @ decode(w_bits[K, N]), f32,
// with an optional out_fmt epilogue that stores out as packed bits.
//
// Replaces the Pallas kernel src/repro/kernels/takum_matmul.py:56
// _mm_kernel(dual=False) (entry takum_matmul :166); here x is f32 or bf16
// (XMODE kXF32 / kXBF16).  Four loops, chosen by the wrapper from (M, x
// type, format) alone (kernels/takum_matmul.py tile_for) and passed in as
// `loop`: at M <= 16 (the decode step) the split-K matvec of
// matvec_splitk.cuh, bound by the weight bytes; above it, for bf16 x, the
// tensor-core tile of matmul_mma.cuh (t16 through its exact hi/lo split),
// for f32 x the warp-specialised wgmma tile of matmul_wgmma.cuh (x through
// its exact three-way bf16 split), both bound by the bf16 tensor-core rate
// over their MMAs per product; the 64 x 64 FMA tile of matmul_tile.cuh is
// the fallback of both tiles, and stays launchable, unfused, for f32 x as
// the reference the wgmma tile's fallback blocks are held against.
// Instantiations, per format and codec: the matvec (MB 4 and 16) for both
// x types, the tensor-core tiles (128 x 128 and 64 x 64, each unfused and
// fused) for each x type (the wgmma tile's flat formats twice: TMA and
// cp.async copies), the FMA tile (unfused) for f32 x; the
// fused kernels and the fused combine pass call one epilogue helper that
// switches on the out format and codec at run time.
#include "matmul_wgmma.cuh"

namespace {

template <int FMT, int IMPL>
int launch_mm_as(int loop, int tile, const void* x, const void* w, void* out, float* ws, int M,
                 int N, int K, int chunk, int x_bf16, const void* tab, const repro::Epilogue& ep,
                 cudaStream_t stream) {
  return x_bf16 ? repro_mma::launch_loop<FMT, IMPL, repro_mm::kXBF16>(
                      loop, tile, x, w, out, ws, M, N, K, chunk, tab, ep, stream)
                : repro_mma::launch_loop<FMT, IMPL, repro_mm::kXF32>(
                      loop, tile, x, w, out, ws, M, N, K, chunk, tab, ep, stream);
}

template <int FMT>
int launch_mm(int loop, int tile, const void* x, const void* w, void* out, float* ws, int M,
              int N, int K, int chunk, int x_bf16, int impl, const void* tab,
              const repro::Epilogue& ep, cudaStream_t stream) {
  REPRO_IMPL_DISPATCH(impl, true, launch_mm_as, FMT, loop, tile, x, w, out, ws, M, N, K, chunk,
                      x_bf16, tab, ep, stream)
}

}  // namespace

// N is the logical column count (for an mx weight, the payload row holds
// ceil(N/32) groups); loop is repro_mma::Loop (kernels/takum_matmul.py
// tile_for) and tile the tensor-core tile's block rows (mma_plan; 0 for the
// other loops); on the matvec, ws is the f32 workspace [splits, M, N] of
// the plan's K chunk `chunk` (matvec_plan), unused otherwise.  impl is
// repro::Impl, tab the decode table (null for kBits).  out_code is the out
// format (repro::kOutF32: f32 out), out_impl its encode codec, meta/aux its
// encode tables (null for kBits).
extern "C" int repro_matmul(const void* x, const void* w, void* out, void* ws, int M, int N,
                            int K, int chunk, int loop, int tile, int x_bf16, int fmt, int impl,
                            const void* tab, int out_code, int out_impl, const void* meta,
                            const void* aux, void* stream) {
  const long long ldo =
      out_code >= repro::kMXE4M3 ? static_cast<long long>(N) / 32 * repro::kMxGroup : N;
  const repro::Epilogue ep{out_code, out_impl, static_cast<const uint32_t*>(meta),
                           static_cast<const int*>(aux), ldo};
  REPRO_WIRE_DISPATCH(fmt, launch_mm, loop, tile, x, w, out, static_cast<float*>(ws), M, N, K,
                      chunk, x_bf16, impl, tab, ep, static_cast<cudaStream_t>(stream))
}
