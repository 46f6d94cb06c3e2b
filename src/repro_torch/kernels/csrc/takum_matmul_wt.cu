// K5's backward: dx[M, N] = g[M, K] @ decode(w_bits[N, K])^T, f32, over the
// forward's weight as it is stored (w_bits is K3's [K_fwd, N_fwd] weight:
// here its rows are the output columns and its columns the reduction).
//
// Replaces the backward rule of the Pallas entry
// src/repro/kernels/takum_matmul.py:190 takum_matmul_ad (_takum_matmul_bwd
// :211), which runs the Pallas kernel _mm_kernel(dual=False) (:56) on
// w_bits.T.  Here K3's loops read the stored weight through their WT load
// mode instead: no transposed copy of the bits (the t8 llama3-8b head alone
// would be 525 MB per backward).  At M <= 16 that is the split-K matvec of
// matvec_splitk.cuh (same plan and order as K3 over a copy, bound by the
// weight bytes), above it the wgmma tile of matmul_wgmma.cuh (g through
// its exact three-way bf16 split; the same MMAs in the same order as K3
// over a copy, bound by the bf16 tensor-core rate over 3 MMAs per product,
// 6 for t16); the loop comes from the wrapper (kernels/takum_matmul.py
// tile_for).  g is the f32 cotangent of K3's f32 output, so x is f32 only
// (XMODE kXF32); the formats are the flat ones (t8, t16, e4m3, e5m2,
// bf16), each under either codec: 5 x 2 x (two matvec kernels, the wgmma
// tile at 128 x 128 and 64 x 64, each with TMA and with cp.async copies),
// plus the combine pass; no fused twin.
#include "matmul_wgmma.cuh"

namespace {

template <int FMT, int IMPL>
int launch_wt_as(int loop, int tile, const void* x, const void* w, void* out, float* ws, int M,
                 int N, int K, int chunk, const void* tab, cudaStream_t stream) {
  const repro::Epilogue f32_out{repro::kOutF32, repro::kBits, nullptr, nullptr, N};
  return repro_mma::launch_loop<FMT, IMPL, repro_mm::kXF32, true>(loop, tile, x, w, out, ws, M,
                                                                  N, K, chunk, tab, f32_out,
                                                                  stream);
}

template <int FMT>
int launch_wt(int loop, int tile, const void* x, const void* w, void* out, float* ws, int M,
              int N, int K, int chunk, int impl, const void* tab, cudaStream_t stream) {
  REPRO_IMPL_DISPATCH(impl, true, launch_wt_as, FMT, loop, tile, x, w, out, ws, M, N, K, chunk,
                      tab, stream)
}

}  // namespace

// out[M, N] = x[M, K] @ decode(w[N, K])^T: x f32 [M, K], w the flat
// format's bits [N, K] row-major, out f32 [M, N]; at M <= 16 ws and chunk
// as repro_matmul's; loop is repro_mma::Loop (kMatvec or kMmaF32)
// and tile the wgmma tile's block rows (mma_plan; 0 for the other loops);
// impl is repro::Impl, tab the decode table (null for kBits).  An mx
// format id is refused.
extern "C" int repro_matmul_wt(const void* x, const void* w, void* out, void* ws, int M, int N,
                               int K, int chunk, int loop, int tile, int fmt, int impl,
                               const void* tab, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  switch (fmt) {
    case repro::kT8: return launch_wt<repro::kT8>(loop, tile, x, w, out, wsf, M, N, K, chunk, impl, tab, s);
    case repro::kT16: return launch_wt<repro::kT16>(loop, tile, x, w, out, wsf, M, N, K, chunk, impl, tab, s);
    case repro::kE4M3: return launch_wt<repro::kE4M3>(loop, tile, x, w, out, wsf, M, N, K, chunk, impl, tab, s);
    case repro::kE5M2: return launch_wt<repro::kE5M2>(loop, tile, x, w, out, wsf, M, N, K, chunk, impl, tab, s);
    case repro::kBF16: return launch_wt<repro::kBF16>(loop, tile, x, w, out, wsf, M, N, K, chunk, impl, tab, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
