// K3: dequantising matmul out[M, N] = x[M, K] @ decode(w_bits[K, N]), f32.
//
// Replaces the Pallas kernel src/repro/kernels/takum_matmul.py:56
// _mm_kernel(dual=False) (entry takum_matmul :166) for the flat formats and
// the mx payloads (its `mx` branch, :61-80, :111-132), with either codec
// (IMPL kBits, or kLut: its `lut` branch, :139-142), without the out_fmt
// epilogue.  The TPU kernel carries an f32
// accumulator tile in VMEM across a sequential K grid axis; here each block
// owns one output tile and loops over K itself, keeping the accumulators in
// registers.
//
// Per K step a block stages an x tile (f32, or bf16 widened to f32) and a
// w-bits tile, decoded by K0 into shared memory, then every thread runs
// TM x TN f32 FMAs per k.  Out-of-range M/N lanes are never stored; K-edge
// lanes are zero on BOTH operands, so a NaN in padding can never meet a 0.
// No tensor cores: decoded t16 values carry up to 11 fraction bits and TF32
// holds 10, so TF32 would round the weights.
//
// Bound on the H100: at the decode step's M = 4 the weight bytes (K*N*1 or
// 2 bytes at 3.35 TB/s); at the prefill's M = 1024 the f32 FMAs (67 TFLOP/s
// outside the tensor cores).  Two tilings: a 64 x 64 tile for large M and an
// 8 x 32 tile for small M, which keeps more blocks in flight over N when a
// 64-row tile would be mostly padding.  Both add the k terms of each output
// in the same ascending order, so every output is the same either way.
//
// An mx weight is the payload [K, ceil(N/32)*33], blocked along N: row k
// holds the groups [s, e0..e31] of columns 32g..32g+31.  N need not be a
// multiple of 32; the padded columns of the last group are never decoded or
// stored.  Each K step first stages the tile's (k, group) scales in shared
// memory, one load per pair (BN = 32: one group per weight row; BN = 64:
// two), then decodes every element byte under its staged scale.
//
// lut: an 8-bit decode table (1 KiB) is copied into shared memory once,
// before the K loop (one more __syncthreads); the t16/bf16 tables (256 KiB)
// are read from global memory through __ldg.  The decoded values equal the
// bits decode's and the k terms are added in the same order, so the two
// codecs give the same output bit for bit.
#include "codec.cuh"

namespace {

constexpr int kThreads = 256;

template <bool XBF16>
__device__ __forceinline__ float load_x(const void* x, long long i) {
  if constexpr (XBF16) {
    return repro::bf16_decode(static_cast<const uint16_t*>(x)[i]);
  } else {
    return static_cast<const float*>(x)[i];
  }
}

template <int FMT, int IMPL, bool XBF16, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
mm_kernel(const void* __restrict__ x, const typename repro::Wire<FMT>::storage* __restrict__ w,
          float* __restrict__ out, int M, int N, int K, const int* __restrict__ tab) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one thread per TM x TN sub-tile");
  __shared__ float xs[BK][BM];  // x tile, transposed: xs[k][m]
  __shared__ float ws[BK][BN];  // decoded weight tile
  __shared__ float ss[BK][BN / 32];  // mx: the tile's (k, group) scales
  __shared__ int tab_s[repro::kDecodeTabInts<FMT, IMPL>];  // lut: an 8-bit decode table
  const int* dtab = repro::stage_decode_table<FMT, IMPL>(tab, tab_s);
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int mm = i / BK, kk = i % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < M && gk < K) ? load_x<XBF16>(x, static_cast<long long>(gm) * K + gk) : 0.0f;
    }
    if constexpr (repro::kIsMx<FMT>) {
      const long long ldw = static_cast<long long>((N + 31) / 32) * repro::kMxGroup;
      for (int i = tid; i < BK * (BN / 32); i += kThreads) {
        const int kk = i / (BN / 32), gg = i % (BN / 32);
        const int gk = k0 + kk, gn = n0 + gg * 32;
        ss[kk][gg] = (gk < K && gn < N)
                         ? repro::e8m0_decode(w[gk * ldw + repro::mx_scale_at(gn)])
                         : 0.0f;
      }
      __syncthreads();
      for (int i = tid; i < BK * BN; i += kThreads) {
        const int kk = i / BN, nn = i % BN;
        const int gk = k0 + kk, gn = n0 + nn;
        ws[kk][nn] = (gk < K && gn < N)
                         ? repro::mx_decode<FMT, IMPL>(dtab, w[gk * ldw + repro::mx_elem_at(gn)],
                                                       ss[kk][nn / 32])
                         : 0.0f;
      }
    } else {
      for (int i = tid; i < BK * BN; i += kThreads) {
        const int kk = i / BN, nn = i % BN;
        const int gk = k0 + kk, gn = n0 + nn;
        ws[kk][nn] = (gk < K && gn < N)
                         ? repro::elem_decode<FMT, IMPL>(dtab, w[static_cast<long long>(gk) * N + gn])
                         : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) out[static_cast<long long>(gm) * N + gn] = acc[i][j];
    }
  }
}

template <int FMT, int IMPL, bool XBF16, int BM, int BN, int BK, int TM, int TN>
int launch_tiled(const void* x, const void* w, void* out, int M, int N, int K, const int* tab,
                 cudaStream_t stream) {
  using T = typename repro::Wire<FMT>::storage;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_kernel<FMT, IMPL, XBF16, BM, BN, BK, TM, TN><<<grid, kThreads, 0, stream>>>(
      x, static_cast<const T*>(w), static_cast<float*>(out), M, N, K, tab);
  return static_cast<int>(cudaGetLastError());
}

template <int FMT, int IMPL>
int launch_mm_as(const void* x, const void* w, void* out, int M, int N, int K, int x_bf16,
                 const void* tab, cudaStream_t stream) {
  const int* t = static_cast<const int*>(tab);
  if (IMPL == repro::kLut && t == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 16) {
    return x_bf16 ? launch_tiled<FMT, IMPL, true, 8, 32, 32, 1, 1>(x, w, out, M, N, K, t, stream)
                  : launch_tiled<FMT, IMPL, false, 8, 32, 32, 1, 1>(x, w, out, M, N, K, t, stream);
  }
  return x_bf16 ? launch_tiled<FMT, IMPL, true, 64, 64, 16, 4, 4>(x, w, out, M, N, K, t, stream)
                : launch_tiled<FMT, IMPL, false, 64, 64, 16, 4, 4>(x, w, out, M, N, K, t, stream);
}

template <int FMT>
int launch_mm(const void* x, const void* w, void* out, int M, int N, int K, int x_bf16, int impl,
              const void* tab, cudaStream_t stream) {
  REPRO_IMPL_DISPATCH(impl, true, launch_mm_as, FMT, x, w, out, M, N, K, x_bf16, tab, stream)
}

}  // namespace

// N is the logical column count (for an mx weight, the payload row holds
// ceil(N/32) groups); impl is repro::Impl, tab the decode table (null for kBits)
extern "C" int repro_matmul(const void* x, const void* w, void* out, int M, int N, int K,
                            int x_bf16, int fmt, int impl, const void* tab, void* stream) {
  REPRO_WIRE_DISPATCH(fmt, launch_mm, x, w, out, M, N, K, x_bf16, impl, tab,
                      static_cast<cudaStream_t>(stream))
}
