// The tiled K loop of K4 (takum_dual_matmul.cu) at every M and of K3
// (takum_matmul.cu, and its transposed twin takum_matmul_wt.cu) above M = 16:
//   out[M, N] = X[M, K] @ decode(w_bits[K, N]), f32 accumulation, where X is
//   x itself (K3: f32, or bf16 widened to f32) or decode(x_bits) (K4).
// K3 at M <= 16 runs the split-K matvec of matvec_splitk.cuh instead.
//
// Replaces the Pallas kernel src/repro/kernels/takum_matmul.py:56 _mm_kernel
// (dual=False: entry takum_matmul :166; dual=True: entry takum_dual_matmul
// :227) for the flat formats and the mx payloads (its `mx` branch, :61-80,
// :111-132), with either codec (IMPL kBits, or kLut: its `lut` branch,
// :139-142), and its out_fmt epilogue (:96-106).  The TPU kernel carries an
// f32 accumulator tile in VMEM across a sequential K grid axis; here each
// block owns one output tile and loops over K itself, keeping the
// accumulators in registers.
//
// Per K step a block stages an X tile and a w-bits tile, decoded by K0 into
// shared memory, then every thread runs TM x TN f32 FMAs per k.  XMODE says
// how X loads: kXF32, kXBF16 (K3) or kXWire (K4: the bits of FMT, decoded by
// the same elem_decode<FMT, IMPL> as the w tile; an mx x is a payload
// [M, K/32*33] blocked along K, element k scaled by its group's byte at
// (k/32)*33, as K3-mx reads w along N).  Out-of-range M/N lanes are never
// stored; K-edge lanes are zero on BOTH operands, so a NaN in padding can
// never meet a 0.  No tensor cores: decoded t16 values carry up to 11
// fraction bits and TF32 holds 10, so TF32 would round the weights.
//
// Bound on the H100: at the prefill's M = 1024 the products (67 TFLOP/s
// f32 outside the tensor cores; 989 bf16 where both operands are exact in
// bf16); at K4's M = 4 the weight bytes (K*N*1 or 2 bytes at 3.35 TB/s),
// which this loop does not reach (one 1 KiB w tile in flight per block).
// Two tilings: a 64 x 64 tile for large M and an 8 x 32 tile for K4's small
// M, which keeps more blocks in flight over N when a 64-row tile would be
// mostly padding.  Both add the k terms of each output in the same
// ascending order, so every output is the same either way.
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
//
// WT (K5's backward above M = 16, takum_matmul_wt.cu): the weight is stored
// transposed, w_bits[N, K] row-major, and the kernel computes
// X @ decode(w_bits)^T without copying it: element (k, n) is read at w[n * K + k] (the index in
// 64 bits).  The w tile is then filled with the thread index running along
// k (kk = i % BK), so that neighbouring threads read neighbouring bytes of
// one stored row; the shared tile's rows are padded by 32 / BK floats, which
// spreads the column a warp stores (BK k's of 32 / BK n's) over all 32
// banks.  The K loop, and so every output, is the same as the unfused
// launch over a copy of w_bits^T; flat formats only (an mx payload's scale
// bytes are bound to blocks of the stored last axis).
//
// FUSED (out_fmt): the same tile and the same K loop as the unfused launch
// of the same shape; only the flush differs.  The unfused instantiation
// (FUSED = false) stores the f32 accumulators; the fused one stages them in
// shared memory and calls repro::store_encoded_tile, so the packed output
// is K2's encode of exactly the values the unfused launch stores.
#pragma once

#include "codec.cuh"

namespace repro_mm {

constexpr int kThreads = 256;

enum XMode : int { kXF32 = 0, kXBF16 = 1, kXWire = 2 };

template <int FMT, int IMPL, int XMODE>
__device__ __forceinline__ float load_x(const void* x, long long gm, int gk, int K,
                                        const int* dtab) {
  if constexpr (XMODE == kXBF16) {
    return repro::bf16_decode(static_cast<const uint16_t*>(x)[gm * K + gk]);
  } else if constexpr (XMODE == kXF32) {
    return static_cast<const float*>(x)[gm * K + gk];
  } else if constexpr (repro::kIsMx<FMT>) {
    const uint8_t* row = static_cast<const uint8_t*>(x) + gm * (K / 32) * repro::kMxGroup;
    return repro::mx_decode<FMT, IMPL>(dtab, row[repro::mx_elem_at(gk)],
                                       repro::e8m0_decode(row[repro::mx_scale_at(gk)]));
  } else {
    using T = typename repro::Wire<FMT>::storage;
    return repro::elem_decode<FMT, IMPL>(dtab, static_cast<const T*>(x)[gm * K + gk]);
  }
}

template <int FMT, int IMPL, int XMODE, bool FUSED, int BM, int BN, int BK, int TM, int TN,
          bool WT = false>
__global__ void __launch_bounds__(kThreads)
mm_kernel(const void* __restrict__ x, const typename repro::Wire<FMT>::storage* __restrict__ w,
          void* __restrict__ out, int M, int N, int K, const int* __restrict__ tab,
          repro::Epilogue ep) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one thread per TM x TN sub-tile");
  static_assert(!(WT && repro::kIsMx<FMT>), "an mx payload has no transposed load");
  constexpr int kWPad = WT ? 32 / BK : 0;  // WT: rows padded off the banks of their k
  __shared__ float xs[BK][BM];  // x tile, transposed: xs[k][m]
  __shared__ float ws[BK][BN + kWPad];  // decoded weight tile
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
      xs[kk][mm] = (gm < M && gk < K) ? load_x<FMT, IMPL, XMODE>(x, gm, gk, K, dtab) : 0.0f;
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
    } else if constexpr (WT) {
      for (int i = tid; i < BK * BN; i += kThreads) {
        const int kk = i % BK, nn = i / BK;
        const int gk = k0 + kk, gn = n0 + nn;
        ws[kk][nn] = (gk < K && gn < N)
                         ? repro::elem_decode<FMT, IMPL>(dtab, w[static_cast<long long>(gn) * K + gk])
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

  if constexpr (FUSED) {
    __shared__ float os[BM][BN];  // the finished tile, for the epilogue
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) os[ty * TM + i][tx * TN + j] = acc[i][j];
    __syncthreads();
    repro::store_encoded_tile(&os[0][0], BN, min(BM, M - m0), min(BN, N - n0), out, m0, n0, ep);
  } else {
    float* o = static_cast<float*>(out);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty * TM + i;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gn = n0 + tx * TN + j;
        if (gn < N) o[static_cast<long long>(gm) * N + gn] = acc[i][j];
      }
    }
  }
}

template <int FMT, int IMPL, int XMODE, bool FUSED, int BM, int BN, int BK, int TM, int TN,
          bool WT = false>
int launch_tiled(const void* x, const void* w, void* out, int M, int N, int K, const int* tab,
                 const repro::Epilogue& ep, cudaStream_t stream) {
  using T = typename repro::Wire<FMT>::storage;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_kernel<FMT, IMPL, XMODE, FUSED, BM, BN, BK, TM, TN, WT><<<grid, kThreads, 0, stream>>>(
      x, static_cast<const T*>(w), out, M, N, K, tab, ep);
  return static_cast<int>(cudaGetLastError());
}

// K4's tile follows M alone (never the out format): M <= 16 takes the
// 8 x 32 tile, larger M the 64 x 64 tile.
template <int FMT, int IMPL, int XMODE, bool FUSED>
int launch_tile_for_m(const void* x, const void* w, void* out, int M, int N, int K,
                      const int* tab, const repro::Epilogue& ep, cudaStream_t stream) {
  if (M <= 16) {
    return launch_tiled<FMT, IMPL, XMODE, FUSED, 8, 32, 32, 1, 1>(x, w, out, M, N, K, tab, ep,
                                                                  stream);
  }
  return launch_tiled<FMT, IMPL, XMODE, FUSED, 64, 64, 16, 4, 4>(x, w, out, M, N, K, tab, ep,
                                                                 stream);
}

// K4's launch: the unfused or the fused instantiation of its tile, as `ep`
// asks.
template <int FMT, int IMPL, int XMODE>
int launch_mm_x(const void* x, const void* w, void* out, int M, int N, int K, const void* tab,
                const repro::Epilogue& ep, cudaStream_t stream) {
  const int* t = static_cast<const int*>(tab);
  if (IMPL == repro::kLut && t == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (!repro::epilogue_ok(ep)) return static_cast<int>(cudaErrorInvalidValue);
  if (ep.code == repro::kOutF32) {
    return launch_tile_for_m<FMT, IMPL, XMODE, false>(x, w, out, M, N, K, t, ep, stream);
  }
  // mx out: whole 32-element groups, which the tiles (BN 32, 64) never split
  if (ep.code >= repro::kMXE4M3 && N % repro::kMxBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_tile_for_m<FMT, IMPL, XMODE, true>(x, w, out, M, N, K, t, ep, stream);
}

}  // namespace repro_mm
