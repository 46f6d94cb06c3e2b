// The FMA tile: out[M, N] = X[M, K] @ decode(w_bits[K, N]) with f32 FMAs.
// Above M = 16 it is the loop of K4 over t16 (takum_dual_matmul.cu, whose
// two split operands would need four products per pair; X = decode(x_bits))
// and the fallback of both tensor-core tiles (fma_tile: matmul_mma.cuh for
// bf16 x and K4, matmul_wgmma.cuh for f32 x and K3's transposed launch) for
// a block that meets a value its bf16 parts do not carry exactly; K3's C
// entry keeps it launchable, unfused, for f32 x too (X = x itself), so that
// the wgmma tile's fallback can be held against it.  The loop a launch runs is the
// wrapper's choice (kernels/takum_matmul.py tile_for); M <= 16 runs the
// split-K matvec of matvec_splitk.cuh, above it bf16 x the tensor-core tile
// of matmul_mma.cuh and f32 x the wgmma tile of matmul_wgmma.cuh.
//
// Replaces, for those launches, the Pallas kernel
// src/repro/kernels/takum_matmul.py:56 _mm_kernel (dual=True: entry
// takum_dual_matmul :227; as the fallback also dual=False, entry
// takum_matmul :166, and the backward rule :211) for the flat
// formats and the mx payloads (its `mx` branch, :61-80, :111-132), with
// either codec (IMPL kBits, or kLut: its `lut` branch, :139-142), and its
// out_fmt epilogue (:96-106).  The TPU kernel carries an f32 accumulator
// tile in VMEM across a sequential K grid axis; here each block owns one
// 64 x 64 output tile and loops over K itself, keeping the accumulators in
// registers.
//
// Per K step (BK = 16) a block stages an X tile and a w-bits tile, decoded
// by K0 into shared memory, then every thread runs 4 x 4 f32 FMAs per k
// into a fresh partial, added to its running sums once per step: a blocked
// order, K / 16 adds per output in series rather than K (the serial order
// moved more of takum8's prefill K/V across a t8 rounding boundary than the
// plain path's).  XMODE says how X loads: kXF32, kXBF16 (the tensor-core
// tile's fallback) or kXWire (K4: the bits of FMT, decoded by the same
// elem_decode<FMT, IMPL> as the w tile; an mx x is a payload
// [M, K/32*33] blocked along K, element k scaled by its group's byte at
// (k/32)*33, as K3-mx reads w along N).  Out-of-range M/N lanes are never
// stored; K-edge lanes are zero on BOTH operands, so a NaN in padding can
// never meet a 0.  No tensor cores here: K4's t16 operands would each need
// their hi/lo split (four products a pair), and the fallback exists for the
// values no bf16 parts carry.  An f32 x runs on the tensor cores through its
// exact three-way bf16 split (matmul_wgmma.cuh).
//
// Bound on the H100: the products at 67 TFLOP/s f32 outside the tensor
// cores (at M = 1024 over 4096 x 14336: 1.795 ms).  The loop issues 8
// shared loads per 16 FMAs per k and reaches about 30 % of that rate
// (K5's backward on it took 6.7 ms t8, 8.9 ms t16 on an H100, PERF.md §6).
//
// An mx weight is the payload [K, ceil(N/32)*33], blocked along N: row k
// holds the groups [s, e0..e31] of columns 32g..32g+31.  N need not be a
// multiple of 32; the padded columns of the last group are never decoded or
// stored.  Each K step first stages the tile's (k, group) scales in shared
// memory, one load per pair (two groups per weight row), then decodes every
// element byte under its staged scale.
//
// lut: an 8-bit decode table (1 KiB) is copied into shared memory once,
// before the K loop (one more __syncthreads); the t16/bf16 tables (256 KiB)
// are read from global memory through __ldg.  The decoded values equal the
// bits decode's and the k terms are added in the same order, so the two
// codecs give the same output bit for bit.
//
// WT (fma_tile only: the fallback of K5's backward above M = 16 on the
// wgmma tile, takum_matmul_wt.cu): the weight is stored transposed,
// w_bits[N, K] row-major, and the pass computes X @ decode(w_bits)^T
// without copying it: element (k, n) is read at w[n * K + k] (the index in
// 64 bits).  The w tile is then filled with the thread index running along
// k (kk = i % BK), so that neighbouring threads read neighbouring bytes of
// one stored row; the shared tile's rows are padded by 32 / BK floats, which
// spreads the column a warp stores (BK k's of 32 / BK n's) over all 32
// banks.  The K loop, and so every output, is the same as the pass over a
// copy of w_bits^T; flat formats only (an mx payload's scale
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

// A barrier of threads 0 .. NT - 1: __syncthreads for BAR 0 (the whole
// block), else named barrier BAR over those NT threads (a warp-specialised
// kernel's consumers, matmul_wgmma.cuh).
template <int BAR, int NT>
__device__ __forceinline__ void block_sync() {
  if constexpr (BAR == 0) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"n"(BAR), "n"(NT) : "memory");
  }
}

// The shared memory of one fma_tile pass.
template <int BM, int BN, int BK, bool WT>
struct FmaSmem {
  static constexpr int kWPad = WT ? 32 / BK : 0;  // WT: rows padded off the banks of their k
  float xs[BK][BM];                                // x tile, transposed: xs[k][m]
  float ws[BK][BN + kWPad];                        // decoded weight tile
  float ss[BK][BN / 32];                           // mx: the tile's (k, group) scales
};

// acc[i][j] = output (m0 + ty * TM + i, n0 + tx * TN + j) of X @ decode(w),
// for thread (tx, ty) = (tid % (BN / TN), tid / (BN / TN)).  Each BK step's
// k terms are summed, ascending, into a fresh partial that is then added to
// acc: a blocked order, K / BK adds per output in series rather than K.
// Threads 0 .. NT - 1 call it, and they alone: it holds block_sync<BAR, NT>.
template <int FMT, int IMPL, int XMODE, int BM, int BN, int BK, int TM, int TN, bool WT,
          int NT = kThreads, int BAR = 0>
__device__ __forceinline__ void fma_tile(const void* __restrict__ x,
                                         const typename repro::Wire<FMT>::storage* __restrict__ w,
                                         int M, int N, int K, const int* dtab, int m0, int n0,
                                         FmaSmem<BM, BN, BK, WT>& sm, float (&acc)[TM][TN]) {
  static_assert((BM / TM) * (BN / TN) == NT, "one thread per TM x TN sub-tile");
  static_assert(!(WT && repro::kIsMx<FMT>), "an mx payload has no transposed load");
  constexpr int kThreads = NT;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int mm = i / BK, kk = i % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      sm.xs[kk][mm] = (gm < M && gk < K) ? load_x<FMT, IMPL, XMODE>(x, gm, gk, K, dtab) : 0.0f;
    }
    if constexpr (repro::kIsMx<FMT>) {
      const long long ldw = static_cast<long long>((N + 31) / 32) * repro::kMxGroup;
      for (int i = tid; i < BK * (BN / 32); i += kThreads) {
        const int kk = i / (BN / 32), gg = i % (BN / 32);
        const int gk = k0 + kk, gn = n0 + gg * 32;
        sm.ss[kk][gg] = (gk < K && gn < N)
                            ? repro::e8m0_decode(w[gk * ldw + repro::mx_scale_at(gn)])
                            : 0.0f;
      }
      block_sync<BAR, NT>();
      for (int i = tid; i < BK * BN; i += kThreads) {
        const int kk = i / BN, nn = i % BN;
        const int gk = k0 + kk, gn = n0 + nn;
        sm.ws[kk][nn] = (gk < K && gn < N)
                            ? repro::mx_decode<FMT, IMPL>(dtab, w[gk * ldw + repro::mx_elem_at(gn)],
                                                          sm.ss[kk][nn / 32])
                            : 0.0f;
      }
    } else if constexpr (WT) {
      for (int i = tid; i < BK * BN; i += kThreads) {
        const int kk = i % BK, nn = i / BK;
        const int gk = k0 + kk, gn = n0 + nn;
        sm.ws[kk][nn] =
            (gk < K && gn < N)
                ? repro::elem_decode<FMT, IMPL>(dtab, w[static_cast<long long>(gn) * K + gk])
                : 0.0f;
      }
    } else {
      for (int i = tid; i < BK * BN; i += kThreads) {
        const int kk = i / BN, nn = i % BN;
        const int gk = k0 + kk, gn = n0 + nn;
        sm.ws[kk][nn] =
            (gk < K && gn < N)
                ? repro::elem_decode<FMT, IMPL>(dtab, w[static_cast<long long>(gk) * N + gn])
                : 0.0f;
      }
    }
    block_sync<BAR, NT>();
    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sm.xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sm.ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
    block_sync<BAR, NT>();
  }
}

// The thread's TM x TN sub-tile at (r0, c0) of a row-major f32 tile `o`
// (row stride ldo), rows < rows and columns < cols only.
template <int TM, int TN>
__device__ __forceinline__ void put_sub_tile(const float (&acc)[TM][TN], float* o, long long ldo,
                                             int r0, int c0, int rows, int cols) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (r0 + i >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (c0 + j < cols) o[(r0 + i) * ldo + c0 + j] = acc[i][j];
    }
  }
}

template <int FMT, int IMPL, int XMODE, bool FUSED, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
mm_kernel(const void* __restrict__ x, const typename repro::Wire<FMT>::storage* __restrict__ w,
          void* __restrict__ out, int M, int N, int K, const int* __restrict__ tab,
          repro::Epilogue ep) {
  __shared__ FmaSmem<BM, BN, BK, false> sm;
  __shared__ int tab_s[repro::kDecodeTabInts<FMT, IMPL>];  // lut: an 8-bit decode table
  const int* dtab = repro::stage_decode_table<FMT, IMPL>(tab, tab_s);
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float acc[TM][TN];
  fma_tile<FMT, IMPL, XMODE, BM, BN, BK, TM, TN, false>(x, w, M, N, K, dtab, m0, n0, sm, acc);
  if constexpr (FUSED) {
    __shared__ float os[BM][BN];  // the finished tile, for the epilogue
    put_sub_tile(acc, &os[0][0], BN, ty * TM, tx * TN, BM, BN);
    __syncthreads();
    repro::store_encoded_tile(&os[0][0], BN, min(BM, M - m0), min(BN, N - n0), out, m0, n0, ep);
  } else {
    put_sub_tile(acc, static_cast<float*>(out) + static_cast<long long>(m0) * N + n0, N,
                 ty * TM, tx * TN, M - m0, N - n0);
  }
}

// The 64 x 64 tile's launch, unfused or (FUSED) with the out_fmt flush.
template <int FMT, int IMPL, int XMODE, bool FUSED>
int launch_tiled(const void* x, const void* w, void* out, int M, int N, int K, const int* tab,
                 const repro::Epilogue& ep, cudaStream_t stream) {
  using T = typename repro::Wire<FMT>::storage;
  const dim3 grid((N + 63) / 64, (M + 63) / 64);
  mm_kernel<FMT, IMPL, XMODE, FUSED, 64, 64, 16, 4, 4><<<grid, kThreads, 0, stream>>>(
      x, static_cast<const T*>(w), out, M, N, K, tab, ep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_mm
