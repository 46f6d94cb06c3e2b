// K3 and K4 at M <= 16 (the decode step) and K3's transposed launch (K5's
// backward): a split-K matrix-vector product that streams the weight at the
// card's bandwidth.
//   out[M, N] = X[M, K] @ decode(w_bits[K, N])      (WT: decode(w_bits[N, K])^T)
// where X is x (f32, or bf16 widened) or, for K4 (XMODE kXWire), decode(x_bits).
//
// Replaces, at small M, the Pallas kernel src/repro/kernels/takum_matmul.py:56
// _mm_kernel (dual=False: entry takum_matmul :166, and the backward of
// takum_matmul_ad :190, _takum_matmul_bwd :211; dual=True: entry
// takum_dual_matmul :227).  At M <= 16 a weight
// element feeds 2 M flops, far below the card's flops per byte (about 20 in
// f32, 300 on bf16 tensor cores), so the bound is the weight bytes at
// 3.35 TB/s (t8 wi 4096 x 14336: 0.0176 ms, t16 0.035 ms) and tensor cores
// buy nothing.  Reaching it takes many bytes in flight on every SM:
//
// - Grid (ceil(N / 128), splits): a block owns 128 output columns and one
//   contiguous chunk of K.  The chunk is matvec_plan's (kernels/
//   takum_matmul.py), computed from (M, N, K, format) alone: at least 264
//   blocks (two per SM) at every decode shape, a multiple of the stage depth
//   KS, at most kXFloats / MB rows.
// - The weight streams through a kStages-deep cp.async ring in shared
//   memory.  A stage is KS rows (64 for 8-bit elements, 32 for 16-bit) of
//   the block's 128-column span, each row copied as the aligned 16-byte
//   chunks that cover it (codec.cuh stage_chunk: any alignment, so a ragged
//   N and an mx row's 33-byte groups take the same path).  Two stages stay
//   in flight while the third is decoded.  Each warp copies and waits for
//   its own rows only (KS / 8 of each stage), so warps run their rings
//   apart, with no block barrier in the loop.
// - x for the block's chunk (f32, bf16 widened, or K4's bits decoded by the
//   elem_decode<FMT, IMPL> of the weight, an mx x along K) is staged once as
//   [k][MB], rows M..MB-1 zero (MB = 4 for M <= 4, else 16).
// - The 8 warps split each stage's rows, KS / 8 each.  A lane owns four
//   columns: 4 lane .. 4 lane + 3 of a flat row, read as one 4- or 8-byte
//   word where the row's span is aligned (else element by element), or
//   lane + 32 j (j < 4) of an mx row (column j in group j, its scale byte
//   one broadcast read per warp) and under WT.  It decodes each element in
//   registers and keeps an MB x 4 f32 accumulator.  The decode is
//   elem_decode<FMT, IMPL>, except for t16 under bits: its integer decode
//   (at half rate on the INT32 lanes) bounds the loop at M = 4, so it reads
//   its regime headers' constants from a table each block computes into
//   shared memory (codec.cuh t16_decode_regime: the same bits, half the
//   integer work).
// - The sums run in one fixed order: each output adds its k terms one by one,
//   ascending, within a warp's rows; the block adds warps 0..7 left to right
//   into the f32 workspace [splits, M, N] (allocated by the wrapper); then
//   combine_kernel adds splits 0..S-1 left to right.  No atomics, so every
//   run gives the same bits, and the order never depends on the codec, so
//   lut equals bits.
// - WT: the weight is stored [N, K].  A stage copies, for each of the 128
//   output columns, the KS-element span of its stored row (contiguous
//   bytes), and a lane reads its columns down those lines.  The plan, the
//   warps' rows and every add are the untransposed launch's over a copy, so
//   the two agree bit for bit.
// - out_fmt: combine_kernel's flush goes through repro::store_encoded_tile,
//   so the fused output is K2's encode of exactly what the unfused launch
//   stores.
//
// The 8-bit lut table (1 KiB) is copied into shared memory per block; the
// 16-bit tables (256 KiB) are read through __ldg.
#pragma once

#include "matmul_tile.cuh"

namespace repro_mv {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;          // output columns per block
constexpr int kCols = kBN / 32;   // columns per lane
constexpr int kStages = 3;        // depth of the weight ring
constexpr int kXFloats = 4096;    // staged x: chunk * MB floats at most
constexpr int kMaxM = 16;
constexpr int kCombineBN = 32;    // output columns per combine block (one mx group)

// bytes per weight element (an mx element: its byte), rows per stage
template <int FMT>
inline constexpr int kEB = repro::kElemBits<FMT> / 8;
template <int FMT>
inline constexpr int kKS = kEB<FMT> == 1 ? 64 : 32;
// a staged line: a row's 128-column span (an mx row: 4 groups), or under WT
// one stored row's KS elements; its pitch rounds the span out to chunks
template <int FMT, bool WT>
inline constexpr int kSpan =
    WT ? kKS<FMT> * kEB<FMT> : (repro::kIsMx<FMT> ? kCols * repro::kMxGroup : kBN * kEB<FMT>);
template <int FMT, bool WT>
inline constexpr int kPitch = 16 * repro::span_chunks(kSpan<FMT, WT>);
template <int FMT, bool WT>
inline constexpr int kLines = WT ? kBN : kKS<FMT>;
template <int FMT, bool WT>
inline constexpr int kStageBytes = kLines<FMT, WT> * kPitch<FMT, WT>;
// a lane's four columns are adjacent (one word) in a flat untransposed row
template <int FMT, bool WT>
inline constexpr bool kWordCols = !WT && !repro::kIsMx<FMT>;
// t16 under bits decodes through its regime table (codec.cuh)
template <int FMT, int IMPL>
inline constexpr bool kRegimes = FMT == repro::kT16 && IMPL == repro::kBits;

template <int FMT, int IMPL>
__device__ __forceinline__ float decode_elem(const int* tab, const uint4* regimes, uint32_t b) {
  if constexpr (kRegimes<FMT, IMPL>) {
    return repro::t16_decode_regime(regimes, b);
  } else {
    return repro::elem_decode<FMT, IMPL>(tab, b);
  }
}

template <int FMT, bool WT>
__device__ __forceinline__ int column(int lane, int j) {
  return kWordCols<FMT, WT> ? lane * kCols + j : lane + 32 * j;
}

template <int FMT, int IMPL, int XMODE, int MB, bool WT>
__global__ void __launch_bounds__(kThreads)
matvec_kernel(const void* __restrict__ x, const uint8_t* __restrict__ w, float* __restrict__ ws,
              int M, int N, int K, int chunk, const int* __restrict__ tab) {
  using T = typename repro::Wire<FMT>::storage;
  constexpr int KS = kKS<FMT>, EB = kEB<FMT>, P = kPitch<FMT, WT>, NCH = P / 16;
  constexpr int LINES = kLines<FMT, WT>, SB = kStageBytes<FMT, WT>, RW = KS / kWarps;
  static_assert(!(WT && repro::kIsMx<FMT>), "an mx payload has no transposed load");
  static_assert(kStages * SB >= kWarps * 4 * kBN * 4, "the ring holds the warps' partials");
  __shared__ __align__(16) uint8_t ring[kStages * SB];
  __shared__ __align__(16) float xs[kXFloats];
  __shared__ int tab_s[repro::kDecodeTabInts<FMT, IMPL>];
  __shared__ uint4 regime_s[kRegimes<FMT, IMPL> ? repro::kT16Regimes : 1];
  const int* dtab = repro::stage_decode_table<FMT, IMPL>(tab, tab_s);
  const uint4* regimes = nullptr;
  if constexpr (kRegimes<FMT, IMPL>) regimes = repro::stage_t16_regimes(regime_s);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * kBN;
  const int kb = blockIdx.y * chunk;
  const int nk = max(0, min(chunk, K - kb));
  const int nst = (nk + KS - 1) / KS;
  const long long groups = (N + 31) / 32;
  const long long ldw =
      repro::kIsMx<FMT> ? groups * repro::kMxGroup : static_cast<long long>(N) * EB;

  // line li of stage s: its first global byte, and its length (0: no line)
  auto span = [&](int s, int li, int& len) -> const uint8_t* {
    if constexpr (WT) {
      const int n = n0 + li;
      len = n < N ? min(KS, nk - s * KS) * EB : 0;
      return w + (static_cast<long long>(n) * K + kb + s * KS) * EB;
    } else {
      const int r = s * KS + li;
      if constexpr (repro::kIsMx<FMT>) {
        const long long g0 = n0 / 32;
        len = r < nk ? static_cast<int>(min(static_cast<long long>(kCols), groups - g0)) *
                           repro::kMxGroup
                     : 0;
        return w + (kb + r) * ldw + g0 * repro::kMxGroup;
      } else {
        len = r < nk ? min(kBN, N - n0) * EB : 0;
        return w + (kb + r) * ldw + static_cast<long long>(n0) * EB;
      }
    }
  };
  // Untransposed, a warp copies only the lines of its own rows and waits on
  // its own copies, so the main loop needs no block barrier.  A lane's copy
  // slots (line, chunk) are the same at every stage, so their line pointers
  // are found once and move on by KS rows a stage.  Under WT every warp
  // reads every line, so the block copies them together.
  constexpr int kSlots = (RW * NCH + 31) / 32;
  const uint8_t* slot_p[kSlots];
  int slot_len = 0;  // the length of every untransposed line (row 0's)
  if constexpr (!WT) {
    int len;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) slot_p[i] = span(0, warp * RW + (lane + 32 * i) / NCH, len);
    span(0, 0, slot_len);
  }
  const long long stage_step = static_cast<long long>(KS) * ldw;
  auto fetch = [&](int s) {
    uint8_t* base = ring + (s % kStages) * SB;
    if constexpr (WT) {
      for (int slot = tid; slot < LINES * NCH; slot += kThreads) {
        int len;
        const uint8_t* p = span(s, slot / NCH, len);
        repro::stage_chunk(base + (slot / NCH) * P, p, len, slot % NCH);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int slot = lane + 32 * i;
        const int li = warp * RW + slot / NCH;
        if (slot < RW * NCH && s * KS + li < nk) {
          repro::stage_chunk(base + li * P, slot_p[i] + s * stage_step, slot_len, slot % NCH);
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) fetch(s);
    repro::cp_async_commit();
  }
  // x rows along k (coalesced reads), rows M..MB-1 zero
  for (int i = tid; i < MB * nk; i += kThreads) {
    const int m = i / nk, kk = i % nk;
    xs[kk * MB + m] = m < M ? repro_mm::load_x<FMT, IMPL, XMODE>(x, m, kb + kk, K, dtab) : 0.0f;
  }
  // untransposed: where row k's span starts in its line, (lo + k * ld) & 15
  // in 32-bit arithmetic (the low four bits survive the wrap)
  const uint32_t line_lo = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(w)) +
                           (repro::kIsMx<FMT> ? static_cast<uint32_t>(n0 / 32 * repro::kMxGroup)
                                              : static_cast<uint32_t>(n0 * EB));
  const uint32_t line_ld = static_cast<uint32_t>(ldw);
  int offj[kCols];  // WT: where column j's stored row starts in its line
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    int len;
    offj[j] = WT ? repro::span_offset(span(0, lane + 32 * j, len)) : 0;
  }
  float acc[MB][kCols];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.0f;
  __syncthreads();  // x

  for (int s = 0; s < nst; ++s) {
    if (s + kStages - 1 < nst) fetch(s + kStages - 1);
    repro::cp_async_commit();
    repro::cp_async_wait<kStages - 1>();
    if constexpr (WT) {
      __syncthreads();
    } else {
      __syncwarp();
    }
    const uint8_t* base = ring + (s % kStages) * SB;
    const int rows = min(KS, nk - s * KS);
    // unrolled at MB = 4 (the decode step); at MB = 16 one row at a time, so
    // the 64 accumulators and their FMAs are not repeated RW times in code
#pragma unroll(MB == 4 ? RW : 1)
    for (int rr = 0; rr < RW; ++rr) {
      const int r = warp * RW + rr;
      if (r >= rows) break;
      float xv[MB];
#pragma unroll
      for (int m = 0; m < MB; m += 4) {
        const float4 t = *reinterpret_cast<const float4*>(&xs[(s * KS + r) * MB + m]);
        xv[m] = t.x;
        xv[m + 1] = t.y;
        xv[m + 2] = t.z;
        xv[m + 3] = t.w;
      }
      float v[kCols];
      if constexpr (WT) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const uint8_t* e = base + (lane + 32 * j) * P + offj[j] + r * EB;
          v[j] = decode_elem<FMT, IMPL>(dtab, regimes, *reinterpret_cast<const T*>(e));
        }
      } else {
        const int off = static_cast<int>((line_lo + static_cast<uint32_t>(kb + s * KS + r) *
                                                        line_ld) & 15u);
        const uint8_t* line = base + r * P + off;
        if constexpr (repro::kIsMx<FMT>) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const uint8_t* grp = line + j * repro::kMxGroup;
            v[j] = repro::mx_decode<FMT, IMPL>(dtab, grp[1 + lane], repro::e8m0_decode(grp[0]));
          }
        } else {
          uint32_t b[kCols];
          if ((off & (kCols * EB - 1)) == 0) {  // the lane's four columns in one word
            if constexpr (EB == 1) {
              const uint32_t wd = *reinterpret_cast<const uint32_t*>(line + lane * 4);
#pragma unroll
              for (int j = 0; j < kCols; ++j) b[j] = (wd >> (8 * j)) & 0xFFu;
            } else {
              const uint2 wd = *reinterpret_cast<const uint2*>(line + lane * 8);
              b[0] = wd.x & 0xFFFFu;
              b[1] = wd.x >> 16;
              b[2] = wd.y & 0xFFFFu;
              b[3] = wd.y >> 16;
            }
          } else {
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
              b[j] = *reinterpret_cast<const T*>(line + (lane * kCols + j) * EB);
            }
          }
#pragma unroll
          for (int j = 0; j < kCols; ++j) v[j] = decode_elem<FMT, IMPL>(dtab, regimes, b[j]);
        }
      }
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[m][j] = fmaf(xv[m], v[j], acc[m][j]);
    }
    if constexpr (WT) {  // the stage's slot is copied into again two stages on
      __syncthreads();
    } else {
      __syncwarp();
    }
  }

  // warps 0..7 added left to right, four rows at a time through the ring
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int q = 0; q < MB / 4; ++q) {
    if (4 * q >= M) break;
#pragma unroll
    for (int mm = 0; mm < 4; ++mm)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        red[(warp * 4 + mm) * kBN + column<FMT, WT>(lane, j)] = acc[4 * q + mm][j];
      }
    __syncthreads();
    for (int i = tid; i < 4 * kBN; i += kThreads) {
      const int mm = i / kBN, nn = i % kBN, m = 4 * q + mm, n = n0 + nn;
      float sum = red[mm * kBN + nn];
#pragma unroll
      for (int wv = 1; wv < kWarps; ++wv) sum += red[(wv * 4 + mm) * kBN + nn];
      if (m < M && n < N) ws[(static_cast<long long>(blockIdx.y) * M + m) * N + n] = sum;
    }
    __syncthreads();
  }
}

// out[M, N] = sum of the workspace's splits, added 0..S-1 left to right; f32
// out, or (FUSED) the tile encoded by repro::store_encoded_tile
template <bool FUSED>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ ws, void* __restrict__ out, int M, int N, int splits,
               repro::Epilogue ep) {
  __shared__ float tile[kMaxM * kCombineBN];
  const int n0 = blockIdx.x * kCombineBN;
  const long long mn = static_cast<long long>(M) * N;
  for (int i = threadIdx.x; i < M * kCombineBN; i += kThreads) {
    const int m = i / kCombineBN, n = n0 + i % kCombineBN;
    float sum = 0.0f;
    if (n < N) {
      const float* p = ws + static_cast<long long>(m) * N + n;
      sum = p[0];
      int s = 1;
      for (; s + 8 <= splits; s += 8) {  // eight loads in flight, then eight adds in order
        float t[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) t[u] = p[(s + u) * mn];
#pragma unroll
        for (int u = 0; u < 8; ++u) sum += t[u];
      }
      for (; s < splits; ++s) sum += p[s * mn];
      if constexpr (!FUSED) static_cast<float*>(out)[static_cast<long long>(m) * N + n] = sum;
    }
    if constexpr (FUSED) tile[i] = sum;
  }
  if constexpr (FUSED) {
    __syncthreads();
    repro::store_encoded_tile(tile, kCombineBN, M, min(kCombineBN, N - n0), out, 0, n0, ep);
  }
}

// The split-K launch (M <= 16): chunk is the plan's, ws its [splits, M, N]
// workspace; then the combine pass, unfused or fused as ep asks.
template <int FMT, int IMPL, int XMODE, bool WT>
int launch_matvec(const void* x, const void* w, void* out, float* ws, int M, int N, int K,
                  int chunk, const int* tab, const repro::Epilogue& ep, cudaStream_t stream) {
  constexpr int KS = kKS<FMT>;
  const int mb = M <= 4 ? 4 : kMaxM;
  const int splits = K > 0 ? (K + chunk - 1) / chunk : 1;
  if (M < 1 || M > kMaxM || chunk < KS || chunk % KS || chunk * mb > kXFloats ||
      ws == nullptr || splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + kBN - 1) / kBN, splits);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  auto* kernel = mb == 4 ? matvec_kernel<FMT, IMPL, XMODE, 4, WT>
                         : matvec_kernel<FMT, IMPL, XMODE, kMaxM, WT>;
  kernel<<<grid, kThreads, 0, stream>>>(x, wb, ws, M, N, K, chunk, tab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 cgrid((N + kCombineBN - 1) / kCombineBN);
  if (ep.code == repro::kOutF32) {
    combine_kernel<false><<<cgrid, kThreads, 0, stream>>>(ws, out, M, N, splits, ep);
  } else {
    combine_kernel<true><<<cgrid, kThreads, 0, stream>>>(ws, out, M, N, splits, ep);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_mv
