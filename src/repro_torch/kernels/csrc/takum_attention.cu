// K6: one-token GQA decode attention over a packed KV cache.
//
// Replaces the Pallas kernel src/repro/kernels/takum_attention.py:56
// _decode_attn_kernel (entry takum_decode_attention :141) for the flat
// formats (an f32 cache too: its fmt="f32", 4-byte rows, 512 B at D = 128)
// and the mx payloads (its payload path, :61, :82-99, :167-186),
// with either codec (IMPL kBits, or kLut: its `lut` branch, :201-204) and
// its out_fmt epilogue (:120-132), and adds what the model
// computes around it in jnp (src/repro/models/transformer.py:484-498): the
// `length` bound (key position < length, i.e. kpos <= pos) over a
// preallocated cache, the sliding `window` and `attn_softcap`.
//
// Split S, then combine in a fixed order.  The TPU kernel walks S as a
// sequential grid axis with (max, denom, acc) in VMEM scratch.  Here the
// grid is (kv head, batch row, split): the valid keys are the contiguous
// range [lo, length), lo = max(0, length - window) with a window, else 0,
// and the host (attention_plan in kernels/takum_attention.py) cuts
// [begin, length), begin = lo rounded down to a tile, into `splits` chunks
// of `chunk` keys (a multiple of the kTileS-key tile) so that the grid holds
// at least 264 blocks (two per SM) at the serving shape: B = 4, Hkv = 8,
// S = 288 gives 9 chunks of 32 keys, 288 blocks.  A block serves the
// g = H / Hkv query rows of its kv head over its chunk, tile by tile, with
// an online softmax in shared memory, and writes its partial (max m, denom
// l, unnormalised acc[g][D]) to an f32 workspace the wrapper allocates.
// combine_kernel then forms, per (kv head, batch row), m = max over splits
// and out = sum e^(m_i - m) acc_i / sum e^(m_i - m) l_i, adding splits 0..S-1
// left to right (no atomics: the same bits every run); a split with no
// valid key (m_i = -inf) adds nothing and never forms -inf - (-inf).
// attn_softcap is applied to each logit before any max.
//
// Loads: each tile's K and V rows (one (position, kv head) row each, D
// elements, or ceil(D/32) 33-byte mx groups) are staged as the aligned
// 16-byte chunks that cover them (codec.cuh stage_chunk), cp.async into a
// two-deep ring, so the next tile's bytes are in flight while this one is
// decoded into f32 and used.  K and V are read through element strides, so
// the model passes its [B, S, Hkv, d] cache slice as a permuted
// [B, Hkv, S, d] view with no copy (the d axis must be unit-stride).
// Invalid keys in a tile get logit -inf (weight 0) and their V rows 0.0.
//
// An mx cache row is the payload of one (position, kv head): ceil(D/32)
// groups [s, e0..e31], 132 B at D = 128.  Element j is read as a byte at
// mx_elem_at(j) and scaled by the byte at mx_scale_at(j).  D need not be a
// multiple of 32: only j < D is read, so the padded lanes of the last group
// are dropped, as the reference drops them.
//
// lut: an 8-bit decode table (1 KiB) sits in the dynamic shared memory,
// which launch_attn sizes for it, and is copied in once per block; the
// t16/bf16 tables (256 KiB) are read from global memory through __ldg.
// Decoded values and summation order equal the bits codec's, so the output
// is the same bit for bit.
//
// out_fmt: the fused combine stages its finished [g, D] tile in shared
// memory and hands it to repro::store_encoded_tile: the packed [B, H, D] (an
// mx out: [B, H, D/32*33], D a multiple of 32, only the D real lanes
// encoded) is K2's encode of exactly what the unfused combine stores.
//
// Bound on the H100: bytes, each valid key's K and V row read once (at the
// serving shape 0.0007 ms for t8), so in practice the latency of two
// launches: the split grid puts every chunk on the card at once, and each
// block's loads are 16-byte chunks already in flight.
#include <cmath>

#include "codec.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kTileS = 32;     // keys per tile: one per lane in the row update

// bytes of one K or V row: D elements, or an mx row's ceil(D/32) groups
template <int FMT>
__host__ __device__ int kv_row_bytes(int D) {
  if constexpr (repro::kIsMx<FMT>) {
    return (D + 31) / 32 * repro::kMxGroup;
  } else {
    return D * static_cast<int>(sizeof(typename repro::Wire<FMT>::storage));
  }
}

// element j of a staged K/V row (its first byte at `row`), decoded
template <int FMT, int IMPL>
__device__ __forceinline__ float kv_decode(const int* dtab, const uint8_t* row, int j) {
  if constexpr (repro::kIsMx<FMT>) {
    return repro::mx_decode<FMT, IMPL>(dtab, row[repro::mx_elem_at(j)],
                                       repro::e8m0_decode(row[repro::mx_scale_at(j)]));
  } else {
    using T = typename repro::Wire<FMT>::storage;
    return repro::elem_decode<FMT, IMPL>(dtab, reinterpret_cast<const T*>(row)[j]);
  }
}

// Shared memory of split_kernel: the staged ring (2 tiles of K and V rows),
// then the float regions, then the 8-bit lut table (none for kBits and for
// the 16-bit tables, which are read from global memory).
template <int FMT, int IMPL>
size_t split_smem(int g, int D) {
  constexpr int kTabInts = repro::kDecodeTabInts<FMT, IMPL> == 256 ? 256 : 0;
  const int pitch = 16 * repro::span_chunks(kv_row_bytes<FMT>(D));
  return static_cast<size_t>(2 * 2 * kTileS * pitch) +
         sizeof(float) * (2 * g * D + kTileS * (D + 1) + kTileS * D + g * kTileS + 3 * g) +
         sizeof(int) * kTabInts;
}

template <int FMT, int IMPL>
__global__ void __launch_bounds__(kThreads)
split_kernel(const float* __restrict__ q, const typename repro::Wire<FMT>::storage* __restrict__ k,
             const typename repro::Wire<FMT>::storage* __restrict__ v, float* __restrict__ ws,
             int H, int Hkv, int D, long long ksb, long long ksh, long long kss, long long vsb,
             long long vsh, long long vss, int length, int window, int begin, int chunk,
             float scale, float softcap, const int* __restrict__ tab) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int g = H / Hkv;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int row_bytes = kv_row_bytes<FMT>(D);
  const int pitch = 16 * repro::span_chunks(row_bytes);
  const int nch = pitch / 16;
  const int ldk = D + 1;  // padded K rows: the logit loop reads across rows
  uint8_t* ring = smem;                                           // [2][K, V][kTileS][pitch]
  float* q_s = reinterpret_cast<float*>(smem + 2 * 2 * kTileS * pitch);  // [g][D]
  float* acc_s = q_s + g * D;             // [g][D]
  float* k_s = acc_s + g * D;             // [kTileS][D + 1]
  float* v_s = k_s + kTileS * ldk;        // [kTileS][D]
  float* p_s = v_s + kTileS * D;          // [g][kTileS]
  float* m_s = p_s + g * kTileS;          // [g] running max
  float* l_s = m_s + g;                   // [g] running denominator
  float* a_s = l_s + g;                   // [g] rescale of this tile
  int* tab_s = reinterpret_cast<int*>(a_s + g);  // lut: [256] an 8-bit decode table
  const int* dtab = repro::stage_decode_table<FMT, IMPL>(tab, tab_s);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const float* qb = q + (static_cast<long long>(b) * H + static_cast<long long>(h) * g) * D;
  const int lo = window > 0 ? max(0, length - window) : 0;
  const int c0 = begin + split * chunk;
  const int c1 = min(length, c0 + chunk);
  const int ntiles = c1 > c0 ? (c1 - c0 + kTileS - 1) / kTileS : 0;
  const auto* kb = k + b * ksb + h * ksh;
  const auto* vb = v + b * vsb + h * vsh;
  // the first global byte of key kp's K row (which 0) or V row (which 1)
  auto row_at = [&](int which, int kp) -> const uint8_t* {
    return reinterpret_cast<const uint8_t*>(which ? vb + kp * vss : kb + kp * kss);
  };
  auto fetch = [&](int t) {
    uint8_t* buf = ring + (t % 2) * 2 * kTileS * pitch;
    const int s0 = c0 + t * kTileS;
    for (int slot = tid; slot < 2 * kTileS * nch; slot += kThreads) {
      const int line = slot / nch;  // which * kTileS + row
      const int kp = s0 + line % kTileS;
      if (kp < c1) {
        repro::stage_chunk(buf + line * pitch, row_at(line / kTileS, kp), row_bytes, slot % nch);
      }
    }
  };

  if (ntiles > 0) fetch(0);
  repro::cp_async_commit();
  for (int i = tid; i < g * D; i += kThreads) {
    q_s[i] = qb[i];
    acc_s[i] = 0.0f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.0f;
  }

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) fetch(t + 1);
    repro::cp_async_commit();
    repro::cp_async_wait<1>();
    __syncthreads();
    const uint8_t* buf = ring + (t % 2) * 2 * kTileS * pitch;
    const int s0 = c0 + t * kTileS;
    // a warp per key row: where the row starts in its staged line, once
    for (int s = warp; s < kTileS; s += kThreads / 32) {
      const int kp = s0 + s;
      if (kp >= lo && kp < c1) {
        const uint8_t* kr = buf + s * pitch + repro::span_offset(row_at(0, kp));
        const uint8_t* vr = buf + (kTileS + s) * pitch + repro::span_offset(row_at(1, kp));
        for (int j = lane; j < D; j += 32) {
          k_s[s * ldk + j] = kv_decode<FMT, IMPL>(dtab, kr, j);
          v_s[s * D + j] = kv_decode<FMT, IMPL>(dtab, vr, j);
        }
      } else {
        for (int j = lane; j < D; j += 32) {
          k_s[s * ldk + j] = 0.0f;
          v_s[s * D + j] = 0.0f;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < g * kTileS; i += kThreads) {
      const int r = i / kTileS, s = i % kTileS;
      const int kp = s0 + s;
      float logit = -INFINITY;
      if (kp >= lo && kp < c1) {
        // four interleaved partial sums: a quarter of the serial FMA chain
        const float* qr = q_s + r * D;
        const float* kr = k_s + s * ldk;
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        int j = 0;
        for (; j + 4 <= D; j += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u) d[u] = fmaf(qr[j + u], kr[j + u], d[u]);
        }
        for (; j < D; ++j) d[0] = fmaf(qr[j], kr[j], d[0]);
        logit = ((d[0] + d[1]) + (d[2] + d[3])) * scale;
        if (softcap > 0.0f) logit = softcap * tanhf(logit / softcap);
      }
      p_s[i] = logit;
    }
    __syncthreads();
    for (int r = warp; r < g; r += kThreads / 32) {
      const float logit = p_s[r * kTileS + lane];
      float mx = logit;
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = logit == -INFINITY ? 0.0f : expf(logit - m_new);
      float sum = p;
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
      p_s[r * kTileS + lane] = p;
      __syncwarp();
      if (lane == 0) {
        // 0 until a valid key was seen (acc and l are 0 then): never -inf - -inf
        const float alpha = m_prev == -INFINITY ? 0.0f : expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < g * D; i += kThreads) {
      const int r = i / D, j = i % D;
      float a = acc_s[i] * a_s[r];
      for (int s = 0; s < kTileS; ++s) a = fmaf(p_s[r * kTileS + s], v_s[s * D + j], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  // the partial: rows [g][D + 2] = acc, m, l
  float* wp = ws + ((static_cast<long long>(b) * Hkv + h) * gridDim.z + split) * g * (D + 2);
  for (int i = tid; i < g * D; i += kThreads) wp[(i / D) * (D + 2) + i % D] = acc_s[i];
  for (int r = tid; r < g; r += kThreads) {
    wp[r * (D + 2) + D] = m_s[r];
    wp[r * (D + 2) + D + 1] = l_s[r];
  }
}

// out = sum_i e^(m_i - m) acc_i / sum_i e^(m_i - m) l_i over the splits of one
// (kv head, batch row), added 0..S-1 left to right; f32 out, or (FUSED) the
// [g, D] tile encoded by repro::store_encoded_tile
template <bool FUSED>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ ws, void* __restrict__ out, int H, int Hkv, int D,
               int splits, repro::Epilogue ep) {
  extern __shared__ float tile[];  // FUSED: [g][D]
  const int g = H / Hkv;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const long long rs = D + 2;
  const float* wp = ws + (static_cast<long long>(b) * Hkv + h) * splits * g * rs;
  const long long row0 = static_cast<long long>(b) * H + static_cast<long long>(h) * g;
  for (int i = threadIdx.x; i < g * D; i += kThreads) {
    const int r = i / D, j = i % D;
    float m = -INFINITY;
    for (int s = 0; s < splits; ++s) m = fmaxf(m, wp[(s * g + r) * rs + D]);
    float a = 0.0f, l = 0.0f;
    bool first = true;
    for (int s = 0; s < splits; ++s) {
      const float* p = wp + (s * g + r) * rs;
      const float ms = p[D];
      if (ms == -INFINITY) continue;  // no valid key in this split: it adds nothing
      const float e = expf(ms - m);
      if (first) {
        a = e * p[j];
        l = e * p[D + 1];
        first = false;
      } else {
        a = fmaf(e, p[j], a);
        l = fmaf(e, p[D + 1], l);
      }
    }
    const float o = a / l;
    if constexpr (FUSED) {
      tile[i] = o;
    } else {
      static_cast<float*>(out)[(row0 + r) * D + j] = o;
    }
  }
  if constexpr (FUSED) {
    __syncthreads();
    repro::store_encoded_tile(tile, D, g, D, out, row0, 0, ep);
  }
}

// dynamic shared memory above 48 KiB needs the kernel's opt-in
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int FMT, int IMPL>
int launch_attn_as(const void* q, const void* k, const void* v, void* out, float* ws, int B, int H,
                   int Hkv, int D, long long ksb, long long ksh, long long kss, long long vsb,
                   long long vsh, long long vss, int length, int window, int begin, int chunk,
                   int splits, float scale, float softcap, const void* tab,
                   const repro::Epilogue& ep, cudaStream_t stream) {
  using T = typename repro::Wire<FMT>::storage;
  const int* t = static_cast<const int*>(tab);
  if (IMPL == repro::kLut && t == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (!repro::epilogue_ok(ep)) return static_cast<int>(cudaErrorInvalidValue);
  if (ep.code >= repro::kMXE4M3 && D % repro::kMxBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the plan: tile-aligned chunks from a tile at or below lo through length
  const int lo = window > 0 ? max(0, length - window) : 0;
  if (ws == nullptr || chunk < kTileS || chunk % kTileS || begin < 0 || begin % kTileS ||
      begin > lo || splits < 1 || splits > 65535 ||
      static_cast<long long>(splits) * chunk < length - begin) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int g = H / Hkv;
  const size_t smem = split_smem<FMT, IMPL>(g, D);
  cudaError_t err = allow_smem(split_kernel<FMT, IMPL>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  split_kernel<FMT, IMPL><<<dim3(Hkv, B, splits), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k), static_cast<const T*>(v), ws, H,
      Hkv, D, ksb, ksh, kss, vsb, vsh, vss, length, window, begin, chunk, scale, softcap, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ep.code == repro::kOutF32) {
    combine_kernel<false><<<dim3(Hkv, B), kThreads, 0, stream>>>(ws, out, H, Hkv, D, splits, ep);
  } else {
    const size_t tile = sizeof(float) * g * D;
    err = allow_smem(combine_kernel<true>, tile);
    if (err != cudaSuccess) return static_cast<int>(err);
    combine_kernel<true><<<dim3(Hkv, B), kThreads, tile, stream>>>(ws, out, H, Hkv, D, splits,
                                                                   ep);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int FMT>
int launch_attn(const void* q, const void* k, const void* v, void* out, float* ws, int B, int H,
                int Hkv, int D, long long ksb, long long ksh, long long kss, long long vsb,
                long long vsh, long long vss, int length, int window, int begin, int chunk,
                int splits, float scale, float softcap, int impl, const void* tab,
                const repro::Epilogue& ep, cudaStream_t stream) {
  REPRO_IMPL_DISPATCH(impl, repro::kHasDecodeLut<FMT>, launch_attn_as, FMT, q, k, v, out, ws,
                      B, H, Hkv, D, ksb, ksh, kss, vsb, vsh, vss, length, window, begin, chunk,
                      splits, scale, softcap, tab, ep, stream)
}

}  // namespace

// ws is the f32 workspace [B, Hkv, splits, g, D + 2] of the plan (begin,
// chunk, splits) of kernels/takum_attention.py attention_plan; impl is
// repro::Impl, tab the decode table (null for kBits); out_code is the out
// format (repro::kOutF32: f32 out), out_impl its encode codec, meta/aux its
// encode tables (null for kBits)
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v, void* out,
                                      void* ws, int B, int H, int Hkv, int D, long long ksb,
                                      long long ksh, long long kss, long long vsb, long long vsh,
                                      long long vss, int length, int window, int begin, int chunk,
                                      int splits, float scale, float softcap, int fmt, int impl,
                                      const void* tab, int out_code, int out_impl,
                                      const void* meta, const void* aux, void* stream) {
  const long long ldo =
      out_code >= repro::kMXE4M3 ? static_cast<long long>(D) / 32 * repro::kMxGroup : D;
  const repro::Epilogue ep{out_code, out_impl, static_cast<const uint32_t*>(meta),
                           static_cast<const int*>(aux), ldo};
  REPRO_WIRE_DISPATCH_F32(fmt, launch_attn, q, k, v, out, static_cast<float*>(ws), B, H, Hkv,
                          D, ksb, ksh, kss, vsb, vsh, vss, length, window, begin, chunk, splits,
                          scale, softcap, impl, tab, ep, static_cast<cudaStream_t>(stream))
}
