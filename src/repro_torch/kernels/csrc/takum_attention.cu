// K6: one-token GQA decode attention over a packed KV cache.
//
// Replaces the Pallas kernel src/repro/kernels/takum_attention.py:56
// _decode_attn_kernel (entry takum_decode_attention :141) for the flat
// formats and the mx payloads (its payload path, :61, :82-99, :167-186),
// with either codec (IMPL kBits, or kLut: its `lut` branch, :201-204) and
// its out_fmt epilogue (:120-132), and adds what the model
// computes around it in jnp (src/repro/models/transformer.py:484-498): the
// `length` bound (key position < length, i.e. kpos <= pos) over a
// preallocated cache, the sliding `window` and `attn_softcap`.
//
// One block per (kv head, batch row) serves the g = H / Hkv query rows of
// that kv head.  The TPU kernel walks S as a sequential grid axis with
// (max, denom, acc) in VMEM scratch; here the block loops over S in tiles of
// kTileS keys itself and keeps that state in shared memory.  Only tiles that
// hold a valid key are visited: the valid keys are the contiguous range
// [lo, length), lo = max(0, length - window) with a window, else 0, so the
// first visited tile always has a finite logit and the running max is finite
// from then on.  Invalid keys in a tile get logit -inf (weight 0) and their V
// rows 0.0.  K and V are read through element strides, so the model passes
// its [B, S, Hkv, d] cache slice as a permuted [B, Hkv, S, d] view with no
// copy (the d axis must be unit-stride).
//
// An mx cache row is the payload of one (position, kv head): ceil(D/32)
// groups [s, e0..e31], 132 B at D = 128.  Element j is read as a byte at
// mx_elem_at(j) and scaled by the byte at mx_scale_at(j); the 32 lanes that
// decode one group read its scale byte as one broadcast.  D need not be a
// multiple of 32: only j < D is read, so the padded lanes of the last group
// are dropped, as the reference drops them.
//
// lut: an 8-bit decode table (1 KiB) sits at the end of the dynamic shared
// memory, which launch_attn sizes for it, and is copied in once per block;
// the t16/bf16 tables (256 KiB) are read from global memory through __ldg.
// Decoded values and summation order equal the bits codec's, so the output
// is the same bit for bit.
//
// FUSED (out_fmt): the block divides acc_s by the denominators in place,
// the same division the unfused flush stores, and hands the [g, D] tile to
// repro::store_encoded_tile: the packed [B, H, D] (an mx out: [B, H,
// D/32*33], D a multiple of 32, only the D real lanes encoded) is K2's
// encode of exactly the unfused output.  The S loop is the unfused one.
//
// Bound on the H100: bytes.  Each block reads its kv head's valid keys and
// values once (1 or 2 bytes each) and does 4 * g flops per cache byte pair;
// at B = 4, Hkv = 8 that is 32 blocks, so the kernel is latency-bound long
// before it reaches 3.35 TB/s.  Splitting S across blocks comes later.
#include <cmath>

#include "codec.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kTileS = 32;     // keys per tile: one per lane in the row update

template <int FMT, int IMPL, bool FUSED>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const float* __restrict__ q, const typename repro::Wire<FMT>::storage* __restrict__ k,
                   const typename repro::Wire<FMT>::storage* __restrict__ v, void* __restrict__ out,
                   int H, int Hkv, int D, long long ksb, long long ksh, long long kss, long long vsb,
                   long long vsh, long long vss, int length, int window, float scale, float softcap,
                   const int* __restrict__ tab, repro::Epilogue ep) {
  extern __shared__ float smem[];
  const int g = H / Hkv;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int ldk = D + 1;  // padded K rows: the logit loop reads across rows
  float* q_s = smem;                      // [g][D]
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

  for (int i = tid; i < g * D; i += kThreads) {
    q_s[i] = qb[i];
    acc_s[i] = 0.0f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.0f;
  }
  const int lo = window > 0 ? max(0, length - window) : 0;
  const auto* kb = k + b * ksb + h * ksh;
  const auto* vb = v + b * vsb + h * vsh;
  __syncthreads();

  for (int s0 = (lo / kTileS) * kTileS; s0 < length; s0 += kTileS) {
    for (int i = tid; i < kTileS * D; i += kThreads) {
      const int s = i / D, j = i % D;
      const int kp = s0 + s;
      const bool valid = kp >= lo && kp < length;
      if constexpr (repro::kIsMx<FMT>) {
        const auto* kr = kb + kp * kss;
        const auto* vr = vb + kp * vss;
        k_s[s * ldk + j] = valid ? repro::mx_decode<FMT, IMPL>(
                                       dtab, kr[repro::mx_elem_at(j)],
                                       repro::e8m0_decode(kr[repro::mx_scale_at(j)]))
                                 : 0.0f;
        v_s[s * D + j] = valid ? repro::mx_decode<FMT, IMPL>(
                                     dtab, vr[repro::mx_elem_at(j)],
                                     repro::e8m0_decode(vr[repro::mx_scale_at(j)]))
                               : 0.0f;
      } else {
        k_s[s * ldk + j] = valid ? repro::elem_decode<FMT, IMPL>(dtab, kb[kp * kss + j]) : 0.0f;
        v_s[s * D + j] = valid ? repro::elem_decode<FMT, IMPL>(dtab, vb[kp * vss + j]) : 0.0f;
      }
    }
    __syncthreads();
    for (int i = tid; i < g * kTileS; i += kThreads) {
      const int r = i / kTileS, s = i % kTileS;
      const int kp = s0 + s;
      float logit = -INFINITY;
      if (kp >= lo && kp < length) {
        float dot = 0.0f;
        for (int j = 0; j < D; ++j) dot = fmaf(q_s[r * D + j], k_s[s * ldk + j], dot);
        logit = dot * scale;
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
        const float alpha = expf(m_prev - m_new);  // 0 on the first tile
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

  const long long row0 = static_cast<long long>(b) * H + static_cast<long long>(h) * g;
  if constexpr (FUSED) {
    for (int i = tid; i < g * D; i += kThreads) acc_s[i] = acc_s[i] / l_s[i / D];
    __syncthreads();
    repro::store_encoded_tile(acc_s, D, g, D, out, row0, 0, ep);
  } else {
    float* ob = static_cast<float*>(out) + row0 * D;
    for (int i = tid; i < g * D; i += kThreads) ob[i] = acc_s[i] / l_s[i / D];
  }
}

template <int FMT, int IMPL, bool FUSED>
int launch_attn_fused(const void* q, const void* k, const void* v, void* out, int B, int H,
                      int Hkv, int D, long long ksb, long long ksh, long long kss, long long vsb,
                      long long vsh, long long vss, int length, int window, float scale,
                      float softcap, const int* t, const repro::Epilogue& ep,
                      cudaStream_t stream) {
  using T = typename repro::Wire<FMT>::storage;
  const int g = H / Hkv;
  // the float regions of the kernel, then the staged table (none for kBits
  // and for the 16-bit tables, which are read from global memory)
  constexpr int kTabInts = repro::kDecodeTabInts<FMT, IMPL> == 256 ? 256 : 0;
  const size_t smem =
      sizeof(float) * (2 * g * D + kTileS * (D + 1) + kTileS * D + g * kTileS + 3 * g) +
      sizeof(int) * kTabInts;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(decode_attn_kernel<FMT, IMPL, FUSED>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(Hkv, B);
  decode_attn_kernel<FMT, IMPL, FUSED><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k), static_cast<const T*>(v), out, H,
      Hkv, D, ksb, ksh, kss, vsb, vsh, vss, length, window, scale, softcap, t, ep);
  return static_cast<int>(cudaGetLastError());
}

// The unfused or the fused instantiation, as `ep` asks.
template <int FMT, int IMPL>
int launch_attn_as(const void* q, const void* k, const void* v, void* out, int B, int H, int Hkv,
                   int D, long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
                   long long vss, int length, int window, float scale, float softcap,
                   const void* tab, const repro::Epilogue& ep, cudaStream_t stream) {
  const int* t = static_cast<const int*>(tab);
  if (IMPL == repro::kLut && t == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (!repro::epilogue_ok(ep)) return static_cast<int>(cudaErrorInvalidValue);
  if (ep.code == repro::kOutF32) {
    return launch_attn_fused<FMT, IMPL, false>(q, k, v, out, B, H, Hkv, D, ksb, ksh, kss, vsb,
                                               vsh, vss, length, window, scale, softcap, t, ep,
                                               stream);
  }
  if (ep.code >= repro::kMXE4M3 && D % repro::kMxBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_attn_fused<FMT, IMPL, true>(q, k, v, out, B, H, Hkv, D, ksb, ksh, kss, vsb, vsh,
                                            vss, length, window, scale, softcap, t, ep, stream);
}

template <int FMT>
int launch_attn(const void* q, const void* k, const void* v, void* out, int B, int H, int Hkv,
                int D, long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
                long long vss, int length, int window, float scale, float softcap, int impl,
                const void* tab, const repro::Epilogue& ep, cudaStream_t stream) {
  REPRO_IMPL_DISPATCH(impl, true, launch_attn_as, FMT, q, k, v, out, B, H, Hkv, D, ksb, ksh, kss,
                      vsb, vsh, vss, length, window, scale, softcap, tab, ep, stream)
}

}  // namespace

// impl is repro::Impl, tab the decode table (null for kBits); out_code is
// the out format (repro::kOutF32: f32 out), out_impl its encode codec,
// meta/aux its encode tables (null for kBits)
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v, void* out, int B,
                                      int H, int Hkv, int D, long long ksb, long long ksh,
                                      long long kss, long long vsb, long long vsh, long long vss,
                                      int length, int window, float scale, float softcap, int fmt,
                                      int impl, const void* tab, int out_code, int out_impl,
                                      const void* meta, const void* aux, void* stream) {
  const long long ldo =
      out_code >= repro::kMXE4M3 ? static_cast<long long>(D) / 32 * repro::kMxGroup : D;
  const repro::Epilogue ep{out_code, out_impl, static_cast<const uint32_t*>(meta),
                           static_cast<const int*>(aux), ldo};
  REPRO_WIRE_DISPATCH(fmt, launch_attn, q, k, v, out, B, H, Hkv, D, ksb, ksh, kss, vsb, vsh, vss,
                      length, window, scale, softcap, impl, tab, ep,
                      static_cast<cudaStream_t>(stream))
}
