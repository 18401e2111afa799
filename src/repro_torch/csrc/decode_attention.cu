// Single-query (decode) attention over a ring-buffer KV cache.
//
// Replaces: src/repro/kernels/decode_attention.py decode_attention_pallas
// (_decode_kernel).
//
// Computes, for one new token per batch row, out (B, KVp, Gp, hd) =
// softmax(q . K^T * hd^-0.5) V over the live slots of the cache (B, buf,
// KVp, hd): every slot once the ring has wrapped (pos + 1 >= buf), slots
// 0 .. pos % buf before that. The wrapper turns the absolute position into
// that count of live slots, so slots never written are never read. The
// cache is stored in bfloat16, float8_e4m3fn or float32 and upcast to f32
// on load; scores, the online-softmax statistics and the output
// accumulator stay in f32.
//
// What bounds it on an H100: the K and V bytes of the live slots, read
// once per step, over 3.35 TB/s -- a few FLOPs per byte.
//
// What the design does about it: one CTA per (batch row, kv head) holds
// that head's whole query group (Gp rows) and streams the cache in 32-slot
// tiles through shared memory, so K/V are read from device memory exactly
// once per group and never repeated per query head; the (Gp, buf) score
// row never leaves shared memory. A grid of only B*KVp CTAs leaves most of
// the 132 SMs idle at batch 1..4 (8 CTAs for smollm-135m at batch 2); the
// flash-decoding split of the cache axis over CTAs, with a second
// reduction pass, is the later fix.
#include "common.cuh"

namespace {

constexpr int kBlockKV = 32;
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

template <typename TQ, typename TC>
__global__ void __launch_bounds__(kThreads)
    decode_attn_kernel(const TQ* __restrict__ q, const TC* __restrict__ ck,
                       const TC* __restrict__ cv, TQ* __restrict__ out,
                       int buf, int kvp, int gp, int hd, int n_valid,
                       float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                          // (gp, hd)
  float* acc = qs + gp * hd;                 // (gp, hd)
  float* ks = acc + gp * hd;                 // (kBlockKV, hd + 1)
  float* vs = ks + kBlockKV * (hd + 1);      // (kBlockKV, hd)
  float* sc = vs + kBlockKV * hd;            // (gp, kBlockKV)
  float* m = sc + gp * kBlockKV;             // (gp,)
  float* l = m + gp;                         // (gp,)
  float* corr = l + gp;                      // (gp,)

  const int tid = threadIdx.x;
  const int b = blockIdx.x / kvp;
  const int h = blockIdx.x % kvp;
  const size_t q_off = static_cast<size_t>(blockIdx.x) * gp * hd;

  for (int i = tid; i < gp * hd; i += kThreads) {
    qs[i] = repro::to_f32(q[q_off + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < gp; g += kThreads) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  for (int j0 = 0; j0 < n_valid; j0 += kBlockKV) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < kBlockKV * hd; i += kThreads) {
      const int j = i / hd, d = i % hd;
      const int slot = j0 + j;
      float kv = 0.f, vv = 0.f;
      if (slot < n_valid) {
        const size_t off =
            ((static_cast<size_t>(b) * buf + slot) * kvp + h) * hd + d;
        kv = repro::to_f32(ck[off]);
        vv = repro::to_f32(cv[off]);
      }
      ks[j * (hd + 1) + d] = kv;
      vs[j * hd + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < gp * kBlockKV; i += kThreads) {
      const int g = i / kBlockKV, j = i % kBlockKV;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qs[g * hd + d], ks[j * (hd + 1) + d], s);
      sc[i] = (j0 + j < n_valid) ? s * scale : kNegInf;
    }
    __syncthreads();
    for (int g = tid; g < gp; g += kThreads) {
      float mx = m[g];
      for (int j = 0; j < kBlockKV; ++j) mx = fmaxf(mx, sc[g * kBlockKV + j]);
      float sum = 0.f;
      for (int j = 0; j < kBlockKV; ++j) {
        const float p = expf(sc[g * kBlockKV + j] - mx);
        sc[g * kBlockKV + j] = p;
        sum += p;
      }
      const float c = expf(m[g] - mx);
      corr[g] = c;
      l[g] = l[g] * c + sum;
      m[g] = mx;
    }
    __syncthreads();
    for (int i = tid; i < gp * hd; i += kThreads) {
      const int g = i / hd, d = i % hd;
      float a = acc[i] * corr[g];
      for (int j = 0; j < kBlockKV; ++j)
        a = fmaf(sc[g * kBlockKV + j], vs[j * hd + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < gp * hd; i += kThreads)
    out[q_off + i] =
        repro::from_f32<TQ>(acc[i] / fmaxf(l[i / hd], 1e-30f));
}

template <typename TQ, typename TC>
cudaError_t launch(const void* q, const void* ck, const void* cv, void* out,
                   int batch, int buf, int kvp, int gp, int hd, int n_valid,
                   float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * gp * hd + kBlockKV * (hd + 1) + kBlockKV * hd +
                       gp * kBlockKV + 3 * gp);
  auto kernel = decode_attn_kernel<TQ, TC>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<batch * kvp, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(ck),
      static_cast<const TC*>(cv), static_cast<TQ*>(out), buf, kvp, gp, hd,
      n_valid, scale);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_cache(int cache_dtype, const void* q, const void* ck,
                         const void* cv, void* out, int batch, int buf,
                         int kvp, int gp, int hd, int n_valid, float scale,
                         cudaStream_t stream) {
  switch (cache_dtype) {
    case repro::kF32:
      return launch<TQ, float>(q, ck, cv, out, batch, buf, kvp, gp, hd,
                               n_valid, scale, stream);
    case repro::kBF16:
      return launch<TQ, __nv_bfloat16>(q, ck, cv, out, batch, buf, kvp, gp,
                                       hd, n_valid, scale, stream);
    case repro::kF8E4M3:
      return launch<TQ, __nv_fp8_e4m3>(q, ck, cv, out, batch, buf, kvp, gp,
                                       hd, n_valid, scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q/out (B, KVp, Gp, hd) float32/bfloat16; ck/cv (B, buf, KVp, hd) in
// cache_dtype; n_valid the live slots (1..buf). Returns cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* ck,
                                       const void* cv, void* out, int batch,
                                       int buf, int kvp, int gp, int hd,
                                       int n_valid, float scale, int q_dtype,
                                       int cache_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (q_dtype == repro::kF32)
    return launch_cache<float>(cache_dtype, q, ck, cv, out, batch, buf, kvp,
                               gp, hd, n_valid, scale, s);
  if (q_dtype == repro::kBF16)
    return launch_cache<__nv_bfloat16>(cache_dtype, q, ck, cv, out, batch,
                                       buf, kvp, gp, hd, n_valid, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
