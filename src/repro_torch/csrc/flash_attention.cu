// Causal flash attention (forward) with grouped-query heads.
//
// Replaces: src/repro/kernels/flash_attention.py flash_attention
// (_flash_kernel).
//
// Computes out (B, S, KV, G, hd) = causal softmax(q . k^T * hd^-0.5) v for
// q (B, S, KV, G, hd) and k/v (B, S, KV, hd), in the grouped layout the
// model keeps (padded heads included): query head (kv, g) reads kv head
// kv, and K/V are never repeated per query head. Scores, the online-softmax
// statistics and the output accumulator are f32.
//
// What bounds it on an H100: at the calibration shapes (S = 128, hd = 64)
// the work is 4*S*S/2*hd operations per head against 4*S*hd bytes of
// q/k/v/out per head, so the operations bound it -- but only through the
// tensor cores, which this first version does not use.
//
// What the design does about it: one CTA per (q block of 64 rows, query
// head) keeps its Q tile, the 64 x 64 score tile, the softmax statistics
// and the accumulator on chip and walks k blocks only up to the causal
// limit (blocks the mask covers entirely are never loaded), so device
// memory sees q/k/v/out once per CTA and no score ever leaves the SM. Four
// threads share a query row: each holds 16 of its scores and HD/4 of its
// output columns in registers, with the row max and sum reduced by warp
// shuffles. S need not be a block multiple: the tail rows and columns are
// masked. The products run as f32 FMAs on the CUDA cores; wgmma on bf16
// tiles is the later fix that moves it toward the operation bound.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 4 threads per query row
constexpr float kNegInf = -1e30f;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, int S,
                      int KV, int G, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                      // (kBQ, HD + 1)
  float* ks = qs + kBQ * (HD + 1);       // (kBK, HD + 1)
  float* vs = ks + kBK * (HD + 1);       // (kBK, HD)
  float* ps = vs + kBK * HD;             // (kBQ, kBK + 1)

  const int tid = threadIdx.x;
  const int r = tid / 4;    // query row within the block
  const int sub = tid % 4;  // owns score columns sub + 4i, output dims sub + 4i
  const int q0 = blockIdx.x * kBQ;
  const int g = blockIdx.y;
  const int b = blockIdx.z / KV;
  const int h = blockIdx.z % KV;
  // row strides of the grouped layouts
  const size_t q_row = static_cast<size_t>(KV) * G * HD;
  const size_t kv_row = static_cast<size_t>(KV) * HD;
  const T* qb = q + static_cast<size_t>(b) * S * q_row + (h * G + g) * HD;
  T* ob = out + static_cast<size_t>(b) * S * q_row + (h * G + g) * HD;
  const T* kb = k + static_cast<size_t>(b) * S * kv_row + h * HD;
  const T* vb = v + static_cast<size_t>(b) * S * kv_row + h * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int rr = i / HD, d = i % HD;
    const int s = q0 + rr;
    qs[rr * (HD + 1) + d] = s < S ? repro::to_f32(qb[s * q_row + d]) : 0.f;
  }

  constexpr int NC = kBK / 4;  // score columns per thread
  constexpr int ND = HD / 4;   // output dims per thread
  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;
  const int qpos = q0 + r;
  // causal limit: k blocks that start at or before the block's last row
  const int last = min(q0 + kBQ, S) - 1;
  const int n_kb = last / kBK + 1;

  for (int kbi = 0; kbi < n_kb; ++kbi) {
    const int k0 = kbi * kBK;
    __syncthreads();  // previous K/V/P tiles fully consumed
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int j = i / HD, d = i % HD;
      const int s = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (s < S) {
        kv = repro::to_f32(kb[s * kv_row + d]);
        vv = repro::to_f32(vb[s * kv_row + d]);
      }
      ks[j * (HD + 1) + d] = kv;
      vs[j * HD + d] = vv;
    }
    __syncthreads();

    float sv[NC];
    float mx = m;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = sub + 4 * i;
      const int kpos = k0 + c;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d)
        s = fmaf(qs[r * (HD + 1) + d], ks[c * (HD + 1) + d], s);
      s = (kpos <= qpos && kpos < S) ? s * scale : kNegInf;
      sv[i] = s;
      mx = fmaxf(mx, s);
    }
    // the row's 4 threads are adjacent lanes of one warp
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float p = expf(sv[i] - mx);
      ps[r * (kBK + 1) + sub + 4 * i] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float corr = expf(m - mx);
    l = l * corr + sum;
    m = mx;
    __syncwarp();  // the row's probabilities are visible to its 4 threads
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] *= corr;
    for (int j = 0; j < kBK; ++j) {
      const float p = ps[r * (kBK + 1) + j];
#pragma unroll
      for (int i = 0; i < ND; ++i)
        acc[i] = fmaf(p, vs[j * HD + sub + 4 * i], acc[i]);
    }
  }

  if (qpos < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < ND; ++i)
      ob[qpos * q_row + sub + 4 * i] = repro::from_f32<T>(acc[i] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int KV, int G, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBQ * (HD + 1) + kBK * (HD + 1) +
                                       kBK * HD + kBQ * (kBK + 1));
  auto kernel = flash_attn_kernel<T, HD>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, G, B * KV);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, KV, G, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* out, int B, int S, int KV, int G, float scale,
                      cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, KV, G, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, KV, G, scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q/out (B, S, KV, G, hd), k/v (B, S, KV, hd), all float32 or all
// bfloat16 (dtype), hd 64 or 128. Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int KV, int G, int hd, float scale,
                                      int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch_hd<float>(hd, q, k, v, out, B, S, KV, G, scale, s);
  if (dtype == repro::kBF16)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, out, B, S, KV, G, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
