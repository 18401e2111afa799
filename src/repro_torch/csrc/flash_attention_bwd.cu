// Causal flash attention, backward, with grouped-query heads.
//
// Replaces: no TPU kernel. The reference has no backward kernel (there is
// no custom_vjp in src/repro/): what it differentiates for training is
// src/repro/models/attention.py _blocked_causal_attention, through XLA's
// autodiff. The port's forward is a hand-written kernel
// (csrc/flash_attention.cu), whose output autograd cannot see through, so
// its gradient is written by hand too.
//
// For q (B, S, KV, G, hd), k/v (B, S, KV, hd), the forward's out and
// row log-sum-exp lse (natural log, float32, (B, S, KV, G)) and the
// output gradient d_out (the layout of q), computes
//   P    = exp(scale q.k^T - lse), causal      (scale = hd^-0.5)
//   dV   = P^T dO                  (P rounded to the value dtype first,
//                                   as the forward rounds it before PV)
//   dP   = dO V^T,  D = rowsum(dO * O),  dS = P (dP - D)
//   dQ   = scale dS K,  dK = scale dS^T Q
// in the grouped layout, K/V never repeated per query head: the G query
// heads of a kv head add into its dK/dV. Everything is accumulated in
// float32 and written in the input dtype (float32 or bfloat16).
//
// Two kernels, launched in turn on the caller's stream:
//
// dq_kernel -- one CTA of 256 threads per (64 (s, g) rows, b, kv head),
// the rows of a position's G heads adjacent as in the forward's
// tensor-core route, so every K/V tile it loads serves all of them. It
// first computes D for its rows (and stores it for the second kernel),
// then walks the key tiles up to its last position: four threads share a
// row, each recomputes P and dP for 16 of the tile's 64 keys, writes dS
// to shared memory, and adds dS K into its quarter of the row's dQ.
//
// dkv_kernel -- one CTA per (32 keys, b, kv head) walks the query rows
// from its first key's position to the end, 64 (s, g) rows a tile: eight
// threads share a key, each recomputes P and dS for 8 of the tile's
// rows, and each then adds P dO and dS Q into its eighth of the key's dV
// and dK. The sums run in one fixed order: no atomics, so a second call
// gives the same bits.
//
// What bounds it on an H100: at smollm-135m's training shape (B 8, S 256,
// KV 4, G 4, hd 64, bf16) the causal work is 2.7 GFLOP (10 flops per
// (row, key, dim): four products and the P recomputation) against 21 MB
// read and written, so the bytes would bound a tensor-core kernel (6.3
// us at 3.35 TB/s). This one runs its products as float32 FMAs on the
// CUDA cores, from shared memory, and is far from either bound; putting
// it on mma.sync / wgmma is a later redesign (PERF.md has the times).
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::to_f32;

constexpr int kThreads = 256;
constexpr int kRows = 64;          // (s, g) rows of a Q tile
constexpr int kKeys = 64;          // keys of a K/V tile (dq_kernel)
constexpr int kRowThreads = kThreads / kRows;    // 4 threads per row
constexpr int kCtaKeys = 32;       // keys of a dkv_kernel CTA
constexpr int kKeyThreads = kThreads / kCtaKeys; // 8 threads per key

// P as the dV product takes it: rounded to the value dtype first
template <typename T>
__device__ __forceinline__ float p_for_dv(float p) {
  if constexpr (std::is_same_v<T, bf16>)
    return __bfloat162float(__float2bfloat16_rn(p));
  else
    return p;
}

// Rows R of one (b, kv) in the grouped layout: position R / G, head R % G.
struct Layout {
  int S, KV, G;
  __device__ size_t q_row(int b, int h, int R) const {  // element offset
    return ((static_cast<size_t>(b) * S + R / G) * KV + h) * G + R % G;
  }
  __device__ size_t kv_row(int b, int h, int s) const {
    return (static_cast<size_t>(b) * S + s) * KV + h;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ out,
              const float* __restrict__ lse, const T* __restrict__ dout,
              T* __restrict__ dq, float* __restrict__ delta, int S, int KV,
              int G, float scale) {
  constexpr int P = HD + 1;  // padded smem row
  extern __shared__ float smem[];
  float* qs = smem;                 // (kRows, P)
  float* dos = qs + kRows * P;      // (kRows, P)
  float* ks = dos + kRows * P;      // (kKeys, P)
  float* vs = ks + kKeys * P;       // (kKeys, P)
  float* dss = vs + kKeys * P;      // (kRows, kKeys + 1)

  const Layout lay{S, KV, G};
  const int tid = threadIdx.x;
  const int r = tid / kRowThreads, sub = tid % kRowThreads;
  const int rows = S * G;
  const int row0 = blockIdx.x * kRows;
  const int b = blockIdx.y / KV, h = blockIdx.y % KV;

  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int rr = i / HD, d = i % HD;
    const int R = row0 + rr;
    float qv = 0.f, dv = 0.f;
    if (R < rows) {
      const size_t off = lay.q_row(b, h, R) * HD + d;
      qv = to_f32(q[off]);
      dv = to_f32(dout[off]);
    }
    qs[rr * P + d] = qv;
    dos[rr * P + d] = dv;
  }

  // D = rowsum(dO * O): a quarter of the dims per thread, quad-summed
  const int R = row0 + r;
  const bool live = R < rows;
  const size_t row_off = live ? lay.q_row(b, h, R) : 0;
  float d_row = 0.f;
  if (live) {
    for (int d = sub; d < HD; d += kRowThreads)
      d_row = fmaf(to_f32(dout[row_off * HD + d]),
                   to_f32(out[row_off * HD + d]), d_row);
  }
  d_row += __shfl_xor_sync(0xffffffffu, d_row, 1);
  d_row += __shfl_xor_sync(0xffffffffu, d_row, 2);
  if (live && sub == 0) delta[row_off] = d_row;
  const float lse_row = live ? lse[row_off] : 0.f;
  const int qpos = R / G;

  constexpr int NC = kKeys / kRowThreads;  // keys per thread per tile
  constexpr int ND = HD / kRowThreads;     // dQ dims per thread
  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;
  const int last_pos = (min(row0 + kRows, rows) - 1) / G;
  const int n_kb = last_pos / kKeys + 1;

  for (int kbi = 0; kbi < n_kb; ++kbi) {
    const int k0 = kbi * kKeys;
    __syncthreads();  // the previous K/V/dS tiles are consumed
    for (int i = tid; i < kKeys * HD; i += kThreads) {
      const int j = i / HD, d = i % HD;
      const int s = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (s <= last_pos) {
        const size_t off = lay.kv_row(b, h, s) * HD + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[j * P + d] = kv;
      vs[j * P + d] = vv;
    }
    __syncthreads();

    // scores and dP of the thread's 16 keys (c = sub + 4 i), each row
    // element loaded once for all of them
    float sc[NC], dp[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qd = qs[r * P + d], gd = dos[r * P + d];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = sub + kRowThreads * i;
        sc[i] = fmaf(qd, ks[c * P + d], sc[i]);
        dp[i] = fmaf(gd, vs[c * P + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = sub + kRowThreads * i;
      const bool on = live && k0 + c <= qpos;
      const float p = on ? expf(sc[i] * scale - lse_row) : 0.f;
      dss[r * (kKeys + 1) + c] = p * (dp[i] - d_row);
    }
    __syncwarp();  // the row's dS is visible to its 4 threads
    for (int j = 0; j < kKeys; ++j) {
      const float ds = dss[r * (kKeys + 1) + j];
#pragma unroll
      for (int i = 0; i < ND; ++i)
        acc[i] = fmaf(ds, ks[j * P + sub + kRowThreads * i], acc[i]);
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < ND; ++i)
      dq[row_off * HD + sub + kRowThreads * i] =
          repro::from_f32<T>(acc[i] * scale);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ lse,
               const T* __restrict__ dout, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int S, int KV, int G,
               float scale) {
  constexpr int P = HD + 1;
  extern __shared__ float smem[];
  float* ks = smem;                     // (kCtaKeys, P)
  float* vs = ks + kCtaKeys * P;        // (kCtaKeys, P)
  float* qs = vs + kCtaKeys * P;        // (kRows, P)
  float* dos = qs + kRows * P;          // (kRows, P)
  float* ps = dos + kRows * P;          // (kCtaKeys, kRows + 1)
  float* dss = ps + kCtaKeys * (kRows + 1);
  float* lses = dss + kCtaKeys * (kRows + 1);  // (kRows)
  float* ds_ = lses + kRows;                   // (kRows) D of the tile

  const Layout lay{S, KV, G};
  const int tid = threadIdx.x;
  const int c = tid / kKeyThreads, sub = tid % kKeyThreads;
  const int rows = S * G;
  const int k0 = blockIdx.x * kCtaKeys;
  const int b = blockIdx.y / KV, h = blockIdx.y % KV;
  const int key = k0 + c;

  for (int i = tid; i < kCtaKeys * HD; i += kThreads) {
    const int j = i / HD, d = i % HD;
    float kv = 0.f, vv = 0.f;
    if (k0 + j < S) {
      const size_t off = lay.kv_row(b, h, k0 + j) * HD + d;
      kv = to_f32(k[off]);
      vv = to_f32(v[off]);
    }
    ks[j * P + d] = kv;
    vs[j * P + d] = vv;
  }

  constexpr int NR = kRows / kKeyThreads;  // query rows per thread per tile
  constexpr int ND = HD / kKeyThreads;     // dK/dV dims per thread
  float acc_k[ND], acc_v[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc_k[i] = acc_v[i] = 0.f;

  // causal: only rows at or after the first key's position see it
  for (int row0 = k0 * G; row0 < rows; row0 += kRows) {
    __syncthreads();  // the previous tile is consumed (and K/V are in)
    for (int i = tid; i < kRows * HD; i += kThreads) {
      const int rr = i / HD, d = i % HD;
      const int R = row0 + rr;
      float qv = 0.f, gv = 0.f;
      if (R < rows) {
        const size_t off = lay.q_row(b, h, R) * HD + d;
        qv = to_f32(q[off]);
        gv = to_f32(dout[off]);
      }
      qs[rr * P + d] = qv;
      dos[rr * P + d] = gv;
    }
    for (int rr = tid; rr < kRows; rr += kThreads) {
      const int R = row0 + rr;
      const bool ok = R < rows;
      lses[rr] = ok ? lse[lay.q_row(b, h, R)] : 0.f;
      ds_[rr] = ok ? delta[lay.q_row(b, h, R)] : 0.f;
    }
    __syncthreads();

    // scores and dP of the thread's 8 rows (rr = sub + 8 i) against its
    // key, the key's K and V elements loaded once for all of them
    float sc[NR], dp[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float kd = ks[c * P + d], vd = vs[c * P + d];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int rr = sub + kKeyThreads * i;
        sc[i] = fmaf(qs[rr * P + d], kd, sc[i]);
        dp[i] = fmaf(dos[rr * P + d], vd, dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int rr = sub + kKeyThreads * i;
      const int R = row0 + rr;
      const bool on = R < rows && key < S && key <= R / G;
      const float p = on ? expf(sc[i] * scale - lses[rr]) : 0.f;
      ps[c * (kRows + 1) + rr] = p_for_dv<T>(p);
      dss[c * (kRows + 1) + rr] = p * (dp[i] - ds_[rr]);
    }
    __syncwarp();  // the key's P and dS are visible to its 8 threads
    for (int rr = 0; rr < kRows; ++rr) {
      const float p = ps[c * (kRows + 1) + rr];
      const float ds = dss[c * (kRows + 1) + rr];
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int d = sub + kKeyThreads * i;
        acc_v[i] = fmaf(p, dos[rr * P + d], acc_v[i]);
        acc_k[i] = fmaf(ds, qs[rr * P + d], acc_k[i]);
      }
    }
  }

  if (key < S) {
    const size_t off = lay.kv_row(b, h, key) * HD;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int d = sub + kKeyThreads * i;
      dk[off + d] = repro::from_f32<T>(acc_k[i] * scale);
      dv[off + d] = repro::from_f32<T>(acc_v[i]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* lse, const void* dout,
                   void* dq, void* dk, void* dv, void* delta, int B, int S,
                   int KV, int G, float scale, cudaStream_t stream) {
  constexpr int P = HD + 1;
  const size_t dq_smem =
      sizeof(float) * (2 * kRows * P + 2 * kKeys * P + kRows * (kKeys + 1));
  const size_t dkv_smem =
      sizeof(float) * (2 * kCtaKeys * P + 2 * kRows * P +
                       2 * kCtaKeys * (kRows + 1) + 2 * kRows);
  auto k1 = dq_kernel<T, HD>;
  auto k2 = dkv_kernel<T, HD>;
  cudaError_t err = repro::allow_smem(k1, dq_smem);
  if (err == cudaSuccess) err = repro::allow_smem(k2, dkv_smem);
  if (err != cudaSuccess) return err;
  const int rows = S * G;
  const dim3 g1((rows + kRows - 1) / kRows, B * KV);
  k1<<<g1, kThreads, dq_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(out),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<float*>(delta), S, KV, G, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g2((S + kCtaKeys - 1) / kCtaKeys, B * KV);
  k2<<<g2, kThreads, dkv_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lse),
      static_cast<const T*>(dout), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, KV, G, scale);
  return cudaGetLastError();
}

}  // namespace

// q/out/dout/dq (B, S, KV, G, hd), k/v/dk/dv (B, S, KV, hd), all float32
// or all bfloat16 (dtype), hd 64 or 128; lse (B, S, KV, G) float32 from
// the forward; delta (B, S, KV, G) float32 scratch. Two launches on
// `stream`; returns the first failing cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int B, int S, int KV, int G, int hd, float scale, int dtype,
    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32 && hd == 64)
    return launch<float, 64>(q, k, v, out, lse, dout, dq, dk, dv, delta, B,
                             S, KV, G, scale, s);
  if (dtype == repro::kF32 && hd == 128)
    return launch<float, 128>(q, k, v, out, lse, dout, dq, dk, dv, delta, B,
                              S, KV, G, scale, s);
  if (dtype == repro::kBF16 && hd == 64)
    return launch<bf16, 64>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, S,
                            KV, G, scale, s);
  if (dtype == repro::kBF16 && hd == 128)
    return launch<bf16, 128>(q, k, v, out, lse, dout, dq, dk, dv, delta, B,
                             S, KV, G, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
