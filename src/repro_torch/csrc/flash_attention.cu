// Causal flash attention (forward) with grouped-query heads.
//
// Replaces: src/repro/kernels/flash_attention.py flash_attention
// (_flash_kernel).
//
// Computes out (B, S, KV, G, hd) = causal softmax(q . k^T * hd^-0.5) v for
// q (B, S, KV, G, hd) and k/v (B, S, KV, hd), in the grouped layout the
// model keeps (padded heads included): query head (kv, g) reads kv head
// kv, and K/V are never repeated per query head. Scores, the online-softmax
// statistics and the output accumulator are f32; probabilities are
// rounded to the value dtype before the PV product, as the plain version
// (models/attention.py _blocked_causal_attention) does. For training the
// launch may also write each row's log-sum-exp (natural log, float32,
// (B, S, KV, G)), from which csrc/flash_attention_bwd.cu recomputes the
// probabilities; the serving path passes a null pointer and runs an
// instantiation without that store (kLse false: the kernel it ran
// before).
//
// What bounds it on an H100: at the calibration shape (B 64, S 128, KV 4,
// G 4, hd 64, bf16) the causal work is 2.1 GFLOP against 42 MB of
// q/k/v/out, so through the tensor cores the bytes bound it (12.5 us at
// 3.35 TB/s; the products alone would take 2.2 us at 989 TFLOP/s).
//
// Two routes, picked by dtype:
//
// bfloat16 -- tensor cores (FlashAttention-2 style). A CTA of 4 warps owns
// 64 consecutive (s, g) rows of one (b, kv): the G query heads of a
// position are adjacent rows, so every K/V tile the CTA loads serves all
// of its heads, and row r masks against position r / G. (One CTA per (q
// block, query head) would load each K/V tile G times.) Each warp owns
// 16 rows: its Q fragments load once (ldmatrix), both products run as
// mma.sync m16n8k16 bf16 -> f32, the online softmax works on the score
// fragments in registers (row max reduced across the quad by shuffles),
// and P is rescaled into bf16 A fragments in registers for the PV product.
// Shared memory holds bf16 tiles only (Q, and K/V double-buffered with
// 16-byte cp.async.cg so the next tile loads while the current one
// computes), each row padded by 16 bytes so ldmatrix is free of bank
// conflicts: 46 KB at hd 64, 87 KB at hd 128. K/V tiles past the block's
// last position are never loaded, and keys of a loaded tile past it (or
// past S) are zero-filled instead of read; the mask is applied only on
// tiles that cross the diagonal or the sequence end (masked keys score
// -inf), and Q rows past S are zero-filled, so any S works. Softmax runs
// in base 2 on the MUFU unit (ex2.approx), hd^-0.5 * log2(e) folded into
// one FMA per score. Row blocks run latest first, the heaviest causal
// work leading. The output is normalised by one reciprocal per row and
// staged through the warp's own Q rows for 16-byte stores.
//
// What holds it back: each CTA's first Q/K/V tiles take about as long to
// arrive as the CTA then computes, and with 4 CTAs an SM (128 registers at
// hd 64, 46 KB of shared memory) the card moves q/k/v/out at well under
// its byte rate (PERF.md has the times). Two variants measured no better
// in scratch copies and are not kept: a persistent kernel that prefetches
// the next row block's tiles during the last tile of the current one
// (its extra registers cost an SM a CTA), and skipping the dead 8-key
// n-tiles of the diagonal tile per warp (the branches break the unrolled
// mma schedule).
//
// float32 -- CUDA cores. TF32 tensor cores would miss the f32 tolerance
// (1e-3), so one CTA per (q block of 64 rows, query head) keeps its Q
// tile, the 64 x 64 score tile and the statistics on chip, four threads
// share a query row (warp-shuffle max/sum) and the products run as f32
// FMAs, walking k blocks only up to the causal limit.
#include <math.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32 route: CUDA cores

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 4 threads per query row
constexpr float kNegInf = -1e30f;

template <int HD, bool kLse>
__global__ void __launch_bounds__(kThreads)
    flash_attn_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          float* __restrict__ out,
                          float* __restrict__ lse, int S, int KV, int G,
                          float scale) {
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
  const float* qb = q + static_cast<size_t>(b) * S * q_row + (h * G + g) * HD;
  float* ob = out + static_cast<size_t>(b) * S * q_row + (h * G + g) * HD;
  const float* kb = k + static_cast<size_t>(b) * S * kv_row + h * HD;
  const float* vb = v + static_cast<size_t>(b) * S * kv_row + h * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int rr = i / HD, d = i % HD;
    const int s = q0 + rr;
    qs[rr * (HD + 1) + d] = s < S ? qb[s * q_row + d] : 0.f;
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
        kv = kb[s * kv_row + d];
        vv = vb[s * kv_row + d];
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
    for (int i = 0; i < ND; ++i) ob[qpos * q_row + sub + 4 * i] = acc[i] * inv;
    // m is the row's largest scaled score: lse = m + ln(l)
    if (kLse && sub == 0)
      lse[(static_cast<size_t>(b) * S + qpos) * KV * G + h * G + g] =
          m + logf(l);
  }
}

template <int HD, bool kLse>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int S, int KV, int G,
                       float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBQ * (HD + 1) + kBK * (HD + 1) +
                                       kBK * HD + kBQ * (kBK + 1));
  auto kernel = flash_attn_f32_kernel<HD, kLse>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, G, B * KV);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, KV, G,
      scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 route: tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcBM = 16 * kTcWarps;  // (s, g) rows per CTA
constexpr int kTcBN = 64;             // key positions per K/V tile
constexpr int kTcThreads = 32 * kTcWarps;

template <int HD>
struct TcTile {
  static constexpr int kStride = HD + 8;      // bf16 per smem row (+16 B)
  static constexpr int kQ = kTcBM * kStride;  // Q tile, bf16 elements
  static constexpr int kKV = kTcBN * kStride; // one K or V tile
  static constexpr size_t kBytes = sizeof(bf16) * (kQ + 4 * kKV);
};

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::smem_u32;

using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;
using repro::pack_bf16;
using repro::fast_exp2;

template <int HD, bool kLse>
__global__ void __launch_bounds__(kTcThreads)
    flash_attn_tc_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         float* __restrict__ lse, int S, int KV, int G,
                         float scale_log2) {
  using T = TcTile<HD>;
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  constexpr int kNT = kTcBN / 8;   // score n-tiles per warp
  constexpr int kDT = HD / 8;      // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* kvs = qs + T::kQ;  // stage st: K at kvs + 2 st kKV, V kKV after

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = S * G;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kTcBM;
  const int b = blockIdx.y / KV, h = blockIdx.y % KV;
  const size_t q_pos = static_cast<size_t>(KV) * G * HD;  // per position
  const size_t kv_pos = static_cast<size_t>(KV) * HD;
  const size_t q_off = static_cast<size_t>(b) * S * q_pos +
                       static_cast<size_t>(h) * G * HD;
  const bf16* qb = q + q_off;
  bf16* ob = out + q_off;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_pos +
                        static_cast<size_t>(h) * HD;
  const bf16* kb = k + kv_off;
  const bf16* vb = v + kv_off;

  for (int i = tid; i < kTcBM * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int R = row0 + r;
    const bool ok = R < rows;
    const bf16* src =
        ok ? qb + static_cast<size_t>(R / G) * q_pos + (R % G) * HD + c * 8
           : q;
    cp_async16(smem_u32(qs + r * T::kStride + c * 8), src, ok);
  }
  const int first_pos = row0 / G;
  const int last_pos = min((min(row0 + kTcBM, rows) - 1) / G, S - 1);
  const int n_kb = last_pos / kTcBN + 1;
  // keys past the block's last position (or S) are zero-filled, not read
  auto load_kv = [&](int kbi, int st) {
    bf16* kd = kvs + 2 * st * T::kKV;
    bf16* vd = kd + T::kKV;
    for (int i = tid; i < kTcBN * kChunks; i += kTcThreads) {
      const int j = i / kChunks, c = i % kChunks;
      const int s = kbi * kTcBN + j;
      const bool ok = s <= last_pos;
      const size_t off = static_cast<size_t>(s) * kv_pos + c * 8;
      cp_async16(smem_u32(kd + j * T::kStride + c * 8), ok ? kb + off : k,
                 ok);
      cp_async16(smem_u32(vd + j * T::kStride + c * 8), ok ? vb + off : v,
                 ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();  // group 0: Q and the first K/V tile

  // this thread's rows of the warp's 16: lane / 4 and lane / 4 + 8
  const int r_lo = warp * 16 + lane / 4;
  const int pos_lo = (row0 + r_lo) / G, pos_hi = (row0 + r_lo + 8) / G;

  uint32_t qf[HD / 16][4];
  float o[kDT][4];
#pragma unroll
  for (int t = 0; t < kDT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  for (int kbi = 0; kbi < n_kb; ++kbi) {
    const int st = kbi & 1;
    if (kbi + 1 < n_kb) {
      load_kv(kbi + 1, st ^ 1);  // the stage the previous tile left free
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kbi == 0) {
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
        const int r = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        const int c = kc * 16 + (lane / 16) * 8;
        ldmatrix_x4(qf[kc], smem_u32(qs + r * T::kStride + c));
      }
    }
    const bf16* kt = kvs + 2 * st * T::kKV;
    const bf16* vt = kt + T::kKV;

    // S = Q K^T: 16 x 64 scores per warp
    const int k0 = kbi * kTcBN;
    float sc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        const int key = j * 8 + (lane % 8) + (lane / 16) * 8;
        const int d = kc * 16 + ((lane / 8) % 2) * 8;
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_u32(kt + key * T::kStride + d));
        mma_bf16(sc[j], qf[kc], kf[0], kf[1]);
        mma_bf16(sc[j + 1], qf[kc], kf[2], kf[3]);
      }
    }

    // mask only where the tile crosses the diagonal or the sequence end;
    // scores stay raw, hd^-0.5 * log2(e) is folded into the exponent
    const bool masked = k0 + kTcBN - 1 > first_pos || k0 + kTcBN > S;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (masked) {
        const int col = k0 + j * 8 + (lane % 4) * 2;
        if (col > pos_lo || col >= S) sc[j][0] = -INFINITY;
        if (col + 1 > pos_lo || col + 1 >= S) sc[j][1] = -INFINITY;
        if (col > pos_hi || col >= S) sc[j][2] = -INFINITY;
        if (col + 1 > pos_hi || col + 1 >= S) sc[j][3] = -INFINITY;
      }
    }
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(sc[j][0], sc[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[j][2], sc[j][3]));
    }
    // a row's scores sit in the 4 lanes of a quad
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    // key 0 lies in every row's first tile, so the max is finite here
    const float corr_lo = fast_exp2((m_lo - mx_lo) * scale_log2);
    const float corr_hi = fast_exp2((m_hi - mx_hi) * scale_log2);
    m_lo = mx_lo;
    m_hi = mx_hi;
    const float off_lo = mx_lo * scale_log2, off_hi = mx_hi * scale_log2;

    // P in registers: the score C fragments of n-tiles 2kk, 2kk + 1 are
    // the A fragment of key chunk kk
    uint32_t pf[kTcBN / 16][4];
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float p0 = fast_exp2(fmaf(sc[j][0], scale_log2, -off_lo));
      const float p1 = fast_exp2(fmaf(sc[j][1], scale_log2, -off_lo));
      const float p2 = fast_exp2(fmaf(sc[j][2], scale_log2, -off_hi));
      const float p3 = fast_exp2(fmaf(sc[j][3], scale_log2, -off_hi));
      sum_lo += p0 + p1;
      sum_hi += p2 + p3;
      pf[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l_lo = l_lo * corr_lo + sum_lo;  // this lane's share; quad-summed last
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int t = 0; t < kDT; ++t) {
      o[t][0] *= corr_lo;
      o[t][1] *= corr_lo;
      o[t][2] *= corr_hi;
      o[t][3] *= corr_hi;
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < kTcBN / 16; ++kk) {
#pragma unroll
      for (int t = 0; t < kDT; t += 2) {
        const int key = kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        const int d = t * 8 + (lane / 16) * 8;
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_u32(vt + key * T::kStride + d));
        mma_bf16(o[t], pf[kk], vf[0], vf[1]);
        mma_bf16(o[t + 1], pf[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();  // the stage is free for the load two tiles ahead
  }

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  if (kLse && lane % 4 == 0) {
    // the row sums are base 2 of raw scores: ln-sum-exp of the scaled
    // scores is (m scale log2(e) + log2(l)) ln(2)
    const size_t lse_b = static_cast<size_t>(b) * S * KV * G + h * G;
    const int R_lo = row0 + r_lo, R_hi = R_lo + 8;
    if (R_lo < rows)
      lse[lse_b + static_cast<size_t>(R_lo / G) * KV * G + R_lo % G] =
          (m_lo * scale_log2 + log2f(l_lo)) * 0.6931471805599453f;
    if (R_hi < rows)
      lse[lse_b + static_cast<size_t>(R_hi / G) * KV * G + R_hi % G] =
          (m_hi * scale_log2 + log2f(l_hi)) * 0.6931471805599453f;
  }
  // stage the warp's 16 output rows in its own Q rows (read only by it)
#pragma unroll
  for (int t = 0; t < kDT; ++t) {
    const int col = t * 8 + (lane % 4) * 2;
    *reinterpret_cast<uint32_t*>(qs + r_lo * T::kStride + col) =
        pack_bf16(o[t][0] * inv_lo, o[t][1] * inv_lo);
    *reinterpret_cast<uint32_t*>(qs + (r_lo + 8) * T::kStride + col) =
        pack_bf16(o[t][2] * inv_hi, o[t][3] * inv_hi);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = warp * 16 + i / kChunks, c = i % kChunks;
    const int R = row0 + r;
    if (R < rows)
      *reinterpret_cast<uint4*>(ob + static_cast<size_t>(R / G) * q_pos +
                                (R % G) * HD + c * 8) =
          *reinterpret_cast<const uint4*>(qs + r * T::kStride + c * 8);
  }
}

template <int HD, bool kLse>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      float* lse, int B, int S, int KV, int G, float scale,
                      cudaStream_t stream) {
  auto kernel = flash_attn_tc_kernel<HD, kLse>;
  cudaError_t err = repro::allow_smem(kernel, TcTile<HD>::kBytes);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(S) * G;
  const dim3 grid(static_cast<unsigned>((rows + kTcBM - 1) / kTcBM), B * KV);
  kernel<<<grid, kTcThreads, TcTile<HD>::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, S, KV, G,
      scale * 1.4426950408889634f);  // log2(e): softmax by exp2
  return cudaGetLastError();
}

}  // namespace

// q/out (B, S, KV, G, hd), k/v (B, S, KV, hd), all float32 or all
// bfloat16 (dtype), hd 64 or 128, 16-byte aligned. lse, when not null,
// receives each row's natural-log sum of exp(scale q.k) over its causal
// keys, float32 (B, S, KV, G) -- what the backward recomputes P from;
// the serving path passes null and writes nothing. Returns the launch's
// cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int S, int KV, int G, int hd,
                                      float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<float*>(lse);
  // the serving launch (no lse) runs an instantiation without the store
  if (dtype == repro::kF32 && hd == 64)
    return l ? launch_f32<64, true>(q, k, v, out, l, B, S, KV, G, scale, s)
             : launch_f32<64, false>(q, k, v, out, l, B, S, KV, G, scale, s);
  if (dtype == repro::kF32 && hd == 128)
    return l ? launch_f32<128, true>(q, k, v, out, l, B, S, KV, G, scale, s)
             : launch_f32<128, false>(q, k, v, out, l, B, S, KV, G, scale, s);
  if (dtype == repro::kBF16 && hd == 64)
    return l ? launch_tc<64, true>(q, k, v, out, l, B, S, KV, G, scale, s)
             : launch_tc<64, false>(q, k, v, out, l, B, S, KV, G, scale, s);
  if (dtype == repro::kBF16 && hd == 128)
    return l ? launch_tc<128, true>(q, k, v, out, l, B, S, KV, G, scale, s)
             : launch_tc<128, false>(q, k, v, out, l, B, S, KV, G, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory, in bytes, of the bfloat16 (tensor-core) route at
// head dim hd; -1 for a head dim it does not take.
extern "C" int flash_attention_tc_smem(int hd) {
  if (hd == 64) return static_cast<int>(TcTile<64>::kBytes);
  if (hd == 128) return static_cast<int>(TcTile<128>::kBytes);
  return -1;
}
