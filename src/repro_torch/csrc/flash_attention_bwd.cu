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
//   dQ   = scale dS K,  dK = scale dS^T Q   (dS rounded to the input
//                                            dtype first)
// in the grouped layout, K/V never repeated per query head: the G query
// heads of a kv head add into its dK/dV. Rows R = s G + g of one (b, kv)
// are adjacent, so row R sees keys j with j G <= R. Everything is
// accumulated in float32 and written in the input dtype. Two kernels run
// in turn on the caller's stream, the first of which also stores D for
// the second; no float atomics anywhere, every sum runs in one fixed
// order, so a second call gives the same bits.
//
// What bounds it on an H100: at smollm-135m's training shape (B 8, S 256,
// KV 4, G 4, hd 64, bf16) the causal work is 2.7 GFLOP (10 flops per
// (row, key, dim): four products and the P recomputation) against 21 MB
// read and written, so the bytes bound it (6.3 us at 3.35 TB/s; the
// products alone would take 2.7 us at 989 TFLOP/s).
//
// Two routes, picked by dtype:
//
// bfloat16 -- tensor cores (FlashAttention-2's backward on mma.sync
// m16n8k16 bf16 -> f32), the fragments and tiles of the forward's
// flash_attn_tc_kernel: bf16 tiles in shared memory padded by 16 bytes a
// row (ldmatrix without bank conflicts), 64-row tiles double-buffered
// with 16-byte cp.async, P recomputed in base 2 on the MUFU unit as
// exp2(s scale log2(e) - lse log2(e)), and accumulators turned into bf16
// A fragments in registers. A key masks rows before its first one only on
// tiles that cross the diagonal or an end; rows past S G and keys past S
// are zero-filled, and a zero-filled row's P is set to 0 by the row test.
//
//   dq_tc_kernel -- a CTA of 4 warps owns 64 adjacent (s, g) rows of one
//   (b, kv), 16 a warp, latest row block first. Its prologue computes D
//   for its rows (stored for the second kernel) while Q, dO and the first
//   K/V tile load; then it walks the 64-key K/V tiles up to its last
//   position: S = Q K^T and dP = dO V^T (K and V as B operands, plain
//   ldmatrix), dS = P (dP - D) in f32, rounded into A fragments, dQ +=
//   dS K (K through ldmatrix.trans).
//
//   dkv_tc_kernel -- a CTA of 4 warps owns 64 keys of one (b, kv), 16 a
//   warp, and walks the 64-row Q/dO tiles from its first key's row to the
//   end, the tiles' lse and D beside them in shared memory: S^T = K Q^T
//   and dP^T = V dO^T, P^T and dS^T in registers (lse and D read for the
//   accumulator's columns), dV += P^T dO and dK += dS^T Q (dO and Q
//   through ldmatrix.trans). At hd 128, where dK and dV alone take 128
//   floats a thread, it walks a tile in two halves of 32 rows (the same
//   mma order, so the same sums).
//
//   Both kernels reload their resident tiles' A fragments (Q and dO, or K
//   and V) from shared memory per tile: kept in registers at hd 64 they
//   took dkv_tc_kernel to 235 registers a thread for no measured gain.
//
//   Causal balance: key block j of n walks (n - j) / n of the rows, so
//   at the training shape one CTA per key block (128 CTAs on 132 SMs)
//   waits on key block 0's 16 tiles while key block 3 walks 4. Pairing
//   blocks j and n - 1 - j in one CTA evens that out but, with fewer CTAs
//   than SMs, lengthens the longest walk (20 tiles); so instead each key
//   block's walk is split into equal row chunks over a thread-block
//   cluster (a rank for every kTcRankTiles tiles of key block 0's walk,
//   at most 8: 2 at the training shape, 256 CTAs), and the ranks' dK/dV
//   partials are summed through distributed shared memory in rank
//   order, each rank writing its share of the block's keys.
//
// Measured on an H100 SXM at 700 W (chip_smoke.py, PERF.md): 0.053-0.055
// ms at the training shape, 1.18-1.23x SDPA's backward timed beside it
// and 12% of the byte bound, from 0.626-0.630 ms on the CUDA cores; in
// the train step dq_tc_kernel takes 0.021 ms a launch and dkv_tc_kernel
// 0.028 ms. Neither comes near the tensor cores' rate: a CTA walks at
// most 8 tiles there, and what bounds a walk is not measured (no
// per-CTA profiler on that machine).
//
// float32 -- CUDA cores. TF32 tensor cores would miss the f32 tolerance
// (1e-4), so the products run as f32 FMAs from shared memory:
//
//   dq_kernel -- one CTA of 256 threads per (64 (s, g) rows, b, kv head)
//   first computes D for its rows (and stores it for the second kernel),
//   then walks the key tiles up to its last position: four threads share
//   a row, each recomputes P and dP for 16 of the tile's 64 keys, writes
//   dS to shared memory, and adds dS K into its quarter of the row's dQ.
//
//   dkv_kernel -- one CTA per (32 keys, b, kv head) walks the query rows
//   from its first key's position to the end, 64 (s, g) rows a tile:
//   eight threads share a key, each recomputes P and dS for 8 of the
//   tile's rows, and each then adds P dO and dS Q into its eighth of the
//   key's dV and dK.
#include <cooperative_groups.h>
#include <math.h>

#include <algorithm>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// float32 route: CUDA cores

constexpr int kThreads = 256;
constexpr int kRows = 64;          // (s, g) rows of a Q tile
constexpr int kKeys = 64;          // keys of a K/V tile (dq_kernel)
constexpr int kRowThreads = kThreads / kRows;    // 4 threads per row
constexpr int kCtaKeys = 32;       // keys of a dkv_kernel CTA
constexpr int kKeyThreads = kThreads / kCtaKeys; // 8 threads per key

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

template <int HD>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ out,
              const float* __restrict__ lse, const float* __restrict__ dout,
              float* __restrict__ dq, float* __restrict__ delta, int S,
              int KV, int G, float scale) {
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
      qv = q[off];
      dv = dout[off];
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
      d_row = fmaf(dout[row_off * HD + d], out[row_off * HD + d], d_row);
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
        kv = k[off];
        vv = v[off];
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
      dq[row_off * HD + sub + kRowThreads * i] = acc[i] * scale;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ lse,
               const float* __restrict__ dout,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int S, int KV, int G, float scale) {
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
      kv = k[off];
      vv = v[off];
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
        qv = q[off];
        gv = dout[off];
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
      ps[c * (kRows + 1) + rr] = p;
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
      dk[off + d] = acc_k[i] * scale;
      dv[off + d] = acc_v[i];
    }
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* out, const void* lse, const void* dout,
                       void* dq, void* dk, void* dv, void* delta, int B,
                       int S, int KV, int G, float scale,
                       cudaStream_t stream) {
  constexpr int P = HD + 1;
  const size_t dq_smem =
      sizeof(float) * (2 * kRows * P + 2 * kKeys * P + kRows * (kKeys + 1));
  const size_t dkv_smem =
      sizeof(float) * (2 * kCtaKeys * P + 2 * kRows * P +
                       2 * kCtaKeys * (kRows + 1) + 2 * kRows);
  auto k1 = dq_kernel<HD>;
  auto k2 = dkv_kernel<HD>;
  cudaError_t err = repro::allow_smem(k1, dq_smem);
  if (err == cudaSuccess) err = repro::allow_smem(k2, dkv_smem);
  if (err != cudaSuccess) return err;
  const int rows = S * G;
  const dim3 g1((rows + kRows - 1) / kRows, B * KV);
  k1<<<g1, kThreads, dq_smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(out),
      static_cast<const float*>(lse), static_cast<const float*>(dout),
      static_cast<float*>(dq), static_cast<float*>(delta), S, KV, G, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g2((S + kCtaKeys - 1) / kCtaKeys, B * KV);
  k2<<<g2, kThreads, dkv_smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(lse),
      static_cast<const float*>(dout), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), S, KV, G, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 route: tensor cores

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::fast_exp2;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;
using repro::pack_bf16;
using repro::smem_u32;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcBM = 16 * kTcWarps;  // rows of a tile: (s, g) rows of a
                                      // Q/dO tile, keys of a K/V tile
constexpr float kLog2e = 1.4426950408889634f;
// Q/dO tiles a rank of key block 0's cluster walks, about: the cluster
// size is that block's walk over this, at most the portable 8 (8 tiles
// give 2 ranks at the training shape, which timed fastest there on an
// H100 of 1, 2, 4 and 8 ranks)
constexpr int kTcRankTiles = 8;

template <int HD>
struct BwdTile {
  static constexpr int kStride = HD + 8;        // bf16 per smem row (+16 B)
  static constexpr int kTile = kTcBM * kStride; // one tile, bf16 elements
  // either kernel: two resident tiles (Q and dO, or K and V), two pairs
  // double-buffered, then per-row floats (lse and D: dq_tc_kernel's own
  // rows; dkv_tc_kernel's two stages)
  static constexpr size_t kDqBytes =
      sizeof(bf16) * 6 * kTile + sizeof(float) * 2 * kTcBM;
  static constexpr size_t kDkvBytes =
      sizeof(bf16) * 6 * kTile + sizeof(float) * 4 * kTcBM;
  // a dkv CTA's f32 dK and dV partials (64 keys each, rows padded by 32
  // B) take the place of its Q/dO stages once the walk is done
  static constexpr int kPartStride = HD + 8;
  static_assert(2 * kTcBM * kPartStride * sizeof(float) <=
                    4 * kTile * sizeof(bf16),
                "the partials fit the Q/dO stages");
  // dkv_tc_kernel walks a tile in one pass at hd 64, in halves of 32
  // rows at hd 128 (where dK and dV take 128 floats a thread)
  static constexpr int kSub = HD == 64 ? kTcBM : kTcBM / 2;
};

// 4 bytes global -> shared (through L1); zero-filled when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

// Operands of m16n8k16 from a row-major bf16 tile of row stride ST:
// the A fragment of rows r0..r0+15, columns c0..c0+15 (ldmatrix); the B
// fragments of the n-tiles n0/8 and n0/8 + 1 of X^T at k columns
// c0..c0+15, X being the tile (X's rows are the n index: plain
// ldmatrix); and the B fragments of the n-tiles c0/8 and c0/8 + 1 of X at
// k rows r0..r0+15 (ldmatrix.trans).
template <int ST>
__device__ __forceinline__ void frag_a(uint32_t (&f)[4], const bf16* tile,
                                       int r0, int c0, int lane) {
  ldmatrix_x4(f, smem_u32(tile + (r0 + (lane % 8) + ((lane / 8) % 2) * 8) *
                                     ST + c0 + (lane / 16) * 8));
}

template <int ST>
__device__ __forceinline__ void frag_bt(uint32_t (&f)[4], const bf16* tile,
                                        int n0, int c0, int lane) {
  ldmatrix_x4(f, smem_u32(tile + (n0 + (lane % 8) + (lane / 16) * 8) * ST +
                          c0 + ((lane / 8) % 2) * 8));
}

template <int ST>
__device__ __forceinline__ void frag_b(uint32_t (&f)[4], const bf16* tile,
                                       int r0, int c0, int lane) {
  ldmatrix_x4_trans(f, smem_u32(tile + (r0 + (lane % 8) +
                                        ((lane / 8) % 2) * 8) * ST +
                                c0 + (lane / 16) * 8));
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ out,
                 const float* __restrict__ lse,
                 const bf16* __restrict__ dout, bf16* __restrict__ dq,
                 float* __restrict__ delta, int S, int KV, int G,
                 float scale_log2, float scale) {
  using T = BwdTile<HD>;
  constexpr int ST = T::kStride;
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  constexpr int kNT = kTcBM / 8;   // score n-tiles per warp
  constexpr int kDT = HD / 8;      // dQ n-tiles per warp
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* dos = qs + T::kTile;
  bf16* kvs = dos + T::kTile;  // stage st: K at kvs + 2 st kTile, V after
  float* lse_s = reinterpret_cast<float*>(kvs + 4 * T::kTile);  // * log2 e
  float* d_s = lse_s + kTcBM;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = S * G;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kTcBM;
  const int b = blockIdx.y / KV, h = blockIdx.y % KV;
  const Layout lay{S, KV, G};

  for (int i = tid; i < kTcBM * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int R = row0 + r;
    const bool ok = R < rows;
    const size_t off = ok ? lay.q_row(b, h, R) * HD + c * 8 : 0;
    cp_async16(smem_u32(qs + r * ST + c * 8), q + off, ok);
    cp_async16(smem_u32(dos + r * ST + c * 8), dout + off, ok);
  }
  const int first_pos = row0 / G;
  const int last_pos = min((min(row0 + kTcBM, rows) - 1) / G, S - 1);
  const int n_kb = last_pos / kTcBM + 1;
  // keys past the block's last position (or S) are zero-filled, not read
  auto load_kv = [&](int kbi, int st) {
    bf16* kd = kvs + 2 * st * T::kTile;
    bf16* vd = kd + T::kTile;
    for (int i = tid; i < kTcBM * kChunks; i += kTcThreads) {
      const int j = i / kChunks, c = i % kChunks;
      const int s = kbi * kTcBM + j;
      const bool ok = s <= last_pos;
      const size_t off = ok ? lay.kv_row(b, h, s) * HD + c * 8 : 0;
      cp_async16(smem_u32(kd + j * ST + c * 8), k + off, ok);
      cp_async16(smem_u32(vd + j * ST + c * 8), v + off, ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();  // group 0: Q, dO and the first K/V tile

  // D = rowsum(dO * O) of the CTA's rows while the tiles load: two
  // threads a row, each half the dims in order, then the pair summed
  {
    const int r = tid / 2, half = tid % 2;
    const int R = row0 + r;
    const bool ok = R < rows;
    float d_row = 0.f;
    if (ok) {
      const size_t off = lay.q_row(b, h, R) * HD + half * (HD / 2);
#pragma unroll
      for (int c = 0; c < HD / 2; c += 8) {
        const uint4 gv = *reinterpret_cast<const uint4*>(dout + off + c);
        const uint4 ov = *reinterpret_cast<const uint4*>(out + off + c);
        const bf16* g8 = reinterpret_cast<const bf16*>(&gv);
        const bf16* o8 = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d_row = fmaf(__bfloat162float(g8[e]), __bfloat162float(o8[e]),
                       d_row);
      }
    }
    d_row += __shfl_xor_sync(0xffffffffu, d_row, 1);
    if (half == 0) {
      d_s[r] = d_row;
      lse_s[r] = ok ? lse[lay.q_row(b, h, R)] * kLog2e : 0.f;
      if (ok) delta[lay.q_row(b, h, R)] = d_row;
    }
  }

  // this thread's rows of the warp's 16: lane / 4 and lane / 4 + 8
  const int r_lo = warp * 16 + lane / 4;
  const int R_lo = row0 + r_lo, R_hi = R_lo + 8;
  float lse_lo = 0.f, lse_hi = 0.f, d_lo = 0.f, d_hi = 0.f;
  float acc[kDT][4];
#pragma unroll
  for (int t = 0; t < kDT; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

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
      lse_lo = lse_s[r_lo];
      lse_hi = lse_s[r_lo + 8];
      d_lo = d_s[r_lo];
      d_hi = d_s[r_lo + 8];
    }
    const bf16* kt = kvs + 2 * st * T::kTile;
    const bf16* vt = kt + T::kTile;
    const int k0 = kbi * kTcBM;

    // S = Q K^T and dP = dO V^T: 16 x 64 each per warp
    float sc[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = dp[j][0] = dp[j][1] =
          dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t aq[4], ag[4];
      frag_a<ST>(aq, qs, warp * 16, kc * 16, lane);
      frag_a<ST>(ag, dos, warp * 16, kc * 16, lane);
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t bk[4], bv[4];
        frag_bt<ST>(bk, kt, j * 8, kc * 16, lane);
        mma_bf16(sc[j], aq, bk[0], bk[1]);
        mma_bf16(sc[j + 1], aq, bk[2], bk[3]);
        frag_bt<ST>(bv, vt, j * 8, kc * 16, lane);
        mma_bf16(dp[j], ag, bv[0], bv[1]);
        mma_bf16(dp[j + 1], ag, bv[2], bv[3]);
      }
    }

    // dS = P (dP - D) into bf16 A fragments: the C fragments of n-tiles
    // 2kk, 2kk + 1 are the A fragment of key chunk kk. Key j masks rows
    // R < j G, and rows past S G, only on tiles that cross the diagonal
    // or an end.
    const bool masked = k0 + kTcBM - 1 > first_pos || row0 + kTcBM > rows;
    uint32_t dsf[kTcBM / 16][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      float p0 = fast_exp2(fmaf(sc[j][0], scale_log2, -lse_lo));
      float p1 = fast_exp2(fmaf(sc[j][1], scale_log2, -lse_lo));
      float p2 = fast_exp2(fmaf(sc[j][2], scale_log2, -lse_hi));
      float p3 = fast_exp2(fmaf(sc[j][3], scale_log2, -lse_hi));
      if (masked) {
        const int first0 = (k0 + j * 8 + (lane % 4) * 2) * G;
        const int first1 = first0 + G;
        if (R_lo >= rows || R_lo < first0) p0 = 0.f;
        if (R_lo >= rows || R_lo < first1) p1 = 0.f;
        if (R_hi >= rows || R_hi < first0) p2 = 0.f;
        if (R_hi >= rows || R_hi < first1) p3 = 0.f;
      }
      dsf[j / 2][(j % 2) * 2] =
          pack_bf16(p0 * (dp[j][0] - d_lo), p1 * (dp[j][1] - d_lo));
      dsf[j / 2][(j % 2) * 2 + 1] =
          pack_bf16(p2 * (dp[j][2] - d_hi), p3 * (dp[j][3] - d_hi));
    }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < kTcBM / 16; ++kk) {
#pragma unroll
      for (int t = 0; t < kDT; t += 2) {
        uint32_t bk[4];
        frag_b<ST>(bk, kt, kk * 16, t * 8, lane);
        mma_bf16(acc[t], dsf[kk], bk[0], bk[1]);
        mma_bf16(acc[t + 1], dsf[kk], bk[2], bk[3]);
      }
    }
    __syncthreads();  // the stage is free for the load two tiles ahead
  }

  // stage the warp's 16 dQ rows in its own Q rows (read only by it)
#pragma unroll
  for (int t = 0; t < kDT; ++t) {
    const int col = t * 8 + (lane % 4) * 2;
    *reinterpret_cast<uint32_t*>(qs + r_lo * ST + col) =
        pack_bf16(acc[t][0] * scale, acc[t][1] * scale);
    *reinterpret_cast<uint32_t*>(qs + (r_lo + 8) * ST + col) =
        pack_bf16(acc[t][2] * scale, acc[t][3] * scale);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = warp * 16 + i / kChunks, c = i % kChunks;
    const int R = row0 + r;
    if (R < rows)
      *reinterpret_cast<uint4*>(dq + lay.q_row(b, h, R) * HD + c * 8) =
          *reinterpret_cast<const uint4*>(qs + r * ST + c * 8);
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ lse,
                  const bf16* __restrict__ dout,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int S, int KV, int G,
                  float scale_log2, float scale) {
  using T = BwdTile<HD>;
  constexpr int ST = T::kStride;
  constexpr int PS = T::kPartStride;
  constexpr int kChunks = HD / 8;
  constexpr int kSub = T::kSub;     // rows of a pass over the tile
  constexpr int kNT = kSub / 8;     // S^T n-tiles per warp per pass
  constexpr int kDT = HD / 8;       // dK/dV n-tiles per warp
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);
  bf16* vs = ks + T::kTile;
  bf16* qds = vs + T::kTile;  // stage st: Q at qds + 2 st kTile, dO after
  // stage st: the tile's lse at rowf + 2 st kTcBM, D after
  float* rowf = reinterpret_cast<float*>(qds + 4 * T::kTile);
  float* part = reinterpret_cast<float*>(qds);  // after the walk

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = S * G;
  const int k0 = blockIdx.y * kTcBM;
  const int b = blockIdx.z / KV, h = blockIdx.z % KV;
  const Layout lay{S, KV, G};

  // the block's walk: 64-row tiles from the first row that sees key k0,
  // cut into `split` equal chunks, this rank's chunk [t_lo, t_hi)
  const int start = k0 * G;
  const int n_t = (rows - start + kTcBM - 1) / kTcBM;
  const int t_lo = rank * n_t / split, t_hi = (rank + 1) * n_t / split;
  auto load_rows = [&](int t, int st) {
    const int ra = start + t * kTcBM;
    bf16* qd = qds + 2 * st * T::kTile;
    bf16* gd = qd + T::kTile;
    for (int i = tid; i < kTcBM * kChunks; i += kTcThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const int R = ra + r;
      const bool ok = R < rows;
      const size_t off = ok ? lay.q_row(b, h, R) * HD + c * 8 : 0;
      cp_async16(smem_u32(qd + r * ST + c * 8), q + off, ok);
      cp_async16(smem_u32(gd + r * ST + c * 8), dout + off, ok);
    }
    // lse (threads 0..63) and D (64..127) of the tile's rows
    const int R = ra + tid % kTcBM;
    const bool ok = R < rows;
    cp_async4(smem_u32(rowf + 2 * st * kTcBM + tid),
              (tid < kTcBM ? lse : delta) + (ok ? lay.q_row(b, h, R) : 0), ok);
  };
  if (t_lo < t_hi) {
    for (int i = tid; i < kTcBM * kChunks; i += kTcThreads) {
      const int j = i / kChunks, c = i % kChunks;
      const bool ok = k0 + j < S;
      const size_t off = ok ? lay.kv_row(b, h, k0 + j) * HD + c * 8 : 0;
      cp_async16(smem_u32(ks + j * ST + c * 8), k + off, ok);
      cp_async16(smem_u32(vs + j * ST + c * 8), v + off, ok);
    }
    load_rows(t_lo, 0);
  }
  cp_async_commit();  // group 0: K, V and the first Q/dO tile

  // this thread's keys of the warp's 16, and the first row each sees
  const int key_lo = k0 + warp * 16 + lane / 4;
  const int first_lo = key_lo * G, first_hi = first_lo + 8 * G;
  float dka[kDT][4], dva[kDT][4];
#pragma unroll
  for (int t = 0; t < kDT; ++t)
    dka[t][0] = dka[t][1] = dka[t][2] = dka[t][3] = dva[t][0] = dva[t][1] =
        dva[t][2] = dva[t][3] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    if (t + 1 < t_hi) {
      load_rows(t + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qds + 2 * st * T::kTile;
    const bf16* gt = qt + T::kTile;
    const float* lse_t = rowf + 2 * st * kTcBM;
    const float* d_t = lse_t + kTcBM;
    const int ra = start + t * kTcBM;
    // key j masks rows R < j G, and rows past S G, only on tiles that
    // cross the diagonal or an end (keys past S lie past every row)
    const bool masked = ra < (k0 + kTcBM - 1) * G || ra + kTcBM > rows;

#pragma unroll 1
    for (int sp = 0; sp < kTcBM; sp += kSub) {
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x kSub rows per warp
      float sc[kNT][4], dp[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = dp[j][0] = dp[j][1] =
            dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
        uint32_t ak[4], av[4];
        frag_a<ST>(ak, ks, warp * 16, kc * 16, lane);
        frag_a<ST>(av, vs, warp * 16, kc * 16, lane);
#pragma unroll
        for (int j = 0; j < kNT; j += 2) {
          uint32_t bq[4], bg[4];
          frag_bt<ST>(bq, qt, sp + j * 8, kc * 16, lane);
          mma_bf16(sc[j], ak, bq[0], bq[1]);
          mma_bf16(sc[j + 1], ak, bq[2], bq[3]);
          frag_bt<ST>(bg, gt, sp + j * 8, kc * 16, lane);
          mma_bf16(dp[j], av, bg[0], bg[1]);
          mma_bf16(dp[j + 1], av, bg[2], bg[3]);
        }
      }

      // P^T and dS^T into bf16 A fragments (row chunks of 16): the
      // accumulator's columns are rows, so lse and D go by column
      uint32_t pf[kSub / 16][4], dsf[kSub / 16][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = sp + j * 8 + (lane % 4) * 2;
        const float2 l = *reinterpret_cast<const float2*>(lse_t + c);
        const float2 d = *reinterpret_cast<const float2*>(d_t + c);
        const float l0 = l.x * kLog2e, l1 = l.y * kLog2e;
        float p0 = fast_exp2(fmaf(sc[j][0], scale_log2, -l0));
        float p1 = fast_exp2(fmaf(sc[j][1], scale_log2, -l1));
        float p2 = fast_exp2(fmaf(sc[j][2], scale_log2, -l0));
        float p3 = fast_exp2(fmaf(sc[j][3], scale_log2, -l1));
        if (masked) {
          const int R = ra + c;
          if (R >= rows || R < first_lo) p0 = 0.f;
          if (R + 1 >= rows || R + 1 < first_lo) p1 = 0.f;
          if (R >= rows || R < first_hi) p2 = 0.f;
          if (R + 1 >= rows || R + 1 < first_hi) p3 = 0.f;
        }
        pf[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
        pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
        dsf[j / 2][(j % 2) * 2] =
            pack_bf16(p0 * (dp[j][0] - d.x), p1 * (dp[j][1] - d.y));
        dsf[j / 2][(j % 2) * 2 + 1] =
            pack_bf16(p2 * (dp[j][2] - d.x), p3 * (dp[j][3] - d.y));
      }

      // dV += P^T dO and dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < kDT; n += 2) {
          uint32_t bg[4], bq[4];
          frag_b<ST>(bg, gt, sp + kk * 16, n * 8, lane);
          mma_bf16(dva[n], pf[kk], bg[0], bg[1]);
          mma_bf16(dva[n + 1], pf[kk], bg[2], bg[3]);
          frag_b<ST>(bq, qt, sp + kk * 16, n * 8, lane);
          mma_bf16(dka[n], dsf[kk], bq[0], bq[1]);
          mma_bf16(dka[n + 1], dsf[kk], bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // the stage is free for the load two tiles ahead
  }

  // the CTA's partials over its chunk of the walk, in its own shared
  // memory (the Q/dO stages): dK rows of its 64 keys, then dV's
  cp_async_wait<0>();
  __syncthreads();
  {
    const int r = warp * 16 + lane / 4;
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const int c = n * 8 + (lane % 4) * 2;
      float* pk = part + r * PS + c;
      float* pv = pk + kTcBM * PS;
      *reinterpret_cast<float2*>(pk) = make_float2(dka[n][0], dka[n][1]);
      *reinterpret_cast<float2*>(pk + 8 * PS) =
          make_float2(dka[n][2], dka[n][3]);
      *reinterpret_cast<float2*>(pv) = make_float2(dva[n][0], dva[n][1]);
      *reinterpret_cast<float2*>(pv + 8 * PS) =
          make_float2(dva[n][2], dva[n][3]);
    }
  }
  cluster.sync();
  // rank r sums its share of the block's 2 x 64 x hd values over the
  // ranks' partials, in rank order, and writes it
  constexpr int kQuads = 2 * kTcBM * HD / 4;
  const int share = (kQuads + split - 1) / split;
  const int q_end = min(kQuads, (rank + 1) * share);
  for (int i = rank * share + tid; i < q_end; i += kTcThreads) {
    const int which = i / (kTcBM * HD / 4);  // 0: dK, 1: dV
    const int j = i % (kTcBM * HD / 4);
    const int r = j / (HD / 4), c = (j % (HD / 4)) * 4;
    if (k0 + r >= S) continue;
    const int at = (which * kTcBM + r) * PS + c;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int src = 0; src < split; ++src) {
      const float4 x = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, src) + at);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const float f = which ? 1.f : scale;
    *reinterpret_cast<uint2*>((which ? dv : dk) +
                              lay.kv_row(b, h, k0 + r) * HD + c) =
        make_uint2(pack_bf16(sum.x * f, sum.y * f),
                   pack_bf16(sum.z * f, sum.w * f));
  }
  cluster.sync();  // no CTA leaves while another reads its partials
}

// CTAs of one dK/dV key block's cluster: a rank for every kTcRankTiles
// tiles of key block 0's walk, at least 1, at most the portable cluster
// size
int tc_split(int S, int G) {
  const long long tiles =
      (static_cast<long long>(S) * G + kTcBM - 1) / kTcBM;
  return static_cast<int>(std::min<long long>(
      repro::kPortableCluster,
      std::max<long long>(1, (tiles + kTcRankTiles - 1) / kTcRankTiles)));
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* out, const void* lse, const void* dout,
                      void* dq, void* dk, void* dv, void* delta, int B, int S,
                      int KV, int G, float scale, cudaStream_t stream) {
  using T = BwdTile<HD>;
  auto k1 = dq_tc_kernel<HD>;
  cudaError_t err = repro::allow_smem(k1, T::kDqBytes);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(S) * G;
  const float scale_log2 = scale * kLog2e;
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* lf = static_cast<const float*>(lse);
  const auto* gb = static_cast<const bf16*>(dout);
  auto* df = static_cast<float*>(delta);
  k1<<<dim3(static_cast<unsigned>((rows + kTcBM - 1) / kTcBM), B * KV),
       kTcThreads, T::kDqBytes, stream>>>(
      qb, kb, vb, static_cast<const bf16*>(out), lf, gb,
      static_cast<bf16*>(dq), df, S, KV, G, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return repro::launch_cluster(
      dkv_tc_kernel<HD>,
      dim3(tc_split(S, G), (S + kTcBM - 1) / kTcBM, B * KV),
      dim3(kTcThreads), T::kDkvBytes, stream, qb, kb, vb, lf, gb,
      static_cast<const float*>(df), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, KV, G, scale_log2, scale);
}

}  // namespace

// q/out/dout/dq (B, S, KV, G, hd), k/v/dk/dv (B, S, KV, hd), all float32
// or all bfloat16 (dtype), hd 64 or 128, 16-byte aligned; lse (B, S, KV,
// G) float32 from the forward; delta (B, S, KV, G) float32 scratch. Two
// launches on `stream` (bfloat16: the tensor-core kernels, float32: the
// CUDA-core ones); returns the first failing cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int B, int S, int KV, int G, int hd, float scale, int dtype,
    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32 && hd == 64)
    return launch_f32<64>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, S,
                          KV, G, scale, s);
  if (dtype == repro::kF32 && hd == 128)
    return launch_f32<128>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, S,
                           KV, G, scale, s);
  if (dtype == repro::kBF16 && hd == 64)
    return launch_tc<64>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, S,
                         KV, G, scale, s);
  if (dtype == repro::kBF16 && hd == 128)
    return launch_tc<128>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, S,
                          KV, G, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory, in bytes, of the bfloat16 route's dq_tc_kernel
// (which 0) or dkv_tc_kernel (which 1) at head dim hd; -1 for a head dim
// they do not take.
extern "C" int flash_attention_bwd_tc_smem(int hd, int which) {
  if (hd == 64)
    return static_cast<int>(which ? BwdTile<64>::kDkvBytes
                                  : BwdTile<64>::kDqBytes);
  if (hd == 128)
    return static_cast<int>(which ? BwdTile<128>::kDkvBytes
                                  : BwdTile<128>::kDqBytes);
  return -1;
}
