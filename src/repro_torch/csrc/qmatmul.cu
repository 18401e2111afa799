// Dequantize-fused matmul, W8A16 and W4A16.
//
// Replaces: src/repro/kernels/qmatmul.py qmatmul_pallas (_qmm_kernel) and
// qmatmul4_pallas (_qmm4_kernel).
//
// Computes out (M, N) = x (M, K) @ (codes (K, N) * scale + mu): codes are
// uint8, or two 4-bit codes per byte (low nibble = even column); scale/mu
// are f32, per tensor (one value) or per output column (N values, in
// unpacked column space). Dequantization (__fmul_rn then __fadd_rn, no FMA
// contraction, as the plain version's two ops) and accumulation run in
// f32 and the result is cast to the output dtype once, as on the TPU.
//
// What bounds it on an H100: at decode (M = batch, 1..4 rows) the product
// is a matrix-vector one, bounded by the weight bytes (K*N for int8,
// K*N/2 for int4) over 3.35 TB/s -- well under a microsecond on
// smollm-135m's projections, so in practice by the latency of the loads
// and of the launch; at prefill (M = B*S rows) by its 2*M*K*N operations.
//
// Two designs, picked by M:
//
// M <= 16, both code widths -- the skinny split-K path, one template on
// the code width. A thread-block cluster of up to 16 CTAs (8 above M = 4)
// shares one 128-column N tile and one pair of x rows; each CTA takes a K
// slice of at least 72 rows. A thread loads codes as 16-byte vectors (32
// nibbles or 16 bytes along N: the 4 or 8 lanes of a row read one 64- or
// 128-byte row segment, so a warp covers 8 or 4 rows), eight vectors in
// flight before x is staged in shared memory, and dequantizes them in
// registers against its columns' scale/mu, also in registers (a code
// converts to float exactly: 2^23 + code, minus 2^23). Partials are
// reduced in a fixed order with no float atomics, so every call gives the
// same bits: the row lanes of a column by halving shuffle exchanges (each
// step keeps half the values), the 4 warps through shared memory, and
// the cluster's CTAs by storing each CTA's sums into the leader CTA's
// shared memory (cluster.map_shared_rank) ahead of one cluster barrier,
// after which the leader adds them in rank order. One launch covers the
// whole product: at M = 2 a (576, 1536) weight runs as 96 CTAs, each
// walking 72 K rows, where a tiled kernel runs ceil(N/64) = 24 CTAs over
// all 576 rows in a serial chain of loads and barriers. Codes that are
// not 16-byte aligned, or rows whose width is not a whole number of
// vectors, load byte by byte into the same registers.
//
// M > 16 (prefill) -- the tiled kernel: each CTA dequantizes its 32 x 64
// code tile once into shared memory as f32 (the full-precision weight
// never exists in device memory) and every thread accumulates a 4 x 4
// register tile of a 64 x 64 output block with FMAs on the CUDA cores.
// Ragged M/N/K edges are masked on load and store in both designs, so no
// shape has to be a tile multiple (d_model 576, H_pad*hd 1024, d_ff 1536).
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Tiled: M > 16

constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kRM = 4;         // output rows a thread accumulates
constexpr int kBM = 16 * kRM;
constexpr int kThreads = 256;  // a 16 x 16 thread grid over the tile

template <typename TX, typename TO, bool PACKED>
__global__ void __launch_bounds__(kThreads)
    qmm_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ codes,
               const float* __restrict__ scale, const float* __restrict__ mu,
               TO* __restrict__ out, int M, int K, int N, int per_col) {
  __shared__ float xs[kBK][kBM + 1];             // x tile, k-major
  __shared__ __align__(16) float ws[kBK][kBN + 4];  // dequantized codes
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // owns output columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // owns output rows ty*kRM .. ty*kRM+kRM-1
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const size_t row_bytes = PACKED ? N / 2 : N;

  float acc[kRM][4];
#pragma unroll
  for (int r = 0; r < kRM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < K)
                     ? repro::to_f32(x[static_cast<size_t>(gm) * K + gk])
                     : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const int gk = k0 + r, gn = n0 + c;
      float w = 0.f;
      if (gk < K && gn < N) {
        unsigned code;
        if (PACKED) {
          const uint8_t b = codes[gk * row_bytes + gn / 2];
          code = (gn & 1) ? (b >> 4) : (b & 0xF);
        } else {
          code = codes[gk * row_bytes + gn];
        }
        const float s = per_col ? scale[gn] : scale[0];
        const float z = per_col ? mu[gn] : mu[0];
        // codes * scale + mu without FMA contraction, as the plain version
        w = __fadd_rn(__fmul_rn(static_cast<float>(code), s), z);
      }
      ws[r][c] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
#pragma unroll
      for (int r = 0; r < kRM; ++r) {
        const float a = xs[kk][ty * kRM + r];
        acc[r][0] = fmaf(a, b.x, acc[r][0]);
        acc[r][1] = fmaf(a, b.y, acc[r][1]);
        acc[r][2] = fmaf(a, b.z, acc[r][2]);
        acc[r][3] = fmaf(a, b.w, acc[r][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    const int gm = m0 + ty * kRM + r;
    if (gm >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gn = n0 + tx * 4 + c;
      if (gn < N)
        out[static_cast<size_t>(gm) * N + gn] =
            repro::from_f32<TO>(acc[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// M <= 16, uint8 or packed int4 codes: split K over a thread-block cluster

namespace cg = cooperative_groups;

constexpr int kSkTN = 128;                      // output columns per CTA
constexpr int kSkWarps = 4;
constexpr int kSkThreads = 32 * kSkWarps;
constexpr int kSkUnroll = 8;                    // vectors in flight
constexpr int kSkMT = 2;                        // x rows per CTA
constexpr int kSkPortableSplit = 8;             // portable cluster size
constexpr int kSkMaxSplit = 16;                 // the H100's largest
constexpr int kSkMinRows = 72;                  // K rows per CTA, at least

// The lane layout of one code width (BITS = 4 or 8): a 16-byte vector
// holds kCols columns, kVecs vectors span the CTA's 128 columns, and the
// 32 / kVecs lanes of a warp that share a vector's columns take
// consecutive K rows (kRows rows a CTA per load step).
template <int BITS>
struct Skinny {
  static constexpr int kCols = 128 / BITS;
  static constexpr int kVecs = kSkTN / kCols;
  static constexpr int kRowLanes = 32 / kVecs;
  static constexpr int kRows = kSkThreads / kVecs;
  static constexpr int kColsPerByte = 8 / BITS;
  static constexpr int kPerWord = 32 / BITS;    // codes in a 32-bit word
};

// x rows m0, m0 + 1 over the CTA's K slice as (x[m0][k], x[m0 + 1][k]),
// two K rows a thread in flight before either is stored
template <typename TX>
__device__ __forceinline__ void stage_x_pairs(const TX* __restrict__ x,
                                              float2* xs, int M, int K,
                                              int m0, int k0, int k_len) {
  for (int i0 = threadIdx.x; i0 < k_len; i0 += 2 * kSkThreads) {
    float2 v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u * kSkThreads;
      const size_t at = static_cast<size_t>(m0) * K + k0 + i;
      v[u] = make_float2(0.f, 0.f);
      if (i < k_len)
        v[u] = make_float2(repro::to_f32(x[at]),
                           m0 + 1 < M ? repro::to_f32(x[at + K]) : 0.f);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (i0 + u * kSkThreads < k_len) xs[i0 + u * kSkThreads] = v[u];
  }
}

// kSkUnroll code vectors of rows kk, kk + kRows, ... of the K slice
// (zeros past k_len); without VEC, byte by byte up to column N
template <int BITS, bool VEC>
__device__ __forceinline__ void load_code_batch(uint4 (&vec)[kSkUnroll],
                                                const uint8_t* base, int kk,
                                                int k_len, size_t row_bytes,
                                                int c0, int N) {
  using L = Skinny<BITS>;
#pragma unroll
  for (int u = 0; u < kSkUnroll; ++u) {
    const int row = kk + u * L::kRows;
    vec[u] = make_uint4(0u, 0u, 0u, 0u);
    if (row >= k_len) continue;
    const uint8_t* p = base + static_cast<size_t>(row) * row_bytes;
    if (VEC) {
      vec[u] = __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j)  // packed N is even: a byte is whole
        if (c0 + j * L::kColsPerByte < N)
          w[j / 4] |= static_cast<uint32_t>(__ldg(p + j)) << (8 * (j % 4));
      vec[u] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// one halving exchange across lane bit `bit`: the lower lane keeps the
// lower half of `in` plus its partner's, the upper lane the upper half
template <int LEN>
__device__ __forceinline__ void halve(const float (&in)[2 * LEN],
                                      float (&out)[LEN], int lane, int bit) {
  const bool hi = lane & bit;
#pragma unroll
  for (int i = 0; i < LEN; ++i)
    out[i] = (hi ? in[i + LEN] : in[i]) +
             __shfl_xor_sync(0xffffffffu, hi ? in[i] : in[i + LEN], bit);
}

template <int BITS, typename TX, typename TO, bool PER_COL, bool VEC>
__global__ void __launch_bounds__(kSkThreads)
    qmm_skinny(const TX* __restrict__ x, const uint8_t* __restrict__ codes,
               const float* __restrict__ scale, const float* __restrict__ mu,
               TO* __restrict__ out, int M, int K, int N, int k_slice) {
  using L = Skinny<BITS>;
  constexpr int kC = L::kCols;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = static_cast<int>(cluster.num_blocks());
  // matched by cluster_wait() before the push
  repro::cluster_arrive_relaxed();
  extern __shared__ __align__(16) float sk_smem[];
  float* gather = sk_smem;  // the leader's (split, kSkMT, kSkTN)
  float* wpart = gather + split * kSkMT * kSkTN;  // (warps, MT, TN)
  float2* xs = reinterpret_cast<float2*>(wpart + kSkWarps * kSkMT * kSkTN);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nv = lane % L::kVecs;            // which vector of the row
  const int kr = warp * L::kRowLanes + lane / L::kVecs;  // 0 .. kRows-1
  const int n0 = blockIdx.y * kSkTN;
  const int m0 = blockIdx.z * kSkMT;
  const int k0 = rank * k_slice;
  const int k_len = max(0, min(k_slice, K - k0));
  const int c0 = n0 + nv * kC;               // the thread's first column
  const bool live = c0 < N;
  const size_t row_bytes = static_cast<size_t>(N) / L::kColsPerByte;

  // every global load -- the first batch of code vectors, scale/mu, x --
  // is issued before any of them is waited for: one memory latency
  const uint8_t* base = codes + static_cast<size_t>(k0) * row_bytes +
                        c0 / L::kColsPerByte;
  uint4 vec[kSkUnroll];
  if (live)
    load_code_batch<BITS, VEC>(vec, base, kr, k_len, row_bytes, c0, N);
  float s_reg[PER_COL ? kC : 1], z_reg[PER_COL ? kC : 1];
  if (PER_COL) {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const bool ok = c0 + c < N;
      s_reg[c] = ok ? scale[c0 + c] : 0.f;
      z_reg[c] = ok ? mu[c0 + c] : 0.f;
    }
  } else {
    s_reg[0] = scale[0];
    z_reg[0] = mu[0];
  }
  stage_x_pairs(x, xs, M, K, m0, k0, k_len);
  float acc0[kC], acc1[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) acc0[c] = acc1[c] = 0.f;
  __syncthreads();

  constexpr int kStep = kSkUnroll * L::kRows;
  for (int kk = kr; live && kk < k_len; kk += kStep) {
#pragma unroll
    for (int u = 0; u < kSkUnroll; ++u) {
      const int row = kk + u * L::kRows;
      if (row >= k_len) break;
      const float2 xv = xs[row];
      const uint32_t words[4] = {vec[u].x, vec[u].y, vec[u].z, vec[u].w};
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {
#pragma unroll
        for (int j = 0; j < L::kPerWord; ++j) {
          const int c = wi * L::kPerWord + j;
          // code -> float exactly: 2^23 + code, minus 2^23
          const uint32_t bits =
              (words[wi] >> (BITS * j)) & ((1u << BITS) - 1u);
          const float code =
              __fsub_rn(__uint_as_float(0x4B000000u | bits), 8388608.f);
          const float w = __fadd_rn(__fmul_rn(code, s_reg[PER_COL ? c : 0]),
                                    z_reg[PER_COL ? c : 0]);
          acc0[c] = fmaf(xv.x, w, acc0[c]);
          acc1[c] = fmaf(xv.y, w, acc1[c]);
        }
      }
    }
    if (kk + kStep < k_len)
      load_code_batch<BITS, VEC>(vec, base, kk + kStep, k_len, row_bytes,
                                 c0, N);
  }

  // The row lanes that share a vector's columns (lane bits 4 .. 2 for
  // int4, 4 .. 3 for int8) are reduced by halving exchanges: each keeps
  // half of its values and adds its partner's copy of that half, so a lane
  // ends with 8 sums -- x row (lane bit 4) and 8 of its vector's columns.
  // Each step writes a new array: done in place, the int4 kernel measured
  // 5-15% slower at M = 4.
  float h[kC];
  {
    const bool hi = lane & 16;
#pragma unroll
    for (int i = 0; i < kC; ++i)
      h[i] = (hi ? acc1[i] : acc0[i]) +
             __shfl_xor_sync(0xffffffffu, hi ? acc0[i] : acc1[i], 16);
  }
  float part[8];
  if constexpr (BITS == 4) {
    float qq[16];
    halve<16>(h, qq, lane, 8);
    halve<8>(qq, part, lane, 4);
  } else {
    halve<8>(h, part, lane, 8);
  }
  {
    const int row = (lane >> 4) & 1;
    const int col =
        nv * kC + ((lane / L::kVecs) % (L::kRowLanes / 2)) * 8;
    float4* dst = reinterpret_cast<float4*>(
        wpart + (warp * kSkMT + row) * kSkTN + col);
    dst[0] = make_float4(part[0], part[1], part[2], part[3]);
    dst[1] = make_float4(part[4], part[5], part[6], part[7]);
  }
  __syncthreads();

  // the CTA's partial goes to the cluster's leader (rank 0), whose shared
  // memory holds one slot per rank; once every rank has stored, the
  // leader sums the slots in rank order
  repro::cluster_wait();  // the start-up arrive: every CTA runs
  float* lead = cluster.map_shared_rank(gather, 0);
  for (int i = tid; i < kSkMT * kSkTN; i += kSkThreads) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kSkWarps; ++w) sum += wpart[w * kSkMT * kSkTN + i];
    lead[rank * kSkMT * kSkTN + i] = sum;
  }
  cluster.sync();
  if (rank != 0) return;
  for (int i = tid; i < kSkMT * kSkTN; i += kSkThreads) {
    const int m = i / kSkTN, t = i % kSkTN;
    const int gm = m0 + m, gn = n0 + t;
    if (gm >= M || gn >= N) continue;
    float v[kSkMaxSplit];  // all slots in flight, then added in order
#pragma unroll
    for (int j = 0; j < kSkMaxSplit; ++j)
      v[j] = j < split ? gather[j * kSkMT * kSkTN + i] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kSkMaxSplit; ++j)
      if (j < split) sum += v[j];
    out[static_cast<size_t>(gm) * N + gn] = repro::from_f32<TO>(sum);
  }
}

// K slices (the cluster's CTAs), rows per slice and dynamic shared memory
// of one skinny launch (the same for both code widths)
struct SkinnyPlan {
  int split, k_slice;
  size_t smem;
};

SkinnyPlan skinny_plan(int M, int K) {
  // up to 16 K slices at M <= 4 (above, the m-groups add CTAs anyway)
  const int max_split = M <= 4 ? kSkMaxSplit : kSkPortableSplit;
  SkinnyPlan p;
  p.split = max(1, min(max_split, (K + kSkMinRows - 1) / kSkMinRows));
  p.k_slice = (K + p.split - 1) / p.split;
  p.smem = sizeof(float) * kSkMT * kSkTN * (p.split + kSkWarps) +
           sizeof(float2) * static_cast<size_t>(p.k_slice);
  return p;
}

template <int BITS, typename TX, typename TO, bool PER_COL, bool VEC>
cudaError_t launch_skinny_as(const TX* x, const uint8_t* codes,
                             const float* scale, const float* mu, TO* out,
                             int M, int K, int N, cudaStream_t stream) {
  const SkinnyPlan plan = skinny_plan(M, K);
  const int split = plan.split, k_slice = plan.k_slice;
  const size_t smem = plan.smem;
  auto kernel = qmm_skinny<BITS, TX, TO, PER_COL, VEC>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err == cudaSuccess && split > kSkPortableSplit)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (N + kSkTN - 1) / kSkTN,
                     (M + kSkMT - 1) / kSkMT);
  cfg.blockDim = dim3(kSkThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, codes, scale, mu, out, M, K, N,
                           k_slice);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int BITS, typename TX, typename TO>
cudaError_t launch_skinny(const TX* x, const uint8_t* codes,
                          const float* scale, const float* mu, TO* out,
                          int M, int K, int N, int per_col,
                          cudaStream_t stream) {
  // whole vectors only: rows a multiple of 16 bytes, codes 16-byte aligned
  const bool vec = (N % Skinny<BITS>::kCols == 0) &&
                   (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  if (per_col)
    return vec ? launch_skinny_as<BITS, TX, TO, true, true>(
                     x, codes, scale, mu, out, M, K, N, stream)
               : launch_skinny_as<BITS, TX, TO, true, false>(
                     x, codes, scale, mu, out, M, K, N, stream);
  return vec ? launch_skinny_as<BITS, TX, TO, false, true>(
                   x, codes, scale, mu, out, M, K, N, stream)
             : launch_skinny_as<BITS, TX, TO, false, false>(
                   x, codes, scale, mu, out, M, K, N, stream);
}

// ---------------------------------------------------------------------------
// Dispatch

template <typename TX, typename TO, bool PACKED>
cudaError_t launch(const void* x, const void* codes, const void* scale,
                   const void* mu, void* out, int M, int K, int N,
                   int per_col, cudaStream_t stream) {
  const auto* xp = static_cast<const TX*>(x);
  const auto* cp = static_cast<const uint8_t*>(codes);
  const auto* sp = static_cast<const float*>(scale);
  const auto* mp = static_cast<const float*>(mu);
  auto* op = static_cast<TO*>(out);
  if (M <= 16)
    return launch_skinny<PACKED ? 4 : 8, TX, TO>(xp, cp, sp, mp, op, M, K, N,
                                                 per_col, stream);
  qmm_kernel<TX, TO, PACKED><<<dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM),
                               kThreads, 0, stream>>>(xp, cp, sp, mp, op, M,
                                                      K, N, per_col);
  return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t launch_packing(int packed, const void* x, const void* codes,
                           const void* scale, const void* mu, void* out,
                           int M, int K, int N, int per_col,
                           cudaStream_t stream) {
  return packed ? launch<TX, TO, true>(x, codes, scale, mu, out, M, K, N,
                                       per_col, stream)
                : launch<TX, TO, false>(x, codes, scale, mu, out, M, K, N,
                                        per_col, stream);
}

}  // namespace

// x (M, K) float32/bfloat16; codes (K, N) uint8, or (K, N/2) when packed;
// scale/mu float32 with 1 value (per_col = 0) or N values (per_col = 1);
// out (M, N) float32/bfloat16. Returns the launch's cudaError_t.
extern "C" int qmatmul_launch(const void* x, const void* codes,
                              const void* scale, const void* mu, void* out,
                              int M, int K, int N, int x_dtype,
                              int out_dtype, int per_col, int packed,
                              void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  using repro::kBF16;
  using repro::kF32;
  if (x_dtype == kF32 && out_dtype == kF32)
    return launch_packing<float, float>(packed, x, codes, scale, mu, out, M,
                                        K, N, per_col, s);
  if (x_dtype == kF32 && out_dtype == kBF16)
    return launch_packing<float, __nv_bfloat16>(packed, x, codes, scale, mu,
                                                out, M, K, N, per_col, s);
  if (x_dtype == kBF16 && out_dtype == kF32)
    return launch_packing<__nv_bfloat16, float>(packed, x, codes, scale, mu,
                                                out, M, K, N, per_col, s);
  if (x_dtype == kBF16 && out_dtype == kBF16)
    return launch_packing<__nv_bfloat16, __nv_bfloat16>(
        packed, x, codes, scale, mu, out, M, K, N, per_col, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory, in bytes, of a launch at M <= 16 (either code
// width) that runs the skinny kernel; -1 where the tiled kernel runs.
extern "C" int qmatmul_skinny_smem(int M, int K) {
  if (M < 1 || M > 16 || K < 1) return -1;
  return static_cast<int>(skinny_plan(M, K).smem);
}
