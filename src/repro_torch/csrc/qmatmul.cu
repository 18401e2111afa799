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
// What bounds it on an H100: the weight bytes (K*N for int8, K*N/2 for
// int4) over 3.35 TB/s, and above M ~ 300 rows the 2*M*K*N operations --
// well under a microsecond on smollm-135m's projections at every M the
// paths run (2 to 256), so in practice the latency of the launch, the
// loads and the cross-CTA reduction.
//
// Three designs, picked by M and the activations' dtype:
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
// M > 16 (prefill, chunked prefill), bf16 activations -- the tensor-core
// kernel, one template on the code width (qmm_tc<BITS, MT>). A CTA owns
// a 64-column output tile of 32 rows (up to M = 64) or 128 rows (above,
// so that the weight is dequantized once per 128 rows) and one K slice;
// a thread-block cluster of up to 16 CTAs splits K. The split and the
// slice length come from (K, N) alone: about one wave of CTAs at one
// 32-row tile (w_up (576, 1536): 24 N tiles x 6 slices of 96 rows,
// w_down (1536, 576): 9 x 14 of 112). x and the raw code tile stream
// into shared memory by 16-byte cp.async, two 64-row stages in flight
// ahead of the one being used (every slice of the paths' shapes, 64 to
// 112 rows, is one memory latency). A thread dequantizes the codes of
// its B fragments straight from shared memory into registers, against
// its two columns' scale/mu held in registers, exactly as the plain
// version (__fmul_rn then __fadd_rn). A dequantized f32 weight w does
// not fit a bf16 operand, so it is split into w_hi = bf16(w) and w_lo =
// bf16(w - w_hi), and two mma.sync m16n8k16 bf16 products (x exact in
// bf16) accumulate into one f32 fragment: what is left of w is ~2^-17
// of it, the order of the plain version's f32 sum. The CTAs' partial
// tiles are reduced in rank order, each rank summing its share of the
// tile from every rank's shared memory (cluster.map_shared_rank): no
// float atomics, and since neither the split nor the in-CTA K order
// depends on M, an output row has the same bits at every M above 16.
// Rows of codes that are not whole 16-byte vectors, codes that are not
// 16-byte aligned, and x rows with K not a multiple of 8 load element
// by element into the same tiles.
//
// M > 16, f32 activations (the GPU tests only; no path of the port
// reaches them) -- the first design, kept: each CTA dequantizes its
// 32 x 64 code tile into shared memory as f32 and every thread
// accumulates a 4 x 4 register tile of a 64 x 64 output block with FMAs
// on the CUDA cores, walking all of K.
// Ragged M/N/K edges are masked on load and store in every design, so no
// shape has to be a tile multiple (d_model 576, H_pad*hd 1024, d_ff 1536).
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Tiled, f32 activations: M > 16

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
  const int max_split = M <= 4 ? kSkMaxSplit : repro::kPortableCluster;
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
  return repro::launch_cluster(
      qmm_skinny<BITS, TX, TO, PER_COL, VEC>,
      dim3(plan.split, (N + kSkTN - 1) / kSkTN, (M + kSkMT - 1) / kSkMT),
      dim3(kSkThreads), plan.smem, stream, x, codes, scale, mu, out, M, K, N,
      plan.k_slice);
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
// M > 16, bf16 activations, uint8 or packed int4 codes: tensor cores, K
// split over a thread-block cluster

using bf16 = __nv_bfloat16;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4;
using repro::mma_bf16;
using repro::pack_bf16;
using repro::smem_u32;

constexpr int kTcBN = 64;                 // output columns: 16 a warp
constexpr int kTcBK = 64;                 // K rows per pipeline stage
constexpr int kTcStages = 3;              // two loading ahead of one used
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcXStride = kTcBK + 8;     // bf16 per x row (+16 B)
constexpr int kTcPStride = kTcBN + 4;     // f32 per partial-tile row
constexpr int kTcTargetCtas = 132;        // the H100's SMs
constexpr int kTcMinRows = 64;            // K rows per slice, at least
constexpr int kTcMaxSplit = 16;           // the H100's largest cluster
constexpr int kTcGather = 8;              // ranks' partials in flight

// The shared-memory layout of one code width and row tile (MT m16 tiles):
// per stage an x tile (16 MT, kTcXStride) bf16 and a code tile of kTcBK
// rows of kCodeBytes, each row padded by 16 bytes (80 or 48: the byte
// reads of a fragment fall in distinct banks). Once the K loop is done
// the partial output tile (16 MT, kTcPStride) f32 takes the stages' place.
template <int BITS, int MT>
struct TcTile {
  static constexpr int kBM = 16 * MT;
  static constexpr int kCodeBytes = kTcBN * BITS / 8;
  static constexpr int kCodeStride = kCodeBytes + 16;
  static constexpr int kXBytes = kBM * kTcXStride * 2;
  static constexpr int kStageBytes = kXBytes + kTcBK * kCodeStride;
  static constexpr size_t kPartBytes = sizeof(float) * kBM * kTcPStride;
  static constexpr size_t kBytes =
      static_cast<size_t>(kTcStages) * kStageBytes > kPartBytes
          ? static_cast<size_t>(kTcStages) * kStageBytes
          : kPartBytes;
};

// K slices (the cluster's CTAs) and rows per slice, from K and N alone --
// never from M, so that an output row's sum runs in the same order at
// every M. Enough slices for about one wave at one row tile, each of at
// least kTcMinRows rows (a multiple of 16: an MMA step never straddles
// two slices).
struct TcPlan {
  int split, k_slice;
};

TcPlan tc_plan(int K, int N) {
  const int n_tiles = (N + kTcBN - 1) / kTcBN;
  int split = min(kTcMaxSplit, (kTcTargetCtas + n_tiles - 1) / n_tiles);
  split = max(1, min(split, (K + kTcMinRows - 1) / kTcMinRows));
  TcPlan p;
  p.k_slice = ((K + split - 1) / split + 15) / 16 * 16;
  p.split = (K + p.k_slice - 1) / p.k_slice;
  return p;
}

// f32 weights w0, w1 (consecutive K rows of one column) -> the bf16 pairs
// hi = bf16(w) and lo = bf16(w - hi) of two B-fragment registers
__device__ __forceinline__ void split_bf16(float w0, float w1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(w0, w1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(__fsub_rn(w0, hf.x), __fsub_rn(w1, hf.y));
}

template <int BITS, int MT, typename TO, bool VEC>
__global__ void __launch_bounds__(kTcThreads)
    qmm_tc(const bf16* __restrict__ x, const uint8_t* __restrict__ codes,
           const float* __restrict__ scale, const float* __restrict__ mu,
           TO* __restrict__ out, int M, int K, int N, int k_slice,
           int per_col) {
  using T = TcTile<BITS, MT>;
  constexpr int kBM = T::kBM;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = static_cast<int>(cluster.num_blocks());
  extern __shared__ __align__(16) unsigned char tc_smem[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row / column group
  const int n0 = blockIdx.y * kTcBN;
  const int m0 = blockIdx.z * kBM;
  const int k0 = rank * k_slice;
  const int k_len = max(0, min(k_slice, K - k0));
  const int n_steps = (k_len + kTcBK - 1) / kTcBK;
  const size_t row_bytes = static_cast<size_t>(N) * BITS / 8;
  const size_t byte0 = static_cast<size_t>(n0) * BITS / 8;

  // stage st <- slice rows [s kTcBK, (s + 1) kTcBK) of x (rows m0 ..) and
  // of the codes (columns n0 ..), zeros past the slice, M and N
  auto load_stage = [&](int s, int st) {
    const int kb = s * kTcBK;
    bf16* xs = reinterpret_cast<bf16*>(tc_smem + st * T::kStageBytes);
    uint8_t* cs = tc_smem + st * T::kStageBytes + T::kXBytes;
    if (VEC) {
      for (int i = tid; i < kBM * (kTcBK / 8); i += kTcThreads) {
        const int r = i / (kTcBK / 8), c = (i % (kTcBK / 8)) * 8;
        const bool ok = m0 + r < M && kb + c < k_len;
        cp_async16(smem_u32(xs + r * kTcXStride + c),
                   ok ? x + static_cast<size_t>(m0 + r) * K + k0 + kb + c
                      : x,
                   ok);
      }
      constexpr int kChunks = T::kCodeBytes / 16;
      for (int i = tid; i < kTcBK * kChunks; i += kTcThreads) {
        const int r = i / kChunks, c = (i % kChunks) * 16;
        const bool ok = kb + r < k_len && byte0 + c < row_bytes;
        cp_async16(smem_u32(cs + r * T::kCodeStride + c),
                   ok ? codes + static_cast<size_t>(k0 + kb + r) * row_bytes +
                            byte0 + c
                      : codes,
                   ok);
      }
    } else {
      for (int i = tid; i < kBM * kTcBK; i += kTcThreads) {
        const int r = i / kTcBK, c = i % kTcBK;
        xs[r * kTcXStride + c] =
            (m0 + r < M && kb + c < k_len)
                ? x[static_cast<size_t>(m0 + r) * K + k0 + kb + c]
                : __float2bfloat16_rn(0.f);
      }
      for (int i = tid; i < kTcBK * T::kCodeBytes; i += kTcThreads) {
        const int r = i / T::kCodeBytes, c = i % T::kCodeBytes;
        // packed N is even: a byte is whole
        cs[r * T::kCodeStride + c] =
            (kb + r < k_len && byte0 + c < row_bytes)
                ? codes[static_cast<size_t>(k0 + kb + r) * row_bytes +
                        byte0 + c]
                : 0;
      }
    }
  };

  // every stage that fits is in flight before scale/mu are read
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < n_steps) load_stage(s, s);
    cp_async_commit();
  }
  // the thread's two columns (one per n8 tile of the warp's 16)
  float s_reg[2], z_reg[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = n0 + warp * 16 + j * 8 + g;
    const bool ok = col < N;
    s_reg[j] = per_col ? (ok ? scale[col] : 0.f) : scale[0];
    z_reg[j] = per_col ? (ok ? mu[col] : 0.f) : mu[0];
  }
  float acc[MT][2][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;

  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kTcStages - 2>();  // stage s has landed
    __syncthreads();                 // ... for all, and s - 1 is consumed
    if (s + kTcStages - 1 < n_steps)
      load_stage(s + kTcStages - 1, (s + kTcStages - 1) % kTcStages);
    cp_async_commit();
    const int st = s % kTcStages;
    const bf16* xs = reinterpret_cast<const bf16*>(tc_smem +
                                                   st * T::kStageBytes);
    const uint8_t* cs = tc_smem + st * T::kStageBytes + T::kXBytes;
    const int n16 = (min(kTcBK, k_len - s * kTcBK) + 15) / 16;
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      if (kk >= n16) break;
      // the B fragments of the warp's two n8 tiles, hi and lo halves
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int cc = warp * 16 + j * 8 + g;  // the thread's tile column
        float w[4];  // K rows 2t, 2t + 1, 2t + 8, 2t + 9 of the step
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = kk * 16 + 2 * t + (q & 1) + (q >> 1) * 8;
          const unsigned code =
              BITS == 8
                  ? cs[r * T::kCodeStride + cc]
                  : (cs[r * T::kCodeStride + cc / 2] >> (4 * (cc & 1))) &
                        0xFu;
          // code -> float exactly: 2^23 + code, minus 2^23
          const float cf =
              __fsub_rn(__uint_as_float(0x4B000000u | code), 8388608.f);
          w[q] = __fadd_rn(__fmul_rn(cf, s_reg[j]), z_reg[j]);
        }
        split_bf16(w[0], w[1], bh[j][0], bl[j][0]);
        split_bf16(w[2], w[3], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_u32(xs + (mi * 16 + lane % 16) * kTcXStride +
                                kk * 16 + (lane / 16) * 8));
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_bf16(acc[mi][j], a, bh[j][0], bh[j][1]);
          mma_bf16(acc[mi][j], a, bl[j][0], bl[j][1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages

  // the CTA's partial tile in its own shared memory; once every rank has
  // stored, each rank sums its share of the tile over the ranks in order
  float* part = reinterpret_cast<float*>(tc_smem);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = mi * 16 + g, c = warp * 16 + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(part + r * kTcPStride + c) =
          make_float2(acc[mi][j][0], acc[mi][j][1]);
      *reinterpret_cast<float2*>(part + (r + 8) * kTcPStride + c) =
          make_float2(acc[mi][j][2], acc[mi][j][3]);
    }
  cluster.sync();
  constexpr int kQuads = kBM * kTcBN / 4;
  const int share = (kQuads + split - 1) / split;
  const int q_end = min(kQuads, (rank + 1) * share);
  for (int i = rank * share + tid; i < q_end; i += kTcThreads) {
    const int r = i / (kTcBN / 4), c = (i % (kTcBN / 4)) * 4;
    const int gm = m0 + r;
    if (gm >= M || n0 + c >= N) continue;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j0 = 0; j0 < split; j0 += kTcGather) {
      float4 v[kTcGather];  // kTcGather ranks' quads in flight, then added
#pragma unroll
      for (int j = 0; j < kTcGather; ++j)
        if (j0 + j < split)
          v[j] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(part, j0 + j) + r * kTcPStride + c);
#pragma unroll
      for (int j = 0; j < kTcGather; ++j)
        if (j0 + j < split) {
          sum[0] += v[j].x;
          sum[1] += v[j].y;
          sum[2] += v[j].z;
          sum[3] += v[j].w;
        }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n0 + c + e < N)
        out[static_cast<size_t>(gm) * N + n0 + c + e] =
            repro::from_f32<TO>(sum[e]);
  }
  cluster.sync();  // no CTA leaves while another reads its partial
}

template <int BITS, int MT, typename TO, bool VEC>
cudaError_t launch_tc_as(const bf16* x, const uint8_t* codes,
                         const float* scale, const float* mu, TO* out, int M,
                         int K, int N, int per_col, cudaStream_t stream) {
  const TcPlan plan = tc_plan(K, N);
  return repro::launch_cluster(
      qmm_tc<BITS, MT, TO, VEC>,
      dim3(plan.split, (N + kTcBN - 1) / kTcBN, (M + 16 * MT - 1) / (16 * MT)),
      dim3(kTcThreads), TcTile<BITS, MT>::kBytes, stream, x, codes, scale,
      mu, out, M, K, N, plan.k_slice, per_col);
}

// the row tile: 32 rows up to M = 64 (chunked prefill's M = 32 is one
// tile), 128 above, where a 32-row tile would dequantize every weight
// M / 32 times over
constexpr int kTcWideM = 64;

template <int BITS, typename TO, bool VEC>
cudaError_t launch_tc_rows(const bf16* x, const uint8_t* codes,
                           const float* scale, const float* mu, TO* out,
                           int M, int K, int N, int per_col,
                           cudaStream_t stream) {
  return M <= kTcWideM
             ? launch_tc_as<BITS, 2, TO, VEC>(x, codes, scale, mu, out, M, K,
                                              N, per_col, stream)
             : launch_tc_as<BITS, 8, TO, VEC>(x, codes, scale, mu, out, M, K,
                                              N, per_col, stream);
}

template <int BITS, typename TO>
cudaError_t launch_tc(const bf16* x, const uint8_t* codes,
                      const float* scale, const float* mu, TO* out, int M,
                      int K, int N, int per_col, cudaStream_t stream) {
  // whole vectors only: x rows and code rows multiples of 16 bytes, both
  // 16-byte aligned
  const bool vec = K % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (static_cast<size_t>(N) * BITS / 8) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  return vec ? launch_tc_rows<BITS, TO, true>(x, codes, scale, mu, out, M, K,
                                              N, per_col, stream)
             : launch_tc_rows<BITS, TO, false>(x, codes, scale, mu, out, M,
                                               K, N, per_col, stream);
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
  if constexpr (std::is_same_v<TX, bf16>) {
    return launch_tc<PACKED ? 4 : 8, TO>(xp, cp, sp, mp, op, M, K, N,
                                         per_col, stream);
  } else {
    qmm_kernel<TX, TO, PACKED>
        <<<dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM), kThreads, 0,
           stream>>>(xp, cp, sp, mp, op, M, K, N, per_col);
    return cudaGetLastError();
  }
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

// Dynamic shared memory, in bytes, of the tensor-core kernel (bf16 x) at
// code width ``bits`` (4 or 8) and M rows; -1 where it does not run.
extern "C" int qmatmul_tc_smem(int bits, int M) {
  if (M <= 16 || (bits != 4 && bits != 8)) return -1;
  if (M <= kTcWideM)
    return static_cast<int>(bits == 4 ? TcTile<4, 2>::kBytes
                                      : TcTile<8, 2>::kBytes);
  return static_cast<int>(bits == 4 ? TcTile<4, 8>::kBytes
                                    : TcTile<8, 8>::kBytes);
}

// K slices (CTAs per cluster) of the tensor-core kernel for a (K, N)
// weight: the same at every M above 16.
extern "C" int qmatmul_tc_split(int K, int N) {
  if (K < 1 || N < 1) return -1;
  return tc_plan(K, N).split;
}
