// Dequantize-fused matmul, W8A16 and W4A16.
//
// Replaces: src/repro/kernels/qmatmul.py qmatmul_pallas (_qmm_kernel) and
// qmatmul4_pallas (_qmm4_kernel).
//
// Computes out (M, N) = x (M, K) @ (codes (K, N) * scale + mu): codes are
// uint8, or two 4-bit codes per byte (low nibble = even column); scale/mu
// are f32, per tensor (one value) or per output column (N values, in
// unpacked column space). Dequantization and accumulation run in f32 and
// the result is cast to the output dtype once, as on the TPU.
//
// What bounds it on an H100: at decode (M = batch, 1..4 rows) the product
// is a matrix-vector one, bounded by the weight bytes (K*N for int8,
// K*N/2 for int4) over 3.35 TB/s; at prefill (M = B*S rows) by its
// 2*M*K*N operations.
//
// What the design does about it: the codes are the only weight bytes read
// from device memory -- each CTA dequantizes its 32 x 64 code tile into
// shared memory as f32, so the full-precision weight never exists in
// device memory -- and every thread accumulates an RM x 4 register tile
// with FMAs. BM = 16 rows at decode sizes (M <= 16), 64 above. Ragged
// M/N/K edges are masked on load and store, so no shape has to be a tile
// multiple (d_model 576, H_pad*hd 1024, d_ff 1536). This first version
// runs on the CUDA cores and leaves decode far from its byte bound: at
// M <= 16 only ceil(N/64) CTAs exist (9..24 of 132 SMs on smollm-135m).
// Split-K over more CTAs, and wgmma for prefill, are the later fixes.
#include "common.cuh"

namespace {

constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;  // a 16 x 16 thread grid over the tile

template <typename TX, typename TO, int RM, bool PACKED>
__global__ void __launch_bounds__(kThreads)
    qmm_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ codes,
               const float* __restrict__ scale, const float* __restrict__ mu,
               TO* __restrict__ out, int M, int K, int N, int per_col) {
  constexpr int BM = 16 * RM;
  __shared__ float xs[kBK][BM + 1];             // x tile, k-major
  __shared__ __align__(16) float ws[kBK][kBN + 4];  // dequantized codes
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // owns output columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // owns output rows ty*RM .. ty*RM+RM-1
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const size_t row_bytes = PACKED ? N / 2 : N;

  float acc[RM][4];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < BM * kBK; i += kThreads) {
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
      for (int r = 0; r < RM; ++r) {
        const float a = xs[kk][ty * RM + r];
        acc[r][0] = fmaf(a, b.x, acc[r][0]);
        acc[r][1] = fmaf(a, b.y, acc[r][1]);
        acc[r][2] = fmaf(a, b.z, acc[r][2]);
        acc[r][3] = fmaf(a, b.w, acc[r][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int gm = m0 + ty * RM + r;
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

template <typename TX, typename TO, bool PACKED>
cudaError_t launch(const void* x, const void* codes, const void* scale,
                   const void* mu, void* out, int M, int K, int N,
                   int per_col, cudaStream_t stream) {
  const auto* xp = static_cast<const TX*>(x);
  const auto* cp = static_cast<const uint8_t*>(codes);
  const auto* sp = static_cast<const float*>(scale);
  const auto* mp = static_cast<const float*>(mu);
  auto* op = static_cast<TO*>(out);
  const int gn = (N + kBN - 1) / kBN;
  if (M <= 16) {
    qmm_kernel<TX, TO, 1, PACKED><<<dim3(gn, (M + 15) / 16), kThreads, 0,
                                    stream>>>(xp, cp, sp, mp, op, M, K, N,
                                              per_col);
  } else {
    qmm_kernel<TX, TO, 4, PACKED><<<dim3(gn, (M + 63) / 64), kThreads, 0,
                                    stream>>>(xp, cp, sp, mp, op, M, K, N,
                                              per_col);
  }
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
