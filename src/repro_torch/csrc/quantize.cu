// Asymmetric uniform quantize, fused quantize-and-pack-int4, dequantize.
//
// Replaces: src/repro/kernels/quantize.py quantize_pallas
// (_quantize_kernel), quantize_pack4_pallas (_quantize_pack4_kernel) and
// dequantize_pallas (_dequantize_kernel).
//
// Computes, on a (rows, N) operand whose scale/mu are (G, N) per column or
// (G, 1) per tensor, row r taking metadata row r / (rows / G):
//   quantize:  codes = clip(round((x - mu) / scale), 0, levels)  -> uint8
//   pack4:     the same at levels 15, byte j = q[2j] | q[2j+1] << 4
//   dequantize: codes * scale + mu                   -> float32 / bfloat16
// G = 1 is the reference's per-tensor / per-column layout; G = P (periods)
// quantizes a whole stacked leaf in ONE launch where the reference
// dispatched one (vmapped) kernel per period slice.
//
// Bit-exactness with the plain PyTorch versions: the subtraction and the
// division are IEEE (__fsub_rn, __fdiv_rn -- never a reciprocal multiply,
// and the build has no --use_fast_math), rounding is rintf (half to even,
// as torch.round / jnp.round), and dequantize rounds twice (__fmul_rn then
// __fadd_rn, no FMA contraction), as two torch ops do. With x_round a
// bfloat16 x has x - mu and the quotient each rounded to bfloat16
// (__float2bfloat16_rn after the f32 op): the reference's int8-code branch
// of quantize_stacked computes a leaf in its own dtype, and an f32 op
// rounded once to bfloat16 is the correctly rounded bfloat16 op (24 >=
// 2 * 8 + 2 bits, so the double rounding is innocuous).
//
// What bounds it on an H100: these are streaming passes of 1-2 flops per
// element, bounded by the bytes over 3.35 TB/s (a full-width smollm-135m
// w_gate leaf, 30 x 576 x 1536 f32, moves 133 MB through quantize).
//
// What the design does about it: each thread owns 4 adjacent columns of a
// row and, where the row width allows (N % 4 == 0, 16-byte aligned
// pointers), loads them with one 16-byte (f32) or 8-byte (bf16) access and
// stores its 4 codes / 2 packed bytes / 4 outputs with one access, so a
// warp touches 512 contiguous input bytes. A block is 32 column chunks x 8
// rows; the grid covers the columns and strides over the rows. Ragged
// edges (any N, any rows) are masked with a scalar path.
#include "common.cuh"

namespace {

constexpr int kVec = 4;   // columns per thread
constexpr int kTx = 32;   // column chunks per block
constexpr int kTy = 8;    // rows per block (per grid-stride step)

__device__ __forceinline__ void load4(const float* p, float (&v)[kVec]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[kVec]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[kVec]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool XROUND>
__device__ __forceinline__ unsigned quantize_one(float x, float s, float z,
                                                 float levels) {
  float d = __fsub_rn(x, z);
  if (XROUND) d = round_bf16(d);
  float q = __fdiv_rn(d, s);
  if (XROUND) q = round_bf16(q);
  q = rintf(q);
  return static_cast<unsigned>(fminf(fmaxf(q, 0.f), levels));
}

// Offset of row r's metadata: groups of rows_per_group rows share one row
// of a (G, N) or (G, 1) scale/mu.
__device__ __forceinline__ size_t meta_offset(int r, int rows_per_group,
                                              int n, int per_col, int c0) {
  const size_t g = static_cast<size_t>(r / rows_per_group);
  return per_col ? g * n + c0 : g;
}

template <typename TX, bool PACK, bool VEC, bool XROUND>
__global__ void __launch_bounds__(kTx* kTy)
    quantize_kernel(const TX* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ mu, uint8_t* __restrict__ out,
                    int rows, int n, int rows_per_group, int per_col,
                    float levels) {
  const int c0 = (blockIdx.x * kTx + threadIdx.x) * kVec;
  if (c0 >= n) return;
  const int width = min(kVec, n - c0);  // 4, or the row's ragged tail
  const size_t out_row = PACK ? n / 2 : n;
  for (int r = blockIdx.y * kTy + threadIdx.y; r < rows;
       r += gridDim.y * kTy) {
    const TX* xr = x + static_cast<size_t>(r) * n + c0;
    const size_t m = meta_offset(r, rows_per_group, n, per_col, c0);
    float v[kVec];
    if (VEC) {
      load4(xr, v);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        v[j] = j < width ? repro::to_f32(xr[j]) : 0.f;
    }
    unsigned q[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int jm = per_col ? j : 0;
      q[j] = j < width ? quantize_one<XROUND>(v[j], scale[m + jm],
                                              mu[m + jm], levels)
                       : 0u;
    }
    if (PACK) {
      uint8_t* o = out + static_cast<size_t>(r) * out_row + c0 / 2;
      const unsigned lo = q[0] | (q[1] << 4), hi = q[2] | (q[3] << 4);
      if (VEC) {
        *reinterpret_cast<uint16_t*>(o) =
            static_cast<uint16_t>(lo | (hi << 8));
      } else {
        o[0] = static_cast<uint8_t>(lo);  // n is even: width is 2 or 4
        if (width == kVec) o[1] = static_cast<uint8_t>(hi);
      }
    } else {
      uint8_t* o = out + static_cast<size_t>(r) * out_row + c0;
      if (VEC) {
        *reinterpret_cast<unsigned*>(o) =
            q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          if (j < width) o[j] = static_cast<uint8_t>(q[j]);
      }
    }
  }
}

template <typename TO, bool VEC>
__global__ void __launch_bounds__(kTx* kTy)
    dequantize_kernel(const uint8_t* __restrict__ codes,
                      const float* __restrict__ scale,
                      const float* __restrict__ mu, TO* __restrict__ out,
                      int rows, int n, int rows_per_group, int per_col) {
  const int c0 = (blockIdx.x * kTx + threadIdx.x) * kVec;
  if (c0 >= n) return;
  const int width = min(kVec, n - c0);
  for (int r = blockIdx.y * kTy + threadIdx.y; r < rows;
       r += gridDim.y * kTy) {
    const size_t at = static_cast<size_t>(r) * n + c0;
    const size_t m = meta_offset(r, rows_per_group, n, per_col, c0);
    unsigned c[kVec];
    if (VEC) {
      const unsigned word = *reinterpret_cast<const unsigned*>(codes + at);
#pragma unroll
      for (int j = 0; j < kVec; ++j) c[j] = (word >> (8 * j)) & 0xFFu;
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) c[j] = j < width ? codes[at + j] : 0u;
    }
    float w[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int jm = per_col ? j : 0;
      w[j] = j < width ? __fadd_rn(__fmul_rn(static_cast<float>(c[j]),
                                             scale[m + jm]),
                                   mu[m + jm])
                       : 0.f;
    }
    if (VEC) {
      store4(out + at, w);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        if (j < width) out[at + j] = repro::from_f32<TO>(w[j]);
    }
  }
}

dim3 grid_for(int rows, int n) {
  const int chunks = (n + kVec - 1) / kVec;
  const int row_blocks = (rows + kTy - 1) / kTy;
  return dim3((chunks + kTx - 1) / kTx, row_blocks < 65535 ? row_blocks
                                                           : 65535);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename TX, bool PACK, bool XROUND>
cudaError_t launch_quantize(const void* x, const float* scale,
                            const float* mu, uint8_t* out, int rows, int n,
                            int rows_per_group, int per_col, float levels,
                            cudaStream_t stream) {
  const auto* xp = static_cast<const TX*>(x);
  const dim3 grid = grid_for(rows, n), block(kTx, kTy);
  if (n % kVec == 0 && aligned16(x) && aligned16(out)) {
    quantize_kernel<TX, PACK, true, XROUND><<<grid, block, 0, stream>>>(
        xp, scale, mu, out, rows, n, rows_per_group, per_col, levels);
  } else {
    quantize_kernel<TX, PACK, false, XROUND><<<grid, block, 0, stream>>>(
        xp, scale, mu, out, rows, n, rows_per_group, per_col, levels);
  }
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_quantize_packing(int pack4, const void* x,
                                    const float* scale, const float* mu,
                                    uint8_t* out, int rows, int n,
                                    int rows_per_group, int per_col,
                                    float levels, cudaStream_t stream) {
  return pack4 ? launch_quantize<TX, true, false>(x, scale, mu, out, rows, n,
                                                  rows_per_group, per_col,
                                                  levels, stream)
               : launch_quantize<TX, false, false>(x, scale, mu, out, rows,
                                                   n, rows_per_group,
                                                   per_col, levels, stream);
}

template <typename TO>
cudaError_t launch_dequantize(const uint8_t* codes, const float* scale,
                              const float* mu, void* out, int rows, int n,
                              int rows_per_group, int per_col,
                              cudaStream_t stream) {
  auto* op = static_cast<TO*>(out);
  const dim3 grid = grid_for(rows, n), block(kTx, kTy);
  if (n % kVec == 0 && aligned16(codes) && aligned16(out)) {
    dequantize_kernel<TO, true><<<grid, block, 0, stream>>>(
        codes, scale, mu, op, rows, n, rows_per_group, per_col);
  } else {
    dequantize_kernel<TO, false><<<grid, block, 0, stream>>>(
        codes, scale, mu, op, rows, n, rows_per_group, per_col);
  }
  return cudaGetLastError();
}

}  // namespace

// x (rows, n) float32/bfloat16; scale/mu float32 (groups, n) when per_col,
// else (groups, 1), groups dividing rows; out (rows, n) uint8 codes in
// [0, levels], or (rows, n / 2) packed nibbles when pack4 (n even, levels
// 15). x_round (bfloat16 x, unpacked codes only) rounds x - mu and the
// quotient to bfloat16. Returns the launch's cudaError_t.
extern "C" int quantize_launch(const void* x, const void* scale,
                               const void* mu, void* out, int rows, int n,
                               int groups, int per_col, int levels,
                               int x_dtype, int pack4, int x_round,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0 || groups <= 0 || rows % groups != 0 ||
      (pack4 && n % 2 != 0) || (x_round && (pack4 || x_dtype != repro::kBF16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* sp = static_cast<const float*>(scale);
  const auto* mp = static_cast<const float*>(mu);
  auto* op = static_cast<uint8_t*>(out);
  const int rpg = rows / groups;
  const float lv = static_cast<float>(levels);
  if (x_dtype == repro::kF32)
    return launch_quantize_packing<float>(pack4, x, sp, mp, op, rows, n, rpg,
                                          per_col, lv, s);
  if (x_dtype == repro::kBF16 && x_round)
    return launch_quantize<__nv_bfloat16, false, true>(x, sp, mp, op, rows, n,
                                                       rpg, per_col, lv, s);
  if (x_dtype == repro::kBF16)
    return launch_quantize_packing<__nv_bfloat16>(pack4, x, sp, mp, op, rows,
                                                  n, rpg, per_col, lv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// codes (rows, n) uint8; scale/mu as for quantize_launch; out (rows, n)
// float32/bfloat16. Returns the launch's cudaError_t.
extern "C" int dequantize_launch(const void* codes, const void* scale,
                                 const void* mu, void* out, int rows, int n,
                                 int groups, int per_col, int out_dtype,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0 || groups <= 0 || rows % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* cp = static_cast<const uint8_t*>(codes);
  const auto* sp = static_cast<const float*>(scale);
  const auto* mp = static_cast<const float*>(mu);
  const int rpg = rows / groups;
  if (out_dtype == repro::kF32)
    return launch_dequantize<float>(cp, sp, mp, out, rows, n, rpg, per_col,
                                    s);
  if (out_dtype == repro::kBF16)
    return launch_dequantize<__nv_bfloat16>(cp, sp, mp, out, rows, n, rpg,
                                            per_col, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
