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
// once per step, over 3.35 TB/s -- a few FLOPs per byte. At smollm-135m's
// decode shapes (B 2..4, KVp 4, hd 64, about 100 live slots) that is
// 50-100 KB, tens of nanoseconds at the card's rate, so in practice a
// chain of latencies bounds it: the DRAM round trip of K/V, the scores
// and softmax, the combine of partial results, the store and the launch.
// One CTA per (batch row, kv head) walking the ring alone leaves most of
// the 132 SMs idle (8 CTAs at batch 2) and serialises all of that chain.
//
// What the design does about it -- flash decoding over a thread-block
// cluster. The live slots [0, n_valid) are cut into contiguous ranges of
// a multiple of 16 slots, one per CTA of a cluster per (batch row, kv
// head): 16-slot ranges on short rings (a 96-slot ring runs 6 CTAs per
// head, 48 at batch 2 where one CTA per head ran 8), at most 8 CTAs up to
// 512 slots and 16 beyond. A CTA issues the 16-byte cp.async of every K
// and V row piece of its first 32-slot tile before it waits on any, and
// double-buffers later tiles. Rows stay in the storage dtype in shared
// memory, padded by 16 bytes so that the lanes' 16-byte reads of their
// own rows are free of bank conflicts. Each warp owns one query row: lane
// j scores slot j against q (f32, broadcast from shared memory), the
// tile's max and sum are warp shuffle reductions, probabilities are
// base-2 exponentials (ex2.approx) with hd^-0.5 * log2(e) folded into the
// score, and each lane accumulates hd / 32 output dims of P.V; (m, l,
// acc) stay in f32 registers. Every CTA stores its partial into the
// cluster leader's shared memory (cluster.map_shared_rank) ahead of one
// cluster barrier, and the leader combines the ranks in rank order -- one
// launch, and with no float atomics the same bits on every call. Takes
// any B, KVp, n_valid and buf, Gp <= 16 and hd a multiple of 32 up to 256.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kTile = 32;            // slots a tile, one a lane
constexpr int kMinWarps = 4;
constexpr int kMaxWarps = 16;        // one query row a warp: Gp <= 16
constexpr int kMaxDimsPerLane = 8;   // head dims a lane: hd <= 256
constexpr int kMaxSplit = 16;        // the H100's largest
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// bytes of one staged K or V row: the storage dtype's row, 16 of padding
template <typename TC>
__host__ __device__ constexpr int staged_row(int hd) {
  return hd * static_cast<int>(sizeof(TC)) + 16;
}

// the 16 / sizeof(TC) elements of a 16-byte vector of the cache, as f32
template <typename TC>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& r,
                                                float (&f)[kN]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& r,
                                                float (&f)[kN]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the first element in the low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Vec16<__nv_fp8_e4m3> {
  static constexpr int kN = 16;
  __device__ __forceinline__ static void unpack(const uint4& r,
                                                float (&f)[kN]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // e4m3 -> half is exact, as -> f32
        const __half2 v(__nv_cvt_fp8x2_to_halfraw2(
            static_cast<__nv_fp8x2_storage_t>(w[i] >> (16 * h)), __NV_E4M3));
        const float2 x = __half22float2(v);
        f[4 * i + 2 * h] = x.x;
        f[4 * i + 2 * h + 1] = x.y;
      }
    }
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (the min-blocks hint of 1 keeps ptxas from spilling the f32-cache
// instantiations, which it did at 64-80 registers without it)
template <typename TQ, typename TC>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    decode_split_kernel(const TQ* __restrict__ q, const TC* __restrict__ ck,
                        const TC* __restrict__ cv, TQ* __restrict__ out,
                        int buf, int kvp, int gp, int hd, int n_valid,
                        int chunk, int nbufs, float scale_log2) {
  using V = Vec16<TC>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = static_cast<int>(cluster.num_blocks());
  // matched by cluster_wait() before the push
  repro::cluster_arrive_relaxed();
  extern __shared__ __align__(16) unsigned char da_smem[];
  const int row = staged_row<TC>(hd);
  float* qs = reinterpret_cast<float*>(da_smem);  // (gp, hd)
  // (nbufs, K | V, kTile, row) in the storage dtype
  unsigned char* stage = da_smem + sizeof(float) * gp * hd;
  float* part_acc = reinterpret_cast<float*>(
      stage + static_cast<size_t>(nbufs) * 2 * kTile * row);  // (split, gp, hd)
  float* part_ml = part_acc + split * gp * hd;  // (split, gp, 2): m, l

  const int tid = threadIdx.x, lane = tid % 32, threads = blockDim.x;
  const int g = tid / 32;  // the warp's query row; none at g >= gp
  const int bh = blockIdx.y;  // batch row * kvp + kv head
  const int b = bh / kvp, h = bh % kvp;
  const int first = rank * chunk;  // the CTA's slots [first, last)
  const int last = min(n_valid, first + chunk);
  const int ntiles = last > first ? (last - first + kTile - 1) / kTile : 0;
  const int vecs = hd * static_cast<int>(sizeof(TC)) / 16;  // a row's
  const size_t slot_bytes = static_cast<size_t>(kvp) * hd * sizeof(TC);
  const size_t head_off = (static_cast<size_t>(b) * buf * kvp + h) * hd;
  const auto* kb = reinterpret_cast<const unsigned char*>(ck + head_off);
  const auto* vb = reinterpret_cast<const unsigned char*>(cv + head_off);

  // every 16-byte piece of tile t's K and V rows, in flight at once
  auto load_tile = [&](int t) {
    const int s0 = first + t * kTile;
    const int cnt = min(kTile, last - s0);
    unsigned char* kd =
        stage + static_cast<size_t>(t % nbufs) * 2 * kTile * row;
    unsigned char* vd = kd + kTile * row;
    for (int i = tid; i < cnt * vecs; i += threads) {
      const int j = i / vecs, c = i % vecs;
      const size_t src = static_cast<size_t>(s0 + j) * slot_bytes + c * 16;
      repro::cp_async16(repro::smem_u32(kd + j * row + c * 16), kb + src,
                        true);
      repro::cp_async16(repro::smem_u32(vd + j * row + c * 16), vb + src,
                        true);
    }
    repro::cp_async_commit();
  };

  if (ntiles > 0) load_tile(0);
  const size_t q_off = static_cast<size_t>(bh) * gp * hd;
  for (int i = tid; i < gp * hd; i += threads)
    qs[i] = repro::to_f32(q[q_off + i]);

  const int dpl = hd / 32;  // the lane's output dims: lane*dpl ..
  float m = kNegInf, l = 0.f, acc[kMaxDimsPerLane];
#pragma unroll
  for (int d = 0; d < kMaxDimsPerLane; ++d) acc[d] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile(t + 1);  // into the buffer the previous tile freed
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and q) visible to every warp
    const unsigned char* kd =
        stage + static_cast<size_t>(t % nbufs) * 2 * kTile * row;
    const unsigned char* vd = kd + kTile * row;
    const int cnt = min(kTile, last - first - t * kTile);
    if (g < gp) {  // warp-uniform
      float s = kNegInf;  // lane j scores slot j, in log2 units
      if (lane < cnt) {
        const float* qg = qs + g * hd;
        const unsigned char* kr = kd + lane * row;
        float dot = 0.f;
        for (int c = 0; c < vecs; ++c) {
          float kf[V::kN];
          V::unpack(*reinterpret_cast<const uint4*>(kr + c * 16), kf);
          const float4* q4 = reinterpret_cast<const float4*>(qg + c * V::kN);
#pragma unroll
          for (int e = 0; e < V::kN / 4; ++e) {
            const float4 qv = q4[e];
            dot = fmaf(qv.x, kf[4 * e], dot);
            dot = fmaf(qv.y, kf[4 * e + 1], dot);
            dot = fmaf(qv.z, kf[4 * e + 2], dot);
            dot = fmaf(qv.w, kf[4 * e + 3], dot);
          }
        }
        s = dot * scale_log2;
      }
      const float m_new = fmaxf(m, warp_max(s));
      const float p = lane < cnt ? repro::fast_exp2(s - m_new) : 0.f;
      const float corr = repro::fast_exp2(m - m_new);
      l = l * corr + warp_sum(p);
      m = m_new;
#pragma unroll
      for (int d = 0; d < kMaxDimsPerLane; ++d) acc[d] *= corr;
      for (int j = 0; j < cnt; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const TC* vr = reinterpret_cast<const TC*>(vd + j * row) + lane * dpl;
#pragma unroll
        for (int d = 0; d < kMaxDimsPerLane; ++d)
          if (d < dpl) acc[d] = fmaf(pj, repro::to_f32(vr[d]), acc[d]);
      }
    }
    __syncthreads();  // every warp is done with the buffer of tile t
  }

  // the CTA's partial (m, l, acc) goes to the cluster's leader (rank 0);
  // once every rank has stored, the leader combines them in rank order
  repro::cluster_wait();  // the start-up arrive: every CTA runs
  if (g < gp) {
    const int at = rank * gp + g;
    float* lead_acc = cluster.map_shared_rank(part_acc, 0) + at * hd;
    float* lead_ml = cluster.map_shared_rank(part_ml, 0) + 2 * at;
    if (lane == 0) {
      lead_ml[0] = m;
      lead_ml[1] = l;
    }
#pragma unroll
    for (int d = 0; d < kMaxDimsPerLane; ++d)
      if (d < dpl) lead_acc[lane * dpl + d] = acc[d];
  }
  cluster.sync();
  if (rank != 0 || g >= gp) return;
  float mx = kNegInf;
  for (int k = 0; k < split; ++k) mx = fmaxf(mx, part_ml[2 * (k * gp + g)]);
  float lsum = 0.f, o[kMaxDimsPerLane];
#pragma unroll
  for (int d = 0; d < kMaxDimsPerLane; ++d) o[d] = 0.f;
  for (int k = 0; k < split; ++k) {
    const int at = k * gp + g;
    const float w = repro::fast_exp2(part_ml[2 * at] - mx);
    lsum = fmaf(part_ml[2 * at + 1], w, lsum);
#pragma unroll
    for (int d = 0; d < kMaxDimsPerLane; ++d)
      if (d < dpl) o[d] = fmaf(part_acc[at * hd + lane * dpl + d], w, o[d]);
  }
  const float denom = fmaxf(lsum, 1e-30f);
  TQ* dst = out + q_off + static_cast<size_t>(g) * hd + lane * dpl;
#pragma unroll
  for (int d = 0; d < kMaxDimsPerLane; ++d)
    if (d < dpl) dst[d] = repro::from_f32<TQ>(o[d] / denom);
}

// The cluster: CTAs per (batch row, kv head), each taking a contiguous
// range of `chunk` live slots (a multiple of 16) that it walks in 32-slot
// tiles, double-buffered when more than one; and the launch's dynamic
// shared memory. Short rings get 16-slot ranges (a 96-slot ring: 6 CTAs),
// so more of the latency chain runs side by side; clusters grow past the
// portable 8 only for rings longer than 512 slots, where the work per CTA
// outweighs the larger cluster's start-up and combine.
struct Plan {
  int split, chunk, nbufs;
  size_t smem;
};

Plan plan_for(int n_valid, int gp, int hd, int esize) {
  const int max_split = n_valid > 512 ? kMaxSplit : repro::kPortableCluster;
  Plan p;
  p.chunk = (n_valid + max_split - 1) / max_split;
  p.chunk = max(16, (p.chunk + 15) / 16 * 16);
  p.split = (n_valid + p.chunk - 1) / p.chunk;  // none empty
  p.nbufs = p.chunk > kTile ? 2 : 1;
  p.smem = sizeof(float) * gp * hd +
           static_cast<size_t>(p.nbufs) * 2 * kTile * (hd * esize + 16) +
           sizeof(float) * p.split * gp * (hd + 2);
  return p;
}

bool takes(int gp, int hd, int n_valid, int buf) {
  return gp >= 1 && gp <= kMaxWarps && hd >= 32 &&
         hd % 32 == 0 && hd <= 32 * kMaxDimsPerLane && n_valid >= 1 &&
         n_valid <= buf;
}

template <typename TQ, typename TC>
cudaError_t launch(const void* q, const void* ck, const void* cv, void* out,
                   int batch, int buf, int kvp, int gp, int hd, int n_valid,
                   float scale, cudaStream_t stream) {
  if (!takes(gp, hd, n_valid, buf)) return cudaErrorInvalidValue;
  const Plan p = plan_for(n_valid, gp, hd, sizeof(TC));
  return repro::launch_cluster(
      decode_split_kernel<TQ, TC>, dim3(p.split, batch * kvp),
      dim3(32 * max(kMinWarps, gp)),  // a warp per query row
      p.smem, stream, static_cast<const TQ*>(q), static_cast<const TC*>(ck),
      static_cast<const TC*>(cv), static_cast<TQ*>(out), buf, kvp, gp, hd,
      n_valid, p.chunk, p.nbufs, scale * kLog2e);
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

int esize_of(int cache_dtype) {
  switch (cache_dtype) {
    case repro::kF32:
      return 4;
    case repro::kBF16:
      return 2;
    case repro::kF8E4M3:
      return 1;
  }
  return 0;
}

}  // namespace

// q/out (B, KVp, Gp, hd) float32/bfloat16; ck/cv (B, buf, KVp, hd) in
// cache_dtype, 16-byte aligned; n_valid the live slots (1..buf); Gp <= 16,
// hd a multiple of 32 up to 256. Returns cudaError_t.
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

// CTAs per (batch row, kv head) of a launch over n_valid live slots.
extern "C" int decode_attention_split(int n_valid) {
  if (n_valid < 1) return -1;
  return plan_for(n_valid, 1, 32, 1).split;
}

// Dynamic shared memory, in bytes, of one launch; -1 for a shape the
// kernel does not take.
extern "C" int decode_attention_smem(int n_valid, int gp, int hd,
                                     int cache_dtype) {
  const int esize = esize_of(cache_dtype);
  if (esize == 0 || !takes(gp, hd, n_valid, n_valid)) return -1;
  return static_cast<int>(plan_for(n_valid, gp, hd, esize).smem);
}
