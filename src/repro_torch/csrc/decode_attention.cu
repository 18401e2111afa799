// Single-query (decode) attention over a ring-buffer KV cache.
//
// Replaces: src/repro/kernels/decode_attention.py decode_attention_pallas
// (_decode_kernel).
//
// Computes, for one new token per batch row, out (B, KVp, Gp, hd) =
// softmax(q . K^T * hd^-0.5) V over the live slots of the cache (B, buf,
// KVp, hd): every slot once the ring has wrapped (pos + 1 >= buf), slots
// 0 .. pos % buf before that. The position is a device operand, as the
// Pallas kernel's scalar-prefetch `pos`: the launch passes a pointer to a
// 0-d int32 / int64 tensor (or null and the host value), and every CTA
// reads it and works out the count of live slots itself, so slots never
// written are never read and one launch -- one node of a CUDA graph --
// serves every position. The
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
//
// With the position on the device the grid cannot follow n_valid: the
// cluster, the staging buffers and the partials' shared memory are sized
// for the ring (the most any n_valid <= buf asks for), and each CTA takes
// the range that a launch sized for today's n_valid would give its rank
// (`ranges_for`). Ranks at or past that split do no work, and the leader
// combines only the ranks below it, in rank order -- so every n_valid
// gives the bits of a launch sized for it alone (an empty partial added
// to the sum would already change the sign of a zero). The idle CTAs are
// the cost: on a ring of more than 512 slots a 16-CTA cluster runs with
// at most 8 busy ranks while n_valid <= 512.
//
// A ring shard (the model-parallel rank program's sequence-sharded ring,
// src/repro_torch/models/attention.py): the cache a launch is given may
// be the slots [slot0, slot0 + buf) of a ring of `ring` slots held across
// the model axis's ranks. Its live slots are the global live slots that
// fall in it -- a prefix of the shard, since the live slots are a prefix
// of the ring -- so the only change is that count: n_valid = clamp(live
// - slot0, 0, buf). Given an `lse` buffer, the leader also writes each
// query row's log-sum-exp of the scores it combined, natural log, f32
// (B, KVp, Gp): max + log(sum) of its base-2 statistics, times ln 2. The
// ranks then merge their partial outputs by these weights. A shard with
// no live slot writes zeros and -inf. With slot0 = 0, ring = buf and no
// lse buffer the launch computes what it computed before, bit for bit.
//
// A head block of a ring (the rank program's ring held whole by every
// rank, each attending only its KV heads): the cache may hold kv_heads
// >= KVp heads a slot, ck/cv pointing at the first of the block's KVp;
// only the slot stride reads kv_heads. With kv_heads = KVp the launch is
// the one above, bit for bit.
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
constexpr float kLn2 = 0.6931471805599453f;

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

// The CTAs' slot ranges of a launch over n_valid live slots: `split`
// contiguous ranges of `chunk` slots (a multiple of 16), none empty.
// Short rings get 16-slot ranges (a 96-slot ring: 6 CTAs), so more of the
// latency chain runs side by side; past the portable 8 the split grows
// only for more than 512 live slots, where the work per CTA outweighs the
// larger cluster's start-up and combine. n_valid = 0 gives no range.
struct Ranges {
  int split, chunk;
};

__host__ __device__ inline Ranges ranges_for(int n_valid) {
  const int max_split =
      n_valid > 512 ? kMaxSplit : repro::kPortableCluster;
  int chunk = (n_valid + max_split - 1) / max_split;
  chunk = max(16, (chunk + 15) / 16 * 16);
  return {(n_valid + chunk - 1) / chunk, chunk};
}

// live ring slots at absolute position pos: all once wrapped, else
// 0 .. pos % buf (none for a negative position)
__host__ __device__ inline int live_slots(long long pos, int buf) {
  if (pos < 0) return 0;
  return pos + 1 >= buf ? buf : static_cast<int>(pos % buf) + 1;
}

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
                        int buf, int kvp, int kv_heads, int gp, int hd,
                        const void* __restrict__ pos_dev, int pos_is64,
                        long long pos_host, int stage_bufs,
                        float scale_log2, int slot0, int ring,
                        float* __restrict__ lse) {
  using V = Vec16<TC>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int grid_split = static_cast<int>(cluster.num_blocks());
  // matched by cluster_wait() before the push
  repro::cluster_arrive_relaxed();
  // the position: read on the device unless the launch gave it
  const long long pos =
      pos_dev == nullptr
          ? pos_host
          : (pos_is64 ? *static_cast<const long long*>(pos_dev)
                      : static_cast<long long>(
                            *static_cast<const int*>(pos_dev)));
  // the shard's live slots: the ring's that lie at or past slot0
  const int n_valid = min(buf, max(0, live_slots(pos, ring) - slot0));
  // this position's ranges; ranks >= split idle, and the leader combines
  // ranks < split alone
  const Ranges rg = ranges_for(n_valid);
  const int split = rg.split, chunk = rg.chunk;
  const int nbufs = chunk > kTile ? 2 : 1;  // <= stage_bufs
  extern __shared__ __align__(16) unsigned char da_smem[];
  const int row = staged_row<TC>(hd);
  float* qs = reinterpret_cast<float*>(da_smem);  // (gp, hd)
  // (stage_bufs, K | V, kTile, row) in the storage dtype
  unsigned char* stage = da_smem + sizeof(float) * gp * hd;
  // (grid_split, gp, hd)
  float* part_acc = reinterpret_cast<float*>(
      stage + static_cast<size_t>(stage_bufs) * 2 * kTile * row);
  float* part_ml = part_acc + grid_split * gp * hd;  // (.., gp, 2): m, l

  const int tid = threadIdx.x, lane = tid % 32, threads = blockDim.x;
  const int g = tid / 32;  // the warp's query row; none at g >= gp
  const int bh = blockIdx.y;  // batch row * kvp + kv head
  const int b = bh / kvp, h = bh % kvp;
  const int first = rank * chunk;  // the CTA's slots [first, last)
  const int last = min(n_valid, first + chunk);
  const int ntiles = last > first ? (last - first + kTile - 1) / kTile : 0;
  const int vecs = hd * static_cast<int>(sizeof(TC)) / 16;  // a row's
  const size_t slot_bytes = static_cast<size_t>(kv_heads) * hd * sizeof(TC);
  const size_t head_off =
      (static_cast<size_t>(b) * buf * kv_heads + h) * hd;
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

  const size_t q_off = static_cast<size_t>(bh) * gp * hd;
  if (ntiles > 0) {  // an idle rank reads nothing
    load_tile(0);
    for (int i = tid; i < gp * hd; i += threads)
      qs[i] = repro::to_f32(q[q_off + i]);
  }

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
  if (rank < split && g < gp) {
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
  if (lse != nullptr && lane == 0)  // natural log; none live: -inf
    lse[static_cast<size_t>(bh) * gp + g] =
        split > 0 ? (mx + log2f(lsum)) * kLn2
                  : __int_as_float(0xff800000);
  const float denom = fmaxf(lsum, 1e-30f);
  TQ* dst = out + q_off + static_cast<size_t>(g) * hd + lane * dpl;
#pragma unroll
  for (int d = 0; d < kMaxDimsPerLane; ++d)
    if (d < dpl) dst[d] = repro::from_f32<TQ>(o[d] / denom);
}

// The launch over a ring of `buf` slots, whatever the position: the
// cluster is the largest split any n_valid <= buf asks for, the staging
// buffers the most any of their chunks double-buffers, and the dynamic
// shared memory holds both and the cluster's partials.
struct Plan {
  int split, nbufs;
  size_t smem;
};

Plan plan_for_ring(int buf, int gp, int hd, int esize) {
  // up to 512 live slots: ceil(n / 16) ranges of 16 until 8 of them
  // (n = 113), then 8 or fewer; the chunk grows with n
  const int small = min(buf, 512);
  int split = min(repro::kPortableCluster, (small + 15) / 16);
  int chunk = ranges_for(small).chunk;
  if (buf > 512) {  // the 16-split regime: some n in 721..768 reaches 16
    chunk = max(chunk, ranges_for(buf).chunk);
    for (int n = 513; n <= buf && split < kMaxSplit; ++n)
      split = max(split, ranges_for(n).split);
  }
  Plan p;
  p.split = split;
  p.nbufs = chunk > kTile ? 2 : 1;
  p.smem = sizeof(float) * gp * hd +
           static_cast<size_t>(p.nbufs) * 2 * kTile * (hd * esize + 16) +
           sizeof(float) * p.split * gp * (hd + 2);
  return p;
}

bool takes(int gp, int hd, int buf) {
  return gp >= 1 && gp <= kMaxWarps && hd >= 32 && hd % 32 == 0 &&
         hd <= 32 * kMaxDimsPerLane && buf >= 1;
}

template <typename TQ, typename TC>
cudaError_t launch(const void* q, const void* ck, const void* cv, void* out,
                   int batch, int buf, int kvp, int kv_heads, int gp,
                   int hd, const void* pos_dev, int pos_is64,
                   long long pos_host, float scale, int slot0, int ring,
                   float* lse, cudaStream_t stream) {
  if (!takes(gp, hd, buf) || slot0 < 0 || ring < 1 || kv_heads < kvp)
    return cudaErrorInvalidValue;
  const Plan p = plan_for_ring(buf, gp, hd, sizeof(TC));
  return repro::launch_cluster(
      decode_split_kernel<TQ, TC>, dim3(p.split, batch * kvp),
      dim3(32 * max(kMinWarps, gp)),  // a warp per query row
      p.smem, stream, static_cast<const TQ*>(q), static_cast<const TC*>(ck),
      static_cast<const TC*>(cv), static_cast<TQ*>(out), buf, kvp, kv_heads,
      gp, hd, pos_dev, pos_is64, pos_host, p.nbufs, scale * kLog2e, slot0,
      ring, lse);
}

template <typename TQ>
cudaError_t launch_cache(int cache_dtype, const void* q, const void* ck,
                         const void* cv, void* out, int batch, int buf,
                         int kvp, int kv_heads, int gp, int hd,
                         const void* pos_dev,
                         int pos_is64, long long pos_host, float scale,
                         int slot0, int ring, float* lse,
                         cudaStream_t stream) {
  switch (cache_dtype) {
    case repro::kF32:
      return launch<TQ, float>(q, ck, cv, out, batch, buf, kvp, kv_heads,
                               gp, hd, pos_dev, pos_is64, pos_host, scale,
                               slot0, ring, lse, stream);
    case repro::kBF16:
      return launch<TQ, __nv_bfloat16>(q, ck, cv, out, batch, buf, kvp,
                                       kv_heads, gp, hd, pos_dev, pos_is64,
                                       pos_host, scale, slot0, ring, lse,
                                       stream);
    case repro::kF8E4M3:
      return launch<TQ, __nv_fp8_e4m3>(q, ck, cv, out, batch, buf, kvp,
                                       kv_heads, gp, hd, pos_dev, pos_is64,
                                       pos_host, scale, slot0, ring, lse,
                                       stream);
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

// q/out (B, KVp, Gp, hd) float32/bfloat16; ck/cv (B, buf, kv_heads, hd)
// in cache_dtype, pointing at the first of the KVp heads read (kv_heads
// >= KVp), 16-byte aligned; Gp <= 16, hd a multiple of 32 up to 256.
// The absolute position: pos_dev a device pointer to one int32 (pos_is64
// = 0) or int64 (1), read by the kernel; or pos_dev null and the value
// in pos_host. Returns cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* ck,
                                       const void* cv, void* out, int batch,
                                       int buf, int kvp, int kv_heads,
                                       int gp, int hd, const void* pos_dev,
                                       int pos_is64, long long pos_host,
                                       float scale, int q_dtype,
                                       int cache_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (q_dtype == repro::kF32)
    return launch_cache<float>(cache_dtype, q, ck, cv, out, batch, buf, kvp,
                               kv_heads, gp, hd, pos_dev, pos_is64, pos_host,
                               scale, 0, buf, nullptr, s);
  if (q_dtype == repro::kBF16)
    return launch_cache<__nv_bfloat16>(cache_dtype, q, ck, cv, out, batch,
                                       buf, kvp, kv_heads, gp, hd, pos_dev,
                                       pos_is64, pos_host, scale, 0, buf,
                                       nullptr, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The ring-shard launch: q/out (B, KVp, Gp, hd) float32; ck/cv (B, buf,
// KVp, hd) the global slots [slot0, slot0 + buf) of a ring of `ring`
// slots, in cache_dtype; lse (B, KVp, Gp) float32, written with each
// row's natural log-sum-exp (-inf where the shard holds no live slot).
// The position as for decode_attention_launch. Returns cudaError_t.
extern "C" int decode_attention_shard_launch(
    const void* q, const void* ck, const void* cv, void* out, void* lse,
    int batch, int buf, int kvp, int gp, int hd, int slot0, int ring,
    const void* pos_dev, int pos_is64, long long pos_host, float scale,
    int cache_dtype, void* stream) {
  if (lse == nullptr || slot0 + buf > ring)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_cache<float>(cache_dtype, q, ck, cv, out, batch, buf, kvp,
                             kvp, gp, hd, pos_dev, pos_is64, pos_host, scale,
                             slot0, ring, static_cast<float*>(lse),
                             static_cast<cudaStream_t>(stream));
}

// CTAs per (batch row, kv head) that work at n_valid live slots.
extern "C" int decode_attention_split(int n_valid) {
  if (n_valid < 1) return -1;
  return ranges_for(n_valid).split;
}

// CTAs per (batch row, kv head) of a launch over a ring of buf slots: the
// cluster, whatever the position.
extern "C" int decode_attention_grid(int buf) {
  if (buf < 1) return -1;
  return plan_for_ring(buf, 1, 32, 1).split;
}

// Dynamic shared memory, in bytes, of a launch over a ring of buf slots;
// -1 for a shape the kernel does not take.
extern "C" int decode_attention_smem(int buf, int gp, int hd,
                                     int cache_dtype) {
  const int esize = esize_of(cache_dtype);
  if (esize == 0 || !takes(gp, hd, buf)) return -1;
  return static_cast<int>(plan_for_ring(buf, gp, hd, esize).smem);
}
