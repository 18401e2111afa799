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
// The shard launch (decode_attention_shard_launch, f32 query) takes one
// of two routes by the cache's dtype:
//
// - float32 caches: the kernel above (f32-query instantiation). One bf16
//   product cannot form an f32 K's scores exactly, and no path on the
//   card shards an f32 ring, so the CUDA-core route stays.
// - bfloat16 and float8_e4m3fn caches: decode_shard_tc_kernel, on the
//   tensor cores. The kernel above, at a pod shard (chatglm3-6b's: Gp 16,
//   hd 128, 2048 slots), asks for 176 KB of shared memory a CTA for its
//   leader's split x Gp x hd partials, so a 16-CTA cluster takes 16 SMs
//   one CTA each, and 16 warps score the same K tile row by row in f32
//   and walk the same V tile again, each reading every byte of it. Here
//   the query group is the A operand of mma.sync m16n8k16 (Gp <= 16 rows,
//   padded to 16): a CTA of 4 warps per (batch row, kv head, slot range),
//   each warp taking its own 16-slot sub-tiles and keeping its own (m, l,
//   O) in f32 registers (O 16 x hd over its C fragments). Precision holds
//   at the f32 route's tolerance by hi/lo products: the query, scaled
//   into log2 units, is split once into q_hi = bf16(q) and q_lo = bf16(q
//   - q_hi), S = q_hi K^T + q_lo K^T (K exact in bf16; e4m3 converts to
//   bf16 exactly); P, in f32 after the online softmax, is split the same
//   way, O += P_hi V + P_lo V. A single bf16 P would carry its 2^-9
//   rounding from a dominant slot straight into the output. Each warp
//   streams its sub-tiles by 16-byte cp.async through one stage of its
//   own, K and V rows apart, so that K of the next sub-tile loads behind
//   P.V and V behind the next scores; float8 rows are converted to bf16
//   in the warp's copy on the way to ldmatrix. A CTA combines its warps'
//   partials in warp order and keeps only the sum, 16 x hd f32 and (m,
//   l); each rank pushes column block k of it to rank k through
//   cluster.map_shared_rank (a warp's lanes write one rank's block
//   contiguously), and after the cluster barrier rank k combines its
//   columns of every rank in rank order; rank 0 writes the lse. No CTA
//   holds split x Gp x hd floats: 53 KB a CTA at chatglm3-6b's shard, 29
//   KB at smollm-135m's, so several CTAs share an SM and every cluster
//   of a pod shard's launch is resident at once (two stages a warp, 89
//   KB at chatglm3-6b's, left clusters to a second wave and ran slower),
//   and with no float atomics the bits repeat on every call. The
//   cluster (<= 16 CTAs of >= 64 slots) and each rank's range come from
//   the shard's slots alone, never the position: ranks past the live
//   slots idle, so a CUDA graph replays one launch at every step. hd is
//   padded to the instantiation's 32, 64, 128 or 256.
//
// A head block of a ring (the rank program's ring held whole by every
// rank, each attending only its KV heads): the cache may hold kv_heads
// >= KVp heads a slot, ck/cv pointing at the first of the block's KVp;
// only the slot stride reads kv_heads. With kv_heads = KVp the launch is
// the one above, bit for bit.
#include <cooperative_groups.h>
#include <math.h>

#include <type_traits>

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

// ---------------------------------------------------------------------------
// Ring shards of bf16 and float8 caches: the tensor-core kernel

using bf16 = __nv_bfloat16;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::fast_exp2;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;
using repro::pack_bf16;
using repro::smem_u32;

constexpr int kShWarps = 4;
constexpr int kShThreads = 32 * kShWarps;
constexpr int kShRows = 16;    // the query group padded to the MMA's M
constexpr int kShSub = 16;     // slots of a warp's sub-tile: P.V's k16
constexpr int kShMinChunk = kShWarps * kShSub;  // a sub-tile a warp

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// Shared memory of one CTA at head dim HD (the instantiation's; a
// shard's hd <= HD, the dims past it zero): the work area (each warp's
// K and V rows of one sub-tile, and for float8 a bf16 copy of either;
// after the walk, each warp's rescaled O), the split query, each warp's
// (m, l), then what the cluster's ranks push: their O columns of this
// rank and their (m, l).
template <int HD, typename TC>
struct ShardSmem {
  static constexpr bool kConvert = sizeof(TC) == 1;
  static constexpr int kRow = HD * sizeof(TC) + 16;  // a staged row, bytes
  static constexpr int kBfRow = HD * 2 + 16;         // a bf16 row, bytes
  // a warp's K rows, V rows, and for float8 the bf16 copy of one of them
  static constexpr int kWarp =
      2 * kShSub * kRow + (kConvert ? kShSub * kBfRow : 0);
  static constexpr int kOStride = HD + 8;            // f32 a row of O
  static constexpr size_t kWork =
      cmax(static_cast<size_t>(kShWarps) * kWarp,
           sizeof(float) * kShWarps * kShRows * kOStride);
  static constexpr size_t kQ = 2 * kShRows * kBfRow;  // hi rows, lo rows
  static constexpr size_t kWml = sizeof(float) * 2 * kShWarps * kShRows;
  static size_t bytes(int split, int cpr) {
    return kWork + kQ + kWml +
           sizeof(float) * split * kShRows * (static_cast<size_t>(cpr) + 2);
  }
};

// f32 a, b -> bf16 pairs hi = bf16(a, b) and lo = bf16(a - hi, b - hi)
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// two e4m3 values (the first in the low byte) -> a bf16 pair, exactly
__device__ __forceinline__ uint32_t fp8x2_to_bf16x2(uint32_t two) {
  const __half2 h(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two & 0xffffu), __NV_E4M3));
  const float2 f = __half22float2(h);
  return pack_bf16(f.x, f.y);
}

// 16 cache rows from `src` (slot s0 on, `slot_bytes` apart) into a
// warp's stage by 16-byte cp.async: rows past `cnt` and bytes past
// `row_bytes` are zero-filled, not read
template <int HD, typename TC>
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          const unsigned char* src, int s0,
                                          int cnt, size_t slot_bytes,
                                          int row_bytes, int lane) {
  using L = ShardSmem<HD, TC>;
  constexpr int kCh = HD * static_cast<int>(sizeof(TC)) / 16;
  static_assert(kShSub * kCh % 32 == 0, "whole pieces a lane");
#pragma unroll 1  // unrolled, its addresses stay live across the MMAs
  for (int it = 0; it < kShSub * kCh / 32; ++it) {
    const int i = lane + 32 * it, r = i / kCh, c = i % kCh;
    const bool ok = r < cnt && c * 16 < row_bytes;
    const size_t at = ok ? static_cast<size_t>(s0 + r) * slot_bytes + c * 16
                         : 0;
    cp_async16(smem_u32(dst + r * L::kRow + c * 16), src + at, ok);
  }
}

// 16 staged float8 rows -> bf16 (exact) into the warp's copy
template <int HD>
__device__ __forceinline__ void widen_rows(bf16* cvt,
                                           const unsigned char* src,
                                           int lane) {
  using L = ShardSmem<HD, __nv_fp8_e4m3>;
  constexpr int kCh = HD / 16;
  static_assert(kShSub * kCh % 32 == 0, "whole pieces a lane");
#pragma unroll
  for (int it = 0; it < kShSub * kCh / 32; ++it) {
    const int i = lane + 32 * it, r = i / kCh, c = i % kCh;
    const uint4 v =
        *reinterpret_cast<const uint4*>(src + r * L::kRow + c * 16);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t o2[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o2[2 * e] = fp8x2_to_bf16x2(w[e]);
      o2[2 * e + 1] = fp8x2_to_bf16x2(w[e] >> 16);
    }
    uint4* dst = reinterpret_cast<uint4*>(
        reinterpret_cast<unsigned char*>(cvt) + r * L::kBfRow + c * 32);
    dst[0] = make_uint4(o2[0], o2[1], o2[2], o2[3]);
    dst[1] = make_uint4(o2[4], o2[5], o2[6], o2[7]);
  }
}

// A warp's walk over its sub-tiles w, w + 4, ... of the CTA's slots
// [first, last): `mine` of them.
template <int HD, typename TC>
struct ShardWalk {
  const unsigned char *kb, *vb;  // the (batch row, kv head)'s slot 0
  size_t slot_bytes;
  int row_bytes, first, last, warp, mine, lane;

  // K or V rows of sub-tile j from `src` into `dst`; one commit group a
  // call, empty past the warp's last sub-tile
  __device__ __forceinline__ void fetch(int j, const unsigned char* src,
                                        unsigned char* dst) const {
    if (j < mine) {
      const int s0 = first + (warp + kShWarps * j) * kShSub;
      load_rows<HD, TC>(dst, src, s0, min(kShSub, last - s0), slot_bytes,
                        row_bytes, lane);
    }
    cp_async_commit();
  }
};

template <int HD, typename TC>
__global__ void __launch_bounds__(kShThreads)
    decode_shard_tc_kernel(const float* __restrict__ q,
                           const TC* __restrict__ ck,
                           const TC* __restrict__ cv, float* __restrict__ out,
                           float* __restrict__ lse, int buf, int kvp, int gp,
                           int hd, const void* __restrict__ pos_dev,
                           int pos_is64, long long pos_host,
                           float scale_log2, int slot0, int ring, int chunk) {
  using L = ShardSmem<HD, TC>;
  constexpr int kNT = HD / 8;  // n8 tiles of O
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = static_cast<int>(cluster.num_blocks());
  repro::cluster_arrive_relaxed();  // matched before the push
  const long long pos =
      pos_dev == nullptr
          ? pos_host
          : (pos_is64 ? *static_cast<const long long*>(pos_dev)
                      : static_cast<long long>(
                            *static_cast<const int*>(pos_dev)));
  const int n_valid = min(buf, max(0, live_slots(pos, ring) - slot0));
  const int nwork = (n_valid + chunk - 1) / chunk;  // ranks with slots
  const int cpr = (hd + split - 1) / split;  // O columns a rank combines

  extern __shared__ __align__(16) unsigned char sh_smem[];
  unsigned char* work = sh_smem;
  bf16* q_hi = reinterpret_cast<bf16*>(sh_smem + L::kWork);
  bf16* q_lo = q_hi + kShRows * (L::kBfRow / 2);
  float* w_m = reinterpret_cast<float*>(sh_smem + L::kWork + L::kQ);
  float* w_l = w_m + kShWarps * kShRows;
  float* recv = w_l + kShWarps * kShRows;      // (split, 16, cpr)
  float* recv_ml = recv + split * kShRows * cpr;  // (split, 16, 2)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / kvp, h = bh % kvp;
  const int first = rank * chunk, last = min(n_valid, first + chunk);
  const int r_lo = lane / 4, r_hi = r_lo + 8;  // the lane's rows of O
  const int c0 = (lane % 4) * 2;               // and its first column

  if (rank < nwork) {
    const size_t head_off = (static_cast<size_t>(b) * buf * kvp + h) * hd;
    const int nsub = (last - first + kShSub - 1) / kShSub;
    const ShardWalk<HD, TC> walk{
        reinterpret_cast<const unsigned char*>(ck + head_off),
        reinterpret_cast<const unsigned char*>(cv + head_off),
        static_cast<size_t>(kvp) * hd * sizeof(TC),
        hd * static_cast<int>(sizeof(TC)), first, last, warp,
        nsub > warp ? (nsub - warp + kShWarps - 1) / kShWarps : 0, lane};
    unsigned char* kd = work + warp * L::kWarp;  // the warp's K rows,
    unsigned char* vd = kd + kShSub * L::kRow;    // its V rows
    bf16* cvt = reinterpret_cast<bf16*>(vd + kShSub * L::kRow);  // float8
    walk.fetch(0, walk.kb, kd);
    walk.fetch(0, walk.vb, vd);

    // the query in log2 units, split once: q = hi + lo in bf16
    for (int i = tid; i < kShRows * HD; i += kShThreads) {
      const int r = i / HD, d = i % HD;
      const float x =
          r < gp && d < hd
              ? q[(static_cast<size_t>(bh) * gp + r) * hd + d] * scale_log2
              : 0.f;
      const bf16 hi = __float2bfloat16_rn(x);
      q_hi[r * (L::kBfRow / 2) + d] = hi;
      q_lo[r * (L::kBfRow / 2) + d] =
          __float2bfloat16_rn(x - __bfloat162float(hi));
    }
    __syncthreads();

    float o[kNT][4];
#pragma unroll
    for (int t = 0; t < kNT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
    constexpr int kStride = L::kBfRow / 2;  // bf16 a row, every layout

    // One stage a warp, its K and V halves apart: K of sub-tile j + 1
    // loads behind P.V of j, V of j + 1 behind the scores of j + 1.
    for (int j = 0; j < walk.mine; ++j) {
      cp_async_wait<1>();  // K of sub-tile j (its V may be in flight)
      __syncwarp();        // every lane's pieces, and P.V of j - 1 read
      const int cnt =
          min(kShSub, last - first - (warp + kShWarps * j) * kShSub);
      const bf16* kt = reinterpret_cast<const bf16*>(kd);
      if constexpr (L::kConvert) {
        widen_rows<HD>(cvt, kd, lane);
        __syncwarp();
        walk.fetch(j + 1, walk.kb, kd);
        kt = cvt;
      }

      // S = (q_hi + q_lo) K^T: 16 rows x 16 slots, in log2 units
      float sc[2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[0][e] = sc[1][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
        const int qr = (lane % 8) + ((lane / 8) % 2) * 8;
        const int qc = kc * 16 + (lane / 16) * 8;
        uint32_t qh[4], ql[4], kf[4];
        ldmatrix_x4(qh, smem_u32(q_hi + qr * kStride + qc));
        ldmatrix_x4(ql, smem_u32(q_lo + qr * kStride + qc));
        const int key = (lane % 8) + (lane / 16) * 8;
        const int d = kc * 16 + ((lane / 8) % 2) * 8;
        ldmatrix_x4(kf, smem_u32(kt + key * kStride + d));
        mma_bf16(sc[0], qh, kf[0], kf[1]);
        mma_bf16(sc[1], qh, kf[2], kf[3]);
        mma_bf16(sc[0], ql, kf[0], kf[1]);
        mma_bf16(sc[1], ql, kf[2], kf[3]);
      }
      if constexpr (!L::kConvert) {
        __syncwarp();  // every lane is done with K of sub-tile j
        walk.fetch(j + 1, walk.kb, kd);
      }
      if (cnt < kShSub) {  // slots past the live ones score -inf
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n * 8 + c0 + e >= cnt) sc[n][e] = sc[n][2 + e] = -INFINITY;
      }
      float mx_lo = fmaxf(m_lo, fmaxf(fmaxf(sc[0][0], sc[0][1]),
                                      fmaxf(sc[1][0], sc[1][1])));
      float mx_hi = fmaxf(m_hi, fmaxf(fmaxf(sc[0][2], sc[0][3]),
                                      fmaxf(sc[1][2], sc[1][3])));
      // a row's scores sit in the 4 lanes of a quad; slot 0 of the
      // sub-tile is live, so the max is finite
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      const float corr_lo = fast_exp2(m_lo - mx_lo);
      const float corr_hi = fast_exp2(m_hi - mx_hi);
      m_lo = mx_lo;
      m_hi = mx_hi;
      // P in f32, split hi / lo into the A fragments of P.V: the score
      // fragments of n-tiles 0, 1 are the A fragment of the sub-tile
      uint32_t ph[4], pl[4];
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float p0 = fast_exp2(sc[n][0] - mx_lo);
        const float p1 = fast_exp2(sc[n][1] - mx_lo);
        const float p2 = fast_exp2(sc[n][2] - mx_hi);
        const float p3 = fast_exp2(sc[n][3] - mx_hi);
        sum_lo += p0 + p1;
        sum_hi += p2 + p3;
        split_pair(p0, p1, ph[2 * n], pl[2 * n]);
        split_pair(p2, p3, ph[2 * n + 1], pl[2 * n + 1]);
      }
      l_lo = l_lo * corr_lo + sum_lo;  // the lane's share; quad-summed last
      l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        o[t][0] *= corr_lo;
        o[t][1] *= corr_lo;
        o[t][2] *= corr_hi;
        o[t][3] *= corr_hi;
      }
      cp_async_wait<1>();  // V of sub-tile j (K of j + 1 may be in flight)
      __syncwarp();
      const bf16* vt = reinterpret_cast<const bf16*>(vd);
      if constexpr (L::kConvert) {
        widen_rows<HD>(cvt, vd, lane);
        __syncwarp();
        walk.fetch(j + 1, walk.vb, vd);
        vt = cvt;
      }
      // O += (P_hi + P_lo) V
#pragma unroll
      for (int t = 0; t < kNT; t += 2) {
        const int key = (lane % 8) + ((lane / 8) % 2) * 8;
        const int d = t * 8 + (lane / 16) * 8;
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_u32(vt + key * kStride + d));
        mma_bf16(o[t], ph, vf[0], vf[1]);
        mma_bf16(o[t + 1], ph, vf[2], vf[3]);
        mma_bf16(o[t], pl, vf[0], vf[1]);
        mma_bf16(o[t + 1], pl, vf[2], vf[3]);
      }
      if constexpr (!L::kConvert) {
        __syncwarp();  // every lane is done with V of sub-tile j
        walk.fetch(j + 1, walk.vb, vd);
      }
    }
    cp_async_wait<0>();  // nothing in flight into the work area
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);

    // the CTA's partial: the warps' (m, l, O) rescaled to the CTA's max
    // (warp 0 holds the CTA's first slot, so it is finite) and summed in
    // warp order
    if (lane % 4 == 0) {
      w_m[warp * kShRows + r_lo] = m_lo;
      w_m[warp * kShRows + r_hi] = m_hi;
    }
    __syncthreads();  // every warp's walk is over: the stages are free
    float top_lo = w_m[r_lo], top_hi = w_m[r_hi];
#pragma unroll
    for (int w = 1; w < kShWarps; ++w) {
      top_lo = fmaxf(top_lo, w_m[w * kShRows + r_lo]);
      top_hi = fmaxf(top_hi, w_m[w * kShRows + r_hi]);
    }
    const float a_lo = fast_exp2(m_lo - top_lo);  // 0 for an idle warp
    const float a_hi = fast_exp2(m_hi - top_hi);
    float* wo = reinterpret_cast<float*>(work) + warp * kShRows * L::kOStride;
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      *reinterpret_cast<float2*>(wo + r_lo * L::kOStride + t * 8 + c0) =
          make_float2(o[t][0] * a_lo, o[t][1] * a_lo);
      *reinterpret_cast<float2*>(wo + r_hi * L::kOStride + t * 8 + c0) =
          make_float2(o[t][2] * a_hi, o[t][3] * a_hi);
    }
    if (lane % 4 == 0) {
      w_l[warp * kShRows + r_lo] = l_lo * a_lo;
      w_l[warp * kShRows + r_hi] = l_hi * a_hi;
    }
    __syncthreads();
  }

  // push the partial: columns [k cpr, (k + 1) cpr) of O to rank k, this
  // rank's (m, l) to every rank
  repro::cluster_wait();  // the start-up arrive: every CTA runs
  if (rank < nwork) {
    const float* wo = reinterpret_cast<const float*>(work);
    constexpr int kW = kShRows * L::kOStride;  // a warp's O
    // rank k's block, (16, cpr) of this rank's rows, in consecutive
    // lanes: 16-byte pieces where cpr allows
    const int vec = cpr % 4 == 0 ? 4 : 1;
    const int per_row = cpr / vec, per_dest = gp * per_row;
    const int dests = (hd + cpr - 1) / cpr;
    for (int i = tid; i < dests * per_dest; i += kShThreads) {
      const int dest = i / per_dest, k = i % per_dest;
      const int r = k / per_row, c = k % per_row * vec;
      if (dest * cpr + c >= hd) continue;  // past the last rank's columns
      const float* p = wo + r * L::kOStride + dest * cpr + c;
      float* to =
          cluster.map_shared_rank(recv, dest) + (rank * kShRows + r) * cpr + c;
      if (vec == 4) {
        float4 v = *reinterpret_cast<const float4*>(p);
#pragma unroll
        for (int w = 1; w < kShWarps; ++w) {
          const float4 x = *reinterpret_cast<const float4*>(p + w * kW);
          v = make_float4(v.x + x.x, v.y + x.y, v.z + x.z, v.w + x.w);
        }
        *reinterpret_cast<float4*>(to) = v;
      } else {
        float v = p[0];
#pragma unroll
        for (int w = 1; w < kShWarps; ++w) v += p[w * kW];
        *to = v;
      }
    }
    // (m, l) of each row to every rank, one store a thread
    for (int i = tid; i < split * gp; i += kShThreads) {
      const int dest = i / gp, r = i % gp;
      float top = w_m[r], l = 0.f;
#pragma unroll
      for (int w = 1; w < kShWarps; ++w)
        top = fmaxf(top, w_m[w * kShRows + r]);
#pragma unroll
      for (int w = 0; w < kShWarps; ++w) l += w_l[w * kShRows + r];
      float* to = cluster.map_shared_rank(recv_ml, dest);
      *reinterpret_cast<float2*>(to + 2 * (rank * kShRows + r)) =
          make_float2(top, l);
    }
  }
  cluster.sync();

  // this rank's columns of the output, the ranks combined in rank order;
  // rank 0 writes the log-sum-exp. No live slot: zeros and -inf.
  const int col0 = rank * cpr, ncol = max(0, min(hd, col0 + cpr) - col0);
  for (int i = tid; i < gp * ncol; i += kShThreads) {
    const int r = i / ncol, c = i % ncol;
    float top = -INFINITY;
    for (int k = 0; k < nwork; ++k)
      top = fmaxf(top, recv_ml[2 * (k * kShRows + r)]);
    float acc = 0.f, lsum = 0.f;
    for (int k = 0; k < nwork; ++k) {
      const float w = fast_exp2(recv_ml[2 * (k * kShRows + r)] - top);
      lsum = fmaf(recv_ml[2 * (k * kShRows + r) + 1], w, lsum);
      acc = fmaf(recv[(k * kShRows + r) * cpr + c], w, acc);
    }
    out[(static_cast<size_t>(bh) * gp + r) * hd + col0 + c] =
        nwork > 0 ? acc / lsum : 0.f;
  }
  if (rank == 0 && tid < gp) {
    float top = -INFINITY, lsum = 0.f;
    for (int k = 0; k < nwork; ++k)
      top = fmaxf(top, recv_ml[2 * (k * kShRows + tid)]);
    for (int k = 0; k < nwork; ++k)
      lsum = fmaf(recv_ml[2 * (k * kShRows + tid) + 1],
                  fast_exp2(recv_ml[2 * (k * kShRows + tid)] - top), lsum);
    lse[static_cast<size_t>(bh) * gp + tid] =
        nwork > 0 ? (top + log2f(lsum)) * kLn2 : -INFINITY;
  }
}

// The shard launch over `buf` slots: CTAs of `chunk` slots (a multiple of
// 16, at least one 16-slot sub-tile a warp where the shard has them),
// one cluster of `split` <= 16 per (batch row, kv head), sized by the
// shard and not by the position.
struct ShardPlan {
  int split, chunk, cpr;
};

ShardPlan shard_plan(int buf, int hd) {
  ShardPlan p;
  p.split = min(kMaxSplit, max(1, (buf + kShMinChunk - 1) / kShMinChunk));
  p.chunk = ((buf + p.split - 1) / p.split + kShSub - 1) / kShSub * kShSub;
  p.split = (buf + p.chunk - 1) / p.chunk;
  p.cpr = (hd + p.split - 1) / p.split;
  return p;
}

// f(std::integral_constant<int, HD>()) at the instantiation's head dim
// HD: the least of 32, 64, 128, 256 >= hd
template <typename F>
auto with_hd(int hd, F f) {
  if (hd <= 32) return f(std::integral_constant<int, 32>());
  if (hd <= 64) return f(std::integral_constant<int, 64>());
  if (hd <= 128) return f(std::integral_constant<int, 128>());
  return f(std::integral_constant<int, 256>());
}

template <int HD, typename TC>
size_t shard_smem(int buf, int hd) {
  const ShardPlan p = shard_plan(buf, hd);
  return ShardSmem<HD, TC>::bytes(p.split, p.cpr);
}

template <int HD, typename TC>
cudaError_t launch_shard_hd(const void* q, const void* ck, const void* cv,
                            void* out, float* lse, int batch, int buf,
                            int kvp, int gp, int hd, const void* pos_dev,
                            int pos_is64, long long pos_host, float scale,
                            int slot0, int ring, cudaStream_t stream) {
  const ShardPlan p = shard_plan(buf, hd);
  return repro::launch_cluster(
      decode_shard_tc_kernel<HD, TC>, dim3(p.split, batch * kvp),
      dim3(kShThreads), ShardSmem<HD, TC>::bytes(p.split, p.cpr), stream,
      static_cast<const float*>(q), static_cast<const TC*>(ck),
      static_cast<const TC*>(cv), static_cast<float*>(out), lse, buf, kvp,
      gp, hd, pos_dev, pos_is64, pos_host, scale * kLog2e, slot0, ring,
      p.chunk);
}

template <typename TC>
cudaError_t launch_shard_tc(const void* q, const void* ck, const void* cv,
                            void* out, float* lse, int batch, int buf,
                            int kvp, int gp, int hd, const void* pos_dev,
                            int pos_is64, long long pos_host, float scale,
                            int slot0, int ring, cudaStream_t stream) {
  if (!takes(gp, hd, buf) || slot0 < 0 || ring < 1)
    return cudaErrorInvalidValue;
  return with_hd(hd, [&](auto c) {
    return launch_shard_hd<decltype(c)::value, TC>(
        q, ck, cv, out, lse, batch, buf, kvp, gp, hd, pos_dev, pos_is64,
        pos_host, scale, slot0, ring, stream);
  });
}

// Resident CTAs per SM (clusters = 0) or clusters on the card at once
// (clusters = 1) of `kernel` in clusters of `cluster` CTAs; -1 on error.
template <typename... Params>
int occupancy(void (*kernel)(Params...), int threads, size_t smem,
              int cluster, int clusters) {
  if (repro::allow_smem(kernel, smem) != cudaSuccess) return -1;
  if (cluster > repro::kPortableCluster &&
      repro::refused(cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return -1;
  int n = -1;
  if (!clusters)
    return repro::refused(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &n, kernel, threads, smem)) == cudaSuccess
               ? n
               : -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return repro::refused(cudaOccupancyMaxActiveClusters(&n, kernel, &cfg)) ==
                 cudaSuccess
             ? n
             : -1;
}

template <typename TC>
int shard_occupancy(int route, int buf, int gp, int hd, int clusters) {
  if (route == 0) {  // decode_split_kernel, f32 query: row 3's kernel
    const Plan p = plan_for_ring(buf, gp, hd, sizeof(TC));
    return occupancy(decode_split_kernel<float, TC>,
                     32 * max(kMinWarps, gp), p.smem, p.split, clusters);
  }
  return with_hd(hd, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    return occupancy(decode_shard_tc_kernel<HD, TC>, kShThreads,
                     shard_smem<HD, TC>(buf, hd), shard_plan(buf, hd).split,
                     clusters);
  });
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
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  switch (cache_dtype) {
    case repro::kBF16:
      return launch_shard_tc<__nv_bfloat16>(q, ck, cv, out, l, batch, buf,
                                            kvp, gp, hd, pos_dev, pos_is64,
                                            pos_host, scale, slot0, ring, s);
    case repro::kF8E4M3:
      return launch_shard_tc<__nv_fp8_e4m3>(q, ck, cv, out, l, batch, buf,
                                            kvp, gp, hd, pos_dev, pos_is64,
                                            pos_host, scale, slot0, ring, s);
  }
  // f32 caches: row 3's kernel on the CUDA cores
  return launch_cache<float>(cache_dtype, q, ck, cv, out, batch, buf, kvp,
                             kvp, gp, hd, pos_dev, pos_is64, pos_host, scale,
                             slot0, ring, l, s);
}

// Dynamic shared memory, in bytes, of the shard launch over buf slots
// (the route its cache dtype takes); -1 for a shape it does not take.
extern "C" int decode_attention_shard_smem(int buf, int gp, int hd,
                                           int cache_dtype) {
  const int esize = esize_of(cache_dtype);
  if (esize == 0 || !takes(gp, hd, buf)) return -1;
  if (cache_dtype == repro::kF32)
    return static_cast<int>(plan_for_ring(buf, gp, hd, esize).smem);
  return static_cast<int>(with_hd(hd, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    return cache_dtype == repro::kF8E4M3
               ? shard_smem<HD, __nv_fp8_e4m3>(buf, hd)
               : shard_smem<HD, __nv_bfloat16>(buf, hd);
  }));
}

// Resident CTAs per SM (clusters = 0), or clusters resident on the card
// at once (clusters = 1), of a shard launch over buf slots of a bf16 or
// float8 cache: route 0 the CUDA-core decode_split_kernel (the shard's
// kernel before the tensor-core one), route 1 decode_shard_tc_kernel.
// -1 on a shape or dtype it does not take, or a refused query.
extern "C" int decode_attention_shard_occupancy(int route, int buf, int gp,
                                                int hd, int cache_dtype,
                                                int clusters) {
  if (!takes(gp, hd, buf)) return -1;
  if (cache_dtype == repro::kBF16)
    return shard_occupancy<__nv_bfloat16>(route, buf, gp, hd, clusters);
  if (cache_dtype == repro::kF8E4M3)
    return shard_occupancy<__nv_fp8_e4m3>(route, buf, gp, hd, clusters);
  return -1;
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
