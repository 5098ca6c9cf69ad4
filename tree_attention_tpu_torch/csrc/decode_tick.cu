// The one-row paged decode tick (kernels B2 and B5) for Hopper, sm_90a: the
// launches of ops/cuda_decode.py decode_body's "tick" rule — one packed query
// row per KV head, KV read through a block table, no tree mask, operands not
// f32:
//   exact bf16 q/k/v: B2 (replaces tree_attention_tpu/ops/pallas_decode.py
//     _flash_decode_paged_kernel at Tq 1), with or without local_blocks;
//   the cast route over B2: bf16 q against int8 pools, with or without
//     per-block (N, Hkv) K/V scalars, with or without local_blocks;
//   q8q: B5 (_flash_decode_paged_q8q_kernel at Tq 1), int8 Q codes with one
//     f32 scale per row against int8 pools, with per-block scalars or with
//     channel scales (folded into Q and the output by the wrapper).
// flash_decode.cu's header has the contract (packed rows, local_blocks, the
// fold order of the int8 scalars); this file the body that runs the serving
// tick on this card. The contiguous one-row launches (B1, B4, the B1 cast
// route) and every f32 launch stay on flash_decode.cu's split body.
//
// What bounds it: the bytes of the visible keys, K and V once each. A tick
// is a GEMV per KV head, so the tensor cores do not help; what does is
// keeping enough bytes in flight (about 20-25 KB per SM at 3.35 TB/s) from
// the first cycle, and few fixed costs, since at the serve shape (8 slots of
// at most 640 keys, 16 heads x 128) the whole tick moves ~21 MB: a handful
// of microseconds.
//
// One thread block CLUSTER of C = 1, 2, 4 or 8 CTAs (the host picks C, as
// many as keep two CTAs per SM at the tick's shape) per (slot, KV head):
// - The slot's visible keys [0, q_offset - kv_offset + Tq) are cut into
//   units: a block's rows, or a 64-key piece of a block longer than 64.
//   CTA rank r of the cluster takes units [r n / C, (r + 1) n / C) of the
//   slot's n visible units, so the split follows the slot's own length, not
//   the table's width: a short slot's CTAs share its few blocks.
// - At the start the CTA reads its units' table entries into shared
//   memory, 320 at a time, dropping remote entries (local_blocks: negative)
//   as it stores them; the int8 pools' per-block K and V scalars follow
//   while the first copies are in flight. After that no load waits on
//   another load, and no remote entry and no entry past the slot's frontier
//   is ever dereferenced.
// - A ring of 3 or more stages (64 keys of K and V each: about 64 KB or,
//   bf16 at D 128, 96 KB) is fed by the copy engine from a producer warp:
//   one lane issues one bulk copy (cp.async.bulk, sm90::bulk_load) per unit
//   for K and one for V — one pool block's rows for this head are
//   contiguous — onto the stage's full barrier with the stage's bytes
//   expected, as soon as the stage's empty barrier says the consumers are
//   done with it. A unit's copy ends at the slot's frontier, so keys past
//   it inside the last block are never loaded; rows of a stage that no
//   copy wrote are never read into a product: their scores are -inf and
//   their p = 0 is SELECTED away, never multiplied, so stale shared memory
//   cannot reach the output (0 * NaN never happens).
// - Four consumer warps each take 16 keys of every stage with an online
//   softmax of their own, so no CTA barrier stands between two stages (a
//   first version shared one softmax across the CTA, two barriers a stage,
//   and its compute alone took as long as the copies on the card: one warp
//   per scheduler, every step waiting on the last). Scores without a per-key
//   warp reduction: eight lanes share a key (a quarter-warp reads a K row's
//   128 bytes at a time, conflict free), each taking D / 8 dims in f32 FMAs
//   (bf16; the cast route widens the int8 codes exactly) or __dp4a on int8
//   Q and K codes with an exact int32 sum (q8q); three shuffles finish a
//   dot. The K scalar multiplies the score after the product; p = exp(s -
//   m), l takes p unscaled, and the V scalar multiplies p before the
//   rounding to bf16 (ta::round_as), the split body's fold order. For P.V
//   each lane owns D / 32 dims of the warp's 16 V rows.
// - The split merge inside the launch: the warps' states merge in shared
//   memory into the CTA's unnormalised (acc, m, l); each peer stores its
//   state into rank 0's shared memory through distributed shared memory
//   and arrives on rank 0's merge barrier (released to the cluster), then
//   exits; rank 0 merges the states with the safe-softmax monoid in rank
//   order and writes out and lse. A CTA with no visible key contributes the
//   identity (0, -inf, l = 0) and still arrives; a row no CTA saw finalizes
//   to (0, -inf). No partials go to global memory and no merge kernel
//   follows: one launch per tick.
#include <cooperative_groups.h>

#include <type_traits>

#include "decode.cuh"
#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumers = 4;                   // warps that compute
constexpr int kWarps = kConsumers + 1;          // ... and the producer's
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 64;                       // keys a ring stage holds
constexpr int kWarpKeys = kKeys / kConsumers;   // keys a warp takes of one
constexpr int kMaxCluster = 8;                  // the portable cluster limit
constexpr int kBatch = 2 * kThreads;  // table entries a CTA holds at once
constexpr int kSubs = 8;              // lanes that share a key's score
constexpr int kPassKeys = 32 / kSubs;           // keys a warp scores at once
constexpr int kPasses = kWarpKeys / kPassKeys;  // score passes a stage
constexpr int kRingTarget = 64 * 1024;          // ring bytes aimed for
static_assert(kPasses <= kSubs, "a key's p is taken by one of its lanes");
static_assert(kWarps <= 16, "the scan's totals");

// Where everything sits in the dynamic shared memory of one CTA.
template <typename TKV, int D, bool kScales>
struct Layout {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(TKV));
  static constexpr int kTileBytes = kKeys * kRowBytes;  // K (or V) of a stage
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStages =
      3 * kStageBytes >= kRingTarget ? 3 : kRingTarget / kStageBytes;
  static constexpr int kBars = kStages * kStageBytes;  // full, empty, merge
  static constexpr int kEnt = kBars + 16 * ((8 * (2 * kStages + 1) + 15) / 16);
  static constexpr int kScale = kEnt + 4 * 4 * kBatch;  // pb, row0, rows, row
  static constexpr int kP = kScale + (kScales ? 2 * 4 * kBatch : 0);
  static constexpr int kScan = kP + 4 * kKeys;
  static constexpr int kWarpState = kScan + 4 * 16;  // kWarps <= 16
  static constexpr int kPeers = kWarpState + 4 * kConsumers * (D + 2);
  static constexpr int kBytes = kPeers + 4 * (kMaxCluster - 1) * (D + 2);
  static_assert(kStages >= 3, "ring shape");
};

// The n = 2 or 4 words of a 8- or 16-byte aligned run.
template <int N>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = x.x; w[4 * i + 1] = x.y; w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  } else {
    static_assert(N == 2, "runs of 8 or 16k bytes");
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x; w[1] = x.y;
  }
}

// A word's values as f32: two bf16, or four int8 codes (exact: the bytes
// biased to unsigned and placed under the exponent of 2^23).
__device__ __forceinline__ void unpack(uint32_t w, const __nv_bfloat16*,
                                       float* f) {
  const float2 x =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  f[0] = x.x; f[1] = x.y;
}
__device__ __forceinline__ void unpack(uint32_t w, const int8_t*, float* f) {
  const uint32_t x = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 | i))
           - 8388736.f;
}

// A lane's share of a key's dot: kW contiguous elements per run, kRuns
// runs 8 kW apart, so that the 8 lanes of a key read 8 kW neighbouring
// elements together (a quarter-warp's 128 bytes, or two half-warps' 64).
template <typename TQ, typename TKV, int D>
struct Dot {
  static constexpr int kW = 16 / static_cast<int>(sizeof(TKV)) < D / 8
                                ? 16 / static_cast<int>(sizeof(TKV))
                                : D / 8;
  static constexpr int kRuns = D / (8 * kW);
  static constexpr int kWords = kW * static_cast<int>(sizeof(TKV)) / 4;
  static constexpr bool kQ8Q = std::is_same<TQ, int8_t>::value;
  // Q in registers: f32 values (bf16 Q), or int8 codes four to a word.
  float qf[kQ8Q ? 1 : kRuns * kW];
  uint32_t qw[kQ8Q ? kRuns * kWords : 1];

  __device__ __forceinline__ void load_q(const TQ* q, int sub) {
#pragma unroll
    for (int c = 0; c < kRuns; ++c) {
      const TQ* p = q + c * 8 * kW + sub * kW;
      if constexpr (kQ8Q) {
        uint32_t w[kWords];
        load_words(p, w);
#pragma unroll
        for (int i = 0; i < kWords; ++i) qw[c * kWords + i] = w[i];
      } else {  // bf16: kW elements are kW / 2 words
        uint32_t w[kW / 2];
        load_words(p, w);
#pragma unroll
        for (int i = 0; i < kW / 2; ++i)
          unpack(w[i], static_cast<const __nv_bfloat16*>(nullptr),
                 qf + c * kW + 2 * i);
      }
    }
  }

  // This lane's part of q . k for the K row at `row`, reduced over the
  // key's 8 lanes: a float, or (q8q) the exact int32 sum as a float.
  __device__ __forceinline__ float operator()(const TKV* row, int sub) const {
    if constexpr (kQ8Q) {
      int s = 0;
#pragma unroll
      for (int c = 0; c < kRuns; ++c) {
        uint32_t w[kWords];
        load_words(row + c * 8 * kW + sub * kW, w);
#pragma unroll
        for (int i = 0; i < kWords; ++i)
          s = __dp4a(static_cast<int>(qw[c * kWords + i]),
                     static_cast<int>(w[i]), s);
      }
#pragma unroll
      for (int o = 1; o < kSubs; o <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      return static_cast<float>(s);
    } else {
      constexpr int kPer = 4 / static_cast<int>(sizeof(TKV));
      float s[2] = {0.f, 0.f};  // two chains: half the FMA latency
#pragma unroll
      for (int c = 0; c < kRuns; ++c) {
        uint32_t w[kWords];
        load_words(row + c * 8 * kW + sub * kW, w);
#pragma unroll
        for (int i = 0; i < kWords; ++i) {
          float kf[kPer];
          unpack(w[i], row, kf);
#pragma unroll
          for (int j = 0; j < kPer; ++j)
            s[j & 1] = fmaf(qf[c * kW + i * kPer + j], kf[j], s[j & 1]);
        }
      }
      float x = s[0] + s[1];
#pragma unroll
      for (int o = 1; o < kSubs; o <<= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
      return x;
    }
  }
};

// A lane's D / 32 dims of a V row as f32: 8, 4 or 2 bytes.
template <typename TKV, int D>
__device__ __forceinline__ void load_v(const TKV* row, int lane,
                                       float (&f)[D / 32]) {
  constexpr int kBytes = D / 32 * static_cast<int>(sizeof(TKV));
  const uint8_t* p = reinterpret_cast<const uint8_t*>(row) + lane * kBytes;
  if constexpr (kBytes == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    unpack(x.x, row, f);
    unpack(x.y, row, f + 4 / sizeof(TKV));
  } else if constexpr (kBytes == 4) {
    unpack(*reinterpret_cast<const uint32_t*>(p), row, f);
  } else {  // two int8 codes
    static_assert(kBytes == 2 && sizeof(TKV) == 1, "V lane share");
    float g[4];
    unpack(*reinterpret_cast<const uint16_t*>(p), row, g);
    f[0] = g[0];
    f[1] = g[1];
  }
}

// The cluster barrier in two halves: arrive at the start, wait at the end.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One arrival on the mbarrier at `bar`'s offset in CTA `rank`'s shared
// memory, releasing this thread's prior writes to the cluster.
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(sm90::smem_u32(bar)), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
      :: "r"(remote) : "memory");
}

// sm90::mbar_wait, acquiring what the arrivals released to the cluster.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(sm90::smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * kConsumers) : "memory");
}

// At most three CTAs share an SM (shared memory bounds it first): room for
// every register the body wants, so none spills.
template <typename TQ, typename TKV, int D, bool kScales>
__global__ void __launch_bounds__(kThreads, 3)
decode_tick_kernel(const Args a) {
  using L = Layout<TKV, D, kScales>;
  constexpr int kLD = D / 32;  // a lane's dims of P.V
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kStages;
  int* ent_pb = reinterpret_cast<int*>(smem + L::kEnt);
  int* ent_row0 = ent_pb + kBatch;
  int* ent_n = ent_row0 + kBatch;
  int* tab = ent_n + kBatch;  // the table row's first kBatch entries
  float* ent_ks = reinterpret_cast<float*>(smem + L::kScale);
  float* ent_vs = ent_ks + kBatch;
  float* P = reinterpret_cast<float*>(smem + L::kP);
  int* scan = reinterpret_cast<int*>(smem + L::kScan);
  float* wstate = reinterpret_cast<float*>(smem + L::kWarpState);
  uint64_t* merge = empty + L::kStages;  // rank 0's: the peers' states in
  float* peers = reinterpret_cast<float*>(smem + L::kPeers);  // (acc, m, l)

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / C;
  const int b = bh / a.Hkv;
  const int h = bh - b * a.Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kp = lane / kSubs, sub = lane % kSubs;  // the score pass

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < L::kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers);
    }
    if (C > 1) sm90::mbar_init(merge, (C - 1) * D);
    sm90::mbar_fence_init();
  }
  if (C > 1) cluster_arrive();  // waited on before the merge

  // The slot's table row (its first kBatch entries), loaded beside the
  // offsets rather than after them: the first copies wait on one load.
  const int* trow = a.table + static_cast<size_t>(b) * a.NB;
  int pre[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int x = 2 * tid + i;
    pre[i] = x < a.NB ? trow[x] : 0;
  }
  // The slot's visible keys [0, j1), cut into units of U keys: a block, or
  // a piece of a block longer than a stage; kb units fill a stage.
  const int q_off = a.offs[b];
  const int kv_off = a.offs[a.B + b];
  const int j1 = min(a.Tk, q_off - kv_off + a.Tq);
  const int Hkv = a.Hkv, blk = a.blk;
  const int U = min(blk, kKeys);
  const int upb = (blk + U - 1) / U;
  const int kb = kKeys / U;
  const int ushift = (U & (U - 1)) == 0 ? __ffs(U) - 1 : -1;  // r / U
  int n_units = 0;
  if (j1 > 0) {
    const int whole = j1 / blk;
    n_units = whole * upb + (j1 - whole * blk + U - 1) / U;
  }
  const int log2c = __ffs(C) - 1;  // C is a power of two
  const int lo = (rank * n_units) >> log2c;
  const int hi = ((rank + 1) * n_units) >> log2c;

  Dot<TQ, TKV, D> dot;
  const size_t row = static_cast<size_t>(bh) * a.R;  // the one packed row
  dot.load_q(static_cast<const TQ*>(a.q) + row * D, sub);
  float qmul;  // the raw dot's multiplier: softmax scale or row scale
  if constexpr (std::is_same<TQ, int8_t>::value) {
    qmul = a.qs[row];
  } else {
    qmul = a.scale;
  }
  const uint8_t* kbase = static_cast<const uint8_t*>(a.k);
  const uint8_t* vbase = static_cast<const uint8_t*>(a.v);

  // A consumer warp's online softmax over its keys of every stage.
  float m = ta::kNegInf, l_part = 0.f;
  float acc[kLD];
#pragma unroll
  for (int i = 0; i < kLD; ++i) acc[i] = 0.f;
  int done = 0;  // stages of earlier batches: the ring's running count

#pragma unroll
  for (int i = 0; i < 2; ++i) tab[2 * tid + i] = pre[i];
  for (int u0 = lo; u0 < hi; u0 += kBatch) {
    const int n_in = min(kBatch, hi - u0);
    __syncthreads();  // the previous batch is consumed; the barriers exist
    // The batch's units, two a thread, kept in order if held: an exclusive
    // scan of the counts places them.
    int pb[2], r0[2], nk[2];
    bool ok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int x = 2 * tid + i;
      ok[i] = x < n_in;
      pb[i] = r0[i] = nk[i] = 0;
      if (ok[i]) {
        const int u = u0 + x;
        const int nb = u / upb;
        r0[i] = (u - nb * upb) * U;
        nk[i] = min(min(U, blk - r0[i]), j1 - (nb * blk + r0[i]));
        pb[i] = nb < kBatch ? tab[nb] : trow[nb];
        ok[i] = !a.local || pb[i] >= 0;  // a remote block is dropped
      }
    }
    const int cnt = ok[0] + ok[1];
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) scan[warp] = incl;
    __syncthreads();
    int pos = incl - cnt, n_list = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      pos += w < warp ? scan[w] : 0;
      n_list += scan[w];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!ok[i]) continue;
      ent_pb[pos] = pb[i];
      ent_row0[pos] = r0[i];
      ent_n[pos] = nk[i];
      ++pos;
    }
    __syncthreads();
    const int n_tiles = (n_list + kb - 1) / kb;

    if (warp == kConsumers) {
      // The producer: one lane fills stage after stage, each as soon as
      // the consumers have released it — one bulk copy of K and one of V
      // per unit, the stage's bytes announced first.
      if (lane == 0) {
        for (int t = 0; t < n_tiles; ++t) {
          const int g = done + t;
          const int s = g % L::kStages;
          if (g >= L::kStages)
            sm90::mbar_wait(&empty[s], ((g / L::kStages) - 1) & 1);
          uint8_t* kd = smem + s * L::kStageBytes;
          uint8_t* vd = kd + L::kTileBytes;
          const int e0 = t * kb, e1 = min(n_list, e0 + kb);
          uint32_t bytes = 0;
          for (int e = e0; e < e1; ++e) bytes += ent_n[e] * L::kRowBytes;
          sm90::mbar_expect_tx(&full[s], 2 * bytes);
          for (int e = e0; e < e1; ++e) {
            const size_t off =
                ((static_cast<size_t>(ent_pb[e]) * Hkv + h) * blk +
                 ent_row0[e]) * L::kRowBytes;
            const uint32_t n = ent_n[e] * L::kRowBytes;
            const int at = (e - e0) * U * L::kRowBytes;
            sm90::bulk_load(kd + at, kbase + off, n, &full[s]);
            sm90::bulk_load(vd + at, vbase + off, n, &full[s]);
          }
        }
      }
      __syncwarp();
    } else {
      // The consumers: the per-block scalars land while the first copies
      // fly, then each warp takes rows 16 warp .. 16 warp + 15 of every
      // stage.
      if constexpr (kScales) {
        for (int e = tid; e < n_list; e += 32 * kConsumers) {
          const size_t at = static_cast<size_t>(ent_pb[e]) * Hkv + h;
          ent_ks[e] = a.ks[at];
          ent_vs[e] = a.vs[at];
        }
        consumers_sync();
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int g = done + t;
        const int s = g % L::kStages;
        const TKV* Ks =
            reinterpret_cast<const TKV*>(smem + s * L::kStageBytes);
        const TKV* Vs = Ks + kKeys * D;
        // The stage's rows [0, n_valid) were copied: every unit of a stage
        // but its last is whole (only the slot's last unit, or a long
        // block's last piece, which has a stage to itself, is short).
        const int e0 = t * kb, e1 = min(n_list, e0 + kb);
        const int n_valid = (e1 - e0 - 1) * U + ent_n[e1 - 1];
        const int r0w = warp * kWarpKeys;  // the warp's first row
        // The entry of row r's unit (the stage's last for rows past it).
        auto unit = [=](int r) {
          return e0 + min(ushift >= 0 ? r >> ushift : r / U, e1 - 1 - e0);
        };
        sm90::mbar_wait(&full[s], (g / L::kStages) & 1);
        if (r0w < n_valid) {
          if constexpr (!std::is_same<TKV, int8_t>::value) {
            // bf16 rows no copy wrote may hold any bits: zero the warp's
            // share of them, so p = 0 meets 0 (a code is always finite).
            if (n_valid < r0w + kWarpKeys) {
              constexpr int kLaneWords = D / 64;  // a lane's kLD bf16 dims
              for (int r = max(n_valid, r0w); r < r0w + kWarpKeys; ++r) {
                uint32_t* w = reinterpret_cast<uint32_t*>(
                    const_cast<TKV*>(Vs) + r * D) + lane * kLaneWords;
#pragma unroll
                for (int i = 0; i < kLaneWords; ++i) w[i] = 0u;
              }
              // ... ordered before the copy engine refills the stage.
              asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
              __syncwarp();
            }
          }
          float sc[kPasses];
          float mx = ta::kNegInf;
#pragma unroll
          for (int p = 0; p < kPasses; ++p) {
            const int r = r0w + p * kPassKeys + kp;
            float x = dot(Ks + r * D, sub) * qmul;
            if constexpr (kScales) x *= ent_ks[unit(r)];
            sc[p] = r < n_valid ? x : ta::kNegInf;
            mx = fmaxf(mx, sc[p]);
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float m_new = fmaxf(m, mx);
          const float alpha =
              m == ta::kNegInf ? 0.f : expf(m - m_new);
          l_part *= alpha;
          // Lane sub < kPasses takes p of its key group's pass-sub key.
          float mine = sc[0];
#pragma unroll
          for (int p = 1; p < kPasses; ++p) mine = sub == p ? sc[p] : mine;
          const int r = r0w + sub * kPassKeys + kp;
          const bool owner = sub < kPasses;
          const float pr = owner && r < n_valid ? expf(mine - m_new) : 0.f;
          l_part += pr;
          if (owner) {
            float pv = pr;
            if constexpr (kScales) pv *= ent_vs[unit(r)];
            P[r] = ta::round_as(pv, Vs);
          }
          __syncwarp();
          // P.V over the warp's rows (p = 0 on a row no copy wrote).
#pragma unroll
          for (int i = 0; i < kLD; ++i) acc[i] *= alpha;
#pragma unroll
          for (int j = 0; j < kWarpKeys; ++j) {
            const int r = r0w + j;
            const float pj = P[r];
            float vf[kLD];
            load_v<TKV, D>(Vs + r * D, lane, vf);
#pragma unroll
            for (int i = 0; i < kLD; ++i) acc[i] = fmaf(pj, vf[i], acc[i]);
          }
          m = m_new;
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[s]);
      }
    }
    done += n_tiles;
  }

  // The warps' states, then the CTA's: acc and l rescaled to the largest m.
  if (warp < kConsumers) {
    float lw = l_part;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      lw += __shfl_xor_sync(0xffffffffu, lw, o);
    float* ws = wstate + warp * (D + 2);
#pragma unroll
    for (int i = 0; i < kLD; ++i) ws[lane * kLD + i] = acc[i];
    if (lane == 0) {
      ws[D] = m;
      ws[D + 1] = lw;
    }
  }
  __syncthreads();
  float M = ta::kNegInf, x = 0.f, l = 0.f;  // thread tid < D: the CTA's
  if (tid < D) {
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) M = fmaxf(M, wstate[w * (D + 2) + D]);
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      const float* ws = wstate + w * (D + 2);
      const float wt = ws[D] == ta::kNegInf ? 0.f : expf(ws[D] - M);
      x += wt * ws[tid];
      l += wt * ws[D + 1];
    }
  }
  // The merge. A peer stores its state into rank 0's shared memory
  // (distributed shared memory) and arrives on rank 0's merge barrier,
  // then exits; rank 0 merges the C states in rank order and writes out
  // and lse. (A cluster.sync() pair here, every CTA waiting for rank 0's
  // reads through distributed shared memory, was slower on the card.)
  if (C > 1) cluster_wait();  // rank 0's merge barrier exists
  if (tid < D) {
    if (rank != 0) {
      float* dst = cluster.map_shared_rank(peers, 0) + (rank - 1) * (D + 2);
      dst[tid] = x;
      if (tid == 0) {
        dst[D] = M;
        dst[D + 1] = l;
      }
      mbar_arrive_remote(merge, 0);
    } else {
      if (C > 1) mbar_wait_cluster(merge, 0);
      float num = x, den = l, Mc = M;
      for (int r = 1; r < C; ++r) Mc = fmaxf(Mc, peers[(r - 1) * (D + 2) + D]);
      const float w0 = M == ta::kNegInf ? 0.f : expf(M - Mc);
      num *= w0;
      den *= w0;
      for (int r = 1; r < C; ++r) {
        const float* st = peers + (r - 1) * (D + 2);
        const float w = st[D] == ta::kNegInf ? 0.f : expf(st[D] - Mc);
        den += w * st[D + 1];
        num += w * st[tid];
      }
      // (__fdividef: no slow-path call; its 2 ulp vanish in the bf16 out.)
      const bool none = den <= 0.f;
      ta::store(static_cast<__nv_bfloat16*>(a.out) + row * D + tid,
                none ? 0.f : __fdividef(num, den));
      if (tid == 0) a.lse[row] = none ? ta::kNegInf : Mc + logf(den);
    }
  }
}

template <typename TQ, typename TKV, int D, bool kScales>
cudaError_t launch(const Args& a, int cluster, cudaStream_t stream) {
  using L = Layout<TKV, D, kScales>;
  auto kernel = decode_tick_kernel<TQ, TKV, D, kScales>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * a.B * a.Hkv);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// An operand variant's launches at D 64 or 128, with per-block scalars
// (int8 pools only) or without.
template <typename TQ, typename TKV>
cudaError_t by_shape(int D, const Args& a, int cluster, cudaStream_t st) {
  const bool scales = a.ks != nullptr;
  if constexpr (std::is_same<TKV, int8_t>::value) {
    if (scales && D == 64) return launch<TQ, TKV, 64, true>(a, cluster, st);
    if (scales && D == 128) return launch<TQ, TKV, 128, true>(a, cluster, st);
  }
  if (scales) return cudaErrorInvalidValue;
  if (D == 64) return launch<TQ, TKV, 64, false>(a, cluster, st);
  if (D == 128) return launch<TQ, TKV, 128, false>(a, cluster, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Keys a ring stage holds, and the largest cluster (CTAs a slot's row
// takes): the host sizes the launch from them.
int decode_tick_keys() { return kKeys; }
int decode_tick_max_cluster() { return kMaxCluster; }

// variant: 1 = bf16 q/k/v/out; 2 = bf16 q, int8 k/v, bf16 out (the cast
// route); 3 = int8 q codes with per-row f32 scales qs (BH, R), int8 k/v,
// bf16 out (q8q). k/v: (N, Hkv, blk, D) pools read through table (B, NB),
// Tk = NB * blk; one packed row (R = Tq = 1); ks/vs: per-block (N, Hkv) f32
// scalars of an int8 pool, or null; local_blocks: the table is signed and
// a negative entry is a block another rank holds, never read. cluster: the
// CTAs of a row's cluster, 1, 2, 4 or 8. Writes out (B*Hkv, 1, D) bf16 and
// lse (B*Hkv, 1) f32 in one launch; returns its CUDA error (0 on success).
int decode_tick_launch(const void* q, const void* k, const void* v,
                       const void* qs, const void* ks, const void* vs,
                       const void* offs, const void* table, void* out,
                       void* lse, int variant, int D, int B, int Hkv, int R,
                       int Tq, int Tk, int blk, int NB, int cluster,
                       int local_blocks, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R != 1 || Tq != 1 || blk <= 0 || Tk != NB * blk)
    return cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)))
    return cudaErrorInvalidValue;
  if ((ks == nullptr) != (vs == nullptr)) return cudaErrorInvalidValue;
  Args a{q, k, v, static_cast<const float*>(qs),
         static_cast<const float*>(ks), static_cast<const float*>(vs),
         static_cast<const int32_t*>(offs),
         static_cast<const int32_t*>(table), nullptr, nullptr, nullptr, out,
         static_cast<float*>(lse), B, Hkv, R, Tq, Tk, blk, NB, kKeys, 1,
         local_blocks, scale};
  switch (variant) {
    case kExactBf16:
      return by_shape<__nv_bfloat16, __nv_bfloat16>(D, a, cluster, st);
    case kCast:
      return by_shape<__nv_bfloat16, int8_t>(D, a, cluster, st);
    case kQ8Q:
      if (qs == nullptr) return cudaErrorInvalidValue;
      return by_shape<int8_t, int8_t>(D, a, cluster, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
