// Split-KV flash decode (kernels B1, B2, B4 and B5) for Hopper, sm_90a.
//
// Replaces tree_attention_tpu/ops/pallas_decode.py:
//   _flash_decode_kernel            (B1: contiguous KV; exact or int8 K/V)
//   _flash_decode_paged_kernel      (B2: KV read through a (B, NB) block
//                                    table over an (N, Hkv, block, D) pool;
//                                    exact, or int8 with optional per-block
//                                    K/V scalars; with local_blocks, one
//                                    rank's slice of a sequence-sharded
//                                    pool under a signed table)
//   _flash_decode_q8q_kernel        (B4: int8 Q x int8 K -> int32 scores)
//   _flash_decode_paged_q8q_kernel  (B5: B4 through the block table, with
//                                    optional per-block K/V scalars)
// each with and without its static `tree` flag (the kTree template flag
// here). The bodies serve four operand variants:
//   exact  q, k, v and out all f32 or all bf16;
//   cast   q bf16, k/v int8 widened to float (exact for [-127, 127]), out
//          bf16 — the "q8" route over B1/B2;
//   q8q    q int8 codes with one f32 scale per packed row, k/v int8, scores
//          int8 x int8 summed in int32 (__dp4a, exact: |s| <= 128 * 127^2
//          < 2^31), rescaled by the row's scale; out bf16.
// Per-block scalars (N, Hkv) multiply the score after the product (they
// commute out of it) and p after the softmax sum l has taken it, so l is
// over the dequantized scores and the scalar belongs to the V values — the
// TPU kernels' fold order (_decode_softmax_fold). They are read through the
// table by the key's own block: scale[table[b, j / blk] * Hkv + h] (by the
// multi-row body and the tick body: only paged int8 pools carry them).
//
// What bounds it on the card: decode streams every visible KV byte once and
// does a few operations per byte per packed query row, so at the serving
// shapes it is bound by HBM bytes: (visible K + V bytes) / 3.35 TB/s — half
// as many bytes for int8 K/V as for bf16. Each KV head's G*Tq query rows
// are packed (row r = g*Tq + t), exactly the TPU kernel's packing, so a KV
// head's stream serves its whole GQA group.
//
// Three bodies, chosen statically by the wrapper (ops/cuda_decode.py
// decode_body):
// - the multi-row body (decode_tiled.cuh; tensor cores) takes every launch
//   with more than one packed row per KV head, or a tree mask, whose
//   operands are not f32: exact bf16 (B1 on contiguous K/V, B2 through the
//   table), the cast route over B1/B2, and q8q (B4 contiguous, B5 through
//   the table): prompt tails and staged chunks, verify ticks, the sharded
//   pool's chunks. It reads each key once per 64 packed rows, so it is
//   bound by the visible K/V bytes;
// - the tick body (decode_tick.cu; a thread block cluster per row) takes
//   every one-row launch through the table without a mask whose operands
//   are not f32: the serving decode tick of B2, its cast route and B5;
// - the split body (this file; CUDA cores) takes the rest: one contiguous
//   packed row without a mask (the reference workload: B1, B4, B1's cast
//   route), and f32 at any row count on either layout (the reference pins
//   f32 products at HIGHEST). At one row a warp it reads each key once and
//   is bound by bytes as well; its 8-row tile (f32 only) re-streams every
//   key for every 8 rows. It is built at one contiguous row for every
//   variant, and through the table, with the 8-row tile and the tree mask
//   for f32 only.
//
// The split body (decode_split_kernel; CUDA cores):
// - One WARP is one (KV split, Q tile of RW packed rows, b*Hkv) work item
//   with its own online-softmax state in registers. Lane l owns head dims
//   [l*D/32, (l+1)*D/32): a key's K and V rows are read by the warp as one
//   coalesced D-element line straight into registers (no shared memory),
//   held in their storage type until used (an int8 lane share at D = 128 is
//   one 32-bit word: a K row is one 128-byte warp load), a chunk of keys at
//   a time so several lines are in flight — more keys per chunk for int8,
//   whose lines are half a bf16 line. Scores are lane partial dots + a warp
//   all-reduce. RW is 1 when a KV head has a single query row (MHA decode,
//   the reference workload): a lean variant
//   whose low register count keeps more warps — more loads — in flight per
//   SM, and which holds two chunks, issuing the next chunk's loads before
//   it folds in the current one, so a warp's loads do not stop while it
//   computes; otherwise 8 (f32), and each 8-row tile re-streams the keys.
//
// Both bodies:
// - Splits give the card enough independent work items to cover HBM
//   latency even at B=1 (the reference workload has 16 KV heads for 132
//   SMs). Each writes a normalized partial (o, lse); a second small kernel
//   (decode.cuh merge_splits_kernel) merges the splits with the
//   safe-softmax monoid (ops/reference.py merge_partials). At the
//   reference workload a row has 252 partials: one warp walking them with
//   each o load waiting on its lse load took 0.113 ms of B1's 0.309 (an
//   H100), so the weights are computed lane-parallel, the o loads issued
//   16 at a time, and from 64 partials four warps share a row.
// - Causal culling: a split's key range stops at the last query row's
//   frontier (key q_offset - kv_offset + Tq - 1), so a short slot reads
//   only its own blocks and never dereferences table entries past its
//   length, and a split or a shard wholly past the frontier reads nothing
//   and writes the merge identity (0, -inf).
// - Keys past Tk are never loaded: their V rows (and per-block scalars)
//   stay 0, so a masked p = 0 never meets garbage (0 * NaN).
// - local_blocks (B2 only; the sequence-sharded pool, where each rank holds
//   a slice of the blocks): the table is SIGNED, a negative entry names a
//   block another rank holds. Its keys are treated like keys past Tk — K,
//   V and the per-block scalars are never read at that entry (the TPU
//   kernel clamps its DMA to pool row 0 instead; here nothing needs to
//   stream), and the keys are masked out of the softmax. A chunk (split
//   body) or tile (multi-row body) of keys that are all remote is skipped
//   whole. A row whose every visible block is remote keeps m = -inf, l = 0
//   and finalizes to (0, -inf), the merge identity. The wrapper sizes the
//   multi-row body's splits on the rank's share of the keys, NB * blk / W
//   (W from the caller that holds the mesh); the split body's stay on the
//   logical length, since each warp checks its range chunk by chunk and
//   short splits spread those checks over more warps.
// - The tree variant (kTree; speculative tree verification, SpecInfer,
//   arXiv:2305.09781): a slot's Tq <= 32 query rows are packed draft-tree
//   nodes at KV positions [q_off, q_off + Tq), and each packed row carries
//   one int32 word (tree, (BH, R)), bit i set iff its query row sees window
//   position i (its ancestors and itself). Row r sees the key at p iff
//   rel = p - q_off < 0 (committed history) or rel < Tq and bit rel of its
//   word is set (read as unsigned: bit 31 is the sign bit). That replaces
//   the causal test; the causal cull of the key range stays, since the
//   window ends at q_off + Tq, and the ragged-tail and local-blocks masks
//   compose with it unchanged. A lower-triangular mask is the causal rule,
//   so it gives the causal launch's out and lse bit for bit. The word is
//   one register per row, loaded beside the row's position; the flag is a
//   template parameter, so the body without it is unchanged. The split
//   body builds it for the 8-row Q tile of f32 only.
#include <type_traits>

#include "decode.cuh"

namespace {

constexpr int kWarps = 4;

// A lane's share of one packed query row: widened to f32, or (q8q) the int8
// codes in one word, like an int8 K line.
template <typename TQ, int N>
struct QReg {
  float f[N];
  __device__ __forceinline__ void load(const TQ* p) { ta::load_vec<N>(p, f); }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = 0.f;
  }
};

template <int N>
struct QReg<int8_t, N> {
  ta::Line<int8_t, N> w;
  __device__ __forceinline__ void load(const int8_t* p) { w.load(p); }
  __device__ __forceinline__ void zero() { w.zero(); }
};

// q . k over the warp's D lanes, as a float: f32 fused multiply-adds, or
// (int8 Q and K) one __dp4a per lane and an exact int32 warp sum.
template <typename TQ, typename TKV, int N>
__device__ __forceinline__ float dot(const QReg<TQ, N>& q,
                                     const ta::Line<TKV, N>& k) {
  if constexpr (std::is_same<TQ, int8_t>::value) {
    static_assert(std::is_same<TKV, int8_t>::value, "q8q needs int8 K");
    return static_cast<float>(ta::warp_sum(
        __dp4a(static_cast<int>(q.w.u), static_cast<int>(k.u), 0)));
  } else {
    float kf[N];
    k.unpack(kf);
    float part = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) part = fmaf(q.f[n], kf[n], part);
    return ta::warp_sum(part);
  }
}

template <typename TQ, typename TKV, int D, bool kPaged, int RW, bool kTree>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const Args a) {
  constexpr int N = D / 32;
  constexpr bool kQ8Q = std::is_same<TQ, int8_t>::value;
  constexpr bool kInt8KV = std::is_same<TKV, int8_t>::value;
  // Keys a chunk holds in registers: 8 bf16 lines, twice as many of the
  // narrower int8 ones; the one-row variant keeps two chunks in flight, of
  // 4 f32 lines each (the same 128 bytes of K and V a lane at D = 128).
  constexpr int kKeysPerChunk =
      kInt8KV ? 16 : (std::is_same<TKV, float>::value && RW == 1 ? 4 : 8);
  const TQ* __restrict__ q = static_cast<const TQ*>(a.q);
  const TKV* __restrict__ k = static_cast<const TKV*>(a.k);
  const TKV* __restrict__ v = static_cast<const TKV*>(a.v);
  const int lane = threadIdx.x & 31;
  const int split = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int row0 = blockIdx.y * RW;
  const int bh = blockIdx.z;
  const int BH = gridDim.z;
  const int b = bh / a.Hkv;
  const int h = bh - b * a.Hkv;
  const int R = a.R;
  const int nrows = min(RW, R - row0);
  const int q_off = a.offs[b];
  const int kv_off = a.offs[a.B + b];

  const int j0 = split * a.split_len;
  int j1 = min(a.Tk, j0 + a.split_len);
  if (a.causal) j1 = min(j1, q_off - kv_off + a.Tq);

  QReg<TQ, N> qr[RW];
  float qmul[RW];  // the raw dot's multiplier: softmax scale or row scale
  int qpos[RW];
  uint32_t bits[kTree ? RW : 1];  // tree: each row's ancestor bitmask
  float m[RW], l[RW], acc[RW][N];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const size_t row = (size_t)bh * R + row0 + r;
    if (r < nrows) {
      qr[r].load(q + row * D + lane * N);
      if constexpr (kQ8Q) {
        qmul[r] = a.qs[row];
      } else {
        qmul[r] = a.scale;
      }
    } else {
      qr[r].zero();
      qmul[r] = 0.f;
    }
    qpos[r] = q_off + (row0 + r) % a.Tq;
    if constexpr (kTree) {
      bits[r] = r < nrows
                    ? static_cast<uint32_t>(a.tree[(size_t)bh * R + row0 + r])
                    : 0u;
    }
    m[r] = ta::kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) acc[r][n] = 0.f;
  }

  // Block of key jj and its row in the block: shifts for a power-of-two
  // block size (every serving pool), a division otherwise.
  const int blk_shift = (a.blk & (a.blk - 1)) == 0 ? __ffs(a.blk) - 1 : -1;

  // A chunk of keys: each lane's share of their K and V lines, held in
  // registers; bit c of `loaded`: key j + c was
  // loaded (below j1 and, under local_blocks, on a block this rank holds),
  // the same for every lane of the warp.
  struct Chunk {
    ta::Line<TKV, N> kl[kKeysPerChunk], vl[kKeysPerChunk];
    uint32_t loaded;
  };
  auto load_chunk = [&](int j, Chunk& ch) {
    ch.loaded = 0;
#pragma unroll
    for (int c = 0; c < kKeysPerChunk; ++c) {
      const int jj = j + c;
      bool ok = jj < j1;
      int pb = 0;
      int in_blk = 0;
      if constexpr (kPaged) {
        if (ok) {
          const int nb = blk_shift >= 0 ? jj >> blk_shift : jj / a.blk;
          in_blk = jj - nb * a.blk;
          pb = a.table[b * a.NB + nb];
          if (a.local && pb < 0) ok = false;  // a remote block
        }
      }
      if (ok) {
        size_t base;
        if constexpr (kPaged) {
          base = (((size_t)pb * a.Hkv + h) * a.blk + in_blk) * D;
        } else {
          base = ((size_t)bh * a.Tk + jj) * D;
        }
        ch.kl[c].load(k + base + lane * N);
        ch.vl[c].load(v + base + lane * N);
        ch.loaded |= 1u << c;
      } else {
        ch.kl[c].zero();
        ch.vl[c].zero();
      }
    }
  };
  // Fold chunk ch of keys j .. j + kKeysPerChunk - 1 into every row's
  // online softmax.
  auto consume = [&](int j, const Chunk& ch) {
    if (ch.loaded == 0) return;  // every key of the chunk is remote
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      if (r >= nrows) continue;
      float s[kKeysPerChunk];
      float mx = ta::kNegInf;
#pragma unroll
      for (int c = 0; c < kKeysPerChunk; ++c) {
        const float sc = dot(qr[r], ch.kl[c]) * qmul[r];
        const int jj = j + c;
        bool rule;
        if constexpr (kTree) {
          // The window rule; rel < Tq <= 32 guards the shift.
          const int rel = kv_off + jj - q_off;
          rule = rel < 0 || (rel < a.Tq && ((bits[r] >> rel) & 1u));
        } else {
          rule = !a.causal || kv_off + jj <= qpos[r];
        }
        const bool vis = ((ch.loaded >> c) & 1u) && rule;
        s[c] = vis ? sc : ta::kNegInf;
        mx = fmaxf(mx, s[c]);
      }
      const float m_new = fmaxf(m[r], mx);
      if (m_new == ta::kNegInf) continue;  // nothing visible yet
      const float alpha = m[r] == ta::kNegInf ? 0.f : expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) acc[r][n] *= alpha;
#pragma unroll
      for (int c = 0; c < kKeysPerChunk; ++c) {
        const float p = s[c] == ta::kNegInf ? 0.f : expf(s[c] - m_new);
        psum += p;
        const float pv = ta::round_as(p, v);  // int8 V counts as bf16
        float vf[N];
        ch.vl[c].unpack(vf);
#pragma unroll
        for (int n = 0; n < N; ++n) acc[r][n] = fmaf(pv, vf[n], acc[r][n]);
      }
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
    }
  };

  if constexpr (RW == 1) {
    // Two chunks in registers: the next chunk's loads are in flight while
    // this one is folded in.
    Chunk c0, c1;
    if (j0 < j1) load_chunk(j0, c0);
    for (int j = j0; j < j1; j += 2 * kKeysPerChunk) {
      const int j2 = j + kKeysPerChunk;
      if (j2 < j1) load_chunk(j2, c1);
      consume(j, c0);
      if (j2 >= j1) break;
      if (j2 + kKeysPerChunk < j1) load_chunk(j2 + kKeysPerChunk, c0);
      consume(j2, c1);
    }
  } else {
    for (int j = j0; j < j1; j += kKeysPerChunk) {
      Chunk ch;
      load_chunk(j, ch);
      consume(j, ch);
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (r >= nrows) continue;
    const size_t row = ((size_t)split * BH + bh) * R + row0 + r;
    const bool empty = l[r] <= 0.f;
    const float inv = empty ? 0.f : 1.f / l[r];
#pragma unroll
    for (int n = 0; n < N; ++n)
      a.o_part[row * D + lane * N + n] = acc[r][n] * inv;
    if (lane == 0) a.lse_part[row] = empty ? ta::kNegInf : m[r] + logf(l[r]);
  }
}

template <typename TQ, typename TKV, typename TO, int D, bool kPaged, int RW,
          bool kTree = false>
cudaError_t launch(const Args& a, int split_ctas, cudaStream_t stream) {
  const int BH = a.B * a.Hkv;
  dim3 grid(split_ctas, (a.R + RW - 1) / RW, BH);
  decode_split_kernel<TQ, TKV, D, kPaged, RW, kTree>
      <<<grid, kWarps * 32, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return merge_splits<TO, D>(a, split_ctas * kWarps, stream);
}

// f32 at 1 or 8 rows a warp (the 8-row tile also with the tree mask); every
// other variant at one contiguous row only: its multi-row launches and tree
// masks run on the multi-row body (decode_tiled.cuh), its one-row paged
// launches on the tick body (decode_tick.cu).
template <typename TQ, typename TKV, typename TO, bool kPaged>
cudaError_t by_shape(int rows_per_warp, int D, const Args& a, int ctas,
                     cudaStream_t st) {
  constexpr bool kF32 = std::is_same<TQ, float>::value;
  if constexpr (kF32) {
    if (a.tree != nullptr) {  // the tree variant: the 8-row Q tile only
      if (rows_per_warp == 8 && D == 64)
        return launch<TQ, TKV, TO, 64, kPaged, 8, true>(a, ctas, st);
      if (rows_per_warp == 8 && D == 128)
        return launch<TQ, TKV, TO, 128, kPaged, 8, true>(a, ctas, st);
      return cudaErrorInvalidValue;
    }
    if (rows_per_warp == 8 && D == 64)
      return launch<TQ, TKV, TO, 64, kPaged, 8>(a, ctas, st);
    if (rows_per_warp == 8 && D == 128)
      return launch<TQ, TKV, TO, 128, kPaged, 8>(a, ctas, st);
  } else {
    if (a.tree != nullptr || kPaged) return cudaErrorInvalidValue;
  }
  if (rows_per_warp == 1 && D == 64)
    return launch<TQ, TKV, TO, 64, kPaged, 1>(a, ctas, st);
  if (rows_per_warp == 1 && D == 128)
    return launch<TQ, TKV, TO, 128, kPaged, 1>(a, ctas, st);
  return cudaErrorInvalidValue;
}

template <typename TQ, typename TKV, typename TO>
cudaError_t by_layout(int paged, int rows_per_warp, int D, const Args& a,
                      int ctas, cudaStream_t st) {
  if (a.ks != nullptr) return cudaErrorInvalidValue;  // the tick body's
  if (!paged) return by_shape<TQ, TKV, TO, false>(rows_per_warp, D, a, ctas,
                                                 st);
  if constexpr (std::is_same<TQ, float>::value) {
    return by_shape<TQ, TKV, TO, true>(rows_per_warp, D, a, ctas, st);
  } else {
    return cudaErrorInvalidValue;  // paged, not f32: another body's
  }
}

}  // namespace

extern "C" {

// Warps per CTA: the host sizes the grid and the partial buffers from it.
int flash_decode_warps_per_cta() { return kWarps; }

// variant: 0 = f32 q/k/v/out; 1 = bf16 q/k/v/out; 2 = bf16 q, int8 k/v, bf16
// out (the cast route); 3 = int8 q with per-row f32 scales qs (BH, R), int8
// k/v, bf16 out (q8q). paged: 0 = k/v are (B*Hkv, Tk, D); 1 (f32 only) =
// k/v are (N, Hkv, blk, D) pools read through table (B, NB), Tk = NB*blk.
// ks/vs: null (per-block scalars are the tick body's). rows_per_warp:
// 1 or (f32 only) 8 packed query rows per warp (the Q tile). o_part/lse_part hold
// split_ctas * warps_per_cta partials. local_blocks (paged only): the table
// is signed and a negative entry is a block another rank holds — never
// read, its keys masked. tree: (B*Hkv, R) int32 ancestor bitmasks of the
// packed rows (the tree variant; f32, causal, Tq <= 32, rows_per_warp
// 8), or null. Returns the CUDA error of the launches (0 on success).
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const void* qs, const void* ks, const void* vs,
                        const void* offs, const void* table,
                        const void* tree, void* o_part,
                        void* lse_part, void* out, void* lse, int variant,
                        int D, int paged, int rows_per_warp, int B, int Hkv,
                        int R, int Tq, int Tk, int blk, int NB,
                        int split_ctas, int split_len, int causal,
                        int local_blocks, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((ks == nullptr) != (vs == nullptr)) return cudaErrorInvalidValue;
  if (local_blocks && !paged) return cudaErrorInvalidValue;
  if (tree != nullptr && (!causal || Tq > 32)) return cudaErrorInvalidValue;
  Args a{q, k, v, static_cast<const float*>(qs),
         static_cast<const float*>(ks), static_cast<const float*>(vs),
         static_cast<const int32_t*>(offs),
         static_cast<const int32_t*>(table),
         static_cast<const int32_t*>(tree), static_cast<float*>(o_part),
         static_cast<float*>(lse_part), out, static_cast<float*>(lse),
         B, Hkv, R, Tq, Tk, blk, NB, split_len, causal, local_blocks,
         scale};
  switch (variant) {
    case kExactF32:
      return by_layout<float, float, float>(paged, rows_per_warp, D, a,
                                            split_ctas, st);
    case kExactBf16:
      return by_layout<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
          paged, rows_per_warp, D, a, split_ctas, st);
    case kCast:
      return by_layout<__nv_bfloat16, int8_t, __nv_bfloat16>(
          paged, rows_per_warp, D, a, split_ctas, st);
    case kQ8Q:
      if (qs == nullptr) return cudaErrorInvalidValue;
      return by_layout<int8_t, int8_t, __nv_bfloat16>(
          paged, rows_per_warp, D, a, split_ctas, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
