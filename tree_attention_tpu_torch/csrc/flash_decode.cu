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
// here). The split body serves four operand variants (the multi-row body
// the exact bf16 one):
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
// table by the key's own block: scale[table[b, j / blk] * Hkv + h].
//
// What bounds it on the card: decode streams every visible KV byte once and
// does a few operations per byte per packed query row, so at the serving
// shapes it is bound by HBM bytes: (visible K + V bytes) / 3.35 TB/s — half
// as many bytes for int8 K/V as for bf16. Each KV head's G*Tq query rows
// are packed (row r = g*Tq + t), exactly the TPU kernel's packing, so a KV
// head's stream serves its whole GQA group.
//
// Two bodies, chosen statically by the wrapper (ops/cuda_decode.py
// decode_body): the multi-row body for B2 with bf16 q/k/v and more than one
// packed row or a tree mask (prompt tails below the Q-tile width, verify
// ticks, the sharded pool's chunks), the split body for everything else
// (R = 1, f32, the int8 cast and q8q variants, contiguous B1/B4), which is
// built for bf16 B2 only at R = 1.
//
// The multi-row body (decode_tiled_kernel; tensor cores). One CTA per (KV
// split, Q tile of up to 64 packed rows, b*Hkv): for R <= 64 a split reads
// each key ONCE for all its rows. Warp w owns 16 packed rows. The split's
// K/V rows go to shared memory in 64-key tiles, double-buffered, by 16-byte
// cp.async with the page read from the table per key (a key not to be read
// is zero-filled and never dereferenced); cp.async rather than TMA because
// that per-key zero fill (a ragged tail, a remote block) and any block size
// come free, where a 4-D tensor map would need both re-done in shared
// memory. Scores S = Q.K^T and O += P.V run on mma.sync m16n8k16 bf16 ->
// f32 (ldmatrix from an XOR-swizzled tile; .trans for V); mma.sync rather
// than wgmma because R is 8-64, below wgmma's 64-row tile at Tq 8, and the
// body is bound by bytes: what matters is that no score needs a warp
// all-reduce (a row's softmax max and sum cross the 4 lanes that hold it)
// and no key is read twice. Masks act on the score fragments with each
// row's position (and tree word) loaded once; a tile below every row's
// window with every key read takes none. P is rounded to bf16 as the A
// operand; l takes it unrounded.
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
//   the reference workload and the serving decode tick): a lean variant
//   whose low register count keeps more warps — more loads — in flight per
//   SM; otherwise 8, and each 8-row tile re-streams the keys.
//
// Both bodies:
// - Splits give the card enough independent work items to cover HBM
//   latency even at B=1 (the reference workload has 16 KV heads for 132
//   SMs). Each writes a normalized partial (o, lse); a second small kernel
//   merges the splits with the safe-softmax monoid (ops/reference.py
//   merge_partials).
// - Causal culling: a split's key range stops at the last query row's
//   frontier (q_offset + Tq - 1), so a short slot reads only its own blocks
//   and never dereferences table entries past its length.
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
//   body builds it for the 8-row Q tile only.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;

// Operand variants (the C interface's `variant`).
enum Variant { kExactF32 = 0, kExactBf16 = 1, kCast = 2, kQ8Q = 3 };

struct Args {
  const void* q;          // (BH, R, D) in TQ
  const void* k;          // (BH, Tk, D), or the (N, Hkv, blk, D) pool
  const void* v;
  const float* qs;        // (BH, R) per-row Q scales (q8q only)
  const float* ks;        // (N, Hkv) per-block K scalars (paged, optional)
  const float* vs;        // (N, Hkv) per-block V scalars
  const int32_t* offs;    // (2, B): q_offset row, kv_offset row
  const int32_t* table;   // (B, NB) if paged
  const int32_t* tree;    // (BH, R) ancestor bitmasks (tree variant only)
  float* o_part;          // (S, BH, R, D)
  float* lse_part;        // (S, BH, R)
  void* out;              // (BH, R, D) in the output type
  float* lse;             // (BH, R)
  int B, Hkv, R, Tq, Tk, blk, NB, split_len, causal;
  int local;              // paged: negative table entries are remote blocks
  float scale;            // softmax scale (unused by q8q: folded into Q)
};

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

template <typename TQ, typename TKV, int D, bool kPaged, bool kScales, int RW,
          bool kTree>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const Args a) {
  constexpr int N = D / 32;
  constexpr bool kQ8Q = std::is_same<TQ, int8_t>::value;
  constexpr bool kInt8KV = std::is_same<TKV, int8_t>::value;
  constexpr int kKeysPerChunk = RW == 1 ? (kInt8KV ? 32 : 16)
                                        : (kInt8KV ? 16 : 8);
  constexpr int kScaleSlots = kScales ? kKeysPerChunk : 1;
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

  for (int j = j0; j < j1; j += kKeysPerChunk) {
    ta::Line<TKV, N> kl[kKeysPerChunk], vl[kKeysPerChunk];
    float ksc[kScaleSlots], vsc[kScaleSlots];
    // Bit c: key j + c was loaded (below j1 and, under local_blocks, on a
    // block this rank holds). The same for every lane of the warp.
    uint32_t loaded = 0;
#pragma unroll
    for (int c = 0; c < kKeysPerChunk; ++c) {
      const int jj = j + c;
      bool ok = jj < j1;
      int pb = 0;
      if constexpr (kPaged) {
        if (ok) {
          pb = a.table[b * a.NB + jj / a.blk];
          if (a.local && pb < 0) ok = false;  // a remote block
        }
      }
      if (ok) {
        size_t base;
        if constexpr (kPaged) {
          base = (((size_t)pb * a.Hkv + h) * a.blk + (jj % a.blk)) * D;
          if constexpr (kScales) {
            ksc[c] = a.ks[pb * a.Hkv + h];
            vsc[c] = a.vs[pb * a.Hkv + h];
          }
        } else {
          base = ((size_t)bh * a.Tk + jj) * D;
        }
        kl[c].load(k + base + lane * N);
        vl[c].load(v + base + lane * N);
        loaded |= 1u << c;
      } else {
        kl[c].zero();
        vl[c].zero();
        if constexpr (kScales) {
          ksc[c] = 0.f;
          vsc[c] = 0.f;
        }
      }
    }
    if (loaded == 0) continue;  // every key of the chunk is remote
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      if (r >= nrows) continue;
      float s[kKeysPerChunk];
      float mx = ta::kNegInf;
#pragma unroll
      for (int c = 0; c < kKeysPerChunk; ++c) {
        float sc = dot(qr[r], kl[c]) * qmul[r];
        if constexpr (kScales) sc *= ksc[c];  // this key's block K scalar
        const int jj = j + c;
        bool rule;
        if constexpr (kTree) {
          // The window rule; rel < Tq <= 32 guards the shift.
          const int rel = kv_off + jj - q_off;
          rule = rel < 0 || (rel < a.Tq && ((bits[r] >> rel) & 1u));
        } else {
          rule = !a.causal || kv_off + jj <= qpos[r];
        }
        const bool vis = ((loaded >> c) & 1u) && rule;
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
        // l takes p unscaled; the block's V scalar joins before the P
        // rounding (int8 V counts as bf16).
        const float pv = ta::round_as(kScales ? p * vsc[c] : p, v);
        float vf[N];
        vl[c].unpack(vf);
#pragma unroll
        for (int n = 0; n < N; ++n) acc[r][n] = fmaf(pv, vf[n], acc[r][n]);
      }
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
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

// One warp per (bh, row): merge the S split partials with the safe-softmax
// monoid and emit (out in TO, lse in f32). Rows no split saw emit (0, -inf).
template <typename TO, int D>
__global__ void __launch_bounds__(128)
merge_splits_kernel(const float* __restrict__ o_part,
                    const float* __restrict__ lse_part, TO* __restrict__ out,
                    float* __restrict__ lse, int S, int rows) {
  constexpr int N = D / 32;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (w >= rows) return;
  float mx = ta::kNegInf;
  for (int s = lane; s < S; s += 32) mx = fmaxf(mx, lse_part[(size_t)s * rows + w]);
  mx = ta::warp_max(mx);
  float num[N];
#pragma unroll
  for (int n = 0; n < N; ++n) num[n] = 0.f;
  float den = 0.f;
  if (mx != ta::kNegInf) {
    for (int s = 0; s < S; ++s) {
      const float ls = lse_part[(size_t)s * rows + w];
      if (ls == ta::kNegInf) continue;
      const float wgt = expf(ls - mx);
      float o[N];
      ta::load_vec<N>(o_part + ((size_t)s * rows + w) * D + lane * N, o);
      den += wgt;
#pragma unroll
      for (int n = 0; n < N; ++n) num[n] = fmaf(wgt, o[n], num[n]);
    }
  }
  const bool empty = den <= 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n)
    ta::store(out + (size_t)w * D + lane * N + n, empty ? 0.f : num[n] / den);
  if (lane == 0) lse[w] = empty ? ta::kNegInf : mx + logf(den);
}

template <typename TQ, typename TKV, typename TO, int D, bool kPaged,
          bool kScales, int RW, bool kTree = false>
cudaError_t launch(const Args& a, int split_ctas, cudaStream_t stream) {
  const int BH = a.B * a.Hkv;
  dim3 grid(split_ctas, (a.R + RW - 1) / RW, BH);
  decode_split_kernel<TQ, TKV, D, kPaged, kScales, RW, kTree>
      <<<grid, kWarps * 32, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = BH * a.R;
  merge_splits_kernel<TO, D><<<(rows + 3) / 4, 128, 0, stream>>>(
      a.o_part, a.lse_part, static_cast<TO*>(a.out), a.lse,
      split_ctas * kWarps, rows);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, typename TO, bool kPaged, bool kScales>
cudaError_t by_shape(int rows_per_warp, int D, const Args& a, int ctas,
                     cudaStream_t st) {
  // bf16 B2 with 8-row tiles or a tree mask runs the multi-row body
  // (tiled::), so the split body is not built for it.
  constexpr bool kLeanOnly =
      kPaged && std::is_same<TKV, __nv_bfloat16>::value;
  if (a.tree != nullptr) {  // the tree variant: the 8-row Q tile only
    if constexpr (!kLeanOnly) {
      if (rows_per_warp == 8 && D == 64)
        return launch<TQ, TKV, TO, 64, kPaged, kScales, 8, true>(a, ctas, st);
      if (rows_per_warp == 8 && D == 128)
        return launch<TQ, TKV, TO, 128, kPaged, kScales, 8, true>(a, ctas,
                                                                  st);
    }
    return cudaErrorInvalidValue;
  }
  if (rows_per_warp == 1 && D == 64)
    return launch<TQ, TKV, TO, 64, kPaged, kScales, 1>(a, ctas, st);
  if (rows_per_warp == 1 && D == 128)
    return launch<TQ, TKV, TO, 128, kPaged, kScales, 1>(a, ctas, st);
  if constexpr (!kLeanOnly) {
    if (rows_per_warp == 8 && D == 64)
      return launch<TQ, TKV, TO, 64, kPaged, kScales, 8>(a, ctas, st);
    if (rows_per_warp == 8 && D == 128)
      return launch<TQ, TKV, TO, 128, kPaged, kScales, 8>(a, ctas, st);
  }
  return cudaErrorInvalidValue;
}

template <typename TQ, typename TKV, typename TO>
cudaError_t by_layout(int paged, int rows_per_warp, int D, const Args& a,
                      int ctas, cudaStream_t st) {
  const bool scales = a.ks != nullptr;
  if (!paged)
    return scales ? cudaErrorInvalidValue
                  : by_shape<TQ, TKV, TO, false, false>(rows_per_warp, D, a,
                                                        ctas, st);
  if constexpr (std::is_same<TKV, int8_t>::value) {
    if (scales)
      return by_shape<TQ, TKV, TO, true, true>(rows_per_warp, D, a, ctas,
                                               st);
  } else {
    if (scales) return cudaErrorInvalidValue;  // only int8 pools scale
  }
  return by_shape<TQ, TKV, TO, true, false>(rows_per_warp, D, a, ctas, st);
}

// ------------------------------------- B2's multi-row body: tensor cores --

namespace tiled {

constexpr int kKeys = 64;  // keys per tile; split lengths are multiples
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Byte offset of 16-byte chunk c of row r in a tile whose rows hold D bf16:
// the chunks of a row are XOR-ed by (r % 8), so the 8 rows an ldmatrix
// reads at one chunk column fall in 8 distinct bank groups.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * (D * 2) + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until cp_wait; `ok` false writes
// 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory, lane l addressing row l % 8
// of matrix l / 8; .trans hands each thread a column pair instead of a row
// pair.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (16 x 8 f32) += a (16 x 16 bf16, row-major) . b (16 x 8 bf16, col-major).
// Fragments (g = lane / 4, t = lane % 4): d[0..1] row g, columns 2t, 2t+1;
// d[2..3] row g + 8; a[0] row g, k 2t..2t+1; a[1] row g + 8; a[2], a[3]
// the same at k + 8; b[0] k 2t..2t+1 of column g, b[1] at k + 8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Shared memory: the Q tile (kWarps * 16 rows), then two stages of a K
// tile and a V tile (kKeys rows each), then (kLocal) each stage's kKeys
// bytes: key loaded (below the split's end and on a block this rank holds).
template <int D, int kWarps, bool kLocal>
constexpr int smem_bytes() {
  return kWarps * 16 * D * 2 + 2 * 2 * kKeys * D * 2 + (kLocal ? 2 * kKeys : 0);
}

// One CTA per (split, Q tile of kWarps * 16 packed rows, b * Hkv) of bf16
// q/k/v through the block table; warp w owns packed rows 16w .. 16w + 15
// of the tile. Writes the split's normalized partial (o, lse) of each row.
template <int D, int kWarps, bool kTree, bool kLocal>
__global__ void __launch_bounds__(kWarps * 32)
decode_tiled_kernel(const Args a, float scale_log2) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kRows = kWarps * 16;
  constexpr int kChunks = D / 8;               // 16-byte chunks of a row
  constexpr int kTile = kKeys * D * 2;         // bytes of a K or V tile
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t q_s = smem_u32(smem);
  const uint32_t kv_s = q_s + kRows * D * 2;   // stage s: K, then V
  uint8_t* ok_s = smem + kRows * D * 2 + 2 * 2 * kTile;

  const __nv_bfloat16* __restrict__ q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* __restrict__ k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* __restrict__ v = static_cast<const __nv_bfloat16*>(a.v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int split = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int bh = blockIdx.z;
  const int BH = gridDim.z;
  const int b = bh / a.Hkv;
  const int h = bh - b * a.Hkv;
  const int R = a.R;
  const int q_off = a.offs[b];
  const int32_t* table = a.table + (size_t)b * a.NB;

  // Keys [j0, j1): the split, culled at the last row's causal frontier
  // (paged: kv_offset 0), so table entries past a slot are never read.
  const int j0 = split * a.split_len;
  const int j1 = min(min(a.Tk, j0 + a.split_len), q_off + a.Tq);

  // The thread's two fragment rows (g and g + 8 of its warp's 16): their
  // positions and (kTree) ancestor words, loaded once.
  int pos[2];
  uint32_t bits[2] = {0u, 0u};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 16 * warp + g + 8 * hh;
    pos[hh] = q_off + r % a.Tq;
    if constexpr (kTree) {
      if (r < R) bits[hh] = static_cast<uint32_t>(a.tree[(size_t)bh * R + r]);
    }
  }

  // Whether key j can be read: below j1 and (kLocal) on a held block.
  auto key_ok = [&](int j) -> bool {
    if (j >= j1) return false;
    if constexpr (kLocal) return table[j / a.blk] >= 0;
    return true;
  };
  // The first tile at or after jt with a key to read (kLocal skips tiles
  // of remote blocks whole; the same answer in every thread).
  auto next_tile = [&](int jt) -> int {
    if constexpr (kLocal) {
      for (; jt < j1; jt += kKeys) {
        bool any = false;
        for (int r = threadIdx.x; r < kKeys; r += kThreads)
          any |= key_ok(jt + r);
        if (__syncthreads_or(any)) break;
      }
    }
    return jt;
  };
  // Stage s <- the K and V rows of keys jt .. jt + kKeys - 1, zeros for a
  // key not read.
  auto load_tile = [&](int jt, int s) {
    const uint32_t ks = kv_s + s * 2 * kTile;
    static_assert(kKeys * kChunks % kThreads == 0, "whole passes");
#pragma unroll
    for (int n = 0; n < kKeys * kChunks / kThreads; ++n) {
      const int i = threadIdx.x + n * kThreads;
      const int r = i / kChunks, c = i - r * kChunks;
      const int j = jt + r;
      bool ok = j < j1;
      int pb = 0;
      if (ok) {
        pb = table[j / a.blk];
        if (kLocal && pb < 0) ok = false;
      }
      const size_t off =
          ok ? (((size_t)pb * a.Hkv + h) * a.blk + j % a.blk) * D + c * 8 : 0;
      cp_async16(ks + swz<D>(r, c), k + off, ok);
      cp_async16(ks + kTile + swz<D>(r, c), v + off, ok);
      if constexpr (kLocal) {
        if (c == 0) ok_s[s * kKeys + r] = ok;
      }
    }
  };

  float m[2] = {ta::kNegInf, ta::kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};                  // this thread's share of l
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  int jt = next_tile(j0);
  if (jt < j1) {
#pragma unroll
    for (int n = 0; n < kRows * kChunks / kThreads; ++n) {
      const int i = threadIdx.x + n * kThreads;
      const int r = i / kChunks, c = i - r * kChunks;
      const bool ok = row0 + r < R;
      cp_async16(q_s + swz<D>(r, c),
                 q + ((size_t)bh * R + (ok ? row0 + r : row0)) * D + c * 8,
                 ok);
    }
    cp_commit();
    load_tile(jt, 0);
    cp_commit();
    cp_wait<1>();  // the Q tile
    __syncthreads();
  }
  uint32_t qa[D / 16][4];  // the warp's Q rows as A fragments
  if (jt < j1) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int mi = lane >> 3;
      ldsm_x4(qa[kk], q_s + swz<D>(16 * warp + (mi & 1) * 8 + (lane & 7),
                                   2 * kk + (mi >> 1)));
    }
  }

  int s = 0;
  while (jt < j1) {
    const int jn = next_tile(jt + kKeys);
    if (jn < j1) load_tile(jn, s ^ 1);
    cp_commit();
    cp_wait<1>();  // tile jt has landed
    __syncthreads();
    const uint32_t ks = kv_s + s * 2 * kTile, vs = ks + kTile;

    // S = Q.K^T over the tile's 64 keys: 8 column tiles of 8 keys.
    float sc[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kKeys / 16; ++np) {
        const int mi = lane >> 3;
        uint32_t kb[4];
        ldsm_x4(kb, ks + swz<D>(16 * np + (mi >> 1) * 8 + (lane & 7),
                                2 * kk + (mi & 1)));
        mma_bf16(sc[2 * np], qa[kk], kb[0], kb[1]);
        mma_bf16(sc[2 * np + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // Masks on the fragments (key 8n + 2t4 + e%2 of the tile, row e/2):
    // keys not read, then the causal or the tree-window rule. A tile below
    // every row's first position with every key read needs none.
    const bool masked = kLocal || jt + kKeys > min(j1, q_off);
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale_log2;
        if (masked) {
          const int r = 8 * n + 2 * t4 + (e & 1);
          const int j = jt + r;
          const int hh = e >> 1;
          bool vis = kLocal ? ok_s[s * kKeys + r] != 0 : j < j1;
          if constexpr (kTree) {
            const int rel = j - q_off;  // rel < Tq <= 32 guards the shift
            vis = vis && (rel < 0 || (rel < a.Tq && ((bits[hh] >> rel) & 1u)));
          } else {
            vis = vis && j <= pos[hh];
          }
          if (!vis) x = ta::kNegInf;
        }
        sc[n][e] = x;
      }
    }

    // Online softmax per row: the row's max over the quad of lanes that
    // share it, p = exp2(s - max); l keeps this thread's partial sum.
    float alpha[2];
    float m_use[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = ta::kNegInf;
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
        mx = fmaxf(mx, fmaxf(sc[n][2 * hh], sc[n][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      m_use[hh] = m_new == ta::kNegInf ? 0.f : m_new;
      alpha[hh] = exp2f(m[hh] - m_use[hh]);  // 0 while nothing was seen
      m[hh] = m_new;
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[n][e] - m_use[e >> 1]);
        l[e >> 1] += p;  // l takes p unrounded; P.V takes it in bf16
        sc[n][e] = p;
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P.V: P from the score fragments as bf16 A operands, V's rows
    // transposed by ldmatrix.
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        const int mi = lane >> 3;
        uint32_t vb[4];
        ldsm_x4_t(vb, vs + swz<D>(16 * kk + (mi & 1) * 8 + (lane & 7),
                                  2 * dp + (mi >> 1)));
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // stage s is free for the tile after next
    s ^= 1;
    jt = jn;
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = row0 + 16 * warp + g + 8 * hh;
    if (r >= R) continue;
    const size_t row = ((size_t)split * BH + bh) * R + r;
    const bool empty = lt <= 0.f;
    const float inv = empty ? 0.f : 1.f / lt;
    float* dst = a.o_part + row * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
    if (t4 == 0)
      a.lse_part[row] = empty ? ta::kNegInf : (m[hh] + log2f(lt)) * kLn2;
  }
}

template <int D, int kWarps, bool kTree, bool kLocal>
cudaError_t launch(const Args& a, int splits, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D, kWarps, kLocal>();
  auto kernel = decode_tiled_kernel<D, kWarps, kTree, kLocal>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int BH = a.B * a.Hkv;
  dim3 grid(splits, (a.R + kWarps * 16 - 1) / (kWarps * 16), BH);
  kernel<<<grid, kWarps * 32, smem, stream>>>(a, a.scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = BH * a.R;
  merge_splits_kernel<__nv_bfloat16, D><<<(rows + 3) / 4, 128, 0, stream>>>(
      a.o_part, a.lse_part, static_cast<__nv_bfloat16*>(a.out), a.lse, splits,
      rows);
  return cudaGetLastError();
}

template <int D, bool kTree, bool kLocal>
cudaError_t by_rows(int rows_per_cta, const Args& a, int splits,
                    cudaStream_t st) {
  if (rows_per_cta == 16) return launch<D, 1, kTree, kLocal>(a, splits, st);
  if (rows_per_cta == 32) return launch<D, 2, kTree, kLocal>(a, splits, st);
  if (rows_per_cta == 64) return launch<D, 4, kTree, kLocal>(a, splits, st);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t by_flags(int rows_per_cta, const Args& a, int splits,
                     cudaStream_t st) {
  if (a.tree != nullptr)
    return by_rows<D, true, false>(rows_per_cta, a, splits, st);
  if (a.local) return by_rows<D, false, true>(rows_per_cta, a, splits, st);
  return by_rows<D, false, false>(rows_per_cta, a, splits, st);
}

}  // namespace tiled

}  // namespace

extern "C" {

// Keys per tile of the multi-row body: its split lengths are multiples.
int flash_decode_tiled_keys() { return tiled::kKeys; }

// B2's multi-row body: bf16 q (BH, R, D), bf16 (N, Hkv, blk, D) pools read
// through table (B, NB) (signed with local_blocks), Tk = NB * blk, causal;
// rows_per_cta 16, 32 or 64 packed rows a CTA; splits partials in o_part
// (splits, BH, R, D) / lse_part, split_len a multiple of
// flash_decode_tiled_keys(); tree (BH, R) ancestor words (Tq <= 32) or
// null, not with local_blocks. Returns the CUDA error of the launches.
int flash_decode_tiled_launch(const void* q, const void* k, const void* v,
                              const void* offs, const void* table,
                              const void* tree, void* o_part, void* lse_part,
                              void* out, void* lse, int D, int rows_per_cta,
                              int B, int Hkv, int R, int Tq, int blk, int NB,
                              int splits, int split_len, int local_blocks,
                              float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split_len % tiled::kKeys || split_len <= 0) return cudaErrorInvalidValue;
  if (tree != nullptr && (local_blocks || Tq > 32))
    return cudaErrorInvalidValue;
  Args a{q, k, v, nullptr, nullptr, nullptr,
         static_cast<const int32_t*>(offs),
         static_cast<const int32_t*>(table),
         static_cast<const int32_t*>(tree), static_cast<float*>(o_part),
         static_cast<float*>(lse_part), out, static_cast<float*>(lse),
         B, Hkv, R, Tq, NB * blk, blk, NB, split_len, 1, local_blocks, scale};
  if (D == 64) return tiled::by_flags<64>(rows_per_cta, a, splits, st);
  if (D == 128) return tiled::by_flags<128>(rows_per_cta, a, splits, st);
  return cudaErrorInvalidValue;
}


// Warps per CTA: the host sizes the grid and the partial buffers from it.
int flash_decode_warps_per_cta() { return kWarps; }

// variant: 0 = f32 q/k/v/out; 1 = bf16 q/k/v/out; 2 = bf16 q, int8 k/v, bf16
// out (the cast route); 3 = int8 q with per-row f32 scales qs (BH, R), int8
// k/v, bf16 out (q8q). paged: 0 = k/v are (B*Hkv, Tk, D); 1 = k/v are
// (N, Hkv, blk, D) pools read through table (B, NB), Tk = NB*blk. ks/vs:
// per-block (N, Hkv) f32 scalars of an int8 pool, or null. rows_per_warp:
// 1 or 8 packed query rows per warp (the Q tile). o_part/lse_part hold
// split_ctas * warps_per_cta partials. local_blocks (paged only): the table
// is signed and a negative entry is a block another rank holds — never
// read, its keys masked. tree: (B*Hkv, R) int32 ancestor bitmasks of the
// packed rows (the tree variant; causal, Tq <= 32, rows_per_warp 8), or
// null. Returns the CUDA error of the launches (0 on success).
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
