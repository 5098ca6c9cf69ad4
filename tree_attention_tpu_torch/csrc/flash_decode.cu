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
// no tree flag. One body serves four operand variants:
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
// as many bytes for int8 K/V as for bf16.
//
// Design (simple first; wgmma/mma.sync, TMA and cp.async are later work):
// - Each KV head's G*Tq query rows are packed (row r = g*Tq + t), exactly the
//   TPU kernel's packing, so a KV head's stream serves its whole GQA group.
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
//   SM; otherwise 8.
// - Splits give the card enough independent warps to cover HBM latency even
//   at B=1 (the reference workload has 16 KV heads for 132 SMs). Each warp
//   writes a normalized partial (o, lse); a second small kernel merges the
//   splits with the safe-softmax monoid (ops/reference.py merge_partials).
// - Causal culling: a warp's key range stops at the last query row's
//   frontier (q_offset + Tq - 1), so a short slot reads only its own blocks
//   and never dereferences table entries past its length.
// - Keys past Tk are never loaded: their V lines (and per-block scalars)
//   stay 0, so a masked p = 0 never meets garbage (0 * NaN).
// - local_blocks (B2 only; the sequence-sharded pool, where each rank holds
//   a slice of the blocks): the table is SIGNED, a negative entry names a
//   block another rank holds. Its keys are treated like keys past Tk — K,
//   V and the per-block scalars are never read at that entry (the TPU
//   kernel clamps its DMA to pool row 0 instead; here nothing needs to
//   stream), and the keys are masked out of the softmax. A chunk of keys
//   that are all remote is skipped whole. A row whose every visible block
//   is remote keeps m = -inf, l = 0 and finalizes to (0, -inf), the merge
//   identity. The split heuristic still sizes splits on NB * blk, the
//   logical length, though a rank holds about 1/W of the blocks: a split
//   over remote blocks only costs its table reads and a (0, -inf) partial.
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

template <typename TQ, typename TKV, int D, bool kPaged, bool kScales, int RW>
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
        const bool vis = ((loaded >> c) & 1u) &&
                         (!a.causal || kv_off + jj <= qpos[r]);
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
          bool kScales, int RW>
cudaError_t launch(const Args& a, int split_ctas, cudaStream_t stream) {
  const int BH = a.B * a.Hkv;
  dim3 grid(split_ctas, (a.R + RW - 1) / RW, BH);
  decode_split_kernel<TQ, TKV, D, kPaged, kScales, RW>
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
  if (rows_per_warp == 1 && D == 64)
    return launch<TQ, TKV, TO, 64, kPaged, kScales, 1>(a, ctas, st);
  if (rows_per_warp == 1 && D == 128)
    return launch<TQ, TKV, TO, 128, kPaged, kScales, 1>(a, ctas, st);
  if (rows_per_warp == 8 && D == 64)
    return launch<TQ, TKV, TO, 64, kPaged, kScales, 8>(a, ctas, st);
  if (rows_per_warp == 8 && D == 128)
    return launch<TQ, TKV, TO, 128, kPaged, kScales, 8>(a, ctas, st);
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

}  // namespace

extern "C" {

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
// read, its keys masked. Returns the CUDA error of the launches (0 on
// success).
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const void* qs, const void* ks, const void* vs,
                        const void* offs, const void* table, void* o_part,
                        void* lse_part, void* out, void* lse, int variant,
                        int D, int paged, int rows_per_warp, int B, int Hkv,
                        int R, int Tq, int Tk, int blk, int NB,
                        int split_ctas, int split_len, int causal,
                        int local_blocks, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((ks == nullptr) != (vs == nullptr)) return cudaErrorInvalidValue;
  if (local_blocks && !paged) return cudaErrorInvalidValue;
  Args a{q, k, v, static_cast<const float*>(qs),
         static_cast<const float*>(ks), static_cast<const float*>(vs),
         static_cast<const int32_t*>(offs),
         static_cast<const int32_t*>(table), static_cast<float*>(o_part),
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
