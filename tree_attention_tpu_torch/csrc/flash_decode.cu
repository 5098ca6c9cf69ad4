// Split-KV flash decode (kernels B1 and B2) for Hopper, sm_90a.
//
// Replaces tree_attention_tpu/ops/pallas_decode.py:_flash_decode_kernel (B1,
// contiguous KV) and :_flash_decode_paged_kernel (B2, KV read through a
// (B, NB) block table over an (N, Hkv, block, D) pool), exact dtypes, no
// tree/int8/local-block flags.
//
// What bounds it on the card: decode streams every visible KV byte once and
// does ~4 FLOPs per byte per packed query row, so at the serving shapes it
// is bound by HBM bytes: (visible K + V bytes) / 3.35 TB/s.
//
// Design (simple first; wgmma/TMA are later work):
// - Each KV head's G*Tq query rows are packed (row r = g*Tq + t), exactly the
//   TPU kernel's packing, so a KV head's stream serves its whole GQA group.
// - One WARP is one (KV split, Q tile of RW packed rows, b*Hkv) work item
//   with its own online-softmax state in registers. Lane l owns head dims
//   [l*D/32, (l+1)*D/32): a key's K and V rows are read by the warp as one
//   coalesced D-element line straight into registers (no shared memory),
//   held in their storage type until used, a chunk of keys at a time so
//   several lines are in flight. Scores are lane partial dots + a warp
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
// - Keys past Tk are never loaded: their V lines stay 0, so a masked p = 0
//   never meets garbage (0 * NaN).
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

template <typename T, int D, bool kPaged, int RW>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const T* __restrict__ q,            // (BH, R, D)
                    const T* __restrict__ k,            // see header
                    const T* __restrict__ v,
                    const int32_t* __restrict__ offs,   // (2, B)
                    const int32_t* __restrict__ table,  // (B, NB) if paged
                    float* __restrict__ o_part,         // (S, BH, R, D)
                    float* __restrict__ lse_part,       // (S, BH, R)
                    int B, int Hkv, int R, int Tq, int Tk, int blk, int NB,
                    int split_len, int causal, float scale) {
  constexpr int N = D / 32;
  constexpr int kRowsPerWarp = RW;
  constexpr int kKeysPerChunk = RW == 1 ? 16 : 8;
  const int lane = threadIdx.x & 31;
  const int split = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int row0 = blockIdx.y * kRowsPerWarp;
  const int bh = blockIdx.z;
  const int BH = gridDim.z;
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int nrows = min(kRowsPerWarp, R - row0);
  const int q_off = offs[b];
  const int kv_off = offs[B + b];

  const int j0 = split * split_len;
  int j1 = min(Tk, j0 + split_len);
  if (causal) j1 = min(j1, q_off - kv_off + Tq);

  float qr[kRowsPerWarp][N];
  int qpos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][N];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (r < nrows) {
      ta::load_vec<N>(q + ((size_t)bh * R + row0 + r) * D + lane * N, qr[r]);
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) qr[r][n] = 0.f;
    }
    qpos[r] = q_off + (row0 + r) % Tq;
    m[r] = ta::kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) acc[r][n] = 0.f;
  }

  for (int j = j0; j < j1; j += kKeysPerChunk) {
    ta::Line<T, N> kl[kKeysPerChunk], vl[kKeysPerChunk];
#pragma unroll
    for (int c = 0; c < kKeysPerChunk; ++c) {
      const int jj = j + c;
      if (jj < j1) {
        size_t base;
        if constexpr (kPaged) {
          const int pb = table[b * NB + jj / blk];
          base = (((size_t)pb * Hkv + h) * blk + (jj % blk)) * D;
        } else {
          base = ((size_t)bh * Tk + jj) * D;
        }
        kl[c].load(k + base + lane * N);
        vl[c].load(v + base + lane * N);
      } else {
        kl[c].zero();
        vl[c].zero();
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (r >= nrows) continue;
      float s[kKeysPerChunk];
      float mx = ta::kNegInf;
#pragma unroll
      for (int c = 0; c < kKeysPerChunk; ++c) {
        float kf[N];
        kl[c].unpack(kf);
        float part = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) part = fmaf(qr[r][n], kf[n], part);
        part = ta::warp_sum(part);
        const int jj = j + c;
        const bool vis = jj < j1 && (!causal || kv_off + jj <= qpos[r]);
        s[c] = vis ? part * scale : ta::kNegInf;
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
        const float pv = ta::round_as(p, v);
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
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (r >= nrows) continue;
    const size_t row = ((size_t)split * BH + bh) * R + row0 + r;
    const bool empty = l[r] <= 0.f;
    const float inv = empty ? 0.f : 1.f / l[r];
#pragma unroll
    for (int n = 0; n < N; ++n) o_part[row * D + lane * N + n] = acc[r][n] * inv;
    if (lane == 0) lse_part[row] = empty ? ta::kNegInf : m[r] + logf(l[r]);
  }
}

// One warp per (bh, row): merge the S split partials with the safe-softmax
// monoid and emit (out in q's dtype, lse in f32). Rows no split saw emit
// (0, -inf).
template <typename T, int D>
__global__ void __launch_bounds__(128)
merge_splits_kernel(const float* __restrict__ o_part,
                    const float* __restrict__ lse_part, T* __restrict__ out,
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

template <typename T, int D, bool kPaged, int RW>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* offs, const void* table, void* o_part,
                   void* lse_part, void* out, void* lse, int B, int Hkv,
                   int R, int Tq, int Tk, int blk, int NB, int split_ctas,
                   int split_len, int causal, float scale,
                   cudaStream_t stream) {
  const int BH = B * Hkv;
  dim3 grid(split_ctas, (R + RW - 1) / RW, BH);
  decode_split_kernel<T, D, kPaged, RW><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(offs),
      static_cast<const int32_t*>(table), static_cast<float*>(o_part),
      static_cast<float*>(lse_part), B, Hkv, R, Tq, Tk, blk, NB, split_len,
      causal, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = BH * R;
  merge_splits_kernel<T, D><<<(rows + 3) / 4, 128, 0, stream>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(lse_part),
      static_cast<T*>(out), static_cast<float*>(lse), split_ctas * kWarps,
      rows);
  return cudaGetLastError();
}

template <typename T, bool kPaged, int RW>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* offs, const void* table, void* o_part,
                     void* lse_part, void* out, void* lse, int B, int Hkv,
                     int R, int Tq, int Tk, int blk, int NB, int split_ctas,
                     int split_len, int causal, float scale,
                     cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64, kPaged, RW>(q, k, v, offs, table, o_part, lse_part,
                                     out, lse, B, Hkv, R, Tq, Tk, blk, NB,
                                     split_ctas, split_len, causal, scale,
                                     stream);
  if (D == 128)
    return launch<T, 128, kPaged, RW>(q, k, v, offs, table, o_part, lse_part,
                                      out, lse, B, Hkv, R, Tq, Tk, blk, NB,
                                      split_ctas, split_len, causal, scale,
                                      stream);
  return cudaErrorInvalidValue;
}

template <typename T, bool kPaged>
cudaError_t launch_rw(int rows_per_warp, int D, const void* q, const void* k,
                      const void* v, const void* offs, const void* table,
                      void* o_part, void* lse_part, void* out, void* lse,
                      int B, int Hkv, int R, int Tq, int Tk, int blk, int NB,
                      int split_ctas, int split_len, int causal, float scale,
                      cudaStream_t stream) {
  if (rows_per_warp == 1)
    return launch_d<T, kPaged, 1>(D, q, k, v, offs, table, o_part, lse_part,
                                  out, lse, B, Hkv, R, Tq, Tk, blk, NB,
                                  split_ctas, split_len, causal, scale,
                                  stream);
  if (rows_per_warp == 8)
    return launch_d<T, kPaged, 8>(D, q, k, v, offs, table, o_part, lse_part,
                                  out, lse, B, Hkv, R, Tq, Tk, blk, NB,
                                  split_ctas, split_len, causal, scale,
                                  stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Warps per CTA: the host sizes the grid and the partial buffers from it.
int flash_decode_warps_per_cta() { return kWarps; }

// dtype: 0 = float32, 1 = bfloat16. paged: 0 = k/v are (B*Hkv, Tk, D);
// 1 = k/v are (N, Hkv, blk, D) pools read through table (B, NB), Tk = NB*blk.
// rows_per_warp: 1 or 8 packed query rows per warp (the Q tile).
// o_part/lse_part hold split_ctas * warps_per_cta partials. Returns the
// CUDA error of the launches (0 on success).
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const void* offs, const void* table, void* o_part,
                        void* lse_part, void* out, void* lse, int dtype,
                        int D, int paged, int rows_per_warp, int B, int Hkv,
                        int R, int Tq, int Tk, int blk, int NB,
                        int split_ctas, int split_len, int causal,
                        float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return paged ? launch_rw<__nv_bfloat16, true>(
                       rows_per_warp, D, q, k, v, offs, table, o_part,
                       lse_part, out, lse, B, Hkv, R, Tq, Tk, blk, NB,
                       split_ctas, split_len, causal, scale, st)
                 : launch_rw<__nv_bfloat16, false>(
                       rows_per_warp, D, q, k, v, offs, table, o_part,
                       lse_part, out, lse, B, Hkv, R, Tq, Tk, blk, NB,
                       split_ctas, split_len, causal, scale, st);
  }
  if (dtype == 0) {
    return paged ? launch_rw<float, true>(
                       rows_per_warp, D, q, k, v, offs, table, o_part,
                       lse_part, out, lse, B, Hkv, R, Tq, Tk, blk, NB,
                       split_ctas, split_len, causal, scale, st)
                 : launch_rw<float, false>(
                       rows_per_warp, D, q, k, v, offs, table, o_part,
                       lse_part, out, lse, B, Hkv, R, Tq, Tk, blk, NB,
                       split_ctas, split_len, causal, scale, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
