// What the two decode bodies share (flash_decode.cu's split body,
// decode_tiled.cuh's multi-row body): the launch arguments and the merge of
// the split partials. Each library includes it once; its kernels have
// internal linkage, so each library carries its own copy.
#pragma once

#include "common.cuh"

namespace {

// Operand variants (the C interfaces' `variant`, ops/cuda_decode.py's).
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

constexpr int kMergeWarps = 8;  // warps of a merge CTA

// A lane's N = 2 or 4 contiguous outputs in one store.
template <int N>
__device__ __forceinline__ void store_line(float* p, const float (&x)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}
template <int N>
__device__ __forceinline__ void store_line(__nv_bfloat16* p,
                                           const float (&x)[N]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  if constexpr (N == 4) {
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = lo;
  }
}

// Merge the S split partials of each output row with the safe-softmax
// monoid (ops/reference.py merge_partials) and emit (out in TO, lse in f32);
// rows no split saw emit (0, -inf), the monoid's identity. `wpr` warps
// share a row (1, 2, 4 or 8; a CTA of 8 warps takes 8 / wpr rows): warp p
// of a row takes the partials of every wpr-th run of 32. Lane i of a warp
// keeps the lse of its run's i-th partial from the pass that finds the
// row's max and turns it into its weight, which the lanes then read by
// shuffle while they load the run's o rows kUnroll at a time, so the loads
// do not wait on one another; the warps of a row add their sums in shared
// memory. kUnroll is 16 where a row has many partials (few rows: latency
// bounds the merge) and 4 where it has at most 16 (many rows: registers,
// and so the warps in flight, bound it; one run, one lse a lane).
template <typename TO, int D, int kUnroll>
__global__ void __launch_bounds__(kMergeWarps * 32)
merge_splits_kernel(const float* __restrict__ o_part,
                    const float* __restrict__ lse_part, TO* __restrict__ out,
                    float* __restrict__ lse, int S, int rows, int wpr) {
  constexpr int N = D / 32;
  __shared__ float red[kMergeWarps][D + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * (kMergeWarps / wpr) + warp / wpr;  // the row
  const int part = warp % wpr;
  const bool live = w < rows;
  // The row's max: the lse of the first kRuns runs loaded at once (the
  // loads issue back to back), any further ones after.
  constexpr int kRuns = kUnroll == 16 ? kMergeWarps : 1;
  float lse_r[kRuns];
#pragma unroll
  for (int i = 0; i < kRuns; ++i) {
    const int s = 32 * i + lane;
    lse_r[i] = live && s < S ? lse_part[(size_t)s * rows + w] : ta::kNegInf;
  }
  float mx = ta::kNegInf;
  float ls_first = ta::kNegInf;  // lse of partial 32 part + lane
#pragma unroll
  for (int i = 0; i < kRuns; ++i) {
    mx = fmaxf(mx, lse_r[i]);
    if (i == part) ls_first = lse_r[i];
  }
  for (int s = 32 * kRuns + lane; live && s < S; s += 32)
    mx = fmaxf(mx, lse_part[(size_t)s * rows + w]);
  mx = ta::warp_max(mx);
  float num[N];
#pragma unroll
  for (int n = 0; n < N; ++n) num[n] = 0.f;
  float den = 0.f;
  if (live && mx != ta::kNegInf) {
    for (int s0 = part * 32; s0 < S; s0 += wpr * 32) {
      const int s = s0 + lane;
      const float ls = s0 == part * 32 ? ls_first
                       : s < S          ? lse_part[(size_t)s * rows + w]
                                        : ta::kNegInf;
      const float wgt = ls == ta::kNegInf ? 0.f : expf(ls - mx);
      den += wgt;
      const int n_run = min(32, S - s0);
      for (int i0 = 0; i0 < n_run; i0 += kUnroll) {
        float o[kUnroll][N];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (i0 + u < n_run) {  // the same in every lane: a predicate
            ta::load_vec<N>(
                o_part + ((size_t)(s0 + i0 + u) * rows + w) * D + lane * N,
                o[u]);
          } else {
#pragma unroll
            for (int n = 0; n < N; ++n) o[u][n] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float wi = __shfl_sync(0xffffffffu, wgt, i0 + u);
#pragma unroll
          for (int n = 0; n < N; ++n)
            num[n] = wi != 0.f ? fmaf(wi, o[u][n], num[n]) : num[n];
        }
      }
    }
  }
  den = ta::warp_sum(den);
  if (wpr > 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) red[warp][lane * N + n] = num[n];
    if (lane == 0) red[warp][D] = den;
    __syncthreads();
    if (part == 0) {
      for (int p = 1; p < wpr; ++p) {
#pragma unroll
        for (int n = 0; n < N; ++n) num[n] += red[warp + p][lane * N + n];
        den += red[warp + p][D];
      }
    }
  }
  if (!live || part != 0) return;
  const bool empty = den <= 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) num[n] = empty ? 0.f : num[n] / den;
  store_line(out + (size_t)w * D + lane * N, num);
  if (lane == 0) lse[w] = empty ? ta::kNegInf : mx + logf(den);
}

// The merge after a body's launch over S partials of every row of `a`: a
// warp for each run of 32 partials of a row, up to 8 (rounded up to a power
// of two).
template <typename TO, int D>
cudaError_t merge_splits(const Args& a, int S, cudaStream_t stream) {
  const int rows = a.B * a.Hkv * a.R;
  const int runs = (S + 31) / 32;
  int wpr = 1;
  while (wpr < runs && wpr < kMergeWarps) wpr *= 2;
  const int per_cta = kMergeWarps / wpr;
  const dim3 grid((rows + per_cta - 1) / per_cta);
  if (S > 16)
    merge_splits_kernel<TO, D, 16><<<grid, kMergeWarps * 32, 0, stream>>>(
        a.o_part, a.lse_part, static_cast<TO*>(a.out), a.lse, S, rows, wpr);
  else
    merge_splits_kernel<TO, D, 4><<<grid, kMergeWarps * 32, 0, stream>>>(
        a.o_part, a.lse_part, static_cast<TO*>(a.out), a.lse, S, rows, wpr);
  return cudaGetLastError();
}

}  // namespace
