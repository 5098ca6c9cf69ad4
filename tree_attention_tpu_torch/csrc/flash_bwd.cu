// Flash-attention backward for Hopper, sm_90a: kernels B6 (dQ) and B7 (dK/dV).
//
// Replace tree_attention_tpu/ops/pallas_bwd.py:_dq_kernel and :_dkv_kernel.
// Both recompute p = exp(q.k^T * scale - lse) from the forward's saved lse
// (no stored probabilities) and read delta = rowsum(dO * O) - dlse, which the
// wrapper computes (ops/cuda_bwd.py), with the lse of rows that see no key
// remapped from -inf to +inf so that p is exactly 0 there and never NaN.
//   ds = p * (dO.V^T - delta)
//   dq = (ds in K's dtype) . K * scale                       (B6)
//   dk = (ds in Q's dtype)^T . Q * scale,  dv = (p in dO's dtype)^T . dO   (B7)
// Scores and every accumulation in f32; dq, dk, dv stored in their inputs'
// dtypes. Masks as B3's: causal with per-batch (q_offset, kv_offset), keys
// past Tk invisible, query rows past Tq never stored.
//
// What bounds them on the card: operations. With `pairs` the visible
// (query, key) pairs summed over batch and query heads, B6 does 6*pairs*D
// FLOPs (q.k, dO.v, ds.k) and B7 8*pairs*D (q.k, dO.v, p.dO, ds.q), against
// 989 TFLOP/s dense bf16 (H100 SXM); their bytes (each of q, k, v, dO, lse,
// delta read once, the gradients written once) are a few times smaller at
// training shapes (T >= 2k, D = 128).
//
// Design (simple first, like B3: the f32 CUDA cores, not wgmma, so both sit
// far above that bound; making them fast is later work). JAX's split needs
// no atomics, so the gradients are deterministic:
// - B6: one CTA per (b*Hq, kBlockQ query rows). Q, dO, lse and delta stay
//   resident; the CTA loops over kBlockK-key tiles up to its last row's
//   causal frontier (block_utils.last_live_k) and holds dq in f32 registers.
// - B7: one CTA per (b*Hkv, kBlockK keys). K and V stay resident; the CTA
//   loops over the G query heads of its group and, for each, over the Q
//   tiles from the first live one (block_utils.first_live_q); dk and dv
//   accumulate in f32 registers, so the GQA reduction stays in the CTA.
// - Score phase (both): warp w owns kRows query rows of the tile, lane l the
//   keys l and l + 32; the K and V tiles sit in shared memory as f32 with
//   each row's columns XOR-swizzled by (row & 31), so lanes reading different
//   keys at one column, and lanes reading one key at consecutive columns,
//   both hit distinct banks.
// - B6 accumulates dq with lane l owning columns l + 32n and ds broadcast by
//   shuffles (as B3's P.V); B7 writes p and ds to shared memory and switches
//   to warp w owning kKeys keys, lane l columns l + 32n, over the tile's rows.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 64;              // keys per tile
constexpr int kKeys = kBlockK / kWarps;  // B7 accumulation: keys per warp
static_assert(kBlockK == 64, "the score phase gives each lane two keys");
// Query rows per warp in the score phase; the Q tile is kWarps * kRows = 32
// rows. At D = 128 this keeps B6 at 96 KB and B7 at 112 KB of shared
// memory, two CTAs per SM; 64-row tiles (one CTA per SM) were slower for
// both kernels on an H100 (PERF.md).
constexpr int kRows = 4;
constexpr int kBlockQ = kWarps * kRows;

// Element (r, c) of a swizzled f32 tile whose rows hold D columns.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + (c ^ (r & 31));
}

// Load rows [row0, row0 + rows) of a (T, D) matrix into a swizzled f32 tile;
// rows past T load as 0 (a masked p = 0 must never meet garbage).
template <typename T, int D>
__device__ __forceinline__ void load_swizzled(float* dst, const T* src,
                                              int row0, int rows, int n) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int g = row0 + r;
    dst[swz<D>(r, c)] = g < n ? ta::to_f32(src[(size_t)g * D + c]) : 0.f;
  }
}

// The same into a plain row-major f32 tile.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0,
                                          int rows, int n) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int g = row0 + i / D;
    dst[i] = g < n ? ta::to_f32(src[(size_t)g * D + i % D]) : 0.f;
  }
}

// s = q.k^T and dp = dO.v^T for the warp's kRows rows of the (plain) Q and
// dO tiles against keys lane and lane + 32 of the (swizzled) K and V tiles.
template <int D>
__device__ __forceinline__ void score_tile(const float* Qs, const float* Os,
                                           const float* Ks, const float* Vs,
                                           int warp, int lane,
                                           float (&s)[kRows][2],
                                           float (&dp)[kRows][2]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
  }
  const float* q_w = Qs + warp * kRows * D;
  const float* o_w = Os + warp * kRows * D;
  const float* k_lo = Ks + lane * D;
  const float* k_hi = Ks + (lane + 32) * D;
  const float* v_lo = Vs + lane * D;
  const float* v_hi = Vs + (lane + 32) * D;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const int c = d ^ lane;  // swizzled column of both keys of this lane
    const float k0 = k_lo[c], k1 = k_hi[c], v0 = v_lo[c], v1 = v_hi[c];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float qv = q_w[r * D + d];
      const float ov = o_w[r * D + d];
      s[r][0] = fmaf(qv, k0, s[r][0]);
      s[r][1] = fmaf(qv, k1, s[r][1]);
      dp[r][0] = fmaf(ov, v0, dp[r][0]);
      dp[r][1] = fmaf(ov, v1, dp[r][1]);
    }
  }
}

// p and ds of one (row, key) entry; invisible entries give exactly 0.
__device__ __forceinline__ void p_ds(float s, float dp, float lse,
                                     float delta, bool visible, float scale,
                                     float& p, float& ds) {
  p = visible ? expf(s * scale - lse) : 0.f;
  ds = p * (dp - delta);
}

// ---------------------------------------------------------------- B6: dQ --

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q,             // (B, Hq, Tq, D)
                const T* __restrict__ k,             // (B, Hkv, Tk, D)
                const T* __restrict__ v,
                const T* __restrict__ dout,          // (B, Hq, Tq, D)
                const float* __restrict__ lse,       // (B, Hq, Tq), -inf -> +inf
                const float* __restrict__ delta,     // (B, Hq, Tq)
                const int32_t* __restrict__ offs,    // (2, B)
                T* __restrict__ dq,                  // (B, Hq, Tq, D)
                int B, int Hq, int Hkv, int Tq, int Tk, int causal,
                float scale) {
  constexpr int N = D / 32;
  extern __shared__ float smem[];
  float* Qs = smem;                 // kBlockQ x D
  float* Os = Qs + kBlockQ * D;     // kBlockQ x D (dO)
  float* Ks = Os + kBlockQ * D;     // kBlockK x D, swizzled
  float* Vs = Ks + kBlockK * D;     // kBlockK x D, swizzled

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int hkv = (bh - b * Hq) / (Hq / Hkv);
  const int q_start = blockIdx.x * kBlockQ;
  const int q_off = offs[b];
  const int kv_off = offs[B + b];

  const T* qb = q + (size_t)bh * Tq * D;
  const T* ob = dout + (size_t)bh * Tq * D;
  const T* kb = k + ((size_t)b * Hkv + hkv) * Tk * D;
  const T* vb = v + ((size_t)b * Hkv + hkv) * Tk * D;
  load_rows<T, D>(Qs, qb, q_start, kBlockQ, Tq);
  load_rows<T, D>(Os, ob, q_start, kBlockQ, Tq);

  int qpos[kRows];
  float row_lse[kRows], row_delta[kRows], acc[kRows][N];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q_start + warp * kRows + r;
    qpos[r] = q_off + i;
    // Rows past Tq: lse +inf makes p exactly 0 (their Q and dO load as 0).
    row_lse[r] = i < Tq ? lse[(size_t)bh * Tq + i] : INFINITY;
    row_delta[r] = i < Tq ? delta[(size_t)bh * Tq + i] : 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) acc[r][n] = 0.f;
  }

  int k_end = Tk;  // keys past the last row's causal frontier are dead
  if (causal) k_end = min(k_end, q_off - kv_off + q_start + kBlockQ);

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and Qs/Os written)
    load_swizzled<T, D>(Ks, kb, k0, kBlockK, Tk);
    load_swizzled<T, D>(Vs, vb, k0, kBlockK, Tk);
    __syncthreads();

    float s[kRows][2], dp[kRows][2], ds[kRows][2];
    score_tile<D>(Qs, Os, Ks, Vs, warp, lane, s, dp);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = k0 + lane + 32 * h;
        const bool vis = j < Tk && (!causal || kv_off + j <= qpos[r]);
        float p;
        p_ds(s[r][h], dp[r][h], row_lse[r], row_delta[r], vis, scale, p,
             ds[r][h]);
        ds[r][h] = ta::round_as(ds[r][h], k);  // ds in K's dtype
      }
    }
    // dq[r, l + 32n] += sum_key ds[r, key] * K[key, l + 32n]; key's ds lives
    // in lane key % 32, half key / 32.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll 4
      for (int src = 0; src < 32; ++src) {
        const float* krow = Ks + (32 * h + src) * D;
        float kv[N];
#pragma unroll
        for (int n = 0; n < N; ++n) kv[n] = krow[(lane ^ src) + 32 * n];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float dsk = __shfl_sync(0xffffffffu, ds[r][h], src);
#pragma unroll
          for (int n = 0; n < N; ++n) acc[r][n] = fmaf(dsk, kv[n], acc[r][n]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q_start + warp * kRows + r;
    if (i >= Tq) continue;
    T* o = dq + ((size_t)bh * Tq + i) * D;
#pragma unroll
    for (int n = 0; n < N; ++n) ta::store(o + lane + 32 * n, acc[r][n] * scale);
  }
}

// ------------------------------------------------------------- B7: dK/dV --

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q,            // (B, Hq, Tq, D)
                 const T* __restrict__ k,            // (B, Hkv, Tk, D)
                 const T* __restrict__ v,
                 const T* __restrict__ dout,         // (B, Hq, Tq, D)
                 const float* __restrict__ lse,      // (B, Hq, Tq), -inf -> +inf
                 const float* __restrict__ delta,    // (B, Hq, Tq)
                 const int32_t* __restrict__ offs,   // (2, B)
                 T* __restrict__ dk,                 // (B, Hkv, Tk, D)
                 T* __restrict__ dv,
                 int B, int Hq, int Hkv, int Tq, int Tk, int causal,
                 float scale) {
  constexpr int N = D / 32;
  extern __shared__ float smem[];
  float* Ks = smem;                     // kBlockK x D, swizzled
  float* Vs = Ks + kBlockK * D;         // kBlockK x D, swizzled
  float* Qs = Vs + kBlockK * D;         // kBlockQ x D
  float* Os = Qs + kBlockQ * D;         // kBlockQ x D (dO)
  float* Ps = Os + kBlockQ * D;         // kBlockQ x kBlockK, p in dO's dtype
  float* Ss = Ps + kBlockQ * kBlockK;   // kBlockQ x kBlockK, ds in Q's dtype
  float* Ls = Ss + kBlockQ * kBlockK;   // kBlockQ lse
  float* Dl = Ls + kBlockQ;             // kBlockQ delta

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bkh = blockIdx.y;
  const int b = bkh / Hkv;
  const int hkv = bkh - b * Hkv;
  const int G = Hq / Hkv;
  const int k_start = blockIdx.x * kBlockK;
  const int q_off = offs[b];
  const int kv_off = offs[B + b];

  load_swizzled<T, D>(Ks, k + (size_t)bkh * Tk * D, k_start, kBlockK, Tk);
  load_swizzled<T, D>(Vs, v + (size_t)bkh * Tk * D, k_start, kBlockK, Tk);

  float acc_k[kKeys][N], acc_v[kKeys][N];
#pragma unroll
  for (int kk = 0; kk < kKeys; ++kk) {
#pragma unroll
    for (int n = 0; n < N; ++n) acc_k[kk][n] = acc_v[kk][n] = 0.f;
  }

  // First live Q tile: the one holding row kv_off + k_start - q_off, the
  // first row that sees this tile's first key.
  int q_begin = 0;
  if (causal) {
    const int first = kv_off + k_start - q_off;
    if (first > 0) q_begin = first / kBlockQ * kBlockQ;
  }

  for (int g = 0; g < G; ++g) {
    const int bh = b * Hq + hkv * G + g;
    const T* qb = q + (size_t)bh * Tq * D;
    const T* ob = dout + (size_t)bh * Tq * D;
    for (int q0 = q_begin; q0 < Tq; q0 += kBlockQ) {
      __syncthreads();  // the previous tile is consumed (and Ks/Vs written)
      load_rows<T, D>(Qs, qb, q0, kBlockQ, Tq);
      load_rows<T, D>(Os, ob, q0, kBlockQ, Tq);
      if (threadIdx.x < kBlockQ) {
        const int i = q0 + threadIdx.x;
        Ls[threadIdx.x] = i < Tq ? lse[(size_t)bh * Tq + i] : INFINITY;
        Dl[threadIdx.x] = i < Tq ? delta[(size_t)bh * Tq + i] : 0.f;
      }
      __syncthreads();

      float s[kRows][2], dp[kRows][2];
      score_tile<D>(Qs, Os, Ks, Vs, warp, lane, s, dp);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = warp * kRows + r;
        const int qpos = q_off + q0 + row;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = lane + 32 * h;
          const int j = k_start + key;
          const bool vis = j < Tk && (!causal || kv_off + j <= qpos);
          float p, ds;
          p_ds(s[r][h], dp[r][h], Ls[row], Dl[row], vis, scale, p, ds);
          Ps[row * kBlockK + key] = ta::round_as(p, dout);  // p in dO's dtype
          Ss[row * kBlockK + key] = ta::round_as(ds, q);    // ds in Q's dtype
        }
      }
      __syncthreads();

      // dv[key, l + 32n] += sum_row p[row, key] * dO[row, l + 32n], and dk
      // likewise from ds and Q, for the warp's kKeys keys.
#pragma unroll 2
      for (int row = 0; row < kBlockQ; ++row) {
        float qv[N], ov[N];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          qv[n] = Qs[row * D + lane + 32 * n];
          ov[n] = Os[row * D + lane + 32 * n];
        }
#pragma unroll
        for (int kk = 0; kk < kKeys; ++kk) {
          const int key = warp * kKeys + kk;
          const float pk = Ps[row * kBlockK + key];
          const float sk = Ss[row * kBlockK + key];
#pragma unroll
          for (int n = 0; n < N; ++n) {
            acc_v[kk][n] = fmaf(pk, ov[n], acc_v[kk][n]);
            acc_k[kk][n] = fmaf(sk, qv[n], acc_k[kk][n]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < kKeys; ++kk) {
    const int j = k_start + warp * kKeys + kk;
    if (j >= Tk) continue;
    T* ko = dk + ((size_t)bkh * Tk + j) * D;
    T* vo = dv + ((size_t)bkh * Tk + j) * D;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      ta::store(ko + lane + 32 * n, acc_k[kk][n] * scale);
      ta::store(vo + lane + 32 * n, acc_v[kk][n]);
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * kBlockQ * D + 2 * kBlockK * D);
}

template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (2 * kBlockK * D + 2 * kBlockQ * D + 2 * kBlockQ * kBlockK +
          2 * kBlockQ);
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* offs, void* dq, int B, int Hq, int Hkv,
                      int Tq, int Tk, int causal, float scale,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kBlockQ - 1) / kBlockQ, B * Hq);
  flash_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(offs), static_cast<T*>(dq), B, Hq, Hkv, Tq,
      Tk, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* offs, void* dk, void* dv, int B, int Hq,
                       int Hkv, int Tq, int Tk, int causal, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tk + kBlockK - 1) / kBlockK, B * Hkv);
  flash_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(offs), static_cast<T*>(dk),
      static_cast<T*>(dv), B, Hq, Hkv, Tq, Tk, causal, scale);
  return cudaGetLastError();
}

// The instantiation of `launch` for (dtype, D): 0 = float32, 1 = bfloat16;
// D 64 or 128. Unknown combinations give cudaErrorInvalidValue.
#define TA_DISPATCH(launch, ...)                                           \
  do {                                                                     \
    if (dtype == 1 && D == 64)                                             \
      return launch<__nv_bfloat16, 64>(__VA_ARGS__);                       \
    if (dtype == 1 && D == 128)                                            \
      return launch<__nv_bfloat16, 128>(__VA_ARGS__);                      \
    if (dtype == 0 && D == 64) return launch<float, 64>(__VA_ARGS__);      \
    if (dtype == 0 && D == 128) return launch<float, 128>(__VA_ARGS__);    \
    return cudaErrorInvalidValue;                                          \
  } while (0)

}  // namespace

extern "C" {

// The tiles the kernels were built with (the wrapper checks them against
// ops/tuning.py).
int flash_bwd_block_q() { return kBlockQ; }
int flash_bwd_block_k() { return kBlockK; }

// Contiguous (B, H, T, D) operands, lse and delta (B, Hq, Tq) f32, offs
// (2, B) int32. Each returns the CUDA error of its launch (0 on success).
int flash_dq_launch(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    const void* offs, void* dq, int dtype, int D, int B,
                    int Hq, int Hkv, int Tq, int Tk, int causal, float scale,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TA_DISPATCH(launch_dq, q, k, v, dout, lse, delta, offs, dq, B, Hq, Hkv, Tq,
              Tk, causal, scale, st);
}

int flash_dkv_launch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* offs, void* dk, void* dv, int dtype, int D,
                     int B, int Hq, int Hkv, int Tq, int Tk, int causal,
                     float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TA_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, offs, dk, dv, B, Hq,
              Hkv, Tq, Tk, causal, scale, st);
}

}  // extern "C"
