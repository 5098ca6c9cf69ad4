// Q-tiled flash-attention forward (kernel B3) for Hopper, sm_90a.
//
// Replaces tree_attention_tpu/ops/pallas_attention.py:_flash_fwd_kernel,
// forward only: (out, lse) of causal-with-offsets attention, GQA through the
// KV head index, per-batch (q_offset, kv_offset).
//
// What bounds it on the card: the larger of its operations,
// 4*B*Hq*(visible q.k pairs)*D / 989 TFLOP/s (H100 SXM dense bf16 peak), and
// its bytes, (q + visible K/V + out) / 3.35 TB/s. At serving prefill shapes
// (a 256-row chunk per slot against a <=2k-token view) the two are within
// a factor of two; longer contexts make it operations-bound.
//
// Design (simple first; this version uses the f32 CUDA cores, not wgmma, so
// it sits far above that bound — making it fast is later work):
// - One CTA = kBlockQ query rows of one query head; kWarps warps own
//   kBlockQ/kWarps rows each. The Q tile and each kBlockK-key K/V tile are
//   staged in shared memory as f32 (K rows padded by one float so lanes
//   reading different keys hit different banks) and reused by every row of
//   the tile: that reuse is what the Q tiling buys over the decode kernel.
// - Scores: lane l computes keys l and l+32 of the tile for the warp's rows.
//   Online softmax per row with warp reductions; P is rounded to V's dtype
//   and broadcast by shuffles into the P.V product, where lane l owns D/32
//   output dims (f32 accumulation).
// - Causal culling: the KV loop stops at the last row's frontier
//   (q_offset + q_start + kBlockQ - 1); keys past Tk load as 0 and are masked.
// - Rows past Tq compute a throwaway row and are never stored.
#include "common.cuh"

namespace {

constexpr int kBlockQ = 32;
constexpr int kBlockK = 64;
constexpr int kWarps = 8;
constexpr int kRows = kBlockQ / kWarps;  // rows per warp

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockK * (D + 1) + kBlockK * D + kBlockQ * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q,           // (B, Hq, Tq, D)
                 const T* __restrict__ k,           // (B, Hkv, Tk, D)
                 const T* __restrict__ v,
                 const int32_t* __restrict__ offs,  // (2, B)
                 T* __restrict__ out,               // (B, Hq, Tq, D)
                 float* __restrict__ lse,           // (B, Hq, Tq)
                 int B, int Hq, int Hkv, int Tq, int Tk, int causal,
                 float scale) {
  constexpr int N = D / 32;
  extern __shared__ float smem[];
  float* Ks = smem;                       // kBlockK x (D + 1)
  float* Vs = Ks + kBlockK * (D + 1);     // kBlockK x D
  float* Qs = Vs + kBlockK * D;           // kBlockQ x D

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int hq = bh - b * Hq;
  const int hkv = hq / (Hq / Hkv);
  const int q_start = blockIdx.x * kBlockQ;
  const int q_off = offs[b];
  const int kv_off = offs[B + b];

  const T* qb = q + (size_t)bh * Tq * D;
  const T* kb = k + ((size_t)b * Hkv + hkv) * Tk * D;
  const T* vb = v + ((size_t)b * Hkv + hkv) * Tk * D;

  for (int i = tid; i < kBlockQ * D; i += kWarps * 32) {
    const int r = q_start + i / D;
    Qs[i] = r < Tq ? ta::to_f32(qb[(size_t)r * D + i % D]) : 0.f;
  }

  int qpos[kRows];
  float m[kRows], l[kRows], acc[kRows][N];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    qpos[i] = q_off + q_start + warp * kRows + i;
    m[i] = ta::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) acc[i][n] = 0.f;
  }

  int k_end = Tk;
  if (causal) k_end = min(k_end, q_off - kv_off + q_start + kBlockQ);

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    for (int i = tid; i < kBlockK * D; i += kWarps * 32) {
      const int key = i / D;
      const int d = i - key * D;
      const int j = k0 + key;
      const bool ok = j < Tk;
      Ks[key * (D + 1) + d] = ok ? ta::to_f32(kb[(size_t)j * D + d]) : 0.f;
      Vs[i] = ok ? ta::to_f32(vb[(size_t)j * D + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) { s[i][0] = 0.f; s[i][1] = 0.f; }
    const float* k_lo = Ks + lane * (D + 1);
    const float* k_hi = Ks + (lane + 32) * (D + 1);
    const float* q_w = Qs + warp * kRows * D;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float a = k_lo[d];
      const float c = k_hi[d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float qv = q_w[i * D + d];
        s[i][0] = fmaf(qv, a, s[i][0]);
        s[i][1] = fmaf(qv, c, s[i][1]);
      }
    }

    float p[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = k0 + lane + 32 * h;
        const bool vis = j < Tk && (!causal || kv_off + j <= qpos[i]);
        s[i][h] = vis ? s[i][h] * scale : ta::kNegInf;
      }
      const float m_new =
          fmaxf(m[i], ta::warp_max(fmaxf(s[i][0], s[i][1])));
      if (m_new == ta::kNegInf) {  // warp-uniform: nothing visible yet
        p[i][0] = 0.f;
        p[i][1] = 0.f;
        continue;
      }
      const float alpha = m[i] == ta::kNegInf ? 0.f : expf(m[i] - m_new);
      const float p0 = s[i][0] == ta::kNegInf ? 0.f : expf(s[i][0] - m_new);
      const float p1 = s[i][1] == ta::kNegInf ? 0.f : expf(s[i][1] - m_new);
      l[i] = l[i] * alpha + ta::warp_sum(p0 + p1);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < N; ++n) acc[i][n] *= alpha;
      p[i][0] = ta::round_as(p0, v);
      p[i][1] = ta::round_as(p1, v);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll 4
      for (int src = 0; src < 32; ++src) {
        float vv[N];
        ta::load_vec<N>(Vs + (32 * h + src) * D + lane * N, vv);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float pk = __shfl_sync(0xffffffffu, p[i][h], src);
#pragma unroll
          for (int n = 0; n < N; ++n) acc[i][n] = fmaf(pk, vv[n], acc[i][n]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q_start + warp * kRows + i;
    if (r >= Tq) continue;
    const bool empty = l[i] <= 0.f;
    const float inv = empty ? 0.f : 1.f / l[i];
    T* o = out + ((size_t)bh * Tq + r) * D + lane * N;
#pragma unroll
    for (int n = 0; n < N; ++n) ta::store(o + n, acc[i][n] * inv);
    if (lane == 0)
      lse[(size_t)bh * Tq + r] = empty ? ta::kNegInf : m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* offs, void* out, void* lse, int B, int Hq,
                   int Hkv, int Tq, int Tk, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kBlockQ - 1) / kBlockQ, B * Hq);
  flash_fwd_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(offs),
      static_cast<T*>(out), static_cast<float*>(lse), B, Hq, Hkv, Tq, Tk,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* offs, void* out, void* lse, int B, int Hq,
                     int Hkv, int Tq, int Tk, int causal, float scale,
                     cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, offs, out, lse, B, Hq, Hkv, Tq, Tk, causal,
                         scale, stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, offs, out, lse, B, Hq, Hkv, Tq, Tk,
                          causal, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Contiguous (B, H, T, D) operands,
// offs (2, B) int32. Returns the CUDA error of the launch (0 on success).
int flash_fwd_launch(const void* q, const void* k, const void* v,
                     const void* offs, void* out, void* lse, int dtype, int D,
                     int B, int Hq, int Hkv, int Tq, int Tk, int causal,
                     float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, offs, out, lse, B, Hq, Hkv, Tq,
                                   Tk, causal, scale, st);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, offs, out, lse, B, Hq, Hkv, Tq, Tk,
                           causal, scale, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
