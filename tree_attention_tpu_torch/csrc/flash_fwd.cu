// Q-tiled flash-attention forward (kernel B3) for Hopper, sm_90a.
//
// Replaces tree_attention_tpu/ops/pallas_attention.py:_flash_fwd_kernel,
// forward only: (out, lse) of causal-with-offsets attention, GQA through the
// KV head index, per-batch (q_offset, kv_offset). Two bodies, chosen by
// dtype alone in flash_fwd_launch:
//
// bf16 (flash_fwd_wgmma_kernel): the tensor cores, as the TPU kernel runs
// both products on the MXU with bf16 operands and f32 accumulation.
// - What bounds it: operations, 4*B*Hq*(visible q.k pairs)*D at 989
//   TFLOP/s (H100 SXM dense bf16) against (q + visible K/V + out) / 3.35
//   TB/s: at the training shape (B2 H16 T4096 causal, D 128) 0.139 ms of
//   products against 0.02 ms of bytes; a 256-row serving chunk against a
//   2k-token view is within a factor of two of its bytes.
// - Design (the CTA skeleton is sm90::QRing, shared with B6): one CTA per
//   (batch*query head, 128-row Q tile), the Q tiles with the most keys
//   launched first under causality. A producer warp (its warpgroup's
//   registers lowered with setmaxnreg) brings the Q tile once and each
//   128-key K/V tile by TMA into a ring of kStages stages that completes
//   on mbarriers; two consumer warpgroups own 64 query rows each. Per
//   tile: S = Q.K^T (wgmma, both operands from shared memory), the online
//   softmax on the accumulator fragment (a row's max and sum combine over
//   the 4 lanes that hold it; exp2 with scale*log2(e) folded in), P
//   rounded to bf16 in registers as the A operand of O += P.V (V's tile
//   as a transposed B). The mask runs only on tiles that need it (the
//   causal diagonal, the ragged Tk tail) and the loop ends at the CTA's
//   causal frontier. Tensor maps are 3-D (D, T, B*H), so rows past
//   Tq/Tk load as zeros and never another head's rows; rows past Tq are
//   never stored.
//
// f32 (flash_fwd_kernel): the f32 CUDA cores, simple first, kept for f32
// inputs because the JAX reference pins f32 products at HIGHEST precision
// and TF32 tensor-core products would change the numbers.
// - Bound as above at the f32 CUDA-core rate (67 TFLOP/s); this body sits
//   far above it.
// - One CTA = kBlockQ query rows of one query head; kWarps warps own
//   kBlockQ/kWarps rows each. The Q tile and each kBlockK-key K/V tile are
//   staged in shared memory as f32 (K rows padded by one float so lanes
//   reading different keys hit different banks) and reused by every row of
//   the tile.
// - Scores: lane l computes keys l and l+32 of the tile for the warp's rows.
//   Online softmax per row with warp reductions; P is rounded to V's dtype
//   and broadcast by shuffles into the P.V product, where lane l owns D/32
//   output dims (f32 accumulation).
// - Causal culling: the KV loop stops at the last row's frontier
//   (q_offset + q_start + kBlockQ - 1); keys past Tk load as 0 and are masked.
// - Rows past Tq compute a throwaway row and are never stored.
#include "common.cuh"
#include "sm90.cuh"

namespace {

// ------------------------------------------------ f32: the CUDA cores --

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

// ---------------------------------------------- bf16: the tensor cores --

namespace tc {

constexpr int kBlockQ = 128;  // two consumer warpgroups x 64 rows
constexpr int kBlockK = 128;
constexpr int kStages = 2;
constexpr int kConsumers = 2;  // warpgroups

// The CTA: the Q tile resident, K/V tiles through the ring.
template <int D>
using Ring = sm90::QRing<kBlockQ, kBlockK, kStages, kConsumers, D,
                         kBlockQ * D * 2>;

template <int D>
__global__ void __launch_bounds__(Ring<D>::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,  // (D,Tq,B*Hq)
                       const __grid_constant__ CUtensorMap tk,  // (D,Tk,B*Hkv)
                       const __grid_constant__ CUtensorMap tv,
                       const int32_t* __restrict__ offs,        // (2, B)
                       __nv_bfloat16* __restrict__ out,         // (B,Hq,Tq,D)
                       float* __restrict__ lse,                 // (B, Hq, Tq)
                       int B, int Hq, int Hkv, int Tq, int Tk, int causal,
                       float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  Ring<D> cta;
  cta.init(smem_raw, offs, B, Hq, Hkv, Tk, causal);

  if (cta.is_producer()) {  // the Q tile at the front of shared memory
    cta.produce(&tk, &tv, [&] {
      sm90::load_tile<kBlockQ, D>(cta.smem, &tq, cta.resident, cta.q0,
                                  cta.bh);
    });
  } else {  // consumers: warpgroup wg owns 64 rows of the Q tile
    sm90::reg_alloc<240>();
    const int lane = threadIdx.x & 31;
    const int row0 = cta.row0();
    const uint32_t q_addr =
        sm90::smem_u32(cta.smem) + 64 * cta.wg() * sm90::kRowBytes;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {ta::kNegInf, ta::kNegInf};  // running max, log2 units
    float l[2] = {0.f, 0.f};                  // this thread's partial sums

    sm90::mbar_wait(cta.resident, 0);
    for (int t = 0; t < cta.n_k; ++t) {
      const uint32_t k_addr = cta.wait_kv(t);
      const uint32_t v_addr = k_addr + Ring<D>::kTile;

      float sc[kBlockK / 2];  // S = Q.K^T
      sm90::wg_fence();
      sm90::gemm_ss<kBlockK, D, kBlockQ>(sc, q_addr, k_addr);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(sc);

      if (cta.needs_mask(t, Tk, causal)) {
#pragma unroll
        for (int i = 0; i < kBlockK / 2; ++i) {
          const int j = t * kBlockK + sm90::frag_col(i, lane);
          const int r = row0 + 8 * ((i >> 1) & 1);
          if (j >= Tk || (causal && cta.kv_off + j > cta.q_off + r))
            sc[i] = ta::kNegInf;
        }
      }
      float mx[2] = {ta::kNegInf, ta::kNegInf};
#pragma unroll
      for (int i = 0; i < kBlockK / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2], m_use[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h] * scale_log2);
        m_use[h] = m_new == ta::kNegInf ? 0.f : m_new;
        alpha[h] = exp2f(m[h] - m_use[h]);  // 0 while nothing was visible
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int i = 0; i < kBlockK / 2; ++i) {
        const int h = (i >> 1) & 1;
        sc[i] = exp2f(fmaf(sc[i], scale_log2, -m_use[h]));
        l[h] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      uint32_t pa[kBlockK / 16][4];
      sm90::acc_to_a<kBlockK>(sc, pa);  // P in V's dtype

      sm90::wg_fence();
      sm90::fence_regs(o);
      sm90::gemm_rs<D, kBlockK>(o, pa, v_addr);  // O += P.V
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(o);
      cta.release_kv(t);
    }

    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const bool empty_row = l[h] <= 0.f;
      inv[h] = empty_row ? 0.f : 1.f / l[h];
      const int r = row0 + 8 * h;
      if (r < Tq && (lane & 3) == 0)
        lse[(size_t)cta.bh * Tq + r] =
            empty_row ? ta::kNegInf : m[h] * 0.69314718055994531f + logf(l[h]);
    }
    sm90::store_rows_bf16<D>(o, out + (size_t)cta.bh * Tq * D, row0, Tq, inv,
                             lane);
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* offs, void* out, void* lse, int B, int Hq,
                         int Hkv, int Tq, int Tk, int causal, float scale,
                         cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = sm90::make_tensor_map(&mq, q, D, Tq, B * Hq, kBlockQ);
  if (!err) err = sm90::make_tensor_map(&mk, k, D, Tk, B * Hkv, kBlockK);
  if (!err) err = sm90::make_tensor_map(&mv, v, D, Tk, B * Hkv, kBlockK);
  if (err) return static_cast<cudaError_t>(err);
  constexpr int smem = Ring<D>::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Tq + kBlockQ - 1) / kBlockQ, B * Hq);
  flash_fwd_wgmma_kernel<D><<<grid, Ring<D>::kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<const int32_t*>(offs),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), B, Hq, Hkv,
      Tq, Tk, causal, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// The (Q, KV) tiles of the body that runs for `dtype` (0 = float32, 1 =
// bfloat16; the wrapper checks them against ops/tuning.py).
int flash_fwd_block_q(int dtype) {
  return dtype == 1 ? tc::kBlockQ : kBlockQ;
}
int flash_fwd_block_k(int dtype) {
  return dtype == 1 ? tc::kBlockK : kBlockK;
}

// dtype: 0 = float32 (the CUDA-core body), 1 = bfloat16 (the tensor-core
// body). Contiguous (B, H, T, D) operands (16-byte aligned for bf16's TMA),
// offs (2, B) int32. Returns the CUDA error of the launch (0 on success).
int flash_fwd_launch(const void* q, const void* k, const void* v,
                     const void* offs, void* out, void* lse, int dtype, int D,
                     int B, int Hq, int Hkv, int Tq, int Tk, int causal,
                     float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64)
    return tc::launch_wgmma<64>(q, k, v, offs, out, lse, B, Hq, Hkv, Tq, Tk,
                                causal, scale, st);
  if (dtype == 1 && D == 128)
    return tc::launch_wgmma<128>(q, k, v, offs, out, lse, B, Hq, Hkv, Tq, Tk,
                                 causal, scale, st);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, offs, out, lse, B, Hq, Hkv, Tq, Tk,
                             causal, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, offs, out, lse, B, Hq, Hkv, Tq, Tk,
                              causal, scale, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
