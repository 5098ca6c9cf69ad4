// Hopper (sm_90a) tile primitives of the tensor-core attention bodies (B3's,
// B6's and B7's bf16 kernels): the TMA tile load and bulk copy, the host-side
// tensor map, mbarriers, the wgmma shared-memory descriptor of a
// 128-byte-swizzled bf16 tile, the m64nNk16 bf16 x bf16 -> f32 products with
// A from shared memory (SS) or from registers (RS) and their k-loops,
// register rebalancing, the map from an accumulator fragment to its (row,
// column), to a bf16 A operand and to bf16 rows, and the CTA skeleton the
// bodies share (TileRing: barriers, stages, producer and consumer sides),
// turned one way for B3 and B6 (QRing: Q resident, K/V streamed) and the
// other for B7 (KRing: K/V resident, Q and dO streamed).
//
// Layout conventions (PTX ISA, "Asynchronous Warpgroup Level Matrix
// Multiply"): a bf16 tile arrives by TMA as rows of 64 elements (128 bytes,
// one swizzle atom wide), 16-byte chunks XOR-ed by (row % 8), 8-row groups
// 1024 bytes apart; a D = 128 tile is two such boxes, one after the other.
// Every tile starts on a 1024-byte boundary (the descriptor's base offset
// stays 0).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// Elements per swizzle atom row (128 bytes of bf16): the TMA box's inner
// extent, and the head-dim chunk one box holds.
constexpr int kAtom = 64;
constexpr int kRowBytes = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers --

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async (TMA) proxy; follow
// with __syncthreads() before any thread uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ TMA --

// One box of a 3-D tensor map at element coordinates (c0, c1, c2) into
// shared memory; completes `bytes` of `bar`'s expected transaction count.
// Coordinates past the tensor's extent fill with zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------- wgmma --

// Descriptor of a 128-byte-swizzled bf16 operand at shared address `addr`.
// K-major (the reduction dim contiguous, trans 0): sbo = 1024, the 8-row
// group stride; lbo unused (16). MN-major (the output dim contiguous, trans
// 1): sbo = 1024 between 8-row groups along the reduction dim, lbo = the
// stride between 64-column boxes along the output dim.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         1ull << 62;  // layout type 1: 128-byte swizzle
}

// Orders the warpgroup's register and shared-memory writes before the
// wgmma that follows reads them.
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins an accumulator's registers in program order around the asynchronous
// products (the compiler must not move their reads or writes across a
// commit or wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// m64nNk16, f32 += bf16 x bf16: D (64 x N) in N/2 registers a thread.
// SS takes A (K-major) and B (K-major: B^T's rows contiguous, trans 0)
// from shared memory; RS takes A from registers (4 words a thread, the
// layout of acc_to_a) and B MN-major (B's rows contiguous, trans 1).
// accumulate 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma N: 64 or 128");
  if constexpr (N == 64) {
    wgmma_ss_n64(d, da, db, accumulate);
  } else {
    wgmma_ss_n128(d, da, db, accumulate);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma N: 64 or 128");
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db, accumulate);
  } else {
    wgmma_rs_n128(d, a, db, accumulate);
  }
}

// D = A.B^T over K, started (not waited for): A the warpgroup's 64 rows at
// shared address `a` inside a tile of kRowsA rows, B's N rows at `b`; both
// stored as TMA boxes of 64 columns (K/64 boxes, each box's rows 128
// bytes apart).
template <int N, int K, int kRowsA>
__device__ __forceinline__ void gemm_ss(float (&d)[N / 2], uint32_t a,
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;  // 16 bf16 per k-step
    wgmma_ss<N>(d,
                desc_sw128(a + (kk / 4) * kRowsA * kRowBytes + col, 16, 1024),
                desc_sw128(b + (kk / 4) * N * kRowBytes + col, 16, 1024),
                kk > 0);
  }
}

// D += A.B over K, started: A in registers (acc_to_a of a 64 x K
// accumulator), B's K rows at shared address `b`, N columns stored as TMA
// boxes of 64 (the second box K rows after the first).
template <int N, int K>
__device__ __forceinline__ void gemm_rs(float (&d)[N / 2],
                                        const uint32_t (&a)[K / 16][4],
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<N>(d, a[kk], desc_sw128(b + kk * 16 * kRowBytes, K * kRowBytes,
                                     1024), 1);
}

// ------------------------------------------------------------ fragments --

// Accumulator element i of a thread (lane `lane` of warp `w` of its
// warpgroup) sits at row 16*w + lane/4 + 8*((i/2)%2) and column
// 8*(i/4) + 2*(lane%4) + i%2: each row's elements are spread over the 4
// lanes that share lane/4.
__device__ __forceinline__ int frag_row(int i, int warp, int lane) {
  return 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// An f32 accumulator (64 x N) rounded to bf16 as the A operand of N/16
// k16 products: the fragment layouts coincide, so step kk takes elements
// 8kk..8kk+7 in pairs.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&d)[N / 2],
                                         uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1]);
  }
}

// Rows row0 and row0 + 8 of a thread's share of a (64 x N) accumulator,
// times f[0] and f[1], as bf16 into rows of N at `dst`; rows at or past
// n_rows are not stored.
template <int N>
__device__ __forceinline__ void store_rows_bf16(const float (&d)[N / 2],
                                                __nv_bfloat16* dst, int row0,
                                                int n_rows,
                                                const float (&f)[2],
                                                int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= n_rows) continue;
    __nv_bfloat16* p = dst + (size_t)r * N + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) =
          pack_bf16(d[4 * j + 2 * h] * f[h], d[4 * j + 2 * h + 1] * f[h]);
  }
}

// ------------------------------------------------------- the ring CTA --

// A tile of kRows rows (row0..) of head `head` of a (K, T, B*H) map into
// shared memory as K/64 boxes, completing on `bar` (which the caller has
// told the tile's bytes).
template <int kRows, int K>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row0, int head) {
#pragma unroll
  for (int x = 0; x < K / kAtom; ++x)
    tma_load_3d(dst + x * kRows * kRowBytes, map, bar, x * kAtom, row0, head);
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, by the bulk-copy unit; completes `bytes` of `bar`'s
// expected transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

constexpr int round_up_1k(int bytes) { return (bytes + 1023) / 1024 * 1024; }

// What every warp-specialised CTA of the tensor-core bodies shares,
// whichever operand stays put: kResident bytes of resident tiles that
// arrive once by TMA (completing on `resident`), then a ring of kStages
// stages of kStage bytes that one producer thread fills (full[s]) and
// kConsumers warpgroups drain (empty[s]). The producer warpgroup is the
// last one; its first thread issues every copy.
//
// Shared memory, byte offsets from a 1024-byte-aligned base: the resident
// tiles, the stages, then the barriers full[kStages], empty[kStages] and
// the resident tiles' one.
template <int kStages, int kConsumers, int kResident, int kStage>
struct TileRing {
  static_assert(kResident % 1024 == 0 && kStage % 1024 == 0,
                "every tile starts on a 1024-byte boundary");
  static constexpr int kThreads = (kConsumers + 1) * 128;
  static constexpr int kBars = kResident + kStages * kStage;
  static constexpr int kSmemBytes = kBars + (2 * kStages + 1) * 8 + 1024;

  uint8_t* smem;
  uint64_t *full, *empty, *resident;

  // Every thread of the CTA calls it: thread 0 initialises the barriers,
  // and all threads return once they are visible to the TMA unit.
  __device__ __forceinline__ void init_ring(uint8_t* raw) {
    smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    full = reinterpret_cast<uint64_t*>(smem + kBars);
    empty = full + kStages;
    resident = empty + kStages;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kConsumers * 128);
      }
      mbar_init(resident, 1);
      mbar_fence_init();
    }
    __syncthreads();
  }

  __device__ __forceinline__ bool is_producer() const {
    return threadIdx.x / 128 == kConsumers;
  }
  // The producer thread that issues the copies.
  __device__ __forceinline__ bool is_issuer() const {
    return threadIdx.x == kConsumers * 128;
  }
  // A consumer thread's warpgroup.
  __device__ __forceinline__ int wg() const { return threadIdx.x / 128; }

  // Tile t's stage (generic pointer) and its full barrier.
  __device__ __forceinline__ uint8_t* stage(int t) const {
    return smem + kResident + (t % kStages) * kStage;
  }
  __device__ __forceinline__ uint64_t* full_of(int t) const {
    return &full[t % kStages];
  }
  // Producer: waits until tile t's stage is free and announces `bytes` of
  // copies on its full barrier; returns the stage.
  __device__ __forceinline__ uint8_t* acquire(int t, uint32_t bytes) const {
    const int s = t % kStages;
    mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);  // first pass: free
    mbar_expect_tx(&full[s], bytes);
    return stage(t);
  }
  // Consumer: waits for tile t's stage; returns its shared address.
  __device__ __forceinline__ uint32_t wait(int t) const {
    mbar_wait(full_of(t), (t / kStages) & 1);
    return smem_u32(stage(t));
  }
  // This thread is done with tile t's stage.
  __device__ __forceinline__ void release(int t) const {
    mbar_arrive(&empty[t % kStages]);
  }
};

// --------------------------------------------- a Q-stationary ring CTA --

// The skeleton of B3's and B6's bf16 bodies. One CTA per (batch * query
// head, kBlockQ-row Q tile) on a grid of (Q tiles, B * Hq), the Q tiles with
// the most keys first under causality. Its resident row tiles (kResident
// bytes: Q, and dO for B6) arrive once by TMA; the producer streams
// kBlockK-key K/V tiles of D columns through the ring (stage: the K tile,
// then the V tile) up to the Q tile's causal frontier
// (block_utils.last_live_k); kConsumers warpgroups of 64 query rows each
// read them.
template <int kBlockQ, int kBlockK, int kStages, int kConsumers, int D,
          int kResident>
struct QRing
    : TileRing<kStages, kConsumers, kResident, 2 * kBlockK * D * 2> {
  static constexpr int kTile = kBlockK * D * 2;  // one K or V tile

  int bh, kv_head;  // batch * Hq + query head, batch * Hkv + KV head
  int q0, q_off, kv_off;
  int n_k;             // K/V tiles up to the Q tile's causal frontier

  // Every thread of the CTA calls it (TileRing::init_ring).
  __device__ __forceinline__ void init(uint8_t* raw, const int32_t* offs,
                                       int B, int Hq, int Hkv, int Tk,
                                       int causal) {
    const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    bh = blockIdx.y;
    const int b = bh / Hq;
    kv_head = b * Hkv + (bh - b * Hq) / (Hq / Hkv);
    q0 = qt * kBlockQ;
    q_off = offs[b];
    kv_off = offs[B + b];
    int k_end = Tk;  // keys j < k_end can be visible to some row of the tile
    if (causal) k_end = min(k_end, q_off - kv_off + q0 + kBlockQ);
    n_k = k_end > 0 ? (k_end + kBlockK - 1) / kBlockK : 0;
    this->init_ring(raw);
  }

  // The producer warpgroup's part: its registers lowered, one thread
  // announces the resident bytes, starts their loads (`load_resident()`,
  // completing on `resident`) and streams the ring.
  template <class LoadResident>
  __device__ __forceinline__ void produce(const CUtensorMap* tk,
                                          const CUtensorMap* tv,
                                          LoadResident load_resident) {
    reg_dealloc<24>();
    if (this->is_issuer()) {
      mbar_expect_tx(this->resident, kResident);
      load_resident();
      for (int t = 0; t < n_k; ++t) {
        uint8_t* st = this->acquire(t, 2 * kTile);
        load_tile<kBlockK, D>(st, tk, this->full_of(t), t * kBlockK, kv_head);
        load_tile<kBlockK, D>(st + kTile, tv, this->full_of(t), t * kBlockK,
                              kv_head);
      }
    }
  }

  // The first of a consumer thread's two fragment rows (its warpgroup owns
  // rows q0 + 64 wg + [0, 64)); the last key index visible to the
  // warpgroup's first row.
  __device__ __forceinline__ int row0() const {
    return q0 + 64 * this->wg() + frag_row(0, (threadIdx.x >> 5) & 3,
                                           threadIdx.x & 31);
  }
  __device__ __forceinline__ int wg_frontier() const {
    return q_off - kv_off + q0 + 64 * this->wg();
  }
  // Whether tile t holds a key some row of the warpgroup must not see.
  __device__ __forceinline__ bool needs_mask(int t, int Tk, int causal) const {
    const int k_last = (t + 1) * kBlockK - 1;
    return k_last >= Tk || (causal && k_last > wg_frontier());
  }

  // Waits for tile t's stage; returns the shared address of its K tile (V
  // follows kTile bytes after).
  __device__ __forceinline__ uint32_t wait_kv(int t) const {
    return this->wait(t);
  }
  __device__ __forceinline__ void release_kv(int t) const {
    this->release(t);
  }
};

// --------------------------------------------- a K/V-stationary ring CTA --

// The skeleton of B7's bf16 body: the ring turned around. One CTA per
// (kBlockK-key K/V tile, batch * KV head) on a grid of (K/V tiles,
// B * Hkv). Its K and V tiles (D columns; kResident: K, then V) arrive once
// by TMA; the producer streams kBlockQ-row Q and dO tiles through the ring,
// each stage with its rows' lse and delta (kBlockQ f32 each, bulk-copied
// from arrays whose row stride `ld` is a multiple of kBlockQ): for each of
// the G query heads of the KV head's group in turn, the Q tiles from the
// first one that sees the K/V tile's first key under causality
// (block_utils.first_live_q) to the last. kConsumers warpgroups of 64 keys
// each read them.
//
// Stage: the Q tile, the dO tile, then lse and delta (kStats bytes in).
template <int kBlockK, int kBlockQ, int kStages, int kConsumers, int D>
struct KRing
    : TileRing<kStages, kConsumers, 2 * kBlockK * D * 2,
               round_up_1k(2 * kBlockQ * D * 2 + 2 * kBlockQ * 4)> {
  static_assert(kBlockK == 64 * kConsumers, "64 keys per warpgroup");
  static constexpr int kTileKV = kBlockK * D * 2;  // the K or V tile
  static constexpr int kTileQ = kBlockQ * D * 2;   // a Q or dO tile
  static constexpr int kStats = 2 * kTileQ;
  static constexpr int kCopy = 2 * kTileQ + 2 * kBlockQ * 4;  // per stage

  int bkh;       // batch * Hkv + KV head
  int bh0;       // batch * Hq + the group's first query head
  int k0, q_off, kv_off;
  int qt0;       // the first live Q tile
  int n_live;    // Q tiles a query head walks
  int n_tiles;   // the walk: G * n_live tiles

  // Every thread of the CTA calls it (TileRing::init_ring).
  __device__ __forceinline__ void init(uint8_t* raw, const int32_t* offs,
                                       int B, int Hq, int Hkv, int Tq,
                                       int causal) {
    bkh = blockIdx.y;
    const int b = bkh / Hkv;
    const int G = Hq / Hkv;
    bh0 = b * Hq + (bkh - b * Hkv) * G;
    k0 = blockIdx.x * kBlockK;
    q_off = offs[b];
    kv_off = offs[B + b];
    const int n_q = (Tq + kBlockQ - 1) / kBlockQ;
    qt0 = 0;
    if (causal) {  // the tile holding the first row that sees key k0
      const int first = kv_off + k0 - q_off;
      if (first > 0) qt0 = min(first / kBlockQ, n_q);
    }
    n_live = n_q - qt0;
    n_tiles = G * n_live;
    this->init_ring(raw);
  }

  // Tile t of the walk: query head bh(t), rows q0(t) + [0, kBlockQ).
  __device__ __forceinline__ int bh(int t) const { return bh0 + t / n_live; }
  __device__ __forceinline__ int q0(int t) const {
    return (qt0 + t % n_live) * kBlockQ;
  }

  // The producer warpgroup's part: its registers lowered, one thread loads
  // the K and V tiles (completing on `resident`) and streams the walk.
  __device__ __forceinline__ void produce(const CUtensorMap* tk,
                                          const CUtensorMap* tv,
                                          const CUtensorMap* tq,
                                          const CUtensorMap* tdo,
                                          const float* lse,
                                          const float* delta, int ld) {
    reg_dealloc<24>();
    if (this->is_issuer()) {
      mbar_expect_tx(this->resident, 2 * kTileKV);
      load_tile<kBlockK, D>(this->smem, tk, this->resident, k0, bkh);
      load_tile<kBlockK, D>(this->smem + kTileKV, tv, this->resident, k0,
                            bkh);
      for (int t = 0; t < n_tiles; ++t) {
        uint8_t* st = this->acquire(t, kCopy);
        uint64_t* bar = this->full_of(t);
        const int h = bh(t), r0 = q0(t);
        load_tile<kBlockQ, D>(st, tq, bar, r0, h);
        load_tile<kBlockQ, D>(st + kTileQ, tdo, bar, r0, h);
        const size_t row = (size_t)h * ld + r0;
        bulk_load(st + kStats, lse + row, kBlockQ * 4, bar);
        bulk_load(st + kStats + kBlockQ * 4, delta + row, kBlockQ * 4, bar);
      }
    }
  }

  // The first of a consumer thread's two fragment rows, a key index (its
  // warpgroup owns keys k0 + 64 wg + [0, 64)).
  __device__ __forceinline__ int key0() const {
    return k0 + 64 * this->wg() + frag_row(0, (threadIdx.x >> 5) & 3,
                                           threadIdx.x & 31);
  }
  // Whether tile t's Q tile holds a row that must not see some key of the
  // warpgroup (keys past Tk need no mask: their rows of dK and dV are
  // never stored, and nothing else reads them).
  __device__ __forceinline__ bool needs_mask(int t, int causal) const {
    return causal && kv_off + k0 + 64 * this->wg() + 63 > q_off + q0(t);
  }
};

// ------------------------------------------------------------ host side --

// Tensor map of a contiguous bf16 (BH, T, D) array seen as the 3-D tensor
// (D, T, BH), boxes of (64, rows, 1), 128-byte swizzle: rows past T fill
// with zeros and never read the next head's rows. cuTensorMapEncodeTiled
// is looked up at run time (cudaGetDriverEntryPoint), so nothing links
// -lcuda.
// Returns 0, or a cudaError_t.
inline int make_tensor_map(CUtensorMap* map, const void* base, int D, int T,
                           int BH, int rows) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  if (reinterpret_cast<uintptr_t>(base) % 16) return cudaErrorMisalignedAddress;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kAtom, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

}  // namespace sm90
