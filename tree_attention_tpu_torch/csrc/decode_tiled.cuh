// The multi-row decode body (kernels B1, B2, B4 and B5) for Hopper, sm_90a:
// the launches of ops/cuda_decode.py decode_body's "tiled" rule — more than
// one packed query row per KV head, or a tree mask — of every operand
// variant but f32, on either layout:
//   exact bf16 q/k/v: B1 (contiguous K/V, any kv_offset, causal or not;
//     replaces tree_attention_tpu/ops/pallas_decode.py _flash_decode_kernel)
//     and B2 (KV through a block table, with or without local_blocks;
//     _flash_decode_paged_kernel);
//   the cast route over B1/B2: bf16 q against int8 K/V, with or without
//     per-block (N, Hkv) K/V scalars through the table, with or without
//     local_blocks;
//   q8q: B4 (contiguous; _flash_decode_q8q_kernel) and B5 (through the
//     table; _flash_decode_paged_q8q_kernel), int8 Q codes with one f32
//     scale per packed row against int8 K/V, B5 with or without per-block
//     K/V scalars.
// Each with and without the tree mask (kTree). flash_decode.cu's header has
// the contract (packed rows, masks, local_blocks, the tree window, the
// fold order of the int8 scalars); this file the body that runs it on the
// tensor cores. Each operand variant instantiates it in a library of its
// own (flash_decode_tiled.cu: bf16; flash_decode_tiled_cast.cu;
// flash_decode_tiled_q8q.cu), built in parallel.
//
// What bounds it: the bytes of the visible keys, as for every decode
// launch. A key is read ONCE for up to 64 packed rows, where the split
// body's 8-row warps read it once per 8 rows (R/8 times at R = 64).
//
// One CTA of four warps per (KV split, Q tile of 16, 32 or 64 packed rows,
// b*Hkv). A warp owns 16 packed rows; where the tile has fewer than four
// such row groups, the warps of a group split each K/V tile's keys (16 or
// 32 each) and combine their softmax states once, at the end. (With one
// warp per 16 rows, a Tq-8 verify tick ran CTAs of a single warp, three to
// an SM by shared memory: too few warps to issue the copies, the widening
// and the products, or to cover the latency.) The split's K/V rows go to
// shared memory in 64-key tiles, double-buffered, by 16-byte cp.async with
// the address computed per key (paged: the page from the table; a key not
// to be read is zero-filled and never dereferenced); cp.async rather than
// TMA because that per-key zero fill (a ragged tail, a remote block) and
// any block size come free, where a 4-D tensor map would need both re-done
// in shared memory. Scores S = Q.K^T and O += P.V run on mma.sync
// m16n8k16 bf16 -> f32 (ldmatrix from an XOR-swizzled tile; .trans for V);
// mma.sync rather than wgmma because R is 8-64, below wgmma's 64-row tile
// at Tq 8, and the body is bound by bytes: what matters is that no score
// needs a warp all-reduce (a row's softmax max and sum cross the 4 lanes
// that hold it) and no key is read twice. Masks act on the score fragments
// with each row's position (and tree word) loaded once; a tile below every
// row's window with every key read takes none. P is rounded to bf16 as the
// A operand; l takes it unrounded.
//
// Contiguous layout (kPaged false): key j of head bh at (bh*Tk + j)*D, no
// table (for int8 K/V, D bytes a key: D / 16 16-byte copies); kv_offset a
// runtime value, the key's position kv_off + j; with `causal` the split is
// culled at q_off - kv_off + Tq (a split or a rank's whole shard past the
// frontier writes (0, -inf) partials); without it only the ragged tail is
// masked.
//
// int8 K/V (q8q: B4, B5; the cast route). The int8 tiles land by cp.async
// in a double-buffered staging area, then the CTA widens them into one
// bf16 K and V tile (exact: every code is an integer of magnitude <= 127),
// which the bf16 path's ldmatrix and mma.sync read unchanged. V needs the
// widening in any case (ldmatrix .trans is b16 only), so one widening
// stage serves K and V, for both int8 routes. q8q widens its Q codes once
// into the Q tile, and its scores stay exact: each product is at most
// 127^2 = 16129 and a D-128 sum at most 2,064,512 < 2^24, so every f32
// partial sum is an integer f32 holds exactly, in any order — the split
// body's __dp4a int32 sums, bit for bit, before the scaling. The cast route
// loads its bf16 Q tile as the bf16 path does; each bf16 x code product is
// exact in f32, and only the summation order differs from the split body.
// The scaling keeps the TPU kernels' fold order: s = (q.k) * (qs[row], or
// the softmax scale for the cast route) * ks[block of key] in f32, l over p
// unscaled, bf16(p * vs[block of key]) into P.V. The per-key scalars ride
// the tile: one 4-byte cp.async per key beside its rows (a tile spans
// several blocks when blk < 64; zero for a key not read, and a remote
// block's scalar is never read), read from shared memory per fragment
// column; qs is loaded once per fragment row beside the row's position and
// tree word. The Q fragments are re-read from the Q tile for every K tile
// (ldmatrix) rather than held, which leaves room for the scalars in the
// register budget (so are they wherever a warp takes less than a whole
// tile's keys: a 32-row bf16 CTA spilled with them held).
#pragma once

#include <type_traits>

#include "decode.cuh"

namespace {

constexpr int kKeys = 64;  // keys per tile; split lengths are multiples
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// What the body's Q and K/V tiles hold: bf16; int8 codes (q8q) with or
// without per-block scalars; bf16 Q against int8 K/V (the cast route) with
// or without per-block scalars.
enum Quant {
  kBf16 = 0,
  kCodes = 1,
  kCodesScaled = 2,
  kCastKV = 3,
  kCastKVScaled = 4
};
__host__ __device__ constexpr bool int8_kv(int q) { return q != kBf16; }
__host__ __device__ constexpr bool q_codes(int q) {
  return q == kCodes || q == kCodesScaled;
}
__host__ __device__ constexpr bool scaled(int q) {
  return q == kCodesScaled || q == kCastKVScaled;
}

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

// 16 (or 4) bytes global -> shared, in flight until cp_wait; `ok` false
// writes zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
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

// Two int8 codes (bytes b and b + 1 of w) as a bf16 pair. The code, offset
// by 128 (x = w ^ 0x80808080), goes into the low mantissa bits of
// 2^23 as a float; subtracting 2^23 + 128 leaves the code exactly, and
// bf16 holds every code in [-128, 127] exactly.
__device__ __forceinline__ uint32_t widen2(uint32_t x, int b) {
  const float lo =
      __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 | b)) - 8388736.f;
  const float hi =
      __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 | (b + 1))) -
      8388736.f;
  return pack_bf16(lo, hi);
}

// 16 int8 codes -> 16 bf16 as two 16-byte chunks.
__device__ __forceinline__ void widen16(const uint4& w, uint4& lo, uint4& hi) {
  const uint32_t x0 = w.x ^ 0x80808080u, x1 = w.y ^ 0x80808080u;
  const uint32_t x2 = w.z ^ 0x80808080u, x3 = w.w ^ 0x80808080u;
  lo = make_uint4(widen2(x0, 0), widen2(x0, 2), widen2(x1, 0), widen2(x1, 2));
  hi = make_uint4(widen2(x2, 0), widen2(x2, 2), widen2(x3, 0), widen2(x3, 2));
}

// Shared memory: the Q tile (kRW * 16 rows of bf16), then the K/V area:
//   bf16:      two stages of a K tile and a V tile;
//   int8 K/V:  one bf16 K and V tile (the widened stage), two stages of
//              int8 K and V tiles, and (scaled) two stages of kKeys K and
//              V scalars;
// then (kLocal) each stage's kKeys bytes: key loaded (below the split's end
// and on a block this rank holds). After the last tile the K/V area holds
// the key warps' (o, m, l) while they are combined (kKW > 1).
template <int D, int kQuant>
__host__ __device__ constexpr int kv_area_bytes() {
  constexpr int tile = kKeys * D * 2;
  return !int8_kv(kQuant) ? 2 * 2 * tile
                          : 2 * tile + 2 * 2 * kKeys * D +
                                (scaled(kQuant) ? 2 * 2 * kKeys * 4 : 0);
}
template <int D, int kRW, int kQuant, bool kLocal>
constexpr int smem_bytes() {
  constexpr int kv = kv_area_bytes<D, kQuant>();
  static_assert(4 * 16 * (D + 8) * 4 + 4 * 16 * 2 * 4 <= kv, "combine");
  return kRW * 16 * D * 2 + kv + (kLocal ? 2 * kKeys : 0);
}

// One CTA of 4 warps per (split, Q tile of kRW * 16 packed rows, b * Hkv):
// warp w owns packed rows 16 (w / kKW) .. + 15 of the tile and the
// kKeys / kKW keys at (w % kKW) kKeys / kKW of every K/V tile, with its own
// online softmax over them; the kKW key warps of a row group combine their
// (o, m, l) in shared memory at the end. Writes the split's normalized
// partial (o, lse) of each row. The operands lead the template arguments,
// so a trace tells the kernels apart by name: <0, false, ...> is B1,
// <0, true, ...> B2, <1, false, ...> B4, <1, true, ...> and <2, ...> B5,
// <3, ...> and <4, ...> the cast route (B1 or B2 by the layout flag).
template <int kQuant, bool kPaged, int D, int kRW, bool kTree, bool kLocal>
__global__ void __launch_bounds__(128, 1)
decode_tiled_kernel(const Args a, float scale_log2) {
  constexpr int kWarps = 4;
  constexpr int kThreads = kWarps * 32;
  constexpr int kKW = kWarps / kRW;            // warps along a tile's keys
  constexpr int kNT = kKeys / 8 / kKW;         // a warp's 8-key columns
  constexpr int kRows = kRW * 16;
  constexpr int kChunks = D / 8;               // 16-byte chunks of a bf16 row
  constexpr int kCodeChunks = D / 16;          // ... of an int8 row
  constexpr int kTile = kKeys * D * 2;         // bytes of a bf16 K or V tile
  constexpr int kCodeTile = kKeys * D;         // ... of an int8 one
  constexpr bool kQ8 = int8_kv(kQuant);        // int8 K/V, widened
  constexpr bool kQCodes = q_codes(kQuant);    // int8 Q codes (q8q)
  constexpr bool kScales = scaled(kQuant);
  using TKV = typename std::conditional<kQ8, int8_t, __nv_bfloat16>::type;
  static_assert(kPaged || (!kLocal && !kScales), "contiguous: no table");
  static_assert(!(kQCodes && kLocal), "local_blocks: B2's routes only");
  static_assert(!(kTree && kLocal), "tree: not under local_blocks");
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t q_s = smem_u32(smem);
  // bf16: stage s's K at kv_s + 2 s kTile, its V kTile after. int8: the
  // widened K and V at kv_s, kv_s + kTile; stage s's codes at code_s +
  // 2 s kCodeTile (K, then V); its scalars at sc_s + 2 s kKeys floats.
  const uint32_t kv_s = q_s + kRows * D * 2;
  const uint32_t code_s = kv_s + 2 * kTile;
  const uint32_t sc_s = code_s + 2 * 2 * kCodeTile;
  uint8_t* ok_s = smem + kRows * D * 2 + kv_area_bytes<D, kQuant>();
  const float* sc_f = reinterpret_cast<const float*>(
      smem + kRows * D * 2 + 2 * kTile + 2 * 2 * kCodeTile);

  const TKV* __restrict__ k = static_cast<const TKV*>(a.k);
  const TKV* __restrict__ v = static_cast<const TKV*>(a.v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wr = warp / kKW, wk = warp % kKW;  // row group, key group
  const int g = lane >> 2, t4 = lane & 3;
  const int split = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int bh = blockIdx.z;
  const int BH = gridDim.z;
  const int b = bh / a.Hkv;
  const int h = bh - b * a.Hkv;
  const int R = a.R;
  const int q_off = a.offs[b];
  const int kv_off = a.offs[a.B + b];  // paged: 0
  const int32_t* table = kPaged ? a.table + (size_t)b * a.NB : nullptr;
  // Block of key j and its row in the block: shifts for a power-of-two
  // block size (every serving pool), a division otherwise.
  const int blk_shift = (a.blk & (a.blk - 1)) == 0 ? __ffs(a.blk) - 1 : -1;
  auto blk_of = [&](int j) -> int {
    return blk_shift >= 0 ? j >> blk_shift : j / a.blk;
  };
  auto in_blk = [&](int j) -> int {
    return blk_shift >= 0 ? j & (a.blk - 1) : j % a.blk;
  };

  // Keys [j0, j1): the split, culled at the last row's causal frontier, so
  // table entries past a slot are never read.
  const int j0 = split * a.split_len;
  int j1 = min(a.Tk, j0 + a.split_len);
  if (a.causal) j1 = min(j1, q_off - kv_off + a.Tq);
  // Keys below every row's first position are visible to every row.
  const int open = a.causal ? min(j1, q_off - kv_off) : j1;

  // The thread's two fragment rows (g and g + 8 of its warp's 16): their
  // positions, (kTree) ancestor words and score multipliers (the softmax
  // scale, or q8q the row's Q scale, in log2 units), loaded once.
  int pos[2];
  uint32_t bits[2] = {0u, 0u};
  float qmul[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 16 * wr + g + 8 * hh;
    pos[hh] = q_off + r % a.Tq;
    if constexpr (kTree) {
      if (r < R) bits[hh] = static_cast<uint32_t>(a.tree[(size_t)bh * R + r]);
    }
    if constexpr (kQCodes) {
      qmul[hh] = r < R ? a.qs[(size_t)bh * R + r] * kLog2e : 0.f;
    } else {
      qmul[hh] = scale_log2;
    }
  }

  // Element offset of key j's row (paged: on block pb).
  auto key_row = [&](int j, int pb) -> size_t {
    if constexpr (kPaged) {
      return (((size_t)pb * a.Hkv + h) * a.blk + in_blk(j)) * D;
    } else {
      return ((size_t)bh * a.Tk + j) * D;
    }
  };
  // Key j's pool block (paged; 0 on the contiguous layout) and whether it
  // can be read: below j1 and (kLocal) on a block this rank holds. A key
  // not read names block 0, whose address is never dereferenced.
  auto key_block = [&](int j, bool& ok) -> int {
    ok = j < j1;
    int pb = 0;
    if (kPaged && ok) {
      pb = table[blk_of(j)];
      if (kLocal && pb < 0) ok = false;
    }
    return ok ? pb : 0;
  };
  // The first tile at or after jt with a key to read (kLocal skips tiles
  // of remote blocks whole; the same answer in every thread).
  auto next_tile = [&](int jt) -> int {
    if constexpr (kLocal) {
      for (; jt < j1; jt += kKeys) {
        bool any = false;
        for (int r = threadIdx.x; r < kKeys; r += kThreads) {
          bool ok;
          key_block(jt + r, ok);
          any |= ok;
        }
        if (__syncthreads_or(any)) break;
      }
    }
    return jt;
  };
  // Stage s <- the K and V rows (and scalars) of keys jt .. jt + kKeys - 1,
  // zeros for a key not read.
  auto load_tile = [&](int jt, int s) {
    if constexpr (!kQ8) {
      const uint32_t ks = kv_s + s * 2 * kTile;
      static_assert(kKeys * kChunks % kThreads == 0, "whole passes");
#pragma unroll
      for (int n = 0; n < kKeys * kChunks / kThreads; ++n) {
        const int i = threadIdx.x + n * kThreads;
        const int r = i / kChunks, c = i - r * kChunks;
        const int j = jt + r;
        bool ok;
        const int pb = key_block(j, ok);
        const size_t off = ok ? key_row(j, pb) + c * 8 : 0;
        cp_async16(ks + swz<D>(r, c), k + off, ok);
        cp_async16(ks + kTile + swz<D>(r, c), v + off, ok);
        if constexpr (kLocal) {
          if (c == 0) ok_s[s * kKeys + r] = ok;
        }
      }
    } else {
      const uint32_t cs = code_s + s * 2 * kCodeTile;
      static_assert(kKeys * kCodeChunks % kThreads == 0, "whole passes");
#pragma unroll
      for (int n = 0; n < kKeys * kCodeChunks / kThreads; ++n) {
        const int i = threadIdx.x + n * kThreads;
        const int r = i / kCodeChunks, c = i - r * kCodeChunks;
        const int j = jt + r;
        bool ok;
        const int pb = key_block(j, ok);
        const size_t off = ok ? key_row(j, pb) + c * 16 : 0;
        cp_async16(cs + r * D + c * 16, k + off, ok);
        cp_async16(cs + kCodeTile + r * D + c * 16, v + off, ok);
        if constexpr (kLocal) {
          if (c == 0) ok_s[s * kKeys + r] = ok;
        }
      }
      if constexpr (kScales) {
        const uint32_t ss = sc_s + s * 2 * kKeys * 4;
        for (int r = threadIdx.x; r < kKeys; r += kThreads) {
          bool ok;
          const int pb = key_block(jt + r, ok);
          cp_async4(ss + r * 4, a.ks + pb * a.Hkv + h, ok);
          cp_async4(ss + (kKeys + r) * 4, a.vs + pb * a.Hkv + h, ok);
        }
      }
    }
  };
  // int8 K/V: stage s's K and V codes -> the bf16 K and V tiles.
  auto widen_tile = [&](int s) {
    const uint8_t* cs = smem + (code_s - q_s) + s * 2 * kCodeTile;
#pragma unroll
    for (int n = 0; n < 2 * kKeys * kCodeChunks / kThreads; ++n) {
      const int i = threadIdx.x + n * kThreads;
      const int t = i / (kKeys * kCodeChunks);  // 0: K, 1: V
      const int rc = i - t * kKeys * kCodeChunks;
      const int r = rc / kCodeChunks, c = rc - r * kCodeChunks;
      const uint4 w = *reinterpret_cast<const uint4*>(
          cs + t * kCodeTile + r * D + c * 16);
      uint4 lo, hi;
      widen16(w, lo, hi);
      uint8_t* dst = smem + (kv_s - q_s) + t * kTile;
      *reinterpret_cast<uint4*>(dst + swz<D>(r, 2 * c)) = lo;
      *reinterpret_cast<uint4*>(dst + swz<D>(r, 2 * c + 1)) = hi;
    }
  };

  float m[2] = {ta::kNegInf, ta::kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};                  // this thread's share of l
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  int jt = next_tile(j0);
  if (jt < j1) {
    if constexpr (kQCodes) {
      // The Q codes, widened once into the Q tile.
      const int8_t* q = static_cast<const int8_t*>(a.q);
      for (int i = threadIdx.x; i < kRows * kCodeChunks; i += kThreads) {
        const int r = i / kCodeChunks, c = i - r * kCodeChunks;
        uint4 w = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < R)
          w = *reinterpret_cast<const uint4*>(
              q + ((size_t)bh * R + row0 + r) * D + c * 16);
        uint4 lo, hi;
        widen16(w, lo, hi);
        *reinterpret_cast<uint4*>(smem + swz<D>(r, 2 * c)) = lo;
        *reinterpret_cast<uint4*>(smem + swz<D>(r, 2 * c + 1)) = hi;
      }
    } else {
      const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
      static_assert(kRows * kChunks % kThreads == 0, "whole passes");
#pragma unroll
      for (int n = 0; n < kRows * kChunks / kThreads; ++n) {
        const int i = threadIdx.x + n * kThreads;
        const int r = i / kChunks, c = i - r * kChunks;
        const bool ok = row0 + r < R;
        cp_async16(q_s + swz<D>(r, c),
                   q + ((size_t)bh * R + (ok ? row0 + r : row0)) * D + c * 8,
                   ok);
      }
    }
    cp_commit();
    load_tile(jt, 0);
    cp_commit();
    cp_wait<1>();  // the Q tile
    __syncthreads();
  }
  // The warp's Q rows as A fragments: held for the split where a warp
  // takes a tile's 64 keys (bf16, 64-row tiles), re-read for each tile
  // where it takes fewer keys or where the scalars need the registers.
  auto load_qa = [&](uint32_t (&qa)[4], int kk) {
    const int mi = lane >> 3;
    ldsm_x4(qa, q_s + swz<D>(16 * wr + (mi & 1) * 8 + (lane & 7),
                             2 * kk + (mi >> 1)));
  };
  constexpr bool kHoldQ = !kQ8 && kKW == 1;
  uint32_t qh[kHoldQ ? D / 16 : 1][4];
  if constexpr (kHoldQ) {
    if (jt < j1) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) load_qa(qh[kk], kk);
    }
  }

  int s = 0;
  while (jt < j1) {
    const int jn = next_tile(jt + kKeys);
    if (jn < j1) load_tile(jn, s ^ 1);
    cp_commit();
    cp_wait<1>();  // tile jt has landed
    __syncthreads();
    if constexpr (kQ8) {
      widen_tile(s);
      __syncthreads();
    }
    const uint32_t ks = kQ8 ? kv_s : kv_s + s * 2 * kTile, vs = ks + kTile;
    const float* ksc = sc_f + s * 2 * kKeys;  // kScales: this stage's
    const float* vsc = ksc + kKeys;

    // S = Q.K^T over the warp's keys of the tile: kNT column tiles of 8,
    // the first at key 8 n0.
    const int n0 = wk * kNT;
    float sc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    auto qk = [&](const uint32_t (&qa)[4], int kk) {
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        const int mi = lane >> 3;
        uint32_t kb[4];
        ldsm_x4(kb, ks + swz<D>(8 * n0 + 16 * np + (mi >> 1) * 8 + (lane & 7),
                                2 * kk + (mi & 1)));
        mma_bf16(sc[2 * np], qa, kb[0], kb[1]);
        mma_bf16(sc[2 * np + 1], qa, kb[2], kb[3]);
      }
    };
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if constexpr (kHoldQ) {
        qk(qh[kk], kk);
      } else {
        uint32_t qa[4];
        load_qa(qa, kk);
        qk(qa, kk);
      }
    }

    // Scale and mask the fragments (key 8 (n0 + n) + 2 t4 + e % 2 of the
    // tile, row e / 2): keys not read, then the causal or the tree-window
    // rule. A tile below every row's first position with every key read
    // needs no mask.
    const bool masked = kLocal || jt + kKeys > open;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      float2 kscal = make_float2(1.f, 1.f);
      if constexpr (kScales)
        kscal = *reinterpret_cast<const float2*>(ksc + 8 * (n0 + n) + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * qmul[e >> 1];
        if constexpr (kScales) x *= (e & 1) ? kscal.y : kscal.x;
        if (masked) {
          const int r = 8 * (n0 + n) + 2 * t4 + (e & 1);
          const int j = jt + r;
          const int hh = e >> 1;
          bool vis = kLocal ? ok_s[s * kKeys + r] != 0 : j < j1;
          if constexpr (kTree) {
            // rel < Tq <= 32 guards the shift.
            const int rel = kv_off + j - q_off;
            vis = vis && (rel < 0 || (rel < a.Tq && ((bits[hh] >> rel) & 1u)));
          } else {
            vis = vis && (!a.causal || kv_off + j <= pos[hh]);
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
      for (int n = 0; n < kNT; ++n)
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
    for (int n = 0; n < kNT; ++n) {
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

    // O += P.V over the warp's keys: P from the score fragments as bf16 A
    // operands (q8q with scalars: p times its key's V scalar, then
    // rounded), V's rows transposed by ldmatrix.
#pragma unroll
    for (int kl = 0; kl < kNT / 2; ++kl) {
      const int kk = n0 / 2 + kl;  // 16-key group of the tile
      float2 v0 = make_float2(1.f, 1.f), v1 = v0;
      if constexpr (kScales) {
        v0 = *reinterpret_cast<const float2*>(vsc + 16 * kk + 2 * t4);
        v1 = *reinterpret_cast<const float2*>(vsc + 16 * kk + 8 + 2 * t4);
      }
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kl][0] * v0.x, sc[2 * kl][1] * v0.y),
          pack_bf16(sc[2 * kl][2] * v0.x, sc[2 * kl][3] * v0.y),
          pack_bf16(sc[2 * kl + 1][0] * v1.x, sc[2 * kl + 1][1] * v1.y),
          pack_bf16(sc[2 * kl + 1][2] * v1.x, sc[2 * kl + 1][3] * v1.y)};
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
    __syncthreads();  // stage s (and q8q's widened tiles) free again
    s ^= 1;
    jt = jn;
  }

  float lt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    lt[hh] = l[hh];
    lt[hh] += __shfl_xor_sync(0xffffffffu, lt[hh], 1);
    lt[hh] += __shfl_xor_sync(0xffffffffu, lt[hh], 2);
  }
  if constexpr (kKW > 1) {
    // The key warps of a row group combine their (o, m, l) with the
    // safe-softmax monoid, in the K/V area (every copy into it has landed
    // and every warp is past its last read of it).
    constexpr int kStride = D + 8;  // floats a row: spreads the banks
    float* red_o = reinterpret_cast<float*>(smem + kRows * D * 2);
    float* red_m = red_o + kWarps * 16 * kStride;
    float* red_l = red_m + kWarps * 16;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = warp * 16 + g + 8 * hh;
      if (t4 == 0) {
        red_m[rl] = m[hh];
        red_l[rl] = lt[hh];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(red_o + rl * kStride + 8 * n + 2 * t4) =
            make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
    }
    __syncthreads();
    if (wk != 0) return;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = warp * 16 + g + 8 * hh;  // key warp 0 of the group
      float mx = ta::kNegInf;
#pragma unroll
      for (int w = 0; w < kKW; ++w) mx = fmaxf(mx, red_m[rl + 16 * w]);
      const float mu = mx == ta::kNegInf ? 0.f : mx;
      float ls = 0.f;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) o[n][2 * hh] = o[n][2 * hh + 1] = 0.f;
#pragma unroll
      for (int w = 0; w < kKW; ++w) {
        const int rw = rl + 16 * w;
        const float f = exp2f(red_m[rw] - mu);  // 0 for a warp saw nothing
        ls += red_l[rw] * f;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const float2 x = *reinterpret_cast<const float2*>(
              red_o + rw * kStride + 8 * n + 2 * t4);
          o[n][2 * hh] = fmaf(f, x.x, o[n][2 * hh]);
          o[n][2 * hh + 1] = fmaf(f, x.y, o[n][2 * hh + 1]);
        }
      }
      m[hh] = mx;
      lt[hh] = ls;
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 16 * wr + g + 8 * hh;
    if (r >= R) continue;
    const size_t row = ((size_t)split * BH + bh) * R + r;
    const bool empty = lt[hh] <= 0.f;
    const float inv = empty ? 0.f : 1.f / lt[hh];
    float* dst = a.o_part + row * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
    if (t4 == 0)
      a.lse_part[row] = empty ? ta::kNegInf : (m[hh] + log2f(lt[hh])) * kLn2;
  }
}

template <int D, int kRW, bool kPaged, int kQuant, bool kTree, bool kLocal>
cudaError_t launch(const Args& a, int splits, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D, kRW, kQuant, kLocal>();
  auto kernel = decode_tiled_kernel<kQuant, kPaged, D, kRW, kTree, kLocal>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int BH = a.B * a.Hkv;
  dim3 grid(splits, (a.R + kRW * 16 - 1) / (kRW * 16), BH);
  kernel<<<grid, 128, smem, stream>>>(a, a.scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return merge_splits<__nv_bfloat16, D>(a, splits, stream);
}

// rows_per_cta 16, 32 or 64: 1, 2 or 4 row groups of 16, the CTA's four
// warps split over the row groups and the keys of each tile.
template <int D, bool kPaged, int kQuant, bool kTree, bool kLocal>
cudaError_t by_rows(int rows_per_cta, const Args& a, int splits,
                    cudaStream_t st) {
  if (rows_per_cta == 16)
    return launch<D, 1, kPaged, kQuant, kTree, kLocal>(a, splits, st);
  if (rows_per_cta == 32)
    return launch<D, 2, kPaged, kQuant, kTree, kLocal>(a, splits, st);
  if (rows_per_cta == 64)
    return launch<D, 4, kPaged, kQuant, kTree, kLocal>(a, splits, st);
  return cudaErrorInvalidValue;
}

// A layout's launches of one operand kind: contiguous {tree, none} (not
// with per-block scalars, which need the table); paged {tree, local_blocks
// (kLocalOk), none}.
template <int D, int kQuant, bool kLocalOk>
cudaError_t by_layout(int paged, int rows_per_cta, const Args& a, int splits,
                      cudaStream_t st) {
  const bool tree = a.tree != nullptr;
  if (!paged) {
    if constexpr (scaled(kQuant)) {
      return cudaErrorInvalidValue;
    } else {
      return tree ? by_rows<D, false, kQuant, true, false>(rows_per_cta, a,
                                                           splits, st)
                  : by_rows<D, false, kQuant, false, false>(rows_per_cta, a,
                                                            splits, st);
    }
  }
  if (tree)
    return by_rows<D, true, kQuant, true, false>(rows_per_cta, a, splits, st);
  if constexpr (kLocalOk) {
    if (a.local)
      return by_rows<D, true, kQuant, false, true>(rows_per_cta, a, splits,
                                                   st);
  }
  return by_rows<D, true, kQuant, false, false>(rows_per_cta, a, splits, st);
}

using ByFlags = cudaError_t (*)(int variant, int paged, int rows_per_cta,
                                const Args& a, int splits, cudaStream_t st);

// The C entry of each library (flash_decode_launch's arguments): the
// checks every variant shares, then the library's by_flags at D 64 or 128.
// rows_per_cta 16, 32 or 64 packed rows a CTA; splits partials in o_part
// (splits, BH, R, D) / lse_part, split_len a multiple of kKeys;
// local_blocks (paged only): a signed table; tree (BH, R) ancestor words
// (causal, Tq <= 32) or null, not with local_blocks; ks/vs per-block
// (N, Hkv) scalars (paged int8 only) or null. Returns the CUDA error of
// the launches.
inline int tiled_entry(ByFlags f64, ByFlags f128, const void* q,
                       const void* k, const void* v, const void* qs,
                       const void* ks, const void* vs, const void* offs,
                       const void* table, const void* tree, void* o_part,
                       void* lse_part, void* out, void* lse, int variant,
                       int D, int paged, int rows_per_cta, int B, int Hkv,
                       int R, int Tq, int Tk, int blk, int NB, int splits,
                       int split_len, int causal, int local_blocks,
                       float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split_len % kKeys || split_len <= 0) return cudaErrorInvalidValue;
  if ((ks == nullptr) != (vs == nullptr)) return cudaErrorInvalidValue;
  if (ks != nullptr && !paged) return cudaErrorInvalidValue;
  if (tree != nullptr && (local_blocks || !causal || Tq > 32))
    return cudaErrorInvalidValue;
  if (paged && !causal) return cudaErrorInvalidValue;
  if (local_blocks && !paged) return cudaErrorInvalidValue;
  Args a{q, k, v, static_cast<const float*>(qs),
         static_cast<const float*>(ks), static_cast<const float*>(vs),
         static_cast<const int32_t*>(offs),
         static_cast<const int32_t*>(table),
         static_cast<const int32_t*>(tree), static_cast<float*>(o_part),
         static_cast<float*>(lse_part), out, static_cast<float*>(lse),
         B, Hkv, R, Tq, Tk, blk, NB, split_len, causal, local_blocks, scale};
  if (D == 64) return f64(variant, paged, rows_per_cta, a, splits, st);
  if (D == 128) return f128(variant, paged, rows_per_cta, a, splits, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// One library's C interface: NAME_keys() (keys per tile: split lengths are
// multiples) and NAME_launch(...) with flash_decode_launch's arguments,
// over the library's by_flags<D>.
#define DECODE_TILED_ENTRY(NAME)                                              \
  extern "C" int NAME##_keys() { return kKeys; }                              \
  extern "C" int NAME##_launch(                                               \
      const void* q, const void* k, const void* v, const void* qs,           \
      const void* ks, const void* vs, const void* offs, const void* table,   \
      const void* tree, void* o_part, void* lse_part, void* out, void* lse,  \
      int variant, int D, int paged, int rows_per_cta, int B, int Hkv,       \
      int R, int Tq, int Tk, int blk, int NB, int splits, int split_len,     \
      int causal, int local_blocks, float scale, void* stream) {             \
    return tiled_entry(by_flags<64>, by_flags<128>, q, k, v, qs, ks, vs,     \
                       offs, table, tree, o_part, lse_part, out, lse,        \
                       variant, D, paged, rows_per_cta, B, Hkv, R, Tq, Tk,   \
                       blk, NB, splits, split_len, causal, local_blocks,     \
                       scale, stream);                                       \
  }
