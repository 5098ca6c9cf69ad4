// The multi-row body's cast-route launches (decode_tiled.cuh), variant 2:
// bf16 q against int8 K/V, bf16 out. B1 over contiguous int8 K/V (channel
// scales folded by the wrapper) {tree, none}; B2 through a block table,
// with per-block (N, Hkv) scalars ks/vs or without, {tree, local_blocks,
// none}: the sharded int8 pool's chunks take B2 local_blocks with scalars.
#include "decode_tiled.cuh"

namespace {

template <int D>
cudaError_t by_flags(int variant, int paged, int rows_per_cta, const Args& a,
                     int splits, cudaStream_t st) {
  if (variant != kCast || a.qs != nullptr) return cudaErrorInvalidValue;
  if (a.ks != nullptr)
    return by_layout<D, kCastKVScaled, true>(paged, rows_per_cta, a, splits,
                                             st);
  return by_layout<D, kCastKV, true>(paged, rows_per_cta, a, splits, st);
}

}  // namespace

DECODE_TILED_ENTRY(flash_decode_tiled_cast)
