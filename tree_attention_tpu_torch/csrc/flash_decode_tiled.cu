// The multi-row body's exact bf16 launches (decode_tiled.cuh): B1 on
// contiguous K/V {tree, none}, B2 through a block table {tree,
// local_blocks, none}; variant 1 only (bf16 q/k/v/out), no scalars.
#include "decode_tiled.cuh"

namespace {

template <int D>
cudaError_t by_flags(int variant, int paged, int rows_per_cta, const Args& a,
                     int splits, cudaStream_t st) {
  if (variant != kExactBf16 || a.ks != nullptr || a.qs != nullptr)
    return cudaErrorInvalidValue;
  return by_layout<D, kBf16, true>(paged, rows_per_cta, a, splits, st);
}

}  // namespace

DECODE_TILED_ENTRY(flash_decode_tiled)
