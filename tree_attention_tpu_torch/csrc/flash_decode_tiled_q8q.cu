// The multi-row body's q8q launches (decode_tiled.cuh), variant 3: int8 q
// codes with per-row f32 scales qs (BH, R) against int8 K/V, bf16 out. B4
// over contiguous K/V (channel scales folded by the wrapper), any
// kv_offset, causal or not, {tree, none}; B5 through a block table, with
// per-block (N, Hkv) scalars ks/vs or without, {tree, none}.
#include "decode_tiled.cuh"

namespace {

template <int D>
cudaError_t by_flags(int variant, int paged, int rows_per_cta, const Args& a,
                     int splits, cudaStream_t st) {
  if (variant != kQ8Q || a.qs == nullptr || a.local)
    return cudaErrorInvalidValue;
  if (a.ks != nullptr)
    return by_layout<D, kCodesScaled, false>(paged, rows_per_cta, a, splits,
                                             st);
  return by_layout<D, kCodes, false>(paged, rows_per_cta, a, splits, st);
}

}  // namespace

DECODE_TILED_ENTRY(flash_decode_tiled_q8q)
