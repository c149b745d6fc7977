// Ablation probe of the port's two parallel decode loops.
//
// The counterpart of scripts/prof/prof_decode_parts.py, which split B3's
// per-symbol loop on the TPU (its pallas_call at :48 drives
// `_make_pallas_call`). Here the loops split are the port's own:
// thc::chain_lane and thc::segment_lane (decode_loop.cuh), which
// chain_decode_kernel and selfsync_decode_kernel run in kEmitSector mode,
// so the probe's `sector` is the production loop and cannot drift from it.
// Modes (thc::EmitMode): `none` stores only the per-lane results, `byte`
// stores one element a symbol (the design before kEmitSector; the caller
// fills the selfsync rows first), `sector` is the kernels'. The block size
// is an argument, so that the kernels' can be taken from a measurement.
//
// Bound: bytes for the stores and the stream's words; the split says how
// much of each loop's time is its stores (byte or sector minus none) and
// how much the lookups, shifts and word loads (none).

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_loop.cuh"

namespace {

template <int Mode, bool TwoLevel>
__global__ void chain_ablate_kernel(
    const unsigned* __restrict__ words, long long n_words,
    const long long* __restrict__ bit_offs, const int* __restrict__ n_syms,
    const long long* __restrict__ out_start, long long n_blocks,
    const int* __restrict__ l0_g, int root_bits, const int* __restrict__ l1_g,
    long long l1_size, int l1_in_smem, int group, uint8_t* __restrict__ out,
    long long* __restrict__ end_bits, int* __restrict__ bad) {
  extern __shared__ int smem[];
  const thc::Lut lut =
      thc::stage_lut(smem, l0_g, root_bits, l1_g, l1_size, l1_in_smem);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  thc::chain_lane<Mode, TwoLevel>(lut, words, n_words, bit_offs, n_syms, out_start, b,
                                  group, out, end_bits, bad);
}

template <int Mode, bool Starts, bool TwoLevel>
__global__ void segment_ablate_kernel(
    const unsigned* __restrict__ words, long long n_words,
    const int* __restrict__ entries, const int* __restrict__ seg_ids,
    long long n_lanes, int seg_bits, int pitch, int max_codes,
    const int* __restrict__ l0_g, int root_bits, const int* __restrict__ l1_g,
    long long l1_size, int l1_in_smem, int group, uint8_t* __restrict__ syms,
    int16_t* __restrict__ starts, int* __restrict__ counts,
    int* __restrict__ exits, int* __restrict__ bad, int* __restrict__ blast) {
  extern __shared__ int smem[];
  const thc::Lut lut =
      thc::stage_lut(smem, l0_g, root_bits, l1_g, l1_size, l1_in_smem);
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_lanes) return;
  thc::segment_lane<Mode, Starts, TwoLevel>(lut, words, n_words, entries, seg_ids, t,
                                            seg_bits, pitch, max_codes, group, syms, starts,
                                            counts, exits, bad, blast);
}

// The instantiation for (mode, two levels): the production loop's templates
// picked at run time.
template <bool TwoLevel>
auto chain_kernel(int mode) {
  return mode == thc::kEmitNone   ? chain_ablate_kernel<thc::kEmitNone, TwoLevel>
         : mode == thc::kEmitByte ? chain_ablate_kernel<thc::kEmitByte, TwoLevel>
                                  : chain_ablate_kernel<thc::kEmitSector, TwoLevel>;
}

template <bool Starts, bool TwoLevel>
auto segment_kernel(int mode) {
  return mode == thc::kEmitNone   ? segment_ablate_kernel<thc::kEmitNone, Starts, TwoLevel>
         : mode == thc::kEmitByte ? segment_ablate_kernel<thc::kEmitByte, Starts, TwoLevel>
                                  : segment_ablate_kernel<thc::kEmitSector, Starts, TwoLevel>;
}

bool valid(int mode, int block) {
  return mode >= thc::kEmitNone && mode <= thc::kEmitSector && block >= 32 &&
         block <= 1024 && block % 32 == 0;
}

}  // namespace

extern "C" {

// thc_chain_decode's arguments, then mode (thc::EmitMode) and the block
// size; `out` is unused in mode 0.
int thc_probe_chain_decode(int device, const void* words, long long n_words,
                           const void* bit_offs, const void* n_syms,
                           const void* out_start, long long n_blocks,
                           const void* l0, int root_bits, const void* l1,
                           long long l1_size, int max_len, void* out, void* end_bits,
                           void* bad, int mode, int block, void* stream) {
  if (!valid(mode, block)) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const thc::LutSmem smem = thc::lut_smem(root_bits, l1_size);
  const unsigned grid = (unsigned)((n_blocks + block - 1) / block);
  auto kernel = thc::two_level(root_bits, max_len) ? chain_kernel<true>(mode)
                                                    : chain_kernel<false>(mode);
  kernel<<<grid, block, smem.bytes, (cudaStream_t)stream>>>(
      (const unsigned*)words, n_words, (const long long*)bit_offs,
      (const int*)n_syms, (const long long*)out_start, n_blocks,
      (const int*)l0, root_bits, (const int*)l1, l1_size, smem.l1_in_smem,
      thc::refill_group(max_len), (uint8_t*)out, (long long*)end_bits, (int*)bad);
  return (int)cudaGetLastError();
}

// thc_selfsync_decode's arguments, then mode and the block size. In mode 1
// the caller fills syms with 0 and starts with NO_START first; in mode 0
// syms and starts are unused.
int thc_probe_selfsync_decode(int device, const void* words, long long n_words,
                              const void* entries, const void* seg_ids,
                              long long n_lanes, int seg_bits, int pitch,
                              int max_codes, const void* l0, int root_bits,
                              const void* l1, long long l1_size, int max_len, void* syms,
                              void* starts, void* counts, void* exits,
                              void* bad, void* blast, int mode, int block,
                              void* stream) {
  if (!valid(mode, block)) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const thc::LutSmem smem = thc::lut_smem(root_bits, l1_size);
  const unsigned grid = (unsigned)((n_lanes + block - 1) / block);
  const bool two = thc::two_level(root_bits, max_len);
  auto kernel = starts ? (two ? segment_kernel<true, true>(mode)
                              : segment_kernel<true, false>(mode))
                       : (two ? segment_kernel<false, true>(mode)
                              : segment_kernel<false, false>(mode));
  kernel<<<grid, block, smem.bytes, (cudaStream_t)stream>>>(
      (const unsigned*)words, n_words, (const int*)entries,
      (const int*)seg_ids, n_lanes, seg_bits, pitch, max_codes,
      (const int*)l0, root_bits, (const int*)l1, l1_size, smem.l1_in_smem,
      thc::refill_group(max_len), (uint8_t*)syms, (int16_t*)starts, (int*)counts,
      (int*)exits, (int*)bad, (int*)blast);
  return (int)cudaGetLastError();
}

}  // extern "C"
