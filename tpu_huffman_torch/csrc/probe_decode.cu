// Ablation probe of the port's decode loops: the two parallel ones and the
// stream walk.
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
// The stream walk (stream_walk.cuh, stream_decode.cu's kernel) has modes of
// its own: `serial` is the one-thread loop of the design before it, kept
// here only as its comparator; `block` is the kernel's design with the LUT
// in shared memory, `block_global` the same with the LUT read through the
// cache, and `none` the block walk without its write pass (info and stats
// only).
//
// Bound: bytes for the stores and the stream's words; the split says how
// much of each loop's time is its stores (byte or sector minus none) and
// how much the lookups, shifts and word loads (none).

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_loop.cuh"
#include "stream_walk.cuh"

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

// The one-thread walk of the design before the block walk: the other
// threads only stage the LUT; the cursor is refilled before every symbol
// so that the stop rules see a full 32-bit window.
__global__ void stream_serial_kernel(
    const unsigned* __restrict__ words, long long n_words, long long start_bit,
    long long total_bits, long long out_capacity,
    const int* __restrict__ l0_g, int root_bits, const int* __restrict__ l1_g,
    long long l1_size, int l1_in_smem, uint8_t* __restrict__ out,
    long long* __restrict__ info) {
  extern __shared__ int smem[];
  const thc::Lut lut =
      thc::stage_lut(smem, l0_g, root_bits, l1_g, l1_size, l1_in_smem);
  if (threadIdx.x != 0) return;

  thc::Cursor cur(words, n_words, start_bit);
  long long n_out = 0;
  long long status = thc::kStreamOk;
  for (;;) {
    const long long left = total_bits - cur.bit();
    if (left <= 0) break;
    cur.refill();
    int sym;
    const int ln = thc::lut_decode<true>(lut, cur.window(), sym);
    if (ln == 0) {
      if (left >= 32) status = thc::kStreamUnknownSymbol;
      break;
    }
    if (ln > left) break;
    if (n_out >= out_capacity) {
      status = thc::kStreamOutputFull;
      break;
    }
    out[n_out++] = (uint8_t)sym;
    cur.advance(ln);
  }
  info[0] = n_out;
  info[1] = cur.bit();
  info[2] = status;
}

template <bool TwoLevel, bool StageLut, bool Write>
__global__ void __launch_bounds__(1024, 1) stream_block_kernel(
    const unsigned* __restrict__ words, long long n_words, long long start_bit,
    long long total_bits, long long out_capacity, const int* __restrict__ l0_g,
    int root_bits, const int* __restrict__ l1_g, long long l1_size, int sub_bits, int overlap,
    int min_len, uint8_t* __restrict__ out, long long* __restrict__ info,
    long long* __restrict__ stats, long long* __restrict__ cycles,
    unsigned long long* __restrict__ branches) {
  extern __shared__ __align__(16) unsigned char walk_smem[];  // not `smem`: another type
  thc::stream_walk<TwoLevel, StageLut, Write>(walk_smem, words, n_words, start_bit, total_bits,
                                               out_capacity, l0_g, root_bits, l1_g, l1_size,
                                               sub_bits, overlap, min_len, out, info, stats,
                                               cycles, branches);
}

// An empty block: the floor a one-block launch cannot beat.
__global__ void empty_kernel() {}

// stream modes: 0 serial, 1 block, 2 block_global, 3 none, 4 empty
template <bool TwoLevel>
auto stream_kernel(int mode) {
  return mode == 1   ? stream_block_kernel<TwoLevel, true, true>
         : mode == 2 ? stream_block_kernel<TwoLevel, false, true>
                     : stream_block_kernel<TwoLevel, true, false>;
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

// thc_stream_decode's arguments before the stream, then cycles (int64[4]
// or null: the block walk's clock cycles by part), branches (int64[4] or
// null: rewalk's branch counters, thc::kRewalks ..., added to) and mode (0
// serial, 1 block, 2 block_global, 3 none, 4 empty). Mode 0 runs one block
// of 128 threads and ignores threads, sub_bits, stats and branches; mode 3
// writes no symbols; mode 4 launches an empty block of `threads` threads
// and writes nothing.
int thc_probe_stream_decode(int device, const void* words, long long n_words,
                            long long start_bit, long long total_bits,
                            long long out_capacity, const void* l0, int root_bits,
                            const void* l1, long long l1_size, int max_len, int min_len,
                            int threads, int sub_bits, int overlap, void* out, void* info,
                            void* stats, void* cycles, void* branches, int mode,
                            void* stream) {
  if (mode < 0 || mode > 4) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (mode == 4) {
    empty_kernel<<<1, threads, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
  }
  if (mode == 0) {
    const thc::LutSmem smem = thc::lut_smem(root_bits, l1_size);
    stream_serial_kernel<<<1, 128, smem.bytes, (cudaStream_t)stream>>>(
        (const unsigned*)words, n_words, start_bit, total_bits, out_capacity,
        (const int*)l0, root_bits, (const int*)l1, l1_size, smem.l1_in_smem,
        (uint8_t*)out, (long long*)info);
    return (int)cudaGetLastError();
  }
  const size_t smem = thc::stream_walk_smem(threads, sub_bits, overlap, min_len, root_bits,
                                            l1_size, mode != 2);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  auto kernel = thc::two_level(root_bits, max_len) ? stream_kernel<true>(mode)
                                                  : stream_kernel<false>(mode);
  if (smem > 48 * 1024) {
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      (const unsigned*)words, n_words, start_bit, total_bits, out_capacity, (const int*)l0,
      root_bits, (const int*)l1, l1_size, sub_bits, overlap, min_len, (uint8_t*)out,
      (long long*)info, (long long*)stats, (long long*)cycles,
      (unsigned long long*)branches);
  return (int)cudaGetLastError();
}

}  // extern "C"
