// Ablation probe of the port's pack loops.
//
// Replaces scripts/prof/prof_pack_ablate.py:make_call (the Pallas kernel
// of :187), which ablated B1's per-symbol loop on the TPU. Here the loops
// ablated are the port's own (csrc/pack.cuh), so they cannot drift from
// the kernels:
//   nop, extract, lut, lut4: thc::pack_chunk with parts removed, one thread
//     a chunk of `chunk` symbols, 256 threads a block; each writes (sum,
//     xor) per chunk;
//   thread: thc::pack_chunk<kPackThread>, the earlier whole per-thread loop
//     (chunk offsets, edge words ORed with global atomics into words the
//     caller zeroed), at any chunk: the design the tile loop replaced;
//   full: thc::pack_tile, encode_pack_kernel's tile loop, at its launch
//     shape (one block a 4096-symbol tile), writing every word.
// The 256 (pattern, length) pairs sit in shared memory.
//
// Bound: bytes (the symbols read once, the words written once). The modes
// split where the per-thread loop's time goes: the chunk-strided byte reads
// (extract), the shared-memory lookups and their dependent adds (lut, lut4
// with four chains), the bit accumulator and the word stores (thread).

#include <cstdint>
#include <cuda_runtime.h>

#include "pack.cuh"

namespace {

using thc::kTileThreads;
using thc::kTileWarps;
using thc::kTileWords;

constexpr int kThreads = 256;

template <int Mode>
__global__ void pack_ablate_kernel(const uint8_t* __restrict__ syms,
                                   long long n, int chunk,
                                   const unsigned* __restrict__ patterns,
                                   const int* __restrict__ lengths,
                                   const long long* __restrict__ chunk_offs,
                                   long long n_chunks, long long total_bits,
                                   unsigned eos_padding,
                                   unsigned* __restrict__ words,
                                   long long n_words, int2* __restrict__ sums) {
  __shared__ unsigned s_pat[256];
  __shared__ int s_len[256];
  if constexpr (Mode >= thc::kPackLut) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) {
      s_pat[i] = patterns[i];
      s_len[i] = lengths[i];
    }
    __syncthreads();
  }
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chunks) return;
  const long long i0 = c * chunk;
  const long long start = Mode == thc::kPackThread ? chunk_offs[c] : 0;
  const thc::PackSums r = thc::pack_chunk<Mode>(
      syms, i0, min(i0 + chunk, n), s_pat, s_len, start, c == n_chunks - 1,
      total_bits, eos_padding, words, n_words);
  if constexpr (Mode != thc::kPackThread) sums[c] = make_int2(r.sum, (int)r.x);
}

// encode_pack_kernel's body, without block offsets; ScanOnly stops after
// the scan and writes each tile's bit total to words[tile].
template <bool ScanOnly>
__global__ void __launch_bounds__(kTileThreads)
    pack_ablate_tile_kernel(const uint8_t* __restrict__ syms, long long n,
                            const unsigned* __restrict__ patterns,
                            const int* __restrict__ lengths,
                            const long long* __restrict__ tile_offs,
                            long long n_tiles, long long total_bits,
                            unsigned eos_padding, unsigned* __restrict__ words,
                            long long n_words) {
  __shared__ unsigned s_pat[256];
  __shared__ int s_len[256];
  __shared__ unsigned s_buf[kTileWords];
  __shared__ int s_warp[kTileWarps];
  thc::pack_tile_setup(patterns, lengths, s_pat, s_len, s_buf);
  const long long tile = blockIdx.x;
  thc::pack_tile<ScanOnly>(syms, n, tile, n_tiles,
                           ((uintptr_t)syms & 15) == 0, s_pat, s_len,
                           ScanOnly ? 0 : tile_offs[tile], total_bits,
                           eos_padding, words, n_words, 0, nullptr, s_buf,
                           s_warp);
}

template <bool ScanOnly>
void launch_tile(const void* syms, long long n, const void* patterns,
                 const void* lengths, const void* tile_offs,
                 long long total_bits, int eos_padding, void* words,
                 long long n_words, cudaStream_t stream) {
  const long long n_tiles = (n + thc::kTile - 1) / thc::kTile;
  pack_ablate_tile_kernel<ScanOnly><<<(unsigned)n_tiles, kTileThreads, 0, stream>>>(
      (const uint8_t*)syms, n, (const unsigned*)patterns, (const int*)lengths,
      (const long long*)tile_offs, n_tiles, total_bits, (unsigned)eos_padding,
      (unsigned*)words, n_words);
}

template <int Mode>
void launch(const void* syms, long long n, int chunk, const void* patterns,
            const void* lengths, const void* chunk_offs, long long total_bits,
            int eos_padding, void* words, long long n_words, void* sums,
            cudaStream_t stream) {
  const long long n_chunks = (n + chunk - 1) / chunk;
  const unsigned grid = (unsigned)((n_chunks + kThreads - 1) / kThreads);
  pack_ablate_kernel<Mode><<<grid, kThreads, 0, stream>>>(
      (const uint8_t*)syms, n, chunk, (const unsigned*)patterns,
      (const int*)lengths, (const long long*)chunk_offs, n_chunks, total_bits,
      (unsigned)eos_padding, (unsigned*)words, n_words, (int2*)sums);
}

}  // namespace

extern "C" {

// mode: 0 nop, 1 extract, 2 lut, 3 lut4, 4 full, 5 thread, 6 tile_scan
// (thc::PackMode). `thread` needs chunk offsets (int64, one a chunk),
// total_bits and zeroed words; `full` ignores `chunk` and takes tile
// offsets (one a 4096-symbol tile) in chunk_offs, and writes every word;
// `tile_scan` writes one int32 a tile into words; the other modes need
// sums (int32[n_chunks][2]).
int thc_probe_pack(int device, const void* syms, long long n, int chunk,
                   const void* patterns, const void* lengths,
                   const void* chunk_offs, long long total_bits,
                   int eos_padding, void* words, long long n_words, void* sums,
                   int mode, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case thc::kPackNop:
      launch<thc::kPackNop>(syms, n, chunk, patterns, lengths, chunk_offs,
                            total_bits, eos_padding, words, n_words, sums, s);
      break;
    case thc::kPackExtract:
      launch<thc::kPackExtract>(syms, n, chunk, patterns, lengths, chunk_offs,
                                total_bits, eos_padding, words, n_words, sums, s);
      break;
    case thc::kPackLut:
      launch<thc::kPackLut>(syms, n, chunk, patterns, lengths, chunk_offs,
                            total_bits, eos_padding, words, n_words, sums, s);
      break;
    case thc::kPackLut4:
      launch<thc::kPackLut4>(syms, n, chunk, patterns, lengths, chunk_offs,
                             total_bits, eos_padding, words, n_words, sums, s);
      break;
    case thc::kPackThread:
      launch<thc::kPackThread>(syms, n, chunk, patterns, lengths, chunk_offs,
                               total_bits, eos_padding, words, n_words, sums, s);
      break;
    case thc::kPackFull:
      launch_tile<false>(syms, n, patterns, lengths, chunk_offs, total_bits,
                         eos_padding, words, n_words, s);
      break;
    case thc::kPackTileScan:
      launch_tile<true>(syms, n, patterns, lengths, chunk_offs, total_bits,
                        eos_padding, words, n_words, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
