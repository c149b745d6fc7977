// Huffman encode for Hopper: a count kernel and a pack kernel.
//
// Replaces the Pallas pack kernel B1, tpu_huffman/ops/pallas_encode.py
// `_make_pack_call`, together with the placement half of its XLA pipeline
// `_encode_pipeline` (offsets, stitch, EOS pad code).
//
// The input is cut into tiles of thc::kTile (4096) consecutive symbols, one
// block of 256 threads each, 16 symbols a thread loaded as one uint4 (the
// loops are in csrc/pack.cuh). The tile does not depend on the index's
// block_symbols: the pack writes the block offsets from its own scan.
//   count: each tile's bit total (int32: at most 4096 x 32 bits); the first
//          unknown symbol's index (atomicMin) and the data's longest code
//          (atomicMax), one atomic each a block at most.
//   (host) the exclusive prefix over tiles is torch.cumsum in int64.
//   pack:  one block a tile: a block-wide scan of the threads' bit totals,
//          the codes ORed MSB-first into a word buffer in shared memory, the
//          tile's last word completed with the next tile's head codes (the
//          EOS pad code after the last tile), and the words the tile owns
//          copied out with consecutive lanes on consecutive words. Every
//          output word is written exactly once by a plain store: the output
//          needs no fill and there is no global atomic. The block offsets
//          of the index (every block_symbols-th symbol's bit) come from the
//          same scan.
// The 256 (pattern, length) pairs sit in shared memory.
//
// Two ways to get the stream's length, in one kernel: by value (the host
// has read it, as encode and encode_with_index do), or from device memory
// (`total_dev`, the inclusive prefix's last element: the fixed-size step
// of best_encode_step, which never synchronises with the host). Either
// way the last tile places the EOS pad at its end, words past the pad up
// to n_words are zeros (written by every block, a grid-stride share
// each), and `padded_out`, where given, gets the padded length.
//
// Bound: bytes. The symbols are read once, each output word and block
// offset written once (the head codes re-read at most 32 bytes a tile).
// The tile base and word indices are int64, so one launch takes a stream
// past 2^31 bits; offsets inside a tile (< 2^17 + 32) are int32.

#include <cstdint>
#include <cuda_runtime.h>

#include "pack.cuh"

namespace {

using thc::kTile;
using thc::kTileThreads;
using thc::kTileWarps;
using thc::kTileWords;

__global__ void __launch_bounds__(kTileThreads)
    encode_count_kernel(const uint8_t* __restrict__ syms, long long n,
                        const int* __restrict__ lengths,
                        int* __restrict__ tile_bits,
                        unsigned long long* __restrict__ stats) {
  __shared__ int s_len[256];
  __shared__ int s_red[3][kTileWarps];
  for (int i = threadIdx.x; i < 256; i += kTileThreads) s_len[i] = lengths[i];
  __syncthreads();
  const long long tile = blockIdx.x;
  const int first = threadIdx.x * thc::kSymsPerThread;  // in the tile
  const thc::Syms16 s = thc::load_syms16(
      syms, tile * kTile + first, n, ((uintptr_t)syms & 15) == 0);
  // The thread's bits, its longest code, and its first unknown symbol's
  // place in the tile (kTile if none); then the warp's, then the block's.
  int bits = 0, max_len = 0, bad = kTile;
#pragma unroll
  for (int j = 0; j < thc::kSymsPerThread; ++j) {
    const int l = j < s.count ? s_len[thc::sym_at(s, j)] : 1;
    bits += j < s.count ? l : 0;
    max_len = max(max_len, j < s.count ? l : 0);
    if (l == 0) bad = min(bad, first + j);
  }
  bits = (int)__reduce_add_sync(0xffffffffu, (unsigned)bits);
  max_len = (int)__reduce_max_sync(0xffffffffu, (unsigned)max_len);
  bad = (int)__reduce_min_sync(0xffffffffu, (unsigned)bad);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_red[0][warp] = bits;
    s_red[1][warp] = max_len;
    s_red[2][warp] = bad;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bits = 0;
    max_len = 0;
    bad = kTile;
#pragma unroll
    for (int k = 0; k < kTileWarps; ++k) {
      bits += s_red[0][k];
      max_len = max(max_len, s_red[1][k]);
      bad = min(bad, s_red[2][k]);
    }
    tile_bits[tile] = bits;
    if (bad < kTile) atomicMin(&stats[0], (unsigned long long)(tile * kTile + bad));
    // Most tiles find the longest code already there: a plain read first.
    const unsigned long long m = (unsigned long long)max_len;
    if (m > *(volatile unsigned long long*)&stats[1]) atomicMax(&stats[1], m);
  }
}

__global__ void __launch_bounds__(kTileThreads)
    encode_pack_kernel(const uint8_t* __restrict__ syms, long long n,
                       const unsigned* __restrict__ patterns,
                       const int* __restrict__ lengths,
                       const long long* __restrict__ tile_offs,
                       long long n_tiles, long long total_bits,
                       unsigned eos_padding, unsigned* __restrict__ words,
                       long long n_words, long long block_symbols,
                       long long* __restrict__ block_offs,
                       const long long* __restrict__ total_dev,
                       long long* __restrict__ padded_out) {
  __shared__ unsigned s_pat[256];
  __shared__ int s_len[256];
  __shared__ unsigned s_buf[kTileWords];
  __shared__ int s_warp[kTileWarps];
  thc::pack_tile_setup(patterns, lengths, s_pat, s_len, s_buf);
  const long long total = total_dev != nullptr ? *total_dev : total_bits;
  const long long padded = total + ((8 - (total & 7)) & 7);
  // The words up to the pad's end go to their tiles; the rest are zeros.
  const long long stream_words = min(n_words, (padded + 31) >> 5);
  for (long long g = stream_words + blockIdx.x * (long long)kTileThreads + threadIdx.x;
       g < n_words; g += (long long)gridDim.x * kTileThreads) {
    words[g] = 0u;
  }
  if (padded_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *padded_out = padded;
  const long long tile = blockIdx.x;
  thc::pack_tile(syms, n, tile, n_tiles, ((uintptr_t)syms & 15) == 0, s_pat,
                 s_len, tile_offs[tile], total, eos_padding, words,
                 stream_words, block_symbols, block_offs, s_buf, s_warp);
}

}  // namespace

extern "C" {

// Every entry point first makes `device` (the tensors' CUDA device) current
// for this thread, then launches on `stream`, PyTorch's current stream there.

// stats[0] must hold n (no unknown symbol) and stats[1] 0 before the call;
// tile_bits holds ceil(n / 4096) ints.
int thc_encode_count(int device, const void* syms, long long n,
                     const void* lengths, void* tile_bits, void* stats,
                     void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const long long n_tiles = (n + kTile - 1) / kTile;
  encode_count_kernel<<<(unsigned)n_tiles, kTileThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)syms, n, (const int*)lengths, (int*)tile_bits,
      (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

// tile_offs: each tile's first bit (int64, the exclusive prefix of the
// count's tile totals, shifted by any carry before the stream). words need
// no fill: all n_words >= ceil((total_bits + pad) / 32) words are written.
// block_offs (or null with block_symbols 0) gets ceil(n / block_symbols)
// int64 bit offsets. total_dev (or null: total_bits is used) is an int64
// in device memory that holds the stream's length in place of total_bits;
// padded_out (or null) gets the length with the pad (int64).
int thc_encode_pack(int device, const void* syms, long long n,
                    const void* patterns, const void* lengths,
                    const void* tile_offs, long long total_bits,
                    int eos_padding, void* words, long long n_words,
                    long long block_symbols, void* block_offs,
                    const void* total_dev, void* padded_out, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const long long n_tiles = (n + kTile - 1) / kTile;
  encode_pack_kernel<<<(unsigned)n_tiles, kTileThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)syms, n, (const unsigned*)patterns, (const int*)lengths,
      (const long long*)tile_offs, n_tiles, total_bits, (unsigned)eos_padding,
      (unsigned*)words, n_words, block_symbols, (long long*)block_offs,
      (const long long*)total_dev, (long long*)padded_out);
  return (int)cudaGetLastError();
}

const char* thc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
