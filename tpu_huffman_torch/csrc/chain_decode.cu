// Indexed Huffman decode for Hopper: one thread per index block.
//
// Replaces both Pallas decode kernels of tpu_huffman/ops/pallas_decode.py:
// B2 `_make_pallas_call_dual` (two half-chains per lane) and B3
// `_make_pallas_call` (one chain per lane). Their pairing of chains hides
// the TPU vector unit's latency and is not carried over: here every index
// block is an independent chain on its own thread, and the many threads in
// flight hide the latency instead.
//
// A chain starts at its block's int64 entry bit. Per symbol it takes the
// 32-bit MSB-aligned window at the head of its stream register, looks up
// (symbol, length) in the LUT (both in lut.cuh), and shifts the register by
// the length; the loop is thc::chain_loop (decode_loop.cuh). An active
// window that no code matches (length 0) marks the chain bad; the chain
// does not advance then, like the plain version, and the host raises.
//
// Bound: first the stores, then the word loads, then the serial chain
// (PERF.md §5). Lanes write blocks block_symbols bytes apart, so one byte
// store a symbol made every warp store touch 32 sectors for 32 bytes. Each
// lane now gathers its symbols in registers and writes 32-byte spans
// (thc::Emitter<kEmitSector>): bytes one by one up to its first 16-byte
// boundary (a span is aligned only when block_symbols % 16 == 0), then two
// 16-byte stores per 32 symbols, then its tail. The stream's words come in
// through thc::Cursor at refills that the whole warp makes at the same
// step, each word loaded one refill ahead; a table whose codes all fit the
// LUT's level 0 gets a loop without the level-1 branch. What is left is
// each symbol's dependent lookup and shift; throughput comes from the
// number of chains (n / block_symbols) in flight.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_loop.cuh"

namespace {

constexpr int kThreads = 128;

template <bool TwoLevel>
__global__ void chain_decode_kernel(
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
  thc::chain_lane<thc::kEmitSector, TwoLevel>(lut, words, n_words, bit_offs, n_syms,
                                              out_start, b, group, out, end_bits, bad);
}

}  // namespace

extern "C" {

// bad must be zeroed before the call; out holds sum(n_syms) bytes; max_len
// is the table's longest code. `device` (the tensors' CUDA device) is made
// current before the launch on `stream`.
int thc_chain_decode(int device, const void* words, long long n_words,
                     const void* bit_offs, const void* n_syms,
                     const void* out_start, long long n_blocks, const void* l0,
                     int root_bits, const void* l1, long long l1_size, int max_len,
                     void* out, void* end_bits, void* bad, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const thc::LutSmem smem = thc::lut_smem(root_bits, l1_size);
  const unsigned grid = (unsigned)((n_blocks + kThreads - 1) / kThreads);
  auto kernel = thc::two_level(root_bits, max_len) ? chain_decode_kernel<true>
                                                  : chain_decode_kernel<false>;
  kernel<<<grid, kThreads, smem.bytes, (cudaStream_t)stream>>>(
      (const unsigned*)words, n_words, (const long long*)bit_offs,
      (const int*)n_syms, (const long long*)out_start, n_blocks,
      (const int*)l0, root_bits, (const int*)l1, l1_size, smem.l1_in_smem,
      thc::refill_group(max_len), (uint8_t*)out, (long long*)end_bits, (int*)bad);
  return (int)cudaGetLastError();
}

}  // extern "C"
