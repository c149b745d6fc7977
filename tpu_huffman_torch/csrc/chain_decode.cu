// Indexed Huffman decode for Hopper: one thread per index block.
//
// Replaces both Pallas decode kernels of tpu_huffman/ops/pallas_decode.py:
// B2 `_make_pallas_call_dual` (two half-chains per lane) and B3
// `_make_pallas_call` (one chain per lane). Their pairing of chains hides
// the TPU vector unit's latency and is not carried over: here every index
// block is an independent chain on its own thread, and the many threads in
// flight hide the latency instead.
//
// A chain starts at its block's int64 entry bit. Per symbol it funnel-shifts
// a 32-bit MSB-aligned window out of two stream words kept in registers,
// looks up (symbol, length) in the two-level LUT (both in lut.cuh), writes
// the symbol byte to out[out_start[block] + i], and advances. An active
// window that no code matches (length 0) marks the chain bad; the chain does
// not advance then, like the plain version, and the host raises.
//
// Bound: the serial per-symbol dependency. Each symbol's position depends on
// the previous symbol's length (a shared-memory lookup and a funnel shift),
// so a chain runs at the latency of that loop; throughput comes from the
// number of chains (n / block_symbols) in flight.

#include <cstdint>
#include <cuda_runtime.h>

#include "lut.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void chain_decode_kernel(
    const unsigned* __restrict__ words, long long n_words,
    const long long* __restrict__ bit_offs, const int* __restrict__ n_syms,
    const long long* __restrict__ out_start, long long n_blocks,
    const int* __restrict__ l0_g, int root_bits, const int* __restrict__ l1_g,
    long long l1_size, int l1_in_smem, uint8_t* __restrict__ out,
    long long* __restrict__ end_bits, int* __restrict__ bad) {
  extern __shared__ int smem[];
  const thc::Lut lut =
      thc::stage_lut(smem, l0_g, root_bits, l1_g, l1_size, l1_in_smem);

  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  const int ns = n_syms[b];
  uint8_t* o = out + out_start[b];
  thc::Cursor cur(words, n_words, bit_offs[b]);
  bool is_bad = false;
  for (int i = 0; i < ns; ++i) {
    int sym;
    const int ln = thc::lut_decode(lut, cur.window(), sym);
    is_bad |= (ln == 0);
    o[i] = (uint8_t)sym;
    cur.advance(ln);
  }
  end_bits[b] = cur.bit();
  if (is_bad) atomicOr(bad, 1);
}

}  // namespace

extern "C" {

// bad must be zeroed before the call; out holds sum(n_syms) bytes. `device`
// (the tensors' CUDA device) is made current before the launch on `stream`.
int thc_chain_decode(int device, const void* words, long long n_words,
                     const void* bit_offs, const void* n_syms,
                     const void* out_start, long long n_blocks, const void* l0,
                     int root_bits, const void* l1, long long l1_size,
                     void* out, void* end_bits, void* bad, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const thc::LutSmem smem = thc::lut_smem(root_bits, l1_size);
  const unsigned grid = (unsigned)((n_blocks + kThreads - 1) / kThreads);
  chain_decode_kernel<<<grid, kThreads, smem.bytes, (cudaStream_t)stream>>>(
      (const unsigned*)words, n_words, (const long long*)bit_offs,
      (const int*)n_syms, (const long long*)out_start, n_blocks,
      (const int*)l0, root_bits, (const int*)l1, l1_size, smem.l1_in_smem,
      (uint8_t*)out, (long long*)end_bits, (int*)bad);
  return (int)cudaGetLastError();
}

}  // extern "C"
