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
// looks up (symbol, length) in the two-level LUT (level 0 in shared memory;
// level 1 too when it fits, else read through the cache from global memory,
// e.g. the HPACK table's 2^18-entry subtable for its 30-bit codes), writes
// the symbol byte to out[out_start[block] + i], and advances. An active
// window that no code matches (length 0) marks the chain bad; the chain does
// not advance then, like the plain version, and the host raises.
//
// Bound: the serial per-symbol dependency. Each symbol's position depends on
// the previous symbol's length (a shared-memory lookup and a funnel shift),
// so a chain runs at the latency of that loop; throughput comes from the
// number of chains (n / block_symbols) in flight.
//
// LUT entry forms (packed by ops/encode.py, DeviceTable):
//   level 0: (val << 8) | (bits & 0xff), bits a signed byte: > 0 leaf
//            (val = symbol), 0 invalid, < 0 pointer (-bits = subtable width,
//            val = subtable base);
//   level 1: (symbol << 8) | bits, bits 0 = invalid.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ unsigned load_word(const unsigned* __restrict__ w,
                                              long long i, long long n_words) {
  return i < n_words ? w[i] : 0u;  // past the stream: zero padding
}

__global__ void chain_decode_kernel(
    const unsigned* __restrict__ words, long long n_words,
    const long long* __restrict__ bit_offs, const int* __restrict__ n_syms,
    const long long* __restrict__ out_start, long long n_blocks,
    const int* __restrict__ l0_g, int root_bits, const int* __restrict__ l1_g,
    long long l1_size, int l1_in_smem, uint8_t* __restrict__ out,
    long long* __restrict__ end_bits, int* __restrict__ bad) {
  extern __shared__ int smem[];
  const int l0_size = 1 << root_bits;
  for (int i = threadIdx.x; i < l0_size; i += blockDim.x) smem[i] = l0_g[i];
  if (l1_in_smem) {
    for (int i = threadIdx.x; i < l1_size; i += blockDim.x)
      smem[l0_size + i] = l1_g[i];
  }
  __syncthreads();
  const int* l0 = smem;
  const int* l1 = l1_in_smem ? smem + l0_size : l1_g;

  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  const long long off = bit_offs[b];
  const int ns = n_syms[b];
  uint8_t* o = out + out_start[b];
  long long wi = off >> 5;
  int sh = (int)(off & 31);
  unsigned w0 = load_word(words, wi, n_words);
  unsigned w1 = load_word(words, wi + 1, n_words);
  const int sub_shift = root_bits;  // root_bits <= 12: no shift by 32
  bool is_bad = false;
  for (int i = 0; i < ns; ++i) {
    // (w0 << sh) | (w1 >> (32 - sh)), sh in [0, 31]
    const unsigned win = __funnelshift_l(w1, w0, sh);
    const int e = l0[win >> (32 - root_bits)];
    const int bits0 = (int)(signed char)(e & 0xff);
    int ln, sym;
    if (bits0 < 0) {
      const int width = -bits0;
      const unsigned sub = (win << sub_shift) >> (32 - width);
      const int e1 = l1[(e >> 8) + (int)sub];
      ln = e1 & 0xff;
      sym = e1 >> 8;
    } else {
      ln = bits0;
      sym = e >> 8;
    }
    is_bad |= (ln == 0);
    o[i] = (uint8_t)sym;
    // sh < 32 and ln <= 32: at most one word boundary is crossed.
    sh += ln;
    if (sh >= 32) {
      sh -= 32;
      ++wi;
      w0 = w1;
      w1 = load_word(words, wi + 1, n_words);
    }
  }
  end_bits[b] = (wi << 5) + sh;
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
  // Level 1 joins level 0 in shared memory while both fit in the 48 KiB a
  // block may take without opting in.
  const long long smem_l0 = (4LL << root_bits);
  const int l1_in_smem = smem_l0 + 4 * l1_size <= 48 * 1024;
  const size_t smem = (size_t)(smem_l0 + (l1_in_smem ? 4 * l1_size : 0));
  const unsigned grid = (unsigned)((n_blocks + kThreads - 1) / kThreads);
  chain_decode_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const unsigned*)words, n_words, (const long long*)bit_offs,
      (const int*)n_syms, (const long long*)out_start, n_blocks,
      (const int*)l0, root_bits, (const int*)l1, l1_size, l1_in_smem,
      (uint8_t*)out, (long long*)end_bits, (int*)bad);
  return (int)cudaGetLastError();
}

}  // extern "C"
