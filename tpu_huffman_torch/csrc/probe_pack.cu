// Ablation probe of the port's pack loop.
//
// Replaces scripts/prof/prof_pack_ablate.py:make_call (the Pallas kernel
// of :187), which ablated B1's per-symbol loop on the TPU. Here the loop
// ablated is the port's own: thc::pack_chunk (csrc/pack.cuh), which
// encode_pack_kernel (pack_encode.cu) runs in its kPackFull mode, so the
// probe's `full` is the production loop and cannot drift from it. Same
// launch shape as encode_pack_kernel: one thread per 32-symbol chunk, 256
// threads a block, the 256 (pattern, length) pairs in shared memory.
// Outputs: `full` writes the stream's words (zeroed first by the caller,
// edge words ORed); every other mode writes (sum, xor) per chunk.
//
// Bound: bytes (8 MiB of symbols read once, 8 bytes a chunk written). The
// modes split where the production loop's time above that bound goes:
// the chunk-strided byte reads (extract), the shared-memory lookups and
// their dependent adds (lut, lut4 with four chains), the bit accumulator
// and the word stores (full).

#include <cstdint>
#include <cuda_runtime.h>

#include "pack.cuh"

namespace {

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
  const long long start = Mode == thc::kPackFull ? chunk_offs[c] : 0;
  const thc::PackSums r = thc::pack_chunk<Mode>(
      syms, i0, min(i0 + chunk, n), s_pat, s_len, start, c == n_chunks - 1,
      total_bits, eos_padding, words, n_words);
  if constexpr (Mode != thc::kPackFull) sums[c] = make_int2(r.sum, (int)r.x);
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

// mode: 0 nop, 1 extract, 2 lut, 3 lut4, 4 full (thc::PackMode). `full`
// needs chunk_offs, total_bits and zeroed words, as thc_encode_pack does;
// the other modes need sums (int32[n_chunks][2]).
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
    case thc::kPackFull:
      launch<thc::kPackFull>(syms, n, chunk, patterns, lengths, chunk_offs,
                             total_bits, eos_padding, words, n_words, sums, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
