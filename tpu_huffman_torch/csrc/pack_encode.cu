// Huffman encode for Hopper: a count kernel and a pack kernel.
//
// Replaces the Pallas pack kernel B1, tpu_huffman/ops/pallas_encode.py
// `_make_pack_call`, together with the placement half of its XLA pipeline
// `_encode_pipeline` (offsets, stitch, EOS pad code).
//
// The input is cut into chunks of `chunk` consecutive symbols, one thread
// each (the chunk divides the index's block_symbols, so every block offset
// of the index is a chunk offset).
//   count: each chunk's bit total; the first unknown symbol's index
//          (atomicMin) and the data's longest code (atomicMax).
//   (host) the exclusive prefix over chunks is torch.cumsum in int64.
//   pack:  each chunk writes its codes MSB-first at its global bit offset
//          (the loop is thc::pack_chunk<kPackFull>, csrc/pack.cuh).
//          Words that lie wholly inside the chunk get plain stores; its first
//          and last word may hold a neighbour's bits too, so those are ORed
//          in (atomicOr, never an add). The output is zeroed first. The
//          last chunk appends the EOS pad code at total_bits.
// The 256 (pattern, length) pairs sit in shared memory.
//
// Bound: bytes. Each symbol is read once and each output word written once;
// there is no chain between chunks. A thread's own loop is serial through
// its bit accumulator, but there are n/chunk independent threads (262144 at
// 8 MiB and chunk 32), enough to keep the memory system busy.

#include <cstdint>
#include <cuda_runtime.h>

#include "pack.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void encode_count_kernel(const uint8_t* __restrict__ syms,
                                    long long n, int chunk,
                                    const int* __restrict__ lengths,
                                    int* __restrict__ chunk_bits,
                                    unsigned long long* __restrict__ stats,
                                    long long n_chunks) {
  __shared__ int s_len[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_len[i] = lengths[i];
  __syncthreads();

  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned max_len = 0;
  if (c < n_chunks) {
    const long long i0 = c * chunk;
    const long long i1 = min(i0 + chunk, n);
    int bits = 0;
    long long first_bad = -1;
    for (long long i = i0; i < i1; ++i) {
      const int l = s_len[syms[i]];
      bits += l;
      max_len = max(max_len, (unsigned)l);
      if (l == 0 && first_bad < 0) first_bad = i;
    }
    chunk_bits[c] = bits;
    if (first_bad >= 0) atomicMin(&stats[0], (unsigned long long)first_bad);
  }
  // One atomic per warp: every lane reaches this point (no early return).
  const unsigned m = __reduce_max_sync(0xffffffffu, max_len);
  if ((threadIdx.x & 31) == 0 && m) atomicMax(&stats[1], (unsigned long long)m);
}

__global__ void encode_pack_kernel(const uint8_t* __restrict__ syms,
                                   long long n, int chunk,
                                   const unsigned* __restrict__ patterns,
                                   const int* __restrict__ lengths,
                                   const long long* __restrict__ chunk_offs,
                                   long long n_chunks, long long total_bits,
                                   unsigned eos_padding,
                                   unsigned* __restrict__ words,
                                   long long n_words) {
  __shared__ unsigned s_pat[256];
  __shared__ int s_len[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_pat[i] = patterns[i];
    s_len[i] = lengths[i];
  }
  __syncthreads();

  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chunks) return;
  const long long i0 = c * chunk;
  thc::pack_chunk<thc::kPackFull>(syms, i0, min(i0 + chunk, n), s_pat, s_len,
                                  chunk_offs[c], c == n_chunks - 1,
                                  total_bits, eos_padding, words, n_words);
}

unsigned grid_for(long long n_chunks) {
  return (unsigned)((n_chunks + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Every entry point first makes `device` (the tensors' CUDA device) current
// for this thread, then launches on `stream`, PyTorch's current stream there.

// stats[0] must hold n (no unknown symbol) and stats[1] 0 before the call.
int thc_encode_count(int device, const void* syms, long long n, int chunk,
                     const void* lengths, void* chunk_bits, void* stats,
                     void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const long long n_chunks = (n + chunk - 1) / chunk;
  encode_count_kernel<<<grid_for(n_chunks), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)syms, n, chunk, (const int*)lengths, (int*)chunk_bits,
      (unsigned long long*)stats, n_chunks);
  return (int)cudaGetLastError();
}

// words must be zeroed and hold at least ceil((total_bits + pad) / 32) words.
int thc_encode_pack(int device, const void* syms, long long n, int chunk,
                    const void* patterns, const void* lengths,
                    const void* chunk_offs, long long total_bits,
                    int eos_padding, void* words, long long n_words,
                    void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const long long n_chunks = (n + chunk - 1) / chunk;
  encode_pack_kernel<<<grid_for(n_chunks), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)syms, n, chunk, (const unsigned*)patterns,
      (const int*)lengths, (const long long*)chunk_offs, n_chunks, total_bits,
      (unsigned)eos_padding, (unsigned*)words, n_words);
  return (int)cudaGetLastError();
}

const char* thc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
