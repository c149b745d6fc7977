// Huffman decode of a foreign stream with the reference's termination
// rules, for Hopper: one thread block walks the stream in windows staged in
// shared memory (stream_walk.cuh).
//
// Replaces the JAX package's `decode_stream_kernel`
// (tpu_huffman/ops/decode.py), a `lax.scan` with one step per symbol, not a
// Pallas kernel. Done with torch ops it would cost several launches per
// symbol; here the whole walk is one launch. It decodes small inputs, calls
// with an output cap (`max_output`), streaming drains of small remainders
// and the tail of a self-synchronising decode (selfsync_decode.cu), so the
// termination rules live in one place.
//
// From `start_bit`, per symbol, in the order of the reference loop
// (source/huffman.c:230-281):
//   1. no bits left                              -> stop, STATUS_OK;
//   2. no code matches, < 32 bits left           -> stop, STATUS_OK (needs
//                                                   more input);
//   3. no code matches, >= 32 bits left          -> stop, STATUS_UNKNOWN_SYMBOL;
//   4. the code is longer than the bits left     -> stop, STATUS_OK (trailing
//                                                   padding);
//   5. `out_capacity` symbols already written    -> stop, STATUS_OUTPUT_FULL
//                                                   (checked before the symbol
//                                                   is consumed);
//   6. write the symbol and advance by its length.
// The result is (n_decoded, end_bit, status) in info[0..2]; end_bit is the
// resume point. Output bytes past n_decoded are left as they were.
//
// Bound: the serial dependency between codes. The design before this one
// walked it on one thread, a dependent load of the next word every few
// symbols (~0.12 us a symbol on the H100); here T threads walk a window's T
// slices at once and resynchronise (stream_walk.cuh), so a window costs a
// few slices' walks, a scan and a copy out, whatever T is. Very short walks
// (HPACK's pieces) are bound by the launch; the LUT is staged in shared
// memory at every length (reading it through the cache instead was no
// faster at any walk measured).

#include <cstdint>
#include <cuda_runtime.h>

#include "stream_walk.cuh"

namespace {

template <bool TwoLevel>
__global__ void __launch_bounds__(1024, 1) stream_decode_kernel(
    const unsigned* __restrict__ words, long long n_words, long long start_bit,
    long long total_bits, long long out_capacity, const int* __restrict__ l0_g,
    int root_bits, const int* __restrict__ l1_g, long long l1_size, int sub_bits, int overlap,
    int min_len, uint8_t* __restrict__ out, long long* __restrict__ info,
    long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  thc::stream_walk<TwoLevel, true, true>(smem, words, n_words, start_bit, total_bits,
                                          out_capacity, l0_g, root_bits, l1_g, l1_size,
                                          sub_bits, overlap, min_len, out, info, stats, nullptr,
                                          nullptr);
}

// The same walk from scalars that earlier launches left in device memory:
// args = (start_bit, total_bits, budget). A negative start or budget counts
// as 0, and the budget is capped at the output's out_slots.
template <bool TwoLevel>
__global__ void __launch_bounds__(1024, 1) stream_decode_dev_kernel(
    const unsigned* __restrict__ words, long long n_words, const long long* __restrict__ args,
    long long out_slots, const int* __restrict__ l0_g, int root_bits,
    const int* __restrict__ l1_g, long long l1_size, int sub_bits, int overlap, int min_len,
    uint8_t* __restrict__ out, long long* __restrict__ info) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long start_bit = max(args[0], 0LL);
  const long long budget = min(max(args[2], 0LL), out_slots);
  thc::stream_walk<TwoLevel, true, true>(smem, words, n_words, start_bit, args[1], budget, l0_g,
                                          root_bits, l1_g, l1_size, sub_bits, overlap, min_len,
                                          out, info, nullptr, nullptr, nullptr);
}

}  // namespace

extern "C" {

// out holds at least min(out_capacity, the most symbols the bits can hold)
// bytes; info holds 3 int64, stats 2 (or null). One block of `threads`
// threads (a multiple of 32), each owning `sub_bits` bits of a window (a
// power of two >= 32) and guessing its entry from `overlap` bits before;
// min_len and max_len are the table's shortest and longest codes. `device`
// (the tensors' CUDA device) is made current before the launch on `stream`.
int thc_stream_decode(int device, const void* words, long long n_words,
                      long long start_bit, long long total_bits,
                      long long out_capacity, const void* l0, int root_bits,
                      const void* l1, long long l1_size, int max_len, int min_len,
                      int threads, int sub_bits, int overlap, void* out, void* info,
                      void* stats, void* stream) {
  const size_t smem = thc::stream_walk_smem(threads, sub_bits, overlap, min_len, root_bits,
                                            l1_size, true);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  auto kernel = thc::two_level(root_bits, max_len) ? stream_decode_kernel<true>
                                                  : stream_decode_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      (const unsigned*)words, n_words, start_bit, total_bits, out_capacity, (const int*)l0,
      root_bits, (const int*)l1, l1_size, sub_bits, overlap, min_len, (uint8_t*)out,
      (long long*)info, (long long*)stats);
  return (int)cudaGetLastError();
}

// thc_stream_decode with its three scalars in device memory: args holds
// int64 (start_bit, total_bits, budget), written by earlier launches on the
// same stream, so the host need not read them. The walk starts at
// max(start_bit, 0) and writes at most min(budget, out_slots) symbols; the
// result equals thc_stream_decode's with out_capacity = budget when
// out_slots covers the most symbols the bits can hold, (total_bits -
// start_bit) / min_len + 1. The shape (threads, sub_bits) comes from the
// host's bound on the walk, not from the scalars.
int thc_stream_decode_dev(int device, const void* words, long long n_words, const void* args,
                          long long out_slots, const void* l0, int root_bits, const void* l1,
                          long long l1_size, int max_len, int min_len, int threads,
                          int sub_bits, int overlap, void* out, void* info, void* stream) {
  const size_t smem = thc::stream_walk_smem(threads, sub_bits, overlap, min_len, root_bits,
                                            l1_size, true);
  if (smem == 0 || out_slots < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  auto kernel = thc::two_level(root_bits, max_len) ? stream_decode_dev_kernel<true>
                                                  : stream_decode_dev_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      (const unsigned*)words, n_words, (const long long*)args, out_slots, (const int*)l0,
      root_bits, (const int*)l1, l1_size, sub_bits, overlap, min_len, (uint8_t*)out,
      (long long*)info);
  return (int)cudaGetLastError();
}

}  // extern "C"
