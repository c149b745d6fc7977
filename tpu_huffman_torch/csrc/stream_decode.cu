// Sequential Huffman decode of a foreign stream with the reference's
// termination rules, for Hopper: one thread walks the stream.
//
// Replaces the JAX package's `decode_stream_kernel`
// (tpu_huffman/ops/decode.py), a `lax.scan` with one step per symbol, not a
// Pallas kernel. Done with torch ops it would cost several launches per
// symbol; here the whole walk is one launch. It decodes small inputs, calls
// with an output cap (`max_output`), and the tail of a self-synchronising
// decode (selfsync_decode.cu), so the termination rules live in one place.
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
// resume point.
//
// Bound: the serial dependency, one LUT lookup and one shift per symbol on
// one thread (thc::Cursor, refilled before every symbol so that the stop
// rules see a full 32-bit window). The block's other threads only help stage the LUT in
// shared memory. The kernel is meant for short walks: a tail of at most two
// segments plus one code, or an input of at most 2048 bytes, or a capped
// prefix.

#include <cstdint>
#include <cuda_runtime.h>

#include "lut.cuh"

namespace {

constexpr int kThreads = 128;  // for staging the LUT; thread 0 decodes
constexpr long long kStatusOk = 0;
constexpr long long kStatusUnknownSymbol = 1;
constexpr long long kStatusOutputFull = 2;

__global__ void stream_decode_kernel(
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
  long long status = kStatusOk;
  for (;;) {
    const long long left = total_bits - cur.bit();
    if (left <= 0) break;
    cur.refill();  // every step: 32 bits in the window, as the stop rules read them
    int sym;
    const int ln = thc::lut_decode<true>(lut, cur.window(), sym);
    if (ln == 0) {
      if (left >= 32) status = kStatusUnknownSymbol;
      break;
    }
    if (ln > left) break;
    if (n_out >= out_capacity) {
      status = kStatusOutputFull;
      break;
    }
    out[n_out++] = (uint8_t)sym;
    cur.advance(ln);
  }
  info[0] = n_out;
  info[1] = cur.bit();
  info[2] = status;
}

}  // namespace

extern "C" {

// out holds at least min(out_capacity, the most symbols the bits can hold)
// bytes; info holds 3 int64. `device` (the tensors' CUDA device) is made
// current before the launch on `stream`.
int thc_stream_decode(int device, const void* words, long long n_words,
                      long long start_bit, long long total_bits,
                      long long out_capacity, const void* l0, int root_bits,
                      const void* l1, long long l1_size, void* out, void* info,
                      void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const thc::LutSmem smem = thc::lut_smem(root_bits, l1_size);
  stream_decode_kernel<<<1, kThreads, smem.bytes, (cudaStream_t)stream>>>(
      (const unsigned*)words, n_words, start_bit, total_bits, out_capacity,
      (const int*)l0, root_bits, (const int*)l1, l1_size, smem.l1_in_smem,
      (uint8_t*)out, (long long*)info);
  return (int)cudaGetLastError();
}

}  // extern "C"
