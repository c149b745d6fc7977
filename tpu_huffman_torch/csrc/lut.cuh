// Pieces shared by the decode kernels (chain_decode.cu, selfsync_decode.cu,
// stream_decode.cu): the two-level LUT lookup and the funnel-shift window.
//
// LUT entry forms (packed by ops/encode.py, DeviceTable):
//   level 0: (val << 8) | (bits & 0xff), bits a signed byte: > 0 leaf
//            (val = symbol), 0 invalid, < 0 pointer (-bits = subtable width,
//            val = subtable base);
//   level 1: (symbol << 8) | bits, bits 0 = invalid.
// Level 0 always lives in shared memory; level 1 joins it while both fit in
// the 48 KiB a block may take without opting in, else it is read through the
// cache from global memory (e.g. the HPACK table's 2^18-entry subtable for
// its 30-bit codes).
//
// Stream bit j lives in word j >> 5 at bit 31 - (j & 31); words past the
// stream read as zeros, as the reference decoder pads its window.

#pragma once

#include <cstddef>
#include <cuda_runtime.h>

namespace thc {

struct Lut {
  const int* l0;
  const int* l1;
  int root_bits;  // <= 12: level 0 fits shared memory, and no shift by 32
};

// Host side: dynamic shared memory for the LUT, and whether level 1 is in it.
struct LutSmem {
  size_t bytes;
  int l1_in_smem;
};

inline LutSmem lut_smem(int root_bits, long long l1_size) {
  const long long l0_bytes = 4LL << root_bits;
  const int l1_in = l0_bytes + 4 * l1_size <= 48 * 1024;
  return {(size_t)(l0_bytes + (l1_in ? 4 * l1_size : 0)), l1_in};
}

// Every thread of the block calls this once, before any lookup.
__device__ __forceinline__ Lut stage_lut(int* smem, const int* __restrict__ l0_g,
                                         int root_bits,
                                         const int* __restrict__ l1_g,
                                         long long l1_size, int l1_in_smem) {
  const int l0_size = 1 << root_bits;
  for (int i = threadIdx.x; i < l0_size; i += blockDim.x) smem[i] = l0_g[i];
  if (l1_in_smem) {
    for (int i = threadIdx.x; i < l1_size; i += blockDim.x)
      smem[l0_size + i] = l1_g[i];
  }
  __syncthreads();
  return {smem, l1_in_smem ? smem + l0_size : l1_g, root_bits};
}

// Bits read by the code at the head of the MSB-aligned 32-bit window `win`
// (0 = no code matches), and its symbol in `sym`.
__device__ __forceinline__ int lut_decode(const Lut& lut, unsigned win, int& sym) {
  const int e = lut.l0[win >> (32 - lut.root_bits)];
  const int bits0 = (int)(signed char)(e & 0xff);
  if (bits0 >= 0) {
    sym = e >> 8;
    return bits0;
  }
  const int width = -bits0;  // in [1, 32 - root_bits]
  const unsigned sub = (win << lut.root_bits) >> (32 - width);
  const int e1 = lut.l1[(e >> 8) + (int)sub];
  sym = e1 >> 8;
  return e1 & 0xff;
}

__device__ __forceinline__ unsigned load_word(const unsigned* __restrict__ w,
                                              long long i, long long n_words) {
  return i < n_words ? w[i] : 0u;  // past the stream: zero padding
}

// A position in the stream: word index and phase, with the two words under
// the window kept in registers.
struct Cursor {
  const unsigned* words;
  long long n_words;
  long long wi;
  int sh;  // in [0, 31]
  unsigned w0, w1;

  __device__ Cursor(const unsigned* __restrict__ w, long long n, long long start)
      : words(w), n_words(n), wi(start >> 5), sh((int)(start & 31)) {
    w0 = load_word(words, wi, n_words);
    w1 = load_word(words, wi + 1, n_words);
  }

  __device__ __forceinline__ long long bit() const { return (wi << 5) + sh; }

  // (w0 << sh) | (w1 >> (32 - sh)) without a shift by 32.
  __device__ __forceinline__ unsigned window() const {
    return __funnelshift_l(w1, w0, sh);
  }

  // step <= 32 and sh < 32: at most one word boundary is crossed.
  __device__ __forceinline__ void advance(int step) {
    sh += step;
    if (sh >= 32) {
      sh -= 32;
      ++wi;
      w0 = w1;
      w1 = load_word(words, wi + 1, n_words);
    }
  }
};

}  // namespace thc
