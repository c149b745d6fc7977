// Pieces shared by the decode kernels (chain_decode.cu, selfsync_decode.cu,
// stream_decode.cu): the two-level LUT lookup and the stream cursor.
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

// `reserve` bytes of the 48 KiB are kept for the caller's own tables.
__host__ __device__ inline LutSmem lut_smem(int root_bits, long long l1_size,
                                            long long reserve = 0) {
  const long long l0_bytes = 4LL << root_bits;
  const int l1_in = l0_bytes + 4 * l1_size + reserve <= 48 * 1024;
  return {(size_t)(l0_bytes + (l1_in ? 4 * l1_size : 0)), l1_in};
}

// The block's copy of the LUT into shared memory, with no barrier: the
// caller's next __syncthreads() must come before any lookup.
__device__ __forceinline__ Lut copy_lut(int* smem, const int* __restrict__ l0_g,
                                        int root_bits, const int* __restrict__ l1_g,
                                        long long l1_size, int l1_in_smem) {
  const int l0_size = 1 << root_bits;
  for (int i = threadIdx.x; i < l0_size; i += blockDim.x) smem[i] = l0_g[i];
  if (l1_in_smem) {
    for (int i = threadIdx.x; i < l1_size; i += blockDim.x)
      smem[l0_size + i] = l1_g[i];
  }
  return {smem, l1_in_smem ? smem + l0_size : l1_g, root_bits};
}

// Every thread of the block calls this once, before any lookup.
__device__ __forceinline__ Lut stage_lut(int* smem, const int* __restrict__ l0_g,
                                         int root_bits,
                                         const int* __restrict__ l1_g,
                                         long long l1_size, int l1_in_smem) {
  const Lut lut = copy_lut(smem, l0_g, root_bits, l1_g, l1_size, l1_in_smem);
  __syncthreads();
  return lut;
}

// Whether a table's LUT has level-1 entries: some code is longer than the
// level-0 index.
inline bool two_level(int root_bits, int max_len) { return max_len > root_bits; }

// Bits read by the code at the head of the MSB-aligned 32-bit window `win`
// (0 = no code matches), and its symbol in `sym`. With TwoLevel false (a
// table whose codes all fit level 0) the level-1 branch is compiled out: it
// lengthens every step even where no lane takes it.
template <bool TwoLevel>
__device__ __forceinline__ int lut_decode(const Lut& lut, unsigned win, int& sym) {
  const int e = lut.l0[win >> (32 - lut.root_bits)];
  const int bits0 = (int)(signed char)(e & 0xff);
  if (!TwoLevel || bits0 >= 0) {
    sym = e >> 8;
    return bits0;
  }
  const int width = -bits0;  // in [1, 32 - root_bits]
  const unsigned sub = (win << lut.root_bits) >> (32 - width);
  const int e1 = lut.l1[(e >> 8) + (int)sub];
  sym = e1 >> 8;
  return e1 & 0xff;
}

// Symbols a lane can decode between two refills of its Cursor: a refill
// leaves at least 32 bits in it, and each step needs max_len of them.
inline int refill_group(int max_len) {
  return max_len >= 32 ? 1 : (max_len < 1 ? 32 : 32 / max_len);
}

// A position in the stream: the next bits MSB-aligned in a 64-bit register,
// and the word after them, loaded ahead. refill() appends that word once 32
// or fewer bits are left and issues the load of the next one, so the word
// a refill appends was loaded at the refill before it.
//
// Refills come every refill_group(max_len) steps, at the same step for every
// lane of a warp. A warp waits on a register written by a load until the
// load has landed for all its lanes; had each lane loaded its next word when
// its own window crossed a word boundary (every ~3.4 symbols, so some lane of
// the warp at nearly every step), every step would wait on a load issued the
// step before.
//
// The position is a 64-bit base (the start word) plus 32-bit word and bit
// counts, so the per-symbol work shifts and adds in 32 bits; only bit() goes
// back to 64 bits.
struct Cursor {
  const unsigned* base;     // the start word
  long long base_bit;       // its first bit
  int lim;                  // words of the stream from `base` on, in [0, INT_MAX]
  int next;                 // the word `ahead` holds, from `base`
  int avail;                // valid bits at the top of `bits`, in [0, 64]
  unsigned ahead;           // word `next`
  unsigned long long bits;  // the stream from bit() on, MSB-aligned

  __device__ Cursor(const unsigned* __restrict__ w, long long n, long long start) {
    const long long ws = start >> 5;
    const long long left = n - ws;
    const int sh = (int)(start & 31);
    base = w + ws;
    base_bit = ws << 5;
    lim = left <= 0 ? 0 : (left >= 0x7fffffffLL ? 0x7fffffff : (int)left);
    bits = (((unsigned long long)load(0) << 32) | load(1)) << sh;
    avail = 64 - sh;
    next = 2;
    ahead = load(2);
  }

  // past the stream: zero padding
  __device__ __forceinline__ unsigned load(int i) const {
    return i < lim ? base[i] : 0u;
  }

  __device__ __forceinline__ long long bit() const {
    return base_bit + 32LL * next - avail;
  }

  // Once 32 or fewer bits are left (never fewer than 0: a group takes at
  // most 32), append `ahead` and load the word after it.
  __device__ __forceinline__ void refill() {
    if (avail <= 32) {
      bits |= (unsigned long long)ahead << (32 - avail);
      avail += 32;
      ahead = load(++next);
    }
  }

  // The 32 bits at bit(); those past `avail` read as 0 (a lookup needs at
  // most max_len of them, which a refill group guarantees).
  __device__ __forceinline__ unsigned window() const { return (unsigned)(bits >> 32); }

  __device__ __forceinline__ void advance(int step) {
    bits <<= step;
    avail -= step;
  }
};

}  // namespace thc
