// The pack loop of one chunk, shared by the encode pack kernel
// (pack_encode.cu) and its ablation probe (probe_pack.cu).
//
// One thread packs `chunk` consecutive symbols. The mode removes parts of
// the loop, so that the probe can split its cost (the counterpart of
// scripts/prof/prof_pack_ablate.py's modes):
//   kPackNop:     nothing read; the caller writes its outputs;
//   kPackExtract: the chunk's symbol bytes read and summed;
//   kPackLut:     each symbol's (pattern, length) looked up; the lengths
//                 summed and the patterns XORed;
//   kPackLut4:    the same values from four interleaved accumulators;
//   kPackFull:    the production loop: codes MSB-first at the chunk's bit
//                 offset, edge words ORed in, the EOS pad code after the
//                 last chunk. encode_pack_kernel runs this mode.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace thc {

enum PackMode : int {
  kPackNop = 0,
  kPackExtract = 1,
  kPackLut = 2,
  kPackLut4 = 3,
  kPackFull = 4,
};

struct PackSums {
  int sum;
  unsigned x;
};

// Words past n_words are dropped: offsets that disagree with the word
// count can never write outside the output.
__device__ __forceinline__ void emit(unsigned* words, long long n_words,
                                     long long w, unsigned v, bool shared) {
  if (w < 0 || w >= n_words) return;
  if (shared) {
    atomicOr(&words[w], v);
  } else {
    words[w] = v;
  }
}

// Symbols [i0, i1) of one chunk; s_pat/s_len are the 256 (pattern,
// length) pairs in shared memory. Only kPackFull reads `start` (the
// chunk's first bit) and the arguments after it, and writes `words`.
template <int Mode>
__device__ __forceinline__ PackSums pack_chunk(
    const uint8_t* __restrict__ syms, long long i0, long long i1,
    const unsigned* s_pat, const int* s_len, long long start, bool last,
    long long total_bits, unsigned eos_padding, unsigned* __restrict__ words,
    long long n_words) {
  PackSums r{0, 0u};
  if constexpr (Mode == kPackExtract) {
    for (long long i = i0; i < i1; ++i) r.sum += syms[i];
  } else if constexpr (Mode == kPackLut) {
    for (long long i = i0; i < i1; ++i) {
      const int s = syms[i];
      r.sum += s_len[s];
      r.x ^= s_pat[s];
    }
  } else if constexpr (Mode == kPackLut4) {
    int l4[4] = {0, 0, 0, 0};
    unsigned x4[4] = {0u, 0u, 0u, 0u};
    long long i = i0;
    for (; i + 4 <= i1; i += 4) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int s = syms[i + v];
        l4[v] += s_len[s];
        x4[v] ^= s_pat[s];
      }
    }
    for (; i < i1; ++i) {
      const int s = syms[i];
      l4[0] += s_len[s];
      x4[0] ^= s_pat[s];
    }
    r.sum = (l4[0] + l4[1]) + (l4[2] + l4[3]);
    r.x = (x4[0] ^ x4[1]) ^ (x4[2] ^ x4[3]);
  } else if constexpr (Mode == kPackFull) {
    long long w = start >> 5;
    // acc holds the pending bits MSB-aligned; its top `nacc` bits are live.
    // The first (start & 31) of them belong to the previous chunk: zeros here.
    unsigned long long acc = 0;
    int nacc = (int)(start & 31);
    bool first = true;  // the first word written may be shared with the left
    for (long long i = i0; i < i1; ++i) {
      const int s = syms[i];
      const int l = s_len[s];
      if (l == 0) continue;  // unknown symbol: the host has raised already
      // nacc < 32 and 1 <= l <= 32 keep the shift in [1, 63].
      acc |= (unsigned long long)s_pat[s] << (64 - nacc - l);
      nacc += l;
      if (nacc >= 32) {
        emit(words, n_words, w, (unsigned)(acc >> 32), first);
        first = false;
        ++w;
        acc <<= 32;
        nacc -= 32;
      }
    }
    if (last) {
      // EOS padding: the low pad_len bits of eos_padding at total_bits, the
      // end of this (the last) chunk.
      const int pad_len = (int)((8 - (total_bits & 7)) & 7);
      if (pad_len) {
        const unsigned pad = eos_padding & ((1u << pad_len) - 1u);
        acc |= (unsigned long long)pad << (64 - nacc - pad_len);
        nacc += pad_len;
        if (nacc >= 32) {
          emit(words, n_words, w, (unsigned)(acc >> 32), first);
          ++w;
          acc <<= 32;
          nacc -= 32;
        }
      }
    }
    // The last, partial word may be shared with the next chunk.
    if (nacc > 0) emit(words, n_words, w, (unsigned)(acc >> 32), true);
  }
  return r;
}

}  // namespace thc
