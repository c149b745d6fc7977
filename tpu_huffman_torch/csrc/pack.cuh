// The encode's loops, shared by the encode kernels (pack_encode.cu) and
// their ablation probe (probe_pack.cu).
//
// The tile loop (pack_tile; the count kernel loads its tiles with the same
// load_syms16): one block of kTileThreads threads takes kTile consecutive
// symbols, 16 a thread, loaded as one uint4 with neighbouring threads on
// neighbouring addresses. pack_tile scans the
// threads' bit totals across the block, ORs the codes MSB-first into a
// word buffer in shared memory, completes its last word with the head
// codes of the next tile (the EOS pad code after the last one), and copies
// the words it owns to device memory, consecutive lanes on consecutive
// words. A tile owns the words whose first bit lies in its bit range (tile
// 0 also word 0, the last tile every word up to n_words), so every output
// word is written exactly once, by plain stores: the output needs no fill
// and no global atomics. The same scan gives the index's block offsets.
//
// The per-thread loop (pack_chunk): the earlier design, one thread a chunk of
// consecutive symbols read one byte at a time, edge words ORed into a
// zeroed output with global atomics. Only the probe runs it now. The mode
// removes parts of it, so that the probe can split its cost (the
// counterpart of scripts/prof/prof_pack_ablate.py's modes):
//   kPackNop:     nothing read; the caller writes its outputs;
//   kPackExtract: the chunk's symbol bytes read and summed;
//   kPackLut:     each symbol's (pattern, length) looked up; the lengths
//                 summed and the patterns XORed;
//   kPackLut4:    the same values from four interleaved accumulators;
//   kPackThread:  the whole loop: codes MSB-first at the chunk's bit offset,
//                 edge words ORed in, the EOS pad code after the last chunk.
// kPackFull is the tile loop (pack_tile), as encode_pack_kernel runs it;
// kPackTileScan the same up to its block scan (setup, uint4 loads,
// lookups, scan), which splits the tile loop's time from its placement
// (the codes into shared memory, the head, the copy out).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace thc {

constexpr int kTile = 4096;          // symbols a tile: one block of the encode kernels
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kSymsPerThread = kTile / kTileThreads;  // 16: one uint4
// A tile's codes at up to 32 bits each, behind up to 31 bits of the
// previous tile in its first word, and the EOS pad code after the last.
constexpr int kTileWords = kTile + 2;
static_assert(kSymsPerThread == 16, "one uint4 of symbols a thread");

enum PackMode : int {
  kPackNop = 0,
  kPackExtract = 1,
  kPackLut = 2,
  kPackLut4 = 3,
  kPackFull = 4,
  kPackThread = 5,
  kPackTileScan = 6,  // the tile loop up to its scan: the tiles' bit totals
};

struct PackSums {
  int sum;
  unsigned x;
};

// ---- the tile loop ---------------------------------------------------------

// A thread's 16 symbols: byte j of the tile slice is (w[j / 4] >> 8 (j % 4)).
struct Syms16 {
  unsigned w[4];
  int count;  // symbols that exist (16 but at the ragged end of the input)
};

// One uint4 load where the input is 16-byte aligned and the 16 symbols
// exist; otherwise byte loads of those that exist (a view that starts off
// alignment, or the ragged end).
__device__ __forceinline__ Syms16 load_syms16(const uint8_t* __restrict__ syms,
                                              long long i0, long long n,
                                              bool aligned) {
  Syms16 s;
  if (aligned && i0 + kSymsPerThread <= n) {
    const uint4 v = *reinterpret_cast<const uint4*>(syms + i0);
    s.w[0] = v.x;
    s.w[1] = v.y;
    s.w[2] = v.z;
    s.w[3] = v.w;
    s.count = kSymsPerThread;
    return s;
  }
  const long long left = n - i0;
  s.count = left <= 0 ? 0 : (int)min(left, (long long)kSymsPerThread);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    unsigned w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (4 * k + b < s.count) w |= (unsigned)syms[i0 + 4 * k + b] << (8 * b);
    }
    s.w[k] = w;
  }
  return s;
}

__device__ __forceinline__ int sym_at(const Syms16& s, int j) {
  return (int)((s.w[j >> 2] >> (8 * (j & 3))) & 255u);
}

// Exclusive scan of v over the block; `total` gets the block's sum. One
// __syncthreads: s_warp (kTileWarps ints) is written once per kernel.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int k = 0; k < kTileWarps; ++k) {
    const int t = s_warp[k];
    before += k < warp ? t : 0;
    total += t;
  }
  return before + x - v;
}

// ORs `len` (1..32) bits of `pat` (its low bits) into the shared buffer at
// local bit `pos`.
__device__ __forceinline__ void or_code(unsigned* s_buf, int pos, unsigned pat,
                                        int len) {
  const unsigned long long v = (unsigned long long)pat
                               << (64 - (pos & 31) - len);
  atomicOr(&s_buf[pos >> 5], (unsigned)(v >> 32));
  if ((unsigned)v) atomicOr(&s_buf[(pos >> 5) + 1], (unsigned)v);
}

// The bits [end, end of its word) that follow a tile ending at local bit
// `end`: the first codes of the next tile, and the EOS pad code (pad_len
// bits of `pad`) where the input ends within 32 symbols. Run by one whole
// warp; ORs them into the buffer's last word.
__device__ __forceinline__ void or_head(unsigned* s_buf, int end,
                                        const uint8_t* __restrict__ syms,
                                        long long next, long long n,
                                        const unsigned* s_pat, const int* s_len,
                                        unsigned pad, int pad_len) {
  const int need = (32 - (end & 31)) & 31;
  if (need == 0) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const long long i = next + lane;
  int l = 0;
  unsigned p = 0;
  if (i < n) {
    const int s = syms[i];
    l = s_len[s];
    p = s_pat[s];
  } else if (i == n) {
    l = pad_len;
    p = pad;
  }
  int x = l;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  const int st = x - l;  // this code's first bit, past `end`
  unsigned v = 0;
  if (l > 0 && st < need) {
    const int q = (end & 31) + st;  // its first bit within the word, >= 1
    v = q + l <= 32 ? p << (32 - q - l) : p >> (q + l - 32);
  }
  v = __reduce_or_sync(0xffffffffu, v);
  if (lane == 0) atomicOr(&s_buf[end >> 5], v);
}

// One tile of the pack: the symbols [tile * kTile, min(+kTile, n)) at bit
// `base` (the tile's exclusive prefix, int64). s_pat/s_len hold the table;
// s_buf (kTileWords words) and s_warp (kTileWarps ints) are scratch. The
// caller has loaded the table, and zeroed s_buf, before a __syncthreads.
// block_offs (or null) gets the bit of every symbol index that is a
// multiple of block_symbols. kScanOnly (the probe's `tile_scan`) stops
// after the scan and writes the tile's bit total to words[tile].
template <bool kScanOnly = false>
__device__ __forceinline__ void pack_tile(
    const uint8_t* __restrict__ syms, long long n, long long tile,
    long long n_tiles, bool aligned, const unsigned* s_pat, const int* s_len,
    long long base, long long total_bits, unsigned eos_padding,
    unsigned* __restrict__ words, long long n_words, long long block_symbols,
    long long* __restrict__ block_offs, unsigned* s_buf, int* s_warp) {
  const long long i0 = tile * kTile + (long long)threadIdx.x * kSymsPerThread;
  const Syms16 s = load_syms16(syms, i0, n, aligned);
  int lens[kSymsPerThread];
  int bits = 0;
#pragma unroll
  for (int j = 0; j < kSymsPerThread; ++j) {
    lens[j] = j < s.count ? s_len[sym_at(s, j)] : 0;
    bits += lens[j];
  }
  int tile_bits;
  const int off = block_exclusive_scan(bits, s_warp, tile_bits);
  if constexpr (kScanOnly) {
    if (threadIdx.x == 0) words[tile] = (unsigned)tile_bits;
    return;
  }
  const long long wbase = base >> 5;  // the buffer's word 0
  const int lo = (int)(base & 31) + off;  // this thread's first bit in it

  // The thread's codes through a 64-bit accumulator, its top `nacc` bits
  // live; words wholly its own are stored, its first and last ORed.
  unsigned long long acc = 0;
  int nacc = lo & 31;
  int w = lo >> 5;
  bool first = true;
  int pos = lo;
  // The next index block that starts among this thread's symbols: its
  // number and its symbol's place in the thread's 16 (16 if none).
  long long blk = 0;
  int at = kSymsPerThread;
  if (block_offs != nullptr) {
    blk = (i0 + block_symbols - 1) / block_symbols;
    at = (int)min(blk * block_symbols - i0, (long long)kSymsPerThread);
  }
  const int step = (int)min(block_symbols, (long long)kSymsPerThread);
#pragma unroll
  for (int j = 0; j < kSymsPerThread; ++j) {
    const int l = lens[j];
    if (j == at && j < s.count) {
      block_offs[blk++] = (wbase << 5) + pos;
      at += step;
    }
    pos += l;
    if (l == 0) continue;  // no code (unknown symbol, or past the input)
    // nacc < 32 and 1 <= l <= 32 keep the shift in [1, 63].
    acc |= (unsigned long long)s_pat[sym_at(s, j)] << (64 - nacc - l);
    nacc += l;
    if (nacc >= 32) {
      if (first) {
        atomicOr(&s_buf[w], (unsigned)(acc >> 32));
      } else {
        s_buf[w] = (unsigned)(acc >> 32);
      }
      first = false;
      ++w;
      acc <<= 32;
      nacc -= 32;
    }
  }
  if (nacc > 0) atomicOr(&s_buf[w], (unsigned)(acc >> 32));

  // The tile's end, and the bits after it within its last word.
  const int end = (int)(base & 31) + tile_bits;
  const bool last = tile == n_tiles - 1;
  const int pad_len = (int)((8 - (total_bits & 7)) & 7);
  const unsigned pad = eos_padding & ((1u << pad_len) - 1u);
  if (last) {
    if (threadIdx.x == 0 && pad_len) or_code(s_buf, end, pad, pad_len);
  } else if ((threadIdx.x >> 5) == kTileWarps - 1) {
    or_head(s_buf, end, syms, (tile + 1) * kTile, n, s_pat, s_len, pad,
            pad_len);
  }
  __syncthreads();

  // The words this tile owns: from the first whose first bit is in its
  // range (word 0 for tile 0) to the last (every word up to n_words for the
  // last tile; words past its codes are zeros).
  const long long w_lo = tile == 0 ? 0 : (base + 31) >> 5;
  const long long w_hi =
      last ? n_words : min(n_words, (base + tile_bits + 31) >> 5);
  for (long long g = w_lo + threadIdx.x; g < w_hi; g += kTileThreads) {
    const long long k = g - wbase;
    words[g] = k >= 0 && k < kTileWords ? s_buf[k] : 0u;
  }
}

// The pack's prologue: the table into shared memory, the word buffer zeroed.
__device__ __forceinline__ void pack_tile_setup(
    const unsigned* __restrict__ patterns, const int* __restrict__ lengths,
    unsigned* s_pat, int* s_len, unsigned* s_buf) {
  for (int i = threadIdx.x; i < 256; i += kTileThreads) {
    s_pat[i] = patterns[i];
    s_len[i] = lengths[i];
  }
  for (int i = threadIdx.x; i < kTileWords; i += kTileThreads) s_buf[i] = 0u;
  __syncthreads();
}

// ---- the per-thread loop (the probe's comparator) --------------------------

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
// length) pairs in shared memory. Only kPackThread reads `start` (the
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
  } else if constexpr (Mode == kPackThread) {
    long long w = start >> 5;
    // acc holds the pending bits MSB-aligned; its top `nacc` bits are live.
    // The first (start & 31) of them belong to the previous chunk: zeros here.
    unsigned long long acc = 0;
    int nacc = (int)(start & 31);
    bool first = true;  // the first word written may be shared with the left
    for (long long i = i0; i < i1; ++i) {
      const int s = syms[i];
      const int l = s_len[s];
      // Unknown symbol: no bits. The host raises, unless it starts at or past a
      // capped call's cut, where the bytes before the cut are all it keeps.
      if (l == 0) continue;
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
