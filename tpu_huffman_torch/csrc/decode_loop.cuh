// The per-symbol loops of the two parallel decode kernels, shared by
// chain_decode.cu, selfsync_decode.cu and their ablation probe
// (probe_decode.cu), as pack.cuh holds the pack loop.
//
// Each loop is templated on how it emits a lane's outputs (EmitMode):
//   kEmitSector: the kernels' design. A lane gathers its symbols (and
//                starts) in registers and writes whole 32-byte sectors as
//                two 16-byte stores: one flush per 32 symbols or 16 starts.
//   kEmitByte:   one store a symbol at the lane's own row (the design before
//                this one), kept as the probe's comparator. A selfsync row
//                is written up to its count only.
//   kEmitNone:   the same loop with only the per-lane results stored
//                (end bits, counts, exits, bad, blast): the lookup-and-load
//                floor.
//
// Lanes write rows that lie far apart (a chain's block, a segment's row),
// so a warp's one-element stores touch 32 sectors for 32 useful bytes; the
// sector emitter touches the same 32 sectors for 512.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "lut.cuh"

namespace thc {

enum EmitMode : int {
  kEmitNone = 0,
  kEmitByte = 1,
  kEmitSector = 2,
};

constexpr int16_t kNoStart = 32767;  // a starts slot past a segment's count

template <typename T, int Mode>
struct Emitter;

template <typename T>
struct Emitter<T, kEmitNone> {
  __device__ explicit Emitter(T*) {}
  __device__ __forceinline__ void put(T) {}
  __device__ __forceinline__ void fill(T, int) {}
  __device__ __forceinline__ void finish() {}
};

template <typename T>
struct Emitter<T, kEmitByte> {
  T* p;
  __device__ explicit Emitter(T* dst) : p(dst) {}
  __device__ __forceinline__ void put(T v) { *p++ = v; }
  __device__ __forceinline__ void fill(T, int) {}  // the caller filled the row
  __device__ __forceinline__ void finish() {}
};

// Elements of T written in order from `dst` (any address aligned to T).
// Up to the first 16-byte boundary they are stored one by one; then they
// are shifted into a 16-byte accumulator (four registers, compile-time
// indices: __funnelshift_r moves every element down one slot and takes the
// new one at the top, so the first is at the bottom when it is full). A
// full accumulator is held; the next one is stored with it, two 16-byte
// stores to one 32-byte span. finish() stores what is left.
template <typename T>
struct Emitter<T, kEmitSector> {
  static constexpr int kHalf = 16 / (int)sizeof(T);  // elements a 16-byte store
  static constexpr int kBits = 8 * (int)sizeof(T);
  using U = typename std::conditional<sizeof(T) == 1, uint8_t, uint16_t>::type;

  T* p;      // the next element's address (head), or the held half's
  int head;  // elements to store one by one before p is 16-byte aligned
  int n;     // elements in the accumulator
  bool held;
  unsigned a0, a1, a2, a3;  // the accumulator
  unsigned h0, h1, h2, h3;  // the held half

  __device__ explicit Emitter(T* dst)
      : p(dst), n(0), held(false), a0(0), a1(0), a2(0), a3(0),
        h0(0), h1(0), h2(0), h3(0) {
    head = (int)(((16u - ((unsigned)(uintptr_t)dst & 15u)) & 15u) / sizeof(T));
  }

  __device__ __forceinline__ static void store16(T* at, unsigned x0, unsigned x1,
                                                 unsigned x2, unsigned x3) {
    *reinterpret_cast<uint4*>(at) = make_uint4(x0, x1, x2, x3);
  }

  __device__ __forceinline__ void put(T v) {
    if (head > 0) {
      *p++ = v;
      --head;
      return;
    }
    a0 = __funnelshift_r(a0, a1, kBits);
    a1 = __funnelshift_r(a1, a2, kBits);
    a2 = __funnelshift_r(a2, a3, kBits);
    a3 = __funnelshift_r(a3, (unsigned)(U)v, kBits);
    if (++n == kHalf) {
      n = 0;
      if (held) {
        store16(p, h0, h1, h2, h3);
        store16(p + kHalf, a0, a1, a2, a3);
        p += 2 * kHalf;
        held = false;
      } else {
        h0 = a0, h1 = a1, h2 = a2, h3 = a3;
        held = true;
      }
    }
  }

  // k more elements, each v: through put() until nothing is buffered, then
  // whole 32-byte spans of v, then the rest through put(), then finish().
  __device__ __forceinline__ void fill(T v, int k) {
    for (; k > 0 && (head > 0 || n > 0 || held); --k) put(v);
    const unsigned s = sizeof(T) == 1 ? 0x01010101u * (unsigned)(U)v
                                      : 0x00010001u * (unsigned)(U)v;
    for (; k >= 2 * kHalf; k -= 2 * kHalf) {
      store16(p, s, s, s, s);
      store16(p + kHalf, s, s, s, s);
      p += 2 * kHalf;
    }
    for (; k > 0; --k) put(v);
    finish();
  }

  // The held half, then the accumulator's n elements, which sit in its top
  // n slots, one by one.
  __device__ __forceinline__ void finish() {
    if (held) {
      store16(p, h0, h1, h2, h3);
      p += kHalf;
      held = false;
    }
    const unsigned a[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const int slot = j - (kHalf - n);
      if (slot >= 0) {
        const int byte = j * (int)sizeof(T);
        p[slot] = (T)(U)(a[byte >> 2] >> (8 * (byte & 3)));
      }
    }
    p += n;
    n = 0;
  }
};

// One chain of chain_decode: `ns` symbols from the cursor into o[0, ns), a
// refill every `group` symbols. Returns whether an active window matched no
// code (the chain does not advance then, like the plain version).
template <int Mode, bool TwoLevel>
__device__ __forceinline__ bool chain_loop(const Lut& lut, Cursor& cur, int ns, int group,
                                           uint8_t* __restrict__ o) {
  Emitter<uint8_t, Mode> out(o);
  bool is_bad = false;
  for (int i = 0; i < ns;) {
    cur.refill();
    for (const int end = min(ns, i + group); i < end; ++i) {
      int sym;
      const int ln = lut_decode<TwoLevel>(lut, cur.window(), sym);
      is_bad |= (ln == 0);
      out.put((uint8_t)sym);
      cur.advance(ln);
    }
  }
  out.finish();
  return is_bad;
}

// A chain_decode lane: block b's chain, its end bit and the bad flag.
template <int Mode, bool TwoLevel>
__device__ __forceinline__ void chain_lane(
    const Lut& lut, const unsigned* __restrict__ words, long long n_words,
    const long long* __restrict__ bit_offs, const int* __restrict__ n_syms,
    const long long* __restrict__ out_start, long long b, int group,
    uint8_t* __restrict__ out, long long* __restrict__ end_bits, int* __restrict__ bad) {
  Cursor cur(words, n_words, bit_offs[b]);
  const bool is_bad =
      chain_loop<Mode, TwoLevel>(lut, cur, n_syms[b], group, out + out_start[b]);
  end_bits[b] = cur.bit();
  if (is_bad) atomicOr(bad, 1);
}

struct SegmentEnd {
  int count, exit, first_bad, last_bad;
};

// One segment of selfsync_decode from segment-relative bit `rel`: codes
// until the first codeword start at or past seg_bits, or `cap` codes, a
// refill every `group` steps. A code takes the next slot of `row` (and of
// `start_row`: its start bit); an invalid window steps 1 bit and takes
// none. In kEmitSector mode the rest of each row, up to `pitch` slots, gets
// 0 and kNoStart.
template <int Mode, bool Starts, bool TwoLevel>
__device__ __forceinline__ SegmentEnd segment_loop(
    const Lut& lut, Cursor& cur, int rel, int seg_bits, int cap, int group, int pitch,
    uint8_t* __restrict__ row, int16_t* __restrict__ start_row) {
  Emitter<uint8_t, Mode> out(row);
  Emitter<int16_t, Starts ? Mode : (int)kEmitNone> out_s(start_row);
  int count = 0;
  int first_bad = 0;
  int last_bad = 0;
  while (rel < seg_bits && count < cap) {
    cur.refill();
    for (int g = 0; g < group && rel < seg_bits && count < cap; ++g) {
      int sym;
      const int ln = lut_decode<TwoLevel>(lut, cur.window(), sym);
      int step = ln;
      if (ln == 0) {
        if (first_bad == 0) first_bad = rel + 1;
        last_bad = rel + 1;
        step = 1;
      } else {
        if (count < pitch) {  // always true for entries >= 0 at max_symbols
          out.put((uint8_t)sym);
          out_s.put((int16_t)rel);
        }
        ++count;
      }
      rel += step;
      cur.advance(step);
    }
  }
  const int rest = pitch - min(count, pitch);
  out.fill(0, rest);
  out_s.fill(kNoStart, rest);
  return {count, rel, first_bad, last_bad};
}

// A selfsync_decode lane: lane t decodes segment t, or seg_ids[t] (a
// negative id is a dead lane that writes nothing), from entries[t].
template <int Mode, bool Starts, bool TwoLevel>
__device__ __forceinline__ void segment_lane(
    const Lut& lut, const unsigned* __restrict__ words, long long n_words,
    const int* __restrict__ entries, const int* __restrict__ seg_ids, long long t,
    int seg_bits, int pitch, int max_codes, int group, uint8_t* __restrict__ syms,
    int16_t* __restrict__ starts, int* __restrict__ counts, int* __restrict__ exits,
    int* __restrict__ bad, int* __restrict__ blast) {
  const long long s = seg_ids ? (long long)seg_ids[t] : t;
  if (s < 0) return;  // a dead lane of a repair launch
  const int rel = entries[t];  // segment-relative bit, >= 0
  Cursor cur(words, n_words, s * seg_bits + rel);
  const SegmentEnd e = segment_loop<Mode, Starts, TwoLevel>(
      lut, cur, rel, seg_bits, max_codes > 0 ? max_codes : INT_MAX, group, pitch,
      syms + t * pitch, Starts ? starts + t * pitch : nullptr);
  counts[t] = e.count;
  exits[t] = e.exit;
  bad[t] = e.first_bad;
  if (blast) blast[t] = e.last_bad;
}

}  // namespace thc
