// The block walk of stream_decode.cu, shared with its ablation probe
// (probe_decode.cu), as decode_loop.cuh holds the parallel decode loops.
//
// One thread block decodes a foreign stream from `start_bit` with the
// reference's stop rules (source/huffman.c:230-281), in windows of W words
// staged in shared memory. Thread t of T owns the bits [t*B, (t+1)*B) of a
// window (B = sub_bits, a multiple of 32; W = T*B/32):
//
//   1. stage: the window's words plus two guard words (a code straddling
//      the window's end reads shared memory), 16-byte loads where the
//      words allow; the thread's words of the start bitmap cleared. Both
//      hold one pad word after each slice's B/32 words: a warp's threads,
//      each at the same offset in its own slice, then hit 32 banks, not
//      32 / (B/32).
//   2. speculate: thread 0 enters at the walk's exact bit, thread t > 0 at
//      the first step start at or past its slice's first bit of a walk
//      from `overlap` bits before it (most walks resynchronise within a
//      few codes, so the guess is mostly the true entry, and few threads
//      walk again). Each walks to the first step start at or past
//      its slice's end and records its first stop event (rules 1-4, judged
//      against total_bits, never against the window's end) with the codes
//      before it, its exit bit, and every step start in the bitmap. A walk
//      does not end at an event: a window that matches no code steps one
//      bit, as B4's segments do, so a walk from a wrong entry still hands
//      its neighbour an exit (rule 1, no bits left, exits at the slice's
//      end: past the stream nothing decodes).
//   3. synchronise: thread t's true entry is thread t-1's true exit. A
//      thread whose entry changed walks again from the new entry, up to
//      the first step start its previous walk visited: from there the old
//      exit holds, and so do its later events and its codes (the old
//      starts past that point), marked in a second bitmap that then takes
//      the first one's place. Rounds repeat
//      until no entry changes; each round fixes at least one more thread,
//      so a window takes at most T-1 rounds (a table whose codes never
//      resynchronise takes the serial walk's time, no more).
//   4. resolve: the first thread whose true walk met a stop event ends the
//      walk; an exclusive block scan of the true counts gives each thread's
//      output index. The symbol at index out_capacity ends it earlier, with
//      OUTPUT_FULL, only if that symbol decodes (rules 1-4 come first).
//   5. write: each live thread walks its slice once more from its true
//      entry into a shared-memory buffer at its scanned offset, at the
//      output's 16-byte phase; the block copies it out with consecutive
//      lanes on consecutive 16-byte chunks (stores are priced per lane).
//
// Bit positions are int64 across windows and int32 inside one.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "lut.cuh"

namespace thc {

constexpr int kStreamOk = 0;
constexpr int kStreamUnknownSymbol = 1;
constexpr int kStreamOutputFull = 2;
constexpr int kNoEvent = -1;
// rewalk's branch counters (the probe's `branches`)
enum { kRewalks, kJoinOldRecord, kJoinOldStarts, kJoinSuffixWalk, kBranches };
constexpr size_t kMaxBlockSmem = 232448;  // H100: 227 KiB a block, opted in

__host__ __device__ inline size_t up16(size_t x) { return (x + 15) & ~(size_t)15; }

// Byte offsets of the walk's shared memory: the LUT (when staged), the
// window and the two start bitmaps (each with a pad word a slice), each
// thread's exit, event and event bit, the
// scan's warp sums, two scalars and the output buffer (a window's most
// symbols at its 16-byte phase).
struct WalkLayout {
  size_t win, bitmap, exits, events, ev_bits, wsum, scalars, out, bytes;
  __host__ __device__ __forceinline__ WalkLayout(size_t lut_bytes, int threads, int window_words,
                                                 int min_len) {
    win = up16(lut_bytes);
    bitmap = win + 4 * (size_t)(window_words + threads + 8);
    exits = bitmap + 8 * (size_t)(window_words + threads);
    events = exits + 4 * (size_t)threads;
    ev_bits = events + 4 * (size_t)threads;
    wsum = ev_bits + 4 * (size_t)threads;
    scalars = wsum + 4 * 32;
    out = scalars + 16;
    bytes = out + up16(16 + (size_t)window_words * 32 / min_len + 2);
  }
};

// Shared-memory words with one pad word after every 2^sh: word i at
// i + (i >> sh).
struct Padded {
  unsigned* p;
  int sh;
  __device__ __forceinline__ unsigned& operator[](int i) const { return p[i + (i >> sh)]; }
};

struct WalkRec {
  int count;   // codes before the first stop event (all, without one)
  int exit;    // the first step start at or past the slice's end
  int ev;      // the first stop event's status, or kNoEvent
  int ev_bit;  // its bit
  int last;    // the last stop event's bit, or -1
};

__device__ __forceinline__ void note_event(WalkRec& r, int ev, int p) {
  if (r.ev == kNoEvent) r.ev = ev, r.ev_bit = p;
  r.last = p;
}

// Words [ws, ws + n) of the stream into win[i] (zeros past n_words), in
// 16-byte loads from the 16-byte boundary at or before word ws.
__device__ __forceinline__ void stage_window(Padded win, const unsigned* __restrict__ words,
                                             long long n_words, long long ws, int n) {
  const int lead = (int)(((uintptr_t)(words + ws) >> 2) & 3);
  const long long g_first = ws - lead;
  const int chunks = (lead + n + 3) >> 2;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const long long g = g_first + 4 * c;
    uint4 v;
    if (g >= 0 && g + 3 < n_words) {
      v = *reinterpret_cast<const uint4*>(words + g);
    } else {
      v.x = g >= 0 && g < n_words ? words[g] : 0u;
      v.y = g + 1 >= 0 && g + 1 < n_words ? words[g + 1] : 0u;
      v.z = g + 2 >= 0 && g + 2 < n_words ? words[g + 2] : 0u;
      v.w = g + 3 >= 0 && g + 3 < n_words ? words[g + 3] : 0u;
    }
    const int i = 4 * c - lead;
    if (i >= 0 && i < n) win[i] = v.x;
    if (i + 1 >= 0 && i + 1 < n) win[i + 1] = v.y;
    if (i + 2 >= 0 && i + 2 < n) win[i + 2] = v.z;
    if (i + 3 >= 0 && i + 3 < n) win[i + 3] = v.w;
  }
}

// The code at window bit p: its length (0 = no code matches) and symbol.
template <bool TwoLevel>
__device__ __forceinline__ int window_code(const Lut& lut, Padded w, int p, int& sym) {
  const unsigned x = __funnelshift_l(w[(p >> 5) + 1], w[p >> 5], p & 31);
  return lut_decode<TwoLevel>(lut, x, sym);
}

// One step of the walk at window bit p, `rem` = total_bits less the
// window's first bit, in the reference loop's order: the bits to advance
// (0: no bits left, rule 1), and in `ev` the stop this step meets (no match
// with < 32 or >= 32 bits left, rules 2-3, advancing one bit; a code longer
// than the bits left, rule 4) or kNoEvent for a code to emit.
template <bool TwoLevel>
__device__ __forceinline__ int walk_step(const Lut& lut, Padded w, int p, int rem,
                                         int& ev) {
  const int left = rem - p;
  if (left <= 0) {
    ev = kStreamOk;
    return 0;
  }
  int sym;
  const int ln = window_code<TwoLevel>(lut, w, p, sym);
  if (ln == 0) {
    ev = left >= 32 ? kStreamUnknownSymbol : kStreamOk;
    return 1;
  }
  ev = ln > left ? kStreamOk : kNoEvent;
  return ln;
}

__device__ __forceinline__ bool visited(Padded bm, int p) {
  return (bm[p >> 5] >> (p & 31)) & 1u;
}

__device__ __forceinline__ void visit(Padded bm, int p) { bm[p >> 5] |= 1u << (p & 31); }

// The bitmap's bits set in [lo, hi) (hi a multiple of 32).
__device__ __forceinline__ int count_starts(Padded bm, int lo, int hi) {
  int n = __popc(bm[lo >> 5] & (0xffffffffu << (lo & 31)));
  for (int i = (lo >> 5) + 1; (i << 5) < hi; ++i) n += __popc(bm[i]);
  return n;
}

// The bitmap's bits set in [lo, hi) (lo a multiple of 32).
__device__ __forceinline__ int count_below(Padded bm, int lo, int hi) {
  int n = 0;
  for (int i = lo >> 5; (i << 5) < hi; ++i) {
    const int k = hi - (i << 5);
    n += __popc(bm[i] & (k >= 32 ? 0xffffffffu : ((1u << k) - 1u)));
  }
  return n;
}

// The walk from window bit p to the slice's end `end`, marking each step
// start; `r` holds what came before p (a fresh walk: nothing).
template <bool TwoLevel>
__device__ __forceinline__ int walk_from(const Lut& lut, Padded w, Padded bm, int p,
                                         int end, int rem, WalkRec& r) {
  while (p < end) {
    int ev;
    const int step = walk_step<TwoLevel>(lut, w, p, rem, ev);
    if (step == 0) {  // no bits left: nothing past here decodes
      note_event(r, ev, p);
      return end;
    }
    if (ev != kNoEvent) {
      note_event(r, ev, p);
    } else if (r.ev == kNoEvent) {
      ++r.count;
    }
    visit(bm, p);
    p += step;
  }
  return p;
}

template <bool TwoLevel>
__device__ __forceinline__ WalkRec walk_marking(const Lut& lut, Padded w, Padded bm,
                                                int p, int end, int rem) {
  WalkRec r{0, 0, kNoEvent, 0, -1};
  r.exit = walk_from<TwoLevel>(lut, w, bm, p, end, rem, r);
  return r;
}

// The walk again from a changed entry `entry`, up to the first step start
// q that the previous walk `old` visited (marked in `cur`): from there the
// old exit holds, and the suffix's events are the old ones at or past q.
// Its first event and count follow from the old record when the old first
// event is at or past q, or when the old last event lies before q (the
// suffix has none: its codes are the old starts from q on); otherwise a
// walk from q, marking nothing, finds it. `nxt` gets the new walk's starts
// (the new prefix's, then the old ones from q on); the caller swaps the two.
// `branches`, where given (the probe), counts the re-walks, then those that
// joined and took their first event and count from the old record, from
// the old starts, or from the walk of the suffix.
template <bool TwoLevel>
__device__ __forceinline__ WalkRec rewalk(const Lut& lut, Padded w, Padded cur,
                                          Padded nxt, const WalkRec old, int entry, int lo,
                                          int end, int rem,
                                          unsigned long long* __restrict__ branches) {
  if (branches) atomicAdd(&branches[kRewalks], 1ull);
  for (int i = lo >> 5; i < end >> 5; ++i) nxt[i] = 0;
  WalkRec r{0, 0, kNoEvent, 0, -1};
  int q = entry;
  bool joined = false, past = false;
  while (q < end) {
    if (visited(cur, q)) {
      joined = true;
      break;
    }
    int ev;
    const int step = walk_step<TwoLevel>(lut, w, q, rem, ev);
    if (step == 0) {
      note_event(r, ev, q);
      past = true;
      break;
    }
    if (ev != kNoEvent) {
      note_event(r, ev, q);
    } else if (r.ev == kNoEvent) {
      ++r.count;
    }
    visit(nxt, q);
    q += step;
  }
  if (!joined) {
    r.exit = past ? end : q;
    return r;
  }
  const bool suffix_events = old.ev != kNoEvent && old.last >= q;
  r.exit = old.exit;
  if (r.ev == kNoEvent) {
    if (old.ev == kNoEvent || old.ev_bit >= q) {
      if (branches) atomicAdd(&branches[kJoinOldRecord], 1ull);
      r.count += old.count - count_below(cur, lo, q);
      r.ev = old.ev;
      r.ev_bit = old.ev_bit;
    } else if (!suffix_events) {
      if (branches) atomicAdd(&branches[kJoinOldStarts], 1ull);
      r.count += count_starts(cur, q, end);
    } else {
      if (branches) atomicAdd(&branches[kJoinSuffixWalk], 1ull);
      for (int p = q; p < end;) {
        int ev;
        const int step = walk_step<TwoLevel>(lut, w, p, rem, ev);
        if (ev != kNoEvent) {
          r.ev = ev;
          r.ev_bit = p;
          break;
        }
        ++r.count;
        p += step;
      }
    }
  }
  if (suffix_events) r.last = old.last;
  nxt[q >> 5] |= cur[q >> 5] & (0xffffffffu << (q & 31));
  for (int i = (q >> 5) + 1; i < end >> 5; ++i) nxt[i] = cur[i];
  return r;
}

// Exclusive prefix sum of v over the block, and its total in `total`.
__device__ __forceinline__ int block_scan(int v, int* wsum, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? wsum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    wsum[lane] = s;
  }
  __syncthreads();
  total = wsum[n_warps - 1];
  return (warp ? wsum[warp - 1] : 0) + x - v;
}

// buf[phase + i] -> dst[i] for i < n, where buf and dst - phase share their
// 16-byte alignment: whole chunks as 16-byte copies, consecutive lanes on
// consecutive chunks; the two partial chunks byte by byte.
__device__ __forceinline__ void copy_out(const uint8_t* buf, int phase, int n, uint8_t* dst) {
  const int end = phase + n;
  const int chunks = (end + 15) >> 4;
  for (int j = threadIdx.x; j < chunks; j += blockDim.x) {
    const int a = j << 4, b = a + 16;
    if (a >= phase && b <= end) {
      *reinterpret_cast<uint4*>(dst + (a - phase)) = *reinterpret_cast<const uint4*>(buf + a);
    } else {
      for (int k = max(a, phase); k < min(b, end); ++k) dst[k - phase] = buf[k];
    }
  }
}

// The whole walk, run by every thread of one block of T threads (a
// multiple of 32) with smem laid out as WalkLayout says. StageLut: the LUT
// in shared memory, the kernel's form (else read through the cache: the
// ablation's `block_global`). Write: the symbols are
// written (else only info and stats: the ablation's `none`). info gets
// (n_decoded, end_bit, status); stats, where given, (windows, the most
// sync rounds a window took); cycles, where given (the ablation), thread
// 0's clock cycles summed over the windows in staging, the speculative
// walks, the sync rounds, and the scan, write and copy out; branches, where
// given (the ablation), rewalk's kBranches counters.
template <bool TwoLevel, bool StageLut, bool Write>
__device__ __forceinline__ void stream_walk(
    unsigned char* smem, const unsigned* __restrict__ words, long long n_words,
    long long start_bit, long long total_bits, long long out_capacity,
    const int* __restrict__ l0_g, int root_bits, const int* __restrict__ l1_g,
    long long l1_size, int sub_bits, int overlap, int min_len, uint8_t* __restrict__ out,
    long long* __restrict__ info, long long* __restrict__ stats, long long* __restrict__ cycles,
    unsigned long long* __restrict__ branches) {
  const int T = blockDim.x, t = threadIdx.x;
  const int W = T * (sub_bits >> 5);
  const LutSmem lsm = lut_smem(root_bits, l1_size);
  const WalkLayout L(StageLut ? lsm.bytes : 0, T, W, min_len);
  const int sh = __ffs(sub_bits >> 5) - 1;  // slices of 2^sh words
  const Padded w{reinterpret_cast<unsigned*>(smem + L.win), sh};
  Padded cur{reinterpret_cast<unsigned*>(smem + L.bitmap), sh};  // this thread's words of
  Padded nxt{cur.p + W + T, sh};                                  // the two bitmaps
  int* exit_s = reinterpret_cast<int*>(smem + L.exits);
  int* ev_s = reinterpret_cast<int*>(smem + L.events);
  int* ev_bit_s = reinterpret_cast<int*>(smem + L.ev_bits);
  int* wsum = reinterpret_cast<int*>(smem + L.wsum);
  int* sc = reinterpret_cast<int*>(smem + L.scalars);  // first event thread, cut bit
  uint8_t* obuf = smem + L.out;

  Lut lut{l0_g, l1_g, root_bits};
  if (StageLut) {  // the first window's barrier covers it
    lut = copy_lut(reinterpret_cast<int*>(smem), l0_g, root_bits, l1_g, l1_size,
                   lsm.l1_in_smem);
  }
  const int lo = t * sub_bits, hi = lo + sub_bits;
  long long pos = start_bit, n_out = 0, windows = 0, end_bit = 0, status = kStreamOk;
  int max_rounds = 0;
  long long c_stage = 0, c_spec = 0, c_sync = 0, c_out = 0, c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  for (;;) {
    if (cycles) c0 = clock64();
    const long long ws = pos >> 5, base = ws << 5;
    const int e0 = (int)(pos - base);
    const long long rem64 = total_bits - base;
    const int rem =
        (int)(rem64 > (1 << 30) ? (1 << 30) : (rem64 < -(1 << 30) ? -(1 << 30) : rem64));
    // the window and two guard words, or up to the word after the stream's
    // last bit: no step reads past it (a step at bit p < rem reads words
    // p >> 5 and the next)
    const int n_stage = rem <= 0 ? 0 : min(W + 2, ((rem - 1) >> 5) + 2);
    stage_window(w, words, n_words, ws, n_stage);
    for (int i = lo >> 5; i < hi >> 5; ++i) cur[i] = 0;
    if (t == 0) sc[0] = T;
    __syncthreads();
    if (cycles) c1 = clock64();

    int entry = t == 0 ? e0 : lo - overlap;
    while (entry < lo && t > 0) {  // the guess: past the overlap's walk
      int sym;
      const int ln = rem - entry <= 0 ? lo - entry : window_code<TwoLevel>(lut, w, entry, sym);
      entry += ln ? ln : 1;
    }
    WalkRec r = walk_marking<TwoLevel>(lut, w, cur, entry, hi, rem);
    int rounds = 0;
    for (;;) {
      exit_s[t] = r.exit;
      __syncthreads();
      if (cycles && rounds == 0) c2 = clock64();
      const int ne = t == 0 ? e0 : exit_s[t - 1];
      const bool changed = ne != entry;
      if (!__syncthreads_or(changed)) break;
      ++rounds;
      if (changed) {
        r = rewalk<TwoLevel>(lut, w, cur, nxt, r, ne, lo, hi, rem, branches);
        const Padded was = cur;
        cur = nxt;
        nxt = was;
        entry = ne;
      }
    }
    if (cycles) c3 = clock64();
    max_rounds = max(max_rounds, rounds);
    ++windows;

    ev_s[t] = r.ev;
    ev_bit_s[t] = r.ev_bit;
    if (r.ev != kNoEvent) atomicMin(&sc[0], t);
    __syncthreads();
    const int te = sc[0];
    const int c = t <= te ? r.count : 0;
    int total;
    const int off = block_scan(c, wsum, total);
    const long long room = out_capacity - n_out;
    const bool cut = room < total;
    const long long fit = room - off;
    const int lim = fit <= 0 ? 0 : (fit < c ? (int)fit : c);
    const bool holds_cut = cut && off <= room && room < off + c;
    const int phase = (int)(((uintptr_t)out + n_out) & 15);
    if (lim > 0 || holds_cut) {
      int p = entry;
      for (int i = 0; i < lim; ++i) {
        int sym;
        const int ln = window_code<TwoLevel>(lut, w, p, sym);
        if (Write) obuf[phase + off + i] = (uint8_t)sym;
        p += ln;
      }
      if (holds_cut) sc[1] = p;
    }
    __syncthreads();
    const int n_win = cut ? (int)room : total;
    if (Write) copy_out(obuf, phase, n_win, out + n_out);
    if (cycles) {
      c_stage += c1 - c0;
      c_spec += c2 - c1;
      c_sync += c3 - c2;
      c_out += clock64() - c3;
    }
    if (cut) {
      n_out = out_capacity;
      end_bit = base + sc[1];
      status = kStreamOutputFull;
      break;
    }
    n_out += total;
    if (te < T) {
      end_bit = base + ev_bit_s[te];
      status = ev_s[te];
      break;
    }
    pos = base + exit_s[T - 1];
    __syncthreads();  // the next window's staging overwrites the buffers
  }
  if (t == 0) {
    info[0] = n_out;
    info[1] = end_bit;
    info[2] = status;
    if (stats) {
      stats[0] = windows;
      stats[1] = max_rounds;
    }
    if (cycles) {
      cycles[0] = c_stage;
      cycles[1] = c_spec;
      cycles[2] = c_sync;
      cycles[3] = c_out;
    }
  }
}

// Host side: the walk's shared memory, or 0 when the shape is refused.
inline size_t stream_walk_smem(int threads, int sub_bits, int overlap, int min_len,
                               int root_bits, long long l1_size, bool stage_lut) {
  if (threads < 32 || threads > 1024 || threads % 32 || sub_bits < 32 || overlap < 0 ||
      overlap > sub_bits ||
      (sub_bits & (sub_bits - 1)) || min_len < 1 || (long long)threads * sub_bits > (1LL << 24))
    return 0;
  const WalkLayout L(stage_lut ? lut_smem(root_bits, l1_size).bytes : 0, threads,
                     threads * (sub_bits >> 5), min_len);
  return L.bytes <= kMaxBlockSmem ? L.bytes : 0;
}

}  // namespace thc
