// Segment decode for the self-synchronising foreign-stream decode, for
// Hopper: one thread per segment of seg_bits bits.
//
// Replaces the Pallas kernel B4 `_make_selfsync_call`
// (tpu_huffman/ops/selfsync.py), in all three of the ways the TPU path
// calls it. A stream with no block index is cut into segments. The full
// pass decodes every segment from an entry-bit estimate; prefix codes
// resynchronise, so a chain started at a wrong bit joins the true codeword
// boundaries after a few symbols. Segment s's exit is segment s+1's true
// entry once segment s's chain has joined, so ops/selfsync.py then runs a
// short patch pass (a code cap) from those entries and stitches the patch's
// head onto the full pass's tail; from each of the few segments that do not
// join within the patch, a walk (below, a kernel of its own with no TPU
// counterpart) follows the true chain through the run of segments it
// starts, and those segments are re-decoded whole by a launch with segment
// ids. The fixpoint loop in ops/selfsync.py, which repeats the full pass
// until the entries stop changing, is the fallback for the segments that
// cannot be resolved so.
//
// Per thread, from the segment-relative int32 entry bit
// (thc::segment_loop, decode_loop.cuh): per step it takes the 32-bit window
// at the head of its stream register (thc::Cursor; reads past the stream
// give zeros) and looks it up in the LUT (both in lut.cuh). A code takes
// the row's next slot and advances by its length; a window no code matches
// records bad = 1 + its first invalid bit, advances 1 bit and takes no
// slot. The walk stops at the first codeword start at or past the
// segment's end, so every exit is >= seg_bits and every next entry lies in
// [0, max code length).
//
// Outputs: syms u8[T, pitch], a lane's symbols then 0 to the row's end;
// counts, exits (segment-relative) and bad, int32[T], by thread t.
//
// Optional outputs and inputs, each off with a null pointer or 0:
//   starts  int16 [T, pitch] (the TPU kernel's `emit_offs=True` form):
//           each emitted symbol's segment-relative start bit, in its slot,
//           then NO_START (32767) to the row's end, so each row ascends
//           (seg_bits <= 32767, checked by the wrapper). The stitch merges
//           and cuts at these: a chain that steps 1 bit at invalid windows
//           cannot be rebuilt from a cumsum of code lengths.
//   blast   int32 [T] (emit_offs's other output): 0, or 1 + the
//           segment-relative bit of the LAST invalid window. The stitch
//           takes the full pass's chain from a merge point on only when no
//           invalid window lies past it.
//   max_codes (the patch pass): stop once this many codes are emitted, or
//           at the segment's end; `exits` is where the thread stopped. The
//           TPU's patch counts an invalid 1-bit step as a slot; here it takes
//           none. A patch that meets an invalid window has bad != 0 and its
//           segment is unresolved either way.
//   seg_ids int32 [T] (the re-decode of the walked segments, as
//           `_dense_repair`'s window gather): thread t decodes segment
//           seg_ids[t] from entries[t]; a negative id is a dead lane that
//           writes nothing, so its rows keep what the caller's buffers held.
//
// Not carried over from the TPU kernel: the (8,128) lane tiles, the
// entry-roll select tree over a staged window, reusing one window for M
// symbols with a re-anchor every A symbols, u16 offsets packed two per u32
// word (here one int16 per slot) and the window rows gathered for a repair
// (here the thread reads its segment's words where they lie). Those shape
// vector registers and VMEM tiles; here each segment is an independent
// thread reading its words through the cache.
//
// The walk (thc_selfsync_walk, selfsync_walk_kernel): one thread a failed
// segment f of the stitch, f ascending by thread. From f's true entry it
// follows the chain through f and on into the segments after it while its
// exit differs from the full pass's, keeping only the chain's state (no
// rows) and appending (segment, thread, entry) to a list for each segment it
// crosses. It stops at an invalid window (the stitch then falls back) and at
// the last segment. A failure inside an earlier walk started from the full
// pass's wrong chain, and its walk can run on past that walk's end, so the
// last block to finish keeps the walks in order, each that starts past the
// last kept one's end (a scan over the threads' last segments, the warp
// computing it together through shuffles), and writes the kept walks'
// entries per segment. ops/selfsync.py re-decodes those segments and proves
// the chain on the device. A walk is one serial chain, latency-bound (one
// warp an SM: the threads are the few failed segments, so a block is one
// warp, spread over the SMs), so it steps over every code that lies whole
// in the window's top kWalkStepBits bits in one lookup of a second table
// in shared memory (`steps`, ops/selfsync.py walk_steps): a run of the 2-bit
// code of 0x00, which is what keeps a run of segments out of phase, goes
// six codes a lookup. The single-code lookup takes the rest: a longer
// code, an invalid window, the codes at the segment's end.
//
// Bound: stores first, then the serial chain. Rows lie `pitch` slots apart,
// so one store a symbol (and one a start) made every warp store touch 32
// sectors for 32 or 64 bytes, and that store traffic set the time of every
// form. Each lane now gathers its symbols and starts in registers and
// writes whole 32-byte sectors (thc::Emitter<kEmitSector>), then fills the
// rest of its row with 0 and NO_START, so the caller allocates the rows
// without a fill. ops/selfsync.py rounds the pitch up to 32 slots, so every
// row starts on a sector and its last flush is whole. The words come in at
// refills the whole warp makes at the same step, each loaded one refill
// ahead (thc::Cursor), and a table whose codes fit the LUT's level 0 gets a
// loop without the level-1 branch. What is left is each symbol's dependent
// lookup and shift; throughput comes from the segments in flight, S = stream
// bits / seg_bits on the full pass and the patch, at most max(256, S / 32)
// on a repair.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_loop.cuh"

namespace {

constexpr int kThreads = 128;

template <bool Starts, bool TwoLevel>
__global__ void selfsync_decode_kernel(
    const unsigned* __restrict__ words, long long n_words,
    const int* __restrict__ entries, const int* __restrict__ seg_ids,
    long long n_lanes, int seg_bits, int pitch, int max_codes,
    const int* __restrict__ l0_g, int root_bits, const int* __restrict__ l1_g,
    long long l1_size, int l1_in_smem, int group, uint8_t* __restrict__ syms,
    int16_t* __restrict__ starts, int* __restrict__ counts,
    int* __restrict__ exits, int* __restrict__ bad, int* __restrict__ blast) {
  extern __shared__ int smem[];
  const thc::Lut lut =
      thc::stage_lut(smem, l0_g, root_bits, l1_g, l1_size, l1_in_smem);
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_lanes) return;
  thc::segment_lane<thc::kEmitSector, Starts, TwoLevel>(
      lut, words, n_words, entries, seg_ids, t, seg_bits, pitch, max_codes, group, syms,
      starts, counts, exits, bad, blast);
}

constexpr int kWalkThreads = 32;  // one warp: the last block's scan is a warp's
constexpr int kWalkStepBits = 12;  // ops/selfsync.py WALK_STEP_BITS

// The walk through one segment from `rel` to its exit (the first code
// start at or past seg_bits); false at an invalid window, where the walk
// stops. A group of whole codes ends at or before seg_bits, so each of
// them starts before it, as a single step would have found.
template <bool TwoLevel>
__device__ __forceinline__ bool walk_segment(const thc::Lut& lut,
                                             const uint8_t* __restrict__ steps,
                                             thc::Cursor& cur, int& rel, int seg_bits) {
  while (rel < seg_bits) {
    cur.refill();  // leaves at least 33 bits: a step takes at most 32
    const unsigned win = cur.window();
    int step = steps[win >> (32 - kWalkStepBits)];
    if (step == 0 || rel + step > seg_bits) {
      int sym;
      step = thc::lut_decode<TwoLevel>(lut, win, sym);
      if (step == 0) return false;
    }
    rel += step;
    cur.advance(step);
  }
  return true;
}

template <bool TwoLevel>
__global__ void __launch_bounds__(kWalkThreads) selfsync_walk_kernel(
    const unsigned* __restrict__ words, long long n_words,
    const int* __restrict__ seg_ids, const int* __restrict__ entries, int n_lanes,
    const int* __restrict__ exits0, int n_segs, int seg_bits,
    const int* __restrict__ l0_g, int root_bits, const int* __restrict__ l1_g,
    long long l1_size, int l1_in_smem, int lut_bytes, const int* __restrict__ steps_g,
    int* ends, long long* pairs, long long cap, unsigned* counters,
    int* __restrict__ claim) {
  extern __shared__ int smem[];
  int* steps_s = smem + lut_bytes / 4;
  for (int i = threadIdx.x; i < (1 << kWalkStepBits) / 4; i += kWalkThreads)
    steps_s[i] = steps_g[i];
  const thc::Lut lut =
      thc::stage_lut(smem, l0_g, root_bits, l1_g, l1_size, l1_in_smem);
  const uint8_t* steps = reinterpret_cast<const uint8_t*>(steps_s);
  const int lane = threadIdx.x;
  const int t = blockIdx.x * kWalkThreads + lane;
  if (t < n_lanes) {
    int s = seg_ids[t];
    int rel = entries[s];
    thc::Cursor cur(words, n_words, (long long)s * seg_bits + rel);
    for (;;) {
      const unsigned long long p = atomicAdd(&counters[0], 1u);
      if (p < (unsigned long long)cap)
        pairs[p] = (long long)s << 32 | (long long)t << 8 | rel;
      if (!walk_segment<TwoLevel>(lut, steps, cur, rel, seg_bits) || rel == exits0[s] ||
          s + 1 >= n_segs)
        break;
      rel -= seg_bits;  // the cursor is already there
      ++s;
    }
    ends[t] = s;
  }
  // the last block to finish (threadFenceReduction's pattern)
  __threadfence();
  __syncwarp();
  unsigned done = 0;
  if (lane == 0) done = atomicAdd(&counters[1], 1u);
  if (__shfl_sync(0xffffffffu, done, 0) != gridDim.x - 1) return;
  __threadfence();
  // keep each walk that starts past the last kept one's end: every thread
  // runs the same scan, thread j of a round reading walk base + j's bounds
  int reach = -1;
  for (int base = 0; base < n_lanes; base += kWalkThreads) {
    const int i = base + lane;
    const int st = i < n_lanes ? seg_ids[i] : INT_MIN;
    const int en = i < n_lanes ? __ldcg(ends + i) : 0;
    bool mine = false;
#pragma unroll
    for (int j = 0; j < kWalkThreads; ++j) {
      const int sj = __shfl_sync(0xffffffffu, st, j);
      const int ej = __shfl_sync(0xffffffffu, en, j);
      const bool keep = sj > reach;
      reach = keep ? ej : reach;
      mine = j == lane ? keep : mine;
    }
    if (i < n_lanes) ends[i] = mine ? en : -1;
  }
  __syncwarp();
  __threadfence_block();
  const unsigned long long used = min((unsigned long long)cap,
                                      (unsigned long long)__ldcg(&counters[0]));
  for (unsigned long long p = lane; p < used; p += kWalkThreads) {
    const long long pr = __ldcg(pairs + p);
    if (__ldcg(ends + ((pr >> 8) & 0xffffff)) >= 0) claim[pr >> 32] = (int)(pr & 0xff);
  }
}

}  // namespace

extern "C" {

// syms holds n_lanes * pitch bytes, starts is null or holds n_lanes * pitch
// int16; the kernel writes every slot of a live lane's rows, so neither
// needs a fill. seg_ids and blast are null or hold n_lanes int32; entries,
// counts, exits and bad hold n_lanes int32. max_codes 0 means no cap;
// max_len is the table's longest code. `device` (the tensors' CUDA device) is
// made current before the launch on `stream`.
int thc_selfsync_decode(int device, const void* words, long long n_words,
                        const void* entries, const void* seg_ids,
                        long long n_lanes, int seg_bits, int pitch,
                        int max_codes, const void* l0, int root_bits,
                        const void* l1, long long l1_size, int max_len, void* syms,
                        void* starts, void* counts, void* exits, void* bad,
                        void* blast, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const thc::LutSmem smem = thc::lut_smem(root_bits, l1_size);
  const unsigned grid = (unsigned)((n_lanes + kThreads - 1) / kThreads);
  const bool two = thc::two_level(root_bits, max_len);
  auto kernel = starts ? (two ? selfsync_decode_kernel<true, true>
                              : selfsync_decode_kernel<true, false>)
                       : (two ? selfsync_decode_kernel<false, true>
                              : selfsync_decode_kernel<false, false>);
  kernel<<<grid, kThreads, smem.bytes, (cudaStream_t)stream>>>(
      (const unsigned*)words, n_words, (const int*)entries,
      (const int*)seg_ids, n_lanes, seg_bits, pitch, max_codes,
      (const int*)l0, root_bits, (const int*)l1, l1_size, smem.l1_in_smem,
      thc::refill_group(max_len), (uint8_t*)syms, (int16_t*)starts, (int*)counts,
      (int*)exits, (int*)bad, (int*)blast);
  return (int)cudaGetLastError();
}

// The walk: seg_ids (ascending, >= 0) hold n_lanes int32, entries and
// exits0 n_segs int32; steps the 2^kWalkStepBits bytes of the walk table; ends n_lanes int32 (out: the last segment of each
// kept walk, -1 for a dropped one); pairs holds cap int64 (the list; a walk
// past it is not kept whole, which the stitch's proof catches); counters
// two uint32 and claim n_segs int32, which the caller fills with 0 and -1.
// n_lanes < 2^24: a thread's number takes 24 bits of a pair.
int thc_selfsync_walk(int device, const void* words, long long n_words,
                      const void* seg_ids, const void* entries, int n_lanes,
                      const void* exits0, int n_segs, int seg_bits, const void* l0,
                      int root_bits, const void* l1, long long l1_size, int max_len,
                      const void* steps, void* ends, void* pairs, long long cap,
                      void* counters, void* claim, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const thc::LutSmem smem = thc::lut_smem(root_bits, l1_size, 1 << kWalkStepBits);
  const unsigned grid = (unsigned)((n_lanes + kWalkThreads - 1) / kWalkThreads);
  auto kernel = thc::two_level(root_bits, max_len) ? selfsync_walk_kernel<true>
                                                   : selfsync_walk_kernel<false>;
  kernel<<<grid, kWalkThreads, smem.bytes + (1 << kWalkStepBits), (cudaStream_t)stream>>>(
      (const unsigned*)words, n_words, (const int*)seg_ids, (const int*)entries, n_lanes,
      (const int*)exits0, n_segs, seg_bits, (const int*)l0, root_bits, (const int*)l1,
      l1_size, smem.l1_in_smem, (int)smem.bytes, (const int*)steps, (int*)ends,
      (long long*)pairs, cap, (unsigned*)counters, (int*)claim);
  return (int)cudaGetLastError();
}

}  // extern "C"
