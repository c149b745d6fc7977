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
// head onto the full pass's tail; the few segments that do not join within
// the patch are re-decoded whole by a repair launch (segment ids). The
// fixpoint loop in ops/selfsync.py, which repeats the full pass until the
// entries stop changing, is the fallback for the segments that cannot be
// resolved so.
//
// Per thread, from the segment-relative int32 entry bit: per step it
// funnel-shifts a 32-bit window from the global words (reads past the stream
// give zeros) and looks it up in the LUT (both in lut.cuh). A code writes its
// symbol byte to syms[t, count] and advances by its length; a window no code
// matches records bad = 1 + its first invalid bit, advances 1 bit and takes
// no output slot. The walk stops at the first codeword start at or past the
// segment's end, so every exit is >= seg_bits and every next entry lies in
// [0, max code length). Outputs: syms u8[T, max_syms], counts, exits
// (segment-relative) and bad, int32[T], by thread t.
//
// Optional outputs and inputs, each off with a null pointer or 0:
//   starts  int16 [T, max_syms] (the TPU kernel's `emit_offs=True` form):
//           each emitted symbol's segment-relative start bit, in its slot
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
//   seg_ids int32 [T] (the repair launch, `_dense_repair`'s window gather):
//           thread t decodes segment seg_ids[t] from entries[t]; a negative id
//           is a dead lane that writes nothing.
//
// Not carried over from the TPU kernel: the (8,128) lane tiles, the
// entry-roll select tree over a staged window, reusing one window for M
// symbols with a re-anchor every A symbols, u16 offsets packed two per u32
// word (here one int16 per slot) and the window rows gathered for a repair
// (here the thread reads its segment's words where they lie). Those shape
// vector registers and VMEM tiles; here each segment is an independent
// thread reading its words through the cache.
//
// Bound: the serial per-symbol dependency inside a segment (a shared-memory
// lookup and a funnel shift per symbol), as in chain_decode.cu; throughput
// comes from the segments in flight, S = stream bits / seg_bits on the full
// pass and the patch, at most 256 on a repair.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "lut.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void selfsync_decode_kernel(
    const unsigned* __restrict__ words, long long n_words,
    const int* __restrict__ entries, const int* __restrict__ seg_ids,
    long long n_lanes, int seg_bits, int max_syms, int max_codes,
    const int* __restrict__ l0_g, int root_bits, const int* __restrict__ l1_g,
    long long l1_size, int l1_in_smem, uint8_t* __restrict__ syms,
    int16_t* __restrict__ starts, int* __restrict__ counts,
    int* __restrict__ exits, int* __restrict__ bad, int* __restrict__ blast) {
  extern __shared__ int smem[];
  const thc::Lut lut =
      thc::stage_lut(smem, l0_g, root_bits, l1_g, l1_size, l1_in_smem);

  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_lanes) return;
  const long long s = seg_ids ? (long long)seg_ids[t] : t;
  if (s < 0) return;  // a dead lane of a repair launch
  const long long seg_start = s * seg_bits;
  uint8_t* row = syms + t * max_syms;
  int16_t* start_row = starts ? starts + t * max_syms : nullptr;
  const int cap = max_codes > 0 ? max_codes : INT_MAX;
  int rel = entries[t];  // segment-relative bit, >= 0
  thc::Cursor cur(words, n_words, seg_start + rel);
  int count = 0;
  int first_bad = 0;
  int last_bad = 0;
  while (rel < seg_bits && count < cap) {
    int sym;
    const int ln = thc::lut_decode(lut, cur.window(), sym);
    int step = ln;
    if (ln == 0) {
      if (first_bad == 0) first_bad = rel + 1;
      last_bad = rel + 1;
      step = 1;
    } else {
      if (count < max_syms) {  // always true for entries >= 0
        row[count] = (uint8_t)sym;
        if (start_row) start_row[count] = (int16_t)rel;
      }
      ++count;
    }
    rel += step;
    cur.advance(step);
  }
  counts[t] = count;
  exits[t] = rel;
  bad[t] = first_bad;
  if (blast) blast[t] = last_bad;
}

}  // namespace

extern "C" {

// syms holds n_lanes * max_syms bytes, zeroed by the caller; starts is null
// or holds n_lanes * max_syms int16; seg_ids and blast are null or hold
// n_lanes int32; entries, counts, exits and bad hold n_lanes int32.
// max_codes 0 means no cap. `device` (the tensors' CUDA device) is made
// current before the launch on `stream`.
int thc_selfsync_decode(int device, const void* words, long long n_words,
                        const void* entries, const void* seg_ids,
                        long long n_lanes, int seg_bits, int max_syms,
                        int max_codes, const void* l0, int root_bits,
                        const void* l1, long long l1_size, void* syms,
                        void* starts, void* counts, void* exits, void* bad,
                        void* blast, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const thc::LutSmem smem = thc::lut_smem(root_bits, l1_size);
  const unsigned grid = (unsigned)((n_lanes + kThreads - 1) / kThreads);
  selfsync_decode_kernel<<<grid, kThreads, smem.bytes, (cudaStream_t)stream>>>(
      (const unsigned*)words, n_words, (const int*)entries,
      (const int*)seg_ids, n_lanes, seg_bits, max_syms, max_codes,
      (const int*)l0, root_bits, (const int*)l1, l1_size, smem.l1_in_smem,
      (uint8_t*)syms, (int16_t*)starts, (int*)counts, (int*)exits, (int*)bad,
      (int*)blast);
  return (int)cudaGetLastError();
}

}  // extern "C"
