// Segment decode for the self-synchronising foreign-stream decode, for
// Hopper: one thread per segment of seg_bits bits.
//
// Replaces the Pallas kernel B4 `_make_selfsync_call`
// (tpu_huffman/ops/selfsync.py). A stream with no block index is cut into
// segments; each pass decodes every segment from an entry-bit estimate, and
// the host loop in ops/selfsync.py feeds segment s's exit back as segment
// s+1's entry until the entries stop changing. Prefix codes resynchronise,
// so a chain started at a wrong bit joins the true codeword boundaries after
// a few symbols, and two or three passes usually suffice.
//
// Per thread, from the segment-relative int32 entry bit: per step it
// funnel-shifts a 32-bit window from the global words (reads past the stream
// give zeros) and looks it up in the LUT (both in lut.cuh). A code writes its
// symbol byte to syms[s, count] and advances by its length; a window no code
// matches records bad = 1 + its first invalid bit, advances 1 bit and takes
// no output slot. The walk stops at the first codeword start at or past the
// segment's end, so every exit is >= seg_bits and every next entry lies in
// [0, max code length). Outputs: syms u8[S, max_syms], counts, exits
// (segment-relative) and bad, int32[S].
//
// Optional output `starts` (the TPU kernel's `emit_offs=True` form): when
// the caller passes the buffer, int16 [S, max_syms], each emitted symbol's
// segment-relative start bit goes into the same slot as its byte (seg_bits
// <= 32767, checked by the wrapper); a null pointer turns it off. The
// capped streaming drain cuts at these starts and counts the symbols before
// an invalid window with them: a chain that steps 1 bit at invalid windows
// cannot be rebuilt from a cumsum of code lengths. The TPU form's other
// extra output, the last invalid-window bit, has no user on this path; it
// waits for the one-pass + patch stitch (_segments_pipeline_fast), which
// needs it.
//
// Not carried over from the TPU kernel: the (8,128) lane tiles, the
// entry-roll select tree over a staged window, reusing one window for M
// symbols with a re-anchor every A symbols, and u16 offsets packed two per
// u32 word (here one int16 per slot). Those shape vector registers and VMEM
// tiles; here each segment is an independent thread reading its words
// through the cache.
//
// Bound: the serial per-symbol dependency inside a segment (a shared-memory
// lookup and a funnel shift per symbol), as in chain_decode.cu; throughput
// comes from the S segments in flight, S = stream bits / seg_bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "lut.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void selfsync_decode_kernel(
    const unsigned* __restrict__ words, long long n_words,
    const int* __restrict__ entries, long long n_segs, int seg_bits,
    int max_syms, const int* __restrict__ l0_g, int root_bits,
    const int* __restrict__ l1_g, long long l1_size, int l1_in_smem,
    uint8_t* __restrict__ syms, int16_t* __restrict__ starts,
    int* __restrict__ counts, int* __restrict__ exits, int* __restrict__ bad) {
  extern __shared__ int smem[];
  const thc::Lut lut =
      thc::stage_lut(smem, l0_g, root_bits, l1_g, l1_size, l1_in_smem);

  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_segs) return;
  const long long seg_start = s * seg_bits;
  uint8_t* row = syms + s * max_syms;
  int16_t* start_row = starts ? starts + s * max_syms : nullptr;
  int rel = entries[s];  // segment-relative bit, >= 0
  thc::Cursor cur(words, n_words, seg_start + rel);
  int count = 0;
  int first_bad = 0;
  while (rel < seg_bits) {
    int sym;
    const int ln = thc::lut_decode(lut, cur.window(), sym);
    int step = ln;
    if (ln == 0) {
      if (first_bad == 0) first_bad = rel + 1;
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
  counts[s] = count;
  exits[s] = rel;
  bad[s] = first_bad;
}

}  // namespace

extern "C" {

// syms holds n_segs * max_syms bytes, zeroed by the caller; starts is null
// or holds n_segs * max_syms int16; entries, counts, exits and bad hold
// n_segs int32. `device` (the tensors' CUDA device) is made current before
// the launch on `stream`.
int thc_selfsync_decode(int device, const void* words, long long n_words,
                        const void* entries, long long n_segs, int seg_bits,
                        int max_syms, const void* l0, int root_bits,
                        const void* l1, long long l1_size, void* syms,
                        void* starts, void* counts, void* exits, void* bad,
                        void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const thc::LutSmem smem = thc::lut_smem(root_bits, l1_size);
  const unsigned grid = (unsigned)((n_segs + kThreads - 1) / kThreads);
  selfsync_decode_kernel<<<grid, kThreads, smem.bytes, (cudaStream_t)stream>>>(
      (const unsigned*)words, n_words, (const int*)entries, n_segs, seg_bits,
      max_syms, (const int*)l0, root_bits, (const int*)l1, l1_size,
      smem.l1_in_smem, (uint8_t*)syms, (int16_t*)starts, (int*)counts,
      (int*)exits, (int*)bad);
  return (int)cudaGetLastError();
}

}  // extern "C"
