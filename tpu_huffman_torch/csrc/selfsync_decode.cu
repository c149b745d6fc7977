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

}  // extern "C"
