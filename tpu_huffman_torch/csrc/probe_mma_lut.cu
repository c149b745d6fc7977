// A 256-entry table lookup on the tensor cores: a one-hot row times the
// table, in bf16 with f32 accumulation.
//
// Replaces the Pallas probe scripts/prof/prof_mxu_lut.py's f_onehot (:152,
// body k_onehot :127), the MXU one-hot lookup of P6, and the one-column
// case of scripts/prof/prof_kernel_lut.py's k_onehot (:93, run :37).
//
// Four kernels compute it:
//
// mma_lut_kernel (modes 0-4), by mma.sync.m16n8k16. The table is a
// (256, 8) bf16 matrix B, column-major fragments kept in registers for
// the whole kernel (16 k-steps x 2 registers a thread). Each warp looks up
// 32 elements a round as two m16 tiles: the A fragment of tile h is the
// one-hot of its 16 indexes, built in registers (an index's 1 lies in
// k-step idx >> 4, column idx & 15), and 16 mma.sync k-steps give C =
// onehot(idx) @ B. Thread (g, t) = (lane >> 2, lane & 3) owns rows g and
// g + 8 of both tiles, elements g, g + 8, 16 + g and 24 + g of the warp's
// 32, and computes their indexes itself, so no index is shuffled. Two
// tables:
//   wide:  columns [pattern >> 24, >> 16, >> 8, & 255, length, 0, 0, 0];
//          threads t = 0, 1 XOR their two bytes into the pattern, t = 2
//          adds the length; one reduction over the four threads at the end
//          (out = XOR patterns ^ SUM lengths, as lut_wide);
//   chain: every column the table's low byte, so every thread of the
//          group reads T[x] for its own rows in C and the chain
//          x = (T[x] (+ r)) & 255 goes on without a shuffle (as lut_chain).
// Modes 3 and 4 split the wide mode's time: 3 keeps the mma and the
// epilogue but builds no one-hot a k-step (the round's column, idx & 15,
// hot in all 16 k-steps: C = SUM_j T[16j + (idx & 15)]), 4 keeps the build
// and the epilogue but drops the mma (two LOP3 a k-step fold the fragments
// so that the build stays; C stays 0).
//
// wgmma_wide_kernel (modes 5, 6), by wgmma.mma_async.m64n8k16 (sm_90a):
// a warpgroup looks up 64 elements a round, A (the one-hot) from
// registers, B (the table, 4 KB) from shared memory through a matrix
// descriptor, staged once a block. A round's k-steps are committed as one
// group of 16 (mode 5) or two groups of 8 (mode 6), and the next group's
// fragments are built while the last one runs: its A registers stay
// untouched until wgmma.wait_group 1 retires it. Two accumulator sets
// alternate between rounds. ptxas pipelines mode 6; mode 5 it serializes
// (note C7514: it schedules the epilogue's reads of one accumulator set
// inside the stage of the group that rewrites it).
//
// sync_tiles_kernel (mode 7, the fastest), by mma.sync again: four
// independent tiles (64 elements) a warp, interleaved by k-step, B's
// fragments read from shared memory (one 8-byte load a k-step for four
// mma), 2 blocks of 256 an SM.
//
// chain_nibble_kernel (modes 8, 9), P1's chain x = (T[x] (+ r)) & 255 by
// mma.sync with the 256-wide one-hot factored: the table is a 16 x 16 B,
// B[lo][hi] = T[16 hi + lo] & 255, so a row's one-hot is 16 wide, over
// lo = x & 15, and one k-step covers the table (4 B registers a thread).
// A tile-round starts with two independent m16n8k16 (hi 0-7 and hi 8-15):
// 2 * 16 * 16 flops a lookup, the TPU product's 512, where
// mma_lut_kernel's chain modes spend 16 dependent k-steps, 4096 flops, on
// a K of 256. Row g's answer is then column hi = x >> 4 of C. The two
// products run in fp16, so that C comes out in the layout of an A
// fragment over hi; four set.eq of the high nibble and four mul.f16x2
// keep column hi alone, and a third m16n8k16 against a B of ones (its C
// operand 1024 + r) sums each row, so every thread of the group holds
// 1024 + T[x] (+ r), exact in fp16, whose bits' low byte is the next
// index: no shuffle, no integer select. kNibbleTiles independent tiles a
// warp hide the HMMA latencies.
//
// Modes 5-9 build the one-hot with one set.eq.f16x2 an A register (4 a
// k-step, where mode 0 takes 2 ISETP and 4 SEL; HotKeys below). Modes 5-7
// share an epilogue with no branch on t: each column becomes 128 c + 1.5 * 2^23,
// whose bits hold the entry in the low byte and zeros above it; one
// byte_perm with a per-thread selector places the two bytes (t = 0, 1) or
// nothing (t = 2, 3), and every thread adds the bits of its first column
// (the length for t = 2). At the end a thread keeps its pattern or (t = 2)
// its length, and one XOR over the four threads gives XOR patterns ^ SUM
// lengths.
//
// Integers <= 255 are exact in bf16 and their one-hot sums exact in f32.
//
// Bound: tensor-core operations, over the card's bf16 rate. Modes 0-7
// execute 2 * 256 * 8 flops a lookup (the one-hot's K of 256 is the cost:
// only one of its 16 k-steps holds the 1); the one-hot's construction runs
// beside it: a thread writes 4 A registers a k-step (rows g and g + 8,
// columns 2t..2t+1 and 2t+8..2t+9), 4 warp-instructions for 16 lookups a
// k-step at least. mma.sync at N = 8 reaches about half the bf16 rate,
// and the build's instructions do not all hide under it. Modes 8 and 9
// execute the TPU product's 2 * 256 flops a lookup (the row sum's third
// product adds 2 * 16 * 8 on the ones). Their instructions, not the
// tensor cores' flops, bound them: a tile-round is 3 HMMA, 8 set.eq,
// 4 mul.f16x2 and a few integer instructions.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kOneLo = 0x3F80u;       // bf16 1.0 in the low half
constexpr unsigned kOneHi = 0x3F800000u;   // bf16 1.0 in the high half
constexpr float kMagic = 12582912.0f;      // 1.5 * 2^23: bits 0x4B400000 + x for x < 2^22
constexpr unsigned kMagicBits = 0x4B400000u;

enum Split : int { kFull_ = 0, kMmaOnly = 1, kBuildOnly = 2 };

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One index's one-hot row as thread t holds it: its k-step, and the A
// register pairs for columns (2t, 2t + 1) and (2t + 8, 2t + 9).
struct OneHot {
  unsigned step, lo, hi;
  __device__ __forceinline__ OneHot() {}
  __device__ __forceinline__ OneHot(unsigned idx, unsigned t) {
    const unsigned hot = (idx & 1u) ? kOneHi : kOneLo;
    const unsigned pair = (idx & 15u) >> 1;
    step = idx >> 4;
    lo = pair == t ? hot : 0u;
    hi = pair == t + 4u ? hot : 0u;
  }
};

// The A fragment of k-step j for rows (r0, r1): one predicate a row.
__device__ __forceinline__ void fragment(unsigned (&a)[4], const OneHot& r0, const OneHot& r1,
                                         unsigned j) {
  const bool p0 = r0.step == j, p1 = r1.step == j;
  a[0] = p0 ? r0.lo : 0u;
  a[1] = p1 ? r1.lo : 0u;
  a[2] = p0 ? r0.hi : 0u;
  a[3] = p1 ? r1.hi : 0u;
}

// d = onehot(rows g, g + 8) @ B: d[0], d[1] = C[g][2t], C[g][2t + 1];
// d[2], d[3] = C[g + 8][2t], C[g + 8][2t + 1]. Split kMmaOnly puts the
// row's column hot in every k-step (no select a k-step); kBuildOnly XORs
// the fragments together in place of the mma and leaves C at 0 (the XOR
// of halves 0x3F80 never equals kNever, but the compiler cannot drop the
// build; B goes unread, so its registers are free).
constexpr unsigned kNever = 0x12345678u;
template <int S>
__device__ __forceinline__ void lookup_tile(float (&d)[4], unsigned idx_g, unsigned idx_g8,
                                            unsigned t, const unsigned (&b)[16][2]) {
  const OneHot r0(idx_g, t), r1(idx_g8, t);
  d[0] = d[1] = d[2] = d[3] = 0.f;
  unsigned folded = 0u;
#pragma unroll
  for (unsigned j = 0; j < 16; ++j) {
    unsigned a[4];
    if constexpr (S == kMmaOnly) {
      a[0] = r0.lo, a[1] = r1.lo, a[2] = r0.hi, a[3] = r1.hi;
    } else {
      fragment(a, r0, r1, j);
    }
    if constexpr (S == kBuildOnly) {
      folded ^= a[0] ^ a[1];
      folded ^= a[2] ^ a[3];
    } else {
      mma_bf16(d, a, b[j][0], b[j][1]);
    }
  }
  if constexpr (S == kBuildOnly) d[0] = d[1] = d[2] = d[3] = folded == kNever ? 1.f : 0.f;
}

__device__ __forceinline__ unsigned u(float f) { return __float2uint_rn(f); }

// tab: the (256, 8) bf16 table, row-major, as raw 16-bit values.
template <bool Wide, bool Acc, int S>
__global__ void mma_lut_kernel(const int* __restrict__ x, const unsigned short* __restrict__ tab,
                               int rounds, int* __restrict__ out, long long n) {
  const unsigned lane = threadIdx.x & 31u, g = lane >> 2, t = lane & 3u;
  unsigned b[16][2];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int k = 16 * j + 2 * (int)t;
    b[j][0] = (unsigned)__ldg(tab + k * 8 + g) | ((unsigned)__ldg(tab + (k + 1) * 8 + g) << 16);
    b[j][1] = (unsigned)__ldg(tab + (k + 8) * 8 + g) |
              ((unsigned)__ldg(tab + (k + 9) * 8 + g) << 16);
  }
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long base = warp * 32; base < n; base += n_warps * 32) {
    const long long e[4] = {base + g, base + g + 8, base + 16 + g, base + 24 + g};
    unsigned v[4], accp[4] = {0u, 0u, 0u, 0u}, accl[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = e[q] < n ? (unsigned)x[e[q]] & 255u : 0u;
#pragma unroll 1
    for (int r = 0; r < rounds; ++r) {
      unsigned idx[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) idx[q] = Wide ? (v[q] + (unsigned)r) & 255u : v[q];
      float d[2][4];
      lookup_tile<S>(d[0], idx[0], idx[1], t, b);
      lookup_tile<S>(d[1], idx[2], idx[3], t, b);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float c0 = d[q >> 1][2 * (q & 1)], c1 = d[q >> 1][2 * (q & 1) + 1];
        if constexpr (Wide) {
          if (t == 0) {
            accp[q] ^= (u(c0) << 24) | (u(c1) << 16);
          } else if (t == 1) {
            accp[q] ^= (u(c0) << 8) | u(c1);
          } else if (t == 2) {
            accl[q] += u(c0);
          }
        } else {
          v[q] = (Acc ? u(c0) + (unsigned)r : u(c0)) & 255u;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (Wide) {
        // the group's four threads hold the pattern's halves and the length
        unsigned p = accp[q], l = accl[q];
        p ^= __shfl_xor_sync(kFull, p, 1);
        p ^= __shfl_xor_sync(kFull, p, 2);
        l += __shfl_xor_sync(kFull, l, 1);
        l += __shfl_xor_sync(kFull, l, 2);
        v[q] = p ^ l;
      }
      if (t == 0 && e[q] < n) out[e[q]] = (int)v[q];
    }
  }
}

// ---- the one-hot of modes 5-7: one set.eq.f16x2 an A register ----------

// A thread's A register for a row and a column pair is 0 but where the
// row's index is hot in that pair at k-step j. Keep, for each such register
// a half2 "key": lane L is 1024 + step (fp16, exact) where column (pair, L)
// is the row's hot column, else 2047, which no k-step matches. Then the
// register of k-step j is set.eq.f16x2(key, (1024 + j) x 2): fp16 1.0
// (0x3C00) in the hot lane, else 0, one instruction. 0x3C00 read as bf16 is
// 2^-7, so the product is C = 2^-7 T[idx], exact in f32, and the epilogue
// multiplies by 128.
constexpr unsigned kKey0 = 0x6400u;     // fp16 1024.0
constexpr unsigned kNoKey = 0x67FFu;    // fp16 2047.0
constexpr unsigned kNoKeys = kNoKey * 0x10001u;
constexpr float kUnscale = 128.0f;      // 1 / (fp16 1.0 read as bf16)

struct HotKeys {
  unsigned lo, hi;  // columns (2t, 2t + 1) and (2t + 8, 2t + 9)
  __device__ __forceinline__ HotKeys() {}
  __device__ __forceinline__ HotKeys(unsigned idx, unsigned t) {
    const unsigned key = kKey0 + (idx >> 4);
    const unsigned lanes = (idx & 1u) ? (key << 16) | kNoKey : (kNoKey << 16) | key;
    const unsigned pair = (idx & 15u) >> 1;
    lo = pair == t ? lanes : kNoKeys;
    hi = pair == t + 4u ? lanes : kNoKeys;
  }
};

__device__ __forceinline__ unsigned set_eq_f16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("set.eq.f16x2.f16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The A fragment of k-step j for rows (r0, r1): four instructions.
__device__ __forceinline__ void hot_fragment(unsigned (&a)[4], const HotKeys& r0,
                                             const HotKeys& r1, unsigned j) {
  const unsigned kj = (kKey0 + j) * 0x10001u;
  a[0] = set_eq_f16x2(r0.lo, kj);
  a[1] = set_eq_f16x2(r1.lo, kj);
  a[2] = set_eq_f16x2(r0.hi, kj);
  a[3] = set_eq_f16x2(r1.hi, kj);
}

// ---- the branch-free wide epilogue (modes 5-7) ---------------------------

// byte_perm selector of thread t: t = 0 places C0, C1 as pattern >> 24,
// >> 16; t = 1 C2, C3 as >> 8, & 255; t = 2, 3 nothing (byte 1 of a
// magic-offset value is 0).
__device__ __forceinline__ unsigned wide_selector(unsigned t) {
  return t == 0 ? 0x0411u : t == 1 ? 0x1104u : 0x1111u;
}

// The bits of 128 c + 1.5 * 2^23: 0x4B400000 + the entry.
__device__ __forceinline__ unsigned entry_bits(float c) {
  return __float_as_uint(fmaf(c, kUnscale, kMagic));
}

// One row's round, c0 and c1 its two columns, counted if `valid`.
__device__ __forceinline__ void wide_round(unsigned& accp, unsigned& accl, float c0, float c1,
                                           unsigned sel, bool valid) {
  const unsigned b0 = entry_bits(c0), b1 = entry_bits(c1);
  accp ^= valid ? __byte_perm(b0, b1, sel) : 0u;
  accl += valid ? b0 : 0u;
}

// A row's result after `rounds`, XORed over the four threads of its group.
__device__ __forceinline__ unsigned wide_result(unsigned accp, unsigned accl, unsigned t,
                                                int rounds) {
  unsigned w = t == 2 ? accl - (unsigned)rounds * kMagicBits : accp;
  w ^= __shfl_xor_sync(kFull, w, 1);
  w ^= __shfl_xor_sync(kFull, w, 2);
  return w;
}

// ---- wgmma (modes 5, 6) ----------------------------------------------------

// The table as B of wgmma, K-major without swizzle: 32 core matrices of
// 8 columns x 8 K values (16 bytes a column, 128 bytes a core matrix),
// element (k, n) at byte (k >> 3) * 128 + n * 16 + (k & 7) * 2. K-step j
// reads core matrices 2j and 2j + 1.
__device__ __forceinline__ void stage_table_kmajor(const unsigned short* __restrict__ tab,
                                                   unsigned short* s) {
  for (int e = threadIdx.x; e < 256 * 8; e += blockDim.x) {
    const int k = e >> 3, c = e & 7;
    s[(k >> 3) * 64 + c * 8 + (k & 7)] = tab[e];
  }
}

// The matrix descriptor of k-step j: start address >> 4 (bits 0-13), the
// leading and stride byte offsets >> 4 (bits 16-29, 32-45; both 128 bytes:
// the next core matrix along K, and the one 8-column group of N = 8), no
// swizzle (bits 62-63 zero).
__device__ __forceinline__ unsigned long long table_desc(unsigned smem_addr, int j) {
  const unsigned long long start = ((smem_addr + 256u * (unsigned)j) & 0x3FFFFu) >> 4;
  return start | (8ull << 16) | (8ull << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep a register's value where it is up to this point (the hardware reads
// A and writes D asynchronously; the compiler must not move them).
__device__ __forceinline__ void keep(unsigned& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d (+)= A (registers) @ B (descriptor), m64n8k16, f32 += bf16 x bf16.
__device__ __forceinline__ void wgmma_m64n8k16(float (&d)[4], const unsigned (&a)[4],
                                               unsigned long long desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// Group (round r, part h) of KG k-steps: build the fragments, then issue
// them into d and commit. Warp w of the warpgroup owns rows 16w + g and
// 16w + g + 8.
template <int KG>
__device__ __forceinline__ void wgmma_issue(unsigned (&a)[KG][4], float (&d)[4], unsigned v0,
                                            unsigned v1, int r, int h, unsigned t,
                                            unsigned smem_addr) {
  const HotKeys r0((v0 + (unsigned)r) & 255u, t), r1((v1 + (unsigned)r) & 255u, t);
#pragma unroll
  for (int kk = 0; kk < KG; ++kk) hot_fragment(a[kk], r0, r1, (unsigned)(h * KG + kk));
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KG; ++kk)
    wgmma_m64n8k16(d, a[kk], table_desc(smem_addr, h * KG + kk), h > 0 || kk > 0);
  wgmma_commit();
}

// Retire all but N groups, then pin the retired group's A registers up to
// here. No other instruction may read the accumulators of a group between
// its issue and the wait that retires it: ptxas serializes every wgmma of
// the kernel (note C7514) if one does.
template <int N, int KG>
__device__ __forceinline__ void wgmma_retire(unsigned (&a)[KG][4]) {
  wgmma_wait<N>();
#pragma unroll
  for (int kk = 0; kk < KG; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) keep(a[kk][i]);
}

// One warpgroup a block (blockDim.x = 128), so that every branch around a
// wgmma depends on blockIdx, the arguments and loop counters alone (ptxas
// serializes wgmma it cannot prove warpgroup-uniform, note C7518). Slot s
// is group (round s / G, part s % G), in A buffer s & 1 and D buffer
// (s / G) & 1; two rounds (2G slots) an iteration keep both compile-time.
// Slot s + 1 is issued, then slot s retired (wait_group 1) and, if it ends
// a round, that round's epilogue reads its accumulators, which no group in
// flight writes. The last iteration issues one slot past the rounds (and
// an odd round count one round more), retired unread: no branch skips a
// wgmma.
template <int KG>
__global__ void __launch_bounds__(128, KG == 16 ? 3 : 4)
    wgmma_wide_kernel(const int* __restrict__ x, const unsigned short* __restrict__ tab,
                      int rounds, int* __restrict__ out, long long n) {
  constexpr int G = 16 / KG;  // groups a round
  __shared__ __align__(128) unsigned short sb[256 * 8];
  stage_table_kmajor(tab, sb);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const unsigned smem_addr = (unsigned)__cvta_generic_to_shared(sb);
  const unsigned lane = threadIdx.x & 31u, g = lane >> 2, t = lane & 3u;
  const unsigned w = threadIdx.x >> 5, sel = wide_selector(t);
  for (long long base = (long long)blockIdx.x * 64; base < n; base += (long long)gridDim.x * 64) {
    const long long e0 = base + 16 * w + g, e1 = e0 + 8;
    const unsigned v0 = (unsigned)x[e0 < n ? e0 : n - 1], v1 = (unsigned)x[e1 < n ? e1 : n - 1];
    unsigned accp0 = 0u, accp1 = 0u, accl0 = 0u, accl1 = 0u;
    unsigned a[2][KG][4];
    float d[2][4];
    wgmma_issue<KG>(a[0], d[0], v0, v1, 0, 0, t, smem_addr);
    for (int rp = 0; rp < rounds; rp += 2) {
#pragma unroll
      for (int q = 0; q < 2 * G; ++q) {
        // issue slot rp * G + q + 1, retire slot rp * G + q
        wgmma_issue<KG>(a[(q + 1) & 1], d[((q + 1) / G) & 1], v0, v1, rp + (q + 1) / G,
                        (q + 1) % G, t, smem_addr);
        wgmma_retire<1, KG>(a[q & 1]);
        if (q % G == G - 1) {
          float(&c)[4] = d[(q / G) & 1];
#pragma unroll
          for (int i = 0; i < 4; ++i) keep(c[i]);
          const bool valid = rp + q / G < rounds;
          wide_round(accp0, accl0, c[0], c[1], sel, valid);
          wide_round(accp1, accl1, c[2], c[3], sel, valid);
        }
      }
    }
    wgmma_retire<0, KG>(a[0]);
    const unsigned o0 = wide_result(accp0, accl0, t, rounds);
    const unsigned o1 = wide_result(accp1, accl1, t, rounds);
    if (t == 0 && e0 < n) out[e0] = (int)o0;
    if (t == 0 && e1 < n) out[e1] = (int)o1;
  }
}

// ---- mma.sync, four tiles a warp (mode 7) --------------------------------

constexpr int kTiles = 4;  // mode 7's tiles a warp

__global__ void __launch_bounds__(256, 2)
    sync_tiles_kernel(const int* __restrict__ x, const unsigned short* __restrict__ tab,
                      int rounds, int* __restrict__ out, long long n) {
  // B's fragments, [k-step][lane]: one conflict-free 8-byte load a k-step
  __shared__ uint2 sb[16 * 32];
  for (int i = threadIdx.x; i < 16 * 32; i += blockDim.x) {
    const int j = i >> 5, gg = (i & 31) >> 2, k = 16 * j + 2 * (i & 3);
    sb[i] = make_uint2(
        (unsigned)tab[k * 8 + gg] | ((unsigned)tab[(k + 1) * 8 + gg] << 16),
        (unsigned)tab[(k + 8) * 8 + gg] | ((unsigned)tab[(k + 9) * 8 + gg] << 16));
  }
  __syncthreads();
  const unsigned lane = threadIdx.x & 31u, g = lane >> 2, t = lane & 3u;
  const unsigned sel = wide_selector(t);
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long base = warp * 16 * kTiles; base < n; base += n_warps * 16 * kTiles) {
    unsigned v[kTiles][2], accp[kTiles][2], accl[kTiles][2];
#pragma unroll
    for (int q = 0; q < kTiles; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long e = base + 16 * q + 8 * h + g;
        v[q][h] = e < n ? (unsigned)x[e] : 0u;
        accp[q][h] = accl[q][h] = 0u;
      }
    for (int r = 0; r < rounds; ++r) {
      HotKeys hk[kTiles][2];
#pragma unroll
      for (int q = 0; q < kTiles; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) hk[q][h] = HotKeys((v[q][h] + (unsigned)r) & 255u, t);
      float d[kTiles][4];
#pragma unroll
      for (int q = 0; q < kTiles; ++q) d[q][0] = d[q][1] = d[q][2] = d[q][3] = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint2 bj = sb[j * 32 + lane];
#pragma unroll
        for (int q = 0; q < kTiles; ++q) {
          unsigned a[4];
          hot_fragment(a, hk[q][0], hk[q][1], (unsigned)j);
          mma_bf16(d[q], a, bj.x, bj.y);
        }
      }
#pragma unroll
      for (int q = 0; q < kTiles; ++q) {
        wide_round(accp[q][0], accl[q][0], d[q][0], d[q][1], sel, true);
        wide_round(accp[q][1], accl[q][1], d[q][2], d[q][3], sel, true);
      }
    }
#pragma unroll
    for (int q = 0; q < kTiles; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned o = wide_result(accp[q][h], accl[q][h], t, rounds);
        const long long e = base + 16 * q + 8 * h + g;
        if (t == 0 && e < n) out[e] = (int)o;
      }
  }
}

// ---- the nibble one-hot chain (modes 8, 9) --------------------------------

constexpr int kNibbleTiles = 4;              // modes 8 and 9's tiles a warp
constexpr unsigned kLowBytes = 0x00FF00FFu;  // a packed pair of indexes
constexpr unsigned kPairStep = 0x00010001u;  // + 1 to both halves
constexpr unsigned kKeys0 = kKey0 * kPairStep;  // fp16 1024.0 in both halves
constexpr unsigned kOnes = 0x3C003C00u;      // fp16 1.0 in both halves

// set.eq.f16x2 of key against the low (H = 0) or high (H = 1) half of w
// in both halves.
template <int H>
__device__ __forceinline__ unsigned set_eq_half(unsigned key, unsigned w) {
  unsigned d;
  if constexpr (H == 0) {
    asm("{\n.reg .b16 l, h;\n.reg .b32 s;\nmov.b32 {l, h}, %2;\nmov.b32 s, {l, l};\n"
        "set.eq.f16x2.f16x2 %0, %1, s;\n}\n" : "=r"(d) : "r"(key), "r"(w));
  } else {
    asm("{\n.reg .b16 l, h;\n.reg .b32 s;\nmov.b32 {l, h}, %2;\nmov.b32 s, {h, h};\n"
        "set.eq.f16x2.f16x2 %0, %1, s;\n}\n" : "=r"(d) : "r"(key), "r"(w));
  }
  return d;
}

__device__ __forceinline__ unsigned mul_f16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.f16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// d = a @ b + c, m16n8k16, fp16 in and out: d[0] = C[g][2t, 2t + 1],
// d[1] = C[g + 8][2t, 2t + 1], the layout of an A register pair.
__device__ __forceinline__ void mma_f16(unsigned (&d)[2], const unsigned (&a)[4], unsigned b0,
                                        unsigned b1, unsigned c0, unsigned c1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f16.f16.f16.f16 "
      "{%0, %1}, {%2, %3, %4, %5}, {%6, %7}, {%8, %9};\n"
      : "=r"(d[0]), "=r"(d[1])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(c0), "r"(c1));
}

// What a thread keeps for the whole kernel: B's fragments as fp16 (n-tile
// h = columns hi = 8h..8h+7: rows 2t, 2t + 1 and 2t + 8, 2t + 9 of column
// 8h + g), its A columns (2t, 2t + 1) and (2t + 8, 2t + 9) as fp16x2 keys
// 1024 + column, and the same columns as keys of the high nibble,
// 1024 + 16 column.
struct NibbleThread {
  unsigned b[2][2], key_lo, key_hi, hkey_lo, hkey_hi, t;
  __device__ __forceinline__ void load(const unsigned short* __restrict__ tab, unsigned lane) {
    const unsigned g = lane >> 2;
    t = lane & 3u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const unsigned col = 8u * h + g, k = 2u * t + 8u * i;
        // the integer's bf16 bits to fp16 bits
        const unsigned lo = __half_as_ushort(
            __float2half_rn(__uint_as_float((unsigned)__ldg(tab + k * 16 + col) << 16)));
        const unsigned hi = __half_as_ushort(
            __float2half_rn(__uint_as_float((unsigned)__ldg(tab + (k + 1) * 16 + col) << 16)));
        b[h][i] = lo | (hi << 16);
      }
    }
    key_lo = (kKey0 + 2u * t) | ((kKey0 + 2u * t + 1u) << 16);
    key_hi = key_lo + 8u * kPairStep;
    hkey_lo = (kKey0 + 32u * t) | ((kKey0 + 32u * t + 16u) << 16);
    hkey_hi = hkey_lo + 128u * kPairStep;
  }
};

// One tile-round. w holds rows g and g + 8 as fp16 1024 + x (low byte x);
// bias is 1024 + (r & 255) with accumulate, else 1024, in both halves.
// Four set.eq of lo = x & 15 build the A registers; the first two
// products, in fp16, give C = T (rows by lo, columns by hi) in the layout
// of an A fragment over hi; set.eq of the high nibble and one mul.f16x2 a
// register keep column hi alone, and a third product with a B of ones
// sums the row: every thread of the group gets 1024 + T[x] (+ r), exact
// in fp16, in both rows. No shuffle.
__device__ __forceinline__ unsigned nibble_round(unsigned w, unsigned bias,
                                                 const NibbleThread& th) {
  const unsigned klo = (w & 0x000F000Fu) | kKeys0;  // 1024 + lo
  const unsigned a[4] = {set_eq_half<0>(th.key_lo, klo), set_eq_half<1>(th.key_lo, klo),
                         set_eq_half<0>(th.key_hi, klo), set_eq_half<1>(th.key_hi, klo)};
  unsigned c0[2], c1[2], d[2];
  mma_f16(c0, a, th.b[0][0], th.b[0][1], 0u, 0u);
  mma_f16(c1, a, th.b[1][0], th.b[1][1], 0u, 0u);
  const unsigned khi = (w & 0x00F000F0u) | kKeys0;  // 1024 + 16 hi
  const unsigned sel[4] = {mul_f16x2(c0[0], set_eq_half<0>(th.hkey_lo, khi)),
                           mul_f16x2(c0[1], set_eq_half<1>(th.hkey_lo, khi)),
                           mul_f16x2(c1[0], set_eq_half<0>(th.hkey_hi, khi)),
                           mul_f16x2(c1[1], set_eq_half<1>(th.hkey_hi, khi))};
  mma_f16(d, sel, kOnes, kOnes, bias, bias);
  return __byte_perm(d[0], d[1], 0x5410);
}

// tab: B, (16, 16) bf16, row-major (B[lo][hi] = T[16 hi + lo] & 255). A
// warp takes kNibbleTiles tiles of 16 elements; rows past n take index 0
// and run every mma with the warp, and are not stored.
template <bool Acc>
__global__ void __launch_bounds__(256, 4)
    chain_nibble_kernel(const int* __restrict__ x, const unsigned short* __restrict__ tab,
                        int rounds, int* __restrict__ out, long long n) {
  const unsigned lane = threadIdx.x & 31u, g = lane >> 2;
  NibbleThread th;
  th.load(tab, lane);
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long base = warp * 16 * kNibbleTiles; base < n;
       base += n_warps * 16 * kNibbleTiles) {
    unsigned v[kNibbleTiles];
#pragma unroll
    for (int q = 0; q < kNibbleTiles; ++q) {
      const long long e0 = base + 16 * q + g, e1 = e0 + 8;
      v[q] = (e0 < n ? (unsigned)x[e0] & 255u : 0u) |
             (e1 < n ? ((unsigned)x[e1] & 255u) << 16 : 0u);
    }
    unsigned rr = 0u;  // (r & 255) in both halves
    for (int r = 0; r < rounds; ++r) {
#pragma unroll
      for (int q = 0; q < kNibbleTiles; ++q) v[q] = nibble_round(v[q], kKeys0 + rr, th);
      if constexpr (Acc) rr = (rr + kPairStep) & kLowBytes;
    }
#pragma unroll
    for (int q = 0; q < kNibbleTiles; ++q) {
      const long long e0 = base + 16 * q + g, e1 = e0 + 8;
      if (th.t == 0 && e0 < n) out[e0] = (int)(v[q] & 255u);
      if (th.t == 0 && e1 < n) out[e1] = (int)((v[q] >> 16) & 255u);
    }
  }
}

// ---- launch ----------------------------------------------------------------

template <bool Wide, bool Acc, int S>
const void* mma_kernel() {
  return (const void*)mma_lut_kernel<Wide, Acc, S>;
}

// The kernel of a mode, or null.
const void* kernel_of(int mode) {
  switch (mode) {
    case 0: return mma_kernel<true, false, kFull_>();
    case 1: return mma_kernel<false, false, kFull_>();
    case 2: return mma_kernel<false, true, kFull_>();
    case 3: return mma_kernel<true, false, kMmaOnly>();
    case 4: return mma_kernel<true, false, kBuildOnly>();
    case 5: return (const void*)wgmma_wide_kernel<16>;
    case 6: return (const void*)wgmma_wide_kernel<8>;
    case 7: return (const void*)sync_tiles_kernel;
    case 8: return (const void*)chain_nibble_kernel<false>;
    case 9: return (const void*)chain_nibble_kernel<true>;
    default: return nullptr;
  }
}

// Elements a block takes at a time.
long long per_block(int mode, int block) {
  if (mode == 5 || mode == 6) return 64;
  if (mode == 7) return 16ll * kTiles * (block / 32);
  if (mode >= 8) return 16ll * kNibbleTiles * (block / 32);
  return block;
}

}  // namespace

extern "C" {

// mode: 0 wide (idx = (x + r) & 255; XOR of patterns ^ SUM of lengths),
// 1 chain (x = T[x] & 255), 2 chain with accumulate (x = (T[x] + r) &
// 255), 3 wide with no one-hot a k-step (mma and epilogue only; column
// idx & 15 hot in every k-step), 4 wide without the mma (build and
// epilogue only; out is 0), 5 wide by wgmma (a round one group of 16
// k-steps), 6 wide by wgmma (two groups of 8), 7 wide by mma.sync, four
// tiles a warp, 8 chain on the nibble one-hot, 9 the same with
// accumulate. tab: (256, 8) bf16 for modes 0-7, (16, 16) for 8 and 9,
// built by the wrapper for the mode. block: a multiple of 32 (128 for
// modes 5, 6; at most 256 for 8 and 9). grid <= 0: as many blocks
// as the card holds at once, capped at the work.
int thc_probe_mma_lut(int device, const void* x, long long n, const void* tab, int rounds,
                      int mode, int block, int grid, void* out, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const void* kernel = kernel_of(mode);
  if (kernel == nullptr || ((mode == 5 || mode == 6) ? block != 128 : block % 32 != 0) ||
      (mode >= 8 && block > 256))
    return (int)cudaErrorInvalidValue;
  if (grid <= 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, 0);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const long long work = (n + per_block(mode, block) - 1) / per_block(mode, block);
    grid = (int)(work < (long long)per_sm * sms ? (work > 0 ? work : 1) : (long long)per_sm * sms);
  }
  void* args[] = {(void*)&x, (void*)&tab, (void*)&rounds, (void*)&out, (void*)&n};
  const cudaError_t err = cudaLaunchKernel(kernel, dim3(grid), dim3(block), args, 0,
                                           (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Blocks of `block` threads that one SM holds at once for a mode's kernel
// (registers and shared memory as ptxas left them), or -(CUDA error).
int thc_probe_mma_occupancy(int device, int mode, int block) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return -(int)set;
  const void* kernel = kernel_of(mode);
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, 0);
  return err != cudaSuccess ? -(int)err : per_sm;
}

// Registers a thread of a mode's kernel takes (as ptxas allocated them),
// or -(CUDA error).
int thc_probe_mma_registers(int device, int mode) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return -(int)set;
  const void* kernel = kernel_of(mode);
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  return err != cudaSuccess ? -(int)err : attr.numRegs;
}

}  // extern "C"
