// A 256-entry table lookup on the tensor cores: a one-hot row times the
// table, by mma.sync.m16n8k16 in bf16 with f32 accumulation.
//
// Replaces the Pallas probe scripts/prof/prof_mxu_lut.py's f_onehot (:152,
// body k_onehot :127), the MXU one-hot lookup of P6, and the one-column
// case of scripts/prof/prof_kernel_lut.py's k_onehot (:93, run :37).
//
// The table is a (256, 8) bf16 matrix B, column-major fragments kept in
// registers for the whole kernel (16 k-steps x 2 registers a thread).
// Each warp looks up 32 elements a round as two m16 tiles: the A fragment
// of tile h is the one-hot of its 16 indexes, built in registers (an
// index's 1 lies in k-step idx >> 4, column idx & 15), and 16 mma.sync
// k-steps give C = onehot(idx) @ B. Thread (g, t) = (lane >> 2, lane & 3)
// owns rows g and g + 8 of both tiles, elements g, g + 8, 16 + g and
// 24 + g of the warp's 32, and computes their indexes itself, so no index
// is shuffled. Two tables:
//   wide:  columns [pattern >> 24, >> 16, >> 8, & 255, length, 0, 0, 0];
//          threads t = 0, 1 XOR their two bytes into the pattern, t = 2
//          adds the length; one reduction over the four threads at the end
//          (out = XOR patterns ^ SUM lengths, as lut_wide);
//   chain: every column the table's low byte, so every thread of the
//          group reads T[x] for its own rows in C and the chain
//          x = (T[x] (+ r)) & 255 goes on without a shuffle (as lut_chain).
// Integers <= 255 are exact in bf16 and their one-hot sums exact in f32.
//
// Bound: tensor-core operations as executed, 2 * 256 * 8 flops a lookup
// (the one-hot's K of 256 is the cost: only one of its 16 k-steps holds
// the 1), over the card's bf16 rate; the one-hot's construction (four
// selects a k-step) runs on the ALUs beside it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kOneLo = 0x3F80u;       // bf16 1.0 in the low half
constexpr unsigned kOneHi = 0x3F800000u;   // bf16 1.0 in the high half

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
  __device__ __forceinline__ OneHot(unsigned idx, unsigned t) {
    const unsigned hot = (idx & 1u) ? kOneHi : kOneLo;
    const unsigned pair = (idx & 15u) >> 1;
    step = idx >> 4;
    lo = pair == t ? hot : 0u;
    hi = pair == t + 4u ? hot : 0u;
  }
};

// d = onehot(rows g, g + 8) @ B: d[0], d[1] = C[g][2t], C[g][2t + 1];
// d[2], d[3] = C[g + 8][2t], C[g + 8][2t + 1].
__device__ __forceinline__ void lookup_tile(float (&d)[4], unsigned idx_g, unsigned idx_g8,
                                            unsigned t, const unsigned (&b)[16][2]) {
  const OneHot r0(idx_g, t), r1(idx_g8, t);
  d[0] = d[1] = d[2] = d[3] = 0.f;
#pragma unroll
  for (unsigned j = 0; j < 16; ++j) {
    const unsigned a[4] = {r0.step == j ? r0.lo : 0u, r1.step == j ? r1.lo : 0u,
                           r0.step == j ? r0.hi : 0u, r1.step == j ? r1.hi : 0u};
    mma_bf16(d, a, b[j][0], b[j][1]);
  }
}

__device__ __forceinline__ unsigned u(float f) { return __float2uint_rn(f); }

// tab: the (256, 8) bf16 table, row-major, as raw 16-bit values.
template <bool Wide, bool Acc>
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
      lookup_tile(d[0], idx[0], idx[1], t, b);
      lookup_tile(d[1], idx[2], idx[3], t, b);
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

template <bool Wide, bool Acc>
cudaError_t launch(const void* x, long long n, const void* tab, int rounds, int block, int grid,
                   void* out, cudaStream_t s) {
  mma_lut_kernel<Wide, Acc><<<grid, block, 0, s>>>((const int*)x, (const unsigned short*)tab,
                                                    rounds, (int*)out, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// mode: 0 wide (idx = (x + r) & 255; XOR of patterns ^ SUM of lengths),
// 1 chain (x = T[x] & 255), 2 chain with accumulate (x = (T[x] + r) & 255).
// tab: (256, 8) bf16, built by the wrapper for the mode. block: a multiple
// of 32.
int thc_probe_mma_lut(int device, const void* x, long long n, const void* tab, int rounds,
                      int mode, int block, int grid, void* out, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0: return (int)launch<true, false>(x, n, tab, rounds, block, grid, out, s);
    case 1: return (int)launch<false, false>(x, n, tab, rounds, block, grid, out, s);
    case 2: return (int)launch<false, true>(x, n, tab, rounds, block, grid, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
