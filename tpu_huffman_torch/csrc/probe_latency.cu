// Dependent-step latency: a chain of ALU steps against a chain of gathers.
//
// Replaces the Pallas probe scripts/prof/prof_r3_gather_latency.py:make
// (:11, pallas_call :31). Each element i runs `steps` dependent steps on
// its uint32 x, with (s, l) = ((i >> 7) & 7, i & 127), its sublane and
// lane in the script's (8, 128) tiles, and LUT a (8, 128) uint32 table:
//   chain:   x = (x >= 2^31 ? x + 13 : x) ^ (x >> 1)
//   gather:  x = LUT[s][x & 127] + x
//   gather0: x = LUT[x & 7][l] + x
// LUT is data, read through the form's load on every step (smem: staged in
// shared memory; ldg: global through L1; l2: global through L2 only; lean:
// shared memory, with the fewest integer instructions a step), so the
// compiler cannot fold gather0's identical rows into a constant.
//
// Bound: on the card, latency. One thread runs one chain, so at one warp
// an SM the time per step is the latency of one dependent step; at 64
// warps an SM it approaches the SM's instruction throughput. The caller
// sweeps the occupancy with the element count and the block size, and
// takes the slope between two step counts to remove the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Kind : int { kChain = 0, kGather = 1, kGather0 = 2 };
// smem, ldg and l2 keep the numbers of probe_lut.cu; lean has its own
enum Form : int { kSmem = 0, kLdg = 2, kL2 = 3, kLean = 7 };

template <int F>
__device__ __forceinline__ unsigned load(const unsigned* smem, const unsigned* __restrict__ g,
                                         unsigned j) {
  if constexpr (F == kSmem) {
    return smem[j];
  } else if constexpr (F == kLdg) {
    return __ldg(g + j);
  } else {
    return __ldcg(g + j);
  }
}

template <int K, int F>
__global__ void step_chain_kernel(const unsigned* __restrict__ x, const unsigned* __restrict__ lut,
                                  int steps, unsigned* __restrict__ out, long long n) {
  __shared__ unsigned smem[K != kChain && F == kSmem ? 1024 : 1];
  if constexpr (K != kChain && F == kSmem) {
    for (int k = threadIdx.x; k < 1024; k += blockDim.x) smem[k] = lut[k];
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    unsigned v = x[i];
    const unsigned row = ((unsigned)(i >> 7) & 7u) * 128u;
    const unsigned lane = (unsigned)i & 127u;
#pragma unroll 4
    for (int k = 0; k < steps; ++k) {
      if constexpr (K == kChain) {
        v = (v >= 0x80000000u ? v + 13u : v) ^ (v >> 1);
      } else if constexpr (K == kGather) {
        v = load<F>(smem, lut, row + (v & 127u)) + v;
      } else {
        v = load<F>(smem, lut, (v & 7u) * 128u + lane) + v;
      }
    }
    out[i] = v;
  }
}

// The lean form of gather and gather0: the same steps, the LUT staged in
// shared memory and read at every step, with the fewest integer
// instructions a step. The LUT starts at a 4 KB boundary of the shared
// window (kLeanSmem words leave room for the padding), so a word's address
// is the LUT's base ORed with its byte offset. What stays the same along a
// chain, base | the row's offset (gather) or base | the lane's (gather0),
// is computed once a chain; a step's address is then a shift and one LOP3,
// ((v << 2) & 0x1FC) | fixed for gather and ((v << 9) & 0xE00) | fixed for
// gather0 (the bit ranges are disjoint), the load takes it as it is, and
// one add makes the next value. Steps run in unrolled groups of
// kLeanGroup, so no counter runs a step.
constexpr int kLeanGroup = 32;
constexpr int kLeanSmem = 2048;  // words: 4 KB of LUT and 4 KB for the padding

__device__ __forceinline__ unsigned ld_shared(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

template <int K>
__device__ __forceinline__ unsigned lean_step(unsigned fixed, unsigned v) {
  const unsigned a = K == kGather ? ((v << 2) & 0x1FCu) | fixed : ((v << 9) & 0xE00u) | fixed;
  return ld_shared(a) + v;
}

template <int K>
__global__ void step_lean_kernel(const unsigned* __restrict__ x, const unsigned* __restrict__ lut,
                                 int steps, unsigned* __restrict__ out, long long n) {
  __shared__ unsigned smem[kLeanSmem];
  const unsigned s0 = (unsigned)__cvta_generic_to_shared(smem);
  const unsigned pad = (0u - s0) & 4095u;
  unsigned* t = smem + pad / 4;
  for (int k = threadIdx.x; k < 1024; k += blockDim.x) t[k] = lut[k];
  __syncthreads();
  const unsigned base = s0 + pad;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    unsigned v = x[i];
    const unsigned fixed =
        base | (K == kGather ? ((unsigned)(i >> 7) & 7u) << 9 : ((unsigned)i & 127u) << 2);
    int k = 0;
    for (; k + kLeanGroup <= steps; k += kLeanGroup) {
#pragma unroll
      for (int u = 0; u < kLeanGroup; ++u) v = lean_step<K>(fixed, v);
    }
    for (; k < steps; ++k) v = lean_step<K>(fixed, v);
    out[i] = v;
  }
}

template <int K, int F>
cudaError_t launch(const void* x, long long n, const void* lut, int steps, int block, int grid,
                   void* out, cudaStream_t s) {
  step_chain_kernel<K, F><<<grid, block, 0, s>>>((const unsigned*)x, (const unsigned*)lut, steps,
                                                  (unsigned*)out, n);
  return cudaGetLastError();
}

template <int K>
cudaError_t by_form(int form, const void* x, long long n, const void* lut, int steps, int block,
                    int grid, void* out, cudaStream_t s) {
  switch (form) {
    case kSmem: return launch<K, kSmem>(x, n, lut, steps, block, grid, out, s);
    case kLdg: return launch<K, kLdg>(x, n, lut, steps, block, grid, out, s);
    case kL2: return launch<K, kL2>(x, n, lut, steps, block, grid, out, s);
    case kLean:
      step_lean_kernel<K><<<grid, block, 0, s>>>((const unsigned*)x, (const unsigned*)lut, steps,
                                                 (unsigned*)out, n);
      return cudaGetLastError();
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// kind: 0 chain, 1 gather, 2 gather0; form: 0 smem, 2 ldg, 3 l2, 7 lean
// (ignored for chain). lut: 8 x 128 uint32.
int thc_probe_step_chain(int device, const void* x, long long n, const void* lut, int steps,
                         int kind, int form, int block, int grid, void* out, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case kChain: return (int)launch<kChain, kSmem>(x, n, lut, steps, block, grid, out, s);
    case kGather: return (int)by_form<kGather>(form, x, n, lut, steps, block, grid, out, s);
    case kGather0: return (int)by_form<kGather0>(form, x, n, lut, steps, block, grid, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
