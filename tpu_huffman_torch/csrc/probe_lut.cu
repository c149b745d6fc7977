// Table lookups in the placements a CUDA kernel can give a 256-entry table.
//
// Replaces the Pallas lookup probes: scripts/prof/prof_kernel_lut.py:run
// (:37; bodies k_tree, k_take), prof_kernel_gather2d.py:run (:24; k_lanes,
// k_sublane), prof_dynamic_gather.py's f and ft (:34, :92) and
// prof_mxu_lut.py's f_gather3 (:101). Two kernels:
//   lut_chain: R dependent lookups per element, x = (T[x] (+ r)) & 255,
//              on a byte table (uint8) or a 32-bit one (int32);
//   lut_wide:  R independent lookups of a (32-bit pattern, length) entry
//              at idx = (x0 + r) & 255; out = XOR patterns ^ SUM lengths.
// Forms (where the table lives):
//   smem      one copy per block in shared memory;
//   smem_rep  one copy per bank column: lane c reads copy c, in bank c,
//             so 32 random indexes never conflict (32 KB of 32-bit entries;
//             a byte table keeps four entries a word, 8 KB);
//   ldg       global memory through L1 (ld.global.nc);
//   l2        global memory through L2 only (ld.global.cg);
//   shfl      spread over the warp's registers, read with __shfl_sync: two
//             words a lane for a byte table, eight for a 32-bit one (eight
//             shuffles and a select tree, the counterpart of the TPU's
//             select tree, tpu_huffman/ops/pallas_encode.py:_make_byte_lut);
//   packed    (lut_wide only) pattern and length as one 64-bit shared
//             memory entry, one load a lookup: the counterpart of P6's
//             three gathers;
//   word      (lut_wide only, its own kernel lut_word_kernel) the entry as
//             one 32-bit word, e = pattern | 1 << (31 - length) (a
//             left-aligned pattern of length <= 31 has its low 32 - length
//             bits zero), one copy per bank column as smem_rep: one
//             conflict-free 4-byte load a lookup, whatever the indexes.
//   addr      (lut_chain only, its own kernel lut_addr_kernel) the table as
//             next addresses: entry idx of copy c, in bank column c, holds
//             the shared-memory address of the next lookup in copy c. A
//             round is one conflict-free 4-byte load, from a byte or a
//             32-bit table alike (the accumulating chain's add rides in the
//             next load's address).
//
// Bound: at the scripts' round counts, bytes (each element read and
// written once); per lookup, the latency of the dependent load (lut_chain)
// or the load throughput of the form (lut_wide): one 4-byte lane load a
// lookup, 32 a cycle an SM. The word form reaches it only with few
// instructions a lookup: two for the address, the load, two for the
// marker bit (lsb = e & -e), one LOP3 for the pattern (e ^ lsb), one
// quarter-rate FLO for the length and one add, about 8 at 128 a cycle an
// SM, which caps it near 16 lookups a cycle, half the bound. The addr form
// spends no integer instruction a round, so its chains run at the load
// rate and hide under the stream's bytes. The design keeps every
// round dependent on the last (lut_chain) and the table's placement a
// template parameter, so that each form compiles to its own load
// instruction and nothing else differs. A block-uniform grid-stride loop
// keeps every lane of a warp in the loop, as __shfl_sync needs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
enum Form : int {
  kSmem = 0, kSmemRep = 1, kLdg = 2, kL2 = 3, kShfl = 4, kPacked = 5, kAddr = 6
};

// Byte b of the little-endian word holding entries 4w..4w+3.
__device__ __forceinline__ unsigned byte_of(unsigned w, unsigned i) {
  return (w >> ((i & 3u) * 8u)) & 255u;
}

__device__ __forceinline__ unsigned word_of_bytes(const uint8_t* t, int w) {
  return (unsigned)t[4 * w] | ((unsigned)t[4 * w + 1] << 8) |
         ((unsigned)t[4 * w + 2] << 16) | ((unsigned)t[4 * w + 3] << 24);
}

// Entry i (of 256) of a table spread over the warp: entry i in lane i & 31,
// register i >> 5. Eight shuffles, then a select tree on i >> 5.
__device__ __forceinline__ unsigned shfl_select8(const unsigned (&r)[8], unsigned i) {
  const int src = (int)(i & 31u);
  unsigned v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __shfl_sync(kFull, r[k], src);
  const unsigned k = i >> 5;
  const unsigned a = (k & 1u) ? v[1] : v[0];
  const unsigned b = (k & 1u) ? v[3] : v[2];
  const unsigned c = (k & 1u) ? v[5] : v[4];
  const unsigned d = (k & 1u) ? v[7] : v[6];
  const unsigned ab = (k & 2u) ? b : a;
  const unsigned cd = (k & 2u) ? d : c;
  return (k & 4u) ? cd : ab;
}

// Byte i of a 256-byte table spread over the warp: word w = i >> 2 in lane
// w & 31, register w >> 5. Two shuffles and one select.
__device__ __forceinline__ unsigned shfl_byte(unsigned r0, unsigned r1, unsigned i) {
  const int src = (int)((i >> 2) & 31u);
  const unsigned a = __shfl_sync(kFull, r0, src);
  const unsigned b = __shfl_sync(kFull, r1, src);
  return byte_of((i & 128u) ? b : a, i);
}

// A 256-entry byte table in form F; get(i) is entry i, i < 256.
template <int F>
struct ByteTable {
  const uint8_t* g;
  const unsigned* s;
  unsigned r0, r1;
  unsigned lane;

  static constexpr int smem_bytes() {
    return F == kSmem ? 256 : F == kSmemRep ? 64 * 32 * 4 : 0;
  }

  // Every thread of the block calls this once, before any get.
  __device__ __forceinline__ void init(const uint8_t* __restrict__ tab, unsigned* smem) {
    g = tab;
    s = smem;
    lane = threadIdx.x & 31u;
    if constexpr (F == kSmem) {
      uint8_t* b = reinterpret_cast<uint8_t*>(smem);
      for (int i = threadIdx.x; i < 256; i += blockDim.x) b[i] = tab[i];
      __syncthreads();
    } else if constexpr (F == kSmemRep) {
      for (int k = threadIdx.x; k < 64 * 32; k += blockDim.x)
        smem[k] = word_of_bytes(tab, k >> 5);
      __syncthreads();
    } else if constexpr (F == kShfl) {
      r0 = word_of_bytes(tab, (int)lane);
      r1 = word_of_bytes(tab, (int)lane + 32);
    }
  }

  __device__ __forceinline__ unsigned get(unsigned i) const {
    if constexpr (F == kSmem) {
      return reinterpret_cast<const uint8_t*>(s)[i];
    } else if constexpr (F == kSmemRep) {
      return byte_of(s[(i >> 2) * 32u + lane], i);
    } else if constexpr (F == kLdg) {
      return __ldg(g + i);
    } else if constexpr (F == kL2) {
      return __ldcg(g + i);
    } else {
      return shfl_byte(r0, r1, i);
    }
  }
};

// A 256-entry table of 32-bit values in form F.
template <int F>
struct WordTable {
  const unsigned* g;
  const unsigned* s;
  unsigned r[8];
  unsigned lane;

  static constexpr int smem_bytes() {
    return F == kSmem ? 256 * 4 : F == kSmemRep ? 256 * 32 * 4 : 0;
  }

  __device__ __forceinline__ void init(const unsigned* __restrict__ tab, unsigned* smem) {
    g = tab;
    s = smem;
    lane = threadIdx.x & 31u;
    if constexpr (F == kSmem) {
      for (int i = threadIdx.x; i < 256; i += blockDim.x) smem[i] = tab[i];
      __syncthreads();
    } else if constexpr (F == kSmemRep) {
      for (int k = threadIdx.x; k < 256 * 32; k += blockDim.x) smem[k] = tab[k >> 5];
      __syncthreads();
    } else if constexpr (F == kShfl) {
#pragma unroll
      for (int k = 0; k < 8; ++k) r[k] = tab[k * 32 + lane];
    }
  }

  __device__ __forceinline__ unsigned get(unsigned i) const {
    if constexpr (F == kSmem) {
      return s[i];
    } else if constexpr (F == kSmemRep) {
      return s[i * 32u + lane];
    } else if constexpr (F == kLdg) {
      return __ldg(g + i);
    } else if constexpr (F == kL2) {
      return __ldcg(g + i);
    } else {
      return shfl_select8(r, i);
    }
  }
};

// x[i] = (T[x[i]] (+ r)) & 255 for r < rounds.
template <typename Table, typename Entry, bool Acc>
__global__ void lut_chain_kernel(const int* __restrict__ x, const Entry* __restrict__ table,
                                 int rounds, int* __restrict__ out, long long n) {
  extern __shared__ unsigned smem[];
  Table t;
  t.init(table, smem);
  const long long stride = (long long)gridDim.x * blockDim.x;
  // block-uniform trip count: every lane reaches every shuffle
  for (long long b = (long long)blockIdx.x * blockDim.x; b < n; b += stride) {
    const long long i = b + threadIdx.x;
    const bool live = i < n;
    unsigned v = live ? (unsigned)x[i] & 255u : 0u;
#pragma unroll 4
    for (int r = 0; r < rounds; ++r) {
      const unsigned e = t.get(v);
      v = (Acc ? e + (unsigned)r : e) & 255u;
    }
    if (live) out[i] = (int)v;
  }
}

// The (pattern, length) table of lut_wide in form F. Lengths are bytes.
template <int F>
struct WideTable {
  WordTable<F == kPacked ? kSmem : F> pat;
  const int* gl;
  const unsigned* sl;
  unsigned l0, l1;

  static constexpr int smem_bytes() {
    return F == kSmem || F == kPacked ? 256 * 8 : F == kSmemRep ? 256 * 32 * 4 + 64 * 32 * 4 : 0;
  }

  __device__ __forceinline__ void init(const unsigned* __restrict__ p32,
                                       const int* __restrict__ lens, unsigned* smem) {
    gl = lens;
    if constexpr (F == kPacked) {
      uint2* e = reinterpret_cast<uint2*>(smem);
      for (int i = threadIdx.x; i < 256; i += blockDim.x)
        e[i] = make_uint2(p32[i], (unsigned)lens[i] & 255u);
      __syncthreads();
      sl = smem;
    } else {
      pat.init(p32, smem);
      const int lane = threadIdx.x & 31;
      if constexpr (F == kSmem) {
        unsigned* s = smem + 256;
        for (int i = threadIdx.x; i < 256; i += blockDim.x) s[i] = (unsigned)lens[i] & 255u;
        __syncthreads();
        sl = s;
      } else if constexpr (F == kSmemRep) {
        unsigned* s = smem + 256 * 32;
        for (int k = threadIdx.x; k < 64 * 32; k += blockDim.x) {
          const int w = k >> 5;
          s[k] = ((unsigned)lens[4 * w] & 255u) | (((unsigned)lens[4 * w + 1] & 255u) << 8) |
                 (((unsigned)lens[4 * w + 2] & 255u) << 16) |
                 (((unsigned)lens[4 * w + 3] & 255u) << 24);
        }
        __syncthreads();
        sl = s;
      } else if constexpr (F == kShfl) {
        auto word = [&](int w) {
          return ((unsigned)lens[4 * w] & 255u) | (((unsigned)lens[4 * w + 1] & 255u) << 8) |
                 (((unsigned)lens[4 * w + 2] & 255u) << 16) |
                 (((unsigned)lens[4 * w + 3] & 255u) << 24);
        };
        l0 = word(lane);
        l1 = word(lane + 32);
      }
    }
  }

  __device__ __forceinline__ void get(unsigned i, unsigned& p, unsigned& l) const {
    if constexpr (F == kPacked) {
      const uint2 e = reinterpret_cast<const uint2*>(sl)[i];
      p = e.x;
      l = e.y;
    } else {
      p = pat.get(i);
      if constexpr (F == kSmem) {
        l = sl[i];
      } else if constexpr (F == kSmemRep) {
        l = byte_of(sl[(i >> 2) * 32u + pat.lane], i);
      } else if constexpr (F == kLdg) {
        l = (unsigned)__ldg(gl + i) & 255u;
      } else if constexpr (F == kL2) {
        l = (unsigned)__ldcg(gl + i) & 255u;
      } else {
        l = shfl_byte(l0, l1, i);
      }
    }
  }
};

// out[i] = XOR_r p32[(x0[i] + r) & 255] ^ SUM_r lens[(x0[i] + r) & 255].
template <int F>
__global__ void lut_wide_kernel(const int* __restrict__ x0, const unsigned* __restrict__ p32,
                                const int* __restrict__ lens, int rounds,
                                int* __restrict__ out, long long n) {
  extern __shared__ unsigned smem[];
  WideTable<F> t;
  t.init(p32, lens, smem);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long b = (long long)blockIdx.x * blockDim.x; b < n; b += stride) {
    const long long i = b + threadIdx.x;
    const bool live = i < n;
    const unsigned base = live ? (unsigned)x0[i] : 0u;
    unsigned accp = 0u, accl = 0u;
#pragma unroll 4
    for (int r = 0; r < rounds; ++r) {
      unsigned p, l;
      t.get((base + (unsigned)r) & 255u, p, l);
      accp ^= p;
      accl += l;
    }
    if (live) out[i] = (int)(accp ^ accl);
  }
}

// lut_wide on the word table: 256 marker-bit words (w = p | 1 << (31 - l)),
// copy c of the 256 in bank column c (word idx * 32 + c, 32 KB). Lane c
// reads copy c, so a warp's 32 loads hit 32 banks whatever their indexes:
// one wavefront a lookup. The copies start at a 32 KB boundary of the
// shared window (kWordSmem bytes a block leave room for the padding), so
// the address of round r, ((x0 << 7) + (r << 7)) & 0x7F80 | base | lane << 2,
// is an add and one LOP3: with the base anywhere else its add is a third
// instruction. lsb = w & -w is the marker; w ^ lsb the pattern; the length
// is 31 - FLO(lsb), bfind.shiftamt in one instruction.
constexpr int kWordTable = 256 * 32 * 4;
constexpr int kWordSmem = 2 * kWordTable;

__device__ __forceinline__ unsigned shiftamt(unsigned v) {
  unsigned d;
  asm("bfind.shiftamt.u32 %0, %1;" : "=r"(d) : "r"(v));
  return d;
}

__device__ __forceinline__ unsigned ld_shared(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__global__ void lut_word_kernel(const int* __restrict__ x0, const unsigned* __restrict__ words,
                                int rounds, int* __restrict__ out, long long n) {
  extern __shared__ unsigned smem[];
  const unsigned s0 = (unsigned)__cvta_generic_to_shared(smem);
  const unsigned pad = (0u - s0) & (unsigned)(kWordTable - 1);
  unsigned* copies = smem + pad / 4;
  for (int k = threadIdx.x; k < 256 * 32; k += blockDim.x) copies[k] = words[k >> 5];
  __syncthreads();
  const unsigned base = (s0 + pad) | ((threadIdx.x & 31u) << 2);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const unsigned b7 = (unsigned)x0[i] << 7;
    unsigned accp = 0u, accl = 0u;
#pragma unroll 16
    for (int r = 0; r < rounds; ++r) {
      const unsigned w = ld_shared(((b7 + ((unsigned)r << 7)) & 0x7F80u) | base);
      const unsigned lsb = w & (0u - w);
      accp ^= w ^ lsb;
      accl += shiftamt(lsb);
    }
    out[i] = (int)(accp ^ accl);
  }
}

// lut_chain's addr form. The 256 entries as next addresses, one copy per
// bank column: entry (idx, c), word idx * 32 + c, holds the shared-memory
// address of the next lookup in copy c, base + ((T[idx] & 255) << 7) + (c
// << 2), with base the copies' start. The block builds the entries from a
// byte or a 32-bit table as it stages them, so P1, P2 and P3 run this one
// kernel. Lane c walks copy c, so a warp's 32 loads hit 32 banks whatever
// their indexes: one wavefront a round. A round of the plain chain is the
// load alone, e = lds(e), with no integer instruction (an offset from the
// base would need an add a round: ptxas keeps the base in the load's
// uniform register only sometimes). The accumulating chain adds (r & 255)
// << 7 to the index bits after the load and masks nothing, so ptxas folds
// the add into the next load's address ([R + UR + imm]: the group's r in
// the uniform register, the round's k in the immediate): its copies hold
// the 256 entries twice (entry idx + 256 = entry idx, 64 KB), so an index
// up to 255 + 255 reads entry index & 255, and a group of kAddrGroup
// rounds from a multiple of kAddrGroup never passes 255 + 255. The value
// is ((e - base) >> 7) & 255.
// Rounds run in unrolled groups, so no counter runs a round. One chain a
// thread, as the other forms; the thread's next kAddrAhead elements are
// loaded before the current chain runs, so the stream's reads are in
// flight under the lookups instead of after them.
constexpr int kAddrGroup = 16;
constexpr int kAddrAhead = 4;  // elements a thread has loaded ahead of its chain

// Entries a copy: the accumulating chain's copies hold the table twice.
template <bool Acc>
__host__ __device__ constexpr int addr_entries() {
  return Acc ? 512 : 256;
}

// Shared memory a block: the copies, then the 256 entries' offsets.
template <bool Acc>
__host__ __device__ constexpr int addr_smem() {
  return addr_entries<Acc>() * 32 * 4 + 256 * 4;
}

template <bool Acc>
__device__ __forceinline__ unsigned addr_chain(unsigned e, int rounds) {
  int r = 0;
  for (; r + kAddrGroup <= rounds; r += kAddrGroup) {
    const unsigned r7 = ((unsigned)r & 255u) << 7;
#pragma unroll
    for (int k = 0; k < kAddrGroup; ++k) {
      e = ld_shared(e);
      if (Acc) e += r7 + ((unsigned)k << 7);
    }
  }
  for (; r < rounds; ++r) {
    e = ld_shared(e);
    if (Acc) e += ((unsigned)r & 255u) << 7;
  }
  return e;
}

// 32 registers at most, so that two blocks of 1024 threads fill an SM
template <bool Acc>
__global__ void __launch_bounds__(1024, 2)
    lut_addr_kernel(const int* __restrict__ x, const void* __restrict__ table, int table_bytes,
                    int rounds, int* __restrict__ out, long long n) {
  extern __shared__ unsigned smem[];
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // Slot k holds the next element of the thread's k-th stride: a slot is
  // refilled, kAddrAhead strides on, as soon as its element is taken, so
  // each load has kAddrAhead - 1 chains to arrive in. The slots stay in
  // registers of their own (the loop over them is unrolled): a rotation
  // through one register would wait for the newest load at every element.
  // The first loads are issued before the table is staged, and arrive
  // meanwhile.
  unsigned xs[kAddrAhead];
#pragma unroll
  for (int k = 0; k < kAddrAhead; ++k) {
    const long long j = first + k * stride;
    xs[k] = j < n ? (unsigned)__ldg(x + j) : 0u;
  }
  const unsigned base = (unsigned)__cvta_generic_to_shared(smem);
  // The 256 entries' offsets first, one coalesced load an entry, into the
  // words after the copies; then the copies from them. Loading an entry a
  // copy instead would send every warp of the grid to the table's few
  // lines in L2 at once, 32 times over.
  unsigned* offsets = smem + addr_entries<Acc>() * 32;
  for (int idx = threadIdx.x; idx < 256; idx += blockDim.x) {
    const unsigned v = table_bytes == 1 ? (unsigned)static_cast<const uint8_t*>(table)[idx]
                                        : static_cast<const unsigned*>(table)[idx];
    offsets[idx] = base + ((v & 255u) << 7);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < addr_entries<Acc>() * 32; k += blockDim.x)
    smem[k] = offsets[(k >> 5) & 255] + (((unsigned)k & 31u) << 2);
  __syncthreads();
  const unsigned start = base + ((threadIdx.x & 31u) << 2);
  for (long long i = first; i < n; i += kAddrAhead * stride) {
#pragma unroll
    for (int k = 0; k < kAddrAhead; ++k) {
      const long long j = i + k * stride;
      if (j >= n) break;
      const unsigned e = start + ((xs[k] & 255u) << 7);
      const long long ahead = j + kAddrAhead * stride;
      xs[k] = ahead < n ? (unsigned)__ldg(x + ahead) : 0u;
      out[j] = (int)(((addr_chain<Acc>(e, rounds) - base) >> 7) & 255u);
    }
  }
}

cudaError_t launch_addr(const void* x, long long n, const void* table, int table_bytes,
                        int rounds, int accumulate, int block, int grid, void* out,
                        cudaStream_t s) {
  if (table_bytes != 1 && table_bytes != 4) return cudaErrorInvalidValue;
  const auto kernel = accumulate ? lut_addr_kernel<true> : lut_addr_kernel<false>;
  const int smem = accumulate ? addr_smem<true>() : addr_smem<false>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, block, smem, s>>>((const int*)x, table, table_bytes, rounds, (int*)out, n);
  return cudaGetLastError();
}

template <typename Table, typename Entry, bool Acc>
cudaError_t launch_chain(const void* x, long long n, const void* table, int rounds, int block,
                         int grid, void* out, cudaStream_t stream) {
  lut_chain_kernel<Table, Entry, Acc><<<grid, block, Table::smem_bytes(), stream>>>(
      (const int*)x, (const Entry*)table, rounds, (int*)out, n);
  return cudaGetLastError();
}

template <int F>
cudaError_t chain_form(const void* x, long long n, const void* table, int table_bytes,
                       int rounds, int accumulate, int block, int grid, void* out,
                       cudaStream_t s) {
  if (table_bytes == 1) {
    return accumulate
               ? launch_chain<ByteTable<F>, uint8_t, true>(x, n, table, rounds, block, grid, out, s)
               : launch_chain<ByteTable<F>, uint8_t, false>(x, n, table, rounds, block, grid, out, s);
  }
  return accumulate
             ? launch_chain<WordTable<F>, unsigned, true>(x, n, table, rounds, block, grid, out, s)
             : launch_chain<WordTable<F>, unsigned, false>(x, n, table, rounds, block, grid, out, s);
}

template <int F>
cudaError_t wide_form(const void* x0, long long n, const void* p32, const void* lens,
                      int rounds, int block, int grid, void* out, cudaStream_t s) {
  lut_wide_kernel<F><<<grid, block, WideTable<F>::smem_bytes(), s>>>(
      (const int*)x0, (const unsigned*)p32, (const int*)lens, rounds, (int*)out, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// form: 0 smem, 1 smem_rep, 2 ldg, 3 l2, 4 shfl, 6 addr. table: 256
// entries of table_bytes (1: uint8, 4: int32). block must be a multiple of
// 32; addr takes 33 KB of shared memory a block (65 KB with accumulate),
// so blocks of 1024 threads, two an SM, fill it with 2048.
int thc_probe_lut_chain(int device, const void* x, long long n, const void* table,
                        int table_bytes, int rounds, int accumulate, int form, int block,
                        int grid, void* out, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (form) {
    case kSmem: return (int)chain_form<kSmem>(x, n, table, table_bytes, rounds, accumulate, block, grid, out, s);
    case kSmemRep: return (int)chain_form<kSmemRep>(x, n, table, table_bytes, rounds, accumulate, block, grid, out, s);
    case kLdg: return (int)chain_form<kLdg>(x, n, table, table_bytes, rounds, accumulate, block, grid, out, s);
    case kL2: return (int)chain_form<kL2>(x, n, table, table_bytes, rounds, accumulate, block, grid, out, s);
    case kShfl: return (int)chain_form<kShfl>(x, n, table, table_bytes, rounds, accumulate, block, grid, out, s);
    case kAddr: return (int)launch_addr(x, n, table, table_bytes, rounds, accumulate, block, grid, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// form: as above, plus 5 packed.
int thc_probe_lut_wide(int device, const void* x0, long long n, const void* p32,
                       const void* lens, int rounds, int form, int block, int grid,
                       void* out, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (form) {
    case kSmem: return (int)wide_form<kSmem>(x0, n, p32, lens, rounds, block, grid, out, s);
    case kSmemRep: return (int)wide_form<kSmemRep>(x0, n, p32, lens, rounds, block, grid, out, s);
    case kLdg: return (int)wide_form<kLdg>(x0, n, p32, lens, rounds, block, grid, out, s);
    case kL2: return (int)wide_form<kL2>(x0, n, p32, lens, rounds, block, grid, out, s);
    case kShfl: return (int)wide_form<kShfl>(x0, n, p32, lens, rounds, block, grid, out, s);
    case kPacked: return (int)wide_form<kPacked>(x0, n, p32, lens, rounds, block, grid, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// lut_wide's word form: words, 256 marker-bit entries (prof/lut.py:
// word_table). block: a multiple of 32; a block takes 64 KB of shared
// memory (32 KB of copies at a 32 KB boundary), so blocks of 1024 threads,
// two an SM, fill it with 2048.
int thc_probe_lut_word(int device, const void* x0, long long n, const void* words, int rounds,
                       int block, int grid, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(lut_word_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWordSmem);
  if (err != cudaSuccess) return (int)err;
  lut_word_kernel<<<grid, block, kWordSmem, (cudaStream_t)stream>>>(
      (const int*)x0, (const unsigned*)words, rounds, (int*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
