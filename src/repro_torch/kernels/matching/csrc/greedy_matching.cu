// Greedy matching kernels for the Cocktail scheduler, CUDA C++ for sm_90a.
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/matching/kernel.py:
//   greedy_collection_kernel  <- greedy_collection_pallas (_collection_kernel)
//   greedy_assignment_kernel  <- greedy_assignment_pallas (_greedy_kernel)
//   greedy_pairing_kernel     <- greedy_pairing_pallas    (_pairing_kernel)
// and computes bit for bit what the plain PyTorch versions in ../ref.py
// compute.
//
// What bounds them on an H100: neither bytes nor operations. Each matcher is
// a chain of up to N (collection) or M (assignment, pairing) dependent
// argmax-and-update steps over an (N, M) tile; one step cannot start before
// the previous one has updated the loop state. The roofline time of the work
// (a few microseconds at N x M = 1024 x 32) is far below the latency of that
// chain, so what counts is the latency of one step.
//
// The TPU kernels run the loop as a sequential grid whose steps share
// scratch memory; on Hopper grid blocks run in no order and share nothing, so
// here the whole loop runs inside ONE thread block per problem (leading batch
// axes are flattened into gridDim.x, so a batch of problems fills more SMs).
// Every argmax carries (value, flat index) and prefers the lower row-major
// index on equal values (torch.argmax / jnp.argmax order). The loop breaks
// once the best value is not positive (the TPU kernel runs no-op grid steps
// instead; the output is the same). Masks are applied by the caller before
// the launch; the kernels are mask-free.
//
// Collection (the long chain: one step per CU taken, up to N of them) keeps
// each EC column's best gain instead of rescanning the tile. The gain
// logw[i, j] - pen[count_j] has one penalty per column, so each column keeps
// its own argmax (gain, lowest row) as one 64-bit key, (order-preserving bits
// of the gain) << 32 | ~row, so that an integer max is the argmax. A step:
//   1. warp 0 takes the argmax over the M column keys (ties: lowest flat
//      index row * M + col) with two warp reductions (__reduce_max_sync on
//      the gain bits, __reduce_min_sync on the flat index);
//   2. it takes (i*, j*) or stops, writes -1e30 into row i* of the tile (the
//      row leaves every column, as the plain version's assigned rows do) and
//      marks stale column j* (its penalty moved) and every column whose best
//      row was i*;
//   3. all warps rescan only the stale columns, one warp a column or, when
//      fewer columns are stale than warps, a power of two of warps a column
//      whose shares warp 0 merges by a shuffle butterfly before step 1
//      (no atomics: one column's warps would contend for one address).
// This is exact: removing a row that is not a column's best leaves that
// column's argmax as it was, and only j*'s penalty moves. Column rescans
// are redone in full, so rounding of x - pen (two weights one ulp apart can
// give equal gains) is resolved exactly as the plain version resolves it.
// The tile is stored column-major, so a warp reads 32 consecutive rows of a
// column: in dynamic shared memory with an odd stride (conflict-free also
// while it is transposed in) when it fits (1024 x 32: 128 KB), else in a
// scratch buffer in global memory that the wrapper allocates and the kernel
// fills in the same launch (4096 x 64: 1 MB, read from L2). Non-finite
// weights become -1e30 there, so every gain is finite. The penalty table
// pen[0..N] is computed by the wrapper with the plain version's own PyTorch
// code and staged in shared memory, so gain = logw - pen[count] is the same
// single float32 subtraction in both.
//
// Assignment and pairing (chains of at most M steps) rescan the masked
// tile every step: a strided scan, a warp-shuffle plus shared-memory argmax
// in which a NaN beats every number and the first NaN wins, a single-thread
// update of the loop state, then __syncthreads(). Their tile sits in shared
// memory when it fits (227 KB opt-in), else it is read from L2 every step.
//
// Interface: plain C, one launcher per kernel, returning the cudaError_t of
// the launch (0 on success). Pointers are device pointers to contiguous
// float32 arrays; the stream is a cudaStream_t; *in_smem_out (host) reports
// whether the tile was kept in shared memory.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
// Threads of the collection kernel's block, at most, with the tile in
// shared memory (fewer warps, shorter barriers) and in the global scratch
// (more loads in flight per column rescan).
constexpr int kCollSmemThreads = 256;
constexpr int kCollGlobalThreads = 1024;

struct Cand {
  float v;
  int idx;
};

// True if candidate a wins over b: NaN first, then the larger value, then
// the lower flat index.
__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an || bn) return an && (!bn || ai < bi);
  if (av != bv) return av > bv;
  return ai < bi;
}

// Block-wide argmax. Every thread passes its own best candidate; the result
// is valid in thread 0 only. Uses sv/si (kMaxWarps entries) as scratch; the
// caller must __syncthreads() before the next call reuses them.
__device__ __forceinline__ Cand block_argmax(Cand c, float* sv, int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, c.v, off);
    const int oi = __shfl_down_sync(0xffffffffu, c.idx, off);
    if (beats(ov, oi, c.v, c.idx)) { c.v = ov; c.idx = oi; }
  }
  if (lane == 0) { sv[warp] = c.v; si[warp] = c.idx; }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    c.v = lane < n_warps ? sv[lane] : -CUDART_INF_F;
    c.idx = lane < n_warps ? si[lane] : INT32_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, c.v, off);
      const int oi = __shfl_down_sync(0xffffffffu, c.idx, off);
      if (beats(ov, oi, c.v, c.idx)) { c.v = ov; c.idx = oi; }
    }
  }
  return c;
}

// Shared-memory layout shared by the three kernels:
//   [tile: n*m floats, only when in_smem] [choice: n ints] [colval: m floats]
//   [count: m ints] [flags: 4 ints]
// choice[i] is the column chosen for row i (-1 none); colval/count are the
// per-column state (collection: penalty and connection count; assignment:
// taken flag). For pairing the "rows" are ECs and choice[j] is the partner.
struct Smem {
  float* tile;
  int* choice;
  float* colval;
  int* count;
  int* flags;
};

__host__ __device__ inline size_t smem_bytes(int n, int m, bool in_smem) {
  return (in_smem ? sizeof(float) * (size_t)n * m : 0) + sizeof(int) * (size_t)n +
         sizeof(float) * (size_t)m + sizeof(int) * (size_t)m + sizeof(int) * 4;
}

__device__ inline Smem carve(char* base, int n, int m, bool in_smem) {
  Smem s;
  s.tile = reinterpret_cast<float*>(base);
  char* p = base + (in_smem ? sizeof(float) * (size_t)n * m : 0);
  s.choice = reinterpret_cast<int*>(p);
  p += sizeof(int) * (size_t)n;
  s.colval = reinterpret_cast<float*>(p);
  p += sizeof(float) * (size_t)m;
  s.count = reinterpret_cast<int*>(p);
  p += sizeof(int) * (size_t)m;
  s.flags = reinterpret_cast<int*>(p);
  return s;
}

// Loads the tile into shared memory (when it lives there) and resets the
// row state; returns the pointer the scan reads.
__device__ inline const float* stage_tile(const float* g, Smem s, int n, int m,
                                          bool in_smem) {
  const int nm = n * m;
  if (in_smem)
    for (int e = threadIdx.x; e < nm; e += blockDim.x) s.tile[e] = g[e];
  for (int i = threadIdx.x; i < n; i += blockDim.x) s.choice[i] = -1;
  return in_smem ? s.tile : g;
}

// Writes out[i, j] = (choice[i] == j) (pairing also sets the mirror entry,
// since choice is symmetric there).
__device__ inline void write_choice(float* out, const int* choice, int n, int m) {
  const int nm = n * m;
  for (int e = threadIdx.x; e < nm; e += blockDim.x) {
    const int i = e / m, j = e - i * m;
    out[e] = choice[i] == j ? 1.0f : 0.0f;
  }
}

// --- Collection: cached per-column maxima -----------------------------------

// Order-preserving bits of a finite float: a > b as floats iff ord(a) >
// ord(b) as integers; -0 is folded into +0 (they compare equal as floats).
__device__ __forceinline__ uint32_t ord_bits(float g) {
  const uint32_t u = __float_as_uint(g == 0.0f ? 0.0f : g);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ord(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Shared-memory layout of the collection kernel:
//   [colkey: m u64] [part: 32 u64] [tile: m * ld floats, only when in smem]
//   [pen: n + 1] [colpen: m floats] [choice: n ints] [count: m] [stale: m]
//   [per_shift: 33] [flags: 4]
// colkey[j] is column j's best as (ord(gain) << 32 | ~row), 0 while stale;
// part[w] is warp w's share of a column split over several warps;
// colpen[j] = pen[count[j]]; stale[0..flags[1]) lists the columns to
// rescan; 1 << per_shift[s] warps share a column when s are stale;
// flags[0] is the stop flag.
struct CollSmem {
  unsigned long long* colkey;
  unsigned long long* part;
  float* tile;
  float* pen;
  float* colpen;
  int* choice;
  int* count;
  int* stale;
  int* per_shift;
  int* flags;
};

// Column stride of the tile: odd in shared memory (the transposing stores
// of a warp then hit distinct banks), n in the global scratch (coalesced).
__host__ __device__ inline int coll_ld(int n, bool in_smem) { return in_smem ? (n | 1) : n; }

__host__ __device__ inline size_t coll_smem_bytes(int n, int m, bool in_smem) {
  return sizeof(unsigned long long) * ((size_t)m + kMaxWarps) +
         (in_smem ? sizeof(float) * (size_t)m * coll_ld(n, true) : 0) +
         sizeof(float) * (size_t)(n + 1) + sizeof(float) * (size_t)m +
         sizeof(int) * ((size_t)n + 2 * (size_t)m + kMaxWarps + 1 + 4);
}

__device__ inline CollSmem coll_carve(char* base, int n, int m, bool in_smem) {
  CollSmem s;
  s.colkey = reinterpret_cast<unsigned long long*>(base);
  s.part = s.colkey + m;
  char* p = base + sizeof(unsigned long long) * ((size_t)m + kMaxWarps);
  s.tile = reinterpret_cast<float*>(p);
  if (in_smem) p += sizeof(float) * (size_t)m * coll_ld(n, true);
  s.pen = reinterpret_cast<float*>(p);
  p += sizeof(float) * (size_t)(n + 1);
  s.colpen = reinterpret_cast<float*>(p);
  p += sizeof(float) * (size_t)m;
  s.choice = reinterpret_cast<int*>(p);
  p += sizeof(int) * (size_t)n;
  s.count = reinterpret_cast<int*>(p);
  p += sizeof(int) * (size_t)m;
  s.stale = reinterpret_cast<int*>(p);
  p += sizeof(int) * (size_t)m;
  s.per_shift = reinterpret_cast<int*>(p);
  p += sizeof(int) * (size_t)(kMaxWarps + 1);
  s.flags = reinterpret_cast<int*>(p);
  return s;
}

// One warp's share of a column rescan: rows first_row + lane + q stride
// below n. Returns their best as a column key (0 if there is no row), in
// every lane.
__device__ __forceinline__ unsigned long long rescan_rows(const float* __restrict__ col, float p,
                                                          int first_row, int stride, int n) {
  const int lane = threadIdx.x & 31;
  uint32_t best_o = 0, best_r = 0xffffffffu;
#pragma unroll 4
  for (int i = first_row + lane; i < n; i += stride) {
    const uint32_t o = ord_bits(col[i] - p);
    if (o > best_o) {  // rows rise along a lane: the first maximum is the lowest row
      best_o = o;
      best_r = (uint32_t)i;
    }
  }
  const uint32_t mo = __reduce_max_sync(0xffffffffu, best_o);
  const uint32_t row = __reduce_min_sync(0xffffffffu, best_o == mo ? best_r : 0xffffffffu);
  return mo == 0 ? 0ull : ((unsigned long long)mo << 32) | (unsigned long long)(0xffffffffu - row);
}

// InSmem: the column-major tile lives in shared memory (else in the global
// scratch); a template parameter, so that its loads compile to LDS / LDG
// rather than generic loads.
template <bool InSmem>
__global__ void greedy_collection_kernel(const float* __restrict__ logw,
                                         const float* __restrict__ pen_g,
                                         float* __restrict__ alpha,
                                         float* __restrict__ scratch, int n, int m) {
  extern __shared__ __align__(16) char smem_raw[];
  const size_t off = (size_t)blockIdx.x * n * m;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  CollSmem s = coll_carve(smem_raw, n, m, InSmem);
  const int ld = coll_ld(n, InSmem);
  float* tile = InSmem ? s.tile : scratch + off;

  // Stage the tile column-major, non-finite weights as -1e30.
  const float* w = logw + off;
  const int nm = n * m;
  for (int e = threadIdx.x; e < nm; e += blockDim.x) {
    const int i = e / m, j = e - i * m;
    const float x = w[e];
    tile[(size_t)j * ld + i] = isfinite(x) ? x : kNeg;
  }
  for (int c = threadIdx.x; c <= n; c += blockDim.x) s.pen[c] = pen_g[c];
  for (int i = threadIdx.x; i < n; i += blockDim.x) s.choice[i] = -1;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    s.colkey[j] = 0ull;
    s.count[j] = 0;
    s.colpen[j] = pen_g[0];
    s.stale[j] = j;  // every column is scanned once at the start
  }
  for (int q = threadIdx.x + 1; q <= n_warps; q += blockDim.x) {
    int sh = 0;  // the largest power of two of warps per column: (2 << sh) * q > n_warps
    while ((2 << sh) * q <= n_warps) ++sh;
    s.per_shift[q] = sh;
  }
  if (threadIdx.x == 0) {
    s.flags[0] = 0;
    s.flags[1] = m;
  }
  __syncthreads();

  for (int it = 0; it < n; ++it) {
    // Rescan the stale columns: whole columns a warp when there are at
    // least as many as warps, else a power of two of warps a column, each
    // leaving its share in part[] for warp 0 to merge.
    const int n_stale = s.flags[1];
    if (n_stale >= n_warps) {
      for (int q = warp; q < n_stale; q += n_warps) {
        const int c = s.stale[q];
        const unsigned long long key = rescan_rows(tile + (size_t)c * ld, s.colpen[c], 0, 32, n);
        if (lane == 0) s.colkey[c] = key;
      }
    } else {
      const int sh = s.per_shift[n_stale];
      if (warp < (n_stale << sh)) {
        const int c = s.stale[warp >> sh];
        const unsigned long long key = rescan_rows(
            tile + (size_t)c * ld, s.colpen[c], 32 * (warp & ((1 << sh) - 1)), 32 << sh, n);
        if (lane == 0) s.part[warp] = key;
      }
    }
    __syncthreads();

    if (warp == 0) {
      if (n_stale < n_warps) {  // merge the shares: a butterfly within groups of 1 << sh lanes
        const int sh = s.per_shift[n_stale];
        const bool used = lane < (n_stale << sh);
        unsigned long long key = used ? s.part[lane] : 0ull;
        for (int o = 1; o < (1 << sh); o <<= 1) {
          const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, o);
          key = other > key ? other : key;
        }
        if (used && (lane & ((1 << sh) - 1)) == 0) s.colkey[s.stale[lane >> sh]] = key;
        __syncwarp();
      }
      // Argmax over the column bests: largest gain, then lowest flat index
      // row * m + col, compared as (row << 16 | col) (the launcher keeps
      // n and m below 2^16).
      uint32_t bo = 0, bf = 0xffffffffu;
      for (int c = lane; c < m; c += 32) {
        const unsigned long long key = s.colkey[c];
        const uint32_t o = (uint32_t)(key >> 32);
        const uint32_t flat = ((0xffffffffu - (uint32_t)key) << 16) | (uint32_t)c;
        if (o > bo || (o == bo && flat < bf)) {
          bo = o;
          bf = flat;
        }
      }
      const uint32_t mo = __reduce_max_sync(0xffffffffu, bo);
      const uint32_t flat = __reduce_min_sync(0xffffffffu, bo == mo ? bf : 0xffffffffu);
      if (mo != 0 && from_ord(mo) > 0.0f) {
        const int bi = (int)(flat >> 16), bj = (int)(flat & 0xffffu);
        if (lane == 0) {
          s.choice[bi] = bj;
          const int cnt = ++s.count[bj];
          s.colpen[bj] = s.pen[cnt];
        }
        // Row bi leaves every column; j* and the columns whose best was bi
        // become stale.
        int n_new = 0;
        for (int c0 = 0; c0 < m; c0 += 32) {
          const int c = c0 + lane;
          bool st = false;
          if (c < m) {
            tile[(size_t)c * ld + bi] = kNeg;
            const unsigned long long key = s.colkey[c];
            st = c == bj || 0xffffffffu - (uint32_t)key == (uint32_t)bi;
            if (st) s.colkey[c] = 0ull;
          }
          const unsigned ballot = __ballot_sync(0xffffffffu, st);
          if (st) s.stale[n_new + __popc(ballot & ((1u << lane) - 1u))] = c;
          n_new += __popc(ballot);
        }
        if (lane == 0) s.flags[1] = n_new;
      } else if (lane == 0) {
        s.flags[0] = 1;  // no positive gain is left
      }
    }
    __syncthreads();
    if (s.flags[0]) break;
  }
  write_choice(alpha + off, s.choice, n, m);
}

__global__ void greedy_assignment_kernel(const float* __restrict__ w_in,
                                         float* __restrict__ alpha, int n, int m,
                                         int in_smem) {
  extern __shared__ __align__(16) char smem_raw[];
  __shared__ float red_v[kMaxWarps];
  __shared__ int red_i[kMaxWarps];
  const size_t off = (size_t)blockIdx.x * n * m;
  Smem s = carve(smem_raw, n, m, in_smem);
  const float* w = stage_tile(w_in + off, s, n, m, in_smem);
  for (int j = threadIdx.x; j < m; j += blockDim.x) s.count[j] = 0;  // EC taken
  if (threadIdx.x == 0) s.flags[0] = 0;
  __syncthreads();

  const int nm = n * m;
  const int step_i = blockDim.x / m, step_j = blockDim.x % m;
  for (int it = 0; it < m; ++it) {
    Cand c{-CUDART_INF_F, INT32_MAX};
    int i = threadIdx.x / m, j = threadIdx.x % m;
    for (int e = threadIdx.x; e < nm; e += blockDim.x) {
      const float x = w[e];
      // w > 0 drops NaN and non-positive weights, as in the plain version.
      const float g = (x > 0.0f && s.choice[i] < 0 && s.count[j] == 0) ? x : kNeg;
      if (beats(g, e, c.v, c.idx)) { c.v = g; c.idx = e; }
      i += step_i;
      j += step_j;
      if (j >= m) { j -= m; ++i; }
    }
    c = block_argmax(c, red_v, red_i);
    if (threadIdx.x == 0) {
      if (c.v > 0.0f) {
        const int bi = c.idx / m, bj = c.idx - bi * m;
        s.choice[bi] = bj;
        s.count[bj] = 1;
      } else {
        s.flags[0] = 1;  // nothing positive is left: the state is final
      }
    }
    __syncthreads();
    if (s.flags[0]) break;
  }
  write_choice(alpha + off, s.choice, n, m);
}

__global__ void greedy_pairing_kernel(const float* __restrict__ w_in,
                                      float* __restrict__ match, int m,
                                      int in_smem) {
  extern __shared__ __align__(16) char smem_raw[];
  __shared__ float red_v[kMaxWarps];
  __shared__ int red_i[kMaxWarps];
  const size_t off = (size_t)blockIdx.x * m * m;
  Smem s = carve(smem_raw, m, m, in_smem);
  const float* w = stage_tile(w_in + off, s, m, m, in_smem);
  if (threadIdx.x == 0) s.flags[0] = 0;
  __syncthreads();

  const int mm = m * m;
  const int step_i = blockDim.x / m, step_j = blockDim.x % m;
  for (int it = 0; it < m; ++it) {
    Cand c{-CUDART_INF_F, INT32_MAX};
    int i = threadIdx.x / m, j = threadIdx.x % m;
    for (int e = threadIdx.x; e < mm; e += blockDim.x) {
      // No sanitizing: a NaN among the free entries wins and stops the loop.
      const float g = (s.choice[i] < 0 && s.choice[j] < 0) ? w[e] : kNeg;
      if (beats(g, e, c.v, c.idx)) { c.v = g; c.idx = e; }
      i += step_i;
      j += step_j;
      if (j >= m) { j -= m; ++i; }
    }
    c = block_argmax(c, red_v, red_i);
    if (threadIdx.x == 0) {
      if (c.v > 0.0f) {
        const int bj = c.idx / m, bk = c.idx - bj * m;
        s.choice[bj] = bk;
        s.choice[bk] = bj;
      } else {
        s.flags[0] = 1;
      }
    }
    __syncthreads();
    if (s.flags[0]) break;
  }
  write_choice(match + off, s.choice, m, m);
}

int threads_for(long long nm) {
  long long t = (nm + 31) / 32 * 32;
  if (t > kMaxThreads) t = kMaxThreads;
  if (t < 32) t = 32;
  return (int)t;
}

// Chooses shared-memory residency of the tile and opts in to more than
// 48 KB of dynamic shared memory when needed. Returns the dynamic size.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int n, int m, int* in_smem, size_t* bytes,
                    size_t (*layout_bytes)(int, int, bool) = smem_bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  // Leave room for the static reduction scratch.
  const size_t budget = (size_t)optin - 2 * sizeof(int) * kMaxWarps;
  *in_smem = layout_bytes(n, m, true) <= budget ? 1 : 0;
  *bytes = layout_bytes(n, m, *in_smem != 0);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

}  // namespace

extern "C" {

// logw, alpha: (k, n, m); pen: (n + 1,); scratch: (k, m, n), used as the
// column-major tile when it does not fit in shared memory. n, m < 2^16.
int greedy_collection_launch(const float* logw, const float* pen, float* alpha,
                             float* scratch, int k, int n, int m, void* stream,
                             int* in_smem_out) {
  cudaGetLastError();  // clear a stale, non-sticky error
  if (n >= (1 << 16) || m >= (1 << 16)) return (int)cudaErrorInvalidValue;
  int in_smem = 0;
  size_t bytes = 0;
  cudaError_t err = prepare(greedy_collection_kernel<true>, n, m, &in_smem, &bytes,
                            coll_smem_bytes);
  if (err != cudaSuccess) return (int)err;
  *in_smem_out = in_smem;
  const int threads = threads_for((long long)n * m);
  const int cap = in_smem ? kCollSmemThreads : kCollGlobalThreads;
  if (in_smem) {
    greedy_collection_kernel<true><<<k, threads < cap ? threads : cap, bytes,
                                     (cudaStream_t)stream>>>(logw, pen, alpha, scratch, n, m);
  } else {
    err = cudaFuncSetAttribute(greedy_collection_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    greedy_collection_kernel<false><<<k, threads < cap ? threads : cap, bytes,
                                      (cudaStream_t)stream>>>(logw, pen, alpha, scratch, n, m);
  }
  return (int)cudaGetLastError();
}

// w, alpha: (k, n, m).
int greedy_assignment_launch(const float* w, float* alpha, int k, int n, int m,
                             void* stream, int* in_smem_out) {
  cudaGetLastError();
  int in_smem = 0;
  size_t bytes = 0;
  cudaError_t err = prepare(greedy_assignment_kernel, n, m, &in_smem, &bytes);
  if (err != cudaSuccess) return (int)err;
  *in_smem_out = in_smem;
  greedy_assignment_kernel<<<k, threads_for((long long)n * m), bytes,
                             (cudaStream_t)stream>>>(w, alpha, n, m, in_smem);
  return (int)cudaGetLastError();
}

// w, match: (k, m, m).
int greedy_pairing_launch(const float* w, float* match, int k, int m, void* stream,
                          int* in_smem_out) {
  cudaGetLastError();
  int in_smem = 0;
  size_t bytes = 0;
  cudaError_t err = prepare(greedy_pairing_kernel, m, m, &in_smem, &bytes);
  if (err != cudaSuccess) return (int)err;
  *in_smem_out = in_smem;
  greedy_pairing_kernel<<<k, threads_for((long long)m * m), bytes,
                          (cudaStream_t)stream>>>(w, match, m, in_smem);
  return (int)cudaGetLastError();
}

const char* greedy_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
