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
// chain, so what counts is the latency of one step, and that no step reads
// more than it must.
//
// The TPU kernels run the loop as a sequential grid whose steps share
// scratch memory; on Hopper grid blocks run in no order and share nothing, so
// here the whole loop runs inside ONE thread block (pairing: one warp) per
// problem; leading batch axes are flattened, so a batch of problems fills
// more SMs. Every argmax prefers the lower row-major flat index on equal
// values (torch.argmax / jnp.argmax order). The loop breaks once the best
// value is not positive (the TPU kernel runs no-op grid steps instead; the
// output is the same). Masks are applied by the caller before the launch;
// the kernels are mask-free. Row and column indices are packed as
// row << 16 | col, so that one 32-bit minimum is the lowest flat index: the
// launchers refuse N or M of 2^16 or more.
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
// Assignment (plain P1, at most L = min(N, M) steps, M <= 64) takes the
// tile out of the chain. Weights never change; only rows and columns leave.
// While column j is free at most L - 1 rows have left, so its best free row
// is among its L best positive entries, keyed ord(w) << 32 | ~row (w > 0
// only: NaN and non-positive weights are never candidates, +inf is; an
// integer max is the largest weight, lowest row first). So:
//   1. a parallel prologue, one warp a column, stages the tile through
//      shared memory (whole at 1024 x 32; in row chunks at 4096 x 64, read
//      once a pass) and finds each column's top-L list in three passes:
//      a. each lane keeps its top 2 C values (C columns a lane, below); the
//         L-th best of the warp's 64 C values, taken by a bitwise search of
//         warp sums, bounds the column's L-th best value from below;
//      b. the keys at or above that bound are gathered by ballots (a
//         little more than L of them on rows in random order);
//      c. each gathered key's rank is the number of larger ones (a count
//         over the list, four keys a lane), which sorts the list.
//      More than 128 keys at the bound (many equal values) send the column
//      down an insertion path instead: each key that beats the list's last
//      enters by a rank count (ballots) and a one-place shift (shuffles).
//      Insertion for every column (the first design) costs L (1 + ln(N / L))
//      such insertions a column on rows in random order, and 32 warps of
//      them bound the kernel by the SM's instruction issue;
//   2. one warp runs the chain with no block barrier: lane l holds the head
//      (best free candidate) of columns l and l + 32; a step is two warp
//      reductions over the heads (key bits, then row << 16 | col); the
//      taken row goes into a bitmap in shared memory, j*'s head is retired,
//      and every lane whose head row was i* walks down its list past taken
//      rows. The chain never reads the tile again; an exhausted list means
//      the column has no free positive entry left;
//   3. the other warps zero alpha while the chain runs, then every thread
//      writes the ones.
// Weights in which one factor per CU ranks the same rows first in every
// column (the main path's d_ij (mu_i - eta_ij - c_ij)) cost one list step
// per column per selection, not a rescan.
//
// Pairing (Thm. 2, at most M steps on an (M, M) value matrix, no
// sanitising) runs in one warp per problem, several problems a block when
// a batch outnumbers the SMs. Each value is ranked once: NaN first (argmax
// ranks it above every number), then its order-preserving bits. Lane r
// holds row r's best free column (rank, then the lowest column); a step is
// two warp reductions over the rows, stops at a NaN or a value that is not
// positive, retires rows j* and k*, and only lanes whose cached column was
// j* or k* rescan their own row. Up to M = 64 (the "warp" variant) each
// lane holds its one or two rows as 32 or 64 ranks in registers, loaded
// straight from global memory, and the free set is a 64-bit mask in two
// registers: a rescan is four masked argmaxes over the registers, one pass
// a lane whichever of its rows it is, with no load. Above 64 (the "wide"
// variant) the free mask, the row bests and the partners live in shared
// memory, and the tile too where it fits (odd row stride: lanes walking
// their rows side by side hit distinct banks), else the rows are read from
// global memory.
//
// Interface: plain C, one launcher per kernel, returning the cudaError_t of
// the launch (0 on success). Pointers are device pointers to contiguous
// float32 arrays; the stream is a cudaStream_t; *in_smem_out (host) reports
// the variant taken: bit 0 is set when the whole tile was held in shared
// memory, bit 1 when pairing took its register (M <= 64) variant.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
// Threads of the collection kernel's block, at most, with the tile in
// shared memory (fewer warps, shorter barriers) and in the global scratch
// (more loads in flight per column rescan).
constexpr int kCollSmemThreads = 256;
constexpr int kCollGlobalThreads = 1024;
// Assignment: columns a lane of the chain warp are 1 or 2, so M <= 64; a
// column's gathered keys, at most kAssignListMax, fit its list region.
constexpr int kAssignMaxM = 64;
constexpr int kAssignListMax = 128;
// Pairing: the register variant's largest M, and problems (warps) a block.
constexpr int kPairWarpMaxM = 64;
constexpr int kPairMaxWarps = 8;

// Writes out[i, j] = (choice[i] == j).
__device__ inline void write_choice(float* out, const int* choice, int n, int m) {
  const int nm = n * m;
  for (int e = threadIdx.x; e < nm; e += blockDim.x) {
    const int i = e / m, j = e - i * m;
    out[e] = choice[i] == j ? 1.0f : 0.0f;
  }
}

// Zeroes count floats at p, thread t of T.
__device__ inline void zero_fill(float* p, int count, int t, int T) {
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const int n4 = count >> 2;
    for (int e = t; e < n4; e += T) reinterpret_cast<float4*>(p)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    head = n4 << 2;
  }
  for (int e = head + t; e < count; e += T) p[e] = 0.0f;
}

// Copies count floats of a row-major tile with m columns (row stride m) into
// shared memory with row stride ld, thread t of T, U loads in flight a
// thread: 16-byte loads (four floats of one row) where m % 4 == 0 and src is
// 16-byte aligned, else 4-byte ones.
template <int U>
__device__ inline void stage_rows(const float* __restrict__ src, float* dst, int count, int m,
                                  int ld, int t, int T) {
  const bool vec = (m & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int width = vec ? 4 : 1;  // floats a load
  const int units = count / width, mu = m / width;
  const int di = T / mu, dj = T - di * mu;
  int i = t / mu, j = t - i * mu;
  for (int e0 = t; e0 < units; e0 += U * T) {
    float4 v[U];
    int at[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * T;
      if (e < units)
        v[u] = vec ? __ldg(reinterpret_cast<const float4*>(src) + e)
                   : make_float4(__ldg(src + e), 0.f, 0.f, 0.f);
      at[u] = i * ld + j * width;
      i += di;
      j += dj;
      if (j >= mu) { j -= mu; ++i; }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (e0 + u * T >= units) continue;
      dst[at[u]] = v[u].x;
      if (vec) {
        dst[at[u] + 1] = v[u].y;
        dst[at[u] + 2] = v[u].z;
        dst[at[u] + 3] = v[u].w;
      }
    }
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

// --- Assignment: candidate lists and a warp-only chain -----------------------

// Candidate key of weight x in row `row`: ord(x) << 32 | ~row for x > 0 (an
// integer max is then the largest weight, lowest row first), else 0 (NaN and
// non-positive weights are never selected). +inf is a candidate.
__device__ __forceinline__ unsigned long long cand_key(float x, int row) {
  return x > 0.0f ? ((unsigned long long)(__float_as_uint(x) | 0x80000000u) << 32) |
                        (unsigned long long)(0xffffffffu - (uint32_t)row)
                  : 0ull;
}

__device__ __forceinline__ int key_row(unsigned long long key) {
  return (int)(0xffffffffu - (uint32_t)key);
}

// Inserts key k into a warp's sorted (descending) list of at most len keys,
// rank 32 s + lane in slot a[s] of each lane, 0 past the end; returns the new
// rank len - 1 key (0 while the list is not full), in every lane.
template <int C>
__device__ __forceinline__ unsigned long long list_insert(unsigned long long (&a)[C],
                                                          unsigned long long k, int len,
                                                          int lane) {
  int pos = 0;
#pragma unroll
  for (int s = 0; s < C; ++s) pos += __popc(__ballot_sync(kFull, a[s] > k));
#pragma unroll
  for (int s = C - 1; s >= 0; --s) {  // descending: a[s - 1] is still the old slot
    const unsigned long long up = __shfl_up_sync(kFull, a[s], 1);
    const unsigned long long prev = __shfl_sync(kFull, a[s > 0 ? s - 1 : 0], 31);
    const int r = 32 * s + lane;
    const unsigned long long below = lane > 0 ? up : (s > 0 ? prev : 0ull);
    a[s] = r >= len ? 0ull : r < pos ? a[s] : r == pos ? k : below;
  }
  const int last = len - 1;
  unsigned long long v = a[0];
#pragma unroll
  for (int s = 1; s < C; ++s)
    if (s == (last >> 5)) v = a[s];
  return __shfl_sync(kFull, v, last & 31);
}

// Order-preserving bits of x for x > 0, else 0 (NaN and non-positive
// weights are never selected); cand_key's upper half.
__device__ __forceinline__ uint32_t pos_ord(float x) {
  return x > 0.0f ? __float_as_uint(x) | 0x80000000u : 0u;
}

// Inserts o into a lane's top values t[0] >= t[1] >= ... (a min / max
// network; t[s - 1] is still the old one when t[s] is updated).
template <int K>
__device__ __forceinline__ void top_insert(uint32_t (&t)[K], uint32_t o) {
#pragma unroll
  for (int s = K - 1; s > 0; --s) t[s] = max(t[s], min(t[s - 1], o));
  t[0] = max(t[0], o);
}

// The largest multiple of 256 with at least len of the warp's 32 K values t
// at or above it: since the t are entries of one column, a lower bound of
// the column's len-th best value (0 when fewer than len are positive).
template <int K>
__device__ __forceinline__ uint32_t lower_bound_of(const uint32_t (&t)[K], int len) {
  uint32_t v = 0;
#pragma unroll 1
  for (int b = 31; b >= 8; --b) {
    const uint32_t next = v | (1u << b);
    uint32_t cnt = 0;
#pragma unroll
    for (int s = 0; s < K; ++s) cnt += t[s] >= next ? 1u : 0u;
    if ((int)__reduce_add_sync(kFull, cnt) >= len) v = next;
  }
  return v;
}

// Dynamic shared memory of the assignment kernel:
//   [cand: m * kAssignListMax u64] [taken: ceil(n / 32) u32]
//   [picks: L + 1 ints] [chunk: rows * (m | 1) floats]
// cand[c * kAssignListMax + r] is column c's rank-r candidate key (0 past
// its end; the region first holds the column's gathered keys); taken is the
// bitmap of rows taken; picks[0..L) the chain's (row << 16 | col) picks and
// picks[L] their number; chunk a block of staged rows.
__host__ __device__ inline size_t assign_fixed_bytes(int n, int m) {
  const int len = n < m ? n : m;
  return sizeof(unsigned long long) * (size_t)m * kAssignListMax +
         sizeof(uint32_t) * (size_t)((n + 31) / 32) + sizeof(int) * (size_t)(len + 1);
}

// C: columns a warp in the prologue and a lane in the chain (M <= 32 C,
// L <= M). rows_per_chunk: rows staged at a time (all n: staged once).
template <int C>
__global__ void __launch_bounds__(kMaxThreads)
    greedy_assignment_kernel(const float* __restrict__ w_in, float* __restrict__ alpha, int n,
                             int m, int rows_per_chunk) {
  extern __shared__ __align__(16) char smem_raw[];
  constexpr int K = 2 * C;                   // top values a lane keeps: 2 L for the warp
  constexpr int S = kAssignListMax / 32;     // gathered keys a lane ranks
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int len = n < m ? n : m;
  const int words = (n + 31) >> 5;
  unsigned long long* cand = reinterpret_cast<unsigned long long*>(smem_raw);
  uint32_t* taken = reinterpret_cast<uint32_t*>(cand + (size_t)m * kAssignListMax);
  int* picks = reinterpret_cast<int*>(taken + words);
  float* chunk = reinterpret_cast<float*>(picks + len + 1);
  const int ld = m | 1;  // odd: a warp reading 32 rows of one column hits 32 banks
  const bool whole = rows_per_chunk >= n;
  const size_t off = (size_t)blockIdx.x * n * m;
  const float* w = w_in + off;

  for (int i = threadIdx.x; i < words; i += blockDim.x) taken[i] = 0u;
  // body(r0, rows) on each chunk of staged rows; a whole tile is staged once.
  const auto each_chunk = [&](auto&& body) {
    for (int r0 = 0; r0 < n; r0 += rows_per_chunk) {
      const int rows = min(rows_per_chunk, n - r0);
      if (!whole) {
        __syncthreads();  // the previous chunk is consumed
        stage_rows<4>(w + (size_t)r0 * m, chunk, rows * m, m, ld, threadIdx.x, blockDim.x);
        __syncthreads();
      }
      body(r0, rows);
    }
  };
  if (whole) {
    stage_rows<4>(w, chunk, n * m, m, ld, threadIdx.x, blockDim.x);
    __syncthreads();
  }

  // 1. Prologue, warp w on columns w + 32 q: each column's top-len keys.
  // a. A lower bound of the column's len-th best value: the len-th best of
  //    the lanes' top K values (K = 2 C: 2 L of the column's entries).
  uint32_t top[C][K];
#pragma unroll
  for (int q = 0; q < C; ++q)
#pragma unroll
    for (int s = 0; s < K; ++s) top[q][s] = 0u;
  each_chunk([&](int, int rows) {
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int c = warp + 32 * q;
      if (c < m)
        for (int i = lane; i < rows; i += 32) top_insert(top[q], pos_ord(chunk[i * ld + c]));
    }
  });
  uint32_t bound[C];
  int count[C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    bound[q] = warp + 32 * q < m ? lower_bound_of(top[q], len) : 0u;
    count[q] = 0;
  }
  // b. Gather the keys at or above the bound (at least len of them), in
  //    row order, up to kAssignListMax.
  each_chunk([&](int r0, int rows) {
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int c = warp + 32 * q;
      if (c >= m) continue;
      unsigned long long* buf = cand + (size_t)c * kAssignListMax;
      for (int i0 = 0; i0 < rows; i0 += 32) {
        const int i = i0 + lane;
        const uint32_t o = i < rows ? pos_ord(chunk[i * ld + c]) : 0u;
        const bool keep = o != 0u && o >= bound[q];
        const unsigned ballot = __ballot_sync(kFull, keep);
        const int at = count[q] + __popc(ballot & ((1u << lane) - 1u));
        if (keep && at < kAssignListMax)
          buf[at] = ((unsigned long long)o << 32) | (0xffffffffu - (uint32_t)(r0 + i));
        count[q] += __popc(ballot);
      }
    }
  });
  // c. Sort the gathered keys by counting, each key's rank the number of
  //    larger ones; keep ranks below len, end a shorter list with 0.
  bool overflow = false;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int c = warp + 32 * q;
    if (c >= m) continue;
    if (count[q] > kAssignListMax) {
      overflow = true;
      continue;
    }
    unsigned long long* buf = cand + (size_t)c * kAssignListMax;
    __syncwarp();
    unsigned long long key[S];
    int rank[S];
#pragma unroll
    for (int u = 0; u < S; ++u) {
      key[u] = lane + 32 * u < count[q] ? buf[lane + 32 * u] : 0ull;
      rank[u] = 0;
    }
    for (int e = 0; e < count[q]; ++e) {
      const unsigned long long x = buf[e];
#pragma unroll
      for (int u = 0; u < S; ++u) rank[u] += x > key[u] ? 1 : 0;
    }
    __syncwarp();  // every read is done
#pragma unroll
    for (int u = 0; u < S; ++u)
      if (lane + 32 * u < count[q] && rank[u] < len) buf[rank[u]] = key[u];
    for (int r = count[q] + lane; r < len; r += 32) buf[r] = 0ull;
  }
  // d. More than kAssignListMax keys at or above the bound (many equal
  //    values): build the column's list by insertion, each key that beats
  //    the list's last (and the bound) entering by a rank count (ballots)
  //    and a one-place shift (shuffles).
  if (__syncthreads_or(overflow)) {
    each_chunk([&](int r0, int rows) {
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const int c = warp + 32 * q;
        if (c >= m || count[q] <= kAssignListMax) continue;
        unsigned long long* list = cand + (size_t)c * kAssignListMax;
        unsigned long long a[C];
#pragma unroll
        for (int s = 0; s < C; ++s) {
          const int r = 32 * s + lane;
          a[s] = (r0 > 0 && r < len) ? list[r] : 0ull;
        }
        const unsigned long long floor_key =
            bound[q] != 0u ? ((unsigned long long)bound[q] << 32) - 1ull : 0ull;
        unsigned long long thr = r0 > 0 ? list[len - 1] : 0ull;
        thr = thr > floor_key ? thr : floor_key;
        for (int i0 = 0; i0 < rows; i0 += 32) {
          const int i = i0 + lane;
          const unsigned long long key = i < rows ? cand_key(chunk[i * ld + c], r0 + i) : 0ull;
          unsigned pass = __ballot_sync(kFull, key > thr);
          while (pass) {
            thr = list_insert<C>(a, __shfl_sync(kFull, key, __ffs(pass) - 1), len, lane);
            thr = thr > floor_key ? thr : floor_key;
            pass &= pass - 1;  // the lanes above, if they still beat the list's last
            pass &= __ballot_sync(kFull, key > thr);
          }
        }
#pragma unroll
        for (int s = 0; s < C; ++s) {
          const int r = 32 * s + lane;
          if (r < len) list[r] = a[s];
        }
      }
    });
  }
  __syncthreads();

  // 2. The chain, in warp 0; the other warps zero alpha meanwhile.
  float* out = alpha + off;
  if (warp == 0) {
    unsigned long long head[C];
    int pos[C];
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int c = lane + 32 * q;
      head[q] = c < m ? cand[(size_t)c * kAssignListMax] : 0ull;
      pos[q] = 0;
    }
    int steps = 0;
    for (; steps < len; ++steps) {
      uint32_t bo = 0, bf = 0xffffffffu;
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const uint32_t o = (uint32_t)(head[q] >> 32);
        const uint32_t f = ((uint32_t)key_row(head[q]) << 16) | (uint32_t)(lane + 32 * q);
        if (o > bo || (o == bo && f < bf)) {
          bo = o;
          bf = f;
        }
      }
      const uint32_t mo = __reduce_max_sync(kFull, bo);
      if (mo == 0) break;  // no free positive entry is left
      const uint32_t f = __reduce_min_sync(kFull, bo == mo ? bf : 0xffffffffu);
      const int bi = (int)(f >> 16), bj = (int)(f & 0xffffu);
      if (lane == 0) {
        taken[bi >> 5] |= 1u << (bi & 31);
        picks[steps] = (int)f;
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const int c = lane + 32 * q;
        if (c == bj) {
          head[q] = 0ull;
        } else if (head[q] != 0ull && key_row(head[q]) == bi) {
          // Walk down the list past taken rows; 0 ends it.
          const unsigned long long* list = cand + (size_t)c * kAssignListMax;
          int p = pos[q];
          unsigned long long k;
          do {
            ++p;
            k = p < len ? list[p] : 0ull;
          } while (k != 0ull && ((taken[key_row(k) >> 5] >> (key_row(k) & 31)) & 1u));
          pos[q] = p;
          head[q] = k;
        }
      }
    }
    if (lane == 0) picks[len] = steps;
  } else {
    zero_fill(out, n * m, threadIdx.x - 32, blockDim.x - 32);
  }
  __syncthreads();

  // 3. The ones.
  for (int t = threadIdx.x; t < picks[len]; t += blockDim.x) {
    const uint32_t f = (uint32_t)picks[t];
    out[(size_t)(f >> 16) * m + (f & 0xffffu)] = 1.0f;
  }
}

// --- Pairing: one warp per problem ------------------------------------------

// Rank of a value in the pairing argmax (pair_rank): NaN first (it beats
// every number), then the value's order-preserving bits. 0 marks a row that
// is not free; every value ranks above it (-inf ranks 0x007fffff).
constexpr uint32_t kNanRank = 0xffffffffu;
constexpr uint32_t kZeroRank = 0x80000000u;  // ord_bits(0.0f): positive values rank above

__device__ __forceinline__ uint32_t pair_rank(float x) {
  return isnan(x) ? kNanRank : ord_bits(x);
}

// The best free column of one row: the first NaN, else the largest value,
// then the lowest column. Returns its rank and sets col.
template <typename IsFree>
__device__ __forceinline__ uint32_t best_in_row(const float* row, int m, IsFree is_free,
                                                int& col) {
  uint32_t best = 0;
  int bc = 0;
#pragma unroll 8
  for (int c = 0; c < m; ++c) {
    const uint32_t o = pair_rank(row[c]);
    if (o > best && is_free(c)) {
      best = o;
      bc = c;
    }
  }
  col = bc;
  return best;
}

// The same over one of a lane's R rows held in registers as ranks (MB of
// them, 0 past m; row `second` ? R - 1 : 0, picked by a select per entry so
// that lanes rescanning different rows share one pass), the free set as two
// 32-bit words: four independent argmaxes over columns c % 4 (strictly
// greater: the lowest column wins a tie), then merged.
template <int MB, int R>
__device__ __forceinline__ uint32_t best_in_regs(const uint32_t (&v)[R][MB], bool second,
                                                 uint32_t free_lo, uint32_t free_hi, int& col) {
  uint32_t mx[4] = {0u, 0u, 0u, 0u};
  int mc[4] = {0, 0, 0, 0};
#pragma unroll
  for (int c = 0; c < MB; ++c) {
    const uint32_t x = second ? v[R - 1][c] : v[0][c];
    if (((c < 32 ? free_lo : free_hi) & (1u << (c & 31))) && x > mx[c & 3]) {
      mx[c & 3] = x;
      mc[c & 3] = c;
    }
  }
  uint32_t best = mx[0];
  col = mc[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    if (mx[i] > best || (mx[i] == best && mc[i] < col)) {
      best = mx[i];
      col = mc[i];
    }
  }
  return best;
}

// M <= MB (32 or 64). Lane r holds rows r, r + 32, ... (MB / 32 of them) as
// ranks in registers, loaded straight from global memory; the free set is
// a 64-bit mask in two words, held alike by every lane. No shared memory.
template <int MB>
__global__ void greedy_pairing_warp_kernel(const float* __restrict__ w_in,
                                           float* __restrict__ match, int k, int m) {
  constexpr int R = MB / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int prob = blockIdx.x * (blockDim.x >> 5) + warp;
  if (prob >= k) return;
  const size_t off = (size_t)prob * m * m;
  const float* w = w_in + off;
  const bool vec = m == MB && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  uint32_t v[R][MB];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int r = lane + 32 * q;
    if (vec) {  // m == MB: every lane has its rows
      const float4* row = reinterpret_cast<const float4*>(w + (size_t)r * MB);
#pragma unroll
      for (int c4 = 0; c4 < MB / 4; ++c4) {
        const float4 x = __ldg(row + c4);
        v[q][4 * c4] = pair_rank(x.x);
        v[q][4 * c4 + 1] = pair_rank(x.y);
        v[q][4 * c4 + 2] = pair_rank(x.z);
        v[q][4 * c4 + 3] = pair_rank(x.w);
      }
    } else {
#pragma unroll
      for (int c = 0; c < MB; ++c)
        v[q][c] = (r < m && c < m) ? pair_rank(__ldg(w + (size_t)r * m + c)) : 0u;
    }
  }

  // The free set, columns 0-31 and 32-63.
  uint32_t free_lo = m >= 32 ? kFull : (1u << m) - 1u;
  uint32_t free_hi = m >= 64 ? kFull : (m > 32 ? (1u << (m - 32)) - 1u : 0u);
  uint32_t rank[R];
  int col[R], partner[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    partner[q] = -1;
    col[q] = 0;
    rank[q] = lane + 32 * q < m ? best_in_regs(v, q > 0, free_lo, free_hi, col[q]) : 0u;
  }
  for (int it = 0; it < m; ++it) {
    uint32_t bo = 0, bf = 0xffffffffu;
#pragma unroll
    for (int q = 0; q < R; ++q) {  // rows rise with q: strictly greater keeps the lowest
      if (rank[q] > bo) {
        bo = rank[q];
        bf = ((uint32_t)(lane + 32 * q) << 16) | (uint32_t)col[q];
      }
    }
    const uint32_t mo = __reduce_max_sync(kFull, bo);
    // Stop at a NaN among the free entries, or when no value is positive.
    if (mo == kNanRank || mo <= kZeroRank) break;
    const uint32_t f = __reduce_min_sync(kFull, bo == mo ? bf : 0xffffffffu);
    const int bj = (int)(f >> 16), bk = (int)(f & 0xffffu);
    free_lo &= ~((bj < 32 ? 1u << bj : 0u) | (bk < 32 ? 1u << bk : 0u));
    free_hi &= ~((bj >= 32 ? 1u << (bj - 32) : 0u) | (bk >= 32 ? 1u << (bk - 32) : 0u));
    int stale = 0;  // bit q: row q's best column was taken
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = lane + 32 * q;
      if (r == bj || r == bk) {
        rank[q] = 0u;
        partner[q] = bj + bk - r;
      } else if (rank[q] != 0u && (col[q] == bj || col[q] == bk)) {
        stale |= 1 << q;
      }
    }
    while (stale != 0) {  // one rescan a pass, whichever row of the lane it is
      const bool second = (stale & 1) == 0;
      int c = 0;
      const uint32_t b = best_in_regs(v, second, free_lo, free_hi, c);
      if (second) {
        rank[R - 1] = b;
        col[R - 1] = c;
      } else {
        rank[0] = b;
        col[0] = c;
      }
      stale &= stale - 1;
    }
  }
  // Each lane writes its own rows.
  float* out = match + off;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int r = lane + 32 * q;
    if (r >= m) continue;
    float* row = out + (size_t)r * m;
    if (vec) {
#pragma unroll
      for (int c4 = 0; c4 < MB / 4; ++c4) {
        const int c = 4 * c4;
        reinterpret_cast<float4*>(row)[c4] =
            make_float4(partner[q] == c ? 1.f : 0.f, partner[q] == c + 1 ? 1.f : 0.f,
                        partner[q] == c + 2 ? 1.f : 0.f, partner[q] == c + 3 ? 1.f : 0.f);
      }
    } else {
      for (int c = 0; c < m; ++c) row[c] = partner[q] == c ? 1.0f : 0.0f;
    }
  }
}

// Shared memory of one warp of the wide variant, in 4-byte words:
//   [free: ceil(m / 32)] [rank: m] [col: m] [partner: m] [tile: m * (m | 1), in_smem only]
__host__ __device__ inline size_t pair_wide_words(int m, bool in_smem) {
  return (size_t)((m + 31) / 32) + 3 * (size_t)m + (in_smem ? (size_t)m * (m | 1) : 0);
}

// M > 64: the same chain with the free mask, the row bests and the partners
// in shared memory; the tile there too when it fits, else read from global
// memory.
__global__ void greedy_pairing_wide_kernel(const float* __restrict__ w_in,
                                           float* __restrict__ match, int k, int m,
                                           int in_smem) {
  extern __shared__ __align__(16) char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int prob = blockIdx.x * (blockDim.x >> 5) + warp;
  if (prob >= k) return;
  const int words = (m + 31) >> 5;
  uint32_t* avail = reinterpret_cast<uint32_t*>(smem_raw) + (size_t)warp * pair_wide_words(m, in_smem);
  uint32_t* rank = avail + words;
  int* col = reinterpret_cast<int*>(rank + m);
  int* partner = col + m;
  const size_t off = (size_t)prob * m * m;
  const float* tile = w_in + off;
  int ld = m;
  if (in_smem) {
    ld = m | 1;
    float* t = reinterpret_cast<float*>(partner + m);
    stage_rows<16>(w_in + off, t, m * m, m, ld, lane, 32);
    tile = t;
  }
  for (int i = lane; i < words; i += 32)
    avail[i] = (i == words - 1 && (m & 31)) ? (1u << (m & 31)) - 1u : kFull;
  __syncwarp();
  const auto is_free = [avail](int c) { return ((avail[c >> 5] >> (c & 31)) & 1u) != 0u; };
  for (int r = lane; r < m; r += 32) {
    partner[r] = -1;
    int c = 0;
    rank[r] = best_in_row(tile + (size_t)r * ld, m, is_free, c);
    col[r] = c;
  }
  for (int it = 0; it < m; ++it) {
    uint32_t bo = 0, bf = 0xffffffffu;
    for (int r = lane; r < m; r += 32) {
      if (rank[r] > bo) {
        bo = rank[r];
        bf = ((uint32_t)r << 16) | (uint32_t)col[r];
      }
    }
    const uint32_t mo = __reduce_max_sync(kFull, bo);
    if (mo == kNanRank || mo <= kZeroRank) break;
    const uint32_t f = __reduce_min_sync(kFull, bo == mo ? bf : 0xffffffffu);
    const int bj = (int)(f >> 16), bk = (int)(f & 0xffffu);
    if (lane == 0) {
      avail[bj >> 5] &= ~(1u << (bj & 31));
      avail[bk >> 5] &= ~(1u << (bk & 31));
    }
    __syncwarp();
    for (int r = lane; r < m; r += 32) {  // each lane touches only its own rows
      if (r == bj || r == bk) {
        rank[r] = 0u;
        partner[r] = bj + bk - r;
      } else if (rank[r] != 0u && (col[r] == bj || col[r] == bk)) {
        int c = 0;
        rank[r] = best_in_row(tile + (size_t)r * ld, m, is_free, c);
        col[r] = c;
      }
    }
    __syncwarp();
  }
  float* out = match + off;
  zero_fill(out, m * m, lane, 32);
  __syncwarp();
  for (int r = lane; r < m; r += 32)
    if (partner[r] >= 0) out[(size_t)r * m + partner[r]] = 1.0f;
}

int threads_for(long long nm) {
  long long t = (nm + 31) / 32 * 32;
  if (t > kMaxThreads) t = kMaxThreads;
  if (t < 32) t = 32;
  return (int)t;
}

// The device's SM count and its opt-in limit of shared memory a block.
cudaError_t device_limits(int* sms, int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// Chooses shared-memory residency of the collection's tile and opts in to
// more than 48 KB of dynamic shared memory when needed. Returns the dynamic
// size.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int n, int m, int* in_smem, size_t* bytes,
                    size_t (*layout_bytes)(int, int, bool)) {
  int sms = 0, optin = 0;
  cudaError_t err = device_limits(&sms, &optin);
  if (err != cudaSuccess) return err;
  *in_smem = layout_bytes(n, m, true) <= (size_t)optin ? 1 : 0;
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

// w, alpha: (k, n, m); n < 2^16, m <= 64. Bit 0 of *in_smem_out: all n
// rows were staged at once (else in chunks).
int greedy_assignment_launch(const float* w, float* alpha, int k, int n, int m,
                             void* stream, int* in_smem_out) {
  cudaGetLastError();
  if (n >= (1 << 16) || m > kAssignMaxM) return (int)cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t err = device_limits(&sms, &optin);
  if (err != cudaSuccess) return (int)err;
  // Rows staged at a time: all n where they fit beside the lists, else as
  // many multiples of 32 as fit.
  const size_t fixed = assign_fixed_bytes(n, m), row_bytes = sizeof(float) * (size_t)(m | 1);
  if (fixed + 32 * row_bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  long long rows = (long long)(((size_t)optin - fixed) / row_bytes);
  rows = n <= rows ? n : rows & ~31LL;
  const size_t bytes = fixed + row_bytes * (size_t)rows;
  void (*kernel)(const float*, float*, int, int, int) =
      m <= 32 ? greedy_assignment_kernel<1> : greedy_assignment_kernel<2>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  *in_smem_out = rows == n ? 1 : 0;
  kernel<<<k, kMaxThreads, bytes, (cudaStream_t)stream>>>(w, alpha, n, m, (int)rows);
  return (int)cudaGetLastError();
}

// w, match: (k, m, m); m < 2^16. One warp a problem, as many a block as
// cover the SMs once (1 to 8). *in_smem_out: bit 0, the tile is in shared
// memory; bit 1, the register variant (m <= 64) ran.
int greedy_pairing_launch(const float* w, float* match, int k, int m, void* stream,
                          int* in_smem_out) {
  cudaGetLastError();
  if (m >= (1 << 16)) return (int)cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t err = device_limits(&sms, &optin);
  if (err != cudaSuccess) return (int)err;
  int per_block = (k + sms - 1) / sms;
  per_block = per_block < 1 ? 1 : (per_block > kPairMaxWarps ? kPairMaxWarps : per_block);
  const bool small = m <= kPairWarpMaxM;
  if (small) {  // rows in registers: no shared memory
    const int blocks = (k + per_block - 1) / per_block;
    void (*kernel)(const float*, float*, int, int) =
        m <= 32 ? greedy_pairing_warp_kernel<32> : greedy_pairing_warp_kernel<64>;
    kernel<<<blocks, 32 * per_block, 0, (cudaStream_t)stream>>>(w, match, k, m);
    *in_smem_out = 2;
    return (int)cudaGetLastError();
  }
  const int in_smem = sizeof(uint32_t) * pair_wide_words(m, true) <= (size_t)optin ? 1 : 0;
  const size_t per_warp = sizeof(uint32_t) * pair_wide_words(m, in_smem != 0);
  if (per_warp > (size_t)optin) return (int)cudaErrorInvalidValue;
  if ((size_t)per_block * per_warp > (size_t)optin) per_block = (int)((size_t)optin / per_warp);
  const size_t bytes = per_warp * per_block;
  const int blocks = (k + per_block - 1) / per_block;
  err = cudaFuncSetAttribute(greedy_pairing_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  greedy_pairing_wide_kernel<<<blocks, 32 * per_block, bytes, (cudaStream_t)stream>>>(
      w, match, k, m, in_smem);
  *in_smem_out = in_smem;
  return (int)cudaGetLastError();
}

const char* greedy_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
