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
// chain, so the time per step -- one pass over the tile plus one block-wide
// reduction and two barriers -- is what counts.
//
// Design. The TPU kernels run the loop as a sequential grid whose steps share
// scratch memory; on Hopper grid blocks run in no order and share nothing, so
// here the whole loop runs inside ONE thread block per problem (leading batch
// axes are flattened into gridDim.x, so a batch of problems fills more SMs):
//   * the (N, M) tile sits in dynamic shared memory when it fits next to the
//     loop state (227 KB opt-in, e.g. 1024 x 32 = 128 KB); otherwise it is
//     read from global memory on every step, where it stays in the 50 MB L2;
//   * each step is a strided scan of the masked gains, a warp-shuffle plus
//     shared-memory argmax that carries (value, flat index) and prefers the
//     lower index on equal values (torch.argmax / jnp.argmax order; a NaN
//     beats every number and the first NaN wins), and a single-thread update
//     of the loop state in shared memory, then __syncthreads();
//   * the loop breaks once the stop flag is set (the TPU kernel runs no-op
//     grid steps instead; the output is the same);
//   * the output is written once at the end from the per-row choice.
// The collection kernel reads the crowding penalty from a table pen[0..N]
// that the wrapper computes with the plain version's own PyTorch code, so
// gain = logw - pen[count] is the same single float32 subtraction in both.
// Masks are applied by the caller before the launch; the kernels are
// mask-free.
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

__global__ void greedy_collection_kernel(const float* __restrict__ logw,
                                         const float* __restrict__ pen,
                                         float* __restrict__ alpha, int n, int m,
                                         int in_smem) {
  extern __shared__ __align__(16) char smem_raw[];
  __shared__ float red_v[kMaxWarps];
  __shared__ int red_i[kMaxWarps];
  const size_t off = (size_t)blockIdx.x * n * m;
  Smem s = carve(smem_raw, n, m, in_smem);
  const float* w = stage_tile(logw + off, s, n, m, in_smem);
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    s.count[j] = 0;
    s.colval[j] = pen[0];
  }
  if (threadIdx.x == 0) s.flags[0] = 0;
  __syncthreads();

  const int nm = n * m;
  const int step_i = blockDim.x / m, step_j = blockDim.x % m;
  for (int it = 0; it < n; ++it) {
    Cand c{-CUDART_INF_F, INT32_MAX};
    int i = threadIdx.x / m, j = threadIdx.x % m;
    for (int e = threadIdx.x; e < nm; e += blockDim.x) {
      float x = w[e];
      x = isfinite(x) ? x : kNeg;
      const float g = s.choice[i] >= 0 ? kNeg : x - s.colval[j];
      if (beats(g, e, c.v, c.idx)) { c.v = g; c.idx = e; }
      i += step_i;
      j += step_j;
      if (j >= m) { j -= m; ++i; }
    }
    c = block_argmax(c, red_v, red_i);
    if (threadIdx.x == 0) {
      if (c.v > 0.0f) {  // false for NaN, as in the plain version
        const int bi = c.idx / m, bj = c.idx - bi * m;
        s.choice[bi] = bj;
        const int cnt = ++s.count[bj];
        s.colval[bj] = pen[cnt];
      } else {
        s.flags[0] = 1;
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
cudaError_t prepare(Kernel kernel, int n, int m, int* in_smem, size_t* bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  // Leave room for the static reduction scratch.
  const size_t budget = (size_t)optin - 2 * sizeof(int) * kMaxWarps;
  *in_smem = smem_bytes(n, m, true) <= budget ? 1 : 0;
  *bytes = smem_bytes(n, m, *in_smem != 0);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

}  // namespace

extern "C" {

// logw, alpha: (k, n, m); pen: (n + 1,).
int greedy_collection_launch(const float* logw, const float* pen, float* alpha,
                             int k, int n, int m, void* stream, int* in_smem_out) {
  cudaGetLastError();  // clear a stale, non-sticky error
  int in_smem = 0;
  size_t bytes = 0;
  cudaError_t err = prepare(greedy_collection_kernel, n, m, &in_smem, &bytes);
  if (err != cudaSuccess) return (int)err;
  *in_smem_out = in_smem;
  greedy_collection_kernel<<<k, threads_for((long long)n * m), bytes,
                             (cudaStream_t)stream>>>(logw, pen, alpha, n, m, in_smem);
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
