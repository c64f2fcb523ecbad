// Mamba-1 selective scan, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel mamba1_scan_pallas
// (src/repro/kernels/mamba_scan/kernel.py, body _scan_kernel) and computes
// what the plain versions in ../ref.py and ../ops.py compute: for each batch
// row and channel d, over the sequence,
//     h[n] <- exp(dt * a[d, n]) * h[n] + (dt * x) * b[n],   y = sum_n h[n] c[n]
// with the state h in float32, starting from h0 (or 0), returning y in x's
// type and the final h.
//
// What bounds it on an H100: the B * S * DI * N exponentials, at the
// special-function units' 16 results per clock per SM, and next to them the
// bytes of x, dt and y (read and written once). The recurrence itself is
// sequential in time but independent across (batch, channel, state).
//
// Design. One thread per (batch row, channel), with its N <= N_MAX states
// and its row of a in registers; it walks the sequence once. A block of 128
// threads covers 128 channels of one batch row. The sequence is staged
// through shared memory in chunks of 32 steps: x and dt of the block's
// channels (one coalesced row per step) and b and c of the batch row, which
// all 128 threads share. The TPU kernel's grid over sequence chunks exists
// only to keep the state in VMEM between grid steps; here the state stays in
// registers for the whole walk, so there is no chunk grid. Decode calls it
// with S = 1 and h0.
//
// Interface: plain C. mamba1_scan_launch returns the cudaError_t of the
// launch (0 on success). Pointers are device pointers to contiguous arrays:
// x, dt, y (B, S, DI) of one type (dtype 0 = float32, 1 = bfloat16);
// a (DI, N), b and c (B, S, N), h0 and h_out (B, DI, N) float32; h0 may be
// null (zero initial state).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kChunk = 32;     // time steps staged per pass

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int N_MAX>
__global__ void __launch_bounds__(kThreads)
    mamba1_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                       const float* __restrict__ a, const float* __restrict__ bm,
                       const float* __restrict__ cm, const float* __restrict__ h0,
                       T* __restrict__ y, float* __restrict__ h_out, int s_len, int di,
                       int n) {
  __shared__ float xs[kChunk][kThreads];
  __shared__ float dts[kChunk][kThreads];
  __shared__ float bs[kChunk][N_MAX];
  __shared__ float cs[kChunk][N_MAX];

  const int tid = threadIdx.x;
  const int bb = blockIdx.y;
  const int d = blockIdx.x * kThreads + tid;
  const bool active = d < di;

  float h[N_MAX], av[N_MAX];
#pragma unroll
  for (int i = 0; i < N_MAX; ++i) {
    const bool on = active && i < n;
    h[i] = on && h0 != nullptr ? h0[(size_t(bb) * di + d) * n + i] : 0.f;
    av[i] = on ? a[size_t(d) * n + i] : 0.f;
  }

  for (int t0 = 0; t0 < s_len; t0 += kChunk) {
    const int tc = min(kChunk, s_len - t0);
    for (int tt = 0; tt < tc; ++tt) {
      const size_t at = (size_t(bb) * s_len + t0 + tt) * di + d;
      xs[tt][tid] = active ? to_float(x[at]) : 0.f;
      dts[tt][tid] = active ? to_float(dt[at]) : 0.f;
    }
    for (int e = tid; e < tc * n; e += kThreads) {
      const int tt = e / n;
      const int i = e - tt * n;
      const size_t at = (size_t(bb) * s_len + t0 + tt) * n + i;
      bs[tt][i] = bm[at];
      cs[tt][i] = cm[at];
    }
    __syncthreads();

    for (int tt = 0; tt < tc; ++tt) {
      const float dv = dts[tt][tid];
      const float dx = dv * xs[tt][tid];
      float yv = 0.f;
#pragma unroll
      for (int i = 0; i < N_MAX; ++i) {
        if (i < n) {
          h[i] = expf(dv * av[i]) * h[i] + dx * bs[tt][i];
          yv += h[i] * cs[tt][i];
        }
      }
      if (active) y[(size_t(bb) * s_len + t0 + tt) * di + d] = from_float<T>(yv);
    }
    __syncthreads();  // before the next chunk overwrites the staged inputs
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < N_MAX; ++i)
      if (i < n) h_out[(size_t(bb) * di + d) * n + i] = h[i];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const float* a, const float* b,
                   const float* c, const float* h0, void* y, float* h_out, int bsz, int s_len,
                   int di, int n, cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, bsz);
  const T* xt = static_cast<const T*>(x);
  const T* dtt = static_cast<const T*>(dt);
  T* yt = static_cast<T*>(y);
  if (n <= 16)
    mamba1_scan_kernel<T, 16><<<grid, kThreads, 0, stream>>>(xt, dtt, a, b, c, h0, yt, h_out,
                                                              s_len, di, n);
  else
    mamba1_scan_kernel<T, 32><<<grid, kThreads, 0, stream>>>(xt, dtt, a, b, c, h0, yt, h_out,
                                                              s_len, di, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int mamba1_scan_launch(const void* x, const void* dt, const float* a, const float* b,
                       const float* c, const float* h0, void* y, float* h_out, int bsz,
                       int s_len, int di, int n, int dtype, void* stream) {
  cudaGetLastError();  // clear a stale, non-sticky error
  if (bsz <= 0 || bsz > 65535 || s_len <= 0 || di <= 0 || n <= 0 || n > 32 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<float>(x, dt, a, b, c, h0, y, h_out, bsz, s_len, di, n, s)
                 : launch<__nv_bfloat16>(x, dt, a, b, c, h0, y, h_out, bsz, s_len, di, n, s);
  return static_cast<int>(err);
}

const char* mamba1_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
