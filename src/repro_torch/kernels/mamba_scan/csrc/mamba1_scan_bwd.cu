// Mamba-1 selective scan, backward: CUDA C++ for sm_90a.
//
// The gradient of the scan in mamba1_scan.cu (the Pallas TPU kernel
// mamba1_scan_pallas, src/repro/kernels/mamba_scan/kernel.py, has no
// custom_vjp: JAX differentiates the plain chunked scan off the TPU, so this
// kernel replaces autograd through that plain version). It computes what
// ../ref.py::mamba1_scan_bwd_ref computes: with alpha_t = exp(dt_t a) and the
// adjoint lam_t = dL/dh_t walked back in time,
//     lam_t  = C_t gy_t + alpha_{t+1} lam_{t+1}      (lam_{S-1} = gh + C_{S-1} gy_{S-1})
//     gC_t   = sum_d gy_t h_t            gB_t  = sum_d lam_t dt_t x_t
//     gx_t   = dt_t sum_n lam_t B_t      gdt_t = sum_n lam_t (a alpha_t h_{t-1} + x_t B_t)
//     ga     = sum_{b,t} lam_t dt_t alpha_t h_{t-1}                gh0 = alpha_0 lam_0
// in float32, gx / gdt written in x's type, gB / gC in b's type.
//
// What bounds it on an H100: as the forward, the exponentials (three per
// (token, channel, state) here against one in the forward) at the
// special-function units' 16 a clock an SM, and the float32 work around
// them; then the shuffles of the cross-channel sums. The bytes (x, dt, gy
// read, gx, gdt written, the workspace below) are far below.
//
// Design -- a simple kernel that is right; making it fast is later work:
//   * the forward kernel's lane layout: a block covers 64 channels of one
//     batch row, a group of G lanes the two adjacent channels of a pair, 4
//     states a lane (G = 4 at N = 16); its exponential, ex2.approx.ftz of
//     dt * a log2(e), so that alpha agrees with the forward bit for bit;
//   * the reverse walk needs h_{t-1} in reverse order. The kernel first
//     sweeps forward from h0 and writes each lane's state at the start of
//     every chunk of kChunk = 8 steps to a workspace (laid out by thread, so
//     the stores coalesce; only the thread that wrote a state reads it back).
//     Then, chunk by chunk from the last, it recomputes the chunk's states
//     from that checkpoint into a per-thread stash in shared memory and
//     walks the chunk backwards. Three exponentials a (token, channel,
//     state) instead of one, and no (B, S, DI, N) tensor anywhere. Eight
//     steps keep the stash at 32 KB a block at G = 4 (4 blocks an SM);
//   * the per-channel sums over the states (gx, gdt) reduce over the lane
//     group by __shfl_xor_sync; the sums over channels (gB, gC) reduce over
//     the warp's lanes that hold the same states by __shfl_xor_sync, then
//     over the block's warps in shared memory, into per-block partials in a
//     float32 workspace; a second kernel of this source sums the partials
//     over blocks (gB, gC) and ga's per-row partials over batch rows, each
//     in a fixed order. No atomics: two runs give the same bits;
//   * x, dt, gy and the outputs gx, gdt move through shared memory as whole
//     rows of the block's 64 channels; b and c are read in their own type
//     (bfloat16 or float32) with their own batch and step strides (the
//     models pass strided slices of the x_proj product), as float32 staged.
//
// Interface: plain C. mamba1_scan_bwd_workspace_floats gives the float32
// workspace a call needs; mamba1_scan_bwd_launch returns the cudaError_t of
// its launches (0 on success). Pointers are device pointers: x, dt, gy, gx,
// gdt (B, S, DI) contiguous of one type (dtype 0 = float32, 1 = bfloat16);
// a (DI, N), h0, gh and gh0 (B, DI, N) contiguous float32 (h0 and gh may be
// null: zero); b, c (B, S, N) of one type (bc_dtype) with unit stride along
// N and the given strides (in elements) along B and S; gb, gc (B, S, N)
// contiguous in b's type; ga (DI, N) float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kLaneChannels = 2;               // adjacent channels a lane carries
constexpr int kChannels = 32 * kLaneChannels;  // channels a block covers
constexpr int P = 4;                           // states a lane holds
constexpr int kChunk = 8;                      // steps between checkpoints

struct Params {
  const void* x;
  const void* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* h0;
  const void* gy;
  const float* gh;
  void* gx;
  void* gdt;
  float* gh0;
  float* ws;      // checkpoints: (B, blocks, chunks, 2, threads) float4
  float* part_b;  // (B, blocks, S, N) per-block sums of gB
  float* part_c;  // (B, blocks, S, N) per-block sums of gC
  float* part_a;  // (B, DI, N) per-row sums of ga
  long long b_sb, b_ss, c_sb, c_ss;  // strides of b and c along B and S, in bytes
  int s_len, di, n, n_blk, n_chunks;
  bool bc_bf16;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float2 load2(const float* s) {
  return *reinterpret_cast<const float2*>(s);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* s) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s));
}
__device__ __forceinline__ void store2(float* s, float a, float b) {
  *reinterpret_cast<float2*>(s) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* s, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(s) = __floats2bfloat162_rn(a, b);
}

// One block's shared memory: the stash of the chunk's states (a thread's 2 x
// 4 in two float4), the per-warp partial sums of gB and gC, b and c of the
// chunk as float32 (padded to the group's states with zeros), and the rows
// of x, dt, gy in and gx, gdt out.
template <typename T, int G>
struct Smem {
  static constexpr int kThreads = 32 * G;
  static constexpr int NP = G * P;
  float4 hs[kChunk][kLaneChannels][kThreads];
  float wb[G][kChunk][NP];
  float wc[G][kChunk][NP];
  float bs[kChunk][NP];
  float cs[kChunk][NP];
  __align__(16) T xs[kChunk][kChannels];
  __align__(16) T dts[kChunk][kChannels];
  __align__(16) T gys[kChunk][kChannels];
  __align__(16) T gxs[kChunk][kChannels];
  __align__(16) T gdts[kChunk][kChannels];
};

template <typename T, int G>
__global__ void __launch_bounds__(32 * G, 16 / G) mamba1_scan_bwd_kernel(const Params p) {
  using S = Smem<T, G>;
  constexpr int kThreads = S::kThreads;
  constexpr int NP = S::NP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ch = tid / G * kLaneChannels;
  const int n0 = g * P;
  const int bb = blockIdx.y;
  const int blk = blockIdx.x;
  const int d0 = blk * kChannels;
  const int d = d0 + ch;
  const int di = p.di, n = p.n, s_len = p.s_len;
  const size_t row0 = size_t(bb) * s_len;
  const T* x = static_cast<const T*>(p.x);
  const T* dtp = static_cast<const T*>(p.dt);
  const T* gyp = static_cast<const T*>(p.gy);
  float4* ws = reinterpret_cast<float4*>(p.ws) +
               (size_t(bb) * p.n_blk + blk) * p.n_chunks * kLaneChannels * kThreads;

  // x, dt (and gy) rows and b, c of the chunk at t0 into shared memory;
  // steps at or past tc, channels past DI and states past N read as 0.
  auto stage = [&](int t0, int tc, bool with_gy) {
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = tid; i < kChunk * kChannels; i += kThreads) {
      const int tt = i / kChannels, col = i % kChannels;
      const bool in = tt < tc && d0 + col < di;
      const size_t off = (row0 + t0 + tt) * di + d0 + col;
      sm.xs[tt][col] = in ? x[off] : from_float<T>(0.f);
      sm.dts[tt][col] = in ? dtp[off] : from_float<T>(0.f);
      if (with_gy) sm.gys[tt][col] = in ? gyp[off] : from_float<T>(0.f);
    }
    for (int i = tid; i < kChunk * NP; i += kThreads) {
      const int tt = i / NP, k = i % NP;
      float bv = 0.f, cv = 0.f;
      if (tt < tc && k < n) {
        const char* bp = static_cast<const char*>(p.b) + bb * p.b_sb + (t0 + tt) * p.b_ss;
        const char* cp = static_cast<const char*>(p.c) + bb * p.c_sb + (t0 + tt) * p.c_ss;
        if (p.bc_bf16) {
          bv = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(bp)[k]);
          cv = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(cp)[k]);
        } else {
          bv = reinterpret_cast<const float*>(bp)[k];
          cv = reinterpret_cast<const float*>(cp)[k];
        }
      }
      sm.bs[tt][k] = bv;
      sm.cs[tt][k] = cv;
    }
    __syncthreads();
  };

  // This lane's states of its two channels from h0 (0 without it), its rows
  // of a times log2(e), and the carried adjoint alpha lam from gh (0).
  float h[kLaneChannels][P], a2[kLaneChannels][P], r[kLaneChannels][P], ga[kLaneChannels][P];
#pragma unroll
  for (int c = 0; c < kLaneChannels; ++c) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const bool on = d + c < di && n0 + q < n;
      const size_t at = (size_t(bb) * di + d + c) * n + n0 + q;
      h[c][q] = on && p.h0 != nullptr ? p.h0[at] : 0.f;
      r[c][q] = on && p.gh != nullptr ? p.gh[at] : 0.f;
      a2[c][q] = on ? p.a[size_t(d + c) * n + n0 + q] * kLog2e : 0.f;
      ga[c][q] = 0.f;
    }
  }

  // One step of the recurrence, as the forward kernel takes it.
  auto advance = [&](int tt) {
    const float2 dtv = load2(&sm.dts[tt][ch]);
    const float2 xv = load2(&sm.xs[tt][ch]);
    const float dts_[kLaneChannels] = {dtv.x, dtv.y};
    const float dx[kLaneChannels] = {dtv.x * xv.x, dtv.y * xv.y};
    const float* bq = &sm.bs[tt][n0];
#pragma unroll
    for (int c = 0; c < kLaneChannels; ++c) {
#pragma unroll
      for (int q = 0; q < P; ++q) h[c][q] = fmaf(ex2(dts_[c] * a2[c][q]), h[c][q], dx[c] * bq[q]);
    }
  };

  // Pass 1: forward from h0, the state at the start of every chunk kept.
  for (int k = 0; k < p.n_chunks; ++k) {
    const int t0 = k * kChunk;
    const int tc = min(kChunk, s_len - t0);
#pragma unroll
    for (int c = 0; c < kLaneChannels; ++c)
      ws[(size_t(k) * kLaneChannels + c) * kThreads + tid] =
          make_float4(h[c][0], h[c][1], h[c][2], h[c][3]);
    stage(t0, tc, false);
    for (int tt = 0; tt < tc; ++tt) advance(tt);
  }

  // Pass 2: chunk by chunk from the last, the chunk's states recomputed
  // into the stash, then walked backwards.
  T* gxp = static_cast<T*>(p.gx);
  T* gdtp = static_cast<T*>(p.gdt);
  for (int k = p.n_chunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int tc = min(kChunk, s_len - t0);
    stage(t0, tc, true);
    float hs0[kLaneChannels][P];
#pragma unroll
    for (int c = 0; c < kLaneChannels; ++c) {
      const float4 v = ws[(size_t(k) * kLaneChannels + c) * kThreads + tid];
      h[c][0] = hs0[c][0] = v.x, h[c][1] = hs0[c][1] = v.y;
      h[c][2] = hs0[c][2] = v.z, h[c][3] = hs0[c][3] = v.w;
    }
    for (int tt = 0; tt < tc; ++tt) {
      advance(tt);
#pragma unroll
      for (int c = 0; c < kLaneChannels; ++c)
        sm.hs[tt][c][tid] = make_float4(h[c][0], h[c][1], h[c][2], h[c][3]);
    }
    for (int tt = tc - 1; tt >= 0; --tt) {
      const float2 dtv = load2(&sm.dts[tt][ch]);
      const float2 xv = load2(&sm.xs[tt][ch]);
      const float2 gyv = load2(&sm.gys[tt][ch]);
      const float dtc[kLaneChannels] = {dtv.x, dtv.y};
      const float xc[kLaneChannels] = {xv.x, xv.y};
      const float gyc[kLaneChannels] = {gyv.x, gyv.y};
      const float* bq = &sm.bs[tt][n0];
      const float* cq = &sm.cs[tt][n0];
      float pb[P] = {0.f, 0.f, 0.f, 0.f}, pc[P] = {0.f, 0.f, 0.f, 0.f};
      float sx[kLaneChannels], sw[kLaneChannels];
#pragma unroll
      for (int c = 0; c < kLaneChannels; ++c) {
        const float4 hc4 = sm.hs[tt][c][tid];
        float hp[P];
        if (tt > 0) {
          const float4 v = sm.hs[tt - 1][c][tid];
          hp[0] = v.x, hp[1] = v.y, hp[2] = v.z, hp[3] = v.w;
        } else {
#pragma unroll
          for (int q = 0; q < P; ++q) hp[q] = hs0[c][q];
        }
        const float hc[P] = {hc4.x, hc4.y, hc4.z, hc4.w};
        const float dx = dtc[c] * xc[c];
        sx[c] = 0.f;
        sw[c] = 0.f;
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const float lam = fmaf(cq[q], gyc[c], r[c][q]);
          const float al = ex2(dtc[c] * a2[c][q]);
          pc[q] = fmaf(gyc[c], hc[q], pc[q]);
          pb[q] = fmaf(lam, dx, pb[q]);
          sx[c] = fmaf(lam, bq[q], sx[c]);
          const float w = lam * al * hp[q];
          sw[c] = fmaf(w, a2[c][q], sw[c]);
          ga[c][q] = fmaf(w, dtc[c], ga[c][q]);
          r[c][q] = al * lam;
        }
      }
      // gx, gdt: sums over the channel's states, over the lane group.
#pragma unroll
      for (int w = G / 2; w > 0; w /= 2) {
#pragma unroll
        for (int c = 0; c < kLaneChannels; ++c) {
          sx[c] += __shfl_xor_sync(0xffffffffu, sx[c], w);
          sw[c] += __shfl_xor_sync(0xffffffffu, sw[c], w);
        }
      }
      if (g == 0) {
        store2(&sm.gxs[tt][ch], dtc[0] * sx[0], dtc[1] * sx[1]);
        store2(&sm.gdts[tt][ch], fmaf(sw[0], kLn2, xc[0] * sx[0]),
               fmaf(sw[1], kLn2, xc[1] * sx[1]));
      }
      // gB, gC: sums over channels, first over the warp's lanes that hold
      // the same states.
#pragma unroll
      for (int w = G; w < 32; w *= 2) {
#pragma unroll
        for (int q = 0; q < P; ++q) {
          pb[q] += __shfl_xor_sync(0xffffffffu, pb[q], w);
          pc[q] += __shfl_xor_sync(0xffffffffu, pc[q], w);
        }
      }
      if (lane < G) {
#pragma unroll
        for (int q = 0; q < P; ++q) {
          sm.wb[warp][tt][n0 + q] = pb[q];
          sm.wc[warp][tt][n0 + q] = pc[q];
        }
      }
    }
    __syncthreads();
    // The chunk's gx / gdt rows, and its per-block sums of gB / gC over the
    // block's warps in order.
    for (int i = tid; i < tc * kChannels; i += kThreads) {
      const int tt = i / kChannels, col = i % kChannels;
      if (d0 + col < di) {
        const size_t off = (row0 + t0 + tt) * di + d0 + col;
        gxp[off] = sm.gxs[tt][col];
        gdtp[off] = sm.gdts[tt][col];
      }
    }
    for (int i = tid; i < tc * n; i += kThreads) {
      const int tt = i / n, kk = i % n;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < G; ++w) {
        sb += sm.wb[w][tt][kk];
        sc += sm.wc[w][tt][kk];
      }
      const size_t at = ((size_t(bb) * p.n_blk + blk) * s_len + t0 + tt) * n + kk;
      p.part_b[at] = sb;
      p.part_c[at] = sc;
    }
  }

  // gh0 = alpha_0 lam_0 (the carry after step 0) and this row's part of ga.
#pragma unroll
  for (int c = 0; c < kLaneChannels; ++c) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (d + c < di && n0 + q < n) {
        const size_t at = (size_t(bb) * di + d + c) * n + n0 + q;
        p.gh0[at] = r[c][q];
        p.part_a[at] = ga[c][q];
      }
    }
  }
}

// gB, gC = the per-block partials summed over blocks; ga = the per-row
// partials summed over batch rows; each in a fixed order.
template <typename TB>
__global__ void mamba1_scan_bwd_reduce_kernel(const float* part_b, const float* part_c,
                                              const float* part_a, TB* gb, TB* gc, float* ga,
                                              int bsz, int s_len, int di, int n, int n_blk) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long per_row = static_cast<long long>(s_len) * n;
  if (idx < bsz * per_row) {
    const long long row = idx / per_row, rem = idx % per_row;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < n_blk; ++k) {
      const long long at = (row * n_blk + k) * per_row + rem;
      sb += part_b[at];
      sc += part_c[at];
    }
    gb[idx] = from_float<TB>(sb);
    gc[idx] = from_float<TB>(sc);
  }
  const long long per_a = static_cast<long long>(di) * n;
  if (idx < per_a) {
    float s = 0.f;
    for (int row = 0; row < bsz; ++row) s += part_a[row * per_a + idx];
    ga[idx] = s;
  }
}

// The group: the fewest lanes of 4 states that hold N (a power of two).
int group_of(int n) { return n <= 4 ? 1 : n <= 8 ? 2 : n <= 16 ? 4 : 8; }

long long round4(long long v) { return (v + 3) / 4 * 4; }

struct Layout {
  long long ws, part, part_a;  // floats of each workspace piece
};

Layout layout(int bsz, int s_len, int di, int n) {
  const long long n_blk = (di + kChannels - 1) / kChannels;
  const long long n_chunks = (s_len + kChunk - 1) / kChunk;
  const long long threads = 32LL * group_of(n);
  Layout l;
  l.ws = bsz * n_blk * n_chunks * kLaneChannels * threads * 4;
  l.part = round4(bsz * n_blk * static_cast<long long>(s_len) * n);
  l.part_a = round4(static_cast<long long>(bsz) * di * n);
  return l;
}

template <typename T, int G>
cudaError_t launch_g(const Params& p, int bsz, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem<T, G>));
  cudaError_t err = cudaFuncSetAttribute(mamba1_scan_bwd_kernel<T, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.n_blk, bsz);
  mamba1_scan_bwd_kernel<T, G><<<grid, 32 * G, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, int bsz, cudaStream_t stream) {
  switch (group_of(p.n)) {
    case 1: return launch_g<T, 1>(p, bsz, stream);
    case 2: return launch_g<T, 2>(p, bsz, stream);
    case 4: return launch_g<T, 4>(p, bsz, stream);
    default: return launch_g<T, 8>(p, bsz, stream);
  }
}

template <typename TB>
cudaError_t launch_reduce(const Params& p, int bsz, void* gb, void* gc, float* ga,
                          cudaStream_t stream) {
  const long long work = static_cast<long long>(bsz) * p.s_len * p.n;
  const long long per_a = static_cast<long long>(p.di) * p.n;
  const long long total = work > per_a ? work : per_a;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  mamba1_scan_bwd_reduce_kernel<TB><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      p.part_b, p.part_c, p.part_a, static_cast<TB*>(gb), static_cast<TB*>(gc), ga, bsz,
      p.s_len, p.di, p.n, p.n_blk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

long long mamba1_scan_bwd_workspace_floats(int bsz, int s_len, int di, int n) {
  if (bsz <= 0 || s_len <= 0 || di <= 0 || n <= 0 || n > 32) return -1;
  const Layout l = layout(bsz, s_len, di, n);
  return l.ws + 2 * l.part + l.part_a;
}

int mamba1_scan_bwd_launch(const void* x, const void* dt, const float* a, const void* b,
                           const void* c, const float* h0, const void* gy, const float* gh,
                           void* gx, void* gdt, float* ga, void* gb, void* gc, float* gh0,
                           float* workspace, int bsz, int s_len, int di, int n, long long b_sb,
                           long long b_ss, long long c_sb, long long c_ss, int dtype,
                           int bc_dtype, void* stream) {
  cudaGetLastError();  // clear a stale, non-sticky error
  if (bsz <= 0 || bsz > 65535 || s_len <= 0 || di <= 0 || n <= 0 || n > 32 ||
      (dtype != 0 && dtype != 1) || (bc_dtype != 0 && bc_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(bsz, s_len, di, n);
  Params p;
  p.x = x, p.dt = dt, p.a = a, p.b = b, p.c = c, p.h0 = h0, p.gy = gy, p.gh = gh;
  p.gx = gx, p.gdt = gdt, p.gh0 = gh0;
  p.ws = workspace;
  p.part_b = workspace + l.ws;
  p.part_c = p.part_b + l.part;
  p.part_a = p.part_c + l.part;
  p.bc_bf16 = bc_dtype == 1;
  const int esize = p.bc_bf16 ? 2 : 4;
  p.b_sb = b_sb * esize, p.b_ss = b_ss * esize, p.c_sb = c_sb * esize, p.c_ss = c_ss * esize;
  p.s_len = s_len, p.di = di, p.n = n;
  p.n_blk = (di + kChannels - 1) / kChannels;
  p.n_chunks = (s_len + kChunk - 1) / kChunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch<float>(p, bsz, s) : launch<__nv_bfloat16>(p, bsz, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = p.bc_bf16 ? launch_reduce<__nv_bfloat16>(p, bsz, gb, gc, ga, s)
                  : launch_reduce<float>(p, bsz, gb, gc, ga, s);
  return static_cast<int>(err);
}

}  // extern "C"
