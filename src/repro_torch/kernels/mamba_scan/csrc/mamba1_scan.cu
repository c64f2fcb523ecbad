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
// special-function units' 16 results per clock per SM; next to them the
// instruction slots of the float32 work around each exponential and the
// shared-memory loads of the staged rows, and far below them the bytes of x,
// dt and y (read and written once). The recurrence is sequential in time
// but independent across (batch, channel, state).
//
// Design:
//   * the state axis is split across a group of G lanes: lane g of a group
//     holds states 4 g .. 4 g + 3 (P = 4) of two adjacent channels, and
//     their a, in registers; y of each step is summed over the group with
//     __shfl_xor_sync, G steps at once (G - 1 shuffles a channel, the
//     sums transposed so that lane g ends with step g's). At N = 16 (G 4)
//     the B 4 x DI 8192 prefill runs 65,536 threads, 4 warps per SM
//     sub-partition, each lane with two independent recurrences;
//   * two channels a lane: one 16-byte load of b and one of c, and one
//     4-byte load of an x pair and of a dt pair, serve both channels, which
//     halves the shared-memory loads per channel-step (a version with one
//     channel a lane was bound by them);
//   * one exponential is one MUFU.EX2: a is scaled by log2(e) once, and each
//     step takes ex2.approx.ftz of dt * a log2(e) (no range reduction; a
//     result below 2^-126 flushes to 0, where the factor it multiplies is
//     lost below float32's resolution of h anyway);
//   * a block covers 64 channels of one batch row (32 G threads) and walks
//     the sequence in chunks (32 steps in bf16, 16 in float32) through a
//     two-stage ring in shared memory: the x and dt rows of chunk k + 1 are
//     copied by 16-byte cp.async (element loads where a row is not 16-byte
//     aligned), and its b and c loaded into registers, while chunk k runs;
//     b and c are stored as float32 once per block;
//   * b and c are read in their own type (bfloat16 or float32) and with
//     their own batch and step strides, so the model's strided slices of the
//     x_proj product need no copy;
//   * y of a chunk is gathered in shared memory and written as whole rows
//     while the next chunk runs; a lane's states are contiguous in h0 and
//     h_out, so decode (S = 1) reads and writes them as float4.
// The TPU kernel's grid over sequence chunks exists only to keep the state
// in VMEM between grid steps; here it stays in registers for the whole walk.
//
// Interface: plain C. mamba1_scan_launch returns the cudaError_t of the
// launch (0 on success). Pointers are device pointers: x, dt, y (B, S, DI)
// contiguous, of one type (dtype 0 = float32, 1 = bfloat16); a (DI, N),
// h0 and h_out (B, DI, N) contiguous float32, h0 may be null (zero initial
// state); b and c (B, S, N) of one type (bc_dtype as dtype), unit stride
// along N and the given strides (in elements) along B and S.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* x;
  const void* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* h0;
  void* y;
  float* h_out;
  long long b_sb, b_ss, c_sb, c_ss;  // strides of b and c along B and S, in bytes
  int s_len, di, n;
  bool bc_bf16;    // b and c are bfloat16 (else float32)
  bool vec_rows;   // x, dt and y rows move as 16-byte pieces
  bool vec_state;  // a, h0 and h_out move as float4
};

// ---- PTX helpers -----------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Raw bits of one b / c element. volatile keeps the load where it stands,
// ahead of the chunk it overlaps, instead of next to its first use.
__device__ __forceinline__ uint32_t load_u16(const void* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u16 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t load_u32(const void* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

// ---- the kernel ------------------------------------------------------------

constexpr int kLaneChannels = 2;               // adjacent channels a lane carries
constexpr int kChannels = 32 * kLaneChannels;  // channels a block covers
constexpr int P = 4;                           // states a lane holds, one float4

// Two x or dt (or y) values of adjacent channels as one 4- or 8-byte word.
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

// The two-stage ring of one block: x, dt and y rows of its channels, b and
// c as float32 (padded to the group's states with zeros).
template <typename T, int NP, int CHUNK>
struct Ring {
  __align__(16) T xs[2][CHUNK][kChannels];
  __align__(16) T dts[2][CHUNK][kChannels];
  __align__(16) T ys[2][CHUNK][kChannels];
  __align__(16) float bs[2][CHUNK][NP];
  __align__(16) float cs[2][CHUNK][NP];
};

// One thread of a block: 64 channels of one batch row, a group of G lanes
// for each pair of adjacent channels, P states a lane (G P >= N). Every
// member is inlined, so h, a2 and raw stay in registers.
template <typename T, int G>
struct Lane {
  static constexpr int kThreads = 32 * G;
  static constexpr int kChunk = 64 / sizeof(T);          // steps a stage: 32 bf16, 16 float32
  static constexpr int NP = G * P;                       // states padded to the group
  static constexpr int kPiece = 16 / sizeof(T);          // elements per 16-byte copy
  static constexpr int kRowPieces = kChannels / kPiece;  // 16-byte copies per row
  static constexpr int kBC = 2 * kChunk * NP / kThreads; // b / c elements a thread loads
  static constexpr int kHalf = kBC / 2;                  // of them b, then as many c
  static_assert(kHalf * kThreads == kChunk * NP, "layout");
  using Stage = Ring<T, NP, kChunk>;

  const Params p;  // a copy: taking the kernel parameter's address would spill it
  Stage& sm;
  int tid, g, ch, n0, bb, d0, d, di, n;
  size_t row0;  // first (b, s) row of this batch row
  float h[kLaneChannels][P], a2[kLaneChannels][P];
  uint32_t raw[kBC];

  __device__ __forceinline__ Lane(const Params& p_, Stage& sm_) : p(p_), sm(sm_) {
    tid = threadIdx.x;
    g = tid % G;
    ch = tid / G * kLaneChannels;
    n0 = g * P;
    bb = blockIdx.y;
    d0 = blockIdx.x * kChannels;
    d = d0 + ch;
    di = p.di;
    n = p.n;
    row0 = size_t(bb) * p.s_len;
  }

  // x and dt rows t0 .. t0 + kChunk - 1 of the block's channels into stage
  // st; rows at or past tc and channels past DI are zero-filled.
  __device__ __forceinline__ void load_rows(int st, int t0, int tc) {
    const T* x = static_cast<const T*>(p.x);
    const T* xb = x + (row0 + t0) * di + d0;
    const T* db = static_cast<const T*>(p.dt) + (row0 + t0) * di + d0;
    if (p.vec_rows) {
      constexpr int kPieces = 2 * kChunk * kRowPieces;
      static_assert(kPieces % kThreads == 0, "whole copies a thread");
#pragma unroll 4
      for (int e = 0; e < kPieces / kThreads; ++e) {
        const int i = tid + e * kThreads;
        const int arr = i / (kChunk * kRowPieces);
        const int tt = (i / kRowPieces) % kChunk;
        const int col = (i % kRowPieces) * kPiece;
        const bool in = tt < tc && d0 + col < di;
        const T* src = (arr ? db : xb) + tt * di + col;
        cp_async16(arr ? &sm.dts[st][tt][col] : &sm.xs[st][tt][col], in ? src : x, in);
      }
    } else {
#pragma unroll 4
      for (int i = tid; i < 2 * kChunk * kChannels; i += kThreads) {
        const int arr = i / (kChunk * kChannels);
        const int tt = (i / kChannels) % kChunk;
        const int col = i % kChannels;
        const T v = tt < tc && d0 + col < di ? (arr ? db : xb)[tt * di + col] : from_float<T>(0.f);
        (arr ? sm.dts : sm.xs)[st][tt][col] = v;
      }
    }
    cp_async_commit();
  }

  // b and c of steps t0 .. t0 + tc - 1 into registers as raw bits. Element
  // e of a thread is state tid % NP of step tid / NP + (e % kHalf) kThreads
  // / NP, of b for e < kHalf, else of c. An element past the end or past N
  // reads element 0 instead, and store_bc writes it as 0 into stage st, as
  // float32.
  __device__ __forceinline__ void fetch_bc(int t0, int tc) {
    const char* b0 = static_cast<const char*>(p.b);
    const char* c0 = static_cast<const char*>(p.c);
    const char* bb_ = b0 + bb * p.b_sb + t0 * p.b_ss;
    const char* cb_ = c0 + bb * p.c_sb + t0 * p.c_ss;
    if (p.bc_bf16) {
#pragma unroll
      for (int e = 0; e < kBC; ++e) raw[e] = load_u16(bc_src(e, tc, bb_, cb_, b0, c0, 2));
    } else {
#pragma unroll
      for (int e = 0; e < kBC; ++e) raw[e] = load_u32(bc_src(e, tc, bb_, cb_, b0, c0, 4));
    }
  }
  __device__ __forceinline__ const char* bc_src(int e, int tc, const char* bb_, const char* cb_,
                                                const char* b0, const char* c0, int esize) const {
    const int arr = e / kHalf;
    const int j = tid + (e % kHalf) * kThreads;
    const int tt = j / NP;
    const int k = j % NP;
    const bool ok = tt < tc && k < n;
    const char* src = arr ? cb_ + tt * p.c_ss + k * esize : bb_ + tt * p.b_ss + k * esize;
    return ok ? src : (arr ? c0 : b0);
  }
  __device__ __forceinline__ void store_bc(int st, int tc) {
#pragma unroll
    for (int e = 0; e < kBC; ++e) {
      const int arr = e / kHalf;
      const int j = tid + (e % kHalf) * kThreads;
      const bool ok = j / NP < tc && j % NP < n;
      const float v = ok ? __uint_as_float(p.bc_bf16 ? raw[e] << 16 : raw[e]) : 0.f;
      (arr ? sm.cs : sm.bs)[st][j / NP][j % NP] = v;
    }
  }

  // y rows t0 .. t0 + tc - 1 of the block's channels from stage st.
  __device__ __forceinline__ void write_rows(int st, int t0, int tc) {
    T* yb = static_cast<T*>(p.y) + (row0 + t0) * di + d0;
    if (p.vec_rows) {
      constexpr int kPieces = kChunk * kRowPieces;
      static_assert(kPieces % kThreads == 0, "whole copies a thread");
#pragma unroll 4
      for (int e = 0; e < kPieces / kThreads; ++e) {
        const int i = tid + e * kThreads;
        const int tt = i / kRowPieces;
        const int col = (i % kRowPieces) * kPiece;
        if (tt < tc && d0 + col < di)
          *reinterpret_cast<uint4*>(yb + tt * di + col) =
              *reinterpret_cast<const uint4*>(&sm.ys[st][tt][col]);
      }
    } else {
#pragma unroll 4
      for (int i = tid; i < kChunk * kChannels; i += kThreads) {
        const int tt = i / kChannels;
        const int col = i % kChannels;
        if (tt < tc && d0 + col < di) yb[tt * di + col] = sm.ys[st][tt][col];
      }
    }
  }

  // This lane's states of its two channels from h0 (0 without it) and their
  // rows of a, times log2(e).
  __device__ __forceinline__ void load_state() {
#pragma unroll
    for (int c = 0; c < kLaneChannels; ++c) {
      const bool active = d + c < di;
      const size_t at = (size_t(bb) * di + d + c) * n + n0;
      const size_t at_a = size_t(d + c) * n + n0;
      if (p.vec_state) {
        const bool on = active && n0 < n;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 hv = on && p.h0 != nullptr ? *reinterpret_cast<const float4*>(p.h0 + at)
                                                : zero;
        const float4 av = on ? *reinterpret_cast<const float4*>(p.a + at_a) : zero;
        h[c][0] = hv.x, h[c][1] = hv.y, h[c][2] = hv.z, h[c][3] = hv.w;
        a2[c][0] = av.x, a2[c][1] = av.y, a2[c][2] = av.z, a2[c][3] = av.w;
      } else {
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const bool on = active && n0 + q < n;
          h[c][q] = on && p.h0 != nullptr ? p.h0[at + q] : 0.f;
          a2[c][q] = on ? p.a[at_a + q] : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < P; ++q) a2[c][q] *= kLog2e;  // padded states: a 0, b 0, h 0 stay 0
    }
  }
  __device__ __forceinline__ void store_state() {
#pragma unroll
    for (int c = 0; c < kLaneChannels; ++c) {
      const bool active = d + c < di;
      const size_t at = (size_t(bb) * di + d + c) * n + n0;
      if (p.vec_state) {
        if (active && n0 < n)
          *reinterpret_cast<float4*>(p.h_out + at) =
              make_float4(h[c][0], h[c][1], h[c][2], h[c][3]);
      } else {
#pragma unroll
        for (int q = 0; q < P; ++q)
          if (active && n0 + q < n) p.h_out[at + q] = h[c][q];
      }
    }
  }

  // One step on this lane's states of its two channels: their parts of y.
  __device__ __forceinline__ void advance(int st, int tt, float (&yv)[kLaneChannels]) {
    const float2 dtv = load2(&sm.dts[st][tt][ch]);
    const float2 xv = load2(&sm.xs[st][tt][ch]);
    const float dts_[kLaneChannels] = {dtv.x, dtv.y};
    const float dx[kLaneChannels] = {dtv.x * xv.x, dtv.y * xv.y};
    const float4 bq = *reinterpret_cast<const float4*>(&sm.bs[st][tt][n0]);
    const float4 cq = *reinterpret_cast<const float4*>(&sm.cs[st][tt][n0]);
#pragma unroll
    for (int c = 0; c < kLaneChannels; ++c) {
      h[c][0] = fmaf(ex2(dts_[c] * a2[c][0]), h[c][0], dx[c] * bq.x);
      h[c][1] = fmaf(ex2(dts_[c] * a2[c][1]), h[c][1], dx[c] * bq.y);
      h[c][2] = fmaf(ex2(dts_[c] * a2[c][2]), h[c][2], dx[c] * bq.z);
      h[c][3] = fmaf(ex2(dts_[c] * a2[c][3]), h[c][3], dx[c] * bq.w);
      float v = h[c][0] * cq.x;
      v = fmaf(h[c][1], cq.y, v);
      v = fmaf(h[c][2], cq.z, v);
      yv[c] = fmaf(h[c][3], cq.w, v);
    }
  }

  // One step, y summed over the group (butterfly) and written by its first
  // lane: the tail of the sequence.
  __device__ __forceinline__ void step(int st, int tt) {
    float yv[kLaneChannels];
    advance(st, tt, yv);
#pragma unroll
    for (int w = G / 2; w > 0; w /= 2) {
#pragma unroll
      for (int c = 0; c < kLaneChannels; ++c) yv[c] += __shfl_xor_sync(0xffffffffu, yv[c], w);
    }
    if (g == 0) store2(&sm.ys[st][tt][ch], yv[0], yv[1]);
  }

  // G steps, their partial sums of y reduced over the group at once: in the
  // round of width w a lane keeps the half of its sums that its bit w
  // selects and adds the partner's, so G - 1 shuffles a channel (not
  // G log2 G) leave lane g with the whole y of step tt + g, which it writes.
  __device__ __forceinline__ void group_steps(int st, int tt) {
    float v[G][kLaneChannels];
#pragma unroll
    for (int j = 0; j < G; ++j) advance(st, tt + j, v[j]);
#pragma unroll
    for (int w = G / 2; w > 0; w /= 2) {
      const bool upper = g & w;
#pragma unroll
      for (int i = 0; i < w; ++i) {
#pragma unroll
        for (int c = 0; c < kLaneChannels; ++c) {
          const float send = upper ? v[i][c] : v[i + w][c];
          const float keep = upper ? v[i + w][c] : v[i][c];
          v[i][c] = keep + __shfl_xor_sync(0xffffffffu, send, w);
        }
      }
    }
    store2(&sm.ys[st][tt + g][ch], v[0][0], v[0][1]);
  }
};

template <typename T, int G>
__global__ void __launch_bounds__(32 * G, 16 / G) mamba1_scan_kernel(const Params p) {
  using L = Lane<T, G>;
  constexpr int kChunk = L::kChunk;
  __shared__ typename L::Stage sm;
  L lane(p, sm);
  const int s_len = p.s_len;
  const int n_chunks = (s_len + kChunk - 1) / kChunk;

  // Chunk 0 in flight first, then this lane's states and a.
  lane.load_rows(0, 0, min(kChunk, s_len));
  lane.fetch_bc(0, min(kChunk, s_len));
  lane.load_state();
  lane.store_bc(0, min(kChunk, s_len));

  for (int k = 0; k < n_chunks; ++k) {
    const int st = k & 1;
    const int t0 = k * kChunk;
    const int tc = min(kChunk, s_len - t0);
    cp_async_wait_all();
    __syncthreads();  // chunk k staged; every thread is done with chunk k - 1
    const bool more = k + 1 < n_chunks;
    const int tn = min(kChunk, s_len - t0 - kChunk);
    if (more) {  // chunk k + 1 into the other stage while chunk k runs
      lane.load_rows(st ^ 1, t0 + kChunk, tn);
      lane.fetch_bc(t0 + kChunk, tn);
    }
    if (k > 0) lane.write_rows(st ^ 1, t0 - kChunk, kChunk);
    if (tc == kChunk) {
#pragma unroll 2
      for (int tt = 0; tt < kChunk; tt += G) lane.group_steps(st, tt);
    } else {
      for (int tt = 0; tt < tc; ++tt) lane.step(st, tt);
    }
    if (more) lane.store_bc(st ^ 1, tn);
  }
  __syncthreads();
  lane.write_rows((n_chunks - 1) & 1, (n_chunks - 1) * kChunk, s_len - (n_chunks - 1) * kChunk);
  lane.store_state();
}

template <typename T, int G>
cudaError_t launch_g(const Params& p, int bsz, cudaStream_t stream) {
  const dim3 grid((p.di + kChannels - 1) / kChannels, bsz);
  mamba1_scan_kernel<T, G><<<grid, 32 * G, 0, stream>>>(p);
  return cudaGetLastError();
}

// The group: the fewest lanes of 4 states that hold N (a power of two).
template <typename T>
cudaError_t launch(const Params& p, int bsz, cudaStream_t stream) {
  if (p.n <= 4) return launch_g<T, 1>(p, bsz, stream);
  if (p.n <= 8) return launch_g<T, 2>(p, bsz, stream);
  if (p.n <= 16) return launch_g<T, 4>(p, bsz, stream);
  return launch_g<T, 8>(p, bsz, stream);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

extern "C" {

int mamba1_scan_launch(const void* x, const void* dt, const float* a, const void* b,
                       const void* c, const float* h0, void* y, float* h_out, int bsz,
                       int s_len, int di, int n, long long b_sb, long long b_ss,
                       long long c_sb, long long c_ss, int dtype, int bc_dtype,
                       void* stream) {
  cudaGetLastError();  // clear a stale, non-sticky error
  if (bsz <= 0 || bsz > 65535 || s_len <= 0 || di <= 0 || n <= 0 || n > 32 ||
      (dtype != 0 && dtype != 1) || (bc_dtype != 0 && bc_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x, p.dt = dt, p.a = a, p.b = b, p.c = c, p.h0 = h0, p.y = y, p.h_out = h_out;
  p.bc_bf16 = bc_dtype == 1;
  const int esize = p.bc_bf16 ? 2 : 4;
  p.b_sb = b_sb * esize, p.b_ss = b_ss * esize, p.c_sb = c_sb * esize, p.c_ss = c_ss * esize;
  p.s_len = s_len, p.di = di, p.n = n;
  const int piece = dtype == 0 ? 4 : 8;  // elements of x's type in 16 bytes
  p.vec_rows = di % piece == 0 && aligned16(x) && aligned16(dt) && aligned16(y);
  p.vec_state = n % 4 == 0 && aligned16(a) && aligned16(h_out) &&
                (h0 == nullptr || aligned16(h0));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch<float>(p, bsz, s)
                                     : launch<__nv_bfloat16>(p, bsz, s);
  return static_cast<int>(err);
}

const char* mamba1_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
