// Mamba-1 selective scan, backward: CUDA C++ for sm_90a.
//
// The gradient of the scan in mamba1_scan.cu (the Pallas TPU kernel
// mamba1_scan_pallas, src/repro/kernels/mamba_scan/kernel.py, has no
// custom_vjp: JAX differentiates the plain chunked scan off the TPU, so this
// kernel replaces autograd through that plain version). It computes what
// ../ref.py::mamba1_scan_bwd_ref computes: with alpha_t = exp(dt_t a),
// u_t = alpha_t h_{t-1} and the adjoint lam_t = dL/dh_t walked back in time,
//     lam_t  = C_t gy_t + alpha_{t+1} lam_{t+1}      (lam_{S-1} = gh + C_{S-1} gy_{S-1})
//     gC_t   = sum_d gy_t h_t            gB_t  = sum_d lam_t dt_t x_t
//     gx_t   = dt_t sum_n lam_t B_t      gdt_t = sum_n lam_t (a u_t + x_t B_t)
//     ga     = sum_{b,t} lam_t dt_t u_t                  gh0 = alpha_0 lam_0
// in float32, gx / gdt written in x's type, gB / gC in b's type. Its
// schedule and algebra, step for step, are
// ../ref.py::mamba1_scan_bwd_schedule_reference's.
//
// What bounds it on an H100: the instructions a (token, channel, state)
// takes -- a forward sweep to the checkpoints (3 float32 and an exponential),
// the chunk's recompute (4 and an exponential) and the walk back (7), with
// the cross-lane sums, the staged rows' loads and their bf16 unpacking
// around them -- at one warp instruction a clock a sub-partition, and the
// latency of them that the walk's 8 warps an SM do not hide (at one block an
// SM instead of two it runs 1.51x longer, not 2x); the sweep at 16 warps an
// SM runs near its exponentials' rate on the special-function units (16 a
// clock an SM). The bytes (x, dt, gy, b, c read, gx, gdt written, the
// checkpoints) are far below while loads are in flight as the block computes.
//
// The design followed a census of the SASS of a first, plain version (a
// shared-memory stash of h, three exponentials, plain butterflies, every
// chunk staged by loads between two barriers: 0.644 ms at falcon-mamba-7b's
// train shape B 16 x 128 x 8192 x 16 on an H100, 9.7x its bound) and of
// ablations of it: 302 instructions a thread-step (205 in the walk back, 32
// of them shuffles); the staging's exposed loads 14 % of the time, the
// forward sweep 22 %, the shuffles 9 %, the checkpoints' traffic 4 %, the
// third exponential 1.6 %, the second kernel 3.8 %. Design (times at that
// shape, on that card):
//   * the forward kernel's lane layout: a block covers 64 channels of one
//     batch row, a group of G lanes the two adjacent channels of a pair, 4
//     states a lane (G = 4 at N = 16); its exponential, ex2.approx.ftz of
//     dt * a log2(e) (one MUFU.EX2);
//   * the walk back needs the states in reverse order. A forward sweep from
//     h0 keeps the state at the start of every chunk of kChunk = 8 steps (the
//     checkpoints) in a workspace in device memory; then, chunk by chunk from
//     the last, the chunk is recomputed from its checkpoint and walked back.
//     The sweep is a launch of its own (the same kernel, kWalk false): it
//     needs about 125 registers, so it runs at 16 warps an SM where the walk
//     runs at 8 (in one launch it took 24 % of the time; apart 0.093 ms of
//     0.46, -2 % at B 16 x 128 and -8 % at B 4 x 2048). The recompute keeps
//     alpha_t and u_t = alpha_t h_{t-1} of its 8 steps in registers (128 a
//     lane, the loops unrolled over the chunk), so the walk back takes no
//     exponential and no shared-memory load of a state: two exponentials a
//     (token, channel, state), not three, and w = lam u needs no h_{t-1}
//     (nor the identity alpha_t h_{t-1} = h_t - dt x B, which cancels).
//     gC_t = sum_d gy_t h_t needs no adjoint, so the recompute sums it;
//   * the trade taken for the registers: the walk's 255 a lane (ptxas
//     spills a few bytes) hold 8 warps an SM, 2 blocks at G = 4, and the
//     chunk stays at 8 steps (16 would need 256 registers for the stash
//     alone; a chunk of 4 ran 8-9 % slower, at 8 warps an SM and at 12 with
//     168 registers; a stash of u alone with the third exponential back, at
//     12 warps, ran 2-4 % faster at B 16 x 128 and 12-15 % slower at B 4 x
//     2048). Keeping the last chunks' checkpoints in shared memory instead
//     of the workspace (a lane's own) gained nothing measurable;
//   * the cross-lane sums are transposed butterflies, as the forward's
//     group_steps: in each round a lane keeps half of its values and adds
//     the partner's half, so lanes end with different sums. gB / gC (4
//     states' sums over the warp's 8 channel pairs) take 2 + 1 + 1 shuffles
//     a step, not 12; gx / gdt (both channels' dt sum_n lam B and
//     ln 2 sum_n w a log2(e) + x sum_n lam B, 4 values over the group) 2 + 1,
//     not 8: 11 shuffles a thread-step against the first version's 32. For
//     gB / gC a lane holds its 4 states in an order of its own (register q
//     is state q ^ m, m from the lane's pair bits; b and c are kept in
//     shared memory in all 4 orders), so that every lane keeps its lower
//     half and sends its upper one: no selects. A step's sums stay in
//     registers until its chunk is done: a store to shared memory between
//     two steps holds the next step's loads, and the arithmetic after them,
//     behind the shuffles (0.58 -> 0.51 ms);
//   * staging by a two-stage ring in shared memory, as the forward's, each
//     stage 2 chunks (16 steps: one barrier per 16, 0.50 -> 0.46 ms; 4
//     chunks leave no room at float32 and N 32): the x, dt (and gy) rows of
//     the next stage (the previous one, walking back) are copied by 16-byte
//     cp.async (element loads where a row is not 16-byte aligned), its b and
//     c loaded into registers, while this one runs; a chunk's checkpoint is
//     read while the chunk after it walks back. The stage's gx / gdt rows
//     and per-warp sums of gB / gC are gathered in shared memory and written
//     after the next barrier;
//   * the sums over channels of gB and gC go from the block's warps (in
//     order) into per-block partials in a float32 workspace, and a third
//     kernel sums them over blocks, each output over 4 interleaved sets of
//     blocks then the sets in order (and ga's per-row partials over batch
//     rows): a fixed order, no atomics, two runs give the same bits;
//   * b and c are read in their own type (bfloat16 or float32) with their
//     own batch and step strides (the models pass strided slices of the
//     x_proj product). Steps past the end of the sequence run on zeros
//     (alpha 1, nothing added), so the unrolled chunk needs no tail code.

// Interface: plain C. mamba1_scan_bwd_workspace_floats gives the float32
// workspace a call needs; mamba1_scan_bwd_launch makes the call's three
// launches and returns the cudaError_t of the first that fails (0 on
// success). Pointers are device pointers: x, dt, gy, gx,
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
constexpr int kStageChunks = 2;                // chunks a stage of the ring holds
constexpr int kStage = kStageChunks * kChunk;  // its steps
constexpr int kWarpsPerSM = 8;                 // at up to 255 registers a lane

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
  float* ws;      // checkpoints: (B, blocks, n_chunks, 2, threads) float4
  float* part_b;  // (B, blocks, S, N) per-block sums of gB
  float* part_c;  // (B, blocks, S, N) per-block sums of gC
  float* part_a;  // (B, DI, N) per-row sums of ga
  long long b_sb, b_ss, c_sb, c_ss;  // strides of b and c along B and S, in bytes
  int s_len, di, n, n_blk, n_chunks;
  bool bc_bf16;   // b and c are bfloat16 (else float32)
  bool vec_rows;  // x, dt, gy, gx and gdt rows move as 16-byte pieces
};

// ---- PTX helpers -----------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
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
  const uint32_t w = *reinterpret_cast<const uint32_t*>(s);  // two bf16: a shift and a mask
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ void store2(float* s, float a, float b) {
  *reinterpret_cast<float2*>(s) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* s, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(s) = __floats2bfloat162_rn(a, b);
}

// ---- the transposed butterflies --------------------------------------------

// One halving round at xor distance w: the lane whose bit w is set keeps the
// upper half of v[0 .. 2 half) and sends the lower, its partner the reverse;
// v[0 .. half) then holds the kept half summed with the partner's.
template <int half>
__device__ __forceinline__ void halve(float (&v)[4], int lane, int w) {
  const bool up = lane & w;
#pragma unroll
  for (int i = 0; i < half; ++i) {
    const float send = up ? v[i] : v[i + half];
    const float keep = up ? v[i + half] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, w);
  }
}

// Four states' sums over the warp's lanes that hold them (xor distances G ..
// 16), the states in the lane's order (below): v[i] holds state n0 + (i ^
// m), m = 2 bit(lane, G) + bit(lane, 2G), so that in each halving round
// every lane keeps its lower half and sends its upper one, which is the
// partner's lower half -- no selects. v[0] ends as the sum of state n0 + m,
// the same in the lanes that differ in higher bits.
template <int G>
__device__ __forceinline__ float pair_sum(float (&v)[4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i + 2], G);
  v[0] += __shfl_xor_sync(0xffffffffu, v[1], 2 * G);
#pragma unroll
  for (int w = 4 * G; w < 32; w *= 2) v[0] += __shfl_xor_sync(0xffffffffu, v[0], w);
  return v[0];
}

// Four values' sums over the group's G lanes (xor distances 1 .. G / 2),
// halving while more than one value is left: lane g ends with values
// 2 bit(g, 1) + bit(g, 2) (G >= 4; the same in lanes that differ in bit 4),
// 2 bit(g, 1) + {0, 1} (G = 2) or all four (G = 1).
template <int G>
__device__ __forceinline__ void group_sum(float (&v)[4], int lane) {
  if constexpr (G >= 2) halve<2>(v, lane, 1);
  if constexpr (G >= 4) halve<1>(v, lane, 2);
  if constexpr (G >= 8) v[0] += __shfl_xor_sync(0xffffffffu, v[0], 4);
}

// ---- the kernel ------------------------------------------------------------

// One block's shared memory besides its checkpoints: the two-stage ring of
// x, dt, gy rows and of b, c as float32 (padded to the group's states with
// zeros), and, for the chunk walked back and the one before it, the rows of
// gx, gdt and the per-warp sums of gB, gC.
template <typename T, int G>
struct __align__(16) Smem {
  static constexpr int kThreads = 32 * G;
  static constexpr int NP = G * P;
  __align__(16) T rows[2][3][kStage][kChannels];  // x, dt, gy
  __align__(16) float bc[2][2][kStage][4][NP];    // b, c in the 4 lane orders
  __align__(16) T out[2][2][kStage][kChannels];   // gx, gdt
  float part[2][2][G][kStage][NP];                // gB, gC of each warp
};

// The forward sweep to the checkpoints (kWalk false: few registers, twice
// the warps an SM) or the walk back (kWalk true); one source, two launches.
template <typename T, int G, bool kWalk>
__global__ void __launch_bounds__(32 * G, (kWalk ? 1 : 2) * kWarpsPerSM / G)
    mamba1_scan_bwd_kernel(const Params p) {
  using S = Smem<T, G>;
  constexpr int kThreads = S::kThreads;
  constexpr int NP = S::NP;
  constexpr int kPiece = 16 / sizeof(T);          // elements per 16-byte copy
  constexpr int kRowPieces = kChannels / kPiece;  // 16-byte copies per row
  constexpr int kBC = 2 * kStage * NP / kThreads; // b / c elements a lane loads
  static_assert(kBC * kThreads == 2 * kStage * NP, "layout");
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
  const int di = p.di, n = p.n, s_len = p.s_len, n_chunks = p.n_chunks;
  const size_t row0 = size_t(bb) * s_len;
  const T* xg = static_cast<const T*>(p.x);
  const T* dtg = static_cast<const T*>(p.dt);
  const T* gyg = static_cast<const T*>(p.gy);
  float4* ws = reinterpret_cast<float4*>(p.ws) +
               (size_t(bb) * p.n_blk + blk) * n_chunks * kLaneChannels * kThreads;

  // The chunk-invariant parts of this lane's addresses: the block's first
  // row and channel, b / c of its batch row, its part of the partials.
  const size_t rows_at = row0 * di + d0;
  const char* b_row = static_cast<const char*>(p.b) + bb * p.b_sb;
  const char* c_row = static_cast<const char*>(p.c) + bb * p.c_sb;
  const size_t part_at = (size_t(bb) * p.n_blk + blk) * s_len * n;
  T* gxp = static_cast<T*>(p.gx);
  T* gdtp = static_cast<T*>(p.gdt);

  // The x, dt (and gy) rows of stage k into stage st; steps past the end and
  // channels past DI read as 0. A lane's copies are fixed: copy i = tid + e
  // kThreads of (x, dt, gy) x (kStage steps) x (the row's 16-byte pieces).
  auto stage_rows = [&](int st, int k, bool with_gy) {
    const int t0 = k * kStage, tc = min(kStage, s_len - t0);
    const size_t at = rows_at + size_t(t0) * di;
    if (p.vec_rows) {
      constexpr int kCopies = 3 * kStage * kRowPieces;
#pragma unroll
      for (int e = 0; e < (kCopies + kThreads - 1) / kThreads; ++e) {
        const int i = tid + e * kThreads;
        const int arr = i / (kStage * kRowPieces);
        const int tt = i / kRowPieces % kStage;
        const int col = i % kRowPieces * kPiece;
        if ((kCopies % kThreads == 0 || i < kCopies) && (arr < 2 || with_gy)) {
          const bool in = tt < tc && d0 + col < di;
          const T* base = arr == 0 ? xg : arr == 1 ? dtg : gyg;
          cp_async16(&sm.rows[st][arr][tt][col], in ? base + at + tt * di + col : base, in);
        }
      }
    } else {
      for (int i = tid; i < (with_gy ? 3 : 2) * kStage * kChannels; i += kThreads) {
        const int arr = i / (kStage * kChannels);
        const int tt = i / kChannels % kStage;
        const int col = i % kChannels;
        const T* base = arr == 0 ? xg : arr == 1 ? dtg : gyg;
        sm.rows[st][arr][tt][col] =
            tt < tc && d0 + col < di ? base[at + tt * di + col] : from_float<T>(0.f);
      }
    }
    cp_async_commit();
  };

  // b and c of stage k into registers as raw bits, then (store_bc) into
  // stage st as float32. Element e of a lane is element j = tid + e kThreads
  // of (b, c) x (kStage steps) x (NP states); one past the end or past N
  // reads element 0 and is stored as 0.
  uint32_t raw[kBC];
  auto fetch_bc = [&](int k) {
    const int t0 = k * kStage, tc = min(kStage, s_len - t0);
    const int esize = p.bc_bf16 ? 2 : 4;
#pragma unroll
    for (int e = 0; e < kBC; ++e) {
      const int j = tid + e * kThreads;
      const int arr = j / (kStage * NP), tt = j / NP % kStage, kk = j % NP;
      const char* src = arr ? c_row + (t0 + tt) * p.c_ss : b_row + (t0 + tt) * p.b_ss;
      src = tt < tc && kk < n ? src + kk * esize : (arr ? c_row : b_row);
      raw[e] = p.bc_bf16 ? load_u16(src) : load_u32(src);
    }
  };
  auto store_bc = [&](int st, int k) {
    const int tc = min(kStage, s_len - k * kStage);
#pragma unroll
    for (int e = 0; e < kBC; ++e) {
      const int j = tid + e * kThreads;
      const int arr = j / (kStage * NP), tt = j / NP % kStage, kk = j % NP;
      const bool ok = tt < tc && kk < n;
      const float v = ok ? __uint_as_float(p.bc_bf16 ? raw[e] << 16 : raw[e]) : 0.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) sm.bc[st][arr][tt][m][(kk & ~3) | ((kk & 3) ^ m)] = v;
    }
  };

  // Where this lane keeps its checkpoint of chunk k, channel c.
  auto ckpt = [&](int k, int c) { return ws + (size_t(k) * kLaneChannels + c) * kThreads + tid; };

  // The gx / gdt rows and the per-block sums of gB / gC (over the block's
  // warps in order; one (step, state) a lane) of stage k, from stage st.
  static_assert(kStage * NP % kThreads == 0, "whole partials a lane");
  auto flush = [&](int st, int k) {
    const int t0 = k * kStage, tc = min(kStage, s_len - t0);
    const size_t at = rows_at + size_t(t0) * di;
    if (p.vec_rows) {
      constexpr int kCopies = 2 * kStage * kRowPieces;
#pragma unroll
      for (int e = 0; e < (kCopies + kThreads - 1) / kThreads; ++e) {
        const int i = tid + e * kThreads;
        const int arr = i / (kStage * kRowPieces);
        const int tt = i / kRowPieces % kStage;
        const int col = i % kRowPieces * kPiece;
        if ((kCopies % kThreads == 0 || i < kCopies) && tt < tc && d0 + col < di)
          *reinterpret_cast<uint4*>((arr ? gdtp : gxp) + at + tt * di + col) =
              *reinterpret_cast<const uint4*>(&sm.out[st][arr][tt][col]);
      }
    } else {
      for (int i = tid; i < 2 * kStage * kChannels; i += kThreads) {
        const int arr = i / (kStage * kChannels);
        const int tt = i / kChannels % kStage;
        const int col = i % kChannels;
        if (tt < tc && d0 + col < di)
          (arr ? gdtp : gxp)[at + tt * di + col] = sm.out[st][arr][tt][col];
      }
    }
#pragma unroll
    for (int e = 0; e < kStage * NP / kThreads; ++e) {
      const int tt = (tid + e * kThreads) / NP, kk = tid % NP;
      if (tt < tc && kk < n) {
        float sb = 0.f, sc = 0.f;
#pragma unroll
        for (int w = 0; w < G; ++w) {
          sb += sm.part[st][0][w][tt][kk];
          sc += sm.part[st][1][w][tt][kk];
        }
        const size_t pat = part_at + size_t(t0 + tt) * n + kk;
        p.part_b[pat] = sb;
        p.part_c[pat] = sc;
      }
    }
  };

  // The first stage in flight first (the sweep's first; the walk's last,
  // with gy), then this lane's rows of a times log2(e) and, for the sweep,
  // its states of its two channels from h0 (0 without it); for the walk,
  // the carried adjoint alpha lam from gh (0) and the last chunk's
  // checkpoint. A lane holds its states in the order of pair_sum: register
  // q is state n0 + (q ^ m), and it reads b and c in that order (bc[..][m]).
  const int m = 2 * (lane / G & 1) + (lane / G >> 1 & 1);
  const int n_stages = (s_len + kStage - 1) / kStage;
  const int first = kWalk ? n_stages - 1 : 0;
  stage_rows(first & 1, first, kWalk);
  fetch_bc(first);
  float h[kLaneChannels][P], a2[kLaneChannels][P], r[kLaneChannels][P], ga[kLaneChannels][P];
#pragma unroll
  for (int c = 0; c < kLaneChannels; ++c) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int nn = n0 + (q ^ m);
      const bool on = d + c < di && nn < n;
      const size_t at = (size_t(bb) * di + d + c) * n + nn;
      a2[c][q] = on ? p.a[size_t(d + c) * n + nn] * kLog2e : 0.f;
      if constexpr (kWalk) {
        r[c][q] = on && p.gh != nullptr ? p.gh[at] : 0.f;
        ga[c][q] = 0.f;
      } else {
        h[c][q] = on && p.h0 != nullptr ? p.h0[at] : 0.f;
      }
    }
    if constexpr (kWalk) {
      const float4 v = *ckpt(n_chunks - 1, c);
      h[c][0] = v.x, h[c][1] = v.y, h[c][2] = v.z, h[c][3] = v.w;
    }
  }
  store_bc(first & 1, first);

  if constexpr (!kWalk) {
    // The sweep: forward from h0, stage by stage (stage k holds chunks
    // kStageChunks k and on), the state at the start of every chunk kept.
    for (int k = 0; k < n_stages; ++k) {
      const int st = k & 1;
      cp_async_wait_all();
      __syncthreads();  // stage k landed; every lane is done with stage st ^ 1
      if (k + 1 < n_stages) {
        stage_rows(st ^ 1, k + 1, false);
        fetch_bc(k + 1);
      }
      for (int j = kStageChunks * k; j < min(kStageChunks * (k + 1), n_chunks); ++j) {
#pragma unroll
        for (int c = 0; c < kLaneChannels; ++c)
          *ckpt(j, c) = make_float4(h[c][0], h[c][1], h[c][2], h[c][3]);
        if (j + 1 == n_chunks) break;
        const int t0 = (j - kStageChunks * k) * kChunk;  // the chunk's first step in the stage
#pragma unroll
        for (int tt = 0; tt < kChunk; ++tt) {
          const float2 dtv = load2(&sm.rows[st][1][t0 + tt][ch]);
          const float2 xv = load2(&sm.rows[st][0][t0 + tt][ch]);
          const float4 bq = *reinterpret_cast<const float4*>(&sm.bc[st][0][t0 + tt][m][n0]);
          const float dtc[kLaneChannels] = {dtv.x, dtv.y};
          const float dx[kLaneChannels] = {dtv.x * xv.x, dtv.y * xv.y};
          const float bv[P] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
          for (int c = 0; c < kLaneChannels; ++c) {
#pragma unroll
            for (int q = 0; q < P; ++q)
              h[c][q] = fmaf(dx[c], bv[q], ex2(dtc[c] * a2[c][q]) * h[c][q]);
          }
        }
      }
      if (k + 1 < n_stages) store_bc(st ^ 1, k + 1);
    }
  } else {
    // The walk: stage by stage from the last, and in each its chunks from the
    // last: a chunk recomputed from its checkpoint (alpha and u kept in
    // registers, gC summed), then walked back.
    const int nq = n0 + m;  // this lane's state of pair_sum
    float hn[kLaneChannels][P];  // the previous chunk's checkpoint, read ahead
    for (int k = n_stages - 1; k >= 0; --k) {
      const int st = k & 1;
      cp_async_wait_all();
      __syncthreads();  // stage k landed; stage k + 1's outputs gathered
      if (k + 1 < n_stages) flush(st ^ 1, k + 1);
      if (k > 0) {
        stage_rows(st ^ 1, k - 1, true);
        fetch_bc(k - 1);
      }
      for (int j = min(kStageChunks * (k + 1), n_chunks) - 1; j >= kStageChunks * k; --j) {
        const int t0 = (j - kStageChunks * k) * kChunk;  // the chunk's first step in the stage

        // The sums of a step leave the lanes' registers only after the chunk:
        // a store to shared memory between two steps would hold the next
        // step's loads, and with them its arithmetic, behind this step's
        // shuffles.
        float u[kChunk][kLaneChannels][P], al[kChunk][kLaneChannels][P];
        float sums[kChunk];
#pragma unroll
        for (int tt = 0; tt < kChunk; ++tt) {
          const float2 dtv = load2(&sm.rows[st][1][t0 + tt][ch]);
          const float2 xv = load2(&sm.rows[st][0][t0 + tt][ch]);
          const float2 gyv = load2(&sm.rows[st][2][t0 + tt][ch]);
          const float4 bq = *reinterpret_cast<const float4*>(&sm.bc[st][0][t0 + tt][m][n0]);
          const float dtc[kLaneChannels] = {dtv.x, dtv.y};
          const float dx[kLaneChannels] = {dtv.x * xv.x, dtv.y * xv.y};
          const float gyc[kLaneChannels] = {gyv.x, gyv.y};
          const float bv[P] = {bq.x, bq.y, bq.z, bq.w};
          float pc[P] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int c = 0; c < kLaneChannels; ++c) {
#pragma unroll
            for (int q = 0; q < P; ++q) {
              al[tt][c][q] = ex2(dtc[c] * a2[c][q]);
              u[tt][c][q] = al[tt][c][q] * h[c][q];
              h[c][q] = fmaf(dx[c], bv[q], u[tt][c][q]);
              pc[q] = fmaf(gyc[c], h[c][q], pc[q]);
            }
          }
          sums[tt] = pair_sum<G>(pc);
        }
        if (lane < 4 * G) {
#pragma unroll
          for (int tt = 0; tt < kChunk; ++tt) sm.part[st][1][warp][t0 + tt][nq] = sums[tt];
        }

        // The previous chunk's checkpoint, read while this one walks back (not
        // during the recompute, when the registers are fullest).
        if (j > 0) {
#pragma unroll
          for (int c = 0; c < kLaneChannels; ++c) {
            const float4 v = *ckpt(j - 1, c);
            hn[c][0] = v.x, hn[c][1] = v.y, hn[c][2] = v.z, hn[c][3] = v.w;
          }
        }
        float outs[kChunk][G == 1 ? 4 : G == 2 ? 2 : 1];
#pragma unroll
        for (int tt = kChunk - 1; tt >= 0; --tt) {
          const float2 dtv = load2(&sm.rows[st][1][t0 + tt][ch]);
          const float2 xv = load2(&sm.rows[st][0][t0 + tt][ch]);
          const float2 gyv = load2(&sm.rows[st][2][t0 + tt][ch]);
          const float4 bq = *reinterpret_cast<const float4*>(&sm.bc[st][0][t0 + tt][m][n0]);
          const float4 cq = *reinterpret_cast<const float4*>(&sm.bc[st][1][t0 + tt][m][n0]);
          const float dtc[kLaneChannels] = {dtv.x, dtv.y};
          const float xc[kLaneChannels] = {xv.x, xv.y};
          const float gyc[kLaneChannels] = {gyv.x, gyv.y};
          const float bv[P] = {bq.x, bq.y, bq.z, bq.w};
          const float cv[P] = {cq.x, cq.y, cq.z, cq.w};
          float pb[P] = {0.f, 0.f, 0.f, 0.f};
          float sx[kLaneChannels] = {0.f, 0.f}, sw[kLaneChannels] = {0.f, 0.f};
#pragma unroll
          for (int c = 0; c < kLaneChannels; ++c) {
            const float dx = dtc[c] * xc[c];
#pragma unroll
            for (int q = 0; q < P; ++q) {
              const float lam = fmaf(cv[q], gyc[c], r[c][q]);
              const float w = lam * u[tt][c][q];
              pb[q] = fmaf(lam, dx, pb[q]);
              sx[c] = fmaf(lam, bv[q], sx[c]);
              sw[c] = fmaf(w, a2[c][q], sw[c]);
              ga[c][q] = fmaf(w, dtc[c], ga[c][q]);
              r[c][q] = al[tt][c][q] * lam;
            }
          }
          // gx, gdt of both channels: sums over the channel's states, over the group.
          float v[4] = {dtc[0] * sx[0], dtc[1] * sx[1], fmaf(sw[0], kLn2, xc[0] * sx[0]),
                        fmaf(sw[1], kLn2, xc[1] * sx[1])};
          group_sum<G>(v, lane);
#pragma unroll
          for (int i = 0; i < (G == 1 ? 4 : G == 2 ? 2 : 1); ++i) outs[tt][i] = v[i];
          // gB: sums over channels, over the warp's lanes that hold the same states.
          sums[tt] = pair_sum<G>(pb);
        }
        if (lane < 4 * G) {
#pragma unroll
          for (int tt = 0; tt < kChunk; ++tt) sm.part[st][0][warp][t0 + tt][nq] = sums[tt];
        }
#pragma unroll
        for (int tt = 0; tt < kChunk; ++tt) {
          if constexpr (G == 1) {
            store2(&sm.out[st][0][t0 + tt][ch], outs[tt][0], outs[tt][1]);
            store2(&sm.out[st][1][t0 + tt][ch], outs[tt][2], outs[tt][3]);
          } else if constexpr (G == 2) {
            store2(&sm.out[st][g][t0 + tt][ch], outs[tt][0], outs[tt][1]);
          } else {
            if (g < 4) sm.out[st][g & 1][t0 + tt][ch + (g >> 1)] = from_float<T>(outs[tt][0]);
          }
        }
        if (j > 0) {
#pragma unroll
          for (int c = 0; c < kLaneChannels; ++c) {
#pragma unroll
            for (int q = 0; q < P; ++q) h[c][q] = hn[c][q];
          }
        }
      }
      if (k > 0) store_bc(st ^ 1, k - 1);
    }
    __syncthreads();
    flush(0, 0);

    // gh0 = alpha_0 lam_0 (the carry after step 0) and this row's part of ga.
#pragma unroll
    for (int c = 0; c < kLaneChannels; ++c) {
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int nn = n0 + (q ^ m);
        if (d + c < di && nn < n) {
          const size_t at = (size_t(bb) * di + d + c) * n + nn;
          p.gh0[at] = r[c][q];
          p.part_a[at] = ga[c][q];
        }
      }
    }
  }
}

// gB, gC = the per-block partials summed over blocks; ga = the per-row
// partials summed over batch rows; each in a fixed order. A block sums 64
// outputs, each over kSplit interleaved sets of blocks (k = s, s + kSplit,
// ...) at once, the sets then added in order.
constexpr int kSplit = 4;
constexpr int kReduceOutputs = 64;

template <typename TB>
__global__ void __launch_bounds__(kSplit * kReduceOutputs) mamba1_scan_bwd_reduce_kernel(
    const float* part_b, const float* part_c, const float* part_a, TB* gb, TB* gc, float* ga,
    int bsz, int s_len, int di, int n, int n_blk) {
  __shared__ float sums[2][kSplit][kReduceOutputs];
  const int o = threadIdx.x % kReduceOutputs, set = threadIdx.x / kReduceOutputs;
  const long long idx = blockIdx.x * static_cast<long long>(kReduceOutputs) + o;
  const long long per_row = static_cast<long long>(s_len) * n;
  const bool on = idx < bsz * per_row;
  float sb = 0.f, sc = 0.f;
  if (on) {
    const long long row = idx / per_row, rem = idx % per_row;
    for (int k = set; k < n_blk; k += kSplit) {
      const long long at = (row * n_blk + k) * per_row + rem;
      sb += part_b[at];
      sc += part_c[at];
    }
  }
  sums[0][set][o] = sb;
  sums[1][set][o] = sc;
  __syncthreads();
  if (on && set == 0) {
#pragma unroll
    for (int i = 1; i < kSplit; ++i) {
      sb += sums[0][i][o];
      sc += sums[1][i][o];
    }
    gb[idx] = from_float<TB>(sb);
    gc[idx] = from_float<TB>(sc);
  }
  const long long per_a = static_cast<long long>(di) * n;
  if (set == 1 && idx < per_a) {
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
  int n_chunks;
};

Layout layout(int bsz, int s_len, int di, int n) {
  const long long n_blk = (di + kChannels - 1) / kChannels;
  Layout l;
  l.n_chunks = (s_len + kChunk - 1) / kChunk;
  const long long threads = 32LL * group_of(n);
  l.ws = bsz * n_blk * l.n_chunks * kLaneChannels * threads * 4;
  l.part = round4(bsz * n_blk * static_cast<long long>(s_len) * n);
  l.part_a = round4(static_cast<long long>(bsz) * di * n);
  return l;
}

template <typename T, int G>
cudaError_t launch_g(const Params& p, int bsz, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem<T, G>));
  const dim3 grid(p.n_blk, bsz);
  cudaError_t err = cudaFuncSetAttribute(mamba1_scan_bwd_kernel<T, G, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mamba1_scan_bwd_kernel<T, G, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  mamba1_scan_bwd_kernel<T, G, false><<<grid, 32 * G, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mamba1_scan_bwd_kernel<T, G, true><<<grid, 32 * G, smem, stream>>>(p);
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
  const long long blocks = (total + kReduceOutputs - 1) / kReduceOutputs;
  mamba1_scan_bwd_reduce_kernel<TB><<<static_cast<unsigned>(blocks), kSplit * kReduceOutputs, 0,
                                      stream>>>(
      p.part_b, p.part_c, p.part_a, static_cast<TB*>(gb), static_cast<TB*>(gc), ga, bsz,
      p.s_len, p.di, p.n, p.n_blk);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

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
  p.n_chunks = l.n_chunks;
  const int piece = dtype == 0 ? 4 : 8;  // elements of x's type in 16 bytes
  p.vec_rows = di % piece == 0 && aligned16(x) && aligned16(dt) && aligned16(gy) &&
               aligned16(gx) && aligned16(gdt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch<float>(p, bsz, s) : launch<__nv_bfloat16>(p, bsz, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = p.bc_bf16 ? launch_reduce<__nv_bfloat16>(p, bsz, gb, gc, ga, s)
                  : launch_reduce<float>(p, bsz, gb, gc, ga, s);
  return static_cast<int>(err);
}

}  // extern "C"
