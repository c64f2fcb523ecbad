// Forward attention on the float32 cores for Hopper: the q heads of a kv
// head packed into a block's rows, a row tile sized to the call, k / v tiles
// staged by 16-byte cp.async in their own type while the previous tile is
// computed, and a register micro-tile read as float4. CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py, body _fwd_kernel) for every
// call that kernel.py::variant does not send to flash_decode_sm90.cu (decode,
// Sq = 1, hd a multiple of 8) or flash_attention_sm90.cu (bf16 prefill at hd
// 64 / 128 with Sq >= 64): float32 prefill, bf16 prompts under 64 tokens,
// hd 80 and 256 in either type and decode at an odd head dim. It computes
// what ../ref.py's attention_ref computes: grouped-query attention over
// absolute positions with causal, sliding-window and prefix-LM masks, a
// per-key validity mask and an optional tanh soft-cap; float32 softmax
// state; masked logits take the finite -1e30, so a row that never sees a
// key is written as exact 0; the output is rounded once to the input type.
// ../ref.py's simt_tile_reference repeats the tiling step by step.
//
// What bounds it on an H100: the 4 hd operations per visible (q, key) pair.
// Float32 stays on the float32 cores (67 TFLOP/s; TF32 keeps about three
// decimal digits and would break the 2e-5 tolerance), so at the float32
// prefill shapes a tile's two products are all that matters, and the design
// is that of a SIMT matrix product: few shared-memory loads and no other
// instruction per fused multiply-add. At a short prompt (the 16-token
// forward) the bound is the bytes, and the time is a block's latency: the
// design packs the work so that each byte is read once and the grid spans
// the SMs.
//
// Design.
//   * Rows. The rows of kv head kvh are its G = H / Hkv q heads at each query
//     position, in (position, g) order: flat row f = position G + g, whose q
//     is G hd contiguous values a position. One block takes R = 16, 32, 64 or
//     128 consecutive flat rows of one (batch row, kv head) and reads each
//     k / v tile once for all of them. The wrapper (kernel.py::simt_rows)
//     takes the least R that holds Sq G rows, halved down to 32 while the
//     grid would not fill the SMs once: the 16-token forward (Sq G = 64)
//     runs 64 blocks of 32 rows, the 2048-token prefill blocks of 128 (64 at
//     hd 256). 16 rows take the calls of at most 16 (decode at an odd hd).
//     A tile may cut a group; every row has its own position.
//   * Keys, in tiles of 32 (64 at R = 128) listed before the loop: the block
//     reads its keys' positions and validity (8 loads in flight a thread)
//     and ballots, per 32 keys, the keys some row may see (tested against
//     the least and greatest row position) and the keys every row sees;
//     warp 0 compacts the tiles with a key of the first kind into a list.
//     Tiles with none are never loaded; a tile whose every key every row
//     sees skips the per-entry mask. A block holds the words of 8192 keys at
//     a time and walks longer caches in such chunks. k and v of tile 0 are
//     copied before the list is known (the first listed tile of most calls).
//   * Staging, by 16-byte cp.async (element loads into the same chunks where
//     a row is not whole chunks: hd 36 in bf16, float32 at an hd not a
//     multiple of 4). k has two slots, v one: a tile's k lands while the
//     previous tile's P V runs, its v while its own S and softmax run; two
//     barriers a tile. Float32 lands in the layout the products read; bf16
//     lands as bf16 (half the bytes) and the thread that copied a chunk
//     widens it to float32 once, since every value is read by R / 4 or R / 8
//     threads. q is copied the same way, once.
//   * Products. Thread (ty, tx) owns RPT = 4 rows (8 at R = 128) in both
//     products, so its m, l and accumulators stay in registers: in S = Q K^T
//     the keys tx + TX j, reading float4 along hd from q (a broadcast) and
//     from k rows padded to hd + 4 floats (8 lanes, 8 rows, 8 distinct bank
//     groups); in O += P V the float4 columns tx + TX i, reading P as float4s
//     of its rows from a key-major tile and v along its rows. Shared-memory
//     bandwidth (128 bytes a clock an SM, 16-byte loads costing four
//     wavefronts a warp) bounds both products before the float32 pipes do,
//     so R = 128 takes 64-key tiles and an 8 x 4 logit block (12 float4
//     loads for 128 fused multiply-adds) and an 8-row x 8-column output
//     block (4 loads for 64); TX = 8 at R = 64 and hd <= 128, else 16.
//   * Softmax: logits scaled by scale log2(e) (after the soft-cap, when
//     there is one) and exponentiated with ex2.approx; row maxima and sums
//     are warp shuffles over the TX lanes of a row. -1e30 is kept as the
//     masked value: a row with no visible key yet takes p = 2^0 = 1 for it,
//     and the factor 2^(-1e30 - m) = 0 erases that once a key arrives.
// Shared memory: q (R x hdp floats), two k slots and one v tile, the widened
// bf16 tile, the probabilities (tile keys x (R + 4) floats) and the words:
// 92 KB at hdp 128 and R = 64 (two blocks an SM), 188-213 KB at R = 128 and
// at hdp 256 (one). The attribute is set once per instance and device.
//
// Interface: plain C. flash_attention_launch returns the cudaError_t of the
// launch (0 on success). Pointers are device pointers to contiguous arrays,
// q, k, v 16-byte aligned: q, o (B, Sq, H, hd) and k, v (B, Skv, Hkv, hd) of
// one type (dtype 0 = float32, 1 = bfloat16); q_pos (B, Sq) and kv_pos
// (B, Skv) int32; kv_valid (B, Skv) bytes (0 = invalid) or null for all
// valid; rows (16, 32 or 64, or 128 up to hd 128) the flat rows a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWordKeys = 32;     // keys a ballot word
constexpr int kChunkWords = 256;  // words a block holds at once (8192 keys)
constexpr int kPosUnroll = 8;     // position loads in flight a thread

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* kv_pos;
  const uint8_t* kv_valid;
  void* o;
  int b, sq, skv, h, hkv, hd, group;
  float scale, softcap;
  int causal, window, prefix_len;
};

// Per instance: T the storage type, HDP the padded head dim (64, 128, 256),
// R the flat rows a block. R = 128 (hdp <= 128) takes 64-key tiles and 8 rows
// a thread; the others 32-key tiles and 4 rows a thread.
template <typename T, int HDP, int R>
struct Layout {
  static constexpr bool kBig = R == 128;
  static constexpr int kBK = kBig ? 64 : 32;  // keys a tile
  static constexpr int kW = kBK / kWordKeys;  // ballot words a tile
  static constexpr int kRpt = kBig ? 8 : 4;   // rows a thread
  static constexpr int kTx = (R == 64 && HDP <= 128) ? 8 : 16;  // lanes of a row
  static constexpr int kThreads = R / kRpt * kTx;
  static constexpr int kKeys = kBK / kTx;    // keys of a thread in S
  static constexpr int kCh = HDP / 4 / kTx;  // float4 columns of a thread in O
  static constexpr bool kWiden = sizeof(T) == 2;
  static constexpr int kVec = 16 / int(sizeof(T));  // elements in 16 bytes
  static constexpr int kCpr = HDP / kVec;           // 16-byte chunks of a padded row
  static constexpr int kKStr = HDP + 4;             // floats a k row
  static constexpr int kPStr = R + 4;               // floats a row of P (key-major)
  static constexpr int kChunkTiles = kChunkWords / kW;
  // k and v of a tile as copied: float32 in the layout the products read,
  // bf16 as it is (then widened); k's slots also hold the keys' positions.
  static constexpr int kKBytes = kWiden ? kBK * HDP * 2 : kBK * kKStr * 4;
  static constexpr int kVBytes = kWiden ? kBK * HDP * 2 : kBK * HDP * 4;
  static constexpr int kKSlot = kKBytes + 4 * kBK;
  static constexpr int kOffQ = 0;
  static constexpr int kOffK = kOffQ + R * HDP * 4;  // two slots
  static constexpr int kOffV = kOffK + 2 * kKSlot;
  static constexpr int kOffKf = kOffV + kVBytes;  // widened k and v (bf16)
  static constexpr int kOffVf = kOffKf + (kWiden ? kBK * kKStr * 4 : 0);
  static constexpr int kOffP = kOffVf + (kWiden ? kBK * HDP * 4 : 0);
  static constexpr int kOffAny = kOffP + kBK * kPStr * 4;
  static constexpr int kOffAll = kOffAny + 4 * kChunkWords;
  static constexpr int kOffList = kOffAll + 4 * kChunkWords;
  static constexpr int kOffMisc = kOffList + kChunkTiles;
  static constexpr int kOffRows = kOffMisc + 16;  // the rows' positions
  static constexpr int kSmem = kOffRows + 4 * R;
  static_assert(!kBig || HDP <= 128, "128 rows a block only up to hd 128");
  static_assert(kKeys >= 1 && kCh >= 1 && kThreads % 32 == 0 && kThreads >= kBK, "threads");
  static_assert((kBK * kCpr) % kThreads == 0, "whole copy rounds");
  static_assert(kSmem <= 232448, "shared memory of one block");
  static_assert(!kWiden || R * HDP * 2 <= kBK * HDP * 4, "raw bf16 q fits the widened v tile");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Eight bf16 of a 16-byte chunk as two float4 (bf16 -> float is exact: the
// high half of the word).
__device__ __forceinline__ void widen8(const uint4& u, float4* f) {
  f[0] = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  f[1] = make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                     __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
}

__device__ __forceinline__ void fma4(float a, const float4& b, float4& c) {
  c.x = fmaf(a, b.x, c.x);
  c.y = fmaf(a, b.y, c.y);
  c.z = fmaf(a, b.z, c.z);
  c.w = fmaf(a, b.w, c.w);
}

__device__ __forceinline__ float elem(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float c) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}

// Four output values at out: one 16- or 8-byte store when vec, else the
// first n (1 .. 4) one by one.
template <typename T>
__device__ __forceinline__ void store4(T* out, const float4& x, bool vec, int n) {
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      *reinterpret_cast<float4*>(out) = x;
      return;
    }
  } else {
    if (vec) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
      uint2 u;
      u.x = *reinterpret_cast<uint32_t*>(&lo);
      u.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(out) = u;
      return;
    }
  }
  out[0] = from_float<T>(x.x);
  if (n > 1) out[1] = from_float<T>(x.y);
  if (n > 2) out[2] = from_float<T>(x.z);
  if (n > 3) out[3] = from_float<T>(x.w);
}

template <int N>
struct Int {
  static constexpr int value = N;
};

template <typename T, int HDP, int R>
__global__ void __launch_bounds__(Layout<T, HDP, R>::kThreads)
    flash_fwd_kernel(Params p) {
  using L = Layout<T, HDP, R>;
  constexpr int NT = L::kThreads;
  constexpr int TX = L::kTx;
  constexpr int RPT = L::kRpt;
  constexpr int KEYS = L::kKeys;
  constexpr int CH = L::kCh;
  constexpr int VEC = L::kVec;
  constexpr int CPR = L::kCpr;
  constexpr int BK = L::kBK;
  constexpr int W = L::kW;
  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem + L::kOffQ);
  float* kf = reinterpret_cast<float*>(smem + L::kOffKf);
  float* vf = reinterpret_cast<float*>(smem + L::kOffVf);
  float* ps = reinterpret_cast<float*>(smem + L::kOffP);
  uint32_t* any_s = reinterpret_cast<uint32_t*>(smem + L::kOffAny);
  uint32_t* all_s = reinterpret_cast<uint32_t*>(smem + L::kOffAll);
  uint8_t* list_s = smem + L::kOffList;
  int* misc_s = reinterpret_cast<int*>(smem + L::kOffMisc);
  int* rpos_s = reinterpret_cast<int*>(smem + L::kOffRows);
  const uint32_t smem_u32 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid % TX;
  const int ty = tid / TX;
  // Block i takes (batch row, kv head) i % (B Hkv) and, from the last, row
  // tile i / (B Hkv): under a causal mask the last rows see the most keys,
  // so the longest blocks start first and the grid ends on short ones.
  const int n_bh = p.b * p.hkv;
  const int bh = blockIdx.x % n_bh;
  const int kvh = bh % p.hkv;
  const int bb = bh / p.hkv;
  const int hd = p.hd;
  const int group = p.group;
  const int n_rows = p.sq * group;  // flat rows of this (batch row, kv head)
  const int f0 = (gridDim.x / n_bh - 1 - blockIdx.x / n_bh) * R;
  const bool vec = (hd * int(sizeof(T))) % 16 == 0;  // rows are whole 16-byte chunks
  const int nch = (hd + VEC - 1) / VEC;              // 16-byte chunks of a row
  const int hd4 = (hd + 3) & ~3;
  const int nch4 = hd4 / 4;  // float4 columns of a row
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const size_t key_stride = size_t(p.hkv) * hd;  // elements from one key to the next
  const size_t kv_base = (size_t(bb) * p.skv * p.hkv + kvh) * hd;
  const int* kpos_g = p.kv_pos + size_t(bb) * p.skv;
  const uint8_t* kval_g = p.kv_valid ? p.kv_valid + size_t(bb) * p.skv : nullptr;
  // Element offset of flat row f's q (and output) row.
  auto row_off = [&](int f) {
    const int pos = f / group;
    return ((size_t(bb) * p.sq + pos) * p.h + size_t(kvh) * group + (f - pos * group)) * hd;
  };

  // Copies of k or v of keys kt0 .. kt0 + BK - 1 (zeros past Skv): thread
  // tid takes the 16-byte chunks e = tid + NT i of the tile (row e / CPR),
  // by cp.async, or, for rows that are not whole chunks, by element loads
  // into the same chunks; so a thread widens the bf16 chunks it copied.
  auto load_rows = [&](const T* src, int kt0, int dst_off, int stride_bytes) {
    const int nk = min(BK, p.skv - kt0);
#pragma unroll
    for (int e0 = 0; e0 < BK * CPR; e0 += NT) {
      const int e = e0 + tid;
      const int c = e / CPR;
      const int ch = e % CPR;
      const int at = dst_off + (L::kWiden ? e * 16 : c * stride_bytes + ch * 16);
      if (vec) {
        if (ch < nch) {
          const bool in = c < nk;
          cp_async16(smem_u32 + at,
                     src + kv_base + size_t(kt0 + (in ? c : 0)) * key_stride + ch * VEC, in);
        }
      } else {
        T* dst = reinterpret_cast<T*>(smem + at);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int d = ch * VEC + i;
          dst[i] = (c < nk && d < hd) ? src[kv_base + size_t(kt0 + c) * key_stride + d]
                                      : from_float<T>(0.f);
        }
      }
    }
  };
  auto load_k = [&](int kt0, int slot) {
    const int off = L::kOffK + slot * L::kKSlot;
    load_rows(k, kt0, off, L::kKStr * 4);
    const int nk = min(BK, p.skv - kt0);
    if (tid < BK)
      cp_async4(smem_u32 + off + L::kKBytes + 4 * tid, kpos_g + kt0 + (tid < nk ? tid : 0),
                tid < nk);
  };
  auto load_v = [&](int kt0) { load_rows(v, kt0, L::kOffV, HDP * 4); };
  // bf16: widen the chunks this thread copied into the float32 tile.
  auto widen_own = [&](int src_off, float* dst, int stride) {
#pragma unroll
    for (int e0 = 0; e0 < BK * CPR; e0 += NT) {
      const int e = e0 + tid;
      if (e % CPR < nch) {
        float4 f[2];
        widen8(*reinterpret_cast<const uint4*>(smem + src_off + e * 16), f);
        float* at = dst + (e / CPR) * stride + (e % CPR) * 8;
        *reinterpret_cast<float4*>(at) = f[0];
        *reinterpret_cast<float4*>(at + 4) = f[1];
      }
    }
  };

  // Key tile 0 before its words are known: the first listed tile of most
  // calls, so its copy overlaps the position loads below. q joins k's
  // group: float32 straight into its tile, bf16 as it is into the widened
  // v tile's space (R <= 2 BK: it fits), widened by the thread that copied
  // it before v is first widened. Rows past n_rows are zeros.
  load_k(0, 0);
  const int q_raw = L::kWiden ? L::kOffVf : L::kOffQ;
  if (vec) {
    for (int e = tid; e < R * CPR; e += NT) {
      const int r = e / CPR;
      const int ch = e % CPR;
      if (ch < nch) {
        const bool in = f0 + r < n_rows;
        cp_async16(smem_u32 + q_raw + e * 16, q + row_off(in ? f0 + r : 0) + ch * VEC, in);
      }
    }
  }
  cp_async_commit();
  load_v(0);
  cp_async_commit();

  // The rows' positions (to shared memory, for the per-entry masks), and
  // (each warp for itself) the least and greatest of them, loaded here and
  // reduced where first needed, so that their latency overlaps the key
  // positions'.
  if (tid < R)
    rpos_s[tid] = f0 + tid < n_rows ? __ldg(p.q_pos + size_t(bb) * p.sq + (f0 + tid) / group) : 0;
  constexpr int kQv = (R + 1 + 31) / 32;  // positions f0 / G .. (last row) / G
  int qv[kQv];
  {
    const int p_lo = f0 / group;
    const int p_hi = (min(f0 + R, n_rows) - 1) / group;
#pragma unroll
    for (int i = 0; i < kQv; ++i) {
      const int pp = p_lo + lane + 32 * i;
      qv[i] = pp <= p_hi ? __ldg(p.q_pos + size_t(bb) * p.sq + pp) : INT_MIN;
    }
  }
  int qmin = INT_MAX, qmax = INT_MIN;
  bool q_range = false;
  // Key positions and validity, kPosUnroll keys a thread at a time.
  const int n_words = (p.skv + kWordKeys - 1) / kWordKeys;
  int kp[kPosUnroll];
  bool kin[kPosUnroll];
  auto load_pass = [&](int key0, int key_end, int u0) {
#pragma unroll
    for (int x = 0; x < kPosUnroll; ++x) {
      const int key = key0 + (u0 + x) * NT + tid;
      kin[x] = key < key_end;
      kp[x] = 0;
      if (kin[x]) {
        kp[x] = __ldg(kpos_g + key);
        if (kval_g != nullptr) kin[x] = __ldg(kval_g + key) != 0;
      }
    }
  };

  // Rows of q that are not whole chunks: element loads.
  if (!vec) {
    for (int e = tid; e < R * HDP; e += NT) {
      const int r = e / HDP;
      const int d = e % HDP;
      qs[e] = (f0 + r < n_rows && d < hd) ? to_float(q[row_off(f0 + r) + d]) : 0.f;
    }
  }

  float m[RPT], l[RPT];
  float4 acc[RPT][CH];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const bool capped = p.softcap > 0.f;
  const float qk_scale = capped ? p.scale : p.scale * kLog2e;

  int gi = 0;  // visible tiles so far: tile gi takes k slot gi % 2
  for (int c0 = 0; c0 < n_words; c0 += kChunkWords) {
    const int nw = min(kChunkWords, n_words - c0);
    const int nt = (nw + W - 1) / W;  // tiles of the chunk
    const int key0 = c0 * kWordKeys;
    const int key_end = min(key0 + nw * kWordKeys, p.skv);
    // Words of the chunk's keys: keys some row may see, keys every row sees.
    const int n_pass = (nt * BK + NT - 1) / NT;
    for (int u0 = 0; u0 < n_pass; u0 += kPosUnroll) {
      load_pass(key0, key_end, u0);
      if (!q_range) {
        q_range = true;
#pragma unroll
        for (int i = 0; i < kQv; ++i)
          if (qv[i] != INT_MIN) {
            qmin = min(qmin, qv[i]);
            qmax = max(qmax, qv[i]);
          }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          qmin = min(qmin, __shfl_xor_sync(kFull, qmin, off));
          qmax = max(qmax, __shfl_xor_sync(kFull, qmax, off));
        }
      }
#pragma unroll
      for (int x = 0; x < kPosUnroll; ++x) {
        const bool pre = p.prefix_len > 0 && kp[x] < p.prefix_len;
        const bool some = kin[x] && (pre || ((!p.causal || kp[x] <= qmax) &&
                                            (p.window <= 0 || qmin - kp[x] < p.window)));
        const bool every = kin[x] && (pre || ((!p.causal || kp[x] <= qmin) &&
                                             (p.window <= 0 || qmax - kp[x] < p.window)));
        const uint32_t w_some = __ballot_sync(kFull, some);
        const uint32_t w_every = __ballot_sync(kFull, every);
        const int t = (u0 + x) * (NT / 32) + warp;
        if (lane == 0 && t < nt * W) {
          any_s[t] = w_some;
          all_s[t] = w_every;
        }
      }
    }
    __syncthreads();
    auto tile_words = [&](int t, const uint32_t* words) {
      uint64_t w = words[W * t];
      if (W == 2) w |= uint64_t(words[W * t + 1]) << 32;
      return w;
    };
    if (warp == 0 && nt > 1) {  // compact the tiles with a key some row may see
      int n = 0;
      for (int base = 0; base < nt; base += 32) {
        const int t = base + lane;
        const bool has = t < nt && tile_words(t, any_s) != 0u;
        const uint32_t bal = __ballot_sync(kFull, has);
        if (has) list_s[n + __popc(bal & ((1u << lane) - 1u))] = static_cast<uint8_t>(t);
        n += __popc(bal);
      }
      if (lane == 0) misc_s[0] = n;
    }
    if (nt > 1) __syncthreads();
    const int n_vis = nt > 1 ? misc_s[0] : int(tile_words(0, any_s) != 0u);
    auto tile_key = [&](int idx) { return key0 + (nt > 1 ? int(list_s[idx]) : 0) * BK; };

    // k and v of the first listed tile (the copies of tile 0 when it is
    // that: they must land before their buffers are written again), and k
    // of the second.
    const bool reuse = c0 == 0 && n_vis > 0 && tile_key(0) == 0;
    if (c0 == 0 && !reuse) cp_async_wait<0>();
    if (n_vis > 0) {
      if (!reuse) {
        load_k(tile_key(0), gi & 1);
        cp_async_commit();
        load_v(tile_key(0));
        cp_async_commit();
      }
      if (n_vis > 1) load_k(tile_key(1), (gi + 1) & 1);
      cp_async_commit();
      cp_async_wait<2>();  // k of the first tile (and q)
      if constexpr (L::kWiden) {
        if (gi == 0 && vec) {
          for (int e = tid; e < R * CPR; e += NT) {
            if (e % CPR < nch) {
              float4 f[2];
              widen8(*reinterpret_cast<const uint4*>(smem + q_raw + e * 16), f);
              float* at = qs + (e / CPR) * HDP + (e % CPR) * 8;
              *reinterpret_cast<float4*>(at) = f[0];
              *reinterpret_cast<float4*>(at + 4) = f[1];
            }
          }
        }
        widen_own(L::kOffK + (gi & 1) * L::kKSlot, kf, L::kKStr);
      }
    }
    __syncthreads();

    // Per tile: S and the softmax from k while v lands; P V while the tile
    // after next's k lands. Two barriers a tile.
    for (int it = 0; it < n_vis; ++it, ++gi) {
      const int slot = gi & 1;
      const int t = nt > 1 ? int(list_s[it]) : 0;
      const uint8_t* kslot = smem + L::kOffK + slot * L::kKSlot;
      const float* ks = L::kWiden ? kf : reinterpret_cast<const float*>(kslot);
      const float* vs = L::kWiden ? vf : reinterpret_cast<const float*>(smem + L::kOffV);
      const int* kpos_t = reinterpret_cast<const int*>(kslot + L::kKBytes);
      const uint64_t w_some = tile_words(t, any_s);
      const uint64_t w_every = tile_words(t, all_s);
      // Keys past the last one some row may see (past Skv, or past the
      // causal diagonal) are left out of both products: for a row that has
      // seen a key their p is 0, and a row that has not is erased or written
      // as 0.
      const int nk = 64 - __clzll(w_some);
      const bool full = w_every == (W == 2 ? ~uint64_t(0) : uint64_t(kFull));

      // S = Q K^T: rows RPT ty + i, keys tx + TX j, over the NJ slabs of TX
      // keys that hold one (a tile's last keys may be past Skv); the loop
      // bound is compile-time at the padded head dim.
      float s[RPT][KEYS];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KEYS; ++j) s[i][j] = 0.f;
      const float* qr = qs + RPT * ty * HDP;
      const float* kr = ks + tx * L::kKStr;
      auto qk = [&](auto nj_c, auto hd_c) {
        constexpr int NJ = decltype(nj_c)::value;
        const int n = decltype(hd_c)::value > 0 ? decltype(hd_c)::value : hd4;
#pragma unroll(RPT == 8 ? 2 : 4)
        for (int d = 0; d < n; d += 4) {
          float4 a[RPT], b[NJ];
#pragma unroll
          for (int i = 0; i < RPT; ++i) a[i] = *reinterpret_cast<const float4*>(qr + i * HDP + d);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            b[j] = *reinterpret_cast<const float4*>(kr + j * TX * L::kKStr + d);
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) s[i][j] = dot4(a[i], b[j], s[i][j]);
        }
      };
      const int nj = (nk + TX - 1) / TX;
      if (nj == KEYS && hd4 == HDP) qk(Int<KEYS>{}, Int<HDP>{});
      else if (nj == KEYS) qk(Int<KEYS>{}, Int<0>{});
      else if (nj == 1) qk(Int<1>{}, Int<0>{});
      else if (nj == 2) qk(Int<(KEYS > 2 ? 2 : 1)>{}, Int<0>{});  // KEYS = 4 only
      else qk(Int<(KEYS > 3 ? 3 : 1)>{}, Int<0>{});

      // Online softmax in the log2 domain; P to shared memory, key-major.
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        const int c = tx + TX * j;
        const int kp = full ? 0 : kpos_t[c];
        const bool pre = p.prefix_len > 0 && kp < p.prefix_len;
        const bool some = (w_some >> c) & 1u;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          float x = s[i][j] * qk_scale;
          if (capped) x = p.softcap * tanhf(x / p.softcap) * kLog2e;
          if (!full) {
            const int qp = rpos_s[RPT * ty + i];
            const bool ok = some && (pre || ((!p.causal || kp <= qp) &&
                                             (p.window <= 0 || qp - kp < p.window)));
            x = ok ? x : kNeg;
          }
          s[i][j] = x;
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float mx = s[i][0];
#pragma unroll
        for (int j = 1; j < KEYS; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
        for (int off = TX / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float corr = ex2(m[i] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < KEYS; ++j) {
          s[i][j] = ex2(s[i][j] - m_new);
          rs += s[i][j];
        }
#pragma unroll
        for (int off = TX / 2; off > 0; off >>= 1) rs += __shfl_xor_sync(kFull, rs, off);
        l[i] = l[i] * corr + rs;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          acc[i][c].x *= corr;
          acc[i][c].y *= corr;
          acc[i][c].z *= corr;
          acc[i][c].w *= corr;
        }
      }
#pragma unroll
      for (int j = 0; j < KEYS; ++j)
#pragma unroll
        for (int h = 0; h < RPT / 4; ++h)
          *reinterpret_cast<float4*>(ps + (tx + TX * j) * L::kPStr + RPT * ty + 4 * h) =
              make_float4(s[4 * h][j], s[4 * h + 1][j], s[4 * h + 2][j], s[4 * h + 3][j]);
      cp_async_wait<0>();  // v of this tile and k of the next
      if constexpr (L::kWiden) widen_own(L::kOffV, vf, HDP);
      // Every thread is done with this tile's k slot (and the positions in
      // it): the tile after next may land there while P V runs.
      __syncthreads();
      if (it + 2 < n_vis) load_k(tile_key(it + 2), slot);
      cp_async_commit();

      // O += P V: rows RPT ty + i, float4 columns tx + TX c (all of them:
      // columns past hd are never stored), over the tile's nk keys.
      const float* vc = vs + 4 * tx;
      const float* pr0 = ps + RPT * ty;
      auto pv = [&](auto nk_c) {
        const int n = decltype(nk_c)::value > 0 ? decltype(nk_c)::value : nk;
#pragma unroll 4
        for (int c = 0; c < n; ++c) {
          float4 pr[RPT / 4];
#pragma unroll
          for (int h = 0; h < RPT / 4; ++h)
            pr[h] = *reinterpret_cast<const float4*>(pr0 + c * L::kPStr + 4 * h);
#pragma unroll
          for (int cc = 0; cc < CH; ++cc) {
            const float4 vv = *reinterpret_cast<const float4*>(vc + c * HDP + 4 * TX * cc);
#pragma unroll
            for (int i = 0; i < RPT; ++i) fma4(elem(pr[i / 4], i % 4), vv, acc[i][cc]);
          }
        }
      };
      if (nk == BK) pv(Int<BK>{});
      else pv(Int<0>{});

      if constexpr (L::kWiden)
        if (it + 1 < n_vis) widen_own(L::kOffK + (slot ^ 1) * L::kKSlot, kf, L::kKStr);
      // Every thread is done with this tile's v and P (and the chunk's
      // words), and the next tile's k is in place.
      __syncthreads();
      if (it + 1 < n_vis) load_v(tile_key(it + 1));
      cp_async_commit();
    }
  }
  cp_async_wait<0>();  // no copy may outlive the block (tile 0's when no tile is visible)

  const bool vec_out = hd % 4 == 0;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (f0 + RPT * ty + i >= n_rows) continue;
    const bool seen = m[i] > kNeg / 2;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* out = static_cast<T*>(p.o) + row_off(f0 + RPT * ty + i);
#pragma unroll
    for (int cc = 0; cc < CH; ++cc) {
      const int col = tx + TX * cc;
      if (col < nch4) {
        const float4& a = acc[i][cc];
        const float4 r = seen ? make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        store4<T>(out + 4 * col, r, vec_out, hd - 4 * col);
      }
    }
  }
}

template <typename T, int HDP, int R>
struct Inst {
  using Type = T;
  using Lt = Layout<T, HDP, R>;
  static constexpr int kHdp = HDP;
  static constexpr int kR = R;
};

// Raises the dynamic shared-memory limit of an instance once per device.
template <typename I>
cudaError_t prepare() {
  static std::atomic<uint32_t> ready{0};
  if (I::Lt::kSmem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = dev < 32 ? 1u << dev : 0u;
  if (bit != 0u && (ready.load() & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd_kernel<typename I::Type, I::kHdp, I::kR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, I::Lt::kSmem);
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

template <typename I>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const cudaError_t err = prepare<I>();
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq * p.group + I::kR - 1) / I::kR * p.hkv * p.b);
  flash_fwd_kernel<typename I::Type, I::kHdp, I::kR>
      <<<grid, I::Lt::kThreads, I::Lt::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HDP, typename F>
cudaError_t dispatch_rows(int rows, F&& f) {
  if (rows == 16) return f(Inst<T, HDP, 16>{});
  if (rows == 32) return f(Inst<T, HDP, 32>{});
  if constexpr (HDP <= 128)
    if (rows == 128) return f(Inst<T, HDP, 128>{});
  return f(Inst<T, HDP, 64>{});
}

template <typename T, typename F>
cudaError_t dispatch_hd(int hd, int rows, F&& f) {
  if (hd <= 64) return dispatch_rows<T, 64>(rows, f);
  if (hd <= 128) return dispatch_rows<T, 128>(rows, f);
  return dispatch_rows<T, 256>(rows, f);
}

template <typename F>
cudaError_t dispatch(int dtype, int hd, int rows, F&& f) {
  return dtype == 0 ? dispatch_hd<float>(hd, rows, f) : dispatch_hd<__nv_bfloat16>(hd, rows, f);
}

bool valid_rows(int rows, int hd) {
  return rows == 16 || rows == 32 || rows == 64 || (rows == 128 && hd <= 128);
}

}  // namespace

extern "C" {

int flash_attention_launch(const void* q, const void* k, const void* v, const int* q_pos,
                           const int* kv_pos, const unsigned char* kv_valid, void* o, int b,
                           int sq, int skv, int h, int hkv, int hd, int dtype, int rows,
                           float scale, int causal, int window, int prefix_len, float softcap,
                           void* stream) {
  cudaGetLastError();  // clear a stale, non-sticky error
  const auto misaligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16; };
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || h % hkv != 0 || hd <= 0 || hd > 256 ||
      hkv > 65535 || b > 65535 || (dtype != 0 && dtype != 1) || !valid_rows(rows, hd) ||
      (static_cast<long long>(sq) * (h / hkv) + 15) / 16 * hkv * b > INT_MAX || misaligned(q) ||
      misaligned(k) || misaligned(v))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,  k,   v,  q_pos,   kv_pos, kv_valid, o,      b,      sq,        skv,
                 h,  hkv, hd, h / hkv, scale,  softcap,  causal, window, prefix_len};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, hd, rows, [&](auto inst) {
    return launch<decltype(inst)>(p, s);
  }));
}

// Shared memory a block, threads a block and blocks per SM of the instance
// that takes (dtype, hd, rows), for reports.
int flash_attention_occupancy(int dtype, int hd, int rows, int* smem_bytes, int* threads,
                              int* blocks_per_sm) {
  if (hd <= 0 || hd > 256 || (dtype != 0 && dtype != 1) || !valid_rows(rows, hd))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(dtype, hd, rows, [&](auto inst) {
    using I = decltype(inst);
    *smem_bytes = I::Lt::kSmem;
    *threads = I::Lt::kThreads;
    const cudaError_t err = prepare<I>();
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, flash_fwd_kernel<typename I::Type, I::kHdp, I::kR>, I::Lt::kThreads,
        I::Lt::kSmem);
  }));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
