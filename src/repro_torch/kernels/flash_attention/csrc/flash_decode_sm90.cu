// Decode attention (one query row per batch row) for Hopper: the q heads of
// a kv head packed into one block, the keys split across blocks
// (flash-decoding) and merged in the same launch. CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py, body _fwd_kernel) for calls
// with Sq = 1, float32 or bfloat16, head dim a multiple of 8 up to 256; the
// kernel of flash_attention.cu keeps the rest of Sq = 1 and float32 prefill,
// flash_attention_sm90.cu the bf16 prefill. It computes what ../ref.py's
// attention_ref(..., gqa="group") computes: grouped-query attention over
// absolute positions with causal, sliding-window and prefix-LM masks, a
// per-key validity mask (kv_pos = -1 slots of ring-buffer and partly
// filled caches) and an optional tanh soft-cap; float32 m, l and
// accumulator; masked logits take the finite -1e30, so a row that sees no
// key is written as exact 0. ../ref.py's decode_split_reference repeats the
// split-and-merge arithmetic step by step. Where the caller passes lse, the
// kernel also writes each (batch row, q head)'s float32 log-sum-exp of its
// visible logits, m + log l of the merged (m, l) (-1e30 for a row that sees
// no key; ../ref.py's attention_lse_ref): a tensor-parallel decode whose
// cache slots are split over ranks merges the ranks' outputs with it.
//
// What bounds it on an H100: the bytes of the kv cache. Each key costs
// 2 hd loaded values for 4 hd G operations (G q heads a kv head): 2 operations
// a byte at G = 4 in bf16, far below the ~20 a byte at which the float32
// cores (67 TFLOP/s) would become the limit. So the dot products and sums run
// in float32 on the CUDA cores; tensor cores would not move the bound. What
// the design does is keep enough bytes in flight and read each byte once:
//   * one block of 128 threads (4 warps) per (kv split, kv head x row group,
//     batch row); the G = H / Hkv q heads of a kv head are the block's rows
//     (up to 8 a block; more take several row groups), so each k / v byte is
//     read from HBM once per kv head, not G times;
//   * before the kv loop the block reads the positions and validity of its
//     split (16 loads in flight a thread), builds one visibility word per
//     32-key tile with a warp ballot and compacts the visible tiles into a
//     list; every row of the block shares the batch row's query position, so
//     the word is the mask of all rows. Tiles with no visible key are never
//     loaded: ring-buffer and partly filled caches read only their live part;
//   * k and v stay in their own type (bf16 or float32) in shared memory: a
//     ring of 2-4 stages of 32 keys (2 at bf16 hd 128), filled by 16-byte
//     cp.async (keys past the end zero-filled), the next tile in flight
//     while one is computed. A block's rate is set by its own instruction
//     latency more than by bytes in flight, so few stages and more blocks an
//     SM pay (chip_smoke.py on an H100 SXM at 700 W, B 128 x 32,768 keys,
//     H 32 / 8, hd 128: 5.56 ms with 2 stages and 5 blocks an SM, 6.24
//     with 4 stages and 3);
//     A key's row is read by L lanes (4 to 32, by head dim and rows), lane c
//     taking the 16-byte chunks c + L i; the lane holds the same chunks of q
//     for every row in registers, in float32. With L < 8 the chunks are
//     XOR-swizzled by row, so a quarter-warp's 16-byte loads hit distinct
//     banks;
//   * per tile: each warp takes 8 keys, dot products in float32 FMAs and a
//     shuffle sum over the key's L lanes; one warp a row takes the tile's
//     32 logits (one per lane) through scale, soft-cap, mask, max, exp and
//     sum (warp shuffles); then each warp adds p v over its 8 keys into
//     register accumulators, rescaled once a tile;
//   * the split count comes from the wrapper (kernel.py::decode_plan): one
//     split when Skv is a few tiles; otherwise as many as one wave of
//     resident blocks holds (5 an SM at bf16 hd 128: the card at least twice
//     over), at most 4096 keys a split. With several
//     splits each block writes its float32 (m, l, acc) to a workspace the
//     wrapper owns; the last block of a (batch row, row group) to finish,
//     found by an atomic counter that it resets, merges them with factors
//     exp(m_s - M): a split that saw no key (m_s = -1e30) merges away.
// Shared memory: the stages (32 KB at bf16 hd 128: 2 stages of 16 KB; 64 KB
// for float32 hd 128 and 256 with 2 stages), the logits, probabilities,
// masks and tile list, about 3 KB. Where that passes 48 KB the attribute is
// set once per kernel instance and device.
//
// Interface: plain C. flash_decode_launch returns the cudaError_t of the
// launch (0 on success). Pointers are device pointers to contiguous arrays,
// q, k, v 16-byte aligned: q, o (B, 1, H, hd) and k, v (B, Skv, Hkv, hd) of
// one type (dtype 0 = float32, 1 = bfloat16); q_pos (B, 1) and kv_pos
// (B, Skv) int32; kv_valid (B, Skv) bytes (0 = invalid) or null for all
// valid; lse (B, H) float32 or null. rows (1, 2, 4 or 8, at least
// min(H / Hkv, 8)) is the q heads a block; keys are cut into n_split splits
// of split_tiles 32-key tiles. With
// n_split > 1, ws holds B x Hkv ceil(G / rows) x n_split x rows (2 + hd)
// floats and counters B x Hkv ceil(G / rows) ints, zero before the first
// launch; every launch leaves them at zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;                     // keys per tile: one visibility word
constexpr int kKeysPerWarp = kBK / kWarps;  // 8
constexpr int kMaxSplitTiles = 128;         // 4096 keys a split at most
constexpr int kStageBudget = 32 * 1024;     // bytes of k / v stages a block
constexpr int kPosUnroll = 16;              // position loads in flight a thread

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* kv_pos;
  const uint8_t* kv_valid;
  void* o;
  float* lse;
  float* ws;
  int* counters;
  int b, skv, h, hkv, hd, group, n_groups, n_split, split_tiles;
  float scale, softcap;
  int causal, window, prefix_len;
};

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Per instance: T the storage type, HDP the padded head dim (64, 128, 256),
// GM the rows (q heads) a block.
template <typename T, int HDP, int GM>
struct Layout {
  static constexpr int kVec = 16 / int(sizeof(T));  // elements in a 16-byte chunk
  static constexpr int kChunks = HDP / kVec;        // chunks in a padded row
  // Elements a lane holds of each row, so that q and the accumulator take
  // about 32 registers each: at least one chunk, at most a quarter row.
  static constexpr int kE = cmin(cmax(32 / GM, cmax(kVec, HDP / 32)), HDP / 4);
  static constexpr int kLpk = HDP / kE;     // lanes a key: 4 .. 32
  static constexpr int kCpl = kE / kVec;    // chunks a lane
  static constexpr int kKpw = 32 / kLpk;    // keys a warp step
  static constexpr int kSteps = kKeysPerWarp / kKpw;
  static constexpr int kRowBytes = HDP * int(sizeof(T));
  static constexpr int kTileBytes = kBK * kRowBytes;  // k or v of one tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStages = cmin(cmax(kStageBudget / kStageBytes, 2), 4);
  static constexpr int kRowsPerWarp = (GM + kWarps - 1) / kWarps;
  static constexpr int kOffS = kStages * kStageBytes;   // logits [GM][kBK]
  static constexpr int kOffP = kOffS + 4 * GM * kBK;    // probabilities [kBK][GM]
  static constexpr int kOffCorr = kOffP + 4 * GM * kBK;  // [GM]
  static constexpr int kOffMl = kOffCorr + 4 * GM;      // m, l [2][GM]
  static constexpr int kOffMask = kOffMl + 8 * GM;      // visibility words
  static constexpr int kOffList = kOffMask + 4 * kMaxSplitTiles;  // visible tiles
  static constexpr int kOffMisc = kOffList + kMaxSplitTiles;
  static constexpr int kSmem = kOffMisc + 16;
  static_assert(kLpk >= 4 && kLpk <= 32 && kCpl >= 1 && kSteps >= 1, "lane layout");
  static_assert(kWarps * GM * HDP * 4 <= kStages * kStageBytes, "reduction buffer");
};

// Physical chunk of logical chunk ch in row r: with fewer than 8 lanes a key,
// one quarter-warp reads 8 / L rows; XOR by row keeps their chunks apart.
template <int LPK>
__device__ __forceinline__ int swizzle(int ch, int r) {
  return LPK < 8 ? ch ^ ((r * LPK) & 7) : ch;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> float is exact: the high half of the word
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <typename T, int HDP, int GM>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(Params p) {
  using Lt = Layout<T, HDP, GM>;
  extern __shared__ __align__(128) uint8_t smem[];
  float* s_s = reinterpret_cast<float*>(smem + Lt::kOffS);
  float* p_s = reinterpret_cast<float*>(smem + Lt::kOffP);
  float* corr_s = reinterpret_cast<float*>(smem + Lt::kOffCorr);
  float* ml_s = reinterpret_cast<float*>(smem + Lt::kOffMl);
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(smem + Lt::kOffMask);
  uint8_t* list_s = smem + Lt::kOffList;
  int* misc_s = reinterpret_cast<int*>(smem + Lt::kOffMisc);
  const uint32_t smem_u32 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kk = lane / Lt::kLpk;  // key of the lane within a warp step
  const int c = lane % Lt::kLpk;   // first chunk of the lane
  const int split = blockIdx.x;
  const int grp = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = grp / p.n_groups;
  const int head0 = kvh * p.group + (grp - kvh * p.n_groups) * GM;
  const int rows = min(GM, p.group - (grp - kvh * p.n_groups) * GM);
  const int hd = p.hd;
  const int nch = hd / Lt::kVec;  // live chunks of a row
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  // This lane's chunks of the block's q rows, in float32 (0 past hd and for
  // rows past the group).
  float qf[GM][Lt::kE];
  {
    const T* qb = static_cast<const T*>(p.q) + (size_t(bb) * p.h + head0) * hd;
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int i = 0; i < Lt::kCpl; ++i) {
        const int ch = c + Lt::kLpk * i;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (g < rows && ch < nch) raw = __ldg(reinterpret_cast<const uint4*>(qb + g * hd) + ch);
        unpack<T>(raw, &qf[g][i * Lt::kVec]);
      }
  }

  // Visibility of the split's keys: one word a 32-key tile.
  const int n_tiles = (p.skv + kBK - 1) / kBK;
  const int t0 = split * p.split_tiles;
  const int nt = min(p.split_tiles, n_tiles - t0);
  const int key0 = t0 * kBK;
  const int key_end = min(key0 + nt * kBK, p.skv);
  {
    const int qp = p.q_pos[bb];
    const int* kpos = p.kv_pos + size_t(bb) * p.skv;
    const uint8_t* kval = p.kv_valid ? p.kv_valid + size_t(bb) * p.skv : nullptr;
    const int n_rounds = (nt + kWarps - 1) / kWarps;  // 128 keys a round
    for (int u0 = 0; u0 < n_rounds; u0 += kPosUnroll) {
      int kp[kPosUnroll];
      bool in[kPosUnroll];
#pragma unroll
      for (int x = 0; x < kPosUnroll; ++x) {
        const int key = key0 + (u0 + x) * kThreads + tid;
        in[x] = key < key_end;
        kp[x] = 0;
        if (in[x]) {
          kp[x] = __ldg(kpos + key);
          if (kval != nullptr) in[x] = __ldg(kval + key) != 0;
        }
      }
#pragma unroll
      for (int x = 0; x < kPosUnroll; ++x) {
        bool ok = p.causal ? kp[x] <= qp : true;
        if (p.window > 0) ok = ok && (qp - kp[x] < p.window);
        if (p.prefix_len > 0) ok = ok || (kp[x] < p.prefix_len);
        const uint32_t word = __ballot_sync(kFull, ok && in[x]);
        const int t = (u0 + x) * kWarps + warp;  // lanes of warp w: tile 4 round + w
        if (lane == 0 && t < nt) mask_s[t] = word;
      }
    }
  }
  __syncthreads();
  if (warp == 0) {  // compact the visible tiles into a list
    int n = 0;
    for (int base = 0; base < nt; base += 32) {
      const int t = base + lane;
      const bool has = t < nt && mask_s[t] != 0u;
      const uint32_t bal = __ballot_sync(kFull, has);
      if (has) list_s[n + __popc(bal & ((1u << lane) - 1u))] = static_cast<uint8_t>(t);
      n += __popc(bal);
    }
    if (lane == 0) misc_s[0] = n;
  }
  __syncthreads();
  const int n_vis = misc_s[0];

  const size_t key_stride = size_t(p.hkv) * hd;  // elements from one key to the next
  const size_t kv_base = (size_t(bb) * p.skv * p.hkv + kvh) * hd;
  auto load_tile = [&](int idx, int stage) {
    const int kt0 = key0 + int(list_s[idx]) * kBK;
    const int nk = min(kBK, p.skv - kt0);
    const uint32_t sk = smem_u32 + stage * Lt::kStageBytes;
    const uint32_t sv = sk + Lt::kTileBytes;
#pragma unroll
    for (int e0 = 0; e0 < kBK * Lt::kChunks; e0 += kThreads) {
      const int e = e0 + tid;
      const int r = e / Lt::kChunks;
      const int ch = e % Lt::kChunks;
      if (ch < nch) {
        const bool in = r < nk;
        const size_t off = kv_base + size_t(kt0 + (in ? r : 0)) * key_stride + ch * Lt::kVec;
        const uint32_t at = r * Lt::kRowBytes + (swizzle<Lt::kLpk>(ch, r) << 4);
        cp_async16(sk + at, k + off, in);
        cp_async16(sv + at, v + off, in);
      }
    }
  };

  float m_r[Lt::kRowsPerWarp], l_r[Lt::kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < Lt::kRowsPerWarp; ++r) {
    m_r[r] = kNeg;
    l_r[r] = 0.f;
  }
  float acc[GM][Lt::kE];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < Lt::kE; ++e) acc[g][e] = 0.f;

#pragma unroll
  for (int s = 0; s < Lt::kStages - 1; ++s) {
    if (s < n_vis) load_tile(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < n_vis; ++it) {
    cp_async_wait<Lt::kStages - 2>();
    // Tile it is here for every thread, and every thread is done with the
    // stage that the next copy overwrites (tile it - 1's).
    __syncthreads();
    {
      const int nx = it + Lt::kStages - 1;
      if (nx < n_vis) load_tile(nx, nx % Lt::kStages);
      cp_async_commit();
    }
    const uint8_t* sk = smem + (it % Lt::kStages) * Lt::kStageBytes;
    const uint8_t* sv = sk + Lt::kTileBytes;
    const uint32_t word = mask_s[list_s[it]];

    // Logits: warp w takes keys 8 w .. 8 w + 7.
#pragma unroll
    for (int st = 0; st < Lt::kSteps; ++st) {
      const int j = warp * kKeysPerWarp + st * Lt::kKpw + kk;
      const uint8_t* row = sk + j * Lt::kRowBytes;
      float d[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) d[g] = 0.f;
#pragma unroll
      for (int i = 0; i < Lt::kCpl; ++i) {
        const int ch = c + Lt::kLpk * i;
        if (ch < nch) {
          float kf[Lt::kVec];
          unpack<T>(*reinterpret_cast<const uint4*>(row + (swizzle<Lt::kLpk>(ch, j) << 4)), kf);
#pragma unroll
          for (int g = 0; g < GM; ++g)
#pragma unroll
            for (int e = 0; e < Lt::kVec; ++e) d[g] = fmaf(qf[g][i * Lt::kVec + e], kf[e], d[g]);
        }
      }
#pragma unroll
      for (int off = Lt::kLpk / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < GM; ++g) d[g] += __shfl_xor_sync(kFull, d[g], off);
      if (c == 0) {
#pragma unroll
        for (int g = 0; g < GM; ++g) s_s[g * kBK + j] = d[g];
      }
    }
    __syncthreads();

    // Online softmax: warp w takes rows w, w + 4; lane = key.
#pragma unroll
    for (int r = 0; r < Lt::kRowsPerWarp; ++r) {
      const int g = warp + kWarps * r;
      if (g < GM) {
        float x = s_s[g * kBK + lane] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        x = (word >> lane) & 1u ? x : kNeg;
        const float m_new = fmaxf(m_r[r], warp_max(x));  // finite: the tile has a visible key
        const float corr = expf(m_r[r] - m_new);
        const float pr = expf(x - m_new);
        l_r[r] = l_r[r] * corr + warp_sum(pr);
        m_r[r] = m_new;
        p_s[lane * GM + g] = pr;
        if (lane == 0) corr_s[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc corr + p v over the warp's 8 keys.
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float corr = corr_s[g];
#pragma unroll
      for (int e = 0; e < Lt::kE; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int st = 0; st < Lt::kSteps; ++st) {
      const int j = warp * kKeysPerWarp + st * Lt::kKpw + kk;
      const uint8_t* row = sv + j * Lt::kRowBytes;
      float pj[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) pj[g] = p_s[j * GM + g];
#pragma unroll
      for (int i = 0; i < Lt::kCpl; ++i) {
        const int ch = c + Lt::kLpk * i;
        if (ch < nch) {
          float vf[Lt::kVec];
          unpack<T>(*reinterpret_cast<const uint4*>(row + (swizzle<Lt::kLpk>(ch, j) << 4)), vf);
#pragma unroll
          for (int g = 0; g < GM; ++g)
#pragma unroll
            for (int e = 0; e < Lt::kVec; ++e)
              acc[g][i * Lt::kVec + e] = fmaf(pj[g], vf[e], acc[g][i * Lt::kVec + e]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy may outlive the loop (n_vis < stages)
  __syncthreads();

  // Sum the accumulators over the warp's key subsets, then over the warps
  // (in shared memory, over the stages); m and l are the block's.
#pragma unroll
  for (int off = Lt::kLpk; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < Lt::kE; ++e) acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], off);
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][GM][HDP]
  if (kk == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int i = 0; i < Lt::kCpl; ++i) {
        const int ch = c + Lt::kLpk * i;
        if (ch < nch) {
#pragma unroll
          for (int e = 0; e < Lt::kVec; ++e)
            red[(warp * GM + g) * HDP + ch * Lt::kVec + e] = acc[g][i * Lt::kVec + e];
        }
      }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < Lt::kRowsPerWarp; ++r) {
      const int g = warp + kWarps * r;
      if (g < GM) {
        ml_s[g] = m_r[r];
        ml_s[GM + g] = l_r[r];
      }
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(p.o) + (size_t(bb) * p.h + head0) * hd;
  if (p.n_split == 1) {
    for (int g = 0; g < rows; ++g) {
      const bool seen = ml_s[g] > kNeg / 2;
      const float denom = fmaxf(ml_s[GM + g], 1e-30f);
      if (p.lse != nullptr && tid == 0)
        p.lse[size_t(bb) * p.h + head0 + g] = seen ? ml_s[g] + logf(ml_s[GM + g]) : kNeg;
      for (int d = tid; d < hd; d += kThreads) {
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) a += red[(w * GM + g) * HDP + d];
        out[g * hd + d] = from_float<T>(seen ? a / denom : 0.f);
      }
    }
    return;
  }

  // Several splits: this block's (m, l, acc), then the last block merges.
  const size_t n_rec = size_t(GM) * (2 + hd);
  const size_t at = size_t(bb) * gridDim.y + grp;
  const float* recs = p.ws + at * p.n_split * n_rec;
  float* rec = p.ws + (at * p.n_split + split) * n_rec;
  for (int g = 0; g < rows; ++g)
    for (int d = tid; d < hd; d += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += red[(w * GM + g) * HDP + d];
      rec[2 * GM + g * hd + d] = a;
    }
  if (tid < rows) {
    rec[tid] = ml_s[tid];
    rec[GM + tid] = ml_s[GM + tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) misc_s[1] = atomicAdd(p.counters + at, 1) == p.n_split - 1;
  __syncthreads();
  if (!misc_s[1]) return;
  __threadfence();
#pragma unroll
  for (int r = 0; r < Lt::kRowsPerWarp; ++r) {
    const int g = warp + kWarps * r;
    if (g < rows) {
      float mx = kNeg;
      for (int s = lane; s < p.n_split; s += 32) mx = fmaxf(mx, __ldcg(recs + s * n_rec + g));
      mx = warp_max(mx);
      float l = 0.f;
      for (int s = lane; s < p.n_split; s += 32)
        l += __ldcg(recs + s * n_rec + GM + g) * expf(__ldcg(recs + s * n_rec + g) - mx);
      l = warp_sum(l);
      if (lane == 0) {
        corr_s[g] = mx;
        p_s[g] = l;
      }
    }
  }
  __syncthreads();
  for (int g = 0; g < rows; ++g) {
    const float mx = corr_s[g];
    const float denom = fmaxf(p_s[g], 1e-30f);
    if (p.lse != nullptr && tid == 0)
      p.lse[size_t(bb) * p.h + head0 + g] = mx > kNeg / 2 ? mx + logf(p_s[g]) : kNeg;
    for (int d = tid; d < hd; d += kThreads) {
      float a = 0.f;
      for (int s = 0; s < p.n_split; ++s)
        a += __ldcg(recs + s * n_rec + 2 * GM + g * hd + d) * expf(__ldcg(recs + s * n_rec + g) - mx);
      out[g * hd + d] = from_float<T>(mx > kNeg / 2 ? a / denom : 0.f);
    }
  }
  if (tid == 0) p.counters[at] = 0;  // ready for the next launch
}

template <typename T, int HDP, int GM>
struct Inst {
  using Type = T;
  using Lt = Layout<T, HDP, GM>;
  static constexpr int kHdp = HDP;
  static constexpr int kGm = GM;
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
  err = cudaFuncSetAttribute(flash_decode_kernel<typename I::Type, I::kHdp, I::kGm>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, I::Lt::kSmem);
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

template <typename I>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const cudaError_t err = prepare<I>();
  if (err != cudaSuccess) return err;
  const dim3 grid(p.n_split, p.hkv * p.n_groups, p.b);
  flash_decode_kernel<typename I::Type, I::kHdp, I::kGm>
      <<<grid, kThreads, I::Lt::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HDP, typename F>
cudaError_t dispatch_rows(int rows, F&& f) {
  switch (rows) {
    case 1: return f(Inst<T, HDP, 1>{});
    case 2: return f(Inst<T, HDP, 2>{});
    case 4: return f(Inst<T, HDP, 4>{});
    default: return f(Inst<T, HDP, 8>{});
  }
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

bool valid_rows(int rows, int group) {
  return (rows == 1 || rows == 2 || rows == 4 || rows == 8) && (rows >= group || rows == 8);
}

}  // namespace

extern "C" {

int flash_decode_launch(const void* q, const void* k, const void* v, const int* q_pos,
                        const int* kv_pos, const unsigned char* kv_valid, void* o, float* lse,
                        float* ws,
                        int* counters, int b, int skv, int h, int hkv, int hd, int dtype, int rows,
                        int n_split, int split_tiles, float scale, int causal, int window,
                        int prefix_len, float softcap, void* stream) {
  cudaGetLastError();  // clear a stale, non-sticky error
  const auto misaligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16; };
  if (b <= 0 || b > 65535 || skv <= 0 || hkv <= 0 || h % hkv != 0 || hd <= 0 || hd > 256 ||
      hd % 8 != 0 || (dtype != 0 && dtype != 1) || misaligned(q) || misaligned(k) ||
      misaligned(v))
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = h / hkv;
  const int n_tiles = (skv + kBK - 1) / kBK;
  if (!valid_rows(rows, group) || split_tiles <= 0 || split_tiles > kMaxSplitTiles ||
      n_split <= 0 || (n_split - 1) * split_tiles >= n_tiles ||
      n_split * split_tiles < n_tiles || (n_split > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_groups = (group + rows - 1) / rows;
  if (hkv * n_groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,      k,     v,        q_pos,   kv_pos, kv_valid, o,      lse,    ws,
                 counters, b,   skv,      h,       hkv,    hd,       group,  n_groups,
                 n_split, split_tiles, scale, softcap, causal, window, prefix_len};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, hd, rows, [&](auto inst) {
    return launch<decltype(inst)>(p, s);
  }));
}

// Shared memory a block, stages and blocks per SM of the instance that takes
// (dtype, hd, rows), for reports.
int flash_decode_occupancy(int dtype, int hd, int rows, int* smem_bytes, int* stages,
                           int* blocks_per_sm) {
  if (hd <= 0 || hd > 256 || hd % 8 != 0 || (dtype != 0 && dtype != 1) ||
      !valid_rows(rows, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(dtype, hd, rows, [&](auto inst) {
    using I = decltype(inst);
    *smem_bytes = I::Lt::kSmem;
    *stages = I::Lt::kStages;
    const cudaError_t err = prepare<I>();
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, flash_decode_kernel<typename I::Type, I::kHdp, I::kGm>, kThreads,
        I::Lt::kSmem);
  }));
}

}  // extern "C"
