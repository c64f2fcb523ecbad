// Forward attention for bf16 prefill on Hopper: both products on wgmma
// tensor cores, k / v through a two-stage cp.async ring. CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py, body _fwd_kernel) for bf16
// calls with head dim 64 or 128 and at least 64 query rows; the kernel of
// flash_decode_sm90.cu takes decode (one query row) and that of
// flash_attention.cu the rest. All compute
// what ../ref.py and ../ops.py compute: grouped-query attention over
// absolute positions with causal, sliding-window and prefix-LM masks, a
// per-key validity mask and an optional tanh soft-cap; float32 m, l and
// accumulator; the finite -1e30 masking of flash_attention.cu, so that a
// row that never sees a key is written as exact 0.
//
// What bounds it on an H100: at the prefill shape (Sq = Skv = 2048,
// hd 128, causal) the 4 hd operations per visible (q, kv) pair at 989
// TFLOP/s bf16 on the tensor cores. So both products run as warpgroup MMAs
// (wgmma, bf16 in, float32 out) instead of float32 FMAs:
//   * one block of 256 threads (two warpgroups) per (128 query rows, q head,
//     batch row); warpgroup w owns rows 64 w .. 64 w + 63; keys come in
//     tiles of 64;
//   * q, k and v tiles stay bf16 in shared memory in the 128-byte swizzled
//     layout that wgmma reads: a row of hd values is cut into panels of 64
//     (128 bytes); chunk c (16 bytes) of row r lands at chunk c ^ (r % 8);
//   * S = Q K^T is wgmma m64n64k16 with both operands K-major in shared
//     memory; the softmax runs on the accumulator fragment in registers
//     (lane l of warp w holds rows 16 w + l / 4 and + 8, columns
//     8 j + 2 (l % 4) + {0, 1}; a row is reduced over its 4 lanes);
//   * O += P V is wgmma m64n{hd}k16 with A = P from registers (two adjacent
//     n8 blocks of the float32 fragment are one k16 step of the A fragment,
//     rounded to bf16) and B = V from shared memory, MN-major (transposed);
//   * before the kv loop the block decides from the positions which kv
//     tiles hold a visible (q, kv) entry and walks only that list (the Pallas
//     kernel's pl.when(any(mask))); exact: a key's visible query positions
//     form an interval, held against the rows' min and max and scanned only
//     where it cuts through them;
//   * tile j + 1 of the list is copied by 16-byte cp.async into the other
//     stage while the warpgroups compute tile j;
//   * a tile in which every row sees every key (all but the diagonal tiles
//     of a causal prefill) skips the per-entry mask;
//   * rows and keys past the end are zero-filled and masked by index.
// Shared memory at hd 128: q 32 KB + 2 x (k 16 KB + v 16 KB) + positions,
// about 99 KB; registers are capped at 128 a thread (a few spill), so two
// blocks share an SM and one's softmax overlaps the other's products.
//
// Interface: plain C. flash_attention_wgmma_launch returns the cudaError_t of
// the launch (0 on success). Pointers are device pointers to contiguous
// arrays, q, k, v 16-byte aligned: q, o (B, Sq, H, hd) and k, v
// (B, Skv, Hkv, hd) bfloat16; q_pos (B, Sq) and kv_pos (B, Skv) int32;
// kv_valid (B, Skv) bytes (0 = invalid) or null for all valid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 128;  // query rows per block, 64 per warpgroup
constexpr int kBK = 64;   // keys per tile
constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;
constexpr int kFull = 1 << 30;  // list entry flag: every row sees every key of the tile

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* q_pos;
  const int* kv_pos;
  const uint8_t* kv_valid;
  __nv_bfloat16* o;
  int b, sq, skv, h, hkv, hd;
  float scale, softcap;
  int causal, window, prefix_len;
};

// ---- PTX helpers -----------------------------------------------------------

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
// Generic-proxy writes to shared memory (cp.async, stores) become visible to
// the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units) and the
// layout type (1 = 128-byte swizzle) in bits 62-63. Tiles start on 1024-byte
// boundaries, so the base-offset field stays 0.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// ---- wgmma (m64nNk16, bf16 in, float32 accumulator) ----------------------------

// D (64 x 64, float32) (+)= A (64 x 16, shared) * B (64 x 16, shared)^T, both
// K-major; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, float32) += A (64 x 16, registers) * B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128, float32) += A (64 x 16, registers) * B (16 x 128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (HD == 64) wgmma_rs_n64(d, a, desc_b);
  else wgmma_rs_n128(d, a, desc_b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of 16-byte chunk c of row r in a swizzled tile of `rows` rows.
__device__ __forceinline__ uint32_t sw128_offset(int rows, int r, int c) {
  return uint32_t((c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ bool visible(const Params& p, int qp, int kp) {
  bool ok = p.causal ? kp <= qp : true;
  if (p.window > 0) ok = ok && (qp - kp < p.window);
  if (p.prefix_len > 0) ok = ok || (kp < p.prefix_len);
  return ok;
}

__host__ __device__ constexpr size_t tile_bytes(int rows, int hd) { return size_t(rows) * hd * 2; }

// Ints after the tiles: k positions and validity of both stages, q positions
// and validity, the rows' min / max position and the list length, the list.
constexpr int kIntsFixed = 2 * kBK + 2 * kBK + kBQ + kBQ + 4;

constexpr size_t smem_bytes(int hd, int n_tiles) {
  return 1024 + tile_bytes(kBQ, hd) + 4 * tile_bytes(kBK, hd) +
         sizeof(int) * (size_t(kIntsFixed) + n_tiles);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_sm90_kernel(Params p) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  constexpr uint32_t kQBytes = tile_bytes(kBQ, HD);
  constexpr uint32_t kKBytes = tile_bytes(kBK, HD);

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* smem = smem_raw + pad;
  const uint32_t s_q = raw + pad;
  const uint32_t s_k = s_q + kQBytes;        // 2 stages
  const uint32_t s_v = s_k + 2 * kKBytes;    // 2 stages
  int* kpos_s = reinterpret_cast<int*>(smem + kQBytes + 4 * kKBytes);  // [2][kBK]
  int* kok_s = kpos_s + 2 * kBK;                                        // [2][kBK]
  int* qpos_s = kok_s + 2 * kBK;                                        // [kBQ]
  int* qok_s = qpos_s + kBQ;                                            // [kBQ]
  int* misc = qok_s + kBQ;                  // qmin, qmax, list length
  int* tiles = misc + 4;                    // flags, then the list of visible tiles

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // the longest causal rows first
  const int head = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = head / (p.h / p.hkv);
  const int n_tiles = (p.skv + kBK - 1) / kBK;
  const size_t q_row = size_t(p.h) * HD;     // elements between rows of q / o
  const size_t kv_row = size_t(p.hkv) * HD;  // and of k / v

  // ---- q tile (asynchronous) and the rows' positions ------------------------
  {
    const __nv_bfloat16* qb = p.q + (size_t(bb) * p.sq * p.h + head) * HD;
    for (int e = tid; e < kBQ * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int c = e - r * kChunks;
      const bool in = q0 + r < p.sq;
      cp_async16(s_q + sw128_offset(kBQ, r, c), in ? qb + (q0 + r) * q_row + c * 8 : p.q, in);
    }
    cp_async_commit();
  }
  if (tid == 0) {
    misc[0] = INT_MAX;
    misc[1] = INT_MIN;
  }
  if (tid < kBQ) {
    const bool in = q0 + tid < p.sq;
    qpos_s[tid] = in ? p.q_pos[size_t(bb) * p.sq + q0 + tid] : 0;
    qok_s[tid] = in;
  }
  for (int i = tid; i < n_tiles; i += kThreads) tiles[i] = 0;
  __syncthreads();
  if (tid < kBQ && qok_s[tid]) {
    atomicMin(&misc[0], qpos_s[tid]);
    atomicMax(&misc[1], qpos_s[tid]);
  }
  __syncthreads();

  // ---- which kv tiles hold a visible entry, and which hold nothing else ----
  // Flag bit 0: a key of the tile is seen by a row; bit 1: a key is not seen
  // by every row (or lies past the end), so the tile needs its mask.
  {
    const long long qmin = misc[0], qmax = misc[1];  // the block holds >= 1 row
    for (int t0 = 0; t0 < n_tiles; t0 += kThreads / kBK) {
      const int tile = t0 + tid / kBK;
      const int kj = tile * kBK + (tid % kBK);
      bool seen = false, by_all = false;
      if (tile < n_tiles && kj < p.skv) {
        const size_t at = size_t(bb) * p.skv + kj;
        const long long kp = p.kv_pos[at];
        if (p.kv_valid == nullptr || p.kv_valid[at] != 0) {
          if (p.prefix_len > 0 && kp < p.prefix_len) {
            seen = by_all = true;
          } else {
            // The query positions that see kp: [lo, hi].
            const long long lo = p.causal ? kp : LLONG_MIN;
            const long long hi = p.window > 0 ? kp + p.window - 1 : LLONG_MAX;
            if (lo <= qmin && hi >= qmax) {
              seen = by_all = true;
            } else if (hi >= qmin && lo <= qmax) {
              for (int r = 0; r < kBQ && !seen; ++r)
                seen = qok_s[r] && qpos_s[r] >= lo && qpos_s[r] <= hi;
            }
          }
        }
      }
      // A warp's 32 keys lie in one tile.
      const int flag = (__any_sync(0xffffffffu, seen) ? 1 : 0) |
                       (__all_sync(0xffffffffu, by_all) ? 0 : 2);
      if (lane == 0 && tile < n_tiles) atomicOr(&tiles[tile], flag);
    }
  }
  __syncthreads();
  if (warp == 0) {  // compact into the list, in place: tile | kFull when unmasked
    int count = 0;
    for (int base = 0; base < n_tiles; base += 32) {
      const int i = base + lane;
      const int flag = i < n_tiles ? tiles[i] : 0;
      const unsigned ball = __ballot_sync(0xffffffffu, flag & 1);
      if (flag & 1) tiles[count + __popc(ball & ((1u << lane) - 1))] = i | (flag & 2 ? 0 : kFull);
      count += __popc(ball);
    }
    if (lane == 0) misc[2] = count;
  }
  __syncthreads();
  const int n_vis = misc[2];

  // ---- per thread: its two rows ---------------------------------------------
  const int wg = tid >> 7;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r_lo = wg * 64 + (warp & 3) * 16 + g;
  const int r_hi = r_lo + 8;
  const int qp_lo = qpos_s[r_lo], qp_hi = qpos_s[r_hi];
  const bool ok_lo = qok_s[r_lo] != 0, ok_hi = qok_s[r_hi] != 0;
  float m_lo = kNeg, m_hi = kNeg, l_lo = 0.f, l_hi = 0.f;  // l: this thread's columns
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  const __nv_bfloat16* kbase = p.k + (size_t(bb) * p.skv * p.hkv + kvh) * HD;
  const __nv_bfloat16* vbase = p.v + (size_t(bb) * p.skv * p.hkv + kvh) * HD;
  // Copies tile `tile`'s keys and values into `stage` (asynchronous) and
  // reads its positions into (kp, kok) for threads < kBK.
  auto issue = [&](int entry, int stage, int& kp, int& kok) {
    const int k0 = (entry & ~kFull) * kBK;
    for (int e = tid; e < kBK * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int c = e - r * kChunks;
      const bool in = k0 + r < p.skv;
      const size_t off = size_t(k0 + r) * kv_row + c * 8;
      const uint32_t at = sw128_offset(kBK, r, c) + stage * kKBytes;
      cp_async16(s_k + at, in ? kbase + off : p.k, in);
      cp_async16(s_v + at, in ? vbase + off : p.v, in);
    }
    if (tid < kBK) {
      const int kj = k0 + tid;
      const size_t at = size_t(bb) * p.skv + kj;
      const bool in = kj < p.skv;
      kp = in ? p.kv_pos[at] : 0;
      kok = in && (p.kv_valid == nullptr || p.kv_valid[at] != 0);
    }
  };

  int nkp = 0, nkok = 0;
  if (n_vis > 0) {
    issue(tiles[0], 0, nkp, nkok);
    if (tid < kBK) {
      kpos_s[tid] = nkp;
      kok_s[tid] = nkok;
    }
  }
  cp_async_commit();

  for (int j = 0; j < n_vis; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_vis) issue(tiles[j + 1], stage ^ 1, nkp, nkok);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: q and tile j are here
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T for this warpgroup's 64 rows and the tile's 64 keys.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t kofs = (kk & 3) * 32;  // k16 step within a 64-wide panel
      const uint64_t da = sw128_desc(s_q + (kk >> 2) * (kBQ * 128) + wg * (64 * 128) + kofs,
                                     16, 1024);
      const uint64_t db = sw128_desc(s_k + stage * kKBytes + (kk >> 2) * (kBK * 128) + kofs,
                                     16, 1024);
      wgmma_ss_n64(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // Online softmax on the fragment, in log2 units (logits times log2 e):
    // element i is row lo when (i & 2) == 0, column 8 (i / 4) + 2 t4 + (i & 1).
    // Rows past the end are never written, so an unmasked tile skips them.
    float mx_lo = kNeg, mx_hi = kNeg;
    if (tiles[j] & kFull) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = s[i] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        s[i] = x * kLog2e;
        if (i & 2) mx_hi = fmaxf(mx_hi, s[i]);
        else mx_lo = fmaxf(mx_lo, s[i]);
      }
    } else {
      const int* kp_s = kpos_s + stage * kBK;
      const int* ko_s = kok_s + stage * kBK;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i >> 2) + 2 * t4 + (i & 1);
        const bool hi = i & 2;
        float x = s[i] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        const bool vis =
            ko_s[col] && (hi ? ok_hi : ok_lo) && visible(p, hi ? qp_hi : qp_lo, kp_s[col]);
        s[i] = vis ? x * kLog2e : kNeg;
        if (hi) mx_hi = fmaxf(mx_hi, s[i]);
        else mx_lo = fmaxf(mx_lo, s[i]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float c_lo = exp2f(m_lo - mn_lo), c_hi = exp2f(m_hi - mn_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi = i & 2;
      s[i] = exp2f(s[i] - (hi ? mn_hi : mn_lo));
      if (hi) sum_hi += s[i];
      else sum_lo += s[i];
    }
    l_lo = l_lo * c_lo + sum_lo;
    l_hi = l_hi * c_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= (i & 2) ? c_hi : c_lo;

    // O += P V: k16 step kk takes the fragment's columns 16 kk .. 16 kk + 15.
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<HD>(o, a[kk], sw128_desc(s_v + stage * kKBytes + kk * (16 * 128), kBK * 128, 1024));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);

    if (j + 1 < n_vis && tid < kBK) {
      kpos_s[(stage ^ 1) * kBK + tid] = nkp;
      kok_s[(stage ^ 1) * kBK + tid] = nkok;
    }
    __syncthreads();  // every warpgroup is done with this stage
  }
  cp_async_wait<0>();  // no copy may outlive the block (n_vis == 0)

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = m_lo > kNeg / 2 ? 1.f / fmaxf(l_lo, 1e-30f) : 0.f;
  const float inv_hi = m_hi > kNeg / 2 ? 1.f / fmaxf(l_hi, 1e-30f) : 0.f;
  __nv_bfloat16* ob = p.o + (size_t(bb) * p.sq * p.h + head) * HD + 2 * t4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + (half ? r_hi : r_lo);
    if (qi >= p.sq) continue;
    const float inv = half ? inv_hi : inv_lo;
    __nv_bfloat16* out = ob + qi * q_row;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const __nv_bfloat162 v2 =
          __floats2bfloat162_rn(o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = v2;
    }
  }
}

template <int HD>
cudaError_t prepare(int skv, size_t* bytes) {
  *bytes = smem_bytes(HD, (skv + kBK - 1) / kBK);
  if (*bytes > size_t(kMaxSmem)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(flash_fwd_sm90_kernel<HD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  size_t bytes = 0;
  const cudaError_t err = prepare<HD>(p.skv, &bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.h, p.b);
  flash_fwd_sm90_kernel<HD><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, const int* q_pos,
                                 const int* kv_pos, const unsigned char* kv_valid, void* o,
                                 int b, int sq, int skv, int h, int hkv, int hd, float scale,
                                 int causal, int window, int prefix_len, float softcap,
                                 void* stream) {
  cudaGetLastError();  // clear a stale, non-sticky error
  const auto misaligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16; };
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || h % hkv != 0 || (hd != 64 && hd != 128) ||
      h > 65535 || b > 65535 || misaligned(q) || misaligned(k) || misaligned(v) || misaligned(o))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
           static_cast<const __nv_bfloat16*>(v), q_pos, kv_pos, kv_valid,
           static_cast<__nv_bfloat16*>(o), b, sq, skv, h, hkv, hd, scale, softcap, causal,
           window, prefix_len};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(hd == 64 ? launch<64>(p, s) : launch<128>(p, s));
}

// Shared memory per block and blocks per SM of the kernel at (hd, skv), for
// reports.
int flash_attention_wgmma_occupancy(int hd, int skv, int* smem_bytes_out, int* blocks_per_sm) {
  if ((hd != 64 && hd != 128) || skv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  size_t bytes = 0;
  cudaError_t err = hd == 64 ? prepare<64>(skv, &bytes) : prepare<128>(skv, &bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm,
        hd == 64 ? flash_fwd_sm90_kernel<64> : flash_fwd_sm90_kernel<128>,
        kThreads, bytes);
  *smem_bytes_out = static_cast<int>(bytes);
  return static_cast<int>(err);
}

}  // extern "C"
