// Forward attention with an online softmax, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py, body _fwd_kernel) and
// computes what the plain versions in ../ref.py and ../ops.py compute:
// grouped-query attention over absolute positions with causal, sliding-window
// and prefix-LM masks, a per-key validity mask (decode caches) and an
// optional tanh soft-cap of the logits; float32 softmax state and sums.
//
// What bounds it on an H100: at the prefill shapes (Sq = Skv = 2048,
// hd = 128) the 4 hd operations per visible (q, kv) pair, which the card
// could do on its tensor cores at 989 TFLOP/s in bf16. This first kernel
// runs them on the float32 cores instead (67 TFLOP/s), so it cannot come
// near that bound; it is the simple, exact design that a later kernel
// (wgmma, TMA, warp specialisation) is measured against. Decode (Sq = 1)
// takes flash_decode_sm90.cu, bf16 prefill at hd 64 / 128
// flash_attention_sm90.cu; this kernel keeps float32 prefill, hd 80 and 256
// prefill and decode at a head dim that is not a multiple of 8.
//
// Design. One thread block of 256 threads per (q tile of 64 rows, q head,
// batch row). The q tile stays in shared memory; the block streams the
// kv head h / group in tiles of 64 keys:
//   * the tile's positions and validity are read first; a tile in which no
//     (q, kv) entry is visible is skipped whole, before its keys and values
//     are loaded (the Pallas kernel's pl.when(any(mask)));
//   * each thread owns a 4 x 4 block of the 64 x 64 logits (rows ty + 16 i,
//     columns tx + 16 j) and, for the same 4 rows, the columns tx + 16 j of
//     the output accumulator; rows are reduced with warp shuffles over the
//     16 lanes that share them;
//   * masked logits take the finite value -1e30, as in the reference: a row
//     with no visible key yet takes p = exp(0) = 1 for them, and the factor
//     exp(-1e30 - m) = 0 erases that once a visible key arrives; a row that
//     never sees one ends with m <= -5e29 and is written as 0. (-inf would
//     give -inf - -inf = NaN.)
//   * q, k and v are converted to float32 when they are staged in shared
//     memory; the output is rounded once to the input type.
// Shared memory: the q and k tiles with a padded row stride (hd_max + 1
// floats, so that the 16 lanes reading 16 key rows hit 16 banks), the v
// tile, and the 64 x 65 probabilities, which reuse the k tile's space.
// About 99 KB at hd <= 128, so two blocks fit on an SM.
//
// Interface: plain C. flash_attention_launch returns the cudaError_t of the
// launch (0 on success). Pointers are device pointers to contiguous arrays:
// q, o (B, Sq, H, hd) and k, v (B, Skv, Hkv, hd) of one type (dtype 0 =
// float32, 1 = bfloat16); q_pos (B, Sq) and kv_pos (B, Skv) int32;
// kv_valid (B, Skv) bytes (0 = invalid) or null for all valid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per streamed tile
constexpr int kThreads = 256;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* kv_pos;
  const uint8_t* kv_valid;
  void* o;
  int b, sq, skv, h, hkv, hd;
  float scale, softcap;
  int causal, window, prefix_len;
};

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

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Floats of the region that holds the k tile, then the probabilities.
__host__ __device__ constexpr int k_region(int hd_max) {
  return kBK * (hd_max + 1) > kBQ * (kBK + 1) ? kBK * (hd_max + 1) : kBQ * (kBK + 1);
}

constexpr size_t smem_bytes(int hd_max) {
  return sizeof(float) * (size_t(kBQ) * (hd_max + 1) + k_region(hd_max) +
                          size_t(kBK) * hd_max) +
         sizeof(int) * (kBQ + 2 * kBK);
}

template <typename T, int HD_MAX>
__global__ void __launch_bounds__(kThreads, HD_MAX <= 128 ? 2 : 1)
    flash_fwd_kernel(Params p) {
  constexpr int kStride = HD_MAX + 1;  // padded row stride of the q and k tiles
  constexpr int kCols = HD_MAX / 16;   // accumulator columns per thread
  constexpr int kPStride = kBK + 1;    // row stride of the probabilities

  extern __shared__ float smem[];
  float* qs = smem;                    // kBQ x kStride
  float* ks = qs + kBQ * kStride;      // kBK x kStride, then kBQ x kPStride probs
  float* vs = ks + k_region(HD_MAX);   // kBK x HD_MAX
  int* qpos_s = reinterpret_cast<int*>(vs + kBK * HD_MAX);  // kBQ
  int* kpos_s = qpos_s + kBQ;                                // kBK
  int* kok_s = kpos_s + kBK;                                 // kBK

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int bb = blockIdx.z;
  const int hd = p.hd;
  const int kvh = head / (p.h / p.hkv);
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);

  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int r = e / hd;
    const int d = e - r * hd;
    const int qi = q0 + r;
    float val = 0.f;
    if (qi < p.sq) val = to_float(q[((size_t(bb) * p.sq + qi) * p.h + head) * hd + d]);
    qs[r * kStride + d] = val;
  }
  if (tid < kBQ) {
    const int qi = q0 + tid;
    qpos_s[tid] = qi < p.sq ? p.q_pos[size_t(bb) * p.sq + qi] : 0;
  }
  __syncthreads();

  int rpos[4];
  bool rvalid[4];
  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    rpos[i] = qpos_s[r];
    rvalid[i] = q0 + r < p.sq;
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < p.skv; k0 += kBK) {
    if (tid < kBK) {
      const int kj = k0 + tid;
      const bool in = kj < p.skv;
      const size_t at = size_t(bb) * p.skv + kj;
      kpos_s[tid] = in ? p.kv_pos[at] : 0;
      kok_s[tid] = in && (p.kv_valid == nullptr || p.kv_valid[at] != 0);
    }
    __syncthreads();

    bool vis[4][4];
    int any = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int qp = rpos[i];
        const int kp = kpos_s[c];
        bool ok = p.causal ? kp <= qp : true;
        if (p.window > 0) ok = ok && (qp - kp < p.window);
        if (p.prefix_len > 0) ok = ok || (kp < p.prefix_len);
        ok = ok && kok_s[c] && rvalid[i];
        vis[i][j] = ok;
        any |= ok;
      }
    }
    // Also the barrier after which kpos_s may be overwritten.
    if (!__syncthreads_or(any)) continue;

    for (int e = tid; e < kBK * hd; e += kThreads) {
      const int c = e / hd;
      const int d = e - c * hd;
      const int kj = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (kj < p.skv) {
        const size_t off = ((size_t(bb) * p.skv + kj) * p.hkv + kvh) * hd + d;
        kv = to_float(k[off]);
        vv = to_float(v[off]);
      }
      ks[c * kStride + d] = kv;
      vs[c * HD_MAX + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * kStride + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * kStride + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * b[j];
    }
    __syncthreads();  // every thread is done with ks: it now holds the probabilities

    float* ps = ks;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        s[i][j] = vis[i][j] ? x : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = pv;
        rs += pv;
      }
      l[i] = l[i] * corr + row_sum16(rs);
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        if (tx + 16 * cc < hd) {
          const float vv = vs[c * HD_MAX + tx + 16 * cc];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][cc] += pr[i] * vv;
        }
      }
    }
    __syncthreads();  // before the next tile overwrites ks, vs and kpos_s
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.sq) continue;
    const bool seen = m[i] > kNeg / 2;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + ((size_t(bb) * p.sq + qi) * p.h + head) * hd;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int d = tx + 16 * cc;
      if (d < hd) out[d] = from_float<T>(seen ? acc[i][cc] / denom : 0.f);
    }
  }
}

template <typename T, int HD_MAX>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_bytes(HD_MAX);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD_MAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.h, p.b);
  flash_fwd_kernel<T, HD_MAX><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Params& p, cudaStream_t stream) {
  if (p.hd <= 32) return launch<T, 32>(p, stream);
  if (p.hd <= 64) return launch<T, 64>(p, stream);
  if (p.hd <= 128) return launch<T, 128>(p, stream);
  return launch<T, 256>(p, stream);
}

}  // namespace

extern "C" {

int flash_attention_launch(const void* q, const void* k, const void* v, const int* q_pos,
                           const int* kv_pos, const unsigned char* kv_valid, void* o, int b,
                           int sq, int skv, int h, int hkv, int hd, int dtype, float scale,
                           int causal, int window, int prefix_len, float softcap,
                           void* stream) {
  cudaGetLastError();  // clear a stale, non-sticky error
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || h % hkv != 0 || hd <= 0 || hd > 256 ||
      h > 65535 || b > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,  k,  v,   q_pos, kv_pos, kv_valid, o,      b,      sq,         skv,
           h,  hkv, hd, scale, softcap, causal,  window, prefix_len};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_hd<float>(p, s) : launch_hd<__nv_bfloat16>(p, s);
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
