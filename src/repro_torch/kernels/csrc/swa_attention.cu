// Hopper (sm_90a) CUDA kernel for causal sliding-window attention with
// grouped KV heads: q (B, T, H, dh), k/v (B, T, K, dh) -> o (B, T, H, dh).
// Query position t attends to the keys s with t - W < s <= t; query head h
// reads KV head h / (H / K), repeat_kv's mapping, without materialising
// the repeat.
//
// Replaces the Pallas TPU kernel swa_attention_pallas (_swa_kernel) in
// src/repro/kernels/swa_attention.py.  The TPU grid (H, nq, nkv_vis) walks
// the visible KV tiles as a sequential grid axis, clamps the tile index
// below zero and masks the duplicate tile it then visits; the online-
// softmax state (m, l, acc) lives in VMEM scratch across those grid steps.
// Here one block owns one (b, h, 64-row query tile) and loops itself over
// exactly the KV tiles its rows can see, from max(0, q0 - W + 1) / 64 to the
// tile of its last row, so nothing is visited twice and no state crosses
// blocks; m, l and acc stay in registers for the whole loop.
//
//   block    256 threads as a 16 x 16 grid (ty, tx); thread (ty, tx) owns
//            query rows ty + 16 i (i < 4), score columns tx + 16 j (j < 4)
//            and output columns tx + 16 c (c < dh / 16).
//   shared   the Q tile and one K and one V tile, float32 with rows padded
//            by one word (conflict-free column reads), and the tile's
//            probabilities P (64 x 64, rows padded too):
//            (3 * 64 * (dh + 1) + 64 * 65) * 4 bytes, 214 016 at dh = 256
//            (dynamic, above the 48 KB default).
//   per tile S = Q K^T * (1 / sqrt(dh)) in float32; masked entries are -1e30
//            and contribute exactly 0; row maxima and sums by a 16-lane
//            shuffle; acc = acc * exp(m_old - m_new) + P V.
//   epilogue o = acc / max(l, 1e-30), cast to the input type.
//
// Inputs are float32 or bfloat16 (read with __bfloat162float, written with
// __float2bfloat16); all arithmetic is float32 FMAs on the CUDA cores: no
// tensor cores and no TF32.
//
// What bounds it on an H100: operations.  Each visible (q, k) pair costs
// 4 * dh flops (QK^T and PV), against reading q, k, v and writing o once;
// at gemma3's prefill (T 2048, W 1024, dh 256) that is ~500 flops per byte,
// above the bf16 ridge.  This design runs those flops on the CUDA cores out
// of shared memory (scalar loads, one block per SM at dh = 256), so it is
// far from the tensor-core bound; wgmma tiles fed by TMA are the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstddef>

namespace {

constexpr int kBq = 64;        // query rows per block
constexpr int kBk = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = kBq / 16;
constexpr int kCols = kBk / 16;
constexpr int kPs = kBk + 1;   // padded row of P
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

constexpr size_t smem_bytes(int dh) {
  return (3 * static_cast<size_t>(kBq) * (dh + 1) + kBq * kPs) * sizeof(float);
}

// Stage rows [p0, p0 + 64) of head `head` of x (B, T, nh, DH) into a padded
// float32 tile; rows at or past T are zero.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ x, int b,
                                          int p0, int head, int seq, int nh) {
  for (int e = threadIdx.x; e < kBq * DH; e += kThreads) {
    const int r = e / DH, d = e % DH, p = p0 + r;
    float v = 0.f;
    if (p < seq) v = to_f32(x[((static_cast<size_t>(b) * seq + p) * nh + head) * DH + d]);
    tile[r * (DH + 1) + d] = v;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
swa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, int seq, int H, int K, int window) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBq * (DH + 1);
  float* vs = ks + kBk * (DH + 1);
  float* ps = vs + kBk * (DH + 1);

  const int q0 = blockIdx.x * kBq, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / K);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float scale = rsqrtf(static_cast<float>(DH));
  const int w = window < seq ? window : seq;  // W >= T is plain causal

  load_tile<T, DH>(qs, q, b, q0, h, seq, H);

  float m[kRows], l[kRows], acc[kRows][DH / 16];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + kBq, seq) - 1;
  const int kt_lo = max(0, q0 - w + 1) / kBk, kt_hi = q_last / kBk;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBk;
    __syncthreads();  // the previous tile's P V is done with ks/vs/ps
    load_tile<T, DH>(ks, k, b, k0, kvh, seq, K);
    load_tile<T, DH>(vs, v, b, k0, kvh, seq, K);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + 16 * i) * (DH + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos <= qpos && kpos > qpos - w && kpos < seq;
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are lanes tx = 0..15 of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * kPs + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DH / 16; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBk; ++j) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + 16 * i) * kPs + j];
#pragma unroll
      for (int c = 0; c < DH / 16; ++c) {
        const float vv = vs[j * (DH + 1) + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= seq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* out = o + ((static_cast<size_t>(b) * seq + qpos) * H + h) * DH;
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) store(&out[tx + 16 * c], acc[i][c] * inv);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int seq, int H,
           int K, int window, cudaStream_t stream) {
  const size_t bytes = smem_bytes(DH);
  cudaError_t err = cudaFuncSetAttribute(swa_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kBq - 1) / kBq, H, B);
  swa_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), seq, H, K, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int seq, int H,
             int K, int dh, int window, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, o, B, seq, H, K, window, s);
    case 32: return launch<T, 32>(q, k, v, o, B, seq, H, K, window, s);
    case 64: return launch<T, 64>(q, k, v, o, B, seq, H, K, window, s);
    case 128: return launch<T, 128>(q, k, v, o, B, seq, H, K, window, s);
    case 256: return launch<T, 256>(q, k, v, o, B, seq, H, K, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  dtype: 0 = float32, 1 = bfloat16;
// dh in {16, 32, 64, 128, 256}; H % K == 0; window >= 1.  Returns the
// cudaError_t of the attribute call and the launch (0 on success).
extern "C" int swa_attention_launch(const void* q, const void* k, const void* v, void* o,
                                    int B, int seq, int H, int K, int dh, int window,
                                    int dtype, void* stream) {
  if (B < 1 || seq < 1 || H < 1 || K < 1 || H % K != 0 || window < 1 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, o, B, seq, H, K, dh, window, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, o, B, seq, H, K, dh, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* swa_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
