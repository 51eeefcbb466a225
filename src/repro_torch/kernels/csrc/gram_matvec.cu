// Hopper (sm_90a) CUDA kernels for the paper's per-task computation
// h(X) = X (X^T theta), batched over tasks: Xs (n, d, b) -> (n, d).
//
// Replaces the Pallas TPU kernel gram_matvec_pallas (_xt_theta_kernel and
// _x_u_kernel) in src/repro/kernels/gram_matvec.py.  The TPU version walks
// (d, b) tiles on a sequential grid and accumulates across grid steps in
// VMEM; here the two passes are two launches, each block owns whole output
// elements and loops over the reduction axis itself, so no sums are carried
// between blocks and no atomics are needed: results are deterministic.
//
//   pass 1  u[t, j] = sum_i X[t, i, j] theta[i]   one block per (b-tile, t);
//           threadIdx.x runs along the contiguous b axis (coalesced rows),
//           threadIdx.y splits d into kRowGroups phases reduced in shared
//           memory in a fixed order.
//   pass 2  y[t, i] = sum_j X[t, i, j] u[t, j]    one warp per row i, lanes
//           stride along b, then a butterfly shuffle reduction.
//
// Accumulation is float32; inputs are float32 or bfloat16 (read through
// __bfloat162float), the output has X's dtype, u is float32 scratch that the
// caller allocates.
//
// What bounds it on an H100: memory.  Both passes do 2 flops per element of
// X, so the arithmetic intensity is about 1 flop/byte in float32, far below
// the card's ridge; the least it must move is one read of X,
// n*d*b*itemsize bytes.  This design reads X twice (once per pass), so it
// can reach at best half of the HBM roofline; a one-pass version that keeps a
// task's X tile in shared memory (96 KB at the paper's d=400, b=60) is the
// next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstddef>

namespace {

constexpr int kCols = 32;        // pass 1: b columns per block (one warp wide)
constexpr int kRowGroups = 8;    // pass 1: d phases per block
constexpr int kRowsPerBlock = 8; // pass 2: rows (warps) per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void xt_theta_kernel(const T* __restrict__ X, const T* __restrict__ theta,
                                float* __restrict__ u, int d, int b) {
  __shared__ float part[kRowGroups][kCols];
  const int t = blockIdx.y;
  const int j = blockIdx.x * kCols + threadIdx.x;
  float acc = 0.f;
  if (j < b) {
    const T* Xt = X + static_cast<size_t>(t) * d * b;
    for (int i = threadIdx.y; i < d; i += kRowGroups)
      acc += to_f32(Xt[static_cast<size_t>(i) * b + j]) * to_f32(theta[i]);
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < b) {
    float s = 0.f;
    for (int g = 0; g < kRowGroups; ++g) s += part[g][threadIdx.x];
    u[static_cast<size_t>(t) * b + j] = s;
  }
}

template <typename T>
__global__ void x_u_kernel(const T* __restrict__ X, const float* __restrict__ u,
                           T* __restrict__ y, int d, int b) {
  const int t = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (i >= d) return;  // the whole warp shares i, so it leaves together
  const T* row = X + (static_cast<size_t>(t) * d + i) * b;
  const float* ut = u + static_cast<size_t>(t) * b;
  float acc = 0.f;
  for (int j = lane; j < b; j += 32) acc += to_f32(row[j]) * ut[j];
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) store(&y[static_cast<size_t>(t) * d + i], acc);
}

template <typename T>
int launch(const void* X, const void* theta, void* u, void* y, int n, int d, int b,
           cudaStream_t stream) {
  const dim3 grid1((b + kCols - 1) / kCols, n), block1(kCols, kRowGroups);
  xt_theta_kernel<T><<<grid1, block1, 0, stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(theta), static_cast<float*>(u), d, b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((d + kRowsPerBlock - 1) / kRowsPerBlock, n), block2(32 * kRowsPerBlock);
  x_u_kernel<T><<<grid2, block2, 0, stream>>>(
      static_cast<const T*>(X), static_cast<const float*>(u), static_cast<T*>(y), d, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int gram_matvec_launch(const void* X, const void* theta, void* u, void* y,
                                  int n, int d, int b, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(X, theta, u, y, n, d, b, s);
  if (dtype == 1) return launch<__nv_bfloat16>(X, theta, u, y, n, d, b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* gram_matvec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
