// Hopper (sm_90a) CUDA kernel for the adaptive schedule's greedy row
// assignment, batched over Monte-Carlo trials: per trial, n sequential
// picks, fastest worker first, each taking the untaken row of the TO matrix
// whose discounted task coverage is least.
//
// Replaces the Pallas TPU kernel greedy_assign_pallas (_greedy_kernel) in
// src/repro/kernels/greedy_assign.py:73.  The TPU version runs a (128, n)
// trial block through n dense cov @ W^T products on the MXU, with the trial
// grid edge-padded.  Here one warp owns one trial and kWarps trials share a
// block; nothing is padded (a warp past the last trial leaves).
//
//   W (n, n) float32 is loaded once per block into shared memory,
//   transposed (WT[j * n + p] = W[p, j]) so the lanes of a warp, which
//   stride over rows p, read neighbouring words.  Each warp keeps its
//   trial's coverage cov (n floats) in shared memory and its taken flags in
//   registers (lane p % 32 owns row p).  Per pick t:
//     1. lanes compute the scores of their rows, a left fold over j of
//        __fmul_rn(cov[j], W[p, j]) added with __fadd_rn, taken rows at
//        FLT_MAX;
//     2. with reissue priorities, a warp min over the untaken needed rows
//        decides whether the argmin is restricted to them;
//     3. a warp-shuffle argmin on the pair (score, row) picks row p,
//        lowest row on ties (NaN counts as smallest, as torch.argmin and
//        jnp.argmin treat it);
//     4. worker_of_row[p] = order[t], and lanes stride over tasks j to add
//        __fdiv_rn(W[p, j], epick[t]) to cov[j];
//   with __syncwarp() between the phases that share cov.
//
// Rounding: the plain version (kernels/ref.py greedy_assign_ref) uses the
// same fold in the same order, each product and sum rounded once, and a
// true division: the explicit _rn intrinsics keep nvcc from contracting
// them into FMAs or a reciprocal multiply, so kernel and plain version
// agree bit for bit on every input, ties included.
//
// Largest n: kMaxN = 128 (n^2 * 4 = 64 KB of W in shared memory, above the
// 48 KB default, so the launch raises the block's dynamic shared memory
// limit); every configuration in the repository has n <= 16.
//
// What bounds it on an H100: neither bytes nor operations.  The least it
// must move is B*n*16 bytes (order, epick, need_row in, worker_of_row out)
// plus n^2 * 4 for W, over 3.35 TB/s; it does about 2*B*n*nnz(W) flops
// (every row's score per pick).  Both are microseconds at the main path's
// shapes.  The kernel sits far above that bound by design: the n picks of
// a trial depend on one another, and each pick is a warp reduction plus
// shared-memory round trips, so a trial's time is n dependent latency
// chains; the card is filled only by running many trials side by side.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstddef>

namespace {

constexpr int kWarps = 8;              // trials per block
constexpr int kMaxN = 128;             // largest n the kernel takes
constexpr int kRowsPerLane = kMaxN / 32;

__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (!na && a != b) return a < b;
  return ia < ib;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  if (isnan(a) || isnan(b)) return __int_as_float(0x7fc00000);
  return a < b ? a : b;
}

__global__ void greedy_assign_kernel(const float* __restrict__ W,
                                     const int* __restrict__ order,
                                     const float* __restrict__ epick,
                                     const float* __restrict__ need_row,
                                     int* __restrict__ out, int B, int n) {
  extern __shared__ float smem[];
  float* WT = smem;                      // n * n, transposed
  float* cov_all = smem + n * n;         // kWarps * n
  for (int i = threadIdx.x; i < n * n; i += blockDim.x)
    WT[(i % n) * n + i / n] = W[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int trial = blockIdx.x * kWarps + warp;
  if (trial >= B) return;                // whole warp leaves together
  float* cov = cov_all + warp * n;
  const size_t base = static_cast<size_t>(trial) * n;
  const int* ord = order + base;
  const float* ep = epick + base;
  const float* nd = need_row == nullptr ? nullptr : need_row + base;
  int* wout = out + base;

  bool taken[kRowsPerLane];
  bool needed[kRowsPerLane];
#pragma unroll
  for (int q = 0; q < kRowsPerLane; ++q) {
    const int p = lane + 32 * q;
    taken[q] = false;
    needed[q] = p < n && nd != nullptr && nd[p] > 0.f;
  }
  for (int p = lane; p < n; p += 32) {
    cov[p] = 0.f;
    wout[p] = 0;
  }
  __syncwarp();

  for (int t = 0; t < n; ++t) {
    float score[kRowsPerLane];
    float pref_min = FLT_MAX;
#pragma unroll
    for (int q = 0; q < kRowsPerLane; ++q) {
      const int p = lane + 32 * q;
      score[q] = FLT_MAX;
      if (p < n) {
        float acc = 0.f;
        for (int j = 0; j < n; ++j)
          acc = __fadd_rn(acc, __fmul_rn(cov[j], WT[j * n + p]));
        if (!taken[q]) score[q] = acc;
        if (needed[q] && !taken[q]) pref_min = nan_min(pref_min, score[q]);
      }
    }
    bool has = false;
    if (nd != nullptr) {
      for (int off = 16; off > 0; off >>= 1)
        pref_min = nan_min(pref_min, __shfl_xor_sync(0xffffffffu, pref_min, off));
      has = pref_min < FLT_MAX;
    }
    float best = 0.f;
    int best_row = n;                    // beyond every real row
#pragma unroll
    for (int q = 0; q < kRowsPerLane; ++q) {
      const int p = lane + 32 * q;
      if (p < n) {
        const float sel = (has && !(needed[q] && !taken[q])) ? FLT_MAX : score[q];
        if (best_row == n || before(sel, p, best, best_row)) {
          best = sel;
          best_row = p;
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int orow = __shfl_xor_sync(0xffffffffu, best_row, off);
      if (orow < n && (best_row == n || before(ob, orow, best, best_row))) {
        best = ob;
        best_row = orow;
      }
    }
    const int p = best_row;              // the same on every lane
    if (lane == 0) wout[p] = ord[t];
#pragma unroll
    for (int q = 0; q < kRowsPerLane; ++q)
      if (lane + 32 * q == p) taken[q] = true;
    __syncwarp();                        // every lane has read cov
    const float e = ep[t];
    for (int j = lane; j < n; j += 32)
      cov[j] = __fadd_rn(cov[j], __fdiv_rn(WT[j * n + p], e));
    __syncwarp();                        // cov complete for the next pick
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  need_row may be NULL (no reissue
// priorities).  Returns the cudaError_t of the launch (0 on success).
extern "C" int greedy_assign_launch(const void* W, const void* order, const void* epick,
                                    const void* need_row, void* out, int B, int n,
                                    void* stream) {
  if (n < 1 || n > kMaxN || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(n) * n + kWarps * n) * sizeof(float);
  static size_t smem_allowed = 48 * 1024;  // the default dynamic limit
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(greedy_assign_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  const int blocks = (B + kWarps - 1) / kWarps;
  greedy_assign_kernel<<<blocks, 32 * kWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const int*>(order),
      static_cast<const float*>(epick), static_cast<const float*>(need_row),
      static_cast<int*>(out), B, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* greedy_assign_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
