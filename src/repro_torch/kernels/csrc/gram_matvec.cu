// Hopper (sm_90a) CUDA kernels for the tall tasks of the paper's per-task
// computation h(X) = X (X^T theta), batched over tasks: Xs (n, d, b) -> (n, d).
//
// Replaces the Pallas TPU kernel gram_matvec_pallas (_xt_theta_kernel and
// _x_u_kernel) in src/repro/kernels/gram_matvec.py for the tasks that the
// one-pass kernel (gram_matvec_onepass.cu) cannot take: a column that no
// cluster of 8 CTAs holds in shared memory, d past ~90 000 rows in float32
// (repro_torch.kernels.ops.gram_plan sends them here).  The TPU version walks
// (d, b) tiles on a sequential grid and carries u = X^T theta in VMEM; here
// the height of a task is cut into slabs that run on every SM at once.
//
// What bounds it on an H100: memory.  Both products do 2 flops per element
// of X (about 1 flop/byte in float32), far below the card's ridge.  The least
// it must move is one read of X; this design reads X twice, so where X is
// larger than what the 50 MB L2 keeps, it can reach at most half of that
// bound.  Where X fits, much of the second read comes from L2.
//
//   pass 1  u = X^T theta, split over d.  Work items are (task, slab, column
//           block), grid (S1 * ncb, n): a slab is `rows1` consecutive rows of
//           one task, a column block `qb` vectors of `vec` elements (16 bytes
//           where b allows, else one element).  Thread `tid` owns one vector
//           column and a row phase, walks its rows in order with vector
//           loads (kUnroll1 in flight), multiplies by theta and sums per
//           column; then the CTA adds its phases in a fixed tree in shared
//           memory and writes float32 partials part[t, slab, j] (u itself
//           when a task has one slab).
//   pass 2  y = X u.  Grid (S2, n): slabs of `rows2` rows over every SM, in
//           pass 1's order (block i on slab i), each walked from its last
//           row to its first: pass 1's CTAs run at once and each reads its
//           slab front to back, so the ends of the slabs are what L2 still
//           holds.  Its loads are marked evict-first (X is not read again).
//           Each CTA first folds its task's S1 partials of every column in
//           slab order (contiguous groups of slabs, then the groups in order)
//           into u in shared memory, while the loads of its first rows are
//           already on their way to L1.  `tr` threads share a row (one when b
//           is narrow, up to a warp when it is wide), each summing its vectors
//           in order, then a butterfly over the tr lanes; kUnroll2 rows in
//           flight a thread.
//
// No atomics and no order that depends on timing: every sum has one fixed
// association, and no state outlives a call, so two calls give the same
// bits.  Accumulation is float32; inputs are float32 or bfloat16, the output
// has X's dtype.  The plan (vec, qb, ncb, rows1, S1, rows2, S2, tr) comes from
// the caller (ops.gram_tall_plan); it depends on the shape and dtype only,
// and a misaligned X takes the same plan with element loads, so the bits do
// not depend on the card or the address.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;    // both passes
constexpr int kFoldMax = 8192;   // most partials (S1 * b) a pass-2 CTA folds
constexpr int kSmemU = 4096;     // most columns of u pass 2 keeps in shared memory
constexpr int kUnroll1 = 8;      // pass 1: rows in flight a thread
constexpr int kUnroll2 = 8;      // pass 2: rows in flight a thread
static_assert(kFoldMax / 2 <= kSmemU, "a task with two slabs keeps its u in shared memory");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// V consecutive elements at p as float32: one 16-byte load when kVec, else
// one load per element (same values, so the same arithmetic follows).
// kLast marks the line evict-first in L2 (the data's last read).
template <typename T, int V, bool kVec, bool kLast>
__device__ __forceinline__ void load_x(const T* __restrict__ p, float (&f)[V]) {
  if constexpr (kVec && sizeof(T) == 4) {
    static_assert(V == 4, "float32 vectors are 4 wide");
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 v = kLast ? __ldcs(q) : __ldg(q);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else if constexpr (kVec) {
    static_assert(V == 8, "bfloat16 vectors are 8 wide");
    const uint4* q = reinterpret_cast<const uint4*>(p);
    const uint4 v = kLast ? __ldcs(q) : __ldg(q);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 g = __bfloat1622float2(h[k]);
      f[2 * k] = g.x; f[2 * k + 1] = g.y;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = to_f32(p[v]);
  }
}

// V consecutive floats of u, in shared or global memory (16-byte aligned when
// V > 1: V divides b).
template <int V>
__device__ __forceinline__ void load_u(const float* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = *p;
  } else {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 v = reinterpret_cast<const float4*>(p)[k];
      f[4 * k] = v.x; f[4 * k + 1] = v.y; f[4 * k + 2] = v.z; f[4 * k + 3] = v.w;
    }
  }
}

template <typename T, int V, bool kVec>
__global__ void __launch_bounds__(kThreads)
slab_u_kernel(const T* __restrict__ X, const T* __restrict__ theta, float* __restrict__ part,
              float* __restrict__ u, int d, int b, int S1, int rows1, int ncb, int qb) {
  __shared__ float red[V * kThreads];  // red[v * kThreads + tid]: no bank conflicts
  const int t = blockIdx.y;
  const int s = blockIdx.x / ncb, cb = blockIdx.x % ncb;
  const int q0 = cb * qb, nq = min(qb, b / V - q0);
  const int phases = kThreads / qb;
  const int tid = threadIdx.x, q = tid % qb, ph = tid / qb;
  const bool active = ph < phases && q < nq;
  const int r0 = s * rows1, r1 = min(d, r0 + rows1);

  // thread: its rows in order, kUnroll1 loads in flight
  float acc[V] = {};
  if (active) {
    const T* col = X + static_cast<size_t>(t) * d * b + static_cast<size_t>(q0 + q) * V;
    for (int r = r0 + ph; r < r1; r += kUnroll1 * phases) {
      float x[kUnroll1][V], th[kUnroll1];
#pragma unroll
      for (int k = 0; k < kUnroll1; ++k) {
        const int rr = r + k * phases;
        if (rr < r1) {
          load_x<T, V, kVec, false>(col + static_cast<size_t>(rr) * b, x[k]);
          th[k] = to_f32(theta[rr]);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll1; ++k) {
        if (r + k * phases < r1) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = fmaf(x[k][v], th[k], acc[v]);
        }
      }
    }
  }

  // block: the phases of a column in a fixed tree (thread tid = ph * qb + q)
  if (active) {
#pragma unroll
    for (int v = 0; v < V; ++v) red[v * kThreads + tid] = acc[v];
  }
  int top = 1;
  while (top < phases) top <<= 1;
  for (int h = top >> 1; h > 0; h >>= 1) {
    __syncthreads();
    if (active && ph < h && ph + h < phases) {
#pragma unroll
      for (int v = 0; v < V; ++v) red[v * kThreads + tid] += red[v * kThreads + tid + h * qb];
    }
  }
  __syncthreads();
  if (ph == 0 && q < nq) {
    float* out = S1 == 1 ? u + static_cast<size_t>(t) * b
                         : part + (static_cast<size_t>(t) * S1 + s) * b;
#pragma unroll
    for (int v = 0; v < V; ++v) out[(q0 + q) * V + v] = red[v * kThreads + q];
  }
}

template <typename T, int V, bool kVec>
__global__ void __launch_bounds__(kThreads)
x_u_kernel(const T* __restrict__ X, const float* __restrict__ part, const float* __restrict__ u,
           T* __restrict__ y, int d, int b, int S1, int S2, int rows2, int tr) {
  __shared__ __align__(16) float us[kSmemU];
  __shared__ float grp[kThreads];
  const int t = blockIdx.y, s = blockIdx.x;
  const int r0 = s * rows2, r1 = min(d, r0 + rows2), nr = r1 - r0;
  const int Q = b / V;
  const int tid = threadIdx.x, lane = tid % tr, sub = tid / tr, step = kThreads / tr;
  const T* Xt = X + static_cast<size_t>(t) * d * b;
  const float* ut = u + static_cast<size_t>(t) * b;

  // u into shared memory: this task's partials folded in slab order (or u
  // as pass 1 wrote it), while the first rows travel to L1
  if (b <= kSmemU) {
#pragma unroll
    for (int k = 0; k < kUnroll2; ++k) {
      const int i = k * step + sub;
      if (i < nr && lane < Q) {
        const T* p = Xt + static_cast<size_t>(r1 - 1 - i) * b + lane * V;
        asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
      }
    }
    if (S1 == 1) {
      for (int j = tid; j < b; j += kThreads) us[j] = ut[j];
    } else {
      // G groups of contiguous slabs per column (several when b is narrow),
      // each summed in slab order, then the groups in order
      const int G = max(1, min(S1, kThreads / b));
      const int cols = G > 1 ? b : kThreads;
      const int g = tid / cols, jj = tid % cols;
      const float* pt = part + static_cast<size_t>(t) * S1 * b;
      for (int j0 = 0; j0 < b; j0 += cols) {
        const int j = j0 + jj;
        float sum = 0.f;
        if (g < G && j < b) {
          const int lo = static_cast<int>(static_cast<long long>(g) * S1 / G);
          const int hi = static_cast<int>(static_cast<long long>(g + 1) * S1 / G);
          for (int sl = lo; sl < hi; sl += kUnroll1) {
            float p[kUnroll1];
#pragma unroll
            for (int k = 0; k < kUnroll1; ++k)
              p[k] = sl + k < hi ? __ldg(pt + static_cast<size_t>(sl + k) * b + j) : 0.f;
#pragma unroll
            for (int k = 0; k < kUnroll1; ++k) sum += p[k];
          }
        }
        if (G == 1) {
          if (j < b) us[j] = sum;
          continue;
        }
        grp[tid] = sum;
        __syncthreads();
        if (g == 0 && j < b) {
          float all = grp[jj];
          for (int k = 1; k < G; ++k) all += grp[k * cols + jj];
          us[j] = all;
        }
      }
    }
    __syncthreads();
    ut = us;
  }

  // rows i = 0, 1, ... of the slab counted from its end
  for (int base = 0; base < nr; base += kUnroll2 * step) {
    float acc[kUnroll2] = {};
#pragma unroll 2
    for (int q = lane; q < Q; q += tr) {
      float uq[V];
      load_u<V>(ut + q * V, uq);
      float x[kUnroll2][V];
#pragma unroll
      for (int k = 0; k < kUnroll2; ++k) {
        const int i = base + k * step + sub;
        if (i < nr)
          load_x<T, V, kVec, true>(Xt + static_cast<size_t>(r1 - 1 - i) * b + q * V, x[k]);
      }
#pragma unroll
      for (int k = 0; k < kUnroll2; ++k) {
        if (base + k * step + sub < nr) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[k] = fmaf(x[k][v], uq[v], acc[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll2; ++k)
      for (int o = tr >> 1; o > 0; o >>= 1) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kUnroll2; ++k) {
        const int i = base + k * step + sub;
        if (i < nr) store(&y[static_cast<size_t>(t) * d + r1 - 1 - i], acc[k]);
      }
    }
  }
}

template <typename T, int V, bool kVec>
int launch(const void* X, const void* theta, void* part, void* u, void* y, int n, int d, int b,
           int qb, int ncb, int rows1, int S1, int rows2, int S2, int tr, cudaStream_t stream) {
  slab_u_kernel<T, V, kVec><<<dim3(S1 * ncb, n), kThreads, 0, stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(theta), static_cast<float*>(part),
      static_cast<float*>(u), d, b, S1, rows1, ncb, qb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  x_u_kernel<T, V, kVec><<<dim3(S2, n), kThreads, 0, stream>>>(
      static_cast<const T*>(X), static_cast<const float*>(part), static_cast<const float*>(u),
      static_cast<T*>(y), d, b, S1, S2, rows2, tr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* X, const void* theta, void* part, void* u, void* y, int n, int d, int b,
             int vec, int qb, int ncb, int rows1, int S1, int rows2, int S2, int tr,
             cudaStream_t stream) {
  constexpr int kVecMax = 16 / static_cast<int>(sizeof(T));
  if (vec == 1)
    return launch<T, 1, false>(X, theta, part, u, y, n, d, b, qb, ncb, rows1, S1, rows2, S2, tr,
                               stream);
  if (vec != kVecMax) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(X) % 16 == 0)
    return launch<T, kVecMax, true>(X, theta, part, u, y, n, d, b, qb, ncb, rows1, S1, rows2,
                                    S2, tr, stream);
  return launch<T, kVecMax, false>(X, theta, part, u, y, n, d, b, qb, ncb, rows1, S1, rows2, S2,
                                   tr, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// X (n, d, b) and theta (d,) contiguous; y (n, d) in X's dtype; u (n, b)
// float32 scratch, 16-byte aligned; part (n, S1, b) float32 scratch when
// S1 > 1, else unused.  The plan: vectors of vec elements (1, or 16 bytes'
// worth, dividing b), column blocks of qb vectors (ncb = ceil(b / vec / qb),
// qb <= kThreads), slabs of rows1 rows in pass 1 (S1 = ceil(d / rows1),
// S1 * b <= kFoldMax unless S1 = 1) and of rows2 rows in pass 2 (S2 =
// ceil(d / rows2)), tr threads a row in pass 2 (a power of two <= 32).
// Returns the cudaError_t of the launches (0 on success;
// cudaErrorInvalidValue for a plan the kernels cannot take).
extern "C" int gram_matvec_launch(const void* X, const void* theta, void* part, void* u, void* y,
                                  int n, int d, int b, int dtype, int vec, int qb, int ncb,
                                  int rows1, int S1, int rows2, int S2, int tr, void* stream) {
  const long long Q = vec >= 1 ? b / vec : 0;
  if ((dtype != 0 && dtype != 1) || n < 1 || n > 65535 || d < 1 || b < 1 || vec < 1 ||
      b % vec != 0 || qb < 1 || qb > kThreads || ncb != (Q + qb - 1) / qb || rows1 < 1 ||
      S1 != (static_cast<long long>(d) + rows1 - 1) / rows1 ||
      (S1 > 1 && (static_cast<long long>(S1) * b > kFoldMax || part == nullptr)) ||
      static_cast<long long>(S1) * ncb >= (1LL << 31) || rows2 < 1 ||
      S2 != (static_cast<long long>(d) + rows2 - 1) / rows2 || tr < 1 || tr > 32 ||
      (tr & (tr - 1)) != 0 || u == nullptr || reinterpret_cast<uintptr_t>(u) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(X, theta, part, u, y, n, d, b, vec, qb, ncb, rows1, S1, rows2, S2, tr,
                           s);
  return dispatch<__nv_bfloat16>(X, theta, part, u, y, n, d, b, vec, qb, ncb, rows1, S1, rows2,
                                 S2, tr, s);
}

extern "C" const char* gram_matvec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
