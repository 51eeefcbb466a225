// Hopper (sm_90a) CUDA kernel for the paper's per-task computation
// h(X) = X (X^T theta), batched over tasks: Xs (n, d, b) -> (n, d), in one
// pass that reads each element of X from device memory once.
//
// Replaces the Pallas TPU kernel gram_matvec_pallas (_xt_theta_kernel and
// _x_u_kernel) in src/repro/kernels/gram_matvec.py.  The TPU version walks
// (d, b) tiles on a sequential grid twice, carrying u = X^T theta in VMEM;
// the port's first kernel (gram_matvec.cu) did the same in two launches and
// so read X twice.  Here a tile stays in shared memory between the two
// products, and u is reduced inside a thread-block cluster.
//
// What bounds it on an H100: memory.  Both products do 2 flops per element
// of X (about 1 flop/byte in float32), far below the card's ridge, so the
// least it must move is one read of X.  The design:
//
//   * Work items are (task, column block) pairs, n * nbc of them.  A cluster
//     of c CTAs (c <= 8, the portable size) holds one item at a time over
//     the task's whole height d: CTA `rank` holds rows [rank*R, rank*R + R)
//     of C columns in shared memory.  The clusters are persistent: grid
//     (c, clusters), cluster (c, 1, 1), as many clusters as the device holds
//     at once, cluster g taking items g, g + clusters, ...  gram_plan sizes
//     the tile (at most ~48 K elements: one CTA an SM in float32, two in
//     bfloat16, where the second one's loads overlap the first one's
//     arithmetic).
//   * Loads: where rows start on 16-byte boundaries and are multiples of 16
//     bytes (X 16-byte aligned, b*itemsize and C*itemsize multiples of 16),
//     a few threads issue asynchronous copies that land on kStages
//     mbarriers, so the first product starts on the first rows while the
//     rest are in flight.  When one block covers b the tile is contiguous
//     in X and takes one cp.async.bulk per stage; otherwise TMA copies boxes
//     of C columns x Rb rows (Rb <= 256) through a 3-D tensor map, a few
//     boxes per stage, zero-filling columns past b and rows past d (one
//     instruction per box: a copy per row queued hundreds and stalled the
//     threads that issued them).  The next item's copies start as soon as
//     this item's tile has been read.  Otherwise (odd widths such as b = 53)
//     each item is loaded before its arithmetic by 4-byte cp.async (float32
//     elements, pairs of bfloat16 elements where b and C are even) or, for
//     odd bfloat16 widths, by ordinary loads (cp.async has no 2-byte size).
//   * u: each CTA sums its rows' part u_r[j] = sum_i X[i, j] theta[i] in a
//     fixed order (row groups of 16-byte column chunks, then the groups in
//     index order) into its shared memory; after a cluster barrier every CTA
//     reads the c parts through distributed shared memory and adds them in
//     rank order 0..c-1, so all hold the same u bit for bit.  The parts are
//     double-buffered, so one cluster barrier per item suffices: a part is
//     written again two items later, after every CTA has passed the barrier
//     that follows its reads.  A last barrier keeps each CTA's shared memory
//     alive until the others are done.
//   * y from the same tile: a thread per row, a float32 sum per element of a
//     16-byte chunk, added in order at the end.  When one column block
//     covers b (nbc == 1) the kernel writes y in X's dtype: one launch, no
//     scratch.  Otherwise it writes float32 partials P[t, jblock, i], and a
//     second small launch adds them over jblock in index order.
//
// No float atomics and no order that depends on arrival: the result is
// deterministic.  Accumulation is float32.  The plan (c, R, C, nbc) comes
// from the caller (repro_torch.kernels.ops.gram_plan), which also sends a
// column no cluster can hold to the two-pass kernel.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;          // mbarriers over a tile's rows
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kHeader = 128;        // bytes before the tile: the mbarriers
constexpr int kMaxBox = 256;        // the most rows or columns of a TMA box
constexpr int kSmemLimit = 232448;  // the most shared memory a block may use

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }
__host__ __device__ constexpr size_t round128(size_t v) { return (v + 127) & ~size_t{127}; }
__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// A tile's rows come in `boxes(R)` boxes of `box_rows(R)` rows each, a whole
// number of boxes per stage; a box is at most kMaxBox rows and a multiple of
// 8, so every box starts 128-byte aligned.
__host__ __device__ inline int boxes(int R) { return kStages * ceil_div(R, kStages * kMaxBox); }
__host__ __device__ inline int box_rows(int R) { return (ceil_div(R, boxes(R)) + 7) & ~7; }

__host__ __device__ inline size_t tile_bytes(int R, int C, int itemsize) {
  return round128(static_cast<size_t>(boxes(R)) * box_rows(R) * C * itemsize);
}

// Floats of the row groups' column sums: at most kThreads 16-byte chunks
// of columns, or C columns when one pass of the block cannot cover them.
__host__ __device__ constexpr int part_floats(int C, int itemsize) {
  return round4(kThreads * (16 / itemsize) > C ? kThreads * (16 / itemsize) : C);
}

// Dynamic shared memory of one CTA: header, the tile, float32 theta, the
// row groups' column sums, two parts of u, u.  ops.gram_plan computes the
// same and passes it to gram_onepass_launch, which refuses a plan whose
// count differs.
__host__ __device__ inline size_t smem_bytes(int R, int C, int itemsize) {
  return kHeader + tile_bytes(R, C, itemsize) +
         4 * static_cast<size_t>(round4(R) + part_floats(C, itemsize) + 3 * round4(C));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A stage's bytes
// land within microseconds; a barrier still open after ~2^28 polls means a
// byte count that cannot be met, and the kernel traps instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// `bytes` (a multiple of 16) from 16-byte aligned global `src` to 16-byte
// aligned shared `dst`; completion counted on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// A box of the 3-D tensor map (columns, rows, tasks) at (c0, c1, c2) to
// 128-byte aligned shared `dst`; its bytes, zeros past the edges included,
// counted on the mbarrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// 4 bytes from global `src` to shared `dst`, both 4-byte aligned.
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The elements of 16 bytes (4 float32 or 8 bfloat16, in address order) as
// float32.
__device__ __forceinline__ void widen(uint4 v, float* f, float) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void widen(uint4 v, float* f, __nv_bfloat16) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// One CTA's view of a work item: its rows of the item's column block.
template <typename T>
struct Item {
  const T* src;   // X[t, r0, j0]
  int t, j0, Cb;  // task, first column, columns of this block
};

template <typename T>
__device__ __forceinline__ Item<T> item_at(const T* X, int w, int d, int b, int C, int nbc,
                                           int r0) {
  const int t = w / nbc, j0 = (w - t * nbc) * C;
  return {X + (static_cast<size_t>(t) * d + r0) * b + j0, t, j0, min(C, b - j0)};
}

// How a CTA's tile is loaded: `rows` rows in stages of Rs; contiguous (one
// copy of Cb-wide rows per stage) or by boxes of Rb rows x C columns.
struct Loads {
  int rows, Rs, Rb, C;
  bool contiguous;
};

// Thread 0 arms a tile's stage barriers for the bytes the stage brings.
__device__ __forceinline__ void arm(uint64_t* bars, const Loads& L, uint32_t item_bytes,
                                    int Cb) {
  const int used = ceil_div(L.rows, L.Rb);       // boxes that hold a row
  for (int s = 0; s < kStages; ++s) {
    const int lo = s * L.Rs, hi = min(lo + L.Rs, L.rows);
    if (lo >= hi) continue;
    const int per = L.Rs / L.Rb, nb = min(used, (s + 1) * per) - s * per;
    mbar_expect_tx(smem_u32(&bars[s]), L.contiguous ? (hi - lo) * Cb * item_bytes
                                                    : nb * L.Rb * L.C * item_bytes);
  }
}

// A few threads start a tile's copies: thread s the contiguous stage s, or
// thread j box j.
template <typename T>
__device__ __forceinline__ void issue(const Item<T>& it, T* tile, uint64_t* bars, const Loads& L,
                                      const CUtensorMap* map, int r0, int b) {
  const int j = threadIdx.x;
  if (L.contiguous) {
    const int lo = j * L.Rs, hi = min(lo + L.Rs, L.rows);
    if (j < kStages && lo < hi)
      bulk_copy(smem_u32(tile + static_cast<size_t>(lo) * it.Cb),
                it.src + static_cast<size_t>(lo) * b, (hi - lo) * it.Cb * sizeof(T),
                smem_u32(&bars[j]));
  } else if (j * L.Rb < L.rows) {
    tma_load(smem_u32(tile + static_cast<size_t>(j) * L.Rb * L.C), map,
             smem_u32(&bars[j / (L.Rs / L.Rb)]), it.j0, r0 + j * L.Rb, it.t);
  }
}

template <typename T, bool kBulk>
__global__ void __launch_bounds__(kThreads)
gram_onepass_kernel(const __grid_constant__ CUtensorMap map, const T* __restrict__ X,
                    const T* __restrict__ theta, T* __restrict__ y, float* __restrict__ P, int n,
                    int d, int b, int R, int C, int nbc) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int V = 16 / sizeof(T);          // elements of a 16-byte chunk
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);          // [kStages]
  T* tile = reinterpret_cast<T*>(smem + kHeader);
  float* th = reinterpret_cast<float*>(smem + kHeader + tile_bytes(R, C, sizeof(T)));
  float* part = th + round4(R);
  float* ur = part + part_floats(C, sizeof(T));                // [2][round4(C)]
  float* uu = ur + 2 * round4(C);

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = blockIdx.x;      // the cluster spans x, so this is its rank
  const int c = gridDim.x;
  const int r0 = rank * R;
  const int rows = max(0, min(R, d - r0));
  const int items = n * nbc;
  const int first = blockIdx.y, stride = gridDim.y;
  const bool contiguous = nbc == 1;     // rows back to back in X and in the tile
  const int Rb = box_rows(R);
  const Loads L = {rows, contiguous ? ceil_div(rows, kStages) : boxes(R) / kStages * Rb, Rb, C,
                   contiguous};

  // The first tile: its barriers armed before any copy starts.
  if constexpr (kBulk) {
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&bars[s]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      arm(bars, L, sizeof(T), item_at(X, first, d, b, C, nbc, r0).Cb);
    }
    __syncthreads();
    issue(item_at(X, first, d, b, C, nbc, r0), tile, bars, L, &map, r0, b);
  }
  for (int i = tid; i < rows; i += kThreads) th[i] = to_f32(theta[r0 + i]);
  __syncthreads();

  for (int k = 0, w = first; w < items; ++k, w += stride) {
    const uint32_t parity = k & 1;
    const Item<T> it = item_at(X, w, d, b, C, nbc, r0);
    const int Cb = it.Cb;
    const int ld = kBulk && !contiguous ? C : Cb;      // the tile's row pitch
    float* urk = ur + (k & 1) * round4(C);

    if constexpr (!kBulk) {
      // 4-byte words where rows and blocks start on them (every float32
      // width, even bfloat16 widths), else single bfloat16 elements
      const int per = sizeof(T) == 4 || (b % 2 == 0 && C % 2 == 0 &&
                                         reinterpret_cast<uintptr_t>(X) % 4 == 0)
                          ? 4 / sizeof(T) : 1;
      const int wpr = Cb / per;                         // copies per row
      for (int e = tid; e < rows * wpr; e += kThreads) {
        const int i = e / wpr, j = (e - i * wpr) * per;
        const T* src = it.src + static_cast<size_t>(i) * b + j;
        if (per * sizeof(T) == 4) copy4(tile + i * ld + j, src);
        else tile[i * ld + j] = *src;
      }
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncthreads();
    }

    // 1. u's part.  Thread (g, kc) sums chunk (or column) kc over rows
    //    lo+g, lo+g+G, ... of each stage; then the G groups in order.
    const int m = kBulk ? Cb / V : Cb;       // 16-byte chunks, or columns
    const int Cc = min(m, kThreads);
    const int G = kThreads / Cc;
    const int g = tid / Cc, kc = tid - g * Cc;
    if (g < G) {
      for (int ch = kc; ch < m; ch += Cc) {
        if constexpr (kBulk) {
          float acc[V] = {};
          for (int s = 0; s < kStages; ++s) {
            const int lo = s * L.Rs, hi = min(lo + L.Rs, rows);
            if (lo >= hi) break;
            mbar_wait(smem_u32(&bars[s]), parity);
#pragma unroll 2
            for (int i = lo + g; i < hi; i += G) {
              float f[V];
              widen(*reinterpret_cast<const uint4*>(tile + static_cast<size_t>(i) * ld + ch * V),
                    f, T());
              const float ti = th[i];
#pragma unroll
              for (int e = 0; e < V; ++e) acc[e] = fmaf(f[e], ti, acc[e]);
            }
          }
#pragma unroll
          for (int e = 0; e < V; ++e) part[g * Cb + ch * V + e] = acc[e];
        } else {
          float a = 0.f;
#pragma unroll 4
          for (int i = g; i < rows; i += G) a = fmaf(to_f32(tile[i * ld + ch]), th[i], a);
          part[g * Cb + ch] = a;
        }
      }
    }
    __syncthreads();      // every wait on this tile's barriers is over
    const int next = w + stride;
    if constexpr (kBulk) {
      if (tid == 0 && next < items) arm(bars, L, sizeof(T), item_at(X, next, d, b, C, nbc, r0).Cb);
    }
    for (int j = tid; j < Cb; j += kThreads) {
      float s = 0.f;
#pragma unroll 8
      for (int q = 0; q < G; ++q) s += part[q * Cb + j];
      urk[j] = s;
    }

    // 2. u = the c parts added in rank order, through distributed shared
    //    memory.  urk is written again two items later, after the barrier
    //    of the next item, which every CTA passes only after these reads.
    cluster_sync_all();
    for (int j = tid; j < Cb; j += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < c) s += cluster.map_shared_rank(urk, q)[j];
      uu[j] = s;
    }
    __syncthreads();

    // 3. y (or the block's partial) for this CTA's rows, from the tile
    float* out_p = P + static_cast<size_t>(w) * d + r0;
    T* out_y = y + static_cast<size_t>(w) * d + r0;      // w == t when nbc == 1
    if constexpr (kBulk) {
      for (int i = tid; i < rows; i += kThreads) {
        const T* row = tile + static_cast<size_t>(i) * ld;
        // Rows of an even pitch in chunks start at chunk i mod m, so that
        // the eight rows of a quarter warp read eight bank groups.
        int ch = (ld / V) % 2 == 0 ? i % m : 0;
        float acc[V] = {};
        for (int step = 0; step < m; ++step) {
          float f[V];
          widen(*reinterpret_cast<const uint4*>(row + ch * V), f, T());
          const float* u = uu + ch * V;
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = fmaf(f[e], u[e], acc[e]);
          if (++ch == m) ch = 0;
        }
        float sum = acc[0];
#pragma unroll
        for (int e = 1; e < V; ++e) sum += acc[e];
        if (contiguous) store(&out_y[i], sum);
        else out_p[i] = sum;
      }
    } else {
      for (int i = tid; i < rows; i += kThreads) {
        float acc = 0.f;
        for (int j = 0; j < Cb; ++j) acc = fmaf(to_f32(tile[i * ld + j]), uu[j], acc);
        if (contiguous) store(&out_y[i], acc);
        else out_p[i] = acc;
      }
    }
    __syncthreads();      // the tile and u are free again
    if constexpr (kBulk) {
      if (next < items) issue(item_at(X, next, d, b, C, nbc, r0), tile, bars, L, &map, r0, b);
    }
  }
  cluster_sync_all();     // no CTA leaves while another may read its parts
}

// y[t, i] = sum over jblock = 0..nbc-1 of P[t, jblock, i], in that order.
template <typename T>
__global__ void gram_fold_kernel(const float* __restrict__ P, T* __restrict__ y, int n, int d,
                                 int nbc) {
  const size_t total = static_cast<size_t>(n) * d;
  for (size_t k = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; k < total;
       k += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t t = k / d, i = k - t * d;
    const float* p = P + t * nbc * d + i;
    float s = 0.f;
    for (int q = 0; q < nbc; ++q) s += p[static_cast<size_t>(q) * d];
    store(&y[k], s);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver API through the runtime, so
// the library needs no -lcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// X as a (b, d, n) tensor with boxes of C columns x Rb rows x 1 task; reads
// past the edges give zeros.
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* X, int n, int d, int b,
                  int C, int Rb, int itemsize) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(b), static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(b) * itemsize,
                                 static_cast<cuuint64_t>(d) * b * itemsize};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(C), static_cast<cuuint32_t>(Rb), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, itemsize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             3, const_cast<void*>(X), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Clusters of c CTAs with `smem` bytes each that the device holds at once
// (cudaOccupancyMaxActiveClusters), remembered per device and shape.
template <typename T, bool kBulk>
int resident_clusters(int dev, int c, size_t smem, cudaLaunchConfig_t cfg) {
  struct Entry { int dev, c; size_t smem; int clusters; };
  static Entry cache[16];
  static int filled = 0;
  for (int k = 0; k < filled; ++k)
    if (cache[k].dev == dev && cache[k].c == c && cache[k].smem == smem) return cache[k].clusters;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, gram_onepass_kernel<T, kBulk>, &cfg) !=
      cudaSuccess)
    return -1;
  if (filled < 16) cache[filled++] = {dev, c, smem, clusters};
  return clusters;
}

template <typename T, bool kBulk>
int launch(const void* X, const void* theta, void* y, void* P, int n, int d, int b, int c,
           int R, int C, int nbc, cudaStream_t stream) {
  static bool raised[64] = {};     // the shared-memory limit, once per device
  auto kernel = gram_onepass_kernel<T, kBulk>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) raised[dev] = true;
  }
  alignas(64) CUtensorMap map = {};
  if (kBulk && nbc > 1) {
    EncodeTiled enc = encode_fn();
    if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const CUresult r = make_map(enc, &map, X, n, d, b, C, box_rows(R), sizeof(T));
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  }
  const int items = n * nbc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, items);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(R, C, sizeof(T));
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int resident = resident_clusters<T, kBulk>(dev, c, cfg.dynamicSmemBytes, cfg);
  if (resident < 0) return static_cast<int>(cudaGetLastError());
  cfg.gridDim.y = resident > 0 && resident < items ? resident : (items < 65535 ? items : 65535);
  err = cudaLaunchKernelEx(&cfg, kernel, map, static_cast<const T*>(X),
                           static_cast<const T*>(theta), static_cast<T*>(y),
                           static_cast<float*>(P), n, d, b, R, C, nbc);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nbc > 1) {
    const size_t total = static_cast<size_t>(n) * d;
    const size_t blocks = (total + 255) / 256;
    gram_fold_kernel<T><<<static_cast<unsigned>(blocks < 65535 * 8 ? blocks : 65535 * 8), 256,
                          0, stream>>>(static_cast<const float*>(P), static_cast<T*>(y), n, d,
                                       nbc);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* X, const void* theta, void* y, void* P, int n, int d, int b, int c,
             int R, int C, int nbc, cudaStream_t stream) {
  const int item = sizeof(T);
  const bool bulk = reinterpret_cast<uintptr_t>(X) % 16 == 0 && (b * item) % 16 == 0 &&
                    (C * item) % 16 == 0;
  if (bulk && nbc > 1 && C > kMaxBox) return static_cast<int>(cudaErrorInvalidValue);
  if (bulk) return launch<T, true>(X, theta, y, P, n, d, b, c, R, C, nbc, stream);
  return launch<T, false>(X, theta, y, P, n, d, b, c, R, C, nbc, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// X (n, d, b) and theta (d,) contiguous; y (n, d) in X's dtype; P (n, nbc,
// d) float32 scratch when nbc > 1, else unused.  The plan: c CTAs per
// cluster of R rows each (c*R >= d > (c-1)*R), column blocks of C (nbc =
// ceil(b/C), C <= 256 when nbc > 1) and smem, the plan's shared memory per
// CTA, which must equal smem_bytes(R, C, itemsize).
// Returns 0 on success, minus the CUresult of a failed tensor-map encoding,
// or the cudaError_t of the attribute call, the occupancy query or a launch
// (cudaErrorInvalidValue for a plan the kernel cannot take).
extern "C" int gram_onepass_launch(const void* X, const void* theta, void* y, void* P, int n,
                                   int d, int b, int dtype, int c, int R, int C, int nbc,
                                   int smem, void* stream) {
  const int item = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || n < 1 || d < 1 || b < 1 || n > 65535 || c < 1 ||
      c > kMaxCluster || R < 1 || static_cast<long long>(c) * R < d ||
      static_cast<long long>(c - 1) * R >= d || C < 1 || C > b ||
      nbc != (b + C - 1) / C || static_cast<long long>(n) * nbc >= (1LL << 31) ||
      (nbc > 1 && P == nullptr) || smem_bytes(R, C, item) > static_cast<size_t>(kSmemLimit) ||
      smem_bytes(R, C, item) != static_cast<size_t>(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(X, theta, y, P, n, d, b, c, R, C, nbc, s);
  return dispatch<__nv_bfloat16>(X, theta, y, P, n, d, b, c, R, C, nbc, s);
}

// Shared memory of one CTA holding R rows of C columns of itemsize bytes:
// what gram_onepass_launch asks for, so that a test can hold ops.gram_plan's
// count against it.
extern "C" long long gram_onepass_smem(int R, int C, int itemsize) {
  return static_cast<long long>(smem_bytes(R, C, itemsize));
}

extern "C" const char* gram_onepass_error_string(int err) {
  if (err < 0) return "cuTensorMapEncodeTiled failed (CUresult = -err)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
