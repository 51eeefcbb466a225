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
// What bounds it on an H100: the dependent chain of a trial's n picks, not
// bytes or operations.  The least it must move is B*n*16 bytes (order,
// epick, need_row in, worker_of_row out) plus n^2 * 4 for W, over
// 3.35 TB/s, and it does about 2*B*n*nnz(W) flops: microseconds at the main
// path's shapes.  Each pick needs the previous pick's coverage, so a
// trial's time is n times one pick's latency, and the design cuts that
// latency (the card is filled only by many trials side by side):
//
//   Prologue.  The block copies W into shared memory (row stride n | 1, an
//   odd stride, so that the lanes reading one column of their rows hit
//   distinct banks).  Lane l owns rows and tasks l + 32q, q < R (R =
//   ceil(n / 32) rounded up to 1, 2 or 4, a template argument): it holds
//   their cov, order, epick, need flags, taken flags and worker_of_row in
//   registers, so that pick t reads order[t] and epick[t] with one
//   __shfl_sync each.  worker_of_row is written once, coalesced, at the
//   end.  At R = 1 (n <= 32, every configuration in the repository) the
//   block also lists each row's nonzeros, ascending by column, up to kCap
//   of them, and lane l keeps its row's list in registers.
//
//   Fold.  At R = 1 a row's score is the left fold over its nonzero
//   columns of __fmul_rn(cov[j], W[p, j]) added with __fadd_rn, starting
//   from +0; cov[j] comes from lane j by a shuffle, all K gathers issued
//   before the fold.  K, the longest list rounded up to 1, 2, 3, 4, 8 or 16,
//   is a template argument of the pick loop chosen once a trial, so the
//   fold has no branch; a shorter list is padded with (column 0, +0) pairs.
//   This equals the dense fold over every j bit for bit while every cov[j]
//   is finite: a skipped term is cov[j] * (+-0) = +-0, and adding +-0 to an
//   accumulator that starts at +0 never changes it (round-to-nearest never
//   makes -0 from +0, and sums are exact below the normal range).  A cov[j]
//   of +-inf or NaN would make a skipped term NaN, so after each update the
//   warp asks whether every cov[j] is finite (one __all_sync) and, once one
//   is not, finishes the trial in a second pick loop that folds densely,
//   over every j in order (a non-finite cov[j] stays non-finite).  The next
//   pick folds before it reads that vote, so the vote's latency hides
//   behind the gathers, and a pick folded over a non-finite cov is redone
//   densely.  A launch whose W has a row of more than kCap nonzeros, and
//   every launch at R > 1, runs the dense loop throughout (no workload
//   sends n > 32; there the R rows of a lane fold side by side, one shuffle
//   of cov[j] feeding all R).  Each fold is exact in its own domain, so the
//   output equals the plain version's.  The loops are templated on K and on
//   whether reissue priorities are given, so a pick has no branch but the
//   division's.  The dense loop counts the trials that enter it
//   (greedy_assign_dense_trials reads the count).
//
//   Argmin.  Each score maps to an order-preserving uint32 key: -0 as +0,
//   every NaN to 0 (NaN ranks first, as torch.argmin and jnp.argmin treat
//   it), taken rows at FLT_MAX's key (an untaken +inf still loses to them,
//   as in the plain version).  Two warp reductions pick the row: the least
//   key (__reduce_min_sync, redux.sync), then the least row holding it (at
//   R = 1 the lowest lane of a __ballot_sync, else a second redux).  With
//   reissue priorities one more reduction takes the least key over the
//   untaken needed rows: the argmin is restricted to them when that key is
//   neither 0 (a NaN among them: amin is NaN in the plain version) nor at
//   or above FLT_MAX's.
//
//   Update.  Lane j adds __fdiv_rn(W[p, j], epick[t]) to cov[j] for every
//   task j, as the plain version does (a zero, NaN or inf estimate reaches
//   every column).  Where W[p, j] is +-0 and the estimate is finite and
//   nonzero the quotient is +-0 and the sum cov[j] (never -0), so the lane
//   skips it: a zero dividend would take the division's slow path.  After
//   the last pick nothing reads cov, so that update is skipped (in the
//   sparse loop the last pick is peeled off the loop).
//
// Rounding: the plain version (kernels/ref.py greedy_assign_ref) uses the
// same fold in the same order, each product and sum rounded once, and a
// true division: the explicit _rn intrinsics keep nvcc from contracting
// them into FMAs or a reciprocal multiply.
//
// Largest n: kMaxN = 128 (n * (n | 1) * 4 bytes of W in shared memory,
// above the 48 KB default, so the launch raises the block's dynamic shared
// memory limit).

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kWarps = 8;              // trials per block
constexpr int kMaxN = 128;             // largest n the kernel takes
constexpr int kCap = 16;               // most nonzeros a row's list keeps
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kKeyFltMax = 0xff7fffffu;  // key(FLT_MAX)
constexpr unsigned kKeyNone = 0xffffffffu;    // beyond every float's key

// trials that entered the dense pick loop since the library was loaded
__device__ unsigned long long dense_trials;

__host__ __device__ constexpr int rows_per_lane(int n) {
  return n <= 32 ? 1 : (n <= 64 ? 2 : 4);
}

// order-preserving key: NaN -> 0 (first), -0 -> +0 (f + 0 changes no other
// value), else the float order: negative floats flipped whole, the others
// above them with the sign bit set
__device__ __forceinline__ unsigned key_of(float f) {
  const unsigned u = __float_as_uint(__fadd_rn(f, 0.f));
  const unsigned sign = static_cast<unsigned>(static_cast<int>(u) >> 31);
  const unsigned k = u ^ (sign | 0x80000000u);
  return f != f ? 0u : k;
}

// one lane's share of a trial: rows, tasks and picks lane + 32q, q < R;
// at R = 1 also its row's nonzeros (column, value), ascending, padded with
// (0, +0)
template <int R>
struct Lane {
  float cov[R], ep[R];
  int ord[R], wout[R];
  bool needed[R], taken[R];
  float val[R == 1 ? kCap : 1];
  int col[R == 1 ? kCap : 1];
};

// x[t], held by lane t % 32 at q = t / 32, on every lane
template <int R, typename T>
__device__ __forceinline__ T bcast(const T (&x)[R], int t) {
  T v = x[0];
#pragma unroll
  for (int q = 1; q < R; ++q) v = t >> 5 == q ? x[q] : v;
  return __shfl_sync(kFull, v, t & 31);
}

// the row a pick takes: fold the scores (SPARSE: over K (column, value)
// pairs, K >= the row's nonzeros, the pairs past a row's own adding +0;
// else over every column), then the argmin of their keys, restricted to
// the untaken needed rows while NEED finds one
template <int K, bool NEED, bool SPARSE, int R>
__device__ __forceinline__ int choose(const Lane<R>& L, const float* Ws,
                                      int n, int lane) {
  float score[R];
  if constexpr (SPARSE) {               // R = 1
    float c[K];
#pragma unroll
    for (int k = 0; k < K; ++k)         // gathers first, then the fold
      c[k] = __shfl_sync(kFull, L.cov[0], L.col[k]);
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      acc = __fadd_rn(acc, __fmul_rn(c[k], L.val[k]));
    score[0] = acc;
  } else {                              // a lane's R rows side by side
    const int s = n | 1;
    const float* wp[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      wp[q] = Ws + min(lane + 32 * q, n - 1) * s;  // rows >= n never read
      score[q] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < R; ++h) {
      const int m = min(32, n - 32 * h);
#pragma unroll 4
      for (int i = 0; i < m; ++i) {
        const float c = __shfl_sync(kFull, L.cov[h], i);
#pragma unroll
        for (int q = 0; q < R; ++q)
          score[q] = __fadd_rn(score[q], __fmul_rn(c, wp[q][32 * h + i]));
      }
    }
  }
  unsigned key[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {         // taken rows: FLT_MAX; none: beyond
    const bool in = lane + 32 * q < n;
    key[q] = in & !L.taken[q] ? key_of(score[q]) : in ? kKeyFltMax : kKeyNone;
  }
  if constexpr (NEED) {
    unsigned pk = kKeyFltMax;
#pragma unroll
    for (int q = 0; q < R; ++q)
      pk = L.needed[q] && !L.taken[q] ? min(pk, key[q]) : pk;
    const unsigned m = __reduce_min_sync(kFull, pk);
    const bool restrict_to_needed = m != 0u && m < kKeyFltMax;
#pragma unroll
    for (int q = 0; q < R; ++q)
      key[q] = restrict_to_needed && !(L.needed[q] && !L.taken[q]) &&
                       key[q] != kKeyNone
                   ? kKeyFltMax
                   : key[q];
  }
  unsigned best = key[0], best_row = lane;
#pragma unroll
  for (int q = 1; q < R; ++q) {         // strict: the lower row on ties
    best_row = key[q] < best ? lane + 32 * q : best_row;
    best = min(best, key[q]);
  }
  const unsigned m = __reduce_min_sync(kFull, best);
  if constexpr (R == 1)                 // the lowest lane holding m
    return __ffs(__ballot_sync(kFull, best == m)) - 1;
  return static_cast<int>(__reduce_min_sync(
      kFull, best == m ? best_row : static_cast<unsigned>(n)));
}

// row p goes to worker ord_t
template <int R>
__device__ __forceinline__ void take(Lane<R>& L, int p, int ord_t,
                                     int lane) {
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const bool hit = lane + 32 * q == p;
    L.taken[q] = L.taken[q] || hit;
    L.wout[q] = hit ? ord_t : L.wout[q];
  }
}

// cov[j] += W[p, j] / e for every task j; with VOTE, returns whether every
// cov[j] is finite afterwards (warp-uniform)
template <bool VOTE, int R>
__device__ __forceinline__ bool update(Lane<R>& L, const float* Ws, int n,
                                       int lane, int p, float e) {
  // W[p, j] = +-0 adds +-0 / e = +-0, a no-op, unless e is 0, inf or NaN;
  // skipping it keeps zeros off the division's slow path
  const bool e_plain = isfinite(e) && e != 0.f;
  const float* wp = Ws + p * (n | 1);
  bool fin = true;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int j = lane + 32 * q;
    const float w = wp[min(j, n - 1)];  // in range: no branch on the chain
    const bool add = (j < n) & ((w != 0.f) | !e_plain);  // no branch
    const float d = __fdiv_rn(add ? w : 1.f, e);
    L.cov[q] = add ? __fadd_rn(L.cov[q], d) : L.cov[q];
    fin = fin && (j >= n || isfinite(L.cov[q]));
  }
  return VOTE && __all_sync(kFull, fin);
}

// the n picks of one trial: at R = 1 sparse while every cov[j] is finite,
// then (or from the start, where a row is past the cap, and always at
// R > 1) dense.  A sparse pick folds before it looks at the previous
// update's vote, so the vote's latency overlaps the gathers; a pick whose
// cov was not finite is redone densely.
template <int K, bool NEED, int R>
__device__ __forceinline__ void run_picks(Lane<R>& L, const float* Ws, int n,
                                          int lane, bool sparse_ok) {
  int t = 0;
  if constexpr (R == 1) {
    if (sparse_ok) {
      bool finite = true;               // every cov[j] finite before pick t
      for (; t + 1 < n; ++t) {          // the last pick is peeled off
        const int ord_t = bcast(L.ord, t);
        const float e = bcast(L.ep, t);
        const int p = choose<K, NEED, true>(L, Ws, n, lane);
        if (!finite) break;
        take(L, p, ord_t, lane);
        finite = update<true>(L, Ws, n, lane, p, e);
      }
      if (t + 1 == n && finite) {       // the last pick: no update
        const int ord_t = bcast(L.ord, t);
        take(L, choose<K, NEED, true>(L, Ws, n, lane), ord_t, lane);
        ++t;
      }
    }
  }
  if (t < n && lane == 0) atomicAdd(&dense_trials, 1ull);
  for (; t < n; ++t) {
    const int ord_t = bcast(L.ord, t);
    const float e = bcast(L.ep, t);
    const int p = choose<1, NEED, false>(L, Ws, n, lane);
    take(L, p, ord_t, lane);
    if (t + 1 < n) update<false>(L, Ws, n, lane, p, e);
  }
}

template <bool NEED>
__device__ __forceinline__ void dispatch_k(Lane<1>& L, const float* Ws, int n,
                                           int lane, bool sparse_ok,
                                           int kpad) {
  if (kpad <= 1)
    run_picks<1, NEED>(L, Ws, n, lane, sparse_ok);
  else if (kpad <= 2)
    run_picks<2, NEED>(L, Ws, n, lane, sparse_ok);
  else if (kpad <= 3)
    run_picks<3, NEED>(L, Ws, n, lane, sparse_ok);
  else if (kpad <= 4)
    run_picks<4, NEED>(L, Ws, n, lane, sparse_ok);
  else if (kpad <= 8)
    run_picks<8, NEED>(L, Ws, n, lane, sparse_ok);
  else
    run_picks<kCap, NEED>(L, Ws, n, lane, sparse_ok);
}

template <int R>
__global__ void __launch_bounds__(32 * kWarps)
greedy_assign_kernel(const float* __restrict__ W, const int* __restrict__ order,
                     const float* __restrict__ epick,
                     const float* __restrict__ need_row,
                     int* __restrict__ out, int B, int n) {
  extern __shared__ float smem[];
  const int s = n | 1;                  // odd row stride
  float* Ws = smem;                                        // n * s
  float* lval = Ws + n * s;                                // kCap * n
  int* lcol = reinterpret_cast<int*>(lval + kCap * n);     // kCap * n
  int* lnnz = lcol + kCap * n;                             // n
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int trial = blockIdx.x * kWarps + warp;
  const bool live = trial < B;
  const size_t base = static_cast<size_t>(live ? trial : 0) * n;
  const bool with_need = need_row != nullptr;

  // the trial's pick data first, so its loads overlap W's
  Lane<R> L;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int j = lane + 32 * q;
    const bool in = live && j < n;
    L.ord[q] = in ? order[base + j] : 0;
    L.ep[q] = in ? epick[base + j] : 1.f;
    L.needed[q] = in && with_need && need_row[base + j] > 0.f;
    L.taken[q] = false;
    L.wout[q] = 0;
    L.cov[q] = 0.f;
  }
  bool over = false;
  if constexpr (R == 1) {
    // warp w copies rows w + kWarps * i, i < 4, of W and lists each row's
    // nonzeros (NaN counts), ascending, at lval/lcol[k * n + p] (one
    // ballot a row); unused entries (column 0, +0) add +0 while cov is
    // finite.  The four rows' loads are issued together: one latency.
    float wrow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = warp + kWarps * i;
      wrow[i] = p < n && lane < n ? W[p * n + lane] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = warp + kWarps * i;
      if (p >= n) break;                // warp-uniform
      const float w = wrow[i];
      if (lane < n) Ws[p * s + lane] = w;
      const unsigned nz = __ballot_sync(kFull, w != 0.f);
      const int k = __popc(nz & ((1u << lane) - 1u));
      const int nnz = __popc(nz);
      if (w != 0.f && k < kCap) {
        lval[k * n + p] = w;
        lcol[k * n + p] = lane;
      }
      if (lane >= nnz && lane < kCap) {
        lval[lane * n + p] = 0.f;
        lcol[lane * n + p] = 0;
      }
      if (lane == 0) lnnz[p] = nnz;
      over = over || nnz > kCap;
    }
  } else {
    for (int i = threadIdx.x; i < n * n; i += 32 * kWarps)
      Ws[(i / n) * s + i % n] = W[i];
  }
  const bool sparse_ok = !__syncthreads_or(over);
  if (!live) return;                    // whole warp leaves together

  if constexpr (R == 1) {
    const bool in = lane < n;
#pragma unroll
    for (int k = 0; k < kCap; ++k) {
      L.val[k] = in ? lval[k * n + lane] : 0.f;
      L.col[k] = in ? lcol[k * n + lane] : 0;
    }
    const int kpad =
        sparse_ok ? __reduce_max_sync(kFull, in ? min(lnnz[lane], kCap) : 0)
                  : 1;
    if (with_need)
      dispatch_k<true>(L, Ws, n, lane, sparse_ok, kpad);
    else
      dispatch_k<false>(L, Ws, n, lane, sparse_ok, kpad);
  } else if (with_need) {
    run_picks<1, true>(L, Ws, n, lane, false);
  } else {
    run_picks<1, false>(L, Ws, n, lane, false);
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int j = lane + 32 * q;
    if (j < n) out[base + j] = L.wout[q];
  }
}

template <int R>
int launch(const float* W, const int* order, const float* epick,
           const float* need_row, int* out, int B, int n, cudaStream_t stream) {
  const size_t lists = R == 1 ? 2 * kCap * n + n : 0;
  const size_t smem = (static_cast<size_t>(n) * (n | 1) + lists) * sizeof(float);
  static size_t smem_allowed = 48 * 1024;  // the default dynamic limit
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(greedy_assign_kernel<R>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  const int blocks = (B + kWarps - 1) / kWarps;
  greedy_assign_kernel<R><<<blocks, 32 * kWarps, smem, stream>>>(
      W, order, epick, need_row, out, B, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  need_row may be NULL (no reissue
// priorities).  Returns the cudaError_t of the launch (0 on success).
extern "C" int greedy_assign_launch(const void* W, const void* order, const void* epick,
                                    const void* need_row, void* out, int B, int n,
                                    void* stream) {
  if (n < 1 || n > kMaxN || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* w = static_cast<const float*>(W);
  const auto* o = static_cast<const int*>(order);
  const auto* e = static_cast<const float*>(epick);
  const auto* nd = static_cast<const float*>(need_row);
  auto* y = static_cast<int*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  switch (rows_per_lane(n)) {
    case 1: return launch<1>(w, o, e, nd, y, B, n, st);
    case 2: return launch<2>(w, o, e, nd, y, B, n, st);
    default: return launch<4>(w, o, e, nd, y, B, n, st);
  }
}

// The number of trials that have entered the dense pick loop, over every
// launch since the library was loaded, into *count (waits for the device).
// Returns the cudaError_t of the copy.
extern "C" int greedy_assign_dense_trials(unsigned long long* count) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(count, dense_trials, sizeof(*count)));
}

extern "C" const char* greedy_assign_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
