// Hopper (sm_90a) tensor-core kernel for causal sliding-window attention
// with grouped KV heads, float32 in and out at float32 accuracy: q (B, T,
// H, dh), k/v (B, T, K, dh) -> o (B, T, H, dh), dh in {16, 32, 64, 128,
// 256}.  Query position t attends to the keys s with t - W < s <= t; query
// head h reads KV head h / (H / K).  Scores are scaled by 1 / sqrt(dh), the
// online-softmax state is float32, and o = acc / max(l, 1e-30).
//
// Replaces the Pallas TPU kernel swa_attention_pallas (_swa_kernel) in
// src/repro/kernels/swa_attention.py for float32 inputs; bfloat16 keeps
// swa_attention_wgmma.cu (dh 64-256) and swa_attention.cu (dh 16 / 32).
//
// What bounds it on an H100: operations.  Each visible (q, k) pair costs
// 4 * dh flops; at gemma3-4b's prefill (T 2048, W 1024, dh 256) that is
// ~500 flops per byte of q, k, v and o.  On the CUDA cores (67 TFLOP/s)
// that is 0.385 ms; the tensor cores take TF32 at 495 TFLOP/s, but one
// TF32 product keeps 11 of float32's 24 bits.  So each product runs as
// error-compensated TF32: x = hi + lo with hi = rna(x) and lo = rna(x - hi)
// (rna: round to 11 significant bits, ties away from zero, as
// cvt.rna.tf32.f32, done here on the bit pattern with integer ops), and
//   Q K^T ~ Q_lo K_hi + Q_hi K_lo + Q_hi K_hi        (three products),
//   P V   ~ P_lo V_hi + P_hi V_lo2 + P_hi V_lo + P_hi V_hi  (four),
// small terms first, each into the float32 accumulator of
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32.  The dropped lo * lo term and
// the rounding of lo are ~2^-22 of |x|, near float32's own 2^-24.  V takes a
// third term, lo2 = (v - hi) - lo, which is exact (at most 3 bits), so
// hi + lo + lo2 == v: where a row's weights are exact (one visible key: W =
// 1, or the first position of every call) the output is v to the bit, as
// the plain float32 version gives it; two terms would miss it by ~2^-22.
//
//   block    256 threads, 8 warps; a warp owns 16 query rows of one head.
//            The block holds NH heads of one KV group (the largest power of
//            two dividing H / K, at most 8) at 128 / NH consecutive
//            positions, so each K/V tile it stages serves 128 query rows
//            (both heads of a gemma3 group: NH = 2, 64 positions).
//   shared   Q (128 rows) loaded once; one K tile and one V tile (kKeys
//            keys: 32 at dh 256, else 64), rows padded by 4 floats so the
//            ldmatrix and 8-byte reads below are free of bank conflicts.
//            At dh 256: 133 120 + 2 x 33 280 = 199 680 bytes.
//   copies   16-byte cp.async (rows past T filled with zeros), issued a
//            phase ahead: V of tile j lands while Q K^T of tile j runs, K
//            of tile j + 1 while P V of tile j runs; two block barriers a
//            tile, each after a wait for the copy the next phase reads.
//   Q K^T    A (Q) and B (K) fragments by ldmatrix (a float32 is two b16
//            halves, so the b16 fragment layout is the tf32 one), split in
//            registers as they are loaded.
//   softmax  each thread holds rows g and g + 8 of its warp's 16; row
//            maxima over the quad by shuffles, l summed per thread and over
//            the quad at the end; masked scores contribute exactly 0, and
//            the mask is paid only on tiles that cross the band's edge.
//   P V      P comes from the S accumulator as the A fragment, with each
//            k-step's 8 keys permuted (A column t is key 2t, t + 4 is key
//            2t + 1) and V read in the same order; two n-blocks of 8 take
//            interleaved columns, so each B pair is one 8-byte read and each
//            thread's output is 4 adjacent floats, stored as one float4.
//   order    blocks run the work items of a plan (ops.swa_f32_plan) in its
//            order, longest first, so the short ones fill the tail; where the
//            long query tiles of a wide window would still form the tail,
//            the plan splits their KV range in two halves.  Each half
//            writes its accumulator, row maxima and sums to scratch; the
//            half that finishes later (an atomic count) merges the other's
//            with its own, o = (acc_a e^(m_a - m) + acc_b e^(m_b - m)) /
//            (l_a e^(m_a - m) + l_b e^(m_b - m)), in rounded products and
//            sums that do not depend on which half came last.
//   epilogue o = acc / max(l, 1e-30) (a true division, so l = 1 gives acc).

#include <cuda_runtime.h>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16 * kWarps;         // query rows (head, position) a block
constexpr float kNegInf = -1e30f;

template <int DH> struct Cfg {
  static constexpr int kKeys = DH == 256 ? 32 : 64;   // keys a KV tile
  static constexpr int kStride = DH + 4;              // floats a shared row
  static constexpr int kQFloats = kRows * kStride;
  static constexpr int kTileFloats = kKeys * kStride;
  static constexpr size_t kSmem = (kQFloats + 2 * kTileFloats) * sizeof(float);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros where !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait for every copy this thread has committed.
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// x rounded to TF32 (11 significant bits, ties away from zero): the bit
// pattern of cvt.rna.tf32.f32 for finite x.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split2(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& lo, uint32_t& lo2) {
  hi = tf32_rna(x);
  const float r = x - __uint_as_float(hi);
  lo = tf32_rna(r);
  lo2 = __float_as_uint(r - __uint_as_float(lo));
}

// d += a * b: one m16n8k8 TF32 product with a float32 accumulator.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [p0, p0 + kKeys) of head `head` of x (B, T, nh, DH) into a
// padded tile by 16-byte copies; rows at or past T are zeros.
template <int DH>
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ x, int b,
                                          int p0, int head, int seq, int nh) {
  using C = Cfg<DH>;
  constexpr int kChunks = DH / 4;
#pragma unroll
  for (int i = 0; i < C::kKeys * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks, col = (c % kChunks) * 4, p = p0 + r;
    const bool ok = p < seq;
    const float* src = x + ((static_cast<size_t>(b) * seq + (ok ? p : 0)) * nh + head) * DH + col;
    cp_async16(smem_u32(tile + r * C::kStride + col), src, ok);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
swa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int B, int seq, int H,
               int K, int window, const int4* __restrict__ items, int nh,
               float* __restrict__ scratch, int* __restrict__ counts, float scale) {
  using C = Cfg<DH>;
  constexpr int kKeys = C::kKeys, kS = C::kStride, kNb = kKeys / 8, kPairs = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + C::kQFloats;
  float* vs = ks + C::kTileFloats;

  // block -> (work item, head group hb, batch row b); an item is query tile
  // x over KV tiles kt_lo..kt_hi, whole (code < 0) or one half of a split
  // range (scratch slot code, the other half's code ^ 1)
  const int hgroups = H / nh, per = hgroups * B;
  const int4 item = items[blockIdx.x / per];
  const int rest = static_cast<int>(blockIdx.x) % per;
  const int hb = rest % hgroups, b = rest / hgroups;
  const int x = item.x, kt_lo = item.y, kt_hi = item.z, code = item.w;
  const int npos = kRows / nh;                  // positions a block
  const int q0 = x * npos;
  const int h0 = hb * nh, kvh = h0 / (H / K);
  const int w = window < seq ? window : seq;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wpos = npos / 16;                   // warps a head
  const int h = h0 + warp / wpos;
  const int p0 = q0 + (warp % wpos) * 16;       // the warp's first position
  const int p_last = min(p0 + 15, seq - 1);

  // Q: row warp * 16 + i holds position p0 + i of head h
#pragma unroll
  for (int i = 0; i < kRows * (DH / 4) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / (DH / 4), col = (c % (DH / 4)) * 4;
    const int rw = r / 16;
    const int p = q0 + (rw % wpos) * 16 + r % 16;
    const bool ok = p < seq;
    const float* src =
        q + ((static_cast<size_t>(b) * seq + (ok ? p : 0)) * H + h0 + rw / wpos) * DH + col;
    cp_async16(smem_u32(qs + r * kS + col), src, ok);
  }
  load_tile<DH>(ks, k, b, kt_lo * kKeys, kvh, seq, K);
  cp_async_commit();

  float acc[kPairs][2][4];
#pragma unroll
  for (int p = 0; p < kPairs; ++p)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // ldmatrix row addresses: lane -> (matrix lane / 8, row lane % 8)
  const int mi = lane / 8, mr = lane % 8;
  const uint32_t q_addr =
      smem_u32(qs + (warp * 16 + (mi & 1) * 8 + mr) * kS + (mi >> 1) * 4);
  const uint32_t k_addr = smem_u32(ks + ((mi >> 1) * 8 + mr) * kS + (mi & 1) * 4);
  const float* v_row = vs + 2 * t * kS + 2 * g;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kKeys;
    const bool sees = p0 < seq && k0 <= p_last && k0 + kKeys - 1 > p0 - w;
    const bool full = k0 + kKeys - 1 <= p0 && k0 > p_last - w;
    cp_async_wait();                           // Q and this tile's K landed
    __syncthreads();                           // and every warp is done with V
    load_tile<DH>(vs, v, b, k0, kvh, seq, K);
    cp_async_commit();

    float s[kNb][4];
#pragma unroll
    for (int n = 0; n < kNb; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if (sees) {
#pragma unroll 2
      for (int d = 0; d < DH; d += 8) {
        uint32_t a[4], ah[4], al[4];
        ldsm_x4(q_addr + d * 4, a[0], a[1], a[2], a[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) split2(__uint_as_float(a[e]), ah[e], al[e]);
#pragma unroll
        for (int n = 0; n < kNb; n += 2) {
          uint32_t bk[4], bh[4], bl[4];
          ldsm_x4(k_addr + (n * 8 * kS + d) * 4, bk[0], bk[1], bk[2], bk[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) split2(__uint_as_float(bk[e]), bh[e], bl[e]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma(s[n + j], al, bh[2 * j], bh[2 * j + 1]);
            mma(s[n + j], ah, bl[2 * j], bl[2 * j + 1]);
            mma(s[n + j], ah, bh[2 * j], bh[2 * j + 1]);
          }
        }
      }
    }

    if (sees) {
      // online softmax over rows r = 0 (g) and 1 (g + 8)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = p0 + g + 8 * r;
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < kNb; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& sv = s[n][2 * r + c];
            const int kpos = k0 + 8 * n + 2 * t + c;
            const bool ok = full || (kpos <= qpos && kpos > qpos - w && kpos < seq);
            sv = ok ? sv * scale : kNegInf;
            mx = fmaxf(mx, sv);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float corr = expf(m[r] - m_new);
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < kNb; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& sv = s[n][2 * r + c];
            sv = sv > 0.5f * kNegInf ? expf(sv - m_new) : 0.f;
            sum += sv;
          }
        l[r] = l[r] * corr + sum;
#pragma unroll
        for (int p = 0; p < kPairs; ++p)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            acc[p][n][2 * r] *= corr;
            acc[p][n][2 * r + 1] *= corr;
          }
      }
    }
    cp_async_wait();                           // this tile's V landed
    __syncthreads();                           // and every warp is done with K
    if (kt < kt_hi) load_tile<DH>(ks, k, b, k0 + kKeys, kvh, seq, K);
    cp_async_commit();

    if (sees) {
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        // A = P of keys 8j..8j+7, column t <- key 2t, column t + 4 <- 2t + 1
        uint32_t ph[4], pl[4];
        split2(s[j][0], ph[0], pl[0]);
        split2(s[j][2], ph[1], pl[1]);
        split2(s[j][1], ph[2], pl[2]);
        split2(s[j][3], ph[3], pl[3]);
        const float* vr = v_row + 8 * j * kS;
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          // keys 8j + 2t and 8j + 2t + 1, columns 16p + 2g and 16p + 2g + 1
          const float2 v0 = *reinterpret_cast<const float2*>(vr + 16 * p);
          const float2 v1 = *reinterpret_cast<const float2*>(vr + kS + 16 * p);
          uint32_t h0v[2], l0v[2], z0v[2], h1v[2], l1v[2], z1v[2];
          split3(v0.x, h0v[0], l0v[0], z0v[0]);
          split3(v0.y, h0v[1], l0v[1], z0v[1]);
          split3(v1.x, h1v[0], l1v[0], z1v[0]);
          split3(v1.y, h1v[1], l1v[1], z1v[1]);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma(acc[p][n], pl, h0v[n], h1v[n]);
            mma(acc[p][n], ph, z0v[n], z1v[n]);
            mma(acc[p][n], ph, l0v[n], l1v[n]);
            mma(acc[p][n], ph, h0v[n], h1v[n]);
          }
        }
      }
    }
  }

  if (code >= 0) {
    // one half of a split range: state to scratch, the later half merges
    constexpr int kState = DH / 2 + 4;
    float* mine = scratch + (static_cast<size_t>(code) * per + rest) * kState * kThreads +
                  threadIdx.x;
    const float* other = scratch +
                         (static_cast<size_t>(code ^ 1) * per + rest) * kState * kThreads +
                         threadIdx.x;
#pragma unroll
    for (int p = 0; p < kPairs; ++p)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[((p * 2 + n) * 4 + e) * kThreads] = acc[p][n][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mine[(DH / 2 + r) * kThreads] = m[r];
      mine[(DH / 2 + 2 + r) * kThreads] = l[r];
    }
    __shared__ int later;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) later = atomicAdd(&counts[(code >> 1) * per + rest], 1) == 1;
    __syncthreads();
    if (!later) return;
    __threadfence();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mo = __ldcg(other + (DH / 2 + r) * kThreads);
      const float lo = __ldcg(other + (DH / 2 + 2 + r) * kThreads);
      const float mt = fmaxf(m[r], mo);
      const float sm = expf(m[r] - mt), so = expf(mo - mt);
      l[r] = __fadd_rn(__fmul_rn(l[r], sm), __fmul_rn(lo, so));
#pragma unroll
      for (int p = 0; p < kPairs; ++p)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& a = acc[p][n][2 * r + c];
            const float ao = __ldcg(other + ((p * 2 + n) * 4 + 2 * r + c) * kThreads);
            a = __fadd_rn(__fmul_rn(a, sm), __fmul_rn(ao, so));
          }
    }
  }

  // l over the quad; row g + 8r holds columns 16p + 4t .. 16p + 4t + 3
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qpos = p0 + g + 8 * r;
    if (qpos >= seq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* out = o + ((static_cast<size_t>(b) * seq + qpos) * H + h) * DH + 4 * t;
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      float4 y;
      y.x = acc[p][0][2 * r] / den;
      y.y = acc[p][1][2 * r] / den;
      y.z = acc[p][0][2 * r + 1] / den;
      y.w = acc[p][1][2 * r + 1] / den;
      *reinterpret_cast<float4*>(out + 16 * p) = y;
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int seq, int H,
           int K, int window, const void* items, int n_items, int nh, void* scratch,
           void* counts, cudaStream_t stream) {
  using C = Cfg<DH>;
  const long long blocks = static_cast<long long>(n_items) * (H / nh) * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(swa_f32_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(DH)));
  const dim3 grid(static_cast<unsigned>(blocks), 1, 1);
  swa_f32_kernel<DH><<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), B, seq, H, K, window,
      static_cast<const int4*>(items), nh, static_cast<float*>(scratch),
      static_cast<int*>(counts), scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  float32 q, k, v, o, contiguous
// and 16-byte aligned; dh in {16, 32, 64, 128, 256}; H % K == 0; window >= 1.
// items: the plan's n_items (x, kt0, kt1, code) int32 quadruples, for
// blocks of nh query heads (a power of two dividing H / K, at most 8);
// scratch: (2 * pairs * (H / nh) * B) x (dh / 2 + 4) x 256 floats and
// counts: pairs * (H / nh) * B zeroed ints, where the plan splits ranges
// (else unused).  Returns the cudaError_t of the attribute call and the
// launch (0 on success).
extern "C" int swa_f32_launch(const void* q, const void* k, const void* v, void* o, int B,
                              int seq, int H, int K, int dh, int window, const void* items,
                              int n_items, int nh, void* scratch, void* counts,
                              void* stream) {
  if (B < 1 || seq < 1 || H < 1 || K < 1 || H % K != 0 || window < 1 || n_items < 1 ||
      nh < 1 || nh > 8 || (nh & (nh - 1)) != 0 || (H / K) % nh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch<16>(q, k, v, o, B, seq, H, K, window, items, n_items, nh,
                               scratch, counts, s);
    case 32: return launch<32>(q, k, v, o, B, seq, H, K, window, items, n_items, nh,
                               scratch, counts, s);
    case 64: return launch<64>(q, k, v, o, B, seq, H, K, window, items, n_items, nh,
                               scratch, counts, s);
    case 128: return launch<128>(q, k, v, o, B, seq, H, K, window, items, n_items, nh,
                                 scratch, counts, s);
    case 256: return launch<256>(q, k, v, o, B, seq, H, K, window, items, n_items, nh,
                                 scratch, counts, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* swa_f32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
