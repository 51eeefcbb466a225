// Hopper (sm_90a) tensor-core kernel for causal sliding-window attention
// with grouped KV heads, bfloat16 in and out: q (B, T, H, dh), k/v
// (B, T, K, dh) -> o (B, T, H, dh), dh in {64, 128, 256}.  Query position
// t attends to the keys s with t - W < s <= t; query head h reads KV head
// h / (H / K).  Scores, softmax statistics and the output accumulator are
// float32; the probabilities enter the P V product as two bfloat16 terms,
// hi + lo, so P keeps ~16 significant bits.  P rounded to one bf16 term
// (8 bits) misses the elementwise bound 1e-3 + 1e-2 |o| in rows that see
// few keys, where a 2^-9 error of each weight does not average out; the
// second term costs a second P V product, half as many flops again.
//
// Replaces the Pallas TPU kernel swa_attention_pallas (_swa_kernel) in
// src/repro/kernels/swa_attention.py for bfloat16 inputs at those head
// dims; float32 inputs and dh 16 / 32 keep the CUDA-core kernel in
// swa_attention.cu.  As there, one block loops itself over exactly the
// 64-key tiles its rows can see, from max(0, q0 - W + 1) / 64 to the tile
// of its last row, and the online-softmax state stays in registers.
//
// What bounds it on an H100: operations.  Each visible (q, k) pair costs
// 4 * dh flops (6 * dh as computed here, with the P_lo term); at
// gemma3-4b's prefill (T 2048, W 1024, dh 256) that is ~500 flops per byte
// of q, k, v and o, above the bf16 ridge of ~295.  So every flop runs on
// the tensor cores (wgmma), operands arrive by TMA without register or
// instruction cost, and the mask is paid only where a tile crosses the
// band's edge.
//
//   block    384 threads: warpgroups 0 and 1 consume (wgmma, softmax),
//            warpgroup 2 produces (one thread issues TMA); setmaxnreg
//            moves registers from the producer (24) to the consumers (240).
//   slots    each consumer owns 64 query rows of one head.  When H / K is
//            even the two consumers hold two query heads of one KV group
//            at the same 64 positions, so they see the same KV tiles and
//            each tile is loaded once for both; otherwise they hold rows
//            q0 and q0 + 64 of one head and each skips the tiles of the
//            union range that it cannot see.
//   shared   Q of both slots (loaded once) and a ring of kStages K/V tile
//            pairs (64 keys x dh each), all as 64-column boxes of 128-byte
//            rows with the 128-byte swizzle that TMA writes and wgmma
//            reads; per stage, mbarriers k_full / v_full (TMA bytes landed)
//            and k_empty / v_empty (the eight consumer warps are done with
//            K after Q K^T, with V after P V).  At dh 256:
//            64 KB of Q + 2 x 64 KB of K/V.
//   tensors  4-D TMA maps (dh, heads, T, B) with 64 x 1 x 64 x 1 boxes, so
//            rows past T (a ragged last tile, a window edge before 0) read
//            as zeros and never as the next batch row.
//   per tile S = Q K^T: wgmma m64n64k16, Q and K from shared memory, both
//            K-major.  Interior tiles take S as is; the diagonal tile
//            (also the ragged end tile) and the window's lower-edge tile
//            set hidden entries to -inf.  Online softmax in base 2 with scale *
//            log2(e) folded in; row maxima by the quad shuffle of the
//            accumulator layout.  O += P_hi V + P_lo V: wgmma m64n64k16
//            per 64-column chunk of dh, P from registers (the S accumulator
//            converted to bf16x2 is already the A fragment), V from shared
//            memory as stored, MN-major, through the transpose bit.
//   epilogue o = O / max(l, 1e-30) with l quad-summed, bf16, stored from
//            registers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRows = 64;         // query rows per consumer warpgroup
constexpr int kKeys = 64;         // keys per KV tile
constexpr int kBox = 64;          // dh columns per TMA box (128 bytes)
constexpr int kBoxBytes = kRows * kBox * 2;   // 8 KB, one 64 x 64 bf16 box
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kConsumerWarps = kConsumers * 4;

template <int DH> struct Cfg {
  static constexpr int kStages = DH == 256 ? 2 : 4;
  static constexpr int kChunks = DH / kBox;                  // boxes per tile
  static constexpr int kTileBytes = kRows * DH * 2;          // Q, K or V tile
  static constexpr int kQOff = 0;
  static constexpr int kKOff = kQOff + kConsumers * kTileBytes;
  static constexpr int kVOff = kKOff + kStages * kTileBytes;
  static constexpr int kBarOff = kVOff + kStages * kTileBytes;
  // q_full, then per stage k_full, v_full, k_empty, v_empty; + 1024 to
  // align the base
  static constexpr size_t kSmem = kBarOff + 8 * (1 + 4 * kStages) + 1024;
};

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One 64 x 64 bf16 box of a (dh, heads, T, B) tensor into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  lbo/sbo in bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma issue and wait.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define WG_D32                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "     \
  "%30, %31}"
#define WG_OUT32(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),    \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),             \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),             \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),             \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), both from shared memory,
// K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : WG_OUT32(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) B (16 x 64), B from
// shared memory MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// (x0, x1) = hi + lo with hi = bf16(x) and lo = bf16(x - hi), each a
// bf16x2 with x0 in the low half: ~16 significant bits of x in two terms.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The visible KV tiles of 64 query rows from q0: [lo, hi], empty if q0 >= T.
__device__ __forceinline__ void tile_range(int q0, int seq, int w, int& lo, int& hi) {
  if (q0 >= seq) { lo = 1; hi = 0; return; }
  lo = max(0, q0 - w + 1) / kKeys;
  hi = (min(q0 + kRows, seq) - 1) / kKeys;
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
swa_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 __nv_bfloat16* __restrict__ o, int seq, int H, int K, int window,
                 int pair_heads) {
  using C = Cfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t q_full = base + C::kBarOff;
  const uint32_t k_full = q_full + 8;                 // + 8 * stage
  const uint32_t v_full = k_full + 8 * C::kStages;
  const uint32_t k_empty = v_full + 8 * C::kStages;
  const uint32_t v_empty = k_empty + 8 * C::kStages;

  // blockIdx.x walks (head block, batch row) fastest and blockIdx.y the
  // query tiles from the last: the tiles with the most visible keys (all
  // of the window, or the longest causal prefix) start first, the short
  // ones fill in behind them
  const int head_blocks = pair_heads ? H / kConsumers : H;
  const int hb = blockIdx.x % head_blocks, b = blockIdx.x / head_blocks;
  const int tile = gridDim.y - 1 - blockIdx.y;
  const int group = H / K;
  int head[kConsumers], q0[kConsumers];
#pragma unroll
  for (int s = 0; s < kConsumers; ++s) {
    head[s] = pair_heads ? kConsumers * hb + s : hb;
    q0[s] = pair_heads ? tile * kRows : (tile * kConsumers + s) * kRows;
  }
  const int kvh = head[0] / group;
  const int w = window < seq ? window : seq;
  int lo[kConsumers], hi[kConsumers];
#pragma unroll
  for (int s = 0; s < kConsumers; ++s) tile_range(q0[s], seq, w, lo[s], hi[s]);
  const int kt_lo = lo[0];                         // slot 0 is never empty
  const int kt_hi = hi[1] >= lo[1] ? max(hi[0], hi[1]) : hi[0];
  const int n_tiles = kt_hi - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kConsumerWarps);
      mbar_init(v_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      // a slot past the sequence (the second one, rows q0 + 64) stays unloaded
      const int n_q = q0[1] < seq ? 2 : 1;
      mbar_expect_tx(q_full, n_q * C::kTileBytes);
      for (int s = 0; s < n_q; ++s)
        for (int c = 0; c < C::kChunks; ++c)
          tma_load(base + C::kQOff + s * C::kTileBytes + c * kBoxBytes, &qmap,
                   q_full, c * kBox, head[s], q0[s], b);
      // K of a stage frees after Q K^T, V after P V: K_i waits for the
      // scores of tile i - kStages, V_i for its output update
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % C::kStages;
        const uint32_t par = ((i / C::kStages) & 1) ^ 1;
        const int k0 = (kt_lo + i) * kKeys;
        mbar_wait(k_empty + 8 * st, par);
        mbar_expect_tx(k_full + 8 * st, C::kTileBytes);
        for (int c = 0; c < C::kChunks; ++c)
          tma_load(base + C::kKOff + st * C::kTileBytes + c * kBoxBytes, &kmap,
                   k_full + 8 * st, c * kBox, kvh, k0, b);
        mbar_wait(v_empty + 8 * st, par);
        mbar_expect_tx(v_full + 8 * st, C::kTileBytes);
        for (int c = 0; c < C::kChunks; ++c)
          tma_load(base + C::kVOff + st * C::kTileBytes + c * kBoxBytes, &vmap,
                   v_full + 8 * st, c * kBox, kvh, k0, b);
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = 16 * warp + lane / 4;       // rows r0 and r0 + 8
    const int qa = wg ? q0[1] : q0[0], qpos0 = qa + r0, qpos1 = qpos0 + 8;
    const int my_lo = wg ? lo[1] : lo[0], my_hi = wg ? hi[1] : hi[0];
    const float sl2 = rsqrtf(static_cast<float>(DH)) * 1.4426950408889634f;
    const float kNegInf = -INFINITY;

    float acc[C::kChunks][32];
#pragma unroll
    for (int n = 0; n < C::kChunks; ++n)
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[n][j] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    const uint32_t qs = base + C::kQOff + wg * C::kTileBytes;
    mbar_wait(q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % C::kStages;
      const uint32_t par = (i / C::kStages) & 1;
      const int kt = kt_lo + i;
      mbar_wait(k_full + 8 * st, par);
      if (kt < my_lo || kt > my_hi) {
        // a tile of the other slot's range (rows q0 and q0 + 64 of one head)
        mbar_wait(v_full + 8 * st, par);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(k_empty + 8 * st);
          mbar_arrive(v_empty + 8 * st);
        }
        continue;
      }
      const uint32_t ks = base + C::kKOff + st * C::kTileBytes;
      const uint32_t vs = base + C::kVOff + st * C::kTileBytes;
      float s[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        const uint32_t off = (j / 4) * kBoxBytes + (j % 4) * 32;
        wgmma_ss(s, desc(qs + off, 16, 1024), desc(ks + off, 16, 1024), j > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty + 8 * st);

      // mask only the tiles that cross the diagonal or the window's lower
      // edge; the ragged end tile (keys past T) is always the diagonal one
      const int k0 = kt * kKeys;
      const bool interior = k0 + kKeys - 1 <= qa && k0 >= qa + kRows - w;
      if (!interior) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int qp = (j & 2) ? qpos1 : qpos0;
          const int kp = k0 + (j / 4) * 8 + 2 * (lane % 4) + (j & 1);
          if (kp > qp || kp <= qp - w) s[j] = kNegInf;
        }
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (j & 2) mx1 = fmaxf(mx1, s[j]);
        else mx0 = fmaxf(mx0, s[j]);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
      const float mu0 = mn0 == kNegInf ? 0.f : mn0;   // no visible key yet
      const float mu1 = mn1 == kNegInf ? 0.f : mn1;
      const float c0 = exp2f(m0 - mu0), c1 = exp2f(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (j & 2) { s[j] = exp2f(fmaf(s[j], sl2, -mu1)); sum1 += s[j]; }
        else { s[j] = exp2f(fmaf(s[j], sl2, -mu0)); sum0 += s[j]; }
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
      // P = hi + lo, two bf16 A fragments: the accumulator layout of S
      // is the A fragment layout of P V
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1], p_hi[kk][e], p_lo[kk][e]);
#pragma unroll
      for (int n = 0; n < C::kChunks; ++n) {
#pragma unroll
        for (int j = 0; j < 32; ++j) acc[n][j] *= (j & 2) ? c1 : c0;
        fence_regs(acc[n]);
      }
      mbar_wait(v_full + 8 * st, par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int n = 0; n < C::kChunks; ++n) {
          const uint64_t vd = desc(vs + n * kBoxBytes + kk * 16 * 128, 8192, 1024);
          wgmma_rs(acc[n], p_hi[kk], vd);
          wgmma_rs(acc[n], p_lo[kk], vd);
        }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int n = 0; n < C::kChunks; ++n) fence_regs(acc[n]);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty + 8 * st);
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    const int h = wg ? head[1] : head[0];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qp = half ? qpos1 : qpos0;
      if (qp >= seq) continue;
      const float inv = half ? inv1 : inv0;
      __nv_bfloat16* out = o + ((static_cast<size_t>(b) * seq + qp) * H + h) * DH;
#pragma unroll
      for (int n = 0; n < C::kChunks; ++n)
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int j = 4 * g + 2 * half;
          const int col = n * kBox + 8 * g + 2 * (lane % 4);
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(acc[n][j] * inv, acc[n][j + 1] * inv);
        }
    }
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

// A (dh, heads, T, B) bf16 tensor map with 64 x 1 x 64 x 1 boxes and the
// 128-byte swizzle; rows out of range read as zeros.
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int seq,
                  int heads, int dh) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(dh) * 2,
                                 static_cast<cuuint64_t>(heads) * dh * 2,
                                 static_cast<cuuint64_t>(seq) * heads * dh * 2};
  const cuuint32_t box[4] = {kBox, 1, kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int seq, int H,
           int K, int window, cudaStream_t stream) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qm, km, vm;
  CUresult r = make_map(enc, &qm, q, B, seq, H, DH);
  if (r == CUDA_SUCCESS) r = make_map(enc, &km, k, B, seq, K, DH);
  if (r == CUDA_SUCCESS) r = make_map(enc, &vm, v, B, seq, K, DH);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  const size_t bytes = Cfg<DH>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(swa_wgmma_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pair = (H / K) % kConsumers == 0;
  const int rows = pair ? kRows : kConsumers * kRows;
  const long long blocks = static_cast<long long>(pair ? H / kConsumers : H) * B;
  const int tiles = (seq + rows - 1) / rows;
  if (blocks > 0x7fffffff || tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), tiles, 1);
  swa_wgmma_kernel<DH><<<grid, kThreads, bytes, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), seq, H, K, window, pair);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  bfloat16 q, k, v, o, contiguous
// and 16-byte aligned; dh in {64, 128, 256}; H % K == 0; window >= 1.
// Returns 0 on success, a cudaError_t of the attribute call or the launch,
// or minus the CUresult of a failed tensor-map encoding.
extern "C" int swa_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                                int B, int seq, int H, int K, int dh, int window,
                                void* stream) {
  if (B < 1 || seq < 1 || H < 1 || K < 1 || H % K != 0 || window < 1 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64: return launch<64>(q, k, v, o, B, seq, H, K, window, s);
    case 128: return launch<128>(q, k, v, o, B, seq, H, K, window, s);
    case 256: return launch<256>(q, k, v, o, B, seq, H, K, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* swa_wgmma_error_string(int err) {
  if (err < 0) return "cuTensorMapEncodeTiled failed (CUresult = -err)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
