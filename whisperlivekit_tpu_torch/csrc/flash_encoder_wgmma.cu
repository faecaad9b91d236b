// Flash attention in bf16 for the Whisper encoder and the AlignAtt prefill
// cross-attention, on Hopper's tensor cores (sm_90a).
//
// Replaces whisperlivekit_tpu/ops/flash_encoder.py::flash_encoder_attn (the
// Pallas TPU kernel) for bf16, the serving dtype; f32 stays on the CUDA-core
// body of csrc/flash_encoder.cu. Same math as the reference: non-causal
// attention, f32 scores and softmax, key columns >= t_valid masked,
// probabilities rounded to bf16, P.V accumulated in f32, output in bf16.
//
// What bounds it on the H100: at the encoder's full window (S = T = 1500,
// Dh = 64) 4*S*T*Dh operations per (lane, head) against 2*(S+T)*Dh elements
// read, so the tensor cores (989 TFLOP/s bf16) bound it. At the prefill and
// refresh call sites (S = 8..384 over T = 1536) the K and V bytes bound it.
//
// Design: one block per (128 or 64 query rows, head, lane[, key split]).
// - A producer warpgroup keeps K and V tiles of 128 keys in flight in a ring
//   of three shared-memory buffers, signalled by mbarriers (full: tile
//   landed; empty: every consumer thread is done with it). Where the
//   strides allow (16-byte multiples), one thread issues TMA loads through
//   4-D tensor maps whose T extent is t_valid, so the hardware zero-fills
//   the keys past it. Otherwise (the dense [B,H,Dh,1500] cross-KV: rows of
//   3000 bytes) the 128 producer threads issue 8-byte cp.async copies into
//   the same swizzled layout, zero-filling past t_valid through the copy's
//   source size.
// - One or two consumer warpgroups each own 64 query rows. Q is read once,
//   rows >= S as zeros. S = Q.K^T is a wgmma (m64n128k16, k16 steps over
//   Dh) from shared memory; the online softmax runs in f32 on the
//   accumulator registers (a row's 128 scores live on 4 threads, reduced by
//   two shuffles); P is rounded to bf16 in registers and is the A operand of
//   the P.V wgmma (m64nDHk16), with V from shared memory. Each warpgroup
//   runs its products and its softmax in turn; the two warpgroups of a
//   block interleave, so one's exponentials overlap the other's products.
//   (Overlapping a warpgroup's own softmax with its next Q.K^T needs a
//   second score buffer, and ptxas then serializes the wgmmas.) At Dh = 64
//   the exponentials (one MUFU op per score, 16 per clock per SM) take as
//   long as the products, which caps this design near 40 % of the tensor
//   cores' peak.
// - Every tile is stored in 128-byte rows with the 128-byte swizzle, the
//   contiguous axis of device memory along the row. K and V come either
//   with Dh contiguous (the encoder's strided views of [B,T,H,Dh]) or with T
//   contiguous (the [B,H,Dh,T] cross-KV and its pool). Each product reads
//   its B operand K-major or MN-major through the descriptor's transpose
//   bit, so neither layout is copied: the kernel is templated on both.
// - When B*H*ceil(S/rows) blocks leave most SMs idle (small S over the pool),
//   the wrapper splits T across blocks; each split writes its normalized
//   partial output and log-sum-exp in f32, and flash_combine_kernel merges them.

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;   // query rows per consumer warpgroup (one wgmma M)
constexpr int BN = 128;  // keys per tile
constexpr int WG = 128;  // threads per warpgroup
constexpr int MAX_CONSUMERS = 2;

template <int DH>
struct Cfg {
  static constexpr int STAGES = 3;  // the producer runs up to two tiles ahead
  static constexpr int Q_BYTES = BM * DH * 2;     // one warpgroup's Q tile
  static constexpr int TILE_BYTES = BN * DH * 2;  // one K or V tile
  // 1024 bytes of slack to align the swizzled tiles, then the barriers
  static constexpr int SMEM =
      1024 + MAX_CONSUMERS * Q_BYTES + 2 * STAGES * TILE_BYTES + 2 * STAGES * 8;
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;       // [B,H,S,Dh], contiguous
  float* o_part; // [n_split, B*H, S, Dh] when T is split, else null
  float* lse;    // [n_split, B*H, S] (log2 domain) when T is split
  long long q_b, q_h, q_s;  // q element strides; Dh has unit stride
  long long k_b, k_h, k_r;  // k: lane, head, and the tile axis that is not unit-stride
  long long v_b, v_h, v_r;
  int H, S, t_valid, n_tiles, tiles_per_split, n_consumers, use_tma;
  float scale_log2;  // Dh^-0.5 * log2(e): the softmax runs on exp2
};

// ---- shared memory, barriers, copies ----------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) of an R-row tile whose c axis (the one
// contiguous in device memory) is cut into 64-element regions of R 128-byte
// rows, with the swizzle TMA's SWIZZLE_128B writes: 16-byte unit u of row r
// lands at u ^ (r % 8). Regions start on 1024-byte boundaries (R % 8 == 0).
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 6) * (R * 128) + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// 8 bytes global -> shared; bytes past src_bytes (0..8) are written as zeros
__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// generic-proxy writes to shared memory become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// ---- wgmma --------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle. lbo: K-major, unused
// (16); MN-major, the step between 64-element regions along M/N. sbo: the
// step between groups of 8 rows (1024 bytes here).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_D8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

#define WG_R32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_R64                                                                     \
  WG_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
         "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d[64] (+)= A[64x16] . B[16x128]: A (Q) K-major from shared memory, B (K)
// K-major (TB = 0) or MN-major (TB = 1) from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64 "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// d[DH/2] += P[64x16] . V[16xDH]: P (bf16 pairs) from registers, V K-major
// (TB = 0) or MN-major (TB = 1) from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even, as astype() does
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- producer -----------------------------------------------------------

// A K or V tile of keys n0..n0+127. T_UNIT: [DH rows d][BN columns t], else
// [BN rows t][DH columns d]; the map's axes are (contiguous, other, H, B).
template <int DH, bool T_UNIT>
__device__ __forceinline__ void tile_tma(const CUtensorMap* map, uint32_t dst, uint32_t bar, int n0,
                                         int h, int b) {
  if (T_UNIT) {
#pragma unroll
    for (int r = 0; r < BN / 64; ++r) tma_load_4d(dst + r * DH * 128, map, bar, n0 + 64 * r, 0, h, b);
  } else {
#pragma unroll
    for (int r = 0; r < DH / 64; ++r) tma_load_4d(dst + r * BN * 128, map, bar, 64 * r, n0, h, b);
  }
}

// The same tile by the 128 producer threads, 8 bytes each copy, keys past
// t_valid as zeros; src points at (lane, head), rs is the other axis' stride
template <int DH, bool T_UNIT>
__device__ __forceinline__ void tile_cpasync(uint32_t dst, const bf16* src, long long rs, int n0,
                                             int t_valid, int tid) {
  constexpr int R = T_UNIT ? DH : BN;
  constexpr int CH = (T_UNIT ? BN : DH) / 4;  // 8-byte chunks per row
#pragma unroll 4
  for (int i = tid; i < R * CH; i += WG) {
    const int r = i / CH, c = (i % CH) * 4;
    const bf16* g;
    int bytes;
    if (T_UNIT) {  // row r = d, column c = t - n0
      const int t = n0 + c;
      bytes = 2 * max(0, min(4, t_valid - t));
      g = src + r * rs + t;
    } else {  // row r = t - n0, column c = d
      const int t = n0 + r;
      bytes = t < t_valid ? 8 : 0;
      g = src + t * rs + c;
    }
    cp_async_8(dst + swz<R>(r, c), bytes ? g : src, bytes);
  }
}

template <int DH, bool K_T, bool V_T>
__device__ void produce(const CUtensorMap* k_map, const CUtensorMap* v_map, const Params& p,
                        uint32_t k_s, uint32_t v_s, uint32_t bar, int b, int h, int tile0, int tile1,
                        int tid) {
  using C = Cfg<DH>;
  int stage = 0;
  uint32_t phase = 0;
  if (p.use_tma) {
    if (tid != 0) return;
    for (int t = tile0; t < tile1; ++t) {
      mbar_wait(bar + 8 * (C::STAGES + stage), phase ^ 1);  // the consumers released it
      mbar_expect_tx(bar + 8 * stage, 2 * C::TILE_BYTES);
      tile_tma<DH, K_T>(k_map, k_s + stage * C::TILE_BYTES, bar + 8 * stage, t * BN, h, b);
      tile_tma<DH, V_T>(v_map, v_s + stage * C::TILE_BYTES, bar + 8 * stage, t * BN, h, b);
      if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
    }
    // do not leave while copies are in flight: wait until the last tiles are released
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_wait(bar + 8 * (C::STAGES + stage), phase ^ 1);
      if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
    }
    return;
  }
  // cp.async: the 128 threads copy a tile, wait for their own copies, make
  // them visible to wgmma and arrive; the consumers overlap the next copy
  const bf16* kb = p.k + b * p.k_b + h * p.k_h;
  const bf16* vb = p.v + b * p.v_b + h * p.v_h;
  for (int t = tile0; t < tile1; ++t) {
    mbar_wait(bar + 8 * (C::STAGES + stage), phase ^ 1);
    tile_cpasync<DH, K_T>(k_s + stage * C::TILE_BYTES, kb, p.k_r, t * BN, p.t_valid, tid);
    tile_cpasync<DH, V_T>(v_s + stage * C::TILE_BYTES, vb, p.v_r, t * BN, p.t_valid, tid);
    cp_async_commit();
    cp_async_wait_all();
    fence_proxy_async();
    mbar_arrive(bar + 8 * stage);
    if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
  }
}

// ---- consumer -----------------------------------------------------------

// S = Q.K^T of one tile into s, issued and committed (the caller waits):
// accumulator element 4j+2i+e is row r+8i, column 8j+2*quad+e
template <int DH, bool K_T>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t qw, uint32_t kt) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint64_t da = desc(qw + (kk / 4) * (BM * 128) + (kk % 4) * 32, 16, 1024);
    const uint64_t db = K_T ? desc(kt + kk * 2048, DH * 128, 1024)
                            : desc(kt + (kk / 4) * (BN * 128) + (kk % 4) * 32, 16, 1024);
    wgmma_qk<K_T ? 1 : 0>(s, da, db, kk > 0);
  }
  wg_commit();
}

// O += P.V with P rounded to bf16 in registers (the wgmma A fragment of
// keys 16kk..16kk+15 is S's accumulator elements 8kk..8kk+7); issued and
// committed (the caller waits). Packing each fragment just before its
// wgmma, rather than all before the fence, measured faster.
template <int DH, bool V_T>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2], const float (&s)[64], uint32_t vt) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(s[8 * kk + 0], s[8 * kk + 1]), pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                           pack_bf16(s[8 * kk + 4], s[8 * kk + 5]), pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
    const uint64_t db = V_T ? desc(vt + (kk / 4) * (DH * 128) + (kk % 4) * 32, 16, 1024)
                            : desc(vt + kk * 2048, BN * 128, 1024);
    wgmma_pv<V_T ? 0 : 1>(o, a, db);
  }
  wg_commit();
}

// The online softmax of one tile's scores, in place, in the log2 domain;
// columns >= t_valid score -inf. A row's 128 columns live on the 4 threads
// of a quad. Column n0 is always valid, so the row max is finite.
__device__ __forceinline__ void softmax_tile(float (&s)[64], int n0, int t_valid, int quad, float sl2,
                                             float (&m_run)[2], float (&l_run)[2], float (&alpha)[2]) {
  if (n0 + BN > t_valid) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (n0 + 8 * j + 2 * quad + e >= t_valid) s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[i], mx * sl2);
    alpha[i] = ex2(m_run[i] - m_new);
    m_run[i] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pv = ex2(fmaf(s[4 * j + 2 * i + e], sl2, -m_new));
        s[4 * j + 2 * i + e] = pv;
        sum += pv;
      }
    l_run[i] = l_run[i] * alpha[i] + sum;  // this thread's part; the quad is summed at the end
  }
}

template <int DH, bool K_T, bool V_T>
__device__ void consume(const Params& p, uint32_t q_s, uint32_t k_s, uint32_t v_s, uint32_t bar,
                        int wg, int b, int h, int tile0, int tile1, int tid) {
  using C = Cfg<DH>;
  const int m0 = blockIdx.x * (BM * p.n_consumers) + wg * BM;  // this warpgroup's first query row
  const uint32_t qw = q_s + wg * C::Q_BYTES;

  // Q once: 8-byte loads, rows >= S as zeros, swizzled like a TMA box
  const bf16* qb = p.q + b * p.q_b + h * p.q_h;
#pragma unroll 4
  for (int i = tid; i < BM * DH / 4; i += WG) {
    const int r = i / (DH / 4), c = (i % (DH / 4)) * 4;
    uint2 val = make_uint2(0u, 0u);
    if (m0 + r < p.S) val = *reinterpret_cast<const uint2*>(qb + (m0 + r) * p.q_s + c);
    asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(qw + swz<BM>(r, c)), "r"(val.x), "r"(val.y)
                 : "memory");
  }
  fence_proxy_async();
  named_bar_sync(1 + wg, WG);

  const int lane = tid % 32, quad = lane % 4;
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // rows r and r + 8

  int stage = 0;
  uint32_t phase = 0;
  for (int t = tile0; t < tile1; ++t) {
    mbar_wait(bar + 8 * stage, phase);
    float s[64];
    issue_qk<DH, K_T>(s, qw, k_s + stage * C::TILE_BYTES);
    wg_wait0();
    fence_regs(s);
    float alpha[2];
    softmax_tile(s, t * BN, p.t_valid, quad, p.scale_log2, m_run, l_run, alpha);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    fence_regs(o);
    issue_pv<DH, V_T>(o, s, v_s + stage * C::TILE_BYTES);
    wg_wait0();
    fence_regs(o);
    mbar_arrive(bar + 8 * (C::STAGES + stage));
    if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
  }

  const long long bh = static_cast<long long>(blockIdx.y);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = m0 + 16 * (tid / 32) + lane / 4 + 8 * i;
    if (row >= p.S) continue;
    const float inv = 1.f / l;
    if (p.o_part == nullptr) {
      bf16* orow = p.o + (bh * p.S + row) * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * quad) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
    } else {
      const long long prow = (static_cast<long long>(blockIdx.z) * gridDim.y + bh) * p.S + row;
      float* orow = p.o_part + prow * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * quad) =
            make_float2(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      if (quad == 0) p.lse[prow] = m_run[i] + __log2f(l);
    }
  }
}

template <int DH, bool K_T, bool V_T>
__global__ void __launch_bounds__(WG * (MAX_CONSUMERS + 1), 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map, const Params p) {
  using C = Cfg<DH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [MAX_CONSUMERS][Q_BYTES]
  const uint32_t k_s = q_s + MAX_CONSUMERS * C::Q_BYTES;        // [STAGES][TILE_BYTES]
  const uint32_t v_s = k_s + C::STAGES * C::TILE_BYTES;         // [STAGES][TILE_BYTES]
  const uint32_t bar = v_s + C::STAGES * C::TILE_BYTES;         // full[STAGES], empty[STAGES]

  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int tile0 = blockIdx.z * p.tiles_per_split;
  const int tile1 = min(tile0 + p.tiles_per_split, p.n_tiles);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar + 8 * s, p.use_tma ? 1 : WG);
      mbar_init(bar + 8 * (C::STAGES + s), p.n_consumers * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroups part here for good: the producer gives up registers that
  // the consumers' accumulators take
  if (wg == p.n_consumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    produce<DH, K_T, V_T>(&k_map, &v_map, p, k_s, v_s, bar, b, h, tile0, tile1, tid);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    consume<DH, K_T, V_T>(p, q_s, k_s, v_s, bar, wg, b, h, tile0, tile1, tid);
  }
}

// Merges the T splits of each output row (one warp per row): weights
// 2^(lse_i - max), partial outputs already normalized by their own sums.
template <int DH>
__global__ void __launch_bounds__(128)
flash_combine_kernel(const float* __restrict__ o_part, const float* __restrict__ lse, bf16* __restrict__ o,
               long long rows, int n_split) {
  const long long row = blockIdx.x * 4LL + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float mx = -INFINITY;
  for (int i = 0; i < n_split; ++i) mx = fmaxf(mx, lse[i * rows + row]);
  float wsum = 0.f, acc[DH / 32];
#pragma unroll
  for (int j = 0; j < DH / 32; ++j) acc[j] = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const float w = exp2f(lse[i * rows + row] - mx);
    wsum += w;
    const float* part = o_part + (i * rows + row) * DH;
#pragma unroll
    for (int j = 0; j < DH / 32; ++j) acc[j] = fmaf(w, part[lane + 32 * j], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < DH / 32; ++j) o[row * DH + lane + 32 * j] = __float2bfloat16(acc[j] / wsum);
}

// ---- host ---------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver the runtime already loaded,
// so the library links no -lcuda
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(sym);
  }
  return fn;
}

// A 4-D map (contiguous axis, other tile axis, H, B) over a K or V view with
// its T extent cut to t_valid: the hardware zero-fills the keys past it.
bool encode_tile_map(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, bool t_unit, int DH,
                     int H, int B, int t_valid, long long s_b, long long s_h, long long s_r) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(t_unit ? t_valid : DH),
                              static_cast<cuuint64_t>(t_unit ? DH : t_valid),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * s_r), static_cast<cuuint64_t>(2 * s_h),
                                 static_cast<cuuint64_t>(2 * s_b)};
  const cuuint32_t box[4] = {64u, static_cast<cuuint32_t>(t_unit ? DH : BN), 1u, 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH, bool K_T, bool V_T>
int launch(Params p, int B, int n_split, cudaStream_t stream) {
  using C = Cfg<DH>;
  CUtensorMap k_map, v_map;
  memset(&k_map, 0, sizeof(k_map));  // unused by the cp.async producer
  memset(&v_map, 0, sizeof(v_map));
  if (p.use_tma) {
    const EncodeTiledFn fn = encode_fn();
    if (fn == nullptr) return -3;
    if (!encode_tile_map(fn, &k_map, p.k, K_T, DH, p.H, B, p.t_valid, p.k_b, p.k_h, p.k_r) ||
        !encode_tile_map(fn, &v_map, p.v, V_T, DH, p.H, B, p.t_valid, p.v_b, p.v_h, p.v_r))
      return -2;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<DH, K_T, V_T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = BM * p.n_consumers;
  const dim3 grid((p.S + rows - 1) / rows, B * p.H, n_split);
  flash_wgmma_kernel<DH, K_T, V_T><<<grid, WG * (p.n_consumers + 1), C::SMEM, stream>>>(k_map, v_map, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  const long long out_rows = static_cast<long long>(B) * p.H * p.S;
  flash_combine_kernel<DH><<<static_cast<unsigned>((out_rows + 3) / 4), 128, 0, stream>>>(
      p.o_part, p.lse, p.o, out_rows, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code when a launch was refused, -1 for
// arguments the kernel does not take, -2 when the CUDA driver refused a
// tensor map, -3 when the CUDA driver has no cuTensorMapEncodeTiled. strides: 9 element
// strides, q (b, h, s), k (b, h, r), v (b, h, r), where r is the axis of
// the [Dh, T] pair that is not unit-stride. o_part and lse are the split
// scratch (null when n_split == 1).
int wlk_flash_wgmma(const void* q, const void* k, const void* v, void* o, void* o_part, void* lse,
                    int B, int H, int S, int Dh, int t_valid, int k_t_unit, int v_t_unit, int use_tma,
                    int n_split, int n_consumers, float scale, const long long* strides,
                    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || t_valid <= 0 || n_split <= 0) return -1;
  if (n_consumers < 1 || n_consumers > MAX_CONSUMERS) return -1;
  if (n_split > 1 && (o_part == nullptr || lse == nullptr)) return -1;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.o_part = n_split > 1 ? static_cast<float*>(o_part) : nullptr;
  p.lse = n_split > 1 ? static_cast<float*>(lse) : nullptr;
  p.q_b = strides[0]; p.q_h = strides[1]; p.q_s = strides[2];
  p.k_b = strides[3]; p.k_h = strides[4]; p.k_r = strides[5];
  p.v_b = strides[6]; p.v_h = strides[7]; p.v_r = strides[8];
  p.H = H;
  p.S = S;
  p.t_valid = t_valid;
  p.n_tiles = (t_valid + BN - 1) / BN;
  p.tiles_per_split = (p.n_tiles + n_split - 1) / n_split;
  if ((n_split - 1) * p.tiles_per_split >= p.n_tiles) return -1;  // an empty split
  p.n_consumers = n_consumers;
  p.use_tma = use_tma;
  p.scale_log2 = scale * 1.4426950408889634f;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WLK_LAUNCH(D, KT, VT) return launch<D, KT, VT>(p, B, n_split, s)
#define WLK_LAYOUTS(D)                                  \
  if (k_t_unit && v_t_unit) WLK_LAUNCH(D, true, true);  \
  if (k_t_unit) WLK_LAUNCH(D, true, false);             \
  if (v_t_unit) WLK_LAUNCH(D, false, true);             \
  WLK_LAUNCH(D, false, false)
  if (Dh == 64) { WLK_LAYOUTS(64); }
  if (Dh == 128) { WLK_LAYOUTS(128); }
#undef WLK_LAYOUTS
#undef WLK_LAUNCH
  return -1;
}

// Dynamic shared memory a block of the Dh = 64 or 128 kernel takes (bytes)
int wlk_flash_wgmma_smem_bytes(int Dh) {
  return Dh == 64 ? Cfg<64>::SMEM : Dh == 128 ? Cfg<128>::SMEM : -1;
}

const char* wlk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
