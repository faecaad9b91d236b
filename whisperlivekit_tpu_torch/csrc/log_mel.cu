// Fused log-mel front end, hand-written for Hopper (sm_90a).
//
// Replaces whisperlivekit_tpu/ops/mel_pallas.py::log_mel_pallas (the Pallas
// TPU kernel). Same result: for audio [B, N] f32, frame i of a lane is the
// 400 samples at 160 i - 200 (reflect-padded at both ends), and
//
//     out[b, m, i] = log10(max(sum_k |X_k(i)|^2 * filters[k, m], 1e-10))
//
// where X_k(i) is bin k (of 201) of the DFT of the Hann-windowed frame. The
// output is the encoder's [B, n_mels, N / 160] layout; the dynamic floor and
// the (x + 4) / 4 scaling need a maximum over a whole lane and stay outside.
//
// What bounds it on the H100: bytes. The TPU kernel's DFT by matrix product
// costs 2 * 400 * 402 FLOP a frame, an operations bound 17x the bytes bound
// (audio in, log-mel out: 23 MB, 6.9 us at 3.35 TB/s for 8 lanes of 30 s).
// An f32 FFT costs ~10 kFLOP a frame, under the bytes at the f32 rate.
// Tensor cores do not fit: TF32 keeps ~3 digits, and the 1e-4 bar on the
// log-mel holds quiet bins 80 dB under a lane's peak. As built it reaches
// ~30 % of the bytes bound at 8 lanes, held by latency rather than by its
// arithmetic: shared memory allows 4 blocks (64 frames) an SM, and each
// block's chain of copy, exchanges and barriers sets their pace.
//
// Design:
// - One block takes one lane's tile of 16 consecutive frames, so a single
//   30 s lane (3000 frames) makes 188 blocks: the card fills at the lane
//   counts the main path launches (1-2). Tiles of 32 measured no faster at
//   8 lanes.
// - Samples: a tile inside the lane whose rows are 16-byte aligned copies
//   its 15 * 160 + 400 contiguous samples with one bulk async copy
//   (cp.async.bulk onto an mbarrier) while the block stages the mel tables;
//   edge tiles and unaligned lanes load by index with numpy's reflection.
//   The launch plan (ops/mel_pallas.py k3_plan) names the bulk tiles.
// - Two real frames (2p, 2p + 1) form one complex sequence z = x_a + i x_b
//   (the Hann window applied as the samples are read; an odd last frame
//   gets a zero partner). 400 = 20 x 20: 20 threads per pair; in stage 1
//   thread n2 takes the 20-point DFT of z[20 n1 + n2] over n1 in registers
//   (prime-factor 4 x 5: radix-4 and radix-5 butterflies, no twiddles, the
//   index maps fixed at compile time), multiplies by W400^(n2 k1) and writes
//   it to shared memory; in stage 2 thread k1 takes the 20-point DFT over
//   n2, giving Z[k1 + 20 k2]. The exchange planes use a row stride
//   of 25 and a pair stride of 500 (= 20 mod 32), so both the stage-1 writes
//   and the stage-2 reads hit 32 distinct banks.
// - X_a[k] = (Z[k] + conj Z[-k]) / 2 and X_b[k] = (Z[k] - conj Z[-k]) / 2i,
//   from stage 2's registers and the partner bin read back from shared
//   memory: the power of the 201 bins of both frames goes to shared memory
//   (bin-major rows over the samples, which are spent) and never reaches
//   device memory.
// - A thread sums one mel filter for 4 frames over the filter's nonzero
//   bins only (16-byte power reads, weights compacted in shared memory);
//   log10 goes out in stores coalesced along T.
// All constants (window, twiddles) come from the wrapper's table, computed
// in float64 and rounded once; nothing is evaluated with sincos here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HOP = 160;
constexpr int N_FFT = 400;
constexpr int PAD = N_FFT / 2;            // reflect padding at each end
constexpr int BINS = N_FFT / 2 + 1;       // 201
constexpr int R = 20;                     // 400 = R x R
constexpr int EX_ROW = 25;                // exchange row stride: odd, = 1 (mod 8)
constexpr int EX_PAIR = 500;              // exchange pair stride: >= R * EX_ROW, = 20 (mod 32)
constexpr int MEL_MAX = 128;
constexpr int W_MAX = 512;                // compacted filterbank weights
// the wrapper's table (floats): window, W400^(n2 k1) [k1][n2], radix-5 constants
constexpr int TAB_WIN = 0, TAB_TW = 400, TAB_R5 = 1200;

constexpr int FRAMES = 16;                // frames per tile (block); k3_plan's K3_FRAMES
constexpr int PAIRS = FRAMES / 2;
constexpr int THREADS = PAIRS * R;        // 160
constexpr int SAMPLES = (FRAMES - 1) * HOP + N_FFT;
constexpr int PROW = FRAMES + 4;          // power row of one bin: the tile's frames, padded
constexpr int SP = SAMPLES > BINS * PROW ? SAMPLES : BINS * PROW;
// shared memory (floats): mbarrier slot, samples | power, exchange re | im,
// mel weights, mel index
constexpr int OFF_SP = 4;
constexpr int OFF_RE = OFF_SP + (SP + 3) / 4 * 4;
constexpr int OFF_IM = OFF_RE + PAIRS * EX_PAIR;
constexpr int OFF_W = OFF_IM + PAIRS * EX_PAIR;
constexpr int OFF_IDX = OFF_W + W_MAX;
constexpr int SMEM = 4 * (OFF_IDX + 4 * MEL_MAX);

static_assert(R * EX_ROW <= EX_PAIR && EX_PAIR % 32 == 20 && EX_ROW % 8 == 1, "bank-free exchange");
static_assert((SAMPLES * 4) % 16 == 0 && (OFF_SP * 4) % 16 == 0, "bulk copy: 16-byte multiples");
static_assert(PROW % 4 == 0 && OFF_IDX % 4 == 0, "16-byte power rows and index entries");

struct R5 {  // cos(2pi/5), sin(2pi/5), cos(4pi/5), sin(4pi/5)
  float c1, s1, c2, s2;
};

__device__ __forceinline__ long long reflect(long long i, long long n) {
  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  const long long per = 2 * (n - 1);  // numpy's repeated reflection
  i %= per;
  if (i < 0) i += per;
  return i < n ? i : per - i;
}

__device__ __forceinline__ void cmul(float& re, float& im, float2 w) {
  const float r = re * w.x - im * w.y;
  im = re * w.y + im * w.x;
  re = r;
}

// 20-point DFT y[k] = sum_n x[n] W20^(nk), in registers, by the prime-factor
// map (4 and 5 are coprime): n = (5 n1 + 4 n2) mod 20, k = (5 k1 + 16 k2)
// mod 20 make W20^(nk) = W4^(n1 k1) W5^(n2 k2), so a radix-4 over n1 then a
// radix-5 over n2 need no twiddles between them
__device__ __forceinline__ void dft20(const float (&xr)[R], const float (&xi)[R], float (&yr)[R],
                                      float (&yi)[R], const R5& c) {
  float ar[5][4], ai[5][4];
#pragma unroll
  for (int n2 = 0; n2 < 5; ++n2) {
    const int i0 = (4 * n2) % R, i1 = (5 + 4 * n2) % R, i2 = (10 + 4 * n2) % R, i3 = (15 + 4 * n2) % R;
    const float t0r = xr[i0] + xr[i2], t0i = xi[i0] + xi[i2];
    const float t1r = xr[i0] - xr[i2], t1i = xi[i0] - xi[i2];
    const float t2r = xr[i1] + xr[i3], t2i = xi[i1] + xi[i3];
    const float t3r = xr[i1] - xr[i3], t3i = xi[i1] - xi[i3];
    ar[n2][0] = t0r + t2r; ai[n2][0] = t0i + t2i;
    ar[n2][1] = t1r + t3i; ai[n2][1] = t1i - t3r;
    ar[n2][2] = t0r - t2r; ai[n2][2] = t0i - t2i;
    ar[n2][3] = t1r - t3i; ai[n2][3] = t1i + t3r;
  }
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    const float x0r = ar[0][k1], x0i = ai[0][k1];
    const float t1r = ar[1][k1] + ar[4][k1], t1i = ai[1][k1] + ai[4][k1];
    const float t2r = ar[2][k1] + ar[3][k1], t2i = ai[2][k1] + ai[3][k1];
    const float t3r = ar[1][k1] - ar[4][k1], t3i = ai[1][k1] - ai[4][k1];
    const float t4r = ar[2][k1] - ar[3][k1], t4i = ai[2][k1] - ai[3][k1];
    const float a1r = x0r + c.c1 * t1r + c.c2 * t2r, a1i = x0i + c.c1 * t1i + c.c2 * t2i;
    const float a2r = x0r + c.c2 * t1r + c.c1 * t2r, a2i = x0i + c.c2 * t1i + c.c1 * t2i;
    const float b1r = c.s1 * t3r + c.s2 * t4r, b1i = c.s1 * t3i + c.s2 * t4i;
    const float b2r = c.s2 * t3r - c.s1 * t4r, b2i = c.s2 * t3i - c.s1 * t4i;
    const int o = 5 * k1;  // y[(5 k1 + 16 k2) mod 20], k2 = 0..4
    yr[o % R] = x0r + t1r + t2r;          yi[o % R] = x0i + t1i + t2i;
    yr[(o + 16) % R] = a1r + b1i;         yi[(o + 16) % R] = a1i - b1r;
    yr[(o + 32) % R] = a2r + b2i;         yi[(o + 32) % R] = a2i - b2r;
    yr[(o + 48) % R] = a2r - b2i;         yi[(o + 48) % R] = a2i + b2r;
    yr[(o + 64) % R] = a1r - b1i;         yi[(o + 64) % R] = a1i + b1r;
  }
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

// grid (tiles, B); out [B, n_mels, T] with T = N / 160
__global__ void __launch_bounds__(THREADS, 4)
log_mel_kernel(const float* __restrict__ audio, const float* __restrict__ tab,
               const float* __restrict__ mel_w, const int* __restrict__ mel_idx,
               float* __restrict__ out, int N, int T, int n_mels, int n_w, int bulk_lo, int bulk_hi) {
  extern __shared__ __align__(128) float smem[];
  float* samp = smem + OFF_SP;   // [SAMPLES], later the power rows [BINS][PROW]
  float* power = samp;
  float* ex_re = smem + OFF_RE;  // [PAIRS][EX_PAIR]
  float* ex_im = smem + OFF_IM;
  float* s_w = smem + OFF_W;
  int* s_idx = reinterpret_cast<int*>(smem + OFF_IDX);  // [n_mels][4]
  const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int f0 = tile * FRAMES;
  const int nf = min(FRAMES, T - f0);
  const float* x = audio + static_cast<size_t>(b) * N;
  const long long first = static_cast<long long>(f0) * HOP - PAD;
  const bool bulk = tile >= bulk_lo && tile < bulk_hi;

  if (bulk) {
    if (tid == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                   "r"(SAMPLES * 4)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
              static_cast<uint32_t>(__cvta_generic_to_shared(samp))),
          "l"(x + first), "r"(SAMPLES * 4), "r"(bar)
          : "memory");
    }
  } else {
    const int n_samp = (nf - 1) * HOP + N_FFT;
    for (int s = tid; s < n_samp; s += THREADS) samp[s] = __ldg(x + reflect(first + s, N));
  }
  for (int i = tid; i < n_w; i += THREADS) s_w[i] = __ldg(mel_w + i);
  for (int i = tid; i < 4 * n_mels; i += THREADS) s_idx[i] = __ldg(mel_idx + i);
  R5 c;
  c.c1 = __ldg(tab + TAB_R5);
  c.s1 = __ldg(tab + TAB_R5 + 1);
  c.c2 = __ldg(tab + TAB_R5 + 2);
  c.s2 = __ldg(tab + TAB_R5 + 3);
  __syncthreads();  // the mbarrier's init is visible before anyone waits on it
  if (bulk) mbar_wait(bar, 0);

  const int p = tid / R;  // frame pair (2p, 2p + 1) of the tile
  const int j = tid % R;
  float xr[R], xi[R], yr[R], yi[R];
  {  // stage 1: thread j = n2 transforms z[20 n1 + n2] over n1
    const bool has_a = 2 * p < nf, has_b = 2 * p + 1 < nf;
    const float* sa = samp + 2 * p * HOP;
#pragma unroll
    for (int n1 = 0; n1 < R; ++n1) {
      const int n = R * n1 + j;
      const float w = __ldg(tab + TAB_WIN + n);
      xr[n1] = has_a ? w * sa[n] : 0.f;
      xi[n1] = has_b ? w * sa[HOP + n] : 0.f;
    }
    dft20(xr, xi, yr, yi, c);
    const float2* tw = reinterpret_cast<const float2*>(tab + TAB_TW);
#pragma unroll
    for (int k1 = 0; k1 < R; ++k1) {
      cmul(yr[k1], yi[k1], __ldg(tw + k1 * R + j));
      ex_re[p * EX_PAIR + k1 + EX_ROW * j] = yr[k1];
      ex_im[p * EX_PAIR + k1 + EX_ROW * j] = yi[k1];
    }
  }
  __syncthreads();
  {  // stage 2: thread j = k1 transforms over n2, giving Z[k1 + 20 k2]
#pragma unroll
    for (int n2 = 0; n2 < R; ++n2) {
      xr[n2] = ex_re[p * EX_PAIR + j + EX_ROW * n2];
      xi[n2] = ex_im[p * EX_PAIR + j + EX_ROW * n2];
    }
    dft20(xr, xi, yr, yi, c);
  }
  __syncthreads();  // every read of the exchange planes is done: Z goes over them
#pragma unroll
  for (int k2 = 0; k2 < R; ++k2) {
    ex_re[p * EX_PAIR + j + R * k2] = yr[k2];
    ex_im[p * EX_PAIR + j + R * k2] = yi[k2];
  }
  __syncthreads();
  // split the pair: thread j holds Z[k] for k = j + 20 k2 and reads Z[-k];
  // the power of bin k of both frames goes to row k
#pragma unroll
  for (int k2 = 0; k2 <= BINS / R; ++k2) {
    const int k = j + R * k2;
    if (k < BINS) {
      const int km = k ? N_FFT - k : 0;
      const float zr = yr[k2], zi = yi[k2];
      const float wr = ex_re[p * EX_PAIR + km], wi = ex_im[p * EX_PAIR + km];
      const float ar = 0.5f * (zr + wr), ai = 0.5f * (zi - wi);  // X_a = (Z + conj W) / 2
      const float br = 0.5f * (zi + wi), bi = 0.5f * (wr - zr);  // X_b = (Z - conj W) / 2i
      *reinterpret_cast<float2*>(power + k * PROW + 2 * p) =
          make_float2(ar * ar + ai * ai, br * br + bi * bi);
    }
  }
  __syncthreads();

  // mel projection: a thread takes 4 consecutive frames of one mel, over
  // the filter's nonzero bins; consecutive threads, consecutive frames
  constexpr int G = FRAMES / 4;
  const bool vec_out = T % 4 == 0;  // 16-byte aligned output rows
  for (int i = tid; i < n_mels * G; i += THREADS) {
    const int m = i / G, f = 4 * (i % G);
    if (f >= nf) continue;
    const int4 ix = reinterpret_cast<const int4*>(s_idx)[m];  // first bin, last + 1, offset
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = ix.x; k < ix.y; ++k) {
      const float w = s_w[ix.z + k - ix.x];
      const float4 pw = *reinterpret_cast<const float4*>(power + k * PROW + f);
      acc.x = fmaf(pw.x, w, acc.x);
      acc.y = fmaf(pw.y, w, acc.y);
      acc.z = fmaf(pw.z, w, acc.z);
      acc.w = fmaf(pw.w, w, acc.w);
    }
    const float4 lg = make_float4(log10f(fmaxf(acc.x, 1e-10f)), log10f(fmaxf(acc.y, 1e-10f)),
                                  log10f(fmaxf(acc.z, 1e-10f)), log10f(fmaxf(acc.w, 1e-10f)));
    float* o = out + (static_cast<size_t>(b) * n_mels + m) * T + f0 + f;
    if (vec_out && f + 4 <= nf) {
      *reinterpret_cast<float4*>(o) = lg;
    } else {
      o[0] = lg.x;
      if (f + 1 < nf) o[1] = lg.y;
      if (f + 2 < nf) o[2] = lg.z;
      if (f + 3 < nf) o[3] = lg.w;
    }
  }
}

}  // namespace

extern "C" {

// audio [B, N] f32; tab the f32 constants (window, twiddles); mel_w [n_w]
// f32 and mel_idx [n_mels, 4] int32 (first bin, last bin + 1, offset into
// mel_w, 0) the compacted filterbank; out [B, n_mels, N / 160] f32; all
// contiguous on the device of `stream`. tiles and [bulk_lo, bulk_hi) are
// ops/mel_pallas.py k3_plan's, checked here against this file's tile of
// FRAMES frames. Returns 0 on success, a cudaError_t code when the launch
// was refused, or -1 for arguments the kernel does not take.
int wlk_log_mel(const float* audio, const float* tab, const float* mel_w, const int* mel_idx,
                float* out, int B, int N, int n_mels, int n_w, int tiles, int bulk_lo, int bulk_hi,
                void* stream) {
  const int T = N / HOP;
  if (B <= 0 || B > 65535 || T <= 0 || n_mels <= 0 || n_mels > MEL_MAX || n_w < 0 || n_w > W_MAX)
    return -1;
  if (tiles != (T + FRAMES - 1) / FRAMES) return -1;
  if (bulk_hi > bulk_lo) {  // bulk tiles: whole, inside the lane, 16-byte aligned
    if (N % 4 != 0 || reinterpret_cast<uintptr_t>(audio) % 16 != 0) return -1;
    if (bulk_lo < 0 || static_cast<long long>(bulk_lo) * FRAMES * HOP < PAD) return -1;
    if (static_cast<long long>(bulk_hi) * FRAMES > T) return -1;
    if ((static_cast<long long>(bulk_hi) * FRAMES - 1) * HOP + PAD > N) return -1;
  }
  cudaError_t err = cudaFuncSetAttribute(log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  log_mel_kernel<<<dim3(tiles, B), THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      audio, tab, mel_w, mel_idx, out, N, T, n_mels, n_w, bulk_lo, bulk_hi);
  return static_cast<int>(cudaGetLastError());
}

const char* wlk_log_mel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
