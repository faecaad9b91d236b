// Fused log-mel front end, hand-written for Hopper (sm_90a).
//
// Replaces whisperlivekit_tpu/ops/mel_pallas.py::log_mel_pallas (the Pallas
// TPU kernel). Same result: for audio [B, N] f32, frame i of a lane is the
// 400 samples at 160 i - 200 (reflect-padded at both ends), and
//
//     out[b, m, i] = log10(max(sum_k |X_k(i)|^2 * filters[k, m], 1e-10))
//
// where X_k(i) is the Hann-windowed DFT bin k (201 bins) taken against the
// same f32 cos|sin basis table as the plain version (no sincos on the fly).
// The output is the encoder's [B, n_mels, N / 160] layout; the dynamic
// floor and the (x + 4) / 4 scaling need a maximum over a whole lane and
// stay outside the kernel.
//
// What bounds it on the H100: operations. The DFT is 2 * 400 * 402 FLOP
// per frame (7.7 GFLOP for 8 lanes of 30 s) against 23 MB of audio in and
// log-mel out, so at the card's 67 TFLOP/s of f32 FMA on CUDA cores the
// bound is ~0.12 ms and memory is ~20x below it.
//
// Design (first version, right before fast): one block takes one lane and
// 64 frames. It loads those frames' 10480 samples into shared memory once,
// reflecting at both ends from the index (no padded copy), and walks the
// 201 bins in tiles of 64 (the last tile 32 wide). The 480 x 512 basis does
// not fit in shared memory, so 40-tap chunks of the tile's cos and sin
// columns stream through it. Each warp owns 8 frames and each lane 2 bins
// (cos and sin): 32 f32 accumulators, fed by broadcast 16-byte sample reads
// (a warp reads one frame's 4 taps at once) and conflict-free basis reads.
// The power rows stay in shared memory (row stride 201, odd, so the mel
// phase's column reads are conflict-free) and never reach device memory;
// the mel projection sums only each filter's nonzero bins (the skipped
// terms are exact zeros) and writes log10 with coalesced stores. Tensor
// cores (TF32 keeps ~3 digits against a 1e-4 bar) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HOP = 160;
constexpr int N_FFT = 400;
constexpr int PAD = N_FFT / 2;           // reflect padding at each end
constexpr int BINS = N_FFT / 2 + 1;      // 201
constexpr int DFT_COLS = 512;            // basis row: cos bins [0, 256), sin bins [256, 512)
constexpr int SIN_OFF = 256;
constexpr int MEL_COLS = 128;            // filterbank row [256 bins, 128 mels]

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FRAMES = 64;               // frames per block
constexpr int FPW = FRAMES / WARPS;      // 8 frames per warp
constexpr int BIN_TILE = 64;             // bins per tile: 2 per lane
constexpr int N_TILES = (BINS + BIN_TILE - 1) / BIN_TILE;  // 4; the last needs 32 lanes x 1
constexpr int KC = 40;                   // taps per basis chunk
constexpr int BASIS_ROW = 2 * BIN_TILE;  // cos | sin columns of one tap
constexpr int SAMPLES = (FRAMES - 1) * HOP + N_FFT;  // 10480
constexpr int PSTRIDE = BINS;            // power row stride (odd)
constexpr size_t SMEM_BYTES =
    static_cast<size_t>(SAMPLES + KC * BASIS_ROW + FRAMES * PSTRIDE) * sizeof(float);

static_assert(FPW * WARPS == FRAMES, "frames split evenly over warps");
static_assert(N_FFT % KC == 0 && KC % 4 == 0, "chunks of whole 4-tap groups");
static_assert((BIN_TILE * (N_TILES - 1)) + 32 >= BINS, "the last tile covers the last bins");
static_assert(SAMPLES % 4 == 0 && (KC * BASIS_ROW) % 4 == 0, "16-byte aligned regions");

__device__ __forceinline__ long long reflect(long long i, long long n) {
  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  const long long per = 2 * (n - 1);  // numpy's repeated reflection
  i %= per;
  if (i < 0) i += per;
  return i < n ? i : per - i;
}

__device__ __forceinline__ float pick(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// One tile of bins [tile * 64, tile * 64 + 32 * NB) for the block's 64
// frames; writes the power of each real bin (< 201) into `power`.
template <int NB>
__device__ __forceinline__ void dft_tile(const float* samp, float* basis,
                                         const float* __restrict__ dft, float* power,
                                         int tile, int warp, int lane) {
  float ac[FPW][NB], as[FPW][NB];
#pragma unroll
  for (int f = 0; f < FPW; ++f)
#pragma unroll
    for (int j = 0; j < NB; ++j) ac[f][j] = as[f][j] = 0.f;

  const int bin0 = tile * BIN_TILE;
  const float* frames = samp + warp * FPW * HOP;
  for (int k0 = 0; k0 < N_FFT; k0 += KC) {
    __syncthreads();  // the previous chunk's readers are done (and the samples are in)
    for (int i = threadIdx.x; i < KC * BASIS_ROW / 4; i += THREADS) {
      const int r = i / (BASIS_ROW / 4);
      const int c4 = i % (BASIS_ROW / 4);
      const int col = c4 < BIN_TILE / 4 ? bin0 + 4 * c4 : SIN_OFF + bin0 + 4 * (c4 - BIN_TILE / 4);
      reinterpret_cast<float4*>(basis)[i] =
          __ldg(reinterpret_cast<const float4*>(dft + static_cast<size_t>(k0 + r) * DFT_COLS + col));
    }
    __syncthreads();
#pragma unroll 2
    for (int t = 0; t < KC; t += 4) {
      float4 x[FPW];
#pragma unroll
      for (int f = 0; f < FPW; ++f)  // one warp-wide broadcast per frame
        x[f] = *reinterpret_cast<const float4*>(frames + f * HOP + k0 + t);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* row = basis + (t + u) * BASIS_ROW;
        float c[NB], s[NB];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          c[j] = row[lane + 32 * j];
          s[j] = row[BIN_TILE + lane + 32 * j];
        }
#pragma unroll
        for (int f = 0; f < FPW; ++f) {
          const float xv = pick(x[f], u);
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            ac[f][j] = fmaf(xv, c[j], ac[f][j]);
            as[f][j] = fmaf(xv, s[j], as[f][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int f = 0; f < FPW; ++f)
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int bin = bin0 + lane + 32 * j;
      if (bin < BINS) power[(warp * FPW + f) * PSTRIDE + bin] = ac[f][j] * ac[f][j] + as[f][j] * as[f][j];
    }
}

// grid: (ceil(T / 64), B); out [B, n_mels, T] with T = N / 160.
__global__ void __launch_bounds__(THREADS, 2)
log_mel_kernel(const float* __restrict__ audio, const float* __restrict__ dft,
               const float* __restrict__ filters, const int* __restrict__ ranges,
               float* __restrict__ out, int N, int T, int n_mels) {
  extern __shared__ __align__(16) float smem[];
  float* samp = smem;                       // [SAMPLES]
  float* basis = samp + SAMPLES;            // [KC][BASIS_ROW]
  float* power = basis + KC * BASIS_ROW;    // [FRAMES][PSTRIDE]

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FRAMES;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* x = audio + static_cast<size_t>(b) * N;
  const long long first = static_cast<long long>(f0) * HOP - PAD;
  for (int s = threadIdx.x; s < SAMPLES; s += THREADS) samp[s] = x[reflect(first + s, N)];

#pragma unroll 1
  for (int tile = 0; tile < N_TILES - 1; ++tile) dft_tile<2>(samp, basis, dft, power, tile, warp, lane);
  dft_tile<1>(samp, basis, dft, power, N_TILES - 1, warp, lane);
  __syncthreads();

  // mel projection: a warp takes 32 consecutive frames of one mel
  for (int idx = threadIdx.x; idx < n_mels * FRAMES; idx += THREADS) {
    const int m = idx / FRAMES;
    const int f = idx % FRAMES;
    if (f0 + f >= T) continue;
    const int lo = __ldg(ranges + 2 * m), hi = __ldg(ranges + 2 * m + 1);
    float acc = 0.f;
    for (int k = lo; k < hi; ++k) acc = fmaf(power[f * PSTRIDE + k], __ldg(filters + k * MEL_COLS + m), acc);
    out[(static_cast<size_t>(b) * n_mels + m) * T + f0 + f] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

extern "C" {

// audio [B, N] f32; dft [480, 512] f32 (rows >= 400 unused); filters
// [256, 128] f32; ranges [n_mels, 2] int32 (each filter's nonzero bins);
// out [B, n_mels, N / 160] f32; all contiguous on the device of `stream`.
// Returns 0 on success, a cudaError_t code when the launch was refused, or
// -1 for arguments the kernel does not take.
int wlk_log_mel(const float* audio, const float* dft, const float* filters, const int* ranges,
                float* out, int B, int N, int n_mels, void* stream) {
  const int T = N / HOP;
  if (B <= 0 || B > 65535 || T <= 0 || n_mels <= 0 || n_mels > MEL_COLS) return -1;
  cudaError_t err = cudaFuncSetAttribute(log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + FRAMES - 1) / FRAMES, B);
  log_mel_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      audio, dft, filters, ranges, out, N, T, n_mels);
  return static_cast<int>(cudaGetLastError());
}

const char* wlk_log_mel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
