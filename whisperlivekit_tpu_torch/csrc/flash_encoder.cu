// Flash attention for the Whisper encoder and the AlignAtt prefill
// cross-attention, hand-written for Hopper (sm_90a).
//
// Replaces whisperlivekit_tpu/ops/flash_encoder.py::flash_encoder_attn (the
// Pallas TPU kernel). Same math: non-causal attention, f32 scores and
// softmax, key columns >= t_valid masked, probabilities rounded to V's
// dtype, P.V accumulated in f32, output in q's dtype.
//
// What bounds it on the H100: at the full-window encoder shape (S = T = 1500,
// Dh = 64) the work is 4*S*T*Dh flops per (lane, head) against 2*(S+T)*Dh
// elements read, ~1000 flops per byte, so it is compute-bound on QK^T and
// PV. The XLA/PyTorch formulation also writes and re-reads the [S,T] f32
// score matrix per head; this kernel keeps score tiles in shared memory and
// streams K/V once per 64-row query tile with an online (running max / sum)
// softmax, so device memory sees only q, k, v and o.
//
// Design (the f32 body; bf16 runs on the tensor cores in
// flash_encoder_wgmma.cu): one block per (query tile of 64 rows, head,
// lane), 256 threads on a 16x16 grid; each thread owns 4 rows x 4 score
// columns of a 64x64 tile and 4 rows x Dh/16 output columns. All products
// are f32 FMAs on the CUDA cores, which keeps the f32 results within the
// 2e-5 of the reference that TF32 tensor cores could not. K and V arrive
// through explicit element strides, so one kernel reads V as [T,Dh] or
// [Dh,T] and q/k/v as strided views of the projections without a
// transposing copy; the loader maps consecutive threads onto whichever axis
// has unit stride. Ragged S and T are masked in-kernel (no 128-padding as
// on the TPU).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK_M = 64;  // query rows per block
constexpr int BLOCK_N = 64;  // key columns per tile
constexpr int THREADS = 256; // 16 x 16
constexpr int TM = 4;        // query rows per thread (stride 16)
constexpr int TN = 4;        // key columns per thread (stride 16)

struct Strides {
  long long b, h, t, d;  // element strides of a logical [B, H, T or S, Dh] view
};

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// p.astype(v.dtype) of the reference, kept in f32 registers afterwards
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

template <int DH>
constexpr size_t smem_bytes() {
  // Q [BM][DH], K [BN][DH+1], V [BN][DH+1], P [BM][BN+1]; the +1 pads keep
  // the column-strided accesses free of bank conflicts
  return sizeof(float) *
         (BLOCK_M * DH + 2 * BLOCK_N * (DH + 1) + BLOCK_M * (BLOCK_N + 1));
}

template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          const Strides& st, int n0, int t_valid,
                                          int tid) {
  // dst[c][d] (row pitch DH+1) <- src[t = n0 + c, d]; zero past t_valid so
  // masked columns contribute exactly 0 to P.V even if they hold inf/nan.
  const bool t_unit = (st.t == 1);
  for (int i = tid; i < BLOCK_N * DH; i += THREADS) {
    int c, d;
    if (t_unit) {
      c = i % BLOCK_N;
      d = i / BLOCK_N;
    } else {
      d = i % DH;
      c = i / DH;
    }
    const int t = n0 + c;
    dst[c * (DH + 1) + d] = t < t_valid ? to_f32<T>(src[t * st.t + d * st.d]) : 0.f;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_encoder_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S,
                     int t_valid, float scale, Strides qs, Strides ks, Strides vs,
                     Strides os) {
  extern __shared__ float smem[];
  float* Qs = smem;                      // [BLOCK_M][DH]
  float* Ks = Qs + BLOCK_M * DH;         // [BLOCK_N][DH+1]
  float* Vs = Ks + BLOCK_N * (DH + 1);   // [BLOCK_N][DH+1]
  float* Ps = Vs + BLOCK_N * (DH + 1);   // [BLOCK_M][BLOCK_N+1]

  constexpr int TD = DH / 16;  // output columns per thread
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.x * BLOCK_M;
  const long long h = blockIdx.y;
  const long long b = blockIdx.z;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < BLOCK_M * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;  // q's Dh axis has unit stride
    const int s = m0 + r;
    Qs[r * DH + d] = s < S ? to_f32<T>(qb[s * qs.t + d * qs.d]) : 0.f;
  }

  float m_run[TM], l_run[TM], oacc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) oacc[i][j] = 0.f;
  }

  const int n_tiles = (t_valid + BLOCK_N - 1) / BLOCK_N;  // tiles past t_valid are all masked
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int n0 = tile * BLOCK_N;
    __syncthreads();  // the previous tile's P.V is done with Ks/Vs/Ps
    load_tile<T, DH>(Ks, kb, ks, n0, t_valid, tid);
    load_tile<T, DH>(Vs, vb, vs, n0, t_valid, tid);
    __syncthreads();

    float sacc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sacc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[TM], kv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) qv[i] = Qs[(ty + 16 * i) * DH + d];
#pragma unroll
      for (int j = 0; j < TN; ++j) kv[j] = Ks[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
    }

    // online softmax over this tile; a row's 64 columns live on the 16
    // threads sharing ty, which are 16 consecutive lanes of one warp
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + tx + 16 * j;
        const float s = col < t_valid ? sacc[i][j] * scale : -INFINITY;
        sacc[i][j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);  // finite: column 0 is always valid
      const float alpha = expf(m_run[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = expf(sacc[i][j] - m_new);
        rsum += p;
        Ps[(ty + 16 * i) * (BLOCK_N + 1) + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l_run[i] = l_run[i] * alpha + rsum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < TD; ++j) oacc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BLOCK_N; ++c) {
      float pv[TM], vv[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) pv[i] = Ps[(ty + 16 * i) * (BLOCK_N + 1) + c];
#pragma unroll
      for (int j = 0; j < TD; ++j) vv[j] = Vs[c * (DH + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) oacc[i][j] = fmaf(pv[i], vv[j], oacc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int s = m0 + ty + 16 * i;
    if (s >= S) continue;
    const float inv = 1.f / l_run[i];
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      const int d = tx + 16 * j;
      ob[s * os.t + d * os.d] = from_f32<T>(oacc[i][j] * inv);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int S, int t_valid, float scale, const long long* st,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_encoder_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{st[0], st[1], st[2], st[3]};
  const Strides ks{st[4], st[5], st[6], st[7]};
  const Strides vs{st[8], st[9], st[10], st[11]};
  const Strides os{st[12], st[13], st[14], st[15]};
  const dim3 grid((S + BLOCK_M - 1) / BLOCK_M, H, B);
  flash_encoder_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, t_valid, scale, qs, ks,
      vs, os);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code when the launch was refused, or
// -1 for an argument combination the kernel does not take. f32 only. Strides
// are 16 element strides: q (b,h,s,d), k (b,h,t,d), v (b,h,t,d), o (b,h,s,d).
int wlk_flash_encoder_attn(const void* q, const void* k, const void* v, void* o,
                           int B, int H, int S, int Dh, int t_valid, float scale,
                           const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || t_valid <= 0) return -1;
  if (strides[3] != 1) return -1;  // q rows are read with unit Dh stride
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 64) return launch<float, 64>(q, k, v, o, B, H, S, t_valid, scale, strides, s);
  if (Dh == 128) return launch<float, 128>(q, k, v, o, B, H, S, t_valid, scale, strides, s);
  return -1;
}

const char* wlk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
