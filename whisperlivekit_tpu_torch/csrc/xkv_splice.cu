// Cross-KV pool splice for the large form's steady tick, hand-written for
// Hopper (sm_90a).
//
// Replaces whisperlivekit_tpu/ops/xkv_merge.py::xkv_splice (the Pallas TPU
// kernel). Same result: for every lane g with win[g] > 0, pool columns
// [dst0, dst0 + 256) of every (layer, head, Dh) row of K and V take the
// freshly projected tail, cast to the pool's dtype, in place, where
// dst0 = clip(align128(win - 128), 0, Tp - 256); lanes with win == 0 keep
// every bit.
//
// What bounds it on the H100: nothing but bytes. It is a copy of
// 2 * L * G * H * Dh * 256 elements (about 1 GB read and 1 GB written at
// large-v3 with G = 24 in bf16), with no arithmetic beyond an optional
// f32 -> bf16 rounding. The plain PyTorch version selects over the whole
// pools and so reads and writes all Tp = 1536 columns and a gathered copy
// of them, well over 6x the bytes.
//
// Design (first version, right before fast): the TPU kernel issues one
// strided DMA per (lane, k/v); on Hopper the copy is spread over all SMs
// instead. Each thread moves one 16-byte vector of the pool, neighbouring
// threads on neighbouring addresses, so a warp writes 512 contiguous bytes
// of one row (one bf16 row of 256 columns). dst0 is a multiple of 128 and
// Tp is too, so every row segment starts 256-byte aligned in bf16 and the
// vector accesses stay aligned. A block serves one (k/v, layer, lane)
// segment; it reads its lane's win from the device and derives dst0 itself,
// so the host never synchronises, and it returns at once when win == 0.
// Where the tail's dtype differs from the pool's it rounds with
// __float2bfloat16_rn (round to nearest even, as Tensor.to does). TMA bulk
// copies are later work.
//
// float8_e4m3fn pools (the f8 large form, xkv_cache_dtype="f8"): the cast
// must give JAX's bytes (ml_dtypes): round to nearest even, and NaN with the
// input's sign for every magnitude that rounds past 448 (above 464), for
// +-inf and for NaN. PTX's only convert to e4m3 (cvt.rn.satfinite)
// saturates to 448 instead, so the kernel rounds in integer arithmetic on
// the f32 bits, the same arithmetic as ops/f8.py to_e4m3fn (bf16 tails widen
// exactly to f32 first). A 16-byte pool vector is 16 columns; dst0 is a
// multiple of 128 columns and so of 128 bytes, and the stores stay aligned.
// Bytes moved per element: the tail's 4 or 2 read, 1 written.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int W_SPLICE = 256;  // spliced columns per row (2 x 128)
constexpr int THREADS = 256;

struct alignas(16) Vec16 {
  uint32_t w[4];
};

// 16 bytes of the pool (VEC elements of TP) from VEC elements of TT
template <typename TP, typename TT> struct Cvt;

template <typename T> struct Cvt<T, T> {
  static constexpr int VEC = 16 / sizeof(T);
  __device__ static Vec16 load(const T* src) {
    return *reinterpret_cast<const Vec16*>(src);
  }
};

template <> struct Cvt<__nv_bfloat16, float> {
  static constexpr int VEC = 8;
  __device__ static Vec16 load(const float* src) {
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    Vec16 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(r.w);
    h[0] = __floats2bfloat162_rn(a.x, a.y);  // .x is the lower address
    h[1] = __floats2bfloat162_rn(a.z, a.w);
    h[2] = __floats2bfloat162_rn(b.x, b.y);
    h[3] = __floats2bfloat162_rn(b.z, b.w);
    return r;
  }
};

template <> struct Cvt<float, __nv_bfloat16> {
  static constexpr int VEC = 4;
  __device__ static Vec16 load(const __nv_bfloat16* src) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    Vec16 r;
    *reinterpret_cast<float4*>(r.w) = make_float4(a.x, a.y, b.x, b.y);
    return r;
  }
};

// float -> float8_e4m3fn byte, as JAX rounds (see the note at the top)
__device__ __forceinline__ uint32_t e4m3_from_f32(float x) {
  const uint32_t bits = __float_as_uint(x);
  const uint32_t sign = (bits >> 24) & 0x80u;
  const uint32_t mag = bits & 0x7FFFFFFFu;
  uint32_t code;
  if (mag >= 0x7F800000u) {  // +-inf, NaN
    code = 0x7Fu;
  } else if (mag < 0x3C800000u) {  // below 2^-6: a multiple of 2^-9, to even
    code = static_cast<uint32_t>(__float2int_rn(__uint_as_float(mag) * 512.0f));
  } else {  // round the mantissa to 3 bits, to even, and rebias 127 -> 7
    const uint32_t r = ((mag + 0x7FFFFu + ((mag >> 20) & 1u)) >> 20) - (120u << 3);
    code = r > 0x7Eu ? 0x7Fu : r;
  }
  return code | sign;
}

__device__ __forceinline__ uint32_t pack4_e4m3(float a, float b, float c, float d) {
  return e4m3_from_f32(a) | (e4m3_from_f32(b) << 8) | (e4m3_from_f32(c) << 16) |
         (e4m3_from_f32(d) << 24);  // the first element at the lowest address
}

template <> struct Cvt<__nv_fp8_e4m3, float> {
  static constexpr int VEC = 16;
  __device__ static Vec16 load(const float* src) {
    const float4* s = reinterpret_cast<const float4*>(src);
    Vec16 r;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a = s[i];
      r.w[i] = pack4_e4m3(a.x, a.y, a.z, a.w);
    }
    return r;
  }
};

template <> struct Cvt<__nv_fp8_e4m3, __nv_bfloat16> {
  static constexpr int VEC = 16;
  __device__ static Vec16 load(const __nv_bfloat16* src) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    Vec16 r;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4 raw = s[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 a = __bfloat1622float2(h[0]);
      const float2 b = __bfloat1622float2(h[1]);
      const float2 c = __bfloat1622float2(h[2]);
      const float2 d = __bfloat1622float2(h[3]);
      r.w[2 * i] = pack4_e4m3(a.x, a.y, b.x, b.y);
      r.w[2 * i + 1] = pack4_e4m3(c.x, c.y, d.x, d.y);
    }
    return r;
  }
};

__device__ __forceinline__ int splice_dst0(int win, int t_pool) {
  int d = win >= W_SPLICE / 2 ? ((win - W_SPLICE / 2) / 128) * 128 : 0;
  return d < t_pool - W_SPLICE ? d : t_pool - W_SPLICE;
}

// grid: (vector chunks of one segment, G, 2 * L); blockIdx.z < L is K.
// rows = H * Dh rows per (layer, lane) segment, contiguous in both tensors.
template <typename TP, typename TT>
__global__ void __launch_bounds__(THREADS)
xkv_splice_kernel(TP* __restrict__ pool_k, TP* __restrict__ pool_v,
                  const TT* __restrict__ tail_k, const TT* __restrict__ tail_v,
                  const int* __restrict__ win, int L, int G, int rows, int t_pool) {
  const int g = blockIdx.y;
  const int w = win[g];
  if (w <= 0) return;
  constexpr int VEC = Cvt<TP, TT>::VEC;
  constexpr int PER_ROW = W_SPLICE / VEC;  // vectors per row
  const long long v = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (v >= static_cast<long long>(rows) * PER_ROW) return;
  const int row = static_cast<int>(v / PER_ROW);
  const int col = static_cast<int>(v % PER_ROW) * VEC;

  const bool is_v = blockIdx.z >= L;
  const int l = is_v ? blockIdx.z - L : blockIdx.z;
  const long long seg_row = (static_cast<long long>(l) * G + g) * rows + row;
  TP* dst = (is_v ? pool_v : pool_k) + seg_row * t_pool + splice_dst0(w, t_pool) + col;
  const TT* src = (is_v ? tail_v : tail_k) + seg_row * W_SPLICE + col;
  *reinterpret_cast<Vec16*>(dst) = Cvt<TP, TT>::load(src);
}

template <typename TP, typename TT>
int launch(void* pk, void* pv, const void* tk, const void* tv, const int* win, int L,
           int G, int rows, int t_pool, cudaStream_t stream) {
  constexpr int VEC = Cvt<TP, TT>::VEC;
  const long long vectors = static_cast<long long>(rows) * (W_SPLICE / VEC);
  const long long chunks = (vectors + THREADS - 1) / THREADS;
  if (chunks > 0x7fffffffLL || G > 65535 || 2 * L > 65535) return -1;
  const dim3 grid(static_cast<unsigned>(chunks), G, 2 * L);
  xkv_splice_kernel<TP, TT><<<grid, THREADS, 0, stream>>>(
      static_cast<TP*>(pk), static_cast<TP*>(pv), static_cast<const TT*>(tk),
      static_cast<const TT*>(tv), win, L, G, rows, t_pool);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn (pools only).
// Returns 0 on success, a
// cudaError_t code when the launch was refused, or -1 for arguments the
// kernel does not take. All tensors contiguous: pools [L, G, rows, Tp],
// tails [L, G, rows, 256], win [G] int32, all on the device of `stream`.
int wlk_xkv_splice(void* pool_k, void* pool_v, const void* tail_k, const void* tail_v,
                   const int* win, int L, int G, int rows, int t_pool, int pool_dtype,
                   int tail_dtype, void* stream) {
  if (L <= 0 || G <= 0 || rows <= 0 || t_pool < W_SPLICE || t_pool % 128 != 0) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_dtype == 1 && tail_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(pool_k, pool_v, tail_k, tail_v, win, L, G,
                                                rows, t_pool, s);
  if (pool_dtype == 0 && tail_dtype == 0)
    return launch<float, float>(pool_k, pool_v, tail_k, tail_v, win, L, G, rows, t_pool, s);
  if (pool_dtype == 1 && tail_dtype == 0)
    return launch<__nv_bfloat16, float>(pool_k, pool_v, tail_k, tail_v, win, L, G, rows,
                                        t_pool, s);
  if (pool_dtype == 0 && tail_dtype == 1)
    return launch<float, __nv_bfloat16>(pool_k, pool_v, tail_k, tail_v, win, L, G, rows,
                                        t_pool, s);
  if (pool_dtype == 2 && tail_dtype == 0)
    return launch<__nv_fp8_e4m3, float>(pool_k, pool_v, tail_k, tail_v, win, L, G, rows,
                                        t_pool, s);
  if (pool_dtype == 2 && tail_dtype == 1)
    return launch<__nv_fp8_e4m3, __nv_bfloat16>(pool_k, pool_v, tail_k, tail_v, win, L, G,
                                                rows, t_pool, s);
  return -1;
}

const char* wlk_xkv_splice_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
