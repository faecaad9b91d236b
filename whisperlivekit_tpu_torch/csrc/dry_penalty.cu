// DRY repetition penalty for the decode step, hand-written for Hopper
// (sm_90a): kernel K4.
//
// Replaces no Pallas kernel. The JAX package writes dry_penalty
// (whisperlivekit_tpu/streaming/alignatt.py) in jnp, and XLA fuses it into
// the jitted tick. Run eagerly, the same arithmetic walks 49 match offsets in
// Python: about 800 small launches per decode step, most of a step's host
// enqueue. This kernel is one launch.
//
// The result is bit for bit the plain version's (ops/dry.py,
// dry_penalty_plain). Per lane row b, with end = cur_len - 1 and
// last = tokens[end mod L]:
// - a candidate is a position i < end with tokens[i] == last whose next
//   token tokens[(i + 1) mod L] is below eot;
// - its match length is 1 plus the run of offsets l = 1..49 with i - l >= 0,
//   end - l > i, tokens[i - l] == tokens[end - l] and that token below eot;
// - each next-token id takes the largest length among its candidates, and
//   loses exactly 2^(len - 2) where that length is 2 or more;
// - only where cur_len >= 5 and last < eot. Every other logit is x - 0.0f,
//   as the plain version's subtraction leaves it (the same bits, NaNs made
//   canonical by the card's arithmetic as there).
// A next-token id outside [0, V) is skipped (the plain version's scatter
// refuses it). Positions past L, which only cur_len > L + 1 would reach and
// the plain version's gather refuses, are read modulo L.
//
// What bounds it on the H100: bytes. The row's copy reads and writes
// B * V * 4 bytes (64 x 51866 floats: 26.6 MB, 7.9 us at 3.35 TB/s); the
// match walk reads L tokens per row from shared memory.
//
// Design: one block per lane row. The block loads its token row into shared
// memory (L up to THREADS) and copies the row in 16-byte vectors, then gives
// each thread one candidate position, which walks its own match length.
// Every id a row penalizes is resolved in shared memory: of the candidates
// that share a next-token id, exactly one writes, the longest and among
// equals the lowest position, so no atomic and no order of execution changes
// the result. Each candidate finds out by scanning the row's keys, 16 at a
// time (scanned one by one, the scan waits on shared memory at every entry:
// 448 entries took ~20 us on the H100). The penalties are written after a
// barrier, over the copied row. One block per row keeps the resolution inside
// one block; the turbo step's 64 rows fill 64 SMs, each copying 207 KB, and
// the copy alone runs at 94 % of the byte bound there (8.5 us).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;  // also the longest token row taken (ops/dry.py MAX_LEN)
constexpr int MAX_RUN = 49;    // match offsets walked behind a candidate

// i mod L in [0, L); the 64-bit remainder (a long software routine) only
// off the usual range
__device__ __forceinline__ int wrap(long long i, int L) {
  if (i >= 0 && i < L) return static_cast<int>(i);
  const long long r = i % L;
  return static_cast<int>(r < 0 ? r + L : r);
}

// dst[v] = src[v] - zero over one row; zero is 0.0f from the host, so the
// subtraction is not folded away and rounds as the plain version's does
__device__ __forceinline__ void copy_row(const float* __restrict__ src, float* __restrict__ dst,
                                         long long V, float zero) {
  const int tid = threadIdx.x;
  long long head = V;  // scalar elements before the vectors
  if (((reinterpret_cast<uintptr_t>(src) ^ reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    head = ((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) / 4;
    if (head > V) head = V;
  }
  for (long long v = tid; v < head; v += THREADS) dst[v] = src[v] - zero;
  const long long nvec = (V - head) / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  long long v = tid;
  for (; v + 3 * THREADS < nvec; v += 4 * THREADS) {  // four 16-byte loads in flight
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = s4[v + u * THREADS];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      d4[v + u * THREADS] = make_float4(x[u].x - zero, x[u].y - zero, x[u].z - zero, x[u].w - zero);
  }
  for (; v < nvec; v += THREADS) {
    const float4 x = s4[v];
    d4[v] = make_float4(x.x - zero, x.y - zero, x.z - zero, x.w - zero);
  }
  for (long long t = head + nvec * 4 + tid; t < V; t += THREADS) dst[t] = src[t] - zero;
}

// grid: B blocks, one per lane row
template <typename TT, typename LT>
__global__ void __launch_bounds__(THREADS)
dry_penalty_kernel(const float* __restrict__ logits, float* __restrict__ out,
                   const TT* __restrict__ tokens, const LT* __restrict__ cur_len, int L,
                   long long V, long long eot, float zero) {
  __shared__ long long tok[THREADS];
  // per position: (match length, 1023 - position) as one key, 0 where the
  // position penalizes nothing; and its next-token id
  __shared__ __align__(16) int key[THREADS];
  __shared__ __align__(16) int nid[THREADS];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  // issued before the copy, so that their latency hides under it
  const long long t = tid < L ? static_cast<long long>(tokens[static_cast<long long>(b) * L + tid]) : 0;
  const long long end = static_cast<long long>(cur_len[b]) - 1;
  const float* src = logits + static_cast<long long>(b) * V;
  float* dst = out + static_cast<long long>(b) * V;
  copy_row(src, dst, V, zero);
  tok[tid] = t;
  __syncthreads();  // the token row is in; the copy is written

  const long long last = tok[wrap(end, L)];
  if (end + 1 < 5 || last >= eot) return;  // the same for the whole block

  int len = 0, next = 0;
  if (tid < L && tid < end && tok[tid] == last) {
    const long long nx = tok[tid + 1 < L ? tid + 1 : 0];
    if (nx < eot) {
      len = 1;
      int k = wrap(end - 1, L);  // (end - l) mod L, stepped down with l
      for (int l = 1; l <= MAX_RUN; ++l) {
        const int j = tid - l;
        if (j < 0 || end - l <= tid) break;
        const long long tj = tok[j];
        if (tj != tok[k] || tj >= eot) break;
        ++len;
        k = k == 0 ? L - 1 : k - 1;
      }
      if (len < 2 || nx < 0 || nx >= V) len = 0;
      next = static_cast<int>(nx);
    }
  }
  const int mine = len ? len * THREADS + (THREADS - 1 - tid) : 0;
  key[tid] = mine;
  nid[tid] = next;
  __syncthreads();
  if (mine == 0) return;
  // the one writer of this id: the largest key (the longest run, the lowest
  // position among equals). A single thread's scan is bound by the latency
  // of shared memory, so 16 entries go in flight together; the positions
  // past L hold key 0, and the scan stops at a multiple of 16 <= THREADS.
  const int4* key4 = reinterpret_cast<const int4*>(key);
  const int4* nid4 = reinterpret_cast<const int4*>(nid);
  const int quads = (L + 15) / 16 * 4;
  bool beaten = false;
  for (int q = 0; q < quads && !beaten; q += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int4 kq = key4[q + u], nq = nid4[q + u];
      beaten |= (nq.x == next && kq.x > mine) | (nq.y == next && kq.y > mine) |
                (nq.z == next && kq.z > mine) | (nq.w == next && kq.w > mine);
    }
  }
  if (!beaten) dst[next] = src[next] - __int_as_float((len - 2 + 127) << 23);  // exactly 2^(len-2)
}

template <typename TT, typename LT>
int launch(const float* logits, float* out, const void* tokens, const void* cur_len, int B,
           int L, long long V, long long eot, cudaStream_t stream) {
  dry_penalty_kernel<TT, LT><<<B, THREADS, 0, stream>>>(
      logits, out, static_cast<const TT*>(tokens), static_cast<const LT*>(cur_len), L, V, eot,
      0.0f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// logits, out: [B, V] float32, contiguous; tokens: [B, L] contiguous and
// cur_len: [B], each int32 (code 0) or int64 (code 1); all on the device of
// `stream`. Returns 0 on success, a cudaError_t code when the launch was
// refused, or -1 for arguments the kernel does not take.
int wlk_dry_penalty(const float* logits, float* out, const void* tokens, const void* cur_len,
                    int B, int L, long long V, long long eot, int tokens_i64, int cur_len_i64,
                    void* stream) {
  if (B <= 0 || L <= 0 || L > THREADS || V <= 0 || V > 0x7fffffffLL) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tokens_i64 && cur_len_i64)
    return launch<long long, long long>(logits, out, tokens, cur_len, B, L, V, eot, s);
  if (tokens_i64)
    return launch<long long, int>(logits, out, tokens, cur_len, B, L, V, eot, s);
  if (cur_len_i64)
    return launch<int, long long>(logits, out, tokens, cur_len, B, L, V, eot, s);
  return launch<int, int>(logits, out, tokens, cur_len, B, L, V, eot, s);
}

const char* wlk_dry_penalty_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
