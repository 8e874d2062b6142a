// The previous design of the depthwise weight/bias gradient, kept (October
// 2026) only as the yardstick of chip_smoke.py's `ms_before`, which builds it
// into a library of its own: nothing in the package builds or calls it.
// Delete this directory, and `ms_before`, with the next change to either
// kernel.  Two launches: per-chunk partial sums to a (chunks, k + 1, C)
// float32 scratch in device memory, then a kernel that adds the chunks in
// index order.  The kernel in use is
// speechlid_tpu_torch/csrc/depthwise.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTC = 32;    // channels per block (one warp across)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int kBwdTT = 64;    // frames per bwd_w block
constexpr int kBwdRows = 32;  // thread rows of a bwd_w block
constexpr int kMaxK = 64;
constexpr int kBwdTaps = (kMaxK + 1 + kBwdRows - 1) / kBwdRows;  // sums per thread

template <typename T>
__global__ void __launch_bounds__(kTC * kBwdRows) depthwise_bwd_w_partial_kernel(
    const T* __restrict__ x,        // (B, T, C)
    const T* __restrict__ g,        // (B, T, C)
    float* __restrict__ scratch,    // (chunks, K + 1, C)
    int Tn, int C, int K, int pad_l, int chunks_per_utt)
{
  extern __shared__ float smem[];
  const int span = kBwdTT + K - 1;
  float* xs = smem;               // span × kTC
  float* gs = smem + span * kTC;  // kBwdTT × kTC

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int c = blockIdx.y * kTC + tx;
  const int utt = blockIdx.x / chunks_per_utt;
  const int t0 = (blockIdx.x % chunks_per_utt) * kBwdTT;
  const bool c_ok = c < C;
  const T* xb = x + static_cast<size_t>(utt) * Tn * C;
  const T* gb = g + static_cast<size_t>(utt) * Tn * C;

  for (int r = ty; r < span; r += kBwdRows) {
    const int t = t0 - pad_l + r;
    xs[r * kTC + tx] =
        (c_ok && t >= 0 && t < Tn) ? to_f32(xb[static_cast<size_t>(t) * C + c]) : 0.f;
  }
  for (int r = ty; r < kBwdTT; r += kBwdRows) {
    const int t = t0 + r;
    gs[r * kTC + tx] = (c_ok && t < Tn) ? to_f32(gb[static_cast<size_t>(t) * C + c]) : 0.f;
  }
  __syncthreads();
  if (!c_ok) return;

  float acc[kBwdTaps];
#pragma unroll
  for (int i = 0; i < kBwdTaps; ++i) acc[i] = 0.f;
  for (int r = 0; r < kBwdTT; ++r) {
    const float gv = gs[r * kTC + tx];
#pragma unroll
    for (int i = 0; i < kBwdTaps; ++i) {
      const int j = ty + i * kBwdRows;
      if (j < K)
        acc[i] = fmaf(xs[(r + j) * kTC + tx], gv, acc[i]);
      else if (j == K)
        acc[i] += gv;
    }
  }
  float* out = scratch + static_cast<size_t>(blockIdx.x) * (K + 1) * C;
#pragma unroll
  for (int i = 0; i < kBwdTaps; ++i) {
    const int j = ty + i * kBwdRows;
    if (j <= K) out[static_cast<size_t>(j) * C + c] = acc[i];
  }
}

// Sums the chunks' partials in index order: dw (K, C), then db (C,).
template <typename T>
__global__ void depthwise_bwd_w_reduce_kernel(
    const float* __restrict__ scratch, T* __restrict__ dw, T* __restrict__ db,
    int n_chunks, int C, int K)
{
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = (K + 1) * C;
  if (i >= n) return;
  float acc = 0.f;
#pragma unroll 8
  for (int ch = 0; ch < n_chunks; ++ch) acc += scratch[static_cast<size_t>(ch) * n + i];
  if (i < K * C)
    dw[i] = from_f32<T>(acc);
  else
    db[i - K * C] = from_f32<T>(acc);
}

template <typename T>
cudaError_t launch_bwd_w(const void* x, const void* g, float* scratch, void* dw, void* db,
                         int B, int Tn, int C, int K, int pad_l, cudaStream_t stream) {
  const int chunks_per_utt = (Tn + kBwdTT - 1) / kBwdTT;
  const int n_chunks = B * chunks_per_utt;
  if (n_chunks > 0) {
    const dim3 grid(n_chunks, (C + kTC - 1) / kTC);
    const dim3 block(kTC, kBwdRows);
    const size_t smem = sizeof(float) * static_cast<size_t>(2 * kBwdTT + K - 1) * kTC;
    depthwise_bwd_w_partial_kernel<T><<<grid, block, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), scratch, Tn, C, K, pad_l,
        chunks_per_utt);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int n = (K + 1) * C;
  depthwise_bwd_w_reduce_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(
      scratch, static_cast<T*>(dw), static_cast<T*>(db), n_chunks, C, K);
  return cudaGetLastError();
}

}  // namespace

// Frames of one utterance that one block of depthwise_conv1d_bwd_w reduces;
// the caller sizes the scratch from it.
extern "C" int depthwise_conv1d_bwd_w_previous_time_chunk() { return kBwdTT; }

// dW (K, C) and db (C,) of the depthwise conv from x and the output
// gradient g, both (B, T, C) of `dtype` (0 = float32, 1 = bfloat16); dw and
// db come out in that type, sums in float32.  `scratch` is float32 of
// scratch_chunks × (K + 1) × C elements with scratch_chunks =
// B · ceil(T / time_chunk), allocated by the caller.  Launches two kernels
// on `stream`; returns the cudaError_t of the launches (0 on success).
extern "C" int depthwise_conv1d_bwd_w_previous(
    const void* x, const void* g, void* scratch, void* dw, void* db,
    int B, int Tn, int C, int K, int pad_l, int scratch_chunks, int dtype,
    cudaStream_t stream)
{
  if (K < 1 || K > kMaxK || pad_l < 0 || pad_l >= K || B < 0 || Tn < 0 ||
      (C + kTC - 1) / kTC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = static_cast<long long>(B) * ((Tn + kBwdTT - 1) / kBwdTT);
  if (chunks != scratch_chunks) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  cudaError_t err;
  if (dtype == 0)
    err = launch_bwd_w<float>(x, g, static_cast<float*>(scratch), dw, db, B, Tn, C, K, pad_l,
                              stream);
  else if (dtype == 1)
    err = launch_bwd_w<__nv_bfloat16>(x, g, static_cast<float*>(scratch), dw, db, B, Tn, C, K,
                                      pad_l, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
