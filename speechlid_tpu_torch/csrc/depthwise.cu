// Depthwise (per-channel) 1-D convolution for Hopper (sm_90a), forward.
//
// Replaces the Pallas TPU kernel speechlid_tpu/ops/pallas/depthwise_kernel.py
// (_pallas_impl / _dw_kernel_3d): 'SAME' depthwise conv1d plus bias,
//
//   y[b, t, c] = bias[c] + Σ_j x[b, t + j - pad_l, c] · w[j, c]
//
// over (B, T, C) activations with channels last, zeros outside [0, T).
// pad_l is an argument: (k-1)//2 for the forward, and k-1-(k-1)//2 with
// time-flipped weights for dX in a backward pass.
//
// What bounds it: 2·k FLOP per output against 2 × 4 bytes of input and
// output per element (f32) — about 8 FLOP a byte at k = 31, under the
// card's ~20 FLOP/byte FP32 ridge, so it is bound by bytes, and at the
// Conformer's serving shapes (74 × 288 per utterance) by launch latency.
//
// Design: one block per (channel tile of 32, time tile of 32, utterance).
// The block stages the (32 + k - 1) × 32 input span (its halo included)
// and the k × 32 weights in shared memory with channels contiguous, so
// every global load and store of a warp covers 32 neighbouring channels.
// Each thread accumulates in float32 in a fixed tap order, adds the bias,
// and stores in the input type (float32 or bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTT = 32;    // time steps per block
constexpr int kTC = 32;    // channels per block (one warp across)
constexpr int kRows = 8;   // threads along time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void depthwise_conv1d_kernel(
    const T* __restrict__ x,     // (B, T, C)
    const T* __restrict__ w,     // (K, C)
    const T* __restrict__ bias,  // (C,)
    T* __restrict__ y,           // (B, T, C)
    int Tn, int C, int K, int pad_l)
{
  extern __shared__ float smem[];
  const int span = kTT + K - 1;
  float* xs = smem;               // span × kTC
  float* ws = smem + span * kTC;  // K × kTC

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int c = blockIdx.x * kTC + tx;
  const int t0 = blockIdx.y * kTT;
  const bool c_ok = c < C;
  const T* xb = x + static_cast<size_t>(blockIdx.z) * Tn * C;
  T* yb = y + static_cast<size_t>(blockIdx.z) * Tn * C;

  for (int r = ty; r < span; r += kRows) {
    const int t = t0 - pad_l + r;
    xs[r * kTC + tx] =
        (c_ok && t >= 0 && t < Tn) ? to_f32(xb[static_cast<size_t>(t) * C + c]) : 0.f;
  }
  for (int j = ty; j < K; j += kRows)
    ws[j * kTC + tx] = c_ok ? to_f32(w[j * C + c]) : 0.f;
  __syncthreads();
  if (!c_ok) return;

  const float bv = to_f32(bias[c]);
  for (int r = ty; r < kTT; r += kRows) {
    const int t = t0 + r;
    if (t >= Tn) break;
    float acc = 0.f;
    for (int j = 0; j < K; ++j) acc = fmaf(xs[(r + j) * kTC + tx], ws[j * kTC + tx], acc);
    yb[static_cast<size_t>(t) * C + c] = from_f32<T>(acc + bv);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   int B, int Tn, int C, int K, int pad_l, cudaStream_t stream) {
  const dim3 grid((C + kTC - 1) / kTC, (Tn + kTT - 1) / kTT, B);
  const dim3 block(kTC, kRows);
  const size_t smem = sizeof(float) * static_cast<size_t>(kTT + 2 * K - 1) * kTC;
  depthwise_conv1d_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), Tn, C, K, pad_l);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, bias and y all of that type).
// Launches on `stream`; allocates nothing.  Returns the cudaError_t of the
// launch (0 on success).  K <= 64 keeps the staging under 48 KB.
extern "C" int depthwise_conv1d_fwd(
    const void* x, const void* w, const void* bias, void* y,
    int B, int Tn, int C, int K, int pad_l, int dtype, cudaStream_t stream)
{
  if (K < 1 || K > 64 || pad_l < 0 || pad_l >= K || B > 65535 ||
      (Tn + kTT - 1) / kTT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Tn == 0 || C == 0) return 0;
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, w, bias, y, B, Tn, C, K, pad_l, stream);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, w, bias, y, B, Tn, C, K, pad_l, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* speechlid_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
