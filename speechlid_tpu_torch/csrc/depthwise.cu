// Depthwise (per-channel) 1-D convolution for Hopper (sm_90a): the forward
// (which also serves dX in the backward) and the dW/db reduction.
//
// Replaces the Pallas TPU kernel speechlid_tpu/ops/pallas/depthwise_kernel.py
// (_pallas_impl / _dw_kernel_3d): 'SAME' depthwise conv1d plus bias,
//
//   y[b, t, c] = bias[c] + Σ_j x[b, t + j - pad_l, c] · w[j, c]
//
// over (B, T, C) activations with channels last, zeros outside [0, T).
// pad_l is an argument: (k-1)//2 for the forward.  For dX in a backward
// pass the same kernel runs on the output gradient with pad_l =
// k-1-(k-1)//2, `flip` set (tap j reads w[k-1-j]: the transposed
// correlation, with no flipped copy of the weights) and a null bias (taken
// as zero), so dX is one launch and nothing else.
//
// What bounds it: 2·k FLOP per output against 2 × 4 bytes of input and
// output per element (f32) — about 8 FLOP a byte at k = 31, under the
// card's ~20 FLOP/byte FP32 ridge, so it is bound by bytes, and at the
// Conformer's shapes (74 × 288 per utterance) by launch latency.
//
// Design: one block per (channel tile of 32, time tile of 32, utterance).
// The block stages the (32 + k - 1) × 32 input span (its halo included)
// and the k × 32 weights in shared memory with channels contiguous, so
// every global load and store of a warp covers 32 neighbouring channels.
// Each thread accumulates in float32 in a fixed tap order, adds the bias,
// and stores in the input type (float32 or bfloat16).
//
// The weight/bias gradient (depthwise_conv1d_bwd_w) replaces the XLA
// reductions inside the same TPU kernel's custom_vjp (_dw_bwd):
//
//   dW[j, c] = Σ_{b,t} x[b, t + j - pad_l, c] · g[b, t, c]    db[c] = Σ_{b,t} g[b, t, c]
//
// It reads x and g once (2 × 4 bytes per element, f32) for 2·k FLOP, so it
// is bound by bytes like the forward, and at the Conformer's shapes by the
// floor of a launch: the work is a few microseconds, so every further
// launch and every round trip through device memory shows.  Design: one
// launch, one thread-block cluster per channel tile of 32.  The B·ceil(T/64)
// time chunks of 64 frames are split over the cluster's blocks (at most 8)
// in index order, block r taking chunks [r·n/R, (r+1)·n/R).  A block of
// 32 × 32 threads stages one chunk's x span with its halo and its g tile in
// shared memory as the forward does.  A thread owns a channel, a quarter of
// the chunk's frames and four neighbouring taps (eight with k > 32): a
// window of four x values slides along its 16 frames, so a frame costs one
// g and one new x from shared memory for four FMAs, and its sums stay in
// registers from chunk to chunk of the block's share.  The block adds its
// four quarters in order and leaves the (k + 1) × 32 partial in its own
// shared memory; after a cluster barrier the rows are dealt over the
// blocks, and each row's owner adds the blocks' partials in rank order
// through distributed shared memory and writes dW and db.  No scratch in device memory, no second kernel, no
// atomics: the order of every sum is fixed by the shape alone, so the
// result is the same bits on every run.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

#if !defined(DW_MAX_KERNEL_SIZE) || !defined(DW_BWD_TIME_CHUNK) || !defined(DW_BWD_QUARTERS) || \
    !defined(DW_BWD_MAX_CLUSTER)
#error "the tile sizes come as -D definitions from ops/cuda/_build.py (TILING)"
#endif
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
    const T* __restrict__ bias,  // (C,), or null for zero
    T* __restrict__ y,           // (B, T, C)
    int Tn, int C, int K, int pad_l, int flip)
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
    ws[j * kTC + tx] = c_ok ? to_f32(w[(flip ? K - 1 - j : j) * C + c]) : 0.f;
  __syncthreads();
  if (!c_ok) return;

  const float bv = bias ? to_f32(bias[c]) : 0.f;
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
                   int B, int Tn, int C, int K, int pad_l, int flip, cudaStream_t stream) {
  const dim3 grid((C + kTC - 1) / kTC, (Tn + kTT - 1) / kTT, B);
  const dim3 block(kTC, kRows);
  const size_t smem = sizeof(float) * static_cast<size_t>(kTT + 2 * K - 1) * kTC;
  depthwise_conv1d_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), Tn, C, K, pad_l, flip);
  return cudaGetLastError();
}

constexpr int kMaxK = DW_MAX_KERNEL_SIZE;   // taps: the staging stays under 48 KB
constexpr int kBwdTT = DW_BWD_TIME_CHUNK;   // frames per time chunk
constexpr int kBwdRows = 32;                // thread rows of a bwd_w block
constexpr int kQuarters = DW_BWD_QUARTERS;           // a chunk's frames, split over thread rows
constexpr int kQuarterTT = kBwdTT / kQuarters;       // 16 frames a thread
constexpr int kGroupRows = kBwdRows / kQuarters;     // 8 tap groups at a time
constexpr int kGroupTaps = 4;                        // taps a thread carries per group
constexpr int kPasses = kMaxK / (kGroupRows * kGroupTaps);  // groups a thread takes: g, g + 8
constexpr int kXRows = kBwdTT + kPasses * kGroupRows * kGroupTaps;  // no window leaves the span
constexpr int kBwdMaxCluster = DW_BWD_MAX_CLUSTER;  // 8 is the portable cluster size
static_assert(kBwdTT % kQuarters == 0 && kBwdRows % kQuarters == 0 && kBwdTT % kBwdRows == 0 &&
              kMaxK % (kGroupRows * kGroupTaps) == 0 && kXRows % kBwdRows == 0,
              "chunks, quarters and tap groups divide evenly");
static_assert(kBwdMaxCluster >= 1 && kBwdMaxCluster <= 8, "portable cluster size");

template <typename T>
__global__ void __launch_bounds__(kTC * kBwdRows) depthwise_bwd_w_kernel(
    const T* __restrict__ x,   // (B, T, C)
    const T* __restrict__ g,   // (B, T, C)
    T* __restrict__ dw,        // (K, C)
    T* __restrict__ db,        // (C,)
    int Tn, int C, int K, int pad_l, int chunks_per_utt, int n_chunks)
{
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int span = kBwdTT + K - 1;
  const int rows = K + 1;             // the taps, and db
  float* xs = smem;                   // kXRows × kTC, zeros past the span
  float* gs = xs + kXRows * kTC;      // kBwdTT × kTC
  float* quart = gs + kBwdTT * kTC;   // kQuarters × rows × kTC; quarter 0 becomes the block's partial

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int quarter = ty / kGroupRows;   // frames [16·quarter, 16·quarter + 16) of a chunk
  const int group = ty % kGroupRows;     // taps 4·group …, and 4·(group + 8) … when K > 32
  const int c = blockIdx.y * kTC + tx;
  const bool c_ok = c < C;

  float acc[kPasses][kGroupTaps];
  float acc_b = 0.f;
#pragma unroll
  for (int p = 0; p < kPasses; ++p)
#pragma unroll
    for (int i = 0; i < kGroupTaps; ++i) acc[p][i] = 0.f;

  // this block's share of the chunks, in index order
  const int first = static_cast<int>(static_cast<long long>(rank) * n_chunks / n_blocks);
  const int last = static_cast<int>(static_cast<long long>(rank + 1) * n_chunks / n_blocks);
  for (int chunk = first; chunk < last; ++chunk) {
    const int utt = chunk / chunks_per_utt;
    const int t0 = (chunk - utt * chunks_per_utt) * kBwdTT;
    const T* xb = x + static_cast<size_t>(utt) * Tn * C;
    const T* gb = g + static_cast<size_t>(utt) * Tn * C;
    // fixed trip counts, unrolled: a thread's loads are in flight together
#pragma unroll
    for (int i = 0; i < kXRows / kBwdRows; ++i) {
      const int r = ty + i * kBwdRows;
      const int t = t0 - pad_l + r;
      xs[r * kTC + tx] = (c_ok && r < span && t >= 0 && t < Tn)
                             ? to_f32(xb[static_cast<size_t>(t) * C + c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBwdTT / kBwdRows; ++i) {
      const int r = ty + i * kBwdRows;
      const int t = t0 + r;
      gs[r * kTC + tx] = (c_ok && t < Tn) ? to_f32(gb[static_cast<size_t>(t) * C + c]) : 0.f;
    }
    __syncthreads();

    // a window of four x values slides along the thread's 16 frames: per
    // frame one g and one new x from shared memory for four FMAs
    const int r0 = quarter * kQuarterTT;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int j0 = (group + p * kGroupRows) * kGroupTaps;
      if (j0 < K) {  // uniform over the warp
        const float* xw = xs + (r0 + j0) * kTC + tx;
        float x0 = xw[0], x1 = xw[kTC], x2 = xw[2 * kTC];
#pragma unroll
        for (int r = 0; r < kQuarterTT; ++r) {
          const float gv = gs[(r0 + r) * kTC + tx];
          const float x3 = xw[(r + 3) * kTC];
          acc[p][0] = fmaf(x0, gv, acc[p][0]);
          acc[p][1] = fmaf(x1, gv, acc[p][1]);
          acc[p][2] = fmaf(x2, gv, acc[p][2]);
          acc[p][3] = fmaf(x3, gv, acc[p][3]);
          if (p == 0 && group == 0) acc_b += gv;
          x0 = x1;
          x1 = x2;
          x2 = x3;
        }
      }
    }
    __syncthreads();  // every thread is done with xs and gs: the next chunk may land
  }

  // the quarters' sums side by side, then added in quarter order
  float* mine = quart + quarter * rows * kTC;
#pragma unroll
  for (int p = 0; p < kPasses; ++p)
#pragma unroll
    for (int i = 0; i < kGroupTaps; ++i) {
      const int j = (group + p * kGroupRows) * kGroupTaps + i;
      if (j < K) mine[j * kTC + tx] = acc[p][i];
    }
  if (group == 0) mine[K * kTC + tx] = acc_b;
  __syncthreads();
  float* part = quart;  // (K + 1) × kTC: this block's partial sums
  for (int j = ty; j <= K; j += kBwdRows) {
    float s = quart[j * kTC + tx];
#pragma unroll
    for (int q = 1; q < kQuarters; ++q) s += quart[(q * rows + j) * kTC + tx];
    part[j * kTC + tx] = s;
  }
  cluster.sync();  // every block's partial is written

  // row j (a tap, or K for db) belongs to block j % n_blocks, which adds
  // the blocks' partials in rank order
  for (int j = rank + n_blocks * ty; j <= K; j += n_blocks * kBwdRows) {
    float s = 0.f;
    for (int q = 0; q < n_blocks; ++q) s += cluster.map_shared_rank(part, q)[j * kTC + tx];
    if (c_ok) {
      if (j < K)
        dw[static_cast<size_t>(j) * C + c] = from_f32<T>(s);
      else
        db[c] = from_f32<T>(s);
    }
  }
  cluster.sync();  // no block leaves while its partial may still be read
}

template <typename T>
cudaError_t launch_bwd_w(const void* x, const void* g, void* dw, void* db,
                         int B, int Tn, int C, int K, int pad_l, cudaStream_t stream) {
  const int chunks_per_utt = (Tn + kBwdTT - 1) / kBwdTT;
  const long long chunks = static_cast<long long>(B) * chunks_per_utt;
  if (chunks > 2147483647LL) return cudaErrorInvalidValue;
  const int n_chunks = static_cast<int>(chunks);
  const int n_blocks = n_chunks < 1 ? 1 : (n_chunks > kBwdMaxCluster ? kBwdMaxCluster : n_chunks);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n_blocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks, (C + kTC - 1) / kTC);
  cfg.blockDim = dim3(kTC, kBwdRows);
  const size_t smem =
      sizeof(float) * static_cast<size_t>(kXRows + kBwdTT + kQuarters * (K + 1)) * kTC;
  if (smem > 48 * 1024) {  // K > 47: over the default limit of dynamic shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        depthwise_bwd_w_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dwt = static_cast<T*>(dw);
  T* dbt = static_cast<T*>(db);
  return cudaLaunchKernelEx(&cfg, depthwise_bwd_w_kernel<T>, xt, gt, dwt, dbt, Tn, C, K, pad_l,
                            chunks_per_utt, n_chunks);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, bias and y all of that type).
// `bias` may be null (zero); `flip` != 0 reads the taps in reverse time
// order.  Launches on `stream`; allocates nothing.  Returns the cudaError_t
// of the launch (0 on success).  K <= kMaxK keeps the staging under 48 KB.
extern "C" int depthwise_conv1d_fwd(
    const void* x, const void* w, const void* bias, void* y,
    int B, int Tn, int C, int K, int pad_l, int flip, int dtype, cudaStream_t stream)
{
  if (K < 1 || K > kMaxK || pad_l < 0 || pad_l >= K || B > 65535 ||
      (Tn + kTT - 1) / kTT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Tn == 0 || C == 0) return 0;
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, w, bias, y, B, Tn, C, K, pad_l, flip, stream);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, w, bias, y, B, Tn, C, K, pad_l, flip, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// dW (K, C) and db (C,) of the depthwise conv from x and the output
// gradient g, both (B, T, C) of `dtype` (0 = float32, 1 = bfloat16); dw and
// db come out in that type, sums in float32.  Launches one cluster kernel on
// `stream`; allocates nothing.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int depthwise_conv1d_bwd_w(
    const void* x, const void* g, void* dw, void* db,
    int B, int Tn, int C, int K, int pad_l, int dtype, cudaStream_t stream)
{
  if (K < 1 || K > kMaxK || pad_l < 0 || pad_l >= K || B < 0 || Tn < 0 ||
      (C + kTC - 1) / kTC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  cudaError_t err;
  if (dtype == 0)
    err = launch_bwd_w<float>(x, g, dw, db, B, Tn, C, K, pad_l, stream);
  else if (dtype == 1)
    err = launch_bwd_w<__nv_bfloat16>(x, g, dw, db, B, Tn, C, K, pad_l, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* speechlid_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
