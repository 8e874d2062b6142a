// Depthwise (per-channel) 1-D convolution for Hopper (sm_90a): the forward
// kernel, which is also the conv module's one kernel between its two
// pointwise GEMMs and serves dX in the backward, and the dW/db reduction.
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
// The forward kernel is one template with a prologue (what it stages) and
// an epilogue (what it writes), so that the Conformer conv module's
// elementwise passes around the conv run inside it:
//
//   prologue  plain    x, as above;
//             GLU      the pointwise GEMM's output h (B, T, 2C): the conv's
//                      input is u = h[..., :C]·σ(h[..., C:]), formed once per
//                      staged element, and 0 where mask[b, t] is false and
//                      outside [0, T).  With a `u` pointer the block also
//                      writes u for its own frames (training: bwd_w needs it).
//   epilogue  bias     y = conv + bias;
//             BN+act   y = act((v − mean)·rsqrt(var + eps)·weight + bn_bias),
//                      v = conv + bias: eval BatchNorm from the running
//                      statistics in the module's order of operations (not
//                      folded into one scale and shift), act Swish (z·σ(z))
//                      or DoubleSwish (z·σ(z − 1));
//             GLU bwd  with `flip` and no bias, on the output gradient: the
//                      conv gives du, and the kernel writes dh (B, T, 2C) =
//                      mask·[du·σ(g), du·a·σ(g)·(1 − σ(g))] from the saved h.
//
// In bfloat16 and float16 everything is computed in float and rounded to
// the 16-bit type where the JAX package's conv module of that dtype rounds:
// u before the conv (the u written for dW is the one the conv read), the
// conv output before BatchNorm, BatchNorm's output before the act, and the
// output; in the GLU backward du (dX's output) before the product, and dh.
// Every template below takes float, __nv_bfloat16 or __half.
//
// In eval one launch replaces the 13 of GLU, mask, conv, BatchNorm and
// Swish; in training the forward takes GLU and mask (5 launches become 1)
// and dX takes the GLU backward (6 become 1).
//
// What bounds it: 2·k FLOP per output against at least 12 bytes moved per
// output in float32 (read a and g, write y) — about 5 FLOP a byte at
// k = 31, under the card's ~20 FLOP/byte FP32 ridge, so it is bound by
// bytes, and at the Conformer's shapes (74 × 288 per utterance) by the
// floor of a launch.  There is no reduction over channels, so tensor cores,
// TMA and wgmma have nothing to do here; what the design can win is whole
// launches and the (B, T, C) round trips between them.
//
// Design: one block per (32 channels, DW_FWD_TIME_TILE frames, utterance),
// 8 threads across the channels and one row of threads per
// DW_FWD_THREAD_FRAMES frames (24 and 2 from TILING: 96 threads, 36 blocks
// at (1, 74, 288), 1152 at (32, 74, 288); chosen over 13 other tilings by
// scripts/depthwise_fwd_tilings.py, PERF.md).  The block stages its span
// (its frames plus the k − 1 halo; a and g for the GLU prologue) with
// 16-byte cp.async copies, all in flight at once and
// zero-filled outside [0, T), while it loads the k × 32 weights (flipped
// for dX) as float.  The prologue then forms the conv's input in float once
// per staged element (in place over a for float32).  A thread owns four
// neighbouring channels (float4 from shared memory) and
// DW_FWD_THREAD_FRAMES consecutive frames: a window of that many input rows
// slides along the taps in registers, so a tap costs one weight and one
// input load for 4·DW_FWD_THREAD_FRAMES FMAs.  Each output is summed in
// float32 in tap order, and its epilogue reads its channels' parameters
// once a thread.  A channel count that is not a multiple of 16 bytes, or a
// pointer that is not 16-byte aligned, takes the same kernel with scalar
// loads and stores.  IEEE expf and division (no fast math) for σ.
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
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

#if !defined(DW_MAX_KERNEL_SIZE) || !defined(DW_BWD_TIME_CHUNK) || !defined(DW_BWD_QUARTERS) || \
    !defined(DW_BWD_MAX_CLUSTER) || !defined(DW_FWD_TIME_TILE) || !defined(DW_FWD_THREAD_FRAMES)
#error "the tile sizes come as -D definitions from ops/cuda/_build.py (TILING)"
#endif
constexpr int kMaxK = DW_MAX_KERNEL_SIZE;   // taps: the staging stays under 48 KB
constexpr int kTC = 32;                     // channels per block
constexpr int kGroups = kTC / 4;            // threads across a block's channels, four each
constexpr int kTT = DW_FWD_TIME_TILE;       // frames per block
constexpr int kR = DW_FWD_THREAD_FRAMES;    // consecutive frames a thread sums
constexpr int kFwdThreads = kGroups * (kTT / kR);
static_assert(kTT % kR == 0 && kFwdThreads % 32 == 0, "a block is whole warps of frame rows");

enum Prologue { kPlainIn = 0, kGluIn = 1 };
enum Epilogue { kBiasOut = 0, kBnActOut = 1, kGluBwdOut = 2 };

struct FwdArgs {
  const void* x;               // plain: (B, T, C); GLU: h (B, T, 2C)
  const unsigned char* mask;   // (B, T) bool, or null: every frame valid
  const void* w;               // (K, C)
  const void* bias;            // (C,), or null for zero
  const float* bn_mean;        // BN+act: (C,) float32 each
  const float* bn_var;
  const float* bn_weight;
  const float* bn_bias;
  float eps;
  int act;                     // BN+act: 0 Swish, 1 DoubleSwish
  const void* h;               // GLU bwd: the forward's h (B, T, 2C)
  void* u;                     // GLU prologue: u (B, T, C) out, or null
  void* y;                     // (B, T, C); GLU bwd: dh (B, T, 2C)
  int Tn, C, K, pad_l, flip;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
// two packed 16-bit values (the low one first) as float, and back
__device__ __forceinline__ float2 pair_to_f32(unsigned raw, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
}
__device__ __forceinline__ float2 pair_to_f32(unsigned raw, __half) {
  return __half22float2(*reinterpret_cast<const __half2*>(&raw));
}
__device__ __forceinline__ unsigned pair_from_f32(float lo, float hi, __nv_bfloat16) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ unsigned pair_from_f32(float lo, float hi, __half) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
// v as the module's tensors of type T hold it
template <typename T> __device__ __forceinline__ float in_type(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }
__device__ __forceinline__ float& at(float4& v, int i) { return reinterpret_cast<float*>(&v)[i]; }
__device__ __forceinline__ float at(const float4& v, int i) {
  return reinterpret_cast<const float*>(&v)[i];
}
__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// channels c … c + 3 of one frame (`row` is its channel 0) as float, 0 past C
template <typename T, bool kVec>
__device__ __forceinline__ float4 load4(const T* row, int c, int C) {
  float4 v = zero4();
  if constexpr (kVec) {  // C is a multiple of the 16-byte width: all four or none
    if (c >= C) return v;
    if constexpr (std::is_same<T, float>::value) {
      v = *reinterpret_cast<const float4*>(row + c);
    } else {
      const uint2 raw = *reinterpret_cast<const uint2*>(row + c);
      const float2 lo = pair_to_f32(raw.x, T());
      const float2 hi = pair_to_f32(raw.y, T());
      v = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c + i < C) at(v, i) = to_f32(row[c + i]);
  }
  return v;
}

template <typename T, bool kVec>
__device__ __forceinline__ void store4(T* row, int c, int C, float4 v) {
  if constexpr (kVec) {
    if (c >= C) return;
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float4*>(row + c) = v;
    } else {
      uint2 raw;
      raw.x = pair_from_f32(v.x, v.y, T());
      raw.y = pair_from_f32(v.z, v.w, T());
      *reinterpret_cast<uint2*>(row + c) = raw;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c + i < C) row[c + i] = from_f32<T>(at(v, i));
  }
}

__device__ __forceinline__ float4 lds4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// shared memory of one block: the weights, the staged span as it arrives,
// and (16-bit types) the conv's input in float; float32 forms it in place
__host__ __device__ constexpr int fwd_parts(int pro) { return pro == kGluIn ? 2 : 1; }
template <typename T, int kPro>
__host__ __device__ size_t fwd_smem_bytes(int K) {
  const size_t rows = kTT + K;  // the span, and the row the last tap's window reads past it
  const size_t xs = std::is_same<T, float>::value ? 0 : sizeof(float) * rows * kTC;
  return sizeof(float) * K * kTC + sizeof(T) * rows * fwd_parts(kPro) * kTC + xs;
}

template <typename T, int kPro, int kEpi, bool kVec>
__global__ void __launch_bounds__(kFwdThreads) depthwise_conv1d_kernel(const FwdArgs a) {
  constexpr int kParts = fwd_parts(kPro);
  constexpr bool kInPlace = std::is_same<T, float>::value;  // the input is formed over the staging
  constexpr int kXS = kInPlace ? kParts * kTC : kTC;         // floats between frames of xs
  const int Tn = a.Tn, C = a.C, K = a.K;
  const int rows = kTT + K;
  const int span = kTT + K - 1;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);                   // K × kTC
  T* raw = reinterpret_cast<T*>(ws + K * kTC);                   // rows × kParts·kTC, as staged
  float* xs = kInPlace ? reinterpret_cast<float*>(raw)
                       : reinterpret_cast<float*>(raw + static_cast<size_t>(rows) * kParts * kTC);

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kTC;
  const int t0 = blockIdx.y * kTT;
  const int b = blockIdx.z;
  const size_t in_stride = static_cast<size_t>(kParts) * C;  // elements between input frames
  const T* xb = static_cast<const T*>(a.x) + static_cast<size_t>(b) * Tn * in_stride;
  const unsigned char* mb = a.mask ? a.mask + static_cast<size_t>(b) * Tn : nullptr;

  if constexpr (kVec) {  // the span (a and g for GLU), every copy in flight at once
    constexpr int kVecT = 16 / sizeof(T);
    constexpr int kCopies = kParts * kTC / kVecT;  // 16-byte copies of one row
    for (int i = tid; i < span * kCopies; i += kFwdThreads) {
      const int r = i / kCopies;
      const int q = i - r * kCopies;
      const int part = q / (kTC / kVecT);
      const int t = t0 - a.pad_l + r;
      const int c = c0 + (q - part * (kTC / kVecT)) * kVecT;
      const bool ok = t >= 0 && t < Tn && c < C;
      const T* src = ok ? xb + t * in_stride + static_cast<size_t>(part) * C + c : xb;
      __pipeline_memcpy_async(raw + static_cast<size_t>(r) * kParts * kTC + q * kVecT, src, 16,
                              ok ? 0 : 16);
    }
    __pipeline_commit();
  }
  {  // the weights, while the span is in flight
    const T* w = static_cast<const T*>(a.w);
    for (int i = tid; i < K * kGroups; i += kFwdThreads) {
      const int j = i / kGroups;
      const int g4 = 4 * (i - j * kGroups);
      const T* row = w + static_cast<size_t>(a.flip ? K - 1 - j : j) * C;
      *reinterpret_cast<float4*>(ws + j * kTC + g4) = load4<T, kVec>(row, c0 + g4, C);
    }
  }
  if constexpr (kVec) __pipeline_wait_prior(0);
  __syncthreads();

  // the prologue: the conv's input in float, once per staged element
  if constexpr (kPro == kGluIn || !kInPlace || !kVec) {
    T* ub = (kPro == kGluIn && a.u) ? static_cast<T*>(a.u) + static_cast<size_t>(b) * Tn * C
                                    : nullptr;
    for (int i = tid; i < span * kGroups; i += kFwdThreads) {
      const int r = i / kGroups;
      const int g4 = 4 * (i - r * kGroups);
      const int t = t0 - a.pad_l + r;
      const bool in_range = t >= 0 && t < Tn;
      const T* sr = raw + static_cast<size_t>(r) * kParts * kTC;
      float4 v;
      if constexpr (kVec)
        v = load4<T, true>(sr, g4, kTC);
      else
        v = in_range ? load4<T, false>(xb + t * in_stride, c0 + g4, C) : zero4();
      if constexpr (kPro == kGluIn) {
        float4 gv;
        if constexpr (kVec)
          gv = load4<T, true>(sr + kTC, g4, kTC);
        else
          gv = in_range ? load4<T, false>(xb + t * in_stride + C, c0 + g4, C) : zero4();
        if (in_range && (mb == nullptr || mb[t])) {
#pragma unroll
          for (int e = 0; e < 4; ++e) at(v, e) = in_type<T>(at(v, e) * sigmoid(at(gv, e)));
        } else {
          v = zero4();
        }
        if (ub != nullptr && r >= a.pad_l && r < a.pad_l + kTT && t < Tn)
          store4<T, kVec>(ub + static_cast<size_t>(t) * C, c0 + g4, C, v);
      }
      *reinterpret_cast<float4*>(xs + r * kXS + g4) = v;
    }
    __syncthreads();
  }

  // the taps: a window of kR input rows slides along them in registers
  const int g4 = 4 * (tid % kGroups);
  const int r0 = (tid / kGroups) * kR;
  const float* xc = xs + g4;
  const float* wc = ws + g4;
  float4 acc[kR], win[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    acc[r] = zero4();
    win[r] = lds4(xc + (r0 + r) * kXS);
  }
  for (int j = 0; j < K; ++j) {
    const float4 wv = lds4(wc + j * kTC);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      acc[r].x = fmaf(win[r].x, wv.x, acc[r].x);
      acc[r].y = fmaf(win[r].y, wv.y, acc[r].y);
      acc[r].z = fmaf(win[r].z, wv.z, acc[r].z);
      acc[r].w = fmaf(win[r].w, wv.w, acc[r].w);
    }
#pragma unroll
    for (int r = 0; r + 1 < kR; ++r) win[r] = win[r + 1];
    win[kR - 1] = lds4(xc + (r0 + kR + j) * kXS);  // row ≤ kTT + K − 1 < rows
  }

  // the epilogue
  const int c = c0 + g4;
  if (c >= C) return;
  const float4 bv = a.bias ? load4<T, kVec>(static_cast<const T*>(a.bias), c, C) : zero4();
  float4 mean = zero4(), rs = zero4(), bw = zero4(), bb = zero4();
  if constexpr (kEpi == kBnActOut) {
    mean = load4<float, kVec>(a.bn_mean, c, C);
    const float4 var = load4<float, kVec>(a.bn_var, c, C);
    bw = load4<float, kVec>(a.bn_weight, c, C);
    bb = load4<float, kVec>(a.bn_bias, c, C);
#pragma unroll
    for (int e = 0; e < 4; ++e) at(rs, e) = 1.f / sqrtf(at(var, e) + a.eps);
  }
  const size_t out_stride = static_cast<size_t>(kEpi == kGluBwdOut ? 2 : 1) * C;
  T* yb = static_cast<T*>(a.y) + static_cast<size_t>(b) * Tn * out_stride;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int t = t0 + r0 + r;
    if (t >= Tn) break;
    float4 v = acc[r];
    T* out = yb + t * out_stride;
    if constexpr (kEpi == kBiasOut) {
#pragma unroll
      for (int e = 0; e < 4; ++e) at(v, e) += at(bv, e);
      store4<T, kVec>(out, c, C, v);
    } else if constexpr (kEpi == kBnActOut) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float conv = in_type<T>(at(v, e) + at(bv, e));
        const float z = in_type<T>(__fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(conv, at(mean, e)), at(rs, e)), at(bw, e)), at(bb, e)));
        at(v, e) = __fmul_rn(z, sigmoid(a.act ? z - 1.f : z));
      }
      store4<T, kVec>(out, c, C, v);
    } else {  // the GLU backward at frame t from the saved h
      const T* hr = static_cast<const T*>(a.h) + (static_cast<size_t>(b) * Tn + t) * 2 * C;
      const float4 av = load4<T, kVec>(hr, c, C);
      const float4 gv = load4<T, kVec>(hr + C, c, C);
      float4 da = zero4(), dg = zero4();
      if (mb == nullptr || mb[t]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s = sigmoid(at(gv, e));
          const float du = in_type<T>(at(v, e));  // dX as a tensor of type T holds it
          at(da, e) = du * s;
          at(dg, e) = du * at(av, e) * s * (1.f - s);
        }
      }
      store4<T, kVec>(out, c, C, da);
      store4<T, kVec>(out + C, c, C, dg);
    }
  }
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int kPro, int kEpi>
cudaError_t launch_fwd(const FwdArgs& a, int B, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<T, kPro>(a.K);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;  // kMaxK and kTT keep it under
  const dim3 grid((a.C + kTC - 1) / kTC, (a.Tn + kTT - 1) / kTT, B);
  const bool vec = a.C % (16 / static_cast<int>(sizeof(T))) == 0 && aligned16(a.x) &&
                   aligned16(a.w) && aligned16(a.bias) && aligned16(a.bn_mean) &&
                   aligned16(a.bn_var) && aligned16(a.bn_weight) && aligned16(a.bn_bias) &&
                   aligned16(a.h) && aligned16(a.u) && aligned16(a.y);
  if (vec)
    depthwise_conv1d_kernel<T, kPro, kEpi, true><<<grid, kFwdThreads, smem, stream>>>(a);
  else
    depthwise_conv1d_kernel<T, kPro, kEpi, false><<<grid, kFwdThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// the shape limits of every mode of the forward kernel
bool fwd_shape_ok(int B, int Tn, int C, int K, int pad_l) {
  return K >= 1 && K <= kMaxK && pad_l >= 0 && pad_l < K && B >= 0 && Tn >= 0 && C >= 0 &&
         B <= 65535 && (Tn + kTT - 1) / kTT <= 65535;
}

template <int kPro, int kEpi>
int dispatch_fwd(const FwdArgs& a, int B, int dtype, cudaStream_t stream) {
  if (!fwd_shape_ok(B, a.Tn, a.C, a.K, a.pad_l)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || a.Tn == 0 || a.C == 0) return 0;
  cudaError_t err;
  if (dtype == 0)
    err = launch_fwd<float, kPro, kEpi>(a, B, stream);
  else if (dtype == 1)
    err = launch_fwd<__nv_bfloat16, kPro, kEpi>(a, B, stream);
  else if (dtype == 2)
    err = launch_fwd<__half, kPro, kEpi>(a, B, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

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

// The forward kernel's modes.  dtype: 0 = float32, 1 = bfloat16, 2 =
// float16 (the activations, w and bias of that type; BatchNorm's
// parameters float32).
// Each launches one kernel on `stream`, allocates nothing, and returns the
// cudaError_t of the launch (0 on success).  K <= kMaxK keeps the staging
// under 48 KB.

// Plain: y = conv(x) + bias.  `bias` may be null (zero); `flip` != 0 reads
// the taps in reverse time order (dX).
extern "C" int depthwise_conv1d_fwd(
    const void* x, const void* w, const void* bias, void* y,
    int B, int Tn, int C, int K, int pad_l, int flip, int dtype, cudaStream_t stream)
{
  FwdArgs a = {};
  a.x = x; a.w = w; a.bias = bias; a.y = y;
  a.Tn = Tn; a.C = C; a.K = K; a.pad_l = pad_l; a.flip = flip;
  return dispatch_fwd<kPlainIn, kBiasOut>(a, B, dtype, stream);
}

// GLU prologue on h (B, T, 2C) with the padding mask ((B, T) bool, or null).
// With bn_mean null: y = conv(u) + bias, and u (B, T, C) written unless `u`
// is null.  Otherwise eval BatchNorm and the activation (act 0 Swish, 1
// DoubleSwish) behind the conv, and `u` must be null.
extern "C" int depthwise_conv1d_glu_fwd(
    const void* h, const void* mask, const void* w, const void* bias,
    const float* bn_mean, const float* bn_var, const float* bn_weight, const float* bn_bias,
    float eps, int act, void* u, void* y,
    int B, int Tn, int C, int K, int pad_l, int dtype, cudaStream_t stream)
{
  FwdArgs a = {};
  a.x = h; a.mask = static_cast<const unsigned char*>(mask); a.w = w; a.bias = bias;
  a.bn_mean = bn_mean; a.bn_var = bn_var; a.bn_weight = bn_weight; a.bn_bias = bn_bias;
  a.eps = eps; a.act = act; a.u = u; a.y = y;
  a.Tn = Tn; a.C = C; a.K = K; a.pad_l = pad_l; a.flip = 0;
  if (bn_mean == nullptr) return dispatch_fwd<kGluIn, kBiasOut>(a, B, dtype, stream);
  if (u != nullptr || bn_var == nullptr || bn_weight == nullptr || bn_bias == nullptr ||
      (act != 0 && act != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_fwd<kGluIn, kBnActOut>(a, B, dtype, stream);
}

// dX with the GLU backward: du = conv(g) with flipped taps and no bias
// (`pad_l` the dX halo, k-1-pad_l of the forward), then dh (B, T, 2C) =
// mask·[du·σ(b), du·a·σ(b)·(1 − σ(b))] for h = [a, b].
extern "C" int depthwise_conv1d_glu_bwd(
    const void* g, const void* w, const void* h, const void* mask, void* dh,
    int B, int Tn, int C, int K, int pad_l, int dtype, cudaStream_t stream)
{
  FwdArgs a = {};
  a.x = g; a.w = w; a.h = h; a.mask = static_cast<const unsigned char*>(mask); a.y = dh;
  a.Tn = Tn; a.C = C; a.K = K; a.pad_l = pad_l; a.flip = 1;
  return dispatch_fwd<kPlainIn, kGluBwdOut>(a, B, dtype, stream);
}

// dW (K, C) and db (C,) of the depthwise conv from x and the output
// gradient g, both (B, T, C) of `dtype` (0 = float32, 1 = bfloat16, 2 =
// float16); dw and
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
  else if (dtype == 2)
    err = launch_bwd_w<__half>(x, g, dw, db, B, Tn, C, K, pad_l, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* speechlid_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
