// The previous design of the fused log-mel kernel, kept (October 2026) only
// as the yardstick of chip_smoke.py's `ms_before`, which builds it into a
// library of its own: nothing in the package builds or calls it.  Delete
// this directory, and `ms_before`, with the next change to either kernel.
// It takes the reflect-padded wav (the caller pads), tiles over frames alone
// (one block per 8 frames, one thread per bin) and streams the whole
// windowed basis through a 4-stage cp.async ring for every block.
// The kernel in use is speechlid_tpu_torch/csrc/fbank.cu.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTF = 8;   // frames per block
constexpr int kKC = 16;  // basis rows per shared-memory chunk
constexpr int kStages = 4;  // chunks in flight

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

__host__ __device__ __forceinline__ int span_floats(int hop, int win_pad) {
  return (((kTF - 1) * hop + win_pad) + 3) & ~3;
}

__global__ void fbank_log_mel_kernel(
    const float* __restrict__ xp,     // (B, Tp) reflect-padded wav
    int Tp, int n_frames,
    const float* __restrict__ basis,  // (win_pad, 2·bins) windowed cos | sin
    int win_pad, int bins,
    const float* __restrict__ fb,     // (bins, n_mels)
    const int2* __restrict__ mel_range,  // (n_mels,) nonzero bins [x, y) of each filter
    int n_mels, int hop, int pad_left,
    float* __restrict__ out)          // (B, n_frames, n_mels)
{
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int two_bins = 2 * bins;
  const int chunk = kKC * two_bins;          // floats, a multiple of 4
  const int span = span_floats(hop, win_pad);
  float* wav_s = smem + kStages * chunk;     // span, after the kStages chunks
  float* pow_s = wav_s + span;               // kTF · bins

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTF;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  // chunk c of the basis → dst, 16 bytes per cp.async, one commit group
  auto load_chunk = [&](int c, float* dst) {
    const float4* src = reinterpret_cast<const float4*>(basis + static_cast<size_t>(c) * chunk);
    float4* d = reinterpret_cast<float4*>(dst);
    for (int i = tid; i < chunk / 4; i += nthreads) __pipeline_memcpy_async(d + i, src + i, 16);
    __pipeline_commit();
  };
  const int n_chunks = win_pad / kKC;
  // every stage commits one group, empty past the end, so that waiting for
  // all but the kStages-1 newest groups always means "chunk c has landed"
#pragma unroll
  for (int c = 0; c < kStages; ++c) {
    if (c < n_chunks) load_chunk(c, smem + c * chunk);
    else __pipeline_commit();
  }

  const float* xb = xp + static_cast<size_t>(b) * Tp;
  const int base = f0 * hop + pad_left;
  for (int i = tid; i < span; i += nthreads) {
    const int g = base + i;
    wav_s[i] = g < Tp ? xb[g] : 0.f;
  }

  const int k = tid;
  const bool active = k < bins;
  float re[kTF], im[kTF];
#pragma unroll
  for (int f = 0; f < kTF; ++f) {
    re[f] = 0.f;
    im[f] = 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    __pipeline_wait_prior(kStages - 1);  // chunk c has landed
    __syncthreads();  // chunk c (and the wav span) visible to every thread
    float* basis_s = smem + (c % kStages) * chunk;
    const int n0 = c * kKC;
    if (active) {
#pragma unroll
      for (int nn = 0; nn < kKC; nn += 4) {
        float4 w[kTF];
#pragma unroll
        for (int f = 0; f < kTF; ++f)
          w[f] = *reinterpret_cast<const float4*>(&wav_s[f * hop + n0 + nn]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float cv = basis_s[(nn + j) * two_bins + k];
          const float sv = basis_s[(nn + j) * two_bins + bins + k];
#pragma unroll
          for (int f = 0; f < kTF; ++f) {
            const float x = lane(w[f], j);
            re[f] = fmaf(x, cv, re[f]);
            im[f] = fmaf(x, sv, im[f]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with this buffer: refill it
    if (c + kStages < n_chunks) load_chunk(c + kStages, basis_s);
    else __pipeline_commit();
  }

  if (active) {
#pragma unroll
    for (int f = 0; f < kTF; ++f) pow_s[f * bins + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  for (int idx = tid; idx < kTF * n_mels; idx += nthreads) {
    const int f = idx / n_mels;
    const int m = idx - f * n_mels;
    if (f0 + f >= n_frames) break;  // idx grows with f: the rest are past the end too
    const float* p = pow_s + f * bins;
    const int2 r = mel_range[m];
    float acc = 0.f;
    for (int kk = r.x; kk < r.y; ++kk) acc = fmaf(p[kk], fb[kk * n_mels + m], acc);
    out[(static_cast<size_t>(b) * n_frames + f0 + f) * n_mels + m] =
        10.f * log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

// Launches on `stream`; allocates nothing.  Returns the cudaError_t of the
// launch (0 on success).  Requires win_pad % 16 == 0, hop % 4 == 0,
// bins <= 1024 and a 16-byte aligned basis, which the Python wrapper
// guarantees.
extern "C" int fbank_log_mel_previous_f32(
    const float* xp, int batch, int Tp, int n_frames,
    const float* basis, int win_pad, int bins,
    const float* fb, const int* mel_range, int n_mels, int hop, int pad_left,
    float* out, cudaStream_t stream)
{
  if (win_pad % kKC != 0 || win_pad == 0 || hop % 4 != 0 || bins > 1024 ||
      batch > 65535 || reinterpret_cast<size_t>(basis) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || n_frames == 0) return 0;
  const int threads = ((bins + 31) / 32) * 32;
  const size_t smem = sizeof(float) * (kStages * static_cast<size_t>(kKC) * 2 * bins +
                                       span_floats(hop, win_pad) + kTF * bins);
  cudaError_t err = cudaFuncSetAttribute(
      fbank_log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + kTF - 1) / kTF, batch);
  fbank_log_mel_kernel<<<grid, threads, smem, stream>>>(
      xp, Tp, n_frames, basis, win_pad, bins, fb,
      reinterpret_cast<const int2*>(mel_range), n_mels, hop, pad_left, out);
  return static_cast<int>(cudaGetLastError());
}
