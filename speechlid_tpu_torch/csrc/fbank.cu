// Fused log-mel filterbank for Hopper (sm_90a): raw wav → dB mel.
//
// Replaces the Pallas TPU kernel speechlid_tpu/ops/pallas/fbank_kernel.py
// (pallas_log_mel / _fbank_kernel).  It computes, for each frame f of
// utterance b, with x_pad the wav reflect-padded by n_fft/2 on both sides,
//
//   [re | im] = x_pad[b, f·hop + pad_left : … + win] @ [win·cos | win·sin]
//   mel       = (re² + im²) @ fb                   (bins × n_mels, HTK)
//   out[b, f] = 10·log10(max(mel, 1e-10))
//
// The top_db clamp needs a per-utterance max and stays with the caller.
//
// What bounds it: the DFT product, 2·win·2·bins FLOP a frame (about 0.8
// MFLOP) against 4·hop bytes of new input, so it is bound by FP32
// operations, not bytes.  It must be plain FP32 FMA, not TF32: a 1e-3
// relative error in power is 0.004 dB, over the 1e-3 dB tolerance.  One
// utterance of a few seconds is little work for 132 SMs, so at B = 1 the
// shape of the grid decides, and at large B the shared-memory loads per FMA
// and the traffic of the 0.8 MB basis from L2.
//
// Design.
//  * Tiles over bins as well as frames.  The n_fft/2 + 1 bins are packed
//    into n_fft/2: DC and Nyquist have no imaginary part, so Nyquist's real
//    column takes the place of DC's imaginary one.  A block owns kTF frames
//    × kTN packed bins (2·kTN columns, re and im interleaved) and holds its
//    win × 2·kTN slab of the basis in shared memory for its whole life: it
//    is copied in once (cp.async, in two groups so that the first taps run
//    while the rest are in flight) and reused for every frame tile the
//    block walks over.  Two blocks fit an SM.  The blocks of one frame
//    tile, one per bin tile, form a thread-block cluster; the grid is (bin
//    tiles, clusters), with as many clusters as the card holds at once (the
//    wrapper asks fbank_log_mel_setup once per device), and cluster c takes
//    the frame tiles c, c + clusters, … of the batch's B · ceil(F / kTF).
//  * Register tiles, taps split four ways.  A thread accumulates 4 frames
//    × 4 columns over a quarter of the taps; per 4 taps it reads 4 float4
//    of the basis and 4 float4 of the wav for 64 FMAs, 8 FMAs a shared
//    load.  The four parts give the block 256 threads, and their sums are
//    added pairwise in shared memory, (p0 + p2) + (p1 + p3).  Measured on
//    the card, the warps in flight decide at every batch size: the same
//    tile with the taps split two ways (128 threads) or with 8 frames a
//    thread is slower, and so is a tile of 2 frames a thread with more
//    warps, which loads more per FMA.
//  * Reflection in the staging loop.  The kernel takes the raw (B, T) wav
//    and reflects the sample index (i < 0 → −i, i ≥ T → 2(T−1) − i) while it
//    stages the span of its frame tile (4-byte cp.async, all in flight at
//    once); no padded copy exists.
//  * Mel across the cluster.  Each block writes its power tile to its own
//    shared memory; after a cluster barrier the cluster's threads split the
//    kTF × n_mels outputs and each sums its filter over the filter's
//    nonzero bins in ascending order, reading every bin from the block that
//    owns it through distributed shared memory.  The power spectrum never
//    reaches device memory.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

#if !defined(FBANK_TILE_FRAMES) || !defined(FBANK_TILE_BINS) || !defined(FBANK_TAP_PARTS) || \
    !defined(FBANK_MAX_TILES)
#error "the tile sizes come as -D definitions from ops/cuda/_build.py (TILING)"
#endif
constexpr int kTF = FBANK_TILE_FRAMES;  // frames per block tile
constexpr int kTN = FBANK_TILE_BINS;    // packed bins per block (2·kTN basis columns)
constexpr int kCols = 2 * kTN;
constexpr int kColGroups = kCols / 4;        // threads along columns
constexpr int kFT = 4;                       // frames per thread
constexpr int kKS = FBANK_TAP_PARTS;         // parts the taps are split into
constexpr int kFrameRows = kTF / kFT;        // threads along frames
constexpr int kPartThreads = kColGroups * kFrameRows;
constexpr int kThreads = kKS * kPartThreads;
constexpr int kPowStride = kTN + 1;  // slot kTN of tile 0 holds the Nyquist bin
constexpr int kRedFloats = (kKS / 2) * kTF * kCols;  // sums handed over in one step
constexpr int kMaxTiles = FBANK_MAX_TILES;   // blocks of a cluster: 8 is the portable size
static_assert(kTF % kFT == 0 && kCols % 4 == 0, "a thread's register tile divides the block's");
static_assert(kKS >= 2 && (kKS & (kKS - 1)) == 0, "the parts' sums are added pairwise");
static_assert(kMaxTiles >= 1 && kMaxTiles <= 8, "portable cluster size");

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// floats of the region that holds the wav span while the taps run and,
// afterwards, the power tile followed by the handed-over sums
__host__ __device__ __forceinline__ int pow_floats() { return round4(kTF * kPowStride); }
__host__ __device__ __forceinline__ int span_floats(int hop, int win_pad) {
  const int span = round4((kTF - 1) * hop + win_pad);
  const int after = pow_floats() + kRedFloats;
  return span > after ? span : after;
}

// rows of the basis that one part of the taps takes
__host__ __device__ __forceinline__ int part_rows(int win_pad) {
  return round4((win_pad + kKS - 1) / kKS);
}

__global__ void __launch_bounds__(kThreads) fbank_log_mel_kernel(
    const float* __restrict__ wav,    // (B, T) raw wav
    int batch, int T, int n_frames,
    const float* __restrict__ basis,  // (tiles, win_pad, kCols) re-laid windowed basis
    int win_pad, int bins,
    const float* __restrict__ fb,     // (bins, n_mels)
    const int2* __restrict__ mel_range,  // (n_mels,) nonzero bins [x, y) of each filter
    int n_mels, int hop, int frame_offset,  // raw index of frame 0's first tap (≤ 0)
    float* __restrict__ out)          // (B, n_frames, n_mels)
{
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());  // bin tile
  const int n_tiles = static_cast<int>(cluster.num_blocks());
  float* slab = reinterpret_cast<float*>(smem4);        // win_pad × kCols
  float* wav_s = slab + win_pad * kCols;                 // the frame tile's span
  float* pow_s = wav_s;                                  // after the taps: kTF × kPowStride
  float* red_s = wav_s + pow_floats();                   // after the taps: kRedFloats

  const int tid = threadIdx.x;
  const int part = tid / kPartThreads;        // which part of the taps (warp-uniform)
  const int t = tid - part * kPartThreads;
  const int cgp = t % kColGroups;             // columns 4·cgp … 4·cgp + 3
  const int fr = t / kColGroups;              // frames kFT·fr … of the tile
  const int n_ftiles = (n_frames + kTF - 1) / kTF;
  const int n_work = batch * n_ftiles;
  const int span = round4((kTF - 1) * hop + win_pad);
  const int nyquist = bins - 1;

  // part p takes taps [p·R, (p+1)·R); their first half arrives with the
  // first cp.async group, the rest with the second
  const int prow = part_rows(win_pad);
  auto part_begin = [&](int p) { return p * prow < win_pad ? p * prow : win_pad; };
  auto part_mid = [&](int p) {
    const int s0 = part_begin(p), e0 = part_begin(p + 1);
    return s0 + round4((e0 - s0) / 2);
  };
  const int h0 = part_begin(part), mid = part_mid(part), h1 = part_begin(part + 1);

  // a tile's span of the reflect-padded wav, copied from the raw wav without
  // a stop in registers: every copy of the span is in flight at once
  auto stage_span = [&](int tile) {
    const int b = tile / n_ftiles;
    const float* xb = wav + static_cast<size_t>(b) * T;
    const int base = (tile - b * n_ftiles) * kTF * hop + frame_offset;
    for (int i = tid; i < span; i += kThreads) {
      int g = base + i;
      g = g < 0 ? -g : g;
      g = g >= T ? 2 * (T - 1) - g : g;
      if (g >= 0 && g < T)
        __pipeline_memcpy_async(wav_s + i, xb + g, 4);
      else
        wav_s[i] = 0.f;  // past the last frame: taps of frames that are not written
    }
  };

  {  // the first span and the slab, once: each part's first taps, then the rest
    const float4* src = reinterpret_cast<const float4*>(
        basis + static_cast<size_t>(rank) * win_pad * kCols);
    float4* dst = reinterpret_cast<float4*>(slab);
    constexpr int kRow4 = kCols / 4;
    auto copy_rows = [&](int r0, int r1) {
      for (int i = r0 * kRow4 + tid; i < r1 * kRow4; i += kThreads)
        __pipeline_memcpy_async(dst + i, src + i, 16);
    };
    stage_span(blockIdx.y);
#pragma unroll
    for (int p = 0; p < kKS; ++p) copy_rows(part_begin(p), part_mid(p));
    __pipeline_commit();
#pragma unroll
    for (int p = 0; p < kKS; ++p) copy_rows(part_mid(p), part_begin(p + 1));
    __pipeline_commit();
  }

  const float4* slab4 = reinterpret_cast<const float4*>(slab) + cgp;
  const float* wrow = wav_s + fr * kFT * hop;
  bool first = true;

  for (int tile = blockIdx.y; tile < n_work; tile += gridDim.y) {
    const int b = tile / n_ftiles;
    const int f0 = (tile - b * n_ftiles) * kTF;
    if (!first) {
      stage_span(tile);
      __pipeline_commit();
    }

    float acc[kFT][4];
#pragma unroll
    for (int i = 0; i < kFT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

    auto run_taps = [&](int n0, int n1) {
      for (int n = n0; n < n1; n += 4) {
        float4 w[kFT];
#pragma unroll
        for (int i = 0; i < kFT; ++i) w[i] = *reinterpret_cast<const float4*>(wrow + i * hop + n);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 bv = slab4[(n + j) * kColGroups];
#pragma unroll
          for (int i = 0; i < kFT; ++i) {
            const float x = lane(w[i], j);
            acc[i][0] = fmaf(x, bv.x, acc[i][0]);
            acc[i][1] = fmaf(x, bv.y, acc[i][1]);
            acc[i][2] = fmaf(x, bv.z, acc[i][2]);
            acc[i][3] = fmaf(x, bv.w, acc[i][3]);
          }
        }
      }
    };

    // first tile: the span and the slab's first group, then its second;
    // later tiles: the span alone
    if (first) __pipeline_wait_prior(1);
    else __pipeline_wait_prior(0);
    __syncthreads();
    run_taps(h0, mid);
    if (first) {
      __pipeline_wait_prior(0);
      __syncthreads();
      first = false;
    }
    run_taps(mid, h1);
    __syncthreads();  // every thread is done with the span: its room is reused

    // the parts' sums are added pairwise, the upper half of the parts
    // handing theirs to the lower half: (p0 + p2) + (p1 + p3) for four
#pragma unroll
    for (int step = kKS / 2; step >= 1; step /= 2) {
      if (part >= step && part < 2 * step) {
#pragma unroll
        for (int i = 0; i < kFT; ++i)
          *reinterpret_cast<float4*>(red_s + ((part - step) * kTF + fr * kFT + i) * kCols + cgp * 4) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
      __syncthreads();
      if (part < step) {
#pragma unroll
        for (int i = 0; i < kFT; ++i) {
          const float4 o = *reinterpret_cast<const float4*>(
              red_s + (part * kTF + fr * kFT + i) * kCols + cgp * 4);
          acc[i][0] += o.x;
          acc[i][1] += o.y;
          acc[i][2] += o.z;
          acc[i][3] += o.w;
        }
      }
      if (step > 1) __syncthreads();  // the room is written again in the next step
    }
    if (part == 0) {
#pragma unroll
      for (int i = 0; i < kFT; ++i) {
        const float re0 = acc[i][0], im0 = acc[i][1], re1 = acc[i][2], im1 = acc[i][3];
        float* p = pow_s + (fr * kFT + i) * kPowStride + 2 * cgp;
        if (rank == 0 && cgp == 0) {  // packed bin 0: DC, and Nyquist in the im slot
          p[0] = re0 * re0;
          p[kTN] = im0 * im0;
        } else {
          p[0] = re0 * re0 + im0 * im0;
        }
        p[1] = re1 * re1 + im1 * im1;
      }
    }
    cluster.sync();  // every block's power tile is written

    // kTF × n_mels outputs over the cluster's threads; each filter summed
    // over its nonzero bins in ascending order, each bin read where it lies
    for (int idx = rank * kThreads + tid; idx < kTF * n_mels; idx += n_tiles * kThreads) {
      const int f = idx / n_mels;
      const int m = idx - f * n_mels;
      if (f0 + f >= n_frames) break;  // idx grows with f: the rest are past the end too
      const int2 r = mel_range[m];
      float s = 0.f;
      for (int kk = r.x; kk < r.y; ++kk) {
        const int owner = kk == nyquist ? 0 : kk / kTN;
        const int slot = kk == nyquist ? kTN : kk % kTN;
        const float* p = cluster.map_shared_rank(pow_s, owner);
        s = fmaf(p[f * kPowStride + slot], __ldg(fb + kk * n_mels + m), s);
      }
      out[(static_cast<size_t>(b) * n_frames + f0 + f) * n_mels + m] =
          10.f * log10f(fmaxf(s, 1e-10f));
    }
    cluster.sync();  // every reader is done: the room may be overwritten, or the block exit
  }
}

size_t smem_bytes(int hop, int win_pad) {
  return sizeof(float) *
         (static_cast<size_t>(win_pad) * kCols + span_floats(hop, win_pad));
}

cudaLaunchConfig_t launch_config(int n_tiles, int clusters, size_t smem,
                                 cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n_tiles;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles, clusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// (B, T) raw wav → (B, n_frames, n_mels).  `basis` is the windowed DFT basis
// re-laid as (n_tiles, win_pad, 64): tile r holds packed bins 32r … 32r + 31,
// re and im interleaved, Nyquist's re in packed bin 0's im column.
// `resident_clusters` is what fbank_log_mel_setup found for these sizes on
// the current device; that call must come first, once.  Launches one cluster
// kernel on `stream`; allocates nothing.  Returns the cudaError_t of the
// launch (0 on success).  Requires win_pad % 4 == 0, hop % 4 == 0,
// 1 <= n_tiles <= 8, T > -frame_offset (one reflection is enough) and a
// 16-byte aligned basis, which the Python wrapper guarantees.
extern "C" int fbank_log_mel_f32(
    const float* wav, int batch, int T, int n_frames,
    const float* basis, int win_pad, int n_tiles, int bins,
    const float* fb, const int* mel_range, int n_mels, int hop, int frame_offset,
    int resident_clusters, float* out, cudaStream_t stream)
{
  if (win_pad % 4 != 0 || win_pad <= 0 || hop % 4 != 0 || hop <= 0 || n_tiles < 1 ||
      n_tiles > kMaxTiles || bins > n_tiles * kTN + 1 || batch < 0 || frame_offset > 0 ||
      T <= -frame_offset || resident_clusters < 1 || reinterpret_cast<size_t>(basis) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || n_frames == 0) return 0;
  // as many clusters as the card holds at once; each walks over its share
  // of the batch's frame tiles
  const long long total = static_cast<long long>(batch) * ((n_frames + kTF - 1) / kTF);
  if (total > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int clusters = total < resident_clusters ? static_cast<int>(total) : resident_clusters;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(n_tiles, clusters, smem_bytes(hop, win_pad), stream, &attr);
  const int2* ranges = reinterpret_cast<const int2*>(mel_range);
  return static_cast<int>(cudaLaunchKernelEx(&cfg, fbank_log_mel_kernel, wav, batch, T, n_frames,
                                             basis, win_pad, bins, fb, ranges, n_mels, hop,
                                             frame_offset, out));
}

// Once per device, before the first launch there: allows the kernel all the
// dynamic shared memory the device can give a block (so the setting holds
// for every hop and window), and reports what the device grants it at these
// sizes: blocks per SM, and clusters of n_tiles blocks resident at once.
extern "C" int fbank_log_mel_setup(int hop, int win_pad, int n_tiles,
                                   int* blocks_per_sm, int* clusters)
{
  if (win_pad % 4 != 0 || win_pad <= 0 || hop % 4 != 0 || hop <= 0 || n_tiles < 1 ||
      n_tiles > kMaxTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, optin = 0;
  cudaFuncAttributes attrs;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attrs, fbank_log_mel_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(hop, win_pad);
  const int most = optin - static_cast<int>(attrs.sharedSizeBytes);
  if (smem > static_cast<size_t>(most > 0 ? most : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(fbank_log_mel_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fbank_log_mel_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(n_tiles, 1, smem, nullptr, &attr);
  err = cudaOccupancyMaxActiveClusters(clusters, fbank_log_mel_kernel, &cfg);
  if (err == cudaSuccess && *clusters < 1) *clusters = 1;
  return static_cast<int>(err);
}
