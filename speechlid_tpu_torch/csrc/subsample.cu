// The Conformer's ×4 Conv2d subsampling for Hopper (sm_90a), forward and
// backward, in float32 with IEEE products and sums (no TF32):
//
//   a0 = relu(conv0(x) + b0)     x (B, T, 80) as one input channel, conv0 1 → 144, 3×3, stride 2
//   y1 = relu(conv1(a0) + b1)    conv1 144 → 144, 3×3, stride 2
//
// 'VALID' both, so a0 is (B, T0, 39, 144) with T0 = (T − 1)/2 and y1 is
// (B, T1, 19, 144) with T1 = (T0 − 1)/2.  y1 is written channels last
// (NHWC), the layout the subsampling's Linear reads as a view.
//
// Replaces no TPU kernel: the JAX package leaves both convolutions to XLA
// (models/conformer.py Conv2dSubsampling).  On the card the port ran
// cuDNN's chain conv0, ReLU, conv1, ReLU and a permute copy, with a0 (1.7 GB
// at a scoring batch of 512 × 3 s) written, read, written and read again.
//
// What bounds it: conv1 is 2 · 144 · 1296 operations an output position
// against 144 floats written, so it is bound by float32 FFMA operations
// (67 TFLOP/s), as are its two gradients.  conv0 is 3 % of the operations.
// So the design keeps a0 out of device memory altogether: every block
// recomputes the conv0 + bias + ReLU values its tile of conv1 reads, from x,
// with 9 FMAs a value against 144 of conv1's for each.
//
// Every pass is one tiled FFMA product C[i][j] += Σ_k A[k][i] · B[k][j] with
// j the 144 channels (a thread owns 9: 4tn…4tn+3, 64+4tn…+3, 128+tn) and
// i a tile of 128 or 144 rows (a thread owns 8 or 9 likewise), 256 threads,
// K walked in chunks of SUB_BK rows through two shared-memory stages: the
// block fills one stage (its producer) while it multiplies out the other,
// two blocks an SM.  The producers differ:
//
//   forward  i = 128 output positions (b, t1, f1) in a row, k = (tap, ci).
//            A: a0 at (2t1 + kh, 2f1 + kw, ci), recomputed from the x rows
//            staged at the block's start (each thread one position, 8
//            channels: 9 x values a position for 72 FMAs).  B: conv1's
//            weights as (tap, ci, co), by cp.async during the previous
//            chunk's products.  Epilogue: + b1, ReLU, y1 written.
//   dgrad    dA0 = conv1ᵀ(g1, W1), g1 = dY ⊙ [y1 > 0], tiled by the four
//            parities of a0's (row, column): a position of parity (pr, pc)
//            is reached by the taps kh ∈ {0, 2} (pr = 0) or {1}, kw alike,
//            so each tile is a dense product over its 144·n_taps rows
//            (co, tap).  i = 128 a0 positions of one parity and utterance;
//            g1's cells under a group of 16 co come in by cp.async into a
//            window in shared memory two chunks ahead, the weights one
//            ahead, and each chunk's A is gathered from the window.
//            Epilogue: dZ0 = dA0 ⊙ [z0 > 0] with z0 recomputed exactly as
//            the forward computed it, reduced at once into the block's
//            dW0 (144 × 9) and db0 partial; dA0 and dZ0 never leave the SM.
//            A fixed number of blocks (SUB_DGRAD_BLOCKS) each walk a
//            contiguous range of tiles.
//   wgrad    dW1 (tap, ci, co) = Σ over positions of a0 ⊗ g1: one block per
//            (tap, split of the positions into SUB_WGRAD_SPLITS ranges),
//            i = 144 input channels, k = 16 positions a chunk; A recomputed
//            from x, B = g1.  The tap-0 blocks also sum db1.
//   reduce   the dgrad blocks' and the splits' partials, each summed in
//            index order, into dW0, db0, dW1 (co, ci, kh, kw) and db1.
//
// No atomics, no scratch beyond the partials, and the order of every sum
// is fixed by the shape alone: the same bits on every run.  z0 is one
// function (conv0_at) in all three producers, so the backward's ReLU masks
// are the forward's decisions.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

#if !defined(SUB_BK) || !defined(SUB_WGRAD_SPLITS) || !defined(SUB_DGRAD_BLOCKS)
#error "the tile sizes come as -D definitions from ops/cuda/_build.py (TILING)"
#endif

constexpr int kF = 80;          // mel bins of x
constexpr int kC = 144;         // channels of both convolutions
constexpr int kF1 = 19;         // conv1's output width: ((80 - 1)/2 - 1)/2
constexpr int kBK = SUB_BK;     // K rows of a chunk
constexpr int kThreads = 256;   // 16 × 16 threads: tm = tid / 16 over i, tn = tid % 16 over j
constexpr int kTile = 128;      // positions of a forward block or a dgrad tile (8 a thread)
constexpr int kDgradAStride = 132;  // dgrad's A rows, padded: its producer writes down columns
constexpr int kTaps = 9;
constexpr int kW0Row = 12;      // conv0's 9 taps and bias of a channel, padded to 16-byte pieces
constexpr int kFwdChunks = kTaps * kC / kBK;
constexpr int kPart0 = kC * 10;  // a dgrad block's partial: dW0 (ci, 9 taps) and db0, as (ci, 10)
constexpr int kXRowsFwd = 7;     // x rows under one conv1 output row: 4·t1 … 4·t1 + 6
constexpr int kMaxTileRows = 8;  // rows a tile of 128 positions spans, 19 or 20 a row
static_assert(kBK == 16, "the producers deal a chunk's 16 rows over the block");
static_assert(kC % kBK == 0, "a chunk lies within one tap");

// The phase layout of a staged x row: column c at (c % 4)·20 + c / 4, so the
// columns 4·f1 + o of neighbouring positions f1 lie in neighbouring banks.
__device__ __forceinline__ int xph(int col) { return (col & 3) * 20 + (col >> 2); }

// A thread's i-th row or column of a tile: 4t…4t+3, 64+4t…64+4t+3, 128+t.
__device__ __forceinline__ int slot(int t, int i) {
  return i < 4 ? 4 * t + i : (i < 8 ? 60 + 4 * t + i : 128 + t);
}

// conv0's pre-activation for channel ci over the 3×3 patch p (p[3i + j] =
// x[2·row + i][2·col + j]): the taps in order, then the bias.  Every producer
// computes z0 with this function, so the backward's masks are the forward's.
// w0s holds a channel's taps and bias in one row of kW0Row (load_w0), read
// as three 16-byte pieces.
__device__ __forceinline__ float conv0_at(const float* __restrict__ w0s, int ci,
                                          const float (&p)[kTaps]) {
  const float4* row = reinterpret_cast<const float4*>(w0s + ci * kW0Row);
  const float4 a = row[0], b = row[1], c = row[2];
  float z = fmaf(a.x, p[0], 0.f);
  z = fmaf(a.y, p[1], z);
  z = fmaf(a.z, p[2], z);
  z = fmaf(a.w, p[3], z);
  z = fmaf(b.x, p[4], z);
  z = fmaf(b.y, p[5], z);
  z = fmaf(b.z, p[6], z);
  z = fmaf(b.w, p[7], z);
  z = fmaf(c.x, p[8], z);
  return z + c.y;
}

// One chunk of the product: acc[i][j] += Σ_k A[k][slot(tm, i)] · B[k][slot(tn, j)],
// k in order, one FMA each.
template <int TM>
__device__ __forceinline__ void mma_chunk(const float* __restrict__ As, int a_stride,
                                          const float* __restrict__ Bs, float (&acc)[TM][9],
                                          int tm, int tn) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float* ar = As + k * a_stride;
    const float* br = Bs + k * kC;
    float a[TM], b[9];
    float4 v = *reinterpret_cast<const float4*>(ar + 4 * tm);
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
    v = *reinterpret_cast<const float4*>(ar + 64 + 4 * tm);
    a[4] = v.x; a[5] = v.y; a[6] = v.z; a[7] = v.w;
    if constexpr (TM == 9) a[8] = ar[128 + tm];
    v = *reinterpret_cast<const float4*>(br + 4 * tn);
    b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
    v = *reinterpret_cast<const float4*>(br + 64 + 4 * tn);
    b[4] = v.x; b[5] = v.y; b[6] = v.z; b[7] = v.w;
    b[8] = br[128 + tn];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 9; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// 16 bytes from global into shared memory by cp.async, or 16 zero bytes.
__device__ __forceinline__ void copy16_async(float* dst, const float* src, bool valid) {
  __pipeline_memcpy_async(dst, src, 16, valid ? 0 : 16);
}

// 16 rows × 144 floats from global memory (a chunk of a weight) into a stage,
// in flight until the caller waits for its pipeline.
__device__ __forceinline__ void copy_rows_async(const float* __restrict__ src,
                                                float* __restrict__ dst) {
  constexpr int kVecs = kBK * kC / 4;
#pragma unroll
  for (int r = 0; r < (kVecs + kThreads - 1) / kThreads; ++r) {
    const int q = threadIdx.x + r * kThreads;
    if (q < kVecs) copy16_async(dst + 4 * q, src + 4 * q, true);
  }
}

// w0p (10, 144): conv0's taps, then its bias → w0s (144, kW0Row), a channel a row.
__device__ __forceinline__ void load_w0(const float* __restrict__ w0p, float* __restrict__ w0s) {
  for (int q = threadIdx.x; q < kC * kW0Row; q += kThreads) {
    const int ci = q / kW0Row, t = q % kW0Row;
    w0s[q] = t <= kTaps ? __ldg(w0p + t * kC + ci) : 0.f;
  }
}

// --------------------------------------------------------------- forward

constexpr size_t kFwdSmemFloats =
    kMaxTileRows * kXRowsFwd * kF + kC * kW0Row + 2 * kBK * kTile + 2 * kBK * kC;

__global__ void __launch_bounds__(kThreads, 2)
subsample_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w0p,
                     const float* __restrict__ w1f, const float* __restrict__ b1,
                     float* __restrict__ y, int Tn, int T1, int M) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);            // [rows][7][80], phase layout
  float* w0s = xs + kMaxTileRows * kXRowsFwd * kF;        // [144][12]: 9 taps, bias
  float* As = w0s + kC * kW0Row;                          // [2][16][128]
  float* Bs = As + 2 * kBK * kTile;                      // [2][16][144]
  const int tid = threadIdx.x, tm = tid >> 4, tn = tid & 15;
  const int m0 = blockIdx.x * kTile;
  const int g_first = m0 / kF1;
  const int n_rows = (min(m0 + kTile, M) - 1) / kF1 - g_first + 1;
  for (int q = tid; q < n_rows * kXRowsFwd * kF; q += kThreads) {
    const int lr = q / (kXRowsFwd * kF), r = (q / kF) % kXRowsFwd, col = q % kF;
    const int g = g_first + lr, b = g / T1, t1 = g - b * T1;
    xs[(lr * kXRowsFwd + r) * kF + xph(col)] = __ldg(x + ((size_t)b * Tn + 4 * t1 + r) * kF + col);
  }
  load_w0(w0p, w0s);
  // the producer's position and half of the chunk's 16 channels
  const int pm = tid & (kTile - 1), half = tid >> 7;
  const int m = m0 + pm;
  const bool valid = m < M;
  const int lr = valid ? m / kF1 - g_first : 0;
  const int f1 = valid ? m % kF1 : 0;
  __syncthreads();

  auto produce = [&](int c, int stage) {
    const int tap = c / (kC / kBK), kh = tap / 3, kw = tap - 3 * kh;
    const int ci0 = (c - tap * (kC / kBK)) * kBK;
    copy_rows_async(w1f + (size_t)(tap * kC + ci0) * kC, Bs + stage * kBK * kC);
    __pipeline_commit();
    float p[kTaps];
    const float* xr = xs + (lr * kXRowsFwd + 2 * kh) * kF;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) p[3 * i + j] = xr[i * kF + xph(4 * f1 + 2 * kw + j)];
    float* a = As + stage * kBK * kTile + half * 8 * kTile + pm;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float z = conv0_at(w0s, ci0 + half * 8 + r, p);
      a[r * kTile] = valid ? fmaxf(z, 0.f) : 0.f;
    }
  };

  float acc[8][9];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 9; ++j) acc[i][j] = 0.f;
  produce(0, 0);
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int c = 0; c < kFwdChunks; ++c) {
    if (c + 1 < kFwdChunks) produce(c + 1, (c + 1) & 1);  // its weights land during the mma
    mma_chunk<8>(As + (c & 1) * kBK * kTile, kTile, Bs + (c & 1) * kBK * kC, acc, tm, tn);
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  float bias[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) bias[j] = __ldg(b1 + slot(tn, j));
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int mm = m0 + slot(tm, i);
    if (mm >= M) continue;
    float* yr = y + (size_t)mm * kC;
    float o[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) o[j] = fmaxf(acc[i][j] + bias[j], 0.f);
    *reinterpret_cast<float4*>(yr + 4 * tn) = make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(yr + 64 + 4 * tn) = make_float4(o[4], o[5], o[6], o[7]);
    yr[128 + tn] = o[8];
  }
}

// ----------------------------------------------------------------- dgrad

// The parity classes of a0's positions: class cls has rows 2a + pr (pr =
// cls / 2), a < T1 + 1 − pr, and columns 2e + pc (pc = cls % 2), e < 20 − pc.
struct Tile {
  int b, pr, pc, E, N, n0;
};

__host__ __device__ __forceinline__ int class_tiles(int cls, int T1) {
  const int n = (T1 + 1 - (cls >> 1)) * (20 - (cls & 1));
  return (n + kTile - 1) / kTile;
}

// Tile idx in the kernel's order: utterance by utterance, and within one the
// classes' tiles dealt round-robin (tile 0 of each class, then tile 1, …), so
// that a block's contiguous share holds the four classes (1, 2, 2 and 4 taps)
// alike.
__device__ __forceinline__ Tile decode_tile(int idx, int T1) {
  int n_cls[4], per_utt = 0;
  for (int cls = 0; cls < 4; ++cls) per_utt += n_cls[cls] = class_tiles(cls, T1);
  Tile t;
  t.b = idx / per_utt;
  int r = idx - t.b * per_utt, cls = 0, j = 0;
  for (;; ++j) {
    for (cls = 0; cls < 4; ++cls) {
      if (j < n_cls[cls] && r-- == 0) break;
    }
    if (cls < 4) break;
  }
  t.pr = cls >> 1;
  t.pc = cls & 1;
  t.E = 20 - t.pc;
  t.N = (T1 + 1 - t.pr) * t.E;
  t.n0 = j * kTile;
  return t;
}

// The window of g1 a tile's chunks of one co group read: conv1's output rows
// t1_base … t1_base + 8 and columns f1_base … f1_base + 20 (f1_base = −1 for
// even a0 columns), 16 channels a cell; cells outside the output are zeros.
constexpr int kWinRows = kMaxTileRows + 1;
constexpr int kWinCols = 21;
constexpr int kWin = kWinRows * kWinCols * kBK;  // floats of one tensor's window
constexpr int kWinVecs = kWinRows * kWinCols * 4;  // its 16-byte pieces

constexpr int kDgradOps = 2 * kBK * kDgradAStride + 2 * kBK * kC;
constexpr int kDgradWins = 2 * 2 * kWin;  // two buffers of dy's and y1's windows
constexpr int kDgradRed = 8 * kPart0;     // a warp's pair of thread rows each
static_assert(kDgradRed <= kDgradWins, "the epilogue's rows reuse the windows");
constexpr size_t kDgradSmemFloats =
    kMaxTileRows * 3 * kF + kC * kW0Row + kDgradOps + kDgradWins + kPart0 + kTile + kWinVecs;

__global__ void __launch_bounds__(kThreads, 2)
subsample_dgrad_kernel(const float* __restrict__ x, const float* __restrict__ w0p,
                       const float* __restrict__ w1d, const float* __restrict__ dy,
                       const float* __restrict__ y1, float* __restrict__ part0,
                       int Tn, int T1, int n_tiles) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [8][3][80], phase layout
  float* w0s = xs + kMaxTileRows * 3 * kF;       // [144][12]
  float* As = w0s + kC * kW0Row;                 // [2][16][132]
  float* Bs = As + 2 * kBK * kDgradAStride;      // [2][16][144]
  float* wins = Bs + 2 * kBK * kC;               // [2 buffers][dy, y1][9][21][16]
  float* red = wins;                             // [8][144][10], after the last chunk
  float* total = wins + kDgradWins;              // [144][10]
  int* cell = reinterpret_cast<int*>(total + kPart0);  // [128]: a position's window cell, or -1
  int* piece = cell + kTile;  // [756]: a window piece's offset in dy and y1 (co group 0), or -1
  const int tid = threadIdx.x, tm = tid >> 4, tn = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  load_w0(w0p, w0s);
  for (int q = tid; q < kPart0; q += kThreads) total[q] = 0.f;
  const int first = (int)((long long)blockIdx.x * n_tiles / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * n_tiles / gridDim.x);

  for (int ti = first; ti < last; ++ti) {
    const Tile t = decode_tile(ti, T1);
    const int a_first = t.n0 / t.E;
    const int n_rows = (min(t.n0 + kTile, t.N) - 1) / t.E - a_first + 1;
    const int t1_base = a_first - (t.pr ? 0 : 1), f1_base = t.pc ? 0 : -1;
    const int nkw = t.pc ? 1 : 2, n_taps = (t.pr ? 1 : 2) * nkw;
    const int n_chunks = n_taps * (kC / kBK);  // co group outer, taps inner
    __syncthreads();  // the previous tile's epilogue is done with xs and red
    for (int q = tid; q < n_rows * 3 * kF; q += kThreads) {
      const int la = q / (3 * kF), i = (q / kF) % 3, col = q % kF;
      const int row = 4 * (a_first + la) + 2 * t.pr + i;  // x row 2·(2a + pr) + i
      xs[(la * 3 + i) * kF + xph(col)] = __ldg(x + ((size_t)t.b * Tn + row) * kF + col);
    }
    // position i's window cell under the taps kh, kw ≤ 1: conv1's output
    // (a + (pr − kh)/2, e + (pc − kw)/2) at window row a − a_first + 1 − pr,
    // column e + 1 − pc; the taps kh = 2 and kw = 2 step one row or column back
    if (tid < kTile) {
      const int n = t.n0 + tid, aa = n / t.E, e = n - aa * t.E;
      cell[tid] = n < t.N ? ((aa - a_first + 1 - t.pr) * kWinCols + e + 1 - t.pc) * kBK : -1;
    }
    // the window's pieces, each read back only by the thread that wrote it
    // (offsets fit an int: the wrapper holds B·T'·19·144 under 2³¹)
    for (int u = tid; u < kWinVecs; u += kThreads) {
      const int t1 = t1_base + (u >> 2) / kWinCols, f1 = f1_base + (u >> 2) % kWinCols;
      piece[u] = t1 >= 0 && t1 < T1 && f1 >= 0 && f1 < kF1
                     ? ((t.b * T1 + t1) * kF1 + f1) * kC + 4 * (u & 3) : -1;
    }

    // dy's and y1's cells of co group cg into window buffer cg % 2
    auto fetch_window = [&](int cg) {
      float* w = wins + (cg & 1) * 2 * kWin;
#pragma unroll
      for (int r = 0; r < (kWinVecs + kThreads - 1) / kThreads; ++r) {
        const int u = tid + r * kThreads;
        if (u < kWinVecs) {
          const int o = piece[u];
          const size_t src = o < 0 ? 0 : (size_t)o + cg * kBK;
          copy16_async(w + 4 * u, dy + src, o >= 0);
          copy16_async(w + kWin + 4 * u, y1 + src, o >= 0);
        }
      }
    };
    auto fetch_weights = [&](int c, int stage) {
      const int cg = c / n_taps, tap_i = c - cg * n_taps;
      const int kh = t.pr ? 1 : 2 * (tap_i / nkw), kw = t.pc ? 1 : 2 * (tap_i % nkw);
      const float* src = w1d + (size_t)((kh * 3 + kw) * kC + cg * kBK) * kC;
      float* dst = Bs + stage * kBK * kC;
      copy_rows_async(src, dst);
    };
    // A of chunk c: g1 = dy ⊙ [y1 > 0] under the chunk's tap, from the window
    auto build = [&](int c, int stage) {
      const int cg = c / n_taps, tap_i = c - cg * n_taps;
      const int kh = t.pr ? 1 : 2 * (tap_i / nkw), kw = t.pc ? 1 : 2 * (tap_i % nkw);
      const int kk = tid & 15;
      const float* w = wins + (cg & 1) * 2 * kWin + kk - ((kh >> 1) * kWinCols + (kw >> 1)) * kBK;
      float* a = As + stage * kBK * kDgradAStride + kk * kDgradAStride;
#pragma unroll
      for (int s = 0; s < kTile / 16; ++s) {
        const int i = (tid >> 4) + 16 * s, o = cell[i];
        a[i] = o >= 0 && w[kWin + o] > 0.f ? w[o] : 0.f;
      }
    };
    auto group_of = [&](int c) { return c / n_taps; };

    float acc[8][9];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 9; ++j) acc[i][j] = 0.f;
    fetch_weights(0, 0);
    __pipeline_commit();
    fetch_window(0);
    if (n_chunks > 1 && group_of(1) != 0) fetch_window(group_of(1));
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    build(0, 0);
    __syncthreads();
    for (int c = 0; c < n_chunks; ++c) {
      // two groups an iteration: the next chunk's weights, then the window
      // two chunks ahead where that starts a co group (else none)
      if (c + 1 < n_chunks) fetch_weights(c + 1, (c + 1) & 1);
      __pipeline_commit();
      if (c + 2 < n_chunks && group_of(c + 2) != group_of(c + 1)) fetch_window(group_of(c + 2));
      __pipeline_commit();
      mma_chunk<8>(As + (c & 1) * kBK * kDgradAStride, kDgradAStride, Bs + (c & 1) * kBK * kC,
                   acc, tm, tn);
      __pipeline_wait_prior(1);
      __syncthreads();
      if (c + 1 < n_chunks) {
        build(c + 1, (c + 1) & 1);
        __syncthreads();
      }
    }

    // dZ0 = dA0 ⊙ [z0 > 0], folded at once into dW0 and db0 for each of the
    // thread's 9 channels over its 8 positions; then the two thread rows of a
    // warp are added, and the 8 warps' rows in order.
#pragma unroll
    for (int jj = 0; jj < 9; ++jj) {
      const int ci = slot(tn, jj);
      float part[kTaps + 1];
#pragma unroll
      for (int q = 0; q <= kTaps; ++q) part[q] = 0.f;
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const int n = t.n0 + slot(tm, ii);
        if (n < t.N) {
          const int aa = n / t.E, e = n - aa * t.E;
          const float* xr = xs + (aa - a_first) * 3 * kF;
          const int col = 2 * (2 * e + t.pc);
          float p[kTaps];
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) p[3 * i + j] = xr[i * kF + xph(col + j)];
          const float d = conv0_at(w0s, ci, p) > 0.f ? acc[ii][jj] : 0.f;
#pragma unroll
          for (int q = 0; q < kTaps; ++q) part[q] = fmaf(d, p[q], part[q]);
          part[kTaps] += d;
        }
      }
#pragma unroll
      for (int q = 0; q <= kTaps; ++q) part[q] += __shfl_xor_sync(0xffffffffu, part[q], 16);
      if (lane < 16) {
#pragma unroll
        for (int q = 0; q <= kTaps; ++q) red[(warp * kC + ci) * (kTaps + 1) + q] = part[q];
      }
    }
    __syncthreads();
    for (int q = tid; q < kPart0; q += kThreads) {
      float s = red[q];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) s += red[w * kPart0 + q];
      total[q] += s;
    }
  }
  __syncthreads();
  for (int q = tid; q < kPart0; q += kThreads) part0[(size_t)blockIdx.x * kPart0 + q] = total[q];
}

// ----------------------------------------------------------------- wgrad

constexpr int kDbRows = kThreads / (kC / 4);  // 7 threads a column group of g1
constexpr size_t kWgradSmemFloats = kC * kW0Row + 2 * kBK * kC + 2 * kBK * kC + kDbRows * kC;

__global__ void __launch_bounds__(kThreads, 2)
subsample_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ w0p,
                       const float* __restrict__ dy, const float* __restrict__ y1,
                       float* __restrict__ part1, float* __restrict__ part_db1,
                       int Tn, int T1, int M) {
  extern __shared__ float4 smem4[];
  float* w0s = reinterpret_cast<float*>(smem4);  // [144][12]
  float* As = w0s + kC * kW0Row;                 // [2][16 positions][144 ci]: a0
  float* Bs = As + 2 * kBK * kC;                 // [2][16 positions][144 co]: g1
  float* dbs = Bs + 2 * kBK * kC;                // [7][144]
  const int tid = threadIdx.x, tm = tid >> 4, tn = tid & 15;
  const int tap = blockIdx.x, kh = tap / 3, kw = tap - 3 * kh;
  const int split = blockIdx.y;
  const int n_q = (M + kBK - 1) / kBK;
  const int q_first = (int)((long long)split * n_q / gridDim.y);
  const int q_last = (int)((long long)(split + 1) * n_q / gridDim.y);
  load_w0(w0p, w0s);
  // g1's loader: thread < 252 owns four channels and the chunk rows kk0, kk0 + 7, kk0 + 14
  const int co4 = tid % (kC / 4), kk0 = tid / (kC / 4);
  float4 db = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // chunk q's stage: a0 under the tap, recomputed from x, and g1 = dy ⊙ [y1 > 0]
  auto produce = [&](int q, int stage) {
    {  // a0 at (2t1 + kh, 2f1 + kw) of the chunk's position p, channels 9·cg … 9·cg + 8
      const int p = tid >> 4, cg = tid & 15, m = q * kBK + p;
      float* a = As + stage * kBK * kC + p * kC + 9 * cg;
      if (m < M) {
        const int g = m / kF1, f1 = m - g * kF1, b = g / T1, t1 = g - b * T1;
        const float* xr = x + ((size_t)b * Tn + 4 * t1 + 2 * kh) * kF + 4 * f1 + 2 * kw;
        float pt[kTaps];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) pt[3 * i + j] = __ldg(xr + i * kF + j);
#pragma unroll
        for (int r = 0; r < 9; ++r) a[r] = fmaxf(conv0_at(w0s, 9 * cg + r, pt), 0.f);
      } else {
#pragma unroll
        for (int r = 0; r < 9; ++r) a[r] = 0.f;
      }
    }
    if (tid < kDbRows * (kC / 4)) {
      for (int kk = kk0; kk < kBK; kk += kDbRows) {
        const int m = q * kBK + kk;
        float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m < M) {
          const float4 d = __ldg(reinterpret_cast<const float4*>(dy + (size_t)m * kC) + co4);
          const float4 v = __ldg(reinterpret_cast<const float4*>(y1 + (size_t)m * kC) + co4);
          g = make_float4(v.x > 0.f ? d.x : 0.f, v.y > 0.f ? d.y : 0.f,
                          v.z > 0.f ? d.z : 0.f, v.w > 0.f ? d.w : 0.f);
        }
        db.x += g.x; db.y += g.y; db.z += g.z; db.w += g.w;
        reinterpret_cast<float4*>(Bs + stage * kBK * kC + kk * kC)[co4] = g;
      }
    }
  };

  float acc[9][9];
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int j = 0; j < 9; ++j) acc[i][j] = 0.f;
  produce(q_first, 0);
  __syncthreads();
  for (int q = q_first; q < q_last; ++q) {
    const int stage = (q - q_first) & 1;
    if (q + 1 < q_last) produce(q + 1, stage ^ 1);
    mma_chunk<9>(As + stage * kBK * kC, kC, Bs + stage * kBK * kC, acc, tm, tn);
    __syncthreads();
  }
  float* out = part1 + ((size_t)split * kTaps + tap) * kC * kC;  // [ci][co]
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    float* row = out + (size_t)slot(tm, i) * kC;
    *reinterpret_cast<float4*>(row + 4 * tn) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 64 + 4 * tn) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    row[128 + tn] = acc[i][8];
  }
  if (tap == 0) {
    if (tid < kDbRows * (kC / 4)) reinterpret_cast<float4*>(dbs + kk0 * kC)[co4] = db;
    __syncthreads();
    if (tid < kC) {
      float s = dbs[tid];
      for (int r = 1; r < kDbRows; ++r) s += dbs[r * kC + tid];
      part_db1[(size_t)split * kC + tid] = s;
    }
  }
}

// ---------------------------------------------------------------- reduce

__global__ void subsample_reduce_kernel(const float* __restrict__ part0,
                                        const float* __restrict__ part1,
                                        const float* __restrict__ part_db1, float* __restrict__ dw0,
                                        float* __restrict__ db0, float* __restrict__ dw1,
                                        float* __restrict__ db1, int n_blocks0, int n_splits) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  constexpr int kW1 = kTaps * kC * kC;
  if (o < kW1) {  // (tap, ci, co) in, (co, ci, tap) out
    float s = part1[o];
    for (int sp = 1; sp < n_splits; ++sp) s += part1[(size_t)sp * kW1 + o];
    const int tap = o / (kC * kC), ci = (o / kC) % kC, co = o % kC;
    dw1[((size_t)co * kC + ci) * kTaps + tap] = s;
  } else if (o < kW1 + kC) {
    const int co = o - kW1;
    float s = part_db1[co];
    for (int sp = 1; sp < n_splits; ++sp) s += part_db1[(size_t)sp * kC + co];
    db1[co] = s;
  } else if (o < kW1 + kC + kPart0) {
    const int q = o - kW1 - kC, ci = q / (kTaps + 1), t = q % (kTaps + 1);
    float s = part0[q];
    for (int g = 1; g < n_blocks0; ++g) s += part0[(size_t)g * kPart0 + q];
    if (t < kTaps) dw0[ci * kTaps + t] = s;
    else db0[ci] = s;
  }
}

int per_utt_tiles(int T1) {
  int n = 0;
  for (int cls = 0; cls < 4; ++cls) n += class_tiles(cls, T1);
  return n;
}

cudaError_t set_smem(const void* kernel, size_t floats) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(floats * sizeof(float)));
}

bool shape_ok(int B, int Tn, int F, int C) {
  return B >= 1 && Tn >= 7 && F == kF && C == kC;
}

// The backward's grid: dgrad blocks and wgrad splits (ops/cuda/subsample_kernel.py
// bwd_grid); the scratch holds n_blocks0·1440 + n_splits·(9·144·144 + 144) floats.
void bwd_grid(int B, int T1, int* n_blocks0, int* n_splits) {
  const long long tiles = (long long)B * per_utt_tiles(T1);
  const long long chunks = ((long long)B * T1 * kF1 + kBK - 1) / kBK;
  *n_blocks0 = static_cast<int>(tiles < SUB_DGRAD_BLOCKS ? tiles : SUB_DGRAD_BLOCKS);
  *n_splits = static_cast<int>(chunks < SUB_WGRAD_SPLITS ? chunks : SUB_WGRAD_SPLITS);
}

}  // namespace

// y1 (B, T1, 19, 144) = relu(conv1(relu(conv0(x)))) for x (B, Tn, 80); w0p
// (10, 144): conv0's 9 taps (i·3 + j) then its bias; w1f (9, 144 ci, 144 co);
// b1 (144,).  All float32, contiguous.  One launch on `stream`.
extern "C" int subsample_fwd(const void* x, const void* w0p, const void* w1f, const void* b1,
                             void* y, int B, int Tn, int F, int C, cudaStream_t stream) {
  if (!shape_ok(B, Tn, F, C)) return static_cast<int>(cudaErrorInvalidValue);
  const int T1 = ((Tn - 1) / 2 - 1) / 2;
  const long long M = (long long)B * T1 * kF1;
  if (M * kC > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(subsample_fwd_kernel), kFwdSmemFloats);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((M + kTile - 1) / kTile);
  subsample_fwd_kernel<<<blocks, kThreads, kFwdSmemFloats * sizeof(float), stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w0p),
      static_cast<const float*>(w1f), static_cast<const float*>(b1), static_cast<float*>(y), Tn,
      T1, static_cast<int>(M));
  return static_cast<int>(cudaGetLastError());
}

// dW0 (144, 1, 3, 3), db0, dW1 (144, 144, 3, 3) and db1 of the subsampling
// from x, the forward's y1 and its gradient dy (both (B, T1, 19, 144)); w0p
// as the forward's, w1d (9, 144 co, 144 ci).  `scratch` holds the partials
// (bwd_grid).  Three launches on `stream`: dgrad, wgrad, reduce.
extern "C" int subsample_bwd(const void* x, const void* w0p, const void* w1d, const void* y1,
                             const void* dy, void* scratch, void* dw0, void* db0, void* dw1,
                             void* db1, int B, int Tn, int F, int C, cudaStream_t stream) {
  if (!shape_ok(B, Tn, F, C)) return static_cast<int>(cudaErrorInvalidValue);
  const int T1 = ((Tn - 1) / 2 - 1) / 2;
  const long long M = (long long)B * T1 * kF1;
  const long long tiles = (long long)B * per_utt_tiles(T1);
  if (M * kC > INT32_MAX || tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int n_blocks0 = 0, n_splits = 0;
  bwd_grid(B, T1, &n_blocks0, &n_splits);
  float* part0 = static_cast<float*>(scratch);
  float* part1 = part0 + (size_t)n_blocks0 * kPart0;
  float* part_db1 = part1 + (size_t)n_splits * kTaps * kC * kC;
  cudaError_t err =
      set_smem(reinterpret_cast<const void*>(subsample_dgrad_kernel), kDgradSmemFloats);
  if (err == cudaSuccess)
    err = set_smem(reinterpret_cast<const void*>(subsample_wgrad_kernel), kWgradSmemFloats);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* xf = static_cast<const float*>(x);
  const float* w0f = static_cast<const float*>(w0p);
  const float* dyf = static_cast<const float*>(dy);
  const float* y1f = static_cast<const float*>(y1);
  subsample_dgrad_kernel<<<n_blocks0, kThreads, kDgradSmemFloats * sizeof(float), stream>>>(
      xf, w0f, static_cast<const float*>(w1d), dyf, y1f, part0, Tn, T1, static_cast<int>(tiles));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  subsample_wgrad_kernel<<<dim3(kTaps, n_splits), kThreads, kWgradSmemFloats * sizeof(float),
                           stream>>>(xf, w0f, dyf, y1f, part1, part_db1, Tn, T1,
                                     static_cast<int>(M));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int outputs = kTaps * kC * kC + kC + kPart0;
  subsample_reduce_kernel<<<(outputs + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part0, part1, part_db1, static_cast<float*>(dw0), static_cast<float*>(db0),
      static_cast<float*>(dw1), static_cast<float*>(db1), n_blocks0, n_splits);
  return static_cast<int>(cudaGetLastError());
}
