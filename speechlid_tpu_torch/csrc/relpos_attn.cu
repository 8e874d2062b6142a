// Shaw relative-position self-attention of the Conformer blocks for Hopper
// (sm_90a), forward and backward, float32 with IEEE products and sums (no
// TF32):
//
//   o_i = Σ_j softmax_j(S_i) · v_j,   S_ij = s · q_i · (k_j + E[clip(i − j, ±P) + P]),   s = d^-1/2
//
// for every (utterance, head), q, k, v (B, N, H·D) rows as the projections
// write them (k and v the two halves of to_kv's (B, N, 2·H·D)), E the
// (2P + 1, D) table, and a pair masked (S = finfo.min, as the plain chain
// fills it) where either frame is padded: a padded query row takes the
// uniform average of v over all N keys, a valid row weighs padded keys 0.
//
// Replaces no TPU kernel: the JAX package leaves the attention to XLA
// (models/conformer.py RelPosAttention), where q·Eᵀ over the whole table and
// a gather suit the TPU.  On the card that chain wrote a (B, H, N, 2P + 1)
// product (86 % of it discarded), then scaled, added, masked, soft-maxed and
// multiplied (B, H, N, N) tensors one pass each, and its backward
// scatter-added into a zeroed (B, H, N, 2P + 1) gradient with atomics.
//
// What bounds it: one FMA per query, key and channel for each of q·kᵀ, the
// relative-position term and p·v (and their gradients), against 16 bytes a
// row and channel of q, k, v and o: float32 FFMA operations (67 TFLOP/s).
// So no (N, N) or (N, 2P + 1) tensor reaches device memory:
//
//   forward   one block of 64 threads per (utterance·head, 32 queries)
//             walks the keys 32 at a time with an online softmax.  A
//             32 × 32 tile of pairs needs only the 63 rows of E on its
//             diagonals (i − j), staged in shared memory beside q, k and v
//             (s goes on each dot).  A thread owns the pairs (ty + 8a,
//             tx + 8b), a, b < 4, which touch 7 of those rows.  o and one
//             log-sum-exp a row are written.
//   backward  one block of 256 threads (8 warps) per (utterance, group of
//             G heads, 64 keys) walks the queries 32 at a time, three phases
//             a step between barriers.  (1) Warps 0–3 recompute S for the
//             32 × 64 pairs, each 32-key half by the forward's own function
//             over its slice of the step's band (rows 32 − 32kh …), so every
//             logit is the forward's bit for bit; warps 4–7 compute dP =
//             dO·vᵀ for the same pairs and D_i = dO_i · o_i (o staged where P
//             goes next).  A thread owns 4 × 4 pairs (ty + 8a, 32kh + tx +
//             8b): 4 channels of 4 rows of each operand and 7 band rows feed
//             32 FMAs (64 with the band).  (2) Warps 0–3 form P = exp(S −
//             lse) and dS = P ⊙ (dP − D), zero unless both frames are valid,
//             dS over dP in place and again skewed by diagonal (G[i][i − j +
//             63]).  (3) All 8 warps: dV in warps 0–3 and dK in 4–7 sum in
//             registers across the walk, a thread 4 keys × D/8 channels (32
//             floats at d = 64: a float4 of P or dS and D/32 of dO or q feed
//             8·D/8 FMAs); dQ's partial of the key tile, dS·k + G·E (at d =
//             64 a warp 16 rows × 16 channels, 2 × 4 a thread, so a float4 of
//             k or E is read by 4 groups of lanes; at d = 32 a warp 4 rows ×
//             all channels), and dE along the step's 95 diagonals into the
//             block's partial (rows i0 + e; 4 diagonals × D/16 channels a
//             thread, warps 0–3 the diagonals 32 … 63, 4–7 the rest).  A
//             32-key half without a valid key is left out of S, dP, dK, and
//             of the diagonals only it reaches.  Shared memory is 106 KB at d
//             = 64 (70 KB at d = 32) and a thread keeps to 128 registers,
//             so two blocks, 16 warps, share an SM: enough to hide the
//             latency of shared loads and dependent FMAs.  64 keys a block
//             halve dQ's partials: 277 MB a call at the training encoder (b,
//             h, n) = (128, 4, 324), where 32-key blocks would write 507;
//             dE's 163 MB (G = 2).  dQ stays
//             partial: a separate pass would recompute S and P (11.7 products
//             a pair against 8.7).  Two small kernels then sum dQ's partials
//             over the key tiles and dE's over the blocks (the clipped
//             distances into E's edge rows), each in index order, the latter
//             8 table rows a CUDA block so each partial is read in runs.
//
// The mask decides what a tile computes: a tile where no valid row meets a
// valid key takes no logits (its padded rows only their uniform weights, its
// dS 0), and one that has no padded row either is skipped; what it leaves
// out is exact zeros.
//
// No atomics, and the order of every sum is fixed by the shape and the mask
// alone: the same bits on every run.  D (the head width) is 32 or 64; G (heads a
// backward block takes) comes from ops/cuda/relpos_attn_kernel.py.
//
// The Transformer-XL form (wav2vec 2.0 Conformer: S_ij = s·[(q_i + u)·k_j + (q_i
// + v)·p_{i−j}], unclipped) is the same source compiled a second time with
// RPA_XL = 1 (ops/cuda/_build.py UNITS), its kernels in the namespace xl and its
// entries relpos_attn_xl_*:
//
//   S_ij = s · q'_i · (k_j + E_h[clip(i − j, ±P) + P]) + β_h[clip(i − j, ±P) + P]
//
// with q' = q + u, a table E_h = p_h per head (H, 2P + 1, D) and a logit bias
// β_h(r) = s·(v_h − u_h)·p_h(r) per head and distance (H, 2P + 1), both made by
// the caller.  The bias rides in shared memory beside its band of E and goes on
// each logit as fmaf(dot, s, β), in the forward and in the backward's
// recomputation alike.  The backward also writes dβ_h(r) = Σ_{i−j=r} dS_ij (the
// diagonal sums dE forms, with q' replaced by 1).  Since every head has its own
// table, a block takes one head (G = 1) and dE's and dβ's partials are per head,
// head-major, summed per head; four launches.  What RPA_XL adds stands in #if
// blocks, so the Shaw compilation is the code it was.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

#if !defined(RPA_TILE) || !defined(RPA_BWD_KEYS)
#error "the tile sizes come as -D definitions from ops/cuda/_build.py (TILING)"
#endif
#ifndef RPA_XL
#define RPA_XL 0
#endif
#if RPA_XL
namespace xl {
#endif

constexpr int kT = RPA_TILE;       // queries and keys of a forward tile, queries of a backward step
constexpr int kKT = RPA_BWD_KEYS;  // keys of a backward block
static_assert(kT == 32, "the thread mappings are built for 32-query tiles");
static_assert(kKT == 2 * kT, "a backward block's keys are two 32-key halves of the forward's tile");
constexpr int kThreads = 64;       // forward: 8 × 8, ty = tid / 8, tx = tid % 8
constexpr int kBand = 2 * kT;      // E rows of a forward tile's band: 63 used, row 63 zero
constexpr int kPS = kT + 4;        // row stride of the forward's 32 × 32 P tile
constexpr int kBwdThreads = 256;   // backward: two halves of 128, then all 256
constexpr int kBwdBand = kT + kKT;  // E rows of a backward step's band: 95 used, row 95 zero
constexpr int kBPS = kKT + 4;      // row stride of the backward's 32 × 64 P and dS tiles
constexpr int kBGS = kBwdBand + 4;  // row stride of the skewed dS (96 diagonals)
constexpr int kReduceThreads = 1024;
constexpr int kOut = 0, kDead = 1, kLive = 2;  // a frame past N, padded, valid

template <int D>
struct Cfg {
  static_assert(D == 32 || D == 64, "head widths 32 and 64");
  static constexpr int S = D + 4;     // row stride of the q, k, v, dO and E tiles
  static constexpr int CPT = D / 8;   // channels a thread owns of a (32 × D) tile (forward), in dK, dV
  static constexpr int CH = D / 16;   // channels a backward thread owns in dQ and dE
  // the backward's shared floats: k, v (64 rows), q, dO (32), the band (96), P
  // (o before it) and dS (dP before it), the skewed dS
  static constexpr int BWD_FLOATS = (2 * kKT + 2 * kT + kBwdBand) * S + 2 * kT * kBPS + kT * kBGS;
};

struct Args {
  const float* q;        // (B, N, H·D)
  const float* kv;       // (B, N, 2·H·D): k, then v
  const float* table;    // (2P + 1, D)
  const uint8_t* mask;   // (B, N), 1 = valid; null: every frame valid
  float* o;              // (B, N, H·D): the forward's output, the backward's input
  float* lse;            // (B·H, NP)
  const float* dout;     // (B, N, H·D)
  float* dq;             // (B, N, H·D)
  float* dkv;            // (B, N, 2·H·D)
  float* dtable;         // (2P + 1, D)
  float* part_dq;        // (n key tiles, B·H, NP, D), 64 keys a tile
  float* part_de;        // (B·H/G, n key tiles, NR, D)
  int B, N, H, P, G;
  float scale;
#if RPA_XL
  const float* beta;     // (H, 2P + 1): the logit bias by distance
  float* dbeta;          // (H, 2P + 1)
  float* part_db;        // (H·B, n key tiles, NR): dβ's partials, head-major
#endif
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// W = D/16 floats (the backward's dQ and dE channels): a float4 or a float2.
template <int W>
__device__ __forceinline__ void ld_vec(const float* p, float (&v)[W]) {
  static_assert(W == 2 || W == 4, "2 or 4 floats");
  if constexpr (W == 4) {
    const float4 x = ld4(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  }
}

template <int W>
__device__ __forceinline__ void st_vec(float* p, const float (&v)[W], float mul) {
  static_assert(W == 2 || W == 4, "2 or 4 floats");
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0] * mul, v[1] * mul, v[2] * mul, v[3] * mul);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0] * mul, v[1] * mul);
}

// A thread's channels of a (32 × D) row: 4tx … 4tx + 3, then 32 + 4tx … 32 + 4tx + 3 (D = 64).
template <int D>
__device__ __forceinline__ void load_chans(const float* row, int tx, float (&v)[D / 8]) {
#pragma unroll
  for (int g = 0; g < D / 32; ++g) {
    const float4 x = ld4(row + 32 * g + 4 * tx);
    v[4 * g] = x.x; v[4 * g + 1] = x.y; v[4 * g + 2] = x.z; v[4 * g + 3] = x.w;
  }
}

template <int D>
__device__ __forceinline__ void store_chans(float* row, int tx, const float (&v)[D / 8], float mul) {
#pragma unroll
  for (int g = 0; g < D / 32; ++g)
    *reinterpret_cast<float4*>(row + 32 * g + 4 * tx) =
        make_float4(v[4 * g] * mul, v[4 * g + 1] * mul, v[4 * g + 2] * mul, v[4 * g + 3] * mul);
}

// Rows [r0, r0 + ROWS) of a (·, D) matrix with row stride `ld` into a tile of
// stride D + 4 by cp.async, NT threads, zeros at or past `limit`; the caller
// commits and waits (tile_ready) once for every tile of a step.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src, size_t ld, int r0,
                                          int limit) {
  constexpr int V = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * V; idx += NT) {
    const int r = idx / V, c = 4 * (idx % V);
    const bool in = r0 + r < limit;
    __pipeline_memcpy_async(dst + r * Cfg<D>::S + c, src + (size_t)(in ? r0 + r : 0) * ld + c,
                            16, in ? 0 : 16);
  }
}

// The band of E a tile reads: row e holds E[clip(diag0 + e, ±P) + P] for e <
// ROWS − 1 (a forward tile's pair (i, j) reads row i − j + 31, a backward
// step's i − j + 63, tile-local); the last row is zero.  By cp.async, as
// load_rows.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_band(float* Es, const float* table, int P, int diag0) {
  constexpr int V = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * V; idx += NT) {
    const int e = idx / V, c = 4 * (idx % V);
    const bool in = e < ROWS - 1;
    const int row = in ? min(max(diag0 + e, -P), P) + P : 0;
    __pipeline_memcpy_async(Es + e * Cfg<D>::S + c, table + (size_t)row * D + c, 16,
                            in ? 0 : 16);
  }
}

#if RPA_XL
// The bias band beside its band of E: row e holds β[clip(diag0 + e, ±P) + P]
// for e < ROWS − 1, the last row zero.  Plain loads; the tile's barrier
// publishes them.
template <int ROWS, int NT>
__device__ __forceinline__ void load_beta(float* Bs, const float* beta, int P, int diag0) {
  for (int e = threadIdx.x; e < ROWS; e += NT)
    Bs[e] = e < ROWS - 1 ? beta[min(max(diag0 + e, -P), P) + P] : 0.f;
}
#endif

// Every copy this thread issued has landed, then every thread's has.
__device__ __forceinline__ void tile_ready() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

__device__ __forceinline__ int frame_state(const uint8_t* mask, int i, int N) {
  return i >= N ? kOut : ((mask != nullptr && mask[i] == 0) ? kDead : kLive);
}

// The logit of a pair as the chain's softmax sees it: a padded query row is
// uniform over the N keys (0 stands for its constant fill), a padded key of
// a valid row and a key past N weigh nothing.
__device__ __forceinline__ float logit(float s, int row, int key) {
  if (key == kOut) return -INFINITY;
  if (row == kDead) return 0.f;
  return key == kLive ? s : -INFINITY;
}

// acc[a][b] = Σ_c A[ty + 8a][c] · (B[tx + 8b][c] (+ E[ty − tx + 31 + 8(a − b)][c])),
// the channels in order, one FMA each: the 4 × 4 pairs a thread owns.
template <int D, bool WITH_E>
__device__ __forceinline__ void pair_dots(const float* __restrict__ As, const float* __restrict__ Bs,
                                          const float* __restrict__ Es, int ty, int tx,
                                          float (&acc)[4][4]) {
  constexpr int S = Cfg<D>::S;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 1  // fewer registers: more blocks an SM at d = 32
  for (int c = 0; c < D; c += 4) {
    float4 x[4], y[4], e[7];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = ld4(As + (ty + 8 * a) * S + c);
#pragma unroll
    for (int b = 0; b < 4; ++b) y[b] = ld4(Bs + (tx + 8 * b) * S + c);
    if constexpr (WITH_E) {
#pragma unroll
      for (int t = 0; t < 7; ++t) e[t] = ld4(Es + (ty - tx + 7 + 8 * t) * S + c);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float v = acc[a][b];
        v = fmaf(x[a].x, y[b].x, v);
        if constexpr (WITH_E) v = fmaf(x[a].x, e[a - b + 3].x, v);
        v = fmaf(x[a].y, y[b].y, v);
        if constexpr (WITH_E) v = fmaf(x[a].y, e[a - b + 3].y, v);
        v = fmaf(x[a].z, y[b].z, v);
        if constexpr (WITH_E) v = fmaf(x[a].z, e[a - b + 3].z, v);
        v = fmaf(x[a].w, y[b].w, v);
        if constexpr (WITH_E) v = fmaf(x[a].w, e[a - b + 3].w, v);
        acc[a][b] = v;
      }
  }
}

// ---------------------------------------------------------------- forward

template <int D>
__global__ void __launch_bounds__(kThreads) relpos_fwd_kernel(Args a) {
  constexpr int S = Cfg<D>::S, CPT = Cfg<D>::CPT;
  __shared__ __align__(16) float Qs[kT * S];
  __shared__ __align__(16) float Ks[kT * S];
  __shared__ __align__(16) float Vs[kT * S];
  __shared__ __align__(16) float Es[kBand * S];
  __shared__ __align__(16) float Ps[kT * kPS];
  __shared__ int kst[kT];
#if RPA_XL
  __shared__ float Bs[kBand];  // the bias band
#endif
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, i0 = blockIdx.y * kT;
  const int N = a.N, HD = a.H * D, NP = gridDim.y * kT;
  const float* qb = a.q + (size_t)b * N * HD + h * D;
  const float* kb = a.kv + (size_t)b * N * 2 * HD + h * D;
  const uint8_t* mb = a.mask == nullptr ? nullptr : a.mask + (size_t)b * N;

  load_rows<D, kT, kThreads>(Qs, qb, HD, i0, N);  // s·q·(k + E): the scale goes on the dot
  // what the tile's rows need: a valid row the valid keys' logits, a padded
  // row the uniform weights of all N keys
  const int rs = tid < kT ? frame_state(mb, i0 + tid, N) : kOut;
  const int q_live = __syncthreads_or(rs == kLive), q_dead = __syncthreads_or(rs == kDead);
  int rst[4];
  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    rst[r] = frame_state(mb, i0 + ty + 8 * r, N);
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int u = 0; u < CPT; ++u) acc[r][u] = 0.f;
  }
  const int nkt = (N + kT - 1) / kT;
  for (int kt = 0; kt < nkt; ++kt) {
    const int j0 = kt * kT;
    const int ks = tid < kT ? frame_state(mb, j0 + tid, N) : kOut;
    // also: the last tile's readers are done
    const int k_live = __syncthreads_or(ks == kLive);
    if (!q_dead && !k_live) continue;  // every weight of the tile is 0
    const bool logits = q_live && k_live;  // else only padded rows' uniform weights
    if (logits) {
      load_rows<D, kT, kThreads>(Ks, kb, 2 * (size_t)HD, j0, N);
#if RPA_XL  // the head's own table and bias
      load_band<D, kBand, kThreads>(Es, a.table + (size_t)h * (2 * a.P + 1) * D, a.P,
                                    i0 - j0 - (kT - 1));
      load_beta<kBand, kThreads>(Bs, a.beta + (size_t)h * (2 * a.P + 1), a.P, i0 - j0 - (kT - 1));
#else
      load_band<D, kBand, kThreads>(Es, a.table, a.P, i0 - j0 - (kT - 1));
#endif
    }
    load_rows<D, kT, kThreads>(Vs, kb + HD, 2 * (size_t)HD, j0, N);
    if (tid < kT) kst[tid] = ks;
    tile_ready();
    float s[4][4] = {};
    if (logits) pair_dots<D, true>(Qs, Ks, Es, ty, tx, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#if RPA_XL  // pair (ty + 8r, tx + 8c): band row i − j + 31
        s[r][c] = logit(logits ? fmaf(s[r][c], a.scale, Bs[ty - tx + kT - 1 + 8 * (r - c)]) : 0.f,
                        rst[r], kst[tx + 8 * c]);
#else
        s[r][c] = logit(s[r][c] * a.scale, rst[r], kst[tx + 8 * c]);
#endif
        tmax = fmaxf(tmax, s[r][c]);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float mnew = fmaxf(m[r], tmax);
      const float mu = mnew == -INFINITY ? 0.f : mnew;
      const float alpha = expf(m[r] - mu);
      m[r] = mnew;
      float ls = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - mu);
        Ps[(ty + 8 * r) * kPS + tx + 8 * c] = p;
        ls += p;
      }
      l[r] = l[r] * alpha + ls;
#pragma unroll
      for (int u = 0; u < CPT; ++u) acc[r][u] *= alpha;
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kT; j += 4) {
      float4 p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = ld4(Ps + (ty + 8 * r) * kPS + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float v[CPT];
        load_chans<D>(Vs + (j + jj) * S, tx, v);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int u = 0; u < CPT; ++u) acc[r][u] = fmaf(at(p[r], jj), v[u], acc[r][u]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float lsum = l[r];
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    const int i = i0 + ty + 8 * r;
    if (i < N) {
#pragma unroll
      for (int u = 0; u < CPT; ++u) acc[r][u] = acc[r][u] / lsum;
      store_chans<D>(a.o + (size_t)(b * N + i) * HD + h * D, tx, acc[r], 1.f);
      if (tx == 0) a.lse[(size_t)bh * NP + i] = (m[r] == -INFINITY ? 0.f : m[r]) + logf(lsum);
    }
  }
}

// ---------------------------------------------------------------- backward

// acc_j += Σ_i W_ij X_i over a step's 32 queries in order (dV: W = P, X =
// dO; dK: W = dS, X = q, s goes on at the end): keys 4kx + r, channels
// (D/8)·kc + u.
template <int D>
__device__ __forceinline__ void dkv_step(const float* __restrict__ Ws, const float* __restrict__ Xs,
                                         int kx, int kc, float (&acc)[4][D / 8]) {
  constexpr int S = Cfg<D>::S, CPT = Cfg<D>::CPT;
#pragma unroll 4
  for (int i = 0; i < kT; ++i) {
    const float4 w = ld4(Ws + i * kBPS + 4 * kx);
    float x[CPT];
#pragma unroll
    for (int g = 0; g < CPT / 4; ++g) {
      const float4 v = ld4(Xs + i * S + CPT * kc + 4 * g);
      x[4 * g] = v.x; x[4 * g + 1] = v.y; x[4 * g + 2] = v.z; x[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < CPT; ++u) acc[r][u] = fmaf(at(w, r), x[u], acc[r][u]);
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 2) relpos_bwd_kernel(Args a) {
  constexpr int S = Cfg<D>::S, CPT = Cfg<D>::CPT, CH = Cfg<D>::CH;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kKT * S;
  float* Qs = Vs + kKT * S;
  float* dOs = Qs + kT * S;
  float* Es = dOs + kT * S;
  float* Ps = Es + kBwdBand * S;  // P[i][j]; before it o[i] (stride S), for D_i
  float* dSs = Ps + kT * kBPS;    // dS[i][j]; before it dP[i][j]
  float* Gs = dSs + kT * kBPS;    // dS[i][j] at Gs[i][i − j + 63]
  __shared__ int kst[kKT], rst[kT];
  __shared__ float lse_s[kT], dsum[kT];
#if RPA_XL
  __shared__ float Bb[kBwdBand];  // the step's bias band
#endif
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // (1): half 0 (warps 0–3) S, half 1 dP; a thread the pairs (ty + 8a, 32kh + tx + 8b)
  const int half = tid >> 7, kh = (tid >> 6) & 1, ty = (tid >> 3) & 7, tx = tid & 7;
  // (3) dV in half 0, dK in half 1: keys 4kx + r, channels (D/8)·kc + u
  const int kx = (lane & 7) + 8 * (warp & 1), kc = (lane >> 3) + 4 * ((warp >> 1) & 1);
  // (3) dQ: rows r0 and r1 = r0 + kQStep, channels qc + u: at d = 64 a warp
  // takes 16 rows (from 16(w % 2)) × 16 channels, so each float4 of k or E
  // goes to 8 lanes; at d = 32 a warp 4 rows (from 4w) × all 32 channels,
  // fewer diagonals.  dE: diagonals 4m + t (+32g), m = 2(w % 4) + lane / 16,
  // g = 1 in warps 0–3, 0 and 2 in 4–7, channels CH·(lane % 16) + u
  constexpr bool kWide = D == 64;
  constexpr int kQStep = kWide ? 8 : 2, kQDiag = kWide ? 80 : 68;  // diagonals a warp walks
  const int r0 = kWide ? 16 * (warp & 1) + (lane & 7) : 4 * warp + (lane >> 4);
  const int qc = kWide ? 16 * (warp >> 1) + 4 * (lane >> 3) : 2 * (lane & 15);
  const int q_elo = kWide ? 16 * (warp & 1) : 4 * warp;
  const int cg = lane & 15, m = 2 * (warp & 3) + (lane >> 4);
  const int hg = blockIdx.x, kt = blockIdx.y, nkt = gridDim.y, j0 = kt * kKT;
  const int N = a.N, H = a.H, HD = H * D, G = a.G, HG = H / G;
  const int b = hg / HG, grp = hg % HG;
  const int nqt = (N + kT - 1) / kT, NP = nqt * kT, NR = NP + kKT - 1;
  const uint8_t* mb = a.mask == nullptr ? nullptr : a.mask + (size_t)b * N;
#if RPA_XL  // one head a block (G = 1): its own partials, head-major
  float* pde = a.part_de + (((size_t)grp * a.B + b) * nkt + kt) * NR * D;
  float* pdb = a.part_db + (((size_t)grp * a.B + b) * nkt + kt) * NR;
#else
  float* pde = a.part_de + ((size_t)hg * nkt + kt) * NR * D;
#endif

  // diagonals no pair of a step reaches stay zero in every step
  for (int idx = tid; idx < kT * kBGS; idx += kBwdThreads) Gs[idx] = 0.f;
  const int ks = tid < kKT ? frame_state(mb, j0 + tid, N) : kOut;
  if (tid < kKT) kst[tid] = ks;
  // a 32-key half without a valid key has no logits and a zero dS: its S,
  // dP, dK and the diagonals only it reaches are left out
  const bool k_lo = __syncthreads_or(tid < kT && ks == kLive) != 0;
  const bool k_hi = __syncthreads_or(tid >= kT && ks == kLive) != 0;
  const bool k_live = k_lo || k_hi;

  for (int hh = 0; hh < G; ++hh) {
    const int h = grp * G + hh, bh = b * H + h;
    const float* qb = a.q + (size_t)b * N * HD + h * D;
    const float* ob = a.o + (size_t)b * N * HD + h * D;
    const float* gb = a.dout + (size_t)b * N * HD + h * D;
    const float* kb = a.kv + (size_t)b * N * 2 * HD + h * D;
    __syncthreads();  // the last head's readers of Ks and Vs are done
    load_rows<D, kKT, kBwdThreads>(Ks, kb, 2 * (size_t)HD, j0, N);
    load_rows<D, kKT, kBwdThreads>(Vs, kb + HD, 2 * (size_t)HD, j0, N);
    tile_ready();
    float dkv[4][CPT];  // dV in half 0, dK / s in half 1
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < CPT; ++u) dkv[r][u] = 0.f;

    for (int qt = 0; qt < nqt; ++qt) {
      const int i0 = qt * kT;
      const int rs = tid < kT ? frame_state(mb, i0 + tid, N) : kOut;
      // also: the last step's readers are done
      const int q_live = __syncthreads_or(rs == kLive), q_dead = __syncthreads_or(rs == kDead);
      // dS is 0 unless a valid row meets a valid key; P is 0 unless it is
      // that, or a padded row (uniform over the N keys)
      const bool need_ds = q_live && k_live, need_p = need_ds || q_dead;
      if (need_p) {
        if (need_ds) {
          load_rows<D, kT, kBwdThreads>(Qs, qb, HD, i0, N);
          load_rows<D, kT, kBwdThreads>(Ps, ob, HD, i0, N);
#if RPA_XL
          load_band<D, kBwdBand, kBwdThreads>(Es, a.table + (size_t)h * (2 * a.P + 1) * D, a.P,
                                              i0 - j0 - (kKT - 1));
          load_beta<kBwdBand, kBwdThreads>(Bb, a.beta + (size_t)h * (2 * a.P + 1), a.P,
                                           i0 - j0 - (kKT - 1));
#else
          load_band<D, kBwdBand, kBwdThreads>(Es, a.table, a.P, i0 - j0 - (kKT - 1));
#endif
        }
        load_rows<D, kT, kBwdThreads>(dOs, gb, HD, i0, N);
        if (tid < kT) {
          rst[tid] = rs;
          lse_s[tid] = rs != kOut ? a.lse[(size_t)bh * NP + i0 + tid] : 0.f;
        }
        tile_ready();
        // (1) S in half 0: each 32-key half as a forward tile, its band the
        // rows 32 − 32kh … of this step's; dP and D_i in half 1
        const bool my_keys = kh == 0 ? k_lo : k_hi;
        float s[4][4] = {};
        if (need_ds && half == 0) {
          if (my_keys)
            pair_dots<D, true>(Qs, Ks + kh * kT * S, Es + (kKT - kT - kh * kT) * S, ty, tx, s);
        } else if (need_ds) {
          if (my_keys) {
            float dp[4][4];
            pair_dots<D, false>(dOs, Vs + kh * kT * S, nullptr, ty, tx, dp);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) dSs[(ty + 8 * r) * kBPS + kh * kT + tx + 8 * c] = dp[r][c];
          }
          const int t = tid - 128, r = t >> 2, part = t & 3;  // D_i: four threads a row
          float d = 0.f;
#pragma unroll
          for (int m4 = 0; m4 < D / 16; ++m4) {
            const int c = part * (D / 4) + 4 * m4;
            const float4 x = ld4(Ps + r * S + c), g = ld4(dOs + r * S + c);  // o, dO
            d = fmaf(g.x, x.x, d); d = fmaf(g.y, x.y, d);
            d = fmaf(g.z, x.z, d); d = fmaf(g.w, x.w, d);
          }
          d += __shfl_xor_sync(0xffffffffu, d, 1);
          d += __shfl_xor_sync(0xffffffffu, d, 2);
          if (part == 0) dsum[r] = d;
        }
        __syncthreads();
        // (2) P and dS of half 0's pairs; dS over dP in place and skewed
        if (half == 0) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int il = ty + 8 * r, jl = kh * kT + tx + 8 * c, rsi = rst[il], ksj = kst[jl];
              float p = 0.f, ds = 0.f;
              if (rsi != kOut && ksj != kOut) {
#if RPA_XL  // the forward's logit: band row i − j + 63
                p = expf(logit(fmaf(s[r][c], a.scale, Bb[il - jl + kKT - 1]), rsi, ksj) - lse_s[il]);
#else
                p = expf(logit(s[r][c] * a.scale, rsi, ksj) - lse_s[il]);
#endif
                if (rsi == kLive && ksj == kLive) ds = p * (dSs[il * kBPS + jl] - dsum[il]);
              }
              Ps[il * kBPS + jl] = p;
              if (need_ds) {
                dSs[il * kBPS + jl] = ds;
                Gs[il * kBGS + il - jl + kKT - 1] = ds;
              }
            }
        }
        __syncthreads();
        // (3) dV_j += Σ_i P_ij dO_i in half 0, dK_j += Σ_i dS_ij q_i in half 1
        if (half == 0 ? q_dead || ((warp & 1) == 0 ? k_lo : k_hi)
                      : need_ds && ((warp & 1) == 0 ? k_lo : k_hi))
          dkv_step<D>(half == 0 ? Ps : dSs, half == 0 ? dOs : Qs, kx, kc, dkv);
      }
      // dE / s along the step's diagonals e: Σ_i G[i][e] q_i, into the
      // block's partial row i0 + e.  The rows the last step also reached (e
      // < 63) and the later heads of the group add the step's sum to what is
      // there (another thread wrote it, before the barrier that opened this
      // step); a step without dS writes zeros where it would write first.
      // XL: dβ the same way, Σ_i G[i][e], by the lane of channel group 0.
      for (int gi = 0; gi <= half; ++gi) {
        const int g = half == 0 ? 1 : 2 * gi, e0 = 4 * m + 32 * g;
        const int ilo = max(0, 8 * (warp & 3) + 32 * g - (kKT - 1));
        const int ihi = min(kT - 1, 8 * (warp & 3) + 7 + 32 * g);  // the warp's rows: G is 0 past a lane's
        float acc[4][CH], old[4][CH];
#if RPA_XL
        float db[4], db_old[4];
#endif
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int ee = e0 + t;
          const bool fresh = hh == 0 && (qt == 0 || ee >= kKT - 1);
#pragma unroll
          for (int u = 0; u < CH; ++u) acc[t][u] = 0.f;
          if (ee < kBwdBand - 1 && !fresh && need_ds)
            ld_vec<CH>(pde + (size_t)(i0 + ee) * D + CH * cg, old[t]);
          else
#pragma unroll
            for (int u = 0; u < CH; ++u) old[t][u] = 0.f;
#if RPA_XL
          db[t] = 0.f;
          db_old[t] = ee < kBwdBand - 1 && !fresh && need_ds && cg == 0 ? pdb[i0 + ee] : 0.f;
#endif
        }
        // e < 32 only the keys 32 … 63 reach, e ≥ 64 only 0 … 31
        if (need_ds && (g != 0 || k_hi) && (g != 2 || k_lo)) {
          for (int i = ilo; i <= ihi; ++i) {
            const float4 gv = ld4(Gs + i * kBGS + e0);
            float x[CH];
            ld_vec<CH>(Qs + i * S + CH * cg, x);
#pragma unroll
            for (int t = 0; t < 4; ++t)
#pragma unroll
              for (int u = 0; u < CH; ++u) acc[t][u] = fmaf(at(gv, t), x[u], acc[t][u]);
#if RPA_XL
#pragma unroll
            for (int t = 0; t < 4; ++t) db[t] += at(gv, t);
#endif
          }
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int ee = e0 + t;
          const bool fresh = hh == 0 && (qt == 0 || ee >= kKT - 1);
          if (ee < kBwdBand - 1 && (fresh || need_ds)) {
#pragma unroll
            for (int u = 0; u < CH; ++u) acc[t][u] += old[t][u];
            st_vec<CH>(pde + (size_t)(i0 + ee) * D + CH * cg, acc[t], 1.f);
#if RPA_XL
            if (cg == 0) pdb[i0 + ee] = db[t] + db_old[t];
#endif
          }
        }
      }
      {  // dQ's partial of this key tile: s·(Σ_j dS_ij k_j + Σ_e G[i][e] E_e)
        const int r1 = r0 + kQStep;
        float acc[2][CH];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int u = 0; u < CH; ++u) acc[r][u] = 0.f;
        if (need_ds) {
#pragma unroll 2
          for (int j = k_lo ? 0 : kT; j < (k_hi ? kKT : kT); j += 4) {
            const float4 g0 = ld4(dSs + r0 * kBPS + j), g1 = ld4(dSs + r1 * kBPS + j);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              float x[CH];
              ld_vec<CH>(Ks + (j + t) * S + qc, x);
#pragma unroll
              for (int u = 0; u < CH; ++u) {
                acc[0][u] = fmaf(at(g0, t), x[u], acc[0][u]);
                acc[1][u] = fmaf(at(g1, t), x[u], acc[1][u]);
              }
            }
          }
          // the warp's rows reach kQDiag − 1 diagonals from q_elo; keys 0 … 31
          // only those from q_elo + 32, keys 32 … 63 only those below
          // q_elo + kQDiag − 32
          const int e_hi = q_elo + (k_lo ? kQDiag : kQDiag - kT);
#pragma unroll 2
          for (int e = q_elo + (k_hi ? 0 : kT); e < e_hi; e += 4) {
            const float4 g0 = ld4(Gs + r0 * kBGS + e), g1 = ld4(Gs + r1 * kBGS + e);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              float x[CH];
              ld_vec<CH>(Es + (e + t) * S + qc, x);
#pragma unroll
              for (int u = 0; u < CH; ++u) {
                acc[0][u] = fmaf(at(g0, t), x[u], acc[0][u]);
                acc[1][u] = fmaf(at(g1, t), x[u], acc[1][u]);
              }
            }
          }
        }
        float* dst = a.part_dq + (((size_t)kt * a.B * H + bh) * NP + i0) * D + qc;
        st_vec<CH>(dst + r0 * D, acc[0], a.scale);
        st_vec<CH>(dst + r1 * D, acc[1], a.scale);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + 4 * kx + r;
      if (j < N) {
        float* row = a.dkv + (size_t)(b * N + j) * 2 * HD + (half == 0 ? HD : 0) + h * D + CPT * kc;
        const float mul = half == 0 ? 1.f : a.scale;
#pragma unroll
        for (int g = 0; g < CPT / 4; ++g)
          *reinterpret_cast<float4*>(row + 4 * g) =
              make_float4(dkv[r][4 * g] * mul, dkv[r][4 * g + 1] * mul, dkv[r][4 * g + 2] * mul,
                          dkv[r][4 * g + 3] * mul);
      }
    }
  }
}

// dQ (B, N, H·D): the key tiles' partials summed in order.
template <int D>
__global__ void relpos_dq_reduce_kernel(const float* __restrict__ part, float* __restrict__ dq,
                                        int B, int N, int H, int NP, int nkt) {
  const size_t total = (size_t)B * N * H * D, stride = (size_t)B * H * NP * D;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += (size_t)gridDim.x * blockDim.x) {
    const int c = static_cast<int>(o % D);
    size_t rest = o / D;
    const int h = static_cast<int>(rest % H);
    rest /= H;
    const int i = static_cast<int>(rest % N);
    const size_t b = rest / N;
    const float* p = part + ((b * H + h) * NP + i) * D + c;
    float s = p[0];
    for (int kt = 1; kt < nkt; ++kt) s += p[kt * stride];
    dq[o] = s;
  }
}

// dE rows R of the table: s times every block's partial rows ρ whose
// distance r = ρ − j0 − 63 clips to R − P, the blocks dealt to
// kReduceThreads / D parts, each part's sum in block and row order, the
// parts added in order.  A CUDA block takes kDeRows rows inside the table
// (one ρ a block each, contiguous, or none: it adds 0); blocks 0 and 1 take
// the edge rows 0 and 2P, every clipped ρ, kDeRows at a time.
constexpr int kDeRows = 8;

template <int D>
__global__ void __launch_bounds__(kReduceThreads) relpos_de_reduce_kernel(
    const float* __restrict__ part, float* __restrict__ dtable, int nblk, int nkt, int NR, int P,
    float scale) {
  constexpr int kParts = kReduceThreads / D;
  __shared__ float sums[kDeRows][kReduceThreads];
#if RPA_XL  // head blockIdx.y's table rows from its own blocks' partials (nblk a head)
  part += (size_t)blockIdx.y * nblk * NR * D;
  dtable += (size_t)blockIdx.y * (2 * P + 1) * D;
#endif
  const int t = threadIdx.x, c = t % D;
  const bool edge = blockIdx.x < 2;
  const int R0 = edge ? (blockIdx.x == 0 ? 0 : 2 * P) : 1 + (blockIdx.x - 2) * kDeRows;
  float s[kDeRows];
#pragma unroll
  for (int u = 0; u < kDeRows; ++u) s[u] = 0.f;
  for (int blk = t / D; blk < nblk; blk += kParts) {
    const float* pb = part + (size_t)blk * NR * D + c;
    const int rho0 = R0 - P + (blk % nkt) * kKT + kKT - 1;  // R0's ρ in this block
    if (!edge) {
      float v[kDeRows];
#pragma unroll
      for (int u = 0; u < kDeRows; ++u)
        v[u] = R0 + u < 2 * P && rho0 + u >= 0 && rho0 + u < NR ? pb[(size_t)(rho0 + u) * D] : 0.f;
#pragma unroll
      for (int u = 0; u < kDeRows; ++u) s[u] += v[u];
    } else {
      const int lo = R0 == 0 ? 0 : max(0, rho0), hi = R0 == 2 * P ? NR - 1 : min(NR - 1, rho0);
      for (int rho = lo; rho <= hi; rho += kDeRows) {
        float v[kDeRows];
#pragma unroll
        for (int u = 0; u < kDeRows; ++u) v[u] = rho + u <= hi ? pb[(size_t)(rho + u) * D] : 0.f;
#pragma unroll
        for (int u = 0; u < kDeRows; ++u) s[0] += v[u];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kDeRows; ++u) sums[u][t] = s[u];
  __syncthreads();
  for (int o = t; o < kDeRows * D; o += kReduceThreads) {
    const int u = o / D, ch = o % D, R = R0 + u;
    if ((edge && u > 0) || (!edge && R >= 2 * P)) continue;
    float total = sums[u][ch];
    for (int p = 1; p < kParts; ++p) total += sums[u][p * D + ch];
    dtable[(size_t)R * D + ch] = total * scale;
  }
}

#if RPA_XL
// dβ (H, 2P + 1), a thread a head's row R: every block's partial rows whose
// distance clips to R − P, blocks and rows in order.
__global__ void relpos_db_reduce_kernel(const float* __restrict__ part, float* __restrict__ dbeta,
                                        int nblk, int nkt, int NR, int H, int P) {
  const int rows = 2 * P + 1;
  for (int o = blockIdx.x * blockDim.x + threadIdx.x; o < H * rows; o += gridDim.x * blockDim.x) {
    const int h = o / rows, R = o % rows;
    float s = 0.f;
    for (int blk = 0; blk < nblk; ++blk) {
      const float* pb = part + ((size_t)h * nblk + blk) * NR;
      const int rho0 = R - P + (blk % nkt) * kKT + kKT - 1;
      const int lo = R == 0 ? 0 : max(0, rho0), hi = R == 2 * P ? NR - 1 : min(NR - 1, rho0);
      for (int rho = lo; rho <= hi; ++rho) s += pb[rho];
    }
    dbeta[o] = s;
  }
}
#endif

bool shape_ok(int B, int N, int H, int D, int P) {
  return B >= 1 && N >= 1 && H >= 1 && P >= 0 && (D == 32 || D == 64) &&
         (long long)B * H <= INT32_MAX && (N + kT - 1) / kT <= 65535;
}

template <int D>
int launch_fwd(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.B * a.H, (a.N + kT - 1) / kT);
  relpos_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const Args& a, cudaStream_t stream) {
  const int nkt = (a.N + kKT - 1) / kKT, NP = (a.N + kT - 1) / kT * kT, NR = NP + kKT - 1;
  const size_t smem = Cfg<D>::BWD_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(relpos_bwd_kernel<D>),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nhg = a.B * (a.H / a.G);
  relpos_bwd_kernel<D><<<dim3(nhg, nkt), kBwdThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = (size_t)a.B * a.N * a.H * D;
  const size_t want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  relpos_dq_reduce_kernel<D><<<blocks, 256, 0, stream>>>(a.part_dq, a.dq, a.B, a.N, a.H, NP, nkt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int inner = 2 * a.P - 1;  // table rows between the edges
#if RPA_XL  // a head a grid row, then dβ
  relpos_de_reduce_kernel<D><<<dim3((a.P == 0 ? 1 : 2) + (inner + kDeRows - 1) / kDeRows, a.H),
                               kReduceThreads, 0, stream>>>(
      a.part_de, a.dtable, a.B * nkt, nkt, NR, a.P, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  relpos_db_reduce_kernel<<<(a.H * (2 * a.P + 1) + 255) / 256, 256, 0, stream>>>(
      a.part_db, a.dbeta, a.B * nkt, nkt, NR, a.H, a.P);
#else
  relpos_de_reduce_kernel<D><<<(a.P == 0 ? 1 : 2) + (inner + kDeRows - 1) / kDeRows,
                               kReduceThreads, 0, stream>>>(
      a.part_de, a.dtable, nhg * nkt, nkt, NR, a.P, a.scale);
#endif

  return static_cast<int>(cudaGetLastError());
}

#if RPA_XL
}  // namespace xl
#endif
}  // namespace
#if RPA_XL
using namespace xl;
#endif

#if !RPA_XL
// o (B, N, H·D) and lse (B·H, ceil(N/32)·32) of q (B, N, H·D), kv (B, N, 2·H·D)
// and the table (2P + 1, D); mask (B, N) bytes, 1 = valid, or null.  All float32,
// contiguous.  One launch on `stream`.
extern "C" int relpos_attn_fwd(const void* q, const void* kv, const void* table, const void* mask,
                               void* o, void* lse, int B, int N, int H, int D, int P, float scale,
                               cudaStream_t stream) {
  if (!shape_ok(B, N, H, D, P)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = static_cast<const float*>(q);
  a.kv = static_cast<const float*>(kv);
  a.table = static_cast<const float*>(table);
  a.mask = static_cast<const uint8_t*>(mask);
  a.o = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
  a.B = B; a.N = N; a.H = H; a.P = P; a.G = 1;
  a.scale = scale;
  return D == 64 ? launch_fwd<64>(a, stream) : launch_fwd<32>(a, stream);
}

// dq, dkv and dtable from the forward's inputs, its o and lse and the output
// gradient dout (B, N, H·D); part_dq holds ceil(N/64) · B·H · NP · D floats
// and part_de B·(H/G) · ceil(N/64) · (NP + 63) · D, NP = ceil(N/32)·32; G
// divides H.  Three launches on `stream`: the tiles, dQ's sum, dE's sum.
extern "C" int relpos_attn_bwd(const void* q, const void* kv, const void* table, const void* mask,
                               const void* o, const void* lse, const void* dout, void* dq,
                               void* dkv, void* dtable, void* part_dq, void* part_de, int B, int N,
                               int H, int D, int P, int G, float scale, cudaStream_t stream) {
  if (!shape_ok(B, N, H, D, P) || G < 1 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = static_cast<const float*>(q);
  a.kv = static_cast<const float*>(kv);
  a.table = static_cast<const float*>(table);
  a.mask = static_cast<const uint8_t*>(mask);
  a.o = const_cast<float*>(static_cast<const float*>(o));
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.dout = static_cast<const float*>(dout);
  a.dq = static_cast<float*>(dq);
  a.dkv = static_cast<float*>(dkv);
  a.dtable = static_cast<float*>(dtable);
  a.part_dq = static_cast<float*>(part_dq);
  a.part_de = static_cast<float*>(part_de);
  a.B = B; a.N = N; a.H = H; a.P = P; a.G = G;
  a.scale = scale;
  return D == 64 ? launch_bwd<64>(a, stream) : launch_bwd<32>(a, stream);
}
#else
// The Transformer-XL form: q holds q + u, table the heads' (H, 2P + 1, D) and
// beta their (H, 2P + 1) logit bias; otherwise as relpos_attn_fwd.
extern "C" int relpos_attn_xl_fwd(const void* q, const void* kv, const void* table,
                                  const void* beta, const void* mask, void* o, void* lse, int B,
                                  int N, int H, int D, int P, float scale, cudaStream_t stream) {
  if (!shape_ok(B, N, H, D, P)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = static_cast<const float*>(q);
  a.kv = static_cast<const float*>(kv);
  a.table = static_cast<const float*>(table);
  a.beta = static_cast<const float*>(beta);
  a.mask = static_cast<const uint8_t*>(mask);
  a.o = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
  a.B = B; a.N = N; a.H = H; a.P = P; a.G = 1;
  a.scale = scale;
  return D == 64 ? launch_fwd<64>(a, stream) : launch_fwd<32>(a, stream);
}

// The Transformer-XL backward: dtable (H, 2P + 1, D) and dbeta (H, 2P + 1)
// besides dq (of q + u) and dkv; one head a block (G = 1); part_de holds H·B ·
// ceil(N/64) · (NP + 63) · D floats and part_db H·B · ceil(N/64) · (NP + 63).
// Four launches on `stream`: the tiles, dQ's sum, dE's and dβ's sums.
extern "C" int relpos_attn_xl_bwd(const void* q, const void* kv, const void* table,
                                  const void* beta, const void* mask, const void* o,
                                  const void* lse, const void* dout, void* dq, void* dkv,
                                  void* dtable, void* dbeta, void* part_dq, void* part_de,
                                  void* part_db, int B, int N, int H, int D, int P, float scale,
                                  cudaStream_t stream) {
  if (!shape_ok(B, N, H, D, P)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = static_cast<const float*>(q);
  a.kv = static_cast<const float*>(kv);
  a.table = static_cast<const float*>(table);
  a.beta = static_cast<const float*>(beta);
  a.mask = static_cast<const uint8_t*>(mask);
  a.o = const_cast<float*>(static_cast<const float*>(o));
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.dout = static_cast<const float*>(dout);
  a.dq = static_cast<float*>(dq);
  a.dkv = static_cast<float*>(dkv);
  a.dtable = static_cast<float*>(dtable);
  a.dbeta = static_cast<float*>(dbeta);
  a.part_dq = static_cast<float*>(part_dq);
  a.part_de = static_cast<float*>(part_de);
  a.part_db = static_cast<float*>(part_db);
  a.B = B; a.N = N; a.H = H; a.P = P; a.G = 1;
  a.scale = scale;
  return D == 64 ? launch_bwd<64>(a, stream) : launch_bwd<32>(a, stream);
}
#endif
