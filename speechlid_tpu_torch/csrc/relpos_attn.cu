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
//   backward  one block per (utterance, group of G heads, 32 keys) walks
//             the queries 32 at a time: it recomputes S as the forward did
//             (the same function, so P = exp(S − lse) is the forward's), dP
//             = dO·vᵀ, D_i = dO_i · o_i and dS = P ⊙ (dP − D), zero on masked
//             pairs; dK and dV sum in registers, dE's 63 diagonals of the
//             tile go into the block's partial (rows i − j + j0 + 31), and
//             the tile's dQ (dS·k + the diagonals' dS·E) is written as one
//             partial a key tile.  dS is kept in shared memory also skewed
//             by diagonal (G[i][i − j + 31]), so the two products along the
//             diagonals are plain loops over rows.  Two small kernels then
//             sum dQ's partials over the key tiles and dE's over the blocks
//             (the clipped distances into E's edge rows), each in index
//             order.
//
// The mask decides what a tile computes: a tile where no valid row meets a
// valid key takes no logits (its padded rows only their uniform weights, its
// dS 0), and one that has no padded row either is skipped; what it leaves
// out is exact zeros.
//
// No atomics, and the order of every sum is fixed by the shape and the mask
// alone: the same bits on every run.  D (the head width) is 32 or 64; G (heads a
// backward block takes) comes from ops/cuda/relpos_attn_kernel.py.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

#if !defined(RPA_TILE)
#error "the tile size comes as a -D definition from ops/cuda/_build.py (TILING)"
#endif

constexpr int kT = RPA_TILE;       // queries and keys of a tile
static_assert(kT == 32, "the thread mapping is built for 32 × 32 tiles and 64 threads");
constexpr int kThreads = 64;       // 8 × 8: ty = tid / 8, tx = tid % 8
constexpr int kBand = 2 * kT;      // E rows of a tile's band: 63 used, row 63 zero
constexpr int kPS = kT + 4;        // row stride of the 32 × 32 P and dS tiles
constexpr int kGS = kBand + 4;     // row stride of the skewed dS (64 diagonals)
constexpr int kReduceThreads = 1024;
constexpr int kOut = 0, kDead = 1, kLive = 2;  // a frame past N, padded, valid

template <int D>
struct Cfg {
  static_assert(D == 32 || D == 64, "head widths 32 and 64");
  static constexpr int S = D + 4;     // row stride of the q, k, v, dO and E tiles
  static constexpr int CPT = D / 8;   // channels a thread owns of a (32 × D) tile
  static constexpr int EG = 512 / D;  // diagonals of a dE group: 8 or 16
  static constexpr int CPL = D / 32;  // channels a lane owns in dE
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
  float* part_dq;        // (n key tiles, B·H, NP, D)
  float* part_de;        // (B·H/G, n key tiles, NR, D)
  int B, N, H, P, G;
  float scale;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
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

// Rows [r0, r0 + 32) of a (·, D) matrix with row stride `ld` into a tile of
// stride D + 4 by cp.async, zeros at or past `limit`; the caller commits and
// waits (tile_ready) once for every tile of a step.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, size_t ld, int r0,
                                          int limit) {
  constexpr int V = D / 4;
  for (int idx = threadIdx.x; idx < kT * V; idx += kThreads) {
    const int r = idx / V, c = 4 * (idx % V);
    const bool in = r0 + r < limit;
    __pipeline_memcpy_async(dst + r * Cfg<D>::S + c, src + (size_t)(in ? r0 + r : 0) * ld + c,
                            16, in ? 0 : 16);
  }
}

// The band of E a tile reads: row e holds E[clip(diag0 + e, ±P) + P], diag0 =
// i0 − j0 − 31, for e < 63 (pair (i, j) reads row i − j + 31, tile-local);
// row 63 is zero.  By cp.async, as load_rows.
template <int D>
__device__ __forceinline__ void load_band(float* Es, const float* table, int P, int diag0) {
  constexpr int V = D / 4;
  for (int idx = threadIdx.x; idx < kBand * V; idx += kThreads) {
    const int e = idx / V, c = 4 * (idx % V);
    const bool in = e < kBand - 1;
    const int row = in ? min(max(diag0 + e, -P), P) + P : 0;
    __pipeline_memcpy_async(Es + e * Cfg<D>::S + c, table + (size_t)row * D + c, 16,
                            in ? 0 : 16);
  }
}

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
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, i0 = blockIdx.y * kT;
  const int N = a.N, HD = a.H * D, NP = gridDim.y * kT;
  const float* qb = a.q + (size_t)b * N * HD + h * D;
  const float* kb = a.kv + (size_t)b * N * 2 * HD + h * D;
  const uint8_t* mb = a.mask == nullptr ? nullptr : a.mask + (size_t)b * N;

  load_rows<D>(Qs, qb, HD, i0, N);  // s·q·(k + E): the scale goes on the dot
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
      load_rows<D>(Ks, kb, 2 * (size_t)HD, j0, N);
      load_band<D>(Es, a.table, a.P, i0 - j0 - (kT - 1));
    }
    load_rows<D>(Vs, kb + HD, 2 * (size_t)HD, j0, N);
    if (tid < kT) kst[tid] = ks;
    tile_ready();
    float s[4][4] = {};
    if (logits) pair_dots<D, true>(Qs, Ks, Es, ty, tx, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = logit(s[r][c] * a.scale, rst[r], kst[tx + 8 * c]);
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

// dV_j += Σ_i P_ij dO_i and, WITH_DK, dK_j += Σ_i dS_ij q_i (s goes on at the end):
// keys j = ty + 8r of the tile, the thread's channels.
template <int D, bool WITH_DK>
__device__ __forceinline__ void dkv_tile(const float* __restrict__ PT, const float* __restrict__ dST,
                                         const float* __restrict__ dOs,
                                         const float* __restrict__ Qs, int ty, int tx,
                                         float (&dv)[4][D / 8], float (&dk)[4][D / 8]) {
  constexpr int S = Cfg<D>::S, CPT = Cfg<D>::CPT;
#pragma unroll 2
  for (int i = 0; i < kT; i += 4) {
    float4 pt[4], gt[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pt[r] = ld4(PT + (ty + 8 * r) * kPS + i);
      if constexpr (WITH_DK) gt[r] = ld4(dST + (ty + 8 * r) * kPS + i);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      float g[CPT], x[CPT];
      load_chans<D>(dOs + (i + ii) * S, tx, g);
      if constexpr (WITH_DK) load_chans<D>(Qs + (i + ii) * S, tx, x);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < CPT; ++u) {
          dv[r][u] = fmaf(at(pt[r], ii), g[u], dv[r][u]);
          if constexpr (WITH_DK) dk[r][u] = fmaf(at(gt[r], ii), x[u], dk[r][u]);
        }
    }
  }
}

template <int D>
constexpr int bwd_smem_floats() {
  return 4 * kT * Cfg<D>::S + kBand * Cfg<D>::S + 2 * kT * kPS + kT * kGS;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 3) relpos_bwd_kernel(Args a) {
  constexpr int S = Cfg<D>::S, CPT = Cfg<D>::CPT, EG = Cfg<D>::EG, CPL = Cfg<D>::CPL;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kT * S;
  float* Qs = Vs + kT * S;
  float* dOs = Qs + kT * S;
  float* Es = dOs + kT * S;
  float* PT = Es + kBand * S;   // P[i][j] at PT[j][i]
  float* dST = PT + kT * kPS;   // dS[i][j] at dST[j][i]
  float* Gs = dST + kT * kPS;   // dS[i][j] at Gs[i][i − j + 31]
  __shared__ int kst[kT], rst[kT];
  __shared__ float lse_s[kT], dsum[kT];
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7, lane = tid & 31, warp = tid >> 5;
  const int hg = blockIdx.x, kt = blockIdx.y, nkt = gridDim.y, j0 = kt * kT;
  const int N = a.N, H = a.H, HD = H * D, G = a.G, HG = H / G;
  const int b = hg / HG, grp = hg % HG;
  const int nqt = (N + kT - 1) / kT, NP = nqt * kT, NR = NP + kT - 1;
  const uint8_t* mb = a.mask == nullptr ? nullptr : a.mask + (size_t)b * N;
  float* pde = a.part_de + ((size_t)hg * nkt + kt) * NR * D;

  // diagonals no pair of a tile reaches stay zero in every tile
  for (int idx = tid; idx < kT * kGS; idx += kThreads) Gs[idx] = 0.f;
  const int ks = tid < kT ? frame_state(mb, j0 + tid, N) : kOut;
  if (tid < kT) kst[tid] = ks;
  const int k_live = __syncthreads_or(ks == kLive);

  for (int hh = 0; hh < G; ++hh) {
    const int h = grp * G + hh, bh = b * H + h;
    const float* qb = a.q + (size_t)b * N * HD + h * D;
    const float* ob = a.o + (size_t)b * N * HD + h * D;
    const float* gb = a.dout + (size_t)b * N * HD + h * D;
    const float* kb = a.kv + (size_t)b * N * 2 * HD + h * D;
    __syncthreads();  // the last head's readers of Ks are done
    load_rows<D>(Ks, kb, 2 * (size_t)HD, j0, N);
    load_rows<D>(Vs, kb + HD, 2 * (size_t)HD, j0, N);
    tile_ready();
    float dk[4][CPT], dv[4][CPT];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < CPT; ++u) dk[r][u] = dv[r][u] = 0.f;

    for (int qt = 0; qt < nqt; ++qt) {
      const int i0 = qt * kT;
      const int rs = tid < kT ? frame_state(mb, i0 + tid, N) : kOut;
      // also: the last tile's readers are done
      const int q_live = __syncthreads_or(rs == kLive), q_dead = __syncthreads_or(rs == kDead);
      // dS is 0 unless a valid row meets a valid key; P is 0 unless it is
      // that, or a padded row (uniform over the N keys)
      const bool need_ds = q_live && k_live, need_p = need_ds || q_dead;
      if (need_p) {
        if (need_ds) {
          load_rows<D>(Qs, qb, HD, i0, N);
          load_band<D>(Es, a.table, a.P, i0 - j0 - (kT - 1));
        }
        load_rows<D>(dOs, gb, HD, i0, N);
        if (tid < kT) {
          rst[tid] = rs;
          lse_s[tid] = rs != kOut ? a.lse[(size_t)bh * NP + i0 + tid] : 0.f;
        }
        if (need_ds) {  // D_i = dO_i · o_i: two threads a row
          const int r = tid >> 1, c0 = (tid & 1) * (D / 2), i = i0 + r;
          float4 x[D / 8], g[D / 8];
#pragma unroll
          for (int c = 0; c < D / 8; ++c) {
            x[c] = g[c] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (i < N) {
              x[c] = ld4(ob + (size_t)i * HD + c0 + 4 * c);
              g[c] = ld4(gb + (size_t)i * HD + c0 + 4 * c);
            }
          }
          float d = 0.f;
#pragma unroll
          for (int c = 0; c < D / 8; ++c) {
            d = fmaf(g[c].x, x[c].x, d); d = fmaf(g[c].y, x[c].y, d);
            d = fmaf(g[c].z, x[c].z, d); d = fmaf(g[c].w, x[c].w, d);
          }
          d += __shfl_xor_sync(0xffffffffu, d, 1);
          if ((tid & 1) == 0) dsum[r] = d;
        }
        tile_ready();
        float s[4][4] = {}, dp[4][4] = {};
        if (need_ds) {
          pair_dots<D, true>(Qs, Ks, Es, ty, tx, s);
          pair_dots<D, false>(dOs, Vs, nullptr, ty, tx, dp);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int il = ty + 8 * r, jl = tx + 8 * c, rsi = rst[il], ksj = kst[jl];
            float p = 0.f, ds = 0.f;
            if (rsi != kOut && ksj != kOut) {
              p = expf(logit(s[r][c] * a.scale, rsi, ksj) - lse_s[il]);
              if (rsi == kLive && ksj == kLive) ds = p * (dp[r][c] - dsum[il]);
            }
            PT[jl * kPS + il] = p;
            if (need_ds) {
              dST[jl * kPS + il] = ds;
              Gs[il * kGS + il - jl + kT - 1] = ds;
            }
          }
        __syncthreads();
        // dV_j += Σ_i P_ij dO_i, dK_j += Σ_i dS_ij q_i, keys j = ty + 8r
        if (need_ds)
          dkv_tile<D, true>(PT, dST, dOs, Qs, ty, tx, dv, dk);
        else
          dkv_tile<D, false>(PT, dST, dOs, Qs, ty, tx, dv, dk);
      }
      // dE / s along the tile's diagonals e: Σ_i G[i][e] q_i, into the
      // block's partial row i0 + e; a warp takes every other group of EG
      // diagonals, a lane CPL channels.  The rows the last tile also reached
      // (e < 31) and the later heads of the group add to what is there; a
      // tile without dS writes zeros where it would write first.
      for (int g = warp; g < kBand / EG; g += 2) {
        const int e0 = g * EG;
        float acc[EG][CPL];
#pragma unroll
        for (int e = 0; e < EG; ++e) {
          // what the partial holds where this tile adds (read before the products)
          const int ee = e0 + e;
          const bool fresh = hh == 0 && (qt == 0 || ee >= kT - 1);
#pragma unroll
          for (int c = 0; c < CPL; ++c)
            acc[e][c] = ee < kBand - 1 && !fresh && need_ds
                            ? pde[(size_t)(i0 + ee) * D + lane * CPL + c] : 0.f;
        }
        if (need_ds) {
          const int ilo = max(0, e0 - (kT - 1)), ihi = min(kT - 1, e0 + EG - 1);
          for (int i = ilo; i <= ihi; ++i) {
            float gv[EG], x[CPL];
#pragma unroll
            for (int t = 0; t < EG; t += 4) {
              const float4 v = ld4(Gs + i * kGS + e0 + t);
              gv[t] = v.x; gv[t + 1] = v.y; gv[t + 2] = v.z; gv[t + 3] = v.w;
            }
#pragma unroll
            for (int c = 0; c < CPL; ++c) x[c] = Qs[i * S + lane * CPL + c];
#pragma unroll
            for (int e = 0; e < EG; ++e)
#pragma unroll
              for (int c = 0; c < CPL; ++c) acc[e][c] = fmaf(gv[e], x[c], acc[e][c]);
          }
        }
#pragma unroll
        for (int e = 0; e < EG; ++e) {
          const int ee = e0 + e;
          const bool fresh = hh == 0 && (qt == 0 || ee >= kT - 1);
          if (ee < kBand - 1 && (fresh || need_ds)) {
#pragma unroll
            for (int c = 0; c < CPL; ++c) pde[(size_t)(i0 + ee) * D + lane * CPL + c] = acc[e][c];
          }
        }
      }
      {  // dQ's partial of this key tile: s·(Σ_j dS_ij k_j + Σ_e G[i][e] E_e), rows 4ty + r
        float acc[4][CPT];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int u = 0; u < CPT; ++u) acc[r][u] = 0.f;
        if (need_ds) {
#pragma unroll 4
          for (int j = 0; j < kT; ++j) {
            const float4 g = ld4(dST + j * kPS + 4 * ty);
            float x[CPT];
            load_chans<D>(Ks + j * S, tx, x);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int u = 0; u < CPT; ++u) acc[r][u] = fmaf(at(g, r), x[u], acc[r][u]);
          }
          // a warp's rows 16w … 16w + 15 reach the diagonals 16w … 16w + 46
          const int elo = 16 * warp;
#pragma unroll 2
          for (int e = elo; e < elo + 48; e += 4) {
            float4 g[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) g[r] = ld4(Gs + (4 * ty + r) * kGS + e);
#pragma unroll
            for (int ee = 0; ee < 4; ++ee) {
              float x[CPT];
              load_chans<D>(Es + (e + ee) * S, tx, x);
#pragma unroll
              for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int u = 0; u < CPT; ++u) acc[r][u] = fmaf(at(g[r], ee), x[u], acc[r][u]);
            }
          }
        }
        float* dst = a.part_dq + (((size_t)kt * a.B * H + bh) * NP + i0 + 4 * ty) * D;
#pragma unroll
        for (int r = 0; r < 4; ++r) store_chans<D>(dst + r * D, tx, acc[r], a.scale);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + ty + 8 * r;
      if (j < N) {
        float* row = a.dkv + (size_t)(b * N + j) * 2 * HD + h * D;
        store_chans<D>(row, tx, dk[r], a.scale);
        store_chans<D>(row + HD, tx, dv[r], 1.f);
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

// dE row R of the table: s times every block's partial rows ρ whose
// distance r = ρ − j0 − 31 clips to R − P, the blocks dealt to
// kReduceThreads / D parts, each part's sum in block and row order, the
// parts added in order.
template <int D>
__global__ void __launch_bounds__(kReduceThreads) relpos_de_reduce_kernel(
    const float* __restrict__ part, float* __restrict__ dtable, int nblk, int nkt, int NR, int P,
    float scale) {
  constexpr int kParts = kReduceThreads / D;
  __shared__ float sums[kReduceThreads];
  const int R = blockIdx.x, t = threadIdx.x, c = t % D;
  float s = 0.f;
  for (int blk = t / D; blk < nblk; blk += kParts) {
    const int j0 = (blk % nkt) * kT;
    const int lo = R == 0 ? 0 : max(0, R - P + j0 + kT - 1);
    const int hi = R == 2 * P ? NR - 1 : min(NR - 1, R - P + j0 + kT - 1);
    const float* pb = part + (size_t)blk * NR * D + c;
    for (int rho = lo; rho <= hi; ++rho) s += pb[(size_t)rho * D];
  }
  sums[t] = s;
  __syncthreads();
  if (t < D) {
    float total = sums[t];
    for (int p = 1; p < kParts; ++p) total += sums[p * D + t];
    dtable[(size_t)R * D + t] = total * scale;
  }
}

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
  const int nkt = (a.N + kT - 1) / kT, NP = nkt * kT, NR = NP + kT - 1;
  const size_t smem = bwd_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(relpos_bwd_kernel<D>),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nhg = a.B * (a.H / a.G);
  relpos_bwd_kernel<D><<<dim3(nhg, nkt), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = (size_t)a.B * a.N * a.H * D;
  const size_t want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  relpos_dq_reduce_kernel<D><<<blocks, 256, 0, stream>>>(a.part_dq, a.dq, a.B, a.N, a.H, NP, nkt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  relpos_de_reduce_kernel<D><<<2 * a.P + 1, kReduceThreads, 0, stream>>>(
      a.part_de, a.dtable, nhg * nkt, nkt, NR, a.P, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
// gradient dout (B, N, H·D); part_dq holds ceil(N/32) · B·H · NP · D floats
// and part_de B·(H/G) · ceil(N/32) · (NP + 31) · D, NP = ceil(N/32)·32; G
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
