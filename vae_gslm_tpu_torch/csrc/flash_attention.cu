// K3 / K3b / K4 / K4b / K5 / K5b: length-masked ALiBi attention, forward
// and backward, for sm_90a.
//
// Replaces the Pallas kernels of vae_gslm_tpu/ops/flash_attention.py:
//   K3  _flash_forward_full_packed (:230, body _fwd_full_packed_kernel :189)
//   K3b _flash_backward_packed     (:359, body _bwd_full_packed_kernel :272)
//   K4  _flash_forward_full        (:406, body _fwd_full_kernel :111)
//   K4b _flash_backward            (:735, body _flash_bwd_kernel :481)
//   K5  _flash_forward             (:443, body _flash_kernel :69)
//   K5b _flash_backward_blockwise  (:682, body
//       _flash_bwd_blockwise_kernel :609)
// K3/K3b take causal self-attention over the packed (B, T, H*D)
// projection layout, T <= 1024.  K4 (Tq = Tk <= 1024, optional lse) and
// K5 (any Tq, Tk up to 8192, no lse) are the (B, H, T, D) forwards that
// JAX runs off the packed envelope and under a data-parallel mesh; K4b
// (Tq = Tk <= 1024, lse from K4) and K5b (any Tq, Tk up to 8192, its own
// row statistics) are the backwards of that (B, H, T, D) custom VJP.  The
// three forwards share a tiled float32 body and K5's bfloat16 body; K3
// and K4 in bfloat16 have a Hopper body of their own (wgmma, TMA); the
// three backwards share another in float32 and K3b's in bfloat16, and
// K4b and K5b in bfloat16 have a Hopper body of their own (bwd_wgmma).
// Each has an entry point and kernel symbols of its own
// (k3_/k4_/k5_fwd*, k3b_/k4b_/k5b_{dkv,dq}*, k5b_stats*), so a profile
// tells them apart.  Every operand is read
// through (batch, head, row) element strides with a contiguous feature
// axis (the bf16 forward builds TMA tensor maps from them), so packed
// projection views and (B, H, T, D) tensors both go in without a copy.
// The query and key positions both count from 0 (the ALiBi distance and
// the causal test of _flash_kernel :90-99 for Tq != Tk).
//
// Numerics (the plain versions in ops/flash_attention.py):
//   s   = (q . k) * scale + slope * |k - q|, masked to -1e30 where the key
//         is at or past lengths[b] or (causal) after the query;
//   fwd: m = max s, l = sum exp(s - m), p = exp(s - m) / l rounded to V's
//        dtype, o = p . v (float32 sums) in q's dtype, lse = m + log l;
//   bwd: p = exp(s - lse) (K3b, K4b) or exp(s - m) / l (K5b, exact rows as
//        _flash_bwd_blockwise_kernel :648-650), dp = dO . v,
//        ds = p (dp - delta) rounded to q's dtype, dq = (ds . k) * scale,
//        dv = round(p)^T . dO, dk = (ds^T . q) * scale, with
//        delta = rowsum(dO * O) given.  dk and dv are summed in float32
//        over every query tile and rounded once.
// All arithmetic is float32; elements are float32 or bfloat16.  A row of
// length 0 sees every key at -1e30: K4's lse is then -1e30 + log Tk, which
// is -1e30 in float32, so K3b/K4b's p is 1 on every key (JAX's kernels do
// the same); K5b keeps m and l apart and gets 1 / Tk.
//
// Design.  The TPU kernels keep a whole (T, T) float32 tile per
// (batch, head) in VMEM; at T = 640 that is 1.6 MB against the 227 KB of
// shared memory an H100 block can use, so these kernels are tiled 64 x 64.
//   * forward: one block per (64-query tile, head, batch).  Pass 1 walks
//     the key tiles for the row max and sum (online); pass 2 recomputes
//     the logits, forms the normalized, rounded p and accumulates p . v.
//     The probabilities are normalized before P.V, as the TPU kernel does.
//   * backward: two launches and no atomics, so runs agree bit for bit:
//     one block per key tile walks the query tiles for dk and dv, one per
//     query tile walks the key tiles for dq.  K5b, which gets no lse,
//     runs a third launch before them in float32, the forward's pass 1
//     alone, that writes each row's m and l (in bfloat16 the dq kernel's
//     first pass); whether a body reads l is a template parameter, so
//     K3b and K4b compile without it.  The TPU's q-tile
//     grid that carries dk/dv across sequential steps (K5b) becomes the
//     key-tile block's own loop over the query tiles.
// Key tiles past the causal edge or at or past lengths[b] add exact zeros
// and are skipped, but only when lengths[b] >= 1: a row of length 0 is
// uniform over all Tk keys, as in the reference.
//
// Two element types, two product routes.  bfloat16 (the training path
// under 16-mixed) multiplies on the tensor cores: K3/K4's forward and
// K4b/K5b's backward with wgmma (below), K5 and K3b with mma.sync
// (m16n8k16); exact bf16 products, float32 sums in the hardware's order.
// float32 multiplies with scalar FMAs out of shared memory (4 x 4
// outputs per thread, float4 operand loads), since the tensor cores
// would round its operands to TF32.
//
// K3/K4 bfloat16 forward (fwd_wgmma).  JAX normalises p = exp(s - m) / l
// before P.V, so m and l are final before any p is formed: two passes
// over the key tiles.  Tq = Tk <= 1024 here, so a head's key tiles
// (<= 16 x 8 KB) stay in shared memory for both passes and only V
// streams in pass 2.  One block per (64-query tile, head, batch), the
// longest causal tiles first: a producer warp issues TMA loads (128B
// swizzle, zero fill past T, tensor maps built from the operands'
// strides) of Q, every key tile (one mbarrier each) and V through a
// ring of `stages` tiles (full/empty mbarriers); one consumer warpgroup
// forms S = Q K^T with wgmma m64n64k16 (both operands K-major from
// shared memory) and O += P V with P's bf16 A fragments in registers
// and V MN-major (the transpose bit).  The tensor cores run the next
// tile's Q K^T (pass 1) or this tile's P V (pass 2) while the warps take
// a softmax.  Tiles wholly inside the length and causal edges take the
// ALiBi bias alone; edge tiles also mask.  The
// plan of the dynamic shared memory (resident key tiles, V stages,
// bytes) comes from the wrapper (fwd_smem_plan in ops/flash_attention.py)
// and is checked here.  Numerics against the plain version: the logit is
// fmaf(dot, scale, slope * |k - q|), which equals the rounded product
// plus the rounded bias since scale = 1/8 is a power of two at head_dim
// 64; exponentials are ex2.approx of (x - m) * log2(e); p is exp(.)
// times the row's 1/l, not a division: within 1.5 float32 ulps of the
// quotient, so a bf16 p differs only where the quotient lies that close
// to a rounding edge.
//
// What bounds it: at the training shapes (B 8, T 640, H 16, D 64, the
// lengths of chip_smoke.py) the ~34 / ~66 MB the forward / backward
// must move over HBM bandwidth (10 / 20 us on an H100 SXM) bound it more
// than their causal, length-masked products (4.7 / 11.8 GFLOP at the
// bf16 peak).  K3/K4's bf16 forward recomputes S in pass 2 and takes
// two exponentials per element of every walked 64 x 64 tile (5,072 tiles
// at the training call: ~42 M, ~10 us at 16 per clock per SM on 132 SMs
// at 1.98 GHz), plus ~14 other instructions per element (logit, mask,
// max, sums, scaling, packing), so the per-element work and its
// latency, with two consumer warpgroups per SM, not the bytes, hold it
// (~4x its bytes bound).  K5 at the scoring shapes (B 8, T 1750, float32) is
// bound by its products: ~50 GFLOP of causal pairs at the 67 TFLOP/s
// float32 rate of the FMA units (~0.75 ms) against ~0.2 GB of HBM
// traffic (~0.07 ms).
// The mma.sync kernels (K5 bf16, K3b) run far from that bound:
// fragments are loaded from shared memory by plain loads (no ldmatrix,
// no TMA, no pipelining of the next tile's loads), K5 reads every key
// tile twice, and K3b's two launches recompute every (query, key) pair.
//
// K4b/K5b bfloat16 backward (bwd_wgmma).  Two launches, no atomics, so
// the outputs are the same bits from run to run: the dq kernel, one
// block per (64-query tile, head, batch), the longest causal walks
// first, then the dk/dv kernel, one block per (64-key tile, head,
// batch), the same.  Each block keeps two tiles (Q and dO, or K and V)
// and a producer warp streams the walk's other two through a ring by
// TMA (tensor maps from the strides, zero fill past Tq or Tk; the
// dk/dv walk's float32 query rows of lse or m, l, 1/l and delta by
// plain loads, 0, 1, 1 and 0 past Tq).  One consumer warpgroup forms both
// logit-side products from shared memory with wgmma (S = Q K^T and
// dP = dO V^T, or S^T = K Q^T and dP^T = V dO^T, all K-major), p and ds
// in registers, and the gradient products with the bf16 A fragments in
// registers: dQ += dS K, dV += P^T dO, dK += dS^T Q, with K, dO and Q
// read MN-major through the transpose bit, so no tile is ever copied
// transposed.  K5b's row statistics are the dq kernel's pass 1 (online
// m and l over the key tiles, which stream twice: Tk up to 8192 does not
// stay resident); it writes m and l for the dk/dv kernel and keeps them
// in registers.  p = ex2((x - lse) log2(e)) in K4b, as the forward; in
// K5b expf(x - m) / l, the quotient correctly rounded (its product by
// 1/l and one FMA correction), as JAX's kernel divides: with rows of up
// to 8192 keys, a few ulps more in p (ex2.approx, or the product alone)
// flip enough of ds's bf16 roundings against the plain version's to
// fail the element-wise gate at Tk 8192 (bwd_prob); ds = p (dp - delta)
// rounded to bf16, the 1/sqrt(D) scale on dq and dk.  Interior tiles
// skip the length and causal tests.  The wrapper's bwd_smem_plan sizes
// the shared memory (the same for both kernels and every T), which the
// launcher checks.
// Per (query, key) pair it runs the five products the backward needs
// (K5b: six, its statistics recompute Q K^T), where K3b's mma.sync body
// runs seven.
//
// Each launch function returns cudaGetLastError() after its launches.

#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;          // head_dim (the wrapper checks)
constexpr int TILE = 64;        // query and key rows per tile
constexpr int NT = 256;         // threads per block: 16 x 16, 4 x 4 each
constexpr int LD = TILE + 4;    // padded row of a transposed (d-major) tile
constexpr float NEG_INF = -1e30f;

constexpr int TT = HD * LD;     // floats in a transposed tile
constexpr int TR = TILE * HD;   // floats in a row-major tile
constexpr int FWD_SMEM = (3 * TT + TR) * 4;
constexpr int STATS_SMEM = 2 * TT * 4;
constexpr int DKV_SMEM = (6 * TT + 2 * TR) * 4;
constexpr int DQ_SMEM = (5 * TT + TR) * 4;

struct Seq {             // one operand's element strides: batch, head and
  long long bs, hs, rs;  // row; the feature axis is contiguous
};

// Rows [r0, r0 + 64) of head h of one batch row into shared memory,
// d-major (dst[d * LD + r]) or row-major (dst[r * HD + d]); rows at or
// past T read as 0.
__device__ void load_t(float* dst, const float* src, long long rs, int r0,
                       int t_len) {
  for (int idx = threadIdx.x; idx < TILE * HD; idx += NT) {
    int r = idx / HD, d = idx % HD, t = r0 + r;
    dst[d * LD + r] = t < t_len ? src[t * rs + d] : 0.f;
  }
}
__device__ void load_r(float* dst, const float* src, long long rs, int r0,
                       int t_len) {
  for (int idx = threadIdx.x; idx < TILE * HD; idx += NT) {
    int r = idx / HD, d = idx % HD, t = r0 + r;
    dst[r * HD + d] = t < t_len ? src[t * rs + d] : 0.f;
  }
}

// acc[i][j] += sum_k X[k][ty*4 + i] * Y[k][tx*4 + j] over 64 k.
__device__ __forceinline__ void outer(const float* X, int ldx,
                                      const float* Y, int ldy,
                                      float acc[4][4], int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < TILE; ++k) {
    float4 a = *reinterpret_cast<const float4*>(X + k * ldx + ty * 4);
    float4 b = *reinterpret_cast<const float4*>(Y + k * ldy + tx * 4);
    float av[4] = {a.x, a.y, a.z, a.w};
    float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float a[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

// Scaled, ALiBi-biased, masked logit of query row r and key c.
__device__ __forceinline__ float logit(float dot, int r, int c, int len,
                                       int causal, int use_alibi,
                                       float slope, float scale) {
  float x = __fmul_rn(dot, scale);
  if (use_alibi) x = __fadd_rn(x, __fmul_rn(slope, (float)abs(c - r)));
  bool valid = c < len && (!causal || c <= r);
  return valid ? x : NEG_INF;
}

// The backward's probability of a logit x from its row's statistics:
// exp(x - lse) (a is lse, l unused) or, with HAVE_L, exp(x - m) / l (a
// is m).
template <bool HAVE_L>
__device__ __forceinline__ float prob(float x, float a, float l) {
  return HAVE_L ? __fdiv_rn(expf(x - a), l) : expf(x - a);
}

// Reductions over the 16 threads (tx) that share a row: lanes 0-15 or
// 16-31 of a warp.  The butterfly gives every lane the same value.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Key tiles [0, end) that can hold a nonzero probability for query tile
// qt over tk keys: all of them for a row set of length 0.
__device__ __forceinline__ int key_tiles(int qt, int len, int tk,
                                         int causal) {
  int end = (tk + TILE - 1) / TILE;
  if (len >= 1) {
    end = min(end, (len + TILE - 1) / TILE);
    if (causal) end = min(end, qt + 1);
  }
  return end;
}

// Pass 1 of the float32 forward: the row max m and the sum l of
// exp(s - m) of the thread's four query rows of the tile at q0, online
// over the key tiles [0, kt_end).  Qt holds the query tile; Kt is
// scratch.
__device__ __forceinline__ void pass1_f32(const float* Qt, float* Kt,
                                          const float* kb, long long k_rs,
                                          int q0, int kt_end, int tk,
                                          int len, int causal,
                                          int use_alibi, float slope,
                                          float scale, float m[4],
                                          float l[4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_t(Kt, kb, k_rs, k0, tk);
    __syncthreads();
    zero(s);
    outer(Qt, LD, Kt, LD, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx * 4 + j;
        s[i][j] = c < tk ? logit(s[i][j], r, c, len, causal, use_alibi,
                                 slope, scale)
                         : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(tmax));
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) e += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum(e);
      m[i] = m_new;
    }
  }
}

// The float32 forward of one (64-query tile, head, batch): tq queries
// against tk keys; lse (B, H, tq) is written unless it is null.
__device__ __forceinline__ void fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, const int* __restrict__ lengths,
    const float* __restrict__ slopes, Seq sq, Seq sk, Seq sv, Seq so,
    int tq, int tk, int nheads, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Kt = Qt + TT;
  float* Pt = Kt + TT;
  float* Vs = Pt + TT;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * TILE, ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int len = lengths[b];
  const int use_alibi = slopes != nullptr;
  const float slope = use_alibi ? slopes[h] : 0.f;
  const float* qb = q + b * sq.bs + h * sq.hs;
  const float* kb = k + b * sk.bs + h * sk.hs;
  const float* vb = v + b * sv.bs + h * sv.hs;
  const int kt_end = key_tiles(qt, len, tk, causal);

  load_t(Qt, qb, sq.rs, q0, tq);
  float m[4], l[4], s[4][4];
  pass1_f32(Qt, Kt, kb, sk.rs, q0, kt_end, tk, len, causal, use_alibi,
            slope, scale, m, l);

  // pass 2: normalized probabilities times V
  float acc[4][4];
  zero(acc);
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_t(Kt, kb, sk.rs, k0, tk);
    load_r(Vs, vb, sv.rs, k0, tk);
    __syncthreads();
    zero(s);
    outer(Qt, LD, Kt, LD, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx * 4 + j;
        float p = 0.f;
        if (c < tk) {
          const float x = logit(s[i][j], r, c, len, causal, use_alibi,
                                slope, scale);
          p = __fdiv_rn(expf(x - m[i]), l[i]);
        }
        Pt[(tx * 4 + j) * LD + ty * 4 + i] = p;
      }
    }
    __syncthreads();
    outer(Pt, LD, Vs, HD, acc, ty, tx);
  }

  float* ob = o + b * so.bs + h * so.hs;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= tq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) ob[r * so.rs + tx * 4 + j] = acc[i][j];
    if (lse && tx == 0)
      lse[((long long)b * nheads + h) * tq + r] = m[i] + logf(l[i]);
  }
}

#define FWD_F32_ARGS                                                      \
  const float *__restrict__ q, const float *__restrict__ k,               \
      const float *__restrict__ v, float *__restrict__ o,                 \
      float *__restrict__ lse, const int *__restrict__ lengths,           \
      const float *__restrict__ slopes, Seq sq, Seq sk, Seq sv, Seq so,   \
      int tq, int tk, int nheads, int causal, float scale
#define FWD_PASS q, k, v, o, lse, lengths, slopes, sq, sk, sv, so, tq, tk, \
                 nheads, causal, scale

// One symbol per TPU kernel replaced (K3 packed, K4 full, K5 q-tiled).
__global__ void __launch_bounds__(NT) k3_fwd_kernel(FWD_F32_ARGS) {
  fwd_f32(FWD_PASS);
}
__global__ void __launch_bounds__(NT) k4_fwd_kernel(FWD_F32_ARGS) {
  fwd_f32(FWD_PASS);
}
__global__ void __launch_bounds__(NT) k5_fwd_kernel(FWD_F32_ARGS) {
  fwd_f32(FWD_PASS);
}

// K5b's row statistics of one (64-query tile, head, batch): pass 1 of
// the forward alone, m into m_out and l into l_out, each (B, H, tq).
__device__ __forceinline__ void stats_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const int* __restrict__ lengths, const float* __restrict__ slopes,
    float* __restrict__ m_out, float* __restrict__ l_out, Seq sq, Seq sk,
    int tq, int tk, int nheads, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Kt = Qt + TT;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * TILE, ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int len = lengths[b];
  const int use_alibi = slopes != nullptr;
  const float slope = use_alibi ? slopes[h] : 0.f;
  load_t(Qt, q + b * sq.bs + h * sq.hs, sq.rs, q0, tq);
  float m[4], l[4];
  pass1_f32(Qt, Kt, k + b * sk.bs + h * sk.hs, sk.rs, q0,
            key_tiles(qt, len, tk, causal), tk, len, causal, use_alibi,
            slope, scale, m, l);
  if (tx != 0) return;
  const long long base = ((long long)b * nheads + h) * tq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= tq) continue;
    m_out[base + r] = m[i];
    l_out[base + r] = l[i];
  }
}

#define STATS_F32_ARGS                                                    \
  const float *__restrict__ q, const float *__restrict__ k,               \
      const int *__restrict__ lengths, const float *__restrict__ slopes,  \
      float *__restrict__ m_out, float *__restrict__ l_out, Seq sq,       \
      Seq sk, int tq, int tk, int nheads, int causal, float scale
#define STATS_PASS q, k, lengths, slopes, m_out, l_out, sq, sk, tq, tk, \
                   nheads, causal, scale

__global__ void __launch_bounds__(NT) k5b_stats_kernel(STATS_F32_ARGS) {
  stats_f32(STATS_PASS);
}

// p and ds of one (query tile, key tile) pair from the logits s and
// dp = dO . v; zero for rows at or past tq and keys at or past tk.
template <bool HAVE_L>
__device__ __forceinline__ void probs(float s[4][4], float dp[4][4],
                                      const float a_r[4], const float l_r[4],
                                      const float delta_r[4],
                                      int q0, int k0, int tq, int tk,
                                      int len, int causal, int use_alibi,
                                      float slope, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + (threadIdx.x >> 4) * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + (threadIdx.x & 15) * 4 + j;
      float p = 0.f, ds = 0.f;
      if (r < tq && c < tk) {
        const float x = logit(s[i][j], r, c, len, causal, use_alibi, slope,
                              scale);
        p = prob<HAVE_L>(x, a_r[i], l_r[i]);
        ds = __fmul_rn(p, __fsub_rn(dp[i][j], delta_r[i]));
      }
      s[i][j] = p;       // s now holds p, dp holds ds
      dp[i][j] = ds;
    }
  }
}

// The statistics (lse, or m and l) and delta of the thread's four query
// rows.
template <bool HAVE_L>
__device__ __forceinline__ void row_stats(float a_r[4], float l_r[4],
                                          float delta_r[4], const float* ab,
                                          const float* lb, const float* db,
                                          int q0, int tq) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + (threadIdx.x >> 4) * 4 + i;
    a_r[i] = r < tq ? ab[r] : 0.f;
    l_r[i] = HAVE_L && r < tq ? lb[r] : 1.f;
    delta_r[i] = r < tq ? db[r] : 0.f;
  }
}

#define BWD_F32_COMMON                                                    \
  const float *__restrict__ q, const float *__restrict__ k,               \
      const float *__restrict__ v, const float *__restrict__ g,           \
      const float *__restrict__ rowa, const float *__restrict__ rowl,     \
      const float *__restrict__ delta, const int *__restrict__ lengths,   \
      const float *__restrict__ slopes
#define DKV_F32_ARGS                                                      \
  BWD_F32_COMMON, float *__restrict__ dk, float *__restrict__ dv, Seq sq, \
      Seq sk, Seq sv, Seq sg, Seq sdk, Seq sdv, int tq, int tk,           \
      int nheads, int causal, float scale
#define DKV_PASS q, k, v, g, rowa, rowl, delta, lengths, slopes, dk, dv, sq, \
                 sk, sv, sg, sdk, sdv, tq, tk, nheads, causal, scale
#define DQ_F32_ARGS                                                       \
  BWD_F32_COMMON, float *__restrict__ dq, Seq sq, Seq sk, Seq sv, Seq sg, \
      Seq sdq, int tq, int tk, int nheads, int causal, float scale
#define DQ_PASS q, k, v, g, rowa, rowl, delta, lengths, slopes, dq, sq, sk, \
                sv, sg, sdq, tq, tk, nheads, causal, scale

// dk, dv of one key tile, walking the query tiles that see it; with
// HAVE_L p = exp(s - m) / l from rowa = m and rowl = l, else exp(s - lse)
// from rowa = lse.
template <bool HAVE_L>
__device__ __forceinline__ void dkv_f32(DKV_F32_ARGS) {
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);
  float* Vt = Kt + TT;
  float* Qt = Vt + TT;
  float* Gt = Qt + TT;
  float* Ps = Gt + TT;     // p  [r][c]
  float* Ss = Ps + TT;     // ds [r][c]
  float* Qs = Ss + TT;
  float* Gs = Qs + TR;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * TILE, ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int len = lengths[b];
  const int use_alibi = slopes != nullptr;
  const float slope = use_alibi ? slopes[h] : 0.f;
  const float* qb = q + b * sq.bs + h * sq.hs;
  const float* gb = g + b * sg.bs + h * sg.hs;
  const long long bh = (long long)b * nheads + h;
  const float* ab = rowa + bh * tq;
  const float* lb = HAVE_L ? rowl + bh * tq : nullptr;
  const float* db = delta + bh * tq;
  const int nq = (tq + TILE - 1) / TILE;
  int qt_begin = 0;
  if (len >= 1) {
    if (k0 >= len) qt_begin = nq;          // every p of this tile is 0
    else if (causal) qt_begin = kt;
  }
  float acc_k[4][4], acc_v[4][4], s[4][4], dp[4][4];
  float a_r[4], l_r[4], delta_r[4];
  zero(acc_k);
  zero(acc_v);
  if (qt_begin < nq) {
    load_t(Kt, k + b * sk.bs + h * sk.hs, sk.rs, k0, tk);
    load_t(Vt, v + b * sv.bs + h * sv.hs, sv.rs, k0, tk);
  }
  for (int qt = qt_begin; qt < nq; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();
    load_t(Qt, qb, sq.rs, q0, tq);
    load_r(Qs, qb, sq.rs, q0, tq);
    load_t(Gt, gb, sg.rs, q0, tq);
    load_r(Gs, gb, sg.rs, q0, tq);
    __syncthreads();
    zero(s);
    zero(dp);
    outer(Qt, LD, Kt, LD, s, ty, tx);
    outer(Gt, LD, Vt, LD, dp, ty, tx);
    row_stats<HAVE_L>(a_r, l_r, delta_r, ab, lb, db, q0, tq);
    probs<HAVE_L>(s, dp, a_r, l_r, delta_r, q0, k0, tq, tk, len, causal,
                  use_alibi, slope, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[(ty * 4 + i) * LD + tx * 4 + j] = s[i][j];
        Ss[(ty * 4 + i) * LD + tx * 4 + j] = dp[i][j];
      }
    __syncthreads();
    outer(Ps, LD, Gs, HD, acc_v, ty, tx);   // rows: keys ty*4+i
    outer(Ss, LD, Qs, HD, acc_k, ty, tx);
  }
  float* dkb = dk + b * sdk.bs + h * sdk.hs;
  float* dvb = dv + b * sdv.bs + h * sdv.hs;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty * 4 + i;
    if (c >= tk) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dkb[c * sdk.rs + tx * 4 + j] = __fmul_rn(acc_k[i][j], scale);
      dvb[c * sdv.rs + tx * 4 + j] = acc_v[i][j];
    }
  }
}

// dq of one query tile, walking the key tiles it sees (HAVE_L as in
// dkv_f32).
template <bool HAVE_L>
__device__ __forceinline__ void dq_f32(DQ_F32_ARGS) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Gt = Qt + TT;
  float* Kt = Gt + TT;
  float* Vt = Kt + TT;
  float* St = Vt + TT;     // ds [c][r]
  float* Ks = St + TT;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * TILE, ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int len = lengths[b];
  const int use_alibi = slopes != nullptr;
  const float slope = use_alibi ? slopes[h] : 0.f;
  const float* qb = q + b * sq.bs + h * sq.hs;
  const float* kb = k + b * sk.bs + h * sk.hs;
  const float* vb = v + b * sv.bs + h * sv.hs;
  const long long bh = (long long)b * nheads + h;
  const int kt_end = key_tiles(qt, len, tk, causal);
  float acc[4][4], s[4][4], dp[4][4], a_r[4], l_r[4], delta_r[4];
  zero(acc);
  load_t(Qt, qb, sq.rs, q0, tq);
  load_t(Gt, g + b * sg.bs + h * sg.hs, sg.rs, q0, tq);
  row_stats<HAVE_L>(a_r, l_r, delta_r, rowa + bh * tq,
                    HAVE_L ? rowl + bh * tq : nullptr, delta + bh * tq, q0,
                    tq);
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_t(Kt, kb, sk.rs, k0, tk);
    load_t(Vt, vb, sv.rs, k0, tk);
    load_r(Ks, kb, sk.rs, k0, tk);
    __syncthreads();
    zero(s);
    zero(dp);
    outer(Qt, LD, Kt, LD, s, ty, tx);
    outer(Gt, LD, Vt, LD, dp, ty, tx);
    probs<HAVE_L>(s, dp, a_r, l_r, delta_r, q0, k0, tq, tk, len, causal,
                  use_alibi, slope, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) St[(tx * 4 + j) * LD + ty * 4 + i] = dp[i][j];
    __syncthreads();
    outer(St, LD, Ks, HD, acc, ty, tx);
  }
  float* dqb = dq + b * sdq.bs + h * sdq.hs;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= tq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dqb[r * sdq.rs + tx * 4 + j] = __fmul_rn(acc[i][j], scale);
  }
}

// One symbol per TPU kernel replaced (K3b packed, K4b full: from lse;
// K5b blockwise: from m and l).
__global__ void __launch_bounds__(NT) k3b_dkv_kernel(DKV_F32_ARGS) {
  dkv_f32<false>(DKV_PASS);
}
__global__ void __launch_bounds__(NT) k4b_dkv_kernel(DKV_F32_ARGS) {
  dkv_f32<false>(DKV_PASS);
}
__global__ void __launch_bounds__(NT) k5b_dkv_kernel(DKV_F32_ARGS) {
  dkv_f32<true>(DKV_PASS);
}
__global__ void __launch_bounds__(NT) k3b_dq_kernel(DQ_F32_ARGS) {
  dq_f32<false>(DQ_PASS);
}
__global__ void __launch_bounds__(NT) k4b_dq_kernel(DQ_F32_ARGS) {
  dq_f32<false>(DQ_PASS);
}
__global__ void __launch_bounds__(NT) k5b_dq_kernel(DQ_F32_ARGS) {
  dq_f32<true>(DQ_PASS);
}

// ------------------------------------------------------------------
// bfloat16: the same math with the products on the tensor cores
// (mma.sync m16n8k16, bf16 x bf16 -> float32).  Four warps per block,
// each owning 16 rows of the 64-row tile; a product's accumulator
// fragment is reused, rounded to bf16, as the next product's A operand
// (p before P.V, p and ds in the backward): exactly the roundings of the
// plain version.  Tiles sit in shared memory as bf16, row-major or
// transposed as each product's B operand needs (pitch 72: conflict-free
// fragment loads).
// ------------------------------------------------------------------
typedef __nv_bfloat16 bf16;
constexpr int MW = 4;                   // warps per block
constexpr int MT = MW * 32;             // threads per block
constexpr int LH = HD + 8;              // bf16 pitch of a shared tile
constexpr int SH = TILE * LH;           // bf16 elements per shared tile
constexpr int FWD_MMA_SMEM = 3 * SH * 2;
constexpr int DKV_MMA_SMEM = 4 * SH * 2 + 2 * TILE * 4;
constexpr int DQ_MMA_SMEM = 3 * SH * 2;

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [r0, r0 + 64) of one head into shared bf16, row-major (dst[r][d])
// and/or transposed (dst_t[d][r]); rows at or past T read as 0.  Global
// rows are read 16 bytes at a time (the wrapper checks the alignment).
__device__ void load_bf16(bf16* dst, bf16* dst_t, const bf16* src,
                          long long rs, int r0, int t_len) {
  for (int idx = threadIdx.x; idx < TILE * HD / 8; idx += MT) {
    const int r = idx / (HD / 8), d = idx % (HD / 8) * 8, t = r0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t < t_len) v = *reinterpret_cast<const uint4*>(src + t * rs + d);
    if (dst) *reinterpret_cast<uint4*>(dst + r * LH + d) = v;
    if (dst_t) {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) dst_t[(d + i) * LH + r] = e[i];
    }
  }
}

// A fragments (16 rows x 64) of rows [row0, row0 + 16) of a row-major
// shared tile: a[k-step][4].
__device__ __forceinline__ void a_frags(uint32_t a[4][4], const bf16* s,
                                        int row0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const bf16* p = s + (row0 + g) * LH + ks * 16 + 2 * t;
    a[ks][0] = ld32(p);
    a[ks][1] = ld32(p + 8 * LH);
    a[ks][2] = ld32(p + 8);
    a[ks][3] = ld32(p + 8 * LH + 8);
  }
}

// acc[nt] (16 x 8 each, 8 tiles) += A (16 x 64) . B, where B[k][n] is
// read from a shared tile stored n-major: bt[n * LH + k].
__device__ __forceinline__ void mma_rows(float acc[8][4],
                                         const uint32_t a[4][4],
                                         const bf16* bt) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* p = bt + (nt * 8 + g) * LH + ks * 16 + 2 * t;
      mma16816(acc[nt], a[ks], ld32(p), ld32(p + 8));
    }
}

__device__ __forceinline__ void zero8(float a[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

// The A fragments of a 16 x 64 accumulator (8 column tiles), rounded to
// bf16: the operand of the next product over those 64 columns.
__device__ __forceinline__ void acc_to_a(uint32_t a[4][4],
                                         const float c[8][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[ks][0] = pack(c[2 * ks][0], c[2 * ks][1]);
    a[ks][1] = pack(c[2 * ks][2], c[2 * ks][3]);
    a[ks][2] = pack(c[2 * ks + 1][0], c[2 * ks + 1][1]);
    a[ks][3] = pack(c[2 * ks + 1][2], c[2 * ks + 1][3]);
  }
}

// Accumulator element e (0..3) of column tile nt: its row within the
// warp's 16 and its column within the tile's 64.
__device__ __forceinline__ int frag_row(int e) {
  return ((threadIdx.x & 31) >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int nt, int e) {
  return nt * 8 + 2 * (threadIdx.x & 3) + (e & 1);
}

// Row reductions over the 4 threads (a quad) that share an accumulator
// row; the butterfly gives all four the same value.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Pass 1 of the bfloat16 forward: m and l of the warp's two accumulator
// rows (hr 0, 1) of the 16 at row0, online over the key tiles
// [0, kt_end); qa holds the query rows' A fragments, Ks is scratch.
__device__ __forceinline__ void pass1_mma(const uint32_t qa[4][4], bf16* Ks,
                                          const bf16* kb, long long k_rs,
                                          int row0, int kt_end, int tk,
                                          int len, int causal,
                                          int use_alibi, float slope,
                                          float scale, float m[2],
                                          float l[2]) {
  float s[8][4];
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_bf16(Ks, nullptr, kb, k_rs, k0, tk);
    __syncthreads();
    zero8(s);
    mma_rows(s, qa, Ks);
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + frag_row(e), c = k0 + frag_col(nt, e);
        s[nt][e] = c < tk ? logit(s[nt][e], r, c, len, causal, use_alibi,
                                  slope, scale)
                          : -INFINITY;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[nt][e]);
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float m_new = fmaxf(m[hr], quad_max(tmax[hr]));
      float e_sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        e_sum += expf(s[nt][2 * hr] - m_new) + expf(s[nt][2 * hr + 1] - m_new);
      l[hr] = l[hr] * expf(m[hr] - m_new) + quad_sum(e_sum);
      m[hr] = m_new;
    }
  }
}

// The bfloat16 forward of one (64-query tile, head, batch), as fwd_f32.
__device__ __forceinline__ void fwd_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, const int* __restrict__ lengths,
    const float* __restrict__ slopes, Seq sq, Seq sk, Seq sv, Seq so,
    int tq, int tk, int nheads, int causal, float scale) {
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* Ks = Qs + SH;      // [key][d]: B of S = Q K^T
  bf16* Vt = Ks + SH;      // [d][key]: B of O = P V
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int w = threadIdx.x >> 5, q0 = qt * TILE, row0 = q0 + w * 16;
  const int len = lengths[b];
  const int use_alibi = slopes != nullptr;
  const float slope = use_alibi ? slopes[h] : 0.f;
  const bf16* kb = k + b * sk.bs + h * sk.hs;
  const bf16* vb = v + b * sv.bs + h * sv.hs;
  const int kt_end = key_tiles(qt, len, tk, causal);

  load_bf16(Qs, nullptr, q + b * sq.bs + h * sq.hs, sq.rs, q0, tq);
  __syncthreads();
  uint32_t qa[4][4], pa[4][4];
  a_frags(qa, Qs, w * 16);
  float m[2], l[2], s[8][4];
  pass1_mma(qa, Ks, kb, sk.rs, row0, kt_end, tk, len, causal, use_alibi,
            slope, scale, m, l);

  float acc[8][4];
  zero8(acc);
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_bf16(Ks, nullptr, kb, sk.rs, k0, tk);
    load_bf16(nullptr, Vt, vb, sv.rs, k0, tk);
    __syncthreads();
    zero8(s);
    mma_rows(s, qa, Ks);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + frag_row(e), c = k0 + frag_col(nt, e);
        float p = 0.f;
        if (c < tk) {
          const float x = logit(s[nt][e], r, c, len, causal, use_alibi,
                                slope, scale);
          p = __fdiv_rn(expf(x - m[e >> 1]), l[e >> 1]);
        }
        s[nt][e] = p;
      }
    acc_to_a(pa, s);
    mma_rows(acc, pa, Vt);
  }

  bf16* ob = o + b * so.bs + h * so.hs;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + frag_row(2 * hr);
    if (r >= tq) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<uint32_t*>(ob + r * so.rs + frag_col(nt, 0)) =
          pack(acc[nt][2 * hr], acc[nt][2 * hr + 1]);
    if (lse && (threadIdx.x & 3) == 0)
      lse[((long long)b * nheads + h) * tq + r] = m[hr] + logf(l[hr]);
  }
}

#define FWD_MMA_ARGS                                                      \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k,                 \
      const bf16 *__restrict__ v, bf16 *__restrict__ o,                   \
      float *__restrict__ lse, const int *__restrict__ lengths,           \
      const float *__restrict__ slopes, Seq sq, Seq sk, Seq sv, Seq so,   \
      int tq, int tk, int nheads, int causal, float scale

// K5's bfloat16 forward (Tk up to 8192: no resident K).
__global__ void __launch_bounds__(MT) k5_fwd_mma_kernel(FWD_MMA_ARGS) {
  fwd_mma(FWD_PASS);
}

// ------------------------------------------------------------------
// K3/K4 bfloat16 forward for Hopper: TMA into a resident K and a V ring,
// wgmma products (the design note at the top of the file).
// ------------------------------------------------------------------
constexpr int WG = 128;                 // the consumer warpgroup
constexpr int WG_NT = WG + 32;          // and one producer warp
constexpr int TILE_BYTES = TILE * HD * 2;
constexpr int MAX_KEY_TILES = 16;       // Tk <= 1024
constexpr int SMEM_LIMIT = 232448;      // a block's most on an H100
constexpr float LOG2E = 1.4426950408889634f;

// The dynamic shared memory of a plan: alignment slack, Q, the resident
// key tiles and the V stages (1024-byte aligned for the 128B swizzle),
// then the mbarriers (Q, one per key tile, full and empty per stage).
// ops/flash_attention.py's fwd_smem_plan computes the same.
constexpr int plan_bytes(int tiles, int stages) {
  return 1024 + (1 + tiles + stages) * TILE_BYTES +
         8 * (1 + tiles + 2 * stages);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64-row tile (rows [row, row + 64) of head h, batch b) of a 4-D
// (D, T, H, B) tensor map into shared memory at dst.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row),
      "r"(h), "r"(b)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128B-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N wgmma groups of the warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous products.
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_OUT(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d (64 x 64, float32) (+)= A (64 x 16) . B (16 x 64), both K-major in
// shared memory; d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
// d += A (64 x 16, bf16 fragments in registers) . B (16 x 64), B
// MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Issues s = Q K^T of one key tile (four k16 steps, 32 bytes apart
// inside the 128-byte swizzled rows) as one wgmma group.
__device__ __forceinline__ void qk_issue(float (&s)[32], uint64_t dq,
                                         uint64_t dk) {
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_ss(s, dq + 2 * ks, dk + 2 * ks, ks);
  wg_commit();
}

// x = the scaled, ALiBi-biased logits of the products s of one tile.
// Accumulator element i of the thread holds row rr + 8 ((i >> 1) & 1) and
// column cc + 8 (i >> 2) + (i & 1); |k - q| is |dt + const|, dt = rr -
// cc.  EDGE tiles also mask: -inf past tk (no probability), -1e30 at or
// past len or after the query (causal).
template <bool EDGE>
__device__ __forceinline__ void tile_logits(float (&x)[32],
                                            const float (&s)[32], int rr,
                                            int cc, int tk, int len,
                                            int causal, float slope,
                                            float scale) {
  const float dt = (float)(rr - cc);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int j = (i >> 1) & 1, nt = i >> 2, e = i & 1;
    const float bias =
        __fmul_rn(slope, fabsf(dt + (float)(8 * j - 8 * nt - e)));
    x[i] = fmaf(s[i], scale, bias);
    if (EDGE) {
      const int r = rr + 8 * j, c = cc + 8 * nt + e;
      x[i] = c >= tk ? -INFINITY
                     : (c < len && (!causal || c <= r) ? x[i] : NEG_INF);
    }
  }
}

// The bfloat16 forward of one (64-query tile, head, batch) of K3/K4:
// Tq = Tk = t; lse (B, H, t) is written unless it is null.
__device__ __forceinline__ void fwd_wgmma(
    const CUtensorMap* mq, const CUtensorMap* mk, const CUtensorMap* mv,
    bf16* __restrict__ o, float* __restrict__ lse,
    const int* __restrict__ lengths, const float* __restrict__ slopes,
    Seq so, int t, int nheads, int causal, float scale, int tiles,
    int stages) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;   // Q, then the key tiles,
  const uint32_t sk = sq + TILE_BYTES;         // then the V stages
  const uint32_t sv = sk + tiles * TILE_BYTES;
  const uint32_t bq = sv + stages * TILE_BYTES;   // mbarriers
  const uint32_t bk = bq + 8, bfull = bk + 8 * tiles;
  const uint32_t bempty = bfull + 8 * stages;
  const int n_qt = (t + TILE - 1) / TILE;
  const int h = blockIdx.x, b = blockIdx.y, qt = n_qt - 1 - blockIdx.z;
  const int q0 = qt * TILE, len = lengths[b];
  const int kt_end = key_tiles(qt, len, t, causal);
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bq, 1);
    for (int j = 0; j < kt_end; ++j) mbar_init(bk + 8 * j, 1);
    for (int st = 0; st < stages; ++st) {
      mbar_init(bfull + 8 * st, 1);
      mbar_init(bempty + 8 * st, 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= WG) {   // the producer warp: one thread issues every copy
    if (tid == WG) {
      mbar_expect(bq, TILE_BYTES);
      tma_tile(sq, mq, bq, q0, h, b);
      for (int j = 0; j < kt_end; ++j) {
        mbar_expect(bk + 8 * j, TILE_BYTES);
        tma_tile(sk + j * TILE_BYTES, mk, bk + 8 * j, j * TILE, h, b);
      }
      for (int j = 0; j < kt_end; ++j) {
        const int st = j % stages;
        if (j >= stages) mbar_wait(bempty + 8 * st, (j / stages - 1) & 1);
        mbar_expect(bfull + 8 * st, TILE_BYTES);
        tma_tile(sv + st * TILE_BYTES, mv, bfull + 8 * st, j * TILE, h, b);
      }
    }
    return;
  }

  const int w = tid >> 5, lane = tid & 31;
  const int rr = q0 + 16 * w + (lane >> 2);   // rows rr and rr + 8
  const float slope = slopes != nullptr ? slopes[h] : 0.f;
  // key tiles [0, n_in) lie wholly inside the length and causal edges
  int n_in = 0;
  if (len >= 1) {
    n_in = min(len, t) / TILE;
    if (causal) n_in = min(n_in, qt);
  }
  const uint64_t dq = sw128_desc(sq, 16, 1024);
  // The products overlap the softmax, with a pipeline ptxas keeps
  // asynchronous: s is written by wgmma alone and read only after the
  // group that wrote it has retired (the logits go to x), and every
  // iteration issues the next Q K^T unconditionally (the last tile's
  // again at the end, unread).
  float s[32], x[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  const int last = kt_end - 1;
  auto dk = [&](int kt) {
    return sw128_desc(sk + kt * TILE_BYTES, 16, 1024);
  };
  auto logits = [&](int kt) {   // x from s
    const int cc = kt * TILE + 2 * (lane & 3);
    if (kt < n_in)
      tile_logits<false>(x, s, rr, cc, t, len, causal, slope, scale);
    else
      tile_logits<true>(x, s, rr, cc, t, len, causal, slope, scale);
  };
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // pass 1: the row max and the (thread-partial) sum, online; tile kt's
  // softmax runs beside tile kt + 1's Q K^T
  mbar_wait(bq, 0);
  mbar_wait(bk, 0);
  __syncwarp();
  qk_issue(s, dq, dk(0));
  for (int kt = 0; kt < kt_end; ++kt) {
    const int nx = min(kt + 1, last);
    wg_wait<0>();
    reg_fence(s);
    logits(kt);
    mbar_wait(bk + 8 * nx, 0);
    __syncwarp();
    qk_issue(s, dq, dk(nx));
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mx = fmaxf(mx, fmaxf(x[4 * nt + 2 * j], x[4 * nt + 2 * j + 1]));
      const float m_new = fmaxf(m[j], quad_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sum += ex2(__fmul_rn(__fsub_rn(x[4 * nt + 2 * j + e], m_new),
                               LOG2E));
      l[j] = l[j] * ex2(__fmul_rn(__fsub_rn(m[j], m_new), LOG2E)) + sum;
      m[j] = m_new;
    }
  }
  float inv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] = quad_sum(l[j]);
    inv[j] = 1.f / l[j];
  }

  // pass 2: p = exp(s - m) / l rounded to bf16, O += P V; tile kt + 1's
  // softmax runs beside tile kt's P V
  auto probs = [&]() {   // x = p from the logits in x
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = (i >> 1) & 1;
      x[i] = __fmul_rn(ex2(__fmul_rn(__fsub_rn(x[i], m[j]), LOG2E)),
                       inv[j]);
    }
  };
  wg_wait<0>();   // pass 1's last (unread) product
  reg_fence(s);
  float acc[32];
  uint32_t pa[16];   // P's A fragments, four per k16 step of keys
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  qk_issue(s, dq, dk(0));
  wg_wait<0>();
  reg_fence(s);
  logits(0);
  probs();
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i] = pack(x[2 * i], x[2 * i + 1]);
  for (int kt = 0; kt < kt_end; ++kt) {
    qk_issue(s, dq, dk(min(kt + 1, last)));
    const int st = kt % stages;
    const uint32_t vt = sv + st * TILE_BYTES;
    mbar_wait(bfull + 8 * st, (kt / stages) & 1);
    __syncwarp();
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)   // 16 keys = two 1024-byte atoms
      wgmma_rs(acc, pa + 4 * ks, sw128_desc(vt + ks * 2048, 1024, 1024));
    wg_commit();
    wg_wait<1>();   // the next tile's Q K^T; P V still runs
    reg_fence(s);
    if (kt < last) {
      logits(kt + 1);
      probs();
    }
    wg_wait<0>();
    reg_fence(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bempty + 8 * st);
#pragma unroll
    for (int i = 0; i < 16; ++i) pa[i] = pack(x[2 * i], x[2 * i + 1]);
  }

  bf16* ob = o + b * so.bs + h * so.hs;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = rr + 8 * j;
    if (r >= t) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<uint32_t*>(ob + r * so.rs + 8 * nt +
                                   2 * (lane & 3)) =
          pack(acc[4 * nt + 2 * j], acc[4 * nt + 2 * j + 1]);
    if (lse && (lane & 3) == 0)
      lse[((long long)b * nheads + h) * t + r] = m[j] + logf(l[j]);
  }
}

#define FWD_WGMMA_ARGS                                                    \
  const __grid_constant__ CUtensorMap mq,                                 \
      const __grid_constant__ CUtensorMap mk,                             \
      const __grid_constant__ CUtensorMap mv, bf16 *__restrict__ o,       \
      float *__restrict__ lse, const int *__restrict__ lengths,           \
      const float *__restrict__ slopes, Seq so, int t, int nheads,        \
      int causal, float scale, int tiles, int stages
#define FWD_WGMMA_PASS &mq, &mk, &mv, o, lse, lengths, slopes, so, t, \
                       nheads, causal, scale, tiles, stages

__global__ void __launch_bounds__(WG_NT) k3_fwd_wgmma_kernel(FWD_WGMMA_ARGS) {
  fwd_wgmma(FWD_WGMMA_PASS);
}
__global__ void __launch_bounds__(WG_NT) k4_fwd_wgmma_kernel(FWD_WGMMA_ARGS) {
  fwd_wgmma(FWD_WGMMA_PASS);
}

#define BWD_MMA_COMMON                                                    \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k,                 \
      const bf16 *__restrict__ v, const bf16 *__restrict__ g,             \
      const float *__restrict__ rowa, const float *__restrict__ rowl,     \
      const float *__restrict__ delta, const int *__restrict__ lengths,   \
      const float *__restrict__ slopes
#define DKV_MMA_ARGS                                                      \
  BWD_MMA_COMMON, bf16 *__restrict__ dk, bf16 *__restrict__ dv, Seq sq,   \
      Seq sk, Seq sv, Seq sg, Seq sdk, Seq sdv, int tq, int tk,           \
      int nheads, int causal, float scale
#define DQ_MMA_ARGS                                                       \
  BWD_MMA_COMMON, bf16 *__restrict__ dq, Seq sq, Seq sk, Seq sv, Seq sg,  \
      Seq sdq, int tq, int tk, int nheads, int causal, float scale

// K3b's dk, dv of one 64-key tile, each warp 16 keys, in the transposed
// orientation (rows = keys, columns = queries) so that p^T and ds^T feed
// the dv and dk products straight from their accumulators; p = exp(s -
// lse) (rowl unread).
__device__ __forceinline__ void dkv_mma(DKV_MMA_ARGS) {
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // [q][d]: B of S^T = K Q^T
  bf16* Qt = Qs + SH;                         // [d][q]: B of dK += dS^T Q
  bf16* Gs = Qt + SH;                         // [q][d]: B of dP^T = V dO^T
  bf16* Gt = Gs + SH;                         // [d][q]: B of dV += P^T dO
  float* a_s = reinterpret_cast<float*>(Gt + SH);
  float* delta_s = a_s + TILE;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int w = threadIdx.x >> 5, k0 = kt * TILE, key0 = k0 + w * 16;
  const int len = lengths[b];
  const int use_alibi = slopes != nullptr;
  const float slope = use_alibi ? slopes[h] : 0.f;
  const bf16* qb = q + b * sq.bs + h * sq.hs;
  const bf16* gb = g + b * sg.bs + h * sg.hs;
  const long long bh = (long long)b * nheads + h;
  const int nq = (tq + TILE - 1) / TILE;
  int qt_begin = 0;
  if (len >= 1) {
    if (k0 >= len) qt_begin = nq;          // every p of this tile is 0
    else if (causal) qt_begin = kt;
  }
  uint32_t ka[4][4], va[4][4], pa[4][4], sa[4][4];
  float acc_k[8][4], acc_v[8][4], s[8][4], dp[8][4];
  zero8(acc_k);
  zero8(acc_v);
  if (qt_begin < nq) {   // the warp's K and V rows as A fragments
    load_bf16(Qs, nullptr, k + b * sk.bs + h * sk.hs, sk.rs, k0, tk);
    load_bf16(Gs, nullptr, v + b * sv.bs + h * sv.hs, sv.rs, k0, tk);
    __syncthreads();
    a_frags(ka, Qs, w * 16);
    a_frags(va, Gs, w * 16);
  }
  for (int qt = qt_begin; qt < nq; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();
    load_bf16(Qs, Qt, qb, sq.rs, q0, tq);
    load_bf16(Gs, Gt, gb, sg.rs, q0, tq);
    for (int i = threadIdx.x; i < TILE; i += MT) {
      const int r = q0 + i;
      a_s[i] = r < tq ? rowa[bh * tq + r] : 0.f;
      delta_s[i] = r < tq ? delta[bh * tq + r] : 0.f;
    }
    __syncthreads();
    zero8(s);
    zero8(dp);
    mma_rows(s, ka, Qs);
    mma_rows(dp, va, Gs);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = key0 + frag_row(e), ri = frag_col(nt, e), r = q0 + ri;
        float p = 0.f, ds = 0.f;
        if (r < tq && c < tk) {
          const float x = logit(s[nt][e], r, c, len, causal, use_alibi,
                                slope, scale);
          p = prob<false>(x, a_s[ri], 1.f);
          ds = __fmul_rn(p, __fsub_rn(dp[nt][e], delta_s[ri]));
        }
        s[nt][e] = p;
        dp[nt][e] = ds;
      }
    acc_to_a(pa, s);      // p^T rounded to dO's type
    acc_to_a(sa, dp);     // ds^T rounded to q's type
    mma_rows(acc_v, pa, Gt);
    mma_rows(acc_k, sa, Qt);
  }
  bf16* dkb = dk + b * sdk.bs + h * sdk.hs;
  bf16* dvb = dv + b * sdv.bs + h * sdv.hs;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int c = key0 + frag_row(2 * hr);
    if (c >= tk) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int d = frag_col(nt, 0);
      *reinterpret_cast<uint32_t*>(dkb + c * sdk.rs + d) =
          pack(__fmul_rn(acc_k[nt][2 * hr], scale),
               __fmul_rn(acc_k[nt][2 * hr + 1], scale));
      *reinterpret_cast<uint32_t*>(dvb + c * sdv.rs + d) =
          pack(acc_v[nt][2 * hr], acc_v[nt][2 * hr + 1]);
    }
  }
}

// K3b's dq of one 64-query tile, each warp 16 queries (as dkv_mma).
__device__ __forceinline__ void dq_mma(DQ_MMA_ARGS) {
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);  // [key][d]: B of S = Q K^T
  bf16* Vs = Ks + SH;                         // [key][d]: B of dP = dO V^T
  bf16* Kt = Vs + SH;                         // [d][key]: B of dQ += dS K
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int w = threadIdx.x >> 5, q0 = qt * TILE, row0 = q0 + w * 16;
  const int len = lengths[b];
  const int use_alibi = slopes != nullptr;
  const float slope = use_alibi ? slopes[h] : 0.f;
  const bf16* kb = k + b * sk.bs + h * sk.hs;
  const bf16* vb = v + b * sv.bs + h * sv.hs;
  const long long bh = (long long)b * nheads + h;
  const int kt_end = key_tiles(qt, len, tk, causal);
  uint32_t qa[4][4], ga[4][4], sa[4][4];
  load_bf16(Ks, nullptr, q + b * sq.bs + h * sq.hs, sq.rs, q0, tq);
  load_bf16(Vs, nullptr, g + b * sg.bs + h * sg.hs, sg.rs, q0, tq);
  __syncthreads();
  a_frags(qa, Ks, w * 16);
  a_frags(ga, Vs, w * 16);
  float a_r[2], delta_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + frag_row(2 * hr);
    a_r[hr] = r < tq ? rowa[bh * tq + r] : 0.f;
    delta_r[hr] = r < tq ? delta[bh * tq + r] : 0.f;
  }
  float acc[8][4], s[8][4], dp[8][4];
  zero8(acc);
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_bf16(Ks, Kt, kb, sk.rs, k0, tk);
    load_bf16(Vs, nullptr, vb, sv.rs, k0, tk);
    __syncthreads();
    zero8(s);
    zero8(dp);
    mma_rows(s, qa, Ks);
    mma_rows(dp, ga, Vs);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + frag_row(e), c = k0 + frag_col(nt, e);
        float ds = 0.f;
        if (r < tq && c < tk) {
          const float x = logit(s[nt][e], r, c, len, causal, use_alibi,
                                slope, scale);
          const float p = prob<false>(x, a_r[e >> 1], 1.f);
          ds = __fmul_rn(p, __fsub_rn(dp[nt][e], delta_r[e >> 1]));
        }
        dp[nt][e] = ds;
      }
    acc_to_a(sa, dp);
    mma_rows(acc, sa, Kt);
  }
  bf16* dqb = dq + b * sdq.bs + h * sdq.hs;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + frag_row(2 * hr);
    if (r >= tq) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<uint32_t*>(dqb + r * sdq.rs + frag_col(nt, 0)) =
          pack(__fmul_rn(acc[nt][2 * hr], scale),
               __fmul_rn(acc[nt][2 * hr + 1], scale));
  }
}

// K3b's bfloat16 backward (K4b and K5b take bwd_wgmma below).
__global__ void __launch_bounds__(MT) k3b_dkv_mma_kernel(DKV_MMA_ARGS) {
  dkv_mma(DKV_PASS);
}
__global__ void __launch_bounds__(MT) k3b_dq_mma_kernel(DQ_MMA_ARGS) {
  dq_mma(DQ_PASS);
}

// ------------------------------------------------------------------
// K4b/K5b bfloat16 backward for Hopper (bwd_wgmma): TMA rings, wgmma
// products, no transposed copies (the design note at the top of the
// file).
// ------------------------------------------------------------------
constexpr int ROW_FLOATS = 4 * TILE;   // a stage's lse or m, l, 1/l, delta

// The dynamic shared memory of a backward plan with `stages` ring
// stages: alignment slack, two resident tiles (K and V, or Q and dO),
// two tiles per stage (Q and dO, or K and V), each stage's float32 query
// rows (read by the dk/dv kernel), then the mbarriers (the resident
// tiles', full and empty per stage).  ops/flash_attention.py's
// bwd_smem_plan computes the same.
constexpr int bwd_plan_bytes(int stages) {
  return 1024 + (2 + 2 * stages) * TILE_BYTES + stages * ROW_FLOATS * 4 +
         8 * (1 + 2 * stages);
}

// The logit of accumulator element i of a backward tile: rows from rr,
// columns from cc (element i at row rr + 8 ((i >> 1) & 1), column cc +
// 8 (i >> 2) + (i & 1)), keys along the rows (KEY_ROWS: the dk/dv
// kernel's S^T) or along the columns; dt = rr - cc.  EDGE tiles also
// mask: -inf for keys at or past tk or queries at or past tq (p = 0, as
// the mma kernels' r < tq && c < tk test), -1e30 at or past len or
// after the query (causal).
template <bool EDGE, bool KEY_ROWS>
__device__ __forceinline__ float bwd_logit(float s, int i, float dt, int rr,
                                           int cc, int tq, int tk, int len,
                                           int causal, float slope,
                                           float scale) {
  const int j = (i >> 1) & 1, nt = i >> 2, e = i & 1;
  const float x = fmaf(
      s, scale, __fmul_rn(slope, fabsf(dt + (float)(8 * j - 8 * nt - e))));
  if (!EDGE) return x;
  const int row = rr + 8 * j, col = cc + 8 * nt + e;
  const int key = KEY_ROWS ? row : col, qry = KEY_ROWS ? col : row;
  if (key >= tk || qry >= tq) return -INFINITY;
  return key < len && (!causal || key <= qry) ? x : NEG_INF;
}

// p of a logit from its query row's statistics: K4b (a = lse; ex2 of
// (x - lse) log2(e), as the forward) or K5b (HAVE_L: a = m, l and its
// reciprocal inv; expf(x - m) / l as JAX's kernel, the quotient
// correctly rounded by one FMA correction of its product by inv).  At
// Tk up to 8192 a row's dq and a key's dk sum thousands of ds terms,
// each rounded to bf16: ex2.approx of a rounded product (a few ulps) and
// the product by 1/l (1.5 ulps) flip those roundings against the plain
// version's often enough to fail the element-wise gate.
template <bool HAVE_L>
__device__ __forceinline__ float bwd_prob(float x, float a, float l,
                                          float inv) {
  if (!HAVE_L) return ex2(__fmul_rn(__fsub_rn(x, a), LOG2E));
  const float e = expf(__fsub_rn(x, a));
  const float q = __fmul_rn(e, inv);
  return fmaf(fmaf(-q, l, e), inv, q);
}

// d = A B^T over the 64 features, A and B 64 x 64 K-major tiles in
// shared memory (four k16 steps, 32 bytes apart in the swizzled rows);
// issued, not committed.
__device__ __forceinline__ void ss_tile(float (&d)[32], uint32_t a,
                                        uint32_t b) {
  const uint64_t da = sw128_desc(a, 16, 1024), db = sw128_desc(b, 16, 1024);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_ss(d, da + 2 * ks, db + 2 * ks, ks);
}
// d += A B, A's bf16 fragments in registers (four per k16 step), B a
// 64 x 64 tile whose rows are the product's k, read MN-major (the
// transpose bit; 16 rows = two 1024-byte atoms per step); issued, not
// committed.
__device__ __forceinline__ void rs_tile(float (&d)[32],
                                        const uint32_t (&a)[16],
                                        uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_rs(d, a + 4 * ks, sw128_desc(b + ks * 2048, 1024, 1024));
}

// The dk/dv kernel's p^T and ds^T fragments of one (key tile, query
// tile) pair from S^T and dP^T: keys along the rows from cr, queries
// along the columns from qc, each query's a, l, 1/l and delta from the
// stage's rows r_s (index in the tile).
template <bool EDGE, bool HAVE_L>
__device__ __forceinline__ void dkv_frags(uint32_t (&pa)[16],
                                          uint32_t (&sa)[16],
                                          const float (&s)[32],
                                          const float (&dp)[32],
                                          const float* r_s, int cr, int qc,
                                          int q0, int tq, int tk, int len,
                                          int causal, float slope,
                                          float scale) {
  const float dt = (float)(cr - q0 - qc);
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const int c = qc + 8 * (u >> 1);
    const float2 a = *reinterpret_cast<const float2*>(r_s + c);
    const float2 ll = *reinterpret_cast<const float2*>(r_s + TILE + c);
    const float2 il = *reinterpret_cast<const float2*>(r_s + 2 * TILE + c);
    const float2 de = *reinterpret_cast<const float2*>(r_s + 3 * TILE + c);
    float p[2], ds[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * u + e;
      const float x = bwd_logit<EDGE, true>(s[i], i, dt, cr, q0 + qc, tq,
                                            tk, len, causal, slope, scale);
      p[e] = bwd_prob<HAVE_L>(x, e ? a.y : a.x, e ? ll.y : ll.x,
                              e ? il.y : il.x);
      ds[e] = __fmul_rn(p[e], __fsub_rn(dp[i], e ? de.y : de.x));
    }
    pa[u] = pack(p[0], p[1]);    // p^T rounded to dO's type
    sa[u] = pack(ds[0], ds[1]);  // ds^T rounded to q's type
  }
}

// dk, dv of one (64-key tile, head, batch): the producer warp loads K
// and V once and streams the walk's Q and dO tiles (TMA) with their
// rows of lse (or m, l, 1/l) and delta (plain loads: 0, 1, 1 and 0 past
// tq)
// through the ring; the consumer warpgroup forms S^T = K Q^T and
// dP^T = V dO^T (wgmma, shared operands), p^T and ds^T in registers,
// and dV += P^T dO, dK += dS^T Q (wgmma, A in registers, dO and Q read
// MN-major).  Key tiles run in the grid's slowest axis from 0, the
// longest causal walks first.
template <bool HAVE_L>
__device__ __forceinline__ void dkv_wgmma(
    const CUtensorMap* mq, const CUtensorMap* mk, const CUtensorMap* mv,
    const CUtensorMap* mg, const float* __restrict__ rowa,
    const float* __restrict__ rowl, const float* __restrict__ delta,
    const int* __restrict__ lengths, const float* __restrict__ slopes,
    bf16* __restrict__ dk, bf16* __restrict__ dv, Seq sdk, Seq sdv, int tq,
    int tk, int nheads, int causal, float scale, int stages) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t s_k = base, s_v = base + TILE_BYTES;
  const uint32_t ring = base + 2 * TILE_BYTES;   // stage st: Q, then dO
  const uint32_t rows_off = (2 + 2 * stages) * TILE_BYTES;
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + rows_off);
  const uint32_t b_kv = base + rows_off + stages * ROW_FLOATS * 4;
  const uint32_t b_full = b_kv + 8, b_empty = b_full + 8 * stages;
  const int h = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int k0 = kt * TILE, len = lengths[b], tid = threadIdx.x;
  const int nq = (tq + TILE - 1) / TILE;
  int qt_begin = 0;
  if (len >= 1) {
    if (k0 >= len) qt_begin = nq;          // every p of this tile is 0
    else if (causal) qt_begin = kt;
  }
  const int walk = nq - qt_begin;
  const long long bh = (long long)b * nheads + h;

  if (tid == 0) {
    mbar_init(b_kv, 1);
    for (int st = 0; st < stages; ++st) {
      mbar_init(b_full + 8 * st, 32);    // every producer lane
      mbar_init(b_empty + 8 * st, 4);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= WG) {   // the producer warp
    const int lane = tid - WG;
    if (walk > 0 && lane == 0) {
      mbar_expect(b_kv, 2 * TILE_BYTES);
      tma_tile(s_k, mk, b_kv, k0, h, b);
      tma_tile(s_v, mv, b_kv, k0, h, b);
    }
    for (int n = 0; n < walk; ++n) {
      const int st = n % stages, q0 = (qt_begin + n) * TILE;
      if (n >= stages) mbar_wait(b_empty + 8 * st, (n / stages - 1) & 1);
      float* r_s = rows + st * ROW_FLOATS;
      for (int i = lane; i < TILE; i += 32) {
        const int r = q0 + i;
        const bool in = r < tq;
        const float l = HAVE_L && in ? rowl[bh * tq + r] : 1.f;
        r_s[i] = in ? rowa[bh * tq + r] : 0.f;
        r_s[TILE + i] = l;
        r_s[2 * TILE + i] = 1.f / l;
        r_s[3 * TILE + i] = in ? delta[bh * tq + r] : 0.f;
      }
      const uint32_t full = b_full + 8 * st;
      if (lane == 0) {   // its arrival carries the tiles' bytes
        const uint32_t dst = ring + st * 2 * TILE_BYTES;
        mbar_expect(full, 2 * TILE_BYTES);
        tma_tile(dst, mq, full, q0, h, b);
        tma_tile(dst + TILE_BYTES, mg, full, q0, h, b);
      } else {
        mbar_arrive(full);
      }
    }
    return;
  }

  const int w = tid >> 5, lane = tid & 31;
  const int cr = k0 + 16 * w + (lane >> 2);   // keys cr and cr + 8
  const int qc = 2 * (lane & 3);              // query columns qc + 8 nt + e
  const float slope = slopes != nullptr ? slopes[h] : 0.f;
  // the key tile lies wholly inside the length (and below tk)
  const bool keys_in = k0 + TILE <= min(len, tk);
  float acc_k[32], acc_v[32], s[32], dp[32];
  uint32_t pa[16], sa[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = 0.f;
  if (walk > 0) mbar_wait(b_kv, 0);
  for (int n = 0; n < walk; ++n) {
    const int st = n % stages, qt = qt_begin + n, q0 = qt * TILE;
    const uint32_t sq = ring + st * 2 * TILE_BYTES, sg = sq + TILE_BYTES;
    mbar_wait(b_full + 8 * st, (n / stages) & 1);
    __syncwarp();
    wg_fence();
    ss_tile(s, s_k, sq);    // S^T = K Q^T
    ss_tile(dp, s_v, sg);   // dP^T = V dO^T
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    const float* r_s = rows + st * ROW_FLOATS;
    if (keys_in && q0 + TILE <= tq && (!causal || kt < qt))
      dkv_frags<false, HAVE_L>(pa, sa, s, dp, r_s, cr, qc, q0, tq, tk, len,
                               causal, slope, scale);
    else
      dkv_frags<true, HAVE_L>(pa, sa, s, dp, r_s, cr, qc, q0, tq, tk, len,
                              causal, slope, scale);
    wg_fence();
    rs_tile(acc_v, pa, sg);   // dV += P^T dO
    rs_tile(acc_k, sa, sq);   // dK += dS^T Q
    wg_commit();
    wg_wait<0>();
    reg_fence(acc_v);
    reg_fence(acc_k);
    __syncwarp();
    if (lane == 0) mbar_arrive(b_empty + 8 * st);
  }

  bf16* dkb = dk + b * sdk.bs + h * sdk.hs;
  bf16* dvb = dv + b * sdv.bs + h * sdv.hs;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = cr + 8 * j;
    if (c >= tk) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int d = 8 * nt + qc, i = 4 * nt + 2 * j;
      *reinterpret_cast<uint32_t*>(dkb + c * sdk.rs + d) =
          pack(__fmul_rn(acc_k[i], scale), __fmul_rn(acc_k[i + 1], scale));
      *reinterpret_cast<uint32_t*>(dvb + c * sdv.rs + d) =
          pack(acc_v[i], acc_v[i + 1]);
    }
  }
}

// The dq kernel's ds fragments of one (query tile, key tile) pair from
// S and dP: queries along the rows from rr (rows rr and rr + 8 with
// their a, l, 1/l and delta), keys along the columns from cc.
template <bool EDGE, bool HAVE_L>
__device__ __forceinline__ void dq_frags(uint32_t (&sa)[16],
                                         const float (&s)[32],
                                         const float (&dp)[32],
                                         const float (&a_r)[2],
                                         const float (&l_r)[2],
                                         const float (&inv_r)[2],
                                         const float (&del_r)[2], int rr,
                                         int cc, int tq, int tk, int len,
                                         int causal, float slope,
                                         float scale) {
  const float dt = (float)(rr - cc);
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const int j = u & 1;
    float ds[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * u + e;
      const float x = bwd_logit<EDGE, false>(s[i], i, dt, rr, cc, tq, tk,
                                             len, causal, slope, scale);
      const float p = bwd_prob<HAVE_L>(x, a_r[j], l_r[j], inv_r[j]);
      ds[e] = __fmul_rn(p, __fsub_rn(dp[i], del_r[j]));
    }
    sa[u] = pack(ds[0], ds[1]);   // ds rounded to q's type
  }
}

// dq of one (64-query tile, head, batch): Q and dO are loaded once, K
// (pass 1) and K with V (pass 2) stream through the ring.  HAVE_L (K5b):
// pass 1 walks the key tiles for each row's m and l (online, as the
// forward's pass 1) and writes m to rowa and l to rowl for the dk/dv
// kernel, which runs after; without it (K4b) rowa holds K4's lse.  Pass
// 2 forms S = Q K^T and dP = dO V^T (wgmma, shared operands), ds in
// registers and dQ += dS K (A in registers, K read MN-major).  Query
// tiles run in the grid's slowest axis from the last, the longest causal
// walks first.
template <bool HAVE_L>
__device__ __forceinline__ void dq_wgmma(
    const CUtensorMap* mq, const CUtensorMap* mk, const CUtensorMap* mv,
    const CUtensorMap* mg, float* __restrict__ rowa,
    float* __restrict__ rowl, const float* __restrict__ delta,
    const int* __restrict__ lengths, const float* __restrict__ slopes,
    bf16* __restrict__ dq, Seq sdq, int tq, int tk, int nheads, int causal,
    float scale, int stages) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_q = base, s_g = base + TILE_BYTES;
  const uint32_t ring = base + 2 * TILE_BYTES;   // stage st: K, then V
  const uint32_t b_qg = base + (2 + 2 * stages) * TILE_BYTES +
                        stages * ROW_FLOATS * 4;
  const uint32_t b_full = b_qg + 8, b_empty = b_full + 8 * stages;
  const int n_qt = (tq + TILE - 1) / TILE;
  const int h = blockIdx.x, b = blockIdx.y, qt = n_qt - 1 - blockIdx.z;
  const int q0 = qt * TILE, len = lengths[b], tid = threadIdx.x;
  const int kt_end = key_tiles(qt, len, tk, causal);
  const int n1 = HAVE_L ? kt_end : 0;   // pass 1's ring items
  const long long bh = (long long)b * nheads + h;

  if (tid == 0) {
    mbar_init(b_qg, 1);
    for (int st = 0; st < stages; ++st) {
      mbar_init(b_full + 8 * st, 1);
      mbar_init(b_empty + 8 * st, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= WG) {   // the producer warp: one thread issues every copy
    if (tid == WG) {
      mbar_expect(b_qg, 2 * TILE_BYTES);
      tma_tile(s_q, mq, b_qg, q0, h, b);
      tma_tile(s_g, mg, b_qg, q0, h, b);
      for (int n = 0; n < n1 + kt_end; ++n) {
        const int st = n % stages, k0 = (n < n1 ? n : n - n1) * TILE;
        const uint32_t dst = ring + st * 2 * TILE_BYTES;
        const uint32_t full = b_full + 8 * st;
        if (n >= stages) mbar_wait(b_empty + 8 * st, (n / stages - 1) & 1);
        mbar_expect(full, (n < n1 ? 1 : 2) * TILE_BYTES);
        tma_tile(dst, mk, full, k0, h, b);
        if (n >= n1) tma_tile(dst + TILE_BYTES, mv, full, k0, h, b);
      }
    }
    return;
  }

  const int w = tid >> 5, lane = tid & 31;
  const int rr = q0 + 16 * w + (lane >> 2);   // query rows rr and rr + 8
  const int cc = 2 * (lane & 3);              // key columns cc + 8 nt + e
  const float slope = slopes != nullptr ? slopes[h] : 0.f;
  float a_r[2], l_r[2], inv_r[2], del_r[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = rr + 8 * j;
    a_r[j] = !HAVE_L && r < tq ? rowa[bh * tq + r] : 0.f;
    l_r[j] = inv_r[j] = 1.f;
    del_r[j] = r < tq ? delta[bh * tq + r] : 0.f;
  }
  float s[32], dp[32], acc[32];
  uint32_t sa[16];
  mbar_wait(b_qg, 0);

  if (HAVE_L) {   // pass 1: m and l (expf), online over the key tiles
    // key tiles [0, n_in) lie wholly inside the length and causal edges
    int n_in = 0;
    if (len >= 1) {
      n_in = min(len, tk) / TILE;
      if (causal) n_in = min(n_in, qt);
    }
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int kt = 0; kt < kt_end; ++kt) {
      const int st = kt % stages;
      mbar_wait(b_full + 8 * st, (kt / stages) & 1);
      __syncwarp();
      wg_fence();
      ss_tile(s, s_q, ring + st * 2 * TILE_BYTES);
      wg_commit();
      wg_wait<0>();
      reg_fence(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(b_empty + 8 * st);
      float x[32];   // the logits
      if (kt < n_in)
        tile_logits<false>(x, s, rr, kt * TILE + cc, tk, len, causal, slope,
                           scale);
      else
        tile_logits<true>(x, s, rr, kt * TILE + cc, tk, len, causal, slope,
                          scale);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          mx = fmaxf(mx, fmaxf(x[4 * nt + 2 * j], x[4 * nt + 2 * j + 1]));
        const float m_new = fmaxf(m[j], quad_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sum += expf(__fsub_rn(x[4 * nt + 2 * j + e], m_new));
        l[j] = l[j] * expf(__fsub_rn(m[j], m_new)) + sum;
        m[j] = m_new;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = rr + 8 * j;
      a_r[j] = m[j];
      l_r[j] = quad_sum(l[j]);
      inv_r[j] = 1.f / l_r[j];
      if (r < tq && (lane & 3) == 0) {
        rowa[bh * tq + r] = a_r[j];
        rowl[bh * tq + r] = l_r[j];
      }
    }
  }

  // pass 2: dQ += dS K
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const bool rows_in = q0 + TILE <= tq;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int n = n1 + kt, st = n % stages, k0 = kt * TILE;
    const uint32_t sk = ring + st * 2 * TILE_BYTES, sv = sk + TILE_BYTES;
    mbar_wait(b_full + 8 * st, (n / stages) & 1);
    __syncwarp();
    wg_fence();
    ss_tile(s, s_q, sk);    // S = Q K^T
    ss_tile(dp, s_g, sv);   // dP = dO V^T
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    if (rows_in && k0 + TILE <= min(len, tk) && (!causal || kt < qt))
      dq_frags<false, HAVE_L>(sa, s, dp, a_r, l_r, inv_r, del_r, rr,
                              k0 + cc, tq, tk, len, causal, slope, scale);
    else
      dq_frags<true, HAVE_L>(sa, s, dp, a_r, l_r, inv_r, del_r, rr, k0 + cc,
                             tq, tk, len, causal, slope, scale);
    wg_fence();
    rs_tile(acc, sa, sk);   // dQ += dS K
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(b_empty + 8 * st);
  }

  bf16* dqb = dq + b * sdq.bs + h * sdq.hs;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = rr + 8 * j;
    if (r >= tq) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int i = 4 * nt + 2 * j;
      *reinterpret_cast<uint32_t*>(dqb + r * sdq.rs + 8 * nt + cc) =
          pack(__fmul_rn(acc[i], scale), __fmul_rn(acc[i + 1], scale));
    }
  }
}

#define BWD_WGMMA_MAPS                                                    \
  const __grid_constant__ CUtensorMap mq,                                 \
      const __grid_constant__ CUtensorMap mk,                             \
      const __grid_constant__ CUtensorMap mv,                             \
      const __grid_constant__ CUtensorMap mg
#define DKV_WGMMA_ARGS                                                    \
  BWD_WGMMA_MAPS, const float *__restrict__ rowa,                         \
      const float *__restrict__ rowl, const float *__restrict__ delta,    \
      const int *__restrict__ lengths, const float *__restrict__ slopes,  \
      bf16 *__restrict__ dk, bf16 *__restrict__ dv, Seq sdk, Seq sdv,     \
      int tq, int tk, int nheads, int causal, float scale, int stages
#define DKV_WGMMA_PASS &mq, &mk, &mv, &mg, rowa, rowl, delta, lengths,    \
                       slopes, dk, dv, sdk, sdv, tq, tk, nheads, causal, \
                       scale, stages
#define DQ_WGMMA_ARGS                                                     \
  BWD_WGMMA_MAPS, float *__restrict__ rowa, float *__restrict__ rowl,     \
      const float *__restrict__ delta, const int *__restrict__ lengths,   \
      const float *__restrict__ slopes, bf16 *__restrict__ dq, Seq sdq,   \
      int tq, int tk, int nheads, int causal, float scale, int stages
#define DQ_WGMMA_PASS &mq, &mk, &mv, &mg, rowa, rowl, delta, lengths,     \
                      slopes, dq, sdq, tq, tk, nheads, causal, scale,    \
                      stages

__global__ void __launch_bounds__(WG_NT) k4b_dkv_wgmma_kernel(DKV_WGMMA_ARGS) {
  dkv_wgmma<false>(DKV_WGMMA_PASS);
}
__global__ void __launch_bounds__(WG_NT) k5b_dkv_wgmma_kernel(DKV_WGMMA_ARGS) {
  dkv_wgmma<true>(DKV_WGMMA_PASS);
}
__global__ void __launch_bounds__(WG_NT) k4b_dq_wgmma_kernel(DQ_WGMMA_ARGS) {
  dq_wgmma<false>(DQ_WGMMA_PASS);
}
__global__ void __launch_bounds__(WG_NT) k5b_dq_wgmma_kernel(DQ_WGMMA_ARGS) {
  dq_wgmma<true>(DQ_WGMMA_PASS);
}

typedef void (*FwdF32)(FWD_F32_ARGS);
typedef void (*DkvF32)(DKV_F32_ARGS);
typedef void (*DqF32)(DQ_F32_ARGS);
constexpr FwdF32 FWD_F32[3] = {k3_fwd_kernel, k4_fwd_kernel, k5_fwd_kernel};
constexpr DkvF32 DKV_F32[3] = {k3b_dkv_kernel, k4b_dkv_kernel,
                               k5b_dkv_kernel};
constexpr DqF32 DQ_F32[3] = {k3b_dq_kernel, k4b_dq_kernel, k5b_dq_kernel};

// cuTensorMapEncodeTiled through the runtime's driver entry point (the
// library links no -lcuda); null if the driver has none.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Launch errors of the wgmma kernels beyond cudaError_t: no encoder in
// the driver, or the driver refused a tensor map (TMA_ENCODE + CUresult).
constexpr int TMA_NO_ENCODER = 900;
constexpr int TMA_ENCODE = 1000;

// The (D, T, H, B) tensor map of one bf16 operand, 64 x 64 boxes with
// 128B swizzle, zero fill past T.  A size-1 axis's stride is never read;
// 128 bytes stands in for it.
int tile_map(CUtensorMap* map, const void* ptr, Seq s, int t, int h, int b) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return TMA_NO_ENCODER;
  const cuuint64_t row = HD * 2;
  cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)t, (cuuint64_t)h,
                        (cuuint64_t)b};
  cuuint64_t strides[3] = {t > 1 ? (cuuint64_t)s.rs * 2 : row,
                           h > 1 ? (cuuint64_t)s.hs * 2 : row,
                           b > 1 ? (cuuint64_t)s.bs * 2 : row};
  cuuint32_t box[4] = {(cuuint32_t)HD, (cuuint32_t)TILE, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMA_ENCODE + (int)r;
}

// K3 (`kid` 0) or K4 (1) bfloat16 forward, Tq = Tk = t: one block per
// (64-query tile, head, batch), query tiles in the grid's slowest axis,
// the longest first.  `smem`, `tiles` and `stages` are the wrapper's
// shared-memory plan; a plan that cannot hold this launch is refused.
int launch_fwd_wgmma(int kid, const void* q, const void* k, const void* v,
                     void* o, float* lse, const int* lengths,
                     const float* slopes, Seq sq, Seq sk, Seq sv, Seq so,
                     int B, int t, int H, int causal, float scale, int smem,
                     int tiles, int stages, cudaStream_t stream) {
  if (tiles < (t + TILE - 1) / TILE || tiles > MAX_KEY_TILES ||
      stages < 1 || smem < plan_bytes(tiles, stages) || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int err = tile_map(&mq, q, sq, t, H, B);
  if (!err) err = tile_map(&mk, k, sk, t, H, B);
  if (!err) err = tile_map(&mv, v, sv, t, H, B);
  if (err) return err;
  const void* fn = kid == 0 ? (const void*)k3_fwd_wgmma_kernel
                            : (const void*)k4_fwd_wgmma_kernel;
  static int attr[2] = {0, 0};   // the largest size set per kernel
  if (smem > attr[kid]) {
    err = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    attr[kid] = smem;
  }
  dim3 grid(H, B, (t + TILE - 1) / TILE);
  if (kid == 0)
    k3_fwd_wgmma_kernel<<<grid, WG_NT, smem, stream>>>(
        mq, mk, mv, (bf16*)o, lse, lengths, slopes, so, t, H, causal, scale,
        tiles, stages);
  else
    k4_fwd_wgmma_kernel<<<grid, WG_NT, smem, stream>>>(
        mq, mk, mv, (bf16*)o, lse, lengths, slopes, so, t, H, causal, scale,
        tiles, stages);
  return (int)cudaGetLastError();
}

// One forward launch of entry point `kid` (0: K3, 1: K4, 2: K5): one block
// per (64-query tile, head, batch); lse may be null.  K3/K4 in bfloat16
// take the wgmma kernels with the plan (smem, tiles, stages).
int launch_fwd(int kid, int use_mma, const void* q, const void* k,
               const void* v, void* o, float* lse, const int* lengths,
               const float* slopes, Seq sq, Seq sk, Seq sv, Seq so, int B,
               int tq, int tk, int H, int causal, float scale, int smem,
               int tiles, int stages, cudaStream_t stream) {
  if (use_mma && kid < 2) {
    if (tq != tk) return (int)cudaErrorInvalidValue;
    return launch_fwd_wgmma(kid, q, k, v, o, lse, lengths, slopes, sq, sk,
                            sv, so, B, tq, H, causal, scale, smem, tiles,
                            stages, stream);
  }
  dim3 grid((tq + TILE - 1) / TILE, H, B);
  if (use_mma) {
    k5_fwd_mma_kernel<<<grid, MT, FWD_MMA_SMEM, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse,
        lengths, slopes, sq, sk, sv, so, tq, tk, H, causal, scale);
    return (int)cudaGetLastError();
  }
  static bool attr[3] = {false, false, false};
  if (!attr[kid]) {
    cudaFuncSetAttribute(FWD_F32[kid],
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         FWD_SMEM);
    attr[kid] = true;
  }
  FWD_F32[kid]<<<grid, NT, FWD_SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse,
      lengths, slopes, sq, sk, sv, so, tq, tk, H, causal, scale);
  return (int)cudaGetLastError();
}

// K4b (`kid` 1: rowa = K4's lse, rowl null) or K5b (2: rowa and rowl
// receive each query row's m and l) bfloat16 backward: the dq kernel
// (K5b's row statistics folded into its pass 1), then the dk/dv kernel.
// `smem` and `stages` are the wrapper's shared-memory plan; a plan that
// cannot hold these launches is refused.
int launch_bwd_wgmma(int kid, const void* q, const void* k, const void* v,
                     const void* g, float* rowa, float* rowl,
                     const float* delta, const int* lengths,
                     const float* slopes, void* dq, void* dk, void* dv,
                     Seq sq, Seq sk, Seq sv, Seq sg, Seq sdq, Seq sdk,
                     Seq sdv, int B, int tq, int tk, int H, int causal,
                     float scale, int smem, int stages,
                     cudaStream_t stream) {
  if (stages < 1 || smem < bwd_plan_bytes(stages) || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mg;
  int err = tile_map(&mq, q, sq, tq, H, B);
  if (!err) err = tile_map(&mg, g, sg, tq, H, B);
  if (!err) err = tile_map(&mk, k, sk, tk, H, B);
  if (!err) err = tile_map(&mv, v, sv, tk, H, B);
  if (err) return err;
  const int l = kid == 2;
  const void* fq = l ? (const void*)k5b_dq_wgmma_kernel
                     : (const void*)k4b_dq_wgmma_kernel;
  const void* fkv = l ? (const void*)k5b_dkv_wgmma_kernel
                      : (const void*)k4b_dkv_wgmma_kernel;
  static int attr[2] = {0, 0};   // the largest size set per entry point
  if (smem > attr[l]) {
    err = (int)cudaFuncSetAttribute(
        fq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (!err)
      err = (int)cudaFuncSetAttribute(
          fkv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    attr[l] = smem;
  }
  dim3 gq(H, B, (tq + TILE - 1) / TILE), gk(H, B, (tk + TILE - 1) / TILE);
  if (l)
    k5b_dq_wgmma_kernel<<<gq, WG_NT, smem, stream>>>(
        mq, mk, mv, mg, rowa, rowl, delta, lengths, slopes, (bf16*)dq, sdq,
        tq, tk, H, causal, scale, stages);
  else
    k4b_dq_wgmma_kernel<<<gq, WG_NT, smem, stream>>>(
        mq, mk, mv, mg, rowa, rowl, delta, lengths, slopes, (bf16*)dq, sdq,
        tq, tk, H, causal, scale, stages);
  err = (int)cudaGetLastError();
  if (err) return err;
  if (l)
    k5b_dkv_wgmma_kernel<<<gk, WG_NT, smem, stream>>>(
        mq, mk, mv, mg, rowa, rowl, delta, lengths, slopes, (bf16*)dk,
        (bf16*)dv, sdk, sdv, tq, tk, H, causal, scale, stages);
  else
    k4b_dkv_wgmma_kernel<<<gk, WG_NT, smem, stream>>>(
        mq, mk, mv, mg, rowa, rowl, delta, lengths, slopes, (bf16*)dk,
        (bf16*)dv, sdk, sdv, tq, tk, H, causal, scale, stages);
  return (int)cudaGetLastError();
}

// The backward's two launches of entry point `kid` (0: K3b, 1: K4b,
// 2: K5b): float32, and K3b in bfloat16, one block per (64-key tile,
// head, batch) for dk and dv, then one per (64-query tile, head, batch)
// for dq; K4b and K5b in bfloat16 take launch_bwd_wgmma with the plan
// (smem, stages).  K3b and K4b read lse from rowa; K5b reads m from rowa
// and l from rowl (float32: from flash_stats_launch; bfloat16: written
// there by the dq kernel).
int launch_bwd(int kid, int use_mma, const void* q, const void* k,
               const void* v, const void* g, float* rowa, float* rowl,
               const float* delta, const int* lengths, const float* slopes,
               void* dq, void* dk, void* dv, Seq sq, Seq sk, Seq sv, Seq sg,
               Seq sdq, Seq sdk, Seq sdv, int B, int tq, int tk, int H,
               int causal, float scale, int smem, int stages,
               cudaStream_t stream) {
  if (use_mma && kid > 0)
    return launch_bwd_wgmma(kid, q, k, v, g, rowa, rowl, delta, lengths,
                            slopes, dq, dk, dv, sq, sk, sv, sg, sdq, sdk,
                            sdv, B, tq, tk, H, causal, scale, smem, stages,
                            stream);
  dim3 gk((tk + TILE - 1) / TILE, H, B), gq((tq + TILE - 1) / TILE, H, B);
  int err;
  if (use_mma) {
    k3b_dkv_mma_kernel<<<gk, MT, DKV_MMA_SMEM, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g,
        rowa, rowl, delta, lengths, slopes, (bf16*)dk, (bf16*)dv, sq, sk,
        sv, sg, sdk, sdv, tq, tk, H, causal, scale);
    err = (int)cudaGetLastError();
    if (err) return err;
    k3b_dq_mma_kernel<<<gq, MT, DQ_MMA_SMEM, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g,
        rowa, rowl, delta, lengths, slopes, (bf16*)dq, sq, sk, sv, sg, sdq,
        tq, tk, H, causal, scale);
    return (int)cudaGetLastError();
  }
  static bool attr[3] = {false, false, false};
  if (!attr[kid]) {
    cudaFuncSetAttribute(DKV_F32[kid],
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         DKV_SMEM);
    cudaFuncSetAttribute(DQ_F32[kid],
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         DQ_SMEM);
    attr[kid] = true;
  }
  DKV_F32[kid]<<<gk, NT, DKV_SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g,
      rowa, rowl, delta, lengths, slopes, (float*)dk, (float*)dv, sq, sk,
      sv, sg, sdk, sdv, tq, tk, H, causal, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  DQ_F32[kid]<<<gq, NT, DQ_SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g,
      rowa, rowl, delta, lengths, slopes, (float*)dq, sq, sk, sv, sg, sdq,
      tq, tk, H, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Strides are in elements: (batch, row) of each packed operand (K3/K3b:
// the head stride is head_dim), (batch, head, row) of each operand of
// K4, K4b, K5 and K5b.  K3/K4 take the bf16 forward's shared-memory plan
// (smem bytes, resident key tiles, V stages; unread for float32).
int flash_fwd_packed_launch(const void* q, const void* k, const void* v,
                            void* o, float* lse, const int* lengths,
                            const float* slopes, long long q_bs,
                            long long q_rs, long long k_bs, long long k_rs,
                            long long v_bs, long long v_rs, long long o_bs,
                            long long o_rs, int B, int T_, int H, int bf16,
                            int causal, float scale, int smem, int tiles,
                            int stages, void* stream) {
  Seq sq{q_bs, HD, q_rs}, sk{k_bs, HD, k_rs}, sv{v_bs, HD, v_rs};
  Seq so{o_bs, HD, o_rs};
  return launch_fwd(0, bf16, q, k, v, o, lse, lengths, slopes, sq, sk, sv,
                    so, B, T_, T_, H, causal, scale, smem, tiles, stages,
                    (cudaStream_t)stream);
}

// K4: Tq = Tk = T_ (<= 1024 on its path); lse (B, H, T) or null.
int flash_fwd_full_launch(const void* q, const void* k, const void* v,
                          void* o, float* lse, const int* lengths,
                          const float* slopes, long long q_bs,
                          long long q_hs, long long q_rs, long long k_bs,
                          long long k_hs, long long k_rs, long long v_bs,
                          long long v_hs, long long v_rs, long long o_bs,
                          long long o_hs, long long o_rs, int B, int T_,
                          int H, int bf16, int causal, float scale, int smem,
                          int tiles, int stages, void* stream) {
  Seq sq{q_bs, q_hs, q_rs}, sk{k_bs, k_hs, k_rs}, sv{v_bs, v_hs, v_rs};
  Seq so{o_bs, o_hs, o_rs};
  return launch_fwd(1, bf16, q, k, v, o, lse, lengths, slopes, sq, sk, sv,
                    so, B, T_, T_, H, causal, scale, smem, tiles, stages,
                    (cudaStream_t)stream);
}

// K5: Tq queries against Tk keys, no lse.
int flash_fwd_tiled_launch(const void* q, const void* k, const void* v,
                           void* o, const int* lengths, const float* slopes,
                           long long q_bs, long long q_hs, long long q_rs,
                           long long k_bs, long long k_hs, long long k_rs,
                           long long v_bs, long long v_hs, long long v_rs,
                           long long o_bs, long long o_hs, long long o_rs,
                           int B, int Tq, int Tk, int H, int bf16,
                           int causal, float scale, void* stream) {
  Seq sq{q_bs, q_hs, q_rs}, sk{k_bs, k_hs, k_rs}, sv{v_bs, v_hs, v_rs};
  Seq so{o_bs, o_hs, o_rs};
  return launch_fwd(2, bf16, q, k, v, o, nullptr, lengths, slopes, sq, sk,
                    sv, so, B, Tq, Tk, H, causal, scale, 0, 0, 0,
                    (cudaStream_t)stream);
}

int flash_bwd_packed_launch(const void* q, const void* k, const void* v,
                            const void* g, const float* lse,
                            const float* delta, const int* lengths,
                            const float* slopes, void* dq, void* dk,
                            void* dv, long long q_bs, long long q_rs,
                            long long k_bs, long long k_rs, long long v_bs,
                            long long v_rs, long long g_bs, long long g_rs,
                            long long dq_bs, long long dq_rs,
                            long long dk_bs, long long dk_rs,
                            long long dv_bs, long long dv_rs, int B, int T_,
                            int H, int bf16, int causal, float scale,
                            void* stream) {
  Seq sq{q_bs, HD, q_rs}, sk{k_bs, HD, k_rs}, sv{v_bs, HD, v_rs};
  Seq sg{g_bs, HD, g_rs};
  Seq sdq{dq_bs, HD, dq_rs}, sdk{dk_bs, HD, dk_rs}, sdv{dv_bs, HD, dv_rs};
  return launch_bwd(0, bf16, q, k, v, g, const_cast<float*>(lse), nullptr,
                    delta, lengths, slopes, dq, dk, dv, sq, sk, sv, sg, sdq,
                    sdk, sdv, B, T_, T_, H, causal, scale, 0, 0,
                    (cudaStream_t)stream);
}

// K5b's float32 row statistics, m into m_out and l into l_out, each
// (B, H, Tq): one block per (64-query tile, head, batch).  (The bf16
// backward folds them into its dq kernel.)
int flash_stats_launch(const void* q, const void* k, const int* lengths,
                       const float* slopes, float* m_out, float* l_out,
                       long long q_bs, long long q_hs, long long q_rs,
                       long long k_bs, long long k_hs, long long k_rs, int B,
                       int Tq, int Tk, int H, int causal, float scale,
                       void* stream) {
  Seq sq{q_bs, q_hs, q_rs}, sk{k_bs, k_hs, k_rs};
  dim3 grid((Tq + TILE - 1) / TILE, H, B);
  k5b_stats_kernel<<<grid, NT, STATS_SMEM, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, lengths, slopes, m_out, l_out, sq,
      sk, Tq, Tk, H, causal, scale);
  return (int)cudaGetLastError();
}

// K4b (`kid` 1: Tq = Tk, rowa = lse from K4, rowl null) or K5b (`kid` 2:
// rowa and rowl hold m and l, from flash_stats_launch in float32 and
// from the dq kernel in bfloat16) on (B, H, T, D)
// operands; `smem` and `stages` are the bf16 backward's plan (unread for
// float32).
int flash_bwd_bhtd_launch(int kid, const void* q, const void* k,
                          const void* v, const void* g, float* rowa,
                          float* rowl, const float* delta,
                          const int* lengths, const float* slopes, void* dq,
                          void* dk, void* dv, long long q_bs, long long q_hs,
                          long long q_rs, long long k_bs, long long k_hs,
                          long long k_rs, long long v_bs, long long v_hs,
                          long long v_rs, long long g_bs, long long g_hs,
                          long long g_rs, long long dq_bs, long long dq_hs,
                          long long dq_rs, long long dk_bs, long long dk_hs,
                          long long dk_rs, long long dv_bs, long long dv_hs,
                          long long dv_rs, int B, int Tq, int Tk, int H,
                          int bf16, int causal, float scale, int smem,
                          int stages, void* stream) {
  if (kid < 1 || kid > 2 || (kid == 2) != (rowl != nullptr))
    return (int)cudaErrorInvalidValue;
  Seq sq{q_bs, q_hs, q_rs}, sk{k_bs, k_hs, k_rs}, sv{v_bs, v_hs, v_rs};
  Seq sg{g_bs, g_hs, g_rs};
  Seq sdq{dq_bs, dq_hs, dq_rs}, sdk{dk_bs, dk_hs, dk_rs};
  Seq sdv{dv_bs, dv_hs, dv_rs};
  return launch_bwd(kid, bf16, q, k, v, g, rowa, rowl, delta, lengths,
                    slopes, dq, dk, dv, sq, sk, sv, sg, sdq, sdk, sdv, B, Tq,
                    Tk, H, causal, scale, smem, stages, (cudaStream_t)stream);
}

}  // extern "C"
