// One whole trunk AR step (all L layers) over the three-tier mega cache,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vae_gslm_tpu/ops/mega_step.py::
// fused_trunk_step (kernel body `_kernel`).  It computes what the
// reference fused_trunk_step_reference computes; its plain PyTorch
// version is fused_trunk_step_plain in vae_gslm_tpu_torch/ops/mega_step.py.
// Layouts (JAX's, at the wrapper): weights (L, din, dout) int8 with
// (L, dout) float32 column scales; cold cache (L, NB, H, B, Dh, 128) int8
// time-minor with (L, NB, H, B, 128) scales; tail (L, H, B, 128, Dh) int8
// with (L, H, B, 128) scales; stage (L, 8, H, B, Dh) bfloat16.
//
// Bound.  Per step the kernel must read the 16 x 12 x 1024^2 = 201 MB of
// int8 weights once, plus B*H*pos*(2*Dh + 8) bytes of valid cache rows per
// layer: at B=8 about 73 us at pos 151 and 114 us at pos 650 (3.35 TB/s).
// It is bound by HBM bytes: even at B=32 the dense products are 64
// int8 (or bf16) operations per weight byte, far under the card's ratio.
//
// Design (simple first; a persistent single launch with wgmma/TMA weight
// streaming is later work).  One C call per step issues, for each layer,
// these kernels in stream order:
//   1. rows_kernel: RMSNorm(x, n1), then per-row int8 quantization (a8)
//      or the float32 row (bf16 branch, rounded to bf16 where it is read);
//   2. dense_kernel + epilogue_kernel: the QKV product plus bq.  The dense
//      kernel splits K into chunks (one grid row each) and writes partial
//      sums; the epilogue sums them in chunk order and applies the scales,
//      so the result does not depend on which block finishes first;
//   3. attn_kernel, one block per (h, b): cold blocks, the tail masked at
//      t < stage_base, the stage rows masked at stage_base <= j < pos,
//      then the current token; writes k_new/v_new in bf16 and the head's
//      output (int8 + per-head scale for a8, float32 otherwise);
//   4. the out-projection, split by head: the epilogue sums heads 0..H-1
//      in order (a8: dot_h * asx[b, h]), applies `so`, the residual and bo;
//   5. rows_kernel(x, n3), the FFN-up product, b1, the rational-erf GELU;
//   6. (a8) rows_kernel quantizes the GELU rows; the FFN-down product, b2,
//      the residual.
// Dense products: a8 takes __dp4a over four int8 weights of one column
// (a 4x4 byte transpose of four 32-bit row loads) in int32; the bf16
// branch multiplies the bf16-rounded activation by the int8 weight
// (converted exactly by a magic-number trick) and sums in float64, as the
// plain version does (the TPU sums in float32; see dense_kernel).  Each
// thread owns 4 columns and 8 batch rows; more rows take more grid rows.
//
// Numerics that must match the reference (and are easy to get wrong):
//   * the online softmax is per 128-row block: each block's e*v_scale is
//     requantized against the running maximum AT THAT BLOCK, not a global
//     one (K1's structure cannot be reused as it is);
//   * products and sums are grouped as the reference groups them:
//     (s_i32 * (q_scale * scale)) * k_scale; a8: y * (xs * scale_col);
//     bf16: y * scale_col then + b; the a8 out-projection sums
//     dot_h * asx[b, h] over heads in order, then * so;
//   * every separately rounded operation is written with __fmul_rn /
//     __fadd_rn / __fdiv_rn so nvcc does not contract it into an FMA;
//     rounding is half to even (__float2int_rn); divisions are true
//     divisions (the plain version divides by tensors);
//   * rsqrt is the correctly rounded 1 / sqrt (__fsqrt_rn, __fdiv_rn), in
//     the plain version too; the RMS sum of squares, the stage-tier dots,
//     the current token's dot, the softmax denominators and the stage P.V
//     are summed in float64 and rounded once, in the plain version too, so
//     their order of summation does not matter;
//   * GELU uses the Abramowitz-Stegun rational erf of the TPU kernel.
//
// The w4 branch (group > 0; K2-w4, the Pallas kernel's w4 path at _kernel
// and its out-projection) reads nibble-packed int4 weights: (L, din/2,
// dout) int8, rows r and r + din/2 in the hi and lo nibble of one byte,
// with folded group scales g (L, din/group, dout) float32 in place of the
// column scales.  Its bound is the same HBM stream at about half the
// weight bytes (6 x 1024^2 x 16 = 101 MB packed + 6.3 MB of group scales
// at group 128).  It has kernels of its own beside the a8/bf16 ones, which
// it leaves as they are:
//   * rows_w4_kernel quantizes each row per group of `group` inputs (one
//     scale per (row, group), max|h| / 127 divided, not multiplied by a
//     reciprocal);
//   * dense_w4_kernel reads each packed byte once: a block takes PKC = 32
//     packed rows, unpacks the hi nibbles (logical rows p0..) and the
//     sign-extended lo nibbles (rows din/2 + p0..) into int8 and sums each
//     against its activation rows with __dp4a into exact int32 partials,
//     one per 32-row sub-chunk;
//   * epilogue_w4_kernel sums a group's sub-chunk partials in int32 (exact, so
//     the order does not matter), then the groups in group order in
//     float32: y += float(dot_g) * (xs[b, g] * g[g, n]); the
//     out-projection takes each head's (two sub-chunks') dot, its scale
//     asx[b, h] and its group row of go, with no `so`;
//   * the attention tier quantizes its output per head, as a8 does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLK = 128;        // positions per cold block and in the tail
constexpr int STAGE = 8;        // bf16 stage rows
constexpr int DH = 64;          // head_dim
constexpr int AT = 128;         // attention threads: one per block row
constexpr float NEG_INF = -1e30f;
constexpr int RT = 256;         // rows_kernel threads
constexpr int DT = 64;          // dense_kernel threads
constexpr int DCOLS = 4 * DT;   // columns per dense block
constexpr int BT = 8;           // batch rows per dense block
constexpr int ET = 256;         // epilogue threads

enum Epi { EPI_OUT = 0, EPI_GELU = 1, EPI_RESID = 2 };

// ---------------------------------------------------------------- helpers
template <int NT>
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();                       // red may still be read
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < NT / 32; ++w) v = fmaxf(v, red[w]);
  return v;
}

template <int NT>
__device__ __forceinline__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < NT / 32; ++w) v += red[w];
  return v;
}

__device__ __forceinline__ int8_t quant(float v, float scale) {
  return (int8_t)__float2int_rn(__fdiv_rn(v, scale));
}

// max(amax, floor) / 127
__device__ __forceinline__ float qscale(float amax, float floor_) {
  return __fdiv_rn(fmaxf(amax, floor_), 127.f);
}

// Abramowitz-Stegun 7.1.26, operation by operation as in
// vae_gslm_tpu/ops/mega_step.py::_erf.
__device__ __forceinline__ float erf_rational(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f;
  const float a4 = -1.453152027f, a5 = 1.061405429f, pp = 0.3275911f;
  const float sign = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(pp, ax)));
  float p = __fadd_rn(__fmul_rn(a5, t), a4);
  p = __fadd_rn(__fmul_rn(p, t), a3);
  p = __fadd_rn(__fmul_rn(p, t), a2);
  p = __fadd_rn(__fmul_rn(p, t), a1);
  p = __fmul_rn(p, t);
  const float y = __fsub_rn(1.f, __fmul_rn(p, expf(__fmul_rn(-ax, ax))));
  return __fmul_rn(sign, y);
}

__device__ __forceinline__ float gelu(float x) {
  const float c = 0.70710678118654752f;   // float32(1 / sqrt(2))
  return __fmul_rn(__fmul_rn(0.5f, x),
                   __fadd_rn(1.f, erf_rational(__fmul_rn(x, c))));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ------------------------------------------------------------ 1. rows
// r = 1 / sqrt(sum(x^2) / K + 1e-6) of one row, the squares summed in
// float64
__device__ __forceinline__ float row_rms(const float* __restrict__ xr,
                                         int K, double* dred) {
  double ss = 0.0;
  for (int k = threadIdx.x; k < K; k += RT) {
    const float v = xr[k];
    ss += (double)__fmul_rn(v, v);
  }
  const float ms = __fdiv_rn(__double2float_rn(block_sum<RT>(ss, dred)),
                             (float)K);
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(ms, 1e-6f)));
}

// One block per batch row of K values.  With `norm`, h = (x * r) * norm
// (r from row_rms); else h = x.  a8: q8 = round(h / xs), xs =
// max(|h|max, 1e-8) / 127, with xs written to xs_out[b * xs_stride];
// otherwise h goes to h_out.
__global__ void __launch_bounds__(RT)
rows_kernel(const float* __restrict__ x, const float* __restrict__ norm,
            int K, int a8, float* __restrict__ h_out,
            int8_t* __restrict__ q_out, float* __restrict__ xs_out,
            int xs_stride) {
  __shared__ double dred[RT / 32];
  __shared__ float fred[RT / 32];
  const int b = blockIdx.x;
  const float* xr = x + (size_t)b * K;
  const float r = norm ? row_rms(xr, K, dred) : 1.f;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += RT) {
    const float h = norm ? __fmul_rn(__fmul_rn(xr[k], r), norm[k]) : xr[k];
    if (a8) amax = fmaxf(amax, fabsf(h));
    else h_out[(size_t)b * K + k] = h;
  }
  if (!a8) return;
  const float xs = qscale(block_max<RT>(amax, fred), 1e-8f);
  for (int k = threadIdx.x; k < K; k += RT) {
    const float h = norm ? __fmul_rn(__fmul_rn(xr[k], r), norm[k]) : xr[k];
    q_out[(size_t)b * K + k] = quant(h, xs);
  }
  if (threadIdx.x == 0) xs_out[(size_t)b * xs_stride] = xs;
}

// w4: as rows_kernel's a8 mode with one xs per group of `group` values (a
// warp per group), written to xs_out[b * (K / group) + group index].
__global__ void __launch_bounds__(RT)
rows_w4_kernel(const float* __restrict__ x, const float* __restrict__ norm,
               int K, int group, int8_t* __restrict__ q_out,
               float* __restrict__ xs_out) {
  __shared__ double dred[RT / 32];
  const int b = blockIdx.x;
  const float* xr = x + (size_t)b * K;
  const float r = norm ? row_rms(xr, K, dred) : 1.f;
  const int G = K / group, lane = threadIdx.x & 31;
  for (int gi = threadIdx.x >> 5; gi < G; gi += RT / 32) {
    const int k0 = gi * group;
    float amax = 0.f;
    for (int k = k0 + lane; k < k0 + group; k += 32) {
      const float h = norm ? __fmul_rn(__fmul_rn(xr[k], r), norm[k]) : xr[k];
      amax = fmaxf(amax, fabsf(h));
    }
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float xs = qscale(amax, 1e-8f);
    for (int k = k0 + lane; k < k0 + group; k += 32) {
      const float h = norm ? __fmul_rn(__fmul_rn(xr[k], r), norm[k]) : xr[k];
      q_out[(size_t)b * K + k] = quant(h, xs);
    }
    if (lane == 0) xs_out[(size_t)b * G + gi] = xs;
  }
}

// ----------------------------------------------------------- 2. dense
// part[s, b, n] = sum over k in chunk s of act[b, k] * w[k, n], for the
// block's 256 columns, 8 batch rows and chunk s = blockIdx.y of KC rows.
// a8: int8 x int8 in int32.  bf16: bf16(act) x int8 in float64.
__device__ __forceinline__ void transpose4(int w0, int w1, int w2, int w3,
                                           int c[4]) {
  const int lo01 = __byte_perm(w0, w1, 0x5140);
  const int hi01 = __byte_perm(w0, w1, 0x7362);
  const int lo23 = __byte_perm(w2, w3, 0x5140);
  const int hi23 = __byte_perm(w2, w3, 0x7362);
  c[0] = __byte_perm(lo01, lo23, 0x5410);  // column 0: rows 0..3
  c[1] = __byte_perm(lo01, lo23, 0x7632);
  c[2] = __byte_perm(hi01, hi23, 0x5410);
  c[3] = __byte_perm(hi01, hi23, 0x7632);
}

// the four signed 4-bit values in the hi (or lo) nibbles of w's bytes, as
// four signed bytes: per byte, (nibble ^ 8) - 8 without carries
__device__ __forceinline__ int nibbles(int w, bool hi) {
  const unsigned u = (hi ? (unsigned)w >> 4 : (unsigned)w) & 0x0F0F0F0Fu;
  return (int)__vsub4(u ^ 0x08080808u, 0x08080808u);
}

// the four signed bytes of w as exact floats: (byte ^ 0x80) placed in the
// mantissa of 2^23, minus 2^23 + 128
__device__ __forceinline__ void bytes_to_float(int w, float f[4]) {
  const int u = w ^ 0x80808080;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __int_as_float(__byte_perm(u, 0x4B000000, 0x7440 | j)) -
           8388736.f;
}

__global__ void __launch_bounds__(DT)
dense_kernel(const int8_t* __restrict__ act8, const float* __restrict__ actf,
             const int8_t* __restrict__ w, int B, int K, int N, int KC,
             int a8, void* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * DCOLS + threadIdx.x * 4;
  const int s = blockIdx.y;
  const int k0 = s * KC;
  const int b0 = blockIdx.z * BT;
  const int bt = min(BT, B - b0);
  const int8_t* wp = w + (size_t)k0 * N + n0;
  if (a8) {
    int8_t* xs = reinterpret_cast<int8_t*>(smem);          // [BT][KC]
    for (int i = threadIdx.x; i < BT * KC; i += DT) {
      const int bb = i / KC, k = i % KC;
      xs[i] = bb < bt ? act8[(size_t)(b0 + bb) * K + k0 + k] : 0;
    }
    __syncthreads();
    int acc[BT][4] = {};
#pragma unroll 4
    for (int k = 0; k < KC; k += 4) {
      int c[4];
      transpose4(*reinterpret_cast<const int*>(wp + (size_t)k * N),
                 *reinterpret_cast<const int*>(wp + (size_t)(k + 1) * N),
                 *reinterpret_cast<const int*>(wp + (size_t)(k + 2) * N),
                 *reinterpret_cast<const int*>(wp + (size_t)(k + 3) * N), c);
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) {
        const int xp = *reinterpret_cast<const int*>(xs + bb * KC + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[bb][j] = __dp4a(xp, c[j], acc[bb][j]);
      }
    }
    int* out = static_cast<int*>(part);
    for (int bb = 0; bb < bt; ++bb)
      *reinterpret_cast<int4*>(out + ((size_t)s * B + b0 + bb) * N + n0) =
          make_int4(acc[bb][0], acc[bb][1], acc[bb][2], acc[bb][3]);
  } else {
    float* xs = reinterpret_cast<float*>(smem);            // [BT][KC]
    for (int i = threadIdx.x; i < BT * KC; i += DT) {
      const int bb = i / KC, k = i % KC;
      xs[i] = bb < bt ? bf16_round(actf[(size_t)(b0 + bb) * K + k0 + k])
                      : 0.f;
    }
    __syncthreads();
    // Summed in float64, like the plain version: bf16 x int8 products are
    // exact, and their float64 sum is exact unless the terms span more
    // than about 2^38, so both sides round the same sum once whatever
    // their order.  (A float32 sum in another order flipped bf16
    // roundings of k_new over 16 layers.)
    double acc[BT][4] = {};
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float f[4];
      bytes_to_float(*reinterpret_cast<const int*>(wp + (size_t)k * N), f);
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) {
        const double xv = xs[bb * KC + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[bb][j] = fma(xv, (double)f[j],
                                                     acc[bb][j]);
      }
    }
    double* out = static_cast<double*>(part);
    for (int bb = 0; bb < bt; ++bb) {
      double2* o = reinterpret_cast<double2*>(
          out + ((size_t)s * B + b0 + bb) * N + n0);
      o[0] = make_double2(acc[bb][0], acc[bb][1]);
      o[1] = make_double2(acc[bb][2], acc[bb][3]);
    }
  }
}

// ------------------------------------------------------ 2a. dense, w4
// Nibble-packed weights (K/2, N): packed row r holds logical row r in its
// hi nibble and row K/2 + r in its lo nibble.  A block takes 256 columns,
// 8 batch rows and the PKC packed rows [p0, p0 + PKC), p0 = blockIdx.y *
// PKC, reading each byte once, and writes the int32 sums of its two
// logical sub-chunks: rows p0.. to part[p0 / PKC], rows K/2 + p0.. to
// part[(K/2 + p0) / PKC] (part[c, b, n], one c per PKC logical rows).
constexpr int PKC = 32;

__global__ void __launch_bounds__(DT)
dense_w4_kernel(const int8_t* __restrict__ act8, const int8_t* __restrict__ w,
                int B, int K, int N, int* __restrict__ part) {
  __shared__ __align__(16) int8_t xs[2][BT][PKC];
  const int n0 = blockIdx.x * DCOLS + threadIdx.x * 4;
  const int p0 = blockIdx.y * PKC, half = K / 2;
  const int b0 = blockIdx.z * BT;
  const int bt = min(BT, B - b0);
  for (int i = threadIdx.x; i < 2 * BT * PKC; i += DT) {
    const int hl = i / (BT * PKC), bb = i / PKC % BT, k = i % PKC;
    xs[hl][bb][k] =
        bb < bt ? act8[(size_t)(b0 + bb) * K + hl * half + p0 + k] : 0;
  }
  __syncthreads();
  const int8_t* wp = w + (size_t)p0 * N + n0;
  int acc[2][BT][4] = {};
#pragma unroll 2
  for (int k = 0; k < PKC; k += 4) {
    int r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = *reinterpret_cast<const int*>(wp + (size_t)(k + j) * N);
#pragma unroll
    for (int hl = 0; hl < 2; ++hl) {
      int c[4];
      transpose4(nibbles(r[0], hl == 0), nibbles(r[1], hl == 0),
                 nibbles(r[2], hl == 0), nibbles(r[3], hl == 0), c);
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) {
        const int xp = *reinterpret_cast<const int*>(&xs[hl][bb][k]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[hl][bb][j] = __dp4a(xp, c[j], acc[hl][bb][j]);
      }
    }
  }
  const size_t c_lo = (size_t)(half + p0) / PKC;
  for (int hl = 0; hl < 2; ++hl)
    for (int bb = 0; bb < bt; ++bb)
      *reinterpret_cast<int4*>(
          part + (((hl ? c_lo : p0 / PKC)) * B + b0 + bb) * N + n0) =
          make_int4(acc[hl][bb][0], acc[hl][bb][1], acc[hl][bb][2],
                    acc[hl][bb][3]);
}

// -------------------------------------------------------- 2b. epilogue
// out = y + bias (EPI_OUT), gelu(y + bias) (EPI_GELU) or x = (x + y) + bias
// (EPI_RESID)
__device__ __forceinline__ void epi_store(float y, const float* bias,
                                          int op, float* out, int i, int n) {
  if (op == EPI_OUT)
    out[i] = __fadd_rn(y, bias[n]);
  else if (op == EPI_GELU)
    out[i] = gelu(__fadd_rn(y, bias[n]));
  else
    out[i] = __fadd_rn(__fadd_rn(out[i], y), bias[n]);
}

// y[b, n] from the S partial sums, then epi_store:
//   a8, per-row scale:  y = float(sum_s part) * (ascale[b*H] * col[n])
//   a8, per-head scale: y = (sum_s float(part_s) * ascale[b*H + s]) * col[n]
//   bf16:               y = float(sum_s part_s) * col[n], the float64
//                       partials summed in float64 (per-head: each partial
//                       rounded to float32 first, then summed in order)
__global__ void __launch_bounds__(ET)
epilogue_kernel(const void* __restrict__ part, int S, int B, int N, int a8,
                int per_head, const float* __restrict__ ascale, int H,
                const float* __restrict__ col, const float* __restrict__ bias,
                int op, float* __restrict__ out) {
  const int i = blockIdx.x * ET + threadIdx.x;
  if (i >= B * N) return;
  const int b = i / N, n = i % N;
  const size_t stride = (size_t)B * N;
  float y;
  if (a8 && !per_head) {
    const int* p = static_cast<const int*>(part) + i;
    int acc = 0;
    for (int s = 0; s < S; ++s) acc += p[s * stride];
    y = __fmul_rn(__int2float_rn(acc),
                  __fmul_rn(ascale[(size_t)b * H], col[n]));
  } else if (a8) {
    const int* p = static_cast<const int*>(part) + i;
    y = 0.f;
    for (int s = 0; s < S; ++s)
      y = __fadd_rn(y, __fmul_rn(__int2float_rn(p[s * stride]),
                                 ascale[(size_t)b * H + s]));
    y = __fmul_rn(y, col[n]);
  } else if (!per_head) {
    const double* p = static_cast<const double*>(part) + i;
    double acc = 0.0;
    for (int s = 0; s < S; ++s) acc += p[s * stride];
    y = __fmul_rn(__double2float_rn(acc), col[n]);
  } else {
    const double* p = static_cast<const double*>(part) + i;
    y = 0.f;
    for (int s = 0; s < S; ++s)
      y = __fadd_rn(y, __double2float_rn(p[s * stride]));
    y = __fmul_rn(y, col[n]);
  }
  epi_store(y, bias, op, out, i, n);
}

// w4: S scale units (groups, or heads in the out-projection) of NSUB
// partials each; dot_s = the int32 sum of unit s's partials, then y =
// sum_s float(dot_s) * (ascale[b*S + s] * gscale[(s / gdiv) * N + n]) in
// unit order, no column scale (gdiv = group / 64 for heads, else 1).
// The loads of EU units (EU * NSUB partials and their scales) are issued
// before their in-order float32 sum, so that many are in flight at once:
// a thread's loads are the kernel's time, and at B = 8 the FFN-down
// epilogue has only 32 blocks for 128 partials per thread.  On the H100,
// 4 units ran ahead of 8 and of a plain loop under `#pragma unroll`
// (scripts/mega_ab.py).
constexpr int EU = 4;

template <int NSUB>
__global__ void __launch_bounds__(ET)
epilogue_w4_kernel(const int* __restrict__ part, int S, int B, int N,
                   const float* __restrict__ ascale,
                   const float* __restrict__ gscale, int gdiv,
                   const float* __restrict__ bias, int op,
                   float* __restrict__ out) {
  const int i = blockIdx.x * ET + threadIdx.x;
  if (i >= B * N) return;
  const int b = i / N, n = i % N;
  const size_t stride = (size_t)B * N;
  const int* p = part + i;
  const float* as = ascale + (size_t)b * S;
  const float* gs = gscale + n;
  float y = 0.f;
  int s0 = 0;
  for (; s0 + EU <= S; s0 += EU) {
    int dot[EU];
    float sc[EU];
#pragma unroll
    for (int u = 0; u < EU; ++u) {
      const int s = s0 + u;
      int d = 0;
#pragma unroll
      for (int j = 0; j < NSUB; ++j) d += p[(size_t)(s * NSUB + j) * stride];
      dot[u] = d;
      sc[u] = __fmul_rn(as[s], gs[(size_t)(s / gdiv) * N]);
    }
#pragma unroll
    for (int u = 0; u < EU; ++u)
      y = __fadd_rn(y, __fmul_rn(__int2float_rn(dot[u]), sc[u]));
  }
  for (int s = s0; s < S; ++s) {          // fewer than EU units left
    int d = 0;
#pragma unroll
    for (int j = 0; j < NSUB; ++j) d += p[(size_t)(s * NSUB + j) * stride];
    y = __fadd_rn(y, __fmul_rn(__int2float_rn(d),
                               __fmul_rn(as[s], gs[(size_t)(s / gdiv) * N])));
  }
  epi_store(y, bias, op, out, i, n);
}

// ------------------------------------------------------- 3. attention
struct AttnArgs {
  const float* qkv;            // (B, 3D)
  const int8_t* k_cold;        // this layer's (NB, H, B, DH, BLK)
  const int8_t* v_cold;
  const float* kc_scale;       // this layer's (NB, H, B, BLK)
  const float* vc_scale;
  const int8_t* k_tail;        // this layer's (H, B, BLK, DH)
  const int8_t* v_tail;
  const float* kt_scale;       // this layer's (H, B, BLK)
  const float* vt_scale;
  const __nv_bfloat16* k_stage;  // this layer's (STAGE, H, B, DH)
  const __nv_bfloat16* v_stage;
  const float* slopes;         // (H,)
  __nv_bfloat16* k_new;        // this layer's (H, B, DH)
  __nv_bfloat16* v_new;
  int8_t* out8;                // a8: (B, D) int8 and asx (B, H)
  float* asx;
  float* outf;                 // bf16 branch: (B, D) float32
  int B, H, D, nblk, pos, flushed, a8;
  float scale;                 // 1 / sqrt(DH)
};

struct AttnState {
  float m, l;                  // running max and denominator (all threads)
  float acc;                   // output channel d = tid (tid < DH)
};

// Merge one 128-row block of logits (thread t holds row t's logit s and
// V scale vs) into the state.  V is int8, (DH, BLK) time-minor for a cold
// block, (BLK, DH) for the tail.
__device__ __forceinline__ void merge_i8(AttnState& st, float s, float vs,
                                         const int8_t* v, bool time_minor,
                                         float* fred, double* dred,
                                         int8_t* u8, int* avred) {
  const int tid = threadIdx.x;
  const float m_new = fmaxf(st.m, block_max<AT>(s, fred));
  const float corr = expf(__fsub_rn(st.m, m_new));
  const float e = expf(__fsub_rn(s, m_new));
  const float esum = __double2float_rn(block_sum<AT>((double)e, dred));
  st.l = __fadd_rn(__fmul_rn(st.l, corr), esum);
  const float u = __fmul_rn(e, vs);
  const float u_scale = qscale(block_max<AT>(u, fred), 1e-20f);
  u8[tid] = quant(u, u_scale);
  __syncthreads();
  // thread (d = tid % 64, part = tid / 64) sums 64 rows of channel d
  const int d = tid % DH, part = tid / DH;
  int av = 0;
  if (time_minor) {                      // row d: 64 contiguous bytes
    const int4* r = reinterpret_cast<const int4*>(v + d * BLK + part * DH);
    const int* up = reinterpret_cast<const int*>(u8 + part * DH);
    for (int i = 0; i < DH / 16; ++i) {
      const int4 vv = r[i];
      av = __dp4a(up[4 * i], vv.x, av);
      av = __dp4a(up[4 * i + 1], vv.y, av);
      av = __dp4a(up[4 * i + 2], vv.z, av);
      av = __dp4a(up[4 * i + 3], vv.w, av);
    }
  } else {                               // column d, coalesced over d
    for (int t = part * DH; t < (part + 1) * DH; ++t)
      av += (int)u8[t] * (int)v[t * DH + d];
  }
  if (part == 1) avred[d] = av;
  __syncthreads();
  if (part == 0)
    st.acc = __fadd_rn(__fmul_rn(st.acc, corr),
                       __fmul_rn(__int2float_rn(av + avred[d]), u_scale));
  st.m = m_new;
  __syncthreads();                       // u8 / avred are rewritten next
}

__global__ void __launch_bounds__(AT) attn_kernel(AttnArgs a) {
  __shared__ float qf[DH], kc[DH], vc[DH];
  __shared__ __align__(16) int8_t q8[DH];
  __shared__ __align__(16) int8_t u8[AT];
  __shared__ int avred[DH];
  __shared__ float fred[AT / 32];
  __shared__ double dred[AT / 32];
  __shared__ float s_st[STAGE];

  const int tid = threadIdx.x;
  const int h = blockIdx.x / a.B, b = blockIdx.x % a.B;
  const size_t hb = (size_t)h * a.B + b;
  const float slope = a.slopes[h];
  const float* row = a.qkv + (size_t)b * 3 * a.D + h * DH;
  if (tid < DH) {
    qf[tid] = row[tid];
    kc[tid] = row[a.D + tid];
    vc[tid] = row[2 * a.D + tid];
    a.k_new[hb * DH + tid] = __float2bfloat16_rn(kc[tid]);
    a.v_new[hb * DH + tid] = __float2bfloat16_rn(vc[tid]);
  }
  __syncthreads();
  const float q_scale =
      qscale(block_max<AT>(tid < DH ? fabsf(qf[tid]) : 0.f, fred), 1e-8f);
  if (tid < DH) q8[tid] = quant(qf[tid], q_scale);
  __syncthreads();
  const float qs = __fmul_rn(q_scale, a.scale);
  const int* q8p = reinterpret_cast<const int*>(q8);
  const int stage_base = a.pos - (a.pos - a.flushed) % STAGE;
  AttnState st{NEG_INF, 0.f, 0.f};

  // ---- cold blocks: (DH, BLK) time-minor planes, read byte-wise
  for (int i = 0; i < a.nblk; ++i) {
    const size_t plane = (size_t)i * a.H * a.B + hb;
    const int8_t* k = a.k_cold + plane * DH * BLK + tid;
    int acc = 0;
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      const int8_t* p = k + (size_t)(4 * d4) * BLK;
      const int packed = (int)(uint8_t)p[0] | ((int)(uint8_t)p[BLK] << 8) |
                         ((int)(uint8_t)p[2 * BLK] << 16) |
                         ((int)(uint8_t)p[3 * BLK] << 24);
      acc = __dp4a(q8p[d4], packed, acc);
    }
    const int t = i * BLK + tid;
    float s = __fmul_rn(__fmul_rn((float)acc, qs),
                        a.kc_scale[plane * BLK + tid]);
    s = __fadd_rn(s, __fmul_rn(slope, (float)abs(t - a.pos)));
    merge_i8(st, s, a.vc_scale[plane * BLK + tid],
             a.v_cold + plane * DH * BLK, true, fred, dred, u8, avred);
  }

  // ---- tail: (BLK, DH) rows, valid below stage_base
  {
    const int4* kr = reinterpret_cast<const int4*>(
        a.k_tail + (hb * BLK + tid) * DH);
    int acc = 0;
    for (int i = 0; i < DH / 16; ++i) {
      const int4 v = kr[i];
      acc = __dp4a(q8p[4 * i], v.x, acc);
      acc = __dp4a(q8p[4 * i + 1], v.y, acc);
      acc = __dp4a(q8p[4 * i + 2], v.z, acc);
      acc = __dp4a(q8p[4 * i + 3], v.w, acc);
    }
    const int t = a.flushed + tid;
    float s = __fmul_rn(__fmul_rn((float)acc, qs),
                        a.kt_scale[hb * BLK + tid]);
    s = __fadd_rn(s, __fmul_rn(slope, (float)abs(t - a.pos)));
    s = t < stage_base ? s : NEG_INF;
    merge_i8(st, s, a.vt_scale[hb * BLK + tid], a.v_tail + hb * BLK * DH,
             false, fred, dred, u8, avred);
  }

  // ---- stage: STAGE bf16 rows, valid at stage_base <= j < pos.  Warp w
  // takes rows w and w + 4; the dot is summed in float64.
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int j = warp; j < STAGE; j += AT / 32) {
      const __nv_bfloat16* kr = a.k_stage + ((size_t)j * a.H * a.B + hb) * DH;
      double dot = (double)__fmul_rn(qf[lane], __bfloat162float(kr[lane])) +
                   (double)__fmul_rn(qf[lane + 32],
                                     __bfloat162float(kr[lane + 32]));
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) {
        const int jj = stage_base + j;
        float s = __fmul_rn(__double2float_rn(dot), a.scale);
        s = __fadd_rn(s, __fmul_rn(slope, (float)abs(jj - a.pos)));
        s_st[j] = jj < a.pos ? s : NEG_INF;
      }
    }
    __syncthreads();
    float mx = s_st[0];
    for (int j = 1; j < STAGE; ++j) mx = fmaxf(mx, s_st[j]);
    const float m_new = fmaxf(st.m, mx);
    const float corr = expf(__fsub_rn(st.m, m_new));
    float e[STAGE];
    double esum = 0.0;
    for (int j = 0; j < STAGE; ++j) {
      e[j] = expf(__fsub_rn(s_st[j], m_new));
      esum += (double)e[j];
    }
    st.l = __fadd_rn(__fmul_rn(st.l, corr), __double2float_rn(esum));
    if (tid < DH) {
      double av = 0.0;
      for (int j = 0; j < STAGE; ++j)
        av += (double)__fmul_rn(
            e[j], __bfloat162float(
                      a.v_stage[((size_t)j * a.H * a.B + hb) * DH + tid]));
      st.acc = __fadd_rn(__fmul_rn(st.acc, corr), __double2float_rn(av));
    }
    st.m = m_new;
  }

  // ---- the current token (dot summed in float64), then acc / l
  const double dot = block_sum<AT>(
      tid < DH ? (double)__fmul_rn(qf[tid], kc[tid]) : 0.0, dred);
  const float s_self = __fmul_rn(__double2float_rn(dot), a.scale);
  const float m_f = fmaxf(st.m, s_self);
  const float corr = expf(__fsub_rn(st.m, m_f));
  const float e_self = expf(__fsub_rn(s_self, m_f));
  const float l_f = __fadd_rn(__fmul_rn(st.l, corr), e_self);
  float attn = 0.f;
  if (tid < DH)
    attn = __fdiv_rn(__fadd_rn(__fmul_rn(st.acc, corr),
                               __fmul_rn(e_self, vc[tid])),
                     l_f);
  const size_t o = (size_t)b * a.D + h * DH + tid;
  if (a.a8) {
    const float asx = qscale(block_max<AT>(fabsf(attn), fred), 1e-8f);
    if (tid < DH) a.out8[o] = quant(attn, asx);
    if (tid == 0) a.asx[(size_t)b * a.H + h] = asx;
  } else if (tid < DH) {
    a.outf[o] = attn;
  }
}

// ------------------------------------------------------------ launches
// K-input product: the int8/bf16 split-K kernel in chunks of KC rows, or
// (w4) the nibble kernel in PKC-row sub-chunks
int dense(const int8_t* act8, const float* actf, const int8_t* w, int B,
          int K, int N, int KC, int a8, int w4, void* part, cudaStream_t st) {
  if (w4) {
    const dim3 grid(N / DCOLS, K / 2 / PKC, (B + BT - 1) / BT);
    dense_w4_kernel<<<grid, DT, 0, st>>>(act8, w, B, K, N,
                                         static_cast<int*>(part));
    return (int)cudaGetLastError();
  }
  const dim3 grid(N / DCOLS, K / KC, (B + BT - 1) / BT);
  const size_t smem = (size_t)BT * KC * (a8 ? 1 : 4);
  dense_kernel<<<grid, DT, smem, st>>>(act8, actf, w, B, K, N, KC, a8, part);
  return (int)cudaGetLastError();
}

// the split-K partials' epilogue; w4 (gscale set): the group-scale
// epilogue with nsub partials per unit, 2 (group 64, or a head) or 4
// (group 128)
int epilogue(const void* part, int S, int B, int N, int a8, int per_head,
             const float* ascale, int H, const float* col,
             const float* gscale, int gdiv, int nsub, const float* bias,
             int op, float* out, cudaStream_t st) {
  const int nblk = (B * N + ET - 1) / ET;
  const int* p32 = static_cast<const int*>(part);
  if (!gscale)
    epilogue_kernel<<<nblk, ET, 0, st>>>(part, S, B, N, a8, per_head, ascale,
                                         H, col, bias, op, out);
  else if (nsub == 2)
    epilogue_w4_kernel<2><<<nblk, ET, 0, st>>>(p32, S, B, N, ascale, gscale,
                                               gdiv, bias, op, out);
  else if (nsub == 4)
    epilogue_w4_kernel<4><<<nblk, ET, 0, st>>>(p32, S, B, N, ascale, gscale,
                                               gdiv, bias, op, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// RMSNorm / quantization of B rows: per row, or (group > 0) per group
int rows(const float* x, const float* norm, int B, int K, int a8, int group,
         float* h_out, int8_t* q_out, float* xs_out, int xs_stride,
         cudaStream_t st) {
  if (group)
    rows_w4_kernel<<<B, RT, 0, st>>>(x, norm, K, group, q_out, xs_out);
  else
    rows_kernel<<<B, RT, 0, st>>>(x, norm, K, a8, h_out, q_out, xs_out,
                                  xs_stride);
  return (int)cudaGetLastError();
}

#define CHECK(call)                  \
  do {                               \
    const int err_ = (call);         \
    if (err_ != 0) return err_;      \
  } while (0)

}  // namespace

// One trunk step for all L layers.  Shapes and layouts as in the wrapper,
// vae_gslm_tpu_torch/ops/mega_step.py; `work` is its workspace_bytes(B, D,
// H) bytes of scratch.  Requires head_dim 64, D a multiple of 256.  With
// group > 0 (the w4 branch; 64 or 128, dividing D / 2) wq/wo/w1/w2
// are nibble-packed and gq/go/g1/g2 their group scales; sq/so/s1/s2 and
// a8 are then not read.
extern "C" int fused_trunk_step_launch(
    const void* x, void* x_out, const void* wq, const void* wo,
    const void* w1, const void* w2, const void* sq, const void* so,
    const void* s1, const void* s2, const void* n1, const void* n3,
    const void* bq, const void* bo, const void* b1, const void* b2,
    const void* slopes, const void* k_cold, const void* v_cold,
    const void* kc_scale, const void* vc_scale, const void* k_tail,
    const void* v_tail, const void* kt_scale, const void* vt_scale,
    const void* k_stage, const void* v_stage, void* k_new, void* v_new,
    void* work, const void* gq, const void* go, const void* g1,
    const void* g2, int L, int B, int D, int H, int nb_cap, int pos,
    int flushed, int a8, int group, float scale, void* stream) {
  if (group != 0 && group != 64 && group != 128)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t BD = (size_t)B * D;
  const int pmax = D / 16 > H ? D / 16 : H;
  void* part = work;                      // int32 (a8) or float64 partials
  float* qkv = reinterpret_cast<float*>(static_cast<double*>(work) +
                                        BD * pmax);
  float* g = qkv + 3 * BD;
  float* actf = g + 4 * BD;
  int8_t* act8 = reinterpret_cast<int8_t*>(actf + 4 * BD);
  float* ascale = reinterpret_cast<float*>(act8 + 4 * BD);
  float* xo = static_cast<float*>(x_out);
  CHECK((int)cudaMemcpyAsync(xo, x, BD * sizeof(float),
                             cudaMemcpyDeviceToDevice, st));

  const auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const auto bf = [](const void* p) {
    return static_cast<const __nv_bfloat16*>(p);
  };
  const size_t hbd = (size_t)H * B * DH;           // one layer's K/V rows
  const size_t cold = (size_t)nb_cap * H * B * BLK;  // one layer's cold rows
  const size_t tail = (size_t)H * B * BLK;
  const int D3 = 3 * D, D4 = 4 * D;
  const int w4 = group > 0;
  const int q8 = a8 || w4;               // int8 activations
  const int wrows = w4 ? D / 2 : D;      // stored rows of a D-input weight
  // scale units per product: groups (w4) or split-K chunks of 64 (128 for
  // the 4D-input FFN-down), and w4's partials per unit
  const int kc = w4 ? group : 64, kc2 = w4 ? group : 128;
  const int nsub = w4 ? group / PKC : 1;
  const auto gs = [&](const void* p, size_t din, size_t dout, int li) {
    return w4 ? f32(p) + (size_t)li * (din / group) * dout : nullptr;
  };
  for (int li = 0; li < L; ++li) {
    // 1-2. RMSNorm, QKV
    CHECK(rows(xo, f32(n1) + (size_t)li * D, B, D, q8, group, actf, act8,
               ascale, H, st));
    CHECK(dense(act8, actf, i8(wq) + (size_t)li * wrows * D3, B, D, D3, kc,
                a8, w4, part, st));
    CHECK(epilogue(part, D / kc, B, D3, q8, 0, ascale, H,
                   f32(sq) + (size_t)li * D3, gs(gq, D, D3, li), 1, nsub,
                   f32(bq) + (size_t)li * D3, EPI_OUT, qkv, st));
    // 3. attention
    AttnArgs aa{qkv,
                i8(k_cold) + (size_t)li * cold * DH,
                i8(v_cold) + (size_t)li * cold * DH,
                f32(kc_scale) + (size_t)li * cold,
                f32(vc_scale) + (size_t)li * cold,
                i8(k_tail) + (size_t)li * tail * DH,
                i8(v_tail) + (size_t)li * tail * DH,
                f32(kt_scale) + (size_t)li * tail,
                f32(vt_scale) + (size_t)li * tail,
                bf(k_stage) + (size_t)li * STAGE * hbd,
                bf(v_stage) + (size_t)li * STAGE * hbd,
                f32(slopes),
                static_cast<__nv_bfloat16*>(k_new) + (size_t)li * hbd,
                static_cast<__nv_bfloat16*>(v_new) + (size_t)li * hbd,
                act8, ascale, actf,
                B, H, D, flushed / BLK, pos, flushed, q8, scale};
    attn_kernel<<<H * B, AT, 0, st>>>(aa);
    CHECK((int)cudaGetLastError());
    // 4. out-projection, one K chunk per head; residual
    CHECK(dense(act8, actf, i8(wo) + (size_t)li * wrows * D, B, D, D, DH,
                a8, w4, part, st));
    CHECK(epilogue(part, H, B, D, q8, 1, ascale, H,
                   f32(so) + (size_t)li * D, gs(go, D, D, li),
                   w4 ? group / DH : 1, DH / PKC, f32(bo) + (size_t)li * D,
                   EPI_RESID, xo, st));
    // 5. RMSNorm, FFN up, GELU
    CHECK(rows(xo, f32(n3) + (size_t)li * D, B, D, q8, group, actf, act8,
               ascale, H, st));
    CHECK(dense(act8, actf, i8(w1) + (size_t)li * wrows * D4, B, D, D4, kc,
                a8, w4, part, st));
    CHECK(epilogue(part, D / kc, B, D4, q8, 0, ascale, H,
                   f32(s1) + (size_t)li * D4, gs(g1, D, D4, li), 1, nsub,
                   f32(b1) + (size_t)li * D4, EPI_GELU, g, st));
    // 6. FFN down, residual
    if (q8)
      CHECK(rows(g, nullptr, B, D4, 1, group, nullptr, act8, ascale, H, st));
    CHECK(dense(act8, g, i8(w2) + (size_t)li * (D4 / (w4 ? 2 : 1)) * D, B,
                D4, D, kc2, a8, w4, part, st));
    CHECK(epilogue(part, D4 / kc2, B, D, q8, 0, ascale, H,
                   f32(s2) + (size_t)li * D, gs(g2, D4, D, li), 1, nsub,
                   f32(b2) + (size_t)li * D, EPI_RESID, xo, st));
  }
  return 0;
}
