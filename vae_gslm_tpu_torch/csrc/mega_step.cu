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
// Two designs.  The a8 branch (s8 x s8 products, the serving default at
// B <= 8) and the w4 branch run as one C call per step that issues, for
// each layer, these kernels in stream order:
//   1. rows_kernel: RMSNorm(x, n1), then per-row int8 quantization;
//   2. dense_kernel + epilogue_kernel: the QKV product plus bq.  The dense
//      kernel splits K into chunks (one grid row each) and writes partial
//      sums; the epilogue sums them in chunk order and applies the scales,
//      so the result does not depend on which block finishes first;
//   3. attn_kernel, one block per (h, b): cold blocks, the tail masked at
//      t < stage_base, the stage rows masked at stage_base <= j < pos,
//      then the current token; writes k_new/v_new in bf16 and the head's
//      output (int8 + per-head scale);
//   4. the out-projection, split by head: the epilogue sums heads 0..H-1
//      in order (dot_h * asx[b, h]), applies `so`, the residual and bo;
//   5. rows_kernel(x, n3), the FFN-up product, b1, the rational-erf GELU;
//   6. rows_kernel quantizes the GELU rows; the FFN-down product, b2, the
//      residual.
// Its dense products take __dp4a over four int8 weights of one column (a
// 4x4 byte transpose of four 32-bit row loads) in int32.  Each thread
// owns 4 columns and 8 batch rows; more rows take more grid rows.
//
// The bf16 branch (bf16 activations x int8 weights: every B > 8 call,
// such as the CLI's B = 32 chunks) is one cooperative launch per step,
// k2_bf16_step_kernel: one 512-thread block per SM (its grid is the
// occupancy x the SM count), 16 layers x 5 phases separated by a grid
// barrier (5 L - 1 per step): QKV, attention, out-projection, FFN up, FFN
// down.
//   * Dense products on the FP64 tensor cores (mma.m16n8k16.f64, twice
//     m8n8k4's rate on sm_90): the batch is M (tiles of 16 rows; rows
//     past B are zeros and never stored), the weights are N (units of 8
//     output columns).  A bf16 x int8 product is exact in float64 and
//     their float64 sum is exact unless its terms span about 2^38, so any
//     order of summation gives the parent's bits: a warp may take any k,
//     in any order, into any number of accumulators.
//   * A block owns units of 8 output columns over all K (unit u =
//     blockIdx + j G, so that out-projection and FFN down, 128 units at
//     D = 1024, still fill 128 SMs); TMA streams the 16-column strips
//     that hold them (16 x 256 boxes) into one of two shared-memory
//     slots, and the next product's weights are in flight while this one
//     runs (they do not depend on activations).  No partial sum leaves
//     the block: warps split K (or, in the out-projection, the heads) and
//     the block adds their float64 sums in shared memory.
//   * The RMSNorm of the B rows is folded into the product that reads it:
//     every block recomputes each row's 1/rms as rows_kernel sums it, and
//     the fragment loads apply it and round to bf16.  Attention and GELU
//     rows are written as the high words of their bf16 values as doubles.
//   * The epilogues keep the parent's operation order: the QKV bias; the
//     out-projection's per-head sums rounded to float32 and added in head
//     order, then `so`, the residual and bo; GELU(y + b1); (x + y) + b2.
//   * Attention is attn_kernel's body over (h, b) items, one per group of
//     128 threads (4 per block), the positions of an item in order (each
//     block of 128 is requantized against the running maximum there);
//     each cache block is copied to shared memory by 16-byte loads, the
//     next one in flight.
//   Bounds at B = 32 (position 351): 0.603 GB of weights, valid cache
//   rows and I/O, 0.180 ms at 3.35 TB/s; the exact-sum design's 12.88
//   GFLOP on the FP64 tensor cores, 0.192 ms at 67 TFLOP/s.  What holds
//   it far above them on the H100 (PERF.md): every block reads all B
//   activation rows of each product from L2, at 6-15 bytes a cycle a
//   block, each item's attention is a chain of dependent block merges,
//   and 79 grid barriers of about 1 us.
//
// Numerics that must match the reference (and are easy to get wrong):
//   * the online softmax is per 128-row block: each block's e*v_scale is
//     requantized against the running maximum AT THAT BLOCK, not a global
//     one (K1's structure cannot be reused as it is);
//   * products and sums are grouped as the reference groups them:
//     (s_i32 * (q_scale * scale)) * k_scale; a8: y * (xs * scale_col);
//     bf16: float(the float64 sum) * scale_col then + b; the a8
//     out-projection sums dot_h * asx[b, h] over heads in order, then *
//     so;
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

#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

// The high word of (double)bf16_round(v), whose low word is 0: the form
// in which the persistent step keeps the bf16 rows its products read.
__device__ __forceinline__ uint32_t bf16_hi(float v) {
  return (uint32_t)__double2hiint((double)bf16_round(v));
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
// (r from row_rms); else h = x.  q8 = round(h / xs), xs = max(|h|max,
// 1e-8) / 127, with xs written to xs_out[b * xs_stride].
__global__ void __launch_bounds__(RT)
rows_kernel(const float* __restrict__ x, const float* __restrict__ norm,
            int K, int8_t* __restrict__ q_out, float* __restrict__ xs_out,
            int xs_stride) {
  __shared__ double dred[RT / 32];
  __shared__ float fred[RT / 32];
  const int b = blockIdx.x;
  const float* xr = x + (size_t)b * K;
  const float r = norm ? row_rms(xr, K, dred) : 1.f;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += RT) {
    const float h = norm ? __fmul_rn(__fmul_rn(xr[k], r), norm[k]) : xr[k];
    amax = fmaxf(amax, fabsf(h));
  }
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
// block's 256 columns, 8 batch rows and chunk s = blockIdx.y of KC rows:
// int8 x int8 in int32.
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

__global__ void __launch_bounds__(DT)
dense_kernel(const int8_t* __restrict__ act8, const int8_t* __restrict__ w,
             int B, int K, int N, int KC, int* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * DCOLS + threadIdx.x * 4;
  const int s = blockIdx.y;
  const int k0 = s * KC;
  const int b0 = blockIdx.z * BT;
  const int bt = min(BT, B - b0);
  const int8_t* wp = w + (size_t)k0 * N + n0;
  int8_t* xs = reinterpret_cast<int8_t*>(smem);          // [BT][KC]
  for (int i = threadIdx.x; i < BT * KC; i += DT) {
    const int bb = i / KC, k = i % KC;
    xs[i] = bb < bt ? act8[(size_t)(b0 + bb) * K + k0 + k] : 0;
  }
  __syncthreads();
  int acc[BT][4] = {};
  // 32 weight rows a step, the next step's 32 in flight while this one's
  // are summed (KC is 64 or 128), so that many loads wait at once
  int r[32];
#pragma unroll
  for (int j = 0; j < 32; ++j)
    r[j] = *reinterpret_cast<const int*>(wp + (size_t)j * N);
  for (int k = 0; k < KC; k += 32) {
    int nx[32];
    if (k + 32 < KC) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        nx[j] = *reinterpret_cast<const int*>(wp + (size_t)(k + 32 + j) * N);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      int c[4];
      transpose4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3], c);
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) {
        const int xp =
            *reinterpret_cast<const int*>(xs + bb * KC + k + 4 * q);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[bb][j] = __dp4a(xp, c[j], acc[bb][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) r[j] = nx[j];
  }
  for (int bb = 0; bb < bt; ++bb)
    *reinterpret_cast<int4*>(part + ((size_t)s * B + b0 + bb) * N + n0) =
        make_int4(acc[bb][0], acc[bb][1], acc[bb][2], acc[bb][3]);
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

// y[b, n] from the S int32 partial sums, then epi_store:
//   per-row scale:  y = float(sum_s part) * (ascale[b*H] * col[n])
//   per-head scale: y = (sum_s float(part_s) * ascale[b*H + s]) * col[n]
__global__ void __launch_bounds__(ET)
epilogue_kernel(const int* __restrict__ part, int S, int B, int N,
                int per_head, const float* __restrict__ ascale, int H,
                const float* __restrict__ col, const float* __restrict__ bias,
                int op, float* __restrict__ out) {
  const int i = blockIdx.x * ET + threadIdx.x;
  if (i >= B * N) return;
  const int b = i / N, n = i % N;
  const size_t stride = (size_t)B * N;
  const int* p = part + i;
  float y;
  if (!per_head) {
    int acc = 0;
    for (int s = 0; s < S; ++s) acc += p[s * stride];
    y = __fmul_rn(__int2float_rn(acc),
                  __fmul_rn(ascale[(size_t)b * H], col[n]));
  } else {
    y = 0.f;
    for (int s = 0; s < S; ++s)
      y = __fadd_rn(y, __fmul_rn(__int2float_rn(p[s * stride]),
                                 ascale[(size_t)b * H + s]));
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
  int8_t* out8;                // (B, D) int8 and asx (B, H)
  float* asx;
  int B, H, D, nblk, pos, flushed;
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
  const float asx = qscale(block_max<AT>(fabsf(attn), fred), 1e-8f);
  if (tid < DH) a.out8[o] = quant(attn, asx);
  if (tid == 0) a.asx[(size_t)b * a.H + h] = asx;
}

// ------------------------------------------- 4. K2-bf16: one launch a step
// The bf16 branch (bf16 activations x int8 weights) as one cooperative
// launch per step: the design note at the top of the file.
constexpr int PT = 512;                 // threads of a persistent block
constexpr int PWARPS = PT / 32;
constexpr int PGROUPS = PT / AT;        // attention groups per block
constexpr int UW = 8;                   // output columns per unit (an M tile)
constexpr int UC = 16;                  // columns per weight strip: the TMA
                                        // box's 16-byte inner extent
constexpr int KBOX = 256;               // weight rows per TMA box
constexpr int UPP = 4;                  // units per product pass
constexpr int BROWS = 16;               // batch rows per tile (an M tile)
constexpr int BTP = 2;                  // batch tiles per pass
constexpr int PF = 2;                   // activation chunks loaded ahead
constexpr int SMEM_LIMIT = 232448;      // a block's most on an H100
constexpr int GROUP_SMEM = 17680;       // sizeof(GroupSmem)
constexpr double I8_MAGIC = 4503599627370624.0;   // 2^52 + 128

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}
__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}

// The step's dynamic shared memory, laid out for G blocks: 1024 bytes of
// alignment slack; two weight slots, each the most units that a block
// takes of one product (QKV, out-projection, FFN up, FFN down) x a
// 16-column strip x K rows of int8; one region that the dense phases
// use for the products' partial sums (float64 per warp K-split, or
// float32 per head for the out-projection) and the RMSNorm scale, and
// the attention phase for PGROUPS GroupSmem scratches; each batch row's
// 1/rms; two mbarriers.  ops/mega_step.py's bf16_step_plan computes the
// same.
struct StepPlan {
  int slot, part, region, rows, bytes;
};
__host__ __device__ inline StepPlan step_plan(int B, int D, int H, int G) {
  const int pn[4] = {3 * D, D, 4 * D, D}, pk[4] = {D, D, D, 4 * D};
  int slot = 0;
  for (int i = 0; i < 4; ++i)
    slot = imax(slot, cdiv(pn[i] / UW, G) * UC * pk[i]);
  slot = cdiv(slot, 1024) * 1024;
  const int btp = imin(cdiv(B, BROWS), BTP), ks = PWARPS / btp;
  const int sums = ks * btp * BROWS * UPP * UW * 8;
  const int heads = H * btp * BROWS * imin(cdiv(D / UW, G), UPP) * UW * 4;
  const int part = cdiv(imax(sums, heads), 16) * 16;
  const int region = imax(part + 4 * D, PGROUPS * GROUP_SMEM);
  const int rows = cdiv(B, 4) * 16;
  return {slot, part, region, rows,
          1024 + 2 * slot + region + rows + 16};
}

struct StepArgs {
  const float* x;              // (B, D) in
  float* xo;                   // (B, D) out: the residual rows
  const float *sq, *so, *s1, *s2, *n1, *n3, *bq, *bo, *b1, *b2;  // (L, n)
  AttnArgs att;                // layer 0's attention arguments
  float* qkv;                  // (B, 3D): att.qkv, written here
  uint32_t* ah;                // (B, D) attention rows, bf16 high words
  uint32_t* gh;                // (B, 4D) GELU rows, bf16 high words
  unsigned* bar;               // the grid barrier's count, zeroed by the
                               // launcher
  unsigned long long* trace;   // null, or 1 + 5 L phase-end times (ns)
  int L, nb_cap;
  StepPlan plan;               // laid out for one block per SM
};

// Layer li's attention arguments from layer 0's.
__host__ __device__ inline AttnArgs attn_layer(AttnArgs a, int li,
                                               int nb_cap) {
  const size_t hbd = (size_t)a.H * a.B * DH;
  const size_t cold = (size_t)nb_cap * a.H * a.B * BLK;
  const size_t tail = (size_t)a.H * a.B * BLK;
  a.k_cold += li * cold * DH;
  a.v_cold += li * cold * DH;
  a.kc_scale += li * cold;
  a.vc_scale += li * cold;
  a.k_tail += li * tail * DH;
  a.v_tail += li * tail * DH;
  a.kt_scale += li * tail;
  a.vt_scale += li * tail;
  a.k_stage += li * STAGE * hbd;
  a.v_stage += li * STAGE * hbd;
  a.k_new += li * hbd;
  a.v_new += li * hbd;
  return a;
}

// ---- shared memory, TMA, barriers
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
// One 16-column x 256-row box of a weight stack (columns from col, rows
// from k, layer li) into shared memory at dst: rows of 16 bytes.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int col, int k,
                                        int li) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(k),
      "r"(li)
      : "memory");
}

// ---- the grid barrier
// Every block of the cooperative grid arrives with one release add to
// *bar, a word of the call's scratch that the launcher zeroes, and waits
// until it reads the barrier's arrivals, `target` (G more each barrier);
// writes before it are visible after it.  With cooperative groups' grid
// sync (an atom add and a flip bit on the driver's word) in its place
// the step read 1.5261 and 1.5443 ms against this one's 1.5016 and
// 1.4998 (scripts/mega_ab.py in one call, B = 32; PERF.md).
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(bar)
                 : "memory");
    unsigned now;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(now)
                   : "l"(bar)
                   : "memory");
    } while (now < target);
  }
  __syncthreads();
}

// ---- attention: (h, b) items, one per group of AT threads
// A group's shared scratch: attn_kernel's, and the K and V of the block
// being merged (a cold block's (DH, BLK) planes or the tail's (BLK, DH)
// rows), 8 KB each.
struct __align__(16) GroupSmem {
  float qf[DH], kc[DH], vc[DH];
  int avred[DH];
  double dred[AT / 32];
  float fred[AT / 32];
  float s_st[STAGE];
  int8_t q8[DH];
  int8_t u8[AT];
  int8_t k[BLK * DH], v[BLK * DH];
};
static_assert(sizeof(GroupSmem) == GROUP_SMEM, "bf16_step_plan mirrors it");

// block_max / block_sum over one group (named barrier `id`)
__device__ __forceinline__ void group_bar(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(AT) : "memory");
}
__device__ __forceinline__ float group_max(float v, float* red, int id) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  group_bar(id);                         // red may still be read
  if ((threadIdx.x & 31) == 0) red[(threadIdx.x % AT) >> 5] = v;
  group_bar(id);
  v = red[0];
  for (int w = 1; w < AT / 32; ++w) v = fmaxf(v, red[w]);
  return v;
}
__device__ __forceinline__ double group_sum(double v, double* red, int id) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  group_bar(id);
  if ((threadIdx.x & 31) == 0) red[(threadIdx.x % AT) >> 5] = v;
  group_bar(id);
  v = red[0];
  for (int w = 1; w < AT / 32; ++w) v += red[w];
  return v;
}

// group_sum(v) and group_max(w) (into wmax) over one group in one round
// of barriers: the same sums and maxima in the same order.
__device__ __forceinline__ double group_sum_max(double v, float w,
                                                GroupSmem& g, int id,
                                                float& wmax) {
  for (int o = 16; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
    w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, o));
  }
  group_bar(id);                         // red may still be read
  if ((threadIdx.x & 31) == 0) {
    g.dred[(threadIdx.x % AT) >> 5] = v;
    g.fred[(threadIdx.x % AT) >> 5] = w;
  }
  group_bar(id);
  v = g.dred[0];
  w = g.fred[0];
  for (int k = 1; k < AT / 32; ++k) {
    v += g.dred[k];
    w = fmaxf(w, g.fred[k]);
  }
  wmax = w;
  return v;
}

// Block i of an item's walk (cold blocks 0..nblk-1, then the tail):
// thread tid's four 16-byte pieces tid, tid + AT, .. of its K and of its
// V (8 KB each, a (DH, BLK) plane or (BLK, DH) rows: a warp reads 512
// contiguous bytes a load), and row tid's K and V scales.
struct KVBlock {
  int4 k[4], v[4];
  float ks, vs;
};
__device__ __forceinline__ KVBlock kv_load(const AttnArgs& a, size_t hb,
                                           int i, int tid) {
  KVBlock r;
  const int8_t *kp, *vp;
  if (i < a.nblk) {
    const size_t plane = (size_t)i * a.H * a.B + hb;
    kp = a.k_cold + plane * DH * BLK;
    vp = a.v_cold + plane * DH * BLK;
    r.ks = a.kc_scale[plane * BLK + tid];
    r.vs = a.vc_scale[plane * BLK + tid];
  } else {
    kp = a.k_tail + hb * BLK * DH;
    vp = a.v_tail + hb * BLK * DH;
    r.ks = a.kt_scale[hb * BLK + tid];
    r.vs = a.vt_scale[hb * BLK + tid];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r.k[j] = reinterpret_cast<const int4*>(kp)[j * AT + tid];
    r.v[j] = reinterpret_cast<const int4*>(vp)[j * AT + tid];
  }
  return r;
}

// attn_kernel's attention of head h, batch row b by one group (named
// barrier `id`), with the same operations in the same order, so the same
// bits; its output goes to outh as bf16 high words.  Each block's K and
// V are copied into g.k and g.v by 16-byte loads, and block i + 1's
// copy is in flight while block i merges, so the walk waits on device
// memory once, not twice a block.
__device__ __forceinline__ void attn_group(const AttnArgs& a,
                                           uint32_t* outh, int h, int b,
                                           GroupSmem& g, int id) {
  const int tid = threadIdx.x % AT;
  const size_t hb = (size_t)h * a.B + b;
  const float slope = a.slopes[h];
  const float* row = a.qkv + (size_t)b * 3 * a.D + h * DH;
  if (tid < DH) {
    g.qf[tid] = __ldcg(row + tid);
    g.kc[tid] = __ldcg(row + a.D + tid);
    g.vc[tid] = __ldcg(row + 2 * a.D + tid);
    a.k_new[hb * DH + tid] = __float2bfloat16_rn(g.kc[tid]);
    a.v_new[hb * DH + tid] = __float2bfloat16_rn(g.vc[tid]);
  }
  KVBlock cur = kv_load(a, hb, 0, tid);
  group_bar(id);
  const float q_scale = qscale(
      group_max(tid < DH ? fabsf(g.qf[tid]) : 0.f, g.fred, id), 1e-8f);
  if (tid < DH) g.q8[tid] = quant(g.qf[tid], q_scale);
  group_bar(id);
  const float qs = __fmul_rn(q_scale, a.scale);
  const int* q8p = reinterpret_cast<const int*>(g.q8);
  const int stage_base = a.pos - (a.pos - a.flushed) % STAGE;
  const int d = tid % DH, part = tid / DH;
  AttnState st{NEG_INF, 0.f, 0.f};

  // ---- cold blocks, then the tail (valid below stage_base)
  for (int i = 0; i <= a.nblk; ++i) {
    const bool cold = i < a.nblk;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      reinterpret_cast<int4*>(g.k)[j * AT + tid] = cur.k[j];
      reinterpret_cast<int4*>(g.v)[j * AT + tid] = cur.v[j];
    }
    const float ks = cur.ks, vs = cur.vs;
    if (cold) cur = kv_load(a, hb, i + 1, tid);   // the next block
    group_bar(id);
    int acc = 0;
    if (cold) {                          // column tid of the K plane
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const uint8_t* p =
            reinterpret_cast<const uint8_t*>(g.k) + 4 * d4 * BLK + tid;
        const int packed = (int)p[0] | ((int)p[BLK] << 8) |
                           ((int)p[2 * BLK] << 16) | ((int)p[3 * BLK] << 24);
        acc = __dp4a(q8p[d4], packed, acc);
      }
    } else {                             // row tid of the tail's K
      const int4* kr = reinterpret_cast<const int4*>(g.k) + 4 * tid;
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        const int4 v = kr[j];
        acc = __dp4a(q8p[4 * j], v.x, acc);
        acc = __dp4a(q8p[4 * j + 1], v.y, acc);
        acc = __dp4a(q8p[4 * j + 2], v.z, acc);
        acc = __dp4a(q8p[4 * j + 3], v.w, acc);
      }
    }
    const int t = cold ? i * BLK + tid : a.flushed + tid;
    float s = __fmul_rn(__fmul_rn((float)acc, qs), ks);
    s = __fadd_rn(s, __fmul_rn(slope, (float)abs(t - a.pos)));
    if (!cold) s = t < stage_base ? s : NEG_INF;
    // merge_i8 (the sum of e and the max of e * vs in one round)
    const float m_new = fmaxf(st.m, group_max(s, g.fred, id));
    const float corr = expf(__fsub_rn(st.m, m_new));
    const float e = expf(__fsub_rn(s, m_new));
    const float u = __fmul_rn(e, vs);
    float umax;
    const float esum =
        __double2float_rn(group_sum_max((double)e, u, g, id, umax));
    st.l = __fadd_rn(__fmul_rn(st.l, corr), esum);
    const float u_scale = qscale(umax, 1e-20f);
    g.u8[tid] = quant(u, u_scale);
    group_bar(id);
    int av = 0;
    if (cold) {                          // row d of the V plane
      const int4* r = reinterpret_cast<const int4*>(g.v + d * BLK + part * DH);
      const int* up = reinterpret_cast<const int*>(g.u8 + part * DH);
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        const int4 vv = r[j];
        av = __dp4a(up[4 * j], vv.x, av);
        av = __dp4a(up[4 * j + 1], vv.y, av);
        av = __dp4a(up[4 * j + 2], vv.z, av);
        av = __dp4a(up[4 * j + 3], vv.w, av);
      }
    } else {                             // column d of the tail's V
#pragma unroll 16
      for (int t2 = part * DH; t2 < (part + 1) * DH; ++t2)
        av += (int)g.u8[t2] * (int)g.v[t2 * DH + d];
    }
    if (part == 1) g.avred[d] = av;
    group_bar(id);
    if (part == 0)
      st.acc = __fadd_rn(__fmul_rn(st.acc, corr),
                         __fmul_rn(__int2float_rn(av + g.avred[d]), u_scale));
    st.m = m_new;
    group_bar(id);                       // u8 / avred / k / v are rewritten
  }

  // ---- stage: STAGE bf16 rows, valid at stage_base <= j < pos.  Warp w
  // takes rows w and w + 4; the dot is summed in float64.
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int j = warp; j < STAGE; j += AT / 32) {
      const __nv_bfloat16* kr = a.k_stage + ((size_t)j * a.H * a.B + hb) * DH;
      double dot =
          (double)__fmul_rn(g.qf[lane], __bfloat162float(kr[lane])) +
          (double)__fmul_rn(g.qf[lane + 32], __bfloat162float(kr[lane + 32]));
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) {
        const int jj = stage_base + j;
        float s = __fmul_rn(__double2float_rn(dot), a.scale);
        s = __fadd_rn(s, __fmul_rn(slope, (float)abs(jj - a.pos)));
        g.s_st[j] = jj < a.pos ? s : NEG_INF;
      }
    }
    group_bar(id);
    float mx = g.s_st[0];
    for (int j = 1; j < STAGE; ++j) mx = fmaxf(mx, g.s_st[j]);
    const float m_new = fmaxf(st.m, mx);
    const float corr = expf(__fsub_rn(st.m, m_new));
    float e[STAGE];
    double esum = 0.0;
    for (int j = 0; j < STAGE; ++j) {
      e[j] = expf(__fsub_rn(g.s_st[j], m_new));
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
  const double dot = group_sum(
      tid < DH ? (double)__fmul_rn(g.qf[tid], g.kc[tid]) : 0.0, g.dred, id);
  const float s_self = __fmul_rn(__double2float_rn(dot), a.scale);
  const float m_f = fmaxf(st.m, s_self);
  const float corr = expf(__fsub_rn(st.m, m_f));
  const float e_self = expf(__fsub_rn(s_self, m_f));
  const float l_f = __fadd_rn(__fmul_rn(st.l, corr), e_self);
  if (tid < DH)
    outh[(size_t)b * a.D + h * DH + tid] = bf16_hi(__fdiv_rn(
        __fadd_rn(__fmul_rn(st.acc, corr), __fmul_rn(e_self, g.vc[tid])),
        l_f));
  group_bar(id);                         // g is rewritten by the next item
}

// ---- the products
// d (16 batch rows x 8 output columns, float64) += a (16 rows x 16 k) .
// b (16 k x 8 columns) on the FP64 tensor cores: the m16n8k16 shape,
// which sm_90 runs at twice m8n8k4's rate.  Fragments (PTX ISA, mma
// .f64; g = lane / 4, t = lane % 4): lane l holds a[g + 8 (v % 2)][t + 4
// (v / 2)] (v < 8), b[t + 4 v][g] (v < 4) and d[g + 8 (v / 2)][2 t + v %
// 2] (v < 4).
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[8],
                                     const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// an int8 weight's byte as an exact double: (byte ^ 0x80) in the low
// word of 2^52, minus 2^52 + 128 (one add on the FP64 pipe)
__device__ __forceinline__ double i8_double(uint8_t w) {
  return __hiloint2double(0x43300000, (int)(w ^ 0x80u)) - I8_MAGIC;
}

// The activations of a product: RMSNorm rows (x, their 1/rms r and the
// norm scale nrm in shared memory, rounded to bf16 here) or rows kept as
// bf16 high words (hi).
struct DenseIn {
  const float* x;
  const float* r;
  const float* nrm;
  const uint32_t* hi;
};

// Chunk c (16 k) of a lane's activations: rows `row` and row + 8 at k =
// 16 c + 4 t + s for the fragment's k index t + 4 s (the k order inside
// a chunk is free: the float64 sums are exact), so each row's four values
// are one 16-byte load, read through L2 (other blocks wrote them in this
// launch).  Rows past B read as 0.
struct ARaw {
  float4 x[2];
};
template <bool NORM>
__device__ __forceinline__ ARaw a_load(const DenseIn& in, int K, int row,
                                       int B, int c, int t) {
  const float* src = NORM ? in.x : reinterpret_cast<const float*>(in.hi);
  ARaw r;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    r.x[h] = row + 8 * h < B
                 ? __ldcg(reinterpret_cast<const float4*>(
                       src + (size_t)(row + 8 * h) * K + 16 * c + 4 * t))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  return r;
}
template <bool NORM>
__device__ __forceinline__ void a_frag(double (&a)[8], const ARaw& r,
                                       const DenseIn& in, int c, int t,
                                       const float (&rr)[2]) {
  float ns[4] = {0.f, 0.f, 0.f, 0.f};
  if (NORM) {
    const float4 n =
        *reinterpret_cast<const float4*>(in.nrm + 16 * c + 4 * t);
    ns[0] = n.x, ns[1] = n.y, ns[2] = n.z, ns[3] = n.w;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float xs[4] = {r.x[h].x, r.x[h].y, r.x[h].z, r.x[h].w};
#pragma unroll
    for (int s = 0; s < 4; ++s)
      a[h + 2 * s] =
          NORM ? (double)bf16_round(__fmul_rn(__fmul_rn(xs[s], rr[h]), ns[s]))
               : __hiloint2double(__float_as_int(xs[s]), 0);
  }
}

// acc[q] += chunk c's products for the accumulators q whose round is r,
// q in [r nu, r nu + nu): unit q - r nu, the weights read from wrow[q],
// the lane's byte of that unit's first weight row (rows of 16 bytes in
// the slot: k = 16 c + 4 t + s at s * 16).  With fewer than UPP units a
// unit has UPP / nu accumulators that take its chunks in turn, so that
// more products are in flight (the float64 sums are exact, so adding
// them up later changes no bit).
__device__ __forceinline__ void chunk_mma(double (&acc)[UPP][4],
                                          const uint8_t* const (&wrow)[UPP],
                                          int nu, int r, int c,
                                          const double (&a)[8]) {
#pragma unroll
  for (int q = 0; q < UPP; ++q) {
    if (q >= r * nu && q < r * nu + nu) {
      const uint8_t* p = wrow[q] + (size_t)16 * c * UC;
      double b[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) b[s] = i8_double(p[s * UC]);
      dmma(acc[q], a, b);
    }
  }
}

enum StepOp { OP_QKV = 0, OP_OUT = 1, OP_UP = 2, OP_DOWN = 3 };

// The epilogue of one output, the parent's operation order: QKV y + bq;
// FFN up gelu(y + b1), kept as a bf16 high word; out-projection and FFN
// down (x + y) + b, x read from xres (the layer's input rows).
__device__ __forceinline__ void step_store(int op, float y, int b, int n,
                                           int N, const float* bias,
                                           const float* xres, float* out,
                                           uint32_t* outh) {
  const size_t i = (size_t)b * N + n;
  if (op == OP_QKV)
    out[i] = __fadd_rn(y, bias[n]);
  else if (op == OP_UP)
    outh[i] = bf16_hi(gelu(__fadd_rn(y, bias[n])));
  else
    out[i] = __fadd_rn(__fadd_rn(__ldcg(xres + i), y), bias[n]);
}

// One product y = act . W[:, block's columns] over all B rows, then its
// epilogue.  The block's units (8 columns over all K) are u = blockIdx.x
// + j G, their weights in the slot w (unit j's 16-column strip at j K 16,
// its columns in half u % 2); passes of up to UPP units and BTP batch
// tiles of 16 rows.  In a
// pass warp w takes batch tile w % btp and the chunks c = ks, ks + KS, ..
// (ks = w / btp, KS = 16 / btp) and writes its
// float64 sums to part[ks][b][col], which the epilogue adds (exact, so
// in any order).  PER_HEAD (the out-projection): warp ks takes heads ks,
// ks + KS, .. (4 chunks each), rounds each head's sum to float32 into
// part[h][b][col], and the epilogue adds the heads in order in float32,
// then scales: the parent's per-head epilogue.
template <bool NORM, bool PER_HEAD>
__device__ __forceinline__ void dense_phase(
    const uint8_t* w, int K, int N, const DenseIn& in, int B, int H,
    void* part, int op, const float* col, const float* bias,
    const float* xres, float* out, uint32_t* outh) {
  const int G = gridDim.x, n_units = N / UW, tid = threadIdx.x;
  const int U =
      (int)blockIdx.x < n_units ? cdiv(n_units - blockIdx.x, G) : 0;
  const int wi = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nbt = cdiv(B, BROWS), nch = K / 16;
  for (int j0 = 0; j0 < U; j0 += UPP) {
    const int nu = imin(UPP, U - j0), cols = nu * UW;
    const int reps = UPP / nu;           // accumulators per unit
    const uint8_t* wrow[UPP];            // accumulator q's unit's row
#pragma unroll
    for (int q = 0; q < UPP; ++q) {
      const int j = j0 + q % nu;
      wrow[q] = w + (size_t)j * K * UC + 4 * t * UC +
                (blockIdx.x + j * G) % 2 * UW + g;
    }
    for (int bt0 = 0; bt0 < nbt; bt0 += BTP) {
      const int btp = imin(BTP, nbt - bt0), nks = PWARPS / btp;
      const int bw = btp * BROWS, btl = wi % btp, ks = wi / btp;
      const int row = (bt0 + btl) * BROWS + g;
      const float rr[2] = {NORM && row < B ? in.r[row] : 0.f,
                           NORM && row + 8 < B ? in.r[row + 8] : 0.f};
      if (ks < nks) {
        // the warp's items: PER_HEAD, chunk i % 4 of head ks + (i / 4)
        // nks; else chunk ks + i nks.  Their activations are loaded PF
        // items ahead.
        const int n_items = PER_HEAD ? 4 * cdiv(H - ks, nks)
                                     : cdiv(nch - ks, nks);
        const auto chunk = [&](int i) {
          return PER_HEAD ? 4 * (ks + (i >> 2) * nks) + (i & 3)
                          : ks + i * nks;
        };
        double acc[UPP][4] = {};
        const auto store = [&](int hc) {   // acc into part[hc][b][col]
          // a unit's other accumulators into its first (indices known at
          // compile time, so that acc stays in registers)
#pragma unroll
          for (int q = UPP - 1; q > 0; --q)
#pragma unroll
            for (int u = 0; u < q; ++u)
              if (q >= nu && q < reps * nu && q % nu == u)
#pragma unroll
                for (int v = 0; v < 4; ++v) acc[u][v] += acc[q][v];
#pragma unroll
          for (int q = 0; q < UPP; ++q) {
            if (q >= nu) {
#pragma unroll
              for (int v = 0; v < 4; ++v) acc[q][v] = 0.0;
              continue;
            }
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const size_t at =
                  ((size_t)hc * bw + btl * BROWS + g + 8 * (v >> 1)) * cols +
                  q * UW + 2 * t + (v & 1);
              if (PER_HEAD)
                static_cast<float*>(part)[at] = __double2float_rn(acc[q][v]);
              else
                static_cast<double*>(part)[at] = acc[q][v];
              acc[q][v] = 0.0;
            }
          }
        };
        ARaw cur[PF], nxt[PF];
#pragma unroll
        for (int j = 0; j < PF; ++j)
          if (j < n_items) cur[j] = a_load<NORM>(in, K, row, B, chunk(j), t);
        for (int i0 = 0; i0 < n_items; i0 += PF) {
#pragma unroll
          for (int j = 0; j < PF; ++j)
            if (i0 + PF + j < n_items)
              nxt[j] = a_load<NORM>(in, K, row, B, chunk(i0 + PF + j), t);
#pragma unroll
          for (int j = 0; j < PF; ++j) {
            const int i = i0 + j;
            if (i < n_items) {
              double a[8];
              a_frag<NORM>(a, cur[j], in, chunk(i), t, rr);
              chunk_mma(acc, wrow, nu, i % reps, chunk(i), a);
              if (PER_HEAD && (i & 3) == 3) store(ks + (i >> 2) * nks);
            }
          }
#pragma unroll
          for (int j = 0; j < PF; ++j) cur[j] = nxt[j];
        }
        if (!PER_HEAD) store(ks);
      }
      __syncthreads();
      const int rows = imin(B - bt0 * BROWS, bw);
      for (int e = tid; e < rows * cols; e += PT) {
        const int br = e / cols, cl = e % cols;
        const int n = (blockIdx.x + (j0 + cl / UW) * G) * UW + cl % UW;
        float y;
        if (PER_HEAD) {
          const float* F = static_cast<const float*>(part);
          y = 0.f;
          for (int h = 0; h < H; ++h)
            y = __fadd_rn(y, F[((size_t)h * bw + br) * cols + cl]);
          y = __fmul_rn(y, col[n]);
        } else {
          const double* P = static_cast<const double*>(part);
          double acc = 0.0;
          for (int k2 = 0; k2 < nks; ++k2)
            acc += P[((size_t)k2 * bw + br) * cols + cl];
          y = __fmul_rn(__double2float_rn(acc), col[n]);
        }
        step_store(op, y, bt0 * BROWS + br, n, N, bias, xres, out, outh);
      }
      __syncthreads();
    }
  }
}

// Each row's 1 / rms into r[b], one warp a row, summed as rows_kernel's
// RT threads sum it (thread t: k = t, t + RT, ..; each warp's butterfly,
// lane 0's result; the warps in order), so the bits are the same.  A
// lane loads 4 RT / 32 values at a time before summing them.
__device__ void rms_rows(const float* x, int B, int K, float* r) {
  constexpr int NW = RT / 32;            // rows_kernel's warps
  const int wi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = wi; b < B; b += PWARPS) {
    const float* xr = x + (size_t)b * K + lane;
    double ss[NW] = {};
    for (int k0 = 0; k0 < K; k0 += 4 * RT) {
      float v[4][NW];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int wv = 0; wv < NW; ++wv)
          v[j][wv] = k0 + j * RT < K ? __ldcg(xr + k0 + j * RT + wv * 32)
                                     : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int wv = 0; wv < NW; ++wv)
          if (k0 + j * RT < K)
            ss[wv] += (double)__fmul_rn(v[j][wv], v[j][wv]);
    }
    double tot = 0.0;
#pragma unroll
    for (int wv = 0; wv < NW; ++wv) {
      for (int o = 16; o > 0; o >>= 1)
        ss[wv] += __shfl_xor_sync(0xffffffffu, ss[wv], o);
      tot += ss[wv];
    }
    if (lane == 0)
      r[b] = __fdiv_rn(
          1.f, __fsqrt_rn(__fadd_rn(
                   __fdiv_rn(__double2float_rn(tot), (float)K), 1e-6f)));
  }
}

// The weights of product d = 4 li + p (0 QKV, 1 out-projection, 2 FFN
// up, 3 FFN down) of this block into shared memory at dst (thread 0):
// one expect_tx of all its bytes on bar, then for each unit (8 columns)
// the 16-column strip that holds it, one TMA box per 256 rows (the other
// half is another block's unit: the boxes' inner extent is 16 bytes).  A
// block with no unit expects 0 bytes.
__device__ void load_units(const CUtensorMap* map, int li, int K, int N,
                           uint32_t dst, uint32_t bar) {
  const int G = gridDim.x, nu = N / UW;
  const int cnt = (int)blockIdx.x < nu ? cdiv(nu - blockIdx.x, G) : 0;
  mbar_expect(bar, cnt * UC * K);
  for (int j = 0; j < cnt; ++j)
    for (int kb = 0; kb < K; kb += KBOX)
      tma_box(dst + (uint32_t)(j * K + kb) * UC, map, bar,
              (blockIdx.x + j * G) * UW / UC * UC, kb, li);
}

__global__ void __launch_bounds__(PT, 1)
k2_bf16_step_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mo,
                    const __grid_constant__ CUtensorMap m1,
                    const __grid_constant__ CUtensorMap m2,
                    const __grid_constant__ StepArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const StepPlan pl = a.plan;
  uint8_t* slot[2] = {gbase, gbase + pl.slot};
  // the region: the sums and the norm scale in the dense phases, the
  // attention groups' scratch in the attention phase
  uint8_t* region = gbase + 2 * pl.slot;
  void* part = region;
  float* nrm_s = reinterpret_cast<float*>(region + pl.part);
  GroupSmem* groups = reinterpret_cast<GroupSmem*>(region);
  float* r_s = reinterpret_cast<float*>(region + pl.region);
  const uint32_t bars = base + 2 * pl.slot + pl.region + pl.rows;
  const int tid = threadIdx.x, G = gridDim.x;
  const int B = a.att.B, D = a.att.D, H = a.att.H, L = a.L;
  const CUtensorMap* maps[4] = {&mq, &mo, &m1, &m2};
  const int pn[4] = {3 * D, D, 4 * D, D}, pk[4] = {D, D, D, 4 * D};

  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) load_units(maps[0], 0, pk[0], pn[0], base, bars);
  // with a.trace, block 0 stamps the start and each phase's end (after
  // its grid barrier: every block is done) on the global timer
  int stamp = 0;
  const auto mark = [&]() {
    if (a.trace != nullptr && blockIdx.x == 0 && tid == 0) {
      unsigned long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      a.trace[stamp] = t;
    }
    ++stamp;
  };
  mark();
  int uses[2] = {0, 0};
  unsigned arrivals = 0;                 // grid_sync's target
  // product d: issue product d + 1's weights into the other slot (its
  // last reader, product d - 1, is done), then wait for d's
  auto begin = [&](int d) {
    const int nd = d + 1, p = nd & 3;
    if (tid == 0 && nd < 4 * L)
      load_units(maps[p], nd >> 2, pk[p], pn[p], base + (nd & 1) * pl.slot,
                 bars + 8 * (nd & 1));
    mbar_wait(bars + 8 * (d & 1), uses[d & 1]++ & 1);
  };

  const int grp = tid / AT;
  for (int li = 0; li < L; ++li) {
    const float* xin = li == 0 ? a.x : a.xo;     // the layer's input rows
    // QKV: RMSNorm(x, n1) rounded to bf16, x wq, + bq
    rms_rows(xin, B, D, r_s);
    for (int k = tid; k < D; k += PT) nrm_s[k] = a.n1[(size_t)li * D + k];
    __syncthreads();
    begin(4 * li);
    dense_phase<true, false>(slot[0], D, 3 * D,
                             DenseIn{xin, r_s, nrm_s, nullptr}, B, H,
                             part, OP_QKV, a.sq + (size_t)li * 3 * D,
                             a.bq + (size_t)li * 3 * D, nullptr, a.qkv,
                             nullptr);
    grid_sync(a.bar, arrivals);
    mark();
    // attention: (h, b) items, one per group of AT threads
    const AttnArgs at = attn_layer(a.att, li, a.nb_cap);
    for (int it = blockIdx.x * PGROUPS + grp; it < H * B;
         it += G * PGROUPS)
      attn_group(at, a.ah, it / B, it % B, groups[grp], 1 + grp);
    grid_sync(a.bar, arrivals);
    mark();
    // out-projection by head, residual
    begin(4 * li + 1);
    dense_phase<false, true>(slot[1], D, D,
                             DenseIn{nullptr, nullptr, nullptr, a.ah}, B, H,
                             part, OP_OUT, a.so + (size_t)li * D,
                             a.bo + (size_t)li * D, xin, a.xo, nullptr);
    grid_sync(a.bar, arrivals);
    mark();
    // FFN up: RMSNorm(x, n3), x w1, + b1, GELU
    rms_rows(a.xo, B, D, r_s);
    for (int k = tid; k < D; k += PT) nrm_s[k] = a.n3[(size_t)li * D + k];
    __syncthreads();
    begin(4 * li + 2);
    dense_phase<true, false>(slot[0], D, 4 * D,
                             DenseIn{a.xo, r_s, nrm_s, nullptr}, B, H,
                             part, OP_UP, a.s1 + (size_t)li * 4 * D,
                             a.b1 + (size_t)li * 4 * D, nullptr, nullptr,
                             a.gh);
    grid_sync(a.bar, arrivals);
    mark();
    // FFN down, residual
    begin(4 * li + 3);
    dense_phase<false, false>(slot[1], 4 * D, D,
                              DenseIn{nullptr, nullptr, nullptr, a.gh}, B,
                              H, part, OP_DOWN, a.s2 + (size_t)li * D,
                              a.b2 + (size_t)li * D, a.xo, a.xo, nullptr);
    if (li + 1 < L) grid_sync(a.bar, arrivals);
    mark();
  }
}

// Barriers alone, on the step's grid: their cost per barrier.
__global__ void __launch_bounds__(PT, 1)
k2_barrier_probe_kernel(unsigned* bar, int n) {
  unsigned arrivals = 0;
  for (int i = 0; i < n; ++i) grid_sync(bar, arrivals);
}

// ------------------------------------------------------------ launches
// K-input product: the int8 split-K kernel in chunks of KC rows, or (w4)
// the nibble kernel in PKC-row sub-chunks
int dense(const int8_t* act8, const int8_t* w, int B, int K, int N, int KC,
          int w4, void* part, cudaStream_t st) {
  if (w4) {
    const dim3 grid(N / DCOLS, K / 2 / PKC, (B + BT - 1) / BT);
    dense_w4_kernel<<<grid, DT, 0, st>>>(act8, w, B, K, N,
                                         static_cast<int*>(part));
    return (int)cudaGetLastError();
  }
  const dim3 grid(N / DCOLS, K / KC, (B + BT - 1) / BT);
  dense_kernel<<<grid, DT, (size_t)BT * KC, st>>>(act8, w, B, K, N, KC,
                                                  static_cast<int*>(part));
  return (int)cudaGetLastError();
}

// the split-K partials' epilogue; w4 (gscale set): the group-scale
// epilogue with nsub partials per unit, 2 (group 64, or a head) or 4
// (group 128)
int epilogue(const void* part, int S, int B, int N, int per_head,
             const float* ascale, int H, const float* col,
             const float* gscale, int gdiv, int nsub, const float* bias,
             int op, float* out, cudaStream_t st) {
  const int nblk = (B * N + ET - 1) / ET;
  const int* p32 = static_cast<const int*>(part);
  if (!gscale)
    epilogue_kernel<<<nblk, ET, 0, st>>>(p32, S, B, N, per_head, ascale, H,
                                         col, bias, op, out);
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
int rows(const float* x, const float* norm, int B, int K, int group,
         int8_t* q_out, float* xs_out, int xs_stride, cudaStream_t st) {
  if (group)
    rows_w4_kernel<<<B, RT, 0, st>>>(x, norm, K, group, q_out, xs_out);
  else
    rows_kernel<<<B, RT, 0, st>>>(x, norm, K, q_out, xs_out, xs_stride);
  return (int)cudaGetLastError();
}

#define CHECK(call)                  \
  do {                               \
    const int err_ = (call);         \
    if (err_ != 0) return err_;      \
  } while (0)

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

// Errors beyond cudaError_t (ops/mega_step.py names them): no encoder in
// the driver, or the driver refused a tensor map (TMA_ENCODE + CUresult).
constexpr int TMA_NO_ENCODER = 900;
constexpr int TMA_ENCODE = 1000;

// The (N, K, L) tensor map of an int8 weight stack (L, K, N), 16 x 256
// boxes (16-byte rows), no swizzle.
int weight_map(CUtensorMap* map, const void* w, int L, int K, int N) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return TMA_NO_ENCODER;
  cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)L};
  cuuint64_t strides[2] = {(cuuint64_t)N, (cuuint64_t)K * N};
  cuuint32_t box[3] = {(cuuint32_t)UC, (cuuint32_t)KBOX, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                   const_cast<void*>(w), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMA_ENCODE + (int)r;
}

// The grid of a cooperative launch of `fn` with `smem` bytes: every block
// resident, occupancy x the SM count.  Refuses a plan that does not fit.
int coop_grid(const void* fn, int smem, int* grid) {
  int dev, nsm, occ = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (!err)
    err = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, PT,
                                                             smem);
  if (err) return err;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *grid = occ * nsm;
  return 0;
}

}  // namespace

// One trunk step for all L layers on the a8 or w4 branch (the bf16 branch
// is fused_trunk_step_bf16_launch).  Shapes and layouts as in the
// wrapper, vae_gslm_tpu_torch/ops/mega_step.py; `work` is its
// workspace_bytes(B, D, H) bytes of scratch.  Requires head_dim 64, D a
// multiple of 256.  With group > 0 (the w4 branch; 64 or 128, dividing
// D / 2) wq/wo/w1/w2 are nibble-packed and gq/go/g1/g2 their group
// scales; sq/so/s1/s2 and a8 are then not read.
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
  if ((group != 0 && group != 64 && group != 128) || (!a8 && !group))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t BD = (size_t)B * D;
  const int pmax = D / 16 > H ? D / 16 : H;
  void* part = work;      // int32 partials: w4 takes D / 8 per output
  float* qkv =
      reinterpret_cast<float*>(static_cast<int*>(work) + 2 * BD * pmax);
  float* g = qkv + 3 * BD;
  int8_t* act8 = reinterpret_cast<int8_t*>(g + 4 * BD);
  float* ascale = reinterpret_cast<float*>(act8 + 4 * BD);
  float* xo = static_cast<float*>(x_out);
  CHECK((int)cudaMemcpyAsync(xo, x, BD * sizeof(float),
                             cudaMemcpyDeviceToDevice, st));

  const auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const int D3 = 3 * D, D4 = 4 * D;
  const int w4 = group > 0;
  const int wrows = w4 ? D / 2 : D;      // stored rows of a D-input weight
  // scale units per product: groups (w4) or split-K chunks of 64 (128 for
  // the 4D-input FFN-down), and w4's partials per unit
  const int kc = w4 ? group : 64, kc2 = w4 ? group : 128;
  const int nsub = w4 ? group / PKC : 1;
  const auto gs = [&](const void* p, size_t din, size_t dout, int li) {
    return w4 ? f32(p) + (size_t)li * (din / group) * dout : nullptr;
  };
  const AttnArgs att0{qkv,
                      i8(k_cold), i8(v_cold), f32(kc_scale), f32(vc_scale),
                      i8(k_tail), i8(v_tail), f32(kt_scale), f32(vt_scale),
                      static_cast<const __nv_bfloat16*>(k_stage),
                      static_cast<const __nv_bfloat16*>(v_stage),
                      f32(slopes),
                      static_cast<__nv_bfloat16*>(k_new),
                      static_cast<__nv_bfloat16*>(v_new),
                      act8, ascale,
                      B, H, D, flushed / BLK, pos, flushed, scale};
  for (int li = 0; li < L; ++li) {
    // 1-2. RMSNorm, QKV
    CHECK(rows(xo, f32(n1) + (size_t)li * D, B, D, group, act8, ascale, H,
               st));
    CHECK(dense(act8, i8(wq) + (size_t)li * wrows * D3, B, D, D3, kc, w4,
                part, st));
    CHECK(epilogue(part, D / kc, B, D3, 0, ascale, H,
                   f32(sq) + (size_t)li * D3, gs(gq, D, D3, li), 1, nsub,
                   f32(bq) + (size_t)li * D3, EPI_OUT, qkv, st));
    // 3. attention
    attn_kernel<<<H * B, AT, 0, st>>>(attn_layer(att0, li, nb_cap));
    CHECK((int)cudaGetLastError());
    // 4. out-projection, one K chunk per head; residual
    CHECK(dense(act8, i8(wo) + (size_t)li * wrows * D, B, D, D, DH, w4,
                part, st));
    CHECK(epilogue(part, H, B, D, 1, ascale, H,
                   f32(so) + (size_t)li * D, gs(go, D, D, li),
                   w4 ? group / DH : 1, DH / PKC, f32(bo) + (size_t)li * D,
                   EPI_RESID, xo, st));
    // 5. RMSNorm, FFN up, GELU
    CHECK(rows(xo, f32(n3) + (size_t)li * D, B, D, group, act8, ascale, H,
               st));
    CHECK(dense(act8, i8(w1) + (size_t)li * wrows * D4, B, D, D4, kc, w4,
                part, st));
    CHECK(epilogue(part, D / kc, B, D4, 0, ascale, H,
                   f32(s1) + (size_t)li * D4, gs(g1, D, D4, li), 1, nsub,
                   f32(b1) + (size_t)li * D4, EPI_GELU, g, st));
    // 6. FFN down, residual
    CHECK(rows(g, nullptr, B, D4, group, act8, ascale, H, st));
    CHECK(dense(act8, i8(w2) + (size_t)li * (D4 / (w4 ? 2 : 1)) * D, B, D4,
                D, kc2, w4, part, st));
    CHECK(epilogue(part, D4 / kc2, B, D, 0, ascale, H,
                   f32(s2) + (size_t)li * D, gs(g2, D4, D, li), 1, nsub,
                   f32(b2) + (size_t)li * D, EPI_RESID, xo, st));
  }
  return 0;
}

// The bf16 branch's grid for a dynamic shared memory of `smem` bytes
// (the wrapper's bf16_step_plan): occupancy x the SM count, into *grid.
extern "C" int fused_trunk_step_bf16_grid(int smem, int* grid) {
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  return coop_grid((const void*)k2_bf16_step_kernel, smem, grid);
}

// One trunk step for all L layers on the bf16 branch (bf16 activations x
// int8 weights): one cooperative launch of k2_bf16_step_kernel.  Shapes
// and layouts as fused_trunk_step_launch's; `work` holds qkv (B, 3D)
// float32 and the attention and GELU rows (B, D) and (B, 4D) as bf16
// high words, then the grid barrier's word, zeroed here
// (bf16_workspace_bytes(B, D)); `trace` null or 1 + 5 L words for block
// 0's phase-end times; `smem` the wrapper's plan, refused unless it holds
// step_plan for one block per SM.
extern "C" int fused_trunk_step_bf16_launch(
    const void* x, void* x_out, const void* wq, const void* wo,
    const void* w1, const void* w2, const void* sq, const void* so,
    const void* s1, const void* s2, const void* n1, const void* n3,
    const void* bq, const void* bo, const void* b1, const void* b2,
    const void* slopes, const void* k_cold, const void* v_cold,
    const void* kc_scale, const void* vc_scale, const void* k_tail,
    const void* v_tail, const void* kt_scale, const void* vt_scale,
    const void* k_stage, const void* v_stage, void* k_new, void* v_new,
    void* work, void* trace, int L, int B, int D, int H,
    int nb_cap, int pos, int flushed, float scale, int smem, void* stream) {
  if (B < 1 || D % 256 || H * DH != D) return (int)cudaErrorInvalidValue;
  int dev, nsm;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return err;
  const StepPlan plan = step_plan(B, D, H, nsm);
  if (smem < plan.bytes || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  int grid;
  err = coop_grid((const void*)k2_bf16_step_kernel, smem, &grid);
  if (err) return err;
  CUtensorMap mq, mo, m1, m2;
  err = weight_map(&mq, wq, L, D, 3 * D);
  if (!err) err = weight_map(&mo, wo, L, D, D);
  if (!err) err = weight_map(&m1, w1, L, D, 4 * D);
  if (!err) err = weight_map(&m2, w2, L, 4 * D, D);
  if (err) return err;
  const auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  float* qkv = static_cast<float*>(work);
  uint32_t* ah = reinterpret_cast<uint32_t*>(qkv + (size_t)3 * B * D);
  uint32_t* gh = ah + (size_t)B * D;
  unsigned* bar = gh + (size_t)4 * B * D;
  err = (int)cudaMemsetAsync(bar, 0, sizeof(unsigned),
                             static_cast<cudaStream_t>(stream));
  if (err) return err;
  StepArgs args{static_cast<const float*>(x), static_cast<float*>(x_out),
                f32(sq), f32(so), f32(s1), f32(s2), f32(n1), f32(n3),
                f32(bq), f32(bo), f32(b1), f32(b2),
                AttnArgs{qkv,
                         i8(k_cold), i8(v_cold), f32(kc_scale),
                         f32(vc_scale), i8(k_tail), i8(v_tail),
                         f32(kt_scale), f32(vt_scale),
                         static_cast<const __nv_bfloat16*>(k_stage),
                         static_cast<const __nv_bfloat16*>(v_stage),
                         f32(slopes),
                         static_cast<__nv_bfloat16*>(k_new),
                         static_cast<__nv_bfloat16*>(v_new),
                         nullptr, nullptr,
                         B, H, D, flushed / BLK, pos, flushed, scale},
                qkv, ah, gh, bar,
                static_cast<unsigned long long*>(trace), L, nb_cap, plan};
  void* params[] = {&mq, &mo, &m1, &m2, &args};
  return (int)cudaLaunchCooperativeKernel((const void*)k2_bf16_step_kernel,
                                          dim3(grid), dim3(PT), params,
                                          (size_t)smem,
                                          static_cast<cudaStream_t>(stream));
}

// `n` grid barriers alone on the bf16 step's grid (the same kernel shape
// and `smem`), counted in the word at `bar` (zeroed here): their cost.
extern "C" int k2_barrier_probe_launch(void* bar, int n, int smem,
                                       void* stream) {
  int grid;
  int err = coop_grid((const void*)k2_barrier_probe_kernel, smem, &grid);
  if (!err)
    err = (int)cudaMemsetAsync(bar, 0, sizeof(unsigned),
                               static_cast<cudaStream_t>(stream));
  if (err) return err;
  unsigned* b = static_cast<unsigned*>(bar);
  void* params[] = {&b, &n};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)k2_barrier_probe_kernel, dim3(grid), dim3(PT), params,
      (size_t)smem, static_cast<cudaStream_t>(stream));
}
