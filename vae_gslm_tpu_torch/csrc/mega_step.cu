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
// Every branch is one cooperative launch per step: one 512-thread block per
// SM (the grid is the occupancy x the SM count), all L layers, phases
// separated by a hand-written grid barrier (a release add and an acquire
// poll on a word of the call's scratch that the launcher zeroes).
// Attention is one (h, b) item per group of 128 threads (4 per block),
// the positions of an item in order (each block of 128 is requantized
// against the running maximum there).
//
// The bf16 branch (bf16 activations x int8 weights: every B > 8 call,
// such as the CLI's B = 32 chunks) is k2_bf16_step_kernel (section 4): 5
// phases a layer (QKV, attention, out-projection, FFN up, FFN down; 5 L -
// 1 barriers a step).
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
//     every block recomputes each row's 1/rms (rms_rows) and the fragment
//     loads apply it and round to bf16.  Attention and GELU rows are
//     written as the high words of their bf16 values as doubles.
//   * The epilogues keep the parent's operation order: the QKV bias; the
//     out-projection's per-head sums rounded to float32 and added in head
//     order, then `so`, the residual and bo; GELU(y + b1); (x + y) + b2.
//   Bounds at B = 32 (position 351): 0.603 GB of weights, valid cache
//   rows and I/O, 0.180 ms at 3.35 TB/s; the exact-sum design's 12.88
//   GFLOP on the FP64 tensor cores, 0.192 ms at 67 TFLOP/s.  What holds
//   it far above them on the H100 (PERF.md): every block reads all B
//   activation rows of each product from L2, each warp's chain of K
//   chunks on the FP64 tensor cores, each item's attention is a chain of
//   dependent block merges, and 79 grid barriers of about 1 us.
//
// The a8 branch (s8 x s8 products, the serving default at B <= 8) and the
// w4 branch (group > 0; K2-w4, the Pallas kernel's w4 path at _kernel and
// its out-projection: nibble-packed int4 weights (L, din/2, dout) int8, rows
// r and r + din/2 in the hi and lo nibble of one byte, with folded group
// scales g (L, din/group, dout) float32 in place of the column scales) are
// k2_i8_step_kernel<W4> (section 5): 8 phases a layer, each input row
// quantized once, each product split over K as well as over its columns.
//   * A rows phase (block b takes row b) finalizes the product before it
//     (the residual x, or GELU(y + b1)), takes the next product's RMSNorm
//     (1/rms summed as rms_rows sums it) and its scales max|h| / 127 per
//     row (a8) or per (row, group) (w4), a true division, and writes the
//     int8 row once, in each 32-chunk's fragment order (chunk_pos).
//   * A product is cut into tiles of 64 output columns x a K range (S per
//     product, from the plan), tile t to block t mod G.  Each block loads
//     its tiles' weight rows (64 bytes a row) with cp.async into one of two
//     slots, the next product's while this one runs (TMA boxes of narrow
//     strips had stalled the issuing thread for microseconds), and its K
//     range of the int8 rows (w4: both nibble halves) into shared memory.
//   * Dense products on the int8 tensor cores, mma.m16n8k32.s8.s8.s32: the
//     weights' output columns are M (16 a tile), the batch is N (tiles of 8
//     rows, up to four a pass), so no half of a tile is padding at B <= 8.
//     ldmatrix.trans reads 32 weight rows of a chunk as each lane's two
//     columns x four rows, and two byte permutes make them the A fragment
//     (w4: then the nibbles of the half, sign-extended).  An int32 sum of
//     int8 products is exact in any order, so warps, tiles and atomics
//     split and add K any way: the bits equal the parent's.
//   * a8's one dot per output: the tile's int32 sums in shared memory,
//     then added into the call's int32 sums with global atomics; the next
//     phase's reader takes float(dot) * (xs[b] * s[n]) + b, and zeroes
//     them.  A fold group (w4's group, the out-projection's head): its
//     tile writes the term float(dot_g) * (xs[b, g] * g[g, n]) (the out-
//     projection: asx[b, h], times w4's go row of the head); the reader
//     adds the terms in group order from 0.0 in float32 (a8's
//     out-projection then * so), the parent's operation order.
//   * Attention (after QKV, whose sums each item finalizes) quantizes its
//     head's output per head into the int8 rows.  The a8 kernel, with no
//     more items than blocks (B <= 8 at 16 heads), gives each item a whole
//     block (attn_coop_i8): its cache blocks are split over the four
//     groups, which replay the sequential walk's recurrences exactly.
//   * The phase bodies are not inlined (one copy each): inlined four times,
//     the kernel was 60,000 instructions and every phase refetched its code.
//   Bounds at B = 8 (position 351): 0.303 GB of weights, valid cache rows
//   and I/O, 0.090 ms at 3.35 TB/s; w4 at B = 32, group 128: 0.152 ms.
//   What holds it far above them (PERF.md): 8 L barriers of about 1 us and
//   a few dependent memory round trips in every phase.
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

#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLK = 128;        // positions per cold block and in the tail
constexpr int STAGE = 8;        // bf16 stage rows
constexpr int AT = 128;         // attention threads: one per block row
// The head width DH is a template parameter of the attention code and of
// the kernels, instantiated at 32, 64 and 128 (ops/mega_step.HEAD_DIMS);
// the launchers take D / H and dispatch.
constexpr float NEG_INF = -1e30f;
constexpr int RT = 256;         // the RMS sum's width: rms_rows adds a row's
                                // squares as RT threads (k = t, t + RT, ..)
                                // would, then their warps in order

// ---------------------------------------------------------------- helpers
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

// the four signed 4-bit values in the hi (or lo) nibbles of w's bytes, as
// four signed bytes: per byte, (nibble ^ 8) - 8 without carries
__device__ __forceinline__ int nibbles(int w, bool hi) {
  const unsigned u = (hi ? (unsigned)w >> 4 : (unsigned)w) & 0x0F0F0F0Fu;
  return (int)__vsub4(u ^ 0x08080808u, 0x08080808u);
}

// The position of k (within its chunk of 32) in the chunk's stored order:
// k = 8 j + 2 t + e goes to 8 t + 4 (j / 2) + 2 (j % 2) + e, so that lane
// (g, t)'s two B-fragment registers (k rows 2t, 2t+1, 8+2t, 9+2t and 16 +
// those, the weight rows ldmatrix.trans hands it: section 5) are 8 contiguous
// bytes.
__host__ __device__ __forceinline__ int chunk_pos(int k) {
  const int j = (k >> 3) & 3, t = (k >> 1) & 3, e = k & 1;
  return (k & ~31) + 8 * t + 4 * (j >> 1) + 2 * (j & 1) + e;
}

// ------------------------------------------------------- attention
struct AttnArgs {
  const float* qkv;            // (B, 3D)
  const int8_t* k_cold;        // this layer's (NB, H, B, DH, BLK), DH = D/H
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

// The cache-block buffers of an attention group: K and V apart at widths
// up to 64; at 128 one buffer takes a block's K, then (once every logit
// is read) its V, so that four groups' scratch stays within the bf16
// step's block at d1024 / 8 x 128 (two buffers of 16 KB each would not).
__host__ __device__ constexpr int kv_buffers(int dh) { return dh > 64 ? 1 : 2; }
// sizeof(GroupSmem<dh>) (below; static_asserts hold each instantiation to
// it), mirrored by ops/mega_step.py's group_smem.
__host__ __device__ constexpr int group_smem(int dh) {
  return (4 * 3 * dh + 4 * (AT / dh > 1 ? (AT / dh - 1) * dh : 4) + 8 * 4 +
          4 * 4 + 4 * STAGE + dh + AT + kv_buffers(dh) * BLK * dh + 15) /
         16 * 16;
}

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
  const int region = imax(part + 4 * D, PGROUPS * group_smem(D / H));
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
  const size_t dh = a.D / a.H;
  const size_t hbd = (size_t)a.H * a.B * dh;
  const size_t cold = (size_t)nb_cap * a.H * a.B * BLK;
  const size_t tail = (size_t)a.H * a.B * BLK;
  a.k_cold += li * cold * dh;
  a.v_cold += li * cold * dh;
  a.kc_scale += li * cold;
  a.vc_scale += li * cold;
  a.k_tail += li * tail * dh;
  a.v_tail += li * tail * dh;
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
// A group's shared scratch: the item's q, k and v rows, its reductions
// (avred: the int32 P.V sums of parts 1 .. NP - 1, a part being DH of a
// block's 128 positions), and the K and V of the block being merged (a
// cold block's (DH, BLK) planes or the tail's (BLK, DH) rows), in two
// buffers or, at DH = 128, one (kv_buffers).
template <int DH>
struct __align__(16) GroupSmem {
  static constexpr int NP = AT / DH;     // P.V parts: 4, 2 or 1
  static constexpr bool ONE = kv_buffers(DH) == 1;
  float qf[DH], kc[DH], vc[DH];
  int avred[NP > 1 ? (NP - 1) * DH : 4];
  double dred[AT / 32];
  float fred[AT / 32];
  float s_st[STAGE];
  int8_t q8[DH];
  int8_t u8[AT];
  int8_t kv[kv_buffers(DH) * BLK * DH];
  __device__ int8_t* k() { return kv; }
  __device__ int8_t* v() { return ONE ? kv : kv + BLK * DH; }
};
static_assert(sizeof(GroupSmem<32>) == group_smem(32), "group_smem mirrors it");
static_assert(sizeof(GroupSmem<64>) == group_smem(64), "group_smem mirrors it");
static_assert(sizeof(GroupSmem<128>) == group_smem(128),
              "group_smem mirrors it");

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
template <int DH>
__device__ __forceinline__ double group_sum_max(double v, float w,
                                                GroupSmem<DH>& g, int id,
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
// thread tid's DH / 16 16-byte pieces tid, tid + AT, .. of its K and of
// its V (128 DH bytes each, a (DH, BLK) plane or (BLK, DH) rows: a warp
// reads 512 contiguous bytes a load), and row tid's K and V scales.
template <int DH>
struct KVBlock {
  int4 k[DH / 16], v[DH / 16];
  float ks, vs;
};
template <int DH>
__device__ __forceinline__ KVBlock<DH> kv_load(const AttnArgs& a, size_t hb,
                                               int i, int tid) {
  KVBlock<DH> r;
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
  for (int j = 0; j < DH / 16; ++j) {
    r.k[j] = reinterpret_cast<const int4*>(kp)[j * AT + tid];
    r.v[j] = reinterpret_cast<const int4*>(vp)[j * AT + tid];
  }
  return r;
}

// A block's K (or V) pieces from a thread's registers into the buffer.
template <int DH>
__device__ __forceinline__ void kv_put(int8_t* dst, const int4 (&src)[DH / 16],
                                       int tid) {
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    reinterpret_cast<int4*>(dst)[j * AT + tid] = src[j];
}

// Row tid's logit dot: q8 . column tid of a cold K plane, or . row tid of
// the tail's K rows (int32, exact).
template <int DH>
__device__ __forceinline__ int k_dot(const int8_t* k, const int* q8p,
                                     bool cold, int tid) {
  int acc = 0;
  if (cold) {
#pragma unroll
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      const uint8_t* p =
          reinterpret_cast<const uint8_t*>(k) + 4 * d4 * BLK + tid;
      const int packed = (int)p[0] | ((int)p[BLK] << 8) |
                         ((int)p[2 * BLK] << 16) | ((int)p[3 * BLK] << 24);
      acc = __dp4a(q8p[d4], packed, acc);
    }
  } else {
    const int4* kr = reinterpret_cast<const int4*>(k) + DH / 16 * tid;
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      const int4 v = kr[j];
      acc = __dp4a(q8p[4 * j], v.x, acc);
      acc = __dp4a(q8p[4 * j + 1], v.y, acc);
      acc = __dp4a(q8p[4 * j + 2], v.z, acc);
      acc = __dp4a(q8p[4 * j + 3], v.w, acc);
    }
  }
  return acc;
}

// Channel d's P.V over part `part` (positions part DH .. part DH + DH - 1)
// of a block: the int8 probabilities u8 . row d of a cold V plane, or .
// column d of the tail's V rows; then the parts added in part order into
// part 0's threads (int32, exact).  Its barrier (NP > 1) leaves avred to
// the caller's next one.
template <int DH>
__device__ __forceinline__ int pv_dot(GroupSmem<DH>& g, bool cold, int d,
                                      int part, int id) {
  const int8_t* v = g.v();
  int av = 0;
  if (cold) {
    const int4* r = reinterpret_cast<const int4*>(v + d * BLK + part * DH);
    const int* up = reinterpret_cast<const int*>(g.u8 + part * DH);
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      const int4 vv = r[j];
      av = __dp4a(up[4 * j], vv.x, av);
      av = __dp4a(up[4 * j + 1], vv.y, av);
      av = __dp4a(up[4 * j + 2], vv.z, av);
      av = __dp4a(up[4 * j + 3], vv.w, av);
    }
  } else {
#pragma unroll 16
    for (int t2 = part * DH; t2 < (part + 1) * DH; ++t2)
      av += (int)g.u8[t2] * (int)v[t2 * DH + d];
  }
  constexpr int NP = GroupSmem<DH>::NP;
  if (NP > 1) {
    if (part > 0) g.avred[(part - 1) * DH + d] = av;
    group_bar(id);
    if (part == 0)
#pragma unroll
      for (int q = 1; q < NP; ++q) av += g.avred[(q - 1) * DH + d];
  }
  return av;
}

// The sum, in group order from 0.0, of output (b, n)'s fold terms.
// Its terms lie `stride` floats apart (the terms are [g][b][n]); they are
// loaded up to 32 at a time, then added in order.
__device__ __forceinline__ float fold_terms(const float* t, int ng,
                                           size_t stride) {
  float y = 0.f;
  for (int g0 = 0; g0 < ng; g0 += 32) {
    float v[32];
#pragma unroll
    for (int j = 0; j < 32; ++j)
      v[j] = g0 + j < ng ? __ldcg(t + (g0 + j) * stride) : 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (g0 + j < ng) y = __fadd_rn(y, v[j]);
  }
  return y;
}

// The folds of outputs n + o m (o < KO, those below cnt) from at most NG
// terms each, all their loads in flight at once.
template <int KO, int NG>
__device__ __forceinline__ void fold_multi(const float* t, int m, int ng,
                                           size_t stride, int cnt,
                                           float (&y)[4]) {
  float v[KO][NG];
#pragma unroll
  for (int o = 0; o < KO; ++o)
#pragma unroll
    for (int j = 0; j < NG; ++j)
      v[o][j] = j < ng && o < cnt ? __ldcg(t + o * m + j * stride) : 0.f;
#pragma unroll
  for (int o = 0; o < KO; ++o) {
    y[o] = 0.f;
#pragma unroll
    for (int j = 0; j < NG; ++j)
      if (j < ng) y[o] = __fadd_rn(y[o], v[o][j]);
  }
}

// The finalize of QKV's outputs inside the attention items: a8's int32
// sums (acc, zeroed as read) x (xs[b] * sq) or w4's fold of the terms,
// then + bq.
struct I8Fin {
  int* acc;                    // (B, 3D) a8's int32 sums
  const float* terms;          // (ng, B, 3D) w4's fold terms
  size_t gstride;              // B x 3D: the terms' group stride
  int ng;                      // their count
  const float* xs;             // the QKV inputs' scales (B, nxs)
  const float* sq;             // layer li's column scales, biases
  const float* bq;
  int nxs;
};

// QKV outputs n, D + n and 2D + n of row b (q, k and v of one head
// channel), finalized, every load issued before the first is used: w4's
// fold terms (W4) or a8's int32 sums
template <bool W4>
__device__ __forceinline__ void i8_fin(const I8Fin& f, int b, int n, int D,
                                       float (&y)[3]) {
  const size_t i = (size_t)b * 3 * D + n;
  float bq[3], y4[4];
#pragma unroll
  for (int o = 0; o < 3; ++o) bq[o] = __ldg(f.bq + n + o * D);
  if (W4) {
    if (f.ng <= 16) {
      fold_multi<3, 16>(f.terms + i, D, f.ng, f.gstride, 3, y4);
    } else {
#pragma unroll
      for (int o = 0; o < 3; ++o)
        y4[o] = fold_terms(f.terms + i + o * D, f.ng, f.gstride);
    }
  } else {
    int q[3];
    float sc[3];
    const float xs = __ldcg(f.xs + (size_t)b * f.nxs);
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      q[o] = __ldcg(f.acc + i + o * D);
      sc[o] = __ldg(f.sq + n + o * D);
    }
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      y4[o] = __fmul_rn(__int2float_rn(q[o]), __fmul_rn(xs, sc[o]));
      f.acc[i + o * D] = 0;
    }
  }
#pragma unroll
  for (int o = 0; o < 3; ++o) y[o] = __fadd_rn(y4[o], bq[o]);
}

// An item's stage rows, loaded ahead into shared memory: K and V, [STAGE]
// [DH] float32 each (the values of their bf16).
struct StagePre {
  const float* k;
  const float* v;
};
// by one group's thread tid, its share
template <int DH>
__device__ __forceinline__ void stage_load(const AttnArgs& a, size_t hb,
                                           int tid, float* k, float* v) {
#pragma unroll
  for (int e = tid; e < STAGE * DH; e += AT) {
    const size_t at = ((size_t)(e / DH) * a.H * a.B + hb) * DH + e % DH;
    k[e] = __bfloat162float(a.k_stage[at]);
    v[e] = __bfloat162float(a.v_stage[at]);
  }
}

// The end of an item's attention, after its cold blocks and tail: the
// stage rows (loaded here, or ahead with PRE), the current token, acc / l,
// and the output (attn_group's).
template <int DH, bool I8, bool PRE = false>
__device__ __forceinline__ void attn_finish(const AttnArgs& a,
                                            uint32_t* outh, int h, int b,
                                            GroupSmem<DH>& g, int id,
                                            const I8Fin& f, AttnState& st,
                                            const StagePre& pre = {}) {
  const int tid = threadIdx.x % AT;
  const size_t hb = (size_t)h * a.B + b;
  const float slope = a.slopes[h];
  const int stage_base = a.pos - (a.pos - a.flushed) % STAGE;
  // ---- stage: STAGE bf16 rows, valid at stage_base <= j < pos.  Warp w
  // takes rows w and w + 4, lane l channels l, l + 32, ..; the dot is
  // summed in float64.
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int j = warp; j < STAGE; j += AT / 32) {
      const __nv_bfloat16* kr = a.k_stage + ((size_t)j * a.H * a.B + hb) * DH;
      double dot = 0.0;
#pragma unroll
      for (int c = lane; c < DH; c += 32)
        dot += (double)__fmul_rn(
            g.qf[c], PRE ? pre.k[j * DH + c] : __bfloat162float(kr[c]));
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
            e[j], PRE ? pre.v[j * DH + tid]
                      : __bfloat162float(
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
  if (I8) {
    const float o =
        tid < DH ? __fdiv_rn(__fadd_rn(__fmul_rn(st.acc, corr),
                                       __fmul_rn(e_self, g.vc[tid])),
                             l_f)
                 : 0.f;
    const float asx = qscale(group_max(fabsf(o), g.fred, id), 1e-8f);
    if (tid < DH) a.out8[(size_t)b * a.D + h * DH + chunk_pos(tid)] =
        quant(o, asx);
    if (tid == 0) a.asx[(size_t)b * f.nxs + h] = asx;
  } else if (tid < DH) {
    outh[(size_t)b * a.D + h * DH + tid] = bf16_hi(__fdiv_rn(
        __fadd_rn(__fmul_rn(st.acc, corr), __fmul_rn(e_self, g.vc[tid])),
        l_f));
  }
}

// The attention of head h, batch row b by one group (named barrier `id`),
// with the operations of the reference in its order, so the same bits
// as the plain version.  Its output goes to outh as bf16 high words (the
// bf16 branch) or, with I8, quantized per head (scale max|o| / 127) into
// a.out8 in chunk_pos order and a.asx (stride f.nxs); with I8 its q, k and
// v are QKV's sums, finalized here (i8_fin).  Each
// block's K and V are copied into g's buffers by 16-byte loads, and block
// i + 1's copy is in flight while block i merges (at DH = 128, where K and
// V share one buffer, while its softmax and P.V run), so the walk waits on
// device memory once, not twice a block.
template <int DH, bool I8, bool W4 = false>
__device__ __forceinline__ void attn_group(const AttnArgs& a,
                                           uint32_t* outh, int h, int b,
                                           GroupSmem<DH>& g, int id,
                                           const I8Fin& f) {
  constexpr bool ONE = GroupSmem<DH>::ONE;
  const int tid = threadIdx.x % AT;
  const size_t hb = (size_t)h * a.B + b;
  const float slope = a.slopes[h];
  const float* row = a.qkv + (size_t)b * 3 * a.D + h * DH;
  if (tid < DH) {
    if (I8) {
      float y[3];
      i8_fin<W4>(f, b, h * DH + tid, a.D, y);
      g.qf[tid] = y[0];
      g.kc[tid] = y[1];
      g.vc[tid] = y[2];
    } else {
      g.qf[tid] = __ldcg(row + tid);
      g.kc[tid] = __ldcg(row + a.D + tid);
      g.vc[tid] = __ldcg(row + 2 * a.D + tid);
    }
    a.k_new[hb * DH + tid] = __float2bfloat16_rn(g.kc[tid]);
    a.v_new[hb * DH + tid] = __float2bfloat16_rn(g.vc[tid]);
  }
  KVBlock<DH> cur = kv_load<DH>(a, hb, 0, tid);
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

  // ---- cold blocks, then the tail (valid below stage_base).  With two
  // buffers block i + 1's loads are issued before block i's logits; with
  // one, once its V is in the buffer.
  for (int i = 0; i <= a.nblk; ++i) {
    const bool cold = i < a.nblk;
    kv_put<DH>(g.k(), cur.k, tid);
    if (!ONE) kv_put<DH>(g.v(), cur.v, tid);
    const float ks = cur.ks, vs = cur.vs;
    if (!ONE && cold) cur = kv_load<DH>(a, hb, i + 1, tid);   // the next
    group_bar(id);
    const int acc = k_dot<DH>(g.k(), q8p, cold, tid);
    const int t = cold ? i * BLK + tid : a.flushed + tid;
    float s = __fmul_rn(__fmul_rn((float)acc, qs), ks);
    s = __fadd_rn(s, __fmul_rn(slope, (float)abs(t - a.pos)));
    if (!cold) s = t < stage_base ? s : NEG_INF;
    // merge the block (the sum of e and the max of e * vs in one round)
    const float m_new = fmaxf(st.m, group_max(s, g.fred, id));
    if (ONE) {            // every logit is read: V into the one buffer
      kv_put<DH>(g.v(), cur.v, tid);
      if (cold) cur = kv_load<DH>(a, hb, i + 1, tid);
    }
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
    const int av = pv_dot<DH>(g, cold, d, part, id);
    if (part == 0)
      st.acc = __fadd_rn(__fmul_rn(st.acc, corr),
                         __fmul_rn(__int2float_rn(av), u_scale));
    st.m = m_new;
    group_bar(id);                       // u8 / avred / k / v are rewritten
  }

  attn_finish<DH, I8>(a, outh, h, b, g, id, f, st);
  group_bar(id);                         // g is rewritten by the next item
}

// An a8/w4 attention item (h, b) by a whole block, for grids with a block
// per item: its cold blocks and tail (nb1 = nblk + 1 cache blocks) are
// split over the block's PGROUPS groups (block i to group i mod PGROUPS).
// A first pass takes each cache block's logit maximum; every group then
// knows the running maximum m_i after each block (the prefix maxima), so
// a second pass merges each cache block against it (e, its float64 sum,
// e * v_scale requantized against its own maximum, the int8 P.V) as the
// walk of attn_group does; group 0 then replays the walk's recurrences
// in block order (corr = exp(m_{i-1} - m_i); l = l corr + esum_i; acc =
// acc corr + av_i u_scale_i), the same operations on the same values, so
// the same bits, and finishes as attn_group (the stage rows loaded ahead
// by the last group).  `xs` is scratch of coop_bytes(DH) a cache block
// and 16 + 2 STAGE DH 4 more (a weight slot no product reads now).
template <int DH>
__device__ void attn_coop_i8(const AttnArgs& a, int h, int b,
                             GroupSmem<DH>* groups, const I8Fin& f,
                             uint8_t* xs) {
  constexpr bool ONE = GroupSmem<DH>::ONE;
  const int tid = threadIdx.x % AT, grp = threadIdx.x / AT, id = 1 + grp;
  GroupSmem<DH>& g = groups[grp];
  GroupSmem<DH>& g0 = groups[0];
  const size_t hb = (size_t)h * a.B + b;
  const int nb1 = a.nblk + 1;
  float* mx = reinterpret_cast<float*>(xs);            // [nb1] block maxima
  float* es = mx + nb1;                                // [nb1] esum
  float* us = es + nb1;                                // [nb1] u_scale
  int* avs = reinterpret_cast<int*>(us + nb1);         // [nb1][DH] av
  float* qsp = reinterpret_cast<float*>(avs + nb1 * DH);  // qs
  float* stk = qsp + 4;                               // [STAGE][DH] K, V
  float* stv = stk + STAGE * DH;
  if (grp == PGROUPS - 1) stage_load<DH>(a, hb, tid, stk, stv);   // ahead
  if (grp == 0 && tid < DH) {
    float y[3];
    i8_fin<false>(f, b, h * DH + tid, a.D, y);
    g0.qf[tid] = y[0];
    g0.kc[tid] = y[1];
    g0.vc[tid] = y[2];
    a.k_new[hb * DH + tid] = __float2bfloat16_rn(g0.kc[tid]);
    a.v_new[hb * DH + tid] = __float2bfloat16_rn(g0.vc[tid]);
  }
  KVBlock<DH> cur;
  if (grp < nb1) cur = kv_load<DH>(a, hb, grp, tid);   // the first round's
  if (grp == 0) {
    group_bar(id);
    const float q_scale = qscale(
        group_max(tid < DH ? fabsf(g0.qf[tid]) : 0.f, g0.fred, id), 1e-8f);
    if (tid < DH) g0.q8[tid] = quant(g0.qf[tid], q_scale);
    if (tid == 0) qsp[0] = __fmul_rn(q_scale, a.scale);
  }
  __syncthreads();
  const float qs = qsp[0], slope = a.slopes[h];
  const int* q8p = reinterpret_cast<const int*>(g0.q8);
  const int stage_base = a.pos - (a.pos - a.flushed) % STAGE;
  const int d = tid % DH, part = tid / DH;
  const bool one = nb1 <= PGROUPS;        // each group keeps its block
  // cache block i's K (and, with two buffers, V) into g, and row tid's
  // logit
  const auto logit = [&](int i, const KVBlock<DH>& kv) {
    kv_put<DH>(g.k(), kv.k, tid);
    if (!ONE) kv_put<DH>(g.v(), kv.v, tid);
    group_bar(id);
    const bool cold = i < a.nblk;
    const int acc = k_dot<DH>(g.k(), q8p, cold, tid);
    const int t = cold ? i * BLK + tid : a.flushed + tid;
    float s = __fmul_rn(__fmul_rn((float)acc, qs), kv.ks);
    s = __fadd_rn(s, __fmul_rn(slope, (float)abs(t - a.pos)));
    if (!cold) s = t < stage_base ? s : NEG_INF;
    return s;
  };
  // pass 1: each cache block's maximum
  float s0 = NEG_INF;
  for (int i = grp; i < nb1; i += PGROUPS) {
    if (i > grp) cur = kv_load<DH>(a, hb, i, tid);
    const float s = logit(i, cur);
    if (i == grp) s0 = s;
    const float m = group_max(s, g.fred, id);
    if (tid == 0) mx[i] = m;
    group_bar(id);                       // g.k, g.v are rewritten next
  }
  __syncthreads();
  // pass 2: each cache block merged against the running maximum
  for (int i = grp; i < nb1; i += PGROUPS) {
    float m_i = mx[0];
    for (int j = 1; j <= i; ++j) m_i = fmaxf(m_i, mx[j]);
    KVBlock<DH> kv;
    float s = s0, vs;
    if (one) {
      vs = cur.vs;
      if (ONE) kv_put<DH>(g.v(), cur.v, tid);   // pass 1 left K there
    } else {
      kv = kv_load<DH>(a, hb, i, tid);
      s = logit(i, kv);
      vs = kv.vs;
      if (ONE) {                         // every logit is read: V in
        group_bar(id);
        kv_put<DH>(g.v(), kv.v, tid);
      }
    }
    const float e = expf(__fsub_rn(s, m_i));
    const float u = __fmul_rn(e, vs);
    float umax;
    const float esum =
        __double2float_rn(group_sum_max((double)e, u, g, id, umax));
    const float u_scale = qscale(umax, 1e-20f);
    g.u8[tid] = quant(u, u_scale);
    group_bar(id);
    const int av = pv_dot<DH>(g, i < a.nblk, d, part, id);
    if (part == 0) avs[i * DH + d] = av;
    if (tid == 0) {
      es[i] = esum;
      us[i] = u_scale;
    }
    group_bar(id);                       // u8 / avred / k / v are rewritten
  }
  __syncthreads();
  if (grp != 0) return;
  AttnState st{NEG_INF, 0.f, 0.f};
  for (int i = 0; i < nb1; ++i) {
    const float m_new = fmaxf(st.m, mx[i]);
    const float corr = expf(__fsub_rn(st.m, m_new));
    st.l = __fadd_rn(__fmul_rn(st.l, corr), es[i]);
    if (part == 0)
      st.acc = __fadd_rn(__fmul_rn(st.acc, corr),
                         __fmul_rn(__int2float_rn(avs[i * DH + d]), us[i]));
    st.m = m_new;
  }
  attn_finish<DH, true, true>(a, nullptr, h, b, g0, id, f, st,
                              StagePre{stk, stv});
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
// ks + KS, .. (DH / 16 chunks each), rounds each head's sum to float32
// into part[h][b][col], and the epilogue adds the heads in order in
// float32, then scales: the parent's per-head epilogue.
template <bool NORM, bool PER_HEAD, int DH>
__device__ __forceinline__ void dense_phase(
    const uint8_t* w, int K, int N, const DenseIn& in, int B, int H,
    void* part, int op, const float* col, const float* bias,
    const float* xres, float* out, uint32_t* outh) {
  const int G = gridDim.x, n_units = N / UW, tid = threadIdx.x;
  const int U =
      (int)blockIdx.x < n_units ? cdiv(n_units - blockIdx.x, G) : 0;
  const int wi = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nbt = cdiv(B, BROWS), nch = K / 16;
  constexpr int HC = DH / 16;            // PER_HEAD: a head's chunks
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
        // the warp's items: PER_HEAD, chunk i % HC of head ks + (i / HC)
        // nks; else chunk ks + i nks.  Their activations are loaded PF
        // items ahead.
        const int n_items = PER_HEAD ? HC * cdiv(H - ks, nks)
                                     : cdiv(nch - ks, nks);
        const auto chunk = [&](int i) {
          return PER_HEAD ? HC * (ks + (i / HC) * nks) + (i % HC)
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
              if (PER_HEAD && i % HC == HC - 1) store(ks + (i / HC) * nks);
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

// Each row's 1 / rms into r[b], one warp a row, summed as RT threads
// would sum it (thread t: k = t, t + RT, ..; each warp's butterfly, lane
// 0's result; the warps in order): the order of the multi-launch design's
// row kernel, whose bits the plain version's float64 sum rounds to.  A
// lane loads 4 RT / 32 values at a time before summing them.
__device__ void rms_rows(const float* x, int B, int K, float* r) {
  constexpr int NW = RT / 32;            // RT's warps
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

template <int DH>
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
  GroupSmem<DH>* groups = reinterpret_cast<GroupSmem<DH>*>(region);
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
    dense_phase<true, false, DH>(slot[0], D, 3 * D,
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
      attn_group<DH, false>(at, a.ah, it / B, it % B, groups[grp], 1 + grp,
                            I8Fin{});
    grid_sync(a.bar, arrivals);
    mark();
    // out-projection by head, residual
    begin(4 * li + 1);
    dense_phase<false, true, DH>(slot[1], D, D,
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
    dense_phase<true, false, DH>(slot[0], D, 4 * D,
                             DenseIn{a.xo, r_s, nrm_s, nullptr}, B, H,
                             part, OP_UP, a.s1 + (size_t)li * 4 * D,
                             a.b1 + (size_t)li * 4 * D, nullptr, nullptr,
                             a.gh);
    grid_sync(a.bar, arrivals);
    mark();
    // FFN down, residual
    begin(4 * li + 3);
    dense_phase<false, false, DH>(slot[1], 4 * D, D,
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

// --------------------------------- 5. K2-a8 and K2-w4: one launch a step
// The s8 x s8 and nibble-packed int4 branches as one cooperative launch
// per step, on section 4's grid, barrier and attention items: the design
// note at the top of the file.  A layer is 8 phases:
//   rows      block b < B finalizes row b of the previous layer's FFN down
//             (the residual x), then RMSNorm(x, n1): 1/rms, the scales and
//             the int8 row (chunk_pos order) for QKV;
//   QKV       split-K tiles of 64 output columns x a K range;
//   attention finalizes its item's q, k, v from QKV's sums, attends, and
//             quantizes its head's output per head;
//   out       the out-projection's tiles;
//   rows_up   finalizes the out-projection (the residual), RMSNorm(x, n3),
//             the int8 row for FFN up;
//   FFN up    its tiles;
//   gelu_rows finalizes FFN up, GELU(y + b1), the int8 row for FFN down;
//   FFN down  its tiles;
// and after the last layer one more rows phase finalizes its FFN down
// (8 L barriers a step).
constexpr int TW = 64;                  // output columns per tile (a strip:
                                        // 64-byte weight rows)
constexpr int TM = TW / 16;             // the strip's 16-column M tiles
constexpr int IK = 32;                  // logical k per chunk: the mma's K
constexpr int IROWS = 32;               // batch rows per pass: 4 N tiles
constexpr int IPAD = 32;                // bytes past each activation row
// attn_coop_i8's scratch a cache block
__host__ __device__ constexpr int coop_bytes(int dh) { return 12 + 4 * dh; }
enum RowsKind { RA = 0, RB = 1, RC = 2, RF = 3 };

// Product p (0 QKV, 1 out-projection, 2 FFN up, 3 FFN down) at head width
// dh: its output columns N, its inputs K and its fold group gsz in logical
// inputs (a head of dh for the out-projection, w4's scale group, or 0:
// a8's one dot).
__host__ __device__ inline void i8_geom(int p, int D, int group, int dh,
                                        int& N, int& K, int& gsz) {
  N = p == 0 ? 3 * D : p == 2 ? 4 * D : D;
  K = p == 3 ? 4 * D : D;
  gsz = p == 1 ? dh : group;
}

// The tiles, scratch and shared memory of one a8/w4 step for G blocks.
// Product p is cut into N / 64 strips x S K ranges of TR stored rows (K,
// or K / 2 packed); tile t = strip + NS s goes to block t mod G.  The
// region holds the attention groups' scratch, a rows phase's row (4D
// float32), its maxima, 1/rms and norm scale (D float32), or a tile's int8
// activation rows (w4: the hi and lo halves) beside its int32 sums (a8)
// or the scales of its fold groups; each of the two slots what is left of
// the block, and a piece of a block's tiles (TP of them) at a time.  S is the split whose
// tiles fit that (TR a multiple of 32 and of the fold group in stored
// rows) and that costs the busiest block least, at TR + TILE_COST rows a
// tile (its staging and barriers).  ops/mega_step.py's i8_step_plan
// computes the same.
struct I8Plan {
  int bp;                      // batch rows rounded up to 8
  int splits[4];               // per product: S
  int tp[4];                   // per product: tiles per piece
  int nxs;                     // activation scales per row (stride)
  int slot, region, bytes;
};
constexpr int I8_NO_FIT = 1 << 30;      // bytes of a plan that does not fit
constexpr int TILE_COST = 256;          // a tile's overhead, in rows

// Product p's tile of TR stored rows: its int8 rows and, after them, its
// scratch (a8: int32 sums [bp][64]; grouped: the scales of its fold
// groups, [groups][bp] and [groups][64]), in bytes.
__host__ __device__ inline int i8_tile_bytes(int p, int D, int group, int dh,
                                             int bp, int tr) {
  int N, K, gsz;
  i8_geom(p, D, group, dh, N, K, gsz);
  const int ngt = gsz ? (group ? 2 : 1) * tr / gsz : 0;
  return bp * ((group ? 2 : 1) * tr + IPAD) +
         (gsz ? ngt * (bp + TW) * 4 : bp * TW * 4);
}

__host__ __device__ inline I8Plan i8_plan(int B, int D, int H, int G,
                                          int group) {
  I8Plan pl{};
  const int dh = D / H;
  pl.bp = cdiv(B, 8) * 8;
  pl.nxs = cdiv(imax(H, group ? 4 * D / group : 1), 4) * 4;
  pl.region =
      cdiv(imax(PGROUPS * group_smem(dh), 20 * D + 4 * pl.nxs + 64), 16) * 16;
  const int budget = (SMEM_LIMIT - 1024 - pl.region - 16) / 2 / 1024 * 1024;
  bool ok = true;
  for (int p = 0; p < 4; ++p) {
    int N, K, gsz;
    i8_geom(p, D, group, dh, N, K, gsz);
    const int kst = group ? K / 2 : K, ns = N / TW;
    const int gst = imax(IK, gsz);      // stored rows per fold group
    int best = -1, bs = 0;
    for (int S = 1; S <= kst / gst; ++S) {
      const int tr = kst / S;
      if (kst % S || tr % gst || tr * TW > budget ||
          i8_tile_bytes(p, D, group, dh, pl.bp, tr) > pl.region)
        continue;
      const int cost = cdiv(ns * S, G) * (tr + TILE_COST);
      if (best < 0 || cost < best) best = cost, bs = S;
    }
    if (best < 0) {
      ok = false;
      continue;
    }
    const int tr = kst / bs, mine = cdiv(ns * bs, G);
    pl.splits[p] = bs;
    pl.tp[p] = imin(mine, budget / (tr * TW));
    pl.slot = imax(pl.slot, pl.tp[p] * tr * TW);
  }
  pl.slot = cdiv(pl.slot, 1024) * 1024;
  pl.bytes = ok ? 1024 + 2 * pl.slot + pl.region + 16 : I8_NO_FIT;
  return pl;
}

struct I8Args {
  const float* x;              // (B, D) in
  float* xo;                   // (B, D) out: the residual rows
  const int8_t* w[4];          // (L, K or K / 2, N): wq, wo, w1, w2
  const float *sq, *so, *s1, *s2, *n1, *n3, *bq, *bo, *b1, *b2;  // (L, n)
  const float *gq, *go, *g1, *g2;  // w4: (L, din / group, dout); else null
  AttnArgs att;                // layer 0's (its qkv unused)
  int8_t* rows8;               // (B, K) the next product's int8 rows
  float* xs[2];                // (B, nxs) scales: [0] the QKV and FFN-up
                               // inputs', [1] the out-projection's and
                               // FFN-down's
  int* acc;                    // (B, 4D) a8's int32 sums, zeroed
  float* terms;                // (groups, B, N) grouped products' terms
  unsigned* bar;               // the grid barrier's count, zeroed
  unsigned long long* trace;   // null, or 2 + 8 L phase-end times (ns)
  int L, nb_cap, group;
  I8Plan plan;                 // laid out for one block per SM
};

// The weight pieces in step order (layer, product, piece): `s` counts
// those consumed, (li, p, i) is the next one to issue.  Every block takes
// cdiv(its most tiles, TP) pieces of a product (some may be empty).
struct Ring {
  int s, li, p, i;
};

// lane (g, t) of four 8 x 8 matrices of 16-bit values, transposed: matrix j
// is the 8 rows (of 16 bytes) whose addresses lanes 8j..8j+7 give; the
// lane gets rows 2t and 2t + 1 of each at bytes 2g, 2g + 1
__device__ __forceinline__ void ldsm_x4_t(unsigned (&d)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr));
}

// d (16 x 8, int32) += a (16 x 32 s8) . b (32 x 8 s8): lane (g, t) holds
// a[g][4t..], a[g+8][4t..], a[g][16+4t..], a[g+8][16+4t..] (four bytes each),
// b[4t..][g], b[16+4t..][g] and d[g][2t], d[g][2t+1], d[g+8][2t],
// d[g+8][2t+1]
__device__ __forceinline__ void imma(int (&d)[4], const unsigned (&a)[4],
                                     const uint2& b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

// The pieces of product p every block takes.
__host__ __device__ inline int i8_pieces(const I8Plan& pl, int p, int D,
                                         int G) {
  const int N = p == 0 ? 3 * D : p == 2 ? 4 * D : D;
  return cdiv(cdiv(N / TW * pl.splits[p], G), pl.tp[p]);
}

// Piece i of product p of layer li into shared memory at dst: every thread
// copies 16-byte parts of its tiles' rows (64 bytes a row, four lanes a
// row, so a warp reads 8 whole rows a copy) with cp.async, which does not
// wait for the data.
__device__ void i8_issue(const I8Args& a, int li, int p, int i, uint32_t dst) {
  int N, K, gsz;
  i8_geom(p, a.att.D, a.group, a.att.D / a.att.H, N, K, gsz);
  const int G = gridDim.x, ns = N / TW, S = a.plan.splits[p];
  const int kst = a.group ? K / 2 : K, tr = kst / S, nt = ns * S;
  const int mine =
      (int)blockIdx.x < nt ? cdiv(nt - (int)blockIdx.x, G) : 0;
  const int j0 = i * a.plan.tp[p], j1 = imin(mine, j0 + a.plan.tp[p]);
  const int8_t* w = a.w[p] + (size_t)li * kst * N;
  const int part = threadIdx.x % (TW / 16), r0 = threadIdx.x / (TW / 16);
  constexpr int RSTEP = PT / (TW / 16);   // rows a pass of the block copies
  for (int jj = 0; jj < j1 - j0; ++jj) {
    const int t = (int)blockIdx.x + (j0 + jj) * G, strip = t % ns, s = t / ns;
    const int8_t* src = w + (size_t)(s * tr) * N + strip * TW + part * 16;
    const uint32_t d = dst + (uint32_t)(jj * tr * TW + part * 16);
#pragma unroll 4
    for (int r = r0; r < tr; r += RSTEP)
      cp_async16(d + (uint32_t)(r * TW), src + (size_t)r * N);
  }
}

__device__ __forceinline__ void ring_next(Ring& r, const I8Args& a) {
  if (++r.i < i8_pieces(a.plan, r.p, a.att.D, gridDim.x)) return;
  r.i = 0;
  if (++r.p < 4) return;
  r.p = 0;
  ++r.li;
}

// The next piece's weights: issue the one after it into the other slot
// (its last reader, the piece before, is done), then wait for this
// thread's copies of this one; the caller's __syncthreads then makes every
// thread's copies visible.  Each piece is one cp.async group (maybe empty).
__device__ void ring_begin(Ring& r, const I8Args& a, uint32_t slots) {
  if (r.li < a.L) {
    i8_issue(a, r.li, r.p, r.i, slots + ((r.s + 1) & 1) * a.plan.slot);
    ring_next(r, a);
  }
  asm volatile("cp.async.commit_group;\n"
               "cp.async.wait_group 1;" ::: "memory");
}

// One product's tiles on this block: for each tile, its K range of the B
// int8 rows (w4: the hi and the lo half) into shared memory, with the
// scales of its fold groups, then warp w takes items w, w + 16, .. of (M
// tile, segment, nibble half): a segment is a fold group (w4's group, in
// one nibble half an item, the out-projection's head) or, for a8's one
// dot, a quarter of the range.  An item sums its chunks in int32 registers (exact, in any
// order); a8 adds them into the tile's sums in shared memory (exact, in
// any order), which the block then adds into acc with global atomics, a
// row of 64 columns at a time; a fold group writes its terms float(dot) *
// (xs[b, g] * g[g, n]) (the out-projection: asx[b, h], and w4's go row of
// the head) to terms[g, b, n], which the next phase adds in group order.
template <bool W4>
__device__ __noinline__ void i8_product(const I8Args& a, uint32_t slots, uint8_t* region,
                           Ring& ring, int li, int p) {
  const int tid = threadIdx.x, G = gridDim.x, wi = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int B = a.att.B, D = a.att.D, group = a.group;
  const I8Plan& pl = a.plan;
  int N, K, gsz;
  i8_geom(p, D, group, D / a.att.H, N, K, gsz);
  const int ns = N / TW, S = pl.splits[p], kst = W4 ? K / 2 : K;
  const int tr = kst / S, nt = ns * S, bp = pl.bp;
  const int mine =
      (int)blockIdx.x < nt ? cdiv(nt - (int)blockIdx.x, G) : 0;
  const bool grouped = gsz > 0;
  const int nseg = grouped ? tr / gsz : imin(4, tr / IK);
  const int ngt = (W4 ? 2 : 1) * (grouped ? nseg : 0);   // tile's groups
  const int nch = tr / IK, half = W4 ? tr : 0;  // lo rows' offset in act
  const int astride = (W4 ? 2 : 1) * tr + IPAD;
  const size_t gstride = (size_t)B * N;        // the terms' group stride
  const float* xs = a.xs[p == 1 || p == 3 ? 1 : 0];
  const float* gsc =
      W4 ? (p == 0 ? a.gq : p == 1 ? a.go : p == 2 ? a.g1 : a.g2) +
               (size_t)li * (K / group) * N
         : nullptr;
  int8_t* act = reinterpret_cast<int8_t*>(region);
  int* tacc = reinterpret_cast<int*>(region + (size_t)bp * astride);
  float* tsx = reinterpret_cast<float*>(tacc);            // [ngt][bp]
  float* tgs = tsx + ngt * bp;                            // [ngt][TW]
  const int tp = pl.tp[p], npieces = i8_pieces(pl, p, D, G);
  // a tile's fold group gl: hi (or a8) groups, then lo ones
  const auto group_of = [&](int s, int gl) {
    return ((gl / nseg) * (K / 2) + s * tr + gl % nseg * gsz) / gsz;
  };

  if (!grouped)
    for (int e = tid; e < bp * TW; e += PT) tacc[e] = 0;
  for (int i = 0; i < npieces; ++i) {
    const int j0 = i * tp, j1 = imin(mine, j0 + tp);
    if (j1 <= j0) ring_begin(ring, a, slots);           // an empty piece
    for (int j = j0; j < j1; ++j) {
      const int t = (int)blockIdx.x + j * G, strip = t % ns, s = t / ns;
      // the tile's K range of the rows (rows past B: zeros), and the
      // scales of its fold groups
      const int n16 = (W4 ? 2 : 1) * tr / 16;
      for (int e = tid; e < bp * n16; e += PT) {
        const int b = e / n16, q = e - b * n16;
        const int k =
            q * 16 < tr ? s * tr + q * 16 : K / 2 + s * tr + q * 16 - tr;
        *reinterpret_cast<int4*>(act + (size_t)b * astride + 16 * q) =
            b < B ? __ldcg(reinterpret_cast<const int4*>(a.rows8 +
                                                         (size_t)b * K + k))
                  : make_int4(0, 0, 0, 0);
      }
      for (int e = tid; e < ngt * bp; e += PT) {
        const int gl = e / bp, b = e % bp;
        tsx[e] = b < B ? __ldcg(xs + (size_t)b * pl.nxs + group_of(s, gl))
                       : 0.f;
      }
      if (W4)
        for (int e = tid; e < ngt * TW; e += PT) {
          const int gl = e / TW, c = e % TW;
          tgs[e] = __ldg(gsc + (size_t)(group_of(s, gl) * gsz / group) * N +
                         strip * TW + c);
        }
      if (j == j0) ring_begin(ring, a, slots);            // the piece
      __syncthreads();
      const uint32_t wt =
          slots + (ring.s & 1) * pl.slot + (uint32_t)((j - j0) * tr) * TW;
      // items (M tile, segment, nibble half): w4's halves on two warps
      for (int it = wi; it < TM * nseg * (W4 ? 2 : 1); it += PWARPS) {
        const int m = it % TM, sg = it / TM % nseg, hl = it / TM / nseg;
        const int ca = grouped ? sg * gsz / IK : sg * nch / nseg;
        const int cb = grouped ? (sg + 1) * gsz / IK : (sg + 1) * nch / nseg;
        const int c0 = 16 * m + 2 * gq;           // the lane's columns
        for (int rp = 0; rp < bp; rp += IROWS) {
          const int ntl = imin(IROWS, bp - rp) / 8;
          {
            int acc[4][4] = {};                         // [N tile]
            for (int c = ca; c < cb; ++c) {
              unsigned d[4], af[4];
              ldsm_x4_t(d, wt + (uint32_t)(c * IK + lane) * TW + 16 * m);
              af[0] = __byte_perm(d[0], d[1], 0x6420);
              af[1] = __byte_perm(d[0], d[1], 0x7531);
              af[2] = __byte_perm(d[2], d[3], 0x6420);
              af[3] = __byte_perm(d[2], d[3], 0x7531);
              if (W4) {
#pragma unroll
                for (int q = 0; q < 4; ++q)
                  af[q] = (unsigned)nibbles(af[q], hl == 0);
              }
#pragma unroll
              for (int u = 0; u < 4; ++u)
                if (u < ntl)
                  imma(acc[u], af,
                       *reinterpret_cast<const uint2*>(
                           act + (size_t)(rp + 8 * u + gq) * astride +
                           hl * half + c * IK + 8 * tq));
            }
            const int gl = hl * nseg + sg;              // grouped: its group
            const size_t tb =
                grouped ? group_of(s, gl) * gstride + strip * TW + c0 : 0;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (u >= ntl) continue;
#pragma unroll
              for (int r2 = 0; r2 < 2; ++r2) {    // rows 2t and 2t + 1
                const int b = rp + 8 * u + 2 * tq + r2;
                const int v0 = acc[u][r2], v1 = acc[u][2 + r2];
                if (!grouped) {
                  atomicAdd(tacc + b * TW + c0, v0);
                  atomicAdd(tacc + b * TW + c0 + 1, v1);
                  continue;
                }
                if (b >= B) continue;
                const float sx = tsx[gl * bp + b];
                const float sc0 = W4 ? __fmul_rn(sx, tgs[gl * TW + c0]) : sx;
                const float sc1 =
                    W4 ? __fmul_rn(sx, tgs[gl * TW + c0 + 1]) : sx;
                *reinterpret_cast<float2*>(a.terms + tb + (size_t)b * N) =
                    make_float2(__fmul_rn(__int2float_rn(v0), sc0),
                                __fmul_rn(__int2float_rn(v1), sc1));
              }
            }
          }
        }
      }
      __syncthreads();
      if (!grouped)                 // the tile's sums, a row at a time
        for (int e = tid; e < B * TW; e += PT) {
          const int b = e / TW, c = e % TW;
          atomicAdd(a.acc + (size_t)b * N + strip * TW + c, tacc[e]);
          tacc[e] = 0;
        }
      __syncthreads();              // act (and the slot) are free again
    }
    ++ring.s;
  }
}

// GELU and the int8 pair of two values, as calls: the rows phases apply
// them in unrolled loops, and one copy each keeps the kernel's code small.
__device__ __noinline__ float gelu_call(float x) { return gelu(x); }
__device__ __noinline__ unsigned quant_pair(float h0, float h1, float sc) {
  return (unsigned)(uint8_t)quant(h0, sc) |
         ((unsigned)(uint8_t)quant(h1, sc) << 8);
}

// rms_rows' order (RT threads: thread t sums k = t, t + RT, ..; each warp's
// butterfly, lane 0's result; the warps in order) over one row in shared
// memory, by one warp: 1 / sqrt(sum(x^2) / K + 1e-6).
__device__ float rms_row(const float* xr, int K) {
  constexpr int NW = RT / 32;
  const int lane = threadIdx.x & 31;
  double ss[NW] = {};
  for (int k0 = 0; k0 < K; k0 += 4 * RT)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int wv = 0; wv < NW; ++wv)
        if (k0 + j * RT < K) {
          const float v = xr[k0 + j * RT + wv * 32 + lane];
          ss[wv] += (double)__fmul_rn(v, v);
        }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int wv = 0; wv < NW; ++wv)
      ss[wv] += __shfl_xor_sync(0xffffffffu, ss[wv], o);
  double tot = 0.0;
#pragma unroll
  for (int wv = 0; wv < NW; ++wv) tot += ss[wv];
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(
                            __fdiv_rn(__double2float_rn(tot), (float)K),
                            1e-6f)));
}

// A rows phase: block j of a grid of G takes batch rows j, j + G, .. (one
// row a block from B = 1 to the SM count; the loop keeps b uniform), one
// after another through the shared row.  A row's values into the shared
// row: RA/RF the residual x after the previous FFN down (or the input rows
// at layer 0), RB after the out-projection, both also written to xo; RC
// GELU(FFN up + b1).  Then (not RF) the next product's input: RA/RB
// h = (x r) n (r = 1 / rms), RC the GELU row; its maximum per row (a8) or
// group of `group` (w4): 8 inputs a thread, a warp's lanes of one group
// reduced by shuffles, one shared atomicMax per warp and group; the scales
// max / 127 into xs; the int8 row in chunk_pos order into rows8.
template <bool W4>
__device__ __noinline__ void i8_rows(const I8Args& a, int li, int kind, uint8_t* region) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int B = a.att.B, D = a.att.D, group = a.group;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    if (b != (int)blockIdx.x) __syncthreads();   // the last row is read
    const int nxs = a.plan.nxs;
    float* row = reinterpret_cast<float*>(region);          // up to 4D
    unsigned* amx = reinterpret_cast<unsigned*>(row + 4 * D);
    float* rs = reinterpret_cast<float*>(amx + nxs);
    float* nrm8 = rs + 16;                                  // D: the norm scale
    const int nrow = kind == RC ? 4 * D : D;
    const int gx = W4 ? group : nrow, nx = nrow / gx, n8 = nrow / 8;
    for (int i = tid; i < nx; i += PT) amx[i] = 0u;
    // the norm scale (RA/RB), loaded into shared memory ahead
    if (kind == RA || kind == RB) {
      const float* nrm = (kind == RA ? a.n1 : a.n3) + (size_t)li * D;
      for (int k = 4 * tid; k < D; k += 4 * PT)
        *reinterpret_cast<float4*>(nrm8 + k) =
            __ldg(reinterpret_cast<const float4*>(nrm + k));
    }
    // the values
    if (kind == RA && li == 0) {
      for (int n = tid; n < D; n += PT)
        row[n] = __ldcg(a.x + (size_t)b * D + n);
    } else {
      const int pp = kind == RB ? 1 : kind == RC ? 2 : 3;
      const int lp = kind == RB || kind == RC ? li : li - 1;  // its layer
      int N, K, gsz;
      i8_geom(pp, D, group, D / a.att.H, N, K, gsz);
      const int ng = gsz ? K / gsz : 0;
      const float* cs = pp == 1 ? a.so : pp == 2 ? a.s1 : a.s2;
      const float* bias = pp == 1 ? a.bo : pp == 2 ? a.b1 : a.b2;
      const float* xin = pp == 1 ? (li == 0 ? a.x : a.xo) : a.xo;
      const float xb =
          gsz ? 0.f : __ldcg(a.xs[pp == 2 ? 0 : 1] + (size_t)b * nxs);
      cs += (size_t)lp * N;
      bias += (size_t)lp * N;
      // a8: 8 outputs a round, their loads issued together
      if (!W4 && !gsz) {
#pragma unroll 1
        for (int n0 = 0; n0 < N; n0 += 8 * PT) {
          int q[8];
          float c8[8], b8[8], x8[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = n0 + j * PT + tid;
            const bool in = n < N;
            q[j] = in ? __ldcg(a.acc + (size_t)b * N + n) : 0;
            c8[j] = in ? __ldg(cs + n) : 0.f;
            b8[j] = in ? __ldg(bias + n) : 0.f;
            x8[j] = in && pp != 2 ? __ldcg(xin + (size_t)b * N + n) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = n0 + j * PT + tid;
            if (n >= N) continue;
            a.acc[(size_t)b * N + n] = 0;
            const float y =
                __fmul_rn(__int2float_rn(q[j]), __fmul_rn(xb, c8[j]));
            float v;
            if (pp == 2) {
              v = gelu_call(__fadd_rn(y, b8[j]));
            } else {
              v = __fadd_rn(__fadd_rn(x8[j], y), b8[j]);
              a.xo[(size_t)b * N + n] = v;
            }
            row[n] = v;
          }
        }
      } else {
        // grouped: up to 4 outputs a round (as many as 32 terms allow), their
        // terms, biases, scales and residuals loaded together
        const int step = W4 && ng <= 8 ? 4 : ng <= 16 ? 2 : 1;
        const size_t gstr = (size_t)B * N;
#pragma unroll 1
        for (int n0 = tid; n0 < N; n0 += step * PT) {
          const int cnt = imin(step, (N - n0 + PT - 1) / PT);
          float bn[4], sc[4], xv[4], y[4];
#pragma unroll
          for (int o = 0; o < 4; ++o) {
            const int n = n0 + o * PT;
            const bool in = o < cnt;
            bn[o] = in ? __ldg(bias + n) : 0.f;
            sc[o] = in && pp == 1 && !W4 ? __ldg(cs + n) : 1.f;
            xv[o] = in && pp != 2 ? __ldcg(xin + (size_t)b * N + n) : 0.f;
          }
          const float* t = a.terms + (size_t)b * N + n0;
          if (W4 && step == 4)            // (a8 folds the heads: 16 or more)
            fold_multi<4, 8>(t, PT, ng, gstr, cnt, y);
          else if (step == 2)
            fold_multi<2, 16>(t, PT, ng, gstr, cnt, y);
          else
            y[0] = fold_terms(t, ng, gstr);
#pragma unroll
          for (int o = 0; o < 4; ++o) {
            if (o >= cnt) break;
            const int n = n0 + o * PT;
            float yy = y[o];
            if (pp == 1 && !W4) yy = __fmul_rn(yy, sc[o]);
            float v;
            if (pp == 2) {
              v = gelu_call(__fadd_rn(yy, bn[o]));
            } else {
              v = __fadd_rn(__fadd_rn(xv[o], yy), bn[o]);
              a.xo[(size_t)b * N + n] = v;
            }
            row[n] = v;
          }
        }
      }
    }
    if (kind == RF) continue;
    __syncthreads();
    if (kind != RC && tid < 32) {
      const float r = rms_row(row, D);
      if (tid == 0) rs[0] = r;
    }
    __syncthreads();
    const float r = kind == RC ? 1.f : rs[0];
    const int span = imin(gx / 8, 32);
    // h = (x r) n (RA/RB) or the GELU row, 8 inputs from k
    const auto h8 = [&](int k, float (&h)[8]) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        h[e] = kind == RC ? row[k + e]
                          : __fmul_rn(__fmul_rn(row[k + e], r), nrm8[k + e]);
    };
    // the maxima: items of 8 a thread
#pragma unroll 1
    for (int i0 = 0; i0 < n8; i0 += PT) {
      const int i = i0 + tid;            // warp-uniform: n8 is a multiple of 32
      float m = 0.f;
      if (i < n8) {
        float h[8];
        h8(8 * i, h);
#pragma unroll
        for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(h[e]));
      }
      for (int s = 1; s < span; s <<= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
      if (i < n8 && (lane & (span - 1)) == 0)
        atomicMax(amx + 8 * i / gx, __float_as_uint(m));
    }
    __syncthreads();
    float* xs = a.xs[kind == RC ? 1 : 0] + (size_t)b * nxs;
    if (tid < nx) xs[tid] = qscale(__uint_as_float(amx[tid]), 1e-8f);
#pragma unroll 1
    for (int i = tid; i < n8; i += PT) {
      const float sc = qscale(__uint_as_float(amx[8 * i / gx]), 1e-8f);
      float h[8];
      h8(8 * i, h);
      int8_t* dst = a.rows8 + (size_t)b * nrow + chunk_pos(8 * i);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        *reinterpret_cast<uint16_t*>(dst + 8 * t) =
            (uint16_t)quant_pair(h[2 * t], h[2 * t + 1], sc);
    }
  }
}

template <bool W4, int DH>
__global__ void __launch_bounds__(PT, 1)
k2_i8_step_kernel(const __grid_constant__ I8Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const I8Plan& pl = a.plan;
  uint8_t* region = gbase + 2 * pl.slot;
  GroupSmem<DH>* groups = reinterpret_cast<GroupSmem<DH>*>(region);
  const int tid = threadIdx.x, G = gridDim.x;
  const int B = a.att.B, D = a.att.D, H = a.att.H, L = a.L;

  Ring ring{0, 0, 0, 0};
  i8_issue(a, 0, 0, 0, base);            // the first piece
  asm volatile("cp.async.commit_group;" ::: "memory");
  ring_next(ring, a);
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
  unsigned arrivals = 0;                 // grid_sync's target
  const int grp = tid / AT;
  const auto phase_end = [&]() {
    grid_sync(a.bar, arrivals);
    mark();
  };
  for (int li = 0; li < L; ++li) {
    i8_rows<W4>(a, li, RA, region);
    phase_end();
    i8_product<W4>(a, base, region, ring, li, 0);
    phase_end();
    // attention: (h, b) items, one per group of AT threads, each
    // finalizing its q, k, v and quantizing its output per head
    const AttnArgs at = attn_layer(a.att, li, a.nb_cap);
    const I8Fin fin{a.acc, a.terms, (size_t)B * 3 * D,
                    W4 ? D / a.group : 0, a.xs[0],
                    a.sq + (size_t)li * 3 * D, a.bq + (size_t)li * 3 * D,
                    pl.nxs};
    uint8_t* spare = gbase + ((ring.s + 1) & 1) * pl.slot;  // read by none
    // a8 (the serving default up to B = 8): a block per item when there
    // are no more items than blocks (w4, the CLI's B = 32 chunks, keeps
    // its kernel's code small: it would not take this path there)
    if (!W4 && H * B <= G &&
        (a.nb_cap + 1) * coop_bytes(DH) + 16 + 2 * STAGE * DH * 4 <= pl.slot) {
      if ((int)blockIdx.x < H * B)       // a block per item
        attn_coop_i8<DH>(at, blockIdx.x / B, blockIdx.x % B, groups, fin,
                         spare);
    } else {
      for (int it = blockIdx.x * PGROUPS + grp; it < H * B;
           it += G * PGROUPS)
        attn_group<DH, true, W4>(at, nullptr, it / B, it % B, groups[grp],
                                 1 + grp, fin);
    }
    phase_end();
    i8_product<W4>(a, base, region, ring, li, 1);
    phase_end();
    i8_rows<W4>(a, li, RB, region);
    phase_end();
    i8_product<W4>(a, base, region, ring, li, 2);
    phase_end();
    i8_rows<W4>(a, li, RC, region);
    phase_end();
    i8_product<W4>(a, base, region, ring, li, 3);
    phase_end();
  }
  i8_rows<W4>(a, L, RF, region);
  mark();
}

// ------------------------------------------------------------ launches
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

// The kernels' instantiations at head width dh (32, 64 or 128), or null.
const void* bf16_kernel(int dh) {
  return dh == 32    ? (const void*)k2_bf16_step_kernel<32>
         : dh == 64  ? (const void*)k2_bf16_step_kernel<64>
         : dh == 128 ? (const void*)k2_bf16_step_kernel<128>
                     : nullptr;
}
template <bool W4>
const void* i8_kernel_at(int dh) {
  return dh == 32    ? (const void*)k2_i8_step_kernel<W4, 32>
         : dh == 64  ? (const void*)k2_i8_step_kernel<W4, 64>
         : dh == 128 ? (const void*)k2_i8_step_kernel<W4, 128>
                     : nullptr;
}
const void* i8_kernel(bool w4, int dh) {
  return w4 ? i8_kernel_at<true>(dh) : i8_kernel_at<false>(dh);
}

}  // namespace

// The bf16 branch's grid at head width `head_dim` for a dynamic shared
// memory of `smem` bytes (the wrapper's bf16_step_plan): occupancy x the
// SM count, into *grid.
extern "C" int fused_trunk_step_bf16_grid(int head_dim, int smem,
                                          int* grid) {
  const void* fn = bf16_kernel(head_dim);
  if (fn == nullptr || smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  return coop_grid(fn, smem, grid);
}

// One trunk step for all L layers on the bf16 branch (bf16 activations x
// int8 weights): one cooperative launch of k2_bf16_step_kernel.  Shapes
// and layouts as in the wrapper (vae_gslm_tpu_torch/ops/mega_step.py;
// head_dim D / H of 32, 64 or 128, the instantiation launched; D a
// multiple of 256); `work` holds qkv (B, 3D)
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
  const void* fn = H > 0 && D % H == 0 ? bf16_kernel(D / H) : nullptr;
  if (B < 1 || D % 256 || fn == nullptr) return (int)cudaErrorInvalidValue;
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
  err = coop_grid(fn, smem, &grid);
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
  return (int)cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(PT), params,
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

// The a8/w4 step's plan on this card (i8_plan for one block per SM) and its
// grid for a dynamic shared memory of `smem` bytes: occupancy x the SM
// count, into *grid, and the plan's bytes into *bytes.
extern "C" int fused_trunk_step_i8_grid(int B, int D, int H, int group,
                                        int smem, int* grid, int* bytes) {
  int dev, nsm;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return err;
  const void* fn =
      H > 0 && D % H == 0 ? i8_kernel(group != 0, D / H) : nullptr;
  if (fn == nullptr || smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  *bytes = i8_plan(B, D, H, nsm, group).bytes;
  return coop_grid(fn, smem, grid);
}

// One trunk step for all L layers on the a8 branch (group 0: int8 weights,
// s8 x s8 products) or the w4 branch (group 64 or 128, dividing D / 2 and
// a multiple of the head width:
// wq/wo/w1/w2 nibble-packed, gq/go/g1/g2 their group scales; sq/so/s1/s2
// then not read): one cooperative launch of k2_i8_step_kernel.  Shapes and
// layouts as fused_trunk_step_bf16_launch's; `work` holds the grid
// barrier's word (16 bytes) and, for a8, the int32 sums (B, 4D), both
// zeroed here, then the fold terms of the grouped products (groups x B x
// N float32, the largest product's), the int8 rows
// (B, 4D) and two arrays of activation scales (B, nxs) float32
// (ops/mega_step.py's i8_workspace_bytes); `trace` null or 2 + 8 L words
// for block 0's phase-end times; `smem` the wrapper's plan, refused
// unless it holds i8_plan for one block per SM.
extern "C" int fused_trunk_step_i8_launch(
    const void* x, void* x_out, const void* wq, const void* wo,
    const void* w1, const void* w2, const void* sq, const void* so,
    const void* s1, const void* s2, const void* n1, const void* n3,
    const void* bq, const void* bo, const void* b1, const void* b2,
    const void* slopes, const void* k_cold, const void* v_cold,
    const void* kc_scale, const void* vc_scale, const void* k_tail,
    const void* v_tail, const void* kt_scale, const void* vt_scale,
    const void* k_stage, const void* v_stage, void* k_new, void* v_new,
    void* work, const void* gq, const void* go, const void* g1,
    const void* g2, void* trace, int L, int B, int D, int H, int nb_cap,
    int pos, int flushed, int group, float scale, int smem, void* stream) {
  const void* fn =
      H > 0 && D % H == 0 ? i8_kernel(group != 0, D / H) : nullptr;
  if (B < 1 || D % 256 || fn == nullptr ||
      (group != 0 && group != 64 && group != 128) ||
      (group && (D % (2 * group) || group % (D / H))))
    return (int)cudaErrorInvalidValue;
  int dev, nsm;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return err;
  const I8Plan plan = i8_plan(B, D, H, nsm, group);
  if (smem < plan.bytes || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  int grid;
  err = coop_grid(fn, smem, &grid);
  if (err) return err;
  const auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  size_t terms_n = 0;                    // the largest grouped product's
  for (int p = 0; p < 4; ++p) {
    int N, K, gsz;
    i8_geom(p, D, group, D / H, N, K, gsz);
    if (gsz) terms_n = imax((int)terms_n, N * (K / gsz));
  }
  const size_t acc_n = group ? 0 : (size_t)4 * D;
  unsigned* bar = static_cast<unsigned*>(work);
  int* acc = reinterpret_cast<int*>(bar + 4);
  float* terms = reinterpret_cast<float*>(acc + (size_t)B * acc_n);
  // the terms: (groups, B, N) of the largest grouped product
  int8_t* rows8 = reinterpret_cast<int8_t*>(terms + (size_t)B * terms_n);
  float* xs0 = reinterpret_cast<float*>(rows8 + (size_t)B * 4 * D);
  float* xs1 = xs0 + (size_t)B * plan.nxs;
  err = (int)cudaMemsetAsync(work, 0, 16 + 4 * (size_t)B * acc_n,
                             static_cast<cudaStream_t>(stream));
  if (err) return err;
  I8Args args{static_cast<const float*>(x), static_cast<float*>(x_out),
              {i8(wq), i8(wo), i8(w1), i8(w2)},
              f32(sq), f32(so), f32(s1), f32(s2), f32(n1), f32(n3),
              f32(bq), f32(bo), f32(b1), f32(b2),
              f32(gq), f32(go), f32(g1), f32(g2),
              AttnArgs{nullptr,
                       i8(k_cold), i8(v_cold), f32(kc_scale),
                       f32(vc_scale), i8(k_tail), i8(v_tail),
                       f32(kt_scale), f32(vt_scale),
                       static_cast<const __nv_bfloat16*>(k_stage),
                       static_cast<const __nv_bfloat16*>(v_stage),
                       f32(slopes),
                       static_cast<__nv_bfloat16*>(k_new),
                       static_cast<__nv_bfloat16*>(v_new),
                       rows8, xs1,
                       B, H, D, flushed / BLK, pos, flushed, scale},
              rows8, {xs0, xs1}, acc, terms, bar,
              static_cast<unsigned long long*>(trace), L, nb_cap, group,
              plan};
  void* params[] = {&args};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(PT), params,
                                          (size_t)smem,
                                          static_cast<cudaStream_t>(stream));
}
