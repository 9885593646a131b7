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
// K5 (any Tq and Tk, no lse) are the (B, H, T, D) forwards that
// JAX runs off the packed envelope and under a data-parallel mesh; K4b
// (Tq = Tk <= 1024, lse from K4) and K5b (any Tq, Tk up to 8192, its own
// row statistics) are the backwards of that (B, H, T, D) custom VJP.  The
// three forwards share a tiled float32 body (fwd_f32); K3 and K4 in
// bfloat16 have a Hopper body of their own (fwd_wgmma: wgmma, TMA, K
// resident), K5 in bfloat16 another (fwd_stream_wgmma: K streamed); the
// three backwards share one body in float32 (dq_f32, dkv_f32) and in
// bfloat16 a Hopper body of their own (bwd_wgmma; K3b's packed operands
// are the same tensor maps with a head stride of head_dim).
// Each has an entry point and kernel symbols of its own
// (k3_/k4_/k5_fwd*, k3b_/k4b_/k5b_{dq,dkv}*), so a profile tells them
// apart.  Every operand is read
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
// shared memory an H100 block can use, so these kernels are tiled.
//   * forward, bfloat16: pass 1 walks the key tiles for the row max and
//     sum (online); pass 2 recomputes the logits, forms the normalized,
//     rounded p and accumulates p . v.  The probabilities are normalized
//     before P.V, as the TPU kernel does, since p is rounded to bf16
//     before P.V.
//   * forward, float32: one pass, one block per (128-query tile, head,
//     batch): the softmax online, O rescaled as the row max grows and
//     divided by l once at the end (fwd_f32 below: p is not rounded, so
//     only the last bits of each term move).
//   * backward: two launches and no atomics, so runs agree bit for bit:
//     one block per query tile walks the key tiles for dq, then one per
//     key tile walks the query tiles for dk and dv.  K5b, which gets no
//     lse, takes each row's m and l in the dq kernel's first pass and
//     writes them for the dk/dv kernel; whether a body reads l is a
//     template parameter, so K3b and K4b compile without it.  The TPU's q-tile
//     grid that carries dk/dv across sequential steps (K5b) becomes the
//     key-tile block's own loop over the query tiles.
// Key tiles past the causal edge or at or past lengths[b] add exact zeros
// and are skipped, but only when lengths[b] >= 1: a row of length 0 is
// uniform over all Tk keys, as in the reference.
//
// Two element types, two product routes.  bfloat16 (the training path
// under 16-mixed) multiplies on the tensor cores with wgmma (below);
// exact bf16 products, float32 sums in the hardware's order.  float32
// multiplies with scalar FMAs out of shared memory (8 x 4 outputs per
// thread and product, float4 operand loads, forward and backward), since
// the tensor cores would round its operands to TF32.
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
// 64 (at 32 and 128, whose scales are not, the product and the sum are
// rounded apart, as the plain version rounds them: logit<D>);
// exponentials are ex2.approx of (x - m) * log2(e); p is exp(.)
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
// bound by its products: ~42 GFLOP of causal pairs at the 67 TFLOP/s
// float32 rate of the FMA units (~0.62 ms) against ~0.2 GB of HBM
// traffic (~0.07 ms); so are K3 and K5 at the scoring path's B 64
// (103 and 316 GFLOP).  The one-pass float32 body forms those two
// products and no third, on a register tile that leaves the FMA pipes,
// not shared memory, the limit; the logits and exponentials (~12
// instructions per pair against 128 FMAs) come on top.  The float32
// backward (dq_f32, dkv_f32 below) is bound the same way: 14.0 GFLOP at
// K4b's training call (~0.21 ms at 67 TFLOP/s) against ~0.13 GB.
//
// K5 bfloat16 forward (fwd_stream_wgmma).  The same two passes as
// fwd_wgmma, but Tk has no bound (8192 keys are 128 key tiles, 1 MB of
// K per (batch, head)), so no key tile stays resident: a producer warp loads
// Q once by TMA and streams K (pass 1), then K and V (pass 2), through
// one ring of `stages` stages of a K and a V tile (full/empty
// mbarriers); the plan (k5_fwd_plan) is the same for every Tq and Tk.
// Two consumer warpgroups share each K/V tile, 64 query rows each, which
// halves the K/V traffic per query row against one; each walks its own
// key tiles (the causal edge of its rows) and only frees the stages of
// the longer walk it does not read.  Query blocks of 128 rows run the
// longest causal walks first.  S = Q K^T (wgmma m64n64k16, both
// operands K-major) and O += P V (P's bf16 A fragments in registers, V
// MN-major) overlap the softmax as in fwd_wgmma, with fwd_wgmma's
// numerics (fmaf logit, ex2.approx, p as the product with 1/l); keys
// past Tk take -inf.  At chip_smoke.py's K5 call (B 8, T 1750) the
// products are 41.7 GFLOP (42 us at the bf16 peak) and both passes'
// exponentials and logits, ~20 instructions per element of each walked
// 64 x 64 tile, bound it, as fwd_wgmma.
//
// K3b/K4b/K5b bfloat16 backward (bwd_wgmma).  Two launches, no atomics, so
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
// (K5b: six, its statistics recompute Q K^T).  K3b reads K3's lse as
// K4b reads K4's (a row of length 0: p = 1 on every key); its packed q,
// k and v may be views of one fused projection, so the wrapper checks
// the 16-byte base and stride alignment that a tensor map needs.
//
// Head widths.  Every body is a template on D, instantiated at 32, 64
// and 128 (the widths JAX's packed grouping takes that the shipped and
// planned trunks use), the launchers dispatching on head_dim.  A bf16
// tile of 64 rows keeps its rows in column blocks of at most 128 bytes
// (Tile<D>: one 128B-swizzled block at D = 64, two at D = 128, loaded as
// two TMA boxes; one 64B-swizzled block of 64-byte rows at D = 32), so
// Q K^T walks D / 16 k16 steps and the products whose n runs along D
// (P V, dS K, P^T dO, dS^T Q) are m64nDk16.  K3/K4's resident K holds
// at most resident_tiles<D>() key tiles (11 at D = 128: T <= 704); past
// them K3/K4 run fwd_stream_wgmma, which writes lse at the end of its
// pass-1 statistics, so the routing stays JAX's (T <= 1024).  The
// float32 bodies keep their per-element sum orders at every width and
// take 64 query rows a block at D = 128 so that the plan fits (F32<D>).
//
// Each launch function returns cudaGetLastError() after its launches.

#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Every body is a template on the head width D, instantiated at D = 32,
// 64 and 128 (HEAD_DIMS in ops/flash_attention.py; the launchers
// dispatch on the head_dim they are given and refuse any other).
constexpr int TILE = 64;        // query and key rows per tile
constexpr int NT = 256;         // threads per block of the float32 bodies
constexpr float NEG_INF = -1e30f;

struct Seq {             // one operand's element strides: batch, head and
  long long bs, hs, rs;  // row; the feature axis is contiguous
};

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

// ------------------------------------------------------------------
// The float32 forward (K3, K4 and K5 in float32): one pass over the key
// tiles with the softmax taken online, products on the FMA units.
//
// One block of 256 threads per (128-query tile, head, batch), the query
// tiles in the grid's slowest axis from the last (the longest causal
// walks) to the first, and aligned to end at Tq, so that a ragged tile is
// the first, whose walk is the shortest, and no row past Tq is computed.
// Warp w owns query rows [16 w, 16 w + 16) of the tile; lane (rg = lane
// / 16, cg = lane % 16) owns rows 16 w + rg + 2 i (i < 8) and, of a
// 64-key tile, keys cg + 16 j of S = Q K^T and output
// columns 4 cg + j of O (j < 4): an 8 x 4 register tile per product, 32
// FMAs for every 12 floats read from shared memory, so a warp's operand
// loads (two distinct Q rows, sixteen K rows of a padded pitch, or
// sixteen consecutive V quads: conflict-free) keep shared memory at
// about half its rate while the FMA pipes run full.  That is the D = 64
// geometry; at width D a lane owns D / 16 output columns (chunks of four,
// or of two at D = 32, 16 chunks apart: conflict-free), and at D = 128 a
// block takes 64 query rows (4 a lane: RI = FQ / 16 rows) so that the
// plan fits.  Q stays resident;
// K and V tiles come in by 16-byte cp.async (zero fill past Tk) two
// stages deep, the next tile's bytes in flight while this tile's
// products run.  Per key tile: S, the logits (tiles wholly inside the
// length and causal edges skip the masks), the row max over the 16
// lanes, O and the lanes' partial sums l rescaled by ex2((m_old - m_new)
// log2 e) (1 unless the max grew; a branch on it read slower), p = ex2((x
// - m) log2 e) into shared memory, then O += P V.  Three barriers a tile
// (one fewer, the copy's wait folded into the first, read no faster).  The row's l is summed over its lanes and O divided by
// it once at the end, so Q K^T is formed once per (query, key) pair
// (the two-pass body formed it twice): two products of 2 D FLOPs per
// pair, the count the bound takes.  Numerics against the plain version
// (exp(s - m) / l before P.V): the logit is rounded exactly as the plain
// version rounds it; each p carries ex2.approx's error (2 ulps) and the
// rounding of (x - m) log2 e; each rescale of O adds an ulp; float32 p
// is not rounded to V's dtype, so the order of normalisation changes
// only the last bits of each term.  The plan (F32<D>::FWD_SMEM bytes,
// FQ-row query tiles, two stages) is ops/flash_attention.py's
// f32_fwd_plan, which the launcher checks.
// ------------------------------------------------------------------
constexpr int FK = 64;                  // keys (or queries) per tile
constexpr int PP = FK + 4;              // pitch (floats) of P and dS rows
constexpr int F_STAGES = 2;
constexpr float F_LOG2E = 1.4426950408889634f;

// The float32 bodies' geometry at head width D.
template <int D>
struct F32 {
  static constexpr int FQ = D == 128 ? 64 : 128;   // rows per block
  static constexpr int RI = FQ / 16;   // rows per lane (a warp: 2 RI)
  static constexpr int FP = D + 4;     // pitch (floats) of Q, K, dO rows
  static constexpr int CW = D >= 64 ? 4 : 2;   // output columns per chunk
  static constexpr int NC = D / 16 / CW;       // chunks per lane
  static constexpr int FWD_SMEM =
      (FQ * FP + F_STAGES * FK * FP + F_STAGES * FK * D + FQ * PP) * 4;
  static constexpr int BWD_SMEM =
      (2 * FQ * FP + FQ * PP + F_STAGES * (2 * FK * FP + 3 * FK)) * 4;
  static_assert(FWD_SMEM <= 232448, "the float32 forward's plan");
  static_assert(BWD_SMEM <= 232448, "the float32 backward's plan");
};

// Output column e of chunk u of lane cg (CW columns a chunk, the chunks
// 16 CW apart, so a half-warp's loads of one chunk are contiguous).
template <int D>
__device__ __forceinline__ int f32_col(int cg, int u) {
  return F32<D>::CW * cg + 16 * F32<D>::CW * u;
}

// CW contiguous floats (16 or 8 bytes) from shared or global memory.
template <int CW>
__device__ __forceinline__ void ld_cw(float* x, const float* p) {
  if constexpr (CW == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  }
}
template <int CW>
__device__ __forceinline__ void st_cw(float* p, const float* x) {
  if constexpr (CW == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}

__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool fill) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows [r0, r0 + rows) of one head into shared memory at `pitch` floats
// a row, 16 bytes per cp.async; rows before 0 or at or past t_len are
// zero filled.
template <int D>
__device__ __forceinline__ void rows_async(float* dst, int pitch,
                                          const float* src, long long rs,
                                          int r0, int rows, int t_len) {
  for (int idx = threadIdx.x; idx < rows * (D / 4); idx += NT) {
    const int r = idx / (D / 4), c = idx % (D / 4) * 4, t = r0 + r;
    const bool in = t >= 0 && t < t_len;
    cp16(dst + r * pitch + c, in ? src + t * rs + c : src, in);
  }
}

// Key tiles [0, end) that can hold a nonzero probability for the query
// rows [q0, q0 + FQ) (q0 + FQ <= tq) over tk keys: all of them for a row
// set of length 0.
template <int FQ>
__device__ __forceinline__ int key_tiles_f32(int q0, int len, int tk,
                                             int causal) {
  int end = (tk + FK - 1) / FK;
  if (len >= 1) {
    end = min(end, (len + FK - 1) / FK);
    if (causal) end = min(end, (q0 + FQ - 1) / FK + 1);
  }
  return end;
}

template <int D>
__device__ __forceinline__ void fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, const int* __restrict__ lengths,
    const float* __restrict__ slopes, Seq sq, Seq sk, Seq sv, Seq so,
    int tq, int tk, int nheads, int causal, float scale) {
  using G = F32<D>;
  constexpr int FQ = G::FQ, RI = G::RI, FP = G::FP, CW = G::CW, NC = G::NC;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [FQ][FP]
  float* Ks = Qs + FQ * FP;                      // [stage][FK][FP]
  float* Vs = Ks + F_STAGES * FK * FP;           // [stage][FK][D]
  float* Ps = Vs + F_STAGES * FK * D;            // [FQ][PP]
  // query tile qt holds rows [q0, q0 + FQ), the tiles aligned to end at
  // tq: a ragged tile is the first, whose causal walk is the shortest
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int q0 = qt * FQ - ((int)gridDim.z * FQ - tq);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 4, cg = lane & 15;
  const int qrow = w * 2 * RI + rg;              // + 2 i
  const int len = lengths[b];
  const int use_alibi = slopes != nullptr;
  const float slope = use_alibi ? slopes[h] : 0.f;
  const float* kb = k + b * sk.bs + h * sk.hs;
  const float* vb = v + b * sv.bs + h * sv.hs;
  const int kt_end = key_tiles_f32<FQ>(q0, len, tk, causal);

  rows_async<D>(Qs, FP, q + b * sq.bs + h * sq.hs, sq.rs, q0, FQ, tq);
  rows_async<D>(Ks, FP, kb, sk.rs, 0, FK, tk);
  rows_async<D>(Vs, D, vb, sv.rs, 0, FK, tk);
  cp_commit();

  float acc[RI][NC * CW], m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY, l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC * CW; ++j) acc[i][j] = 0.f;
  }
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * FK, st = kt & 1;
    __syncthreads();                 // tile kt - 1's K, V and P are read
    if (kt + 1 < kt_end) {           // tile kt + 1 into the other stage
      rows_async<D>(Ks + (st ^ 1) * FK * FP, FP, kb, sk.rs, k0 + FK, FK, tk);
      rows_async<D>(Vs + (st ^ 1) * FK * D, D, vb, sv.rs, k0 + FK, FK, tk);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                 // tile kt is in shared memory
    const float* Kt = Ks + st * FK * FP;
    const float* Vt = Vs + st * FK * D;

    float s[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Kt + (cg + 16 * j) * FP + d);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (qrow + 2 * i) * FP + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }

    // logits, the online softmax and P: one copy of the body for tiles
    // inside the length and causal edges, which skip the masks, and one
    // for edge tiles; c - r as a float from one conversion a tile (exact
    // integers)
    const float dist0 = (float)(k0 + cg - q0 - qrow);
    auto softmax = [&](auto edge) {
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = q0 + qrow + 2 * i;
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = k0 + cg + 16 * j;
          float x = __fmul_rn(s[i][j], scale);
          if (use_alibi)
            x = __fadd_rn(x,
                          __fmul_rn(slope, fabsf(dist0 + (16 * j - 2 * i))));
          if (decltype(edge)::value) {
            const bool valid = c < len && (!causal || c <= r);
            x = c < tk ? (valid ? x : NEG_INF) : -INFINITY;
          }
          s[i][j] = x;
          tmax = fmaxf(tmax, x);
        }
        const float m_new = fmaxf(m[i], row_max(tmax));
        const float alpha = ex2((m[i] - m_new) * F_LOG2E);   // 1 or less
        m[i] = m_new;
        float e_sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = ex2((s[i][j] - m_new) * F_LOG2E);
          e_sum += p;
          Ps[(qrow + 2 * i) * PP + cg + 16 * j] = p;
          // O's columns rescaled beside the keys (at D = 64 one a key)
#pragma unroll
          for (int e = j * NC * CW / 4; e < (j + 1) * NC * CW / 4; ++e)
            acc[i][e] *= alpha;
        }
        l[i] = fmaf(l[i], alpha, e_sum);
      }
    };
    if (len >= 1 && k0 + FK <= min(len, tk) && (!causal || k0 + FK - 1 <= q0))
      softmax(std::false_type{});
    else
      softmax(std::true_type{});
    __syncthreads();                 // P is in shared memory

#pragma unroll 4
    for (int n = 0; n < FK; n += 4) {
      float vv[4][NC * CW];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          ld_cw<CW>(vv[u] + c * CW, Vt + (n + u) * D + f32_col<D>(cg, c));
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float4 pv =
            *reinterpret_cast<const float4*>(Ps + (qrow + 2 * i) * PP + n);
        const float pp[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int j = 0; j < NC * CW; ++j)
            acc[i][j] = fmaf(pp[u], vv[u][j], acc[i][j]);
      }
    }
  }
  cp_wait<0>();

  float* ob = o + b * so.bs + h * so.hs;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + qrow + 2 * i;
    const float lr = row_sum(l[i]);
    if (r < 0) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float y[CW];
#pragma unroll
      for (int e = 0; e < CW; ++e) y[e] = __fdiv_rn(acc[i][c * CW + e], lr);
      st_cw<CW>(ob + r * so.rs + f32_col<D>(cg, c), y);
    }
    if (lse && cg == 0)
      lse[((long long)b * nheads + h) * tq + r] = m[i] + logf(lr);
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
template <int D>
__global__ void __launch_bounds__(NT, 1) k3_fwd_kernel(FWD_F32_ARGS) {
  fwd_f32<D>(FWD_PASS);
}
template <int D>
__global__ void __launch_bounds__(NT, 1) k4_fwd_kernel(FWD_F32_ARGS) {
  fwd_f32<D>(FWD_PASS);
}
template <int D>
__global__ void __launch_bounds__(NT, 1) k5_fwd_kernel(FWD_F32_ARGS) {
  fwd_f32<D>(FWD_PASS);
}

// ------------------------------------------------------------------
// The float32 backward (K3b, K4b and K5b in float32): two launches, the
// dq kernel then the dk/dv kernel, products on the FMA units.
//
// Both kernels take fwd_f32's geometry: one block of 256 threads keeps
// 128 rows of one side resident (Q and dO in the dq kernel, K and V in
// the dk/dv kernel) and walks 64-row tiles of the other side, which
// come in by 16-byte cp.async two stages deep (zero fill outside [0,
// T)), the next tile's bytes in flight while this tile's products run.
// Warp w owns resident rows [16 w, 16 w + 16); lane (rg = lane / 16, cg
// = lane % 16) owns rows 16 w + rg + 2 i (i < 8), streamed rows cg + 16
// j (j < 4) of the logit-side products and output columns 4 cg + j of
// the gradient products: an 8 x 4 register tile per product, fed by
// float4 loads of rows as they lie (pitch FP, conflict-free), so no
// tile is ever copied transposed:
//   dq kernel   S = Q K^T, dP = dO V^T (resident rows by streamed rows
//               along D), ds in registers, then through the warp's own
//               rows of a shared tile into dQ += dS K;
//   dk/dv kernel S^T = K Q^T, dP^T = V dO^T, p^T and ds^T in registers
//               and through the warp's own rows of the shared tile into
//               dV += P^T dO and dK += dS^T Q.
// A row of the shared P/dS tile is written and read by one warp, so the
// warp's own barrier orders it; the ring takes two block barriers a
// tile.  dk and dv are summed in float32 over the key tile's query
// tiles inside one block and rounded once; no atomics, so runs agree
// bit for bit.  Per (query, key) pair the two kernels form seven
// products of 2 D FLOPs (S and dP in both), K5b eight (its statistics
// form S once more), against the five the bound counts.
//
// The dq kernel runs first, one block per (128-query tile, head, batch),
// the tiles aligned to end at Tq (a ragged tile is the first, the
// shortest causal walk) and launched from the last (the longest); K5b's
// pass 1 walks the key tiles for each row's m and l (online, the
// forward's pass; K tiles alone) and writes them to rowa and rowl for
// the dk/dv kernel, one block per (128-key tile, head, batch), key tile
// 0 (the longest causal walk) first.  Numerics: the logit as fwd_f32
// rounds it; p = expf(x - lse) (K3b, K4b; a row of length 0 has p = 1 on
// every key) or expf(x - m) / l (K5b, the quotient correctly rounded by
// one FMA correction of its product by 1/l: 1 / Tk on a row of length
// 0); ds = p (dp - delta); every sum over D, keys or queries in order,
// as the plain version's loops.  At head width D the geometry is
// fwd_f32's (FQ = 64 resident rows at D = 128, 128 below; D / 16 output
// columns a lane), with the same sum orders.  The plan (F32<D>::BWD_SMEM
// bytes, F_STAGES) is ops/flash_attention.py's f32_bwd_plan, which the
// launcher checks.
// ------------------------------------------------------------------

// 4-byte cp.async (zero fill unless `fill`).
__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    bool fill) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(fill ? 4 : 0)
               : "memory");
}

// s[i][j] = sum_d A[row + 2 i][d] B[cg + 16 j][d], in order over d: A
// the resident rows, B a streamed 64-row tile, both at pitch FP.
template <int D>
__device__ __forceinline__ void rows_by_rows(float (&s)[F32<D>::RI][4],
                                             const float* A,
                                             const float* Bt, int row,
                                             int cg) {
  constexpr int RI = F32<D>::RI, FP = F32<D>::FP;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; d += 4) {
    float4 bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(Bt + (cg + 16 * j) * FP + d);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float4 av =
          *reinterpret_cast<const float4*>(A + (row + 2 * i) * FP + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av.x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av.y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av.z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av.w, bv[j].w, s[i][j]);
      }
    }
  }
}

// acc[i][.] += sum_n P[row + 2 i][n] X[n][lane cg's columns] over the 64
// n of a tile, in order: P the warp's own rows of the shared tile (pitch
// PP), X a streamed tile (pitch FP).
template <int D>
__device__ __forceinline__ void rows_times_tile(
    float (&acc)[F32<D>::RI][D / 16], const float* P, const float* X,
    int row, int cg) {
  constexpr int RI = F32<D>::RI, FP = F32<D>::FP, CW = F32<D>::CW;
  constexpr int NC = F32<D>::NC;
#pragma unroll 4
  for (int n = 0; n < FK; n += 4) {
    float xv[4][NC * CW];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        ld_cw<CW>(xv[u] + c * CW, X + (n + u) * FP + f32_col<D>(cg, c));
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float4 pv =
          *reinterpret_cast<const float4*>(P + (row + 2 * i) * PP + n);
      const float pp[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < NC * CW; ++j)
          acc[i][j] = fmaf(pp[u], xv[u][j], acc[i][j]);
    }
  }
}

// Lane cg's columns of one gradient row into global memory, times
// `scale` with SCALED (dq, dk; dv is written as summed).
template <int D, bool SCALED>
__device__ __forceinline__ void store_row_f32(float* dst, const float* acc,
                                              int cg, float scale) {
  constexpr int CW = F32<D>::CW, NC = F32<D>::NC;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float y[CW];
#pragma unroll
    for (int e = 0; e < CW; ++e)
      y[e] = SCALED ? __fmul_rn(acc[c * CW + e], scale) : acc[c * CW + e];
    st_cw<CW>(dst + f32_col<D>(cg, c), y);
  }
}

// The backward's logit of a dot product at |key - query| = dist, as
// fwd_f32 rounds it.
__device__ __forceinline__ float logit_f32(float dot, float dist,
                                           float slope, float scale,
                                           int use_alibi) {
  const float x = __fmul_rn(dot, scale);
  return use_alibi ? __fadd_rn(x, __fmul_rn(slope, dist)) : x;
}

// p of a logit from its query row's statistics: expf(x - lse) (a =
// lse), or with HAVE_L expf(x - m) / l (a = m; inv = 1 / l), the
// quotient correctly rounded by one FMA correction.
template <bool HAVE_L>
__device__ __forceinline__ float prob_f32(float x, float a, float l,
                                          float inv) {
  const float e = expf(__fsub_rn(x, a));
  if (!HAVE_L) return e;
  const float q = __fmul_rn(e, inv);
  return fmaf(fmaf(-q, l, e), inv, q);
}

#define BWD_F32_COMMON                                                    \
  const float *__restrict__ q, const float *__restrict__ k,               \
      const float *__restrict__ v, const float *__restrict__ g,           \
      const float *__restrict__ delta, const int *__restrict__ lengths,   \
      const float *__restrict__ slopes
#define DKV_F32_ARGS                                                      \
  BWD_F32_COMMON, const float *__restrict__ rowa,                         \
      const float *__restrict__ rowl, float *__restrict__ dk,             \
      float *__restrict__ dv, Seq sq, Seq sk, Seq sv, Seq sg, Seq sdk,    \
      Seq sdv, int tq, int tk, int nheads, int causal, float scale
#define DKV_PASS q, k, v, g, delta, lengths, slopes, rowa, rowl, dk, dv, sq, \
                 sk, sv, sg, sdk, sdv, tq, tk, nheads, causal, scale
#define DQ_F32_ARGS                                                       \
  BWD_F32_COMMON, float *__restrict__ rowa, float *__restrict__ rowl,     \
      float *__restrict__ dq, Seq sq, Seq sk, Seq sv, Seq sg, Seq sdq,    \
      int tq, int tk, int nheads, int causal, float scale
#define DQ_PASS q, k, v, g, delta, lengths, slopes, rowa, rowl, dq, sq, sk, \
                sv, sg, sdq, tq, tk, nheads, causal, scale

// dq of one (FQ-query tile, head, batch); with HAVE_L (K5b) pass 1
// writes each row's m to rowa and l to rowl, else rowa holds lse.
template <int D, bool HAVE_L>
__device__ __forceinline__ void dq_f32(DQ_F32_ARGS) {
  using G = F32<D>;
  constexpr int FQ = G::FQ, RI = G::RI, FP = G::FP;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [FQ][FP]
  float* Gs = Qs + FQ * FP;                      // [FQ][FP]
  float* Ps = Gs + FQ * FP;                      // [FQ][PP]: ds
  float* ring = Ps + FQ * PP;                    // [stage]: K, V [FK][FP]
  constexpr int STAGE = 2 * FK * FP;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int q0 = qt * FQ - ((int)gridDim.z * FQ - tq);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 4, cg = lane & 15;
  const int row = w * 2 * RI + rg;               // + 2 i
  const int len = lengths[b];
  const int use_alibi = slopes != nullptr;
  const float slope = use_alibi ? slopes[h] : 0.f;
  const float* kb = k + b * sk.bs + h * sk.hs;
  const float* vb = v + b * sv.bs + h * sv.hs;
  const long long bh = (long long)b * nheads + h;
  const int kt_end = key_tiles_f32<FQ>(q0, len, tk, causal);
  const int n1 = HAVE_L ? kt_end : 0;            // pass 1's items (K only)
  const int items = n1 + kt_end;

  auto issue = [&](int i) {   // item i into stage i & 1
    const int k0 = (i < n1 ? i : i - n1) * FK;
    float* st = ring + (i & 1) * STAGE;
    rows_async<D>(st, FP, kb, sk.rs, k0, FK, tk);
    if (i >= n1) rows_async<D>(st + FK * FP, FP, vb, sv.rs, k0, FK, tk);
    cp_commit();
  };
  rows_async<D>(Qs, FP, q + b * sq.bs + h * sq.hs, sq.rs, q0, FQ, tq);
  rows_async<D>(Gs, FP, g + b * sg.bs + h * sg.hs, sg.rs, q0, FQ, tq);
  issue(0);

  // the rows' statistics (lse, or m, l, 1/l) and delta; 0, 1, 1 and 0
  // outside [0, tq)
  float a_r[RI], l_r[RI], inv_r[RI], del_r[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + row + 2 * i;
    const bool in = r >= 0 && r < tq;
    a_r[i] = !HAVE_L && in ? rowa[bh * tq + r] : 0.f;
    l_r[i] = inv_r[i] = 1.f;
    del_r[i] = in ? delta[bh * tq + r] : 0.f;
  }
  // the warp's 2 RI rows see no key of tile kt (rows outside [0, tq), or
  // every key at or past the length or after the rows): its products
  // would add exact zeros, so it skips them
  const int r_lo = q0 + 2 * RI * w, r_hi = r_lo + 2 * RI - 1;
  auto warp_idle = [&](int kt) {
    const int k0 = kt * FK;
    return r_hi < 0 || r_lo >= tq ||
           (len >= 1 && (k0 >= len || (causal && k0 > r_hi)));
  };
  auto wait_item = [&](int i) {
    __syncthreads();                 // item i - 1's tiles are read
    if (i + 1 < items) {
      issue(i + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                 // item i is in shared memory
  };

  if (HAVE_L) {   // pass 1: m and l, online over the key tiles
    float m[RI], l[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) m[i] = -INFINITY, l[i] = 0.f;
    for (int kt = 0; kt < kt_end; ++kt) {
      wait_item(kt);
      if (warp_idle(kt)) continue;
      const int k0 = kt * FK;
      float s[RI][4];
      rows_by_rows<D>(s, Qs, ring + (kt & 1) * STAGE, row, cg);
      const float dist0 = (float)(k0 + cg - q0 - row);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = q0 + row + 2 * i;
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = k0 + cg + 16 * j;
          float x = logit_f32(s[i][j], fabsf(dist0 + (16 * j - 2 * i)),
                              slope, scale, use_alibi);
          const bool valid = c < len && (!causal || c <= r);
          x = c < tk ? (valid ? x : NEG_INF) : -INFINITY;
          s[i][j] = x;
          tmax = fmaxf(tmax, x);
        }
        const float m_new = fmaxf(m[i], row_max(tmax));
        float e = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) e += expf(__fsub_rn(s[i][j], m_new));
        l[i] = fmaf(l[i], expf(__fsub_rn(m[i], m_new)), e);
        m[i] = m_new;
      }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = q0 + row + 2 * i;
      a_r[i] = m[i];
      l_r[i] = row_sum(l[i]);
      inv_r[i] = 1.f / l_r[i];
      if (r >= 0 && r < tq && cg == 0) {
        rowa[bh * tq + r] = a_r[i];
        rowl[bh * tq + r] = l_r[i];
      }
    }
  }

  // pass 2: dQ += dS K
  float acc[RI][D / 16];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int i_ = n1 + kt, k0 = kt * FK;
    wait_item(i_);
    if (warp_idle(kt)) continue;
    const float* Kt = ring + (i_ & 1) * STAGE;
    const float* Vt = Kt + FK * FP;
    float p[RI][4], dp[RI][4];
    rows_by_rows<D>(p, Qs, Kt, row, cg);
    rows_by_rows<D>(dp, Gs, Vt, row, cg);
    const bool interior = q0 >= 0 && len >= 1 &&
                          k0 + FK <= min(len, tk) &&
                          (!causal || k0 + FK - 1 <= q0);
    const float dist0 = (float)(k0 + cg - q0 - row);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = q0 + row + 2 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + cg + 16 * j;
        const float x = logit_f32(p[i][j], fabsf(dist0 + (16 * j - 2 * i)),
                                  slope, scale, use_alibi);
        float pr = 0.f;
        if (interior) {
          pr = prob_f32<HAVE_L>(x, a_r[i], l_r[i], inv_r[i]);
        } else if (r >= 0 && r < tq && c < tk) {
          const bool valid = c < len && (!causal || c <= r);
          pr = prob_f32<HAVE_L>(valid ? x : NEG_INF, a_r[i], l_r[i],
                                inv_r[i]);
        }
        Ps[(row + 2 * i) * PP + cg + 16 * j] =
            __fmul_rn(pr, __fsub_rn(dp[i][j], del_r[i]));
      }
    }
    __syncwarp();                    // the warp's rows of dS are written
    rows_times_tile<D>(acc, Ps, Kt, row, cg);
  }
  cp_wait<0>();

  float* dqb = dq + b * sdq.bs + h * sdq.hs;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + row + 2 * i;
    if (r < 0) continue;
    store_row_f32<D, true>(dqb + r * sdq.rs, acc[i], cg, scale);
  }
}

// dk, dv of one (FQ-key tile, head, batch), walking the 64-query tiles
// that see it (HAVE_L as in dq_f32; rowa and rowl come from it).
template <int D, bool HAVE_L>
__device__ __forceinline__ void dkv_f32(DKV_F32_ARGS) {
  using G = F32<D>;
  constexpr int FQ = G::FQ, RI = G::RI, FP = G::FP;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [FQ][FP]
  float* Vs = Ks + FQ * FP;                      // [FQ][FP]
  float* Ps = Vs + FQ * FP;                      // [FQ][PP]: p^T, ds^T
  float* ring = Ps + FQ * PP;   // [stage]: Q, dO [FK][FP], rows [3][FK]
  constexpr int STAGE = 2 * FK * FP + 3 * FK;
  const int h = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int k0 = kt * FQ;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 4, cg = lane & 15;
  const int row = w * 2 * RI + rg;               // + 2 i
  const int len = lengths[b];
  const int use_alibi = slopes != nullptr;
  const float slope = use_alibi ? slopes[h] : 0.f;
  const float* qb = q + b * sq.bs + h * sq.hs;
  const float* gb = g + b * sg.bs + h * sg.hs;
  const long long bh = (long long)b * nheads + h;
  const float* ab = rowa + bh * tq;
  const float* lb = HAVE_L ? rowl + bh * tq : nullptr;
  const float* db = delta + bh * tq;
  const int nq = (tq + FK - 1) / FK;
  int qt_begin = 0;
  if (len >= 1) {
    if (k0 >= len) qt_begin = nq;          // every p of this tile is 0
    else if (causal) qt_begin = min(nq, k0 / FK);
  }
  const int walk = nq - qt_begin;

  auto issue = [&](int n) {   // query tile qt_begin + n into stage n & 1
    const int q0 = (qt_begin + n) * FK;
    float* st = ring + (n & 1) * STAGE;
    rows_async<D>(st, FP, qb, sq.rs, q0, FK, tq);
    rows_async<D>(st + FK * FP, FP, gb, sg.rs, q0, FK, tq);
    float* rs = st + 2 * FK * FP;
    for (int idx = threadIdx.x; idx < 3 * FK; idx += NT) {
      const int which = idx / FK, r = q0 + idx % FK;
      const float* src = which == 0 ? ab : which == 1 ? lb : db;
      const bool in = r < tq && src != nullptr;
      cp4(rs + idx, in ? src + r : ab, in);
    }
    cp_commit();
  };
  float acc_k[RI][D / 16], acc_v[RI][D / 16];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
  if (walk > 0) {
    rows_async<D>(Ks, FP, k + b * sk.bs + h * sk.hs, sk.rs, k0, FQ, tk);
    rows_async<D>(Vs, FP, v + b * sv.bs + h * sv.hs, sv.rs, k0, FQ, tk);
    issue(0);
  }
  for (int n = 0; n < walk; ++n) {
    const int q0 = (qt_begin + n) * FK;
    __syncthreads();                 // tile n - 1 is read
    if (n + 1 < walk) {
      issue(n + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                 // tile n is in shared memory
    // the warp's 2 RI keys are seen by no query of the tile (past tk, at
    // or past the length, or after every query): exact zeros, skipped
    const int c_lo = k0 + 2 * RI * w;
    if (c_lo >= tk || (len >= 1 && (c_lo >= len ||
                                    (causal && c_lo > min(q0 + FK, tq) - 1))))
      continue;
    const float* Qt = ring + (n & 1) * STAGE;
    const float* Gt = Qt + FK * FP;
    const float* Rt = Gt + FK * FP;  // a, l, delta of the tile's rows
    float a_c[4], l_c[4], inv_c[4], del_c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a_c[j] = Rt[cg + 16 * j];
      l_c[j] = HAVE_L ? Rt[FK + cg + 16 * j] : 1.f;
      inv_c[j] = HAVE_L ? 1.f / l_c[j] : 1.f;
      del_c[j] = Rt[2 * FK + cg + 16 * j];
    }
    const bool interior = len >= 1 && q0 + FK <= tq &&
                          k0 + FQ <= min(len, tk) &&
                          (!causal || k0 + FQ - 1 <= q0);
    const float dist0 = (float)(k0 + row - q0 - cg);
    float p[RI][4];
    rows_by_rows<D>(p, Ks, Qt, row, cg);    // S^T = K Q^T
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int c = k0 + row + 2 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = q0 + cg + 16 * j;
        const float x = logit_f32(p[i][j], fabsf(dist0 + (2 * i - 16 * j)),
                                  slope, scale, use_alibi);
        float pr = 0.f;
        if (interior) {
          pr = prob_f32<HAVE_L>(x, a_c[j], l_c[j], inv_c[j]);
        } else if (r < tq && c < tk) {
          const bool valid = c < len && (!causal || c <= r);
          pr = prob_f32<HAVE_L>(valid ? x : NEG_INF, a_c[j], l_c[j],
                                inv_c[j]);
        }
        p[i][j] = pr;
        Ps[(row + 2 * i) * PP + cg + 16 * j] = pr;
      }
    }
    __syncwarp();                    // the warp's rows of p^T are written
    rows_times_tile<D>(acc_v, Ps, Gt, row, cg);   // dV += P^T dO
    float dp[RI][4];
    rows_by_rows<D>(dp, Vs, Gt, row, cg);   // dP^T = V dO^T
    __syncwarp();                    // the warp's reads of p^T are done
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(row + 2 * i) * PP + cg + 16 * j] =
            __fmul_rn(p[i][j], __fsub_rn(dp[i][j], del_c[j]));
    __syncwarp();                    // ... and of ds^T written
    rows_times_tile<D>(acc_k, Ps, Qt, row, cg);   // dK += dS^T Q
  }

  float* dkb = dk + b * sdk.bs + h * sdk.hs;
  float* dvb = dv + b * sdv.bs + h * sdv.hs;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int c = k0 + row + 2 * i;
    if (c >= tk) continue;
    store_row_f32<D, true>(dkb + c * sdk.rs, acc_k[i], cg, scale);
    store_row_f32<D, false>(dvb + c * sdv.rs, acc_v[i], cg, 0.f);
  }
}

// One symbol per TPU kernel replaced (K3b packed, K4b full: from lse;
// K5b blockwise: its own m and l).
template <int D>
__global__ void __launch_bounds__(NT, 1) k3b_dq_kernel(DQ_F32_ARGS) {
  dq_f32<D, false>(DQ_PASS);
}
template <int D>
__global__ void __launch_bounds__(NT, 1) k4b_dq_kernel(DQ_F32_ARGS) {
  dq_f32<D, false>(DQ_PASS);
}
template <int D>
__global__ void __launch_bounds__(NT, 1) k5b_dq_kernel(DQ_F32_ARGS) {
  dq_f32<D, true>(DQ_PASS);
}
template <int D>
__global__ void __launch_bounds__(NT, 1) k3b_dkv_kernel(DKV_F32_ARGS) {
  dkv_f32<D, false>(DKV_PASS);
}
template <int D>
__global__ void __launch_bounds__(NT, 1) k4b_dkv_kernel(DKV_F32_ARGS) {
  dkv_f32<D, false>(DKV_PASS);
}
template <int D>
__global__ void __launch_bounds__(NT, 1) k5b_dkv_kernel(DKV_F32_ARGS) {
  dkv_f32<D, true>(DKV_PASS);
}

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// ------------------------------------------------------------------
// K3/K4 bfloat16 forward for Hopper: TMA into a resident K and a V ring,
// wgmma products (the design note at the top of the file).
// ------------------------------------------------------------------
constexpr int WG = 128;                 // the consumer warpgroup
constexpr int WG_NT = WG + 32;          // and one producer warp
constexpr int MAX_KEY_TILES = 16;       // Tk <= 1024
constexpr int SMEM_LIMIT = 232448;      // a block's most on an H100
constexpr float LOG2E = 1.4426950408889634f;

// One 64-row bf16 tile of head width D in shared memory, as TMA writes
// it and wgmma reads it.  A row is cut into column blocks of at most 64
// columns (128 bytes), each block 64 rows of ROW bytes swizzled at ROW
// bytes: the 128B swizzle at D = 64 (one block, one TMA box) and D = 128
// (two blocks, two boxes of 64 columns, 8 KB apart), the 64B swizzle at
// D = 32 (one block of 64-byte rows).  A product whose k runs along D
// (K-major: Q K^T, dO V^T) steps 32 bytes a k16 step inside a block's
// rows and moves to the next block every ROW / 32 steps; a product whose
// k runs along the tile's rows (MN-major: P V, dS K, P^T dO, dS^T Q)
// steps 16 rows, and its n = D spans the blocks BLOCK_BYTES apart.
template <int D>
struct Tile {
  static constexpr int ROW = D * 2 < 128 ? D * 2 : 128;
  static constexpr int COLS = ROW / 2;               // columns a block
  static constexpr int BLOCKS = D / COLS;
  static constexpr int BLOCK_BYTES = TILE * ROW;
  static constexpr int BYTES = TILE * D * 2;
  static constexpr uint64_t LAYOUT = ROW == 128 ? 1 : 2;   // 128B / 64B
  static constexpr int KSTEPS = D / 16;              // k16 steps along D
};

// The dynamic shared memory of a plan: alignment slack, Q, the resident
// key tiles and the V stages (1024-byte aligned for the swizzle), then
// the mbarriers (Q, one per key tile, full and empty per stage).
// ops/flash_attention.py's fwd_smem_plan computes the same.
template <int D>
constexpr int plan_bytes(int tiles, int stages) {
  return 1024 + (1 + tiles + stages) * Tile<D>::BYTES +
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

// One TMA box (columns [col, col + box), rows [row, row + 64) of head h,
// batch b) of a 4-D (D, T, H, B) tensor map into shared memory at dst.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int col, int row,
                                        int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(h), "r"(b)
      : "memory");
}
// One 64-row tile of head width D: a box per column block, all on `bar`
// (Tile<D>::BYTES in all).
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int h,
                                         int b) {
#pragma unroll
  for (int c = 0; c < Tile<D>::BLOCKS; ++c)
    tma_box(dst + c * Tile<D>::BLOCK_BYTES, map, bar, c * Tile<D>::COLS,
            row, h, b);
}

// A wgmma shared-memory descriptor of a swizzled operand of head width
// D: start address, leading and stride byte offsets (16-byte units),
// the layout type of Tile<D>'s swizzle.
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (Tile<D>::LAYOUT << 62);
}
// k16 step ks of a tile read K-major (k along D): 8-row groups 8 ROW
// apart (the stride byte offset; the leading one is not read).  The
// step's offset is added to the tile's descriptor in 16-byte units (the
// start address field), so one descriptor a tile serves every step.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int ks) {
  constexpr int R = Tile<D>::ROW;
  const int off = (ks * 32 / R) * Tile<D>::BLOCK_BYTES + ks * 32 % R;
  return smem_desc<D>(tile, 16, 8 * R) + (off >> 4);
}
// k16 step ks (rows [16 ks, 16 ks + 16)) of a tile read MN-major (the
// transpose bit; n along D): 8-row groups 8 ROW apart (the stride byte
// offset), column blocks BLOCK_BYTES apart (the leading byte offset).
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int ks) {
  constexpr int R = Tile<D>::ROW;
  return smem_desc<D>(tile + ks * 16 * R,
                      Tile<D>::BLOCKS > 1 ? Tile<D>::BLOCK_BYTES : 8 * R,
                      8 * R);
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
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The accumulator operands of an m64nNk16 product: N / 2 float32
// registers a thread (N = 32, 64 and 128).
#define WG_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_OUT16(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define WG_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define WG_OUT32(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
      "+f"(d[31])
#define WG_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"
#define WG_OUT64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 64, float32) (+)= A (64 x 16) . B (16 x 64), both K-major in
// shared memory; d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
// d += A (64 x 16, bf16 fragments in registers) . B (16 x N), B
// MN-major in shared memory (transpose bit set): N = 2 x the registers
// of d, the head width of the products whose n runs along D.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : WG_OUT16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Issues s = Q K^T of one key tile (D / 16 k16 steps along the rows of
// the two K-major tiles) as one wgmma group.
template <int D>
__device__ __forceinline__ void qk_issue(float (&s)[32], uint32_t q,
                                         uint32_t k) {
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < Tile<D>::KSTEPS; ++ks)
    wgmma_ss(s, kmajor_desc<D>(q, ks), kmajor_desc<D>(k, ks), ks);
  wg_commit();
}
// Issues d += P X over one 64-row tile X read MN-major (four k16 steps
// of its rows, P's A fragments four per step), not committed.
template <int D>
__device__ __forceinline__ void rs_tile(float (&d)[D / 2],
                                        const uint32_t (&a)[16],
                                        uint32_t x) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_rs(d, a + 4 * ks, mnmajor_desc<D>(x, ks));
}

// The logit of a product s, s * scale + bias, rounded as the plain
// version rounds it: the product, then the sum.  Where the scale
// 1/sqrt(D) is a power of two (D = 64, a power of 4) the product is
// exact and one fmaf gives the same bits.
template <int D>
__device__ __forceinline__ float logit(float s, float scale, float bias) {
  if constexpr ((D & (D - 1)) == 0 && (D & 0x55555555) != 0)
    return fmaf(s, scale, bias);
  else
    return __fadd_rn(__fmul_rn(s, scale), bias);
}

// x = the scaled, ALiBi-biased logits of the products s of one tile.
// Accumulator element i of the thread holds row rr + 8 ((i >> 1) & 1) and
// column cc + 8 (i >> 2) + (i & 1); |k - q| is |dt + const|, dt = rr -
// cc.  EDGE tiles also mask: -inf past tk (no probability), -1e30 at or
// past len or after the query (causal).
template <int D, bool EDGE>
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
    x[i] = logit<D>(s[i], scale, bias);
    if (EDGE) {
      const int r = rr + 8 * j, c = cc + 8 * nt + e;
      x[i] = c >= tk ? -INFINITY
                     : (c < len && (!causal || c <= r) ? x[i] : NEG_INF);
    }
  }
}

// The bfloat16 forward of one (64-query tile, head, batch) of K3/K4:
// Tq = Tk = t; lse (B, H, t) is written unless it is null.
template <int D>
__device__ __forceinline__ void fwd_wgmma(
    const CUtensorMap* mq, const CUtensorMap* mk, const CUtensorMap* mv,
    bf16* __restrict__ o, float* __restrict__ lse,
    const int* __restrict__ lengths, const float* __restrict__ slopes,
    Seq so, int t, int nheads, int causal, float scale, int tiles,
    int stages) {
  constexpr int TILE_BYTES = Tile<D>::BYTES;
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
      tma_tile<D>(sq, mq, bq, q0, h, b);
      for (int j = 0; j < kt_end; ++j) {
        mbar_expect(bk + 8 * j, TILE_BYTES);
        tma_tile<D>(sk + j * TILE_BYTES, mk, bk + 8 * j, j * TILE, h, b);
      }
      for (int j = 0; j < kt_end; ++j) {
        const int st = j % stages;
        if (j >= stages) mbar_wait(bempty + 8 * st, (j / stages - 1) & 1);
        mbar_expect(bfull + 8 * st, TILE_BYTES);
        tma_tile<D>(sv + st * TILE_BYTES, mv, bfull + 8 * st, j * TILE, h,
                    b);
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
  // The products overlap the softmax, with a pipeline ptxas keeps
  // asynchronous: s is written by wgmma alone and read only after the
  // group that wrote it has retired (the logits go to x), and every
  // iteration issues the next Q K^T unconditionally (the last tile's
  // again at the end, unread).
  float s[32], x[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  const int last = kt_end - 1;
  auto sk_ = [&](int kt) { return sk + kt * TILE_BYTES; };
  auto logits = [&](int kt) {   // x from s
    const int cc = kt * TILE + 2 * (lane & 3);
    if (kt < n_in)
      tile_logits<D, false>(x, s, rr, cc, t, len, causal, slope, scale);
    else
      tile_logits<D, true>(x, s, rr, cc, t, len, causal, slope, scale);
  };
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // pass 1: the row max and the (thread-partial) sum, online; tile kt's
  // softmax runs beside tile kt + 1's Q K^T
  mbar_wait(bq, 0);
  mbar_wait(bk, 0);
  __syncwarp();
  qk_issue<D>(s, sq, sk_(0));
  for (int kt = 0; kt < kt_end; ++kt) {
    const int nx = min(kt + 1, last);
    wg_wait<0>();
    reg_fence(s);
    logits(kt);
    mbar_wait(bk + 8 * nx, 0);
    __syncwarp();
    qk_issue<D>(s, sq, sk_(nx));
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
  float acc[D / 2];
  uint32_t pa[16];   // P's A fragments, four per k16 step of keys
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  qk_issue<D>(s, sq, sk_(0));
  wg_wait<0>();
  reg_fence(s);
  logits(0);
  probs();
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i] = pack(x[2 * i], x[2 * i + 1]);
  for (int kt = 0; kt < kt_end; ++kt) {
    qk_issue<D>(s, sq, sk_(min(kt + 1, last)));
    const int st = kt % stages;
    const uint32_t vt = sv + st * TILE_BYTES;
    mbar_wait(bfull + 8 * st, (kt / stages) & 1);
    __syncwarp();
    wg_fence();
    rs_tile<D>(acc, pa, vt);   // O += P V, 16 keys a step
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
    for (int nt = 0; nt < D / 8; ++nt)
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

template <int D>
__global__ void __launch_bounds__(WG_NT) k3_fwd_wgmma_kernel(FWD_WGMMA_ARGS) {
  fwd_wgmma<D>(FWD_WGMMA_PASS);
}
template <int D>
__global__ void __launch_bounds__(WG_NT) k4_fwd_wgmma_kernel(FWD_WGMMA_ARGS) {
  fwd_wgmma<D>(FWD_WGMMA_PASS);
}

// ------------------------------------------------------------------
// K5's bfloat16 forward for Hopper (fwd_stream_wgmma): TMA rings, two
// consumer warpgroups, wgmma products (the design note at the top of
// the file).
// ------------------------------------------------------------------
constexpr int K5_WGS = 2;                    // consumer warpgroups
constexpr int K5_Q = K5_WGS * TILE;          // query rows per block
constexpr int K5_NT = K5_WGS * WG + 32;      // and one producer warp

// The dynamic shared memory of K5's plan with `stages` ring stages:
// alignment slack, Q (one 64-row tile per warpgroup), a K and a V tile
// per stage (1024-byte aligned for the swizzle), then the mbarriers (Q,
// full and empty per stage).  ops/flash_attention.py's k5_fwd_plan
// computes the same.
template <int D>
constexpr int k5_plan_bytes(int stages) {
  return 1024 + (K5_WGS + 2 * stages) * Tile<D>::BYTES +
         8 * (1 + 2 * stages);
}

// The bfloat16 forward of one (128-query tile, head, batch) of K5: Tq
// queries against Tk keys (any number), both positions from 0, no lse.
// Warpgroup wg owns the 64-row query tile 2 qb + wg and walks its own
// key tiles (key_tiles; none for rows wholly past tq); the producer
// streams the longer walk twice through one ring, K alone in pass 1 and
// K with V in pass 2, and a warpgroup past its own walk only waits for
// and frees the stages it does not read.  lse (B, H, Tq), where it is
// not null, takes m + log l of each row: K3/K4 at a head width whose
// resident key tiles do not fit (D = 128 past 704 keys) take this body
// with it.
template <int D>
__device__ __forceinline__ void fwd_stream_wgmma(
    const CUtensorMap* mq, const CUtensorMap* mk, const CUtensorMap* mv,
    bf16* __restrict__ o, float* __restrict__ lse,
    const int* __restrict__ lengths, const float* __restrict__ slopes,
    Seq so, int tq, int tk, int causal, float scale, int stages) {
  constexpr int TILE_BYTES = Tile<D>::BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = sq + K5_WGS * TILE_BYTES;   // stage st: K, then V
  const uint32_t bq = ring + 2 * stages * TILE_BYTES;   // mbarriers
  const uint32_t bfull = bq + 8, bempty = bfull + 8 * stages;
  const int n_qb = (tq + K5_Q - 1) / K5_Q;
  const int h = blockIdx.x, b = blockIdx.y, qb = n_qb - 1 - blockIdx.z;
  const int q0 = qb * K5_Q, len = lengths[b], tid = threadIdx.x;
  auto walk_of = [&](int wg) {   // key tiles of warpgroup wg's rows
    const int t64 = 2 * qb + wg;
    return t64 * TILE < tq ? key_tiles(t64, len, tk, causal) : 0;
  };
  const int n = max(walk_of(0), walk_of(1));   // the ring's walk

  if (tid == 0) {
    mbar_init(bq, 1);
    for (int st = 0; st < stages; ++st) {
      mbar_init(bfull + 8 * st, 1);
      mbar_init(bempty + 8 * st, 4 * K5_WGS);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= K5_WGS * WG) {   // the producer warp: one thread issues
    if (tid == K5_WGS * WG) {
      const int nq = q0 + TILE < tq ? 2 : 1;   // Q tiles holding rows
      mbar_expect(bq, nq * TILE_BYTES);
      for (int j = 0; j < nq; ++j)
        tma_tile<D>(sq + j * TILE_BYTES, mq, bq, q0 + j * TILE, h, b);
      for (int i = 0; i < 2 * n; ++i) {
        const int st = i % stages, kt = i < n ? i : i - n;
        const uint32_t dst = ring + st * 2 * TILE_BYTES;
        const uint32_t full = bfull + 8 * st;
        if (i >= stages) mbar_wait(bempty + 8 * st, (i / stages - 1) & 1);
        mbar_expect(full, (i < n ? 1 : 2) * TILE_BYTES);
        tma_tile<D>(dst, mk, full, kt * TILE, h, b);
        if (i >= n)
          tma_tile<D>(dst + TILE_BYTES, mv, full, kt * TILE, h, b);
      }
    }
    return;
  }

  const int wg = tid / WG, w = (tid % WG) >> 5, lane = tid & 31;
  const int t64 = 2 * qb + wg, walk = walk_of(wg), last = walk - 1;
  const int rr = t64 * TILE + 16 * w + (lane >> 2);   // rows rr, rr + 8
  const float slope = slopes != nullptr ? slopes[h] : 0.f;
  // key tiles [0, n_in) lie wholly inside the length and causal edges
  int n_in = 0;
  if (len >= 1) {
    n_in = min(len, tk) / TILE;
    if (causal) n_in = min(n_in, t64);
  }
  const uint32_t sq_wg = sq + wg * TILE_BYTES;
  auto stage = [&](int i) { return ring + (i % stages) * 2 * TILE_BYTES; };
  auto full_wait = [&](int i) {
    mbar_wait(bfull + 8 * (i % stages), (i / stages) & 1);
    __syncwarp();
  };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bempty + 8 * (i % stages));
  };
  // The products overlap the softmax as in fwd_wgmma: s is written by
  // wgmma alone and read only after its group has retired, and every
  // iteration issues the next Q K^T unconditionally (the last tile's
  // again at the end, unread, before its stage is freed).
  float s[32], x[32], acc[D / 2];
  uint32_t pa[16];   // P's A fragments, four per k16 step of keys
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  auto logits = [&](int kt) {   // x from s
    const int cc = kt * TILE + 2 * (lane & 3);
    if (kt < n_in)
      tile_logits<D, false>(x, s, rr, cc, tk, len, causal, slope, scale);
    else
      tile_logits<D, true>(x, s, rr, cc, tk, len, causal, slope, scale);
  };
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv[2];
  mbar_wait(bq, 0);

  // pass 1 (items 0 .. n - 1): the row max and the (thread-partial)
  // sum, online; tile kt's softmax runs beside tile kt + 1's Q K^T
  if (walk > 0) {
    full_wait(0);
    qk_issue<D>(s, sq_wg, stage(0));
    for (int kt = 0; kt < walk; ++kt) {
      const int nx = min(kt + 1, last);
      wg_wait<0>();
      reg_fence(s);
      if (kt < last) release(kt);
      logits(kt);
      full_wait(nx);
      qk_issue<D>(s, sq_wg, stage(nx));
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
    wg_wait<0>();   // the unread last product
    reg_fence(s);
    release(last);
  }
  for (int kt = max(walk, 0); kt < n; ++kt) {   // stages this group skips
    full_wait(kt);
    release(kt);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] = quad_sum(l[j]);
    inv[j] = 1.f / l[j];
  }

  // pass 2 (items n .. 2 n - 1): p = exp(s - m) / l rounded to bf16, O
  // += P V; tile kt + 1's softmax runs beside tile kt's P V
  auto probs = [&]() {   // x = p from the logits in x
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = (i >> 1) & 1;
      x[i] = __fmul_rn(ex2(__fmul_rn(__fsub_rn(x[i], m[j]), LOG2E)),
                       inv[j]);
    }
  };
  if (walk > 0) {
    full_wait(n);
    qk_issue<D>(s, sq_wg, stage(n));
    wg_wait<0>();
    reg_fence(s);
    logits(0);
    probs();
#pragma unroll
    for (int i = 0; i < 16; ++i) pa[i] = pack(x[2 * i], x[2 * i + 1]);
    for (int kt = 0; kt < walk; ++kt) {
      const int it = n + kt, nx = n + min(kt + 1, last);
      full_wait(nx);
      qk_issue<D>(s, sq_wg, stage(nx));
      const uint32_t vt = stage(it) + TILE_BYTES;
      wg_fence();
      rs_tile<D>(acc, pa, vt);   // O += P V, 16 keys a step
      wg_commit();
      wg_wait<1>();   // the next tile's Q K^T; P V still runs
      reg_fence(s);
      if (kt < last) {
        logits(kt + 1);
        probs();
      }
      wg_wait<0>();
      reg_fence(acc);
      release(it);
#pragma unroll
      for (int i = 0; i < 16; ++i) pa[i] = pack(x[2 * i], x[2 * i + 1]);
    }
  }
  for (int kt = max(walk, 0); kt < n; ++kt) {
    full_wait(n + kt);
    release(n + kt);
  }

  bf16* ob = o + b * so.bs + h * so.hs;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = rr + 8 * j;
    if (r >= tq) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(ob + r * so.rs + 8 * nt +
                                   2 * (lane & 3)) =
          pack(acc[4 * nt + 2 * j], acc[4 * nt + 2 * j + 1]);
    if (lse && (lane & 3) == 0)
      lse[((long long)b * gridDim.x + h) * tq + r] = m[j] + logf(l[j]);
  }
}

#define FWD_STREAM_ARGS                                                   \
  const __grid_constant__ CUtensorMap mq,                                 \
      const __grid_constant__ CUtensorMap mk,                             \
      const __grid_constant__ CUtensorMap mv, bf16 *__restrict__ o,       \
      float *__restrict__ lse, const int *__restrict__ lengths,           \
      const float *__restrict__ slopes, Seq so, int tq, int tk,           \
      int causal, float scale, int stages
#define FWD_STREAM_PASS &mq, &mk, &mv, o, lse, lengths, slopes, so, tq, tk, \
                        causal, scale, stages

template <int D>
__global__ void __launch_bounds__(K5_NT, 1)
    k5_fwd_wgmma_kernel(FWD_STREAM_ARGS) {
  fwd_stream_wgmma<D>(FWD_STREAM_PASS);
}
// K3 and K4 past the resident plan (lse written), under names of their
// own so that a profile tells them apart.
template <int D>
__global__ void __launch_bounds__(K5_NT, 1)
    k3_fwd_stream_kernel(FWD_STREAM_ARGS) {
  fwd_stream_wgmma<D>(FWD_STREAM_PASS);
}
template <int D>
__global__ void __launch_bounds__(K5_NT, 1)
    k4_fwd_stream_kernel(FWD_STREAM_ARGS) {
  fwd_stream_wgmma<D>(FWD_STREAM_PASS);
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
template <int D>
constexpr int bwd_plan_bytes(int stages) {
  return 1024 + (2 + 2 * stages) * Tile<D>::BYTES +
         stages * ROW_FLOATS * 4 + 8 * (1 + 2 * stages);
}

// The logit of accumulator element i of a backward tile: rows from rr,
// columns from cc (element i at row rr + 8 ((i >> 1) & 1), column cc +
// 8 (i >> 2) + (i & 1)), keys along the rows (KEY_ROWS: the dk/dv
// kernel's S^T) or along the columns; dt = rr - cc.  EDGE tiles also
// mask: -inf for keys at or past tk or queries at or past tq (p = 0, as
// the mma kernels' r < tq && c < tk test), -1e30 at or past len or
// after the query (causal).
template <int D, bool EDGE, bool KEY_ROWS>
__device__ __forceinline__ float bwd_logit(float s, int i, float dt, int rr,
                                           int cc, int tq, int tk, int len,
                                           int causal, float slope,
                                           float scale) {
  const int j = (i >> 1) & 1, nt = i >> 2, e = i & 1;
  const float x = logit<D>(
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

// d = A B^T over the D features, A and B 64-row K-major tiles in
// shared memory (D / 16 k16 steps); issued, not committed.
template <int D>
__device__ __forceinline__ void ss_tile(float (&d)[32], uint32_t a,
                                        uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < Tile<D>::KSTEPS; ++ks)
    wgmma_ss(d, kmajor_desc<D>(a, ks), kmajor_desc<D>(b, ks), ks);
}

// The dk/dv kernel's p^T and ds^T fragments of one (key tile, query
// tile) pair from S^T and dP^T: keys along the rows from cr, queries
// along the columns from qc, each query's a, l, 1/l and delta from the
// stage's rows r_s (index in the tile).
template <int D, bool EDGE, bool HAVE_L>
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
      const float x = bwd_logit<D, EDGE, true>(s[i], i, dt, cr, q0 + qc, tq,
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
template <int D, bool HAVE_L>
__device__ __forceinline__ void dkv_wgmma(
    const CUtensorMap* mq, const CUtensorMap* mk, const CUtensorMap* mv,
    const CUtensorMap* mg, const float* __restrict__ rowa,
    const float* __restrict__ rowl, const float* __restrict__ delta,
    const int* __restrict__ lengths, const float* __restrict__ slopes,
    bf16* __restrict__ dk, bf16* __restrict__ dv, Seq sdk, Seq sdv, int tq,
    int tk, int nheads, int causal, float scale, int stages) {
  constexpr int TILE_BYTES = Tile<D>::BYTES;
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
      tma_tile<D>(s_k, mk, b_kv, k0, h, b);
      tma_tile<D>(s_v, mv, b_kv, k0, h, b);
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
        tma_tile<D>(dst, mq, full, q0, h, b);
        tma_tile<D>(dst + TILE_BYTES, mg, full, q0, h, b);
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
  float acc_k[D / 2], acc_v[D / 2], s[32], dp[32];
  uint32_t pa[16], sa[16];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  if (walk > 0) mbar_wait(b_kv, 0);
  for (int n = 0; n < walk; ++n) {
    const int st = n % stages, qt = qt_begin + n, q0 = qt * TILE;
    const uint32_t sq = ring + st * 2 * TILE_BYTES, sg = sq + TILE_BYTES;
    mbar_wait(b_full + 8 * st, (n / stages) & 1);
    __syncwarp();
    wg_fence();
    ss_tile<D>(s, s_k, sq);    // S^T = K Q^T
    ss_tile<D>(dp, s_v, sg);   // dP^T = V dO^T
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    const float* r_s = rows + st * ROW_FLOATS;
    if (keys_in && q0 + TILE <= tq && (!causal || kt < qt))
      dkv_frags<D, false, HAVE_L>(pa, sa, s, dp, r_s, cr, qc, q0, tq, tk, len,
                               causal, slope, scale);
    else
      dkv_frags<D, true, HAVE_L>(pa, sa, s, dp, r_s, cr, qc, q0, tq, tk, len,
                              causal, slope, scale);
    wg_fence();
    rs_tile<D>(acc_v, pa, sg);   // dV += P^T dO
    rs_tile<D>(acc_k, sa, sq);   // dK += dS^T Q
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
    for (int nt = 0; nt < D / 8; ++nt) {
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
template <int D, bool EDGE, bool HAVE_L>
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
      const float x = bwd_logit<D, EDGE, false>(s[i], i, dt, rr, cc, tq, tk,
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
template <int D, bool HAVE_L>
__device__ __forceinline__ void dq_wgmma(
    const CUtensorMap* mq, const CUtensorMap* mk, const CUtensorMap* mv,
    const CUtensorMap* mg, float* __restrict__ rowa,
    float* __restrict__ rowl, const float* __restrict__ delta,
    const int* __restrict__ lengths, const float* __restrict__ slopes,
    bf16* __restrict__ dq, Seq sdq, int tq, int tk, int nheads, int causal,
    float scale, int stages) {
  constexpr int TILE_BYTES = Tile<D>::BYTES;
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
      tma_tile<D>(s_q, mq, b_qg, q0, h, b);
      tma_tile<D>(s_g, mg, b_qg, q0, h, b);
      for (int n = 0; n < n1 + kt_end; ++n) {
        const int st = n % stages, k0 = (n < n1 ? n : n - n1) * TILE;
        const uint32_t dst = ring + st * 2 * TILE_BYTES;
        const uint32_t full = b_full + 8 * st;
        if (n >= stages) mbar_wait(b_empty + 8 * st, (n / stages - 1) & 1);
        mbar_expect(full, (n < n1 ? 1 : 2) * TILE_BYTES);
        tma_tile<D>(dst, mk, full, k0, h, b);
        if (n >= n1) tma_tile<D>(dst + TILE_BYTES, mv, full, k0, h, b);
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
  float s[32], dp[32], acc[D / 2];
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
      ss_tile<D>(s, s_q, ring + st * 2 * TILE_BYTES);
      wg_commit();
      wg_wait<0>();
      reg_fence(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(b_empty + 8 * st);
      float x[32];   // the logits
      if (kt < n_in)
        tile_logits<D, false>(x, s, rr, kt * TILE + cc, tk, len, causal, slope,
                           scale);
      else
        tile_logits<D, true>(x, s, rr, kt * TILE + cc, tk, len, causal, slope,
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
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const bool rows_in = q0 + TILE <= tq;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int n = n1 + kt, st = n % stages, k0 = kt * TILE;
    const uint32_t sk = ring + st * 2 * TILE_BYTES, sv = sk + TILE_BYTES;
    mbar_wait(b_full + 8 * st, (n / stages) & 1);
    __syncwarp();
    wg_fence();
    ss_tile<D>(s, s_q, sk);    // S = Q K^T
    ss_tile<D>(dp, s_g, sv);   // dP = dO V^T
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    if (rows_in && k0 + TILE <= min(len, tk) && (!causal || kt < qt))
      dq_frags<D, false, HAVE_L>(sa, s, dp, a_r, l_r, inv_r, del_r, rr,
                              k0 + cc, tq, tk, len, causal, slope, scale);
    else
      dq_frags<D, true, HAVE_L>(sa, s, dp, a_r, l_r, inv_r, del_r, rr, k0 + cc,
                             tq, tk, len, causal, slope, scale);
    wg_fence();
    rs_tile<D>(acc, sa, sk);   // dQ += dS K
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
    for (int nt = 0; nt < D / 8; ++nt) {
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

template <int D>
__global__ void __launch_bounds__(WG_NT) k3b_dkv_wgmma_kernel(DKV_WGMMA_ARGS) {
  dkv_wgmma<D, false>(DKV_WGMMA_PASS);
}
template <int D>
__global__ void __launch_bounds__(WG_NT) k4b_dkv_wgmma_kernel(DKV_WGMMA_ARGS) {
  dkv_wgmma<D, false>(DKV_WGMMA_PASS);
}
template <int D>
__global__ void __launch_bounds__(WG_NT) k5b_dkv_wgmma_kernel(DKV_WGMMA_ARGS) {
  dkv_wgmma<D, true>(DKV_WGMMA_PASS);
}
template <int D>
__global__ void __launch_bounds__(WG_NT) k3b_dq_wgmma_kernel(DQ_WGMMA_ARGS) {
  dq_wgmma<D, false>(DQ_WGMMA_PASS);
}
template <int D>
__global__ void __launch_bounds__(WG_NT) k4b_dq_wgmma_kernel(DQ_WGMMA_ARGS) {
  dq_wgmma<D, false>(DQ_WGMMA_PASS);
}
template <int D>
__global__ void __launch_bounds__(WG_NT) k5b_dq_wgmma_kernel(DQ_WGMMA_ARGS) {
  dq_wgmma<D, true>(DQ_WGMMA_PASS);
}

typedef void (*FwdF32)(FWD_F32_ARGS);
typedef void (*DkvF32)(DKV_F32_ARGS);
typedef void (*DqF32)(DQ_F32_ARGS);
typedef void (*FwdStream)(FWD_STREAM_ARGS);
typedef void (*DkvWgmma)(DKV_WGMMA_ARGS);
typedef void (*DqWgmma)(DQ_WGMMA_ARGS);

// The kernels of one head width by entry point (0: K3, 1: K4, 2: K5, or
// their backwards).
template <int D>
FwdF32 fwd_f32_kernel(int kid) {
  return kid == 0 ? k3_fwd_kernel<D> : kid == 1 ? k4_fwd_kernel<D>
                                                : k5_fwd_kernel<D>;
}
template <int D>
DqF32 dq_f32_kernel(int kid) {
  return kid == 0 ? k3b_dq_kernel<D> : kid == 1 ? k4b_dq_kernel<D>
                                                : k5b_dq_kernel<D>;
}
template <int D>
DkvF32 dkv_f32_kernel(int kid) {
  return kid == 0 ? k3b_dkv_kernel<D> : kid == 1 ? k4b_dkv_kernel<D>
                                                 : k5b_dkv_kernel<D>;
}
template <int D>
DqWgmma dq_wgmma_kernel(int kid) {
  return kid == 0 ? k3b_dq_wgmma_kernel<D>
                  : kid == 1 ? k4b_dq_wgmma_kernel<D>
                             : k5b_dq_wgmma_kernel<D>;
}
template <int D>
DkvWgmma dkv_wgmma_kernel(int kid) {
  return kid == 0 ? k3b_dkv_wgmma_kernel<D>
                  : kid == 1 ? k4b_dkv_wgmma_kernel<D>
                             : k5b_dkv_wgmma_kernel<D>;
}

// The most key tiles a K3/K4 bf16 forward keeps resident at head width D
// (two V stages): 16 (T <= 1024) at D = 32 and 64, 11 (T <= 704) at
// D = 128, past which K3/K4 stream K through fwd_stream_wgmma.
template <int D>
constexpr int resident_tiles() {
  int n = MAX_KEY_TILES;
  while (n > 0 && plan_bytes<D>(n, 2) > SMEM_LIMIT) --n;
  return n;
}

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

// The (D, T, H, B) tensor map of one bf16 operand of head width D:
// boxes of Tile<D>::COLS columns x 64 rows with Tile<D>'s swizzle (128B,
// or 64B at D = 32), zero fill past T.  A size-1 axis's stride is never
// read; the row's bytes stand in for it.
template <int D>
int tile_map(CUtensorMap* map, const void* ptr, Seq s, int t, int h, int b) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return TMA_NO_ENCODER;
  const cuuint64_t row = D * 2;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)t, (cuuint64_t)h,
                        (cuuint64_t)b};
  cuuint64_t strides[3] = {t > 1 ? (cuuint64_t)s.rs * 2 : row,
                           h > 1 ? (cuuint64_t)s.hs * 2 : row,
                           b > 1 ? (cuuint64_t)s.bs * 2 : row};
  cuuint32_t box[4] = {(cuuint32_t)Tile<D>::COLS, (cuuint32_t)TILE, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE,
                   Tile<D>::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : CU_TENSOR_MAP_SWIZZLE_64B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMA_ENCODE + (int)r;
}

// The streaming bf16 forward: K5 (`kid` 2, no lse) or K3/K4 past their
// resident plan (`kid` 0 or 1, lse written; only where resident_tiles
// is below 16), one block per (128-query tile, head, batch), query tiles
// in the grid's slowest axis, the longest walks first.  `smem` and
// `stages` are the wrapper's plan (k5_fwd_plan); a plan that cannot hold
// this launch is refused.
template <int D>
int launch_fwd_stream(int kid, const void* q, const void* k, const void* v,
                      void* o, float* lse, const int* lengths,
                      const float* slopes, Seq sq, Seq sk, Seq sv, Seq so,
                      int B, int tq, int tk, int H, int causal, float scale,
                      int smem, int stages, cudaStream_t stream) {
  if (stages < 2 || smem < k5_plan_bytes<D>(stages) || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  FwdStream fn = nullptr;
  if (kid == 2) {
    fn = k5_fwd_wgmma_kernel<D>;
  } else if constexpr (resident_tiles<D>() < MAX_KEY_TILES) {
    fn = kid == 0 ? k3_fwd_stream_kernel<D> : k4_fwd_stream_kernel<D>;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap mq, mk, mv;
  int err = tile_map<D>(&mq, q, sq, tq, H, B);
  if (!err) err = tile_map<D>(&mk, k, sk, tk, H, B);
  if (!err) err = tile_map<D>(&mv, v, sv, tk, H, B);
  if (err) return err;
  static int attr[3] = {0, 0, 0};   // the largest size set per kernel
  if (smem > attr[kid]) {
    err = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    attr[kid] = smem;
  }
  dim3 grid(H, B, (tq + K5_Q - 1) / K5_Q);
  fn<<<grid, K5_NT, smem, stream>>>(mq, mk, mv, (bf16*)o, lse, lengths,
                                    slopes, so, tq, tk, causal, scale,
                                    stages);
  return (int)cudaGetLastError();
}

// K3 (`kid` 0) or K4 (1) bfloat16 forward, Tq = Tk = t: one block per
// (64-query tile, head, batch), query tiles in the grid's slowest axis,
// the longest first.  `smem`, `tiles` and `stages` are the wrapper's
// shared-memory plan; a plan that cannot hold this launch is refused.
// A plan of 0 tiles (K not resident: fwd_smem_plan past resident_tiles)
// takes the streaming body with its plan (smem, stages).
template <int D>
int launch_fwd_wgmma(int kid, const void* q, const void* k, const void* v,
                     void* o, float* lse, const int* lengths,
                     const float* slopes, Seq sq, Seq sk, Seq sv, Seq so,
                     int B, int t, int H, int causal, float scale, int smem,
                     int tiles, int stages, cudaStream_t stream) {
  if (tiles == 0)
    return launch_fwd_stream<D>(kid, q, k, v, o, lse, lengths, slopes, sq,
                                sk, sv, so, B, t, t, H, causal, scale, smem,
                                stages, stream);
  if (tiles < (t + TILE - 1) / TILE || tiles > MAX_KEY_TILES ||
      stages < 1 || smem < plan_bytes<D>(tiles, stages) || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int err = tile_map<D>(&mq, q, sq, t, H, B);
  if (!err) err = tile_map<D>(&mk, k, sk, t, H, B);
  if (!err) err = tile_map<D>(&mv, v, sv, t, H, B);
  if (err) return err;
  const void* fn = kid == 0 ? (const void*)k3_fwd_wgmma_kernel<D>
                            : (const void*)k4_fwd_wgmma_kernel<D>;
  static int attr[2] = {0, 0};   // the largest size set per kernel
  if (smem > attr[kid]) {
    err = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    attr[kid] = smem;
  }
  dim3 grid(H, B, (t + TILE - 1) / TILE);
  if (kid == 0)
    k3_fwd_wgmma_kernel<D><<<grid, WG_NT, smem, stream>>>(
        mq, mk, mv, (bf16*)o, lse, lengths, slopes, so, t, H, causal, scale,
        tiles, stages);
  else
    k4_fwd_wgmma_kernel<D><<<grid, WG_NT, smem, stream>>>(
        mq, mk, mv, (bf16*)o, lse, lengths, slopes, so, t, H, causal, scale,
        tiles, stages);
  return (int)cudaGetLastError();
}

// One forward launch of entry point `kid` (0: K3, 1: K4, 2: K5) at head
// width D; lse may be null.  K3/K4 in bfloat16 take the wgmma kernels
// with the plan (smem, tiles, stages); K5 in bfloat16 the streaming
// kernel with its plan (smem, query rows per block, stages); float32 the
// one-pass body, one block per (FQ-query tile, head, batch), the last
// query tiles first, whose plan (smem bytes, query rows per tile,
// stages: f32_fwd_plan) must be this body's.
template <int D>
int launch_fwd_d(int kid, int use_mma, const void* q, const void* k,
                 const void* v, void* o, float* lse, const int* lengths,
                 const float* slopes, Seq sq, Seq sk, Seq sv, Seq so, int B,
                 int tq, int tk, int H, int causal, float scale, int smem,
                 int tiles, int stages, cudaStream_t stream) {
  if (use_mma && kid < 2) {
    if (tq != tk) return (int)cudaErrorInvalidValue;
    return launch_fwd_wgmma<D>(kid, q, k, v, o, lse, lengths, slopes, sq, sk,
                               sv, so, B, tq, H, causal, scale, smem, tiles,
                               stages, stream);
  }
  if (use_mma) {
    if (tiles != K5_Q) return (int)cudaErrorInvalidValue;
    return launch_fwd_stream<D>(2, q, k, v, o, nullptr, lengths, slopes, sq,
                                sk, sv, so, B, tq, tk, H, causal, scale,
                                smem, stages, stream);
  }
  using G = F32<D>;
  if (smem != G::FWD_SMEM || tiles != G::FQ || stages != F_STAGES)
    return (int)cudaErrorInvalidValue;
  const FwdF32 fn = fwd_f32_kernel<D>(kid);
  static bool attr[3] = {false, false, false};
  if (!attr[kid]) {
    const int err = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, G::FWD_SMEM);
    if (err) return err;
    attr[kid] = true;
  }
  dim3 grid(H, B, (tq + G::FQ - 1) / G::FQ);
  fn<<<grid, NT, G::FWD_SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse,
      lengths, slopes, sq, sk, sv, so, tq, tk, H, causal, scale);
  return (int)cudaGetLastError();
}

int launch_fwd(int kid, int use_mma, int d, const void* q, const void* k,
               const void* v, void* o, float* lse, const int* lengths,
               const float* slopes, Seq sq, Seq sk, Seq sv, Seq so, int B,
               int tq, int tk, int H, int causal, float scale, int smem,
               int tiles, int stages, cudaStream_t stream) {
  switch (d) {
#define FWD_D(W)                                                          \
  case W:                                                                 \
    return launch_fwd_d<W>(kid, use_mma, q, k, v, o, lse, lengths, slopes, \
                           sq, sk, sv, so, B, tq, tk, H, causal, scale,   \
                           smem, tiles, stages, stream);
    FWD_D(32)
    FWD_D(64)
    FWD_D(128)
#undef FWD_D
  }
  return (int)cudaErrorInvalidValue;
}

// K3b (`kid` 0, packed operands: head stride = head_dim) or K4b (1),
// each with rowa = its forward's lse and rowl null, or K5b (2: rowa and
// rowl receive each query row's m and l) bfloat16 backward at head width
// D: the dq kernel (K5b's row statistics folded into its pass 1), then
// the dk/dv kernel.  `smem` and `stages` are the wrapper's shared-memory
// plan; a plan that cannot hold these launches is refused.
template <int D>
int launch_bwd_wgmma(int kid, const void* q, const void* k, const void* v,
                     const void* g, float* rowa, float* rowl,
                     const float* delta, const int* lengths,
                     const float* slopes, void* dq, void* dk, void* dv,
                     Seq sq, Seq sk, Seq sv, Seq sg, Seq sdq, Seq sdk,
                     Seq sdv, int B, int tq, int tk, int H, int causal,
                     float scale, int smem, int stages,
                     cudaStream_t stream) {
  if (stages < 1 || smem < bwd_plan_bytes<D>(stages) || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mg;
  int err = tile_map<D>(&mq, q, sq, tq, H, B);
  if (!err) err = tile_map<D>(&mg, g, sg, tq, H, B);
  if (!err) err = tile_map<D>(&mk, k, sk, tk, H, B);
  if (!err) err = tile_map<D>(&mv, v, sv, tk, H, B);
  if (err) return err;
  const DqWgmma fq = dq_wgmma_kernel<D>(kid);
  const DkvWgmma fkv = dkv_wgmma_kernel<D>(kid);
  static int attr[3] = {0, 0, 0};   // the largest size set per entry point
  if (smem > attr[kid]) {
    err = (int)cudaFuncSetAttribute(
        fq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (!err)
      err = (int)cudaFuncSetAttribute(
          fkv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    attr[kid] = smem;
  }
  dim3 gq(H, B, (tq + TILE - 1) / TILE), gk(H, B, (tk + TILE - 1) / TILE);
  fq<<<gq, WG_NT, smem, stream>>>(mq, mk, mv, mg, rowa, rowl, delta, lengths,
                                  slopes, (bf16*)dq, sdq, tq, tk, H, causal,
                                  scale, stages);
  err = (int)cudaGetLastError();
  if (err) return err;
  fkv<<<gk, WG_NT, smem, stream>>>(mq, mk, mv, mg, rowa, rowl, delta,
                                   lengths, slopes, (bf16*)dk, (bf16*)dv,
                                   sdk, sdv, tq, tk, H, causal, scale,
                                   stages);
  return (int)cudaGetLastError();
}

// The backward's two launches of entry point `kid` (0: K3b, 1: K4b,
// 2: K5b) at head width D, the dq kernel then the dk/dv kernel: bfloat16
// takes launch_bwd_wgmma with its plan (smem, stages); float32 one block
// per (FQ-query tile, head, batch) for dq, then one per (FQ-key tile,
// head, batch) for dk and dv, whose plan (smem bytes, stages:
// f32_bwd_plan) must be this body's.  K3b and K4b read lse from rowa;
// K5b's dq kernel writes m to rowa and l to rowl for the dk/dv kernel.
template <int D>
int launch_bwd_d(int kid, int use_mma, const void* q, const void* k,
                 const void* v, const void* g, float* rowa, float* rowl,
                 const float* delta, const int* lengths, const float* slopes,
                 void* dq, void* dk, void* dv, Seq sq, Seq sk, Seq sv, Seq sg,
                 Seq sdq, Seq sdk, Seq sdv, int B, int tq, int tk, int H,
                 int causal, float scale, int smem, int stages,
                 cudaStream_t stream) {
  if (use_mma)
    return launch_bwd_wgmma<D>(kid, q, k, v, g, rowa, rowl, delta, lengths,
                               slopes, dq, dk, dv, sq, sk, sv, sg, sdq, sdk,
                               sdv, B, tq, tk, H, causal, scale, smem,
                               stages, stream);
  using G = F32<D>;
  if (smem != G::BWD_SMEM || stages != F_STAGES)
    return (int)cudaErrorInvalidValue;
  const DqF32 fq = dq_f32_kernel<D>(kid);
  const DkvF32 fkv = dkv_f32_kernel<D>(kid);
  int err;
  static bool attr[3] = {false, false, false};
  if (!attr[kid]) {
    err = (int)cudaFuncSetAttribute(
        fq, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BWD_SMEM);
    if (!err)
      err = (int)cudaFuncSetAttribute(
          fkv, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BWD_SMEM);
    if (err) return err;
    attr[kid] = true;
  }
  dim3 gq(H, B, (tq + G::FQ - 1) / G::FQ), gk(H, B, (tk + G::FQ - 1) / G::FQ);
  fq<<<gq, NT, G::BWD_SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g,
      delta, lengths, slopes, rowa, rowl, (float*)dq, sq, sk, sv, sg, sdq,
      tq, tk, H, causal, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  fkv<<<gk, NT, G::BWD_SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g,
      delta, lengths, slopes, rowa, rowl, (float*)dk, (float*)dv, sq, sk,
      sv, sg, sdk, sdv, tq, tk, H, causal, scale);
  return (int)cudaGetLastError();
}

int launch_bwd(int kid, int use_mma, int d, const void* q, const void* k,
               const void* v, const void* g, float* rowa, float* rowl,
               const float* delta, const int* lengths, const float* slopes,
               void* dq, void* dk, void* dv, Seq sq, Seq sk, Seq sv, Seq sg,
               Seq sdq, Seq sdk, Seq sdv, int B, int tq, int tk, int H,
               int causal, float scale, int smem, int stages,
               cudaStream_t stream) {
  switch (d) {
#define BWD_D(W)                                                          \
  case W:                                                                 \
    return launch_bwd_d<W>(kid, use_mma, q, k, v, g, rowa, rowl, delta,   \
                           lengths, slopes, dq, dk, dv, sq, sk, sv, sg,   \
                           sdq, sdk, sdv, B, tq, tk, H, causal, scale,    \
                           smem, stages, stream);
    BWD_D(32)
    BWD_D(64)
    BWD_D(128)
#undef BWD_D
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Strides are in elements: (batch, row) of each packed operand (K3/K3b:
// the head stride is head_dim), (batch, head, row) of each operand of
// K4, K4b, K5 and K5b.  head_dim is 32, 64 or 128 (the instantiations;
// any other is refused).  K3/K4 take the forward's plan: in bfloat16
// the wgmma body's (smem bytes, resident key tiles, V stages; 0 tiles:
// the streaming body's smem and stages), in float32 the one-pass body's
// (smem bytes, query rows per tile, stages).
int flash_fwd_packed_launch(const void* q, const void* k, const void* v,
                            void* o, float* lse, const int* lengths,
                            const float* slopes, long long q_bs,
                            long long q_rs, long long k_bs, long long k_rs,
                            long long v_bs, long long v_rs, long long o_bs,
                            long long o_rs, int B, int T_, int H,
                            int head_dim, int bf16, int causal, float scale,
                            int smem, int tiles, int stages, void* stream) {
  const long long hd = head_dim;
  Seq sq{q_bs, hd, q_rs}, sk{k_bs, hd, k_rs}, sv{v_bs, hd, v_rs};
  Seq so{o_bs, hd, o_rs};
  return launch_fwd(0, bf16, head_dim, q, k, v, o, lse, lengths, slopes, sq,
                    sk, sv, so, B, T_, T_, H, causal, scale, smem, tiles,
                    stages, (cudaStream_t)stream);
}

// K4: Tq = Tk = T_ (<= 1024 on its path); lse (B, H, T) or null.
int flash_fwd_full_launch(const void* q, const void* k, const void* v,
                          void* o, float* lse, const int* lengths,
                          const float* slopes, long long q_bs,
                          long long q_hs, long long q_rs, long long k_bs,
                          long long k_hs, long long k_rs, long long v_bs,
                          long long v_hs, long long v_rs, long long o_bs,
                          long long o_hs, long long o_rs, int B, int T_,
                          int H, int head_dim, int bf16, int causal,
                          float scale, int smem, int tiles, int stages,
                          void* stream) {
  Seq sq{q_bs, q_hs, q_rs}, sk{k_bs, k_hs, k_rs}, sv{v_bs, v_hs, v_rs};
  Seq so{o_bs, o_hs, o_rs};
  return launch_fwd(1, bf16, head_dim, q, k, v, o, lse, lengths, slopes, sq,
                    sk, sv, so, B, T_, T_, H, causal, scale, smem, tiles,
                    stages, (cudaStream_t)stream);
}

// K5: Tq queries against Tk keys, no lse; the plan of its body
// (k5_fwd_plan in bfloat16, f32_fwd_plan in float32).
int flash_fwd_tiled_launch(const void* q, const void* k, const void* v,
                           void* o, const int* lengths, const float* slopes,
                           long long q_bs, long long q_hs, long long q_rs,
                           long long k_bs, long long k_hs, long long k_rs,
                           long long v_bs, long long v_hs, long long v_rs,
                           long long o_bs, long long o_hs, long long o_rs,
                           int B, int Tq, int Tk, int H, int head_dim,
                           int bf16, int causal, float scale, int smem,
                           int tiles, int stages, void* stream) {
  Seq sq{q_bs, q_hs, q_rs}, sk{k_bs, k_hs, k_rs}, sv{v_bs, v_hs, v_rs};
  Seq so{o_bs, o_hs, o_rs};
  return launch_fwd(2, bf16, head_dim, q, k, v, o, nullptr, lengths, slopes,
                    sq, sk, sv, so, B, Tq, Tk, H, causal, scale, smem, tiles,
                    stages, (cudaStream_t)stream);
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
                            int H, int head_dim, int bf16, int causal,
                            float scale, int smem, int stages,
                            void* stream) {
  const long long hd = head_dim;
  Seq sq{q_bs, hd, q_rs}, sk{k_bs, hd, k_rs}, sv{v_bs, hd, v_rs};
  Seq sg{g_bs, hd, g_rs};
  Seq sdq{dq_bs, hd, dq_rs}, sdk{dk_bs, hd, dk_rs}, sdv{dv_bs, hd, dv_rs};
  return launch_bwd(0, bf16, head_dim, q, k, v, g, const_cast<float*>(lse),
                    nullptr, delta, lengths, slopes, dq, dk, dv, sq, sk, sv,
                    sg, sdq, sdk, sdv, B, T_, T_, H, causal, scale, smem,
                    stages, (cudaStream_t)stream);
}

// K4b (`kid` 1: Tq = Tk, rowa = lse from K4, rowl null) or K5b (`kid` 2:
// rowa and rowl receive each row's m and l from the dq kernel) on (B, H,
// T, D) operands; `smem` and `stages` are the backward's plan
// (bwd_smem_plan in bfloat16, f32_bwd_plan in float32).
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
                          int head_dim, int bf16, int causal, float scale,
                          int smem, int stages, void* stream) {
  if (kid < 1 || kid > 2 || (kid == 2) != (rowl != nullptr))
    return (int)cudaErrorInvalidValue;
  Seq sq{q_bs, q_hs, q_rs}, sk{k_bs, k_hs, k_rs}, sv{v_bs, v_hs, v_rs};
  Seq sg{g_bs, g_hs, g_rs};
  Seq sdq{dq_bs, dq_hs, dq_rs}, sdk{dk_bs, dk_hs, dk_rs};
  Seq sdv{dv_bs, dv_hs, dv_rs};
  return launch_bwd(kid, bf16, head_dim, q, k, v, g, rowa, rowl, delta,
                    lengths, slopes, dq, dk, dv, sq, sk, sv, sg, sdq, sdk,
                    sdv, B, Tq, Tk, H, causal, scale, smem, stages,
                    (cudaStream_t)stream);
}

}  // extern "C"
