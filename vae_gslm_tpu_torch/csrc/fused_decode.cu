// Single-query decode attention over the hybrid cold/tail int8 KV cache,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// vae_gslm_tpu/ops/fused_decode.py::fused_decode_attention_prepared
// (kernel body `_kernel`).  It computes what the reference
// fused_decode_attention_reference computes, and its plain PyTorch
// version is fused_decode_attention_plain in
// vae_gslm_tpu_torch/ops/fused_decode.py:
//   * q quantized to int8 per (batch, head): scale = max(|q|max, 1e-8)/127,
//     rounding half to even;
//   * int8 x int8 QK in int32 (__dp4a), times q_scale * k_scale / sqrt(D),
//     plus ALiBi slope * |t - pos|; tail rows valid only at t < pos, cold
//     rows always valid;
//   * the current token as one extra float32 logit q . k_new / sqrt(D), the
//     dot product summed in float64 and rounded once;
//   * softmax against the global max; P.V requantizes e * v_scale per
//     256-position block (cold blocks from 0, then the tail) against the
//     block max, rounding half to even, and sums int8 x int8 in int32;
//   * the merge e_self * v_new, then the blocks' terms in block order
//     (cold 0 .. nblk - 1, then the tail), each added once, and one
//     division by l at the end.
//
// Bound.  The kernel is bound by HBM bytes: per call it reads the
// B*H*P*(2*D + 8) bytes of the P valid cache rows (int8 K and V plus two
// float32 scales per row).  At the flagship width (H=16, D=64) and B=8,
// P averages about 400 over the 500 AR steps of a 150-frame prompt:
// 8*16*400*136 = 7.0 MB, or 2.1 us at 3.35 TB/s.  What stands between a
// call and that bound is latency: a (batch, head) reads at most a few
// 256-position blocks, so the kernel has to request all of its bytes at
// once and keep the dependent steps after them (max, requantization,
// merge) few and short.
//
// Design.  A thread-block cluster per (batch row, head): CTA r of a
// cluster of C = min(nblk + 1, 8) owns position blocks r, r + C, ..
// (cold blocks 0 .. nblk - 1, the tail as block nblk), so the blocks of a
// (batch, head) run side by side on C SMs.  Each CTA's last thread asks
// the bulk-copy engine (cp.async.bulk, one mbarrier per slot) for every
// K and V plane and its 256 scales before any product, while the other
// threads read q: each cold plane and the tail are contiguous (D x 256
// or 256 x D bytes), so a plane is one copy, the tail's only up to pos.
// Where a CTA's planes outgrow its shared memory (D 256 past 8 blocks),
// the planes stream through a ring of `slots` (ops/fused_decode.py's
// k1_plan, which the launcher checks).  Each CTA forms its blocks'
// logits from shared memory (thread t: position t; cold planes byte by
// byte down the time-minor columns, tail rows 16 bytes at a time in a
// rotated order that keeps the banks apart) and takes its max; thread r
// pushes it into CTA r (st.async: a remote store counted in bytes on CTA
// r's MAXB mbarrier, no fence), so every CTA gets the cluster's maxima
// in one one-way hop.  Each CTA then forms e = exp(s - m), requantizes
// and sums its blocks' P.V in int32 (cold rows: 16-byte rows and
// __dp4a; tail rows: 4 x 4 byte transposes and __dp4a) into one term
// av * u_scale per block.  CTA 0 sums l over the blocks in block order,
// position by position, as the one-block kernel did, and merges the
// terms in the reference's order.  When every CTA owns one block (up to
// 7 cold blocks: the serving path's every state), the others push their
// e and terms into CTA 0's receive buffers the same way (READY counts
// the bytes) and are done; with more blocks a CTA, they arrive on CTA
// 0's READY (release at cluster scope), CTA 0 reads their e and terms
// through distributed shared memory (eight blocks' loads in flight) and
// arrives on each one's DONE, which keeps its shared memory alive until
// then.  The one cluster barrier (arrived at after the mbarrier inits,
// waited on before the first remote access) costs nothing on the path;
// a cluster of one skips all of it.  Every int32 sum is
// exact and every float step is the one-block kernel's, in its order, so
// the output is that kernel's bits.  The float operations that the
// reference rounds separately are written with explicit round-to-nearest
// intrinsics so that the compiler does not contract them into fused
// multiply-adds.  D is a template parameter: every multiple of 16 that
// divides 256.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BLK = 256;         // positions per cold block and in the tail
constexpr int NT = 256;          // threads per CTA
constexpr int NWARP = NT / 32;
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr int MAX_SLOTS = 13;    // slot mbarriers in the header
constexpr int MAXB = 13;         // every CTA's: the cluster's maxima are in
constexpr int READY = 14;        // CTA 0's: the other CTAs' partials are in
constexpr int DONE = 15;         // CTA r > 0's: CTA 0 has read them
constexpr int ISSUER = NT - 1;   // the thread that issues the bulk copies
constexpr int SMEM_LIMIT = 232448;
constexpr float NEG_INF = -1e30f;

// Shared memory of a CTA: a 352-byte header (13 slot mbarriers, MAXB,
// READY, DONE; a scratch of 8 words for each block-wide reduction; the
// cluster's maxima), q8 (D), u8 (256), the int32 P.V sums (4 D), then
// per owned block its e (1 KB) and its term (4 D), then, when every CTA
// owns one block, CTA 0's receive buffers for the e and terms of blocks
// 1 .. nblk (1 KB + 4 D each), then the slots, each a plane and its
// scales (256 D + 1 KB).
constexpr int HDR = 352;
__host__ __device__ constexpr int fixed_bytes(int D, int owned, int nblk) {
  return HDR + 5 * D + BLK + owned * (BLK * 4 + D * 4) +
         (owned == 1 ? nblk * (BLK * 4 + D * 4) : 0);
}
__host__ __device__ constexpr int slot_bytes(int D) {
  return D * BLK + BLK * 4;
}

struct Plan {
  int cluster, owned, slots, smem;
};

// The plan of a call with nblk cold blocks (ops/fused_decode.py::k1_plan
// computes the same); slots is 0 when not even one slot fits.
Plan make_plan(int D, int nblk) {
  Plan p;
  p.cluster = nblk + 1 < MAX_CLUSTER ? nblk + 1 : MAX_CLUSTER;
  p.owned = (nblk + 1 + p.cluster - 1) / p.cluster;
  const int fit =
      (SMEM_LIMIT - fixed_bytes(D, p.owned, nblk)) / slot_bytes(D);
  int slots = 2 * p.owned;
  if (slots > MAX_SLOTS) slots = MAX_SLOTS;
  if (slots > fit) slots = fit > 0 ? fit : 0;
  p.slots = slots;
  p.smem = fixed_bytes(D, p.owned, nblk) + slots * slot_bytes(D);
  return p;
}

struct Args {
  const void* q;            // (B, H, D) float32 or bfloat16, (H, D)
  const void* k_new;        // contiguous per batch row
  const void* v_new;
  const int8_t* k_cold;     // this layer's (NB, B, H, D, BLK)
  const int8_t* v_cold;
  const float* kc_scale;    // this layer's (NB, B, H, BLK)
  const float* vc_scale;
  const int8_t* k_tail;     // this layer's (B, H, BLK, D)
  const int8_t* v_tail;
  const float* kt_scale;    // this layer's (B, H, BLK)
  const float* vt_scale;
  const float* slopes;      // (H,)
  float* out;               // (B, H, D)
  long long row_stride;     // elements between batch rows of q/k_new/v_new
  int B, H, nblk, pos, flushed, cluster, owned, slots;
  float scale;              // 1 / sqrt(D)
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Block-wide reductions; each call site has a scratch of its own, so no
// barrier has to keep an earlier reduction's reads apart from the writes.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = (threadIdx.x & 31) < NWARP ? red[threadIdx.x & 31] : -INFINITY;
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename A>
__device__ __forceinline__ A block_sum(A v, A* red) {
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = (threadIdx.x & 31) < NWARP ? red[threadIdx.x & 31] : A(0);
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// s * (q_scale * k_scale * scale) + slope * |t - pos|, rounded as the
// reference rounds it.
__device__ __forceinline__ float logit(int acc, float q_scale, float ks,
                                       float scale, float slope, int t,
                                       int pos) {
  float f = __fmul_rn(__fmul_rn(q_scale, ks), scale);
  float s = __fmul_rn((float)acc, f);
  return __fadd_rn(s, __fmul_rn(slope, (float)abs(t - pos)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// The cluster barrier in two halves: every thread of every CTA arrives
// once (relaxed: only the mbarrier inits before it, fenced, are ordered)
// and waits once before it touches another CTA.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}
// The same wait with acquire at cluster scope: what other CTAs wrote into
// their shared memory before arriving is visible after it.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// This CTA's shared address `addr` in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
// v into another CTA's shared memory (cluster address dst), counted as 4
// bytes on that CTA's mbarrier (cluster address bar): no fence, the
// mbarrier's phase orders it for the reader.
__device__ __forceinline__ void st_async(uint32_t dst, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];" ::"r"(dst),
      "f"(v), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
// One arrival, with release at cluster scope, on the mbarrier at this
// CTA's shared address `bar` in CTA `rank` of the cluster.
__device__ __forceinline__ void arrive_remote(uint32_t bar, int rank) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n" ::
          "r"(bar),
      "r"(rank)
      : "memory");
}
// `bytes` contiguous bytes from global memory into this CTA's shared
// memory, completing on the mbarrier (both addresses 16-byte aligned).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Load i of a CTA that owns `mine` blocks: K planes of its blocks in
// order (i < mine), then their V planes; each with its 256 scales.  The
// tail's planes are copied only up to pos: the rows past it keep what
// the slot held, which the mask (K) and a zero probability (V: u8 = 0)
// keep out of the result.
template <int D>
__device__ __forceinline__ void issue(const Args& a, unsigned char* slots,
                                      uint64_t* bars, int rank, int mine,
                                      int i) {
  const int o = i < mine ? i : i - mine, j = rank + o * a.cluster;
  const bool v = i >= mine;
  const size_t bh = blockIdx.y, BH = (size_t)a.B * a.H;
  const int8_t* plane;
  const float* sc;
  int rows = BLK;
  if (j < a.nblk) {
    const size_t pl = (size_t)j * BH + bh;
    plane = (v ? a.v_cold : a.k_cold) + pl * D * BLK;
    sc = (v ? a.vc_scale : a.kc_scale) + pl * BLK;
  } else {                                // only the rows below pos
    plane = (v ? a.v_tail : a.k_tail) + bh * D * BLK;
    sc = (v ? a.vt_scale : a.kt_scale) + bh * BLK;
    rows = a.pos - a.flushed;
  }
  const int s = i % a.slots;
  unsigned char* dst = slots + (size_t)s * slot_bytes(D);
  const uint32_t bar = smem_u32(&bars[s]);
  mbar_expect(bar, rows * D + BLK * 4);
  if (rows > 0) bulk_load(smem_u32(dst), plane, rows * D, bar);
  bulk_load(smem_u32(dst + D * BLK), sc, BLK * 4, bar);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) fused_decode_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int PLANE = D * BLK;
  const int C = a.cluster, rank = (int)cluster.block_rank();
  const int nblk = a.nblk;
  const int mine = (nblk + 1 - rank + C - 1) / C;   // blocks this CTA owns
  const int loads = 2 * mine;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  double* red_dot = reinterpret_cast<double*>(smem + 128);  // 8 each
  float* red_q = reinterpret_cast<float*>(smem + 192);
  float* red_m = reinterpret_cast<float*>(smem + 224);
  float* red_u = reinterpret_cast<float*>(smem + 256);
  float* red_l = reinterpret_cast<float*>(smem + 288);
  float* cmax = reinterpret_cast<float*>(smem + 320);  // one per rank
  int8_t* q8 = reinterpret_cast<int8_t*>(smem + HDR);
  int8_t* u8 = q8 + D;
  int* av_s = reinterpret_cast<int*>(u8 + BLK);
  float* prob = reinterpret_cast<float*>(av_s + D);    // owned x BLK
  float* terms = prob + a.owned * BLK;                 // owned x D
  // one block a CTA: the others' e and terms are pushed into CTA 0
  const bool push = C > 1 && a.owned == 1;
  float* recv_e = terms + a.owned * D;                 // nblk x BLK
  float* recv_t = recv_e + (a.owned == 1 ? nblk * BLK : 0);   // nblk x D
  unsigned char* slots = reinterpret_cast<unsigned char*>(
      recv_t + (a.owned == 1 ? nblk * D : 0));

  const int bh = blockIdx.y;
  const int h = bh % a.H;
  const size_t qoff = (size_t)(bh / a.H) * a.row_stride + (size_t)h * D;
  const int tid = threadIdx.x;
  const float slope = a.slopes[h];

  if (tid == ISSUER) {                    // while the others read q
    for (int s = 0; s < a.slots; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_u32(&bars[s]))
                   : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     smem_u32(&bars[READY])),
                 "r"(push || C == 1 ? 1 : C - 1)
                 : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     smem_u32(&bars[DONE]))
                 : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     smem_u32(&bars[MAXB]))
                 : "memory");
    if (C > 1) {                          // the bytes the others will push
      mbar_expect(smem_u32(&bars[MAXB]), 4 * C);
      if (push && rank == 0)
        mbar_expect(smem_u32(&bars[READY]), nblk * (BLK + D) * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < loads && i < a.slots; ++i)
      issue<D>(a, slots, bars, rank, mine, i);
  }
  if (C > 1) cluster_arrive_relaxed();    // this CTA's mbarriers exist

  // ---- query: float32 copy, per-head int8 quantization; the current
  // token's logit (every CTA needs it for the max); q, k_new and v_new
  // are read together, before the first barrier ----------------------
  float qv = 0.f, kv = 0.f, vv = 0.f;
  if (tid < D) {
    qv = to_f(static_cast<const T*>(a.q)[qoff + tid]);
    kv = to_f(static_cast<const T*>(a.k_new)[qoff + tid]);
    vv = to_f(static_cast<const T*>(a.v_new)[qoff + tid]);
  }
  // One reduction round for max |q| and q . k_new; q . k_new is summed
  // in float64 (block_sum's order) and rounded once, so that it does not
  // depend on the order of the sum (the plain version does the same): a
  // last-bit change in the largest logit would shift every exponential.
  float qmax = fabsf(qv);
  double dot = tid < D ? (double)qv * (double)kv : 0.0;
  {
    for (int o = 16; o > 0; o >>= 1) {
      qmax = fmaxf(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if ((tid & 31) == 0) red_q[tid >> 5] = qmax, red_dot[tid >> 5] = dot;
    __syncthreads();
    qmax = (tid & 31) < NWARP ? red_q[tid & 31] : -INFINITY;
    dot = (tid & 31) < NWARP ? red_dot[tid & 31] : 0.0;
    for (int o = 16; o > 0; o >>= 1) {
      qmax = fmaxf(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
  }
  const float q_scale = __fdiv_rn(fmaxf(qmax, 1e-8f), 127.f);
  if (tid < D) q8[tid] = (int8_t)__float2int_rn(__fdiv_rn(qv, q_scale));
  const float s_self = __fmul_rn(__double2float_rn(dot), a.scale);
  const int* q8w = reinterpret_cast<const int*>(q8);
  __syncthreads();                        // q8 is in

  // ---- logits of this CTA's blocks -----------------------------------
  float mx = -INFINITY;
  for (int o = 0; o < mine; ++o) {
    const int s = o % a.slots, j = rank + o * C;
    mbar_wait(smem_u32(&bars[s]), (o / a.slots) & 1);
    const int8_t* kp =
        reinterpret_cast<const int8_t*>(slots + (size_t)s * slot_bytes(D));
    const float* ks = reinterpret_cast<const float*>(kp + PLANE);
    float x;
    if (j < nblk) {                       // cold: (D, BLK), time-minor
      const int8_t* col = kp + tid;
      int acc = 0;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const int8_t* p = col + 4 * d4 * BLK;
        const int packed = (int)(uint8_t)p[0] | ((int)(uint8_t)p[BLK] << 8) |
                           ((int)(uint8_t)p[2 * BLK] << 16) |
                           ((int)(uint8_t)p[3 * BLK] << 24);
        acc = __dp4a(q8w[d4], packed, acc);
      }
      x = logit(acc, q_scale, ks[tid], a.scale, slope, j * BLK + tid,
                a.pos);
    } else {                              // tail: (BLK, D), t < pos
      constexpr int CH = D / 16;          // 16-byte chunks a row
      constexpr int RUN = 128 / D > 0 ? 128 / D : 1;
      const int4* row = reinterpret_cast<const int4*>(kp + tid * D);
      const int rot = tid / RUN;          // 8 rows a phase, 8 bank groups
      int acc = 0;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int c = (i + rot) % CH;
        const int4 v = row[c];
        acc = __dp4a(q8w[4 * c], v.x, acc);
        acc = __dp4a(q8w[4 * c + 1], v.y, acc);
        acc = __dp4a(q8w[4 * c + 2], v.z, acc);
        acc = __dp4a(q8w[4 * c + 3], v.w, acc);
      }
      const int t = a.flushed + tid;
      x = t < a.pos
              ? logit(acc, q_scale, ks[tid], a.scale, slope, t, a.pos)
              : NEG_INF;
    }
    prob[o * BLK + tid] = x;
    mx = fmaxf(mx, x);
    __syncthreads();                      // the slot is read
    if (tid == ISSUER && o + a.slots < loads)
      issue<D>(a, slots, bars, rank, mine, o + a.slots);
  }

  // ---- the global max over the cluster, then exponentials -------------
  // Thread r < C pushes this CTA's max into CTA r's slot for it (st.async,
  // counted on CTA r's MAXB); every CTA waits on its own.
  const float cm = block_max(mx, red_m);
  float m = fmaxf(cm, s_self);
  if (C > 1) {                            // a cluster of one has it all
    cluster_wait();                       // every CTA's mbarriers exist
    if (tid < C)
      st_async(mapa(smem_u32(cmax + rank), tid), cm,
               mapa(smem_u32(&bars[MAXB]), tid));
    mbar_wait(smem_u32(&bars[MAXB]), 0);
    for (int r = 0; r < C; ++r) m = fmaxf(m, cmax[r]);
  }
  for (int o = 0; o < mine; ++o) {
    const float e = expf(__fsub_rn(prob[o * BLK + tid], m));
    prob[o * BLK + tid] = e;
    if (push && rank > 0)                 // block `rank`, to CTA 0
      st_async(mapa(smem_u32(recv_e + (rank - 1) * BLK + tid), 0), e,
               mapa(smem_u32(&bars[READY]), 0));
  }
  const float e_self = expf(__fsub_rn(s_self, m));

  // ---- P.V of this CTA's blocks: one term av * u_scale per block -----
  for (int o = 0; o < mine; ++o) {
    const int i = mine + o, s = i % a.slots, j = rank + o * C;
    mbar_wait(smem_u32(&bars[s]), (i / a.slots) & 1);
    const int8_t* vp =
        reinterpret_cast<const int8_t*>(slots + (size_t)s * slot_bytes(D));
    const float* vs = reinterpret_cast<const float*>(vp + PLANE);
    const float u = __fmul_rn(prob[o * BLK + tid], vs[tid]);
    const float u_scale =
        __fdiv_rn(fmaxf(block_max(u, red_u), 1e-20f), 127.f);
    u8[tid] = (int8_t)__float2int_rn(__fdiv_rn(u, u_scale));
    if (tid < D) av_s[tid] = 0;
    __syncthreads();
    const int* uw = reinterpret_cast<const int*>(u8);
    if (j < nblk) {                       // cold V: (D, BLK) rows
      constexpr int TPD = NT / D;         // threads per output channel
      const int d = tid / TPD, part = tid % TPD;   // D positions each
      const int4* row =
          reinterpret_cast<const int4*>(vp + d * BLK + part * D);
      const int* up = uw + part * D / 4;
      int a0 = 0, a1 = 0, a2 = 0, a3 = 0;  // exact: any order
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const int4 v = row[c];
        a0 = __dp4a(up[4 * c], v.x, a0);
        a1 = __dp4a(up[4 * c + 1], v.y, a1);
        a2 = __dp4a(up[4 * c + 2], v.z, a2);
        a3 = __dp4a(up[4 * c + 3], v.w, a3);
      }
      int av = (a0 + a1) + (a2 + a3);
#pragma unroll
      for (int sh = TPD / 2; sh > 0; sh >>= 1)
        av += __shfl_xor_sync(0xffffffffu, av, sh);
      if (part == 0) atomicAdd(&av_s[d], av);
    } else {                              // tail V: (BLK, D) rows
      // thread (g, part): channels 4 g .. 4 g + 3 over D / 4 positions;
      // four rows' words transposed to one word of 4 positions a channel
      constexpr int G = D / 4, SPAN = BLK / (NT / G);
      const int g = tid % G, part = tid / G;
      int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll 4
      for (int t0 = part * SPAN; t0 < (part + 1) * SPAN; t0 += 4) {
        const int* r = reinterpret_cast<const int*>(vp + t0 * D) + g;
        const int w0 = r[0], w1 = r[D / 4], w2 = r[D / 2], w3 = r[3 * D / 4];
        const int lo01 = __byte_perm(w0, w1, 0x5140);
        const int hi01 = __byte_perm(w0, w1, 0x7362);
        const int lo23 = __byte_perm(w2, w3, 0x5140);
        const int hi23 = __byte_perm(w2, w3, 0x7362);
        const int u4 = uw[t0 / 4];
        a0 = __dp4a(u4, (int)__byte_perm(lo01, lo23, 0x5410), a0);
        a1 = __dp4a(u4, (int)__byte_perm(lo01, lo23, 0x7632), a1);
        a2 = __dp4a(u4, (int)__byte_perm(hi01, hi23, 0x5410), a2);
        a3 = __dp4a(u4, (int)__byte_perm(hi01, hi23, 0x7632), a3);
      }
      atomicAdd(&av_s[4 * g], a0);
      atomicAdd(&av_s[4 * g + 1], a1);
      atomicAdd(&av_s[4 * g + 2], a2);
      atomicAdd(&av_s[4 * g + 3], a3);
    }
    __syncthreads();                      // the sums are in; slot read
    if (tid < D) {
      const float term = __fmul_rn((float)av_s[tid], u_scale);
      terms[o * D + tid] = term;
      if (push && rank > 0)
        st_async(mapa(smem_u32(recv_t + (rank - 1) * D + tid), 0), term,
                 mapa(smem_u32(&bars[READY]), 0));
    }
    if (tid == ISSUER && i + a.slots < loads)
      issue<D>(a, slots, bars, rank, mine, i + a.slots);
  }

  // ---- CTA 0 merges in block order ------------------------------------
  // One block a CTA: the others have pushed their e and terms into CTA
  // 0's receive buffers (READY counts the bytes) and are done.  Several:
  // they arrive on CTA 0's READY once their e and terms are written and
  // wait, with their shared memory, until CTA 0 arrives on their DONE
  // after reading them.
  __syncthreads();                        // this CTA's e and terms are in
  if (rank != 0) {
    if (!push && tid == 0) {
      arrive_remote(smem_u32(&bars[READY]), 0);
      mbar_wait(smem_u32(&bars[DONE]), 0);
    }
    return;
  }
  float ls = 0.f, acc = __fmul_rn(e_self, vv);
  if (push) {
    mbar_wait(smem_u32(&bars[READY]), 0);
    ls = prob[tid];                       // block 0 (0 + e is e)
    if (tid < D) acc = __fadd_rn(acc, terms[tid]);
    for (int j = 1; j <= nblk; ++j) {
      ls = __fadd_rn(ls, recv_e[(j - 1) * BLK + tid]);
      if (tid < D) acc = __fadd_rn(acc, recv_t[(j - 1) * D + tid]);
    }
    const float l = __fadd_rn(block_sum(ls, red_l), e_self);
    if (tid < D) a.out[(size_t)bh * D + tid] = __fdiv_rn(acc, l);
    return;
  }
  if (C > 1) mbar_wait_cluster(smem_u32(&bars[READY]), 0);
  for (int j0 = 0; j0 <= nblk; j0 += 8) {  // 8 blocks' reads in flight
    float ev[8], tv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + u;
      ev[u] = tv[u] = 0.f;
      if (j <= nblk) {
        ev[u] = cluster.map_shared_rank(prob, j % C)[(j / C) * BLK + tid];
        if (tid < D)
          tv[u] = cluster.map_shared_rank(terms, j % C)[(j / C) * D + tid];
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (j0 + u <= nblk) {
        ls = __fadd_rn(ls, ev[u]);
        acc = __fadd_rn(acc, tv[u]);
      }
  }
  if (C > 1) {                            // every remote read is done
    __syncthreads();
    if (tid == ISSUER)
      for (int r = 1; r < C; ++r) arrive_remote(smem_u32(&bars[DONE]), r);
  }
  const float l = __fadd_rn(block_sum(ls, red_l), e_self);
  if (tid < D) a.out[(size_t)bh * D + tid] = __fdiv_rn(acc, l);
}

template <typename T, int D>
int launch(const Args& a, const Plan& p, cudaStream_t s) {
  static int attr = 0;                    // the largest size set so far
  if (p.smem > attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_decode_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return (int)err;
    attr = p.smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, a.B * a.H, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = p.cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, fused_decode_kernel<T, D>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Args& a, const Plan& p, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(a, p, s);
    case 32: return launch<T, 32>(a, p, s);
    case 64: return launch<T, 64>(a, p, s);
    case 128: return launch<T, 128>(a, p, s);
    case 256: return launch<T, 256>(a, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The caches hold every layer (shapes in the wrapper,
// vae_gslm_tpu_torch/ops/fused_decode.py); this call reads layer li.
// Offsetting here keeps the per-call host work in the wrapper to taking
// the tensors' base pointers.  (cluster, owned, slots, smem) is the
// wrapper's k1_plan of this call, refused unless it is this file's.
extern "C" int fused_decode_attention_launch(
    const void* q, const void* k_new, const void* v_new, int in_bf16,
    const void* k_cold, const void* v_cold, const void* kc_scale,
    const void* vc_scale, const void* k_tail, const void* v_tail,
    const void* kt_scale, const void* vt_scale, const void* slopes,
    void* out, long long row_stride, int B, int H, int D, int nb_cap,
    int li, int pos, int flushed, float scale, int cluster, int owned,
    int slots, int smem, void* stream) {
  const size_t bh = (size_t)B * H;
  const size_t cold = (size_t)li * nb_cap * bh * BLK;    // rows before li
  const size_t tail = (size_t)li * bh * BLK;
  const int nblk = flushed / BLK;
  const Plan p = make_plan(D, nblk);
  if (p.slots < 1 || p.cluster != cluster || p.owned != owned ||
      p.slots != slots || p.smem != smem)
    return (int)cudaErrorInvalidValue;
  Args a{q, k_new, v_new,
         static_cast<const int8_t*>(k_cold) + cold * D,
         static_cast<const int8_t*>(v_cold) + cold * D,
         static_cast<const float*>(kc_scale) + cold,
         static_cast<const float*>(vc_scale) + cold,
         static_cast<const int8_t*>(k_tail) + tail * D,
         static_cast<const int8_t*>(v_tail) + tail * D,
         static_cast<const float*>(kt_scale) + tail,
         static_cast<const float*>(vt_scale) + tail,
         static_cast<const float*>(slopes), static_cast<float*>(out),
         row_stride, B, H, nblk, pos, flushed, p.cluster, p.owned, p.slots,
         scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16 ? launch_d<__nv_bfloat16>(a, p, D, s)
                 : launch_d<float>(a, p, D, s);
}
