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
//     block max, rounding half to even, and sums int8 x int8 in int32.
//
// Bound.  The kernel is bound by HBM bytes: per call it reads the
// B*H*P*(2*D + 8) bytes of the P valid cache rows (int8 K and V plus two
// float32 scales per row).  At the flagship width (H=16, D=64) and B=8,
// P averages about 400 over the 500 AR steps of a 150-frame prompt:
// 8*16*400*136 = 7.0 MB, or 2.1 us at 3.35 TB/s.  The pipeline launches it
// once per layer per step, 16 * 500 = 8000 times per request batch, so
// until a later change captures the step in a CUDA graph, launch latency
// (8000 x a few us) will exceed that bound.
//
// Design.  One thread block of 256 threads per (batch row, head): thread t
// owns position t of each 256-row block while logits are formed, and
// threads (d, part) own output channel d while P.V is summed.  The cache
// rows are read straight from device memory with coalesced loads (the
// time-minor cold planes byte by byte across the warp, the tail rows and
// the cold V rows 16 bytes at a time); the float32 logits and the int8
// probabilities of the current block live in shared memory.  The float
// operations that the reference rounds separately are written with
// explicit round-to-nearest intrinsics so that the compiler does not
// contract them into fused multiply-adds.  wgmma, TMA and a single-tier
// cache layout are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLK = 256;   // positions per cold block and in the tail
constexpr int NT = 256;    // threads per block
constexpr int NWARP = NT / 32;
constexpr float NEG_INF = -1e30f;

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
  int B, H, D, nblk, pos, flushed;
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

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();                       // red may still be read
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
  __syncthreads();
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

template <typename T>
__global__ void __launch_bounds__(NT) fused_decode_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D;
  const int P = (a.nblk + 1) * BLK;        // cold rows + the tail block
  float* prob = reinterpret_cast<float*>(smem);   // P logits, then e
  float* qf = prob + P;                    // D
  float* red = qf + D;                     // NWARP (+ pad)
  int* q8p = reinterpret_cast<int*>(red + 32);    // D / 4 packed int8
  int* u8p = q8p + D / 4;                  // BLK / 4 packed int8

  const int bh = blockIdx.x;               // b * H + h
  const int h = bh % a.H;
  const size_t qoff = (size_t)(bh / a.H) * a.row_stride + (size_t)h * D;
  const int tid = threadIdx.x;
  const size_t BH = (size_t)a.B * a.H;
  const float slope = a.slopes[h];

  // ---- query: float32 copy, per-head int8 quantization -------------
  const T* q = static_cast<const T*>(a.q) + qoff;
  const float qv = tid < D ? to_f(q[tid]) : 0.f;
  if (tid < D) qf[tid] = qv;
  const float q_scale = __fdiv_rn(fmaxf(block_max(fabsf(qv), red), 1e-8f),
                                  127.f);
  if (tid < D)
    reinterpret_cast<int8_t*>(q8p)[tid] =
        (int8_t)__float2int_rn(__fdiv_rn(qv, q_scale));
  __syncthreads();

  // ---- logits of the cold blocks: (D, BLK) time-minor planes -------
  for (int nb = 0; nb < a.nblk; ++nb) {
    const size_t plane = (size_t)nb * BH + bh;
    const int8_t* k = a.k_cold + plane * D * BLK + tid;
    int acc = 0;
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const int8_t* p = k + (size_t)(4 * d4) * BLK;
      const int packed = (int)(uint8_t)p[0] | ((int)(uint8_t)p[BLK] << 8) |
                         ((int)(uint8_t)p[2 * BLK] << 16) |
                         ((int)(uint8_t)p[3 * BLK] << 24);
      acc = __dp4a(q8p[d4], packed, acc);
    }
    const int t = nb * BLK + tid;
    prob[t] = logit(acc, q_scale, a.kc_scale[plane * BLK + tid], a.scale,
                    slope, t, a.pos);
  }

  // ---- logits of the tail: (BLK, D) time-major rows, masked t < pos --
  {
    const int4* row = reinterpret_cast<const int4*>(
        a.k_tail + ((size_t)bh * BLK + tid) * D);
    int acc = 0;
    for (int i = 0; i < D / 16; ++i) {
      const int4 v = row[i];
      acc = __dp4a(q8p[4 * i], v.x, acc);
      acc = __dp4a(q8p[4 * i + 1], v.y, acc);
      acc = __dp4a(q8p[4 * i + 2], v.z, acc);
      acc = __dp4a(q8p[4 * i + 3], v.w, acc);
    }
    const int t = a.flushed + tid;
    const float s = logit(acc, q_scale, a.kt_scale[(size_t)bh * BLK + tid],
                          a.scale, slope, t, a.pos);
    prob[a.nblk * BLK + tid] = t < a.pos ? s : NEG_INF;
  }

  // ---- the current token's logit, the global max, exponentials -----
  // q . k_new is summed in float64 and rounded once, so that it does not
  // depend on the order of the sum (the plain version does the same): a
  // last-bit change in the largest logit would shift every exponential.
  const T* kn = static_cast<const T*>(a.k_new) + qoff;
  const double dot = block_sum(
      tid < D ? (double)qf[tid] * (double)to_f(kn[tid]) : 0.0,
      reinterpret_cast<double*>(red));
  const float s_self = __fmul_rn(__double2float_rn(dot), a.scale);
  __syncthreads();                         // all logits written
  float mx = -INFINITY;
  for (int i = tid; i < P; i += NT) mx = fmaxf(mx, prob[i]);
  const float m = fmaxf(block_max(mx, red), s_self);
  float ls = 0.f;
  for (int i = tid; i < P; i += NT) {
    const float e = expf(__fsub_rn(prob[i], m));
    prob[i] = e;
    ls += e;
  }
  const float e_self = expf(__fsub_rn(s_self, m));
  const float l = __fadd_rn(block_sum(ls, red), e_self);

  // ---- P.V, one 256-row block at a time ------------------------------
  const int tpd = NT / D;                  // threads per output channel
  const int d = tid / tpd, part = tid % tpd;
  const int span = BLK / tpd;              // rows per thread (== D)
  const T* vn = static_cast<const T*>(a.v_new) + qoff;
  float acc = __fmul_rn(e_self, to_f(vn[d]));
  for (int nb = 0; nb <= a.nblk; ++nb) {
    const bool tail = nb == a.nblk;
    const size_t plane = (size_t)nb * BH + bh;
    const float vs = tail ? a.vt_scale[(size_t)bh * BLK + tid]
                          : a.vc_scale[plane * BLK + tid];
    const float u = __fmul_rn(prob[nb * BLK + tid], vs);
    const float u_scale = __fdiv_rn(fmaxf(block_max(u, red), 1e-20f), 127.f);
    reinterpret_cast<int8_t*>(u8p)[tid] =
        (int8_t)__float2int_rn(__fdiv_rn(u, u_scale));
    __syncthreads();
    int av = 0;
    if (!tail) {                           // cold V: (D, BLK) rows
      const int4* row = reinterpret_cast<const int4*>(
          a.v_cold + (plane * D + d) * BLK + part * span);
      const int* up = u8p + part * span / 4;
      for (int i = 0; i < span / 16; ++i) {
        const int4 v = row[i];
        av = __dp4a(up[4 * i], v.x, av);
        av = __dp4a(up[4 * i + 1], v.y, av);
        av = __dp4a(up[4 * i + 2], v.z, av);
        av = __dp4a(up[4 * i + 3], v.w, av);
      }
    } else {                               // tail V: (BLK, D) rows
      const int8_t* vt = a.v_tail + (size_t)bh * BLK * D + d;
      const int8_t* u8 = reinterpret_cast<const int8_t*>(u8p);
      for (int t = part * span; t < (part + 1) * span; ++t)
        av += (int)u8[t] * (int)vt[(size_t)t * D];
    }
    for (int o = tpd / 2; o > 0; o >>= 1)
      av += __shfl_xor_sync(0xffffffffu, av, o);
    acc = __fadd_rn(acc, __fmul_rn((float)av, u_scale));
    __syncthreads();                       // u8p is rewritten next block
  }
  if (part == 0) a.out[(size_t)bh * D + d] = __fdiv_rn(acc, l);
}

size_t smem_bytes(int D, int nblk) {
  return sizeof(float) * ((size_t)(nblk + 1) * BLK + D + 32) + D + BLK;
}

}  // namespace

// The caches hold every layer (shapes in the wrapper,
// vae_gslm_tpu_torch/ops/fused_decode.py); this call reads layer li.
// Offsetting here keeps the per-call host work in the wrapper to taking
// the tensors' base pointers.
extern "C" int fused_decode_attention_launch(
    const void* q, const void* k_new, const void* v_new, int in_bf16,
    const void* k_cold, const void* v_cold, const void* kc_scale,
    const void* vc_scale, const void* k_tail, const void* v_tail,
    const void* kt_scale, const void* vt_scale, const void* slopes,
    void* out, long long row_stride, int B, int H, int D, int nb_cap,
    int li, int pos, int flushed, float scale, void* stream) {
  const size_t bh = (size_t)B * H;
  const size_t cold = (size_t)li * nb_cap * bh * BLK;    // rows before li
  const size_t tail = (size_t)li * bh * BLK;
  const int nblk = flushed / BLK;
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
         row_stride, B, H, D, nblk, pos, flushed, scale};
  const size_t smem = smem_bytes(D, nblk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Above the default 48 KB of dynamic shared memory (caches longer
  // than about 11,000 positions) the kernel must opt in.
  const bool big = smem > 48 * 1024;
  if (in_bf16) {
    if (big) {
      const cudaError_t err = cudaFuncSetAttribute(
          fused_decode_kernel<__nv_bfloat16>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    fused_decode_kernel<__nv_bfloat16><<<B * H, NT, smem, s>>>(a);
  } else {
    if (big) {
      const cudaError_t err = cudaFuncSetAttribute(
          fused_decode_kernel<float>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    fused_decode_kernel<float><<<B * H, NT, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}
