// Single-query decode attention over an int8 per-layer KV cache that
// reads only the filled 256-key blocks, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// vae_gslm_tpu/ops/flash_decode.py::flash_decode_int8_tm (kernel body
// `_kernel`, reached from flash_decode_int8 too), over the head-major
// (B, H, T, D) cache of the port's per-layer path.  Its plain PyTorch
// version is flash_decode_int8_plain in
// vae_gslm_tpu_torch/ops/flash_decode.py.  For one query row per
// (batch, head), in float32 (q is not quantized), over the
// ceil((pos + 1) / 256) key blocks that hold positions <= pos:
//   s   = (q . k_t) / sqrt(D) * k_scale_t + slope * |t - pos|, masked to
//         t <= pos;
//   m'  = max(m, max s); corr = exp(m - m'); e = exp(s - m');
//   l   = l * corr + sum e;  acc = acc * corr + sum (e * v_scale_t) v_t;
// and the output is acc / l.
//
// Bound.  The kernel is bound by HBM bytes: per call it must read the
// B*H*(pos+1) valid cache rows (int8 K and V, 2*D bytes, plus two float32
// scales) and q, and write the output: B*H*((pos+1)*(2*D + 8) + 8*D)
// bytes.  At the per-layer path's B = 128, 16 heads of 64 (8 of 128 and
// 32 of 32 move the same bytes at equal H * D), that is about
// 113 MB at pos 400, 34 us at the H100's published 3.35 TB/s; the
// 500-step rollout launches it once per layer per step, 8000 times per
// request batch.
//
// Design.  The TPU kernel's grid of (B,) programs with all heads each, its
// time-minor DMA slices and its double-buffered VMEM answer Mosaic's
// constraints; here one 256-thread block takes one (batch, head) row
// (2048 blocks at the path's B = 128), so the blocks alone fill the
// card's SMs.  Over the head-major cache, D / 16 threads take one key
// row of D bytes with 16-byte loads (a warp reads 512 contiguous bytes),
// sum their 16 channels of q . k and meet through log2(D / 16) shuffles;
// the block's 256 logits go to shared memory, a block reduction gives the
// max and the sum of the online softmax, and P.V runs in the same
// key-row layout, each thread keeping 16 output channels across the
// blocks, reduced over the block at the end.  D is a template parameter,
// instantiated at 32, 64 and 128 (the launcher dispatches on head_dim and
// refuses any other): at D = 64 four threads a row, 64 rows a pass, at
// 32 two and 128, at 128 eight and 32.  Splitting
// the keys over more blocks (flash-decoding) and cp.async/TMA double
// buffering are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLK = 256;   // keys per block of the online softmax
constexpr int NT = 256;    // threads per thread block
constexpr int NWARP = NT / 32;
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;           // (B, H, D) rows of (H, D), batch stride q_bstride
  int q_bf16;
  long long q_bstride;
  const int8_t* k;         // (B, H, T, D), contiguous
  const int8_t* v;
  const float* k_scale;    // (B, H, T)
  const float* v_scale;
  const float* slopes;     // (H,)
  float* out;              // (B, H, D)
  int H, T, pos;
  float scale;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(NT) flash_decode_kernel(Args a) {
  constexpr int TPR = D / 16;        // threads a key row, 16 channels each
  constexpr int ROWS = NT / TPR;     // key rows a pass
  __shared__ float qs[D];
  __shared__ float logit[BLK];
  __shared__ float p[BLK];
  __shared__ float red_max[NWARP];
  __shared__ float red_sum[NWARP];
  __shared__ float part_acc[NWARP][D];

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < D) {
    const long long off = (long long)b * a.q_bstride + (long long)h * D + tid;
    qs[tid] = a.q_bf16
        ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(a.q)[off])
        : reinterpret_cast<const float*>(a.q)[off];
  }
  const size_t plane = (size_t)bh * a.T * D;
  const int8_t* kp = a.k + plane;
  const int8_t* vp = a.v + plane;
  const float* ksp = a.k_scale + (size_t)bh * a.T;
  const float* vsp = a.v_scale + (size_t)bh * a.T;
  const float slope = a.slopes[h];
  const int nblk = (a.pos + BLK) / BLK;
  // channels [part * 16, part * 16 + 16) of this thread's keys
  const int part = tid % TPR;
  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.f;
  float m = NEG_INF, l = 0.f;
  __syncthreads();

  for (int blk = 0; blk < nblk; ++blk) {
    const int t0 = blk * BLK;
    // q . k of the block's 256 keys into shared memory
#pragma unroll
    for (int pass = 0; pass < BLK / ROWS; ++pass) {
      const int key = pass * ROWS + tid / TPR;
      const int4 raw = *reinterpret_cast<const int4*>(
          kp + (size_t)(t0 + key) * D + part * 16);
      const int8_t* kb = reinterpret_cast<const int8_t*>(&raw);
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) dot = fmaf(qs[part * 16 + j], (float)kb[j], dot);
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (part == 0) logit[key] = dot;
    }
    __syncthreads();

    // scale, ALiBi and mask; the block max and the online-softmax update
    const int t = t0 + tid;
    float s = logit[tid] * a.scale * ksp[t] + slope * fabsf((float)(t - a.pos));
    if (t > a.pos) s = NEG_INF;
    float x = warp_max(s);
    if (lane == 0) red_max[warp] = x;
    __syncthreads();
    float bmax = red_max[0];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) bmax = fmaxf(bmax, red_max[w]);
    const float m_new = fmaxf(m, bmax);
    const float corr = expf(m - m_new);
    const float e = expf(s - m_new);
    p[tid] = e * vsp[t];
    x = warp_sum(e);
    if (lane == 0) red_sum[warp] = x;
    __syncthreads();
    float bsum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) bsum += red_sum[w];
    l = l * corr + bsum;
    m = m_new;

    // P . V over the block's keys
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] *= corr;
#pragma unroll
    for (int pass = 0; pass < BLK / ROWS; ++pass) {
      const int key = pass * ROWS + tid / TPR;
      const float pk = p[key];
      const int4 raw = *reinterpret_cast<const int4*>(
          vp + (size_t)(t0 + key) * D + part * 16);
      const int8_t* vb = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] = fmaf(pk, (float)vb[j], acc[j]);
    }
    __syncthreads();   // logit, p and the reductions are rewritten next
  }

  // lanes with the same tid % TPR hold the same channels
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float y = acc[j];
#pragma unroll
    for (int o = TPR; o < 32; o <<= 1)
      y += __shfl_xor_sync(0xffffffffu, y, o);
    acc[j] = y;
  }
  if (lane < TPR) {
#pragma unroll
    for (int j = 0; j < 16; ++j) part_acc[warp][lane * 16 + j] = acc[j];
  }
  __syncthreads();
  if (tid < D) {
    float y = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) y += part_acc[w][tid];
    a.out[(size_t)bh * D + tid] = y / l;
  }
}

}  // namespace

// Plain C entry point (ctypes): returns the cudaError_t of the launch.
extern "C" int flash_decode_int8_launch(
    const void* q, int q_bf16, long long q_bstride, const void* k,
    const void* v, const void* k_scale, const void* v_scale,
    const void* slopes, void* out, int B, int H, int T, int head_dim, int pos,
    float scale, void* stream) {
  if (T % BLK || pos < 0 || pos >= T || B <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.q_bf16 = q_bf16;
  a.q_bstride = q_bstride;
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.slopes = static_cast<const float*>(slopes);
  a.out = static_cast<float*>(out);
  a.H = H;
  a.T = T;
  a.pos = pos;
  a.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      flash_decode_kernel<32><<<B * H, NT, 0, st>>>(a);
      break;
    case 64:
      flash_decode_kernel<64><<<B * H, NT, 0, st>>>(a);
      break;
    case 128:
      flash_decode_kernel<128><<<B * H, NT, 0, st>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
