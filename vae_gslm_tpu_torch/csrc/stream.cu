// Weight-stream probe, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/bench_slope.py::k_block, launched by
// mk_stream: a grid over the L layers of an (L, R, C) int8 stack whose
// BlockSpec DMAs each (1, R, C) layer slice into VMEM, the kernel itself
// writing only the int32 sum of the first column of the slice's [:8, :128]
// tile to one (1, 1) output (the last layer's value remains).  Its time is
// the time to stream the stack from HBM.  Its plain PyTorch version is
// stream_sums_plain in vae_gslm_tpu_torch/ops/stream.py.
//
// A CUDA block has no DMA of a whole slice into on-chip memory, so this
// kernel does the work the TPU's BlockSpec did: it reads every byte of the
// stack and returns per-layer int32 sums of each whole slice (so that no
// load can be elided), and beside them the TPU kernel's own output.
//
// Bound.  Bytes: the stack read once, 201.3 MB for (16, 1024, 12288), or
// 60.1 us at the H100's published 3.35 TB/s; the sums are a few bytes.
//
// Design.  BPL blocks per layer of 256 threads, each summing a contiguous
// share of its layer slice with 16-byte loads (a warp reads 512
// contiguous bytes per load), four loads in flight per thread; __dp4a
// against 0x01010101 sums four signed bytes into an int32; a block
// reduction, then one int32 atomicAdd per block into its layer's sum
// (exact in any order; |sum| <= 128 * 12.6 M < 2^31).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int BPL = 64;    // blocks per layer
constexpr int UNROLL = 4;

__device__ __forceinline__ int sum16(const int4 v) {
  int s = __dp4a(v.x, 0x01010101, 0);
  s = __dp4a(v.y, 0x01010101, s);
  s = __dp4a(v.z, 0x01010101, s);
  return __dp4a(v.w, 0x01010101, s);
}

__global__ void __launch_bounds__(NT) stream_kernel(
    const int8_t* __restrict__ w, int* __restrict__ sums, long long n16,
    int layers, long long row_bytes) {
  __shared__ int red[NT / 32];
  const int layer = blockIdx.x / BPL, chunk = blockIdx.x % BPL;
  const int4* base = reinterpret_cast<const int4*>(w) + (long long)layer * n16;
  const long long per = (n16 + BPL - 1) / BPL;
  const long long lo = chunk * per;
  const long long hi = lo + per < n16 ? lo + per : n16;
  int acc = 0;
  long long i = lo + threadIdx.x;
  for (; i + (UNROLL - 1) * NT < hi; i += UNROLL * NT) {
    int4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(base + i + u * NT);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc += sum16(v[u]);
  }
  for (; i < hi; i += NT) acc += sum16(__ldg(base + i));
#pragma unroll
  for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int k = 0; k < NT / 32; ++k) s += red[k];
    atomicAdd(sums + layer, s);
    if (layer == layers - 1 && chunk == 0) {
      // k_block's output: the first column of the [:8, :128] tile summed
      const int8_t* tile = w + (long long)layer * n16 * 16;
      int t = 0;
      for (int r = 0; r < 8; ++r) t += tile[r * row_bytes];
      sums[layers] = t;
    }
  }
}

}  // namespace

// Plain C entry point (ctypes): w (L, R, C) int8 contiguous with R * C a
// multiple of 16, R >= 8, C >= 128; sums (L + 1,) int32 zeroed by the
// caller: the per-layer sums, then the tile sum.  Returns the cudaError_t
// of the launch.
extern "C" int stream_sums_launch(const void* w, void* sums, int layers,
                                  long long rows, long long cols,
                                  void* stream) {
  if (layers <= 0 || rows < 8 || cols < 128 || (rows * cols) % 16)
    return (int)cudaErrorInvalidValue;
  stream_kernel<<<layers * BPL, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), static_cast<int*>(sums),
      rows * cols / 16, layers, cols);
  return (int)cudaGetLastError();
}
