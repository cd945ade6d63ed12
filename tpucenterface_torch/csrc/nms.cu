// Fused sigmoid + 3x3 pseudo-NMS for Hopper (sm_90a).
//
// Replaces the TPU kernel tpucenterface/decode/pallas_nms.py::sigmoid_pseudo_nms_pallas
// (kernel _nms_kernel): out = s where s = sigmoid(x) equals the maximum of its
// 3x3 window (borders count as -inf, so every tied cell of a plateau stays),
// else 0. One pass: the logits are read once and the masked scores written
// once; no sigmoid map or shifted maxima reach device memory.
//
// Bound on an H100 SXM: B*H*W*4 bytes in and as many out, 6.6 MB at
// (32, 160, 160): 2 us at 3.35 TB/s, against one sigmoid and eight maxima a
// cell on the float32 pipes. The first version took nine sigmoids a cell
// (one thread a cell, each reading its whole window from global memory);
// what holds this one back at the model's maps is the launch and the
// wrapper's host time.
//
// Design: one block of 256 threads a tile of kTileH x kTileW cells of one
// image. The block reads the tile with its one-cell halo through the given
// strides (consecutive threads on consecutive columns, so the reads coalesce
// where the column stride is 1), takes one sigmoid a cell into shared memory
// (-inf outside the map), then each thread takes the 3x3 maximum of its cells
// from shared memory and keeps the cell where the maximum equals its own
// score. The maximum of the nine equals the separable row-then-column maximum
// of the reference, since a maximum does not round; neighbouring tiles take
// the sigmoid of a halo cell with the same arithmetic, so their scores agree.
// decode/fused_nms.py::sigmoid_pseudo_nms_tiled is this tiling in torch.
//
// The sigmoid is 1/(1+expf(-x)) with IEEE division and the accurate expf (no
// --use_fast_math), the expression of decode.cu: the same arithmetic as
// torch.sigmoid on the GPU, which the exact test max == s relies on.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 32;   // decode/fused_nms.py NMS_TILE
constexpr int kTileW = 32;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kRowsAThread = kTileH * kTileW / kThreads;
constexpr int kLoads = (kHaloH * kHaloW + kThreads - 1) / kThreads;   // halo cells a thread

__device__ __forceinline__ float sigmoid_exact(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ hm, long long sb, long long sy, long long sx,
           float* __restrict__ out, int H, int W) {
  __shared__ float s[kHaloH][kHaloW];
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const float* p = hm + static_cast<long long>(blockIdx.z) * sb;
  // every load of the thread first, then the sigmoids (cell i = hy * kHaloW + hx)
  float v[kLoads];
  bool in[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int hy = i / kHaloW;
    const int gy = y0 - 1 + hy;
    const int gx = x0 - 1 + (i - hy * kHaloW);
    in[j] = i < kHaloH * kHaloW && gy >= 0 && gy < H && gx >= 0 && gx < W;
    v[j] = in[j] ? p[gy * sy + gx * sx] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < kHaloH * kHaloW) s[i / kHaloW][i % kHaloW] = in[j] ? sigmoid_exact(v[j]) : -INFINITY;
  }
  __syncthreads();
  const int tx = threadIdx.x % kTileW;
  const int gx = x0 + tx;
  if (gx >= W) return;
  float* o = out + static_cast<long long>(blockIdx.z) * H * W;
#pragma unroll
  for (int r = 0; r < kRowsAThread; ++r) {
    const int ty = threadIdx.x / kTileW + r * (kThreads / kTileW);
    const int gy = y0 + ty;
    if (gy >= H) break;
    const float c = s[ty + 1][tx + 1];
    float m = c;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, s[ty + dy][tx + dx]);
    o[static_cast<long long>(gy) * W + gx] = (m == c) ? c : 0.f;
  }
}

}  // namespace

// Launches the pass on `stream`; returns cudaGetLastError() as an int.
// hm is read through element strides (sb, sy, sx), so a channel slice of a
// wider map needs no copy; out is (B, H, W) contiguous.
extern "C" int tcf_sigmoid_nms(const float* hm, long long sb, long long sy, long long sx,
                               float* out, int B, int H, int W, void* stream) {
  if (B < 1 || H < 1 || W < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  nms_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(hm, sb, sy, sx, out, H, W);
  return static_cast<int>(cudaGetLastError());
}
