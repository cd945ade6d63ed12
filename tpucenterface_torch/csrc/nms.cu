// Fused sigmoid + 3x3 pseudo-NMS for Hopper (sm_90a).
//
// Replaces the TPU kernel tpucenterface/decode/pallas_nms.py::sigmoid_pseudo_nms_pallas
// (kernel _nms_kernel): out = s where s = sigmoid(x) equals the maximum of its
// 3x3 window (borders count as -inf, so every tied cell of a plateau stays),
// else 0. One pass: the logits are read once and the masked scores written
// once; no sigmoid map or shifted maxima reach device memory.
//
// Design: one thread per cell, consecutive threads on consecutive columns.
// A thread reads the up to nine logits of its window (eight of them hits in
// L1, loaded by its neighbours) and takes the sigmoid of each. The maximum of
// the nine equals the separable row-then-column maximum of the reference,
// since a maximum does not round.
//
// The sigmoid is 1/(1+expf(-x)) with IEEE division and the accurate expf (no
// --use_fast_math), the expression of decode.cu: the same arithmetic as
// torch.sigmoid on the GPU, which the exact test max == s relies on.
//
// Bound on an H100 SXM: B*H*W*4 bytes in and as many out, 6.6 MB at
// (32, 160, 160): 2 us at 3.35 TB/s. The nine expf per cell keep this version
// above that; sharing the sigmoids of a tile through shared memory is later
// work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoid_exact(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ hm, long long sb, long long sy, long long sx,
           float* __restrict__ out, int H, int W, long long cells) {
  const long long cell = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (cell >= cells) return;
  const int x = static_cast<int>(cell % W);
  const int y = static_cast<int>((cell / W) % H);
  const long long b = cell / (static_cast<long long>(W) * H);
  const float* p = hm + b * sb;
  const float s = sigmoid_exact(p[y * sy + x * sx]);
  float m = s;
  for (int yy = max(y - 1, 0); yy <= min(y + 1, H - 1); ++yy) {
    for (int xx = max(x - 1, 0); xx <= min(x + 1, W - 1); ++xx) {
      m = fmaxf(m, sigmoid_exact(p[yy * sy + xx * sx]));
    }
  }
  out[cell] = (m == s) ? s : 0.f;
}

}  // namespace

// Launches the pass on `stream`; returns cudaGetLastError() as an int.
// hm is read through element strides (sb, sy, sx), so a channel slice of a
// wider map needs no copy; out is (B, H, W) contiguous.
extern "C" int tcf_sigmoid_nms(const float* hm, long long sb, long long sy, long long sx,
                               float* out, int B, int H, int W, void* stream) {
  const long long cells = static_cast<long long>(B) * H * W;
  const long long blocks = (cells + kThreads - 1) / kThreads;
  if (cells < 1 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  nms_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      hm, sb, sy, sx, out, H, W, cells);
  return static_cast<int>(cudaGetLastError());
}
