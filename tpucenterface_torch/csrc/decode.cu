// Fused CenterNet decode for Hopper (sm_90a).
//
// Replaces the TPU kernel tpucenterface/decode/pallas_decode.py::decode_feats_pallas
// (kernel _decode_kernel). For each image:
//   sigmoid(hm) -> 3x3 max window with -inf borders (peaks keep their score,
//   other cells become 0) -> exact top-K as K rounds of argmax over a per-row
//   max cache, ties to the lowest row and then the lowest column (the order of
//   lax.top_k), each emitted cell knocked out to -1 -> gather wh/off at the
//   peak -> boxes (c + off -/+ wh/2) * stride.
//
// Design: one thread block per image.
//   Phase 1 (all threads): the masked peak map, written to a global scratch
//     buffer the wrapper allocates (H*W floats per image: 100 KB at 640 and
//     256 KB at the 1024 bucket, more than a block's 227 KB of shared memory),
//     then the per-row maxima into shared memory (H floats).
//   Phase 2 (warp 0): K rounds. A warp reduction over the row maxima gives the
//     value and its lowest row; a warp reduction over that row gives the
//     lowest column holding it and the row's runner-up value, which becomes
//     the row's new maximum once the cell is knocked out. Lane 0 gathers
//     wh/off and writes output lane i.
// hm, wh and off are read by pointer and element strides, so slices of the
// fused (B, H, W, 5) head tensor need no copy.
//
// The sigmoid is 1/(1+expf(-x)) with IEEE division and the accurate expf
// (no --use_fast_math, no __expf): the same arithmetic as torch.sigmoid on the
// GPU, which the peak test (max == score, an exact comparison) relies on.
//
// Bound on an H100 SXM: the kernel must read hm once (B*H*W*4 bytes, 3.3 MB
// at batch 32 and 640x640 input) and the K gathered wh/off cells, and write
// K boxes and scores: about 1 us at 3.35 TB/s. What holds it back is the K
// sequential rounds, each a chain of dependent warp shuffles and loads, on
// only B blocks (32 of the 132 SMs at batch 32). Making it fast (more blocks
// per image, a two-stage select) is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Plane3 {
  const float* p;
  long long sb, sy, sx;
};

struct Plane4 {
  const float* p;
  long long sb, sy, sx, sc;
};

__device__ __forceinline__ float sigmoid_exact(float x) {
  return 1.f / (1.f + expf(-x));
}

// (v2, i2) beats (v, i): larger value, then lower index.
__device__ __forceinline__ bool beats(float v2, int i2, float v, int i) {
  return v2 > v || (v2 == v && i2 < i);
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(Plane3 hm, Plane4 wh, Plane4 off, float* __restrict__ peaks,
              float* __restrict__ boxes, float* __restrict__ scores,
              int* __restrict__ idx, int H, int W, int K, float stride,
              int wh_log) {
  extern __shared__ float row_max[];  // H floats
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* hmb = hm.p + b * hm.sb;
  float* pk = peaks + static_cast<long long>(b) * H * W;

  // ---- Phase 1: masked peak map --------------------------------------------
  for (int cell = tid; cell < H * W; cell += blockDim.x) {
    const int y = cell / W;
    const int x = cell - y * W;
    const float s = sigmoid_exact(hmb[y * hm.sy + x * hm.sx]);
    float m = s;
    for (int yy = max(y - 1, 0); yy <= min(y + 1, H - 1); ++yy) {
      for (int xx = max(x - 1, 0); xx <= min(x + 1, W - 1); ++xx) {
        m = fmaxf(m, sigmoid_exact(hmb[yy * hm.sy + xx * hm.sx]));
      }
    }
    pk[cell] = (m == s) ? s : 0.f;
  }
  __syncthreads();
  for (int r = warp; r < H; r += nwarps) {
    float m = -INFINITY;
    for (int x = lane; x < W; x += 32) m = fmaxf(m, pk[r * W + x]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    if (lane == 0) row_max[r] = m;
  }
  __syncthreads();
  if (warp != 0) return;

  // ---- Phase 2: K rounds of exact argmax (warp 0) --------------------------
  for (int i = 0; i < K; ++i) {
    float g = -INFINITY;
    int r = H;
    for (int rr = lane; rr < H; rr += 32) {
      const float v = row_max[rr];
      if (beats(v, rr, g, r)) { g = v; r = rr; }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float g2 = __shfl_xor_sync(kFull, g, o);
      const int r2 = __shfl_xor_sync(kFull, r, o);
      if (beats(g2, r2, g, r)) { g = g2; r = r2; }
    }
    // best (v1, lowest column c1) of row r, and the best value left beside it
    const float* row = pk + r * W;
    float v1 = -INFINITY, v2 = -INFINITY;
    int c1 = W;
    for (int x = lane; x < W; x += 32) {
      const float v = row[x];
      if (beats(v, x, v1, c1)) { v2 = v1; v1 = v; c1 = x; }
      else { v2 = fmaxf(v2, v); }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov1 = __shfl_xor_sync(kFull, v1, o);
      const float ov2 = __shfl_xor_sync(kFull, v2, o);
      const int oc1 = __shfl_xor_sync(kFull, c1, o);
      if (beats(ov1, oc1, v1, c1)) { v2 = fmaxf(ov2, v1); v1 = ov1; c1 = oc1; }
      else { v2 = fmaxf(v2, ov1); }
    }
    if (lane == 0) {
      const int c = c1;
      const long long ow = b * wh.sb + r * wh.sy + c * wh.sx;
      const long long oo = b * off.sb + r * off.sy + c * off.sx;
      float bw = wh.p[ow];
      float bh = wh.p[ow + wh.sc];
      const float cx = static_cast<float>(c) + off.p[oo];
      const float cy = static_cast<float>(r) + off.p[oo + off.sc];
      if (wh_log) {
        bw = expf(bw);
        bh = expf(bh);
      } else {
        bw = fmaxf(bw, 0.f);
        bh = fmaxf(bh, 0.f);
      }
      const long long o = static_cast<long long>(b) * K + i;
      float* box = boxes + o * 4;
      box[0] = (cx - bw * 0.5f) * stride;
      box[1] = (cy - bh * 0.5f) * stride;
      box[2] = (cx + bw * 0.5f) * stride;
      box[3] = (cy + bh * 0.5f) * stride;
      scores[o] = v1;
      idx[o] = r * W + c;
      pk[r * W + c] = -1.f;
      row_max[r] = v2;
    }
    __syncwarp();
  }
}

}  // namespace

// Launches the decode on `stream`; returns cudaGetLastError() as an int.
// Requires 1 <= K <= H*W; pointers are device pointers, strides in elements.
extern "C" int tcf_decode(
    const float* hm, long long hm_sb, long long hm_sy, long long hm_sx,
    const float* wh, long long wh_sb, long long wh_sy, long long wh_sx, long long wh_sc,
    const float* off, long long off_sb, long long off_sy, long long off_sx, long long off_sc,
    float* peaks, float* boxes, float* scores, int* idx,
    int B, int H, int W, int K, float stride, int wh_log, void* stream) {
  const size_t smem = static_cast<size_t>(H) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Plane3 hmp{hm, hm_sb, hm_sy, hm_sx};
  const Plane4 whp{wh, wh_sb, wh_sy, wh_sx, wh_sc};
  const Plane4 offp{off, off_sb, off_sy, off_sx, off_sc};
  decode_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      hmp, whp, offp, peaks, boxes, scores, idx, H, W, K, stride, wh_log);
  return static_cast<int>(cudaGetLastError());
}
