// Fused CenterNet decode for Hopper (sm_90a), in two stages.
//
// Replaces the TPU kernel tpucenterface/decode/pallas_decode.py::decode_feats_pallas
// (kernel _decode_kernel). For each image:
//   sigmoid(hm) -> 3x3 max window with -inf borders (peaks keep their score,
//   other cells become 0) -> exact top-K, ties to the lowest flat index (the
//   order of lax.top_k) -> gather wh/off at the peak -> boxes
//   (c + off -/+ wh/2) * stride.
//
// Bound on an H100 SXM: hm read once (B*H*W*4 bytes, 3.3 MB at batch 32 and
// a 640x640 input), the K gathered wh/off cells, K boxes, scores and indices
// written: about 1 us at 3.35 TB/s. The TPU kernel takes the top-K as K
// serial rounds of argmax on one core; this one selects, on many blocks.
//
// Keys. Every peak value is >= +0 (non-peaks are +0, and 1/(1+inf) is +0,
// never -0), and the bits of such floats order as unsigned integers. The key
// of a cell is bits(v) << 32 | (0xFFFFFFFF - flat index): a larger key is a
// higher score and, among equal scores, a lower index. Keys are unique, so
// the top-K by key is exact and deterministic, and it is lax.top_k's.
//
// Stage 1, band_kernel, grid (bands, B): a band of R rows of one image.
//   The sigmoids of its rows and the two halo rows (-inf outside the map)
//   into shared memory, once a cell; the 3x3 max over them; the peak map;
//   the keys of the positive peaks, appended with one atomic a warp. If
//   more than K' = min(K, R*W) are positive, a radix select on the keys
//   (8 bits a pass from the top, a 256-bin histogram, until the chosen bin
//   holds exactly the keys still wanted) keeps the band's top K'. Else all
//   of them, then the band's lowest-index zeros in index order (a ballot
//   and per-warp counts a chunk of cells) until K' are kept. The K' keys go
//   unsorted to cand[b][band][:]; the empty slots of a ragged last band get
//   key 0, below every cell's. The global top-K lies in the union of the
//   bands' top-K', as keys are unique.
// Stage 2, merge_kernel, grid (B): the image's bands*K' keys into shared
//   memory; a radix select of the top K; each survivor's rank is the count
//   of larger survivors, and the key goes to slot rank (K^2 comparisons,
//   where ranking all the candidates would take (bands*K')^2); then K
//   threads gather wh/off through the strides,
//   apply exp or the >= 0 clamp, scale by the stride, and write boxes,
//   scores and indices in order, coalesced.
// tcf_decode launches both on the caller's stream. The plan (R, stage 1's
// block size, each stage's shared memory) comes from
// decode/fused_decode.py::plan_decode; it is derived again here, and a plan
// that does not match is refused with cudaErrorInvalidValue.
//
// Traps:
// - The max is taken over the sigmoids, not over the logits: expf is not
//   guaranteed monotone to the last bit, so two different logits can round
//   to one sigmoid, and then both cells are peaks in the plain version
//   (decode/reference.py::pseudo_nms) and in JAX; a max over logits would
//   drop one of them.
// - Each halo row is computed by two bands, with the same function, so both
//   get the same bits.
// - Zeros fill the list: a band with fewer than K' positive peaks, or a map
//   whose sigmoids all underflow to 0 (expf(-x) overflows for logits below
//   about -88.7), keeps its lowest-index zeros, as lax.top_k returns them.
// - The sigmoid is 1/(1+expf(-x)) with IEEE division and the accurate expf
//   (no --use_fast_math, no __expf): the arithmetic of torch.sigmoid on the
//   GPU, which the peak test (max == score, an exact comparison) relies on.
//
// hm, wh and off are read by pointer and element strides, so slices of the
// fused (B, H, W, 5) head tensor need no copy.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

typedef unsigned long long u64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBins = 256;
// scratch beside the arrays: histogram, two buffers of 32 per-warp counts, 8 words
constexpr int kFixedSmem = 4 * (kBins + 64 + 8);
constexpr long long kMaxSmem = 232448;
constexpr long long kMaxCandidates = 24000;
constexpr int kMergeThreads = 512;

struct Plane3 {
  const float* p;
  long long sb, sy, sx;
};

struct Plane4 {
  const float* p;
  long long sb, sy, sx, sc;
};

struct Scratch {
  unsigned* hist;        // kBins
  unsigned* warp_count;  // 2 x 32
  unsigned* vars;        // 0: positives, 1: output slots, 4-6: the select's state
};

__device__ __forceinline__ Scratch scratch_at(void* p) {
  unsigned* u = static_cast<unsigned*>(p);
  return {u, u + kBins, u + kBins + 64};
}

__device__ __forceinline__ float sigmoid_exact(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ u64 make_key(float v, unsigned flat) {
  return (static_cast<u64>(__float_as_uint(v)) << 32) | (0xFFFFFFFFu - flat);
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The slot of this thread in a list that `counter` fills, one atomic a warp;
// meaningful where `take`. Every lane of the warp calls it.
__device__ __forceinline__ unsigned append_slot(bool take, unsigned* counter) {
  const unsigned bal = __ballot_sync(kFull, take);
  unsigned base = 0;
  if ((threadIdx.x & 31) == 0 && bal) base = atomicAdd(counter, __popc(bal));
  return __shfl_sync(kFull, base, 0) + __popc(bal & lanes_below());
}

// The top k of n keys (1 <= k <= n, the k-th largest unique): on return
// exactly k keys have (key & mask) >= prefix. A radix select, 8 bits a pass
// from the top: a histogram of the next digit of the keys that match the
// prefix so far; warp 0 finds the bin that holds the k-th; it stops once the
// bin holds exactly the keys still wanted. All threads call it.
__device__ void radix_select(const u64* keys, int n, int k, const Scratch& s, u64& prefix, u64& mask) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  prefix = 0;
  mask = 0;
  unsigned want = k;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < kBins; i += nt) s.hist[i] = 0;
    __syncthreads();
    for (int i0 = 0; i0 < n; i0 += nt) {
      const int i = i0 + tid;
      const u64 key = i < n ? keys[i] : 0;
      const bool in = i < n && (key & mask) == prefix;
      const unsigned digit = static_cast<unsigned>(key >> shift) & 255u;
      const unsigned act = __ballot_sync(kFull, in);
      if (in) {
        const unsigned peers = __match_any_sync(act, digit);
        if (lane == __ffs(peers) - 1) atomicAdd(&s.hist[digit], __popc(peers));
      }
    }
    __syncthreads();
    if (tid < 32) {
      // lane l holds bins 255-8l down to 248-8l; a scan over the lanes counts
      // the keys in higher bins
      unsigned c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = s.hist[255 - 8 * lane - j];
        sum += c[j];
      }
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      unsigned above = incl - sum;
      if (above < want && want <= incl) {
        for (int j = 0; j < 8; ++j) {
          if (above + c[j] >= want) {
            s.vars[4] = 255 - 8 * lane - j;
            s.vars[5] = want - above;
            s.vars[6] = c[j];
            break;
          }
          above += c[j];
        }
      }
    }
    __syncthreads();
    want = s.vars[5];
    prefix |= static_cast<u64>(s.vars[4]) << shift;
    mask |= 255ull << shift;
    if (s.vars[6] == want) break;
  }
}

__global__ void __launch_bounds__(1024)
band_kernel(Plane3 hm, u64* __restrict__ cand, int H, int W, int R, int kb) {
  extern __shared__ u64 smem[];
  const int band = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int y0 = band * R;
  const int rows = min(R, H - y0);
  const int cells = rows * W;
  u64* keys = smem;                                     // R*W: keys of the positive peaks
  float* sig = reinterpret_cast<float*>(keys + R * W);  // (R+2)*W: sigmoids of rows y0-1 .. y0+R
  float* peak = sig + (R + 2) * W;                      // R*W: the peak value or +0
  const Scratch s = scratch_at(peak + R * W);
  if (tid < 8) s.vars[tid] = 0;

  const float* hmb = hm.p + b * hm.sb;
  for (int i = tid; i < (rows + 2) * W; i += nt) {
    const int r = i / W, x = i - r * W, y = y0 - 1 + r;
    sig[i] = (y >= 0 && y < H) ? sigmoid_exact(hmb[y * hm.sy + x * hm.sx]) : -INFINITY;
  }
  __syncthreads();
  for (int i0 = 0; i0 < cells; i0 += nt) {
    const int i = i0 + tid;
    float v = 0.f;
    if (i < cells) {
      const int x = i % W;
      const float* c = sig + W + i;
      const float sc = *c;
      float m = sc;
      for (int dy = -W; dy <= W; dy += W) {
        m = fmaxf(m, c[dy]);
        if (x > 0) m = fmaxf(m, c[dy - 1]);
        if (x + 1 < W) m = fmaxf(m, c[dy + 1]);
      }
      v = (m == sc) ? sc : 0.f;
      peak[i] = v;
    }
    const unsigned slot = append_slot(v > 0.f, &s.vars[0]);
    if (v > 0.f) keys[slot] = make_key(v, y0 * W + i);
  }
  __syncthreads();

  const int npos = s.vars[0];
  const int keep = min(kb, cells);
  u64* out = cand + (static_cast<long long>(b) * gridDim.x + band) * kb;
  if (npos > keep) {
    u64 prefix, mask;
    radix_select(keys, npos, keep, s, prefix, mask);
    for (int i0 = 0; i0 < npos; i0 += nt) {
      const int i = i0 + tid;
      const u64 key = i < npos ? keys[i] : 0;
      const bool take = i < npos && (key & mask) >= prefix;
      const unsigned slot = append_slot(take, &s.vars[1]);
      if (take) out[slot] = key;
    }
  } else {
    for (int i = tid; i < npos; i += nt) out[i] = keys[i];
    // the lowest-index zeros, in index order, until `keep` keys are kept
    // (there are cells - npos >= keep - npos of them)
    const int warp = tid >> 5, nwarps = nt >> 5;
    unsigned base = npos;
    for (int i0 = 0, turn = 0; base < static_cast<unsigned>(keep) && i0 < cells; i0 += nt, turn ^= 1) {
      const int i = i0 + tid;
      const bool zero = i < cells && peak[i] == 0.f;
      const unsigned bal = __ballot_sync(kFull, zero);
      unsigned* wc = s.warp_count + 32 * turn;
      if ((tid & 31) == 0) wc[warp] = __popc(bal);
      __syncthreads();
      unsigned before = 0, total = 0;
      for (int w = 0; w < nwarps; ++w) {
        const unsigned c = wc[w];
        total += c;
        if (w < warp) before += c;
      }
      const unsigned slot = base + before + __popc(bal & lanes_below());
      if (zero && slot < static_cast<unsigned>(keep)) out[slot] = make_key(0.f, y0 * W + i);
      base += total;
    }
  }
  for (int i = keep + tid; i < kb; i += nt) out[i] = 0;
}

__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const u64* __restrict__ cand, Plane4 wh, Plane4 off, float* __restrict__ boxes,
             float* __restrict__ scores, int* __restrict__ idx, int W, int n, int K, float stride,
             int wh_log) {
  extern __shared__ u64 smem[];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  u64* keys = smem;       // n: the candidates
  u64* surv = keys + n;   // K: the select's survivors
  u64* sorted = surv + K; // K: the top K in rank order
  const Scratch s = scratch_at(sorted + K);
  if (tid < 8) s.vars[tid] = 0;
  const u64* src = cand + static_cast<long long>(b) * n;
  for (int i = tid; i < n; i += nt) keys[i] = src[i];
  __syncthreads();

  // the top K (the empty slots' key 0 is never among them), then each one's
  // rank among them
  u64 prefix, mask;
  radix_select(keys, n, K, s, prefix, mask);
  for (int i0 = 0; i0 < n; i0 += nt) {
    const int i = i0 + tid;
    const u64 key = i < n ? keys[i] : 0;
    const bool take = i < n && (key & mask) >= prefix;
    const unsigned slot = append_slot(take, &s.vars[1]);
    if (take) surv[slot] = key;
  }
  __syncthreads();
  for (int i = tid; i < K; i += nt) {
    const u64 key = surv[i];
    int rank = 0;
    for (int j = 0; j < K; ++j) rank += surv[j] > key;
    sorted[rank] = key;
  }
  __syncthreads();

  for (int i = tid; i < K; i += nt) {
    const u64 key = sorted[i];
    const int flat = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key));
    const int r = flat / W, c = flat - r * W;
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
    reinterpret_cast<float4*>(boxes)[o] = make_float4(
        (cx - bw * 0.5f) * stride, (cy - bh * 0.5f) * stride, (cx + bw * 0.5f) * stride,
        (cy + bh * 0.5f) * stride);
    scores[o] = __uint_as_float(static_cast<unsigned>(key >> 32));
    idx[o] = flat;
  }
}

cudaError_t allow_smem(const void* kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

}  // namespace

// Launches both stages on `stream`; returns a cudaError_t as an int:
// cudaErrorInvalidValue where the plan (rows, bands, kb, stage 1's block
// size, each stage's shared memory) is not the one the sizes give (decode/fused_decode.py::plan_decode), else cudaGetLastError().
// Pointers are device pointers, strides in elements; `cand` holds B*bands*kb
// 64-bit keys, `boxes` is 16-byte aligned.
extern "C" int tcf_decode(
    const float* hm, long long hm_sb, long long hm_sy, long long hm_sx,
    const float* wh, long long wh_sb, long long wh_sy, long long wh_sx, long long wh_sc,
    const float* off, long long off_sb, long long off_sy, long long off_sx, long long off_sc,
    u64* cand, float* boxes, float* scores, int* idx,
    int B, int H, int W, int K, float stride, int wh_log,
    int rows, int bands, int kb, int threads, int band_smem, int merge_smem, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1) return cudaErrorInvalidValue;
  const long long cells = static_cast<long long>(H) * W;
  if (cells >= (1ll << 31) || K < 1 || K > cells) return cudaErrorInvalidValue;
  if (rows < 1 || rows > H || bands != (H + rows - 1) / rows) return cudaErrorInvalidValue;
  if (kb != static_cast<int>(std::min<long long>(K, static_cast<long long>(rows) * W))) return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(bands) * kb;
  const long long s1 = 16ll * rows * W + 8ll * W + kFixedSmem;
  const long long s2 = 8 * n + 16ll * K + kFixedSmem;
  if (n > kMaxCandidates || s1 > kMaxSmem || s2 > kMaxSmem || band_smem != s1 || merge_smem != s2 ||
      threads < 64 || threads > 1024 || threads % 32) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(band_kernel), s1);
  if (e == cudaSuccess) e = allow_smem(reinterpret_cast<const void*>(merge_kernel), s2);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plane3 hmp{hm, hm_sb, hm_sy, hm_sx};
  const Plane4 whp{wh, wh_sb, wh_sy, wh_sx, wh_sc};
  const Plane4 offp{off, off_sb, off_sy, off_sx, off_sc};
  band_kernel<<<dim3(bands, B), threads, band_smem, st>>>(hmp, cand, H, W, rows, kb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  merge_kernel<<<B, kMergeThreads, merge_smem, st>>>(cand, whp, offp, boxes, scores, idx, W,
                                                      static_cast<int>(n), K, stride, wh_log);
  return static_cast<int>(cudaGetLastError());
}
