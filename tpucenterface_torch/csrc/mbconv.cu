// Fused MobileNetV2 inverted-residual block (stride 1) for Hopper (sm_90a).
//
// Replaces the TPU kernel tpucenterface/ops/fused_mbconv.py::fused_mbconv
// (kernel _kernel). For x (B, H, W, Cin) bf16, NHWC:
//   e = bf16(act(x @ w1 + b1))         1x1 expand (skipped when the block has none)
//   e = 0 at the image's zero-pad positions (not act(b1))
//   d = bf16(act(sum_{dy,dx} e[y+dy-1, x+dx-1] * wd[dy, dx] + bd))   3x3 depthwise
//   out = bf16(d @ w2 + b2 [+ x])      1x1 project, optional skip
// with float32 sums; the expanded tensor e never reaches device memory.
//
// Design: one thread block (8 warps) per 16x16 tile of output positions of one
// image. The 18x18 halo'd input tile sits in shared memory for the whole
// block. The expanded channels are walked in chunks of CK (32, 48 or 64):
//   load    the chunk's w1 columns, w2 rows, depthwise taps and biases;
//   stage A expand the 324 halo positions for the chunk's channels with
//           mma.sync.m16n8k16 (bf16 x bf16 -> f32), add b1, activate, zero the
//           positions outside the image, store as bf16 in shared memory;
//   stage B each warp owns two output rows (two 16-position M tiles); a thread
//           computes the depthwise for exactly the (position, channel) pairs
//           that form its A fragments of the next product, so the depthwise
//           result goes from registers straight into
//   stage C the project mma, whose f32 accumulators (16x16 positions x up to
//           96 output channels) stay in registers across all chunks.
// Neighbouring tiles recompute each other's halo in stage A; that is the
// price of keeping e on chip. Output channels beyond 96 run as further
// groups in grid.z, each recomputing stages A and B.
// K that is not a multiple of 16 (Cin = 24) and ragged channel chunks are
// padded with zeros in shared memory; ragged tile edges are masked on store.
//
// Bound on an H100 SXM: the block reads x once and writes out once,
// B*H*W*(Cin+Cout)*2 bytes, against 2*B*H*W*(Cin*Ce + 9*Ce + Ce*Cout)
// operations; at the model's shapes the depthwise term on the float32 pipes
// and the bytes are of the same order, and both far below what this first
// version takes: it is held back by shared-memory loads in stage B (one
// 32-bit load per two multiply-adds), by one resident block per SM at the wide
// shapes, and by the tail of 16x16 tiles on 40x40 maps. wgmma, TMA and a
// pipelined weight load are later work.
//
// Not bit-equal to a float32 matrix product of the same bf16 operands: the
// tensor cores sum in another order, so a value next to a bf16 rounding
// boundary can land one bf16 step away.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;                   // output positions per tile side
constexpr int kHalo = kTile + 2;
constexpr int kHaloPos = kHalo * kHalo;     // 324
constexpr int kHaloMTiles = (kHaloPos + 15) / 16;
constexpr int kMaxSmem = 232448;            // bytes a block may use on sm_90

struct Params {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w1;   // (Cin, Ce) or null
  const __nv_bfloat16* b1;   // (Ce) or null
  const __nv_bfloat16* wd;   // (3, 3, Ce)
  const __nv_bfloat16* bd;   // (Ce)
  const __nv_bfloat16* w2;   // (Ce, Cout)
  const __nv_bfloat16* b2;   // (Cout)
  __nv_bfloat16* out;
  int B, H, W, Cin, Ce, Cout;
  int cin_pad;               // Cin rounded up to 16
  int groups;                // output-channel groups in grid.z
  int has_expand, has_skip, relu6;
};

__device__ __forceinline__ float act(float v, int relu6) {
  v = fmaxf(v, 0.f);
  return relu6 ? fminf(v, 6.f) : v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D (16x8, f32) += A (16x16, bf16, row-major) * B (16x8, bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory, in this order (row strides in bf16 elements; the +8 keeps
// the 32-bit fragment loads of eight consecutive rows on distinct banks):
//   xs  [kHaloPos][cin_pad + 8]   input tile with halo, zero outside the image
//   es  [kHaloPos][CK + 8]        expanded chunk
//   w1s [CK][cin_pad + 8]         w1 chunk, transposed (expanded channel major)
//   w2s [NT * 8][CK + 8]          w2 chunk, transposed (output channel major)
//   wds [9][CK] f32, b1s [CK] f32, bds [CK] f32
template <int CK, int NT>
__host__ __device__ constexpr size_t smem_bytes(int cin_pad) {
  return static_cast<size_t>(kHaloPos + CK) * (cin_pad + 8) * 2 +
         static_cast<size_t>(kHaloPos + NT * 8) * (CK + 8) * 2 + 11 * CK * 4;
}

template <int CK, int NT>
__global__ void __launch_bounds__(kThreads, NT <= 4 ? 2 : 1)
mbconv_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int XS = p.cin_pad + 8;
  constexpr int ES = CK + 8;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* es = xs + kHaloPos * XS;
  __nv_bfloat16* w1s = es + kHaloPos * ES;
  __nv_bfloat16* w2s = w1s + CK * XS;
  float* wds = reinterpret_cast<float*>(w2s + NT * 8 * ES);
  float* b1s = wds + 9 * CK;
  float* bds = b1s + CK;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;     // fragment row group
  const int tig = lane & 3;    // thread in group
  const int img = blockIdx.z / p.groups;
  const int co0 = (blockIdx.z % p.groups) * (NT * 8);   // first output channel
  const int co_n = min(p.Cout - co0, NT * 8);            // output channels here
  const int nt_used = (co_n + 7) / 8;
  const int ty0 = blockIdx.y * kTile;
  const int tx0 = blockIdx.x * kTile;
  const int H = p.H, W = p.W, Cin = p.Cin, Ce = p.Ce, Cout = p.Cout;
  const int relu6 = p.relu6;

  // ---- input tile with halo: 16-byte loads, zeros outside the image and in
  // the K padding --------------------------------------------------------------
  {
    const int segs = p.cin_pad / 8;
    const __nv_bfloat16* xb = p.x + static_cast<size_t>(img) * H * W * Cin;
    for (int i = tid; i < kHaloPos * segs; i += kThreads) {
      const int pos = i / segs;
      const int seg = i - pos * segs;
      const int hy = pos / kHalo;
      const int gy = ty0 - 1 + hy;
      const int gx = tx0 - 1 + (pos - hy * kHalo);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && seg * 8 < Cin) {
        v = *reinterpret_cast<const uint4*>(xb + (static_cast<size_t>(gy) * W + gx) * Cin + seg * 8);
      }
      *reinterpret_cast<uint4*>(xs + pos * XS + seg * 8) = v;
    }
  }

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  for (int ce0 = 0; ce0 < Ce; ce0 += CK) {
    __syncthreads();  // the previous chunk's readers are done (and xs is written)

    // ---- this chunk's weights ------------------------------------------------
    if (p.has_expand) {
      for (int i = tid; i < CK * p.cin_pad; i += kThreads) {
        const int k = i / CK;
        const int n = i - k * CK;
        __nv_bfloat16 v = __float2bfloat16_rn(0.f);
        if (k < Cin && ce0 + n < Ce) v = p.w1[static_cast<size_t>(k) * Ce + ce0 + n];
        w1s[n * XS + k] = v;
      }
    }
    for (int i = tid; i < NT * 8 * CK; i += kThreads) {
      const int k = i / (NT * 8);
      const int n = i - k * (NT * 8);
      __nv_bfloat16 v = __float2bfloat16_rn(0.f);
      if (ce0 + k < Ce && n < co_n) v = p.w2[static_cast<size_t>(ce0 + k) * Cout + co0 + n];
      w2s[n * ES + k] = v;
    }
    for (int i = tid; i < 11 * CK; i += kThreads) {
      const int row = i / CK;   // 0..8 depthwise taps, 9 b1, 10 bd
      const int c = i - row * CK;
      float v = 0.f;
      if (ce0 + c < Ce) {
        if (row < 9) v = __bfloat162float(p.wd[row * Ce + ce0 + c]);
        else if (row == 9) v = p.has_expand ? __bfloat162float(p.b1[ce0 + c]) : 0.f;
        else v = __bfloat162float(p.bd[ce0 + c]);
      }
      wds[i] = v;   // b1s and bds follow wds
    }
    __syncthreads();

    // ---- stage A: expand the halo'd tile for this chunk ---------------------
    if (p.has_expand) {
      const int ksteps = p.cin_pad / 16;
      for (int mt = warp; mt < kHaloMTiles; mt += kWarps) {
        float ea[CK / 8][4];
#pragma unroll
        for (int nt = 0; nt < CK / 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) ea[nt][j] = 0.f;
        const int r0 = mt * 16 + g;
        const int r1 = r0 + 8;
        // rows past the last halo position read the last one; never stored
        const __nv_bfloat16* xa0 = xs + min(r0, kHaloPos - 1) * XS + 2 * tig;
        const __nv_bfloat16* xa1 = xs + min(r1, kHaloPos - 1) * XS + 2 * tig;
        const __nv_bfloat16* wb = w1s + g * XS + 2 * tig;
        for (int ks = 0; ks < ksteps; ++ks) {
          uint32_t a[4];
          a[0] = lds32(xa0 + ks * 16);
          a[1] = lds32(xa1 + ks * 16);
          a[2] = lds32(xa0 + ks * 16 + 8);
          a[3] = lds32(xa1 + ks * 16 + 8);
#pragma unroll
          for (int nt = 0; nt < CK / 8; ++nt) {
            const __nv_bfloat16* w = wb + nt * 8 * XS + ks * 16;
            mma_bf16(ea[nt], a, lds32(w), lds32(w + 8));
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = half ? r1 : r0;
          if (r >= kHaloPos) continue;
          const int hy = r / kHalo;
          const int gy = ty0 - 1 + hy;
          const int gx = tx0 - 1 + (r - hy * kHalo);
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int nt = 0; nt < CK / 8; ++nt) {
            const int c = nt * 8 + 2 * tig;
            uint32_t v = 0u;
            if (inside) {
              v = pack_bf16(act(ea[nt][2 * half] + b1s[c], relu6),
                            act(ea[nt][2 * half + 1] + b1s[c + 1], relu6));
            }
            *reinterpret_cast<uint32_t*>(es + r * ES + c) = v;
          }
        }
      }
    } else {
      // no expand: the chunk is the input's own channels
      for (int i = tid; i < kHaloPos * (CK / 2); i += kThreads) {
        const int pos = i / (CK / 2);
        const int c = (i - pos * (CK / 2)) * 2;
        uint32_t v = 0u;
        if (ce0 + c < Ce) v = lds32(xs + pos * XS + ce0 + c);
        *reinterpret_cast<uint32_t*>(es + pos * ES + c) = v;
      }
    }
    __syncthreads();

    // ---- stages B and C: depthwise into the project's A fragments ----------
#pragma unroll 1
    for (int ks = 0; ks < CK / 16; ++ks) {
      const int c0 = ks * 16 + 2 * tig;   // this thread's channels: c0, c0+1, c0+8, c0+9
      float2 tap[2][9], bias[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int t = 0; t < 9; ++t) tap[h][t] = *reinterpret_cast<const float2*>(wds + t * CK + c0 + 8 * h);
        bias[h] = *reinterpret_cast<const float2*>(bds + c0 + 8 * h);
      }
      uint32_t bw[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < nt_used) {
          const __nv_bfloat16* w = w2s + (nt * 8 + g) * ES + ks * 16 + 2 * tig;
          bw[nt][0] = lds32(w);
          bw[nt][1] = lds32(w + 8);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int y = warp * 2 + mt;   // output row of the tile = M tile
        uint32_t a[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // a0: (x=g, c0), a1: (x=g+8, c0), a2: (x=g, c0+8), a3: (x=g+8, c0+8)
          const int x = g + 8 * (j & 1);
          const int h = j >> 1;
          const __nv_bfloat16* e = es + (y * kHalo + x) * ES + c0 + 8 * h;
          float2 s = make_float2(0.f, 0.f);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const float2 v = unpack_bf16(lds32(e + (dy * kHalo + dx) * ES));
              s.x = fmaf(v.x, tap[h][dy * 3 + dx].x, s.x);
              s.y = fmaf(v.y, tap[h][dy * 3 + dx].y, s.y);
            }
          }
          a[j] = pack_bf16(act(s.x + bias[h].x, relu6), act(s.y + bias[h].y, relu6));
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt < nt_used) mma_bf16(acc[mt][nt], a, bw[nt][0], bw[nt][1]);
        }
      }
    }
  }

  // ---- epilogue: + b2 [+ skip], round to bf16, masked store ------------------
  __nv_bfloat16* ob = p.out + static_cast<size_t>(img) * H * W * Cout;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int y = warp * 2 + mt;
    const int gy = ty0 + y;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int x = g + 8 * half;
      const int gx = tx0 + x;
      if (gy >= H || gx >= W) continue;
      const __nv_bfloat16* xc = xs + ((y + 1) * kHalo + x + 1) * XS;
      __nv_bfloat16* o = ob + (static_cast<size_t>(gy) * W + gx) * Cout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = co0 + nt * 8 + 2 * tig;
        if (nt < nt_used && c < Cout) {
          float v0 = acc[mt][nt][2 * half] + __bfloat162float(p.b2[c]);
          float v1 = acc[mt][nt][2 * half + 1] + __bfloat162float(p.b2[c + 1]);
          if (p.has_skip) {
            const float2 s = unpack_bf16(lds32(xc + c));
            v0 += s.x;
            v1 += s.y;
          }
          *reinterpret_cast<uint32_t*>(o + c) = pack_bf16(v0, v1);
        }
      }
    }
  }
}

template <int CK, int NT>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<CK, NT>(p.cin_pad);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      mbconv_kernel<CK, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.W + kTile - 1) / kTile, (p.H + kTile - 1) / kTile, p.B * p.groups);
  mbconv_kernel<CK, NT><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_ck(const Params& p, cudaStream_t stream) {
  // the chunk width that pads Ce least; the wider one on a tie
  int best = 0, padded = 0;
  const int widths[3] = {64, 48, 32};
  for (int i = 0; i < 3; ++i) {
    const int pad = (p.Ce + widths[i] - 1) / widths[i] * widths[i];
    if (best == 0 || pad < padded) { best = widths[i]; padded = pad; }
  }
  if (best == 64) return launch<64, NT>(p, stream);
  if (best == 48) return launch<48, NT>(p, stream);
  return launch<32, NT>(p, stream);
}

}  // namespace

// Launches the block on `stream`; returns cudaGetLastError() as an int.
// x (B,H,W,Cin), out (B,H,W,Cout), weights as in Params, all bf16, contiguous,
// x 16-byte aligned; Cin, Ce, Cout multiples of 8; w1 and b1 null without an
// expand (then Ce == Cin); the skip needs Cin == Cout.
extern "C" int tcf_mbconv(
    const void* x, const void* w1, const void* b1, const void* wd, const void* bd,
    const void* w2, const void* b2, void* out,
    int B, int H, int W, int Cin, int Ce, int Cout,
    int has_expand, int has_skip, int relu6, void* stream) {
  const long long blocks_z = static_cast<long long>(B) * (Cout <= 32 ? 1 : (Cout + 95) / 96);
  if (B < 1 || H < 1 || W < 1 || blocks_z > 65535 || Cin % 8 || Ce % 8 || Cout % 8 || Cin < 8 || Ce < 8 || Cout < 8 ||
      (has_expand && (!w1 || !b1)) || (!has_expand && Ce != Cin) || (has_skip && Cin != Cout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w1 = static_cast<const __nv_bfloat16*>(w1);
  p.b1 = static_cast<const __nv_bfloat16*>(b1);
  p.wd = static_cast<const __nv_bfloat16*>(wd);
  p.bd = static_cast<const __nv_bfloat16*>(bd);
  p.w2 = static_cast<const __nv_bfloat16*>(w2);
  p.b2 = static_cast<const __nv_bfloat16*>(b2);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = B; p.H = H; p.W = W; p.Cin = Cin; p.Ce = Ce; p.Cout = Cout;
  p.cin_pad = (Cin + 15) / 16 * 16;
  p.has_expand = has_expand; p.has_skip = has_skip; p.relu6 = relu6;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cout <= 32) {
    p.groups = 1;
    return launch_ck<4>(p, s);
  }
  p.groups = (Cout + 95) / 96;
  return launch_ck<12>(p, s);
}
