// The stride-2 int8 MobileNetV2 block (B6) in one kernel, NHWC, for Hopper
// (sm_90a).
//
// Replaces make_fused_block_kernel of tpucenterface/bench/probe_fused_block.py:
// x (B, H, W, Cin) int8 -> out (B, Ho, Wo, Cout) int8, Ho = (H - 1) / 2 + 1.
// With per-channel float32 vectors (the JAX kernel's operands, channel-major):
//   e  = clip(rint(clip(acc_e * e_scale + e_bias, 0, 6) * e_inv), -127, 127)
//        acc_e = sum_k x[k] * we[c, k]                       1x1 expand
//   d  = clip(rint(clip(acc_d * d_scale + d_bias, 0, 6) * d_inv), -127, 127)
//        acc_d = sum of the nine taps e * wd[tap, c]         3x3 depthwise, stride 2
//   out = clip(rint(acc_p * p_scale + p_bias), -127, 127), acc_p = sum_c d[c] * wp[o, c]
// e is zero at the map's padding positions. Every product and every sum is
// rounded on its own (__fmul_rn, __fadd_rn; nvcc would contract them into
// FMAs, which the JAX function does not do); rint rounds half to even. The
// depthwise taps are integers, so the JAX kernel's float32 multiply-adds are
// exact (|9 * 127 * 127| < 2^24) and equal the int32 sums taken here.
// The stride-1 block (B7) has its own kernel, csrc/int8_block_s1.cu.
//
// Design (that of csrc/mbconv.cu, the bf16 block): one thread block (8 warps)
// per tile of 16 output columns by 8 output rows of one image. The halo'd
// input tile (17x33 positions) sits in shared memory as int8 for the whole
// block. The expanded channels are walked in chunks of CK (32 or 64):
//   load    the chunk's expand and project weights, depthwise taps, vectors;
//   stage A expand every halo position for the chunk with mma.sync.m16n8k32
//           (s8 x s8 -> s32), requantize to int8, zero the positions outside
//           the image, store in shared memory;
//   stage B each warp owns one output row (a 16-position M tile); a thread
//           computes the depthwise for exactly the (position, channel) pairs
//           of its A fragments of the project product, with __dp4a on one
//           byte lane of the taps at a time, requantizes, and packs them
//           straight into
//   stage C the project mma, whose int32 sums (16 positions x up to 96
//           output channels per M tile) stay in registers across all chunks.
// The int8 expanded and depthwise activations never leave the SM. Output
// channels past 96 run as further groups in grid.z, each recomputing stages A
// and B. Channels past the ends are zero in shared memory (zero weights and
// vectors give e = 0 and d = 0); ragged tile edges are masked on store.
//
// Bound on an H100 SXM: bytes at three of the model's four shapes, the int8
// operations at the widest (block 13). The block reads x once and writes out
// once against 2*(Cin*Ce + 9*Ce/4 + Ce*Cout/4) operations per input position,
// all on int8 operands; this version is held back by the halo, by the byte-lane
// depthwise (about two instructions a multiply-add) and by one resident block
// per SM at the wide shapes. It is on no path of the port.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;   // bytes a block may use on sm_90

struct Params {
  const int8_t* x;            // (B, H, W, Cin)
  const int8_t* we;           // (Cmid, Cin)
  const float* e_scale;       // (Cmid), and the five vectors below
  const float* e_bias;
  const float* e_inv;
  const int8_t* wd;           // (9, Cmid), tap-major
  const float* d_scale;
  const float* d_bias;
  const float* d_inv;
  const int8_t* wp;           // (Cout, Cmid)
  const float* p_scale;       // (Cout)
  const float* p_bias;
  int8_t* out;                // (B, Ho, Wo, Cout)
  int B, H, W, Ho, Wo, Cin, Cmid, Cout;
  int cin_pad;                // Cin rounded up to 32
  int groups;                 // output-channel groups in grid.z
};

template <int S>
struct Tile {
  static constexpr int OH = 16 / S;                 // output rows
  static constexpr int OW = 16;                     // output columns
  static constexpr int IH = (OH - 1) * S + 3;       // halo'd input rows
  static constexpr int IW = (OW - 1) * S + 3;
  static constexpr int NPOS = IH * IW;              // 561 at stride 2
  static constexpr int MT = OH / kWarps;            // output rows (M tiles) per warp
  static constexpr int HALO_MT = (NPOS + 15) / 16;
};

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D (16x8, s32) += A (16x32, s8, row-major) * B (32x8, s8, column-major)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int clip127(float v) {
  return static_cast<int>(fminf(fmaxf(rintf(v), -127.f), 127.f));
}

// clip(rint(clip(acc * s + b, 0, 6) * inv), -127, 127)
__device__ __forceinline__ int requant6(int acc, float s, float b, float inv) {
  const float y = fminf(fmaxf(__fadd_rn(__fmul_rn(static_cast<float>(acc), s), b), 0.f), 6.f);
  return clip127(__fmul_rn(y, inv));
}

__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return (static_cast<uint32_t>(lo) & 0xffu) | ((static_cast<uint32_t>(hi) & 0xffu) << 8);
}

template <int S, int CK, int NT>
__host__ __device__ constexpr size_t smem_bytes(int cin_pad) {
  return static_cast<size_t>(Tile<S>::NPOS + CK) * (cin_pad + 16) +
         static_cast<size_t>(Tile<S>::NPOS + NT * 8) * (CK + 16) + 6 * CK * 4 + 9 * CK;
}

// Shared memory, in this order (row strides in bytes; the +16 keeps the
// 32-bit fragment loads of eight consecutive rows on distinct banks):
//   xs  [NPOS][cin_pad + 16]  input tile with halo, int8, zero outside the image and in the K padding
//   es  [NPOS][CK + 16]       expanded chunk, int8
//   w1s [CK][cin_pad + 16]    expand weights of the chunk (channel, k)
//   w2s [NT * 8][CK + 16]     project weights of the chunk (output channel, k)
//   vs  [6][CK] f32           e_scale, e_bias, e_inv, d_scale, d_bias, d_inv
//   wds [9][CK] int8          depthwise taps
template <int S, int CK, int NT>
__global__ void __launch_bounds__(kThreads, Tile<S>::MT * NT <= 12 ? 2 : 1)
int8_block_kernel(const Params p) {
  using T = Tile<S>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int XS = p.cin_pad + 16;
  constexpr int ES = CK + 16;
  int8_t* xs = reinterpret_cast<int8_t*>(smem);
  int8_t* es = xs + T::NPOS * XS;
  int8_t* w1s = es + T::NPOS * ES;
  int8_t* w2s = w1s + CK * XS;
  float* vs = reinterpret_cast<float*>(w2s + NT * 8 * ES);
  int8_t* wds = reinterpret_cast<int8_t*>(vs + 6 * CK);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int img = blockIdx.z / p.groups;
  const int co0 = (blockIdx.z % p.groups) * (NT * 8);
  const int co_n = min(p.Cout - co0, NT * 8);
  const int nt_used = (co_n + 7) / 8;
  const int oy0 = blockIdx.y * T::OH;
  const int ox0 = blockIdx.x * T::OW;
  const int iy0 = oy0 * S - 1;
  const int ix0 = ox0 * S - 1;
  const int H = p.H, W = p.W, Cin = p.Cin, Cmid = p.Cmid, Cout = p.Cout;

  // ---- input tile with halo, eight channels a load ---------------------------
  {
    const int segs = p.cin_pad / 8;
    for (int i = tid; i < T::NPOS * segs; i += kThreads) {
      const int pos = i / segs;
      const int seg = i - pos * segs;
      const int hy = pos / T::IW;
      const int gy = iy0 + hy;
      const int gx = ix0 + (pos - hy * T::IW);
      uint2 v = make_uint2(0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && seg * 8 < Cin) {
        const size_t off = ((static_cast<size_t>(img) * H + gy) * W + gx) * Cin + seg * 8;
        v = *reinterpret_cast<const uint2*>(p.x + off);
      }
      *reinterpret_cast<uint2*>(xs + pos * XS + seg * 8) = v;
    }
  }

  int acc[T::MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0;

  for (int ce0 = 0; ce0 < Cmid; ce0 += CK) {
    __syncthreads();  // the previous chunk's readers are done (and xs is written)

    // ---- this chunk's weights, vectors and taps --------------------------------
    for (int i = tid; i < CK * p.cin_pad; i += kThreads) {
      const int n = i / p.cin_pad;
      const int k = i - n * p.cin_pad;
      int8_t v = 0;
      if (k < Cin && ce0 + n < Cmid) v = p.we[static_cast<size_t>(ce0 + n) * Cin + k];
      w1s[n * XS + k] = v;
    }
    for (int i = tid; i < NT * 8 * CK; i += kThreads) {
      const int n = i / CK;
      const int k = i - n * CK;
      int8_t v = 0;
      if (n < co_n && ce0 + k < Cmid) v = p.wp[static_cast<size_t>(co0 + n) * Cmid + ce0 + k];
      w2s[n * ES + k] = v;
    }
    for (int i = tid; i < 15 * CK; i += kThreads) {
      const int row = i / CK;
      const int c = i - row * CK;
      const bool in = ce0 + c < Cmid;
      if (row < 6) {
        const float* src = row == 0 ? p.e_scale : row == 1 ? p.e_bias : row == 2 ? p.e_inv
                         : row == 3 ? p.d_scale : row == 4 ? p.d_bias : p.d_inv;
        vs[i] = in ? src[ce0 + c] : 0.f;
      } else {
        wds[i - 6 * CK] = in ? p.wd[static_cast<size_t>(row - 6) * Cmid + ce0 + c] : static_cast<int8_t>(0);
      }
    }
    __syncthreads();

    // ---- stage A: expand every halo position for this chunk -------------------
    {
      const int ksteps = p.cin_pad / 32;
      for (int mt = warp; mt < T::HALO_MT; mt += kWarps) {
        int ea[CK / 8][4];
#pragma unroll
        for (int nt = 0; nt < CK / 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) ea[nt][j] = 0;
        const int r0 = mt * 16 + g;
        const int r1 = r0 + 8;
        // rows past the last halo position read the last one; never stored
        const int8_t* xa0 = xs + min(r0, T::NPOS - 1) * XS + 4 * tig;
        const int8_t* xa1 = xs + min(r1, T::NPOS - 1) * XS + 4 * tig;
        const int8_t* wb = w1s + g * XS + 4 * tig;
        for (int ks = 0; ks < ksteps; ++ks) {
          const uint32_t a[4] = {lds32(xa0 + ks * 32), lds32(xa1 + ks * 32), lds32(xa0 + ks * 32 + 16),
                                 lds32(xa1 + ks * 32 + 16)};
#pragma unroll
          for (int nt = 0; nt < CK / 8; ++nt) {
            const int8_t* w = wb + nt * 8 * XS + ks * 32;
            mma_s8(ea[nt], a, lds32(w), lds32(w + 16));
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = half ? r1 : r0;
          if (r >= T::NPOS) continue;
          const int hy = r / T::IW;
          const int gy = iy0 + hy;
          const int gx = ix0 + (r - hy * T::IW);
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int nt = 0; nt < CK / 8; ++nt) {
            const int c = nt * 8 + 2 * tig;
            uint32_t v = 0u;
            if (inside) {
              v = pack2(requant6(ea[nt][2 * half], vs[c], vs[CK + c], vs[2 * CK + c]),
                        requant6(ea[nt][2 * half + 1], vs[c + 1], vs[CK + c + 1], vs[2 * CK + c + 1]));
            }
            *reinterpret_cast<uint16_t*>(es + r * ES + c) = static_cast<uint16_t>(v);
          }
        }
      }
    }
    __syncthreads();

    // ---- stages B and C: depthwise into the project's A fragments -------------
#pragma unroll 1
    for (int ks = 0; ks < CK / 32; ++ks) {
      uint32_t bw[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < nt_used) {
          const int8_t* w = w2s + (nt * 8 + g) * ES + ks * 32 + 4 * tig;
          bw[nt][0] = lds32(w);
          bw[nt][1] = lds32(w + 16);
        }
      }
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        const int oy = warp * T::MT + mt;   // output row of the tile = M tile
        uint32_t a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // channels c..c+3 at output columns g and g+8: a[2h] and a[2h+1]
          const int c = ks * 32 + 16 * h + 4 * tig;
          int s0[4] = {0, 0, 0, 0}, s1[4] = {0, 0, 0, 0};
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const uint32_t tw = lds32(wds + (dy * 3 + dx) * CK + c);
              const int8_t* row = es + ((oy * S + dy) * T::IW + dx) * ES + c;
              const int e0 = static_cast<int>(lds32(row + g * S * ES));
              const int e1 = static_cast<int>(lds32(row + (g + 8) * S * ES));
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int m = static_cast<int>(tw & (0xffu << (8 * j)));   // tap j alone in its byte lane
                s0[j] = __dp4a(e0, m, s0[j]);
                s1[j] = __dp4a(e1, m, s1[j]);
              }
            }
          }
          uint32_t q0 = 0u, q1 = 0u;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float ds = vs[3 * CK + c + j], db = vs[4 * CK + c + j], di = vs[5 * CK + c + j];
            q0 |= (static_cast<uint32_t>(requant6(s0[j], ds, db, di)) & 0xffu) << (8 * j);
            q1 |= (static_cast<uint32_t>(requant6(s1[j], ds, db, di)) & 0xffu) << (8 * j);
          }
          a[2 * h] = q0;
          a[2 * h + 1] = q1;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt < nt_used) mma_s8(acc[mt][nt], a, bw[nt][0], bw[nt][1]);
        }
      }
    }
  }

  // ---- epilogue: scale + bias, round, masked store -----------------------------
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
    const int gy = oy0 + warp * T::MT + mt;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gx = ox0 + g + 8 * half;
      if (gy >= p.Ho || gx >= p.Wo) continue;
      const size_t pix = (static_cast<size_t>(img) * p.Ho + gy) * p.Wo + gx;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = co0 + nt * 8 + 2 * tig;
        if (nt >= nt_used || c >= Cout) continue;
        const float v0 = __fadd_rn(__fmul_rn(static_cast<float>(acc[mt][nt][2 * half]), p.p_scale[c]), p.p_bias[c]);
        const float v1 = __fadd_rn(__fmul_rn(static_cast<float>(acc[mt][nt][2 * half + 1]), p.p_scale[c + 1]),
                                   p.p_bias[c + 1]);
        *reinterpret_cast<uint16_t*>(p.out + pix * Cout + c) = static_cast<uint16_t>(pack2(clip127(v0), clip127(v1)));
      }
    }
  }
}

template <int S, int CK, int NT>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<S, CK, NT>(p.cin_pad);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      int8_block_kernel<S, CK, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.Wo + Tile<S>::OW - 1) / Tile<S>::OW, (p.Ho + Tile<S>::OH - 1) / Tile<S>::OH, p.B * p.groups);
  int8_block_kernel<S, CK, NT><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int S, int NT>
int launch_ck(const Params& p, cudaStream_t stream) {
  // the chunk width that pads Cmid least; the wider one on a tie
  const int pad64 = (p.Cmid + 63) / 64 * 64;
  const int pad32 = (p.Cmid + 31) / 32 * 32;
  return pad64 <= pad32 ? launch<S, 64, NT>(p, stream) : launch<S, 32, NT>(p, stream);
}

template <int S>
int launch_groups(Params& p, cudaStream_t stream) {
  if (p.Cout <= 32) {
    p.groups = 1;
    return launch_ck<S, 4>(p, stream);
  }
  p.groups = (p.Cout + 95) / 96;
  return launch_ck<S, 12>(p, stream);
}

}  // namespace

// Launches the stride-2 block on `stream`; returns cudaGetLastError() as an
// int. x (B,H,W,Cin) int8 contiguous, 8-byte aligned; out (B,Ho,Wo,Cout) int8,
// Ho = (H-1)/2 + 1; weights and vectors as in Params, contiguous; Cin and Cout
// multiples of 8.
extern "C" int tcf_int8_block(
    const void* x, const void* we, const void* e_scale, const void* e_bias, const void* e_inv, const void* wd,
    const void* d_scale, const void* d_bias, const void* d_inv, const void* wp, const void* p_scale,
    const void* p_bias, void* out, int B, int H, int W, int Cin, int Cmid, int Cout, void* stream) {
  const long long blocks_z = static_cast<long long>(B) * (Cout <= 32 ? 1 : (Cout + 95) / 96);
  if (B < 1 || H < 1 || W < 1 || Cin < 8 || Cin % 8 || Cmid < 1 || Cout < 8 || Cout % 8 || blocks_z > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.we = static_cast<const int8_t*>(we);
  p.e_scale = static_cast<const float*>(e_scale);
  p.e_bias = static_cast<const float*>(e_bias);
  p.e_inv = static_cast<const float*>(e_inv);
  p.wd = static_cast<const int8_t*>(wd);
  p.d_scale = static_cast<const float*>(d_scale);
  p.d_bias = static_cast<const float*>(d_bias);
  p.d_inv = static_cast<const float*>(d_inv);
  p.wp = static_cast<const int8_t*>(wp);
  p.p_scale = static_cast<const float*>(p_scale);
  p.p_bias = static_cast<const float*>(p_bias);
  p.out = static_cast<int8_t*>(out);
  p.B = B; p.H = H; p.W = W;
  p.Ho = (H - 1) / 2 + 1;
  p.Wo = (W - 1) / 2 + 1;
  p.Cin = Cin; p.Cmid = Cmid; p.Cout = Cout;
  p.cin_pad = (Cin + 31) / 32 * 32;
  return launch_groups<2>(p, static_cast<cudaStream_t>(stream));
}
