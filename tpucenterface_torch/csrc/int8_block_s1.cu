// The stride-1 int8 MobileNetV2 residual block (B7) in one kernel, NHWC, for
// Hopper (sm_90a).
//
// Replaces make_fused_block_s1_kernel of tpucenterface/bench/probe_fused_block.py:
// x (B, H, W, Cin) bf16 -> out (B, H, W, Cout) bf16, with per-channel float32
// vectors:
//   x_q = clip(rint(x * inv_se), -127, 127)
//   e   = clip(rint(clip(acc_e * e_scale + e_bias, 0, 6) * e_inv), -127, 127)
//         acc_e = sum_k x_q[k] * we[c, k]                      1x1 expand
//   d   = clip(rint(clip(acc_d * d_scale + d_bias, 0, 6) * d_inv), -127, 127)
//         acc_d = sum of the nine taps e * wd[tap, c]          3x3 depthwise
//   out = bf16(acc_p * p_scale + p_bias [+ x]), acc_p = sum_c d[c] * wp[o, c]
// e is zero at the map's padding positions. Every product and every sum of the
// epilogues is rounded on its own (__fmul_rn, __fadd_rn: nvcc would contract
// them into FMAs, which the plain version does not do); rint rounds half to
// even. The depthwise taps are integers, so any order of the integer sums
// gives the plain version's values.
//
// Bound on an H100 SXM. The block reads x once and writes out once, and does
// 2 * (Cin + Cout) * Cmid operations a position in its products and 18 * Cmid
// in its depthwise, all on int8 operands (the card's int8 peak). At the
// model's shapes x and out bound blocks 2-9 and the operations blocks 11-15:
// 0.071 ms for the model's ten blocks at batch 32. What
// holds a fused block back on this card is not the arithmetic but latency and
// waste: the halo's expand, the weight traffic of each chunk of expanded
// channels, the barriers between the stages, and the SMs a small map leaves
// idle. After this design the kernel is latency-bound inside a block: cutting
// a sixth of its instructions, or overlapping its stages, moved it little.
//
// Design, and what each part does about that:
// - The launch plan comes from the caller (ops/int8_block.py,
//   plan_int8_block_s1): a tile of OH x OW output positions of one image,
//   fitted to the map (16x16 at 160x160, 10x20 at 80x80 and 40x40, 10x10 at
//   20x20 for the model at batch 32: few halo positions, enough blocks), the
//   chunk width CK of expanded channels (32 or 64), the warps of a block and
//   the (M tile, N tile) rectangle of the project each warp owns; blocks of 8
//   warps fit two or three an SM. The kernel recomputes every derived size
//   and refuses a plan that does not fit.
// - Every output channel in one pass: the int32 project sums of the whole tile
//   (OH*OW positions x Cout) stay in registers across all chunks, spread over
//   the warps as PM x PN mma tiles each. The expand and the depthwise of a
//   chunk are computed once.
// - The operands come packed once (pack_int8_block_s1): chunk by chunk, each
//   chunk one contiguous, 16-byte aligned block in the layout of its shared
//   memory buffer (expand weights, project weights, depthwise tap words, six
//   vectors; rows padded by 16 bytes against bank conflicts, zeros past Cmid
//   and Cin). Chunk k+1 is copied with cp.async.cg 16-byte copies into the
//   second buffer while chunk k computes.
// - Stage A, the expand: mma.sync.m16n8k32 s8 over the tile's halo, ldmatrix
//   for the input fragments, the halo M tiles and the two 32-channel halves of
//   a chunk spread over all warps; requantized to int8, zero outside the image,
//   and stored channel-major (the positions of a halo row contiguous).
// - Stage B, the depthwise in three __dp4a an output: each channel's three
//   taps of a row are packed as (w0, w1, w2, 0) in one word, and __byte_perm
//   forms the four unaligned three-byte windows of four neighbouring outputs
//   from two aligned words of the row. Requantized, d goes position-major to
//   shared memory.
// - Stage C, the project: ldmatrix reads d into the A fragments of
//   mma.sync.m16n8k32; the B fragments come from the chunk's buffer.
// - The epilogue adds p_bias and the float32 residual before one bf16
//   rounding, and masks the ragged edges of the tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;   // bytes a block may use on sm_90
constexpr int kMaxDevices = 64;

struct Params {
  const __nv_bfloat16* x;   // (B, H, W, Cin)
  const uint8_t* packed;    // pack_int8_block_s1's layout
  float inv_se;
  __nv_bfloat16* out;       // (B, H, W, Cout)
  int B, H, W, Cin, Cmid, Cout;
  int residual;
  // the plan and what follows from it
  int OH, OW;               // output tile
  int IH, IW, NPOS;         // halo'd input tile
  int RW, CS;               // bytes of a halo row and of a channel in es
  int XG;                   // groups of four output columns
  int M, MT;                // output positions of a tile, their M tiles
  int NT;                   // N tiles of Cout
  int ngroups;              // N groups of the project's rectangles
  int rects;                // rectangles (one a warp)
  int tiles_x, tiles;       // tiles a row of the map, tiles an image
  int cin_pad, XS, DSS;     // K of the expand; row bytes of xs and of ds
  int nchunks, chunk_bytes;
  int off_wp, off_taps, off_vec;   // offsets inside a chunk
  int off_es, off_ds, off_buf;     // offsets in shared memory
};

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices: lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// D (16x8, s32) += A (16x32, s8, row-major) * B (32x8, s8, column-major)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// clip(rint(v), -127, 127): for a finite v, clipping first and rounding
// after gives the same integer in one instruction less
__device__ __forceinline__ int clip127(float v) {
  return __float2int_rn(fminf(fmaxf(v, -127.f), 127.f));
}

// clip(rint(clip(acc * s + b, 0, 6) * inv), -127, 127)
__device__ __forceinline__ int requant6(int acc, float s, float b, float inv) {
  const float y = fminf(fmaxf(__fadd_rn(__fmul_rn(static_cast<float>(acc), s), b), 0.f), 6.f);
  return clip127(__fmul_rn(y, inv));
}

__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return (static_cast<uint32_t>(lo) & 0xffu) | ((static_cast<uint32_t>(hi) & 0xffu) << 8);
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return pack2(a, b) | (pack2(c, d) << 16);
}

// Shared memory, in this order (every part 16-byte aligned):
//   xs  [NPOS][XS]        the halo'd input tile, int8, zero outside the image and past Cin
//   es  [CK][CS]          the expanded chunk, channel-major: halo row hy at hy * RW
//   ds  [MT * 16][DSS]    the chunk's depthwise output, position-major (p = oy * OW + ox)
//   buf [2][chunk_bytes]  two chunks of the packed operands:
//        we [CK][XS] | wp [NT * 8][DSS] | taps [3][CK] u32 | vec [6][CK] f32
//        (vec: e_scale, e_bias, e_inv, d_scale, d_bias, d_inv)
template <int CK, int NW, int PM, int PN>
__global__ void __launch_bounds__(NW * 32, NW == 8 ? (PN <= 4 ? 3 : 2) : 1)
int8_block_s1_kernel(const Params p) {
  constexpr int kThreads = NW * 32;
  constexpr int kHalves = CK / 32;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* xs = smem;
  int8_t* es = reinterpret_cast<int8_t*>(smem + p.off_es);
  uint8_t* ds = smem + p.off_ds;
  uint8_t* buf = smem + p.off_buf;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int img = blockIdx.x / p.tiles;
  const int t = blockIdx.x - img * p.tiles;
  const int ty = t / p.tiles_x;
  const int oy0 = ty * p.OH;
  const int ox0 = (t - ty * p.tiles_x) * p.OW;
  const int iy0 = oy0 - 1;
  const int ix0 = ox0 - 1;
  const int H = p.H, W = p.W, Cin = p.Cin;
  const int XS = p.XS, DSS = p.DSS;
  const uint8_t* packed = p.packed;

  auto copy_chunk = [&](int k) {
    const uint8_t* src = packed + static_cast<size_t>(k) * p.chunk_bytes;
    uint8_t* dst = buf + (k & 1) * p.chunk_bytes;
    for (int i = tid; i < p.chunk_bytes / 16; i += kThreads) cp_async16(dst + 16 * i, src + 16 * i);
    cp_async_commit();
  };
  copy_chunk(0);

  // ---- the input tile with halo, quantized, eight channels a load -------------
  {
    const int segs = p.cin_pad / 8;
    for (int i = tid; i < p.NPOS * segs; i += kThreads) {
      const int pos = i / segs;
      const int seg = i - pos * segs;
      const int hy = pos / p.IW;
      const int gy = iy0 + hy;
      const int gx = ix0 + (pos - hy * p.IW);
      uint2 v = make_uint2(0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && seg * 8 < Cin) {
        const size_t off = ((static_cast<size_t>(img) * H + gy) * W + gx) * Cin + seg * 8;
        const uint4 raw = *reinterpret_cast<const uint4*>(p.x + off);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        uint32_t word[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 f0 = __bfloat1622float2(h2[2 * j]);
          const float2 f1 = __bfloat1622float2(h2[2 * j + 1]);
          word[j] = pack4(clip127(__fmul_rn(f0.x, p.inv_se)), clip127(__fmul_rn(f0.y, p.inv_se)),
                          clip127(__fmul_rn(f1.x, p.inv_se)), clip127(__fmul_rn(f1.y, p.inv_se)));
        }
        v = make_uint2(word[0], word[1]);
      }
      *reinterpret_cast<uint2*>(xs + pos * XS + seg * 8) = v;
    }
  }

  int acc[PM][PN][4];
#pragma unroll
  for (int i = 0; i < PM; ++i)
#pragma unroll
    for (int j = 0; j < PN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // this warp's rectangle of the project
  const bool has_rect = warp < p.rects;
  const int mg = warp / p.ngroups;
  const int ng = warp - mg * p.ngroups;
  // ldmatrix row and column of this lane inside a 16-row, 32-byte A tile
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lcol = 16 * (lane >> 4);
  const int halo_mt = (p.NPOS + 15) / 16;

  for (int k = 0; k < p.nchunks; ++k) {
    cp_async_wait_all();
    __syncthreads();  // chunk k has landed; every reader of chunk k-1, es and ds is done
    if (k + 1 < p.nchunks) copy_chunk(k + 1);
    const uint8_t* cur = buf + (k & 1) * p.chunk_bytes;
    const uint8_t* wes = cur;
    const uint8_t* wps = cur + p.off_wp;
    const uint32_t* taps = reinterpret_cast<const uint32_t*>(cur + p.off_taps);
    const float* vec = reinterpret_cast<const float*>(cur + p.off_vec);

    // ---- stage A: expand the halo, one (halo M tile, 32 channels) a warp -------
    for (int item = warp; item < halo_mt * kHalves; item += NW) {
      const int hmt = item / kHalves;
      const int h = item - hmt * kHalves;
      int ea[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) ea[nt][r] = 0;
      // rows past the last halo position read the last one; never stored
      const uint8_t* xa = xs + min(hmt * 16 + lrow, p.NPOS - 1) * XS + lcol;
      const uint8_t* wb = wes + (h * 32 + g) * XS + 4 * tig;
      for (int ks = 0; ks < p.cin_pad / 32; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, xa + ks * 32);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint8_t* w = wb + nt * 8 * XS + ks * 32;
          mma_s8(ea[nt], a, lds32(w), lds32(w + 16));
        }
      }
      float2 sc[4], bi[4], inv[4];   // this thread's two channels of each N tile
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = h * 32 + nt * 8 + 2 * tig;
        sc[nt] = *reinterpret_cast<const float2*>(vec + c);
        bi[nt] = *reinterpret_cast<const float2*>(vec + CK + c);
        inv[nt] = *reinterpret_cast<const float2*>(vec + 2 * CK + c);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = hmt * 16 + g + 8 * half;
        if (r >= p.NPOS) continue;
        const int hy = r / p.IW;
        const int hx = r - hy * p.IW;
        const int gy = iy0 + hy;
        const int gx = ix0 + hx;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        int8_t* e = es + hy * p.RW + hx;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = h * 32 + nt * 8 + 2 * tig;
          int v0 = 0, v1 = 0;
          if (inside) {
            v0 = requant6(ea[nt][2 * half], sc[nt].x, bi[nt].x, inv[nt].x);
            v1 = requant6(ea[nt][2 * half + 1], sc[nt].y, bi[nt].y, inv[nt].y);
          }
          e[c * p.CS] = static_cast<int8_t>(v0);
          e[(c + 1) * p.CS] = static_cast<int8_t>(v1);
        }
      }
    }
    __syncthreads();

    // ---- stage B: the depthwise, four columns by four channels a thread -------
    {
      const int units = (CK / 4) * p.OH * p.XG;
      for (int u = tid; u < units; u += kThreads) {
        // column group fastest, then channel group: a warp's word loads of es
        // and its word stores of d fall on distinct banks
        const int tt = u / p.XG;
        const int xg = u - tt * p.XG;
        const int oy = tt / (CK / 4);
        const int cg = tt - oy * (CK / 4);
        uint32_t q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * cg + j;
          int s[4] = {0, 0, 0, 0};
          const int8_t* row = es + c * p.CS + oy * p.RW + 4 * xg;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int tap = static_cast<int>(taps[dy * CK + c]);   // (w0, w1, w2, 0)
            const uint32_t w0 = *reinterpret_cast<const uint32_t*>(row + dy * p.RW);
            const uint32_t w1 = *reinterpret_cast<const uint32_t*>(row + dy * p.RW + 4);
            s[0] = __dp4a(static_cast<int>(w0), tap, s[0]);
            s[1] = __dp4a(static_cast<int>(__byte_perm(w0, w1, 0x4321)), tap, s[1]);
            s[2] = __dp4a(static_cast<int>(__byte_perm(w0, w1, 0x5432)), tap, s[2]);
            s[3] = __dp4a(static_cast<int>(__byte_perm(w0, w1, 0x6543)), tap, s[3]);
          }
          const float dsc = vec[3 * CK + c], dbi = vec[4 * CK + c], dinv = vec[5 * CK + c];
#pragma unroll
          for (int x = 0; x < 4; ++x) q[x] |= (static_cast<uint32_t>(requant6(s[x], dsc, dbi, dinv)) & 0xffu) << (8 * j);
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int ox = 4 * xg + x;
          if (ox < p.OW) *reinterpret_cast<uint32_t*>(ds + (oy * p.OW + ox) * DSS + 4 * cg) = q[x];
        }
      }
    }
    __syncthreads();

    // ---- stage C: the project, this warp's PM x PN mma tiles ------------------
    if (has_rect) {
#pragma unroll
      for (int ks = 0; ks < kHalves; ++ks) {
        uint32_t b[PN][2];
#pragma unroll
        for (int j = 0; j < PN; ++j) {
          const int nt = ng * PN + j;
          if (nt < p.NT) {
            const uint8_t* w = wps + (nt * 8 + g) * DSS + ks * 32 + 4 * tig;
            b[j][0] = lds32(w);
            b[j][1] = lds32(w + 16);
          }
        }
#pragma unroll
        for (int i = 0; i < PM; ++i) {
          const int mt = mg * PM + i;
          if (mt >= p.MT) continue;
          uint32_t a[4];
          ldmatrix_x4(a, ds + (mt * 16 + lrow) * DSS + ks * 32 + lcol);
#pragma unroll
          for (int j = 0; j < PN; ++j) {
            if (ng * PN + j < p.NT) mma_s8(acc[i][j], a, b[j][0], b[j][1]);
          }
        }
      }
    }
  }

  // ---- epilogue: scale + bias [+ residual], one bf16 rounding, masked store ----
  if (!has_rect) return;
  const float* p_scale = reinterpret_cast<const float*>(packed + static_cast<size_t>(p.nchunks) * p.chunk_bytes);
  const float* p_bias = p_scale + p.Cout;
#pragma unroll
  for (int i = 0; i < PM; ++i) {
    const int mt = mg * PM + i;
    if (mt >= p.MT) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pos = mt * 16 + g + 8 * half;
      if (pos >= p.M) continue;
      const int oy = pos / p.OW;
      const int gy = oy0 + oy;
      const int gx = ox0 + pos - oy * p.OW;
      if (gy >= H || gx >= W) continue;
      const size_t pix = (static_cast<size_t>(img) * H + gy) * W + gx;
#pragma unroll
      for (int j = 0; j < PN; ++j) {
        const int nt = ng * PN + j;
        if (nt >= p.NT) continue;
        const int c = nt * 8 + 2 * tig;
        float v0 = __fadd_rn(__fmul_rn(static_cast<float>(acc[i][j][2 * half]), p_scale[c]), p_bias[c]);
        float v1 = __fadd_rn(__fmul_rn(static_cast<float>(acc[i][j][2 * half + 1]), p_scale[c + 1]), p_bias[c + 1]);
        if (p.residual && c < Cin) {
          const float2 rf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.x + pix * Cin + c));
          v0 = __fadd_rn(v0, rf.x);
          v1 = __fadd_rn(v1, rf.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(p.out + pix * p.Cout + c) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The sizes the plan implies; the same arithmetic as plan_int8_block_s1.
// Returns false if the plan does not fit.
bool derive(Params& p, int ck, int warps, int pm, int pn, int smem_bytes, long long grid_x) {
  if (p.OH < 1 || p.OW < 1 || p.OH * p.OW > 1024) return false;
  p.IH = p.OH + 2;
  p.IW = p.OW + 2;
  p.NPOS = p.IH * p.IW;
  p.XG = (p.OW + 3) / 4;
  p.RW = 4 * p.XG + 4;
  p.CS = p.IH * p.RW;
  if ((p.CS / 4) % 2 == 0) p.CS += 4;   // an odd number of words between channels
  p.M = p.OH * p.OW;
  p.MT = (p.M + 15) / 16;
  p.NT = p.Cout / 8;
  p.ngroups = (p.NT + pn - 1) / pn;
  p.rects = (p.MT + pm - 1) / pm * p.ngroups;
  if (p.rects > warps) return false;
  p.tiles_x = (p.W + p.OW - 1) / p.OW;
  p.tiles = p.tiles_x * ((p.H + p.OH - 1) / p.OH);
  if (grid_x != static_cast<long long>(p.B) * p.tiles || grid_x > 2147483647LL) return false;
  p.cin_pad = round_up(p.Cin, 32);
  p.XS = p.cin_pad + 16;
  p.DSS = ck + 16;
  p.nchunks = (p.Cmid + ck - 1) / ck;
  p.off_wp = ck * p.XS;
  p.off_taps = p.off_wp + p.NT * 8 * p.DSS;
  p.off_vec = p.off_taps + 3 * ck * 4;
  p.chunk_bytes = p.off_vec + 6 * ck * 4;
  p.off_es = p.NPOS * p.XS;
  p.off_ds = p.off_es + round_up(ck * p.CS, 16);
  p.off_buf = p.off_ds + p.MT * 16 * p.DSS;
  const long long smem = static_cast<long long>(p.off_buf) + 2LL * p.chunk_bytes;
  return smem == smem_bytes && smem <= kMaxSmem;
}

template <int CK, int NW, int PM, int PN>
int launch(const Params& p, int smem, cudaStream_t stream) {
  // the dynamic shared memory is asked for once a device
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(int8_block_s1_kernel<CK, NW, PM, PN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev] = true;
  }
  int8_block_s1_kernel<CK, NW, PM, PN><<<static_cast<unsigned>(p.B * p.tiles), NW * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The (warps, PM, PN) variants the planner may choose, for CK 32 and 64.
template <int CK>
int dispatch(const Params& p, int warps, int pm, int pn, int smem, cudaStream_t stream) {
  if (warps == 8 && pm == 2 && pn == 4) return launch<CK, 8, 2, 4>(p, smem, stream);
  if (warps == 8 && pm == 2 && pn == 8) return launch<CK, 8, 2, 8>(p, smem, stream);
  if (warps == 16 && pm == 1 && pn == 12) return launch<CK, 16, 1, 12>(p, smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches B7 on `stream`; returns cudaGetLastError() as an int, or
// cudaErrorInvalidValue for shapes or a plan the kernel does not take.
// x (B,H,W,Cin) bf16 contiguous, 16-byte aligned; packed as
// pack_int8_block_s1 lays it out for chunk width ck, 16-byte aligned; out
// (B,H,W,Cout) bf16; Cin and Cout multiples of 8; the residual needs
// Cout >= Cin. The plan (tile_h, tile_w, ck, warps, pm, pn, smem_bytes,
// grid_x) is plan_int8_block_s1's.
extern "C" int tcf_int8_block_s1(
    const void* x, const void* packed, float inv_se, void* out,
    int B, int H, int W, int Cin, int Cmid, int Cout, int residual,
    int tile_h, int tile_w, int ck, int warps, int pm, int pn, int smem_bytes, long long grid_x,
    void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 8 || Cin % 8 || Cmid < 1 || Cout < 8 || Cout % 8 ||
      (residual && Cout < Cin) || (ck != 32 && ck != 64) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(packed) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.packed = static_cast<const uint8_t*>(packed);
  p.inv_se = inv_se;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = B; p.H = H; p.W = W;
  p.Cin = Cin; p.Cmid = Cmid; p.Cout = Cout;
  p.residual = residual;
  p.OH = tile_h;
  p.OW = tile_w;
  if (!derive(p, ck, warps, pm, pn, smem_bytes, grid_x)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ck == 64 ? dispatch<64>(p, warps, pm, pn, smem_bytes, s) : dispatch<32>(p, warps, pm, pn, smem_bytes, s);
}
