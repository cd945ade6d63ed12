// The stride-2 int8 MobileNetV2 block (B6) in one kernel, NHWC, for Hopper
// (sm_90a).
//
// Replaces make_fused_block_kernel of tpucenterface/bench/probe_fused_block.py:
// x (B, H, W, Cin) int8 -> out (B, Ho, Wo, Cout) int8, Ho = (H - 1) / 2 + 1.
// With per-channel float32 vectors:
//   e  = clip(rint(clip(acc_e * e_scale + e_bias, 0, 6) * e_inv), -127, 127)
//        acc_e = sum_k x[k] * we[c, k]                       1x1 expand
//   d  = clip(rint(clip(acc_d * d_scale + d_bias, 0, 6) * d_inv), -127, 127)
//        acc_d = sum of the nine taps e * wd[tap, c]         3x3 depthwise, stride 2
//   out = clip(rint(acc_p * p_scale + p_bias), -127, 127), acc_p = sum_c d[c] * wp[o, c]
// e is zero at the map's padding positions. Every product and every sum of the
// epilogues is rounded on its own (__fmul_rn, __fadd_rn: nvcc would contract
// them into FMAs, which the plain version does not do; the one fused add,
// requant6_bits', multiplies by +-1, exactly); rint rounds half to even. The depthwise taps are integers, so any order of the integer sums
// gives the plain version's values. The stride-1 block (B7) has its own
// kernel, csrc/int8_block_s1.cu, whose design this one follows.
//
// Bound on an H100 SXM. The block reads x once and writes out once, and does
// 2 * Cin * Cmid operations an input position in its expand, 2 * Cmid * Cout
// an output position in its project and 18 * Cmid in its depthwise, all on
// int8 operands (the card's int8 peak). At the model's shapes x and out bound
// blocks 1, 3 and 6 and the operations block 13: 0.036 ms for the four
// stride-2 blocks at batch 32. What holds the block back on this card is not
// the arithmetic but the elementwise work around it: every expanded value and
// every depthwise value is requantized (about ten instructions each; at block
// 1, 3.5 M halo positions x 96 channels), and the halo's expand, the barriers
// between the stages and a small map's idle SMs add to it. A clock64 profile
// of sampled warps puts 45-55% of their time in stage A and 12-17% in stage B
// (kernels/profile_b6.py; PERF.md section 6).
//
// Design, and what each part does about that:
// - The launch plan comes from the caller (ops/int8_block.py,
//   plan_int8_block_s2): a tile of OH x OW output positions of one image,
//   fitted to the map, whose halo is (2 OH + 1) x (2 OW + 1) input positions
//   (10% over the footprint at 10 x 10); the chunk width CK of expanded
//   channels (32 or 64); the warps of a block and the (M tile, N tile)
//   rectangle of the project each warp owns. The kernel recomputes every
//   derived size and refuses a plan that does not fit.
// - Every output channel in one pass: the int32 project sums of the whole tile
//   (OH*OW positions x Cout) stay in registers across all chunks, spread over
//   the warps as PM x PN mma tiles each. The expand and the depthwise of a
//   chunk are computed once.
// - The operands come packed once, in B7's layout (pack_int8_block_s1, which
//   does not depend on the stride): chunk by chunk, each chunk one contiguous,
//   16-byte aligned block in the layout of its shared memory buffer. Chunk
//   k+1 is copied with cp.async.cg 16-byte copies into the second buffer while
//   chunk k computes; p_scale and p_bias are copied once, with the input tile.
// - The input tile is copied with cp.async, 16 bytes a copy where Cin is a
//   multiple of 16 and 8 where it is not (a halo row then starts on 8 bytes
//   only), one warp a halo row, only the positions inside the image; its
//   rows are padded to an even 2 OW + 2 positions.
// - Stage A, the expand, with the chunk's channels in M (the weights, by
//   ldmatrix) and the halo positions in N: a warp item is 32 channels by 16
//   positions, so a thread holds two neighbouring positions of four channels
//   and stores them as 16-bit pairs, channel-major (the positions of a halo
//   row contiguous, slack after each channel for the positions past the
//   halo). mma.sync.m16n8k32 s8, and where Cin mod 32 is 16 or less an
//   mma.sync.m16n8k16 for the last step (block 1's Cin 16 pays no zero half).
//   The requantization is branch-free and converts nothing: the sums start
//   at the bits of 1.5 * 2^23 (the first mma's C operand), so one float
//   subtraction gives their value; the clip to +-127 is folded into the sign
//   of the inverse scale, and the rounding into a fused add of 1.5 * 2^23
//   whose product is exact. Positions outside the image are zeroed by a mask,
//   computed only in tiles whose halo leaves the image.
// - Stage B, the depthwise at stride 2 in three __dp4a an output: each
//   channel's three taps of a row are packed as (w0, w1, w2, 0) in one word;
//   output column 4g + j reads halo columns 8g + 2j .. 8g + 2j + 2, the aligned
//   word for even j and a __byte_perm of two aligned words for odd j.
//   Requantized the same way, d goes position-major to shared memory.
// - Stage C, the project: ldmatrix reads d into the A fragments of
//   mma.sync.m16n8k32; the B fragments come from the chunk's buffer.
// - The epilogue scales, biases and rounds from the vectors in shared memory,
//   stages the tile's int8 output there, and stores each output row of the
//   tile (OW * Cout contiguous bytes of out) in 16-byte pieces (8 where Cout
//   is not a multiple of 16).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;   // bytes a block may use on sm_90
constexpr int kMaxDevices = 64;
constexpr int kMaxCin = 248;       // the expand's sums stay under 2^22 (unbias)

struct Params {
  const int8_t* x;          // (B, H, W, Cin)
  const uint8_t* packed;    // pack_int8_block_s1's layout
  int8_t* out;              // (B, Ho, Wo, Cout)
  int B, H, W, Ho, Wo, Cin, Cmid, Cout;
  // the plan and what follows from it
  int OH, OW;               // output tile
  int IH, IW;               // halo'd input tile: 2 OH + 1 rows, 2 OW + 1 columns
  int IWp, NPOSp;           // its rows padded to an even IWp = IW + 1 positions, and their count
  int RW, CS;               // bytes of a halo row and of a channel in es
  int XG;                   // groups of four output columns
  int M, MT;                // output positions of a tile, their M tiles
  int NT;                   // N tiles of Cout
  int ngroups;              // N groups of the project's rectangles
  int rects;                // rectangles (one a warp)
  int tiles_x, tiles;       // tiles a row of the map, tiles an image
  int k32, k16;             // expand steps of K 32, and of K 16 (0 or 1)
  int XSX;                  // row bytes of xs
  int unit, segs;           // bytes a copy of x, copies a position
  int ROWB, ovec;           // bytes of a staged output row of the tile; bytes a store of out
  int cin_pad, XS, DSS;     // row bytes of the packed expand weights, of the project weights and of ds
  int nchunks, chunk_bytes;
  int off_wp, off_taps, off_vec;           // offsets inside a chunk
  int off_es, off_ds, off_pv, off_buf;     // offsets in shared memory
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

// two 8x8 b16 matrices: lanes 0-15 give the row addresses
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// D (16x8, s32) += A (16x16, s8, row-major) * B (16x8, s8, column-major)
__device__ __forceinline__ void mma_s8_k16(int (&c)[4], const uint32_t (&a)[2], uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// D = A * B + (c, c, c, c), the shapes of mma_s8
__device__ __forceinline__ void mma_s8_from(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1, int c) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(c));
}

// D = A * B + (c, c, c, c), the shapes of mma_s8_k16
__device__ __forceinline__ void mma_s8_k16_from(int (&d)[4], const uint32_t (&a)[2], uint32_t b0, int c) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%7,%7,%7};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0), "r"(c));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// The requantizations take int32 sums started at kMagic, the bits of
// 1.5 * 2^23, instead of 0: for |sum| < 2^22 the float of those bits, less
// 1.5 * 2^23, is the sum, exactly, without a conversion instruction.
constexpr int kMagic = 0x4B400000;
constexpr float kMagicF = 12582912.f;

__device__ __forceinline__ float unbias(int biased) { return __fsub_rn(__int_as_float(biased), kMagicF); }

// clip(rint(v), -127, 127) in the low byte of the result: clipping first and
// rounding after gives the same integer for a finite v, and adding 1.5 * 2^23
// rounds to an integer, half to even, leaving it in the low bits
__device__ __forceinline__ uint32_t clip127_bits(float v) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(v, -127.f), 127.f), kMagicF));
}

// clip(rint(clip(sum * s + b, 0, 6) * inv), -127, 127) in the low byte, for a
// sum started at kMagic, with ainv = |inv| and sgn = +-1 the sign of inv: y =
// clip(.., 0, 6) is not negative, so y * inv has the sign of inv and only one
// of the two clips can bind; the product by sgn in the fused add is exact
__device__ __forceinline__ uint32_t requant6_bits(int biased, float s, float b, float ainv, float sgn) {
  const float y = fminf(fmaxf(__fadd_rn(__fmul_rn(unbias(biased), s), b), 0.f), 6.f);
  return __float_as_uint(__fmaf_rn(fminf(__fmul_rn(y, ainv), 127.f), sgn, kMagicF));
}

// the low bytes of lo and hi as a 16-bit pair
__device__ __forceinline__ uint16_t low_bytes2(uint32_t lo, uint32_t hi) {
  return static_cast<uint16_t>(__byte_perm(lo, hi, 0x0040));
}

// Shared memory, in this order (every part 16-byte aligned):
//   xs  [NPOSp][XSX]       the halo'd input tile, int8, position hy * IWp + hx (only the positions inside
//                          the image are written); after the last chunk, the staged output tile [OH][ROWB]
//   es  [CK][CS]           the expanded chunk, channel-major: halo row hy at hy * RW, then slack rows
//   ds  [MT * 16][DSS]     the chunk's depthwise output, position-major (p = oy * OW + ox)
//   pv  [2][Cout] f32      p_scale, p_bias
//   buf [2][chunk_bytes]   two chunks of the packed operands:
//        we [CK][XS] | wp [NT * 8][DSS] | taps [3][CK] u32 | vec [6][CK] f32
//        (vec: e_scale, e_bias, e_inv, d_scale, d_bias, d_inv)
template <int CK, int NW, int PM, int PN>
__global__ void __launch_bounds__(NW * 32, NW == 8 ? (PN <= 4 ? 3 : 2) : 1)
int8_block_s2_kernel(const Params p) {
  constexpr int kThreads = NW * 32;
  constexpr int kHalves = CK / 32;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* xs = smem;
  int8_t* es = reinterpret_cast<int8_t*>(smem + p.off_es);
  uint8_t* ds = smem + p.off_ds;
  const float* pv = reinterpret_cast<const float*>(smem + p.off_pv);
  uint8_t* buf = smem + p.off_buf;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int img = blockIdx.x / p.tiles;
  // PROFILE_START (this line and each PROFILE(phase) below are where
  // kernels/profile_b6.py puts its clock64 marks; they compile to nothing)
  const int t = blockIdx.x - img * p.tiles;
  const int ty = t / p.tiles_x;
  const int oy0 = ty * p.OH;
  const int ox0 = (t - ty * p.tiles_x) * p.OW;
  const int iy0 = 2 * oy0 - 1;
  const int ix0 = 2 * ox0 - 1;
  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout;
  const int XS = p.XS, XSX = p.XSX, DSS = p.DSS, IWp = p.IWp;
  const uint8_t* packed = p.packed;

  // ---- the halo'd input tile, a warp a halo row, without a division a copy ---
  {
    const int segs = p.segs, unit = p.unit;
    const int row_units = p.IW * segs;
    const int dq = 32 / segs;
    const int dr = 32 - dq * segs;
    const int hx0 = lane / segs;
    const int seg0 = lane - hx0 * segs;
    for (int hy = warp; hy < p.IH; hy += NW) {
      const int gy = iy0 + hy;
      if (gy < 0 || gy >= H) continue;
      const long long row = (static_cast<long long>(img) * H + gy) * W;
      uint8_t* dst_row = xs + hy * IWp * XSX;
      int hx = hx0, seg = seg0;
      for (int u = lane; u < row_units; u += 32) {
        const int gx = ix0 + hx;
        if (gx >= 0 && gx < W) {
          const int8_t* src = p.x + (row + gx) * Cin + seg * unit;
          uint8_t* dst = dst_row + hx * XSX + seg * unit;
          if (unit == 16) {
            cp_async16(dst, src);
          } else {
            cp_async8(dst, src);
          }
        }
        hx += dq;
        seg += dr;
        if (seg >= segs) {
          seg -= segs;
          ++hx;
        }
      }
    }
    const uint8_t* src = packed + static_cast<size_t>(p.nchunks) * p.chunk_bytes;
    for (int i = tid; i < Cout / 2; i += kThreads) cp_async16(smem + p.off_pv + 16 * i, src + 16 * i);
  }

  auto copy_chunk = [&](int k) {
    const uint8_t* src = packed + static_cast<size_t>(k) * p.chunk_bytes;
    uint8_t* dst = buf + (k & 1) * p.chunk_bytes;
    for (int i = tid; i < p.chunk_bytes / 16; i += kThreads) cp_async16(dst + 16 * i, src + 16 * i);
    cp_async_commit();
  };
  copy_chunk(0);   // one group with the input tile and the vectors

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
  // Stage A: warp w expands the 32 channels w % kHalves of the chunk (two M
  // tiles of 16; the chunk's weights are the A operand) at the pairs of N
  // tiles of eight halo positions w / kHalves, then every kStep-th. A
  // thread's positions are 16 pair + 8 j + 2 tig and the next one, neighbours
  // in one padded halo row (IWp is even), followed as (halo row, column)
  // without a division. A tile whose halo lies inside the image tests no
  // position.
  constexpr int kStep = NW / kHalves;
  const int h = warp % kHalves;
  const int npairs = (p.NPOSp + 15) / 16;
  const int a_q = 16 * kStep / IWp;
  const int a_r = 16 * kStep - a_q * IWp;
  int a_hy[2], a_hx[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int pos = warp / kHalves * 16 + 8 * j + 2 * tig;
    a_hy[j] = pos / IWp;
    a_hx[j] = pos - a_hy[j] * IWp;
  }
  const bool interior = iy0 >= 0 && iy0 + p.IH <= H && ix0 >= 0 && ix0 + p.IW <= W;
  // Stage B: thread u of a chunk's units is (unit / XG, unit % XG), followed
  // the same way over steps of kThreads units
  const int b_q = kThreads / p.XG;
  const int b_r = kThreads - b_q * p.XG;
  const int b_tt = tid / p.XG;
  const int b_xg = tid - b_tt * p.XG;

  for (int k = 0; k < p.nchunks; ++k) {
    // PROFILE(k == 0 ? 0 : 6)
    cp_async_wait_all();
    __syncthreads();  // chunk k has landed; every reader of chunk k-1, es and ds is done
    if (k + 1 < p.nchunks) copy_chunk(k + 1);
    // PROFILE(1)
    const uint8_t* cur = buf + (k & 1) * p.chunk_bytes;
    const uint8_t* wes = cur;
    const uint8_t* wps = cur + p.off_wp;
    const uint32_t* taps = reinterpret_cast<const uint32_t*>(cur + p.off_taps);
    const float* vec = reinterpret_cast<const float*>(cur + p.off_vec);

    // ---- stage A: expand the halo, (32 channels) x (16 positions) a warp item -
    {
      // this thread's channels: h * 32 + 16 mt + 8 i + g, vector v = 2 mt + i
      float sc[4], bi[4], ainv[4], sgn[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int c = h * 32 + 8 * v + g;
        sc[v] = vec[c];
        bi[v] = vec[CK + c];
        ainv[v] = fabsf(vec[2 * CK + c]);
        sgn[v] = copysignf(1.f, vec[2 * CK + c]);
      }
      const uint8_t* wa = wes + (h * 32 + lrow) * XS + lcol;
      int8_t* ec = es + (h * 32 + g) * p.CS;
      int hy[2] = {a_hy[0], a_hy[1]}, hx[2] = {a_hx[0], a_hx[1]};
      for (int pair = warp / kHalves; pair < npairs; pair += kStep) {
        // B: position 16 pair + 8 j + g, bytes 4 tig.. of each step of K
        const uint8_t* xb = xs + (pair * 16 + g) * XSX + 4 * tig;
        // the positions' bytes in es and masks that zero those outside the
        // image: the requantization and the stores run branch-free (positions
        // past the halo land in the slack rows of their channel)
        uint32_t m0[2] = {0xFFu, 0xFFu}, m1[2] = {0xFFu, 0xFFu};
        int eo[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (!interior) {   // the same branch for the whole block
            const int gy = iy0 + hy[j];
            const int gx = ix0 + hx[j];
            const bool row_in = (gy >= 0) & (gy < H);
            m0[j] = row_in & (gx >= 0) & (gx < W) ? 0xFFu : 0u;
            m1[j] = row_in & (gx + 1 < W) ? 0xFFu : 0u;   // gx + 1 >= 0: halo columns start at -1
          }
          eo[j] = hy[j] * p.RW + hx[j];
          hx[j] += a_r;
          hy[j] += a_q;
          if (hx[j] >= IWp) {
            hx[j] -= IWp;
            ++hy[j];
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // the sums start at kMagic, the first product's C operand
          int ea[2][4];
          const uint8_t* w = wa + mt * 16 * XS;
          if (p.k32 > 0) {
            uint32_t a[4];
            ldmatrix_x4(a, w);
#pragma unroll
            for (int j = 0; j < 2; ++j) mma_s8_from(ea[j], a, lds32(xb + j * 8 * XSX), lds32(xb + j * 8 * XSX + 16), kMagic);
            for (int ks = 1; ks < p.k32; ++ks) {
              ldmatrix_x4(a, w + ks * 32);
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const uint8_t* b = xb + j * 8 * XSX + ks * 32;
                mma_s8(ea[j], a, lds32(b), lds32(b + 16));
              }
            }
            if (p.k16) {
              // lanes 0-15 address the 16 rows at column 0 of the last 16 bytes of K
              uint32_t a2[2];
              ldmatrix_x2(a2, w - lcol + p.k32 * 32);
#pragma unroll
              for (int j = 0; j < 2; ++j) mma_s8_k16(ea[j], a2, lds32(xb + j * 8 * XSX + p.k32 * 32));
            }
          } else {   // Cin of 16 or less: one step of K 16
            uint32_t a2[2];
            ldmatrix_x2(a2, w - lcol);
#pragma unroll
            for (int j = 0; j < 2; ++j) mma_s8_k16_from(ea[j], a2, lds32(xb + j * 8 * XSX), kMagic);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int v = 2 * mt + i;
              const uint32_t v0 = requant6_bits(ea[j][2 * i], sc[v], bi[v], ainv[v], sgn[v]) & m0[j];
              const uint32_t v1 = requant6_bits(ea[j][2 * i + 1], sc[v], bi[v], ainv[v], sgn[v]) & m1[j];
              *reinterpret_cast<uint16_t*>(ec + eo[j] + 8 * v * p.CS) = low_bytes2(v0, v1);
            }
          }
        }
      }
    }
    // PROFILE(2)
    __syncthreads();
    // PROFILE(3)

    // ---- stage B: the depthwise at stride 2, four columns by four channels a thread
    {
      const int units = (CK / 4) * p.OH * p.XG;
      int tt = b_tt, xg = b_xg;   // column group fastest, then channel group, then output row
      for (int u = tid; u < units; u += kThreads) {
        const int oy = tt / (CK / 4);
        const int cg = tt % (CK / 4);
        uint32_t q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * cg + j;
          int s[4] = {kMagic, kMagic, kMagic, kMagic};
          // halo columns 8 xg .. 8 xg + 11 of halo row 2 oy + dy
          const int8_t* row = es + c * p.CS + 2 * oy * p.RW + 8 * xg;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int tap = static_cast<int>(taps[dy * CK + c]);   // (w0, w1, w2, 0)
            const uint32_t* r = reinterpret_cast<const uint32_t*>(row + dy * p.RW);
            const uint32_t w0 = r[0], w1 = r[1], w2 = r[2];
            s[0] = __dp4a(static_cast<int>(w0), tap, s[0]);
            s[1] = __dp4a(static_cast<int>(__byte_perm(w0, w1, 0x5432)), tap, s[1]);
            s[2] = __dp4a(static_cast<int>(w1), tap, s[2]);
            s[3] = __dp4a(static_cast<int>(__byte_perm(w1, w2, 0x5432)), tap, s[3]);
          }
          const float dsc = vec[3 * CK + c], dbi = vec[4 * CK + c], dinv = vec[5 * CK + c];
          const float dainv = fabsf(dinv), dsgn = copysignf(1.f, dinv);
          // the low byte of each result into byte j of its output's word: selector
          // 0x3210 with nibble j set to 4
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            q[x] = __byte_perm(q[x], requant6_bits(s[x], dsc, dbi, dainv, dsgn), 0x3210u + ((4u - j) << (4 * j)));
          }
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int ox = 4 * xg + x;
          if (ox < p.OW) *reinterpret_cast<uint32_t*>(ds + (oy * p.OW + ox) * DSS + 4 * cg) = q[x];
        }
        tt += b_q;
        xg += b_r;
        if (xg >= p.XG) {
          xg -= p.XG;
          ++tt;
        }
      }
    }
    // PROFILE(4)
    __syncthreads();
    // PROFILE(5)

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

  // PROFILE(6)
  // ---- epilogue: scale + bias, round, staged in xs (free since the last stage A)
  uint8_t* stage = xs;
  if (has_rect) {
#pragma unroll
    for (int i = 0; i < PM; ++i) {
      const int mt = mg * PM + i;
      if (mt >= p.MT) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pos = mt * 16 + g + 8 * half;
        if (pos >= p.M) continue;
        const int oy = pos / p.OW;
        uint8_t* o = stage + oy * p.ROWB + (pos - oy * p.OW) * Cout;
#pragma unroll
        for (int j = 0; j < PN; ++j) {
          const int nt = ng * PN + j;
          if (nt >= p.NT) continue;
          const int c = nt * 8 + 2 * tig;
          const float v0 = __fadd_rn(__fmul_rn(static_cast<float>(acc[i][j][2 * half]), pv[c]), pv[Cout + c]);
          const float v1 = __fadd_rn(__fmul_rn(static_cast<float>(acc[i][j][2 * half + 1]), pv[c + 1]),
                                     pv[Cout + c + 1]);
          *reinterpret_cast<uint16_t*>(o + c) = low_bytes2(clip127_bits(v0), clip127_bits(v1));
        }
      }
    }
  }
  __syncthreads();
  // each output row of the tile: its columns inside the map are contiguous in out
  {
    const int rows = min(p.OH, p.Ho - oy0);
    const int units = min(p.OW, p.Wo - ox0) * Cout / p.ovec;
    for (int oy = warp; oy < rows; oy += NW) {
      int8_t* dst = p.out + ((static_cast<long long>(img) * p.Ho + oy0 + oy) * p.Wo + ox0) * Cout;
      const uint8_t* src = stage + oy * p.ROWB;
      if (p.ovec == 16) {
        for (int u = lane; u < units; u += 32)
          reinterpret_cast<uint4*>(dst)[u] = reinterpret_cast<const uint4*>(src)[u];
      } else {
        for (int u = lane; u < units; u += 32)
          reinterpret_cast<uint2*>(dst)[u] = reinterpret_cast<const uint2*>(src)[u];
      }
    }
  }
  // PROFILE(7)
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The sizes the plan implies; the same arithmetic as plan_int8_block_s2.
// Returns false if the plan does not fit.
bool derive(Params& p, int ck, int warps, int pm, int pn, int smem_bytes, long long grid_x) {
  if (p.OH < 1 || p.OW < 1 || p.OH * p.OW > 1024) return false;
  p.IH = 2 * p.OH + 1;
  p.IW = 2 * p.OW + 1;
  p.IWp = p.IW + 1;
  p.NPOSp = p.IH * p.IWp;
  p.XG = (p.OW + 3) / 4;
  p.RW = 8 * p.XG + 4;
  // a channel's halo rows, and slack for stage A's stores past the halo (up
  // to 15 positions); an odd number of words between channels
  p.CS = round_up(p.IH * p.RW + 15 / p.IWp * p.RW + 15 % p.IWp + 1, 4);
  if ((p.CS / 4) % 2 == 0) p.CS += 4;
  p.M = p.OH * p.OW;
  p.MT = (p.M + 15) / 16;
  p.NT = p.Cout / 8;
  p.ngroups = (p.NT + pn - 1) / pn;
  p.rects = (p.MT + pm - 1) / pm * p.ngroups;
  if (p.rects > warps) return false;
  p.tiles_x = (p.Wo + p.OW - 1) / p.OW;
  p.tiles = p.tiles_x * ((p.Ho + p.OH - 1) / p.OH);
  if (grid_x != static_cast<long long>(p.B) * p.tiles || grid_x > 2147483647LL) return false;
  const int kpad = round_up(p.Cin, 16);
  p.k32 = kpad / 32;
  p.k16 = kpad % 32 != 0;
  p.XSX = (kpad / 16) % 2 ? kpad : kpad + 16;   // an odd number of 16 bytes: ldmatrix rows on distinct banks
  p.unit = p.Cin % 16 == 0 ? 16 : 8;
  p.segs = p.Cin / p.unit;
  p.ovec = p.Cout % 16 == 0 ? 16 : 8;
  p.ROWB = round_up(p.OW * p.Cout, 16);
  p.cin_pad = round_up(p.Cin, 32);
  p.XS = p.cin_pad + 16;
  p.DSS = ck + 16;
  p.nchunks = (p.Cmid + ck - 1) / ck;
  p.off_wp = ck * p.XS;
  p.off_taps = p.off_wp + p.NT * 8 * p.DSS;
  p.off_vec = p.off_taps + 3 * ck * 4;
  p.chunk_bytes = p.off_vec + 6 * ck * 4;
  const int xs_bytes = p.NPOSp * p.XSX;   // stage A's reads past it fall in es, and are never stored
  const int tile = xs_bytes > p.OH * p.ROWB ? xs_bytes : p.OH * p.ROWB;
  p.off_es = round_up(tile, 16);
  p.off_ds = p.off_es + round_up(ck * p.CS, 16);
  p.off_pv = p.off_ds + p.MT * 16 * p.DSS;
  p.off_buf = p.off_pv + 8 * p.Cout;
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
    e = cudaFuncSetAttribute(int8_block_s2_kernel<CK, NW, PM, PN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev] = true;
  }
  int8_block_s2_kernel<CK, NW, PM, PN><<<static_cast<unsigned>(p.B * p.tiles), NW * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The (warps, PM, PN) variants the planner may choose, for CK 32 and 64.
template <int CK>
int dispatch(const Params& p, int warps, int pm, int pn, int smem, cudaStream_t stream) {
  if (warps == 8 && pm == 2 && pn == 3) return launch<CK, 8, 2, 3>(p, smem, stream);
  if (warps == 8 && pm == 2 && pn == 4) return launch<CK, 8, 2, 4>(p, smem, stream);
  if (warps == 8 && pm == 2 && pn == 8) return launch<CK, 8, 2, 8>(p, smem, stream);
  if (warps == 16 && pm == 1 && pn == 12) return launch<CK, 16, 1, 12>(p, smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches B6 on `stream`; returns cudaGetLastError() as an int, or
// cudaErrorInvalidValue for shapes or a plan the kernel does not take.
// x (B,H,W,Cin) int8 contiguous, 16-byte aligned; packed as
// pack_int8_block_s1 lays it out for chunk width ck, 16-byte aligned; out
// (B,Ho,Wo,Cout) int8, Ho = (H-1)/2 + 1, 16-byte aligned; Cin and Cout
// multiples of 8, Cin at most 248. The plan (tile_h, tile_w, ck, warps, pm, pn, smem_bytes,
// grid_x) is plan_int8_block_s2's.
extern "C" int tcf_int8_block(
    const void* x, const void* packed, void* out, int B, int H, int W, int Cin, int Cmid, int Cout,
    int tile_h, int tile_w, int ck, int warps, int pm, int pn, int smem_bytes, long long grid_x,
    void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 8 || Cin % 8 || Cin > kMaxCin || Cmid < 1 || Cout < 8 || Cout % 8 ||
      (ck != 32 && ck != 64) || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(packed) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.packed = static_cast<const uint8_t*>(packed);
  p.out = static_cast<int8_t*>(out);
  p.B = B; p.H = H; p.W = W;
  p.Ho = (H - 1) / 2 + 1;
  p.Wo = (W - 1) / 2 + 1;
  p.Cin = Cin; p.Cmid = Cmid; p.Cout = Cout;
  p.OH = tile_h;
  p.OW = tile_w;
  if (!derive(p, ck, warps, pm, pn, smem_bytes, grid_x)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ck == 64 ? dispatch<64>(p, warps, pm, pn, smem_bytes, s) : dispatch<32>(p, warps, pm, pn, smem_bytes, s);
}
