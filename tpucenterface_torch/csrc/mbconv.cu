// Fused MobileNetV2 inverted-residual block (stride 1) for Hopper (sm_90a).
//
// Replaces the TPU kernel tpucenterface/ops/fused_mbconv.py::fused_mbconv
// (kernel _kernel). For x (B, H, W, Cin) bf16, NHWC:
//   e = bf16(act(x @ w1 + b1))         1x1 expand (skipped when the block has none)
//   e = 0 at the image's zero-pad positions (not act(b1))
//   d = bf16(act(sum_{dy,dx} e[y+dy-1, x+dx-1] * wd[dy, dx] + bd))   3x3 depthwise
//   out = bf16(d @ w2 + b2 [+ x])      1x1 project, optional skip
// with bf16 operands and float32 sums; the nine taps are summed in the order
// dy, dx. The expanded tensor e never reaches device memory.
//
// Bound on an H100 SXM. The block reads x once and writes out once,
// B*H*W*(Cin+Cout)*2 bytes, against 2*B*H*W*(Cin*Ce + Ce*Cout) operations on
// the tensor cores and 18*B*H*W*Ce on the float32 pipes (the depthwise); the
// depthwise is the largest term at the model's shapes, the bytes at the block
// without an expand. What held the first version back was not the arithmetic
// but latency and waste: the halo's expand recomputed by neighbouring tiles,
// the dead outputs of a tile that does not fit the map, each chunk's weights
// loaded two bytes at a time between barriers, one block of eight warps an SM,
// and nine shared-memory loads an output in the depthwise. This version is
// latency-bound inside a thread block: a clock64 profile of its phases puts
// most of a tile in the depthwise and the expand, each issued at about half
// the SM's rate between two barriers.
//
// Design, and what each part does about that:
// - The launch plan comes from the caller (ops/fused_mbconv.py,
//   plan_fused_mbconv): a tile of OH x OW output positions of one image,
//   fitted to the map (few halo positions, no dead outputs, enough blocks for
//   the 132 SMs), the chunk width CK of expanded channels (32, 48 or 64), the
//   warps of a block (8, two blocks an SM, or 16, 128 registers a thread),
//   each warp's rectangle of PM x PN project tiles, and the output channels a
//   block computes (all of them at the model's shapes; groups in grid.y
//   beyond). The kernel recomputes every derived size and refuses a plan that
//   does not fit.
// - Every output channel in one pass: the float32 project sums of the whole
//   tile (OH*OW positions x Cout) stay in registers across all chunks, spread
//   over the warps as PM x PN mma tiles each. The expand and the depthwise of
//   a chunk are computed once a tile.
// - The weights come packed once (pack_fused_mbconv): chunk by chunk, each
//   chunk one contiguous, 16-byte aligned slab in the layout of its shared
//   memory buffer (w1 transposed, w2 rows for every output channel, the nine
//   taps, b1 and bd in float32; rows padded by 16 bytes against bank
//   conflicts, zeros past Ce, Cin and Cout). Chunk k+1 is copied with
//   cp.async.cg 16-byte copies into the second buffer while chunk k
//   computes. A block walks tiles (as many blocks as fit the SMs at once),
//   and the next tile's halo'd input is copied the same way, zero-filled
//   outside the image and past Cin, once the current tile's last reader of it
//   is done (the last chunk's expand), or, without an expand, into a second
//   buffer a whole tile ahead.
// - Stage A, the expand: mma.sync.m16n8k16 over the tile's halo, A and B
//   fragments by ldmatrix, the halo M tiles and the 32- or 48-channel groups
//   of a chunk spread over all warps; b1, act, bf16 rounding, zero outside the
//   image, stored position-major.
// - Stage B, the depthwise: a thread keeps one channel pair's taps in
//   registers and walks units of two rows of four outputs, a window of four
//   rows of six columns: each expanded value is loaded once for up to six
//   taps (the first version loaded it once a tap). Without an expand the
//   chunk is read from the input tile itself. d goes position-major to shared
//   memory, bias, act and bf16 rounding applied (the clamp on the rounded
//   pair as bf16x2, which gives the same bits).
// - Stage C, the project: ldmatrix reads d into A fragments and the chunk's
//   w2 rows into B fragments; each warp adds its PM x PN tiles.
// - The epilogue adds b2 and the skip (read again from x, through L2: the
//   input tile's buffer holds the next tile by then) before one bf16
//   rounding, and masks the ragged edges of the tile.
//
// Not bit-equal to a float32 matrix product of the same bf16 operands: the
// tensor cores sum in another order, and the depthwise multiplies and adds in
// one fused step, so a value next to a bf16 rounding boundary can land one
// bf16 step away.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;   // bytes a block may use on sm_90
constexpr int kMaxDevices = 64;
constexpr int kSpare = 4;          // rows past the halo a depthwise window may read (masked outputs only)

struct Params {
  const __nv_bfloat16* x;   // (B, H, W, Cin)
  const uint8_t* packed;    // pack_fused_mbconv's layout
  __nv_bfloat16* out;       // (B, H, W, Cout)
  int B, H, W, Cin, Ce, Cout;
  int skip;
  float cap;                // the activation's upper bound: 6 for ReLU6, +inf for ReLU
  // the plan and what follows from it
  int OH, OW;               // output tile
  int IW, NPOS;             // halo'd input tile: row length, positions
  int XG;                   // groups of four output columns
  int M, MT;                // output positions of a tile, their M tiles
  int CG;                   // output channels a block (grid.y groups of them)
  int ngroups, rects;       // N groups of the project's rectangles; rectangles (one a warp)
  int tiles_x, tiles;       // tiles a row of the map, tiles an image
  int cin_pad, XS;          // K of the expand (or the chunked channels); row of xs and of w1, bf16
  int nchunks, chunk_bytes;
  int off_w2, off_taps, off_bd;    // offsets inside a chunk (b1 follows the taps)
  int off_es, off_ds, off_buf;     // offsets in shared memory
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bf16(act(lo)), bf16(act(hi)) as one word, act(v) = min(max(v, 0), cap): the
// pair is rounded first and clamped as bf16x2, which gives the same bits,
// since rounding is monotonic and 0 and cap (6 or +inf) are bf16 values
__device__ __forceinline__ uint32_t act_pack(float lo, float hi, __nv_bfloat162 cap2) {
  const __nv_bfloat162 v = __hmin2(__hmax2(__floats2bfloat162_rn(lo, hi), __float2bfloat162_rn(0.f)), cap2);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the two bf16 of a word as float32: a shift and a mask
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// The warp's index, broadcast from lane 0 so that the compiler knows it is the
// same in every lane: branches on it then need no WARPSYNC before the
// .sync.aligned instructions (ldmatrix, mma) inside them.
__device__ __forceinline__ int warp_index() { return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 5, 0); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices: lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// two 8x8 b16 matrices: lanes 0-15 give the row addresses
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}

// D (16x8, f32) += A (16x16, bf16, row-major) * B (16x8, bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// 16 bytes from src, or 16 zero bytes when `bytes` is 0 (src is not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Blocks an SM holds at the launch bounds, 128 registers a thread: two of
// eight warps, one of sixteen. (Three or four blocks of eight warps, at 80 or
// 64 registers, spilled and ran slower.)
__host__ __device__ constexpr int occupancy(int nw) { return nw == 16 ? 1 : 2; }

// Shared memory, in this order (every part 16-byte aligned; row strides in
// bf16 are 8 past a multiple of 16, so that the eight rows an ldmatrix reads
// fall on distinct banks):
//   xs  [NPOS + kSpare][XS]      the halo'd input tile, zero outside the image and past Cin;
//                                two of them without an expand
//   es  [NPOS + kSpare][CK + 8]  the expanded chunk, position-major (none without an expand)
//   ds  [MT * 16][CK + 8]        the chunk's depthwise output, position-major (p = oy * OW + ox)
//   buf [2][chunk_bytes]         two chunks of the packed weights:
//        w1 [CK][XS] (with an expand) | w2 [Cout][CK + 8] | taps [9][CK] f32 | b1 [CK] f32 | bd [CK] f32
template <int CK, int NW, int PM, int PN, bool EXPAND>
__global__ void __launch_bounds__(NW * 32, occupancy(NW))
mbconv_kernel(const Params p) {
  constexpr int kThreads = NW * 32;
  constexpr int CW = CK + 8;           // row of es, ds and the w2 chunk, bf16
  constexpr int kPairs = CK / 2;       // channel pairs of a chunk
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* es = reinterpret_cast<__nv_bfloat16*>(smem + p.off_es);
  __nv_bfloat16* ds = reinterpret_cast<__nv_bfloat16*>(smem + p.off_ds);
  uint8_t* buf = smem + p.off_buf;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = warp_index();
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int co0 = blockIdx.y * p.CG;               // this block's first output channel
  const int ntg = (min(p.CG, p.Cout - co0)) / 8;   // its N tiles
  const int H = p.H, W = p.W, Cin = p.Cin, IW = p.IW, XS = p.XS, NPOS = p.NPOS;
  const int total = p.B * p.tiles;                 // tiles of the batch
  const __nv_bfloat162 cap2 = __float2bfloat162_rn(p.cap);

  // chunk copies go to the two buffers in turns, across tiles
  int issued = 0;
  auto copy_chunk = [&](int k) {
    const uint8_t* src = p.packed + static_cast<size_t>(k) * p.chunk_bytes;
    uint8_t* dst = buf + (issued & 1) * p.chunk_bytes;
    for (int i = tid; i < p.chunk_bytes / 16; i += kThreads) cp_async16(dst + 16 * i, src + 16 * i);
    cp_async_commit();
    ++issued;
  };
  // the halo'd input tile `t` (image, tile row, tile column), eight channels a
  // copy, zeros outside the image and past Cin; copy i is (halo row hy, column
  // hx, eight channels seg), i = (hy * IW + hx) * segs + seg, a thread's copies
  // stepping by kThreads = ((dhy * IW) + dhx) * segs + dseg
  const int segs = p.cin_pad / 8;
  const int dseg = kThreads % segs, dhx = kThreads / segs % IW, dhy = kThreads / segs / IW;
  const int hy_first = tid / segs / IW, hx_first = tid / segs % IW, seg_first = tid % segs;
  // without an expand xs is two buffers, tile by tile in turns
  const int xs_elems = (NPOS + kSpare) * XS;
  auto copy_tile = [&](int t, __nv_bfloat16* dst) {
    const int img = t / p.tiles;
    const int ty = (t - img * p.tiles) / p.tiles_x;
    const int iy0 = ty * p.OH - 1;
    const int ix0 = (t - img * p.tiles - ty * p.tiles_x) * p.OW - 1;
    const __nv_bfloat16* xb = p.x + static_cast<size_t>(img) * H * W * Cin;
    for (int hy = hy_first, hx = hx_first, seg = seg_first; hy < p.OH + 2;) {
      const int gy = iy0 + hy, gx = ix0 + hx;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W && seg * 8 < Cin;
      const __nv_bfloat16* src = in ? xb + (static_cast<size_t>(gy) * W + gx) * Cin + seg * 8 : p.x;
      cp_async16_zfill(dst + (hy * IW + hx) * XS + seg * 8, src, in ? 16 : 0);
      seg += dseg;
      hx += dhx;
      hy += dhy;
      if (seg >= segs) {
        seg -= segs;
        ++hx;
      }
      if (hx >= IW) {
        hx -= IW;
        ++hy;
      }
    }
  };

  // this warp's rectangle of the project
  const bool has_rect = warp < p.rects;
  const int mg = warp / p.ngroups;
  const int ng = warp - mg * p.ngroups;
  // ldmatrix: lane -> row of a 16-row A tile and its 8-column half
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lcol = 8 * (lane >> 4);
  // stage B: this thread's channel pair, its first unit (two output rows
  // from oy_first, four columns from 4 xg_first) and the units it moves on
  // by, kStep a round; threads past kStep * kPairs (with CK 48) take no part
  const int cpair = 2 * (tid % kPairs);
  constexpr int kStep = kThreads / kPairs;
  const int oy_first = tid < kStep * kPairs ? 2 * ((tid / kPairs) / p.XG) : p.OH;
  const int xg_first = (tid / kPairs) - oy_first / 2 * p.XG;
  const int step_y = 2 * (kStep / p.XG);
  const int step_x = kStep % p.XG;
  // the epilogue: row and column in the tile of this thread's output rows
  // (M tile mg * PM + i, row g + 8 half), -1 past the tile
  int out_yx[PM][2];
#pragma unroll
  for (int i = 0; i < PM; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pos = (mg * PM + i) * 16 + g + 8 * half;
      out_yx[i][half] = pos < p.M ? (pos / p.OW) << 16 | (pos % p.OW) : -1;
    }
  // stage A: items (halo M tile, kNA N tiles), warp w taking items w, w + NW, ...
  constexpr int kNA = CK == 48 ? 6 : 4;
  constexpr int kGroups = CK / (8 * kNA);
  const int a_items = (NPOS + 15) / 16 * kGroups;

  // The block walks tiles blockIdx.x, + gridDim.x, ...: the first tile and
  // chunk 0 are copied here, every later tile while the one before computes.
  if (static_cast<int>(blockIdx.x) < total) copy_tile(blockIdx.x, xs);
  copy_chunk(0);
  for (int t = blockIdx.x, turn = 0; t < total; t += gridDim.x, turn ^= 1) {
    const int img = t / p.tiles;
    const int ty = (t - img * p.tiles) / p.tiles_x;
    const int oy0 = ty * p.OH;
    const int ox0 = (t - img * p.tiles - ty * p.tiles_x) * p.OW;
    const bool more = t + static_cast<int>(gridDim.x) < total;

    // bit 2 j + half of `inside`: whether row g + 8 half of this warp's j-th
    // stage-A item lies inside the image (the same for every chunk)
    uint32_t inside = 0u;
    if constexpr (EXPAND) {
      for (int j = 0, item = warp; item < a_items; ++j, item += NW) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = item / kGroups * 16 + g + 8 * half;
          const int hy = r / IW;
          const int gy = oy0 - 1 + hy;
          const int gx = ox0 - 1 + (r - hy * IW);
          if (r < NPOS && gy >= 0 && gy < H && gx >= 0 && gx < W) inside |= 1u << (2 * j + half);
        }
      }
    }

    float acc[PM][PN][4];
#pragma unroll
    for (int i = 0; i < PM; ++i)
#pragma unroll
      for (int j = 0; j < PN; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

    for (int k = 0; k < p.nchunks; ++k) {
      cp_async_wait_all();
      __syncthreads();  // chunk k (and the tile) have landed; every reader of chunk k-1, es and ds is done
      const uint8_t* cur = buf + ((issued - 1) & 1) * p.chunk_bytes;
      const bool last = k + 1 == p.nchunks;
      if (!last) {
        copy_chunk(k + 1);
      } else if (more) {
        copy_chunk(0);   // the next tile's first chunk
      }
      if constexpr (!EXPAND) {
        // the next tile into the other buffer, a whole tile ahead of its use
        if (k == 0 && more) {
          copy_tile(t + gridDim.x, xs + (turn ^ 1) * xs_elems);
          cp_async_commit();
        }
      }
      const __nv_bfloat16* w2s = reinterpret_cast<const __nv_bfloat16*>(cur + p.off_w2);
      const float* taps = reinterpret_cast<const float*>(cur + p.off_taps);
      const float* bds = reinterpret_cast<const float*>(cur + p.off_bd);

      // ---- stage A: expand the halo, one (halo M tile, kNA N tiles) a warp ---
      if constexpr (EXPAND) {
        const __nv_bfloat16* w1s = reinterpret_cast<const __nv_bfloat16*>(cur);
        const float* b1s = taps + 9 * CK;
        // B: matrix j is expanded channels 8 * (j / 2).., input channels 8 * (j % 2)..
        const int brow = (lane & 7) + 8 * (lane >> 4);
        const int bcol = 8 * ((lane >> 3) & 1);
        for (int j = 0, item = warp; item < a_items; ++j, item += NW) {
          const int hmt = item / kGroups;
          const int h = item - hmt * kGroups;
          float ea[kNA][4];
#pragma unroll
          for (int nt = 0; nt < kNA; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) ea[nt][r] = 0.f;
          // rows past the last halo position read the last one; never stored
          const __nv_bfloat16* xa = xs + min(hmt * 16 + lrow, NPOS - 1) * XS + lcol;
          const __nv_bfloat16* wb = w1s + (h * 8 * kNA + brow) * XS + bcol;
#pragma unroll 2
          for (int ks = 0; ks < p.cin_pad / 16; ++ks) {
            uint32_t a[4];
            ldsm_x4(a, xa + ks * 16);
#pragma unroll
            for (int jj = 0; jj < kNA / 2; ++jj) {
              uint32_t b[4];
              ldsm_x4(b, wb + 16 * jj * XS + ks * 16);
              mma_bf16(ea[2 * jj], a, b[0], b[1]);
              mma_bf16(ea[2 * jj + 1], a, b[2], b[3]);
            }
          }
          float2 bias[kNA];
#pragma unroll
          for (int nt = 0; nt < kNA; ++nt) bias[nt] = *reinterpret_cast<const float2*>(b1s + h * 8 * kNA + nt * 8 + 2 * tig);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = hmt * 16 + g + 8 * half;
            if (r >= NPOS) continue;
            const bool in = (inside >> (2 * j + half)) & 1u;
#pragma unroll
            for (int nt = 0; nt < kNA; ++nt) {
              const int c = h * 8 * kNA + nt * 8 + 2 * tig;
              uint32_t v = 0u;
              if (in) v = act_pack(ea[nt][2 * half] + bias[nt].x, ea[nt][2 * half + 1] + bias[nt].y, cap2);
              *reinterpret_cast<uint32_t*>(es + r * CW + c) = v;
            }
          }
        }
        __syncthreads();
        // the tile's last reader of xs is done: copy the next tile into it
        if (last && more) {
          copy_tile(t + gridDim.x, xs);
          cp_async_commit();
        }
      }
      // the depthwise's input, position-major: the expanded chunk, or without
      // an expand the input's own channels
      const __nv_bfloat16* src = EXPAND ? es + cpair : xs + turn * xs_elems + k * CK + cpair;
      const int src_w = EXPAND ? CW : XS;

      // ---- stage B: the depthwise, two rows of four outputs by two channels
      // a unit: input row r of the unit's four feeds output row 0 as tap row
      // r and output row 1 as tap row r - 1, each in the order dy, dx
      {
        float2 w[9];
#pragma unroll
        for (int j = 0; j < 9; ++j) w[j] = *reinterpret_cast<const float2*>(taps + j * CK + cpair);
        const float2 bias = *reinterpret_cast<const float2*>(bds + cpair);
        for (int oy = oy_first, xg = xg_first; oy < p.OH;) {
          const bool two = oy + 1 < p.OH;   // the second row lies in the tile
          float2 s[2][4];
#pragma unroll
          for (int o = 0; o < 4; ++o) s[0][o] = s[1][o] = make_float2(0.f, 0.f);
          const int pos0 = oy * IW + 4 * xg;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (r == 3 && !two) break;
            float2 v[6];
#pragma unroll
            for (int j = 0; j < 6; ++j) v[j] = unpack_bf16(lds32(src + (pos0 + r * IW + j) * src_w));
            // output o takes columns o, o+1, o+2 of the row, in that order
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
              for (int o = 0; o < 4; ++o) {
                if (r < 3) {
                  s[0][o].x = fmaf(v[o + dx].x, w[r * 3 + dx].x, s[0][o].x);
                  s[0][o].y = fmaf(v[o + dx].y, w[r * 3 + dx].y, s[0][o].y);
                }
                if (r > 0) {
                  s[1][o].x = fmaf(v[o + dx].x, w[(r - 1) * 3 + dx].x, s[1][o].x);
                  s[1][o].y = fmaf(v[o + dx].y, w[(r - 1) * 3 + dx].y, s[1][o].y);
                }
              }
            }
          }
#pragma unroll
          for (int y = 0; y < 2; ++y) {
            if (y == 1 && !two) break;
#pragma unroll
            for (int o = 0; o < 4; ++o) {
              const int ox = 4 * xg + o;
              if (ox < p.OW) {
                *reinterpret_cast<uint32_t*>(ds + ((oy + y) * p.OW + ox) * CW + cpair) =
                    act_pack(s[y][o].x + bias.x, s[y][o].y + bias.y, cap2);
              }
            }
          }
          oy += step_y;
          xg += step_x;
          if (xg >= p.XG) {
            xg -= p.XG;
            oy += 2;
          }
        }
      }
      __syncthreads();

      // ---- stage C: the project, this warp's PM x PN mma tiles ----------------
      if (has_rect) {
#pragma unroll
        for (int ks = 0; ks < CK / 16; ++ks) {
          // B fragments two N tiles an ldmatrix (matrix j: output channels
          // 8 * (j / 2).., k 8 * (j % 2)..), the last one alone where the
          // block's N tiles end on an odd one
          uint32_t b[PN][2];
#pragma unroll
          for (int j = 0; j < PN; j += 2) {
            const int nt = ng * PN + j;
            if (j + 1 < PN && nt + 1 < ntg) {
              uint32_t r[4];
              ldsm_x4(r, w2s + (co0 + nt * 8 + (lane & 7) + 8 * (lane >> 4)) * CW + ks * 16 + 8 * ((lane >> 3) & 1));
              b[j][0] = r[0];
              b[j][1] = r[1];
              b[j + 1][0] = r[2];
              b[j + 1][1] = r[3];
            } else if (nt < ntg) {
              ldsm_x2(b[j], w2s + (co0 + nt * 8 + (lane & 7)) * CW + ks * 16 + 8 * ((lane >> 3) & 1));
            }
          }
#pragma unroll
          for (int i = 0; i < PM; ++i) {
            const int mt = mg * PM + i;
            if (mt >= p.MT) continue;
            uint32_t a[4];
            ldsm_x4(a, ds + (mt * 16 + lrow) * CW + ks * 16 + lcol);
#pragma unroll
            for (int j = 0; j < PN; ++j) {
              if (ng * PN + j < ntg) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
            }
          }
        }
      }
    }

    // ---- epilogue: + b2 [+ skip, read again from x: xs holds the next tile
    // by now], one bf16 rounding, masked store -----------------------------------
    if (has_rect) {
      const float* b2 = reinterpret_cast<const float*>(p.packed + static_cast<size_t>(p.nchunks) * p.chunk_bytes);
      float2 bias[PN];
#pragma unroll
      for (int j = 0; j < PN; ++j) {
        const int nt = min(ng * PN + j, ntg - 1);
        bias[j] = __ldg(reinterpret_cast<const float2*>(b2 + co0 + nt * 8 + 2 * tig));
      }
#pragma unroll
      for (int i = 0; i < PM; ++i) {
        // the output pixels of this M tile's two rows, -1 off the map
        long long pix[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int yx = out_yx[i][half];
          const int gy = oy0 + (yx >> 16), gx = ox0 + (yx & 0xffff);
          pix[half] = yx >= 0 && gy < H && gx < W ? (static_cast<long long>(img) * H + gy) * W + gx : -1;
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (pix[half] < 0) continue;
          // every load of the skip first, then the stores
          uint32_t sk[PN];
#pragma unroll
          for (int j = 0; j < PN; ++j) {
            const int c = co0 + (ng * PN + j) * 8 + 2 * tig;
            sk[j] = 0u;
            if (p.skip && ng * PN + j < ntg) sk[j] = __ldg(reinterpret_cast<const unsigned int*>(p.x + pix[half] * Cin + c));
          }
          __nv_bfloat16* o = p.out + pix[half] * p.Cout;
#pragma unroll
          for (int j = 0; j < PN; ++j) {
            if (ng * PN + j >= ntg) continue;
            const int c = co0 + (ng * PN + j) * 8 + 2 * tig;
            const float2 x2 = unpack_bf16(sk[j]);
            *reinterpret_cast<uint32_t*>(o + c) = pack_bf16(acc[i][j][2 * half] + bias[j].x + x2.x,
                                                            acc[i][j][2 * half + 1] + bias[j].y + x2.y);
          }
        }
      }
    }
  }
  cp_async_wait_all();   // nothing left in flight when the block ends
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The sizes the plan implies; the same arithmetic as ops/fused_mbconv.py
// (MBConvLayout, mbconv_smem_bytes, fused_mbconv_plans). Returns false if
// the plan does not fit.
bool derive(Params& p, int expand, int ck, int warps, int pm, int pn, int smem_bytes, long long grid_x,
            int grid_y) {
  if (p.OH < 1 || p.OW < 1 || p.OH > p.H || p.OW > p.W) return false;
  p.IW = p.OW + 2;
  p.NPOS = (p.OH + 2) * p.IW;
  p.XG = (p.OW + 3) / 4;
  p.M = p.OH * p.OW;
  p.MT = (p.M + 15) / 16;
  if (p.CG < 8 || p.CG % 8 || (p.Cout + p.CG - 1) / p.CG != grid_y) return false;
  p.ngroups = (p.CG / 8 + pn - 1) / pn;
  p.rects = (p.MT + pm - 1) / pm * p.ngroups;
  if (p.rects > warps) return false;
  p.tiles_x = (p.W + p.OW - 1) / p.OW;
  p.tiles = p.tiles_x * ((p.H + p.OH - 1) / p.OH);
  if (grid_x < 1 || grid_x > static_cast<long long>(p.B) * p.tiles || grid_y > 65535) return false;
  // stage A keeps a bit a row for each of a warp's items
  const int kgroups = ck == 64 ? 2 : 1;
  if (expand && ((p.NPOS + 15) / 16 * kgroups + warps - 1) / warps > 16) return false;
  p.cin_pad = expand ? round_up(p.Cin, 16) : round_up(p.Cin, ck);
  p.XS = p.cin_pad + 8;
  p.nchunks = (p.Ce + ck - 1) / ck;
  const int cw = ck + 8;
  p.off_w2 = expand ? ck * p.XS * 2 : 0;
  p.off_taps = p.off_w2 + p.Cout * cw * 2;
  p.off_bd = p.off_taps + 10 * ck * 4;
  p.chunk_bytes = p.off_bd + ck * 4;
  p.off_es = (p.NPOS + kSpare) * p.XS * 2 * (expand ? 1 : 2);
  p.off_ds = p.off_es + (expand ? (p.NPOS + kSpare) * cw * 2 : 0);
  p.off_buf = p.off_ds + p.MT * 16 * cw * 2;
  const long long smem = static_cast<long long>(p.off_buf) + 2LL * p.chunk_bytes;
  return smem == smem_bytes && smem <= kMaxSmem;
}

template <int CK, int NW, int PM, int PN, bool EXPAND>
int launch(const Params& p, int smem, dim3 grid, cudaStream_t stream) {
  // the dynamic shared memory is asked for once a device
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(mbconv_kernel<CK, NW, PM, PN, EXPAND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    // all of the SM's unified memory as shared memory, so that as many blocks
    // fit as the plan counts on
    e = cudaFuncSetAttribute(mbconv_kernel<CK, NW, PM, PN, EXPAND>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev] = true;
  }
  mbconv_kernel<CK, NW, PM, PN, EXPAND><<<grid, NW * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The (warps, PM, PN) variants the planner may choose (ops/fused_mbconv.py,
// MBCONV_VARIANTS).
template <int CK, bool EXPAND>
int dispatch(const Params& p, int warps, int pm, int pn, int smem, dim3 grid, cudaStream_t stream) {
  if (warps == 8 && pm == 2 && pn == 4) return launch<CK, 8, 2, 4, EXPAND>(p, smem, grid, stream);
  if (warps == 8 && pm == 2 && pn == 8) return launch<CK, 8, 2, 8, EXPAND>(p, smem, grid, stream);
  if (warps == 16 && pm == 1 && pn == 12) return launch<CK, 16, 1, 12, EXPAND>(p, smem, grid, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches B3 on `stream`; returns cudaGetLastError() as an int, or
// cudaErrorInvalidValue for shapes or a plan the kernel does not take.
// x (B,H,W,Cin) bf16 contiguous, 16-byte aligned; packed as
// pack_fused_mbconv lays it out for chunk width ck (32, 48, 64), 16-byte aligned; out
// (B,H,W,Cout) bf16; Cin, Ce, Cout multiples of 8; without an expand Ce ==
// Cin; the skip needs Cin == Cout. The plan (tile_h, tile_w, ck, warps, pm,
// pn, cout_group, smem_bytes, grid_x, grid_y) is plan_fused_mbconv's.
extern "C" int tcf_mbconv(
    const void* x, const void* packed, void* out,
    int B, int H, int W, int Cin, int Ce, int Cout, int has_expand, int has_skip, int relu6,
    int tile_h, int tile_w, int ck, int warps, int pm, int pn, int cout_group, int smem_bytes,
    long long grid_x, int grid_y, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 8 || Cin % 8 || Ce < 8 || Ce % 8 || Cout < 8 || Cout % 8 ||
      (!has_expand && Ce != Cin) || (has_skip && Cin != Cout) || (ck != 32 && ck != 48 && ck != 64) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(packed) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.packed = static_cast<const uint8_t*>(packed);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = B; p.H = H; p.W = W;
  p.Cin = Cin; p.Ce = Ce; p.Cout = Cout;
  p.skip = has_skip;
  p.cap = relu6 ? 6.f : INFINITY;
  p.OH = tile_h;
  p.OW = tile_w;
  p.CG = cout_group;
  if (!derive(p, has_expand, ck, warps, pm, pn, smem_bytes, grid_x, grid_y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y), 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ck == 64) {
    return has_expand ? dispatch<64, true>(p, warps, pm, pn, smem_bytes, grid, s)
                      : dispatch<64, false>(p, warps, pm, pn, smem_bytes, grid, s);
  }
  if (ck == 48) {
    return has_expand ? dispatch<48, true>(p, warps, pm, pn, smem_bytes, grid, s)
                      : dispatch<48, false>(p, warps, pm, pn, smem_bytes, grid, s);
  }
  return has_expand ? dispatch<32, true>(p, warps, pm, pn, smem_bytes, grid, s)
                    : dispatch<32, false>(p, warps, pm, pn, smem_bytes, grid, s);
}
