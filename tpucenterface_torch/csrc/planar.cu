// One MobileNetV2 inverted-residual block (stride 1) on the row-padded planar
// layout, for Hopper (sm_90a). The chain of N blocks in one launch is
// csrc/planar_chain.cu.
//
// Replaces the TPU kernel of tpucenterface/ops/planar_mbconv.py:
//   tcf_planar_mbconv  <-  planar_mbconv        (kernel _kernel)
//
// Layout: activations (B, C, H*Wp) bf16, channel planes of H rows of Wp pixels;
// columns W..Wp-1 of a row are pad columns, read as zeros whatever they hold and
// written as zeros. Per block
//   e = bf16(act(w1 x + b1)), 0 outside the image and at the pad columns
//   e = x there without an expand
//   d = bf16(act(sum_{dy,dx} f32(e[y+dy, x+dx]) * wd[dy, dx] + bd))
//         nine taps in the order dy, dx from a zero float32 accumulator; wd and
//         bd are float32 and each product is rounded before it is added (no
//         fused multiply-add: the product of a bf16 and a float32 is not exact)
//   p = w2 d + b2 [+ x]           bf16 operands, float32 sums
// with b1, wd, bd, b2 in float32. tcf_planar_mbconv writes p as float32.
//
// The TPU kernel keeps a whole image and its 6x expanded tensor in on-chip
// memory; an SM has 227 KB, so nothing of that carries over. Here:
// - a work item is one tile of up to 256 output positions of one image (and
//   one group of up to 96 output channels). The tile's sides are chosen per
//   launch to fit the map (choose_tile: 16x16 on large maps, 20x10 on a 20x20
//   or 40x40 map, the whole map at 10x10). Its input tile with a halo of one,
//   at most 324 positions, sits in shared memory, position-major, for the
//   whole item; the expanded channels go by in chunks of 32: stage A expands
//   the halo'd positions with mma.sync.m16n8k16 into shared memory (zeros
//   outside the image, masked by index, so pad columns cost nothing and their
//   contents never matter);
//   stage B computes the depthwise for exactly the (position, channel) pairs
//   that are a thread's A fragments of the project; stage C accumulates the
//   project in registers over all chunks. Weights are streamed chunk by chunk
//   from device memory (they stay in L2). The expanded tensor never leaves the
//   SM. Neighbouring tiles recompute each other's halo, and output channels
//   beyond 96 are further items that recompute stages A and B.
//
// Bound on an H100 SXM: x, out and the weights once over 3.35 TB/s against the
// two products over 989 TFLOP/s and the depthwise over 67 TFLOP/s; at the
// model's shapes the depthwise term and the bytes are of one order. This
// version is far from it: one thread block of eight warps an SM leaves every
// latency in the open (each chunk waits for its weights, a fifth of the time),
// the transposing tile load is made of 2-byte loads, stage B makes one 32-bit
// shared load per two multiply-adds, and outputs wider than 96 channels
// recompute the expand and the depthwise. wgmma and TMA are later work.
//
// Not bit-equal to a float32 matrix product of the same bf16 operands: the
// tensor cores sum in another order, so a value next to a bf16 rounding
// boundary can land one bf16 step away. The depthwise keeps its sum order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTilePos = 256;               // most output positions of a tile: 16 M tiles
constexpr int kHaloPos = 324;               // most positions of a tile with its halo (18x18)
constexpr int CK = 32;                      // expanded channels per chunk
constexpr int NT = 12;                      // 8-wide output-channel tiles per item
constexpr int ES = CK + 8;                  // row stride of the expanded chunk
constexpr int kMaxCin = 256;
constexpr int kMaxSmem = 232448;            // bytes a block may use on sm_90
constexpr int kMaxDevices = 64;            // device ordinals these entry points keep state for

struct Block {
  const __nv_bfloat16* w1;   // (Ce, Cin) or null: no expand
  const float* b1;           // (Ce) or null
  const float* wd;           // (Ce, 9), tap dy*3+dx
  const float* bd;           // (Ce)
  const __nv_bfloat16* w2;   // (Cout, Ce)
  const float* b2;           // (Cout)
  int cin, ce, cout, has_skip;
};

struct Geometry {
  int B, H, W, Wp, relu6;
  int tw, th;             // a tile's width and height in output positions
  int tiles_x, tiles_y;   // tiles across and down the map
};

__host__ __device__ constexpr int pad16(int c) { return (c + 15) / 16 * 16; }

// Shared memory, in this order (row strides in bf16 elements; the +8 keeps the
// 32-bit fragment loads of eight consecutive rows on distinct banks):
//   xs  [kHaloPos][cin_pad + 8]   input tile with halo, zero outside the image
//   es  [kHaloPos][CK + 8]        expanded chunk
//   w1s [CK][cin_pad + 8]         w1 chunk (expanded channel major)
//   w2s [NT * 8][CK + 8]          w2 chunk (output channel major)
//   wds [9][CK] f32, b1s [CK] f32, bds [CK] f32
//   where [kHaloPos] i32  row * Wp + column of each position of the tile with
//                         its halo, -1 outside the image
//   offs [kTilePos] u16   halo position of each output position's window origin
// (the two tables keep the divisions by the tile's run-time sides out of the loops)
__host__ __device__ constexpr size_t smem_bytes(int cin_pad) {
  return static_cast<size_t>(kHaloPos + CK) * (cin_pad + 8) * 2 +
         static_cast<size_t>(kHaloPos + NT * 8) * ES * 2 + 11 * CK * 4 + kHaloPos * 4 + kTilePos * 2;
}

__host__ __device__ inline int items_of(const Block& k, const Geometry& g) {
  return g.B * g.tiles_x * g.tiles_y * ((k.cout + NT * 8 - 1) / (NT * 8));
}

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

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// D (16x8, f32) += A (16x16, bf16, row-major) * B (16x8, bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One work item of one block: a tile of one image, one group of up to 96
// output channels. Output position p of the tile is (p / tw, p % tw); M tile m
// of the project holds positions 16m..16m+15, and warp w computes M tiles w
// and w + 8.
template <typename OutT>
__device__ void run_item(const Block& k, const Geometry& geo, const __nv_bfloat16* in, OutT* out,
                         int item, unsigned char* smem) {
  const int H = geo.H, W = geo.W, Wp = geo.Wp, relu6 = geo.relu6;
  const int Cin = k.cin, Ce = k.ce, Cout = k.cout;
  const bool has_expand = k.w1 != nullptr;
  const int cin_pad = pad16(Cin);
  const int XS = cin_pad + 8;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* es = xs + kHaloPos * XS;
  __nv_bfloat16* w1s = es + kHaloPos * ES;
  __nv_bfloat16* w2s = w1s + CK * XS;
  float* wds = reinterpret_cast<float*>(w2s + NT * 8 * ES);
  float* b1s = wds + 9 * CK;
  float* bds = b1s + CK;
  int* where = reinterpret_cast<int*>(bds + CK);
  uint16_t* offs = reinterpret_cast<uint16_t*>(where + kHaloPos);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;     // fragment row group
  const int tig = lane & 3;    // thread in group

  const int tw = geo.tw, th = geo.th;
  const int hw = tw + 2;                          // width of the tile with its halo
  const int hpos = hw * (th + 2);                 // positions of the tile with its halo
  const int npos = tw * th;                       // output positions
  const int n_hmt = (hpos + 15) / 16;             // M tiles of the expand
  const int n_mt = (npos + 15) / 16;              // M tiles of the project
  const int groups = (Cout + NT * 8 - 1) / (NT * 8);
  int rest = item;
  const int group = rest % groups; rest /= groups;
  const int tx0 = (rest % geo.tiles_x) * tw; rest /= geo.tiles_x;
  const int ty0 = (rest % geo.tiles_y) * th;
  const int img = rest / geo.tiles_y;
  const int co0 = group * (NT * 8);              // first output channel
  const int co_n = min(Cout - co0, NT * 8);      // output channels here
  const int nt_used = (co_n + 7) / 8;
  const size_t plane = static_cast<size_t>(H) * Wp;

  __syncthreads();  // the previous item's readers of shared memory are done

  for (int pos = tid; pos < hpos; pos += kThreads) {
    const int hy = pos / hw;
    const int gy = ty0 - 1 + hy;
    const int gx = tx0 - 1 + (pos - hy * hw);
    where[pos] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? gy * Wp + gx : -1;
  }
  // positions past the tile's last read the first window; never stored
  for (int p = tid; p < kTilePos; p += kThreads) {
    offs[p] = p < npos ? static_cast<uint16_t>((p / tw) * hw + p % tw) : 0;
  }
  __syncthreads();

  // ---- input tile with halo, transposed to position-major; zeros outside
  // the image (pad columns are outside) and in the K padding. A thread takes
  // every fourth channel of one position; a warp's loads of one channel are
  // consecutive pixels of a row ------------------------------------------------
  {
    const __nv_bfloat16* xb = in + static_cast<size_t>(img) * Cin * plane;
    for (int i = tid; i < 4 * hpos; i += kThreads) {
      const int q = i / hpos;
      const int pos = i - q * hpos;
      const int off = where[pos];
      __nv_bfloat16* dst = xs + pos * XS;
      for (int c = q; c < cin_pad; c += 16) {   // four loads in flight; cin_pad is a multiple of 16
        __nv_bfloat16 v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = (off >= 0 && c + 4 * j < Cin) ? xb[(c + 4 * j) * plane + off] : __float2bfloat16_rn(0.f);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[c + 4 * j] = v[j];
      }
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

    // ---- this chunk's weights: eight values a load where the rows of w1 and
    // w2 are multiples of eight long (then every row starts on 16 bytes, and a
    // group of eight lies wholly inside the weights or wholly in the padding) ----
    if (has_expand && Cin % 8 == 0) {
      const int per_row = cin_pad / 8;
      for (int i = tid; i < CK * per_row; i += kThreads) {
        const int n = i / per_row;
        const int kk = (i - n * per_row) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (kk < Cin && ce0 + n < Ce) v = *reinterpret_cast<const uint4*>(k.w1 + static_cast<size_t>(ce0 + n) * Cin + kk);
        *reinterpret_cast<uint4*>(w1s + n * XS + kk) = v;
      }
    } else if (has_expand) {
      for (int i = tid; i < CK * cin_pad; i += kThreads) {
        const int n = i / cin_pad;
        const int kk = i - n * cin_pad;
        __nv_bfloat16 v = __float2bfloat16_rn(0.f);
        if (kk < Cin && ce0 + n < Ce) v = k.w1[static_cast<size_t>(ce0 + n) * Cin + kk];
        w1s[n * XS + kk] = v;
      }
    }
    if (Ce % 8 == 0) {
      for (int i = tid; i < NT * 8 * (CK / 8); i += kThreads) {
        const int n = i / (CK / 8);
        const int kk = (i - n * (CK / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (ce0 + kk < Ce && n < co_n) v = *reinterpret_cast<const uint4*>(k.w2 + static_cast<size_t>(co0 + n) * Ce + ce0 + kk);
        *reinterpret_cast<uint4*>(w2s + n * ES + kk) = v;
      }
    } else {
      for (int i = tid; i < NT * 8 * CK; i += kThreads) {
        const int n = i / CK;
        const int kk = i - n * CK;
        __nv_bfloat16 v = __float2bfloat16_rn(0.f);
        if (ce0 + kk < Ce && n < co_n) v = k.w2[static_cast<size_t>(co0 + n) * Ce + ce0 + kk];
        w2s[n * ES + kk] = v;
      }
    }
    for (int i = tid; i < 11 * CK; i += kThreads) {
      const int row = i / CK;   // 0..8 depthwise taps, 9 b1, 10 bd
      const int c = i - row * CK;
      float v = 0.f;
      if (ce0 + c < Ce) {
        if (row < 9) v = k.wd[static_cast<size_t>(ce0 + c) * 9 + row];
        else if (row == 9) v = has_expand ? k.b1[ce0 + c] : 0.f;
        else v = k.bd[ce0 + c];
      }
      wds[i] = v;   // b1s and bds follow wds
    }
    __syncthreads();

    // ---- stage A: expand the halo'd tile for this chunk ---------------------
    if (has_expand) {
      const int ksteps = cin_pad / 16;
      for (int mt = warp; mt < n_hmt; mt += kWarps) {
        float ea[CK / 8][4];
#pragma unroll
        for (int nt = 0; nt < CK / 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) ea[nt][j] = 0.f;
        const int r0 = mt * 16 + g;
        const int r1 = r0 + 8;
        // rows past the last halo position read the last one; never stored
        const __nv_bfloat16* xa0 = xs + min(r0, hpos - 1) * XS + 2 * tig;
        const __nv_bfloat16* xa1 = xs + min(r1, hpos - 1) * XS + 2 * tig;
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
          if (r >= hpos) continue;
          const bool inside = where[r] >= 0;
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
      // no expand: the chunk is the input's own channels (zero outside the image)
      for (int i = tid; i < hpos * (CK / 2); i += kThreads) {
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
        const int m = warp + kWarps * mt;   // M tile: the same for the whole warp
        if (m >= n_mt) continue;
        uint32_t a[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // a0: (p=g, c0), a1: (p=g+8, c0), a2: (p=g, c0+8), a3: (p=g+8, c0+8)
          const int h = j >> 1;
          const __nv_bfloat16* e = es + offs[m * 16 + g + 8 * (j & 1)] * ES + c0 + 8 * h;
          float2 s = make_float2(0.f, 0.f);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const float2 v = unpack_bf16(lds32(e + (dy * hw + dx) * ES));
              // product rounded, then added: not an fma (see the header)
              s.x = __fadd_rn(s.x, __fmul_rn(v.x, tap[h][dy * 3 + dx].x));
              s.y = __fadd_rn(s.y, __fmul_rn(v.y, tap[h][dy * 3 + dx].y));
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

  // ---- epilogue: + b2 [+ skip], masked store into the channel planes --------
  OutT* ob = out + static_cast<size_t>(img) * Cout * plane;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = (warp + kWarps * mt) * 16 + g + 8 * half;
      if (p >= npos) continue;
      const int self = offs[p] + hw + 1;   // the position itself among the halo'd ones
      if (where[self] < 0) continue;
      const __nv_bfloat16* xc = xs + self * XS;
      OutT* o = ob + where[self];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = co0 + nt * 8 + 2 * tig + j;
          if (nt < nt_used && c < Cout) {
            float v = acc[mt][nt][2 * half + j] + k.b2[c];
            if (k.has_skip) v += __bfloat162float(xc[c]);
            store_out(o + c * plane, v);
          }
        }
      }
    }
  }
}

// Zeros in the pad columns of `out` (B, C, H*Wp), by the whole grid.
template <typename OutT>
__device__ void zero_pad_columns(OutT* out, int C, const Geometry& g) {
  const int pad = g.Wp - g.W;
  const size_t n = static_cast<size_t>(g.B) * C * g.H * pad;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * kThreads) {
    const size_t row = i / pad;
    store_out(out + row * g.Wp + g.W + (i - row * pad), 0.f);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
planar_block_kernel(const Block k, const Geometry g, const __nv_bfloat16* x, float* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int items = items_of(k, g);
  for (int item = blockIdx.x; item < items; item += gridDim.x) run_item<float>(k, g, x, out, item, smem);
  zero_pad_columns(out, k.cout, g);
}

// Fills `k` from six pointers and (Cin, Ce, Cout, skip); false if they are not
// a block these kernels take.
bool read_block(Block& k, const void* const* ptr, const int* dims) {
  k.w1 = static_cast<const __nv_bfloat16*>(ptr[0]);
  k.b1 = static_cast<const float*>(ptr[1]);
  k.wd = static_cast<const float*>(ptr[2]);
  k.bd = static_cast<const float*>(ptr[3]);
  k.w2 = static_cast<const __nv_bfloat16*>(ptr[4]);
  k.b2 = static_cast<const float*>(ptr[5]);
  k.cin = dims[0]; k.ce = dims[1]; k.cout = dims[2]; k.has_skip = dims[3];
  if (k.cin < 1 || k.ce < 1 || k.cout < 1 || k.cin > kMaxCin) return false;
  if (!k.wd || !k.bd || !k.w2 || !k.b2 || ((k.w1 == nullptr) != (k.b1 == nullptr))) return false;
  if (!k.w1 && k.ce != k.cin) return false;
  if (k.has_skip && k.cin != k.cout) return false;
  return true;
}

// The tile for an H x W map: of all widths and heights that fit (at most
// kTilePos positions, kHaloPos with the halo), the pair that covers the map at
// the least cost, and of those the one with the fewest tiles. The cost counts
// rounds of the eight warps over a tile's M tiles: those of the expand once,
// those of the depthwise and the project twice. A tile is at least 16
// positions wide where the map is, so that the loads and stores of a tile row
// stay contiguous.
void choose_tile(Geometry& g) {
  long best = -1;
  const auto rounds = [](int positions) { return (positions + 16 * kWarps - 1) / (16 * kWarps); };
  for (int tw = std::min(g.W, 16); tw <= std::min(g.W, kTilePos); ++tw) {
    for (int th = 1; th <= g.H && tw * th <= kTilePos && (tw + 2) * (th + 2) <= kHaloPos; ++th) {
      const int nx = (g.W + tw - 1) / tw, ny = (g.H + th - 1) / th;
      const long cost = static_cast<long>(nx) * ny * (rounds((tw + 2) * (th + 2)) + 2 * rounds(tw * th));
      if (best < 0 || cost < best || (cost == best && nx * ny < g.tiles_x * g.tiles_y)) {
        best = cost;
        g.tw = tw; g.th = th; g.tiles_x = nx; g.tiles_y = ny;
      }
    }
  }
}

// Checks the map's sizes and chooses its tile.
bool good_geometry(Geometry& g) {
  if (g.B < 1 || g.H < 1 || g.W < 1 || g.Wp < g.W) return false;
  if (static_cast<long long>(g.H) * g.Wp >= (1LL << 31)) return false;   // offsets in a plane are ints
  choose_tile(g);
  return static_cast<long long>(g.B) * g.tiles_x * g.tiles_y < (1 << 24);
}

// More than 48 KB of dynamic shared memory is an opt-in of a kernel on a
// device: asked for once for each, at the most these kernels take. Two threads
// that both ask do no harm.
cudaError_t allow_max_smem(const void* kernel, bool (&asked)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (asked[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSmem));
  asked[dev] = e == cudaSuccess;
  return e;
}

}  // namespace

// One block, output float32 (B, Cout, H*Wp). Launches on `stream`; returns the
// CUDA error of the launch as an int (0: launched). x (B, Cin, H*Wp) bf16,
// contiguous; `ptrs` holds w1 (Ce, Cin) bf16 or null, b1 (Ce) f32 or null,
// wd (Ce, 9) f32, bd (Ce) f32, w2 (Cout, Ce) bf16, b2 (Cout) f32, all on the
// device; `dims` holds Cin, Ce, Cout, skip (host memory).
extern "C" int tcf_planar_mbconv(
    const void* x, void* out, const void* const* ptrs, const int* dims,
    int B, int H, int W, int Wp, int relu6, void* stream) {
  Block k;
  Geometry g{B, H, W, Wp, relu6, 0, 0, 0, 0};
  if (!x || !out || !ptrs || !dims || !good_geometry(g) || !read_block(k, ptrs, dims)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(pad16(k.cin));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static bool asked[kMaxDevices] = {};
  const cudaError_t e = allow_max_smem(reinterpret_cast<const void*>(planar_block_kernel), asked);
  if (e != cudaSuccess) return static_cast<int>(e);
  planar_block_kernel<<<items_of(k, g), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      k, g, static_cast<const __nv_bfloat16*>(x), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
