// int8 1x1 convolution with a requantizing epilogue, planar, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpucenterface/bench/probe_int8_conv.py::
// make_pallas_conv1x1_int8. For x (B, Cin, P) int8, w (Cout, Cin) int8 and
// per-channel float32 scale and bias (Cout):
//   acc[b, c, p] = sum_k w[c, k] * x[b, k, p]                         int32
//   out[b, c, p] = clip(rint(acc * scale[c] + bias[c]), -127, 127)    int8
// The product and the sum are rounded separately (__fmul_rn, __fadd_rn: nvcc
// would otherwise contract them into one FMA, which the JAX function does not
// do), and rint rounds half to even as jnp.round does.
//
// Bound on an H100 SXM: bytes. The kernel reads x once and writes out once,
// B*P*(Cin + Cout) bytes, against 2*B*P*Cin*Cout int8 operations, far below
// the tensor cores' rate at these widths (block 0's project, 32 -> 16 at
// 320x320, bs32: 157 MB, 0.047 ms at 3.35 TB/s). So the kernel is a stream:
// every byte of x is read with wide loads and every output byte written with
// wide stores, with enough loads in flight to keep HBM busy, and the work
// around the mma kept below the memory time.
//
// Design:
// - mma.sync.m16n8k32 (s8 x s8 -> s32) with the output channels in M (the
//   weights are the A fragments) and the pixels in N. Both operands of an int8
//   mma are K-major, and planar x has the pixels contiguous, so x is
//   transposed in registers: lane (g = lane / 4, t = lane % 4) loads VEC
//   bytes (pixels VEC*g .. VEC*g + VEC-1 of a warp step of 8*VEC pixels) of
//   each of the rows k = 4t..4t+3 and 16+4t..16+4t+3 of a K step of 32, and
//   turns each 4x4 byte block (four rows, four pixels) into four words of
//   four k with eight __byte_perm. Those words are the B fragments of VEC n
//   tiles: column g of n tile n is pixel VEC*g + n. The D fragments then
//   leave lane (g, t) holding output channels g and g+8 of an m tile at the
//   2*VEC contiguous pixels 2*VEC*t .. 2*VEC*t + 2*VEC-1, stored as two
//   VEC-byte vectors a channel. No shared memory staging of x and no barrier.
// - Each warp walks (image, pixel step) items on its own, a persistent grid
//   (blockIdx.x) of a few blocks an SM; blockIdx.y picks a slice of output
//   channels whose weights the block stages once in shared memory, in
//   fragment order (one 16-byte read a lane an m tile and K step), with
//   scale and bias. A warp holds the sums of MT m tiles (a group) and loads
//   KC K steps at a time; the next (item, group, chunk)'s loads are issued
//   before the current one's transposes, mma and epilogue, so each warp keeps
//   one chunk in flight while it computes.
// - The launch plan (VEC, byte or vector loads, MT, KC, slice, warps, blocks)
//   comes from the caller (ops/int8_conv.py, plan_int8_conv1x1), which fits
//   it to the shape: VEC 16 at block 0's project, 8 at the model's wider
//   projects, 4 where P is only a multiple of 4, and byte loads and stores
//   (VEC 4) where P or x's address is not. Rows past Cin, channels past Cout
//   and pixels past P are masked. Where even one m tile's weights do not fit
//   in shared memory (Cin past ~14,000) they are read from w at each use.
// - The epilogue converts nothing where Cin <= 255: the sums start at the
//   bits of 1.5 * 2^23 (the first mma's C operand), so one float subtraction
//   gives their exact value while |acc| < 2^22 (128 * 128 * 255 < 2^22); the
//   clipped value plus 1.5 * 2^23 rounds half to even and leaves the int8 in
//   the low byte, and __byte_perm packs four outputs a word. Past Cin 255 the
//   sums start at 0 and are converted with one I2F.
//
// On the card (kernels/sweep_b5.py; PERF.md section 6): block 0's project at
// bs32 takes 0.062 ms, 90% of the rate of a device copy of the same bytes.
// The wide projects (Cin 576 and 960 on a 20x20 map) leave each warp a chain
// of dependent K chunks over one or two items; more K steps a chunk (KC 4
// and 8) or more m tiles a warp (MT 4 and 8 at VEC 4) cost registers, and so
// resident warps, and measured slower: those variants are not compiled.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;   // bytes a block may use on sm_90
constexpr int kMagicMaxCin = 255;  // |acc| < 2^22 for any int8 operands
constexpr int kMagic = 0x4B400000;
constexpr float kMagicF = 12582912.f;

struct Params {
  const int8_t* x;       // (B, Cin, P)
  const int8_t* w;       // (Cout, Cin)
  const float* scale;    // (Cout)
  const float* bias;     // (Cout)
  int8_t* out;           // (B, Cout, P)
  int B, Cin, P, Cout;
  int KS;                // K steps of 32
  int steps;             // pixel steps an image
  int items;             // B * steps
  int slice_mt;          // m tiles of a block's slice of output channels
  int w_unit;            // bytes a read of w: 16, 4 or 1
  int w_smem;            // the slice's weights staged in shared memory (else read from w at each use)
  int off_vec;           // offset of scale and bias in shared memory
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// D (16x8, s32) += A (16x32, s8, row-major) * B (32x8, s8, column-major)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// D = A * B + (c, c, c, c), the shapes of mma_s8
__device__ __forceinline__ void mma_s8_from(int (&d)[4], const uint4& a, uint32_t b0, uint32_t b1, int c) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1), "r"(c));
}

__device__ __forceinline__ uint4 lds128(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(smem_addr(p)));
  return v;
}

// The four bytes w[co, k0 .. k0+3] (zero past Cin) as a word; w_unit 4: one
// aligned read (Cin a multiple of 4), else bytes
__device__ __forceinline__ uint32_t w_word(const Params& p, int co, int k0) {
  const int8_t* row = p.w + static_cast<size_t>(co) * p.Cin;
  if (p.w_unit != 1) return k0 < p.Cin ? __ldg(reinterpret_cast<const uint32_t*>(row + k0)) : 0u;
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (k0 + j < p.Cin) v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(row + k0 + j))) << (8 * j);
  }
  return v;
}

// Lane (g, t)'s A fragment of m tile rows co .. co + 15 and K step ks, from w
__device__ __forceinline__ uint4 w_frag(const Params& p, int co, int ks, int g, int t) {
  const int k0 = 32 * ks + 4 * t;
  const int r0 = co + g, r1 = co + g + 8;
  uint4 a = make_uint4(0, 0, 0, 0);
  if (r0 < p.Cout) {
    a.x = w_word(p, r0, k0);
    a.z = w_word(p, r0, k0 + 16);
  }
  if (r1 < p.Cout) {
    a.y = w_word(p, r1, k0);
    a.w = w_word(p, r1, k0 + 16);
  }
  return a;
}

// Shared memory: the slice's weights in fragment order, tile (mt, ks) at
// (mt * KS + ks) * 512 bytes, lane l's A fragment (a0, a1, a2, a3) at 16 l:
//   a0 = w[16 mt + g, 32 ks + 4 t ..], a1 = w[16 mt + g + 8, 32 ks + 4 t ..],
//   a2 = w[16 mt + g, 32 ks + 16 + 4 t ..], a3 = w[16 mt + g + 8, 32 ks + 16 + 4 t ..]
// (zero past Cout and Cin); then scale and bias, slice_mt * 16 floats each.
// Where the weights do not fit (w_smem 0), only scale and bias.
__device__ void stage_weights(const Params& p, uint8_t* smem, int co0, int mts) {
  uint32_t* wf = reinterpret_cast<uint32_t*>(smem);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  if (p.w_smem && p.w_unit == 16) {
    // 16 bytes of one row (k = 16 q .. 16 q + 15) fill word (row half, k half)
    // of the four lanes t = 0..3 of row group g
    const int quads = p.KS * 2;
    const int n = mts * 16 * quads;
#pragma unroll 4
    for (int i = tid; i < n; i += nthreads) {
      const int r = i / quads;
      const int q = i - r * quads;
      const int co = co0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (co < p.Cout && 16 * q < p.Cin) {
        v = __ldg(reinterpret_cast<const uint4*>(p.w + static_cast<size_t>(co) * p.Cin + 16 * q));
      }
      const int mt = r >> 4, g = r & 7, hi = (r >> 3) & 1;
      const int ks = q >> 1, kh = q & 1;
      uint32_t* dst = wf + (mt * p.KS + ks) * 128 + (g * 4) * 4 + hi + 2 * kh;
      dst[0] = v.x;
      dst[4] = v.y;
      dst[8] = v.z;
      dst[12] = v.w;
    }
  } else if (p.w_smem) {
    const int n = mts * p.KS * 128;
#pragma unroll 4
    for (int i = tid; i < n; i += nthreads) {
      const int word = i & 3, lane = (i >> 2) & 31, tile = i >> 7;
      const int mt = tile / p.KS, ks = tile - mt * p.KS;
      const int co = co0 + 16 * mt + (lane >> 2) + 8 * (word & 1);
      const int k0 = 32 * ks + 4 * (lane & 3) + 16 * (word >> 1);
      wf[i] = co < p.Cout ? w_word(p, co, k0) : 0u;
    }
  }
  float* sv = reinterpret_cast<float*>(smem + p.off_vec);
  for (int i = tid; i < p.slice_mt * 16; i += nthreads) {
    const int co = co0 + i;
    sv[i] = co < p.Cout ? p.scale[co] : 0.f;
    sv[p.slice_mt * 16 + i] = co < p.Cout ? p.bias[co] : 0.f;
  }
}

// Row i (0..7) of lane (g, t)'s loads in K step ks is k = 32 ks + 4 t + (i & 3)
// + 16 (i >> 2); its VEC bytes (pixels pix .. pix + VEC-1) go to words
// r[i * VEC / 4 ..]. Rows past Cin and pixels past P read as zero.
template <int VEC, bool BYTES>
__device__ __forceinline__ void load_step(uint32_t (&r)[2 * VEC], const Params& p, const int8_t* xb, int ks, int t,
                                          int pix) {
  constexpr int W = VEC / 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = 32 * ks + 4 * t + (i & 3) + 16 * (i >> 2);
    const int8_t* src = xb + static_cast<size_t>(k) * p.P + pix;
    if constexpr (BYTES) {
      uint32_t v = 0;
      if (k < p.Cin) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (pix + j < p.P) v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + j))) << (8 * j);
        }
      }
      r[i] = v;
    } else {
      const bool in = k < p.Cin && pix < p.P;
      if constexpr (VEC == 16) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (in) v = __ldg(reinterpret_cast<const uint4*>(src));
        r[i * W] = v.x;
        r[i * W + 1] = v.y;
        r[i * W + 2] = v.z;
        r[i * W + 3] = v.w;
      } else if constexpr (VEC == 8) {
        uint2 v = make_uint2(0, 0);
        if (in) v = __ldg(reinterpret_cast<const uint2*>(src));
        r[i * W] = v.x;
        r[i * W + 1] = v.y;
      } else {
        r[i] = in ? __ldg(reinterpret_cast<const uint32_t*>(src)) : 0u;
      }
    }
  }
}

// The B fragments of the VEC n tiles of one K step: for rows 4h .. 4h+3 and
// word v, the 4x4 byte block (row i, pixel j) becomes the words b[4v + j][h]
// of bytes (row 0..3, pixel j)
template <int VEC>
__device__ __forceinline__ void transpose(uint32_t (&b)[VEC][2], const uint32_t (&r)[2 * VEC]) {
  constexpr int W = VEC / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int v = 0; v < W; ++v) {
      const uint32_t r0 = r[(4 * h) * W + v], r1 = r[(4 * h + 1) * W + v];
      const uint32_t r2 = r[(4 * h + 2) * W + v], r3 = r[(4 * h + 3) * W + v];
      const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
      const uint32_t t2 = __byte_perm(r2, r3, 0x5140), t3 = __byte_perm(r2, r3, 0x7362);
      b[4 * v][h] = __byte_perm(t0, t2, 0x5410);
      b[4 * v + 1][h] = __byte_perm(t0, t2, 0x7632);
      b[4 * v + 2][h] = __byte_perm(t1, t3, 0x5410);
      b[4 * v + 3][h] = __byte_perm(t1, t3, 0x7632);
    }
  }
}

// clip(rint(acc * s + b), -127, 127) in the low byte; MAGIC: acc started at kMagic
template <bool MAGIC>
__device__ __forceinline__ uint32_t requant_bits(int acc, float s, float b) {
  const float a = MAGIC ? __fsub_rn(__int_as_float(acc), kMagicF) : __int2float_rn(acc);
  const float y = __fadd_rn(__fmul_rn(a, s), b);
  return __float_as_uint(__fadd_rn(fminf(fmaxf(y, -127.f), 127.f), kMagicF));
}

// the low bytes of q0..q3 as one word
__device__ __forceinline__ uint32_t pack4(uint32_t q0, uint32_t q1, uint32_t q2, uint32_t q3) {
  return __byte_perm(__byte_perm(q0, q1, 0x0040), __byte_perm(q2, q3, 0x0040), 0x5410);
}

// VEC bytes (VEC / 4 words) to dst, or the first n < VEC of them byte by byte
template <int VEC, bool BYTES>
__device__ __forceinline__ void store_vec(int8_t* dst, const uint32_t (&q)[VEC / 4], int n) {
  if constexpr (BYTES) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (j < n) dst[j] = static_cast<int8_t>(q[j / 4] >> (8 * (j % 4)));
    }
  } else {
    if (n <= 0) return;
    if constexpr (VEC == 16) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(q[0], q[1], q[2], q[3]);
    } else if constexpr (VEC == 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(q[0], q[1]);
    } else {
      *reinterpret_cast<uint32_t*>(dst) = q[0];
    }
  }
}

template <int VEC, bool BYTES, int MT, int KC, bool MAGIC>
__global__ void __launch_bounds__(256) conv1x1_int8_kernel(const Params p) {
  constexpr int NPIX = 8 * VEC;
  constexpr int W = VEC / 4;
  extern __shared__ __align__(16) uint8_t smem[];
  const float* sc = reinterpret_cast<const float*>(smem + p.off_vec);
  const float* bi = sc + p.slice_mt * 16;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int co0 = blockIdx.y * p.slice_mt * 16;
  const int left = (p.Cout - co0 + 15) / 16;
  const int mts = left < p.slice_mt ? left : p.slice_mt;
  stage_weights(p, smem, co0, mts);
  __syncthreads();

  const int nw = blockDim.x >> 5;
  const int stride = gridDim.x * nw;
  const int groups = (mts + MT - 1) / MT;
  const int chunks = (p.KS + KC - 1) / KC;
  int item = blockIdx.x * nw + (threadIdx.x >> 5);
  if (item >= p.items) return;

  // the current step (item, group, chunk) and its x
  int img = item / p.steps;
  int p0 = (item - img * p.steps) * NPIX;
  int grp = 0, c = 0;
  uint32_t raw[KC][2 * VEC];
  {
    const int8_t* xb = p.x + static_cast<size_t>(img) * p.Cin * p.P;
#pragma unroll
    for (int u = 0; u < KC; ++u) load_step<VEC, BYTES>(raw[u], p, xb, u, t, p0 + VEC * g);
  }
  int acc[MT][VEC][4];
  while (true) {
    // the next step's loads go out first
    int nitem = item, nimg = img, np0 = p0, ngrp = grp, nc = c + 1;
    if (nc == chunks) {
      nc = 0;
      if (++ngrp == groups) {
        ngrp = 0;
        nitem += stride;
        nimg = nitem / p.steps;
        np0 = (nitem - nimg * p.steps) * NPIX;
      }
    }
    const bool more = nitem < p.items;
    uint32_t nraw[KC][2 * VEC];
    if (more) {
      const int8_t* xb = p.x + static_cast<size_t>(nimg) * p.Cin * p.P;
#pragma unroll
      for (int u = 0; u < KC; ++u) load_step<VEC, BYTES>(nraw[u], p, xb, nc * KC + u, t, np0 + VEC * g);
    }

#pragma unroll
    for (int u = 0; u < KC; ++u) {
      const int ks = c * KC + u;
      if (ks < p.KS) {
        uint32_t b[VEC][2];
        transpose<VEC>(b, raw[u]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int m = grp * MT + mt;
          if (m < mts) {
            const uint4 a = p.w_smem ? lds128(smem + (m * p.KS + ks) * 512 + 16 * lane)
                                     : w_frag(p, co0 + 16 * m, ks, g, t);
#pragma unroll
            for (int n = 0; n < VEC; ++n) {
              if (u == 0 && c == 0) {
                mma_s8_from(acc[mt][n], a, b[n][0], b[n][1], MAGIC ? kMagic : 0);
              } else {
                mma_s8(acc[mt][n], a, b[n][0], b[n][1]);
              }
            }
          }
        }
      }
    }

    if (c == chunks - 1) {
      // channels g and g + 8 of each m tile at pixels p0 + 2 VEC t .. + 2 VEC - 1
      const int pix = p0 + 2 * VEC * t;
      int8_t* ob = p.out + static_cast<size_t>(img) * p.Cout * p.P + pix;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = grp * MT + mt;
        if (m < mts) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int lc = 16 * m + g + 8 * h;
            const float s = sc[lc], bb = bi[lc];
            uint32_t q0[W], q1[W];
#pragma unroll
            for (int v = 0; v < W; ++v) {
              q0[v] = pack4(requant_bits<MAGIC>(acc[mt][4 * v][2 * h], s, bb),
                            requant_bits<MAGIC>(acc[mt][4 * v + 1][2 * h], s, bb),
                            requant_bits<MAGIC>(acc[mt][4 * v + 2][2 * h], s, bb),
                            requant_bits<MAGIC>(acc[mt][4 * v + 3][2 * h], s, bb));
              q1[v] = pack4(requant_bits<MAGIC>(acc[mt][4 * v][2 * h + 1], s, bb),
                            requant_bits<MAGIC>(acc[mt][4 * v + 1][2 * h + 1], s, bb),
                            requant_bits<MAGIC>(acc[mt][4 * v + 2][2 * h + 1], s, bb),
                            requant_bits<MAGIC>(acc[mt][4 * v + 3][2 * h + 1], s, bb));
            }
            if (co0 + lc < p.Cout) {
              int8_t* dst = ob + static_cast<size_t>(co0 + lc) * p.P;
              store_vec<VEC, BYTES>(dst, q0, p.P - pix);
              store_vec<VEC, BYTES>(dst + VEC, q1, p.P - pix - VEC);
            }
          }
        }
      }
    }

    if (!more) break;
    item = nitem;
    img = nimg;
    p0 = np0;
    grp = ngrp;
    c = nc;
#pragma unroll
    for (int u = 0; u < KC; ++u)
#pragma unroll
      for (int i = 0; i < 2 * VEC; ++i) raw[u][i] = nraw[u][i];
  }
}

using Kernel = void (*)(const Params);

// The variants the planner may choose (ops/int8_conv.py, VARIANTS):
// (VEC, byte loads, MT, KC), each with the magic epilogue and the cvt one.
#define TCF_B5_VARIANTS(X) \
  X(16, false, 1, 1)       \
  X(16, false, 2, 1)       \
  X(16, false, 1, 2)       \
  X(8, false, 1, 1)        \
  X(8, false, 2, 1)        \
  X(8, false, 4, 1)        \
  X(8, false, 1, 2)        \
  X(8, false, 2, 2)        \
  X(4, false, 2, 2)        \
  X(4, true, 2, 2)

Kernel pick(int vec, bool bytes, int mt, int kc, bool magic) {
#define TCF_B5_PICK(V, BY, M, K)                                                   \
  if (vec == V && bytes == BY && mt == M && kc == K) {                             \
    return magic ? conv1x1_int8_kernel<V, BY, M, K, true> : conv1x1_int8_kernel<V, BY, M, K, false>; \
  }
  TCF_B5_VARIANTS(TCF_B5_PICK)
#undef TCF_B5_PICK
  return nullptr;
}

}  // namespace

// Launches the conv on `stream` with a plan of ops/int8_conv.py
// (plan_int8_conv1x1). cfg holds 13 ints: B, Cin, P, Cout, then the plan:
// VEC pixels a lane a row (16, 8 or 4), byte loads and stores (1) or
// vectors (0), MT m tiles a warp holds, KC K steps a chunk, slice_mt m tiles
// a block's slice of output channels, whether their weights are staged in
// shared memory (w_smem; else read from w at each use, for a Cin whose
// weights do not fit), warps a block, blocks a slice, smem_bytes of dynamic
// shared memory. Returns cudaGetLastError() as an int, or
// cudaErrorInvalidValue for a shape or a plan the kernel does not take.
// x (B, Cin, P) int8, w (Cout, Cin) int8, scale and bias (Cout) float32,
// out (B, Cout, P) int8, all contiguous; x and out aligned to VEC bytes and P
// a multiple of VEC unless bytes.
extern "C" int tcf_int8_conv1x1(const void* x, const void* w, const void* scale, const void* bias, void* out,
                                const int* cfg, void* stream) {
  const int B = cfg[0], Cin = cfg[1], P = cfg[2], Cout = cfg[3];
  const int vec = cfg[4], bytes = cfg[5], mt = cfg[6], kc = cfg[7], slice_mt = cfg[8], w_smem = cfg[9];
  const int warps = cfg[10], blocks = cfg[11], smem_bytes = cfg[12];
  const bool magic = Cin <= kMagicMaxCin;
  const Kernel kernel = pick(vec, bytes != 0, mt, kc, magic);
  const int npix = 8 * vec;
  if (kernel == nullptr || B < 1 || Cin < 1 || P < 1 || Cout < 1 || warps < 1 || warps > 8 || blocks < 1 ||
      slice_mt < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!bytes && (P % vec || reinterpret_cast<uintptr_t>(x) % vec || reinterpret_cast<uintptr_t>(out) % vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<int8_t*>(out);
  p.B = B;
  p.Cin = Cin;
  p.P = P;
  p.Cout = Cout;
  p.KS = (Cin + 31) / 32;
  p.steps = (P + npix - 1) / npix;
  const long long items = static_cast<long long>(B) * p.steps;
  const int slices = (Cout + 16 * slice_mt - 1) / (16 * slice_mt);
  if (items > 2147483647LL || slices > 65535) return static_cast<int>(cudaErrorInvalidValue);
  p.items = static_cast<int>(items);
  p.slice_mt = slice_mt;
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  p.w_unit = Cin % 16 == 0 && wa % 16 == 0 ? 16 : Cin % 4 == 0 && wa % 4 == 0 ? 4 : 1;
  p.w_smem = w_smem != 0;
  const long long off_vec = p.w_smem ? 512LL * slice_mt * p.KS : 0;
  const long long smem = off_vec + 128LL * slice_mt;
  if (smem != smem_bytes || smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  p.off_vec = static_cast<int>(off_vec);

  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(slices)), warps * 32, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread and local memory bytes a thread of one variant, as the
// card's compiled kernel has them (kernels/sweep_b5.py and chip_smoke.py hold
// the planner's table to them). Returns a CUDA error code as an int.
extern "C" int tcf_int8_conv1x1_attr(int vec, int bytes, int mt, int kc, int magic, int* regs, int* local_bytes) {
  const Kernel kernel = pick(vec, bytes != 0, mt, kc, magic != 0);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
