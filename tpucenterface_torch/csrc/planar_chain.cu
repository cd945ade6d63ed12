// MobileNetV2 inverted-residual blocks (stride 1) on the row-padded planar
// layout, for Hopper (sm_90a): a chain of N blocks in ONE cooperative launch,
// and one block alone.
//
// Replaces the TPU kernels of tpucenterface/ops/planar_mbconv.py:
//   tcf_planar_chain  <-  planar_mbconv_chain  (kernel _chain_kernel)
//   tcf_planar_block  <-  planar_mbconv        (kernel _kernel)
// The one-block kernel's design follows the chain's, below it.
//
// Layout: activations (B, C, H*Wp) bf16, channel planes of H rows of Wp pixels;
// columns W..Wp-1 of a row are pad columns, read as zeros whatever they hold and
// written as zeros in the output. Per block
//   e = bf16(act(w1 x + b1)), 0 outside the image and at the pad columns
//   e = x there without an expand
//   d = bf16(act(sum_{dy,dx} f32(e[y+dy, x+dx]) * wd[dy, dx] + bd))
//         nine taps in the order dy, dx from a zero float32 accumulator; wd and
//         bd are float32 and each product is rounded before it is added (no
//         fused multiply-add: the product of a bf16 and a float32 is not exact)
//   p = w2 d + b2 [+ x]           bf16 operands, float32 sums
// with b1, wd, bd, b2 in float32; p is rounded to bf16 after every block and
// feeds the next.
//
// Bound on an H100 SXM: x, out and the weights once over 3.35 TB/s against the
// two products over 989 TFLOP/s and the depthwise over 67 TFLOP/s; the
// depthwise is the largest term at the model's shapes, and without a fused
// multiply-add it takes two float32 instructions a tap. What holds a block
// back on this card is latency inside a thread block, not the tensor cores
// or the memory: a chunk's expand, depthwise and project are short chains of
// dependent shared-memory loads and arithmetic split over 16 warps, between
// barriers, and a clock64 profile of the phases showed the SM's issue slots
// idle most of a chunk.
//
// Design, and what each part does about that:
// - Block k+1 reads block k's neighbouring tiles, so the chain is one
//   cooperative launch of persistent thread blocks: each walks the tiles of
//   chain block k, writes bf16 outputs to one of two scratch buffers in device
//   memory (L2-sized at the model's shapes), and all meet in a grid-wide sync
//   before block k+1 reads them, through L2 (ld.global.cg), never through L1.
// - The launch plan comes from the caller (ops/planar_mbconv.py,
//   plan_planar_chain): per block a tile of TH x TW output positions of one
//   image, fitted to the map, and each warp's PM x PN rectangle of the
//   project's mma tiles; per launch the variant, the shared memory (sized by
//   the plan's tiles) and the grid. The kernel derives every size again and
//   refuses a plan that does not fit.
// - Every output channel in one pass: the float32 project sums of the whole
//   tile (TH*TW positions x Cout) stay in registers over all chunks of the
//   expanded channels, spread over the warps. The expand and the depthwise of
//   a chunk run once a tile.
// - The weights come packed once (pack_planar_chain): block by block, chunk by
//   chunk of 32 expanded channels, each chunk one contiguous, 16-byte aligned
//   slab in the layout of its shared-memory buffer (w1, w2 for every output
//   channel, the nine taps, b1, bd; rows padded by 16 bytes against bank
//   conflicts, zeros past Ce, Cin and Cout). Chunks are copied with
//   cp.async.cg into three buffers, one or two chunks ahead of their use,
//   across tiles and across the grid-wide sync.
// - Two structures, one thread block of 16 warps an SM, chosen by the plan:
//   every warp takes every stage, software-pipelined by one chunk (the expand
//   of chunk k+1 and the depthwise of chunk k share a phase: two barriers a
//   chunk), for the narrow chains; or 8 producer warps (tile load, expand,
//   depthwise) and 8 consumer warps (project, epilogue) a chunk behind,
//   handing chunks over through named barriers, with setmaxnreg moving
//   registers to the consumers, whose 80 float32 sums a thread hold Cout 320
//   on a 10x10 tile. The warp index is broadcast from lane 0, so that the
//   compiler knows the branches around ldmatrix and mma to be warp-uniform
//   (else it puts a WARPSYNC before each, which serialises the project).
// - The input tile with its halo is loaded channel-major (a channel's tile row
//   is contiguous in the planar input), zeros outside the image and past Cin.
// - Stage A, the expand: mma.sync.m16n8k16 over the halo, A fragments by
//   ldmatrix.trans from the channel-major tile, B by ldmatrix; act, bf16
//   rounding and the image mask, stored position-major in float32.
// - Stage B, the depthwise: a thread takes four outputs of a row for two
//   channels, a sliding window of six columns a row, each loaded value used
//   for up to three taps, the channels' taps in registers; d goes
//   position-major to shared memory in bf16.
// - Stage C, the project: ldmatrix reads d into A fragments and the chunk's
//   w2 rows into B fragments; each warp adds its PM x PN tiles.
// - The epilogue adds b2 and the skip (from the input tile in shared memory)
//   and stores bf16 into the channel planes.
//
// One block alone (tcf_planar_block). Its input comes from device memory,
// at maps up to 320x320 (the chain's come from L2, at most 80 high), and at
// the model's first blocks the bytes (block 0: 316 MB, 0.094 ms) and the
// depthwise (2 float32 instructions a tap) are the bounds. The plan
// (plan_planar_mbconv) picks per launch one of the chain kernel's variants on
// a chain of one (wide outputs, small maps: the split variant holds Cout 160
// in one pass, so the expand and the depthwise run once a tile) or the
// streamed kernel `planar_block_stream`, which the model's blocks 0, 2 and 4
// take. What held its first version back (a float32 output cast in a second
// pass, one block of 8 warps an SM waiting on every tile load and every
// chunk's weights, transposing 2-byte loads, integer divisions by run-time
// sizes in every item) and what the streamed kernel does about it:
// - bf16 straight from the epilogue: the float32 sum is rounded once, the
//   value the cast of a float32 output gave; no second pass.
// - Persistent thread blocks of 8 warps, two an SM where the plan's shared
//   memory allows (<= 113 KB each), walking the tiles. Tile t+1's input rows
//   arrive by tensor copies (TMA, a 2-D map of H*Wp positions by B*Cin
//   planes, completion on an mbarrier) while tile t computes. A box's first
//   column must lie on 16 bytes (the card faults on a box at any other
//   column) and rows start at gy*Wp, which is rarely a multiple of 8: halo
//   row hy is copied from the 16 bytes at or before its first position,
//   IWB = TW + 9 rounded up to 8 columns of Cin planes, and is read
//   (flat & 7) columns in. Whatever lies around the map (pad columns, rows
//   of other images or planes, zeros past the tensor) is masked by index.
// - Stage A reads the rows with ldmatrix.trans: the expand's A fragments,
//   or, without an expand, the input's own channels, stored to their halo
//   positions in es; one item is a 16-column M tile by all 32 channels of
//   the chunk, its divisions by multiply-high with per-launch constants.
// - The weights: every chunk resident when there is a buffer for each (the
//   plan says so: block 0's one chunk, block 2's five), copied once; else the
//   chain's ring of three, two chunks ahead (block 2 on 8x15 tiles: 0.573 ms
//   resident, 0.596 with the ring). Stages B and C are the chain's; a chunk
//   takes two barriers (three with the ring).
// - Rectangles of at most 2x2 project tiles (16 sums a thread) where the
//   output allows, else 2x4: the 2x2 instantiation takes 107 registers to
//   the 2x4's 114, which leaves the depthwise room (block 0 on 4x47 tiles:
//   0.461 ms against 0.489). The products stay on mma.sync m16n8k16, as in
//   the chain: a warp's project is at most 2x4 tiles of 16 positions by 8
//   channels, and wgmma's 64-row products would need four warps to share
//   one rectangle; not tried.
// (Times: kernels/sweep_b4a.py, bs32 @ 640, NVIDIA H100 80GB HBM3.) A
// clock64 profile of the phases at block 0 put the depthwise first, then
// the wait on the project's results; the epilogue's stores are a small part.
//
// Not bit-equal to a float32 matrix product of the same bf16 operands: the
// tensor cores sum in another order, so a value next to a bf16 rounding
// boundary can land one bf16 step away. The depthwise keeps its sum order.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CK = 32;                // expanded channels a chunk
constexpr int ESW = CK + 8;           // row of the expanded chunk es, float32
constexpr int DSW = CK + 8;           // row of the depthwise output ds and of the w2 chunk, bf16
constexpr int kTable = 10;            // ints a block in the caller's table
constexpr int kMaxBlocks = 16;
constexpr int kMaxCin = 256;
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90
constexpr int kMaxDevices = 64;
constexpr int kBuffers = 3;           // chunk buffers

struct Block {
  // the caller's table
  int cin, ce, cout, skip, expand, ck, th, tw, pm, pn;
  // what follows from it
  int IH, IW, NPOS, XP;               // halo'd tile; row of xs in positions
  int IWB;                            // the one-block kernel's xs row: IW + 7 positions from 16 bytes, rounded to 8
  unsigned g_magic, tw_magic;         // the one-block kernel's divisions by IWB / 8 and by TW (div_small)
  int M, MT, NT, XG;                  // output positions, their M tiles, N tiles of Cout, groups of four columns
  int tiles_x, tiles_y, items;
  int cin_pad, XW;                    // K of the expand; row of the w1 chunk in bf16
  int nchunks, chunk_bytes, off_w2, off_taps, off_b1, off_bd;
  int ngroups, rects;                 // N groups of the rectangles; rectangles (one a warp)
  int off_xs, off_es, off_ds, ds_elems;   // shared memory, from the tile's base; bf16 of a ds buffer
  int xs_row;                         // the one-block kernel's elements of xs between halo rows
  int off_bar;                        // the one-block kernel's two tile barriers, from the tile's base
  long long wofs;                     // byte offset of the block's chunks in `packed`; b2 follows them
};

struct Chain {
  Block blk[kMaxBlocks];
  int n, B, H, W, Wp, relu6;
  int chunk_max;                      // bytes of one of the kBuffers chunk buffers
  int nbuf;                           // the one-block kernel's chunk buffers: kBuffers, or every chunk
  int threads;                        // of a thread block
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  __nv_bfloat16* scratch[2];
  const uint8_t* packed;
};

// act(v) = min(max(v, 0), cap), cap 6 for ReLU6 and +inf for ReLU
__device__ __forceinline__ float act(float v, float cap) { return fminf(fmaxf(v, 0.f), cap); }

// both values rounded to bf16 (one conversion for the pair), back in float32
__device__ __forceinline__ float2 round_bf16x2(float lo, float hi) {
  return __bfloat1622float2(__floats2bfloat162_rn(lo, hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// n / d for 0 <= n < 2^16 and 1 <= d < 2^16, magic = ceil(2^32 / d) (0 for
// d = 1; see magic_of)
__device__ __forceinline__ int div_small(int n, unsigned magic, int d) {
  return d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), magic));
}

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

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Starts the copy of chunk `c` of block `k` into `dst`; the `nthreads` threads
// that copy take part, each commits one group.
__device__ __forceinline__ void copy_chunk(const Chain& p, const Block& k, int c, unsigned char* dst, int t,
                                           int nthreads) {
  const uint8_t* src = p.packed + k.wofs + static_cast<long long>(c) * k.chunk_bytes;
  for (int i = t; i < k.chunk_bytes / 16; i += nthreads) cp_async16(dst + 16 * i, src + 16 * i);
  cp_async_commit();
}

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Named barriers: 0 is __syncthreads' (and the grid sync's); FULL + b: the
// producers have written ds[b] (and the chunk's weights have landed); EMPTY + b:
// the consumers have read ds[b] and the chunk's w2; PROD: the producers alone;
// TILE: the consumers have read the skip of their tile from xs.
constexpr int kFull = 1, kEmpty = 3, kProd = 5, kTile = 6;

__device__ __forceinline__ void bar_sync(int id, int n) { asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory"); }

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// mbarriers and tensor copies (the one-block kernel's input tiles)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// A box of the 2-D tensor map at (c0, c1) into shared memory, its bytes
// counted on `bar`; coordinates outside the tensor read zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

template <int R>
__device__ __forceinline__ void regs_down() { asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R)); }

template <int R>
__device__ __forceinline__ void regs_up() { asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R)); }

// Shared memory: three chunk buffers of p.chunk_max bytes, then one tile:
//   where [NPOS] i32          row * Wp + column of each halo position, -1 outside the image
//   xs    [cin_pad][XP] bf16   the input tile with its halo, channel-major, zeros
//                              outside the image and past Cin
//   es    [1 or 2][NPOS + 4][ESW] f32  the expanded chunk, position-major (bf16 values):
//                              two when every warp takes every stage
//   ds    [2 or 1][MT * 16][DSW] bf16  the depthwise output of a chunk, position-major:
//                              two with producer and consumer warps
// A chunk buffer: w1 [CK][XW] bf16 (with an expand) | w2 [round16(Cout)][DSW] bf16 |
//   taps [9][CK] f32 | b1 [CK] f32 | bd [CK] f32.

struct Tile {
  int img, oy0, ox0;
  int flat0, wp, H, W;  // offset in a plane of the halo's first position; Wp; the map
  int* where;
  __nv_bfloat16* xs;
  float* es;
  __nv_bfloat16* ds0;   // the first ds buffer
};

// The tile `item` of block k: (image, first output row, first output column)
// and its shared memory.
__device__ __forceinline__ Tile tile_of(const Chain& p, const Block& k, int item, unsigned char* smem) {
  Tile t;
  int rest = item;   // item = (img * tiles_y + ty) * tiles_x + tx
  const int tx = rest % k.tiles_x;
  rest /= k.tiles_x;
  const int ty = rest % k.tiles_y;
  t.img = rest / k.tiles_y;
  t.oy0 = ty * k.th;
  t.ox0 = tx * k.tw;
  t.flat0 = (t.oy0 - 1) * p.Wp + t.ox0 - 1;
  t.wp = p.Wp;
  t.H = p.H;
  t.W = p.W;
  unsigned char* base = smem + kBuffers * p.chunk_max;
  t.where = reinterpret_cast<int*>(base);
  t.xs = reinterpret_cast<__nv_bfloat16*>(base + k.off_xs);
  t.es = reinterpret_cast<float*>(base + k.off_es);
  t.ds0 = reinterpret_cast<__nv_bfloat16*>(base + k.off_ds);
  return t;
}

// This thread block's walk of the chain's chunks (blocks, its tiles of each,
// their chunks), for the copies that run ahead of the computation. Weights are
// read-only, so a copy may cross the grid-wide sync into the next block.
struct Cursor {   // the next chunk whose copy is to be started: block, tile, chunk
  int i, item, ch;
};

// The chunk after (i, item, ch) in this thread block's walk of the chain;
// i == p.n when there is none.
__device__ __forceinline__ Cursor advance(const Chain& p, Cursor c) {
  if (++c.ch < p.blk[c.i].nchunks) return c;
  c.ch = 0;
  c.item += gridDim.x;
  while (c.i < p.n && c.item >= p.blk[c.i].items) {
    ++c.i;
    c.item = blockIdx.x;
  }
  return c;
}

// The first chunk of the walk.
__device__ __forceinline__ Cursor first_chunk(const Chain& p) {
  Cursor c{0, static_cast<int>(blockIdx.x), 0};
  while (c.i < p.n && c.item >= p.blk[c.i].items) ++c.i;
  return c;
}

// Starts the copy of the cursor's chunk into buffer `issued` % kBuffers and moves the
// cursor on; past the end it commits an empty group, so that every call adds
// one group. `t` is this thread among the `nth` that copy.
__device__ __forceinline__ void issue(const Chain& p, unsigned char* smem, Cursor& c, int& issued, int t, int nth) {
  if (c.i < p.n) {
    copy_chunk(p, p.blk[c.i], c.ch, smem + (issued % kBuffers) * p.chunk_max, t, nth);
    c = advance(p, c);
  } else {
    cp_async_commit();
  }
  ++issued;
}

// The halo positions' offsets of a tile (t: this thread among nth).
__device__ __forceinline__ void fill_where(const Chain& p, const Block& k, const Tile& tl, int t, int nth) {
  for (int pos = t; pos < k.NPOS; pos += nth) {
    const int hy = pos / k.IW;
    const int gy = tl.oy0 - 1 + hy;
    const int gx = tl.ox0 - 1 + (pos - hy * k.IW);
    tl.where[pos] = (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) ? gy * p.Wp + gx : -1;
  }
}

// The input tile with its halo, channel-major, eight loads in flight a thread;
// a warp's loads are consecutive positions of one channel. `in` was written by
// other thread blocks of this launch: read through L2.
__device__ __forceinline__ void load_tile(const Chain& p, const Block& k, const Tile& tl, const __nv_bfloat16* in,
                                          int t, int nth) {
  const size_t plane = static_cast<size_t>(p.H) * p.Wp;
  const __nv_bfloat16* xb = in + static_cast<size_t>(tl.img) * k.cin * plane;
  const int NPOS = k.NPOS;
  const int dc = nth / NPOS, dp = nth - dc * NPOS;
  int c = t / NPOS, pos = t - c * NPOS;
  while (c < k.cin_pad) {
    __nv_bfloat16 v[8];
    int dst[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dst[j] = -1;
      v[j] = __float2bfloat16_rn(0.f);
      if (c < k.cin_pad) {
        dst[j] = c * k.XP + pos;
        const int off = tl.where[pos];
        if (c < k.cin && off >= 0) v[j] = __ldcg(xb + c * plane + off);
      }
      pos += dp;
      c += dc;
      if (pos >= NPOS) {
        pos -= NPOS;
        ++c;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (dst[j] >= 0) tl.xs[dst[j]] = v[j];
    }
  }
}

// Stage A: chunk ch's expanded channels at every halo position into es,
// act and bf16 rounding applied, zeros outside the image. An item is one halo
// M tile by 16 of the chunk's channels (warp: this warp among nw; t: this
// thread among nth).
__device__ __forceinline__ void stage_a(const Block& k, int ch, const Tile& tl, const unsigned char* cur, float cap,
                                        int warp, int nw, int t, int nth) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int NPOS = k.NPOS, XP = k.XP;
  float* es = tl.es;
  if (!k.expand) {
    // the chunk is the input's own channels (zero outside the image)
    const int ce0 = ch * CK;
    for (int j = t; j < NPOS * (CK / 2); j += nth) {
      const int pos = j / (CK / 2);
      const int c = 2 * (j - pos * (CK / 2));
      float2 v = make_float2(0.f, 0.f);
      if (ce0 + c < k.ce) v.x = __bfloat162float(tl.xs[(ce0 + c) * XP + pos]);
      if (ce0 + c + 1 < k.ce) v.y = __bfloat162float(tl.xs[(ce0 + c + 1) * XP + pos]);
      *reinterpret_cast<float2*>(es + pos * ESW + c) = v;
    }
    return;
  }
  const __nv_bfloat16* w1s = reinterpret_cast<const __nv_bfloat16*>(cur);
  const float* b1s = reinterpret_cast<const float*>(cur + k.off_b1);
  const int ksteps = k.cin_pad / 16;
  // A: matrix j = lane / 8 is channels 8 * (j / 2).., positions 8 * (j % 2)..
  const __nv_bfloat16* xa = tl.xs + ((lane & 7) + 8 * (lane >> 4)) * XP + 8 * ((lane >> 3) & 1);
  // B: matrix j is expanded channels 8 * (j / 2).., input channels 8 * (j % 2)..
  const __nv_bfloat16* wb = w1s + ((lane & 7) + 8 * (lane >> 4)) * k.XW + 8 * ((lane >> 3) & 1);
  const int items = (NPOS + 15) / 16 * 2;
  const int XW = k.XW;
  for (int it = warp; it < items; it += nw) {
    const int hmt = it >> 1;
    const int n0 = 16 * (it & 1);
    float ea[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) ea[nt][r] = 0.f;
    // rows past the last halo position read what lies there; never stored
#pragma unroll 2
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t a[4], b[4];
      ldsm_x4_trans(a, xa + ks * 16 * XP + hmt * 16);
      ldsm_x4(b, wb + n0 * XW + ks * 16);
      mma_bf16(ea[0], a, b[0], b[1]);
      mma_bf16(ea[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = hmt * 16 + g + 8 * half;
      if (r >= NPOS) continue;
      const bool inside = tl.where[r] >= 0;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = n0 + nt * 8 + 2 * tig;
        const float2 bias = *reinterpret_cast<const float2*>(b1s + c);
        float2 v = round_bf16x2(act(ea[nt][2 * half] + bias.x, cap), act(ea[nt][2 * half + 1] + bias.y, cap));
        if (!inside) v = make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(es + r * ESW + c) = v;
      }
    }
  }
}

// Stage A of the streamed one-block kernel, as stage_a, from xs as the
// tensor copies leave it: [IH][cin_pad][IWB] rows, halo row hy starting at
// the 16 bytes at or before its first position, shift(hy) = (flat0 + hy * Wp)
// & 7 columns earlier, holding whatever lies around the map. An item is two
// 8-column groups of xs (an M tile) by the chunk's 32 channels: the expand's
// A fragments by ldmatrix.trans, or without an expand the input's own
// channels by the same ldmatrix.trans; each value goes to its halo position
// in es, masked by index (columns before the shift and past the halo are not
// stored).
__device__ __forceinline__ void stage_a_rows(const Block& k, int ch, const Tile& tl, const unsigned char* cur,
                                             float cap, int warp, int nw) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int G = k.IWB / 8, groups = k.IH * G;
  // A: matrix j = lane / 8 is channels 8 * (j / 2).. of the xs columns of group 2 * m + j % 2
  const __nv_bfloat16* xa = tl.xs + ((lane & 7) + 8 * (lane >> 4)) * k.IWB;
  const int kstep = 16 * k.IWB;
  // B: matrix j is expanded channels 8 * (j / 2).., input channels 8 * (j % 2)..
  const __nv_bfloat16* w1s = reinterpret_cast<const __nv_bfloat16*>(cur);
  const float* b1s = reinterpret_cast<const float*>(cur + k.off_b1);
  const __nv_bfloat16* wb = w1s + ((lane & 7) + 8 * (lane >> 4)) * k.XW + 8 * ((lane >> 3) & 1);
  const int c0 = ch * CK;   // without an expand: the input's channels c0 ..
  const bool full = c0 + CK <= k.ce;
  for (int m = warp; m < (groups + 1) / 2; m += nw) {
    // a group past the last reads the last; never stored
    const int g8 = min(2 * m + ((lane >> 3) & 1), groups - 1);
    const int gy8 = div_small(g8, k.g_magic, G);
    const __nv_bfloat16* xr = xa + gy8 * k.xs_row + 8 * (g8 - gy8 * G);
    float2 v[2][4];   // [half][nt]: position g + 8 half of the M tile, channels 8 nt + 2 tig, +1
    if (k.expand) {
      float ea[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) ea[nt][r] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < k.cin_pad / 16; ++ks) {
        uint32_t a[4], b[4], bb[4];
        ldsm_x4_trans(a, xr + ks * kstep);
        ldsm_x4(b, wb + ks * 16);
        ldsm_x4(bb, wb + 16 * k.XW + ks * 16);
        mma_bf16(ea[0], a, b[0], b[1]);
        mma_bf16(ea[1], a, b[2], b[3]);
        mma_bf16(ea[2], a, bb[0], bb[1]);
        mma_bf16(ea[3], a, bb[2], bb[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float2 bias = *reinterpret_cast<const float2*>(b1s + nt * 8 + 2 * tig);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          v[half][nt] = round_bf16x2(act(ea[nt][2 * half] + bias.x, cap), act(ea[nt][2 * half + 1] + bias.y, cap));
        }
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // channels c0 + 16 h ..: zeros past Ce (past cin_pad they are not loaded)
        uint32_t a[4] = {0u, 0u, 0u, 0u};
        if (c0 + 16 * h < k.cin_pad) ldsm_x4_trans(a, xr + (c0 / 16 + h) * kstep);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[half + 2 * q]));
            if (!full) {
              const int c = c0 + 16 * h + 8 * q + 2 * tig;
              f = make_float2(c < k.ce ? f.x : 0.f, c + 1 < k.ce ? f.y : 0.f);
            }
            v[half][2 * h + q] = f;
          }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // xs column -> halo position of its row
      const int gg = 2 * m + half;
      const int hy = div_small(gg, k.g_magic, G);
      const int hx = 8 * (gg - hy * G) + g - ((tl.flat0 + hy * tl.wp) & 7);
      if (gg >= groups || hx < 0 || hx >= k.IW) continue;
      const int gy = tl.oy0 - 1 + hy, gx = tl.ox0 - 1 + hx;
      const bool inside = gy >= 0 && gy < tl.H && gx >= 0 && gx < tl.W;
      float* e = tl.es + (hy * k.IW + hx) * ESW + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        *reinterpret_cast<float2*>(e + nt * 8) = inside ? v[half][nt] : make_float2(0.f, 0.f);
      }
    }
  }
}

// Stage B: the depthwise of chunk es into ds, four outputs of a row by two
// channels a thread; the channel pair, and so its taps, is the same in every
// unit of a thread (nth is a multiple of CK / 2), and its units go along the
// rows.
__device__ __forceinline__ void stage_b(const Block& k, const Tile& tl, __nv_bfloat16* ds, const unsigned char* cur,
                                        float cap, int t, int nth) {
  const float* taps = reinterpret_cast<const float*>(cur + k.off_taps);
  const float* bds = reinterpret_cast<const float*>(cur + k.off_bd);
  const int IW = k.IW;
  const int c = 2 * (t & (CK / 2 - 1));
  float2 w[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) w[j] = *reinterpret_cast<const float2*>(taps + j * CK + c);
  const float2 bias = *reinterpret_cast<const float2*>(bds + c);
  const int step = nth / (CK / 2);   // units a round
  const int XG = k.XG;
  const int step_y = step / XG, step_x = step - step_y * XG;
  int oy = (t / (CK / 2)) / XG;
  int xg = (t / (CK / 2)) - oy * XG;
  while (oy < k.th) {
    float2 s4[4];
#pragma unroll
    for (int o = 0; o < 4; ++o) s4[o] = make_float2(0.f, 0.f);
    const float* e = tl.es + (oy * IW + 4 * xg) * ESW + c;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      float2 v[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) v[j] = *reinterpret_cast<const float2*>(e + (dy * IW + j) * ESW);
      // output o takes columns o, o+1, o+2 of the row, in that order
#pragma unroll
      for (int j = 0; j < 6; ++j) {
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          const int dx = j - o;
          if (dx < 0 || dx > 2) continue;
          // product rounded, then added: not an fma (see the header)
          s4[o].x = __fadd_rn(s4[o].x, __fmul_rn(v[j].x, w[dy * 3 + dx].x));
          s4[o].y = __fadd_rn(s4[o].y, __fmul_rn(v[j].y, w[dy * 3 + dx].y));
        }
      }
    }
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const int ox = 4 * xg + o;
      if (ox < k.tw) {
        *reinterpret_cast<uint32_t*>(ds + (oy * k.tw + ox) * DSW + c) =
            pack_bf16(act(s4[o].x + bias.x, cap), act(s4[o].y + bias.y, cap));
      }
    }
    oy += step_y;
    xg += step_x;
    if (xg >= XG) {
      xg -= XG;
      ++oy;
    }
  }
}

// This warp's rectangle of the project (warp: among the project's warps).
struct Rect {
  int mg, ng, pm, pn;
  bool has;
};

__device__ __forceinline__ Rect rect_of(const Block& k, int warp) {
  Rect r;
  r.pm = k.pm;
  r.pn = k.pn;
  r.has = warp < k.rects;
  r.mg = warp / k.ngroups;
  r.ng = warp - r.mg * k.ngroups;
  return r;
}

// Stage C: acc += d (ds) times the chunk's w2 over this warp's PM x PN tiles.
template <int PMX, int PNX>
__device__ __forceinline__ void stage_c(const Block& k, const Rect& rc, const __nv_bfloat16* ds,
                                        const unsigned char* cur, float (&acc)[PMX][PNX][4]) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* w2s = reinterpret_cast<const __nv_bfloat16*>(cur + k.off_w2);
  // ldmatrix: lane -> row of a 16-row tile and its 8-column half
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lcol = 8 * (lane >> 4);
#pragma unroll
  for (int ks = 0; ks < CK / 16; ++ks) {
    uint32_t b[PNX][2];
#pragma unroll
    for (int jj = 0; jj < PNX; ++jj) {
      const int nt = rc.ng * rc.pn + jj;
      if (jj < rc.pn && nt < k.NT) {
        ldsm_x2(b[jj], w2s + (nt * 8 + (lane & 7)) * DSW + ks * 16 + 8 * ((lane >> 3) & 1));
      }
    }
#pragma unroll
    for (int ii = 0; ii < PMX; ++ii) {
      const int mt = rc.mg * rc.pm + ii;
      if (ii >= rc.pm || mt >= k.MT) continue;
      uint32_t a[4];
      ldsm_x4(a, ds + (mt * 16 + lrow) * DSW + ks * 16 + lcol);
#pragma unroll
      for (int jj = 0; jj < PNX; ++jj) {
        if (jj < rc.pn && rc.ng * rc.pn + jj < k.NT) mma_bf16(acc[ii][jj], a, b[jj][0], b[jj][1]);
      }
    }
  }
}

// The epilogue: + b2 [+ skip, from the tile's xs], rounded to bf16, into the
// channel planes of `out`.
template <int PMX, int PNX>
__device__ __forceinline__ void epilogue(const Chain& p, const Block& k, const Rect& rc, const Tile& tl,
                                         __nv_bfloat16* out, const float (&acc)[PMX][PNX][4]) {
  if (!rc.has) return;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const size_t plane = static_cast<size_t>(p.H) * p.Wp;
  const float* b2 = reinterpret_cast<const float*>(p.packed + k.wofs + static_cast<long long>(k.nchunks) * k.chunk_bytes);
  __nv_bfloat16* ob = out + static_cast<size_t>(tl.img) * k.cout * plane;
#pragma unroll
  for (int ii = 0; ii < PMX; ++ii) {
    const int mt = rc.mg * rc.pm + ii;
    if (ii >= rc.pm || mt >= k.MT) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pos = mt * 16 + g + 8 * half;
      if (pos >= k.M) continue;
      const int oy = pos / k.tw;
      const int ox = pos - oy * k.tw;
      const int gy = tl.oy0 + oy, gx = tl.ox0 + ox;
      if (gy >= p.H || gx >= p.W) continue;
      const int self = (oy + 1) * k.IW + ox + 1;   // the position among the halo'd ones
      __nv_bfloat16* o = ob + gy * p.Wp + gx;
#pragma unroll
      for (int jj = 0; jj < PNX; ++jj) {
        const int nt = rc.ng * rc.pn + jj;
        if (jj >= rc.pn || nt >= k.NT) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = nt * 8 + 2 * tig + j;
          if (c >= k.cout) continue;
          float v = acc[ii][jj][2 * half + j] + __ldg(b2 + c);
          if (k.skip) v += __bfloat162float(tl.xs[c * k.XP + self]);
          o[c * plane] = __float2bfloat16_rn(v);
        }
      }
    }
  }
}

// The streamed kernel's epilogue: as `epilogue`, the skip from xs as
// stage_a_rows reads it, b2 read once, offsets in 32 bits (derive checks that
// an image's output fits).
template <int PMX, int PNX>
__device__ __forceinline__ void epilogue_rows(const Chain& p, const Block& k, const Rect& rc, const Tile& tl,
                                              const float (&acc)[PMX][PNX][4]) {
  if (!rc.has) return;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int plane = p.H * p.Wp;
  const float* b2 = reinterpret_cast<const float*>(p.packed + k.wofs + static_cast<long long>(k.nchunks) * k.chunk_bytes);
  __nv_bfloat16* ob = p.out + static_cast<size_t>(tl.img) * k.cout * plane;
  float b2r[PNX][2];
#pragma unroll
  for (int jj = 0; jj < PNX; ++jj)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = (rc.ng * rc.pn + jj) * 8 + 2 * tig + j;
      b2r[jj][j] = jj < rc.pn && c < k.cout ? __ldg(b2 + c) : 0.f;
    }
#pragma unroll
  for (int ii = 0; ii < PMX; ++ii) {
    const int mt = rc.mg * rc.pm + ii;
    if (ii >= rc.pm || mt >= k.MT) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pos = mt * 16 + g + 8 * half;
      if (pos >= k.M) continue;
      const int oy = div_small(pos, k.tw_magic, k.tw);
      const int ox = pos - oy * k.tw;
      const int gy = tl.oy0 + oy, gx = tl.ox0 + ox;
      if (gy >= p.H || gx >= p.W) continue;
      // the position in the halo'd tile
      const __nv_bfloat16* xself = tl.xs + (oy + 1) * k.xs_row + ox + 1 + ((tl.flat0 + (oy + 1) * tl.wp) & 7);
      const int o = gy * p.Wp + gx;
#pragma unroll
      for (int jj = 0; jj < PNX; ++jj) {
        const int nt = rc.ng * rc.pn + jj;
        if (jj >= rc.pn || nt >= k.NT) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = nt * 8 + 2 * tig + j;
          if (c >= k.cout) continue;
          float v = acc[ii][jj][2 * half + j] + b2r[jj][j];
          if (k.skip) v += __bfloat162float(xself[c * k.IWB]);
          ob[o + c * plane] = __float2bfloat16_rn(v);
        }
      }
    }
  }
}

template <int PMX, int PNX>
__device__ __forceinline__ void zero_acc(float (&acc)[PMX][PNX][4]) {
#pragma unroll
  for (int a = 0; a < PMX; ++a)
#pragma unroll
    for (int b = 0; b < PNX; ++b)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[a][b][r] = 0.f;
}

// Zeros in the pad columns of the chain's output, by every thread of the grid.
__device__ __forceinline__ void zero_pad_columns(const Chain& p, int cout) {
  const int pad = p.Wp - p.W;
  const size_t total = static_cast<size_t>(p.B) * cout * p.H * pad;
  for (size_t j = static_cast<size_t>(blockIdx.x) * p.threads + threadIdx.x; j < total;
       j += static_cast<size_t>(gridDim.x) * p.threads) {
    const size_t row = j / pad;
    p.out[row * p.Wp + p.W + (j - row * pad)] = __float2bfloat16_rn(0.f);
  }
}

__device__ __forceinline__ float act_cap(const Chain& p) { return p.relu6 ? 6.f : __int_as_float(0x7f800000); }

// ---- every warp takes every stage: NW warps, one thread block an SM --------
// Software-pipelined by one chunk: the expand of chunk k+1 (into es[(k+1) % 2])
// and the depthwise of chunk k (from es[k % 2]) share a phase, then the project
// of chunk k; two barriers a chunk. Chunk q of the thread block's running count
// goes to buffer q % 3; the copy of chunk q+2 is started when the expand of
// q+1 begins.
template <int NW, int PMX, int PNX>
__global__ void __launch_bounds__(NW * 32, 1) planar_chain_all(const __grid_constant__ Chain p) {
  constexpr int NTH = NW * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int warp = warp_index();
  const float cap = act_cap(p);
  // the copy cursor and the count of copies started; chunk q of the walk is
  // the q-th copy
  Cursor cur = first_chunk(p);
  int issued = 0, q = 0;
  for (int i = 0; i < p.n; ++i) {
    const Block& k = p.blk[i];
    const bool last = i + 1 == p.n;
    const __nv_bfloat16* in = i == 0 ? p.x : p.scratch[(i - 1) & 1];
    __nv_bfloat16* out = last ? p.out : p.scratch[i & 1];
    const Rect rc = rect_of(k, warp);
    for (int item = blockIdx.x; item < k.items; item += gridDim.x) {
      const Tile tl = tile_of(p, k, item, smem);
      float* es2 = tl.es + (k.NPOS + 4) * ESW;   // the second es buffer
      __syncthreads();  // the previous tile's readers of the tile memory are done
      while (issued < q + 2) issue(p, smem, cur, issued, tid, NTH);   // chunks q and q+1
      fill_where(p, k, tl, tid, NTH);
      __syncthreads();
      load_tile(p, k, tl, in, tid, NTH);
      cp_async_wait_one();   // chunk q
      __syncthreads();
      stage_a(k, 0, tl, smem + (q % kBuffers) * p.chunk_max, cap, warp, NW, tid, NTH);
      float acc[PMX][PNX][4];
      zero_acc(acc);
      for (int ch = 0; ch < k.nchunks; ++ch, ++q) {
        cp_async_wait_all();   // chunk q+1
        __syncthreads();       // es[ch % 2] written; ds and chunk q-1's buffer free
        issue(p, smem, cur, issued, tid, NTH);   // chunk q+2, into chunk q-1's buffer
        Tile ta = tl, tb = tl;
        ta.es = (ch & 1) ? tl.es : es2;   // the expand of chunk ch+1
        tb.es = (ch & 1) ? es2 : tl.es;   // the depthwise of chunk ch
        if (ch + 1 < k.nchunks) stage_a(k, ch + 1, ta, smem + ((q + 1) % kBuffers) * p.chunk_max, cap, warp, NW, tid, NTH);
        const unsigned char* cb = smem + (q % kBuffers) * p.chunk_max;
        stage_b(k, tb, tl.ds0, cb, cap, tid, NTH);
        __syncthreads();
        if (rc.has) stage_c(k, rc, tl.ds0, cb, acc);
      }
      epilogue(p, k, rc, tl, out, acc);
    }
    if (!last) {
      grid.sync();  // every thread block has written its part of this block's output
    } else {
      zero_pad_columns(p, k.cout);
    }
  }
  cp_async_wait_all();
}

// ---- producer and consumer warps ---------------------------------------------
// NP producer warps (tile load, stage A, stage B) and NC consumer warps (stage
// C, epilogue), one thread block an SM; setmaxnreg moves registers from the
// producers (REG_P a thread) to the consumers (REG_C), whose PMX x PNX
// rectangles of float32 sums stay in registers over all chunks. Chunk q of the
// thread block's running count goes to buffer q % 3 and its depthwise output to
// ds[q % 2]: the producers work on chunk q while the consumers multiply chunk
// q - 1 and chunk q + 1 is in flight. Each role walks the chain on its own
// path (the two never merge, so that the compiler gives each the registers
// its setmaxnreg sets); both meet in the grid-wide syncs, which count threads,
// not code.
template <int NP>
__device__ __forceinline__ void producer_main(const Chain& p, unsigned char* smem) {
  constexpr int PTH = NP * 32;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;   // producers are threads 0 .. PTH-1
  const int warp = warp_index();
  const float cap = act_cap(p);
  const int all = p.threads;
  Cursor cur = first_chunk(p);
  int q = 0, issued = 0, tiles = 0;
  for (int i = 0; i < p.n; ++i) {
    const Block& k = p.blk[i];
    const __nv_bfloat16* in = i == 0 ? p.x : p.scratch[(i - 1) & 1];
    for (int item = blockIdx.x; item < k.items; item += gridDim.x) {
      const Tile tl = tile_of(p, k, item, smem);
      // the producers' last readers of where, xs and es (the previous tile's
      // stages A and B) are past the producer barrier that ends stage A; the
      // consumers read the previous tile's skip from xs in its epilogue
      if (tiles++ > 0) bar_sync(kTile, all);
      fill_where(p, k, tl, tid, PTH);
      bar_sync(kProd, PTH);
      load_tile(p, k, tl, in, tid, PTH);
      for (int ch = 0; ch < k.nchunks; ++ch, ++q) {
        // the consumers are done with chunk q - 2: ds[q % 2] and buffer (q + 1) % 3 are free
        if (q >= 2) bar_sync(kEmpty + (q & 1), all);
        while (issued < q + 2) issue(p, smem, cur, issued, tid, PTH);   // chunks q and q+1
        cp_async_wait_one();    // chunk q
        bar_sync(kProd, PTH);   // chunk q has landed for every producer; xs is written; es is free
        const unsigned char* buf = smem + (q % kBuffers) * p.chunk_max;
        stage_a(k, ch, tl, buf, cap, warp, NP, tid, PTH);
        bar_sync(kProd, PTH);
        stage_b(k, tl, tl.ds0 + (q & 1) * k.ds_elems, buf, cap, tid, PTH);
        bar_arrive(kFull + (q & 1), all);   // ds[q % 2] is written; chunk q's w2 has landed
      }
    }
    if (i + 1 < p.n) {
      grid.sync();
    } else {
      zero_pad_columns(p, k.cout);
    }
  }
  // the consumers' last arrivals, so that no barrier is left half-way
  for (int j = q >= 2 ? q - 2 : 0; j < q; ++j) bar_sync(kEmpty + (j & 1), all);
  if (tiles > 0) bar_sync(kTile, all);
  cp_async_wait_all();
}

template <int NP, int NC, int PMX, int PNX>
__device__ __forceinline__ void consumer_main(const Chain& p, unsigned char* smem) {
  cg::grid_group grid = cg::this_grid();
  const int warp = warp_index() - NP;   // 0 .. NC-1
  const int all = p.threads;
  int q = 0;
  for (int i = 0; i < p.n; ++i) {
    const Block& k = p.blk[i];
    const bool last = i + 1 == p.n;
    __nv_bfloat16* out = last ? p.out : p.scratch[i & 1];
    const Rect rc = rect_of(k, warp);
    for (int item = blockIdx.x; item < k.items; item += gridDim.x) {
      const Tile tl = tile_of(p, k, item, smem);
      float acc[PMX][PNX][4];
      zero_acc(acc);
      for (int ch = 0; ch < k.nchunks; ++ch, ++q) {
        bar_sync(kFull + (q & 1), all);
        if (rc.has) stage_c(k, rc, tl.ds0 + (q & 1) * k.ds_elems, smem + (q % kBuffers) * p.chunk_max, acc);
        bar_arrive(kEmpty + (q & 1), all);   // ds[q % 2] and chunk q's buffer may be refilled
      }
      epilogue(p, k, rc, tl, out, acc);
      bar_arrive(kTile, all);   // the producers may load the next tile into xs
    }
    if (!last) {
      grid.sync();  // every thread block has written its part of this block's output
    } else {
      zero_pad_columns(p, k.cout);
    }
  }
}

template <int NP, int NC, int PMX, int PNX, int REG_P, int REG_C>
__global__ void __launch_bounds__((NP + NC) * 32) __maxnreg__(65536 / ((NP + NC) * 32))
planar_chain_split(const __grid_constant__ Chain p) {
  static_assert(NP % 4 == 0 && NC % 4 == 0, "roles are whole warpgroups");
  static_assert(NP * REG_P + NC * REG_C <= 2048, "the register file of an SM");
  extern __shared__ __align__(16) unsigned char smem[];
  if (warp_index() < NP) {
    regs_down<REG_P>();
    producer_main<NP>(p, smem);
  } else {
    regs_up<REG_C>();
    consumer_main<NP, NC, PMX, PNX>(p, smem);
  }
}

// ---- one block, streamed: the one-block kernel's own structure ------------
// Starts the tensor copies of tile `item`'s input rows on `bar`, one thread:
// halo row hy from the 16 bytes at or before its first position (a box's
// first column must lie on 16 bytes), [Cin][IWB] into xs, rows xs_row apart.
__device__ __forceinline__ void load_tile_tma(const Chain& p, const Block& k, const CUtensorMap* map, int item,
                                              __nv_bfloat16* xs, uint64_t* bar) {
  const int tx = item % k.tiles_x;
  const int rest = item / k.tiles_x;
  const int ty = rest % k.tiles_y;
  const int img = rest / k.tiles_y;
  mbar_expect_tx(bar, k.IH * k.cin * k.IWB * 2);
  for (int hy = 0; hy < k.IH; ++hy) {
    tma_load_2d(xs + hy * k.xs_row, map, ((ty * k.th - 1 + hy) * p.Wp + tx * k.tw - 1) & ~7, img * k.cin, bar);
  }
}

// NW warps, every warp every stage, persistent thread blocks (two an SM where
// the shared memory allows) walking the tiles of one block. Tile t's input
// rows land by tensor copies in xs[t % 2] while tile t - 1 computes. With a
// buffer for every chunk (p.nbuf >= nchunks) the weights are copied once and
// stay; else they come by cp.async into three buffers two chunks ahead, as
// in the chain. A chunk: expand (es), barrier, depthwise (ds), barrier,
// project into the registers.
template <int NW, int PMX, int PNX>
__global__ void __launch_bounds__(NW * 32, 2)
planar_block_stream(const __grid_constant__ Chain p, const __grid_constant__ CUtensorMap xmap) {
  constexpr int NTH = NW * 32;
  extern __shared__ __align__(128) unsigned char smem_rows[];   // the tensor copies land on 128 bytes
  unsigned char* smem = smem_rows;
  const Block& k = p.blk[0];
  const int tid = threadIdx.x;
  const int warp = warp_index();
  const float cap = act_cap(p);
  unsigned char* base = smem + p.nbuf * p.chunk_max;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + k.off_bar);
  __nv_bfloat16* xs_all = reinterpret_cast<__nv_bfloat16*>(base + k.off_xs);
  const bool resident = k.nchunks <= p.nbuf;
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
  }
  // the rows of the K padding (Cin .. cin_pad-1) of both buffers: zeros, once
  // (the copies write rows below Cin only)
  const int npad = (k.cin_pad - k.cin) * k.IWB;
  for (int j = tid; j < 2 * k.IH * npad; j += NTH) {
    const int r = j / npad;
    xs_all[r * k.xs_row + k.cin * k.IWB + (j - r * npad)] = __float2bfloat16_rn(0.f);
  }
  Cursor cur = first_chunk(p);
  int issued = 0, q = 0;
  if (resident) {
    for (int c = 0; c < k.nchunks; ++c) copy_chunk(p, k, c, smem + c * p.chunk_max, tid, NTH);
    cp_async_wait_all();
  }
  __syncthreads();
  const Rect rc = rect_of(k, warp);
  if (tid == 0 && blockIdx.x < k.items) load_tile_tma(p, k, &xmap, blockIdx.x, xs_all, &bars[0]);
  int t = 0;
  for (int item = blockIdx.x; item < k.items; item += gridDim.x, ++t) {
    const int b = t & 1;
    // tile_of puts the tile after kBuffers chunk buffers; here there are nbuf
    Tile tl = tile_of(p, k, item, smem + (p.nbuf - kBuffers) * p.chunk_max);
    tl.xs = xs_all + b * k.IH * k.xs_row;
    __syncthreads();  // the previous tile's readers of es, ds and xs[b ^ 1] are done
    if (tid == 0 && item + static_cast<int>(gridDim.x) < k.items) {
      load_tile_tma(p, k, &xmap, item + gridDim.x, xs_all + (b ^ 1) * k.IH * k.xs_row, &bars[b ^ 1]);
    }
    if (!resident) {
      while (issued < q + 2) issue(p, smem, cur, issued, tid, NTH);   // chunks q and q+1
    }
    mbar_wait(&bars[b], (t >> 1) & 1);   // this tile's rows have landed
    float acc[PMX][PNX][4];
    zero_acc(acc);
    for (int ch = 0; ch < k.nchunks; ++ch, ++q) {
      if (!resident) {
        cp_async_wait_one();   // chunk q
        __syncthreads();       // chunk q has landed for every thread; es is free
      }
      const unsigned char* cb = smem + (resident ? ch : q % kBuffers) * p.chunk_max;
      stage_a_rows(k, ch, tl, cb, cap, warp, NW);
      __syncthreads();
      stage_b(k, tl, tl.ds0, cb, cap, tid, NTH);
      __syncthreads();
      if (!resident) issue(p, smem, cur, issued, tid, NTH);   // chunk q+2, into chunk q-1's buffer
      if (rc.has) stage_c(k, rc, tl.ds0, cb, acc);
    }
    epilogue_rows(p, k, rc, tl, acc);
  }
  zero_pad_columns(p, k.cout);
  cp_async_wait_all();
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// ceil(2^32 / d) for div_small, 0 for d = 1
unsigned magic_of(int d) { return d > 1 ? static_cast<unsigned>(((1ULL << 32) + d - 1) / d) : 0u; }

// The sizes a block's table entry implies; the same arithmetic as
// ChainLayout, chain_tile_smem, block_tile_smem and _rect's coverage in
// ops/planar_mbconv.py. `rect_warps` share the project; `nes` es and `nds` ds
// buffers; `rows`: the one-block kernel's tile (two barriers, two xs
// buffers of halo rows of IWB positions, no where table: it masks by index).
// Returns the bytes of its tile, or -1 if the entry does not fit.
int derive(Block& k, int B, int H, int W, int Wp, int rect_warps, int pmx, int pnx, int nes, int nds, bool rows = false) {
  if (k.cin < 1 || k.ce < 1 || k.cout < 1 || k.cin > kMaxCin || k.ck != CK) return -1;
  if (!k.expand && k.ce != k.cin) return -1;
  if (k.skip && k.cin != k.cout) return -1;
  if (k.th < 1 || k.tw < 1 || k.th > H || k.tw > W || k.th * k.tw > 1024) return -1;
  if (k.pm < 1 || k.pn < 1 || k.pm > pmx || k.pn > pnx) return -1;
  k.IH = k.th + 2;
  k.IW = k.tw + 2;
  k.IWB = rows ? round_up(k.IW + 7, 8) : k.IW;
  if (rows && k.IWB > 256) return -1;  // a tensor copy's box is at most 256 wide
  k.NPOS = k.IH * k.IW;
  k.XP = round_up(k.NPOS, 16) + 8;
  k.M = k.th * k.tw;
  k.MT = (k.M + 15) / 16;
  k.NT = (k.cout + 7) / 8;
  k.XG = (k.tw + 3) / 4;
  k.ngroups = (k.NT + k.pn - 1) / k.pn;
  k.rects = (k.MT + k.pm - 1) / k.pm * k.ngroups;
  if (k.rects > rect_warps) return -1;
  k.tiles_x = (W + k.tw - 1) / k.tw;
  k.tiles_y = (H + k.th - 1) / k.th;
  if (static_cast<long long>(B) * k.tiles_x * k.tiles_y >= (1 << 24)) return -1;
  k.items = B * k.tiles_x * k.tiles_y;
  k.cin_pad = round_up(k.cin, 16);
  k.XW = k.cin_pad + 8;
  k.nchunks = (k.ce + CK - 1) / CK;
  k.off_w2 = k.expand ? CK * k.XW * 2 : 0;
  k.off_taps = k.off_w2 + round_up(k.cout, 16) * DSW * 2;
  k.off_b1 = k.off_taps + 9 * CK * 4;
  k.off_bd = k.off_b1 + CK * 4;
  k.chunk_bytes = k.off_bd + CK * 4;
  k.g_magic = rows ? magic_of(k.IWB / 8) : 0;
  k.tw_magic = rows ? magic_of(k.tw) : 0;
  if (rows && static_cast<long long>(k.cout) * H * Wp >= (1LL << 31)) return -1;   // 32-bit output offsets
  k.xs_row = rows ? k.cin_pad * k.IWB : 0;
  k.off_bar = rows ? 0 : round_up(4 * k.NPOS, 16);   // rows: the barriers; else where [NPOS] before xs
  k.off_xs = rows ? 128 : k.off_bar;                // a tensor copy lands on 128 bytes
  k.off_es = k.off_xs + (rows ? 2 * k.IH * k.xs_row : k.cin_pad * k.XP) * 2;
  k.off_ds = k.off_es + nes * (k.NPOS + 4) * ESW * 4;
  k.ds_elems = k.MT * 16 * DSW;
  return k.off_ds + nds * k.ds_elems * 2;
}

// Launches `kernel` cooperatively with `threads` threads a block; `regs` is
// the registers a thread the kernel's roles take after setmaxnreg (0: none).
int launch(const void* kernel, Chain& p, int threads, int regs, int smem, int grid, cudaStream_t stream,
           bool (&asked)[kMaxDevices]) {
  // the dynamic shared memory is asked for once a device
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!asked[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    asked[dev] = true;
  }
  // setmaxnreg only moves registers inside the thread block: the consumers'
  // increase waits for the producers' release, so the launch must hold all
  // the registers the roles take, or the consumers would wait forever
  cudaFuncAttributes attr;
  if ((e = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return static_cast<int>(e);
  if (attr.numRegs < regs) return static_cast<int>(cudaErrorInvalidConfiguration);
  // a cooperative grid must be resident all at once
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  if (grid > sms * per_sm) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  p.threads = threads;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(threads), args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int NW, int PMX, int PNX>
int launch_all(Chain& p, int smem, int grid, cudaStream_t stream) {
  static bool asked[kMaxDevices] = {};
  return launch(reinterpret_cast<const void*>(planar_chain_all<NW, PMX, PNX>), p, NW * 32, 0, smem, grid, stream,
                asked);
}

template <int NP, int NC, int PMX, int PNX, int REG_P, int REG_C>
int launch_split(Chain& p, int smem, int grid, cudaStream_t stream) {
  static bool asked[kMaxDevices] = {};
  constexpr int kThreadsAll = (NP + NC) * 32;
  return launch(reinterpret_cast<const void*>(planar_chain_split<NP, NC, PMX, PNX, REG_P, REG_C>), p, kThreadsAll,
                (NP * REG_P + NC * REG_C) * 32 / kThreadsAll, smem, grid, stream, asked);
}

// cuTensorMapEncodeTiled of the driver, found once in the loaded libcuda (the
// library then needs no link against it); null if it is not there.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// The input (B, Cin, H*Wp) as a 2-D tensor of H*Wp positions by B*Cin planes,
// read in boxes of IWB positions by Cin planes: one box a halo row of a tile.
bool input_map(CUtensorMap* map, const Chain& p, const Block& k) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.H) * p.Wp, static_cast<cuuint64_t>(p.B) * k.cin};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.H) * p.Wp * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(k.IWB), static_cast<cuuint32_t>(k.cin)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<__nv_bfloat16*>(p.x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NW, int PMX, int PNX>
int launch_stream(Chain& p, const CUtensorMap& map, int smem, int grid, cudaStream_t stream) {
  static bool asked[kMaxDevices] = {};
  const void* kernel = reinterpret_cast<const void*>(planar_block_stream<NW, PMX, PNX>);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!asked[dev]) {
    // the most shared memory a block may take, and the SM's memory split in
    // favour of shared memory, so that two blocks of up to 113 KB fit
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem)) != cudaSuccess ||
        (e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100)) != cudaSuccess) {
      return static_cast<int>(e);
    }
    asked[dev] = true;
  }
  p.threads = NW * 32;
  planar_block_stream<NW, PMX, PNX><<<grid, NW * 32, smem, stream>>>(p, map);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A chain of n blocks (1..16) in one cooperative launch on `stream`; returns
// the CUDA error of the launch as an int (0: launched), or
// cudaErrorInvalidValue for shapes or a plan the kernel does not take.
// x (B, C_0, H*Wp) and out (B, C_last, H*Wp) bf16, contiguous; scratch0 and
// scratch1 (B, widest intermediate C, H*Wp) bf16, scratch0 needed for n > 1,
// scratch1 for n > 2; `packed` (packed_bytes, 16-byte aligned) as
// pack_planar_chain lays it out; `table` holds ten ints a block (host memory):
// Cin, Ce, Cout, skip, expand, chunk width, tile rows, tile columns, PM, PN.
// (producers, consumers, pmx, pnx) name the kernel variant: with consumers 0,
// `producers` warps take every stage, else producer and consumer warps; one
// thread block an SM. smem_bytes and grid are the plan's (plan_planar_chain).
extern "C" int tcf_planar_chain(
    const void* x, void* out, void* scratch0, void* scratch1, const void* packed, long long packed_bytes,
    const int* table, int n, int B, int H, int W, int Wp, int relu6,
    int producers, int consumers, int pmx, int pnx, int smem_bytes, int grid, void* stream) {
  if (!x || !out || !packed || !table || n < 1 || n > kMaxBlocks || (n > 1 && !scratch0) || (n > 2 && !scratch1) ||
      B < 1 || H < 1 || W < 1 || Wp < W || static_cast<long long>(H) * Wp >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(packed) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool split = consumers > 0;
  Chain p;   // the launch copies it
  p.n = n; p.B = B; p.H = H; p.W = W; p.Wp = Wp; p.relu6 = relu6;
  long long at = 0;
  int chunk_max = 0, tile_max = 0, most_items = 0;
  for (int i = 0; i < n; ++i) {
    Block& k = p.blk[i];
    const int* t = table + kTable * i;
    k.cin = t[0]; k.ce = t[1]; k.cout = t[2]; k.skip = t[3]; k.expand = t[4];
    k.ck = t[5]; k.th = t[6]; k.tw = t[7]; k.pm = t[8]; k.pn = t[9];
    const int tile = derive(k, B, H, W, Wp, split ? consumers : producers, pmx, pnx, split ? 1 : 2, split ? 2 : 1);
    if (tile < 0 || (i > 0 && k.cin != p.blk[i - 1].cout)) return static_cast<int>(cudaErrorInvalidValue);
    k.wofs = at;
    at += static_cast<long long>(k.nchunks) * k.chunk_bytes + round_up(4 * k.cout, 16);
    chunk_max = chunk_max > k.chunk_bytes ? chunk_max : k.chunk_bytes;
    tile_max = tile_max > tile ? tile_max : tile;
    most_items = most_items > k.items ? most_items : k.items;
  }
  p.chunk_max = chunk_max;
  const long long smem = static_cast<long long>(kBuffers) * chunk_max + tile_max;
  if (at != packed_bytes || smem != smem_bytes || smem > kMaxSmem || grid < 1 || grid > most_items) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.scratch[0] = static_cast<__nv_bfloat16*>(scratch0);
  p.scratch[1] = static_cast<__nv_bfloat16*>(scratch1);
  p.packed = static_cast<const uint8_t*>(packed);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!split && producers == 16 && pmx == 2 && pnx == 4) return launch_all<16, 2, 4>(p, smem_bytes, grid, s);
  if (producers == 8 && consumers == 8 && pmx == 4 && pnx == 5) return launch_split<8, 8, 4, 5, 96, 160>(p, smem_bytes, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// One block (B4a) on `stream`: x (B, Cin, H*Wp) and out (B, Cout, H*Wp)
// bf16, contiguous, 16-byte aligned; `packed` one block as pack_planar_chain
// lays it out; `table` its ten ints as for tcf_planar_chain. With `streamed`
// the one-block kernel (producers 8, consumers 0, pmx 2, pnx 2 or 4): persistent
// thread blocks, the input tiles by tensor copies; else the chain kernel's
// variant (producers, consumers, pmx, pnx) on a chain of one. chunk_buffers
// (streamed only): 3, a ring, or the block's number of chunks if that is
// more, every chunk resident. smem_bytes and grid are the plan's
// (plan_planar_mbconv). Returns the CUDA error of the launch as an int (0:
// launched), or cudaErrorInvalidValue for shapes or a plan the kernel does
// not take.
extern "C" int tcf_planar_block(
    const void* x, void* out, const void* packed, long long packed_bytes, const int* table,
    int B, int H, int W, int Wp, int relu6, int producers, int consumers, int pmx, int pnx, int streamed,
    int chunk_buffers, int smem_bytes, int grid, void* stream) {
  if (!streamed) {
    return tcf_planar_chain(x, out, nullptr, nullptr, packed, packed_bytes, table, 1, B, H, W, Wp, relu6, producers,
                            consumers, pmx, pnx, smem_bytes, grid, stream);
  }
  if (!x || !out || !packed || !table || B < 1 || H < 1 || W < 1 || Wp < W ||
      static_cast<long long>(H) * Wp >= (1LL << 31) || reinterpret_cast<uintptr_t>(packed) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 || producers != 8 || consumers != 0 || pmx != 2 || (pnx != 2 && pnx != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Chain p;
  p.n = 1; p.B = B; p.H = H; p.W = W; p.Wp = Wp; p.relu6 = relu6;
  Block& k = p.blk[0];
  k.cin = table[0]; k.ce = table[1]; k.cout = table[2]; k.skip = table[3]; k.expand = table[4];
  k.ck = table[5]; k.th = table[6]; k.tw = table[7]; k.pm = table[8]; k.pn = table[9];
  const int tile = derive(k, B, H, W, Wp, producers, pmx, pnx, 1, 1, true);
  if (tile < 0) return static_cast<int>(cudaErrorInvalidValue);
  k.wofs = 0;
  p.chunk_max = k.chunk_bytes;
  if (chunk_buffers != kBuffers && (chunk_buffers != k.nchunks || k.nchunks < kBuffers)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.nbuf = chunk_buffers;
  const long long smem = static_cast<long long>(p.nbuf) * k.chunk_bytes + tile;
  const long long nbytes = static_cast<long long>(k.nchunks) * k.chunk_bytes + round_up(4 * k.cout, 16);
  if (nbytes != packed_bytes || smem != smem_bytes || smem > kMaxSmem || grid < 1 || grid > k.items) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.scratch[0] = p.scratch[1] = nullptr;
  p.packed = static_cast<const uint8_t*>(packed);
  CUtensorMap map;
  if (!input_map(&map, p, k)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pnx == 2 ? launch_stream<8, 2, 2>(p, map, smem_bytes, grid, s) : launch_stream<8, 2, 4>(p, map, smem_bytes, grid, s);
}
