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
// Design: one thread block (4 warps) per tile of 128 pixels x 64 output
// channels of one image. K is walked in chunks of 64: the chunk's weights go
// to shared memory row-major (output channel, k), and the chunk's inputs are
// transposed into shared memory pixel-major (pixel, k), so both operands of
// mma.sync.m16n8k32 (s8 x s8 -> s32) are read as 32-bit words along k. Warp w
// owns pixels 32w..32w+31 (four n tiles) and all four m tiles; the int32
// sums stay in registers until the epilogue. Channels and pixels past the
// ends are zero-padded in shared memory and masked on store.
//
// Bound on an H100 SXM: bytes. The kernel reads x once and writes out once,
// B*P*(Cin + Cout) bytes, against 2*B*P*Cin*Cout int8 operations, far below
// the tensor cores' rate at these widths. This first version loads x and
// stores out one byte per thread (coalesced across the warp, but many
// instructions); vector loads and a TMA pipeline are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPix = 128;          // pixels per tile
constexpr int kCo = 64;            // output channels per tile
constexpr int kK = 64;             // K per chunk
constexpr int kStride = kK + 16;   // shared row stride in bytes (conflict-free fragment loads)

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

__device__ __forceinline__ int8_t requant(int acc, float s, float b) {
  const float y = __fadd_rn(__fmul_rn(static_cast<float>(acc), s), b);
  return static_cast<int8_t>(fminf(fmaxf(rintf(y), -127.f), 127.f));
}

__global__ void __launch_bounds__(kThreads)
conv1x1_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                    const float* __restrict__ bias, int8_t* __restrict__ out, int Cin, int P, int Cout) {
  __shared__ __align__(16) int8_t ws[kCo * kStride];
  __shared__ __align__(16) int8_t xs[kPix * kStride];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int p0 = blockIdx.x * kPix;
  const int co0 = blockIdx.y * kCo;
  const int img = blockIdx.z;
  const int8_t* xb = x + static_cast<size_t>(img) * Cin * P;

  int acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0;

  for (int k0 = 0; k0 < Cin; k0 += kK) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < kCo * kK; i += kThreads) {
      const int r = i / kK;
      const int k = i - r * kK;
      int8_t v = 0;
      if (co0 + r < Cout && k0 + k < Cin) v = w[static_cast<size_t>(co0 + r) * Cin + k0 + k];
      ws[r * kStride + k] = v;
    }
    for (int i = tid; i < kK * kPix; i += kThreads) {
      const int k = i / kPix;
      const int px = i - k * kPix;
      int8_t v = 0;
      if (k0 + k < Cin && p0 + px < P) v = xb[static_cast<size_t>(k0 + k) * P + p0 + px];
      xs[px * kStride + k] = v;
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kK / 32; ++ks) {
      uint32_t bw[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* bp = xs + (warp * 32 + nt * 8 + g) * kStride + ks * 32 + 4 * tig;
        bw[nt][0] = lds32(bp);
        bw[nt][1] = lds32(bp + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int8_t* ap = ws + (mt * 16 + g) * kStride + ks * 32 + 4 * tig;
        const uint32_t a[4] = {lds32(ap), lds32(ap + 8 * kStride), lds32(ap + 16), lds32(ap + 8 * kStride + 16)};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a, bw[nt][0], bw[nt][1]);
      }
    }
  }

  int8_t* ob = out + static_cast<size_t>(img) * Cout * P;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = co0 + mt * 16 + g + 8 * half;
      if (co >= Cout) continue;
      const float s = scale[co];
      const float b = bias[co];
      int8_t* o = ob + static_cast<size_t>(co) * P;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int px = p0 + warp * 32 + nt * 8 + 2 * tig;
        if (px < P) o[px] = requant(acc[mt][nt][2 * half], s, b);
        if (px + 1 < P) o[px + 1] = requant(acc[mt][nt][2 * half + 1], s, b);
      }
    }
  }
}

}  // namespace

// Launches the conv on `stream`; returns cudaGetLastError() as an int.
// x (B, Cin, P) int8, w (Cout, Cin) int8, scale and bias (Cout) float32,
// out (B, Cout, P) int8, all contiguous.
extern "C" int tcf_int8_conv1x1(const void* x, const void* w, const void* scale, const void* bias, void* out,
                                int B, int Cin, int P, int Cout, void* stream) {
  if (B < 1 || Cin < 1 || P < 1 || Cout < 1 || B > 65535 || (Cout + kCo - 1) / kCo > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((P + kPix - 1) / kPix, (Cout + kCo - 1) / kCo, B);
  conv1x1_int8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<int8_t*>(out), Cin, P, Cout);
  return static_cast<int>(cudaGetLastError());
}
