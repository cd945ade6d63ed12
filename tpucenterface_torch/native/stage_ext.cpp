// Host staging kernel for the int8-input serving path: apply the stem's
// per-channel uint8 -> int8 quantization table while copying request images
// into the coalesced launch buffer (runtime/serving.py, int8_input mode).
//
// Mirrors tpucenterface/native/stage_ext.cpp. The table itself is built on
// the device (Detector.stem_input_lut), so the staged bytes equal the
// in-program quantization; this kernel only gathers through the 256x3 table.
// std::thread splits the pixels; below 64k pixels it runs inline.
//
// Build: g++ -O3 -shared -fPIC stage_ext.cpp -o libstage_ext.so -lpthread
// ABI: plain C, loaded with ctypes (tpucenterface_torch/native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

void lut_rows(const uint8_t* src, int8_t* dst, int64_t npix,
              const int8_t* l0, const int8_t* l1, const int8_t* l2) {
  for (int64_t i = 0; i < npix; ++i) {
    dst[i * 3 + 0] = l0[src[i * 3 + 0]];
    dst[i * 3 + 1] = l1[src[i * 3 + 1]];
    dst[i * 3 + 2] = l2[src[i * 3 + 2]];
  }
}

}  // namespace

extern "C" {

// src: npix interleaved 3-channel uint8 pixels; lut: (256, 3) int8, row-major
// (lut[v*3 + c] = quantized value of raw pixel v in channel c); dst: npix*3
// int8. nthreads <= 1 runs inline.
void stem_lut_apply(const uint8_t* src, int64_t npix, const int8_t* lut,
                    int8_t* dst, int32_t nthreads) {
  // deinterleave the table once: three 256-entry channel tables stay in L1
  int8_t l0[256], l1[256], l2[256];
  for (int v = 0; v < 256; ++v) {
    l0[v] = lut[v * 3 + 0];
    l1[v] = lut[v * 3 + 1];
    l2[v] = lut[v * 3 + 2];
  }
  if (nthreads <= 1 || npix < (1 << 16)) {
    lut_rows(src, dst, npix, l0, l1, l2);
    return;
  }
  std::vector<std::thread> pool;
  const int64_t chunk = (npix + nthreads - 1) / nthreads;
  for (int32_t t = 0; t < nthreads; ++t) {
    const int64_t lo = t * chunk;
    if (lo >= npix) break;
    const int64_t n = std::min(chunk, npix - lo);
    pool.emplace_back(lut_rows, src + lo * 3, dst + lo * 3, n, l0, l1, l2);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
