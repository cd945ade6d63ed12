// Host eval kernels: the IoU matrix of the WIDER protocol and greedy NMS
// (eval/wider_eval.py::bbox_overlaps, eval/tta.py::nms).
//
// Mirrors tpucenterface/native/nms_ext.cpp. bbox_overlaps computes in
// double; nms takes float32 detections, so on float64 input near the
// threshold it can decide otherwise than the numpy loop (the plain version,
// eval/tta.py::nms_plain), which computes in double.
//
// Build: g++ -O3 -shared -fPIC nms_ext.cpp -o libnms_ext.so -lpthread
// ABI: plain C, loaded with ctypes (tpucenterface_torch/native/__init__.py).

#include <cstdint>
#include <algorithm>
#include <vector>

extern "C" {

// IoU matrix between boxes (n,4) and query (m,4), xyxy, +1 pixel convention
// (matches the WIDER eval tool). out must hold n*m doubles.
void bbox_overlaps(const double* boxes, int64_t n, const double* query,
                   int64_t m, double* out) {
  for (int64_t i = 0; i < n; ++i) {
    const double bx1 = boxes[i * 4 + 0], by1 = boxes[i * 4 + 1];
    const double bx2 = boxes[i * 4 + 2], by2 = boxes[i * 4 + 3];
    const double barea = (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0);
    for (int64_t j = 0; j < m; ++j) {
      const double qx1 = query[j * 4 + 0], qy1 = query[j * 4 + 1];
      const double qx2 = query[j * 4 + 2], qy2 = query[j * 4 + 3];
      const double iw =
          std::min(bx2, qx2) - std::max(bx1, qx1) + 1.0;
      const double ih =
          std::min(by2, qy2) - std::max(by1, qy1) + 1.0;
      double iou = 0.0;
      if (iw > 0.0 && ih > 0.0) {
        const double qarea = (qx2 - qx1 + 1.0) * (qy2 - qy1 + 1.0);
        const double inter = iw * ih;
        iou = inter / (barea + qarea - inter);
      }
      out[i * m + j] = iou;
    }
  }
}

// Greedy IoU NMS over score-DESCENDING dets (n,5) xyxy+score (float32).
// keep must hold n int64; returns the number kept.
int64_t nms(const float* dets, int64_t n, float thresh, int64_t* keep) {
  std::vector<char> suppressed(n, 0);
  std::vector<float> areas(n);
  for (int64_t i = 0; i < n; ++i) {
    areas[i] = (dets[i * 5 + 2] - dets[i * 5 + 0] + 1.0f) *
               (dets[i * 5 + 3] - dets[i * 5 + 1] + 1.0f);
  }
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (suppressed[i]) continue;
    keep[count++] = i;
    const float x1 = dets[i * 5 + 0], y1 = dets[i * 5 + 1];
    const float x2 = dets[i * 5 + 2], y2 = dets[i * 5 + 3];
    for (int64_t j = i + 1; j < n; ++j) {
      if (suppressed[j]) continue;
      const float iw =
          std::min(x2, dets[j * 5 + 2]) - std::max(x1, dets[j * 5 + 0]) + 1.0f;
      if (iw <= 0.0f) continue;
      const float ih =
          std::min(y2, dets[j * 5 + 3]) - std::max(y1, dets[j * 5 + 1]) + 1.0f;
      if (ih <= 0.0f) continue;
      const float inter = iw * ih;
      const float iou = inter / (areas[i] + areas[j] - inter);
      if (iou > thresh) suppressed[j] = 1;
    }
  }
  return count;
}

}  // extern "C"
