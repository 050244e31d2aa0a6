// reface_native: C++ host-side runtime kernels for the reface_tpu framework.
//
// Role parity: the reference's only native surface is dlib (C++ HOG detector +
// ERT 68-landmark predictor) plus library-internal cv2/PIL kernels
// (SURVEY.md §2.6). This library provides the equivalents for the host side
// of the TPU pipeline:
//   - bilinear resize / generic coordinate-map warp (cv2.remap equivalent)
//   - thin-plate-spline grid solve + mask warp (decow augmentation hot path)
//   - segmentation LUT remap + preserve-list binary masks
//   - uint8 -> float normalization ([-1,1] and CLIP norms)
//   - ERT (ensemble of regression trees) landmark evaluation in the
//     shape-predictor style (cascaded sparse pixel-difference features),
//     using reface's own binary format (tools/convert_dlib_sp.py writes it
//     from a dlib shape_predictor .dat when dlib is available offline).
//
// Everything is plain C ABI for ctypes; OpenMP parallel over rows/batch.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <cstdio>

extern "C" {

// ---------------------------------------------------------------- resize

// Bilinear resize HWC float32, align_corners=False (half-pixel centers).
void rn_resize_bilinear(const float* src, int sh, int sw, int c,
                        float* dst, int dh, int dw) {
  const float sy = (float)sh / dh, sx = (float)sw / dw;
#pragma omp parallel for
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)std::floor(fy);
    float wy = fy - y0;
    int y0c = std::min(std::max(y0, 0), sh - 1);
    int y1c = std::min(std::max(y0 + 1, 0), sh - 1);
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = (int)std::floor(fx);
      float wx = fx - x0;
      int x0c = std::min(std::max(x0, 0), sw - 1);
      int x1c = std::min(std::max(x0 + 1, 0), sw - 1);
      const float* p00 = src + (y0c * sw + x0c) * c;
      const float* p01 = src + (y0c * sw + x1c) * c;
      const float* p10 = src + (y1c * sw + x0c) * c;
      const float* p11 = src + (y1c * sw + x1c) * c;
      float* out = dst + (y * dw + x) * c;
      for (int k = 0; k < c; ++k) {
        float top = p00[k] * (1 - wx) + p01[k] * wx;
        float bot = p10[k] * (1 - wx) + p11[k] * wx;
        out[k] = top * (1 - wy) + bot * wy;
      }
    }
  }
}

// ------------------------------------------------------------------ warp

// Generic map warp: dst(y,x) = src(map_y(y,x), map_x(y,x)), zeros outside.
void rn_remap_bilinear(const float* src, int sh, int sw, int c,
                       const float* map_x, const float* map_y,
                       float* dst, int dh, int dw) {
#pragma omp parallel for
  for (int y = 0; y < dh; ++y) {
    for (int x = 0; x < dw; ++x) {
      float fx = map_x[y * dw + x];
      float fy = map_y[y * dw + x];
      float* out = dst + (y * dw + x) * c;
      if (fx < -1.f || fx > sw || fy < -1.f || fy > sh) {
        for (int k = 0; k < c; ++k) out[k] = 0.f;
        continue;
      }
      int x0 = (int)std::floor(fx), y0 = (int)std::floor(fy);
      float wx = fx - x0, wy = fy - y0;
      for (int k = 0; k < c; ++k) {
        float acc = 0.f;
        for (int dy = 0; dy < 2; ++dy) {
          int yy = y0 + dy;
          if (yy < 0 || yy >= sh) continue;
          float wyy = dy ? wy : 1 - wy;
          for (int dx = 0; dx < 2; ++dx) {
            int xx = x0 + dx;
            if (xx < 0 || xx >= sw) continue;
            float wxx = dx ? wx : 1 - wx;
            acc += src[(yy * sw + xx) * c + k] * wxx * wyy;
          }
        }
        out[k] = acc;
      }
    }
  }
}

// ------------------------------------------------------------------- TPS

// Solve the (p+3)x(p+3) TPS system by Gaussian elimination with partial
// pivoting; U(r) = r^2 log(r^2). ctrl/warped: (p,2) in any coordinate frame.
static bool tps_solve(const float* ctrl, const float* warped, int p,
                      std::vector<double>& w /* (p+3)*2 */) {
  int n = p + 3;
  std::vector<double> A(n * n, 0.0), B(n * 2, 0.0);
  for (int i = 0; i < p; ++i) {
    for (int j = 0; j < p; ++j) {
      double dx = ctrl[i * 2] - ctrl[j * 2];
      double dy = ctrl[i * 2 + 1] - ctrl[j * 2 + 1];
      double r2 = dx * dx + dy * dy;
      A[i * n + j] = r2 > 1e-12 ? r2 * std::log(r2) : 0.0;
    }
    A[i * n + p] = 1.0;
    A[i * n + p + 1] = ctrl[i * 2];
    A[i * n + p + 2] = ctrl[i * 2 + 1];
    A[(p)*n + i] = 1.0;
    A[(p + 1) * n + i] = ctrl[i * 2];
    A[(p + 2) * n + i] = ctrl[i * 2 + 1];
    B[i * 2] = warped[i * 2];
    B[i * 2 + 1] = warped[i * 2 + 1];
  }
  // gaussian elimination
  for (int col = 0; col < n; ++col) {
    int piv = col;
    for (int r = col + 1; r < n; ++r)
      if (std::fabs(A[r * n + col]) > std::fabs(A[piv * n + col])) piv = r;
    if (std::fabs(A[piv * n + col]) < 1e-12) return false;
    if (piv != col) {
      for (int k = 0; k < n; ++k) std::swap(A[col * n + k], A[piv * n + k]);
      std::swap(B[col * 2], B[piv * 2]);
      std::swap(B[col * 2 + 1], B[piv * 2 + 1]);
    }
    double d = A[col * n + col];
    for (int r = col + 1; r < n; ++r) {
      double f = A[r * n + col] / d;
      if (f == 0.0) continue;
      for (int k = col; k < n; ++k) A[r * n + k] -= f * A[col * n + k];
      B[r * 2] -= f * B[col * 2];
      B[r * 2 + 1] -= f * B[col * 2 + 1];
    }
  }
  w.assign(n * 2, 0.0);
  for (int r = n - 1; r >= 0; --r) {
    double s0 = B[r * 2], s1 = B[r * 2 + 1];
    for (int k = r + 1; k < n; ++k) {
      s0 -= A[r * n + k] * w[k * 2];
      s1 -= A[r * n + k] * w[k * 2 + 1];
    }
    w[r * 2] = s0 / A[r * n + r];
    w[r * 2 + 1] = s1 / A[r * n + r];
  }
  return true;
}

// TPS grid in [-1,1] coords: out (h*w*2) = warped positions of the regular
// grid through the spline defined by ctrl -> warped ((p,2) each, [-1,1]).
int rn_tps_grid(const float* ctrl, const float* warped, int p,
                float* out, int h, int w) {
  std::vector<double> q;
  if (!tps_solve(ctrl, warped, p, q)) return -1;
#pragma omp parallel for
  for (int y = 0; y < h; ++y) {
    double gy = h > 1 ? -1.0 + 2.0 * y / (h - 1) : 0.0;
    for (int x = 0; x < w; ++x) {
      double gx = w > 1 ? -1.0 + 2.0 * x / (w - 1) : 0.0;
      double ox = q[p * 2] + q[(p + 1) * 2] * gx + q[(p + 2) * 2] * gy;
      double oy = q[p * 2 + 1] + q[(p + 1) * 2 + 1] * gx + q[(p + 2) * 2 + 1] * gy;
      for (int i = 0; i < p; ++i) {
        double dx = gx - ctrl[i * 2], dy = gy - ctrl[i * 2 + 1];
        double r2 = dx * dx + dy * dy;
        double u = r2 > 1e-12 ? r2 * std::log(r2) : 0.0;
        ox += q[i * 2] * u;
        oy += q[i * 2 + 1] * u;
      }
      out[(y * w + x) * 2] = (float)ox;
      out[(y * w + x) * 2 + 1] = (float)oy;
    }
  }
  return 0;
}

// ------------------------------------------------------------- mask ops

// remap int mask through a LUT
void rn_mask_remap(const int32_t* mask, int n, const int32_t* lut, int lut_n,
                   int32_t* out) {
#pragma omp parallel for
  for (int i = 0; i < n; ++i) {
    int v = mask[i];
    out[i] = (v >= 0 && v < lut_n) ? lut[v] : 0;
  }
}

// binary preserve mask: out[i] = classes contains mask[i] ? 1.f : 0.f
void rn_preserve_mask(const int32_t* mask, int n, const int32_t* classes,
                      int n_classes, float* out) {
  int32_t lut[256];
  std::memset(lut, 0, sizeof(lut));
  for (int i = 0; i < n_classes; ++i)
    if (classes[i] >= 0 && classes[i] < 256) lut[classes[i]] = 1;
#pragma omp parallel for
  for (int i = 0; i < n; ++i) {
    int v = mask[i];
    out[i] = (v >= 0 && v < 256 && lut[v]) ? 1.f : 0.f;
  }
}

// ----------------------------------------------------------- normalize

// uint8 HWC -> float32, y = x/127.5 - 1  (to_tensor_pm1)
void rn_u8_to_pm1(const uint8_t* src, int n, float* dst) {
#pragma omp parallel for
  for (int i = 0; i < n; ++i) dst[i] = src[i] * (1.f / 127.5f) - 1.f;
}

// uint8 HWC(3) -> float32 CLIP-normalized
void rn_u8_to_clip(const uint8_t* src, int npix, float* dst) {
  static const float mean[3] = {0.48145466f, 0.4578275f, 0.40821073f};
  static const float stdv[3] = {0.26862954f, 0.26130258f, 0.27577711f};
#pragma omp parallel for
  for (int i = 0; i < npix; ++i)
    for (int k = 0; k < 3; ++k)
      dst[i * 3 + k] = (src[i * 3 + k] / 255.f - mean[k]) / stdv[k];
}

// ------------------------------------------------------------------- ERT
//
// Ensemble-of-regression-trees landmark cascade (Kazemi & Sullivan 2014,
// the algorithm behind dlib's shape_predictor). Model data layout (all
// little-endian float32/int32, produced by tools/convert_dlib_sp.py):
//   header: int32 magic=0x52455254 ('RERT'), int32 n_points,
//           int32 n_cascades, int32 trees_per_cascade, int32 tree_depth,
//           int32 feats_per_cascade
//   initial_shape: float32[n_points*2]            (normalized [0,1] coords)
//   per cascade:
//     anchor_idx: int32[feats]                    (landmark index per feature)
//     deltas:     float32[feats*2]                (offset from the anchor)
//     per tree:
//       splits: (2^depth - 1) x {int32 f1, int32 f2, float32 thresh}
//       leaves: 2^depth x float32[n_points*2]
//
// Evaluation: features are pixel differences sampled at (anchor + delta)
// positions mapped through the current shape's similarity transform.

struct ERTModel {
  int n_points = 0, n_casc = 0, n_trees = 0, depth = 0, n_feats = 0;
  std::vector<float> init_shape;
  std::vector<std::vector<int32_t>> anchors;
  std::vector<std::vector<float>> deltas;
  // per cascade, per tree: splits + leaves flattened
  std::vector<std::vector<int32_t>> split_f1, split_f2;
  std::vector<std::vector<float>> split_thr;
  std::vector<std::vector<float>> leaves;
};

static ERTModel* g_model = nullptr;

int rn_ert_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  auto rd = [&](void* p, size_t n) { return std::fread(p, 1, n, f) == n; };
  int32_t head[6];
  if (!rd(head, sizeof(head)) || head[0] != 0x52455254) {
    std::fclose(f);
    return -2;
  }
  ERTModel* m = new ERTModel();
  m->n_points = head[1];
  m->n_casc = head[2];
  m->n_trees = head[3];
  m->depth = head[4];
  m->n_feats = head[5];
  int np2 = m->n_points * 2;
  int n_splits = (1 << m->depth) - 1;
  int n_leaves = 1 << m->depth;
  m->init_shape.resize(np2);
  bool ok = rd(m->init_shape.data(), np2 * 4);
  for (int c = 0; ok && c < m->n_casc; ++c) {
    m->anchors.emplace_back(m->n_feats);
    m->deltas.emplace_back(m->n_feats * 2);
    ok = rd(m->anchors[c].data(), m->n_feats * 4) &&
         rd(m->deltas[c].data(), m->n_feats * 8);
    m->split_f1.emplace_back(m->n_trees * n_splits);
    m->split_f2.emplace_back(m->n_trees * n_splits);
    m->split_thr.emplace_back(m->n_trees * n_splits);
    m->leaves.emplace_back((size_t)m->n_trees * n_leaves * np2);
    for (int t = 0; ok && t < m->n_trees; ++t) {
      for (int s = 0; ok && s < n_splits; ++s) {
        int32_t f12[2];
        float thr;
        ok = rd(f12, 8) && rd(&thr, 4);
        m->split_f1[c][t * n_splits + s] = f12[0];
        m->split_f2[c][t * n_splits + s] = f12[1];
        m->split_thr[c][t * n_splits + s] = thr;
      }
      ok = ok && rd(&m->leaves[c][(size_t)t * n_leaves * np2],
                    (size_t)n_leaves * np2 * 4);
    }
  }
  std::fclose(f);
  if (!ok) {
    delete m;
    return -3;
  }
  delete g_model;
  g_model = m;
  return 0;
}

// similarity transform (scale+rot) aligning init_shape -> current shape
static void similarity(const float* from, const float* to, int n,
                       float* a, float* b) {
  // least-squares 2D similarity without translation on mean-centered pts
  double mfx = 0, mfy = 0, mtx = 0, mty = 0;
  for (int i = 0; i < n; ++i) {
    mfx += from[i * 2];
    mfy += from[i * 2 + 1];
    mtx += to[i * 2];
    mty += to[i * 2 + 1];
  }
  mfx /= n; mfy /= n; mtx /= n; mty /= n;
  double num_a = 0, num_b = 0, den = 0;
  for (int i = 0; i < n; ++i) {
    double fx = from[i * 2] - mfx, fy = from[i * 2 + 1] - mfy;
    double tx = to[i * 2] - mtx, ty = to[i * 2 + 1] - mty;
    num_a += fx * tx + fy * ty;
    num_b += fx * ty - fy * tx;
    den += fx * fx + fy * fy;
  }
  *a = den > 1e-12 ? (float)(num_a / den) : 1.f;
  *b = den > 1e-12 ? (float)(num_b / den) : 0.f;
}

// Evaluate on a grayscale uint8 image; box = (x0, y0, x1, y1) face rect.
// out: float32[n_points*2] pixel coords. Returns 0 on success.
int rn_ert_predict(const uint8_t* gray, int h, int w,
                   float bx0, float by0, float bx1, float by1, float* out) {
  if (!g_model) return -1;
  const ERTModel& m = *g_model;
  int np = m.n_points, np2 = np * 2;
  int n_splits = (1 << m.depth) - 1;
  std::vector<float> shape(m.init_shape);  // normalized [0,1] box coords
  float bw = bx1 - bx0, bh = by1 - by0;

  auto sample = [&](float nx, float ny) -> float {
    int px = (int)std::lround(bx0 + nx * bw);
    int py = (int)std::lround(by0 + ny * bh);
    if (px < 0 || px >= w || py < 0 || py >= h) return 0.f;
    return (float)gray[py * w + px];
  };

  std::vector<float> feat(m.n_feats);
  for (int c = 0; c < m.n_casc; ++c) {
    float sa, sb;
    similarity(m.init_shape.data(), shape.data(), np, &sa, &sb);
    for (int fidx = 0; fidx < m.n_feats; ++fidx) {
      int anchor = m.anchors[c][fidx];
      float dx = m.deltas[c][fidx * 2], dy = m.deltas[c][fidx * 2 + 1];
      // rotate/scale delta by the current similarity transform
      float rx = sa * dx - sb * dy, ry = sb * dx + sa * dy;
      feat[fidx] = sample(shape[anchor * 2] + rx, shape[anchor * 2 + 1] + ry);
    }
    for (int t = 0; t < m.n_trees; ++t) {
      int node = 0;
      for (int d = 0; d < m.depth; ++d) {
        const int s = t * n_splits + node;
        float diff = feat[m.split_f1[c][s]] - feat[m.split_f2[c][s]];
        node = node * 2 + 1 + (diff > m.split_thr[c][s] ? 0 : 1);
      }
      int leaf = node - n_splits;
      const float* lv = &m.leaves[c][((size_t)t * (1 << m.depth) + leaf) * np2];
      for (int i = 0; i < np2; ++i) shape[i] += lv[i];
    }
  }
  for (int i = 0; i < np; ++i) {
    out[i * 2] = bx0 + shape[i * 2] * bw;
    out[i * 2 + 1] = by0 + shape[i * 2 + 1] * bh;
  }
  return 0;
}

int rn_ert_n_points() { return g_model ? g_model->n_points : 0; }

}  // extern "C"

extern "C" {

// Batched ERT evaluation: images flattened contiguously, OpenMP over items.
int rn_ert_predict_batch(const uint8_t* grays, int n, int h, int w,
                         const float* boxes /* n*4 */, float* out /* n*np*2 */) {
  if (!g_model) return -1;
  int np2 = g_model->n_points * 2;
  int rc = 0;
#pragma omp parallel for
  for (int i = 0; i < n; ++i) {
    int r = rn_ert_predict(grays + (size_t)i * h * w, h, w, boxes[i * 4],
                           boxes[i * 4 + 1], boxes[i * 4 + 2],
                           boxes[i * 4 + 3], out + (size_t)i * np2);
    if (r != 0) rc = r;
  }
  return rc;
}

}  // extern "C"
