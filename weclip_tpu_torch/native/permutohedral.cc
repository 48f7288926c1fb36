// Permutohedral-lattice Gaussian filtering + dense-CRF mean-field inference.
//
// Native replacement for the reference's pydensecrf C++/Cython extension
// (built against the vendored eigen-3.4.0 tree; used via utils/dcrf.py).
// Implements, from the published algorithms:
//   - Adams, Baek, Davis, "Fast High-Dimensional Filtering Using the
//     Permutohedral Lattice", Eurographics 2010 (splat / blur / slice),
//   - Krähenbühl, Koltun, "Efficient Inference in Fully Connected CRFs with
//     Gaussian Edge Potentials", NeurIPS 2011 (mean-field updates, Potts
//     compatibility, symmetric kernel normalization).
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libpermutohedral.so permutohedral.cc

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Hash table keyed by d-dimensional int16 lattice coordinates.
// ---------------------------------------------------------------------------
struct KeyHash {
  size_t operator()(const std::vector<int16_t>& k) const {
    size_t h = 0;
    for (int16_t v : k) h = h * 2531011u + static_cast<uint16_t>(v);
    return h;
  }
};

class Permutohedral {
 public:
  // features: (n, d) row-major. Builds the lattice (splat weights/offsets).
  Permutohedral(const float* features, int n, int d) : n_(n), d_(d) {
    offsets_.resize(static_cast<size_t>(n) * (d + 1));
    weights_.resize(static_cast<size_t>(n) * (d + 1));

    std::vector<float> elevated(d + 1), rem0(d + 1), barycentric(d + 2);
    std::vector<int> rank(d + 1);
    std::vector<int16_t> canonical((d + 1) * (d + 1));
    for (int i = 0; i <= d; ++i) {
      for (int j = 0; j <= d - i; ++j) canonical[i * (d + 1) + j] = i;
      for (int j = d - i + 1; j <= d; ++j)
        canonical[i * (d + 1) + j] = i - (d + 1);
    }

    std::vector<float> scale_factor(d);
    const float inv_std_dev = std::sqrt(2.0f / 3.0f) * (d + 1);
    for (int i = 0; i < d; ++i)
      scale_factor[i] =
          1.0f / std::sqrt(static_cast<float>((i + 2) * (i + 1))) * inv_std_dev;

    std::unordered_map<std::vector<int16_t>, int, KeyHash> table;
    std::vector<int16_t> key(d);

    for (int k = 0; k < n; ++k) {
      const float* f = features + static_cast<size_t>(k) * d;
      // embed onto the hyperplane H_d (E f)
      float sm = 0.f;
      for (int j = d; j > 0; --j) {
        float cf = f[j - 1] * scale_factor[j - 1];
        elevated[j] = sm - j * cf;
        sm += cf;
      }
      elevated[0] = sm;

      // nearest zero-colored lattice point
      const float down_factor = 1.0f / (d + 1);
      const float up_factor = static_cast<float>(d + 1);
      int sum = 0;
      for (int i = 0; i <= d; ++i) {
        int rd = static_cast<int>(std::round(down_factor * elevated[i]));
        rem0[i] = rd * up_factor;
        sum += rd;
      }

      // rank differential
      for (int i = 0; i <= d; ++i) rank[i] = 0;
      for (int i = 0; i < d; ++i) {
        double di = elevated[i] - rem0[i];
        for (int j = i + 1; j <= d; ++j) {
          if (di < elevated[j] - rem0[j]) ++rank[i];
          else ++rank[j];
        }
      }
      // walk back to the canonical simplex if sum != 0
      for (int i = 0; i <= d; ++i) {
        rank[i] += sum;
        if (rank[i] < 0) {
          rank[i] += d + 1;
          rem0[i] += d + 1;
        } else if (rank[i] > d) {
          rank[i] -= d + 1;
          rem0[i] -= d + 1;
        }
      }

      // barycentric coordinates
      std::fill(barycentric.begin(), barycentric.end(), 0.f);
      for (int i = 0; i <= d; ++i) {
        float v = (elevated[i] - rem0[i]) * down_factor;
        barycentric[d - rank[i]] += v;
        barycentric[d - rank[i] + 1] -= v;
      }
      barycentric[0] += 1.0f + barycentric[d + 1];

      // splat to the d+1 simplex vertices
      for (int remainder = 0; remainder <= d; ++remainder) {
        for (int i = 0; i < d; ++i)
          key[i] = static_cast<int16_t>(
              rem0[i] + canonical[remainder * (d + 1) + rank[i]]);
        auto it = table.find(key);
        int idx;
        if (it == table.end()) {
          idx = static_cast<int>(table.size());
          table.emplace(key, idx);
          keys_.insert(keys_.end(), key.begin(), key.end());
        } else {
          idx = it->second;
        }
        offsets_[static_cast<size_t>(k) * (d + 1) + remainder] = idx;
        weights_[static_cast<size_t>(k) * (d + 1) + remainder] =
            barycentric[remainder];
      }
    }
    m_ = static_cast<int>(table.size());

    // blur neighbors along each lattice direction
    blur_n1_.resize(static_cast<size_t>(d + 1) * m_);
    blur_n2_.resize(static_cast<size_t>(d + 1) * m_);
    std::vector<int16_t> np(d), nm(d);
    for (int j = 0; j <= d; ++j) {
      for (int i = 0; i < m_; ++i) {
        const int16_t* kk = keys_.data() + static_cast<size_t>(i) * d;
        for (int kdim = 0; kdim < d; ++kdim) {
          np[kdim] = kk[kdim] + 1;
          nm[kdim] = kk[kdim] - 1;
        }
        if (j < d) {
          np[j] = kk[j] - d;
          nm[j] = kk[j] + d;
        }
        auto itp = table.find(np);
        auto itm = table.find(nm);
        blur_n1_[static_cast<size_t>(j) * m_ + i] =
            itp == table.end() ? -1 : itp->second;
        blur_n2_[static_cast<size_t>(j) * m_ + i] =
            itm == table.end() ? -1 : itm->second;
      }
    }
  }

  // out (n, vd) = filter(in (n, vd)); in may alias out.
  void Compute(const float* in, float* out, int vd) const {
    std::vector<float> values(static_cast<size_t>(m_ + 2) * vd, 0.f);
    std::vector<float> new_values(static_cast<size_t>(m_ + 2) * vd, 0.f);

    // splat
    for (int k = 0; k < n_; ++k)
      for (int r = 0; r <= d_; ++r) {
        int o = offsets_[static_cast<size_t>(k) * (d_ + 1) + r];
        float w = weights_[static_cast<size_t>(k) * (d_ + 1) + r];
        float* v = values.data() + static_cast<size_t>(o + 1) * vd;
        const float* x = in + static_cast<size_t>(k) * vd;
        for (int c = 0; c < vd; ++c) v[c] += w * x[c];
      }

    // blur along each direction: (1, 2, 1) / 2 stencil
    for (int j = 0; j <= d_; ++j) {
      for (int i = 0; i < m_; ++i) {
        const float* old = values.data() + static_cast<size_t>(i + 1) * vd;
        float* nv = new_values.data() + static_cast<size_t>(i + 1) * vd;
        int i1 = blur_n1_[static_cast<size_t>(j) * m_ + i];
        int i2 = blur_n2_[static_cast<size_t>(j) * m_ + i];
        const float* v1 = values.data() + static_cast<size_t>(i1 + 1) * vd;
        const float* v2 = values.data() + static_cast<size_t>(i2 + 1) * vd;
        for (int c = 0; c < vd; ++c)
          nv[c] = old[c] + 0.5f * ((i1 >= 0 ? v1[c] : 0.f) +
                                   (i2 >= 0 ? v2[c] : 0.f));
      }
      values.swap(new_values);
    }

    // slice (alpha undoes the blur's overcounting)
    const float alpha = 1.0f / (1.0f + std::pow(2.0f, -d_));
    for (int k = 0; k < n_; ++k) {
      float* o = out + static_cast<size_t>(k) * vd;
      for (int c = 0; c < vd; ++c) o[c] = 0.f;
      for (int r = 0; r <= d_; ++r) {
        int off = offsets_[static_cast<size_t>(k) * (d_ + 1) + r];
        float w = weights_[static_cast<size_t>(k) * (d_ + 1) + r];
        const float* v = values.data() + static_cast<size_t>(off + 1) * vd;
        for (int c = 0; c < vd; ++c) o[c] += w * v[c] * alpha;
      }
    }
  }

 private:
  int n_, d_, m_ = 0;
  std::vector<int> offsets_;
  std::vector<float> weights_;
  std::vector<int16_t> keys_;
  std::vector<int> blur_n1_, blur_n2_;
};

// symmetric kernel normalization (Krähenbühl's NORMALIZE_SYMMETRIC):
// filter'(x) = norm .* filter(norm .* x),  norm = 1/sqrt(filter(1))
struct Kernel {
  Permutohedral lattice;
  std::vector<float> norm;
  float weight;

  Kernel(const float* features, int n, int d, float w)
      : lattice(features, n, d), weight(w) {
    std::vector<float> ones(n, 1.f);
    norm.resize(n);
    lattice.Compute(ones.data(), norm.data(), 1);
    for (int i = 0; i < n; ++i)
      norm[i] = 1.0f / std::sqrt(norm[i] + 1e-20f);
  }

  // out += weight * norm .* filter(norm .* q)   (Potts: label-wise)
  void Apply(const float* q, float* out, int n, int labels,
             std::vector<float>& tmp) const {
    tmp.resize(static_cast<size_t>(n) * labels);
    for (int i = 0; i < n; ++i)
      for (int l = 0; l < labels; ++l)
        tmp[static_cast<size_t>(i) * labels + l] =
            q[static_cast<size_t>(i) * labels + l] * norm[i];
    lattice.Compute(tmp.data(), tmp.data(), labels);
    for (int i = 0; i < n; ++i)
      for (int l = 0; l < labels; ++l)
        out[static_cast<size_t>(i) * labels + l] +=
            weight * norm[i] * tmp[static_cast<size_t>(i) * labels + l];
  }
};

void Softmax(const float* in, float* out, int n, int labels) {
  for (int i = 0; i < n; ++i) {
    const float* x = in + static_cast<size_t>(i) * labels;
    float* y = out + static_cast<size_t>(i) * labels;
    float mx = x[0];
    for (int l = 1; l < labels; ++l) mx = std::max(mx, x[l]);
    float s = 0.f;
    for (int l = 0; l < labels; ++l) {
      y[l] = std::exp(x[l] - mx);
      s += y[l];
    }
    for (int l = 0; l < labels; ++l) y[l] /= s;
  }
}

}  // namespace

extern "C" {

// Generic permutohedral filter: out (n, vd) = G_features * in.
void permutohedral_filter(const float* features, int n, int d,
                          const float* in, int vd, float* out) {
  Permutohedral lattice(features, n, d);
  lattice.Compute(in, out, vd);
}

// DenseCRF2D mean-field inference with the reference's kernel setup
// (utils/dcrf.py:7-37 + test_msc_flip_voc.py:126-133):
//   - Gaussian kernel: sxy = pos_xy_std, weight = pos_w
//   - Bilateral kernel: sxy = bi_xy_std, srgb = bi_rgb_std, weight = bi_w
// probs: (h*w, labels) row-major softmax probabilities (unary = -log p).
// image: (h*w, 3) uint8 RGB. Result Q written back into probs.
void dense_crf_inference(float* probs, const uint8_t* image, int h, int w,
                         int labels, int n_iter, float pos_xy_std, float pos_w,
                         float bi_xy_std, float bi_rgb_std, float bi_w) {
  const int n = h * w;

  std::vector<float> feat_pos(static_cast<size_t>(n) * 2);
  std::vector<float> feat_bi(static_cast<size_t>(n) * 5);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int i = y * w + x;
      feat_pos[i * 2 + 0] = x / pos_xy_std;
      feat_pos[i * 2 + 1] = y / pos_xy_std;
      feat_bi[i * 5 + 0] = x / bi_xy_std;
      feat_bi[i * 5 + 1] = y / bi_xy_std;
      feat_bi[i * 5 + 2] = image[i * 3 + 0] / bi_rgb_std;
      feat_bi[i * 5 + 3] = image[i * 3 + 1] / bi_rgb_std;
      feat_bi[i * 5 + 4] = image[i * 3 + 2] / bi_rgb_std;
    }

  Kernel k_pos(feat_pos.data(), n, 2, pos_w);
  Kernel k_bi(feat_bi.data(), n, 5, bi_w);

  std::vector<float> unary(static_cast<size_t>(n) * labels);
  for (size_t i = 0; i < unary.size(); ++i)
    unary[i] = -std::log(std::max(probs[i], 1e-20f));

  std::vector<float> q(static_cast<size_t>(n) * labels);
  std::vector<float> tmp1(static_cast<size_t>(n) * labels);
  std::vector<float> tmp;
  // Q0 = softmax(-unary)
  for (size_t i = 0; i < unary.size(); ++i) tmp1[i] = -unary[i];
  Softmax(tmp1.data(), q.data(), n, labels);

  for (int it = 0; it < n_iter; ++it) {
    for (size_t i = 0; i < unary.size(); ++i) tmp1[i] = -unary[i];
    k_pos.Apply(q.data(), tmp1.data(), n, labels, tmp);
    k_bi.Apply(q.data(), tmp1.data(), n, labels, tmp);
    Softmax(tmp1.data(), q.data(), n, labels);
  }
  std::memcpy(probs, q.data(), sizeof(float) * n * labels);
}

}  // extern "C"
