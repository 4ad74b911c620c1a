// LSD — Line Segment Detector (von Gioi et al., IPOL 2012 algorithm),
// implemented from scratch in C++ as this framework's native line-detection
// component. The reference (fkluger/vanishing_points_2017) consumes the
// same algorithm through its lsdpython C/Cython submodule
// (evaluation.py:238: input float64 grayscale scaled to [0,255]; output
// rows with endpoint columns 0-3 and -log10(NFA) at column 6).
//
// Pipeline: Gaussian subsampling (scale 0.8) -> 2x2 gradient + level-line
// angles -> pseudo-ordering by gradient magnitude (1024 bins) -> greedy
// region growing with 22.5 deg angular tolerance -> rectangle fit via
// weighted second moments -> a-contrario NFA validation with rectangle
// improvement. Parameters are the canonical LSD defaults.
//
// C ABI (ctypes-friendly):
//   lsd_detect(image, w, h, &out, &n): out = n rows x 7 doubles
//       (x1, y1, x2, y2, width, precision, -log10(NFA))
//   lsd_free(out)
//
// PROVENANCE / LICENSE NOTE (deliberate decision, see README "Licensing"):
// this file implements the algorithm published in von Gioi, Jakubowicz,
// Morel, Randall, "LSD: a Line Segment Detector", IPOL 2012
// (doi:10.5201/ipol.2012.gjmr-lsd). The IPOL reference C implementation is
// AGPL-3.0; this C++ code was written from the paper's algorithm
// description and therefore necessarily matches its numeric scaffolding
// (Lanczos log-gamma, Windschitl approximation, NFA tail-sum bound,
// rect_improve schedule — those ARE the published algorithm). The upstream
// reference project kept the AGPL code out of its tree via a git submodule
// (fkluger/lsd-python); anyone redistributing THIS repository should
// either treat this file as AGPL-compatible or swap in the on-device
// detector (ops/lines_device.py), which is an independent clean-room
// formulation and the production path anyway.

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <limits>

namespace {

constexpr double kScale = 0.8;
constexpr double kSigmaScale = 0.6;
constexpr double kQuant = 2.0;
constexpr double kAngTh = 22.5;
constexpr double kLogEps = 0.0;
constexpr double kDensityTh = 0.7;
constexpr int kNBins = 1024;
constexpr double kPi = 3.14159265358979323846;
constexpr double kNotDef = -1024.0;  // level-line angle "undefined"

struct Pt { int x, y; };

struct Rect {
  double x1, y1, x2, y2;  // endpoints of the main axis
  double width;
  double x, y;            // centre
  double theta, dx, dy;   // axis angle + unit direction
  double prec;            // angular tolerance (rad)
  double p;               // probability of an aligned point
};

struct Image {
  int w = 0, h = 0;
  std::vector<double> v;
  double& at(int x, int y) { return v[y * w + x]; }
  double at(int x, int y) const { return v[y * w + x]; }
};

// ---------- Gaussian subsampling ----------

static void gaussian_kernel(std::vector<double>& k, double sigma, double mean) {
  double sum = 0.0;
  for (size_t i = 0; i < k.size(); ++i) {
    double val = (static_cast<double>(i) - mean) / sigma;
    k[i] = std::exp(-0.5 * val * val);
    sum += k[i];
  }
  if (sum > 0) for (auto& x : k) x /= sum;
}

static Image gaussian_sampler(const Image& in, double scale, double sigma_scale) {
  Image out;
  out.w = static_cast<int>(std::ceil(in.w * scale));
  out.h = static_cast<int>(std::ceil(in.h * scale));
  out.v.resize(static_cast<size_t>(out.w) * out.h);

  double sigma = scale < 1.0 ? sigma_scale / scale : sigma_scale;
  const double prec = 3.0;
  int half = static_cast<int>(std::ceil(sigma * std::sqrt(2.0 * prec * std::log(10.0))));
  int ksize = 1 + 2 * half;
  std::vector<double> kern(ksize);

  // x-convolved intermediate at output x resolution, input y resolution
  Image aux;
  aux.w = out.w; aux.h = in.h;
  aux.v.resize(static_cast<size_t>(aux.w) * aux.h);

  for (int x = 0; x < aux.w; ++x) {
    double xx = static_cast<double>(x) / scale;  // sample position in input
    int xc = static_cast<int>(std::floor(xx + 0.5));
    gaussian_kernel(kern, sigma, static_cast<double>(half) + xx - xc);
    for (int y = 0; y < aux.h; ++y) {
      double sum = 0.0;
      for (int i = 0; i < ksize; ++i) {
        int j = xc - half + i;
        // symmetric boundary extension
        while (j < 0) j += 2 * in.w;
        while (j >= 2 * in.w) j -= 2 * in.w;
        if (j >= in.w) j = 2 * in.w - 1 - j;
        sum += in.at(j, y) * kern[i];
      }
      aux.at(x, y) = sum;
    }
  }
  for (int y = 0; y < out.h; ++y) {
    double yy = static_cast<double>(y) / scale;
    int yc = static_cast<int>(std::floor(yy + 0.5));
    gaussian_kernel(kern, sigma, static_cast<double>(half) + yy - yc);
    for (int x = 0; x < out.w; ++x) {
      double sum = 0.0;
      for (int i = 0; i < ksize; ++i) {
        int j = yc - half + i;
        while (j < 0) j += 2 * in.h;
        while (j >= 2 * in.h) j -= 2 * in.h;
        if (j >= in.h) j = 2 * in.h - 1 - j;
        sum += aux.at(x, j) * kern[i];
      }
      out.at(x, y) = sum;
    }
  }
  return out;
}

// ---------- gradient ----------

struct Grad {
  Image angle;   // level-line angle, kNotDef where below threshold
  Image modgrad;
};

static Grad compute_gradient(const Image& img, double threshold,
                             std::vector<int>& sorted_pixels, int n_bins) {
  Grad g;
  g.angle.w = g.modgrad.w = img.w;
  g.angle.h = g.modgrad.h = img.h;
  g.angle.v.assign(static_cast<size_t>(img.w) * img.h, kNotDef);
  g.modgrad.v.assign(static_cast<size_t>(img.w) * img.h, 0.0);

  double max_grad = 0.0;
  for (int y = 0; y < img.h - 1; ++y) {
    for (int x = 0; x < img.w - 1; ++x) {
      // 2x2 mask
      double com1 = img.at(x + 1, y + 1) - img.at(x, y);
      double com2 = img.at(x + 1, y) - img.at(x, y + 1);
      double gx = com1 + com2;
      double gy = com1 - com2;
      double norm = std::sqrt((gx * gx + gy * gy) / 4.0);
      g.modgrad.at(x, y) = norm;
      if (norm > threshold) {
        g.angle.at(x, y) = std::atan2(gx, -gy);  // level-line angle
        if (norm > max_grad) max_grad = norm;
      }
    }
  }

  // pseudo-sort into bins, descending magnitude
  std::vector<std::vector<int>> bins(n_bins);
  for (int y = 0; y < img.h - 1; ++y) {
    for (int x = 0; x < img.w - 1; ++x) {
      double norm = g.modgrad.at(x, y);
      int b = max_grad > 0
          ? static_cast<int>(norm * n_bins / max_grad) : 0;
      if (b >= n_bins) b = n_bins - 1;
      bins[b].push_back(y * img.w + x);
    }
  }
  sorted_pixels.clear();
  sorted_pixels.reserve(static_cast<size_t>(img.w) * img.h);
  for (int b = n_bins - 1; b >= 0; --b)
    for (int idx : bins[b]) sorted_pixels.push_back(idx);
  return g;
}

// ---------- NFA (a-contrario validation) ----------

static double log_gamma_lanczos(double x) {
  static const double q[7] = {75122.6331530, 80916.6278952, 36308.2951477,
                              8687.24529705, 1168.92649479, 83.8676043424,
                              2.50662827511};
  double a = (x + 0.5) * std::log(x + 5.5) - (x + 5.5);
  double b = 0.0;
  for (int n = 0; n < 7; ++n) {
    a -= std::log(x + static_cast<double>(n));
    b += q[n] * std::pow(x, static_cast<double>(n));
  }
  return a + std::log(b);
}

static double log_gamma_windschitl(double x) {
  return 0.918938533204673 + (x - 0.5) * std::log(x) - x +
         0.5 * x * std::log(x * std::sinh(1.0 / x) + 1.0 / (810.0 * std::pow(x, 6.0)));
}

static double log_gamma(double x) {
  return x > 15.0 ? log_gamma_windschitl(x) : log_gamma_lanczos(x);
}

// -log10(NFA) for k aligned points of n total, alignment probability p.
static double nfa(int n, int k, double p, double logNT) {
  if (n < 0 || k < 0 || k > n || p <= 0.0 || p >= 1.0) return -logNT;
  if (n == 0 || k == 0) return -logNT;
  if (n == k) return -logNT - static_cast<double>(n) * std::log10(p);

  double p_term = p / (1.0 - p);
  double log1term = log_gamma(n + 1.0) - log_gamma(k + 1.0) -
                    log_gamma(n - k + 1.0) + k * std::log(p) +
                    (n - k) * std::log(1.0 - p);
  double term = std::exp(log1term);
  if (term == 0.0) {
    if (static_cast<double>(k) > static_cast<double>(n) * p)
      return -log1term / std::log(10.0) - logNT;
    return -logNT;
  }

  double bin_tail = term;
  double tolerance = 0.1;
  for (int i = k + 1; i <= n; ++i) {
    double bin_term = static_cast<double>(n - i + 1) / static_cast<double>(i);
    double mult_term = bin_term * p_term;
    term *= mult_term;
    bin_tail += term;
    if (bin_term < 1.0) {
      double err = term * ((1.0 - std::pow(mult_term, n - i + 1)) /
                           (1.0 - mult_term) - 1.0);
      if (err < tolerance * std::fabs(-std::log10(bin_tail) - logNT) * bin_tail)
        break;
    }
  }
  return -std::log10(bin_tail) - logNT;
}

// ---------- angle utilities ----------

static bool is_aligned(double theta, double angle, double prec) {
  if (theta == kNotDef) return false;
  double diff = theta - angle;
  if (diff < 0.0) diff = -diff;
  if (diff > 1.5 * kPi) {
    diff -= 2.0 * kPi;
    if (diff < 0.0) diff = -diff;
  }
  return diff <= prec;
}

static double angle_diff(double a, double b) {
  double d = a - b;
  while (d <= -kPi) d += 2.0 * kPi;
  while (d > kPi) d -= 2.0 * kPi;
  return d < 0 ? -d : d;
}

// ---------- region growing ----------

static void region_grow(int seed, const Grad& g, std::vector<Pt>& reg,
                        double& reg_angle, std::vector<char>& used,
                        double prec) {
  reg.clear();
  int w = g.angle.w, h = g.angle.h;
  int sx = seed % w, sy = seed / w;
  reg.push_back({sx, sy});
  reg_angle = g.angle.v[seed];
  double sumdx = std::cos(reg_angle), sumdy = std::sin(reg_angle);
  used[seed] = 1;

  for (size_t i = 0; i < reg.size(); ++i) {
    for (int yy = reg[i].y - 1; yy <= reg[i].y + 1; ++yy) {
      for (int xx = reg[i].x - 1; xx <= reg[i].x + 1; ++xx) {
        if (xx < 0 || yy < 0 || xx >= w || yy >= h) continue;
        int idx = yy * w + xx;
        if (used[idx]) continue;
        double a = g.angle.v[idx];
        if (!is_aligned(a, reg_angle, prec)) continue;
        used[idx] = 1;
        reg.push_back({xx, yy});
        sumdx += std::cos(a);
        sumdy += std::sin(a);
        reg_angle = std::atan2(sumdy, sumdx);
      }
    }
  }
}

// ---------- rectangle fit ----------

static double get_theta(const std::vector<Pt>& reg, double cx, double cy,
                        const Image& modgrad, double reg_angle, double prec) {
  double ixx = 0, iyy = 0, ixy = 0;
  for (const auto& p : reg) {
    double wgt = modgrad.at(p.x, p.y);
    ixx += wgt * (p.y - cy) * (p.y - cy);
    iyy += wgt * (p.x - cx) * (p.x - cx);
    ixy -= wgt * (p.x - cx) * (p.y - cy);
  }
  double lambda = 0.5 * (ixx + iyy -
      std::sqrt((ixx - iyy) * (ixx - iyy) + 4.0 * ixy * ixy));
  double theta = std::fabs(ixx) > std::fabs(iyy)
      ? std::atan2(lambda - ixx, ixy)
      : std::atan2(ixy, lambda - iyy);
  if (angle_diff(theta, reg_angle) > prec) theta += kPi;
  return theta;
}

static void region2rect(const std::vector<Pt>& reg, const Image& modgrad,
                        double reg_angle, double prec, double p, Rect& rec) {
  double cx = 0, cy = 0, sum = 0;
  for (const auto& q : reg) {
    double wgt = modgrad.at(q.x, q.y);
    cx += wgt * q.x;
    cy += wgt * q.y;
    sum += wgt;
  }
  cx /= sum;
  cy /= sum;

  double theta = get_theta(reg, cx, cy, modgrad, reg_angle, prec);
  double dx = std::cos(theta), dy = std::sin(theta);
  double lmin = 0, lmax = 0, wmin = 0, wmax = 0;
  for (const auto& q : reg) {
    double l = (q.x - cx) * dx + (q.y - cy) * dy;
    double wd = -(q.x - cx) * dy + (q.y - cy) * dx;
    if (l > lmax) lmax = l;
    if (l < lmin) lmin = l;
    if (wd > wmax) wmax = wd;
    if (wd < wmin) wmin = wd;
  }
  rec.x1 = cx + lmin * dx; rec.y1 = cy + lmin * dy;
  rec.x2 = cx + lmax * dx; rec.y2 = cy + lmax * dy;
  rec.width = wmax - wmin;
  rec.x = cx; rec.y = cy; rec.theta = theta;
  rec.dx = dx; rec.dy = dy;
  rec.prec = prec; rec.p = p;
  if (rec.width < 1.0) rec.width = 1.0;
}

// ---------- rectangle NFA via pixel iteration ----------

static double rect_nfa(const Rect& rec, const Grad& g, double logNT) {
  // iterate integer pixels inside the rectangle via its 4 corners
  double hw = rec.width / 2.0;
  double vx[4], vy[4];
  vx[0] = rec.x1 - rec.dy * hw; vy[0] = rec.y1 + rec.dx * hw;
  vx[1] = rec.x2 - rec.dy * hw; vy[1] = rec.y2 + rec.dx * hw;
  vx[2] = rec.x2 + rec.dy * hw; vy[2] = rec.y2 - rec.dx * hw;
  vx[3] = rec.x1 + rec.dy * hw; vy[3] = rec.y1 - rec.dx * hw;

  double minx = vx[0], maxx = vx[0], miny = vy[0], maxy = vy[0];
  for (int i = 1; i < 4; ++i) {
    minx = std::min(minx, vx[i]); maxx = std::max(maxx, vx[i]);
    miny = std::min(miny, vy[i]); maxy = std::max(maxy, vy[i]);
  }

  int pts = 0, alg = 0;
  int x0 = std::max(0, static_cast<int>(std::floor(minx)));
  int x1 = std::min(g.angle.w - 1, static_cast<int>(std::ceil(maxx)));
  int y0 = std::max(0, static_cast<int>(std::floor(miny)));
  int y1 = std::min(g.angle.h - 1, static_cast<int>(std::ceil(maxy)));
  for (int y = y0; y <= y1; ++y) {
    for (int x = x0; x <= x1; ++x) {
      // inside test: projections onto axis/normal within bounds
      double l = (x - rec.x) * rec.dx + (y - rec.y) * rec.dy;
      double wd = -(x - rec.x) * rec.dy + (y - rec.y) * rec.dx;
      double len1 = (rec.x1 - rec.x) * rec.dx + (rec.y1 - rec.y) * rec.dy;
      double len2 = (rec.x2 - rec.x) * rec.dx + (rec.y2 - rec.y) * rec.dy;
      if (l < std::min(len1, len2) || l > std::max(len1, len2)) continue;
      if (std::fabs(wd) > hw) continue;
      ++pts;
      if (is_aligned(g.angle.at(x, y), rec.theta, rec.prec)) ++alg;
    }
  }
  return nfa(pts, alg, rec.p, logNT);
}

// ---------- region refine / rect improve ----------

static bool reduce_region_radius(std::vector<Pt>& reg, double& reg_angle,
                                 const Grad& g, double prec, double p,
                                 Rect& rec, std::vector<char>& used,
                                 double density_th) {
  double density = static_cast<double>(reg.size()) /
      (std::hypot(rec.x2 - rec.x1, rec.y2 - rec.y1) * rec.width);
  if (density >= density_th) return true;

  int xc = reg[0].x, yc = reg[0].y;
  double rad1 = std::hypot(static_cast<double>(xc) - rec.x1,
                           static_cast<double>(yc) - rec.y1);
  double rad2 = std::hypot(static_cast<double>(xc) - rec.x2,
                           static_cast<double>(yc) - rec.y2);
  double rad = std::max(rad1, rad2);

  while (density < density_th) {
    rad *= 0.75;
    for (size_t i = 0; i < reg.size(); ++i) {
      if (std::hypot(static_cast<double>(xc) - reg[i].x,
                     static_cast<double>(yc) - reg[i].y) > rad) {
        used[reg[i].y * g.angle.w + reg[i].x] = 0;
        reg[i] = reg.back();
        reg.pop_back();
        --i;
      }
    }
    if (reg.size() < 2) return false;
    region2rect(reg, g.modgrad, reg_angle, prec, p, rec);
    density = static_cast<double>(reg.size()) /
        (std::hypot(rec.x2 - rec.x1, rec.y2 - rec.y1) * rec.width);
  }
  return true;
}

static bool refine(std::vector<Pt>& reg, double& reg_angle, const Grad& g,
                   double prec, double p, Rect& rec, std::vector<char>& used,
                   double density_th) {
  double density = static_cast<double>(reg.size()) /
      (std::hypot(rec.x2 - rec.x1, rec.y2 - rec.y1) * rec.width);
  if (density >= density_th) return true;

  // re-estimate angle tolerance from pixels near the seed
  int xc = reg[0].x, yc = reg[0].y;
  double ang_c = g.angle.v[yc * g.angle.w + xc];
  double sum = 0, s_sum = 0;
  int n = 0;
  for (const auto& q : reg) {
    used[q.y * g.angle.w + q.x] = 0;
    if (std::hypot(static_cast<double>(xc) - q.x,
                   static_cast<double>(yc) - q.y) < rec.width) {
      double ang = g.angle.at(q.x, q.y);
      double ad = ang - ang_c;
      while (ad <= -kPi) ad += 2 * kPi;
      while (ad > kPi) ad -= 2 * kPi;
      sum += ad;
      s_sum += ad * ad;
      ++n;
    }
  }
  if (n == 0) return false;
  double mean_angle = sum / n;
  double tau = 2.0 * std::sqrt((s_sum - 2.0 * mean_angle * sum) / n +
                               mean_angle * mean_angle);
  region_grow(yc * g.angle.w + xc, g, reg, reg_angle, used, tau);
  if (reg.size() < 2) return false;
  region2rect(reg, g.modgrad, reg_angle, tau, p, rec);
  return reduce_region_radius(reg, reg_angle, g, tau, p, rec, used, density_th);
}

static double rect_improve(Rect& rec, const Grad& g, double logNT,
                           double log_eps) {
  double log_nfa = rect_nfa(rec, g, logNT);
  if (log_nfa > log_eps) return log_nfa;

  // try finer precision
  Rect r = rec;
  for (int i = 0; i < 5; ++i) {
    r.p /= 2.0;
    r.prec = r.p * kPi;
    double ln = rect_nfa(r, g, logNT);
    if (ln > log_nfa) {
      log_nfa = ln;
      rec = r;
    }
  }
  if (log_nfa > log_eps) return log_nfa;

  // try reducing width
  r = rec;
  for (int i = 0; i < 5; ++i) {
    if (r.width - 0.5 >= 0.5) {
      r.width -= 0.5;
      double ln = rect_nfa(r, g, logNT);
      if (ln > log_nfa) {
        log_nfa = ln;
        rec = r;
      }
    }
  }
  if (log_nfa > log_eps) return log_nfa;

  // try reducing one side, then the other
  for (int side = 0; side < 2; ++side) {
    r = rec;
    for (int i = 0; i < 5; ++i) {
      if (r.width - 0.5 < 0.5) break;
      double ddx = (side == 0 ? 1.0 : -1.0) * 0.5 * (-r.dy);
      double ddy = (side == 0 ? 1.0 : -1.0) * 0.5 * r.dx;
      r.x1 += ddx; r.y1 += ddy;
      r.x2 += ddx; r.y2 += ddy;
      r.width -= 0.5;
      double ln = rect_nfa(r, g, logNT);
      if (ln > log_nfa) {
        log_nfa = ln;
        rec = r;
      }
    }
    if (log_nfa > log_eps) return log_nfa;
  }

  // finest precision once more
  r = rec;
  for (int i = 0; i < 5; ++i) {
    r.p /= 2.0;
    r.prec = r.p * kPi;
    double ln = rect_nfa(r, g, logNT);
    if (ln > log_nfa) {
      log_nfa = ln;
      rec = r;
    }
  }
  return log_nfa;
}

}  // namespace

extern "C" {

int lsd_detect(const double* image, int width, int height, double** out,
               int* n_out) {
  if (!image || width < 2 || height < 2 || !out || !n_out) return -1;

  Image input;
  input.w = width;
  input.h = height;
  input.v.assign(image, image + static_cast<size_t>(width) * height);

  Image img = kScale != 1.0 ? gaussian_sampler(input, kScale, kSigmaScale)
                            : std::move(input);

  double prec = kPi * kAngTh / 180.0;
  double p = kAngTh / 180.0;
  double rho = kQuant / std::sin(prec);

  std::vector<int> sorted_pixels;
  Grad g = compute_gradient(img, rho, sorted_pixels, kNBins);

  double logNT = 5.0 * (std::log10(static_cast<double>(img.w)) +
                        std::log10(static_cast<double>(img.h))) / 2.0 +
                 std::log10(11.0);
  int min_reg_size =
      static_cast<int>(-logNT / std::log10(p));  // min aligned points

  std::vector<char> used(static_cast<size_t>(img.w) * img.h, 0);
  std::vector<Pt> reg;
  std::vector<double> results;

  for (int seed : sorted_pixels) {
    if (used[seed] || g.angle.v[seed] == kNotDef) continue;
    double reg_angle;
    region_grow(seed, g, reg, reg_angle, used, prec);
    if (static_cast<int>(reg.size()) < min_reg_size) continue;

    Rect rec;
    region2rect(reg, g.modgrad, reg_angle, prec, p, rec);
    if (!refine(reg, reg_angle, g, prec, p, rec, used, kDensityTh)) continue;
    if (static_cast<int>(reg.size()) < min_reg_size) continue;

    double log_nfa = rect_improve(rec, g, logNT, kLogEps);
    if (log_nfa <= kLogEps) continue;

    // back to original image coordinates (0.5 pixel-centre offset like LSD)
    double inv = 1.0 / kScale;
    results.push_back((rec.x1 + 0.5) * inv);
    results.push_back((rec.y1 + 0.5) * inv);
    results.push_back((rec.x2 + 0.5) * inv);
    results.push_back((rec.y2 + 0.5) * inv);
    results.push_back(rec.width * inv);
    results.push_back(rec.p);
    results.push_back(log_nfa);
  }

  int n = static_cast<int>(results.size() / 7);
  double* buf = static_cast<double*>(std::malloc(results.size() * sizeof(double)));
  if (!buf && !results.empty()) return -2;
  std::memcpy(buf, results.data(), results.size() * sizeof(double));
  *out = buf;
  *n_out = n;
  return 0;
}

void lsd_free(double* p) { std::free(p); }

}  // extern "C"
