// Two-view geometric verification with COLMAP-grade model selection.
//
// Native replacement for the reference's pycolmap
// ``estimation_and_geometric_verification`` step
// (reference: pose_diffusion/util/match_extraction.py:125-130; SURVEY.md N2):
// given putative correspondences from the matcher, robustly fit F, H and
// (when intrinsics are available) E, then classify the pair the way
// COLMAP's TwoViewGeometry estimation does:
//
//   - CALIBRATED (2):   E explains (almost) everything F does
//   - UNCALIBRATED (3): F is the best epipolar model
//   - PLANAR_OR_PANORAMIC (6): a homography explains >= max_H_inlier_ratio
//     of the chosen epipolar model's inliers (planar scene or pure
//     rotation) — the epipolar fit is degenerate; inliers come from H
//   - DEGENERATE (1):   nothing reaches min_num_inliers
//
// The enum values match COLMAP's TwoViewGeometry::ConfigurationType.
//
// Self-contained C++17, no external deps: small fixed-size linear algebra
// (Jacobi eigensolver for the 9x9 normal matrix, closed-form 3x3 SVD via
// Jacobi on F^T F) keeps the hot loop allocation-free.  Exposed with a C ABI
// for ctypes.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libransac.so ransac.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

// ---------------------------------------------------------------- linalg

// Jacobi eigen-decomposition of a symmetric n x n matrix (n <= 9).
// A is overwritten; V receives eigenvectors (columns); d eigenvalues.
void jacobi_eigen(double* A, int n, double* V, double* d) {
  for (int i = 0; i < n * n; ++i) V[i] = 0.0;
  for (int i = 0; i < n; ++i) V[i * n + i] = 1.0;

  for (int sweep = 0; sweep < 64; ++sweep) {
    double off = 0.0;
    for (int p = 0; p < n; ++p)
      for (int q = p + 1; q < n; ++q) off += A[p * n + q] * A[p * n + q];
    if (off < 1e-24) break;

    for (int p = 0; p < n; ++p) {
      for (int q = p + 1; q < n; ++q) {
        double apq = A[p * n + q];
        if (std::fabs(apq) < 1e-30) continue;
        double app = A[p * n + p], aqq = A[q * n + q];
        double tau = (aqq - app) / (2.0 * apq);
        double t = (tau >= 0 ? 1.0 : -1.0) /
                   (std::fabs(tau) + std::sqrt(1.0 + tau * tau));
        double c = 1.0 / std::sqrt(1.0 + t * t);
        double s = t * c;

        for (int k = 0; k < n; ++k) {
          double akp = A[k * n + p], akq = A[k * n + q];
          A[k * n + p] = c * akp - s * akq;
          A[k * n + q] = s * akp + c * akq;
        }
        for (int k = 0; k < n; ++k) {
          double apk = A[p * n + k], aqk = A[q * n + k];
          A[p * n + k] = c * apk - s * aqk;
          A[q * n + k] = s * apk + c * aqk;
        }
        for (int k = 0; k < n; ++k) {
          double vkp = V[k * n + p], vkq = V[k * n + q];
          V[k * n + p] = c * vkp - s * vkq;
          V[k * n + q] = s * vkp + c * vkq;
        }
      }
    }
  }
  for (int i = 0; i < n; ++i) d[i] = A[i * n + i];
}

// Eigenvector of the smallest eigenvalue of symmetric n x n M -> out[n].
void smallest_eigenvector(const double* M, int n, double* out) {
  double A[81], V[81], d[9];
  std::memcpy(A, M, sizeof(double) * n * n);
  jacobi_eigen(A, n, V, d);
  int best = 0;
  for (int i = 1; i < n; ++i)
    if (d[i] < d[best]) best = i;
  for (int i = 0; i < n; ++i) out[i] = V[i * n + best];
}

// Project a 3x3 matrix onto rank 2 (fundamental: keep s1, s2) or onto the
// essential manifold (singular values (s, s, 0) with s = (s1 + s2) / 2).
// Uses eigen-decomposition of F^T F for the right singular vectors.
void enforce_singular_values(double* F, bool essential) {
  double FtF[9] = {0};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < 3; ++k) FtF[i * 3 + j] += F[k * 3 + i] * F[k * 3 + j];
  double Vr[9], dr[3], Ar[9];
  std::memcpy(Ar, FtF, sizeof(FtF));
  jacobi_eigen(Ar, 3, Vr, dr);
  // sort eigenpairs descending
  int idx[3] = {0, 1, 2};
  std::sort(idx, idx + 3, [&](int a, int b) { return dr[a] > dr[b]; });

  double s[3];
  double U[9];
  for (int c = 0; c < 3; ++c) {
    int e = idx[c];
    s[c] = dr[e] > 0 ? std::sqrt(dr[e]) : 0.0;
    // u_c = F v_c / s_c (for nonzero s)
    double u[3] = {0, 0, 0};
    for (int i = 0; i < 3; ++i)
      for (int k = 0; k < 3; ++k) u[i] += F[i * 3 + k] * Vr[k * 3 + e];
    double norm = std::sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2]);
    if (norm > 1e-12)
      for (int i = 0; i < 3; ++i) u[i] /= norm;
    for (int i = 0; i < 3; ++i) U[i * 3 + c] = u[i];
  }
  if (essential) s[0] = s[1] = 0.5 * (s[0] + s[1]);
  // F = s1 u1 v1^T + s2 u2 v2^T  (drop the smallest singular value)
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double acc = 0.0;
      for (int c = 0; c < 2; ++c)
        acc += s[c] * U[i * 3 + c] * Vr[j * 3 + idx[c]];
      F[i * 3 + j] = acc;
    }
}

// ------------------------------------------------------------- estimation

struct NormXform {
  double cx, cy, scale;
};

NormXform normalize_points(const float* pts, const int* sample, int m,
                           double* out /* 2*m */) {
  double cx = 0, cy = 0;
  for (int i = 0; i < m; ++i) {
    cx += pts[2 * sample[i]];
    cy += pts[2 * sample[i] + 1];
  }
  cx /= m;
  cy /= m;
  double dist = 0;
  for (int i = 0; i < m; ++i) {
    double dx = pts[2 * sample[i]] - cx, dy = pts[2 * sample[i] + 1] - cy;
    dist += std::sqrt(dx * dx + dy * dy);
  }
  dist /= m;
  double scale = dist > 1e-12 ? std::sqrt(2.0) / dist : 1.0;
  for (int i = 0; i < m; ++i) {
    out[2 * i] = (pts[2 * sample[i]] - cx) * scale;
    out[2 * i + 1] = (pts[2 * sample[i] + 1] - cy) * scale;
  }
  return {cx, cy, scale};
}

constexpr int kMaxFit = 4096;  // refits use at most this many inliers

// Fit F or E (p2^T F p1 = 0) from m >= 8 correspondences (normalized
// 8-point); essential additionally projects onto (s, s, 0).
bool fit_epipolar(const float* kp1, const float* kp2, const int* sample,
                  int m, bool essential, double* F) {
  static thread_local std::vector<double> buf;
  if (m > kMaxFit) m = kMaxFit;
  buf.resize(4 * m);
  double* p1 = buf.data();
  double* p2 = buf.data() + 2 * m;
  NormXform t1 = normalize_points(kp1, sample, m, p1);
  NormXform t2 = normalize_points(kp2, sample, m, p2);

  // normal matrix AtA of the m x 9 design matrix
  double AtA[81] = {0};
  for (int i = 0; i < m; ++i) {
    double x1 = p1[2 * i], y1 = p1[2 * i + 1];
    double x2 = p2[2 * i], y2 = p2[2 * i + 1];
    double row[9] = {x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, 1.0};
    for (int a = 0; a < 9; ++a)
      for (int b = 0; b < 9; ++b) AtA[a * 9 + b] += row[a] * row[b];
  }
  double f[9];
  smallest_eigenvector(AtA, 9, f);

  double Fn[9];
  std::memcpy(Fn, f, sizeof(Fn));
  enforce_singular_values(Fn, /*essential=*/false);

  // denormalize: F = T2^T Fn T1, with T = [[s,0,-s*cx],[0,s,-s*cy],[0,0,1]]
  double T1[9] = {t1.scale, 0, -t1.scale * t1.cx,
                  0, t1.scale, -t1.scale * t1.cy, 0, 0, 1};
  double T2[9] = {t2.scale, 0, -t2.scale * t2.cx,
                  0, t2.scale, -t2.scale * t2.cy, 0, 0, 1};
  double tmp[9] = {0};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < 3; ++k)
        tmp[i * 3 + j] += T2[k * 3 + i] * Fn[k * 3 + j];  // T2^T Fn
  std::memset(F, 0, sizeof(double) * 9);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < 3; ++k) F[i * 3 + j] += tmp[i * 3 + k] * T1[k * 3 + j];
  // The essential structure (equal singular values) does not survive the
  // anisotropic Hartley denormalization, so project AFTER denormalizing
  // (rank 2, enforced above, does survive).
  if (essential) enforce_singular_values(F, /*essential=*/true);
  return true;
}

// Fit a homography p2 ~ H p1 from m >= 4 correspondences (normalized DLT).
bool fit_homography(const float* kp1, const float* kp2, const int* sample,
                    int m, double* H) {
  static thread_local std::vector<double> buf;
  if (m > kMaxFit) m = kMaxFit;
  buf.resize(4 * m);
  double* p1 = buf.data();
  double* p2 = buf.data() + 2 * m;
  NormXform t1 = normalize_points(kp1, sample, m, p1);
  NormXform t2 = normalize_points(kp2, sample, m, p2);

  // normal matrix of the 2m x 9 DLT design matrix
  double AtA[81] = {0};
  for (int i = 0; i < m; ++i) {
    double x = p1[2 * i], y = p1[2 * i + 1];
    double xp = p2[2 * i], yp = p2[2 * i + 1];
    double r1[9] = {x, y, 1, 0, 0, 0, -xp * x, -xp * y, -xp};
    double r2[9] = {0, 0, 0, x, y, 1, -yp * x, -yp * y, -yp};
    for (int a = 0; a < 9; ++a)
      for (int b = 0; b < 9; ++b)
        AtA[a * 9 + b] += r1[a] * r1[b] + r2[a] * r2[b];
  }
  double h[9];
  smallest_eigenvector(AtA, 9, h);
  if (std::fabs(h[8]) < 1e-15 &&
      std::fabs(h[0]) + std::fabs(h[4]) < 1e-12)
    return false;

  // denormalize: H = T2^{-1} Hn T1
  double T1[9] = {t1.scale, 0, -t1.scale * t1.cx,
                  0, t1.scale, -t1.scale * t1.cy, 0, 0, 1};
  double T2inv[9] = {1.0 / t2.scale, 0, t2.cx,
                     0, 1.0 / t2.scale, t2.cy, 0, 0, 1};
  double tmp[9] = {0};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < 3; ++k) tmp[i * 3 + j] += T2inv[i * 3 + k] * h[k * 3 + j];
  std::memset(H, 0, sizeof(double) * 9);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < 3; ++k) H[i * 3 + j] += tmp[i * 3 + k] * T1[k * 3 + j];
  return true;
}

inline double sampson(const double* F, double x1, double y1, double x2,
                      double y2) {
  double Fx1[3] = {F[0] * x1 + F[1] * y1 + F[2], F[3] * x1 + F[4] * y1 + F[5],
                   F[6] * x1 + F[7] * y1 + F[8]};
  double Ftx2[3] = {F[0] * x2 + F[3] * y2 + F[6], F[1] * x2 + F[4] * y2 + F[7],
                    F[2] * x2 + F[5] * y2 + F[8]};
  double num = x2 * Fx1[0] + y2 * Fx1[1] + Fx1[2];
  double den = Fx1[0] * Fx1[0] + Fx1[1] * Fx1[1] + Ftx2[0] * Ftx2[0] +
               Ftx2[1] * Ftx2[1];
  return num * num / std::max(den, 1e-12);
}

// Squared forward transfer error |p2 - H p1|^2 (COLMAP's homography
// residual).
inline double transfer_sq(const double* H, double x1, double y1, double x2,
                          double y2) {
  double w = H[6] * x1 + H[7] * y1 + H[8];
  if (std::fabs(w) < 1e-12) return 1e30;
  double xp = (H[0] * x1 + H[1] * y1 + H[2]) / w;
  double yp = (H[3] * x1 + H[4] * y1 + H[5]) / w;
  double dx = x2 - xp, dy = y2 - yp;
  return dx * dx + dy * dy;
}

// ------------------------------------------------------ generic RANSAC

struct RansacResult {
  int num_inliers = 0;
  double model[9] = {0};
};

// Model: kSampleSize; fit(kp1, kp2, sample, m, M) -> bool;
// error(M, x1, y1, x2, y2) -> double (compared against threshold).
template <typename Model>
RansacResult ransac(const float* kp1, const float* kp2, int n, float threshold,
                    int max_iters, double confidence, uint64_t seed) {
  RansacResult best;
  if (n < Model::kSampleSize) return best;

  std::mt19937_64 rng(seed);
  std::uniform_int_distribution<int> pick(0, n - 1);
  int iters = max_iters;

  for (int it = 0; it < iters; ++it) {
    int sample[8];
    for (int i = 0; i < Model::kSampleSize; ++i) {
      bool dup;
      do {
        sample[i] = pick(rng);
        dup = false;
        for (int j = 0; j < i; ++j) dup |= (sample[j] == sample[i]);
      } while (dup);
    }
    double M[9];
    if (!Model::fit(kp1, kp2, sample, Model::kSampleSize, M)) continue;

    int count = 0;
    for (int i = 0; i < n; ++i) {
      if (Model::error(M, kp1[2 * i], kp1[2 * i + 1], kp2[2 * i],
                       kp2[2 * i + 1]) < threshold)
        ++count;
    }
    if (count > best.num_inliers) {
      best.num_inliers = count;
      std::memcpy(best.model, M, sizeof(M));
      // adaptive iteration count; the ratio can reach ~1e13 for weak models,
      // so clamp in double BEFORE the int cast (overflow wraps negative and
      // would truncate the loop right after the first bad model)
      double w = static_cast<double>(count) / n;
      double p_outlier = 1.0 - std::pow(w, Model::kSampleSize);
      p_outlier = std::min(std::max(p_outlier, 1e-12), 1.0 - 1e-12);
      double needed_d =
          std::ceil(std::log(1.0 - confidence) / std::log(p_outlier));
      int needed = needed_d >= static_cast<double>(max_iters)
                       ? max_iters
                       : static_cast<int>(needed_d);
      iters = std::min(max_iters, std::max(needed, it + 1));
    }
  }

  if (best.num_inliers < Model::kSampleSize) {
    best.num_inliers = 0;
    return best;
  }

  // local optimization: refit on all inliers of the best model, once.
  std::vector<int> inliers;
  inliers.reserve(best.num_inliers);
  for (int i = 0; i < n; ++i) {
    if (Model::error(best.model, kp1[2 * i], kp1[2 * i + 1], kp2[2 * i],
                     kp2[2 * i + 1]) < threshold)
      inliers.push_back(i);
  }
  double refit[9];
  if (Model::fit(kp1, kp2, inliers.data(), static_cast<int>(inliers.size()),
                 refit)) {
    int count = 0;
    for (int i = 0; i < n; ++i) {
      if (Model::error(refit, kp1[2 * i], kp1[2 * i + 1], kp2[2 * i],
                       kp2[2 * i + 1]) < threshold)
        ++count;
    }
    if (count >= best.num_inliers) {
      best.num_inliers = count;
      std::memcpy(best.model, refit, sizeof(refit));
    }
  }
  return best;
}

template <typename Model>
int fill_mask(const double* M, const float* kp1, const float* kp2, int n,
              float threshold, uint8_t* mask) {
  int count = 0;
  for (int i = 0; i < n; ++i) {
    bool in = Model::error(M, kp1[2 * i], kp1[2 * i + 1], kp2[2 * i],
                           kp2[2 * i + 1]) < threshold;
    mask[i] = in ? 1 : 0;
    count += in;
  }
  return count;
}

struct FundamentalModel {
  static constexpr int kSampleSize = 8;
  static bool fit(const float* kp1, const float* kp2, const int* sample,
                  int m, double* M) {
    return fit_epipolar(kp1, kp2, sample, m, /*essential=*/false, M);
  }
  static double error(const double* M, double x1, double y1, double x2,
                      double y2) {
    return sampson(M, x1, y1, x2, y2);
  }
};

struct EssentialModel {
  static constexpr int kSampleSize = 8;
  static bool fit(const float* kp1, const float* kp2, const int* sample,
                  int m, double* M) {
    return fit_epipolar(kp1, kp2, sample, m, /*essential=*/true, M);
  }
  static double error(const double* M, double x1, double y1, double x2,
                      double y2) {
    return sampson(M, x1, y1, x2, y2);
  }
};

struct HomographyModel {
  static constexpr int kSampleSize = 4;
  static bool fit(const float* kp1, const float* kp2, const int* sample,
                  int m, double* M) {
    return fit_homography(kp1, kp2, sample, m, M);
  }
  static double error(const double* M, double x1, double y1, double x2,
                      double y2) {
    return transfer_sq(M, x1, y1, x2, y2);
  }
};

}  // namespace

extern "C" {

// RANSAC fundamental-matrix verification (F only; see verify_two_view for
// the full COLMAP-style model selection).
//   kp1, kp2: (n, 2) float32 pixel coordinates of putative matches
//   threshold: inlier Sampson distance in px^2-comparable units (COLMAP's
//              default max_error=4px corresponds to threshold 16)
//   confidence: early-exit confidence (e.g. 0.9999)
//   F_out: row-major 3x3 (p2^T F p1 = 0); inlier_mask: n bytes
// Returns the inlier count (0 if degenerate / n < 8).
int ransac_fundamental(const float* kp1, const float* kp2, int n,
                       float threshold, int max_iters, double confidence,
                       uint64_t seed, double* F_out, uint8_t* inlier_mask) {
  std::memset(inlier_mask, 0, n);
  std::memset(F_out, 0, sizeof(double) * 9);
  RansacResult r = ransac<FundamentalModel>(kp1, kp2, n, threshold, max_iters,
                                            confidence, seed);
  if (r.num_inliers == 0) return 0;
  std::memcpy(F_out, r.model, sizeof(r.model));
  return fill_mask<FundamentalModel>(r.model, kp1, kp2, n, threshold,
                                     inlier_mask);
}

// COLMAP TwoViewGeometry::ConfigurationType values we emit.
enum Config {
  kDegenerate = 1,
  kCalibrated = 2,
  kUncalibrated = 3,
  kPlanarOrPanoramic = 6,
};

// Full two-view geometric verification with model selection, mirroring
// COLMAP's EstimateTwoViewGeometry (two_view_geometry.cc):
//
//   1. RANSAC-fit F (Sampson, threshold = max_error^2 px^2) and H
//      (transfer error, same threshold).  With intrinsics, also fit E on
//      K^-1-normalized coordinates (threshold scaled by the mean focal).
//   2. Pick the epipolar model: CALIBRATED if E's inliers reach
//      min_E_F_inlier_ratio (0.95) of F's, else UNCALIBRATED.
//   3. Degeneracy: if H explains >= max_H_inlier_ratio (0.8) of the chosen
//      model's inliers, the pair is PLANAR_OR_PANORAMIC (planar scene or
//      pure rotation) and the returned inliers are H's — an F fit on such a
//      pair is arbitrary and would pass bogus matches downstream.
//   4. DEGENERATE if nothing reaches min_num_inliers (COLMAP default 15).
//
//   kp1, kp2: (n, 2) float32 pixel coordinates of putative matches
//   K1, K2: row-major 3x3 intrinsics or nullptr (uncalibrated path)
//   max_error_px: inlier threshold in pixels (COLMAP default 4)
//   config_out: one of Config above
//   F_out / H_out / E_out: fitted models (E only when calibrated; zeros
//      otherwise).  Any of them may be nullptr.
// Returns the inlier count of the SELECTED model and fills inlier_mask.
int verify_two_view(const float* kp1, const float* kp2, int n,
                    const double* K1, const double* K2, float max_error_px,
                    int max_iters, double confidence, int min_num_inliers,
                    uint64_t seed, double* F_out, double* H_out, double* E_out,
                    uint8_t* inlier_mask, int* config_out) {
  std::memset(inlier_mask, 0, n);
  if (F_out) std::memset(F_out, 0, sizeof(double) * 9);
  if (H_out) std::memset(H_out, 0, sizeof(double) * 9);
  if (E_out) std::memset(E_out, 0, sizeof(double) * 9);
  *config_out = kDegenerate;
  if (n < 4) return 0;

  const float thr = max_error_px * max_error_px;
  RansacResult F =
      ransac<FundamentalModel>(kp1, kp2, n, thr, max_iters, confidence, seed);
  RansacResult H = ransac<HomographyModel>(kp1, kp2, n, thr, max_iters,
                                           confidence, seed ^ 0x9e3779b97f4a7c15ULL);
  if (F_out) std::memcpy(F_out, F.model, sizeof(F.model));
  if (H_out) std::memcpy(H_out, H.model, sizeof(H.model));

  // Calibrated path: E on normalized coordinates.
  RansacResult E;
  std::vector<float> nk1, nk2;
  float thr_norm = 0;
  const bool calibrated = (K1 != nullptr && K2 != nullptr);
  if (calibrated) {
    nk1.resize(2 * n);
    nk2.resize(2 * n);
    auto apply_Kinv = [](const double* K, const float* in, float* out, int n) {
      // K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]]; skew ignored (COLMAP
      // cameras have none).
      const double fx = K[0], cx = K[2], fy = K[4], cy = K[5];
      for (int i = 0; i < n; ++i) {
        out[2 * i] = static_cast<float>((in[2 * i] - cx) / fx);
        out[2 * i + 1] = static_cast<float>((in[2 * i + 1] - cy) / fy);
      }
    };
    apply_Kinv(K1, kp1, nk1.data(), n);
    apply_Kinv(K2, kp2, nk2.data(), n);
    const double f_mean = 0.25 * (K1[0] + K1[4] + K2[0] + K2[4]);
    const double t = max_error_px / std::max(f_mean, 1e-9);
    thr_norm = static_cast<float>(t * t);
    E = ransac<EssentialModel>(nk1.data(), nk2.data(), n, thr_norm, max_iters,
                               confidence, seed ^ 0xda3e39cb94b95bdbULL);
    if (E_out) std::memcpy(E_out, E.model, sizeof(E.model));
  }

  // --- model selection (COLMAP two_view_geometry.cc logic)
  constexpr double kMinEFInlierRatio = 0.95;
  constexpr double kMaxHInlierRatio = 0.8;

  int config;
  int num_inliers;
  if (calibrated && E.num_inliers >= min_num_inliers &&
      E.num_inliers >=
          kMinEFInlierRatio * static_cast<double>(F.num_inliers)) {
    config = kCalibrated;
    num_inliers = E.num_inliers;
  } else if (F.num_inliers >= min_num_inliers) {
    config = kUncalibrated;
    num_inliers = F.num_inliers;
  } else if (H.num_inliers >= min_num_inliers) {
    config = kPlanarOrPanoramic;
    num_inliers = H.num_inliers;
  } else {
    *config_out = kDegenerate;
    return 0;
  }

  if (config != kPlanarOrPanoramic &&
      H.num_inliers >= kMaxHInlierRatio * static_cast<double>(num_inliers)) {
    config = kPlanarOrPanoramic;
    num_inliers = H.num_inliers;
  }

  *config_out = config;
  if (config == kPlanarOrPanoramic) {
    return fill_mask<HomographyModel>(H.model, kp1, kp2, n, thr, inlier_mask);
  }
  if (config == kCalibrated) {
    return fill_mask<EssentialModel>(E.model, nk1.data(), nk2.data(), n,
                                     thr_norm, inlier_mask);
  }
  return fill_mask<FundamentalModel>(F.model, kp1, kp2, n, thr, inlier_mask);
}

}  // extern "C"
