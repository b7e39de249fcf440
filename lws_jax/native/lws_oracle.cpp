// lws_oracle: scalar CPU oracle for differential testing of the device kernels.
//
// A clean-room implementation of the Local Weighted Sums phase-recovery
// semantics (Le Roux et al., DAFx 2010) used by lws_jax: Gauss-Seidel raster
// sweeps over a Hermitian-extended spectrogram, with the general per-bin
// weight-row selection (summarized Qprime==Q or fractional Qprime==fsize) and
// the visibility gating that unifies the batch / no-future / asymmetric
// (RTISI-LA) schedules. Behaviour corresponds to the reference C library's
// general code paths (LWSanyQ / LWSfractionalQ / NoFuture_LWSanyQ /
// Asym_UpdatePhaseanyQ / TF_RTISI_LA, lwslib/lwslib.cpp:283-1492) - written
// from the mathematical spec, not ported - and is validated bit-for-bit
// against golden vectors generated from the reference build.
//
// Everything is double precision, single threaded, deliberately simple: this
// is the trusted slow path the fast device kernels are tested against.
#include <cmath>
#include <complex>
#include <cstdlib>
#include <cstring>

namespace {

using cd = std::complex<double>;

constexpr double kPrune = 1.0e-12;  // reference w_flag threshold (lws.pyx:231)

struct Grid {
  cd* S;         // extended spectrogram, (T + 2*(Q-1)) x (F + 2*L), row-major
  double* amp;   // extended magnitudes (fixed targets), same shape
  int T, F, Q, Qprime, L;
  int Fp() const { return F + 2 * L; }
  cd& at(int m, int n) { return S[(m + Q - 1) * Fp() + (n + L)]; }  // true indices
  double ampAt(int m, int n) const { return amp[(m + Q - 1) * Fp() + (n + L)]; }
};

struct Weights {
  const cd* W;  // (Qprime, Q, L+1), row-major
  int Qprime, Q, L;
  cd at(int p, int r, int k) const { return W[(p * Q + r) * (L + 1) + k]; }
};

// Update one bin (true frame m, bin n) in place. `v` is the visibility: taps
// at future offset dr are used only when dr <= v (v = Q-1 full batch sweep,
// v = 0 centre-frame-only, v = -1 strictly past / no-future).
void update_bin(Grid& g, const Weights& w, int m, int n, int v, double threshold) {
  const double a = g.ampAt(m, n);
  if (!(a > threshold)) return;

  const int pp = n % w.Qprime;
  const int pn = (w.Qprime - n % w.Qprime) % w.Qprime;
  cd temp(0.0, 0.0);

  for (int r = 0; r < w.Q; ++r) {
    for (int k = 0; k <= w.L; ++k) {
      if (r == 0 && k == 0) continue;  // the self tap is never applied
      const cd wp = w.at(pp, r, k);
      const bool usep = std::abs(wp) > kPrune;
      if (r == 0) {
        if (v >= 0 && usep) {  // centre-frame taps need cframe visibility
          temp += wp * g.at(m, n - k);
          temp += std::conj(wp) * g.at(m, n + k);
        }
      } else if (k == 0) {
        if (usep) {
          temp += wp * g.at(m - r, n);
          if (r <= v) temp += std::conj(wp) * g.at(m + r, n);
        }
      } else {
        const cd wn = w.at(pn, r, k);
        const bool usen = std::abs(wn) > kPrune;
        if (usep) {
          temp += wp * g.at(m - r, n - k);
          if (r <= v) temp += std::conj(wp) * g.at(m + r, n - k);
        }
        if (usen) {
          if (r <= v) temp += wn * g.at(m + r, n + k);
          temp += std::conj(wn) * g.at(m - r, n + k);
        }
      }
    }
  }

  const double at = std::abs(temp);
  if (at > 0.0) {
    const cd nv = temp * (a / at);
    g.at(m, n) = nv;
    // mirror updated margin bins into the Hermitian halo immediately
    if (n >= 1 && n <= g.L) g.at(m, -n) = std::conj(nv);
    if (n >= g.F - 1 - g.L && n <= g.F - 2) g.at(m, 2 * (g.F - 1) - n) = std::conj(nv);
  }
}

void update_frame(Grid& g, const Weights& w, int m, int v, double threshold) {
  for (int n = 0; n < g.F; ++n) update_bin(g, w, m, n, v, threshold);
}

Grid make_grid(const double* sr, const double* si, int T, int F, int Q, int Qprime, int L) {
  Grid g;
  g.T = T; g.F = F; g.Q = Q; g.Qprime = Qprime; g.L = L;
  const int Tp = T + 2 * (Q - 1);
  const int Fp = F + 2 * L;
  g.S = static_cast<cd*>(std::calloc(static_cast<size_t>(Tp) * Fp, sizeof(cd)));
  g.amp = static_cast<double*>(std::calloc(static_cast<size_t>(Tp) * Fp, sizeof(double)));
  // interior
  for (int m = 0; m < T; ++m)
    for (int n = 0; n < F; ++n)
      g.at(m, n) = cd(sr[m * F + n], si[m * F + n]);
  // Hermitian frequency halo
  for (int m = 0; m < T; ++m)
    for (int n = 1; n <= L; ++n) {
      g.at(m, -n) = std::conj(g.at(m, n));
      g.at(m, F - 1 + n) = std::conj(g.at(m, F - 1 - n));
    }
  // replicated edge frames (frozen through all sweeps)
  const int FpAll = Fp;
  for (int j = 0; j < Q - 1; ++j) {
    std::memcpy(g.S + j * FpAll, g.S + (Q - 1) * FpAll, FpAll * sizeof(cd));
    std::memcpy(g.S + (Q - 1 + T + j) * FpAll, g.S + (Q - 2 + T) * FpAll, FpAll * sizeof(cd));
  }
  const int Tp2 = T + 2 * (Q - 1);
  for (int i = 0; i < Tp2 * FpAll; ++i) g.amp[i] = std::abs(g.S[i]);
  return g;
}

void extract(const Grid& g, double* sr, double* si) {
  Grid& gm = const_cast<Grid&>(g);
  for (int m = 0; m < g.T; ++m)
    for (int n = 0; n < g.F; ++n) {
      const cd v = gm.at(m, n);
      sr[m * g.F + n] = v.real();
      si[m * g.F + n] = v.imag();
    }
}

double interior_mean_amp(const double* sr, const double* si, int T, int F) {
  double s = 0.0;
  for (int i = 0; i < T * F; ++i) s += std::hypot(sr[i], si[i]);
  return s / (T * F);
}

}  // namespace

extern "C" {

// Batch / no-future sweeps. visibility: Q-1 for batch, -1 for no-future.
// thresholds are the RELATIVE schedule; they are scaled by the interior mean
// input magnitude here (mirrors python/lws.pyx:240-245).
void lws_oracle_sweeps(double* sr, double* si, int T, int F,
                       const double* wr, const double* wi,
                       int Qprime, int Q, int L,
                       const double* thresholds, int iters, int visibility) {
  const int n_w = Qprime * Q * (L + 1);
  cd* W = static_cast<cd*>(std::malloc(n_w * sizeof(cd)));
  for (int i = 0; i < n_w; ++i) W[i] = cd(wr[i], wi[i]);
  Weights w{W, Qprime, Q, L};

  const double mean_amp = interior_mean_amp(sr, si, T, F);
  Grid g = make_grid(sr, si, T, F, Q, Qprime, L);

  for (int it = 0; it < iters; ++it) {
    const double thr = thresholds[it] * mean_amp;
    for (int m = 0; m < T; ++m) update_frame(g, w, m, visibility, thr);
  }

  extract(g, sr, si);
  std::free(g.S); std::free(g.amp); std::free(W);
}

// Online (TF-RTISI-LA) schedule: per newest frame m, an asym-init pass
// (W_ai, v=-1, threshold 0), then per round h: the LA look-ahead frames
// (W, v=min(d, Q-1)) and the newest frame (W_af, v=0) at thresholds[h].
// Mirrors the sequencing of TF_RTISI_LA (lwslib.cpp:1432-1491).
void lws_oracle_online(double* sr, double* si, int T, int F,
                       const double* wr, const double* wi,
                       const double* wr_ai, const double* wi_ai,
                       const double* wr_af, const double* wi_af,
                       int Qprime, int Q, int L,
                       const double* thresholds, int iters, int LA) {
  const int n_w = Qprime * Q * (L + 1);
  cd* W = static_cast<cd*>(std::malloc(n_w * sizeof(cd)));
  cd* Wai = static_cast<cd*>(std::malloc(n_w * sizeof(cd)));
  cd* Waf = static_cast<cd*>(std::malloc(n_w * sizeof(cd)));
  for (int i = 0; i < n_w; ++i) {
    W[i] = cd(wr[i], wi[i]);
    Wai[i] = cd(wr_ai[i], wi_ai[i]);
    Waf[i] = cd(wr_af[i], wi_af[i]);
  }
  Weights w{W, Qprime, Q, L}, wai{Wai, Qprime, Q, L}, waf{Waf, Qprime, Q, L};

  const double mean_amp = interior_mean_amp(sr, si, T, F);
  Grid g = make_grid(sr, si, T, F, Q, Qprime, L);

  for (int m = 0; m < T; ++m) {
    update_frame(g, wai, m, -1, 0.0);
    for (int h = 0; h < iters; ++h) {
      const double thr = thresholds[h] * mean_amp;
      const int nd = m < LA ? m : LA;
      for (int d = nd; d >= 1; --d) {
        const int vv = d < Q - 1 ? d : Q - 1;
        update_frame(g, w, m - d, vv, thr);
      }
      update_frame(g, waf, m, 0, thr);
    }
  }

  extract(g, sr, si);
  std::free(g.S); std::free(g.amp); std::free(W); std::free(Wai); std::free(Waf);
}

}  // extern "C"
