// Native fp64 FFT oracle + host-side execution engine.
//
// A clean-room, correct-for-all-N mixed-radix FFT in C++ playing two roles:
//   1. the numerical oracle for the test suite (the role SURVEY.md §2.9
//      assigns to the reference C library, which is only correct for a
//      subset of lengths — this one is correct everywhere);
//   2. the host-side small-transform path: for tiny plans the device
//      dispatch dwarfs the transform, so compat-level calls on small host
//      arrays can run natively instead.
//
// Algorithm: recursive decimation-in-time over the smallest prime factor
// (the same decomposition family as the reference's mixed_radix_dit_rec,
// /root/reference/src/highSpeedFFT.c:318-1629, but with a generic correct
// O(r^2) combine for every radix — no hand-unrolled leaves, none of the
// verified leaf-2/twiddle-table bugs) plus Bluestein's chirp-z for lengths
// with large prime factors (reference src/highSpeedFFT.c:1735-1907, with
// consistent padding and no plan mutation).

#include <cmath>
#include <complex>
#include <cstdint>
#include <initializer_list>
#include <vector>

namespace {

using cplx = std::complex<double>;
constexpr double kTau = 6.283185307179586476925286766559;

int64_t smallest_prime_factor(int64_t n) {
  if (n % 2 == 0) return 2;
  if (n % 3 == 0) return 3;
  for (int64_t f = 5; f * f <= n; f += 6) {
    if (n % f == 0) return f;
    if (n % (f + 2) == 0) return f + 2;
  }
  return n;
}

// exp(sign * i * tau * num / den) with exact integer phase reduction.
cplx unit_root(int64_t num, int64_t den, int sign) {
  int64_t phase = num % den;
  double ang = sign * kTau * static_cast<double>(phase) / den;
  return {std::cos(ang), std::sin(ang)};
}

// Recursive DIT: out[k] = sum_t in[t*stride] * W_n^(sign*t*k), for n smooth.
void fft_rec(const cplx* in, cplx* out, int64_t n, int64_t stride, int sign) {
  if (n == 1) {
    out[0] = in[0];
    return;
  }
  int64_t f = smallest_prime_factor(n);
  int64_t m = n / f;
  // sub-FFTs of the f interleaved subsequences, laid out contiguously
  for (int64_t j = 0; j < f; ++j) {
    fft_rec(in + j * stride, out + j * m, m, stride * f, sign);
  }
  // combine: X[k2 + m*k1] = sum_j W_n^(j*k2) W_f^(j*k1) Y_j[k2]
  std::vector<cplx> col(f);
  std::vector<cplx> res(n);
  for (int64_t k2 = 0; k2 < m; ++k2) {
    for (int64_t j = 0; j < f; ++j) {
      col[j] = out[j * m + k2] * unit_root(j * k2, n, sign);
    }
    for (int64_t k1 = 0; k1 < f; ++k1) {
      cplx acc = 0;
      for (int64_t j = 0; j < f; ++j) {
        acc += col[j] * unit_root(j * k1, f, sign);
      }
      res[k2 + m * k1] = acc;
    }
  }
  for (int64_t k = 0; k < n; ++k) out[k] = res[k];
}

int64_t next_pow2(int64_t n) {
  int64_t m = 1;
  while (m < n) m <<= 1;
  return m;
}

void bluestein(const cplx* in, cplx* out, int64_t n, int sign) {
  int64_t m = next_pow2(2 * n - 1);
  // chirp w[j] = e^(sign*pi*i*j^2/n) via j^2 mod 2n
  std::vector<cplx> w(n);
  int64_t l2 = 0;
  for (int64_t j = 0; j < n; ++j) {
    double ang = sign * (kTau / 2.0) * static_cast<double>(l2) / n;
    w[j] = {std::cos(ang), std::sin(ang)};
    l2 = (l2 + 2 * j + 1) % (2 * n);
  }
  // kernel c[j] = conj(w[j]) wrapped circularly, padded to m
  std::vector<cplx> c(m, 0.0), a(m, 0.0), spec(m), A(m);
  for (int64_t j = 0; j < n; ++j) c[j] = std::conj(w[j]);
  for (int64_t j = 1; j < n; ++j) c[m - j] = std::conj(w[j]);
  for (int64_t j = 0; j < n; ++j) a[j] = in[j] * w[j];
  fft_rec(c.data(), spec.data(), m, 1, -1);
  fft_rec(a.data(), A.data(), m, 1, -1);
  for (int64_t k = 0; k < m; ++k) A[k] *= spec[k];
  // inverse length-m FFT via conjugation
  for (auto& v : A) v = std::conj(v);
  fft_rec(A.data(), c.data(), m, 1, -1);
  for (int64_t j = 0; j < n; ++j) {
    out[j] = std::conj(c[j]) * w[j] / static_cast<double>(m);
  }
}

constexpr int64_t kSmoothLimit = 64;  // matches SpectralConfig.max_stage

bool is_smooth_small(int64_t n) {
  for (int64_t p : {2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47,
                    53, 59, 61}) {
    while (n % p == 0) n /= p;
  }
  return n == 1;
}

}  // namespace

extern "C" {

// Unnormalized 1-D transform of `batch` rows of length n (complex interleaved
// fp64: re,im,re,im,...).  sign=-1 forward, +1 inverse (unnormalized, like
// the reference's fft_exec).  Returns 0 on success, -1 on bad args.
int32_t spectral_oracle_fft(const double* in, double* out, int64_t n,
                            int64_t batch, int32_t sign) {
  if (n < 1 || batch < 1 || (sign != -1 && sign != 1)) return -1;
  const cplx* src = reinterpret_cast<const cplx*>(in);
  cplx* dst = reinterpret_cast<cplx*>(out);
  bool smooth = is_smooth_small(n);
  (void)kSmoothLimit;
  for (int64_t b = 0; b < batch; ++b) {
    if (smooth) {
      fft_rec(src + b * n, dst + b * n, n, 1, sign);
    } else {
      bluestein(src + b * n, dst + b * n, n, sign);
    }
  }
  return 0;
}

}  // extern "C"
