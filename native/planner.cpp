// Native planner core: factorization, stage scheduling, twiddle generation.
//
// Host-side parallel of the reference C library's cold path (fft_init /
// factors / dividebyN / longvectorN — /root/reference/src/highSpeedFFT.c:206-286,
// 1954-2163, 2238-2313), redesigned rather than ported:
//   * exact trial-division + 6k±1 wheel factorization for every n >= 1
//     (the reference caps its factor list at 64 and its lookup omits 19);
//   * greedy stage grouping toward a max stage size (the generalization of
//     the reference preferring radices 8/4 over 2);
//   * fp64 twiddle generation with exact integer phase reduction mod n
//     (the reference's dynamic formula — its table path is verifiably wrong);
//   * Bluestein chirp generation with the quadratic-residue mod-2n trick
//     (reference src/highSpeedFFT.c:1674-1690) in exact integer arithmetic.
//
// Everything is extern "C", buffer-filling, and thread-safe (no globals) so
// ctypes can call it from Python; the Python planner falls back to its own
// implementation when this library is absent.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <initializer_list>

namespace {
constexpr double kTau = 6.283185307179586476925286766559;
}

extern "C" {

// Full prime factorization, ascending. Returns count, or -1 if n < 1 or
// the output buffer (capacity `cap`) is too small.
int64_t spectral_prime_factors(int64_t n, int64_t* out, int64_t cap) {
  if (n < 1) return -1;
  int64_t cnt = 0;
  for (int64_t p : {2LL, 3LL}) {
    while (n % p == 0) {
      if (cnt >= cap) return -1;
      out[cnt++] = p;
      n /= p;
    }
  }
  for (int64_t f = 5; f * f <= n; f += 6) {
    for (int64_t p : {f, f + 2}) {
      while (n % p == 0) {
        if (cnt >= cap) return -1;
        out[cnt++] = p;
        n /= p;
      }
    }
  }
  if (n > 1) {
    if (cnt >= cap) return -1;
    out[cnt++] = n;
  }
  return cnt;
}

// Is every prime factor of n <= max_prime?  (1 = yes, 0 = no, -1 = bad n)
int32_t spectral_is_smooth(int64_t n, int64_t max_prime) {
  if (n < 1) return -1;
  int64_t f[64];
  int64_t cnt = spectral_prime_factors(n, f, 64);
  if (cnt < 0) return -1;
  return (cnt == 0 || f[cnt - 1] <= max_prime) ? 1 : 0;
}

// Greedy stage grouping: descending primes packed toward max_stage.
// Mirrors plan_stages() in utils/factorize.py exactly (tested for parity).
// Returns stage count, or -1 on error / prime factor exceeding max_stage.
int64_t spectral_plan_stages(int64_t n, int64_t max_stage, int64_t* out,
                             int64_t cap) {
  if (n < 1) return -1;
  if (n == 1) {
    if (cap < 1) return -1;
    out[0] = 1;
    return 1;
  }
  int64_t primes[64];
  int64_t cnt = spectral_prime_factors(n, primes, 64);
  if (cnt < 0) return -1;
  // descending order
  for (int64_t i = 0; i < cnt / 2; ++i) {
    int64_t t = primes[i];
    primes[i] = primes[cnt - 1 - i];
    primes[cnt - 1 - i] = t;
  }
  if (primes[0] > max_stage) return -1;
  bool used[64] = {false};
  int64_t n_stages = 0;
  for (int64_t i = 0; i < cnt; ++i) {
    if (used[i]) continue;
    int64_t stage = primes[i];
    used[i] = true;
    for (int64_t j = i + 1; j < cnt; ++j) {
      if (!used[j] && stage * primes[j] <= max_stage) {
        stage *= primes[j];
        used[j] = true;
      }
    }
    if (n_stages >= cap) return -1;
    out[n_stages++] = stage;
  }
  // descending stage order (greedy from descending primes is already sorted,
  // but re-sort defensively: insertion sort, tiny count)
  for (int64_t i = 1; i < n_stages; ++i) {
    int64_t v = out[i];
    int64_t j = i - 1;
    while (j >= 0 && out[j] < v) {
      out[j + 1] = out[j];
      --j;
    }
    out[j + 1] = v;
  }
  return n_stages;
}

// Smallest m >= n whose prime factors are all in {2, 3, 5, 7} ("fast"
// padded length; mirrors utils/factorize.next_fast_len: scan up to the next
// power of two, which bounds the search).  Returns -1 on bad n.
int64_t spectral_next_fast_len(int64_t n) {
  if (n < 0) return -1;
  if (n <= 1) return 1;
  int64_t pow2 = 1;
  while (pow2 < n) pow2 <<= 1;
  for (int64_t m = n; m < pow2; ++m) {
    int64_t v = m;
    for (int64_t p : {2LL, 3LL, 5LL, 7LL}) {
      while (v % p == 0) v /= p;
    }
    if (v == 1) return m;
  }
  return pow2;
}

// Largest m <= n whose prime factors are all in {2, 3, 5, 7} (mirrors
// utils/factorize.prev_fast_len).  Returns -1 on n < 1.
int64_t spectral_prev_fast_len(int64_t n) {
  if (n < 1) return -1;
  for (int64_t m = n;; --m) {
    int64_t v = m;
    for (int64_t p : {2LL, 3LL, 5LL, 7LL}) {
      while (v % p == 0) v /= p;
    }
    if (v == 1) return m;
  }
}

// Smallest convenient m >= n with m = parts^2 * s, s 7-smooth — the padded
// length contract of the distributed four-step (closed form of
// utils/factorize.next_splittable_len; tested for parity).  Returns -1 when
// parts < 1 or parts has a prime factor > max_stage.
int64_t spectral_next_splittable_len(int64_t n, int64_t parts,
                                     int64_t max_stage) {
  if (parts < 1) return -1;
  if (spectral_is_smooth(parts, max_stage) != 1) return -1;
  int64_t pp = parts * parts;
  int64_t target = (n + pp - 1) / pp;
  if (target < 1) target = 1;
  int64_t s = spectral_next_fast_len(target);
  return pp * s;
}

// Dense DFT matrix W[j,k] = e^(sign*2*pi*i*j*k/f), row-major (re, im planes).
void spectral_dft_matrix(int64_t f, int32_t sign, double* re, double* im) {
  for (int64_t j = 0; j < f; ++j) {
    for (int64_t k = 0; k < f; ++k) {
      int64_t phase = (j * k) % f;  // exact reduction
      double ang = sign * kTau * static_cast<double>(phase) / f;
      re[j * f + k] = std::cos(ang);
      im[j * f + k] = std::sin(ang);
    }
  }
}

// Cooley-Tukey split twiddles T[j1, j2] = e^(sign*2*pi*i*j1*j2/n), with
// n = f * m, shape (f, m) row-major.  The correct dynamic formula of the
// reference (src/highSpeedFFT.c:2275-2288), with exact integer phase mod n.
void spectral_split_twiddles(int64_t f, int64_t m, int32_t sign, double* re,
                             double* im) {
  int64_t n = f * m;
  for (int64_t j1 = 0; j1 < f; ++j1) {
    for (int64_t j2 = 0; j2 < m; ++j2) {
      int64_t phase = (j1 * j2) % n;
      double ang = sign * kTau * static_cast<double>(phase) / n;
      re[j1 * m + j2] = std::cos(ang);
      im[j1 * m + j2] = std::sin(ang);
    }
  }
}

// Bluestein chirp w[j] = e^(sign*pi*i*j^2/n) for j < count, via the exact
// quadratic-residue recurrence l2 = j^2 mod 2n (reference
// src/highSpeedFFT.c:1674-1690, here in closed integer form).
void spectral_chirp(int64_t n, int64_t count, int32_t sign, double* re,
                    double* im) {
  int64_t two_n = 2 * n;
  int64_t l2 = 0;  // j^2 mod 2n, updated by += 2j+1 (mod 2n)
  for (int64_t j = 0; j < count; ++j) {
    double ang = sign * (kTau / 2.0) * static_cast<double>(l2) / n;
    re[j] = std::cos(ang);
    im[j] = std::sin(ang);
    l2 += 2 * j + 1;
    l2 %= two_n;
  }
}

// Packed-real split twiddles e^(sign*2*pi*i*k/n) for k < count (the Python
// layer passes count = n/2 + 1; reference fft_real_init builds n/2,
// src/real.c:56-61 — but direction-aware here).
void spectral_real_split_twiddles(int64_t n, int64_t count, int32_t sign,
                                  double* re, double* im) {
  for (int64_t k = 0; k < count; ++k) {
    double ang = sign * kTau * static_cast<double>(k) / n;
    re[k] = std::cos(ang);
    im[k] = std::sin(ang);
  }
}

}  // extern "C"
