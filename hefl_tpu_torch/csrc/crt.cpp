// Exact CRT decode of RNS-CKKS residues, the host-side trust-boundary decode.
//
// Counterpart of hefl_tpu/native/crt.cpp. The on-device decode recombines
// the CRT value in float32; the owner's final decode (model export, the
// serving client's score decrypt) wants the exact centred integer. In
// Python that is object-dtype bignum arithmetic over every coefficient;
// here it is Garner's mixed-radix algorithm in 64-bit words, the value
// rebuilt in a fixed 256-bit integer, parallel over coefficients.
//
// Layout (as ckks/encoding.py): residues uint32[outer, L, n], C-contiguous,
// canonical (< p_l); primes below 2**31, 1 <= L <= 8 (q < 2**248). Output
// double[outer, n] = double(centred CRT value) / scale, where the integer
// is rounded to double once, to nearest with ties to even: the same
// double as Python's float(v) / scale on the bignum value, bit for bit.

#include <cmath>
#include <cstdint>

using u32 = uint32_t;
using u64 = uint64_t;
using u128 = unsigned __int128;

namespace {

constexpr int kMaxL = 8;
constexpr int kWords = 4;   // 256 bits

struct Wide {
  u64 w[kWords];
};

u64 modpow(u64 base, u64 exp, u64 mod) {
  u64 acc = 1 % mod;
  base %= mod;
  while (exp) {
    if (exp & 1) acc = (u128)acc * base % mod;
    base = (u128)base * base % mod;
    exp >>= 1;
  }
  return acc;
}

// x = x * m + a, with m, a < 2**32.
void mul_add(Wide& x, u64 m, u64 a) {
  u128 carry = a;
  for (int i = 0; i < kWords; ++i) {
    const u128 t = (u128)x.w[i] * m + carry;
    x.w[i] = (u64)t;
    carry = t >> 64;
  }
}

bool greater(const Wide& a, const Wide& b) {
  for (int i = kWords - 1; i >= 0; --i)
    if (a.w[i] != b.w[i]) return a.w[i] > b.w[i];
  return false;
}

// a - b for a >= b.
Wide sub(const Wide& a, const Wide& b) {
  Wide out;
  u64 borrow = 0;
  for (int i = 0; i < kWords; ++i) {
    const u64 t = a.w[i] - b.w[i];
    const u64 b1 = a.w[i] < b.w[i];
    out.w[i] = t - borrow;
    borrow = b1 | (t < borrow);
  }
  return out;
}

Wide shr1(const Wide& a) {
  Wide out;
  for (int i = 0; i < kWords; ++i)
    out.w[i] = (a.w[i] >> 1) | (i + 1 < kWords ? a.w[i + 1] << 63 : 0);
  return out;
}

int top_bit(const Wide& x) {
  for (int i = kWords - 1; i >= 0; --i)
    if (x.w[i]) return i * 64 + 63 - __builtin_clzll(x.w[i]);
  return -1;
}

bool bit(const Wide& x, int k) { return (x.w[k >> 6] >> (k & 63)) & 1; }

// True when any bit below position k is set.
bool any_below(const Wide& x, int k) {
  for (int i = 0; i < kWords && i * 64 < k; ++i) {
    const int n = k - i * 64;
    const u64 mask = n >= 64 ? ~0ull : ((1ull << n) - 1);
    if (x.w[i] & mask) return true;
  }
  return false;
}

// The low 64 bits of x >> s.
u64 bits_from(const Wide& x, int s) {
  const int wi = s >> 6, sh = s & 63;
  u64 lo = x.w[wi] >> sh;
  if (sh && wi + 1 < kWords) lo |= x.w[wi + 1] << (64 - sh);
  return lo;
}

// x rounded to the nearest double, ties to even (as Python's int -> float).
double to_double(const Wide& x) {
  const int b = top_bit(x);
  if (b < 0) return 0.0;
  if (b <= 52) return (double)x.w[0];
  const int shift = b - 52;
  u64 m = bits_from(x, shift);   // 53 bits
  if (bit(x, shift - 1) && (any_below(x, shift - 1) || (m & 1))) ++m;
  return std::ldexp((double)m, shift);
}

}  // namespace

extern "C" {

// 0 on success; 1 on a bad shape or L, 2 on a prime outside [2, 2**31),
// 3 on a residue that is not canonical.
int crt_decode_exact(const u32* res, int64_t outer, int64_t L, int64_t n, const u32* primes,
                     double scale, double* out) {
  if (L < 1 || L > kMaxL || outer < 0 || n < 0) return 1;
  u64 p[kMaxL];
  u64 inv[kMaxL][kMaxL];   // inv[j][l] = p_j^-1 mod p_l, j < l
  Wide q = {{1, 0, 0, 0}};
  for (int64_t l = 0; l < L; ++l) {
    p[l] = primes[l];
    if (p[l] < 2 || p[l] >= (1u << 31)) return 2;
    mul_add(q, p[l], 0);
  }
  for (int64_t l = 1; l < L; ++l)
    for (int64_t j = 0; j < l; ++j) inv[j][l] = modpow(p[j] % p[l], p[l] - 2, p[l]);
  const Wide half = shr1(q);
  const int64_t total = outer * n;
  int bad = 0;

#pragma omp parallel for schedule(static) reduction(| : bad) if (total >= (1 << 16))
  for (int64_t idx = 0; idx < total; ++idx) {
    const int64_t b = idx / n, j = idx % n;
    const u32* rb = res + b * L * n + j;
    // Garner: v = t_0 + p_0 (t_1 + p_1 (t_2 + ...)), every t_l < p_l.
    u64 t[kMaxL];
    for (int64_t l = 0; l < L; ++l) {
      u64 u = rb[l * n];
      if (u >= p[l]) {
        bad = 1;
        u %= p[l];
      }
      for (int64_t k = 0; k < l; ++k) u = (u + p[l] - t[k] % p[l]) % p[l] * inv[k][l] % p[l];
      t[l] = u;
    }
    Wide v = {{0, 0, 0, 0}};
    for (int64_t l = L - 1; l >= 0; --l) mul_add(v, p[l], t[l]);
    const bool neg = greater(v, half);
    const double d = to_double(neg ? sub(q, v) : v);
    out[idx] = (neg ? -d : d) / scale;
  }
  return bad ? 3 : 0;
}

}  // extern "C"
