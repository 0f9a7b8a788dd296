// Hand-written Hopper (sm_90a) kernels for the CKKS hot paths: forward NTT,
// inverse NTT, fused encrypt and fused decrypt (the encrypted FedAvg round),
// the fused gadget key-switch and hoisted-rotation products (encrypted
// inference serving), and the fused hybrid-HE transcipher (the HHE uplink).
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (hefl_tpu_torch/ckks/cuda_ntt.py).
//
// Replaces the Pallas TPU kernels of hefl_tpu/ckks/pallas_ntt.py:
//   ntt_forward       <- ntt_forward_pallas       (_fwd_kernel / _fwd_stages)
//   ntt_inverse       <- ntt_inverse_pallas       (_inv_kernel / _inv_stages)
//                        (both: ntt_kernel)
//   encrypt_fused     <- encrypt_fused_pallas     (_enc_kernel)
//   decrypt_fused     <- decrypt_fused_pallas     (_dec_kernel)
//   keyswitch_fused   <- keyswitch_fused_pallas   (_keyswitch_kernel)
//   hoisted_products  <- hoisted_rotations_pallas (_hoist_products_kernel)
//   transcipher_fused <- transcipher_fused_pallas (_transcipher_kernel)
//
// Data layout is the JAX package's [B, L, N] residue tensor as is: row
// r = b*L + l holds polynomial b mod prime l, N uint32 words (the port stores
// them as int32; residues are < 2**27 so the bits are the same). The TPU's
// transpose to (L, B, S, 128) and its per-stage pre-broadcast twiddle tables
// are Mosaic layout workarounds and are not carried over: twiddles are read
// from the [L, N] plain-domain psi / psi_shoup tables at index m + j.
//
// Design of K1 and K2 (redesigned for Hopper at the row counts the main
// paths launch: 3 to 54 rows of N words, where one block per row would keep
// 3 to 54 of the 132 SMs busy). One templated routine (ntt_kernel, above
// the K1/K2 launchers) serves both: each thread holds 8 words of its row in
// registers and runs up to three radix-2 stages there between two
// shared-memory exchanges (4 passes and 3 block barriers at N = 4096
// instead of 12 barriers), the exchange layout padded by one word every 32,
// the last pass's store (K1) and the first pass's load (K2) 16-byte
// vectors, each twiddle read once per group. When the row count leaves
// most SMs idle the host (cuda_ntt.ntt_plan) splits each row over a
// thread-block cluster of C = 2, 4 or 8 blocks: the stages whose
// butterflies cross blocks run in one pass, from device memory (K1) or
// through distributed shared memory (K2), and exchange their words with
// the other blocks of the cluster through distributed shared memory.
//
// Design of K5 (redesigned on the same routine). Its digit stage is K1's
// transform under a second load policy (DigitRows): the cross-block first
// pass, which already reads device memory, takes each word straight from
// the ciphertext's coefficient limb, cuts out the base-2**w digit and
// centres it, so the digits are never written before their transform. Its
// B*R*L rows get ntt_plan's cluster size (C = 2 at one ciphertext of L = 3,
// R = 18), and the eval-input inverse too (C = 8 at 5 rows, not 1). The
// digit x key inner product stays a second launch, now 16-byte loads with
// the R components of a word group spread over 8 threads (see its kernel).
//
// Design of K3 and K4 (redesigned on the same routine). K4 is K2's
// transform under a third load policy (DecryptRows): the inverse's first
// pass, which holds 8 consecutive words of its row, loads those words of
// c0, c1 and the prime's row of s as 16-byte vectors and forms
// d = c0 + c1*s in registers, so d is never written; the rest is K2's
// (passes, the N^-1 Shoup multiply on the store, the cluster split). K3 runs
// three forward transforms a row, not the TPU kernel's four: the transform
// is linear mod p and every word is a canonical residue, so
// NTT(e0) + NTT(m) = NTT((e0 + m) mod p) word for word, and
// c0 = b*NTT(u) + NTT(e0 + m), c1 = a*NTT(u) + NTT(e1) are the four-transform
// words bitwise. The routine takes the number of transforms T of a row from
// its load policy (EncryptRows: T = 3, u, e0 + m and e1 read at the first
// pass's indices); each pass runs all T transforms of the row between the
// same two barriers, reading each twiddle once for the T groups that share
// it; the last forward pass holds the same 8 consecutive words of every
// transform, and a store policy (EncryptStore) forms c0 and c1 there from
// 16-byte loads of the key rows and stores each as two 16-byte vectors. Both
// follow ntt_plan: C = 1 at the rounds' 165 to 456 rows, C = 8 at serving's
// one-ciphertext encrypt.
//
// Design of K7 (redesigned on the same routine). The transcipher is K1's
// transform under a fourth load policy and a second store policy. Its
// load policy (TranscipherRows) embeds the word pair at the first pass's
// indices: row r = b*L + l reads word x of upload row b's w_hi and w_lo and
// returns m = (hi mod p)*(2**31 mod p) + (lo mod p) (two Barrett reductions
// and a Montgomery product with the prime's constants, fetched once a row),
// so m is never written. Its store policy (TranscipherStore) takes the last
// forward pass's 8 consecutive words of NTT(m), loads the same 8 words of
// both pad rows as 16-byte vectors, and stores c0 = NTT(m) - pad0 and
// c1 = -pad1 (which needs no transform) as two 16-byte vectors each. It
// follows ntt_plan: C = 1 at the HHE round's 456 rows, C = 8 at a few.
//
// Design of K6 (redesigned for Hopper: 16-byte groups with the gadget
// components split over threads, one lazy Montgomery reduction per word,
// streaming key loads) is described above its kernel below.
//
// Bounds on the H100 (see PERF.md for the measured times): each kernel reads
// every input word once and writes every output word once, so the byte
// bound is (inputs + outputs) * 4 B / 3.35 TB/s, e.g. 6 * 330 rows * 16 KB
// for K3 at [110, 3, 4096]; the operation count is (N/2) * log2 N butterflies
// per transform of about 12 32-bit integer instructions each, over the
// card's 32-bit integer issue rate (132 SMs x 64 lanes x 1.98 GHz). At the
// round's shapes the operations set the bound, the bytes second (K3, three
// transforms a row: 0.019 ms against 0.010 ms).
//
// Arithmetic: Shoup products q = __umulhi(a, w_shoup), r = a*w - q*p (mod
// 2**32), one conditional subtract; Montgomery products for key polynomials
// (a native 32x32->64 multiply plus REDC with -p^-1 mod 2**32). Every output
// is a canonical residue, so the kernels match the plain int64 PyTorch
// versions and the JAX package's XLA path bit for bit.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMinLogN = 8;    // N = 256
constexpr int kMaxLogN = 14;   // N = 16384

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t t = a + b;
  return t >= p ? t - p : t;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t t = a + p - b;
  return t >= p ? t - p : t;
}

// a * w mod p with the Harvey/Shoup quotient w_shoup = floor(w * 2**32 / p).
__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w, uint32_t w_shoup,
                                              uint32_t p) {
  const uint32_t q = __umulhi(a, w_shoup);
  const uint32_t r = a * w - q * p;  // true value in [0, 2p), exact mod 2**32
  return r >= p ? r - p : r;
}

// x mod p for any 32-bit x with mu = floor((2**32 - 1) / p): the quotient
// estimate is at most one short, so one conditional subtract is canonical.
__device__ __forceinline__ uint32_t barrett_mod(uint32_t x, uint32_t p, uint32_t mu) {
  const uint32_t r = x - __umulhi(x, mu) * p;
  return r >= p ? r - p : r;
}

// a * b * 2**-32 mod p (Montgomery REDC); with b in Montgomery form = a*b mod p.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b, uint32_t p,
                                             uint32_t pinv_neg) {
  const uint64_t prod = static_cast<uint64_t>(a) * b;
  const uint32_t lo = static_cast<uint32_t>(prod);
  const uint32_t hi = static_cast<uint32_t>(prod >> 32);
  const uint32_t m = lo * pinv_neg;
  const uint32_t t = hi + __umulhi(m, p) + (lo != 0u ? 1u : 0u);
  return t >= p ? t - p : t;
}

// K1-K4, K5's digit stage and K7: the register-resident, cluster-split
// transform.
//
// A row of N words is split over a cluster of C = 1, 2, 4 or 8 thread
// blocks (the host's plan, cuda_ntt.ntt_plan: C > 1 only when the row count
// leaves most SMs idle); block `rank` owns the N/C words [rank*N/C,
// (rank+1)*N/C) of the row in shared memory, padded by one word after every
// 32, and has N/(8C) threads, each holding kWords = 8 words in registers.
// The log2 N stages run in passes of up to three radix-2 stages: a pass
// loads a thread's 2**R-word groups, runs R stages on them in registers and
// stores them back to the same places, so a pass needs no barrier inside it
// and one between it and the next.
//
// Pass geometry (forward; the inverse runs the same passes in reverse, each
// in reverse stage order): a pass over stages s..s+R-1 splits the row into
// groups x_k = J*(N >> s) + i0 + k*u, k < 2**R, u = N >> (s+R), i0 < u;
// stage s+r pairs k with k + 2**(R-1-r) under twiddle index
// 2**(s+r) + (J << r) + (k >> (R-r)), so a group reads 2**r twiddles at
// stage s+r, once each. Passes: 3 stages, then (log2 N - 3) mod 3 if
// non-zero, then 3 at a time (log2 N = 12: 3+3+3+3, 13: 3+1+3+3+3).
//
// The first forward pass (stages 0-2, u = N/8) is the only one whose groups
// cross block boundaries: its 8 words lie in all eighths of the row. Each
// block runs it on its own N/(8C) groups straight from device memory
// (coalesced 4-byte loads, consecutive threads on consecutive words) and
// then stores word x_k into the shared memory of block x_k / (N/C) through
// distributed shared memory (map_shared_rank), between two cluster.sync()s:
// the first makes sure every block of the cluster runs, the second that
// every word has landed. The later passes stay in the block. The last
// forward pass (u = 1) holds 8 consecutive words and hands them to the
// store policy (two 16-byte vectors). The inverse mirrors it: its first pass
// takes 8 consecutive words from the load policy (16-byte vectors), its last
// (stages 2..0) reads its words from the owning blocks' shared memory after
// a cluster.sync(), multiplies by N^-1 (Shoup) while storing, and ends with
// a cluster.sync() so that no block exits while a neighbour still reads its
// shared memory.
//
// T transforms a row (K3: T = 3, the others 1): shared memory holds T
// padded segments one after the other, a thread T groups of each shape, and
// every pass runs the same stages on the T groups, sharing the twiddles and
// the barriers.
//
// At N = 4096: 4 passes, 3 block barriers (plus 2 cluster barriers when
// C > 1) instead of 12, and 3 rows keep 24 SMs busy at C = 8 instead of 3.
constexpr int kWords = 8;

__device__ __forceinline__ void load8(const uint32_t* src, uint32_t* v) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  const uint4 a = s4[0], b = s4[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(uint32_t* dst, const uint32_t* v) {
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  d4[0] = make_uint4(v[0], v[1], v[2], v[3]);
  d4[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

// Shared-memory index of row word x: one spare word after every 32, so
// strides of 8 and below between threads stop conflicting on banks.
__host__ __device__ constexpr int pad(int x) { return x + (x >> 5); }

// Stage s+r of a pass over stages s..s+R-1 on T groups of 2**R words,
// group t at v + t*kWords, word k of it x_k, J the groups' global block
// index: pairs k, k + 2**(R-1-r) under twiddle 2**(s+r) + (J << r) +
// (k >> (R-r)), read once for the T * 2**(R-r) words that share it.
// Forward: Cooley-Tukey; inverse: Gentleman-Sande.
template <int R, int r, bool kInverse, int T>
__device__ __forceinline__ void group_stage(uint32_t* v, int s, int j, const uint32_t* tw,
                                            const uint32_t* tw_sh, uint32_t p) {
  constexpr int kHalf = 1 << (R - 1 - r);
  const int first = (1 << (s + r)) + (j << r);
#pragma unroll
  for (int g = 0; g < (1 << r); ++g) {
    const uint32_t w = __ldg(tw + first + g);
    const uint32_t ws = __ldg(tw_sh + first + g);
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int k0 = 0; k0 < kHalf; ++k0) {
        const int lo = t * kWords + g * 2 * kHalf + k0;
        const int hi = lo + kHalf;
        const uint32_t a = v[lo];
        if constexpr (kInverse) {
          v[lo] = add_mod(a, v[hi], p);
          v[hi] = shoup_mul(sub_mod(a, v[hi], p), w, ws, p);
        } else {
          const uint32_t b = shoup_mul(v[hi], w, ws, p);
          v[lo] = add_mod(a, b, p);
          v[hi] = sub_mod(a, b, p);
        }
      }
    }
  }
}

// All R stages of T groups: in increasing order forward, decreasing inverse.
template <int R, bool kInverse, int T>
__device__ __forceinline__ void group_stages(uint32_t* v, int s, int j, const uint32_t* tw,
                                             const uint32_t* tw_sh, uint32_t p) {
  if constexpr (!kInverse) {
    group_stage<R, 0, false, T>(v, s, j, tw, tw_sh, p);
    if constexpr (R > 1) group_stage<R, 1, false, T>(v, s, j, tw, tw_sh, p);
    if constexpr (R > 2) group_stage<R, 2, false, T>(v, s, j, tw, tw_sh, p);
  } else {
    if constexpr (R > 2) group_stage<R, 2, true, T>(v, s, j, tw, tw_sh, p);
    if constexpr (R > 1) group_stage<R, 1, true, T>(v, s, j, tw, tw_sh, p);
    group_stage<R, 0, true, T>(v, s, j, tw, tw_sh, p);
  }
}

// One pass of R stages from stage s inside the block's segment of SEG
// words (segment offset seg in the row) of each of the T transforms: each
// thread takes kWords >> R groups of each, local group q*THREADS + tid,
// loads them from shared memory (transform t's segment at t*pad(SEG)),
// runs the stages and stores them back in place.
template <int LOGN, int SEG, int R, bool kInverse, int T>
__device__ __forceinline__ void local_pass(uint32_t* sm, int s, int seg, const uint32_t* tw,
                                           const uint32_t* tw_sh, uint32_t p) {
  constexpr int kThreadsPerBlock = SEG / kWords;
  constexpr int kGroup = 1 << R;
  constexpr int kStride = pad(SEG);
  const int log_u = LOGN - s - R;
  const int span = (1 << LOGN) >> s;
  uint32_t v[T * kWords];
#pragma unroll
  for (int q = 0; q < kWords / kGroup; ++q) {
    const int gl = q * kThreadsPerBlock + static_cast<int>(threadIdx.x);
    const int jl = gl >> log_u;
    const int x0 = jl * span + (gl & ((1 << log_u) - 1));
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        v[t * kWords + q * kGroup + k] = sm[t * kStride + pad(x0 + (k << log_u))];
    group_stages<R, kInverse, T>(v + q * kGroup, s, seg / span + jl, tw, tw_sh, p);
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        sm[t * kStride + pad(x0 + (k << log_u))] = v[t * kWords + q * kGroup + k];
  }
}

// Load policies: where the first pass finds its words. kTransforms is T,
// the transforms a row; row(r, num_l, n) does the per-row index work once
// and returns a functor. The forward's first pass calls it as (t, x, p):
// word x of transform t of the row, p the row's prime; the inverse's first
// pass as vec8(x0, p, v): the 8 words x0..x0+7 (x0 a multiple of 8) into v.
// Plain loads in the forward: through __ldg (the read-only path) the first
// pass took about 1 us longer on the H100 at 3 to 54 rows (PERF.md).
//
// PlainRows (K1, K2): row r of the [rows, N] input itself.
struct PlainRows {
  static constexpr int kTransforms = 1;
  const uint32_t* in;
  struct Row {
    const uint32_t* src;
    __device__ __forceinline__ uint32_t operator()(int, int x, uint32_t) const {
      return src[x];
    }
    __device__ __forceinline__ void vec8(int x0, uint32_t, uint32_t* v) const {
      load8(src + x0, v);
    }
  };
  __device__ __forceinline__ Row row(size_t r, int, int n) const { return {in + r * n}; }
};

// DigitRows (K5's digit stage, forward only): row r = (b*R + c)*L + j of
// the digit tensor D[B, R, L, N], R = L*d, is digit k = c % d (bits
// w*k .. w*k+w-1) of coefficient limb i = c / d of ciphertext b, centred by
// 2**(w-1) under the output prime p_j = primes[r % L]. A limb is read d*L
// times, by d*L rows; after the first the words come from the L2.
struct DigitRows {
  static constexpr int kTransforms = 1;
  const uint32_t* coeff;   // [B, L, N] canonical coefficient residues
  int num_digits;          // d
  int digit_bits;          // w
  struct Row {
    const uint32_t* src;
    int shift;
    uint32_t mask, half;
    __device__ __forceinline__ uint32_t operator()(int, int x, uint32_t p) const {
      return sub_mod((src[x] >> shift) & mask, half, p);
    }
  };
  __device__ __forceinline__ Row row(size_t r, int num_l, int n) const {
    const int num_r = num_l * num_digits;
    const size_t bc = r / num_l;
    const int c = static_cast<int>(bc % num_r);
    const size_t b = bc / num_r;
    return {coeff + (b * num_l + c / num_digits) * n, digit_bits * (c % num_digits),
            (1u << digit_bits) - 1u, 1u << (digit_bits - 1)};
  }
};

// EncryptRows (K3, forward only): three transforms of row r = b*L + l of
// the coefficient-domain [B, L, N] inputs: u, (e0 + m) mod p and e1. The
// words of m and e0 are added as they are loaded, so their sum is never
// written.
struct EncryptRows {
  static constexpr int kTransforms = 3;
  const uint32_t *u, *e0, *e1, *m;
  struct Row {
    const uint32_t *u, *e0, *e1, *m;
    __device__ __forceinline__ uint32_t operator()(int t, int x, uint32_t p) const {
      return t == 0 ? u[x] : t == 1 ? add_mod(e0[x], m[x], p) : e1[x];
    }
  };
  __device__ __forceinline__ Row row(size_t r, int, int n) const {
    const size_t o = r * n;
    return {u + o, e0 + o, e1 + o, m + o};
  }
};

// DecryptRows (K4, inverse only): row r = b*L + l is d = c0 + c1*s mod p,
// s the Montgomery-form secret key's row of prime l, formed from 16-byte
// loads of c0, c1 and s.
struct DecryptRows {
  static constexpr int kTransforms = 1;
  const uint32_t *c0, *c1, *s_mont, *pinv_neg;
  struct Row {
    const uint32_t *c0, *c1, *s;
    uint32_t pinv;
    __device__ __forceinline__ void vec8(int x0, uint32_t p, uint32_t* v) const {
      uint32_t a[kWords], b[kWords], k[kWords];
      load8(c0 + x0, a);
      load8(c1 + x0, b);
      load8(s + x0, k);
#pragma unroll
      for (int i = 0; i < kWords; ++i) v[i] = add_mod(a[i], mont_mul(b[i], k[i], p, pinv), p);
    }
  };
  __device__ __forceinline__ Row row(size_t r, int num_l, int n) const {
    const int l = static_cast<int>(r % num_l);
    return {c0 + r * n, c1 + r * n, s_mont + static_cast<size_t>(l) * n, pinv_neg[l]};
  }
};

// TranscipherRows (K7, forward only): row r = b*L + l is the exact
// embedding of upload row b's word pair under prime l,
// m = (hi mod p) * (2**31 mod p) + (lo mod p): Barrett reductions with
// mu = floor((2**32 - 1) / p), one Montgomery product with
// sh31 = (2**31 mod p) in Montgomery form. The words [B, N] carry no limb
// axis, so a pair is read by the L rows of its upload row (after the first,
// from the L2).
struct TranscipherRows {
  static constexpr int kTransforms = 1;
  const uint32_t *w_hi, *w_lo, *mu, *sh31, *pinv_neg;
  struct Row {
    const uint32_t *hi, *lo;
    uint32_t mu, sh31, pinv;
    __device__ __forceinline__ uint32_t operator()(int, int x, uint32_t p) const {
      return add_mod(mont_mul(barrett_mod(hi[x], p, mu), sh31, p, pinv),
                     barrett_mod(lo[x], p, mu), p);
    }
  };
  __device__ __forceinline__ Row row(size_t r, int num_l, int n) const {
    const int l = static_cast<int>(r % num_l);
    const size_t o = r / num_l * n;
    return {w_hi + o, w_lo + o, mu[l], sh31[l], pinv_neg[l]};
  }
};

// Store policies: where the last pass puts its words. row(r, l, n) returns
// a functor; the forward's last pass calls vec8(x0, v, p) with the 8 words
// x0..x0+7 of each of the T transforms (transform t at v + t*kWords), the
// inverse's word(x, value) for each word.
//
// PlainStore (K1, K2, K4, K5): row r of the [rows, N] output.
struct PlainStore {
  uint32_t* out;
  struct Row {
    uint32_t* dst;
    __device__ __forceinline__ void vec8(int x0, const uint32_t* v, uint32_t) const {
      store8(dst + x0, v);
    }
    __device__ __forceinline__ void word(int x, uint32_t value) const { dst[x] = value; }
  };
  __device__ __forceinline__ Row row(size_t r, int, int n) const { return {out + r * n}; }
};

// EncryptStore (K3, after EncryptRows): from U = NTT(u), E = NTT(e0 + m)
// and F = NTT(e1), c0 = b*U + E and c1 = a*U + F (b, a the Montgomery-form
// public key's rows of prime l, 16-byte loads), each stored as two 16-byte
// vectors.
struct EncryptStore {
  uint32_t *c0, *c1;
  const uint32_t *b_mont, *a_mont, *pinv_neg;
  struct Row {
    uint32_t *c0, *c1;
    const uint32_t *b, *a;
    uint32_t pinv;
    __device__ __forceinline__ void vec8(int x0, const uint32_t* v, uint32_t p) const {
      uint32_t k[kWords], out[kWords];
      load8(b + x0, k);
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        out[i] = add_mod(mont_mul(v[i], k[i], p, pinv), v[kWords + i], p);
      store8(c0 + x0, out);
      load8(a + x0, k);
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        out[i] = add_mod(mont_mul(v[i], k[i], p, pinv), v[2 * kWords + i], p);
      store8(c1 + x0, out);
    }
  };
  __device__ __forceinline__ Row row(size_t r, int l, int n) const {
    const size_t key = static_cast<size_t>(l) * n;
    return {c0 + r * n, c1 + r * n, b_mont + key, a_mont + key, pinv_neg[l]};
  }
};

// TranscipherStore (K7, after TranscipherRows): from M = NTT(m),
// c0 = M - pad0 and c1 = -pad1 (zero stays zero), the pad rows loaded and
// both outputs stored as 16-byte vectors.
struct TranscipherStore {
  uint32_t *c0, *c1;
  const uint32_t *pad0, *pad1;
  struct Row {
    uint32_t *c0, *c1;
    const uint32_t *pad0, *pad1;
    __device__ __forceinline__ void vec8(int x0, const uint32_t* v, uint32_t p) const {
      uint32_t z[kWords], out[kWords];
      load8(pad0 + x0, z);
#pragma unroll
      for (int i = 0; i < kWords; ++i) out[i] = sub_mod(v[i], z[i], p);
      store8(c0 + x0, out);
      load8(pad1 + x0, z);
#pragma unroll
      for (int i = 0; i < kWords; ++i) out[i] = z[i] == 0u ? 0u : p - z[i];
      store8(c1 + x0, out);
    }
  };
  __device__ __forceinline__ Row row(size_t r, int, int n) const {
    const size_t o = r * n;
    return {c0 + o, c1 + o, pad0 + o, pad1 + o};
  }
};

// K1 (kInverse = false, PlainRows) replaces ntt_forward_pallas
// (pallas_ntt.py, _fwd_kernel / _fwd_stages); K2 (kInverse = true)
// replaces ntt_inverse_pallas (_inv_kernel / _inv_stages), its N^-1 Shoup
// multiply folded into the store; K5's digit stage is the forward
// transform with DigitRows; K3 the forward with EncryptRows and
// EncryptStore, K4 the inverse with DecryptRows; K7 (transcipher_fused_pallas,
// _transcipher_kernel) the forward with TranscipherRows and
// TranscipherStore. Grid: rows * C blocks, clusters of C along x;
// T * pad(N/C) words of dynamic shared memory. Bound at the main paths' 3
// to 456 rows: operations, then bytes (rows in, rows out, the prime's
// twiddle tables; K7 at [152, 3, 4096]: the 456 transforms 0.011 ms, its
// 34.9 MB 0.010 ms); see PERF.md.
template <int LOGN, int C, bool kInverse, typename Src, typename Dst>
__global__ void __launch_bounds__((1 << LOGN) / C / kWords)
ntt_kernel(Src src, Dst dst, const uint32_t* __restrict__ tw_all,
           const uint32_t* __restrict__ tw_sh_all, const uint32_t* __restrict__ primes,
           const uint32_t* __restrict__ n_inv, const uint32_t* __restrict__ n_inv_sh,
           int num_l) {
  constexpr int T = Src::kTransforms;
  static_assert(!kInverse || T == 1, "the inverse runs one transform a row");
  constexpr int N = 1 << LOGN;
  constexpr int SEG = N / C;
  constexpr int kStride = pad(SEG);              // shared words of one transform
  constexpr int kThreadsPerBlock = SEG / kWords;
  constexpr int kShort = (LOGN - 3) % 3;         // stages of the short pass, 0: none
  extern __shared__ uint32_t sm[];               // T * pad(SEG) words
  int rank = 0;
  if constexpr (C > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const size_t row = blockIdx.x / C;
  const int l = static_cast<int>(row % num_l);
  const uint32_t p = primes[l];
  const uint32_t* tw = tw_all + static_cast<size_t>(l) * N;
  const uint32_t* tw_sh = tw_sh_all + static_cast<size_t>(l) * N;
  const int tid = threadIdx.x;
  const int seg = rank * SEG;
  const int g = rank * kThreadsPerBlock + tid;   // group of the cross-block pass
  uint32_t v[T * kWords];
  if constexpr (!kInverse) {
    const auto load = src.row(row, num_l, N);
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int k = 0; k < kWords; ++k) v[t * kWords + k] = load(t, g + k * (N / kWords), p);
    group_stages<3, false, T>(v, 0, 0, tw, tw_sh, p);
    if constexpr (C > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          const int x = g + k * (N / kWords);
          cluster.map_shared_rank(sm, x / SEG)[t * kStride + pad(x % SEG)] = v[t * kWords + k];
        }
      cluster.sync();
    } else {
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int k = 0; k < kWords; ++k)
          sm[t * kStride + pad(g + k * (N / kWords))] = v[t * kWords + k];
      __syncthreads();
    }
    if constexpr (kShort > 0) {
      local_pass<LOGN, SEG, kShort, false, T>(sm, 3, seg, tw, tw_sh, p);
      __syncthreads();
    }
#pragma unroll
    for (int s = 3 + kShort; s < LOGN - 3; s += 3) {
      local_pass<LOGN, SEG, 3, false, T>(sm, s, seg, tw, tw_sh, p);
      __syncthreads();
    }
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int k = 0; k < kWords; ++k) v[t * kWords + k] = sm[t * kStride + pad(kWords * tid + k)];
    group_stages<3, false, T>(v, LOGN - 3, (seg >> 3) + tid, tw, tw_sh, p);
    dst.row(row, l, N).vec8(seg + kWords * tid, v, p);
  } else {
    src.row(row, num_l, N).vec8(seg + kWords * tid, p, v);
    group_stages<3, true, 1>(v, LOGN - 3, (seg >> 3) + tid, tw, tw_sh, p);
#pragma unroll
    for (int k = 0; k < kWords; ++k) sm[pad(kWords * tid + k)] = v[k];
    __syncthreads();
#pragma unroll
    for (int s = LOGN - 6; s >= 3 + kShort; s -= 3) {
      local_pass<LOGN, SEG, 3, true, 1>(sm, s, seg, tw, tw_sh, p);
      __syncthreads();
    }
    if constexpr (kShort > 0) {
      local_pass<LOGN, SEG, kShort, true, 1>(sm, 3, seg, tw, tw_sh, p);
      __syncthreads();
    }
    if constexpr (C > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const int x = g + k * (N / kWords);
        v[k] = cluster.map_shared_rank(sm, x / SEG)[pad(x % SEG)];
      }
    } else {
#pragma unroll
      for (int k = 0; k < kWords; ++k) v[k] = sm[pad(g + k * (N / kWords))];
    }
    group_stages<3, true, 1>(v, 0, 0, tw, tw_sh, p);
    const uint32_t w = n_inv[l], ws = n_inv_sh[l];
    const auto store = dst.row(row, l, N);
#pragma unroll
    for (int k = 0; k < kWords; ++k) store.word(g + k * (N / kWords), shoup_mul(v[k], w, ws, p));
    if constexpr (C > 1) cg::this_cluster().sync();
  }
}

// Device pointers and sizes of one ntt_kernel launch besides its load and
// store policies (n_inv, n_inv_sh: the inverse only).
struct NttArgs {
  const void* tw;
  const void* tw_sh;
  const void* primes;
  const void* n_inv;
  const void* n_inv_sh;
  int rows;
  int num_l;
};

template <int LOGN, int C, bool kInverse, typename Src, typename Dst>
cudaError_t launch_ntt_kernel(const Src& src, const Dst& dst, const NttArgs& a,
                              cudaStream_t stream) {
  constexpr int SEG = (1 << LOGN) / C;
  const auto kernel = ntt_kernel<LOGN, C, kInverse, Src, Dst>;
  const size_t smem = static_cast<size_t>(Src::kTransforms) * pad(SEG) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.rows) * C);
  cfg.blockDim = dim3(SEG / kWords);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, src, dst, static_cast<const uint32_t*>(a.tw),
                            static_cast<const uint32_t*>(a.tw_sh),
                            static_cast<const uint32_t*>(a.primes),
                            static_cast<const uint32_t*>(a.n_inv),
                            static_cast<const uint32_t*>(a.n_inv_sh), a.num_l);
}

// Cluster sizes instantiated at LOGN: one block a row below N = 1024 (at
// N = 256 a block is one warp, N/8 = 32 threads, and a cluster of C would
// cut a row into segments of fewer words than one padded 32-word stretch);
// 2, 4 and 8 at N = 16384, where one block a row would need 2048 threads;
// 1, 2, 4 and 8 from 1024 to 8192. cuda_ntt.ntt_plan asks only for these.
template <int LOGN>
constexpr bool cluster_ok(int c) {
  return LOGN < 10 ? c == 1 : LOGN > 13 ? c > 1 : true;
}

template <int LOGN, int C, bool kInverse, typename Src, typename Dst>
cudaError_t launch_ntt_if(const Src& src, const Dst& dst, const NttArgs& a, cudaStream_t stream) {
  if constexpr (cluster_ok<LOGN>(C)) {
    return launch_ntt_kernel<LOGN, C, kInverse>(src, dst, a, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <int LOGN, bool kInverse, typename Src, typename Dst>
cudaError_t launch_ntt_logn(int cluster, const Src& src, const Dst& dst, const NttArgs& a,
                            cudaStream_t stream) {
  switch (cluster) {
    case 1: return launch_ntt_if<LOGN, 1, kInverse>(src, dst, a, stream);
    case 2: return launch_ntt_if<LOGN, 2, kInverse>(src, dst, a, stream);
    case 4: return launch_ntt_if<LOGN, 4, kInverse>(src, dst, a, stream);
    case 8: return launch_ntt_if<LOGN, 8, kInverse>(src, dst, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Launch the transform on a.rows rows with cluster size `cluster` (one of
// cluster_ok's at log2 N; anything else, or an N outside 256..16384, is
// refused with cudaErrorInvalidValue before any launch). Instantiated for K1
// and K2 (PlainRows, PlainStore), K5's digit stage (DigitRows, forward), K3
// (EncryptRows, EncryptStore), K4 (DecryptRows, inverse) and K7
// (TranscipherRows, TranscipherStore). The pass schedule covers every size:
// 3 + 2 + 3 stages at N = 256, 3 + 3 + 3 at 512, 3 + 2 + 3 + 3 + 3 at 16384.
template <bool kInverse, typename Src, typename Dst>
cudaError_t launch_ntt(int logn, int cluster, const Src& src, const Dst& dst, const NttArgs& a,
                       cudaStream_t stream) {
  if (a.rows <= 0 || a.num_l <= 0) return cudaErrorInvalidValue;
  switch (logn) {
    case 8: return launch_ntt_logn<8, kInverse>(cluster, src, dst, a, stream);
    case 9: return launch_ntt_logn<9, kInverse>(cluster, src, dst, a, stream);
    case 10: return launch_ntt_logn<10, kInverse>(cluster, src, dst, a, stream);
    case 11: return launch_ntt_logn<11, kInverse>(cluster, src, dst, a, stream);
    case 12: return launch_ntt_logn<12, kInverse>(cluster, src, dst, a, stream);
    case 13: return launch_ntt_logn<13, kInverse>(cluster, src, dst, a, stream);
    case 14: return launch_ntt_logn<14, kInverse>(cluster, src, dst, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// K5. Replaces keyswitch_fused_pallas (pallas_ntt.py, _keyswitch_kernel):
// (optional inverse NTT per limb) -> base-2**w digits -> centring -> forward
// NTT under every output prime -> digit x key inner product + correction
// row. On the TPU the grid is (L, B) and each step runs all R = L*d
// transforms of its output prime in series; on Hopper that would be 3
// blocks at a serving batch of 1. Here:
//
// Stage 1, the digit stage, is ntt_kernel with the DigitRows load policy:
// one transform per row (b, c, j) of D[B, R, L, N] (54 rows at B = 1,
// L = 3: K1's [18, 3, 4096] shape), split over ntt_plan(B*R*L, N) blocks,
// the digit cut out and centred inside the first, cross-block pass, the
// row stored as 16-byte vectors.
//
// Stage 2, the inner product (below): a reduction over c across the stage-1
// rows, so a second launch. One thread per 4 consecutive output words per
// share of the components: kReduceSplit threads split the R components of
// one 4-word group (c = q, q + 8, ...), each with 16-byte loads of the
// digits and both keys, so a thread waits for at most ceil(R / 8) rows of
// loads instead of R in a row; the shares meet in shared memory.
//
// Bound: operations, the B*R*L transforms (0.0013 ms at [1, 3, 4096]); the
// bytes (x, the [R+1, L, N] keys, c0 and c1) are 2.1 MB. The digit rows
// (0.88 MB at [1, 3, 4096]) go through the L2 between the two launches.
constexpr int kReduceGroups = 32;   // 4-word output groups per block: one warp's worth
constexpr int kReduceSplit = 8;     // threads sharing one group's R components

// acc[i] += d[i] * k[i] mod p for the 4 words of a group (k Montgomery).
__device__ __forceinline__ void mac4(uint32_t* acc, uint4 d, uint4 k, uint32_t p,
                                     uint32_t pinv) {
  acc[0] = add_mod(acc[0], mont_mul(d.x, k.x, p, pinv), p);
  acc[1] = add_mod(acc[1], mont_mul(d.y, k.y, p, pinv), p);
  acc[2] = add_mod(acc[2], mont_mul(d.z, k.z, p, pinv), p);
  acc[3] = add_mod(acc[3], mont_mul(d.w, k.w, p, pinv), p);
}

__device__ __forceinline__ void add4(uint32_t* acc, uint4 v, uint32_t p) {
  acc[0] = add_mod(acc[0], v.x, p);
  acc[1] = add_mod(acc[1], v.y, p);
  acc[2] = add_mod(acc[2], v.z, p);
  acc[3] = add_mod(acc[3], v.w, p);
}

// K5, stage 2: thread (x, q) of block blk takes the 4-word group
// g = blk*kReduceGroups + x of c0/c1 [B, L, N] and components c = q, q + 8,
// ... < R; thread q = 0 adds the other shares and the correction row
// 1 * k[R] (the constant-1 digit's evaluation form is all ones), and writes
// 4 words of c0 and of c1. Every term is a canonical residue and add_mod is
// exact, so the sum mod p does not depend on the order of the additions:
// the words equal the plain version's, which adds in component order.
// Warp x-lanes read 32 consecutive 16-byte vectors of every row.
__global__ void __launch_bounds__(kReduceGroups * kReduceSplit)
keyswitch_reduce_kernel(const uint4* __restrict__ digits, const uint4* __restrict__ bk,
                        const uint4* __restrict__ ak, uint4* __restrict__ c0,
                        uint4* __restrict__ c1, const uint32_t* __restrict__ primes,
                        const uint32_t* __restrict__ pinv_neg, int batch, int num_l,
                        int num_r, int logn) {
  __shared__ uint4 share[2][kReduceSplit - 1][kReduceGroups];
  const unsigned per = (static_cast<unsigned>(num_l) << logn) / 4;   // groups of one [L, N]
  const unsigned g = blockIdx.x * kReduceGroups + threadIdx.x;
  const int q = static_cast<int>(threadIdx.y);
  const bool live = g < static_cast<unsigned>(batch) * per;
  const unsigned ln = live ? g % per : 0u;
  const int j = static_cast<int>((ln * 4) >> logn);
  const uint32_t p = primes[j];
  const uint32_t pinv = pinv_neg[j];
  uint32_t a0[4] = {0u, 0u, 0u, 0u};
  uint32_t a1[4] = {0u, 0u, 0u, 0u};
  uint4 k0 = make_uint4(0u, 0u, 0u, 0u), k1 = k0;
  if (live) {
    if (q == 0) {
      k0 = bk[num_r * per + ln];
      k1 = ak[num_r * per + ln];
    }
    const uint4* d = digits + static_cast<size_t>(g / per) * num_r * per + ln;
    // Unrolled, a thread's loads of several components are in flight at
    // once (on the H100, 1.2 us less at [1, 3, 4096] than the rolled loop;
    // PERF.md).
#pragma unroll 4
    for (int c = q; c < num_r; c += kReduceSplit) {
      const uint4 dc = d[c * per];
      mac4(a0, dc, bk[c * per + ln], p, pinv);
      mac4(a1, dc, ak[c * per + ln], p, pinv);
    }
  }
  if (q > 0) {
    share[0][q - 1][threadIdx.x] = make_uint4(a0[0], a0[1], a0[2], a0[3]);
    share[1][q - 1][threadIdx.x] = make_uint4(a1[0], a1[1], a1[2], a1[3]);
  }
  __syncthreads();
  if (q > 0 || !live) return;
#pragma unroll
  for (int s = 0; s < kReduceSplit - 1; ++s) {
    add4(a0, share[0][s][threadIdx.x], p);
    add4(a1, share[1][s][threadIdx.x], p);
  }
  c0[g] = make_uint4(add_mod(a0[0], mont_mul(1u, k0.x, p, pinv), p),
                     add_mod(a0[1], mont_mul(1u, k0.y, p, pinv), p),
                     add_mod(a0[2], mont_mul(1u, k0.z, p, pinv), p),
                     add_mod(a0[3], mont_mul(1u, k0.w, p, pinv), p));
  c1[g] = make_uint4(add_mod(a1[0], mont_mul(1u, k1.x, p, pinv), p),
                     add_mod(a1[1], mont_mul(1u, k1.y, p, pinv), p),
                     add_mod(a1[2], mont_mul(1u, k1.z, p, pinv), p),
                     add_mod(a1[3], mont_mul(1u, k1.w, p, pinv), p));
}

// K6. Replaces hoisted_rotations_pallas (pallas_ntt.py,
// _hoist_products_kernel): for every rotation step s, ciphertext b, prime l
// and word x, acc0[s, b] = c0[b] + sum_c D[b, c] * B'[s, c] and
// acc1[s, b] = sum_c D[b, c] * A'[s, c] over the R shared gadget digits. No
// NTT: the digits were transformed once outside, and the per-step output
// permutation is a gather the caller applies after.
//
// Bound: bytes at serving batches (B <= 4). The pre-permuted keys
// [S, R, L, N] are read once and dominate (38.9 MB for both at S = 22,
// R = 18, L = 3, N = 4096, about 12 us at 3.35 TB/s); the digits (0.9-4.9
// MB) are re-read by every step, from the L2. A key word is used B times,
// far below the ~295 operations a byte at which tensor cores would pay,
// and 27-bit modular products are not exact in any tensor-core type, so
// the kernel uses none. What the design does about the bytes:
//  * 16-byte groups, components split over threads. Thread (x, q) of a
//    block of kHoistThreads takes the 4-word group x of the block's tile of
//    the [S, B, L, N/4] output space and the components c = q, q + Q, ...
//    of each chunk, as 16-byte loads of the digit row and both key rows;
//    warp lanes read 32 consecutive vectors of a row. The host's plan
//    (cuda_ntt.hoisted_plan) picks Q so that the grid fills the card in one
//    wave (the kernel fits 4 blocks an SM): more threads a group where the
//    group count is small, none where it already fills the card. Blocks
//    run the B ciphertexts of one step's tile next to each other, so the
//    key lines the B - 1 others read are still in the L2.
//  * Streaming key loads (evict-first in L1 and L2): the keys are read
//    once and do not push the digits out of the L2.
//  * One lazy Montgomery reduction per word. The raw products d * k
//    (< 2**54) of a chunk of up to K components are summed in 64 bits (one
//    IMAD.WIDE.U32 a term), the Q threads' partial sums combined in a tree
//    through shared memory, and the sum reduced by one REDC. Since
//    mont_mul(a, b) = a*b*2**-32 mod p, sum_c mont_mul(d_c, k_c) =
//    (sum_c d_c*k_c) * 2**-32 mod p, and REDC returns exactly that,
//    canonical, for any T < p * 2**32: the words equal the plain version's
//    per-term products bitwise. K = floor((p*2**32 - 1) / (p-1)**2) over
//    the primes (32 at 27-bit primes), so the serving shapes (R = 18, 30)
//    take one REDC per word; R > K runs in chunks, each chunk's residue
//    added mod p.
// Variants that measured no faster on the H100 (PERF.md, section 6): several
// components' loads staged in registers before the products, a per-thread
// cp.async ring of up to 8 stages in shared memory, one thread serving up
// to 4 ciphertexts (or steps) from each key (or digit) load, and warp lanes
// that share one key load across ciphertexts.
constexpr int kHoistThreads = 256;

// (t * 2**-32) mod p for t < p * 2**32 (Montgomery REDC of a lazy sum).
__device__ __forceinline__ uint32_t redc(uint64_t t, uint32_t p, uint32_t pinv_neg) {
  const uint32_t lo = static_cast<uint32_t>(t);
  const uint32_t m = lo * pinv_neg;
  const uint32_t u = static_cast<uint32_t>(t >> 32) + __umulhi(m, p) + (lo != 0u ? 1u : 0u);
  return u >= p ? u - p : u;
}

__device__ __forceinline__ void mad4(uint64_t* t, uint4 d, uint4 k) {
  t[0] += static_cast<uint64_t>(d.x) * k.x;
  t[1] += static_cast<uint64_t>(d.y) * k.y;
  t[2] += static_cast<uint64_t>(d.z) * k.z;
  t[3] += static_cast<uint64_t>(d.w) * k.w;
}

__device__ __forceinline__ uint4 redc_add4(const uint64_t* t, uint4 a, uint32_t p,
                                           uint32_t pinv) {
  return make_uint4(add_mod(redc(t[0], p, pinv), a.x, p), add_mod(redc(t[1], p, pinv), a.y, p),
                    add_mod(redc(t[2], p, pinv), a.z, p), add_mod(redc(t[3], p, pinv), a.w, p));
}

// K6: blockDim = (kHoistThreads / Q, Q). Block blk covers ciphertext
// b = blk % B, tile blk / B % tiles of kHoistThreads / Q groups and step
// s = blk / (B * tiles); lane x takes group x of the tile. Per component
// chunk [base, base + chunk): thread (x, q) sums d * k over c = base + q,
// base + q + Q, ... < min(R, base + chunk) in 64 bits (chunk <= K, so every
// sum stays below p * 2**32); the tree halves the Q partial sums through
// shared memory (q < h adds q + h's); thread q = 0 reduces the total and
// writes out0 = c0 + REDC (first chunk) or out0 + REDC (later chunks, read
// back from its own store), out1 likewise without c0.
__global__ void __launch_bounds__(kHoistThreads)
hoisted_lazy_kernel(const uint4* __restrict__ c0, const uint4* __restrict__ digits,
                    const uint4* __restrict__ bk, const uint4* __restrict__ ak,
                    uint4* __restrict__ out0, uint4* __restrict__ out1,
                    const uint32_t* __restrict__ primes, const uint32_t* __restrict__ pinv_neg,
                    int batch, int num_r, int num_l, int logn, int chunk) {
  __shared__ uint64_t share[8][kHoistThreads / 2];
  const int split = static_cast<int>(blockDim.y);
  const int x = static_cast<int>(threadIdx.x);
  const int q = static_cast<int>(threadIdx.y);
  const size_t per = (static_cast<size_t>(num_l) << logn) / 4;   // groups of one [L, N]
  const size_t tiles = per / blockDim.x;
  const size_t b = blockIdx.x % batch;
  const size_t ln = blockIdx.x / batch % tiles * blockDim.x + x;
  const size_t s = blockIdx.x / (batch * tiles);
  const int l = static_cast<int>((ln * 4) >> logn);
  const uint32_t p = primes[l];
  const uint32_t pinv = pinv_neg[l];
  const size_t row = static_cast<size_t>(num_r) * per;             // one step's keys
  const uint4* kb = bk + s * row + ln;
  const uint4* ka = ak + s * row + ln;
  const uint4* d = digits + b * row + ln;
  const size_t o = (s * batch + b) * per + ln;
  for (int base = 0; base < num_r; base += chunk) {
    uint64_t t[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};
    const int end = min(num_r, base + chunk);
    for (int c = base + q; c < end; c += split) {
      const uint4 dv = d[c * per];
      mad4(t[0], dv, __ldcs(kb + c * per));
      mad4(t[1], dv, __ldcs(ka + c * per));
    }
    for (int h = split >> 1; h > 0; h >>= 1) {
      const int slot = (q - h) * static_cast<int>(blockDim.x) + x;
      if (q >= h && q < 2 * h) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          share[i][slot] = t[0][i];
          share[4 + i][slot] = t[1][i];
        }
      }
      __syncthreads();
      if (q < h) {
        const int from = q * static_cast<int>(blockDim.x) + x;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          t[0][i] += share[i][from];
          t[1][i] += share[4 + i][from];
        }
      }
      __syncthreads();
    }
    if (q == 0) {
      const bool first = base == 0;
      out0[o] = redc_add4(t[0], first ? c0[b * per + ln] : out0[o], p, pinv);
      out1[o] = redc_add4(t[1], first ? make_uint4(0u, 0u, 0u, 0u) : out1[o], p, pinv);
    }
  }
}

}  // namespace

extern "C" {

// Each launcher takes device pointers, the row count rows = B*L, the prime
// count L, log2 N and the CUDA stream; it launches on that stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).

int ntt_forward(const void* in, void* out, const void* psi, const void* psi_sh,
                const void* primes, int rows, int num_l, int logn, int cluster, void* stream) {
  const NttArgs a{psi, psi_sh, primes, nullptr, nullptr, rows, num_l};
  const PlainRows src{static_cast<const uint32_t*>(in)};
  const PlainStore dst{static_cast<uint32_t*>(out)};
  cudaError_t err = launch_ntt<false>(logn, cluster, src, dst, a,
                                      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

int ntt_inverse(const void* in, void* out, const void* psi_inv, const void* psi_inv_sh,
                const void* primes, const void* n_inv, const void* n_inv_sh, int rows,
                int num_l, int logn, int cluster, void* stream) {
  const NttArgs a{psi_inv, psi_inv_sh, primes, n_inv, n_inv_sh, rows, num_l};
  const PlainRows src{static_cast<const uint32_t*>(in)};
  const PlainStore dst{static_cast<uint32_t*>(out)};
  cudaError_t err = launch_ntt<true>(logn, cluster, src, dst, a,
                                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// K3: coefficient-domain m_res, u, e0, e1 [B, L, N] and the Montgomery-form
// public key b_mont/a_mont [L, N] -> evaluation-domain c0/c1 [B, L, N];
// rows = B*L, split over `cluster` blocks each. b_mont, a_mont, c0 and c1
// must be 16-byte aligned.
int encrypt_fused(const void* m_res, const void* u, const void* e0, const void* e1,
                  const void* b_mont, const void* a_mont, void* c0, void* c1,
                  const void* psi, const void* psi_sh, const void* primes,
                  const void* pinv_neg, int rows, int num_l, int logn, int cluster,
                  void* stream) {
  const NttArgs a{psi, psi_sh, primes, nullptr, nullptr, rows, num_l};
  const EncryptRows src{static_cast<const uint32_t*>(u), static_cast<const uint32_t*>(e0),
                        static_cast<const uint32_t*>(e1), static_cast<const uint32_t*>(m_res)};
  const EncryptStore dst{static_cast<uint32_t*>(c0), static_cast<uint32_t*>(c1),
                         static_cast<const uint32_t*>(b_mont),
                         static_cast<const uint32_t*>(a_mont),
                         static_cast<const uint32_t*>(pinv_neg)};
  cudaError_t err = launch_ntt<false>(logn, cluster, src, dst, a,
                                      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// K4: evaluation-domain c0/c1 [B, L, N] and the Montgomery-form secret key
// s_mont [L, N] -> coefficient-domain out [B, L, N]; rows = B*L, split over
// `cluster` blocks each. c0, c1 and s_mont must be 16-byte aligned.
int decrypt_fused(const void* c0, const void* c1, const void* s_mont, void* out,
                  const void* psi_inv, const void* psi_inv_sh, const void* primes,
                  const void* pinv_neg, const void* n_inv, const void* n_inv_sh, int rows,
                  int num_l, int logn, int cluster, void* stream) {
  const NttArgs a{psi_inv, psi_inv_sh, primes, n_inv, n_inv_sh, rows, num_l};
  const DecryptRows src{static_cast<const uint32_t*>(c0), static_cast<const uint32_t*>(c1),
                        static_cast<const uint32_t*>(s_mont),
                        static_cast<const uint32_t*>(pinv_neg)};
  const PlainStore dst{static_cast<uint32_t*>(out)};
  cudaError_t err = launch_ntt<true>(logn, cluster, src, dst, a,
                                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// K7: words w_hi/w_lo [B, N] (< 2**31), pads pad_c0/pad_c1 [B, L, N] ->
// c0/c1 [B, L, N], evaluation domain; rows = B*L, split over `cluster`
// blocks each. mu and sh31 are per prime. pad_c0, pad_c1, c0 and c1 must be
// 16-byte aligned.
int transcipher_fused(const void* w_hi, const void* w_lo, const void* pad_c0,
                      const void* pad_c1, void* c0, void* c1, const void* psi,
                      const void* psi_sh, const void* primes, const void* pinv_neg,
                      const void* mu, const void* sh31, int rows, int num_l, int logn,
                      int cluster, void* stream) {
  if (rows <= 0 || num_l <= 0 || rows % num_l != 0) return static_cast<int>(cudaErrorInvalidValue);
  const NttArgs a{psi, psi_sh, primes, nullptr, nullptr, rows, num_l};
  const TranscipherRows src{static_cast<const uint32_t*>(w_hi), static_cast<const uint32_t*>(w_lo),
                            static_cast<const uint32_t*>(mu), static_cast<const uint32_t*>(sh31),
                            static_cast<const uint32_t*>(pinv_neg)};
  const TranscipherStore dst{static_cast<uint32_t*>(c0), static_cast<uint32_t*>(c1),
                             static_cast<const uint32_t*>(pad_c0),
                             static_cast<const uint32_t*>(pad_c1)};
  cudaError_t err = launch_ntt<false>(logn, cluster, src, dst, a,
                                      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// K5: x [B, L, N] (coefficient domain, or evaluation domain with
// eval_input = 1), keys bk/ak [R + 1, L, N] -> c0/c1 [B, L, N], evaluation
// domain. Scratch: coeff_scratch [B, L, N] (used when eval_input: each limb
// is first inverse-transformed ONCE under its own prime, by K2's routine
// with cluster size inverse_cluster) and digit_scratch [B, R, L, N] (the
// digit stage, cluster size digit_cluster). bk, ak, c0, c1 and
// digit_scratch must be 16-byte aligned (x too when eval_input). Two or
// three launches on one stream; the wrapper counts the call once.
int keyswitch_fused(const void* x, void* coeff_scratch, void* digit_scratch, const void* bk,
                    const void* ak, void* c0, void* c1, const void* psi, const void* psi_sh,
                    const void* psi_inv, const void* psi_inv_sh, const void* primes,
                    const void* pinv_neg, const void* n_inv, const void* n_inv_sh, int batch,
                    int num_l, int num_digits, int digit_bits, int eval_input, int logn,
                    int digit_cluster, int inverse_cluster, void* stream) {
  if (batch <= 0 || num_l <= 0 || num_digits <= 0 || digit_bits < 1 || digit_bits > 31 ||
      digit_bits * (num_digits - 1) > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int num_r = num_l * num_digits;
  const uint32_t* coeff = static_cast<const uint32_t*>(x);
  cudaError_t err;
  if (eval_input) {
    const NttArgs a{psi_inv, psi_inv_sh, primes, n_inv, n_inv_sh, batch * num_l, num_l};
    err = launch_ntt<true>(logn, inverse_cluster, PlainRows{coeff},
                           PlainStore{static_cast<uint32_t*>(coeff_scratch)}, a, st);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    coeff = static_cast<const uint32_t*>(coeff_scratch);
  }
  const NttArgs a{psi, psi_sh, primes, nullptr, nullptr, batch * num_r * num_l, num_l};
  err = launch_ntt<false>(logn, digit_cluster, DigitRows{coeff, num_digits, digit_bits},
                          PlainStore{static_cast<uint32_t*>(digit_scratch)}, a, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t groups = (static_cast<size_t>(batch) * num_l << logn) / 4;
  keyswitch_reduce_kernel<<<static_cast<unsigned>((groups + kReduceGroups - 1) / kReduceGroups),
                            dim3(kReduceGroups, kReduceSplit), 0, st>>>(
      static_cast<const uint4*>(digit_scratch), static_cast<const uint4*>(bk),
      static_cast<const uint4*>(ak), static_cast<uint4*>(c0), static_cast<uint4*>(c1),
      static_cast<const uint32_t*>(primes), static_cast<const uint32_t*>(pinv_neg), batch, num_l,
      num_r, logn);
  return static_cast<int>(cudaGetLastError());
}

// K6: c0 [B, L, N], digits [B, R, L, N], keys bk/ak [S, R, L, N] ->
// out0/out1 [S, B, L, N] (before the per-step permutation); the host's plan
// (cuda_ntt.hoisted_plan) gives split Q in (1, 2, 4, 8) and chunk (a
// multiple of Q, at most K components a REDC). Every pointer must be
// 16-byte aligned.
int hoisted_products(const void* c0, const void* digits, const void* bk, const void* ak,
                     void* out0, void* out1, const void* primes, const void* pinv_neg,
                     int num_s, int batch, int num_r, int num_l, int logn, int split, int chunk,
                     void* stream) {
  if (num_s <= 0 || batch <= 0 || num_r <= 0 || num_l <= 0 || logn < kMinLogN ||
      logn > kMaxLogN || (split != 1 && split != 2 && split != 4 && split != 8) ||
      chunk < split || chunk % split != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // A block's groups divide the N/4 * L groups of a step: kHoistThreads /
  // split from N = 1024 up, at most N/4 (64 at N = 256) below.
  const unsigned quarter = (1u << logn) / 4u;
  const unsigned full = static_cast<unsigned>(kHoistThreads / split);
  const unsigned per_block = full < quarter ? full : quarter;
  const size_t tiles = (static_cast<size_t>(num_l) << logn) / 4 / per_block;
  hoisted_lazy_kernel<<<static_cast<unsigned>(num_s * batch * tiles),
                        dim3(per_block, static_cast<unsigned>(split)), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(c0), static_cast<const uint4*>(digits),
      static_cast<const uint4*>(bk), static_cast<const uint4*>(ak), static_cast<uint4*>(out0),
      static_cast<uint4*>(out1), static_cast<const uint32_t*>(primes),
      static_cast<const uint32_t*>(pinv_neg), batch, num_r, num_l, logn, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
