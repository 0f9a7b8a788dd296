// Hand-written Hopper (sm_90a) kernels for the CKKS hot path of the
// encrypted FedAvg round: forward NTT, inverse NTT, fused encrypt and fused
// decrypt. Plain C interface, built by nvcc into a shared library and called
// through ctypes (hefl_tpu_torch/ckks/cuda_ntt.py).
//
// Replaces the Pallas TPU kernels of hefl_tpu/ckks/pallas_ntt.py:
//   ntt_forward    <- ntt_forward_pallas   (_fwd_kernel / _fwd_stages)
//   ntt_inverse    <- ntt_inverse_pallas   (_inv_kernel / _inv_stages)
//   encrypt_fused  <- encrypt_fused_pallas (_enc_kernel)
//   decrypt_fused  <- decrypt_fused_pallas (_dec_kernel)
//
// Data layout is the JAX package's [B, L, N] residue tensor as is: row
// r = b*L + l holds polynomial b mod prime l, N uint32 words (the port stores
// them as int32; residues are < 2**27 so the bits are the same). The TPU's
// transpose to (L, B, S, 128) and its per-stage pre-broadcast twiddle tables
// are Mosaic layout workarounds and are not carried over: twiddles are read
// from the [L, N] plain-domain psi / psi_shoup tables at index m + j.
//
// Design (first version: simple and exact, not yet fast). One thread block
// per (polynomial, prime) row. The row is staged in shared memory (16 KB at
// N = 4096), the N/2 butterflies of each stage are spread over the block's
// threads with __syncthreads() between stages, and the finished row is
// written once. K3 keeps all four polynomials (u, e0, e1, m) in 4*N words of
// dynamic shared memory and runs their four transforms in one stage loop, so
// a stage costs one barrier for four butterflies; c0 and c1 are written once.
// K4 forms d = c0 + c1*s while loading, then runs the inverse stages.
//
// Bounds on the H100 (see PERF.md for the measured times): each kernel reads
// every input word once and writes every output word once, so the byte
// bound is (inputs + outputs) * 4 B / 3.35 TB/s, e.g. 6 * 330 rows * 16 KB
// for K3 at [110, 3, 4096]; the operation count is (N/2) * log2 N butterflies
// per transform of about 12 32-bit integer instructions each. At these
// shapes the bytes set the bound. This version is far from it: a block
// spends log2 N barriers per row, shared-memory butterflies at stride
// t < 32 conflict, and a 4-byte load per thread does not fill the memory
// pipe. Several rows per block, register-resident radix-4 stages and 16-byte
// accesses are the later work that closes the gap.
//
// Arithmetic: Shoup products q = __umulhi(a, w_shoup), r = a*w - q*p (mod
// 2**32), one conditional subtract; Montgomery products for key polynomials
// (a native 32x32->64 multiply plus REDC with -p^-1 mod 2**32). Every output
// is a canonical residue, so the kernels match the plain int64 PyTorch
// versions and the JAX package's XLA path bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMinLogN = 10;   // N = 1024
constexpr int kMaxLogN = 13;   // N = 8192

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

// Forward Cooley-Tukey stages on K rows of n words each, held back to back in
// shared memory. Stage s: m = 2**s blocks of half-width t = n >> (s+1);
// butterfly k pairs lo = j*2t + i with hi = lo + t under twiddle psi[m + j].
// Callers sync before; every stage ends with a barrier.
template <int K>
__device__ __forceinline__ void fwd_stages(uint32_t* x, int logn, const uint32_t* psi,
                                           const uint32_t* psi_sh, uint32_t p) {
  const int n = 1 << logn;
  const int half = n >> 1;
  for (int s = 0; s < logn; ++s) {
    const int log_t = logn - 1 - s;
    const int m = 1 << s;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int j = k >> log_t;
      const int lo = (j << (log_t + 1)) + (k & ((1 << log_t) - 1));
      const int hi = lo + (1 << log_t);
      const uint32_t w = psi[m + j];
      const uint32_t ws = psi_sh[m + j];
#pragma unroll
      for (int r = 0; r < K; ++r) {
        uint32_t* y = x + r * n;
        const uint32_t v = shoup_mul(y[hi], w, ws, p);
        const uint32_t a = y[lo];
        y[lo] = add_mod(a, v, p);
        y[hi] = sub_mod(a, v, p);
      }
    }
    __syncthreads();
  }
}

// Gentleman-Sande inverse stages (without the final N^-1): s from logn-1 down
// to 0, h = 2**s, t = n / 2h; lo' = lo + hi, hi' = (lo - hi) * psi_inv[h + j].
__device__ __forceinline__ void inv_stages(uint32_t* x, int logn, const uint32_t* psi_inv,
                                           const uint32_t* psi_inv_sh, uint32_t p) {
  const int half = (1 << logn) >> 1;
  for (int s = logn - 1; s >= 0; --s) {
    const int log_t = logn - 1 - s;
    const int h = 1 << s;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int j = k >> log_t;
      const int lo = (j << (log_t + 1)) + (k & ((1 << log_t) - 1));
      const int hi = lo + (1 << log_t);
      const uint32_t a = x[lo];
      const uint32_t b = x[hi];
      x[lo] = add_mod(a, b, p);
      x[hi] = shoup_mul(sub_mod(a, b, p), psi_inv[h + j], psi_inv_sh[h + j], p);
    }
    __syncthreads();
  }
}

// K1. Replaces ntt_forward_pallas (hefl_tpu/ckks/pallas_ntt.py, _fwd_kernel /
// _fwd_stages). Bound at [55, 3, 4096]: bytes (row in, row out, twiddle
// tables), 5.5 MB over 3.35 TB/s. One block per row, so the row's reads and
// writes are each done once and every stage stays in shared memory.
__global__ void __launch_bounds__(kThreads)
ntt_forward_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ psi, const uint32_t* __restrict__ psi_sh,
                   const uint32_t* __restrict__ primes, int num_l, int logn) {
  extern __shared__ uint32_t sm[];
  const int n = 1 << logn;
  const size_t row = blockIdx.x;
  const int l = static_cast<int>(row % num_l);
  const uint32_t p = primes[l];
  const uint32_t* src = in + row * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) sm[k] = src[k];
  __syncthreads();
  fwd_stages<1>(sm, logn, psi + static_cast<size_t>(l) * n,
                psi_sh + static_cast<size_t>(l) * n, p);
  uint32_t* dst = out + row * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = sm[k];
}

// K2. Replaces ntt_inverse_pallas (pallas_ntt.py, _inv_kernel / _inv_stages).
// Bound as K1 (bytes). The N^-1 Shoup multiply is folded into the store, so
// the row still goes through device memory once each way.
__global__ void __launch_bounds__(kThreads)
ntt_inverse_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ psi_inv,
                   const uint32_t* __restrict__ psi_inv_sh,
                   const uint32_t* __restrict__ primes, const uint32_t* __restrict__ n_inv,
                   const uint32_t* __restrict__ n_inv_sh, int num_l, int logn) {
  extern __shared__ uint32_t sm[];
  const int n = 1 << logn;
  const size_t row = blockIdx.x;
  const int l = static_cast<int>(row % num_l);
  const uint32_t p = primes[l];
  const uint32_t* src = in + row * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) sm[k] = src[k];
  __syncthreads();
  inv_stages(sm, logn, psi_inv + static_cast<size_t>(l) * n,
             psi_inv_sh + static_cast<size_t>(l) * n, p);
  const uint32_t w = n_inv[l], ws = n_inv_sh[l];
  uint32_t* dst = out + row * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = shoup_mul(sm[k], w, ws, p);
}

// K3. Replaces encrypt_fused_pallas (pallas_ntt.py, _enc_kernel).
// c0 = b*u + e0 + m, c1 = a*u + e1 (all evaluation domain; b, a Montgomery).
// Bound at [110, 3, 4096]: bytes, 6 words per coefficient (4 in, 2 out),
// 32.6 MB over 3.35 TB/s. The four transformed polynomials never leave shared
// memory: only c0 and c1 are written.
__global__ void __launch_bounds__(kThreads)
encrypt_fused_kernel(const uint32_t* __restrict__ m_res, const uint32_t* __restrict__ u,
                     const uint32_t* __restrict__ e0, const uint32_t* __restrict__ e1,
                     const uint32_t* __restrict__ b_mont,
                     const uint32_t* __restrict__ a_mont, uint32_t* __restrict__ c0,
                     uint32_t* __restrict__ c1, const uint32_t* __restrict__ psi,
                     const uint32_t* __restrict__ psi_sh,
                     const uint32_t* __restrict__ primes,
                     const uint32_t* __restrict__ pinv_neg, int num_l, int logn) {
  extern __shared__ uint32_t sm[];  // [u | e0 | e1 | m], n words each
  const int n = 1 << logn;
  const size_t row = blockIdx.x;
  const int l = static_cast<int>(row % num_l);
  const uint32_t p = primes[l];
  const uint32_t pinv = pinv_neg[l];
  const size_t off = row * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    sm[k] = u[off + k];
    sm[n + k] = e0[off + k];
    sm[2 * n + k] = e1[off + k];
    sm[3 * n + k] = m_res[off + k];
  }
  __syncthreads();
  fwd_stages<4>(sm, logn, psi + static_cast<size_t>(l) * n,
                psi_sh + static_cast<size_t>(l) * n, p);
  const uint32_t* bk = b_mont + static_cast<size_t>(l) * n;
  const uint32_t* ak = a_mont + static_cast<size_t>(l) * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const uint32_t uk = sm[k];
    c0[off + k] = add_mod(add_mod(mont_mul(uk, bk[k], p, pinv), sm[n + k], p),
                          sm[3 * n + k], p);
    c1[off + k] = add_mod(mont_mul(uk, ak[k], p, pinv), sm[2 * n + k], p);
  }
}

// K4. Replaces decrypt_fused_pallas (pallas_ntt.py, _dec_kernel).
// out = iNTT(c0 + c1*s) * N^-1 (s Montgomery), coefficient domain.
// Bound at [55, 3, 4096]: bytes, 3 words per coefficient (2 in, 1 out), 8.3 MB
// over 3.35 TB/s. d = c0 + c1*s is formed while loading, so it is never
// written to device memory.
__global__ void __launch_bounds__(kThreads)
decrypt_fused_kernel(const uint32_t* __restrict__ c0, const uint32_t* __restrict__ c1,
                     const uint32_t* __restrict__ s_mont, uint32_t* __restrict__ out,
                     const uint32_t* __restrict__ psi_inv,
                     const uint32_t* __restrict__ psi_inv_sh,
                     const uint32_t* __restrict__ primes,
                     const uint32_t* __restrict__ pinv_neg,
                     const uint32_t* __restrict__ n_inv,
                     const uint32_t* __restrict__ n_inv_sh, int num_l, int logn) {
  extern __shared__ uint32_t sm[];
  const int n = 1 << logn;
  const size_t row = blockIdx.x;
  const int l = static_cast<int>(row % num_l);
  const uint32_t p = primes[l];
  const uint32_t pinv = pinv_neg[l];
  const size_t off = row * n;
  const uint32_t* sk = s_mont + static_cast<size_t>(l) * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    sm[k] = add_mod(c0[off + k], mont_mul(c1[off + k], sk[k], p, pinv), p);
  __syncthreads();
  inv_stages(sm, logn, psi_inv + static_cast<size_t>(l) * n,
             psi_inv_sh + static_cast<size_t>(l) * n, p);
  const uint32_t w = n_inv[l], ws = n_inv_sh[l];
  for (int k = threadIdx.x; k < n; k += blockDim.x) out[off + k] = shoup_mul(sm[k], w, ws, p);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int rows, int num_l, int logn, int words_per_row,
                    size_t* smem) {
  if (rows <= 0 || num_l <= 0 || logn < kMinLogN || logn > kMaxLogN) return cudaErrorInvalidValue;
  *smem = static_cast<size_t>(words_per_row) * (static_cast<size_t>(1) << logn) * sizeof(uint32_t);
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Each launcher takes device pointers, the row count rows = B*L, the prime
// count L, log2 N and the CUDA stream; it launches on that stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).

int ntt_forward(const void* in, void* out, const void* psi, const void* psi_sh,
                const void* primes, int rows, int num_l, int logn, void* stream) {
  size_t smem = 0;
  cudaError_t err = prepare(ntt_forward_kernel, rows, num_l, logn, 1, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_forward_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(psi), static_cast<const uint32_t*>(psi_sh),
      static_cast<const uint32_t*>(primes), num_l, logn);
  return static_cast<int>(cudaGetLastError());
}

int ntt_inverse(const void* in, void* out, const void* psi_inv, const void* psi_inv_sh,
                const void* primes, const void* n_inv, const void* n_inv_sh, int rows,
                int num_l, int logn, void* stream) {
  size_t smem = 0;
  cudaError_t err = prepare(ntt_inverse_kernel, rows, num_l, logn, 1, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_inverse_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(psi_inv), static_cast<const uint32_t*>(psi_inv_sh),
      static_cast<const uint32_t*>(primes), static_cast<const uint32_t*>(n_inv),
      static_cast<const uint32_t*>(n_inv_sh), num_l, logn);
  return static_cast<int>(cudaGetLastError());
}

int encrypt_fused(const void* m_res, const void* u, const void* e0, const void* e1,
                  const void* b_mont, const void* a_mont, void* c0, void* c1,
                  const void* psi, const void* psi_sh, const void* primes,
                  const void* pinv_neg, int rows, int num_l, int logn, void* stream) {
  size_t smem = 0;
  cudaError_t err = prepare(encrypt_fused_kernel, rows, num_l, logn, 4, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  encrypt_fused_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(m_res), static_cast<const uint32_t*>(u),
      static_cast<const uint32_t*>(e0), static_cast<const uint32_t*>(e1),
      static_cast<const uint32_t*>(b_mont), static_cast<const uint32_t*>(a_mont),
      static_cast<uint32_t*>(c0), static_cast<uint32_t*>(c1),
      static_cast<const uint32_t*>(psi), static_cast<const uint32_t*>(psi_sh),
      static_cast<const uint32_t*>(primes), static_cast<const uint32_t*>(pinv_neg), num_l,
      logn);
  return static_cast<int>(cudaGetLastError());
}

int decrypt_fused(const void* c0, const void* c1, const void* s_mont, void* out,
                  const void* psi_inv, const void* psi_inv_sh, const void* primes,
                  const void* pinv_neg, const void* n_inv, const void* n_inv_sh, int rows,
                  int num_l, int logn, void* stream) {
  size_t smem = 0;
  cudaError_t err = prepare(decrypt_fused_kernel, rows, num_l, logn, 1, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decrypt_fused_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(c0), static_cast<const uint32_t*>(c1),
      static_cast<const uint32_t*>(s_mont), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(psi_inv), static_cast<const uint32_t*>(psi_inv_sh),
      static_cast<const uint32_t*>(primes), static_cast<const uint32_t*>(pinv_neg),
      static_cast<const uint32_t*>(n_inv), static_cast<const uint32_t*>(n_inv_sh), num_l,
      logn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
