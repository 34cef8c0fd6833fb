// Kernel B2: natural-order NTT of every row of a (16, rows, S) limb array,
// S = 2^log_s <= 1024, then row r times mult[:, r % mult_rows] (optional)
// and times a scalar (optional).  Replaces the Pallas kernel
// `_colntt_kernel_call` of tinyram_tpu/poly/pallas_ntt.py; see
// poly/cuda_ntt.py for the four-step composition and the note on what
// bounds it.
//
// One block per row: the row is loaded into shared memory in bit-reversed
// order, the log_s radix-2 Cooley-Tukey stages run in place with a
// __syncthreads() after each, and the natural-order result is written back.
// tw holds w_S^k, k < S/2, as a (16, S/2) limb table (w_S^-1 for the
// inverse transform).
#include "field.cuh"

namespace {

template <int F>
__global__ void ntt_rows_kernel(const uint32_t* __restrict__ x,
                                uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ tw,
                                const uint32_t* __restrict__ mult,
                                int64_t mult_rows,
                                const uint32_t* __restrict__ scale,
                                int64_t rows, int log_s) {
  extern __shared__ tr::Fe sm[];
  const int S = 1 << log_s;
  const int half = S >> 1;
  const int64_t r = blockIdx.x;
  const int64_t stride = rows * (int64_t)S;  // limb stride of x and out
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int rev = (int)(__brev((unsigned)s) >> (32 - log_s));
    sm[rev] = tr::load_fe(x, stride, r * S + s);
  }
  __syncthreads();
  for (int st = 0; st < log_s; ++st) {
    const int m = 1 << st;  // butterfly half-size at this stage
    for (int t = threadIdx.x; t < half; t += blockDim.x) {
      const int j = t & (m - 1);
      const int i0 = ((t >> st) << (st + 1)) + j;
      const int i1 = i0 + m;
      // w_{2m}^j = w_S^(j * S / 2m)
      const tr::Fe w = tr::load_fe(tw, half, (int64_t)j << (log_s - 1 - st));
      const tr::Fe u = sm[i0];
      const tr::Fe v = tr::mont_mul<F>(sm[i1], w);
      sm[i0] = tr::add_mod<F>(u, v);
      sm[i1] = tr::sub_mod<F>(u, v);
    }
    __syncthreads();
  }
  const int64_t mrow = mult ? (r % mult_rows) * S : 0;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    tr::Fe v = sm[s];
    if (mult) v = tr::mont_mul<F>(v, tr::load_fe(mult, mult_rows * S, mrow + s));
    if (scale) v = tr::mont_mul<F>(v, tr::load_fe(scale, 1, 0));
    tr::store_fe(out, stride, r * S + s, v);
  }
}

}  // namespace

extern "C" int tr_ntt(const void* x, void* out, const void* tw,
                      const void* mult, int64_t mult_rows, const void* scale,
                      int64_t rows, int log_s, int field, void* stream) {
  if (log_s < 1 || log_s > 10 || rows < 1) return (int)cudaErrorInvalidValue;
  const int S = 1 << log_s;
  int threads = S / 2;
  if (threads > 256) threads = 256;
  if (threads < 32) threads = 32;
  const size_t smem = (size_t)S * sizeof(tr::Fe);  // <= 32 KB
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto X = static_cast<const uint32_t*>(x);
  auto O = static_cast<uint32_t*>(out);
  auto T = static_cast<const uint32_t*>(tw);
  auto M = static_cast<const uint32_t*>(mult);
  auto C = static_cast<const uint32_t*>(scale);
  if (field == 0) {
    ntt_rows_kernel<0><<<(unsigned)rows, threads, smem, s>>>(
        X, O, T, M, mult_rows, C, rows, log_s);
  } else {
    ntt_rows_kernel<1><<<(unsigned)rows, threads, smem, s>>>(
        X, O, T, M, mult_rows, C, rows, log_s);
  }
  return (int)cudaGetLastError();
}
