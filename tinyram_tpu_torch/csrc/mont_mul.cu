// Kernel B1: elementwise Montgomery product out = a*b/2^256 mod p over
// (16, n) limb arrays.  Replaces the Pallas kernel `_mul_pallas` of
// tinyram_tpu/field/pallas_mul.py; see field/cuda_mul.py for the note on
// what bounds it on the H100.  One thread per element.
#include "field.cuh"

namespace {

template <int F>
__global__ void mont_mul_kernel(const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const tr::Fe x = tr::load_fe(a, n, j);
  const tr::Fe y = tr::load_fe(b, n, j);
  tr::store_fe(out, n, j, tr::mont_mul<F>(x, y));
}

}  // namespace

extern "C" int tr_mont_mul(const void* a, const void* b, void* out, int64_t n,
                           int field, void* stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto A = static_cast<const uint32_t*>(a);
  auto B = static_cast<const uint32_t*>(b);
  auto O = static_cast<uint32_t*>(out);
  if (field == 0) {
    mont_mul_kernel<0><<<(unsigned)blocks, threads, 0, s>>>(A, B, O, n);
  } else {
    mont_mul_kernel<1><<<(unsigned)blocks, threads, 0, s>>>(A, B, O, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
