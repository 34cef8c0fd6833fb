// Kernels B3-B6: complete Vesta point operations over Fq (a = 0, 3b = 15),
// one lane per thread, coordinates in registers as 8-word field elements.
// Replace the Pallas kernels of tinyram_tpu/curve/pallas_point.py; the
// formulas are RCB16 Algorithms 7, 8 and 9 step for step as in
// tinyram_tpu/curve/vesta.py.  See curve/cuda_point.py for the note on
// what bounds them.
#include "field.cuh"

namespace {

using tr::Fe;
constexpr int Q = 1;  // Fq

__device__ __forceinline__ Fe M(const Fe& a, const Fe& b) {
  return tr::mont_mul<Q>(a, b);
}
__device__ __forceinline__ Fe A(const Fe& a, const Fe& b) {
  return tr::add_mod<Q>(a, b);
}
__device__ __forceinline__ Fe S(const Fe& a, const Fe& b) {
  return tr::sub_mod<Q>(a, b);
}

// t * 15 (b = 5, 3b = 15) as 16t - t
__device__ __forceinline__ Fe mul_by_3b(const Fe& t) {
  const Fe t2 = A(t, t);
  const Fe t4 = A(t2, t2);
  const Fe t8 = A(t4, t4);
  const Fe t16 = A(t8, t8);
  return S(t16, t);
}

// RCB16 Algorithm 7: complete projective addition.
__device__ __forceinline__ void add_body(const Fe& X1, const Fe& Y1,
                                         const Fe& Z1, const Fe& X2,
                                         const Fe& Y2, const Fe& Z2, Fe& X3,
                                         Fe& Y3, Fe& Z3) {
  Fe t0 = M(X1, X2);
  Fe t1 = M(Y1, Y2);
  Fe t2 = M(Z1, Z2);
  Fe t3 = A(X1, Y1);
  Fe t4 = A(X2, Y2);
  t3 = M(t3, t4);
  t4 = A(t0, t1);
  t3 = S(t3, t4);
  t4 = A(Y1, Z1);
  X3 = A(Y2, Z2);
  t4 = M(t4, X3);
  X3 = A(t1, t2);
  t4 = S(t4, X3);
  X3 = A(X1, Z1);
  Y3 = A(X2, Z2);
  X3 = M(X3, Y3);
  Y3 = A(t0, t2);
  Y3 = S(X3, Y3);
  X3 = A(t0, t0);
  t0 = A(X3, t0);
  t2 = mul_by_3b(t2);
  Z3 = A(t1, t2);
  t1 = S(t1, t2);
  Y3 = mul_by_3b(Y3);
  X3 = M(t4, Y3);
  t2 = M(t3, t1);
  X3 = S(t2, X3);
  Y3 = M(Y3, t0);
  t1 = M(t1, Z3);
  Y3 = A(t1, Y3);
  t0 = M(t0, t3);
  Z3 = M(Z3, t4);
  Z3 = A(Z3, t0);
}

// RCB16 Algorithm 8: P1 projective + (X2, Y2, 1); P2 must be finite.
__device__ __forceinline__ void madd_body(const Fe& X1, const Fe& Y1,
                                          const Fe& Z1, const Fe& X2,
                                          const Fe& Y2, Fe& X3, Fe& Y3,
                                          Fe& Z3) {
  Fe t0 = M(X1, X2);
  Fe t1 = M(Y1, Y2);
  Fe t3 = A(X2, Y2);
  Fe t4 = A(X1, Y1);
  t3 = M(t3, t4);
  t4 = A(t0, t1);
  t3 = S(t3, t4);
  t4 = M(Y2, Z1);
  t4 = A(t4, Y1);
  Y3 = M(X2, Z1);
  Y3 = A(Y3, X1);
  X3 = A(t0, t0);
  t0 = A(X3, t0);
  Fe t2 = mul_by_3b(Z1);
  Z3 = A(t1, t2);
  t1 = S(t1, t2);
  Y3 = mul_by_3b(Y3);
  X3 = M(t4, Y3);
  t2 = M(t3, t1);
  X3 = S(t2, X3);
  Y3 = M(Y3, t0);
  t1 = M(t1, Z3);
  Y3 = A(t1, Y3);
  t0 = M(t0, t3);
  Z3 = M(Z3, t4);
  Z3 = A(Z3, t0);
}

// RCB16 Algorithm 9: exception-free doubling.
__device__ __forceinline__ void dbl_body(const Fe& X, const Fe& Y, const Fe& Z,
                                         Fe& X3, Fe& Y3, Fe& Z3) {
  Fe t0 = M(Y, Y);
  Z3 = A(t0, t0);
  Z3 = A(Z3, Z3);
  Z3 = A(Z3, Z3);
  Fe t1 = M(Y, Z);
  Fe t2 = M(Z, Z);
  t2 = mul_by_3b(t2);
  X3 = M(t2, Z3);
  Y3 = A(t0, t2);
  Z3 = M(t1, Z3);
  t1 = A(t2, t2);
  t2 = A(t1, t2);
  t0 = S(t0, t2);
  Y3 = M(t0, Y3);
  Y3 = A(X3, Y3);
  t1 = M(X, Y);
  X3 = M(t0, t1);
  X3 = A(X3, X3);
}

__global__ void madd_select_kernel(const uint8_t* __restrict__ mask,
                                   const uint32_t* __restrict__ ax,
                                   const uint32_t* __restrict__ ay,
                                   const uint32_t* __restrict__ az,
                                   const uint32_t* __restrict__ qx,
                                   const uint32_t* __restrict__ qy,
                                   uint32_t* __restrict__ ox,
                                   uint32_t* __restrict__ oy,
                                   uint32_t* __restrict__ oz, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const Fe x2 = tr::load_fe(qx, n, j);
  const Fe y2 = tr::load_fe(qy, n, j);
  if (mask[j]) {
    Fe x3, y3, z3;
    madd_body(tr::load_fe(ax, n, j), tr::load_fe(ay, n, j),
              tr::load_fe(az, n, j), x2, y2, x3, y3, z3);
    tr::store_fe(ox, n, j, x3);
    tr::store_fe(oy, n, j, y3);
    tr::store_fe(oz, n, j, z3);
  } else {
    tr::store_fe(ox, n, j, x2);
    tr::store_fe(oy, n, j, y2);
    tr::store_fe(oz, n, j, tr::mont_one<Q>());
  }
}

__global__ void padd_kernel(const uint32_t* __restrict__ px,
                            const uint32_t* __restrict__ py,
                            const uint32_t* __restrict__ pz,
                            const uint32_t* __restrict__ qx,
                            const uint32_t* __restrict__ qy,
                            const uint32_t* __restrict__ qz,
                            uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                            uint32_t* __restrict__ oz, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Fe x3, y3, z3;
  add_body(tr::load_fe(px, n, j), tr::load_fe(py, n, j), tr::load_fe(pz, n, j),
           tr::load_fe(qx, n, j), tr::load_fe(qy, n, j), tr::load_fe(qz, n, j),
           x3, y3, z3);
  tr::store_fe(ox, n, j, x3);
  tr::store_fe(oy, n, j, y3);
  tr::store_fe(oz, n, j, z3);
}

__global__ void padd_select_kernel(const uint8_t* __restrict__ mask,
                                   const uint32_t* __restrict__ px,
                                   const uint32_t* __restrict__ py,
                                   const uint32_t* __restrict__ pz,
                                   const uint32_t* __restrict__ qx,
                                   const uint32_t* __restrict__ qy,
                                   const uint32_t* __restrict__ qz,
                                   uint32_t* __restrict__ ox,
                                   uint32_t* __restrict__ oy,
                                   uint32_t* __restrict__ oz, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const Fe x2 = tr::load_fe(qx, n, j);
  const Fe y2 = tr::load_fe(qy, n, j);
  const Fe z2 = tr::load_fe(qz, n, j);
  if (mask[j]) {
    Fe x3, y3, z3;
    add_body(tr::load_fe(px, n, j), tr::load_fe(py, n, j),
             tr::load_fe(pz, n, j), x2, y2, z2, x3, y3, z3);
    tr::store_fe(ox, n, j, x3);
    tr::store_fe(oy, n, j, y3);
    tr::store_fe(oz, n, j, z3);
  } else {
    tr::store_fe(ox, n, j, x2);
    tr::store_fe(oy, n, j, y2);
    tr::store_fe(oz, n, j, z2);
  }
}

__global__ void pdouble_kernel(const uint32_t* __restrict__ px,
                               const uint32_t* __restrict__ py,
                               const uint32_t* __restrict__ pz,
                               uint32_t* __restrict__ ox,
                               uint32_t* __restrict__ oy,
                               uint32_t* __restrict__ oz, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Fe x3, y3, z3;
  dbl_body(tr::load_fe(px, n, j), tr::load_fe(py, n, j), tr::load_fe(pz, n, j),
           x3, y3, z3);
  tr::store_fe(ox, n, j, x3);
  tr::store_fe(oy, n, j, y3);
  tr::store_fe(oz, n, j, z3);
}

constexpr int kThreads = 128;

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

using U = uint32_t;

extern "C" int tr_madd_select(const void* mask, const void* ax, const void* ay,
                              const void* az, const void* qx, const void* qy,
                              void* ox, void* oy, void* oz, int64_t n,
                              void* stream) {
  madd_select_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const U*>(ax),
      static_cast<const U*>(ay), static_cast<const U*>(az),
      static_cast<const U*>(qx), static_cast<const U*>(qy),
      static_cast<U*>(ox), static_cast<U*>(oy), static_cast<U*>(oz), n);
  return (int)cudaGetLastError();
}

extern "C" int tr_padd(const void* px, const void* py, const void* pz,
                       const void* qx, const void* qy, const void* qz,
                       void* ox, void* oy, void* oz, int64_t n, void* stream) {
  padd_kernel<<<blocks_for(n), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const U*>(px), static_cast<const U*>(py),
      static_cast<const U*>(pz), static_cast<const U*>(qx),
      static_cast<const U*>(qy), static_cast<const U*>(qz),
      static_cast<U*>(ox), static_cast<U*>(oy), static_cast<U*>(oz), n);
  return (int)cudaGetLastError();
}

extern "C" int tr_padd_select(const void* mask, const void* px, const void* py,
                              const void* pz, const void* qx, const void* qy,
                              const void* qz, void* ox, void* oy, void* oz,
                              int64_t n, void* stream) {
  padd_select_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const U*>(px),
      static_cast<const U*>(py), static_cast<const U*>(pz),
      static_cast<const U*>(qx), static_cast<const U*>(qy),
      static_cast<const U*>(qz), static_cast<U*>(ox), static_cast<U*>(oy),
      static_cast<U*>(oz), n);
  return (int)cudaGetLastError();
}

extern "C" int tr_pdouble(const void* px, const void* py, const void* pz,
                          void* ox, void* oy, void* oz, int64_t n,
                          void* stream) {
  pdouble_kernel<<<blocks_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const U*>(px), static_cast<const U*>(py),
      static_cast<const U*>(pz), static_cast<U*>(ox), static_cast<U*>(oy),
      static_cast<U*>(oz), n);
  return (int)cudaGetLastError();
}
