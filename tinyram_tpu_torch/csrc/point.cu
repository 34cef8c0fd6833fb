// Kernels B3-B6: complete Vesta point operations over Fq (a = 0, 3b = 15),
// coordinates as 8-word field elements.  Replace the Pallas kernels of
// tinyram_tpu/curve/pallas_point.py; the formulas are RCB16 Algorithms 7, 8
// and 9 as in tinyram_tpu/curve/vesta.py, so every output is the plain
// version's, limb for limb.  See curve/cuda_point.py for what bounds them
// and what the design does about it.
//
// B4 (padd) and B6 (pdouble): one lane per thread, the formulas step for
// step with the 64-bit-sum field functions of field.cuh.  B3 and B5 in
// every form (the one-step selects, the bucket scan, the double-and-add
// ladder) run one lane per thread with the carry-chain field functions, cut
// the formulas into stages of independent products, and run their
// sequential loop inside the kernel.
#include "field.cuh"

namespace {

using tr::Fe;
using U = uint32_t;
constexpr int Q = 1;  // Fq

// ------------------------------------------------------ arithmetic policies

struct Cios64 {  // B4, B6
  static __device__ __forceinline__ Fe M(const Fe& a, const Fe& b) {
    return tr::mont_mul<Q>(a, b);
  }
  static __device__ __forceinline__ Fe A(const Fe& a, const Fe& b) {
    return tr::add_mod<Q>(a, b);
  }
  static __device__ __forceinline__ Fe S(const Fe& a, const Fe& b) {
    return tr::sub_mod<Q>(a, b);
  }
};

struct Chain {  // B3, B5
  static __device__ __forceinline__ Fe M(const Fe& a, const Fe& b) {
    return tr::mont_mul_cc<Q>(a, b);
  }
  static __device__ __forceinline__ Fe A(const Fe& a, const Fe& b) {
    return tr::add_mod_cc<Q>(a, b);
  }
  static __device__ __forceinline__ Fe S(const Fe& a, const Fe& b) {
    return tr::sub_mod_cc<Q>(a, b);
  }
};

// t * 15 (b = 5, 3b = 15) as 16t - t
template <class Ar>
__device__ __forceinline__ Fe mul_by_3b(const Fe& t) {
  const Fe t2 = Ar::A(t, t);
  const Fe t4 = Ar::A(t2, t2);
  const Fe t8 = Ar::A(t4, t4);
  const Fe t16 = Ar::A(t8, t8);
  return Ar::S(t16, t);
}

// ------------------------------------------- B4, B6: the formulas in order

// RCB16 Algorithm 7: complete projective addition.
template <class Ar>
__device__ __forceinline__ void add_body(const Fe& X1, const Fe& Y1,
                                         const Fe& Z1, const Fe& X2,
                                         const Fe& Y2, const Fe& Z2, Fe& X3,
                                         Fe& Y3, Fe& Z3) {
  Fe t0 = Ar::M(X1, X2);
  Fe t1 = Ar::M(Y1, Y2);
  Fe t2 = Ar::M(Z1, Z2);
  Fe t3 = Ar::A(X1, Y1);
  Fe t4 = Ar::A(X2, Y2);
  t3 = Ar::M(t3, t4);
  t4 = Ar::A(t0, t1);
  t3 = Ar::S(t3, t4);
  t4 = Ar::A(Y1, Z1);
  X3 = Ar::A(Y2, Z2);
  t4 = Ar::M(t4, X3);
  X3 = Ar::A(t1, t2);
  t4 = Ar::S(t4, X3);
  X3 = Ar::A(X1, Z1);
  Y3 = Ar::A(X2, Z2);
  X3 = Ar::M(X3, Y3);
  Y3 = Ar::A(t0, t2);
  Y3 = Ar::S(X3, Y3);
  X3 = Ar::A(t0, t0);
  t0 = Ar::A(X3, t0);
  t2 = mul_by_3b<Ar>(t2);
  Z3 = Ar::A(t1, t2);
  t1 = Ar::S(t1, t2);
  Y3 = mul_by_3b<Ar>(Y3);
  X3 = Ar::M(t4, Y3);
  t2 = Ar::M(t3, t1);
  X3 = Ar::S(t2, X3);
  Y3 = Ar::M(Y3, t0);
  t1 = Ar::M(t1, Z3);
  Y3 = Ar::A(t1, Y3);
  t0 = Ar::M(t0, t3);
  Z3 = Ar::M(Z3, t4);
  Z3 = Ar::A(Z3, t0);
}

// RCB16 Algorithm 9: exception-free doubling.
template <class Ar>
__device__ __forceinline__ void dbl_body(const Fe& X, const Fe& Y, const Fe& Z,
                                         Fe& X3, Fe& Y3, Fe& Z3) {
  Fe t0 = Ar::M(Y, Y);
  Z3 = Ar::A(t0, t0);
  Z3 = Ar::A(Z3, Z3);
  Z3 = Ar::A(Z3, Z3);
  Fe t1 = Ar::M(Y, Z);
  Fe t2 = Ar::M(Z, Z);
  t2 = mul_by_3b<Ar>(t2);
  X3 = Ar::M(t2, Z3);
  Y3 = Ar::A(t0, t2);
  Z3 = Ar::M(t1, Z3);
  t1 = Ar::A(t2, t2);
  t2 = Ar::A(t1, t2);
  t0 = Ar::S(t0, t2);
  Y3 = Ar::M(t0, Y3);
  Y3 = Ar::A(X3, Y3);
  t1 = Ar::M(X, Y);
  X3 = Ar::M(t0, t1);
  X3 = Ar::A(X3, X3);
}

// ------------------------------------------------- B3, B5: staged formulas
//
// The formulas as stages of independent products (Alg. 7: 6 then 6; Alg.
// 8: 5 then 6; Alg. 9: 4 then 4), the additions between them unchanged.
// A stage puts its operand pairs in the lane's shared-memory slots and runs
// its products in a loop that is not unrolled, so the code holds one
// product per stage instead of one per product: the ladder, a doubling and
// an add per step, fell from 11,472 SASS instructions fully unrolled to
// 3,680, and on an H100 from 8.5 to 4.9 ms at config-2 shapes.  Two or
// three products per iteration were slower.

constexpr int kBlock = 64;  // threads (one lane each) per block of B3, B5
constexpr int kSlots = 12;  // operands of the largest stage: 6 pairs

// One lane's slots: slot s of the block's lane l as two uint4 at [s][0..1][l],
// so the 16-byte accesses of a warp are contiguous.
struct Slots {
  uint4 (*v)[2][kBlock];
  int l;

  __device__ void put(int s, const Fe& x) const {
    v[s][0][l] = make_uint4(x.w[0], x.w[1], x.w[2], x.w[3]);
    v[s][1][l] = make_uint4(x.w[4], x.w[5], x.w[6], x.w[7]);
  }
  __device__ Fe get(int s) const {
    const uint4 a = v[s][0][l];
    const uint4 b = v[s][1][l];
    return Fe{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
  }
};

// out[k] = a[k] * b[k] for k < K, one product after another.
template <int K>
__device__ __forceinline__ void products(const Slots& s, const Fe (&a)[K],
                                         const Fe (&b)[K], Fe (&out)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    s.put(2 * k, a[k]);
    s.put(2 * k + 1, b[k]);
  }
#pragma unroll 1
  for (int k = 0; k < K; ++k) s.put(2 * k, Chain::M(s.get(2 * k), s.get(2 * k + 1)));
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = s.get(2 * k);
}

// The common second stage of Algorithms 7 and 8.
__device__ __forceinline__ void rcb_tail(const Slots& s, const Fe& t0,
                                         const Fe& t1, const Fe& t3,
                                         const Fe& t4, const Fe& Z3a,
                                         const Fe& Y3a, Fe& X3, Fe& Y3,
                                         Fe& Z3) {
  using C = Chain;
  Fe m[6];  // X3 = t4 Y3, t2 = t3 t1, Y3 = Y3 t0, t1 = t1 Z3, t0 = t0 t3, Z3 = Z3 t4
  products<6>(s, {t4, t3, Y3a, t1, t0, Z3a}, {Y3a, t1, t0, Z3a, t3, t4}, m);
  X3 = C::S(m[1], m[0]);
  Y3 = C::A(m[3], m[2]);
  Z3 = C::A(m[5], m[4]);
}

// RCB16 Algorithm 7.
__device__ __forceinline__ void add_lane(const Slots& s, const Fe& X1,
                                         const Fe& Y1, const Fe& Z1,
                                         const Fe& X2, const Fe& Y2,
                                         const Fe& Z2, Fe& X3, Fe& Y3,
                                         Fe& Z3) {
  using C = Chain;
  Fe m[6];
  products<6>(s, {X1, Y1, Z1, C::A(X1, Y1), C::A(Y1, Z1), C::A(X1, Z1)},
              {X2, Y2, Z2, C::A(X2, Y2), C::A(Y2, Z2), C::A(X2, Z2)}, m);
  const Fe t3 = C::S(m[3], C::A(m[0], m[1]));
  const Fe t4 = C::S(m[4], C::A(m[1], m[2]));
  const Fe y3 = C::S(m[5], C::A(m[0], m[2]));
  const Fe t0 = C::A(C::A(m[0], m[0]), m[0]);
  const Fe t2 = mul_by_3b<C>(m[2]);
  rcb_tail(s, t0, C::S(m[1], t2), t3, t4, C::A(m[1], t2), mul_by_3b<C>(y3),
           X3, Y3, Z3);
}

// RCB16 Algorithm 8: P1 projective + (X2, Y2, 1); P2 must be finite.
__device__ __forceinline__ void madd_lane(const Slots& s, const Fe& X1,
                                          const Fe& Y1, const Fe& Z1,
                                          const Fe& X2, const Fe& Y2, Fe& X3,
                                          Fe& Y3, Fe& Z3) {
  using C = Chain;
  Fe m[5];
  products<5>(s, {X1, Y1, C::A(X2, Y2), Y2, X2},
              {X2, Y2, C::A(X1, Y1), Z1, Z1}, m);
  const Fe t3 = C::S(m[2], C::A(m[0], m[1]));
  const Fe t4 = C::A(m[3], Y1);
  const Fe y3 = C::A(m[4], X1);
  const Fe t0 = C::A(C::A(m[0], m[0]), m[0]);
  const Fe t2 = mul_by_3b<C>(Z1);
  rcb_tail(s, t0, C::S(m[1], t2), t3, t4, C::A(m[1], t2), mul_by_3b<C>(y3),
           X3, Y3, Z3);
}

// RCB16 Algorithm 9.
__device__ __forceinline__ void dbl_lane(const Slots& s, const Fe& X,
                                         const Fe& Y, const Fe& Z, Fe& X3,
                                         Fe& Y3, Fe& Z3) {
  using C = Chain;
  Fe m[4];  // Y Y, Y Z, Z Z, X Y
  products<4>(s, {Y, Y, Z, X}, {Y, Z, Z, Y}, m);
  Fe z3 = C::A(m[0], m[0]);
  z3 = C::A(z3, z3);
  z3 = C::A(z3, z3);
  const Fe t2 = mul_by_3b<C>(m[2]);
  const Fe y3 = C::A(m[0], t2);
  const Fe t0 = C::S(m[0], C::A(C::A(t2, t2), t2));
  Fe d[4];  // X3 = t2 Z3, Z3 = t1 Z3, Y3 = t0 Y3, X3 = t0 (X Y)
  products<4>(s, {t2, m[1], t0, t0}, {z3, z3, y3, m[3]}, d);
  X3 = C::A(d[3], d[3]);
  Y3 = C::A(d[0], d[2]);
  Z3 = d[1];
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- kernels

// B3 and its scan form B3s: for each step s < L, acc = same[s] ? acc + q_s :
// q_s (q_s = (qx[s], qy[s], 1)), o*[s] = acc.  acc starts at (ax, ay, az),
// or at the identity when az is null.  Step s+1's q is staged into shared
// memory by cp.async (two buffers) while step s computes.
__global__ void __launch_bounds__(kBlock)
madd_scan_kernel(const uint8_t* __restrict__ same, const U* __restrict__ ax,
                 const U* __restrict__ ay, const U* __restrict__ az,
                 const U* __restrict__ qx, const U* __restrict__ qy,
                 U* __restrict__ ox, U* __restrict__ oy, U* __restrict__ oz,
                 int64_t L, int64_t n) {
  __shared__ uint4 slots[kSlots][2][kBlock];
  __shared__ U stage[2][32][kBlock];  // [buffer][limb of qx, qy][lane]
  const int l = threadIdx.x;
  const int64_t j = (int64_t)blockIdx.x * kBlock + l;
  if (j >= n) return;  // nothing below synchronises across threads
  const Slots s{slots, l};
  Fe X, Y, Z;
  if (az != nullptr) {
    X = tr::load_fe(ax, n, j);
    Y = tr::load_fe(ay, n, j);
    Z = tr::load_fe(az, n, j);
  } else {
    X = Fe{};
    Y = tr::mont_one<Q>();
    Z = Fe{};
  }
  const int64_t step = 16 * n;  // one step's coordinate in qx, qy, o*
  auto fetch = [&](int64_t st, int buf) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const U* src = (i < 16 ? qx + i * n : qy + (i - 16) * n) + st * step + j;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_addr(&stage[buf][i][l])),
                   "l"(src));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  fetch(0, 0);
#pragma unroll 1
  for (int64_t st = 0; st < L; ++st) {
    const int buf = (int)(st & 1);
    if (st + 1 < L) {
      fetch(st + 1, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    Fe x2, y2;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      x2.w[k] = (stage[buf][2 * k][l] & 0xFFFFu) | (stage[buf][2 * k + 1][l] << 16);
      y2.w[k] = (stage[buf][16 + 2 * k][l] & 0xFFFFu) |
                (stage[buf][17 + 2 * k][l] << 16);
    }
    if (same[st * n + j]) {
      Fe x3, y3, z3;
      madd_lane(s, X, Y, Z, x2, y2, x3, y3, z3);
      X = x3;
      Y = y3;
      Z = z3;
    } else {
      X = x2;
      Y = y2;
      Z = tr::mont_one<Q>();
    }
    tr::store_fe(ox + st * step, n, j, X);
    tr::store_fe(oy + st * step, n, j, Y);
    tr::store_fe(oz + st * step, n, j, Z);
  }
}

// B5: select(mask, p + q, q).
__global__ void __launch_bounds__(kBlock)
padd_select_kernel(const uint8_t* __restrict__ mask,
                   const U* __restrict__ px, const U* __restrict__ py,
                   const U* __restrict__ pz, const U* __restrict__ qx,
                   const U* __restrict__ qy, const U* __restrict__ qz,
                   U* __restrict__ ox, U* __restrict__ oy,
                   U* __restrict__ oz, int64_t n) {
  __shared__ uint4 slots[kSlots][2][kBlock];
  const int l = threadIdx.x;
  const int64_t j = (int64_t)blockIdx.x * kBlock + l;
  if (j >= n) return;
  Fe X = tr::load_fe(qx, n, j);
  Fe Y = tr::load_fe(qy, n, j);
  Fe Z = tr::load_fe(qz, n, j);
  if (mask[j]) {
    Fe x3, y3, z3;
    add_lane(Slots{slots, l}, tr::load_fe(px, n, j), tr::load_fe(py, n, j),
             tr::load_fe(pz, n, j), X, Y, Z, x3, y3, z3);
    X = x3;
    Y = y3;
    Z = z3;
  }
  tr::store_fe(ox, n, j, X);
  tr::store_fe(oy, n, j, Y);
  tr::store_fe(oz, n, j, Z);
}

// B5's ladder form B5l: acc = identity; for r < R: acc = 2 acc (Alg. 9),
// then acc = bits[r] ? p + acc : acc (Alg. 7, p first as in padd_select).
__global__ void __launch_bounds__(kBlock)
ladder_kernel(const uint8_t* __restrict__ bits, const U* __restrict__ px,
              const U* __restrict__ py, const U* __restrict__ pz,
              U* __restrict__ ox, U* __restrict__ oy, U* __restrict__ oz,
              int64_t R, int64_t n) {
  __shared__ uint4 slots[kSlots][2][kBlock];
  const int l = threadIdx.x;
  const int64_t j = (int64_t)blockIdx.x * kBlock + l;
  if (j >= n) return;
  const Slots s{slots, l};
  const Fe PX = tr::load_fe(px, n, j);
  const Fe PY = tr::load_fe(py, n, j);
  const Fe PZ = tr::load_fe(pz, n, j);
  Fe X{}, Y = tr::mont_one<Q>(), Z{};
#pragma unroll 1
  for (int64_t r = 0; r < R; ++r) {
    const bool bit = bits[r * n + j];
    Fe x2, y2, z2;
    dbl_lane(s, X, Y, Z, x2, y2, z2);
    if (bit) {
      add_lane(s, PX, PY, PZ, x2, y2, z2, X, Y, Z);
    } else {
      X = x2;
      Y = y2;
      Z = z2;
    }
  }
  tr::store_fe(ox, n, j, X);
  tr::store_fe(oy, n, j, Y);
  tr::store_fe(oz, n, j, Z);
}

// B4: p + q.
__global__ void padd_kernel(const U* __restrict__ px, const U* __restrict__ py,
                            const U* __restrict__ pz, const U* __restrict__ qx,
                            const U* __restrict__ qy, const U* __restrict__ qz,
                            U* __restrict__ ox, U* __restrict__ oy,
                            U* __restrict__ oz, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Fe x3, y3, z3;
  add_body<Cios64>(tr::load_fe(px, n, j), tr::load_fe(py, n, j),
                   tr::load_fe(pz, n, j), tr::load_fe(qx, n, j),
                   tr::load_fe(qy, n, j), tr::load_fe(qz, n, j), x3, y3, z3);
  tr::store_fe(ox, n, j, x3);
  tr::store_fe(oy, n, j, y3);
  tr::store_fe(oz, n, j, z3);
}

// B6: 2p.
__global__ void pdouble_kernel(const U* __restrict__ px,
                               const U* __restrict__ py,
                               const U* __restrict__ pz, U* __restrict__ ox,
                               U* __restrict__ oy, U* __restrict__ oz,
                               int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Fe x3, y3, z3;
  dbl_body<Cios64>(tr::load_fe(px, n, j), tr::load_fe(py, n, j),
                   tr::load_fe(pz, n, j), x3, y3, z3);
  tr::store_fe(ox, n, j, x3);
  tr::store_fe(oy, n, j, y3);
  tr::store_fe(oz, n, j, z3);
}

constexpr int kThreads = 128;  // B4, B6

unsigned blocks(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

const U* in(const void* p) { return static_cast<const U*>(p); }
U* out(void* p) { return static_cast<U*>(p); }

}  // namespace

extern "C" int tr_madd_select_scan(const void* same, const void* ax,
                                   const void* ay, const void* az,
                                   const void* qx, const void* qy, void* ox,
                                   void* oy, void* oz, int64_t L, int64_t n,
                                   void* stream) {
  madd_scan_kernel<<<blocks(n, kBlock), kBlock, 0, as_stream(stream)>>>(
      static_cast<const uint8_t*>(same), in(ax), in(ay), in(az), in(qx),
      in(qy), out(ox), out(oy), out(oz), L, n);
  return (int)cudaGetLastError();
}

extern "C" int tr_padd_select(const void* mask, const void* px, const void* py,
                              const void* pz, const void* qx, const void* qy,
                              const void* qz, void* ox, void* oy, void* oz,
                              int64_t n, void* stream) {
  padd_select_kernel<<<blocks(n, kBlock), kBlock, 0, as_stream(stream)>>>(
      static_cast<const uint8_t*>(mask), in(px), in(py), in(pz), in(qx),
      in(qy), in(qz), out(ox), out(oy), out(oz), n);
  return (int)cudaGetLastError();
}

extern "C" int tr_padd_select_ladder(const void* bits, const void* px,
                                     const void* py, const void* pz, void* ox,
                                     void* oy, void* oz, int64_t R, int64_t n,
                                     void* stream) {
  ladder_kernel<<<blocks(n, kBlock), kBlock, 0, as_stream(stream)>>>(
      static_cast<const uint8_t*>(bits), in(px), in(py), in(pz), out(ox),
      out(oy), out(oz), R, n);
  return (int)cudaGetLastError();
}

extern "C" int tr_padd(const void* px, const void* py, const void* pz,
                       const void* qx, const void* qy, const void* qz,
                       void* ox, void* oy, void* oz, int64_t n, void* stream) {
  padd_kernel<<<blocks(n, kThreads), kThreads, 0, as_stream(stream)>>>(
      in(px), in(py), in(pz), in(qx), in(qy), in(qz), out(ox), out(oy),
      out(oz), n);
  return (int)cudaGetLastError();
}

extern "C" int tr_pdouble(const void* px, const void* py, const void* pz,
                          void* ox, void* oy, void* oz, int64_t n,
                          void* stream) {
  pdouble_kernel<<<blocks(n, kThreads), kThreads, 0, as_stream(stream)>>>(
      in(px), in(py), in(pz), out(ox), out(oy), out(oz), n);
  return (int)cudaGetLastError();
}
