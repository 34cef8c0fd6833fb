// Kernels B3-B6: complete Vesta point operations over Fq (a = 0, 3b = 15),
// coordinates as 8-word field elements.  Replace the Pallas kernels of
// tinyram_tpu/curve/pallas_point.py; the formulas are RCB16 Algorithms 7, 8
// and 9 as in tinyram_tpu/curve/vesta.py, so every output is the plain
// version's, limb for limb.  See curve/cuda_point.py for what bounds them
// and what the design does about it.
//
// Every kernel runs the carry-chain field functions of field.cuh (*_cc),
// cuts the formulas into stages of independent products, and runs its
// sequential loop, where it has one, inside the kernel with the point in
// registers: the bucket scan (B3s), the double-and-add ladder (B5l), the
// weighted reduce's suffix scan (B4s), the doubling chains (B6 with a
// count) and the window combine (B6h).
#include "field.cuh"

namespace {

using tr::Fe;
using U = uint32_t;
constexpr int Q = 1;  // Fq

struct Chain {  // the carry-chain field functions over Fq
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
using C = Chain;

// t * 15 (b = 5, 3b = 15) as 16t - t
__device__ __forceinline__ Fe mul_by_3b(const Fe& t) {
  const Fe t2 = C::A(t, t);
  const Fe t4 = C::A(t2, t2);
  const Fe t8 = C::A(t4, t4);
  const Fe t16 = C::A(t8, t8);
  return C::S(t16, t);
}

// ------------------------------------------------------------ the stages
//
// The formulas as stages of independent products (Alg. 7: 6 then 6; Alg.
// 8: 5 then 6; Alg. 9: 4 then 4), the additions between them unchanged.
// `products<K>(st, a, b, out)` runs one stage, out[k] = a[k] * b[k], in one
// of two ways:
// - Slots, one thread per lane: the operand pairs go to the lane's
//   shared-memory slots and the products run in a loop that is not
//   unrolled, so the code holds one product per stage instead of one per
//   product: the ladder, a doubling and an add per step, fell from 11,472
//   SASS instructions fully unrolled to 3,680, and on an H100 from 8.5 to
//   4.9 ms at config-2 shapes.  Two or three products per iteration were
//   slower.  The shape for kernels with many lanes, where the card is
//   bound by its integer pipes.
// - Group<G>, G neighbouring threads of a warp per lane: thread r of the
//   group computes products r, r + G, ... of the stage, and every product
//   reaches every thread of the group by warp shuffles, so each thread
//   keeps the whole point and repeats the additions.  A stage of K
//   products then waits on ceil(K / G) dependent products instead of K:
//   the shape for the window combine, whose few lanes leave the card
//   waiting on each thread's chain of dependent products.

constexpr int kBlock = 64;  // threads per block of every point kernel
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

template <int K>
__device__ __forceinline__ void products(const Slots& s, const Fe (&a)[K],
                                         const Fe (&b)[K], Fe (&out)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    s.put(2 * k, a[k]);
    s.put(2 * k + 1, b[k]);
  }
#pragma unroll 1
  for (int k = 0; k < K; ++k) s.put(2 * k, C::M(s.get(2 * k), s.get(2 * k + 1)));
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = s.get(2 * k);
}

// Every thread of a warp takes part in the shuffles, so a kernel over
// groups runs no branch that depends on the lane.
template <int G>
struct Group {
  static_assert(G > 1 && 32 % G == 0, "a group is a power of two in a warp");
  int r;  // this thread's rank in its group
};

template <int K, int G>
__device__ __forceinline__ void products(const Group<G>& g, const Fe (&a)[K],
                                         const Fe (&b)[K], Fe (&out)[K]) {
#pragma unroll
  for (int i = 0; i < K; i += G) {
    // this thread's product of the round: i + r (ranks past the last
    // product of a short round repeat product i)
    Fe x = a[i], y = b[i];
#pragma unroll
    for (int k = i + 1; k < K && k < i + G; ++k) {
      if (g.r == k - i) {
        x = a[k];
        y = b[k];
      }
    }
    const Fe m = C::M(x, y);
#pragma unroll
    for (int k = i; k < K && k < i + G; ++k) {
#pragma unroll
      for (int w = 0; w < 8; ++w)
        out[k].w[w] = __shfl_sync(0xFFFFFFFFu, m.w[w], k - i, G);
    }
  }
}

// ----------------------------------------------------------- the formulas

// The common second stage of Algorithms 7 and 8.
template <class St>
__device__ __forceinline__ void rcb_tail(const St& s, const Fe& t0,
                                         const Fe& t1, const Fe& t3,
                                         const Fe& t4, const Fe& Z3a,
                                         const Fe& Y3a, Fe& X3, Fe& Y3,
                                         Fe& Z3) {
  Fe m[6];  // X3 = t4 Y3, t2 = t3 t1, Y3 = Y3 t0, t1 = t1 Z3, t0 = t0 t3, Z3 = Z3 t4
  products<6>(s, {t4, t3, Y3a, t1, t0, Z3a}, {Y3a, t1, t0, Z3a, t3, t4}, m);
  X3 = C::S(m[1], m[0]);
  Y3 = C::A(m[3], m[2]);
  Z3 = C::A(m[5], m[4]);
}

// RCB16 Algorithm 7.
template <class St>
__device__ __forceinline__ void add_lane(const St& s, const Fe& X1,
                                         const Fe& Y1, const Fe& Z1,
                                         const Fe& X2, const Fe& Y2,
                                         const Fe& Z2, Fe& X3, Fe& Y3,
                                         Fe& Z3) {
  Fe m[6];
  products<6>(s, {X1, Y1, Z1, C::A(X1, Y1), C::A(Y1, Z1), C::A(X1, Z1)},
              {X2, Y2, Z2, C::A(X2, Y2), C::A(Y2, Z2), C::A(X2, Z2)}, m);
  const Fe t3 = C::S(m[3], C::A(m[0], m[1]));
  const Fe t4 = C::S(m[4], C::A(m[1], m[2]));
  const Fe y3 = C::S(m[5], C::A(m[0], m[2]));
  const Fe t0 = C::A(C::A(m[0], m[0]), m[0]);
  const Fe t2 = mul_by_3b(m[2]);
  rcb_tail(s, t0, C::S(m[1], t2), t3, t4, C::A(m[1], t2), mul_by_3b(y3),
           X3, Y3, Z3);
}

// RCB16 Algorithm 8: P1 projective + (X2, Y2, 1); P2 must be finite.
__device__ __forceinline__ void madd_lane(const Slots& s, const Fe& X1,
                                          const Fe& Y1, const Fe& Z1,
                                          const Fe& X2, const Fe& Y2, Fe& X3,
                                          Fe& Y3, Fe& Z3) {
  Fe m[5];
  products<5>(s, {X1, Y1, C::A(X2, Y2), Y2, X2},
              {X2, Y2, C::A(X1, Y1), Z1, Z1}, m);
  const Fe t3 = C::S(m[2], C::A(m[0], m[1]));
  const Fe t4 = C::A(m[3], Y1);
  const Fe y3 = C::A(m[4], X1);
  const Fe t0 = C::A(C::A(m[0], m[0]), m[0]);
  const Fe t2 = mul_by_3b(Z1);
  rcb_tail(s, t0, C::S(m[1], t2), t3, t4, C::A(m[1], t2), mul_by_3b(y3),
           X3, Y3, Z3);
}

// RCB16 Algorithm 9.
template <class St>
__device__ __forceinline__ void dbl_lane(const St& s, const Fe& X,
                                         const Fe& Y, const Fe& Z, Fe& X3,
                                         Fe& Y3, Fe& Z3) {
  Fe m[4];  // Y Y, Y Z, Z Z, X Y
  products<4>(s, {Y, Y, Z, X}, {Y, Z, Z, Y}, m);
  Fe z3 = C::A(m[0], m[0]);
  z3 = C::A(z3, z3);
  z3 = C::A(z3, z3);
  const Fe t2 = mul_by_3b(m[2]);
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
__global__ void __launch_bounds__(kBlock)
padd_kernel(const U* __restrict__ px, const U* __restrict__ py,
            const U* __restrict__ pz, const U* __restrict__ qx,
            const U* __restrict__ qy, const U* __restrict__ qz,
            U* __restrict__ ox, U* __restrict__ oy, U* __restrict__ oz,
            int64_t n) {
  __shared__ uint4 slots[kSlots][2][kBlock];
  const int l = threadIdx.x;
  const int64_t j = (int64_t)blockIdx.x * kBlock + l;
  if (j >= n) return;
  Fe x3, y3, z3;
  add_lane(Slots{slots, l}, tr::load_fe(px, n, j), tr::load_fe(py, n, j),
           tr::load_fe(pz, n, j), tr::load_fe(qx, n, j),
           tr::load_fe(qy, n, j), tr::load_fe(qz, n, j), x3, y3, z3);
  tr::store_fe(ox, n, j, x3);
  tr::store_fe(oy, n, j, y3);
  tr::store_fe(oz, n, j, z3);
}

// B4s's layout pass: one coordinate of the buckets, (16, A, H, S) with
// limb stride sl, stride sa between the A blocks of H lanes and each lane's
// S steps contiguous, to step-major (S, 16, A*H), through 32 x 32 tiles in
// shared memory so that a warp's reads and its writes are both contiguous.
// Grid: x = (limb, block, tile of H), y = tile of S.
constexpr int kTile = 32;
constexpr int kTileRows = 8;  // threads per tile column

__global__ void __launch_bounds__(kTile * kTileRows)
step_major_kernel(const U* __restrict__ b, U* __restrict__ out, int64_t A,
                  int64_t H, int64_t S, int64_t sl, int64_t sa) {
  __shared__ U tile[kTile][kTile + 1];
  const int64_t tiles_h = (H + kTile - 1) / kTile;
  const int64_t ia = blockIdx.x / tiles_h;  // limb * A + block
  const int64_t i = ia / A, a = ia % A;
  const int64_t h0 = (blockIdx.x % tiles_h) * kTile;
  const int64_t s0 = (int64_t)blockIdx.y * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int r = ty; r < kTile; r += kTileRows) {
    const int64_t h = h0 + r, s = s0 + tx;
    if (h < H && s < S) tile[r][tx] = b[i * sl + a * sa + h * S + s];
  }
  __syncthreads();
  const int64_t n = A * H;
#pragma unroll
  for (int r = ty; r < kTile; r += kTileRows) {
    const int64_t s = s0 + r, h = h0 + tx;
    if (h < H && s < S) out[(s * 16 + i) * n + a * H + h] = tile[tx][r];
  }
}

// B4's scan form B4s (the weighted reduce's suffix scan): acc = tot =
// identity; for k = S-1 .. 0: acc = acc + b[k] (Alg. 7), then, for k >= 1,
// tot = acc + tot (Alg. 7, acc first as in padd_select).  b* hold the steps
// first, (S, 16, n), so a warp's loads of one step are contiguous.
__global__ void __launch_bounds__(kBlock)
suffix_scan_kernel(const U* __restrict__ bx, const U* __restrict__ by,
                   const U* __restrict__ bz, U* __restrict__ ax,
                   U* __restrict__ ay, U* __restrict__ az,
                   U* __restrict__ tx, U* __restrict__ ty,
                   U* __restrict__ tz, int64_t S, int64_t n) {
  __shared__ uint4 slots[kSlots][2][kBlock];
  const int l = threadIdx.x;
  const int64_t j = (int64_t)blockIdx.x * kBlock + l;
  if (j >= n) return;
  const Slots s{slots, l};
  Fe AX{}, AY = tr::mont_one<Q>(), AZ{};
  Fe TX{}, TY = tr::mont_one<Q>(), TZ{};
  const int64_t step = 16 * n;
#pragma unroll 1
  for (int64_t k = S - 1; k >= 0; --k) {
    Fe x3, y3, z3;
    add_lane(s, AX, AY, AZ, tr::load_fe(bx + k * step, n, j),
             tr::load_fe(by + k * step, n, j),
             tr::load_fe(bz + k * step, n, j), x3, y3, z3);
    AX = x3;
    AY = y3;
    AZ = z3;
    if (k >= 1) {
      add_lane(s, AX, AY, AZ, TX, TY, TZ, x3, y3, z3);
      TX = x3;
      TY = y3;
      TZ = z3;
    }
  }
  tr::store_fe(ax, n, j, AX);
  tr::store_fe(ay, n, j, AY);
  tr::store_fe(az, n, j, AZ);
  tr::store_fe(tx, n, j, TX);
  tr::store_fe(ty, n, j, TY);
  tr::store_fe(tz, n, j, TZ);
}

// B6 with a count: `times` doublings (Alg. 9) of p, in registers.
__global__ void __launch_bounds__(kBlock)
pdouble_kernel(const U* __restrict__ px, const U* __restrict__ py,
               const U* __restrict__ pz, U* __restrict__ ox,
               U* __restrict__ oy, U* __restrict__ oz, int64_t times,
               int64_t n) {
  __shared__ uint4 slots[kSlots][2][kBlock];
  const int l = threadIdx.x;
  const int64_t j = (int64_t)blockIdx.x * kBlock + l;
  if (j >= n) return;
  const Slots s{slots, l};
  Fe X = tr::load_fe(px, n, j);
  Fe Y = tr::load_fe(py, n, j);
  Fe Z = tr::load_fe(pz, n, j);
#pragma unroll 1
  for (int64_t r = 0; r < times; ++r) {
    Fe x3, y3, z3;
    dbl_lane(s, X, Y, Z, x3, y3, z3);
    X = x3;
    Y = y3;
    Z = z3;
  }
  tr::store_fe(ox, n, j, X);
  tr::store_fe(oy, n, j, Y);
  tr::store_fe(oz, n, j, Z);
}

// One lane of B6h: acc = identity; for w = nw-1 .. 0: acc = 2^c acc (c
// times Alg. 9), then acc = acc + S_w (Alg. 7).  s* hold S as (16, nw, n).
template <class St>
__device__ __forceinline__ void horner_lane(
    const St& st, const U* __restrict__ sx, const U* __restrict__ sy,
    const U* __restrict__ sz, int64_t c, int64_t nw, int64_t n, int64_t j,
    Fe& X, Fe& Y, Fe& Z) {
  X = Fe{};
  Y = tr::mont_one<Q>();
  Z = Fe{};
  const int64_t limb = nw * n;  // from one limb of S to the next
#pragma unroll 1
  for (int64_t w = nw - 1; w >= 0; --w) {
    Fe x3, y3, z3;
#pragma unroll 1
    for (int64_t d = 0; d < c; ++d) {
      dbl_lane(st, X, Y, Z, x3, y3, z3);
      X = x3;
      Y = y3;
      Z = z3;
    }
    add_lane(st, X, Y, Z, tr::load_fe(sx + w * n, limb, j),
             tr::load_fe(sy + w * n, limb, j),
             tr::load_fe(sz + w * n, limb, j), x3, y3, z3);
    X = x3;
    Y = y3;
    Z = z3;
  }
}

// B6's Horner form B6h (the window combine), one lane per G threads: G = 1
// stages its products through the lane's slots, G > 1 through a group.
template <int G>
__global__ void __launch_bounds__(kBlock)
horner_kernel(const U* __restrict__ sx, const U* __restrict__ sy,
              const U* __restrict__ sz, U* __restrict__ ox,
              U* __restrict__ oy, U* __restrict__ oz, int64_t c, int64_t nw,
              int64_t n) {
  const int64_t j = ((int64_t)blockIdx.x * kBlock + threadIdx.x) / G;
  Fe X, Y, Z;
  if constexpr (G == 1) {
    __shared__ uint4 slots[kSlots][2][kBlock];
    if (j >= n) return;
    horner_lane(Slots{slots, (int)threadIdx.x}, sx, sy, sz, c, nw, n, j, X,
                Y, Z);
  } else {
    // the ragged edge's spare threads run the last lane again (they take
    // part in the shuffles) and store nothing
    horner_lane(Group<G>{(int)(threadIdx.x % G)}, sx, sy, sz, c, nw, n,
                j < n ? j : n - 1, X, Y, Z);
    if (j >= n || threadIdx.x % G != 0) return;
  }
  tr::store_fe(ox, n, j, X);
  tr::store_fe(oy, n, j, Y);
  tr::store_fe(oz, n, j, Z);
}

unsigned blocks(int64_t threads) {
  return (unsigned)((threads + kBlock - 1) / kBlock);
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
  madd_scan_kernel<<<blocks(n), kBlock, 0, as_stream(stream)>>>(
      static_cast<const uint8_t*>(same), in(ax), in(ay), in(az), in(qx),
      in(qy), out(ox), out(oy), out(oz), L, n);
  return (int)cudaGetLastError();
}

extern "C" int tr_padd_select(const void* mask, const void* px, const void* py,
                              const void* pz, const void* qx, const void* qy,
                              const void* qz, void* ox, void* oy, void* oz,
                              int64_t n, void* stream) {
  padd_select_kernel<<<blocks(n), kBlock, 0, as_stream(stream)>>>(
      static_cast<const uint8_t*>(mask), in(px), in(py), in(pz), in(qx),
      in(qy), in(qz), out(ox), out(oy), out(oz), n);
  return (int)cudaGetLastError();
}

extern "C" int tr_padd_select_ladder(const void* bits, const void* px,
                                     const void* py, const void* pz, void* ox,
                                     void* oy, void* oz, int64_t R, int64_t n,
                                     void* stream) {
  ladder_kernel<<<blocks(n), kBlock, 0, as_stream(stream)>>>(
      static_cast<const uint8_t*>(bits), in(px), in(py), in(pz), out(ox),
      out(oy), out(oz), R, n);
  return (int)cudaGetLastError();
}

extern "C" int tr_padd(const void* px, const void* py, const void* pz,
                       const void* qx, const void* qy, const void* qz,
                       void* ox, void* oy, void* oz, int64_t n, void* stream) {
  padd_kernel<<<blocks(n), kBlock, 0, as_stream(stream)>>>(
      in(px), in(py), in(pz), in(qx), in(qy), in(qz), out(ox), out(oy),
      out(oz), n);
  return (int)cudaGetLastError();
}

// b*: (16, n / H, H, S) at limb stride sl and block stride sa, each lane's
// steps contiguous; scratch: 3 * S * 16 * n words for their step-major copy.
extern "C" int tr_padd_suffix_scan(const void* bx, const void* by,
                                   const void* bz, void* scratch, void* ax,
                                   void* ay, void* az, void* tx, void* ty,
                                   void* tz, int64_t S, int64_t H, int64_t sl,
                                   int64_t sa, int64_t n, void* stream) {
  const int64_t A = n / H;
  const dim3 grid((unsigned)(16 * A * ((H + kTile - 1) / kTile)),
                  (unsigned)((S + kTile - 1) / kTile));
  const dim3 block(kTile, kTileRows);
  U* steps[3];
  const void* src[3] = {bx, by, bz};
  for (int k = 0; k < 3; ++k) {
    steps[k] = out(scratch) + k * S * 16 * n;
    if (S == 0) continue;  // no steps: both sums stay the identity
    step_major_kernel<<<grid, block, 0, as_stream(stream)>>>(
        in(src[k]), steps[k], A, H, S, sl, sa);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  suffix_scan_kernel<<<blocks(n), kBlock, 0, as_stream(stream)>>>(
      steps[0], steps[1], steps[2], out(ax), out(ay), out(az), out(tx),
      out(ty), out(tz), S, n);
  return (int)cudaGetLastError();
}

extern "C" int tr_pdouble(const void* px, const void* py, const void* pz,
                          void* ox, void* oy, void* oz, int64_t times,
                          int64_t n, void* stream) {
  pdouble_kernel<<<blocks(n), kBlock, 0, as_stream(stream)>>>(
      in(px), in(py), in(pz), out(ox), out(oy), out(oz), times, n);
  return (int)cudaGetLastError();
}

extern "C" int tr_pdouble_horner(const void* sx, const void* sy,
                                 const void* sz, void* ox, void* oy, void* oz,
                                 int64_t c, int64_t nw, int group, int64_t n,
                                 void* stream) {
  if (group == 1) {
    horner_kernel<1><<<blocks(n), kBlock, 0, as_stream(stream)>>>(
        in(sx), in(sy), in(sz), out(ox), out(oy), out(oz), c, nw, n);
  } else if (group == 4) {
    horner_kernel<4><<<blocks(4 * n), kBlock, 0, as_stream(stream)>>>(
        in(sx), in(sy), in(sz), out(ox), out(oy), out(oz), c, nw, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
