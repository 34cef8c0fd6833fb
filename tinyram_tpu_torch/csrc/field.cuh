// Pasta-field arithmetic for the port's CUDA kernels (sm_90a).
//
// A field element is 8 little-endian 32-bit words in Montgomery form with
// R = 2^256, canonical in [0, p).  F = 0 selects Fp (the Pallas base field,
// the circuit field), F = 1 selects Fq (the Vesta base field, the curve's
// coordinate field).  Both primes are 2^254 + c with c < 2^128 and
// p = 1 mod 2^32, so -p^-1 mod 2^32 = 0xFFFFFFFF and words 4-6 are zero.
//
// Global-memory layout is the reference's (16, n) array of 16-bit limbs held
// in 32-bit integers: limb i of element j at i*stride + j.  Loads and stores
// pack two limbs into one word.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tr {

struct Fe {
  uint32_t w[8];
};

template <int F>
__device__ __forceinline__ uint32_t mod_word(int i) {
  if constexpr (F == 0) {
    constexpr uint32_t P[8] = {0x00000001u, 0x992D30EDu, 0x094CF91Bu,
                               0x224698FCu, 0x00000000u, 0x00000000u,
                               0x00000000u, 0x40000000u};
    return P[i];
  } else {
    constexpr uint32_t P[8] = {0x00000001u, 0x8C46EB21u, 0x0994A8DDu,
                               0x224698FCu, 0x00000000u, 0x00000000u,
                               0x00000000u, 0x40000000u};
    return P[i];
  }
}

// R mod p: one in Montgomery form.
template <int F>
__device__ __forceinline__ Fe mont_one() {
  Fe r;
  if constexpr (F == 0) {
    constexpr uint32_t W[8] = {0xFFFFFFFDu, 0x34786D38u, 0xE41914ADu,
                               0x992C350Bu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                               0xFFFFFFFFu, 0x3FFFFFFFu};
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = W[i];
  } else {
    constexpr uint32_t W[8] = {0xFFFFFFFDu, 0x5B2B3E9Cu, 0xE3420567u,
                               0x992C350Bu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                               0xFFFFFFFFu, 0x3FFFFFFFu};
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = W[i];
  }
  return r;
}

constexpr uint32_t kN0 = 0xFFFFFFFFu;  // -p^-1 mod 2^32 for both primes

__device__ __forceinline__ Fe load_fe(const uint32_t* base, int64_t stride,
                                      int64_t j) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t lo = base[(2 * k) * stride + j];
    uint32_t hi = base[(2 * k + 1) * stride + j];
    r.w[k] = (lo & 0xFFFFu) | (hi << 16);
  }
  return r;
}

__device__ __forceinline__ void store_fe(uint32_t* base, int64_t stride,
                                         int64_t j, const Fe& v) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    base[(2 * k) * stride + j] = v.w[k] & 0xFFFFu;
    base[(2 * k + 1) * stride + j] = v.w[k] >> 16;
  }
}

// t - p if t >= p, else t (t < 2p).
template <int F>
__device__ __forceinline__ Fe cond_sub_p(const Fe& t) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t v = (uint64_t)t.w[i] - mod_word<F>(i) - borrow;
    d.w[i] = (uint32_t)v;
    borrow = (v >> 63) & 1;  // wrapped below zero
  }
  return borrow ? t : d;
}

template <int F>
__device__ __forceinline__ Fe add_mod(const Fe& a, const Fe& b) {
  Fe s;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t v = (uint64_t)a.w[i] + b.w[i] + carry;
    s.w[i] = (uint32_t)v;
    carry = v >> 32;
  }
  return cond_sub_p<F>(s);  // a + b < 2p < 2^256: no carry out
}

template <int F>
__device__ __forceinline__ Fe sub_mod(const Fe& a, const Fe& b) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t v = (uint64_t)a.w[i] - b.w[i] - borrow;
    d.w[i] = (uint32_t)v;
    borrow = (v >> 63) & 1;
  }
  if (borrow) {
    uint64_t carry = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint64_t v = (uint64_t)d.w[i] + mod_word<F>(i) + carry;
      d.w[i] = (uint32_t)v;
      carry = v >> 32;
    }
  }
  return d;
}

// CIOS Montgomery product a*b/2^256 mod p, 32-bit words, 64-bit accumulators.
template <int F>
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t v = (uint64_t)a.w[i] * b.w[j] + t[j] + c;
      t[j] = (uint32_t)v;
      c = v >> 32;
    }
    uint64_t v = (uint64_t)t[8] + c;
    t[8] = (uint32_t)v;
    t[9] = (uint32_t)(v >> 32);
    const uint32_t m = t[0] * kN0;
    c = ((uint64_t)m * mod_word<F>(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      uint64_t u = (uint64_t)m * mod_word<F>(j) + t[j] + c;
      t[j - 1] = (uint32_t)u;
      c = u >> 32;
    }
    v = (uint64_t)t[8] + c;
    t[7] = (uint32_t)v;
    t[8] = t[9] + (uint32_t)(v >> 32);
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = t[i];
  return cond_sub_p<F>(r);  // result < 2p, so t[8] == 0
}

// ---------------------------------------------------------------------------
// Carry-chain arithmetic: the same functions as above (equal outputs, all
// canonical), written in PTX with the hardware carry flag (add.cc/addc.cc,
// sub.cc/subc.cc, mad.lo.cc/madc.hi.cc) instead of 64-bit sums, and with
// p's zero words 4-6 taken as zeros.  The flag does not survive from one
// asm statement to the next, so each chain is one asm block.

template <int F>
struct Mod {  // p's nonzero words; word 0 is 1, words 4-6 are 0
  static constexpr uint32_t w1 = F == 0 ? 0x992D30EDu : 0x8C46EB21u;
  static constexpr uint32_t w2 = F == 0 ? 0x094CF91Bu : 0x0994A8DDu;
  static constexpr uint32_t w3 = 0x224698FCu;
  static constexpr uint32_t w7 = 0x40000000u;
};

// t < 2p -> t mod p: d = t - p; keep t where that borrows.
template <int F>
__device__ __forceinline__ Fe cond_sub_p_cc(const Fe& t) {
  using P = Mod<F>;
  Fe d;
  uint32_t borrow;
  asm volatile(
      "sub.cc.u32  %0, %9, 1;\n\t"
      "subc.cc.u32 %1, %10, %17;\n\t"
      "subc.cc.u32 %2, %11, %18;\n\t"
      "subc.cc.u32 %3, %12, %19;\n\t"
      "subc.cc.u32 %4, %13, 0;\n\t"
      "subc.cc.u32 %5, %14, 0;\n\t"
      "subc.cc.u32 %6, %15, 0;\n\t"
      "subc.cc.u32 %7, %16, %20;\n\t"
      "subc.u32    %8, 0, 0;"
      : "=r"(d.w[0]), "=r"(d.w[1]), "=r"(d.w[2]), "=r"(d.w[3]),
        "=r"(d.w[4]), "=r"(d.w[5]), "=r"(d.w[6]), "=r"(d.w[7]),
        "=r"(borrow)
      : "r"(t.w[0]), "r"(t.w[1]), "r"(t.w[2]), "r"(t.w[3]), "r"(t.w[4]),
        "r"(t.w[5]), "r"(t.w[6]), "r"(t.w[7]), "n"(P::w1), "n"(P::w2),
        "n"(P::w3), "n"(P::w7));
  Fe r;  // borrow is all ones where t < p
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = (t.w[i] & borrow) | (d.w[i] & ~borrow);
  return r;
}

template <int F>
__device__ __forceinline__ Fe add_mod_cc(const Fe& a, const Fe& b) {
  Fe s;
  asm volatile(
      "add.cc.u32  %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32    %7, %15, %23;"  // a + b < 2p < 2^256: no carry out
      : "=r"(s.w[0]), "=r"(s.w[1]), "=r"(s.w[2]), "=r"(s.w[3]),
        "=r"(s.w[4]), "=r"(s.w[5]), "=r"(s.w[6]), "=r"(s.w[7])
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
        "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]),
        "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
        "r"(b.w[7]));
  return cond_sub_p_cc<F>(s);
}

template <int F>
__device__ __forceinline__ Fe sub_mod_cc(const Fe& a, const Fe& b) {
  using P = Mod<F>;
  Fe d;
  uint32_t borrow;
  asm volatile(
      "sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, 0, 0;"
      : "=r"(d.w[0]), "=r"(d.w[1]), "=r"(d.w[2]), "=r"(d.w[3]),
        "=r"(d.w[4]), "=r"(d.w[5]), "=r"(d.w[6]), "=r"(d.w[7]),
        "=r"(borrow)
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
        "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]),
        "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
        "r"(b.w[7]));
  // a < b: add p back (borrow is all ones, so p & borrow is p)
  asm volatile(
      "add.cc.u32  %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.u32    %7, %7, %12;"
      : "+r"(d.w[0]), "+r"(d.w[1]), "+r"(d.w[2]), "+r"(d.w[3]),
        "+r"(d.w[4]), "+r"(d.w[5]), "+r"(d.w[6]), "+r"(d.w[7])
      : "r"(borrow & 1u), "r"(borrow & P::w1), "r"(borrow & P::w2),
        "r"(borrow & P::w3), "r"(borrow & P::w7));
  return d;
}

// CIOS a*b/2^256 mod p over 32-bit words.  Each outer step adds a_i*b as a
// chain of low halves and a chain of high halves, then m*p (m = -t0, since
// -p^-1 = -1 mod 2^32) the same way, skipping p's zero words; the low word
// is then zero and the shift is a renaming.  t stays < 2^288 (p < 2^255),
// so nine words hold it and the last high chain has no carry out.
template <int F>
__device__ __forceinline__ Fe mont_mul_cc(const Fe& a, const Fe& b) {
  using P = Mod<F>;
  uint32_t t[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t ai = a.w[i];
    asm volatile(
        "mad.lo.cc.u32  %0, %9, %10, %0;\n\t"
        "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
        "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
        "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
        "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"
        "addc.u32       %8, 0, 0;\n\t"  // t8 is 0 at the start of a step
        "mad.hi.cc.u32  %1, %9, %10, %1;\n\t"
        "madc.hi.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
        "madc.hi.cc.u32 %4, %9, %13, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %14, %5;\n\t"
        "madc.hi.cc.u32 %6, %9, %15, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %16, %7;\n\t"
        "madc.hi.u32    %8, %9, %17, %8;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
        : "r"(ai), "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]),
          "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]));
    const uint32_t m = 0u - t[0];  // t0 * (-p^-1); m*p0 + t0 = 0 mod 2^32
    asm volatile(
        "add.cc.u32     %0, %0, %9;\n\t"  // p0 = 1
        "madc.lo.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.lo.cc.u32 %3, %9, %12, %3;\n\t"
        "addc.cc.u32    %4, %4, 0;\n\t"
        "addc.cc.u32    %5, %5, 0;\n\t"
        "addc.cc.u32    %6, %6, 0;\n\t"
        "madc.lo.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32       %8, %8, 0;\n\t"
        "mad.hi.cc.u32  %2, %9, %10, %2;\n\t"  // hi(m * p0) = 0
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.hi.cc.u32 %4, %9, %12, %4;\n\t"
        "addc.cc.u32    %5, %5, 0;\n\t"
        "addc.cc.u32    %6, %6, 0;\n\t"
        "addc.cc.u32    %7, %7, 0;\n\t"
        "madc.hi.u32    %8, %9, %13, %8;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
        : "r"(m), "n"(P::w1), "n"(P::w2), "n"(P::w3), "n"(P::w7));
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = t[j + 1];  // t0 is 0: divide by 2^32
    t[8] = 0;
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = t[i];
  return cond_sub_p_cc<F>(r);
}

}  // namespace tr
