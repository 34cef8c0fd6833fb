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

}  // namespace tr
