// Kernels A1 and A2: the batched-affine MSM bucket scan and the batched
// inverse over Fq (the Vesta base field).  New device code: the JAX package
// computes both in XLA (tinyram_tpu/curve/msm.py: the affine lax.scan of
// _group_bucket_sums_inner, :351-408, and batch_inv, :239); see
// curve/cuda_affine.py for what bounds them on the H100 and what the design
// does about it.
//
// Points are (16, n) arrays of 16-bit limbs in 32-bit words, Montgomery
// form; the scan's inputs and outputs are (L, 16, M), step-major.
#include "field.cuh"

namespace {

using tr::Fe;
using U = uint32_t;
constexpr int Q = 1;  // Fq

__device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) {
  return tr::mont_mul_cc<Q>(a, b);
}
__device__ __forceinline__ Fe add(const Fe& a, const Fe& b) {
  return tr::add_mod_cc<Q>(a, b);
}
__device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) {
  return tr::sub_mod_cc<Q>(a, b);
}
__device__ __forceinline__ Fe zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = 0;
  return r;
}
__device__ __forceinline__ bool eq(const Fe& a, const Fe& b) {
  U d = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) d |= a.w[i] ^ b.w[i];
  return d == 0;
}
__device__ __forceinline__ bool is_zero(const Fe& a) {
  U d = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) d |= a.w[i];
  return d == 0;
}
__device__ __forceinline__ Fe pick(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = c ? a.w[i] : b.w[i];
  return r;
}

// p - 2 for Fq, little-endian words (p's word 0 is 1)
__constant__ U kExp[8] = {0xFFFFFFFFu, 0x8C46EB20u, 0x0994A8DDu, 0x224698FCu,
                          0x00000000u, 0x00000000u, 0x00000000u, 0x40000000u};

// a^(p-2) by square and multiply over the bits of p - 2 from bit 254 down:
// the inverse, and 0 for 0.  255 squarings and 127 products in one chain.
__device__ Fe fermat(const Fe& a) {
  Fe acc = tr::mont_one<Q>();
#pragma unroll 1
  for (int i = 254; i >= 0; --i) {
    acc = mul(acc, acc);
    if ((kExp[i >> 5] >> (i & 31)) & 1u) acc = mul(acc, a);
  }
  return acc;
}

// shared-memory slots of the block's threads, word-major so that a warp's
// accesses of one word fall in 32 banks
__device__ __forceinline__ void put(U* buf, int T, int i, const Fe& v) {
#pragma unroll
  for (int k = 0; k < 8; ++k) buf[k * T + i] = v.w[k];
}
__device__ __forceinline__ Fe get(const U* buf, int T, int i) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = buf[k * T + i];
  return r;
}

// Inclusive product scan of v over the block's T threads (T a power of
// two): from thread 0 up, or, with `down`, from thread T - 1 down.
__device__ Fe scan_product(Fe v, U* buf, int tid, int T, bool down) {
#pragma unroll 1
  for (int off = 1; off < T; off <<= 1) {
    put(buf, T, tid, v);
    __syncthreads();
    const int src = down ? tid + off : tid - off;
    const bool has = down ? src < T : src >= 0;
    Fe o;
    if (has) o = get(buf, T, src);
    __syncthreads();
    if (has) v = mul(v, o);
  }
  return v;
}

// Montgomery's trick over the block: v^-1 for every thread's v from one
// inversion of the block's product, v^-1 = (Π v)^-1 · (product of the
// threads before) · (product of the threads after).  Zero anywhere makes
// every thread's result zero, as the reference's product tree does within
// one of its stop-level nodes.
__device__ Fe block_inverse(const Fe& v, U* buf, int tid, int T) {
  const Fe one = tr::mont_one<Q>();
  const Fe up = scan_product(v, buf, tid, T, false);
  put(buf, T, tid, up);
  __syncthreads();
  const Fe before = tid > 0 ? get(buf, T, tid - 1) : one;
  const Fe total = get(buf, T, T - 1);
  __syncthreads();
  const Fe down = scan_product(v, buf, tid, T, true);
  put(buf, T, tid, down);
  __syncthreads();
  const Fe after = tid + 1 < T ? get(buf, T, tid + 1) : one;
  __syncthreads();
  if (tid == 0) put(buf, T, 0, fermat(total));
  __syncthreads();
  const Fe inv_total = get(buf, T, 0);
  __syncthreads();
  return mul(mul(inv_total, before), after);
}

constexpr int kScanThreads = 256;
constexpr int kLanesPerThread = 2;  // the inverse below pairs them

// A1: L steps of the affine bucket accumulation over M lanes, the
// accumulator (x, y, inf) in registers, two lanes a thread; step s's
// outputs are the accumulator after it.  Per lane and step, as the
// reference's scan body:
//   restart (!same) or identity accumulator -> take q
//   x equal, y equal -> doubling, λ = 3x² / 2y
//   x equal, y differs -> cancel -> the identity, canonical (0, 1)
//   else -> chord, λ = (y_q - y) / (x_q - x)
// with the λ denominators of lanes that add nothing (or that are zero)
// replaced by one before the block's shared inversion.
__global__ void __launch_bounds__(kScanThreads, 2)
    affine_scan_kernel(const uint8_t* __restrict__ same,
                       const U* __restrict__ qx, const U* __restrict__ qy,
                       U* __restrict__ ox, U* __restrict__ oy,
                       uint8_t* __restrict__ oinf, int64_t L, int64_t M) {
  __shared__ U buf[8 * kScanThreads];
  const int tid = threadIdx.x;
  const Fe one = tr::mont_one<Q>();
  int64_t lane[kLanesPerThread];
  Fe ax[kLanesPerThread], ay[kLanesPerThread];
  bool inf[kLanesPerThread];
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) {
    lane[j] = ((int64_t)blockIdx.x * kLanesPerThread + j) * kScanThreads + tid;
    ax[j] = zero();
    ay[j] = zero();
    inf[j] = true;
  }
  for (int64_t s = 0; s < L; ++s) {
    const U* sx = qx + s * 16 * M;
    const U* sy = qy + s * 16 * M;
    bool sm[kLanesPerThread], cancel[kLanesPerThread];
    Fe numer[kLanesPerThread], denom[kLanesPerThread];
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const bool live = lane[j] < M;
      sm[j] = live && same[s * M + lane[j]];
      const Fe cx = live ? tr::load_fe(sx, M, lane[j]) : zero();
      const Fe cy = live ? tr::load_fe(sy, M, lane[j]) : zero();
      const bool x_eq = eq(ax[j], cx), y_eq = eq(ay[j], cy);
      const bool dbl = x_eq && y_eq;
      cancel[j] = x_eq && !y_eq;
      const Fe ax2 = mul(ax[j], ax[j]);
      numer[j] = dbl ? add(add(ax2, ax2), ax2) : sub(cy, ay[j]);
      const Fe d = dbl ? add(ay[j], ay[j]) : sub(cx, ax[j]);
      const bool active = sm[j] && !inf[j] && !cancel[j];
      denom[j] = active && !is_zero(d) ? d : one;
    }
    const Fe inv_both =
        block_inverse(mul(denom[0], denom[1]), buf, tid, kScanThreads);
    const Fe inv[kLanesPerThread] = {mul(inv_both, denom[1]),
                                     mul(inv_both, denom[0])};
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      if (lane[j] >= M) continue;
      const Fe cx = tr::load_fe(sx, M, lane[j]);
      const Fe cy = tr::load_fe(sy, M, lane[j]);
      const Fe lam = mul(numer[j], inv[j]);
      const Fe x3 = sub(sub(mul(lam, lam), ax[j]), cx);
      const Fe y3 = sub(mul(lam, sub(ax[j], x3)), ay[j]);
      const bool takes_q = !sm[j] || inf[j];
      const bool ninf = sm[j] && !inf[j] && cancel[j];
      ax[j] = ninf ? zero() : pick(takes_q, cx, x3);
      ay[j] = ninf ? one : pick(takes_q, cy, y3);
      inf[j] = ninf;
      tr::store_fe(ox + s * 16 * M, M, lane[j], ax[j]);
      tr::store_fe(oy + s * 16 * M, M, lane[j], ay[j]);
      oinf[s * M + lane[j]] = ninf ? 1 : 0;
    }
  }
}

// A2: out = d^-1 lane by lane over groups of T * chunk consecutive lanes,
// one block a group; a lane of a group that holds a zero gets zero.
// Thread t owns `chunk` consecutive lanes: their running products go to
// `out` first, then come back for the backward pass.
__global__ void __launch_bounds__(256)
    batch_inv_kernel(const U* __restrict__ d, U* __restrict__ out, int64_t n,
                     int chunk) {
  extern __shared__ U sbuf[];
  const int tid = threadIdx.x, T = blockDim.x;
  const int64_t first = ((int64_t)blockIdx.x * T + tid) * chunk;
  Fe acc = tr::mont_one<Q>();
  for (int i = 0; i < chunk; ++i) {
    const int64_t j = first + i;
    if (j >= n) break;
    tr::store_fe(out, n, j, acc);
    acc = mul(acc, tr::load_fe(d, n, j));
  }
  Fe inv = block_inverse(acc, sbuf, tid, T);
  for (int i = chunk - 1; i >= 0; --i) {
    const int64_t j = first + i;
    if (j >= n) continue;
    const Fe before = tr::load_fe(out, n, j);
    tr::store_fe(out, n, j, mul(inv, before));
    inv = mul(inv, tr::load_fe(d, n, j));
  }
}

}  // namespace

extern "C" int tr_affine_scan(const void* same, const void* qx, const void* qy,
                              void* ox, void* oy, void* oinf, int64_t L,
                              int64_t M, void* stream) {
  const int64_t per_block = (int64_t)kScanThreads * kLanesPerThread;
  const int64_t blocks = (M + per_block - 1) / per_block;
  affine_scan_kernel<<<(unsigned)blocks, kScanThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(same), static_cast<const U*>(qx),
      static_cast<const U*>(qy), static_cast<U*>(ox), static_cast<U*>(oy),
      static_cast<uint8_t*>(oinf), L, M);
  return (int)cudaGetLastError();
}

// groups of 2^group_log2 lanes: min(group, 256) threads a block
extern "C" int tr_batch_inv(const void* d, void* out, int64_t n,
                            int group_log2, void* stream) {
  if (group_log2 < 0 || group_log2 > 30) return (int)cudaErrorInvalidValue;
  const int64_t group = (int64_t)1 << group_log2;
  const int T = group < 256 ? (int)group : 256;
  const int chunk = (int)(group / T);
  const int64_t blocks = (n + group - 1) / group;
  batch_inv_kernel<<<(unsigned)blocks, T, 8 * T * sizeof(U),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const U*>(d), static_cast<U*>(out), n, chunk);
  return (int)cudaGetLastError();
}
