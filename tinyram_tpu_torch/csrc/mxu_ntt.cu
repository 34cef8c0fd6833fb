// Kernel M1: one radix-R DFT stage (R <= 128) of the digit-matmul NTT on
// the int8 tensor cores.  New device code: the JAX package computes the
// stage in XLA (tinyram_tpu/poly/mxu_ntt.py dft_stage, :152, with
// limbs_to_digits7 and digits_cols_to_mont); see poly/cuda_mxu.py for what
// bounds it on the H100 and what the design does about it.
//
// x and out are (16, R, L) arrays of 16-bit limbs in 32-bit words at the
// element strides (sl, sr, sc) of limbs, rows j (or k) and columns l; the
// output has the input's strides.  w is the DFT table's 7-bit digits,
// (37, R16, RP) int8 with R16 = max(R, 16) rows, RP = max(R, 32) digits per
// row, zero past R.  consts holds 2^256 and 2^512 mod p in Montgomery form
// as (16, 2) limbs.
#include <utility>

#include "field.cuh"

namespace {

constexpr int kDigits = 37;
constexpr int kCols = 2 * kDigits - 1;  // 73 anti-diagonal digit columns
constexpr int kRows = 16;               // output rows of a block: one mma M
constexpr int kPad = 16;                // bytes after each staged row

// c += a * b over a 16 x 32 s8 tile of A (row-major) and a 32 x 8 s8 tile
// of B (column-major), int32 sums.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-bit limb m of a running value, two limbs to a 32-bit word
template <int M>
__device__ __forceinline__ void put_limb(uint32_t (&words)[17], uint32_t v) {
  if constexpr (M % 2 == 0) {
    words[M / 2] = v;
  } else {
    words[M / 2] |= v << 16;
  }
}

// The products of one digit pair (k1, k2) over the ND depth steps: chain
// dd of `acc` takes depth step dd.  wa / xb point at this thread's A row g
// and B column g of digit plane 0, byte 4t; RS is the staged row stride.
template <int ND, int RS>
__device__ __forceinline__ void pair(int (&acc)[ND][4], const int8_t* wa,
                                     const int8_t* xb) {
#pragma unroll
  for (int dd = 0; dd < ND; ++dd) {
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(wa + 32 * dd);
    a[1] = *reinterpret_cast<const uint32_t*>(wa + 32 * dd + 8 * RS);
    a[2] = *reinterpret_cast<const uint32_t*>(wa + 32 * dd + 16);
    a[3] = *reinterpret_cast<const uint32_t*>(wa + 32 * dd + 8 * RS + 16);
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xb + 32 * dd);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xb + 32 * dd + 16);
    mma_s8(acc[dd], a, b0, b1);
  }
}

// Digit column C: the sums over k1 + k2 = C for this thread's four
// elements, carried into their running values.  Before column C the limbs
// below floor(7C / 16) have left; a column moves that by one at most.
template <int ND, int C>
__device__ __forceinline__ void column(const int8_t* wa, const int8_t* xb,
                                       int wplane, int xplane,
                                       uint64_t (&run)[4],
                                       uint32_t (&words)[4][17]) {
  constexpr int RS = 32 * ND + kPad;
  constexpr int lo = C < kDigits ? 0 : C - (kDigits - 1);
  constexpr int hi = C < kDigits ? C : kDigits - 1;
  int acc[2][ND][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int dd = 0; dd < ND; ++dd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][dd][e] = 0;
#pragma unroll 1
  for (int k1 = lo; k1 < hi; k1 += 2) {
    pair<ND, RS>(acc[0], wa + k1 * wplane, xb + (C - k1) * xplane);
    pair<ND, RS>(acc[1], wa + (k1 + 1) * wplane, xb + (C - k1 - 1) * xplane);
  }
  if constexpr ((hi - lo) % 2 == 0) {  // an odd count of pairs: the last
    pair<ND, RS>(acc[0], wa + hi * wplane, xb + (C - hi) * xplane);
  }
  constexpr int m = (7 * C) / 16;
  constexpr int shift = 7 * C - 16 * m;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t col = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) col += (uint32_t)acc[h][dd][e];
    if constexpr (C > 0 && m > (7 * (C - 1)) / 16) {
      put_limb<m - 1>(words[e], (uint32_t)(run[e] & 0xFFFFu));
      run[e] >>= 16;
    }
    run[e] += (uint64_t)col << shift;
  }
}

template <int ND, int... Cs>
__device__ __forceinline__ void all_columns(std::integer_sequence<int, Cs...>,
                                            const int8_t* wa,
                                            const int8_t* xb, int wplane,
                                            int xplane, uint64_t (&run)[4],
                                            uint32_t (&words)[4][17]) {
  (column<ND, Cs>(wa, xb, wplane, xplane, run, words), ...);
}

// value = lo + mid * 2^256 + top * 2^512 -> value mod p, canonical
template <int F>
__device__ __forceinline__ tr::Fe fold(const tr::Fe& lo, const tr::Fe& mid,
                                       const tr::Fe& top, const tr::Fe& c256,
                                       const tr::Fe& c512) {
  const tr::Fe mid_part = tr::mont_mul_cc<F>(mid, c256);
  const tr::Fe top_part = tr::mont_mul_cc<F>(top, c512);
  tr::Fe out = lo;  // < 2^256 < 4p
#pragma unroll
  for (int i = 0; i < 3; ++i) out = tr::cond_sub_p_cc<F>(out);
  return tr::add_mod_cc<F>(tr::add_mod_cc<F>(out, mid_part), top_part);
}

template <int ND>
__global__ void __launch_bounds__(256)
    mxu_dft_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                   const int8_t* __restrict__ w,
                   const uint32_t* __restrict__ consts, int R, int64_t L,
                   int64_t sl, int64_t sr, int64_t sc, int field) {
  constexpr int RP = 32 * ND;     // staged digits per row (depth, padded)
  constexpr int RS = RP + kPad;   // staged row stride in bytes
  extern __shared__ __align__(16) int8_t smem[];
  const int ncols = 8 * (blockDim.x / 32);
  const int wplane = kRows * RS;  // bytes of one digit plane of the table
  const int xplane = ncols * RS;  // ... and of the inputs
  int8_t* ws = smem;                      // [37][16][RS]
  int8_t* xs = smem + kDigits * wplane;   // [37][ncols][RS]
  const int r16 = R < kRows ? kRows : R;
  const int k0 = blockIdx.y * kRows;
  const int64_t l0 = (int64_t)blockIdx.x * ncols;
  const int tid = threadIdx.x;

  // the block's 16 rows of every digit plane of the table, 16 B at a time
  constexpr int kVec = RP / 16;
  for (int i = tid; i < kDigits * kRows * kVec; i += blockDim.x) {
    const int v = i % kVec;
    const int row = (i / kVec) % kRows;
    const int d = i / (kVec * kRows);
    const uint4 val = *reinterpret_cast<const uint4*>(
        w + ((int64_t)d * r16 + k0 + row) * RP + 16 * v);
    *reinterpret_cast<uint4*>(ws + d * wplane + row * RS + 16 * v) = val;
  }
  // the columns' inputs, cut into digits: element (j, l) -> 37 bytes; the
  // thread order follows whichever input stride is 1
  const bool l_fast = sc == 1;
  for (int i = tid; i < RP * ncols; i += blockDim.x) {
    const int j = l_fast ? i / ncols : i % RP;
    const int lc = l_fast ? i % ncols : i / RP;
    const int64_t l = l0 + lc;
    uint32_t wd[8];
    if (j < R && l < L) {
      const uint32_t* p = x + j * sr + l * sc;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        wd[k] = (p[(2 * k) * sl] & 0xFFFFu) | (p[(2 * k + 1) * sl] << 16);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) wd[k] = 0;
    }
    int8_t* dst = xs + lc * RS + j;
#pragma unroll
    for (int d = 0; d < kDigits; ++d) {
      const int bit = 7 * d, wi = bit >> 5, off = bit & 31;
      uint32_t v = wd[wi] >> off;
      if (off > 25 && wi < 7) v |= wd[wi + 1] << (32 - off);
      dst[d * xplane] = (int8_t)(v & 0x7Fu);
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int8_t* wa = ws + g * RS + 4 * t;
  const int8_t* xb = xs + (8 * warp + g) * RS + 4 * t;
  uint64_t run[4] = {0, 0, 0, 0};
  uint32_t words[4][17];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int k = 0; k < 17; ++k) words[e][k] = 0;
  all_columns<ND>(std::make_integer_sequence<int, kCols>{}, wa, xb, wplane,
                  xplane, run, words);
  // limbs 31..33 (the value is below 2^517, so nothing is left after them)
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    put_limb<31>(words[e], (uint32_t)(run[e] & 0xFFFFu));
    put_limb<32>(words[e], (uint32_t)((run[e] >> 16) & 0xFFFFu));
    put_limb<33>(words[e], (uint32_t)((run[e] >> 32) & 0xFFFFu));
  }

  const tr::Fe c256 = tr::load_fe(consts, 2, 0);
  const tr::Fe c512 = tr::load_fe(consts, 2, 1);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    // accumulator e: row g (+8 for e >= 2), column 2t (+1 for odd e)
    const int k = k0 + g + (e >= 2 ? 8 : 0);
    const int64_t l = l0 + 8 * warp + 2 * t + (e & 1);
    if (k >= R || l >= L) continue;
    tr::Fe lo, mid, top;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      lo.w[i] = words[e][i];
      mid.w[i] = words[e][8 + i];
      top.w[i] = 0;
    }
    top.w[0] = words[e][16];
    const tr::Fe r = field == 0 ? fold<0>(lo, mid, top, c256, c512)
                                : fold<1>(lo, mid, top, c256, c512);
    uint32_t* o = out + k * sr + l * sc;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[(2 * i) * sl] = r.w[i] & 0xFFFFu;
      o[(2 * i + 1) * sl] = r.w[i] >> 16;
    }
  }
}

template <int ND>
int launch(const uint32_t* x, uint32_t* out, const int8_t* w,
           const uint32_t* consts, int R, int64_t L, int64_t sl, int64_t sr,
           int64_t sc, int field, cudaStream_t stream) {
  constexpr int RS = 32 * ND + kPad;
  // the warps a block takes and its shared memory, set up once (outside
  // any CUDA graph capture: the first call runs uncaptured)
  static int warps = 0;
  static size_t smem = 0;
  if (warps == 0) {
    int dev = 0, max_smem = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&max_smem,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    int w = (max_smem / (kDigits * RS) - kRows) / 8;
    w = w < 1 ? 1 : (w > 8 ? 8 : w);
    const size_t bytes = (size_t)kDigits * RS * (kRows + 8 * w);
    const cudaError_t err = cudaFuncSetAttribute(
        mxu_dft_kernel<ND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    smem = bytes;
    warps = w;
  }
  const int ncols = 8 * warps;
  const dim3 grid((unsigned)((L + ncols - 1) / ncols),
                  (unsigned)((R < kRows ? kRows : R) / kRows));
  mxu_dft_kernel<ND><<<grid, 32 * warps, smem, stream>>>(
      x, out, w, consts, R, L, sl, sr, sc, field);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tr_mxu_dft(const void* x, void* out, const void* w,
                          const void* consts, int log_r, int64_t L, int64_t sl,
                          int64_t sr, int64_t sc, int field, void* stream) {
  const int R = 1 << log_r;
  auto X = static_cast<const uint32_t*>(x);
  auto O = static_cast<uint32_t*>(out);
  auto W = static_cast<const int8_t*>(w);
  auto K = static_cast<const uint32_t*>(consts);
  auto s = static_cast<cudaStream_t>(stream);
  if (log_r < 1 || log_r > 7) return (int)cudaErrorInvalidValue;
  if (R <= 32) return launch<1>(X, O, W, K, R, L, sl, sr, sc, field, s);
  if (R == 64) return launch<2>(X, O, W, K, R, L, sl, sr, sc, field, s);
  return launch<4>(X, O, W, K, R, L, sl, sr, sc, field, s);
}
