// Kernels P1 and P2: op-rate probes.  Each thread runs `REPS` chained
// operations of one kind on its element, x = op(x, b), and writes x.
// Replace the Pallas kernels of scripts/bench_vpu.py (`bench`, body
// `make_kernel`: add, mul, mulmask) and scripts/bench_vpu_ops.py (`run`,
// body `_kernel_factory`: u32mul, u32add, u32shift, f32mul, f32fma); see
// probes.py for the wrappers and the note on what bounds them.
//
// The chain is the measurement, so no step may be folded (a loop of
// `x += b` would otherwise become x + REPS*b): after every step an empty
// `asm volatile` takes x as an in/out register operand, which the compiler
// must assume changes it.  REPS is a template argument and the loop is
// unrolled, so the kernel holds REPS copies of the step and no loop
// counter: `cuobjdump -sass` shows about REPS instructions of the op, but
// for add: the barrier acts before ptxas, which merges two dependent adds
// into one three-input IADD3, so an add chain holds REPS/2 of them.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Op : int {
  kAdd = 0,       // x + b
  kMul = 1,       // x * b
  kMulMask = 2,   // p = x * b; x = (p & 0xFFFF) + (p >> 16)
  kShiftXor = 3,  // (x >> 3) ^ b
  kFMul = 4,      // x * b (f32)
  kFFma = 5,      // fma(x, b, a) (f32, one rounding)
};

template <int OP, int REPS>
__global__ void u32_chain_kernel(const uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ b,
                                 uint32_t* __restrict__ out, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  uint32_t x = a[j];
  const uint32_t y = b[j];
#pragma unroll
  for (int i = 0; i < REPS; ++i) {
    if constexpr (OP == kAdd) {
      x = x + y;
    } else if constexpr (OP == kMul) {
      x = x * y;
    } else if constexpr (OP == kMulMask) {
      const uint32_t p = x * y;
      x = (p & 0xFFFFu) + (p >> 16);
    } else {
      x = (x >> 3) ^ y;
    }
    asm volatile("" : "+r"(x));
  }
  out[j] = x;
}

template <int OP, int REPS>
__global__ void f32_chain_kernel(const float* __restrict__ a,
                                 const float* __restrict__ b,
                                 float* __restrict__ out, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const float z = a[j];
  const float y = b[j];
  float x = z;
#pragma unroll
  for (int i = 0; i < REPS; ++i) {
    if constexpr (OP == kFMul) {
      x = __fmul_rn(x, y);
    } else {
      x = __fmaf_rn(x, y, z);
    }
    asm volatile("" : "+f"(x));
  }
  out[j] = x;
}

constexpr int kThreads = 256;

template <int OP, int REPS>
int launch(const void* a, const void* b, void* out, int64_t n,
           cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if constexpr (OP == kFMul || OP == kFFma) {
    f32_chain_kernel<OP, REPS><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), n);
  } else {
    u32_chain_kernel<OP, REPS><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<uint32_t*>(out), n);
  }
  return (int)cudaGetLastError();
}

template <int OP>
int launch_reps(int reps, const void* a, const void* b, void* out, int64_t n,
                cudaStream_t s) {
  switch (reps) {
    case 16: return launch<OP, 16>(a, b, out, n, s);
    case 64: return launch<OP, 64>(a, b, out, n, s);
    case 256: return launch<OP, 256>(a, b, out, n, s);
    case 512: return launch<OP, 512>(a, b, out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// out[j] = REPS chained op(x, b[j]) from x = a[j]; reps in {16, 64, 256,
// 512}; u32 ops on 32-bit words, f32 ops on floats.
extern "C" int tr_vpu_probe(int op, int reps, const void* a, const void* b,
                            void* out, int64_t n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kAdd: return launch_reps<kAdd>(reps, a, b, out, n, s);
    case kMul: return launch_reps<kMul>(reps, a, b, out, n, s);
    case kMulMask: return launch_reps<kMulMask>(reps, a, b, out, n, s);
    case kShiftXor: return launch_reps<kShiftXor>(reps, a, b, out, n, s);
    case kFMul: return launch_reps<kFMul>(reps, a, b, out, n, s);
    case kFFma: return launch_reps<kFFma>(reps, a, b, out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
