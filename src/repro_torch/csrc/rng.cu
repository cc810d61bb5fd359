// Counter draws for Hopper (sm_90a): rng_uniform_kernel.
//
// The function: core/rng.py:uniform(seed, *words) on the card. For each
// element of the words' broadcast shape (rank <= 4, the seed and up to six
// words), the Murmur3 fold of core/rng.py on native u32 lanes,
//   h = fmix32(u32(seed) ^ GOLDEN)
//   h = fmix32(h ^ fmix32(u32(w_i) + GOLDEN (i + 1)))      word i = 0, 1, ...
// all mod 2^32, u32(w) the low 32 bits of the int64 carrier; then the U(0,1)
// float32 (h >> 8) 2^-24 + 2^-25, rounded as the plain version rounds (the
// _rn intrinsics, so no FMA contraction can change a bit). The plain version
// is core/rng.py's int64 path (hash_u32 and uniform's tail), which the CPU
// runs and the tests compare with, bit for bit.
//
// It replaces no Pallas kernel: on the TPU, XLA fused the same chain of u32
// ops into one loop. Eager PyTorch ran it as ~124 int64 passes over memory a
// draw (each multiply split into 16-bit halves), 2.08 ms a draw at the day's
// (256, 55,130) on an H100.
//
// What bounds it: the store, 4 B an element (56.5 MB at (256, 55,130): 17 us
// at 3.35 TB/s). Folding every word for every element would bound it by
// integer instruction throughput instead (a fold is two fmix32, four
// multiplies and ~20 instructions): so the prefix, the inputs that are the
// same along the last axis (seed, stream and day on the day's draws), is
// folded once a row, and an element of the day's draws costs the two
// fmix32 of its person id, the float conversion and its store.
//
// Design. The output is seen as (rows, cols), cols its last axis. A CTA of
// 256 threads takes one row (blockIdx.y, looping past the grid's y extent)
// and 256 * kElems of its columns; a lane stores kElems columns 256 apart,
// so neighbouring lanes store neighbouring floats. Each lane folds the
// row's prefix (the same loads for the whole CTA, one broadcast a warp),
// then per column the words after it. Words arrive as int64 pointers with
// four strides in elements (0 on a broadcast axis), or as u32 constants;
// the loops over the inputs run to kMaxInputs, unrolled, each step guarded
// by the launch's counts, so the argument array is indexed statically. The
// output is contiguous float32. Nothing is synchronised with the host or
// between threads, and nothing is allocated, so a launch is captured into a
// CUDA graph like any other.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kMaxInputs = 7;  // the seed and up to six words
constexpr int kRank = 4;
constexpr int kThreads = 256;
constexpr int kElems = 8;                  // columns of a row a lane stores
constexpr int kHeader = 2 + kRank;         // inputs, prefix, shape
constexpr int kPerInput = 2 + kRank;       // pointer, constant, strides
constexpr unsigned kC1 = 0x85EBCA6Bu;
constexpr unsigned kC2 = 0xC2B2AE35u;
constexpr unsigned kGolden = 0x9E3779B9u;

// One input: a device pointer (null for a constant), the constant's u32,
// and its strides in elements.
struct Input {
  const long long* word;
  unsigned value;
  long long stride[kRank];
};

struct Args {
  Input in[kMaxInputs];  // the seed, then the words in order
  long long shape[kRank];
  int inputs;            // how many of in[] are used
  int prefix;            // the leading inputs constant along the last axis
};

// Murmur3 finalizer (core/rng.py: fmix32).
__device__ __forceinline__ unsigned fmix32(unsigned h) {
  h ^= h >> 16;
  h *= kC1;
  h ^= h >> 13;
  h *= kC2;
  h ^= h >> 16;
  return h;
}

// Input k's u32 folded into h: k = 0 is the seed, which starts the hash;
// k >= 1 is word k - 1.
__device__ __forceinline__ unsigned fold(int k, unsigned h, unsigned w) {
  return k == 0 ? fmix32(w ^ kGolden)
                : fmix32(h ^ fmix32(w + kGolden * static_cast<unsigned>(k)));
}

// The u32 of an input at an element offset: the low 32 bits of the int64
// carrier (conversion to unsigned is mod 2^32), or the constant.
__device__ __forceinline__ unsigned word_at(const Input& in, long long off) {
  return in.word ? static_cast<unsigned>(__ldg(in.word + off)) : in.value;
}

__global__ void __launch_bounds__(kThreads)
rng_uniform_kernel(const Args a, float* __restrict__ out, long long rows, long long cols) {
  const long long col0 = static_cast<long long>(blockIdx.x) * (kThreads * kElems) + threadIdx.x;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    // The row's element offset in each input, from its index on the three
    // leading axes.
    const long long i2 = row % a.shape[2], i1 = row / a.shape[2] % a.shape[1],
                    i0 = row / a.shape[2] / a.shape[1];
    long long base[kMaxInputs];
    unsigned prefix_hash = 0;
#pragma unroll
    for (int k = 0; k < kMaxInputs; ++k) {
      const Input& in = a.in[k];
      base[k] = i0 * in.stride[0] + i1 * in.stride[1] + i2 * in.stride[2];
      if (k < a.prefix) prefix_hash = fold(k, prefix_hash, word_at(in, base[k]));
    }
    float* const out_row = out + row * cols;
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const long long col = col0 + static_cast<long long>(e) * kThreads;
      if (col < cols) {
        unsigned h = prefix_hash;
#pragma unroll
        for (int k = 0; k < kMaxInputs; ++k) {
          const Input& in = a.in[k];
          if (k >= a.prefix && k < a.inputs) {
            h = fold(k, h, word_at(in, base[k] + col * in.stride[3]));
          }
        }
        // (h >> 8) * 2^-24 + 2^-25 in float32, each step rounded to nearest.
        out_row[col] = __fadd_rn(__fmul_rn(__uint2float_rn(h >> 8), 5.9604644775390625e-08f),
                                 2.98023223876953125e-08f);
      }
    }
  }
}

constexpr long long kMaxGridY = 65535;

}  // namespace

// Plain C entry point for ctypes. `packed` holds kHeader + kMaxInputs *
// kPerInput int64 values: the number of inputs (1 to 7: the seed and up to
// six words), the prefix length (0 to inputs), the output's shape padded to
// rank 4 with leading 1s; then per input its device pointer (0 for a
// constant), its u32 constant and its four strides in elements after
// broadcasting (0 on a broadcast axis). `out` is the contiguous float32
// output of that shape, with at least one element. The Python wrapper
// (kernels/rng/kernel.py:pack) builds `packed` and checks devices and types.
// Launches once on `stream`, does not synchronise, and returns the launch's
// cudaGetLastError() (or cudaErrorInvalidValue for a shape or count the
// kernel does not take).
extern "C" int rng_uniform_launch(const long long* packed, float* out, void* stream) {
  Args a{};
  a.inputs = static_cast<int>(packed[0]);
  a.prefix = static_cast<int>(packed[1]);
  if (a.inputs < 1 || a.inputs > kMaxInputs || a.prefix < 0 || a.prefix > a.inputs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int d = 0; d < kRank; ++d) {
    a.shape[d] = packed[2 + d];
    if (a.shape[d] < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < a.inputs; ++k) {
    const long long* p = packed + kHeader + k * kPerInput;
    a.in[k].word = reinterpret_cast<const long long*>(p[0]);
    a.in[k].value = static_cast<unsigned>(p[1]);
    for (int d = 0; d < kRank; ++d) a.in[k].stride[d] = p[2 + d];
  }
  const long long rows = a.shape[0] * a.shape[1] * a.shape[2];
  const long long cols = a.shape[3];
  const long long col_tiles = (cols + kThreads * kElems - 1) / (kThreads * kElems);
  if (col_tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // Rows past the grid's y extent loop inside the kernel.
  const dim3 grid(static_cast<unsigned>(col_tiles),
                  static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
  const auto st = static_cast<cudaStream_t>(stream);
  rng_uniform_kernel<<<grid, kThreads, 0, st>>>(a, out, rows, cols);
  return static_cast<int>(cudaGetLastError());
}
