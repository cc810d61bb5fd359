// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:28
// `_kernel` (pallas_call :128, launcher `flash_attention_bhsd` :92). It
// computes the same function, not block for block:
//
//   q (BH, Sq, Dh), k/v (BH / G, Sk, Dh), f32 or bf16, Dh in {64, 128, 256};
//   query head bh reads key/value head bh / G in place (GQA, no repeat);
//   logits in f32 from f32 q * scale and f32 k; running max m (from -inf),
//   sum l and accumulator acc in f32 (online softmax over key tiles in order);
//   a key tile the masks leave empty is skipped (causal: live iff
//   k_lo <= q_hi; window: live iff k_hi > q_lo - window), then inside a live
//   tile masked logits are -1e30 (not -inf), queries end-aligned to the keys
//   (query i sits at position i + Sk - Sq);
//   out = acc / max(l, 1e-30), cast to the input type.
//
// The -1e30 mask matters: inside a live tile, a row whose keys are all masked
// gets p = 1 on each of them, and the row's first real tile wipes that through
// corr = exp(-1e30 - m) = 0. Built without fast math so that expf underflows
// to exactly 0 there, as XLA's exp does.
//
// Design (first, simple version; no tensor cores): one CTA of 256 threads per
// (bh, tile of kBQ = 64 query rows), the tile with the longest causal rows
// first. The CTA stages its Q tile (scaled, f32) in shared memory once, then
// walks the live key tiles of kBK = 32 keys: K and V tiles to shared memory,
// the 64 x 32 logits as a 16 x 16 thread grid of 4 x 2 register blocks, the
// online softmax one warp per 8 rows (one logit per lane), then acc (4 rows x
// Dh / 16 columns per thread, in registers) += P V. A query tile past Sq and a
// key tile past Sk are masked at their tails (a key past Sk gets weight 0), so
// any Sq <= Sk works. Bound on this card: at the serving prefill shape the
// work is ~4 Sq Sk Dh BH / 2 flops against a few MB of Q/K/V/O, so the bound is
// the tensor cores' rate; this kernel uses FP32 CUDA cores (a later design's
// wgmma and TMA are what close that gap).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 32;        // keys per shared-memory tile (one per lane)
constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;  // the reference's masked logit

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int Dh>
constexpr size_t smem_bytes() {
  // Q and K tiles padded by one column (no bank conflicts on the strided
  // reads), V unpadded, the logit tile padded, then m, l and corr per row.
  return sizeof(float) * ((size_t)kBQ * (Dh + 1) + (size_t)kBK * (Dh + 1) +
                          (size_t)kBK * Dh + (size_t)kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T, int Dh>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int G, int Sq, int Sk, int causal, int has_window,
                 int window, float scale) {
  constexpr int QS = Dh + 1;     // row stride of the Q and K tiles
  constexpr int SS = kBK + 1;    // row stride of the logit tile
  constexpr int RPT = kBQ / 16;  // query rows per thread
  constexpr int CPT = kBK / 16;  // logit columns per thread
  constexpr int DPT = Dh / 16;   // output columns per thread
  constexpr int RPW = kBQ / kWarps;  // softmax rows per warp

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * QS;
  float* sV = sK + kBK * QS;
  float* sS = sV + kBK * Dh;
  float* sM = sS + kBQ * SS;
  float* sL = sM + kBQ;
  float* sC = sL + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int nq = min(kBQ, Sq - q0);
  const int off = Sk - Sq;
  const int q_lo = q0 + off, q_hi = q0 + nq - 1 + off;

  const T* qb = q + ((size_t)bh * Sq + q0) * Dh;
  const T* kb = k + (size_t)(bh / G) * Sk * Dh;
  const T* vb = v + (size_t)(bh / G) * Sk * Dh;

  for (int i = tid; i < kBQ * Dh; i += kThreads) {
    const int r = i / Dh, d = i % Dh;
    sQ[r * QS + d] = r < nq ? to_f(qb[(size_t)r * Dh + d]) * scale : 0.0f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    sM[r] = -INFINITY;
    sL[r] = 0.0f;
  }

  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.0f;

  const int nkt = (Sk + kBK - 1) / kBK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kBK;
    const int nk = min(kBK, Sk - k0);
    const int k_hi = k0 + nk - 1;
    bool live = true;
    if (causal) live = k0 <= q_hi;
    if (has_window) live = live && (k_hi > q_lo - window);
    if (!live) continue;  // uniform over the CTA

    __syncthreads();  // the previous tile's readers are done with sK, sV, sS
    for (int i = tid; i < kBK * Dh; i += kThreads) {
      const int r = i / Dh, d = i % Dh;
      const bool in = r < nk;
      sK[r * QS + d] = in ? to_f(kb[(size_t)(k0 + r) * Dh + d]) : 0.0f;
      sV[r * Dh + d] = in ? to_f(vb[(size_t)(k0 + r) * Dh + d]) : 0.0f;
    }
    __syncthreads();

    // logits = (q * scale) . k, then the masks
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < Dh; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sK[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qpos = q_lo + r, kpos = k0 + c;
        bool keep = true;
        if (causal) keep = kpos <= qpos;
        if (has_window) keep = keep && (kpos > qpos - window);
        float x = keep ? s[i][j] : kMasked;
        if (c >= nk) x = -INFINITY;  // past the last key: weight exactly 0
        sS[r * SS + c] = x;
      }
    }
    __syncthreads();

    // online softmax: one warp per RPW rows, one logit per lane
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      const float x = sS[r * SS + lane];
      float mx = x;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(x - m_new);
      float sum = p;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      sS[r * SS + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
        sC[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float corr = sC[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < nk; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sS[(ty + 16 * i) * SS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = sV[c * Dh + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();  // sL is final

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    const float denom = fmaxf(sL[r], 1e-30f);
    T* orow = o + ((size_t)bh * Sq + q0 + r) * Dh;
#pragma unroll
    for (int j = 0; j < DPT; ++j) from_f(orow + tx + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int Dh>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int G,
                   int Sq, int Sk, int causal, int has_window, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<Dh>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, Dh>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  flash_fwd_kernel<T, Dh><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), G, Sq, Sk, causal, has_window, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(int Dh, const void* q, const void* k, const void* v, void* o, int BH,
                      int G, int Sq, int Sk, int causal, int has_window, int window,
                      float scale, cudaStream_t stream) {
  switch (Dh) {
    case 64:
      return launch<T, 64>(q, k, v, o, BH, G, Sq, Sk, causal, has_window, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, BH, G, Sq, Sk, causal, has_window, window, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, BH, G, Sq, Sk, causal, has_window, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The C entry point: bf16 = 0 for float32 tensors, 1 for bfloat16. Pointers
// are contiguous device buffers: q and o (BH, Sq, Dh), k and v (BH / G, Sk,
// Dh). Launches on `stream` without synchronising; returns the CUDA error of
// the launch (0 when it was accepted).
extern "C" int flash_attention_launch(int bf16, const void* q, const void* k, const void* v,
                                      void* o, int BH, int G, int Sq, int Sk, int Dh, int causal,
                                      int has_window, int window, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_dh<__nv_bfloat16>(Dh, q, k, v, o, BH, G, Sq, Sk, causal, has_window, window,
                                      scale, s)
           : launch_dh<float>(Dh, q, k, v, o, BH, G, Sq, Sk, causal, has_window, window, scale, s);
  return static_cast<int>(err);
}
