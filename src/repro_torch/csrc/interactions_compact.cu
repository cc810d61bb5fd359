// Fused compacted-schedule interaction kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/interactions/kernel.py:
// _fused_kernel (launcher interactions_pallas_compact_call, backend
// "pallas-compact"). Same function: walk the live-first, stably compacted
// block-pair schedule up to n_live; for each b x b tile of visit pairs work
// out the overlap, the same-location/different-person validity and the
// symmetric CONTACT hash draw, and accumulate per row visit
//   acc += overlap * sus * inf * contact   (f32)
//   cnt += contact & sus > 0 & inf > 0     (i32)
// plus the day's traversed-edge total.
//
// Design (a simple kernel that is right first):
//  * One CTA per schedule entry k, blockDim = b. CTA k works only if
//    k < n_live and row_start_c[k] == 1, and then owns the whole live run of
//    its row block (tiles k, k+1, ... while rows_c is unchanged). No two CTAs
//    write one output row and nothing depends on CTA order, unlike the TPU
//    grid, which runs in order and zeroes `edges` at k == 0 and each row on
//    row_start. Here the wrapper hands in zeroed acc/cnt/edges instead, so
//    row blocks with no live tile are already 0 and need no masking after
//    the launch.
//  * Thread t keeps row visit rows_c[k] * b + t in registers. Per tile the
//    column block (pid, loc, start, end, inf) is staged in shared memory.
//  * Order: for j = 0 .. b-1, part = part + ((overlap * sus) * inf) * contact
//    from 0.0f, then acc = acc + part per tile, all with explicit _rn
//    intrinsics and the file built with --fmad=false. That is exactly the
//    order of the plain version (repro_torch/kernels/interactions/ref.py:
//    pair_tile and kernel.py:interactions_compact_plain), so the two agree
//    bitwise. No float atomics anywhere; edges is an integer block
//    reduction and one 64-bit integer atomicAdd per CTA.
//
// Bound: integer ALU work, not bytes. Every pair of a live tile needs the
// validity test (3 integer and 4 float operations); a pair that passes it
// also draws the hash. As written here that is the full six-word fold,
// about 100 u32 operations, but only the outer halves of three words
// depend on the pair (about 34 integer and 9 float operations with the
// uniform, rho and the count); the rest is per visit or per day. A fully
// live md-mini day is 1,505 tiles x 128^2 = 24.7 M pairs against ~5 MB of
// visit arrays. Making it fast (hoisting the per-day hash prefix and the
// per-visit inner words, several rows per thread, TMA staging) is later
// work.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kC1 = 0x85EBCA6Bu;
constexpr unsigned kC2 = 0xC2B2AE35u;
constexpr unsigned kGolden = 0x9E3779B9u;
constexpr unsigned kContactStream = 0x01u;  // core/rng.py: CONTACT

// Murmur3 finalizer (core/rng.py: fmix32).
__device__ __forceinline__ unsigned fmix32(unsigned h) {
  h ^= h >> 16;
  h *= kC1;
  h ^= h >> 13;
  h *= kC2;
  h ^= h >> 16;
  return h;
}

// Word i (0-based) of the left fold in core/rng.py: hash_u32.
__device__ __forceinline__ unsigned fold(unsigned h, unsigned w, unsigned i) {
  return fmix32(h ^ fmix32(w + kGolden * (i + 1u)));
}

// kernels/interactions/ref.py: contact_uniform, i.e.
// uniform(seed, CONTACT, day, min pid, max pid, loc).
__device__ __forceinline__ float contact_uniform(unsigned seed, unsigned day,
                                                 int pid_i, int pid_j,
                                                 int loc) {
  unsigned h = fmix32(seed ^ kGolden);
  h = fold(h, kContactStream, 0u);
  h = fold(h, day, 1u);
  h = fold(h, static_cast<unsigned>(min(pid_i, pid_j)), 2u);
  h = fold(h, static_cast<unsigned>(max(pid_i, pid_j)), 3u);
  h = fold(h, static_cast<unsigned>(loc), 4u);
  // Top 24 bits -> [0, 1) in steps of 2^-24, then + 2^-25, in f32.
  return __fadd_rn(__fmul_rn(__uint2float_rn(h >> 8), 5.9604644775390625e-08f),
                   2.98023223876953125e-08f);
}

__global__ void interactions_compact_kernel(
    const int* __restrict__ pid, const int* __restrict__ loc,
    const float* __restrict__ start, const float* __restrict__ end,
    const float* __restrict__ p_loc, const float* __restrict__ sus_val,
    const float* __restrict__ inf_val,
    const int* __restrict__ rows_c, const int* __restrict__ cols_c,
    const int* __restrict__ row_start_c, const int* __restrict__ n_live,
    const int* __restrict__ col_has_inf, const int* __restrict__ row_has_sus,
    const long long* __restrict__ meta,
    float* __restrict__ acc, int* __restrict__ cnt,
    unsigned long long* __restrict__ edges) {
  extern __shared__ int smem[];
  __shared__ unsigned long long warp_edges[32];
  const int b = blockDim.x;
  int* s_pid = smem;
  int* s_loc = s_pid + b;
  float* s_start = reinterpret_cast<float*>(s_loc + b);
  float* s_end = s_start + b;
  float* s_inf = s_end + b;

  const int k = blockIdx.x;
  const int t = threadIdx.x;
  const int nl = n_live[0];
  // Uniform over the block: only the first live tile of a row run works.
  if (k >= nl || row_start_c[k] == 0) return;

  const int rb = rows_c[k];
  const long long r = static_cast<long long>(rb) * b + t;
  const int pid_r = pid[r];
  const int loc_r = loc[r];
  const float start_r = start[r];
  const float end_r = end[r];
  const float p_r = p_loc[r];
  const float sus_r = sus_val[r];
  const unsigned seed = static_cast<unsigned>(meta[0]);
  const unsigned day = static_cast<unsigned>(meta[1]);
  const bool row_sus = row_has_sus[rb] > 0;

  float acc_r = 0.0f;
  int cnt_r = 0;
  for (int kk = k; kk < nl && rows_c[kk] == rb; ++kk) {
    const int cb = cols_c[kk];
    // The TPU kernel's per-tile short-circuit guard (uniform over the block,
    // so the barriers below stay convergent).
    if (!(row_sus && col_has_inf[cb] > 0)) continue;
    __syncthreads();  // the previous tile's readers are done
    const long long c = static_cast<long long>(cb) * b + t;
    s_pid[t] = pid[c];
    s_loc[t] = loc[c];
    s_start[t] = start[c];
    s_end[t] = end[c];
    s_inf[t] = inf_val[c];
    __syncthreads();

    float part = 0.0f;
    int pcnt = 0;
    for (int j = 0; j < b; ++j) {
      const int pid_c = s_pid[j];
      const float inf_c = s_inf[j];
      const float overlap = fmaxf(
          __fsub_rn(fminf(end_r, s_end[j]), fmaxf(start_r, s_start[j])), 0.0f);
      const bool valid = pid_r >= 0 && pid_c >= 0 && loc_r == s_loc[j] &&
                         pid_r != pid_c && overlap > 0.0f;
      // The draw only matters for a valid pair; skipping it elsewhere
      // changes no result.
      const bool contact =
          valid && contact_uniform(seed, day, pid_r, pid_c, loc_r) < p_r;
      const float cf = contact ? 1.0f : 0.0f;
      part = __fadd_rn(
          part, __fmul_rn(__fmul_rn(__fmul_rn(overlap, sus_r), inf_c), cf));
      pcnt += (contact && sus_r > 0.0f && inf_c > 0.0f) ? 1 : 0;
    }
    acc_r = __fadd_rn(acc_r, part);
    cnt_r += pcnt;
  }
  acc[r] = acc_r;
  cnt[r] = cnt_r;

  // Traversed edges: integer block reduction, one atomicAdd per CTA.
  unsigned long long e = static_cast<unsigned long long>(cnt_r);
  for (int off = 16; off > 0; off >>= 1) e += __shfl_down_sync(0xffffffffu, e, off);
  if ((t & 31) == 0) warp_edges[t >> 5] = e;
  __syncthreads();
  if (t == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < (b >> 5); ++w) total += warp_edges[w];
    if (total) atomicAdd(edges, total);
  }
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers on one card;
// block_size must be a multiple of 32 and at most 1024 (the Python wrapper
// checks shapes, types and devices). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch.
extern "C" int interactions_compact_launch(
    const int* pid, const int* loc, const float* start, const float* end,
    const float* p_loc, const float* sus_val, const float* inf_val,
    const int* rows_c, const int* cols_c, const int* row_start_c,
    const int* n_live, const int* col_has_inf, const int* row_has_sus,
    const long long* meta, float* acc, int* cnt, unsigned long long* edges,
    int num_pairs, int block_size, void* stream) {
  if (num_pairs <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = 5 * static_cast<size_t>(block_size) * sizeof(int);
  interactions_compact_kernel<<<num_pairs, block_size, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      pid, loc, start, end, p_loc, sus_val, inf_val, rows_c, cols_c,
      row_start_c, n_live, col_has_inf, row_has_sus, meta, acc, cnt, edges);
  return static_cast<int>(cudaGetLastError());
}
