// Interaction-pass kernels for Hopper (sm_90a): one templated tile body,
// four instantiations.
//
//   interactions_kernel<kTraced, kPadded>
//
//   <false, false>  compacted schedule, untraced. Replaces the Pallas TPU
//                   kernel src/repro/kernels/interactions/kernel.py:205
//                   _fused_kernel (launcher interactions_pallas_compact_call,
//                   kernel.py:279; backend "pallas-compact").
//   <true,  false>  the same kernel's traced arity (src_c in, trc out;
//                   kernel.py:218-228, :259-266, :327-344).
//   <false, true>   padded schedule, untraced. Replaces kernel.py:66 _kernel
//                   (launcher interactions_pallas_call, kernel.py:129;
//                   backend "pallas").
//   <true,  true>   the padded kernel's traced arity (kernel.py:79-83,
//                   :113-120).
//
// The function: for each b x b tile of visit pairs of the block-pair
// schedule that passes the short-circuit guard, work out the overlap, the
// same-location/different-person validity and the symmetric CONTACT hash
// draw, and accumulate per row visit
//   acc += overlap * sus * inf * contact          (f32)
//   cnt += pair = contact & sus > 0 & inf > 0     (i32)
//   trc += pair & src > 0                         (i32, traced arity only)
// plus, on the compacted schedule, the day's traversed-edge total.
//
// Design (a simple kernel that is right first):
//  * One CTA per schedule entry k, blockDim = b. CTA k works only if
//    row_start[k] == 1 (and, compacted, k < n_live), and then owns the whole
//    run of its row block: tiles k, k+1, ... while the row index is
//    unchanged (compacted: and kk < n_live; padded: and kk < NP). No two
//    CTAs write one output row and nothing depends on CTA order, unlike the
//    TPU grid, which runs in order and zeroes a row on row_start (and
//    `edges` at k == 0). Here the wrapper hands in zeroed outputs instead,
//    so row blocks that no CTA owns are already 0. For the padded kernel
//    that zeroing is the counterpart of the JAX wrapper's visited mask
//    (src/repro/kernels/interactions/ops.py:263-270).
//  * Compacted schedule: the live tiles first, in row-major order; the
//    guard is row_has_sus & col_has_inf (already true on the live prefix).
//    Padded schedule: every scheduled tile, guarded by the TPU kernel's
//    full predicate pair_active & col_has_inf & row_has_sus
//    (kernel.py:101-105). pair_active matters: the schedule's padding
//    repeats the last real tile with pair_active = 0
//    (src/repro/core/population.py:464-472), so without it that tile would
//    be added twice. The padded kernel launches NP CTAs whether or not
//    their tiles are live, as the TPU grid stepped over every scheduled
//    tile; the compacted kernel launches NP CTAs too, and those past n_live
//    exit at once.
//  * Thread t keeps row visit rows[k] * b + t in registers. Per tile the
//    column block (pid, loc, start, end, inf, and src when traced) is staged
//    in dynamic shared memory: 5 * b * 4 B, or 6 * b * 4 B traced.
//  * Order: for j = 0 .. b-1, part = part + ((overlap * sus) * inf) * contact
//    from 0.0f, then acc = acc + part per tile, all with explicit _rn
//    intrinsics and the file built with --fmad=false. That is exactly the
//    order of the plain versions (repro_torch/kernels/interactions/ref.py:
//    pair_tile_traced, kernel.py: interactions_compact_plain and
//    interactions_padded_plain). Both schedules add the same live tiles of a
//    row in the same row-major order from the same zero, so the padded and
//    the compacted kernels give bitwise-equal acc, cnt and trc. No float
//    atomics anywhere; trc is a per-thread int written like cnt, and edges
//    is an integer block reduction and one 64-bit integer atomicAdd per CTA.
//
// Bound: integer ALU work, not bytes. Every pair of a live tile needs the
// validity test (3 integer and 4 float operations); a pair that passes it
// also draws the hash. As written here that is the full six-word fold,
// about 100 u32 operations, but only the outer halves of three words
// depend on the pair (about 34 integer and 9 float operations with the
// uniform, rho and the count); the rest is per visit or per day. The traced
// arity adds one more byte stream (src in, trc out) and about 2 integer
// operations per valid pair. The padded kernel does the same live-tile work
// as the compacted one and reads the (NP,) row_start and pair_active arrays
// in place of the compacted schedule. A fully live md-mini day is
// 1,505 tiles x 128^2 = 24.7 M pairs against ~5 MB of visit arrays. Making
// them fast (hoisting the per-day hash prefix and the per-visit inner
// words, several rows per thread, TMA staging) is later work.

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

struct Args {
  // (V,) visit arrays, location-sorted; src_val only in the traced arity.
  const int* pid;
  const int* loc;
  const float* start;
  const float* end;
  const float* p_loc;
  const float* sus_val;
  const float* inf_val;
  const float* src_val;
  // (NP,) schedule: compacted (rows_c, cols_c, row_start_c) with n_live (1,),
  // or padded (row_idx, col_idx, row_start) with pair_active.
  const int* rows;
  const int* cols;
  const int* row_start;
  const int* pair_active;
  const int* n_live;
  // (V / b,) short-circuit flags; meta = [seed, day] as int64.
  const int* col_has_inf;
  const int* row_has_sus;
  const long long* meta;
  // Outputs, zeroed by the wrapper; trc only traced, edges only compacted.
  float* acc;
  int* cnt;
  int* trc;
  unsigned long long* edges;
  int num_pairs;
};

template <bool kTraced, bool kPadded>
__global__ void interactions_kernel(const Args a) {
  extern __shared__ int smem[];
  __shared__ unsigned long long warp_edges[32];
  const int b = blockDim.x;
  int* s_pid = smem;
  int* s_loc = s_pid + b;
  float* s_start = reinterpret_cast<float*>(s_loc + b);
  float* s_end = s_start + b;
  float* s_inf = s_end + b;
  float* s_src = s_inf + b;  // traced arity only

  const int k = blockIdx.x;
  const int t = threadIdx.x;
  // The schedule entries this kernel may walk: all of them on the padded
  // schedule, the live prefix on the compacted one.
  const int n = kPadded ? a.num_pairs : a.n_live[0];
  // Uniform over the block: only the first tile of a row run works.
  if (k >= n || a.row_start[k] != 1) return;

  const int rb = a.rows[k];
  const long long r = static_cast<long long>(rb) * b + t;
  const int pid_r = a.pid[r];
  const int loc_r = a.loc[r];
  const float start_r = a.start[r];
  const float end_r = a.end[r];
  const float p_r = a.p_loc[r];
  const float sus_r = a.sus_val[r];
  const unsigned seed = static_cast<unsigned>(a.meta[0]);
  const unsigned day = static_cast<unsigned>(a.meta[1]);
  const bool row_sus = a.row_has_sus[rb] > 0;

  float acc_r = 0.0f;
  int cnt_r = 0;
  int trc_r = 0;
  for (int kk = k; kk < n && a.rows[kk] == rb; ++kk) {
    const int cb = a.cols[kk];
    // The TPU kernels' per-tile short-circuit guard (uniform over the
    // block, so the barriers below stay convergent).
    bool live = row_sus && a.col_has_inf[cb] > 0;
    if (kPadded) live = live && a.pair_active[kk] == 1;
    if (!live) continue;
    __syncthreads();  // the previous tile's readers are done
    const long long c = static_cast<long long>(cb) * b + t;
    s_pid[t] = a.pid[c];
    s_loc[t] = a.loc[c];
    s_start[t] = a.start[c];
    s_end[t] = a.end[c];
    s_inf[t] = a.inf_val[c];
    if (kTraced) s_src[t] = a.src_val[c];
    __syncthreads();

    float part = 0.0f;
    int pcnt = 0;
    int ptrc = 0;
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
      const bool pair = contact && sus_r > 0.0f && inf_c > 0.0f;
      pcnt += pair ? 1 : 0;
      if (kTraced) ptrc += (pair && s_src[j] > 0.0f) ? 1 : 0;
    }
    acc_r = __fadd_rn(acc_r, part);
    cnt_r += pcnt;
    trc_r += ptrc;
  }
  a.acc[r] = acc_r;
  a.cnt[r] = cnt_r;
  if (kTraced) a.trc[r] = trc_r;

  if (!kPadded) {
    // Traversed edges: integer block reduction, one atomicAdd per CTA.
    unsigned long long e = static_cast<unsigned long long>(cnt_r);
    for (int off = 16; off > 0; off >>= 1) e += __shfl_down_sync(0xffffffffu, e, off);
    if ((t & 31) == 0) warp_edges[t >> 5] = e;
    __syncthreads();
    if (t == 0) {
      unsigned long long total = 0;
      for (int w = 0; w < (b >> 5); ++w) total += warp_edges[w];
      if (total) atomicAdd(a.edges, total);
    }
  }
}

template <bool kTraced, bool kPadded>
int launch(const Args& a, int block_size, cudaStream_t stream) {
  const size_t smem = (kTraced ? 6 : 5) * static_cast<size_t>(block_size) * sizeof(int);
  interactions_kernel<kTraced, kPadded><<<a.num_pairs, block_size, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers on one card;
// those an instantiation does not use may be null (src_val and trc untraced;
// pair_active compacted; n_live and edges padded). block_size must be a
// multiple of 32 and at most 1024 (the Python wrapper checks shapes, types
// and devices). Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch.
extern "C" int interactions_launch(
    int traced, int padded,
    const int* pid, const int* loc, const float* start, const float* end,
    const float* p_loc, const float* sus_val, const float* inf_val,
    const float* src_val, const int* rows, const int* cols,
    const int* row_start, const int* pair_active, const int* n_live,
    const int* col_has_inf, const int* row_has_sus, const long long* meta,
    float* acc, int* cnt, int* trc, unsigned long long* edges,
    int num_pairs, int block_size, void* stream) {
  if (num_pairs <= 0) return static_cast<int>(cudaSuccess);
  const Args a{pid, loc, start, end, p_loc, sus_val, inf_val, src_val,
               rows, cols, row_start, pair_active, n_live,
               col_has_inf, row_has_sus, meta,
               acc, cnt, trc, edges, num_pairs};
  const auto s = static_cast<cudaStream_t>(stream);
  if (traced) {
    return padded ? launch<true, true>(a, block_size, s)
                  : launch<true, false>(a, block_size, s);
  }
  return padded ? launch<false, true>(a, block_size, s)
                : launch<false, false>(a, block_size, s);
}
