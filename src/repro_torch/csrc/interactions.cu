// Interaction-pass kernels for Hopper (sm_90a): one templated body, four
// instantiations.
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
// What bounds it: u32 and f32 ALU work with no tensor-core path (the SM's
// INT32/FP32 lanes and its issue rate), and far less of it than the tiles
// suggest: at md-mini's mid-epidemic day 24.5 M pairs lie in live tiles,
// 634,498 are candidates (same location, row sus != 0, column inf != 0, both
// pids >= 0) and 564,129 of those contribute (valid). The rest can change no
// output. On the card the time goes to each CTA's chain of dependent loads
// and barriers, and to the longest row run (5 tiles of one location).
//
// The scenario axis: one launch serves a batch of B scenarios (the day of a
// scenario ensemble), grid (NP, B), CTA (k, s) for schedule entry k of
// scenario s. What varies by scenario is strided by it: pid, sus, inf and
// src by V, the block flags by V / b, meta by 2, the compacted schedule by
// NP with n_live[s], and the outputs (acc, cnt, trc by V, edges by 1). loc,
// start, end, p and the padded schedule come from the week and are shared.
// A CTA past its scenario's n_live returns at once. Scenario s's outputs are
// the ones its launch alone gives, bit for bit: no CTA reads or writes
// another scenario's rows, and the arithmetic below does not depend on s.
//
// Design:
//  * Grid and ownership. One CTA per schedule entry k (of each scenario);
//    CTA k works only if
//    row_start[k] == 1 (compacted: and k < n_live) and its row block holds
//    a susceptible visit, and then owns the whole run of its row block:
//    entries k, k+1, ... while the row index is unchanged (compacted: and
//    < n_live; padded: and < NP), scanned T at a time. No two CTAs write one
//    output row and nothing depends on CTA order. The wrapper hands in one
//    zeroed buffer for all outputs, so row blocks that no CTA owns are 0
//    (for the padded kernel, the counterpart of the JAX wrapper's visited
//    mask, src/repro/kernels/interactions/ops.py:263-270). Guards as the
//    TPU kernels: compacted row_has_sus & col_has_inf (true on the live
//    prefix), padded pair_active & col_has_inf & row_has_sus
//    (kernel.py:101-105; the schedule's padding repeats the last real tile
//    with pair_active = 0, src/repro/core/population.py:464-472).
//  * Launch geometry. NP x B CTAs of T = G b threads, G = TILES_PER_GROUP in
//    kernels/interactions/kernel.py (2; at most 1024 threads): a CTA stages
//    G live tiles of its run at once, thread (g, i) column i of tile g.
//    Dynamic shared memory shared_words(b, T) * 4 bytes: the loc -> run hash
//    table (2 T slots of 12 bytes), the group's compacted columns (a 16-byte
//    record pid, A, B, loc; an 8-byte start, end; inf; src), the compacted
//    rows (lane, pid, loc, start, end, threshold), the run's live
//    tiles, the run starts and a b x (T / 32 + 1)-word contact bitmask (the
//    odd stride keeps a warp's rows in different banks): 24,200 bytes at
//    b = 128, T = 256 (plus 400 or 656 static). Above 48 KB (b >= 256) the
//    launch opts in. __launch_bounds__(1024) holds ptxas to 64 registers.
//  * Two rounds of loads. The first reads the schedule entries k .. k + T - 1,
//    the day and, speculatively, the column block of entry k + g; the second
//    the row block, the flags and those columns (used if entries k .. k + g
//    are all live, which the compacted schedule's live prefix always is).
//  * Hoisted hash. rng.hash_u32 folds word i as
//    h = fmix32(h ^ fmix32(w + GOLDEN (i + 1))). The prefix fmix32(seed ^
//    GOLDEN), CONTACT, day is per CTA. The fold of the min pid depends on
//    that pid alone, so each visit carries A = fmix32(prefix ^ fmix32(pid +
//    3 GOLDEN)) and B = fmix32(pid + 4 GOLDEN), and each row its loc word
//    L = fmix32(loc + 5 GOLDEN): rows in registers once per CTA, columns in
//    shared memory once per group. A pair pays h = fmix32(fmix32(A_min ^
//    B_max) ^ L): a compare, two selects, two xors and two finalizers. The
//    uniform's compare u < p becomes (h >> 8) < thr, with thr per row the
//    count of k in [0, 2^24) whose float32 uniform (k 2^-24 + 2^-25,
//    rounded as ref.py rounds it) is < p: the uniform is non-decreasing in
//    k, so the two compares agree for every hash. All integer: exact.
//  * Draw only for pairs that can count, with converged warps. Rows with
//    pid >= 0 and sus != 0 and columns with pid >= 0 and inf != 0 are
//    compacted in order (ballot scans). The compacted columns' maximal runs
//    of one loc form a run table, and a hash table maps each loc to its run,
//    or marks it as split over several. All T threads walk: thread t <
//    Gw nr, Gw = T / nr, takes candidates t / nr, + Gw, ... of compacted row
//    t % nr: the columns of its loc's run, or, for a split loc, every
//    compacted column with a loc test (so any layout is served, and a
//    layout with no runs walks each row's compacted columns once). A warp's
//    lanes are consecutive rows, so the rows of one location's run walk the
//    same columns in lockstep, and each lane draws for 4 candidates at once
//    (independent loads and hash chains). A valid candidate (same loc,
//    different pid, overlap > 0) contributes, and a contact sets bit (row,
//    position) of the bitmask (an integer shared-memory atomicOr).
//  * Fold, and the order. After a barrier, thread t < b folds row t: per
//    tile of the group, part = part + ((overlap * sus) * inf) over its set
//    bits in ascending column order from 0.0f, then acc = acc + part, tiles
//    in schedule order, all with _rn intrinsics and the file built with
//    --fmad=false. That is the plain versions' order (ref.py:
//    pair_tile_traced, folded by kernel.py: _fold_tiles) with the terms
//    that are +-0 left out; cnt and trc are integer sums. The padded and
//    compacted kernels add the same live tiles of a row in the same order,
//    so they agree bitwise too. No float atomics; edges is an integer block
//    reduction and one 64-bit integer atomicAdd per CTA.
//  * Why leaving out a term is exact. A pair that is not a contact has
//    contact = 0, so its term x * 0.0f is +-0 for any finite x =
//    (overlap * sus) * inf; a contact whose row has sus == 0 or whose
//    column has inf == 0 has x = +-0. (Inputs are finite and x does not
//    overflow, as for every real input: |overlap| <= 86,400 s and |sus|,
//    |inf| are a few units at most.) Adding +-0 to part changes it only if
//    part is -0; part starts at +0.0f, and a round-to-nearest sum is -0
//    only when both addends are -0, so part is never -0. The same holds for
//    acc. A contact's own term is x * 1.0f = x. cnt and trc need sus > 0
//    and inf > 0, so they never count a left-out pair. The test is != 0,
//    not > 0: no sign is assumed.
//  * Chosen by measurement on the H100 (device-alone times of all four
//    instantiations in chip_smoke.py's states). Design (a), the run-table
//    walk, over design (b), a pair-parallel test of every pair at full
//    width: (b) was slower at mid and all, where after compaction 89% of
//    the same-location candidates contribute (564,129 of 634,498 at mid),
//    so (a)'s lanes already draw together and (b) only adds the tests of
//    pairs at other locations; (b) was faster on the shuffled layout, which
//    is why a split loc walks all compacted columns with a loc test rather
//    than run by run. G = 2 over 1 (slower at all) and 4 (slower at mid);
//    4 candidates per lane at once over 1, 2 (slower at all) and 8; one
//    output buffer, one fill instead of four; warp 0 scanning the warps'
//    counts and one pass of 16-byte stores clearing the table and bitmask
//    (a loop over the warps in every thread, and word stores, were slower
//    at mid). Tried and dropped: one barrier per scan instead of two, one
//    scan for a chunk's end, live tiles and rows with run starts found
//    before the column writes (no gain), the validity test moved into the
//    fold, more CTAs per SM by capping registers (spills, no gain),
//    prefetching the next group's columns and 3 tiles per group (no gain).
//
// Bound (chip_smoke.py: bound), the least work on this data: the validity
// test per candidate (1 integer, 4 float), the draw per contributing pair
// (23 integer), the term and count per contact (1 + 3; traced + 1 + 1), the
// hash words per candidate visit of a live tile (27 integer); every input
// read once and every output written once.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kC1 = 0x85EBCA6Bu;
constexpr unsigned kC2 = 0xC2B2AE35u;
constexpr unsigned kGolden = 0x9E3779B9u;
constexpr unsigned kContactStream = 0x01u;  // core/rng.py: CONTACT
constexpr unsigned kMulti = 0x80000000u;    // run-table flag: the loc has several runs
constexpr int kUnroll = 4;  // candidates a walker draws for at once

// Murmur3 finalizer (core/rng.py: fmix32).
__device__ __forceinline__ unsigned fmix32(unsigned h) {
  h ^= h >> 16;
  h *= kC1;
  h ^= h >> 13;
  h *= kC2;
  h ^= h >> 16;
  return h;
}

// The inner hash of word i (0-based) of core/rng.py: hash_u32's fold.
__device__ __forceinline__ unsigned inner(unsigned w, unsigned i) {
  return fmix32(w + kGolden * (i + 1u));
}

// kernels/interactions/ref.py's uniform of a hash whose top 24 bits are k.
__device__ __forceinline__ float uniform24(unsigned k) {
  return __fadd_rn(__fmul_rn(__uint2float_rn(k), 5.9604644775390625e-08f),
                   2.98023223876953125e-08f);
}

// The count of k in [0, 2^24) with uniform24(k) < p. uniform24 is
// non-decreasing in k, so that set is a prefix and u < p <=> (h >> 8) < it.
// A first guess from p, then the two loops settle on the one k with
// uniform24(k - 1) < p <= uniform24(k) (as far as those exist).
__device__ unsigned contact_threshold(float p) {
  if (!(p > 0.0f)) return 0u;  // uniform24(0) = 2^-25 > 0; NaN too
  const double e = static_cast<double>(p) * 16777216.0 - 0.5;
  unsigned k = e <= 0.0 ? 0u : e >= 16777216.0 ? (1u << 24) : static_cast<unsigned>(e);
  while (k > 0u && !(uniform24(k - 1u) < p)) --k;
  while (k < (1u << 24) && uniform24(k) < p) ++k;
  return k;
}

// Stream compaction over the CTA: the count of set flags among lower
// threads (whether or not this thread's own is set), and in `total` the
// count of all. s_warp holds 65 ints: the warps' counts, then their prefix
// (scanned by warp 0). Every thread of the CTA calls it (it holds two
// barriers); the next call's writes come after this call's reads.
__device__ __forceinline__ int compact_index(bool flag, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int nw = static_cast<int>(blockDim.x >> 5);
  const unsigned bal = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) s_warp[w] = __popc(bal);
  __syncthreads();
  if (w == 0) {
    int c = lane < nw ? s_warp[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, c, off);
      if (lane >= off) c += v;
    }
    s_warp[33 + lane] = c;  // inclusive prefix; s_warp[32 + x] is warp x's offset
    if (lane == 0) s_warp[32] = 0;
  }
  __syncthreads();
  total = s_warp[32 + nw];
  return s_warp[32 + w] + __popc(bal & ((1u << lane) - 1u));
}

struct Args {
  // (V,) visit arrays; src_val only in the traced arity.
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
  int num_visits;  // V: the stride of a scenario's visits and outputs
  int b;  // tile width (block_size)
};

// Slots of the loc -> run hash table: a power of two >= 2 * threads, so it
// never fills (a column group has at most `threads` runs).
__host__ __device__ constexpr int table_slots(int threads) {
  int s = 1;
  while (s < 2 * threads) s <<= 1;
  return s;
}

// Row stride of the contact bitmask, in words: one bit per column position
// of a group of G tiles, plus one word so that the rows of a warp fall in
// different banks.
__host__ __device__ constexpr int bit_stride(int threads) { return threads / 32 + 1; }

// Dynamic shared memory of one CTA (T threads, tiles of b), in 4-byte
// words: the run table (8-byte keys and 4-byte values) and the contact
// bitmask (b rows of bit_stride(T) words), both cleared for every group;
// the compacted columns of a group (pid, the two hash words and loc as one
// 16-byte record; start and end as one 8-byte record; inf; src: 8 T); the
// compacted rows (their lane, pid, loc, start, end and threshold: 6 b); the
// live tiles of a schedule chunk (T); the group's tile boundaries (33) and
// the run starts (T + 1).
__host__ __device__ constexpr long long shared_words(int b, int threads) {
  return 3LL * table_slots(threads) + 8LL * threads + 6LL * b + threads + 33 +
         threads + 1 + static_cast<long long>(b) * bit_stride(threads);
}

// One thread's column visit, staged from device memory.
struct Col {
  int pid;
  int loc;
  float start;
  float end;
  float inf;
  float src;
};

// Column visit c of the scenario whose visits start at sV.
template <bool kTraced>
__device__ __forceinline__ Col load_col(const Args& a, long long c, long long sV) {
  Col v;
  v.pid = a.pid[sV + c];
  v.loc = a.loc[c];
  v.start = a.start[c];
  v.end = a.end[c];
  v.inf = a.inf_val[sV + c];
  v.src = kTraced ? a.src_val[sV + c] : 0.0f;
  return v;
}

// The slot of `loc` in a run table of 2^lg slots.
__device__ __forceinline__ unsigned table_slot(int loc, int lg) {
  return (static_cast<unsigned>(loc) * 2654435761u) >> (32 - lg);
}

__device__ __forceinline__ unsigned long long table_key(int loc) {
  return (1ull << 32) | static_cast<unsigned>(loc);
}

template <bool kTraced, bool kPadded>
__global__ void __launch_bounds__(1024) interactions_kernel(const Args a) {
  extern __shared__ unsigned long long smem64[];
  __shared__ int s_warp[65];
  __shared__ int s_stop;
  __shared__ int s_spec[33];
  __shared__ unsigned long long warp_edges[32];
  const int b = a.b;
  const int T = blockDim.x;
  const int G = T / b;  // tiles per group
  const int TS = table_slots(T);
  const int lg = 31 - __clz(TS);
  const int BW = bit_stride(T);
  // Cleared for every group, as one run of 16-byte words: the run table
  // and the contact bitmask.
  unsigned long long* t_key = smem64;  // 0, or table_key(loc)
  unsigned* t_val = reinterpret_cast<unsigned*>(t_key + TS);  // run index | kMulti
  unsigned* bits = t_val + TS;  // contacts, b x BW
  const int n_clear = (12 * TS + 4 * b * BW) / 16;
  // Compacted columns of a group (pid >= 0, inf != 0): (pid, A, B, loc),
  // A the hash state after the min pid, B the inner word as max pid.
  int4* c_pk = reinterpret_cast<int4*>(bits + b * BW);
  float2* c_se = reinterpret_cast<float2*>(c_pk + T);  // (start, end)
  float* c_inf = reinterpret_cast<float*>(c_se + T);
  float* c_src = c_inf + T;  // traced arity only
  int* r_lane = reinterpret_cast<int*>(c_src + T);  // compacted rows: pid >= 0, sus != 0
  int* r_pid = r_lane + b;
  int* r_loc = r_pid + b;
  float* r_start = reinterpret_cast<float*>(r_loc + b);
  float* r_end = r_start + b;
  unsigned* r_thr = reinterpret_cast<unsigned*>(r_end + b);
  int* s_tile = reinterpret_cast<int*>(r_thr + b);  // live column blocks of a chunk
  int* s_sub = s_tile + T;  // tile boundaries in the group
  int* run_begin = s_sub + 33;  // runs of one loc, + end

  const int k = blockIdx.x;
  // Scenario scen: offsets of its visits and outputs, its block flags and (on
  // the compacted schedule) its schedule, all in 64-bit.
  const int scen = blockIdx.y;
  const long long sV = static_cast<long long>(scen) * a.num_visits;
  const long long sF = static_cast<long long>(scen) * (a.num_visits / b);
  const long long sP = kPadded ? 0LL : static_cast<long long>(scen) * a.num_pairs;
  const int* rows = a.rows + sP;
  const int* cols = a.cols + sP;
  const int* col_has_inf = a.col_has_inf + sF;
  const int t = threadIdx.x;
  const int g = t / b;  // staging: thread (g, i) stages column i of tile g
  const int i = t - g * b;
  // First round of loads, all independent: this entry, the T entries from
  // it (the run's tiles, if it starts one) and, speculatively, the column
  // block of entry k + g.
  const int n = kPadded ? a.num_pairs : a.n_live[scen];
  const int start_k = a.row_start[sP + k];
  const int rb = rows[k];
  const long long meta0 = a.meta[2 * scen];  // [seed, day]
  const long long meta1 = a.meta[2 * scen + 1];
  const int kk = k + t;
  const bool kk_ok = kk < a.num_pairs;
  const int row_kk = kk_ok ? rows[kk] : -1;
  const int col_kk = kk_ok ? cols[kk] : 0;
  const bool pa_kk = !kPadded || (kk_ok && a.pair_active[kk] == 1);
  const int col_spec = k + g < a.num_pairs ? cols[k + g] : 0;
  // Uniform over the block: only the first tile of a row run works.
  if (k >= n || start_k != 1) return;
  const long long r0 = static_cast<long long>(rb) * b;

  // Second round: the row block, its flag, the chunk's column flags and
  // the speculative column visits.
  const int sus_blk = a.row_has_sus[sF + rb];
  int pid_f = -1, loc_f = 0;
  float start_f = 0.0f, end_f = 0.0f, sus_f = 0.0f, p_f = 0.0f;
  if (t < b) {  // thread t < b holds row lane t
    pid_f = a.pid[sV + r0 + t];
    loc_f = a.loc[r0 + t];
    start_f = a.start[r0 + t];
    end_f = a.end[r0 + t];
    sus_f = a.sus_val[sV + r0 + t];
    p_f = a.p_loc[r0 + t];
  }
  const bool inf_kk = kk_ok && row_kk == rb && col_has_inf[col_kk] > 0;
  Col cur = load_col<kTraced>(a, static_cast<long long>(col_spec) * b + i, sV);
  // The hash prefix of the day (seed, then the words CONTACT and day),
  // while the second round is in flight.
  unsigned prefix = fmix32(static_cast<unsigned>(meta0) ^ kGolden);
  prefix = fmix32(prefix ^ inner(kContactStream, 0u));
  prefix = fmix32(prefix ^ inner(static_cast<unsigned>(meta1), 1u));
  // Every tile of the run fails the guard without a susceptible row.
  if (sus_blk <= 0) return;
  const bool row_ok = t < b && pid_f >= 0 && sus_f != 0.0f;

  bool ready = false;  // rows compacted (at the first live tile)
  bool walker = false;
  int wg = 0, Gw = 1;
  int w_r = 0, w_pid = 0, w_loc = 0;
  float w_start = 0.0f, w_end = 0.0f;
  unsigned w_A = 0u, w_B = 0u, w_L = 0u, w_thr = 0u;
  float acc_r = 0.0f;
  int cnt_r = 0;
  int trc_r = 0;
  // The row run, in chunks of T schedule entries: its live tiles in order.
  for (int base = k; base < n; base += T) {
    const int kc = base + t;
    bool in_run, live;
    int cb;
    if (base == k) {  // the first chunk: from the first round
      in_run = kc < n && row_kk == rb;
      cb = col_kk;
      live = in_run && inf_kk && pa_kk;
    } else {
      in_run = kc < n && rows[kc] == rb;
      cb = in_run ? cols[kc] : 0;
      live = in_run && col_has_inf[cb] > 0 &&
             (!kPadded || a.pair_active[kc] == 1);
    }
    if (t == 0) s_stop = T;
    __syncthreads();  // also: the previous chunk's readers of s_tile are done
    if (!in_run) atomicMin(&s_stop, t);
    __syncthreads();
    const int stop = s_stop;
    live = live && t < stop;
    int nl;
    const int li = compact_index(live, s_warp, nl);
    if (live) s_tile[li] = cb;
    // The speculative columns of slot g hold the g-th live tile if the
    // entries k .. k + g are all live.
    if (t < G) s_spec[t] = base == k && live && li == t;
    __syncthreads();

    if (nl > 0 && !ready) {
      // Once, at the first live tile: compact the rows, with each row's
      // threshold (a run without live tiles leaves its zeroed rows as they
      // are).
      ready = true;
      int nr;
      const int ri = compact_index(row_ok, s_warp, nr);
      if (row_ok) {
        r_lane[ri] = t;
        r_pid[ri] = pid_f;
        r_loc[ri] = loc_f;
        r_start[ri] = start_f;
        r_end[ri] = end_f;
        r_thr[ri] = contact_threshold(p_f);
      }
      __syncthreads();
      // Walkers: thread t < Gw * nr walks the (t / nr)-th, ... candidate of
      // compacted row t % nr, in steps of Gw = T / nr (all threads walk).
      Gw = nr > 0 ? T / nr : 1;
      walker = t < Gw * nr;
      if (walker) {
        const int wi = t % nr;
        wg = t / nr;
        w_r = r_lane[wi];
        w_pid = r_pid[wi];
        w_loc = r_loc[wi];
        w_start = r_start[wi];
        w_end = r_end[wi];
        w_thr = r_thr[wi];
        w_A = fmix32(prefix ^ inner(static_cast<unsigned>(w_pid), 2u));
        w_B = inner(static_cast<unsigned>(w_pid), 3u);
        w_L = inner(static_cast<unsigned>(w_loc), 4u);
      }
    }

    // Groups of G live tiles: thread (g, i) stages column i of tile g.
    for (int q0 = 0; q0 < nl; q0 += G) {
      const int nq = min(G, nl - q0);
      if (g < nq && !(q0 == 0 && s_spec[g])) {
        cur = load_col<kTraced>(a, static_cast<long long>(s_tile[q0 + g]) * b + i, sV);
      }
      __syncthreads();  // the previous group's readers are done
      const bool col_ok = g < nq && cur.pid >= 0 && cur.inf != 0.0f;
      for (int q = t; q < n_clear; q += T) {
        reinterpret_cast<uint4*>(smem64)[q] = make_uint4(0u, 0u, 0u, 0u);
      }
      int nc;
      const int ci = compact_index(col_ok, s_warp, nc);
      if (g < nq && i == 0) s_sub[g] = ci;
      if (t == 0) s_sub[nq] = nc;
      if (col_ok) {
        c_pk[ci] = make_int4(cur.pid,
                             static_cast<int>(fmix32(prefix ^ inner(static_cast<unsigned>(cur.pid), 2u))),
                             static_cast<int>(inner(static_cast<unsigned>(cur.pid), 3u)), cur.loc);
        c_se[ci] = make_float2(cur.start, cur.end);
        c_inf[ci] = cur.inf;
        if (kTraced) c_src[ci] = cur.src;
      }
      __syncthreads();

      // The run table: maximal runs of one loc in the compacted columns,
      // and a hash table from loc to a run (kMulti if the loc has several).
      const bool first = t < nc && (t == 0 || c_pk[t].w != c_pk[t - 1].w);
      int nruns;
      const int ru = compact_index(first, s_warp, nruns);
      if (first) {
        const int l = c_pk[t].w;
        run_begin[ru] = t;
        const unsigned long long key = table_key(l);
        for (unsigned s = table_slot(l, lg);; s = (s + 1u) & (TS - 1u)) {
          const unsigned long long old = atomicCAS(t_key + s, 0ull, key);
          if (old == 0ull || old == key) {
            atomicOr(t_val + s, old == 0ull ? static_cast<unsigned>(ru) : kMulti);
            break;
          }
        }
      }
      if (t == 0) run_begin[nruns] = nc;
      __syncthreads();

      // Walk: the row's candidates are its loc's run, or, if the loc is
      // split over several runs, every compacted column with a loc test.
      // Draw for the valid pairs (all of them contribute: both sides passed
      // compaction), and mark each contact in the bitmask.
      if (walker) {
        int mb = 0, me = 0;
        const unsigned long long key = table_key(w_loc);
        for (unsigned s = table_slot(w_loc, lg);; s = (s + 1u) & (TS - 1u)) {
          const unsigned long long kv = t_key[s];
          if (kv == key) {
            const unsigned v = t_val[s];
            const int c = static_cast<int>(v & ~kMulti);
            const bool multi = (v & kMulti) != 0u;
            mb = multi ? 0 : run_begin[c];
            me = multi ? nc : run_begin[c + 1];
            break;
          }
          if (kv == 0ull) break;
        }
        unsigned* row_bits = bits + w_r * BW;
        // kUnroll candidates at once, m, m + Gw, ...: independent loads and
        // hash chains, then the marks (an index past the range reads its
        // last column and marks nothing).
        for (int m0 = mb + wg; m0 < me; m0 += kUnroll * Gw) {
          int4 q[kUnroll];
          float2 x[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int m = min(m0 + u * Gw, me - 1);
            q[u] = c_pk[m];
            x[u] = c_se[m];
          }
          bool hit[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const float ov = __fsub_rn(fminf(w_end, x[u].y), fmaxf(w_start, x[u].x));
            const bool lo = w_pid < q[u].x;
            unsigned h = fmix32((lo ? w_A : static_cast<unsigned>(q[u].y)) ^
                                (lo ? static_cast<unsigned>(q[u].z) : w_B));
            h = fmix32(h ^ w_L);
            hit[u] = m0 + u * Gw < me && q[u].w == w_loc && q[u].x != w_pid && ov > 0.0f &&
                     (h >> 8) < w_thr;
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int m = m0 + u * Gw;
            if (hit[u]) atomicOr(row_bits + (m >> 5), 1u << (m & 31));
          }
        }
      }
      __syncthreads();

      // Fold: one thread per row, tile by tile, its contacts in ascending
      // column order from 0.0f.
      if (row_ok) {
        const unsigned* row_bits = bits + t * BW;
        for (int q = 0; q < nq; ++q) {
          const int e = s_sub[q + 1];
          float part = 0.0f;
          int pcnt = 0;
          int ptrc = 0;
          for (int m = s_sub[q]; m < e; m = (m | 31) + 1) {
            unsigned word = row_bits[m >> 5] & (0xffffffffu << (m & 31));
            if ((e >> 5) == (m >> 5)) word &= (1u << (e & 31)) - 1u;
            while (word) {
              const int j = (m & ~31) + __ffs(word) - 1;
              word &= word - 1u;
              const float inf_c = c_inf[j];
              const float2 se = c_se[j];
              const float overlap =
                  fmaxf(__fsub_rn(fminf(end_f, se.y), fmaxf(start_f, se.x)), 0.0f);
              part = __fadd_rn(part, __fmul_rn(__fmul_rn(overlap, sus_f), inf_c));
              const bool pair = sus_f > 0.0f && inf_c > 0.0f;
              pcnt += pair ? 1 : 0;
              if (kTraced) ptrc += (pair && c_src[j] > 0.0f) ? 1 : 0;
            }
          }
          acc_r = __fadd_rn(acc_r, part);
          cnt_r += pcnt;
          trc_r += ptrc;
        }
      }
    }
    if (stop < T) break;
  }
  if (!ready) return;  // no live tile: the zeroed outputs stand
  if (t < b) {
    a.acc[sV + r0 + t] = acc_r;
    a.cnt[sV + r0 + t] = cnt_r;
    if (kTraced) a.trc[sV + r0 + t] = trc_r;
  }

  if (!kPadded) {
    // Traversed edges: integer block reduction, one atomicAdd per CTA.
    unsigned long long e = static_cast<unsigned long long>(cnt_r);
    for (int off = 16; off > 0; off >>= 1) e += __shfl_down_sync(0xffffffffu, e, off);
    if ((t & 31) == 0) warp_edges[t >> 5] = e;
    __syncthreads();
    if (t == 0) {
      unsigned long long total = 0;
      for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += warp_edges[w];
      if (total) atomicAdd(a.edges + scen, total);
    }
  }
}

template <bool kTraced, bool kPadded>
int launch(const Args& a, int threads, int num_scenarios, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(shared_words(a.b, threads)) * sizeof(int);
  if (smem > 48 * 1024) {  // tiles of 256 and wider
    const cudaError_t e = cudaFuncSetAttribute(interactions_kernel<kTraced, kPadded>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(a.num_pairs), static_cast<unsigned>(num_scenarios));
  interactions_kernel<kTraced, kPadded><<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool bad_geometry(int block_size, int threads) {
  return block_size < 32 || block_size > 1024 || block_size % 32 || threads < block_size ||
         threads > 1024 || threads % block_size || threads / block_size > 32;
}

}  // namespace

// Dynamic shared memory, in bytes, of a CTA of `threads` threads on tiles of
// `block_size` (-1 for a geometry the kernel does not take).
extern "C" long long interactions_shared_bytes(int block_size, int threads) {
  if (bad_geometry(block_size, threads)) return -1;
  return shared_words(block_size, threads) * static_cast<long long>(sizeof(int));
}

// Plain C entry point for ctypes. Pointers are device pointers on one card;
// those an instantiation does not use may be null (src_val and trc untraced;
// pair_active compacted; n_live and edges padded). block_size must be a
// multiple of 32 and at most 1024, threads a multiple of block_size and at
// most 1024, num_visits (V) a multiple of block_size and num_scenarios (B)
// in [1, 65535]; per-scenario arrays hold B rows (the header: the scenario
// axis). The Python wrapper checks shapes, types and devices. Launches once
// for the batch on `stream`, does not synchronise, and returns the launch's
// cudaGetLastError() (or cudaErrorInvalidValue for a bad geometry).
extern "C" int interactions_launch(
    int traced, int padded,
    const int* pid, const int* loc, const float* start, const float* end,
    const float* p_loc, const float* sus_val, const float* inf_val,
    const float* src_val, const int* rows, const int* cols,
    const int* row_start, const int* pair_active, const int* n_live,
    const int* col_has_inf, const int* row_has_sus, const long long* meta,
    float* acc, int* cnt, int* trc, unsigned long long* edges,
    int num_pairs, int block_size, int threads, int num_visits, int num_scenarios,
    void* stream) {
  if (bad_geometry(block_size, threads) || num_visits <= 0 || num_visits % block_size ||
      num_scenarios < 1 || num_scenarios > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_pairs <= 0) return static_cast<int>(cudaSuccess);
  const Args a{pid, loc, start, end, p_loc, sus_val, inf_val, src_val,
               rows, cols, row_start, pair_active, n_live,
               col_has_inf, row_has_sus, meta,
               acc, cnt, trc, edges, num_pairs, num_visits, block_size};
  const int B = num_scenarios;
  const auto st = static_cast<cudaStream_t>(stream);
  if (traced) {
    return padded ? launch<true, true>(a, threads, B, st) : launch<true, false>(a, threads, B, st);
  }
  return padded ? launch<false, true>(a, threads, B, st) : launch<false, false>(a, threads, B, st);
}
