// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:28
// `_kernel` (pallas_call :128, launcher `flash_attention_bhsd` :92). It
// computes the same function, not block for block:
//
//   q (BH, Sq, Dh), k/v (BH / G, Sk, Dh), f32 or bf16, Dh in {64, 128, 256};
//   query head bh reads key/value head bh / G in place (GQA, no repeat);
//   f32 logits of q and k, times the scale; running max m (from -inf),
//   sum l and accumulator acc in f32 (online softmax over key tiles in order);
//   a key tile the masks leave empty is skipped (causal: live iff
//   k_lo <= q_hi; window: live iff k_hi > q_lo - window), then inside a live
//   tile masked logits are -1e30 (not -inf), queries end-aligned to the keys
//   (query i sits at position i + Sk - Sq); keys past Sk get -inf (weight
//   exactly 0), so any Sq <= Sk works;
//   out = acc / max(l, 1e-30), cast to the input type.
//
// The -1e30 mask matters: inside a live tile, a row whose keys are all masked
// gets p = 1 on each of them, and the row's first real tile wipes that through
// corr = exp(-1e30 - m) = 0. Built without fast math, so that the float32
// kernel's expf and the bf16 kernel's exp2f underflow to exactly 0 there, as
// XLA's exp does.
//
// Bound on this card: at the serving prefill shape (qwen2-1.5b, 8 x 512,
// 12 query heads over 2 KV heads, Dh 128) the work is 4 Dh flops per live
// (query, key) pair and head, 6.5 GFLOP. In bf16, against 29 MB of Q/K/V/O,
// 0.0088 ms at 3.35 TB/s bounds it, with the operations close behind at
// 0.0065 ms on the tensor cores' 989 TFLOP/s. In float32 the 58.7 MB take
// 0.0175 ms and the operations bound it: 0.0391 ms at the split-TF32 rate
// (495 / 3 TFLOP/s, below), 0.0963 ms at the FP32 lanes' 67 TFLOP/s.
//
// Two kernels, one function:
//
// flash_fwd_wgmma_kernel<Dh>, bf16 (the type serving runs in). One CTA owns
// one (bh, tile of kWgBQ = 128 query rows); CTAs are launched with the longest
// causal rows first. Three warpgroups: two consumers of 64 query rows each and
// a producer whose first thread alone issues the loads (setmaxnreg gives the
// consumers 240 registers, the producer 24).
//   Loads: TMA (cp.async.bulk.tensor) through 3-D tensor maps (Dh, S, heads),
//   so a tail tile reads zeros past S and never the next head's rows; 128 B
//   swizzle, the layout wgmma reads without bank conflicts; the inner box is
//   64 bf16 (128 B), so a row of Dh is Dh / 64 panels. Q comes once; K and V
//   tiles of kWgBK = 64 keys go through a ring of kWgStages = 2 stages, each
//   completing on a "full" mbarrier with expect-tx and freed by the 256
//   consumer threads on an "empty" one. The producer walks the same live
//   tiles as the consumers.
//   S = Q K^T: wgmma m64n64k16, both operands in shared memory (K-major, one
//   instruction per 16 of Dh: the descriptor advances 32 B inside a swizzle
//   row, a panel every 4 steps), f32 accumulators. The scale is applied to
//   the f32 logits, then the block's masks on the accumulator fragment (a
//   thread holds rows r and r + 8 of its warp's 16, columns 8j + 2(lane % 4)
//   + {0, 1}), only in a tile the diagonal, the window's edge or Sk crosses.
//   Online softmax in registers: a row's max and sum over its four threads
//   by shuffles; no shared-memory logit tile and no CTA barrier per key tile.
//   The logits are scaled by scale * log2(e) and p = exp2f(x - m) (one MUFU
//   op; -1e30 and -inf still give exactly 0, a fully masked row still p = 1).
//   A warpgroup frees unread a live tile its own 64 rows see nothing of (the
//   causal tail, the window's head): its logits would all be -1e30, which
//   changes none of m, l, acc.
//   O += P V: wgmma m64n{Dh}k16 RS, P converted to bf16 in registers as A
//   (the S fragment of 16 keys is exactly the A fragment), V in shared memory
//   as B, MN-major (its rows are keys), through the descriptor's transpose
//   bit; acc is rescaled by corr first. P in bf16 adds ~2^-9 relative error
//   per weight; l sums the f32 p.
//   Epilogue: acc / max(l, 1e-30) to bf16, rows < Sq only (guarded stores).
//   The two consumers overlap each other's softmax and products; within one
//   consumer S, softmax and P V of a tile run in turn. Overlapping tile j's S
//   with tile j - 1's P V, three stages, or 128-key tiles measured no faster
//   at the serving shape (PERF.md).
//
// flash_fwd_f32_kernel<Dh>, float32, on the tensor cores in split TF32. One
// TF32 product keeps 10 of float32's 23 mantissa bits, which moves the
// outputs by ~1e-4, ten times the float32 tolerance (1e-5 + 1e-5|x|;
// tests/test_torch_flash.py emulates it). So each operand x is split into
// big = rna_tf32(x) and small = rna_tf32(x - big), and a b is taken as
// small_a big_b + big_a small_b + big_a big_b on the tensor cores (CUTLASS's
// "3xTF32"), accumulated in f32, the cross terms apart from big x big and
// the two added on the FP32 lanes; the dropped small_a small_b and the
// rounding of the small parts are ~2^-22 |a b|, the order of float32's own
// rounding. The split is two integer operations a part (ptxas makes
// cvt.rna.tf32.f32 a longer sequence with NaN handling). Three products per
// product turn the card's 495 TFLOP/s of TF32 into ~165 TFLOP/s of
// float32-accurate ones, 2.5x the 67 TFLOP/s of the FP32 lanes. mma.sync
// takes both operands from registers, so Q, K, V and P are split in
// registers as they are loaded (a wgmma design would need split and, for V,
// transposed copies in shared memory).
//   One CTA of four warps owns one (bh, tile of kF32BQ = 64 query rows), the
//   tiles with the longest causal rows first, on a 1-D grid; each warp owns
//   16 rows (two m-tiles a warp, so that a K/V fragment split once feeds
//   both, spilled at Dh 128 and measured slower at Dh 64: PERF.md).
//   Loads: the Q tile, times the scale, to shared memory once (split in
//   registers as it is read, as K, V and P are: splitting each K/V tile
//   once into big and small copies in shared memory measured slower, and
//   does not fit at Dh 256); K and V tiles of kF32BK = 32 keys through two
//   stages by cp.async (16 B a thread, rows past Sk zero-filled), the next
//   live tile in flight while the warps work on this one, one CTA barrier
//   per tile. Rows are padded (Q and K to
//   Dh + 16 floats, V to Dh + 4) so that each quarter warp's 16-byte
//   fragment loads hit 32 distinct banks.
//   S = Q K^T by mma.sync m16n8k8 TF32: Q is the row-major A fragment, K the
//   B fragment, both Dh-contiguous. The dot runs over d in another order:
//   one 16-byte load at d = 16 p + 4 t (t = lane % 4) gives a thread the four
//   d that the two 8-deep k-steps at 16 p assign it, for Q and K alike.
//   Scale on Q, masks as in the bf16 design, online softmax in registers (a
//   row's max and sum over its quad by shuffles), expf.
//   O += P V with no shuffle: the S accumulator holds keys 2t and 2t + 1 of
//   rows g and g + 8 (g = lane / 4); they become the A fragment's k-indices
//   t and t + 4, and V's rows 2t and 2t + 1 are read in that order for B.
//   Four n-tiles of 8 output columns take d = 32 q + 4 g + j (j the n-tile),
//   so one 16-byte load of a V row feeds four of them, and a thread's
//   outputs are 8 contiguous floats of a row: two 16-byte stores. A tile's
//   P V sums in fresh accumulators and joins acc on the FP32 lanes (acc corr
//   + P V, the plain version's step): the truncating tensor-core steps
//   straight into acc would bias it (3 Sk / 8 of them; measured: PERF.md).
//   A warp works only on the live tiles its own rows see (a skipped tile's
//   logits would all be -1e30, which changes none of m, l, acc). The keys
//   are never split across CTAs (no float atomics, no combine), so each
//   row's sums run in one fixed order: the same inputs give the same bits on
//   every launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kMasked = -1e30f;  // the reference's masked logit

// ---- the bf16 design: wgmma, TMA, warp-specialised ------------------------

constexpr int kWgBQ = 128;             // query rows per CTA: two consumer warpgroups
constexpr int kWgBK = 64;              // keys per K/V tile
constexpr int kWgStages = 2;           // K/V ring depth
constexpr int kWgThreads = 3 * 128;    // consumers 0 and 1, producer 2
constexpr int kConsumerThreads = 256;  // the arrivals that free a stage
constexpr uint32_t kPanel = 64;        // bf16 values in a 128 B swizzle row
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, as byte offsets from a 1024 B aligned base (the swizzle
// atom): Q as Dh / 64 panels of 128 rows x 128 B, then per stage a K and a V
// tile as Dh / 64 panels of 64 rows x 128 B each, then the barriers. 1024 B
// of slack align the base.
template <int Dh>
struct WgLayout {
  static constexpr uint32_t kQPanel = kWgBQ * 128;
  static constexpr uint32_t kKPanel = kWgBK * 128;
  static constexpr uint32_t kQBytes = kWgBQ * Dh * 2;
  static constexpr uint32_t kTileBytes = kWgBK * Dh * 2;  // one K or one V tile
  static constexpr uint32_t kKV = kQBytes;                // stage s at kKV + 2 s kTileBytes
  static constexpr uint32_t kBar = kKV + kWgStages * 2 * kTileBytes;
  static constexpr uint32_t kBytes = kBar + 8 * (2 * kWgStages + 1) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of this parity has completed. A wait of
// more than ~10 s (a load that never lands) traps, so a fault in the
// pipeline is a launch error and not a hung card.
constexpr long long kHangCycles = 20000000000LL;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kHangCycles) __trap();
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128 B swizzled operand: start
// address, leading and stride byte offsets (16 B units), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers an asynchronous wgmma writes: no read of them moves above the
// wait, and no write below the next issue.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), both bf16 in shared memory,
// K-major; scale_d = 0 overwrites S.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// O (64 x N, f32) += A (64 x 16, bf16 in registers) B (16 x N, bf16 in shared
// memory, MN-major: the transpose bit is set).

__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n128_tb(float (&d)[64], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n256_tb(float (&d)[128], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}


template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  if constexpr (N == 64) wgmma_rs_m64n64_tb(d, a, desc_b, 1);
  if constexpr (N == 128) wgmma_rs_m64n128_tb(d, a, desc_b, 1);
  if constexpr (N == 256) wgmma_rs_m64n256_tb(d, a, desc_b, 1);
}

// Whether key tile kt (of bk keys) holds a pair the masks keep for query
// positions [q_lo, q_hi]; the producer and the consumers walk the same tiles.
__device__ __forceinline__ bool tile_live(int kt, int Sk, int q_lo, int q_hi, int causal,
                                          int has_window, int window, int bk = kWgBK) {
  const int k0 = kt * bk;
  const int k_hi = min(k0 + bk, Sk) - 1;
  bool live = true;
  if (causal) live = k0 <= q_hi;
  if (has_window) live = live && (k_hi > q_lo - window);
  return live;
}

template <int Dh>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
                       int BH, int G, int Sq, int Sk, int causal, int has_window, int window,
                       float scale) {
  using L = WgLayout<Dh>;
  constexpr int kPanels = Dh / kPanel;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full_bar = base + L::kBar;            // kWgStages barriers
  const uint32_t empty_bar = full_bar + 8 * kWgStages;  // kWgStages barriers
  const uint32_t q_bar = empty_bar + 8 * kWgStages;

  // CTA -> (query tile, head), the tiles with the longest causal rows first.
  const int nqt = (Sq + kWgBQ - 1) / kWgBQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.x / BH)) * kWgBQ;
  const int off = Sk - Sq;
  const int q_lo = q0 + off, q_hi = min(q0 + kWgBQ, Sq) - 1 + off;
  const int nkt = (Sk + kWgBK - 1) / kWgBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumerThreads);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every load --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(q_bar, L::kQBytes);
      for (int p = 0; p < kPanels; ++p)
        tma_load_3d(base + p * L::kQPanel, &map_q, q_bar, p * kPanel, q0, bh);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < nkt; ++kt) {
        if (!tile_live(kt, Sk, q_lo, q_hi, causal, has_window, window)) continue;
        mbar_wait(empty_bar + 8 * stage, phase ^ 1);  // the first pass finds it free
        const uint32_t kdst = base + L::kKV + stage * 2 * L::kTileBytes;
        const uint32_t bar = full_bar + 8 * stage;
        mbar_expect_tx(bar, 2 * L::kTileBytes);
        for (int p = 0; p < kPanels; ++p) {
          tma_load_3d(kdst + p * L::kKPanel, &map_k, bar, p * kPanel, kt * kWgBK, bh / G);
          tma_load_3d(kdst + L::kTileBytes + p * L::kKPanel, &map_v, bar, p * kPanel,
                      kt * kWgBK, bh / G);
        }
        if (++stage == kWgStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each -----------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int row0 = wg * 64 + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
    const int qpos0 = q0 + off + row0;
    const int col0 = 2 * (lane % 4);                   // + 8 j + {0, 1}
    const int wq_lo = q0 + off + wg * 64, wq_hi = wq_lo + 63;
    const float scale2 = scale * kLog2e;  // logits in log2 units: p = 2^(x - m)
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.0f, 0.0f};  // this thread's share of the row sums
    float acc[Dh / 2];
#pragma unroll
    for (int i = 0; i < Dh / 2; ++i) acc[i] = 0.0f;

    // The CTA's live tiles [c0, c1] and this warpgroup's [w0, w1] inside
    // them (both ranges are contiguous: causal cuts a suffix, the window a
    // prefix). A tile outside [w0, w1] leaves m, l and acc unchanged for
    // these rows (its logits are all -1e30: before the first real tile corr
    // wipes them, after it p = 0), so it is freed unread.
    int c0 = nkt, c1 = -1, w0 = nkt, w1 = -1;
    for (int kt = 0; kt < nkt; ++kt) {
      if (!tile_live(kt, Sk, q_lo, q_hi, causal, has_window, window)) continue;
      c0 = min(c0, kt);
      c1 = kt;
      if (tile_live(kt, Sk, wq_lo, wq_hi, causal, has_window, window)) {
        w0 = min(w0, kt);
        w1 = kt;
      }
    }
    if (w0 > w1) {  // rows past Sq only: every tile is skipped
      w0 = c1 + 1;
      w1 = c1;
    }

    int stage = 0;
    uint32_t phase = 0;
    auto next_stage = [&] {
      mbar_arrive(empty_bar + 8 * stage);
      if (++stage == kWgStages) {
        stage = 0;
        phase ^= 1;
      }
    };
    for (int kt = c0; kt < w0; ++kt) {
      mbar_wait(full_bar + 8 * stage, phase);
      next_stage();
    }
    mbar_wait(q_bar, 0);
    for (int kt = w0; kt <= w1; ++kt) {  // no branch around a wgmma here
      mbar_wait(full_bar + 8 * stage, phase);
      // S = Q K^T over Dh in steps of 16 (32 B inside a swizzle row, a
      // panel every 4 steps).
      uint32_t q_rows = base + wg * 64 * 128;
      uint32_t k_tile = base + L::kKV + stage * 2 * L::kTileBytes;
      asm volatile("" : "+r"(q_rows), "+r"(k_tile));  // keep the descriptors in the loop
      float s[kWgBK / 2];
#pragma unroll
      for (int i = 0; i < kWgBK / 2; ++i) s[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Dh / 16; ++kk) {
        const uint32_t panel = kk / 4, in_row = (kk % 4) * 32;
        wgmma_ss_m64n64(s, sw128_desc(q_rows + panel * L::kQPanel + in_row, 16, 1024),
                        sw128_desc(k_tile + panel * L::kKPanel + in_row, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // Scale, then the masks where this tile crosses the diagonal, the
      // window's edge or Sk.
      const int k0 = kt * kWgBK;
      const bool edge = (causal && k0 + kWgBK - 1 > wq_lo) ||
                        (has_window && k0 <= wq_hi - window) || (k0 + kWgBK > Sk);
#pragma unroll
      for (int i = 0; i < kWgBK / 2; ++i) {
        float x = s[i] * scale2;
        if (edge) {
          const int kpos = k0 + (i / 4) * 8 + col0 + (i % 2);
          const int qpos = qpos0 + 8 * ((i / 2) % 2);
          bool keep = true;
          if (causal) keep = kpos <= qpos;
          if (has_window) keep = keep && (kpos > qpos - window);
          x = keep ? x : kMasked;
          if (kpos >= Sk) x = -INFINITY;  // past the last key: weight exactly 0
        }
        s[i] = x;
      }

      // Online softmax: row h of this thread is (i / 2) % 2; the row's
      // other 48 columns sit in lanes xor 1 and xor 2.
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kWgBK / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = exp2f(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= corr[h];
      }
#pragma unroll
      for (int i = 0; i < kWgBK / 2; ++i) {
        s[i] = exp2f(s[i] - m[(i / 2) % 2]);
        l[(i / 2) % 2] += s[i];
      }
#pragma unroll
      for (int i = 0; i < Dh / 2; ++i) acc[i] *= corr[(i / 2) % 2];

      // O += P V: P's fragment of keys 16 kk.. is the A fragment as it lies.
      uint32_t pa[kWgBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      uint32_t v_tile = k_tile + L::kTileBytes;
      asm volatile("" : "+r"(v_tile));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        wgmma_rs_tb<Dh>(acc, pa[kk], sw128_desc(v_tile + kk * 16 * 128, L::kKPanel, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      next_stage();
    }
    for (int kt = w1 + 1; kt <= c1; ++kt) {
      mbar_wait(full_bar + 8 * stage, phase);
      next_stage();
    }

    // Epilogue: acc / max(l, 1e-30) to bf16, rows < Sq only.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      l[h] = fmaxf(l[h], 1e-30f);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + row0 + 8 * h;
      if (r >= Sq) continue;
      __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * Sq + r) * Dh + col0;
#pragma unroll
      for (int j = 0; j < Dh / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] / l[h], acc[4 * j + 2 * h + 1] / l[h]);
    }
  }
}

// ---- the float32 design: split-TF32 mma.sync, cp.async --------------------

constexpr int kF32BQ = 64;  // query rows per CTA
constexpr int kF32BK = 32;  // keys per K/V tile

// Per head dim, the shared memory in floats: the scaled Q tile, then two
// stages of a K tile and a V tile. Row strides: Q and K rows Dh + 16 floats
// (a quarter warp's 16-byte loads of rows g, g + 1 at 4 t hit 32 distinct
// banks), V rows Dh + 4 (the same for rows 2t at 4 g).
template <int Dh>
struct F32Layout {
  static constexpr int kThreads = 32 * kF32BQ / 16;  // a warp per 16 query rows
  static constexpr int kQS = Dh + 16;
  static constexpr int kVS = Dh + 4;
  static constexpr int kK = kF32BQ * kQS;  // stage s: its K tile at kK + s kStage
  static constexpr int kV = kF32BK * kQS;  // and its V tile kV further
  static constexpr int kStage = kF32BK * (kQS + kVS);
  static constexpr uint32_t kBytes = sizeof(float) * (kK + 2 * kStage);
};

// x rounded to TF32 (10 explicit mantissa bits), ties away from zero: half
// a TF32 unit added to the magnitude bits, then the 13 low bits cleared (the
// sign takes no carry for finite x; inf stays inf). What cvt.rna.tf32.f32
// computes for finite x, in two integer operations where ptxas makes that
// instruction a longer sequence with NaN handling.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small + e with big and small TF32 and |e| <= 2^-22 |x|: x - big
// is exact, and rounding it keeps 11 of its bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a b: A 16 x 8 row-major, B 8 x 8 column-major, both TF32; f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d + dx += a b in split TF32: big x big into d, the two cross terms into dx.
// The tensor cores' f32 accumulation truncates, so the small terms keep an
// accumulator of their own size instead of meeting big x big's partial sums
// (half the error of one accumulator, at the same speed: PERF.md).
__device__ __forceinline__ void mma_split(float (&d)[4], float (&dx)[4], const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                          const uint32_t (&bs)[2]) {
  mma_tf32(dx, as, bb[0], bb[1]);
  mma_tf32(dx, ab, bs[0], bs[1]);
  mma_tf32(d, ab, bb[0], bb[1]);
}

// 16 bytes from global to shared memory, asynchronously; zeros where !in
// (then nothing is read from src).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

template <int Dh>
__global__ void __launch_bounds__(F32Layout<Dh>::kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int BH, int G, int Sq,
                     int Sk, int causal, int has_window, int window, float scale) {
  using L = F32Layout<Dh>;
  constexpr int kQS = L::kQS, kVS = L::kVS;
  constexpr int kNT = kF32BK / 8;  // 8-key n-tiles of S
  constexpr int kChunks = Dh / 4;  // 16-byte chunks of a row
  extern __shared__ float4 f32_smem[];
  float* sQ = reinterpret_cast<float*>(f32_smem);
  const uint32_t s_base = smem_u32(sQ);
  const int tid = threadIdx.x;

  // CTA -> (query tile, head), the tiles with the longest causal rows first.
  const int nqt = (Sq + kF32BQ - 1) / kF32BQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.x / BH)) * kF32BQ;
  const int off = Sk - Sq;
  const int q_lo = q0 + off, q_hi = min(q0 + kF32BQ, Sq) - 1 + off;
  const int nkt = (Sk + kF32BK - 1) / kF32BK;
  const float* kb = k + static_cast<size_t>(bh / G) * Sk * Dh;
  const float* vb = v + static_cast<size_t>(bh / G) * Sk * Dh;

  // K and V tile kt into stage st, rows past Sk as zeros; one commit group.
  auto load_kv = [&](int kt, int st) {
    const int k0 = kt * kF32BK;
    const uint32_t dst = s_base + sizeof(float) * (L::kK + st * L::kStage);
    for (int i = tid; i < kF32BK * kChunks; i += L::kThreads) {
      const int r = i / kChunks, c = 4 * (i % kChunks);
      const bool in = k0 + r < Sk;
      const size_t src = static_cast<size_t>(in ? k0 + r : 0) * Dh + c;
      cp_async16(dst + sizeof(float) * (r * kQS + c), kb + src, in);
      cp_async16(dst + sizeof(float) * (L::kV + r * kVS + c), vb + src, in);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // The CTA's live tiles [c0, c1] (contiguous: causal cuts a suffix, the
  // window a prefix; never empty, each query row keeps its own key), and
  // this warp's [w0, w1] inside them.
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = 16 * warp;  // the warp's first row in the tile
  const int wq_lo = q_lo + row0, wq_hi = wq_lo + 15;
  int c0 = nkt, c1 = -1, w0 = nkt, w1 = -1;
  for (int kt = 0; kt < nkt; ++kt) {
    if (!tile_live(kt, Sk, q_lo, q_hi, causal, has_window, window, kF32BK)) continue;
    c0 = min(c0, kt);
    c1 = kt;
    if (tile_live(kt, Sk, wq_lo, wq_hi, causal, has_window, window, kF32BK)) {
      w0 = min(w0, kt);
      w1 = kt;
    }
  }
  if (c0 <= c1) load_kv(c0, 0);

  // The Q tile, times the scale, rows past Sq as zeros (read while the
  // first K/V tile is in flight).
  for (int i = tid; i < kF32BQ * kChunks; i += L::kThreads) {
    const int r = i / kChunks, c = 4 * (i % kChunks);
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < Sq) {
      x = *reinterpret_cast<const float4*>(q + (static_cast<size_t>(bh) * Sq + q0 + r) * Dh + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(sQ + r * kQS + c) = x;
  }

  // This thread's rows g and g + 8 of the warp's 16 (index h): the running
  // max, its share of the row sum, and acc[j][i], row g + 8 (i / 2) and
  // d = 32 (j / 4) + 8 t + 4 (i % 2) + j % 4.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[Dh / 8][4];
#pragma unroll
  for (int j = 0; j < Dh / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

  int stage = 0;
  for (int kt = c0; kt <= c1; ++kt, stage ^= 1) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // Tile kt (and, the first time, Q) is in place for every thread, and
    // every warp is done with the other stage, which the next tile fills.
    __syncthreads();
    if (kt < c1) load_kv(kt + 1, stage ^ 1);
    if (kt < w0 || kt > w1) continue;  // uniform over the warp
    const float* sK = sQ + L::kK + stage * L::kStage;
    const float* sV = sK + L::kV;

    // S = Q K^T, two 8-deep k-steps per 16 of Dh; s[nt][i] is row
    // g + 8 (i / 2), key 8 nt + 2 t + i % 2.
    float s[kNT][4], sx[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = sx[nt][i] = 0.0f;
#pragma unroll
    for (int p = 0; p < Dh / 16; ++p) {
      // A fragments of both k-steps: rows g and g + 8, k-indices t and t + 4
      // of step 0 at d = 16 p + 4 t + {0, 1}, of step 1 at + {2, 3}.
      const float* qr = sQ + (row0 + g) * kQS + 16 * p + 4 * t;
      const float4 x = *reinterpret_cast<const float4*>(qr);
      const float4 y = *reinterpret_cast<const float4*>(qr + 8 * kQS);
      uint32_t ab[2][4], as[2][4];
      split_tf32(x.x, ab[0][0], as[0][0]);
      split_tf32(y.x, ab[0][1], as[0][1]);
      split_tf32(x.y, ab[0][2], as[0][2]);
      split_tf32(y.y, ab[0][3], as[0][3]);
      split_tf32(x.z, ab[1][0], as[1][0]);
      split_tf32(y.z, ab[1][1], as[1][1]);
      split_tf32(x.w, ab[1][2], as[1][2]);
      split_tf32(y.w, ab[1][3], as[1][3]);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        // B fragments: key 8 nt + g at the same four d.
        const float4 z = *reinterpret_cast<const float4*>(sK + (8 * nt + g) * kQS + 16 * p + 4 * t);
        uint32_t bb[2][2], bs[2][2];
        split_tf32(z.x, bb[0][0], bs[0][0]);
        split_tf32(z.y, bb[0][1], bs[0][1]);
        split_tf32(z.z, bb[1][0], bs[1][0]);
        split_tf32(z.w, bb[1][1], bs[1][1]);
        mma_split(s[nt], sx[nt], ab[0], as[0], bb[0], bs[0]);
        mma_split(s[nt], sx[nt], ab[1], as[1], bb[1], bs[1]);
      }
    }

    // Join the cross terms, then the masks where this tile crosses the
    // diagonal, the window's edge or Sk.
    const int k0 = kt * kF32BK;
    const bool edge = (causal && k0 + kF32BK - 1 > wq_lo) ||
                      (has_window && k0 <= wq_hi - window) || (k0 + kF32BK > Sk);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nt][i] + sx[nt][i];
        if (edge) {
          const int qpos = wq_lo + g + 8 * (i / 2);
          const int kpos = k0 + 8 * nt + 2 * t + (i % 2);
          bool keep = true;
          if (causal) keep = kpos <= qpos;
          if (has_window) keep = keep && (kpos > qpos - window);
          x = keep ? x : kMasked;
          if (kpos >= Sk) x = -INFINITY;  // past the last key: weight exactly 0
        }
        s[nt][i] = x;
      }

    // Online softmax: a row's other 24 columns sit in lanes xor 1 and xor 2.
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[h] = expf(m[h] - mx);
      m[h] = mx;
      l[h] *= corr[h];
    }
    // P, split: the A fragment of keys 8 kk.. takes key 2t as k-index t and
    // key 2t + 1 as t + 4.
    uint32_t pb[kNT][4], ps[kNT][4];
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = expf(s[kk][i] - m[i / 2]);
        l[i / 2] += pr[i];
      }
      split_tf32(pr[0], pb[kk][0], ps[kk][0]);
      split_tf32(pr[2], pb[kk][1], ps[kk][1]);
      split_tf32(pr[1], pb[kk][2], ps[kk][2]);
      split_tf32(pr[3], pb[kk][3], ps[kk][3]);
    }

    // acc = acc corr + P V, 32 output columns at a time: the tile's P V in
    // fresh accumulators, joined to acc on the FP32 lanes.
#pragma unroll
    for (int dq = 0; dq < Dh / 32; ++dq) {
      float pv[4][4], pvx[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[j][i] = pvx[j][i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kNT; ++kk) {
        // n-tile j is d = 32 dq + 4 g + j: V rows 2t and 2t + 1 of the 8 keys.
        const float* vr = sV + (8 * kk + 2 * t) * kVS + 32 * dq + 4 * g;
        const float4 x0 = *reinterpret_cast<const float4*>(vr);
        const float4 x1 = *reinterpret_cast<const float4*>(vr + kVS);
        const float r0[4] = {x0.x, x0.y, x0.z, x0.w}, r1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bb[2], bs[2];
          split_tf32(r0[j], bb[0], bs[0]);
          split_tf32(r1[j], bb[1], bs[1]);
          mma_split(pv[j], pvx[j], pb[kk], ps[kk], bb, bs);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[4 * dq + j][i] = acc[4 * dq + j][i] * corr[i / 2] + (pv[j][i] + pvx[j][i]);
    }
  }

  // Epilogue: acc / max(l, 1e-30), rows < Sq only; row g + 8 h's d =
  // 32 dq + 8 t + 0..7 are two float4 stores.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float denom = fmaxf(sum, 1e-30f);
    const int r = q0 + row0 + g + 8 * h;
    if (r >= Sq) continue;
    float* orow = o + (static_cast<size_t>(bh) * Sq + r) * Dh + 8 * t;
#pragma unroll
    for (int dq = 0; dq < Dh / 32; ++dq) {
      const int j = 4 * dq;
      *reinterpret_cast<float4*>(orow + 32 * dq) =
          make_float4(acc[j][2 * h] / denom, acc[j + 1][2 * h] / denom,
                      acc[j + 2][2 * h] / denom, acc[j + 3][2 * h] / denom);
      *reinterpret_cast<float4*>(orow + 32 * dq + 4) =
          make_float4(acc[j][2 * h + 1] / denom, acc[j + 1][2 * h + 1] / denom,
                      acc[j + 2][2 * h + 1] / denom, acc[j + 3][2 * h + 1] / denom);
    }
  }
}

// cuTensorMapEncodeTiled is a driver-API function: take it through the
// runtime's entry-point query, so the library needs no -lcuda.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A (Dh, rows, heads) bf16 tensor map with boxes of 64 x box_rows x 1, 128 B
// swizzle; rows past `rows` read as zeros.
CUresult encode_map(CUtensorMap* map, const void* ptr, int Dh, int rows, int heads,
                    int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Dh), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Dh) * 2,
                                 static_cast<cuuint64_t>(rows) * Dh * 2};
  const cuuint32_t box[3] = {kPanel, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Codes the C entry point returns beside CUDA's own errors.
constexpr int kErrNoEncoder = 10000;      // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 11000;         // + the CUresult of a refused tensor map
constexpr int kErrRegisters = 20000;      // too few registers at launch for setmaxnreg
constexpr int kErrGrid = 20001;           // more CTAs than a grid's x dimension takes
// The registers the roles claim with setmaxnreg; the launch must hold them,
// or the consumers' setmaxnreg.inc would wait forever.
constexpr int kRegsClaimed = 128 * 24 + kConsumerThreads * 240;

constexpr int kMaxDevices = 64;  // devices whose kernel checks are cached

// Runs `setup` (0 or an error code) on the current device until it succeeds
// once, then never again there: a kernel's checks and opt-ins hold for the
// kernel as loaded on a device, and cost more host time than a launch at the
// serving shape. Two threads may both run it once; that is harmless.
template <typename Setup>
int once_per_device(std::atomic<bool> (&ready)[kMaxDevices], Setup setup) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < kMaxDevices;
  if (cached && ready[dev].load(std::memory_order_acquire)) return 0;
  if (const int code = setup()) return code;
  if (cached) ready[dev].store(true, std::memory_order_release);
  return 0;
}

// The register check and the shared-memory opt-in of flash_fwd_wgmma_kernel
// <Dh>.
template <int Dh>
int prepare_wgmma() {
  static std::atomic<bool> ready[kMaxDevices];
  return once_per_device(ready, [] {
    const auto kernel = flash_fwd_wgmma_kernel<Dh>;
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (attr.numRegs * kWgThreads < kRegsClaimed) return kErrRegisters;
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WgLayout<Dh>::kBytes));
  });
}

template <int Dh>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int BH, int G, int Sq,
                 int Sk, int causal, int has_window, int window, float scale,
                 cudaStream_t stream) {
  using L = WgLayout<Dh>;
  const auto kernel = flash_fwd_wgmma_kernel<Dh>;
  const long long ctas = static_cast<long long>((Sq + kWgBQ - 1) / kWgBQ) * BH;
  if (ctas > 0x7fffffffLL) return kErrGrid;
  if (encode_tiled() == nullptr) return kErrNoEncoder;
  CUtensorMap map_q, map_k, map_v;
  CUresult res = encode_map(&map_q, q, Dh, Sq, BH, kWgBQ);
  if (res == CUDA_SUCCESS) res = encode_map(&map_k, k, Dh, Sk, BH / G, kWgBK);
  if (res == CUDA_SUCCESS) res = encode_map(&map_v, v, Dh, Sk, BH / G, kWgBK);
  if (res != CUDA_SUCCESS) return kErrEncode + static_cast<int>(res);
  if (const int code = prepare_wgmma<Dh>()) return code;
  kernel<<<static_cast<unsigned>(ctas), kWgThreads, L::kBytes, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), BH, G, Sq, Sk, causal, has_window,
      window, scale);
  return cudaGetLastError();
}

// The shared-memory opt-in of flash_fwd_f32_kernel<Dh>.
template <int Dh>
int prepare_f32() {
  static std::atomic<bool> ready[kMaxDevices];
  return once_per_device(ready, [] {
    return static_cast<int>(cudaFuncSetAttribute(
        flash_fwd_f32_kernel<Dh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        F32Layout<Dh>::kBytes));
  });
}

template <int Dh>
int launch_f32(const void* q, const void* k, const void* v, void* o, int BH, int G, int Sq,
               int Sk, int causal, int has_window, int window, float scale, cudaStream_t stream) {
  using L = F32Layout<Dh>;
  const long long ctas = static_cast<long long>((Sq + kF32BQ - 1) / kF32BQ) * BH;
  if (ctas > 0x7fffffffLL) return kErrGrid;
  if (const int code = prepare_f32<Dh>()) return code;
  flash_fwd_f32_kernel<Dh><<<static_cast<unsigned>(ctas), L::kThreads, L::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), BH, G, Sq, Sk, causal, has_window, window, scale);
  return cudaGetLastError();
}

template <typename T>
int launch_dh(int Dh, const void* q, const void* k, const void* v, void* o, int BH, int G,
              int Sq, int Sk, int causal, int has_window, int window, float scale,
              cudaStream_t stream);

// float32 goes to the split-TF32 design.
template <>
int launch_dh<float>(int Dh, const void* q, const void* k, const void* v, void* o, int BH,
                     int G, int Sq, int Sk, int causal, int has_window, int window, float scale,
                     cudaStream_t stream) {
  switch (Dh) {
    case 64:
      return launch_f32<64>(q, k, v, o, BH, G, Sq, Sk, causal, has_window, window, scale, stream);
    case 128:
      return launch_f32<128>(q, k, v, o, BH, G, Sq, Sk, causal, has_window, window, scale, stream);
    case 256:
      return launch_f32<256>(q, k, v, o, BH, G, Sq, Sk, causal, has_window, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// bf16 goes to the wgmma design.
template <>
int launch_dh<__nv_bfloat16>(int Dh, const void* q, const void* k, const void* v, void* o,
                             int BH, int G, int Sq, int Sk, int causal, int has_window,
                             int window, float scale, cudaStream_t stream) {
  switch (Dh) {
    case 64:
      return launch_wgmma<64>(q, k, v, o, BH, G, Sq, Sk, causal, has_window, window, scale, stream);
    case 128:
      return launch_wgmma<128>(q, k, v, o, BH, G, Sq, Sk, causal, has_window, window, scale,
                               stream);
    case 256:
      return launch_wgmma<256>(q, k, v, o, BH, G, Sq, Sk, causal, has_window, window, scale,
                               stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The C entry point: bf16 = 0 for float32 tensors, 1 for bfloat16. Pointers
// are contiguous device buffers: q and o (BH, Sq, Dh), k and v (BH / G, Sk,
// Dh), 16 B aligned. Launches on `stream` without synchronising;
// returns 0 when the launch was accepted, else a CUDA error or one of the
// kErr* codes above.
extern "C" int flash_attention_launch(int bf16, const void* q, const void* k, const void* v,
                                      void* o, int BH, int G, int Sq, int Sk, int Dh, int causal,
                                      int has_window, int window, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dh<__nv_bfloat16>(Dh, q, k, v, o, BH, G, Sq, Sk, causal, has_window,
                                         window, scale, s)
              : launch_dh<float>(Dh, q, k, v, o, BH, G, Sq, Sk, causal, has_window, window,
                                 scale, s);
}
