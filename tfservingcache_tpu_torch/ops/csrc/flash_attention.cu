// Flash attention forward (B2) and the ring-attention carry step (B4) for
// Hopper (sm_90a): bf16 and f32 inputs.
//
// B2, `flash_fwd_kernel` (bf16) / `flash_fwd_f32_kernel`: replaces the
// Pallas TPU kernel `flash_attention` (tfservingcache_tpu/ops/attention.py
// :211, bodies `_flash_kernel` :75 and `_flash_streamed_kernel` :143). Same
// arithmetic:
//   - scores q.k^T in f32 (bf16 tensor-core products, f32 accumulation),
//     scaled by 1/sqrt(D);
//   - online softmax over K tiles in f32 (running max m, running sum l);
//   - p rounded to bf16 before the p.v product, l summed from the f32 p;
//   - key mask k_pos < S, and q_pos >= k_pos when causal; a causal block
//     stops its K loop at the diagonal;
//   - GQA: query head h reads K/V head h / (Hq / Hkv);
//   - out = acc / max(l, 1e-30), rounded to bf16.
// The TPU version splits into a VMEM-resident and a streamed kernel; here
// one kernel streams K/V tiles through shared memory for every length.
//
// Bound on this card: causal prefill does 2*S*S*D flops per head against
// 4*S*D bytes of q/k/v/o, so above S ~ 600 it is bound by tensor-core
// operations, below that by memory. The bf16 kernel is built for Hopper's
// tensor-core path:
//   - a persistent grid: one block per streaming multiprocessor walks work
//     tiles of 128 query rows (64 for short sequences and for D = 256),
//     dealt longest causal tiles first;
//   - a block is one producer warpgroup and two (or one) consumer
//     warpgroups of 64 query rows each; setmaxnreg moves the producer's
//     registers to the consumers;
//   - one producer thread issues TMA loads: Q once a tile, K and V tiles
//     through a two-stage ring in shared memory, each stage with a `full`
//     barrier for K, one for V (expect_tx) and an `empty` barrier the
//     consumers arrive on once both products have read it; Q is released
//     after the tile's last Q.K^T, so the next tile's Q and first K/V tiles
//     load while the consumers finish. The tensor maps are 3-D (D, S, B*H)
//     with 128-byte swizzle, so rows past S of a tile read as zeros (never
//     the next head's rows); a 128-byte box holds 64 columns, so a tile is
//     D/64 column panels;
//   - S = Q.K^T is wgmma with both operands in shared memory, K-major;
//   - O += P.V is wgmma with P from registers (the score accumulator packed
//     to bf16 in place: the reference's p.astype(bf16)) and V read from
//     shared memory as it lies, MN-major, through the transpose flag;
//   - softmax in f32 on the accumulator fragments, exp2 (ex2.approx) with
//     log2(e) folded into the scale; a row is held by four threads. Masks
//     run only on the tiles that straddle the diagonal or S's end;
//   - the epilogue stages each warpgroup's bf16 rows in shared memory and
//     stores them with TMA, which never writes rows past S.
// The two consumer warpgroups overlap each other's softmax and products;
// one warpgroup's softmax does not yet overlap its own next Q.K^T.
//
// B4, `flash_attention_carry_kernel` / `flash_attention_carry_f32_kernel`:
// replaces the Pallas TPU kernel `flash_attention_carry` (attention.py:393,
// body `_flash_carry_kernel` :323), one hop of ring attention: local Q
// (Sq rows) against one K/V block (Sk keys) with the online-softmax state
// carried in f32 from hop to hop. The bf16 kernel is B2's design (persistent
// grid, producer warpgroup, TMA, wgmma for both products) with these
// changes:
//   - the grid walks only the live query tiles: those whose last row sees a
//     key of the block. They are a suffix of the tiles (counted on the host
//     from rel, no sync), dealt longest first in B2's snake order; a hop no
//     row sees launches one block that returns at once, reading and writing
//     nothing. A tile reads the K tiles up to the Pallas predicate
//     q_last - j*BN >= rel (attention.py:375-378); a warpgroup none of
//     whose rows sees a tile keeps the barriers' count and skips its math;
//   - the state (acc, m, l) starts the tile instead of zeros / NEG_INF: the
//     producer loads the tile's f32 acc into shared memory with TMA (a 3-D
//     f32 map, 32-column panels, 128-byte swizzle) before its Q, so the next
//     tile's carry is in flight while the consumers finish this one; they
//     move it into their accumulator fragments at the tile's start and free
//     the buffer. m and l come from global memory. The new state leaves from
//     the fragments after the last P.V, unnormalized, in 8-byte stores (m in
//     natural units; the body works in log2 units and converts at both
//     ends). Only rows that see a key (r >= rel) are written, so a blind
//     row's carry stays bit-identical (-0.0 included). The block stages no
//     output, so the carry's buffer fits where B2's output staging was (one
//     consumer warpgroup for D > 128);
//   - the mask is the runtime offset rel = k_off - q_off: local row r sees
//     local key c when r - c >= rel (no causal mask = rel <= -Sk). It runs
//     only on a tile past Sk's end or one the warpgroup's first row does
//     not wholly see; a masked score is -inf, so p = 0 exactly even while
//     the row's max is NEG_INF, and alpha = exp2(min(m_prev - m_new, 0)):
//     the reference's two guards (attention.py:361-365).
// The carry is updated in place (the ring owns it). A ring hop at the
// serving shape (32 heads, Sq = Sk = 1024, D 128, a past block) does 17.2
// GFLOP against ~59 MB, more than half of it the f32 carry read and
// written: the two bounds are within 2% (~0.018 ms each at the H100 SXM's
// published peaks).
//
// f32 inputs take plain SIMT kernels with the reference's f32 rounding: f32
// scores, p kept in f32 for the p.v product (the reference's
// `p.astype(v.dtype)` is a no-op there), f32 out. One block of 4 warps per
// (batch*head, 16 query rows); each K/V tile of 32 keys sits in shared
// memory; a lane scores one key of the tile with FMAs, the warp takes the
// tile's max and sum with shuffles, and each lane accumulates D/32 output
// columns. No tensor cores (no TF32), so f32 is exact to the reference's
// rounding up to summation order. B4's f32 kernel is B2's with the carry
// changes above, written out apart from it: sharing one template moved
// B2's register allocation (on an H100 80GB HBM3 at 700 W: 0.085 -> 0.124
// ms at (1,8,8,256,128) causal, outputs bitwise equal).
//
// Entry points: tpusc_flash_attention_fwd (bf16),
// tpusc_flash_attention_fwd_f32 and tpusc_flash_attention_carry (either
// dtype); plain C, loaded with ctypes. Each launches on the given stream,
// allocates nothing and returns cudaGetLastError() of the launch. The bf16
// entries encode their tensor maps with libcuda's cuTensorMapEncodeTiled,
// taken through cudaGetDriverEntryPoint (no link to libcuda).
//
// Built with -DTPUSC_CARRY_LOADS_ONLY=1 (tools/flash_kernel_ab.py
// SOURCE:TPUSC_CARRY_LOADS_ONLY=1), the bf16 carry kernel streams Q, K and V
// through its barriers and loads and stores the carry, but skips both
// products and the softmax: an ablation that tells the memory pipeline's
// time from the compute's. Its outputs are not attention.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>  // INFINITY
#include <stdint.h>

#ifndef TPUSC_CARRY_LOADS_ONLY
#define TPUSC_CARRY_LOADS_ONLY 0
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;  // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- B2, bf16: TMA + wgmma, one producer warpgroup ------------------------

constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int PANEL = 64;        // bf16 columns in one 128-byte swizzled row

template <int D, int CONSUMERS>
struct HopperTile {
  static constexpr int BM = 64 * CONSUMERS;     // query rows per block
  static constexpr int BN = D <= 128 ? 128 : 64;  // keys per K/V tile
  static constexpr int STAGES = 2;
  static constexpr int PANELS = D / PANEL;
  static constexpr int PV_N = D % 128 == 0 ? 128 : 64;  // output columns per P.V wgmma
  static constexpr uint32_t Q_BYTES = BM * D * 2;   // Q, and the output staged for its store
  static constexpr uint32_t KV_BYTES = BN * D * 2;  // one K (or V) tile
  static constexpr int THREADS = WG_THREADS * (CONSUMERS + 1);
  // 1024 of slack to align the tiles to the swizzle's 1024-byte period,
  // then Q, the K stages, the V stages, the output and the barriers
  static constexpr size_t SMEM_BYTES = 1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (2 + 3 * STAGES);
  static_assert(SMEM_BYTES <= 232448, "more shared memory than a block may use");
};

// B4's block: B2's tiles, plus the f32 carry of a tile's BM rows in shared
// memory (D/32 panels of 32 columns, 128-byte swizzled), and no output
// staging (its output leaves from registers)
template <int D, int CONSUMERS>
struct CarryTile : HopperTile<D, CONSUMERS> {
  using H = HopperTile<D, CONSUMERS>;
  static constexpr int STAGES = 2;
  static constexpr int C_PANEL = 32;  // f32 columns in one 128-byte swizzled row
  static constexpr uint32_t C_BYTES = H::BM * D * 4;
  // the slack, Q, the carry, the K stages, the V stages and the barriers
  static constexpr size_t SMEM_BYTES = 1024 + H::Q_BYTES + C_BYTES + 2 * STAGES * H::KV_BYTES + 8 * (4 + 3 * STAGES);
  static_assert(SMEM_BYTES <= 232448, "more shared memory than a block may use");
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

// returns once the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// the async proxy's store from shared memory: rows past the map's S are
// not written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ float2 ld_shared_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t val) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(val) : "memory");
}

// the 128 threads of consumer warpgroup c (named barrier 1 + c)
__device__ __forceinline__ void warpgroup_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
}

// 2^x on the special function unit (x <= 0 here; results below 2^-126
// flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (128B).
// K-major (Q, K): SBO = 1024, the step between 8-row groups; LBO unused.
// MN-major (V): LBO = the step between 64-column panels, SBO = 1024, the
// step between groups of 8 keys.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d(64 x N) (+)= A(64 x 16) B(16 x N), bf16 in, f32 accumulate. wgmma_ss:
// A and B in shared memory, both K-major; scale_d = 0 overwrites d.
// wgmma_rs: A in registers (the m16n8k16 A fragment of the warp's 16 rows),
// B MN-major in shared memory (transpose flag set); accumulates.
// Accumulator layout: warp w, lane (g = lane / 4, t = lane % 4) holds rows
// 16w + g and 16w + g + 8 of columns 8j + 2t, 8j + 2t + 1 in d[4j .. 4j+3].
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One work tile: BM query rows of one (batch, head) and the K tiles they
// see. Tiles are numbered longest causal tiles first over the whole grid.
struct WorkTile {
  int q0, bh, kv_row, n_tiles;
};

template <int BM, int BN, bool CAUSAL>
__device__ __forceinline__ WorkTile work_tile(int w, int BH, int Hq, int Hkv, int S) {
  WorkTile t;
  const int n_q = (S + BM - 1) / BM;
  t.q0 = (n_q - 1 - w / BH) * BM;
  t.bh = w % BH;  // b * Hq + h
  t.kv_row = (t.bh / Hq) * Hkv + (t.bh % Hq) / (Hq / Hkv);
  t.n_tiles = CAUSAL ? (min(t.q0 + BM, S) + BN - 1) / BN : (S + BN - 1) / BN;
  return t;
}

// The k-th tile of this block, or -1 past the last: tiles are dealt to the
// blocks in snake order (0 .. G-1, then G-1 .. 0, ...), so that every
// block's sum of causal lengths is about the same.
__device__ __forceinline__ int nth_tile(int k, int total) {
  const int w = k * gridDim.x + ((k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  return w < total ? w : -1;
}

// Persistent: one block per streaming multiprocessor walks its work tiles.
// The producer loads the next tile's Q and first K/V tiles while the
// consumers finish the current one (Q is released after its last Q.K^T).
template <int D, bool CAUSAL, int CONSUMERS>
__global__ void __launch_bounds__(HopperTile<D, CONSUMERS>::THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                     int BH, int Hq, int Hkv, int S, float scale_log2) {
  using T = HopperTile<D, CONSUMERS>;
  constexpr int BM = T::BM;
  constexpr int BN = T::BN;
  constexpr int ST = T::STAGES;
  constexpr int PV_N = T::PV_N;
  constexpr int CHUNKS = D / PV_N;
  const int total = BH * ((S + BM - 1) / BM);

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                      // PANELS x (BM rows x 128 B)
  const uint32_t sK = sQ + T::Q_BYTES;           // ST x PANELS x (BN rows x 128 B)
  const uint32_t sV = sK + ST * T::KV_BYTES;     // the same for V
  const uint32_t sO = sV + ST * T::KV_BYTES;     // per consumer: PANELS x (64 rows x 128 B)
  const uint32_t q_full = sO + T::Q_BYTES;       // then q_empty, k_full[ST], v_full[ST], empty[ST]
  const uint32_t q_empty = q_full + 8;
  auto k_full = [&](int s) { return q_full + 8u * (2 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (2 + ST + s); };
  auto empty = [&](int s) { return q_full + 8u * (2 + 2 * ST + s); };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMERS * WG_THREADS);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMERS * WG_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {
    // ---- producer warpgroup: one thread keeps the TMA loads in flight
    if constexpr (CONSUMERS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;  // K/V tiles loaded so far, over all work tiles: stage it % ST
      for (int k = 0;; ++k) {
        const int w = nth_tile(k, total);
        if (w < 0) break;
        const WorkTile wt = work_tile<BM, BN, CAUSAL>(w, BH, Hq, Hkv, S);
        mbar_wait(q_empty, (k & 1) ^ 1);  // the consumers are done with the last tile's Q
        mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
        for (int p = 0; p < T::PANELS; ++p)
          tma_load_3d(sQ + p * BM * 128, &tm_q, q_full, p * PANEL, wt.q0, wt.bh);
        for (int j = 0; j < wt.n_tiles; ++j, ++it) {
          const int s = it % ST;
          mbar_wait(empty(s), ((it / ST) & 1) ^ 1);  // the first round finds every stage empty
          mbar_expect_tx(k_full(s), T::KV_BYTES);
#pragma unroll
          for (int p = 0; p < T::PANELS; ++p)
            tma_load_3d(sK + s * T::KV_BYTES + p * BN * 128, &tm_k, k_full(s), p * PANEL, j * BN, wt.kv_row);
          mbar_expect_tx(v_full(s), T::KV_BYTES);
#pragma unroll
          for (int p = 0; p < T::PANELS; ++p)
            tma_load_3d(sV + s * T::KV_BYTES + p * BN * 128, &tm_v, v_full(s), p * PANEL, j * BN, wt.kv_row);
        }
      }
    }
  } else {
    // ---- consumer warpgroup c: query rows q0 + 64c .. q0 + 64c + 63 of each tile
    if constexpr (CONSUMERS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = threadIdx.x / WG_THREADS - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int lane = tid & 31;
    const int t = lane & 3;
    const int row_in_wg = (tid >> 5) * 16 + (lane >> 2);  // and row_in_wg + 8
    const uint32_t q_rows = sQ + 64 * c * 128;  // this warpgroup's rows of each Q panel
    const uint32_t o_rows = sO + c * 64 * D * 2;  // this warpgroup's output staging

    float acc[CHUNKS][PV_N / 2];
    float sc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    int it = 0;
    for (int k = 0;; ++k) {
      const int w = nth_tile(k, total);
      if (w < 0) break;
      const WorkTile wt = work_tile<BM, BN, CAUSAL>(w, BH, Hq, Hkv, S);
      const int wg_row0 = wt.q0 + 64 * c;
      const int row_lo = wg_row0 + row_in_wg;

#pragma unroll
      for (int ch = 0; ch < CHUNKS; ++ch)
#pragma unroll
        for (int i = 0; i < PV_N / 2; ++i) acc[ch][i] = 0.f;
      float m[2] = {NEG_INF, NEG_INF};  // running max (log2 units), rows row_lo and row_lo + 8
      float l[2] = {0.f, 0.f};          // this thread's part of the running sum of f32 p
      mbar_wait(q_full, k & 1);

      for (int j = 0; j < wt.n_tiles; ++j, ++it) {
        const int s = it % ST;
        const uint32_t parity = (it / ST) & 1;
        const int k0 = j * BN;

        // s = q k^T: D/16 steps of 16 columns, 4 per 64-column panel
        mbar_wait(k_full(s), parity);
        const uint32_t k_tile = sK + s * T::KV_BYTES;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;
          wgmma_ss(sc, sw128_desc(q_rows + (kk / 4) * BM * 128 + col, 0, 1024),
                   sw128_desc(k_tile + (kk / 4) * BN * 128 + col, 0, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        if (j == wt.n_tiles - 1) mbar_arrive(q_empty);  // the producer may load the next Q

        // mask (only a tile past S's end or across this warpgroup's diagonal)
        if (k0 + BN > S || (CAUSAL && k0 + BN - 1 > wg_row0)) {
#pragma unroll
          for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = row_lo + (e >> 1) * 8;
              const int key = k0 + jj * 8 + t * 2 + (e & 1);
              if (key >= S || (CAUSAL && key > r)) sc[4 * jj + e] = NEG_INF;
            }
          }
        }
        // online softmax in the log2 domain; a row's four threads share its max
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m[h], mx[h] * scale_log2);
          alpha[h] = exp2_approx(m[h] - m_new);
          m[h] = m_new;
          l[h] *= alpha[h];
        }
        // p = exp2(s * scale - m): tile 0 holds key 0, which every row sees,
        // so m is finite from the first tile on and a masked score gives 0
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int h = (i >> 1) & 1;
          sc[i] = exp2_approx(fmaf(sc[i], scale_log2, -m[h]));
          l[h] += sc[i];
        }
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch)
#pragma unroll
          for (int i = 0; i < PV_N / 2; ++i) acc[ch][i] *= alpha[(i >> 1) & 1];

        // acc += bf16(p) v: the score accumulator's layout is the A fragment's
        uint32_t pa[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        }
        mbar_wait(v_full(s), parity);
        const uint32_t v_tile = sV + s * T::KV_BYTES;
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch) fence_regs(acc[ch]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
          for (int ch = 0; ch < CHUNKS; ++ch) {
            // keys 16kk .. 16kk + 15 (two groups of 8 rows), columns of panels
            // ch * PV_N / 64 onward
            wgmma_rs(acc[ch], pa[kk],
                     sw128_desc(v_tile + (ch * PV_N / PANEL) * BN * 128 + kk * 16 * 128, BN * 128, 1024));
          }
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch) fence_regs(acc[ch]);
        mbar_arrive(empty(s));  // both products have read stage s
      }

      // normalize, round to bf16, stage the rows in shared memory in the
      // output map's swizzled layout (16-byte chunk j of row r at j ^ r % 8:
      // a warp's stores hit 32 distinct banks) and store them with TMA,
      // which drops the rows past S. The store runs on while the next tile
      // starts; its buffer is waited for before it is written again.
      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        inv[h] = 1.f / fmaxf(l[h], 1e-30f);
      }
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      warpgroup_sync(c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row_in_wg + h * 8;
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch) {
#pragma unroll
          for (int jj = 0; jj < PV_N / 8; ++jj) {
            const int col = ch * PV_N + jj * 8;
            st_shared_u32(o_rows + (col / PANEL) * 64 * 128 + r * 128 + ((((col % PANEL) / 8) ^ (r % 8)) * 16) +
                              t * 4,
                          pack_bf16x2(acc[ch][4 * jj + 2 * h] * inv[h], acc[ch][4 * jj + 2 * h + 1] * inv[h]));
          }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the TMA store
      warpgroup_sync(c);
      if (tid == 0 && wg_row0 < S) {
#pragma unroll
        for (int p = 0; p < T::PANELS; ++p) tma_store_3d(&tm_o, o_rows + p * 64 * 128, p * PANEL, wg_row0, wt.bh);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// libcuda's cuTensorMapEncodeTiled, found once through the runtime
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p)
                                                                      : nullptr;
  }();
  return fn;
}

// (D, S, BH) bf16 (or f32) map of a contiguous (BH, S, D) tensor, read in
// boxes of one 128-byte row (64 bf16 or 32 f32 columns) x `rows` rows of one
// (batch, head), 128-byte swizzled; rows past S are filled with zeros.
bool encode_map(CUtensorMap* map, const void* ptr, int D, int S, int BH, int rows, bool f32 = false) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t elem = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * elem, (cuuint64_t)S * D * elem};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / elem), (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// D is the tile's head dim; DG the tensors' (D, or 32 in a 64-column tile)
template <int D, bool CAUSAL, int CONSUMERS, int DG>
cudaError_t launch_hopper(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int S,
                          int sms, cudaStream_t stream) {
  using T = HopperTile<D, CONSUMERS>;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!encode_map(&tm_q, q, DG, S, B * Hq, T::BM) || !encode_map(&tm_k, k, DG, S, B * Hkv, T::BN) ||
      !encode_map(&tm_v, v, DG, S, B * Hkv, T::BN) || !encode_map(&tm_o, o, DG, S, B * Hq, 64))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_kernel<D, CAUSAL, CONSUMERS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)T::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)B * Hq * ((S + T::BM - 1) / T::BM);
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(tm_q, tm_k, tm_v, tm_o, B * Hq, Hq, Hkv, S,
                                                       LOG2E / sqrtf((float)DG));
  return cudaGetLastError();
}

// Two consumer warpgroups (128-row tiles), or one (64-row tiles) where
// 128-row tiles would leave streaming multiprocessors idle, and always for
// D = 256 (two would need more shared memory than a block may use).
// head_dim 32 runs in the 64-column tile: the maps are 32 columns wide, so
// TMA fills the tile's other 32 columns of Q, K and V with zeros (they add
// exact zeros to q.k and give zero output columns) and the output store
// writes only the 32 in the map; the scale stays 1/sqrt(32).
template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int S,
                     int causal, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  constexpr int TD = D < PANEL ? PANEL : D;  // the tile's head dim
  constexpr int WIDE = TD <= 192 ? 2 : 1;
  const bool narrow = (long long)B * Hq * ((S + 127) / 128) < sms;
  if (causal) {
    return narrow ? launch_hopper<TD, true, 1, D>(q, k, v, o, B, Hq, Hkv, S, sms, stream)
                  : launch_hopper<TD, true, WIDE, D>(q, k, v, o, B, Hq, Hkv, S, sms, stream);
  }
  return narrow ? launch_hopper<TD, false, 1, D>(q, k, v, o, B, Hq, Hkv, S, sms, stream)
                : launch_hopper<TD, false, WIDE, D>(q, k, v, o, B, Hq, Hkv, S, sms, stream);
}

// ---- B4, bf16: B2's design with the carry ---------------------------------

// One live work tile of a hop: BM query rows of one (batch, head) of which
// at least the last sees a key of the block, and the K tiles they read. K
// tile j is read only if the tile's last row sees its first key,
// q_last - j*BN >= rel (the Pallas predicate, attention.py:375-378);
// visibility grows toward key 0, so the tiles read are a prefix. The live
// tiles are the last `live` query tiles of each (batch, head), numbered
// longest first.
template <int BM, int BN>
__device__ __forceinline__ WorkTile carry_work_tile(int w, int BH, int Hq, int Hkv, int Sq, int Sk, int rel) {
  WorkTile t;
  const int n_q = (Sq + BM - 1) / BM;
  t.q0 = (n_q - 1 - w / BH) * BM;
  t.bh = w % BH;  // b * Hq + h
  t.kv_row = (t.bh / Hq) * Hkv + (t.bh % Hq) / (Hq / Hkv);
  t.n_tiles = min((Sk + BN - 1) / BN, (min(t.q0 + BM, Sq) - 1 - rel) / BN + 1);
  return t;
}

// B2's persistent TMA + wgmma kernel over the live tiles of one hop. The
// producer also loads each tile's f32 carry acc into shared memory (TMA,
// one tile ahead: the next tile's carry is in flight while this one
// computes); the consumers move it into their accumulator fragments at the
// tile's start and store the new carry from them at its end, by row: a row
// that sees no key of the hop (r < rel) is never written. DG is the
// tensors' head dim: D, or 32 in a 64-column tile, whose carry columns past
// DG are neither loaded nor stored (they start at zero and stay there).
template <int D, int CONSUMERS, int DG = D>
__global__ void __launch_bounds__(HopperTile<D, CONSUMERS>::THREADS, 1)
    flash_attention_carry_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_c,
                                 float* __restrict__ acc_io, float* __restrict__ m_io, float* __restrict__ l_io,
                                 int BH, int Hq, int Hkv, int Sq, int Sk, int rel, int live, float scale_log2) {
  using T = CarryTile<D, CONSUMERS>;
  constexpr int BM = T::BM;
  constexpr int BN = T::BN;
  constexpr int ST = T::STAGES;
  constexpr int PV_N = T::PV_N;
  constexpr int CHUNKS = D / PV_N;
  const int total = BH * live;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                   // PANELS x (BM rows x 128 B)
  const uint32_t sC = sQ + T::Q_BYTES;        // D/32 x (BM rows x 128 B), f32
  const uint32_t sK = sC + T::C_BYTES;        // ST x PANELS x (BN rows x 128 B)
  const uint32_t sV = sK + ST * T::KV_BYTES;  // the same for V
  const uint32_t q_full = sV + ST * T::KV_BYTES;  // then q_empty, c_full, c_empty, k_full[ST], v_full[ST], empty[ST]
  const uint32_t q_empty = q_full + 8;
  const uint32_t c_full = q_full + 16;
  const uint32_t c_empty = q_full + 24;
  auto k_full = [&](int s) { return q_full + 8u * (4 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (4 + ST + s); };
  auto empty = [&](int s) { return q_full + 8u * (4 + 2 * ST + s); };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMERS * WG_THREADS);
    mbar_init(c_full, 1);
    mbar_init(c_empty, CONSUMERS * WG_THREADS);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMERS * WG_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {
    // ---- producer warpgroup: one thread keeps the TMA loads in flight
    if constexpr (CONSUMERS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;  // K/V tiles loaded so far, over all work tiles: stage it % ST
      for (int k = 0;; ++k) {
        const int w = nth_tile(k, total);
        if (w < 0) break;
        const WorkTile wt = carry_work_tile<BM, BN>(w, BH, Hq, Hkv, Sq, Sk, rel);
        // the carry first: the consumers freed its buffer at the last
        // tile's start, so it loads while they finish that tile
        mbar_wait(c_empty, (k & 1) ^ 1);
        mbar_expect_tx(c_full, T::C_BYTES / (D / DG));
#pragma unroll
        for (int p = 0; p < DG / T::C_PANEL; ++p)
          tma_load_3d(sC + p * BM * 128, &tm_c, c_full, p * T::C_PANEL, wt.q0, wt.bh);
        mbar_wait(q_empty, (k & 1) ^ 1);  // the consumers are done with the last tile's Q
        mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
        for (int p = 0; p < T::PANELS; ++p)
          tma_load_3d(sQ + p * BM * 128, &tm_q, q_full, p * PANEL, wt.q0, wt.bh);
        for (int j = 0; j < wt.n_tiles; ++j, ++it) {
          const int s = it % ST;
          mbar_wait(empty(s), ((it / ST) & 1) ^ 1);  // the first round finds every stage empty
          mbar_expect_tx(k_full(s), T::KV_BYTES);
#pragma unroll
          for (int p = 0; p < T::PANELS; ++p)
            tma_load_3d(sK + s * T::KV_BYTES + p * BN * 128, &tm_k, k_full(s), p * PANEL, j * BN, wt.kv_row);
          mbar_expect_tx(v_full(s), T::KV_BYTES);
#pragma unroll
          for (int p = 0; p < T::PANELS; ++p)
            tma_load_3d(sV + s * T::KV_BYTES + p * BN * 128, &tm_v, v_full(s), p * PANEL, j * BN, wt.kv_row);
        }
      }
    }
  } else {
    // ---- consumer warpgroup c: query rows q0 + 64c .. q0 + 64c + 63 of each tile
    if constexpr (CONSUMERS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = threadIdx.x / WG_THREADS - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int lane = tid & 31;
    const int t = lane & 3;
    const int row_in_wg = (tid >> 5) * 16 + (lane >> 2);  // and row_in_wg + 8
    const uint32_t q_rows = sQ + 64 * c * 128;  // this warpgroup's rows of each Q panel

    float acc[CHUNKS][PV_N / 2];
    float sc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    int it = 0;
    for (int k = 0;; ++k) {
      const int w = nth_tile(k, total);
      if (w < 0) break;
      const WorkTile wt = carry_work_tile<BM, BN>(w, BH, Hq, Hkv, Sq, Sk, rel);
      const int wg_row0 = wt.q0 + 64 * c;
      const int row_lo = wg_row0 + row_in_wg;
      // the K tiles some row of this warpgroup sees (a prefix): none when
      // every row is blind (r < rel) or past Sq
      const int wg_last = min(wg_row0 + 63, Sq - 1);
      const int wg_tiles = wg_row0 >= Sq || wg_last < rel ? 0 : min(wt.n_tiles, (wg_last - rel) / BN + 1);

      // the carried state: m and l of the rows that see a key (r >= rel)
      // from global memory (m in the body's log2 units; the carried l sits
      // in one of a row's four threads), the other rows start empty and are
      // never stored; acc from the tile's carry in shared memory (16-byte
      // chunk j of a 128-byte row r at j ^ r % 8), whose buffer is then
      // free for the next tile's
      float m[2], l[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row_lo + h * 8;
        const bool seen = r < Sq && r >= rel;
        const size_t row = (size_t)wt.bh * Sq + r;
        m[h] = seen ? m_io[row] * LOG2E : NEG_INF;
        l[h] = seen && t == 0 ? l_io[row] : 0.f;
      }
      mbar_wait(c_full, k & 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rb = 64 * c + row_in_wg + h * 8;  // the row within the tile
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch) {
#pragma unroll
          for (int jj = 0; jj < PV_N / 8; ++jj) {
            const int col = ch * PV_N + jj * 8 + t * 2;
            const float2 a2 = ch * PV_N + jj * 8 >= DG
                                  ? make_float2(0.f, 0.f)
                                  : ld_shared_f32x2(sC + (col / T::C_PANEL) * BM * 128 + rb * 128 +
                                                    ((((col % T::C_PANEL) / 4) ^ (rb % 8)) * 16) + (col % 4) * 4);
            acc[ch][4 * jj + 2 * h] = a2.x;
            acc[ch][4 * jj + 2 * h + 1] = a2.y;
          }
        }
      }
      mbar_arrive(c_empty);
      mbar_wait(q_full, k & 1);

      for (int j = 0; j < wt.n_tiles; ++j, ++it) {
        const int s = it % ST;
        const uint32_t parity = (it / ST) & 1;
        const int k0 = j * BN;

        mbar_wait(k_full(s), parity);
        if (j >= wg_tiles || TPUSC_CARRY_LOADS_ONLY) {
          // no row of this warpgroup sees a key of the tile: keep the
          // barriers' count and skip the math
          if (j == wt.n_tiles - 1) mbar_arrive(q_empty);
          mbar_wait(v_full(s), parity);
          mbar_arrive(empty(s));
          continue;
        }

        // s = q k^T: D/16 steps of 16 columns, 4 per 64-column panel
        const uint32_t k_tile = sK + s * T::KV_BYTES;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;
          wgmma_ss(sc, sw128_desc(q_rows + (kk / 4) * BM * 128 + col, 0, 1024),
                   sw128_desc(k_tile + (kk / 4) * BN * 128 + col, 0, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        if (j == wt.n_tiles - 1) mbar_arrive(q_empty);  // the producer may load the next Q

        // the runtime mask, only on a tile past Sk's end or one that some
        // row of the warpgroup sees in part: local row r sees key c when
        // r - c >= rel. A masked score is -inf, so its p is exactly 0 even
        // while the row's max is still NEG_INF.
        if (k0 + BN > Sk || wg_row0 - (k0 + BN - 1) < rel) {
#pragma unroll
          for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = row_lo + (e >> 1) * 8;
              const int key = k0 + jj * 8 + t * 2 + (e & 1);
              if (key >= Sk || r - key < rel) sc[4 * jj + e] = -INFINITY;
            }
          }
        }
        // online softmax in the log2 domain; a row's four threads share its
        // max. alpha = exp2(min(m_prev - m_new, 0)): the reference's guard
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m[h], mx[h] * scale_log2);
          alpha[h] = exp2_approx(fminf(m[h] - m_new, 0.f));
          m[h] = m_new;
          l[h] *= alpha[h];
        }
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int h = (i >> 1) & 1;
          sc[i] = exp2_approx(fmaf(sc[i], scale_log2, -m[h]));
          l[h] += sc[i];
        }
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch)
#pragma unroll
          for (int i = 0; i < PV_N / 2; ++i) acc[ch][i] *= alpha[(i >> 1) & 1];

        // acc += bf16(p) v: the score accumulator's layout is the A fragment's
        uint32_t pa[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        }
        mbar_wait(v_full(s), parity);
        const uint32_t v_tile = sV + s * T::KV_BYTES;
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch) fence_regs(acc[ch]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
          for (int ch = 0; ch < CHUNKS; ++ch) {
            wgmma_rs(acc[ch], pa[kk],
                     sw128_desc(v_tile + (ch * PV_N / PANEL) * BN * 128 + kk * 16 * 128, BN * 128, 1024));
          }
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch) fence_regs(acc[ch]);
        mbar_arrive(empty(s));  // both products have read stage s
      }

      // the carry back, unnormalized, from the fragments: 8-byte stores of
      // the rows that see a key (m in natural units, l summed over the
      // row's four threads); the stores run on while the next tile starts
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const int r = row_lo + h * 8;
        if (r >= Sq || r < rel) continue;
        const size_t row = (size_t)wt.bh * Sq + r;
        float* ap = acc_io + row * DG + t * 2;
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch) {
#pragma unroll
          for (int jj = 0; jj < PV_N / 8; ++jj)
            if (ch * PV_N + jj * 8 < DG)
              *reinterpret_cast<float2*>(ap + ch * PV_N + jj * 8) =
                  make_float2(acc[ch][4 * jj + 2 * h], acc[ch][4 * jj + 2 * h + 1]);
        }
        if (t == 0) {
          m_io[row] = m[h] / LOG2E;
          l_io[row] = l[h];
        }
      }
    }
  }
}

// The query tiles of BM rows that some row of sees a key of the block: the
// last `live` of the ceil(Sq/BM), a tile's last row being its most visible.
int live_q_tiles(int Sq, int rel, int BM) {
  const int n_q = (Sq + BM - 1) / BM;
  return n_q - (rel <= 0 ? 0 : rel >= Sq ? n_q : rel / BM);
}

template <int D, int CONSUMERS, int DG>
cudaError_t launch_carry_hopper(const void* q, const void* k, const void* v, void* acc, void* m, void* l, int B,
                                int Hq, int Hkv, int Sq, int Sk, int rel, int sms, cudaStream_t stream) {
  using T = CarryTile<D, CONSUMERS>;
  CUtensorMap tm_q, tm_k, tm_v, tm_c;
  if (!encode_map(&tm_q, q, DG, Sq, B * Hq, T::BM) || !encode_map(&tm_k, k, DG, Sk, B * Hkv, T::BN) ||
      !encode_map(&tm_v, v, DG, Sk, B * Hkv, T::BN) || !encode_map(&tm_c, acc, DG, Sq, B * Hq, T::BM, true))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_carry_kernel<D, CONSUMERS, DG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)T::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int live = live_q_tiles(Sq, rel, T::BM);
  const long long tiles = (long long)B * Hq * live;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  // a hop that no row sees launches one block, which returns at once
  const int grid = (int)(tiles < 1 ? 1 : tiles < sms ? tiles : sms);
  kernel<<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(
      tm_q, tm_k, tm_v, tm_c, static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l), B * Hq, Hq, Hkv,
      Sq, Sk, rel, live, LOG2E / sqrtf((float)DG));
  return cudaGetLastError();
}

// Two consumer warpgroups (128-row tiles) or one, as B2 chooses, counting
// only the live 128-row tiles; one for D > 128, where two with the carry's
// buffer would need more shared memory than a block may use. head_dim 32
// runs in B2's 64-column tile (launch_d).
template <int D>
cudaError_t launch_carry_bf16(const void* q, const void* k, const void* v, void* acc, void* m, void* l, int B,
                              int Hq, int Hkv, int Sq, int Sk, int rel, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  constexpr int TD = D < PANEL ? PANEL : D;  // the tile's head dim
  constexpr int WIDE = TD <= 128 ? 2 : 1;
  const bool narrow = (long long)B * Hq * live_q_tiles(Sq, rel, 128) < sms;
  return narrow ? launch_carry_hopper<TD, 1, D>(q, k, v, acc, m, l, B, Hq, Hkv, Sq, Sk, rel, sms, stream)
                : launch_carry_hopper<TD, WIDE, D>(q, k, v, acc, m, l, B, Hq, Hkv, Sq, Sk, rel, sms, stream);
}

// ---- f32 inputs: plain SIMT kernels ---------------------------------------

constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int F32_ROWS = 16;  // query rows per block (4 per warp)
constexpr int F32_KEYS = 32;  // keys per K/V tile: one per lane when scoring

template <int D>
struct TileF32 {
  static constexpr int K_STRIDE = D + 1;  // odd pitch: lane j reads K row j conflict-free
  static constexpr size_t SMEM_BYTES =
      sizeof(float) * (size_t)(F32_ROWS * D + F32_KEYS * K_STRIDE + F32_KEYS * D);
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int Hq, int Hkv, int S,
                         float scale) {
  constexpr int E = D / 32;                     // output columns per lane: lane + 32 * e
  constexpr int RPW = F32_ROWS / NUM_WARPS;     // query rows per warp
  constexpr int KS = TileF32<D>::K_STRIDE;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + F32_ROWS * D;
  float* sV = sK + F32_KEYS * KS;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q_tiles = (S + F32_ROWS - 1) / F32_ROWS;
  const int bh = blockIdx.x / q_tiles;  // blockIdx.x = bh * q_tiles + tile, bh = b * Hq + h
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int q_start = (q_tiles - 1 - blockIdx.x % q_tiles) * F32_ROWS;  // longest causal blocks first
  const float* qp = q + (size_t)bh * S * D;
  const float* kp = k + ((size_t)b * Hkv + kvh) * S * D;
  const float* vp = v + ((size_t)b * Hkv + kvh) * S * D;

  for (int c = threadIdx.x; c < F32_ROWS * D; c += NUM_THREADS) {
    const int r = c / D;
    sQ[c] = q_start + r < S ? qp[(size_t)(q_start + r) * D + c % D] : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][E];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  int n_tiles = (S + F32_KEYS - 1) / F32_KEYS;
  if (CAUSAL) n_tiles = min(n_tiles, (q_start + F32_ROWS + F32_KEYS - 1) / F32_KEYS);

  for (int j = 0; j < n_tiles; ++j) {
    const int k_start = j * F32_KEYS;
    __syncthreads();  // every warp is done with the previous tile
    for (int c = threadIdx.x; c < F32_KEYS * D; c += NUM_THREADS) {
      const int r = c / D;
      const int col = c % D;
      const bool ok = k_start + r < S;
      sK[r * KS + col] = ok ? kp[(size_t)(k_start + r) * D + col] : 0.f;
      sV[r * D + col] = ok ? vp[(size_t)(k_start + r) * D + col] : 0.f;
    }
    __syncthreads();

    const int key = k_start + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int row_local = warp * RPW + i;
      const int row = q_start + row_local;
      const float* qr = sQ + row_local * D;
      const float* kr = sK + lane * KS;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      // the first tile always holds key 0, visible to every row, so m is
      // finite after it and masked keys underflow to exactly 0 below
      s = (key < S && (!CAUSAL || key <= row)) ? s * scale : NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(s));
      const float alpha = expf(m[i] - m_new);
      const float p = expf(s - m_new);
      l[i] = alpha * l[i] + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= alpha;
#pragma unroll 4
      for (int jj = 0; jj < F32_KEYS; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
        const float* vr = sV + jj * D + lane;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(pj, vr[32 * e], acc[i][e]);
      }
    }
  }

  float* op = o + (size_t)bh * S * D;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = q_start + warp * RPW + i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < E; ++e) op[(size_t)row * D + lane + 32 * e] = acc[i][e] * inv;
  }
}

// B4's f32 kernel: the f32 B2 kernel above with the carry loaded and stored
// (m in natural units, as the carry keeps it), the rel mask, the K loop cut
// at the frontier and the reference's two guards. It is a body of its own:
// one template shared with B2 moved ptxas's register allocation of B2's
// D = 128 causal instantiation (more spills, 47% slower on the card).
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_attention_carry_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                     const float* __restrict__ v, float* __restrict__ acc_io,
                                     float* __restrict__ m_io, float* __restrict__ l_io, int Hq,
                                     int Hkv, int Sq, int Sk, int rel, float scale) {
  constexpr int E = D / 32;                     // output columns per lane: lane + 32 * e
  constexpr int RPW = F32_ROWS / NUM_WARPS;     // query rows per warp
  constexpr int KS = TileF32<D>::K_STRIDE;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + F32_ROWS * D;
  float* sV = sK + F32_KEYS * KS;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q_tiles = (Sq + F32_ROWS - 1) / F32_ROWS;
  const int bh = blockIdx.x / q_tiles;  // blockIdx.x = bh * q_tiles + tile, bh = b * Hq + h
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int q_start = (q_tiles - 1 - blockIdx.x % q_tiles) * F32_ROWS;  // longest blocks first

  // the K tiles the block's last row sees (a prefix, as in the bf16 body)
  const int q_last = min(q_start + F32_ROWS, Sq) - 1;
  if (q_last < rel) return;  // wholly above the frontier: read and write nothing
  const int n_tiles = min((Sk + F32_KEYS - 1) / F32_KEYS, (q_last - rel) / F32_KEYS + 1);

  const float* qp = q + (size_t)bh * Sq * D;
  const float* kp = k + ((size_t)b * Hkv + kvh) * Sk * D;
  const float* vp = v + ((size_t)b * Hkv + kvh) * Sk * D;

  for (int c = threadIdx.x; c < F32_ROWS * D; c += NUM_THREADS) {
    const int r = c / D;
    sQ[c] = q_start + r < Sq ? qp[(size_t)(q_start + r) * D + c % D] : 0.f;
  }

  // rows that see a key of this hop (row >= rel) take their carried state;
  // the others are never written back. Every thread reads before the
  // loop's first barrier; the stores come after the last one.
  float m[RPW], l[RPW], acc[RPW][E];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
    const int row = q_start + warp * RPW + i;
    if (row < Sq && row >= rel) {
      const size_t ri = (size_t)bh * Sq + row;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] = acc_io[ri * D + lane + 32 * e];
      m[i] = m_io[ri];
      l[i] = l_io[ri];
    }
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k_start = j * F32_KEYS;
    __syncthreads();  // every warp is done with the previous tile
    for (int c = threadIdx.x; c < F32_KEYS * D; c += NUM_THREADS) {
      const int r = c / D;
      const int col = c % D;
      const bool ok = k_start + r < Sk;
      sK[r * KS + col] = ok ? kp[(size_t)(k_start + r) * D + col] : 0.f;
      sV[r * D + col] = ok ? vp[(size_t)(k_start + r) * D + col] : 0.f;
    }
    __syncthreads();

    const int key = k_start + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int row_local = warp * RPW + i;
      const int row = q_start + row_local;
      const float* qr = sQ + row_local * D;
      const float* kr = sK + lane * KS;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s = (key < Sk && row - key >= rel) ? s * scale : NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(s));
      // the reference's two guards (attention.py:361-365)
      const float alpha = expf(fminf(m[i] - m_new, 0.f));
      const float p = s <= 0.5f * NEG_INF ? 0.f : expf(s - m_new);
      l[i] = alpha * l[i] + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= alpha;
#pragma unroll 4
      for (int jj = 0; jj < F32_KEYS; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
        const float* vr = sV + jj * D + lane;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(pj, vr[32 * e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = q_start + warp * RPW + i;
    if (row >= Sq || row < rel) continue;
    const size_t ri = (size_t)bh * Sq + row;
#pragma unroll
    for (int e = 0; e < E; ++e) acc_io[ri * D + lane + 32 * e] = acc[i][e];
    if (lane == 0) {
      m_io[ri] = m[i];
      l_io[ri] = l[i];
    }
  }
}

template <int D, bool CAUSAL>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                       int S, cudaStream_t stream) {
  constexpr size_t smem = TileF32<D>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((S + F32_ROWS - 1) / F32_ROWS) * B * Hq;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  flash_fwd_f32_kernel<D, CAUSAL><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Hq, Hkv, S, 1.f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32_d(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                         int S, int causal, cudaStream_t stream) {
  return causal ? launch_f32<D, true>(q, k, v, o, B, Hq, Hkv, S, stream)
                : launch_f32<D, false>(q, k, v, o, B, Hq, Hkv, S, stream);
}

// One B4 hop: the f32 kernel over B * Hq * query tiles, flat in x, or the
// bf16 persistent kernel.
template <int D>
cudaError_t launch_carry(const void* q, const void* k, const void* v, void* acc, void* m, void* l,
                         int B, int Hq, int Hkv, int Sq, int Sk, int rel, int f32,
                         cudaStream_t stream) {
  cudaError_t err;
  if (f32) {
    constexpr size_t smem = TileF32<D>::SMEM_BYTES;
    err = cudaFuncSetAttribute(flash_attention_carry_f32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long blocks = (long long)((Sq + F32_ROWS - 1) / F32_ROWS) * B * Hq;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)blocks);
    flash_attention_carry_f32_kernel<D><<<grid, NUM_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l), Hq, Hkv, Sq, Sk,
        rel, 1.f / sqrtf((float)D));
    return cudaGetLastError();
  }
  return launch_carry_bf16<D>(q, k, v, acc, m, l, B, Hq, Hkv, Sq, Sk, rel, stream);
}

}  // namespace

extern "C" {

// q, o: (B, Hq, S, D); k, v: (B, Hkv, S, D); all contiguous bf16 on the
// device, 16-byte aligned. D in {32, 64, 128, 192, 256}; Hq % Hkv == 0.
// Returns 0 or the CUDA error code of the launch.
int tpusc_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                              int Hkv, int S, int D, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)launch_d<32>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    case 64: return (int)launch_d<64>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    case 128: return (int)launch_d<128>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    case 192: return (int)launch_d<192>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    case 256: return (int)launch_d<256>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same contract for f32 q, k, v, o.
int tpusc_flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o, int B,
                                  int Hq, int Hkv, int S, int D, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)launch_f32_d<32>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    case 64: return (int)launch_f32_d<64>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    case 128: return (int)launch_f32_d<128>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    case 192: return (int)launch_f32_d<192>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    case 256: return (int)launch_f32_d<256>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One ring hop, updating the carry in place. q: (B, Hq, Sq, D); k, v:
// (B, Hkv, Sk, D), bf16 (f32 == 0) or f32 (f32 == 1); acc: (B, Hq, Sq, D)
// f32; m, l: (B, Hq, Sq) f32; all contiguous on the device, 16-byte
// aligned. Local row r sees local key c when r - c >= rel. D in {32, 64,
// 128, 192, 256}; Hq % Hkv == 0. Returns 0 or the CUDA error code of the launch.
int tpusc_flash_attention_carry(const void* q, const void* k, const void* v, void* acc, void* m,
                                void* l, int B, int Hq, int Hkv, int Sq, int Sk, int D, int rel,
                                int f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)launch_carry<32>(q, k, v, acc, m, l, B, Hq, Hkv, Sq, Sk, rel, f32, st);
    case 64: return (int)launch_carry<64>(q, k, v, acc, m, l, B, Hq, Hkv, Sq, Sk, rel, f32, st);
    case 128: return (int)launch_carry<128>(q, k, v, acc, m, l, B, Hq, Hkv, Sq, Sk, rel, f32, st);
    case 192: return (int)launch_carry<192>(q, k, v, acc, m, l, B, Hq, Hkv, Sq, Sk, rel, f32, st);
    case 256: return (int)launch_carry<256>(q, k, v, acc, m, l, B, Hq, Hkv, Sq, Sk, rel, f32, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* tpusc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
