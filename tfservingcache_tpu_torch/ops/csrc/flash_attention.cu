// Flash attention forward (B2) and the ring-attention carry step (B4) for
// Hopper (sm_90a): bf16 and f32 inputs. The bf16 kernels share one device
// body under two kernel names, so that profiles split them; the f32
// kernels are two bodies (see the f32 section).
//
// B2, `flash_fwd_kernel` / `flash_fwd_f32_kernel`: replaces the Pallas TPU
// kernel `flash_attention` (tfservingcache_tpu/ops/attention.py:211, bodies
// `_flash_kernel` :75 and `_flash_streamed_kernel` :143). Same arithmetic:
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
// B4, `flash_attention_carry_kernel` / `flash_attention_carry_f32_kernel`:
// replaces the Pallas TPU kernel `flash_attention_carry` (attention.py:393,
// body `_flash_carry_kernel` :323), one hop of ring attention: local Q
// (Sq rows) against one K/V block (Sk keys) with the online-softmax state
// carried in f32 from hop to hop. It is B2's body with three changes:
//   - the state (acc, m, l) is loaded from the carry instead of starting at
//     zeros / NEG_INF, and written back unnormalized (m in natural units;
//     the bf16 body works in log2 units and converts at both ends);
//   - the mask is the runtime offset rel = k_off - q_off: local row r sees
//     local key c when r - c >= rel (no causal mask = rel <= -Sk), and the
//     K loop stops at the Pallas predicate q_last - j*BN >= rel
//     (attention.py:375-378); a block wholly above the frontier returns at
//     once, reading and writing nothing;
//   - the reference's two guards: p = 0 where a score is masked, and
//     alpha = exp(min(m_prev - m_new, 0)) (attention.py:361-365). A row that
//     sees no key of the hop (r < rel) is neither read nor written, so its
//     carry stays bit-identical.
// The carry is updated in place (the ring owns it). At rel = 0, Sq = Sk,
// from an empty carry, B4 runs B2's instructions on B2's values, so its
// state normalized as B2 normalizes equals B2's output bit for bit.
//
// Bound on this card: causal prefill at serving lengths does 2*S*S*D flops
// per head against 4*S*D bytes of q/k/v/o, so above S ~ 600 it is bound by
// tensor-core operations, below that by memory. A ring hop at the serving
// shape (32 heads, Sq = Sk = 1024, D 128, a past block) does 17.2 GFLOP
// against ~59 MB, more than half of it the f32 carry read and written: the
// two bounds are within 2% (~0.018 ms each). The design keeps the score
// matrix in registers and touches the carry once per row (a hop never
// stores scores or p); it does nothing yet to shrink the carry's bytes or
// to reach wgmma's rate. This first version aims at being simple and
// right: one block of 4 warps per (batch*head, 64 query rows), K and V^T
// tiles staged through padded (bank-conflict free) shared memory with plain
// 16-byte loads, bf16 mma.sync m16n8k16 for both products, scores and the
// output accumulator in registers. No wgmma/TMA, no double-buffered copy
// pipeline yet.
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
// B2's register allocation (on the card: 0.085 -> 0.124 ms at
// (1,8,8,256,128) causal, outputs bitwise equal).
//
// Entry points: tpusc_flash_attention_fwd (bf16),
// tpusc_flash_attention_fwd_f32 and tpusc_flash_attention_carry (either
// dtype); plain C, loaded with ctypes. Each launches on the given stream,
// allocates nothing and returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BLOCK_M = 64;          // query rows per block (16 per warp)
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr float NEG_INF = -1e30f;    // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int BLOCK_N = D <= 128 ? 64 : 32;  // keys per K/V tile
  static constexpr int QK_STRIDE = D + 8;             // smem row pitch of Q and K (bf16)
  static constexpr int VT_STRIDE = BLOCK_N + 8;       // smem row pitch of V^T (bf16)
  static constexpr size_t SMEM_BYTES =
      sizeof(bf16) * (size_t)(BLOCK_M * QK_STRIDE + BLOCK_N * QK_STRIDE + D * VT_STRIDE);
};

__device__ __forceinline__ uint32_t ld_smem_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a(16x16, row-major) * b(16x8, col-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Rows [row0, row0 + ROWS) of a (S, D) row-major matrix into smem with row
// pitch STRIDE; rows at or past S are zero-filled.
template <int D, int ROWS, int STRIDE>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int row0, int S) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += NUM_THREADS) {
    const int r = c / CHUNKS;
    const int col = (c % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + col);
    *reinterpret_cast<uint4*>(dst + r * STRIDE + col) = val;
  }
}

// The same rows of V, stored transposed (D x ROWS, pitch STRIDE) so that the
// p.v product reads its B operand as contiguous bf16 pairs. Consecutive
// threads take consecutive keys, so the transposed stores do not conflict.
template <int D, int ROWS, int STRIDE>
__device__ __forceinline__ void load_rows_transposed(bf16* dst, const bf16* __restrict__ src, int row0,
                                                     int S) {
  constexpr int CHUNKS = D / 8;
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += NUM_THREADS) {
    const int r = c % ROWS;
    const int col = (c / ROWS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + col);
    const bf16* v = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(col + i) * STRIDE + r] = v[i];
  }
}

// The bf16 body: one block's 64 query rows of (batch*head) blockIdx.y
// against the K/V tiles they see. B2 (CARRY = false) starts from an empty
// state and writes the normalized bf16 output o; B4 (CARRY = true, masked by
// rel) loads and stores the f32 carry acc_io / m_io / l_io in place.
template <int D, bool CAUSAL, bool CARRY>
__device__ __forceinline__ void flash_body(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                           const bf16* __restrict__ v, bf16* __restrict__ o,
                                           float* __restrict__ acc_io, float* __restrict__ m_io,
                                           float* __restrict__ l_io, int Hq, int Hkv, int Sq, int Sk,
                                           int rel, float scale_log2) {
  constexpr int BN = Tile<D>::BLOCK_N;
  constexpr int QS = Tile<D>::QK_STRIDE;
  constexpr int VS = Tile<D>::VT_STRIDE;
  constexpr int NT_S = BN / 8;  // n-tiles of the score block
  constexpr int NT_O = D / 8;   // n-tiles of the output block

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BLOCK_M * QS;
  bf16* sVt = sK + BN * QS;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group

  const int bh = blockIdx.y;  // b * Hq + h
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  // the longest causal blocks are scheduled first
  const int q_start = (gridDim.x - 1 - blockIdx.x) * BLOCK_M;

  int n_blocks = (Sk + BN - 1) / BN;
  if constexpr (CARRY) {
    // K tile j is read only if the block's last row sees its first key,
    // q_last - j*BN >= rel; visibility grows toward key 0, so the tiles
    // read are a prefix, and tile 0 holds every seeing row's key 0
    const int q_last = min(q_start + BLOCK_M, Sq) - 1;
    if (q_last < rel) return;  // wholly above the frontier: read and write nothing
    n_blocks = min(n_blocks, (q_last - rel) / BN + 1);
  } else if (CAUSAL) {
    n_blocks = min(n_blocks, (q_start + BLOCK_M + BN - 1) / BN);
  }

  const bf16* qp = q + (size_t)bh * Sq * D;
  const bf16* kp = k + ((size_t)b * Hkv + kvh) * Sk * D;
  const bf16* vp = v + ((size_t)b * Hkv + kvh) * Sk * D;

  load_rows<D, BLOCK_M, QS>(sQ, qp, q_start, Sq);

  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max (log2 units), rows g and g + 8
  float l[2] = {0.f, 0.f};          // running sum of f32 p
  const int row_lo = q_start + warp * 16 + g;

  if constexpr (CARRY) {
    // rows that see a key of this hop (r >= rel) take their carried state;
    // the others are never written back. Every thread reads before the
    // loop's first barrier; the stores come after the last one.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row_lo + half * 8;
      if (r >= Sq || r < rel) continue;
      const size_t row = (size_t)bh * Sq + r;
      const float* ap = acc_io + row * D + t * 2;
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        const float2 a2 = *reinterpret_cast<const float2*>(ap + nt * 8);
        acc[nt][2 * half] = a2.x;
        acc[nt][2 * half + 1] = a2.y;
      }
      m[half] = m_io[row] * LOG2E;  // natural units -> the body's log2 units
      l[half] = l_io[row];
    }
  }

  for (int j = 0; j < n_blocks; ++j) {
    const int k_start = j * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<D, BN, QS>(sK, kp, k_start, Sk);
    load_rows_transposed<D, BN, VS>(sVt, vp, k_start, Sk);
    __syncthreads();

    // s = q k^T for this warp's 16 rows x BN keys
    float s[NT_S][4];
#pragma unroll
    for (int i = 0; i < NT_S; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* qa = sQ + (warp * 16 + g) * QS + kk * 16 + t * 2;
      uint32_t a[4];
      a[0] = ld_smem_u32(qa);
      a[1] = ld_smem_u32(qa + 8 * QS);
      a[2] = ld_smem_u32(qa + 8);
      a[3] = ld_smem_u32(qa + 8 * QS + 8);
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        const bf16* kb = sK + (nt * 8 + g) * QS + kk * 16 + t * 2;
        uint32_t bb[2] = {ld_smem_u32(kb), ld_smem_u32(kb + 8)};
        mma_16816(s[nt], a, bb);
      }
    }

    // scale, mask, online-softmax update (log2 domain)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row_lo + (e >> 1) * 8;
        const int c = k_start + nt * 8 + t * 2 + (e & 1);
        bool ok;
        if constexpr (CARRY) {
          ok = c < Sk && r - c >= rel;
        } else {
          ok = c < Sk && (!CAUSAL || c <= r);
        }
        const float val = ok ? s[nt][e] * scale_log2 : NEG_INF;
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      if constexpr (CARRY) {
        alpha[i] = exp2f(fminf(m[i] - mx[i], 0.f));
      } else {
        alpha[i] = exp2f(m[i] - mx[i]);
      }
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p;
        if constexpr (CARRY) {
          // a masked score is no probability, even while the row's max is
          // still NEG_INF (exp(NEG_INF - NEG_INF) would be 1)
          p = s[nt][e] <= 0.5f * NEG_INF ? 0.f : exp2f(s[nt][e] - m[e >> 1]);
        } else {
          p = exp2f(s[nt][e] - m[e >> 1]);
        }
        s[nt][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = alpha[i] * l[i] + sum[i];
    }
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }

    // acc += bf16(p) v: the score accumulator's layout is the A operand's
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        const bf16* vb = sVt + (nt * 8 + g) * VS + kk * 16 + t * 2;
        uint32_t bb[2] = {ld_smem_u32(vb), ld_smem_u32(vb + 8)};
        mma_16816(acc[nt], a, bb);
      }
    }
  }

  if constexpr (CARRY) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row_lo + half * 8;
      if (r >= Sq || r < rel) continue;
      const size_t row = (size_t)bh * Sq + r;
      float* ap = acc_io + row * D + t * 2;
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        *reinterpret_cast<float2*>(ap + nt * 8) = make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
      }
      if (t == 0) {
        m_io[row] = m[half] / LOG2E;
        l_io[row] = l[half];
      }
    }
  } else {
    const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
    bf16* op = o + (size_t)bh * Sq * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row_lo + half * 8;
      if (r >= Sq) continue;
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        *reinterpret_cast<uint32_t*>(op + (size_t)r * D + nt * 8 + t * 2) =
            pack_bf16x2(acc[nt][2 * half] * inv[half], acc[nt][2 * half + 1] * inv[half]);
      }
    }
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     bf16* __restrict__ o, int Hq, int Hkv, int S, float scale_log2) {
  flash_body<D, CAUSAL, false>(q, k, v, o, nullptr, nullptr, nullptr, Hq, Hkv, S, S, 0, scale_log2);
}

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_attention_carry_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, float* __restrict__ acc,
                                 float* __restrict__ m, float* __restrict__ l, int Hq, int Hkv, int Sq,
                                 int Sk, int rel, float scale_log2) {
  flash_body<D, true, true>(q, k, v, nullptr, acc, m, l, Hq, Hkv, Sq, Sk, rel, scale_log2);
}

template <int D, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int S,
                   cudaStream_t stream) {
  constexpr size_t smem = Tile<D>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BLOCK_M - 1) / BLOCK_M, B * Hq);
  const float scale_log2 = LOG2E / sqrtf((float)D);
  flash_fwd_kernel<D, CAUSAL><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Hq, Hkv, S, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int S,
                     int causal, cudaStream_t stream) {
  return causal ? launch<D, true>(q, k, v, o, B, Hq, Hkv, S, stream)
                : launch<D, false>(q, k, v, o, B, Hq, Hkv, S, stream);
}


// ---- f32 inputs: plain SIMT kernels ---------------------------------------

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
  const int bh = blockIdx.y;  // b * Hq + h
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int q_start = (gridDim.x - 1 - blockIdx.x) * F32_ROWS;  // longest causal blocks first
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
  const int bh = blockIdx.y;  // b * Hq + h
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int q_start = (gridDim.x - 1 - blockIdx.x) * F32_ROWS;  // longest blocks first

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
  const dim3 grid((S + F32_ROWS - 1) / F32_ROWS, B * Hq);
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

// One B4 hop: the bf16 or the f32 kernel over (query tiles, B * Hq).
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
    const dim3 grid((Sq + F32_ROWS - 1) / F32_ROWS, B * Hq);
    flash_attention_carry_f32_kernel<D><<<grid, NUM_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l), Hq, Hkv, Sq, Sk,
        rel, 1.f / sqrtf((float)D));
  } else {
    constexpr size_t smem = Tile<D>::SMEM_BYTES;
    err = cudaFuncSetAttribute(flash_attention_carry_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, B * Hq);
    flash_attention_carry_kernel<D><<<grid, NUM_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l), Hq, Hkv, Sq, Sk,
        rel, LOG2E / sqrtf((float)D));
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (B, Hq, S, D); k, v: (B, Hkv, S, D); all contiguous bf16 on the
// device, 16-byte aligned. D in {64, 128, 192, 256}; Hq % Hkv == 0.
// Returns 0 or the CUDA error code of the launch.
int tpusc_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                              int Hkv, int S, int D, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
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
// aligned. Local row r sees local key c when r - c >= rel. D in {64, 128,
// 192, 256}; Hq % Hkv == 0. Returns 0 or the CUDA error code of the launch.
int tpusc_flash_attention_carry(const void* q, const void* k, const void* v, void* acc, void* m,
                                void* l, int B, int Hq, int Hkv, int Sq, int Sk, int D, int rel,
                                int f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
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
