// Flash attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (tfservingcache_tpu/ops/attention.py:211, bodies `_flash_kernel` :75 and
// `_flash_streamed_kernel` :143). Same arithmetic:
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
// Bound on this card: causal prefill at serving lengths does 2*S*S*D flops
// per head against 4*S*D bytes of q/k/v/o, so above S ~ 600 it is bound by
// tensor-core operations, below that by memory. This first version aims at
// being simple and right: one block of 4 warps per (batch*head, 64 query
// rows), K and V^T tiles staged through padded (bank-conflict free) shared
// memory with plain 16-byte loads, bf16 mma.sync m16n8k16 for both products,
// scores and the output accumulator in registers. No wgmma/TMA, no
// double-buffered copy pipeline yet.
//
// Entry point: tpusc_flash_attention_fwd (plain C, loaded with ctypes).
// It launches on the given stream, allocates nothing and returns
// cudaGetLastError() of the launch.

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

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     bf16* __restrict__ o, int Hq, int Hkv, int S, float scale_log2) {
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
  const bf16* qp = q + (size_t)bh * S * D;
  const bf16* kp = k + ((size_t)b * Hkv + kvh) * S * D;
  const bf16* vp = v + ((size_t)b * Hkv + kvh) * S * D;

  load_rows<D, BLOCK_M, QS>(sQ, qp, q_start, S);

  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max (log2 units), rows g and g + 8
  float l[2] = {0.f, 0.f};          // running sum of f32 p
  const int row_lo = q_start + warp * 16 + g;

  int n_blocks = (S + BN - 1) / BN;
  if (CAUSAL) n_blocks = min(n_blocks, (q_start + BLOCK_M + BN - 1) / BN);

  for (int j = 0; j < n_blocks; ++j) {
    const int k_start = j * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<D, BN, QS>(sK, kp, k_start, S);
    load_rows_transposed<D, BN, VS>(sVt, vp, k_start, S);
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
        const bool ok = c < S && (!CAUSAL || c <= r);
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
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m[e >> 1]);
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

  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  bf16* op = o + (size_t)bh * S * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row_lo + half * 8;
    if (r >= S) continue;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      *reinterpret_cast<uint32_t*>(op + (size_t)r * D + nt * 8 + t * 2) =
          pack_bf16x2(acc[nt][2 * half] * inv[half], acc[nt][2 * half + 1] * inv[half]);
    }
  }
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

const char* tpusc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
