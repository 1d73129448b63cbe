// Paged attention for Hopper (sm_90a): T query positions per lane over the
// continuous engine's paged KV arena. One device body (paged_attention_body)
// behind two kernels, so that a profile tells them apart:
//   - paged_decode_attention_kernel (T = 1) replaces the Pallas TPU kernel
//     `paged_decode_attention_kernel` (tfservingcache_tpu/ops/attention.py:705,
//     body `_paged_decode_kernel` :624): one decode step of every lane;
//   - paged_verify_attention_kernel (any T >= 1) replaces
//     `paged_verify_attention_kernel` (:945, body `_paged_verify_kernel`
//     :867): the verify pass of a speculative round (T = spec + 1) and, at
//     T = chunk, chunked prefill.
// Both run the same code with T a run-time argument, so they agree bit for
// bit at T = 1. When the page axis is split (below), a second kernel of the
// same family, paged_decode_attention_combine_kernel or
// paged_verify_attention_combine_kernel, merges the splits.
//
// Same arithmetic as the Pallas bodies:
//   - lane s, KV head h: the T * g query rows of that head (g = Hq / Hkv),
//     folded as r = t * g + gi (query offset t = r / g, query head h*g + gi),
//     walk the lane's block-table row tables[s, ..], reading the arena in
//     place (the table is a device int32 tensor the kernel reads itself);
//   - row r sits at pos[s] + t and sees keys k_pos <= pos[s] + t (its own
//     causal frontier); keys past min(pos[s] + T, pps * page_tokens) are
//     never read, and no table slot past the deepest frontier's page is ever
//     dereferenced, so the trash page behind unreserved entries (and the
//     overshoot rows a verify pass writes there) is never streamed;
//   - scores q.k * 1/sqrt(D) in f32, online softmax (m, l, acc) in f32;
//   - bf16 arena: p rounded to bf16 before the p.v product, l summed from
//     the f32 p (the Pallas body :686-693 / :926-932); f32 arena: all f32;
//     int8 arena: k and v dequantized as int8 * scale[row] in f32, q upcast
//     to f32, p kept f32;
//   - out = acc / max(l, 1e-30), f32, (S, Hq, T, D).
//
// Bound on this card: bytes, for the decode step and the spec rounds. A call
// reads every visible K/V row of every lane once (2 * rows * Hkv * D *
// itemsize) and does 4 * T * g * D operations per row and KV head: at
// T * g <= 36 that is under 20 operations a byte against the ~295 where the
// bf16 tensor cores would bind. At T = 256 (chunked prefill) it nears that
// line. What held the first, SIMT-only design back was loads in flight,
// one K/V read per tile of 4 rows, and too few blocks for 132 SMs. This
// design:
//   - one block of 4 warps per (lane, KV head, row tile, split), flattened
//     into gridDim.x (no 65535 limit on lanes). A row tile holds every
//     folded row of the (lane, head) up to 64 (bf16 pages and bf16 q) or 16
//     (the SIMT path), so a decode step and a spec round (T * g <= 16) read
//     each K/V row once; only chunked prefill has several tiles, and they
//     re-read from L2;
//   - the page axis split: a block walks pages_per_split consecutive table
//     slots. The split is planned on the host from shapes alone (lanes,
//     Hkv, rows, pps, page_tokens, the SM count: ops/attention.py
//     paged_split_plan), so nothing reads pos on the host and a call stays
//     capturable in a CUDA graph. The mma path splits a grid up to one wave
//     of its blocks (two an SM fit their shared memory); the SIMT path up
//     to eight blocks an SM. With one split the block writes out; with
//     more, every block writes its unnormalized (m, l, acc) in f32 to
//     scratch and the combine kernel merges the splits in a fixed order (no
//     atomics: deterministic). A split that begins past the block's deepest
//     frontier reads nothing and writes (NEG_INF, 0, 0); split 0 always
//     holds key 0;
//   - K and V (and int8 scales) stream into shared memory through cp.async
//     16-byte copies, in a ring of stages of 64 keys (32 for f32): 3 on the
//     mma path (two in flight while one is consumed; 2 at D = 256), 2 on
//     the SIMT path, whose smaller blocks then fit 3-4 to an SM (its own
//     compute binds there, so more warps pay more than loads in flight).
//     Keys past the block's frontier are zero-filled, never read;
//   - bf16 pages with bf16 q: mma.sync.m16n8k16 (f32 accumulate) for q.k^T
//     and p.v. Q fragments stay in registers (D <= 128) or in shared memory
//     (D > 128), rows padded to 16; K and V come from the staged rows by
//     ldmatrix (.trans for V); staged rows are padded by 16 bytes so the
//     page rows do not bank-conflict; p is rounded to bf16 as the A operand (the
//     reference's rounding point), l summed from the f32 p. Each warp owns
//     16 rows; with fewer rows than 64 the warps of a row group split a
//     stage's 16-key chunks between them;
//   - int8 and f32 pages (and f32 q over bf16 pages): SIMT f32 math from the
//     staged rows (the reference's f32 dequantization and f32 rounding rule
//     out bf16 or TF32 mma): each warp owns 4 rows (q as f32 in shared
//     memory); a lane takes one key's dot product (or a half or a quarter
//     of it, when 2 or 4 warps share a row group's keys), so a score needs
//     no shuffle across the warp; p of a key is broadcast by a shuffle for
//     the p.v sum, where each lane owns D/32 output columns;
//   - a key past a row's frontier gets score NEG_INF and p = 0 explicitly,
//     so a warp that sees no visible key of a row keeps (m = NEG_INF,
//     l = 0, acc = 0) and never forms exp(NEG_INF - NEG_INF) as a weight;
//   - at the end the warps that split a row group's keys merge their
//     (m, l, acc) through shared memory, in warp order.
//
// Entry points (plain C, loaded with ctypes): tpusc_paged_attention
// launches on the given stream, allocates nothing (the caller passes the
// split scratch) and returns cudaGetLastError() of the launches;
// tpusc_paged_tiling says which path and row tile a (q, page) type pair
// takes, so that the host's split plan reads the tiling from here.
//
// Built with -DTPUSC_PAGED_LOADS_ONLY=1 (tools/paged_kernel_ab.py
// SOURCE:TPUSC_PAGED_LOADS_ONLY=1), the key loop streams its stages and
// skips their math: an ablation that tells the copy pipeline's time from
// the compute's. Its outputs are not attention.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef TPUSC_PAGED_LOADS_ONLY
#define TPUSC_PAGED_LOADS_ONLY 0
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr float NEG_INF = -1e30f;  // the reference's mask value
constexpr int COMBINE_THREADS = 256;

// Which compute path an (q, page) type pair takes, and its row tiling.
template <typename QT, typename KVT>
struct Path {
  static constexpr bool MMA = std::is_same<QT, bf16>::value && std::is_same<KVT, bf16>::value;
  static constexpr int UNIT = MMA ? 16 : 4;  // rows a warp owns
  static constexpr int ROW_TILE = NUM_WARPS * UNIT;
};

// Shared-memory layout: [Q (f32 rows on the SIMT path; bf16 rows on the mma
// path for D > 128)] [stage 0] [stage 1]
// ..., a stage = SK K rows, SK V rows (row pitch PITCH elements), and for
// int8 pages SK K scales and SK V scales. After the key loop the stages'
// space holds the warps' (m, l, acc) for the merge.
template <int D, typename QT, typename KVT>
struct Layout {
  static constexpr bool MMA = Path<QT, KVT>::MMA;
  static constexpr int SK = sizeof(KVT) == 4 ? 32 : 64;  // keys a stage
  // staged rows padded by 16 bytes: rows 8 apart start 4 banks apart, so
  // ldmatrix (mma path) and 16-byte reads of 8 keys (SIMT) do not conflict
  static constexpr int PITCH = D + 16 / (int)sizeof(KVT);
  static constexpr int ROW_BYTES = PITCH * (int)sizeof(KVT);
  static constexpr int KV_BYTES = SK * ROW_BYTES;
  static constexpr bool SCALES = std::is_same<KVT, int8_t>::value;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES + (SCALES ? 2 * SK * 4 : 0);
  static constexpr bool Q_SMEM = MMA && D > 128;  // q in shared memory (bf16), not registers
  static constexpr int Q_BYTES = MMA ? (Q_SMEM ? Path<QT, KVT>::ROW_TILE * PITCH * 2 : 0)
                                     : Path<QT, KVT>::ROW_TILE * D * 4;  // SIMT: f32 q rows
  // mma path: 3 stages where they fit; SIMT: 2 (its smaller blocks then fit
  // 3-4 to an SM, and more warps, not more loads in flight, pay there)
  static constexpr int STAGES = MMA && 3 * STAGE_BYTES + Q_BYTES <= 200 * 1024 ? 3 : 2;
  static constexpr int PIPE_BYTES = STAGES * STAGE_BYTES;
  static constexpr int MERGE_BYTES = NUM_WARPS * Path<QT, KVT>::UNIT * (D + 2) * 4;
  static constexpr int BYTES = Q_BYTES + (PIPE_BYTES > MERGE_BYTES ? PIPE_BYTES : MERGE_BYTES);
  static_assert(ROW_BYTES % 16 == 0 && STAGE_BYTES % 16 == 0, "16-byte copies");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zero-filled when !valid
// (no byte is read then). No memory clobber, so the table reads that feed
// the copies need not wait for earlier copies; the reads of a stage are
// ordered by cp_async_wait (which has one) and a barrier.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a(16x16, row-major) * b(16x8, col-major), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// E consecutive elements at p (p aligned to 2 elements when E > 1) as f32
// (E = 1 at head_dim 32: one column a lane)
template <int E>
__device__ __forceinline__ void load_row(const bf16* p, float (&x)[E]) {
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    const float2 f = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
  if constexpr (E % 2 == 1) x[E - 1] = __bfloat162float(p[E - 1]);
}

template <int E>
__device__ __forceinline__ void load_row(const float* p, float (&x)[E]) {
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    const float2 f = reinterpret_cast<const float2*>(p)[i];
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
  if constexpr (E % 2 == 1) x[E - 1] = p[E - 1];
}

template <int E>
__device__ __forceinline__ void load_row(const int8_t* p, float (&x)[E]) {
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    const char2 c = reinterpret_cast<const char2*>(p)[i];
    x[2 * i] = (float)c.x;
    x[2 * i + 1] = (float)c.y;
  }
  if constexpr (E % 2 == 1) x[E - 1] = (float)p[E - 1];
}

// one chunk of a staged row as f32: the 16 bytes at p (16-byte aligned),
// or 8 int8 values (8-byte aligned) where a 32-column int8 row has too few
// 16-byte chunks for four lanes to share a key's dot product
__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load_vec(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load_vec(const int8_t* p, float (&x)[16]) {
  const int4 u = *reinterpret_cast<const int4*>(p);
  const char4* c = reinterpret_cast<const char4*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[4 * i] = (float)c[i].x;
    x[4 * i + 1] = (float)c[i].y;
    x[4 * i + 2] = (float)c[i].z;
    x[4 * i + 3] = (float)c[i].w;
  }
}
__device__ __forceinline__ void load_vec(const int8_t* p, float (&x)[8]) {
  const int2 u = *reinterpret_cast<const int2*>(p);
  const char4* c = reinterpret_cast<const char4*>(&u);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    x[4 * i] = (float)c[i].x;
    x[4 * i + 1] = (float)c[i].y;
    x[4 * i + 2] = (float)c[i].z;
    x[4 * i + 3] = (float)c[i].w;
  }
}

// p as the p.v product sees it: rounded to the cache dtype (bf16), else f32
__device__ __forceinline__ float round_p(float p, const bf16*) {
  return __bfloat162float(__float2bfloat16(p));
}
__device__ __forceinline__ float round_p(float p, const float*) { return p; }
__device__ __forceinline__ float round_p(float p, const int8_t*) { return p; }

// row index of folded row f = t * g + gi of (lane s, KV head kvh) in the
// (S, Hq, T) q / out layout
__device__ __forceinline__ size_t out_row(int s, int kvh, int f, int g, int Hq, int T) {
  return ((size_t)s * Hq + kvh * g + f % g) * T + f / g;
}

template <int D, typename QT, typename KVT>
__device__ __forceinline__ void paged_attention_body(
    const QT* __restrict__ q, const KVT* __restrict__ kp, const KVT* __restrict__ vp,
    const float* __restrict__ ks, const float* __restrict__ vs, const int* __restrict__ tables,
    const int* __restrict__ pos, float* __restrict__ out, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int Hq, int Hkv, int T, int page_tokens, int pps, int n_pages,
    int row_tiles, int n_splits, int pages_per_split, float scale) {
  using P = Path<QT, KVT>;
  using L = Layout<D, QT, KVT>;
  constexpr int UNIT = P::UNIT;
  constexpr int SK = L::SK;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int blk = blockIdx.x;
  const int sp = blk % n_splits;
  blk /= n_splits;
  const int rt = blk % row_tiles;
  blk /= row_tiles;
  const int kvh = blk % Hkv;
  const int s = blk / Hkv;
  const int g = Hq / Hkv;
  const int row0 = rt * P::ROW_TILE;
  const int rows = min(P::ROW_TILE, T * g - row0);
  const int groups = (rows + UNIT - 1) / UNIT;
  // warps of one row group split its keys: 4, 2 or 1 of them
  const int kspl = groups == 1 ? 4 : groups == 2 ? 2 : 1;
  const int rg = warp / kspl;
  const int kq = warp % kspl;
  const bool active = rg < groups;

  const int p0 = pos[s];
  const int max_keys = pps * page_tokens;
  const int n_keys = min(p0 + (row0 + rows - 1) / g + 1, max_keys);  // deepest frontier
  const int kb = sp * pages_per_split * page_tokens;  // this split's keys: [kb, ke)
  const int ke = min(kb + pages_per_split * page_tokens, n_keys);
  const int n_st = ke > kb ? (ke - kb + SK - 1) / SK : 0;

  const int* trow = tables + (size_t)s * pps;
  unsigned char* pipe = smem + L::Q_BYTES;

  // stage st: keys kb + st*SK .. +SK into ring slot st % STAGES; one
  // commit group per call, empty past the last stage. Every table entry of
  // the stage is read before the first copy is issued, so the reads overlap.
  auto issue = [&](int st) {
    if (st < n_st) {
      unsigned char* buf = pipe + (st % STAGES) * L::STAGE_BYTES;
      constexpr int CHUNKS = D * (int)sizeof(KVT) / 16;  // 16-byte chunks of a row
      constexpr int ITERS = (SK * CHUNKS + NUM_THREADS - 1) / NUM_THREADS;
      const int k0 = kb + st * SK;
      int rows_at[ITERS];  // arena row (page * Hkv + head) * page_tokens + token, or -1
#pragma unroll
      for (int it = 0; it < ITERS; ++it) {
        const int idx = threadIdx.x + it * NUM_THREADS;
        const int key = k0 + idx / CHUNKS;
        rows_at[it] = -1;
        if (idx < SK * CHUNKS && key < ke) {
          const int pg = min(max(trow[key / page_tokens], 0), n_pages - 1);
          rows_at[it] = (pg * Hkv + kvh) * page_tokens + key % page_tokens;
        }
      }
#pragma unroll
      for (int it = 0; it < ITERS; ++it) {
        const int idx = threadIdx.x + it * NUM_THREADS;
        if (idx >= SK * CHUNKS) break;
        const int j = idx / CHUNKS;
        const int c = idx % CHUNKS;
        const bool ok = rows_at[it] >= 0;
        const size_t off = ok ? (size_t)rows_at[it] * D : 0;
        const uint32_t dst = smem_u32(buf + j * L::ROW_BYTES + c * 16);
        cp_async16(dst, reinterpret_cast<const unsigned char*>(kp + off) + c * 16, ok);
        cp_async16(dst + L::KV_BYTES, reinterpret_cast<const unsigned char*>(vp + off) + c * 16,
                   ok);
      }
      if constexpr (L::SCALES) {
        for (int j = threadIdx.x; j < SK; j += NUM_THREADS) {
          const int key = k0 + j;
          const bool ok = key < ke;
          int so = 0;
          if (ok) {
            const int pg = min(max(trow[key / page_tokens], 0), n_pages - 1);
            so = (pg * Hkv + kvh) * page_tokens + key % page_tokens;
          }
          const uint32_t dst = smem_u32(buf + 2 * L::KV_BYTES + j * 4);
          cp_async4(dst, ks + so, ok);
          cp_async4(dst + SK * 4, vs + so, ok);
        }
      }
    }
    cp_async_commit();
  };

  float* merge = reinterpret_cast<float*>(pipe);  // after the key loop
  float* mine = merge + warp * UNIT * (D + 2);     // this warp's m[UNIT], l[UNIT], acc[UNIT][D]

  if constexpr (P::MMA) {
    // ---- bf16 pages, bf16 q: mma.sync ----
    constexpr int NT_O = D / 8;  // 8-column n-tiles of the output
    const int fr = lane >> 2;    // fragment row (and row + 8)
    const int ft = lane & 3;     // thread within the row's quad
    // the keys rows fr and fr + 8 see in this split: [kb, min(frontier, ke))
    int nk[2];
    const int rl = rg * 16 + fr;  // tile-local row of the low half
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rl + 8 * h;
      nk[h] = active && r < rows ? min(p0 + (row0 + r) / g + 1, ke) : 0;
    }
    // the warp's deepest frontier: rows grow with r, so the group's last row
    const int wr = min(rg * 16 + 15, rows - 1);
    const int wnk = active ? min(p0 + (row0 + wr) / g + 1, ke) : 0;

    uint32_t qa[L::Q_SMEM ? 1 : D / 16][4];
    if constexpr (L::Q_SMEM) {
      bf16* sq = reinterpret_cast<bf16*>(smem);
      for (int idx = threadIdx.x; idx < P::ROW_TILE * (D / 8); idx += NUM_THREADS) {
        const int r = idx / (D / 8);
        const int c = (idx % (D / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows)
          val = *reinterpret_cast<const uint4*>(q + out_row(s, kvh, row0 + r, g, Hq, T) * D + c);
        *reinterpret_cast<uint4*>(sq + r * L::PITCH + c) = val;
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) qa[kk][0] = qa[kk][1] = qa[kk][2] = qa[kk][3] = 0u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rl + 8 * h;
        if (!active || r >= rows) continue;
        const bf16* qr = q + out_row(s, kvh, row0 + r, g, Hq, T) * D + ft * 2;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          qa[kk][h] = *reinterpret_cast<const uint32_t*>(qr + kk * 16);
          qa[kk][2 + h] = *reinterpret_cast<const uint32_t*>(qr + kk * 16 + 8);
        }
      }
    }

    float acc[NT_O][4];
#pragma unroll
    for (int i = 0; i < NT_O; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};

    for (int st = 0; st < STAGES - 1; ++st) issue(st);
    for (int st = 0; st < n_st; ++st) {
      issue(st + STAGES - 1);
      cp_async_wait<STAGES - 1>();
      __syncthreads();
      if (active && !TPUSC_PAGED_LOADS_ONLY) {
        const unsigned char* buf = pipe + (st % STAGES) * L::STAGE_BYTES;
        const uint32_t sk = smem_u32(buf);
        const uint32_t sv = sk + L::KV_BYTES;
        for (int c = kq; c < SK / 16; c += kspl) {
          const int kc = c * 16;
          const int key0 = kb + st * SK + kc;
          if (key0 >= wnk) break;  // warp-uniform: every later key is past the frontier
          // s = q k^T: 16 rows x 16 keys (two 8-key n-tiles)
          float sc[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
          const uint32_t ka =
              sk + ((kc + (lane >> 4) * 8 + (lane & 7)) * L::PITCH + ((lane >> 3) & 1) * 8) * 2;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t a[4];
            if constexpr (L::Q_SMEM) {
              const uint32_t qaddr = smem_u32(smem) +
                                     ((rg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L::PITCH +
                                      kk * 16 + (lane >> 4) * 8) * 2;
              ldsm_x4(a, qaddr);
            } else {
              a[0] = qa[kk][0];
              a[1] = qa[kk][1];
              a[2] = qa[kk][2];
              a[3] = qa[kk][3];
            }
            uint32_t b[4];
            ldsm_x4(b, ka + kk * 32);
            mma_16816(sc[0], a, b[0], b[1]);
            mma_16816(sc[1], a, b[2], b[3]);
          }
          // scale, mask, online softmax (rows fr and fr + 8)
          float mx[2] = {m[0], m[1]};
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = key0 + nt * 8 + ft * 2 + (e & 1);
              const float v = key < nk[e >> 1] ? sc[nt][e] * scale : NEG_INF;
              sc[nt][e] = v;
              mx[e >> 1] = fmaxf(mx[e >> 1], v);
            }
          }
          float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
            alpha[h] = expf(m[h] - mx[h]);
            m[h] = mx[h];
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              // a masked key is no probability, even while the row's max is
              // still NEG_INF (exp(NEG_INF - NEG_INF) would be 1)
              const int key = key0 + nt * 8 + ft * 2 + (e & 1);
              const float p = key < nk[e >> 1] ? expf(sc[nt][e] - m[e >> 1]) : 0.f;
              sc[nt][e] = p;
              sum[e >> 1] += p;
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
            sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
            l[h] = alpha[h] * l[h] + sum[h];
          }
#pragma unroll
          for (int nt = 0; nt < NT_O; ++nt) {
            acc[nt][0] *= alpha[0];
            acc[nt][1] *= alpha[0];
            acc[nt][2] *= alpha[1];
            acc[nt][3] *= alpha[1];
          }
          // acc += bf16(p) v: the score accumulator's layout is the A operand's
          uint32_t pa[4];
          pa[0] = pack_bf16x2(sc[0][0], sc[0][1]);
          pa[1] = pack_bf16x2(sc[0][2], sc[0][3]);
          pa[2] = pack_bf16x2(sc[1][0], sc[1][1]);
          pa[3] = pack_bf16x2(sc[1][2], sc[1][3]);
          const uint32_t va =
              sv + ((kc + ((lane >> 3) & 1) * 8 + (lane & 7)) * L::PITCH + (lane >> 4) * 8) * 2;
#pragma unroll
          for (int np = 0; np < D / 16; ++np) {
            uint32_t b[4];
            ldsm_x4_trans(b, va + np * 32);
            mma_16816(acc[2 * np], pa, b[0], b[1]);
            mma_16816(acc[2 * np + 1], pa, b[2], b[3]);
          }
        }
      }
      __syncthreads();
    }
    cp_async_wait<0>();
    __syncthreads();
    if (active) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = fr + 8 * h;
        float* ar = mine + 2 * UNIT + r * D + ft * 2;
#pragma unroll
        for (int nt = 0; nt < NT_O; ++nt)
          *reinterpret_cast<float2*>(ar + nt * 8) = make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
        if (ft == 0) {
          mine[r] = m[h];
          mine[UNIT + r] = l[h];
        }
      }
    }
  } else {
    // ---- int8 / f32 pages (or f32 q): SIMT f32 ----
    // A step is 32 keys of the stage; the kspl warps of the row group take
    // 32 / kspl of them each, and kspl lanes share a key's dot product
    // (lane: key lane % KW, part lane / KW of D). The q rows wait in shared
    // memory as f32 and are read as broadcasts.
    constexpr int E = D / 32;                      // output columns a lane owns: lane * E ..
    // elements of a chunk: 16 bytes, or fewer where a row has fewer than
    // four (int8 at D = 32), so that each of four lanes dots one
    constexpr int VE = 16 / (int)sizeof(KVT) < D / 4 ? 16 / (int)sizeof(KVT) : D / 4;
    const int KW = 32 / kspl;                      // keys a warp takes of a step
    const int kl = lane % KW;
    const int part = lane / KW;
    const int seg_chunks = D / VE / kspl;          // chunks of a key's row a lane dots
    float* sq = reinterpret_cast<float*>(smem);    // [ROW_TILE][D] f32
    for (int idx = threadIdx.x; idx < P::ROW_TILE * D; idx += NUM_THREADS) {
      const int r = idx / D;
      float x = 0.f;
      if (r < rows) {
        const QT* qr = q + out_row(s, kvh, row0 + r, g, Hq, T) * D + idx % D;
        if constexpr (std::is_same<QT, bf16>::value) x = __bfloat162float(*qr);
        else x = *qr;
      }
      sq[idx] = x;
    }
    const int nrow = active ? min(UNIT, rows - rg * UNIT) : 0;  // this warp's real rows
    int nk[UNIT];
    int wnk = 0;
#pragma unroll
    for (int i = 0; i < UNIT; ++i) {  // row i sees keys [kb, min(frontier, ke)) of this split
      nk[i] = i < nrow ? min(p0 + (row0 + rg * UNIT + i) / g + 1, ke) : 0;
      wnk = max(wnk, nk[i]);
    }
    float m[UNIT], l[UNIT], acc[UNIT][E];
#pragma unroll
    for (int i = 0; i < UNIT; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
    }

    for (int st = 0; st < STAGES - 1; ++st) issue(st);
    for (int st = 0; st < n_st; ++st) {
      issue(st + STAGES - 1);
      cp_async_wait<STAGES - 1>();
      __syncthreads();
      if (active && !TPUSC_PAGED_LOADS_ONLY) {
        const unsigned char* buf = pipe + (st % STAGES) * L::STAGE_BYTES;
        const float* sks = reinterpret_cast<const float*>(buf + 2 * L::KV_BYTES);
        for (int j0 = kq * KW; j0 < SK; j0 += 32) {
          const int key0 = kb + st * SK + j0;  // the warp's first key of the step
          if (key0 >= wnk) break;              // warp-uniform: every later key is masked
          const int j = j0 + kl;
          const unsigned char* krow = buf + j * L::ROW_BYTES;
          // scores of key j for the warp's rows, over this lane's part of D
          float sc[UNIT];
#pragma unroll
          for (int i = 0; i < UNIT; ++i) sc[i] = 0.f;
          for (int c = part * seg_chunks; c < (part + 1) * seg_chunks; ++c) {
            float kx[VE];
            load_vec(reinterpret_cast<const KVT*>(krow) + c * VE, kx);
            if constexpr (L::SCALES) {  // int8 pages: per-(page, head, token) scales
              const float a = sks[j];
#pragma unroll
              for (int e = 0; e < VE; ++e) kx[e] *= a;
            }
#pragma unroll
            for (int i = 0; i < UNIT; ++i) {
              if (i >= nrow) break;  // warp-uniform
              const float* qv = sq + (rg * UNIT + i) * D + c * VE;
#pragma unroll
              for (int e = 0; e < VE; e += 4) {
                const float4 q4 = *reinterpret_cast<const float4*>(qv + e);
                sc[i] = fmaf(q4.x, kx[e], sc[i]);
                sc[i] = fmaf(q4.y, kx[e + 1], sc[i]);
                sc[i] = fmaf(q4.z, kx[e + 2], sc[i]);
                sc[i] = fmaf(q4.w, kx[e + 3], sc[i]);
              }
            }
          }
          float pr[UNIT];
#pragma unroll
          for (int i = 0; i < UNIT; ++i) {
            pr[i] = 0.f;
            if (i >= nrow || key0 >= nk[i]) continue;  // warp-uniform
            float d = sc[i];
            for (int o = KW; o < 32; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
            const bool vis = key0 + kl < nk[i];
            // masked keys give p = 0 explicitly
            const float v = vis ? d * scale : NEG_INF;
            float mx = v;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = expf(m[i] - m_new);
            const float p = vis ? expf(v - m_new) : 0.f;
            float sum = part == 0 ? p : 0.f;  // each key once
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
            l[i] = alpha * l[i] + sum;
            m[i] = m_new;
#pragma unroll
            for (int e = 0; e < E; ++e) acc[i][e] *= alpha;
            pr[i] = round_p(p, kp);
          }
          // acc += p v over the warp's keys of the step (p of key jj from lane jj)
          const int n_j = min(KW, wnk - key0);
          for (int jj = 0; jj < n_j; ++jj) {
            float vx[E];
            load_row<E>(reinterpret_cast<const KVT*>(buf + L::KV_BYTES + (j0 + jj) * L::ROW_BYTES) +
                            lane * E,
                        vx);
            if constexpr (L::SCALES) {
              const float b = sks[SK + j0 + jj];
#pragma unroll
              for (int e = 0; e < E; ++e) vx[e] *= b;
            }
#pragma unroll
            for (int i = 0; i < UNIT; ++i) {
              if (i >= nrow) break;  // warp-uniform
              const float pj = __shfl_sync(0xffffffffu, pr[i], jj);
#pragma unroll
              for (int e = 0; e < E; ++e) acc[i][e] = fmaf(pj, vx[e], acc[i][e]);
            }
          }
        }
      }
      __syncthreads();
    }
    cp_async_wait<0>();
    __syncthreads();
    if (active) {
#pragma unroll
      for (int r = 0; r < UNIT; ++r) {
#pragma unroll
        for (int e = 0; e < E; ++e) mine[2 * UNIT + r * D + lane * E + e] = acc[r][e];
        if (lane == 0) {
          mine[r] = m[r];
          mine[UNIT + r] = l[r];
        }
      }
    }
  }
  __syncthreads();

  // merge the warps of each row group (in warp order), then write out or,
  // with the page axis split, this split's unnormalized state
  for (int idx = threadIdx.x; idx < rows * D; idx += NUM_THREADS) {
    const int r = idx / D;
    const int d = idx % D;
    const int grp = r / UNIT;
    const int rr = r % UNIT;
    const float* w0 = merge + grp * kspl * UNIT * (D + 2);
    float mx = NEG_INF;
    for (int w = 0; w < kspl; ++w) mx = fmaxf(mx, w0[w * UNIT * (D + 2) + rr]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < kspl; ++w) {
      const float* wm = w0 + w * UNIT * (D + 2);
      const float f = expf(wm[rr] - mx);  // 0 for a warp that saw no key of the row
      lsum += wm[UNIT + rr] * f;
      a += wm[2 * UNIT + rr * D + d] * f;
    }
    const size_t orow = out_row(s, kvh, row0 + r, g, Hq, T);
    if (n_splits == 1) {
      out[orow * D + d] = a / fmaxf(lsum, 1e-30f);
    } else {
      const size_t slot = orow * n_splits + sp;
      part_acc[slot * D + d] = a;
      if (d == 0) {
        part_ml[slot * 2] = mx;
        part_ml[slot * 2 + 1] = lsum;
      }
    }
  }
}

// Merge the page-axis splits of every output row, split 0 first: part_ml
// (rows, n_splits, 2) = (m, l), part_acc (rows, n_splits, D) -> out (rows, D).
__device__ __forceinline__ void combine_body(const float* __restrict__ part_ml,
                                             const float* __restrict__ part_acc,
                                             float* __restrict__ out, long long total, int D,
                                             int n_splits) {
  const long long idx = (long long)blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (idx >= total) return;
  const long long row = idx / D;
  const int d = (int)(idx % D);
  const float* ml = part_ml + row * n_splits * 2;
  float mx = NEG_INF;
  for (int sp = 0; sp < n_splits; ++sp) mx = fmaxf(mx, ml[2 * sp]);
  float lsum = 0.f, a = 0.f;
  const float* pa = part_acc + row * n_splits * D + d;
  for (int sp = 0; sp < n_splits; ++sp) {
    const float f = expf(ml[2 * sp] - mx);  // 0 for a split that saw no key of the row
    lsum += ml[2 * sp + 1] * f;
    a += pa[(size_t)sp * D] * f;
  }
  out[idx] = a / fmaxf(lsum, 1e-30f);
}

#define PAGED_KERNEL_PARAMS                                                                     \
  const QT *__restrict__ q, const KVT *__restrict__ kp, const KVT *__restrict__ vp,             \
      const float *__restrict__ ks, const float *__restrict__ vs, const int *__restrict__ tables, \
      const int *__restrict__ pos, float *__restrict__ out, float *__restrict__ part_ml,          \
      float *__restrict__ part_acc, int Hq, int Hkv, int T, int page_tokens, int pps,            \
      int n_pages, int row_tiles, int n_splits, int pages_per_split, float scale
#define PAGED_KERNEL_ARGS                                                                    \
  q, kp, vp, ks, vs, tables, pos, out, part_ml, part_acc, Hq, Hkv, T, page_tokens, pps, n_pages, \
      row_tiles, n_splits, pages_per_split, scale

// Two kernels over one body, so that a profile tells the decode step (T = 1)
// from the verify pass; both take T at run time and run the same code. (A
// minimum of one block an SM leaves ptxas the whole register file: with
// the default it capped some SIMT instantiations at 64-96 registers and
// spilled.)
template <int D, typename QT, typename KVT>
__global__ void __launch_bounds__(NUM_THREADS, 1)
    paged_decode_attention_kernel(PAGED_KERNEL_PARAMS) {
  paged_attention_body<D, QT, KVT>(PAGED_KERNEL_ARGS);
}

template <int D, typename QT, typename KVT>
__global__ void __launch_bounds__(NUM_THREADS, 1)
    paged_verify_attention_kernel(PAGED_KERNEL_PARAMS) {
  paged_attention_body<D, QT, KVT>(PAGED_KERNEL_ARGS);
}

__global__ void __launch_bounds__(COMBINE_THREADS)
    paged_decode_attention_combine_kernel(const float* __restrict__ part_ml,
                                          const float* __restrict__ part_acc,
                                          float* __restrict__ out, long long total, int D,
                                          int n_splits) {
  combine_body(part_ml, part_acc, out, total, D, n_splits);
}

__global__ void __launch_bounds__(COMBINE_THREADS)
    paged_verify_attention_combine_kernel(const float* __restrict__ part_ml,
                                          const float* __restrict__ part_acc,
                                          float* __restrict__ out, long long total, int D,
                                          int n_splits) {
  combine_body(part_ml, part_acc, out, total, D, n_splits);
}

struct Args {
  bool verify;
  const void *q, *k, *v, *ks, *vs, *tables, *pos;
  void *out, *part_ml, *part_acc;
  int S, Hq, Hkv, D, T, page_tokens, pps, n_pages, n_splits, pages_per_split;
  cudaStream_t stream;
};

template <int D, typename QT, typename KVT>
cudaError_t launch(const Args& a) {
  using P = Path<QT, KVT>;
  constexpr int smem = Layout<D, QT, KVT>::BYTES;
  const long long rows = (long long)a.T * (a.Hq / a.Hkv);
  const long long row_tiles = (rows + P::ROW_TILE - 1) / P::ROW_TILE;
  const long long blocks = (long long)a.S * a.Hkv * row_tiles * a.n_splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = a.verify ? paged_verify_attention_kernel<D, QT, KVT>
                         : paged_decode_attention_kernel<D, QT, KVT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, NUM_THREADS, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KVT*>(a.k), static_cast<const KVT*>(a.v),
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.pos),
      static_cast<float*>(a.out), static_cast<float*>(a.part_ml), static_cast<float*>(a.part_acc),
      a.Hq, a.Hkv, a.T, a.page_tokens, a.pps, a.n_pages, (int)row_tiles, a.n_splits,
      a.pages_per_split, 1.f / sqrtf((float)D));
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return err;
  const long long total = (long long)a.S * a.Hq * a.T * D;
  const long long cblocks = (total + COMBINE_THREADS - 1) / COMBINE_THREADS;
  if (cblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto combine = a.verify ? paged_verify_attention_combine_kernel
                          : paged_decode_attention_combine_kernel;
  combine<<<(unsigned)cblocks, COMBINE_THREADS, 0, a.stream>>>(
      static_cast<const float*>(a.part_ml), static_cast<const float*>(a.part_acc),
      static_cast<float*>(a.out), total, D, a.n_splits);
  return cudaGetLastError();
}

template <int D, typename QT>
cudaError_t launch_kv(int kv_type, const Args& a) {
  switch (kv_type) {
    case 0: return launch<D, QT, bf16>(a);
    case 1: return launch<D, QT, float>(a);
    case 2: return launch<D, QT, int8_t>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t launch_d(int q_type, int kv_type, const Args& a) {
  switch (q_type) {
    case 0: return launch_kv<D, bf16>(kv_type, a);
    case 1: return launch_kv<D, float>(kv_type, a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT, typename KVT>
int tiling_of(int* tiling) {
  tiling[0] = Path<QT, KVT>::MMA;
  tiling[1] = Path<QT, KVT>::ROW_TILE;
  tiling[2] = Path<QT, KVT>::UNIT;
  return 0;
}

}  // namespace

extern "C" {

// q: (S, Hq, T, D) bf16 (q_type 0) or f32 (1); k_pages, v_pages:
// (n_pages, Hkv, page_tokens, D) bf16 (kv_type 0), f32 (1) or int8 (2, with
// k_scale/v_scale (n_pages, Hkv, page_tokens) f32); tables: (S, pps) int32;
// pos: (S,) int32; out: (S, Hq, T, D) f32. The page axis is split into
// n_splits runs of pages_per_split table slots ((n_splits - 1) *
// pages_per_split < pps <= n_splits * pages_per_split); with n_splits > 1,
// part_ml (S * Hq * T, n_splits, 2) and part_acc (S * Hq * T, n_splits, D)
// are f32 scratch. All contiguous on the device. D in {32, 64, 128, 192, 256};
// Hq % Hkv == 0; T >= 1, and T == 1 unless `verify` (which picks
// paged_verify_attention_kernel over paged_decode_attention_kernel).
// Returns 0 or the CUDA error code.
int tpusc_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                          const void* k_scale, const void* v_scale, const void* tables,
                          const void* pos, void* out, void* part_ml, void* part_acc, int S, int Hq,
                          int Hkv, int D, int page_tokens, int pps, int n_pages, int q_type,
                          int kv_type, int T, int verify, int n_splits, int pages_per_split,
                          void* stream) {
  if (S < 1 || T < 1 || (!verify && T != 1) || Hkv < 1 || Hq % Hkv != 0 || page_tokens < 1 ||
      pps < 1 || n_pages < 1 || (kv_type == 2 && (k_scale == nullptr || v_scale == nullptr)) ||
      n_splits < 1 || pages_per_split < 1 || (long long)n_splits * pages_per_split < pps ||
      (long long)(n_splits - 1) * pages_per_split >= pps ||
      (n_splits > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{verify != 0, q, k_pages, v_pages, k_scale, v_scale, tables, pos,
               out, part_ml, part_acc, S, Hq, Hkv, D, T, page_tokens, pps, n_pages,
               n_splits, pages_per_split, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return (int)launch_d<32>(q_type, kv_type, a);
    case 64: return (int)launch_d<64>(q_type, kv_type, a);
    case 128: return (int)launch_d<128>(q_type, kv_type, a);
    case 192: return (int)launch_d<192>(q_type, kv_type, a);
    case 256: return (int)launch_d<256>(q_type, kv_type, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tiling of a (q_type, kv_type) pair (types as for
// tpusc_paged_attention): tiling[0] = 1 for the mma.sync path, 0 for the
// SIMT path; tiling[1] = folded query rows a block holds (the row tile);
// tiling[2] = rows a warp owns. Returns 0, or cudaErrorInvalidValue for a
// pair the kernels do not take.
int tpusc_paged_tiling(int q_type, int kv_type, int* tiling) {
  if (q_type == 0 && kv_type == 0) return tiling_of<bf16, bf16>(tiling);
  if (q_type == 0 && kv_type == 1) return tiling_of<bf16, float>(tiling);
  if (q_type == 0 && kv_type == 2) return tiling_of<bf16, int8_t>(tiling);
  if (q_type == 1 && kv_type == 0) return tiling_of<float, bf16>(tiling);
  if (q_type == 1 && kv_type == 1) return tiling_of<float, float>(tiling);
  if (q_type == 1 && kv_type == 2) return tiling_of<float, int8_t>(tiling);
  return (int)cudaErrorInvalidValue;
}

const char* tpusc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
