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
// bit at T = 1.
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
//     int8 arena: k and v dequantized in registers as int8 * scale[row],
//     q upcast to f32, p kept f32;
//   - out = acc / max(l, 1e-30), f32, (S, Hq, T, D).
//
// Bound on this card: bytes, for the decode step and the spec rounds. A call
// reads every visible K/V row of every lane once (2 * rows * Hkv * D *
// itemsize) and does 4 * T * g * D operations per row and KV head: at
// T * g <= 36 that is under 20 operations a byte against the ~295 where the
// bf16 tensor cores would bind. (At T = 256, chunked prefill, it nears that
// line; the SIMT FMAs below then bind first.) So the design spends nothing
// on tensor cores and aims at keeping loads in flight:
//   - one block of 8 warps per (lane, KV head, tile of up to 4 folded query
//     rows); a (lane, head) with T * g > 4 rows has several tiles, each
//     streaming the keys up to its own deepest frontier (re-reads come from
//     L2; neighbouring tiles are neighbouring blocks);
//   - the warps split the keys in batches of 4 consecutive keys; a warp
//     issues all 8 row loads of a batch (each lane D/32 contiguous elements,
//     so a warp reads a whole row per load) before it uses any;
//   - each key's score is a warp-wide shuffle sum; each lane keeps D/32
//     elements of q and of every row's accumulator in registers;
//   - a key past a row's frontier gets score NEG_INF and p = 0 explicitly,
//     so a warp that sees no visible key of a row keeps (m = NEG_INF, l = 0,
//     acc = 0) and never forms exp(NEG_INF - NEG_INF); key 0 is visible to
//     every row and warp 0 reads it, so the combined max is finite;
//   - at the end the 8 warps' (m, l, acc) combine through shared memory.
// Left for later: tensor cores (mma) for T * g >= 16 rows, splitting the page
// axis across blocks (low lane counts leave SMs idle), one read of the K/V
// rows shared by all row tiles of a (lane, head), 16-byte vector loads
// through cp.async/TMA with double buffering.
//
// Entry point: tpusc_paged_attention (plain C, loaded with ctypes). It
// launches on the given stream, allocates nothing and returns
// cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NUM_WARPS = 8;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int KB = 4;        // keys a warp loads before it uses any of them
constexpr int MAX_ROWS = 4;  // folded query rows (t, gi) per block
constexpr float NEG_INF = -1e30f;  // the reference's mask value

// E consecutive elements at p (E even, p aligned to 2 elements) as f32
template <int E>
__device__ __forceinline__ void load_row(const bf16* p, float (&x)[E]) {
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    const float2 f = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <int E>
__device__ __forceinline__ void load_row(const float* p, float (&x)[E]) {
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    const float2 f = reinterpret_cast<const float2*>(p)[i];
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <int E>
__device__ __forceinline__ void load_row(const int8_t* p, float (&x)[E]) {
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    const char2 c = reinterpret_cast<const char2*>(p)[i];
    x[2 * i] = (float)c.x;
    x[2 * i + 1] = (float)c.y;
  }
}

// p as the p.v product sees it: rounded to the cache dtype (bf16), else f32
__device__ __forceinline__ float round_p(float p, const bf16*) {
  return __bfloat162float(__float2bfloat16(p));
}
__device__ __forceinline__ float round_p(float p, const float*) { return p; }
__device__ __forceinline__ float round_p(float p, const int8_t*) { return p; }

// element offset of folded row f = t * g + gi of (lane s, KV head kvh) in
// the (S, Hq, T, D) q / out layout
__device__ __forceinline__ size_t row_offset(int s, int kvh, int f, int g, int Hq, int T,
                                             int D) {
  const int t = f / g;
  const int head = kvh * g + f % g;
  return (((size_t)s * Hq + head) * T + t) * D;
}

template <int D, typename QT, typename KVT>
__device__ __forceinline__ void paged_attention_body(
    const QT* __restrict__ q, const KVT* __restrict__ kp, const KVT* __restrict__ vp,
    const float* __restrict__ ks, const float* __restrict__ vs, const int* __restrict__ tables,
    const int* __restrict__ pos, float* __restrict__ out, int Hq, int Hkv, int T,
    int page_tokens, int pps, int n_pages, int row_tiles, float scale) {
  constexpr int E = D / 32;  // elements of a row per lane: [lane * E, lane * E + E)

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.y;
  const int kvh = blockIdx.x / row_tiles;
  const int g = Hq / Hkv;
  const int row0 = (blockIdx.x % row_tiles) * MAX_ROWS;
  const int nrows = min(MAX_ROWS, T * g - row0);

  // row r of this block: folded row row0 + r, query offset (row0 + r) / g,
  // visible keys 0 .. pos + t (the table covers pps * page_tokens of them)
  const int p0 = pos[s];
  const int max_keys = pps * page_tokens;
  float qr[MAX_ROWS][E];
  int nk[MAX_ROWS];
  int n_keys = 0;  // the block's deepest frontier
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) {
    if (r < nrows) {
      const int f = row0 + r;
      load_row<E>(q + row_offset(s, kvh, f, g, Hq, T, D) + lane * E, qr[r]);
      nk[r] = min(p0 + f / g + 1, max_keys);
      n_keys = max(n_keys, nk[r]);
    } else {
      nk[r] = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) qr[r][e] = 0.f;
    }
  }

  const int* trow = tables + (size_t)s * pps;
  const size_t page_elems = (size_t)Hkv * page_tokens * D;
  const size_t head_elems = (size_t)kvh * page_tokens * D;

  float m[MAX_ROWS], l[MAX_ROWS], acc[MAX_ROWS][E];
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  for (int t0 = warp * KB; t0 < n_keys; t0 += NUM_WARPS * KB) {
    float kx[KB][E], vx[KB][E];
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      const int t = t0 + i;
      if (t < n_keys) {  // warp-uniform
        const int pg = min(max(trow[t / page_tokens], 0), n_pages - 1);
        const int row = t % page_tokens;
        const size_t off = (size_t)pg * page_elems + head_elems + (size_t)row * D + lane * E;
        load_row<E>(kp + off, kx[i]);
        load_row<E>(vp + off, vx[i]);
        if (ks != nullptr) {  // int8 arena: per-(page, head, token) scales
          const size_t so = ((size_t)pg * Hkv + kvh) * page_tokens + row;
          const float a = ks[so], b = vs[so];
#pragma unroll
          for (int e = 0; e < E; ++e) {
            kx[i][e] *= a;
            vx[i][e] *= b;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kx[i][e] = vx[i][e] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) {
      if (r >= nrows) continue;  // block-uniform
      float sc[KB];
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < KB; ++i) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[r][e], kx[i][e], d);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        sc[i] = t0 + i < nk[r] ? d * scale : NEG_INF;
        mx = fmaxf(mx, sc[i]);
      }
      // masked keys give p = 0 explicitly: m_new may still be NEG_INF for a
      // row whose frontier lies below this batch, and exp(0) must not count
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f, pv[KB];
#pragma unroll
      for (int i = 0; i < KB; ++i) {
        const float p = t0 + i < nk[r] ? expf(sc[i] - m_new) : 0.f;
        sum += p;
        pv[i] = round_p(p, kp);
      }
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float a = acc[r][e] * alpha;
#pragma unroll
        for (int i = 0; i < KB; ++i) a = fmaf(pv[i], vx[i][e], a);
        acc[r][e] = a;
      }
    }
  }

  // combine the warps' partial softmax states
  __shared__ float sm_m[NUM_WARPS][MAX_ROWS];
  __shared__ float sm_l[NUM_WARPS][MAX_ROWS];
  __shared__ float sm_acc[NUM_WARPS][MAX_ROWS][D];
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][r][lane * E + e] = acc[r][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nrows * D; idx += NUM_THREADS) {
    const int r = idx / D;
    const int d = idx % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NUM_WARPS; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NUM_WARPS; ++w) {
      const float f = expf(sm_m[w][r] - mx);  // 0 for a warp that saw no key of the row
      lsum += sm_l[w][r] * f;
      a += sm_acc[w][r][d] * f;
    }
    out[row_offset(s, kvh, row0 + r, g, Hq, T, D) + d] = a / fmaxf(lsum, 1e-30f);
  }
}

// Two kernels over one body, so that a profile tells the decode step (T = 1)
// from the verify pass; both take T at run time and run the same code.
template <int D, typename QT, typename KVT>
__global__ void __launch_bounds__(NUM_THREADS)
    paged_decode_attention_kernel(const QT* __restrict__ q, const KVT* __restrict__ kp,
                                  const KVT* __restrict__ vp, const float* __restrict__ ks,
                                  const float* __restrict__ vs, const int* __restrict__ tables,
                                  const int* __restrict__ pos, float* __restrict__ out, int Hq,
                                  int Hkv, int T, int page_tokens, int pps, int n_pages,
                                  int row_tiles, float scale) {
  paged_attention_body<D, QT, KVT>(q, kp, vp, ks, vs, tables, pos, out, Hq, Hkv, T, page_tokens,
                                   pps, n_pages, row_tiles, scale);
}

template <int D, typename QT, typename KVT>
__global__ void __launch_bounds__(NUM_THREADS)
    paged_verify_attention_kernel(const QT* __restrict__ q, const KVT* __restrict__ kp,
                                  const KVT* __restrict__ vp, const float* __restrict__ ks,
                                  const float* __restrict__ vs, const int* __restrict__ tables,
                                  const int* __restrict__ pos, float* __restrict__ out, int Hq,
                                  int Hkv, int T, int page_tokens, int pps, int n_pages,
                                  int row_tiles, float scale) {
  paged_attention_body<D, QT, KVT>(q, kp, vp, ks, vs, tables, pos, out, Hq, Hkv, T, page_tokens,
                                   pps, n_pages, row_tiles, scale);
}

template <int D, typename QT, typename KVT>
cudaError_t launch(bool verify, const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* tables, const void* pos, void* out, int S, int Hq,
                   int Hkv, int T, int page_tokens, int pps, int n_pages, cudaStream_t stream) {
  const long long rows = (long long)T * (Hq / Hkv);
  const long long row_tiles = (rows + MAX_ROWS - 1) / MAX_ROWS;
  if (row_tiles * Hkv > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(Hkv * row_tiles), S);
  auto kernel = verify ? paged_verify_attention_kernel<D, QT, KVT>
                       : paged_decode_attention_kernel<D, QT, KVT>;
  kernel<<<grid, NUM_THREADS, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k), static_cast<const KVT*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(tables), static_cast<const int*>(pos), static_cast<float*>(out),
      Hq, Hkv, T, page_tokens, pps, n_pages, (int)row_tiles, 1.f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D, typename QT>
cudaError_t launch_kv(bool verify, int kv_type, const void* q, const void* k, const void* v,
                      const void* ks, const void* vs, const void* tables, const void* pos,
                      void* out, int S, int Hq, int Hkv, int T, int page_tokens, int pps,
                      int n_pages, cudaStream_t st) {
  switch (kv_type) {
    case 0:
      return launch<D, QT, bf16>(verify, q, k, v, nullptr, nullptr, tables, pos, out, S, Hq, Hkv,
                                 T, page_tokens, pps, n_pages, st);
    case 1:
      return launch<D, QT, float>(verify, q, k, v, nullptr, nullptr, tables, pos, out, S, Hq, Hkv,
                                  T, page_tokens, pps, n_pages, st);
    case 2:
      return launch<D, QT, int8_t>(verify, q, k, v, ks, vs, tables, pos, out, S, Hq, Hkv, T,
                                   page_tokens, pps, n_pages, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t launch_d(bool verify, int q_type, int kv_type, const void* q, const void* k,
                     const void* v, const void* ks, const void* vs, const void* tables,
                     const void* pos, void* out, int S, int Hq, int Hkv, int T, int page_tokens,
                     int pps, int n_pages, cudaStream_t st) {
  switch (q_type) {
    case 0:
      return launch_kv<D, bf16>(verify, kv_type, q, k, v, ks, vs, tables, pos, out, S, Hq, Hkv,
                                T, page_tokens, pps, n_pages, st);
    case 1:
      return launch_kv<D, float>(verify, kv_type, q, k, v, ks, vs, tables, pos, out, S, Hq, Hkv,
                                 T, page_tokens, pps, n_pages, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (S, Hq, T, D) bf16 (q_type 0) or f32 (1); k_pages, v_pages:
// (n_pages, Hkv, page_tokens, D) bf16 (kv_type 0), f32 (1) or int8 (2, with
// k_scale/v_scale (n_pages, Hkv, page_tokens) f32); tables: (S, pps) int32;
// pos: (S,) int32; out: (S, Hq, T, D) f32. All contiguous on the device.
// D in {64, 128, 192, 256}; Hq % Hkv == 0; T >= 1, and T == 1 unless
// `verify` (which picks paged_verify_attention_kernel over
// paged_decode_attention_kernel). Returns 0 or the CUDA error code.
int tpusc_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                          const void* k_scale, const void* v_scale, const void* tables,
                          const void* pos, void* out, int S, int Hq, int Hkv, int D,
                          int page_tokens, int pps, int n_pages, int q_type, int kv_type, int T,
                          int verify, void* stream) {
  if (S < 1 || S > 65535 || T < 1 || (!verify && T != 1) || Hkv < 1 || Hq % Hkv != 0 ||
      page_tokens < 1 || pps < 1 || n_pages < 1 ||
      (kv_type == 2 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const bool v = verify != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch_d<64>(v, q_type, kv_type, q, k_pages, v_pages, k_scale, v_scale, tables,
                               pos, out, S, Hq, Hkv, T, page_tokens, pps, n_pages, st);
    case 128:
      return (int)launch_d<128>(v, q_type, kv_type, q, k_pages, v_pages, k_scale, v_scale, tables,
                                pos, out, S, Hq, Hkv, T, page_tokens, pps, n_pages, st);
    case 192:
      return (int)launch_d<192>(v, q_type, kv_type, q, k_pages, v_pages, k_scale, v_scale, tables,
                                pos, out, S, Hq, Hkv, T, page_tokens, pps, n_pages, st);
    case 256:
      return (int)launch_d<256>(v, q_type, kv_type, q, k_pages, v_pages, k_scale, v_scale, tables,
                                pos, out, S, Hq, Hkv, T, page_tokens, pps, n_pages, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* tpusc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
