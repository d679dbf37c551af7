// Ragged paged-decode attention for Hopper (sm_90a): one query token per
// slot attends straight through the slot's page-table row.
//
// Replaces: csat_tpu/ops/paged_decode.py:_attend_kernel (pallas_call at
// :269, body _decode_body :203) AND the XLA finalize it feeds
// (_finalize :146-175).  The TPU kernel only walks the table and writes a
// dequantised (S, H, width, dh) strip; the one-hot token merge, mask,
// softmax and ·V then run in XLA.  This kernel fuses all of it (decoding
// over pages): the strip never exists in device memory.
//
// Per (slot s, head h) block:
//   * lane t of the chain lives in page table[s, t / page] at row t % page;
//     a NULL_PAGE (0) entry is skipped without a read (its lanes are k = v =
//     0, exactly what the TPU kernel writes for them) and counted in
//     skipped[s, h] — over the whole table row, as reference_page_skip does;
//   * self attention passes idx: lane idx[s] takes this step's k_tok/v_tok
//     (the one-hot merge), whatever the page holds;
//   * live lanes dequantise in registers, element by element, as
//     dequantize_kv does: value = stored (f32 | bf16 | int8) · scale[row];
//   * scores q·k / sqrt(dh), -1e9 where mask[s, t] is set, a max-subtracted
//     softmax over all `width` lanes, then Σ p_t v_t / Σ p_t.  In a row with
//     an admissible lane a masked lane's weight exp(-1e9 - max) is exactly 0
//     in f32, so only admissible lanes are read; a row whose every lane is
//     masked (a frozen slot) is the mean of its `width` V rows.
//
// What bounds it on an H100: bytes, and below them latency.  Each block
// reads the K and V rows of its chain's admissible lanes once (dh values
// each, plus one scale per row; a masked lane is read, V only, in a row whose
// every lane is masked) and does 4 flops per value read, far below the ~20
// flop/byte at which f32 compute would matter.  At the serving shapes (S=8,
// H=8, width <= 150, dh=64) one call reads well under 2 MB, under a
// microsecond of HBM time: what is left is the launch (a few µs) and the
// chain of dependent steps inside a block.  The design keeps that chain short:
//   * one launch per attention (no strip write/re-read, no separate softmax
//     and matmul launches), one block of 8 warps per (slot, head);
//   * the table walk is one parallel pass: every thread takes a lane, reads
//     its mask byte and table entry, and a warp ballot compacts the
//     admissible lanes into a list in shared memory (row id, NULL or the
//     merged token), so the K/V loop never waits on the table or skips;
//     the skip count is a ballot over the table row;
//   * one pass over K and V: a lane row is read by a fraction of a warp in
//     16-byte vectors (a half-warp for f32, a quarter for bf16, an eighth for
//     int8), so a warp covers 2, 4 or 8 lanes at once, and each group issues
//     the K and V loads of its next 4 lanes before it uses any of them; each
//     group keeps an online max, sum and output slice, and the groups merge
//     once in shared memory at the end.
// Every sum runs in a fixed order, so a launch repeats bit for bit.
//
// Rows with no admissible lane (frozen slots) attend uniformly over zeros
// for NULL lanes where the gather path reads the null page's contents; the
// engine discards those rows, and comparisons hold live rows only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NULL_PAGE = 0;
constexpr float NEG_INF = -1e9f;   // the mask fill of models/components.py
constexpr float NEG = -1e30f;      // running max of a group that has read nothing
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;          // lanes a group has in flight
constexpr int LANE_NULL = -1;      // list entry of a NULL lane: k = v = 0
constexpr int LANE_TOKEN = -2;     // list entry of the merged lane: k_tok / v_tok

struct Args {
  const float* q;          // (S, H, 1, DH)
  const void* pages_k;     // (NP, H, page, DH) storage dtype
  const void* pages_v;
  const float* scale_k;    // (NP, H, page, 1)
  const float* scale_v;
  const int32_t* table;    // (S, NB)
  const uint8_t* mask;     // (S, width), nonzero = disallowed
  const int32_t* idx;      // (S,) or null
  const float* k_tok;      // (S, H, 1, DH) or null
  const float* v_tok;
  float* out;              // (S, H, 1, DH)
  int32_t* skipped;        // (S, H)
  int S, H, NB, page, width;
};

// 16 bytes of a stored row → VEC f32 values
__device__ __forceinline__ void unpack(const float4& r, float (&x)[4]) {
  x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
}
__device__ __forceinline__ void unpack(const float4& r, float (&x)[8]) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(b[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const float4& r, float (&x)[16]) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = (float)b[i];
}

template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC / 4; ++i) {
    const float4 r = reinterpret_cast<const float4*>(p)[i];
    x[4 * i] = r.x; x[4 * i + 1] = r.y; x[4 * i + 2] = r.z; x[4 * i + 3] = r.w;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(Args a) {
  constexpr int VEC = 16 / sizeof(T);   // stored values in one 16-byte load
  constexpr int TPR = DH / VEC;         // threads that read one lane row
  constexpr int GROUPS = THREADS / TPR;
  constexpr int MLD = DH + 1;           // merge row stride
  static_assert(DH % VEC == 0 && TPR <= 32 && (TPR & (TPR - 1)) == 0, "row split");
  extern __shared__ __align__(16) float sm[];
  float* macc = sm;                     // GROUPS x MLD partial outputs
  float* mm = macc + GROUPS * MLD;      // GROUPS running maxima
  float* ml = mm + GROUPS;              // GROUPS running sums
  float* mw = ml + GROUPS;              // GROUPS merge weights, then [GROUPS] = Σ
  int* list = reinterpret_cast<int*>(mw + GROUPS + 1);  // width lane entries
  __shared__ int wcount[WARPS];

  const int h = blockIdx.x, s = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / TPR, sub = tid % TPR;
  const size_t sh = (size_t)s * a.H + h;
  const int32_t* trow = a.table + (size_t)s * a.NB;
  const uint8_t* mrow = a.mask + (size_t)s * a.width;
  const int cur = a.idx ? a.idx[s] : -1;
  const T* pk = reinterpret_cast<const T*>(a.pages_k);
  const T* pv = reinterpret_cast<const T*>(a.pages_v);

  float qv[VEC];
  load_f32<VEC>(a.q + sh * DH + sub * VEC, qv);

  if (warp == 0) {  // the skip count: one ballot per 32 table entries
    int n = 0;
    for (int j0 = 0; j0 < a.NB; j0 += 32) {
      const int j = j0 + lane;
      n += __popc(__ballot_sync(0xffffffffu, j < a.NB && trow[j] == NULL_PAGE));
    }
    if (lane == 0) a.skipped[sh] = n;
  }

  // does the row have an admissible lane?  Then only those are read; else
  // every lane is (the uniform softmax of a frozen row)
  int any = 0;
  for (int t = tid; t < a.width; t += THREADS) any |= !mrow[t];
  const bool live = __syncthreads_or(any);

  // the walk: compact the lanes to read into `list`, in lane order
  int n_list = 0;
  for (int t0 = 0; t0 < a.width; t0 += THREADS) {
    const int t = t0 + tid;
    const bool use = t < a.width && (!live || !mrow[t]);
    int code = LANE_NULL;
    if (use) {
      const int pg = trow[t / a.page];
      // row ids fit an int: a pool of 2^31 rows of dh >= 64 values outgrows the card
      code = t == cur ? LANE_TOKEN
           : pg == NULL_PAGE ? LANE_NULL : (pg * a.H + h) * a.page + t % a.page;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, use);
    if (lane == 0) wcount[warp] = __popc(bal);
    __syncthreads();
    int off = n_list, tot = 0;
    for (int w = 0; w < WARPS; ++w) {
      off += w < warp ? wcount[w] : 0;
      tot += wcount[w];
    }
    if (use) list[off + __popc(bal & ((1u << lane) - 1u))] = code;
    n_list += tot;
    __syncthreads();
  }

  // one pass over K and V, UNROLL lanes in flight per group
  float m = NEG, l = 0.f, acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  const float inv_sqrt = 1.f / sqrtf((float)DH);
  for (int i0 = 0; i0 < n_list; i0 += GROUPS * UNROLL) {
    float kx[UNROLL][VEC], vx[UNROLL][VEC], sc[UNROLL];
    bool valid[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + grp + GROUPS * u;
      valid[u] = i < n_list;
      const int code = valid[u] ? list[i] : LANE_NULL;
      if (code >= 0) {
        const size_t base = (size_t)code * DH + sub * VEC;
        const float4 kr = live ? *reinterpret_cast<const float4*>(pk + base)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 vr = *reinterpret_cast<const float4*>(pv + base);
        const float sk = live ? a.scale_k[code] : 0.f, sv = a.scale_v[code];
        unpack(kr, kx[u]);
        unpack(vr, vx[u]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          kx[u][e] *= sk;
          vx[u][e] *= sv;
        }
      } else if (code == LANE_TOKEN) {
        load_f32<VEC>(a.k_tok + sh * DH + sub * VEC, kx[u]);
        load_f32<VEC>(a.v_tok + sh * DH + sub * VEC, vx[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kx[u][e] = vx[u][e] = 0.f;
      }
    }
    float mt = m;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) dot += qv[e] * kx[u][e];
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      sc[u] = live ? dot * inv_sqrt : NEG_INF;
      if (valid[u]) mt = fmaxf(mt, sc[u]);
    }
    const float alpha = expf(m - mt);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float p = valid[u] ? expf(sc[u] - mt) : 0.f;
      l += p;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += p * vx[u][e];
    }
    m = mt;
  }

  // merge the groups: out = Σ_g e^{m_g - M} acc_g / Σ_g e^{m_g - M} l_g
  if (sub == 0) {
    mm[grp] = m;
    ml[grp] = l;
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) macc[grp * MLD + sub * VEC + e] = acc[e];
  __syncthreads();
  if (warp == 0) {
    float mx = NEG;
    for (int g = lane; g < GROUPS; g += 32) mx = fmaxf(mx, mm[g]);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float lsum = 0.f;
    for (int g = lane; g < GROUPS; g += 32) {
      const float w = expf(mm[g] - mx);
      mw[g] = w;
      lsum += w * ml[g];
    }
    for (int o = 16; o > 0; o >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
    if (lane == 0) mw[GROUPS] = lsum;
  }
  __syncthreads();
  // four threads per output column, each over every fourth group
  const int part = tid & 3;
  for (int d = tid >> 2; d < DH; d += THREADS / 4) {
    float o = 0.f;
    for (int g = part; g < GROUPS; g += 4) o += mw[g] * macc[g * MLD + d];
    o += __shfl_xor_sync(0xffffffffu, o, 1);
    o += __shfl_xor_sync(0xffffffffu, o, 2);
    if (part == 0) a.out[sh * DH + d] = o / mw[GROUPS];
  }
}

template <typename T, int DH>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int GROUPS = THREADS / (DH * (int)sizeof(T) / 16);
  const size_t bytes = ((size_t)GROUPS * (DH + 1) + 3 * GROUPS + 1) * sizeof(float)
                       + (size_t)a.width * sizeof(int);
  if (bytes > 232448) return -2;
  if (bytes > 49152) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(a.H, a.S);
  paged_decode_kernel<T, DH><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// The head width of ops/build.py HEAD_DIMS: the decoder's 512 / 8 heads.
template <typename T>
int dispatch(int dh, const Args& a, cudaStream_t stream) {
  return dh == 64 ? launch<T, 64>(a, stream) : -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 page storage.
extern "C" int paged_decode(int dtype, const float* q, const void* pages_k,
                            const void* pages_v, const float* scale_k,
                            const float* scale_v, const int32_t* table,
                            const uint8_t* mask, const int32_t* idx,
                            const float* k_tok, const float* v_tok, float* out,
                            int32_t* skipped, int S, int H, int NB, int page,
                            int width, int DH, void* stream) {
  if (width < 1 || width > NB * page) return -4;
  // rows are read in 16-byte vectors
  auto misaligned = [](const void* p) { return ((uintptr_t)p & 15u) != 0; };
  if (misaligned(q) || misaligned(pages_k) || misaligned(pages_v) ||
      (k_tok && misaligned(k_tok)) || (v_tok && misaligned(v_tok)))
    return -6;
  Args a{q, pages_k, pages_v, scale_k, scale_v, table, mask, idx, k_tok, v_tok,
         out, skipped, S, H, NB, page, width};
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return dispatch<float>(DH, a, st);
    case 1: return dispatch<__nv_bfloat16>(DH, a, st);
    case 2: return dispatch<int8_t>(DH, a, st);
    default: return -5;
  }
}
