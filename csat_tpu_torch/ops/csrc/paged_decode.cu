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
//     softmax over all `width` lanes, then Σ p_t v_t / Σ p_t.
//
// What bounds it on an H100: bytes.  Each block reads the K and V rows of
// its chain's unmasked lanes once (dh values each, plus one scale per row;
// a masked lane is read only in a row whose every lane is masked) and does
// 4 flops per value read, far below the ~20 flop/byte at which f32 compute
// would matter.  At the serving shapes (S=8, H=8, width <= 150, dh=64) one call
// reads well under 1 MB, so a launch is latency-bound; the design keeps it
// to one launch per attention (no strip write/re-read, no separate softmax
// and matmul launches) and reads each K/V row with one coalesced warp load.
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
constexpr float NEG_INF = -1e9f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

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

__device__ float block_reduce(float x, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < nw; ++i) r = is_max ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

template <typename T, int DH>
__global__ void paged_decode_kernel(Args a) {
  extern __shared__ float sm[];
  float* qs = sm;               // DH
  float* part = qs + DH;        // 2 * DH partial outputs
  float* red = part + 2 * DH;   // 32 reduction slots
  float* sc = red + 32;         // width scores / probabilities
  const int h = blockIdx.x, s = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const size_t sh = (size_t)s * a.H + h;
  const int32_t* trow = a.table + (size_t)s * a.NB;
  const int cur = a.idx ? a.idx[s] : -1;
  const T* pk = reinterpret_cast<const T*>(a.pages_k);
  const T* pv = reinterpret_cast<const T*>(a.pages_v);

  for (int d = tid; d < DH; d += blockDim.x) qs[d] = a.q[sh * DH + d];
  if (tid == 0) {
    int n = 0;
    for (int j = 0; j < a.NB; ++j) n += trow[j] == NULL_PAGE;
    a.skipped[sh] = n;
  }
  __syncthreads();

  // scores: one warp per lane of the chain, one coalesced row read each; a
  // masked lane takes the fill without reading its row
  for (int t = warp; t < a.width; t += nw) {
    const bool masked = a.mask[(size_t)s * a.width + t];
    const int pg = trow[t / a.page];  // issued together with the mask load
    const int off = t % a.page;
    float dot = 0.f;
    if (!masked && t == cur) {
      for (int d = lane; d < DH; d += 32) dot += qs[d] * a.k_tok[sh * DH + d];
    } else if (!masked && pg != NULL_PAGE) {
      const size_t row = ((size_t)pg * a.H + h) * a.page + off;
      const float scl = a.scale_k[row];
      for (int d = lane; d < DH; d += 32) dot += qs[d] * (to_f32(pk[row * DH + d]) * scl);
    }
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (lane == 0) sc[t] = masked ? NEG_INF : dot / sqrtf((float)DH);
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int t = tid; t < a.width; t += blockDim.x) mx = fmaxf(mx, sc[t]);
  mx = block_reduce(mx, red, true);
  float sum = 0.f;
  for (int t = tid; t < a.width; t += blockDim.x) {
    const float e = expf(sc[t] - mx);
    sc[t] = e;
    sum += e;
  }
  sum = block_reduce(sum, red, false);  // its barriers also publish sc[]

  // Σ p_t v_t: thread (par, d) sums the lanes t ≡ par (mod 2); a lane of
  // probability exactly 0 (masked, in a row with an admissible lane) adds
  // nothing and is not read
  const int d = tid % DH, par = tid / DH;
  float acc = 0.f;
  for (int t = par; t < a.width; t += 2) {
    const float pt = sc[t];
    if (pt == 0.f) continue;
    float val;
    if (t == cur) {
      val = a.v_tok[sh * DH + d];
    } else {
      const int pg = trow[t / a.page];
      if (pg == NULL_PAGE) continue;
      const size_t row = ((size_t)pg * a.H + h) * a.page + t % a.page;
      val = to_f32(pv[row * DH + d]) * a.scale_v[row];
    }
    acc += pt * val;
  }
  part[par * DH + d] = acc;
  __syncthreads();
  if (par == 0) a.out[sh * DH + d] = (part[d] + part[DH + d]) / sum;
}

template <typename T, int DH>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = (3 * DH + 32 + (size_t)a.width) * sizeof(float);
  if (bytes > 232448) return -2;
  if (bytes > 49152) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(a.H, a.S);
  paged_decode_kernel<T, DH><<<grid, 2 * DH, bytes, stream>>>(a);
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
