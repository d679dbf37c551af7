// Blocked weighted-softmax attention forward for Hopper (sm_90a) under the
// CSE mod: the SIMT kernel K1 (flex_fwd_cse).  The three SBM mods (K2
// expected, K6 sampled, K7 graph) run on the tensor-core kernel of
// flex_fwd_tc.cu.
//
// Replaces: csat_tpu/ops/flex_core.py:_fwd_call (pallas_call at :310, body
// _fwd_body :230) under CSESpec.tile_score of csat_tpu/ops/mods.py
// (:430-439): disentangled L/T relative bias s = (q·k + q·lk[rel_ij] +
// k·lq[rel_ji]) / sqrt(3 dk), -1e9 fill where the raw distance is 0, weight
// = real-extent gate.  It computes out = Σ_j w_ij e^{s_ij} V_j / Σ_j w_ij
// e^{s_ij} (rows with no live weight are exactly 0), plus per-row lse,
// Σ w (graph_sum) and the number of dead (q-tile, k-tile) blocks
// (skipped_blocks).
//
// What bounds it on an H100: at the serving shapes (B <= 8, H=8, N<=150,
// dh=64, f32) the whole call moves well under 10 MB and does a few hundred
// MFLOP, and at the training shape (B=64) a few tens of MB and a few GFLOP:
// neither HBM (3.35 TB/s) nor the f32 pipes (67 TFLOP/s) are the limit.
// One block owns one 64-row q-tile and walks the k-tiles in series, so the
// latency of that loop (loads → weights → scores → row reductions → P·V) and
// the occupancy of ~1 block per SM bound it.  The CSE mod triples the score
// work (two gathered dot products per unmasked entry from the relative
// tables; a masked entry takes the -1e9 fill without them).  The tensor-core
// designs tried for it were slower on a real batch's masks (PERF.md).
//
// Design:
//   * The TPU kernel keeps a full (128, n_pad) f32 score row and weight row
//     in VMEM and runs one softmax over it; that is 256 KB at N=150, over the
//     227 KB a Hopper block may have.  Here one block owns a 64-row q-tile and
//     streams 64-column k-tiles with online max/sum statistics (flash style),
//     so shared memory holds one tile of Q, K, V and P.  The result is not
//     bitwise equal to the one-shot softmax: it differs in summation order.
//   * A k-tile whose weights are all zero is skipped (no score/PV work) and
//     counted — the analogue of the TPU kernel's @pl.when skip, at this
//     kernel's block size of 64 (reference_block_skip is evaluated at 64).
//   * Two sentinels, as in the reference: NEG=-1e30 is the running max of a
//     row that has seen no live weight; -1e9 is the CSE score fill of a LIVE
//     (weight 1) entry, so a CSE row whose every column is masked softmaxes
//     to uniform over its real columns (the cse_empty_rows="uniform" quirk).
//   * The CSE relative tables lq/lk of this head (R x dh) sit in shared
//     memory, so the c2p/p2c gathers index them directly (no lane-chunked
//     gather as on the TPU).  The p2c term reads rel[j][i] (transposed).
//   * Simple SIMT f32: 256 threads, each owns a 4x4 block of the 64x64 score
//     tile (rows ty*4.., columns tx+16*j) and the same 4 rows x dh/16 columns
//     of the output accumulator; rows reduce over the 16 lanes that share
//     them with warp shuffles.  Tensor cores (wgmma) and TMA are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;
constexpr float NEG_CSE = -1e9f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* lq;        // (H, R, dh)
  const float* lk;
  const int32_t* rel;     // (B, 2, N, N)
  const uint8_t* mask;    // (B, 2, N, N), nonzero = masked
  float* out;             // (B, H, N, dh)
  float* lse;             // (B, H, N)
  float* gsum_part;       // (B, H, n_qtiles)
  int32_t* skip_part;     // (B, H, n_qtiles)
  int B, H, N, R, group;
  float scale;
};

template <int DH>
size_t smem_floats(int R) {
  constexpr int LD = DH + 1;
  return 2 * BM * LD + BN * DH + BM * (BN + 1) + 2 * (size_t)R * LD;
}

template <int DH>
__global__ void __launch_bounds__(THREADS) flex_fwd_kernel(Params p) {
  constexpr int LD = DH + 1;     // padded row stride: conflict-free reads
  constexpr int DPT = DH / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * LD;
  float* Vs = Ks + BN * LD;
  float* Ps = Vs + BN * DH;
  float* Lq = Ps + BM * (BN + 1);      // the relative tables (R x LD)
  float* Lk = Lq + (size_t)p.R * LD;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int N = p.N;
  const size_t bh = (size_t)b * p.H + h;
  const float* qg = p.q + bh * N * DH;
  const float* kg = p.k + bh * N * DH;
  const float* vg = p.v + bh * N * DH;
  const int row0 = qt * BM;
  const int plane = h / p.group;
  const size_t plane_off = ((size_t)b * 2 + plane) * N * N;

  for (int i = tid; i < BM * DH; i += THREADS) {
    const int r = i / DH, d = i % DH, gr = row0 + r;
    Qs[r * LD + d] = gr < N ? qg[(size_t)gr * DH + d] : 0.f;
  }
  {
    const float* lqh = p.lq + (size_t)h * p.R * DH;
    const float* lkh = p.lk + (size_t)h * p.R * DH;
    for (int i = tid; i < p.R * DH; i += THREADS) {
      const int r = i / DH, d = i % DH;
      Lq[r * LD + d] = lqh[i];
      Lk[r * LD + d] = lkh[i];
    }
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = NEG;
    l[ii] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) acc[ii][dd] = 0.f;
  }
  float gsum = 0.f;
  int skips = 0;
  const int nkt = (N + BN - 1) / BN;

  for (int kt = 0; kt < nkt; ++kt) {
    const int col0 = kt * BN;
    for (int i = tid; i < BN * DH; i += THREADS) {
      const int c = i / DH, d = i % DH, gc = col0 + c;
      const bool in = gc < N;
      Ks[c * LD + d] = in ? kg[(size_t)gc * DH + d] : 0.f;
      Vs[c * DH + d] = in ? vg[(size_t)gc * DH + d] : 0.f;
    }
    __syncthreads();

    // weights of this thread's 4x4 entries
    float w[4][4];
    int live_local = 0;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = ty * 4 + ii, gr = row0 + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj, gc = col0 + c;
        const float wr = gr < N && gc < N ? 1.f : 0.f;
        gsum += wr;
        w[ii][jj] = wr;
        live_local |= (wr > 0.f);
      }
    }
    if (!__syncthreads_or(live_local)) {
      ++skips;  // block-uniform: every thread counts the same skips
      continue;
    }

    // scores
    float s[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) qv[ii] = Qs[(ty * 4 + ii) * LD + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = Ks[(tx + 16 * jj) * LD + d];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[ii][jj] += qv[ii] * kv[jj];
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = ty * 4 + ii, gr = row0 + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj, gc = col0 + c;
        float sc = s[ii][jj] * p.scale;
        if (w[ii][jj] > 0.f) {
          if (p.mask[plane_off + (size_t)gr * N + gc]) {
            sc = NEG_CSE;  // the fill replaces the score: no gathers needed
          } else {
            const int rij = p.rel[plane_off + (size_t)gr * N + gc];
            const int rji = p.rel[plane_off + (size_t)gc * N + gr];
            float c2p = 0.f, p2c = 0.f;
            for (int d = 0; d < DH; ++d) {
              c2p += Qs[r * LD + d] * Lk[rij * LD + d];
              p2c += Ks[c * LD + d] * Lq[rji * LD + d];
            }
            sc = sc + c2p * p.scale + p2c * p.scale;
          }
        }
        s[ii][jj] = sc;
      }
    }

    // online max / sum over the 16 lanes that share each row
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      float mt = NEG;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (w[ii][jj] > 0.f) mt = fmaxf(mt, s[ii][jj]);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[ii], mt);
      const float alpha = expf(m[ii] - m_new);
      float lt = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float pr = w[ii][jj] > 0.f ? expf(s[ii][jj] - m_new) * w[ii][jj] : 0.f;
        Ps[(ty * 4 + ii) * (BN + 1) + tx + 16 * jj] = pr;
        lt += pr;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, o);
      l[ii] = l[ii] * alpha + lt;
      m[ii] = m_new;
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) acc[ii][dd] *= alpha;
    }
    __syncthreads();
    for (int c = 0; c < BN; ++c) {
      float vv[DPT];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) vv[dd] = Vs[c * DH + tx + 16 * dd];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float pr = Ps[(ty * 4 + ii) * (BN + 1) + c];
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) acc[ii][dd] += pr * vv[dd];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int gr = row0 + ty * 4 + ii;
    if (gr >= N) continue;
    const bool live = l[ii] > 0.f;
    const float inv = live ? 1.f / l[ii] : 0.f;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd)
      p.out[(bh * N + gr) * DH + tx + 16 * dd] = acc[ii][dd] * inv;
    if (tx == 0) p.lse[bh * N + gr] = live ? m[ii] + logf(l[ii]) : NEG;
  }

  // graph_sum: block reduction of the per-thread partial sums
  for (int o = 16; o > 0; o >>= 1) gsum += __shfl_xor_sync(0xffffffffu, gsum, o);
  __syncthreads();
  if ((tid & 31) == 0) Ps[tid >> 5] = gsum;
  __syncthreads();
  if (tid == 0) {
    float tot = 0.f;
    for (int i = 0; i < THREADS / 32; ++i) tot += Ps[i];
    const size_t slot = bh * gridDim.x + qt;
    p.gsum_part[slot] = tot;
    p.skip_part[slot] = skips;
  }
}

template <int DH>
int launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_floats<DH>(p.R) * sizeof(float);
  if (bytes > 232448) return -2;  // over the 227 KB a block may use
  cudaError_t err = cudaFuncSetAttribute(
      flex_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.N + BM - 1) / BM, p.H, p.B);
  flex_fwd_kernel<DH><<<grid, THREADS, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The head width of ops/build.py HEAD_DIMS: 64 (CSE 512 / 8 heads).
extern "C" int flex_fwd_cse(const float* q, const float* k, const float* v,
                            const float* lq, const float* lk, const int32_t* rel,
                            const uint8_t* mask, float* out, float* lse,
                            float* gsum_part, int32_t* skip_part, int B, int H,
                            int N, int DH, int R, int group, float scale,
                            void* stream) {
  if (DH != 64) return -1;  // head width without an instantiation
  Params p{};
  p.q = q; p.k = k; p.v = v; p.lq = lq; p.lk = lk; p.rel = rel; p.mask = mask;
  p.out = out; p.lse = lse; p.gsum_part = gsum_part; p.skip_part = skip_part;
  p.B = B; p.H = H; p.N = N; p.R = R; p.group = group; p.scale = scale;
  return launch<64>(p, (cudaStream_t)stream);
}
