// Two-pass backward of the SBM blocked attention for Hopper (sm_90a) under
// the expected graph, a pair of SIMT kernels: K8 and K9.  The sampled graph's
// pair (K3/K4) runs on the tensor-core template of flex_bwd_tc.cu.
//
// Replaces: csat_tpu/ops/flex_core.py:_kernel_bwd_calls — the q-pass
// (pallas_call at :498, body _bwd_q_body :389) and the k-pass (pallas_call at
// :519, body _bwd_k_body :434), which share the per-tile math _bwd_tile
// (:356-386) — under sbm_expected with the clip's vjp
// SBMExpectedSpec.tile_dexp (mods.py:254-261):
//   * flex_bwd_q_sbm_expected: one block per (b, h, 64-row q-tile) walks the
//     k-tiles and accumulates dq (B, H, N, dh) and dR (B, H, N, kk);
//   * flex_bwd_k_sbm_expected: one block per (b, h, 64-column k-tile) walks
//     the q-tiles and accumulates dk, dv (B, H, N, dh) and dK̂ (B, H, N, kk).
// Per entry (i, j) of a tile, with s = q_i·k_j / sqrt(dh), lse_i from the
// forward (−1e30 on a row with no live weight), dvec_i = g_i·out_i, gs the
// graph_sum cotangent of (b, h) and keep the dropout keep-field:
//   a_raw = clip(R_i·K̂_j, floor, .99) · real,  a_eff = a_raw (1 − pad_j)
//   e     = exp(min(s − lse_i, 80))   (0 on a dead row)
//   dattn = (g_i·v_j) keep
//   d_s   = e a_eff (dattn − dvec_i)               → dq_i, dk_j (·/sqrt(dh))
//   d_a   = e (dattn − dvec_i)(1 − pad_j) + gs      (the pad gate only on
//                                                   the attention term)
//   d_exp = d_a · c(R_i·K̂_j) · real                → dR_i += d_exp K̂_j,
//                                                     dK̂_j += d_exp R_i
//   dv_j += e a_eff keep g_i
// with c(x) = 1 inside (floor, .99), 1/2 at x == floor or x == .99 (the even
// split jnp.clip's vjp gives a tie), 0 outside.  The dropout bits are
// regenerated from the counter hash with the forward's seed, stride
// round_up(N, 128) and global indices (hashrng.cuh), and R·K̂ᵀ is summed in
// the forward's order, so the weights are the forward's bit for bit.
//
// What bounds it on an H100: at the training shape (B=64, H=8, N=150,
// dh=64, kk=10) each pass moves about 15 MB and does about 2 GFLOP of f32
// work, some 5 µs of HBM time and 30 µs of f32 pipe time at the data sheet's
// peaks; the per-tile loop of one 64-row block (two dh-deep products per
// entry, 10 cluster products per entry, and the accumulation products) sets
// the time, since the grid is B·H·3 = 1536 blocks of 256
// threads over 132 SMs.
//
// Design:
//   * The TPU carries the accumulators in VMEM scratch across a sequential
//     grid axis; here the sweep is a loop inside the block, so dq/dR (q-pass)
//     and dk/dv/dK̂ (k-pass) live in registers for the whole sweep and are
//     written once.  No atomics: every output row belongs to one block.
//   * A tile whose effective weight is all zero skips the score products,
//     but still adds d_exp(gs) into dR / dK̂: on padded key columns a_raw
//     is live while a_eff is 0 (flex_core.py:381-384).  An entry with weight
//     0 whose clip gate is open (a tie at floor == 0) still needs e, so such
//     a tile takes the full branch: the result does not depend on the tile
//     size.
//   * The cluster axis is kk wide (<= 16) in shared memory, not 128 lanes.
//   * Simple SIMT f32, as in flex_fwd.cu: 256 threads, each owns a 4x4 block
//     of the 64x64 tile for the entry math and 4 rows (q-pass) or 4 columns
//     (k-pass) x dh/16 of the accumulators; the tile's d_s, e·a_eff·keep and
//     d_exp pass through shared memory between the two thread layouts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hashrng.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int PLD = BN + 1;  // row stride of the 64x64 tiles in shared memory
constexpr int THREADS = 256;
constexpr int KKMAX = 16;
constexpr int KKLD = KKMAX + 1;
constexpr int KSLOTS = BM * KKMAX / THREADS;  // (row, cluster) pairs per thread
constexpr float NEG = -1e30f;
constexpr float LIVE_LSE = -5e29f;  // lse above this: the row saw live weight

struct Params {
  const float* q;         // (B, H, N, dh)
  const float* k;
  const float* v;
  const float* r;         // (B, H, N, kk)  R = Q̂·S
  const float* kh;        // (B, H, N, kk)
  const float* pad;       // (B, N), 1.0 = padded key
  const int32_t* dseed;   // (1,) dropout stream seed, read when rate > 0
  const float* lse;       // (B, H, N) forward log-sum-exp (before dropout)
  const float* dvec;      // (B, H, N) Σ_d g·out
  const float* gout;      // (B, H, N, dh) output cotangent
  const float* gs;        // (B, H) graph_sum cotangent
  float* dq;              // q-pass outputs
  float* dr;
  float* dk;              // k-pass outputs
  float* dv;
  float* dkh;
  int B, H, N, kk;
  uint32_t stride;        // hash row stride, round_up(N, 128)
  float floor_, scale, rate, keep_scale;
};

// Shared memory of one pass, in floats: Q, g_out, K and V tiles (dh + 1
// wide), the d_s / d_exp (and, k-pass, e·a_eff·keep) tiles, the R and K̂
// tiles, and the pad, lse and dvec vectors.
template <int DH>
constexpr size_t smem_floats(bool k_pass) {
  return 4 * (size_t)BM * (DH + 1) + (k_pass ? 3 : 2) * (size_t)BM * PLD
         + 2 * (size_t)BM * KKLD + 3 * BM;
}

// Loads rows [row0, row0 + 64) of a (N, width) slab into a (64, ld) tile,
// zero beyond N and beyond width (up to `cols` columns).
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, int width,
                                          int cols, int row0, int N, int tid) {
  for (int i = tid; i < BM * cols; i += THREADS) {
    const int r = i / cols, c = i % cols, g = row0 + r;
    dst[r * ld + c] = (g < N && c < width) ? src[(size_t)g * width + c] : 0.f;
  }
}

// The entry math of one (q-tile, k-tile) pair for this thread's 4x4 entries
// (rows ty*4+ii, columns tx+16*jj); writes d_s to Ds, d_exp to De and, when
// As is given, e·a_eff·keep to As.  Returns whether the tile is live (some
// a_eff > 0, or some zero-weight entry whose clip gate is open on an
// unpadded key); block-uniform, and every thread must call it.
template <int DH>
__device__ bool tile_backward(const Params& p, const float* Qs, const float* Gs,
                              const float* Ks, const float* Vs, const float* Rs,
                              const float* Khs, const float* pads, const float* lses,
                              const float* dvecs, int row0, int col0, uint32_t bh,
                              uint32_t dseed, float gs, float* Ds, float* De,
                              float* As) {
  constexpr int LD = DH + 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int N = p.N;
  float a_raw[4][4], a_eff[4][4];
  float cgate[4][4];  // the clip's vjp factor times the real gate
  int live_local = 0;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = ty * 4 + ii, gr = row0 + r;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = tx + 16 * jj, gc = col0 + c;
      float a = 0.f, cg = 0.f;
      if (gr < N && gc < N) {
        float ea = 0.f;
        for (int j = 0; j < p.kk; ++j)
          ea = __fadd_rn(ea, __fmul_rn(Rs[r * KKLD + j], Khs[c * KKLD + j]));
        a = fminf(fmaxf(ea, p.floor_), 0.99f);
        cg = (ea > p.floor_ && ea < 0.99f) ? 1.f
             : ((ea == p.floor_ || ea == 0.99f) ? 0.5f : 0.f);
      }
      a_raw[ii][jj] = a;
      a_eff[ii][jj] = a * (1.f - pads[c]);
      cgate[ii][jj] = cg;
      live_local |= (a_eff[ii][jj] > 0.f);
      live_local |= (cg > 0.f && pads[c] < 1.f);
    }
  }
  const bool live = __syncthreads_or(live_local);

  float d_s[4][4], d_a[4][4], att[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      d_s[ii][jj] = 0.f;
      d_a[ii][jj] = gs;
      att[ii][jj] = 0.f;
    }
  if (live) {
    float s[4][4], dat[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = dat[ii][jj] = 0.f;
    for (int d = 0; d < DH; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        qv[ii] = Qs[(ty * 4 + ii) * LD + d];
        gv[ii] = Gs[(ty * 4 + ii) * LD + d];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        kv[jj] = Ks[(tx + 16 * jj) * LD + d];
        vv[jj] = Vs[(tx + 16 * jj) * LD + d];
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[ii][jj] += qv[ii] * kv[jj];
          dat[ii][jj] += gv[ii] * vv[jj];
        }
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = ty * 4 + ii, gr = row0 + r;
      const float lse = lses[r];
      const bool finite = lse > LIVE_LSE;
      const float dvec = dvecs[r];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj, gc = col0 + c;
        const float e = finite ? expf(fminf(s[ii][jj] * p.scale - lse, 80.f)) : 0.f;
        float keep = 1.f;
        if (p.rate > 0.f)
          keep = hash_uniform(dseed, bh, gr, gc, p.stride) >= p.rate ? p.keep_scale : 0.f;
        const float t = dat[ii][jj] * keep - dvec;
        const float attn = e * a_eff[ii][jj];
        d_s[ii][jj] = attn * t;
        d_a[ii][jj] = e * t * (1.f - pads[c]) + gs;
        att[ii][jj] = attn * keep;
      }
    }
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int at = (ty * 4 + ii) * PLD + tx + 16 * jj;
      Ds[at] = d_s[ii][jj];
      De[at] = d_a[ii][jj] * cgate[ii][jj];
      if (As) As[at] = att[ii][jj];
    }
  return live;
}

// Per-block tile pointers into dynamic shared memory.
template <int DH>
struct Tiles {
  float *Qs, *Gs, *Ks, *Vs, *Ds, *De, *As, *Rs, *Khs, *pads, *lses, *dvecs;
  __device__ Tiles(float* smem, bool k_pass) {
    constexpr int LD = DH + 1;
    Qs = smem;
    Gs = Qs + BM * LD;
    Ks = Gs + BM * LD;
    Vs = Ks + BN * LD;
    Ds = Vs + BN * LD;
    De = Ds + BM * PLD;
    As = k_pass ? De + BM * PLD : nullptr;
    Rs = De + (k_pass ? 2 : 1) * BM * PLD;
    Khs = Rs + BM * KKLD;
    pads = Khs + BN * KKLD;
    lses = pads + BN;
    dvecs = lses + BM;
  }
};

// Q-side rows of tile row0: Q, g_out, R, lse (NEG beyond N) and dvec.
template <int DH>
__device__ void load_q_side(const Params& p, const Tiles<DH>& t, size_t bh, int row0, int tid) {
  const int N = p.N;
  load_rows(t.Qs, DH + 1, p.q + bh * N * DH, DH, DH, row0, N, tid);
  load_rows(t.Gs, DH + 1, p.gout + bh * N * DH, DH, DH, row0, N, tid);
  load_rows(t.Rs, KKLD, p.r + bh * N * p.kk, p.kk, KKMAX, row0, N, tid);
  for (int i = tid; i < BM; i += THREADS) {
    const int g = row0 + i;
    t.lses[i] = g < N ? p.lse[bh * N + g] : NEG;
    t.dvecs[i] = g < N ? p.dvec[bh * N + g] : 0.f;
  }
}

// K-side rows of tile col0: K, V, K̂ and the pad gate (1 beyond N).
template <int DH>
__device__ void load_k_side(const Params& p, const Tiles<DH>& t, size_t bh, int b, int col0,
                            int tid) {
  const int N = p.N;
  load_rows(t.Ks, DH + 1, p.k + bh * N * DH, DH, DH, col0, N, tid);
  load_rows(t.Vs, DH + 1, p.v + bh * N * DH, DH, DH, col0, N, tid);
  load_rows(t.Khs, KKLD, p.kh + bh * N * p.kk, p.kk, KKMAX, col0, N, tid);
  for (int i = tid; i < BN; i += THREADS) {
    const int g = col0 + i;
    t.pads[i] = g < N ? p.pad[(size_t)b * N + g] : 1.f;
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS) bwd_q_kernel(Params p) {
  constexpr int LD = DH + 1;
  constexpr int DPT = DH / 16;
  extern __shared__ float smem[];
  const Tiles<DH> t(smem, false);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int N = p.N, kk = p.kk;
  const size_t bh = (size_t)b * p.H + h;
  const int row0 = qt * BM;
  const uint32_t dseed = p.rate > 0.f ? (uint32_t)p.dseed[0] : 0u;
  const float gs = p.gs[bh];

  load_q_side<DH>(p, t, bh, row0, tid);
  float dq[4][DPT], dr[KSLOTS];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) dq[ii][dd] = 0.f;
#pragma unroll
  for (int s = 0; s < KSLOTS; ++s) dr[s] = 0.f;

  const int nkt = (N + BN - 1) / BN;
  for (int kt = 0; kt < nkt; ++kt) {
    const int col0 = kt * BN;
    load_k_side<DH>(p, t, bh, b, col0, tid);
    __syncthreads();
    const bool live = tile_backward<DH>(p, t.Qs, t.Gs, t.Ks, t.Vs, t.Rs, t.Khs, t.pads,
                                        t.lses, t.dvecs, row0, col0, (uint32_t)bh, dseed, gs,
                                        t.Ds, t.De, nullptr);
    __syncthreads();
    if (live) {
      for (int c = 0; c < BN; ++c) {
        float kv[DPT];
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) kv[dd] = t.Ks[c * LD + tx + 16 * dd];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const float ds = t.Ds[(ty * 4 + ii) * PLD + c];
#pragma unroll
          for (int dd = 0; dd < DPT; ++dd) dq[ii][dd] += ds * kv[dd];
        }
      }
    }
#pragma unroll
    for (int s = 0; s < KSLOTS; ++s) {
      const int idx = tid + s * THREADS;
      if (idx < BM * kk) {
        const int r = idx / kk, j = idx % kk;
        float accum = 0.f;
        for (int c = 0; c < BN; ++c) accum += t.De[r * PLD + c] * t.Khs[c * KKLD + j];
        dr[s] += accum;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int gr = row0 + ty * 4 + ii;
    if (gr >= N) continue;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd)
      p.dq[(bh * N + gr) * DH + tx + 16 * dd] = dq[ii][dd] * p.scale;
  }
#pragma unroll
  for (int s = 0; s < KSLOTS; ++s) {
    const int idx = tid + s * THREADS;
    if (idx < BM * kk) {
      const int gr = row0 + idx / kk;
      if (gr < N) p.dr[(bh * N + gr) * kk + idx % kk] = dr[s];
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS) bwd_k_kernel(Params p) {
  constexpr int LD = DH + 1;
  constexpr int DPT = DH / 16;
  extern __shared__ float smem[];
  const Tiles<DH> t(smem, true);
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int N = p.N, kk = p.kk;
  const size_t bh = (size_t)b * p.H + h;
  const int col0 = kt * BN;
  const uint32_t dseed = p.rate > 0.f ? (uint32_t)p.dseed[0] : 0u;
  const float gs = p.gs[bh];

  load_k_side<DH>(p, t, bh, b, col0, tid);
  float dk[4][DPT], dv[4][DPT], dkh[KSLOTS];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) dk[ii][dd] = dv[ii][dd] = 0.f;
#pragma unroll
  for (int s = 0; s < KSLOTS; ++s) dkh[s] = 0.f;

  const int nqt = (N + BM - 1) / BM;
  for (int qt = 0; qt < nqt; ++qt) {
    const int row0 = qt * BM;
    load_q_side<DH>(p, t, bh, row0, tid);
    __syncthreads();
    const bool live = tile_backward<DH>(p, t.Qs, t.Gs, t.Ks, t.Vs, t.Rs, t.Khs, t.pads,
                                        t.lses, t.dvecs, row0, col0, (uint32_t)bh, dseed, gs,
                                        t.Ds, t.De, t.As);
    __syncthreads();
    if (live) {
      for (int r = 0; r < BM; ++r) {
        float qv[DPT], gv[DPT];
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) {
          qv[dd] = t.Qs[r * LD + tx + 16 * dd];
          gv[dd] = t.Gs[r * LD + tx + 16 * dd];
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int c = ty * 4 + ii;
          const float ds = t.Ds[r * PLD + c], at = t.As[r * PLD + c];
#pragma unroll
          for (int dd = 0; dd < DPT; ++dd) {
            dk[ii][dd] += ds * qv[dd];
            dv[ii][dd] += at * gv[dd];
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < KSLOTS; ++s) {
      const int idx = tid + s * THREADS;
      if (idx < BN * kk) {
        const int c = idx / kk, j = idx % kk;
        float accum = 0.f;
        for (int r = 0; r < BM; ++r) accum += t.De[r * PLD + c] * t.Rs[r * KKLD + j];
        dkh[s] += accum;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int gc = col0 + ty * 4 + ii;
    if (gc >= N) continue;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      p.dk[(bh * N + gc) * DH + tx + 16 * dd] = dk[ii][dd] * p.scale;
      p.dv[(bh * N + gc) * DH + tx + 16 * dd] = dv[ii][dd];
    }
  }
#pragma unroll
  for (int s = 0; s < KSLOTS; ++s) {
    const int idx = tid + s * THREADS;
    if (idx < BN * kk) {
      const int gc = col0 + idx / kk;
      if (gc < N) p.dkh[(bh * N + gc) * kk + idx % kk] = dkh[s];
    }
  }
}

template <int DH>
int launch(const Params& p, bool k_pass, cudaStream_t stream) {
  const size_t bytes = smem_floats<DH>(k_pass) * sizeof(float);
  if (bytes > 232448) return -2;  // over the 227 KB a block may use
  const void* fn = k_pass ? (const void*)bwd_k_kernel<DH> : (const void*)bwd_q_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.N + BM - 1) / BM, p.H, p.B);
  if (k_pass) bwd_k_kernel<DH><<<grid, THREADS, bytes, stream>>>(p);
  else bwd_q_kernel<DH><<<grid, THREADS, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// The head widths of ops/build.py HEAD_DIMS: 64 (python), 96 (java).
int dispatch(int dh, const Params& p, bool k_pass, cudaStream_t stream) {
  if (dh == 64) return launch<64>(p, k_pass, stream);
  if (dh == 96) return launch<96>(p, k_pass, stream);
  return -1;  // head width without an instantiation
}

int run(const float* q, const float* k, const float* v, const float* r, const float* kh,
        const float* pad, const int32_t* dseed, const float* lse, const float* dvec,
        const float* gout, const float* gs, float* dq, float* dr, float* dk, float* dv,
        float* dkh, int B, int H, int N, int DH, int KK, int stride, float floor_,
        float scale, float rate, float keep_scale, bool k_pass, void* stream) {
  if (KK < 1 || KK > KKMAX) return -3;
  if (rate > 0.f && dseed == nullptr) return -4;
  Params p{};
  p.q = q; p.k = k; p.v = v; p.r = r; p.kh = kh; p.pad = pad;
  p.dseed = dseed; p.lse = lse; p.dvec = dvec; p.gout = gout; p.gs = gs;
  p.dq = dq; p.dr = dr; p.dk = dk; p.dv = dv; p.dkh = dkh;
  p.B = B; p.H = H; p.N = N; p.kk = KK; p.stride = (uint32_t)stride;
  p.floor_ = floor_; p.scale = scale; p.rate = rate; p.keep_scale = keep_scale;
  return dispatch(DH, p, k_pass, (cudaStream_t)stream);
}

}  // namespace

// The argument lists are those of the sampled pair (flex_bwd_tc.cu) without
// the sample seed: the expected mod draws no graph.
extern "C" int flex_bwd_q_sbm_expected(
    const float* q, const float* k, const float* v, const float* r, const float* kh,
    const float* pad, const int32_t* dseed, const float* lse, const float* dvec,
    const float* gout, const float* gs, float* dq, float* dr, int B, int H, int N, int DH,
    int KK, int stride, float floor_, float scale, float rate, float keep_scale,
    void* stream) {
  return run(q, k, v, r, kh, pad, dseed, lse, dvec, gout, gs, dq, dr, nullptr, nullptr,
             nullptr, B, H, N, DH, KK, stride, floor_, scale, rate, keep_scale, false, stream);
}

extern "C" int flex_bwd_k_sbm_expected(
    const float* q, const float* k, const float* v, const float* r, const float* kh,
    const float* pad, const int32_t* dseed, const float* lse, const float* dvec,
    const float* gout, const float* gs, float* dk, float* dv, float* dkh, int B, int H,
    int N, int DH, int KK, int stride, float floor_, float scale, float rate,
    float keep_scale, void* stream) {
  return run(q, k, v, r, kh, pad, dseed, lse, dvec, gout, gs, nullptr, nullptr, dk, dv, dkh,
             B, H, N, DH, KK, stride, floor_, scale, rate, keep_scale, true, stream);
}
