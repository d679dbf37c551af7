// Blocked weighted-softmax attention forward on Hopper's tensor cores
// (sm_90a) for the expected-SBM mod: the kernel K2 (flex_fwd_sbm_expected).
// The CSE, sampled and graph mods (K1, K6, K7) stay on the SIMT template of
// flex_fwd.cu.
//
// Replaces: csat_tpu/ops/flex_core.py:_fwd_call (pallas_call at :310, body
// _fwd_body :230) under SBMExpectedSpec.tile_weight_parts
// (csat_tpu/ops/mods.py:248-252): s = q·k / sqrt(dh), weight clip(R·K̂ᵀ,
// floor, .99) · real · (1 - key_pad), R = Q̂·S formed outside, with hash
// dropout on P (flex_core.py:214-219).  It computes out = Σ_j w_ij e^{s_ij}
// keep_ij V_j / Σ_j w_ij e^{s_ij} (rows with no live weight exactly 0), lse
// before dropout, Σ w_raw per q-tile and the dead (64-row, 64-column) tiles
// per q-tile — the outputs, sentinels and argument list of the SIMT kernel
// it replaces.
//
// What bounds it on an H100: at B 64, N 150, dh 64 the call moves about
// 90 MB (q, k, v, out, the factors) and needs about 2 GFLOP of dot products
// and 0.3 GFLOP of R·K̂ᵀ: ~0.03 ms either way, so neither bound is near.
// What limited the SIMT kernel was its arithmetic: every product was a
// scalar FMA.  What limits this one is latency: a block is 4 warps, each a
// long chain of dependent loads, products and barriers.
//
// Design:
//   * Tensor cores, f32-faithful.  Q·Kᵀ and P·V run on mma.sync.m16n8k8
//     TF32 with the 3xTF32 split (each f32 operand x = hi + lo, hi =
//     tf32(x), lo = tf32(x − hi); a·b ≈ hi·lo + lo·hi + hi·hi with f32
//     accumulation), which keeps about f32 precision.  One TF32 product
//     keeps about 3 decimal digits: it would break the 2e-5 parity
//     tolerance.  mma.sync, not wgmma: a warp owns 16 rows, so P stays in
//     registers between the two products (the k index of P·V is permuted so
//     that the accumulator layout of S is the A operand layout of P·V: k =
//     tig ↔ column 2·tig, k = tig+4 ↔ 2·tig+1, and V is read at the same
//     permuted rows), rows come in 16-row steps and key columns in 8-column
//     steps, so N = 150 computes 160 x 152 entries, not 192 x 192; wgmma's
//     64-row A tiles and K-major TF32 operands (V transposed in shared
//     memory) would force P through shared memory and buy nothing at 64-row
//     tiles of a 150-node problem.
//   * R·K̂ᵀ is summed j = 0, 1, … with one rounding per product and per sum
//     (__fmul_rn/__fadd_rn, no FMA), as ops/mods.py:exp_adjacency and the
//     backward kernels sum it, so the weights are the same bits.
//   * Loads: K (with K̂ and the pad row) and V are copied with cp.async in
//     two groups, so V arrives while the weights, Q·Kᵀ and the softmax run;
//     Q is read once into registers.  Single-buffered: three k-tiles a block
//     at N 150 leave little to pipeline (43 KB at dh 64, 60 KB at dh 96).
//   * Skip count at FLEX_BLOCK = 64: a block is one 64-row q-tile (4 warps x
//     16 rows) and walks 64-column k-tiles; a k-tile with no live weight in
//     the whole block is skipped and counted, so the count equals
//     reference_block_skip at 64.  Warps whose rows all lie past N only load.
//   * NEG = -1e30 is the running max of a row that has seen no live weight.
//     Dropout multiplies P where it enters P·V, never l.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hashrng.cuh"

namespace {

constexpr int BM = 64;          // q-tile rows: 4 warps x 16
constexpr int BN = 64;          // k-tile columns
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int KKMAX = 16;
constexpr int KKLD = KKMAX + 1;
constexpr float NEG = -1e30f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* r;         // (B, H, N, kk)
  const float* kh;        // (B, H, N, kk)
  const float* pad;       // (B, N), 1.0 = padded key
  const int32_t* dseed;   // (1,) dropout stream seed, read when rate > 0
  float* out;             // (B, H, N, dh)
  float* lse;             // (B, H, N)
  float* gsum_part;       // (B, H, n_qtiles)
  int32_t* skip_part;     // (B, H, n_qtiles)
  int B, H, N, kk;
  uint32_t stride;        // hash row stride, round_up(N, 128)
  float floor_, scale, rate, keep_scale;
};

// ---- tensor-core helpers ---------------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with both parts TF32; hi·hi + hi·lo + lo·hi keeps ~f32 precision
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the A operand of one m16n8k8 product, split once and reused across n8 tiles
__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
}

// d += a·b in 3xTF32: the small cross terms first, the large term last
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh[2], bl[2];
  split(b0, bh[0], bl[0]);
  split(b1, bh[1], bl[1]);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// ---- asynchronous copies ---------------------------------------------------

__device__ __forceinline__ void cp16(float* dst, const float* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N_PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N_PENDING));
}

// rows [row0, row0 + 64) of a (n_rows, DH) matrix into a (64, LD) tile;
// rows past n_rows read as 0
template <int DH, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int n_rows) {
  constexpr int C4 = DH / 4;
  for (int i = threadIdx.x; i < BN * C4; i += THREADS) {
    const int r = i / C4, c = (i % C4) * 4, gr = row0 + r;
    const bool in = gr < n_rows;
    cp16(dst + r * LD + c, src + (size_t)(in ? gr : 0) * DH + c, in);
  }
}

// ---- the kernel ------------------------------------------------------------

size_t smem_bytes(int dh) {
  // K and V tiles, K̂ᵀ, the pad row, R
  const size_t n = (size_t)BN * (dh + 16) + (size_t)BN * (dh + 4) + KKMAX * BN + BN + BM * KKLD;
  return n * sizeof(float);
}

// The k index of Q·Kᵀ (reducing over dh) is permuted
// so that a lane's operands of two k-steps lie in four consecutive floats:
// in k-steps 2p and 2p + 1, lane tig's k = tig and k = tig + 4 are the
// columns d0 + 2h and d0 + 2h + 1 of d0 = 16p + 4·tig (h = the step's
// parity).  A and B use the same map, so the sum is unchanged, and each
// pair of k-steps needs one 16-byte load per operand row instead of four
// 4-byte ones.  K-layout tiles have the row stride DH + 16 (≡ 16 mod 32
// words), so these loads are conflict-free.

// A fragments of k-steps 2p and 2p + 1 from rows x0 (row g) and x1 (g + 8)
__device__ __forceinline__ void pair_frags(const float4& x0, const float4& x1,
                                           float (&a0)[4], float (&a1)[4]) {
  a0[0] = x0.x; a0[1] = x1.x; a0[2] = x0.y; a0[3] = x1.y;
  a1[0] = x0.z; a1[1] = x1.z; a1[2] = x0.w; a1[3] = x1.w;
}

__device__ __forceinline__ float4 row4(const float* row, bool in) {
  return in ? *reinterpret_cast<const float4*>(row) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Lane layout of one m16n8 accumulator: c[0], c[1] at (g, 2·tig + {0, 1}),
// c[2], c[3] at (g + 8, 2·tig + {0, 1}); entry i of n8 tile t of a warp is
// row wrow + g + 8·(i >> 1), column 8·t + 2·tig + (i & 1).
template <int DH>
__global__ void __launch_bounds__(THREADS) flex_tc_kernel(Params p) {
  constexpr int LD = DH + 4;     // V tile: ≡ 4 (mod 32), its fragment reads are conflict-free
  constexpr int LDK = DH + 16;   // K tile: ≡ 16 (mod 32), for the 16-byte pair loads
  constexpr int KS = DH / 8;     // k-steps of Q·Kᵀ = n8 tiles of P·V
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[WARPS];
  float* Ks = smem;
  float* Vs = Ks + BN * LDK;
  float* KhT = Vs + BN * LD;      // (KKMAX, BN)
  float* pads = KhT + KKMAX * BN;  // (BN)
  float* Rs = pads + BN;           // (BM, KKLD)

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int N = p.N;
  const size_t bh = (size_t)b * p.H + h;
  const float* qg = p.q + bh * N * DH;
  const float* kg = p.k + bh * N * DH;
  const float* vg = p.v + bh * N * DH;
  const int row0 = qt * BM, wrow = warp * 16;
  const int gr_[2] = {row0 + wrow + g, row0 + wrow + g + 8};
  const bool active = row0 + wrow < N;   // the warp has a real row
  const bool dropout = p.rate > 0.f;
  const uint32_t dseed = dropout ? (uint32_t)p.dseed[0] : 0u;

  // Q fragments of the warp's 16 rows, f32, read once (permuted k)
  float qf[KS][4];
#pragma unroll
  for (int pp = 0; pp < KS / 2; ++pp) {
    const int d0 = 16 * pp + 4 * tig;
    pair_frags(row4(qg + (size_t)gr_[0] * DH + d0, gr_[0] < N),
               row4(qg + (size_t)gr_[1] * DH + d0, gr_[1] < N), qf[2 * pp], qf[2 * pp + 1]);
  }

  const float* rg = p.r + bh * N * p.kk;
  for (int i = tid; i < BM * KKMAX; i += THREADS) {
    const int r = i / KKMAX, j = i % KKMAX, gr = row0 + r;
    Rs[r * KKLD + j] = (gr < N && j < p.kk) ? rg[(size_t)gr * p.kk + j] : 0.f;
  }

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[KS][4] = {};
  float gsum = 0.f;
  int skips = 0;
  const int nkt = (N + BN - 1) / BN;

  for (int kt = 0; kt < nkt; ++kt) {
    const int col0 = kt * BN;
    const int ntk = min(8, (N - col0 + 7) >> 3);  // n8 column tiles holding real keys
    float w[8][4] = {};  // the effective weights

    // ---- K (+ K̂, pads), and V in a second group that lands later ----
    load_rows<DH, LDK>(Ks, kg, col0, N);
    const float* khg = p.kh + bh * N * p.kk;
    for (int i = tid; i < KKMAX * BN; i += THREADS) {
      const int j = i / BN, c = i % BN, gc = col0 + c;
      const bool in = gc < N && j < p.kk;
      cp4(KhT + j * BN + c, khg + (in ? (size_t)gc * p.kk + j : 0), in);
    }
    for (int c = tid; c < BN; c += THREADS) {
      const int gc = col0 + c;
      cp4(pads + c, p.pad + (size_t)b * N + (gc < N ? gc : 0), gc < N);
    }
    cp_commit();
    load_rows<DH, LD>(Vs, vg, col0, N);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    // ---- weights and liveness ----
    int live_local = 0;
    const float* r0 = Rs + (wrow + g) * KKLD;
    const float* r1 = r0 + 8 * KKLD;
    for (int j = 0; j < p.kk; ++j) {
      const float a0 = r0[j], a1 = r1[j];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float2 kv = *reinterpret_cast<const float2*>(KhT + j * BN + 8 * t + 2 * tig);
        w[t][0] = __fadd_rn(w[t][0], __fmul_rn(a0, kv.x));
        w[t][1] = __fadd_rn(w[t][1], __fmul_rn(a0, kv.y));
        w[t][2] = __fadd_rn(w[t][2], __fmul_rn(a1, kv.x));
        w[t][3] = __fadd_rn(w[t][3], __fmul_rn(a1, kv.y));
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 8 * t + 2 * tig + (i & 1);
        const bool real = gr_[i >> 1] < N && col0 + c < N;
        const float pr = fminf(fmaxf(w[t][i], p.floor_), 0.99f);
        const float wr = real ? pr : 0.f;
        const float we = wr * (1.f - pads[c]);
        gsum += wr;
        w[t][i] = we;
        live_local |= (we > 0.f);
      }
    if (!__syncthreads_or(live_local)) {
      ++skips;  // block-uniform: every thread counts the same skips
      cp_wait<0>();  // V lands before the next tile
      continue;
    }

    float sacc[8][4] = {};
    if (active) {
      // ---- S = Q·Kᵀ ----
#pragma unroll
      for (int pp = 0; pp < KS / 2; ++pp) {
        const int d0 = 16 * pp + 4 * tig;
        uint32_t h0[4], l0[4], h1[4], l1[4];
        split4(qf[2 * pp], h0, l0);
        split4(qf[2 * pp + 1], h1, l1);
#pragma unroll
        for (int t = 0; t < 8; ++t)
          if (t < ntk) {
            const float4 b = *reinterpret_cast<const float4*>(Ks + (8 * t + g) * LDK + d0);
            mma3(sacc[t], h0, l0, b.x, b.y);
            mma3(sacc[t], h1, l1, b.z, b.w);
          }
      }

      // ---- scores ----
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) sacc[t][i] *= p.scale;

      // ---- online max / sum over the 4 lanes that share each row ----
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mt = NEG;
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (w[t][2 * hr + e] > 0.f) mt = fmaxf(mt, sacc[t][2 * hr + e]);
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m[hr], mt);
        const float alpha = expf(m[hr] - m_new);
        float lt = 0.f;
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * hr + e;
            const float we = w[t][i];
            const float pr = we > 0.f ? expf(sacc[t][i] - m_new) * we : 0.f;
            float keep = 1.f;
            if (dropout && pr > 0.f)
              keep = hash_uniform(dseed, (uint32_t)bh, gr_[hr], col0 + 8 * t + 2 * tig + e,
                                  p.stride) >= p.rate ? p.keep_scale : 0.f;
            sacc[t][i] = pr * keep;  // P, dropped out; the row sum takes pr
            lt += pr;
          }
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        l[hr] = l[hr] * alpha + lt;
        m[hr] = m_new;
#pragma unroll
        for (int dt = 0; dt < KS; ++dt) {
          o[dt][2 * hr] *= alpha;
          o[dt][2 * hr + 1] *= alpha;
        }
      }
    }

    cp_wait<0>();
    __syncthreads();  // V is in shared memory

    if (active) {
      // ---- O += P·V: P straight from the S accumulators.  The k index of
      // this product is permuted (k = tig <-> key 2 tig, k = tig + 4 <->
      // key 2 tig + 1), so the accumulator layout is the A layout, and V's
      // rows are read in the same order ----
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (t < ntk) {
          const float a[4] = {sacc[t][0], sacc[t][2], sacc[t][1], sacc[t][3]};
          uint32_t ah[4], al[4];
          split4(a, ah, al);
          const float* vp = Vs + (8 * t + 2 * tig) * LD + g;
#pragma unroll
          for (int dt = 0; dt < KS; ++dt) mma3(o[dt], ah, al, vp[8 * dt], vp[LD + 8 * dt]);
        }
    }
    __syncthreads();  // the tiles are free for the next k-tile
  }

  // ---- epilogue ----
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int gr = gr_[hr];
    if (gr >= N) continue;
    const bool live = l[hr] > 0.f;
    const float inv = live ? 1.f / l[hr] : 0.f;
    float* dst = p.out + (bh * N + gr) * DH + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < KS; ++dt)
      *reinterpret_cast<float2*>(dst + 8 * dt) =
          make_float2(o[dt][2 * hr] * inv, o[dt][2 * hr + 1] * inv);
    if (tig == 0) p.lse[bh * N + gr] = live ? m[hr] + logf(l[hr]) : NEG;
  }

  // graph_sum: block reduction of the per-thread partial sums
  for (int off = 16; off > 0; off >>= 1) gsum += __shfl_xor_sync(0xffffffffu, gsum, off);
  if (lane == 0) red[warp] = gsum;
  __syncthreads();
  if (tid == 0) {
    float tot = 0.f;
    for (int i = 0; i < WARPS; ++i) tot += red[i];
    const size_t slot = bh * gridDim.x + qt;
    p.gsum_part[slot] = tot;
    p.skip_part[slot] = skips;
  }
}

template <int DH>
int launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_bytes(DH);
  cudaError_t err = cudaFuncSetAttribute(
      flex_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // the largest shared-memory carveout, so that the shared memory never
  // caps the blocks an SM holds below what the registers allow
  err = cudaFuncSetAttribute(flex_tc_kernel<DH>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.N + BM - 1) / BM, p.H, p.B);
  flex_tc_kernel<DH><<<grid, THREADS, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

Params base(const float* q, const float* k, const float* v, float* out, float* lse,
            float* gsum_part, int32_t* skip_part, int B, int H, int N, float scale) {
  Params p{};
  p.q = q; p.k = k; p.v = v;
  p.out = out; p.lse = lse; p.gsum_part = gsum_part; p.skip_part = skip_part;
  p.B = B; p.H = H; p.N = N; p.scale = scale;
  p.rate = 0.f; p.keep_scale = 1.f;
  return p;
}

}  // namespace

// The head widths of ops/build.py HEAD_DIMS: 64, and 96 for the java
// config's SBM encoder (768 / 8 heads).
extern "C" int flex_fwd_sbm_expected(const float* q, const float* k, const float* v,
                                     const float* r, const float* kh, const float* pad,
                                     const int32_t* dseed, float* out, float* lse,
                                     float* gsum_part, int32_t* skip_part, int B, int H,
                                     int N, int DH, int KK, int stride, float floor_,
                                     float scale, float rate, float keep_scale,
                                     void* stream) {
  if (KK < 1 || KK > KKMAX) return -3;
  if (rate > 0.f && dseed == nullptr) return -4;
  Params p = base(q, k, v, out, lse, gsum_part, skip_part, B, H, N, scale);
  p.r = r; p.kh = kh; p.pad = pad; p.dseed = dseed; p.kk = KK;
  p.stride = (uint32_t)stride; p.floor_ = floor_;
  p.rate = rate; p.keep_scale = keep_scale;
  if (DH == 64) return launch<64>(p, (cudaStream_t)stream);
  if (DH == 96) return launch<96>(p, (cudaStream_t)stream);
  return -1;  // head width without an instantiation
}
