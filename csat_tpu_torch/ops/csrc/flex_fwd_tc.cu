// Blocked weighted-softmax attention forward on Hopper's tensor cores
// (sm_90a) for every mod: K2 (flex_fwd_sbm_expected) and K6
// (flex_fwd_sbm_sampled), whose weights come from the factors R, K̂, in one
// template with the mod as its parameter; K7 (flex_fwd_sbm_graph), whose
// weights are a graph read from device memory, and K1 (flex_fwd_cse), whose
// score carries the disentangled relative bias, each in a kernel of its own
// built from the same parts (below, "the graph mod" and "the CSE mod").
//
// Replaces: csat_tpu/ops/flex_core.py:_fwd_call (pallas_call at :310, body
// _fwd_body :230) under the CSE mod (its own section below) and three mods
// of csat_tpu/ops/mods.py, with s = q·k /
// sqrt(dh), R = Q̂·S formed outside and hash dropout on P
// (flex_core.py:214-219):
//   * SBMExpectedSpec.tile_weight_parts (:248-252): weight clip(R·K̂ᵀ,
//     floor, .99) · real · (1 - key_pad);
//   * SBMSampledSpec.tile_weight_parts (:188-194): the Bernoulli graph
//     a = 1{u < clip(R·K̂ᵀ, floor, .99)} · real drawn in the kernel from the
//     counter hash (ops/hashrng.py:46-72) under the sample seed, weight
//     a · (1 - key_pad);
//   * SBMGraphSpec.tile_weight (:310-312): a materialised 0/1 graph (B, H,
//     N, N), weight graph · (1 - key_pad).
// All compute out = Σ_j w_ij e^{s_ij} keep_ij V_j / Σ_j w_ij e^{s_ij} (rows
// with no live weight exactly 0), lse before dropout, Σ w_raw per q-tile
// (graph_sum: padded keys too) and the dead (64-row, 64-column) tiles per
// q-tile — the outputs, sentinels and argument lists of the SIMT kernels
// they replaced.
//
// What bounds it on an H100: at B 64, N 150, dh 64 the call moves about
// 90 MB (q, k, v, out, the factors) and needs about 2 GFLOP of dot products
// and 0.3 GFLOP of R·K̂ᵀ: ~0.03 ms either way, so neither bound is near.
// What limited the SIMT kernels was their arithmetic: every product was a
// scalar FMA.  What limits this one is latency: a block is 4 warps at 255
// registers, two blocks an SM, each warp a long chain of dependent loads,
// 3xTF32 products and barriers.  Under the sampled mod the products take
// about two thirds of the time, and the graph's per-entry work (R·K̂ᵀ in
// order, one hash per real entry) most of the rest; capped at 168 or 128
// registers (three or four blocks an SM) it was at most a few per cent
// faster, with spills.
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
//     backward kernels sum it, so the weights are the same bits.  The
//     sampled mod draws hash_uniform(sample seed, bh0 + b·Ht + h, row, col,
//     stride) at the global (query, key) indices of each entry a thread owns
//     in the accumulator layout, with the hash row stride round_up(N, 128):
//     the graph is the same bits that the plain path and K3/K4 draw.  bh0 =
//     b0·Ht + h0 and the head stride Ht (the global head count), from the
//     launch, put a process holding rows [b0, b0 + B) of the global batch
//     and heads [h0, h0 + H) at their global batch·head index, so every
//     process draws its slice of the one global graph and dropout field
//     (bh0 0 and Ht = H on one process).
//   * The 3xTF32 split rounds both parts (cvt.rna), not the two-instruction
//     truncating split of flex_bwd_tc.cu's dh-deep products.  Each pair of
//     k-steps of Q·Kᵀ and each product of P·V also starts a fresh
//     accumulator that is added in f32: the tensor core's accumulation
//     rounds less finely than f32 adds, and a running sum of 24 products
//     per accumulator left the output 6e-6 from the plain path where this
//     leaves 2e-6.  Under the sampled mod the output is the next SBM
//     layer's input and so reaches that layer's graph; under the expected
//     mod it feeds K8/K9 through dvec = g·out, and dR there weighs dvec's
//     error by Σ_j e^{s − lse}, up to 1/floor times the attention's own
//     sum: with one accumulator (out 7.8e-7 from plain, relative L2, on the
//     expected_grad batch) dR missed the same-layer gate's 1e-5, with
//     fresh ones (1.9e-7) it holds (PERF.md §6).
//   * The expected mod's loop is specialised on dropout (its callers run it
//     at rate 0); the sampled mod keeps one copy that reads the rate, which
//     costs it fewer registers.
//   * Loads: K (with K̂ and the pad row) and V are copied with cp.async in
//     two groups, so V arrives while the weights, Q·Kᵀ and the softmax run;
//     Q is read once into registers.  Single-buffered: three k-tiles a block
//     at N 150 leave little to pipeline (43 KB at dh 64, 60 KB at dh 96).
//   * Skip count at FLEX_BLOCK = 64: a block is one 64-row q-tile (4 warps x
//     16 rows) and walks 64-column k-tiles; a k-tile with no live weight in
//     the whole block is skipped and counted, so the count equals
//     reference_block_skip at 64.  Warps whose rows all lie past N only load.
//     Under the sampled mod a warp also skips, in both products, each
//     8-column tile with no live weight in its 16 rows (keys past a
//     sample's length, or no sampled edge): its P is exactly 0, so the
//     result is the same bits.
//   * NEG = -1e30 is the running max of a row that has seen no live weight.
//     Dropout multiplies P where it enters P·V, never l.

#include <cuda_runtime.h>
#include <algorithm>
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

enum { MOD_SBM_EXPECTED = 0, MOD_SBM_SAMPLED = 1 };

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
  uint32_t bh0;           // batch·head offset of the hash streams (data parallelism)
  uint32_t hstride;       // the global head count (tensor parallelism: ≥ H)
  float floor_, scale, rate, keep_scale;
  const int32_t* sseed;   // (1,) Bernoulli stream seed (sampled mod only)
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

// n of 4 bytes copied, the rest of the word zero-filled
__device__ __forceinline__ void cp4n(void* dst, const void* src, int n) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" :: "r"(s), "l"(src), "r"(n));
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
// DROPOUT: 0 off, 1 on, 2 as p.rate says
template <int MOD, int DH, int DROPOUT>
__device__ __forceinline__ void flex_tc_body(Params p) {
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
  // the global batch·head index of the hash streams
  const uint32_t gbh = p.bh0 + (uint32_t)b * p.hstride + (uint32_t)h;
  const float* qg = p.q + bh * N * DH;
  const float* kg = p.k + bh * N * DH;
  const float* vg = p.v + bh * N * DH;
  const int row0 = qt * BM, wrow = warp * 16;
  const int gr_[2] = {row0 + wrow + g, row0 + wrow + g + 8};
  const bool active = row0 + wrow < N;   // the warp has a real row
  const bool dropout = DROPOUT == 1 || (DROPOUT == 2 && p.rate > 0.f);
  const uint32_t dseed = dropout ? (uint32_t)p.dseed[0] : 0u;
  const uint32_t sseed = MOD == MOD_SBM_SAMPLED ? (uint32_t)p.sseed[0] : 0u;

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
        float wr;
        if constexpr (MOD == MOD_SBM_EXPECTED)
          wr = real ? pr : 0.f;
        else  // the Bernoulli draw at the entry's global (query, key) indices
          wr = real && hash_uniform(sseed, gbh, gr_[i >> 1], col0 + c, p.stride) < pr
                   ? 1.f : 0.f;
        const float we = wr * (1.f - pads[c]);
        gsum += wr;
        w[t][i] = we;
        live_local |= (we > 0.f);
      }
    // the sampled mod's n8 tiles with a live weight in the warp's 16 rows
    // (warp-uniform): the products skip the others, whose P is 0
    unsigned tiles = (1u << ntk) - 1u;
    if constexpr (MOD == MOD_SBM_SAMPLED) {
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (!__any_sync(0xffffffffu, w[t][0] > 0.f || w[t][1] > 0.f || w[t][2] > 0.f ||
                                          w[t][3] > 0.f))
          tiles &= ~(1u << t);
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
          if (MOD == MOD_SBM_EXPECTED ? t < ntk : (tiles >> t & 1u)) {
            const float4 b = *reinterpret_cast<const float4*>(Ks + (8 * t + g) * LDK + d0);
            // a fresh accumulator per pair of k-steps, added in f32
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma3(part, h0, l0, b.x, b.y);
            mma3(part, h1, l1, b.z, b.w);
#pragma unroll
            for (int i = 0; i < 4; ++i) sacc[t][i] += part[i];
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
              keep = hash_uniform(dseed, gbh, gr_[hr],
                                  col0 + 8 * t + 2 * tig + e, p.stride) >= p.rate ? p.keep_scale : 0.f;
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
        if (MOD == MOD_SBM_EXPECTED ? t < ntk : (tiles >> t & 1u)) {
          const float a[4] = {sacc[t][0], sacc[t][2], sacc[t][1], sacc[t][3]};
          uint32_t ah[4], al[4];
          split4(a, ah, al);
          const float* vp = Vs + (8 * t + 2 * tig) * LD + g;
#pragma unroll
          for (int dt = 0; dt < KS; ++dt) {  // a fresh accumulator per product
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma3(part, ah, al, vp[8 * dt], vp[LD + 8 * dt]);
#pragma unroll
            for (int i = 0; i < 4; ++i) o[dt][i] += part[i];
          }
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

// The expected mod's k-tile loop is specialised on dropout: its rate-0 copy
// (every call on the serving, eval and expected-gradient paths) carries no
// keep hash.  The sampled mod, which trains with dropout, keeps one copy
// that asks p.rate: a second copy would cost it registers.
template <int MOD, int DH>
__global__ void __launch_bounds__(THREADS) flex_tc_kernel(Params p) {
  if constexpr (MOD == MOD_SBM_EXPECTED) {
    if (p.rate > 0.f)
      flex_tc_body<MOD, DH, 1>(p);
    else
      flex_tc_body<MOD, DH, 0>(p);
  } else {
    flex_tc_body<MOD, DH, 2>(p);
  }
}

// One block per (64-row q-tile, head, batch) with `bytes` of dynamic shared
// memory, for the SBM kernels of this file.
template <typename P>
int launch_grid(void (*kern)(P), const P& p, size_t bytes, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // the largest shared-memory carveout, so that the shared memory never
  // caps the blocks an SM holds below what the registers allow
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.N + BM - 1) / BM, p.H, p.B);
  kern<<<grid, THREADS, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// The head widths of ops/build.py HEAD_DIMS: 64, and 96 for the java
// config's SBM encoder (768 / 8 heads).
template <int MOD>
int run(const float* q, const float* k, const float* v, const float* r, const float* kh,
        const float* pad, const int32_t* sseed, const int32_t* dseed, float* out, float* lse,
        float* gsum_part, int32_t* skip_part, int B, int H, int N, int DH, int KK, int stride,
        int bh0, int hstride, float floor_, float scale, float rate, float keep_scale, void* stream) {
  if (KK < 1 || KK > KKMAX) return -3;
  if (bh0 < 0 || hstride < H) return -7;
  if (rate > 0.f && dseed == nullptr) return -4;
  if (MOD == MOD_SBM_SAMPLED && sseed == nullptr) return -5;
  Params p{};
  p.q = q; p.k = k; p.v = v; p.r = r; p.kh = kh; p.pad = pad;
  p.sseed = sseed; p.dseed = dseed;
  p.out = out; p.lse = lse; p.gsum_part = gsum_part; p.skip_part = skip_part;
  p.B = B; p.H = H; p.N = N; p.kk = KK;
  p.stride = (uint32_t)stride; p.bh0 = (uint32_t)bh0; p.hstride = (uint32_t)hstride;
  p.floor_ = floor_; p.scale = scale;
  p.rate = rate; p.keep_scale = keep_scale;
  const cudaStream_t st = (cudaStream_t)stream;
  if (DH == 64) return launch_grid(flex_tc_kernel<MOD, 64>, p, smem_bytes(64), st);
  if (DH == 96) return launch_grid(flex_tc_kernel<MOD, 96>, p, smem_bytes(96), st);
  return -1;  // head width without an instantiation
}

// ---- the graph mod (K7) ---------------------------------------------------
//
// SBMGraphSpec.tile_weight: the weight is a materialised graph tile
// (noise_mode="shared": sampled outside through the STE) times (1 − pad).
// It follows the factor mods' tile loop — one 64-row q-tile a block of 4
// warps, 64-column k-tiles, 3xTF32 mma.sync products with the rounding split
// and a fresh accumulator per pair of k-steps of Q·Kᵀ and per product of
// P·V, the n8-tile and dead k-tile skips, the same outputs and sentinels —
// in a kernel of its own, so that the factor mods' code and register
// allocation stay as they were (a third mod in their template made K2 spill).
//
// What bounds it on an H100: at B 64, N 150, dh 64 the call moves 125 MB
// (46 MB of it the graph), 0.037 ms at 3.35 TB/s, and its products on the
// live entries need ~0.004 ms at a third of the TF32 rate; like K2 and K6 it
// is bound by latency, two blocks an SM (255 registers, 94.5 KB of shared
// memory).
// What its design does about that, beyond the factor mods' loop:
//   * no R·K̂ᵀ and no sample hash: the weights are the graph tile, copied
//     with cp.async beside K.  A graph row is N floats, so a row starts
//     16-byte aligned only where N·4 is a multiple of 16 (N 150: every other
//     row; N 75 and 37: one in four): the tile is copied in 4-byte pieces, a
//     thread on one column of every other row, and reads 0 outside the
//     N x N graph.  Its shared rows are GLD = 72 floats apart, so the float2
//     reads of the accumulator layout are conflict-free.
//   * K and V are split into their TF32 parts once a tile, by all threads
//     (split_tile), not once per warp at every product.
//   * the weights pass writes each entry's effective weight back into the
//     graph tile, where only the same thread's softmax reads it: the weights
//     are not held in registers across Q·Kᵀ and are not recomputed.
//   * the dropout keep bits of a thread's 32 entries (a 32-bit mask) are
//     drawn while the tile's copies are in flight, and compared as integers:
//     u ≥ rate ⟺ top ≥ ceil(rate · 2^24), u = top · 2^-24 exactly.  The loop
//     is specialised on dropout (the eval encoder runs at rate 0).
//   * the row max is taken over the unscaled scores and scaled once (scale >
//     0 keeps the order), and e^(s·scale − m) is ex2.approx of one FMA in
//     base 2.  Its error against the plain path stays ~2e-6 max abs (f32
//     expf: the same), the budget being 5e-6.
//   * graph_sum of a 0/1 graph is an integer count, exact in f32.

constexpr int GLD = BN + 8;  // graph tile row stride: ≡ 8 (mod 32)

struct GraphParams {
  const float* q;
  const float* k;
  const float* v;
  const float* graph;     // (B, H, N, N), 0/1
  const float* pad;       // (B, N), 1.0 = padded key
  const int32_t* dseed;   // (1,) dropout stream seed, read when rate > 0
  float* out;             // (B, H, N, dh)
  float* lse;             // (B, H, N)
  float* gsum_part;       // (B, H, n_qtiles)
  int32_t* skip_part;     // (B, H, n_qtiles)
  int B, H, N;
  uint32_t stride;        // hash row stride, round_up(N, 128)
  uint32_t bh0;           // batch·head offset of the dropout stream (data parallelism)
  uint32_t hstride;       // the global head count (tensor parallelism: ≥ H)
  uint32_t keep_from;     // keep an entry iff its 24 hash bits ≥ ceil(rate · 2^24)
  float scale, keep_scale;
};

constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
size_t graph_smem_bytes() {
  // K and V tiles, each as TF32 high and low parts, the graph tile, the pad row
  return ((size_t)2 * BN * ((DH + 16) + (DH + 4)) + (size_t)BM * GLD + BN) * sizeof(float);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d += a·b in 3xTF32 with b split already: as mma3, the small terms first
__device__ __forceinline__ void mma3s(float (&d)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                      uint32_t bl0, uint32_t bl1) {
  const uint32_t bh[2] = {bh0, bh1}, bl[2] = {bl0, bl1};
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// a (64, DH) f32 tile of row stride LDT, in place: its TF32 high parts (as
// bits) stay, the low parts go to lo (same layout); every thread its own
// float4s
template <int DH, int LDT>
__device__ __forceinline__ void split_tile(float* t, float* lo) {
  constexpr int C4 = DH / 4;
  for (int i = threadIdx.x; i < BN * C4; i += THREADS) {
    const int off = (i / C4) * LDT + (i % C4) * 4;
    const float4 x = *reinterpret_cast<const float4*>(t + off);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(t + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

template <int DH, bool DROPOUT>
__device__ __forceinline__ void graph_body(const GraphParams& p) {
  constexpr int LD = DH + 4;     // V tile, as in flex_tc_body
  constexpr int LDK = DH + 16;   // K tile, as in flex_tc_body
  constexpr int KS = DH / 8;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[WARPS];
  float* Ks = smem;
  float* Vs = Ks + BN * LDK;
  float* Gs = Vs + BN * LD;        // (BM, GLD)
  float* pads = Gs + BM * GLD;     // (BN)
  float* Kl = pads + BN;           // the low TF32 parts of K and V (split_tile)
  float* Vl = Kl + BN * LDK;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int N = p.N;
  const size_t bh = (size_t)b * p.H + h;
  // the global batch·head index of the hash streams
  const uint32_t gbh = p.bh0 + (uint32_t)b * p.hstride + (uint32_t)h;
  const float* qg = p.q + bh * N * DH;
  const float* kg = p.k + bh * N * DH;
  const float* vg = p.v + bh * N * DH;
  const float* gg = p.graph + bh * N * N;
  const int row0 = qt * BM, wrow = warp * 16;
  const int gr_[2] = {row0 + wrow + g, row0 + wrow + g + 8};
  const bool active = row0 + wrow < N;   // the warp has a real row
  const uint32_t dseed = DROPOUT ? (uint32_t)p.dseed[0] : 0u;
  const float c1 = p.scale * LOG2E;

  float qf[KS][4];
#pragma unroll
  for (int pp = 0; pp < KS / 2; ++pp) {
    const int d0 = 16 * pp + 4 * tig;
    pair_frags(row4(qg + (size_t)gr_[0] * DH + d0, gr_[0] < N),
               row4(qg + (size_t)gr_[1] * DH + d0, gr_[1] < N), qf[2 * pp], qf[2 * pp + 1]);
  }

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[KS][4] = {};
  float gsum = 0.f;
  int skips = 0;
  const int nkt = (N + BN - 1) / BN;

  for (int kt = 0; kt < nkt; ++kt) {
    const int col0 = kt * BN;
    const int ntk = min(8, (N - col0 + 7) >> 3);

    // ---- K, the graph tile and pads, then V in a second group ----
    load_rows<DH, LDK>(Ks, kg, col0, N);
    {  // a thread copies one column, every other row
      static_assert(THREADS % BN == 0, "a thread keeps its graph column");
      constexpr int RSTEP = THREADS / BN;
      const int c = tid % BN, r0 = tid / BN;
      const bool cin = col0 + c < N;
      const float* src = gg + (size_t)(row0 + r0) * N + col0 + c;
      float* dst = Gs + r0 * GLD + c;
#pragma unroll 8
      for (int r = r0; r < BM; r += RSTEP) {
        const bool in = cin && row0 + r < N;
        cp4(dst, in ? src : gg, in);
        src += RSTEP * N;
        dst += RSTEP * GLD;
      }
    }
    for (int c = tid; c < BN; c += THREADS) {
      const int gc = col0 + c;
      cp4(pads + c, p.pad + (size_t)b * N + (gc < N ? gc : 0), gc < N);
    }
    cp_commit();
    load_rows<DH, LD>(Vs, vg, col0, N);
    cp_commit();

    // ---- the keep bits while the copies land: bit 4·t + i ↔ entry i of
    // n8 tile t (row gr_[i >> 1], column col0 + 8·t + 2·tig + (i & 1)) ----
    uint32_t keep = 0u;
    if (DROPOUT && active) {
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t bits = hash_bits(dseed, gbh, (uint32_t)gr_[i >> 1],
                                          (uint32_t)(col0 + 8 * t + 2 * tig + (i & 1)), p.stride);
          keep |= (uint32_t)((bits >> 8) >= p.keep_from) << (4 * t + i);
        }
    }
    cp_wait<1>();
    __syncthreads();
    split_tile<DH, LDK>(Ks, Kl);  // the next barrier publishes it

    // ---- weights and liveness ----
    int live_local = 0;
    unsigned tiles = (1u << ntk) - 1u;
    {
      // a thread reads its 32 entries and writes their effective weights
      // back in place, for its own softmax (no other thread reads them)
      float* g0 = Gs + (wrow + g) * GLD + 2 * tig;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        float2* e0 = reinterpret_cast<float2*>(g0 + 8 * t);
        float2* e1 = reinterpret_cast<float2*>(g0 + 8 * GLD + 8 * t);
        const float2 a0 = *e0, a1 = *e1;
        const float2 pv = *reinterpret_cast<const float2*>(pads + 8 * t + 2 * tig);
        gsum += a0.x + a0.y + a1.x + a1.y;  // the copy read 0 outside the N x N graph
        const float2 w0 = make_float2(a0.x * (1.f - pv.x), a0.y * (1.f - pv.y));
        const float2 w1 = make_float2(a1.x * (1.f - pv.x), a1.y * (1.f - pv.y));
        *e0 = w0;
        *e1 = w1;
        const bool live = w0.x > 0.f || w0.y > 0.f || w1.x > 0.f || w1.y > 0.f;
        live_local |= live;
        // n8 tiles without a live weight in the warp's 16 rows (warp-uniform)
        if (!__any_sync(0xffffffffu, live)) tiles &= ~(1u << t);
      }
    }
    if (!__syncthreads_or(live_local)) {
      ++skips;  // block-uniform: every thread counts the same skips
      cp_wait<0>();  // V lands before the next tile
      continue;
    }

    float sacc[8][4] = {};
    if (active) {
      // ---- S = Q·Kᵀ, a fresh accumulator per pair of k-steps ----
#pragma unroll
      for (int pp = 0; pp < KS / 2; ++pp) {
        const int d0 = 16 * pp + 4 * tig;
        uint32_t h0[4], l0[4], h1[4], l1[4];
        split4(qf[2 * pp], h0, l0);
        split4(qf[2 * pp + 1], h1, l1);
#pragma unroll
        for (int t = 0; t < 8; ++t)
          if (tiles >> t & 1u) {
            const uint4 bh = *reinterpret_cast<const uint4*>(Ks + (8 * t + g) * LDK + d0);
            const uint4 bl = *reinterpret_cast<const uint4*>(Kl + (8 * t + g) * LDK + d0);
            // the first pair accumulates onto sacc's zeros: the same bits
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            float (&acc)[4] = pp == 0 ? sacc[t] : part;
            mma3s(acc, h0, l0, bh.x, bh.y, bl.x, bl.y);
            mma3s(acc, h1, l1, bh.z, bh.w, bl.z, bl.w);
            if (pp > 0) {
#pragma unroll
              for (int i = 0; i < 4; ++i) sacc[t][i] += part[i];
            }
          }
      }

      // ---- online max / sum over the 4 lanes that share each row ----
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float we[8][2];  // the row's effective weights, as the weights pass left them
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float2 wv = *reinterpret_cast<const float2*>(
              Gs + (wrow + g + 8 * hr) * GLD + 8 * t + 2 * tig);
          we[t][0] = wv.x;
          we[t][1] = wv.y;
        }
        // the max of the unscaled scores, scaled once (scale > 0 keeps the
        // order); e^(s·scale − m) = 2^(s·scale·log2 e − m·log2 e)
        float mt = NEG;
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (we[t][e] > 0.f) mt = fmaxf(mt, sacc[t][2 * hr + e]);
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m[hr], mt * p.scale);
        // (m − m_new) first: m == m_new must give exactly 1, also at the
        // −1e30 sentinels, where an FMA of the two products would not
        const float alpha = ex2((m[hr] - m_new) * LOG2E);
        const float m2 = m_new * LOG2E;
        float lt = 0.f;
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * hr + e;
            const float pr = we[t][e] > 0.f ? ex2(fmaf(sacc[t][i], c1, -m2)) * we[t][e] : 0.f;
            // P, dropped out; the row sum takes pr
            sacc[t][i] = DROPOUT ? (keep >> (4 * t + i) & 1u ? pr * p.keep_scale : 0.f) : pr;
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
    split_tile<DH, LD>(Vs, Vl);
    __syncthreads();

    if (active) {
      // ---- O += P·V, P straight from the S accumulators (permuted k, as in
      // flex_tc_body), a fresh accumulator per product ----
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (tiles >> t & 1u) {
          const float a[4] = {sacc[t][0], sacc[t][2], sacc[t][1], sacc[t][3]};
          uint32_t ah[4], al[4];
          split4(a, ah, al);
          const uint32_t* vh = reinterpret_cast<const uint32_t*>(Vs) + (8 * t + 2 * tig) * LD + g;
          const uint32_t* vl = reinterpret_cast<const uint32_t*>(Vl) + (8 * t + 2 * tig) * LD + g;
#pragma unroll
          for (int dt = 0; dt < KS; ++dt) {
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma3s(part, ah, al, vh[8 * dt], vh[LD + 8 * dt], vl[8 * dt], vl[LD + 8 * dt]);
#pragma unroll
            for (int i = 0; i < 4; ++i) o[dt][i] += part[i];
          }
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
__global__ void __launch_bounds__(THREADS) flex_graph_kernel(GraphParams p) {
  if (p.keep_from > 0u)
    graph_body<DH, true>(p);
  else
    graph_body<DH, false>(p);
}


// ---- the CSE mod (K1) -----------------------------------------------------
//
// Replaces csat_tpu/ops/flex_core.py:_fwd_call (pallas_call at :310) under
// CSESpec.tile_score of csat_tpu/ops/mods.py (:430-439): the disentangled
// L/T relative bias s_ij = (q_i·k_j + q_i·lk[rel_ij] + k_j·lq[rel_ji]) /
// sqrt(3 dk) on an unmasked entry, the fill -1e9 in place of the score on a
// masked one (a row whose every column is masked is then uniform over its
// real columns), weight = the real-extent gate.  Heads h < group read plane 0
// of rel/mask (L), the others plane 1 (T); a tensor-parallel member whose
// heads all lie in one plane passes that plane alone with group = H.
//
// What bounds it on an H100: at B 64, N 150 the call moves 93 MB (q, k, v,
// out, rel, mask): 0.028 ms.  Its products need q·k and P·V on every real
// entry and two dh-long dot products on each unmasked one; a real batch
// leaves 11 % of the L plane and 0.3 % of the T plane unmasked, so the bias
// is ~0.09 GMAC against ~2.4 GMAC for q·k and P·V.  Like K2, K6 and K7 it is
// bound by latency, not by either roof: the scan of the mask and the
// gathers of the bias are chains of dependent loads.
// What its design does about that:
//   * q·k and P·V as in the factor mods' template: 3xTF32 mma.sync with the
//     rounding split, a fresh accumulator per pair of k-steps of Q·Kᵀ and per
//     product of P·V, P from the accumulators, one 16-row slab a warp.
//   * the bias first, for the block's rows over every column, only where
//     the mask is clear and with no table in shared memory.  The block's
//     mask rows arrive by cp.async together with the first K and V tiles.
//     Each warp scans its rows 8 chunks of 32 entries at a time: a ballot
//     over the staged mask bytes gives a chunk's unmasked bits (kept for the
//     scores), rel[i][j] (coalesced) and rel[j][i] (one sector) are read for
//     the unmasked entries only, and a prefix count lists them; the next 8
//     chunks' reads fly while this list is worked.  Eight lanes take an
//     entry, each two 16-byte pieces of q_i, k_j, lk[rel_ij] and lq[rel_ji]
//     (rows from L1/L2: one head's tables are 77 KB, all eight 614 KB), a
//     group 4 entries in flight, plain f32; (c2p + p2c)·scale goes to a
//     (rows, N) bias tile.  A masked entry costs no load and no arithmetic.
//   * then the k-tile loop of the template, whose score is q·k·scale + bias
//     where the chunk's bit says unmasked and the fill -1e9 elsewhere.
//   * the grid fills the card at serving batch sizes: a block always has 4
//     warps, which all scan and form the bias, but holds 16·S q rows, S = 1,
//     2 or 4 slabs, the fewest for which one wave of two blocks an SM (254
//     registers) holds the grid; warps past S only work on the bias.  B 4,
//     N 150 runs 160 blocks of 2 slabs where 64-row blocks gave 96.  Heads
//     are the grid's outer index, so the blocks that run together read one
//     head's tables, and the shared-memory carveout is what two blocks need,
//     the rest of the SM's 256 KB staying L1.
//   * the softmax subtracts before it exponentiates (2^((s − m)·log2 e),
//     2^((m − m')·log2 e)) so that rows at the -1e9 fill, whose scores and
//     max are equal, give exactly 1.
//   * graph_sum and the skip count follow from the real gate: a 64-row
//     q-tile's weight is its real rows × N, and every 64 × 64 tile of the
//     grid holds a real entry, so none is dead (reference_block_skip is 0);
//     the block that starts a 64-row q-tile writes both.

constexpr float NEG_CSE = -1e9f;
constexpr int CSE_CH = 8;               // chunks of 32 entries a warp lists at a time
constexpr int LIST = 32 * CSE_CH;       // the entries they may hold

struct CseParams {
  const float* q;
  const float* k;
  const float* v;
  const float* lq;        // (H, R, dh)
  const float* lk;
  const int32_t* rel;     // (B, 2, N, N)
  const uint8_t* mask;    // (B, 2, N, N), nonzero = masked
  float* out;             // (B, H, N, dh)
  float* lse;             // (B, H, N)
  float* gsum_part;       // (B, H, n_qtiles), 64-row q-tiles
  int32_t* skip_part;     // (B, H, n_qtiles)
  int B, H, N, R, group;
  float scale;
};

// shared-memory layout of a block of S slabs (16·S q rows), in floats: the
// K and V tiles, the bias of the block's rows over every column (row stride
// bld ≡ 8 mod 32, so the accumulator layout's float2 reads are
// conflict-free), the bits of their unmasked real entries (a word per 32
// columns), each warp's list of entries (two words each) and the block's
// mask rows (mw words a row: the aligned words that cover its N bytes)
template <int S>
struct CseTiles {
  static constexpr int ROWS = 16 * S;
  int bld, nh, mw;
  __host__ __device__ explicit CseTiles(int n)
      : bld(((n + 7) / 8 * 8 + 23) / 32 * 32 + 8), nh((n + 31) / 32), mw((n + 3) / 4 + 1) {}
  __host__ __device__ int ks() const { return 0; }
  __host__ __device__ int vs() const { return BN * (64 + 16); }
  __host__ __device__ int bias() const { return vs() + BN * (64 + 4); }
  __host__ __device__ int ubits() const { return bias() + ROWS * bld; }
  __host__ __device__ int lists() const { return ubits() + ROWS * nh + (ROWS * nh) % 2; }
  __host__ __device__ int mask() const { return lists() + WARPS * LIST * 2; }
  __host__ __device__ size_t bytes() const {
    return (size_t)(mask() + ROWS * mw) * sizeof(float);
  }
};

// q_i·lk[rel_ij] + k_j·lq[rel_ji] for a warp's list of `n` entries (row i in
// the block, column j, rel_ij, rel_ji), eight lanes an entry, U entries a
// group in flight; each lane holds two 16-byte pieces of the four rows (q_i
// and k_j from L1, the table rows from L1/L2).  (c2p + p2c)·scale goes to
// bias[i][j].
template <int DH, int U>
__device__ __forceinline__ void cse_bias_list(const uint2* list, int n, const float* qg,
                                              const float* kg, const float* lkh,
                                              const float* lqh, float* bias, int bld,
                                              float scale, int lane) {
  const int grp = lane >> 3, d0 = 4 * (lane & 7);
  for (int base = 0; base < n; base += 4 * U) {
    float acc[U];
    int at[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + 4 * u + grp;
      const uint2 e = list[idx < n ? idx : n - 1];
      const int i = e.x & 0xffff, j = e.x >> 16, rij = e.y & 0xffff, rji = e.y >> 16;
      at[u] = idx < n ? i * bld + j : -1;
      const float* qr = qg + (size_t)i * DH + d0;
      const float* kr = kg + (size_t)j * DH + d0;
      const float* lkr = lkh + (size_t)rij * DH + d0;
      const float* lqr = lqh + (size_t)rji * DH + d0;
      float a = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(qr + 32 * half));
        const float4 y = __ldg(reinterpret_cast<const float4*>(lkr + 32 * half));
        const float4 z = __ldg(reinterpret_cast<const float4*>(kr + 32 * half));
        const float4 w = __ldg(reinterpret_cast<const float4*>(lqr + 32 * half));
        a = fmaf(x.x, y.x, a); a = fmaf(x.y, y.y, a);
        a = fmaf(x.z, y.z, a); a = fmaf(x.w, y.w, a);
        a = fmaf(z.x, w.x, a); a = fmaf(z.y, w.y, a);
        a = fmaf(z.z, w.z, a); a = fmaf(z.w, w.w, a);
      }
      acc[u] = a;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], 4);
      acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], 2);
      acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], 1);
      if ((lane & 7) == 0 && at[u] >= 0) bias[at[u]] = acc[u] * scale;
    }
  }
}

// One batch of CH chunks of a warp for the CSE bias, from its chunk q on.
// The warp owns rows warp, warp + WARPS, ... of the block; its chunk q is
// row warp + WARPS·(q / nh), columns 32·(q % nh) + lane.  un[c]: the lane's
// entry is real and unmasked (the mask from the staged rows, whose first
// word starts `skew` bytes before the row); rc[c] = row | column << 16;
// rel[i][j] (coalesced) and rel[j][i] (one sector) are read for unmasked
// entries only.
template <int CH>
__device__ __forceinline__ void cse_scan(int q, int nq, int nh, int N, int row0, int skew0,
                                         const uint8_t* Mrows, int mw, const int32_t* relg,
                                         int warp, int lane, bool (&un)[CH], uint32_t (&rc)[CH],
                                         int (&rv)[CH], int (&rt)[CH]) {
  int r = warp + WARPS * (q / nh), hh = q % nh;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = hh * 32 + lane;
    const int skew = (skew0 + (row0 + r) * N) & 3;
    un[c] = q + c < nq && col < N && Mrows[r * 4 * mw + skew + col] == 0;
    rc[c] = (uint32_t)r | (uint32_t)col << 16;
    if (++hh == nh) {
      hh = 0;
      r += WARPS;
    }
  }
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int i = row0 + (int)(rc[c] & 0xffffu), j = (int)(rc[c] >> 16);
    rv[c] = un[c] ? __ldg(relg + (size_t)i * N + j) : 0;
    rt[c] = un[c] ? __ldg(relg + (size_t)j * N + i) : 0;
  }
}

template <int DH, int S>
__global__ void __launch_bounds__(THREADS) flex_cse_kernel(CseParams p) {
  static_assert(DH == 64, "a bias lane holds two 16-byte pieces of a 64-wide row");
  constexpr int ROWS = 16 * S, LDK = DH + 16, LD = DH + 4, KS = DH / 8;
  extern __shared__ __align__(16) float smem[];
  const int N = p.N;
  const CseTiles<S> T(N);
  const int bld = T.bld, nh = T.nh;
  float* Ks = smem + T.ks();
  float* Vs = smem + T.vs();
  float* Bs = smem + T.bias();
  uint32_t* ubits = reinterpret_cast<uint32_t*>(smem + T.ubits());

  // heads outermost: the blocks that run together share a head's tables
  const int qb = blockIdx.x, b = blockIdx.y, h = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const size_t bh = (size_t)b * p.H + h;
  const float* qg = p.q + bh * N * DH;
  const float* kg = p.k + bh * N * DH;
  const float* vg = p.v + bh * N * DH;
  // H / group planes a batch row: 2 (L, T), or 1 for a head shard in one plane
  const size_t plane_off = ((size_t)b * (p.H / p.group) + h / p.group) * N * N;
  const int32_t* relg = p.rel + plane_off;
  const uint8_t* maskg = p.mask + plane_off;
  const int row0 = qb * ROWS, wrow = warp * 16;
  const int nr = min(ROWS, N - row0);  // the block's real rows
  const int gr_[2] = {row0 + wrow + g, row0 + wrow + g + 8};
  const bool active = warp < S && wrow < nr;  // a slab warp with a real row

  // the block's mask rows, then the first k-tile's K and V, which fly while
  // the bias is formed.  A mask row of N bytes starts 4-byte aligned only
  // where N·4 divides its offset, so the copy takes the aligned words that
  // cover it (reading nothing past the tensor's end) and the scan skips the
  // row's first (base & 3) bytes
  uint8_t* Mrows = reinterpret_cast<uint8_t*>(smem + T.mask());
  {
    const uintptr_t end = (uintptr_t)(p.mask + (size_t)p.B * 2 * N * N);
    for (int i = tid; i < nr * T.mw; i += THREADS) {
      const int r = i / T.mw, w = i % T.mw;
      const uintptr_t a = ((uintptr_t)(maskg + (size_t)(row0 + r) * N) & ~(uintptr_t)3) + 4 * w;
      const int n_in = a < end ? (int)min((uintptr_t)4, end - a) : 0;
      cp4n(Mrows + 4 * i, reinterpret_cast<const void*>(n_in ? a : (uintptr_t)p.mask), n_in);
    }
  }
  cp_commit();
  load_rows<DH, LDK>(Ks, kg, 0, N);
  cp_commit();
  load_rows<DH, LD>(Vs, vg, 0, N);
  cp_commit();
  cp_wait<2>();
  __syncthreads();  // the mask rows

  // ---- the bias of the block's rows where the mask is clear, 8 chunks of
  // a warp at a time (cse_scan); the chunks' unmasked bits go to ubits ----
  {
    uint2* list = reinterpret_cast<uint2*>(smem + T.lists()) + warp * LIST;
    const float* lkh = p.lk + (size_t)h * p.R * DH;
    const float* lqh = p.lq + (size_t)h * p.R * DH;
    const float* qrows = qg + (size_t)row0 * DH;
    // this warp's chunks: nh for each of its rows
    const int nq = (nr > warp ? (nr - warp + WARPS - 1) / WARPS : 0) * nh;
    const int skew0 = (int)((uintptr_t)maskg & 3);
    bool un[CSE_CH];
    uint32_t rc[CSE_CH];
    int rv[CSE_CH], rt[CSE_CH];
    if (nq > 0)
      cse_scan(0, nq, nh, N, row0, skew0, Mrows, T.mw, relg, warp, lane, un, rc, rv, rt);
    for (int q = 0; q < nq; q += CSE_CH) {
      int n = 0;
#pragma unroll
      for (int c = 0; c < CSE_CH; ++c) {
        const unsigned bits = __ballot_sync(0xffffffffu, un[c]);
        if (lane == 0 && q + c < nq) ubits[(rc[c] & 0xffffu) * nh + (rc[c] >> 21)] = bits;
        if (un[c])
          list[n + __popc(bits & ((1u << lane) - 1u))] =
              make_uint2(rc[c], (uint32_t)rv[c] | (uint32_t)rt[c] << 16);
        n += __popc(bits);
      }
      __syncwarp();
      // the next chunks' rel reads fly while these entries' bias is formed
      if (q + CSE_CH < nq)
        cse_scan(q + CSE_CH, nq, nh, N, row0, skew0, Mrows, T.mw, relg, warp, lane, un, rc, rv,
                 rt);
      cse_bias_list<DH, 4>(list, n, qrows, kg, lkh, lqh, Bs, bld, p.scale, lane);
      __syncwarp();
    }
  }

  float qf[KS][4] = {};
  if (active) {
#pragma unroll
    for (int pp = 0; pp < KS / 2; ++pp) {
      const int d = 16 * pp + 4 * tig;
      pair_frags(row4(qg + (size_t)gr_[0] * DH + d, gr_[0] < N),
                 row4(qg + (size_t)gr_[1] * DH + d, gr_[1] < N), qf[2 * pp], qf[2 * pp + 1]);
    }
  }

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[KS][4] = {};
  const int nkt = (N + BN - 1) / BN;

  for (int kt = 0; kt < nkt; ++kt) {
    const int col0 = kt * BN;
    const int nc = min(BN, N - col0);  // the tile's real keys
    const int ntk = (nc + 7) >> 3;     // n8 column tiles holding them
    if (kt > 0) {
      load_rows<DH, LDK>(Ks, kg, col0, N);
      cp_commit();
      load_rows<DH, LD>(Vs, vg, col0, N);
      cp_commit();
    }
    cp_wait<1>();
    __syncthreads();  // K (and, at the first tile, every bias and bit)

    float sacc[8][4] = {};
    if (active) {
      // ---- S = Q·Kᵀ, a fresh accumulator per pair of k-steps ----
#pragma unroll
      for (int pp = 0; pp < KS / 2; ++pp) {
        const int d = 16 * pp + 4 * tig;
        uint32_t h0[4], l0[4], h1[4], l1[4];
        split4(qf[2 * pp], h0, l0);
        split4(qf[2 * pp + 1], h1, l1);
#pragma unroll
        for (int t = 0; t < 8; ++t)
          if (t < ntk) {
            const float4 bk = *reinterpret_cast<const float4*>(Ks + (8 * t + g) * LDK + d);
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma3(part, h0, l0, bk.x, bk.y);
            mma3(part, h1, l1, bk.z, bk.w);
#pragma unroll
            for (int i = 0; i < 4; ++i) sacc[t][i] += part[i];
          }
      }

      // ---- scores: q·k·scale + bias where unmasked, the fill where masked;
      // weight 1 on real entries; online max / sum over the row's quad ----
      bool real[8][4];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = wrow + g + 8 * hr;
        const uint32_t* ub = ubits + r * nh + (col0 >> 5);
        const uint64_t bits = gr_[hr] < N ? (uint64_t)ub[0] | (nc > 32 ? (uint64_t)ub[1] << 32 : 0)
                                          : 0;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float2 bias = *reinterpret_cast<const float2*>(Bs + r * bld + col0 + 8 * t + 2 * tig);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * hr + e, c = 8 * t + 2 * tig + e;
            real[t][i] = gr_[hr] < N && c < nc;
            sacc[t][i] = (bits >> c & 1u) ? fmaf(sacc[t][i], p.scale, e ? bias.y : bias.x)
                                          : NEG_CSE;
          }
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mt = NEG;
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (real[t][2 * hr + e]) mt = fmaxf(mt, sacc[t][2 * hr + e]);
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m[hr], mt);
        // differences first: at the fill, s == m_new gives exactly 1
        const float alpha = ex2((m[hr] - m_new) * LOG2E);
        float lt = 0.f;
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * hr + e;
            const float pr = real[t][i] ? ex2((sacc[t][i] - m_new) * LOG2E) : 0.f;
            sacc[t][i] = pr;
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
      // ---- O += P·V (permuted k, as in flex_tc_body), a fresh accumulator
      // per product ----
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (t < ntk) {
          const float a[4] = {sacc[t][0], sacc[t][2], sacc[t][1], sacc[t][3]};
          uint32_t ah[4], al[4];
          split4(a, ah, al);
          const float* vp = Vs + (8 * t + 2 * tig) * LD + g;
#pragma unroll
          for (int dt = 0; dt < KS; ++dt) {
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma3(part, ah, al, vp[8 * dt], vp[LD + 8 * dt]);
#pragma unroll
            for (int i = 0; i < 4; ++i) o[dt][i] += part[i];
          }
        }
    }
    __syncthreads();  // the tiles are free for the next k-tile
  }

  // ---- epilogue ----
  if (active) {
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
  }
  if (tid == 0 && row0 % BM == 0) {
    const size_t slot = bh * ((N + BM - 1) / BM) + row0 / BM;
    p.gsum_part[slot] = (float)(min(BM, N - row0) * N);
    p.skip_part[slot] = 0;
  }
}

// S = 1, 2 or 4 slabs a block: the fewest whose grid one wave of two blocks
// an SM (252 registers) holds, else 4 (the fewest K/V tile copies)
int cse_slabs(int B, int H, int N, int sms) {
  for (int s = 1; s < 4; s *= 2)
    if ((long)((N + 16 * s - 1) / (16 * s)) * H * B <= 2L * sms) return s;
  return 4;
}

// grid (q blocks, B, H); shared memory carved out for the two blocks an SM
// holds and no more, so that the rest of the SM's 256 KB caches rows (L1)
template <int S>
int launch_cse(const CseParams& p, cudaStream_t stream) {
  auto kern = flex_cse_kernel<64, S>;
  const size_t bytes = CseTiles<S>(p.N).bytes();
  if (bytes > 232448) return -2;  // over the 227 KB a block may use
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int pct = (int)std::min<size_t>(100, (2 * (bytes + 1024) * 100 + 233471) / 233472);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, pct);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.N + 16 * S - 1) / (16 * S), p.B, p.H);
  kern<<<grid, THREADS, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flex_fwd_sbm_expected(const float* q, const float* k, const float* v,
                                     const float* r, const float* kh, const float* pad,
                                     const int32_t* dseed, float* out, float* lse,
                                     float* gsum_part, int32_t* skip_part, int B, int H,
                                     int N, int DH, int KK, int stride, int bh0, int hstride,
                                     float floor_, float scale, float rate, float keep_scale,
                                     void* stream) {
  return run<MOD_SBM_EXPECTED>(q, k, v, r, kh, pad, nullptr, dseed, out, lse, gsum_part,
                               skip_part, B, H, N, DH, KK, stride, bh0, hstride, floor_, scale, rate,
                               keep_scale, stream);
}

extern "C" int flex_fwd_sbm_sampled(const float* q, const float* k, const float* v,
                                    const float* r, const float* kh, const float* pad,
                                    const int32_t* sseed, const int32_t* dseed,
                                    float* out, float* lse, float* gsum_part,
                                    int32_t* skip_part, int B, int H, int N, int DH,
                                    int KK, int stride, int bh0, int hstride, float floor_, float scale,
                                    float rate, float keep_scale, void* stream) {
  return run<MOD_SBM_SAMPLED>(q, k, v, r, kh, pad, sseed, dseed, out, lse, gsum_part,
                              skip_part, B, H, N, DH, KK, stride, bh0, hstride, floor_, scale, rate,
                              keep_scale, stream);
}

extern "C" int flex_fwd_sbm_graph(const float* q, const float* k, const float* v,
                                  const float* graph, const float* pad,
                                  const int32_t* dseed, float* out, float* lse,
                                  float* gsum_part, int32_t* skip_part, int B, int H,
                                  int N, int DH, int stride, int bh0, int hstride, float scale,
                                  float rate, float keep_scale, void* stream) {
  if (rate > 0.f && dseed == nullptr) return -4;
  if (bh0 < 0 || hstride < H) return -7;
  GraphParams p{};
  p.q = q; p.k = k; p.v = v; p.graph = graph; p.pad = pad; p.dseed = dseed;
  p.out = out; p.lse = lse; p.gsum_part = gsum_part; p.skip_part = skip_part;
  p.B = B; p.H = H; p.N = N; p.stride = (uint32_t)stride;
  p.bh0 = (uint32_t)bh0; p.hstride = (uint32_t)hstride;
  // u = top · 2^-24 exactly, so u ≥ rate ⟺ top ≥ ceil(rate · 2^24); 0 = no dropout
  p.keep_from = rate > 0.f ? (uint32_t)ceil((double)rate * 16777216.0) : 0u;
  p.scale = scale; p.keep_scale = keep_scale;
  const cudaStream_t st = (cudaStream_t)stream;
  if (DH == 64) return launch_grid(flex_graph_kernel<64>, p, graph_smem_bytes<64>(), st);
  if (DH == 96) return launch_grid(flex_graph_kernel<96>, p, graph_smem_bytes<96>(), st);
  return -1;  // head width without an instantiation
}

// The head width of ops/build.py HEAD_DIMS: 64 (CSE 512 / 8 heads).
extern "C" int flex_fwd_cse(const float* q, const float* k, const float* v,
                            const float* lq, const float* lk, const int32_t* rel,
                            const uint8_t* mask, float* out, float* lse,
                            float* gsum_part, int32_t* skip_part, int B, int H,
                            int N, int DH, int R, int group, float scale,
                            void* stream) {
  if (DH != 64) return -1;  // head width without an instantiation
  if (group < 1 || H % group) return -3;  // whole planes of heads
  // 16-byte copies and loads of q, k, v and the table rows; the mask rows
  // are copied in the aligned words that cover them
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)lq | (uintptr_t)lk) % 16 ||
      (uintptr_t)mask % 4)
    return -6;
  CseParams p{};
  p.q = q; p.k = k; p.v = v; p.lq = lq; p.lk = lk; p.rel = rel; p.mask = mask;
  p.out = out; p.lse = lse; p.gsum_part = gsum_part; p.skip_part = skip_part;
  p.B = B; p.H = H; p.N = N; p.R = R; p.group = group; p.scale = scale;
  const cudaStream_t st = (cudaStream_t)stream;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  switch (cse_slabs(B, H, N, sms)) {
    case 1: return launch_cse<1>(p, st);
    case 2: return launch_cse<2>(p, st);
    default: return launch_cse<4>(p, st);
  }
}
