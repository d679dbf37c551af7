// Two-pass backward of the SBM blocked attention on Hopper's tensor cores
// (sm_90a), one template with the mod as its parameter: under the sampled
// graph the kernels K3 (flex_bwd_q_sbm_sampled) and K4
// (flex_bwd_k_sbm_sampled), under the expected graph K8
// (flex_bwd_q_sbm_expected) and K9 (flex_bwd_k_sbm_expected).
//
// Replaces: csat_tpu/ops/flex_core.py:_kernel_bwd_calls — the q-pass
// (pallas_call at :498, body _bwd_q_body :389) and the k-pass (pallas_call at
// :519, body _bwd_k_body :434), which share the per-tile math _bwd_tile
// (:356-386) — under SBMSampledSpec.tile_dexp (the straight-through
// estimator, mods.py:196-198) and SBMExpectedSpec.tile_dexp (the clip's vjp,
// mods.py:254-261):
//   * q-pass: one block per (b, h, 64-row q-tile) walks the keys and
//     accumulates dq (B, H, N, dh) and dR (B, H, N, kk);
//   * k-pass: one block per (b, h, 64-key k-tile) walks the query rows and
//     accumulates dk, dv (B, H, N, dh) and dK̂ (B, H, N, kk).
// Per entry (i, j), with x = R_i·K̂_j, s = q_i·k_j / sqrt(dh), lse_i from the
// forward (−1e30 on a row with no live weight), dvec_i = g_i·out_i, gs the
// graph_sum cotangent of (b, h) and keep the dropout keep-field:
//   a_raw = 1{u < clip(x, floor, .99)} · real   (sampled)
//         = clip(x, floor, .99) · real          (expected)
//   a_eff = a_raw (1 − pad_j)
//   e     = exp(min(s − lse_i, 80))   (0 on a dead row)
//   d_s   = e a_eff ((g_i·v_j) keep − dvec_i)         → dq_i, dk_j (·/sqrt(dh))
//   d_a   = e ((g_i·v_j) keep − dvec_i)(1 − pad_j) + gs
//   d_exp = clamp(a_raw d_a, −1, 1)   (sampled)       → dR_i += d_exp K̂_j,
//         = d_a · c(x) · real         (expected)        dK̂_j += d_exp R_i
//   dv_j += e a_eff keep g_i
// with c(x) = 1 inside (floor, .99), 1/2 at x == floor or x == .99 (the even
// split jnp.clip's vjp gives a tie), 0 outside.  The graph is the forward's
// graph bit for bit: R·K̂ᵀ is summed j = 0, 1, … with one rounding per
// product and per sum (__fmul_rn/__fadd_rn), as the forward and
// ops/mods.py:exp_adjacency sum it, and the sample and dropout bits are drawn
// from the counter hash (hashrng.cuh) at the global (query row, key) indices
// under the forward's seeds and stride round_up(N, 128), and at the global
// batch·head index bh0 + b·Ht + h, Ht the head stride (the global head
// count; H on one process): bh0 = b0·Ht + h0 on a process holding rows
// [b0, b0 + B) of the global batch and heads [h0, h0 + H) of its Ht; 0 on
// one process.
//
// What bounds it on an H100: at the training shape (B 64, H 8, N 150, dh 64,
// kk 10) the q-pass moves about 108 MB and the k-pass 128 MB, 32 and 38 µs
// of HBM time; their dh-deep products (6·dh and 8·dh FLOP per live entry:
// 14 % of the entries on the train batch, about 57 % under the expected mod,
// where every real key is live) take 4-5 µs (17-22 µs expected) at the 3xTF32
// rate (495 / 3 TFLOP/s), and R·K̂ᵀ (2·kk per entry, f32) 3 µs.  Neither
// bound is near: what sets the time is latency — a few 4-warp blocks per SM,
// each warp a chain of shared-memory loads, 3xTF32 products and two
// barriers per chunk — and the per-entry work of the graph, which both
// passes evaluate (R·K̂ᵀ in the forward's order, the sample hash or the clip
// gates, the clamps), which stays when the dh-deep products are skipped.
// At 14 % edges almost every tile of the sampled mod is live already, so the
// expected mod's dense products cost it little more.
//
// Design:
//   * One template serves both passes and both mods.  A block owns 64 rows
//     of one side ("own": the q-tile, or the k-tile) in 4 warps of 16 and
//     streams the other side in chunks of 16 ("chunk": keys, or query rows).
//     A warp's 16 x 16 sub-tile is two n8 tiles, each laid out as an m16n8
//     accumulator: entry i of tile t is own row g + 8·(i >> 1), chunk index
//     8·t + 2·tig + (i & 1) (g = lane / 4, tig = lane % 4).  The warp holds
//     TB of them at once (Tiling): the sampled q-pass both, so that the own
//     rows' TF32 splits serve two tiles; the k-passes and the expected
//     q-pass one, so that one tile's weights, S, dP, d_s, d_exp and P are
//     live at a time and the precision below fits their register caps.
//     The k-pass is the q-pass transposed — Sᵀ = K·Qᵀ, dPᵀ = V·Gᵀ — so dSᵀ
//     and (P∘keep)ᵀ come out in the layout that dSᵀ·Q and Pᵀ·G take, and no
//     tile of entries passes through shared memory in either pass.
//   * Tensor cores, f32-faithful.  The five dh-deep products (S, dP and dQ;
//     Sᵀ, dPᵀ, dK and dV) and the cluster products (dR = dE·K̂, dK̂ = dEᵀ·R)
//     run on mma.sync.m16n8k8 TF32 in the 3xTF32 split, as K2 does in
//     flex_fwd_tc.cu: x = hi + lo, a·b ≈ lo·hi + hi·lo + hi·hi with f32
//     accumulation.  S, dP and the cluster products split by rounding (hi =
//     x rounded to the nearest TF32, lo = x − hi), and dP starts a fresh
//     accumulator at each k-step, added in f32; the accumulation products
//     dQ, dK and dV split by truncation (hi = x with its low 13 mantissa bits
//     cleared, one instruction less) into one accumulator.  A truncated
//     split errs always toward 0, and so does the tensor core's running sum,
//     so along a long sum their errors add instead of cancelling.  dR and
//     dK̂ take them from d_a, where g·v − dvec cancels: with every product
//     truncated, dR read 8.0–9.8e-6 in the counter same-graph gate against
//     its 1e-5 limit and the expected mod's gate failed; rounded S/dP and
//     the fresh dP accumulator read 2.9–3.2e-6 and pass it, for 7 %
//     (q-pass) and 9 % (k-pass) more time on the train batch (PERF.md §6).
//     The truncating dQ/dK/dV cost dR nothing.
//     One TF32 product keeps about 3 decimal digits, which the 1e-4
//     gradient tolerance would not survive.  The
//     entries feed the accumulation products straight from the accumulator
//     registers: the chunk index of those products is permuted (k = tig <->
//     2·tig, k = tig + 4 <-> 2·tig + 1), so the accumulator layout is the A
//     layout, and the chunk's rows are read in that order.
//   * Shared memory (row stride dh + 4 ≡ 4 mod 32 words): the own tiles
//     (Q, g_out | K, V) and own factor rows (R | K̂) stay for the whole
//     sweep; the chunk (K, V, K̂ᵀ, pad | Q, g_out, Rᵀ, lse, dvec) is copied
//     with cp.async in 16-byte vectors (4-byte for the factors and vectors);
//     the k-pass keeps two chunks in flight, so chunk c + 1 lands while
//     chunk c computes, and the q-pass one, for a fourth block per SM.  Both
//     the row reads of the S-shaped products (bank 4·g + tig) and the column
//     reads of the accumulation products (bank 8·tig + g) are conflict-free
//     at that stride; the transposed factor chunk (stride ≡ 24) serves the
//     R·K̂ᵀ sum and the cluster products' B operand as float2 reads.
//   * Work follows N: a warp whose 16 own rows lie wholly past N only loads;
//     n8 tiles wholly past N are skipped; TB tiles with no live weight
//     (a_eff = 0: keys past a sample's length, dead rows, no sampled edge)
//     skip S, dP and the dh-deep accumulation products, and still add their
//     d_exp of gs alone into dR / dK̂ — on padded keys a_raw can be live
//     while a_eff is 0; an entry without weight skips its exponential and
//     dropout hash.  Under the expected mod every real key has weight
//     (floor > 0), so the test that sends tiles to the cheap branch also
//     reads the query rows' lse: a row with no live weight has e = 0 on
//     every entry.  At floor 0 an entry of weight 0 whose clip gate is open
//     (x == 0, c = 1/2) on a real key keeps its exponential, since d_a
//     needs it.  Every value that is skipped is an exact 0 (or gs itself),
//     so the result does not depend on the tiling.
//   * No atomics: every output row belongs to one block, the sums run in a
//     fixed order, and two runs give the same bits.
//   * Occupancy.  Shared memory per block: 2·64·(dh + 4) + 64·17 + stages ·
//     (2·16·(dh + 4) + 16·24 + 2·16) floats — 49,536 B (q-pass) and 59,904 B
//     (k-pass) at dh 64, 70,016 B and 84,480 B at dh 96.  ptxas (CUDA 12.8,
//     sm_90a, -Xptxas -v) allocates at dh 64 128 registers to the sampled
//     q-pass (4 blocks per SM), 163 to the expected q-pass and 168 to the
//     k-passes (3 blocks), at dh 96 206 to 255 (2 blocks), with no spills.
//     Chunks of 8 or 32, more stages and other block counts were slower on
//     the train batch; with the precision above, every layout tried
//     spilled at the sampled q-pass's 128 registers or lost its fourth
//     block, except this one (PERF.md §6).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hashrng.cuh"

namespace {

constexpr int BT = 64;          // own rows of a block: 4 warps x 16
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int KKMAX = 16;
constexpr int RLD = KKMAX + 1;  // row stride of the own factor rows

constexpr float NEG = -1e30f;
constexpr float LIVE_LSE = -5e29f;  // lse above this: the row saw live weight

enum { MOD_SBM_SAMPLED = 0, MOD_SBM_EXPECTED = 1 };

// Each pass's streamed chunk (its rows), the chunks in flight, the blocks an
// SM is to hold at dh 64 (the register cap ptxas works to: 65,536 / (128 ·
// blocks); dh 96 holds two, its own tiles alone take 51 KB) and the n8 tiles
// a warp holds at once (TB).  Each choice is the fastest on the train batch
// or the expected_grad batch that ptxas fits without spills.
template <int MOD, bool KPASS>
struct Tiling {  // k-pass, both mods: dk and dv both accumulate, 168 registers
  static constexpr int CH = 16, STAGES = 2, MIN_BLOCKS = 3, TB = 1;
};
template <>
struct Tiling<MOD_SBM_SAMPLED, false> {  // q-pass: 128 registers, 49.5 KB of shared memory
  static constexpr int CH = 16, STAGES = 1, MIN_BLOCKS = 4, TB = 2;
};
template <>
struct Tiling<MOD_SBM_EXPECTED, false> {  // its clip gates spill at 128 registers
  static constexpr int CH = 16, STAGES = 1, MIN_BLOCKS = 3, TB = 1;
};

struct Params {
  const float* q;         // (B, H, N, dh)
  const float* k;
  const float* v;
  const float* r;         // (B, H, N, kk)  R = Q̂·S
  const float* kh;        // (B, H, N, kk)
  const float* pad;       // (B, N), 1.0 = padded key
  const int32_t* sseed;   // (1,) Bernoulli stream seed (sampled mod only)
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
  uint32_t bh0;           // batch·head offset of the hash streams (data parallelism)
  uint32_t hstride;       // the global head count (tensor parallelism: ≥ H)
  float floor_, scale, rate, keep_scale;
};

// ---- tensor-core helpers ------------------------------------------------------

// x = hi + lo.  Truncating (ROUND false), two instructions: hi is x with its
// low 13 mantissa bits cleared, lo = x − hi exactly; the tensor core reads lo
// as TF32, keeping its top 11 significant bits, so hi + lo holds x to 2^-20 of
// its size, always erring toward 0.  Rounding (ROUND true), one integer add
// more: hi = x rounded to the nearest TF32, ties away from 0 — the bits of
// cvt.rna.tf32.f32 for every finite x below 2^128 (the SASS of cvt.rna is
// several instructions longer) — and lo = x − hi, so hi + lo holds x to about
// 2^-22 of its size, with errors of either sign.
template <bool ROUND>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = ((ROUND ? __float_as_uint(x) + 0x1000u : __float_as_uint(x))) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool ROUND = false>
__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split<ROUND>(a[i], hi[i], lo[i]);
}

// d += a·b in 3xTF32: the small cross terms first, the large term last
template <bool ROUND = false>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh[2], bl[2];
  split<ROUND>(b0, bh[0], bl[0]);
  split<ROUND>(b1, bh[1], bl[1]);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// The expected mod's weight and clip gate at x = R·K̂ᵀ: a = clip(x, floor,
// .99); c = 1 inside (floor, .99), 1/2 at a bound (jnp.clip's vjp splits a
// tie evenly), 0 outside
__device__ __forceinline__ void clip_gate(float x, float floor_, float& a, float& c) {
  a = fminf(fmaxf(x, floor_), 0.99f);
  c = (x > floor_ && x < 0.99f) ? 1.f : ((x == floor_ || x == 0.99f) ? 0.5f : 0.f);
}

// ---- asynchronous copies -----------------------------------------------------

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

// rows [row0, row0 + ROWS) of a (N, DH) slab into a (ROWS, DH + 4) tile;
// rows past N read as 0
template <int DH, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int N) {
  constexpr int C4 = DH / 4;
  for (int i = threadIdx.x; i < ROWS * C4; i += THREADS) {
    const int r = i / C4, c = (i % C4) * 4, gr = row0 + r;
    const bool in = gr < N;
    cp16(dst + r * (DH + 4) + c, src + (size_t)(in ? gr : 0) * DH + c, in);
  }
}

// ---- one template for both passes ---------------------------------------------

// row stride of a transposed factor chunk (KKMAX, CH): ≡ 24 (mod 32)
__host__ __device__ constexpr int factor_ld(int ch) { return (ch + 8 + 31) / 32 * 32 - 8; }

template <int MOD, int DH, bool KPASS>
__host__ __device__ constexpr int stage_floats() {
  constexpr int CH = Tiling<MOD, KPASS>::CH;
  return 2 * CH * (DH + 4) + KKMAX * factor_ld(CH) + 2 * CH;
}

template <int MOD, int DH, bool KPASS>
__host__ __device__ constexpr size_t smem_floats() {
  return 2 * (size_t)BT * (DH + 4) + BT * RLD +
         Tiling<MOD, KPASS>::STAGES * (size_t)stage_floats<MOD, DH, KPASS>();
}

// KPASS = false: own = query rows (Q, g_out, R, lse, dvec), chunk = keys
// (K, V, K̂, pad) → dq, dR.  KPASS = true: own = keys (K, V, K̂, pad), chunk =
// query rows (Q, g_out, R, lse, dvec) → dk, dv, dK̂.
template <int MOD, int DH, bool KPASS>
__global__ void __launch_bounds__(THREADS, DH == 64 ? Tiling<MOD, KPASS>::MIN_BLOCKS : 2)
    bwd_tc_kernel(Params p) {
  constexpr int LD = DH + 4;
  constexpr int KS = DH / 8;   // k-steps of the S-shaped products = n8 tiles of dq/dk/dv
  using T = Tiling<MOD, KPASS>;
  constexpr int CH = T::CH, NT = CH / 8, STAGES = T::STAGES, TB = T::TB;
  constexpr int FLD = factor_ld(CH);
  constexpr int STAGE = stage_floats<MOD, DH, KPASS>();
  extern __shared__ __align__(16) float smem[];
  float* O1 = smem;               // Q | K     (BT, LD)
  float* O2 = O1 + BT * LD;       // g_out | V (BT, LD)
  float* OF = O2 + BT * LD;       // R | K̂     (BT, RLD)
  float* stages = OF + BT * RLD;  // STAGES chunk stages

  const int blk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int N = p.N, kk = p.kk;
  const size_t bh = (size_t)b * p.H + h;
  const uint32_t gbh = p.bh0 + (uint32_t)b * p.hstride + (uint32_t)h;
  const int own0 = blk * BT, wo = warp * 16;
  const int orow[2] = {own0 + wo + g, own0 + wo + g + 8};
  const bool active = own0 + wo < N;  // the warp has a real own row
  const uint32_t sseed = MOD == MOD_SBM_SAMPLED ? (uint32_t)p.sseed[0] : 0u;
  const bool dropout = p.rate > 0.f;
  const uint32_t dseed = dropout ? (uint32_t)p.dseed[0] : 0u;
  const float gs = p.gs[bh];

  const float* qg = p.q + bh * N * DH;
  const float* kg = p.k + bh * N * DH;
  const float* vg = p.v + bh * N * DH;
  const float* gg = p.gout + bh * N * DH;
  const float* rg = p.r + bh * N * kk;
  const float* khg = p.kh + bh * N * kk;
  const float* own1 = KPASS ? kg : qg;
  const float* own2 = KPASS ? vg : gg;
  const float* ownf = KPASS ? khg : rg;
  const float* ch1 = KPASS ? qg : kg;
  const float* ch2 = KPASS ? gg : vg;
  const float* chf = KPASS ? rg : khg;
  const float* padg = p.pad + (size_t)b * N;
  const float* lseg = p.lse + bh * N;
  const float* dvecg = p.dvec + bh * N;

  // the transposed factor chunk's cluster rows kk..15 stay 0 in every stage
  for (int s = 0; s < STAGES; ++s) {
    float* F = stages + s * STAGE + 2 * CH * LD;
    for (int i = tid; i < (KKMAX - kk) * FLD; i += THREADS) F[kk * FLD + i] = 0.f;
  }

  // chunk c into stage c % STAGES: rows 1 and 2, the factor transposed, the vectors
  auto load_chunk = [&](int c) {
    float* st = stages + (c % STAGES) * STAGE;
    float* C1 = st;
    float* C2 = C1 + CH * LD;
    float* CF = C2 + CH * LD;
    float* V0 = CF + KKMAX * FLD;
    float* V1 = V0 + CH;
    const int c0 = c * CH;
    load_rows<DH, CH>(C1, ch1, c0, N);
    load_rows<DH, CH>(C2, ch2, c0, N);
    for (int i = tid; i < kk * CH; i += THREADS) {
      const int j = i / CH, n = i % CH, gn = c0 + n;
      const bool in = gn < N;
      cp4(CF + j * FLD + n, chf + (in ? (size_t)gn * kk + j : 0), in);
    }
    for (int n = tid; n < CH; n += THREADS) {
      const int gn = c0 + n;
      const bool in = gn < N;
      if (KPASS) {
        cp4(V0 + n, lseg + (in ? gn : 0), in);
        cp4(V1 + n, dvecg + (in ? gn : 0), in);
      } else {
        cp4(V0 + n, padg + (in ? gn : 0), in);
      }
    }
  };

  // own tiles and factor rows, with the first STAGES - 1 chunks, as the first group
  load_rows<DH, BT>(O1, own1, own0, N);
  load_rows<DH, BT>(O2, own2, own0, N);
  for (int i = tid; i < BT * kk; i += THREADS) {
    const int r = i / kk, j = i % kk, gr = own0 + r;
    const bool in = gr < N;
    cp4(OF + r * RLD + j, ownf + (in ? (size_t)gr * kk + j : 0), in);
  }
  const int nch = (N + CH - 1) / CH;  // chunks of the sweep
  for (int c = 0; c < STAGES - 1 && c < nch; ++c) load_chunk(c);
  cp_commit();

  // own-row vectors in registers: lse and dvec (q-pass) or the pad gate (k-pass)
  float ov0[2], ov1[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int o = orow[hr];
    if (KPASS) {
      ov0[hr] = o < N ? padg[o] : 1.f;
      ov1[hr] = 0.f;
    } else {
      ov0[hr] = o < N ? lseg[o] : NEG;
      ov1[hr] = o < N ? dvecg[o] : 0.f;
    }
  }

  float acc1[KS][4] = {};   // dq | dk
  float acc2[KS][4] = {};   // dv (k-pass)
  float accf[2][4] = {};    // dR | dK̂

  // chunks while c·CH < N: compared with N itself, so that no chunk count
  // holds a register through the sweep
  // (the one-stage q-pass compares c·CH with N: at its 128-register cap
  // ptxas spilled the chunk count, which then held a register for nothing)
  for (int c = 0; STAGES == 1 ? c * CH < N : c < nch; ++c) {
    if (STAGES == 1 || c + STAGES - 1 < nch) load_chunk(c + STAGES - 1);
    cp_commit();  // an empty group past the last chunk keeps the count
    cp_wait<STAGES - 1>();
    __syncthreads();

    const float* st = stages + (c % STAGES) * STAGE;
    const float* C1 = st;
    const float* C2 = C1 + CH * LD;
    const float* CF = C2 + CH * LD;
    const float* V0 = CF + KKMAX * FLD;
    const float* V1 = V0 + CH;
    const int c0 = c * CH;
    const int ntn = min(NT, (N - c0 + 7) >> 3);  // n8 groups holding real indices

    if (active) {
      const float* f0 = OF + (wo + g) * RLD;  // the warp's own factor rows g, g + 8
      const float* f1 = f0 + 8 * RLD;
      // the warp's 16 x 16 sub-tile TB n8 tiles at a time: entry i of tile
      // t = t0 + u is own row g + 8 (i >> 1), chunk index 8 t + 2 tig + (i & 1)
#pragma unroll
      for (int t0 = 0; t0 < NT; t0 += TB) {
        if (t0 >= ntn) break;  // n8 tiles wholly past N
        // ---- the weights: R·K̂ᵀ in the forward's order, the graph, the gates ----
        float ea[TB][4] = {};
        for (int j = 0; j < kk; ++j) {
          const float a0 = f0[j], a1 = f1[j];
#pragma unroll
          for (int u = 0; u < TB; ++u)
            if (t0 + u < ntn) {
              const float2 fv =
                  *reinterpret_cast<const float2*>(CF + j * FLD + 8 * (t0 + u) + 2 * tig);
              ea[u][0] = __fadd_rn(ea[u][0], __fmul_rn(a0, fv.x));
              ea[u][1] = __fadd_rn(ea[u][1], __fmul_rn(a0, fv.y));
              ea[u][2] = __fadd_rn(ea[u][2], __fmul_rn(a1, fv.x));
              ea[u][3] = __fadd_rn(ea[u][3], __fmul_rn(a1, fv.y));
            }
        }
        // a_raw: the sampled edge, or the expected mod's clip weight, with
        // its clip gate c; keyin = 1 − pad of the entry's key
        float a_raw[TB][4], cg[TB][4], keyin[TB][4];
        int live_l = 0, dlive_l = 0;
        // the chunk's vectors: the pad gate (q-pass) or lse and dvec (k-pass)
        float2 cv[TB], dv[TB];
#pragma unroll
        for (int u = 0; u < TB; ++u) {
          cv[u] = *reinterpret_cast<const float2*>(V0 + 8 * (t0 + u) + 2 * tig);
          dv[u] = KPASS ? *reinterpret_cast<const float2*>(V1 + 8 * (t0 + u) + 2 * tig)
                        : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < TB; ++u) {
          const int t = t0 + u;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int o = orow[i >> 1], n = c0 + 8 * t + 2 * tig + (i & 1);
            const int qrow = KPASS ? n : o, key = KPASS ? o : n;
            const float pad = KPASS ? ov0[i >> 1] : ((i & 1) ? cv[u].y : cv[u].x);
            const float lse = KPASS ? ((i & 1) ? cv[u].y : cv[u].x) : ov0[i >> 1];
            const bool in = t < ntn && o < N && n < N;
            float a = 0.f, c = 0.f;
            if (MOD == MOD_SBM_SAMPLED) {
              if (in) {
                const float pr = fminf(fmaxf(ea[u][i], p.floor_), 0.99f);
                a = hash_uniform(sseed, gbh, qrow, key, p.stride) < pr
                        ? 1.f : 0.f;
              }
              live_l |= (a * (1.f - pad) > 0.f);
              dlive_l |= (a > 0.f);
            } else {
              if (in) clip_gate(ea[u][i], p.floor_, a, c);
              // live: weight (or an open gate at weight 0) on a real key, in a
              // query row that saw live weight in the forward
              live_l |= ((a > 0.f || c > 0.f) && pad < 1.f && lse > LIVE_LSE);
              dlive_l |= (c > 0.f);
            }
            a_raw[u][i] = a;
            cg[u][i] = c;
            keyin[u][i] = 1.f - pad;
          }
        }
        const bool live = __any_sync(0xffffffffu, live_l);
        const bool dlive = __any_sync(0xffffffffu, dlive_l);

        float ds[TB][4] = {}, de[TB][4], at[TB][4] = {};
        if (live) {
          // ---- S = own1·chunk1ᵀ, dP = own2·chunk2ᵀ (Q·Kᵀ, g·Vᵀ | K·Qᵀ, V·gᵀ),
          // rounded splits; dP a fresh accumulator per k-step, added in f32
          // (d_a's g·v − dvec cancels: its error reaches dR undamped) ----
          float x[TB][4] = {}, y[TB][4] = {};
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            const int d0 = 8 * ks + tig;
            const float* a1p = O1 + (wo + g) * LD + d0;
            const float* a2p = O2 + (wo + g) * LD + d0;
            const float a1[4] = {a1p[0], a1p[8 * LD], a1p[4], a1p[8 * LD + 4]};
            const float a2[4] = {a2p[0], a2p[8 * LD], a2p[4], a2p[8 * LD + 4]};
            uint32_t h1[4], l1[4], h2[4], l2[4];
            split4<true>(a1, h1, l1);
            split4<true>(a2, h2, l2);
#pragma unroll
            for (int u = 0; u < TB; ++u)
              if (t0 + u < ntn) {
                const float* b1 = C1 + (8 * (t0 + u) + g) * LD + d0;
                const float* b2 = C2 + (8 * (t0 + u) + g) * LD + d0;
                mma3<true>(x[u], h1, l1, b1[0], b1[4]);
                float fr[4] = {};
                mma3<true>(fr, h2, l2, b2[0], b2[4]);
#pragma unroll
                for (int e = 0; e < 4; ++e) y[u][e] += fr[e];
              }
          }
          // ---- the entries ----
#pragma unroll
          for (int u = 0; u < TB; ++u) {
            const int t = t0 + u;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float we = a_raw[u][i] * keyin[u][i];
              const int o = orow[i >> 1], n = c0 + 8 * t + 2 * tig + (i & 1);
              const int qrow = KPASS ? n : o, key = KPASS ? o : n;
              const float lse = KPASS ? ((i & 1) ? cv[u].y : cv[u].x) : ov0[i >> 1];
              const bool finite = lse > LIVE_LSE && qrow < N;
              if (MOD == MOD_SBM_SAMPLED
                      ? !(we > 0.f)
                      : !(finite && (we > 0.f || (cg[u][i] > 0.f && keyin[u][i] > 0.f)))) {
                // no attention weight (sampled: d_s and P are 0, and the
                // attention term of d_a is gated off or multiplied by a_raw =
                // 0), or e = 0 on a dead row: d_a is gs alone
                de[u][i] = MOD == MOD_SBM_SAMPLED ? fminf(fmaxf(a_raw[u][i] * gs, -1.f), 1.f)
                                                  : gs * cg[u][i];
                continue;
              }
              const float dvec = KPASS ? ((i & 1) ? dv[u].y : dv[u].x) : ov1[i >> 1];
              const float e = finite ? expf(fminf(x[u][i] * p.scale - lse, 80.f)) : 0.f;
              float keep = 1.f;
              if (dropout)
                keep = hash_uniform(dseed, gbh, qrow, key, p.stride) >= p.rate
                           ? p.keep_scale : 0.f;
              const float tt = y[u][i] * keep - dvec;
              const float attn = e * we;
              ds[u][i] = attn * tt;
              const float d_a = e * tt * keyin[u][i] + gs;
              de[u][i] = MOD == MOD_SBM_SAMPLED ? fminf(fmaxf(a_raw[u][i] * d_a, -1.f), 1.f)
                                                : d_a * cg[u][i];
              at[u][i] = attn * keep;
            }
          }
          // ---- dq += dS·K | dk += dSᵀ·Q, dv += (P∘keep)ᵀ·g: the chunk index
          // permuted (k = tig <-> 2 tig, k = tig + 4 <-> 2 tig + 1), so the
          // accumulators are the A operand; the chunk's rows read in that order ----
#pragma unroll
          for (int u = 0; u < TB; ++u)
            if (t0 + u < ntn) {
              const float a[4] = {ds[u][0], ds[u][2], ds[u][1], ds[u][3]};
              uint32_t ah[4], al[4];
              split4(a, ah, al);
              const float* bp = C1 + (8 * (t0 + u) + 2 * tig) * LD + g;
#pragma unroll
              for (int dt = 0; dt < KS; ++dt) mma3(acc1[dt], ah, al, bp[8 * dt], bp[LD + 8 * dt]);
              if (KPASS) {
                const float a2[4] = {at[u][0], at[u][2], at[u][1], at[u][3]};
                split4(a2, ah, al);
                const float* bq = C2 + (8 * (t0 + u) + 2 * tig) * LD + g;
#pragma unroll
                for (int dt = 0; dt < KS; ++dt)
                  mma3(acc2[dt], ah, al, bq[8 * dt], bq[LD + 8 * dt]);
              }
            }
        } else {
          // no live weight in the TB tiles: the graph_sum term alone
#pragma unroll
          for (int u = 0; u < TB; ++u)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              de[u][i] = MOD == MOD_SBM_SAMPLED ? fminf(fmaxf(a_raw[u][i] * gs, -1.f), 1.f)
                                                : gs * cg[u][i];
        }

        // ---- dR += dE·K̂ | dK̂ += dEᵀ·R, the factor chunk read transposed ----
        if (dlive) {
#pragma unroll
          for (int u = 0; u < TB; ++u)
            if (t0 + u < ntn) {
              const float a[4] = {de[u][0], de[u][2], de[u][1], de[u][3]};
              uint32_t ah[4], al[4];
              split4<true>(a, ah, al);
#pragma unroll
              for (int jt = 0; jt < 2; ++jt)
                if (8 * jt < kk) {
                  const float2 fv = *reinterpret_cast<const float2*>(
                      CF + (8 * jt + g) * FLD + 8 * (t0 + u) + 2 * tig);
                  mma3<true>(accf[jt], ah, al, fv.x, fv.y);
                }
            }
        }
      }
    }
    __syncthreads();  // the stage is free for chunk c + STAGES
  }

  if (!active) return;
  // ---- epilogue: accumulator entry i of n8 tile dt is own row g + 8 (i >> 1),
  // column 8 dt + 2 tig + (i & 1) ----
  float* out1 = KPASS ? p.dk : p.dq;
  float* outf = KPASS ? p.dkh : p.dr;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int o = orow[hr];
    if (o >= N) continue;
    float* d1 = out1 + (bh * N + o) * DH + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < KS; ++dt)
      *reinterpret_cast<float2*>(d1 + 8 * dt) =
          make_float2(acc1[dt][2 * hr] * p.scale, acc1[dt][2 * hr + 1] * p.scale);
    if (KPASS) {
      float* d2 = p.dv + (bh * N + o) * DH + 2 * tig;
#pragma unroll
      for (int dt = 0; dt < KS; ++dt)
        *reinterpret_cast<float2*>(d2 + 8 * dt) = make_float2(acc2[dt][2 * hr], acc2[dt][2 * hr + 1]);
    }
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * jt + 2 * tig + e;
        if (j < kk) outf[(bh * N + o) * kk + j] = accf[jt][2 * hr + e];
      }
  }
}

template <int MOD, int DH, bool KPASS>
int launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_floats<MOD, DH, KPASS>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(bwd_tc_kernel<MOD, DH, KPASS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // the largest shared-memory carveout, so that the shared memory never
  // caps the blocks an SM holds below what the registers allow
  err = cudaFuncSetAttribute(bwd_tc_kernel<MOD, DH, KPASS>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.N + BT - 1) / BT, p.H, p.B);
  bwd_tc_kernel<MOD, DH, KPASS><<<grid, THREADS, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// The head widths of ops/build.py HEAD_DIMS: 64 (python), 96 (java).
template <int MOD, bool KPASS>
int dispatch(int dh, const Params& p, cudaStream_t stream) {
  if (dh == 64) return launch<MOD, 64, KPASS>(p, stream);
  if (dh == 96) return launch<MOD, 96, KPASS>(p, stream);
  return -1;  // head width without an instantiation
}

template <int MOD, bool KPASS>
int run(const float* q, const float* k, const float* v, const float* r, const float* kh,
        const float* pad, const int32_t* sseed, const int32_t* dseed, const float* lse,
        const float* dvec, const float* gout, const float* gs, float* dq, float* dr,
        float* dk, float* dv, float* dkh, int B, int H, int N, int DH, int KK, int stride,
        int bh0, int hstride, float floor_, float scale, float rate, float keep_scale, void* stream) {
  if (KK < 1 || KK > KKMAX) return -3;
  if (bh0 < 0 || hstride < H) return -7;
  if (rate > 0.f && dseed == nullptr) return -4;
  if (MOD == MOD_SBM_SAMPLED && sseed == nullptr) return -5;
  Params p{};
  p.q = q; p.k = k; p.v = v; p.r = r; p.kh = kh; p.pad = pad;
  p.sseed = sseed; p.dseed = dseed; p.lse = lse; p.dvec = dvec; p.gout = gout; p.gs = gs;
  p.dq = dq; p.dr = dr; p.dk = dk; p.dv = dv; p.dkh = dkh;
  p.B = B; p.H = H; p.N = N; p.kk = KK; p.stride = (uint32_t)stride;
  p.bh0 = (uint32_t)bh0; p.hstride = (uint32_t)hstride;
  p.floor_ = floor_; p.scale = scale; p.rate = rate; p.keep_scale = keep_scale;
  return dispatch<MOD, KPASS>(DH, p, (cudaStream_t)stream);
}

}  // namespace

extern "C" int flex_bwd_q_sbm_sampled(
    const float* q, const float* k, const float* v, const float* r, const float* kh,
    const float* pad, const int32_t* sseed, const int32_t* dseed, const float* lse,
    const float* dvec, const float* gout, const float* gs, float* dq, float* dr, int B,
    int H, int N, int DH, int KK, int stride, int bh0, int hstride, float floor_, float scale, float rate,
    float keep_scale, void* stream) {
  return run<MOD_SBM_SAMPLED, false>(q, k, v, r, kh, pad, sseed, dseed, lse, dvec, gout, gs,
                                     dq, dr, nullptr, nullptr, nullptr, B, H, N, DH, KK,
                                     stride, bh0, hstride, floor_, scale, rate, keep_scale, stream);
}

extern "C" int flex_bwd_k_sbm_sampled(
    const float* q, const float* k, const float* v, const float* r, const float* kh,
    const float* pad, const int32_t* sseed, const int32_t* dseed, const float* lse,
    const float* dvec, const float* gout, const float* gs, float* dk, float* dv,
    float* dkh, int B, int H, int N, int DH, int KK, int stride, int bh0, int hstride, float floor_,
    float scale, float rate, float keep_scale, void* stream) {
  return run<MOD_SBM_SAMPLED, true>(q, k, v, r, kh, pad, sseed, dseed, lse, dvec, gout, gs,
                                    nullptr, nullptr, dk, dv, dkh, B, H, N, DH, KK, stride,
                                    bh0, hstride, floor_, scale, rate, keep_scale, stream);
}

// The expected pair's argument lists are the sampled pair's without the
// sample seed: the expected mod draws no graph.
extern "C" int flex_bwd_q_sbm_expected(
    const float* q, const float* k, const float* v, const float* r, const float* kh,
    const float* pad, const int32_t* dseed, const float* lse, const float* dvec,
    const float* gout, const float* gs, float* dq, float* dr, int B, int H, int N, int DH,
    int KK, int stride, int bh0, int hstride, float floor_, float scale, float rate, float keep_scale,
    void* stream) {
  return run<MOD_SBM_EXPECTED, false>(q, k, v, r, kh, pad, nullptr, dseed, lse, dvec, gout, gs,
                                      dq, dr, nullptr, nullptr, nullptr, B, H, N, DH, KK,
                                      stride, bh0, hstride, floor_, scale, rate, keep_scale, stream);
}

extern "C" int flex_bwd_k_sbm_expected(
    const float* q, const float* k, const float* v, const float* r, const float* kh,
    const float* pad, const int32_t* dseed, const float* lse, const float* dvec,
    const float* gout, const float* gs, float* dk, float* dv, float* dkh, int B, int H,
    int N, int DH, int KK, int stride, int bh0, int hstride, float floor_, float scale, float rate,
    float keep_scale, void* stream) {
  return run<MOD_SBM_EXPECTED, true>(q, k, v, r, kh, pad, nullptr, dseed, lse, dvec, gout, gs,
                                     nullptr, nullptr, dk, dv, dkh, B, H, N, DH, KK, stride,
                                     bh0, hstride, floor_, scale, rate, keep_scale, stream);
}
