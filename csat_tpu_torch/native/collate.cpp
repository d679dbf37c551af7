// Fused batch-collate kernel for the relation matrices — the host-side hot
// path of the input pipeline that feeds the card on the fixed-shape train
// and eval path.
//
// The reference's collate (dataset/base_data_set.py:20-75 there) stacks
// per-sample L/T tensors, builds masks from the raw distances, then
// offsets+clamps them — in torch, as separate whole-tensor passes. The
// NumPy collate (csat_tpu_torch/data/dataset.py:collate) mirrors those
// passes; for B=64, N=150 that is five full sweeps over two (B,N,N) arrays
// plus the fancy-index gather. On a host core feeding the card, those
// sweeps ARE the input pipeline budget.
//
// Outputs use the narrowest exact dtypes (int16 distances, uint8 adj) so
// the host->device copy per batch is minimal; the batch is widened on the
// device (csat_tpu_torch/data/dataset.py:batch_to_device).
//
// This kernel fuses gather + mask + adjacency + offset/clamp for both
// matrices into a single streaming pass per sample: each int16 element is
// read once and all five outputs are written from registers. Semantics are
// bit-identical to the NumPy path (differential test:
// tests/test_torch_native.py). The code is the JAX package's
// csat_tpu/native/collate.cpp, comments aside.
//
// Plain C ABI + ctypes (no pybind11 needed); built on first use with g++ by
// csat_tpu_torch/native/__init__.py.

#include <cstdint>

extern "C" void collate_rel_c(
    const int16_t* L_all,  // (S, N, N) dataset-resident raw distances
    const int16_t* T_all,  // (S, N, N)
    const int64_t* idx,    // (B,) sample indices into S
    int64_t B, int64_t N,
    int32_t off, int32_t hi,
    int16_t* L_out,        // (B, N, N) offset+clamped (fits: hi < N < 2^15)
    int16_t* T_out,        // (B, N, N)
    uint8_t* L_mask,       // (B, N, N) raw == 0
    uint8_t* T_mask,       // (B, N, N)
    uint8_t* adj)          // (B, N, N) |L_raw| <= 1
{
  const int64_t nn = N * N;
  for (int64_t b = 0; b < B; ++b) {
    const int16_t* Ls = L_all + idx[b] * nn;
    const int16_t* Ts = T_all + idx[b] * nn;
    int16_t* Lo = L_out + b * nn;
    int16_t* To = T_out + b * nn;
    uint8_t* Lm = L_mask + b * nn;
    uint8_t* Tm = T_mask + b * nn;
    uint8_t* Ad = adj + b * nn;
    for (int64_t i = 0; i < nn; ++i) {
      const int32_t l = Ls[i];
      const int32_t t = Ts[i];
      Lm[i] = (l == 0);
      Tm[i] = (t == 0);
      Ad[i] = (l >= -1 && l <= 1) ? 1 : 0;
      int32_t lo = l + off;
      lo = lo < 0 ? 0 : (lo > hi ? hi : lo);
      int32_t to = t + off;
      to = to < 0 ? 0 : (to > hi ? hi : to);
      Lo[i] = static_cast<int16_t>(lo);
      To[i] = static_cast<int16_t>(to);
    }
  }
}
