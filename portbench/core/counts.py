"""Operations and bytes, from shapes: the yardstick of the MFU and roofline
metrics.

Model FLOPs count the matrix products CSA-Trans needs for the real
(unpadded) nodes and tokens of a sample, 2 per multiply-add; a training step
is forward plus backward, 3 × the forward.  Per sample of ``n`` nodes and
``t`` decoder positions (those with a target: the summary's words and EOS),
in each layer:

* CSE: q, k, v, o (4 n d²), the relative attention (scores, both bias
  terms, ·V: 4 n² dk per head), the FFN (2 n d²);
* SBM: q, k, v, o (4 n D²), the cluster MLP on q and k (6 n dh² per head),
  the memberships (2 n kk dh per head), Q̂S (n kk² per head) and Q̂SK̂ᵀ
  (n² kk per head), scores and ·V (2 n² dh per head), the FFN (2 n D²);
* the PE expansion (n · pegen · pe) and the encoder's output (n D hidden);
* decoder: self q, k, v, o (4 t h²), self attention (2 t² h), cross q and o
  (2 t h²), cross k and v over the memory (2 n h²), cross attention (2 t n
  h), the FFN (2 t h f); the output head (t h V).

A step's relative tables (``L_q``, ``T_q`` through ``l_q``, ``l_k``, ``t_q``,
``t_k``: 4 R d dk·H/2 per CSE layer) are counted once per step.

Kernel bounds follow the port's kernel table: each input and output byte
once at the HBM rate, the tensor-core products at the f32-exact rate, the
elementwise cluster sums at the f32 rate; the bound is the largest of the
three.  K1's relative-bias dots are left out (at these shapes the bytes
bound is the largest without them), so the bound errs low, never high.

K5 (``paged_decode``) reads only the admissible lanes of each live slot's
page chain, which its arguments do not say: the serving driver notes, at
each launch, the memory nodes of each distinct cross chain and each live
slot's decoded positions.  A cross launch reads each chain's K and V rows
and row scales once; a self launch reads each slot's decoded positions from
its pages and merges this step's K and V; both read each live slot's query,
table and mask rows and write its output, and write the skip counts of every
row.  Free slots' rows (null tables) and slots sharing a chain add nothing,
so this bound errs low too.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from portbench.core.peaks import PEAKS

__all__ = ["sample_terms", "model_flops", "step_table_flops", "decode_flops",
           "encoder_flops", "kernel_bound", "KERNEL_NAMES"]


def sample_terms(c: Dict) -> Dict[str, float]:
    """Forward multiply-adds per sample as coefficients of ``n``, ``n²``,
    ``t``, ``t²`` and ``n·t``."""
    h = c["num_heads"]
    d = c["pegen_dim"]
    big = c["sbm_enc_dim"]
    dh = big // h
    hid, ff = c["hidden_size"], c["dim_feed_forward"]
    co = {"n": 0.0, "n2": 0.0, "t": 0.0, "t2": 0.0, "nt": 0.0}
    for _ in range(c["num_layers"]):
        co["n"] += 4 * d * d + 2 * d * d
        co["n2"] += 4 * d          # q·k, q·lk[rel], k·lq[rel], attn·v over all heads
    for kk in c["clusters"]:
        co["n"] += 4 * big * big + 2 * big * big + h * (6 * dh * dh + 2 * kk * dh + kk * kk)
        co["n2"] += h * kk + 2 * big
    co["n"] += d * c["pe_dim"] + big * hid
    for _ in range(c["decoder_layers"]):
        co["t"] += 4 * hid * hid + 2 * hid * hid + 2 * hid * ff
        co["t2"] += 2 * hid
        co["n"] += 2 * hid * hid
        co["nt"] += 2 * hid
    co["t"] += hid * c["tgt_vocab_size"]
    return co


def step_table_flops(c: Dict) -> float:
    """Forward FLOPs of one step's relative tables (once per batch)."""
    d, h = c["pegen_dim"], c["num_heads"]
    return 2.0 * c["num_layers"] * 4 * c["max_src_len"] * d * (d // h) * (h // 2)


def model_flops(c: Dict, sums: Dict[str, float], backward: bool) -> float:
    """FLOPs of a batch from its sums ``n``, ``n2``, ``t``, ``t2``, ``nt``
    (over its samples) — forward, or with ``backward`` forward and backward."""
    co = sample_terms(c)
    fwd = 2.0 * sum(co[k] * sums.get(k, 0.0) for k in co)
    if backward:
        fwd += step_table_flops(c)
        return 3.0 * fwd
    return fwd


def encoder_flops(c: Dict, n: int) -> float:
    """Forward FLOPs of one request's prefill at ``n`` real nodes: the
    encoder and the cross K/V projection."""
    co = sample_terms(c)
    return 2.0 * (co["n"] * n + co["n2"] * n * n)


def decode_flops(c: Dict, n: int, k: int) -> float:
    """Forward FLOPs of ``k`` decode steps of one request over a memory of
    ``n`` nodes: step ``p`` attends over ``p + 1`` positions."""
    hid, ff = c["hidden_size"], c["dim_feed_forward"]
    per_tok = c["decoder_layers"] * (6 * hid * hid + 2 * hid * ff + 2 * n * hid) \
        + hid * c["tgt_vocab_size"]
    self_att = c["decoder_layers"] * 2 * hid * (k * (k + 1) / 2)
    return 2.0 * (per_tok * k + self_att)


#: the port's C entry points → the device kernels they launch (by name)
KERNEL_NAMES = {
    "flex_fwd_cse": ("flex_cse_kernel",),
    "flex_fwd_sbm_graph": ("flex_graph_kernel",),
    "flex_fwd_sbm_expected": ("flex_tc_kernel",),
    "paged_decode": ("paged_decode_kernel",),
}

#: ``paged_decode``'s page dtype code → bytes of a stored value
PAGE_BYTES = {0: 4, 1: 2, 2: 1}


def kernel_bound(fn: str, args: Tuple, dtype: str = "float32",
                 note: Optional[Dict] = None) -> Optional[float]:
    """Least seconds of one launch of C entry point ``fn`` with arguments
    ``args`` (pointers as integers, absent ones None) and, for
    ``paged_decode``, the driver's ``note`` of the live lanes (``{"cross":
    nodes per distinct chain, "self": decoded positions per live slot}``);
    None for an entry point, argument list or note this table does not
    know."""
    p = PEAKS[dtype]
    f4 = 4
    if fn == "flex_fwd_cse" and len(args) == 19:
        b, h, n, dh, r, group = args[11:17]
        planes = h // group
        io = 4 * b * h * n * dh * f4 + 2 * h * r * dh * f4 + b * planes * n * n * (4 + 1) \
            + b * h * n * f4 + 2 * b * h * f4
        tc = 4.0 * b * h * n * n * dh
        return max(io / p["hbm"], tc / p["tc"])
    if fn == "flex_fwd_sbm_graph" and len(args) == 21:
        b, h, n, dh = args[10:14]
        io = 4 * b * h * n * dh * f4 + b * h * n * n * f4 + b * n * f4 + b * h * n * f4 \
            + 2 * b * h * f4
        tc = 4.0 * b * h * n * n * dh
        return max(io / p["hbm"], tc / p["tc"])
    if fn == "flex_fwd_sbm_expected" and len(args) == 24:
        b, h, n, dh, kk = args[11:16]
        io = 4 * b * h * n * dh * f4 + 2 * b * h * n * kk * f4 + b * n * f4 \
            + b * h * n * f4 + 2 * b * h * f4
        tc = 4.0 * b * h * n * n * dh
        simt = 2.0 * b * h * n * n * kk
        return max(io / p["hbm"], tc / p["tc"], simt / p["f32"])
    if fn == "paged_decode" and len(args) == 20 and note is not None:
        code, self_attn = args[0], args[8] is not None
        s, h, nb, page, width, dh = args[13:19]
        live = len(note["self"])
        lanes = sum(note["self"]) if self_attn else sum(note["cross"])
        io = lanes * h * (2 * dh * PAGE_BYTES[code] + 2 * f4)      # K, V rows and their scales
        io += live * (2 * h * dh * f4 + nb * 4 + width)             # q, out, table and mask rows
        if self_attn:
            io += live * (2 * h * dh * f4 + 4)                      # this step's K, V; idx
        io += s * h * 4                                             # skip counts
        return io / p["hbm"]
    return None
