"""The count functions against hand counts at small shapes."""

import math

import pytest

from portbench.core import counts
from portbench.core.peaks import PEAKS

C = {"num_heads": 2, "pegen_dim": 4, "sbm_enc_dim": 8, "pe_dim": 2, "hidden_size": 6,
     "dim_feed_forward": 10, "num_layers": 1, "sbm_layers": 1, "clusters": [3],
     "decoder_layers": 1, "tgt_vocab_size": 7, "max_src_len": 5}


def hand_forward_macs(n, t):
    d, D, h, hid, ff, V, kk = 4, 8, 2, 6, 10, 7, 3
    dh = D // h
    cse = 6 * n * d * d + 4 * n * n * d
    sbm = 6 * n * D * D + h * n * (6 * dh * dh + 2 * kk * dh + kk * kk) + h * n * n * kk \
        + 2 * n * n * D
    glue = n * d * 2 + n * D * hid
    dec = t * (6 * hid * hid + 2 * hid * ff) + 2 * t * t * hid + 2 * n * hid * hid \
        + 2 * t * n * hid
    return cse + sbm + glue + dec + t * hid * V


@pytest.mark.parametrize("n,t", [(1, 1), (3, 2), (5, 4)])
def test_sample_forward_flops_match_a_hand_count(n, t):
    sums = {"n": n, "n2": n * n, "t": t, "t2": t * t, "nt": n * t}
    assert counts.model_flops(C, sums, backward=False) == pytest.approx(
        2 * hand_forward_macs(n, t))


def test_training_step_is_three_forwards_plus_the_tables():
    sums = {"n": 7, "n2": 29, "t": 5, "t2": 13, "nt": 17}
    fwd = counts.model_flops(C, sums, backward=False)
    tables = 2 * 1 * 4 * 5 * 4 * (4 // 2) * (2 // 2)
    assert counts.step_table_flops(C) == tables
    assert counts.model_flops(C, sums, backward=True) == pytest.approx(3 * (fwd + tables))


def test_serving_flops_split_into_prefill_and_decode():
    n, k = 4, 3
    sample = counts.model_flops(C, {"n": n, "n2": n * n}, backward=False)
    assert counts.encoder_flops(C, n) == pytest.approx(sample)
    hid, ff, V = 6, 10, 7
    per_tok = 6 * hid * hid + 2 * hid * ff + 2 * n * hid + hid * V
    assert counts.decode_flops(C, n, k) == pytest.approx(2 * (per_tok * k + 2 * hid * 6))


def _args(n_ptr, ints, floats=1):
    return (None,) * n_ptr + tuple(ints) + (0.5,) * floats + (None,)


def test_kernel_bounds_count_each_byte_once():
    hbm, tc, f32 = (PEAKS["float32"][k] for k in ("hbm", "tc", "f32"))
    b, h, n, dh, r, group = 2, 4, 8, 16, 8, 2
    io = 4 * b * h * n * dh * 4 + 2 * h * r * dh * 4 + b * 2 * n * n * 5 + b * h * n * 4 \
        + 2 * b * h * 4
    got = counts.kernel_bound("flex_fwd_cse", _args(11, (b, h, n, dh, r, group)))
    assert got == pytest.approx(max(io / hbm, 4 * b * h * n * n * dh / tc))
    io = 4 * b * h * n * dh * 4 + b * h * n * n * 4 + b * n * 4 + b * h * n * 4 + 2 * b * h * 4
    got = counts.kernel_bound("flex_fwd_sbm_graph", _args(10, (b, h, n, dh, 128, 0, h), 3))
    assert got == pytest.approx(max(io / hbm, 4 * b * h * n * n * dh / tc))
    kk = 10
    got = counts.kernel_bound("flex_fwd_sbm_expected",
                              _args(11, (b, h, n, dh, kk, 128, 0, h), 4))
    io = 4 * b * h * n * dh * 4 + 2 * b * h * n * kk * 4 + b * n * 4 + b * h * n * 4 \
        + 2 * b * h * 4
    assert got == pytest.approx(max(io / hbm, 4 * b * h * n * n * dh / tc,
                                    2 * b * h * n * n * kk / f32))


def _decode_args(code, self_attn, s, h, nb, page, width, dh):
    ptr = 1 << 20
    return (code, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr if self_attn else None,
            ptr if self_attn else None, ptr if self_attn else None, ptr, ptr,
            s, h, nb, page, width, dh, 0)


@pytest.mark.parametrize("code,elem", [(0, 4), (1, 2), (2, 1)])
def test_paged_decode_bound_counts_the_noted_lanes(code, elem):
    hbm = PEAKS["float32"]["hbm"]
    s, h, nb, page, width, dh = 4, 2, 5, 16, 80, 8
    note = {"cross": [10, 30], "self": [0, 3, 7]}       # two chains, three live slots
    cross = counts.kernel_bound("paged_decode", _decode_args(code, False, s, h, nb, page,
                                                             width, dh), note=note)
    io = 40 * h * (2 * dh * elem + 8) + 3 * (2 * h * dh * 4 + nb * 4 + width) + s * h * 4
    assert cross == pytest.approx(io / hbm)
    slf = counts.kernel_bound("paged_decode", _decode_args(code, True, s, h, nb, page, 49, dh),
                              note=note)
    io = 10 * h * (2 * dh * elem + 8) + 3 * (2 * h * dh * 4 + nb * 4 + 49) \
        + 3 * (2 * h * dh * 4 + 4) + s * h * 4
    assert slf == pytest.approx(io / hbm)


def test_kernel_bound_knows_nothing_it_cannot_count():
    assert counts.kernel_bound("paged_decode", _decode_args(0, False, 4, 2, 5, 16, 80, 8)) is None
    assert counts.kernel_bound("paged_decode", (None,) * 20) is None
    assert counts.kernel_bound("flex_fwd_cse", (None,) * 7) is None
    assert math.isclose(counts.kernel_bound("flex_fwd_cse", _args(11, (64, 8, 150, 64, 150, 4)))
                        * 1e3, 0.028, rel_tol=0.05)
