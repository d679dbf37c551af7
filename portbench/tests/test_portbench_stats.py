"""The rate arithmetic: window bases, what ended inside the window, the
slots an engine kept busy, the prefills a repeat is charged."""

import pytest

from portbench.core import counts
from portbench.core.peaks import PEAKS
from portbench.core.readers import serve_mfu
from portbench.core.record import Record
from portbench.core.spec import load_part


def _serve_record(requests, window=10.0):
    rec = Record(cell="x", model={}, mix={})
    rec.window_s = window
    rec.requests = requests
    return rec


def _req(due, done, ok=True, tokens=5):
    return {"due": due, "done": done, "ok": ok, "tokens": tokens, "nodes": 10, "repeat": False}


def test_live_slots_average_over_the_window_s_ticks():
    rec = _serve_record([])
    rec.counters = {"live_slot_ticks": 310.0, "window_ticks": 10.0}
    assert load_part("metrics", "slots_live.serve").read(rec) == 31.0
    rec.counters = {"live_slot_ticks": 0.0, "window_ticks": 0.0}
    assert load_part("metrics", "slots_live.serve").read(rec) is None


def test_a_repeat_is_charged_the_share_of_admitted_repeats_that_missed():
    model = {k: 8 for k in ("num_heads", "pegen_dim", "sbm_enc_dim", "hidden_size",
                            "dim_feed_forward", "pe_dim", "tgt_vocab_size")}
    model.update(num_layers=1, decoder_layers=1, clusters=[2])
    fresh = dict(_req(1.0, 2.0, tokens=4), nodes=10)
    rep = dict(fresh, repeat=True)
    open_ = dict(rep, done=None)          # still queued at the close: never admitted
    rec = _serve_record([fresh, rep, rep, open_, open_, open_], window=10.0)
    # 3 admissions, 2 of them repeats (2/3 of what ended), 1 of those a hit
    rec.counters = {"prefix_hits": 1.0, "prefix_misses": 2.0}
    dec = counts.decode_flops(model, 10, 4)
    enc = counts.encoder_flops(model, 10)
    want = (3 * dec + enc + 2 * 0.5 * enc) / 10.0
    rec.model = model
    assert serve_mfu(rec) / 100.0 * PEAKS["float32"]["tc"] == pytest.approx(want)


def test_tokens_per_second_counts_what_ended_inside_the_window():
    rec = _serve_record([_req(1.0, 2.0, tokens=10), _req(9.0, 9.9, tokens=7),
                         _req(9.5, 10.5, tokens=100), _req(3.0, 4.0, ok=False, tokens=50)],
                        window=10.0)
    assert load_part("metrics", "serve_tokens_per_s").read(rec) == pytest.approx(1.7)


def test_train_rate_is_real_nodes_over_the_whole_window():
    rec = Record(cell="x", model={}, mix={})
    rec.window_s = 2.0
    rec.steps = [{"n": 100.0}, {"n": 300.0}]
    assert load_part("metrics", "train_nodes_per_s").read(rec) == 200.0
    rec.steps = []
    assert load_part("metrics", "train_nodes_per_s").read(rec) is None


def test_a_reader_with_nothing_to_read_returns_nothing():
    rec = Record(cell="x", model={}, mix={})
    for name in ("kernel_roofline.train", "kernel_roofline.serve", "device_idle.serve",
                 "tick_ms.serve", "slots_live.serve", "prefix_hit_rate.serve",
                 "data_wait_ms.train", "train_mfu", "serve_mfu"):
        assert load_part("metrics", name).read(rec) is None, name
