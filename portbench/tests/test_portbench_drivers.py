"""What the drivers derive on the host: the order of the first training
batches, and the lanes a paged-decode launch reads."""

import types

import numpy as np

from portbench.core.spec import load_part


def _batch(n, tag):
    return types.SimpleNamespace(src_seq=np.zeros((2, n)), tag=tag)


def test_the_first_batches_hold_one_of_each_width_then_the_rest_in_order():
    train = load_part("drivers", "train")
    stream = [_batch(n, i) for i, n in enumerate([150, 150, 75, 150, 37, 75, 150, 37])]
    out = list(train.first_per_width(iter(stream), [37, 75, 150]))
    assert [b.src_seq.shape[1] for b in out[:3]] == [150, 75, 37]
    assert [b.tag for b in out] == [0, 2, 4, 1, 3, 5, 6, 7]   # nothing lost, nothing twice


def test_a_width_that_never_comes_stops_the_look_ahead():
    train = load_part("drivers", "train")
    stream = [_batch(150, i) for i in range(300)]
    out = train.first_per_width(iter(stream), [37, 75, 150])
    assert [b.tag for b in out] == list(range(300))


def _req(nodes, admit_tick, phash):
    return types.SimpleNamespace(sample={"num_node": np.int32(nodes)}, admit_tick=admit_tick,
                                 phash=phash)


def test_decode_lanes_count_shared_chains_once_and_fresh_slots_at_zero():
    serve = load_part("drivers", "serve")
    status = np.array([[5, 0, 0], [0, 0, 0], [2, 0, 0], [9, 0, 0]], np.int32)
    engine = types.SimpleNamespace(
        _tick_no=7, _status=status,
        _slots=[_req(40, 3, b"a"), None, _req(40, 6, b"a"), _req(12, 7, b"b")])
    lanes = serve.decode_lanes(engine)
    assert lanes == {"cross": [40, 12], "self": [5, 2, 0]}
    assert serve.decode_lanes(types.SimpleNamespace()) is None
