"""``data_wait_ms.train``: the wait for the next prefetched batch (the
benchmark's ``train.data_wait`` span around taking it), all the window's
waits over its steps: ms per step."""


def read(rec):
    n = rec.spans.count.get("train.data_wait", 0)
    return 1000.0 * rec.spans.total["train.data_wait"] / n if n else None
