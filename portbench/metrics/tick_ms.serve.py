"""``tick_ms.serve``: the window's ``ServeEngine.tick`` calls (the
benchmark's ``serve.tick`` span), time per tick."""


def read(rec):
    n = rec.spans.count.get("serve.tick", 0)
    return 1000.0 * rec.spans.total["serve.tick"] / n if n else None
