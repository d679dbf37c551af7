"""``serve_tokens_per_s``: summary tokens of the requests that ended inside
the window, over the window's seconds (host clock)."""


def read(rec):
    if not rec.requests or rec.window_s <= 0:
        return None
    return sum(r["tokens"] for r in rec.requests
               if r["ok"] and r["done"] is not None and r["done"] <= rec.window_s) / rec.window_s
