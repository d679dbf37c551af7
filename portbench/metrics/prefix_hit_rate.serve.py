"""``prefix_hit_rate.serve``: the window's admissions served from the prefix
cache, ``ServeStats.prefix_hits / (hits + misses)``."""


def read(rec):
    hits, misses = rec.counters.get("prefix_hits"), rec.counters.get("prefix_misses")
    if hits is None or not hits + misses:
        return None
    return 100.0 * hits / (hits + misses)
