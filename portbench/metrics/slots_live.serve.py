"""``slots_live.serve``: the engine's live slots after each ``tick()`` that
began inside the window, averaged over those ticks.  Near the slot count,
the engine is saturated and the window's tokens per second are its
capacity."""


def read(rec):
    ticks = rec.counters.get("window_ticks", 0.0)
    return rec.counters["live_slot_ticks"] / ticks if ticks else None
