"""``train_nodes_per_s``: real (unpadded) AST nodes of every step of the
window, over the window, which closes with a synchronize (host clock)."""


def read(rec):
    if not rec.steps or rec.window_s <= 0:
        return None
    return sum(s["n"] for s in rec.steps) / rec.window_s
