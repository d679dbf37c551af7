"""``setup_s``: process start to the window's opening (host clock)."""


def read(rec):
    return rec.setup_s
