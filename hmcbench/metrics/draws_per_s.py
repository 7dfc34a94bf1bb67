"""draws_per_s: post-warmup chain-draws completed in the window, over the
whole window (warmup included)."""


def read(rec):
    return rec["draws"] / rec["window_s"]
