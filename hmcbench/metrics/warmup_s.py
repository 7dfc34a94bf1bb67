"""warmup_s: from the window's start to its first post-warmup draw call
(host clock, ending in a synchronise): the warmup layer's time."""


def read(rec):
    return rec["warmup_s"]
