"""min_ess_per_s: the pooled bulk ESS of the worst-mixing parameter of the
window's post-warmup draws, over the whole window (warmup included)."""


def read(rec):
    return float(rec["ess"].min()) / rec["window_s"]
