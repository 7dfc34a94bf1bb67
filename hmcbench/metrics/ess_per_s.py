"""ess_per_s: the median over parameters of the pooled bulk ESS of the
window's post-warmup draws, over the whole window (warmup included)."""


def read(rec):
    return float(rec["ess"].median()) / rec["window_s"]
