"""ess_per_draw: the median parameter's ESS over the window's post-warmup
chain-draws, the adaptation's product (ess_per_s × window / draws)."""


def read(rec):
    return float(rec["ess"].median()) / rec["draws"]
