"""min_ess_per_draw: the worst parameter's ESS over the window's post-warmup
chain-draws, the adaptation's product for the tail (min_ess_per_s × window
/ draws)."""


def read(rec):
    return float(rec["ess"].min()) / rec["draws"]
