"""grad_mfu (%): the FLOPs of the window's useful value+grads (Σ n_steps of
the warmup's and the draws' transitions, each chain-step the likelihood's
two products, `roofline.value_grad_flops`) over the window times the
card's peak for the design's type."""

from hmcbench import roofline


def read(rec):
    cfg = rec["config"]
    flops = rec["useful_steps"] * roofline.value_grad_flops(
        1, cfg["n_rows"], cfg["n_features"])
    return 100.0 * flops / (rec["window_s"]
                            * roofline.PEAK_FLOPS[cfg["design_dtype"]])
