"""cox_k1_roofline (%): over the traced CPU+CUDA stretch, the least time of
the log-Gaussian Cox process's value+grad calls (`roofline_cox.
least_time_s` of each call's chain count over the grid's N cells, the
factor's triangle) over the device time of the kernels launched inside the
benchmark's spans around the target's value+grad. Nothing to read where no
such kernel ran."""

from hmcbench import roofline_cox


def read(rec):
    st, cfg = rec.get("stretch"), rec["config"]
    if not st or st["value_grad_device_s"] <= 0:
        return None
    least = sum(n * roofline_cox.least_time_s(c, cfg["n_rows"],
                                              cfg["design_dtype"])
                for c, n in st["value_grad_calls"].items())
    return 100.0 * least / st["value_grad_device_s"]
