"""idle_share (%): 1 − the device's busy time in the traced stretch (the
union of its kernel, copy and memset intervals, from a trace with CUDA
activity only) over the wall the same stretch of work takes unprofiled (the
window's mean per draw call or iteration, times the stretch's): the
profiler's cost on each launch lengthens the traced stretch's own wall."""


def read(rec):
    st = rec.get("stretch")
    if not st or not rec.get("stretch_unprofiled_s"):
        return None
    return 100.0 * (1.0 - st["busy_s"] / rec["stretch_unprofiled_s"])
