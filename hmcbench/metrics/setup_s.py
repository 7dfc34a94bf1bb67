"""setup_s: from the start of the process to the window's start: imports,
loading (and in a fresh checkout building) the kernel libraries, the data,
the initial points and one call of each of the job's shapes."""


def read(rec):
    return rec["setup_s"]
