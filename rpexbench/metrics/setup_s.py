"""Set-up seconds: from the process's start to the window's, taken by
the harness (loading, building or loading the kernels, the weights drawn,
the pilot started, the warm-up tasks)."""


def read(rec):
    return rec["setup_s"]
