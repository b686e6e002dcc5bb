"""trim_s: the trim phase of a -1 job (run_device's report: trim_s):
reading, KH and the emit, as the mean over the window's jobs."""


def read(w, tally):
    return w.mean("trim_s")
