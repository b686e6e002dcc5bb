"""count_s: the counting phase of a job, the finalize and the table
included (run_device's report: count_s, which ends in a device
synchronize), as the mean over the window's jobs."""


def read(w, tally):
    return w.mean("count_s")
