"""correct_s: the correction phase of a job (run_device's report:
correct_s): reading, KC and KD, assembly, the scalar fallback and the
emit, as the mean over the window's jobs."""


def read(w, tally):
    return w.mean("correct_s")
