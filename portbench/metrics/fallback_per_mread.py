"""fallback_per_mread: reads that KD gave up on and the scalar model
corrected on the host (run_device's report: n_fallback), per million
input reads of the window."""


def read(w, tally):
    n = w.total("n_fallback")
    if n is None or not w.reads:
        return None
    return n * 1e6 / w.reads
