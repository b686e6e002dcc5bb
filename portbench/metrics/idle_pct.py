"""idle_pct: the share of the window in which no kernel, copy or fill
ran on the card, from the profiler's timeline (devtrace)."""


def read(w, tally):
    if w.trace is None or w.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s / w.trace.window_s)
