"""kf_roofline_pct: the device finalize's first-occurrence verdict
against its roofline: KF, or KI where the report's verdict names it.

Bytes: each aggregated row's inputs read once and outputs written once
(KF: ret 8, arrival 4, n 4, fp 1, keep 1; KI: ret 8, arrival 8, fp 1),
from the report's n_aggregated.  Operations: one Bloom addressing a
row."""

from portbench.measure import OPS_BLOOM

ROW_BYTES = {"KF": 18, "KI": 17}


def read(w, tally):
    kinds = {j["report"].get("verdict") for j in w.jobs}
    rows = w.total("n_aggregated")
    if rows is None or len(kinds) != 1 or not kinds <= set(ROW_BYTES):
        return None
    kind = kinds.pop()
    return w.roofline_pct(kind, rows * ROW_BYTES[kind], rows * OPS_BLOOM)
