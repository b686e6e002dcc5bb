"""kd_roofline_pct: KD (ec1_search) against its roofline.

Bytes at each call's shape (B reads of L slots): bases, qualities and
annotations read and the packed result written (5 a slot), 16 a read
and the result columns (4 each a read), and two 32-byte sectors for
each table probe the search made (the PROBES column of KD's result,
summed on the card).  Operations: a hash and probe a probe."""

from portbench.measure import OPS_PROBE, SECTOR, add, number


def hooks(tally):
    from bfc_tpu_torch.ops import search

    def on_call(args, kwargs, out):
        bases = args[3]
        B, L = bases.shape
        res = out[1]
        add(tally, "bytes", B * L * 5 + B * (16 + 4 * res.shape[1]))
        add(tally, "probes", res[:, search.PROBES].sum())

    return {"bfc_tpu_torch.ops.search:ec1_search": on_call}


def read(w, tally):
    if "bytes" not in tally:
        return None
    probes = number(tally["probes"])
    return w.roofline_pct("KD", number(tally["bytes"]) + probes * 2 * SECTOR,
                          probes * OPS_PROBE)
