"""kc_roofline_pct: KC (kcov_island) against its roofline.

Bytes at each call's shape (B reads of L slots): the bases read and the
coverage and island outputs written (7 a slot together), 16 a read, and
one 32-byte sector of the table for each k-mer probed (one a k-mer the
lengths hold).  Operations: a hash and probe a k-mer."""

from portbench.measure import OPS_PROBE, SECTOR, add, number, valid_kmers


def hooks(tally):
    def on_call(args, kwargs, out):
        table, bases, lens = args[0], args[1], args[2]
        B, L = bases.shape
        add(tally, "bytes", B * L * 7 + B * 16)
        add(tally, "probes", valid_kmers(lens, table.k))

    return {"bfc_tpu_torch.ops.annotate:kcov_island": on_call}


def read(w, tally):
    if "bytes" not in tally:
        return None
    probes = number(tally["probes"])
    return w.roofline_pct("KC", number(tally["bytes"]) + probes * SECTOR,
                          probes * OPS_PROBE)
