"""kl_roofline_pct: KL (cuckoo_build, the device finalize's table)
against its roofline.

Bytes: what any build must move, 20 a kept key read (shard, keybody,
payload) and the table of 8 * 2^c_bits bytes written once, from the
report's n_kept and c_bits.  Operations: a hash and probe a key."""

from portbench.measure import OPS_PROBE


def read(w, tally):
    if not w.jobs or any(j["report"].get("c_bits") is None for j in w.jobs):
        return None
    keys = sum(j["report"]["n_kept"] for j in w.jobs)
    table = sum(8 << j["report"]["c_bits"] for j in w.jobs)
    return w.roofline_pct("KL", keys * 20 + table, keys * OPS_PROBE)
