"""kh_roofline_pct: KH (max_streak) against its roofline.

Bytes at each call's shape (B reads of L slots): the bases read (1 a
slot), the length (4) and result (8) of each read, and one 64-byte Bloom
block for each k-mer the lengths hold (its probes share the block).
Operations: a hash and one Bloom addressing a k-mer."""

from portbench.measure import BLOCK, OPS_BLOOM, OPS_KMER, add, number, valid_kmers


def hooks(tally):
    def on_call(args, kwargs, out):
        bases, lens, k = args[1], args[2], args[3]
        B, L = bases.shape
        add(tally, "bytes", B * (L + 4 + 8))
        add(tally, "kmers", valid_kmers(lens, k))

    return {"bfc_tpu_torch.models.trimmer:max_streak_batch": on_call}


def read(w, tally):
    if "bytes" not in tally:
        return None
    kmers = number(tally["kmers"])
    return w.roofline_pct("KH", number(tally["bytes"]) + kmers * BLOCK,
                          kmers * (OPS_KMER + OPS_BLOOM))
