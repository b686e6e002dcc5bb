"""ka_roofline_pct: KA (kmer_stream) against its roofline.

Bytes at each call's shape (B reads of L slots): the bases and quality
flags read (2 a slot), the lengths (4 a read), and the shard, keybody
and arrival words written (8 each a slot; ret too where the call makes
it).  Operations: a canonical hash and shard split for each k-mer the
lengths hold."""

from portbench.measure import OPS_KMER, add, number, valid_kmers


def hooks(tally):
    def on_call(args, kwargs, out):
        bases, lens, k = args[0], args[2], args[3]
        B, L = bases.shape
        words = 4 if out[3] is not None else 3
        add(tally, "bytes", B * L * 2 + B * 4 + B * L * 8 * words)
        add(tally, "kmers", valid_kmers(lens, k))

    return {"bfc_tpu_torch.ops.kmer:kmer_stream": on_call}


def read(w, tally):
    if "bytes" not in tally:
        return None
    return w.roofline_pct("KA", number(tally["bytes"]),
                          number(tally["kmers"]) * OPS_KMER)
