"""Configuration for the bfc-tpu engine (PyTorch/CUDA port).

Mirrors the option surface of the reference CLI tool (bfc_opt_t in
bfc.h:15-33 with defaults from bfc.c:17-40
and the genome-size auto-derivation at bfc.c:42-53), plus
device execution knobs that have no reference counterpart.
"""

from __future__ import annotations

import dataclasses
import math

BFC_MAX_KMER = 63          # reference bfc.h:8
BFC_MAX_BF_SHIFT = 37      # reference bfc.h:9
BFC_MAX_PATHS = 4          # reference bfc.h:11
BFC_EC_HIST = 5            # reference bfc.h:12
BFC_EC_HIST_HIGH = 2       # reference bfc.h:13
BFC_CH_KEYBITS = 50        # reference htab.h:7
BFC_CH_MAXPRE = 24         # reference htab.h:8
BFC_BLK_SHIFT = 9          # 512-bit Bloom blocks, reference bbf.h:6
BFC_BLK_MASK = (1 << BFC_BLK_SHIFT) - 1


@dataclasses.dataclass
class Opts:
    """Engine options; field-for-field parity with the reference bfc_opt_t."""

    chunk_size: int = 100_000_000
    n_threads: int = 1          # retained for CLI parity; batching replaces threads
    no_mt_io: bool = False
    q: int = 20                 # base-quality threshold for "high quality"
    k: int = 33

    filter_mode: bool = False   # -1: trim/drop reads with unique k-mers
    refine_ec: bool = False     # -R
    no_qual: bool = False       # -Q: force FASTA output
    min_frac: float = 0.9       # trim-mode survival fraction

    l_pre: int = 20             # 2^l_pre hash-table shards
    bf_shift: int = 33          # Bloom filter = 2^bf_shift bits
    n_hashes: int = 4

    discard: bool = False       # -D
    max_end_ext: int = 5
    win_multi_ec: int = 10
    min_cov: int = 3

    # search penalty weights (not CLI-settable in the reference either)
    w_ec: int = 1
    w_ec_high: int = 7
    w_absent: int = 3
    w_absent_high: int = 1
    max_path_diff: int = 15
    max_heap: int = 100

    # --- device execution knobs (no reference counterpart) ---
    batch_reads: int = 8192     # reads corrected in lockstep per device step
    verbose: int = 3
    genome_size: int = 0        # approximate genome size when -s was given
                                # (enables table-size prediction so the
                                # correction programs compile DURING the
                                # counting stream - the cold-start story)

    def apply_genome_size(self, size: int) -> None:
        """Auto-derive k and bf_shift from an approximate genome size.

        Same formula as the reference (bfc.c:42-53): k is
        ceil(log2(size))+1 rounded up to odd, bf_shift is log2(size)+8.
        """
        bits = math.log(size) / math.log(2)
        self.k = int(bits + 1.0)
        if self.k % 2 == 0:
            self.k += 1
        self.k = min(self.k, BFC_MAX_KMER)
        self.bf_shift = min(int(bits + 8.0), BFC_MAX_BF_SHIFT)
        self.genome_size = int(size)

    def predicted_c_bits(self) -> int:
        """Cuckoo-table size prediction from the genome size (0 = none).

        Kept distinct k-mers run ~1-1.5x the genome size (genomic k-mers
        plus recurring error k-mers), and the cuckoo build wants load
        <= 0.4, so 4x headroom makes the prediction an upper bound in
        practice.  Predicting the table size makes the search jit's
        static shape known BEFORE counting finishes - the cold-start
        prewarm compiles the correction programs during the stream."""
        if not self.genome_size:
            return 0
        return max(8, math.ceil(math.log2(self.genome_size * 4 + 1)))

    def effective_l_pre(self) -> int:
        """Shard-count clamp so the in-bucket key fits 50 bits.

        Mirrors the clamps in bfc_ch_init (htab.c:24-26).
        """
        l_pre = self.l_pre
        if self.k * 2 - l_pre > BFC_CH_KEYBITS:
            l_pre = self.k * 2 - BFC_CH_KEYBITS
        if l_pre > BFC_CH_MAXPRE:
            l_pre = BFC_CH_MAXPRE
        assert self.k - l_pre < BFC_CH_KEYBITS
        return l_pre
