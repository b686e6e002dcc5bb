"""The check's control: the reference put in the program's place with
one guarantee broken, judged as a run's jobs are judged.

The configurations guarantee bfc's exact, sequential counts: a k-mer's
first occurrence enters the table (or, under -1, the second filter) only
where every bit it probes was already set.  The control drops that
rule's false positives (every first occurrence a miss), the step a
faster counter would be tempted by, and must come out not correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

runs on the card, at the cell's own size, and prints one JSON line a
seed with the control's numbers beside their limits.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(HERE))


def control(cat, workload: str, seed: int, device: str) -> dict:
    """The control's numbers and whether they pass, for one seed."""
    from portbench import check, gen, options

    cell = cat.cell(workload)
    cfg = cat.config(cell["config"])
    mix = cat.traffic(cell["traffic"])
    reads = gen.make_reads(cfg["genome"], mix, seed)
    sample = gen.sample_ids(reads.lens, int(mix["check_reads"]), seed)
    opt = options.reference_opts(cfg["flags"])
    want = check.expected(reads, opt, sample, device)
    got = check.expected(reads, opt, sample, device, drop_bloom=True)
    job = {"digest": got.digest, "records": got.records,
           "sampled": got.sampled, "malformed": None,
           "answer": got.table if got.table is not None
           else got.words.cpu().numpy()}
    nums = check.judge([job], want)
    return {"workload": workload, "seed": seed, "correct": check.passed(nums),
            "check": {k: {"value": v, "limit": check.LIMITS[k]}
                      for k, v in nums.items()},
            "reference": want.info, "control": got.info}


def main(argv=None) -> int:
    from portbench.catalog import Catalog

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("control: no CUDA device\n")
        return 2
    cat = Catalog()
    for s in args.seeds.split(","):
        print(json.dumps(control(cat, args.workload, int(s), "cuda")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
