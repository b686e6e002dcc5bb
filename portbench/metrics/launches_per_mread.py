"""launches_per_mread: kernel launches of the program's own kernels
(bfc_tpu_torch.kernels.KERNELS[*].launches, counted over each job) per
million input reads of the window."""


def read(w, tally):
    if not w.reads:
        return None
    return sum(j["launches"] for j in w.jobs) * 1e6 / w.reads
