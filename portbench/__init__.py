"""The benchmark of bfc_tpu_torch (the PyTorch and CUDA port): whole
count-and-correct and count-and-trim jobs on one card, driven by the
data files beside this one.  run.py runs one cell once."""
