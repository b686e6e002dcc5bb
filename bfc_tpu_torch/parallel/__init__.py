"""The multi-device path: one process per rank over torch.distributed."""
