"""Data parallelism and ZeRO-1 over torch.distributed (counterpart of
merlot_tpu/parallel/)."""
