"""Utilities: solution I/O, checkpoints (npz and torch.distributed.checkpoint),
profiling and plotting."""
