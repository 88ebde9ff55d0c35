"""Deterministic synthetic token batches (numpy, so the same seed gives the
reference's prompts)."""
from repro_torch.data.synthetic import DataConfig, batch_iterator, host_batch

__all__ = ["DataConfig", "batch_iterator", "host_batch"]
