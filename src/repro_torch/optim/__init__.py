"""Optimizers and gradient transforms: AdamW, Adafactor, int8
error-feedback compression and learning-rate schedules, as plain
functions over dicts of tensors keyed by parameter name.

The reference stacks each superblock's layers along a leading axis, so
its leaf ``blocks.l0_attn_global.attn.wq`` is the (n_super, ...) stack of
every superblock's ``wq``; the port keeps one tensor per layer.  A
statistic over a whole leaf (the global norm's order, Adafactor's update
RMS and parameter scale, the int8 compressor's blocks) spans every
tensor of its group, in superblock order, as if they were stacked.  The
functions take ``leaves``, a group list ``[[name, ...], ...]`` in the
reference's leaf order (:func:`repro_torch.models.convert.leaf_groups`
makes the model's); without it every name is a leaf of its own, in
sorted order, as JAX orders a flat dict.
"""
from repro_torch.optim import adafactor, adamw, compress, schedule

__all__ = ["adamw", "adafactor", "schedule", "compress"]
