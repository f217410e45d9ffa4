"""Training (counterpart of exavatar_release_tpu/train): the train step, the
optimizer with named groups, densification cadence, the capacity governor
and checkpoints."""
