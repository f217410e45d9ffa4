"""Training (counterpart of exavatar_release_tpu/train): the loss and its
gradients of one frame; the optimizer update, densification and checkpoints
wait for the next slice."""
