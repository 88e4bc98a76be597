"""Training (the port's counterpart of ``openviic_tpu/training``): the
optimizer and schedule, the XE, SCST and eval steps, the on-device CIDEr
reward, and the trainer's SCST pieces.  Checkpoints and the trainer
lifecycle are not ported yet."""
