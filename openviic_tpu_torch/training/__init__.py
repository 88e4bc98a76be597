"""Training: the XE half of ``openviic_tpu/training`` (optimizer, schedule,
losses and the XE / eval steps).  SCST, the device reward, checkpoints and
the trainer lifecycle are not ported yet."""
