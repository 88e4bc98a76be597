"""Training (the port's counterpart of ``openviic_tpu/training``): the
optimizer and schedule, the XE, SCST and eval steps, the on-device CIDEr
reward, checkpoints, and the trainers (``viTrainer``, ``enTrainer``: XE,
patience, the switch to SCST, resume, test predictions)."""
