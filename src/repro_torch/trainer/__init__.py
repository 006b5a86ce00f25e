"""Training: schedule, AdamW, checkpoints and the train step (port of
``repro.trainer``)."""
