"""Optimizers of the training path: AdamW, the LR schedules and one-bit
gradient compression with error feedback."""
