"""Optimizers: AdamW, PowerSGD gradient compression, LR schedules."""
