"""Learner: train step, optimizers, LR schedules, SWA, validation and checkpoints."""
