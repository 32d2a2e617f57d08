"""Replay buffer and replay batch -> model inputs + targets."""
