"""Lockstep self-play step and move-selection signals."""
