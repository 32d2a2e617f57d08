"""Batched Go rules engine and board symmetries on tensors."""
