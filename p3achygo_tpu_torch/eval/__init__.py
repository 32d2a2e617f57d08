"""Cur-vs-cand evaluation + Elo gating."""
