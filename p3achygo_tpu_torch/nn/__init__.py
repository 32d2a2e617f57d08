"""Serving forward: BN folded into producer convolutions, heads pruned."""
