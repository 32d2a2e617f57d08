"""Array-of-nodes search tree and batched Gumbel root search."""
