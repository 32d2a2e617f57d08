"""Model configurations, blocks, heads and the full network."""
