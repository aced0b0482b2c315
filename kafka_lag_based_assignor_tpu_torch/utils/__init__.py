"""Configuration, device resolution and the rebalance record."""
