"""The benchmark of advancedhmc_torch (see README.md)."""
