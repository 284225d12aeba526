"""Strategies: the swell kernel wrapper, its plan, and plain PyTorch strategies."""
