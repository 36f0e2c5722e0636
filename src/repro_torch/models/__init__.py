"""Model library (dense transformer) in PyTorch."""
