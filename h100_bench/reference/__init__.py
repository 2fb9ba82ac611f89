"""The benchmark's plain reference: PyTorch and NumPy only, nothing of the
program under test."""
