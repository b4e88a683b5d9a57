"""Plain PyTorch and NumPy references of what the benchmark compares:
they import nothing of the program and take nothing it made."""
