"""The plain reference of the configurations the benchmark runs: float32
PyTorch that imports nothing of the program under test."""
