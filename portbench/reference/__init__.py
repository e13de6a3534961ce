"""The plain reference: PyTorch integer ops, nothing of the program."""
