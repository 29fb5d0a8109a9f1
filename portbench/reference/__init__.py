"""The plain reference: plain PyTorch in float32, no part of the program."""
