"""Plain PyTorch references: they import nothing of the program."""
