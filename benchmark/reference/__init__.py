"""Plain PyTorch references of what the cells compute; nothing of the measured program."""
