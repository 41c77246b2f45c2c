"""Plain float32 PyTorch references that decide ``correct``.  Nothing here
imports the program."""
