"""The plain reference: the recipe's layers in plain PyTorch and NumPy,
written from the reference repository's equations. It imports nothing of
the program and takes nothing the program made: the benchmark hands it the
same weights, frames and draws it hands the program."""
