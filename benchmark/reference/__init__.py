"""The plain reference the benchmark judges the program against: exact
point-triangle distances by brute force over every triangle and the sign
by the generalized winding number, in plain PyTorch, in blocks. It imports
nothing of the program and takes nothing the program made."""
