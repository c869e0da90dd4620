"""The plain reference: a frozen copy of the scalar EraVM oracle in C++
(oracle.py builds and binds it) and the engine's state fields worked out
from its run (expected.py).  Nothing here imports the program."""
