"""The plain reference that decides `correct`: plain PyTorch and numpy, no
import of the program."""
