"""Plain PyTorch references the benchmark judges the program by. They
import nothing of the program, and take from it only the outputs they
judge."""
