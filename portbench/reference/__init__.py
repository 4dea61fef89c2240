"""The plain reference the benchmark judges the port by: NumPy and
hashlib only, frozen here so that a change to the program cannot move the
yardstick. It imports nothing of the port."""
