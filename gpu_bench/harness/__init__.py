"""The benchmark's harness: the cells' drivers, weights from the seed,
spans on the program's instances, the trace's reduction and the checks."""
