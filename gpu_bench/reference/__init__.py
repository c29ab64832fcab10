"""The plain float32 references the benchmark judges the program against.
They import nothing of the program and take only the benchmark's inputs:
the seed's weights, token ids and pixels."""
