"""The general machinery of the benchmark: finding a cell's files by
name, seeds, the timed window's trace, and the result line."""
