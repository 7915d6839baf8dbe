"""What every cell of the benchmark shares: loading the cells, sizing the
grid, the device trace, the peaks and the kernels' work counts."""
