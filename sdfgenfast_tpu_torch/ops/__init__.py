"""Host binning, parity transport and the kernel wrappers with their plain twins."""
