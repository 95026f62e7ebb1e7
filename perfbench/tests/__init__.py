"""CPU tests of the benchmark harness; `card` tests need an H100."""
