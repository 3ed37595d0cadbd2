"""The port's kernel-level benchmarks: ``kernel_bench`` and ``e2e_detector``."""
