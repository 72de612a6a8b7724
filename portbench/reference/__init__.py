"""Plain float64 references of the benchmark's configurations.

They work out the GLL basis, the grids, the operators and the discrete
residuals again from a configuration file, with NumPy and plain PyTorch,
and import nothing of the program under test.
"""
