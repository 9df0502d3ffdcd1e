"""Plain PyTorch references of the benchmark's configurations. They import
nothing of the measured program and take nothing it made: the benchmark
hands them the same weights and inputs it hands the program."""
