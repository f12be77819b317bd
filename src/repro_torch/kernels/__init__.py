"""Port of `src/repro/kernels/`: selection algebra, oracles, planner and
the hand-written CUDA kernels of the main path."""
