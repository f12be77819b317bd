"""PyTorch + CUDA port of the GreedyML selection system (`src/repro/`).

Laid out module for module like the JAX package; each module names the
reference file it answers to. The package imports torch and never jax or
`repro`. Entry points run on the CUDA device unless the caller passes
``device="cpu"``; the kernels behind them are hand-written CUDA C++ for
Hopper (`csrc/`), and a wrapper takes its plain PyTorch version only
when the tensor it was given lies on the CPU.
"""
