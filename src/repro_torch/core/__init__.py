"""Port of `src/repro/core/`: objectives, greedy, accumulation tree."""
