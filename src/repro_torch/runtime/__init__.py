"""Port of `src/repro/runtime/flags.py` (typed environment knobs)."""
