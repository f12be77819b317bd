"""Port of `src/repro/data/synthetic.py`."""
