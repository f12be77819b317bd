"""Port of `src/repro/data/`: the synthetic datasets (`synthetic.py`), the
coreset selection (`selection.py`) and the token batches (`pipeline.py`)."""
