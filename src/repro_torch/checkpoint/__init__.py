"""Checkpointing of selection state (answers `src/repro/checkpoint/`)."""
