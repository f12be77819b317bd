"""Port of the submodular problem configs of `src/repro/configs/`."""
