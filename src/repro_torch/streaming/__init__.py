"""Streaming submodular selection in PyTorch (answers `src/repro/streaming/`):
sieve-streaming leaves, sliding windows, and the continuous mode on one
device. The mesh driver (`stream_select_distributed`) is not ported
(ROADMAP item 3)."""
from repro_torch.streaming.sieve import SieveState, SieveStreamer, num_levels
from repro_torch.streaming.window import SlidingSieve, WindowState
from repro_torch.streaming.driver import (ContinuousSelector, stream_select,
                                          stream_select_continuous)

__all__ = ["ContinuousSelector", "SieveState", "SieveStreamer",
           "num_levels", "SlidingSieve", "WindowState", "stream_select",
           "stream_select_continuous"]
