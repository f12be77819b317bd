"""Streaming submodular selection in PyTorch (answers `src/repro/streaming/`):
sieve-streaming leaves, sliding windows, and the continuous mode on one
device or over the ranks of a process group (`stream_select_distributed`)."""
from repro_torch.streaming.sieve import SieveState, SieveStreamer, num_levels
from repro_torch.streaming.window import SlidingSieve, WindowState
from repro_torch.streaming.driver import (ContinuousSelector, stream_select,
                                          stream_select_continuous,
                                          stream_select_distributed)

__all__ = ["ContinuousSelector", "SieveState", "SieveStreamer",
           "num_levels", "SlidingSieve", "WindowState", "stream_select",
           "stream_select_continuous", "stream_select_distributed"]
