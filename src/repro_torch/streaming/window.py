"""Sliding-window sieve summaries — the best k of the last W arrivals
(answers `src/repro/streaming/window.py`).

A single sieve never forgets. For recency-bounded summaries we keep S + 1
checkpointed sieves with starts staggered every s = W/S arrivals: at
each stride boundary the oldest checkpoint is reset to a fresh empty
sieve, so the checkpoint ages are ≈ {0, s, 2s, …, W}. Queries answer
from the oldest checkpoint whose age is ≤ W: it holds ONLY elements of
the last W arrivals and covers at least W − s of them.

The S + 1 states are one stacked SieveState (leading axis = checkpoint
slot), so a batch is ONE stream-filter launch for every checkpoint and
level (the reference vmaps the same call). The ages follow from the
batch sizes alone, so they live on the host: a roll is a slot overwrite
on the card that needs no device sync.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.greedy import Solution
from repro_torch.streaming.sieve import SieveState, SieveStreamer


@dataclasses.dataclass
class WindowState:
    states: SieveState     # stacked, leading axis = S + 1 checkpoint slots
    ages: np.ndarray       # (S + 1,) int arrivals seen by each checkpoint
    seen: int              # total arrivals seen


class SlidingSieve:
    """Window of the last ``window`` arrivals, checkpointed every
    ``stride`` (window % stride == 0; batches must divide the stride so
    rolls land on batch boundaries)."""

    def __init__(self, streamer: SieveStreamer, window: int, stride: int):
        if window % stride:
            raise ValueError(f"window {window} is no multiple of the "
                             f"stride {stride}")
        self.streamer = streamer
        self.window = int(window)
        self.stride = int(stride)
        self.n_ckpt = window // stride + 1

    def init(self) -> WindowState:
        return WindowState(self.streamer.init(lanes=self.n_ckpt),
                           np.zeros(self.n_ckpt, np.int64), 0)

    def process_batch(self, wstate: WindowState, ids, payloads, valid
                      ) -> WindowState:
        """Advance every checkpoint by one batch (one launch), then roll
        — reset the oldest slot to a fresh empty sieve — on stride
        boundaries. The state handed in is consumed."""
        nb = int(ids.shape[0])
        if self.stride % nb:
            raise ValueError(f"batch {nb} must divide the stride "
                             f"{self.stride}")
        states = self.streamer.process_batch(wstate.states, ids, payloads,
                                             valid)
        ages = wstate.ages + nb
        seen = wstate.seen + nb
        if seen % self.stride == 0:
            oldest = int(np.argmax(ages))
            # a fresh slot re-anchors from its own future arrivals
            fresh = self.streamer.init()
            for f in dataclasses.fields(SieveState):
                dst = getattr(states, f.name)
                if dst is not None:
                    dst[oldest] = getattr(fresh, f.name)
            ages[oldest] = 0
        return WindowState(states, ages, seen)

    def query(self, wstate: WindowState) -> Solution:
        """Best summary of (at most) the last ``window`` arrivals: the
        oldest checkpoint with age ≤ window — it holds no expired
        element."""
        ages = wstate.ages
        eligible = np.nonzero(ages <= self.window)[0]
        slot = int(eligible[np.argmax(ages[eligible])])
        return self.streamer.solution(wstate.states.map(lambda x: x[slot]))
