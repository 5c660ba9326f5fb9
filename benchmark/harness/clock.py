"""Marks on the device's timeline and the spans the benchmark records
around the program's calls.

On a card a mark is a CUDA event recorded on the current stream, so the
time between two marks is device time, and nothing waits for the device
until the window has closed. On the CPU, which only the tests use, a mark
is the host clock."""
from __future__ import annotations

import time
from collections import defaultdict

import torch


class Clock:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def wait(self, mark) -> None:
        """Block the host until the device has passed ``mark``."""
        if self.cuda:
            mark.synchronize()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def ms(self, a, b) -> float:
        """Milliseconds from mark ``a`` to mark ``b`` (both passed)."""
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


class Spans:
    """Named (start, end) marks around calls; recorded only while ``on``."""

    def __init__(self, clock: Clock):
        self.clock = clock
        self.on = False
        self.marks = defaultdict(list)

    def wrap(self, name: str, fn):
        def spanned(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            start = self.clock.mark()
            out = fn(*args, **kwargs)
            self.marks[name].append((start, self.clock.mark()))
            return out

        return spanned

    def ms(self, name: str) -> list:
        """Each recorded span's milliseconds (after the device has passed them)."""
        return [self.clock.ms(a, b) for a, b in self.marks.get(name, ())]
