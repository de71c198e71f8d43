"""Workload tracing: PBS and keyswitch counters, timed spans, profiler
timelines.

Torch counterpart of ``tfhe_tpu/utils/trace.py`` (the reference's
``PBS_COUNT`` instrumentation, ``tfhe/src/core_crypto/commons/mod.rs``):
every keyswitch and bootstrap that a shortint dispatch site starts records
how many ciphertexts it takes, at the same sites as ``tfhe_tpu``
(``ServerKey.apply_lookup_table``, ``apply_many_lookup_table``,
``keyswitch``), so the same op sequence gives the same counts in both
packages.

Usage::

    from tfhe_tpu_torch.utils import trace
    trace.reset_pbs_count()
    ... run FHE ops ...
    trace.get_pbs_count()      # total ciphertext bootstraps dispatched

    with trace.span("fheuint64_mul") as s:
        ...
    s.pbs, s.ks, s.seconds     # per-span counts + wall time

Spans nest; each span captures the counts while it is open and opens a
``torch.profiler.record_function`` range of its name, so that it shows on
the timeline that ``trace.profile(log_dir)`` writes (``torch.profiler``
over the CPU and, when present, the GPU: a Chrome trace in ``log_dir``).
The wall time of a span is the host clock: synchronize the device inside
the span to time device work.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import List

import torch

_PBS_COUNT = 0
_KS_COUNT = 0


def add_pbs(n: int) -> None:
    global _PBS_COUNT
    _PBS_COUNT += int(n)


def add_ks(n: int) -> None:
    global _KS_COUNT
    _KS_COUNT += int(n)


def get_pbs_count() -> int:
    return _PBS_COUNT


def get_ks_count() -> int:
    return _KS_COUNT


def reset_pbs_count() -> None:
    global _PBS_COUNT, _KS_COUNT
    _PBS_COUNT = 0
    _KS_COUNT = 0


@dataclass
class Span:
    name: str
    pbs: int = 0
    ks: int = 0
    seconds: float = 0.0
    children: List["Span"] = field(default_factory=list)

    def report(self, indent: int = 0) -> str:
        lines = [
            "%s%s: %d PBS, %d KS, %.3fs"
            % ("  " * indent, self.name, self.pbs, self.ks, self.seconds)
        ]
        for c in self.children:
            lines.append(c.report(indent + 1))
        return "\n".join(lines)


_SPAN_STACK: List[Span] = []


@contextlib.contextmanager
def span(name: str):
    """Record PBS/KS counts and wall time for a block; nests."""
    s = Span(name)
    if _SPAN_STACK:
        _SPAN_STACK[-1].children.append(s)
    _SPAN_STACK.append(s)
    pbs0, ks0, t0 = _PBS_COUNT, _KS_COUNT, time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield s
    finally:
        s.pbs = _PBS_COUNT - pbs0
        s.ks = _KS_COUNT - ks0
        s.seconds = time.perf_counter() - t0
        _SPAN_STACK.pop()


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile(log_dir: str):
    """``torch.profiler`` over the block, CPU and (when present) CUDA
    activities; the Chrome trace lands in ``log_dir/trace.json``. Yields
    the profiler, whose ``events()`` / ``key_averages()`` the caller may
    read after the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
