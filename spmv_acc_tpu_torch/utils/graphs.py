"""Chained loops as captured CUDA graphs: the port's counterpart of ``jit``
over ``lax.fori_loop`` / ``lax.while_loop``.

The JAX package compiles its hot loops (the bench's SpMV and SpMM chains,
``time_device_loop``, CG's ``while_loop``) into one device program, so the
host issues one call for any number of iterations.  Eager PyTorch issues every
launch of every iteration from the host; on the card :class:`Loop` captures
``UNROLL`` chained steps of ``carry = step(carry)`` once as a CUDA graph and
runs ``n`` steps as ``n // UNROLL`` replays of it, plus one replay of a graph
of each power of two in the remainder.  A graph is captured where its size is
first needed: the warm-up that capture asks for runs those steps for real, and
the capture records them without running them.  On the CPU the same ``step``
runs eagerly, step by step: the tests hold the logic the card replays.

Rules the step keeps, as a ``jit``'d body does: no host read of a device value
(``.item()``, ``bool(t)``, ``.cpu()``) and no Python decision on one, and every
kernel library built and every lazy cache filled by the warm-up (the step runs
once on the capture's side stream before capture, as PyTorch's documentation
asks).  A step that breaks them makes capture raise; nothing falls back to the
eager loop.

Steps with collectives (the distributed CG's blocks, the weak-scaling step):
NCCL's kernels are recorded in the graph like any other launch, and a replay
meets the peers' replays inside them, so every rank of the group builds its
loop and advances it by the same counts in the same order; the warm-up, run
for real on every rank before capture, makes the communicators a step uses
(a point-to-point pair's at its first send and receive).  Such a loop (or a
``models.cg.CGBlocks``) is freed before its process group is destroyed
(``parallel.multihost.shutdown_distributed`` frees what only reference
cycles keep): on four H100s, three runs whose graphs with NCCL collectives
were still alive did not return from their last collective or from
``destroy_process_group`` (PERF.md).

Launch counters: capture records the launches of a step without running
them, so the counters' growth during capture is taken back and added again at
every replay (``_Graph.replay``): a counter counts what ran, warm-ups
included, one step's launches for each step.

Capture calls ``CUDAGraph.capture_begin`` directly, not through
``torch.cuda.graph``, whose entry synchronizes the device and empties the
caching allocator (every cached block returned to CUDA, to be allocated
anew afterwards).
"""

from __future__ import annotations

import collections
import gc

import torch

__all__ = ["UNROLL", "CAPTURE_MODE", "Loop", "launch_counters"]

# Steps in one captured graph of a chain.  Replaying a graph costs the host
# one launch however many steps it holds, and the card runs its kernels back
# to back; a longer graph costs more capture time and more nodes but the
# replays are then rarer.  On the H100 (scripts/torch_probe_graphs.py tune,
# PERF.md) 4 to 256 steps gave the same µs an iteration within 3 % on
# rajat03, TSOPF_RS_b2383 and boneS10; 64 keeps a 65,536-step bench loop at
# 1,024 replays for 0.02-0.05 s of capture.
UNROLL = 64

# The capture mode.  In torch's default ("global") a capture forbids every
# other thread of the process the CUDA calls that could disturb it, and such a
# call from another thread invalidates the capture.  ProcessGroupNCCL's
# watchdog thread polls the CUDA events of the collectives issued before (a
# distributed loop's warm-up among them) while a capture runs.  On an H100
# with torch 2.11 and NCCL 2.28 none of 40 global captures after eager
# collectives failed (scripts/torch_probe_dist.py --capture-modes, PERF.md),
# but a collision is a race: "thread_local" restricts only the capturing
# thread, which makes every call of a step, and rules it out.
CAPTURE_MODE = "thread_local"


def launch_counters() -> list:
    """The kernels' launch counters (``LAUNCHES`` of every module with a
    kernel wrapper)."""
    from ..ops import adaptive_plus, cg_update, feedback, swell, trisolve, vector_row

    return [swell.LAUNCHES, adaptive_plus.LAUNCHES, vector_row.LAUNCHES, feedback.LAUNCHES,
            cg_update.LAUNCHES, trisolve.LAUNCHES]


def _snapshot() -> list:
    return [collections.Counter(c) for c in launch_counters()]


class _Graph:
    """One CUDA graph of ``body()``: run once for real (the warm-up) and
    captured on ``stream``, in the memory pool ``pool`` (None: a new one)."""

    def __init__(self, body, stream, pool=None):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            body()  # warm-up: builds the libraries, fills caches, runs for real
            before = _snapshot()
            self.graph = torch.cuda.CUDAGraph()
            # no garbage collection inside the capture: freeing a tensor there
            # may need a CUDA call that invalidates it
            gc.disable()
            try:
                self.graph.capture_begin(pool=pool, capture_error_mode=CAPTURE_MODE)
                try:
                    body()
                finally:
                    self.graph.capture_end()
            finally:
                gc.enable()
        torch.cuda.current_stream().wait_stream(stream)
        self.delta = []
        for counter, old in zip(launch_counters(), before):
            grown = collections.Counter({k: v - old.get(k, 0) for k, v in counter.items()
                                         if v != old.get(k, 0)})
            counter.clear()
            counter.update(old)  # capture launched nothing
            self.delta.append(grown)

    def replay(self) -> None:
        self.graph.replay()
        for counter, grown in zip(launch_counters(), self.delta):
            counter.update(grown)


def _tensors(carry) -> tuple:
    return carry if isinstance(carry, tuple) else (carry,)


class Loop:
    """``carry = step(carry)`` chained ``n`` steps at a time; ``carry`` is a
    tensor or a tuple of tensors on one device.

    On a CUDA device the carry lives in static buffers, and steps run as
    replays of graphs of ``unroll`` and of powers of two below it,
    each ending in a copy of the last carry into the buffers; ``step`` may
    update its carry in place.  The graphs share one memory pool, which holds
    what one graph allocates; the loop owns the buffers and the graphs, so
    whatever the step closes over (layouts, plans) stays alive with it.  On
    the CPU ``step`` runs eagerly.  Where a graph size is first needed its
    steps run eagerly (the capture's warm-up) and the graph is captured for
    the later ones.  A step that issues ``torch.distributed`` collectives
    needs every rank of their group to build its loop and advance it by the
    same counts in the same order (the module docstring)."""

    def __init__(self, step, init, unroll: int = UNROLL):
        if unroll < 1:
            raise ValueError(f"unroll must be at least 1, got {unroll}")
        self.step = step
        self.unroll = unroll
        self.tuple = isinstance(init, tuple)
        first = _tensors(init)[0]
        self.cuda = first.device.type == "cuda"
        self._buf = tuple(t.clone() for t in _tensors(init))
        self._graphs: dict = {}
        self._stream = torch.cuda.Stream(first.device) if self.cuda else None
        self._pool = None

    @property
    def carry(self):
        """The current carry: the loop's own buffers (copy before keeping)."""
        return self._buf if self.tuple else self._buf[0]

    def load(self, init) -> None:
        """Set the carry to ``init`` (copied)."""
        for b, t in zip(self._buf, _tensors(init)):
            b.copy_(t)

    def _steps(self, k: int) -> None:
        c = self.carry
        for _ in range(k):
            c = self.step(c)
        for b, t in zip(self._buf, _tensors(c)):
            if t is not b:
                b.copy_(t)

    def _replay(self, k: int) -> None:
        """``k`` steps: a replay of the graph of ``k``, or its capture."""
        g = self._graphs.get(k)
        if g is not None:
            g.replay()
            return
        g = _Graph(lambda: self._steps(k), self._stream, self._pool)
        if self._pool is None:
            self._pool = g.graph.pool()
        self._graphs[k] = g

    def advance(self, n: int) -> None:
        """Run ``n`` more steps on the carry."""
        if not self.cuda:
            self._steps(n)
            return
        for _ in range(n // self.unroll):
            self._replay(self.unroll)
        rem = n % self.unroll
        k = 1 << rem.bit_length() >> 1
        while k:
            if rem & k:
                self._replay(k)
            k >>= 1

    def run(self, init, n: int):
        """``n`` steps from ``init``: fresh tensors (``init`` is left alone)."""
        self.load(init)
        self.advance(n)
        out = tuple(b.clone() for b in self._buf)
        return out if self.tuple else out[0]
