"""Captured decode programs: a chunk of decode steps recorded once as a CUDA
graph and replayed.

The JAX package compiles its decode loops under ``jax.jit`` (greedy's
``lax.while_loop``, the slot engine's chunk ``fori_loop``) and has no file
of this name: this module carries what ``jit`` gives it. A chunk body reads
and writes only static device buffers (the token buffer, ``pos``, the
caches, the cross-K/V, the finished flags and the summed logprob), in
place, and reads nothing back to the host, so one capture of it holds for
every later chunk of every later call: the first call runs the body once
for real on a side stream (the warm-up: every kernel instantiation, every
first-call host copy such as a logit rule's mask, every cuBLAS workspace),
then captures it with ``torch.cuda.graph``; each later chunk is one
``CUDAGraph.replay``.

A capture launches nothing, so the kernels' launch counts
(``ops/_build.py``'s ``CudaKernel.launches``) are put back to where they
stood before it, and each replay adds the launches the capture recorded:
the counts read as those of the same body run eagerly. A capture or replay
that fails raises; nothing falls back to the eager body on the card.

Sampling above temperature 0 is captured only where this PyTorch can
register a generator with a graph (``CUDAGraph.register_generator_state``);
elsewhere that program keeps the eager body (``sampling_capturable``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch


def port_kernels() -> list:
    """Every ``CudaKernel`` of the port: the ones a chunk can launch."""
    from yoho_tpu_torch.ops import decode_attention, flash_attention, mel_kernel, w8a8_dense

    return [mel_kernel.KERNEL, flash_attention.KERNEL, *decode_attention.KERNELS,
            w8a8_dense.KERNEL]


def sampling_capturable() -> bool:
    """Whether a ``torch.Generator`` can be captured into a graph here."""
    return hasattr(torch.cuda.CUDAGraph, "register_generator_state")


class ChunkGraph:
    """One chunk body, captured once and replayed.

    ``body()`` runs one chunk in place (``infer/decode.py``'s greedy chunk,
    ``infer/slot_engine.py``'s slot chunk); it may be set after
    construction, before the first call. ``state`` is whatever its caller
    keeps with it. The first call runs the body on a side stream
    and captures it; every later call replays. ``pool`` is a graph memory
    pool shared with the other graphs of the same buffers
    (``torch.cuda.graph_pool_handle()``); ``generator`` a generator the
    body draws from, registered with the graph. Fields read by the
    measurements: ``captures``, ``replays``, ``capture_s`` (warm-up
    excluded), ``pool_bytes`` (the memory the capture reserved: the graph's
    intermediates, held between replays) and ``deltas`` (launches per
    replay, by kernel name)."""

    def __init__(self, body: Optional[Callable[[], None]] = None, state: Any = None,
                 pool=None, generator: Optional[torch.Generator] = None,
                 kernels: Optional[List] = None):
        self.body = body
        self.state = state
        self.pool = pool
        self.generator = generator
        self.kernels = port_kernels() if kernels is None else list(kernels)
        self.graph = None
        self.deltas: Dict[Any, int] = {}
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0

    def __call__(self) -> None:
        if self.graph is None:
            self.warm_and_capture()
        else:
            self.replay()

    # The CUDA surfaces, one method each (a test on the CPU replaces them).
    def _warm_up(self):
        """Runs the body once on a new side stream; returns the stream."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.body()
        torch.cuda.current_stream().wait_stream(side)
        return side

    def _new_graph(self):
        g = torch.cuda.CUDAGraph()
        if self.generator is not None:
            g.register_generator_state(self.generator)
        return g

    def _capturing(self, graph, stream):
        return torch.cuda.graph(graph, pool=self.pool, stream=stream)

    def _reserved(self) -> int:
        return torch.cuda.memory_reserved()

    def warm_and_capture(self) -> None:
        """The first chunk, for real, on a side stream; then its capture."""
        if self.body is None:
            raise RuntimeError("ChunkGraph called before its body was set")
        side = self._warm_up()
        before = [k.launches for k in self.kernels]
        t0 = time.perf_counter()
        graph = self._new_graph()
        try:
            with self._capturing(graph, side):
                # Read inside: entering the capture empties the allocator's
                # cache, so the pool's segments are what grows after this.
                reserved = self._reserved()
                self.body()
        finally:
            # A capture launches nothing: each count goes back to where it
            # stood, and the difference is what one replay launches.
            after = [k.launches for k in self.kernels]
            for k, n in zip(self.kernels, before):
                k.launches = n
        self.deltas = {k: a - n for k, a, n in zip(self.kernels, after, before) if a != n}
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = self._reserved() - reserved
        self.graph = graph
        self.captures += 1

    def replay(self) -> None:
        self.graph.replay()
        for k, n in self.deltas.items():
            k.launches += n
        self.replays += 1

    def launches_per_replay(self) -> Dict[str, int]:
        return {k.name: n for k, n in self.deltas.items()}


@dataclass(eq=False)
class GreedyWorkspace:
    """The static buffers of one transcriber's captured greedy programs at
    one batch size: the greedy state, one graph pool, the cross-K/V (made
    by the first call, then written in place by every later one), the
    self-attention caches (made by the first call once its cross-K/V are
    made, so that the cross-K/V's temporaries never coexist with them),
    and the captured chunk of each program (by temperature and prompt
    length). ``key`` names what the buffers were
    sized for; a program of another key gets a new workspace."""

    key: tuple
    state: Any
    pool: Any
    ckv: Optional[list] = None
    caches: Optional[list] = None
    graphs: Dict[tuple, ChunkGraph] = field(default_factory=dict)

    def pool_bytes(self) -> int:
        return sum(g.pool_bytes for g in self.graphs.values())

    def buffer_bytes(self) -> int:
        from yoho_tpu_torch.infer.slot_engine import _tensors

        tensors = _tensors(self.caches or []) + _tensors(self.ckv or []) + [
            self.state.tokens, self.state.pos, self.state.finished, self.state.sum_lp]
        return sum(t.numel() * t.element_size() for t in tensors)
