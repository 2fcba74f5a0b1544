"""Present queue: the swapchain frames-in-flight pattern on a CUDA device
(the port's copy of ``superconductor_tpu/render/present.py``).

The reference presents through a real swapchain whose frame queue lets
the CPU record frame n+1 while the GPU renders frame n (wgpu's
desired_maximum_frame_latency, default 2). The port has no swapchain,
but CUDA launches are asynchronous, so the same overlap falls out of
NOT waiting for a frame's output until `depth` newer frames have been
submitted: host draw-build of the next frames proceeds while the device
works through the queue.

Latency accounting is honest: a frame's latency is measured from its
submit() call to the moment its buffer is known ready -- queue wait is
included, exactly what a user would feel between input and photon.

The barrier: ``block_sync`` waits on a CUDA event recorded on the
current stream when the frame was submitted (``mark``), exact on a card
attached to its host. It returns at once for CPU tensors, which are
ready when they exist.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Iterator, Optional, Tuple

import torch


def mark(frame) -> Any:
    """The completion handle of a just-submitted frame: a CUDA event
    recorded on the current stream for a CUDA tensor, None otherwise."""
    if isinstance(frame, torch.Tensor) and frame.is_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(frame.device))
        return event
    return None


def block_sync(frame, event=None) -> None:
    """Wait until the frame is rendered: on the event recorded at submit
    (or, without one, on the frame's stream)."""
    if event is not None:
        event.synchronize()
    elif isinstance(frame, torch.Tensor) and frame.is_cuda:
        torch.cuda.current_stream(frame.device).synchronize()


class PresentQueue:
    """Bounded queue of in-flight frames.

    submit(frame) enqueues a device buffer stamped with the current
    time and its completion event (``mark``); once more than `depth - 1`
    frames are queued, the oldest is waited on (via `sync`, block_sync;
    tests pass their own barrier) and its submit->ready latency in
    seconds is returned (None while filling).
    drain() syncs out the remainder, e.g. before a readback or at the end
    of a timed run. `sync(frame, event)` gets the frame and its mark().
    """

    def __init__(self, depth: int = 2, clock=time.time, sync=block_sync):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = depth
        self._clock = clock
        self._sync = sync
        self._inflight: deque[Tuple[float, Any, Any]] = deque()

    def __len__(self) -> int:
        return len(self._inflight)

    def submit(self, frame: Any, t_start: Optional[float] = None) -> Optional[float]:
        """t_start: override the latency-clock start for this frame, e.g.
        stamped before input handling so the reported latency is full
        input-to-photon rather than submit-to-ready."""
        self._inflight.append((self._clock() if t_start is None else t_start,
                               frame, mark(frame)))
        if len(self._inflight) < self.depth:
            return None
        t_sub, done, event = self._inflight.popleft()
        self._sync(done, event)
        return self._clock() - t_sub

    def drain(self) -> Iterator[float]:
        while self._inflight:
            t_sub, done, event = self._inflight.popleft()
            self._sync(done, event)
            yield self._clock() - t_sub
