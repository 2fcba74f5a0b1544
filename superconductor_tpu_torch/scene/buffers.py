"""Growable host arrays and range suballocation (the port's copy of
``superconductor_tpu/scene/buffers.py``, host side only).

  * ``GrowableArray``: append/insert-able numpy array with doubling
    growth; ``.host`` holds the content at full capacity.
  * ``RangeAllocator`` + ``AllocatedArray``: models allocate contiguous
    vertex/index ranges out of shared mega-buffers and free them on unload.

The reference also keeps a lazily uploaded jax array per buffer
(``device()``); the port builds its torch tensors from ``.host`` in
``scene/upload.py`` instead.
"""

from __future__ import annotations

import bisect
import logging
from typing import List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)


def _next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


class GrowableArray:
    """Append/insert-able array with doubling growth."""

    def __init__(self, shape_tail: Tuple[int, ...], dtype, initial_capacity: int = 1024):
        self.shape_tail = tuple(shape_tail)
        self.dtype = np.dtype(dtype)
        self.capacity = _next_pow2(initial_capacity)
        self.host = np.zeros((self.capacity, *self.shape_tail), dtype=self.dtype)
        self.length = 0

    def _ensure(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = _next_pow2(needed)
        log.info("growing buffer %s -> %s (%s)", self.capacity, new_cap, self.dtype)
        new_host = np.zeros((new_cap, *self.shape_tail), dtype=self.dtype)
        new_host[: self.length] = self.host[: self.length]
        self.host = new_host
        self.capacity = new_cap

    def push(self, rows: np.ndarray) -> int:
        """Append rows; returns the start offset."""
        rows = np.asarray(rows, dtype=self.dtype)
        if rows.ndim == len(self.shape_tail):
            rows = rows[None]
        start = self.length
        self._ensure(start + len(rows))
        self.host[start : start + len(rows)] = rows
        self.length = start + len(rows)
        return start

    def write(self, offset: int, rows: np.ndarray) -> None:
        rows = np.asarray(rows, dtype=self.dtype)
        self._ensure(offset + len(rows))
        self.host[offset : offset + len(rows)] = rows
        self.length = max(self.length, offset + len(rows))

    def clear(self) -> None:
        self.length = 0

    def __len__(self) -> int:
        return self.length


class RangeAllocator:
    """First-fit free-list range allocator (the reference forks gfx's
    range-alloc crate for the same job, renderer-core/Cargo.toml:25)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.free: List[Tuple[int, int]] = [(0, capacity)]  # (start, end)

    def allocate(self, size: int) -> Optional[int]:
        for i, (start, end) in enumerate(self.free):
            if end - start >= size:
                if end - start == size:
                    self.free.pop(i)
                else:
                    self.free[i] = (start + size, end)
                return start
        return None

    def grow(self, new_capacity: int) -> None:
        assert new_capacity >= self.capacity
        if self.free and self.free[-1][1] == self.capacity:
            s, _ = self.free[-1]
            self.free[-1] = (s, new_capacity)
        else:
            self.free.append((self.capacity, new_capacity))
        self.capacity = new_capacity

    def deallocate(self, start: int, size: int) -> None:
        end = start + size
        i = bisect.bisect_left(self.free, (start, end))
        # merge with neighbors
        if i > 0 and self.free[i - 1][1] == start:
            start = self.free[i - 1][0]
            self.free.pop(i - 1)
            i -= 1
        if i < len(self.free) and self.free[i][0] == end:
            end = self.free[i][1]
            self.free.pop(i)
        self.free.insert(i, (start, end))

    def used(self) -> int:
        return self.capacity - sum(e - s for s, e in self.free)


class AllocatedArray:
    """GrowableArray + RangeAllocator: contiguous range alloc with growth.

    ``insert`` returns the range start; on exhaustion the backing array
    doubles (allocate-new + copy, same policy as AllocatedBuffer::insert,
    buffers.rs:150-209).
    """

    def __init__(self, shape_tail: Tuple[int, ...], dtype, initial_capacity: int = 1024):
        self.array = GrowableArray(shape_tail, dtype, initial_capacity)
        self.alloc = RangeAllocator(self.array.capacity)

    def _allocate(self, n: int) -> int:
        start = self.alloc.allocate(n)
        while start is None:
            new_cap = _next_pow2(max(self.array.capacity * 2, n))
            self.array._ensure(new_cap)
            self.alloc.grow(new_cap)
            start = self.alloc.allocate(n)
        return start

    def insert(self, rows: np.ndarray) -> int:
        rows = np.asarray(rows, dtype=self.array.dtype)
        start = self._allocate(len(rows))
        self.array.write(start, rows)
        return start

    def insert_zeros(self, n: int) -> int:
        """Allocate a range without writing content (content is undefined
        until written — callers hide it, e.g. via TexturePool mip views)."""
        start = self._allocate(n)
        self.array.length = max(self.array.length, start + n)
        return start

    def remove(self, start: int, size: int) -> None:
        self.alloc.deallocate(start, size)

    @property
    def host(self) -> np.ndarray:
        return self.array.host

    @property
    def capacity(self) -> int:
        return self.array.capacity
