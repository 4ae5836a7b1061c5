"""Shared-memory arena: the Agnocast "heap mapped to shared memory".

The paper hooks ``malloc``/``free`` via ``LD_PRELOAD`` and backs the whole
heap with shared memory mapped at an identical virtual address in every
participating process, so a raw pointer is a valid cross-process message
reference.  Python owns its allocator, so we adapt the insight rather than
the mechanism: every allocation made through the publisher API is served
from an ``Arena`` — a POSIX shared-memory segment attached by all
participants — and a cross-process reference is ``(arena, offset, length)``.
Offsets are position-independent, which is the moral equivalent of the
paper's identical-VA mapping (and is immune to ASLR by construction, the
property the paper has to argue for explicitly).

Only the owning (publisher) process allocates and frees — exactly the
paper's rule that deallocation "can only be executed by the publisher
process that initially allocated the message" (§IV-C).  Subscribers attach
read-only: views handed to subscriber code are non-writeable numpy views
(the CPU-tier analogue of the MMU read-only mapping of §IV-A).

The allocator is a real first-fit free-list allocator with coalescing and
in-place-growth ``realloc`` so that *unsized* payloads (``std::vector``
analogue: :class:`repro_torch.core.messages.ArenaVector`) can reallocate at
arbitrary times while every byte they ever own stays inside the shared
mapping — the paper's core requirement #1.

The port's copy of ``repro/core/arena.py``: only the import paths differ.  Layouts,
magic numbers and shm names are the reference's on purpose, so a message
published through one package is taken by the other.
"""

from __future__ import annotations

import secrets
from bisect import insort
from collections import OrderedDict
from dataclasses import dataclass
from multiprocessing import shared_memory

import numpy as np

__all__ = ["Arena", "ArenaAttachCache", "AllocRef", "ArenaError",
           "OutOfArenaMemory"]

_ALIGN = 64  # cacheline alignment, mirrors malloc's practical alignment
_HEADER = 4096  # reserved; offset 0 is kept invalid (NULL analogue)
_MAGIC = 0xA6_0C_A5_7C


class ArenaError(RuntimeError):
    pass


class OutOfArenaMemory(ArenaError):
    """The fixed-size virtual range is exhausted (paper §IV-A assumes a
    sufficiently large fixed heap; we surface exhaustion explicitly)."""


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


@dataclass(frozen=True)
class AllocRef:
    """A cross-process reference to payload bytes: the "pointer"."""

    arena: str
    offset: int
    nbytes: int

    def to_words(self) -> tuple[int, int]:
        return (self.offset, self.nbytes)


def _new_shm(name: str | None, create: bool, size: int = 0) -> shared_memory.SharedMemory:
    # track=False (py3.13): we manage unlink ourselves; the resource tracker
    # otherwise unlinks segments owned by other processes on exit.
    try:
        return shared_memory.SharedMemory(name=name, create=create, size=size, track=False)
    except TypeError:  # pragma: no cover - older pythons
        return shared_memory.SharedMemory(name=name, create=create, size=size)


# agnolint: single-writer -- the owning publisher is the only allocator/writer; readers attach read-only (registry entry lifetime gates reuse)
class Arena:
    """Fixed-capacity shared heap owned by a single publisher process."""

    def __init__(self, shm: shared_memory.SharedMemory, *, owner: bool):
        self._shm = shm
        self.owner = owner
        self.name = shm.name
        self._buf = np.frombuffer(shm.buf, dtype=np.uint8)
        hdr = np.frombuffer(shm.buf, dtype=np.uint64, count=4)
        if owner:
            hdr[0] = _MAGIC
            hdr[1] = shm.size
            # free list: sorted list of [offset, size) blocks; owner-local
            # state (only the owner allocates, per §IV-C).
            self._free: list[tuple[int, int]] = [(_HEADER, shm.size - _HEADER)]
            self._live: dict[int, int] = {}  # offset -> size
        else:
            if int(hdr[0]) != _MAGIC:
                raise ArenaError(f"attached segment {shm.name!r} is not an arena")
            self._free = []
            self._live = {}
        self.capacity = shm.size

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def create(cls, capacity: int, name: str | None = None) -> "Arena":
        name = name or f"agno-{secrets.token_hex(6)}"
        shm = _new_shm(name, create=True, size=capacity)
        return cls(shm, owner=True)

    @classmethod
    def attach(cls, name: str) -> "Arena":
        return cls(_new_shm(name, create=False), owner=False)

    def close(self) -> None:
        import gc

        self._buf = None
        gc.collect()  # drop dangling message views before unmapping
        try:
            self._shm.close()
        except BufferError:  # outstanding views; let GC deal with it
            pass

    def unlink(self) -> None:
        if self.owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass

    # -- allocator (owner only) --------------------------------------------

    def alloc(self, nbytes: int) -> int:
        if not self.owner:
            raise ArenaError("only the owning process may allocate (§IV-C)")
        nbytes = _align(max(int(nbytes), 1))
        for i, (off, size) in enumerate(self._free):
            if size >= nbytes:
                rest = size - nbytes
                if rest:
                    self._free[i] = (off + nbytes, rest)
                else:
                    del self._free[i]
                self._live[off] = nbytes
                return off
        raise OutOfArenaMemory(
            f"arena {self.name}: cannot allocate {nbytes}B "
            f"(capacity {self.capacity}B, live {self.live_bytes}B)"
        )

    def free(self, offset: int) -> None:
        if not self.owner:
            raise ArenaError("only the owning process may free (§IV-C)")
        size = self._live.pop(offset)
        insort(self._free, (offset, size))
        self._coalesce()

    def _coalesce(self) -> None:
        merged: list[tuple[int, int]] = []
        for off, size in self._free:
            if merged and merged[-1][0] + merged[-1][1] == off:
                merged[-1] = (merged[-1][0], merged[-1][1] + size)
            else:
                merged.append((off, size))
        self._free = merged

    def realloc(self, offset: int, new_nbytes: int) -> int:
        """Grow/shrink a block; grows in place when the adjacent free block
        allows, else moves within the arena (std::vector reallocation —
        pre-publish and intra-arena, so zero-copy *publishing* is preserved).
        """
        old = self._live[offset]
        new_nbytes = _align(max(int(new_nbytes), 1))
        if new_nbytes <= old:
            return offset
        # try in-place growth
        need = new_nbytes - old
        for i, (foff, fsize) in enumerate(self._free):
            if foff == offset + old and fsize >= need:
                if fsize - need:
                    self._free[i] = (foff + need, fsize - need)
                else:
                    del self._free[i]
                self._live[offset] = new_nbytes
                return offset
            if foff > offset + old:
                break
        new_off = self.alloc(new_nbytes)
        self._buf[new_off : new_off + old] = self._buf[offset : offset + old]
        self.free(offset)
        return new_off

    @property
    def live_bytes(self) -> int:
        return sum(self._live.values())

    @property
    def free_bytes(self) -> int:
        return sum(s for _, s in self._free)

    def owns(self, offset: int) -> bool:
        return offset in self._live

    # -- views ---------------------------------------------------------------

    def view(self, offset: int, nbytes: int, dtype=np.uint8, shape=None, *, writeable: bool | None = None):
        """A numpy view directly over the shared mapping — the zero-copy read
        path. Non-owners get read-only views (MMU read-only analogue)."""
        if offset <= 0 or offset + nbytes > self.capacity or nbytes < 0:
            raise ArenaError(f"view [{offset}, {offset + nbytes}) out of arena bounds")
        raw = self._buf[offset : offset + nbytes]
        arr = raw.view(dtype)
        if shape is not None:
            arr = arr.reshape(shape)
        w = self.owner if writeable is None else writeable
        if not w:
            arr = arr[...]  # new view object so the flag doesn't leak
            arr.flags.writeable = False
        return arr

    def ref(self, offset: int, nbytes: int) -> AllocRef:
        return AllocRef(self.name, offset, nbytes)

    # -- bulk copy helpers (used by benchmarks' copy-baselines) -------------

    def write_bytes(self, offset: int, data: bytes | np.ndarray) -> None:
        src = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        self._buf[offset : offset + src.size] = src

    def read_bytes(self, offset: int, nbytes: int) -> bytes:
        return self._buf[offset : offset + nbytes].tobytes()


class ArenaAttachCache:
    """Bounded read-only attach cache for *foreign* arenas.

    The attach-by-name data plane makes a bridge touch one arena per
    remote publisher incarnation; ``shm_open`` + ``mmap`` per message
    would dwarf the control-frame cost, and caching without a bound
    would leak a mapping per dead publisher (arena names are random per
    incarnation, so a long-lived bridge sees an unbounded stream of
    them).  LRU with ``capacity`` mappings: eviction closes the mapping
    — any outstanding numpy views keep the pages alive until they are
    garbage collected (``Arena.close`` tolerates exported views), so an
    evicted-while-reading arena degrades to a deferred unmap, never a
    dangling read."""

    def __init__(self, capacity: int = 16):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._cached: "OrderedDict[str, Arena]" = OrderedDict()
        self.attaches = 0  # cold attaches (observability: hit rate)
        self.evictions = 0

    def attach(self, name: str) -> Arena:
        """The cached ``Arena.attach(name)``: O(1) on a hit.  Raises
        ``FileNotFoundError``/``ArenaError`` when the segment is gone or
        not an arena — callers treat that as a failed data read (the
        bridge NACKs so the source falls back to serialization)."""
        a = self._cached.get(name)
        if a is not None:
            self._cached.move_to_end(name)
            return a
        a = Arena.attach(name)
        self.attaches += 1
        self._cached[name] = a
        while len(self._cached) > self.capacity:
            _, old = self._cached.popitem(last=False)
            self.evictions += 1
            old.close()
        return a

    def evict(self, name: str) -> bool:
        """Drop one mapping (e.g. after a read fails: the segment may be
        a stale incarnation)."""
        a = self._cached.pop(name, None)
        if a is None:
            return False
        a.close()
        return True

    def close(self) -> None:
        for a in self._cached.values():
            a.close()
        self._cached = OrderedDict()
