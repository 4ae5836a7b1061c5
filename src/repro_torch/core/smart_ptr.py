"""The Agnocast smart pointer (§IV-C).

A message buffer is freed only when BOTH its reference count and its
unreceived-subscriber count are zero — and only by the publisher that
allocated it.  The registry tracks the cross-process component (held /
unreceived bitmasks); this module implements the in-process component:
``MessagePtr`` instances sharing one ``_RefState`` increment/decrement a
local count, and the registry's held-bit for this subscriber is released
exactly when the local count reaches zero.  Destruction is hooked with
``weakref.finalize`` so dropping the last Python reference releases the
shared ref even without an explicit ``close()`` — and process death is
covered by the registry janitor (kernel exit-hook analogue).

The port's copy of ``repro/core/smart_ptr.py``: only the import paths differ.  Layouts,
magic numbers and shm names are the reference's on purpose, so a message
published through one package is taken by the other.
"""

from __future__ import annotations

import weakref

from .messages import ReceivedMessage
from .registry import Entry, Registry
from repro_torch.obs.trace import Stage as _Stage

# plain ints: decref pays no attribute chain per record
_ST_TAKE = _Stage.TAKE
_ST_RELEASE = _Stage.RELEASE

__all__ = ["MessagePtr"]


class _RefState:
    __slots__ = ("count", "released", "registry", "tidx", "sidx", "entry",
                 "gen", "tracer", "take_t")

    def __init__(self, registry: Registry, tidx: int, sidx: int, entry: Entry,
                 gen: int | None = None, tracer=None, take_t: int = 0):
        self.count = 1
        self.released = False
        self.registry = registry
        self.tidx = tidx
        self.sidx = sidx
        self.entry = entry
        self.gen = gen  # topic generation at take: stale handles must not
                        # release into a recycled topic slot (name-ABA guard)
        self.tracer = tracer  # this subscriber's trace ring (None = off)
        self.take_t = take_t  # TAKE stamp, written with RELEASE (one emit2)

    def decref(self) -> None:
        self.count -= 1
        if self.count <= 0 and not self.released:
            self.released = True
            e = self.entry
            try:
                self.registry.release(self.tidx, e.pub_idx, self.sidx,
                                      e.seq, gen=self.gen)
            except Exception:
                pass  # registry torn down; janitor covers us
            if self.tracer is not None and e.trace_id:
                try:
                    # TAKE back-stamped at its sampled time + RELEASE now;
                    # one call writes the subscriber side's record pair
                    self.tracer.emit2(e.trace_id, e.hops, _ST_TAKE,
                                      self.take_t, _ST_RELEASE,
                                      e.seq & 0xFFFF_FFFF)
                except Exception:
                    pass  # finalizer ran after atexit closed the ring


def _finalizer(state: _RefState) -> None:
    if not state.released:
        state.count = 1
        state.decref()


class MessagePtr:
    """Subscriber-side smart pointer over a zero-copy ``ReceivedMessage``."""

    def __init__(self, msg: ReceivedMessage, state: _RefState):
        self._msg = msg
        self._state = state
        self._own = True
        self._fin = weakref.finalize(self, _finalizer, state)

    @classmethod
    def first(cls, msg: ReceivedMessage, registry: Registry, tidx: int, sidx: int,
              entry: Entry, gen: int | None = None, tracer=None,
              take_t: int = 0) -> "MessagePtr":
        return cls(msg, _RefState(registry, tidx, sidx, entry, gen, tracer,
                                  take_t))

    # -- access ----------------------------------------------------------------

    @property
    def msg(self) -> ReceivedMessage:
        if not self._own:
            raise ValueError("use after release of agnocast message_ptr")
        return self._msg

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_msg"), name)

    @property
    def seq(self) -> int:
        return self._state.entry.seq

    @property
    def origin(self) -> int:
        return self._state.entry.origin

    @property
    def pub_idx(self) -> int:
        return self._state.entry.pub_idx

    # -- route metadata (multi-domain federation, repro_torch.core.routing) -----

    @property
    def hops(self) -> int:
        return self._state.entry.hops

    @property
    def src_tag(self) -> int:
        return self._state.entry.src_tag

    @property
    def route_seq(self) -> int:
        return self._state.entry.route_seq

    @property
    def trace_id(self) -> int:
        return self._state.entry.trace_id

    # -- refcount management (create/duplicate/destroy, §IV-C) -----------------

    def clone(self) -> "MessagePtr":
        if not self._own:
            raise ValueError("clone after release")
        self._state.count += 1
        return MessagePtr(self._msg, self._state)

    def release(self) -> None:
        if self._own:
            self._own = False
            self._fin.detach()
            self._state.decref()

    close = release

    def __enter__(self) -> "MessagePtr":
        return self

    def __exit__(self, *exc) -> None:
        self.release()
