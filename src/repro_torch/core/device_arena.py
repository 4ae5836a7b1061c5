"""Device arena: the Agnocast lifetime discipline applied to device KV pages.

A copy of ``repro/core/device_arena.py`` (``DevicePagePool``,
``PoolExhausted``): the port keeps its own copy of the jax-free planes it
needs instead of importing the reference package.

In a serving runtime, prefill "publishes" the KV pages it wrote and decode
(and any other consumer: speculative verifier, fan-out beams,
prefix-sharing siblings) "subscribes" to them — a zero-copy hand-off
*inside device memory*, with the same two-counter rule as the paper's smart
pointer (§IV-C):

    a page is returned to the free list only when
        held-by == 0   AND   unreceived-by == 0
    and only by the pool (the owner), never by a consumer.

The metadata is host-side numpy (refcount vectors).  A consumer that
disappears (e.g. a cancelled request) is cleaned up by ``expire_consumer``
— the janitor — which drops all of its held/unreceived marks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["DevicePagePool", "PagePublication", "PoolExhausted"]


class PoolExhausted(RuntimeError):
    pass


@dataclass
class PagePublication:
    """One published hand-off: a set of pages offered to N consumers."""

    key: str
    pages: np.ndarray                      # page indices (int32)
    unreceived: set[str] = field(default_factory=set)
    held: dict[str, int] = field(default_factory=dict)  # consumer -> refcount


class DevicePagePool:
    """Host-side metadata for a paged device KV arena.

    The actual device storage is owned by the serving step (the server's
    slot-contiguous KV cache, updated in place); this class hands out page
    indices and enforces the two-counter lifetime rule over them.
    """

    def __init__(self, num_pages: int, page_tokens: int):
        self.num_pages = num_pages
        self.page_tokens = page_tokens
        self._free = list(range(num_pages - 1, -1, -1))
        self._pubs: dict[str, PagePublication] = {}
        self._page_pins = np.zeros(num_pages, np.int32)  # pubs pinning each page

    # -- allocation (owner-side) ------------------------------------------------

    def alloc(self, n_pages: int) -> np.ndarray:
        if n_pages > len(self._free):
            raise PoolExhausted(
                f"need {n_pages} pages, {len(self._free)} free of {self.num_pages}"
            )
        out = np.array([self._free.pop() for _ in range(n_pages)], np.int32)
        return out

    def pages_for_tokens(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_tokens)

    # -- publish / take / release (the pub-sub surface) ---------------------------

    def publish(self, key: str, pages: np.ndarray, consumers: list[str]) -> None:
        """Offer ``pages`` to ``consumers``. Pages stay pinned until every
        consumer has taken AND released them (Fig. 7 timing)."""
        if key in self._pubs:
            raise KeyError(f"publication {key!r} already exists")
        pub = PagePublication(key, np.asarray(pages, np.int32), set(consumers))
        self._pubs[key] = pub
        self._page_pins[pub.pages] += 1

    def take(self, key: str, consumer: str) -> np.ndarray:
        """Zero-copy receive: returns the page indices; marks received+held."""
        pub = self._pubs[key]
        pub.unreceived.discard(consumer)
        pub.held[consumer] = pub.held.get(consumer, 0) + 1
        return pub.pages

    def clone(self, key: str, consumer: str) -> None:
        pub = self._pubs[key]
        if consumer not in pub.held:
            raise KeyError(f"{consumer!r} holds no reference on {key!r}")
        pub.held[consumer] += 1

    def release(self, key: str, consumer: str) -> None:
        pub = self._pubs[key]
        n = pub.held.get(consumer, 0)
        if n <= 1:
            pub.held.pop(consumer, None)
        else:
            pub.held[consumer] = n - 1
        self._maybe_free(pub)

    # -- janitor (process-exit hook analogue) --------------------------------------

    def expire_consumer(self, consumer: str) -> int:
        """Drop every mark belonging to a vanished consumer; returns pages freed."""
        freed = 0
        for pub in list(self._pubs.values()):
            before = self.free_pages
            pub.unreceived.discard(consumer)
            pub.held.pop(consumer, None)
            self._maybe_free(pub)
            freed += self.free_pages - before
        return freed

    # -- internals ---------------------------------------------------------------

    def _maybe_free(self, pub: PagePublication) -> None:
        if not pub.unreceived and not pub.held:
            self._page_pins[pub.pages] -= 1
            for p in pub.pages[self._page_pins[pub.pages] == 0]:
                self._free.append(int(p))
            del self._pubs[pub.key]

    # -- introspection --------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_publications(self) -> int:
        return len(self._pubs)

    def check_invariants(self) -> None:
        """Property-test hook: no page is simultaneously free and pinned; the
        free list has no duplicates; pins match live publications."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate pages in free list"
        pins = np.zeros(self.num_pages, np.int32)
        for pub in self._pubs.values():
            pins[pub.pages] += 1
        assert np.array_equal(pins, self._page_pins), "pin accounting drift"
        pinned = set(np.nonzero(self._page_pins)[0].tolist())
        assert not (free & pinned), "page both free and pinned"
