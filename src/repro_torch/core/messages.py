"""Unsized message types over the arena.

The paper's requirement #1 is *unsized* message types: payload fields whose
memory can be reallocated at arbitrary times (``std::vector::push_back``),
not merely sized-once-at-init (the TZC/LOT restriction, §III-A).  The
analogue here is :class:`ArenaVector`: a growable array whose storage lives
in the publisher's shared arena and which may ``push_back``/``resize``/
``reserve`` freely before publication — capacity doubling via
``Arena.realloc`` keeps every byte inside the shared mapping, so publishing
remains a constant-size metadata operation regardless of payload size.

A message *type* is a named schema of fields (ragged arrays, fixed arrays,
scalars — ROS 2 messages are exactly primitives + arrays, §IV-A).  Message
*instances* come in two flavours:

* ``LoanedMessage`` — publisher-side, write-through views into the arena
  (``borrow_loaded_message`` in the paper's API, Fig. 2);
* ``ReceivedMessage`` — subscriber-side, read-only views into the
  publisher's arena (the MMU read-only mapping analogue).

``serialize``/``deserialize`` implement the *conventional* path (the
ROS 2/DDS CDR analogue) used by the baseline transport and by the bridge.

TZC-style partial serialization (the cross-host data plane) splits the
same wire format into a **control part** and a **data part**:

* ``serialize_parts`` returns ``(header, field_views)`` where ``header``
  is the tiny pickled layout prefix and ``field_views`` are zero-copy
  buffers straight over the message's arena (or heap) storage —
  ``header + b"".join(views)`` is byte-identical to ``serialize``'s
  output, so a scatter-gather writer (``BusClient.publish_parts``) can
  emit the conventional frame with **no assembly copy** while every
  legacy receiver keeps working unchanged.
* ``deserialize(buf, copy=False)`` returns read-only ``frombuffer``
  views over the caller's buffer instead of per-field ``.copy()``s —
  the far-side half of partial serialization (the bridge copies each
  field exactly once, from the view into its loan).
* ``control_frame``/``ReceivedMessage.descriptor`` carry the field
  layout (dtype/shape/offset words) out of band for the same-host
  attach-by-name path, where no payload bytes transit the bus at all.

The port's copy of ``repro/core/messages.py``: only the import paths differ.  Layouts,
magic numbers and shm names are the reference's on purpose, so a message
published through one package is taken by the other.
"""

from __future__ import annotations

import pickle
import struct
from dataclasses import dataclass, field

import numpy as np

from .arena import Arena

__all__ = [
    "Ragged",
    "Fixed",
    "MessageType",
    "ArenaVector",
    "LoanedMessage",
    "ReceivedMessage",
    "PlainMessage",
    "POINT_CLOUD2",
    "TOKEN_BATCH",
    "BYTES_BLOB",
    "serialize",
    "serialize_parts",
    "deserialize",
    "message_nbytes",
]


# --------------------------------------------------------------------------
# Schema
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Ragged:
    """Leading dimension dynamic (unsized); trailing dims fixed."""

    dtype: np.dtype
    row_shape: tuple[int, ...] = ()
    init_capacity: int = 8

    def __post_init__(self):
        object.__setattr__(self, "dtype", np.dtype(self.dtype))

    @property
    def row_items(self) -> int:
        n = 1
        for d in self.row_shape:
            n *= d
        return n


@dataclass(frozen=True)
class Fixed:
    """Statically shaped field (covers scalars with shape=())."""

    dtype: np.dtype
    shape: tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "dtype", np.dtype(self.dtype))

    @property
    def nbytes(self) -> int:
        n = self.dtype.itemsize
        for d in self.shape:
            n *= d
        return n


@dataclass(frozen=True)
class MessageType:
    name: str
    fields: dict[str, Ragged | Fixed] = field(default_factory=dict)

    def loan(self, arena: Arena) -> "LoanedMessage":
        return LoanedMessage(self, arena)

    def plain(self) -> "PlainMessage":
        return PlainMessage(self)


# The PointCloud2 analogue — the workload the paper evaluates end to end.
POINT_CLOUD2 = MessageType(
    "PointCloud2",
    {
        "data": Ragged(np.uint8),          # unsized payload (point buffer)
        "point_step": Fixed(np.uint32),
        "width": Fixed(np.uint32),
        "height": Fixed(np.uint32),
        "stamp": Fixed(np.float64),
        "is_dense": Fixed(np.uint8),
    },
)

# Ragged token batch — the ML data-plane message (unsized per-sequence).
TOKEN_BATCH = MessageType(
    "TokenBatch",
    {
        "tokens": Ragged(np.int32),        # flat concatenated tokens
        "row_lengths": Ragged(np.int32),   # per-sequence lengths (also unsized)
        "stamp": Fixed(np.float64),
        "epoch": Fixed(np.int64),
        "step": Fixed(np.int64),
    },
)

BYTES_BLOB = MessageType("BytesBlob", {"data": Ragged(np.uint8), "stamp": Fixed(np.float64)})


# --------------------------------------------------------------------------
# Publisher-side unsized storage (std::vector analogue)
# --------------------------------------------------------------------------


class ArenaVector:
    """Growable array in the arena: reallocation at arbitrary times, which is
    precisely what TZC/LOT cannot support and Agnocast can (§III-A)."""

    def __init__(self, arena: Arena, spec: Ragged):
        self._arena = arena
        self._spec = spec
        self._size = 0
        self._capacity = max(spec.init_capacity, 1)
        self._offset = arena.alloc(self._row_bytes * self._capacity)

    @property
    def _row_bytes(self) -> int:
        return self._spec.dtype.itemsize * self._spec.row_items

    def __len__(self) -> int:
        return self._size

    @property
    def offset(self) -> int:
        return self._offset

    @property
    def nbytes(self) -> int:
        return self._size * self._row_bytes

    def reserve(self, capacity: int) -> None:
        if capacity > self._capacity:
            self._offset = self._arena.realloc(self._offset, self._row_bytes * capacity)
            self._capacity = capacity

    def resize(self, n: int) -> None:
        if n > self._capacity:
            self.reserve(max(n, 2 * self._capacity))
        self._size = n

    def push_back(self, row) -> None:
        if self._size == self._capacity:
            self.reserve(2 * self._capacity)
        self._size += 1
        self.data[self._size - 1] = row

    def extend(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, dtype=self._spec.dtype)
        n = rows.shape[0]
        start = self._size
        self.resize(start + n)
        self.data[start : start + n] = rows.reshape((n,) + self._spec.row_shape)

    @property
    def data(self) -> np.ndarray:
        """Write-through view of the live elements (owner-writable)."""
        shape = (self._size,) + self._spec.row_shape
        return self._arena.view(self._offset, self.nbytes, self._spec.dtype, shape, writeable=True)

    def dealloc(self) -> None:
        if self._offset:
            self._arena.free(self._offset)
            self._offset = 0


# --------------------------------------------------------------------------
# Message instances
# --------------------------------------------------------------------------


class LoanedMessage:
    """Publisher-side message living entirely in the arena.

    Ragged fields are ``ArenaVector``s; fixed fields are write-through numpy
    views. ``descriptor()`` emits the constant-size layout record that is the
    only thing crossing the metadata queue at publish time.
    """

    def __init__(self, mtype: MessageType, arena: Arena):
        self.mtype = mtype
        self.arena = arena
        self._ragged: dict[str, ArenaVector] = {}
        self._fixed: dict[str, tuple[int, Fixed]] = {}
        try:
            for name, spec in mtype.fields.items():
                if isinstance(spec, Ragged):
                    self._ragged[name] = ArenaVector(arena, spec)
                else:
                    off = arena.alloc(spec.nbytes)
                    self._fixed[name] = (off, spec)
        except Exception:
            # abort-safe borrow: an OutOfArenaMemory mid-construction must
            # not strand the fields already allocated (bridges retry borrows
            # under arena pressure, so this path is reachable in steady state)
            self.dealloc()
            raise

    def __getattr__(self, name: str):
        ragged = object.__getattribute__(self, "_ragged")
        if name in ragged:
            return ragged[name]
        fixed = object.__getattribute__(self, "_fixed")
        if name in fixed:
            off, spec = fixed[name]
            v = self.arena.view(off, spec.nbytes, spec.dtype, spec.shape or (1,), writeable=True)
            return v if spec.shape else v  # scalar fields are length-1 views
        raise AttributeError(name)

    def set(self, name: str, value) -> None:
        off, spec = self._fixed[name]
        v = self.arena.view(off, spec.nbytes, spec.dtype, spec.shape or (1,), writeable=True)
        v[...] = value

    def get(self, name: str):
        if name in self._ragged:
            return self._ragged[name].data
        off, spec = self._fixed[name]
        v = self.arena.view(off, spec.nbytes, spec.dtype, spec.shape or (1,))
        return v if spec.shape else v[0]

    # -- publish-time layout record (constant size in payload bytes) --------

    def descriptor(self) -> dict:
        d: dict = {"type": self.mtype.name, "fields": {}}
        for name, vec in self._ragged.items():
            d["fields"][name] = (
                "ragged",
                vec.offset,
                (len(vec),) + vec._spec.row_shape,
                vec._spec.dtype.str,
            )
        for name, (off, spec) in self._fixed.items():
            d["fields"][name] = ("fixed", off, spec.shape, spec.dtype.str)
        return d

    def alloc_offsets(self) -> list[int]:
        offs = [v.offset for v in self._ragged.values()]
        offs += [off for off, _ in self._fixed.values()]
        return offs

    def dealloc(self) -> None:
        for v in self._ragged.values():
            v.dealloc()
        for off, _ in self._fixed.values():
            self.arena.free(off)
        self._fixed = {}
        self._ragged = {}


class ReceivedMessage:
    """Subscriber-side zero-copy read-only window onto the publisher's arena."""

    def __init__(self, arena: Arena, descriptor: dict):
        self.type_name = descriptor["type"]
        self.arena_name = arena.name  # identifies the publisher incarnation
        self.descriptor = descriptor  # field layout: (kind, offset, shape,
                                      # dtype) words — the attach-by-name
                                      # control frame is built from this
        self._views: dict[str, np.ndarray] = {}
        for name, (kind, off, shape, dtstr) in descriptor["fields"].items():
            dt = np.dtype(dtstr)
            n = dt.itemsize
            for s in shape:
                n *= s
            view = arena.view(off, n, dt, shape if shape else (1,), writeable=False)
            self._views[name] = view

    def __getattr__(self, name: str):
        views = object.__getattribute__(self, "_views")
        if name in views:
            return views[name]
        raise AttributeError(name)

    def get(self, name: str):
        v = self._views[name]
        return v if v.shape != (1,) else v[0]

    def fields(self) -> dict[str, np.ndarray]:
        return dict(self._views)


class PlainMessage:
    """Heap-backed message for the conventional (serialized) path."""

    def __init__(self, mtype: MessageType):
        self.mtype = mtype
        self._data: dict[str, np.ndarray] = {}
        for name, spec in mtype.fields.items():
            if isinstance(spec, Ragged):
                self._data[name] = np.zeros((0,) + spec.row_shape, dtype=spec.dtype)
            else:
                self._data[name] = np.zeros(spec.shape or (1,), dtype=spec.dtype)

    def __getattr__(self, name: str):
        data = object.__getattribute__(self, "_data")
        if name in data:
            return data[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value):
        if name in ("mtype", "_data"):
            object.__setattr__(self, name, value)
        else:
            spec = self.mtype.fields[name]
            arr = np.asarray(value, dtype=spec.dtype)
            if isinstance(spec, Fixed):
                arr = arr.reshape(spec.shape or (1,))  # scalars are (1,) everywhere
            self._data[name] = arr

    def fields(self) -> dict[str, np.ndarray]:
        return dict(self._data)


# --------------------------------------------------------------------------
# Conventional path: serialization (CDR analogue). Costs O(payload bytes) —
# this is exactly the cost Agnocast eliminates.
# --------------------------------------------------------------------------

_HDR = struct.Struct("<I")


def serialize_parts(msg) -> tuple[bytes, list]:
    """TZC-style partial serialization: ``(header, field_views)``.

    ``header`` is the tiny pickled-layout prefix; ``field_views`` are
    zero-copy contiguous buffers over the message's own storage (arena
    views for loaned/received messages).  ``header + b"".join(views)``
    is byte-identical to :func:`serialize`'s output — the split exists
    so a scatter-gather writer can put the views on the wire without
    ever assembling them (no per-field ``tobytes``, no join copy)."""
    fields = msg.fields() if not isinstance(msg, LoanedMessage) else {
        name: msg.get(name) for name in msg.mtype.fields
    }
    layout = []
    views = []
    for name, arr in fields.items():
        arr = np.asarray(arr)
        layout.append((name, arr.dtype.str, arr.shape))
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)  # rare: strided caller array
        views.append(arr.reshape(-1).view(np.uint8).data)
    head = pickle.dumps((getattr(msg, "type_name", None) or msg.mtype.name, layout), protocol=5)
    return _HDR.pack(len(head)) + head, views


def serialize(msg) -> bytes:
    """Flatten a message to bytes: header (pickled layout, tiny) + raw field
    bytes. The byte-copy cost is the serialization the paper measures."""
    header, views = serialize_parts(msg)
    return header + b"".join(views)  # the assembly copy parts-writers skip


def deserialize(buf: bytes | memoryview, *, copy: bool = True) -> dict[str, np.ndarray]:
    """Rebuild arrays from bytes.

    ``copy=True`` (default) materialises independent arrays — the
    conventional deserialization copy the paper measures.  ``copy=False``
    returns **read-only ``frombuffer`` views over the caller's buffer**:
    zero-copy, valid only while that buffer lives — the bridge copy-in
    path uses it so each field moves exactly once (view → loan)."""
    buf = memoryview(buf)
    (hlen,) = _HDR.unpack(buf[:4])
    _, layout = pickle.loads(bytes(buf[4 : 4 + hlen]))
    out: dict[str, np.ndarray] = {}
    pos = 4 + hlen
    for name, dtstr, shape in layout:
        dt = np.dtype(dtstr)
        n = dt.itemsize
        for s in shape:
            n *= s
        arr = np.frombuffer(buf[pos : pos + n], dtype=dt).reshape(shape)
        if copy:
            arr = arr.copy()
        elif arr.flags.writeable:  # writable source buffer: views stay RO
            arr = arr[...]
            arr.flags.writeable = False
        out[name] = arr
        pos += n
    return out


def message_nbytes(msg) -> int:
    if isinstance(msg, LoanedMessage):
        return sum(np.asarray(msg.get(n)).nbytes for n in msg.mtype.fields)
    return sum(np.asarray(a).nbytes for a in msg.fields().values())
