"""Agnocast core, the port's copy: zero-copy publish/subscribe IPC for
*unsized* message types.

* :mod:`repro_torch.core.arena` — the heap-on-shared-memory analogue;
* :mod:`repro_torch.core.messages` — unsized message schema
  (``ArenaVector`` = ``std::vector`` in the shared heap) + the serialized
  baseline format;
* :mod:`repro_torch.core.registry` — transactional metadata (per-topic
  flocks + per-topic WAL journal slots + PID-liveness janitor);
* :mod:`repro_torch.core.smart_ptr` — the two-counter smart pointer;
* :mod:`repro_torch.core.topic` — ``create_publisher`` /
  ``create_subscription`` / ``borrow_loaded_message`` / move-``publish``;
* :mod:`repro_torch.core.executor` — the epoll event loop over
  subscription wakeup FIFOs and timers, with callback groups;
* :mod:`repro_torch.core.routing` — the federated routing plane:
  longest-prefix ``RoutingTable``, per-remote-bus ``DomainBridge`` over
  three data planes (``serialized``, ``parts``, ``attach``) and ``Router``
  with origin-tag/route-id/hop-count loop prevention;
  :mod:`repro_torch.core.bridge` keeps the single-topic ``Bridge`` name;
* :mod:`repro_torch.core.transport` — the conventional planes the bridges
  relay over (the serialized bus) and the shm ring baseline;
* :mod:`repro_torch.core.device_arena` — the same lifetime discipline
  applied to device KV pages.

Each module is a copy of the one of the same name in ``repro/core/``, not
an import of it: the port imports nothing of ``repro``.  The layouts, magic
numbers, shm names and the bus's wire are the reference's, so the two
packages share a domain and a bus.
"""

from .arena import (AllocRef, Arena, ArenaAttachCache, ArenaError,
                    OutOfArenaMemory)
from .executor import (
    CallbackGroup,
    EventExecutor,
    MutuallyExclusiveCallbackGroup,
    ReentrantCallbackGroup,
)
from .messages import (
    BYTES_BLOB,
    POINT_CLOUD2,
    TOKEN_BATCH,
    ArenaVector,
    Fixed,
    LoanedMessage,
    MessageType,
    PlainMessage,
    Ragged,
    ReceivedMessage,
    deserialize,
    message_nbytes,
    serialize,
    serialize_parts,
)
from .registry import (
    DEPTH_MAX,
    MAX_PUBS,
    MAX_SUBS,
    MAX_TOPICS,
    AgnocastQueueFull,
    Entry,
    Registry,
    RegistryError,
)
from .routing import (
    Bridge,
    DomainBridge,
    Router,
    RoutingRule,
    RoutingTable,
    domain_tag,
)
from .smart_ptr import MessagePtr
from .topic import Domain, Publisher, Subscription
from .transport import Bus, BusClient, Frame, ShmRing

__all__ = [
    "AllocRef", "Arena", "ArenaAttachCache", "ArenaError",
    "OutOfArenaMemory",
    "ArenaVector", "Fixed", "Ragged", "MessageType",
    "LoanedMessage", "ReceivedMessage", "PlainMessage",
    "POINT_CLOUD2", "TOKEN_BATCH", "BYTES_BLOB",
    "serialize", "serialize_parts", "deserialize", "message_nbytes",
    "Registry", "RegistryError", "AgnocastQueueFull", "Entry",
    "MAX_TOPICS", "MAX_PUBS", "MAX_SUBS", "DEPTH_MAX",
    "MessagePtr", "Domain", "Publisher", "Subscription",
    "Bus", "BusClient", "Frame", "ShmRing",
    "Bridge", "DomainBridge", "Router", "RoutingRule", "RoutingTable",
    "domain_tag",
    "EventExecutor", "CallbackGroup",
    "MutuallyExclusiveCallbackGroup", "ReentrantCallbackGroup",
]
