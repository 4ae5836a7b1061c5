"""The port's copies of the jax-free planes held against the originals.

``repro_torch.core.device_arena`` and ``repro_torch.serving.messages`` are
copies, not imports, of the reference's ``DevicePagePool`` and
``GenerationGate``.  The same seeded sequence of operations, driven through
the copy and the original side by side, must give the same results, the
same exceptions and the same observable state after every step."""

import numpy as np
import pytest

from repro.core.device_arena import DevicePagePool as RefPool
from repro.core.device_arena import PoolExhausted as RefExhausted
from repro.serving.messages import GenerationGate as RefGate
from repro_torch.core.device_arena import DevicePagePool, PoolExhausted
from repro_torch.serving.messages import GenerationGate
from _port_env import port_test_env  # noqa: F401  (autouse)


def _outcome(fn):
    """(kind, value) of one call: its result, or the exception's class name
    with the two packages' ``PoolExhausted`` named alike."""
    try:
        out = fn()
    except (KeyError, PoolExhausted, RefExhausted) as e:
        return ("raise", "PoolExhausted" if "Exhausted" in type(e).__name__
                else type(e).__name__)
    if isinstance(out, np.ndarray):
        return ("array", out.tolist())
    return ("value", out)


def _pool_state(pool) -> tuple:
    pool.check_invariants()
    return (pool.free_pages, pool.live_publications, list(pool._free),
            pool._page_pins.tolist())


@pytest.mark.parametrize("seed", range(4))
def test_page_pool_copy_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ref, port = RefPool(num_pages=24, page_tokens=16), DevicePagePool(24, 16)
    keys, consumers = [f"kv/{i}" for i in range(6)], [f"c{i}" for i in range(3)]
    for _ in range(400):
        op = rng.choice(["alloc_publish", "take", "clone", "release", "expire",
                         "pages_for_tokens"])
        key, who = str(rng.choice(keys)), str(rng.choice(consumers))
        if op == "alloc_publish":
            n = int(rng.integers(1, 9))
            subs = sorted({str(c) for c in rng.choice(consumers, int(rng.integers(1, 4)))})

            def call(pool, n=n, key=key, subs=subs):
                pages = pool.alloc(n)
                pool.publish(key, pages, subs)
                return pages
        elif op == "pages_for_tokens":
            tokens = int(rng.integers(0, 200))
            call = lambda pool, t=tokens: pool.pages_for_tokens(t)  # noqa: E731
        elif op == "expire":
            call = lambda pool, w=who: pool.expire_consumer(w)  # noqa: E731
        else:
            call = lambda pool, op=op, k=key, w=who: getattr(pool, op)(k, w)  # noqa: E731
        assert _outcome(lambda: call(port)) == _outcome(lambda: call(ref)), op
        assert _pool_state(port) == _pool_state(ref), op


@pytest.mark.parametrize("seed", range(4))
def test_generation_gate_copy_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    ref, port = RefGate(done_limit=5), GenerationGate(done_limit=5)
    superseded = {"ref": [], "port": []}
    rids = [f"r{i}" for i in range(8)]
    for _ in range(400):
        op, rid = rng.choice(["admit", "admit", "finish", "drop", "current"]), str(rng.choice(rids))
        if op == "admit":
            gen = int(rng.integers(0, 5))
            got = port.admit(rid, gen, supersede=superseded["port"].append)
            want = ref.admit(rid, gen, supersede=superseded["ref"].append)
        else:
            got, want = getattr(port, op)(rid), getattr(ref, op)(rid)
        assert got == want, op
        assert superseded["port"] == superseded["ref"]
        assert port._live == ref._live and list(port._done.items()) == list(ref._done.items())
