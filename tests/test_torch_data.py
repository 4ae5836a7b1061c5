"""The port's data plane: the copies of ``repro/data`` against the
reference (same documents, packing and batches from the same seed), the
resume cursors, the zero-copy pipeline with a respawn, and the ordered
variant the trainer takes its batches from.  Waits are on conditions with
generous deadlines, never on a fixed window."""

import numpy as np

from repro.data import BatchSpec as JaxBatchSpec
from repro.data import InProcessPipeline as JaxInProcessPipeline
from repro.data.packing import Packer as JaxPacker
from repro.data.packing import pack_documents as jax_pack_documents
from repro.data.synthetic import SyntheticCorpus as JaxCorpus
from repro_torch.data import BatchSpec, InProcessPipeline, ZeroCopyPipeline
from repro_torch.data.ordered import OrderedZeroCopyPipeline
from repro_torch.data.packing import Packer, pack_documents, unpack_batch
from repro_torch.data.synthetic import SyntheticCorpus
from _port_env import port_test_env  # noqa: F401  (autouse)


def _equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_corpus_matches_reference():
    c, j = SyntheticCorpus(vocab_size=1000, seed=7), JaxCorpus(vocab_size=1000, seed=7)
    for i in (0, 1, 5, 123):
        assert c.doc_length(i) == j.doc_length(i)
        np.testing.assert_array_equal(c.doc(i), j.doc(i))
    it, jt = c.shard_iter(1, 3, start=2), j.shard_iter(1, 3, start=2)
    for _ in range(4):
        (i, d), (ji, jd) = next(it), next(jt)
        assert i == ji
        np.testing.assert_array_equal(d, jd)


def test_packing_matches_reference():
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 50, rng.integers(3, 90)).astype(np.int32) for _ in range(9)]
    _equal(pack_documents(docs, 3, 64), jax_pack_documents(docs, 3, 64))
    p, jp = Packer(2, 32), JaxPacker(2, 32)
    for d in docs:
        p.feed(d)
        jp.feed(d)
        while p.ready():
            assert jp.ready()
            (f, r), (jf, jr) = p.emit(), jp.emit()
            np.testing.assert_array_equal(f, jf)
            np.testing.assert_array_equal(r, jr)
            _equal(unpack_batch(f, r, 32), unpack_batch(jf, jr, 32))


def test_inprocess_pipeline_matches_reference_and_resumes():
    """Same seed, identical batches in both packages; a restored pipeline
    continues with the batch the original gives next."""
    spec = BatchSpec(batch=2, seq_len=64, vocab_size=500, seed=3)
    p = InProcessPipeline(spec)
    jp = JaxInProcessPipeline(JaxBatchSpec(batch=2, seq_len=64, vocab_size=500, seed=3))
    for _ in range(3):
        _equal(next(p), next(jp))
    state = p.state()
    assert state == jp.state()
    p2 = InProcessPipeline.restore(spec, state)
    _equal(next(p), next(p2))


def _first_batches(spec: BatchSpec, n: int) -> list:
    p = InProcessPipeline(spec)
    return [next(p)["tokens"] for _ in range(n)]


def test_zero_copy_pipeline_and_respawn():
    """The copied zero-copy pipeline: a batch of the right shape and range,
    then, after its stage is killed, a respawn and another batch."""
    spec = BatchSpec(batch=2, seq_len=128, vocab_size=1000, seed=0)
    with ZeroCopyPipeline(spec, arena_mb=16) as zp:
        b1 = zp.next_batch(timeout=120)
        assert b1["tokens"].shape == (2, 128)
        assert (b1["tokens"] >= 0).all() and (b1["tokens"] < 1000).all()
        zp.kill_stage()
        b2 = zp.next_batch(timeout=120)
        assert b2["tokens"].shape == (2, 128)
        assert zp.stats.respawns >= 1
        assert zp.feeder.hand_off_latency


def test_ordered_pipeline_delivers_every_batch_in_order_from_a_cursor():
    """The trainer's zero-copy pipeline gives the in-process pipeline's
    batches, every one and in order, however slowly they are taken; from a
    cursor it starts at that batch; after its stage is killed it respawns
    and goes on from where it was."""
    spec = BatchSpec(batch=2, seq_len=64, vocab_size=700, seed=5)
    want = _first_batches(spec, 14)
    with OrderedZeroCopyPipeline(spec, arena_mb=16) as zp:
        got = [zp.next_batch(timeout=120)["tokens"] for _ in range(3)]
        # let the stage run ahead; with credits it stops at depth - 1 unread
        zp.feeder.sub.wait(1.0)
        got += [zp.next_batch(timeout=120)["tokens"] for _ in range(3)]
        zp.kill_stage()
        got += [zp.next_batch(timeout=120)["tokens"] for _ in range(3)]
        assert zp.stats.respawns >= 1 and zp.cursor == 9
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with OrderedZeroCopyPipeline(spec, arena_mb=16, cursor=11) as zp:
        for i in (11, 12, 13):
            np.testing.assert_array_equal(zp.next_batch(timeout=120)["tokens"], want[i])
