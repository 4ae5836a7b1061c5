"""The port's continuous-batching ``InferenceServer`` held against the JAX
reference server on the ``tiny_server`` config of ``tests/test_runtime.py``
and the same weights: the same greedy tokens, and the page-pool discipline
of the reference's server tests."""

import jax
import numpy as np
import pytest
import torch

from repro.launch.train import model_100m as jax_model_100m
from repro.models import Model as JaxModel
from repro.runtime import InferenceServer as JaxServer
from repro.runtime import Request as JaxRequest
from repro_torch.configs import model_100m
from repro_torch.models import Model
from repro_torch.models.weights import params_from_numpy
from repro_torch.runtime import InferenceServer, Request
from _port_env import port_test_env  # noqa: F401  (autouse)

TINY = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=512, num_heads=2,
            num_kv_heads=1, head_dim=32)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_model_100m("qwen2-1.5b").scaled(**TINY)
    cfg = model_100m("qwen2-1.5b").scaled(**TINY)
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _servers(weights, **kw):
    jcfg, jparams, cfg, params = weights
    jsrv = JaxServer(JaxModel(jcfg), **kw)
    jsrv.load(jparams)
    srv = InferenceServer(Model(cfg, device="cpu"), **kw)
    srv.load(params)
    return jsrv, srv


def _prompts(seed, n, lo, hi, max_new):
    rng = np.random.default_rng(seed)
    return [(f"r{i}", rng.integers(0, 512, int(rng.integers(lo, hi))), max_new)
            for i in range(n)]


def _assert_pool_clean(srv):
    st = srv.stats()
    assert st["live_publications"] == 0
    assert st["free_pages"] == srv.pool.num_pages   # two-counter rule held
    srv.pool.check_invariants()


def test_server_greedy_tokens_match_jax(weights):
    jsrv, srv = _servers(weights, slots=2, max_seq=128, page_tokens=32)
    for rid, toks, max_new in _prompts(1, 5, 4, 30, 6):   # 5 requests through 2 slots
        jsrv.submit(JaxRequest(rid=rid, tokens=toks, max_new=max_new))
        srv.submit(Request(rid=rid, tokens=toks, max_new=max_new))
    jres, res = jsrv.serve(), srv.serve()
    assert sorted(res) == sorted(jres) and len(res) == 5
    for rid, r in res.items():
        assert r.tokens == jres[rid].tokens, rid
        assert r.prompt_len == jres[rid].prompt_len and len(r.tokens) == 6
    assert srv.steps == jsrv.steps
    _assert_pool_clean(srv)
    assert srv.idle


def test_server_cancel_janitor(weights):
    _, srv = _servers(weights, slots=2, max_seq=128, page_tokens=32)
    rng = np.random.default_rng(2)
    srv.submit(Request(rid="victim", tokens=rng.integers(0, 512, 8), max_new=30))
    srv.submit(Request(rid="survivor", tokens=rng.integers(0, 512, 8), max_new=4))
    srv.step_rounds()
    assert srv.cancel("victim")
    assert not srv.cancel("victim")
    results = srv.serve()
    assert "survivor" in results and "victim" not in results
    _assert_pool_clean(srv)


def test_idle_slot_past_max_seq(weights):
    """An idle slot's length grows every round (as in the reference) past
    max_seq; the in-place K/V write clamps to max_seq - 1 where the
    reference's dynamic_update_slice clamps silently, and the active slot's
    tokens still match the reference."""
    kw = dict(slots=2, max_seq=32, page_tokens=8)
    jsrv, srv = _servers(weights, **kw)
    for rid, toks, max_new in _prompts(3, 3, 4, 6, 26):   # served one after another
        jsrv.submit(JaxRequest(rid=rid, tokens=toks, max_new=max_new))
        srv.submit(Request(rid=rid, tokens=toks, max_new=max_new))
        assert srv.serve()[rid].tokens == jsrv.serve()[rid].tokens
    # slot 0 took every request; slot 1 stayed idle and its length ran past max_seq
    assert srv.steps > kw["max_seq"]
    assert int(srv._cache["len"][1]) == int(jsrv._cache["len"][1]) == srv.steps
    _assert_pool_clean(srv)


def test_server_streams_chunks_and_rejects_bad_prompts(weights):
    _, srv = _servers(weights, slots=2, max_seq=64, page_tokens=16)
    chunks = []
    srv.stream_sink = lambda rid, gen, seq, toks, eos: chunks.append((rid, seq, toks, eos))
    srv.submit(Request(rid="a", tokens=np.arange(5), max_new=3))
    srv.serve()
    assert [c[1] for c in chunks] == [0, 1, 2] and chunks[-1][3]
    assert [t for c in chunks for t in c[2]] == srv.results["a"].tokens
    with pytest.raises(ValueError, match="prompt"):
        srv.submit(Request(rid="long", tokens=np.zeros(64, np.int64)))
    with pytest.raises(ValueError, match="prompt"):
        srv.submit(Request(rid="empty", tokens=np.zeros(0, np.int64)))


def test_server_without_device_does_not_fall_back_to_cpu(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here, so the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceServer(Model(weights[2]))


def test_serve_entry_point_runs_on_cpu_when_asked():
    from repro_torch.launch.serve import main

    out = main(["--size", "smoke", "--device", "cpu", "--requests", "3", "--max-new", "4"])
    assert out["completed"] == 3 and out["pool_clean"]
    assert out["generated_tokens"] == 12 and out["peak_mem_gib"] is None
