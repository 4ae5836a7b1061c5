"""The port's training substrate against the JAX reference, on the CPU:
the loss, the schedule, AdamW, the plain backwards of K1 and K2 (which the
backward kernels are held against on the card), their autograd
``Function``s, the parameter counts and the train launcher.

Inputs are drawn with numpy from a seed and handed to both packages; f32
throughout, at the repo's 3e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _grad_parity import plain_kernel_forwards

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro.models import Model as JaxModel
from repro.models.common import cross_entropy as jax_cross_entropy
from repro.models.common import rms_norm as jax_rms_norm
from repro.optim import AdamW as JaxAdamW
from repro.optim import cosine_schedule as jax_cosine_schedule
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention.ops import (_FlashFn, flash_attention_bwd,
                                                     flash_attention_bwd_ref, flash_attention_ref)
from repro_torch.kernels.rmsnorm.ops import (_RMSNormFn, rmsnorm_bwd, rmsnorm_bwd_blocks,
                                             rmsnorm_bwd_lanes, rmsnorm_bwd_ref, rmsnorm_ref)
from repro_torch.launch import train
from repro_torch.models import Model
from repro_torch.models.common import cross_entropy, tree_items
from repro_torch.models.weights import params_from_numpy, state_from_numpy
from repro_torch.optim import AdamW, cosine_schedule

TOL = 3e-5


def _close(got: torch.Tensor, want, what: str = "") -> None:
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL, err_msg=what)


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_cross_entropy_matches_jax(z_loss):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 7, 50)) * 4).astype(np.float32)
    targets = rng.integers(0, 50, (2, 7))
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(targets), z_loss=z_loss)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets), z_loss=z_loss)
    _close(got, want)
    # its gradient too: softmax - onehot, over the token count
    lt = torch.from_numpy(logits).requires_grad_()
    (g,) = torch.autograd.grad(cross_entropy(lt, torch.from_numpy(targets), z_loss=z_loss), [lt])
    jg = jax.grad(lambda x: jax_cross_entropy(x, jnp.asarray(targets), z_loss=z_loss))(
        jnp.asarray(logits))
    _close(g, jg)


def test_cosine_schedule_matches_jax():
    lr, jlr = cosine_schedule(1e-3, 7, 40, 0.05), jax_cosine_schedule(1e-3, 7, 40, 0.05)
    for step in range(0, 50):
        np.testing.assert_allclose(lr(step), float(jlr(step)), rtol=1e-6, atol=0)


def _jax_tree(seed: int):
    jcfg = jax_get_smoke_config("qwen2-1.5b")
    tree = jax.tree.map(np.asarray, JaxModel(jcfg).init(jax.random.PRNGKey(seed)))
    return jcfg, tree


@pytest.mark.parametrize("steps", [1, 2])
def test_adamw_matches_jax_leaf_by_leaf(steps):
    """One and two AdamW steps on the smoke model's tree from the same
    gradients (scaled so the first clips and the second does not): every
    leaf of params, master, m and v, the step, grad_norm and lr."""
    jcfg, tree = _jax_tree(0)
    cfg = get_smoke_config("qwen2-1.5b")
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(lambda a, s=s: (rng.standard_normal(a.shape) * s).astype(a.dtype),
                          tree) for s in (0.3, 1e-3)][:steps]
    jopt = JaxAdamW(lr=jax_cosine_schedule(1e-2, 1, 10))
    opt = AdamW(lr=cosine_schedule(1e-2, 1, 10))
    jstate = jopt.init(jax.tree.map(jnp.asarray, tree))
    state = opt.init(params_from_numpy(tree, cfg, "cpu"))
    for g in grads:
        jstate, jm = jopt.update(jstate, jax.tree.map(jnp.asarray, g))
        state, m = opt.update(state, params_from_numpy(g, cfg, "cpu"))
        _close(m["grad_norm"], jm["grad_norm"], "grad_norm")
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-6)
    want = state_from_numpy(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    assert int(state["step"]) == int(want["step"]) == steps
    for k in ("params", "master", "m", "v"):
        got = dict(tree_items(state[k]))
        for path, w in tree_items(want[k]):
            _close(got[path], w.numpy(), f"{k}{path}")
    # the master is a copy: params and master are separate storage
    assert all(p.data_ptr() != w.data_ptr() for (_, p), (_, w) in
               zip(tree_items(state["params"]), tree_items(state["master"])))


# -- the plain backwards of K1 and K2 ----------------------------------------------

# (with a residual, gemma's 1 + scale, the residual output wanted)
NORM_MODES = [(True, False, True), (True, False, False), (False, False, False),
              (False, True, False), (True, True, True)]


def _norm_inputs(rng, with_r: bool, rows=(3, 5), d=48):
    x = rng.standard_normal((*rows, d)).astype(np.float32)
    r = rng.standard_normal((*rows, d)).astype(np.float32) if with_r else None
    scale = rng.normal(0, 0.5, d).astype(np.float32)
    return x, r, scale


@pytest.mark.parametrize("with_r,gemma,want", NORM_MODES)
def test_rmsnorm_bwd_ref_matches_jax_vjp(with_r, gemma, want):
    """K1's plain backward against ``jax.vjp`` of the reference's oracles:
    the kernel's ``rmsnorm_ref`` where a residual is added (without Gemma,
    its only mode), ``rms_norm`` for the norm alone and Gemma's scale."""
    rng = np.random.default_rng(2)
    x, r, scale = _norm_inputs(rng, with_r)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    dh = rng.standard_normal(x.shape).astype(np.float32) if with_r and want else None
    if with_r and not gemma:
        y_h, vjp = jax.vjp(lambda a, b, s: jax_rmsnorm_ref(a, b, s), x, r, scale)
        jdx, jdr, jds = vjp((dy, np.zeros_like(x) if dh is None else dh))
    else:
        def f(a, b, s):
            h = a if b is None else a + b
            return jax_rms_norm(h, s, 1e-6, gemma=gemma), h
        _, vjp = jax.vjp(lambda a, s: f(a, r, s), x, scale)
        jdx, jds = vjp((dy, np.zeros_like(x) if dh is None else dh))
        jdr = jdx
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    dx, dscale = rmsnorm_bwd_ref(t(x), t(r), t(scale), t(dy), t(dh), gemma=gemma)
    _close(dx, jdx, "dx")
    _close(dx, jdr, "dr")
    _close(dscale, jds, "dscale")
    # the CPU wrapper is the plain backward itself
    dx2, ds2 = rmsnorm_bwd(t(x), t(r), t(scale), t(dy), t(dh), gemma=gemma)
    assert torch.equal(dx, dx2) and torch.equal(dscale, ds2)


@pytest.mark.parametrize("with_r,gemma,want", NORM_MODES)
def test_rmsnorm_function_matches_autograd(with_r, gemma, want, monkeypatch):
    """``_RMSNormFn`` (K1 with K1-bwd) on CPU tensors, its forward launch
    replaced by the plain version and its backward taking the plain
    backward: the same outputs and gradients as autograd through
    ``rmsnorm_ref``, whichever outputs the loss reads."""
    plain_kernel_forwards(monkeypatch)
    rng = np.random.default_rng(3)
    x, r, scale = (None if a is None else torch.from_numpy(a).requires_grad_()
                   for a in _norm_inputs(rng, with_r))
    w1, w2 = (torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
              for _ in range(2))
    ins = [a for a in (x, r, scale) if a is not None]
    y, h = rmsnorm_ref(x, r, scale, gemma=gemma, want_residual=want)
    want_g = torch.autograd.grad((y * w1).sum() + (0 if h is None else (h * w2).sum()), ins)
    out = _RMSNormFn.apply(x, r, scale, 1e-6, gemma, want)
    y2, h2 = out if isinstance(out, tuple) else (out, x if want else None)
    assert torch.equal(y2, y)
    got_g = torch.autograd.grad((y2 * w1).sum() + (0 if h2 is None else (h2 * w2).sum()), ins)
    for a, b in zip(got_g, want_g):
        _close(a, b.numpy())


def test_rmsnorm_bwd_blocks_rule():
    """K1-bwd's grid: a row takes the least power of two of lanes from 8 to
    256 that holds it in 32 values a lane, a block of 256 threads 256 /
    lanes rows (32 at D <= 256, 4 at D = 1536, 1 at 8192); at most 2
    blocks a multiprocessor; never 0."""
    assert [rmsnorm_bwd_lanes(d) for d in (48, 128, 256, 257, 512, 1536, 2048, 4096, 8192)] \
        == [8, 8, 8, 16, 16, 64, 64, 128, 256]
    assert rmsnorm_bwd_blocks(98304, 128, 132) == 264
    assert rmsnorm_bwd_blocks(37, 128, 132) == 2
    assert rmsnorm_bwd_blocks(37, 1536, 132) == 10
    assert rmsnorm_bwd_blocks(8192, 1536, 132) == 264
    assert rmsnorm_bwd_blocks(1, 8192, 132) == 1


FLASH_CASES = [(2, 4, 2, 9, 9, True), (1, 6, 2, 5, 11, True), (2, 2, 1, 11, 4, True),
               (1, 4, 4, 7, 13, False), (2, 8, 1, 6, 6, False)]


@pytest.mark.parametrize("b,h,kv,sq,sk,causal", FLASH_CASES)
def test_flash_attention_bwd_ref_matches_jax_vjp(b, h, kv, sq, sk, causal):
    """K2's plain backward against ``jax.vjp`` of the reference's oracle:
    GQA, top-left causal with Sq != Sk both ways, and non-causal."""
    rng = np.random.default_rng(4)
    hd = 16
    q = rng.standard_normal((b, h, sq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, kv, sk, hd)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((b, h, sq, hd)).astype(np.float32)
    o, vjp = jax.vjp(lambda a, c, e: jax_flash_ref(a, c, e, causal=causal), q, k, v)
    jdq, jdk, jdv = vjp(do)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    to = flash_attention_ref(tq, tk, tv, causal=causal)
    _close(to, o, "o")
    dq, dk, dv = flash_attention_bwd_ref(tq, tk, tv, to, tdo, causal=causal)
    _close(dq, jdq, "dq")
    _close(dk, jdk, "dk")
    _close(dv, jdv, "dv")
    got = flash_attention_bwd(tq, tk, tv, to, tdo, None, causal=causal)
    assert all(torch.equal(a, c) for a, c in zip(got, (dq, dk, dv)))


@pytest.mark.parametrize("b,h,kv,sq,sk,causal", FLASH_CASES[:3])
def test_flash_function_matches_autograd(b, h, kv, sq, sk, causal, monkeypatch):
    """``_FlashFn`` (K2 with K2-bwd) on CPU tensors, its forward launch
    replaced by the plain version, against autograd through
    ``flash_attention_ref``."""
    plain_kernel_forwards(monkeypatch)
    g = torch.Generator().manual_seed(5)
    q = torch.randn(b, h, sq, 16, generator=g).requires_grad_()
    k, v = (torch.randn(b, kv, sk, 16, generator=g).requires_grad_() for _ in range(2))
    do = torch.randn(b, h, sq, 16, generator=g)
    want = torch.autograd.grad(flash_attention_ref(q, k, v, causal=causal), [q, k, v], do)
    got = torch.autograd.grad(_FlashFn.apply(q, k, v, causal, None), [q, k, v], do)
    for a, c in zip(got, want):
        _close(a, c.numpy())


# -- configs and the launcher ------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_reference(arch):
    for jax_cfg, cfg in ((jax_get_config(arch), get_config(arch)),
                         (jax_get_smoke_config(arch), get_smoke_config(arch))):
        assert cfg.param_count() == jax_cfg.param_count()
        assert cfg.active_param_count() == jax_cfg.active_param_count()


def test_qwen2_full_width_param_count_is_the_tentpoles():
    """The trained config: 1.544 B parameters, every one a leaf of init."""
    cfg = get_config("qwen2-1.5b")
    assert round(cfg.param_count() / 1e9, 3) == 1.544


def test_model_refuses_xlstm_training_on_the_card():
    """K5 has no backward kernel: on a CUDA device without ``plain`` the
    xLSTM family's loss and forward raise at entry, naming it (the check
    reads the model's device; no card is needed to reach it)."""
    m = Model(get_smoke_config("xlstm-1.3b"), device="cpu")
    m.device = torch.device("cuda")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    for call in (m.loss, m.forward):
        with pytest.raises(NotImplementedError, match="K5"):
            call({}, batch)
    m.plain = True     # the plain path is the caller's explicit choice
    m.device = torch.device("cpu")
    params = m.init(0)
    assert torch.isfinite(m.loss(params, batch))


@pytest.mark.parametrize("data", ["in-process", "zero-copy"])
def test_launch_train_smoke_on_cpu_resumes(tmp_path, data):
    """``launch.train --size smoke --device cpu``: 3 steps, a checkpoint
    every 2, then a second run to 5 from the same directory resumes at
    step 4 with its data cursor."""
    args = ["--size", "smoke", "--device", "cpu", "--batch", "2", "--seq", "32",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path), "--data", data]
    s1 = train.main(args + ["--steps", "3"])
    assert s1["steps"] == 3 and np.isfinite(s1["loss_last"])
    s2 = train.main(args + ["--steps", "5"])
    assert s2["steps"] == 5 and np.isfinite(s2["loss_last"])
