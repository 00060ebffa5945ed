"""The port's optimizers against the JAX package's, step for step on the
same parameters and the same fixed gradients (numpy, seeded): AdamW,
Adafactor and SGD, each with gradient compression off, bf16 and int8;
the warmup+cosine schedule; global-norm clipping; the state's layout.

Each step's update (new minus old parameters) agrees with the
reference's at 1e-5 relative, plus two float32 ulps of the parameter
(each package rounds p - lr * u to float32 once); measured, the
packages differ by at most 1.8e-7 relative beyond those ulps, also at
the planted near-zero gradients and through int8 quantization. So an
update that is missing, or that drops or flips weight decay (0.1 * lr
* |p| of a step), fails. The optimizer state (m, v, Adafactor's
factors) agrees at 1e-6 relative to each leaf's largest value. The
compression residual is the small difference gf - q of the error-fed
gradient gf and its quantization q, so a last-bit difference in gf (the
clip scale sums the norm in another order) shows in it whole: it agrees
at 1e-6 relative to max|gf|."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import init_params as jax_init_params
from repro.optim import optimizer as JO
from repro_torch.configs.base import TrainConfig
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.optim import optimizer as O

STEPS = 5
# a tree of dicts, a list of dicts, 1-, 2- and 3-d leaves (Adafactor
# factors the >= 2-d ones); no "layers" key, which the port's Adafactor
# stacks as the reference's blocks (tested on model params below)
SHAPES = {"embed": (24, 8),
          "groups": [{"w": (8, 12), "norm": (8,)}, {"w": (8, 12),
                                                   "norm": (8,)}],
          "head": (3, 4, 5), "bias": (1, 6)}
CFG = dict(learning_rate=1e-2, warmup_steps=2, weight_decay=0.1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one thread each, so that parallel test workers do
    not oversubscribe the cores (the fault tier's timing tests share
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _tree(v, fn) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(v, fn) for v in shapes]
    return fn(shapes)


def _params(seed):
    rng = np.random.default_rng(seed)
    return _tree(SHAPES, lambda s: rng.standard_normal(s).astype(np.float32))


def _grads(step):
    """Fixed gradients: varied scales, a few near zero, a norm above the
    clip threshold on some steps and below on others."""
    rng = np.random.default_rng(100 + step)
    scale = 0.05 if step % 2 else 2.0

    def one(s):
        g = rng.standard_normal(s).astype(np.float32) * scale
        g.reshape(-1)[::7] *= 1e-6
        return g
    return _tree(SHAPES, one)


def _to_torch(tree):
    return _tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _pairs(port, ref, path=""):
    """(path, port leaf as numpy, reference leaf as numpy) over the tree
    (the leaves of ``port`` may be tensors or arrays)."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), (path, set(port), set(ref))
        for k in ref:
            yield from _pairs(port[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            yield from _pairs(p, r, f"{path}/{i}")
    else:
        if isinstance(port, torch.Tensor):
            port = port.detach().numpy()
        yield path, np.asarray(port), np.asarray(ref)


def _state_close(port, ref, scales=None):
    """``scales``: path -> the magnitude a leaf's error is relative to,
    where that is not the leaf's own largest value."""
    for path, p, r in _pairs(port, ref):
        assert p.dtype == r.dtype and p.shape == r.shape, path
        scale = (scales or {}).get(path, np.abs(r).max())
        np.testing.assert_allclose(p, r, rtol=1e-6,
                                   atol=1e-6 * max(scale, 1e-30),
                                   err_msg=path)


def _updates_close(new, old, ref_new, ref_old, msg):
    """Each element's update ``new - old`` against the reference's
    ``ref_new - ref_old``: within 1e-5 of the reference's update plus two
    ulps of the parameter (see the module docstring)."""
    olds = {path: (c, d) for path, c, d in _pairs(old, ref_old)}
    for path, a, b in _pairs(new, ref_new):
        c, d = olds.pop(path)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        du, dr = a - c, b - d
        ulp = np.spacing(np.maximum(np.maximum(abs(a), abs(b)),
                                    np.maximum(abs(c), abs(d))))
        excess = abs(du - dr) - (1e-5 * abs(dr) + 2 * ulp)
        i = np.unravel_index(np.argmax(excess), excess.shape)
        assert excess[i] <= 0, (f"{msg} {path}: update {du[i]} against "
                                f"the reference's {dr[i]} at {i}")
    assert not olds, olds.keys()


@pytest.mark.parametrize("compression", [None, "bf16", "int8"])
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor", "sgd"])
def test_apply_updates_step_for_step(optimizer, compression):
    kw = dict(CFG, optimizer=optimizer, grad_compression=compression)
    jcfg, tcfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    jp = jax.tree.map(jnp.asarray, _params(0))
    tp = _to_torch(_params(0))
    jopt, topt = JO.init_opt_state(jcfg, jp), O.init_opt_state(tcfg, tp, period=1)
    for step in range(STEPS):
        g = _grads(step)
        # max|gf| per residual leaf: the clipped gradient plus the residual
        gf = jax.tree.map(lambda a, b: a + b, JO.clip_by_global_norm(
            jax.tree.map(jnp.asarray, g), jcfg.grad_clip)[0],
            jopt["residual"]) if compression else {}
        scales = {f"/residual{path}": np.abs(r).max()
                  for path, _, r in _pairs(gf, gf)}
        jp_old, tp_old = jp, tp
        jp, jopt, jm = JO.apply_updates(jcfg, jp, jax.tree.map(jnp.asarray,
                                                               g), jopt)
        tp, topt, tm = O.apply_updates(tcfg, tp, _to_torch(g), topt)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        _updates_close(tp, tp_old, jp, jp_old, f"step {step}")
        _state_close({k: v for k, v in topt.items() if k != "step"},
                     {k: v for k, v in jopt.items() if k != "step"}, scales)
        assert int(topt["step"]) == int(jopt["step"]) == step + 1


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor", "sgd"])
@pytest.mark.parametrize("compression", [None, "int8"])
def test_init_opt_state_layout(optimizer, compression):
    kw = dict(optimizer=optimizer, grad_compression=compression)
    jopt = JO.init_opt_state(JaxTrainConfig(**kw),
                             jax.tree.map(jnp.asarray, _params(1)))
    topt = O.init_opt_state(TrainConfig(**kw), _to_torch(_params(1)),
                             period=1)
    assert topt["step"].dtype == torch.int32 and topt["step"].shape == ()
    if compression is None:
        assert topt["residual"] == () == jopt["residual"]
    _state_close({k: v for k, v in topt.items() if k != "step"},
                 {k: v for k, v in jopt.items() if k != "step"})


@pytest.mark.parametrize("total", [10_000, 50])
def test_lr_schedule(total):
    cfg = dict(learning_rate=3e-4, warmup_steps=100)
    jlr = JO.lr_schedule(JaxTrainConfig(**cfg), total)
    tlr = O.lr_schedule(TrainConfig(**cfg), total)
    for step in (0, 1, 49, 99, 100, 101, 5_000, 9_999, 10_000, 20_000):
        j = float(jlr(jnp.asarray(step, jnp.int32)))
        t = tlr(torch.tensor(step, dtype=torch.int32))
        assert t.dtype == torch.float32
        np.testing.assert_allclose(float(t), j, rtol=1e-6, err_msg=step)
    assert float(tlr(torch.tensor(0, dtype=torch.int32))) > 0


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_by_global_norm(max_norm):
    g = _grads(0)
    jg, jn = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    given = _to_torch(g)
    tg, tn = O.clip_by_global_norm(given, max_norm)
    assert tg is given               # in place: no second copy of the grads
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(O.global_norm(tg)),
                               min(max_norm, float(jn)), rtol=1e-5)
    for path, p, r in _pairs(tg, jg):
        np.testing.assert_allclose(p, r, rtol=1e-6, atol=1e-7,
                                   err_msg=path)


def test_clip_keeps_each_gradient_dtype():
    g = {"a": torch.ones(4, dtype=torch.bfloat16) * 10,
         "b": torch.ones(3) * 10}
    out, gn = O.clip_by_global_norm(g, 1.0)
    assert out["a"].dtype == torch.bfloat16 and out["b"].dtype == \
        torch.float32
    assert gn.dtype == torch.float32


def test_update_is_functional():
    """apply_updates leaves the params and state it was given intact, so
    the trainer can retry a step from them."""
    cfg = TrainConfig(**CFG)
    tp = _to_torch(_params(2))
    opt = O.init_opt_state(cfg, tp, period=1)
    before = [t.clone() for t in O.tree_leaves((tp, opt))]
    O.apply_updates(cfg, tp, _to_torch(_grads(0)), opt)
    assert all(torch.equal(a, b)
               for a, b in zip(before, O.tree_leaves((tp, opt))))


def test_int8_compression_rounds_half_to_even():
    """int8 compression with error feedback: q + residual == g exactly
    representable parts, and ties round to even in both packages."""
    g = {"x": np.array([127.0, 63.5, -62.5, 0.5, 1.5, -0.5], np.float32)}
    r0 = {"x": np.zeros(6, np.float32)}
    jq, jr = JO.compress_grads(jax.tree.map(jnp.asarray, g),
                               jax.tree.map(jnp.asarray, r0), "int8")
    tq, tr = O.compress_grads(_to_torch(g), _to_torch(r0), "int8")
    np.testing.assert_array_equal(tq["x"].numpy(), np.asarray(jq["x"]))
    np.testing.assert_array_equal(tr["x"].numpy(), np.asarray(jr["x"]))


def test_weight_decay_reaches_every_leaf():
    """As in the reference, decay applies to norms and biases too: a zero
    gradient still shrinks every parameter."""
    cfg = TrainConfig(**dict(CFG, weight_decay=0.5))
    tp = _to_torch(_params(3))
    zero = O.tree_map(torch.zeros_like, tp)
    new, _, _ = O.apply_updates(cfg, tp, zero,
                                O.init_opt_state(cfg, tp, period=1))
    for a, b in zip(O.tree_leaves(new), O.tree_leaves(tp)):
        assert (a.abs() < b.abs()).all()


def test_unknown_compression_mode_raises():
    cfg = dataclasses.replace(TrainConfig(), grad_compression="fp8")
    tp = _to_torch(_params(4))
    with pytest.raises(ValueError, match="fp8"):
        O.apply_updates(cfg, tp, _to_torch(_grads(0)),
                        O.init_opt_state(dataclasses.replace(
                            cfg, grad_compression="bf16"), tp, period=1))


#: layers of the reduced configs below where their default is not enough:
#: Jamba at two periods, so that each (2, H) Mamba vector (a_log, d_skip,
#: dt_bias) is factored across its two layers, as in the reference
ADAFACTOR_LAYERS = {"jamba-1.5-large-398b": 16}


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma2-9b", "mixtral-8x7b",
                                  "jamba-1.5-large-398b"])
def test_adafactor_on_layers_matches_the_stacked_reference(arch):
    """Adafactor factors and RMS-clips whole tensors, and the reference's
    are stacked over the layers of a period position (a norm scale of
    each layer is one row of an (L, d) matrix). The port's per-layer
    params go through the same stacked update: each of 3 steps' updates
    and the state agree with the reference's on its own layout (gemma2:
    period 2; Mixtral: (2, E, d, f) expert tensors factored over their
    last two axes; Jamba: period 8 at two periods, Mamba and MoE)."""
    jcfg = jax_reduced(arch, n_layers=ADAFACTOR_LAYERS.get(arch))
    kw = dict(CFG, optimizer="adafactor")
    jtc, ttc = JaxTrainConfig(**kw), TrainConfig(**kw)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    period = len(jp["blocks"])
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    jopt = JO.init_opt_state(jtc, jp)
    topt = O.init_opt_state(ttc, tp, period=period)
    jupdate = jax.jit(lambda p, g, o: JO.apply_updates(jtc, p, g, o))
    for step in range(3):
        g = jax.tree.map(lambda p: jnp.sin(p * (step + 2.0)) * 0.3, jp)
        tg = from_jax_params(jax.tree.map(np.asarray, g))
        jp_old, tp_old = jp, to_jax_params(tp, period=period)
        jp, jopt, _ = jupdate(jp, g, jopt)
        tp, topt, _ = O.apply_updates(ttc, tp, tg, topt)
        _updates_close(to_jax_params(tp, period=period), tp_old, jp, jp_old,
                       f"step {step}")
        _state_close(topt["v"], jopt["v"])
    if arch == "jamba-1.5-large-398b":
        assert set(topt["v"]["blocks"]["pos0"]["mixer"]["a_log"]) == \
            {"vr", "vc"}
        assert topt["v"]["blocks"]["pos1"]["ffn"]["w_up"]["vr"].shape == \
            (2, 4, 64)
