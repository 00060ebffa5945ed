"""The port's checkpoints against the JAX package's: the same on-disk
layout, so a ``(params, opt)`` checkpoint saved by either package
restores in the other, for every optimizer's state with gradient
compression on (its residual included); identical leaf names; the
atomic commit (a partial ``step_N.tmp`` is invisible); structure and
shape mismatches rejected; ``prune``; ``extra`` round-trips. Values are
compared exactly: a checkpoint moves bytes."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jax_ckpt
from repro.configs import get_reduced_config as jax_reduced
from repro.models import init_params as jax_init_params
from repro.optim import optimizer as JO
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_reduced_config
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.optim import optimizer as O
from repro_torch.configs.base import ShapeSpec
from repro_torch.train.trainer import Trainer, state_from_jax, state_to_jax


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one thread each, so that parallel test workers do
    not oversubscribe the cores (the fault tier's timing tests share
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, optimizer):
    jcfg, tcfg = jax_reduced(arch), get_reduced_config(arch)
    kw = dict(optimizer=optimizer, grad_compression="int8")
    return (jcfg.replace(train=dataclasses.replace(jcfg.train, **kw)),
            tcfg.replace(train=dataclasses.replace(tcfg.train, **kw)))


def _jax_state(jcfg, seed=0):
    """(params, opt) of the JAX package after one update, so every state
    leaf (m, v, Adafactor's factors, the residual, step) is non-zero."""
    params = jax_init_params(jax.random.PRNGKey(seed), jcfg)
    opt = JO.init_opt_state(jcfg.train, params)
    grads = jax.tree.map(lambda p: jnp.sin(p * 3.0 + 1.0), params)
    params, opt, _ = JO.apply_updates(jcfg.train, params, grads, opt)
    return params, opt


def _port_state(tcfg, jstate):
    """The same state in the port's layout, as tensors."""
    return state_from_jax(tcfg, jax.tree.map(np.asarray, jstate), "cpu")


def _assert_equal(port_np, ref):
    """Two trees of the reference layout, numpy / jax leaves, equal."""
    pl, pd = jax.tree_util.tree_flatten_with_path(port_np)
    rl, rd = jax.tree_util.tree_flatten_with_path(ref)
    assert pd == rd
    for (path, a), (_, b) in zip(pl, rl):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))


CASES = [("qwen3-8b", "adamw"), ("qwen3-8b", "adafactor"),
         ("qwen3-8b", "sgd"), ("rwkv6-1.6b", "adamw"),
         ("mixtral-8x7b", "adamw"), ("jamba-1.5-large-398b", "adafactor")]
#: a leaf of each arch's first layer, by name in the checkpoint; the MoE
#: expert tensors are 4-D once stacked, Mamba's a_log / d_skip / dt_bias
#: fp32 (H,) vectors and conv_w (W, C)
FIRST_LEAVES = {"qwen3-8b": ("mixer$wq",), "rwkv6-1.6b": ("mixer$wr",),
                "mixtral-8x7b": ("mixer$wq", "ffn$w_up", "ffn$router"),
                "jamba-1.5-large-398b": ("mixer$a_log", "mixer$conv_w",
                                         "mixer$dt_bias")}


@pytest.mark.parametrize("arch,optimizer", CASES)
def test_leaf_names_equal_the_reference(arch, optimizer):
    jcfg, tcfg = _configs(arch, optimizer)
    jstate = _jax_state(jcfg)
    names = [n for n, _ in ckpt._flatten_with_names(
        state_to_jax(tcfg, *_port_state(tcfg, jstate)))]
    assert names == [n for n, _ in jax_ckpt._flatten_with_names(jstate)]
    for leaf in FIRST_LEAVES[arch]:
        assert "0$blocks$pos0$" + leaf in names
    assert "1$step" in names and any(n.startswith("1$residual$blocks$")
                                     for n in names)


@pytest.mark.parametrize("arch,optimizer", CASES)
def test_port_checkpoint_restores_in_jax(tmp_path, arch, optimizer):
    jcfg, tcfg = _configs(arch, optimizer)
    jstate = _jax_state(jcfg)
    params, opt = _port_state(tcfg, jstate)
    ckpt.save(str(tmp_path), 3, state_to_jax(tcfg, params, opt),
              extra={"run": "port"})
    target = _jax_state(jcfg, seed=1)
    restored, extra = jax_ckpt.restore(str(tmp_path), 3, target)
    assert extra == {"run": "port"}
    _assert_equal(restored, jstate)


@pytest.mark.parametrize("arch,optimizer", CASES)
def test_jax_checkpoint_restores_in_port(tmp_path, arch, optimizer):
    jcfg, tcfg = _configs(arch, optimizer)
    jstate = _jax_state(jcfg)
    jax_ckpt.save(str(tmp_path), 5, jstate, extra={"run": "jax"})
    assert ckpt.latest_step(str(tmp_path)) == 5
    params, opt = _port_state(tcfg, _jax_state(jcfg, seed=1))
    tree, extra = ckpt.restore(str(tmp_path), 5,
                               state_to_jax(tcfg, params, opt))
    assert extra == {"run": "jax"}
    params, opt = state_from_jax(tcfg, tree, "cpu")
    assert params["layers"][0]["norm1"]["scale"].dtype == torch.float32
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 1
    _assert_equal(state_to_jax(tcfg, params, opt), jstate)


def test_to_jax_params_inverts_from_jax_params():
    jcfg = jax_reduced("gemma2-9b")     # a period of 2 (local / global)
    ref = jax.tree.map(np.asarray,
                       jax_init_params(jax.random.PRNGKey(0), jcfg))
    assert len(ref["blocks"]) == 2
    port = from_jax_params(ref)
    assert len(port["layers"]) == jcfg.model.num_layers
    _assert_equal(to_jax_params(port, period=2), ref)


def test_moe_and_mamba_leaves_convert_both_ways():
    """Jamba at two periods: the expert tensors are 4-D once stacked
    (period, E, d, f) and 3-D a layer; Mamba's a_log / d_skip / dt_bias
    are fp32 (H,) a layer and conv_w (W, C); the round trip is exact."""
    jcfg = jax_reduced("jamba-1.5-large-398b", n_layers=16)
    ref = jax.tree.map(np.asarray,
                       jax_init_params(jax.random.PRNGKey(0), jcfg))
    assert ref["blocks"]["pos1"]["ffn"]["w_up"].ndim == 4
    port = from_jax_params(ref)
    m = jcfg.model
    layer = port["layers"][9]                 # pos 1 of the second period
    assert tuple(layer["ffn"]["w_up"].shape) == (
        m.moe.num_experts, m.d_model, m.moe.d_ff_expert)
    np.testing.assert_array_equal(layer["ffn"]["w_down"].numpy(),
                                  ref["blocks"]["pos1"]["ffn"]["w_down"][1])
    mixer = port["layers"][8]["mixer"]
    H = 2 * m.d_model // 64
    for k in ("a_log", "d_skip", "dt_bias"):
        assert tuple(mixer[k].shape) == (H,) and \
            mixer[k].dtype == torch.float32
    assert tuple(mixer["conv_w"].shape) == (m.ssm.d_conv, 2 * m.d_model)
    _assert_equal(to_jax_params(port, period=8), ref)


def test_tensor_leaves_restore_on_the_target_device_and_dtype(tmp_path):
    tree = {"b": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "a": [torch.ones(2, dtype=torch.bfloat16),
                  torch.tensor(7, dtype=torch.int32)]}
    ckpt.save(str(tmp_path), 1, tree)
    names = json.load(open(tmp_path / "step_1" / "manifest.json"))["leaves"]
    assert names == ["a$0", "a$1", "b"]        # sorted keys, as JAX's
    target = {"b": torch.zeros(2, 3, dtype=torch.float64),
              "a": [torch.zeros(2, dtype=torch.bfloat16),
                    torch.zeros((), dtype=torch.int32)]}
    back, extra = ckpt.restore(str(tmp_path), 1, target)
    assert list(back) == ["b", "a"] and extra == {}
    assert back["b"].dtype == torch.float64
    assert torch.equal(back["b"], tree["b"].double())
    assert back["a"][0].dtype == torch.bfloat16
    assert torch.equal(back["a"][0], tree["a"][0])
    assert int(back["a"][1]) == 7


def test_partial_write_invisible(tmp_path):
    tree = {"w": np.ones((2, 2), np.float32)}
    ckpt.save(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / "step_2.tmp")      # a save cut mid-write
    (tmp_path / "step_2.tmp" / "w.npy").write_bytes(b"partial")
    os.makedirs(tmp_path / "step_3")          # committed name, no manifest
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert jax_ckpt.latest_step(str(tmp_path)) == 1
    ckpt.save(str(tmp_path), 2, tree)         # a retried save replaces it
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert not (tmp_path / "step_2.tmp").exists()


def test_structure_mismatch_rejected(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": np.ones((2, 2), np.float32),
                                 "b": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(str(tmp_path), 1, {"w": np.ones((2, 2), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 1, {"w": np.ones((2, 3), np.float32),
                                        "b": np.zeros(2, np.float32)})


def test_prune_keeps_newest(tmp_path):
    for s in (1, 2, 3, 10, 11):
        ckpt.save(str(tmp_path), s, {"x": np.full(2, s, np.float32)})
    ckpt.prune(str(tmp_path), keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_10", "step_11"]
    assert ckpt.latest_step(str(tmp_path)) == 11
    ckpt.prune(str(tmp_path / "missing"))     # no directory: nothing to do


def test_extra_round_trips(tmp_path):
    extra = {"run_id": "r-42", "cursor": 17, "nested": {"a": [1, 2]}}
    ckpt.save(str(tmp_path), 4, {"x": np.zeros(1, np.float32)}, extra=extra)
    _, back = ckpt.restore(str(tmp_path), 4, {"x": np.zeros(1, np.float32)})
    assert back == extra
    _, jback = jax_ckpt.restore(str(tmp_path), 4,
                                {"x": jnp.zeros(1, jnp.float32)})
    assert jback == extra


def test_params_shaped_trees_with_dict_leaves_convert():
    """to_jax_params / from_jax_params take any params-shaped tree, also
    one whose leaves are dicts."""
    params = from_jax_params(jax.tree.map(np.asarray, jax_init_params(
        jax.random.PRNGKey(0), jax_reduced("qwen3-8b"))))
    tree = O.tree_map(lambda t: {"a": t, "b": t * 2}, params)
    ref = to_jax_params(tree, period=1)
    assert ref["blocks"]["pos0"]["mixer"]["wq"]["b"].shape[0] == \
        len(params["layers"])
    back = from_jax_params(ref)
    assert all(torch.equal(a, b) for a, b in zip(O.tree_leaves(back),
                                                 O.tree_leaves(tree)))


@pytest.mark.parametrize("arch,optimizer", [("qwen3-8b", "adafactor"),
                                           ("gemma2-9b", "adamw")])
def test_restore_target_holds_shapes_only(arch, optimizer):
    """The trainer restores into a target drawn on the meta device: the
    leaf names, shapes and dtypes of the reference's state (gemma2: a
    period of 2), and no data (every array has zero strides)."""
    jcfg, tcfg = _configs(arch, optimizer)
    shape = ShapeSpec("t", seq_len=8, global_batch=1, kind="train")
    target = Trainer(tcfg, shape, device="cpu").restore_target()
    named = ckpt._flatten_with_names(target)
    ref = jax_ckpt._flatten_with_names(_jax_state(jcfg))
    assert [n for n, _ in named] == [n for n, _ in ref]
    for (name, a), (_, b) in zip(named, ref):
        assert a.shape == np.shape(b) and a.dtype == np.asarray(b).dtype, \
            name
        assert not any(a.strides), name


def test_adafactor_state_keeps_the_stacked_layout():
    """Adafactor's state lives in the reference's stacked layout (it
    factors whole stacked tensors), so it checkpoints without
    conversion: a per-layer norm scale's factors span the layers."""
    jcfg, tcfg = _configs("qwen3-8b", "adafactor")
    params, opt = _port_state(tcfg, _jax_state(jcfg))
    L = tcfg.model.num_layers
    assert opt["v"]["blocks"]["pos0"]["norm1"]["scale"]["vr"].shape == (L,)
    assert opt["v"]["blocks"]["pos0"]["mixer"]["wq"]["vr"].shape == \
        (L, tcfg.model.d_model)
    assert "layers" in params and "m" not in opt
