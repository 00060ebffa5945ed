"""The port's logical-axis rules (``parallel/sharding.py``), its
parameter and state axes (``models/model.py``) and the mesh helpers
that need no process group, against the reference's, in one process.
The 2 x 2 mesh itself runs in tests/test_torch_mesh.py."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_reduced_config as jax_reduced
from repro.models import model as jax_model
from repro.parallel import sharding as jax_sharding
from repro_torch.configs import get_reduced_config, list_archs
from repro_torch.kernels.flash_attention.ops import kv_for_heads
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as S
from repro_torch.models import model as M
from repro_torch.models.attention import repeat_kv
from repro_torch.parallel import sharding as sh

LOGICAL = ("batch", "seq", "heads", "kv_heads", "d_ff", "vocab", "expert",
           "fsdp", "kv_seq", "kv_seq_all", "layers", None)
KNOBS = list(itertools.product((("data",), ("pod", "data")), (False, True),
                               ("tp", "ep"), (True, False)))


class _PortMesh:
    """A stand-in DeviceMesh: named dims and their sizes."""

    def __init__(self, shape, names):
        self.mesh_dim_names, self._shape = tuple(names), tuple(shape)
        self.ndim = len(shape)

    def size(self, i):
        return self._shape[i]


class _JaxMesh:
    """A stand-in jax Mesh: ``axis_names`` and ``shape`` by name."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


@pytest.mark.parametrize("batch_axes,fsdp,es,kv", KNOBS)
def test_axis_and_spec_equal_the_reference(batch_axes, fsdp, es, kv):
    kw = dict(mesh=None, batch_axes=batch_axes, fsdp=fsdp,
              expert_sharding=es, shard_kv_heads=kv)
    port, ref = sh.ParallelCtx(**kw), jax_sharding.ParallelCtx(**kw)
    for name in LOGICAL:
        assert port.axis(name) == ref.axis(name), name
    assert port.spec(*LOGICAL) == tuple(ref.spec(*LOGICAL))
    with pytest.raises(KeyError):
        port.axis("nope")


MESHES = [((2, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")), ((1, 3), ("data", "model")),
          ((2, 1, 3), ("pod", "data", "model"))]


@pytest.mark.parametrize("shape,names", MESHES)
def test_make_ctx_equals_the_reference(shape, names):
    """Per registry config, including the ep -> tp fallback where the
    experts do not divide over model (4 experts over 16 or 3)."""
    fell_back = 0
    for arch in list_archs():
        for es in (None, "tp", "ep"):
            cfg = get_reduced_config(arch)
            cfg = cfg.replace(parallel=dataclasses.replace(
                cfg.parallel, expert_sharding=es))
            jcfg = jax_reduced(arch)
            jcfg = jcfg.replace(parallel=dataclasses.replace(
                jcfg.parallel, expert_sharding=es))
            port = sh.make_ctx(cfg, _PortMesh(shape, names))
            ref = jax_sharding.make_ctx(jcfg, _JaxMesh(shape, names))
            for f in ("batch_axes", "model_axis", "fsdp", "ps_mode",
                      "expert_sharding", "seq_shard_prefill",
                      "seq_shard_kv_decode", "shard_kv_heads"):
                assert getattr(port, f) == getattr(ref, f), (arch, es, f)
            n_b = int(np.prod([dict(zip(names, shape))[a]
                               for a in port.batch_axes]))
            assert port.n_batch_shards == n_b
            assert port.n_model_shards == dict(zip(names, shape))["model"]
            fell_back += (es == "ep" and cfg.model.moe is not None
                          and port.expert_sharding == "tp")
    # the reduced MoE configs have 4 experts
    assert (fell_back > 0) == (4 % shape[-1] != 0)


def test_no_mesh():
    x = torch.ones(2, 3)
    assert sh.NO_MESH.constrain(x, "batch", None) is x
    assert sh.NO_MESH.n_batch_shards == sh.NO_MESH.n_model_shards == 1
    assert sh.make_ctx(get_reduced_config("qwen3-8b"), None).mesh is None
    with pytest.raises(ValueError):
        sh.tree_shardings(sh.NO_MESH, {"w": sh.LP("fsdp", "heads")})


def test_placements_follow_the_mesh_dims():
    mesh = _PortMesh((2, 2, 2), ("pod", "data", "model"))
    ctx = sh.ParallelCtx(mesh=mesh, batch_axes=("pod", "data"), fsdp=True)
    assert ctx.placements("batch", None, "heads") == (Shard(0), Shard(0),
                                                      Shard(2))
    assert ctx.placements("fsdp", "d_ff") == (Shard(0), Shard(0), Shard(1))
    assert ctx.placements(None, "kv_seq", None, None) == (
        Replicate(), Replicate(), Shard(1))
    assert ctx.placements(None, "kv_seq_all", None, None) == (
        Shard(1), Shard(1), Shard(1))
    flat = sh.ParallelCtx(mesh=_PortMesh((2, 2), ("data", "model")))
    assert flat.placements("fsdp", "heads") == (Replicate(), Shard(1))
    tree = {"a": [sh.LP("fsdp", None), sh.LP("vocab",)], "b": sh.LP()}
    assert sh.logical_to_physical(flat, tree) == {
        "a": [(None, None), ("model",)], "b": ()}
    assert sh.tree_shardings(flat, tree) == {
        "a": [(Replicate(), Replicate()), (Replicate(), Shard(0))],
        "b": (Replicate(), Replicate())}


def _zip_leaves(tree, axes, fn, path=""):
    """``fn(path, leaf, lp)`` over a tree and its axes, which must have
    the same structure."""
    if isinstance(tree, sh.LP) or isinstance(axes, sh.LP):
        fn(path, tree, axes)
    elif isinstance(tree, dict):
        assert set(tree) == set(axes), (path, set(tree) ^ set(axes))
        for k in tree:
            _zip_leaves(tree[k], axes[k], fn, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        assert len(tree) == len(axes), path
        for i, (a, b) in enumerate(zip(tree, axes)):
            _zip_leaves(a, b, fn, f"{path}/{i}")
    else:
        fn(path, tree, axes)


def _rank_of(path, leaf, lp):
    assert isinstance(lp, sh.LP), (path, lp)
    assert len(lp) == (leaf.dim() if isinstance(leaf, torch.Tensor) else 0), \
        (path, lp)


@pytest.mark.parametrize("arch", list_archs())
def test_param_logical_axes_match_init_params_and_the_reference(arch):
    cfg = get_reduced_config(arch)
    axes = M.param_logical_axes(cfg)
    params = M.init_params(cfg, device="meta", generator=None)
    _zip_leaves(params, axes, _rank_of)
    ref = jax_model.param_logical_axes(jax_reduced(arch))
    period = cfg.model.pattern_period
    for li, layer in enumerate(axes["layers"]):
        def same(path, port_lp, ref_lp):
            assert tuple(ref_lp)[0] == "layers", path
            assert tuple(port_lp) == tuple(ref_lp)[1:], (li, path)
        _zip_leaves(layer, ref["blocks"][f"pos{li % period}"], same)
    for k in ("embed", "lm_head"):
        if k in ref:
            assert tuple(axes[k]) == tuple(ref[k])
    assert set(axes) == set(ref) - {"blocks"} | {"layers"}


@pytest.mark.parametrize("vocab,sharded", [(4096, True), (151936, True),
                                           (4100, False), (2048, False),
                                           (504, False)])
def test_vocab_shards_only_when_it_divides_16_and_is_large(vocab, sharded):
    cfg = get_reduced_config("qwen3-8b")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, vocab_size=vocab))
    axes = M.param_logical_axes(cfg)
    ref = jax_model.param_logical_axes(jax_reduced("qwen3-8b").replace(
        model=dataclasses.replace(jax_reduced("qwen3-8b").model,
                                  vocab_size=vocab)))
    assert (axes["embed"][0] == "vocab") == sharded
    assert tuple(axes["embed"]) == tuple(ref["embed"])
    assert tuple(axes["lm_head"]) == tuple(ref["lm_head"])


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("batch", [1, 4])
def test_state_logical_axes_match_init_states_and_the_reference(arch, batch):
    cfg = get_reduced_config(arch)
    axes = M.state_logical_axes(cfg, batch)
    states = M.init_states(cfg, batch, 16, device="cpu")
    _zip_leaves(states, axes, _rank_of)
    ref = jax_model.state_logical_axes(jax_reduced(arch), batch)
    period = cfg.model.pattern_period
    for li, layer in enumerate(axes):
        def same(path, port_lp, ref_lp):
            assert tuple(ref_lp)[0] == "layers", path
            assert tuple(port_lp) == tuple(ref_lp)[1:], (li, path)
        _zip_leaves(layer, ref[f"pos{li % period}"], same)


# (query heads, KV heads, model shards)
KV_CASES = [(4, 1, 2), (4, 2, 2), (4, 4, 2), (32, 8, 16), (8, 2, 4),
            (6, 2, 3), (12, 4, 2), (12, 4, 3), (32, 8, 1)]


@pytest.mark.parametrize("H,KV,m", KV_CASES)
def test_each_query_head_meets_its_kv_head_on_its_shard(H, KV, m):
    """``kv_for_heads`` on each shard's query heads, given every KV head
    (replicated over model) or, where KV divides, the shard's own: local
    query head i, read through the kernel's GQA rule (i // (n_q // kv)),
    meets global KV head (head0 + i) // (H // KV)."""
    rng = np.random.default_rng(H * 100 + KV * 10 + m)
    k = torch.from_numpy(rng.standard_normal((1, 5, KV, 8)).astype(
        np.float32))
    v = k + 1.0
    n_q = H // m
    want = repeat_kv(k, H // KV)
    for r in range(m):
        head0 = r * n_q
        givens = [k]
        if KV % m == 0:
            givens.append(k[:, :, r * KV // m:(r + 1) * KV // m])
        for given in givens:
            vg = given + 1.0
            ks, vs = kv_for_heads(given, vg, head0, n_q, H, KV)
            assert n_q % ks.shape[2] == 0
            got = repeat_kv(ks, n_q // ks.shape[2])
            torch.testing.assert_close(got, want[:, :, head0:head0 + n_q],
                                       rtol=0, atol=0)
            torch.testing.assert_close(
                repeat_kv(vs, n_q // vs.shape[2]),
                repeat_kv(v, H // KV)[:, :, head0:head0 + n_q], rtol=0,
                atol=0)


def test_mesh_needs_its_ranks():
    """Without a process group of the mesh's size the mesh constructors
    raise, naming both sizes (the production mesh its 256 / 512)."""
    with pytest.raises(ValueError, match="needs 256 ranks"):
        mesh_lib.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        mesh_lib.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match=r"mesh \(2, 2\) needs 4 ranks"):
        mesh_lib.make_test_mesh(2, 2)
    with pytest.raises(ValueError, match=r"needs 8 ranks"):
        mesh_lib.make_test_mesh(2, 2, pod=2)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_recurrent_mixers_are_refused_under_a_mesh(arch):
    """No step builder refuses the rwkv and mamba mixers under a mesh
    any more, and their decode states split by head over ``model`` as
    the reference lays them out (the 2 x 2 runs are in
    tests/test_torch_mesh.py)."""
    cfg = get_reduced_config(arch)
    ctx = sh.ParallelCtx(mesh=_PortMesh((1, 1), ("data", "model")))
    for build in (lambda: S.make_train_step(cfg, ctx),
                  lambda: S.make_prefill_step(cfg, 8, ctx),
                  lambda: S.make_decode_step(cfg, 2, ctx)):
        assert callable(build())
    kind = cfg.model.layer_pattern[0]
    ax = M.state_logical_axes(cfg, 2, ctx)[0]["mixer"]
    head = ax["S"] if kind == "rwkv" else ax["h"]
    assert head == sh.LP("batch", "heads", None, None)
    ref = jax_model.state_logical_axes(jax_reduced(arch), 2)["pos0"][
        "mixer"]
    assert {k: tuple(v)[1:] for k, v in ref.items()} == \
        {k: tuple(v) for k, v in ax.items()}
