"""The port's analysis tooling (``launch/specs.py``, ``dryrun.py``,
``roofline.py``, ``hlo.py``) against the reference's and against
counts written out by hand.

A fake process group (``launch.mesh.init_fake``) must have a process of
its own, so two subprocesses start together in a module fixture, each
on one thread (the tier-1 run shares the machine's cores):

- this file run as a script (``python tests/test_torch_dryrun.py OUT``),
  with jax and repro blocked: the reference's
  ``test_dryrun_small_mesh_all_kinds`` matrix on fake (2, 2) and (2, 2,
  2) meshes with each argument's bytes per device, a reduced MoE with
  Adafactor at 1 and 2 layers, the optimizer's ``_like`` under
  ``MemTracker``, a DTensor product counted per device, then the dry-run
  CLI on the production (16, 16) mesh for qwen3-8b ``train_4k``;
- in JAX on 512 forced host devices (what the reference's dry run
  forces): the reference's ``_analytic_bytes_per_device``, and its
  reduced train and decode steps compiled on a (2, 2) mesh, with each
  argument's bytes per device and XLA's ``argument_size_in_bytes``.

The counts with no mesh run here, on fake tensors (no process group).
"""
import dataclasses
import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
TIMEOUT = 300

ARCHS = ("qwen3-8b", "mixtral-8x7b", "rwkv6-1.6b")
KINDS = (("train_4k", "train"), ("prefill_32k", "prefill"),
         ("decode_32k", "decode"))
MESHES = ((2, 2, None), (2, 2, 2))
ANALYTIC = [(a, s) for a in ARCHS for s in ("train_4k", "decode_32k")]
# the argument bytes held against XLA's: the reduced cells of the (2, 2)
# mesh at the kinds that take resident state
ARG_KINDS = (("train_4k", "train"), ("decode_32k", "decode"))
# the hillclimb knobs (``run_cell``'s ``overrides``) applied to these archs
# on both sides, and the qwen3-8b train_4k variants the CLI's subprocess
# runs on the production mesh through ``--override`` / ``--variant``, cut
# to 2 layers by an override
OVERRIDES = {"train.remat": False, "parallel.fsdp": True}
OVERRIDE_ARCHS = ("qwen3-8b", "mixtral-8x7b")
VARIANTS = (("l2", ["model.num_layers=2"]),
            ("l2_noremat", ["model.num_layers=2", "train.remat=false"]))
# a reduced MoE that trains with Adafactor, at these depths
MOE_ARCH, MOE_LAYERS = "kimi-k2-1t-a32b", (1, 2)
# (global shape, placements over the (data, model) mesh) of a parameter,
# and the dim that Adafactor's factored statistics reduce (or None)
LIKE_CASES = (((4, 6), ("S0", "S1"), 1), ((4, 6), ("S0", "S1"), 0),
              ((3, 5, 8), ("R", "S2"), 1), ((7,), ("S0", "R"), None),
              ((2, 1, 6), ("R", "R"), 2))

_BLOCK_JAX = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
"""

_JAX_ANALYTIC = """
import json, os, sys
from repro.launch import dryrun as D    # forces 512 host devices
from repro.configs import get_config, get_shape
from repro.launch.mesh import make_production_mesh
from repro.parallel.sharding import make_ctx
out = {}
mesh = make_production_mesh()
for arch, shape in %r:
    cfg = get_config(arch)
    out[arch + "/" + shape] = D._analytic_bytes_per_device(
        make_ctx(cfg, mesh), cfg, get_shape(shape))
# the reduced train and decode steps compiled on a (2, 2) mesh, as the
# reference's dry run compiles its cells (repro/launch/dryrun.py
# run_cell); its mesh axes Auto, as tests/_jax_mesh_cases.py builds them
import dataclasses, jax, numpy as np
from jax.sharding import AxisType
from repro.configs import get_reduced_config
from repro.launch import specs as SP, steps as ST
small = jax.make_mesh((2, 2), ("data", "model"),
                      axis_types=(AxisType.Auto,) * 2)
for arch in %r:
    cfg = get_reduced_config(arch, n_layers=2)
    ctx = make_ctx(cfg, small)
    for name, kind in %r:
        shape = dataclasses.replace(get_shape(name), seq_len=64,
                                    global_batch=8)
        with small:
            step = (ST.make_train_step(ctx, cfg, donate=False)
                    if kind == "train" else
                    ST.make_decode_step(ctx, cfg, shape.global_batch))
            args = SP.input_specs(ctx, cfg, shape)
            compiled = step.lower(*args).compile()
        leaves = {}
        for i, (a, shs) in enumerate(zip(args, compiled.input_shardings[0])):
            flat = jax.tree.flatten_with_path(a)[0]
            shs = jax.tree.leaves(shs, is_leaf=lambda x: hasattr(
                x, "shard_shape"))
            assert len(flat) == len(shs)
            for (path, leaf), s in zip(flat, shs):
                key = str(i) + jax.tree_util.keystr(path)
                leaves[key] = int(np.prod(s.shard_shape(leaf.shape))) * \
                    leaf.dtype.itemsize
        out["args/" + arch + "/" + kind] = {
            "argument_size_in_bytes":
                compiled.memory_analysis().argument_size_in_bytes,
            "leaves": leaves}
# the hillclimb knobs: the overridden configs and the variant's file name
for arch in %r:
    out["overrides/" + arch] = dataclasses.asdict(
        D._apply_overrides(get_config(arch), %r))
out["cell_path"] = {v: os.path.basename(D._cell_path(
    "qwen3-8b", "train_4k", "pod16x16", v)) for v in ("", "l2_noremat")}
json.dump(out, open(sys.argv[1], "w"), default=str)
"""


def _small_shape(name, kind):
    from repro_torch.configs import get_shape
    return dataclasses.replace(get_shape(name), seq_len=64,
                               global_batch=8 if kind != "prefill" else 4)


def _arg_bytes(args):
    """Each argument leaf's bytes on this rank, keyed by its argument
    index and tree path."""
    import torch
    from torch.utils._pytree import keystr, tree_flatten_with_path
    out = {}
    for i, a in enumerate(args):
        for path, t in tree_flatten_with_path(a)[0]:
            if isinstance(t, torch.Tensor):
                t = getattr(t, "_local_tensor", t)
                out[str(i) + keystr(path)] = t.numel() * t.element_size()
    return out


def _like_cases(mesh):
    """``optimizer._like`` on the fake mesh: what it returns for each
    case of ``LIKE_CASES``, the stride the code before it read from a
    ``meta`` stand-in, and the devices ``MemTracker`` saw while it ran."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.optim import optimizer as O

    def pl(names):
        return tuple(Replicate() if n == "R" else Shard(int(n[1:]))
                     for n in names)
    out = []
    with FakeTensorMode(allow_non_fake_inputs=True):
        for shape, pls, dim in LIKE_CASES:
            ref = DTensor.from_local(
                torch.empty(shape), mesh, pl("RR"), run_check=False
            ).redistribute(mesh, pl(pls))
            t = torch.zeros(ref.to_local().shape)
            forms = [(t, None, None)]
            if dim is not None:
                rpl, rshape = O._without_dim(ref, dim)
                forms.append((torch.zeros(t.shape[:dim] + t.shape[dim + 1:]),
                              rpl, rshape))
            mt = MemTracker()
            mt.track_external(*[f[0] for f in forms])
            with mt:
                before = mt.get_tracker_snapshot("current")
                got = [O._like(x, ref, p, s) for x, p, s in forms]
                after = mt.get_tracker_snapshot("current")
            peak = mt.get_tracker_snapshot("peak")
            # what the code before read: the stride of a meta stand-in
            want = [(list(s or shape), [str(q) for q in (p or pl(pls))],
                     list(torch.empty(s or shape, device="meta").stride()))
                    for _, p, s in forms]
            out.append({
                "got": [(list(g.shape), [str(q) for q in g.placements],
                         list(g.stride())) for g in got],
                "want": want,
                "local_kept": [g._local_tensor.shape == x.shape
                               for g, (x, _, _) in zip(got, forms)],
                "before": {str(d): v["Total"] for d, v in before.items()},
                "after": {str(d): v["Total"] for d, v in after.items()},
                "peak": {str(d): v["Total"] for d, v in peak.items()}})
    return out


def run_port_cases(out_dir: str) -> None:
    """The fake-mesh cases and the CLI's production cell (this file run
    as a script, jax and repro blocked): ``out_dir``/port.json and the
    CLI's JSON under ``out_dir``/cli."""
    exec(_BLOCK_JAX)
    import logging
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as R
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    from repro_torch.parallel.sharding import make_ctx
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    res = {}
    for data, model, pod in MESHES:
        mesh = make_test_mesh(data, model, pod=pod, fake=True)
        for arch in ARCHS:
            cfg = get_reduced_config(arch, n_layers=2)
            ctx = make_ctx(cfg, mesh)
            for name, kind in KINDS:
                key = f"{pod or 1}x{data}x{model}/{arch}/{kind}"
                shape = _small_shape(name, kind)
                try:
                    r = D.dry_run(ctx, cfg, shape)
                    ma = r["memory_analysis"]
                    res[key] = {"ok": True, "flops":
                                r["cost_analysis"]["flops"],
                                "counts": r["collectives"]["counts"],
                                "peak": ma["peak_memory_in_bytes"],
                                "args": ma["argument_size_in_bytes"]}
                    if pod is None and (name, kind) in ARG_KINDS:
                        with FakeTensorMode(allow_non_fake_inputs=True):
                            res[key]["leaves"] = _arg_bytes(
                                D.lay_out(ctx, cfg, shape))
                except Exception as e:  # noqa: BLE001 - the result
                    res[key] = {"ok": False,
                                "error": f"{type(e).__name__}: {e}"}
        if pod is None:
            res["like"] = _like_cases(mesh)
            for n in MOE_LAYERS:
                cfg = get_reduced_config(MOE_ARCH, n_layers=n)
                ctx = make_ctx(cfg, mesh)
                shape = _small_shape("train_4k", "train")
                with FakeTensorMode(allow_non_fake_inputs=True):
                    params, opt, _ = D.lay_out(ctx, cfg, shape)
                    res[f"moe/{n}"] = {
                        "optimizer": cfg.train.optimizer,
                        "params": sum(_arg_bytes([params]).values()),
                        "opt": sum(_arg_bytes([opt]).values()),
                        "memory": D.dry_run(ctx, cfg, shape)[
                            "memory_analysis"]}
    # one product (4096 x 4096) @ (4096 x 4096) split rows over data and
    # columns over model: each of the 256 ranks computes 1/256 of it
    mesh = make_production_mesh(fake=True)
    ctx = make_ctx(get_reduced_config("qwen3-8b"), mesh)
    with FakeTensorMode():
        a, b = torch.empty(4096, 4096), torch.empty(4096, 4096)
        rep = [Replicate(), Replicate()]
        da = DTensor.from_local(a, mesh, rep, run_check=False).redistribute(
            mesh, [Shard(0), Replicate()])
        db = DTensor.from_local(b, mesh, rep, run_check=False).redistribute(
            mesh, [Replicate(), Shard(1)])
        _, dt = R.count(ctx, "dtensor", lambda x, y: x @ y, da, db)
        _, lo = R.count(ctx, "local", lambda x, y: x @ y,
                        da.to_local(), db.to_local())
        _, ag = R.count(ctx, "gather", lambda x: x.redistribute(
            mesh, rep), da)
    res["dtensor"] = {"flops": dt.flops, "local_flops": lo.flops,
                      "bytes": dt.bytes_accessed,
                      "local_bytes": lo.bytes_accessed,
                      "gather": ag.collectives.summary(),
                      "gather_ops": ag.collectives.ops}
    D.main(["--arch", "qwen3-8b", "--shape", "train_4k", "--force",
            "--out-dir", os.path.join(out_dir, "cli")])
    for variant, over in VARIANTS:
        D.main(["--arch", "qwen3-8b", "--shape", "train_4k", "--force",
                "--variant", variant,
                "--out-dir", os.path.join(out_dir, "cli")]
               + [a for o in over for a in ("--override", o)])
    assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
    with open(os.path.join(out_dir, "port.json"), "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    port = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(d)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ref = subprocess.Popen(
        [sys.executable, "-c", _JAX_ANALYTIC % (ANALYTIC, ARCHS, ARG_KINDS,
                                          OVERRIDE_ARCHS, OVERRIDES),
         str(d / "ref.json")], env=dict(env, JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = {"port": port, "ref": ref}
    out = {}
    try:
        for name, p in procs.items():
            o, e = p.communicate(timeout=TIMEOUT)
            out[name] = (p.returncode, o, e)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    yield d, out


def _json(runs, name, path):
    d, out = runs
    rc, o, e = out[name]
    assert rc == 0, (o[-2000:], e[-3000:])
    with open(d / path) as f:
        return json.load(f)


@pytest.mark.parametrize("mesh", [f"{p or 1}x{d}x{m}" for d, m, p in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", [k for _, k in KINDS])
def test_dryrun_small_mesh_all_kinds(runs, mesh, arch, kind):
    """The reference's matrix: the three step kinds of three archs (2
    layers) on fake (2, 2) and (2, 2, 2) meshes run on fake tensors and
    count a positive number of FLOPs and some collectives."""
    r = _json(runs, "port", "port.json")[f"{mesh}/{arch}/{kind}"]
    assert r["ok"], r.get("error")
    assert r["flops"] > 0 and r["peak"] > 0
    assert sum(r["counts"].values()) > 0


# The argument bytes of the reduced cells differ from XLA's by design in
# two places, each held exactly by the test below:
# - the reference compiles its train step with the optimizer state's
#   layout left to XLA (``in_shardings=(params, None, None)``,
#   repro/launch/steps.py make_train_step), and XLA's propagation splits
#   these AdamW moments over ``model`` though their parameters are whole
#   on every rank; the port lays each moment out as its parameter, as its
#   trainer does, so it holds ``model`` (2) times the reference's bytes;
OPT_SPLIT_BY_XLA = {
    "qwen3-8b": ("lm_head", "mixer.k_norm"),
    "mixtral-8x7b": ("lm_head",),
    "rwkv6-1.6b": ("lm_head", "mixer.ln_x", "mixer.u", "mixer.w0",
                   "mixer.w_lora_b")}
# - the reference's KV cache carries its position as an int32 array, one
#   a layer (``.index``); the port's is a Python int, no tensor.
KV_INDEX = ".index"


def _by_leaf(leaves):
    """Bytes by argument leaf with the layer dropped from the path: the
    reference stacks a pattern position's layers (``['blocks']['pos0']``,
    a state's ``['pos0']``), the port lists them (``['layers'][0]``,
    ``[0]``)."""
    out = {}
    for k, v in leaves.items():
        k = re.sub(r"\['(blocks|layers)'\]|\['pos\d+'\]|\[\d+\]", "", k)
        out[k] = out.get(k, 0) + v
    return out


@pytest.mark.parametrize("kind", [k for _, k in ARG_KINDS])
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_reference(runs, arch, kind):
    """The port's ``argument_size_in_bytes`` of a reduced cell (2 layers,
    seq 64, batch 8) on its fake (2, 2) mesh against XLA's for the
    reference's step compiled on a (2, 2) mesh: leaf by leaf equal, but
    for the two differences by design stated above, which account for
    the whole difference of the totals."""
    ref = _json(runs, "ref", "ref.json")[f"args/{arch}/{kind}"]
    port = _json(runs, "port", "port.json")[f"1x2x2/{arch}/{kind}"]
    assert port["ok"], port.get("error")
    # each count is the sum of its leaves' shards
    assert sum(ref["leaves"].values()) == ref["argument_size_in_bytes"]
    assert sum(port["leaves"].values()) == port["args"]
    r, p = _by_leaf(ref["leaves"]), _by_leaf(port["leaves"])
    split = set()
    if kind == "train":
        split = {f"1['{m}']" + "".join(f"['{n}']" for n in name.split("."))
                 for m in ("m", "v") for name in OPT_SPLIT_BY_XLA[arch]}
    kv_index = {k for k in r if k.endswith(KV_INDEX)}
    assert bool(kv_index) == (kind == "decode" and arch != "rwkv6-1.6b")
    assert split <= set(r) and set(p) == set(r) - kv_index
    for k in r:
        if k in split:
            assert p[k] == 2 * r[k], k
        elif k in kv_index:
            assert r[k] == 4 * 2, k         # int32, 2 layers
        else:
            assert p[k] == r[k], k
    assert port["args"] == ref["argument_size_in_bytes"] - sum(
        r[k] for k in kv_index) + sum(p[k] - r[k] for k in split)


def test_like_makes_no_stand_in(runs):
    """``optimizer._like`` gives the local tensor its parameter's layout
    (or the one Adafactor's factored statistics take) with the
    placements, global shape and stride the code before read from a
    ``meta`` stand-in, keeps the local tensor's shape, and allocates
    nothing: under ``MemTracker`` no device shows but the local tensors',
    and their bytes stay as they were."""
    for case, r in zip(LIKE_CASES, _json(runs, "port", "port.json")["like"]):
        assert r["got"] == r["want"], case
        assert all(r["local_kept"]), case
        assert list(r["peak"]) == ["cpu"], (case, r["peak"])
        assert r["before"] == r["after"] == r["peak"], case


@pytest.mark.parametrize("shape", [(), (5,), (3, 4), (2, 0, 3), (1, 1, 5),
                                   (4, 1, 0, 2), (2, 3, 4, 5)])
def test_contiguous_stride_is_torchs(shape):
    import torch
    from repro_torch.optim.optimizer import _contiguous_stride
    assert _contiguous_stride(shape) == torch.empty(shape).stride()


def test_moe_adafactor_peak_is_the_devices_own(runs):
    """A reduced MoE that trains with Adafactor (Kimi-K2 at 1 and 2
    layers) on the fake (2, 2) mesh: nothing of its peak is on ``meta``
    or any other device but the stand-ins', its kinds sum to its peak,
    and a second layer adds no more than that layer's local parameter,
    gradient and optimizer bytes."""
    res = _json(runs, "port", "port.json")
    one, two = (res[f"moe/{n}"] for n in MOE_LAYERS)
    for r in (one, two):
        ma = r["memory"]
        assert r["optimizer"] == "adafactor"
        assert ma["other_devices"] == {}
        assert sum(ma["by_kind"].values()) == ma["peak_memory_in_bytes"]
        assert ma["peak_memory_in_bytes"] >= ma["argument_size_in_bytes"] \
            > r["params"] + r["opt"]
    layer = 2 * (two["params"] - one["params"]) + two["opt"] - one["opt"]
    grown = two["memory"]["peak_memory_in_bytes"] - \
        one["memory"]["peak_memory_in_bytes"]
    assert 0 < grown <= layer, (grown, layer)


def test_dryrun_flops_halve_with_the_pod_axis(runs):
    """The (2, 2, 2) mesh splits the batch over twice the ranks: each
    rank's FLOPs are half the (2, 2) mesh's, whatever the kind."""
    res = _json(runs, "port", "port.json")
    for arch in ARCHS:
        for _, kind in KINDS:
            one = res[f"1x2x2/{arch}/{kind}"]["flops"]
            two = res[f"2x2x2/{arch}/{kind}"]["flops"]
            assert two == pytest.approx(one / 2, rel=1e-9), (arch, kind)


def test_dtensor_op_is_counted_per_device(runs):
    """A DTensor product reaches the counter at its global shape; it is
    counted as one rank's share (1/256 of 2 * 4096**3), the FLOPs and
    bytes of the same product on the local shards. Gathering the rows
    split over data is one all-gather over the 16 ranks of a data group,
    whose result is the whole (4096, 4096) fp32 tensor."""
    r = _json(runs, "port", "port.json")["dtensor"]
    assert r["flops"] == 2 * 4096 ** 3 / 256 == r["local_flops"]
    assert r["bytes"] == r["local_bytes"]
    counts = r["gather"]["counts"]
    assert counts == {"all-gather": 1}
    (kind, rb, n), = r["gather_ops"]
    assert (kind, rb, n) == ("all-gather", 4096 * 4096 * 4, 16)
    assert r["gather"]["wire_bytes"]["all-gather"] == rb * 15 / 16


def test_dryrun_cli_production_cell(runs):
    """The dry-run CLI (``dryrun.main``, what ``python -m
    repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k`` runs) on
    the fake (16, 16) mesh, with jax and repro blocked:
    ``ok`` JSON with per-device FLOPs, bytes, collectives and analytic
    bytes. Per device the step does more than the model's 6 N D / 256
    (the remat recompute, attention, the KV projections whole on every
    rank: 8 KV heads do not split 16 ways) and less than 3 times it."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.roofline import model_flops
    r = _json(runs, "port", "cli/qwen3-8b__train_4k__pod16x16.json")
    assert r["ok"], r.get("error")
    per_dev = model_flops(get_config("qwen3-8b"), get_shape("train_4k")) \
        / 256
    assert per_dev < r["cost_analysis"]["flops"] < 3 * per_dev
    assert r["cost_analysis"]["bytes accessed"] > 0
    c = r["collectives"]
    assert {"all-gather", "all-reduce", "reduce-scatter"} <= set(c["counts"])
    assert c["total_wire_bytes"] > 0
    ab = r["analytic_bytes_per_device"]
    assert ab["total"] == ab["params"] + ab["optimizer"] > 0
    ma = r["memory_analysis"]
    assert ma["peak_memory_in_bytes"] >= ma["argument_size_in_bytes"] > 0
    assert "while_trip_counts" not in r and "overlap" not in r


#: the port's config fields the reference lacks, with their defaults
PORT_ONLY = {"model": {"embedding_multiplier": None,
                       "residual_multiplier": None, "logits_scaling": None,
                       "norm_eps": 1e-6},
             "attention": {"softmax_scale": None},
             "moe": {"d_ff_shared": None}}


@pytest.mark.parametrize("arch", OVERRIDE_ARCHS)
def test_overrides_equal_the_references(runs, arch):
    """``_apply_overrides`` sets each ``section.field`` as the
    reference's does: the overridden configs agree field by field."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _apply_overrides
    ref = _json(runs, "ref", "ref.json")[f"overrides/{arch}"]
    got = _apply_overrides(get_config(arch), OVERRIDES)
    assert not got.train.remat and got.parallel.fsdp
    assert get_config(arch).train.remat
    mine = json.loads(json.dumps(dataclasses.asdict(got), default=str))
    # the port-only fields (``tests/test_torch_package.py`` DIFFERENCES),
    # at the defaults that compute what the reference computes
    assert {k: mine["model"].pop(k) for k in PORT_ONLY["model"]} \
        == PORT_ONLY["model"]
    for section in ("attention", "moe"):
        if mine["model"][section] is not None:
            assert {k: mine["model"][section].pop(k)
                    for k in PORT_ONLY[section]} == PORT_ONLY[section]
    assert mine == ref


def test_variant_cells_carry_their_name_and_overrides(runs):
    """The CLI's ``--override`` / ``--variant`` (``run_cell(...,
    overrides, variant)``) on the production mesh: the file gains the
    reference's ``__{variant}`` suffix, the result names its variant, and
    the overrides reach the step (2 of 36 layers count far fewer FLOPs,
    and without remat fewer again)."""
    from repro_torch.launch.dryrun import _cell_path
    names = _json(runs, "ref", "ref.json")["cell_path"]
    d = runs[0] / "cli"
    for v, want in names.items():
        assert os.path.basename(_cell_path(
            "qwen3-8b", "train_4k", "pod16x16", v, str(d))) == want
    full = _json(runs, "port", "cli/" + names[""])
    assert full["variant"] == ""
    flops = {}
    for v, _ in VARIANTS:
        r = _json(runs, "port", f"cli/{names[''][:-5]}__{v}.json")
        assert r["ok"], r.get("error")
        assert r["variant"] == v
        flops[v] = r["cost_analysis"]["flops"]
    assert flops["l2_noremat"] < flops["l2"] < full["cost_analysis"][
        "flops"] / 10


@pytest.mark.parametrize("item", ["train.remat", "remat=false"])
def test_cli_refuses_an_override_without_section_and_value(item, capsys):
    from repro_torch.launch import dryrun as D
    with pytest.raises(SystemExit):
        D.main(["--arch", "qwen3-8b", "--shape", "train_4k",
                "--override", item])
    assert "SECTION.FIELD=VALUE" in capsys.readouterr().err


def test_model_flops_equal_the_reference_for_every_cell():
    from repro.configs import get_config as jax_config
    from repro.configs import get_shape as jax_shape
    from repro.launch.roofline import model_flops as jax_model_flops
    from repro_torch.configs import cells, get_config, get_shape
    from repro_torch.launch.roofline import model_flops
    todo = cells()
    assert len(todo) > 30
    for arch, shape, _ in todo:
        assert model_flops(get_config(arch), get_shape(shape)) == \
            jax_model_flops(jax_config(arch), jax_shape(shape)), (arch, shape)


class _Mesh:
    """A stand-in DeviceMesh: the analytic bytes read only dim sizes."""

    def __init__(self, shape, names):
        self.mesh_dim_names, self._shape = tuple(names), tuple(shape)
        self.ndim = len(shape)

    def size(self, i=None):
        return self._shape[i]


@pytest.mark.parametrize("arch,shape", ANALYTIC)
def test_analytic_bytes_equal_the_reference(runs, arch, shape):
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.dryrun import _analytic_bytes_per_device
    from repro_torch.parallel.sharding import make_ctx
    ref = _json(runs, "ref", "ref.json")[f"{arch}/{shape}"]
    cfg = get_config(arch)
    ctx = make_ctx(cfg, _Mesh((16, 16), ("data", "model")))
    got = _analytic_bytes_per_device(ctx, cfg, get_shape(shape))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-12, abs=0), k


def _analytic_matmul_flops(cfg, B, S, kind):
    """The matmuls of a reduced dense model (GQA attention, SwiGLU FFN,
    untied head) by hand. Prefill: each layer's q/k/v/o projections,
    the plain attention's two (B, H, S, S) products and the FFN's three,
    then the head at the last position. Train: the layers' forward, its
    recompute under remat (``nothing_saveable``; the non-reentrant
    checkpoint stops once the backward's inputs are rebuilt, so it does
    not redo the layer's last product, ``w_down``) and the backward (two
    products per product), plus the head over every position (forward
    and backward) in the loss."""
    m, a = cfg.model, cfg.model.attention
    T, d, f, V = B * S, m.d_model, m.d_ff, m.vocab_size
    H, KV, dh = a.n_heads, a.n_kv_heads, a.d_head
    proj = 2 * T * d * (H + 2 * KV) * dh + 2 * T * H * dh * d
    attn = 2 * (2 * B * H * S * S * dh)
    ffn = 3 * 2 * T * d * f
    layer = proj + attn + ffn
    if kind == "prefill":
        return m.num_layers * layer + 2 * B * d * V
    w_down = 2 * T * f * d
    return m.num_layers * (layer + (layer - w_down) + 2 * layer) + \
        3 * 2 * T * d * V


@pytest.mark.parametrize("kind,name", [("prefill", "prefill_32k"),
                                       ("train", "train_4k")])
def test_counted_flops_match_the_matmuls_by_hand(kind, name):
    """No mesh, a reduced Qwen3 (2 layers) at seq 64, batch 2: the
    whole step's counted FLOPs within 1 % of the matmuls by hand, and
    the roofline's segments (one layer, scaled by 2, plus the head and
    the optimizer) add up to the whole step."""
    from repro_torch.configs import get_reduced_config, get_shape
    from repro_torch.launch import dryrun as D
    from repro_torch.parallel.sharding import NO_MESH
    cfg = get_reduced_config("qwen3-8b", n_layers=2)
    shape = dataclasses.replace(get_shape(name), seq_len=64, global_batch=2)
    got = D.dry_run(NO_MESH, cfg, shape)["cost_analysis"]["flops"]
    want = _analytic_matmul_flops(cfg, 2, 64, kind)
    assert got == pytest.approx(want, rel=1e-2)
    rf = D.roofline(NO_MESH, cfg, shape, "none")
    assert rf.flops_per_device == pytest.approx(got, rel=1e-9)
    assert rf.n_chips == 1 and rf.collective_s == 0.0
    assert rf.dominant in ("compute", "memory")


@pytest.mark.parametrize("arch", ["internvl2-76b", "jamba-1.5-large-398b",
                                  "rwkv6-1.6b", "hubert-xlarge"])
def test_roofline_segments_add_up_to_the_step(arch):
    """One layer per signature scaled by its count, the head and the
    optimizer count the FLOPs of the whole train step, for a model fed
    frontend embeds with an untied head (its token embedding unused),
    the hybrid's Mamba / attention / MoE period, RWKV-6 and an encoder."""
    from repro_torch.configs import get_reduced_config, get_shape
    from repro_torch.launch import dryrun as D
    from repro_torch.parallel.sharding import NO_MESH
    cfg = get_reduced_config(arch)
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=64,
                                global_batch=2)
    whole = D.dry_run(NO_MESH, cfg, shape)["cost_analysis"]["flops"]
    assert D.roofline(NO_MESH, cfg, shape, "none").flops_per_device == \
        pytest.approx(whole, rel=1e-9)


def test_roofline_terms_use_the_h100_constants():
    from repro_torch.configs import get_reduced_config, get_shape
    from repro_torch.launch import roofline as R
    from repro_torch.parallel.sharding import NO_MESH
    assert (R.PEAK_FLOPS, R.HBM_BW, R.NVLINK_BW, R.POD_BW) == \
        (989e12, 3.35e12, 450e9, 50e9)
    cfg = get_reduced_config("qwen3-8b", n_layers=2)
    shape = get_shape("train_4k")
    stats = R.hlo_lib.CollectiveStats()
    stats.counts["all-reduce"] = 1
    stats.wire_bytes["all-reduce"] = 9e9
    seg = R.SegmentCost("s", 989e12, 6.7e12, stats, 0.0, 1e9)
    rf = R.build_roofline(NO_MESH, cfg, shape, "m", {"s": seg})
    assert rf.compute_s == pytest.approx(1.0)
    assert rf.memory_s == pytest.approx(2.0)
    assert rf.collective_s == pytest.approx(8e9 / 450e9 + 1e9 / 50e9)
    assert rf.dominant == "memory" and rf.roofline_fraction == \
        pytest.approx(0.5)
    assert set(rf.to_dict()) >= {"compute_s", "memory_s", "dominant",
                                 "model_flops", "segments"}


@pytest.mark.slow
def test_dryrun_all_cells(tmp_path):
    """``--all`` over every assigned cell of the production mesh (40,
    minus the documented skips): each must come back ``ok``."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--force", "--out-dir", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=6 * 3600)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])


if __name__ == "__main__":
    import torch
    torch.set_num_threads(1)
    run_port_cases(sys.argv[1])
