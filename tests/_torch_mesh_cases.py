"""The port's side of tests/test_torch_mesh.py: every case on a 2 x 2
(data, model) mesh of four gloo CPU processes (``launch.mesh.spawn``),
beside the port's no-mesh run of the same case. Imports torch only: the
spawned ranks import this module by name.

``run_all(work)`` returns rank 0's results as a dict of numpy arrays
(every rank computes every case: the collectives need them all).
"""
import dataclasses
import logging
import os

import numpy as np
import torch

import _mesh_specs as SP
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import get_reduced_config, get_shape
from repro_torch.data.pipeline import DataConfig, device_batch, host_batch
from repro_torch.launch import steps as S
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.optim import optimizer as O
from repro_torch.parallel.sharding import NO_MESH, full, make_ctx
from repro_torch.train.trainer import Trainer, TrainerConfig


def config(name):
    return SP.build(get_reduced_config, SP.ALL[name])


def shape(name):
    return dataclasses.replace(get_shape("train_4k"),
                               seq_len=SP.ALL[name].get("seq", SP.SEQ),
                               global_batch=SP.BATCH)


def write_params(work: str) -> None:
    """Draw each parameter set once (a seeded torch generator) and save
    it in the reference's layout, for both packages to load."""
    for name, spec in SP.ALL.items():
        d = os.path.join(work, SP.params_key(spec))
        if os.path.isdir(d):
            continue
        cfg = config(name)
        params = M.init_params(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(0))
        ckpt_lib.save(d, 0, to_jax_params(params,
                                          period=cfg.model.pattern_period))


def load_params(work: str, name: str):
    cfg = config(name)
    target = to_jax_params(M.init_params(cfg, device="meta", generator=None),
                           period=cfg.model.pattern_period)
    tree, _ = ckpt_lib.restore(os.path.join(work, SP.params_key(
        SP.ALL[name])), 0, target)
    return from_jax_params(tree)


def _np(t) -> np.ndarray:
    return full(t).detach().float().numpy().copy()


def _flat(params) -> np.ndarray:
    return np.concatenate([_np(t).ravel() for t in O.tree_leaves(params)])


def _inputs(cfg, name):
    """(tokens or None, embeds or None) of a forward case, as tensors."""
    return tuple(None if a is None else torch.from_numpy(a)
                 for a in SP.inputs(name, cfg))


def _train(work, name, ctx, steps):
    cfg = config(name)
    params = M.distribute_params(ctx, cfg, load_params(work, name))
    opt = O.init_opt_state(cfg.train, params,
                           period=cfg.model.pattern_period)
    step = S.make_train_step(cfg, ctx)
    rows = []
    for i in range(steps):
        batch = device_batch(host_batch(cfg, shape(name), i), "cpu", ctx)
        params, opt, m = step(params, opt, batch)
        rows.append([float(m["loss"]), float(m["grad_norm"]),
                     float(m["ce"])])
    return np.array(rows), _flat(params)


def _ce_grads(work, name, ctx):
    """The gradient of the cross-entropy alone (no router loss, whose
    mesh value is the shards' mean by design) at the case's parameters,
    on the first batch, flattened."""
    cfg = config(name)
    params = M.distribute_params(ctx, cfg, load_params(work, name))
    batch = device_batch(host_batch(cfg, shape(name), 0), "cpu", ctx)

    def ce(p, b):
        hidden, _, _ = M.forward(cfg, p, tokens=b["tokens"], mode="train",
                                 ctx=ctx)
        return M.loss_fn(cfg, p, hidden, b["labels"], ctx=ctx), {}
    _, grads = S.loss_and_grads(ce, params, batch)
    return _flat(grads)


def _forward(work, name, ctx, tokens, embeds):
    cfg = config(name)
    params = M.distribute_params(ctx, cfg, load_params(work, name))
    if ctx.mesh is not None:
        b = (tokens if tokens is not None else embeds)
        pl = S.batch_shardings(ctx, {"x": b})["x"]
        from repro_torch.parallel.sharding import place
        tokens = place(tokens, ctx.mesh, pl) if tokens is not None else None
        embeds = place(embeds, ctx.mesh, pl) if embeds is not None else None
    with torch.no_grad():
        h, _, aux = M.forward(cfg, params, tokens=tokens, embeds=embeds,
                              mode="train", ctx=ctx)
    return _np(h), float(aux)


def _state_leaves(tree) -> list:
    """A prefill / decode state tree's tensors, gathered whole, in an
    order that does not depend on how the dicts were built (keys
    sorted; a KV cache's integer cursor left out)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _state_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _state_leaves(v)]
    if isinstance(tree, int) or tree is None:
        return []
    return [_np(tree).ravel()]


def _greedy(work, name, ctx, n_new=4, prompt=8):
    """The case's prefill of ``prompt`` tokens, then ``n_new`` greedy
    decode steps: the tokens (B, n_new), the logits of the prefill and
    of every decode step (the last one's too), flattened, and the final
    states gathered whole, flattened. Every parameter is moved by seeded
    noise first, so that no per-head tensor is alike across heads
    (RWKV's ``u`` is drawn as zeros, ``ln_x`` as ones): a shard that
    took another rank's rows would show."""
    cfg = config(name)
    g = torch.Generator().manual_seed(1)
    params = O.tree_map(
        lambda t: t + 0.05 * torch.randn(t.shape, generator=g).to(t.dtype)
        if t.is_floating_point() else t, load_params(work, name))
    params = M.distribute_params(ctx, cfg, params)
    tokens, _ = _inputs(cfg, name)
    tokens = tokens[:, :prompt]
    B = tokens.shape[0]
    prefill = S.make_prefill_step(cfg, max_seq=prompt + n_new, ctx=ctx)
    decode = S.make_decode_step(cfg, B, ctx=ctx)
    states, logits = prefill(params, {"tokens": tokens})
    out, seen = [], [_np(logits).ravel()]
    for _ in range(n_new):
        nxt = torch.argmax(full(logits)[:, -1], dim=-1).to(torch.int32)
        out.append(nxt.numpy().copy())
        states, logits = decode(params, states, nxt[:, None])
        seen.append(_np(logits).ravel())
    return (np.stack(out, axis=1), np.concatenate(seen),
            np.concatenate(_state_leaves(states)))


def _elastic(work, ctx):
    """Checkpoints across meshes: the trainer saves on the mesh and a
    no-mesh restore reads it; a no-mesh save restores on the mesh and
    the trainer resumes there. Returns the largest difference seen and
    the resumed run's first step."""
    name = "qwen3_fsdp"
    cfg = config(name)
    sh = shape(name)
    d_mesh = os.path.join(work, "elastic_mesh")
    tr = Trainer(cfg, sh, TrainerConfig(total_steps=2, ckpt_dir=d_mesh,
                                        ckpt_every=100), DataConfig(),
                 device="cpu", ctx=ctx)
    params, opt = tr.train()
    saved = _flat(params)
    one = Trainer(cfg, sh, TrainerConfig(ckpt_dir=d_mesh), DataConfig(),
                  device="cpu")
    p1, o1, step1 = one.resume_or_init()
    err = [float(np.abs(_flat(p1) - saved).max()),
           float(np.abs(_flat(o1["m"]) - _flat(opt["m"])).max())]
    # the other way: a no-mesh save (each rank trains alike, rank 0
    # writes), restored onto the mesh
    d_one = os.path.join(work, "elastic_one")
    one2 = Trainer(cfg, sh, TrainerConfig(total_steps=1, ckpt_dir=d_one,
                                          ckpt_every=100),
                   DataConfig(), device="cpu")
    p_one, _ = one2.train()
    back = Trainer(cfg, sh, TrainerConfig(total_steps=3, ckpt_dir=d_one,
                                          ckpt_every=100), DataConfig(),
                   device="cpu", ctx=ctx)
    p2, o2, step2 = back.resume_or_init()
    err.append(float(np.abs(_flat(p2) - _flat(p_one)).max()))
    back.train(p2, o2, step2)
    return (np.array(err), np.array([step1, step2, back.history[0].step,
                                     len(back.history)]))


def _cli():
    """The train CLI over the spawned ranks: a 2x2 run, then a mesh that
    does not fit the world (exit 2)."""
    tr = train_cli.main(["--arch", "qwen3-8b", "--reduced", "--device",
                         "cpu", "--mesh", "2x2", "--steps", "2",
                         "--seq-len", "32", "--global-batch", "4"])
    try:
        train_cli.main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu",
                        "--mesh", "2x3", "--steps", "1"])
        code = 0
    except SystemExit as e:
        code = e.code
    return np.array([len(tr.history), code])


def _refused(ctx):
    """The rwkv and mamba mixers under a mesh: the Trainer builds for
    each and takes one step (the message of what it raised, or '' when
    nothing was)."""
    out = []
    for arch in ("rwkv6-1.6b", "jamba-1.5-large-398b"):
        cfg = get_reduced_config(arch)
        try:
            Trainer(cfg, shape("qwen3"), TrainerConfig(total_steps=1),
                    device="cpu", ctx=make_ctx(cfg, ctx.mesh)).train()
            out.append("")
        except Exception as e:  # noqa: BLE001 - the message is the result
            out.append(f"{type(e).__name__}: {e}")
    return np.array(out)


def run_all(work: str) -> dict:
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    mesh = make_test_mesh(2, 2)
    res = {}
    for name in SP.TRAIN:
        ctx = make_ctx(config(name), mesh)
        for tag, c in (("one", NO_MESH), ("mesh", ctx)):
            res[f"{name}/{tag}/metrics"], res[f"{name}/{tag}/params"] = \
                _train(work, name, c, 2)
    for name in SP.ADAFACTOR:
        ctx = make_ctx(config(name), mesh)
        for tag, c in (("one", NO_MESH), ("mesh", ctx)):
            res[f"{name}/{tag}/metrics"], res[f"{name}/{tag}/params"] = \
                _train(work, name, c, 1)
    for name in ("rwkv6_fsdp", "jamba_train"):
        ctx = make_ctx(config(name), mesh)
        for tag, c in (("one", NO_MESH), ("mesh", ctx)):
            res[f"{name}/{tag}/ce_grads"] = _ce_grads(work, name, c)
    for name in {**SP.MOE, **SP.FWD}:
        cfg = config(name)
        ctx = make_ctx(cfg, mesh)
        tokens, embeds = _inputs(cfg, name)
        for tag, c in (("one", NO_MESH), ("mesh", ctx)):
            res[f"{name}/{tag}/hidden"], aux = _forward(work, name, c,
                                                        tokens, embeds)
            res[f"{name}/{tag}/aux"] = np.array(aux)
        if name == "mixtral_drop":
            # the no-mesh model on each data shard's rows alone
            half = SP.BATCH // 2
            rows = [_forward(work, name, NO_MESH,
                             None if tokens is None else tokens[i:i + half],
                             None if embeds is None else embeds[i:i + half])
                    [0] for i in (0, half)]
            res[f"{name}/per_shard/hidden"] = np.concatenate(rows)
    for name in SP.GREEDY:
        for tag, c in (("one", NO_MESH), ("mesh", make_ctx(config(name),
                                                           mesh))):
            (res[f"greedy_{name}/{tag}"], res[f"greedy_{name}/{tag}/logits"],
             res[f"greedy_{name}/{tag}/states"]) = _greedy(work, name, c)
    ctx = make_ctx(config("qwen3"), mesh)
    res["elastic/err"], res["elastic/steps"] = _elastic(work, ctx)
    res["cli"] = _cli()
    res["refused"] = _refused(ctx)
    return res if torch.distributed.get_rank() == 0 else {}
