"""The port's training path against the JAX package's, on the same
parameters (the reference's ``init_params``, converted through numpy)
and the same ``host_batch`` data, in fp32 on the CPU: the data pipeline
byte for byte; ``loss_fn`` and the loss gradients at 1e-4; the train
step over 3 steps (losses at 1e-4, each step's parameter update within
2e-2 · lr of the reference's: see the test); remat on and off; the ``Trainer`` (history, retries,
restart from a checkpoint, checkpoints cross-loaded both ways, the
straggler watchdog, ``extra``, the fault boundary); the train CLI and
the example. Reduced Qwen3-8B, reduced RWKV-6 (through its plain
chunked scan, as the reference trains it), and reduced Mixtral and Jamba
(one period: 7 Mamba layers, 4 MoE FFNs, Adafactor), whose loss is the
cross-entropy plus the router's load-balance loss."""
import dataclasses
import pathlib
import re
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.configs import get_shape as jax_shape
from repro.data import pipeline as jax_pipeline
from repro.launch import steps as jax_steps
from repro.models import init_params as jax_init_params
from repro.models import model as jax_model
from repro.optim import optimizer as JO
from repro.parallel import NO_MESH
from repro.train import trainer as jax_trainer
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_reduced_config
from repro_torch.data import pipeline
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.optim import optimizer as O
from repro_torch.train import trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["qwen3-8b", "rwkv6-1.6b", "mixtral-8x7b", "jamba-1.5-large-398b",
         "internvl2-76b"]
SEQ, BATCH = 16, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one thread each, so that parallel test workers do
    not oversubscribe the cores (the fault tier's timing tests share
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shape(seq=SEQ, batch=BATCH):
    return dataclasses.replace(jax_shape("train_4k"), seq_len=seq,
                               global_batch=batch)


def _configs(arch, **train):
    jcfg, tcfg = jax_reduced(arch), get_reduced_config(arch)
    return (jcfg.replace(train=dataclasses.replace(jcfg.train, **train)),
            tcfg.replace(train=dataclasses.replace(tcfg.train, **train)))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, JAX params, the same params in the port's layout)."""
    jcfg = jax_reduced(request.param)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return request.param, jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close_trees(port_ref_layout, ref, **tol):
    pl, pd = jax.tree_util.tree_flatten_with_path(port_ref_layout)
    rl, rd = jax.tree_util.tree_flatten_with_path(ref)
    assert pd == rd
    for (path, a), (_, b) in zip(pl, rl):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=str(path), **tol)


def _updates_close(new, old, ref_new, ref_old, *, atol, msg):
    """Each element's update ``new - old`` (trees in the reference's
    layout) against the reference's ``ref_new - ref_old``: within ``atol``
    plus two float32 ulps of the parameter (each package rounds
    p - lr * u once)."""
    leaves = [jax.tree_util.tree_flatten_with_path(t) for t in
              (new, old, ref_new, ref_old)]
    assert len({str(td) for _, td in leaves}) == 1
    for (path, a), (_, c), (_, b), (_, d) in zip(*(lv for lv, _ in leaves)):
        a, b, c, d = (_np(x) for x in (a, b, c, d))
        du, dr = a - c, b - d
        ulp = np.spacing(np.maximum(np.maximum(abs(a), abs(b)),
                                    np.maximum(abs(c), abs(d))))
        excess = abs(du - dr) - (atol + 2 * ulp)
        i = np.unravel_index(np.argmax(excess), excess.shape)
        assert excess[i] <= 0, (f"{msg} {jax.tree_util.keystr(path)}: "
                                f"update {du[i]} against the reference's "
                                f"{dr[i]} at {i}")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mask", [("qwen3-8b", 0.0), ("qwen3-8b", 0.3),
                                       ("hubert-xlarge", 0.0)])
def test_host_batch_equals_reference(arch, mask):
    jcfg, tcfg = _configs(arch)
    for step in (0, 1, 7):
        ref = jax_pipeline.host_batch(
            jcfg, _shape(32, 3), step,
            jax_pipeline.DataConfig(seed=9, mask_fraction=mask))
        out = pipeline.host_batch(tcfg, _shape(32, 3), step,
                                  pipeline.DataConfig(seed=9,
                                                      mask_fraction=mask))
        assert list(out) == list(ref)
        for k in ref:
            assert out[k].dtype == ref[k].dtype
            assert out[k].tobytes() == ref[k].tobytes(), (k, step)
    dev = pipeline.device_batch(out, "cpu")
    assert all(torch.equal(dev[k], torch.from_numpy(out[k])) for k in out)
    it = pipeline.iterate(tcfg, _shape(32, 3), "cpu", start_step=7,
                          cfg=pipeline.DataConfig(seed=9, mask_fraction=mask))
    first = next(it)
    assert all(torch.equal(first[k], dev[k]) for k in dev)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def test_loss_fn_matches_reference_with_masked_labels(model):
    arch, jp, tp = model
    jcfg, tcfg = _configs(arch)
    rng = np.random.default_rng(1)
    d = tcfg.model.d_model
    hidden = rng.standard_normal((2, 64, d)).astype(np.float32)
    labels = rng.integers(0, tcfg.model.vocab_size, (2, 64)).astype(np.int32)
    labels[rng.random((2, 64)) < 0.25] = -1
    ref = jax_model.loss_fn(NO_MESH, jcfg, jp, jnp.asarray(hidden),
                            jnp.asarray(labels), chunk=16)
    out = M.loss_fn(tcfg, tp, torch.from_numpy(hidden),
                    torch.from_numpy(labels), chunk=16)
    np.testing.assert_allclose(float(out), float(ref), **TOL)
    with pytest.raises(ValueError, match="chunk"):
        M.loss_fn(tcfg, tp, torch.from_numpy(hidden[:, :40]),
                  torch.from_numpy(labels[:, :40]), chunk=16)


def test_loss_and_grads_match_reference(model):
    arch, jp, tp = model
    jcfg, tcfg = _configs(arch)
    batch = jax_pipeline.host_batch(jcfg, _shape(), 0)
    (jloss, jm), jgrads = jax.value_and_grad(
        jax_steps.make_loss_fn(NO_MESH, jcfg), has_aux=True)(
            jp, jax.tree.map(jnp.asarray, batch))
    metrics, grads = steps.loss_and_grads(
        steps.make_loss_fn(tcfg), tp, pipeline.device_batch(batch, "cpu"))
    np.testing.assert_allclose(float(metrics["ce"]), float(jm["ce"]), **TOL)
    np.testing.assert_allclose(float(metrics["aux"]), float(jm["aux"]),
                               **TOL)
    assert (float(metrics["aux"]) > 0) == (tcfg.model.moe is not None)
    _close_trees(to_jax_params(grads, period=tcfg.model.pattern_period),
                 jgrads, **TOL)


@pytest.mark.parametrize("policy", [None, "nothing_saveable",
                                    "dots_saveable"])
def test_remat_leaves_gradients_unchanged(model, policy):
    arch, _, tp = model
    _, plain = _configs(arch, remat=False)
    _, cfg = _configs(arch, remat=policy is not None,
                      remat_policy=policy or "nothing_saveable")
    batch = pipeline.device_batch(
        pipeline.host_batch(cfg, _shape(), 1), "cpu")
    m0, g0 = steps.loss_and_grads(steps.make_loss_fn(plain), tp, batch)
    m1, g1 = steps.loss_and_grads(steps.make_loss_fn(cfg), tp, batch)
    assert float(m0["ce"]) == float(m1["ce"])
    for a, b in zip(O.tree_leaves(g1), O.tree_leaves(g0)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_train_step_matches_reference(model):
    arch, jp, tp = model
    jcfg, tcfg = _configs(arch)
    period = tcfg.model.pattern_period
    jopt = JO.init_opt_state(jcfg.train, jp)
    topt = O.init_opt_state(tcfg.train, tp, period=period)
    jstep = jax_steps.make_train_step(NO_MESH, jcfg, donate=False)
    tstep = steps.make_train_step(tcfg)
    for s in range(3):
        batch = jax_pipeline.host_batch(jcfg, _shape(), s)
        jp_old, tp_old = jp, to_jax_params(tp, period=period)
        jp, jopt, jm = jstep(jp, jopt, jax.tree.map(jnp.asarray, batch))
        before = [t.clone() for t in O.tree_leaves(tp)]
        new_tp, topt, tm = tstep(tp, topt, pipeline.device_batch(batch,
                                                                 "cpu"))
        # functional: the step leaves the params it was given intact
        assert all(torch.equal(a, b)
                   for a, b in zip(before, O.tree_leaves(tp)))
        tp = new_tp
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
        # AdamW's update is m / sqrt(v): lr * sign(g) on the first step,
        # so where a gradient is near zero its last-bit differences reach
        # the update (measured: up to 1e-2 * lr, in 5e-5 of the
        # elements). A missing update (lr), or weight decay dropped or
        # flipped (0.1 * lr on the norm scales, which are 1), fails.
        _updates_close(to_jax_params(tp, period=period), tp_old, jp, jp_old,
                       atol=2e-2 * float(jm["lr"]), msg=f"step {s}")
    assert int(topt["step"]) == 3


def test_forward_casts_fp32_masters_per_call():
    """With bf16 compute, forward casts fp32 params inside the
    differentiated function, so their gradients come back in fp32."""
    _, tcfg = _configs("qwen3-8b", compute_dtype="bfloat16")
    params = M.init_params(tcfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    batch = pipeline.device_batch(
        pipeline.host_batch(tcfg, _shape(), 0), "cpu")
    metrics, grads = steps.loss_and_grads(steps.make_loss_fn(tcfg), params,
                                          batch)
    assert torch.isfinite(metrics["ce"])
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in O.tree_leaves(grads))
    assert grads["layers"][0]["mixer"]["wq"].abs().sum() > 0


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def _trainers(arch, tmp_path, total, fault_hook=None, **tkw):
    """A port Trainer and its TrainerConfig, on the CPU."""
    _, tcfg = _configs(arch)
    tc = trainer.TrainerConfig(total_steps=total, ckpt_dir=str(tmp_path),
                               ckpt_every=2, log_every=0, **tkw)
    return trainer.Trainer(tcfg, _shape(), tc, pipeline.DataConfig(seed=5),
                           fault_hook=fault_hook, device="cpu")


def _port_state(tr, jp):
    params = from_jax_params(jax.tree.map(np.asarray, jp))
    return params, O.init_opt_state(tr.acfg.train, params, period=1)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The JAX Trainer over 6 steps from its own init_params (seed 0),
    and a JAX checkpoint of its first 4 steps."""
    jcfg = jax_reduced("qwen3-8b")
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    d = tmp_path_factory.mktemp("jax_ckpt")

    def run(total, ckpt_dir=None):
        tc = jax_trainer.TrainerConfig(total_steps=total, ckpt_dir=ckpt_dir,
                                       ckpt_every=2, log_every=0)
        tr = jax_trainer.Trainer(NO_MESH, jcfg, _shape(), tc,
                                 jax_pipeline.DataConfig(seed=5))
        tr.train(params=jp, opt=JO.init_opt_state(jcfg.train, jp),
                 start_step=0)
        return tr
    full = run(6)
    run(4, str(d))
    return jp, [r.loss for r in full.history], str(d)


def test_trainer_history_matches_reference(reference_run, tmp_path):
    jp, ref_losses, _ = reference_run
    tr = _trainers("qwen3-8b", tmp_path, 6)
    tr.train(*_port_state(tr, jp), start_step=0)
    assert [r.step for r in tr.history] == list(range(6))
    np.testing.assert_allclose([r.loss for r in tr.history], ref_losses,
                               **TOL)
    assert ckpt.latest_step(str(tmp_path)) == 6


def test_jax_checkpoint_resumes_in_port(reference_run, tmp_path):
    _, ref_losses, jax_dir = reference_run
    import shutil
    shutil.copytree(jax_dir, tmp_path / "c")
    tr = _trainers("qwen3-8b", tmp_path / "c", 6)
    tr.train()                           # resume_or_init: JAX's step_4
    assert [r.step for r in tr.history] == [4, 5]
    np.testing.assert_allclose([r.loss for r in tr.history],
                               ref_losses[4:], **TOL)


def test_port_checkpoint_resumes_in_jax(reference_run, tmp_path):
    jp, ref_losses, _ = reference_run
    tr = _trainers("qwen3-8b", tmp_path, 4)
    tr.train(*_port_state(tr, jp), start_step=0)
    assert ckpt.latest_step(str(tmp_path)) == 4
    jtc = jax_trainer.TrainerConfig(total_steps=6, ckpt_dir=str(tmp_path),
                                    ckpt_every=2, log_every=0)
    jtr = jax_trainer.Trainer(NO_MESH, jax_reduced("qwen3-8b"), _shape(),
                              jtc, jax_pipeline.DataConfig(seed=5))
    jtr.train()
    assert [r.step for r in jtr.history] == [4, 5]
    np.testing.assert_allclose([r.loss for r in jtr.history],
                               ref_losses[4:], **TOL)


def test_retry_then_success(tmp_path):
    fails = {"left": 2}

    def fault(step):
        if step == 3 and fails["left"] > 0:
            fails["left"] -= 1
            raise RuntimeError("transient failure")

    clean = _trainers("rwkv6-1.6b", tmp_path / "a", 5)
    clean.train()
    tr = _trainers("rwkv6-1.6b", tmp_path / "b", 5, fault_hook=fault,
                   max_step_retries=3)
    tr.train()
    assert [r.retried for r in tr.history] == [0, 0, 0, 2, 0]
    # the retried step starts from the params it started with
    assert [r.loss for r in tr.history] == [r.loss for r in clean.history]


def test_failure_restarts_from_checkpoint(tmp_path):
    boom = {"armed": True}

    def fault(step):
        if step == 5 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")

    clean = _trainers("qwen3-8b", tmp_path / "a", 7)
    clean.train()
    tr = _trainers("qwen3-8b", tmp_path / "b", 7, fault_hook=fault,
                   max_step_retries=0)
    tr.train()
    assert [r.step for r in tr.history] == [0, 1, 2, 3, 4, 4, 5, 6]
    got = {r.step: r.loss for r in tr.history}     # the rerun wins
    assert got == {r.step: r.loss for r in clean.history}


class _Clock:
    """A ``time`` stand-in whose ``perf_counter`` only the fault hook
    moves: the trainer's step times are then exactly what the hook says,
    whatever the CPU's load."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        return self.now


def test_straggler_watchdog(tmp_path, monkeypatch):
    """Every step takes 50 ms inside the timed window on a fake clock
    (the trainer's ``time``), so the EMA (from step 1) is 50 ms; steps
    3-5 take 600 ms, more than 3x it. Two slow steps in a row write a
    preemptive checkpoint (step_5, after step 4)."""
    slow = {3, 4, 5}
    clock = _Clock()
    monkeypatch.setattr(trainer, "time", clock)

    def fault(step):
        clock.now += 0.6 if step in slow else 0.05

    tr = _trainers("qwen3-8b", tmp_path, 7, fault_hook=fault,
                   straggler_patience=2)
    tr.train()
    assert tr.straggler_events == [3, 4, 5]
    assert [r.straggler for r in tr.history] == \
        [False, False, False, True, True, True, False]
    assert (tmp_path / "step_5").is_dir()


def test_resume_preserves_checkpoint_extra(tmp_path):
    tr = _trainers("qwen3-8b", tmp_path, 3)
    params, opt, _ = tr.init_state(0)
    ckpt.save(str(tmp_path), 1, trainer.state_to_jax(tr.acfg, params, opt),
              extra={"run_id": "r-42", "cursor": 17})
    tr2 = _trainers("qwen3-8b", tmp_path, 3)
    _, _, start = tr2.resume_or_init()
    assert start == 1
    assert tr2.resume_extra == {"run_id": "r-42", "cursor": 17}
    tr2.train()
    last = ckpt.latest_step(str(tmp_path))
    _, extra = ckpt.restore(str(tmp_path), last,
                            trainer.state_to_jax(tr.acfg, params, opt))
    assert extra == {"run_id": "r-42", "cursor": 17}


def test_programming_errors_propagate_not_retried(tmp_path):
    calls = []

    def bug(step):
        if step == 2:
            calls.append(step)
            raise ValueError("programming error, not a node failure")

    tr = _trainers("qwen3-8b", tmp_path / "a", 4, fault_hook=bug,
                   max_step_retries=3)
    with pytest.raises(ValueError, match="programming error"):
        tr.train()
    assert calls == [2]
    fails = {"left": 1}

    def node_fault(step):
        if step == 2 and fails["left"] > 0:
            fails["left"] -= 1
            raise torch.OutOfMemoryError("injected out of memory")

    tr2 = _trainers("qwen3-8b", tmp_path / "b", 4, fault_hook=node_fault,
                    max_step_retries=3)
    tr2.train()
    assert [r for r in tr2.history if r.step == 2][0].retried == 1


def test_trainer_configs_not_shared_between_instances():
    _, tcfg = _configs("qwen3-8b")
    t1 = trainer.Trainer(tcfg, _shape(), device="cpu")
    t2 = trainer.Trainer(tcfg, _shape(), device="cpu")
    assert t1.tcfg is not t2.tcfg and t1.dcfg is not t2.dcfg
    t1.tcfg.total_steps = 999
    assert t2.tcfg.total_steps == trainer.TrainerConfig().total_steps
    tc = trainer.TrainerConfig(total_steps=7)
    assert trainer.Trainer(tcfg, _shape(), tc, device="cpu").tcfg is tc


def test_no_blanket_exception_handlers_inside_train():
    """The gate of tests/test_service_api.py, over the port's train/:
    broad catches go through the named STEP_FAULTS boundary."""
    root = ROOT / "src" / "repro_torch" / "train"
    pat = re.compile(r"except +\(? *(Base)?Exception\b")
    offenders = [f"{p.name}:{i}: {line.strip()}"
                 for p in sorted(root.rglob("*.py"))
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if pat.search(line)]
    assert not offenders, offenders
    assert trainer.STEP_FAULTS == (RuntimeError, OSError)
    assert issubclass(torch.OutOfMemoryError, trainer.STEP_FAULTS)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_train_cli_runs_on_cpu(capsys):
    tr = train_cli.main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu",
                         "--steps", "3", "--seq-len", "32",
                         "--global-batch", "2", "--grad-compression", "int8"])
    out = capsys.readouterr().out
    assert re.search(r"done: 3 steps, loss [\d.]+ -> [\d.]+, stragglers=\d",
                     out), out
    assert tr.acfg.train.grad_compression == "int8"
    assert tr.acfg.train.use_flash_kernel is False
    assert all(np.isfinite(r.loss) for r in tr.history)


def test_train_cli_rerun_resumes_and_trains_nothing(capsys, tmp_path):
    """A second run on a finished checkpoint directory resumes at its
    last step and says that nothing is left to train."""
    argv = ["--arch", "qwen3-8b", "--reduced", "--device", "cpu", "--steps",
            "2", "--seq-len", "16", "--global-batch", "2", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    train_cli.main(argv)
    assert "done: 2 steps" in capsys.readouterr().out
    tr = train_cli.main(argv)
    assert tr.history == []
    assert "nothing to train: resumed at step 2, --steps 2" in \
        capsys.readouterr().out


def test_train_cli_ps_mode_and_rwkv(capsys):
    tr = train_cli.main(["--arch", "rwkv6-1.6b", "--reduced", "--device",
                         "cpu", "--steps", "2", "--seq-len", "16",
                         "--global-batch", "2", "--ps-mode"])
    assert tr.acfg.parallel.fsdp and tr.acfg.parallel.ps_mode
    assert "done: 2 steps" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-1.5-large-398b",
                                  "kimi-k2-1t-a32b"])
def test_train_cli_trains_moe_and_mamba_on_cpu(capsys, tmp_path, arch):
    """The MoE and Mamba models through the train CLI, with checkpoints
    (Jamba and Kimi-K2 on Adafactor): finite losses, the router loss in
    each step's loss."""
    tr = train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--steps", "2", "--seq-len", "16",
                         "--global-batch", "2", "--ckpt-dir", str(tmp_path),
                         "--ckpt-every", "2"])
    assert "done: 2 steps" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert all(np.isfinite(r.loss) for r in tr.history)


def test_train_config_keeps_the_wkv_kernel_off():
    """K4 has no backward, so on the card the CLI trains RWKV-6 through
    the plain chunked scan, and attention through the flash kernel."""
    cuda = train_cli.train_config("rwkv6-1.6b", reduced=True, device="cuda")
    assert cuda.train.use_rwkv_kernel is False
    assert cuda.train.use_flash_kernel is True
    cpu = train_cli.train_config("qwen3-8b", reduced=True, device="cpu")
    assert not cpu.train.use_flash_kernel and not cpu.train.use_rwkv_kernel
    assert cpu.train.grad_compression is None


def test_train_cli_refuses_a_mesh_and_a_missing_card(monkeypatch, capsys):
    """A mesh that does not fit the world (here one process) exits 2
    naming both sizes, and leaves no process group behind; the mesh
    itself runs in tests/test_torch_mesh.py."""
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu",
                        "--mesh", "2x2"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "needs 4 ranks" in err and "has 1" in err
    assert not torch.distributed.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--arch", "qwen3-8b", "--reduced"])
    assert e.value.code == 2
    assert "no CUDA GPU" in capsys.readouterr().err


def test_example_tiny_runs_on_cpu(capsys):
    example = runpy.run_path(str(ROOT / "examples" /
                                 "torch_train_ps_mode.py"),
                             run_name="example")
    tr, tr2 = example["main"](["--tiny", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "loss:" in out and "resumed from step 6" in out
    assert len(tr.history) == 6 and [r.step for r in tr2.history] == [6, 7]
