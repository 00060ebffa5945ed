"""The port's training over a device mesh, held on a 2 x 2 (data, model)
mesh of four gloo CPU processes against the reference's (2, 2) mesh of
four forced host devices, and against the port's own no-mesh runs.

Two module-scoped runs do the work, side by side: one ``spawn`` of the
four ranks computes every port case (tests/_torch_mesh_cases.py), one
JAX subprocess the reference's (tests/_jax_mesh_cases.py); each has a
timeout of its own. Both read the same parameters, drawn once by the
port and saved in the reference's layout. All cases are reduced configs
in fp32.

Bounds: against the port without a mesh 1e-5 (loss, gradient norm,
parameters, hidden states), where no token drops; against the
reference's mesh its own bounds (tests/test_multidevice.py): loss 1e-4,
parameters atol = rtol = 2e-3, MoE hidden states 2e-3.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _mesh_specs as SP  # noqa: E402
import _torch_mesh_cases as C  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        to_jax_params)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The shared parameters, and the reference's run started on them."""
    d = str(tmp_path_factory.mktemp("mesh"))
    C.write_params(d)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_jax_mesh_cases.py"),
         d], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    yield d, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def port(work):
    return spawn(C.run_all, 4, work[0], timeout=TIMEOUT)[0]


@pytest.fixture(scope="module")
def ref(work):
    d, proc = work
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0 and "OK" in out, err[-3000:]
    return dict(np.load(os.path.join(d, "ref.npz")))


def _ref_params(work, name, steps):
    cfg = C.config(name)
    target = to_jax_params(M.init_params(cfg, device="meta", generator=None),
                           period=cfg.model.pattern_period)
    tree, _ = ckpt.restore(os.path.join(work[0], "ref", name), steps, target)
    return C._flat(from_jax_params(tree))


@pytest.mark.parametrize("name", list(SP.TRAIN))
def test_train_steps_match_no_mesh(port, name):
    one, mesh = port[f"{name}/one/metrics"], port[f"{name}/mesh/metrics"]
    np.testing.assert_allclose(mesh, one, rtol=0, atol=1e-5)
    np.testing.assert_allclose(port[f"{name}/mesh/params"],
                               port[f"{name}/one/params"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(SP.TRAIN))
def test_train_steps_match_reference_mesh(port, ref, work, name):
    np.testing.assert_allclose(port[f"{name}/mesh/metrics"][:, 0],
                               ref[f"{name}/metrics"][:, 0], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(port[f"{name}/mesh/params"],
                               _ref_params(work, name, 2), atol=2e-3,
                               rtol=2e-3)


def test_kimi_adafactor_step_matches_reference_mesh(port, ref, work):
    """One Adafactor step of Kimi-K2 with ep and fsdp: the row and column
    means and the update RMS reduce across shards. Its aux is the mean
    of the shards' estimates, as the reference's pmean makes it, so the
    loss differs from the no-mesh one by that much (the parameters
    barely)."""
    name = "kimi_train"
    np.testing.assert_allclose(port[f"{name}/mesh/metrics"][:, 0],
                               ref[f"{name}/metrics"][:, 0], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(port[f"{name}/mesh/params"],
                               _ref_params(work, name, 1), atol=2e-3,
                               rtol=2e-3)
    np.testing.assert_allclose(port[f"{name}/mesh/params"],
                               port[f"{name}/one/params"], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("name", ["mixtral_tp", "mixtral_ep", "kimi_tp",
                                  "kimi_ep"])
def test_moe_forward_matches_reference_mesh(port, ref, name):
    np.testing.assert_allclose(port[f"{name}/mesh/hidden"],
                               ref[f"{name}/hidden"], rtol=0, atol=2e-3)
    np.testing.assert_allclose(port[f"{name}/mesh/aux"], ref[f"{name}/aux"],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["mixtral_tp", "mixtral_ep", "kimi_tp",
                                  "kimi_ep"])
def test_moe_forward_matches_no_mesh(port, name):
    """The reduced MoE configs are dropless, so the mesh changes no
    token's experts."""
    np.testing.assert_allclose(port[f"{name}/mesh/hidden"],
                               port[f"{name}/one/hidden"], rtol=0,
                               atol=1e-5)


def test_moe_capacity_is_shard_local(port, ref):
    """At capacity factor 0.5 tokens drop. Capacity counts each data
    shard's own tokens: the mesh equals the reference's mesh and the
    no-mesh model run on each shard's rows, not the whole batch."""
    name = "mixtral_drop"
    mesh = port[f"{name}/mesh/hidden"]
    np.testing.assert_allclose(mesh, ref[f"{name}/hidden"], rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(mesh, port[f"{name}/per_shard/hidden"],
                               rtol=0, atol=1e-5)
    assert np.abs(mesh - port[f"{name}/one/hidden"]).max() > 1e-2


@pytest.mark.parametrize("name", list(SP.FWD))
def test_forward_matches_no_mesh_and_reference_mesh(port, ref, name):
    """hubert-xlarge (non-causal, QKV bias, frontend embeds, fsdp) and
    gemma2 (softcaps, a window that binds at seq 128)."""
    mesh = port[f"{name}/mesh/hidden"]
    np.testing.assert_allclose(mesh, port[f"{name}/one/hidden"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(mesh, ref[f"{name}/hidden"], rtol=0,
                               atol=2e-3)


def test_prefill_and_decode_tokens_equal_no_mesh(port):
    """Qwen3 prefill then 4 greedy decode steps over the mesh (the KV
    cache's slots split over model, flash-decoding's combine)."""
    np.testing.assert_array_equal(port["greedy_qwen3/mesh"],
                                  port["greedy_qwen3/one"])


@pytest.mark.parametrize("name", ["rwkv6_fsdp", "jamba_train"])
def test_recurrent_prefill_and_decode_tokens_equal_no_mesh(port, name):
    """RWKV-6 (fsdp) and Jamba (Mamba, attention and MoE layers) prefill
    then 4 greedy decode steps over the mesh: the WKV and SSM states
    split over model by head, the conv histories by channel. The tokens
    are equal, and the logits of the prefill and of every decode step
    and the final states, gathered whole, hold at 1e-5 (a per-shard
    step that lost a small term could keep the argmax)."""
    np.testing.assert_array_equal(port[f"greedy_{name}/mesh"],
                                  port[f"greedy_{name}/one"])
    for part in ("logits", "states"):
        np.testing.assert_allclose(port[f"greedy_{name}/mesh/{part}"],
                                   port[f"greedy_{name}/one/{part}"],
                                   rtol=0, atol=1e-5, err_msg=part)


def test_jamba_adafactor_step_matches_reference_mesh(port, ref, work):
    """One Adafactor step of Jamba's period (Mamba, attention, MoE) with
    tp: the factored means reduce across shards on the stacked Mamba
    tensors. Against no mesh the cross-entropy and the parameters hold
    at 1e-5; the loss carries the router loss, the mean of the shards'
    estimates by design (see the Kimi-K2 case)."""
    name = "jamba_train"
    np.testing.assert_allclose(port[f"{name}/mesh/metrics"][:, 0],
                               ref[f"{name}/metrics"][:, 0], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(port[f"{name}/mesh/params"],
                               _ref_params(work, name, 1), atol=2e-3,
                               rtol=2e-3)
    np.testing.assert_allclose(port[f"{name}/mesh/metrics"][:, 2],
                               port[f"{name}/one/metrics"][:, 2], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(port[f"{name}/mesh/params"],
                               port[f"{name}/one/params"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["rwkv6_fsdp", "jamba_train"])
def test_recurrent_ce_gradients_match_no_mesh(port, name):
    """Every parameter's gradient of the cross-entropy over the mesh
    equals the no-mesh one: the per-head slices of replicated tensors
    sum their shards' parts, Mamba's gated RMSNorm sums its squares
    over model in both directions, RWKV's channel mix reduces the
    row-parallel value before the product."""
    np.testing.assert_allclose(port[f"{name}/mesh/ce_grads"],
                               port[f"{name}/one/ce_grads"], rtol=0,
                               atol=1e-5)


def test_checkpoints_cross_between_mesh_and_no_mesh(port):
    """Saved on the 2x2 mesh, restored with none: parameters and Adam's
    first moment equal; saved with none, restored on the mesh: equal,
    and the trainer resumes there at the saved step."""
    np.testing.assert_array_equal(port["elastic/err"], 0.0)
    step1, step2, first, n = port["elastic/steps"]
    assert (step1, step2, first, n) == (2, 1, 1, 2)


def test_train_cli_mesh_and_world_mismatch(port):
    steps, code = port["cli"]
    assert steps == 2
    assert code == 2          # --mesh 2x3 on 4 ranks


def test_rwkv_and_mamba_refused_under_a_mesh(port):
    """Nothing refuses the rwkv and mamba mixers under a mesh any more:
    the Trainer builds for RWKV-6 and Jamba on the 2x2 mesh and takes a
    step (each entry is the error raised, '' for none)."""
    rwkv, jamba = port["refused"]
    assert rwkv == "" and jamba == "", (rwkv, jamba)
