"""The port's channels (endpoints as rows) against the JAX package's
ppermute channels: the schedules list for list, every channel function
against a numpy model of ppermute (zero-fill included), and byte for
byte against the reference run on 4 host devices in one subprocess."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.channels as ref_ch
import repro_torch.core.channels as ch
from repro_torch import rpc
from repro_torch.core.payload import PayloadSpec as PortSpec
from repro_torch.core.payload import materialize

REPO = Path(__file__).resolve().parents[1]
N = 4
SIZES = (10, 300, 1024, 5000)


# ---------------------------------------------------------------------------
# schedules: pure python, list-equal to the reference
# ---------------------------------------------------------------------------

SCHEDULES = [
    ("bipartite_schedule", ([0, 1], [2, 3, 4]), {}),
    ("bipartite_schedule", ([0, 1, 2], [3, 4]), {}),
    ("bipartite_schedule", ([0], [1, 2, 3, 4, 5]), {}),
    ("bipartite_schedule", ([0, 1, 2, 3], [4, 5, 6, 7]), {}),
    ("all_to_all_schedule", (2,), {}),
    ("all_to_all_schedule", (7,), {}),
    ("ring_schedule", (2,), {}),
    ("ring_schedule", (5,), {"n_chunks": 3}),
    ("incast_schedule", (1,), {}),
    ("incast_schedule", (4,), {"n_chunks": 2}),
    ("incast_schedule", (3,), {"server": 2, "n_chunks": 2}),
    ("rpcs_per_round", (2, 3), {}),
    ("fc_rpcs_per_round", (6,), {}),
    ("ring_rpcs_per_round", (4, 3), {}),
    ("incast_rpcs_per_round", (5, 2), {}),
]


@pytest.mark.parametrize("name,args,kw", SCHEDULES,
                         ids=[f"{s[0]}{s[1]}" for s in SCHEDULES])
def test_schedules_equal_reference(name, args, kw):
    assert getattr(ch, name)(*args, **kw) == getattr(ref_ch, name)(*args,
                                                                   **kw)


# ---------------------------------------------------------------------------
# channel functions: the cases both packages run
# ---------------------------------------------------------------------------

# name -> (channel function, args after (mesh, n_buffers), kwargs)
CASES = {
    "echo": ("p2p_echo_fn", (), {}),
    "echo_2_3": ("p2p_echo_fn", (), {"src": 2, "dst": 3}),
    "send": ("p2p_send_fn", (), {}),
    "ps_1x3": ("ps_round_fn", (1, 3), {}),
    "ps_2x2": ("ps_round_fn", (2, 2), {}),
    "fc_4": ("fully_connected_fn", (4,), {}),
    "fc_3": ("fully_connected_fn", (3,), {}),
    "ring_4x2": ("ring_fn", (4,), {"n_chunks": 2}),
    "ring_3x1": ("ring_fn", (3,), {}),
    "incast_3x2": ("permute_rounds_fn",
                   (ref_ch.incast_schedule(3, n_chunks=2),), {}),
}
MODES = [False, True]
PARITY = [(c, m) for c in CASES for m in MODES] + [("fsdp", False)]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (N, s), dtype=np.uint8) for s in SIZES]


def _rounds(name):
    """The ppermute rounds a case runs (for the numpy model)."""
    fn, args, kw = CASES[name]
    if fn == "p2p_echo_fn":
        s, d = kw.get("src", 0), kw.get("dst", 1)
        return [[(s, d)], [(d, s)]]
    if fn == "ps_round_fn":
        ps, w = list(range(args[0])), list(range(args[0], sum(args)))
        return ch.bipartite_schedule(ps, w) + ch.bipartite_schedule(w, ps)
    if fn == "fully_connected_fn":
        return ch.all_to_all_schedule(args[0])
    if fn == "ring_fn":
        return ch.ring_schedule(args[0], kw.get("n_chunks", 1))
    return args[0]


def _np_ppermute(x, perm):
    out = np.zeros_like(x)
    for s, d in perm:
        out[d] = x[s]
    return out


def _np_model(name, serialized, host):
    if name == "fsdp":
        return [np.minimum(b.astype(np.float32) * np.float32(1.000001)
                           * N, 255).astype(np.uint8) for b in host]
    if name == "send":
        if serialized:
            packed = _np_ppermute(np.concatenate(host, -1), [(0, 1)])
            return [packed, _np_ppermute(packed[:, :64], [(1, 0)])]
        out = [_np_ppermute(b, [(0, 1)]) for b in host]
        return out + [_np_ppermute(out[0][:, :64], [(1, 0)])]
    out = []
    for b in host:
        for perm in _rounds(name):
            b = _np_ppermute(b, perm)
        out.append(b)
    return out


def _port(name, serialized, host, device="cpu"):
    mesh = ch.make_net_mesh(N, device=device)
    if name == "fsdp":
        fn = ch.fsdp_pull_push_fn(mesh, len(host))
    else:
        fname, args, kw = CASES[name]
        fn = getattr(ch, fname)(mesh, len(host), *args, serialized=serialized,
                                **kw)
    outs = fn(*[torch.from_numpy(b.copy()).to(device) for b in host])
    return [o.cpu().numpy() for o in outs]


@pytest.mark.parametrize("name,serialized", PARITY,
                         ids=[f"{c}-{'ser' if m else 'nonser'}"
                              for c, m in PARITY])
def test_channels_match_numpy_ppermute_model(name, serialized):
    host = _inputs()
    got = _port(name, serialized, host)
    want = _np_model(name, serialized, host)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_rows_that_receive_nothing_are_zero():
    host = _inputs()
    out = _port("echo", False, host)
    for o, h in zip(out, host):
        np.testing.assert_array_equal(o[0], h[0])
        assert not o[1:].any()


def test_fsdp_cast_saturates():
    host = [np.array([[0, 1, 63, 64, 100, 254]] * N, np.uint8)]
    out, = _port("fsdp", False, host)
    assert out[0].tolist() == [0, 4, 252, 255, 255, 255]


def test_rounds_refuse_repeated_endpoints():
    mesh = ch.make_net_mesh(N, device="cpu")
    with pytest.raises(ValueError, match="unique"):
        ch.permute_rounds_fn(mesh, 1, [[(0, 1), (2, 1)]])
    with pytest.raises(ValueError, match="endpoints"):
        ch.permute_rounds_fn(mesh, 1, [[(0, N)]])


def test_mesh_defaults_to_eight_rows_on_the_card(monkeypatch):
    assert ch.make_net_mesh(device="cpu").shape == {ch.AXIS: 8}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        ch.make_net_mesh()


def test_device_payload_rows_are_the_aligned_payload():
    spec = PortSpec(sizes=SIZES, scheme="t", categories=("small",) * 4)
    bufs = ch.device_payload(ch.make_net_mesh(N, device="cpu"), spec,
                             seed=5)
    for b, h in zip(bufs, materialize(spec, seed=5, tpu_align=True)):
        assert tuple(b.shape) == (N, h.size)
        np.testing.assert_array_equal(b.numpy(), np.broadcast_to(h, b.shape))


# ---------------------------------------------------------------------------
# byte-exact parity with the JAX channels on 4 host devices
# ---------------------------------------------------------------------------

REF_SCRIPT = """
import sys
import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import channels as ch
from repro.core.payload import PayloadSpec

src, dst, cases = sys.argv[1], sys.argv[2], eval(sys.argv[3])
mesh = ch.make_net_mesh(4)
assert mesh.shape[ch.AXIS] == 4
inp = np.load(src)
host = [inp[f"b{i}"] for i in range(len(inp.files))]
bufs = [jax.device_put(b, NamedSharding(mesh, P(ch.AXIS))) for b in host]
res = {}
for name, fname, args, kw, ser in cases:
    if fname == "fsdp_pull_push_fn":
        fn = ch.fsdp_pull_push_fn(mesh, len(bufs))
    else:
        fn = getattr(ch, fname)(mesh, len(bufs), *args, serialized=ser, **kw)
    for i, o in enumerate(fn(*bufs)):
        res[f"{name}|{ser}|{i}"] = np.asarray(o)
spec = PayloadSpec(sizes=(10, 300, 1024, 5000), scheme="t",
                   categories=("small",) * 4)
for i, b in enumerate(ch.device_payload(mesh, spec, seed=5)):
    res[f"device_payload|False|{i}"] = np.asarray(b)
np.savez(dst, **res)
print("ok", len(res))
"""


@pytest.fixture(scope="module")
def reference_outputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("channels")
    np.savez(d / "in.npz", **{f"b{i}": b for i, b in enumerate(_inputs())})
    cases = [(name, "fsdp_pull_push_fn", (), {}, False) if name == "fsdp"
             else (name, CASES[name][0], CASES[name][1], CASES[name][2], ser)
             for name, ser in PARITY]
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(d / "in.npz"),
                        str(d / "out.npz"), repr(cases)], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    out = np.load(d / "out.npz")
    return {k: out[k] for k in out.files}


def _ref(outputs, name, serialized):
    keys = sorted((k for k in outputs
                   if k.startswith(f"{name}|{serialized}|")),
                  key=lambda k: int(k.rsplit("|", 1)[1]))
    return [outputs[k] for k in keys]


@pytest.mark.parametrize("name,serialized", PARITY,
                         ids=[f"{c}-{'ser' if m else 'nonser'}"
                              for c, m in PARITY])
def test_channels_equal_jax_reference_bytes(reference_outputs, name,
                                            serialized):
    want = _ref(reference_outputs, name, serialized)
    got = _port(name, serialized, _inputs())
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_device_payload_equals_jax_reference(reference_outputs):
    want = _ref(reference_outputs, "device_payload", False)
    spec = PortSpec(sizes=SIZES, scheme="t", categories=("small",) * 4)
    got = ch.device_payload(ch.make_net_mesh(N, device="cpu"), spec, seed=5)
    assert len(got) == len(want) == len(SIZES)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


# ---------------------------------------------------------------------------
# the collective transport over the rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("serialized", MODES)
def test_collective_transport_delivers_a_flight(serialized):
    spec = PortSpec(sizes=(128, 256), scheme="t",
                    categories=("small", "small"))
    mesh = ch.make_net_mesh(N, device="cpu")
    tr = rpc.make_transport("collective", 3, mesh=mesh, spec=spec,
                            serialized=serialized)
    assert tr.n_endpoints == 3 and not tr.dispatches
    frames = [rpc.make_frame(i, "m", [np.zeros(128, np.uint8),
                                      np.zeros(256, np.uint8)],
                             serialized=serialized) for i in range(3)]
    msgs = [rpc.Message(s, d, f) for (s, d), f in
            zip([(0, 1), (1, 2), (2, 0)], frames)]
    out = tr.deliver(msgs)
    assert out.elapsed_s > 0 and out.rounds == 1 and not out.modeled
    assert len(tr._fns) == 1
    assert rpc.CollectiveTransport(mesh, spec).n_endpoints == N
