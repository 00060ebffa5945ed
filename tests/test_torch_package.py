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
# tests/test_service_api.py forbid outside src/repro/rpc/; the port's
# tracer opens live regions (profiler ranges on a device trace's clock),
# which the fabric's flush and the scheduler's step enter. Those gates
# are also why the copies split a few lines (``Name \`` + ``(args)``),
# which leaves the syntax tree unchanged, so copies are compared as
# syntax trees. The configs carry port-only fields, each defaulting to
# the reference's behaviour (a shared expert, a softmax scale, the muP
# multipliers and the norms' epsilon: Granite-4.0-H's mechanisms; MLA,
# YaRN, a dense first layer, the sigmoid router and an expert share:
# Kimi-K2-Instruct's, with ``reduced`` cutting MLA and the share, and
# the parameter counts going layer by layer over them, which the payload
# model reads with the routed experts' width), and the registry
# port-only entries kept out of ``list_archs`` (so out of every test and
# dry-run cell that holds the port to the reference);
# ``kimi_k2_1t_a32b.py``'s docstring names the entry that carries MLA.
DIFFERENCES = {
    "configs/base.py": [
        ("""    use_rope: bool = True
    # softmax scale of the scores; None = 1/sqrt(d_head)
    softmax_scale: Optional[float] = None
    # rope over interleaved pairs (x[2i], x[2i+1]) at frequency i
    # (DeepSeek-V3's) instead of the first half against the second
    rope_interleaved: bool = False
    yarn: Optional[YarnConfig] = None
    # multi-head latent attention (DeepSeek-V2/V3's MLA) where
    # kv_lora_rank is set: queries through a normed latent of
    # q_lora_rank, keys and values expanded from one normed latent of
    # kv_lora_rank shared by every head, beside one roped key of
    # qk_rope_head_dim shared by every head. d_head is the query / key
    # head dim (qk_nope_head_dim + qk_rope_head_dim), v_head_dim the
    # value's; n_kv_heads equals n_heads
    kv_lora_rank: Optional[int] = None
    q_lora_rank: Optional[int] = None
    qk_rope_head_dim: int = 0
    v_head_dim: Optional[int] = None

    @property
    def mla(self) -> bool:
        return self.kv_lora_rank is not None
""", """    use_rope: bool = True
"""),
        ("""    aux_loss_weight: float = 0.01
    # width of one shared SwiGLU expert every token runs beside the
    # routed ones; None = none
    d_ff_shared: Optional[int] = None
    # the routed experts' width where the configuration gives it apart
    # from its intermediate size, which is then the dense layers'
    # (DeepSeek-V3's ``moe_intermediate_size``); it takes precedence over
    # ``d_ff_expert``, which a harness sets from that intermediate size
    d_ff_routed: Optional[int] = None
    # 'softmax': top-k of the softmax over the router's logits;
    # 'sigmoid': DeepSeek-V3's noaux_tc, top-k of sigmoid(logits) plus
    # a selection bias (``router_bias``), weighted by the unbiased scores.
    # Either way the top-k weights are divided by their sum, then
    # multiplied by the scaling factor
    scoring: str = "softmax"
    routed_scaling_factor: float = 1.0
    # an expert-parallel share: the router's width where the layer holds
    # only ``num_experts`` of the experts, ``expert_offset`` .. +
    # num_experts - 1, and computes the assignments that fall on them
    # alone; None = num_experts (every expert held)
    router_experts: Optional[int] = None
    expert_offset: int = 0

    @property
    def expert_d_ff(self) -> int:
        \"\"\"The width of one routed expert.\"\"\"
        return self.d_ff_routed or self.d_ff_expert

    @property
    def n_routed(self) -> int:
        \"\"\"The router's width: the experts every token is routed over.\"\"\"
        return self.router_experts or self.num_experts

    @property
    def is_share(self) -> bool:
        \"\"\"Whether the layer holds only some of the router's experts.\"\"\"
        return self.n_routed != self.num_experts
""", """    aux_loss_weight: float = 0.01
"""),
        ("""    max_position_embeddings: int = 1_048_576
    # muP multipliers (None = none): the embedding's output, each
    # residual branch before its add, and the logits (divided by
    # ``logits_scaling``)
    embedding_multiplier: Optional[float] = None
    residual_multiplier: Optional[float] = None
    logits_scaling: Optional[float] = None
    # epsilon of every RMSNorm / LayerNorm and of Mamba's gated norm
    norm_eps: float = 1e-6
    # leading layers whose FFN is dense (of d_ff) where the pattern puts
    # an MoE (DeepSeek-V3's first_k_dense_replace)
    first_k_dense: int = 0
""", """    max_position_embeddings: int = 1_048_576
"""),
        ("""@dataclass(frozen=True)
class YarnConfig:
    \"\"\"YaRN's rope scaling (arXiv:2309.00071), as DeepSeek-V3 publishes
    it: the inverse frequencies blend theta^(-2i/d) with it divided by
    ``factor`` over the dims between the correction dims of
    ``beta_fast`` and ``beta_slow`` rotations in
    ``original_max_position_embeddings``; cos and sin scale by
    mscale(mscale) / mscale(mscale_all_dim), and the softmax scale by
    mscale(mscale_all_dim)^2 (mscale(m) = 0.1 m ln(factor) + 1).\"\"\"
    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


""", ""),
        ("""    def moe_layer(self, li: int) -> bool:
        \"\"\"Whether layer ``li`` (not a pattern position) runs an MoE.\"\"\"
        return li >= self.first_k_dense and \\
            self.moe_at(li % self.pattern_period)

""", ""),
        ("""    if att is not None and att.mla:
        # MLA's ranks and head dims cut alike: q / k 16 + 8 rope, v 16
        att = dataclasses.replace(att, d_head=24, qk_rope_head_dim=8,
                                  v_head_dim=16, q_lora_rank=32,
                                  kv_lora_rank=16)
    if moe is not None and m.moe.router_experts:
        # a share: 4 experts held of a router of 8, dropless
        moe = dataclasses.replace(moe, router_experts=8, d_ff_routed=96,
                                  capacity_factor=8 / moe.top_k)
""", ""),
        ("""    def param_counts(self) -> dict:
        \"\"\"Analytic parameter count per component, in elements: layer by
        layer, MLA by its ranks, a dense leading layer by ``d_ff``, an MoE
        by the experts it holds (``expert_d_ff``), its router (and the
        sigmoid router's bias) over ``n_routed`` and its shared expert.\"\"\"
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        counts = {"embed": v * d}
        if not self.tie_embeddings and not self.is_encoder:
            counts["lm_head"] = v * d
        att = self.attention
        n_mat = 3 if self.ffn_activation in ("swiglu", "geglu") else 2
        layers = 0
        for li in range(self.n_periods * self.pattern_period):
            kind = self.layer_pattern[li % self.pattern_period]
            layer = 0
            if kind == "attn" and att.mla:
                H, dr = att.n_heads, att.qk_rope_head_dim
                rq, rkv = att.q_lora_rank, att.kv_lora_rank
                layer += d * rq + rq + rq * H * att.d_head   # q, its norm
                layer += d * (rkv + dr) + rkv                # latent, norm
                layer += rkv * H * (att.d_head - dr + att.v_head_dim)
                layer += H * att.v_head_dim * d              # o
            elif kind == "attn":
                hq = att.n_heads * att.d_head
                hkv = att.n_kv_heads * att.d_head
                layer += d * hq + 2 * d * hkv + hq * d  # q,k,v,o
                if att.qkv_bias:
                    layer += hq + 2 * hkv
            elif kind == "mamba":
                di = self.ssm.expand * d
                layer += d * 2 * di                  # in_proj
                layer += di * self.ssm.d_conv        # conv
                layer += di * (2 * self.ssm.d_state + 1) + di  # x_proj-ish + dt
                layer += di * d                      # out_proj
            elif kind == "rwkv":
                layer += 4 * d * d + 6 * d           # r,k,v,o + mixes
                layer += d * d                       # gate
            # FFN
            if self.moe_layer(li):
                e = self.moe
                layer += e.num_experts * n_mat * d * e.expert_d_ff
                layer += d * e.n_routed              # router
                if e.scoring == "sigmoid":
                    layer += e.n_routed              # its selection bias
                if e.d_ff_shared is not None:
                    layer += n_mat * d * e.d_ff_shared
            else:
                layer += n_mat * d * f
            layer += 2 * d                           # two norms
            layers += layer
        counts["layers"] = layers
        counts["final_norm"] = d
        return counts

    def num_params(self) -> int:
        return int(sum(self.param_counts().values()))

    def num_active_params(self) -> int:
        \"\"\"Active params per token (MoE counts top_k experts only; a layer
        holding a share of the experts, the top_k x num_experts /
        n_routed of its experts a token reaches on average).\"\"\"
        if self.moe is None:
            return self.num_params()
        e = self.moe
        n_mat = 3 if self.ffn_activation in ("swiglu", "geglu") else 2
        idle = e.num_experts * (1 - e.top_k / e.n_routed) if e.is_share \\
            else e.num_experts - e.top_k
        dead = sum(idle * n_mat * self.d_model * e.expert_d_ff
                   for li in range(self.num_layers) if self.moe_layer(li))
        return int(self.num_params() - dead)


""", """    def param_counts(self) -> dict:
        \"\"\"Analytic parameter count per component, in elements.\"\"\"
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        counts = {"embed": v * d}
        if not self.tie_embeddings and not self.is_encoder:
            counts["lm_head"] = v * d
        per_layer = 0.0
        att = self.attention
        for pos in range(self.pattern_period):
            kind = self.layer_pattern[pos]
            layer = 0
            if kind == "attn":
                hq = att.n_heads * att.d_head
                hkv = att.n_kv_heads * att.d_head
                layer += d * hq + 2 * d * hkv + hq * d  # q,k,v,o
                if att.qkv_bias:
                    layer += hq + 2 * hkv
            elif kind == "mamba":
                di = self.ssm.expand * d
                layer += d * 2 * di                  # in_proj
                layer += di * self.ssm.d_conv        # conv
                layer += di * (2 * self.ssm.d_state + 1) + di  # x_proj-ish + dt
                layer += di * d                      # out_proj
            elif kind == "rwkv":
                layer += 4 * d * d + 6 * d           # r,k,v,o + mixes
                layer += d * d                       # gate
            # FFN
            if self.moe_at(pos):
                e = self.moe
                n_mat = 3 if self.ffn_activation in ("swiglu", "geglu") else 2
                layer += e.num_experts * n_mat * d * e.d_ff_expert
                layer += d * e.num_experts           # router
            else:
                n_mat = 3 if self.ffn_activation in ("swiglu", "geglu") else 2
                layer += n_mat * d * f
            layer += 2 * d                           # two norms
            per_layer += layer
        counts["layers"] = per_layer * self.n_periods
        counts["final_norm"] = d
        return counts

    def num_params(self) -> int:
        return int(sum(self.param_counts().values()))

    def num_active_params(self) -> int:
        \"\"\"Active params per token (MoE counts top_k experts only).\"\"\"
        if self.moe is None:
            return self.num_params()
        e = self.moe
        n_mat = 3 if self.ffn_activation in ("swiglu", "geglu") else 2
        dead = 0.0
        for pos in range(self.pattern_period):
            if self.moe_at(pos):
                dead += (e.num_experts - e.top_k) * n_mat * \\
                    self.d_model * e.d_ff_expert
        return int(self.num_params() - dead * self.n_periods)


"""),
    ],
    "configs/registry.py": [
        ("""
#: port-only architectures: reachable through ``get_config``, outside
#: ``list_archs`` (and so outside the dry run's cells), which the
#: reference's registry lists too
_PORT_ONLY_MODULES = {
    "granite-4.0-h-small":  "repro.configs.granite_4p0_h_small",
    "kimi-k2-instruct":     "repro.configs.kimi_k2_instruct",
}
""", ""),
        ("""    modules = {**_ARCH_MODULES, **_PORT_ONLY_MODULES}
    if arch not in modules:
        raise KeyError(f"unknown arch {arch!r}; known: {list(modules)}")
    mod = importlib.import_module(modules[arch])
""", """    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
"""),
    ],
    "configs/kimi_k2_1t_a32b.py": [
        ("""Its GQA attention of dh 112 mirrors the JAX package and is not Kimi-K2's
published MLA, which ``kimi-k2-instruct`` carries.
""", ""),
    ],
    "core/payload.py": [
        ("""        sizes_pool.append(d * cfg_m.moe.expert_d_ff * 4)   # one expert matrix
""", """        sizes_pool.append(d * cfg_m.moe.d_ff_expert * 4)   # one expert matrix
"""),
    ],
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
    "rpc/tracing.py": [
        ("from contextlib import contextmanager, nullcontext\n", ""),
        ("""    # live regions -----------------------------------------------------
    #: ``name -> context manager``: a profiler range that every region
    #: opens, so that a device trace shows the serving path on its own
    #: clock. The serving side installs one (this module imports no
    #: profiler); without it a region records call spans only.
    range_factory: Any = None

    @contextmanager
    def region(self, name: str, *, frame=None,
               endpoint: Optional[int] = None, span: Optional[str] = None,
               **attrs) -> Iterator[None]:
        \"\"\"A live region of the path that serves calls (``rpc.flush``,
        ``sched.step``, ``serve.decode``, ...): the range of ``name``
        around the body and, given the ``frame`` of the call it works
        for, a server span ``span`` (default ``name``) in that call's
        tree on ``endpoint``'s track, on the fabric clock. Callers
        without a tracer enter no region at all.\"\"\"
        f = self.range_factory
        with f(name) if f is not None else nullcontext():
            if frame is None:
                yield
                return
            t0 = self.now()
            yield
            self.server_span(frame, endpoint, span or name, t0,
                             self.now(), **attrs)

""", ""),
    ],
    "serve/scheduler.py": [
        ("""shows per-request timelines. The
tracer's regions nest as profiler ranges on a device trace's clock:
``rpc.flush`` around each ``sched.step``, around the engine's
``serve.prefill`` / ``serve.rebuild`` / ``serve.decode`` ops (each
``serve.launch`` then ``serve.to_host``); each decode op is also a
``decode_step`` span in its call's tree.
""", """shows per-request timelines.
"""),
        ("""        # traced: the step is the region ``sched.step`` (admission,
        # preemption and every request's engine op)
        tracer = self._server.tracer if self._server is not None else None
        if tracer is not None:
            with tracer.region("sched.step"):
                return self._step()
        return self._step()

    def _step(self) -> int:
""", ""),
    ],
    "rpc/fabric.py": [
        ("""        # traced: the whole drive is the region ``rpc.flush`` (framing,
        # delivery, the stream pumps and the handlers they run)
        if self.tracer is not None:
            with self.tracer.region("rpc.flush"):
                return self._flush(until_s)
        return self._flush(until_s)

    def _flush(self, until_s: Optional[float]) -> FlightReport:
""", ""),
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
