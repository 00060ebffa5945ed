"""Batched serving engine: prefill + decode with per-layer KV/SSM state,
greedy/temperature sampling, continuous batching through a per-endpoint
request scheduler.

All generation — local ``generate`` calls and rpc-served traffic —
runs through a :class:`repro_torch.serve.scheduler.ServeScheduler`: a queue
of in-flight requests advanced one token per shared decode step, with
admission gated by ``max_batch`` and a modeled KV-cache block budget,
and preemption-by-recompute when decode growth exhausts the budget
(see ``docs/SERVE.md``). ``attach`` builds one scheduler per served
endpoint, so requests that arrive while others are mid-decode join the
running step instead of queueing behind a whole batch.

Generation requests arrive through the rpc fabric: the engine binds
the ``Serve`` service (:data:`SERVE_SERVICE`) on an ``rpc.Server``
endpoint via ``attach``/``serve_loopback``, so serving traffic
exercises the same framing / flow-control / transport stack the
communication benchmarks measure. The service has two methods:

  ``generate``         unary — the whole (B, new) token block in one
                       reply (the original wire shape).
  ``generate_stream``  server-streaming — one chunk per decode step,
                       each a (B,) int32 token vector, emitted
                       incrementally from the shared step (an
                       ``rpc.StreamPump``), so concurrent streams
                       interleave chunk-by-chunk over the fabric.

``serve_stub(channel)`` builds the generated client stub;
``rpc_generate_stream`` is a convenience wrapper over it (the reference's
deprecated ``rpc_generate`` shim is not ported).

Multi-host (PS-style) serving: ``serve_cluster`` binds the service on
every ``ps`` endpoint of a ``rpc.ClusterSpec`` and hands each
``worker`` endpoint a :class:`ShardedServeStub` — a dispatch client
that shards generation requests across the PS endpoints under a
``round_robin`` or ``least_loaded`` policy, so several client
endpoints generate concurrently over per-link-priced cluster routes.

On a CUDA device a request decodes from a fixed slot (:class:`_DecodeSlot`):
its prefill's states are copied into buffers that one CUDA graph of the
batch-1 decode step reads and writes, and every decode after the slot's
first replays that graph, so the host enqueues one graph a token instead
of the step's thousand-odd operations. Sampling stays outside the graph.
Elsewhere (the CPU) the step runs eagerly.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as M
from repro_torch.models.layers import profiler_range
from repro_torch.rpc.interceptors import (ClientInterceptor,
                                          MetricsInterceptor,
                                          is_resource_exhausted)
from repro_torch.serve.scheduler import Request, ServeScheduler


@dataclass
class ServeConfig:
    max_seq: int = 512
    max_new_tokens: int = 32
    temperature: float = 0.0     # 0 = greedy
    eos_id: Optional[int] = None
    seed: int = 0


class ServeEngine:
    """``params`` may hold fp32 masters: they are cast to the config's
    compute dtype once, here, and the engine runs on their device."""

    def __init__(self, acfg: ArchConfig, params,
                 cfg: ServeConfig = ServeConfig()):
        assert not acfg.model.is_encoder, "encoder models do not decode"
        self.acfg, self.cfg = acfg, cfg
        self.params = M.cast_floats(params,
                                    M.dtype_of(acfg.train.compute_dtype))
        self.device = self.params["embed"].device
        self._prefill = steps_lib.make_prefill_step(acfg,
                                                    max_seq=cfg.max_seq)
        self._decode = {}
        #: decode slots by row count, made on demand (CUDA only)
        self._slots: Dict[int, List[_DecodeSlot]] = {}
        self._pool = self._stream = None      # the graphs' pool, stream
        #: how decode steps ran: a slot's first decode runs eagerly and is
        #: then captured, its later ones replay the graph; where no slot
        #: holds the states (the CPU) the step runs eagerly
        self.counters = {"graph_captures": 0, "graph_replays": 0,
                         "eager_decodes": 0}
        #: per-endpoint ServeScheduler, populated by :meth:`attach`
        self.schedulers: Dict = {}
        #: host seconds of every prefill / decode op, each ending in the
        #: device-to-host copy of its sampled token (so the device work
        #: is inside it)
        self.op_seconds: Dict[str, List[float]] = {"prefill": [],
                                                   "decode": []}

    def _decode_fn(self, batch: int):
        if batch not in self._decode:
            self._decode[batch] = steps_lib.make_decode_step(self.acfg,
                                                             batch)
        return self._decode[batch]

    def _sample(self, logits: torch.Tensor, key: prng.Key) -> torch.Tensor:
        """Greedy: the first maximal index, as ``jnp.argmax``. With a
        temperature: ``categorical(key, logits / T)`` on JAX's key chain,
        in the logits' dtype. T is rounded to that dtype first, as JAX
        casts a Python float against a bfloat16 array, and divides as a
        tensor on the logits' device: a Python scalar would be multiplied
        by its reciprocal on the card, and a copied one would wait for
        the device."""
        last = logits[:, -1]
        if self.cfg.temperature <= 0.0:
            return torch.argmax(last, dim=-1)
        temp = torch.tensor(self.cfg.temperature, dtype=last.dtype).item()
        return prng.categorical(key, last / torch.full(
            (), temp, dtype=last.dtype, device=last.device))

    def _prompts(self, req: Request) -> Dict[str, torch.Tensor]:
        return {"tokens": torch.as_tensor(np.asarray(req.prompts),
                                          device=self.device)}

    @staticmethod
    def _host(tok: torch.Tensor) -> np.ndarray:
        return tok.to(torch.int32).cpu().numpy()

    # ------------------------------------------------------------------
    # scheduler model ops: one request's prefill / decode-step /
    # state rebuild, each at the request's own batch size — the compute
    # half of the continuous-batching loop (ServeScheduler owns the
    # queueing half). Each request walks JAX's key chain from
    # PRNGKey(cfg.seed), split in the same order in all three as the
    # reference splits it, so a preempted request resumes identically
    # and draws the reference's tokens.
    # ------------------------------------------------------------------

    def scheduler_prefill(self, req: Request) -> np.ndarray:
        """Prefill ``req`` and sample its first token; leaves the
        request's decode runtime (states, last token, key of JAX's key
        chain) on it."""
        return self._op("prefill", req, self._launch_prefill)

    def scheduler_decode(self, req: Request) -> np.ndarray:
        """Advance ``req`` one decode step; returns the (B,) token."""
        return self._op("decode", req, self._launch_decode)

    def scheduler_rebuild(self, req: Request) -> None:
        """Recompute a preempted request's runtime from its prompt and
        recorded tokens (teacher-forced replay of the exact prefill +
        decode + key-split sequence, so the rebuilt states equal the ones
        dropped at preemption)."""
        tracer = _tracer_of(req)
        if tracer is None:
            self._replay(req)
            return
        with tracer.region("serve.rebuild"), tracer.region("serve.launch"):
            self._replay(req)

    def _op(self, kind: str, req: Request, launch) -> np.ndarray:
        """One prefill or decode op, timed into ``op_seconds[kind]``:
        ``launch(req)`` enqueues the forward and the sampling, and the
        token's copy to the host waits for the device. For a streamed
        call on a traced fabric the op is the region ``serve.<kind>``
        around ``serve.launch`` and ``serve.to_host``, and a decode op
        is also a ``decode_step`` span in the call's tree."""
        t0 = time.perf_counter()
        tracer = _tracer_of(req)
        if tracer is None:
            out = self._host(launch(req))
        else:
            pump = req.pump
            call = (dict(frame=pump.frame, endpoint=pump.server.endpoint,
                         span="decode_step", request=req.id)
                    if kind == "decode" else {})
            with tracer.region(f"serve.{kind}", **call):
                with tracer.region("serve.launch"):
                    tok = launch(req)
                with tracer.region("serve.to_host"):
                    out = self._host(tok)
        self.op_seconds[kind].append(time.perf_counter() - t0)
        return out

    def _launch_prefill(self, req: Request) -> torch.Tensor:
        states, logits = self._prefill(self.params, self._prompts(req))
        key, k0 = prng.split(prng.prng_key(self.cfg.seed))
        tok = self._sample(logits, k0)
        req.runtime = (self._hold(req, states, tok), tok, key)
        return tok

    def _launch_decode(self, req: Request) -> torch.Tensor:
        states, tok, key = req.runtime
        key, k = prng.split(key)
        states, logits = self._decode_step(req, states, tok)
        tok = self._sample(logits, k)
        req.runtime = (states, tok, key)
        return tok

    def _replay(self, req: Request) -> None:
        self._launch_prefill(req)
        for _ in range(len(req.tokens) - 1):
            self._launch_decode(req)

    # ------------------------------------------------------------------
    # decode slots and their CUDA graphs
    # ------------------------------------------------------------------

    def _hold(self, req: Request, states, tok: torch.Tensor):
        """The states ``req`` decodes from. On a CUDA device those of a
        free slot of its row count, which ``req`` now owns: a fresh
        slot adopts the prefill's states, a reused one copies them in.
        Elsewhere the prefill's own."""
        if self.device.type != "cuda":
            return states
        slots = self._slots.setdefault(req.rows, [])
        slot = next((s for s in slots if s.free()), None)
        if slot is None:
            slot = _DecodeSlot(states, tok)
            slots.append(slot)
        else:
            _copy_new(slot.states, states)
        slot.owner = req
        return slot.states

    def _decode_step(self, req: Request, states, tok: torch.Tensor):
        """One decode step of ``req`` from ``states`` at its last token
        ``tok``: the replay of its slot's graph (the region
        ``serve.graph`` on a traced call), the slot's first step and its
        capture, or, where no slot holds ``states``, the eager step.
        Returns (states, logits)."""
        slot = next((s for s in self._slots.get(req.rows, ())
                     if s.states is states), None)
        if slot is None:
            self.counters["eager_decodes"] += 1
            return self._decode_fn(req.rows)(self.params, states,
                                             tok[:, None], None)
        slot.tok.copy_(tok[:, None])
        if slot.graph is None:
            return self._capture(req.rows, slot)
        tracer = _tracer_of(req)
        with (tracer.region("serve.graph") if tracer is not None
              else nullcontext()):
            slot.graph.replay()
        self.counters["graph_replays"] += 1
        return slot.states, slot.logits

    def _capture(self, rows: int, slot: "_DecodeSlot"):
        """A slot's first decode step, run eagerly on a side stream (the
        warm-up a capture needs) with its new states copied into the
        slot's, then captured as a CUDA graph over the slot's buffers:
        the same step, ending in the same copies. Every slot's graph
        shares one memory pool, as replays run one at a time on one
        stream. Returns the eager step's (states, logits)."""
        decode = self._decode_fn(rows)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            states, logits = decode(self.params, slot.states, slot.tok,
                                    None)
            _copy_new(slot.states, states)
        main.wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            new, slot.logits = decode(self.params, slot.states, slot.tok,
                                      None)
            _copy_new(slot.states, new)
        slot.graph = graph
        self.counters["graph_captures"] += 1
        return slot.states, logits

    def make_scheduler(self, *, max_batch: int = 8,
                       kv_blocks: Optional[int] = None,
                       block_size: int = 16,
                       sched_policy: str = "fifo",
                       starvation_age_s: Optional[float] = None
                       ) -> ServeScheduler:
        """A continuous-batching scheduler over this engine's model
        ops (``attach`` builds one per served endpoint).
        ``sched_policy`` picks the admission order (``fifo`` or
        ``sjf``; see :class:`repro_torch.serve.scheduler.ServeScheduler`)."""
        return ServeScheduler(self, max_batch=max_batch,
                              kv_blocks=kv_blocks,
                              block_size=block_size,
                              policy=sched_policy,
                              starvation_age_s=starvation_age_s)

    def generate_tokens(self, prompts: np.ndarray,
                        max_new_tokens: Optional[int] = None
                        ) -> Iterator[np.ndarray]:
        """Token-by-token generation: yields one (B,) token vector per
        decode step — the unit the server-streaming ``generate_stream``
        method ships as a chunk. Runs the request through a private
        unconstrained scheduler, so the op/key sequence (and therefore
        every token) is identical to a request sharing a served
        endpoint's continuous batch."""
        sched = self.make_scheduler(max_batch=1)
        req = sched.submit(np.asarray(prompts), max_new_tokens)
        return sched.stream_tokens(req)

    def generate(self, prompts: np.ndarray,
                 max_new_tokens: Optional[int] = None) -> np.ndarray:
        """prompts: (B, S) int32 (right-aligned, no padding support needed
        for fixed-length prompt batches). Returns (B, new) int32."""
        toks = list(self.generate_tokens(prompts, max_new_tokens))
        return np.stack(toks, axis=1)

    # ------------------------------------------------------------------
    # rpc endpoint
    # ------------------------------------------------------------------

    def attach(self, server, *, max_batch: int = 8,
               kv_blocks: Optional[int] = None,
               block_size: int = 16, sched_policy: str = "fifo",
               starvation_age_s: Optional[float] = None
               ) -> ServeScheduler:
        """Bind this engine's Serve service on an ``rpc.Server``, with
        a dedicated continuous-batching scheduler for the endpoint
        (``self.schedulers[endpoint]``; also returned). The scheduler
        adopts the server's clock/tracer for phase spans, and publishes
        its counters through a ``MetricsInterceptor`` when the server's
        chain has one (under ``serve:scheduler@<endpoint>``)."""
        sched = self.make_scheduler(max_batch=max_batch,
                                    kv_blocks=kv_blocks,
                                    block_size=block_size,
                                    sched_policy=sched_policy,
                                    starvation_age_s=starvation_age_s)
        self.schedulers[server.endpoint] = sched
        return bind_scheduler(server, sched)

    def serve_loopback(self, *, endpoint: int = 0, client: int = 1,
                       serialized: bool = True, tracer=None,
                       max_batch: int = 8,
                       kv_blocks: Optional[int] = None,
                       block_size: int = 16,
                       sched_policy: str = "fifo",
                       starvation_age_s: Optional[float] = None):
        """One-call wiring for single-host serving experiments: a
        loopback-transport fabric with this engine at ``endpoint``.
        ``tracer`` (a ``rpc.Tracer``) records per-call span trees —
        including the scheduler's waiting/prefill/decode/preempted
        phases and the engine's ``decode_step`` spans — and opens the
        serving path's regions (``rpc.flush``, ``sched.step``,
        ``serve.*``) as profiler ranges. ``max_batch`` / ``kv_blocks`` /
        ``block_size`` configure the endpoint's scheduler. Returns
        (fabric, client channel)."""
        from repro_torch import rpc as rpclib
        fabric = rpclib.RpcFabric(
            rpclib.make_transport("loopback",
                                  max(endpoint, client) + 1),
            tracer=_ranged(tracer))
        self.attach(fabric.add_server(endpoint), max_batch=max_batch,
                    kv_blocks=kv_blocks, block_size=block_size,
                    sched_policy=sched_policy,
                    starvation_age_s=starvation_age_s)
        return fabric, fabric.channel(client, endpoint,
                                      serialized=serialized)

    def serve_cluster(self, cluster, *, serialized: bool = True,
                      policy: str = "round_robin", ps_job: str = "ps",
                      worker_job: str = "worker",
                      client_interceptors=None,
                      server_interceptors=None, fault=None,
                      tracer=None, max_batch: int = 8,
                      kv_blocks: Optional[int] = None,
                      block_size: int = 16,
                      sched_policy: str = "fifo",
                      starvation_age_s: Optional[float] = None):
        """Multi-endpoint serving over a cluster transport: this
        engine's ``Serve`` service bound on every ``ps_job`` endpoint
        of ``cluster`` (a ``rpc.ClusterSpec`` / dict / JSON), one
        :class:`ShardedServeStub` per ``worker_job`` endpoint. Returns
        ``(fabric, {worker_name: ShardedServeStub})`` — submit from
        several workers, then ``fabric.flush()`` drives all of them
        concurrently through per-link-priced routes.

        Failure hardening: ``client_interceptors`` /
        ``server_interceptors`` seed the fabric's chains (metrics,
        deadline, retry); ``fault`` (a dict of
        ``FaultInjectionTransport`` kwargs) wraps the cluster transport
        in a seeded fault schedule; and endpoints that advertise an
        ``admission_limit`` in the spec get an ``AdmissionInterceptor``
        installed automatically, fed by a server-side
        ``MetricsInterceptor`` when one is present in the chain.
        ``tracer`` (a ``rpc.Tracer``) records per-call span trees —
        spans follow calls across endpoints and through shard
        failover re-routes — and opens the serving path's regions as
        profiler ranges.

        ``max_batch`` / ``kv_blocks`` / ``block_size`` configure each
        PS endpoint's continuous-batching scheduler; each scheduler
        reports its load as a metrics gauge that the
        ``scheduler_least_loaded`` dispatch policy reads (admission
        control sheds on the per-flight dispatch queue depth)."""
        from repro_torch import rpc as rpclib
        from repro_torch.rpc.cluster import as_cluster_spec
        cluster = as_cluster_spec(cluster)
        ps = cluster.job_endpoints(ps_job)
        workers = cluster.job_endpoints(worker_job)
        if not ps or not workers:
            raise ValueError(
                f"serve_cluster needs >= 1 {ps_job!r} and >= 1 "
                f"{worker_job!r} endpoint; cluster jobs: "
                f"{ {j: len(e) for j, e in cluster.jobs.items()} }")
        transport = rpclib.make_transport("cluster", cluster=cluster)
        if fault:
            transport = rpclib.make_transport("fault", inner=transport,
                                              **fault)
        fabric = rpclib.RpcFabric(
            transport, client_interceptors=client_interceptors,
            server_interceptors=server_interceptors, tracer=_ranged(tracer))
        limits = cluster.admission_limits()
        if limits and not any(isinstance(si, rpclib.AdmissionInterceptor)
                              for si in fabric.server_interceptors):
            metrics = next(
                (si for si in fabric.server_interceptors
                 if isinstance(si, rpclib.MetricsInterceptor)), None)
            fabric.server_interceptors.append(
                rpclib.AdmissionInterceptor(limits=limits,
                                            metrics=metrics))
        for name in ps:
            self.attach(fabric.add_server(name), max_batch=max_batch,
                        kv_blocks=kv_blocks, block_size=block_size,
                        sched_policy=sched_policy,
                        starvation_age_s=starvation_age_s)
        stubs = {w: ShardedServeStub(fabric, w, ps, policy=policy,
                                     serialized=serialized)
                 for w in workers}
        return fabric, stubs


class _DecodeSlot:
    """Fixed decode buffers of one request at a given row count: its
    states (KV caches at ``max_seq``, positions, recurrent states), its
    input token, and once captured the CUDA graph of one decode step
    over them with that graph's logits. A slot is owned by the request
    that holds its states in its runtime; the scheduler drops a
    request's runtime at finish, preemption and cancellation, which
    frees the slot."""

    def __init__(self, states, tok: torch.Tensor):
        self.states = states
        self.tok = torch.empty_like(tok[:, None])
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.owner: Optional[Request] = None

    def free(self) -> bool:
        rt = self.owner.runtime if self.owner is not None else None
        return rt is None or rt[0] is not self.states


def _copy_new(static, new) -> None:
    """Copy each tensor of the state tree ``new`` into ``static``'s, where
    it is another tensor (a KV cache written in place is the same one)."""
    for dst, src in zip(tree_leaves(static), tree_leaves(new)):
        if dst is not src:
            dst.copy_(src)


# ---------------------------------------------------------------------------
# generate-over-rpc wire codec + generated stub
# ---------------------------------------------------------------------------

def _i32_buf(values) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(values, dtype="<i4")) \
        .view(np.uint8).reshape(-1)


def encode_generate_request(prompts: np.ndarray,
                            max_new_tokens: int = 0) -> List[np.ndarray]:
    """[header(B, S, max_new_tokens) | row-major int32 tokens]."""
    B, S = prompts.shape
    return [_i32_buf([B, S, max_new_tokens]),
            _i32_buf(prompts)]


def decode_generate_request(bufs: List[np.ndarray]
                            ) -> Tuple[np.ndarray, int]:
    B, S, mnt = np.ascontiguousarray(bufs[0]).view("<i4")[:3]
    prompts = np.ascontiguousarray(bufs[1]).view("<i4") \
        .reshape(int(B), int(S))
    return prompts, int(mnt)


def encode_generate_reply(tokens: np.ndarray) -> List[np.ndarray]:
    B, N = tokens.shape
    return [_i32_buf([B, N]), _i32_buf(tokens)]


def decode_generate_reply(bufs: List[np.ndarray]) -> np.ndarray:
    B, N = np.ascontiguousarray(bufs[0]).view("<i4")[:2]
    return np.ascontiguousarray(bufs[1]).view("<i4") \
        .reshape(int(B), int(N))


def decode_token_chunk(bufs: List[np.ndarray]) -> np.ndarray:
    """One ``generate_stream`` chunk -> (B,) int32 token vector."""
    return np.ascontiguousarray(bufs[0]).view("<i4").copy()


def _build_serve_service():
    from repro_torch.rpc.service import (SERVER_STREAM, UNARY, Codec,
                                   MethodSpec, ServiceDef)
    request_codec = Codec(
        encode=lambda r: encode_generate_request(*r),
        decode=lambda bufs: decode_generate_request(bufs))
    reply_codec = Codec(encode=lambda t: encode_generate_reply(t),
                        decode=decode_generate_reply)
    return ServiceDef("Serve", (
        MethodSpec("generate", UNARY, request_codec=request_codec,
                   response_codec=reply_codec),
        MethodSpec("generate_stream", SERVER_STREAM,
                   request_codec=request_codec),
    ))


#: the serving service: unary ``generate`` + streaming ``generate_stream``
SERVE_SERVICE = _build_serve_service()


def serve_handlers(scheduler: ServeScheduler):
    """The ``Serve`` service handler table over a scheduler: unary
    ``generate`` runs the request to completion in the endpoint's
    shared continuous batch; ``generate_stream`` wraps the request's
    token stream in an ``rpc.StreamPump`` (one chunk per flush
    iteration). Engine-agnostic — anything implementing the scheduler
    model ops serves through it, which is how the workload tier serves
    a model-free synthetic engine over the same wire surface."""
    def generate(bufs: List[np.ndarray]) -> List[np.ndarray]:
        prompts, mnt = decode_generate_request(bufs)
        out = scheduler.run(scheduler.submit(prompts, mnt or None))
        return encode_generate_reply(out)

    def generate_stream(bufs: List[np.ndarray]):
        from repro_torch import rpc as rpclib
        prompts, mnt = decode_generate_request(bufs)
        req = scheduler.submit(prompts, mnt or None)
        pump = rpclib.StreamPump(
            [_i32_buf(tok)] for tok in scheduler.stream_tokens(req))
        req.pump = pump          # phase spans attribute to this call
        return pump

    return {"generate": generate, "generate_stream": generate_stream}


def _ranged(tracer):
    """``tracer`` with :func:`profiler_range` as its regions' range, so
    that a device trace shows them (None stays None)."""
    if tracer is not None and tracer.range_factory is None:
        tracer.range_factory = profiler_range
    return tracer


def _tracer_of(req: Request):
    """The tracer of the streamed call ``req`` serves: its pump is bound
    to the call's server at dispatch. None for an untraced fabric or a
    unary call, whose ops are then no regions."""
    pump = req.pump
    return pump.server.tracer if pump is not None \
        and pump.server is not None else None


def bind_scheduler(server, scheduler: ServeScheduler) -> ServeScheduler:
    """Wire one scheduler onto one ``rpc.Server`` endpoint: adopt the
    server's clock/tracer, register the ``Serve`` service, and publish
    the scheduler's counters through a server-side
    ``MetricsInterceptor`` when the chain has one (under
    ``serve:scheduler@<endpoint>`` — the gauge the
    ``scheduler_least_loaded`` dispatch policy reads)."""
    scheduler.bind(server)
    server.add_service(SERVE_SERVICE, serve_handlers(scheduler))
    metrics = next((si for si in server.interceptors
                    if isinstance(si, MetricsInterceptor)), None)
    if metrics is not None:
        metrics.attach_gauges(f"serve:scheduler@{server.endpoint}",
                              scheduler.stats)
    return scheduler

#: wire name of the unary method (kept for callers that log/match on it)
GENERATE_METHOD = SERVE_SERVICE.full_name("generate")


def serve_stub(channel):
    """The generated ``Serve`` client stub over an existing channel
    (served from the fabric's stub cache)."""
    return channel.fabric.stub(SERVE_SERVICE, channel.src, channel.dst,
                               serialized=channel.serialized)


#: dispatch policies ShardedServeStub understands
DISPATCH_POLICIES = ("round_robin", "least_loaded",
                     "scheduler_least_loaded")


class ShardFailoverInterceptor(ClientInterceptor):
    """Client-side failover for :class:`ShardedServeStub`: a dispatch a
    PS shard rejected with a transient ``resource exhausted`` error
    (its admission control) is transparently re-issued on the NEXT
    shard instead of being retried against the overloaded one. One
    instance is shared per fabric by every ShardedServeStub, installed
    innermost in the client chain so it consumes the rejection before
    an outer ``RetryInterceptor`` burns an attempt on the same shard.
    Each shard is tried at most once per call; when every shard has
    rejected it, the failure surfaces (an outer retry may still re-try
    the whole cycle on a later, less loaded flight)."""

    def __init__(self):
        self.failovers = 0

    def on_complete(self, ctx, event):
        route = ctx.meta.get("shard_route")
        if route is None or event.kind != "error" \
                or ctx.request is None:
            return None
        if not is_resource_exhausted(ctx.meta.get("error")):
            return None
        if ctx.kind == "server_stream" and ctx.chunks > 0:
            return None         # chunks observed: re-issue would dupe
        stub, shard = route
        tried = ctx.meta.setdefault("shards_tried", set())
        tried.add(shard)
        if len(tried) >= len(stub.servers):
            ctx.meta["shards_tried"] = set()    # a later cycle may pass
            return None
        nxt = (shard + 1) % len(stub.servers)
        while nxt in tried:
            nxt = (nxt + 1) % len(stub.servers)
        ctx.meta["shard_route"] = (stub, nxt)
        ctx.channel = stub.shard_channel(nxt)
        # keep the stub's outstanding-call books consistent with the
        # re-route: the call now loads the NEW shard, not the rejected
        # one — least_loaded dispatch reads these counts
        stub._move_inflight(ctx.call_id, shard, nxt)
        self.failovers += 1
        return "retry"


class ShardedServeStub:
    """PS-style sharded dispatch client: one client endpoint fanning
    generation requests across several server endpoints of one fabric.

    ``round_robin`` cycles the servers; ``least_loaded`` picks the
    server with the fewest outstanding (submitted, not yet completed)
    calls from this client, ties broken by server order. Outstanding
    counts are tracked per handle, so interleaved ``generate`` /
    ``generate_stream`` submissions from several stubs before one
    ``fabric.flush()`` shard the way a real PS front-end would.

    With ``failover=True`` (the default) a shared
    :class:`ShardFailoverInterceptor` is installed on the fabric: a
    dispatch rejected by a shard's admission control fails over to the
    next shard transparently during ``flush``."""

    def __init__(self, fabric, client, servers, *,
                 policy: str = "round_robin", serialized: bool = True,
                 failover: bool = True):
        if policy not in DISPATCH_POLICIES:
            raise ValueError(f"unknown dispatch policy {policy!r}; "
                             f"choose from {DISPATCH_POLICIES}")
        assert servers, "sharded dispatch needs >= 1 server endpoint"
        self.fabric = fabric
        self.client = client
        self.servers = list(servers)
        self.policy = policy
        self._stubs = [serve_stub(fabric.channel(client, s,
                                                 serialized=serialized))
                       for s in self.servers]
        self._rr = 0
        self._inflight: List[list] = [[] for _ in self.servers]
        self._failover = None
        if failover:
            self._failover = next(
                (ic for ic in fabric.client_interceptors
                 if isinstance(ic, ShardFailoverInterceptor)), None)
            if self._failover is None:
                self._failover = ShardFailoverInterceptor()
                fabric.client_interceptors.append(self._failover)

    def shard_channel(self, shard: int):
        """The underlying channel of one shard's stub (failover reroutes
        a call's context onto it)."""
        return self._stubs[shard].channel

    def outstanding(self, shard: int) -> int:
        """Submitted-but-incomplete calls this client has on one
        server (completed handles are pruned lazily)."""
        self._inflight[shard] = [h for h in self._inflight[shard]
                                 if not h.done]
        return len(self._inflight[shard])

    def _move_inflight(self, call_id: int, old: int, new: int) -> None:
        """Re-book a call failover moved between shards, so
        ``outstanding`` charges it to the shard actually serving it."""
        for h in self._inflight[old]:
            if h.call_id == call_id:
                self._inflight[old].remove(h)
                self._inflight[new].append(h)
                return

    def _shard_queue_depth(self, shard: int) -> int:
        metrics = next((si for si in self.fabric.server_interceptors
                        if isinstance(si, MetricsInterceptor)), None)
        if metrics is None:
            return 0
        ep = self.fabric.resolve_endpoint(self.servers[shard])
        gauge = metrics.gauges().get(f"serve:scheduler@{ep}")
        if gauge is not None:
            # the endpoint scheduler's live load report: requests
            # decoding + requests queued behind the batch/KV budget
            return gauge["running"] + gauge["waiting"]
        return metrics.server_queue_depth(ep)

    def _pick(self) -> int:
        if self.policy == "round_robin":
            shard = self._rr % len(self._stubs)
            self._rr += 1
            return shard
        if self.policy == "scheduler_least_loaded":
            # server-reported load first (the endpoint scheduler's
            # running + waiting gauge), own outstanding calls as the
            # tiebreak — so dispatch steers around shards other
            # clients have loaded up, not just ours
            return min(range(len(self._stubs)),
                       key=lambda i: (self._shard_queue_depth(i),
                                      self.outstanding(i), i))
        return min(range(len(self._stubs)),
                   key=lambda i: (self.outstanding(i), i))

    def _dispatch(self, method: str, prompts: np.ndarray,
                  max_new_tokens: int, **kw):
        shard = self._pick()
        handle = getattr(self._stubs[shard], method)(
            (prompts, max_new_tokens), **kw)
        self._inflight[shard].append(handle)
        if self._failover is not None:
            ctx = self.fabric.context(handle.call_id)
            if ctx is not None:
                ctx.meta["shard_route"] = (self, shard)
        return handle

    def generate(self, prompts: np.ndarray, max_new_tokens: int = 0,
                 **kw):
        """Unary generate on the picked shard -> ``UnaryCall`` (its
        ``result()`` is the decoded (B, new) token block)."""
        return self._dispatch("generate", prompts, max_new_tokens, **kw)

    def generate_stream(self, prompts: np.ndarray,
                        max_new_tokens: int = 0, **kw):
        """Streaming generate on the picked shard -> ``ServerStream``
        (one (B,) token chunk per decode step)."""
        return self._dispatch("generate_stream", prompts,
                              max_new_tokens, **kw)


def rpc_generate_stream(channel, prompts: np.ndarray,
                        max_new_tokens: int = 0) -> np.ndarray:
    """Client for the streaming method: drives the ``ServerStream``
    handle to completion and reassembles the per-step token chunks into
    the same (B, new) block ``generate`` returns."""
    handle = serve_stub(channel).generate_stream(
        (prompts, max_new_tokens))
    chunks = handle.result()
    return np.stack([decode_token_chunk(c) for c in chunks], axis=1)
