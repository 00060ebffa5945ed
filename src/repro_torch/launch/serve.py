"""Serving launcher: init a model on the GPU and answer batched requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      [--batch 4] [--prompt-len 512] [--new-tokens 32]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch jamba-1.5-large-398b --reduced --device cpu

The model runs on ``--device cuda`` (the default; no card is an error,
never a silent CPU run) with the prefill attention of every attention
layer in the hand-written flash kernel (dense, MoE and the Mamba
hybrid) or the prefill WKV scan of every layer in the hand-written
RWKV-6 kernel (``rwkv6-1.6b``), or on ``--device cpu`` with their plain
PyTorch versions. MoE FFNs and Mamba mixers are PyTorch ops on either
device, as the reference computes them outside any Pallas kernel. Weights are random,
drawn on the device from seed 0 and cast to the compute dtype tensor by
tensor.

Requests travel through the rpc fabric (loopback transport, serialized
framing) by default, via the generated ``Serve`` stub's
server-streaming ``generate_stream`` method — one chunk per decoded
token — so serving traffic exercises the same RPC runtime the
communication benchmarks measure, streaming included. ``--unary`` uses
the unary ``generate`` method (whole block in one reply); --no-rpc
calls the engine directly.

``--transport cluster --cluster-spec <json>`` serves over a
multi-endpoint cluster transport instead: the engine's ``Serve``
service binds on every ``ps`` endpoint of the spec, every ``worker``
endpoint submits a generation request per round, and one flush drives
all of them concurrently — sharded across the PS endpoints under
``--policy round_robin|least_loaded`` — with per-link modeled timing
and per-endpoint interceptor metrics:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --reduced \
      --transport cluster --cluster-spec cluster.json --unary

``--trace out.json`` attaches a ``rpc.Tracer`` to the serving fabric
(loopback or cluster) and exports every request's span tree — queue /
credit-stall / wire / server / reply phases, retries and shard
failovers included, plus the scheduler's waiting / prefill / decode /
preempted request phases — as Chrome trace-event JSON for Perfetto.

Each served endpoint runs a continuous-batching scheduler
(``repro_torch.serve.scheduler``): ``--max-batch N`` caps concurrent decodes
per endpoint and ``--kv-blocks N`` sets the modeled KV-cache block
budget (exhaustion preempts + requeues the newest request). With the
cluster transport, ``--policy scheduler_least_loaded`` dispatches on
the endpoints' reported scheduler load instead of the client's own
outstanding-call counts. ``--sched-policy sjf`` admits
shortest-prompt-first instead of FIFO (``--starvation-age-s`` bounds
how long a long prompt can be bypassed); see ``docs/WORKLOAD.md`` for
driving a served cluster with recorded open-loop traces.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig, get_config, get_reduced_config
from repro_torch.models import init_params
from repro_torch.models.model import dtype_of
from repro_torch.serve.engine import (DISPATCH_POLICIES, ServeConfig,
                                ServeEngine)
from repro_torch.serve.scheduler import SCHED_POLICIES


def _export_trace(tracer, path: str) -> None:
    if tracer is None:
        return
    tracer.export_chrome(path)
    print(f"trace          : {len(tracer.spans())} spans -> {path}")


def _serve_cluster_rounds(engine: ServeEngine, cluster, args,
                          vocab_size: int) -> None:
    """One request per worker endpoint per round, all flushed (and so
    served) concurrently; PS sharding per --policy."""
    from repro_torch import rpc as rpclib
    from repro_torch.serve.engine import decode_token_chunk

    # metrics server-side too (shed/rejected counts feed admission
    # when the spec advertises limits), and retry so a dispatch a
    # shard's admission control rejects recovers on a later, drained
    # flight (single-PS specs have no shard to fail over to)
    metrics = rpclib.MetricsInterceptor(per_endpoint=True,
                                        endpoint_name=cluster.name_of)
    tracer = rpclib.Tracer() if args.trace else None
    fabric, stubs = engine.serve_cluster(
        cluster, policy=args.policy,
        client_interceptors=[metrics,
                             rpclib.RetryInterceptor(max_attempts=4)],
        server_interceptors=[metrics], tracer=tracer,
        max_batch=args.max_batch, kv_blocks=args.kv_blocks,
        sched_policy=args.sched_policy,
        starvation_age_s=args.starvation_age_s)
    rng = np.random.default_rng(0)
    print(f"cluster        : {len(stubs)} worker endpoint(s) -> "
          f"{len(next(iter(stubs.values())).servers)} ps endpoint(s), "
          f"policy={args.policy}")
    for i in range(args.requests):
        prompts = {w: rng.integers(0, vocab_size,
                                   (args.batch, args.prompt_len),
                                   dtype=np.int32) for w in stubs}
        t0 = time.perf_counter()
        if args.unary:
            calls = {w: stub.generate(prompts[w])
                     for w, stub in stubs.items()}
        else:
            calls = {w: stub.generate_stream(prompts[w])
                     for w, stub in stubs.items()}
        fabric.flush()            # every worker's request, one loop
        dt = time.perf_counter() - t0
        for w, call in calls.items():
            if args.unary:
                out = call.result()
            else:
                out = np.stack([decode_token_chunk(c)
                                for c in call.result()], axis=1)
            print(f"request {i} [{w}]: batch={args.batch} "
                  f"new={out.shape[1]} sample={out[0][:8].tolist()}")
        total = len(calls) * args.batch * args.new_tokens
        print(f"round {i}: {dt*1e3:.1f} ms wall "
              f"({total/dt:.1f} tok/s aggregate, modeled clock "
              f"{fabric.now()*1e3:.3f} ms)")
    per_ep = {k: v["calls"] for k, v in metrics.snapshot().items()
              if "@" in k and not k.startswith("server:")
              and not k.startswith("serve:")}
    print(f"per-endpoint   : {per_ep}")
    for ep, sched in engine.schedulers.items():
        st = sched.stats()
        print(f"scheduler [{ep}]: "
              f"admitted={st['admitted']} finished={st['finished']} "
              f"preempted={st['preempted']} requeued={st['requeued']} "
              f"peak_running={st['peak_running']}")
    _export_trace(tracer, args.trace)


def init_model(arch: str, *, reduced: bool, device: str):
    """(config, params) as the CLI serves them: on ``cuda`` the flash
    and WKV kernels are on (``use_flash_kernel``, ``use_rwkv_kernel``,
    which the reference config leaves off only because Pallas TPU
    kernels do not lower on a CPU); params are drawn on ``device`` from
    seed 0 in the compute dtype."""
    acfg: ArchConfig = (get_reduced_config(arch) if reduced
                        else get_config(arch))
    assert not acfg.model.is_encoder, "encoder archs do not serve decode"
    acfg = acfg.replace(train=dataclasses.replace(
        acfg.train, use_flash_kernel=(device == "cuda"),
        use_rwkv_kernel=(device == "cuda")))
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(acfg, device=device, generator=gen,
                         dtype=dtype_of(acfg.train.compute_dtype))
    return acfg, params


def main(argv: Optional[List[str]] = None) -> dict:
    """Runs the CLI; returns ``{"outputs": [(B, new) int32 per request],
    "seconds": [wall seconds per request], "engine": ServeEngine}``
    (empty lists with ``--transport cluster``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--no-rpc", action="store_true",
                    help="bypass the rpc fabric, call the engine directly")
    ap.add_argument("--unary", action="store_true",
                    help="use the unary generate method instead of the "
                         "server-streaming generate_stream")
    ap.add_argument("--transport", default="loopback",
                    choices=("loopback", "cluster"),
                    help="rpc transport: loopback (single host) or "
                         "cluster (multi-endpoint, --cluster-spec)")
    ap.add_argument("--cluster-spec", default=None, metavar="JSON|PATH",
                    help="cluster topology: inline ClusterSpec JSON or "
                         "a JSON file path (cluster transport only)")
    ap.add_argument("--policy", default="round_robin",
                    choices=DISPATCH_POLICIES,
                    help="PS shard dispatch policy (cluster transport)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="export the serving fabric's span trees as "
                         "Chrome trace-event JSON (Perfetto)")
    ap.add_argument("--max-batch", type=int, default=None, metavar="N",
                    help="continuous-batching scheduler: max requests "
                         "decoding concurrently per endpoint "
                         "(default 8)")
    ap.add_argument("--kv-blocks", type=int, default=None, metavar="N",
                    help="continuous-batching scheduler: modeled "
                         "KV-cache budget in 16-token blocks per "
                         "endpoint (default unlimited; exhaustion "
                         "preempts + requeues)")
    ap.add_argument("--sched-policy", default="fifo",
                    choices=SCHED_POLICIES,
                    help="scheduler admission order: fifo (arrival "
                         "order) or sjf (shortest-prompt-first, FIFO "
                         "tiebreak; preempted requests and starved "
                         "waits keep priority)")
    ap.add_argument("--starvation-age-s", type=float, default=None,
                    metavar="S",
                    help="sjf only: waits older than this regain "
                         "strict FIFO priority (default: no escape "
                         "hatch)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs (default cuda: the GPU, "
                         "with the flash attention / WKV kernels)")
    args = ap.parse_args(argv)

    if args.transport == "cluster" and args.cluster_spec is None:
        ap.error("--transport cluster needs --cluster-spec")
    if args.cluster_spec is not None and args.transport != "cluster":
        ap.error("--cluster-spec needs --transport cluster")
    if args.transport == "cluster" and args.no_rpc:
        ap.error("--no-rpc bypasses the fabric; it cannot combine with "
                 "--transport cluster")
    if args.trace and args.no_rpc:
        ap.error("--trace records fabric spans; it cannot combine with "
                 "--no-rpc")
    if args.no_rpc and (args.max_batch is not None
                        or args.kv_blocks is not None
                        or args.sched_policy != "fifo"
                        or args.starvation_age_s is not None):
        ap.error("--max-batch/--kv-blocks/--sched-policy/"
                 "--starvation-age-s configure the rpc endpoint "
                 "scheduler; they cannot combine with --no-rpc")
    if args.starvation_age_s is not None and args.sched_policy != "sjf":
        ap.error("--starvation-age-s is the sjf starvation escape "
                 "hatch; it needs --sched-policy sjf")
    if args.starvation_age_s is not None and args.starvation_age_s < 0:
        ap.error("--starvation-age-s must be >= 0")
    if args.max_batch is not None and args.max_batch < 1:
        ap.error("--max-batch must be >= 1")
    if args.kv_blocks is not None and args.kv_blocks < 1:
        ap.error("--kv-blocks must be >= 1")
    if args.max_batch is None:
        args.max_batch = 8
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA GPU is visible "
                 "(torch.cuda.is_available() is False); pass --device cpu "
                 "to run the model on the CPU")

    cluster = None
    if args.transport == "cluster":
        # validate the topology BEFORE the (slow) model init
        from repro_torch.rpc.cluster import load_cluster_spec
        try:
            cluster = load_cluster_spec(args.cluster_spec)
        except (OSError, ValueError, KeyError, TypeError) as e:
            ap.error(f"--cluster-spec: {e}")

    acfg, params = init_model(args.arch, reduced=args.reduced,
                              device=args.device)
    engine = ServeEngine(acfg, params, ServeConfig(
        max_seq=args.prompt_len + args.new_tokens + 8,
        max_new_tokens=args.new_tokens, temperature=args.temperature))
    del params
    result = {"outputs": [], "seconds": [], "engine": engine}

    if cluster is not None:
        _serve_cluster_rounds(engine, cluster, args,
                              acfg.model.vocab_size)
        return result

    channel = None
    tracer = None
    if not args.no_rpc:
        from repro_torch import rpc as rpclib
        tracer = rpclib.Tracer() if args.trace else None
        _, channel = engine.serve_loopback(
            tracer=tracer, max_batch=args.max_batch,
            kv_blocks=args.kv_blocks, sched_policy=args.sched_policy,
            starvation_age_s=args.starvation_age_s)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompts = rng.integers(0, acfg.model.vocab_size,
                               (args.batch, args.prompt_len),
                               dtype=np.int32)
        t0 = time.perf_counter()
        if channel is None:
            out = engine.generate(prompts)
            via = "direct"
        elif args.unary:
            from repro_torch.serve.engine import serve_stub
            out = serve_stub(channel).generate((prompts, 0)).result()
            via = "rpc/unary"
        else:
            from repro_torch.serve.engine import rpc_generate_stream
            out = rpc_generate_stream(channel, prompts)
            via = f"rpc/stream({out.shape[1]} chunks)"
        dt = time.perf_counter() - t0
        tps = out.size / dt
        result["outputs"].append(out)
        result["seconds"].append(dt)
        print(f"request {i} [{via}]: batch={args.batch} "
              f"new={out.shape[1]} {dt*1e3:.1f} ms ({tps:.1f} tok/s) "
              f"sample={out[0][:8].tolist()}")
    for ep, sched in engine.schedulers.items():
        st = sched.stats()
        print(f"scheduler [{ep}]: admitted={st['admitted']} "
              f"finished={st['finished']} preempted={st['preempted']} "
              f"requeued={st['requeued']} "
              f"peak_running={st['peak_running']}")
    if args.trace:
        _export_trace(tracer, args.trace)
    return result


if __name__ == "__main__":
    main()
