#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA GPU (written for an H100, ``sm_90a``). Run from the repository
root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. environment and build: the card's name and power limit, then every
   kernel of ``src/repro_torch/csrc`` compiled, one nvcc each, started
   together;
2. flash attention vs plain: the kernel against ``attention_plain`` on
   the reference's kernel-test cases (fp32 at 2e-5, bf16 at 2e-2) and on
   the Qwen3-8B prefill shape, then kernel / plain / SDPA times there;
3. payload pack / unpack vs plain, byte for byte (tolerance 0): the
   reference's kernel-test sizes, unaligned serialization sizes, 8
   endpoint rows of the default payload and of the Qwen3-8B payload,
   and framing's ``backend="kernel"`` against ``backend="numpy"``; then
   kernel / plain / library (``torch.cat``, ``split``) times at both row
   shapes;
4. serve Qwen3-8B at full width (36 layers, random weights from seed 0)
   through the port's serve entry point, ``--batch 4 --prompt-len 512
   --new-tokens 32 --requests 3``: over the loopback streaming RPC, with
   ``--unary`` and with ``--no-rpc``. Greedy tokens must agree across the
   three, and the kernel must have launched 36 times per prefill;
5. end to end, kernel vs plain: last-position logits of the same
   prompts with the flash kernel on and off (bf16, Qwen3-8B), two
   controls (the kernel with a window that drops keys, and with the
   causal mask off) that the bound must catch, and a reduced model in
   fp32;
6. the TF-gRPC-Bench suite through ``repro_torch.launch.bench_comm``:
   p2p_latency, p2p_bandwidth and ps_throughput in both modes with the
   default payload and with ``--arch qwen3-8b``, and fully_connected on
   the collective transport. Serialized runs must launch the pack
   kernel (and unpack, where the family unpacks), non-serialized runs
   neither;
7. the channels on the card against the same channels on CPU rows,
   byte for byte (the CPU tests hold those equal to the JAX package),
   and ``--check-baseline benchmarks/BENCH_fabric.json``;
8. a JSON line of kernel numbers, then the result line.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ARCH = "qwen3-8b"
BATCH, PROMPT_LEN, NEW_TOKENS, REQUESTS = 4, 512, 32, 3
SERVE_ARGS = ["--arch", ARCH, "--batch", str(BATCH), "--prompt-len",
              str(PROMPT_LEN), "--new-tokens", str(NEW_TOKENS),
              "--requests", str(REQUESTS)]
# the cases of tests/test_kernels.py: B, S, H, KV, dh, causal, window, cap
FA_CASES = [
    (2, 128, 4, 2, 64, True, None, None),
    (1, 256, 4, 4, 64, True, 64, None),
    (2, 128, 8, 2, 32, True, None, 50.0),
    (1, 192, 4, 1, 128, True, None, None),
    (2, 64, 4, 2, 64, False, None, None),
    (1, 320, 6, 2, 64, True, 128, 30.0),
]
TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# H100 SXM data sheet: HBM3 bytes/s and dense tensor-core bf16 FLOP/s
HBM_BPS, BF16_FLOPS = 3.35e12, 989e12
# End-to-end logits, kernel vs plain, bf16, as max|diff| / max|plain|.
# Both paths compute the same function and round differently: the plain
# path softmaxes in fp32 and rounds the normalized probabilities to bf16
# before P @ V; the kernel rounds the unnormalized exp(s - m_running) to
# bf16, rescales its accumulator when the running max moves, divides by
# the fp32 sum at the end, and sums both products in another order. Each
# layer's attention output thus differs by a few bf16 units in the last
# place, and 36 residual layers carry that into the logits. The limit
# lies between what sound runs read and what the controls below read;
# the script fails if a control does not exceed it.
E2E_REL_TOL = 5e-2
# Controls: the kernel on the same prompts with one thing wrong, through
# the model's own attention options. "window" drops the first KV tile
# (64 keys) of the last position, and fewer keys of the 63 positions
# before it; "causal off" lets every position see the whole prompt.
E2E_CONTROLS = {"window S - 64": {"sliding_window": PROMPT_LEN - 64},
                "causal off": {"causal": False}}
# The reduced model in fp32: the kernel and the plain path are both fp32
# throughout, so they differ only in summation order.
E2E_FP32_TOL = 1e-4
KERNEL_SOURCES = ("flash_attention", "payload_pack")
# payload pack / unpack: the reference's kernel-test sizes (aligned, and
# lists drawn as its hypothesis property draws them), the unaligned
# sizes serialization hands the kernels, and the endpoint rows of the
# suite (the CLI's 8)
PP_ALIGNED = (128, 512, 1024, 128)
PP_UNALIGNED = (10, 1, 300, 4097, 77)
ROWS = 8
SUITE = [("p2p_latency", []), ("p2p_bandwidth", []),
         ("ps_throughput", ["--num-ps", "2", "--num-workers", "3"])]
SUITE_TIMES = ["--warmup", "0.2", "--duration", "1"]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def valid_pairs(sq: int, skv: int, causal: bool, window) -> int:
    q = torch.arange(sq)[:, None]
    k = torch.arange(skv)[None, :]
    ok = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        ok &= q >= k
    if window is not None:
        ok &= (q - k) < window
    return int(ok.sum())


def attention_bound(q, k, v, causal, window):
    """(ms, what bounds it): each input read once and the output written
    once over HBM bandwidth, against the two products' FLOPs over the
    bf16 tensor-core peak (for this run's mask)."""
    B, Sq, H, dh = q.shape
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * B * H * dh * valid_pairs(Sq, k.shape[1], causal, window)
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def gpu_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call of ``fn`` with L2 cold: each call
    sits between its own pair of events, after a 128 MiB write that
    evicts the 50 MB L2, and a sleep kernel first keeps the card busy
    until the host has queued every call, so host overhead between
    calls is not counted."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(100_000_000)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def phase_build(name: str) -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(_build.build, KERNEL_SOURCES))
    print(f"[build] {', '.join(KERNEL_SOURCES)} -> sm_90a in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          + ", ".join(f"{k} {_build.build_seconds[k]:.2f} s"
                      for k in KERNEL_SOURCES) + ")")
    for src in KERNEL_SOURCES:
        for line in _build.build_log.get(src, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src}: {line.strip()}")


def phase_kernel(name: str) -> dict:
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(B, S, H, KV, dh, dtype):
        return [torch.randn(shape, device="cuda", generator=gen).to(dtype)
                for shape in ((B, S, H, dh), (B, S, KV, dh),
                              (B, S, KV, dh))]

    def strided(B, S, H, KV, dh, dtype):
        # head slices of one fused (B, S, H + 2 KV, dh) projection
        qkv = torch.randn((B, S, H + 2 * KV, dh), device="cuda",
                          generator=gen).to(dtype)
        return [qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]]

    def compare(case, dtype, make=inputs):
        B, S, H, KV, dh, causal, window, cap = case
        q, k, v = make(B, S, H, KV, dh, dtype)
        out = flash_attention(q, k, v, causal, window, cap)
        torch.cuda.synchronize()
        ref = attention_plain(q, k, v, causal, window, cap)
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOLS[dtype]
        ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
        print(f"[kernel] {str(dtype)[6:]:8s} B={B} S={S} H={H} KV={KV} "
              f"dh={dh} causal={causal} window={window} softcap={cap}"
              f"{' strided' if make is strided else ''}: "
              f"max_abs_err={err:.3g} tol={tol} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with "
                                 f"attention_plain on {case} {dtype}")
        return err, (q, k, v)

    for dtype in (torch.float32, torch.bfloat16):
        for case in FA_CASES:
            compare(case, dtype)
    main_case = (BATCH, PROMPT_LEN, 32, 8, 128, True, None, None)
    compare(main_case, torch.bfloat16, make=strided)
    err, (q, k, v) = compare(main_case, torch.bfloat16)

    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = cuda_ms(lambda: flash_attention(q, k, v, True))
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, True))
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    bound_ms, bound_by = attention_bound(q, k, v, True, None)
    print(f"[kernel] Qwen3-8B prefill q{tuple(q.shape)} bf16 causal on "
          f"{name}: kernel {ms:.4f} ms, attention_plain {plain_ms:.4f} ms, "
          f"SDPA {sdpa_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces":
                "src/repro/kernels/flash_attention/flash_attention.py:77",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sdpa_ms}


def _frames():
    """The frames of tests/test_torch_package.py, zero-size buffers
    included."""
    import numpy as np

    from repro_torch.rpc import framing as fr
    rng = np.random.default_rng(0)
    bufs = [rng.integers(0, 256, n, dtype=np.uint8)
            for n in (0, 1, 127, 128, 129, 1000, 0)]
    return [fr.make_frame(7, "Serve/generate", bufs, serialized=True),
            fr.make_frame(8, "Serve/generate", bufs, serialized=False),
            fr.make_frame(9, "Serve/generate", [], serialized=True),
            fr.stream_chunk(10, "Serve/generate_stream", bufs[:3], seq=3,
                            end=True, serialized=True),
            fr.make_frame(11, "x", bufs[1:4], serialized=True, reply=True,
                          budget_us=1234),
            fr.make_frame(12, "x", bufs[2:6], serialized=True)]


def suite_payloads():
    """(label, endpoint rows) of the suite's two payloads on the card."""
    from repro_torch.configs import get_config
    from repro_torch.configs.tfgrpc_bench import BenchConfig
    from repro_torch.core import channels as ch
    from repro_torch.core.payload import from_arch, generate_spec
    mesh = ch.make_net_mesh(ROWS, device="cuda")
    return [("default", ch.device_payload(mesh, generate_spec(BenchConfig()))),
            ("qwen3-8b", ch.device_payload(mesh, from_arch(
                get_config(ARCH))))]


def phase_pack(name: str) -> list:
    """K1 / K2 against their plain versions (bytes equal), then their
    times at the suite's two row shapes; returns their kernel entries."""
    import numpy as np

    from repro_torch.core import serialization
    from repro_torch.kernels.payload_pack import (pack, pack_plain, unpack,
                                                  unpack_plain)
    from repro_torch.rpc import framing as fr
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rows(sizes, r):
        return [torch.randint(0, 256, (r, s), generator=gen, device="cuda",
                              dtype=torch.uint8) for s in sizes]

    def diff(a, b):
        return (a.int() - b.int()).abs().max().item() if a.numel() else 0

    def check(label, bufs, pad):
        sizes = [b.shape[-1] for b in bufs]
        padded = [s + (-s) % 128 for s in sizes] if pad else sizes
        packed, _ = pack(bufs, pad=pad)
        outs = unpack(packed, sizes, pad=pad)
        torch.cuda.synchronize()
        e1 = diff(packed, pack_plain(bufs, padded))
        e2 = max(max(diff(a, b), diff(a, c)) for a, b, c in zip(
            outs, unpack_plain(packed, sizes, padded), bufs))
        print(f"[pack] {label}: {len(bufs)} buffers x {bufs[0].shape[0]} "
              f"rows, {packed.shape[-1]} B/row, pad={pad}: pack "
              f"max_abs_err {e1}, unpack max_abs_err {e2} (tolerance 0) "
              f"{'ok' if e1 == e2 == 0 else 'FAIL'}")
        if e1 or e2:
            raise AssertionError(f"payload_pack disagrees with plain on "
                                 f"{label}")
        return max(e1, e2)

    err = check("reference aligned sizes", rows(PP_ALIGNED, 1), True)
    rng = np.random.default_rng(0)
    for i in range(8):         # tests/test_kernels.py's property sizes
        sizes = rng.integers(1, 4097, rng.integers(1, 9)).tolist()
        err = max(err, check(f"reference property sizes {i}",
                             rows(sizes, 1), True))
    bufs = rows(PP_UNALIGNED, 4)
    err = max(err, check("unaligned serialization sizes", bufs, False))
    packed, meta = serialization.pack(bufs)
    if not (torch.equal(packed, torch.cat(bufs, -1)) and all(
            torch.equal(a, b)
            for a, b in zip(serialization.unpack(packed, meta), bufs))):
        raise AssertionError("serialization on the card is not the "
                             "concatenation")
    payloads = suite_payloads()
    for label, bufs in payloads:
        err = max(err, check(f"{label} payload", bufs, False))
        err = max(err, check(f"{label} payload", bufs, True))
    for frame in _frames():
        kw, nw = (fr.encode(frame, backend=b) for b in ("kernel", "numpy"))
        for wire in (kw, nw):
            back = fr.decode(wire, backend="kernel")
            if not (len(kw) == len(nw) and all(
                    np.array_equal(a, b) for a, b in zip(kw, nw))
                    and all(np.array_equal(a, b)
                            for a, b in zip(back.bufs, frame.bufs))):
                raise AssertionError(f"framing backend='kernel' differs "
                                     f"from numpy on frame {frame.call_id}")
    print(f"[pack] framing backend='kernel' wire bytes equal "
          f"backend='numpy' both ways on {len(_frames())} frames")

    entries = {}
    for label, bufs in payloads:
        sizes = [b.shape[-1] for b in bufs]
        packed, _ = pack(bufs, pad=False)
        nbytes = 2 * packed.numel()            # read once, written once
        bound = nbytes / HBM_BPS * 1e3
        t = {"payload_pack": (
            gpu_ms(lambda: pack(bufs, pad=False)),
            gpu_ms(lambda: pack_plain(bufs, sizes)),
            gpu_ms(lambda: torch.cat(bufs, dim=-1))),
            "payload_unpack": (
            gpu_ms(lambda: unpack(packed, sizes, pad=False)),
            gpu_ms(lambda: unpack_plain(packed, sizes, sizes)),
            gpu_ms(lambda: [p.contiguous()
                            for p in torch.split(packed, sizes, -1)]))}
        shape = f"{ROWS} x {packed.shape[-1]} B ({label} payload)"
        for k, (ms, plain_ms, lib_ms) in t.items():
            print(f"[pack] {k} {shape} on {name}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
                  f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB at "
                  f"{HBM_BPS / 1e12} TB/s)")
            entries.setdefault(k, {})[label] = {
                "shape": shape, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": bound}
        del packed
    del payloads
    torch.cuda.empty_cache()
    out = []
    for k, line in (("payload_pack", 60), ("payload_unpack", 93)):
        main = entries[k]["qwen3-8b"]
        out.append({"name": k, "route": "cuda",
                    "source": "src/repro_torch/csrc/payload_pack.cu",
                    "replaces": f"src/repro/kernels/payload_pack/"
                                f"payload_pack.py:{line}",
                    "max_abs_err": err, **main, "bound_by": "bytes",
                    "default_payload": entries[k]["default"]})
    return out


def phase_suite(name: str) -> dict:
    """The main path of K1/K2: the paper's three families and
    fully_connected through the bench CLI, each with the launch counts
    set to 0 just before it and read just after; returns the launches
    summed over the phase."""
    from repro_torch.kernels.payload_pack import ops as pp
    from repro_torch.launch import bench_comm
    runs = [(fam, extra + payload + ["--mode", mode])
            for payload in ([], ["--arch", ARCH])
            for fam, extra in SUITE
            for mode in ("non_serialized", "serialized")]
    runs += [("fully_connected", ["--transport", "collective",
                                  "--num-workers", "4", "--mode", mode])
             for mode in ("non_serialized", "serialized")]
    total = {"payload_pack": 0, "payload_unpack": 0}
    for fam, args in runs:
        pp.pack.launches = pp.unpack.launches = 0
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            rows = bench_comm.main(["--benchmark", fam] + args + SUITE_TIMES)
        k1, k2 = pp.pack.launches, pp.unpack.launches
        total["payload_pack"] += k1
        total["payload_unpack"] += k2
        row = rows[0]
        mode = args[args.index("--mode") + 1]
        serialized = mode == "serialized"
        label = f"{fam} {mode}{' --arch ' + ARCH if '--arch' in args else ''}"
        print(f"[suite] {label}: {row['metric']} = {row['value']:.6g}, "
              f"mean {row['mean_us']:.1f} us over {row['n_iters']} iters, "
              f"pack launches {k1}, unpack launches {k2} on {name}")
        if "device         : " + torch.cuda.get_device_name() not in \
                log.getvalue():
            raise AssertionError(f"{label}: the run did not name the card")
        if not row["value"] > 0:
            raise AssertionError(f"{label}: {row['metric']} = "
                                 f"{row['value']}")
        if not serialized and (k1 or k2):
            raise AssertionError(f"{label}: non-serialized run launched "
                                 f"pack {k1} / unpack {k2} times")
        if serialized:
            want_k2 = 0 if fam == "p2p_bandwidth" else k1
            if k1 < row["n_iters"] or k2 != want_k2:
                raise AssertionError(f"{label}: pack {k1}, unpack {k2} "
                                     f"launches for {row['n_iters']} "
                                     f"timed iterations")
    return total


def phase_chain(name: str) -> None:
    """Channels on the card equal the same channels on CPU rows, byte
    for byte, then the committed modeled baseline checks clean."""
    from repro_torch.core import channels as ch
    from repro_torch.launch import bench_comm
    n, sizes = 4, (10, 300, 1024, 5000)
    gen = torch.Generator().manual_seed(1)
    host = [torch.randint(0, 255, (n, s), generator=gen, dtype=torch.uint8)
            for s in sizes]
    cases = {"echo": ("p2p_echo_fn", (), {}),
             "send": ("p2p_send_fn", (), {}),
             "ps_1x3": ("ps_round_fn", (1, 3), {}),
             "fc_4": ("fully_connected_fn", (4,), {}),
             "ring_4x2": ("ring_fn", (4,), {"n_chunks": 2}),
             "incast_3x2": ("permute_rounds_fn",
                            (ch.incast_schedule(3, n_chunks=2),), {})}
    checked = 0
    for label, (fname, args, kw) in cases.items():
        for ser in (False, True):
            outs = []
            for device in ("cuda", "cpu"):
                mesh = ch.make_net_mesh(n, device=device)
                fn = getattr(ch, fname)(mesh, len(host), *args,
                                        serialized=ser, **kw)
                outs.append([o.cpu() for o in fn(*[h.to(device)
                                                   for h in host])])
            if not all(torch.equal(a, b) for a, b in zip(*outs)):
                raise AssertionError(f"{label} serialized={ser}: card and "
                                     f"CPU rows differ")
            checked += 1
    outs = [[o.cpu() for o in ch.fsdp_pull_push_fn(
        ch.make_net_mesh(n, device=d), len(host))(*[h.to(d) for h in host])]
        for d in ("cuda", "cpu")]
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        raise AssertionError("fsdp_pull_push: card and CPU rows differ")
    print(f"[chain] {checked + 1} channel runs: card rows equal CPU rows "
          f"byte for byte on {name}")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        bench_comm.main(["--check-baseline",
                         str(ROOT / "benchmarks" / "BENCH_fabric.json")])
    print(f"[chain] {log.getvalue().strip()}")


def phase_serve(name: str) -> int:
    """The main path; returns the kernel's launches during it."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve
    modes = (("rpc/stream", []), ("rpc/unary", ["--unary"]),
             ("direct", ["--no-rpc"]))
    outputs, prefills = {}, 0
    flash_attention.launches = 0
    for label, extra in modes:
        torch.cuda.reset_peak_memory_stats()
        res = serve.main(SERVE_ARGS + extra)
        eng = res["engine"]
        ops = eng.op_seconds
        n_pre = len(ops["prefill"])
        prefills += n_pre
        if any(s.stats()["preempted"] for s in eng.schedulers.values()):
            raise AssertionError("a request was preempted: rebuild "
                                 "prefills would not be counted")
        total_s = sum(res["seconds"])
        toks = sum(o.size for o in res["outputs"])
        print(f"[serve] {label}: {1e3 * total_s / REQUESTS:.1f} ms/request, "
              f"prefill {1e3 * sum(ops['prefill']) / n_pre:.1f} ms, "
              f"decode {1e3 * sum(ops['decode']) / len(ops['decode']):.2f} "
              f"ms/token-step, {toks / total_s:.1f} tok/s, "
              f"max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"on {name}")
        outputs[label] = res["outputs"]
        del res, eng, ops
        gc.collect()      # the engine and its schedulers refer to each other
        torch.cuda.empty_cache()
    launches = flash_attention.launches
    for label, outs in outputs.items():
        if len(outs) != REQUESTS:
            raise AssertionError(f"{label}: {len(outs)} replies")
        for out in outs:
            if out.shape != (BATCH, NEW_TOKENS) or out.min() < 0 \
                    or out.max() >= 151936:
                raise AssertionError(f"{label}: bad tokens {out.shape}")
        for a, b in zip(outs, outputs["direct"]):
            if not (a == b).all():
                raise AssertionError(f"{label} tokens differ from direct")
    print(f"[serve] greedy tokens identical across stream / unary / "
          f"direct; request 0 row 0: {outputs['direct'][0][0][:8].tolist()}")
    if launches != 36 * prefills:
        raise AssertionError(f"flash kernel launched {launches} times for "
                             f"{prefills} prefills of 36 layers")
    print(f"[serve] flash kernel launches {launches} = 36 x {prefills} "
          f"prefills")
    return launches


def profile_steps(name: str, acfg, params, tokens, n_decode: int = 8):
    """Device busy share of one prefill and of greedy decode steps at the
    serving shape (torch.profiler's CUDA kernel times over host wall
    time), and the kernels that take most of the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps

    prefill = steps.make_prefill_step(acfg, max_seq=PROMPT_LEN + n_decode)
    decode = steps.make_decode_step(acfg, BATCH)

    def run():
        states, logits = prefill(params, {"tokens": tokens})
        for _ in range(n_decode):
            tok = logits[:, -1].argmax(-1)[:, None]
            states, logits = decode(params, states, tok)
        torch.cuda.synchronize()

    run()                                            # warm-up
    for label, fn in (("prefill", lambda: prefill(params,
                                                  {"tokens": tokens})),
                      (f"prefill + {n_decode} decode steps", run)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side entries only: the kernels themselves, not the aten
        # ops that launched them (whose device time would count twice)
        avgs = [a for a in prof.key_averages()
                if a.device_type == DeviceType.CUDA
                and a.self_device_time_total > 0]
        busy_ms = sum(a.self_device_time_total for a in avgs) / 1e3
        if not avgs:
            print(f"[profile] {label}: wall {wall_ms:.1f} ms; device "
                  f"time not measured (the profiler saw no CUDA kernels)")
            continue
        top = sorted(avgs, key=lambda a: -a.self_device_time_total)[:4]
        print(f"[profile] {label}: wall {wall_ms:.1f} ms, device busy "
              f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %), top: "
              + "; ".join(f"{a.key[:48]} {a.self_device_time_total / 1e3:.2f}"
                          f" ms x{a.count}" for a in top)
              + f" on {name}")


def phase_e2e(name: str) -> None:
    import dataclasses

    import numpy as np

    from repro_torch.launch import serve, steps

    def last_logits(acfg, params, tokens, flash, **attention):
        m = acfg.model
        if attention:
            m = dataclasses.replace(m, attention=dataclasses.replace(
                m.attention, **attention))
        cfg = acfg.replace(model=m, train=dataclasses.replace(
            acfg.train, use_flash_kernel=flash))
        _, logits = steps.make_prefill_step(cfg)(params, {"tokens": tokens})
        return logits[:, -1].float()

    def prefill_both(acfg, params, tokens):
        return (last_logits(acfg, params, tokens, True),
                last_logits(acfg, params, tokens, False))

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    rng = np.random.default_rng(0)       # the CLI's first prompts
    tokens = torch.as_tensor(rng.integers(0, 151936, (BATCH, PROMPT_LEN),
                                          dtype=np.int32), device="cuda")
    acfg, params = serve.init_model(ARCH, reduced=False, device="cuda")
    kern, plain = prefill_both(acfg, params, tokens)
    controls = {label: rel(last_logits(acfg, params, tokens, True, **kw),
                           plain)
                for label, kw in E2E_CONTROLS.items()}
    profile_steps(name, acfg, params, tokens)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if not (torch.isfinite(kern).all() and torch.isfinite(plain).all()):
        raise AssertionError("non-finite logits")
    sound = rel(kern, plain)
    cos = torch.nn.functional.cosine_similarity(kern, plain, dim=-1)
    agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    print(f"[e2e] Qwen3-8B bf16 last-position logits, kernel vs plain: "
          f"max|diff|/max|plain| = {sound:.4g} (bound {E2E_REL_TOL}), "
          f"min cosine {cos.min().item():.6f}, argmax agreement "
          f"{agree:.2f} on {name}")
    for label, r in controls.items():
        print(f"[e2e] control, kernel with {label} vs plain: "
              f"max|diff|/max|plain| = {r:.4g} "
              f"({'caught' if r > E2E_REL_TOL else 'NOT caught'})")
    if sound > E2E_REL_TOL:
        raise AssertionError(f"end-to-end logits differ by {sound:.3g}")
    missed = [label for label, r in controls.items() if r <= E2E_REL_TOL]
    if missed:
        raise AssertionError(f"the end-to-end bound {E2E_REL_TOL} does not "
                             f"catch the controls {missed}")

    acfg, params = serve.init_model(ARCH, reduced=True, device="cuda")
    small = torch.as_tensor(rng.integers(0, acfg.model.vocab_size, (2, 40),
                                         dtype=np.int32), device="cuda")
    kern, plain = prefill_both(acfg, params, small)
    err = (kern - plain).abs().max().item()
    print(f"[e2e] reduced Qwen3-8B fp32, kernel vs plain: max_abs_err "
          f"{err:.3g} (bound {E2E_FP32_TOL})")
    if not torch.allclose(kern, plain, atol=E2E_FP32_TOL,
                          rtol=E2E_FP32_TOL):
        raise AssertionError(f"reduced model logits differ by {err:.3g}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc" / "flash_attention.cu").is_file():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    name = card()
    print(f"[env] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    phase_build(name)
    kernel = phase_kernel(name)
    packs = phase_pack(name)
    kernel["launches"] = phase_serve(name)
    phase_e2e(name)
    launches = phase_suite(name)
    for entry in packs:
        entry["launches"] = launches[entry["name"]]
    phase_chain(name)
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(name)
    print(json.dumps({"kernels": [kernel] + packs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
