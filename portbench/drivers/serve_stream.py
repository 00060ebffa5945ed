"""Streamed serving: requests stream their tokens back through the
``Serve`` service's ``generate_stream`` over the loopback fabric
(``ServeEngine.serve_loopback``: serialized framing, the endpoint's
continuous-batching scheduler), greedy.

Two arrival processes, as the mix's ``arrivals`` says:

* ``closed``: ``clients`` clients, each sending its next request the
  moment its last one finishes, from the window's open to its close.
  The load follows what the server sustains, so ``served_tok_s`` is the
  server's capacity on the mix and a faster program lifts it.
* ``poisson``: open loop at the cell's ``rate_rps``, requests sent when
  due whether or not earlier ones have finished (``sweep.py`` finds the
  knee with it).

The window opens when the first request is sent and lasts
``--seconds``. ``served_tok_s`` counts every token (one streamed chunk)
the clients received inside the window, over its length. Time to first
token runs from when a request was due (closed loop: sent) to when the
client received its first chunk; the gaps between tokens are those
between consecutive chunks at the client. After the close the run
drains the requests sent up to the mix's ``drain_cap_s``; a request
that fails or is unfinished at the cap counts in ``failed`` and sorts
as +inf in both tails.

``correct``: a sample of the finished requests drawn from the seed,
the longest among them, is run through the plain reference
(``reference/<family>.py``) over prompt and served tokens; the gaps by
which the served tokens' reference logits lie below the reference's
best must stay under the cell's limits."""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np

from portbench import traffic, weights
from portbench.devtrace import DeviceTrace
from portbench.harness import Check, Outcome, load_module


def nearest_rank(values: List[float], q: float) -> float:
    """The ``q`` quantile by nearest rank (inf sorts last)."""
    if not values:
        return math.inf
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def _client_clock():
    from repro_torch.rpc.interceptors import ClientInterceptor

    class ChunkClock(ClientInterceptor):
        """Host-clock time of every chunk the client receives."""

        def __init__(self):
            self.chunks: Dict[int, List[float]] = {}

        def on_event(self, ctx, event):
            if event.kind == "stream_chunk":
                self.chunks.setdefault(ctx.call_id, []).append(
                    time.perf_counter())
    return ChunkClock()


class Served:
    """The system under test, set up once: the engine with the cell's
    weights, its loopback fabric and ``Serve`` stub, the client's chunk
    clock, and a record of every prefill (prompt length, host start,
    end)."""

    def __init__(self, h, *, tracer=None):
        from repro_torch.serve.engine import (ServeConfig, ServeEngine,
                                              serve_stub)
        cfg, mix = h.config, h.mix
        self.h = h
        self.vocab = cfg["vocab_size"]
        p_hi, a_hi = mix["prompt_tokens"]["hi"], mix["answer_tokens"]["hi"]
        params = weights.draw_params(cfg, h.seed, h.device)
        self.engine = ServeEngine(h.arch_config(), params, ServeConfig(
            max_seq=p_hi + a_hi, max_new_tokens=a_hi, temperature=0.0))
        del params
        self.tracer = tracer
        self.fabric, channel = self.engine.serve_loopback(
            tracer=tracer, max_batch=mix["max_batch"],
            kv_blocks=mix.get("kv_blocks"),
            sched_policy=mix["sched_policy"])
        self.stub = serve_stub(channel)
        self.clock = _client_clock()
        self.fabric.client_interceptors.append(self.clock)
        self.prefills: List[tuple] = []
        prefill_op = self.engine.scheduler_prefill

        def timed_prefill(req):
            t0 = time.perf_counter()
            tok = prefill_op(req)
            self.prefills.append((req.prompt_len, t0, time.perf_counter()))
            return tok
        self.engine.scheduler_prefill = timed_prefill

    def warm_up(self, lens=None) -> None:
        """Concurrent requests of two tokens each at the prompt lengths
        ``lens`` (by default a full batch from the shortest prompt to the
        longest): every kernel is built and loaded, every prefill shape
        run, and the allocator holds a full batch's caches before the
        window."""
        import torch
        mix = self.h.mix
        if lens is None:
            lens = np.linspace(mix["prompt_tokens"]["lo"],
                               mix["prompt_tokens"]["hi"],
                               mix["max_batch"]).astype(int)
        rng = traffic.seed_rng(self.h.seed, 2)
        warm = [self.stub.generate_stream(
            (rng.integers(0, self.vocab, (1, int(s)), dtype=np.int32), 2))
            for s in lens]
        self.fabric.flush()
        if any(w.error or len(w.chunks) != 2 for w in warm):
            raise RuntimeError("warm-up requests failed")
        if self.h.device == "cuda":
            torch.cuda.synchronize()
        self.reset()

    def reset(self) -> None:
        for k in self.engine.op_seconds:
            self.engine.op_seconds[k].clear()
        self.prefills.clear()
        self.clock.chunks.clear()
        if self.tracer is not None:
            self.tracer.clear()

    def window(self, reqs, prompts, seconds: float, trace=None,
               drain_s: float = 0.0, clients: Optional[int] = None
               ) -> Dict:
        """Offers ``reqs`` from now for ``seconds`` (open loop on their
        due times; with ``clients``, closed loop: that many in flight,
        the next sent as one finishes, none after the close), drains
        those sent up to ``drain_s`` past the close, and returns what
        was measured."""
        mix = self.h.mix
        t0 = time.perf_counter()
        due = [t0 + r.due_s for r in reqs]
        close = t0 + seconds
        cap = close + drain_s
        tr_on = t0 + 0.3 * seconds
        tr_len = min(mix["trace_s"], 0.4 * seconds)
        tr_off = tr_on + tr_len
        handles, submit = {}, {}
        i, n, n_pre = 0, len(reqs), 0
        tr_prefills: List[int] = []
        while True:
            now = time.perf_counter()
            if trace is not None:
                if not trace.active and trace.bounds is None \
                        and now >= tr_on:
                    n_pre = len(self.prefills)
                    tr_off = trace.start() + tr_len
                elif trace.active and now >= tr_off:
                    trace.stop()
                    tr_prefills = [s for s, _, _ in self.prefills[n_pre:]]
            in_flight = sum(not hd.done for hd in handles.values())
            while i < n and (due[i] <= now if clients is None else
                             now < close and in_flight < clients):
                if clients is not None:
                    due[i] = now
                handles[i] = self.stub.generate_stream(
                    (prompts[i], reqs[i].answer_len))
                submit[i] = time.perf_counter()
                i += 1
                in_flight += 1
            if (in_flight == 0 and (i >= n or clients is not None
                                    and now >= close)) or now >= cap:
                break
            if clients is not None:     # about one scheduler step, then refill
                nxt = time.perf_counter() + 1e-3
            else:
                nxt = due[i] if i < n else cap
            if trace is not None and trace.bounds is None:
                nxt = min(nxt, tr_off if trace.active else tr_on)
            if in_flight:
                self.fabric.flush(until_s=nxt)
            else:
                time.sleep(max(0.0, nxt - time.perf_counter()))
        if trace is not None and trace.active:
            trace.stop()
            tr_prefills = [s for s, _, _ in self.prefills[n_pre:]]
        end = time.perf_counter()
        from repro_torch.serve.engine import decode_token_chunk
        ttft, gaps, tokens, bad, in_window = [], [], {}, 0, 0
        for k in sorted(handles):
            r, hd = reqs[k], handles[k]
            times = self.clock.chunks.get(hd.call_id, [])
            in_window += sum(t <= close for t in times)
            if not hd.done or hd.error is not None \
                    or len(hd.chunks) != r.answer_len:
                bad += 1
                ttft.append(math.inf)
                gaps.append(math.inf)
                continue
            tokens[k] = np.array([int(decode_token_chunk(c)[0])
                                  for c in hd.chunks])
            ttft.append(times[0] - due[k])
            gaps.extend(b - a for a, b in zip(times, times[1:]))
        late = [submit[k] - due[k] for k in submit]
        return {"t0": t0, "close": close, "end": end, "ttft": ttft,
                "gaps": gaps, "tokens": tokens, "bad": bad,
                "sent": len(handles), "late": late,
                "tr_prefills": tr_prefills,
                "served_tok_s": in_window / seconds}


def run(h) -> Outcome:
    from repro_torch import rpc
    cfg, mix, dev = h.config, h.mix, h.device
    srv = Served(h, tracer=rpc.Tracer() if h.trace else None)
    arrivals = mix["arrivals"]
    closed = arrivals["process"] == "closed"
    if closed:
        reqs = traffic.closed_requests(mix)
        offered = f"closed loop, {arrivals['clients']} clients"
        srv.warm_up(sorted({r.prompt_len for r in reqs}))
    else:
        rate = h.params["rate_rps"]
        reqs = traffic.serve_requests(mix, rate, h.seconds, h.seed)
        offered = f"open loop at {rate} /s"
        srv.warm_up()
    prompts = [traffic.prompt_tokens(h.seed, r, srv.vocab) for r in reqs]
    trace = DeviceTrace() if (h.trace and dev == "cuda") else None
    if trace is not None:
        trace.prime()
    setup_s = time.perf_counter() - h.t_start
    w = srv.window(reqs, prompts, h.seconds, trace, mix["drain_cap_s"],
                   clients=arrivals["clients"] if closed else None)
    n, bad, tokens = w["sent"], w["bad"], w["tokens"]
    if closed and n == len(reqs):
        raise RuntimeError(f"the mix's {n} requests ran out inside the "
                           f"window: give it more cycles")
    ops = srv.engine.op_seconds
    notes = [
        f"{n} requests sent in {h.seconds} s, {offered}; {len(tokens)} "
        f"completed, {bad} failed "
        f"({w['end'] - w['close']:+.3f} s after the close); "
        f"{w['served_tok_s'] * h.seconds:.0f} tokens served in the window",
        f"generator lateness: median {1e3 * float(np.median(w['late'])):.3f}"
        f" ms, max {1e3 * max(w['late']):.3f} ms" if w["late"]
        else "no requests",
        f"scheduler: {next(iter(srv.engine.schedulers.values())).stats()}",
        f"prefill ops {len(ops['prefill'])}, decode ops "
        f"{len(ops['decode'])}, setup {setup_s:.3f} s",
    ]
    tails = {"ttft_p90_ms": 1e3 * nearest_rank(w["ttft"], 0.90),
             "tpot_p95_ms": 1e3 * nearest_rank(w["gaps"], 0.95)}
    notes.append(f"tails: {tails}")
    metrics = dict(tails, served_tok_s=w["served_tok_s"], setup_s=setup_s)
    records = {"config": cfg, "trace": trace, "tails": tails,
               "op_seconds": {k: list(v) for k, v in ops.items()},
               "prefill_lens": [s for s, _, _ in srv.prefills],
               "trace_prefill_lens": w["tr_prefills"],
               "spans": srv.tracer.spans() if srv.tracer else [],
               "chunks": sum(len(t) for t in srv.clock.chunks.values())}
    state = {"srv": srv}

    def release():
        state.clear()

    ref = load_module(h.dir / "reference" / f"{cfg['family']}.py",
                      f"portbench_ref_{cfg['family']}")
    pick = sample_requests(h.seed, reqs, tokens, mix["check_tokens"])
    seqs = [(prompts[k][0], tokens[k]) for k in pick]
    served = [tk for _, tk in seqs]
    limits = h.params["limits"]

    def compared(g: List[float]) -> List[Check]:
        """The gap numbers the cell holds, each where the cell file gives
        it a limit: ``max_logit_gap`` (the widest), ``mean_logit_gap``
        (over every served token of the sample) and ``p90_logit_gap``
        (its 90th percentile, nearest rank: steady where a few tokens
        carry the widest gaps, as a router's near tie that flips
        between precisions does)."""
        got = {"max_logit_gap": max(g, default=0.0),
               "mean_logit_gap": float(np.mean(g)) if g else 0.0,
               "p90_logit_gap": nearest_rank(g, 0.90) if g else 0.0}
        return [Check(k, got[k], v) for k, v in limits.items()]

    def verify() -> List[Check]:
        t = time.perf_counter()
        g = gaps_of(ref.served_logits(cfg, h.seed, seqs, dev), served)
        notes.append(f"reference: {len(pick)} requests, {len(g)} served "
                     f"tokens, {time.perf_counter() - t:.3f} s; "
                     + gap_summary(g))
        return [Check("bad_replies", float(bad), 0.0)] + compared(g)

    def control(variant: str = "fp8") -> List[Check]:
        """At each served position of the same sample, the gap of the
        token the float8 reference (``common.mm``'s ``variant``) puts
        first."""
        exact = ref.served_logits(cfg, h.seed, seqs, dev)
        low = ref.served_logits(cfg, h.seed, seqs, dev, control=variant)
        g = gaps_of(exact, [lg.argmax(-1) for lg in low])
        notes.append("control: " + gap_summary(g))
        return compared(g)

    return Outcome(attempted=n, failed=bad, metrics=metrics,
                   records=records, notes=notes, release=release,
                   verify=verify, control=control)


def sample_requests(seed: int, reqs, tokens: Dict, target: int) -> List[int]:
    """Finished requests to compare, drawn from the seed: the one with the
    longest prompt plus answer first, then others at random until
    ``target`` served tokens are in."""
    done = sorted(tokens)
    if not done:
        return []
    longest = max(done, key=lambda k: reqs[k].prompt_len
                  + reqs[k].answer_len)
    rest = [k for k in done if k != longest]
    order = traffic.seed_rng(seed, 3).permutation(len(rest))
    pick, n_tok = [longest], len(tokens[longest])
    for j in order:
        if n_tok >= target:
            break
        pick.append(rest[j])
        n_tok += len(tokens[rest[j]])
    return pick


def gaps_of(logits, tokens) -> List[float]:
    """Per served token: how far its reference logit lies below the
    reference's best at its position."""
    import torch
    out: List[float] = []
    for lg, tk in zip(logits, tokens):
        tk = torch.as_tensor(tk, device=lg.device).long()
        g = lg.max(dim=-1).values - lg.gather(-1, tk[:, None])[:, 0]
        out.extend(g.tolist())
    return out


def gap_summary(g: List[float]) -> str:
    if not g:
        return "no tokens"
    q = np.quantile(np.asarray(g), [0.5, 0.9, 0.99, 1.0])
    return (f"gaps over {len(g)} tokens: {sum(x > 0 for x in g)} off the "
            f"best, mean {float(np.mean(g)):.6f}, p50 {q[0]:.6f}, p90 "
            f"{q[1]:.6f}, p99 {q[2]:.6f}, max {q[3]:.6f}")
