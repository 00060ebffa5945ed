"""Training steps back to back: the port's train step
(``launch/steps.make_train_step``, the step ``launch/train.py``'s
trainer builds: loss and gradients under remat with K3 in the forward,
clipping and AdamW on fp32 masters) on one object of parameters and
optimizer state, fed a batch of new rows from the seed every step.

Set-up draws the masters, runs the mix's ``checked_steps`` through the
same call and feed (they build and warm every kernel), and reads what
``correct`` compares: each step's loss, every leaf's first gradient
from AdamW's first moment after step 1 (``m / (1 - beta1)``), and every
leaf's change after the last checked step (the masters drawn again from
the seed). The window then runs steps for ``--seconds``; ``train_tok_s``
is the window's tokens over its wall time, which ends in
``torch.cuda.synchronize``.

``correct``: the plain float32 reference (``reference/moe_train.py``)
follows the same steps on the same rows after the window, and each
number the cell file limits (the loss; the gradient and change norms,
by the worst leaf and by the median leaf) must stay under it."""
from __future__ import annotations

import time
from typing import Dict, List

import torch

from portbench import weights
from portbench.devtrace import DeviceTrace
from portbench.harness import Check, Outcome, load_module


def leaves(tree, prefix="") -> Dict[str, torch.Tensor]:
    """A parameter-shaped tree as {path: tensor}."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}.{k}" if prefix else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}.{i}"))
    else:
        out[prefix] = tree
    return out


def make_batch(cfg: Dict, mix: Dict, seed: int, k: int, device) -> Dict:
    """Step ``k``'s rows: tokens uniform over the vocabulary, each row's
    labels its next tokens."""
    g = torch.Generator(device=device)
    g.manual_seed(weights.sub_seed(seed, 5000 + k))
    t = torch.randint(0, cfg["vocab_size"],
                      (mix["batch"], mix["seq_len"] + 1), generator=g,
                      device=device, dtype=torch.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


class OptimizerClock:
    """CUDA events around ``optimizer.apply_updates`` (the step's AdamW
    half, as ``chip_smoke.py``'s step breakdown splits it), while
    ``on``."""

    def __init__(self, O):
        self._O, self._fn = O, O.apply_updates
        self.on, self.events = False, []
        clock = self

        def timed(*a, **kw):
            if not clock.on:
                return clock._fn(*a, **kw)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = clock._fn(*a, **kw)
            e1.record()
            clock.events.append((e0, e1))
            return out
        O.apply_updates = timed

    def restore(self):
        self._O.apply_updates = self._fn

    def seconds(self) -> List[float]:
        return [a.elapsed_time(b) * 1e-3 for a, b in self.events]


def run(h) -> Outcome:
    from repro_torch.launch import steps
    from repro_torch.optim import optimizer as O
    cfg, mix, dev = h.config, h.mix, h.device
    on_card = dev == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    tc = cfg["train"]
    acfg = h.arch_config(train=True)
    tokens_per_step = mix["batch"] * mix["seq_len"]
    clock = OptimizerClock(O) if (h.trace and on_card) else None
    params = weights.draw_params(cfg, h.seed, dev, torch.float32)
    opt = O.init_opt_state(acfg.train, params,
                           period=acfg.model.pattern_period)
    step_fn = steps.make_train_step(acfg)
    n_check = mix["checked_steps"]
    losses: List[float] = []
    first: Dict[str, float] = {}
    for k in range(n_check):
        params, opt, m = step_fn(params, opt,
                                 make_batch(cfg, mix, h.seed, k, dev))
        losses.append(float(m["loss"]))
        if k == 0:
            first = {n: float(t.norm()) / (1 - tc["beta1"])
                     for n, t in leaves(opt["m"]).items()}
    change = {}
    now = leaves(params)
    for name, p0 in leaves(weights.draw_params(
            cfg, h.seed, dev, torch.float32)).items():
        change[name] = float((now[name] - p0).norm())
    del now, p0
    sync()
    trace = DeviceTrace() if (h.trace and on_card) else None
    if trace is not None:
        trace.prime()
    t0 = time.perf_counter()
    setup_s = t0 - h.t_start
    tr_on = t0 + 0.3 * h.seconds
    tr_len = min(mix["trace_s"], 0.4 * h.seconds)
    k, tr_steps, k_on = n_check, 0, 0
    while True:
        now_t = time.perf_counter()
        if now_t - t0 >= h.seconds:
            break
        if trace is not None:
            if not trace.active and trace.bounds is None and now_t >= tr_on:
                tr_off = trace.start() + tr_len
                k_on = k
                clock.on = True
            elif trace.active and now_t >= tr_off:
                trace.stop()
                clock.on = False
                tr_steps = k - k_on
        params, opt, _ = step_fn(params, opt,
                                 make_batch(cfg, mix, h.seed, k, dev))
        k += 1
    sync()
    elapsed = time.perf_counter() - t0
    if trace is not None and trace.active:
        trace.stop()
        clock.on = False
        tr_steps = k - k_on
    if clock is not None:
        clock.restore()
    n_win = k - n_check
    notes = [f"{n_win} steps of {tokens_per_step} tokens in {elapsed:.6f} "
             f"s; checked steps' loss {losses}; setup {setup_s:.3f} s"]
    records = {"config": cfg, "mix": mix, "trace": trace,
               "trace_steps": tr_steps,
               "optimizer_s": clock.seconds() if clock else []}
    state = {"params": params, "opt": opt}

    def release():
        state.clear()

    ref = load_module(h.dir / "reference" / f"{cfg['family']}_train.py",
                      f"portbench_ref_{cfg['family']}_train")
    lim = h.params["limits"]

    def checks(r_loss, r_first, r_change, p_loss, p_first, p_change):
        """The numbers the cell holds, each where the cell file gives it
        a limit: the worst step's loss gap; the worst leaf's and the
        median leaf's gap of first-gradient norms; the same of the
        change's norms over the leaves the reference moves."""
        moved = ref.moved_leaves(r_first)
        gaps = {"grad": ref.leaf_gaps(p_first, r_first),
                "change": ref.leaf_gaps(p_change, r_change, moved)}
        worst = {n: sorted(g.items(), key=lambda kv: -kv[1])[:3]
                 for n, g in gaps.items()}
        notes.append(f"loss gap by step {[ref.rel(a, b) for a, b in zip(p_loss, r_loss)]}; worst leaves {worst}; "
                     f"left out of the change: {sorted(set(r_first) - moved)}")
        got = {"loss_rel_gap": max(ref.rel(a, b)
                                   for a, b in zip(p_loss, r_loss))}
        for n, g in gaps.items():
            v = sorted(g.values())
            got[f"{n}_norm_gap"] = v[-1]
            got[f"{n}_median_gap"] = v[len(v) // 2]
        return [Check(k, got[k], v) for k, v in lim.items()]

    batches = [make_batch(cfg, mix, h.seed, j, dev) for j in range(n_check)]
    exact: List = []

    def verify() -> List[Check]:
        t = time.perf_counter()
        exact[:] = ref.train_readings(cfg, h.seed, batches, dev)
        notes.append(f"reference: {n_check} steps in "
                     f"{time.perf_counter() - t:.3f} s; losses {exact[0]}")
        return checks(*exact, losses, first, change)

    def control(variant: str = "fp8") -> List[Check]:
        """The reference in the program's place: as a float8 step
        (``common.mm``: ``fp8`` scaled per row and column, ``fp8_tensor``
        per tensor), or with half of each batch left out (``half``)."""
        low = (ref.train_readings(cfg, h.seed, batches, dev, half=True)
               if variant == "half" else
               ref.train_readings(cfg, h.seed, batches, dev,
                                  control=variant))
        return checks(*exact, *low)

    return Outcome(attempted=n_win, failed=0,
                   metrics={"train_tok_s": n_win * tokens_per_step / elapsed,
                            "setup_s": setup_s},
                   records=records, notes=notes, release=release,
                   verify=verify, control=control)
