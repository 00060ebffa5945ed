"""Plain float32 reference of three training steps of the sparse-MoE
transformer, as the port trains it: the forward of ``reference/moe.py``
over every row (the MoE routed over the whole batch's tokens under its
capacity, ``ceil4(T * top_k * capacity_factor / E)``, in token order),
the mean cross-entropy of every next token plus the routers'
load-balance loss (``E * sum_e frac_e * importance_e`` times its
weight, ``frac`` over every assignment), gradients by autograd,
clipping to a global norm, and AdamW with decoupled weight decay on
every leaf, the learning rate warming up as ``lr * (step + 1) /
warmup``.

Returns, per step, the loss; after step 1, the clipped gradient of
every leaf (its norm, as the optimizer gets it); after step 3, each
leaf's change (its norm)."""
from __future__ import annotations

import gc
import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench import weights
from portbench.reference.common import mm, rms_norm, strict_fp32
from portbench.reference.moe import attention, capacity

CE_CHUNK = 1024


def flat_params(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The masters as float32 leaves named by their path in the port's
    tree."""
    tree = weights.draw_params(cfg, seed, device, torch.float32)
    out = {}

    def walk(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(f"{prefix}.{i}", v)
        else:
            out[prefix] = t.clone()
    walk("", tree)
    return out


def moe_train(cfg: Dict, p: Dict, x: torch.Tensor, control: bool):
    """x (T, d) -> (out, aux): every token routed under the capacity of
    T tokens."""
    T = x.shape[0]
    E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    gates = torch.softmax(x @ p["router"], dim=-1)
    top_w, top_i = torch.topk(gates, k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    flat = top_i.reshape(-1)
    keep = torch.ones_like(flat, dtype=torch.bool)
    C = capacity(cfg, T)
    for e in range(E):
        idx = (flat == e).nonzero()[:, 0]
        keep[idx[C:]] = False
    keep = keep.view(T, k)
    out = torch.zeros_like(x)
    for e in range(E):
        t, slot = ((top_i == e) & keep).nonzero(as_tuple=True)
        if t.numel() == 0:
            continue
        xe = x[t]
        y = F.silu(mm(xe, p["w_gate"][e], control)) \
            * mm(xe, p["w_up"][e], control)
        y = mm(y, p["w_down"][e], control)
        out = out.index_add(0, t, y * top_w[t, slot][:, None])
    frac = torch.bincount(flat, minlength=E).float() / (T * k)
    aux = E * torch.sum(frac * gates.mean(0)) \
        * cfg["router_aux_loss_coef"]
    return out, aux


def loss_fn(cfg: Dict, P: Dict[str, torch.Tensor], tokens, labels,
            control: bool) -> torch.Tensor:
    eps = cfg["rms_norm_eps"]
    B, S = tokens.shape
    x = P["embed"][tokens.long()]
    aux_total = torch.zeros((), device=x.device)
    for li in range(cfg["num_hidden_layers"]):
        pre = f"layers.{li}."
        mix = {k: P[pre + "mixer." + k] for k in ("wq", "wk", "wv", "wo")}
        ffn = {k: P[pre + "ffn." + k]
               for k in ("router", "w_gate", "w_up", "w_down")}
        h = rms_norm(x, P[pre + "norm1.scale"], eps)
        x = x + torch.stack([attention(cfg, mix, h[b], control)
                             for b in range(B)])
        h = rms_norm(x, P[pre + "norm2.scale"], eps)
        y, aux = moe_train(cfg, ffn, h.reshape(B * S, -1), control)
        x = x + y.view(B, S, -1)
        aux_total = aux_total + aux
    h = rms_norm(x, P["final_norm.scale"], eps).reshape(B * S, -1)
    lab = labels.reshape(-1).long()
    ce = torch.zeros((), device=x.device)
    for c0 in range(0, B * S, CE_CHUNK):
        logits = mm(h[c0:c0 + CE_CHUNK], P["lm_head"], control)
        ce = ce + F.cross_entropy(logits, lab[c0:c0 + CE_CHUNK],
                                  reduction="sum")
    return ce / (B * S) + aux_total


def train_readings(cfg: Dict, seed: int, batches: List[Dict], device,
                   control=False, half: bool = False):
    """(losses of the steps, {leaf: norm of its clipped gradient at step
    1}, {leaf: norm of its change after the steps}). ``control``: the
    products in float8 (``common.mm``); ``half``: each step's mean over
    the first half of its rows only (a fault: half the batch left
    out)."""
    strict_fp32()
    tc = cfg["train"]
    P = flat_params(cfg, seed, device)
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    names = list(P)
    losses, first = [], {}
    for step, batch in enumerate(batches):
        leaves = [P[k].requires_grad_() for k in names]
        rows = batch["tokens"].shape[0] // 2 if half else None
        loss = loss_fn(cfg, P, batch["tokens"][:rows],
                       batch["labels"][:rows], control)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            gn = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = torch.clamp(tc["grad_clip"] / torch.clamp(gn, min=1e-9),
                                max=1.0)
            grads = [g * scale for g in grads]
            if step == 0:
                first = {k: float(g.norm()) for k, g in zip(names, grads)}
            t = step + 1
            c1, c2 = 1 - tc["beta1"] ** t, 1 - tc["beta2"] ** t
            lr = tc["learning_rate"] * min((step + 1.0)
                                           / max(tc["warmup_steps"], 1), 1.0)
            if step >= tc["warmup_steps"]:
                raise ValueError("the reference follows the warm-up only")
            for k, g in zip(names, grads):
                p = P[k].detach()
                m[k].mul_(tc["beta1"]).add_(g, alpha=1 - tc["beta1"])
                v2[k].mul_(tc["beta2"]).addcmul_(g, g,
                                                 value=1 - tc["beta2"])
                upd = (m[k] / c1) / ((v2[k] / c2).sqrt() + tc["eps"]) \
                    + tc["weight_decay"] * p
                P[k] = p - lr * upd
        del grads, loss
    del m, v2, leaves
    P0 = flat_params(cfg, seed, device)          # drawn again
    change = {k: float((P[k] - P0[k]).norm()) for k in names}
    del P, P0
    gc.collect()      # autograd leaves this run's tensors in cycles
    return losses, first, change


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    names = [k for k in ref if keep is None or k in keep]
    med = sorted(ref[k] for k in names)[len(names) // 2]
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in names}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep=None) -> float:
    """The worst leaf's ``leaf_gaps``."""
    return max(leaf_gaps(prog, ref, keep).values())


def moved_leaves(first: Dict[str, float]) -> set:
    """Leaves whose reference gradient is above a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    med = sorted(first.values())[len(first) // 2]
    return {k for k, g in first.items() if g > 1e-3 * med}


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a) \
        else math.inf
