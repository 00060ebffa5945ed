"""Data-parallel training steps over the RPC fabric — the paper's
training workload (§3: tensor updates between PS and workers) on the
same datapath the micro-benchmarks measure.

Two gradient-synchronization modes, one step API:

  ps         the paper's deployment: parameters sharded across
             ``n_ps`` server endpoints (balanced, like the sharded
             serving dispatch); every worker pushes its gradient
             shard to the owning PS (one tagged push flight — the PS
             ingress of that flight is exactly
             ``netmodel.ps_round_time`` of the shard payload), each
             PS applies the SGD update in ascending worker order,
             then fans the updated shards back out (the fetch
             flight).
  allreduce  no servers: every endpoint is a worker and the gradient
             is reduced with an ``rpc.collectives`` schedule
             (``ring`` / ``tree`` / ``rsag``), then applied locally.

Gradients come from :class:`SyntheticGradEngine` — a numpy-only
stand-in mirroring ``workload.driver.SyntheticEngine``: the local
gradient is a pure function of ``(seed, worker, step, params)``, so
two runs of the same config produce bit-identical parameters (the
fault tier retries a push and nothing changes) and tier-1 never
imports jax. A real ``train.trainer`` step plugs in through the same
``grad_fn(params, worker, step)`` hook.

``ps_train_step_time`` / ``allreduce_train_step_time`` are the closed
forms the simulated transport matches exactly;
``launch.bench_comm --benchmark train_step --train-mode ps|allreduce``
sweeps them against each other to find the PS -> allreduce crossover
as workers grow.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.netmodel import (ALLREDUCE_TAG_BYTES, NetworkModel,
                                 allreduce_chunk_sizes,
                                 resolve_wire_mode)
from repro_torch.rpc.collectives import (CollectiveReport, _inboxes,
                                   _read_tagged, _stub, _tag)

_DTYPE = np.float32
_ITEMSIZE = 4


class SyntheticGradEngine:
    """Numpy-only synthetic gradient source (quadratic loss).

    Worker ``w`` at step ``t`` pulls toward a seeded target vector
    ``target(w, t)``: ``grad = params - target``, ``loss = 0.5 *
    mean((params - target)^2)``. Like ``SyntheticEngine``'s token
    stream, every value is a pure function of ``(seed, worker, step)``
    — replaying a run reproduces it byte-for-byte."""

    def __init__(self, n_params: int, *, seed: int = 0):
        assert n_params >= 1, n_params
        self.n_params = int(n_params)
        self.seed = int(seed)
        self.grads_computed = 0

    def init_params(self) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 0xA11])
        return rng.standard_normal(self.n_params).astype(_DTYPE)

    def target(self, worker: int, step: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, worker, step])
        return rng.standard_normal(self.n_params).astype(_DTYPE)

    def grad(self, params: np.ndarray, worker: int,
             step: int) -> np.ndarray:
        self.grads_computed += 1
        return (params - self.target(worker, step)).astype(_DTYPE)

    def loss(self, params: np.ndarray, worker: int, step: int) -> float:
        d = params - self.target(worker, step)
        return float(0.5 * np.mean(d * d))


@dataclass
class TrainStepReport:
    """One data-parallel step: its comm cost and training signals."""
    step: int
    mode: str
    loss: float                  # mean pre-update loss across workers
    grad_norm: float             # L2 of the mean gradient
    elapsed_s: float = 0.0       # modeled comm time (0 on loopback)
    wall_s: float = 0.0
    flights: int = 0
    messages: int = 0
    modeled: bool = False


@dataclass
class FabricTrainConfig:
    mode: str = "allreduce"           # "ps" | "allreduce"
    algo: str = "ring"                # allreduce schedule
    n_ps: int = 2                     # PS endpoints (ps mode)
    n_params: int = 4096
    lr: float = 0.1
    seed: int = 0
    serialized: bool = False
    wire_mode: Optional[str] = None


class FabricTrainStep:
    """Run data-parallel SGD steps over one fabric.

    ``ps`` mode expects endpoints ``0..n_ps-1`` to be parameter
    servers and the rest workers (the ``ps_worker_cluster`` layout);
    ``allreduce`` mode treats every endpoint as a worker. All worker
    replicas start identical and must stay bit-identical after every
    step — :meth:`step` asserts it."""

    def __init__(self, fabric, cfg: FabricTrainConfig = None, *,
                 grad_fn: Optional[Callable] = None,
                 engine: Optional[SyntheticGradEngine] = None):
        self.cfg = cfg if cfg is not None else FabricTrainConfig()
        cfg = self.cfg
        if cfg.mode not in ("ps", "allreduce"):
            raise ValueError(f"unknown train mode {cfg.mode!r}; "
                             f"expected 'ps' or 'allreduce'")
        if not fabric.transport.dispatches:
            raise ValueError("FabricTrainStep needs a dispatching "
                             "transport (loopback/simulated/cluster)")
        self.fabric = fabric
        n = fabric.n_endpoints
        if cfg.mode == "ps":
            if not 1 <= cfg.n_ps < n:
                raise ValueError(
                    f"ps mode needs 1 <= n_ps < n_endpoints: "
                    f"n_ps={cfg.n_ps}, endpoints={n}")
            self.n_ps = cfg.n_ps
            self.n_workers = n - cfg.n_ps
        else:
            if n < 2:
                raise ValueError("allreduce mode needs >= 2 endpoints")
            self.n_ps = 0
            self.n_workers = n
        if cfg.n_params < max(1, self.n_workers, self.n_ps):
            raise ValueError(
                f"n_params ({cfg.n_params}) must cover every shard: "
                f"needs >= {max(self.n_workers, self.n_ps)}")
        self.engine = engine if engine is not None \
            else SyntheticGradEngine(cfg.n_params, seed=cfg.seed)
        self.grad_fn = grad_fn if grad_fn is not None else self.engine.grad
        p0 = self.engine.init_params()
        #: per-worker parameter replicas (all bit-identical)
        self.replicas: List[np.ndarray] = [p0.copy()
                                           for _ in range(self.n_workers)]
        if cfg.mode == "ps":
            self._shard_sizes = allreduce_chunk_sizes(
                cfg.n_params * _ITEMSIZE, self.n_ps,
                itemsize=_ITEMSIZE)
            offs = [0]
            for s in self._shard_sizes:
                offs.append(offs[-1] + s // _ITEMSIZE)
            self._offs = offs
            #: the PS-side authoritative shards
            self.shards: List[np.ndarray] = [
                p0[offs[p]:offs[p + 1]].copy() for p in range(self.n_ps)]
        self.step_count = 0

    @property
    def params(self) -> np.ndarray:
        return self.replicas[0]

    def _worker_endpoint(self, w: int) -> int:
        return self.n_ps + w

    def step(self) -> TrainStepReport:
        cfg, t = self.cfg, self.step_count
        grads = [self.grad_fn(self.replicas[w], w, t)
                 for w in range(self.n_workers)]
        loss = float(np.mean([self.engine.loss(self.replicas[w], w, t)
                              for w in range(self.n_workers)]))
        if cfg.mode == "allreduce":
            rep = self._allreduce_step(grads)
        else:
            rep = self._ps_step(grads)
        mean_grad = np.sum(grads, axis=0) / self.n_workers
        out = TrainStepReport(
            step=t, mode=cfg.mode, loss=loss,
            grad_norm=float(np.linalg.norm(mean_grad)),
            elapsed_s=rep.elapsed_s, wall_s=rep.wall_s,
            flights=rep.flights, messages=rep.messages,
            modeled=rep.modeled)
        self.step_count += 1
        first = self.replicas[0]
        assert all((r == first).all() for r in self.replicas[1:]), \
            "worker replicas diverged"
        return out

    # one step per mode -------------------------------------------------
    def _allreduce_step(self, grads) -> CollectiveReport:
        from repro_torch.rpc.collectives import allreduce
        rep = allreduce(self.fabric, self.cfg.algo, data=grads,
                        itemsize=_ITEMSIZE,
                        serialized=self.cfg.serialized,
                        wire_mode=self.cfg.wire_mode)
        scale = _DTYPE(self.cfg.lr / self.n_workers)
        for w in range(self.n_workers):
            self.replicas[w] = (self.replicas[w]
                                - scale * rep.result[w]).astype(_DTYPE)
        return rep

    def _ps_step(self, grads) -> CollectiveReport:
        fab, cfg = self.fabric, self.cfg
        boxes = _inboxes(fab)
        offs = self._offs
        rep = CollectiveReport(algo="ps",
                               modeled=fab.transport.modeled)
        # push flight: worker-major, shard-minor (the closed form
        # replays this order)
        for w in range(self.n_workers):
            ep = self._worker_endpoint(w)
            for p in range(self.n_ps):
                seg = np.ascontiguousarray(
                    grads[w][offs[p]:offs[p + 1]])
                _stub(fab, ep, p, cfg.serialized, cfg.wire_mode).chunk(
                    [_tag(ep), seg.view(np.uint8)], one_way=True)
        rep.merge(fab.flush())
        scale = _DTYPE(cfg.lr / self.n_workers)
        for p in range(self.n_ps):
            got = {}
            for entry in boxes[p]:
                src, vals = _read_tagged(entry)
                got[src] = vals
            boxes[p].clear()
            assert len(got) == self.n_workers, \
                f"ps {p}: pushes from {sorted(got)}"
            acc = None
            for src in sorted(got):         # fixed summation order
                acc = got[src] if acc is None else acc + got[src]
            self.shards[p] = (self.shards[p] - scale * acc).astype(_DTYPE)
        # fetch flight: shard-major, worker-minor
        for p in range(self.n_ps):
            for w in range(self.n_workers):
                ep = self._worker_endpoint(w)
                _stub(fab, p, ep, cfg.serialized, cfg.wire_mode).chunk(
                    [_tag(p), np.ascontiguousarray(self.shards[p])
                     .view(np.uint8)], one_way=True)
        rep.merge(fab.flush())
        for w in range(self.n_workers):
            ep = self._worker_endpoint(w)
            assert len(boxes[ep]) == self.n_ps
            for entry in boxes[ep]:
                src, vals = _read_tagged(entry)
                self.replicas[w][offs[src]:offs[src + 1]] = vals
            boxes[ep].clear()
        return rep


# ---------------------------------------------------------------------------
# closed forms (exactness held by tests/test_fabric_train.py)
# ---------------------------------------------------------------------------

def ps_train_step_time(net: NetworkModel, total_bytes: int, n_ps: int,
                       n_workers: int, *, itemsize: int = _ITEMSIZE,
                       serialized: bool = False,
                       mode: Optional[str] = None) -> float:
    """One PS step on the simulated transport: the tagged push flight
    (each PS ingests ``n_workers`` shard pushes — per PS this is
    exactly ``netmodel.ps_round_time`` of the tagged shard payload,
    racing the workers' own egress) plus the mirrored fetch flight."""
    mode = resolve_wire_mode(serialized, mode)
    shards = allreduce_chunk_sizes(total_bytes, n_ps, itemsize=itemsize)
    tag = ALLREDUCE_TAG_BYTES
    push = [(n_ps + w, p, (tag, shards[p]))
            for w in range(n_workers) for p in range(n_ps)]
    fetch = [(p, n_ps + w, (tag, shards[p]))
             for p in range(n_ps) for w in range(n_workers)]
    return (net._flight_elapsed(push, mode)
            + net._flight_elapsed(fetch, mode))


def allreduce_train_step_time(net: NetworkModel, total_bytes: int,
                              n_workers: int, *, algo: str = "ring",
                              itemsize: int = _ITEMSIZE,
                              serialized: bool = False,
                              mode: Optional[str] = None) -> float:
    """One allreduce step: the collective's closed form."""
    return net.allreduce_time(algo, total_bytes, n_workers,
                              itemsize=itemsize, serialized=serialized,
                              mode=mode)


def train_step_time(net: NetworkModel, train_mode: str,
                    total_bytes: int, n_workers: int, *,
                    n_ps: int = 2, algo: str = "ring",
                    itemsize: int = _ITEMSIZE, serialized: bool = False,
                    mode: Optional[str] = None) -> float:
    """Dispatch on the train mode (the ``bench_comm`` crossover axis:
    PS cost grows quadratically with workers through the host-copy
    contention term, ring allreduce stays near-flat)."""
    if train_mode == "ps":
        return ps_train_step_time(net, total_bytes, n_ps, n_workers,
                                  itemsize=itemsize,
                                  serialized=serialized, mode=mode)
    if train_mode == "allreduce":
        return allreduce_train_step_time(net, total_bytes, n_workers,
                                         algo=algo, itemsize=itemsize,
                                         serialized=serialized,
                                         mode=mode)
    raise ValueError(f"unknown train mode {train_mode!r}; "
                     f"expected 'ps' or 'allreduce'")


__all__ = [
    "FabricTrainConfig", "FabricTrainStep", "SyntheticGradEngine",
    "TrainStepReport", "allreduce_train_step_time",
    "ps_train_step_time", "train_step_time",
]
