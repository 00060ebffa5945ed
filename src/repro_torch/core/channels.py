"""Communication channels: the port's realization of the paper's gRPC
primitives on one card.

 - P2P echo / one-way send  -> a row-permutation round (the reference's
                               ``jax.lax.ppermute`` on a 1-D device axis)
 - PS pull (variable fetch) -> multicast rounds PS -> every worker
 - PS push (tensor update)  -> worker -> every PS (multicast rounds)

The reference runs N endpoints as N XLA devices on a 1-D ``net`` mesh,
each owning one row of every ``(N, size)`` uint8 buffer. On one GPU the
N endpoints are the N rows of one device tensor (``make_net_mesh``), and
a ppermute round is a row-permutation copy in HBM: for each ``(src,
dst)`` of the round, row ``dst`` of the output is row ``src`` of the
input, and every row that is no destination is zero, as ppermute leaves
it. Non-serialized mode moves each buffer separately; serialized mode
packs all buffers into one contiguous transfer first
(``core.serialization``, the payload_pack kernels on the card).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

import torch

from repro_torch.core import serialization as ser
from repro_torch.core.payload import PayloadSpec, materialize

AXIS = "net"
#: endpoints of a mesh by default: the reference's benchmark CLI forces
#: 8 host devices
DEFAULT_ENDPOINTS = 8


@dataclass(frozen=True)
class NetMesh:
    """``n`` endpoints, the rows of every payload buffer on ``device``."""
    n: int
    device: torch.device

    @property
    def shape(self):
        return {AXIS: self.n}


def make_net_mesh(n: int = 0, device="cuda") -> NetMesh:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the endpoints' rows live on a CUDA card, and "
                           "none is visible (torch.cuda.is_available() is "
                           "False); pass device='cpu' for the plain path")
    return NetMesh(n or DEFAULT_ENDPOINTS, device)


def device_payload(mesh: NetMesh, spec: PayloadSpec, *, seed: int = 0
                   ) -> List[torch.Tensor]:
    """Materialize one payload row per endpoint: list of (N, size)
    uint8."""
    host = materialize(spec, seed=seed, tpu_align=True)
    return [torch.from_numpy(b).to(mesh.device).expand(mesh.n, -1)
            .contiguous() for b in host]


# ---------------------------------------------------------------------------
# P2P
# ---------------------------------------------------------------------------

class _Round:
    """One ppermute round as index tensors on the mesh's device, built
    once per channel function."""

    def __init__(self, mesh: NetMesh, perm: Sequence[Tuple[int, int]]):
        srcs = [int(s) for s, _ in perm]
        dsts = [int(d) for _, d in perm]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            raise ValueError(f"a round needs unique sources and "
                             f"destinations, got {list(perm)}")
        if any(not 0 <= i < mesh.n for i in srcs + dsts):
            raise ValueError(f"round {list(perm)} leaves the {mesh.n} "
                             f"endpoints")
        self.src = torch.tensor(srcs, dtype=torch.long, device=mesh.device)
        self.dst = torch.tensor(dsts, dtype=torch.long, device=mesh.device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros_like(x)
        return out.index_copy_(0, self.dst, x.index_select(0, self.src))


def _check(mesh: NetMesh, bufs, n_buffers: int) -> None:
    if len(bufs) != n_buffers or any(b.shape[0] != mesh.n for b in bufs):
        raise ValueError(f"expected {n_buffers} buffers of {mesh.n} rows, "
                         f"got shapes {[tuple(b.shape) for b in bufs]}")


def permute_rounds_fn(mesh: NetMesh, n_buffers: int,
                      rounds: Sequence[Sequence[Tuple[int, int]]],
                      serialized: bool = False) -> Callable:
    """Run a sequence of ppermute rounds over one payload: the common
    lowering every channel (and the rpc collective transport) compiles
    to. One row permutation per buffer per round (non-serialized) or
    pack -> one permutation per round -> unpack (serialized)."""
    rounds = [_Round(mesh, r) for r in rounds]

    def go(*bufs):
        _check(mesh, bufs, n_buffers)
        if serialized:
            packed, meta = ser.pack(bufs)
            for rnd in rounds:
                packed = rnd(packed)
            return tuple(ser.unpack(packed, meta))
        out = []
        for b in bufs:
            for rnd in rounds:
                b = rnd(b)
            out.append(b)
        return tuple(out)

    return go


def p2p_echo_fn(mesh: NetMesh, n_buffers: int, src: int = 0, dst: int = 1,
                serialized: bool = False) -> Callable:
    """Round trip src -> dst -> src."""
    return permute_rounds_fn(mesh, n_buffers, [[(src, dst)], [(dst, src)]],
                             serialized=serialized)


def p2p_send_fn(mesh: NetMesh, n_buffers: int, src: int = 0, dst: int = 1,
                serialized: bool = False) -> Callable:
    """One-way payload + 64-byte ack back (bandwidth benchmark)."""
    fwd, bwd = _Round(mesh, [(src, dst)]), _Round(mesh, [(dst, src)])

    def send(*bufs):
        _check(mesh, bufs, n_buffers)
        if serialized:
            packed, meta = ser.pack(bufs)
            packed = fwd(packed)
            ack = bwd(packed[..., :64])
            return (packed, ack)
        out = [fwd(b) for b in bufs]
        ack = bwd(out[0][..., :64])
        return tuple(out) + (ack,)

    return send


# ---------------------------------------------------------------------------
# Parameter-server round
# ---------------------------------------------------------------------------

def bipartite_schedule(srcs: Sequence[int], dsts: Sequence[int]
                       ) -> List[List[Tuple[int, int]]]:
    """Edge-color K_{|srcs|,|dsts|}: a minimal sequence of ppermute rounds
    (each with unique sources AND destinations) covering every (src, dst)
    pair exactly once. Rounds = max(|srcs|, |dsts|)."""
    m, n = len(srcs), len(dsts)
    rounds = []
    if m <= n:
        for r in range(n):
            rounds.append([(srcs[i], dsts[(i + r) % n]) for i in range(m)])
    else:
        for r in range(m):
            rounds.append([(srcs[(j + r) % m], dsts[j]) for j in range(n)])
    return rounds


def ps_round_fn(mesh: NetMesh, n_buffers: int, n_ps: int, n_workers: int,
                serialized: bool = False) -> Callable:
    """One PS round on endpoints [0..n_ps) = PS, [n_ps..n_ps+n_workers) =
    workers.

    pull: every PS sends its variable shard to every worker (the
          rendezvous'd tensor-fetch response), n_ps x n_workers messages
    push: every worker sends its update to every PS, n_workers x n_ps
          messages

    A round needs unique sources and destinations, so the all-pairs
    exchange is scheduled as a round-robin edge coloring — which also
    matches the per-NIC serialization the netmodel assumes.
    """
    ps_ids = list(range(n_ps))
    w_ids = list(range(n_ps, n_ps + n_workers))
    assert n_ps + n_workers <= mesh.shape[AXIS]
    rounds = bipartite_schedule(ps_ids, w_ids) \
        + bipartite_schedule(w_ids, ps_ids)
    return permute_rounds_fn(mesh, n_buffers, rounds,
                             serialized=serialized)


def rpcs_per_round(n_ps: int, n_workers: int) -> int:
    """The paper counts one RPC per worker x PS interaction per round."""
    return n_ps * n_workers


# ---------------------------------------------------------------------------
# Fully-connected exchange (paper §2 process architecture: every worker
# talks to every other worker)
# ---------------------------------------------------------------------------

def all_to_all_schedule(n: int) -> List[List[Tuple[int, int]]]:
    """Round-robin schedule of the complete digraph K_n: n-1 rounds of
    shift-by-r permutations, each with unique sources and destinations,
    covering every ordered (src, dst) pair with src != dst exactly
    once."""
    assert n >= 2, n
    return [[(i, (i + r) % n) for i in range(n)] for r in range(1, n)]


def fully_connected_fn(mesh: NetMesh, n_buffers: int, n_workers: int,
                       serialized: bool = False) -> Callable:
    """One full exchange: every endpoint sends the payload to every
    other endpoint (n_workers * (n_workers - 1) RPCs)."""
    return permute_rounds_fn(mesh, n_buffers,
                             all_to_all_schedule(n_workers),
                             serialized=serialized)


def fc_rpcs_per_round(n_workers: int) -> int:
    return n_workers * (n_workers - 1)


# ---------------------------------------------------------------------------
# Ring / incast streaming families (the rpc fabric's two stream-shaped
# traffic patterns; the rpc collective transport recovers these exact
# rounds from its greedy edge coloring)
# ---------------------------------------------------------------------------

def ring_schedule(n: int, n_chunks: int = 1
                  ) -> List[List[Tuple[int, int]]]:
    """Rotation schedule for a chunked ring stream: ``n_chunks`` rounds
    of the successor permutation i -> (i+1) % n. Every round is a full
    permutation (unique sources AND destinations), so a ring moves one
    chunk per worker per round regardless of n — including n == 2,
    where the round degenerates to the swap (0,1),(1,0)."""
    assert n >= 2, n
    assert n_chunks >= 1, n_chunks
    perm = [(i, (i + 1) % n) for i in range(n)]
    return [list(perm) for _ in range(n_chunks)]


def incast_schedule(n_workers: int, *, server: int = 0,
                    n_chunks: int = 1) -> List[List[Tuple[int, int]]]:
    """Serialized incast rounds: workers 1..n_workers each stream
    ``n_chunks`` chunks into one server endpoint. A single destination
    admits one message per round (the ppermute / single-port
    constraint), so the schedule is n_workers * n_chunks singleton
    rounds, chunk-major. ``n_workers == 1`` degenerates to a plain
    chunked P2P send."""
    assert n_workers >= 1, n_workers
    assert n_chunks >= 1, n_chunks
    workers = [w for w in range(n_workers + 1) if w != server][:n_workers]
    return [[(w, server)] for _ in range(n_chunks) for w in workers]


def ring_fn(mesh: NetMesh, n_buffers: int, n_workers: int, *,
            n_chunks: int = 1, serialized: bool = False) -> Callable:
    """One chunked ring pass: every worker streams to its successor."""
    return permute_rounds_fn(mesh, n_buffers,
                             ring_schedule(n_workers, n_chunks),
                             serialized=serialized)


def ring_rpcs_per_round(n_workers: int, n_chunks: int = 1) -> int:
    return n_workers * n_chunks


def incast_rpcs_per_round(n_workers: int, n_chunks: int = 1) -> int:
    return n_workers * n_chunks


# ---------------------------------------------------------------------------
# Collective channels (the SPMD-native PS: FSDP pull/push)
# ---------------------------------------------------------------------------

def fsdp_pull_push_fn(mesh: NetMesh, n_buffers: int) -> Callable:
    """all_gather (pull the full variable from its PS shards) followed by
    psum_scatter (push: reduce updates back onto the shards), computed
    literally over the rows: every endpoint gathers all N rows, scales
    them, the N endpoints' copies are summed, and endpoint i keeps row i
    of the sum. The cast back to uint8 saturates, as XLA's does."""
    n = mesh.n

    def step(*bufs):
        _check(mesh, bufs, n_buffers)
        outs = []
        for b in bufs:
            full = b.unsqueeze(0).expand(n, *b.shape)     # all_gather
            upd = full.to(torch.float32) * 1.000001
            summed = upd.sum(0)                           # psum ...
            # ... scatter: row i of the sum is endpoint i's shard
            outs.append(summed.clamp_(0, 255).to(b.dtype))
        return tuple(outs)

    return step
