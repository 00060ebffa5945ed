"""Plain reference of one parameter-server round (paper section 4.5):
endpoints ``0 .. n_ps-1`` are the PS, the next ``n_workers`` the
workers; the pull (every PS to every worker) and then the push (every
worker to every PS) run as rounds of row permutations. In a round the
row of each destination becomes the row of its source and every other
row is zero. Serialisation must not change a byte: the expected output
is the rounds applied to each buffer on its own."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

Round = List[Tuple[int, int]]


def bipartite_schedule(srcs: Sequence[int], dsts: Sequence[int]
                       ) -> List[Round]:
    """Frozen copy of ``repro_torch.core.channels.bipartite_schedule``:
    the round-robin edge colouring of K_{|srcs|,|dsts|}, each round with
    unique sources and destinations."""
    m, n = len(srcs), len(dsts)
    rounds = []
    if m <= n:
        for r in range(n):
            rounds.append([(srcs[i], dsts[(i + r) % n]) for i in range(m)])
    else:
        for r in range(m):
            rounds.append([(srcs[(j + r) % m], dsts[j]) for j in range(n)])
    return rounds


def ps_rounds(n_ps: int, n_workers: int) -> List[Round]:
    ps = list(range(n_ps))
    workers = list(range(n_ps, n_ps + n_workers))
    return bipartite_schedule(ps, workers) + bipartite_schedule(workers, ps)


def stages(bufs: Sequence[torch.Tensor], n_ps: int, n_workers: int,
           serialized: bool, control: bool = False) -> List[tuple]:
    """What one round produces, stage by stage, as the port's round
    records it: serialized, the packed rows (every buffer's row laid end
    to end), the packed rows after each permutation, and the buffers cut
    back out of the last; otherwise each buffer after each permutation.
    ``control`` delivers the payload through float8 (the bytes read as
    bfloat16, rounded to e4m3 and back): a compressed transfer, which
    breaks the guarantee that every byte arrives as sent."""
    rounds = ps_rounds(n_ps, n_workers)
    if control:
        bufs = [b.view(torch.bfloat16).to(torch.float8_e4m3fn)
                .to(torch.bfloat16).view(torch.uint8) for b in bufs]

    def permute(x, rnd):
        y = torch.zeros_like(x)
        for s, d in rnd:
            y[d] = x[s]
        return y
    out = []
    if serialized:
        x = torch.cat(list(bufs), dim=1)
        out.append(("packed", x))
        for rnd in rounds:
            x = permute(x, rnd)
            out.append(("round", x))
        sizes = [b.shape[1] for b in bufs]
        out.append(("unpacked", list(torch.split(x, sizes, dim=1))))
        return out
    for b in bufs:
        x = b
        for rnd in rounds:
            x = permute(x, rnd)
            out.append(("round", x))
    return out


def mismatched(got: List[tuple], want: List[tuple]) -> int:
    """Bytes that differ between two stage lists; a missing, extra or
    misshapen stage counts every byte of it."""
    def flat(stage) -> torch.Tensor:
        t = stage[1]
        return (t if isinstance(t, torch.Tensor)
                else torch.cat([x.reshape(-1) for x in t])).reshape(-1)
    bad = 0
    for j in range(max(len(got), len(want))):
        if j >= len(got) or j >= len(want):
            bad += flat((got if j < len(got) else want)[j]).numel()
            continue
        a, b = flat(got[j]), flat(want[j])
        if got[j][0] != want[j][0] or a.numel() != b.numel():
            bad += max(a.numel(), b.numel())
        else:
            bad += int((a != b).sum())
    return bad
