"""The one traffic generator: reads a mix's parameters (and, open
loop, a cell's rate) and makes the requests of one run.

Every seed gets the same multiset of inter-arrival gaps and of (prompt,
answer) lengths, drawn once from the mix's ``shape_seed`` with the
frozen generators, in an order and with token ids drawn from
``--seed``: a seed changes which request comes when, not how much work
a run holds. Closed loop, where the number of requests a window gets
through follows the server, every seed sends the same sequence of
lengths: cycles of the mix's ``pool``, each in an order drawn from the
shape seed; the seed draws the token ids (and the weights)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from portbench.yardstick.arrivals import poisson_arrivals
from portbench.yardstick.lengths import lognormal_lengths


@dataclass
class Request:
    index: int
    due_s: float          # seconds after the window opens
    prompt_len: int
    answer_len: int


def _lengths(spec: Dict, n: int, seed: int) -> np.ndarray:
    if spec["dist"] != "lognormal":
        raise ValueError(f"length distribution {spec['dist']!r}: the "
                         f"generator draws lognormal only")
    return lognormal_lengths(n, seed=seed, mean=math.log(spec["median"]),
                             sigma=spec["sigma"], lo=spec["lo"],
                             hi=spec["hi"])


def seed_rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**64, *tags])


def serve_requests(mix: Dict, rate: float, seconds: float,
                   seed: int) -> List[Request]:
    """The open-loop schedule of one window of ``seconds`` at ``rate``
    requests/s (Poisson)."""
    base = mix["shape_seed"]
    times = poisson_arrivals(rate, seconds, seed=base)
    gaps = np.diff(np.concatenate([[0.0], times]))
    n = len(gaps)
    prompts = _lengths(mix["prompt_tokens"], n, base + 1)
    answers = _lengths(mix["answer_tokens"], n, base + 2)
    rng = seed_rng(seed, 0)
    due = np.cumsum(gaps[rng.permutation(n)])
    order = rng.permutation(n)
    return [Request(i, float(due[i]), int(prompts[order[i]]),
                    int(answers[order[i]])) for i in range(n)]


def closed_requests(mix: Dict) -> List[Request]:
    """The closed-loop sequence: ``cycles`` cycles of the ``pool``
    (prompt, answer) lengths, each cycle in an order of its own drawn
    from the shape seed, the same for every ``seed``; every request is
    due when a client sends it."""
    arr, base = mix["arrivals"], mix["shape_seed"]
    pool = arr["pool"]
    prompts = _lengths(mix["prompt_tokens"], pool, base + 1)
    answers = _lengths(mix["answer_tokens"], pool, base + 2)
    rng = seed_rng(base, 0)
    order = np.concatenate([rng.permutation(pool)
                            for _ in range(arr["cycles"])])
    return [Request(i, 0.0, int(prompts[j]), int(answers[j]))
            for i, j in enumerate(order)]


def prompt_tokens(seed: int, req: Request, vocab: int) -> np.ndarray:
    """(1, prompt_len) int32 token ids, uniform over the vocabulary."""
    return seed_rng(seed, 1, req.index).integers(
        0, vocab, size=(1, req.prompt_len), dtype=np.int32)
