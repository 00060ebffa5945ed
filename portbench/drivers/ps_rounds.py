"""The paper's parameter-server throughput: ``core/channels.ps_round_fn``
(pull then push, serialized through K1 / K2) driven back to back on
the endpoints' rows of one card, over ``input_sets`` payloads drawn
from the seed in turn.

``rpcs_per_s`` counts ``n_ps * n_workers`` RPCs a round, over every
round issued in the window, divided by the window's wall time, which
ends in ``torch.cuda.synchronize``.

``correct``: a round's last output is all zeros (each permutation
zeroes every row that is no destination, and the push's sources are
the pull's zeroed rows), so the harness keeps what a few rounds drawn
from the seed, and the last, produce at every stage: K1's packed rows,
each permutation's output and K2's unpacked buffers (references to the
round's own tensors, recorded by wrappers around
``core.serialization.pack`` / ``unpack`` and the round's permutation).
Once the window has closed they are compared byte for byte with the
plain reference (``reference/ps.py``)."""
from __future__ import annotations

import time
from typing import Dict, List

import torch

from portbench import traffic, weights
from portbench.devtrace import DeviceTrace
from portbench.harness import Check, Outcome
from portbench.reference import ps as ref


def draw_payload(seed: int, j: int, rows: int, sizes: List[int], device
                 ) -> List[torch.Tensor]:
    """Payload ``j``: one (rows, size) uint8 buffer per size, every row
    its own random bytes, from one draw."""
    g = torch.Generator(device=device)
    g.manual_seed(weights.sub_seed(seed, 1000 + j))
    flat = torch.randint(0, 256, (rows * sum(sizes),), generator=g,
                         device=device, dtype=torch.uint8)
    out, off = [], 0
    for s in sizes:
        out.append(flat[off:off + rows * s].view(rows, s))
        off += rows * s
    return out


class StageRecorder:
    """Wraps the round's stages; while ``on`` is a list, each stage's
    output is appended to it (the tensors themselves, no copy)."""

    def __init__(self, channels, ser):
        self.on = None
        self._ser, self._round = ser, channels._Round
        self._saved = (ser.pack, ser.unpack, channels._Round.__call__)
        pack, unpack, call = self._saved
        rec = self

        def pack_(bufs):
            out = pack(bufs)
            if rec.on is not None:
                rec.on.append(("packed", out[0]))
            return out

        def unpack_(packed, meta):
            out = unpack(packed, meta)
            if rec.on is not None:
                rec.on.append(("unpacked", list(out)))
            return out

        def call_(self_, x):
            out = call(self_, x)
            if rec.on is not None:
                rec.on.append(("round", out))
            return out
        ser.pack, ser.unpack, channels._Round.__call__ = pack_, unpack_, \
            call_

    def restore(self):
        self._ser.pack, self._ser.unpack, self._round.__call__ = \
            self._saved


def run(h) -> Outcome:
    from repro_torch.core import channels
    from repro_torch.core import serialization as ser
    mix, dev = h.mix, h.device
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    n_ps, n_w, rows = mix["n_ps"], mix["n_workers"], mix["endpoints"]
    sizes = mix["buffer_bytes"]
    mesh = channels.make_net_mesh(rows, dev)
    fn = channels.ps_round_fn(mesh, len(sizes), n_ps, n_w,
                              serialized=mix["serialized"])
    sets = [draw_payload(h.seed, j, rows, sizes, dev)
            for j in range(mix["input_sets"])]
    for s in sets:
        fn(*s)
    sync()
    rng = traffic.seed_rng(h.seed, 4)
    check_at = set(int(r) for r in rng.choice(
        mix["checked_among_first"], mix["checked_rounds"], replace=False))
    trace = DeviceTrace() if (h.trace and dev == "cuda") else None
    if trace is not None:
        trace.prime()
    tr_rounds = 0
    kept: Dict[int, list] = {}
    rec = StageRecorder(channels, ser)

    t0 = time.perf_counter()
    setup_s = t0 - h.t_start
    tr_on = t0 + 0.3 * h.seconds
    tr_off = tr_on + min(mix["trace_s"], 0.4 * h.seconds)
    r, out = 0, None
    while True:
        now = time.perf_counter()
        if now - t0 >= h.seconds:
            break
        if trace is not None:
            if not trace.active and trace.bounds is None and now >= tr_on:
                tr_off = trace.start() + (tr_off - tr_on)
                r_on = r
            elif trace.active and now >= tr_off:
                trace.stop()
                tr_rounds = r - r_on
        rec.on = kept.setdefault(r, []) if r in check_at else None
        out = fn(*sets[r % len(sets)])
        r += 1
    rec.on = kept.setdefault(r, [])
    fn(*sets[r % len(sets)])          # the last round, recorded
    r += 1
    rec.on = None
    sync()
    elapsed = time.perf_counter() - t0
    if trace is not None and trace.active:
        trace.stop()
        tr_rounds = r - r_on
    rec.restore()
    rpcs = channels.rpcs_per_round(n_ps, n_w)
    notes = [f"{r} rounds of {rpcs} RPCs in {elapsed:.6f} s; "
             f"{rows} rows of {sum(sizes)} B, setup {setup_s:.3f} s"]
    records = {"trace": trace, "trace_rounds": tr_rounds, "rows": rows,
               "sizes": sizes}
    state = {"fn": fn}

    def release():
        state.clear()

    serialized = mix["serialized"]

    def verify() -> List[Check]:
        bad = 0
        for k, got in sorted(kept.items()):
            want = ref.stages(sets[k % len(sets)], n_ps, n_w, serialized)
            bad += ref.mismatched(got, want)
        notes.append(f"compared every stage of rounds {sorted(kept)}")
        return [Check("mismatched_bytes", float(bad), 0.0)]

    def control(variant: str = "fp8") -> List[Check]:
        """The reference delivering through float8 in the program's
        place, against the exact reference."""
        bad = 0
        for k in sorted(kept):
            x = sets[k % len(sets)]
            bad += ref.mismatched(
                ref.stages(x, n_ps, n_w, serialized, control=True),
                ref.stages(x, n_ps, n_w, serialized))
        return [Check("mismatched_bytes", float(bad), 0.0)]

    return Outcome(attempted=r, failed=0,
                   metrics={"rpcs_per_s": r * rpcs / elapsed,
                            "setup_s": setup_s},
                   records=records, notes=notes, release=release,
                   verify=verify, control=control)
