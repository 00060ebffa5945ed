"""``correct`` comes out false when the timed path is broken underneath
(the harness's look for a chip skipped, everything else as in a run),
once for each fault the cells can have, and when the control (the
reference in the precision below the configuration's) stands in the
program's place."""
import pytest
import torch

from conftest import SERVE_CELLS, TINY_GAP_LIMIT, run_tiny


def _broken_decode(monkeypatch, fault):
    from repro_torch.serve.engine import ServeEngine
    decode = ServeEngine.scheduler_decode

    def broken(self, req):
        before = req.runtime
        tok = decode(self, req)
        if fault == "token" and len(req.tokens) == 1:
            tok = (tok + 1) % self.acfg.model.vocab_size
            states, t, key = req.runtime
            req.runtime = (states, torch.as_tensor(tok).to(t), key)
        elif fault == "state":
            states = before[0]
            _, t, key = req.runtime
            req.runtime = (states, t, key)
        return tok
    monkeypatch.setattr(ServeEngine, "scheduler_decode", broken)


#: the closed-loop cells, as the benchmark's serve cells run
DRAINED = SERVE_CELLS[:2]


@pytest.mark.parametrize("fault", ["token", "state"])
@pytest.mark.parametrize("cell", DRAINED)
def test_serve_fault_is_not_correct(tiny_dir, monkeypatch, cell, fault):
    """A token altered where it is produced; a decode step that returns
    its state unchanged (the recurrent state, or the cache's cursor)."""
    _broken_decode(monkeypatch, fault)
    result, checks, _ = run_tiny(tiny_dir, cell, seed=21)
    assert not result["correct"]
    gap = result["compared"]["max_logit_gap"]
    assert gap["value"] > gap["limit"]


@pytest.mark.parametrize("cell", DRAINED)
def test_serve_control_is_not_correct(tiny_dir, cell):
    """float8 in the program's place: the tokens it puts first lie below
    the reference's best by more than the limit."""
    from portbench import harness
    h = harness.Harness(cell, 23, 2.0, False, device="cpu",
                        data_dir=tiny_dir)
    result, _, _ = harness.run_cell(h, control=["fp8"])
    assert result["correct"]
    assert result["control"]["fp8"]["max_logit_gap"]["value"] > TINY_GAP_LIMIT


def _broken_round(monkeypatch, fault):
    """``answer``: K2 hands back one byte altered; ``half``: K1 packs
    only the first half of the endpoints' rows."""
    from repro_torch.core import serialization as ser
    pack, unpack = ser.pack, ser.unpack

    def pack_half(bufs):
        packed, meta = pack(bufs)
        packed = packed.clone()
        packed[packed.shape[0] // 2:] = 0
        return packed, meta

    def unpack_altered(packed, meta):
        out = [b.clone() for b in unpack(packed, meta)]
        out[2][3, 5] ^= 1
        return out
    if fault == "answer":
        monkeypatch.setattr(ser, "unpack", unpack_altered)
    else:
        monkeypatch.setattr(ser, "pack", pack_half)


@pytest.mark.parametrize("fault", ["answer", "half"])
def test_ps_fault_is_not_correct(tiny_dir, monkeypatch, fault):
    _broken_round(monkeypatch, fault)
    result, _, _ = run_tiny(tiny_dir, "tiny-ps", seed=31, seconds=0.5)
    assert not result["correct"]
    assert result["compared"]["mismatched_bytes"]["value"] > 0


def test_ps_control_is_not_correct(tiny_dir):
    from portbench import harness
    h = harness.Harness("tiny-ps", 33, 0.5, False, device="cpu",
                        data_dir=tiny_dir)
    result, _, _ = harness.run_cell(h, control=["fp8"])
    assert result["correct"]
    assert result["control"]["fp8"]["mismatched_bytes"]["value"] > 0


def _broken_train(monkeypatch, fault):
    from repro_torch.launch import steps
    make = steps.make_train_step

    def make_broken(*a, **kw):
        step = make(*a, **kw)

        def broken(params, opt, batch):
            if fault == "half":          # the mean over half the rows
                half = batch["tokens"].shape[0] // 2
                return step(params, opt, {k: v[:half]
                                          for k, v in batch.items()})
            _, _, metrics = step(params, opt, batch)
            return params, opt, metrics  # the state left unchanged
        return broken
    monkeypatch.setattr(steps, "make_train_step", make_broken)


@pytest.mark.parametrize("fault", ["state", "half"])
def test_train_fault_is_not_correct(tiny_dir, monkeypatch, fault):
    _broken_train(monkeypatch, fault)
    result, checks, _ = run_tiny(tiny_dir, "tiny-train", seed=41,
                                 seconds=0.3)
    assert not result["correct"]
    failed = {c.name for c in checks if not c.ok}
    assert failed
    if fault == "state":      # reads 1: nothing moved
        assert result["compared"]["change_norm_gap"]["value"] == \
            pytest.approx(1.0)


def test_train_control_is_not_correct(tiny_dir):
    from portbench import harness
    h = harness.Harness("tiny-train", 43, 0.3, False, device="cpu",
                        data_dir=tiny_dir)
    result, _, _ = harness.run_cell(h, control=["fp8"])
    assert result["correct"]
    ctl = result["control"]["fp8"]
    assert any(v["value"] > v["limit"] for v in ctl.values())
