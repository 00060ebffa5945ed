"""Every driver kind end to end on the CPU, on tiny cells that exist
only as data files: the result line's keys, the metrics each cell
reports, and ``correct``."""
import json

import pytest

from conftest import SERVE_CELLS, run_tiny

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("cell", SERVE_CELLS + ("tiny-ps", "tiny-train"))
def test_cell_runs_from_data_files_alone(tiny_dir, cell):
    result, checks, notes = run_tiny(tiny_dir, cell, seed=2**31 + 11)
    assert all(k in result for k in KEYS)
    assert list(result)[-1] == "compared"
    json.dumps(result)
    assert result["correct"], (result, notes)
    assert result["attempted"] > 0 and result["failed"] == 0
    if not cell.endswith(".open"):  # closed loop: clients kept busy
        assert result["attempted"] > 4, notes
    want = {"setup_s"} | {"tiny-ps": {"rpcs_per_s"},
                          "tiny-train": {"train_tok_s"}}.get(
        cell, {"served_tok_s"})
    assert set(result["metrics"]) == want
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert checks and all(c.ok for c in checks)


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_traced_serve_run_reads_its_host_metrics(tiny_dir, cell):
    """On the CPU there is no device trace: the span and counter readers
    report, the device readers return nothing."""
    result, _, _ = run_tiny(tiny_dir, cell, seed=7, trace=True)
    assert result["correct"]
    assert set(result["metrics"]) == {
        "ttft_p90_ms.serve", "tpot_p95_ms.serve",
        "fabric_ms_per_chunk.serve", "admit_wait_p90_ms.serve",
        "decode_op_ms.serve", "prefill_mfu.serve"}


def test_same_seed_same_work(tiny_dir):
    from portbench import harness, traffic
    h = harness.Harness("tiny-moe.serve", 3, 5.0, False, device="cpu",
                        data_dir=tiny_dir)
    a = traffic.serve_requests(h.mix, 4.0, 5.0, 3)
    b = traffic.serve_requests(h.mix, 4.0, 5.0, 3)
    c = traffic.serve_requests(h.mix, 4.0, 5.0, 4)
    assert a == b and a != c
    # another seed: the same sizes and gaps, in another order
    assert sorted((r.prompt_len, r.answer_len) for r in a) == \
        sorted((r.prompt_len, r.answer_len) for r in c)
    assert abs(a[-1].due_s - c[-1].due_s) < 1e-9


def test_closed_loop_sends_cycles_of_the_pool(tiny_dir):
    """Closed loop, every seed sends the same sequence: each cycle is the
    mix's pool of lengths in an order of its own."""
    from portbench import harness, traffic
    mix = harness.Harness("tiny-moe.serve", 3, 5.0, False, device="cpu",
                          data_dir=tiny_dir).mix
    reqs = traffic.closed_requests(mix)
    pool, cycles = mix["arrivals"]["pool"], mix["arrivals"]["cycles"]
    assert len(reqs) == pool * cycles
    key = [(r.prompt_len, r.answer_len) for r in reqs]
    first = sorted(key[:pool])
    assert all(sorted(key[c * pool:(c + 1) * pool]) == first
               for c in range(cycles))
    assert key[:pool] != key[pool:2 * pool]
    assert key == [(r.prompt_len, r.answer_len)
                   for r in traffic.closed_requests(mix)]
