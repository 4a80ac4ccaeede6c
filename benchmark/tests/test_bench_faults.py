"""A run with its timed path broken underneath comes out not correct.

Each test plants one fault in the program, then drives the rest of a run
(the look for a card skipped; the program's plain versions on the CPU) and
reads ``correct`` false.  The faults a cell of this benchmark can have: a
chunk that leaves the counters unchanged; half of a point's chunks left
out and the counts of the rest doubled; a decision altered where it is
made.  A cell runs on one card, so there is no exchange between cards to
leave out.  On a card, the same three faults planted in the runner's
chunk loop (``readings.FAULTS``) at each cell's own size."""

import json
import os

import pytest
import torch

from conftest import BENCH_DIR, ROOT, run_harness


def test_a_chunk_that_leaves_the_counters_unchanged(capsys, tiny_bench, monkeypatch):
    from ofdm_tpu_torch.ops import link_kernel as lk

    def unchanged(link, key, sym0, chunk, snr_lin, acc, psum, words=None, rows=None, dump=None):
        zero = torch.zeros(link.T, dtype=torch.float32, device=acc.device)
        return zero, zero

    monkeypatch.setattr(lk, "diag_chunk_plain", unchanged)
    rc, out, _ = run_harness(capsys, *tiny_bench)
    assert rc == 0 and out["correct"] is False
    assert out["check"]["bit_gap"]["value"] > out["check"]["bit_gap"]["limit"]


def test_half_of_the_chunks_left_out(capsys, tiny_bench, monkeypatch):
    from ofdm_tpu_torch.pipeline import LinkRunner

    chunks = LinkRunner._chunks

    def half(self, key, chunk, num_chunks, snr_db, snr_lin, rows, acc, psum, collect):
        done = chunks(self, key, chunk, max(1, num_chunks // 2), snr_db, snr_lin, rows, acc, psum, collect)
        acc[:2] *= 2  # the mean of the chunks run, taken for the whole point
        return done

    monkeypatch.setattr(LinkRunner, "_chunks", half)
    rc, out, _ = run_harness(capsys, *tiny_bench, seconds=1.0)
    assert rc == 0 and out["correct"] is False


def test_a_decision_altered_where_it_is_made(capsys, tiny_bench, monkeypatch):
    from ofdm_tpu_torch.ops import link_kernel as lk

    demap = lk.demap

    def altered(er, ei, c):
        rx = demap(er, ei, c)
        rx[..., 0] ^= 1  # subcarrier 0 of every symbol
        return rx

    monkeypatch.setattr(lk, "demap", altered)
    rc, out, _ = run_harness(capsys, *tiny_bench)
    assert rc == 0 and out["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("cell", ["headline_64sc.campaign", "pod_1024sc.campaign", "headline_64sc.short_points"])
def test_faults_fail_at_the_cells_size(cuda_card, cell):
    """Each cell's readings on a card: every seed of every fault fails a limit."""
    import readings

    from harness import check, spec

    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        limits = spec.find_cell(json.load(fh), cell, BENCH_DIR).limits
    argv = ["--workload", cell, "--seeds", "0", "--control-seeds", "0", "--window-points", "64", "--fault-seeds", "3"]
    lines = readings.main(argv + [a for f in sorted(readings.FAULTS) for a in ("--fault", f)])
    faults = [ln for ln in lines if ln.get("side", "").startswith("fault:")]
    assert len(faults) == 3 * len(readings.FAULTS)
    assert all(not check.verdict(ln, limits) for ln in faults)
