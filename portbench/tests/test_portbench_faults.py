"""A run with the timed path broken underneath comes out not correct,
once for each fault a sweep cell can have; a sound run comes out
correct. The runs skip run.py's look for a card and drive the rest of
a run on the CPU (the kernels' plain versions), at a small size."""

import pytest
import torch

from guard_tpu_torch.commands.sweep import Sweep
from guard_tpu_torch.parallel.device import DeviceBatchEvaluator
from portbench.harness import bench
from portbench.tests.conftest import load_cell, tiny

SEED = 3_000_000_019


def run_cell(tmp_path, seconds=0.5):
    spec = tiny(load_cell())
    return bench.run(spec, SEED, seconds, False, "cpu", workdir_root=str(tmp_path))


def test_a_sound_run_is_correct(tmp_path):
    out = run_cell(tmp_path)
    assert out["correct"] is True
    assert all(c["value"] == 0 for c in out["check"].values())
    assert out["attempted"] >= 600 and out["failed"] == 0
    assert list(out)[-2:] == ["check", "_found"]


def patch_statuses(monkeypatch, change):
    """Every walk's (D, R) statuses changed where the walk produces them,
    before K3 or the tally reads them."""
    original = DeviceBatchEvaluator._walk

    def walk(self, batch):
        statuses, unsure = original(self, batch)
        return change(statuses.clone()), unsure

    monkeypatch.setattr(DeviceBatchEvaluator, "_walk", walk)


def test_a_walk_that_returns_its_state_unchanged_is_caught(tmp_path, monkeypatch):
    # every status left at SKIP (2), as a walk that never ran
    patch_statuses(monkeypatch, lambda s: torch.full_like(s, 2))
    out = run_cell(tmp_path)
    assert out["correct"] is False
    assert out["check"]["doc_mismatches"]["value"] > 0


def test_half_of_the_batch_left_out_is_caught(tmp_path, monkeypatch):
    original = Sweep._merge_outcomes

    def merge(self, data_files, *args):
        out = original(self, data_files, *args)
        half = len(out) // 2
        return out[:half] + [None] * (len(out) - half)

    monkeypatch.setattr(Sweep, "_merge_outcomes", merge)
    out = run_cell(tmp_path)
    assert out["correct"] is False
    assert out["check"]["count_mismatches"]["value"] > 0


def test_an_answer_altered_where_it_is_produced_is_caught(tmp_path, monkeypatch):
    def one_document_passes(s):
        s[0, :] = 0
        return s

    patch_statuses(monkeypatch, one_document_passes)
    out = run_cell(tmp_path)
    assert out["correct"] is False
    # the first document of each bucket a walk runs
    assert 1 <= out["check"]["doc_mismatches"]["value"] <= 16
