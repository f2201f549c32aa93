"""Sweep-driver orchestration: resume markers, stale-row dropping, seeding.

Reference: run-parallel-hqc-simulation.sh (one process per config, log-file
resume).  The attack itself is stubbed — these test the driver, not the
attack (tests/test_hqc_attack.py covers that).
"""

import csv
import importlib.util
import os
import sys


def _load_sweep_module():
    path = os.path.join(os.path.dirname(__file__), "..", "scripts", "sweep_hqc.py")
    spec = importlib.util.spec_from_file_location("sweep_hqc", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


class _FakeTracking:
    def __init__(self, label_seed):
        self.num_oracle_calls = 1000 + label_seed % 97

    def append_stats_csv(self, path, label=""):
        from sca_ldpc_tpu.models.hqc.tracking import STATS_COLUMNS
        from sca_ldpc_tpu.utils.csvio import append_csv_rows

        row = {"label": label, "alg": "hqc-128", "weight": self._weight,
               "epsilon0": 0.9942, "epsilon1": 1.0, "checks": 100,
               "oracle_calls": self.num_oracle_calls, "unsatisfied": 0,
               "good_flips": 0, "bad_flips": 0,
               "found_bad_satisfied_checks": 0,
               "found_bad_unsatisfied_checks": 0, "success": True}
        append_csv_rows(path, [row], STATS_COLUMNS)


def _run_sweep(tmp_path, monkeypatch, labels, calls_log):
    import sca_ldpc_tpu.models.hqc as hqc_pkg

    sweep = _load_sweep_module()
    csv_path = str(tmp_path / "sweep.csv")

    def fake_attack(rng, decode_every, weight, keyfile, error_rate, param_set,
                    max_oracle_calls=None, oracle_backend="fast",
                    decode_backend="general"):
        seed = rng.randint(2**31)
        calls_log.append((weight, seed))
        tr = _FakeTracking(seed)
        tr._weight = weight
        return True, tr

    monkeypatch.setattr(hqc_pkg, "simulate_hqc_idealized_oracle", fake_attack)
    monkeypatch.setattr(
        sys, "argv",
        ["sweep_hqc.py", "--csv", csv_path, "--param-set", "128",
         "--weights", "20", "30", "--labels", *labels, "--platform", "cpu"],
    )
    sweep.main()
    return csv_path


def test_sweep_runs_all_and_resumes(tmp_path, monkeypatch):
    calls = []
    csv_path = _run_sweep(tmp_path, monkeypatch, ["a", "b"], calls)
    assert len(calls) == 4  # 2 labels x 2 weights
    rows = _read_csv(csv_path)
    assert len(rows) == 4
    assert sorted(r["label"] for r in rows) == ["a", "a", "b", "b"]
    markers = sorted(os.listdir(csv_path + ".state"))
    assert markers == ["128-a-w20.done", "128-a-w30.done",
                       "128-b-w20.done", "128-b-w30.done"]

    # Re-run: every config has a marker, nothing executes, CSV unchanged.
    calls2 = []
    _run_sweep(tmp_path, monkeypatch, ["a", "b"], calls2)
    assert calls2 == []
    assert len(_read_csv(csv_path)) == 4

    # Seeding is config-content-derived (crc32), not order-derived: the same
    # (label, weight) gets the same seed in any sweep composition.
    calls3 = []
    _run_sweep(tmp_path, monkeypatch, ["c", "a"], calls3)
    assert len(calls3) == 2  # only label c runs
    calls4 = []
    os.remove(os.path.join(csv_path + ".state", "128-a-w20.done"))
    _run_sweep(tmp_path, monkeypatch, ["a"], calls4)
    assert len(calls4) == 1
    assert calls4[0] == calls[0]  # (a, w20) reproduces its original seed


def test_sweep_drops_stale_rows_on_rerun(tmp_path, monkeypatch):
    """A crash between CSV append and marker write must not double-count: the
    re-run drops the config's partial rows before re-appending."""
    calls = []
    csv_path = _run_sweep(tmp_path, monkeypatch, ["a"], calls)
    assert len(_read_csv(csv_path)) == 2

    # Simulate the crash: marker for (a, w20) missing but rows present.
    os.remove(os.path.join(csv_path + ".state", "128-a-w20.done"))
    calls2 = []
    _run_sweep(tmp_path, monkeypatch, ["a"], calls2)
    assert len(calls2) == 1
    rows = _read_csv(csv_path)
    assert len(rows) == 2  # still one row per config, not three
    assert sorted(int(r["weight"]) for r in rows) == [20, 30]
