"""chip_smoke.py and bench.py: refusal without a GPU, and the smoke phases
at tiny sizes on the CPU backend (the same code the card runs at the
published code lengths)."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd, pythonpath):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=pythonpath)
    return subprocess.run([sys.executable, script], capture_output=True, text=True,
                          cwd=cwd, env=env, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_points_refuse_without_gpu(script):
    r = _run(script, REPO, REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert r.stdout.strip() == ""  # no phase line, no JSON line
    assert "GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the repository, the script cannot pass."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run("chip_smoke.py", str(tmp_path), "")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_binomial_agreement():
    assert chip_smoke.binomial_agree(0, 4096, 0, 64)
    assert chip_smoke.binomial_agree(2048, 4096, 30, 64)
    assert not chip_smoke.binomial_agree(0, 4096, 3, 64)
    assert not chip_smoke.binomial_agree(400, 4096, 40, 64)


def test_fer_phase_tiny():
    out = chip_smoke.phase_fer(n=257, weight=5, batch=64, exact_frames=4,
                               near_rate=0.06, near_frames=16, windows=2)
    assert out["exact_frames_equal"] == 4
    assert out["frames_per_s"] > 0
    assert 0.0 <= out["fer_device@0.06"] <= 1.0


def test_fer_large_phase_tiny():
    out = chip_smoke.phase_fer_large(n=300, weight=7, batch=32)
    assert out["batch"] == 32  # no device memory limit on the CPU backend
    assert out["temp_bytes"] > 0
    assert out["success"] == 1.0


def test_kyber_phase_tiny():
    out = chip_smoke.phase_kyber(batch=4, compare_batch=3, kyber_runs=0, windows=2)
    assert out["cpu_backend_equal"] == "3+3"


def test_four_cards_phase_on_virtual_devices():
    assert len(jax.devices()) >= 4
    out = chip_smoke.phase_four_cards(n=257, weight=5, batch=64,
                                      attack_oracle_calls=2500)
    assert out["sharded_rounds_bitwise_equal"] > 0
    assert out["successes@0.01"] > out["successes@0.045"]
