"""CLI command-surface smoke tests (reference: main.py commands)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(*args, timeout=240):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + ":" + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');"
         "import sys; sys.argv = ['main'] + %r;"
         "from sca_ldpc_tpu.cli.main import main; main()" % (list(args),)],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO,
    )


def test_unknown_command_fails():
    r = run_cli("not_a_command")
    assert r.returncode == 1


def test_official_example():
    r = run_cli("official_example", "--seed", "0", "--runs", "10", "--error-rate", "0.05")
    assert r.returncode == 0
    assert "Success ratio 10/10" in r.stderr + r.stdout


def test_compute_bound():
    r = run_cli("compute_bound", "--error-rate", "0.11")
    assert r.returncode == 0
    out = r.stderr + r.stdout
    assert "C, where R = " in out


def test_regular_ldpc_code():
    r = run_cli("regular_ldpc_code", "--seed", "0", "--runs", "5", "--error-rate", "0.01")
    assert r.returncode == 0
    assert "Success ratio" in r.stderr + r.stdout


def test_view_hqc_oracle_accuracy():
    png = os.path.join(REPO, "OracleAccuracy.png")
    try:
        r = run_cli("view_hqc_oracle_accuracy")
        assert r.returncode == 0
        assert os.path.exists(png)
    finally:
        if os.path.exists(png):
            os.remove(png)


def test_persistent_compilation_cache_util(tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, the cache uses it and sets no
    other directory."""
    import jax

    from sca_ldpc_tpu.utils import enable_persistent_compilation_cache

    prev = jax.config.jax_compilation_cache_dir
    sentinel = str(tmp_path / "set-by-jax")
    try:
        jax.config.update("jax_compilation_cache_dir", sentinel)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
        assert enable_persistent_compilation_cache() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == sentinel
        assert not os.path.exists(tmp_path / "c")
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_hqc_simulate_bounded(tmp_path):
    """Full hqc_simulate argv plumbing (oracle/decode backends, key file,
    CSV output) on a tiny oracle-call budget."""
    csv = str(tmp_path / "stats.csv")
    key = str(tmp_path / "k.key")
    r = run_cli(
        "hqc_simulate", "--seed", "0", "--key-file", key,
        "--decode-every", "50", "--code-weight", "20",
        "--max-oracle-calls", "300", "--decode-backend", "padded",
        "--csv-output", csv, timeout=420,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stderr + r.stdout
    assert "Oracle-call budget exhausted" in out or "Successfully decoded" in out
    assert os.path.exists(csv)
    with open(csv) as f:
        header = f.readline().strip().split(",")
    for col in ("label", "alg", "weight", "checks", "oracle_calls", "success"):
        assert col in header


def test_kyber_simulate_one_run(tmp_path):
    csv = str(tmp_path / "kyber.csv")
    r = run_cli(
        "kyber_simulate", "--seed", "1", "--runs", "1",
        "--error-rate", "0.005", "--csv-output", csv, timeout=420,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "full recoveries" in (r.stderr + r.stdout)
    assert os.path.exists(csv)


def test_kyber_simulate_adaptive(tmp_path):
    r = run_cli(
        "kyber_simulate", "--seed", "1", "--runs", "1", "--adaptive",
        timeout=420,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "full recoveries" in (r.stderr + r.stdout)


def test_test_rust_package_command():
    """The reference's native-package self-test command (main.py
    test_rust_package): toy q-ary decode through the registry."""
    r = run_cli("test_rust_package", "--seed", "0", timeout=420)
    assert r.returncode == 0, r.stderr[-2000:]


def test_qc_ldpc_code_command():
    r = run_cli("qc_ldpc_code", "--seed", "0", "--runs", "4",
                "--error-rate", "0.01", timeout=420)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Success ratio" in (r.stderr + r.stdout)


def test_hqc_eval_oracle_command(tmp_path):
    """hqc_eval_oracle argv plumbing at tiny scale (2 levels x 2 trials,
    2^6-measurement profile), including the new --decision-rule flag."""
    csv = str(tmp_path / "acc.csv")
    state = str(tmp_path / "state.json")
    key = str(tmp_path / "k.key")
    r = run_cli(
        "hqc_eval_oracle", "--seed", "2", "--key-file", key,
        "--trials", "2", "--max-log2-measurements", "2",
        "--profile-log2", "6", "--state-file", state,
        "--csv-output", csv, "--decision-rule", "expansion",
        timeout=420,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(csv) and os.path.exists(state)
    with open(csv) as f:
        assert f.readline().startswith("measurements,accuracy")
