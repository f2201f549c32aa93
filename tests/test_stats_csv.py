"""The attack's statistics CSV without pandas: the reference's header, and
rows appended across runs (hqc.py's to_csv(mode="a") layout)."""

import os
import subprocess
import sys

from sca_ldpc_tpu.models.hqc.tracking import (
    STATS_COLUMNS,
    HqcSimulationParams,
    HqcSimulationTracking,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeHqc:
    @staticmethod
    def name():
        return "hqc-128"

    @staticmethod
    def params(what):
        return {"N": 17669, "N1": 46, "N2": 384}[what]


def _tracking(calls, success):
    tr = HqcSimulationTracking(HqcSimulationParams(_FakeHqc, 3, (0.99, 1.0), 50, 20))
    tr.num_oracle_calls = calls
    tr.add_decoder_stats(50, 3, 60, 1, 0, 2, success)
    return tr


def test_stats_csv_header_and_append(tmp_path):
    path = str(tmp_path / "stats.csv")
    _tracking(1200, False).append_stats_csv(path, label="a")
    _tracking(2400, True).append_stats_csv(path, label=None)
    with open(path) as f:
        lines = f.read().split("\n")
    assert lines[0] == ",".join(STATS_COLUMNS)
    assert lines[0] == ("label,alg,weight,epsilon0,epsilon1,checks,oracle_calls,"
                        "unsatisfied,good_flips,bad_flips,found_bad_satisfied_checks,"
                        "found_bad_unsatisfied_checks,success")
    assert lines[1] == "a,hqc-128,20,0.99,1.0,50,1200,3,60,1,0,2,False"
    assert lines[2] == ",hqc-128,20,0.99,1.0,50,2400,3,60,1,0,2,True"
    assert lines[3:] == [""]


def test_main_path_imports_without_pandas():
    code = (
        "import sys; sys.modules['pandas'] = None\n"
        "import sca_ldpc_tpu, sca_ldpc_tpu.models.hqc, sca_ldpc_tpu.models.kyber\n"
        "import sca_ldpc_tpu.cli.main, sca_ldpc_tpu.parallel, sca_ldpc_tpu.sim\n"
        "import bench, chip_smoke\n"
        "sys.path.insert(0, 'scripts'); import sweep_hqc\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
