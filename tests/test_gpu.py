"""Card-only checks: the XLA decoders compiled for an NVIDIA GPU against
the NumPy reference and the CPU backend, at the HQC-128 code length.

Skipped unless JAX's default device is a GPU.  On a GPU machine:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu.py -m gpu
"""

import numpy as np
import pytest

import chip_smoke
from bench import build_code


@pytest.mark.gpu
def test_circulant_decisions_match_numpy_at_hqc128(gpu_device):
    lay = build_code(seed=0, n=17669, weight=20)
    rng = np.random.RandomState(0)
    errors = (rng.rand(4, lay.n_vars) < 0.01).astype(np.int32)
    dev = chip_smoke.device_decisions(lay, 0.01, errors, 30, device=gpu_device)
    ref = chip_smoke.reference_decisions(lay, 0.01, errors, 30)
    np.testing.assert_array_equal(dev, ref)


@pytest.mark.gpu
def test_qary_decoders_match_cpu_backend(gpu_device):
    out = chip_smoke.phase_kyber(batch=256, compare_batch=16, kyber_runs=0, windows=1)
    assert out["cpu_backend_equal"] == "16+16"
