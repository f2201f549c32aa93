"""The XLA circulant decoder and the FER step against the NumPy reference.

The reference is bench.cpu_reference_decode (float64, one frame at a time);
the decoder under test is the rolled-plane XLA path (ops/circulant_bp.py)
that every FER cell and the attack's circulant decode run.  Far below the
decoding threshold both converge to the same error vector, so hard
decisions are compared exactly.
"""

import jax
import numpy as np
import pytest

from bench import build_code, circulant_syndrome, cpu_reference_decode
from sca_ldpc_tpu.parallel.fer import make_sharded_fer_step, sample_frame_errors
from sca_ldpc_tpu.parallel.mesh import make_mesh
from sca_ldpc_tpu.ops.circulant_bp import _circulant_bp

RATE = 0.02
MAX_ITER = 30


def _reference(lay, errors):
    prior = np.full(lay.n_vars, np.log((1 - RATE) / RATE))
    return np.stack([
        cpu_reference_decode(lay, prior, circulant_syndrome(lay, e), MAX_ITER)[0]
        for e in errors
    ])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n", [128, 150, 257])
def test_circulant_bp_matches_numpy_reference(n, seed):
    lay = build_code(seed=seed, n=n, weight=5)
    rng = np.random.RandomState(seed)
    errors = (rng.rand(6, lay.n_vars) < RATE).astype(np.int32)
    syn = np.stack([circulant_syndrome(lay, e) for e in errors])
    prior = np.full((6, n), np.log((1 - RATE) / RATE), np.float32)
    e_hat, _conv, _it = _circulant_bp(prior, prior, syn, lay.shifts, True,
                                      MAX_ITER, "product_sum")
    np.testing.assert_array_equal(np.asarray(e_hat), _reference(lay, errors))


def test_fer_step_success_count_matches_numpy_reference():
    """The sharded FER step's success count equals the NumPy reference's on
    the errors the step itself drew (rebuilt with sample_frame_errors)."""
    lay = build_code(seed=2, n=257, weight=5)
    probs = np.full(lay.n_vars, 0.04, np.float32)
    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    step = make_sharded_fer_step(lay, probs, mesh, max_iter=MAX_ITER)
    key = jax.random.PRNGKey(5)
    successes, _conv, _it = step(key, 32)
    errors = np.asarray(sample_frame_errors(key, jax.numpy.asarray(probs), 32))
    prior = np.full(lay.n_vars, np.log((1 - 0.04) / 0.04))
    ref_ok = sum(
        (cpu_reference_decode(lay, prior, circulant_syndrome(lay, e), MAX_ITER)[0] == e).all()
        for e in errors
    )
    assert 0 < ref_ok < 32  # the operating point has failures to count
    assert int(successes) == ref_ok
