"""Monte-Carlo frame-error-rate simulation, batched on device.

Reference semantics: decode.py:130-177 (binary, one frame per Python-loop
iteration through ldpc.bp_decoder) and decode.py:180-286 (q-ary, all-zero
codeword with noisy symbol distributions, one Rust decode per thread-pool
task).  Here the whole run is a few jitted batch steps: sample a ``[B, n]``
error tensor, compute all syndromes at once, decode the batch, compare.

The thread pool of the reference is replaced by the batch axis; the
``--threads`` knob maps to batch size.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np

from ..channels.errors import ErrorsProvider
from ..codes.layout import CodeLayout
from ..ops.binary_bp import BinaryBPDecoder
from ..ops.qary import QaryDecoder
from ..utils import make_random_state, rng_to_jax_key

logger = logging.getLogger(__name__)


def _syndromes(layout: CodeLayout, errors):
    """[B, n] int errors -> [B, R] syndromes via the padded layout."""
    b = errors.shape[0]
    e_pad = jnp.concatenate([errors, jnp.zeros((b, 1), errors.dtype)], axis=-1)
    bits = jnp.take(e_pad, jnp.asarray(layout.chk_var).reshape(-1), axis=-1)
    bits = bits.reshape(b, layout.r, layout.dc)
    return jnp.sum(jnp.where(jnp.asarray(layout.chk_mask), bits, 0), axis=-1) % 2


def simulate_frame_error_rate(
    H,
    errors_provider: ErrorsProvider,
    runs: int,
    rng,
    max_iter=None,
    method="product_sum",
    batch_size=None,
):
    """Count successful decodings over ``runs`` random frames.

    API-compatible with decode.py:130-177; ``max_iter`` defaults to n like the
    reference's ``bp_decoder(..., max_iter=n)``.  Sampling happens on device
    (statistically identical to the host loop; the reference's per-position
    RNG stream is not replayed bit-for-bit — conformance is at the FER level).
    """
    H = np.asarray(H)
    n = H.shape[1]
    rng = make_random_state(rng)
    max_iter = int(max_iter if max_iter is not None else n)

    channel_probs = errors_provider.get_binary_channel_probs(n)
    if channel_probs == [None]:
        channel_probs = np.full(n, errors_provider.get_error_rate(), dtype=np.float32)
    else:
        channel_probs = np.asarray(channel_probs, dtype=np.float32)

    decoder = BinaryBPDecoder(H, max_iter=max_iter, method=method, channel_probs=channel_probs)
    layout = decoder.layout

    batch = int(batch_size or min(runs, 1024))
    successes = 0
    done = 0
    while done < runs:
        cur = min(batch, runs - done)
        key = rng_to_jax_key(rng)
        errors = errors_provider.sample_batch(key, cur, n).astype(jnp.int32)
        syn = _syndromes(layout, errors)
        decoded = decoder.decode_syndrome(syn)
        ok = jnp.all(decoded == errors, axis=-1)
        successes += int(jnp.sum(ok))
        done += cur
    return successes


def simulate_frame_error_rate_qary(
    H,
    b_range,
    error_rate,
    runs,
    rng,
    iterations=5,
    batch_size=None,
    host_sampling=False,
    early_exit=False,
):
    """Q-ary FER on the all-zero codeword with good/bad symbol distributions.

    Mirrors decode.py:180-286: every position gets the near-uniform "good"
    distribution (correct symbol boosted) or, with probability ``error_rate``,
    the "bad" one (max symbol boosted); frames with zero noisy symbols are
    resampled.  Returns ``(successes, max_errs_success, min_errs_fail)``.

    ``host_sampling=True`` replays the reference's exact per-position
    ``rng.rand()`` stream (decode.py:250-259) so fixed seeds reproduce its
    frames bit-for-bit; the default samples on device (statistically
    identical, much faster at scale).
    """
    H = np.asarray(H)
    n = H.shape[1]
    rng = make_random_state(rng)
    bb = 2 * b_range + 1

    p_lin = 1.0 / bb
    good = np.full(bb, p_lin, np.float32)
    bad = np.full(bb, p_lin, np.float32)
    good[[b_range, -1]] = [1.75 * p_lin, 0.25 * p_lin]
    bad[[-1, b_range]] = [1.75 * p_lin, 0.25 * p_lin]

    decoder = QaryDecoder(H.astype(np.int8), b_range, iterations,
                          early_exit=early_exit)

    batch = int(batch_size or min(runs, 256))
    successes = 0
    max_errs_success = 0
    min_errs_fail = None
    done = 0
    while done < runs:
        cur = min(batch, runs - done)
        # Bernoulli error mask per position; resample frames with no errors
        # like the reference (decode.py:258-259).
        if host_sampling:
            mask = np.zeros((cur, n), dtype=bool)
            for f in range(cur):
                while True:
                    row = np.array([rng.rand() < error_rate for _ in range(n)])
                    if row.any():
                        mask[f] = row
                        break
        else:
            key = rng_to_jax_key(rng)
            mask = np.array(jax.random.bernoulli(key, error_rate, (cur, n)))
            empty = ~mask.any(axis=1)
            while empty.any():
                key = rng_to_jax_key(rng)
                redo = np.asarray(
                    jax.random.bernoulli(key, error_rate, (int(empty.sum()), n))
                )
                mask[empty] = redo
                empty = ~mask.any(axis=1)
        errs = mask.sum(axis=1)

        # Build the [B, n, Q] channel tensor ON DEVICE from the [B, n] mask
        # and the two [Q] distribution rows — only the bool mask crosses the
        # host boundary (the round-1 version assembled and shipped the full
        # f32 tensor every batch).
        channel = jnp.where(
            jnp.asarray(mask)[:, :, None],
            jnp.asarray(bad)[None, None, :],
            jnp.asarray(good)[None, None, :],
        )
        decoded = np.asarray(decoder.min_sum(channel))
        ok = (decoded == 0).all(axis=1)
        successes += int(ok.sum())
        if ok.any():
            max_errs_success = max(max_errs_success, int(errs[ok].max()))
        if (~ok).any():
            worst = int(errs[~ok].min())
            min_errs_fail = worst if min_errs_fail is None else min(min_errs_fail, worst)
        done += cur

    logger.info(f"Highest number of noisy symbols corrected, per frame: {max_errs_success}")
    logger.info(f"Lowest number of noisy symbols that failed correction: {min_errs_fail}")
    return successes, max_errs_success, min_errs_fail
