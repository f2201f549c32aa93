"""Mesh-sharded q-ary and two-alphabet decoding.

The reference's entire q-ary parallelism surface is a host thread pool over
independent ``decoder.min_sum`` calls (decode.py:247-277, GIL released in
pydecoder.rs:55).  Here the same scale axis — independent frames — is a
sharded batch dimension inside one SPMD program:

- :func:`make_sharded_qary_fer_step`: the q-ary FER simulation
  (decode.py:180-286 semantics) with **channel sampling on device** — the
  good/bad symbol distributions are two [Q] rows selected by a Bernoulli
  error mask, so no [B, n, Q] tensor ever crosses the host boundary — and
  globally-reduced statistics (successes, max-corrected / min-failed noisy
  symbol counts).
- :func:`make_sharded_special_decode`: batch-sharded two-alphabet (Kyber)
  decode; many independent posterior sets decode in one device program.

Both shard the batch axis over every mesh axis; XLA inserts the collectives
for the scalar reductions (psum/min/max across devices).
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..channels.llr import probs_to_llr
from ..ops import minplus
from ..ops.qary import QaryDecoder, _qary_min_sum


def qary_channel_rows(b_range):
    """The reference's good/bad per-position symbol distributions
    (decode.py:233-237): near-uniform with the correct (0) symbol boosted
    [good] or the max symbol boosted [bad].  Returns ``(good[Q], bad[Q])``."""
    bb = 2 * b_range + 1
    p_lin = 1.0 / bb
    good = np.full(bb, p_lin, np.float32)
    bad = np.full(bb, p_lin, np.float32)
    good[[b_range, -1]] = [1.75 * p_lin, 0.25 * p_lin]
    bad[[-1, b_range]] = [1.75 * p_lin, 0.25 * p_lin]
    return good, bad


def make_sharded_qary_fer_step(decoder: QaryDecoder, error_rate, mesh,
                               redraw_rounds=8):
    """Build a jitted sharded q-ary FER step.

    Returns ``step(key, batch) -> (successes, max_errs_success,
    min_errs_fail, frames)`` where ``batch`` frames are sampled, decoded and
    compared entirely on device, sharded over the mesh.  ``min_errs_fail``
    is ``batch`` (an impossible count, > any real frame) when no frame
    failed; ``max_errs_success`` is 0 when none succeeded.

    Frames with zero noisy symbols are redrawn in-jit (``redraw_rounds``
    fresh Bernoulli draws; the reference re-samples on host,
    decode.py:258-259 — after 8 rounds the residual probability of an
    all-clean frame is (1-p)^(8n), negligible at any simulated rate).
    """
    n = decoder.layout.n
    b = decoder.b
    good, bad = qary_channel_rows(b)
    llr_good = minplus.clip_inf(probs_to_llr(jnp.asarray(good[None])))[0]
    llr_bad = minplus.clip_inf(probs_to_llr(jnp.asarray(bad[None])))[0]
    batch_sharding = NamedSharding(mesh, P(("data", "model")))
    rate = float(error_rate)
    args = decoder._args
    max_iter = decoder.max_iter
    dc = decoder.layout.dc

    def step(key, batch):
        kmask, kdecode = jax.random.split(key)

        def redraw(i, state):
            mask, k = state
            k, sub = jax.random.split(k)
            fresh = jax.random.bernoulli(sub, rate, (batch, n))
            empty = ~jnp.any(mask, axis=1, keepdims=True)
            return jnp.where(empty, fresh, mask), k

        mask = jax.random.bernoulli(kmask, rate, (batch, n))
        mask, _ = jax.lax.fori_loop(0, redraw_rounds, redraw, (mask, kdecode))
        mask = jax.lax.with_sharding_constraint(mask, batch_sharding)

        llr = jnp.where(mask[:, :, None], llr_bad[None, None, :],
                        llr_good[None, None, :])
        hard = _qary_min_sum(*args, llr, max_iter, b, dc, early_exit=False)
        ok = jnp.all(hard == 0, axis=-1)
        errs = jnp.sum(mask, axis=-1).astype(jnp.int32)
        successes = jnp.sum(ok)
        max_errs_success = jnp.max(jnp.where(ok, errs, 0))
        min_errs_fail = jnp.min(jnp.where(ok, batch, errs))
        return successes, max_errs_success, min_errs_fail, batch

    return jax.jit(step, static_argnames=("batch",))


def sharded_qary_fer_simulation(decoder, error_rate, runs, key, mesh,
                                batch=None):
    """Run ``runs`` q-ary frames in sharded batches.

    Returns ``(successes, max_errs_success, min_errs_fail, frames)`` with
    the reference's None convention for min_errs_fail when nothing failed.
    """
    n_dev = mesh.devices.size
    if batch is None:
        batch = min(max(runs, n_dev), 64 * n_dev)
    batch = max(n_dev, (batch // n_dev) * n_dev)
    step = make_sharded_qary_fer_step(decoder, error_rate, mesh)
    successes = 0
    max_ok = 0
    min_fail = None
    done = 0
    while done < runs:
        cur = min(batch, max(n_dev, runs - done))
        cur = max(n_dev, (cur // n_dev) * n_dev)
        key, sub = jax.random.split(key)
        s, mx, mn, frames = step(sub, cur)
        successes += int(s)
        max_ok = max(max_ok, int(mx))
        if int(mn) < int(frames):
            min_fail = int(mn) if min_fail is None else min(min_fail, int(mn))
        done += cur
    return successes, max_ok, min_fail, done


def make_sharded_special_decode(decoder, mesh):
    """Batch-sharded two-alphabet (Kyber) decode.

    Returns ``decode(channel_probs [I, N-R, 2B+1], channel_probs_sum
    [I, R, 2BSUM+1]) -> hard [I, N]`` with the instance axis sharded over
    the mesh — many independent Kyber posterior sets decode in one device
    program (the reference's ThreadPoolExecutor surface, decode.py:247-277).
    """
    batch_sharding = NamedSharding(mesh, P(("data", "model")))

    def decode(p_b, p_s):
        p_b = jax.lax.with_sharding_constraint(
            jnp.asarray(p_b, jnp.float32), batch_sharding)
        p_s = jax.lax.with_sharding_constraint(
            jnp.asarray(p_s, jnp.float32), batch_sharding)
        return decoder.min_sum(p_b, p_s)

    return jax.jit(decode)
