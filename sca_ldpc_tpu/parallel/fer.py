"""Mesh-sharded frame-error-rate simulation.

One jitted SPMD step: per-shard error sampling -> syndromes -> batched BP
decode -> frame-exact comparison -> globally reduced statistics.  The batch
axis is sharded over the mesh's 'data' axis; XLA inserts the psum-style
collectives for the scalar reductions (SURVEY §2.3's replacement for the
reference's thread pool + CSV merging).
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..codes.layout import CirculantLayout, CodeLayout
from ..ops.binary_bp import _bp_decode_syndrome
from ..ops.circulant_bp import _circulant_bp


def _prior_llr(probs):
    p = jnp.clip(probs, 1e-30, 1 - 1e-12)
    return jnp.log((1.0 - p) / p)


def sample_frame_errors(key, probs, batch):
    """The FER step's error draw: ``[batch, len(probs)]`` int32 Bernoulli
    bits.  Exposed so a check can rebuild the exact frames a step decoded."""
    return jax.random.bernoulli(key, probs[None, :], (batch, probs.shape[0])).astype(jnp.int32)


def circulant_syndrome_decode(layout: CirculantLayout, prior, errors, max_iter, method):
    """Syndromes of ``errors`` ([B, n_vars]) under ``layout`` and their BP
    decode with per-position prior LLRs ``prior`` ([n_vars]).

    Returns ``(e_hat [B, n_vars] int32, converged [B], iterations)``.
    """
    n = layout.n
    batch = errors.shape[0]
    e_c, e_i = errors[:, :n], errors[:, n:]
    syn = sum(jnp.roll(e_c, k, axis=-1) for k in layout.shifts)
    if layout.with_identity:
        syn = syn + e_i
    syn = syn % 2
    pc = jnp.broadcast_to(prior[:n], (batch, n))
    if layout.with_identity:
        pi = jnp.broadcast_to(prior[n:], (batch, n))
    else:
        pi = jnp.zeros((batch, n))
    return _circulant_bp(pc, pi, syn, layout.shifts, layout.with_identity, max_iter, method)


def make_sharded_fer_step(layout, channel_probs, mesh, max_iter=50, method="product_sum"):
    """Build a jitted sharded step: (key, batch) -> (successes, converged, iters).

    ``layout``: CodeLayout or CirculantLayout.  ``channel_probs``: [n] error
    probabilities.  The returned callable samples its own errors on device
    from the given key (sharded), so no host->device transfer scales with
    batch.
    """
    probs = jnp.asarray(np.asarray(channel_probs, np.float32))
    batch_sharding = NamedSharding(mesh, P(("data", "model")))

    if isinstance(layout, CirculantLayout):
        prior = _prior_llr(probs)

        def step(key, batch):
            errors = sample_frame_errors(key, probs, batch)
            errors = jax.lax.with_sharding_constraint(errors, batch_sharding)
            e_hat, conv, it = circulant_syndrome_decode(layout, prior, errors, max_iter, method)
            ok = jnp.all(e_hat == errors, axis=-1)
            return jnp.sum(ok), jnp.sum(conv), it

    else:
        lay: CodeLayout = layout
        chk_var = jnp.asarray(lay.chk_var)
        chk_mask = jnp.asarray(lay.chk_mask)
        var_flat = jnp.asarray(lay.var_flat)
        var_mask = jnp.asarray(lay.var_mask)
        prior = _prior_llr(probs)

        def step(key, batch):
            errors = sample_frame_errors(key, probs, batch)
            errors = jax.lax.with_sharding_constraint(errors, batch_sharding)
            e_pad = jnp.concatenate([errors, jnp.zeros((batch, 1), jnp.int32)], axis=-1)
            bits = jnp.take(e_pad, chk_var.reshape(-1), axis=-1).reshape(batch, lay.r, lay.dc)
            syn = jnp.sum(jnp.where(chk_mask, bits, 0), axis=-1) % 2
            e_hat, conv, it = _bp_decode_syndrome(
                chk_var, chk_mask, var_flat, var_mask, prior, syn, max_iter, method, lay.dc
            )
            ok = jnp.all(e_hat == errors, axis=-1)
            return jnp.sum(ok), jnp.sum(conv), it

    return jax.jit(step, static_argnames=("batch",))


def sharded_fer_simulation(layout, channel_probs, runs, key, mesh, batch=None, max_iter=50, method="product_sum"):
    """Run ``runs`` frames in sharded batches; returns (successes, frames)."""
    gran = mesh.devices.size
    if batch is None:
        batch = min(max(runs, gran), 256 * gran)
    batch = max(gran, (batch // gran) * gran)
    step = make_sharded_fer_step(layout, channel_probs, mesh, max_iter, method)
    successes = 0
    done = 0
    while done < runs:
        cur = min(batch, max(gran, runs - done))
        cur = max(gran, (cur // gran) * gran)
        key, sub = jax.random.split(key)
        ok, _conv, _it = step(sub, cur)
        successes += int(ok)
        done += cur
    return successes, done
