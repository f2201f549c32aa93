"""Binary BP on circulant codes via rolled message planes — the fast path.

For ``H = [circulant(c) | I]`` (the HQC attack code family, make_code.py:220-273)
every nonzero diagonal of the circulant is one ``[batch, N]`` message plane;
check/variable alignment is a static ``jnp.roll`` per plane.  The decoder is
pure elementwise math with zero gathers or scatters.

Bandwidth discipline (this is the headline benchmark kernel):
- the check update reduces across the plane axis in place — no transposes;
- variable->check realignment rolls only the single totals plane:
  ``v2c_new[t] = roll(total, k_t) - c2v[t]`` (the extrinsic subtraction
  commutes with the roll), instead of rolling every plane twice;
- the syndrome convergence check runs in int8.

The identity block's variables have degree 1, so their v2c messages equal
their channel priors, constant across iterations.

This replaces the reference's per-frame sparse CPU decode (ldpc.bp_decoder on
a 17669-to-57637-column matrix, hqc.py:694-708) with a batched,
HBM-bandwidth-bound kernel.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.layout import CirculantLayout
from .binary_bp import _BIG, _phi


def _plane_check_update(planes, sign_syn, method):
    """Extrinsic check->variable messages, reducing across axis 1 (planes).

    planes: [B, P, N] incoming LLRs (check-aligned); sign_syn: [B, N] +-1.
    """
    sgn = jnp.where(planes >= 0, 1.0, -1.0)
    mag = jnp.abs(planes)
    tot_sign = jnp.prod(sgn, axis=1, keepdims=True) * sign_syn[:, None, :]
    ext_sign = tot_sign * sgn

    if method == "product_sum":
        pm = _phi(mag)
        tot = jnp.sum(pm, axis=1, keepdims=True)
        ext_mag = _phi(jnp.maximum(tot - pm, 1e-9))
    elif method == "min_sum":
        min1 = jnp.min(mag, axis=1, keepdims=True)
        is1 = mag == min1
        min2 = jnp.min(jnp.where(is1, jnp.inf, mag), axis=1, keepdims=True)
        cnt = jnp.sum(is1, axis=1, keepdims=True)
        ext_mag = jnp.where(is1 & (cnt == 1), min2, min1)
        from .binary_bp import MIN_SUM_ALPHA
        ext_mag = MIN_SUM_ALPHA * jnp.minimum(ext_mag, _BIG)
    else:
        raise ValueError(f"unknown bp method: {method}")
    return ext_sign * ext_mag


@partial(jax.jit, static_argnames=("shifts", "with_identity", "max_iter", "method"))
def _circulant_bp(
    prior_c,  # [B, N] error-prior LLR of circulant-part variables
    prior_i,  # [B, N] identity-part priors (ignored if not with_identity)
    syndrome,  # [B, N] (R == N for square circulants)
    shifts: tuple,
    with_identity: bool,
    max_iter: int,
    method: str,
):
    b, n = syndrome.shape
    w = len(shifts)
    syndrome8 = syndrome.astype(jnp.int8)
    sign_syn = (1 - 2 * syndrome8).astype(jnp.float32)

    # v2c planes, check-major: plane t, position i = msg from var (i - k_t).
    v2c0 = jnp.stack([jnp.roll(prior_c, k, axis=-1) for k in shifts], axis=1)

    def iterate(v2c):
        if with_identity:
            planes = jnp.concatenate([v2c, prior_i[:, None, :]], axis=1)
        else:
            planes = v2c
        c2v = _plane_check_update(planes, sign_syn, method)  # [B, P, N]
        c2v_c = c2v[:, :w, :]
        # Variable totals: align each plane at its variable index and sum.
        tot_c = prior_c + sum(
            jnp.roll(c2v_c[:, t, :], -k, axis=-1) for t, k in enumerate(shifts)
        )
        # Extrinsic + realign in one roll of the totals plane.
        v2c_new = jnp.stack(
            [jnp.roll(tot_c, k, axis=-1) for k in shifts], axis=1
        ) - c2v_c
        v2c_new = jnp.clip(v2c_new, -_BIG, _BIG)
        tot_i = prior_i + c2v[:, w, :] if with_identity else None
        return v2c_new, tot_c, tot_i

    def syndrome_of(e_c, e_i):
        s = sum(jnp.roll(e_c, k, axis=-1) for k in shifts)
        if with_identity:
            s = s + e_i
        return s % 2

    def body(state):
        it, v2c, e_out_c, e_out_i, conv = state
        v2c_new, tot_c, tot_i = iterate(v2c)
        e_c = (tot_c < 0).astype(jnp.int8)
        e_i = (tot_i < 0).astype(jnp.int8) if with_identity else jnp.zeros_like(e_c)
        ok = jnp.all(syndrome_of(e_c, e_i) == syndrome8, axis=-1)
        e_out_c = jnp.where(conv[:, None], e_out_c, e_c)
        e_out_i = jnp.where(conv[:, None], e_out_i, e_i)
        return it + 1, v2c_new, e_out_c, e_out_i, conv | ok

    def cond(state):
        it, _, _, _, conv = state
        return (it < max_iter) & ~jnp.all(conv)

    e0 = (prior_c < 0).astype(jnp.int8)
    e0i = (prior_i < 0).astype(jnp.int8)
    state = (jnp.int32(0), v2c0, e0, e0i, jnp.zeros((b,), bool))
    it, _, e_c, e_i, conv = jax.lax.while_loop(cond, body, state)
    e = jnp.concatenate([e_c, e_i], axis=-1) if with_identity else e_c
    return e.astype(jnp.int32), conv, it


@partial(jax.jit, static_argnames=("max_iter", "method"))
def _multi_circulant_bp(
    prior_c,  # [B, N] error-prior LLR of the shared circulant-part variables
    prior_i,  # [B, P, N] identity-part priors (LLR 0 rows are inert checks)
    syndrome,  # [B, P, N] one syndrome row set per circulant block
    shifts,  # [P, W] int32 — one circulant's nonzero shifts per block
    max_iter: int,
    method: str,
):
    """BP over ``H = [[C_1];...;[C_P]] | I_{P*N}`` — P stacked circulants
    sharing the same N variables, each row with its own identity column.

    This is the single-compile-shape formulation of the HQC attack decode:
    the full circulant of every plaintext is present, measured rows carry
    their check value in ``syndrome`` and their certainty in ``prior_i``,
    and unmeasured rows are made inert by an exactly-zero identity-prior
    LLR (a parity check with one uniform-prior member conveys no extrinsic
    information).  ``shifts`` is DATA, not a static argument: one compile
    per (N, P, W) serves every circulant of the whole attack or sweep, and the
    function vmaps over instances for cross-attack batching (vs
    hqc.py:680's per-decode H rebuild).
    """
    b, p, n = syndrome.shape
    w = shifts.shape[1]
    syndrome8 = syndrome.astype(jnp.int8)
    sign_syn = (1 - 2 * syndrome8).astype(jnp.float32)  # [B, P, N]

    def roll(x, k):
        return jnp.roll(x, k, axis=-1)

    # v2c planes: [B, P, W, N]; plane (p, t) check-major.
    def plane_stack(x):
        return jnp.stack(
            [
                jnp.stack([roll(x, shifts[pi, t]) for t in range(w)], axis=1)
                for pi in range(p)
            ],
            axis=1,
        )

    v2c0 = plane_stack(prior_c)

    def iterate(v2c):
        planes = jnp.concatenate([v2c, prior_i[:, :, None, :]], axis=2)
        flat = planes.reshape(b * p, w + 1, n)
        c2v = _plane_check_update(
            flat, sign_syn.reshape(b * p, n), method
        ).reshape(b, p, w + 1, n)
        c2v_c = c2v[:, :, :w, :]
        tot_c = prior_c + sum(
            roll(c2v_c[:, pi, t, :], -shifts[pi, t])
            for pi in range(p)
            for t in range(w)
        )
        v2c_new = plane_stack(tot_c) - c2v_c
        v2c_new = jnp.clip(v2c_new, -_BIG, _BIG)
        tot_i = prior_i + c2v[:, :, w, :]
        return v2c_new, tot_c, tot_i

    def syndrome_of(e_c, e_i):
        s = jnp.stack(
            [
                sum(roll(e_c, shifts[pi, t]) for t in range(w))
                for pi in range(p)
            ],
            axis=1,
        )
        return (s + e_i) % 2

    def body(state):
        it, v2c, e_out_c, e_out_i, conv = state
        v2c_new, tot_c, tot_i = iterate(v2c)
        e_c = (tot_c < 0).astype(jnp.int8)
        e_i = (tot_i < 0).astype(jnp.int8)
        ok = jnp.all(syndrome_of(e_c, e_i) == syndrome8, axis=(-2, -1))
        e_out_c = jnp.where(conv[:, None], e_out_c, e_c)
        e_out_i = jnp.where(conv[:, None, None], e_out_i, e_i)
        return it + 1, v2c_new, e_out_c, e_out_i, conv | ok

    def cond(state):
        it, _, _, _, conv = state
        return (it < max_iter) & ~jnp.all(conv)

    e0 = (prior_c < 0).astype(jnp.int8)
    e0i = (prior_i < 0).astype(jnp.int8)
    state = (jnp.int32(0), v2c0, e0, e0i, jnp.zeros((b,), bool))
    it, _, e_c, e_i, conv = jax.lax.while_loop(cond, body, state)
    return e_c.astype(jnp.int32), e_i.astype(jnp.int32), conv, it


class CirculantBPDecoder:
    """Batched syndrome BP decoder over a :class:`CirculantLayout`."""

    def __init__(self, layout: CirculantLayout, max_iter=50, method="product_sum"):
        self.layout = layout
        self.max_iter = int(max_iter)
        self.method = method

    @staticmethod
    def _to_llr(p_error, n, b):
        p = jnp.clip(jnp.asarray(p_error, jnp.float32), 1e-30, 1 - 1e-12)
        llr = jnp.log((1.0 - p) / p)
        return jnp.broadcast_to(llr, (b, n))

    def decode_syndrome(self, syndrome, channel_probs, return_aux=False):
        """channel_probs: [n_vars] or [B, n_vars] per-position error probability."""
        squeeze = np.ndim(syndrome) == 1
        syn = jnp.atleast_2d(jnp.asarray(syndrome, jnp.int32))
        b = syn.shape[0]
        lay = self.layout
        cp = jnp.atleast_2d(jnp.asarray(channel_probs, jnp.float32))
        prior_c = self._to_llr(cp[..., : lay.n], lay.n, b)
        if lay.with_identity:
            prior_i = self._to_llr(cp[..., lay.n :], lay.n, b)
        else:
            prior_i = jnp.zeros((b, lay.n), jnp.float32)
        e, conv, it = _circulant_bp(
            prior_c, prior_i, syn, lay.shifts, lay.with_identity, self.max_iter, self.method
        )
        if squeeze:
            e, conv = e[0], conv[0]
        return (e, conv, it) if return_aux else e

    def decode_received(self, z, channel_probs):
        squeeze = np.ndim(z) == 1
        z = jnp.atleast_2d(jnp.asarray(z, jnp.int32))
        lay = self.layout
        z_c = z[..., : lay.n]
        syn = sum(jnp.roll(z_c, k, axis=-1) for k in lay.shifts)
        if lay.with_identity:
            syn = syn + z[..., lay.n :]
        e = self.decode_syndrome(syn % 2, channel_probs)
        out = (z + e) % 2
        return out[0] if squeeze else out
