"""Batched binary belief-propagation syndrome decoding.

Batched replacement for the reference's CPU ``ldpc.bp_decoder``
(decode.py:155-171, hqc.py:694-708).  Differences by design:

- The frame dimension is a leading batch axis: one jitted call decodes
  thousands of frames (the reference decodes one frame per Python call).
- Messages live check-major as ``[batch, R, DC]`` with a flat sentinel slot for
  padding, so irregular codes are masked lanes, not branches.
- Flooding schedule with per-frame convergence latching: each frame's output is
  frozen at its first syndrome-satisfying iteration, and the whole batch exits
  early (``lax.while_loop``) once every frame has converged.

Both BP variants of the reference are provided: ``product_sum`` (used by the
reference throughout) and ``min_sum``.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.layout import CodeLayout

_BIG = 60.0  # LLR clip: tanh saturates at float32 well below this
MIN_SUM_ALPHA = 0.75  # normalized min-sum scale (standard 0.7-0.8 range)


def _phi(x):
    """Gallager phi(x) = -log(tanh(x/2)), a self-inverse on (0, inf)."""
    x = jnp.clip(x, 1e-9, _BIG)
    return -jnp.log(jnp.tanh(0.5 * x))


def _check_update(v2c, sign_flip, mask, method):
    """Extrinsic check-to-variable messages.

    v2c: [..., R, DC] incoming LLRs; sign_flip: [..., R] +-1 from the syndrome
    bit; mask: [R, DC] valid-slot mask.  Returns c2v of the same shape.
    """
    sgn = jnp.where(v2c >= 0, 1.0, -1.0)
    sgn = jnp.where(mask, sgn, 1.0)
    mag = jnp.where(mask, jnp.abs(v2c), jnp.inf)

    total_sign = jnp.prod(sgn, axis=-1, keepdims=True) * sign_flip[..., None]
    ext_sign = total_sign * sgn  # divide == multiply for +-1

    if method == "product_sum":
        pm = jnp.where(mask, _phi(mag), 0.0)
        total = jnp.sum(pm, axis=-1, keepdims=True)
        ext_mag = _phi(jnp.maximum(total - pm, 1e-9))
    elif method == "min_sum":
        min1 = jnp.min(mag, axis=-1, keepdims=True)
        arg1 = jnp.argmin(mag, axis=-1)
        mag2 = jnp.where(
            jax.nn.one_hot(arg1, mag.shape[-1], dtype=bool), jnp.inf, mag
        )
        min2 = jnp.min(mag2, axis=-1, keepdims=True)
        ext_mag = jnp.where(mag == min1, min2, min1)
        # normalized min-sum: plain min-sum overestimates extrinsics badly on
        # high-degree checks (FER collapse at moderate noise)
        ext_mag = MIN_SUM_ALPHA * jnp.minimum(ext_mag, _BIG)
    else:
        raise ValueError(f"unknown bp method: {method}")

    return jnp.where(mask, ext_sign * ext_mag, 0.0)


@partial(jax.jit, static_argnames=("max_iter", "method", "dc"))
def _bp_decode_syndrome(
    chk_var,  # [R, DC] int32, pad == n
    chk_mask,  # [R, DC] bool
    var_flat,  # [N, DV] int32 into flattened [R*DC+1]
    var_mask,  # [N, DV] bool
    prior_llr,  # [N] or [B, N] float32, ln(p0/p1) of the error bit
    syndrome,  # [B, R] int
    max_iter: int,
    method: str,
    dc: int,
):
    r = chk_var.shape[0]
    n = var_flat.shape[0]
    b = syndrome.shape[0]

    prior = jnp.broadcast_to(jnp.asarray(prior_llr, jnp.float32), (b, n))
    sign_flip = (1.0 - 2.0 * syndrome.astype(jnp.float32))  # [B, R]

    prior_pad = jnp.concatenate([prior, jnp.zeros((b, 1), jnp.float32)], axis=-1)
    v2c0 = jnp.take(prior_pad, chk_var.reshape(-1), axis=-1).reshape(b, r, dc)

    def hard_and_syndrome(total):  # total: [B, N] posterior LLR
        e_hat = (total < 0).astype(jnp.int32)
        e_pad = jnp.concatenate([e_hat, jnp.zeros((b, 1), jnp.int32)], axis=-1)
        bits = jnp.take(e_pad, chk_var.reshape(-1), axis=-1).reshape(b, r, dc)
        syn = jnp.sum(jnp.where(chk_mask, bits, 0), axis=-1) % 2
        ok = jnp.all(syn == syndrome, axis=-1)
        return e_hat, ok

    def body(state):
        it, v2c, e_out, conv = state
        c2v = _check_update(v2c, sign_flip, chk_mask, method)
        c2v_flat = jnp.concatenate(
            [c2v.reshape(b, -1), jnp.zeros((b, 1), jnp.float32)], axis=-1
        )
        c2v_var = jnp.take(c2v_flat, var_flat.reshape(-1), axis=-1).reshape(
            b, n, -1
        )
        c2v_var = jnp.where(var_mask, c2v_var, 0.0)
        total = prior + jnp.sum(c2v_var, axis=-1)
        # Check-side extrinsic: v2c[r,j] = total[chk_var[r,j]] - c2v[r,j].
        # Same per-edge arithmetic as subtracting variable-side and scattering
        # back check-major, but with a gather instead of a scatter (cf. the
        # q-ary decoder's identical optimization).
        total_pad = jnp.concatenate([total, jnp.zeros((b, 1), jnp.float32)], axis=-1)
        tot_chk = jnp.take(total_pad, chk_var.reshape(-1), axis=-1).reshape(b, r, dc)
        v2c_new = jnp.clip(tot_chk - c2v, -_BIG, _BIG)

        e_hat, ok = hard_and_syndrome(total)
        e_out = jnp.where(conv[:, None], e_out, e_hat)  # latch first converged estimate
        conv_new = conv | ok
        return it + 1, v2c_new, e_out, conv_new

    def cond(state):
        it, _, _, conv = state
        return (it < max_iter) & ~jnp.all(conv)

    # Iteration 0 output (in case max_iter rounds never converge).
    e_init = (prior < 0).astype(jnp.int32)
    state = (jnp.int32(0), v2c0, e_init, jnp.zeros((b,), bool))
    it, _, e_out, conv = jax.lax.while_loop(cond, body, state)
    return e_out, conv, it


class BinaryBPDecoder:
    """Batched syndrome BP decoder over a :class:`CodeLayout`.

    ``channel_probs`` follows the reference's convention: per-position
    probability that the error bit is 1 (ldpc bp_decoder channel_probs /
    error_rate, decode.py:155-161).
    """

    def __init__(self, H_or_layout, max_iter=50, method="product_sum", channel_probs=None, error_rate=None):
        if isinstance(H_or_layout, CodeLayout):
            self.layout = H_or_layout
        else:
            self.layout = CodeLayout.from_h(np.asarray(H_or_layout))
        lay = self.layout
        self.max_iter = int(max_iter)
        self.method = method
        self._chk_var = jnp.asarray(lay.chk_var)
        self._chk_mask = jnp.asarray(lay.chk_mask)
        self._var_flat = jnp.asarray(lay.var_flat)
        self._var_mask = jnp.asarray(lay.var_mask)
        self.default_prior = None
        if channel_probs is not None:
            p = np.asarray(channel_probs, dtype=np.float32)
            self.default_prior = self._to_llr(p)
        elif error_rate is not None:
            p = np.full(lay.n, float(error_rate), dtype=np.float32)
            self.default_prior = self._to_llr(p)

    @staticmethod
    def _to_llr(p_error):
        p = np.clip(np.asarray(p_error, np.float64), 1e-30, 1 - 1e-12)
        return jnp.asarray(np.log((1 - p) / p), jnp.float32)

    def decode_syndrome(self, syndrome, channel_probs=None, return_aux=False):
        """Decode [B, R] (or [R]) syndromes to [B, N] error estimates."""
        syn = jnp.atleast_2d(jnp.asarray(syndrome, jnp.int32))
        squeeze = np.ndim(syndrome) == 1
        prior = (
            self._to_llr(channel_probs) if channel_probs is not None else self.default_prior
        )
        if prior is None:
            raise ValueError("channel probabilities required (ctor or call)")
        e, conv, it = _bp_decode_syndrome(
            self._chk_var,
            self._chk_mask,
            self._var_flat,
            self._var_mask,
            prior,
            syn,
            self.max_iter,
            self.method,
            self.layout.dc,
        )
        if squeeze:
            e, conv = e[0], conv[0]
        return (e, conv, it) if return_aux else e

    def decode_received(self, z, channel_probs=None):
        """ldpc-package "received vector" mode: returns the corrected word
        ``(z + e_hat) % 2`` (used by the HQC attack decode, hqc.py:703-708)."""
        squeeze = np.ndim(z) == 1
        z = jnp.atleast_2d(jnp.asarray(z, jnp.int32))
        lay = self.layout
        z_pad = jnp.concatenate([z, jnp.zeros((z.shape[0], 1), jnp.int32)], axis=-1)
        bits = jnp.take(z_pad, self._chk_var.reshape(-1), axis=-1).reshape(
            z.shape[0], lay.r, lay.dc
        )
        syn = jnp.sum(jnp.where(self._chk_mask, bits, 0), axis=-1) % 2
        e = self.decode_syndrome(syn, channel_probs)
        out = (z + e) % 2
        return out[0] if squeeze else out
