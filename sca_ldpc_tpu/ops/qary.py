"""Batched q-ary min-sum LDPC decoding over symbol alphabet [-B..B].

Batched equivalent of the reference's Rust ``Decoder`` (decoder.rs:417-724):
same message semantics (min-sum LLRs ``ln(max/p)``, extrinsic min over zero-sum
configurations, arg-min normalization, arg-min hard decision, GF "multiplication"
by H entries in {-1,+1} as alphabet reversal) — but the per-check configuration
enumeration is replaced by exact min-plus convolutions
(:mod:`sca_ldpc_tpu.ops.minplus`) and the reference's ThreadPoolExecutor
parallelism (decode.py:247-263) becomes a leading frame batch axis.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.layout import CodeLayout
from ..channels.llr import probs_to_llr
from . import minplus
from .minplus import BIG


def _signed(msg, sign):
    """Apply GF multiplication by h in {-1,+1}: reverse the symbol axis where
    h < 0 (decoder.rs:164-172)."""
    return jnp.where(sign[..., None] < 0, msg[..., ::-1], msg)


@partial(jax.jit, static_argnames=("max_iter", "b_range", "dc", "early_exit"))
def _qary_min_sum(
    chk_var,  # [R, DC] int32, pad == n
    chk_sign,  # [R, DC] int8
    chk_mask,  # [R, DC] bool
    var_flat,  # [N, DV] int32 into [R*DC+1]
    var_sign,  # [N, DV] int8
    var_mask,  # [N, DV] bool
    channel,  # [Bt, N, Q] min-sum LLRs (finite; inf pre-clipped)
    max_iter: int,
    b_range: int,  # B
    dc: int,
    early_exit: bool = False,  # stop when every frame satisfies all checks
):
    bt, n, q = channel.shape
    r = chk_var.shape[0]
    s_mid = (dc - 1) * b_range  # support bound of any (DC-1)-operand conv

    # Padded channel: pad slots get the min-plus identity (delta at symbol 0),
    # which is exactly the reference's treatment of missing/irregular slots.
    delta = minplus.identity(q)[None, None, :]
    channel_pad = jnp.concatenate(
        [channel, jnp.broadcast_to(delta, (bt, 1, q))], axis=1
    )

    def gather_chk(x_pad):  # [Bt, N+1, Q] -> [Bt, R, DC, Q]
        return jnp.take(x_pad, chk_var.reshape(-1), axis=1).reshape(bt, r, dc, q)

    sign_c = jnp.asarray(chk_sign, jnp.int32)
    mask_c = chk_mask

    v2c0 = _signed(gather_chk(channel_pad), sign_c)
    # Force pad slots to the identity so they are conv no-ops.
    v2c0 = jnp.where(mask_c[..., None], v2c0, delta[None])

    sign_v = jnp.asarray(var_sign, jnp.int32)

    def body(_, state):
        v2c, _total = state
        # --- check update: exact min over zero-sum configs via min-plus convs,
        # computed only on the consumed +-B output window.
        ext = minplus.chain_exclusive(v2c, s_mid, s_out=b_range)
        # beta_j[d] = ext_j[-d]: reverse the symbol axis.
        c2v = jnp.minimum(ext[..., ::-1], BIG)

        # --- variable update (sum, extrinsic, arg-min normalization).
        c2v_flat = jnp.concatenate(
            [c2v.reshape(bt, r * dc, q), jnp.zeros((bt, 1, q))], axis=1
        )
        c2v_var = jnp.take(c2v_flat, var_flat.reshape(-1), axis=1).reshape(
            bt, n, -1, q
        )
        c2v_var_u = _signed(c2v_var, sign_v)  # unsigned (variable) domain
        c2v_var_u = jnp.where(var_mask[..., None], c2v_var_u, 0.0)
        total = channel + jnp.sum(c2v_var_u, axis=2)  # [Bt, N, Q]

        # Extrinsic computed check-side: signed(total - c2v_u) ==
        # signed(total) - c2v (reversal is a permutation), which replaces the
        # flat scatter with a cheap gather — bitwise-identical messages.
        total_pad = jnp.concatenate(
            [total, jnp.broadcast_to(delta, (bt, 1, q))], axis=1
        )
        prim = _signed(gather_chk(total_pad), sign_c) - c2v
        prim = prim - jnp.min(prim, axis=-1, keepdims=True)
        prim = jnp.minimum(prim, BIG)
        v2c_new = jnp.where(mask_c[..., None], prim, delta[None])
        return v2c_new, total

    if not early_exit:
        # The reference takes its hard decision from the totals of the final
        # iteration's variable update (decoder.rs:654-662), always running
        # max_iter iterations.
        _, total = jax.lax.fori_loop(
            0, max_iter, body, (v2c0, jnp.zeros((bt, n, q)))
        )
        return jnp.argmin(total, axis=-1).astype(jnp.int32) - b_range

    # Early-exit variant (beyond the reference): per-frame hard decisions
    # latch at the first iteration whose decision satisfies every check
    # (sum of signed symbols == 0 over the integers); the batch stops when
    # all frames have latched or max_iter is reached.
    def satisfied(hard):
        hard_pad = jnp.concatenate([hard, jnp.zeros((bt, 1), jnp.int32)], axis=1)
        sym = jnp.take(hard_pad, chk_var.reshape(-1), axis=1).reshape(bt, r, dc)
        sym = jnp.where(mask_c, sym * jnp.asarray(chk_sign, jnp.int32), 0)
        return jnp.all(jnp.sum(sym, axis=-1) == 0, axis=-1)  # [Bt]

    def w_body(state):
        it, v2c, hard_out, conv = state
        v2c_new, total = body(it, (v2c, None))
        hard = jnp.argmin(total, axis=-1).astype(jnp.int32) - b_range
        ok = satisfied(hard)
        hard_out = jnp.where(conv[:, None], hard_out, hard)
        return it + 1, v2c_new, hard_out, conv | ok

    def w_cond(state):
        it, _v2c, _hard, conv = state
        return (it < max_iter) & ~jnp.all(conv)

    state = (
        jnp.int32(0),
        v2c0,
        jnp.zeros((bt, n), jnp.int32),
        jnp.zeros((bt,), bool),
    )
    _, _, hard, _ = jax.lax.while_loop(w_cond, w_body, state)
    return hard


class QaryDecoder:
    """Q-ary min-sum decoder over a parity-check matrix with entries {-1,0,+1}.

    Matches the construction interface of the reference's registered decoder
    classes (pydecoder.rs:24-45): ``QaryDecoder(H, B, iterations)``.
    """

    def __init__(self, H, b_range: int, max_iter: int, dc=None, dv=None,
                 early_exit=False):
        self.layout = CodeLayout.from_h(np.asarray(H), dc=dc, dv=dv)
        self.b = int(b_range)
        self.q = 2 * self.b + 1
        self.max_iter = int(max_iter)
        self.early_exit = bool(early_exit)
        lay = self.layout
        self._args = (
            jnp.asarray(lay.chk_var),
            jnp.asarray(lay.chk_sign),
            jnp.asarray(lay.chk_mask),
            jnp.asarray(lay.var_flat),
            jnp.asarray(lay.var_sign),
            jnp.asarray(lay.var_mask),
        )

    def _decode_llr(self, llr):
        return _qary_min_sum(
            *self._args, llr, self.max_iter, self.b, self.layout.dc,
            early_exit=self.early_exit,
        )

    def min_sum(self, channel_probs):
        """Decode ``[N, Q]`` (or batched ``[Bt, N, Q]``) symbol probability
        tables to hard decisions in ``[-B..B]``.

        Mirrors pydecoder.rs:53-65: probabilities are converted to min-sum
        LLRs internally (``ln(max/p)``).
        """
        probs = jnp.asarray(channel_probs, jnp.float32)
        squeeze = probs.ndim == 2
        if squeeze:
            probs = probs[None]
        if probs.shape[-1] != self.q:
            raise ValueError(f"expected {self.q} symbol columns, got {probs.shape[-1]}")
        llr = minplus.clip_inf(probs_to_llr(probs))
        hard = self._decode_llr(llr)
        return hard[0] if squeeze else hard

    def min_sum_llr(self, channel_llr):
        """Decode precomputed min-sum LLRs (inf allowed; clipped internally)."""
        llr = jnp.asarray(channel_llr, jnp.float32)
        squeeze = llr.ndim == 2
        if squeeze:
            llr = llr[None]
        llr = minplus.clip_inf(llr)
        hard = self._decode_llr(llr)
        return hard[0] if squeeze else hard
