"""Batched beam-search decoding, fully on device.

Replaces the reference's host-side python beam search (reference
``model_attention.py:§gen_sample`` — SURVEY.md §3.3: python lists of
hypotheses, one video at a time, a host<->device round-trip per token).
Here the full batch x beam state lives in HBM; every step is one fused
XLA program (two-stage vectorized top-k, EOS retirement as masks,
static shapes throughout) under an early-exiting ``lax.while_loop``.

Invariant (tested): ``beam_decode(k=1)`` emits exactly the greedy tokens.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import ModelConfig
from ..data.text import EOS_ID
from ..model import step as step_mod
from ..model.decoder import StepFn, encode_context
from ..model.step import StepState, init_state, logits_from_states, precompute

_NEG = -1.0e30


class BeamOut(NamedTuple):
    tokens: jax.Array       # (B, maxlen) best beam, EOS-terminated
    scores: jax.Array       # (B,) raw log-prob of best beam
    norm_scores: jax.Array  # (B,) length-normalized score used for selection
    lengths: jax.Array      # (B,) tokens incl. EOS of best beam
    all_tokens: jax.Array   # (B, k, maxlen)
    all_scores: jax.Array   # (B, k) RAW log-probs (not length-normalized)
    all_norm_scores: jax.Array  # (B, k) length-normalized — ranking by
    # THIS column agrees with the best-beam choice; ranking all_scores
    # can disagree with `tokens` whenever length_norm > 0


def _topk_rows(x: jax.Array, ki: int, chunks: int = 1
               ) -> Tuple[jax.Array, jax.Array]:
    """Exact row-wise top-k, optionally computed over vocab chunks.

    With ``chunks > 1`` the vocab axis splits into chunks, top-k runs on
    the (rows*chunks, V/chunks) 2D view, and a second top-k merges the
    candidates — exact (each row's global top-k is a subset of the union
    of its per-chunk top-k).  A tuning knob for top_k lowering cost
    at large serving widths; chunks=1 is a plain 2D top_k.
    """
    rows, v = x.shape
    if chunks <= 1 or v % chunks or v // chunks < ki:
        return jax.lax.top_k(x, ki)
    cw = v // chunks
    vals, idx = jax.lax.top_k(x.reshape(rows * chunks, cw), ki)
    base = (jnp.arange(chunks, dtype=jnp.int32) * cw)[None, :, None]
    idx = (idx.reshape(rows, chunks, ki) + base).reshape(rows, chunks * ki)
    vals = vals.reshape(rows, chunks * ki)
    v2, i2 = jax.lax.top_k(vals, ki)
    return v2, jnp.take_along_axis(idx, i2, axis=1)


def _length_penalty(lengths: jax.Array, alpha: float, mode: str) -> jax.Array:
    """lp(l): 'gnmt' = ((5+l)/6)^alpha; 'linear' = l (the reference's
    ``normalize=True`` divides by plain length); 'none' = 1."""
    lf = jnp.maximum(lengths.astype(jnp.float32), 1.0)
    if mode == "linear":
        return lf
    if mode == "gnmt" and alpha > 0.0:
        return ((5.0 + lf) / 6.0) ** alpha
    return jnp.ones_like(lf)


# NOTE: the context is NOT tiled k times per beam — the step function
# broadcasts state batch B*k against context batch B (see
# step._attention_core_jnp 'Beam broadcasting'), saving k× the context
# HBM read traffic per decode step.


def beam_decode(
    params,
    cfg: ModelConfig,
    batch: Dict[str, jax.Array],
    beam_size: int = 5,
    maxlen: int = 30,
    length_norm: float = 0.6,
    norm_mode: str = "gnmt",
    step_fn: Optional[StepFn] = None,
    topk_chunks: int = 1,
) -> BeamOut:
    step_fn = step_fn or step_mod.step
    params = step_mod.cast_params(params, cfg)  # one weight cast, not T
    k = beam_size
    B = batch["frames"].shape[0]
    V = cfg.n_words
    ki = min(k, V)

    # fused logit tail (matmul+logsumexp+top-k, see
    # kernel.make_logit_tail) when the step function provides one and
    # takes the shape; built OUTSIDE the while_loop so its weight prep
    # is loop-invariant
    mk_tail = getattr(step_fn, "make_logit_tail", None)
    tail = mk_tail(params["ff_logit_W"], params["ff_logit_b"], ki) \
        if mk_tail is not None else None

    ctx = encode_context(params, cfg, batch["frames"], batch.get("motion"))
    sc = precompute(params, cfg, ctx, batch["frame_mask"],
                    batch.get("regions"))
    state0 = init_state(params, cfg, sc)
    h0 = jnp.repeat(state0.h, k, axis=0)
    c0 = jnp.repeat(state0.c, k, axis=0)

    # beam 0 starts live, beams 1..k-1 start dead (all beams are identical
    # at t=0 — this avoids k duplicate hypotheses)
    scores0 = jnp.tile(
        jnp.concatenate([jnp.zeros((1,)), jnp.full((k - 1,), _NEG)]), (B, 1))

    # lax.while_loop with early exit: stop as soon as every beam of
    # every batch row has emitted EOS (decode wall-clock tracks actual
    # caption length, not maxlen)
    def cond(carry):
        t = carry[0]
        finished = carry[5]
        return jnp.logical_and(t < maxlen,
                               jnp.logical_not(jnp.all(finished)))

    backptr = getattr(cfg, "beam_buf", "reorder") == "backptr"

    def body(carry):
        t, h, c, prev, scores, finished, lengths = carry[:7]
        bufs = carry[7:]
        emb_t = jnp.where(
            t == 0, jnp.zeros((B * k, cfg.dim_word), params["Wemb"].dtype),
            params["Wemb"][prev.reshape(B * k)])
        out = step_fn(params, cfg, StepState(h, c), sc, emb_t)
        if tail is not None:
            # fused path: logits never materialize at (B*k, V)
            act = step_mod.logit_activation(params, cfg, out.h, out.ctx_t,
                                            emb_t, train=False)
            vals, idx, lse = tail(act)
            pb_vals = (vals - lse[:, None]).reshape(B, k, ki)
            pb_idx = idx.reshape(B, k, ki)
        else:
            logits = logits_from_states(params, cfg, out.h, out.ctx_t,
                                        emb_t, train=False)
            logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
            # two-stage top-k: per-beam top-k over V, then merge over
            # k*ki — avoids a single top-k across k*V lanes (exact,
            # since the global top-k of the union is within each beam's
            # top-k).  The per-beam top_k runs on a 2D view.
            pb_vals, pb_idx = _topk_rows(logp.reshape(B * k, V), ki,
                                         topk_chunks)
            pb_vals = pb_vals.reshape(B, k, ki)
            pb_idx = pb_idx.reshape(B, k, ki)

        # finished beams may only extend with EOS at zero cost
        eos_vals = jnp.full((ki,), _NEG).at[0].set(0.0)
        eos_idx = jnp.where(jnp.arange(ki, dtype=jnp.int32) == 0, EOS_ID,
                            jnp.arange(ki, dtype=jnp.int32))
        pb_vals = jnp.where(finished[..., None], eos_vals, pb_vals)
        pb_idx = jnp.where(finished[..., None], eos_idx, pb_idx)
        cand = (scores[..., None] + pb_vals).reshape(B, k * ki)
        new_scores, merge_idx = jax.lax.top_k(cand, k)         # (B, k)
        parent = (merge_idx // ki).astype(jnp.int32)
        word = jnp.take_along_axis(
            pb_idx.reshape(B, k * ki), merge_idx, axis=1).astype(jnp.int32)

        def g(x):                                    # gather along beam axis
            return jnp.take_along_axis(x, parent, axis=1)

        par_finished = g(finished)
        new_finished = jnp.logical_or(par_finished, word == EOS_ID)
        new_lengths = g(lengths) + jnp.logical_not(par_finished)

        # reorder recurrent state by parent beam — three exact lowerings
        # (cfg.beam_gather)
        mode = getattr(cfg, "beam_gather", "take")
        if mode == "flat":
            rows = (jnp.arange(B, dtype=jnp.int32)[:, None] * k
                    + parent).reshape(B * k)
            new_h, new_c = out.h[rows], out.c[rows]
        elif mode == "onehot":
            oh = jax.nn.one_hot(parent, k, dtype=out.h.dtype)  # (B, k, k)

            def gs(x):
                xk = x.reshape(B, k, -1)
                return jnp.einsum(
                    "bij,bjd->bid", oh, xk,
                    preferred_element_type=jnp.float32,
                ).astype(x.dtype).reshape(B * k, -1)

            new_h, new_c = gs(out.h), gs(out.c)
        else:
            def gs(x):
                xk = x.reshape(B, k, -1)
                return jnp.take_along_axis(
                    xk, parent[..., None], axis=1).reshape(B * k, -1)

            new_h, new_c = gs(out.h), gs(out.c)
        emit = jnp.where(par_finished, EOS_ID, word)
        # token bookkeeping — two schemes (cfg.beam_buf):
        #   'reorder': carry the full (B, k, maxlen) prefix buffer and
        #     gather it by parent every step (the reference's hypothesis
        #     -list semantics, vectorized).
        #   'backptr': write only (emit, parent) at position t — no
        #     per-step buffer gather; prefixes are reconstructed once
        #     after the loop by backtracking the parent pointers.
        if backptr:
            words, parents = bufs
            new_bufs = (
                jax.lax.dynamic_update_index_in_dim(words, emit, t, axis=2),
                jax.lax.dynamic_update_index_in_dim(parents, parent, t,
                                                    axis=2))
        else:
            buf, = bufs
            if mode == "flat":
                new_buf = buf.reshape(B * k, maxlen)[rows].reshape(
                    B, k, maxlen)
            else:
                new_buf = jnp.take_along_axis(buf, parent[..., None], axis=1)
            new_bufs = (jax.lax.dynamic_update_index_in_dim(
                new_buf, emit, t, axis=2),)
        return (t + 1, new_h, new_c, word, new_scores, new_finished,
                new_lengths) + new_bufs

    if backptr:
        # parents init to identity: backtracking through never-executed
        # steps (early exit) must keep the beam slot fixed
        bufs0 = (jnp.zeros((B, k, maxlen), jnp.int32),
                 jnp.broadcast_to(jnp.arange(k, dtype=jnp.int32)[None, :,
                                                                 None],
                                  (B, k, maxlen)))
    else:
        bufs0 = (jnp.zeros((B, k, maxlen), jnp.int32),)
    init = (jnp.zeros((), jnp.int32), h0, c0,
            jnp.zeros((B, k), jnp.int32), scores0,
            jnp.zeros((B, k), bool), jnp.zeros((B, k), jnp.int32)) + bufs0
    final = jax.lax.while_loop(cond, body, init)
    scores, finished, lengths = final[4], final[5], final[6]
    if backptr:
        words, parents = final[7], final[8]

        def back(beams, t):
            w_t = jax.lax.dynamic_index_in_dim(words, t, axis=2,
                                               keepdims=False)
            p_t = jax.lax.dynamic_index_in_dim(parents, t, axis=2,
                                               keepdims=False)
            tok = jnp.take_along_axis(w_t, beams, axis=1)
            return jnp.take_along_axis(p_t, beams, axis=1), tok

        beams0 = jnp.broadcast_to(jnp.arange(k, dtype=jnp.int32)[None, :],
                                  (B, k))
        _, toks = jax.lax.scan(
            back, beams0, jnp.arange(maxlen - 1, -1, -1, dtype=jnp.int32))
        buf = jnp.flip(toks, axis=0).transpose(1, 2, 0)  # (B, k, maxlen)
    else:
        buf = final[7]

    lp = _length_penalty(lengths, length_norm, norm_mode)
    norm = scores / lp
    best = jnp.argmax(norm, axis=1)                    # (B,)
    take = lambda x: jnp.take_along_axis(
        x, best[:, None] if x.ndim == 2 else best[:, None, None], axis=1)
    best_tokens = jnp.take_along_axis(
        buf, best[:, None, None].repeat(buf.shape[2], 2), axis=1)[:, 0]
    return BeamOut(
        tokens=best_tokens,
        scores=take(scores)[:, 0],
        norm_scores=take(norm)[:, 0],
        lengths=take(lengths)[:, 0],
        all_tokens=buf,
        all_scores=scores,
        all_norm_scores=norm,
    )
