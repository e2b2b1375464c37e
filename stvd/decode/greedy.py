"""Batched greedy decoding, fully on device.

Replaces the reference's per-video host loop (reference
``model_attention.py:§gen_sample`` with k=1 — SURVEY.md §3.3: one GPU
round-trip PER TOKEN PER VIDEO).  Here the whole batch decodes in one
early-exiting ``lax.while_loop`` with zero host synchronization; the step function is the
same one training uses (BASELINE: train/infer share the step).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import ModelConfig
from ..data.text import EOS_ID
from ..model import step as step_mod
from ..model.decoder import StepFn, encode_context
from ..model.step import StepState, init_state, logits_from_states, precompute


class GreedyOut(NamedTuple):
    tokens: jax.Array    # (B, maxlen) int32, EOS-terminated, 0-padded
    scores: jax.Array    # (B,) total log-prob of the emitted sequence
    lengths: jax.Array   # (B,) emitted tokens incl. EOS
    alphas: Optional[jax.Array] = None  # (B, maxlen, K) temporal attention


def greedy_decode(
    params,
    cfg: ModelConfig,
    batch: Dict[str, jax.Array],
    maxlen: int = 30,
    step_fn: Optional[StepFn] = None,
    return_alphas: bool = False,
) -> GreedyOut:
    """Greedy argmax decode for a batch of videos.

    ``batch`` keys: frames (B,K,D), frame_mask (B,K), optional
    regions/motion.  ``return_alphas`` additionally records the
    per-step temporal attention maps (the paper's qualitative
    visualizations — reference alphas from §build_sampler).
    """
    step_fn = step_fn or step_mod.step
    params = step_mod.cast_params(params, cfg)  # one weight cast, not T
    B = batch["frames"].shape[0]
    # fused logit tail (top-1 + logsumexp, no (B, V) logits in device
    # memory) when the step function provides one and takes k = 1;
    # built outside the loop
    mk_tail = getattr(step_fn, "make_logit_tail", None)
    tail = mk_tail(params["ff_logit_W"], params["ff_logit_b"], 1) \
        if mk_tail is not None else None
    ctx = encode_context(params, cfg, batch["frames"], batch.get("motion"))
    sc = precompute(params, cfg, ctx, batch["frame_mask"],
                    batch.get("regions"))
    state0 = init_state(params, cfg, sc)

    # lax.while_loop with early exit: most captions finish well before
    # maxlen, so decode stops as soon as every sequence has emitted EOS
    # (static shapes throughout; the token buffer is pre-allocated)
    K = batch["frame_mask"].shape[1]

    def cond(carry):
        t, _, _, finished, _, _, _, _ = carry
        return jnp.logical_and(t < maxlen,
                               jnp.logical_not(jnp.all(finished)))

    def body(carry):
        t, state, prev, finished, score, length, buf, abuf = carry
        emb_t = jnp.where(t == 0,
                          jnp.zeros((B, cfg.dim_word), params["Wemb"].dtype),
                          params["Wemb"][prev])
        out = step_fn(params, cfg, state, sc, emb_t)
        if tail is not None:
            act = step_mod.logit_activation(params, cfg, out.h, out.ctx_t,
                                            emb_t, train=False)
            vals, idx, lse = tail(act)
            nxt = idx[:, 0]
            tok_logp = vals[:, 0] - lse
        else:
            logits = logits_from_states(params, cfg, out.h, out.ctx_t,
                                        emb_t, train=False)
            logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
            nxt = jnp.argmax(logp, axis=-1).astype(jnp.int32)
            tok_logp = jnp.take_along_axis(logp, nxt[:, None], axis=-1)[:, 0]
        alive = jnp.logical_not(finished)
        score = score + jnp.where(alive, tok_logp, 0.0)
        length = length + alive.astype(jnp.int32)
        emit = jnp.where(alive, nxt, EOS_ID)
        finished = jnp.logical_or(finished, nxt == EOS_ID)
        buf = jax.lax.dynamic_update_index_in_dim(buf, emit, t, axis=1)
        if abuf is not None:
            abuf = jax.lax.dynamic_update_index_in_dim(
                abuf, out.alpha.astype(jnp.float32), t, axis=1)
        return (t + 1, StepState(out.h, out.c), emit, finished, score,
                length, buf, abuf)

    init = (jnp.zeros((), jnp.int32), state0, jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), bool), jnp.zeros((B,), jnp.float32),
            jnp.zeros((B,), jnp.int32), jnp.zeros((B, maxlen), jnp.int32),
            jnp.zeros((B, maxlen, K), jnp.float32) if return_alphas else None)
    _, _, _, _, score, length, buf, abuf = jax.lax.while_loop(
        cond, body, init)
    return GreedyOut(tokens=buf, scores=score, lengths=length, alphas=abuf)
