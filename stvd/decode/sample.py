"""Batched stochastic sampling decode, fully on device.

The reference's ``gen_sample`` supports non-argmax sampling
(``model_attention.py:§gen_sample`` with ``argmax=False`` draws the
next word from the softmax multinomial — SURVEY.md §3.3 / §2 row 3);
the reference does it one video at a time with a host round-trip per
token.  Here the whole batch (x ``n_samples`` draws per video) runs in
one early-exiting ``lax.while_loop`` with per-step RNG folding.

Knobs beyond the reference:
  * ``temperature`` — logits are divided by it before sampling;
    ``temperature == 0.0`` (static) is exact greedy argmax, and
    temperature -> 0 converges to greedy (tested).
  * ``top_k`` — truncated sampling among the k most likely words.  When
    the step function provides the fused logit tail
    (kernel.make_logit_tail) and it takes the shape, top-k sampling
    reuses it, so the (rows, V) logits never materialize in device
    memory — sampling costs the same as beam search per step.
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


class SampleOut(NamedTuple):
    tokens: jax.Array    # (B, n_samples, maxlen) int32, EOS-terminated
    scores: jax.Array    # (B, n_samples) total log-prob under the model
    lengths: jax.Array   # (B, n_samples) emitted tokens incl. EOS


def sample_decode(
    params,
    cfg: ModelConfig,
    batch: Dict[str, jax.Array],
    rng: jax.Array,
    maxlen: int = 30,
    temperature: float = 1.0,
    top_k: int = 0,
    n_samples: int = 1,
    step_fn: Optional[StepFn] = None,
) -> SampleOut:
    """Draw ``n_samples`` captions per video by ancestral sampling.

    ``batch`` keys: frames (B,K,D), frame_mask (B,K), optional
    regions/motion.  Scores are the sequence log-probs under the
    UN-tempered model distribution (so samples are comparable to
    greedy/beam scores).  ``temperature=0.0`` short-circuits to argmax.
    """
    if temperature < 0.0:
        raise ValueError("temperature must be >= 0")
    step_fn = step_fn or step_mod.step
    params = step_mod.cast_params(params, cfg)   # one weight cast, not T
    B = batch["frames"].shape[0]
    n = n_samples
    V = cfg.n_words
    greedy = temperature == 0.0
    use_topk = top_k > 0 and top_k < V
    ki = 1 if greedy else (top_k if use_topk else 0)

    # fused logit tail: usable whenever only the top-ki logits are
    # needed (greedy or truncated top-k sampling)
    mk_tail = getattr(step_fn, "make_logit_tail", None)
    tail = (mk_tail(params["ff_logit_W"], params["ff_logit_b"], ki)
            if (mk_tail is not None and ki > 0) else None)

    ctx = encode_context(params, cfg, batch["frames"], batch.get("motion"))
    sc = precompute(params, cfg, ctx, batch["frame_mask"],
                    batch.get("regions"))
    state0 = init_state(params, cfg, sc)
    # n samples per video ride the beam-broadcast machinery: state rows
    # are (B*n,) against context rows (B,) — no context duplication
    h0 = jnp.repeat(state0.h, n, axis=0)
    c0 = jnp.repeat(state0.c, n, axis=0)
    rows = B * n
    inv_t = 0.0 if greedy else 1.0 / temperature

    def cond(carry):
        t, _, _, finished, _, _, _ = carry
        return jnp.logical_and(t < maxlen,
                               jnp.logical_not(jnp.all(finished)))

    def body(carry):
        t, state, prev, finished, score, length, buf = carry
        emb_t = jnp.where(
            t == 0, jnp.zeros((rows, cfg.dim_word), params["Wemb"].dtype),
            params["Wemb"][prev])
        out = step_fn(params, cfg, state, sc, emb_t)
        key = jax.random.fold_in(rng, t)
        if tail is not None:
            act = step_mod.logit_activation(params, cfg, out.h, out.ctx_t,
                                            emb_t, train=False)
            vals, idx, lse = tail(act)          # (rows, ki) exact top-ki
            if greedy:
                nxt = idx[:, 0]
                tok_logp = vals[:, 0] - lse
            else:
                pick = jax.random.categorical(key, vals * inv_t, axis=-1)
                nxt = jnp.take_along_axis(idx, pick[:, None], axis=1)[:, 0]
                tok_logp = jnp.take_along_axis(
                    vals, pick[:, None], axis=1)[:, 0] - lse
        else:
            logits = logits_from_states(params, cfg, out.h, out.ctx_t,
                                        emb_t, train=False)
            logits = logits.astype(jnp.float32)
            logp = jax.nn.log_softmax(logits, axis=-1)
            if greedy:
                nxt = jnp.argmax(logp, axis=-1).astype(jnp.int32)
            else:
                samp = logits * inv_t
                if use_topk:
                    kth = jax.lax.top_k(samp, top_k)[0][:, -1:]
                    samp = jnp.where(samp < kth, -jnp.inf, samp)
                nxt = jax.random.categorical(key, samp, axis=-1)
                nxt = nxt.astype(jnp.int32)
            tok_logp = jnp.take_along_axis(logp, nxt[:, None], axis=1)[:, 0]
        alive = jnp.logical_not(finished)
        score = score + jnp.where(alive, tok_logp, 0.0)
        length = length + alive.astype(jnp.int32)
        emit = jnp.where(alive, nxt, EOS_ID)
        finished = jnp.logical_or(finished, nxt == EOS_ID)
        buf = jax.lax.dynamic_update_index_in_dim(buf, emit, t, axis=1)
        return (t + 1, StepState(out.h, out.c), emit, finished, score,
                length, buf)

    init = (jnp.zeros((), jnp.int32), StepState(h0, c0),
            jnp.zeros((rows,), jnp.int32), jnp.zeros((rows,), bool),
            jnp.zeros((rows,), jnp.float32), jnp.zeros((rows,), jnp.int32),
            jnp.zeros((rows, maxlen), jnp.int32))
    _, _, _, _, score, length, buf = jax.lax.while_loop(cond, body, init)
    return SampleOut(tokens=buf.reshape(B, n, maxlen),
                     scores=score.reshape(B, n),
                     lengths=length.reshape(B, n))
