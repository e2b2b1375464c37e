"""Training loss (reference: the cost expression in
``model_attention.py:§build_model`` — masked NLL averaged over the batch,
plus the optional attention-coverage regularizer ``alpha_c``)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import ModelConfig
from ..model.decoder import ForwardOut, StepFn, forward_train


def loss_terms(
    params,
    cfg: ModelConfig,
    batch: Dict[str, jax.Array],
    rng: Optional[jax.Array] = None,
    train: bool = True,
    ss_prob: float = 0.0,
    step_fn: Optional[StepFn] = None,
) -> Dict[str, jax.Array]:
    """Unreduced loss terms (weighted sums).

    Separated from the final ratios so data-parallel shards can psum
    the numerators/denominators before dividing — giving
    bit-identical loss/grads to a single-device run regardless of how
    examples (and their weights) split across shards.
    """
    out: ForwardOut = forward_train(params, cfg, batch, rng=rng, train=train,
                                    ss_prob=ss_prob, step_fn=step_fn)
    w = batch.get("weight")
    if w is None:
        w = jnp.ones_like(out.nll_per_example)
    terms = {
        "nll_num": jnp.sum(out.nll_per_example * w),
        "ex_den": jnp.sum(w),
        "tok_den": jnp.sum(batch["token_mask"] * w[:, None]),
        "reg_num": jnp.zeros(()),
    }
    if cfg.alpha_c > 0.0:
        # coverage: encourage total attention mass per frame ≈ T_valid/K
        # (show-attend-tell style regularizer the reference inherits)
        tmask = batch["token_mask"]                       # (B, T)
        fmask = batch["frame_mask"]                       # (B, K)
        asum = jnp.sum(out.alphas * tmask[..., None], axis=1)   # (B, K)
        t_valid = jnp.sum(tmask, axis=1, keepdims=True)
        k_valid = jnp.maximum(jnp.sum(fmask, axis=1, keepdims=True), 1.0)
        target = t_valid / k_valid
        reg = jnp.sum(((target - asum) ** 2) * fmask, axis=1)
        terms["reg_num"] = jnp.sum(reg * w)
    return terms


def loss_from_terms(terms: Dict[str, jax.Array], cfg: ModelConfig
                    ) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    denom = jnp.maximum(terms["ex_den"], 1.0)
    nll = terms["nll_num"] / denom
    loss = nll
    if cfg.alpha_c > 0.0:
        loss = loss + cfg.alpha_c * terms["reg_num"] / denom
    aux = {
        "nll": nll,
        "nll_per_token": terms["nll_num"] / jnp.maximum(terms["tok_den"], 1.0),
    }
    return loss, aux


def loss_fn(
    params,
    cfg: ModelConfig,
    batch: Dict[str, jax.Array],
    rng: Optional[jax.Array] = None,
    train: bool = True,
    ss_prob: float = 0.0,
    step_fn: Optional[StepFn] = None,
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """Scalar loss + aux dict.

    ``batch['weight']`` (B,), if present, zeroes out wrapped padding
    examples from the static-shape batch iterator.
    """
    terms = loss_terms(params, cfg, batch, rng=rng, train=train,
                       ss_prob=ss_prob, step_fn=step_fn)
    return loss_from_terms(terms, cfg)
