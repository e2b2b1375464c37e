"""bfloat16 compute-path coverage (the benchmark configuration).

Params stay fp32; matmuls run in bf16 with fp32 accumulation
(ModelConfig.compute_dtype). These tests pin that the bf16 path is
numerically sane and structurally identical to fp32 — on CPU here,
compiled for the GPU's tensor cores.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stvd.data.batching import gather_batch, synthetic_dataset
from stvd.decode.beam import beam_decode
from stvd.decode.greedy import greedy_decode
from stvd.model.decoder import forward_train, init_params
from stvd.train.loop import init_train_state, make_train_step

from conftest import small_cfg
from stvd.config import TrainConfig

BF16 = small_cfg(compute_dtype="bfloat16")
FP32 = small_cfg(compute_dtype="float32")


def _setup(n=4):
    ds = synthetic_dataset(n_videos=n, k=BF16.n_frames, d=BF16.ctx_dim,
                           maxlen=10, seed=0)
    dev = ds.bank.to_device()
    batch = gather_batch(dev, ds.captions, np.arange(n, dtype=np.int32))
    params = init_params(jax.random.PRNGKey(0), BF16)
    return params, batch


def test_bf16_forward_close_to_fp32():
    params, batch = _setup()
    out16 = forward_train(params, BF16, batch, train=False)
    out32 = forward_train(params, FP32, batch, train=False)
    # logits are O(0.1) at init; bf16 has ~3 decimal digits
    np.testing.assert_allclose(np.asarray(out16.logits),
                               np.asarray(out32.logits), atol=0.05)
    assert np.isfinite(np.asarray(out16.logits)).all()


def test_bf16_decode_runs_and_terminates():
    params, batch = _setup()
    b = {k: batch[k] for k in ("frames", "frame_mask")}
    g = greedy_decode(params, BF16, b, maxlen=8)
    bm = beam_decode(params, BF16, b, beam_size=3, maxlen=8)
    assert np.isfinite(np.asarray(g.scores)).all()
    assert np.isfinite(np.asarray(bm.scores)).all()


def test_bf16_training_converges():
    ds = synthetic_dataset(n_videos=8, captions_per_video=1,
                           k=BF16.n_frames, d=BF16.ctx_dim, maxlen=10,
                           seed=0)
    dev = ds.bank.to_device()
    batch = gather_batch(dev, ds.captions, np.arange(8, dtype=np.int32))
    cfg = dataclasses.replace(BF16, use_dropout=False)
    tcfg = TrainConfig(optimizer="adam", lr=3e-3, batch_size=8, clip_c=5.0)
    state = init_train_state(jax.random.PRNGKey(0), cfg, tcfg)
    step = make_train_step(cfg, tcfg)
    state, m0 = step(state, batch)
    l0 = float(m0["loss"])
    for _ in range(200):
        state, m = step(state, batch)
    assert np.isfinite(float(m["loss"]))
    assert float(m["loss"]) < 0.5 * l0
