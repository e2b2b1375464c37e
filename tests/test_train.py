"""Training-loop tests: overfit-to-exact-recovery (the SURVEY.md §4
integration test), checkpoint resume, optimizers, fit() end-to-end."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stvd.config import Config, DataConfig, DecodeConfig, ModelConfig, TrainConfig
from stvd.data.batching import gather_batch, synthetic_dataset
from stvd.decode.greedy import greedy_decode
from stvd.train.loop import (fit, init_train_state, make_train_step,
                             restore_checkpoint, save_checkpoint)

MCFG = ModelConfig(n_words=48, dim_word=16, dim=32, ctx_dim=32, n_frames=6,
                   compute_dtype="float32", use_dropout=False)
TCFG = TrainConfig(optimizer="adam", lr=3e-3, batch_size=8, clip_c=5.0)


def _data():
    ds = synthetic_dataset(n_videos=8, captions_per_video=1, k=6, d=32,
                           maxlen=10, seed=0)
    dev = ds.bank.to_device()
    batch = gather_batch(dev, ds.captions, np.arange(8, dtype=np.int32))
    return ds, batch


def test_overfit_exact_caption_recovery():
    """Train to ~zero NLL on 8 synthetic videos; greedy decode must
    reproduce every teacher caption exactly (SURVEY.md §4)."""
    ds, batch = _data()
    state = init_train_state(jax.random.PRNGKey(0), MCFG, TCFG)
    step = make_train_step(MCFG, TCFG)
    m = {}
    for i in range(1500):
        state, m = step(state, batch)
        if i % 100 == 99 and float(m["nll_per_token"]) < 0.03:
            break
    assert float(m["nll_per_token"]) < 0.1, float(m["nll_per_token"])
    out = greedy_decode(state["params"], MCFG,
                        {"frames": batch["frames"],
                         "frame_mask": batch["frame_mask"]}, maxlen=10)
    toks = np.asarray(out.tokens)
    gold = np.asarray(batch["tokens"])
    gm = np.asarray(batch["token_mask"])
    for i in range(8):
        L = int(gm[i].sum())
        assert toks[i][:L].tolist() == gold[i][:L].tolist(), (
            i, ds.vocab.decode(toks[i]), ds.vocab.decode(gold[i]))


def test_checkpoint_roundtrip(tmp_path):
    """Params + optimizer state + step + rng restore bit-identically
    (the reference drops optimizer state on reload — we must not)."""
    _, batch = _data()
    state = init_train_state(jax.random.PRNGKey(1), MCFG, TCFG)
    step = make_train_step(MCFG, TCFG)
    for _ in range(3):
        state, _ = step(state, batch)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)
    template = init_train_state(jax.random.PRNGKey(2), MCFG, TCFG)
    restored = restore_checkpoint(path, template)
    flat_a = jax.tree.leaves(jax.device_get(state))
    flat_b = jax.tree.leaves(jax.device_get(restored))
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # resuming from the restored state continues identically
    s1, m1 = step(dict(state), batch)
    s2, m2 = step(dict(restored), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-6)


def test_scheduled_sampling_trains():
    """ss_prob > 0 (per-step logits + sampled inputs inside the scan)
    still reduces the loss."""
    _, batch = _data()
    tcfg = dataclasses.replace(TCFG, ss_prob=0.25)
    state = init_train_state(jax.random.PRNGKey(0), MCFG, tcfg)
    step = make_train_step(MCFG, tcfg)
    state, m0 = step(state, batch)
    l0 = float(m0["loss"])
    for _ in range(150):
        state, m = step(state, batch)
    assert float(m["loss"]) < 0.7 * l0


def test_adadelta_default_recipe_converges():
    """The reference's default optimizer (adadelta, lr-insensitive) must
    make steady progress on the overfit task."""
    _, batch = _data()
    tcfg = dataclasses.replace(TCFG, optimizer="adadelta", lr=1.0)
    state = init_train_state(jax.random.PRNGKey(0), MCFG, tcfg)
    step = make_train_step(MCFG, tcfg)
    state, m0 = step(state, batch)
    l0 = float(m0["loss"])
    for _ in range(300):
        state, m = step(state, batch)
    assert float(m["loss"]) < 0.5 * l0, (l0, float(m["loss"]))


def test_adadelta_slot_dtype_f32_bit_exact():
    """_adadelta_slot_dtype(f32) must be BIT-exact vs optax.adadelta
    over a multi-step trajectory — same math, different storage plumbing
    (the bf16 path reuses this code with only the cast changed)."""
    from stvd.train.loop import _adadelta_slot_dtype
    import optax

    params = {"a": jnp.linspace(-1.0, 1.0, 64).reshape(8, 8),
              "b": jnp.ones((16,)) * 0.3}
    ref = optax.adadelta(learning_rate=1.0)
    new = _adadelta_slot_dtype(1.0, jnp.float32)
    st_r, st_n = ref.init(params), new.init(params)
    p_r = p_n = params
    key = jax.random.PRNGKey(0)
    for i in range(5):
        key, k = jax.random.split(key)
        g = {"a": jax.random.normal(k, (8, 8)) * 0.1,
             "b": jnp.full((16,), 0.01 * (i + 1))}
        u_r, st_r = ref.update(g, st_r, p_r)
        u_n, st_n = new.update(g, st_n, p_n)
        p_r = optax.apply_updates(p_r, u_r)
        p_n = optax.apply_updates(p_n, u_n)
    for k in p_r:
        np.testing.assert_array_equal(np.asarray(p_r[k]),
                                      np.asarray(p_n[k]), err_msg=k)


def test_adadelta_bf16_slots_trains_close_to_f32():
    """bf16 accumulator storage must track the f32 trajectory on the
    overfit task (adadelta's per-coordinate normalization absorbs the
    ~0.4% slot rounding) and the slots must actually BE bf16."""
    _, batch = _data()
    tcfg32 = dataclasses.replace(TCFG, optimizer="adadelta", lr=1.0)
    tcfg16 = dataclasses.replace(tcfg32, opt_slot_dtype="bfloat16")
    losses = {}
    for name, tcfg in (("f32", tcfg32), ("bf16", tcfg16)):
        state = init_train_state(jax.random.PRNGKey(0), MCFG, tcfg)
        if name == "bf16":
            leaves = jax.tree.leaves(state["opt_state"])
            assert all(x.dtype == jnp.bfloat16 for x in leaves)
        step = make_train_step(MCFG, tcfg)
        for _ in range(200):
            state, m = step(state, batch)
        losses[name] = float(m["loss"])
    # same convergence class: within 10% relative after 200 steps
    assert abs(losses["bf16"] - losses["f32"]) < 0.1 * losses["f32"] + 0.05, \
        losses


def test_graves_rmsprop_pins_reference_math():
    """graves_rmsprop must match a NumPy transcription of the
    reference's update equations (common.py:§rmsprop — Graves centered
    variant, momentum 0.9, decay 0.95, eps 1e-4, hardcoded 1e-4 step)
    over a multi-step trajectory, bit-for-bit in f32."""
    import optax
    from stvd.train.loop import graves_rmsprop

    params = {"a": jnp.linspace(-1.0, 1.0, 64, dtype=jnp.float32
                                ).reshape(8, 8),
              "b": jnp.full((16,), 0.3, jnp.float32)}
    opt = graves_rmsprop()
    st = opt.init(params)
    p = params
    # NumPy reference state (f32 throughout, same op order)
    ref = {k: np.asarray(v, np.float32) for k, v in params.items()}
    rg = {k: np.zeros_like(v) for k, v in ref.items()}
    rg2 = {k: np.zeros_like(v) for k, v in ref.items()}
    ud = {k: np.zeros_like(v) for k, v in ref.items()}
    key = jax.random.PRNGKey(7)
    f32 = np.float32
    for i in range(5):
        key, k1 = jax.random.split(key)
        g = {"a": jax.random.normal(k1, (8, 8), jnp.float32) * 0.1,
             "b": jnp.full((16,), 0.01 * (i + 1), jnp.float32)}
        u, st = opt.update(g, st)
        p = optax.apply_updates(p, u)
        for name in ref:
            gn = np.asarray(g[name], np.float32)
            rg[name] = f32(0.95) * rg[name] + f32(0.05) * gn
            rg2[name] = f32(0.95) * rg2[name] + f32(0.05) * (gn * gn)
            ud[name] = (f32(0.9) * ud[name]
                        - (f32(1e-4) * gn)
                        / np.sqrt(rg2[name] - rg[name] * rg[name]
                                  + f32(1e-4)))
            ref[name] = ref[name] + ud[name]
    for name in ref:
        np.testing.assert_array_equal(np.asarray(p[name]), ref[name],
                                      err_msg=name)


def test_rmsprop_ignores_configured_lr():
    """The reference quirk, pinned: common.py:§rmsprop's f_update takes
    lr but never uses it (on_unused_input='ignore') — trajectories are
    identical for any configured lr."""
    _, batch = _data()
    states = []
    for lr in (0.5, 5.0):
        tcfg = dataclasses.replace(TCFG, optimizer="rmsprop", lr=lr)
        state = init_train_state(jax.random.PRNGKey(0), MCFG, tcfg)
        step = make_train_step(MCFG, tcfg)
        for _ in range(3):
            state, _ = step(state, batch)
        states.append(jax.device_get(state["params"]["Wemb"]))
    np.testing.assert_array_equal(states[0], states[1])


def test_sgd_is_reference_exact():
    """common.py:§sgd is plain p -= lr*g; pin that our optax.sgd
    mapping emits exactly -lr*g (no momentum/weight-decay surprises)."""
    from stvd.train.loop import make_optimizer
    from stvd.config import TrainConfig

    tcfg = TrainConfig(optimizer="sgd", lr=0.25, clip_c=0.0)
    opt = make_optimizer(tcfg)
    params = {"w": jnp.linspace(-2.0, 2.0, 32, dtype=jnp.float32)}
    g = {"w": jnp.linspace(0.5, -0.5, 32, dtype=jnp.float32)}
    u, _ = opt.update(g, opt.init(params), params)
    np.testing.assert_array_equal(
        np.asarray(u["w"]),
        np.float32(-0.25) * np.asarray(g["w"], np.float32))


def test_rmsprop_bf16_slots_storage():
    """opt_slot_dtype='bfloat16' applies to rmsprop's three slots too
    (same storage plumbing as the adadelta bf16-slot variant)."""
    tcfg = dataclasses.replace(TCFG, optimizer="rmsprop",
                               opt_slot_dtype="bfloat16")
    state = init_train_state(jax.random.PRNGKey(0), MCFG, tcfg)
    leaves = jax.tree.leaves(state["opt_state"])
    assert leaves and all(x.dtype == jnp.bfloat16 for x in leaves)


@pytest.mark.parametrize("opt", ["adadelta", "sgd", "rmsprop"])
def test_optimizers_update_params(opt):
    _, batch = _data()
    tcfg = dataclasses.replace(TCFG, optimizer=opt, lr=0.5)
    state = init_train_state(jax.random.PRNGKey(0), MCFG, tcfg)
    p0 = jax.device_get(state["params"]["Wemb"])
    step = make_train_step(MCFG, tcfg)
    state, m = step(state, batch)
    p1 = jax.device_get(state["params"]["Wemb"])
    assert np.isfinite(float(m["loss"]))
    assert np.abs(p1 - p0).max() > 0


def test_fit_end_to_end(tmp_path):
    """Full fit(): epochs, validation scoring, best-checkpoint save,
    metrics JSONL (reference train() driver behaviors — SURVEY.md §3.1)."""
    cfg = Config(
        model=MCFG,
        train=dataclasses.replace(
            TCFG, max_epochs=6, valid_freq=2, save_freq=4, disp_freq=1,
            sample_freq=3, patience=50, valid_batch_size=8, maxlen=10,
            save_dir=str(tmp_path / "run"), metric="bleu4"),
        decode=DecodeConfig(beam_size=1, maxlen=10, decode_batch=4),
        data=DataConfig(dataset="synthetic", synthetic_videos=8),
    )
    train_ds = synthetic_dataset(n_videos=8, captions_per_video=1, k=6,
                                 d=32, maxlen=10, seed=0)
    valid_ds = synthetic_dataset(n_videos=4, captions_per_video=1, k=6,
                                 d=32, maxlen=10, seed=1)
    res = fit(cfg, train_ds, valid_ds, max_updates=4)
    assert res.history, "validation should have run"
    assert "Bleu_4" in res.history[0]
    assert os.path.exists(os.path.join(cfg.train.save_dir, "ckpt_best"))
    assert os.path.exists(os.path.join(cfg.train.save_dir, "metrics.jsonl"))
    assert os.path.exists(os.path.join(cfg.train.save_dir,
                                       "valid_samples.txt"))
    with open(os.path.join(cfg.train.save_dir, "metrics.jsonl")) as f:
        kinds = {__import__("json").loads(l)["kind"] for l in f}
    assert {"train", "valid", "sample", "best"} <= kinds


def test_fit_with_pallas_kernel(tmp_path):
    """fit() end-to-end with the fused logit-tail step (interpret mode):
    validation beam decodes run the kernel, training the XLA scan."""
    import functools
    from stvd.model import kernel as kmod
    step_fn = kmod.make_tail_step(interpret=True)
    step_fn.make_logit_tail = functools.partial(
        kmod.make_logit_tail, interpret=True, tr=16, tv=64, tk=64,
        splits=2)
    mcfg = dataclasses.replace(MCFG, n_words=1024, dim_word=64)
    cfg = Config(
        model=mcfg,
        train=dataclasses.replace(
            TCFG, max_epochs=3, valid_freq=2, save_freq=0, disp_freq=100,
            sample_freq=0, valid_batch_size=8, maxlen=10,
            save_dir=str(tmp_path / "krun"), metric="bleu4"),
        decode=DecodeConfig(beam_size=2, maxlen=10, decode_batch=4),
    )
    train_ds = synthetic_dataset(n_videos=8, captions_per_video=1, k=6,
                                 d=32, maxlen=10, seed=0)
    valid_ds = synthetic_dataset(n_videos=4, captions_per_video=1, k=6,
                                 d=32, maxlen=10, seed=1)
    res = fit(cfg, train_ds, valid_ds, step_fn=step_fn, max_updates=3)
    assert res.history


def test_fit_reload_resumes(tmp_path):
    """reference `reload_`: restarting fit() with reload_=True continues
    from the saved step instead of reinitializing."""
    base = dataclasses.replace(
        TCFG, max_epochs=8, valid_freq=0, save_freq=2, disp_freq=100,
        sample_freq=0, maxlen=10, save_dir=str(tmp_path / "run"))
    cfg = Config(model=MCFG, train=base,
                 decode=DecodeConfig(beam_size=1, maxlen=10))
    train_ds = synthetic_dataset(n_videos=8, captions_per_video=1, k=6,
                                 d=32, maxlen=10, seed=0)
    res1 = fit(cfg, train_ds, None, max_updates=4)
    assert int(res1.state["step"]) == 4
    cfg2 = Config(model=MCFG,
                  train=dataclasses.replace(base, reload_=True),
                  decode=DecodeConfig(beam_size=1, maxlen=10))
    res2 = fit(cfg2, train_ds, None, max_updates=6)
    # resumed from step 4 (the final checkpoint), trained 2 more
    assert int(res2.state["step"]) == 6


def test_early_stop_state_survives_resume(tmp_path, monkeypatch):
    """Reference train() persists history_errs with the model (SURVEY.md
    §5).  A resumed run must (a) keep the saved best, so a worse
    validation does NOT overwrite ckpt_best, and (b) continue counting
    patience from the saved bad_rounds instead of restarting."""
    import stvd.train.loop as loop_mod

    base = dataclasses.replace(
        TCFG, max_epochs=50, valid_freq=2, save_freq=2, disp_freq=100,
        sample_freq=0, patience=3, valid_batch_size=8, maxlen=10,
        save_dir=str(tmp_path / "run"), metric="bleu4")
    cfg = Config(model=MCFG, train=base,
                 decode=DecodeConfig(beam_size=1, maxlen=10, decode_batch=4))
    train_ds = synthetic_dataset(n_videos=8, captions_per_video=1, k=6,
                                 d=32, maxlen=10, seed=0)
    valid_ds = synthetic_dataset(n_videos=4, captions_per_video=1, k=6,
                                 d=32, maxlen=10, seed=1)
    res1 = fit(cfg, train_ds, valid_ds, max_updates=4)
    assert res1.history
    best1 = res1.best_metric
    assert os.path.exists(os.path.join(base.save_dir, "fit_state.json"))

    # resume with every validation forced WORSE than the saved best
    monkeypatch.setattr(
        loop_mod, "evaluate_split",
        lambda *a, **k: {"Bleu_1": -1.0, "Bleu_2": -1.0, "Bleu_3": -1.0,
                         "Bleu_4": -1.0, "METEOR": -1.0, "ROUGE_L": -1.0,
                         "CIDEr": -1.0})
    saved_paths = []
    real_save = loop_mod.save_checkpoint
    monkeypatch.setattr(
        loop_mod, "save_checkpoint",
        lambda p, s: (saved_paths.append(p), real_save(p, s)))
    cfg2 = Config(model=MCFG, train=dataclasses.replace(base, reload_=True),
                  decode=DecodeConfig(beam_size=1, maxlen=10, decode_batch=4))
    res2 = fit(cfg2, train_ds, valid_ds, max_updates=20)
    # the stale best survived the reload and was never overwritten
    assert res2.best_metric == best1
    assert not any(p.endswith("ckpt_best") for p in saved_paths)
    # patience kept counting: 3 worse rounds after resume -> early stop
    # well before max_updates (validations at 6, 8, 10)
    assert res2.bad_rounds >= 3
    assert int(res2.state["step"]) <= 10


def test_executable_caches_key_on_objects():
    """Decoder/eval caches must key on the step_fn object itself (which
    keeps it alive), never id(): after GC a recycled id could serve a
    stale executable compiled for a different function."""
    import stvd.train.evaluate as ev
    import stvd.train.loop as loop_mod
    from stvd.model import step as step_mod

    dcfg = DecodeConfig(beam_size=1, maxlen=4, decode_batch=2)

    def mk():
        def sf(*a, **kw):
            return step_mod.step(*a, **kw)
        return sf

    f1, f2 = mk(), mk()
    d1 = ev._decoder_fn(MCFG, dcfg, f1)
    d2 = ev._decoder_fn(MCFG, dcfg, f2)
    assert d1 is not d2                      # distinct fns -> distinct entries
    assert ev._decoder_fn(MCFG, dcfg, f1) is d1   # stable on re-query
    e1 = loop_mod.make_eval_nll(MCFG, f1)
    e2 = loop_mod.make_eval_nll(MCFG, f2)
    assert e1 is not e2
    # the caches hold the function objects, so they can't be GC'd while
    # cached (id-reuse is structurally impossible)
    assert any(f1 in k for k in ev._DECODER_CACHE)
    assert any(f1 in k for k in loop_mod._EVAL_NLL_CACHE)


def test_fit_length_bucketed_converges(tmp_path):
    """Bucketed training (train.length_buckets) reaches the same loss
    regime as unbucketed on the same data: the buckets only remove
    all-masked scan steps, so per-example losses are identical and only
    batch composition order differs."""
    def run(buckets, seed_dir):
        cfg = Config(
            model=MCFG,
            train=dataclasses.replace(
                TCFG, max_epochs=40, valid_freq=0, save_freq=0,
                disp_freq=10, sample_freq=0, maxlen=10,
                length_buckets=buckets,
                save_dir=str(tmp_path / seed_dir)),
            decode=DecodeConfig(beam_size=1, maxlen=10, decode_batch=4),
            data=DataConfig(dataset="synthetic", synthetic_videos=8),
        )
        # caption lengths 4-8 + eos vs maxlen 10: both buckets exercise
        train_ds = synthetic_dataset(n_videos=8, captions_per_video=1,
                                     k=6, d=32, maxlen=10, seed=0)
        res = fit(cfg, train_ds, None, max_updates=40)
        return float(res.history[-1]["nll"]) if res.history else None

    from stvd.train.loop import evaluate_nll
    import json as _json

    # run bucketed; read final train loss from metrics.jsonl
    for buckets, d in (("6,10", "bucketed"), ("", "plain")):
        cfg_dir = tmp_path / d
        run(buckets, d)
    losses = {}
    for d in ("bucketed", "plain"):
        with open(os.path.join(str(tmp_path / d), "metrics.jsonl")) as f:
            rows = [_json.loads(l) for l in f]
        losses[d] = [r["loss"] for r in rows if r["kind"] == "train"][-1]
    # same data, same model: end in the same loss regime
    assert losses["bucketed"] < losses["plain"] * 1.5 + 1.0


def test_fit_profile_window(tmp_path):
    """train.profile_dir captures a jax.profiler trace of the configured
    update window and logs a 'profile' row (SURVEY.md §5 tracing)."""
    import glob
    import json as _json
    prof = str(tmp_path / "trace")
    cfg = Config(
        model=MCFG,
        train=dataclasses.replace(
            TCFG, max_epochs=4, valid_freq=0, disp_freq=10, sample_freq=0,
            maxlen=10, save_dir=str(tmp_path / "run"),
            profile_dir=prof, profile_start=1, profile_steps=2),
        decode=DecodeConfig(beam_size=1, maxlen=10, decode_batch=4),
        data=DataConfig(dataset="synthetic", synthetic_videos=8),
    )
    train_ds = synthetic_dataset(n_videos=8, captions_per_video=1, k=6,
                                 d=32, maxlen=10, seed=0)
    fit(cfg, train_ds, None, max_updates=4)
    assert glob.glob(os.path.join(prof, "plugins", "profile", "*", "*")), \
        "profiler trace files should exist"
    with open(os.path.join(cfg.train.save_dir, "metrics.jsonl")) as f:
        rows = [_json.loads(l) for l in f]
    prow = [r for r in rows if r["kind"] == "profile"]
    assert prow and prow[0]["steps"] == 2


@pytest.mark.parametrize("accum", [2, 4])
def test_grad_accum_exact_parity(accum):
    """train.grad_accum=N must produce the SAME optimizer step as the
    full batch: gradients of the summed objective accumulate across
    microbatches and ONE weighted-mean divide happens at the end, so
    non-uniform wrap-padding weights split unevenly across microbatches
    still give the exact full-batch gradient (dropout off -> the only
    rng consumer is gone and parity is FP-exactness-tight).  SGD keeps
    updates proportional to gradients; adaptive optimizers would
    amplify the FP noise of true-zero gradients (c_att's softmax
    shift-invariance) to lr-scale differences."""
    ds, batch = _data()
    batch = dict(batch)
    # weights deliberately unequal BETWEEN microbatches: a naive
    # mean-of-microbatch-means would be wrong by construction here
    batch["weight"] = jnp.asarray([1.0, 1.0, 0.25, 2.0, 1.0, 0.0, 3.0, 1.0])
    tcfg = dataclasses.replace(TCFG, optimizer="sgd", lr=0.5)
    # two independent states (donate_state would free shared buffers)
    s_full = init_train_state(jax.random.PRNGKey(0), MCFG, tcfg)
    s_acc = init_train_state(jax.random.PRNGKey(0), MCFG, tcfg)
    step_full = make_train_step(MCFG, tcfg)
    step_acc = make_train_step(
        MCFG, dataclasses.replace(tcfg, grad_accum=accum))
    for _ in range(3):
        s_full, m_full = step_full(s_full, batch)
        s_acc, m_acc = step_acc(s_acc, batch)
    for k in ("loss", "nll", "nll_per_token", "grad_norm"):
        np.testing.assert_allclose(float(m_acc[k]), float(m_full[k]),
                                   rtol=2e-5, err_msg=k)
    for k in s_full["params"]:
        np.testing.assert_allclose(np.asarray(s_acc["params"][k]),
                                   np.asarray(s_full["params"][k]),
                                   rtol=2e-4, atol=1e-6, err_msg=k)


def test_grad_accum_spatial_fused_vjp():
    """grad_accum composes with the spatial fused sequence VJP (the
    config it exists FOR: config-2 memory pressure) — the custom-VJP
    scan runs inside the microbatch scan and still matches the
    full-batch step."""
    m = dataclasses.replace(MCFG, use_spatial=True, n_regions=4,
                            region_dim=16)
    ds = synthetic_dataset(n_videos=8, captions_per_video=1, k=6, d=32,
                           n_regions=4, region_dim=16, maxlen=10, seed=1)
    dev = ds.bank.to_device()
    batch = gather_batch(dev, ds.captions, np.arange(8, dtype=np.int32))
    tcfg = dataclasses.replace(TCFG, optimizer="sgd", lr=0.5)
    s_full = init_train_state(jax.random.PRNGKey(0), m, tcfg)
    s_acc = init_train_state(jax.random.PRNGKey(0), m, tcfg)
    step_full = make_train_step(m, tcfg)
    step_acc = make_train_step(m, dataclasses.replace(tcfg, grad_accum=2))
    s_full, m_full = step_full(s_full, batch)
    s_acc, m_acc = step_acc(s_acc, batch)
    np.testing.assert_allclose(float(m_acc["loss"]), float(m_full["loss"]),
                               rtol=2e-5)
    for k in s_full["params"]:
        np.testing.assert_allclose(np.asarray(s_acc["params"][k]),
                                   np.asarray(s_full["params"][k]),
                                   rtol=2e-4, atol=1e-6, err_msg=k)


def test_grad_accum_config_guards():
    from stvd.config import validate
    with pytest.raises(ValueError, match="divisible"):
        validate(Config(train=dataclasses.replace(TCFG, grad_accum=3)))
    with pytest.raises(ValueError, match="single-device"):
        validate(Config(train=dataclasses.replace(
            TCFG, grad_accum=2, data_parallel=True)))
    with pytest.raises(ValueError, match="single-device"):
        from stvd.train.parallel import make_mesh
        make_train_step(MCFG, dataclasses.replace(TCFG, grad_accum=2),
                        mesh=make_mesh())


@pytest.mark.parametrize("slot_dtype", ["float32", "bfloat16"])
def test_checkpoint_keeps_dtypes(tmp_path, slot_dtype):
    """The npz checkpoint stores every leaf in its own dtype, bfloat16
    optimizer slots included (numpy cannot name bf16: stored as bits)."""
    tcfg = dataclasses.replace(TCFG, optimizer="adadelta", lr=1.0,
                               opt_slot_dtype=slot_dtype)
    state = init_train_state(jax.random.PRNGKey(1), MCFG, tcfg)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)
    restored = restore_checkpoint(
        path, init_train_state(jax.random.PRNGKey(2), MCFG, tcfg))
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    assert any(leaf.dtype == jnp.bfloat16
               for leaf in jax.tree.leaves(restored)) == \
        (slot_dtype == "bfloat16")


def test_checkpoint_keys_by_tree_path(tmp_path):
    """Entries are keyed by the leaf's tree path, so the file reads
    without the program (and a renamed param is a clear error)."""
    import json
    state = init_train_state(jax.random.PRNGKey(1), MCFG, TCFG)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)
    with np.load(os.path.join(path, "state.npz")) as z:
        keys = set(z.files)
        dtypes = json.loads(str(z["__dtypes__"]))
        np.testing.assert_array_equal(z["['params']['U']"],
                                      np.asarray(state["params"]["U"]))
    assert "['step']" in keys and "['rng']" in keys
    assert set(dtypes) == keys - {"__dtypes__"}
    template = init_train_state(jax.random.PRNGKey(1), MCFG, TCFG)
    template["params"]["U_renamed"] = template["params"].pop("U")
    with pytest.raises(KeyError, match="U_renamed"):
        restore_checkpoint(path, template)


def test_checkpoint_shape_mismatch_raises(tmp_path):
    state = init_train_state(jax.random.PRNGKey(1), MCFG, TCFG)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)
    other = dataclasses.replace(MCFG, dim=40)
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(path, init_train_state(jax.random.PRNGKey(1),
                                                  other, TCFG))


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """A save that dies mid-write leaves the previous checkpoint whole
    (the file is written under a temporary name, then renamed)."""
    state = init_train_state(jax.random.PRNGKey(1), MCFG, TCFG)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)
    before = open(os.path.join(path, "state.npz"), "rb").read()

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError):
        save_checkpoint(path, state)
    assert open(os.path.join(path, "state.npz"), "rb").read() == before
