#!/usr/bin/env python3
"""Smoke run of stvd's main path on NVIDIA GPUs, at full model width.

    python chip_smoke.py [--seed N] [--workdir DIR] [--keep]
    python chip_smoke.py --four          # four-GPU phase only

One process drives, in order, through the entry points a user calls:

  device   require a GPU; print the card's name and power limit
  train    ``stvd.cli.train`` at ``preset("msvd-beam")`` widths (dim 3584,
           vocab 13,056, K=28, bf16): a few updates at batch 64 with one
           METEOR validation round and a checkpoint save; then the fused
           sequence VJP against autodiff of the float32 step
  decode   ``Captioner.from_run_dir`` beam-5 and greedy on 64 videos; the
           production bf16 step, its fused logit tail and the int8 step
           against the float32 reference step
  spatial  the same at ``preset("msvd-spatial")`` widths (R=49 regions)
  export   ``stvd.cli.export --check`` for ``cuda``; the artifact must
           match the live Captioner token for token
  serve    ``cli.serve.build_server`` in-process on a thread, answering
           ``request_captions`` and ``request_caption_ids``

``--four`` runs only data-parallel training (pjit and shard_map paths)
against one GPU running the same global batch, and the sharded-bank id
decode against the single-device one.  Weights and data come from
``--seed``.  Every phase's failure is fatal.  The last line of output is
``{"ok": true, "device": {...}}``; on a machine without a GPU, or
without the rest of the repository beside this file, the script exits
non-zero before printing it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))

PHASES = ("device", "train", "decode", "spatial", "export", "serve")
FOUR_PHASES = ("device", "four")

# Tolerances (each printed beside its measured value)
TOL_SEQGRAD = 1e-3   # f32 at precision=highest on both sides; only the
#                      summation order differs (hand VJP vs autodiff)
TOL_STEP_HC = 2e-2   # bf16 vs f32 step, |h|,|c| <= 1: bf16 operands carry
#                      8 mantissa bits (2^-9 rounding), sums of 5k terms
TOL_STEP_LOGP = 2e-2  # bf16 vs f32 vocab log-probabilities, same reason
TOL_INT8_HC = 5e-2   # int8 vs bf16 step: per-row/per-column symmetric
#                      int8 keeps ~1/254 of each row's and column's range
TOL_DP = 5e-2        # 4-GPU vs 1-GPU parameter update, relative L2: bf16
#                      gradients summed in another order; adadelta
#                      normalizes per coordinate, so near-zero gradients
#                      may flip sign


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU phase")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and data")
    ap.add_argument("--workdir", default=os.path.join(HERE, "runs",
                                                      "chip_smoke"),
                    help="scratch directory for run dirs and artifacts "
                         "(removed at the end unless --keep)")
    ap.add_argument("--keep", action="store_true")
    return ap.parse_args(argv)


def phases_for(args):
    return FOUR_PHASES if args.four else PHASES


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def _maxabs(a, b) -> float:
    import numpy as np
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _report(name: str, value: float, tol: float, note: str = "") -> None:
    say(f"  {name}: {value:.3e} (tolerance {tol:.0e}{note})")
    check(value <= tol, f"{name} {value:.3e} exceeds {tol:.0e}")


def _train_cli(run_dir: str, preset: str, updates: int, seed: int,
               extra=()) -> None:
    from stvd.cli import train as train_cli
    sets = [f"train.save_dir={run_dir}", "train.batch_size=64",
            f"train.seed={seed}", "train.disp_freq=1",
            "train.sample_freq=0", "train.valid_batch_size=64"] + list(extra)
    argv = ["--preset", preset, "--max-updates", str(updates)]
    for s in sets:
        argv += ["--set", s]
    check(train_cli.main(argv) == 0, "cli.train failed")


def _records(run_dir: str, kind: str):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if r.get("kind") == kind]


def _videos(cfg, n: int, seed: int):
    """A synthetic bank at the config's widths and its device batch."""
    import jax.numpy as jnp
    from stvd.data.batching import synthetic_dataset
    m = cfg.model
    ds = synthetic_dataset(
        n_videos=n, captions_per_video=1, k=m.n_frames, d=m.ctx_dim,
        n_regions=m.n_regions if m.use_spatial else 0,
        region_dim=m.region_dim, maxlen=cfg.decode.maxlen, seed=seed,
        n_words=m.n_words)
    dev = ds.bank.to_device(dtype=jnp.dtype(m.compute_dtype))
    keys = ["frames", "frame_mask"] + (["regions"] if m.use_spatial else [])
    return ds, {k: dev[k] for k in keys}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(S):
    import jax
    say(f"card: {card_line()}")
    d = jax.devices()[0]
    say(f"jax {jax.__version__}: {len(jax.devices())} x {d.device_kind} "
        f"({d.platform})")


def phase_train(S):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from stvd.config import preset
    from stvd.data.batching import gather_batch, synthetic_dataset
    from stvd.model.decoder import init_params
    from stvd.train.loss import loss_fn

    run_dir = os.path.join(S.workdir, "msvd-beam")
    _train_cli(run_dir, "msvd-beam", 4, S.seed,
               ["train.valid_freq=4", "train.save_freq=4",
                "data.synthetic_videos=256"])
    losses = [r["loss"] for r in _records(run_dir, "train")]
    check(len(losses) == 4 and all(np.isfinite(losses)),
          f"train losses {losses}")
    valid = _records(run_dir, "valid")
    check(len(valid) == 1 and np.isfinite(valid[0]["METEOR"]),
          f"validation records {valid}")
    check(os.path.exists(os.path.join(run_dir, "ckpt", "state.npz")),
          "no checkpoint written")
    say(f"  4 updates at batch 64: loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
        f"valid METEOR {valid[0]['METEOR']:.4f}; checkpoint saved")
    S.run_dir = run_dir

    # fused sequence VJP vs autodiff of the f32 reference step
    m = dataclasses.replace(preset("msvd-beam").model,
                            compute_dtype="float32", use_dropout=False)
    ds = synthetic_dataset(n_videos=32, captions_per_video=1,
                           k=m.n_frames, d=m.ctx_dim, maxlen=30,
                           seed=S.seed + 1, n_words=m.n_words)
    batch = gather_batch(ds.bank.to_device(), ds.captions,
                         np.arange(32, dtype=np.int32))
    params = init_params(jax.random.PRNGKey(S.seed), m)

    def grads(cfg):
        return jax.jit(jax.grad(
            lambda p: loss_fn(p, cfg, batch, train=False)[0]))(params)

    with jax.default_matmul_precision("highest"):
        g_hand = grads(m)
        g_auto = grads(dataclasses.replace(m, fused_seq_grad=False))
    check(all(bool(jnp.all(jnp.isfinite(g))) for g in g_hand.values()),
          "non-finite fused-VJP gradient")
    # normalized by the largest gradient entry of the whole model: some
    # leaves (c_att) have an exactly-zero true gradient, so a per-leaf
    # relative error would divide rounding noise by zero
    scale = max(float(jnp.max(jnp.abs(g))) for g in g_auto.values())
    errs = {k: _maxabs(g_hand[k], g_auto[k]) / scale for k in g_auto}
    worst = max(errs, key=errs.get)
    _report("seqgrad vs autodiff, max |gradient error| / max |gradient|",
            errs[worst], TOL_SEQGRAD,
            f", f32, precision=highest, batch 32, worst leaf {worst}")


def _step_compare(S, cap, batch):
    """Production bf16 step (and its fused tail, and int8) against the
    float32 reference step on the same (h, c, emb) at full width."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from stvd.model import step as smod
    from stvd.model.decoder import encode_context

    params = cap.params
    m = cap.cfg.model
    m32 = dataclasses.replace(m, compute_dtype="float32")
    beam = cap.cfg.decode.beam_size
    n = batch["frames"].shape[0]
    rng = np.random.RandomState(S.seed)
    toks = jnp.asarray(rng.randint(4, m.n_words, n * beam), jnp.int32)

    def run(mc, p, b, toks, st=None):
        # everything is an argument: captured arrays would become
        # constants that XLA spends minutes folding
        p = smod.cast_params(p, mc)
        b = {k: v.astype(jnp.float32) for k, v in b.items()}
        ctx = encode_context(p, mc, b["frames"])
        sc = smod.precompute(p, mc, ctx, b["frame_mask"], b.get("regions"))
        if st is None:
            st = smod.init_state(p, mc, sc)
            st = smod.StepState(jnp.repeat(st.h, beam, 0),
                                jnp.repeat(st.c, beam, 0))
        emb = p["Wemb"][toks].astype(jnp.float32)
        out = smod.step(p, mc, st, sc, emb)
        act = smod.logit_activation(p, mc, out.h, out.ctx_t, emb)
        logits = smod._dot(act, p["ff_logit_W"],
                           jnp.dtype(mc.compute_dtype)) + p["ff_logit_b"]
        return st, out, act, jax.nn.log_softmax(logits, axis=-1)

    with jax.default_matmul_precision("highest"):
        st, ref, _, ref_logp = jax.jit(
            lambda p, b, t: run(m32, p, b, t))(params, batch, toks)
    _, out, act, logp = jax.jit(
        lambda p, b, t, s: run(m, p, b, t, s))(params, batch, toks, st)
    _report("bf16 step vs f32 step, max |h| error", _maxabs(out.h, ref.h),
            TOL_STEP_HC, f", {n * beam} rows")
    _report("bf16 step vs f32 step, max |c| error", _maxabs(out.c, ref.c),
            TOL_STEP_HC)
    _report("bf16 step vs f32 step, max |log p| error",
            _maxabs(logp, ref_logp), TOL_STEP_LOGP, f", {m.n_words:,} words")

    mk_tail = getattr(cap.step_fn, "make_logit_tail", None)
    check(mk_tail is not None, "production step carries no logit tail")
    p = smod.cast_params(params, m)
    tail = mk_tail(p["ff_logit_W"], p["ff_logit_b"], beam)
    check(tail is not None, "the logit tail declined the msvd-beam shape")
    vals, idx, lse = jax.jit(tail)(act)
    tail_logp = vals - lse[:, None]
    ref_at = jnp.take_along_axis(ref_logp, idx, axis=1)
    _report("Triton logit tail top-5 log p vs f32 reference",
            _maxabs(tail_logp, ref_at), TOL_STEP_LOGP)
    _, xla_idx = jax.lax.top_k(logp, beam)
    say(f"  tail top-5 index agreement with the bf16 XLA path: "
        f"{float(jnp.mean(idx == xla_idx)):.4f} (not asserted: near-ties)")

    m8 = dataclasses.replace(m, decode_quant="int8")
    _, out8, _, _ = jax.jit(
        lambda p, b, t, s: run(m8, p, b, t, s))(params, batch, toks, st)
    _report("int8 step vs bf16 step, max |h| error", _maxabs(out8.h, out.h),
            TOL_INT8_HC)
    _report("int8 step vs bf16 step, max |c| error", _maxabs(out8.c, out.c),
            TOL_INT8_HC)


def _decode_checks(S, cap, batch, label):
    import jax
    import numpy as np
    from stvd.api import Captioner
    from stvd.model import kernel as kmod
    from stvd.model import step as smod
    check(cap.step_fn is kmod.step_tail,
          "Captioner did not pick the fused logit tail on the GPU")
    n = batch["frames"].shape[0]
    t0 = time.perf_counter()
    toks, scores = cap._run(cap.params, batch)
    toks = np.asarray(toks)
    say(f"  {label} beam-5 decode of {n} videos: {time.perf_counter() - t0:.1f}s "
        f"(first call, compile included); mean length "
        f"{float(np.mean((toks != 0).sum(1))):.1f}")
    check(toks.shape == (n, cap.cfg.decode.maxlen), f"tokens {toks.shape}")
    check(np.all(np.isfinite(np.asarray(scores))), "non-finite scores")
    caps = cap.caption_batch(batch)
    check(len(caps) == n, "caption count")

    greedy_cfg = cap.cfg.replace(decode=dataclasses.replace(
        cap.cfg.decode, beam_size=1))
    g = Captioner(cap.params, greedy_cfg, cap.vocab)
    gt, gs = g._run(g.params, batch)
    check(np.asarray(gt).shape == toks.shape, "greedy tokens")
    check(np.all(np.isfinite(np.asarray(gs))), "non-finite greedy scores")

    m32 = dataclasses.replace(cap.cfg.model, compute_dtype="float32")
    ref = Captioner(cap.params, cap.cfg.replace(model=m32), cap.vocab,
                    step_fn=smod.step)
    with jax.default_matmul_precision("highest"):
        rt, _ = jax.jit(ref._run_fn)(cap.params, batch)
    say(f"  token agreement, production bf16 beam vs f32 reference beam: "
        f"{float(np.mean(np.asarray(rt) == toks)):.4f} (not asserted: "
        f"near-ties at a 13k vocabulary may flip)")
    return toks


def phase_decode(S):
    import numpy as np
    from stvd.api import Captioner
    cap = Captioner.from_run_dir(S.run_dir)
    ds, batch = _videos(cap.cfg, 64, S.seed + 2)
    toks = _decode_checks(S, cap, batch, "msvd-beam")
    _step_compare(S, cap, batch)

    cap8 = Captioner.from_run_dir(S.run_dir, quant="int8")
    t8, s8 = cap8._run(cap8.params, batch)
    check(np.all(np.isfinite(np.asarray(s8))), "non-finite int8 scores")
    say(f"  int8 beam-5 decode ran; token agreement with bf16 "
        f"{float(np.mean(np.asarray(t8) == toks)):.4f} (not asserted)")
    S.cap, S.ds, S.batch = cap, ds, batch


def phase_spatial(S):
    import jax
    import numpy as np
    from stvd.api import Captioner
    run_dir = os.path.join(S.workdir, "msvd-spatial")
    _train_cli(run_dir, "msvd-spatial", 2, S.seed,
               ["train.valid_freq=0", "train.save_freq=0"])
    losses = [r["loss"] for r in _records(run_dir, "train")]
    check(len(losses) == 2 and all(np.isfinite(losses)),
          f"spatial train losses {losses}")
    say(f"  2 spatial updates at batch 64: loss {losses[0]:.3f} -> "
        f"{losses[-1]:.3f}")
    cap = Captioner.from_run_dir(run_dir, best=False)
    _, batch = _videos(cap.cfg, 64, S.seed + 3)
    t0 = time.perf_counter()
    toks, scores = cap._run(cap.params, batch)
    toks = np.asarray(toks)
    check(toks.shape == (64, cap.cfg.decode.maxlen) and
          np.all(np.isfinite(np.asarray(scores))), "spatial decode")
    say(f"  spatial beam-5 decode of 64 videos: "
        f"{time.perf_counter() - t0:.1f}s (compile included)")
    stats = jax.devices()[0].memory_stats() or {}
    say(f"  peak device memory so far: "
        f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB of "
        f"{stats.get('bytes_limit', 0) / 2**30:.2f} GiB "
        f"(fused sequence VJP; model.remat off)")


def phase_export(S):
    import numpy as np
    from stvd.cli import export as export_cli
    from stvd.export_aot import load_artifact
    out = os.path.join(S.workdir, "artifact")
    rc = export_cli.main(["--run-dir", S.run_dir, "--out", out,
                          "--batch", "1,64", "--check"])
    check(rc == 0, "cli.export --check failed")
    served = load_artifact(out)
    check(served.manifest["platforms"] == ["cuda"] and
          served.manifest["use_kernel"], f"manifest {served.manifest}")
    cap, batch = S.cap, S.batch
    st, _ = served._call_fn(served._exported[64])(served.params, batch)
    lt, _ = cap._run(cap.params, batch)
    check(np.array_equal(np.asarray(st), np.asarray(lt)),
          "artifact tokens differ from the live Captioner")
    one = {k: v[:1] for k, v in batch.items()}
    check(served.caption_batch(one) == cap.caption_batch(one),
          "b=1 bucket differs from live")
    say("  cuda artifact (buckets 1 and 64, Triton tail inside) matches "
        "the live Captioner token for token")
    S.artifact, S.served = out, served


def phase_serve(S):
    import numpy as np
    from stvd.cli.serve import (build_server, request_caption_ids,
                                request_captions)
    bank_path = os.path.join(S.workdir, "bank.npz")
    S.ds.bank.save(bank_path)
    args = SimpleNamespace(
        artifact=S.artifact, run_dir=None, bank=bank_path, bank_shards=0,
        params=None, quant=None, host="127.0.0.1", port=0, verbose=False,
        allow_shutdown=False, allow_swap=False, coalesce_wait_ms=0.0)
    server = build_server(args)
    warm = server.warmup()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_port
        feats = np.asarray(S.batch["frames"], np.float32)[:3]
        got = request_captions("127.0.0.1", port, feats)
        want = S.served.caption(feats)
        check(got == want, "HTTP /caption differs from the artifact")
        ids = S.ds.bank.ids[:5]
        by_id = request_caption_ids("127.0.0.1", port, ids)
        S.served.attach_bank(S.ds.bank)
        check(by_id == S.served.caption_ids(ids),
              "HTTP /caption_ids differs from the artifact")
        say(f"  in-process server (warmup {warm:.1f}s) answered /caption "
            f"x3 and /caption_ids x5")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")


def phase_four(S):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from stvd.api import Captioner
    from stvd.config import preset
    from stvd.data.batching import gather_batch, synthetic_dataset
    from stvd.train import parallel
    from stvd.train.loop import init_train_state, make_train_step

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 GPUs, JAX sees {len(devs)}")
    cfg = preset("msvd-dp")
    # dropout off: shard_map folds the shard index into the dropout rng,
    # so masks differ from one device by construction
    m = dataclasses.replace(cfg.model, use_dropout=False)
    per = cfg.train.per_device_batch
    t = dataclasses.replace(cfg.train, batch_size=per * 4)
    ds = synthetic_dataset(n_videos=t.batch_size, captions_per_video=1,
                           k=m.n_frames, d=m.ctx_dim, maxlen=t.maxlen,
                           seed=S.seed + 4, n_words=m.n_words)
    batch = gather_batch(ds.bank.to_device(jnp.bfloat16), ds.captions,
                         np.arange(t.batch_size, dtype=np.int32))
    batch["weight"] = jnp.ones((t.batch_size,), jnp.float32)
    state0 = init_train_state(jax.random.PRNGKey(S.seed), m, t)
    p0 = jax.device_get(state0["params"])

    def train(mesh=None, use_shard_map=False):
        state = jax.tree.map(jnp.copy, state0)
        b = batch
        if mesh is not None:
            state = parallel.replicate(state, mesh)
            b = parallel.shard_batch(batch, mesh)
            for leaf in jax.tree.leaves(state):
                check(leaf.sharding.device_set == set(devs),
                      "train state not replicated on all 4 GPUs")
            for leaf in jax.tree.leaves(b):
                owners = {s.device for s in leaf.addressable_shards}
                check(owners == set(devs) and
                      leaf.addressable_shards[0].data.shape[0]
                      == t.batch_size // 4, "batch not split over 4 GPUs")
        step = make_train_step(m, t, mesh=mesh, use_shard_map=use_shard_map)
        t0 = time.perf_counter()
        for _ in range(3):
            state, met = step(state, b)
        jax.block_until_ready(met["loss"])
        check(np.isfinite(float(met["loss"])), "non-finite loss")
        return jax.device_get(state["params"]), float(met["loss"]), \
            time.perf_counter() - t0

    mesh = parallel.make_mesh(devs)
    single, l1, s1 = train()
    say(f"  1 GPU, global batch {t.batch_size}: 3 steps, loss {l1:.4f} "
        f"({s1:.1f}s incl. compile)")

    def upd_err(p):
        num = sum(float(np.sum((np.asarray(p[k], np.float64)
                                - np.asarray(single[k], np.float64)) ** 2))
                  for k in p)
        den = sum(float(np.sum((np.asarray(single[k], np.float64)
                                - np.asarray(p0[k], np.float64)) ** 2))
                  for k in p)
        return (num / den) ** 0.5

    for name, sm in (("pjit", False), ("shard_map psum", True)):
        p, loss, secs = train(mesh, sm)
        say(f"  4 GPUs, {name}: 3 steps, loss {loss:.4f} ({secs:.1f}s "
            f"incl. compile)")
        _report(f"{name} vs 1 GPU, relative L2 error of the 3-step update",
                upd_err(p), TOL_DP)

    dcfg = cfg.replace(model=m, decode=dataclasses.replace(
        cfg.decode, decode_batch=64))
    cap1 = Captioner(single, dcfg, ds.vocab)
    cap1.attach_bank(ds.bank)
    want = cap1.caption_ids(cap1.bank_ids)
    cap4 = Captioner(single, dcfg, ds.vocab)
    cap4.attach_bank(ds.bank, mesh=mesh)
    rows = {s.device: s.data.shape[0]
            for s in cap4._bank_dev["frames"].addressable_shards}
    check(set(rows) == set(devs) and len(set(rows.values())) == 1,
          f"bank not sharded evenly over 4 GPUs: {rows}")
    got = cap4.caption_ids(cap4.bank_ids)
    check(got == want, "sharded-bank captions differ from one GPU")
    say(f"  sharded-bank id decode of {len(want)} videos over 4 GPUs "
        f"({list(rows.values())[0]} videos each) equals one GPU")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    args = parse_args(argv)
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import stvd  # noqa: F401
        from stvd.utils import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: the stvd package must sit beside this script "
              f"({e})", file=sys.stderr)
        return 2
    enable_compile_cache()
    os.makedirs(args.workdir, exist_ok=True)
    S = SimpleNamespace(seed=args.seed, workdir=args.workdir)
    funcs = {name: globals()[f"phase_{name}"] for name in PHASES + ("four",)}
    t_all = time.perf_counter()
    try:
        for name in phases_for(args):
            say(f"[{name}]")
            t0 = time.perf_counter()
            funcs[name](S)
            say(f"[{name}] ok in {time.perf_counter() - t0:.1f}s")
    except Exception:
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: phase {name!r} failed", file=sys.stderr)
        return 1
    finally:
        if not args.keep:
            shutil.rmtree(args.workdir, ignore_errors=True)
    say(f"all phases ok in {time.perf_counter() - t_all:.1f}s "
        f"(smoke run, not a benchmark)")
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
