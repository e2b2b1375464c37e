"""Benchmark harness: decode throughput (headline) + train throughput, on
an NVIDIA GPU.

Headline metric (BASELINE.json): MSVD decode captions/sec/device with
batched on-device beam search (beam=5, length norm) at reference scale
(dim~3518->3584, ctx 1024, vocab 13056, K=28, maxlen=30).

vs_baseline: the reference decodes ONE video at a time with a
host<->device round-trip per token (SURVEY.md §3.3).  Estimated legacy
throughput: beam=5, ~30 steps/video, >=5 f_next round-trips+top-k per
step at ~2-3 ms each on the legacy stack => ~0.4 s/video => ~2.5
captions/sec.  vs_baseline = ours / 2.5 (the BASELINE north-star target
is vs_baseline >= 50x, i.e. >= 125).

Every record names the device it ran on.  ``main`` refuses to measure
without a GPU: a CPU number is not a device metric.  Roofline shares are
computed against the published peaks in ``PEAKS`` for the device's
``device_kind``; a device not in the table gets no share.

Usage: python bench.py [--what decode|train|all|quality|dp|latency|serve]
       [--small] [--kernel | --no-kernel] [--preset N]
(--what serve: daemon-vs-direct E2E over a real exported artifact —
needs a trained --run-dir; see bench_serve.)
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

LEGACY_CAPTIONS_PER_SEC = 2.5   # documented estimate, see module docstring

# Published dense peaks, keyed by jax's device_kind.  Source: NVIDIA H100
# SXM data sheet (no sparsity), at the full 700 W power limit — a card
# set below it cannot hold its top clock under matrix-heavy load, so
# every record also carries the card's power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12, "int8_ops": 1979e12, "hbm_bytes": 3.35e12,
        "source": "NVIDIA H100 SXM data sheet, dense",
    },
}


def device_record():
    """{platform, kind, count, card} of the current JAX devices; ``card``
    is nvidia-smi's name and power limit (None without nvidia-smi)."""
    import jax
    d = jax.devices()[0]
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = None
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": card}


def decode_cost_model(mcfg, batch: int, beam: int, quant: str = "none"):
    """Analytic per-while-step work of beam decode: matmul FLOPs (the
    gates matmul in int8 ops when ``quant == 'int8'``) and the bytes the
    step must move (weights read once, activations and the attention
    reads of the un-tiled context).

    Returns {"flops": bf16 FLOPs, "int8_ops": int8 ops, "bytes": bytes}.
    """
    bt = batch * beam
    d, dw, dc, a, v = (mcfg.dim, mcfg.dim_word, mcfg.ctx_dim,
                       mcfg.attn_dim, mcfg.n_words)
    k_f = mcfg.n_frames
    gates = 2 * bt * (dw + d + dc) * 4 * d    # [emb|h|ctx] @ [W;U;Wc]
    flops = (
        2 * bt * d * (a + 1)              # h @ [Wd_att | W_sel]
        + 4 * bt * k_f * a                # attention scores (tanh+reduce)
        + 2 * bt * k_f * dc               # context reduction
        + 2 * bt * d * dw + 2 * bt * dc * dw  # logit activation matmuls
        + 2 * bt * dw * v                 # vocab matmul
    )
    wbytes = ((dw + d + dc) * 4 * d * (1 if quant == "int8" else 2)
              + 2 * (d * (a + 1)           # attention projection
                     + dw * (d + dc)       # logit stack
                     + dw * v))            # vocab matrix
    abytes = (4 * 4 * bt * d              # h,c carries r/w fp32
              + 2 * 2 * bt * (dw + d + dc)  # x_cat concat r/w bf16
              + 2 * batch * k_f * (a + dc) * 2)  # pctx/ctx attention reads
    if mcfg.use_spatial:
        r, s = mcfg.n_regions, mcfg.region_dim
        flops += (2 * bt * k_f * r * s    # spatial score reduce (. u_s)
                  + 2 * bt * k_f * r * s  # spat = sum_r alpha_s*regions
                  + 2 * bt * k_f * s * (dc + a))  # spat @ [W_spat_fuse|w_sf_att]
        abytes += (batch * k_f * r * s * 4  # pregion read (beam-shared, f32)
                   + batch * k_f * r * s * 2  # regions read (bf16)
                   + 2 * 2 * bt * k_f * (dc + a) * 4)  # per-step ctx_k/
        #                                    pctx_k materialization (f32)
    if quant == "int8":
        return {"flops": flops, "int8_ops": gates, "bytes": wbytes + abytes}
    return {"flops": flops + gates, "int8_ops": 0, "bytes": wbytes + abytes}


def roofline(cost, seconds: float, kind: str):
    """Least time the device could take for ``cost`` (the larger of the
    compute and the memory bound, from the published peaks) over the
    measured ``seconds``.  None for a device not in ``PEAKS``."""
    pk = PEAKS.get(kind)
    if pk is None:
        return None
    compute_s = (cost["flops"] / pk["bf16_flops"]
                 + cost.get("int8_ops", 0) / pk["int8_ops"])
    memory_s = cost["bytes"] / pk["hbm_bytes"]
    floor = max(compute_s, memory_s)
    return {"floor_s": floor, "share": round(floor / seconds, 4),
            "bound": "compute" if compute_s >= memory_s else "memory",
            "peaks": pk["source"]}


def train_cost_model(mcfg, batch: int, maxlen: int) -> float:
    """Forward-pass matmul FLOPs of one train step times 3 (backward ~2x
    forward: the standard count used for train MFU).

    Spatial (preset 2): adds the per-step region stage (score reduce,
    spat weighted sum, the two fusion matmuls) plus the once-per-step
    pregion precompute (regions @ Ws_att — 184 GFLOP at reference
    scale).  Motion (preset 4): the once-per-step stream fusion
    matmuls."""
    b, t = batch, maxlen
    d, dw, dc, a, v = (mcfg.dim, mcfg.dim_word, mcfg.ctx_dim,
                       mcfg.attn_dim, mcfg.n_words)
    k_f = mcfg.n_frames
    fwd = (
        2 * b * t * (dw + d + dc) * 4 * d   # gates over the scan
        + 2 * b * t * d * (a + 1)           # h attention projection
        + 4 * b * t * k_f * a               # attention scores
        + 2 * b * t * k_f * dc              # context reduction
        + 2 * b * t * dw * (d + dc)         # logit activation matmuls
        + 2 * b * t * dw * v                # vocab matmul (post-scan)
        + 2 * b * k_f * dc * a              # pctx precompute
    )
    if mcfg.use_spatial:
        r, s = mcfg.n_regions, mcfg.region_dim
        fwd += (
            2 * b * t * d * s               # h @ Wsd_att (spatial h proj)
            + 2 * b * t * k_f * r * s       # spatial score reduce
            + 2 * b * t * k_f * r * s       # spat weighted sum (Dr == s)
            + 2 * b * t * k_f * s * (dc + a)  # spat @ [W_spat_fuse|w_sfa]
            + 2 * b * k_f * r * s * s       # pregion = regions @ Ws_att
        )
    if mcfg.use_motion:
        dm = mcfg.motion_dim
        fwd += 2 * b * k_f * (dc * dc + dm * dc)  # stream fusion (once)
    return 3.0 * fwd


def _mfu(flops: float, seconds: float, kind: str):
    pk = PEAKS.get(kind)
    return None if pk is None else round(flops / (pk["bf16_flops"]
                                                  * seconds), 4)


def _cfgs(small: bool):
    from stvd.config import ModelConfig, TrainConfig, DecodeConfig
    if small:
        m = ModelConfig(n_words=1024, dim_word=128, dim=256, ctx_dim=256,
                        n_frames=8, compute_dtype="bfloat16")
        t = TrainConfig(batch_size=16, maxlen=16)
        d = DecodeConfig(beam_size=5, maxlen=16, decode_batch=16)
    else:
        # reference scale (dim 3518 -> 3584, vocab -> 13056)
        m = ModelConfig(n_words=13056, dim_word=512, dim=3584, ctx_dim=1024,
                        n_frames=28, compute_dtype="bfloat16",
                        scan_unroll=1)  # fused seq-VJP: unroll=1 fastest
        t = TrainConfig(batch_size=64, maxlen=30)
        d = DecodeConfig(beam_size=5, maxlen=30, decode_batch=64)
    return m, t, d


def _batch(mcfg, tcfg, b, seed=0):
    import jax.numpy as jnp
    import numpy as np
    rng = np.random.RandomState(seed)
    out = {
        "frames": jnp.asarray(rng.randn(b, mcfg.n_frames, mcfg.ctx_dim),
                              jnp.float32),
        "frame_mask": jnp.ones((b, mcfg.n_frames), jnp.float32),
        "tokens": jnp.asarray(
            rng.randint(0, mcfg.n_words, (b, tcfg.maxlen)), jnp.int32),
        "token_mask": jnp.ones((b, tcfg.maxlen), jnp.float32),
    }
    if mcfg.use_spatial:
        out["regions"] = jnp.asarray(
            rng.randn(b, mcfg.n_frames, mcfg.n_regions, mcfg.region_dim)
            .astype(np.float32) * 0.1)
    if mcfg.use_motion:
        out["motion"] = jnp.asarray(
            rng.randn(b, mcfg.n_frames, mcfg.motion_dim), jnp.float32)
    return out


def _timed(run, *args, iters: int):
    """Mean seconds per call: warm once, then ``iters`` pipelined calls
    and one block_until_ready at the end."""
    import jax
    jax.block_until_ready(run(*args))      # compile + warmup
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def bench_decode(small: bool, use_kernel, iters: int = 8, batch: int = 0,
                 quant: str = "none", beam_gather: str = "config",
                 beam_buf: str = "config"):
    import dataclasses

    import jax
    from stvd.decode.beam import beam_decode
    from stvd.model.decoder import init_params
    from stvd.model.kernel import get_step_fn

    mcfg, tcfg, dcfg = _cfgs(small)
    if quant != "none":
        mcfg = dataclasses.replace(mcfg, decode_quant=quant)
    if beam_gather != "config":
        mcfg = dataclasses.replace(mcfg, beam_gather=beam_gather)
    if beam_buf != "config":
        mcfg = dataclasses.replace(mcfg, beam_buf=beam_buf)
    params = dict(init_params(jax.random.PRNGKey(0), mcfg))
    # random weights emit EOS immediately and the early-exit while_loop
    # finishes in ~1 step.  Suppress EOS so every sequence runs the full
    # maxlen steps — the honest WORST case; trained models finish
    # earlier and decode faster.
    params["ff_logit_b"] = params["ff_logit_b"].at[0].set(-1e9)
    b = batch or dcfg.decode_batch
    batch = {k: v for k, v in _batch(mcfg, tcfg, b).items()
             if k in ("frames", "frame_mask")}
    step_fn = get_step_fn(use_kernel)

    @jax.jit
    def run(params, batch):
        return beam_decode(params, mcfg, batch, beam_size=dcfg.beam_size,
                           maxlen=dcfg.maxlen, length_norm=0.6,
                           step_fn=step_fn).tokens

    dt = _timed(run, params, batch, iters=iters)
    return b / dt, dt


def bench_decode_trained(run_dir: str, iters: int = 8, batch: int = 0,
                         bank_path: str = "", quant: str = "",
                         mode: str = "beam"):
    """Realistic-length decode headline: a TRAINED checkpoint decoding
    with natural EOS, so the early-exit while_loop actually exits at real
    caption lengths — reported NEXT TO the EOS-suppressed all-maxlen-steps
    worst case on the same weights, plus the measured mean caption
    length.  The reference's throughput is defined by actual caption
    lengths (``model_attention.py:§gen_sample``), so the honest headline
    pair is (worst case, trained-early-exit).

    Inputs: rows from the run's feature bank when available (cycled to
    fill the batch), else synthetic features — a trained model still
    emits natural-length captions either way (mean length is reported
    so the reader can judge).

    ``mode='greedy'`` measures the config-1 greedy path instead of
    beam-5 (default batch 1024 instead of 384).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from stvd.api import Captioner
    from stvd.data.bank import FeatureBank
    from stvd.decode.beam import beam_decode
    from stvd.decode.greedy import greedy_decode

    cap = Captioner.from_run_dir(run_dir, quant=quant or None)
    mcfg, dcfg = cap.cfg.model, cap.cfg.decode
    b = batch or (1024 if mode == "greedy" else 384)
    keys = ["frames", "frame_mask"]
    if mcfg.use_spatial:
        keys.append("regions")
    if mcfg.use_motion:
        keys.append("motion")

    bank_path = bank_path or "data/msvd/bank.npz"
    bank = FeatureBank.load(bank_path) if os.path.exists(bank_path) \
        else None
    if bank is not None and (
            bank.frames.shape[1] != mcfg.n_frames
            or bank.frames.shape[2] != mcfg.ctx_dim
            or ("regions" in keys and (
                bank.regions is None
                or bank.regions.shape[2:] != (mcfg.n_regions,
                                              mcfg.region_dim)))
            or ("motion" in keys and (
                bank.motion is None
                or bank.motion.shape[2] != mcfg.motion_dim))):
        # the default bank may belong to a DIFFERENT config than the
        # run dir (dims/streams mismatch) — fall back to synthetic
        # rather than feeding wrong-shaped features
        bank = None
    if bank is not None:
        dev = bank.to_device(dtype=jnp.dtype(mcfg.compute_dtype))
        n = dev["frames"].shape[0]
        rows = jnp.asarray(np.arange(b) % n, jnp.int32)
        dec = {k: dev[k][rows] for k in keys}
        src = f"bank:{bank_path}"
    else:
        mc, tc, _ = _cfgs(False)
        dec = {k: v for k, v in _batch(mcfg, tc, b).items() if k in keys}
        src = "synthetic"

    def timed(params):
        @jax.jit
        def run(params, dec):
            if mode == "greedy":
                out = greedy_decode(params, mcfg, dec,
                                    maxlen=dcfg.maxlen,
                                    step_fn=cap.step_fn)
            else:
                out = beam_decode(params, mcfg, dec,
                                  beam_size=dcfg.beam_size,
                                  maxlen=dcfg.maxlen,
                                  length_norm=dcfg.length_norm,
                                  step_fn=cap.step_fn)
            return out.tokens, out.lengths

        _, lengths = run(params, dec)
        mean_len = float(jnp.mean(lengths.astype(jnp.float32)))
        dt = _timed(run, params, dec, iters=iters)
        return b / dt, mean_len

    cps_nat, mean_len = timed(cap.params)
    worst = dict(cap.params)
    worst["ff_logit_b"] = worst["ff_logit_b"].at[0].set(-1e9)
    cps_worst, _ = timed(worst)
    return {
        "metric": "decode_captions_per_sec_trained",
        "value": round(cps_nat, 2), "unit": "captions/s",
        "vs_baseline": round(cps_nat / LEGACY_CAPTIONS_PER_SEC, 1),
        "mode": mode,
        "beam": dcfg.beam_size if mode == "beam" else 1, "batch": b,
        "mean_caption_len": round(mean_len, 2),
        "maxlen": dcfg.maxlen,
        "captions_per_sec_eos_suppressed": round(cps_worst, 2),
        "early_exit_speedup": round(cps_nat / cps_worst, 2),
        "quant": quant or "bf16",
        "run_dir": run_dir, "features": src,
    }


def bench_greedy(use_kernel, iters: int = 16, batch: int = 1024,
                 quant: str = "none"):
    """Config-1 (greedy) decode throughput at reference scale."""
    import dataclasses

    import jax
    from stvd.decode.greedy import greedy_decode
    from stvd.model.decoder import init_params
    from stvd.model.kernel import get_step_fn

    mcfg, tcfg, dcfg = _cfgs(False)
    if quant != "none":
        mcfg = dataclasses.replace(mcfg, decode_quant=quant)
    params = dict(init_params(jax.random.PRNGKey(0), mcfg))
    params["ff_logit_b"] = params["ff_logit_b"].at[0].set(-1e9)
    b = {k: v for k, v in _batch(mcfg, tcfg, batch).items()
         if k in ("frames", "frame_mask")}
    step_fn = get_step_fn(use_kernel)

    @jax.jit
    def run(params, b):
        return greedy_decode(params, mcfg, b, maxlen=dcfg.maxlen,
                             step_fn=step_fn).tokens

    dt = _timed(run, params, b, iters=iters)
    return batch / dt, dt


def bench_latency(use_kernel, quant: str = "none", chain_iters: int = 32,
                  synced_iters: int = 12, small: bool = False):
    """Single-request serving latency: batch=1, beam-5, full-maxlen decode.

    The throughput benches answer "captions/s at saturation"; serving
    also cares about the b=1 critical path, which at this scale is
    weight-STREAMING-bound (the ~145 MB gates stack is read every step
    for 5 rows of work).  Two numbers:

    * ``device_ms`` — a SERIAL CHAIN of ``chain_iters`` decodes (each
      consumes the previous result, so nothing overlaps or hoists) with
      one sync at the end: per-decode device latency with dispatch
      overhead amortized away.
    * ``client_p50_ms`` — one synced call per measurement: what a
      caller observes, dispatch included.
    """
    import dataclasses

    import jax
    import jax.numpy as jnp
    from stvd.decode.beam import beam_decode
    from stvd.model.decoder import init_params
    from stvd.model.kernel import get_step_fn

    mcfg, tcfg, dcfg = _cfgs(small)
    if quant != "none":
        mcfg = dataclasses.replace(mcfg, decode_quant=quant)
    params = dict(init_params(jax.random.PRNGKey(0), mcfg))
    params["ff_logit_b"] = params["ff_logit_b"].at[0].set(-1e9)
    b = {k: v for k, v in _batch(mcfg, tcfg, 1).items()
         if k in ("frames", "frame_mask")}
    step_fn = get_step_fn(use_kernel)

    @jax.jit
    def run(params, frames, fmask, eps):
        bb = {"frames": frames * (1.0 + eps), "frame_mask": fmask}
        out = beam_decode(params, mcfg, bb, beam_size=dcfg.beam_size,
                          maxlen=dcfg.maxlen, length_norm=0.6,
                          step_fn=step_fn)
        # tiny scalar: serial-dependency feedback for the chained variant
        return out.tokens.sum().astype(jnp.float32) * 1e-30

    eps = jnp.float32(0.0)
    jax.block_until_ready(run(params, b["frames"], b["frame_mask"], eps))
    t0 = time.perf_counter()
    s = eps
    for _ in range(chain_iters):
        s = run(params, b["frames"], b["frame_mask"], s)
    jax.block_until_ready(s)
    device_ms = (time.perf_counter() - t0) / chain_iters * 1e3

    synced = []
    for _ in range(synced_iters):
        t0 = time.perf_counter()
        jax.block_until_ready(run(params, b["frames"], b["frame_mask"], eps))
        synced.append((time.perf_counter() - t0) * 1e3)
    synced.sort()
    p50 = synced[len(synced) // 2]

    kind = jax.devices()[0].device_kind
    cost = decode_cost_model(mcfg, 1, dcfg.beam_size, quant)
    roof = roofline(cost, device_ms / 1e3 / dcfg.maxlen, kind)
    return {"metric": "decode_latency_ms_b1_beam5",
            "value": round(device_ms, 3), "unit": "ms",
            "vs_baseline": None,
            "client_p50_ms": round(p50, 2),
            "client_min_ms": round(min(synced), 2),
            "floor_ms": (None if roof is None
                         else roof["floor_s"] * dcfg.maxlen * 1e3),
            "roofline_share": None if roof is None else roof["share"],
            "quant": quant, "maxlen": dcfg.maxlen}


def bench_train(small: bool, use_kernel, iters: int = 10, batch: int = 0):
    import dataclasses

    import jax
    from stvd.model.kernel import get_step_fn
    from stvd.train.loop import init_train_state, make_train_step

    mcfg, tcfg, _ = _cfgs(small)
    if batch:
        tcfg = dataclasses.replace(tcfg, batch_size=batch)
    state = init_train_state(jax.random.PRNGKey(0), mcfg, tcfg)
    step = make_train_step(mcfg, tcfg, step_fn=get_step_fn(use_kernel))
    batch = _batch(mcfg, tcfg, tcfg.batch_size)
    batch["weight"] = batch["token_mask"][:, 0]
    state, m = step(state, batch)
    jax.block_until_ready(m["loss"])          # compile + warmup
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = step(state, batch)
    jax.block_until_ready(m["loss"])
    dt = time.perf_counter() - t0
    return iters / dt, dt / iters


def bench_preset(name: str, use_kernel, iters: int = 4):
    """Benchmark one of the five BASELINE presets at its own (reference-
    scale) config.

    Presets 1-4 measure decode throughput (greedy for 1, beam-5 for
    2/3/4 incl. spatial regions / motion stream); preset 5 measures the
    explicit-shard-map DP train step over all local devices.
    """
    import jax
    from stvd.config import preset
    from stvd.decode.beam import beam_decode
    from stvd.decode.greedy import greedy_decode
    from stvd.model.decoder import init_params
    from stvd.model.kernel import get_step_fn

    cfg = preset(name)
    mcfg, dcfg, tcfg = cfg.model, cfg.decode, cfg.train
    step_fn = get_step_fn(use_kernel)
    kind = jax.devices()[0].device_kind

    if cfg.train.use_shard_map:  # preset 5: DP training
        import dataclasses
        from stvd.train import parallel
        from stvd.train.loop import init_train_state, make_train_step
        mesh = parallel.make_mesh()
        n_dev = mesh.devices.size
        b = (tcfg.per_device_batch or tcfg.batch_size) * n_dev
        tcfg = dataclasses.replace(tcfg, batch_size=b)
        state = parallel.replicate(
            init_train_state(jax.random.PRNGKey(0), mcfg, tcfg), mesh)
        step = make_train_step(mcfg, tcfg, step_fn=step_fn, mesh=mesh,
                               use_shard_map=True)
        batch = _batch(mcfg, tcfg, b)
        batch["weight"] = batch["token_mask"][:, 0]
        batch = parallel.shard_batch(batch, mesh)
        state, m = step(state, batch)
        jax.block_until_ready(m["loss"])
        t0 = time.perf_counter()
        for _ in range(iters):
            state, m = step(state, batch)
        jax.block_until_ready(m["loss"])
        dt = time.perf_counter() - t0
        return {"metric": f"preset{name}_dp_train_steps_per_sec",
                "value": round(iters / dt, 3), "unit": "steps/s",
                "vs_baseline": None, "devices": n_dev, "global_batch": b,
                "examples_per_sec": round(iters / dt * b, 1),
                "path": "shard_map+psum"}

    params = dict(init_params(jax.random.PRNGKey(0), mcfg))
    params["ff_logit_b"] = params["ff_logit_b"].at[0].set(-1e9)  # worst case
    b = dcfg.decode_batch
    batch = {k: v for k, v in _batch(mcfg, tcfg, b).items()
             if k in ("frames", "frame_mask", "regions", "motion")}

    @jax.jit
    def run(params, batch):
        if dcfg.beam_size == 1:
            return greedy_decode(params, mcfg, batch, maxlen=dcfg.maxlen,
                                 step_fn=step_fn).tokens
        return beam_decode(params, mcfg, batch, beam_size=dcfg.beam_size,
                           maxlen=dcfg.maxlen, length_norm=dcfg.length_norm,
                           step_fn=step_fn).tokens

    dt = _timed(run, params, batch, iters=iters)
    cps = b / dt
    roof = roofline(decode_cost_model(mcfg, b, dcfg.beam_size,
                                      quant=mcfg.decode_quant),
                    dt / dcfg.maxlen, kind)
    return {"metric": f"preset{name}_decode_captions_per_sec",
            "value": round(cps, 2), "unit": "captions/s",
            "vs_baseline": round(cps / LEGACY_CAPTIONS_PER_SEC, 1),
            "beam": dcfg.beam_size, "batch": b,
            "spatial": mcfg.use_spatial, "motion": mcfg.use_motion,
            "roofline": roof}


def bench_preset_train(name: str, use_kernel, iters: int = 10,
                       fused: bool = True, batch: int = 0,
                       opt_slots: str = "float32", grad_accum: int = 1):
    """Teacher-forced train-step throughput at a preset's reference
    scale (presets 1-4; preset 5 is the DP path in bench_preset).

    ``fused=False`` measures the autodiff(+remat for spatial) fallback
    — the before/after evidence for the hand-derived sequence VJPs.
    """
    import dataclasses

    import jax
    from stvd.config import preset
    from stvd.model.kernel import get_step_fn
    from stvd.train.loop import init_train_state, make_train_step

    cfg = preset(name)
    mcfg, tcfg = cfg.model, cfg.train
    if batch:
        tcfg = dataclasses.replace(tcfg, batch_size=batch)
    if opt_slots != "float32":
        tcfg = dataclasses.replace(tcfg, opt_slot_dtype=opt_slots)
    if grad_accum > 1:
        # microbatched grads (train.grad_accum): measures the serial
        # latency the memory saving costs vs remat's recompute
        tcfg = dataclasses.replace(tcfg, grad_accum=grad_accum)
    if not fused:
        mcfg = dataclasses.replace(mcfg, fused_seq_grad=False,
                                   remat=mcfg.use_spatial)
    state = init_train_state(jax.random.PRNGKey(0), mcfg, tcfg)
    step = make_train_step(mcfg, tcfg, step_fn=get_step_fn(use_kernel))
    batch = _batch(mcfg, tcfg, tcfg.batch_size)
    batch["weight"] = batch["token_mask"][:, 0]
    state, m = step(state, batch)
    jax.block_until_ready(m["loss"])          # compile + warmup
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = step(state, batch)
    jax.block_until_ready(m["loss"])
    dt = time.perf_counter() - t0
    sps = iters / dt
    return {"metric": f"preset{name}_train_steps_per_sec",
            "value": round(sps, 3), "unit": "steps/s",
            "vs_baseline": None, "batch": tcfg.batch_size,
            "step_ms": round(dt / iters * 1e3, 2),
            "examples_per_sec": round(sps * tcfg.batch_size, 1),
            "train_mfu": _mfu(train_cost_model(mcfg, tcfg.batch_size,
                                               tcfg.maxlen),
                              dt / iters, jax.devices()[0].device_kind),
            "spatial": mcfg.use_spatial, "motion": mcfg.use_motion,
            "path": ("fused_seq_vjp" if fused else
                     "autodiff" + ("+remat" if mcfg.remat else "")),
            "opt_slot_dtype": tcfg.opt_slot_dtype,
            "grad_accum": tcfg.grad_accum}


def bench_quality(use_kernel, hard: bool = False):
    """Train the structured-synthetic quality recipe to convergence and
    score held-out videos (BLEU-4/METEOR/CIDEr) — the offline stand-in
    for MSVD quality parity (no real feature banks here)."""
    import jax
    import jax.numpy as jnp
    from stvd.config import Config, DecodeConfig, ModelConfig, TrainConfig
    from stvd.data.batching import BatchIterator, gather_batch
    from stvd.data.synthetic import structured_splits
    from stvd.model.kernel import get_step_fn
    from stvd.train.evaluate import evaluate_split
    from stvd.train.loop import init_train_state, make_train_step

    mcfg = ModelConfig(n_words=64, dim_word=48, dim=128, ctx_dim=128,
                       n_frames=8, compute_dtype="float32",
                       use_dropout=True, dropout_rate=0.3)
    maxlen = 14 if hard else 12
    tcfg = TrainConfig(optimizer="adam", lr=2e-3, batch_size=32,
                       clip_c=5.0, maxlen=maxlen)
    cfg = Config(model=mcfg, train=tcfg,
                 decode=DecodeConfig(beam_size=5, maxlen=maxlen,
                                     length_norm=0.6, decode_batch=32))
    splits = structured_splits(n_train=200, n_valid=32, n_test=32, k=8,
                               d=128, maxlen=maxlen, hard=hard)
    step_fn = get_step_fn(use_kernel)
    state = init_train_state(jax.random.PRNGKey(0), mcfg, tcfg)
    step = make_train_step(mcfg, tcfg, step_fn=step_fn)
    dev = splits["train"].bank.to_device()
    it = BatchIterator(splits["train"].captions.n, tcfg.batch_size, seed=0)
    m = {}
    for epoch in range(120):
        for idx, w in it.epoch():
            b = gather_batch(dev, splits["train"].captions, idx)
            b["weight"] = jnp.asarray(w)
            state, m = step(state, b)
        if float(m["nll_per_token"]) < (0.3 if hard else 0.05):
            break
    return evaluate_split(state["params"], cfg, splits["test"],
                          split="test", step_fn=step_fn)


def bench_dp(small: bool, use_kernel, iters: int = 10):
    """Data-parallel train throughput over ALL local devices (config 5).

    On one GPU this measures the DP=1 code path; on four the same
    invocation measures 4-way scaling over NVLink.
    """
    import jax
    from stvd.model.kernel import get_step_fn
    from stvd.train import parallel
    from stvd.train.loop import init_train_state, make_train_step

    mesh = parallel.make_mesh()
    n_dev = mesh.devices.size
    mcfg, tcfg, _ = _cfgs(small)
    state = init_train_state(jax.random.PRNGKey(0), mcfg, tcfg)
    state = parallel.replicate(state, mesh)
    step = make_train_step(mcfg, tcfg, step_fn=get_step_fn(use_kernel),
                           mesh=mesh)
    b = tcfg.batch_size * n_dev
    batch = _batch(mcfg, tcfg, b)
    batch["weight"] = batch["token_mask"][:, 0]
    batch = parallel.shard_batch(batch, mesh)
    state, m = step(state, batch)
    jax.block_until_ready(m["loss"])          # compile + warmup
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = step(state, batch)
    jax.block_until_ready(m["loss"])
    dt = time.perf_counter() - t0
    return iters / dt, n_dev, b


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_direct_code(art: str, sizes, n_lat: int, bank: str = "") -> str:
    """Child-process script: load the artifact IN-PROCESS and time
    caption() per batch size — the no-HTTP baseline the daemon numbers
    are compared against.  With ``bank``, also time caption_ids (the
    fused gather+decode path) at b=1 and a bulk burst: the no-HTTP ids
    ceiling that separates HTTP cost from dispatch cost in the
    bank-resident daemon numbers."""
    return f"""
import json, time, sys
import numpy as np
sys.path.insert(0, ".")
from stvd.utils import enable_compile_cache
enable_compile_cache()
from stvd.export_aot import load_artifact
cap = load_artifact({art!r})
m = cap.cfg.model
rng = np.random.RandomState(0)
def arrs(b):
    out = {{"features":
            (rng.randn(b, m.n_frames, m.ctx_dim) * 0.3).astype("float32")}}
    if m.use_spatial:
        out["regions"] = (rng.randn(b, m.n_frames, m.n_regions,
                                    m.region_dim) * 0.3).astype("float32")
    if m.use_motion:
        out["motion"] = (rng.randn(b, m.n_frames,
                                   m.motion_dim) * 0.3).astype("float32")
    return out
res = {{}}
for b in {list(sizes)!r}:
    a = arrs(b)
    kw = dict(regions=a.get("regions"), motion=a.get("motion"))
    cap.caption(a["features"], **kw)          # warm (StableHLO compile)
    reps = {n_lat} if b == 1 else 6
    lat = []
    t0 = time.perf_counter()
    for _ in range(reps):
        t1 = time.perf_counter()
        cap.caption(a["features"], **kw)      # strings out = real sync
        lat.append((time.perf_counter() - t1) * 1e3)
    wall = time.perf_counter() - t0
    lat.sort()
    res[str(b)] = {{
        "min_ms": round(lat[0], 2),
        "p50_ms": round(lat[len(lat) // 2], 2),
        "p95_ms": round(lat[max(0, int(len(lat) * 0.95) - 1)], 2),
        "captions_per_sec": round(b * reps / wall, 1)}}
print("DIRECT_JSON:" + json.dumps(res))
if {bank!r}:
    from stvd.data.bank import FeatureBank
    cap.attach_bank(FeatureBank.load({bank!r}))
    ids = cap.bank_ids
    bulk = max({list(sizes)!r})
    burst = [ids[i % len(ids)] for i in range(bulk)]
    cap.caption_ids(ids[:1]); cap.caption_ids(burst)   # warm both buckets
    lat = []
    for _ in range({n_lat}):
        t1 = time.perf_counter()
        cap.caption_ids(ids[:1])
        lat.append((time.perf_counter() - t1) * 1e3)
    lat.sort()
    t0 = time.perf_counter()
    cap.caption_ids(burst)
    wall = time.perf_counter() - t0
    print("DIRECT_IDS_JSON:" + json.dumps({{
        "b1_p50_ms": round(lat[len(lat) // 2], 2),
        "bulk": bulk,
        "bulk_captions_per_sec": round(bulk / wall, 1)}}))
"""


def _daemon_measure(port: int, sizes, n_lat: int, concurrency: int = 0):
    """Drive a running cli/serve daemon over HTTP (raw wire) and return
    per-size client latency/throughput.  With ``concurrency`` > 0, run
    that many b=1 client threads against the coalescer instead."""
    import http.client
    import threading

    import numpy as np

    from stvd.cli.serve import request_captions

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("GET", "/manifest")
    man = json.loads(conn.getresponse().read().decode())
    conn.close()
    spec = man["inputs"][str(man["batch_sizes"][0])]
    rng = np.random.RandomState(0)

    def arrs(b):
        out = {}
        for name in ("frames", "regions", "motion"):
            if name in spec:
                shape = [b] + [int(d) for d in spec[name][0][1:]]
                out[name] = (rng.randn(*shape) * 0.3).astype(np.float32)
        return out

    if concurrency > 0:
        a1 = arrs(1)
        kw = dict(regions=a1.get("regions"), motion=a1.get("motion"))
        request_captions("127.0.0.1", port, a1["frames"], **kw)  # warm
        per_thread = max(4, n_lat // concurrency)
        lat_all, lock = [], threading.Lock()

        def client():
            mine = []
            for _ in range(per_thread):
                t0 = time.perf_counter()
                request_captions("127.0.0.1", port, a1["frames"], **kw)
                mine.append((time.perf_counter() - t0) * 1e3)
            with lock:
                lat_all.extend(mine)

        threads = [threading.Thread(target=client)
                   for _ in range(concurrency)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        lat_all.sort()
        n = len(lat_all)
        return {"clients": concurrency, "requests": n,
                "p50_ms": round(lat_all[n // 2], 2),
                "p95_ms": round(lat_all[max(0, int(n * 0.95) - 1)], 2),
                "captions_per_sec": round(n / wall, 1)}

    res = {}
    for b in sizes:
        a = arrs(b)
        kw = dict(regions=a.get("regions"), motion=a.get("motion"))
        request_captions("127.0.0.1", port, a["frames"], **kw)   # warm
        reps = n_lat if b == 1 else 6
        lat = []
        t0 = time.perf_counter()
        for _ in range(reps):
            t1 = time.perf_counter()
            request_captions("127.0.0.1", port, a["frames"], **kw)
            lat.append((time.perf_counter() - t1) * 1e3)
        wall = time.perf_counter() - t0
        lat.sort()
        res[str(b)] = {
            "min_ms": round(lat[0], 2),
            "p50_ms": round(lat[len(lat) // 2], 2),
            "p95_ms": round(lat[max(0, int(len(lat) * 0.95) - 1)], 2),
            "captions_per_sec": round(b * reps / wall, 1)}
    return res


def _daemon_stop(proc) -> None:
    """SIGTERM is the daemon's clean stop (cli/serve installs it)."""
    proc.terminate()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


def _ids_measure(port: int, n_lat: int, bulk: int):
    """Drive POST /caption_ids against a --bank daemon: b=1 latency and
    a bulk burst over the resident ids (cycled if the bank is smaller
    than the burst)."""
    import http.client

    from stvd.cli.serve import request_caption_ids

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("GET", "/manifest")
    man = json.loads(conn.getresponse().read().decode())
    conn.close()
    ids = man.get("bank_ids") or []
    if not ids:
        return {"error": "daemon has no resident bank"}
    request_caption_ids("127.0.0.1", port, ids[:1])          # warm b=1
    lat = []
    for _ in range(n_lat):
        t0 = time.perf_counter()
        request_caption_ids("127.0.0.1", port, ids[:1])
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    burst = [ids[i % len(ids)] for i in range(bulk)]
    # warm the bulk bucket too: its graph's first call pays the AOT
    # load/warmup, not serving cost
    t0 = time.perf_counter()
    request_caption_ids("127.0.0.1", port, burst)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    caps = request_caption_ids("127.0.0.1", port, burst)
    wall = time.perf_counter() - t0
    return {"bank_videos": man.get("bank_videos"),
            "bulk_first_call_s": round(cold_s, 2),
            "b1_p50_ms": round(lat[len(lat) // 2], 2),
            "b1_p95_ms": round(lat[max(0, int(len(lat) * 0.95) - 1)], 2),
            "bulk": bulk,
            "bulk_captions_per_sec": round(len(caps) / wall, 1),
            "request_bytes_per_video": "~16 (an id string)"}


def bench_serve(run_dir: str, workdir: str, sizes=(1, 32, 256),
                n_lat: int = 30, coalesce_ms: float = 4.0,
                bank: str = "", quant: str = ""):
    """Serving E2E benchmark (``--what serve``): export a REAL artifact
    from ``run_dir``, then measure (a) direct in-process artifact
    captions/s + latency, (b) the HTTP daemon end-to-end over the raw
    wire format, (c) the request coalescer under concurrent b=1
    clients — the number a serving user sees, not a stub-captioner
    overhead table.

    Every JAX phase (export, direct timing, each daemon) is its OWN
    child process run strictly one at a time, and the parent never
    initializes JAX: a JAX process reserves most of the GPU's memory
    when it starts, so a second one would fail."""
    art = os.path.join(workdir, "serve_artifact")
    out = {"metric": "serve_captions_per_sec",
           "unit": "captions/s", "vs_baseline": None,
           "run_dir": run_dir, "batch_sizes": list(sizes), "wire": "raw",
           "quant": quant or "config"}

    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "stvd.cli.export", "--run-dir", run_dir,
         "--out", art, "--batch", ",".join(str(s) for s in sizes)]
        + (["--quant", quant] if quant else []),
        capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"export failed:\n{r.stdout}\n{r.stderr}")
    out["export_s"] = round(time.perf_counter() - t0, 1)

    r = subprocess.run(
        [sys.executable, "-c", _serve_direct_code(art, sizes, n_lat,
                                                  bank=bank)],
        capture_output=True, text=True)
    for line in r.stdout.splitlines():
        if line.startswith("DIRECT_JSON:"):
            out["direct"] = json.loads(line[len("DIRECT_JSON:"):])
        elif line.startswith("DIRECT_IDS_JSON:"):
            out["direct_ids"] = json.loads(
                line[len("DIRECT_IDS_JSON:"):])
    if "direct" not in out:
        raise RuntimeError(f"direct probe failed:\n{r.stdout}\n{r.stderr}")

    def start_daemon(extra):
        import http.client
        port = _free_port()
        log = open(os.path.join(workdir, f"serve_daemon_{port}.log"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "stvd.cli.serve", "--artifact", art,
             "--port", str(port)] + extra,
            stdout=log, stderr=subprocess.STDOUT)
        deadline = time.time() + 900
        while time.time() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(f"daemon exited early; see {log.name}")
            try:
                conn = http.client.HTTPConnection(
                    "127.0.0.1", port, timeout=5)
                conn.request("GET", "/healthz")
                conn.getresponse().read()
                conn.close()
                return port, proc
            except OSError:
                time.sleep(1.0)
        _daemon_stop(proc)
        raise RuntimeError(f"daemon never became healthy; see {log.name}")

    port, proc = start_daemon([])
    try:
        out["daemon"] = _daemon_measure(port, sizes, n_lat)
    finally:
        _daemon_stop(proc)

    port, proc = start_daemon(["--coalesce-wait-ms", str(coalesce_ms)])
    try:
        out["coalesce"] = _daemon_measure(port, sizes, n_lat,
                                          concurrency=8)
        out["coalesce"]["wait_ms"] = coalesce_ms
    finally:
        _daemon_stop(proc)

    if bank:
        # bank-resident phase: requests carry video ids, zero feature
        # payload — isolates decode from the wire/transfer bandwidth
        # that bounds the feature-payload numbers above
        port, proc = start_daemon(["--bank", bank])
        try:
            out["bank_resident"] = _ids_measure(port, n_lat,
                                                bulk=sizes[-1])
        finally:
            _daemon_stop(proc)

    bulk = str(sizes[-1])
    out["value"] = out["daemon"][bulk]["captions_per_sec"]
    out["daemon_overhead_b1_ms"] = round(
        out["daemon"]["1"]["p50_ms"] - out["direct"]["1"]["p50_ms"], 2)
    return out


def _headline(args, dev):
    """The decode headline: beam-5 at batch 64/256/384 with the production
    step, the XLA step beside it, greedy and int8 companions."""
    import jax
    kind = dev["kind"]
    mcfg, tcfg, dcfg = _cfgs(args.small)
    out = {"metric": "decode_captions_per_sec_per_device", "unit":
           "captions/s", "beam": dcfg.beam_size, "device": dev}
    sizes = (dcfg.decode_batch,) if args.small else (64, 256, 384)
    best = None
    for b in sizes:
        cps, per_batch = bench_decode(args.small, args.kernel, args.iters,
                                      batch=b, beam_gather=args.beam_gather,
                                      beam_buf=args.beam_buf)
        out[f"captions_per_sec_batch{b}"] = round(cps, 2)
        if best is None or cps > best[0]:
            best = (cps, per_batch, b)
    cps, per_batch, b = best
    out.update(value=round(cps, 2), batch=b,
               batch_decode_ms=round(per_batch * 1e3, 1),
               kernel=args.kernel if args.kernel is not None
               else jax.default_backend() == "gpu")
    out["roofline"] = roofline(decode_cost_model(mcfg, b, dcfg.beam_size),
                               per_batch / dcfg.maxlen, kind)
    if not args.small:
        if args.kernel is None:
            xla, _ = bench_decode(False, False, args.iters, batch=b)
            out["captions_per_sec_xla_step"] = round(xla, 2)
        g_cps, g_pb = bench_greedy(args.kernel, iters=16, batch=1024)
        out["greedy_captions_per_sec"] = round(g_cps, 2)
        out["greedy_roofline"] = roofline(
            decode_cost_model(mcfg, 1024, 1), g_pb / dcfg.maxlen, kind)
        # opt-in W8A8 serving path (model.decode_quant='int8'): reported
        # beside the headline, not as it — it is a quality tradeoff
        # (greedy token agreement pinned in tests/test_decode.py)
        q_cps, q_pb = bench_decode(False, args.kernel, args.iters, batch=b,
                                   quant="int8")
        out["captions_per_sec_int8"] = round(q_cps, 2)
        out["roofline_int8"] = roofline(
            decode_cost_model(mcfg, b, dcfg.beam_size, quant="int8"),
            q_pb / dcfg.maxlen, kind)
    out["vs_baseline"] = round(out["value"] / LEGACY_CAPTIONS_PER_SEC, 1)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", default="decode",
                    choices=["decode", "train", "all", "quality", "dp",
                             "latency", "serve"])
    ap.add_argument("--run-dir", default="",
                    help="--what serve: trained run dir to export the "
                         "served artifact from")
    ap.add_argument("--workdir", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "runs", "bench"),
                    help="--what serve: artifact and daemon logs")
    ap.add_argument("--coalesce-ms", type=float, default=4.0,
                    help="--what serve: coalescer collection window")
    ap.add_argument("--serve-bank", default="",
                    help="--what serve: packed bank .npz for the "
                         "bank-resident (id-addressed) phase")
    ap.add_argument("--serve-quant", default="", choices=["", "int8"],
                    help="--what serve: bake decode_quant into the "
                         "exported artifact (W8A8 serving)")
    ap.add_argument("--trained", default="",
                    help="--what decode: run dir with a TRAINED "
                         "checkpoint — report the realistic-length "
                         "natural-EOS headline next to the "
                         "EOS-suppressed worst case (same weights)")
    ap.add_argument("--trained-quant", default="", choices=["", "int8"],
                    help="--trained: decode_quant override")
    ap.add_argument("--trained-bank", default="",
                    help="--trained: packed bank .npz for real input "
                         "features (default data/msvd/bank.npz if "
                         "present, else synthetic)")
    ap.add_argument("--trained-mode", default="beam",
                    choices=["beam", "greedy"],
                    help="--trained: decode mode")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--kernel", action="store_true", default=None,
                    help="force the Triton logit-tail kernel (default: "
                         "auto — the production selection)")
    ap.add_argument("--no-kernel", dest="kernel", action="store_false",
                    help="force the XLA step path")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--batch", type=int, default=0,
                    help="override the batch size (preset train bench)")
    ap.add_argument("--hard", action="store_true",
                    help="quality: harder non-saturating synthetic recipe")
    ap.add_argument("--preset", default=None,
                    help="benchmark a BASELINE preset (1-5 or its name) "
                         "at reference scale; decode by default, "
                         "combine with --what train for the train step")
    ap.add_argument("--no-fused", dest="fused", action="store_false",
                    default=True,
                    help="with --what train --preset: measure the "
                         "autodiff(+remat) fallback instead of the "
                         "fused sequence VJP")
    ap.add_argument("--opt-slots", default="float32",
                    choices=["float32", "bfloat16"],
                    help="with --what train --preset: adadelta "
                         "accumulator storage dtype")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="train.grad_accum microbatches for --what "
                         "train presets")
    ap.add_argument("--beam-gather", default="config",
                    choices=["config", "take", "flat", "onehot"],
                    help="with --what decode: override the beam parent-"
                         "state reorder lowering (model.beam_gather)")
    ap.add_argument("--beam-buf", default="config",
                    choices=["config", "reorder", "backptr"],
                    help="with --what decode: override the beam token "
                         "bookkeeping scheme (model.beam_buf)")
    args = ap.parse_args(argv)

    if args.what == "serve":
        # orchestrator only — the parent stays JAX-free (export, direct
        # timing and the daemons are child processes, one at a time)
        if not args.run_dir:
            ap.error("--what serve needs --run-dir")
        os.makedirs(args.workdir, exist_ok=True)
        sizes = (1, 8) if args.small else (1, 32, 256)
        print(json.dumps(bench_serve(args.run_dir, args.workdir,
                                     sizes=sizes,
                                     coalesce_ms=args.coalesce_ms,
                                     bank=args.serve_bank,
                                     quant=args.serve_quant)))
        return 0

    import jax
    if jax.devices()[0].platform != "gpu":
        print(f"bench.py measures on a GPU; JAX found "
              f"{jax.devices()[0].platform!r}", file=sys.stderr)
        return 2
    from stvd.utils import enable_compile_cache
    enable_compile_cache()
    dev = device_record()
    kind = dev["kind"]

    if args.trained:
        out = bench_decode_trained(
            args.trained, args.iters, batch=args.batch,
            bank_path=args.trained_bank, quant=args.trained_quant,
            mode=args.trained_mode)
    elif args.preset:
        if args.what == "train" and args.preset not in ("5", "msvd-dp"):
            out = bench_preset_train(args.preset, args.kernel, args.iters,
                                     fused=args.fused, batch=args.batch,
                                     opt_slots=args.opt_slots,
                                     grad_accum=args.grad_accum)
        else:
            out = bench_preset(args.preset, args.kernel, args.iters)
    elif args.what == "dp":
        sps, n_dev, b = bench_dp(args.small, args.kernel, args.iters)
        out = {"metric": "dp_train_steps_per_sec", "value": round(sps, 3),
               "unit": "steps/s", "vs_baseline": None, "devices": n_dev,
               "global_batch": b, "examples_per_sec": round(sps * b, 1)}
    elif args.what == "latency":
        out = bench_latency(args.kernel, small=args.small,
                            chain_iters=min(32, max(4, args.iters * 4)))
        if not args.small:   # int8 companion row (serving path)
            out["int8"] = {k: v for k, v in
                           bench_latency(args.kernel, quant="int8").items()
                           if k in ("value", "client_p50_ms",
                                    "roofline_share")}
    elif args.what == "quality":
        scores = bench_quality(args.kernel, args.hard)
        out = {"metric": "synthetic_heldout_bleu4", "value": scores["Bleu_4"],
               "unit": "bleu", "vs_baseline": None,
               **{k: round(v, 4) for k, v in scores.items()}}
    elif args.what == "train":
        out = _train_record(args, kind)
    else:
        out = _headline(args, dev)
        if args.what == "all":
            out.update(_train_record(args, kind, prefix="train_"))
    out["device"] = dev
    print(json.dumps(out))
    return 0


def _train_record(args, kind, prefix=""):
    sps, spt = bench_train(args.small, args.kernel, args.iters)
    mcfg, tcfg, _ = _cfgs(args.small)
    rec = {"metric": "train_steps_per_sec", "value": round(sps, 3),
           "unit": "steps/s", "vs_baseline": None,
           "step_ms": round(spt * 1e3, 2),
           "examples_per_sec": round(sps * tcfg.batch_size, 1),
           "mfu": _mfu(train_cost_model(mcfg, tcfg.batch_size,
                                        tcfg.maxlen), spt, kind)}
    if prefix:
        rec = {prefix + k: v for k, v in rec.items()
               if k not in ("metric", "unit", "vs_baseline")}
    return rec


if __name__ == "__main__":
    sys.exit(main())
