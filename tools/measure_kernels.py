"""Hand kernel vs plain XLA on the GPU, at the msvd-beam decode shapes.

Times the fused logit tail (stvd/model/kernel.py) against what XLA makes
of the plain version (vocab matmul + log_softmax + lax.top_k), then the
whole beam-5 / greedy decode with and without it, alternating the two
(A B B A) in one process, and reduces one profiler trace of each decode
to its largest device operations.  The ``spatial`` phase times the
msvd-spatial train step (time, peak memory, largest device operations).

Needs a GPU:  python tools/measure_kernels.py [--out DIR]
                  [--phases tail,decode,spatial]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from stvd.config import preset  # noqa: E402
from stvd.model import kernel as kmod  # noqa: E402
from stvd.model import step as smod  # noqa: E402
from stvd.model.decoder import init_params  # noqa: E402


def timed(fn, *args, iters=20):
    """Mean seconds per call of a jitted fn (warm), ending in a sync."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def device_ops(trace_dir: str, top: int = 12):
    """Sum device-event durations by name over the newest trace in
    ``trace_dir``; returns (busy_ns, window_ns, [(name, ns, count)])."""
    from jax.profiler import ProfileData
    path = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                         "*", "*.xplane.pb")))[-1]
    pd = ProfileData.from_file(path)
    agg, spans = {}, []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                a = agg.setdefault(ev.name, [0, 0])
                a[0] += ev.duration_ns
                a[1] += 1
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (spans[-1][1] - spans[0][0]) if spans else 0
    ops = sorted(((n, v[0], v[1]) for n, v in agg.items()),
                 key=lambda x: -x[1])[:top]
    return busy, window, ops


def tail_phase(rows=1920, dw=512, v=13056, k=5, iters=50):
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(rows, dw), jnp.bfloat16)
    w = jnp.asarray(rng.randn(dw, v) * 0.05, jnp.bfloat16)
    b = jnp.asarray(rng.randn(v), jnp.float32)

    @jax.jit
    def xla_tail(x):
        logits = jnp.dot(x, w, preferred_element_type=jnp.float32) + b
        logp = jax.nn.log_softmax(logits, axis=-1)
        return jax.lax.top_k(logp, k)

    rv, ri = xla_tail(x)
    out = {"shape": [rows, dw, v, k],
           "xla_us": timed(xla_tail, x, iters=iters) * 1e6, "configs": []}
    for tiles in ({}, dict(tr=32), dict(tv=128), dict(splits=8),
                  dict(num_warps=8), dict(num_stages=2)):
        tail = kmod.make_logit_tail(w, b, k, **tiles)

        @jax.jit
        def ker(x, tail=tail):
            vals, idx, lse = tail(x)
            return vals - lse[:, None], idx

        rec = {"tiles": dict(kmod.TAIL_TILES, **tiles)}
        try:
            kv, ki = ker(x)
            rec["max_abs_err"] = float(jnp.max(jnp.abs(kv - rv)))
            rec["idx_agree"] = float(jnp.mean(ki == ri))
            rec["kernel_us"] = timed(ker, x, iters=iters) * 1e6
        except Exception as e:  # a tile shape the compiler refuses
            rec["error"] = f"{type(e).__name__}: {str(e)[:300]}"
        out["configs"].append(rec)
        print(json.dumps(rec), flush=True)
    return out


def _decode_inputs(cfg, batch, seed=0):
    params = dict(init_params(jax.random.PRNGKey(seed), cfg.model))
    # random weights emit EOS at once; suppress it so every decode runs
    # all maxlen steps
    params["ff_logit_b"] = params["ff_logit_b"].at[0].set(-1e9)
    rng = np.random.RandomState(seed)
    m = cfg.model
    b = {"frames": jnp.asarray(rng.randn(batch, m.n_frames, m.ctx_dim),
                               jnp.float32),
         "frame_mask": jnp.ones((batch, m.n_frames), jnp.float32)}
    if m.use_spatial:
        b["regions"] = jnp.asarray(
            0.1 * rng.randn(batch, m.n_frames, m.n_regions, m.region_dim),
            jnp.float32)
    return params, b


def decode_phase(out_dir, batch=384, reps=3):
    from stvd.decode.beam import beam_decode
    from stvd.decode.greedy import greedy_decode
    cfg = preset("msvd-beam")
    params, b = _decode_inputs(cfg, batch)
    d = cfg.decode
    steps = {"xla": smod.step, "tail": kmod.step_tail}
    res = {"batch": batch}
    for mode in ("beam", "greedy"):
        fns = {}
        for name, sf in steps.items():
            if mode == "beam":
                fns[name] = jax.jit(lambda p, bb, sf=sf: beam_decode(
                    p, cfg.model, bb, beam_size=d.beam_size,
                    maxlen=d.maxlen, length_norm=d.length_norm,
                    step_fn=sf).tokens)
            else:
                fns[name] = jax.jit(lambda p, bb, sf=sf: greedy_decode(
                    p, cfg.model, bb, maxlen=d.maxlen, step_fn=sf).tokens)
        toks = {n: np.asarray(f(params, b)) for n, f in fns.items()}
        times = {n: [] for n in fns}
        for order in (["xla", "tail", "tail", "xla"] * reps):
            times[order].append(timed(fns[order], params, b, iters=3))
        rec = {n: sorted(t) for n, t in times.items()}
        rec["token_agree"] = float(np.mean(toks["xla"] == toks["tail"]))
        for n, f in fns.items():
            tdir = os.path.join(out_dir, f"trace_{mode}_{n}")
            jax.block_until_ready(f(params, b))
            jax.profiler.start_trace(tdir)
            jax.block_until_ready(f(params, b))
            jax.profiler.stop_trace()
            busy, window, ops = device_ops(tdir)
            rec[f"{n}_trace"] = {
                "busy_ms": busy / 1e6, "window_ms": window / 1e6,
                "top_ops": [(o, ns / 1e6, c) for o, ns, c in ops]}
        res[mode] = rec
        print(json.dumps({mode: rec}), flush=True)
    # does the XLA step materialize the (B*k, K, A) attention tanh?
    kk, a = cfg.model.n_frames, cfg.model.attn_dim
    shapes = (f"[{batch},5,{kk},{a}]", f"[{batch * 5},{kk},{a}]")
    hlo = fns_hlo(cfg, params, b)
    res["attn_tanh_buffers"] = [ln.strip()[:160] for ln in hlo
                                if any(s in ln for s in shapes)
                                and " fusion(" in ln]
    print(json.dumps({"attn_tanh_buffers": res["attn_tanh_buffers"]}),
          flush=True)
    return res


def fns_hlo(cfg, params, b):
    """Top-level (non-fused) HLO lines of the compiled XLA beam decode."""
    from stvd.decode.beam import beam_decode
    d = cfg.decode
    txt = jax.jit(lambda p, bb: beam_decode(
        p, cfg.model, bb, beam_size=d.beam_size, maxlen=d.maxlen,
        length_norm=d.length_norm).tokens).lower(params, b).compile(
        ).as_text()
    lines, in_fused = [], False
    for ln in txt.splitlines():
        if ln.startswith("%fused") or ln.startswith("fused"):
            in_fused = True
        elif ln and not ln.startswith(" ") and "{" in ln:
            in_fused = False
        if not in_fused:
            lines.append(ln)
    return lines


def spatial_phase(out_dir, batch=64, remat=False):
    from stvd.train.loop import init_train_state, make_train_step
    cfg = preset("msvd-spatial")
    m = dataclasses.replace(cfg.model, remat=remat)
    t = dataclasses.replace(cfg.train, batch_size=batch)
    state = init_train_state(jax.random.PRNGKey(0), m, t)
    rng = np.random.RandomState(0)
    bt = {"frames": jnp.asarray(rng.randn(batch, m.n_frames, m.ctx_dim),
                                jnp.float32),
          "frame_mask": jnp.ones((batch, m.n_frames), jnp.float32),
          "regions": jnp.asarray(0.1 * rng.randn(
              batch, m.n_frames, m.n_regions, m.region_dim), jnp.float32),
          "tokens": jnp.asarray(rng.randint(4, m.n_words, (batch, t.maxlen)),
                                jnp.int32),
          "token_mask": jnp.ones((batch, t.maxlen), jnp.float32)}
    step = make_train_step(m, t)
    state, met = step(state, bt)
    jax.block_until_ready(met)
    t0 = time.perf_counter()
    for _ in range(5):
        state, met = step(state, bt)
    jax.block_until_ready(met)
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    tdir = os.path.join(out_dir, "trace_spatial_train")
    jax.profiler.start_trace(tdir)
    state, met = step(state, bt)
    jax.block_until_ready(met)
    jax.profiler.stop_trace()
    busy, window, ops = device_ops(tdir, top=15)
    # what the autodiff train path (no fused VJP) would hold, with and
    # without model.remat: compiled, not run
    autodiff = {}
    for rm in (False, True):
        ma = dataclasses.replace(m, fused_seq_grad=False, remat=rm)
        st = init_train_state(jax.random.PRNGKey(0), ma, t)
        mem = make_train_step(ma, t).lower(st, bt).compile(
            ).memory_analysis()
        autodiff[f"remat_{rm}"] = {
            "temp_gb": mem.temp_size_in_bytes / 1e9,
            "args_gb": mem.argument_size_in_bytes / 1e9}
        del st
    rec = {"batch": batch, "remat": remat, "step_ms": step_ms,
           "autodiff_memory": autodiff,
           "peak_gb": jax.devices()[0].memory_stats()["peak_bytes_in_use"]
           / 1e9,
           "busy_ms": busy / 1e6, "window_ms": window / 1e6,
           "top_ops": [(o, ns / 1e6, c) for o, ns, c in ops]}
    print(json.dumps({"spatial_train": rec}), flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="runs/measure_kernels")
    ap.add_argument("--phases", default="tail,decode",
                    help="comma list of tail, decode, spatial")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("measure_kernels needs a GPU")
    os.makedirs(args.out, exist_ok=True)
    phases = args.phases.split(",")
    import subprocess
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    res = {"device": jax.devices()[0].device_kind, "card": card}
    if "tail" in phases:
        res["tail"] = tail_phase()
    if "decode" in phases:
        res["decode"] = decode_phase(args.out)
    if "spatial" in phases:
        res["spatial"] = spatial_phase(args.out)
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
