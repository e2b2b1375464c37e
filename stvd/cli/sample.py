"""Generate + score captions for a split from a saved checkpoint
(reference ``metrics.py`` standalone usage — SURVEY.md §3.5).

Usage:
    python -m stvd.cli.sample --run-dir runs/default [--split test]
        [--beam 5] [--use-kernel]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp

from ..config import Config
from ..data.corpus import load_splits
from ..model.kernel import get_step_fn
from ..train.evaluate import evaluate_split
from ..train.loop import init_train_state, restore_checkpoint


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--split", default="test",
                    choices=["train", "valid", "test"])
    ap.add_argument("--beam", type=int, default=None)
    ap.add_argument("--best", action="store_true",
                    help="load ckpt_best instead of the latest ckpt")
    ap.add_argument("--use-kernel", action="store_true", default=None,
                    help="force the Triton logit-tail kernel (default: "
                         "auto — the kernel on the GPU, XLA elsewhere)")
    ap.add_argument("--no-kernel", dest="use_kernel",
                    action="store_false", help="force the XLA path")
    ap.add_argument("--dump-attention", type=int, default=0, metavar="N",
                    help="greedy-decode the first N videos recording the "
                         "temporal attention maps -> {split}_attention.npz")
    ap.add_argument("--nbest", type=int, default=0, metavar="N",
                    help="write all beams (reference gen_sample returns "
                         "every hypothesis + score) for the first N videos "
                         "-> {split}_nbest.json")
    ap.add_argument("--stochastic", type=int, default=0, metavar="N",
                    help="draw N stochastic samples per video (reference "
                         "gen_sample argmax=False) -> {split}_sampled.json")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="truncated top-k sampling (0 = full vocab)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nll", action="store_true",
                    help="also report teacher-forced NLL + perplexity "
                         "for the split (reference pred_probs)")
    ap.add_argument("--quant", default=None, choices=["none", "int8"],
                    help="override model.decode_quant for this decode "
                         "(int8 = the W8A8 serving path).  The config's "
                         "own committed artifacts are never clobbered: "
                         "samples/scores writes are skipped, and "
                         "nbest/sampled/attention artifacts get a "
                         "'.{quant}' filename suffix")
    ap.add_argument("--synonyms", default=None, metavar="TABLE.json",
                    help="JSON {word: [synonyms...]} to activate "
                         "METEOR's stage-2 synonym matching on boxes "
                         "without WordNet data (metrics/meteor.py "
                         "jar-delta class 4); scores with a non-jar "
                         "table are not jar-comparable")
    args = ap.parse_args(argv)

    from ..utils import enable_compile_cache
    enable_compile_cache()
    with open(os.path.join(args.run_dir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    if args.beam is not None:
        cfg = dataclasses.replace(
            cfg, decode=dataclasses.replace(cfg.decode, beam_size=args.beam))
    if args.quant is not None:
        from ..config import validate
        cfg = validate(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model,
                                           decode_quant=args.quant)))
    # artifacts from a dtype-overridden decode carry the override in
    # their filename so they never clobber the config's own committed
    # artifacts
    qtag = f".{args.quant}" if args.quant else ""

    if args.synonyms:
        from ..metrics.meteor import load_synonym_table
        n_syn = load_synonym_table(args.synonyms)
        print(f"METEOR synonym table: {n_syn} headwords from "
              f"{args.synonyms} (stage 2 active)")

    splits = load_splits(cfg)
    template = init_train_state(jax.random.PRNGKey(0), cfg.model, cfg.train)
    name = "ckpt_best" if args.best else "ckpt"
    state = restore_checkpoint(os.path.join(args.run_dir, name), template)
    step_fn = get_step_fn(args.use_kernel)
    ds = splits[args.split]
    scores = evaluate_split(
        state["params"], cfg, ds, split=args.split,
        save_dir=None if args.quant else args.run_dir, step_fn=step_fn)
    if args.nll:
        from ..train.loop import evaluate_nll_stats, perplexity
        num, ex, tok = evaluate_nll_stats(
            state["params"], cfg.model, ds, cfg.train.valid_batch_size,
            step_fn=step_fn)
        scores["nll"] = num / max(ex, 1.0)          # reference pred_probs
        scores["nll_per_token"] = num / max(tok, 1.0)
        scores["perplexity"] = perplexity(num / max(tok, 1.0))
    if args.nbest > 0:
        import numpy as np
        from ..decode.beam import beam_decode
        n = min(args.nbest, ds.bank.n_videos)
        # compute_dtype: reuse the bank upload evaluate_split already
        # cached — a bare to_device() would pin a SECOND full-precision
        # copy of the bank in HBM for the process lifetime (~3.8 GB f32
        # at real-MSVD region scale)
        dev = ds.bank.to_device(
            dtype=jnp.dtype(cfg.model.compute_dtype))
        b = {k: v[:n] for k, v in dev.items()}
        out = beam_decode(state["params"], cfg.model, b,
                          beam_size=max(2, cfg.decode.beam_size),
                          maxlen=cfg.decode.maxlen,
                          length_norm=cfg.decode.length_norm,
                          step_fn=step_fn)
        toks = np.asarray(out.all_tokens)
        scrs = np.asarray(out.all_scores)
        # order by the length-NORMALIZED score — the quantity best-beam
        # selection uses — so beams[0] is always the caption the scored
        # samples artifact serves (api.caption_nbest(norm=True) parity);
        # the raw log-prob is still reported per beam.
        nrm = np.asarray(out.all_norm_scores)
        rows = []
        for i in range(n):
            order = np.argsort(-nrm[i])
            beams = [{"caption": " ".join(ds.vocab.decode(toks[i, j])),
                      "logprob": float(scrs[i, j]),
                      "norm_score": float(nrm[i, j])}
                     for j in order]
            rows.append({"image_id": ds.bank.ids[i], "beams": beams})
        path = os.path.join(args.run_dir, f"{args.split}_nbest{qtag}.json")
        with open(path, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"n-best lists -> {path}")
    if args.stochastic > 0:
        import numpy as np
        from ..decode.sample import sample_decode
        # compute_dtype: reuse the bank upload evaluate_split already
        # cached — a bare to_device() would pin a SECOND full-precision
        # copy of the bank in HBM for the process lifetime (~3.8 GB f32
        # at real-MSVD region scale)
        dev = ds.bank.to_device(
            dtype=jnp.dtype(cfg.model.compute_dtype))
        n_vid = ds.bank.n_videos
        # decode in fixed decode_batch chunks (one compiled executable,
        # bounded device memory at large splits) like the scored path
        bsz = cfg.decode.decode_batch
        run = jax.jit(lambda p, b, r: sample_decode(
            p, cfg.model, b, r, maxlen=cfg.decode.maxlen,
            temperature=args.temperature, top_k=args.top_k,
            n_samples=args.stochastic, step_fn=step_fn))
        tok_parts, scr_parts = [], []
        for s in range(0, n_vid, bsz):
            e = min(s + bsz, n_vid)
            chunk = {k: v[s:e] for k, v in dev.items()}
            pad = bsz - (e - s)
            if pad:
                chunk = {k: jnp.concatenate(
                    [v, jnp.zeros((pad,) + v.shape[1:], v.dtype)])
                    for k, v in chunk.items()}
                chunk["frame_mask"] = chunk["frame_mask"].at[e - s:, 0].set(1.0)
            out = run(state["params"], chunk,
                      jax.random.fold_in(jax.random.PRNGKey(args.seed), s))
            tok_parts.append(np.asarray(out.tokens)[: e - s])
            scr_parts.append(np.asarray(out.scores)[: e - s])
        toks = np.concatenate(tok_parts)
        scrs = np.concatenate(scr_parts)
        rows = []
        for i in range(n_vid):
            samples = [{"caption": " ".join(ds.vocab.decode(toks[i, j])),
                        "logprob": float(scrs[i, j])}
                       for j in range(toks.shape[1])]
            rows.append({"image_id": ds.bank.ids[i], "samples": samples})
        path = os.path.join(args.run_dir, f"{args.split}_sampled{qtag}.json")
        with open(path, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"stochastic samples (T={args.temperature}, "
              f"top_k={args.top_k}) -> {path}")
    if args.dump_attention > 0:
        import numpy as np
        from ..decode.greedy import greedy_decode
        n = min(args.dump_attention, ds.bank.n_videos)
        # compute_dtype: reuse the bank upload evaluate_split already
        # cached — a bare to_device() would pin a SECOND full-precision
        # copy of the bank in HBM for the process lifetime (~3.8 GB f32
        # at real-MSVD region scale)
        dev = ds.bank.to_device(
            dtype=jnp.dtype(cfg.model.compute_dtype))
        b = {k: v[:n] for k, v in dev.items()}
        out = greedy_decode(state["params"], cfg.model, b,
                            maxlen=cfg.decode.maxlen, step_fn=step_fn,
                            return_alphas=True)
        path = os.path.join(args.run_dir, f"{args.split}_attention{qtag}.npz")
        np.savez_compressed(
            path, ids=np.asarray(ds.bank.ids[:n]),
            tokens=np.asarray(out.tokens), alphas=np.asarray(out.alphas),
            frame_mask=np.asarray(b["frame_mask"]))
        print(f"attention maps -> {path}")
    # persist the scores next to the samples artifacts: score claims
    # for a run must be reproducible from a committed file, not from
    # captured stdout (the repo's BASELINE convention).  The corpus
    # provenance rides IN the artifact so a synthetic-corpus score can
    # never be over-read as paper quality.
    from ..data.corpus import corpus_provenance
    if cfg.data.dataset == "synthetic":
        # the in-memory generator IS the corpus — no marker file needed
        prov = {"synthetic": True, "generator": "data.batching."
                "synthetic_dataset (in-memory)",
                "note": "fabricated corpus — scores are harness pins, "
                        "NOT paper-comparable quality"}
    else:
        prov = corpus_provenance(cfg.data.data_dir)
    meta = {"split": args.split, "beam": cfg.decode.beam_size,
            "checkpoint": name, "scores": scores, "corpus": prov}
    if prov.get("synthetic"):
        meta["caveat"] = ("synthetic corpus — harness pin, NOT "
                          "paper-comparable quality")
    if not args.quant:
        # --quant decodes through an overridden dtype path; the run
        # dir's committed samples/scores artifacts stay the config's
        # own (scores still print below for the caller to capture)
        score_path = os.path.join(args.run_dir,
                                  f"{args.split}_scores.json")
        with open(score_path, "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)
    print(json.dumps(scores, indent=2, sort_keys=True))
    return 0


def run() -> int:
    try:
        return main()
    except FileNotFoundError as e:
        print(f"error: {e} (is --run-dir a training run directory?)",
              file=sys.stderr)
        return 2
    except (ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(run())
