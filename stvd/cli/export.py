"""Export a trained run as an AOT serving artifact (export_aot.py).

    python -m stvd.cli.export --run-dir runs/msvd --out artifacts/msvd \
        [--platforms cuda | cuda,cpu | cpu] [--batch 64] [--no-kernel] \
        [--check]

``--check`` deserializes the artifact and compares its captions on a
random feature batch against the live Captioner on the current platform
(requires the current platform to be one of the exported platforms).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--run-dir", required=True,
                    help="training run dir (config.json + ckpt + vocab)")
    ap.add_argument("--out", required=True, help="artifact output dir")
    ap.add_argument("--platforms", default="cuda",
                    help="comma list of jax.export platforms: cuda | cpu "
                         "| cuda,cpu")
    ap.add_argument("--batch", default="",
                    help="static decode batch size(s); a comma list "
                         "(e.g. '1,64,256') exports one graph per size "
                         "for bucketed serving (default: config "
                         "decode_batch)")
    ap.add_argument("--no-kernel", action="store_true",
                    help="force the XLA step (no Triton logit tail) even "
                         "for a cuda-only export")
    ap.add_argument("--quant", default=None, choices=["none", "int8"],
                    help="override model.decode_quant in the exported "
                         "graph (int8 = W8A8 gates matmul; weights stay "
                         "f32 call-time inputs, quantized inside the "
                         "graph)")
    ap.add_argument("--nbest", action="store_true",
                    help="also export the full-beam n-best graph per "
                         "batch size (requires beam_size > 1)")
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="export sharded over a 1-D data mesh of N "
                         "devices (multi-device serving; batch sizes "
                         "must divide by N; loader needs >= N devices; "
                         "implies the XLA step)")
    ap.add_argument("--model-parallel", type=int, default=0,
                    help="export tensor-parallel over a 2-D data x model "
                         "mesh (params sharded per TP_RULES; combines "
                         "with --data-parallel; loader needs >= N*M "
                         "devices; implies the XLA step)")
    ap.add_argument("--best", action="store_true", default=True)
    ap.add_argument("--check", action="store_true",
                    help="roundtrip-verify vs the live Captioner")
    args = ap.parse_args(argv)

    from ..utils import enable_compile_cache
    enable_compile_cache()

    from ..api import Captioner
    from ..export_aot import load_artifact, save_artifact

    platforms = tuple(p.strip() for p in args.platforms.split(",") if p.strip())
    cap = Captioner.from_run_dir(args.run_dir, best=args.best,
                                 quant=args.quant)
    use_kernel = False if args.no_kernel else None
    sizes = ([int(b) for b in args.batch.split(",") if b.strip()]
             if args.batch else None)
    manifest = save_artifact(args.out, cap.params, cap.cfg, cap.vocab,
                             platforms=platforms,
                             batch_sizes=sizes,
                             use_kernel=use_kernel,
                             nbest=args.nbest,
                             data_parallel=args.data_parallel,
                             model_parallel=args.model_parallel)
    print(f"exported {args.run_dir} -> {args.out} "
          f"(platforms={manifest['platforms']} "
          f"batch_sizes={manifest['batch_sizes']} "
          f"beam={manifest['beam_size']} "
          f"kernel={manifest['use_kernel']})")

    if args.check:
        import numpy as np
        from ..export_aot import current_platform
        platform = current_platform()
        if platform not in platforms:
            print(f"check skipped: current platform {platform!r} not in "
                  f"exported platforms {platforms}")
            return 0
        m = cap.cfg.model
        rng = np.random.RandomState(0)
        n = manifest["decode_batch"] + 1  # exercises the pad path
        feats = rng.randn(n, m.n_frames, m.ctx_dim).astype(np.float32)
        regs = (list(rng.randn(n, m.n_frames, m.n_regions, m.region_dim)
                     .astype(np.float32)) if m.use_spatial else None)
        mots = (list(rng.randn(n, m.n_frames, m.motion_dim)
                     .astype(np.float32)) if m.use_motion else None)
        served = load_artifact(args.out).caption(feats, regs, mots)
        live = cap.caption(feats, regs, mots)
        ok = served == live
        print(f"check: {'OK — artifact captions match live' if ok else 'MISMATCH'}"
              f" ({sum(a == b for a, b in zip(served, live))}/{n} equal)")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
