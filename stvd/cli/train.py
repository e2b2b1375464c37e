"""Training entry point (reference ``train.py``: build options dict,
call ``model_attention.train(**options)`` — SURVEY.md §3.1).

Usage:
    python -m stvd.cli.train --config cfg.json [--preset msvd-beam]
        [--set train.max_epochs=3] [--max-updates N] [--use-kernel]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from ..config import Config, preset, validate
from ..data.corpus import load_splits
from ..model.kernel import get_step_fn
from ..train import parallel
from ..train.loop import fit
from ..utils.logging import MetricsLogger


def apply_overrides(cfg: Config, sets) -> Config:
    """--set section.key=value overrides (typed via the dataclass)."""
    for s in sets or []:
        path, _, raw = s.partition("=")
        section, _, key = path.partition(".")
        sub = getattr(cfg, section)
        old = getattr(sub, key)
        if isinstance(old, bool):
            val = raw.lower() in ("1", "true", "yes")
        elif isinstance(old, int):
            val = int(raw)
        elif isinstance(old, float):
            val = float(raw)
        else:
            val = raw
        cfg = dataclasses.replace(
            cfg, **{section: dataclasses.replace(sub, **{key: val})})
    return cfg


def build_config(args) -> Config:
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    elif args.preset:
        cfg = preset(args.preset)
    else:
        cfg = Config()
    return validate(apply_overrides(cfg, args.set))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", help="config json path")
    ap.add_argument("--preset", help="named preset (see stvd.config.preset)")
    ap.add_argument("--set", action="append",
                    help="override: section.key=value")
    ap.add_argument("--max-updates", type=int, default=None)
    ap.add_argument("--use-kernel", action="store_true", default=None,
                    help="force the Triton logit-tail kernel (default: "
                         "auto — the kernel on the GPU, XLA elsewhere)")
    ap.add_argument("--no-kernel", dest="use_kernel",
                    action="store_false", help="force the XLA path")
    # Three-state parallelism flags: absent -> honor the config (so the
    # msvd-dp preset / recipe keys work without extra flags), present ->
    # override it either way.
    ap.add_argument("--data-parallel", action="store_true", default=None,
                    help="shard the batch over all local devices "
                         "(default: cfg.train.data_parallel)")
    ap.add_argument("--no-data-parallel", dest="data_parallel",
                    action="store_false", help="force single-device")
    ap.add_argument("--shard-map", action="store_true", default=None,
                    help="with data parallelism: explicit lax.psum "
                         "collectives instead of pjit sharding propagation "
                         "(default: cfg.train.use_shard_map)")
    ap.add_argument("--no-shard-map", dest="shard_map",
                    action="store_false", help="force the pjit path")
    ap.add_argument("--model-parallel", type=int, default=None,
                    metavar="N",
                    help="tensor parallelism: shard the big GEMM weights "
                         "over an N-wide 'model' mesh axis (2-D data x "
                         "model mesh; default: cfg.train.model_parallel)")
    args = ap.parse_args(argv)

    from ..utils import enable_compile_cache
    enable_compile_cache()
    cfg = build_config(args)
    os.makedirs(cfg.train.save_dir, exist_ok=True)
    with open(os.path.join(cfg.train.save_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())

    splits = load_splits(cfg)
    # persist the vocab next to checkpoints (Captioner.from_run_dir)
    splits["train"].vocab.save_pickle(
        os.path.join(cfg.train.save_dir, "vocab.pkl"))
    step_fn = get_step_fn(args.use_kernel)
    dp = (cfg.train.data_parallel if args.data_parallel is None
          else args.data_parallel)
    mp = (cfg.train.model_parallel if args.model_parallel is None
          else args.model_parallel)
    if mp > 1:
        # TP implies a mesh over all devices even without --data-parallel
        # (the data axis is then len(devices) // mp, possibly 1)
        mesh = parallel.make_mesh_2d(model_parallel=mp)
    elif dp:
        mesh = parallel.make_mesh()
    else:
        mesh = None
    logger = MetricsLogger(cfg.train.save_dir,
                           tensorboard=cfg.train.tensorboard)
    try:
        result = fit(cfg, splits["train"], splits.get("valid"),
                     step_fn=step_fn, mesh=mesh, logger=logger,
                     max_updates=args.max_updates,
                     use_shard_map=args.shard_map,
                     test_ds=splits.get("test"))
        logger.log("done", best_metric=result.best_metric,
                   best_step=result.best_step)
    finally:
        logger.close()
    return 0


def run() -> int:
    try:
        return main()
    except (ValueError, FileNotFoundError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(run())
