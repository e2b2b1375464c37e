"""Split evaluation: batched decode + metric scoring + parity artifacts.

Reference: ``metrics.py:§compute_score`` (SURVEY.md §3.5) — beam-decode
every video of a split, write ``{split}_samples.txt/json`` into the run
dir, score with the COCO metrics, return the metric dict used for model
selection.  The decode itself is the batched on-device path (decode/),
not the reference's per-video host loop.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config, DecodeConfig, ModelConfig
from ..data.batching import Dataset
from ..decode.beam import beam_decode
from ..decode.greedy import greedy_decode
from ..metrics.scorer import score_all
from ..model.decoder import StepFn


_DECODER_CACHE: Dict = {}


def _decoder_fn(mcfg: ModelConfig, dcfg: DecodeConfig, step_fn, mesh=None):
    """Jitted (params, batch) -> tokens decoder, cached per config so
    repeated validation rounds reuse one compiled executable.

    With a mesh, the batch is sharded over the data axis (data-parallel
    decoding across chips — no reference equivalent; the reference
    decodes one video at a time on one device).

    Cache keys hold the step_fn/mesh objects themselves (identity
    semantics) — never ``id()``, which can be reused after GC and serve
    a stale executable for a different function."""
    key = (mcfg, dcfg.beam_size, dcfg.maxlen, dcfg.length_norm,
           step_fn, mesh)
    fn = _DECODER_CACHE.get(key)
    if fn is None:
        def run(params, batch):
            if dcfg.beam_size <= 1:
                return greedy_decode(params, mcfg, batch,
                                     maxlen=dcfg.maxlen,
                                     step_fn=step_fn).tokens
            return beam_decode(params, mcfg, batch,
                               beam_size=dcfg.beam_size,
                               maxlen=dcfg.maxlen,
                               length_norm=dcfg.length_norm,
                               step_fn=step_fn).tokens
        if mesh is None:
            fn = jax.jit(run)
        else:
            from . import parallel
            fn = jax.jit(run,
                         in_shardings=(parallel.replicated(mesh),
                                       parallel.batch_sharding(mesh)),
                         out_shardings=parallel.replicated(mesh))
        _DECODER_CACHE[key] = fn
    return fn


def generate_captions(
    params,
    mcfg: ModelConfig,
    dev_bank: Dict[str, jax.Array],
    n_videos: int,
    dcfg: DecodeConfig,
    step_fn: Optional[StepFn] = None,
    mesh=None,
) -> List[List[int]]:
    """Decode one caption per video row; returns token-id lists.

    Videos are processed in fixed-size batches (last batch wraps, extras
    discarded) so exactly one executable is compiled.  With a mesh the
    batch axis is sharded across devices (data-parallel decode).
    """
    bsz = min(dcfg.decode_batch, n_videos)
    if mesh is not None:
        n_dev = mesh.devices.size
        bsz = max(n_dev, (bsz // n_dev) * n_dev)
    run_j = _decoder_fn(mcfg, dcfg, step_fn, mesh)
    # dispatch every batch first (device pipeline), then materialize —
    # per-batch host syncs would idle the device between batches
    pending = []
    for s in range(0, n_videos, bsz):
        rows = np.arange(s, min(s + bsz, n_videos))
        pad = bsz - len(rows)
        rows_p = np.concatenate([rows, np.zeros(pad, np.int64)]) if pad else rows
        batch = {"frames": jnp.take(dev_bank["frames"], rows_p, axis=0),
                 "frame_mask": jnp.take(dev_bank["frame_mask"], rows_p, axis=0)}
        for key in ("regions", "motion"):
            if key in dev_bank:
                batch[key] = jnp.take(dev_bank[key], rows_p, axis=0)
        pending.append((len(rows), run_j(params, batch)))
    out: List[List[int]] = []
    for n_real, toks_dev in pending:
        toks = np.asarray(toks_dev)
        out.extend(toks[i].tolist() for i in range(n_real))
    return out


def evaluate_split(
    params,
    cfg: Config,
    ds: Dataset,
    split: str = "valid",
    save_dir: Optional[str] = None,
    step_fn: Optional[StepFn] = None,
    mesh=None,
) -> Dict[str, float]:
    """Decode + score a split; writes the reference's parity artifacts
    (``{split}_samples.txt`` and ``.json``) when ``save_dir`` is given."""
    dev_bank = ds.bank.to_device(dtype=jnp.dtype(cfg.model.compute_dtype))
    token_rows = generate_captions(params, cfg.model, dev_bank,
                                   ds.bank.n_videos, cfg.decode,
                                   step_fn=step_fn, mesh=mesh)
    hyps: Dict[str, List[str]] = {}
    gts: Dict[str, List[str]] = {}
    for row, vid in enumerate(ds.bank.ids):
        if not ds.references[row]:
            continue  # video with no ground-truth captions: unscorable
        toks = ds.vocab.decode(token_rows[row])
        hyps[vid] = [" ".join(toks) if toks else "unk"]
        gts[vid] = [" ".join(r) for r in ds.references[row]]
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, f"{split}_samples.txt"), "w") as f:
            for vid in ds.bank.ids:
                if vid in hyps:
                    f.write(f"{vid}\t{hyps[vid][0]}\n")
        with open(os.path.join(save_dir, f"{split}_samples.json"), "w") as f:
            json.dump([{"image_id": v, "caption": hyps[v][0]}
                       for v in ds.bank.ids if v in hyps], f, indent=1)
    return score_all(gts, hyps, meteor_profile=cfg.train.meteor_profile)
