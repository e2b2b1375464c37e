"""High-level inference API.

The reference has no inference API beyond running metrics.py by hand;
this wraps checkpoint loading + batched on-device decoding behind one
object so a reference user can caption feature arrays in two lines:

    cap = Captioner.from_run_dir("runs/msvd")
    texts = cap.caption(features)          # (N, F, D) numpy -> [str]
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .config import Config
from .data.bank import pack_bank
from .data.text import Vocab
from .decode.beam import beam_decode
from .decode.greedy import greedy_decode
from .decode.sample import sample_decode
from .model.decoder import StepFn


def chunked_caption(run, params, batch: Dict, bsz: int, vocab: Vocab,
                    window: int = 4) -> List[str]:
    """Drive ``run(params, chunk) -> (tokens, scores)`` over an
    arbitrary-size batch in fixed ``bsz`` chunks (last chunk
    zero-padded) so only ONE executable is ever compiled regardless of
    request size.  Shared by the live Captioner and the AOT-exported
    loader (export_aot.ExportedCaptioner).

    A small window of chunks stays in flight: per-chunk host syncs
    would idle the device between chunks, while dispatching
    EVERYTHING would hold a padded duplicate of the whole request on
    device (an OOM risk at large N) — a bounded window gets the RTT
    overlap with bounded memory.
    """
    import jax.numpy as jnp
    n = int(batch["frames"].shape[0])
    pending: List = []
    out: List[str] = []

    def drain_one():
        count, toks = pending.pop(0)
        toks = np.asarray(toks)
        out.extend(" ".join(vocab.decode(toks[i])) for i in range(count))

    for s in range(0, n, bsz):
        e = min(s + bsz, n)
        chunk = {k: v[s:e] for k, v in batch.items()}
        pad = bsz - (e - s)
        if pad:
            chunk = {k: jnp.concatenate(
                [jnp.asarray(v), jnp.zeros((pad,) + v.shape[1:], v.dtype)])
                for k, v in chunk.items()}
            # padded rows need >=1 valid frame for a sane softmax
            chunk["frame_mask"] = chunk["frame_mask"].at[e - s:, 0].set(1.0)
        toks, _ = run(params, chunk)
        pending.append((e - s, toks))
        if len(pending) >= window:
            drain_one()
    while pending:
        drain_one()
    return out


def chunked_caption_ids(run_ids, params, bank: Dict, rows: np.ndarray,
                        bsz: int, vocab: Vocab, window: int = 4
                        ) -> List[str]:
    """Drive ``run_ids(params, bank, rows) -> (tokens, scores)`` — a
    FUSED gather+decode executable — over an arbitrary id list in fixed
    ``bsz`` chunks.  The bank-resident analogue of ``chunked_caption``:
    the host moves only int32 row indices per chunk; the feature gather
    happens inside the same dispatch as the decode (one dispatch per
    chunk instead of one per stream plus one per call).

    Short chunks are padded by REPEATING row 0 (a valid bank row, so
    masks stay sane with no edge-case plumbing); padded outputs are
    dropped on drain.
    """
    import jax.numpy as jnp
    n = int(rows.shape[0])
    pending: List = []
    out: List[str] = []

    def drain_one():
        count, toks = pending.pop(0)
        toks = np.asarray(toks)
        out.extend(" ".join(vocab.decode(toks[i])) for i in range(count))

    for s in range(0, n, bsz):
        e = min(s + bsz, n)
        chunk = rows[s:e]
        if e - s < bsz:
            chunk = np.concatenate(
                [chunk, np.zeros(bsz - (e - s), np.int32)])
        toks, _ = run_ids(params, bank, jnp.asarray(chunk))
        pending.append((e - s, toks))
        if len(pending) >= window:
            drain_one()
    while pending:
        drain_one()
    return out


def pack_request(model_cfg, features, regions=None, motion=None) -> Dict:
    """Raw per-video feature arrays -> a prepared device batch
    (frames/frame_mask[/regions/motion]) in the model's compute dtype.

    ``features`` is (N, F, D) or a list of (F_i, D) arrays (variable
    frame counts are subsampled/padded to the model's K).  Shared by
    ``Captioner``, ``ExportedCaptioner`` and the serving daemon so all
    request paths pack identically.
    """
    import jax.numpy as jnp
    if isinstance(features, np.ndarray) and features.ndim == 3:
        feats = {f"v{i}": features[i] for i in range(features.shape[0])}
    else:
        feats = {f"v{i}": np.asarray(f) for i, f in enumerate(features)}
    ids = [f"v{i}" for i in range(len(feats))]
    regs = ({v: np.asarray(r) for v, r in zip(ids, regions)}
            if regions is not None else None)
    mots = ({v: np.asarray(m) for v, m in zip(ids, motion)}
            if motion is not None else None)
    bank = pack_bank(feats, model_cfg.n_frames, ids=ids, regions=regs,
                     motion=mots)
    dev = bank.to_device(dtype=jnp.dtype(model_cfg.compute_dtype))
    batch = {"frames": dev["frames"], "frame_mask": dev["frame_mask"]}
    for k in ("regions", "motion"):
        if k in dev:
            batch[k] = dev[k]
    return batch


def _step_jnp():
    """The plain XLA step (the SPMD-partitionable one — a Pallas kernel
    does not partition under sharding propagation)."""
    from .model import step as step_mod
    return step_mod.step


def _bank_local_gather(keys, scatter: bool):
    """Per-shard body of the sharded-bank row gather (runs INSIDE a
    ``shard_map`` over the 1-D 'data' mesh): each shard looks up the
    rows it owns (out-of-range rows clamp to a valid index and mask to
    zero) and ONE collective assembles the batch —
    ``psum_scatter`` landing each chip its contiguous slice when the
    chunk divides the axis, plain ``psum`` (replicated) otherwise.

    Factored out of the standalone gather so the fused
    gather+decode executable (``Captioner._caption_rows``) can run it
    in the SAME shard_map region as the per-shard decode."""
    import jax
    import jax.numpy as jnp

    def local(rows, bank):
        d = jax.lax.axis_index("data")
        out = {}
        for k in keys:
            leaf = bank[k]
            sn = leaf.shape[0]
            li = rows - d * sn
            valid = (li >= 0) & (li < sn)
            g = leaf[jnp.clip(li, 0, sn - 1)]
            g = g * valid.reshape(
                (-1,) + (1,) * (g.ndim - 1)).astype(g.dtype)
            out[k] = (jax.lax.psum_scatter(
                g, "data", scatter_dimension=0, tiled=True)
                if scatter else jax.lax.psum(g, "data"))
        return out

    return local


class BankResident:
    """Mixin: device-resident feature bank + id-addressed captioning.

    Production video captioning serves PRE-EXTRACTED features (the
    reference's own data model — features are offline artifacts,
    SURVEY.md §2 row 12), so the bank belongs WITH the model: attach it
    once, then a caption request names video ids and moves bytes of
    text, not megabytes of floats: a spatial request carries ~2.8 MB of
    region features per video, and id-addressed requests remove that
    input transfer from the serving path entirely (the gather runs on
    device against the resident bank).
    """

    _bank_dev = None
    _bank_index: Optional[Dict[str, int]] = None
    _bank_mesh = None
    _ids_params = None

    def attach_bank(self, bank, dtype=None, mesh=None) -> int:
        """device_put a FeatureBank once (cast to compute dtype);
        returns the number of resident videos.

        ``mesh`` (a 1-D ``Mesh(('data',))``) shards the bank's VIDEO
        axis across the mesh — for banks that outgrow one device's
        memory (an MSR-VTT-scale spatial bank is ~56 GB; see
        ``FeatureBank.to_device_sharded``).  Id requests then run a
        sharded on-device gather (each device looks up the rows it owns;
        one ``psum_scatter`` lands each device its slice of the decode
        batch) fused into the same dispatch as the decode."""
        import jax.numpy as jnp
        dt = jnp.dtype(dtype or self.cfg.model.compute_dtype)
        self._bank_index = bank.index()
        self._bank_mesh = mesh
        self._bank_dev = (bank.to_device(dtype=dt) if mesh is None
                          else bank.to_device_sharded(mesh, dtype=dt))
        # a mesh-sharded batch cannot meet single-device params in one
        # jit: the ids path needs a mesh-replicated weight copy (the
        # AOT loader already places params on its serving mesh — reuse)
        self._ids_params = None
        if mesh is not None and getattr(self, "_mesh", None) is None:
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P
            self._ids_params = jax.device_put(
                self.params, NamedSharding(mesh, P()))
        # fused gather+decode executables close over the previous
        # bank's stream-key set — rebuild on re-attach
        self._ids_jit = None
        self._nbest_ids_jit = {}
        if hasattr(self, "_call_cache"):
            self._call_cache = {k: v for k, v in self._call_cache.items()
                                if not (isinstance(k, tuple)
                                        and k and k[0] == "ids")}
        return bank.n_videos

    @property
    def bank_ids(self) -> List[str]:
        if self._bank_index is None:
            return []
        return sorted(self._bank_index, key=self._bank_index.__getitem__)

    def _bank_keys(self) -> List[str]:
        """Only the streams THIS model consumes: a bank may carry more
        (e.g. regions for a temporal model) and AOT graphs reject
        extra pytree keys (battery r4d caught this live)."""
        m = self.cfg.model
        keys = ["frames", "frame_mask"]
        if m.use_spatial:
            keys.append("regions")
        if m.use_motion:
            keys.append("motion")
        bad = [k for k in keys if k not in self._bank_dev]
        if bad:
            raise ValueError(f"bank lacks streams the model needs: {bad}")
        return keys

    def _rows_for(self, ids: Sequence[str]) -> np.ndarray:
        if self._bank_dev is None:
            raise ValueError("no feature bank attached "
                             "(attach_bank / cli/serve --bank)")
        idx = self._bank_index
        missing = [v for v in ids if v not in idx]
        if missing:
            raise ValueError(f"unknown video ids: {missing[:5]}"
                             + ("..." if len(missing) > 5 else ""))
        return np.asarray([idx[v] for v in ids], np.int32)

    def _bank_gather_fn(self, keys: Sequence[str]):
        """Jittable ``(bank, rows) -> batch`` row gather.

        Single-device bank: plain row indexing (fuses into the decode
        jit).  Sharded bank (``attach_bank(mesh=...)``): an explicit
        ``shard_map`` — each shard gathers the rows it owns (rows
        outside its range clamp to a valid index and mask to zero) and
        ONE ``psum_scatter`` over the 'data' axis lands each device
        its contiguous slice of the decode batch, so the decode runs
        data-parallel directly on the scattered output.  Explicit
        collectives rather than GSPMD propagation: left to itself the
        partitioner may all-gather the sharded operand, which is
        exactly the HBM blow-up a sharded bank exists to avoid.  Chunk
        sizes not divisible by the data axis fall back to a plain
        ``psum`` (batch replicated — correct, just not sharded).
        """
        keys = tuple(keys)
        mesh = self._bank_mesh
        if mesh is None:
            def gather(bank, rows):
                return {k: bank[k][rows] for k in keys}
            return gather

        import jax
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        nd = int(mesh.shape["data"])

        def gather(bank, rows):
            scatter = rows.shape[0] % nd == 0
            local = _bank_local_gather(keys, scatter)

            sm = shard_map(
                local, mesh=mesh,
                in_specs=(P(), {k: P("data") for k in keys}),
                out_specs={k: (P("data") if scatter else P())
                           for k in keys})
            return sm(rows, {k: bank[k] for k in keys})

        return gather

    def _gather_ids(self, ids: Sequence[str]) -> Dict:
        import jax.numpy as jnp
        rows = jnp.asarray(self._rows_for(ids))
        bank = {k: self._bank_dev[k] for k in self._bank_keys()}
        return self._bank_gather_fn(self._bank_keys())(bank, rows)

    def caption_ids(self, ids: Sequence[str]) -> List[str]:
        """Caption resident-bank videos by id (zero feature transfer —
        the on-device gather is FUSED into the decode executable, so a
        request costs one dispatch per chunk; see chunked_caption_ids)."""
        return self._caption_rows(self._rows_for(ids))

    def _caption_rows(self, rows: np.ndarray) -> List[str]:
        raise NotImplementedError  # Captioner / ExportedCaptioner

    def nbest_ids(self, ids: Sequence[str], n: Optional[int] = None,
                  norm: bool = True) -> List[List[tuple]]:
        rows = self._rows_for(ids)
        if (self._bank_mesh is not None
                and getattr(self, "_nbest_rows", None) is not None):
            # fused shard_map gather + per-shard beam n-best: no
            # feature bytes move to host
            return self._nbest_rows(rows, n=n, norm=norm)
        batch = self._gather_ids(ids)
        if self._bank_mesh is not None and getattr(self, "_mesh", None) is None:
            # rehome the mesh-sharded gather onto the default device —
            # caption_nbest's jit runs against single-device params.
            # Only reachable for loaders without a fused n-best path.
            import jax
            batch = jax.device_get(batch)
        return self.caption_nbest(batch, n=n, norm=norm)


class Captioner(BankResident):
    """Caption pre-extracted video features with a trained model."""

    def __init__(self, params, cfg: Config, vocab: Vocab,
                 step_fn: Optional[StepFn] = None):
        import jax

        from .model.kernel import get_step_fn
        self.params = params
        self.cfg = cfg
        self.vocab = vocab
        # None = auto: the fused logit tail on the GPU, XLA elsewhere
        step_fn = step_fn or get_step_fn(None)
        self.step_fn = step_fn
        self._run_fn = self._make_run(step_fn)  # unjitted: composed by
        self._run = jax.jit(self._run_fn)       # the fused ids path
        self._ids_jit = None
        self._nbest_ids_jit = {}

    def _make_run(self, step_fn):
        """(params, batch) -> (tokens, scores) with the given step fn."""
        cfg = self.cfg
        d = cfg.decode

        def run(params, batch):
            if d.beam_size <= 1:
                out = greedy_decode(params, cfg.model, batch,
                                    maxlen=d.maxlen, step_fn=step_fn)
                return out.tokens, out.scores
            out = beam_decode(params, cfg.model, batch,
                              beam_size=d.beam_size, maxlen=d.maxlen,
                              length_norm=d.length_norm, step_fn=step_fn)
            return out.tokens, out.norm_scores

        return run

    @staticmethod
    def from_run_dir(run_dir: str, best: bool = True,
                     vocab: Optional[Vocab] = None,
                     step_fn: Optional[StepFn] = None,
                     quant: Optional[str] = None) -> "Captioner":
        """Load config + checkpoint (+ vocab.pkl if present) from a
        training run directory.  ``quant`` overrides
        ``model.decode_quant`` ('int8' enables the W8A8 serving path
        regardless of how the model was trained/saved)."""
        import dataclasses

        import jax
        from .train.loop import init_train_state, restore_checkpoint
        with open(os.path.join(run_dir, "config.json")) as f:
            cfg = Config.from_json(f.read())
        if quant is not None:
            from .config import validate
            cfg = validate(dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model,
                                               decode_quant=quant)))
        template = init_train_state(jax.random.PRNGKey(0), cfg.model,
                                    cfg.train)
        name = "ckpt_best" if best else "ckpt"
        path = os.path.join(run_dir, name)
        if not os.path.exists(path):
            path = os.path.join(run_dir, "ckpt")
        state = restore_checkpoint(path, template)
        if vocab is None:
            vpath = os.path.join(run_dir, "vocab.pkl")
            if os.path.exists(vpath):
                vocab = Vocab.load_pickle(vpath)
            else:
                raise ValueError("no vocab.pkl in run dir; pass vocab=")
        return Captioner(state["params"], cfg, vocab, step_fn)

    def swap_params(self, params) -> None:
        """Hot-swap same-architecture weights mid-run (live mode).
        Key set and shapes must match; compiled executables are
        untouched (params are call-time jit inputs).  The ids-path
        mesh-replicated copy, if any, is re-placed."""
        import jax
        import jax.numpy as jnp
        from .export_aot import _check_swap_compatible
        new = {k: jnp.asarray(v) for k, v in dict(params).items()}
        _check_swap_compatible(self.params, new)
        new = {k: v.astype(self.params[k].dtype) for k, v in new.items()}
        self.params = new
        if self._ids_params is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            self._ids_params = jax.device_put(
                new, NamedSharding(self._bank_mesh, P()))

    def caption_batch(self, batch: Dict) -> List[str]:
        """Caption a prepared device batch (frames/frame_mask/...).

        Arbitrary batch sizes are processed in fixed ``decode_batch``
        chunks (last chunk zero-padded) so only ONE executable is ever
        compiled regardless of request size.
        """
        return chunked_caption(self._run, self.params, batch,
                               self.cfg.decode.decode_batch, self.vocab)

    def _caption_rows(self, rows: np.ndarray) -> List[str]:
        """Fused gather+decode over resident-bank row indices: the
        bank lookup traces INTO the decode jit, so an id request is one
        dispatch per chunk.

        With a SHARDED bank (attach_bank(mesh=...)) gather AND decode
        run in ONE ``shard_map`` region over the 'data' mesh: the
        gather's psum_scatter lands each device its slice of the batch
        and the decode runs PER SHARD on it, so the step's logit-tail
        kernel runs on each device's local rows.  Chunks that don't
        divide the data axis fall back to a replicated batch (psum
        gather + redundant identical decode on every device — correct,
        just not sharded)."""
        import jax
        if self._ids_jit is None:
            keys = self._bank_keys()
            mesh = self._bank_mesh
            run_decode = self._run_fn
            if mesh is None:
                gather = self._bank_gather_fn(keys)

                def run_ids(params, bank, rows):
                    return run_decode(params, gather(bank, rows))
            else:
                from jax.sharding import PartitionSpec as P
                nd = int(mesh.shape["data"])

                def run_ids(params, bank, rows):
                    scatter = rows.shape[0] % nd == 0
                    gather_local = _bank_local_gather(keys, scatter)

                    def local(params, bank, rows):
                        return run_decode(params,
                                          gather_local(rows, bank))

                    sm = jax.shard_map(
                        local, mesh=mesh,
                        in_specs=(P(), {k: P("data") for k in keys},
                                  P()),
                        out_specs=((P("data"), P("data")) if scatter
                                   else (P(), P())),
                        check_vma=False)   # the Triton pallas_call has
                    # no varying-axes rule
                    return sm(params, bank, rows)

            self._ids_jit = jax.jit(run_ids)
        bank = {k: self._bank_dev[k] for k in self._bank_keys()}
        params = (self._ids_params if self._ids_params is not None
                  else self.params)
        return chunked_caption_ids(self._ids_jit, params, bank,
                                   rows, self.cfg.decode.decode_batch,
                                   self.vocab)

    def _nbest_rows(self, rows: np.ndarray, n: Optional[int] = None,
                    norm: bool = True) -> List[List[tuple]]:
        """Sharded-bank n-best by row index: the shard_map gather and a
        PER-SHARD beam decode (all hypotheses) run in one executable,
        so bulk n-best over a sharded bank moves int32 ids in and
        tokens out — never feature bytes (see ``nbest_ids``).  Chunked
        at ``decode_batch`` like ``caption_ids``."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        cfg = self.cfg
        if cfg.decode.beam_size <= 1:
            raise ValueError("n-best export requires beam_size > 1")
        mesh = self._bank_mesh
        if bool(norm) not in self._nbest_ids_jit:
            keys = self._bank_keys()
            nd = int(mesh.shape["data"])
            step_fn = self.step_fn

            def run_ids(params, bank, rows):
                scatter = rows.shape[0] % nd == 0
                gather_local = _bank_local_gather(keys, scatter)

                def local(params, bank, rows):
                    out = beam_decode(
                        params, cfg.model, gather_local(rows, bank),
                        beam_size=cfg.decode.beam_size,
                        maxlen=cfg.decode.maxlen,
                        length_norm=cfg.decode.length_norm,
                        step_fn=step_fn)
                    return out.all_tokens, (out.all_norm_scores if norm
                                            else out.all_scores)

                sm = jax.shard_map(
                    local, mesh=mesh,
                    in_specs=(P(), {k: P("data") for k in keys}, P()),
                    out_specs=((P("data"), P("data")) if scatter
                               else (P(), P())),
                    check_vma=False)
                return sm(params, bank, rows)

            self._nbest_ids_jit[bool(norm)] = jax.jit(run_ids)
        run = self._nbest_ids_jit[bool(norm)]
        params = (self._ids_params if self._ids_params is not None
                  else self.params)
        bank = {k: self._bank_dev[k] for k in self._bank_keys()}
        bsz = self.cfg.decode.decode_batch
        out: List[List[tuple]] = []
        total = int(rows.shape[0])
        for s in range(0, total, bsz):
            e = min(s + bsz, total)
            chunk = rows[s:e]
            if e - s < bsz:   # pad by repeating row 0 (a valid row)
                chunk = np.concatenate(
                    [chunk, np.zeros(bsz - (e - s), np.int32)])
            toks, scores = run(params, bank, jnp.asarray(chunk))
            toks, scores = np.asarray(toks), np.asarray(scores)
            k = n or toks.shape[1]
            for b in range(e - s):
                order = np.argsort(-scores[b])[:k]
                out.append([(" ".join(self.vocab.decode(toks[b, j])),
                             float(scores[b, j])) for j in order])
        return out

    def caption_nbest(self, batch: Dict, n: Optional[int] = None,
                      norm: bool = True) -> List[List[tuple]]:
        """All beam hypotheses per video: [(text, logprob), ...] sorted
        best-first (the reference's gen_sample returns every finished
        hypothesis + score; beam_decode keeps them in all_tokens).

        ``norm=True`` (default) ranks by the length-normalized score —
        the same quantity best-beam selection uses, so entry 0 is
        always the caption ``caption()`` would return.  ``norm=False``
        ranks by raw log-prob (can disagree with the best-beam choice
        when length_norm > 0).  The returned logprob matches the
        chosen ranking."""
        import jax
        cfg = self.cfg
        if cfg.decode.beam_size <= 1:
            raise ValueError("n-best export requires beam_size > 1")

        def run(params, batch):
            out = beam_decode(params, cfg.model, batch,
                              beam_size=cfg.decode.beam_size,
                              maxlen=cfg.decode.maxlen,
                              length_norm=cfg.decode.length_norm,
                              step_fn=self.step_fn)
            return out.all_tokens, (out.all_norm_scores if norm
                                    else out.all_scores)

        toks, scores = jax.jit(run)(self.params, batch)
        toks, scores = np.asarray(toks), np.asarray(scores)
        n = n or toks.shape[1]
        out = []
        for b in range(toks.shape[0]):
            order = np.argsort(-scores[b])[:n]
            out.append([(" ".join(self.vocab.decode(toks[b, j])),
                         float(scores[b, j])) for j in order])
        return out

    def caption_sample(self, batch: Dict, rng=None, temperature: float = 1.0,
                       top_k: int = 0, n_samples: int = 1
                       ) -> List[List[str]]:
        """Stochastically sampled captions (reference gen_sample
        argmax=False): n_samples independent draws per video."""
        import jax
        if rng is None:
            rng = jax.random.PRNGKey(0)
        out = jax.jit(
            lambda p, b, r: sample_decode(
                p, self.cfg.model, b, r, maxlen=self.cfg.decode.maxlen,
                temperature=temperature, top_k=top_k, n_samples=n_samples,
                step_fn=self.step_fn).tokens
        )(self.params, batch, rng)
        toks = np.asarray(out)
        return [[" ".join(self.vocab.decode(toks[b, j]))
                 for j in range(toks.shape[1])] for b in range(toks.shape[0])]

    def caption(self,
                features: Union[np.ndarray, Sequence[np.ndarray]],
                regions: Optional[Sequence[np.ndarray]] = None,
                motion: Optional[Sequence[np.ndarray]] = None,
                ) -> List[str]:
        """Caption raw per-video feature arrays.

        ``features`` is (N, F, D) or a list of (F_i, D) arrays (variable
        frame counts are subsampled/padded to the model's K).
        """
        return self.caption_batch(
            pack_request(self.cfg.model, features, regions, motion))

    def nbest(self,
              features: Union[np.ndarray, Sequence[np.ndarray]],
              regions: Optional[Sequence[np.ndarray]] = None,
              motion: Optional[Sequence[np.ndarray]] = None,
              n: Optional[int] = None, norm: bool = True
              ) -> List[List[tuple]]:
        """``caption_nbest`` over raw feature arrays (the packing of
        ``caption``): per video, [(text, logprob), ...] best-first."""
        return self.caption_nbest(
            pack_request(self.cfg.model, features, regions, motion),
            n=n, norm=norm)
