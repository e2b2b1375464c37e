"""AOT-exported decode artifacts: serving without model-building Python.

The reference re-builds and re-compiles its sampler in every process
(`model_attention.py:§build_sampler` -> theano.function f_init/f_next);
there is no way to ship a compiled decoder.  XLA's AOT compilation
model makes the equivalent first-class: ``jax.export`` serializes the
jitted decode graph (StableHLO, with the Triton logit-tail kernel
already lowered) into a self-contained artifact directory that a
serving process deserializes and calls — no stvd model code runs at
serving time, no tracing, and the graph is pinned (a model-code change
cannot silently alter a deployed decoder).

Artifact layout (a directory)::

    decode_b{N}.jaxexport   one serialized jax.export.Exported
                       (StableHLO bytes + its signature, see
                       ``dump_exported``) per static batch size N —
                       bucketed serving (see save_artifact)
    nbest_b{N}.jaxexport    optional (``nbest=True``): the full-beam
                       hypothesis graph per size (all tokens + both
                       score variants) for ranked n-best serving
    params.npz         checkpoint weights.  Weights are CALL-TIME inputs
                       to the exported graph, so one artifact serves any
                       same-architecture checkpoint (pass ``params=`` to
                       ``load_artifact``) — re-export only on config or
                       code changes.
    vocab.pkl          worddict (reference pickle format)
    config.json        full stvd Config (audit + loader shapes)
    manifest.json      shapes / platforms / jax version / beam setup
                       (a graph holding the Triton kernel is bound to
                       the JAX version it was exported with)

The exported callable has the same contract as ``Captioner._run``:
``(params, batch) -> (tokens, scores)`` at the static decode batch
size; the loader reuses ``api.chunked_caption`` for arbitrary request
sizes, so serving behavior is identical to the live path (pinned by
tests/test_export_aot.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from . import api as _api
from .config import Config
from .data.text import Vocab

# the custom call a Pallas Triton-route kernel lowers to; jax.export
# refuses to serialize it unless this one target is allowed explicitly
_TRITON_CALL_TARGET = "__gpu$xla.gpu.triton"


def current_platform() -> str:
    """The current backend under ``jax.export``'s canonical platform
    names ('cuda', 'rocm', 'cpu', ...) — ``jax.default_backend()`` says
    'gpu' for what an artifact's manifest calls 'cuda'."""
    from jax import export as jexport
    return jexport.default_export_platform()


def _export(fn, platforms, use_kernel: bool):
    from jax import export as jexport
    checks = ([jexport.DisabledSafetyCheck.custom_call(_TRITON_CALL_TARGET)]
              if use_kernel else [])
    return jexport.export(fn, platforms=list(platforms),
                          disabled_checks=checks)


_EXPORTED_FORMAT = "stvd-exported-v1"


def dump_exported(exp) -> bytes:
    """Serialize a ``jax.export.Exported`` without ``Exported.serialize``
    (which needs the ``flatbuffers`` package, absent from some GPU
    installations): the StableHLO bytes and every signature field are
    pickled as they are, with HLO shardings as OpSharding protos.  The
    vjp is not kept — serving never differentiates the graph.  Read it
    back with ``load_exported``; like vocab.pkl, load only artifacts
    this program wrote."""
    import dataclasses
    import pickle
    fields = {f.name: getattr(exp, f.name)
              for f in dataclasses.fields(exp) if f.name != "_get_vjp"}
    for key in ("in_shardings_hlo", "out_shardings_hlo"):
        fields[key] = tuple(None if h is None
                            else h.to_proto().SerializeToString()
                            for h in fields[key])
    return pickle.dumps({"format": _EXPORTED_FORMAT, "fields": fields})


def load_exported(blob: bytes):
    """Inverse of ``dump_exported``."""
    import pickle
    from jax import export as jexport
    from jax._src.lib import xla_client
    obj = pickle.loads(blob)
    if not isinstance(obj, dict) or obj.get("format") != _EXPORTED_FORMAT:
        raise ValueError("not an stvd exported-graph file")
    fields = dict(obj["fields"])

    def hlo(b):
        if b is None:
            return None
        proto = xla_client.OpSharding()
        proto.ParseFromString(b)
        return xla_client.HloSharding.from_proto(proto)

    for key in ("in_shardings_hlo", "out_shardings_hlo"):
        fields[key] = tuple(hlo(b) for b in fields[key])
    return jexport.Exported(**fields, _get_vjp=None)


def _default_use_kernel(platforms, mesh_axes) -> bool:
    """The fused logit tail goes into graphs for CUDA alone and without
    a serving mesh (a ``pallas_call`` does not partition under sharding
    propagation)."""
    return tuple(platforms) == ("cuda",) and not mesh_axes


def _decode_run_fn(cfg: Config, step_fn):
    """The (params, batch) -> (tokens, scores) decode program — the
    same body ``Captioner.__init__`` jits (greedy when beam_size <= 1,
    length-normalized beam otherwise)."""
    from .decode.beam import beam_decode
    from .decode.greedy import greedy_decode
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


def _nbest_run_fn(cfg: Config, step_fn):
    """(params, batch) -> (all_tokens, all_norm_scores, all_scores) —
    the beam's full hypothesis set, same quantities
    ``Captioner.caption_nbest`` reads (both score variants ship so the
    loader can rank raw or length-normalized without re-export)."""
    from .decode.beam import beam_decode
    d = cfg.decode
    if d.beam_size <= 1:
        raise ValueError("n-best export requires decode.beam_size > 1")

    def run(params, batch):
        out = beam_decode(params, cfg.model, batch,
                          beam_size=d.beam_size, maxlen=d.maxlen,
                          length_norm=d.length_norm, step_fn=step_fn)
        return out.all_tokens, out.all_norm_scores, out.all_scores

    return run


def example_batch(cfg: Config, batch_size: Optional[int] = None) -> Dict:
    """A zeros device batch with exactly the shapes/dtypes the serving
    path produces (built through pack_bank + to_device so the two can
    never drift)."""
    from .data.bank import pack_bank
    import jax.numpy as jnp
    m = cfg.model
    bsz = batch_size or cfg.decode.decode_batch
    ids = [f"v{i}" for i in range(bsz)]
    feats = {v: np.zeros((m.n_frames, m.ctx_dim), np.float32) for v in ids}
    regs = ({v: np.zeros((m.n_frames, m.n_regions, m.region_dim),
                         np.float32) for v in ids}
            if m.use_spatial else None)
    mots = ({v: np.zeros((m.n_frames, m.motion_dim), np.float32)
             for v in ids} if m.use_motion else None)
    bank = pack_bank(feats, m.n_frames, ids=ids, regions=regs, motion=mots)
    dev = bank.to_device(dtype=jnp.dtype(m.compute_dtype))
    # a valid frame per row keeps the masked softmax sane (same
    # convention as chunked_caption's padding)
    batch = {"frames": dev["frames"],
             "frame_mask": dev["frame_mask"].at[:, 0].set(1.0)}
    for k in ("regions", "motion"):
        if k in dev:
            batch[k] = dev[k]
    return batch


def _serving_mesh(data_parallel: int):
    """A 1-D Mesh(('data',)) over the first N local devices (serving
    DP: batch sharded on the data axis, params replicated)."""
    import jax
    devs = jax.devices()
    if len(devs) < data_parallel:
        raise ValueError(
            f"data_parallel={data_parallel} needs {data_parallel} devices; "
            f"only {len(devs)} visible")
    from jax.sharding import Mesh
    return Mesh(np.array(devs[:data_parallel]), ("data",))


def _serving_mesh_2d(data_parallel: int, model_parallel: int):
    """A 2-D Mesh(('data', 'model')) over the first dp*mp local devices
    (serving TP: params sharded per train.parallel.TP_RULES, batch on
    the data axis)."""
    import jax
    devs = jax.devices()
    need = data_parallel * model_parallel
    if len(devs) < need:
        raise ValueError(
            f"data_parallel={data_parallel} x model_parallel="
            f"{model_parallel} needs {need} devices; "
            f"{len(devs)} visible")
    from jax.sharding import Mesh
    return Mesh(np.array(devs[:need]).reshape(data_parallel,
                                              model_parallel),
                ("data", "model"))


def _mesh_jit(run, mesh, params=None):
    """jit ``run`` with serving-mesh shardings.

    1-D ('data',) mesh: params replicated, batch + outputs sharded on
    the leading (batch) dim.  2-D ('data', 'model') mesh: params placed
    per ``train.parallel.TP_RULES`` (gates GEMMs row-sharded — one psum
    per matmul over 'model', vocab logits column-sharded; see
    decode/parallel.py for the decode-side TP rationale), batch and
    outputs on 'data' and replicated over 'model'."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    sh = NamedSharding(mesh, P("data"))
    if "model" in mesh.axis_names:
        from .train.parallel import state_shardings
        pshard = state_shardings(params, mesh)
    else:
        pshard = NamedSharding(mesh, P())
    return jax.jit(run, in_shardings=(pshard, sh), out_shardings=sh)


def export_decoder(params, cfg: Config,
                   platforms: Sequence[str] = ("cuda",),
                   batch_size: Optional[int] = None,
                   use_kernel: Optional[bool] = None,
                   _example: Optional[Dict] = None,
                   mesh=None):
    """Trace + lower the decode program for the target platform(s) and
    return the ``jax.export.Exported``.

    ``use_kernel`` picks the step function statically (the exported
    graph cannot re-select per backend): default = the fused Triton
    logit tail iff the export targets CUDA only and has no mesh.  Other
    exports use the XLA path (the kernel lowers for CUDA alone).

    ``mesh`` (a 1-D ``Mesh(('data',))`` or 2-D ``Mesh(('data',
    'model'))``) exports a sharded serving graph: batch over 'data';
    params replicated (1-D) or placed per ``train.parallel.TP_RULES``
    (2-D), with XLA collectives baked into the StableHLO.  The artifact
    then requires the same device count at load time.
    """
    import jax

    from .model.kernel import get_step_fn
    platforms = tuple(platforms)
    mesh_axes = tuple(mesh.axis_names) if mesh is not None else ()
    if use_kernel is None:
        use_kernel = _default_use_kernel(platforms, mesh_axes)
    if use_kernel and platforms != ("cuda",):
        raise ValueError(
            f"the Triton logit tail lowers for cuda only; "
            f"platforms={platforms} requires use_kernel=False")
    if use_kernel and mesh_axes:
        # same boundary as decode/parallel.py: a pallas_call does not
        # partition under sharding propagation
        raise ValueError("a sharded export requires use_kernel=False")
    run = _decode_run_fn(cfg, get_step_fn(use_kernel))
    batch = _example if _example is not None \
        else example_batch(cfg, batch_size)
    jrun = _mesh_jit(run, mesh, params) if mesh is not None else jax.jit(run)
    return _export(jrun, platforms, use_kernel)(params, batch)


def save_artifact(out_dir: str, params, cfg: Config, vocab: Vocab,
                  platforms: Sequence[str] = ("cuda",),
                  batch_size: Optional[int] = None,
                  use_kernel: Optional[bool] = None,
                  batch_sizes: Optional[Sequence[int]] = None,
                  nbest: bool = False,
                  data_parallel: int = 0,
                  model_parallel: int = 0) -> Dict:
    """Export the decoder and write the full serving artifact directory.

    ``batch_sizes`` (e.g. ``(1, 64, 256)``) exports one graph per
    static batch size — bucketed serving: the loader routes each
    request to the best-fitting executable (bulk chunks ride the
    largest size for throughput, the remainder picks the smallest size
    that fits, so a 1-video request pays the b=1 latency graph, not a
    padded 256-row batch).  Default: one size (``batch_size`` or the
    config's decode_batch).

    ``nbest=True`` additionally exports an n-best graph per size
    (all beam hypotheses + both score variants) so the loader can
    serve ranked hypothesis lists; requires beam_size > 1.

    ``data_parallel=N`` exports every graph sharded over a 1-D
    ``Mesh(('data',))`` of N devices (batch split over 'data', params
    replicated) — multi-device serving.  Every batch
    size must be divisible by N; the loader rebuilds the mesh and
    requires >= N devices.

    ``model_parallel=M`` (with ``data_parallel`` defaulting to 1)
    exports over a 2-D ``Mesh(('data', 'model'))`` of N*M devices with
    params sharded per ``train.parallel.TP_RULES`` — tensor-parallel
    serving for decoder dims that outgrow one device (the XLA step;
    see decode/parallel.py for why the Pallas kernel does not apply
    here).

    Returns the manifest dict.
    """
    import jax
    os.makedirs(out_dir, exist_ok=True)
    platforms = tuple(platforms)
    if use_kernel is None:
        use_kernel = _default_use_kernel(
            platforms, data_parallel or model_parallel)
    if batch_sizes is None:
        batch_sizes = (batch_size or cfg.decode.decode_batch,)
    sizes = sorted(set(int(b) for b in batch_sizes))
    if not sizes or sizes[0] < 1:
        raise ValueError(f"batch_sizes must be positive ints: {batch_sizes}")
    mesh = None
    dp = int(data_parallel or 0)
    if model_parallel and model_parallel > 1:
        dp = dp or 1
        bad = [b for b in sizes if b % dp]
        if bad:
            raise ValueError(
                f"data_parallel={dp} requires divisible batch "
                f"sizes; got {bad}")
        mesh = _serving_mesh_2d(dp, int(model_parallel))
    elif dp:
        bad = [b for b in sizes if b % dp]
        if bad:
            raise ValueError(
                f"data_parallel={dp} requires divisible batch "
                f"sizes; got {bad}")
        mesh = _serving_mesh(dp)
    inputs = {}
    for b in sizes:
        # one example batch per size serves trace AND manifest (at
        # spatial reference scale the zeros region bank is ~720 MB on
        # device — build each once)
        example = example_batch(cfg, b)
        exp = export_decoder(params, cfg, platforms=platforms,
                             use_kernel=use_kernel, _example=example,
                             mesh=mesh)
        with open(os.path.join(out_dir, f"decode_b{b}.jaxexport"),
                  "wb") as f:
            f.write(dump_exported(exp))
        inputs[str(b)] = {k: [list(v.shape), str(v.dtype)]
                          for k, v in example.items()}
        if nbest:
            from .model.kernel import get_step_fn
            nrun = _nbest_run_fn(cfg, get_step_fn(use_kernel))
            njit = _mesh_jit(nrun, mesh, params) if mesh is not None \
                else jax.jit(nrun)
            nexp = _export(njit, platforms, use_kernel)(params, example)
            with open(os.path.join(out_dir, f"nbest_b{b}.jaxexport"),
                      "wb") as f:
                f.write(dump_exported(nexp))
    np.savez(os.path.join(out_dir, "params.npz"),
             **{k: np.asarray(v) for k, v in params.items()})
    vocab.save_pickle(os.path.join(out_dir, "vocab.pkl"))
    cfg = dataclasses.replace(
        cfg, decode=dataclasses.replace(cfg.decode,
                                        decode_batch=sizes[-1]))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    manifest = {
        "format": "stvd-aot-decode-v2",
        "platforms": list(platforms),
        "jax_version": jax.__version__,
        "batch_sizes": sizes,
        "decode_batch": sizes[-1],
        "beam_size": cfg.decode.beam_size,
        "maxlen": cfg.decode.maxlen,
        "use_kernel": bool(use_kernel),
        "nbest": bool(nbest),
        "data_parallel": int(dp),
        "model_parallel": int(model_parallel or 0),
        "param_count": int(sum(int(np.prod(v.shape))
                               for v in params.values())),
        "inputs": inputs,
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def _place_params(params, mesh):
    """Place a params dict for serving: replicated over a 1-D DP mesh,
    per TP_RULES over a 2-D data x model mesh, untouched otherwise."""
    if mesh is None:
        return params
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    if "model" in mesh.axis_names:
        from .train.parallel import state_shardings
        return jax.device_put(params, state_shardings(params, mesh))
    return jax.device_put(params, NamedSharding(mesh, P()))


def _check_swap_compatible(cur, new) -> None:
    """Same-architecture check for hot weight swaps: identical key set
    and per-leaf shapes (shapes are the architecture contract; dtypes
    may differ — callers cast to their serving dtype)."""
    missing = sorted(set(cur) - set(new))
    extra = sorted(set(new) - set(cur))
    if missing or extra:
        raise ValueError(f"swap params key mismatch: missing={missing} "
                         f"extra={extra}")
    for k in cur:
        if tuple(cur[k].shape) != tuple(new[k].shape):
            raise ValueError(
                f"swap params shape mismatch at {k!r}: "
                f"{tuple(cur[k].shape)} -> {tuple(new[k].shape)}")


class ExportedCaptioner(_api.BankResident):
    """Serve captions from an AOT artifact (see module docstring).

    Supports ``caption_batch`` / ``caption`` with the exact semantics of
    the live ``Captioner`` (same chunking helper), and
    ``caption_nbest`` / ``nbest`` when the artifact was saved with
    ``nbest=True``.  Stochastic sampling needs live tracing — use
    ``Captioner`` for that.
    """

    def __init__(self, exported: Dict[int, object], params, cfg: Config,
                 vocab: Vocab, manifest: Optional[Dict] = None,
                 nbest_exported: Optional[Dict[int, object]] = None,
                 mesh=None):
        self._exported = dict(exported)   # {batch_size: Exported}
        self._nbest = dict(nbest_exported or {})
        self._mesh = mesh
        self._call_cache = {}             # id(Exported) -> wrapped call
        self.params = _place_params(params, mesh)
        self.cfg = cfg
        self.vocab = vocab
        self.manifest = manifest or {}

    def swap_params(self, params) -> None:
        """Hot-swap same-architecture weights on a LIVE loader (mid-run
        weight swap, no re-export, no restart — weights are call-time
        inputs of the exported graphs by design).  Validates the key
        set and shapes against the current params, then re-places
        across the serving mesh under the same rules as construction.
        Compiled graphs and resident banks are untouched."""
        import jax.numpy as jnp
        new = {k: jnp.asarray(v) for k, v in dict(params).items()}
        _check_swap_compatible(self.params, new)
        # graphs pin the input avals: cast to the exported dtype
        new = {k: v.astype(self.params[k].dtype) for k, v in new.items()}
        self.params = _place_params(new, self._mesh)

    def _call_fn(self, exported):
        """exported.call, wrapped for the serving mesh when the
        artifact is data-parallel: batch leaves are resharded onto the
        'data' axis and the call runs under jit in the multi-device
        context the graph was exported for.  Wrappers are memoized per
        Exported — a fresh ``jax.jit`` object per request would
        retrace on every call."""
        key = id(exported)
        cached = self._call_cache.get(key)
        if cached is not None:
            return cached
        if self._mesh is None:
            run = exported.call
        else:
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P
            sh = NamedSharding(self._mesh, P("data"))
            jcall = jax.jit(exported.call)

            def run(params, batch, _jcall=jcall, _sh=sh):
                batch = {k: jax.device_put(v, _sh)
                         for k, v in batch.items()}
                return _jcall(params, batch)

        self._call_cache[key] = run
        return run

    def caption_batch(self, batch: Dict) -> List[str]:
        """Bucketed routing: bulk chunks ride the largest exported
        batch size; the remainder uses the smallest size that fits
        (a 1-video request on a (1, 64, 256) artifact runs the b=1
        graph, not a 256-row padded batch)."""
        from .api import chunked_caption
        sizes = sorted(self._exported)
        bmax = sizes[-1]
        n = int(batch["frames"].shape[0])
        nbulk = (n // bmax) * bmax
        out: List[str] = []
        if nbulk:
            bulk = {k: v[:nbulk] for k, v in batch.items()}
            out += chunked_caption(self._call_fn(self._exported[bmax]),
                                   self.params, bulk, bmax, self.vocab)
        rem = n - nbulk
        if rem:
            bfit = next(b for b in sizes if b >= rem)
            tail = {k: v[nbulk:] for k, v in batch.items()}
            out += chunked_caption(self._call_fn(self._exported[bfit]),
                                   self.params, tail, bfit, self.vocab)
        return out

    def _ids_call_fn(self, exported):
        """Fused gather+decode for the bank-resident path: the resident
        bank's row gather traces INTO the AOT graph's call under one
        jit, so an id request is ONE dispatch per chunk.  Memoized per
        exported graph; invalidated by attach_bank on re-attach."""
        key = ("ids", id(exported))
        cached = self._call_cache.get(key)
        if cached is not None:
            return cached
        import jax
        gather = self._bank_gather_fn(self._bank_keys())
        inner = self._call_fn(exported)

        def run_ids(params, bank, rows, _inner=inner, _gather=gather):
            return _inner(params, _gather(bank, rows))

        run = jax.jit(run_ids)
        self._call_cache[key] = run
        return run

    def _caption_rows(self, rows: np.ndarray) -> List[str]:
        """Bucketed routing over resident-bank row indices — the id
        analogue of caption_batch: bulk chunks ride the largest
        exported batch size, the remainder the smallest that fits."""
        from .api import chunked_caption_ids
        bank = {k: self._bank_dev[k] for k in self._bank_keys()}
        sizes = sorted(self._exported)
        bmax = sizes[-1]
        n = int(rows.shape[0])
        nbulk = (n // bmax) * bmax
        out: List[str] = []
        if nbulk:
            out += chunked_caption_ids(
                self._ids_call_fn(self._exported[bmax]), self.params,
                bank, rows[:nbulk], bmax, self.vocab)
        rem = n - nbulk
        if rem:
            bfit = next(b for b in sizes if b >= rem)
            out += chunked_caption_ids(
                self._ids_call_fn(self._exported[bfit]), self.params,
                bank, rows[nbulk:], bfit, self.vocab)
        return out

    def caption(self,
                features: Union[np.ndarray, Sequence[np.ndarray]],
                regions: Optional[Sequence[np.ndarray]] = None,
                motion: Optional[Sequence[np.ndarray]] = None,
                ) -> List[str]:
        # Captioner.caption only touches self.cfg.model and
        # self.caption_batch, both of which this class provides — the
        # raw-features packing path is shared, not reimplemented
        from .api import Captioner
        return Captioner.caption(self, features, regions, motion)

    def caption_nbest(self, batch: Dict, n: Optional[int] = None,
                      norm: bool = True) -> List[List[tuple]]:
        """All beam hypotheses per video from the exported n-best
        graph, [(text, logprob), ...] best-first — same semantics as
        ``Captioner.caption_nbest`` (requires an artifact saved with
        ``nbest=True``).  Requests larger than the exported batch are
        chunked at the largest n-best size (last chunk zero-padded)."""
        import jax.numpy as jnp
        if not self._nbest:
            raise ValueError(
                "artifact has no n-best graphs; re-export with "
                "save_artifact(..., nbest=True) / cli/export --nbest")
        bsz = sorted(self._nbest)[-1]
        call = self._call_fn(self._nbest[bsz])
        total = int(batch["frames"].shape[0])
        toks_parts, score_parts = [], []
        for s in range(0, total, bsz):
            e = min(s + bsz, total)
            chunk = {k: v[s:e] for k, v in batch.items()}
            pad = bsz - (e - s)
            if pad:
                chunk = {k: jnp.concatenate(
                    [jnp.asarray(v),
                     jnp.zeros((pad,) + v.shape[1:], v.dtype)])
                    for k, v in chunk.items()}
                chunk["frame_mask"] = chunk["frame_mask"].at[e - s:, 0] \
                    .set(1.0)
            all_toks, norm_scores, raw_scores = call(self.params, chunk)
            toks_parts.append(np.asarray(all_toks)[: e - s])
            score_parts.append(np.asarray(
                norm_scores if norm else raw_scores)[: e - s])
        toks = np.concatenate(toks_parts)
        scores = np.concatenate(score_parts)
        n = n or toks.shape[1]
        out = []
        for b in range(total):
            order = np.argsort(-scores[b])[:n]
            out.append([(" ".join(self.vocab.decode(toks[b, j])),
                         float(scores[b, j])) for j in order])
        return out

    def nbest(self,
              features: Union[np.ndarray, Sequence[np.ndarray]],
              regions: Optional[Sequence[np.ndarray]] = None,
              motion: Optional[Sequence[np.ndarray]] = None,
              n: Optional[int] = None, norm: bool = True
              ) -> List[List[tuple]]:
        """``caption_nbest`` over raw feature arrays (same packing as
        ``caption``; duck-type-compatible with ``Captioner.nbest``)."""
        from .api import pack_request
        return self.caption_nbest(
            pack_request(self.cfg.model, features, regions, motion),
            n=n, norm=norm)


def load_artifact(path: str, params=None) -> ExportedCaptioner:
    """Deserialize a saved artifact.  ``params`` (a flat dict of arrays)
    overrides the shipped checkpoint — same-architecture weight swaps
    need no re-export."""
    import jax.numpy as jnp
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    fmt = manifest.get("format")
    if fmt != "stvd-aot-decode-v2":
        raise ValueError(f"{path}: unknown artifact format {fmt!r} "
                         "(expected stvd-aot-decode-v2; re-export "
                         "artifacts of the v1 format)")
    platform = current_platform()
    if platform not in manifest["platforms"]:
        raise ValueError(
            f"{path}: artifact was exported for {manifest['platforms']} "
            f"but the current platform is {platform!r} — re-export with "
            f"--platforms {platform} (or include it in the list)")
    exported = {}
    nbest_exported = {}
    for b in manifest["batch_sizes"]:
        with open(os.path.join(path, f"decode_b{b}.jaxexport"), "rb") as f:
            exported[int(b)] = load_exported(f.read())
        npath = os.path.join(path, f"nbest_b{b}.jaxexport")
        if manifest.get("nbest") and os.path.exists(npath):
            with open(npath, "rb") as f:
                nbest_exported[int(b)] = load_exported(f.read())
    with open(os.path.join(path, "config.json")) as f:
        cfg = Config.from_json(f.read())
    if params is None:
        with np.load(os.path.join(path, "params.npz")) as z:
            params = {k: jnp.asarray(z[k]) for k in z.files}
    vocab = Vocab.load_pickle(os.path.join(path, "vocab.pkl"))
    mesh = None
    dp = int(manifest.get("data_parallel") or 0)
    mp = int(manifest.get("model_parallel") or 0)
    if mp > 1:
        mesh = _serving_mesh_2d(dp or 1, mp)   # raises if < dp*mp devices
    elif dp:
        mesh = _serving_mesh(dp)   # raises if < dp devices visible
    return ExportedCaptioner(exported, params, cfg, vocab, manifest,
                             nbest_exported=nbest_exported, mesh=mesh)
