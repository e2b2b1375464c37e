"""Feature banks: packed, HBM-resident video feature tensors.

JAX replacement for the reference's per-video pickled feature dicts
(reference: ``data_engine.py:§Movie2Caption`` holds a python dict
vid -> ``(F, 1024)`` numpy array and subsamples/pads to K frames *per batch on
the host*).  Here the whole bank is packed **once** into dense arrays

    frames   (N, K, D)      float32/bfloat16
    frame_mask (N, K)       float32   (1 where a real frame exists)
    regions  (N, K, R, Dr)  optional (spatial attention; tuyunbin addition)
    motion   (N, K, Dm)     optional (MSR-VTT C3D stream)

and ``device_put`` to HBM.  Batches are then pure ``jnp.take`` gathers on
device — no host<->device transfer per step, which is the reference's main
data-path cost (SURVEY.md §3.1 "Host<->GPU crossing at every f_grad_shared").
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Dict, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class FeatureBank:
    """A packed feature bank for one split's videos.

    ``ids[i]`` names the video stored at row ``i``.
    """

    ids: Sequence[str]
    frames: np.ndarray            # (N, K, D)
    frame_mask: np.ndarray        # (N, K)
    regions: Optional[np.ndarray] = None   # (N, K, R, Dr)
    motion: Optional[np.ndarray] = None    # (N, K, Dm)
    # (dtype, sharding) -> device dict; see to_device.  Not part of the
    # bank's value (compare/repr excluded).
    _dev_cache: Dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def n_videos(self) -> int:
        return self.frames.shape[0]

    @property
    def n_frames(self) -> int:
        return self.frames.shape[1]

    def index(self) -> Dict[str, int]:
        return {v: i for i, v in enumerate(self.ids)}

    def save(self, path: str) -> None:
        arrs = dict(frames=self.frames, frame_mask=self.frame_mask,
                    ids=np.asarray(list(self.ids)))
        if self.regions is not None:
            arrs["regions"] = self.regions
        if self.motion is not None:
            arrs["motion"] = self.motion
        np.savez_compressed(path, **arrs)

    @staticmethod
    def load(path: str) -> "FeatureBank":
        z = np.load(path, allow_pickle=False)
        return FeatureBank(
            ids=[str(s) for s in z["ids"]],
            frames=z["frames"],
            frame_mask=z["frame_mask"],
            regions=z["regions"] if "regions" in z.files else None,
            motion=z["motion"] if "motion" in z.files else None,
        )

    def to_device(self, dtype=None, sharding=None):
        """device_put the bank to HBM (optionally sharded / cast).

        Returns a dict of jnp arrays; missing streams are omitted.

        Cached per (dtype, sharding): the train loop evaluates NLL and
        decodes the valid/test splits every ``valid_freq`` round, and each
        of those would otherwise re-upload the whole bank from the host
        (at real MSVD scale the region bank alone is ~1.9 GB bf16 for the
        test split — per round, twice per split).  The bank is treated as
        immutable after the first upload; mutate the numpy arrays only
        before any ``to_device`` call.
        """
        import jax
        import jax.numpy as jnp

        key = (None if dtype is None else jnp.dtype(dtype), sharding)
        cached = self._dev_cache.get(key)
        if cached is not None:
            return cached

        def put(x, cast):
            a = jnp.asarray(x, dtype=dtype if cast else None)
            return jax.device_put(a, sharding) if sharding is not None else a

        out = {"frames": put(self.frames, True),
               "frame_mask": put(self.frame_mask, False)}
        if self.regions is not None:
            out["regions"] = put(self.regions, True)
        if self.motion is not None:
            out["motion"] = put(self.motion, True)
        self._dev_cache[key] = out
        return out

    def to_device_sharded(self, mesh, dtype=None):
        """device_put the bank with its VIDEO axis sharded over the
        mesh's 'data' axis — each device holds ``N/n_data`` videos.

        This is the SURVEY.md §5 "if feature banks exceed HBM, shard
        the bank across chips" path made first-class: at MSR-VTT scale
        a spatial region bank is ~5.6 MB/video x 10k videos = ~56 GB,
        most of one 80 GB device, but 4 devices hold it at
        ~14 GB each.  Row lookups then run as an on-device sharded
        gather (see ``api.BankResident``) — requests still carry only
        int32 ids.

        Rows are zero-padded up to a multiple of the data-axis size
        (NamedSharding needs equal shards); padded rows are never
        addressed (``BankResident._rows_for`` validates ids against the
        real index).  Cached per (dtype, mesh) like ``to_device``.
        """
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        nd = int(mesh.shape["data"])
        key = ("sharded", None if dtype is None else jnp.dtype(dtype), mesh)
        cached = self._dev_cache.get(key)
        if cached is not None:
            return cached

        pad = (-self.n_videos) % nd
        sh = NamedSharding(mesh, P("data"))

        def put(x, cast):
            if pad:
                x = np.concatenate(
                    [x, np.zeros((pad,) + x.shape[1:], x.dtype)])
            return jax.device_put(
                jnp.asarray(x, dtype=dtype if cast else None), sh)

        out = {"frames": put(self.frames, True),
               "frame_mask": put(self.frame_mask, False)}
        if self.regions is not None:
            out["regions"] = put(self.regions, True)
        if self.motion is not None:
            out["motion"] = put(self.motion, True)
        self._dev_cache[key] = out
        return out


def subsample_frames(feat: np.ndarray, k: int) -> np.ndarray:
    """Evenly subsample (or keep) up to ``k`` frames from ``(F, ...)``.

    Mirrors the reference's ``get_sub_frames`` behavior (uniform stride
    when F > K, keep-all + pad when F <= K).
    """
    f = feat.shape[0]
    if f <= k:
        return feat
    idx = np.floor(np.linspace(0, f - 1, k)).astype(np.int64)
    return feat[idx]


def pack_bank(
    feats: Dict[str, np.ndarray],
    k: int,
    ids: Optional[Sequence[str]] = None,
    regions: Optional[Dict[str, np.ndarray]] = None,
    motion: Optional[Dict[str, np.ndarray]] = None,
) -> FeatureBank:
    """Pack per-video feature dicts into a dense ``FeatureBank``.

    ``feats[vid]`` is ``(F, D)``; regions[vid] is ``(F, R, Dr)``;
    motion[vid] is ``(F, Dm)``.  Frames beyond a video's length are
    zero-padded and masked out.
    """
    vids = list(ids) if ids is not None else sorted(feats)
    n = len(vids)
    d = next(iter(feats.values())).shape[-1]
    frames = np.zeros((n, k, d), dtype=np.float32)
    mask = np.zeros((n, k), dtype=np.float32)
    reg_arr = None
    mot_arr = None
    if regions is not None:
        r0 = next(iter(regions.values()))
        reg_arr = np.zeros((n, k, r0.shape[-2], r0.shape[-1]), dtype=np.float32)
    if motion is not None:
        m0 = next(iter(motion.values()))
        mot_arr = np.zeros((n, k, m0.shape[-1]), dtype=np.float32)
    for i, v in enumerate(vids):
        f = subsample_frames(np.asarray(feats[v], dtype=np.float32), k)
        frames[i, : f.shape[0]] = f
        mask[i, : f.shape[0]] = 1.0
        if reg_arr is not None:
            r = subsample_frames(np.asarray(regions[v], dtype=np.float32), k)
            reg_arr[i, : r.shape[0]] = r
        if mot_arr is not None:
            m = subsample_frames(np.asarray(motion[v], dtype=np.float32), k)
            mot_arr[i, : m.shape[0]] = m
    return FeatureBank(ids=vids, frames=frames, frame_mask=mask,
                       regions=reg_arr, motion=mot_arr)


def load_legacy_pickle(path: str) -> Dict[str, np.ndarray]:
    """Load a reference-era Python-2 feature pickle (vid -> array).

    Reference feature banks (FEAT_key_vidID... pkl files consumed by
    ``data_engine.py``) are Py2 pickles; ``encoding='latin1'`` decodes the
    numpy payloads correctly under Py3 (SURVEY.md §7).
    """
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="latin1")
    return {str(k): np.asarray(v) for k, v in d.items()}


def synthetic_bank(
    n_videos: int,
    k: int = 28,
    d: int = 1024,
    n_regions: int = 0,
    region_dim: int = 1024,
    motion_dim: int = 0,
    seed: int = 0,
    varying_lengths: bool = True,
) -> FeatureBank:
    """Deterministic random feature bank for tests/benchmarks.

    Each video gets a distinct feature signature so a model can bind
    captions to videos (the overfit test in SURVEY.md §4 depends on this).
    """
    rng = np.random.RandomState(seed)
    feats = {}
    regions = {} if n_regions else None
    motion = {} if motion_dim else None
    for i in range(n_videos):
        f = rng.randint(max(2, k // 2), k + 1) if varying_lengths else k
        base = rng.randn(1, d).astype(np.float32)  # video signature
        feats[f"vid{i:04d}"] = base + 0.1 * rng.randn(f, d).astype(np.float32)
        if regions is not None:
            rbase = rng.randn(1, 1, region_dim).astype(np.float32)
            regions[f"vid{i:04d}"] = (
                rbase + 0.1 * rng.randn(f, n_regions, region_dim).astype(np.float32))
        if motion is not None:
            mbase = rng.randn(1, motion_dim).astype(np.float32)
            motion[f"vid{i:04d}"] = (
                mbase + 0.1 * rng.randn(f, motion_dim).astype(np.float32))
    ids = sorted(feats)
    return pack_bank(feats, k, ids=ids, regions=regions, motion=motion)
