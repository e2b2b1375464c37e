"""Dataset assembly and fixed-shape batching.

JAX replacement for the reference's ``Movie2Caption`` +
``HomogeneousData`` + ``prepare_data`` (reference ``data_engine.py``):

- the reference buckets captions by length to avoid padding (dynamic batch
  shapes — poison for XLA); we instead pad every caption to a static
  ``maxlen`` with a mask and keep ONE compiled executable,
- the reference re-builds padded numpy tensors on the host per step; we
  pre-encode all (video_idx, tokens, mask) triples once and a batch is a
  device-side gather from the HBM-resident bank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .bank import FeatureBank, synthetic_bank
from .text import Vocab, encode_captions


@dataclasses.dataclass
class CaptionSet:
    """All encoded (video, caption) pairs for one split.

    ``video_idx[i]`` is the row of caption i's video in the FeatureBank.
    """

    video_idx: np.ndarray   # (M,) int32
    tokens: np.ndarray      # (M, maxlen) int32
    mask: np.ndarray        # (M, maxlen) float32

    @property
    def n(self) -> int:
        return self.tokens.shape[0]


@dataclasses.dataclass
class Dataset:
    """One split: a feature bank plus its encoded captions and raw refs."""

    bank: FeatureBank
    captions: CaptionSet
    vocab: Vocab
    # raw tokenized references per video row (for metric computation)
    references: List[List[List[str]]]


def build_caption_set(
    pairs: Sequence[Tuple[str, Sequence[str]]],
    bank: FeatureBank,
    vocab: Vocab,
    maxlen: int,
    n_words: int,
) -> CaptionSet:
    """Encode (video_id, tokens) pairs against a bank.

    Pairs whose video is missing from the bank are dropped (the reference
    filters the same way when feature files are incomplete).
    """
    idx = bank.index()
    vids, caps = [], []
    for v, toks in pairs:
        if v in idx:
            vids.append(idx[v])
            caps.append(toks)
    tokens, mask = encode_captions(caps, vocab, maxlen, n_words)
    return CaptionSet(
        video_idx=np.asarray(vids, dtype=np.int32), tokens=tokens, mask=mask)


class BatchIterator:
    """Shuffled fixed-shape minibatch index iterator.

    Replaces the reference's ``HomogeneousData`` length-bucketing: every
    batch has identical static shape (B, maxlen), so XLA compiles exactly
    one executable.  The final ragged remainder of an epoch is padded by
    *wrapping* (repeating examples) with a per-example weight of 0 for the
    wrapped slots, keeping shapes static without biasing the loss.
    """

    def __init__(self, n: int, batch_size: int, seed: int = 0,
                 shuffle: bool = True):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self._epoch = 0

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (indices (B,), weight (B,)) for one pass over the data."""
        order = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(order)
        self._epoch += 1
        b = self.batch_size
        for s in range(0, self.n, b):
            chunk = order[s: s + b]
            n_real = len(chunk)
            w = np.ones(b, dtype=np.float32)
            if n_real < b:
                chunk = np.concatenate([chunk, np.resize(order, b - n_real)])
                w[n_real:] = 0.0
            yield chunk.astype(np.int32), w


class BucketedBatchIterator:
    """Length-bucketed minibatches — the compute equivalent of the
    reference's ``HomogeneousData`` (``data_engine.py:§HomogeneousData``,
    SURVEY.md §2 row 5), XLA-style.

    The reference groups captions by exact length for pad-free dynamic
    batches; dynamic shapes recompile XLA per length.  Here captions are
    grouped into a FEW static ``(B, T_bucket)`` shapes (one executable
    each): a caption of length L lands in the smallest bucket >= L, so
    real MSVD captions (mean ~7 tokens vs maxlen 30) stop paying ~3-4x
    pad-step FLOPs in the train scan.  Loss is invariant: the dropped
    columns are all-masked (pinned by tests/test_data.py).

    Yields ``(indices (B,), weight (B,), t_bucket)``; batch order is
    shuffled ACROSS buckets per epoch (like HomogeneousData's random
    bucket order), ragged tails pad by wrapping within the bucket with
    weight 0.
    """

    def __init__(self, lengths: Sequence[int], batch_size: int,
                 buckets: Sequence[int], seed: int = 0,
                 shuffle: bool = True):
        lengths = np.asarray(lengths, dtype=np.int64)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if lengths.size and int(lengths.max()) > self.buckets[-1]:
            raise ValueError(
                f"max caption length {int(lengths.max())} exceeds the "
                f"largest bucket {self.buckets[-1]}")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        edges = np.asarray(self.buckets)
        assign = edges[np.searchsorted(edges, lengths)]
        self._groups = [(int(t), np.flatnonzero(assign == t))
                        for t in self.buckets
                        if np.any(assign == t)]
        self.n = int(lengths.size)

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        b = self.batch_size
        batches = []
        for t_b, idxs in self._groups:
            order = idxs.copy()
            if self.shuffle:
                self._rng.shuffle(order)
            for s in range(0, len(order), b):
                chunk = order[s: s + b]
                n_real = len(chunk)
                w = np.ones(b, dtype=np.float32)
                if n_real < b:
                    chunk = np.concatenate(
                        [chunk, np.resize(order, b - n_real)])
                    w[n_real:] = 0.0
                batches.append((chunk.astype(np.int32), w, t_b))
        if self.shuffle:
            self._rng.shuffle(batches)
        return iter(batches)


def gather_batch(dev_bank: Dict, caps: CaptionSet, idx: np.ndarray,
                 seq_len: int = 0):
    """Assemble a device batch: gather features by caption's video row.

    ``dev_bank`` is the dict returned by ``FeatureBank.to_device``.
    ``seq_len`` > 0 slices tokens/mask to a bucket length (the columns
    beyond a caption's bucket are all-pad, so the loss is unchanged).
    Returns a dict of jnp arrays (frames, frame_mask, [regions, motion],
    tokens, token_mask).
    """
    import jax.numpy as jnp

    rows = jnp.asarray(caps.video_idx[idx])
    tokens = caps.tokens[idx]
    mask = caps.mask[idx]
    if seq_len:
        tokens = tokens[:, :seq_len]
        mask = mask[:, :seq_len]
    out = {
        "frames": jnp.take(dev_bank["frames"], rows, axis=0),
        "frame_mask": jnp.take(dev_bank["frame_mask"], rows, axis=0),
        "tokens": jnp.asarray(tokens),
        "token_mask": jnp.asarray(mask),
    }
    if "regions" in dev_bank:
        out["regions"] = jnp.take(dev_bank["regions"], rows, axis=0)
    if "motion" in dev_bank:
        out["motion"] = jnp.take(dev_bank["motion"], rows, axis=0)
    return out


# ---------------------------------------------------------------------------
# Synthetic dataset (tests, benchmarks, CI — no real MSVD features on disk)
# ---------------------------------------------------------------------------

_SYN_WORDS = [
    "a", "the", "man", "woman", "dog", "cat", "is", "playing", "running",
    "jumping", "eating", "cooking", "guitar", "piano", "ball", "water",
    "riding", "bike", "horse", "singing", "dancing", "cutting", "onion",
    "slicing", "bread", "driving", "car", "walking", "street", "talking",
    "phone", "baby", "laughing", "bird", "flying", "swimming", "pool",
    "group", "people", "video", "game", "boy", "girl", "kicking", "throwing",
]


def synthetic_dataset(
    n_videos: int = 64,
    captions_per_video: int = 2,
    k: int = 28,
    d: int = 1024,
    n_regions: int = 0,
    region_dim: int = 1024,
    motion_dim: int = 0,
    maxlen: int = 30,
    seed: int = 0,
    n_words: Optional[int] = None,
) -> Dataset:
    """Deterministic synthetic dataset: each video row gets captions drawn
    from a per-video word pattern so that features fully determine the
    caption (enables exact-recovery overfit tests — SURVEY.md §4).

    ``n_words`` caps the vocab like the reference's worddict truncation
    (rarer words encode as UNK) so token ids always fit the model's
    logit table; default keeps the full synthetic word list."""
    bank = synthetic_bank(n_videos, k=k, d=d, n_regions=n_regions,
                          region_dim=region_dim, motion_dim=motion_dim,
                          seed=seed)
    rng = np.random.RandomState(seed + 1)
    cap = len(_SYN_WORDS) + 2 if n_words is None else n_words
    vocab = Vocab.build([[w] for w in _SYN_WORDS], max_words=cap)
    pairs: List[Tuple[str, List[str]]] = []
    references: List[List[List[str]]] = []
    for i, vid in enumerate(bank.ids):
        refs = []
        # deterministic per-video caption pattern
        base_len = 4 + (i % 5)
        widx = rng.randint(0, len(_SYN_WORDS), size=(captions_per_video, base_len))
        for c in range(captions_per_video):
            toks = [_SYN_WORDS[j] for j in widx[c]]
            pairs.append((vid, toks))
            refs.append(toks)
        references.append(refs)
    caps = build_caption_set(pairs, bank, vocab, maxlen, cap)
    return Dataset(bank=bank, captions=caps, vocab=vocab, references=references)
