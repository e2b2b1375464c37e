"""Vocabulary and caption encoding.

JAX replacement for the reference's worddict handling
(reference: ``data_engine.py:§Movie2Caption`` loads ``worddict.pkl`` mapping
word -> id with the convention id 0 == EOS ('<eos>'), id 1 == UNK; captions
are encoded on the fly and capped at ``n_words``).  We keep the exact id
convention so legacy worddict pickles load unchanged, but encode to fixed
``(maxlen,)`` int32 arrays with masks — XLA wants static shapes, not the
reference's ragged python lists.
"""

from __future__ import annotations

import pickle
import re
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

EOS_ID = 0   # reference: word id 0 terminates a caption ('<eos>')
UNK_ID = 1   # reference: out-of-vocab words map to 1 ('UNK')
EOS_TOKEN = "<eos>"
UNK_TOKEN = "UNK"

_TOKEN_RE = re.compile(r"[a-z0-9']+")


def tokenize(text: str) -> List[str]:
    """Lowercase word tokenizer for building corpora from raw captions.

    (The reference consumes pre-tokenized CAP.pkl entries; this is for the
    raw-text path and the synthetic dataset.)
    """
    return _TOKEN_RE.findall(text.lower())


class Vocab:
    """word <-> id mapping with the reference's 0=EOS / 1=UNK convention."""

    def __init__(self, word_to_id: Dict[str, int]):
        w2i = dict(word_to_id)
        w2i.setdefault(EOS_TOKEN, EOS_ID)
        w2i.setdefault(UNK_TOKEN, UNK_ID)
        if w2i[EOS_TOKEN] != EOS_ID or w2i[UNK_TOKEN] != UNK_ID:
            raise ValueError("vocab must reserve id 0 for <eos>, 1 for UNK")
        self.word_to_id = w2i
        self.id_to_word = {i: w for w, i in w2i.items()}

    def __len__(self) -> int:
        return max(self.word_to_id.values()) + 1

    @staticmethod
    def build(corpus: Iterable[Sequence[str]], max_words: int = 20000) -> "Vocab":
        """Build a frequency-ranked vocab from tokenized captions
        (ids 2.. in descending frequency, matching the reference's
        worddict construction)."""
        from collections import Counter
        counts: Counter = Counter()
        for toks in corpus:
            counts.update(toks)
        w2i = {EOS_TOKEN: EOS_ID, UNK_TOKEN: UNK_ID}
        for i, (w, _) in enumerate(counts.most_common(max_words - 2)):
            w2i[w] = i + 2
        return Vocab(w2i)

    @staticmethod
    def load_pickle(path: str) -> "Vocab":
        """Load a legacy worddict.pkl (Python-2 pickle; latin1 decoding —
        see SURVEY.md §7 'Py2 pickle ingestion')."""
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="latin1")
        return Vocab({str(k): int(v) for k, v in d.items()})

    def save_pickle(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.word_to_id, f, protocol=2)

    def encode(self, tokens: Sequence[str], n_words: int) -> List[int]:
        """tokens -> ids, capping at ``n_words`` (reference caps ids >=
        n_words to UNK at batch-prep time)."""
        out = []
        for t in tokens:
            i = self.word_to_id.get(t, UNK_ID)
            out.append(i if i < n_words else UNK_ID)
        return out

    def decode(self, ids: Sequence[int]) -> List[str]:
        """ids -> tokens, stopping at EOS (reference un-tokenization in
        metrics.py)."""
        toks = []
        for i in ids:
            if i == EOS_ID:
                break
            toks.append(self.id_to_word.get(int(i), UNK_TOKEN))
        return toks


def encode_captions(
    captions: Sequence[Sequence[str]],
    vocab: Vocab,
    maxlen: int,
    n_words: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode tokenized captions to fixed-shape arrays.

    Returns ``(tokens, mask)`` with shapes ``(N, maxlen)`` int32 /
    float32.  Each row is ``w_1 .. w_L <eos> 0 0 ..``; the mask covers
    ``L+1`` positions (the EOS prediction is supervised, matching the
    reference's ``prepare_data`` which appends a zero row and masks L+1
    steps).  Captions longer than ``maxlen-1`` tokens are dropped by the
    caller (reference drops caps with len >= maxlen); here they are
    truncated to ``maxlen-1`` to keep shapes total.
    """
    n = len(captions)
    toks = np.zeros((n, maxlen), dtype=np.int32)
    mask = np.zeros((n, maxlen), dtype=np.float32)
    for r, cap in enumerate(captions):
        ids = vocab.encode(cap, n_words)[: maxlen - 1]
        L = len(ids)
        toks[r, :L] = ids
        # position L holds EOS (already 0); mask covers words + EOS
        mask[r, : L + 1] = 1.0
    return toks, mask
