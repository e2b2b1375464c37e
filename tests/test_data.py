"""Data-layer tests: vocab, caption encoding, feature banks, batching.

Covers the reference behaviors of data_engine.py (SURVEY.md §2 row 5)
rebuilt as static-shape XLA-friendly equivalents.
"""

import numpy as np
import pytest

from stvd.data.bank import (FeatureBank, pack_bank, subsample_frames,
                            synthetic_bank)
from stvd.data.batching import BatchIterator, build_caption_set, synthetic_dataset
from stvd.data.text import EOS_ID, UNK_ID, Vocab, encode_captions, tokenize


def test_vocab_conventions():
    v = Vocab.build([["a", "b", "a"], ["a", "c"]])
    assert v.word_to_id["<eos>"] == EOS_ID
    assert v.word_to_id["UNK"] == UNK_ID
    assert v.word_to_id["a"] == 2  # most frequent first
    assert v.decode(v.encode(["a", "b", "zzz"], len(v))) == ["a", "b", "UNK"]


def test_vocab_pickle_roundtrip(tmp_path):
    v = Vocab.build([["x", "y"]])
    p = str(tmp_path / "worddict.pkl")
    v.save_pickle(p)
    v2 = Vocab.load_pickle(p)
    assert v2.word_to_id == v.word_to_id


def test_encode_captions_mask_covers_eos():
    v = Vocab.build([["a", "b"]])
    toks, mask = encode_captions([["a", "b"], ["a"] * 50], v, maxlen=6,
                                 n_words=len(v))
    # row 0: [a, b, EOS, 0, 0, 0], mask over 3 (words + EOS supervised)
    assert toks[0].tolist()[:3] == [2, 3, EOS_ID]
    assert mask[0].tolist() == [1, 1, 1, 0, 0, 0]
    # row 1: truncated to maxlen-1 words, mask covers all 6
    assert mask[1].sum() == 6


def test_subsample_frames():
    f = np.arange(10)[:, None].astype(np.float32)
    s = subsample_frames(f, 4)
    assert s.shape == (4, 1)
    assert s[0, 0] == 0 and s[-1, 0] == 9
    assert np.array_equal(subsample_frames(f, 20), f)  # keep-all when short


def test_pack_bank_masks_and_order():
    feats = {"b": np.ones((3, 4), np.float32), "a": 2 * np.ones((6, 4), np.float32)}
    bank = pack_bank(feats, k=5)
    assert bank.ids == ["a", "b"]
    assert bank.frames.shape == (2, 5, 4)
    assert bank.frame_mask[0].tolist() == [1, 1, 1, 1, 1]
    assert bank.frame_mask[1].tolist() == [1, 1, 1, 0, 0]
    assert np.all(bank.frames[1, 3:] == 0)


def test_bank_save_load_roundtrip(tmp_path):
    bank = synthetic_bank(4, k=6, d=8, n_regions=2, region_dim=4,
                          motion_dim=8, seed=3)
    p = str(tmp_path / "bank.npz")
    bank.save(p)
    b2 = FeatureBank.load(p)
    assert b2.ids == list(bank.ids)
    np.testing.assert_array_equal(b2.frames, bank.frames)
    np.testing.assert_array_equal(b2.regions, bank.regions)
    np.testing.assert_array_equal(b2.motion, bank.motion)


def test_to_device_is_cached_per_dtype():
    import jax.numpy as jnp

    bank = synthetic_bank(3, k=4, d=8, n_regions=2, region_dim=4, seed=1)
    dev1 = bank.to_device()
    dev2 = bank.to_device()
    # Same upload reused (the train loop calls this every valid round).
    assert dev1 is dev2
    # A different dtype is a distinct cache entry, not a clobber.
    dev_bf16 = bank.to_device(dtype=jnp.bfloat16)
    assert dev_bf16 is not dev1
    assert dev_bf16["frames"].dtype == jnp.bfloat16
    assert dev_bf16["frame_mask"].dtype == dev1["frame_mask"].dtype  # never cast
    assert bank.to_device(dtype=jnp.bfloat16) is dev_bf16
    np.testing.assert_array_equal(np.asarray(dev1["frames"]), bank.frames)


def test_batch_iterator_static_shapes_and_weights():
    it = BatchIterator(10, 4, seed=0)
    batches = list(it.epoch())
    assert len(batches) == 3
    for idx, w in batches:
        assert idx.shape == (4,) and w.shape == (4,)
    # last batch: 2 real + 2 wrapped
    assert batches[-1][1].tolist() == [1, 1, 0, 0]
    # all real examples covered exactly once with weight 1
    seen = np.concatenate([i[w > 0] for i, w in batches])
    assert sorted(seen.tolist()) == list(range(10))


def test_synthetic_dataset_consistency():
    ds = synthetic_dataset(n_videos=4, captions_per_video=3, k=6, d=16,
                           maxlen=12, seed=1)
    assert ds.captions.n == 12
    assert ds.bank.n_videos == 4
    assert len(ds.references) == 4
    # every caption's video index is valid
    assert ds.captions.video_idx.max() < 4
    # references decode consistently with encoded tokens
    row = ds.captions.video_idx[0]
    dec = ds.vocab.decode(ds.captions.tokens[0])
    assert dec in ds.references[row]


def test_tokenize():
    assert tokenize("A man, IS running!") == ["a", "man", "is", "running"]


def test_bucketed_iterator_coverage_and_shapes():
    """Every caption is visited with weight 1 exactly once per epoch;
    each batch's bucket covers every member's length; batch shapes are
    static per bucket (SURVEY.md §2 row 5 HomogeneousData)."""
    from stvd.data.batching import BucketedBatchIterator
    rng = np.random.RandomState(0)
    lengths = rng.randint(2, 31, size=101)
    it = BucketedBatchIterator(lengths, batch_size=16,
                               buckets=(10, 20, 30), seed=1)
    seen = np.zeros(101, int)
    for idx, w, t_b in it.epoch():
        assert idx.shape == (16,) and w.shape == (16,)
        assert t_b in (10, 20, 30)
        assert (lengths[idx] <= t_b).all()
        for i, wi in zip(idx, w):
            if wi > 0:
                seen[i] += 1
    assert (seen == 1).all()
    with pytest.raises(ValueError):
        BucketedBatchIterator([5, 35], 4, buckets=(10, 30))


def test_bucketed_loss_invariance():
    """Slicing tokens/mask to a covering bucket leaves per-example NLL
    (and therefore gradients) exactly unchanged: the dropped columns
    are all-masked."""
    import jax
    from stvd.data.batching import gather_batch
    from stvd.model.decoder import init_params
    from stvd.train.loss import loss_fn
    from conftest import small_cfg
    cfg = small_cfg(compute_dtype="float32")
    ds = synthetic_dataset(n_videos=6, k=cfg.n_frames, d=cfg.ctx_dim,
                           maxlen=30, seed=3)
    dev = ds.bank.to_device()
    idx = np.arange(6, dtype=np.int32)
    lens = ds.captions.mask.sum(axis=1).astype(int)
    t_b = int(((lens.max() + 9) // 10) * 10)       # covering bucket
    full = gather_batch(dev, ds.captions, idx)
    bucketed = gather_batch(dev, ds.captions, idx, seq_len=t_b)
    assert bucketed["tokens"].shape[1] == t_b < full["tokens"].shape[1]
    params = init_params(jax.random.PRNGKey(0), cfg)
    la, _ = loss_fn(params, cfg, full, train=False)
    lb, _ = loss_fn(params, cfg, bucketed, train=False)
    np.testing.assert_allclose(float(la), float(lb), rtol=1e-6)
    ga = jax.grad(lambda p: loss_fn(p, cfg, full, train=False)[0])(params)
    gb = jax.grad(lambda p: loss_fn(p, cfg, bucketed, train=False)[0]
                  )(params)
    for k in ("U", "Wc_att", "Wemb"):
        np.testing.assert_allclose(np.asarray(ga[k]), np.asarray(gb[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
