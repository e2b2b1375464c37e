"""Metric-suite tests: BLEU vs NLTK, ROUGE/CIDEr/METEOR properties,
scorer interface parity with the reference's COCOScorer shape
(SURVEY.md §4: 'scorer parity vs NLTK BLEU + published sanity pairs')."""

import math

import numpy as np
import pytest

from stvd.metrics.bleu import bleu, bleu_score
from stvd.metrics.cider import cider_score
from stvd.metrics.meteor import meteor_score, meteor_sentence
from stvd.metrics.rouge import rouge_l_sentence, rouge_score
from stvd.metrics.scorer import score_all
from stvd.metrics.tokenizer import ptb_tokenize

HYP1 = "a man is playing a guitar".split()
REF1A = "a man is playing a guitar".split()
REF1B = "someone plays the guitar".split()
HYP2 = "a dog runs in the park".split()
REF2A = "a dog is running in a park".split()


def test_bleu_perfect_match():
    s = bleu([HYP1], [[REF1A]])
    for v in s:
        assert abs(v - 1.0) < 1e-9


def test_bleu_vs_nltk_corpus():
    from nltk.translate.bleu_score import corpus_bleu
    hyps = [HYP1, HYP2]
    refs = [[REF1A, REF1B], [REF2A]]
    ours = bleu(hyps, refs)
    for n in range(1, 5):
        w = tuple([1.0 / n] * n + [0.0] * (4 - n))
        ref_val = corpus_bleu(refs, hyps, weights=w)
        # NLTK closest-ref-length BP matches ours
        assert abs(ours[n - 1] - ref_val) < 1e-6, (n, ours[n - 1], ref_val)


def test_bleu_zero_overlap():
    s = bleu([["x", "y"]], [[["a", "b"]]])
    assert s[0] < 1e-6


def test_bleu_brevity_penalty():
    # short hypothesis must be penalized even with perfect precision
    s_full = bleu([REF2A], [[REF2A]])
    s_short = bleu([REF2A[:3]], [[REF2A]])
    assert s_short[0] < s_full[0]


def test_rouge_perfect_and_ordering():
    assert abs(rouge_l_sentence(HYP1, [REF1A]) - 1.0) < 1e-9
    good = rouge_l_sentence(HYP2, [REF2A])
    bad = rouge_l_sentence(["zebra", "piano"], [REF2A])
    assert good > bad


def test_cider_identity_scores_high():
    # many distinct videos so idf is informative
    gts = {f"v{i}": [[w, "object", str(i)]] for i, w in
           enumerate("cat dog bird fish horse cow sheep goat".split())}
    res_good = {k: [v[0]] for k, v in gts.items()}
    _, good = cider_score(gts, res_good)
    res_bad = {k: [["completely", "unrelated", "words"]] for k in gts}
    _, bad = cider_score(gts, res_bad)
    assert good["CIDEr"] > bad["CIDEr"]
    assert bad["CIDEr"] < 0.1


def test_meteor_identity_near_one():
    s = meteor_sentence(HYP1, [REF1A])
    assert s > 0.95


def test_meteor_stem_matching():
    # 'running' vs 'runs' should match via Porter stems
    with_stem = meteor_sentence(["the", "dog", "runs"],
                                [["the", "dog", "running"]])
    without = meteor_sentence(["the", "dog", "xyz"],
                              [["the", "dog", "running"]])
    assert with_stem > without


def test_meteor_word_order_penalty():
    inorder = meteor_sentence(HYP1, [REF1A])
    scrambled = meteor_sentence(list(reversed(HYP1)), [REF1A])
    assert inorder > scrambled


def test_meteor_corpus_aggregation():
    gts = {"a": [REF1A, REF1B], "b": [REF2A]}
    res = {"a": [HYP1], "b": [HYP2]}
    s, d = meteor_score(gts, res)
    assert 0.0 < s <= 1.0 and d["METEOR"] == s


def test_bleu_ref_length_options():
    hyps = [["a", "b", "c"]]
    refs = [[["a", "b"], ["a", "b", "c", "d", "e", "f"]]]
    closest = bleu(hyps, refs, option="closest")
    shortest = bleu(hyps, refs, option="shortest")
    average = bleu(hyps, refs, option="average")
    # closest ref len=2 -> no BP; shortest same here; average len=4 -> BP<1
    assert closest[0] == shortest[0]
    assert average[0] < closest[0]


def test_cider_single_video_degenerate():
    """One video: idf = log(1) = 0 everywhere -> CIDEr 0 (same as the
    COCO scorer's behavior on a 1-document corpus)."""
    _, d = cider_score({"v": [["a", "b"]]}, {"v": [["a", "b"]]})
    assert d["CIDEr"] == 0.0


def test_meteor_profile_2005_hand_computed():
    """Pin the meteor2005 formula on a hand-computed pair.

    hyp=[the cat sat on mat] vs ref=[the cat sat on the mat]:
    5 exact matches, hyp positions 0..4 align to ref 0,1,2,3,5 -> 2
    chunks.  P=5/5, R=5/6, F=PR/(.9P+.1R), pen=.5*(2/5)^3."""
    from stvd.metrics.meteor import meteor_sentence
    hyp = ["the", "cat", "sat", "on", "mat"]
    ref = ["the", "cat", "sat", "on", "the", "mat"]
    p, r = 1.0, 5 / 6
    f = p * r / (0.9 * p + 0.1 * r)
    pen = 0.5 * (2 / 5) ** 3
    assert meteor_sentence(hyp, [ref], profile="meteor2005") == \
        pytest.approx(f * (1 - pen))


def test_meteor_profile_15en_hand_computed():
    """Pin the meteor15-en formula (alpha=.85, beta=.2, gamma=.6,
    delta=.75 content weighting) on the same pair.

    Function words: the, on (weight .25); content: cat sat mat (.75).
    All 5 matches are exact (stage weight 1): weighted hyp matches =
    weighted hyp len = 2.75; weighted ref matches = 2.75, weighted ref
    len = 3.0 (extra 'the').  2 chunks of 5 matches."""
    from stvd.metrics.meteor import meteor_sentence
    hyp = ["the", "cat", "sat", "on", "mat"]
    ref = ["the", "cat", "sat", "on", "the", "mat"]
    p = 2.75 / 2.75
    r = 2.75 / 3.0
    f = p * r / (0.85 * p + 0.15 * r)
    pen = 0.6 * (2 / 5) ** 0.2
    assert meteor_sentence(hyp, [ref], profile="meteor15-en") == \
        pytest.approx(f * (1 - pen))


def test_meteor_profile_15en_stage_weights():
    """Stem-stage matches carry weight 0.6 in meteor15-en: 'dogs' vs
    'dog' is one stem match of a content word -> P=R=0.6, single chunk
    penalty .6*1^.2."""
    from stvd.metrics.meteor import meteor_sentence
    s = meteor_sentence(["dogs"], [["dog"]], profile="meteor15-en")
    p = r = (0.6 * 0.75) / 0.75
    f = p * r / (0.85 * p + 0.15 * r)
    assert s == pytest.approx(f * (1 - 0.6))


def test_meteor_profile_plumbed_through_score_all():
    gts = {"a": ["the cat sat on the mat"]}
    res = {"a": ["the cat sat on mat"]}
    s05 = score_all(gts, res, meteor_profile="meteor2005")["METEOR"]
    s15 = score_all(gts, res, meteor_profile="meteor15-en")["METEOR"]
    assert s05 != s15           # profiles actually change the number
    assert 0 < s15 < s05        # beta=.2 penalizes fragmentation harder


def test_meteor_unknown_profile_raises():
    from stvd.metrics.meteor import meteor_score
    with pytest.raises(KeyError):
        meteor_score({"a": [["x"]]}, {"a": [["x"]]}, profile="nope")


def test_ptb_tokenize():
    assert ptb_tokenize("A man, playing GUITAR!") == ["a", "man", "playing",
                                                      "guitar"]


def test_ptb_tokenize_clitics():
    """PTB keeps clitics as their own apostrophe-bearing tokens
    (Stanford PTBTokenizer: "man's" -> [man, 's])."""
    assert ptb_tokenize("the man's dog") == ["the", "man", "'s", "dog"]
    assert ptb_tokenize("don't run") == ["do", "n't", "run"]
    assert ptb_tokenize("they're, we've, I'll, he'd, I'm") == \
        ["they", "'re", "we", "'ve", "i", "'ll", "he", "'d", "i", "'m"]
    # a bare apostrophe is punctuation, not a clitic
    assert ptb_tokenize("the dogs' bones") == ["the", "dogs", "bones"]


def test_rouge_empty_refs_scores_zero():
    """A video with zero references scores 0, not ValueError
    (score_all is a public API; evaluate_split filters but callers
    may not)."""
    assert rouge_l_sentence(["a", "b"], []) == 0.0
    avg, d = rouge_score({"v": [], "w": [["a", "b"]]},
                         {"v": [["a", "b"]], "w": [["a", "b"]]})
    assert d["ROUGE_L"] == pytest.approx(0.5)


def test_score_all_interface():
    gts = {"a": ["a man is playing a guitar", "someone plays the guitar"],
           "b": ["a dog is running in a park"]}
    res = {"a": ["a man is playing a guitar"],
           "b": ["a dog runs in the park"]}
    out = score_all(gts, res)
    for k in ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
              "CIDEr"):
        assert k in out, k
        assert np.isfinite(out[k])
    assert out["Bleu_1"] > 0.5


def test_score_all_missing_hypothesis_raises():
    with pytest.raises(ValueError):
        score_all({"a": ["x"], "b": ["y"]}, {"a": ["x"]})


def test_meteor_beam_alignment_minimizes_chunks():
    """The jar's alignment resolution (beam over coverage -> chunks ->
    distance, meteor._resolve_beam): with duplicate words the resolver
    must pick the assignment forming one long contiguous run (2 chunks)
    where the round-1 positional-greedy heuristic produced 3.
    Hand-computed: hyp the/cat/sat/the vs ref the/the/cat/sat -> the
    optimal alignment is (0,1),(1,2),(2,3) [one chunk] + (3,0)."""
    from stvd.metrics.meteor import _align, _align_stats
    hyp = ["the", "cat", "sat", "the"]
    ref = ["the", "the", "cat", "sat"]
    assert _align_stats(hyp, ref) == (4, 2)
    assert _align(hyp, ref) == [(0, 1), (1, 2), (2, 3), (3, 0)]


def test_meteor_beam_distance_tiebreak():
    """Equal coverage and chunks resolve by minimal total positional
    distance: aligning 'a' at hyp pos 0 to ref pos 0 (dist 0) beats
    ref pos 2 (dist 2)."""
    from stvd.metrics.meteor import _align
    assert _align(["a"], ["a", "b", "a"]) == [(0, 0)]


# ---------------------------------------------------------------------------
# METEOR synonym stage (stage 2) with an injected table — no nltk_data
# needed (SURVEY.md §2 row 11: the jar always runs this stage; here it
# activates with WordNet data OR an injected synonym source)
# ---------------------------------------------------------------------------

_SYNS = {"dog": {"puppy"}}          # one-directional on purpose


def test_meteor_synonym_stage_2005(monkeypatch):
    """Hand-computed: hyp 'a dog runs' vs ref 'a puppy runs'.
    With dog~puppy: m=3 contiguous, chunks=1 -> F=1, penalty=0.5/27
    -> 0.981481...  Without: m=2, chunks=2 -> 0.333333..."""
    from stvd.metrics import meteor
    hyp, ref = ["a", "dog", "runs"], [["a", "puppy", "runs"]]
    assert abs(meteor.meteor_sentence(hyp, ref) - 1 / 3) < 1e-12
    monkeypatch.setattr(meteor, "_synonym_override", _SYNS)
    got = meteor.meteor_sentence(hyp, ref)
    assert abs(got - 0.9814814814814815) < 1e-12
    # the jar's synonymy test is symmetric over an asymmetric table:
    # hyp 'puppy' matches ref 'dog' through syns('dog') as well
    got_rev = meteor.meteor_sentence(["a", "puppy", "runs"],
                                     [["a", "dog", "runs"]])
    assert abs(got_rev - 0.9814814814814815) < 1e-12


def test_meteor_synonym_stage_weighted(monkeypatch):
    """meteor15-en with a synonym match: stage weight w_syn=0.8 and
    delta=0.75 content weighting.  Hand-computed 0.4739246289772449
    (mwh=mwr=0.25+0.6+0.75=1.6, whl=wrl=1.75, penalty=0.6*(1/3)^0.2)."""
    from stvd.metrics import meteor
    monkeypatch.setattr(meteor, "_synonym_override", _SYNS)
    got = meteor.meteor_sentence(["a", "dog", "runs"],
                                 [["a", "puppy", "runs"]],
                                 profile="meteor15-en")
    assert abs(got - 0.4739246289772449) < 1e-12


def test_meteor_synonym_forces_python_path(monkeypatch):
    """With a synonym source active the native fast paths must be
    bypassed (the C ABI cannot express asymmetric synonymy): corpus
    scoring and _align_stats include stage-2 matches."""
    from stvd.metrics import meteor
    from stvd.metrics import _native
    monkeypatch.setattr(meteor, "_synonym_override", _SYNS)
    assert meteor._synonyms_active()
    # per-pair stats: 3 matches / 1 chunk only via the Python resolver
    assert meteor._align_stats(["a", "dog", "runs"],
                               ["a", "puppy", "runs"]) == (3, 1)
    # corpus path: single-segment corpus score equals the segment score
    score, _ = meteor.meteor_score(
        {"v0": [["a", "puppy", "runs"]]}, {"v0": [["a", "dog", "runs"]]})
    assert abs(score - 0.9814814814814815) < 1e-12
    monkeypatch.setattr(meteor, "_synonym_override", None)
    if _native.get_lib() is not None:
        # sanity: with no synonym source the native path re-engages and
        # scores the exact+stem-only alignment
        score2, _ = meteor.meteor_score(
            {"v0": [["a", "puppy", "runs"]]},
            {"v0": [["a", "dog", "runs"]]})
        assert abs(score2 - 1 / 3) < 1e-12


def test_load_synonym_table_fixture():
    """The scoring-time synonym escape hatch (jar-delta class 4):
    load the committed JSON fixture, verify stage 2 activates and
    matches through the asymmetric table, then clear it."""
    import os

    from stvd.metrics import meteor
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "synonyms_en_mini.json")
    try:
        n = meteor.load_synonym_table(path)
        assert n >= 10
        assert meteor._synonyms_active()
        # 'big'~'large' matches only through the table; reversed order
        # exercises the asymmetric lookup ('large' is not a headword)
        for hyp, ref in ((["a", "big", "dog"], ["a", "large", "dog"]),
                         (["a", "large", "dog"], ["a", "big", "dog"])):
            with_syn = meteor.meteor_sentence(hyp, [ref])
            assert with_syn > 0.9      # 3/3 contiguous matches
    finally:
        meteor.set_synonym_table(None)
    assert meteor.meteor_sentence(["a", "big", "dog"],
                                  [["a", "large", "dog"]]) < 0.7


def test_set_synonym_table_rejects_bad_json(tmp_path):
    from stvd.metrics import meteor
    p = tmp_path / "bad.json"
    p.write_text("[1, 2, 3]")
    with pytest.raises(ValueError):
        meteor.load_synonym_table(str(p))
    assert meteor._synonym_override is None   # nothing half-installed


# 60-word fuzz list: regular forms plus known Porter/Snowball
# divergence classes (-ly adverbs, -ed/-ing, y->i, -ous, short words)
_STEM_FUZZ_WORDS = (
    "running jumps easily fairly generously cats dogs sliced slicing "
    "playing played happily national rational conditional dying lying "
    "tying agreed disabled sized meetings stating siezing itemization "
    "sensational traditional referencing colonizer plotted apples "
    "skies quickly badly universally relational motoring differently "
    "conflated troubling oscillators willingness generously communism "
    "capabilities preliminary independently electricity hopefulness "
    "grows knives feed cement entirely cosmically mule die woman news"
).split()


def test_stemmers_fuzz_pinned_against_nltk():
    """Both stemmer kinds must agree with NLTK's own implementations
    over the fuzz list (the memoizing wrapper adds no drift), and the
    list must actually CONTAIN Porter-vs-Snowball divergences — the
    documented jar-delta class 3 is real, not hypothetical."""
    from nltk.stem.porter import PorterStemmer
    from nltk.stem.snowball import SnowballStemmer

    from stvd.metrics import meteor
    porter, snow = PorterStemmer(), SnowballStemmer("english")
    with meteor._stem_kind("porter"):
        ours_p = [meteor._stem(w) for w in _STEM_FUZZ_WORDS]
    with meteor._stem_kind("snowball"):
        ours_s = [meteor._stem(w) for w in _STEM_FUZZ_WORDS]
    assert ours_p == [porter.stem(w) for w in _STEM_FUZZ_WORDS]
    assert ours_s == [snow.stem(w) for w in _STEM_FUZZ_WORDS]
    diverging = [w for w, p, s in zip(_STEM_FUZZ_WORDS, ours_p, ours_s)
                 if p != s]
    assert diverging, "fuzz list contains no Porter/Snowball deltas"


def test_meteor15_uses_snowball_stemmer():
    """The 1.5 jar stems with Snowball English, not Porter — pin that
    the meteor15-en profile actually switches stemmers: find a word
    pair that shares a Snowball stem but not a Porter stem and check
    it matches under meteor15-en but not under an otherwise-identical
    porter-stemmed profile."""
    from nltk.stem.porter import PorterStemmer
    from nltk.stem.snowball import SnowballStemmer

    from stvd.metrics.meteor import (PROFILES, meteor_sentence)
    import dataclasses as dc
    porter, snow = PorterStemmer(), SnowballStemmer("english")
    pair = None
    base = ["fairly", "entirely", "generously", "cosmically", "badly"]
    for w in base:
        root = w[:-2]            # strip 'ly'
        if (snow.stem(w) == snow.stem(root)
                and porter.stem(w) != porter.stem(root)):
            pair = (w, root)
            break
    assert pair is not None, "no divergent -ly pair found"
    p15 = PROFILES["meteor15-en"]
    p15_porter = dc.replace(p15, name="15-porter", stemmer="porter")
    s_snow = meteor_sentence([pair[0]], [[pair[1]]], profile=p15)
    s_port = meteor_sentence([pair[0]], [[pair[1]]], profile=p15_porter)
    assert s_snow > 0            # stem match under snowball
    assert s_port == 0           # no match under porter


@pytest.mark.parametrize("kind,col", [("porter", 0), ("snowball", 1)])
def test_repo_stemmers_pinned_to_fixture(kind, col):
    """The repo's own Porter and Snowball stemmers reproduce, stem for
    stem, what NLTK's PorterStemmer / SnowballStemmer('english') gave
    for a fixed 2,159-word list (tests/fixtures/stems_en.json) — METEOR
    needs no NLTK installation."""
    import json
    import os
    from stvd.metrics import stem
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "stems_en.json")
    with open(path) as f:
        table = json.load(f)
    fn = getattr(stem, kind)
    bad = {w: (fn(w), s[col]) for w, s in table.items() if fn(w) != s[col]}
    assert not bad, dict(list(bad.items())[:10])
