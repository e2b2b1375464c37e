"""English stemmers for METEOR's stem stage, with no dependency.

``porter`` is Porter's algorithm (Porter 1980) with the extensions NLTK
applies by default (``PorterStemmer`` in ``NLTK_EXTENSIONS`` mode):
the irregular-form pool, the 4-letter ``-ies``/``-ied`` rules, the
consonant-only ``y -> i`` rule, ``-alli``/``-fulli``/``-logi``.
``snowball`` is the Snowball English ("Porter2") algorithm as NLTK's
``SnowballStemmer("english")`` implements it, including its handling of
the R1/R2 regions after replacements.  Both follow those
implementations rule for rule so that METEOR scores do not move when
NLTK is absent; tests pin them against stems NLTK produced for a fixed
word list (tests/fixtures/stems_en.json).
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Porter (NLTK_EXTENSIONS)
# ---------------------------------------------------------------------------

_VOWELS = frozenset("aeiou")

_PORTER_POOL = {
    "sky": "sky", "skies": "sky", "dying": "die", "lying": "lie",
    "tying": "tie", "news": "news", "innings": "inning",
    "inning": "inning", "outings": "outing", "outing": "outing",
    "cannings": "canning", "canning": "canning", "howe": "howe",
    "proceed": "proceed", "exceed": "exceed", "succeed": "succeed",
}


def _cons(w: str, i: int) -> bool:
    if w[i] in _VOWELS:
        return False
    if w[i] == "y":
        negate = False
        while i > 0 and w[i] == "y":
            negate = not negate
            i -= 1
        return (w[i] not in _VOWELS) != negate
    return True


def _measure(s: str) -> int:
    return "".join("c" if _cons(s, i) else "v"
                   for i in range(len(s))).count("vc")


def _has_vowel(s: str) -> bool:
    return any(not _cons(s, i) for i in range(len(s)))


def _double_cons(w: str) -> bool:
    return len(w) >= 2 and w[-1] == w[-2] and _cons(w, len(w) - 1)


def _cvc(w: str) -> bool:
    n = len(w)
    return ((n >= 3 and _cons(w, n - 3) and not _cons(w, n - 2)
             and _cons(w, n - 1) and w[-1] not in "wxy")
            or (n == 2 and not _cons(w, 0) and _cons(w, 1)))


def _m_pos(stem: str) -> bool:
    return _measure(stem) > 0


def _m_gt1(stem: str) -> bool:
    return _measure(stem) > 1


def _rules(word: str, rules) -> str:
    """The first rule whose suffix matches decides: replace when its
    condition holds on the stem, else leave the word as it is."""
    for suffix, repl, cond in rules:
        if suffix == "*d":
            if _double_cons(word):
                stem = word[:-2]
                return stem + repl if cond is None or cond(stem) else word
            continue
        if word.endswith(suffix):
            stem = word[:len(word) - len(suffix)]
            return stem + repl if cond is None or cond(stem) else word
    return word


def _step1b(w: str) -> str:
    if w.endswith("ied"):
        return w[:-3] + ("ie" if len(w) == 4 else "i")
    if w.endswith("eed"):
        stem = w[:-3]
        return stem + "ee" if _measure(stem) > 0 else w
    for suffix in ("ed", "ing"):
        if w.endswith(suffix) and _has_vowel(w[:-len(suffix)]):
            s = w[:-len(suffix)]
            break
    else:
        return w
    return _rules(s, [
        ("at", "ate", None), ("bl", "ble", None), ("iz", "ize", None),
        ("*d", s[-1], lambda _: s[-1] not in "lsz"),
        ("", "e", lambda st: _measure(st) == 1 and _cvc(st)),
    ])


_STEP2 = [(a, b, _m_pos) for a, b in (
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
    ("anci", "ance"), ("izer", "ize"), ("bli", "ble"), ("alli", "al"),
    ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
    ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
    ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
    ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"),
    ("biliti", "ble"), ("fulli", "ful"))]


def _step2(w: str) -> str:
    if w.endswith("alli") and _m_pos(w[:-4]):
        return _step2(w[:-4] + "al")
    return _rules(w, _STEP2 + [("logi", "log",
                                lambda _: _m_pos(w[:-3]))])


_STEP3 = [(a, b, _m_pos) for a, b in (
    ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
    ("ical", "ic"), ("ful", ""), ("ness", ""))]

_STEP4 = [(a, "", _m_gt1) for a in (
    "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
    "ment", "ent")] + [
    ("ion", "", lambda st: _measure(st) > 1 and st[-1] in "st")] + [
    (a, "", _m_gt1) for a in ("ou", "ism", "ate", "iti", "ous", "ive",
                              "ize")]


def porter(word: str) -> str:
    """Porter stem of ``word`` (lower-cased), NLTK_EXTENSIONS rules."""
    w = word.lower()
    if w in _PORTER_POOL:
        return _PORTER_POOL[w]
    if len(word) <= 2:
        return w
    if w.endswith("ies") and len(w) == 4:
        w = w[:-3] + "ie"
    else:
        w = _rules(w, [("sses", "ss", None), ("ies", "i", None),
                       ("ss", "ss", None), ("s", "", None)])
    w = _step1b(w)
    w = _rules(w, [("y", "i", lambda st: len(st) > 1
                    and _cons(st, len(st) - 1))])
    w = _step2(w)
    w = _rules(w, _STEP3)
    w = _rules(w, _STEP4)
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    return _rules(w, [("ll", "l", lambda _: _measure(w[:-1]) > 1)])


# ---------------------------------------------------------------------------
# Snowball English (as NLTK's SnowballStemmer("english"))
# ---------------------------------------------------------------------------

_SB_VOWELS = "aeiouy"
_SB_DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
_SB_LI = "cdeghkmnrt"
_SB_STEP1B = ("eedly", "ingly", "edly", "eed", "ing", "ed")
_SB_STEP2 = ("ization", "ational", "fulness", "ousness", "iveness",
             "tional", "biliti", "lessli", "entli", "ation", "alism",
             "aliti", "ousli", "iviti", "fulli", "enci", "anci", "abli",
             "izer", "ator", "alli", "bli", "ogi", "li")
_SB_STEP3 = ("ational", "tional", "alize", "icate", "iciti", "ative",
             "ical", "ness", "ful")
_SB_STEP4 = ("ement", "ance", "ence", "able", "ible", "ment", "ant",
             "ent", "ism", "ate", "iti", "ous", "ive", "ize", "ion", "al",
             "er", "ic")
_SB_SPECIAL = {
    "skis": "ski", "skies": "sky", "dying": "die", "lying": "lie",
    "tying": "tie", "idly": "idl", "gently": "gentl", "ugly": "ugli",
    "early": "earli", "only": "onli", "singly": "singl", "sky": "sky",
    "news": "news", "howe": "howe", "atlas": "atlas", "cosmos": "cosmos",
    "bias": "bias", "andes": "andes", "inning": "inning",
    "innings": "inning", "outing": "outing", "outings": "outing",
    "canning": "canning", "cannings": "canning", "herring": "herring",
    "herrings": "herring", "earring": "earring", "earrings": "earring",
    "proceed": "proceed", "proceeds": "proceed", "proceeded": "proceed",
    "proceeding": "proceed", "exceed": "exceed", "exceeds": "exceed",
    "exceeded": "exceed", "exceeding": "exceed", "succeed": "succeed",
    "succeeds": "succeed", "succeeded": "succeed",
    "succeeding": "succeed",
}


def _cut(s: str, n: int) -> str:
    return s[:-n] if n else s


def _region_after_vc(s: str) -> str:
    for i in range(1, len(s)):
        if s[i] not in _SB_VOWELS and s[i - 1] in _SB_VOWELS:
            return s[i + 1:]
    return ""


class _Regions:
    """The word with its R1/R2 suffix regions, edited together the way
    NLTK does (a region shorter than a replaced suffix becomes
    ``short``)."""

    def __init__(self, word, r1, r2):
        self.w, self.r1, self.r2 = word, r1, r2

    def cut(self, n):
        self.w, self.r1, self.r2 = (_cut(self.w, n), _cut(self.r1, n),
                                    _cut(self.r2, n))

    def replace(self, suffix, new, r2_short=""):
        n = len(suffix)
        self.w = self.w[:-n] + new
        self.r1 = self.r1[:-n] + new if len(self.r1) >= n else ""
        self.r2 = self.r2[:-n] + new if len(self.r2) >= n else r2_short

    def last_to(self, ch):
        self.w = self.w[:-1] + ch
        self.r1 = self.r1[:-1] + ch if self.r1 else ""
        self.r2 = self.r2[:-1] + ch if self.r2 else ""


def snowball(word: str) -> str:
    """Snowball English stem of ``word`` (lower-cased)."""
    word = word.lower()
    if len(word) <= 2:
        return word
    if word in _SB_SPECIAL:
        return _SB_SPECIAL[word]
    word = (word.replace("’", "'").replace("‘", "'")
            .replace("‛", "'"))
    if word.startswith("'"):
        word = word[1:]
    if word.startswith("y"):
        word = "Y" + word[1:]
    for i in range(1, len(word)):
        if word[i - 1] in _SB_VOWELS and word[i] == "y":
            word = word[:i] + "Y" + word[i + 1:]

    if word.startswith(("gener", "commun", "arsen")):
        r1 = word[6:] if word.startswith("commun") else word[5:]
        r2 = ""
        for i in range(1, len(r1)):
            if r1[i] not in _SB_VOWELS and r1[i - 1] in _SB_VOWELS:
                r2 = r1[i + 1:]
                break
    else:
        r1 = _region_after_vc(word)
        r2 = _region_after_vc(r1)
    x = _Regions(word, r1, r2)

    # step 0
    for suffix in ("'s'", "'s", "'"):
        if x.w.endswith(suffix):
            x.cut(len(suffix))
            break

    # step 1a
    for suffix in ("sses", "ied", "ies", "us", "ss", "s"):
        if x.w.endswith(suffix):
            if suffix == "sses":
                x.cut(2)
            elif suffix in ("ied", "ies"):
                x.cut(2 if len(x.w[:-3]) > 1 else 1)
            elif suffix == "s":
                if any(c in _SB_VOWELS for c in x.w[:-2]):
                    x.cut(1)
            break

    # step 1b
    for suffix in _SB_STEP1B:
        if not x.w.endswith(suffix):
            continue
        if suffix in ("eed", "eedly"):
            if x.r1.endswith(suffix):
                x.replace(suffix, "ee")
        elif any(c in _SB_VOWELS for c in x.w[:-len(suffix)]):
            x.cut(len(suffix))
            w = x.w
            if w.endswith(("at", "bl", "iz")):
                x.w, x.r1 = w + "e", x.r1 + "e"
                if len(x.w) > 5 or len(x.r1) >= 3:
                    x.r2 += "e"
            elif w.endswith(_SB_DOUBLES):
                x.cut(1)
            elif x.r1 == "" and (
                    (len(w) >= 3 and w[-1] not in _SB_VOWELS
                     and w[-1] not in "wxY" and w[-2] in _SB_VOWELS
                     and w[-3] not in _SB_VOWELS)
                    or (len(w) == 2 and w[0] in _SB_VOWELS
                        and w[1] not in _SB_VOWELS)):
                x.w += "e"
                if x.r1:
                    x.r1 += "e"
                if x.r2:
                    x.r2 += "e"
        break

    # step 1c
    if len(x.w) > 2 and x.w[-1] in "yY" and x.w[-2] not in _SB_VOWELS:
        x.last_to("i")

    # step 2
    for suffix in _SB_STEP2:
        if not x.w.endswith(suffix):
            continue
        if x.r1.endswith(suffix):
            if suffix in ("tional", "entli", "fulli", "lessli"):
                x.cut(2)
            elif suffix in ("enci", "anci", "abli"):
                x.last_to("e")
            elif suffix in ("izer", "ization"):
                x.replace(suffix, "ize")
            elif suffix in ("ational", "ation", "ator"):
                x.replace(suffix, "ate", r2_short="e")
            elif suffix in ("alism", "aliti", "alli"):
                x.replace(suffix, "al")
            elif suffix == "fulness":
                x.cut(4)
            elif suffix in ("ousli", "ousness"):
                x.replace(suffix, "ous")
            elif suffix in ("iveness", "iviti"):
                x.replace(suffix, "ive", r2_short="e")
            elif suffix in ("biliti", "bli"):
                x.replace(suffix, "ble")
            elif suffix == "ogi" and x.w[-4] == "l":
                x.cut(1)
            elif suffix == "li" and x.w[-3] in _SB_LI:
                x.cut(2)
        break

    # step 3
    for suffix in _SB_STEP3:
        if not x.w.endswith(suffix):
            continue
        if x.r1.endswith(suffix):
            if suffix == "tional":
                x.cut(2)
            elif suffix == "ational":
                x.replace(suffix, "ate")
            elif suffix == "alize":
                x.cut(3)
            elif suffix in ("icate", "iciti", "ical"):
                x.replace(suffix, "ic")
            elif suffix in ("ful", "ness"):
                x.cut(len(suffix))
            elif suffix == "ative" and x.r2.endswith(suffix):
                x.cut(5)
        break

    # step 4
    for suffix in _SB_STEP4:
        if not x.w.endswith(suffix):
            continue
        if x.r2.endswith(suffix):
            if suffix != "ion":
                x.cut(len(suffix))
            elif x.w[-4] in "st":
                x.cut(3)
        break

    # step 5
    w, r1, r2 = x.w, x.r1, x.r2
    if r2.endswith("l") and w[-2] == "l":
        w = w[:-1]
    elif r2.endswith("e"):
        w = w[:-1]
    elif r1.endswith("e"):
        if len(w) >= 4 and (w[-2] in _SB_VOWELS or w[-2] in "wxY"
                            or w[-3] not in _SB_VOWELS
                            or w[-4] in _SB_VOWELS):
            w = w[:-1]
    return w.replace("Y", "y")
