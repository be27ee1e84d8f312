"""METEOR — dependency-free implementation of the METEOR 1.5 formulation.

The reference pipeline spawns the METEOR 1.5 Java jar as a persistent
subprocess (pycocoevalcap/meteor/meteor.py; the jar is absent from the
snapshot and JVM-dependent — no java in this image). This module implements
the METEOR 1.5 ("Meteor Universal", Denkowski & Lavie 2014) scoring scheme in
pure Python:

  * matcher stages: exact (w=1.0) and Porter-stem (w=0.6);
  * content/function word distinction with weight delta = 0.75;
  * weighted P/R, Fmean = P*R / (alpha*P + (1-alpha)*R), alpha = 0.85;
  * fragmentation penalty gamma * (chunks/matches)^beta, gamma = 0.6,
    beta = 0.2;
  * best reference per segment, corpus score = micro-average over the
    aggregated segment statistics (the jar's EVAL aggregation), per-segment
    scores also returned.

Known deviations from the Java jar (documented, data-blocked in this image):
  * the WordNet synonymy stage (w=0.8) and the paraphrase stage (w=0.6) are
    both implemented but DATA-GATED: synonymy activates when a synset table
    is supplied (``Meteor(synonym_file=)`` / ``MFL_METEOR_SYNONYMS`` — one
    synset per line, space-separated lowercase surface forms, as extractable
    from a WordNet db); paraphrase activates when a paraphrase table is
    supplied (``Meteor(paraphrase_file=)`` / ``MFL_METEOR_PARAPHRASES`` —
    the jar's paraphrase-en.gz dump, ``phrase ||| phrase`` per line, plain
    or gzip). Without the files, scores are a LOWER bound on jar METEOR for
    hyps that only match via synonyms/paraphrases (bound quantified by
    the repository's tools/meteor_gap_bound.py, on the JAX copy).
  * the function-word list is a standard English closed-class list, not the
    jar's corpus-derived function.words file.
  * alignment is a chunk-minimizing greedy heuristic, not the jar's beam
    search (identical on typical short captions); paraphrase spans are only
    placed over words the word stages left unmatched, whereas the beam can
    trade word matches for covering phrases.

The evaluator accepts any scorer object with this interface, so the
Java-backed scorer can be swapped in for bit-exact comparisons where a JVM
exists. ``Meteor2005`` below keeps the classic Banerjee & Lavie formulation.

The port's copy of the JAX package's ``evaluation/metrics/meteor.py``, kept
line for line so that both score a submission to the same float.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


# ---------------------------------------------------------------------------
# Porter stemmer (Porter 1980), standard algorithm
# ---------------------------------------------------------------------------

_VOWELS = "aeiou"


def _cons(word: str, i: int) -> bool:
    ch = word[i]
    if ch in _VOWELS:
        return False
    if ch == "y":
        return i == 0 or not _cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    m, prev_c = 0, True
    started = False
    for i in range(len(stem)):
        c = _cons(stem, i)
        if not c:
            started = True
        elif started and not prev_c:
            m += 1
        prev_c = c
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (
        len(word) >= 2
        and word[-1] == word[-2]
        and _cons(word, len(word) - 1)
    )


def _cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    if not (_cons(word, len(word) - 3) and not _cons(word, len(word) - 2) and _cons(word, len(word) - 1)):
        return False
    return word[-1] not in "wxy"


def porter_stem(word: str) -> str:
    if len(word) <= 2:
        return word
    w = word

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # step 1b
    flag = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed"):
        if _has_vowel(w[:-2]):
            w = w[:-2]
            flag = True
    elif w.endswith("ing"):
        if _has_vowel(w[:-3]):
            w = w[:-3]
            flag = True
    if flag:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"

    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # step 2
    step2 = [
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
        ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
        ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
        ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ]
    for suf, rep in step2:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # step 3
    step3 = [
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ]
    for suf, rep in step3:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # step 4
    step4 = [
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ]
    for suf in step4:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" and _measure(w[:-3]) > 1:
            w = w[:-3]

    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


# ---------------------------------------------------------------------------
# METEOR 1.5
# ---------------------------------------------------------------------------

# Standard English closed-class (function) words; stands in for the jar's
# corpus-derived function.words list (words with relative frequency > 1e-3).
FUNCTION_WORDS = frozenset(
    """a an the this that these those some any each every no all both half
    either neither such what which who whom whose i you he she it we they me
    him her us them my your his its our their mine yours hers ours theirs
    myself yourself himself herself itself ourselves yourselves themselves
    and or but nor so yet for because although though while if unless until
    since when whenever where wherever whereas than as of in on at by with
    from into onto upon about against between among through during before
    after above below under over up down out off to toward towards across
    along around behind beside besides beyond inside outside near past
    without within underneath throughout despite is am are was were be been
    being do does did doing have has had having will would shall should can
    could may might must ought need dare not n't 's 'd 'll 'm 're 've there
    here then once again also too very just only even still almost quite
    rather really now how why whether per via versus etc""".split()
)

# METEOR 1.5 English parameters (meteor-1.5 Constants.java / paper Table 2)
ALPHA = 0.85   # P/R balance in Fmean
BETA = 0.2     # fragmentation exponent
GAMMA = 0.6    # fragmentation weight
DELTA = 0.75   # content-vs-function word weight
# stage order/weights per the jar's English default
# "exact stem synonym paraphrase"; the synonym stage participates only when
# a synset table is loaded and the paraphrase stage only when a paraphrase
# table is loaded (paraphrase-en.gz dump) — both data-gated, zero code gap
STAGE_WEIGHTS = (1.0, 0.6, 0.8, 0.6)
PARAPHRASE_STAGE = 3


def load_synonym_table(path: str) -> Dict[str, frozenset]:
    """Parse a synset file (one synset per line, space-separated lowercase
    surface forms — the natural dump format of a WordNet db) into a
    word -> {synset ids} map for the synonymy matcher stage."""
    table: Dict[str, set] = {}
    with open(path) as f:
        for sid, line in enumerate(f):
            words = line.split()
            if len(words) < 2:
                continue
            for w in words:
                table.setdefault(w.lower(), set()).add(sid)
    return {w: frozenset(s) for w, s in table.items()}


def load_paraphrase_table(path: str) -> Dict[str, frozenset]:
    """Parse a METEOR paraphrase table (the plain-text dump of
    paraphrase-en.gz: one pair per line, phrases separated by `|||`,
    optionally with a leading probability field) into a
    phrase -> {pair ids} map. Two phrases "paraphrase-match" iff they share
    a pair id — pair membership exactly, no transitive closure, mirroring
    the jar's table lookup."""
    import gzip

    table: Dict[str, set] = {}
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        pid = 0
        for line in f:
            parts = [p.strip().lower() for p in line.split("|||")]
            if len(parts) == 3:
                parts = parts[1:]  # leading probability field
            if len(parts) != 2 or not parts[0] or not parts[1]:
                continue
            if parts[0] == parts[1]:
                continue
            for ph in parts:
                table.setdefault(ph, set()).add(pid)
            pid += 1
    return {p: frozenset(s) for p, s in table.items()}


def _max_phrase_len(paraphrases: Optional[Dict]) -> int:
    if not paraphrases:
        return 1
    return max(p.count(" ") + 1 for p in paraphrases)


def _align(
    hyp: List[str],
    ref: List[str],
    synsets: Optional[Dict] = None,
    paraphrases: Optional[Dict] = None,
):
    """Stage-priority one-to-one alignment. Returns a list of match BLOCKS
    (hyp_start, hyp_len, ref_start, ref_len, stage) sorted by hyp_start;
    the word stages (exact/stem/synonym) emit length-1 blocks and the
    paraphrase stage emits phrase spans.

    Chunk-minimizing greedy heuristic: candidates that continue the previous
    (hyp_i-1 -> ref_j-1) adjacency are preferred, then the candidate closest
    to the continuation position (the jar resolves ties by beam search over
    total matches then chunks; identical on typical short captions)."""
    keys = [hyp, [porter_stem(h) for h in hyp]]
    ref_keys = [ref, [porter_stem(r) for r in ref]]

    def matches(stage, i, j):
        if stage < 2:
            return keys[stage][i] == ref_keys[stage][j]
        # synonym stage: words share a synset (jar WordNet surface lookup)
        sh = synsets.get(hyp[i])
        return bool(sh) and bool(sh & synsets.get(ref[j], frozenset()))

    word_stages = (0, 1, 2) if synsets else (0, 1)
    used_ref = [False] * len(ref)
    match_of_hyp: List[Optional[Tuple[int, int]]] = [None] * len(hyp)  # (ref_idx, stage)
    for stage in word_stages:
        prev_j = -2
        for i in range(len(hyp)):
            if match_of_hyp[i] is not None:
                prev_j = match_of_hyp[i][0]
                continue
            cands = [
                j for j in range(len(ref))
                if not used_ref[j] and matches(stage, i, j)
            ]
            if not cands:
                continue
            target = prev_j + 1
            j = min(cands, key=lambda c: (abs(c - target), c))
            match_of_hyp[i] = (j, stage)
            used_ref[j] = True
            prev_j = j

    blocks = [
        (i, 1, m[0], 1, m[1])
        for i, m in enumerate(match_of_hyp)
        if m is not None
    ]

    if paraphrases:
        # paraphrase stage (w=0.6): unmatched hyp spans vs unmatched ref
        # spans whose surface phrases share a table pair id. Greedy longest-
        # first over the hyp, ref span chosen nearest the continuation point.
        used_hyp = [m is not None for m in match_of_hyp]
        max_len = _max_phrase_len(paraphrases)

        def free(used, a, ln):
            return not any(used[a: a + ln])

        prev_end = 0
        i = 0
        while i < len(hyp):
            if used_hyp[i]:
                i += 1
                continue
            placed = False
            for lh in range(min(max_len, len(hyp) - i), 0, -1):
                if not free(used_hyp, i, lh):
                    continue
                ids = paraphrases.get(" ".join(hyp[i: i + lh]))
                if not ids:
                    continue
                cands = []
                for lr in range(min(max_len, len(ref)), 0, -1):
                    for j in range(len(ref) - lr + 1):
                        if not free(used_ref, j, lr):
                            continue
                        if (i, lh) == (j, lr) and hyp[i: i + lh] == ref[j: j + lr]:
                            continue  # identical spans are word-stage territory
                        rids = paraphrases.get(" ".join(ref[j: j + lr]))
                        if rids and (ids & rids):
                            cands.append((j, lr))
                if cands:
                    j, lr = min(cands, key=lambda c: (abs(c[0] - prev_end), -c[1], c[0]))
                    blocks.append((i, lh, j, lr, PARAPHRASE_STAGE))
                    for t in range(lh):
                        used_hyp[i + t] = True
                    for t in range(lr):
                        used_ref[j + t] = True
                    prev_end = j + lr
                    i += lh
                    placed = True
                    break
            if not placed:
                i += 1
        blocks.sort(key=lambda b: b[0])
    return blocks


def _count_chunks(blocks) -> int:
    """Contiguous-in-both runs over match blocks sorted by hyp start; a
    span match extends the current chunk when it starts exactly where the
    previous block ended on both sides."""
    if not blocks:
        return 0
    chunks = 1
    for (h0, hl0, r0, rl0, _), (h1, _, r1, _, _) in zip(blocks, blocks[1:]):
        if h1 != h0 + hl0 or r1 != r0 + rl0:
            chunks += 1
    return chunks


def _segment_stats(
    hyp_line: str,
    ref_line: str,
    synsets: Optional[Dict] = None,
    paraphrases: Optional[Dict] = None,
) -> Dict[str, float]:
    """METEOR 1.5 sufficient statistics for one (hyp, ref) pair."""
    hyp, ref = hyp_line.split(), ref_line.split()
    blocks = _align(hyp, ref, synsets, paraphrases)

    def weighted_len(words):
        c = sum(1 for w in words if w not in FUNCTION_WORDS)
        return DELTA * c + (1.0 - DELTA) * (len(words) - c)

    w_match_h = w_match_r = matches = 0.0
    for i, lh, j, lr, stage in blocks:
        sw = STAGE_WEIGHTS[stage]
        for t in range(lh):
            wh = DELTA if hyp[i + t] not in FUNCTION_WORDS else 1.0 - DELTA
            w_match_h += sw * wh
        for t in range(lr):
            wr = DELTA if ref[j + t] not in FUNCTION_WORDS else 1.0 - DELTA
            w_match_r += sw * wr
        # the jar counts the average of the two span lengths toward the
        # match total used by the fragmentation penalty
        matches += (lh + lr) / 2.0

    return {
        "w_match_h": w_match_h,
        "w_match_r": w_match_r,
        "w_len_h": weighted_len(hyp),
        "w_len_r": weighted_len(ref),
        "matches": matches,
        "chunks": float(_count_chunks(blocks)),
    }


def _score_from_stats(s: Dict[str, float]) -> float:
    if s["matches"] == 0 or s["w_len_h"] == 0 or s["w_len_r"] == 0:
        return 0.0
    p = s["w_match_h"] / s["w_len_h"]
    r = s["w_match_r"] / s["w_len_r"]
    if p + r == 0:
        return 0.0
    fmean = p * r / (ALPHA * p + (1.0 - ALPHA) * r)
    frag = s["chunks"] / s["matches"]
    penalty = GAMMA * frag**BETA if s["chunks"] > 0 else 0.0
    return fmean * (1.0 - penalty)


def meteor_score(
    hyp_line: str,
    ref_line: str,
    synsets: Optional[Dict] = None,
    paraphrases: Optional[Dict] = None,
) -> float:
    """Single-pair METEOR 1.5 score."""
    return _score_from_stats(
        _segment_stats(hyp_line, ref_line, synsets, paraphrases)
    )


def _load_gated_table(explicit_path, env_var, loader, stage_name):
    """Shared data-gating logic for the synonymy/paraphrase stages: an
    explicitly requested table must exist (no silent metric degradation); an
    env-var table warns and degrades if absent."""
    import os
    import warnings

    env_file = os.environ.get(env_var)
    if explicit_path:
        if not os.path.exists(explicit_path):
            raise FileNotFoundError(
                f"METEOR {stage_name} table not found: {explicit_path}"
            )
        return loader(explicit_path)
    if env_file:
        if os.path.exists(env_file):
            return loader(env_file)
        warnings.warn(
            f"{env_var}={env_file} does not exist; scoring WITHOUT the "
            f"{stage_name} stage"
        )
    return None


class Meteor:
    def __init__(
        self,
        synonym_file: Optional[str] = None,
        synsets=None,
        paraphrase_file: Optional[str] = None,
        paraphrases=None,
    ):
        """synonym_file: synset table path enabling the WordNet synonymy
        stage (see load_synonym_table); defaults to $MFL_METEOR_SYNONYMS.
        paraphrase_file: paraphrase table path (plain or .gz dump of the
        jar's paraphrase-en.gz) enabling the paraphrase stage; defaults to
        $MFL_METEOR_PARAPHRASES. Either data file drops in without code
        changes. synsets / paraphrases: pre-built maps (take precedence;
        mainly for tests)."""
        if synsets is None:
            synsets = _load_gated_table(
                synonym_file, "MFL_METEOR_SYNONYMS",
                load_synonym_table, "synonym",
            )
        if paraphrases is None:
            paraphrases = _load_gated_table(
                paraphrase_file, "MFL_METEOR_PARAPHRASES",
                load_paraphrase_table, "paraphrase",
            )
        self.synsets = synsets
        self.paraphrases = paraphrases

    def method(self):
        return "METEOR"

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        """Best reference per segment; corpus score is the jar's micro-average
        (aggregate the best-ref sufficient statistics, score the aggregate)."""
        agg = {k: 0.0 for k in (
            "w_match_h", "w_match_r", "w_len_h", "w_len_r", "matches", "chunks"
        )}
        seg_scores = []
        for k in gts:
            hyp = res[k][0]
            best_stats, best = None, -1.0
            for ref in gts[k]:
                stats = _segment_stats(hyp, ref, self.synsets, self.paraphrases)
                score = _score_from_stats(stats)
                if score > best:
                    best, best_stats = score, stats
            if best_stats is None:
                best_stats = _segment_stats(hyp, "")
                best = 0.0
            seg_scores.append(best)
            for key in agg:
                agg[key] += best_stats[key]
        return _score_from_stats(agg), seg_scores


class Meteor2005:
    """Classic METEOR (Banerjee & Lavie 2005): exact+stem alignment,
    Fmean = 10PR/(R+9P), penalty 0.5*(chunks/matches)^3, max over refs,
    macro-average over segments."""

    def method(self):
        return "METEOR"

    @staticmethod
    def _pair(hyp_line: str, ref_line: str) -> float:
        hyp, ref = hyp_line.split(), ref_line.split()
        if not hyp or not ref:
            return 0.0
        pairs = _align(hyp, ref)
        m = len(pairs)
        if m == 0:
            return 0.0
        p = m / len(hyp)
        r = m / len(ref)
        f_mean = 10 * p * r / (r + 9 * p)
        penalty = 0.5 * (_count_chunks(pairs) / m) ** 3
        return f_mean * (1 - penalty)

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        scores = [
            max((self._pair(res[k][0], ref) for ref in gts[k]), default=0.0)
            for k in gts
        ]
        avg = sum(scores) / len(scores) if scores else 0.0
        return avg, scores
