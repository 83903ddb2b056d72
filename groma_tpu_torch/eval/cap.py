"""Region-caption scoring: CIDEr-D, BLEU, METEOR-lite and ROUGE-L in
pure Python (a copy of ``groma_tpu/eval/cap.py``).

The metrics are written from their definitions, as the reference's
pycocoevalcap needs Java; SPICE needs a dependency parser and is left out
(the reference's headline region-caption metric is CIDEr).  METEOR's stem
stage uses nltk's Porter stemmer where nltk is installed and matches exact
words only where it is not.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence


def _tokenize(s: str) -> List[str]:
    s = s.lower()
    s = re.sub(r"[^a-z0-9 ]", ' ', s)
    return s.split()


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def cider_d(candidates: Dict[str, str],
            references: Dict[str, List[str]],
            n_max: int = 4, sigma: float = 6.0) -> float:
    """CIDEr-D score over {id: caption} vs {id: [refs]}."""
    ids = list(candidates.keys())
    # document frequencies from reference sets
    df = [defaultdict(float) for _ in range(n_max)]
    for i in ids:
        for n in range(n_max):
            seen = set()
            for ref in references[i]:
                seen |= set(_ngrams(_tokenize(ref), n + 1).keys())
            for g in seen:
                df[n][g] += 1.0
    log_num_imgs = math.log(max(len(ids), 1))

    def tfidf(tokens, n):
        cnt = _ngrams(tokens, n + 1)
        total = max(sum(cnt.values()), 1)
        vec = {}
        for g, c in cnt.items():
            idf = log_num_imgs - math.log(max(df[n][g], 1.0))
            vec[g] = (c / total) * idf
        norm = math.sqrt(sum(v * v for v in vec.values()))
        return vec, norm, len(tokens)

    scores = []
    for i in ids:
        cand_toks = _tokenize(candidates[i])
        score_n = [0.0] * n_max
        for n in range(n_max):
            cvec, cnorm, clen = tfidf(cand_toks, n)
            for ref in references[i]:
                rtoks = _tokenize(ref)
                rvec, rnorm, rlen = tfidf(rtoks, n)
                # clipped dot product
                dot = sum(min(cvec.get(g, 0.0), rvec.get(g, 0.0)) * rv
                          for g, rv in rvec.items())
                if cnorm > 0 and rnorm > 0:
                    sim = dot / (cnorm * rnorm)
                    delta = clen - rlen
                    sim *= math.exp(-delta * delta / (2 * sigma * sigma))
                    score_n[n] += sim
            score_n[n] /= max(len(references[i]), 1)
        scores.append(10.0 * sum(score_n) / n_max)
    return sum(scores) / max(len(scores), 1)


def bleu(candidates: Dict[str, str], references: Dict[str, List[str]],
         n_max: int = 4) -> List[float]:
    """Corpus BLEU-1..n with brevity penalty."""
    clipped = [0] * n_max
    totals = [0] * n_max
    c_len, r_len = 0, 0
    for i, cand in candidates.items():
        ctoks = _tokenize(cand)
        rtoks_all = [_tokenize(r) for r in references[i]]
        c_len += len(ctoks)
        r_len += min((abs(len(r) - len(ctoks)), len(r))
                     for r in rtoks_all)[1]
        for n in range(n_max):
            ccnt = _ngrams(ctoks, n + 1)
            max_ref = Counter()
            for rt in rtoks_all:
                rc = _ngrams(rt, n + 1)
                for g, c in rc.items():
                    max_ref[g] = max(max_ref[g], c)
            clipped[n] += sum(min(c, max_ref.get(g, 0))
                              for g, c in ccnt.items())
            totals[n] += max(sum(ccnt.values()), 0)
    bp = 1.0 if c_len > r_len else math.exp(1 - r_len / max(c_len, 1))
    out = []
    log_sum = 0.0
    for n in range(n_max):
        p = clipped[n] / max(totals[n], 1)
        log_sum += math.log(max(p, 1e-12))
        out.append(bp * math.exp(log_sum / (n + 1)))
    return out


def _porter():
    """Porter stemmer (pure python via nltk; no corpus data needed).
    Returns None when nltk is absent — METEOR falls back to exact-only."""
    try:
        from nltk.stem.porter import PorterStemmer
        return PorterStemmer().stem
    except Exception:  # noqa: BLE001 — optional dependency
        return None


def _meteor_align(cand: List[str], ref: List[str], stem=None,
                  stem_weight: float = 0.6):
    """Staged one-to-one alignment (leftmost-first): exact matches
    first (weight 1.0), then Porter-stem matches over the remaining
    words (weight ``stem_weight`` — METEOR 1.5's English stem-module
    weight).  Returns (pairs, weighted_m, m)."""
    used_ref = [False] * len(ref)
    used_cand = [False] * len(cand)
    pairs = []
    wsum = 0.0
    for ci, w in enumerate(cand):
        for ri, rw in enumerate(ref):
            if not used_ref[ri] and rw == w:
                used_ref[ri] = True
                used_cand[ci] = True
                pairs.append((ci, ri))
                wsum += 1.0
                break
    if stem is not None:
        cstem = [stem(w) for w in cand]
        rstem = [stem(w) for w in ref]
        for ci, w in enumerate(cstem):
            if used_cand[ci]:
                continue
            for ri, rw in enumerate(rstem):
                if not used_ref[ri] and rw == w:
                    used_ref[ri] = True
                    used_cand[ci] = True
                    pairs.append((ci, ri))
                    wsum += stem_weight
                    break
    return pairs, wsum, len(pairs)


def meteor(candidates: Dict[str, str],
           references: Dict[str, List[str]],
           alpha: float = 0.9, beta: float = 3.0,
           gamma: float = 0.5, use_stem: bool = True) -> float:
    """METEOR-lite: exact + Porter-stem match stages
    (reference metric surface: groma/eval/eval_cap.py:61 via
    pycocoevalcap.meteor — the Java jar's WordNet synonym and paraphrase
    stages need corpus data unavailable offline and are omitted; the
    stem stage uses METEOR 1.5's 0.6 module weight.  Scoring is the
    original Banerjee & Lavie harmonic-mean + fragmentation-penalty
    formulation, max over references.  Measured stage contribution on a
    morphology-heavy synthetic set: exact-only underscores stem-
    inclusive by ~8-15% relative on inflection-mismatched pairs and 0%
    on verbatim pairs — tests/test_cap_metrics.py pins both)."""
    stem = _porter() if use_stem else None
    total = 0.0
    for i, cand_s in candidates.items():
        cand = _tokenize(cand_s)
        best = 0.0
        for ref_s in references[i]:
            ref = _tokenize(ref_s)
            if not cand or not ref:
                continue
            pairs, wm, m = _meteor_align(cand, ref, stem)
            if m == 0:
                continue
            p = wm / len(cand)
            r = wm / len(ref)
            f_mean = p * r / (alpha * p + (1 - alpha) * r)
            # fragmentation: contiguous-in-both runs of the alignment
            pairs.sort()
            chunks = 1
            for (c0, r0), (c1, r1) in zip(pairs, pairs[1:]):
                if not (c1 == c0 + 1 and r1 == r0 + 1):
                    chunks += 1
            frag = chunks / m
            score = f_mean * (1.0 - gamma * frag ** beta)
            best = max(best, score)
        total += best
    return total / max(len(candidates), 1)


def _lcs_len(a: List[str], b: List[str]) -> int:
    """Longest-common-subsequence length (classic DP, O(|a|·|b|))."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b):
            cur.append(prev[j] + 1 if x == y
                       else max(cur[j], prev[j + 1]))
        prev = cur
    return prev[-1]


def rouge_l(candidates: Dict[str, str],
            references: Dict[str, List[str]],
            beta: float = 1.2) -> float:
    """ROUGE-L exactly as pycocoevalcap's Rouge scorer
    (reference metric surface: groma/eval/eval_cap.py:32-37): per image,
    LCS precision and recall are each MAXed over the references
    (independently — possibly from different refs), combined with the
    beta=1.2 F-measure, then averaged over images."""
    total = 0.0
    for i, cand_s in candidates.items():
        cand = _tokenize(cand_s)
        prec, rec = [0.0], [0.0]
        for ref_s in references[i]:
            ref = _tokenize(ref_s)
            lcs = _lcs_len(ref, cand)
            if cand:
                prec.append(lcs / len(cand))
            if ref:
                rec.append(lcs / len(ref))
        pm, rm = max(prec), max(rec)
        if pm > 0 and rm > 0:
            total += ((1 + beta ** 2) * pm * rm) / (rm + beta ** 2 * pm)
    return total / max(len(candidates), 1)


def score_captions(candidates: Dict[str, str],
                   references: Dict[str, List[str]]) -> dict:
    """The eval_cap.py-equivalent summary
    (reference: groma/eval/eval_cap.py:61; SPICE needs a dependency
    parser and stays documented out of scope, PARITY.md)."""
    b = bleu(candidates, references)
    return {
        'CIDEr': cider_d(candidates, references),
        'BLEU-1': b[0], 'BLEU-4': b[3],
        'METEOR': meteor(candidates, references),
        'ROUGE_L': rouge_l(candidates, references),
        'num': len(candidates),
    }
