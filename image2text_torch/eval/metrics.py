"""Caption-quality metrics: corpus BLEU-4 and CIDEr-D (host-side Python),
a copy of ``image2text_tpu/eval/metrics.py`` (the port imports nothing of
the JAX package).

* :func:`corpus_bleu` — Papineni et al. 2002: modified n-gram precision
  clipped by the max reference count, geometric mean over n=1..4, brevity
  penalty with per-segment closest-reference length.
* :func:`cider_d` — Vedantam et al. 2015: TF-IDF-weighted n-gram cosine
  similarity (n=1..4 averaged), length-gaussian penalty, ×10 scale.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence, Tuple


def _ngrams(tokens: Sequence, n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(candidates: List[Sequence],
                references: List[List[Sequence]],
                max_n: int = 4) -> float:
    """candidates[i] is a token sequence; references[i] a list of token
    sequences.  Returns corpus-level BLEU-4 in [0, 1]."""
    assert len(candidates) == len(references)
    clipped = [0] * max_n
    total = [0] * max_n
    cand_len = 0
    ref_len = 0
    for cand, refs in zip(candidates, references):
        cand_len += len(cand)
        ref_len += min((abs(len(r) - len(cand)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            cn = _ngrams(cand, n)
            max_ref = Counter()
            for r in refs:
                rn = _ngrams(r, n)
                for g, c in rn.items():
                    max_ref[g] = max(max_ref[g], c)
            total[n - 1] += max(0, len(cand) - n + 1)
            clipped[n - 1] += sum(min(c, max_ref[g]) for g, c in cn.items())
    if min(total) == 0 or min(clipped) == 0:
        return 0.0
    logp = sum(math.log(clipped[i] / total[i]) for i in range(max_n)) / max_n
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(cand_len, 1))
    return bp * math.exp(logp)


def cider_d(candidates: List[Sequence],
            references: List[List[Sequence]],
            max_n: int = 4, sigma: float = 6.0) -> float:
    """CIDEr-D over the corpus (mean of per-image scores), ×10 scale."""
    assert len(candidates) == len(references)
    num_images = len(candidates)
    # document frequency over reference n-grams (per image: distinct grams)
    df: List[Counter] = [Counter() for _ in range(max_n)]
    for refs in references:
        for n in range(1, max_n + 1):
            seen = set()
            for r in refs:
                seen.update(_ngrams(r, n).keys())
            for g in seen:
                df[n - 1][g] += 1

    log_num = math.log(max(num_images, 1))

    def tfidf_vec(tokens, n) -> Tuple[Dict, float]:
        cnt = _ngrams(tokens, n)
        vec = {}
        norm_sq = 0.0
        for g, c in cnt.items():
            idf = log_num - math.log(max(df[n - 1].get(g, 0), 1))
            w = c * idf
            vec[g] = w
            norm_sq += w * w
        return vec, math.sqrt(norm_sq)

    scores = []
    for cand, refs in zip(candidates, references):
        per_n = []
        for n in range(1, max_n + 1):
            cv, cnorm = tfidf_vec(cand, n)
            sim = 0.0
            for r in refs:
                rv, rnorm = tfidf_vec(r, n)
                # CIDEr-D clips candidate counts by reference counts
                dot = sum(min(w, rv.get(g, 0.0)) * rv.get(g, 0.0)
                          for g, w in cv.items())
                if cnorm > 0 and rnorm > 0:
                    delta = len(cand) - len(r)
                    sim += (dot / (cnorm * rnorm)) * math.exp(
                        -delta * delta / (2 * sigma * sigma))
            per_n.append(sim / max(len(refs), 1))
        scores.append(10.0 * sum(per_n) / max_n)
    return sum(scores) / max(len(scores), 1)
