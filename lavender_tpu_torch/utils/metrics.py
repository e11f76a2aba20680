"""Caption metrics: BLEU-4, CIDEr-D, ROUGE-L (from scratch; the port's own
copy of lavender_tpu/utils/metrics.py).

The reference imports COCO caption metrics from an ``evalcap`` module that is
absent from its tree (main_caption.py:13; SURVEY.md §2.2 T16), so these are
re-implemented per the standard coco-caption definitions:

* BLEU: corpus-level, uniform weights, closest-reference brevity penalty;
* CIDEr-D: n=1..4 TF-IDF cosine with length gaussian (sigma=6), x10 scale;
* ROUGE-L: LCS F-measure with beta=1.2, max over refs, mean over corpus.
"""
from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

_PUNCT = re.compile(r"[^a-z0-9 ]+")


def ptb_tokenize(s: str) -> List[str]:
    """Simplified PTB tokenization: lowercase, strip punctuation."""
    return _PUNCT.sub(" ", s.lower()).split()


def _ngrams(toks: Sequence[str], n: int) -> Counter:
    return Counter(tuple(toks[i:i + n]) for i in range(len(toks) - n + 1))


def bleu(candidates: Dict[str, str], references: Dict[str, List[str]],
         max_n: int = 4) -> List[float]:
    """Corpus BLEU-1..max_n with closest-length brevity penalty."""
    clip_counts = [0.0] * max_n
    totals = [0.0] * max_n
    cand_len, ref_len = 0, 0
    for key, cand in candidates.items():
        c = ptb_tokenize(cand)
        refs = [ptb_tokenize(r) for r in references[key]]
        cand_len += len(c)
        ref_len += min((abs(len(r) - len(c)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            cng = _ngrams(c, n)
            max_ref = Counter()
            for r in refs:
                rng = _ngrams(r, n)
                for g, ct in rng.items():
                    max_ref[g] = max(max_ref[g], ct)
            clip_counts[n - 1] += sum(
                min(ct, max_ref.get(g, 0)) for g, ct in cng.items())
            totals[n - 1] += max(sum(cng.values()), 0)
    bp = 1.0 if cand_len > ref_len else math.exp(
        1 - ref_len / max(cand_len, 1))
    out = []
    logsum = 0.0
    for n in range(1, max_n + 1):
        p = clip_counts[n - 1] / totals[n - 1] if totals[n - 1] > 0 else 0.0
        # coco-caption "tiny" smoothing: avoids log(0) on empty matches
        p = max(p, 1e-16)
        logsum += math.log(p)
        out.append(bp * math.exp(logsum / n))
    return out


def cider_d(candidates: Dict[str, str], references: Dict[str, List[str]],
            max_n: int = 4, sigma: float = 6.0) -> float:
    """CIDEr-D (Vedantam et al. 2015), coco-caption parameterization."""
    cand_toks = {k: ptb_tokenize(v) for k, v in candidates.items()}
    ref_toks = {k: [ptb_tokenize(r) for r in refs]
                for k, refs in references.items()}
    # document frequency over reference n-grams
    df = [defaultdict(float) for _ in range(max_n)]
    for refs in ref_toks.values():
        for n in range(max_n):
            seen = set()
            for r in refs:
                seen.update(_ngrams(r, n + 1).keys())
            for g in seen:
                df[n][g] += 1.0
    log_num_imgs = math.log(max(len(ref_toks), 1))

    def tfidf_vec(toks, n):
        cnt = _ngrams(toks, n + 1)
        vec = {}
        norm = 0.0
        for g, ct in cnt.items():
            idf = log_num_imgs - math.log(max(df[n].get(g, 0.0), 1.0))
            v = ct * idf
            vec[g] = v
            norm += v * v
        return vec, math.sqrt(norm), len(toks)

    scores = []
    for key, c in cand_toks.items():
        refs = ref_toks[key]
        score_n = [0.0] * max_n
        for n in range(max_n):
            cvec, cnorm, clen = tfidf_vec(c, n)
            for r in refs:
                rvec, rnorm, rlen = tfidf_vec(r, n)
                # CIDEr-D: clipped dot product + length penalty
                num = sum(min(cv, rvec.get(g, 0.0)) * rvec.get(g, 0.0)
                          for g, cv in cvec.items())
                denom = cnorm * rnorm
                val = num / denom if denom > 0 else 0.0
                delta = clen - rlen
                val *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
                score_n[n] += val
            score_n[n] /= max(len(refs), 1)
        scores.append(10.0 * sum(score_n) / max_n)
    return sum(scores) / max(len(scores), 1)


def _lcs(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l(candidates: Dict[str, str], references: Dict[str, List[str]],
            beta: float = 1.2) -> float:
    scores = []
    for key, cand in candidates.items():
        c = ptb_tokenize(cand)
        best = 0.0
        for ref in references[key]:
            r = ptb_tokenize(ref)
            l = _lcs(c, r)
            if l == 0:
                continue
            prec = l / len(c) if c else 0.0
            rec = l / len(r) if r else 0.0
            f = ((1 + beta ** 2) * prec * rec
                 / (rec + beta ** 2 * prec)) if prec + rec > 0 else 0.0
            best = max(best, f)
        scores.append(best)
    return sum(scores) / max(len(scores), 1)


def coco_caption_metrics(candidates: Dict[str, str],
                         references: Dict[str, List[str]]) -> Dict[str, float]:
    """The metric dict the reference's missing evalcap would produce."""
    b = bleu(candidates, references)
    return {
        "Bleu_1": b[0], "Bleu_2": b[1], "Bleu_3": b[2], "Bleu_4": b[3],
        "CIDEr": cider_d(candidates, references),
        "ROUGE_L": rouge_l(candidates, references),
    }
