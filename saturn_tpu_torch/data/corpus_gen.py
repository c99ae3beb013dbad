"""WikiText-scale corpus synthesis for machines with no network.

A copy of ``saturn_tpu/data/corpus_gen.py`` (numpy only): the same
arguments write the same file and the same ``.meta.json`` sidecar, so
either package reuses the other's corpus.

The reference tokenized real WikiText-103 (~500 MB raw, 103M tokens, 267k
word types capped to a 50k vocab — ``examples/wikitext103/dataloaders/
dataloaders.py:70-84``). Without a network, scale testing of the data path
needs a locally generated corpus with the same *shape*:

- word frequencies matching a natural rank-frequency (Zipf) curve — taken
  empirically from the bundled seed text rather than assumed;
- MORE distinct word types than the vocab cap, so the 50k-vocab build has
  real ``<unk>`` pressure and a non-trivial ranked cut;
- hundreds of MB of text, generated in seconds (vectorized sampling).

Token order is iid by design: the tokenizer under test builds an
order-independent frequency vocab and encodes greedily, so bigram realism
would cost generation time and change nothing measured. Deterministic in
``seed``.
"""

from __future__ import annotations

import os
import re
from collections import Counter
from typing import Optional

import numpy as np

_DEFAULT_SEED_TEXT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "examples",
    "data", "corpus.txt",
)
_WORDS_PER_LINE = 18


def _seed_distribution(seed_path: str, n_extra_types: int):
    """(types, probabilities): empirical seed-word distribution extended
    with a Zipf tail of synthetic rare types (``w<i>q``) so the total
    type count exceeds any realistic vocab cap."""
    with open(seed_path, "rb") as f:
        data = f.read()
    toks = re.findall(rb"[a-z0-9]+", data.lower())
    counts = Counter(t.decode("ascii") for t in toks)
    types = list(counts)
    freqs = np.array([counts[t] for t in types], dtype=np.float64)
    # Synthetic tail continues the empirical curve: rank r gets weight
    # proportional to 1/(r0 + r), where r0 is the seed's type count.
    r0 = len(types)
    tail_ranks = np.arange(1, n_extra_types + 1, dtype=np.float64)
    tail = freqs.min() * r0 / (r0 + tail_ranks)
    types += [f"w{i}q" for i in range(n_extra_types)]
    p = np.concatenate([freqs, tail])
    return np.array(types), p / p.sum()


def generate_corpus(
    out_path: str,
    size_mb: float = 120.0,
    seed_path: Optional[str] = None,
    n_extra_types: int = 65536,
    seed: int = 0,
) -> dict:
    """Write ~``size_mb`` MB of synthetic text to ``out_path``.

    Returns {"bytes", "tokens", "types"}. Skips generation if the file
    already exists at >= the requested size AND a sidecar ``.meta.json``
    records the same generation parameters — a corpus written with a
    different seed / seed_path / n_extra_types is regenerated, not silently
    reused (size alone can't tell them apart). On reuse the sidecar's
    token/type counts are returned so benchmark metadata never sees None.
    """
    import json

    target = int(size_mb * 1e6)
    meta_path = out_path + ".meta.json"
    params = {
        "seed_path": os.path.abspath(seed_path or _DEFAULT_SEED_TEXT),
        "n_extra_types": int(n_extra_types),
        "seed": int(seed),
    }
    # The byte count is estimated from mean word length, so the written
    # size lands within a few percent of target; treat >= 90% as done.
    if os.path.exists(out_path) and os.path.getsize(out_path) >= 0.9 * target:
        meta = None
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            pass
        if meta is not None and meta.get("params") == params:
            return {"bytes": os.path.getsize(out_path),
                    "tokens": meta.get("tokens"), "types": meta.get("types"),
                    "reused": True}
        log_msg = ("existing corpus %s has %s generation parameters — "
                   "regenerating" % (out_path,
                                     "different" if meta else "unknown"))
        print(f"corpus_gen: {log_msg}")
    # Invalidate the sidecar BEFORE rewriting the body: an interrupted
    # regeneration must not leave a new-params body paired with old-params
    # metadata (a later call would silently reuse the wrong corpus).
    try:
        os.remove(meta_path)
    except OSError:
        pass
    types, p = _seed_distribution(seed_path or _DEFAULT_SEED_TEXT,
                                  n_extra_types)
    mean_len = float((np.char.str_len(types) * p).sum())
    per_tok = mean_len + 1.0  # the joining space / newline
    n_tokens = int(target / per_tok)
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    written = 0
    total_toks = 0
    chunk = 2_000_000
    with open(out_path, "w") as f:
        while total_toks < n_tokens:
            m = min(chunk, n_tokens - total_toks)
            ids = rng.choice(len(types), size=m, p=p)
            words = types[ids]
            lines = [
                " ".join(words[i:i + _WORDS_PER_LINE])
                for i in range(0, m, _WORDS_PER_LINE)
            ]
            s = "\n".join(lines) + "\n"
            f.write(s)
            written += len(s)
            total_toks += m
    with open(meta_path, "w") as f:
        json.dump({"params": params, "tokens": total_toks,
                   "types": len(types)}, f)
    return {"bytes": written, "tokens": total_toks, "types": len(types)}


def main() -> None:  # pragma: no cover - thin CLI
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--size-mb", type=float, default=120.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seed-text", default=None)
    args = ap.parse_args()
    info = generate_corpus(args.out, args.size_mb, args.seed_text,
                           seed=args.seed)
    print(info)


if __name__ == "__main__":  # pragma: no cover
    main()
