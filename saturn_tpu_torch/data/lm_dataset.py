"""Language-model datasets: one token stream, chunked into fixed-length batches.

A copy of ``saturn_tpu/data/lm_dataset.py`` (numpy only): ``batch(i)`` is O(1)
random access, batches are dense int32 arrays of a fixed shape, and with no
corpus the default is a deterministic synthetic Zipf-distributed token
stream. A local text file is byte- or word-tokenized and cached as ``.npz``.
The word tokenizer is native (``native/tokenize.cpp``, a copy of the JAX
package's, built by ``g++`` at first use); a failed build raises, and
``_word_tokenize_python`` is its plain version, held to it by the tests.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np


class TokenDataset:
    """Fixed-shape LM batches over one token stream."""

    def __init__(
        self,
        tokens: np.ndarray,
        context_length: int = 512,
        batch_size: int = 8,
    ):
        tokens = np.asarray(tokens, dtype=np.int32)
        self.context_length = context_length
        self.batch_size = batch_size
        n_chunks = len(tokens) // context_length
        if n_chunks < batch_size:
            raise ValueError(
                f"corpus too small: {n_chunks} chunks < batch_size {batch_size}"
            )
        self._chunks = tokens[: n_chunks * context_length].reshape(
            n_chunks, context_length
        )
        self._n_batches = n_chunks // batch_size

    def __len__(self) -> int:
        """Batches per epoch (reference ``Task.py:127`` epoch_length)."""
        return self._n_batches

    def batch(self, i: int) -> np.ndarray:
        """(batch_size, context_length) int32 tokens for batch index ``i``."""
        i = i % self._n_batches
        return self._chunks[i * self.batch_size : (i + 1) * self.batch_size]

    def example_batch(self) -> np.ndarray:
        return np.zeros((self.batch_size, self.context_length), dtype=np.int32)


def synthetic_tokens(
    n_tokens: int, vocab_size: int, seed: int = 0, zipf_a: float = 1.2
) -> np.ndarray:
    """Deterministic Zipf-ish token stream — realistic rank-frequency shape so
    embedding-gather and softmax behave like natural text."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(zipf_a, size=n_tokens)
    return (ranks % vocab_size).astype(np.int32)


def byte_tokenize_file(path: str, cache_dir: str = ".saturn_data_cache") -> np.ndarray:
    """Byte-level tokenization of a local text file, cached as .npz
    (cache scheme parity with ``dataloaders.py:70-84``)."""
    os.makedirs(cache_dir, exist_ok=True)
    key = hashlib.sha1(os.path.abspath(path).encode()).hexdigest()[:16]
    cache = os.path.join(cache_dir, f"bytes_{key}.npz")
    if os.path.exists(cache):
        with np.load(cache) as z:
            return z["tokens"]
    with open(path, "rb") as f:
        tokens = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
    np.savez(cache, tokens=tokens)
    return tokens


def _word_tokenize_python(data: bytes, max_vocab: int):
    """The plain version of ``native/tokenize.cpp``: operates on raw bytes, ASCII-only
    lowercasing, ASCII-alnum runs are words, each non-space non-alnum byte is
    its own token, frequency-ranked vocab, 0=pad 1=<unk>. Multi-byte UTF-8
    chars split into byte tokens."""
    import re
    from collections import Counter

    toks = [
        m.decode("latin-1")
        for m in re.findall(rb"[a-z0-9]+|[^\sa-z0-9]", data.lower())
    ]
    counts = Counter(toks)
    first = {}
    for i, t in enumerate(toks):
        first.setdefault(t, i)
    ranked = sorted(counts, key=lambda t: (-counts[t], first[t]))[: max_vocab - 2]
    vocab = {t: i + 2 for i, t in enumerate(ranked)}
    ids = np.fromiter((vocab.get(t, 1) for t in toks), dtype=np.int32, count=len(toks))
    return ids, len(vocab) + 2


def word_tokenize_file(
    path: str,
    max_vocab: int = 32768,
    cache_dir: str = ".saturn_data_cache",
) -> tuple:
    """Word-level tokenization of a local text file -> (ids, vocab_size),
    by the native tokenizer (``native/tokenize.cpp``): one call counts the
    tokens, a second fills the ids and writes the ranked vocabulary to
    ``vocab_<key>.txt``. Cached as ``.npz`` keyed on (path, max_vocab), the
    JAX package's cache format and key."""
    import ctypes

    from saturn_tpu_torch import native

    os.makedirs(cache_dir, exist_ok=True)
    key = hashlib.sha1(
        f"{os.path.abspath(path)}:{max_vocab}".encode()
    ).hexdigest()[:16]
    cache = os.path.join(cache_dir, f"words_{key}.npz")
    if os.path.exists(cache):
        with np.load(cache) as z:
            return z["tokens"], int(z["vocab_size"])

    fn = native.load("tokenize").word_tokenize_file
    fn.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int),
    ]
    fn.restype = ctypes.c_long
    p = path.encode()
    n = fn(p, max_vocab, None, None, 0, None)
    if n < 0:
        raise OSError(f"native word tokenizer: error {n} on {path!r} "
                      f"(-1 unreadable, -2 max_vocab {max_vocab} under 3)")
    ids = np.empty(n, dtype=np.int32)
    vs = ctypes.c_int()
    vocab_path = os.path.join(cache_dir, f"vocab_{key}.txt")
    got = fn(
        p, max_vocab, vocab_path.encode(),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, ctypes.byref(vs),
    )
    if got != n:
        raise OSError(f"native word tokenizer: {path!r} changed between its count "
                      f"({n} tokens) and its fill ({got})")
    np.savez(cache, tokens=ids, vocab_size=vs.value)
    return ids, int(vs.value)


def make_lm_dataset(
    context_length: int = 512,
    batch_size: int = 8,
    vocab_size: int = 50304,
    n_tokens: Optional[int] = None,
    corpus_path: Optional[str] = None,
    seed: int = 0,
    tokenizer: str = "byte",
    reserved_ids: int = 0,
) -> TokenDataset:
    """Dataloader factory for ``Task(get_dataloader=...)``.

    Uses ``corpus_path`` if given and present — ``tokenizer="byte"`` (ids are
    raw bytes; vocab must be >= 256) or ``tokenizer="word"`` (the native
    frequency-ranked word vocab capped at ``vocab_size``) — else a synthetic
    stream of ``n_tokens`` tokens (default: enough for 64 batches).

    ``reserved_ids`` keeps the top that-many ids of the model's vocab out of
    the data on every path, so they can serve as special tokens (an MLM
    task reserves its [MASK] id this way): data ids stay in
    ``[0, vocab_size - reserved_ids)`` (synthetic generation and the word vocab are capped; the byte path
    requires ``vocab_size - reserved_ids >= 256``).
    """
    if reserved_ids < 0 or reserved_ids >= vocab_size:
        raise ValueError(f"reserved_ids must be in [0, vocab_size), got {reserved_ids}")
    data_vocab = vocab_size - reserved_ids
    if corpus_path and os.path.exists(corpus_path):
        if tokenizer == "word":
            # vocab is *capped* (rare words -> <unk>), so the id range always
            # fits the model's embedding table minus any reserved ids.
            tokens, _ = word_tokenize_file(corpus_path, max_vocab=data_vocab)
        elif tokenizer == "byte":
            if data_vocab < 256:
                raise ValueError(
                    f"byte tokenizer emits ids up to 255 but only "
                    f"{data_vocab} unreserved ids exist "
                    f"(vocab_size={vocab_size}, reserved_ids={reserved_ids})"
                )
            tokens = byte_tokenize_file(corpus_path)
        else:
            raise ValueError(f"unknown tokenizer {tokenizer!r} (byte|word)")
    else:
        if n_tokens is None:
            n_tokens = context_length * batch_size * 64
        tokens = synthetic_tokens(n_tokens, data_vocab, seed=seed)
    return TokenDataset(tokens, context_length=context_length, batch_size=batch_size)
