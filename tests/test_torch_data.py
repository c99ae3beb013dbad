"""The port's data path against the JAX package's: the native word tokenizer
(``saturn_tpu_torch/native/tokenize.cpp``, built by ``g++`` from the port's
own copy), its ``.npz`` cache and vocabulary file, and the corpus generator
(``saturn_tpu_torch/data/corpus_gen.py``).

Tolerance: none. Ids, vocab sizes, vocabulary files and generated corpora
are byte-identical to the JAX package's native tokenizer (built from its own
source), to its pure-Python tokenizer and to its generator.
"""

import ctypes
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from saturn_tpu import native as jnative
from saturn_tpu.data import corpus_gen as jcorpus
from saturn_tpu.data import lm_dataset as jdata
from saturn_tpu_torch import native
from saturn_tpu_torch.data import corpus_gen, lm_dataset

ROOT = pathlib.Path(__file__).resolve().parents[1]
BUNDLED = ROOT / "examples" / "data" / "corpus.txt"
SAMPLE = """The quick brown fox jumps over the lazy dog.
The dog, surprisingly, did not mind; the fox did it again!
"""
NON_ASCII = "Café déjà-vu naïve Straße — twice! Café déjà-vu.\nΑλφα 1984 TAB\there\r\n" * 4


def _both(path, max_vocab, tmp_path):
    """(ids, vocab size, vocabulary file bytes) of the port and of the JAX
    package's native tokenizer on ``path``, each with a cache of its own."""
    assert jnative.load("tokenize") is not None, "the JAX package's native tokenizer did not build"
    out = []
    for label, mod in (("port", lm_dataset), ("jax", jdata)):
        cache = tmp_path / f"cache_{label}_{max_vocab}"
        ids, vocab = mod.word_tokenize_file(str(path), max_vocab=max_vocab, cache_dir=str(cache))
        (vocab_file,) = cache.glob("vocab_*.txt")
        out.append((ids, vocab, vocab_file.read_bytes()))
    return out


@pytest.mark.parametrize("corpus,max_vocab", [
    ("bundled", 32768), ("bundled", 50257), ("bundled", 512), ("sample", 64),
    ("non_ascii", 128), ("non_ascii", 6), ("sample", 5),
])
def test_native_tokenizer_matches_jax(tmp_path, corpus, max_vocab):
    """Ids, vocab size and the ranked vocabulary file equal the JAX native
    tokenizer's and the ids its pure-Python tokenizer's; a cap under the
    corpus's types maps the rest to <unk> (1)."""
    if corpus == "bundled":
        path = BUNDLED
    else:
        path = tmp_path / f"{corpus}.txt"
        path.write_bytes((SAMPLE * 3 if corpus == "sample" else NON_ASCII).encode("utf-8"))
    (ids, vocab, vfile), (jids, jvocab, jvfile) = _both(path, max_vocab, tmp_path)
    assert ids.dtype == np.int32 and vocab == jvocab and vfile == jvfile
    np.testing.assert_array_equal(ids, jids)
    py_ids, py_vocab = jdata._word_tokenize_python(path.read_bytes(), max_vocab)
    assert vocab == py_vocab
    np.testing.assert_array_equal(ids, py_ids)
    port_py_ids, port_py_vocab = lm_dataset._word_tokenize_python(path.read_bytes(), max_vocab)
    assert port_py_vocab == vocab
    np.testing.assert_array_equal(port_py_ids, ids)
    assert ids.max() < vocab
    lines = vfile.decode("latin-1").split("\n")
    assert lines[:2] == ["<pad>", "<unk>"] and len(lines) == vocab + 1
    if max_vocab < 10:
        assert vocab == max_vocab and (ids == 1).any()


def test_cache_hit_reads_the_npz(tmp_path, monkeypatch):
    """A second call reads the ``.npz`` (the native library is not called),
    whose format and key are the JAX package's: JAX reads the port's cache."""
    p = tmp_path / "corpus.txt"
    p.write_text(SAMPLE)
    cache = str(tmp_path / "cache")
    a, va = lm_dataset.word_tokenize_file(str(p), max_vocab=64, cache_dir=cache)
    monkeypatch.setattr(native, "load", lambda name: pytest.fail("native called on a hit"))
    b, vb = lm_dataset.word_tokenize_file(str(p), max_vocab=64, cache_dir=cache)
    np.testing.assert_array_equal(a, b)
    assert va == vb
    c, vc = jdata.word_tokenize_file(str(p), max_vocab=64, cache_dir=cache)
    np.testing.assert_array_equal(a, c)
    assert vc == va and len(list(pathlib.Path(cache).glob("words_*.npz"))) == 1


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """Where the tokenizer cannot be built the call raises; nothing quietly
    takes the Python path."""
    (tmp_path / "tokenize.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_loaded", {})
    p = tmp_path / "corpus.txt"
    p.write_text(SAMPLE)
    with pytest.raises(RuntimeError, match="native build of tokenize.cpp failed"):
        lm_dataset.word_tokenize_file(str(p), max_vocab=64, cache_dir=str(tmp_path / "c"))


def test_unreadable_corpus_raises(tmp_path):
    with pytest.raises(OSError, match="error -1"):
        lm_dataset.word_tokenize_file(str(tmp_path / "missing.txt"), max_vocab=64,
                                      cache_dir=str(tmp_path / "c"))


def _bind(lib):
    fn = lib.word_tokenize_file
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                   ctypes.POINTER(ctypes.c_int32), ctypes.c_long, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_long
    return fn


def test_count_cache_keeps_the_recently_used_corpus(tmp_path):
    """The count cache (4 entries) evicts the least recently used entry: a
    corpus counted again between four other count calls stays cached, so
    its fill returns the ids of the counted text even after the file was
    rewritten to other words of the same size and mtime. Those ids equal
    the JAX library's on that text; a fresh count then sees the new
    text."""
    fn = _bind(native.load("tokenize"))
    jfn = _bind(jnative.load("tokenize"))
    paths = {k: tmp_path / f"{k}.txt" for k in "abcde"}
    for k, p in paths.items():
        p.write_text(f"{k}one {k}two {k}one {k}three\n" * 20)
    a = str(paths["a"]).encode()
    n = fn(a, 64, None, None, 0, None)
    for k in "bc":
        fn(str(paths[k]).encode(), 64, None, None, 0, None)
    assert fn(a, 64, None, None, 0, None) == n  # a hit: a is the newest entry
    for k in "de":
        fn(str(paths[k]).encode(), 64, None, None, 0, None)

    def fill(f, path):
        ids, vs = np.empty(n, dtype=np.int32), ctypes.c_int()
        assert f(path, 64, None, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
                 ctypes.byref(vs)) == n
        return ids, vs.value

    jfn(a, 64, None, None, 0, None)
    want = fill(jfn, a)
    st = os.stat(paths["a"])
    paths["a"].write_text("aone aone atwo athree\n" * 20)  # the same size, other counts
    os.utime(paths["a"], ns=(st.st_atime_ns, st.st_mtime_ns))
    assert os.path.getsize(paths["a"]) == st.st_size
    got = fill(fn, a)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert fn(a, 64, None, None, 0, None) == n  # the fill took the entry: a fresh build
    assert not np.array_equal(fill(fn, a)[0], want[0])


def test_interleaved_corpora_and_vocab_caps(tmp_path):
    """The two-call protocol on the port's library: interleaved count calls
    for two corpora and two caps each fill from their own cached build, and
    equal the JAX library's fills."""
    def bind(lib):
        fn = lib.word_tokenize_file
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                       ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_long
        return fn

    pa, pb = tmp_path / "a.txt", tmp_path / "b.txt"
    pa.write_text("alpha beta gamma alpha beta alpha\n" * 50)
    pb.write_text("delta epsilon delta zeta eta theta iota\n" * 50)
    results = []
    for fn in (bind(native.load("tokenize")), bind(jnative.load("tokenize"))):
        def fill(p, mv, n):
            ids, vs = np.empty(n, dtype=np.int32), ctypes.c_int()
            assert fn(str(p).encode(), mv, None,
                      ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
                      ctypes.byref(vs)) == n
            return ids, vs.value

        na = fn(str(pa).encode(), 64, None, None, 0, None)
        nb = fn(str(pb).encode(), 64, None, None, 0, None)
        na4 = fn(str(pa).encode(), 4, None, None, 0, None)
        assert na == na4 == 50 * 6 and nb == 50 * 7
        results.append((fill(pb, 64, nb), fill(pa, 64, na), fill(pa, 4, na4)))
    (b, a, a4), (jb, ja, ja4) = results
    assert (a[1], b[1], a4[1]) == (5, 8, 4) and (a4[0] == 1).any()
    for got, want in ((b, jb), (a, ja), (a4, ja4)):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_word_dataset_on_the_bundled_corpus(tmp_path, monkeypatch):
    """``make_lm_dataset(tokenizer="word")`` on the bundled corpus gives the
    JAX package's batches."""
    monkeypatch.chdir(tmp_path)  # the default data cache is relative
    kw = dict(context_length=64, batch_size=4, vocab_size=256, corpus_path=str(BUNDLED),
              tokenizer="word")
    ds, jds = lm_dataset.make_lm_dataset(**kw), jdata.make_lm_dataset(**kw)
    assert len(ds) == len(jds) > 100
    for i in (0, 1, len(ds) - 1):
        np.testing.assert_array_equal(ds.batch(i), jds.batch(i))


@pytest.mark.parametrize("size_mb,n_extra,seed", [(0.2, 500, 7), (0.5, 3000, 0)])
def test_generate_corpus_matches_jax(tmp_path, size_mb, n_extra, seed):
    """The same arguments write the same bytes and the same sidecar; the
    port's tokenizer then caps the generated types with <unk> pressure."""
    a, b = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    info = corpus_gen.generate_corpus(a, size_mb=size_mb, n_extra_types=n_extra, seed=seed)
    jinfo = jcorpus.generate_corpus(b, size_mb=size_mb, n_extra_types=n_extra, seed=seed)
    assert info == jinfo and not info.get("reused")
    assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()
    assert json.loads(pathlib.Path(a + ".meta.json").read_text()) == \
        json.loads(pathlib.Path(b + ".meta.json").read_text())
    ids, vocab = lm_dataset.word_tokenize_file(a, max_vocab=1024,
                                               cache_dir=str(tmp_path / "cache"))
    assert vocab == 1024 and (ids == 1).any() and 0 < ids.max() < 1024


def test_generate_corpus_reuse_and_regeneration(tmp_path):
    """A second call with the same parameters reuses the file (counts from
    the sidecar), also one the JAX generator wrote; other parameters or a
    missing sidecar regenerate it, as in JAX."""
    out = str(tmp_path / "a.txt")
    jcorpus.generate_corpus(out, size_mb=0.2, n_extra_types=500, seed=7)
    body7 = pathlib.Path(out).read_bytes()
    info = corpus_gen.generate_corpus(out, size_mb=0.2, n_extra_types=500, seed=7)
    assert info.get("reused") and info["tokens"] > 0 and info["types"] > 500
    info = corpus_gen.generate_corpus(out, size_mb=0.2, n_extra_types=500, seed=8)
    assert not info.get("reused") and pathlib.Path(out).read_bytes() != body7
    want = str(tmp_path / "b.txt")
    jcorpus.generate_corpus(want, size_mb=0.2, n_extra_types=500, seed=8)
    assert pathlib.Path(out).read_bytes() == pathlib.Path(want).read_bytes()
    os.remove(out + ".meta.json")
    info = corpus_gen.generate_corpus(out, size_mb=0.2, n_extra_types=500, seed=8)
    assert not info.get("reused") and info["tokens"] > 0
    assert pathlib.Path(out).read_bytes() == pathlib.Path(want).read_bytes()


def test_tokenizer_builds_into_the_compile_cache(tmp_path):
    """``SATURN_TPU_COMPILE_CACHE_DIR``: a first process builds the
    tokenizer's library into that directory, a second loads it there and
    starts no compiler (every ``subprocess`` launch in it is recorded)."""
    d = tmp_path / "compile_cache"
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(SAMPLE)
    code = (
        "import json, subprocess, sys\n"
        "started = []\n"
        "class Popen(subprocess.Popen):\n"
        "    def __init__(self, args, *a, **k):\n"
        "        started.append(str(args[0]))\n"
        "        super().__init__(args, *a, **k)\n"
        "subprocess.Popen = Popen\n"
        "from saturn_tpu_torch.data import lm_dataset\n"
        "from saturn_tpu_torch import native\n"
        "ids, vocab = lm_dataset.word_tokenize_file(sys.argv[1], 64, sys.argv[2])\n"
        "print(json.dumps({'started': started, 'path': str(native.library_path('tokenize')),"
        " 'vocab': vocab}))\n"
    )
    env = dict(os.environ, SATURN_TPU_COMPILE_CACHE_DIR=str(d), PYTHONPATH=str(ROOT))
    runs = []
    for i in range(2):
        out = subprocess.run([sys.executable, "-c", code, str(corpus), str(tmp_path / f"c{i}")],
                             env=env, cwd=tmp_path, check=True, capture_output=True, text=True,
                             timeout=300)
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    first, second = runs
    assert [os.path.basename(s) for s in first["started"]] == ["g++"]
    assert second["started"] == [] and first["path"] == second["path"]
    lib = pathlib.Path(first["path"])
    assert lib.parent == d.resolve() and lib.exists() and first["vocab"] == second["vocab"]
    assert not list(d.glob("*.tmp*"))  # written under a temporary name, then renamed
