"""The port's extraction and real-corpus tool against the JAX package's,
exactly (labels, files and pairs compared for equality):

* ``cst_to_ast_json`` on every CST fixture of
  ``tests/test_extract_reference_differential.py`` (real tree-sitter-java /
  -python node taxonomy) and on ``tests/test_extract.py``'s ``FakeCST``
  cases — the Java ``ERROR`` remap, the punctuation-substring quirk, the
  string-content drops, identifier chains;
* ``source_to_ast_json``'s dispatch: tree-sitter first when a grammar
  imports (a stand-in ``tree_sitter`` package here), the stdlib path for
  Python otherwise, JAX's error for Java without a grammar;
* ``extract_corpus`` files byte for byte, unparseable sources mixed in;
* ``tools/build_real_corpus_torch.py:harvest`` = ``tools/build_real_corpus.py:harvest``
  on the machine's stdlib and on a small tree that exercises the
  directory filters, its split, and ``process_dataset``'s outputs on those
  pairs (text files byte for byte, matrices array for array, vocabularies
  entry for entry).

No ``tree_sitter`` is installed on either machine, so the CST walk is held
on fixtures, as the JAX package's own tests hold it."""

import os
import sys
import types

import numpy as np
import pytest

from test_extract import SRC, FakeCST, _java_method_cst
from test_extract_reference_differential import FIXTURES

HARVEST = 64


def _both(name):
    import csat_tpu.data.extract as jx
    import csat_tpu_torch.data.extract as tx

    return getattr(jx, name), getattr(tx, name)


def _fake_cst_cases():
    s = FakeCST
    return {
        "java_method": (_java_method_cst(), "java"),
        "punctuation_substring": (s("binary_expression", [s("<=", text=b"<="),
                                                          s("==", text=b"==")]), "java"),
        "python_string_content": (s("program", [s("string", [s("string_content",
                                                                text=b"hello world")])]),
                                  "python"),
        "java_string_fragment": (s("program", [s("string_fragment", text=b"hello world")]),
                                 "java"),
        "identifier_chain": (s("program", [s("identifier", text=b"getUserName")]), "java"),
        "numbers_and_unicode": (s("program", [s("integer", text=b"7"), s("word", text=b"\xc2\xbd"),
                                              s("float", text=b"1e3"), s("word", text=b"x1")]),
                                "python"),
        "unknown_language": (s("module", [s("identifier", text=b"snake_case_name")]), "kotlin"),
    }


@pytest.mark.parametrize("fixture", FIXTURES, ids=lambda f: f.__name__)
def test_cst_walk_equals_jax_on_reference_fixtures(fixture):
    jwalk, twalk = _both("cst_to_ast_json")
    _, tree, language = fixture()
    ours = twalk(tree, language)
    assert ours == jwalk(tree, language) and len(ours) > 3


@pytest.mark.parametrize("case", sorted(_fake_cst_cases()))
def test_cst_walk_equals_jax_on_fake_csts(case):
    jwalk, twalk = _both("cst_to_ast_json")
    tree, language = _fake_cst_cases()[case]
    assert twalk(tree, language) == jwalk(tree, language)


def test_cst_quirks_reproduced():
    _, twalk = _both("cst_to_ast_json")
    tree, _ = _fake_cst_cases()["java_method"]
    kinds = {tuple(r["label"].split(":")[:2]) for r in twalk(tree, "java")}
    assert ("nont", "parameters") in kinds and not any(v == "ERROR" for _, v in kinds)
    assert ("idt", "42") not in kinds and ("idt", "return") in kinds
    tree, _ = _fake_cst_cases()["punctuation_substring"]
    kinds = {tuple(r["label"].split(":")[:2]) for r in twalk(tree, "java")}
    assert not any(v == "<=" for _, v in kinds) and ("idt", "==") in kinds


@pytest.fixture
def fake_tree_sitter(monkeypatch):
    """A stand-in ``tree_sitter`` with a ``python`` grammar whose parser
    returns ``_java_method_cst()``-shaped trees for any source."""
    ts = types.ModuleType("tree_sitter")
    parsed = []

    class Language:
        def __init__(self, handle):
            self.handle = handle

    class Parser:
        def __init__(self, language):
            assert language.handle == "python-grammar"

        def parse(self, source):
            parsed.append(source)
            return types.SimpleNamespace(root_node=_java_method_cst())

    ts.Language, ts.Parser = Language, Parser
    grammar = types.ModuleType("tree_sitter_python")
    grammar.language = lambda: "python-grammar"
    monkeypatch.setitem(sys.modules, "tree_sitter", ts)
    monkeypatch.setitem(sys.modules, "tree_sitter_python", grammar)
    return parsed


def test_dispatch_prefers_tree_sitter(fake_tree_sitter):
    jsrc, tsrc = _both("source_to_ast_json")
    jhave, thave = _both("have_tree_sitter")
    assert thave("python") and jhave("python") and not thave("java")
    ours = tsrc("def f(x):\n    return x\n", "python")
    assert ours == jsrc("def f(x):\n    return x\n", "python")
    assert len(fake_tree_sitter) == 2 and any(r["label"].startswith("nont:method_declaration")
                                              for r in ours)


def test_dispatch_without_a_grammar(monkeypatch):
    jsrc, tsrc = _both("source_to_ast_json")
    _, thave = _both("have_tree_sitter")
    monkeypatch.setitem(sys.modules, "tree_sitter", None)  # not importable
    assert not thave("python")
    assert tsrc(SRC, "python") == jsrc(SRC, "python")
    errors = []
    for fn in (jsrc, tsrc):
        with pytest.raises(RuntimeError) as e:
            fn("class A { }", "java")
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "tree_sitter_java" in errors[0]


def test_extract_corpus_files_byte_identical(tmp_path):
    jext, text = _both("extract_corpus")
    pairs = [(SRC, "finds the  maximum\nvalue"), ("def broken(:", "never written"),
             ("def add(a, b):\n    return a + b", "adds two numbers"),
             ("x = 1\0", "nul byte"), ("(" * 300 + ")" * 300, "too deep"),
             ("class K:\n    def camelCase_name(self):\n        return self.httpURL2\n",
              "a method")]
    n = {pkg: fn(pairs, str(tmp_path / pkg), "python") for pkg, fn in (("jax", jext),
                                                                          ("torch", text))}
    assert n["jax"] == n["torch"] == 3
    for name in ("ast.original", "nl.original"):
        a = (tmp_path / "jax" / name).read_bytes()
        assert a == (tmp_path / "torch" / name).read_bytes() and len(a) > 0


@pytest.fixture(scope="module")
def tools_modules():
    from tools import build_real_corpus as jtool
    from tools import build_real_corpus_torch as ttool

    return jtool, ttool


@pytest.fixture(scope="module")
def stdlib_pairs(tools_modules):
    jtool, ttool = tools_modules
    return jtool.harvest(HARVEST, seed=3), ttool.harvest(HARVEST, seed=3)


def test_harvest_equals_jax_on_the_stdlib(stdlib_pairs):
    jpairs, tpairs = stdlib_pairs
    assert tpairs == jpairs and len(tpairs) == HARVEST


def _small_tree(root):
    """A stdlib stand-in: a module with functions and methods that pass and
    fail each filter, and directories the walk must prune."""
    body = '''
def kept_function(a, b):
    """Adds two numbers and returns the sum."""
    return a + b


def too_short(a):
    """Short."""
    return a


def __dunder__(a):
    """A dunder name is never kept here."""
    return a


class Klass:
    def method_one(self, x):
        """Returns the value of x times two, as an int."""
        return x * 2

    async def method_two(self):
        """Waits for nothing and then returns nothing at all."""
        return None


def kept_function(a, b):
    """Adds two numbers and returns the sum."""
    return b + a
'''
    for sub in ("", "pkg", "test", "idlelib", "__pycache__", "site-packages", "pkg/latest"):
        d = root / sub
        d.mkdir(parents=True, exist_ok=True)
        (d / "mod.py").write_text(body.replace("kept_function", f"kept_{sub.replace('/', '_')}"))
    (root / "broken.py").write_text("def broken(:\n")


def test_harvest_filters_equal_jax(tools_modules, tmp_path, monkeypatch):
    import sysconfig

    jtool, ttool = tools_modules
    _small_tree(tmp_path / "stdlib")
    monkeypatch.setattr(sysconfig, "get_path", lambda name: str(tmp_path / "stdlib"))
    jpairs, tpairs = jtool.harvest(100, seed=1), ttool.harvest(100, seed=1)
    assert tpairs == jpairs
    names = sorted(src.split("(")[0].split()[-1] for src, _ in tpairs)
    # root, pkg and pkg/latest kept; test/, idlelib/, __pycache__/, site-packages/ pruned
    assert names == sorted(["kept_", "kept_pkg", "kept_pkg_latest"] + ["method_one"]
                           + ["method_two"])


def test_split_equals_jax_split(stdlib_pairs, tools_modules):
    _, ttool = tools_modules
    pairs = stdlib_pairs[1]
    split = ttool.split_pairs(pairs)
    n = max(1, len(pairs) // 20)  # tools/build_real_corpus.py:main
    assert split == {"dev": pairs[:n], "test": pairs[n:2 * n], "train": pairs[2 * n:]}
    split = ttool.split_pairs(pairs, 8, 4)
    assert [len(split[s]) for s in ("dev", "test", "train")] == [8, 4, HARVEST - 12]


def test_processed_splits_equal_jax(stdlib_pairs, tmp_path):
    from csat_tpu.data.extract import extract_corpus as jext
    from csat_tpu.data.preprocess import process_dataset as jproc
    from csat_tpu.data.vocab import load_vocab as jload
    from csat_tpu_torch.data.extract import extract_corpus as text
    from csat_tpu_torch.data.preprocess import process_dataset as tproc
    from csat_tpu_torch.data.vocab import load_vocab as tload

    pairs = stdlib_pairs[1]
    splits = {"dev": pairs[:8], "test": pairs[8:16], "train": pairs[16:]}
    for pkg, ext, proc in (("jax", jext, jproc), ("torch", text, tproc)):
        for split, sp in splits.items():
            assert ext(sp, str(tmp_path / pkg / split), "python") == len(sp)
        proc(str(tmp_path / pkg), 150, make_vocab=True, n_jobs=1)
    for split in splits:
        for name in ("ast.original", "nl.original", "split_pot.seq"):
            a = (tmp_path / "jax" / split / name).read_bytes()
            assert a == (tmp_path / "torch" / split / name).read_bytes() and len(a) > 0
        jm = np.load(str(tmp_path / "jax" / split / "split_matrices.npz"), allow_pickle=True)
        tm = np.load(str(tmp_path / "torch" / split / "split_matrices.npz"), allow_pickle=True)
        assert sorted(jm.files) == sorted(tm.files)
        for key in ("L", "T", "root_first_level"):
            for a, b in zip(jm[key], tm[key], strict=True):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for ra, rb in zip(jm["root_first_seq"], tm["root_first_seq"], strict=True):
            assert list(ra.labels) == list(rb.labels)
    for jv, tv in zip(jload(str(tmp_path / "jax")), tload(str(tmp_path / "torch"))):
        assert jv.w2i == tv.w2i and jv.i2w == tv.i2w and tv.size() > 38
    assert os.path.exists(tmp_path / "torch" / "node_triplet_dictionary_python.pt")
