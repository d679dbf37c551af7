"""L0 — AST extraction: source code → the ``ast.original`` JSON node list.

Counterpart of the JAX package's ``data/extract.py`` (which imports no JAX;
the port imports nothing of that package and keeps its own copy): parse a
function, build a DFS-ordered node graph where

* non-terminals are ``"nont:<type>:<start>:<end>:<idx>"``;
* identifier leaves are ``"idt:<token>:<start>:<end>:<idx>"``; snake_case /
  camelCase identifiers are split into sub-token **chains**, each split
  becoming a chained child of the previous one;
* string and number literals and punctuation are skipped;

in the schema ``data/ast_tools.py:ast_json_to_tree`` consumes:
``{"label": ..., "children": [child labels]}`` with **1-indexed** trailing
ids.  :func:`extract_corpus` turns (source, summary) pairs into a split's
``ast.original`` + ``nl.original``.

Backends, one node graph (:class:`_NodeGraph`) under both:

* **stdlib ``ast``** (always available) — Python sources only; node *types*
  are CPython AST class names.
* **tree-sitter** (used when the ``tree_sitter`` package and the language's
  grammar import) — :func:`cst_to_ast_json` walks the CST with the
  reference's quirks (punctuation types skipped by substring test, Java
  ``ERROR`` → ``parameters``, string-like leaves dropped), for the
  reference's node taxonomy and for languages other than Python, which
  raise without a grammar.
"""

from __future__ import annotations

import ast as py_ast
import json
import string as _string
from typing import Iterable, List, Optional, Tuple

__all__ = [
    "split_camelcase",
    "split_identifier_into_parts",
    "python_to_ast_json",
    "cst_to_ast_json",
    "source_to_ast_json",
    "extract_corpus",
    "have_tree_sitter",
    "IDENTIFIER_TYPE",
    "STRING_TYPE",
]

# Per-language CST leaf-type tables (ref ``java/process_utils.py:4-111`` ==
# ``py/process_utils.py:4-103``): which leaf types carry identifiers (split
# into sub-token chains) and which are string-like (no terminal emitted).
IDENTIFIER_TYPE = {
    "java": [
        "identifier", "type_identifier", "scoped_type_identifier",
        "scoped_identifier", "enum_constant", "variable_declarator",
        "local_variable_declaration",
    ],
    "python": ["identifier", "list_splat_pattern", "type_conversion"],
    "ruby": [
        "identifier", "hash_key_symbol", "simple_symbol", "constant",
        "instance_variable", "global_variable", "class_variable",
    ],
    "javascript": [
        "identifier", "hash_key_symbol", "simple_symbol", "constant",
        "instance_variable", "global_variable", "class_variable",
        "property_identifier", "shorthand_property_identifier",
        "statement_identifier", "shorthand_property_identifier_pattern",
        "regex_flags",
    ],
    "go": [
        "identifier", "hash_key_symbol", "simple_symbol", "constant",
        "instance_variable", "global_variable", "class_variable",
        "property_identifier", "shorthand_property_identifier",
        "statement_identifier", "shorthand_property_identifier_pattern",
        "regex_flags", "type_identifier", "field_identifier",
        "package_identifier", "label_name",
    ],
}
STRING_TYPE = {
    # python/java carry two additions over the reference tables
    # (string_content / string_fragment): modern tree-sitter grammars emit
    # string *content* as its own leaf, which would otherwise leak raw
    # string text into the graph as an idt terminal; on the reference's
    # pinned grammars these types never occur, so behavior is unchanged
    "java": ["string", "comment", "string_literal", "character_literal",
             "string_fragment"],
    "python": [
        "heredoc_content", "string", "comment", "string_literal",
        "character_literal", "chained_string", "escape_sequence",
        "string_content",
    ],
    "ruby": [
        "heredoc_content", "string", "comment", "string_literal",
        "character_literal", "chained_string", "escape_sequence",
        "string_content", "heredoc_beginning", "heredoc_end",
    ],
    "javascript": [
        "heredoc_content", "string", "comment", "string_literal",
        "character_literal", "chained_string", "escape_sequence",
        "string_content", "heredoc_beginning", "heredoc_end", "jsx_text",
        "regex_pattern", "string_fragment",
    ],
    "go": [
        "heredoc_content", "string", "comment", "string_literal",
        "character_literal", "chained_string", "escape_sequence",
        "string_content", "heredoc_beginning", "heredoc_end",
        "regex_pattern", "\n", "raw_string_literal", "rune_literal",
    ],
}
# numeric leaf types whose literals are dropped (ref process_utils.py:231-240)
_NUMBER_TYPES = frozenset({
    "decimal_integer_literal", "decimal_floating_point_literal",
    "hex_integer_literal", "integer", "float", "int_literal",
    "imaginary_literal", "float_literal",
})


def _is_number(s: str) -> bool:
    """ref ``process_utils.py:is_number`` (float() plus unicode numerics)."""
    try:
        float(s)
        return True
    except ValueError:
        pass
    try:
        import unicodedata

        unicodedata.numeric(s)
        return True
    except (TypeError, ValueError):
        return False


def split_camelcase(token: str) -> List[str]:
    """``camelCaseHTTP2Word`` → ``['camel', 'Case', 'HTTP', '2', 'Word']``.

    Behavior-equivalent to the reference splitter
    (ref ``py/process_utils.py:split_camelcase``): a new word starts at a
    lower→upper, alpha→digit, or alnum→special boundary; a run of uppers
    followed by a lower keeps its last upper as the next word's head
    (``HTTPWord`` → ``HTTP``, ``Word``).
    """
    if not token:
        return []
    parts: List[str] = []
    cur = token[0]
    for ch in token[1:]:
        prev = cur[-1]
        new_upper = ch.isupper() and not prev.isupper()
        new_digit = ch.isdigit() and not prev.isdigit()
        new_special = (not ch.isalnum()) and prev.isalnum()
        left_digit = (not ch.isdigit()) and prev.isdigit()
        left_special = ch.isalnum() and not prev.isalnum()
        if new_upper or new_digit or new_special:
            parts.append(cur)
            cur = ch
        elif not ch.isupper() and prev.isupper() and len(cur) > 1:
            # end of an upper run: its last char heads the new word
            parts.append(cur[:-1])
            cur = cur[-1] + ch
        elif left_digit or left_special:
            parts.append(cur)
            cur = ch
        else:
            cur += ch
    parts.append(cur)
    return parts


def split_identifier_into_parts(identifier: str) -> List[str]:
    """snake_case first, then camelCase within each part, **lowercased**
    (ref ``py/process_utils.py:106-119``)."""
    out: List[str] = []
    for snake in identifier.split("_"):
        if not snake:
            continue
        out.extend(s.lower() for s in split_camelcase(snake))
    return out or [identifier]


class _NodeGraph:
    """Accumulates DFS-ordered nodes with reference label syntax."""

    def __init__(self) -> None:
        self.labels: List[str] = []
        self.children: List[List[int]] = []

    def add(self, kind: str, value: str, start: int, end: int) -> int:
        value = value.replace(":", "") or "_"
        idx = len(self.labels) + 1  # 1-indexed ids (ref my_ast.py:118-119)
        self.labels.append(f"{kind}:{value}:{start}:{end}:{idx}")
        self.children.append([])
        return idx

    def link(self, parent: int, child: int) -> None:
        self.children[parent - 1].append(child)

    def add_identifier_chain(self, parent: int, token: str, start: int, end: int) -> None:
        """Sub-token chain: each split is a child of the previous split
        (ref ``py/process_utils.py:222-229``)."""
        prev = parent
        for part in split_identifier_into_parts(token):
            node = self.add("idt", part, start, end)
            self.link(prev, node)
            prev = node

    def to_json(self) -> List[dict]:
        out = []
        for label, kids in zip(self.labels, self.children):
            rec: dict = {"label": label}
            if kids:
                rec["children"] = [self.labels[k - 1] for k in kids]
            out.append(rec)
        return out


def _py_walk(graph: _NodeGraph, node: py_ast.AST, parent: Optional[int]) -> None:
    kind = type(node).__name__
    start = getattr(node, "lineno", 0) or 0
    end = getattr(node, "end_lineno", start) or start
    me = graph.add("nont", kind, start, end)
    if parent is not None:
        graph.link(parent, me)

    # identifier-bearing fields become idt sub-token chains; string/number
    # literals and pure punctuation are skipped (ref process_utils.py:201+)
    for field in ("name", "id", "attr", "arg", "module"):
        val = getattr(node, field, None)
        if isinstance(val, str) and val:
            graph.add_identifier_chain(me, val, start, end)
    for child in py_ast.iter_child_nodes(node):
        if isinstance(child, (py_ast.Load, py_ast.Store, py_ast.Del)):
            continue  # expression-context markers carry no structure
        _py_walk(graph, child, me)


def python_to_ast_json(source: str) -> List[dict]:
    """One Python function/module source → JSON node list (``ast.original``
    line format)."""
    tree = py_ast.parse(source)
    # a single top-level def is the common corpus shape; descend into it so
    # the root is the function, matching the reference's per-function trees
    root: py_ast.AST = tree
    if isinstance(tree, py_ast.Module) and len(tree.body) == 1:
        root = tree.body[0]
    graph = _NodeGraph()
    _py_walk(graph, root, None)
    return graph.to_json()


def have_tree_sitter(language: str = "python") -> bool:
    try:  # pragma: no cover - environment dependent
        import tree_sitter  # noqa: F401
        __import__(f"tree_sitter_{language}")
        return True
    except Exception:
        return False


def cst_to_ast_json(root, language: str) -> List[dict]:
    """tree-sitter-shaped CST → node graph with the reference's exact walk
    semantics (ref ``java/process_utils.py:dfs_graph``, ``:210-216`` and the
    identical ``py/process_utils.py:196-272``):

    * nodes whose *type* is a **substring** of ``string.punctuation`` are
      skipped entirely — the reference's ``node.type in string.punctuation``
      is a substring test, so multi-char operator types that happen to be
      substrings (``<=``, ``=>``, ``::``) are skipped while others (``==``,
      ``!=``) are kept and even emit an ``idt`` terminal (the literal-level
      check has the same quirk). Reproduced deliberately: the type
      vocabulary must match what the reference pipeline produced;
    * Java ``ERROR`` nodes are remapped to type ``parameters`` (the
      tree-sitter-java recovery quirk, ref ``java/process_utils.py:210-216``);
    * every surviving node becomes a ``nont`` node — keywords included;
    * leaf handling: string-like types emit no terminal; identifier types
      emit a lowercased sub-token *chain* under the ``nont`` node; numeric
      literals and punctuation literals are dropped; anything else emits a
      single raw ``idt`` terminal.

    ``root`` only needs ``type`` / ``children`` / ``start_point`` /
    ``end_point`` / ``text`` attributes, so tests can drive this with
    vendored CST fixtures when no grammar wheel is installed.
    """
    ident_types = IDENTIFIER_TYPE.get(language, IDENTIFIER_TYPE["python"])
    string_types = STRING_TYPE.get(language, STRING_TYPE["python"])
    graph = _NodeGraph()

    def walk(node, parent: Optional[int]) -> None:
        kind = node.type
        if kind in _string.punctuation:
            return
        if language == "java" and kind == "ERROR":
            kind = "parameters"
        start, end = node.start_point[0], node.end_point[0]
        me = graph.add("nont", kind, start, end)
        if parent is not None:
            graph.link(parent, me)
        if not node.children:
            if node.type not in string_types:
                literal = (
                    node.text.decode(errors="replace")
                    if isinstance(node.text, bytes)
                    else str(node.text)
                )
                if node.type in ident_types:
                    graph.add_identifier_chain(me, literal, start, end)
                elif _is_number(literal) or node.type in _NUMBER_TYPES:
                    pass
                elif literal in _string.punctuation:
                    pass
                elif literal:
                    node_id = graph.add("idt", literal, start, end)
                    graph.link(me, node_id)
        for child in node.children:
            walk(child, me)

    walk(root, None)
    return graph.to_json()


def _treesitter_to_ast_json(source: str, language: str) -> List[dict]:  # pragma: no cover
    """tree-sitter CST → node graph, for environments with grammars installed."""
    import tree_sitter

    lang_mod = __import__(f"tree_sitter_{language}")
    parser = tree_sitter.Parser(tree_sitter.Language(lang_mod.language()))
    tree = parser.parse(source.encode())
    return cst_to_ast_json(tree.root_node, language)


def source_to_ast_json(source: str, language: str = "python") -> List[dict]:
    """Dispatch: tree-sitter when available, stdlib ``ast`` for Python."""
    if have_tree_sitter(language):
        return _treesitter_to_ast_json(source, language)
    if language != "python":
        raise RuntimeError(
            f"extracting {language!r} requires the tree_sitter_{language} grammar; "
            "only Python has a stdlib fallback"
        )
    return python_to_ast_json(source)


def extract_corpus(
    pairs: Iterable[Tuple[str, str]],
    out_dir: str,
    language: str = "python",
) -> int:
    """(source, natural-language summary) pairs → ``ast.original`` +
    ``nl.original`` in ``out_dir`` (the L1 input contract,
    ref ``process.py:42-63``). Unparseable sources are skipped. Returns the
    number of examples written."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    n = 0
    with open(os.path.join(out_dir, "ast.original"), "w") as fa, open(
        os.path.join(out_dir, "nl.original"), "w"
    ) as fn:
        for source, nl in pairs:
            try:
                nodes = source_to_ast_json(source, language)
            except (SyntaxError, ValueError, RecursionError):
                # ValueError: NUL bytes in source; RecursionError: absurdly
                # nested code — all count as unparseable and are skipped
                continue
            fa.write(json.dumps(nodes) + "\n")
            fn.write(" ".join(nl.split()) + "\n")
            n += 1
    return n
