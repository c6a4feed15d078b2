"""Guided (constrained) decoding: regex / JSON-schema / choice masks.

The port's own copy of ``modegpt_tpu.models.guided`` (pure numpy there
and here), with the same split between a host automaton and masking on
the device:

* A **byte-level DFA** is compiled on the host from a regex (or from a
  JSON schema / generic-JSON grammar lowered to a regex): Thompson NFA,
  then subset construction, with the 256-byte alphabet partitioned into
  equivalence classes first, so construction cost scales with the
  number of distinct byte sets, not 256 x states.
* The DFA is **lifted to token level** (`TokenGuide`): for a given DFA
  state, every vocabulary token is walked through the DFA in one
  vectorised numpy pass over a padded [V, L] byte matrix; a token is
  allowed iff the walk never hits the dead state. Rows are memoised per
  state, so steady-state serving reuses them.
* The batcher (`models.serving`) keeps an ``allow`` [slots, V] bool
  table on the card and uploads a guided slot's row after each of its
  committed tokens; every dispatch masks the logits with it (``-inf``
  where disallowed) before the token is chosen. The automaton never runs
  on the card: the mask for step t depends only on the state before
  step t, which the host knows when it issues the dispatch.

EOS is allowed exactly when the DFA state is accepting; when a state has
no allowed token and is not accepting (possible with incomplete
vocabularies) the batcher finishes the request on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "CharDFA",
    "TokenGuide",
    "compile_regex",
    "regex_for_choice",
    "regex_for_json_schema",
    "regex_for_json_value",
    "token_bytes_from_tokenizer",
]


# --------------------------------------------------------------------------
# Regex parsing: a self-contained subset (fullmatch semantics, byte-level)
# --------------------------------------------------------------------------
# AST nodes: ("lit", frozenset[int]) | ("cat", [nodes]) | ("alt", [nodes])
#            | ("rep", node, min, max|None)

_SPECIAL = set("\\^$.|?*+()[]{}")

_ESCAPES = {
    "d": frozenset(range(0x30, 0x3A)),
    "w": frozenset(
        list(range(0x30, 0x3A)) + list(range(0x41, 0x5B))
        + list(range(0x61, 0x7B)) + [0x5F]
    ),
    "s": frozenset([0x20, 0x09, 0x0A, 0x0D, 0x0B, 0x0C]),
    "n": frozenset([0x0A]),
    "t": frozenset([0x09]),
    "r": frozenset([0x0D]),
}
_ESCAPES["D"] = frozenset(range(256)) - _ESCAPES["d"]
_ESCAPES["W"] = frozenset(range(256)) - _ESCAPES["w"]
_ESCAPES["S"] = frozenset(range(256)) - _ESCAPES["s"]

_DOT = frozenset(range(256)) - frozenset([0x0A])
_REP_CAP = 1024  # {m,n} duplication bound


class RegexError(ValueError):
    pass


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    # alternation := concat ('|' concat)*
    def parse(self):
        node = self._alternation()
        if self.i != len(self.p):
            raise RegexError(f"unexpected {self.p[self.i]!r} at {self.i}")
        return node

    def _alternation(self):
        branches = [self._concat()]
        while self.peek() == "|":
            self.take()
            branches.append(self._concat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _concat(self):
        parts = []
        while self.peek() is not None and self.peek() not in "|)":
            parts.append(self._repeat())
        if not parts:
            return ("cat", [])  # empty branch matches ""
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def _repeat(self):
        node = self._atom()
        quantified = False
        while True:
            c = self.peek()
            if c in ("*", "+", "?"):
                if quantified:
                    if c == "?":  # non-greedy marker: same DFA language
                        self.take()
                        continue
                    raise RegexError(f"multiple repeat at {self.i}")
                self.take()
                lo, hi = {"*": (0, None), "+": (1, None), "?": (0, 1)}[c]
                node = ("rep", node, lo, hi)
                quantified = True
            elif c == "{":
                save = self.i
                bound = self._try_braces()
                if bound is None:
                    self.i = save
                    break
                if quantified:
                    raise RegexError(f"multiple repeat at {save}")
                lo, hi = bound
                if lo > _REP_CAP or (hi is not None and (hi < lo or hi > _REP_CAP)):
                    raise RegexError(f"bad repetition bound {{{lo},{hi}}}")
                node = ("rep", node, lo, hi)
                quantified = True
            else:
                break
        return node

    def _try_braces(self) -> Optional[Tuple[int, Optional[int]]]:
        # at '{'; returns (lo, hi|None) or None if not a valid bound
        # (then '{' is a literal, like Python re)
        self.take()
        digits = ""
        while self.peek() is not None and self.peek().isdigit():
            digits += self.take()
        if self.peek() == "}":
            if not digits:
                return None
            self.take()
            return (int(digits), int(digits))
        if self.peek() != ",":
            return None
        self.take()
        lo = int(digits) if digits else 0
        digits2 = ""
        while self.peek() is not None and self.peek().isdigit():
            digits2 += self.take()
        if self.peek() != "}":
            return None
        self.take()
        return (lo, int(digits2) if digits2 else None)

    def _atom(self):
        c = self.peek()
        if c is None:
            raise RegexError("unexpected end of pattern")
        if c == "(":
            self.take()
            if self.peek() == "?":  # (?:...) non-capturing — groups are
                self.take()         # all non-capturing here anyway
                if self.peek() != ":":
                    raise RegexError("only (?:...) groups are supported")
                self.take()
            node = self._alternation()
            if self.peek() != ")":
                raise RegexError("unbalanced '('")
            self.take()
            return node
        if c == "[":
            return ("lit", self._charclass())
        if c == ".":
            self.take()
            return ("lit", _DOT)
        if c == "\\":
            self.take()
            return ("lit", self._escape())
        if c in "^$":
            raise RegexError("anchors are implicit (fullmatch semantics)")
        if c in "*+?{":
            # bare '{' not starting a bound is a literal; others are errors
            if c == "{":
                self.take()
                return ("lit", frozenset([0x7B]))
            raise RegexError(f"dangling quantifier {c!r}")
        self.take()
        b = c.encode("utf-8")
        if len(b) == 1:
            return ("lit", frozenset([b[0]]))
        # multi-byte literal -> byte sequence
        return ("cat", [("lit", frozenset([x])) for x in b])

    def _escape(self) -> frozenset:
        c = self.peek()
        if c is None:
            raise RegexError("dangling escape")
        self.take()
        if c in _ESCAPES:
            return _ESCAPES[c]
        if c == "x":
            h = self.take() + self.take()
            return frozenset([int(h, 16)])
        b = c.encode("utf-8")
        if len(b) != 1:
            raise RegexError(f"cannot escape non-ASCII {c!r}")
        return frozenset([b[0]])

    def _charclass(self) -> frozenset:
        self.take()  # '['
        negate = False
        if self.peek() == "^":
            negate = True
            self.take()
        items: set = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise RegexError("unterminated character class")
            if c == "]" and not first:
                self.take()
                break
            first = False
            if c == "\\":
                self.take()
                lo_set = self._escape()
                if len(lo_set) != 1:
                    items |= lo_set  # \d etc. inside a class
                    continue
                (lo,) = lo_set
            else:
                self.take()
                eb = c.encode("utf-8")
                if len(eb) != 1:
                    raise RegexError("non-ASCII in character class")
                lo = eb[0]
            if self.peek() == "-" and self.i + 1 < len(self.p) and self.p[self.i + 1] != "]":
                self.take()
                hc = self.take()
                if hc == "\\":
                    hi_set = self._escape()
                    if len(hi_set) != 1:
                        raise RegexError("bad range bound")
                    (hi,) = hi_set
                else:
                    eb = hc.encode("utf-8")
                    if len(eb) != 1:
                        raise RegexError("non-ASCII in character class")
                    hi = eb[0]
                if hi < lo:
                    raise RegexError("reversed range in class")
                items |= set(range(lo, hi + 1))
            else:
                items.add(lo)
        return frozenset(range(256)) - frozenset(items) if negate else frozenset(items)


# --------------------------------------------------------------------------
# Thompson NFA
# --------------------------------------------------------------------------


class _NFA:
    """States are ints; eps[s] = list of targets; edge[s] = (byteset, tgt)
    (at most one byte-edge per Thompson state)."""

    def __init__(self):
        self.eps: List[List[int]] = []
        self.edge: List[Optional[Tuple[frozenset, int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.edge.append(None)
        return len(self.eps) - 1

    def fragment(self, node) -> Tuple[int, int]:
        kind = node[0]
        if kind == "lit":
            a, b = self.state(), self.state()
            self.edge[a] = (node[1], b)
            return a, b
        if kind == "cat":
            if not node[1]:
                a = self.state()
                return a, a
            start, end = self.fragment(node[1][0])
            for sub in node[1][1:]:
                s2, e2 = self.fragment(sub)
                self.eps[end].append(s2)
                end = e2
            return start, end
        if kind == "alt":
            a, b = self.state(), self.state()
            for sub in node[1]:
                s, e = self.fragment(sub)
                self.eps[a].append(s)
                self.eps[e].append(b)
            return a, b
        if kind == "rep":
            _, sub, lo, hi = node
            if hi is None:
                # sub{lo,} = sub^lo sub*
                a = self.state()
                end = a
                for _ in range(lo):
                    s, e = self.fragment(sub)
                    self.eps[end].append(s)
                    end = e
                s, e = self.fragment(sub)
                loop_in, loop_out = self.state(), self.state()
                self.eps[end].append(loop_in)
                self.eps[loop_in].append(s)
                self.eps[loop_in].append(loop_out)
                self.eps[e].append(loop_in)
                return a, loop_out
            # sub{lo,hi}: lo mandatory copies then (hi-lo) optional
            a = self.state()
            end = a
            for _ in range(lo):
                s, e = self.fragment(sub)
                self.eps[end].append(s)
                end = e
            tail = self.state()
            self.eps[end].append(tail)
            cur = end
            for _ in range(hi - lo):
                s, e = self.fragment(sub)
                self.eps[cur].append(s)
                self.eps[e].append(tail)
                cur = e
            return a, tail
        raise AssertionError(kind)


# --------------------------------------------------------------------------
# DFA (byte alphabet partitioned into equivalence classes)
# --------------------------------------------------------------------------


class CharDFA:
    """Byte-level DFA. State 0 is the absorbing DEAD state; `start` is
    the initial state; `accept[s]` marks fullmatch acceptance.
    `trans` is [n_states, 256] int32 (dense — at most a few hundred KB
    for the grammars served here)."""

    def __init__(self, trans: np.ndarray, accept: np.ndarray, start: int):
        self.trans = trans
        self.accept = accept
        self.start = int(start)

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]

    def fullmatch(self, data) -> bool:
        if isinstance(data, str):
            data = data.encode("utf-8")
        s = self.start
        for b in data:
            s = int(self.trans[s, b])
            if s == 0:
                return False
        return bool(self.accept[s])


def _compile_nfa(nfa: _NFA, start: int, end: int) -> CharDFA:
    # epsilon closures
    n = len(nfa.eps)
    closure: List[Optional[frozenset]] = [None] * n

    def eclose(s: int) -> frozenset:
        if closure[s] is not None:
            return closure[s]
        seen = {s}
        stack = [s]
        while stack:
            cur = stack.pop()
            for t in nfa.eps[cur]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        closure[s] = frozenset(seen)
        return closure[s]

    # partition bytes into equivalence classes over the distinct bytesets
    distinct = list({e[0] for e in nfa.edge if e is not None})
    sigs = np.zeros((256, max(1, len(distinct))), bool)
    for k, bs in enumerate(distinct):
        sigs[list(bs), k] = True
    _, cls_of_byte = np.unique(sigs, axis=0, return_inverse=True)
    n_cls = int(cls_of_byte.max()) + 1
    rep_byte = [int(np.argmax(cls_of_byte == c)) for c in range(n_cls)]

    # subset construction
    start_set = eclose(start)
    sets: Dict[frozenset, int] = {frozenset(): 0, start_set: 1}
    order: List[frozenset] = [frozenset(), start_set]
    trans_rows: List[Optional[List[int]]] = [[0] * n_cls, None]
    work = [start_set]
    while work:
        cur = work.pop()
        row = [0] * n_cls
        for c in range(n_cls):
            b = rep_byte[c]
            tgt: set = set()
            for s in cur:
                e = nfa.edge[s]
                if e is not None and b in e[0]:
                    tgt |= eclose(e[1])
            ft = frozenset(tgt)
            if ft not in sets:
                sets[ft] = len(order)
                order.append(ft)
                trans_rows.append(None)  # placeholder, filled when popped
                work.append(ft)
            row[c] = sets[ft]
        trans_rows[sets[cur]] = row
    # any set still with a placeholder row (unreached pops) -> fill
    for i, r in enumerate(trans_rows):
        if r is None:
            trans_rows[i] = [0] * n_cls

    n_states = len(order)
    trans = np.zeros((n_states, 256), np.int32)
    cls_row = np.asarray(trans_rows, np.int32)  # [n_states, n_cls]
    trans[:, :] = cls_row[:, cls_of_byte]
    accept = np.asarray([end in st for st in order], bool)
    return CharDFA(trans, accept, start=1)


def compile_charset(pattern: str) -> CharDFA:
    """Compile `pattern` (fullmatch semantics) to a byte-level DFA."""
    ast = _Parser(pattern).parse()
    nfa = _NFA()
    s, e = nfa.fragment(ast)
    # single accepting end state
    end = nfa.state()
    nfa.eps[e].append(end)
    return _compile_nfa(nfa, s, end)


# --------------------------------------------------------------------------
# Grammars -> regex
# --------------------------------------------------------------------------

_WS = "[ \\t\\n\\r]*"
_JSON_STRING = '"([^"\\\\\\x00-\\x1f]|\\\\["\\\\/bfnrt]|\\\\u[0-9a-fA-F]{4})*"'
_JSON_NUMBER = "-?(0|[1-9][0-9]*)(\\.[0-9]+)?([eE][+-]?[0-9]+)?"
_JSON_INTEGER = "-?(0|[1-9][0-9]*)"


def _regex_escape(s: str) -> str:
    return "".join("\\" + c if c in _SPECIAL else c for c in s)


def regex_for_choice(choices: Sequence[str]) -> str:
    if not choices:
        raise ValueError("guided_choice needs at least one choice")
    return "(" + "|".join(_regex_escape(c) for c in choices) + ")"


def regex_for_json_value(max_depth: int = 3) -> str:
    """Generic JSON value with containers nested up to `max_depth`
    (bounded-depth JSON is regular; unbounded is not)."""
    scalar = f"({_JSON_STRING}|{_JSON_NUMBER}|true|false|null)"
    value = scalar
    for _ in range(max_depth):
        obj = (f"\\{{{_WS}({_JSON_STRING}{_WS}:{_WS}{value}"
               f"({_WS},{_WS}{_JSON_STRING}{_WS}:{_WS}{value})*)?{_WS}\\}}")
        arr = f"\\[{_WS}({value}({_WS},{_WS}{value})*)?{_WS}\\]"
        value = f"({scalar}|{obj}|{arr})"
    return value


def regex_for_json_object(max_depth: int = 3) -> str:
    """A JSON OBJECT at top level (OpenAI `json_object` mode), values
    nested to `max_depth`."""
    value = regex_for_json_value(max_depth=max_depth)
    return (f"\\{{{_WS}({_JSON_STRING}{_WS}:{_WS}{value}"
            f"({_WS},{_WS}{_JSON_STRING}{_WS}:{_WS}{value})*)?{_WS}\\}}")


def regex_for_json_schema(schema: dict, max_depth: int = 3) -> str:
    """Lower a (non-recursive) JSON-schema subset to a regex, the
    outlines approach: object properties are emitted in declaration
    order, all required. Supported: type object/array/string/number/
    integer/boolean/null, enum, const, string pattern, array
    minItems/maxItems."""
    if not isinstance(schema, dict):
        raise ValueError("schema must be a dict")
    if "enum" in schema:
        import json as _json

        return "(" + "|".join(
            _regex_escape(_json.dumps(v)) for v in schema["enum"]
        ) + ")"
    if "const" in schema:
        import json as _json

        return _regex_escape(_json.dumps(schema["const"]))
    t = schema.get("type")
    if t == "object" or (t is None and "properties" in schema):
        props = schema.get("properties", {})
        if not props:
            return regex_for_json_object(max_depth=max_depth)
        parts = []
        for name, sub in props.items():
            key = _regex_escape('"' + name + '"')
            parts.append(f"{key}{_WS}:{_WS}{regex_for_json_schema(sub, max_depth)}")
        body = f"{_WS},{_WS}".join(parts)
        return f"\\{{{_WS}{body}{_WS}\\}}"
    if t == "array":
        item = (regex_for_json_schema(schema["items"], max_depth)
                if "items" in schema else regex_for_json_value(max_depth))
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        more = f"({_WS},{_WS}{item})"
        if hi is None:
            inner = f"{item}{more}*" if lo >= 1 else f"({item}{more}*)?"
            if lo > 1:
                inner = f"{item}{more}{{{lo - 1},}}"
        else:
            hi = int(hi)
            if lo == 0:
                inner = f"({item}{more}{{0,{hi - 1}}})?" if hi >= 1 else ""
            else:
                inner = f"{item}{more}{{{lo - 1},{hi - 1}}}"
        return f"\\[{_WS}{inner}{_WS}\\]"
    if t == "string":
        if "pattern" in schema:
            return f'"{schema["pattern"]}"'
        return _JSON_STRING
    if t == "number":
        return _JSON_NUMBER
    if t == "integer":
        return _JSON_INTEGER
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t is None:
        return regex_for_json_value(max_depth=max_depth)
    raise ValueError(f"unsupported schema type {t!r}")


# --------------------------------------------------------------------------
# Token-level lifting
# --------------------------------------------------------------------------

# GPT-2 byte<->unicode table (the printable-remap BPE vocabularies use)
def _gpt2_byte_decoder() -> Dict[str, int]:
    bs = (list(range(0x21, 0x7F)) + list(range(0xA1, 0xAD))
          + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


def token_bytes_from_tokenizer(tok) -> List[bytes]:
    """Best-effort byte string for every vocab id: GPT-2 byte-BPE
    pieces are remapped through the byte decoder; sentencepiece pieces
    map the U+2581 marker to a space; special tokens become b'' (never
    maskable). Synthetic test tokenizers can instead pass explicit
    byte lists straight to TokenGuide."""
    size = int(getattr(tok, "vocab_size", 0) or 0)
    try:
        size = max(size, len(tok))
    except TypeError:
        pass
    ids = list(range(size))
    pieces = tok.convert_ids_to_tokens(ids)
    special = set(getattr(tok, "all_special_ids", []) or [])
    dec = _gpt2_byte_decoder()
    out: List[bytes] = []
    for i, p in zip(ids, pieces):
        if i in special or p is None:
            out.append(b"")
            continue
        if all(ch in dec for ch in p):  # byte-BPE piece
            out.append(bytes(dec[ch] for ch in p))
        else:  # sentencepiece-style
            out.append(p.replace("▁", " ").encode("utf-8"))
    return out


class TokenGuide:
    """Token-level view of a CharDFA for one vocabulary.

    `mask_for(state)` -> bool[V] (True = token allowed; the EOS id is
    True iff `state` accepts). `advance(state, token)` -> next state.
    Rows are computed lazily with one vectorised byte walk and
    memoised, so a long-running server pays each visited state once.
    """

    def __init__(self, dfa: CharDFA, token_bytes: Sequence[bytes],
                 eos_id: int, vocab_size: Optional[int] = None):
        self.dfa = dfa
        self.eos_id = int(eos_id)
        V = int(vocab_size) if vocab_size is not None else len(token_bytes)
        if V < len(token_bytes):
            raise ValueError("vocab_size smaller than token table")
        self.V = V
        lens = np.zeros((V,), np.int32)
        L = max((len(b) for b in token_bytes), default=1) or 1
        mat = np.zeros((V, L), np.int32)
        for i, b in enumerate(token_bytes):
            lens[i] = len(b)
            if b:
                mat[i, : len(b)] = np.frombuffer(b, np.uint8)
        self._mat, self._lens = mat, lens
        # zero-length rows (specials, padding ids past the tokenizer)
        # are never allowed as *content*; EOS is handled separately
        self._nonempty = lens > 0
        self._rows: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    @property
    def start(self) -> int:
        return self.dfa.start

    def _row(self, state: int) -> Tuple[np.ndarray, np.ndarray]:
        got = self._rows.get(state)
        if got is not None:
            return got
        cur = np.full((self.V,), state, np.int32)
        for j in range(self._mat.shape[1]):
            step = self.dfa.trans[cur, self._mat[:, j]]
            cur = np.where(j < self._lens, step, cur)
        allow = (cur != 0) & self._nonempty
        self._rows[state] = (allow, cur)
        return self._rows[state]

    def mask_for(self, state: int) -> np.ndarray:
        """bool[V]: tokens allowed from `state` (EOS iff accepting)."""
        allow, _ = self._row(state)
        mask = allow.copy()
        mask[self.eos_id] = bool(self.dfa.accept[state])
        return mask

    def advance(self, state: int, token_id: int) -> int:
        _, nxt = self._row(state)
        return int(nxt[token_id])

    def eos_ok(self, state: int) -> bool:
        return bool(self.dfa.accept[state])

    def dead_end(self, state: int) -> bool:
        """No token allowed and EOS not allowed: the host must finish
        the request (reachable only with vocabularies that cannot
        spell some byte the grammar requires)."""
        allow, _ = self._row(state)
        return not allow.any() and not self.dfa.accept[state]


def compile_regex(pattern: str, token_bytes: Sequence[bytes], eos_id: int,
                  vocab_size: Optional[int] = None) -> TokenGuide:
    """One-call compile: regex -> CharDFA -> TokenGuide."""
    return TokenGuide(compile_charset(pattern), token_bytes, eos_id,
                      vocab_size=vocab_size)
