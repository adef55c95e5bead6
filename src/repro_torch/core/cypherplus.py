"""CypherPlus: Cypher + unstructured-data extensions (paper §III-C).

Supported grammar (the subset the paper's examples exercise, plus CREATE):

  query      := create_q | match_q
  create_q   := (CREATE pattern)+ [';']
  match_q    := MATCH pattern (',' pattern)* [WHERE expr] RETURN items
                [WITH ACCURACY a] [LIMIT n]       (clauses in either order)
  pattern    := node (rel node)*
  node       := '(' [var] [':' Label] [props] ')'
  rel        := '-[' [var] [':' TYPE] ']->' | '<-[' ... ']-' | '-[' ... ']-'
  props      := '{' key ':' literal (',' ...)* '}'
  expr       := or_expr;  and/or/not, comparisons, and the CypherPlus ops:
     a '->' subprop          sub-property extractor    (photo->face)
     x '::' y                similarity (float)
     x '~:' y                is-similar (bool)
     x '!:' y                is-not-similar (bool)
     x '<:' y                x contained in y
     x '>:' y                y contained in x
  literal    := string | number | createFromSource('...') | param
  param      := '$' name          late-bound placeholder (prepare/bind/execute)

Parameters (`$name`) may appear anywhere a literal may (WHERE operands,
node-pattern property values, createFromSource arguments) and after LIMIT.
They are bound at execution time, so one parsed+optimized plan serves every
binding of the same query skeleton.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Optional, Tuple, Union

# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NodePattern:
    var: Optional[str]
    label: Optional[str]
    props: Tuple[Tuple[str, Any], ...] = ()


@dataclasses.dataclass(frozen=True)
class RelPattern:
    var: Optional[str]
    rel_type: Optional[str]
    direction: str  # 'out' | 'in' | 'any'


@dataclasses.dataclass(frozen=True)
class PathPattern:
    nodes: Tuple[NodePattern, ...]
    rels: Tuple[RelPattern, ...]


@dataclasses.dataclass(frozen=True)
class Prop:
    var: str
    key: str


@dataclasses.dataclass(frozen=True)
class SubProp:
    """<expr> -> subkey : the sub-property extractor (semantic information)."""
    base: Any          # Prop or Literal(blob)
    sub_key: str


@dataclasses.dataclass(frozen=True)
class Literal:
    value: Any


@dataclasses.dataclass(frozen=True)
class Param:
    """``$name`` placeholder, resolved from the bind-time parameter map."""
    name: str


@dataclasses.dataclass(frozen=True)
class FuncCall:
    name: str
    args: Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class Compare:
    op: str            # = <> < <= > >= :: ~: !: <: >: CONTAINS
    left: Any
    right: Any


@dataclasses.dataclass(frozen=True)
class BoolOp:
    op: str            # AND OR NOT
    args: Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class ReturnItem:
    expr: Any
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class MatchQuery:
    patterns: Tuple[PathPattern, ...]
    where: Optional[Any]
    returns: Tuple[ReturnItem, ...]
    limit: Optional[Union[int, "Param"]] = None
    # WITH ACCURACY a: semantic predicates may cascade through a calibrated
    # proxy as long as expected accuracy stays >= a.  None and 1.0 both mean
    # "exact only" (the literal is part of the query text, hence of the plan
    # skeleton -- cached plans never leak across targets).
    accuracy: Optional[float] = None
    # PROFILE prefix: execute normally but trace every operator and return
    # the annotated plan + cost-model drift via cursor.profile_report().
    # Part of the frozen query (and of the text skeleton), so profiled and
    # plain runs of the same MATCH never share a plan-cache entry.
    profile: bool = False


@dataclasses.dataclass(frozen=True)
class CreateQuery:
    patterns: Tuple[PathPattern, ...]


Query = Union[MatchQuery, CreateQuery]


def is_semantic(expr: Any) -> bool:
    """Does this expression touch sub-properties / similarity operators?"""
    if isinstance(expr, SubProp):
        return True
    if isinstance(expr, Compare):
        return expr.op in (":", "::", "~:", "!:", "<:", ">:") or \
            is_semantic(expr.left) or is_semantic(expr.right)
    if isinstance(expr, BoolOp):
        return any(is_semantic(a) for a in expr.args)
    if isinstance(expr, FuncCall):
        return any(is_semantic(a) for a in expr.args)
    return False


def expr_vars(expr: Any) -> set:
    if isinstance(expr, Prop):
        return {expr.var}
    if isinstance(expr, SubProp):
        return expr_vars(expr.base)
    if isinstance(expr, Compare):
        return expr_vars(expr.left) | expr_vars(expr.right)
    if isinstance(expr, BoolOp):
        s: set = set()
        for a in expr.args:
            s |= expr_vars(a)
        return s
    if isinstance(expr, FuncCall):
        s = set()
        for a in expr.args:
            s |= expr_vars(a)
        return s
    return set()


def expr_params(expr: Any) -> set:
    """Names of ``$param`` placeholders referenced by an expression."""
    if isinstance(expr, Param):
        return {expr.name}
    if isinstance(expr, SubProp):
        return expr_params(expr.base)
    if isinstance(expr, Compare):
        return expr_params(expr.left) | expr_params(expr.right)
    if isinstance(expr, (BoolOp, FuncCall)):
        s: set = set()
        for a in expr.args:
            s |= expr_params(a)
        return s
    return set()


def query_params(q: Query) -> set:
    """All ``$param`` names a parsed query needs bound before execution."""
    names: set = set()
    for pat in q.patterns:
        for node in pat.nodes:
            for _, v in node.props:
                names |= expr_params(v)
    if isinstance(q, MatchQuery):
        names |= expr_params(q.where) if q.where is not None else set()
        for item in q.returns:
            names |= expr_params(item.expr)
        if isinstance(q.limit, Param):
            names.add(q.limit.name)
    return names


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>//[^\n]*)
  | (?P<arrow_out>-\[)
  | (?P<arrow_in><-\[)
  | (?P<close_out>\]->)
  | (?P<close_in>\]-)
  | (?P<subprop>->)
  | (?P<sim>::)
  | (?P<simq>~:)
  | (?P<nsim>!:)
  | (?P<cin><:)
  | (?P<cout>>:)
  | (?P<le><=) | (?P<ge>>=) | (?P<ne><>)
  | (?P<param>\$[A-Za-z_][A-Za-z0-9_]*)
  | (?P<num>\d+\.\d+|\d+)
  | (?P<str>'[^']*'|"[^"]*")
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<sym>[(){}\[\]:,.=<>;*])
""", re.X)

_KEYWORDS = {"MATCH", "WHERE", "RETURN", "CREATE", "AND", "OR", "NOT",
             "LIMIT", "AS", "CONTAINS", "TRUE", "FALSE", "NULL",
             "WITH", "ACCURACY", "PROFILE"}


@dataclasses.dataclass
class Tok:
    kind: str
    text: str


def tokenize(s: str) -> List[Tok]:
    toks: List[Tok] = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m:
            raise SyntaxError(f"bad token at: {s[pos:pos+24]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        text = m.group()
        if kind == "name" and text.upper() in _KEYWORDS:
            toks.append(Tok("kw", text.upper()))
        else:
            toks.append(Tok(kind, text))
    toks.append(Tok("eof", ""))
    return toks


# ---------------------------------------------------------------------------
# Parser (recursive descent)
# ---------------------------------------------------------------------------


class Parser:
    def __init__(self, toks: List[Tok]):
        self.toks = toks
        self.i = 0

    def peek(self) -> Tok:
        return self.toks[self.i]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind: str, text: Optional[str] = None) -> Tok:
        t = self.next()
        if t.kind != kind or (text is not None and t.text != text):
            raise SyntaxError(f"expected {text or kind}, got {t.kind}:{t.text!r}")
        return t

    def accept(self, kind: str, text: Optional[str] = None) -> Optional[Tok]:
        t = self.peek()
        if t.kind == kind and (text is None or t.text == text):
            return self.next()
        return None

    # -- entry ----------------------------------------------------------------

    def parse(self) -> Query:
        profiled = bool(self.accept("kw", "PROFILE"))
        if self.peek().kind == "kw" and self.peek().text == "CREATE":
            if profiled:
                raise SyntaxError("PROFILE applies to MATCH queries only")
            return self.parse_create()
        q = self.parse_match()
        return dataclasses.replace(q, profile=True) if profiled else q

    def parse_create(self) -> CreateQuery:
        patterns = []
        while self.accept("kw", "CREATE"):
            patterns.append(self.parse_path())
            self.accept("sym", ";")
        return CreateQuery(tuple(patterns))

    def parse_match(self) -> MatchQuery:
        self.expect("kw", "MATCH")
        patterns = [self.parse_path()]
        while self.accept("sym", ","):
            patterns.append(self.parse_path())
        where = None
        if self.accept("kw", "WHERE"):
            where = self.parse_or()
        self.expect("kw", "RETURN")
        items = [self.parse_return_item()]
        while self.accept("sym", ","):
            items.append(self.parse_return_item())
        limit = None
        accuracy = None
        while True:
            if limit is None and self.accept("kw", "LIMIT"):
                p = self.accept("param")
                limit = Param(p.text[1:]) if p else int(self.expect("num").text)
            elif accuracy is None and self.accept("kw", "WITH"):
                # accuracy is a literal, never a $param: the target is baked
                # into the optimized plan (cascade vs direct is a *planning*
                # decision), so late binding would defeat the skeleton key
                self.expect("kw", "ACCURACY")
                accuracy = float(self.expect("num").text)
                if not 0.0 < accuracy <= 1.0:
                    raise SyntaxError(
                        f"ACCURACY must be in (0, 1], got {accuracy}")
            else:
                break
        self.accept("sym", ";")
        return MatchQuery(tuple(patterns), where, tuple(items), limit,
                          accuracy)

    # -- patterns ---------------------------------------------------------------

    def parse_path(self) -> PathPattern:
        nodes = [self.parse_node()]
        rels: List[RelPattern] = []
        while self.peek().kind in ("arrow_out", "arrow_in") or \
                (self.peek().kind == "sym" and self.peek().text == "-"):
            rels.append(self.parse_rel())
            nodes.append(self.parse_node())
        return PathPattern(tuple(nodes), tuple(rels))

    def parse_node(self) -> NodePattern:
        self.expect("sym", "(")
        var = label = None
        t = self.peek()
        if t.kind == "name":
            var = self.next().text
        if self.accept("sym", ":"):
            label = self.expect("name").text
        props: List[Tuple[str, Any]] = []
        if self.accept("sym", "{"):
            while not self.accept("sym", "}"):
                key = self.expect("name").text
                self.expect("sym", ":")
                props.append((key, self.parse_primary()))
                self.accept("sym", ",")
        self.expect("sym", ")")
        return NodePattern(var, label, tuple(props))

    def parse_rel(self) -> RelPattern:
        t = self.next()
        if t.kind == "arrow_in":                   # <-[ ... ]-
            var, rtype = self._rel_body()
            self.expect("close_in")
            return RelPattern(var, rtype, "in")
        if t.kind == "arrow_out":                  # -[ ... ]-> or -[ ... ]-
            var, rtype = self._rel_body()
            t2 = self.next()
            if t2.kind == "close_out":
                return RelPattern(var, rtype, "out")
            if t2.kind == "close_in":
                return RelPattern(var, rtype, "any")
            raise SyntaxError(f"bad relationship close: {t2.text!r}")
        raise SyntaxError(f"bad relationship start: {t.text!r}")

    def _rel_body(self) -> Tuple[Optional[str], Optional[str]]:
        var = rtype = None
        if self.peek().kind == "name":
            var = self.next().text
        if self.accept("sym", ":"):
            rtype = self.expect("name").text
        return var, rtype

    # -- expressions --------------------------------------------------------------

    def parse_or(self) -> Any:
        left = self.parse_and()
        while self.accept("kw", "OR"):
            right = self.parse_and()
            left = BoolOp("OR", (left, right))
        return left

    def parse_and(self) -> Any:
        left = self.parse_not()
        while self.accept("kw", "AND"):
            right = self.parse_not()
            left = BoolOp("AND", (left, right))
        return left

    def parse_not(self) -> Any:
        if self.accept("kw", "NOT"):
            return BoolOp("NOT", (self.parse_not(),))
        return self.parse_comparison()

    _CMP = {"=": "=", "<": "<", ">": ">", "le": "<=", "ge": ">=", "ne": "<>",
            "sim": "::", "simq": "~:", "nsim": "!:", "cin": "<:", "cout": ">:"}

    def parse_comparison(self) -> Any:
        """Left-associative comparison chain, so `x :: y > 0.7` parses as
        `(x :: y) > 0.7` (similarity value against a threshold)."""
        left = self.parse_value()
        while True:
            t = self.peek()
            op = None
            if t.kind == "sym" and t.text in ("=", "<", ">"):
                op = self.next().text
            elif t.kind in ("le", "ge", "ne", "sim", "simq", "nsim",
                            "cin", "cout"):
                op = self._CMP[self.next().kind]
            elif t.kind == "kw" and t.text == "CONTAINS":
                self.next()
                op = "CONTAINS"
            if op is None:
                return left
            right = self.parse_value()
            left = Compare(op, left, right)

    def parse_value(self) -> Any:
        """primary (-> subkey)*; `::` chains live one level up."""
        e = self.parse_primary()
        while self.accept("subprop"):
            sub = self.expect("name").text
            e = SubProp(e, sub)
        return e

    def parse_primary(self) -> Any:
        t = self.next()
        if t.kind == "num":
            return Literal(float(t.text) if "." in t.text else int(t.text))
        if t.kind == "str":
            return Literal(t.text[1:-1])
        if t.kind == "kw" and t.text in ("TRUE", "FALSE"):
            return Literal(t.text == "TRUE")
        if t.kind == "kw" and t.text == "NULL":
            return Literal(None)
        if t.kind == "param":
            return Param(t.text[1:])
        if t.kind == "name":
            # function call?
            if self.peek().kind == "sym" and self.peek().text == "(":
                self.next()
                args = []
                while not self.accept("sym", ")"):
                    args.append(self.parse_value())
                    self.accept("sym", ",")
                return FuncCall(t.text, tuple(args))
            # var.prop ?
            if self.accept("sym", "."):
                key = self.expect("name").text
                return Prop(t.text, key)
            return Prop(t.text, "__self__")
        if t.kind == "sym" and t.text == "(":
            e = self.parse_or()
            self.expect("sym", ")")
            return e
        raise SyntaxError(f"unexpected token {t.kind}:{t.text!r}")

    def parse_return_item(self) -> ReturnItem:
        e = self.parse_value()
        alias = None
        if self.accept("kw", "AS"):
            alias = self.expect("name").text
        return ReturnItem(e, alias)


def parse_query(text: str) -> Query:
    return Parser(tokenize(text)).parse()
