"""Datalog-like query language (paper Section 3.1, Table 2).

Grammar (recursive descent; the paper's surface syntax):

    rule      := head star? ":-" body (";" aggdef)? "."
    head      := NAME "(" keyvars (";" annvar ":" type)? ")"
    star      := "*" ("[" ("i"|"c") "=" NUMBER "]")?
    body      := atom ("," atom)*
    atom      := NAME "(" term ("," term)* ")"
    term      := VAR | NUMBER | STRING
    aggdef    := VAR "=" expr          # expr may contain <<AGG(arg)>>
    expr      := arithmetic over numbers, scalar-relation names, and one
                 "<<OP(arg)>>" aggregation placeholder

Examples accepted verbatim from Table 2: Triangle, 4-Clique, Lollipop,
Barbell, CountTriangle, PageRank (3 rules), SSSP (2 rules).
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple, Union


# --------------------------------------------------------------------- AST
@dataclasses.dataclass(frozen=True)
class Var:
    name: str

    def __repr__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class Const:
    value: Union[int, str, float, "Param"]

    def __repr__(self):
        return repr(self.value)


@dataclasses.dataclass(frozen=True)
class Param:
    """A bind-parameter slot standing in for a selection constant.

    ``Engine.prepare`` rewrites every body ``Const(v)`` to
    ``Const(Param(slot))`` (one slot per distinct constant value, in
    first-appearance order), so the rule's ``repr`` — and with it every
    compile/plan/trace cache key — is stable across bindings. The actual
    value is supplied at run time through the binding-aware ``encode``
    closure; it never reaches a compile key.

    ``repr`` is eval-able on purpose: parameterized selections survive
    the codegen round-trip (`emit_source` embeds ``encode({v!r})``).
    """

    slot: int

    def __repr__(self):
        return f"Param({self.slot})"


@dataclasses.dataclass(frozen=True)
class Atom:
    rel: str
    terms: Tuple[Union[Var, Const], ...]

    @property
    def vars(self) -> Tuple[str, ...]:
        return tuple(t.name for t in self.terms if isinstance(t, Var))

    def __repr__(self):
        return f"{self.rel}({','.join(map(repr, self.terms))})"


# Expression nodes for the aggregation definition -------------------------
@dataclasses.dataclass(frozen=True)
class Num:
    value: float


@dataclasses.dataclass(frozen=True)
class ScalarRef:
    """Reference to a scalar (arity-0, annotated) relation, e.g. 1/N."""
    name: str


@dataclasses.dataclass(frozen=True)
class AggRef:
    """The <<OP(arg)>> placeholder."""
    op: str     # count|sum|min|max
    arg: str    # variable name or "*"


@dataclasses.dataclass(frozen=True)
class BinOp:
    op: str  # + - * /
    lhs: "Expr"
    rhs: "Expr"


Expr = Union[Num, ScalarRef, AggRef, BinOp]


def expr_agg(e: Optional[Expr]) -> Optional[AggRef]:
    """Find the (single) aggregation placeholder in an expression."""
    if e is None or isinstance(e, (Num, ScalarRef)):
        return None
    if isinstance(e, AggRef):
        return e
    l, r = expr_agg(e.lhs), expr_agg(e.rhs)
    assert not (l and r), "at most one aggregation per rule"
    return l or r


def eval_expr(e: Expr, agg_value, scalars: dict):
    """Evaluate with the aggregation placeholder bound to ``agg_value``
    (a scalar or vector); scalar relation names resolved via ``scalars``."""
    if isinstance(e, Num):
        return e.value
    if isinstance(e, ScalarRef):
        if e.name not in scalars:
            raise KeyError(f"scalar relation {e.name} not materialized")
        return scalars[e.name]
    if isinstance(e, AggRef):
        assert agg_value is not None, "aggregation placeholder with no value"
        return agg_value
    l = eval_expr(e.lhs, agg_value, scalars)
    r = eval_expr(e.rhs, agg_value, scalars)
    return {"+": lambda: l + r, "-": lambda: l - r,
            "*": lambda: l * r, "/": lambda: l / r}[e.op]()


@dataclasses.dataclass(frozen=True)
class Head:
    rel: str
    keyvars: Tuple[str, ...]
    ann_var: Optional[str] = None
    ann_type: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Recursion:
    kind: str                 # "iterations" | "tolerance" | "fixpoint"
    value: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Rule:
    head: Head
    body: Tuple[Atom, ...]
    agg_expr: Optional[Expr] = None
    recursion: Optional[Recursion] = None

    @property
    def agg(self) -> Optional[AggRef]:
        return expr_agg(self.agg_expr)

    @property
    def body_vars(self) -> Tuple[str, ...]:
        seen, out = set(), []
        for a in self.body:
            for v in a.vars:
                if v not in seen:
                    seen.add(v)
                    out.append(v)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class Program:
    rules: Tuple[Rule, ...]


# ---------------------------------------------------------------- tokenizer
_TOKEN_RE = re.compile(r"""
      (?P<WS>\s+)
    | (?P<LAGG><<)
    | (?P<RAGG>>>)
    | (?P<IMPL>:-)
    | (?P<NAME>\d*[A-Za-z_][A-Za-z0-9_']*)
    | (?P<NUM>\d+\.\d+|\.\d+|\d+)
    | (?P<STR>"[^"]*")
    | (?P<PUNCT>[(),;.*\[\]=+\-/:])
""", re.VERBOSE)


def tokenize(text: str) -> List[Tuple[str, str]]:
    toks, i = [], 0
    while i < len(text):
        m = _TOKEN_RE.match(text, i)
        if not m:
            raise SyntaxError(f"bad character at {text[i:i+20]!r}")
        i = m.end()
        kind = m.lastgroup
        if kind == "WS":
            continue
        toks.append((kind, m.group()))
    toks.append(("EOF", ""))
    return toks


class Parser:
    def __init__(self, text: str):
        self.toks = tokenize(text)
        self.i = 0

    # -- primitives
    def peek(self, k=0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val=None, kind=None):
        k, v = self.next()
        if val is not None and v != val:
            raise SyntaxError(f"expected {val!r}, got {v!r}")
        if kind is not None and k != kind:
            raise SyntaxError(f"expected {kind}, got {k}:{v!r}")
        return v

    def accept(self, val) -> bool:
        if self.peek()[1] == val:
            self.i += 1
            return True
        return False

    # -- grammar
    def parse_program(self) -> Program:
        rules = []
        while self.peek()[0] != "EOF":
            rules.append(self.parse_rule())
        return Program(tuple(rules))

    def parse_rule(self) -> Rule:
        head = self.parse_head()
        recursion = None
        if self.accept("*"):
            if self.accept("["):
                key = self.expect(kind="NAME")
                self.expect("=")
                num = float(self.expect(kind="NUM"))
                self.expect("]")
                recursion = Recursion("iterations" if key == "i" else "tolerance",
                                      num)
            else:
                recursion = Recursion("fixpoint")
        self.expect(":-")
        body = [self.parse_atom()]
        while self.accept(","):
            body.append(self.parse_atom())
        agg_expr = None
        if self.accept(";"):
            # "y = expr"
            self.expect(kind="NAME")
            self.expect("=")
            agg_expr = self.parse_expr()
        self.expect(".")
        return Rule(head, tuple(body), agg_expr, recursion)

    def parse_head(self) -> Head:
        name = self.expect(kind="NAME")
        self.expect("(")
        keyvars: List[str] = []
        ann_var = ann_type = None
        if not self.accept(")"):
            # keyvars until ';' or ')'
            while self.peek()[1] not in (";", ")"):
                keyvars.append(self.expect(kind="NAME"))
                if not self.accept(","):
                    break
            if self.accept(";"):
                ann_var = self.expect(kind="NAME")
                self.expect(":")
                ann_type = self.expect(kind="NAME")
            self.expect(")")
        return Head(name, tuple(keyvars), ann_var, ann_type)

    def parse_atom(self) -> Atom:
        name = self.expect(kind="NAME")
        self.expect("(")
        terms: List[Union[Var, Const]] = []
        if not self.accept(")"):
            while True:
                k, v = self.next()
                if k == "NAME":
                    terms.append(Var(v))
                elif k == "NUM":
                    terms.append(Const(int(float(v)) if "." not in v else float(v)))
                elif k == "STR":
                    terms.append(Const(v.strip('"')))
                else:
                    raise SyntaxError(f"bad term {v!r}")
                if not self.accept(","):
                    break
            self.expect(")")
        return Atom(name, tuple(terms))

    # expression grammar: term (("+"|"-") term)*; term: factor (("*"|"/") factor)*
    def parse_expr(self) -> Expr:
        e = self.parse_term()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            e = BinOp(op, e, self.parse_term())
        return e

    def parse_term(self) -> Expr:
        e = self.parse_factor()
        while self.peek()[1] in ("*", "/"):
            op = self.next()[1]
            e = BinOp(op, e, self.parse_factor())
        return e

    def parse_factor(self) -> Expr:
        k, v = self.peek()
        if k == "NUM":
            self.next()
            return Num(float(v))
        if k == "LAGG":
            self.next()
            op = self.expect(kind="NAME").lower()
            self.expect("(")
            arg = self.next()[1]  # var name or '*'
            self.expect(")")
            self.expect(kind="RAGG")
            return AggRef(op, arg)
        if k == "NAME":
            self.next()
            return ScalarRef(v)
        if v == "(":
            self.next()
            e = self.parse_expr()
            self.expect(")")
            return e
        raise SyntaxError(f"bad expression factor {v!r}")


def parse(text: str) -> Program:
    return Parser(text).parse_program()


def parse_rule(text: str) -> Rule:
    prog = parse(text)
    assert len(prog.rules) == 1
    return prog.rules[0]
