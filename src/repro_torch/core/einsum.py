"""Tensor index notation parser (paper §2.1, Custard input API #1).

Grammar::

    assignment := access '=' expr
    expr       := term (('+'|'-') term)*
    term       := factor ('*' factor)*
    factor     := access | '(' expr ')'
    access     := NAME ['(' var (',' var)* ')']     # no parens => scalar

Expressions are normalized to sum-of-products (signs distributed), the form
Custard lowers term by term. Reduction variables are implicit: any index
variable absent from the LHS is summed within its term (Einstein summation).
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class Access:
    tensor: str
    vars: Tuple[str, ...]

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.tensor}({','.join(self.vars)})" if self.vars else self.tensor


@dataclasses.dataclass(frozen=True)
class Term:
    """One product term with a sign."""

    sign: int                      # +1 / -1
    factors: Tuple[Access, ...]

    @property
    def vars(self) -> Tuple[str, ...]:
        seen: List[str] = []
        for f in self.factors:
            for v in f.vars:
                if v not in seen:
                    seen.append(v)
        return tuple(seen)


@dataclasses.dataclass(frozen=True)
class Assignment:
    lhs: Access
    terms: Tuple[Term, ...]

    @property
    def result_vars(self) -> Tuple[str, ...]:
        return self.lhs.vars

    @property
    def all_vars(self) -> Tuple[str, ...]:
        seen = list(self.lhs.vars)
        for t in self.terms:
            for v in t.vars:
                if v not in seen:
                    seen.append(v)
        return tuple(seen)

    def reduction_vars(self, term: Term) -> Tuple[str, ...]:
        return tuple(v for v in term.vars if v not in self.lhs.vars)

    @property
    def input_tensors(self) -> Tuple[str, ...]:
        seen: List[str] = []
        for t in self.terms:
            for f in t.factors:
                if f.tensor not in seen:
                    seen.append(f.tensor)
        return tuple(seen)


_TOKEN = re.compile(r"\s*([A-Za-z_][A-Za-z_0-9]*|[(),*+=-])")


class _Parser:
    def __init__(self, text: str):
        self.toks: List[str] = []
        pos = 0
        while pos < len(text):
            m = _TOKEN.match(text, pos)
            if not m:
                if text[pos:].strip():
                    raise SyntaxError(f"bad token at: {text[pos:]!r}")
                break
            self.toks.append(m.group(1))
            pos = m.end()
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def eat(self, expect=None):
        t = self.peek()
        if t is None or (expect is not None and t != expect):
            raise SyntaxError(f"expected {expect!r}, got {t!r}")
        self.i += 1
        return t

    def access(self) -> Access:
        name = self.eat()
        if not re.match(r"[A-Za-z_]", name):
            raise SyntaxError(f"expected tensor name, got {name!r}")
        if self.peek() == "(":
            self.eat("(")
            vs = [self.eat()]
            while self.peek() == ",":
                self.eat(",")
                vs.append(self.eat())
            self.eat(")")
            return Access(name, tuple(vs))
        return Access(name, ())

    # expr -> list of (sign, [factor-lists]) in SOP form
    def factor(self) -> List[Tuple[int, List[Access]]]:
        if self.peek() == "(":
            self.eat("(")
            e = self.expr()
            self.eat(")")
            return e
        return [(1, [self.access()])]

    def term(self) -> List[Tuple[int, List[Access]]]:
        acc = self.factor()
        while self.peek() == "*":
            self.eat("*")
            rhs = self.factor()
            acc = [(s1 * s2, f1 + f2) for s1, f1 in acc for s2, f2 in rhs]
        return acc

    def expr(self) -> List[Tuple[int, List[Access]]]:
        sign = 1
        if self.peek() in ("+", "-"):
            sign = -1 if self.eat() == "-" else 1
        acc = [(sign * s, f) for s, f in self.term()]
        while self.peek() in ("+", "-"):
            op = self.eat()
            s2 = -1 if op == "-" else 1
            acc += [(s2 * s, f) for s, f in self.term()]
        return acc


def parse(text: str) -> Assignment:
    p = _Parser(text)
    lhs = p.access()
    p.eat("=")
    sop = p.expr()
    if p.peek() is not None:
        raise SyntaxError(f"trailing tokens: {p.toks[p.i:]}")
    terms = tuple(Term(sign=s, factors=tuple(fs)) for s, fs in sop)
    return Assignment(lhs=lhs, terms=terms)
