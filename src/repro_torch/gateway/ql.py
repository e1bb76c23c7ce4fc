"""The declarative statistical query language.

The port of ``repro.gateway.ql``, copied as it is (pure Python).

InferSpark frames a fitted model as something you *query* — this module
gives that a concrete surface.  One statement per statistical question,
compiled (``plan.py``) onto the artifact-direct queries and fold-in
scoring the serving layer already implements:

.. code-block:: sql

    TOPICS OF phi TOP 5;
    SIMILARITY BETWEEN phi[0] AND phi[2] USING hellinger;
    SIMILARITY OF phi USING cosine;
    CREDIBLE INTERVAL 0.9 FOR theta[3];
    PREDICT LL FOR DOCS $batch USING ARTIFACT 'lda-v7';
    EXPLAIN PREDICT LL FOR DOCS $batch;
    SHOW ARTIFACTS;
    SHOW STATS;

Keywords are case-insensitive; RV names, metrics and payload names keep
their case.  Every query takes an optional trailing ``USING ARTIFACT
'<id>'`` to pick the serving artifact explicitly (otherwise the gateway's
default routes it).  ``$name`` references a key of the ``params`` dict
passed alongside the script — document payloads never appear inline in
query text.

The parser is a plain tokenizer + recursive descent, ~no lookahead; bad
input raises :class:`QLSyntaxError` carrying the offset and a caret
rendering of the line, like a database would print.
"""

from __future__ import annotations

import re

from .plan import (CredibleQuery, ExplainQuery, PredictQuery, ShowQuery,
                   SimilarityQuery, TopicsQuery)

__all__ = ["parse", "parse_script", "QLSyntaxError"]


class QLSyntaxError(ValueError):
    """Bad query text; ``str()`` shows the offending position with a caret."""

    def __init__(self, text: str, pos: int, message: str):
        self.text, self.pos, self.message = text, pos, message
        line_start = text.rfind("\n", 0, pos) + 1
        line_end = text.find("\n", pos)
        line = text[line_start:line_end if line_end >= 0 else len(text)]
        caret = " " * (pos - line_start) + "^"
        super().__init__(f"{message}\n  {line}\n  {caret}")


_TOKEN = re.compile(r"""
    (?P<ws>\s+)
  | (?P<number>\d+\.\d+|\.\d+|\d+)
  | (?P<string>'[^']*'|"[^"]*")
  | (?P<param>\$[A-Za-z_][A-Za-z0-9_]*)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<punct>[\[\];,])
""", re.VERBOSE)

_KEYWORDS = {"TOPICS", "OF", "TOP", "SIMILARITY", "BETWEEN", "AND", "USING",
             "CREDIBLE", "INTERVAL", "FOR", "PREDICT", "LL", "DOCS",
             "ARTIFACT", "EXPLAIN", "SHOW", "ARTIFACTS", "STATS"}


def _tokenize(text: str):
    """-> list of (kind, value, pos); kind in {kw, ident, number, string,
    param, punct, eof}."""
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise QLSyntaxError(text, pos,
                                f"unexpected character {text[pos]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        val = m.group()
        if kind == "ident" and val.upper() in _KEYWORDS:
            out.append(("kw", val.upper(), m.start()))
        elif kind == "string":
            out.append(("string", val[1:-1], m.start()))
        elif kind == "param":
            out.append(("param", val[1:], m.start()))
        else:
            out.append((kind, val, m.start()))
    out.append(("eof", "", len(text)))
    return out


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.toks = _tokenize(text)
        self.i = 0

    # -- token plumbing ----------------------------------------------------

    def peek(self):
        return self.toks[self.i]

    def next(self):
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def fail(self, message: str):
        raise QLSyntaxError(self.text, self.peek()[2], message)

    def at_kw(self, *words) -> bool:
        kind, val, _ = self.peek()
        return kind == "kw" and val in words

    def expect_kw(self, word: str):
        if not self.at_kw(word):
            kind, val, _ = self.peek()
            got = val or "end of input"
            self.fail(f"expected {word}, got {got!r}")
        return self.next()

    def expect(self, kind: str, what: str):
        if self.peek()[0] != kind:
            got = self.peek()[1] or "end of input"
            self.fail(f"expected {what}, got {got!r}")
        return self.next()[1]

    def expect_int(self, what: str) -> int:
        raw = self.expect("number", what)
        if "." in raw:
            self.fail(f"expected integer {what}, got {raw!r}")
        return int(raw)

    # -- grammar -----------------------------------------------------------

    def statement(self):
        if self.at_kw("EXPLAIN"):
            self.next()
            inner = self.statement()
            if inner.kind in ("explain", "show"):
                self.fail(f"cannot EXPLAIN a {inner.kind.upper()} statement")
            return ExplainQuery(inner=inner)
        if self.at_kw("TOPICS"):
            return self.topics()
        if self.at_kw("SIMILARITY"):
            return self.similarity()
        if self.at_kw("CREDIBLE"):
            return self.credible()
        if self.at_kw("PREDICT"):
            return self.predict()
        if self.at_kw("SHOW"):
            return self.show()
        got = self.peek()[1] or "end of input"
        self.fail(f"expected a query (TOPICS / SIMILARITY / CREDIBLE / "
                  f"PREDICT / EXPLAIN / SHOW), got {got!r}")

    def topics(self):
        self.expect_kw("TOPICS")
        self.expect_kw("OF")
        rv = self.expect("ident", "a random-variable name")
        k = 10
        if self.at_kw("TOP"):
            self.next()
            k = self.expect_int("TOP count")
            if k < 1:
                self.fail("TOP count must be >= 1")
        return TopicsQuery(rv=rv, k=k, artifact=self.artifact_clause())

    def similarity(self):
        self.expect_kw("SIMILARITY")
        if self.at_kw("BETWEEN"):
            self.next()
            rv, i = self.indexed_rv()
            self.expect_kw("AND")
            rv2, j = self.indexed_rv()
            if rv2 != rv:
                self.fail(f"SIMILARITY BETWEEN compares rows of one table; "
                          f"got {rv!r} and {rv2!r}")
            pair = (i, j)
        else:
            self.expect_kw("OF")
            rv = self.expect("ident", "a random-variable name")
            pair = None
        metric = "hellinger"
        if self.at_kw("USING") and self.toks[self.i + 1][:2] != \
                ("kw", "ARTIFACT"):
            self.next()
            metric = self.expect("ident", "a similarity metric "
                                 "(hellinger / cosine)")
        return SimilarityQuery(rv=rv, metric=metric, pair=pair,
                               artifact=self.artifact_clause())

    def credible(self):
        self.expect_kw("CREDIBLE")
        self.expect_kw("INTERVAL")
        prob = float(self.expect("number", "an interval probability"))
        if not 0.0 < prob < 1.0:
            self.fail(f"interval probability must be in (0, 1), got {prob}")
        self.expect_kw("FOR")
        rv = self.expect("ident", "a random-variable name")
        row = None
        if self.peek()[:2] == ("punct", "["):
            _, row = self.indexed_suffix(rv)
        return CredibleQuery(rv=rv, prob=prob, row=row,
                             artifact=self.artifact_clause())

    def predict(self):
        self.expect_kw("PREDICT")
        self.expect_kw("LL")
        self.expect_kw("FOR")
        self.expect_kw("DOCS")
        payload = self.expect("param", "a $payload reference")
        return PredictQuery(payload=payload,
                            artifact=self.artifact_clause())

    def show(self):
        self.expect_kw("SHOW")
        if self.at_kw("ARTIFACTS"):
            self.next()
            return ShowQuery(what="artifacts")
        if self.at_kw("STATS"):
            self.next()
            return ShowQuery(what="stats")
        got = self.peek()[1] or "end of input"
        self.fail(f"expected ARTIFACTS or STATS after SHOW, got {got!r}")

    def indexed_rv(self):
        rv = self.expect("ident", "a random-variable name")
        _, row = self.indexed_suffix(rv)
        return rv, row

    def indexed_suffix(self, rv):
        if self.peek()[:2] != ("punct", "["):
            self.fail(f"expected [row] after {rv!r}")
        self.next()
        row = self.expect_int("row index")
        if self.peek()[:2] != ("punct", "]"):
            self.fail("expected closing ]")
        self.next()
        return rv, row

    def artifact_clause(self):
        if self.at_kw("USING"):
            self.next()
            self.expect_kw("ARTIFACT")
            return self.expect("string", "a quoted artifact id")
        return None


def parse(text: str):
    """Parse exactly one statement (optional trailing ``;``) to its plan."""
    p = _Parser(text)
    stmt = p.statement()
    if p.peek()[:2] == ("punct", ";"):
        p.next()
    if p.peek()[0] != "eof":
        p.fail(f"unexpected trailing input {p.peek()[1]!r}")
    return stmt


def parse_script(text: str) -> list:
    """Parse a ``;``-separated script to a list of plans (comments: ``--``
    to end of line, like SQL)."""
    text = re.sub(r"--[^\n]*", "", text)
    p = _Parser(text)
    out = []
    while p.peek()[0] != "eof":
        out.append(p.statement())
        if p.peek()[:2] == ("punct", ";"):
            p.next()
        elif p.peek()[0] != "eof":
            p.fail(f"expected ; between statements, "
                   f"got {p.peek()[1]!r}")
    return out
