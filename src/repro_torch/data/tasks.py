"""Synthetic *verifiable* task suites mirroring the paper's four domains.

Every task carries a ground truth and a programmatic verifier, so
feedback mechanisms are REAL (the SQL executor actually runs queries;
the math verifier actually checks the value) even though the text is
synthetic.  Used by the end-to-end examples and the feedback tests.
"""
from __future__ import annotations

import random
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Math (Math500 analogue): arithmetic expressions with exact verification
# ---------------------------------------------------------------------------

@dataclass
class MathTask:
    problem: str
    answer: int
    domain: str = "math500"

    def prompt(self) -> str:
        return (f"What is the answer to the following math problem: "
                f"{self.problem}. State your final answer in "
                f"<answer></answer> tags.")

    def verify(self, response: str) -> bool:
        m = re.findall(r"<answer>\s*(-?\d+)\s*</answer>", response)
        return bool(m) and int(m[-1]) == self.answer


def make_math_tasks(n: int, seed: int = 0) -> List[MathTask]:
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        a, b, c = (rng.randint(2, 99) for _ in range(3))
        op1, op2 = rng.choice(["+", "-", "*"]), rng.choice(["+", "-"])
        expr = f"({a} {op1} {b}) {op2} {c}"
        out.append(MathTask(expr, eval(expr)))  # noqa: S307 - our own ints
    return out


# ---------------------------------------------------------------------------
# Mini-SQL (Spider analogue) with a REAL executor
# ---------------------------------------------------------------------------

Table = Dict[str, List[Any]]


def run_sql(query: str, tables: Dict[str, Table]) -> List[Tuple]:
    """Execute a tiny SQL subset:
    SELECT <cols|COUNT(*)> FROM <t> [WHERE <col> <=|>|<|!=> <val>]
    [ORDER BY <col> [DESC]] [LIMIT n]
    Raises ValueError on anything it cannot parse (= execution feedback).
    """
    q = query.strip().rstrip(";")
    m = re.match(
        r"(?is)^SELECT\s+(.*?)\s+FROM\s+(\w+)"
        r"(?:\s+WHERE\s+(\w+)\s*(=|!=|>=|<=|>|<)\s*('[^']*'|-?\d+(?:\.\d+)?))?"
        r"(?:\s+ORDER\s+BY\s+(\w+)(\s+DESC)?)?"
        r"(?:\s+LIMIT\s+(\d+))?$", q)
    if not m:
        raise ValueError(f"cannot parse query: {query!r}")
    cols_s, tname, wcol, wop, wval, ocol, odesc, limit = m.groups()
    if tname not in tables:
        raise ValueError(f"no such table: {tname}")
    t = tables[tname]
    ncols = list(t.keys())
    nrows = len(next(iter(t.values()))) if t else 0
    rows = [tuple(t[c][i] for c in ncols) for i in range(nrows)]

    if wcol is not None:
        if wcol not in ncols:
            raise ValueError(f"no such column: {wcol}")
        val: Any = wval[1:-1] if wval.startswith("'") else (
            float(wval) if "." in wval else int(wval))
        ci = ncols.index(wcol)
        ops = {"=": lambda a, b: a == b, "!=": lambda a, b: a != b,
               ">": lambda a, b: a > b, "<": lambda a, b: a < b,
               ">=": lambda a, b: a >= b, "<=": lambda a, b: a <= b}
        rows = [r for r in rows if ops[wop](r[ci], val)]

    if ocol is not None:
        if ocol not in ncols:
            raise ValueError(f"no such column: {ocol}")
        rows.sort(key=lambda r: r[ncols.index(ocol)], reverse=bool(odesc))

    sel = cols_s.strip()
    if re.match(r"(?i)^COUNT\(\*\)$", sel):
        rows = [(len(rows),)]
    elif sel != "*":
        want = [c.strip() for c in sel.split(",")]
        for c in want:
            if c not in ncols:
                raise ValueError(f"no such column: {c}")
        idx = [ncols.index(c) for c in want]
        rows = [tuple(r[i] for i in idx) for r in rows]
    if limit is not None:
        rows = rows[:int(limit)]
    return rows


@dataclass
class SqlTask:
    question: str
    gold_query: str
    tables: Dict[str, Table]
    domain: str = "spider"

    def prompt(self) -> str:
        schema = "; ".join(f"{t}({', '.join(cols)})"
                           for t, cols in ((n, list(tb.keys()))
                                           for n, tb in self.tables.items()))
        return (f"You are a sqlite expert. Schema: {schema}. Generate a "
                f"query for: {self.question}. Output SQL in <SQL></SQL> tags.")

    def extract(self, response: str) -> Optional[str]:
        m = re.findall(r"(?is)<SQL>(.*?)</SQL>", response)
        return m[-1].strip() if m else None

    def verify(self, response: str) -> bool:
        q = self.extract(response)
        if q is None:
            return False
        try:
            got = run_sql(q, self.tables)
        except ValueError:
            return False
        gold = run_sql(self.gold_query, self.tables)
        return sorted(map(str, got)) == sorted(map(str, gold))


def make_sql_tasks(n: int, seed: int = 0) -> List[SqlTask]:
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        rows = rng.randint(4, 9)
        tables = {"orchestra": {
            "id": list(range(rows)),
            "year": [rng.randint(1900, 2020) for _ in range(rows)],
            "size": [rng.randint(10, 120) for _ in range(rows)],
        }}
        kind = rng.randrange(3)
        if kind == 0:
            y = rng.randint(1950, 2000)
            out.append(SqlTask(f"How many orchestras were founded after {y}?",
                               f"SELECT COUNT(*) FROM orchestra WHERE year > {y}",
                               tables))
        elif kind == 1:
            out.append(SqlTask("List orchestra ids ordered by size descending.",
                               "SELECT id FROM orchestra ORDER BY size DESC",
                               tables))
        else:
            s = rng.randint(20, 100)
            out.append(SqlTask(f"Which orchestra ids have size at least {s}?",
                               f"SELECT id FROM orchestra WHERE size >= {s}",
                               tables))
    return out


# ---------------------------------------------------------------------------
# Sentiment (IMDB analogue)
# ---------------------------------------------------------------------------

POS = ["a triumph", "beautifully shot", "masterful pacing", "I loved it",
       "an instant classic", "the cast shines"]
NEG = ["a mess", "painfully slow", "wooden acting", "I want my time back",
       "utterly forgettable", "the plot collapses"]


@dataclass
class SentimentTask:
    review: str
    label: str                      # "positive" | "negative"
    domain: str = "imdb"

    def prompt(self) -> str:
        return (f"Classify the review sentiment as positive or negative in "
                f"<sentiment></sentiment> tags. Review: {self.review}")

    def verify(self, response: str) -> bool:
        m = re.findall(r"(?is)<sentiment>\s*(\w+)\s*</sentiment>", response)
        return bool(m) and m[-1].lower() == self.label


def make_sentiment_tasks(n: int, seed: int = 0) -> List[SentimentTask]:
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        pos = rng.random() < 0.5
        bits = rng.sample(POS if pos else NEG, 3)
        review = "This film is " + ", ".join(bits) + "."
        out.append(SentimentTask(review, "positive" if pos else "negative"))
    return out


# ---------------------------------------------------------------------------
# Translation (Flores analogue): deterministic cipher language
# ---------------------------------------------------------------------------

CIPHER = {"the": "za", "cat": "miro", "dog": "worf", "sat": "dun",
          "ran": "vel", "on": "po", "under": "subo", "mat": "tal",
          "tree": "arbo", "happy": "joy", "small": "mik", "big": "gran",
          "a": "un", "and": "et", "house": "domu", "bird": "avi"}


@dataclass
class TranslationTask:
    source: str
    reference: str
    domain: str = "flores"

    def prompt(self) -> str:
        return (f"Translate into Zorlang. Output only the translation in "
                f"<translation></translation> tags. Text: {self.source}")

    def score(self, response: str) -> float:
        from repro_torch.core.textmetrics import meteor_lite
        m = re.findall(r"(?is)<translation>(.*?)</translation>", response)
        if not m:
            return 0.0
        return meteor_lite(m[-1].strip(), self.reference)

    def verify(self, response: str) -> bool:
        return self.score(response) > 0.8


def make_translation_tasks(n: int, seed: int = 0) -> List[TranslationTask]:
    rng = random.Random(seed)
    words = list(CIPHER.keys())
    out = []
    for _ in range(n):
        sent = " ".join(rng.choice(words) for _ in range(rng.randint(4, 8)))
        ref = " ".join(CIPHER[w] for w in sent.split())
        out.append(TranslationTask(sent, ref))
    return out


def make_tasks(domain: str, n: int, seed: int = 0):
    return {"math500": make_math_tasks, "spider": make_sql_tasks,
            "imdb": make_sentiment_tasks, "flores": make_translation_tasks
            }[domain](n, seed)
