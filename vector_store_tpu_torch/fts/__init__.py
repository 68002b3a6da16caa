"""BM25 full-text search engine (host-side).

The reference embeds tantivy (fts_index/tantivy.rs); this is a compact
inverted-index equivalent with the same analysis chain — simple tokenizer
(split on non-alphanumeric), lowercasing, English stopword removal
(tantivy.rs:162-169) — BM25 scoring (k1=1.2, b=0.75, tantivy defaults),
and the same commit discipline: documents become searchable only at commit,
batched every COMMIT_INTERVAL seconds or COMMIT_DOCS uncommitted docs
(tantivy.rs:128-130); uncommitted docs delay SERVING.

Query syntax mirrors what the reference exposes by feeding the raw query
string to tantivy's QueryParser (tantivy.rs:258-301): bare terms are
disjunctive (SHOULD), `+term` is required (MUST), `-term` is excluded
(MUST_NOT), and `"quoted text"` is a phrase clause — all terms adjacent
and in order. Positions are post-stopword-filter indices (consistent at
index and query time), and phrase scoring follows Lucene's PhraseQuery:
tf = phrase occurrence count, idf = sum of member-term idfs.
"""

from __future__ import annotations

import math
import re
from collections import defaultdict

K1 = 1.2
B = 0.75
COMMIT_INTERVAL = 3.0
COMMIT_DOCS = 10_000

# Lucene/tantivy English stopword list
STOPWORDS = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such "
    "that the their then there these they this to was will with".split()
)

_TOKEN_RE = re.compile(r"[^\W_]+", re.UNICODE)


def analyze(text: str) -> list[str]:
    return [t for t in (m.group(0).lower() for m in _TOKEN_RE.finditer(text)) if t not in STOPWORDS]


def parse_query(query: str) -> list[tuple[int, list[str], bool]]:
    """Query string -> clause list [(occur, terms, is_phrase)] with occur
    in {-1 MUST_NOT, 0 SHOULD, +1 MUST}. A bare fragment that analyzes to
    several tokens expands to one clause per token (Lucene default); a
    quoted fragment stays one phrase clause."""
    clauses: list[tuple[int, list[str], bool]] = []
    i, n = 0, len(query)
    while i < n:
        while i < n and query[i].isspace():
            i += 1
        if i >= n:
            break
        occur = 0
        if query[i] == "+":
            occur, i = 1, i + 1
        elif query[i] == "-":
            occur, i = -1, i + 1
        if i < n and query[i] == '"':
            j = query.find('"', i + 1)
            if j < 0:
                j = n
            terms = analyze(query[i + 1 : j])
            i = j + 1
            if terms:
                clauses.append((occur, terms, True))
        else:
            j = i
            while j < n and not query[j].isspace():
                j += 1
            for t in analyze(query[i:j]):
                clauses.append((occur, [t], False))
            i = j
    return clauses


class InvertedIndex:
    """Term -> {doc_id: [positions]} postings with BM25 ranking."""

    def __init__(self) -> None:
        self.postings: dict[str, dict[int, list[int]]] = defaultdict(dict)
        self.doc_len: dict[int, int] = {}
        # doc -> its unique terms, so removal walks O(|doc|) postings
        # instead of every term in the vocabulary (CDC delete churn)
        self._doc_terms: dict[int, list[str]] = {}
        self._total_len = 0
        # staged (uncommitted) state
        self._pending_add: dict[int, str] = {}
        self._pending_del: set[int] = set()

    # -- writes (visible after commit) ----------------------------------------

    def add_document(self, doc_id: int, body: str) -> None:
        self._pending_del.discard(doc_id)
        self._pending_add[doc_id] = body

    def delete_document(self, doc_id: int) -> None:
        self._pending_add.pop(doc_id, None)
        self._pending_del.add(doc_id)

    @property
    def uncommitted(self) -> int:
        return len(self._pending_add) + len(self._pending_del)

    def commit(self) -> int:
        n = self.uncommitted
        for doc_id in self._pending_del:
            self._remove(doc_id)
        for doc_id, body in self._pending_add.items():
            self._remove(doc_id)  # replace semantics
            tokens = analyze(body)
            for pos, t in enumerate(tokens):
                self.postings[t].setdefault(doc_id, []).append(pos)
            self._doc_terms[doc_id] = list(dict.fromkeys(tokens))
            self.doc_len[doc_id] = len(tokens)
            self._total_len += len(tokens)
        self._pending_add.clear()
        self._pending_del.clear()
        return n

    def _remove(self, doc_id: int) -> None:
        if doc_id not in self.doc_len:
            return
        self._total_len -= self.doc_len.pop(doc_id)
        for term in self._doc_terms.pop(doc_id, ()):
            plist = self.postings.get(term)
            if plist is not None and doc_id in plist:
                del plist[doc_id]
                if not plist:
                    del self.postings[term]

    # -- reads ------------------------------------------------------------------

    @property
    def num_docs(self) -> int:
        return len(self.doc_len)

    def search(self, query: str, limit: int) -> list[tuple[int, float]]:
        """Top-`limit` (doc_id, bm25_score) under the boolean semantics of
        tantivy's QueryParser: docs satisfy every MUST clause, no MUST_NOT
        clause, and (absent MUSTs) at least one SHOULD clause; the score is
        the sum of matching positive-clause BM25 contributions."""
        n = self.num_docs
        if n == 0:
            return []
        avg_len = (self._total_len / n) if n else 0.0
        pos_scores: list[dict[int, float]] = []
        must_sets: list[set[int]] = []
        banned: set[int] = set()
        for occur, terms, is_phrase in parse_query(query):
            matches = self._match_clause(terms, is_phrase, n, avg_len)
            if occur < 0:
                banned.update(matches)
            else:
                pos_scores.append(matches)
                if occur > 0:
                    must_sets.append(set(matches))
        if not pos_scores:
            return []
        if must_sets:
            allowed = set.intersection(*must_sets)
        else:
            allowed = set()
            for m in pos_scores:
                allowed.update(m)
        allowed -= banned
        scores: dict[int, float] = defaultdict(float)
        for m in pos_scores:
            for doc_id, s in m.items():
                if doc_id in allowed:
                    scores[doc_id] += s
        ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
        return ranked[:limit]

    def _match_clause(
        self, terms: list[str], is_phrase: bool, n: int, avg_len: float
    ) -> dict[int, float]:
        if not is_phrase or len(terms) == 1:
            plist = self.postings.get(terms[0])
            if not plist:
                return {}
            df = len(plist)
            idf = math.log(1.0 + (n - df + 0.5) / (df + 0.5))
            out = {}
            for doc_id, positions in plist.items():
                out[doc_id] = self._bm25(idf, len(positions), doc_id, avg_len)
            return out
        # phrase: every term present at consecutive positions, in order
        plists = [self.postings.get(t) for t in terms]
        if any(p is None for p in plists):
            return {}
        idf = sum(
            math.log(1.0 + (n - len(p) + 0.5) / (len(p) + 0.5)) for p in plists
        )
        smallest = min(plists, key=len)
        out = {}
        for doc_id in smallest:
            if any(doc_id not in p for p in plists):
                continue
            rest = [set(p[doc_id]) for p in plists[1:]]
            tf = sum(
                1
                for p0 in plists[0][doc_id]
                if all((p0 + o + 1) in r for o, r in enumerate(rest))
            )
            if tf:
                out[doc_id] = self._bm25(idf, tf, doc_id, avg_len)
        return out

    def _bm25(self, idf: float, tf: int, doc_id: int, avg_len: float) -> float:
        dl = self.doc_len[doc_id]
        denom = tf + K1 * (1 - B + B * dl / avg_len) if avg_len else tf + K1
        return idf * (tf * (K1 + 1)) / denom

    def size_bytes(self) -> int:
        """Rough memory footprint for the fts_index_size_bytes gauge."""
        total = 0
        for term, plist in self.postings.items():
            total += len(term) + 48
            for positions in plist.values():
                total += 16 + 4 * len(positions)
        total += 16 * len(self.doc_len)
        return total
