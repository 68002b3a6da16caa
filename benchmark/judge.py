"""The comparison that decides ``correct``, and the end-to-end metrics.

Every answer the window's requests got is judged against the plain
reference (``benchmark/reference.py``), which works out the keys' vectors
and the live set from the benchmark's own inputs:

- ``dist_err``: the widest gap between a served distance and the exact
  (float64) distance of the served key's vector to the query, over the
  scale of the terms a float32 scan adds (|q|^2 + |v|^2 for euclidean, 1
  for cosine). A key the window updates may be served at its vector
  before or after the update: the smaller gap counts. Limit: the
  configuration's ``limits.dist_err``, set from readings of sound runs and
  of the control (``PERF.md``).
- ``bad_answers``: requests that failed, or were answered with fewer keys
  than the limit, out of distance order, with a key twice, or with a key
  that was never live. Exact: limit 0.
- ``recall_miss``: 1 less the mean recall@10 of answers against the
  reference's exact top 10 of their queries over the live rows: in a
  read-only cell every answer of the window; in a cell with writes
  ``RECALL_QUERIES`` queries of the pool sent once the window's writes
  have applied, against the live set after them. A scan that skips
  clusters or rows, a probe that drops lists, or a merge that keeps the
  wrong candidates reads high. Limit: the configuration's
  ``limits.recall_miss``, set from readings of sound runs and of a
  control that searches half of the rows (``PERF.md``).
- ``writes_missed`` (cells with writes), read once the window's writes
  have applied: a sample of inserted and updated rows, each queried by its
  new vector, that does not come first; updated rows that still come
  first for their old vector; deleted rows that still come back at all.
  Exact: limit 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark import reference
from benchmark.data import Writes, values_of

CHUNK_ANSWERS = 4096
RECALL_QUERIES = 2048
PERCENTILES = (50, 99)  # printed on standard error, for diagnosis


@dataclass
class Answers:
    """The window's requests: query, due / sent / done times (monotonic
    seconds), HTTP status, keys [r, k] (-1 padded), distances [r, k] (nan
    padded), and how many keys came back."""

    qidx: np.ndarray
    due: np.ndarray
    sent: np.ndarray
    done: np.ndarray
    status: np.ndarray
    keys: np.ndarray
    dists: np.ndarray
    width: np.ndarray

    @classmethod
    def concat(cls, parts: list[dict]) -> "Answers":
        return cls(**{f: np.concatenate([p[f] for p in parts]) for f in cls.__dataclass_fields__})

    def where(self, mask: np.ndarray) -> "Answers":
        return Answers(**{f: getattr(self, f)[mask] for f in self.__dataclass_fields__})


@dataclass
class Picks:
    """The rows the after-window check queries: ``kind`` (Writes.INSERT,
    UPDATE or DELETE, or STALE: an updated row's old vector), ``key``, and
    the vector each is queried by."""

    kind: np.ndarray
    key: np.ndarray
    vectors: np.ndarray

    STALE = 3


@dataclass
class AfterWindow:
    picks: Picks
    keys: np.ndarray  # [p, k] served keys, -1 padded
    status: np.ndarray  # [p]
    pool: np.ndarray  # [r] queries of the pool sent for recall
    pool_keys: np.ndarray  # [r, k] their served keys, -1 padded
    pool_status: np.ndarray  # [r]

    def recall_answers(self) -> "Answers":
        n, k = self.pool.size, self.pool_keys.shape[1]
        zeros = np.zeros(n)
        return Answers(qidx=self.pool, due=zeros, sent=zeros, done=zeros, status=self.pool_status,
                       keys=self.pool_keys, dists=np.zeros((n, k), np.float32), width=np.full(n, k))


def write_checks(writes: Writes, base: np.ndarray, rng: np.random.Generator, count: int) -> Picks:
    """Up to ``count`` writes of each kind, drawn from the seed."""
    kinds, keys, vecs = [], [], []
    for kind in (Writes.INSERT, Writes.UPDATE, Writes.DELETE):
        at = np.flatnonzero(writes.kind == kind)
        at = rng.choice(at, size=min(count, at.size), replace=False)
        key = writes.key[at]
        if kind == Writes.DELETE:
            kinds.append(np.full(at.size, kind)), keys.append(key), vecs.append(base[key])
            continue
        kinds.append(np.full(at.size, kind)), keys.append(key), vecs.append(writes.vectors[writes.vec[at]])
        if kind == Writes.UPDATE:
            kinds.append(np.full(at.size, Picks.STALE)), keys.append(key), vecs.append(base[key])
    return Picks(np.concatenate(kinds), np.concatenate(keys), np.concatenate(vecs).astype(np.float32))


def writes_missed(after: AfterWindow) -> int:
    p, keys = after.picks, after.keys
    first = keys[:, 0] == p.key
    anywhere = (keys == p.key[:, None]).any(axis=1)
    found_kind = np.isin(p.kind, (Writes.INSERT, Writes.UPDATE))
    miss = np.where(found_kind, ~first, np.where(p.kind == Picks.STALE, first, anywhere))
    return int((miss | (after.status != 200)).sum())


def dist_err(cfg: dict, book: reference.KeyBook, queries: np.ndarray, ans: Answers,
             device: torch.device) -> float:
    """The widest relative gap of the answered requests' distances."""
    worst = 0.0
    ok = np.flatnonzero((ans.status == 200) & (ans.width > 0))
    for lo in range(0, ok.size, CHUNK_ANSWERS):
        at = ok[lo : lo + CHUNK_ANSWERS]
        keys, served = ans.keys[at], ans.dists[at].astype(np.float64)
        valid = book.ever_live(keys) & np.isfinite(served)
        safe = np.where(valid, keys, 0)
        q = queries[ans.qidx[at]]
        gaps = []
        for after in (False, True) if book.writes is not None else (False,):
            ref, scale = reference.pair_distances(q, book.vectors(safe, after), cfg["space"], device)
            gaps.append(np.abs(served - ref) / scale)
        gap = np.where(valid, np.min(gaps, axis=0), 0.0)
        worst = max(worst, float(gap.max(initial=0.0)))
    return worst


def bad_answers(book: reference.KeyBook, ans: Answers, k: int) -> int:
    want = min(k, book.n)
    cols = np.arange(ans.keys.shape[1])[None, :]
    inside = cols < ans.width[:, None]
    short = ans.width < want
    never = (inside & ~book.ever_live(ans.keys)).any(axis=1)
    d = np.where(inside, ans.dists, np.inf)
    unordered = (np.diff(d, axis=1) < 0).any(axis=1)
    srt = np.sort(np.where(inside, ans.keys, -1 - cols), axis=1)
    twice = (np.diff(srt, axis=1) == 0).any(axis=1)
    bad = (ans.status != 200) | short | never | unordered | twice
    return int(bad.sum())


@dataclass
class Verdict:
    correct: bool
    attempted: int
    failed: int
    checks: dict  # name -> [value, limit]
    latency_s: np.ndarray
    answered_in_window: int

    @property
    def recall(self) -> float:
        return 1.0 - self.checks["recall_miss"][0]

    def metrics(self, fresh: np.ndarray | None, seconds: float, traffic: dict) -> dict:
        """Every end-to-end metric the run can give (a cell reports those
        ``BENCHMARK.json`` names for it), and latency percentiles, which
        only standard error shows."""
        out = {"qps": {"value": self.answered_in_window / seconds, "unit": "req/s"},
               "recall_at_10": {"value": self.recall, "unit": "fraction"}}
        for q in PERCENTILES:
            out[f"p{q}_ms"] = {"value": float(np.percentile(self.latency_s, q) * 1e3), "unit": "ms"}
        if fresh is not None and fresh.size:
            capped = np.minimum(fresh, seconds + traffic["writes"]["grace_s"])
            for q in PERCENTILES:
                out[f"fresh_p{q}_ms"] = {"value": float(np.percentile(capped, q) * 1e3), "unit": "ms"}
        return out


def window_requests(ans: Answers, t0: float, seconds: float) -> tuple[np.ndarray, np.ndarray]:
    """(which requests the window holds, their latency in seconds): those
    sent in it, timed from sending. A failed request counts as slower
    than any answer (the window plus a minute)."""
    held = (ans.sent >= t0) & (ans.sent < t0 + seconds)
    lat = np.where(ans.status == 200, ans.done - ans.sent, seconds + 60.0)
    return held, lat[held]


def timeline(ans: Answers, t0: float, seconds: float) -> str:
    """Answers completed in each second of the window, and their median
    latency from sending (ms): where a run's rate moved."""
    sec = np.floor(ans.done - t0).astype(np.int64)
    out = []
    for s in range(int(np.ceil(seconds))):
        at = sec == s
        med = np.median(ans.done[at] - ans.sent[at]) * 1e3 if at.any() else float("nan")
        out.append(f"{int(at.sum())}/{med:.0f}")
    return " ".join(out)


def compare(cfg: dict, book: reference.KeyBook, queries: np.ndarray, ans: Answers, k: int,
            after: AfterWindow | None, device: torch.device) -> dict:
    """The compared numbers of a set of answers, each [value, limit]: the
    answers themselves, and recall on ``after``'s pool queries where the
    window wrote, else on the answers."""
    checks = {
        "dist_err": [dist_err(cfg, book, queries, ans, device), cfg["limits"]["dist_err"]],
        "bad_answers": [bad_answers(book, ans, k), 0],
    }
    rec = after.recall_answers() if after is not None else ans.where(ans.status == 200)
    checks["recall_miss"] = [1.0 - recall_at(cfg, book, queries, rec, k, device), cfg["limits"]["recall_miss"]]
    if after is not None:
        checks["writes_missed"] = [writes_missed(after), 0]
    return checks


def recall_at(cfg: dict, book: reference.KeyBook, queries: np.ndarray, ans: Answers, k: int,
              device: torch.device) -> float:
    """Mean recall@k of the answers against the exact top-k of their
    queries over the live rows after the window (a failed answer has
    none of them)."""
    if not ans.qidx.size:
        return 0.0
    keys, vecs = book.final_rows()
    used = np.unique(ans.qidx)
    at, _ = reference.exact_top_k(torch.from_numpy(vecs).to(device), torch.from_numpy(queries[used]).to(device),
                                  k, cfg["space"])
    gt = keys[at]
    pos = np.searchsorted(used, ans.qidx)
    hits = (ans.keys[:, :k, None] == gt[pos][:, None, :]).any(axis=2) & (ans.keys[:, :k] >= 0)
    hits &= (ans.status == 200)[:, None]
    return float(hits.sum(axis=1).mean() / k)


def judge(cfg: dict, traffic: dict, rows: np.ndarray, codes: np.ndarray, writes: Writes | None,
          answers: Answers, after: AfterWindow | None, seconds: float, t0: float,
          device: torch.device) -> Verdict:
    k = traffic["limit"]
    queries = values_of(codes)
    book = reference.KeyBook(rows, writes)
    held, latency = window_requests(answers, t0, seconds)
    in_window = (answers.done >= t0) & (answers.done <= t0 + seconds) & (answers.status == 200)
    checks = compare(cfg, book, queries, answers, k, after, device)
    return Verdict(
        correct=all(v <= lim for v, lim in checks.values()),
        attempted=int(held.sum()),
        failed=int((answers.status[held] != 200).sum()),
        checks=checks,
        latency_s=latency,
        answered_in_window=int(in_window.sum()),
    )
