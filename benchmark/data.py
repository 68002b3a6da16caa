"""Rows, query pools and write streams, made from ``--seed``.

Everything a run feeds the program and the reference comes from here, so
both sides get the same inputs. Rows are drawn on the run's device with a
``torch.Generator`` in a few large calls and copied to the host once (the
program's bootstrap reads host rows). Schedules (arrival times, which
query each request sends, which rows each write touches) are small and
drawn by numpy. Every seed gives the same amount of work: the counts are
fixed by the traffic file and the window's length, only the values and
the order change.

Queries travel as JSON text with ``QUERY_DECIMALS`` decimals, so a query
is kept as its integer codes (``round(x * 10**decimals)``): the client
prints them, and the reference reads the same values back as float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

QUERY_DECIMALS = 4
CHUNK_ROWS = 131_072


def generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` for one stream of a seed's draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + stream) % (2**63 - 1))
    return gen


def _centers(cfg: dict, seed: int, device: torch.device) -> torch.Tensor:
    rows = cfg["rows"]
    return torch.randn(
        (rows["clusters"], cfg["dimensions"]), generator=generator(seed, 0, device), device=device
    ) / math.sqrt(cfg["dimensions"])


def _draw(cfg: dict, centers: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    """n rows of the configuration's distribution: a center plus Gaussian
    noise of ``sigma / sqrt(d)`` a component, cut to unit length where the
    configuration says so; f32, on the centers' device."""
    d, spec = cfg["dimensions"], cfg["rows"]
    out = torch.empty((n, d), dtype=torch.float32, device=centers.device)
    for lo in range(0, n, CHUNK_ROWS):
        m = min(CHUNK_ROWS, n - lo)
        label = torch.randint(0, centers.shape[0], (m,), generator=gen, device=centers.device)
        x = torch.randn((m, d), generator=gen, device=centers.device)
        x.mul_(spec["sigma"] / math.sqrt(d)).add_(centers[label])
        if spec.get("unit"):
            x.div_(x.norm(dim=1, keepdim=True))
        out[lo : lo + m] = x
    return out


def base_rows(cfg: dict, seed: int, device: torch.device) -> torch.Tensor:
    """The index's rows at bootstrap, [n, d] f32 on ``device``."""
    return _draw(cfg, _centers(cfg, seed, device), cfg["rows"]["count"], generator(seed, 1, device))


def fresh_rows(cfg: dict, seed: int, n: int, device: torch.device) -> torch.Tensor:
    """n more rows of the same distribution (the vectors that writes carry)."""
    return _draw(cfg, _centers(cfg, seed, device), n, generator(seed, 2, device))


def query_codes(cfg: dict, rows: torch.Tensor, seed: int) -> np.ndarray:
    """The query pool as int32 codes [pool, d]: a base row plus Gaussian
    noise of ``noise / sqrt(d)`` a component, rounded to QUERY_DECIMALS."""
    spec, d = cfg["queries"], cfg["dimensions"]
    gen = generator(seed, 3, rows.device)
    pick = torch.randint(0, rows.shape[0], (spec["pool"],), generator=gen, device=rows.device)
    q = rows[pick] + torch.randn((spec["pool"], d), generator=gen, device=rows.device) * (
        spec["noise"] / math.sqrt(d)
    )
    return codes_of(q)


def codes_of(x: torch.Tensor) -> np.ndarray:
    return torch.round(x.double() * 10**QUERY_DECIMALS).to(torch.int32).cpu().numpy()


def values_of(codes: np.ndarray) -> np.ndarray:
    """The float32 values a query's text parses to (the nearest double to
    the decimal, then float32, as the server reads it)."""
    return (codes.astype(np.float64) / 10**QUERY_DECIMALS).astype(np.float32)


def sorted_times(rng: np.random.Generator, count: int, seconds: float) -> np.ndarray:
    """``count`` arrival times in [0, seconds): a Poisson process with its
    count fixed, so every seed offers the same load."""
    return np.sort(rng.uniform(0.0, seconds, size=count))


@dataclass
class Writes:
    """A write stream: ``times`` [w] seconds into the window, ``kind`` [w]
    (0 insert, 1 update, 2 delete), ``key`` [w] the row's key, ``vec`` [w]
    the index into ``vectors`` (-1 for a delete), ``probe`` [w] bool: an
    insert whose key a probe looks for."""

    times: np.ndarray
    kind: np.ndarray
    key: np.ndarray
    vec: np.ndarray
    probe: np.ndarray
    vectors: np.ndarray  # [inserts + updates, d] f32

    INSERT, UPDATE, DELETE = 0, 1, 2


def write_stream(cfg: dict, spec: dict, seed: int, seconds: float, device: torch.device) -> Writes:
    """The traffic's writes: ``rate`` a second over a window of
    ``seconds``, in the shares ``insert`` /
    ``update`` / ``delete``; inserts take new keys from n upward, updates
    and deletes distinct base keys (no key is written twice),
    ``probes_per_s`` of the window's inserts carry a probe."""
    rng = np.random.default_rng([int(seed), 11])
    n = cfg["rows"]["count"]
    total = int(round(spec["rate"] * seconds))
    n_upd = int(round(spec["update"] * total))
    n_del = int(round(spec["delete"] * total))
    n_ins = total - n_upd - n_del
    kind = rng.permutation(np.repeat([Writes.INSERT, Writes.UPDATE, Writes.DELETE], [n_ins, n_upd, n_del]))
    key = np.empty(total, dtype=np.int64)
    vec = np.full(total, -1, dtype=np.int64)
    ins = np.flatnonzero(kind == Writes.INSERT)
    key[ins] = n + np.arange(n_ins)
    vec[ins] = np.arange(n_ins)
    touched = rng.choice(n, size=n_upd + n_del, replace=False)
    upd = np.flatnonzero(kind == Writes.UPDATE)
    key[upd] = touched[:n_upd]
    vec[upd] = n_ins + np.arange(n_upd)
    key[kind == Writes.DELETE] = touched[n_upd:]
    probe = np.zeros(total, dtype=bool)
    n_probe = min(ins.size, int(round(spec["probes_per_s"] * seconds)))
    probe[rng.choice(ins, size=n_probe, replace=False)] = True
    vectors = fresh_rows(cfg, seed, n_ins + n_upd, device).cpu().numpy()
    return Writes(sorted_times(rng, total, seconds), kind, key, vec, probe, vectors)
