"""The controls: the reference put in the program's place, one precision
below the configuration's, or searching half of the rows, judged by the
same comparison.

A configuration names its precision control's precision (``control``):
- ``tf32``: float32 products with TF32 operands (10 explicit mantissa
  bits, rounded to nearest even; products and sums in float32), the
  lower precision a float32 index would be tempted by;
- ``int4``: rows stored as symmetric int4 codes with a scale a row (the
  precision below an int8 index's), queries in float32.

The half-rows control searches, at full precision, a half of the live
rows drawn from the seed: the answers of a scan that skips half of each
cluster's rows, or a probe that drops half of its lists.

For each of a sample of the window's queries (drawn from the seed) a
control answers the top ``limit`` keys of the live set with its own
distances, and ``judge.compare`` reads those answers as it reads the
program's. ``correct`` must come out false: the readings set the upper
end of each limit (``PERF.md``).

    python3 -m benchmark.control --workload <name> --seeds 1 2 3 --seconds 10 [--program 0]

runs the program on each seed (as ``benchmark.run`` does) and prints the
program's compared numbers beside the controls', one JSON line a seed.
With ``--program 0`` it runs no program: the controls answer a sample of
the query pool over the cell's rows, made from the seed as a run makes
them (read-only cells).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

import numpy as np
import torch

from benchmark import data, judge, reference
from benchmark.data import values_of

SAMPLE = 2048
KINDS = ("precision", "half_rows")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest even), as float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def int4_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows through symmetric int4 codes with a scale a row, as float32."""
    scale = x.abs().amax(dim=1, keepdim=True).clamp_min(torch.finfo(x.dtype).tiny) / 7.0
    return torch.clamp(torch.round(x / scale), -8, 7) * scale


def distances_for(precision: str):
    if precision == "tf32":
        def dist(q, v, space):
            if space == "COSINE":
                q, v = reference._unit(q), reference._unit(v)
            return reference.block_distances(tf32(q), tf32(v), space)
        return dist, (lambda v: v)
    if precision == "int4":
        return reference.block_distances, int4_rows
    raise ValueError(f"no control of precision {precision!r}")


def control_answers(cfg: dict, book: reference.KeyBook, queries: np.ndarray, qidx: np.ndarray, k: int,
                    device: torch.device, kind: str, rng: np.random.Generator) -> judge.Answers:
    """A control's answers to queries ``qidx`` over the live set after the
    window: in the configuration's lower precision, or over half of it."""
    keys, vecs = book.final_rows()
    if kind == "precision":
        dist, store = distances_for(cfg["control"])
    else:
        dist, store = reference.block_distances, (lambda v: v)
        half = np.sort(rng.permutation(keys.size)[: keys.size // 2])
        keys, vecs = keys[half], vecs[half]
    rows = store(torch.from_numpy(vecs).to(device))
    at, d = reference.exact_top_k(rows, torch.from_numpy(queries[qidx]).to(device), k, cfg["space"], dist)
    n = qidx.size
    zeros = np.zeros(n)
    return judge.Answers(qidx=qidx, due=zeros, sent=zeros, done=zeros, status=np.full(n, 200),
                         keys=keys[at], dists=d.astype(np.float32), width=np.full(n, k))


def control_checks(cell, inputs: dict, device: torch.device) -> dict:
    """Each control's compared numbers ({kind: checks}) on a sample of the
    window's queries, or of the pool's where ``inputs`` has no answers."""
    cfg, k = cell.config, cell.traffic["limit"]
    book = reference.KeyBook(inputs["rows"], inputs["writes"])
    queries = values_of(inputs["codes"])
    ans = inputs.get("answers")
    used = np.unique(ans.qidx) if ans is not None else np.arange(queries.shape[0])
    rng = np.random.default_rng([int(inputs["seed"]), 13])
    qidx = np.sort(rng.choice(used, size=min(SAMPLE, used.size), replace=False))
    out = {}
    for kind in KINDS:
        ctrl = control_answers(cfg, book, queries, qidx, k, device, kind, rng)
        out[kind] = judge.compare(cfg, book, queries, ctrl, k, None, device)
    return out


def passes(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())


def main() -> int:
    p = argparse.ArgumentParser(description="the program's and the controls' compared numbers")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--program", type=int, choices=(0, 1), default=1)
    args = p.parse_args()
    from benchmark import cell as cell_mod
    from benchmark import spec

    cell = spec.cell(spec.load(), args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t = time.perf_counter()
        line: dict = {"workload": args.workload, "seed": seed}
        if args.program:
            result = asyncio.run(cell_mod.run(cell, seed, args.seconds, False, device, t, keep=True))
            inputs = result["inputs"]
            line.update(program=result["checks"], program_correct=result["correct"],
                        metrics={m: v["value"] for m, v in result["metrics"].items()})
            del result
        else:
            rows = data.base_rows(cell.config, seed, device)
            inputs = {"rows": rows.cpu().numpy(), "codes": data.query_codes(cell.config, rows, seed),
                      "writes": None, "seed": seed}
            del rows
        t = time.perf_counter()
        ctrl = control_checks(cell, inputs, device)
        line.update(control=ctrl, control_correct={kind: passes(c) for kind, c in ctrl.items()},
                    control_s=time.perf_counter() - t)
        print(json.dumps(line), flush=True)
        del inputs
    return 0


if __name__ == "__main__":
    sys.exit(main())
