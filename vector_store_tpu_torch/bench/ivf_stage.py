"""Stage ablation of the IVF candidate pipeline on one GPU.

Twin of the JAX package's scripts/ivf_stage_opt2.py, at its shape: B 4096
queries of D 128, nlist 2048 clusters of cmax 1024 BF16 rows, nprobe 32,
k 16, and the slot budget s = choose_budget(4096, 32, 2048) = 128. The
pipeline is ops/ivf.py's: probe, regroup, query gather, grouped scan,
merge. Each row of the table is that pipeline with one change:

- base: as the engine runs it (g = choose_g, ops/ivf.py's merge);
- probe exact: the script's base probed with approx_max_k and this row
  with an exact top-k; the port's probe is the exact torch.topk in both,
  so this row repeats the base (a reading of the noise);
- fake scan, fake gather, sliced-out merge: one stage replaced by a cheap
  stand-in that keeps the data dependencies; the drop from the base is
  what the stage costs;
- kernel g1, g4, g8: the grouped scan with g clusters per CUDA block (the
  Pallas kernel's g clusters per grid step, kernel 4 of the JAX package);
- merge_v2, merge_v3: the script's two merge variants;
- combo g8 + v3.

Times are CUDA events around ``m`` back-to-back pipelines, per pipeline,
the median of ``reps`` such runs. PyTorch runs eagerly, so the script's
chained fori_loop (which kept XLA from eliding the work) has no
counterpart here. The equivalence check runs the base and the combo,
both with the exact probe, and compares their sorted ranks (within
1e-4 * (1 + |r|)) and positions.

    python -m vector_store_tpu_torch.bench.ivf_stage [--reps 5] [--m 8] [--seed 0]
"""

from __future__ import annotations

import argparse
import statistics
import sys
from dataclasses import dataclass

import torch

from vector_store_tpu_torch.ops import ivf
from vector_store_tpu_torch.ops.fused_scan import INVALID_BIAS, INVALID_CUTOFF, LANES

SHAPE = {"b": 4096, "d": 128, "nlist": 2048, "cmax": 1024, "nprobe": 32, "k": 16}
RTOL = 1e-4


@dataclass
class Problem:
    vectors: torch.Tensor  # [nlist*cmax, d] bf16, cluster-major
    a: torch.Tensor  # [nlist*cmax] f32
    b: torch.Tensor  # [nlist*cmax] f32
    cent: torch.Tensor  # [nlist, d] f32
    queries: torch.Tensor  # [B, d] bf16
    q_live: torch.Tensor  # [B] bool
    nlist: int
    cmax: int
    s: int
    nprobe: int
    k: int


def make_problem(device, *, b, d, nlist, cmax, nprobe, k, seed=0) -> Problem:
    """The script's inputs, drawn on ``device`` from ``seed``: normal rows
    and queries in BF16, euclidean coefficients a = -2, b = x^2 for a
    normal x, normal centroids."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    npos = nlist * cmax
    return Problem(
        vectors=normal(npos, d).to(torch.bfloat16),
        a=torch.full((npos,), -2.0, device=device),
        b=normal(npos).square(),
        cent=normal(nlist, d),
        queries=normal(b, d).to(torch.bfloat16),
        q_live=torch.ones((b,), dtype=torch.bool, device=device),
        nlist=nlist,
        cmax=cmax,
        s=ivf.choose_budget(b, nprobe, nlist),
        nprobe=nprobe,
        k=k,
    )


# -- merges ------------------------------------------------------------------------


def merge_base(rank_out, row_out, filled, row_of_pair, probes, *, k):
    """ops/ivf.py's merge."""
    del probes
    return ivf.merge_candidates(rank_out, row_out, filled, row_of_pair, k=k)


def merge_v2(rank_out, row_out, filled, row_of_pair, probes, *, k):
    """The script's merge_v2: every candidate's position gathered beside
    its rank ([B, nprobe*128] of each), the winners' taken from it. The
    script's kernel wrote in-cluster offsets and its merge_full first
    materialized positions for all slots; the port's kernel writes
    absolute rows, so that pass never exists and v2 is the whole-gather
    form of the merge."""
    del probes
    nq, nprobe = row_of_pair.shape
    rank_out = torch.where(filled[:, None], rank_out, INVALID_BIAS)
    safe_row = torch.clamp(row_of_pair, min=0)
    live = (row_of_pair >= 0)[:, :, None]
    cand_rank = torch.where(live, rank_out[safe_row], INVALID_BIAS).view(nq, nprobe * LANES)
    cand_pos = row_out[safe_row].view(nq, nprobe * LANES)
    best_rank, sel = torch.topk(cand_rank, k, dim=1, largest=False, sorted=True)
    best_pos = torch.gather(cand_pos, 1, sel)
    return best_rank, torch.where(best_rank < INVALID_CUTOFF, best_pos, -1)


def merge_v3(rank_out, row_out, filled, row_of_pair, probes, *, k):
    """The script's merge_v3: only the k winners' positions are gathered
    from the scan's output, through their (pair, lane). The port's merge
    (ops/ivf.py::merge_candidates) has had this form from the start, so
    v3 is that function; the row shows it beside v2."""
    return merge_base(rank_out, row_out, filled, row_of_pair, probes, k=k)


MERGES = {"base": merge_base, "v2": merge_v2, "v3": merge_v3}


# -- the pipeline --------------------------------------------------------------------


def pipeline(p: Problem, *, g: int | None = None, merge: str = "base", ablate: str | None = None):
    """Probe -> regroup -> query gather -> grouped scan -> merge, with one
    stage faked (``ablate`` in scan, gather, merge). Returns (rank [B, k]
    f32, pos [B, k] i32)."""
    probes = ivf.ivf_probe(p.cent, p.queries, p.q_live, nprobe=p.nprobe, spherical=False)
    qtab, filled, row_of_pair = ivf.regroup_pairs(probes, nlist=p.nlist, s=p.s)
    if ablate == "gather":
        qg = torch.zeros((p.nlist * p.s, p.queries.shape[1]), dtype=p.queries.dtype,
                         device=p.queries.device) + p.queries[:1, :1]
    else:
        qg = p.queries[qtab].contiguous()
    if ablate == "scan":
        rank_out = torch.zeros((p.nlist * p.s, LANES), device=qg.device) + qg[:, :1].float()
        row_out = torch.zeros((p.nlist * p.s, LANES), dtype=torch.int32, device=qg.device)
    else:
        rank_out, row_out = ivf.grouped_scan(qg, p.vectors, p.a, p.b, p.s, p.cmax, g=g)
    if ablate == "merge":
        nq = p.queries.shape[0]
        return rank_out[:nq, : p.k] + row_out[:nq, : p.k].float(), row_out[:nq, : p.k]
    return MERGES[merge](rank_out, row_out, filled, row_of_pair, probes, k=p.k)


ROWS = (
    ("base", {}),
    ("probe exact (= base)", {}),
    ("fake scan", {"ablate": "scan"}),
    ("fake gather", {"ablate": "gather"}),
    ("sliced-out merge", {"ablate": "merge"}),
    ("kernel g1", {"g": 1}),
    ("kernel g4", {"g": 4}),
    ("kernel g8", {"g": 8}),
    ("merge_v2", {"merge": "v2"}),
    ("merge_v3", {"merge": "v3"}),
    ("combo g8+v3", {"g": 8, "merge": "v3"}),
)


def equivalence(p: Problem) -> dict:
    """The script's closing check: the combo (g 8, merge_v3) against the
    base, both with the exact probe. Runs on any device (on the CPU the
    scan is the plain version at every g)."""
    r0, p0 = pipeline(p)
    r1, p1 = pipeline(p, g=8 if p.nlist % 8 == 0 else 1, merge="v3")
    s0, s1 = torch.sort(r0, dim=1).values, torch.sort(r1, dim=1).values
    diff = (s0 - s1).abs()
    same_pos = (torch.sort(p0, dim=1).values == torch.sort(p1, dim=1).values).float().mean()
    return {
        "max_rank_diff": float(diff.max()),
        "pos_agreement": float(same_pos),
        "ok": bool((diff <= RTOL * (1 + s0.abs())).all()),
    }


def _median_ms(fn, m: int, reps: int) -> tuple[float, list[float]]:
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(m):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / m)
    return statistics.median(runs), runs


def run(device: torch.device, *, shape: dict | None = None, reps: int = 5, m: int = 8, seed: int = 0) -> dict:
    """Time every row of the ablation on ``device`` (a CUDA device: a
    timing needs the card) and run the equivalence check."""
    if device.type != "cuda":
        raise RuntimeError("the stage ablation times on a CUDA device")
    shape = dict(SHAPE if shape is None else shape)
    p = make_problem(device, seed=seed, **shape)
    rows = []
    for name, kw in ROWS:
        med, runs = _median_ms(lambda kw=kw: pipeline(p, **kw), m, reps)
        rows.append({"stage": name, "ms": med, "runs": runs})
    by = {r["stage"]: r["ms"] for r in rows}
    return {
        "shape": shape,
        "s": p.s,
        "g_base": ivf.choose_g(),
        "rows": rows,
        "equivalence": equivalence(p),
        "speedup": by["base"] / by["combo g8+v3"],
    }


def table(result: dict) -> list[str]:
    sh, b = result["shape"], result["shape"]["b"]
    lines = [
        f"B={b} D={sh['d']} nlist={sh['nlist']} cmax={sh['cmax']} nprobe={sh['nprobe']} "
        f"k={sh['k']} s={result['s']} BF16; base g={result['g_base']}"
    ]
    for r in result["rows"]:
        runs = ", ".join(f"{t:.3f}" for t in r["runs"])
        lines.append(f"{r['stage']:24s} {r['ms']:8.3f} ms/iter ({b / r['ms'] * 1e3:9.0f} qps)   runs=[{runs}]")
    eq = result["equivalence"]
    lines.append(
        f"equivalence: max sorted-rank diff {eq['max_rank_diff']:.3e}, pos agreement "
        f"{eq['pos_agreement']:.4f} ({'ok' if eq['ok'] else 'FAILED'}: tolerance {RTOL:g} * (1 + |r|))"
    )
    lines.append(f"speedup combo vs base: {result['speedup']:.2f}x")
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the stage ablation times on the card", file=sys.stderr)
        return 1
    result = run(torch.device("cuda", 0), reps=args.reps, m=args.m, seed=args.seed)
    for line in table(result):
        print(line)
    return 0 if result["equivalence"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
