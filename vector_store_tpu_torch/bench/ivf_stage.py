"""Stage ablation of the IVF candidate pipeline on one GPU.

Twin of the JAX package's scripts/ivf_stage_opt2.py, at its shape: B 4096
queries of D 128, nlist 2048 clusters of cmax 1024 BF16 rows, nprobe 32,
k 16, and the slot budget s = choose_budget(4096, 32, 2048) = 128
(``--s`` sets another: the engine serves a 4096-query batch at s 2048
once a skewed batch has raised its boost; ``--storage i8`` takes int8
rows under bf16 queries, the I8 index's scan). The dense pipeline is the JAX package's: probe, regroup
into the slot plane, query gather, grouped scan of every slot, merge.
Each row of the table is that pipeline with one change:

- base: the dense pipeline (g = choose_g, ops/ivf.py's merge);
- probe exact: the script's base probed with approx_max_k and this row
  with an exact top-k; the port's probe is the exact torch.topk in both,
  so this row repeats the base (a reading of the noise);
- fake scan, fake gather, sliced-out merge: one stage replaced by a cheap
  stand-in that keeps the data dependencies; the drop from the base is
  what the stage costs;
- kernel g1, g4, g8: the grouped scan with g clusters per CUDA block (the
  Pallas kernel's g clusters per grid step, kernel 4 of the JAX package);
- merge_v2, merge_v3: the script's two merge variants;
- combo g8 + v3;
- pairs: the compact pipeline the engine runs (ops/ivf.py::
  ivf_candidates: probe, compact_pairs, the pairs' query gather,
  grouped_scan_pairs, merge), and its own fake scan, fake gather and
  sliced-out merge rows.

Times are CUDA events around ``m`` back-to-back pipelines, per pipeline,
the median of ``reps`` such runs. PyTorch runs eagerly, so the script's
chained fori_loop (which kept XLA from eliding the work) has no
counterpart here. The equivalence check runs the base, the combo and
the pairs pipeline, all with the exact probe, and compares the combo's
and the pairs' sorted ranks (within 1e-4 * (1 + |r|)) and positions with
the base's.

    python -m vector_store_tpu_torch.bench.ivf_stage [--reps 5] [--m 8] [--seed 0] [--s S] [--storage bf16]
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
STORAGE = {"bf16": torch.bfloat16, "i8": torch.int8}


@dataclass
class Problem:
    vectors: torch.Tensor  # [nlist*cmax, d] storage dtype, cluster-major
    a: torch.Tensor  # [nlist*cmax] f32
    b: torch.Tensor  # [nlist*cmax] f32
    cent: torch.Tensor  # [nlist, d] f32
    queries: torch.Tensor  # [B, d] storage dtype (bf16 over int8 rows)
    q_live: torch.Tensor  # [B] bool
    nlist: int
    cmax: int
    s: int
    nprobe: int
    k: int


def make_problem(device, *, b, d, nlist, cmax, nprobe, k, seed=0, s=None, storage="bf16") -> Problem:
    """The script's inputs, drawn on ``device`` from ``seed``: normal rows
    and queries in the storage dtype (i8: uniform codes in [-127, 127]
    under bf16 queries), euclidean coefficients a = -2, b = x^2 for a
    normal x, normal centroids; ``s`` None is choose_budget's."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    npos, dt = nlist * cmax, STORAGE[storage]
    if dt == torch.int8:
        vectors = torch.randint(-127, 128, (npos, d), generator=gen, device=device, dtype=torch.int8)
    else:
        vectors = normal(npos, d).to(dt)
    return Problem(
        vectors=vectors,
        a=torch.full((npos,), -2.0, device=device),
        b=normal(npos).square(),
        cent=normal(nlist, d),
        queries=normal(b, d).to(torch.bfloat16 if dt == torch.int8 else dt),
        q_live=torch.ones((b,), dtype=torch.bool, device=device),
        nlist=nlist,
        cmax=cmax,
        s=ivf.choose_budget(b, nprobe, nlist) if s is None else s,
        nprobe=nprobe,
        k=k,
    )


# -- merges ------------------------------------------------------------------------


def merge_base(rank_out, row_out, row_of_pair, probes, *, k):
    """ops/ivf.py's merge."""
    del probes
    return ivf.merge_candidates(rank_out, row_out, row_of_pair, k=k)


def merge_v2(rank_out, row_out, row_of_pair, probes, *, k):
    """The script's merge_v2: every candidate's position gathered beside
    its rank ([B, nprobe*128] of each), the winners' taken from it. The
    script's kernel wrote in-cluster offsets and its merge_full first
    materialized positions for all slots; the port's kernel writes
    absolute rows, so that pass never exists and v2 is the whole-gather
    form of the merge."""
    del probes
    nq, nprobe = row_of_pair.shape
    safe_row = torch.clamp(row_of_pair, min=0)
    live = (row_of_pair >= 0)[:, :, None]
    cand_rank = torch.where(live, rank_out[safe_row], INVALID_BIAS).view(nq, nprobe * LANES)
    cand_pos = row_out[safe_row].view(nq, nprobe * LANES)
    best_rank, sel = torch.topk(cand_rank, k, dim=1, largest=False, sorted=True)
    best_pos = torch.gather(cand_pos, 1, sel)
    return best_rank, torch.where(best_rank < INVALID_CUTOFF, best_pos, -1)


def merge_v3(rank_out, row_out, row_of_pair, probes, *, k):
    """The script's merge_v3: only the k winners' positions are gathered
    from the scan's output, through their (pair, lane). The port's merge
    (ops/ivf.py::merge_candidates) has had this form from the start, so
    v3 is that function; the row shows it beside v2."""
    return merge_base(rank_out, row_out, row_of_pair, probes, k=k)


MERGES = {"base": merge_base, "v2": merge_v2, "v3": merge_v3}


# -- the pipeline --------------------------------------------------------------------


def pipeline(
    p: Problem, *, g: int | None = None, merge: str = "base", ablate: str | None = None, pairs: bool = False
):
    """Probe -> regroup -> query gather -> grouped scan -> merge, with one
    stage faked (``ablate`` in scan, gather, merge); ``pairs``: the
    compact pair list in place of the slot plane (ivf_candidates' path).
    Returns (rank [B, k] f32, pos [B, k] i32)."""
    probes = ivf.ivf_probe(p.cent, p.queries, p.q_live, nprobe=p.nprobe, spherical=False)
    if pairs:
        qtab, starts, counts, row_of_pair = ivf.compact_pairs(probes, nlist=p.nlist, s=p.s)
    else:
        qtab, _, row_of_pair = ivf.regroup_pairs(probes, nlist=p.nlist, s=p.s)
    rows = qtab.shape[0]
    if ablate == "gather":
        qg = torch.zeros((rows, p.queries.shape[1]), dtype=p.queries.dtype,
                         device=p.queries.device) + p.queries[:1, :1]
    else:
        qg = p.queries[qtab]
    if ablate == "scan":
        rank_out = torch.zeros((rows, LANES), device=qg.device) + qg[:, :1].float()
        row_out = torch.zeros((rows, LANES), dtype=torch.int32, device=qg.device)
    elif pairs:
        rank_out, row_out = ivf.grouped_scan_pairs(qg, p.vectors, p.a, p.b, starts, counts, cmax=p.cmax)
    else:
        rank_out, row_out = ivf.grouped_scan(qg, p.vectors, p.a, p.b, p.s, p.cmax, g=g)
    if ablate == "merge":
        nq = p.queries.shape[0]
        return rank_out[:nq, : p.k] + row_out[:nq, : p.k].float(), row_out[:nq, : p.k]
    return MERGES[merge](rank_out, row_out, row_of_pair, probes, k=p.k)


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
    ("pairs", {"pairs": True}),
    ("pairs fake scan", {"pairs": True, "ablate": "scan"}),
    ("pairs fake gather", {"pairs": True, "ablate": "gather"}),
    ("pairs sliced-out merge", {"pairs": True, "ablate": "merge"}),
)


def equivalence(p: Problem) -> dict:
    """The script's closing check: the combo (g 8, merge_v3) and the pairs
    pipeline against the base, all with the exact probe. Runs on any
    device (on the CPU the scans are their plain versions)."""
    r0, p0 = pipeline(p)
    s0, q0 = torch.sort(r0, dim=1).values, torch.sort(p0, dim=1).values
    diff, same_pos, ok = 0.0, 1.0, True
    for kw in ({"g": 8 if p.nlist % 8 == 0 else 1, "merge": "v3"}, {"pairs": True}):
        r1, p1 = pipeline(p, **kw)
        d = (s0 - torch.sort(r1, dim=1).values).abs()
        diff = max(diff, float(d.max()))
        same_pos = min(same_pos, float((q0 == torch.sort(p1, dim=1).values).float().mean()))
        ok = ok and bool((d <= RTOL * (1 + s0.abs())).all())
    return {"max_rank_diff": diff, "pos_agreement": same_pos, "ok": ok}


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


def run(
    device: torch.device, *, shape: dict | None = None, reps: int = 5, m: int = 8, seed: int = 0,
    s: int | None = None, storage: str = "bf16", rows: tuple = ROWS,
) -> dict:
    """Time ``rows`` of the ablation (every row by default) on ``device``
    (a CUDA device: a timing needs the card) and run the equivalence
    check."""
    if device.type != "cuda":
        raise RuntimeError("the stage ablation times on a CUDA device")
    shape = dict(SHAPE if shape is None else shape)
    p = make_problem(device, seed=seed, s=s, storage=storage, **shape)
    timed = []
    for name, kw in rows:
        med, runs = _median_ms(lambda kw=kw: pipeline(p, **kw), m, reps)
        timed.append({"stage": name, "ms": med, "runs": runs})
    by = {r["stage"]: r["ms"] for r in timed}
    return {
        "shape": shape,
        "s": p.s,
        "storage": storage,
        "g_base": ivf.choose_g(),
        "rows": timed,
        "equivalence": equivalence(p),
        "speedup": {name: by["base"] / by[name] for name in ("combo g8+v3", "pairs") if name in by},
    }


def table(result: dict) -> list[str]:
    sh, b = result["shape"], result["shape"]["b"]
    lines = [
        f"B={b} D={sh['d']} nlist={sh['nlist']} cmax={sh['cmax']} nprobe={sh['nprobe']} "
        f"k={sh['k']} s={result['s']} {result['storage'].upper()}; base g={result['g_base']}"
    ]
    for r in result["rows"]:
        runs = ", ".join(f"{t:.3f}" for t in r["runs"])
        lines.append(f"{r['stage']:24s} {r['ms']:8.3f} ms/iter ({b / r['ms'] * 1e3:9.0f} qps)   runs=[{runs}]")
    eq = result["equivalence"]
    lines.append(
        f"equivalence: max sorted-rank diff {eq['max_rank_diff']:.3e}, pos agreement "
        f"{eq['pos_agreement']:.4f} ({'ok' if eq['ok'] else 'FAILED'}: tolerance {RTOL:g} * (1 + |r|))"
    )
    for name, x in result["speedup"].items():
        lines.append(f"speedup {name} vs base: {x:.2f}x")
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--s", type=int, default=None, help="slot budget (default: choose_budget)")
    ap.add_argument("--storage", choices=sorted(STORAGE), default="bf16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the stage ablation times on the card", file=sys.stderr)
        return 1
    result = run(torch.device("cuda", 0), reps=args.reps, m=args.m, seed=args.seed, s=args.s, storage=args.storage)
    for line in table(result):
        print(line)
    return 0 if result["equivalence"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
