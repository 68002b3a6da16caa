"""Ablation of the scan kernels (fused, grouped, partition) on one GPU.

Where does a scan's time go? Each variant is the kernels of csrc/ with one
part of the scan cores cut out by a compile-time switch of
csrc/hopper_scan.cuh (-DVST_ABLATE_...), built beside the real library and
timed at the shapes chip_smoke.py times. A variant's results are wrong by
design (it skips work); only its time is read, against the unchanged
kernels' in the same run:

- "no fold": the running minimum is folded for the first pass of a group
  only (what the epilogue costs);
- "no product": the slice loop copies and synchronises but does no FMA
  and no MMA (what the copy pipeline, the barriers and the fold take alone;
  with "no fold" as well, the copies and barriers alone);
- "no query reads": in the F32 core every thread multiplies by one query's
  values, so the 16 shared-memory broadcasts per 4 dimensions fall to one
  (what the query operand costs the FMA loop; the tensor core is as built).

Shapes: the fused scan over 1,015,808 x 128 rows with 1024 queries (F32,
BF16); the grouped scan at nlist 2048 x cmax 768, s 32 (F32), at the stage
ablation's nlist 2048 x cmax 1024, s 128 (BF16) and at the I8 main
region's nlist 2048 x cmax 640, Dp 1536, s 32 (int8 rows, bf16 queries);
the partition scan over bench/partition_times.py's mirror (P_cap 2048 x
pmax 1024) with its B 2048 uniform batch (F32, BF16): its entry point's
three kernels (sort by bucket, scan, chunk merge), of which only the scan
runs the cores. Times are medians of CUDA-event timings after a warm-up.

    python -m vector_store_tpu_torch.bench.scan_ablation [--reps 10] [variant ...]
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys

import torch

from vector_store_tpu_torch.bench import partition_times
from vector_store_tpu_torch.ops import kernels
from vector_store_tpu_torch.ops.fused_scan import LANES

# variant -> the switches of csrc/hopper_scan.cuh it defines
VARIANTS: dict[str, tuple[str, ...]] = {
    "as built": (),
    "no fold": ("VST_ABLATE_FOLD",),
    "no product": ("VST_ABLATE_PRODUCT",),
    "no product, no fold": ("VST_ABLATE_PRODUCT", "VST_ABLATE_FOLD"),
    "no query reads": ("VST_ABLATE_QUERY_READS",),
}


def build_variant(name: str):
    """The kernels of csrc/ built with the variant's switches defined."""
    return kernels.load(tuple(f"-D{switch}" for switch in VARIANTS[name]))[0]


def make_cases(device, seed: int = 0) -> dict:
    """name -> (entry point, tensors without outputs, ints, outputs as
    (shape, dtype) in the entry point's order)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def rows(n, d, dtype):
        out = torch.empty((n, d), dtype=dtype, device=device)
        for lo in range(0, n, 131_072):
            x = torch.randn((min(131_072, n - lo), d), generator=gen, device=device)
            x /= x.norm(dim=1, keepdim=True)
            out[lo : lo + x.shape[0]] = torch.round(x * 127).to(dtype) if dtype is torch.int8 else x.to(dtype)
        return out

    def coeffs(n):
        return torch.full((n,), -1.0, device=device), torch.zeros((n,), device=device)

    cases = {}
    cap, block, nq = 1_015_808, 16_384, 1024
    for label, dt in (("fused F32", torch.float32), ("fused BF16", torch.bfloat16)):
        ints = [nq, cap, block, 128, kernels.DTYPE_CODES[dt]]
        cases[label] = ("vst_fused_scan", [rows(nq, 128, dt), rows(cap, 128, dt), *coeffs(cap)], ints,
                        candidates((nq, cap // block * LANES)))
    for label, dt, qdt, nlist, cmax, s, dp in (
        ("grouped F32", torch.float32, torch.float32, 2048, 768, 32, 128),
        ("grouped BF16 s128", torch.bfloat16, torch.bfloat16, 2048, 1024, 128, 128),
        ("grouped I8 Dp1536", torch.int8, torch.bfloat16, 2048, 640, 32, 1536),
    ):
        ints = [nlist, s, cmax, dp, kernels.DTYPE_CODES[dt], 1]
        cases[label] = ("vst_grouped_scan", [rows(nlist * s, dp, qdt), rows(nlist * cmax, dp, dt),
                                             *coeffs(nlist * cmax)], ints, candidates((nlist * s, LANES)))
    v32, a, b = partition_times.mirror(device)
    q32, bsel = partition_times.batch("B 2048 uniform", device)
    nq, pmax, dp = q32.shape[0], partition_times.PMAX, partition_times.DIMS
    for label, dt in (("partition F32", torch.float32), ("partition BF16", torch.bfloat16)):
        ints = [nq, partition_times.PCAP, pmax, dp, kernels.DTYPE_CODES[dt], pmax]
        cases[label] = ("vst_partition_scan", [q32.to(dt), v32.to(dt), a, b, bsel], ints,
                        [((nq, dp), dt), ((3, nq), torch.int32)] + candidates((1, nq, LANES))
                        + candidates((nq, LANES)))
    return cases


def candidates(shape) -> list:
    """The (rank, position) outputs of a scan, as (shape, dtype)."""
    return [(shape, torch.float32), (shape, torch.int32)]


def median_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run(device, names: list[str] | None = None, reps: int = 10) -> dict[str, dict[str, float]]:
    """variant -> case -> median ms; "as built" first and last (the run's
    own spread)."""
    cases = make_cases(device)
    outs = {
        label: [torch.empty(shape, dtype=dtype, device=device) for shape, dtype in shapes]
        for label, (_, _, _, shapes) in cases.items()
    }
    result = {}
    for name in ["as built", *(names or [n for n in VARIANTS if n != "as built"]), "as built"]:
        lib = build_variant(name)
        key = name if name not in result else f"{name} (again)"
        result[key] = {
            label: median_ms(lambda: kernels.launch(entry, [*tensors, *outs[label]], ints, lib=lib), reps)
            for label, (entry, tensors, ints, _) in cases.items()
        }
    return result


def table(result: dict[str, dict[str, float]]) -> list[str]:
    cases = list(next(iter(result.values())))
    lines = [f"{'variant':<22}" + "".join(f"{c:>20}" for c in cases)]
    for name, row in result.items():
        lines.append(f"{name:<22}" + "".join(f"{row[c]:>17.3f} ms" for c in cases))
    return lines


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", help=f"default: all of {', '.join(map(repr, VARIANTS))}")
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args(argv)
    unknown = [name for name in args.variants if name not in VARIANTS]
    if unknown:
        parser.error(f"unknown variants {unknown}")
    if not torch.cuda.is_available():
        print("scan_ablation needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"scan ablation on {card}; ms per launch, median of {args.reps}")
    for line in table(run(torch.device("cuda", 0), args.variants or None, args.reps)):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
