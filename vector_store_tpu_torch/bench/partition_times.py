"""Times of the partition scan (kernel 3) at the local index's shapes, on one GPU.

The partition-1000k mirror (P_cap 2048 x pmax 1024 positions of 128-d unit
rows, ~5% of them empty, 1025 live buckets) and four batches: B 2048 with
buckets drawn uniformly, B 2048 drawn from a Zipf law of exponent 1.1 over
the live buckets (a hot bucket holds hundreds of queries), B 64 (the size
of the local service's batches) and B 8; each in F32 and BF16.
chip_smoke.py holds the kernel against its plain version on this data.
This script only times ``partition_scan``, imported from the checkout
that --root names, so that two trees can be timed in one run. Two times a
case: "call", one call as a caller makes it, between two CUDA events (the
wrapper's host time included, as chip_smoke.py times it); "queued", the
time per call of QUEUED calls made back to back, which the host enqueues
faster than the card runs them: the device time of a call.

    python vector_store_tpu_torch/bench/partition_times.py [--root DIR] [--reps 20]

It prints one line per case and, last, a JSON object of the medians (ms).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

SEED = 20261016
DIMS = 128
PCAP, PMAX, LIVE_BUCKETS = 2048, 1024, 1025
EMPTY_SHARE = 0.05
ZIPF_EXPONENT = 1.1
QUEUED = 20
BATCHES = ("B 2048 uniform", "B 2048 zipf", "B 64", "B 8")
DTYPES = {"F32": torch.float32, "BF16": torch.bfloat16}
INVALID_BIAS = 1e30  # ops/fused_scan.py's mark of an empty position


def unit_rows(n: int, dims: int, gen: torch.Generator, device) -> torch.Tensor:
    out = torch.empty((n, dims), device=device)
    for lo in range(0, n, 1 << 18):
        x = torch.randn((min(1 << 18, n - lo), dims), generator=gen, device=device)
        out[lo : lo + x.shape[0]] = x / x.norm(dim=1, keepdim=True)
    return out


def mirror(device, seed: int = SEED) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rows [PCAP * PMAX, DIMS] f32, a, b): cosine coefficients, ~5% of
    the positions empty and the buckets past the live ones all empty."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    v = unit_rows(PCAP * PMAX, DIMS, gen, device)
    a = torch.full((PCAP * PMAX,), -1.0, device=device)
    empty = torch.rand((PCAP * PMAX,), generator=gen, device=device) < EMPTY_SHARE
    b = torch.where(empty, INVALID_BIAS, 0.0)
    b[LIVE_BUCKETS * PMAX :] = INVALID_BIAS
    return v, a, b


def batch(label: str, device, seed: int = SEED) -> tuple[torch.Tensor, torch.Tensor]:
    """(queries [B, DIMS] f32 unit rows, bsel [B] i32) of one of BATCHES."""
    rng = np.random.default_rng([seed, BATCHES.index(label)])
    nq = int(label.split()[1])
    if label.endswith("zipf"):
        w = np.arange(1, LIVE_BUCKETS + 1, dtype=np.float64) ** -ZIPF_EXPONENT
        bsel = rng.permutation(LIVE_BUCKETS)[rng.choice(LIVE_BUCKETS, size=nq, p=w / w.sum())]
    else:
        bsel = rng.integers(0, LIVE_BUCKETS, size=nq)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + BATCHES.index(label))
    return unit_rows(nq, DIMS, gen, device), torch.from_numpy(bsel.astype(np.int32)).to(device)


def median_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
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


def time_cases(partition_scan, device, reps: int = 20) -> dict[str, dict[str, float]]:
    """"dtype batch" -> {"call": ms, "queued": ms}, medians over the mirror."""
    v32, a, b = mirror(device)
    out = {}
    for name, dt in DTYPES.items():
        v = v32.to(dt)
        for label in BATCHES:
            q32, bsel = batch(label, device)
            q = q32.to(dt)

            def queued():
                for _ in range(QUEUED):
                    partition_scan(v, a, b, q, bsel, PMAX)

            out[f"{name} {label}"] = {
                "call": median_ms(lambda: partition_scan(v, a, b, q, bsel, PMAX), reps),
                "queued": median_ms(queued, max(3, reps // 4)) / QUEUED,
            }
        del v
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                        help="checkout whose vector_store_tpu_torch is timed (default: this one)")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("partition_times needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    from vector_store_tpu_torch.ops.partition_scan import partition_scan

    times = time_cases(partition_scan, torch.device("cuda", 0), args.reps)
    for case, ms in times.items():
        print(f"[partition_times] {args.root.resolve()} {case}: call {ms['call']:.4f} ms, queued {ms['queued']:.4f} ms")
    print(json.dumps({"root": str(args.root.resolve()), "device": torch.cuda.get_device_name(0), "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
