"""Run one cell of the benchmark and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, ``breakdown`` (traced runs) and, last, ``checks``: each
number ``correct`` compares, with its limit. The same numbers close
standard error. Everything else the run says goes to standard error.

Exits non-zero, printing no result, where the program cannot be imported,
where CUDA or the cell's cards are missing, or where JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vector_store_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``vector_store_tpu_torch`` is neither)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi gave nothing"


def result_line(bench: dict, cell, result: dict, trace: bool, chips: int, device) -> dict:
    import torch

    from benchmark import spec, tracing

    metrics: dict = {}
    if trace:
        for m in cell.per_layer:
            value = spec.reader(m["name"])(result["traced"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec.metrics_of(bench, cell.name, "end_to_end"):
            metrics[m["name"]] = result["metrics"][m["name"]]
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": result["peak"]}
    line = {"correct": result["correct"], "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": dev}
    if trace:
        t = result["traced"]["trace"]
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = tracing.breakdown(t)
    line["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in result["checks"].items()}
    return line


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        import torch

        import vector_store_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"[bench] cannot import the program: {e}", file=sys.stderr)
        return 2
    from benchmark import cell as cell_mod
    from benchmark import spec

    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    chips = spec.by_name(bench["workloads"], args.workload, "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    print(f"[bench] {args.workload} seed {args.seed}, {args.seconds:g} s, trace {args.trace}; card: {card_line()}",
          file=sys.stderr, flush=True)
    result = asyncio.run(cell_mod.run(cell, args.seed, args.seconds, bool(args.trace), device, T_START))
    found = forbidden_modules()
    if found:
        print(f"[bench] loaded in this process: {', '.join(found)} (the run must load none)", file=sys.stderr)
        return 4
    line = result_line(bench, cell, result, bool(args.trace), chips, device)
    for name, c in line["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
