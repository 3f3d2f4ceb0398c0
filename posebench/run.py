"""Run one cell of the benchmark once and print its result line.

    python3 posebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic, limits and per-layer readers are
found by name from BENCHMARK.json at the root of the checkout (see
posebench/README.md). With --trace 0 the line holds the cell's end-to-end
metrics, with --trace 1 its per-layer metrics, the device's busy and window
seconds and the breakdown. Exits non-zero with no result line when torch
finds fewer CUDA devices than the cell asks for.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def set_caches() -> None:
    """Build and kernel caches at fixed places inside the checkout (the
    port's own kernels build into build/hyperpose_torch beside it), and no
    JAX through a library that could load it."""
    cache = ROOT / "build" / "posebench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def power_line() -> None:
    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        print(f"card: {got.stdout.strip()}", file=sys.stderr, flush=True)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"card: nvidia-smi unavailable ({e})", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None,
                    help="run the cell's control (the configuration's lower-precision path) "
                         "in the program's place; for the control's readings, not the benchmark")
    args = ap.parse_args(argv)
    set_caches()
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    import torch
    print(f"import torch {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
    # The program works on the card; few host threads keep the host's load,
    # and so the runs, steady.
    torch.set_num_threads(2)

    from posebench import harness

    cell = harness.Cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"posebench: {args.workload} needs {cell.chips} CUDA device(s); torch finds "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    t0 = time.perf_counter()
    power_line()
    print(f"nvidia-smi {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                            args.control)
    if line is None:
        return 4
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
