"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python -m portbench.run  --workload <cell> ...

Prints the result as one JSON line, last on standard output, and the
compared numbers beside their limits last on standard error. Exits non-zero,
printing no result, without a CUDA device, when the cell asks for more
cards than there are, or when a module of JAX or of the JAX package is
loaded once the window has closed. README.md says what it measures.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / "cache"


def _environment() -> None:
    """Kernel caches at fixed paths inside the checkout (the program's own
    library builds into rayfinder_tpu_torch/_build/), and one host thread
    for the CPU's math libraries: the load is one process with few threads,
    so that the host's share of a frame varies less from run to run."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[name] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    from portbench import cells, harness

    bench = cells.benchmark(ROOT)
    cell = cells.find(args.workload, bench)
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    line = harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_PROCESS)
    found = harness.banned_modules()
    if found:
        print(f"portbench: loaded in the process that reports: {', '.join(found)}",
              file=sys.stderr)
        return 3
    harness.print_line(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
