"""Run one cell of the benchmark and print its result as the last line of
standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the repository's root, on a machine with the cards the cell asks for.
Without them it exits with 2 and prints no result.  ``--trace 1`` reports
the cell's per-layer metrics from an instrumented run instead of its
end-to-end metrics.  The numbers that decide ``correct`` are printed, each
beside its limit, as the last lines of standard error and under the
result's last key, ``compared``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BANNED = ("jax", "jaxlib", "flax", "emqx_tpu")


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``BANNED``, compared
    whole (``emqx_tpu_torch`` is not ``emqx_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BANNED)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(args: argparse.Namespace, device: str, root=ROOT,
            t_start: int = T_START) -> int:
    """Run the cell on ``device`` and print the result; 0 on success, 3
    when a banned module was loaded (then no result is printed)."""
    from benchmark import harness
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device=device, root=root,
                      t_start=t_start)
    found = banned_modules()
    if found:
        print("loaded modules the benchmark must not: " + ", ".join(found),
              file=sys.stderr, flush=True)
        return 3
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "?"
    except (OSError, subprocess.TimeoutExpired):
        return "?"


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from benchmark.manifest import Manifest
    chips = Manifest(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}, pid {os.getpid()}", file=sys.stderr,
          flush=True)
    return execute(args, "cuda")


if __name__ == "__main__":
    sys.exit(main())
