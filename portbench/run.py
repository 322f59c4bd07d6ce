"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``bayes_drt_tpu_torch``. Prints
each compared number beside its limit on standard error, then one JSON
line on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with --trace 0, its per-layer
metrics with --trace 1), ``device`` and, traced, ``breakdown``, with the
``checks`` last. Exits non-zero, printing no result, without a CUDA
device (or fewer than the cell asks for) and when ``jax``, ``jaxlib``,
``flax`` or ``bayes_drt_tpu`` were loaded by the time the window closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

FORBIDDEN = ("jax", "jaxlib", "flax", "bayes_drt_tpu")


def set_cache_dirs():
    """Every build or kernel cache inside the checkout, at fixed paths."""
    cache = ROOT / ".portbench_cache"
    for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "2")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    import torch
    from portbench import core
    cell = core.load_cell(args.workload)
    chips = int(cell.entry["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    core.log(f"card: {card_line()}; {torch.cuda.device_count()} device(s); "
             f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    out, verdict, _ = core.run(args.workload, args.seed, args.seconds,
                               args.trace, t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for line in core.check_lines(verdict, cell.limits):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    # run as a script, this file's folder leads sys.path; import the
    # harness as the package ``portbench`` from the checkout's root
    sys.path[0] = str(ROOT)
    sys.exit(main())
