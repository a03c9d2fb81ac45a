"""The benchmark of gloc3d_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. The cell is
an entry of BENCHMARK.json's ``workloads``; its configuration, traffic mix,
limits and per-layer metrics are files under ``benchmark/`` found by name.
Prints the check's numbers beside their limits on standard error and, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``check``. Without a card it prints no result and
exits with an error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# kernel builds and caches stay in the checkout (the port builds its
# kernels into gloc3d_tpu_torch/_build/)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "benchmark", "_cache", sub)
os.environ.setdefault("USE_FLAX", "0")
# one process with one intra-op thread: the host's share of every query
# repeats far better than with a thread per core on a shared host
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
# compiled bytecode of every module this run imports, written into the
# checkout (also where the environment turns writing off) so that later
# runs of a cell do not compile torch and the port again
sys.pycache_prefix = os.path.join(ROOT, "benchmark", "_cache", "pyc")
sys.dont_write_bytecode = False
sys.path[:0] = [ROOT, HERE]


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from lbench import cell as cellmod

    t_start = cellmod.process_start()
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        _log("no NVIDIA card: torch.cuda.is_available() is False; the "
             "benchmark runs only on the card")
        return 2
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        _log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if torch.cuda.device_count() < chips[args.workload]:
        _log(f"{args.workload} needs {chips[args.workload]} cards; "
             f"torch.cuda.device_count() is {torch.cuda.device_count()}")
        return 2
    card = _power_limit()
    _log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    line = cellmod.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", t_start=t_start, log=_log)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
