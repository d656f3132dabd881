"""Run one cell of the benchmark once and print its result line.

    python3 fluorobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (loading, weights and data from the
seed, warm-up of every shape the cell uses) counts as ``setup_s``; the
window then lasts ``--seconds``; ``--trace 1`` records the window with
``torch.profiler`` and reports the cell's per-layer metrics instead of its
end-to-end ones. After the window the program's results are checked
against the plain reference (``reference/``); each number compared is
printed beside its limit on the last lines of standard error and in the
result line's ``checks``. The last line of standard output is the result.

The run refuses to start without as many CUDA cards as the cell asks for,
and fails if JAX or the JAX package is loaded in this process after
set-up or after the window. A cell of several cards runs one process per
card (``ranks.py``); this process waits for them with a deadline and
prints what rank 0 reports, and fails with the rank's message when one
fails or the deadline passes. Build and kernel caches stay in ``build/``
inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def cache_env(root: Path) -> None:
    """Fixed build and kernel cache directories inside the checkout."""
    base = root / "build" / "fluorobench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(base / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env(ROOT)
    sys.path.insert(0, str(ROOT))
    import torch

    from fluorobench import harness, ranks

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("cell {} needs {} CUDA card(s); this machine has {}".format(
            cell.name, cell.chips, torch.cuda.device_count() if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    try:
        import deepfluoro_tpu_torch
    except ImportError as e:
        print("the program is not in this checkout: {}".format(e), file=sys.stderr)
        return 2
    if ROOT not in Path(deepfluoro_tpu_torch.__file__).resolve().parents:
        print("deepfluoro_tpu_torch comes from {}, not this checkout".format(deepfluoro_tpu_torch.__file__),
              file=sys.stderr)
        return 2

    print("torch and the program loaded at {:.3f} s".format(time.perf_counter() - T_START), file=sys.stderr)
    if cell.chips > 1:
        wall_start = time.time() - (time.perf_counter() - T_START)
        try:
            (report,) = ranks.launch(cell, [args.seed], args.seconds, bool(args.trace), wall_start)
        except (RuntimeError, TimeoutError) as e:
            print("cell {} failed on its {} cards: {}".format(cell.name, cell.chips, e), file=sys.stderr)
            return 1
        return harness.emit(report, elsewhere=report["forbidden"])
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device=torch.device("cuda", 0), chips=cell.chips, t_start=T_START)
    torch.cuda.reset_peak_memory_stats()
    harness.load_runner(cell).main(run)
    return harness.emit(harness.summary(run))


if __name__ == "__main__":
    sys.exit(main())
