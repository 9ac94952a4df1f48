"""One run of one benchmark cell of the PyTorch/CUDA port.

    python -m ltbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. One process,
one run: it makes weights and avatars from the seed on the card, loads the
program (``livetalking_tpu_torch``) and opens the cell's sessions as the
server does, warms every shape the traffic uses, measures for ``--seconds``
(with ``--trace 1``, under ``torch.profiler`` from before the sessions
render to just after the window), checks a sample of the window's frames against the plain
reference, and prints one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and, traced, ``breakdown``; last, under
``compared``, each number the check compared with its limit (also the last
lines of standard error).

What is model-specific (weights, loading, serving, the traffic loop, the check,
the work counts) is the configuration's family's: ``ltbench/families/``.
The control runs and the knee sweep are ``ltbench/calibrate.py``'s.

Exits 2 without a result when CUDA is not available or has fewer devices
than the cell needs, and 3 when a JAX module or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Callable, List, Optional  # noqa: E402


def parse(argv=None, parser: argparse.ArgumentParser = None) -> argparse.Namespace:
    p = parser or argparse.ArgumentParser(prog="python -m ltbench.run",
                                          description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fixed_caches(root: str) -> None:
    """Kernel and compiler caches at fixed paths inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build", "torch_extensions")
    os.environ["USE_FLAX"] = "0"


@dataclasses.dataclass
class RunData:
    """What a metric reader reads."""
    cell: dict
    cfg: dict
    mix: dict
    obs: object
    setup_s: float
    work: dict           # program counter -> the operations of one unit of it
    trace: object = None


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(args, root: str, device: str = "cuda", edit: Callable = None,
             t_process: float = T_PROCESS) -> tuple:
    """Everything but the device check and the output; returns the result
    and what the metric readers read. ``edit(cfg, mix, family)`` returns the
    configuration and mix to run instead (calibration runs only)."""
    import torch

    from ltbench.spec import Spec, read_metrics
    from ltbench.trace import Tracer

    spec = Spec(root)
    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    fam = spec.family(cfg["family"])
    if edit is not None:
        cfg, mix = edit(cfg, mix, fam)
    cuda = device == "cuda"
    phases = {}

    def phase(name):
        if cuda:
            torch.cuda.synchronize()
        phases[name] = time.perf_counter() - t_process

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state = fam.setup(cfg, mix, args.seed, device, phase)
    tracer = Tracer(device) if args.trace else None
    with fam.serving(state) as served:
        phase("sessions")
        obs = fam.window(served, state, mix, args.seed, args.seconds, tracer)
    setup_s = obs.t0 - t_process
    phases["window"] = setup_s
    phases["after_window"] = time.perf_counter() - t_process
    mem = int(torch.cuda.max_memory_allocated()) if cuda else 0
    del served
    fam.release(state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if tracer is not None and tracer.started:
        obs.trace = tracer.reduce()
    numbers = fam.compare(state, obs, args.seed)
    phase("check")
    print("ltbench set-up and check (s from process start): "
          + " ".join(f"{k}={v:.2f}" for k, v in phases.items()), file=sys.stderr)
    run = RunData(cell, cfg, mix, obs, setup_s, fam.work(cfg), obs.trace)
    attempted, failed = fam.tally(obs)
    result = {
        "correct": all(v["limit"] is None or v["value"] <= v["limit"] for v in numbers.values()),
        "attempted": attempted,
        "failed": failed,
        "metrics": read_metrics(spec, cell["name"], bool(args.trace), run),
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": mem},
    }
    if obs.trace is not None:
        result["device"].update(busy_s=obs.trace.busy_s, window_s=obs.trace.window_s)
        result["breakdown"] = obs.trace.breakdown
    result["card"] = _power_limit() if cuda else None
    result["compared"] = numbers
    return result, run


def emit(result: dict) -> None:
    """The compared numbers as the last lines of standard error, and the
    result, with ``compared`` its last key, as the last line of standard
    output."""
    result["compared"] = result.pop("compared")
    for name, v in result["compared"].items():
        print(f"compared {name}={v['value']!r} limit={v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv: List[str] = None, args: argparse.Namespace = None, edit: Callable = None,
         extra: Callable = None) -> int:
    """One run of a cell. ``edit`` and ``extra(result, run)`` (which adds
    keys to the result) are ``ltbench/calibrate.py``'s."""
    args = args or parse(argv)
    root = os.getcwd()
    fixed_caches(root)
    import torch

    from ltbench import guard
    from ltbench.spec import Spec

    chips = int(Spec(root).cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ltbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result, run = run_cell(args, root, edit=edit)
    bad = guard.forbidden_modules()
    if bad:
        print(f"ltbench: forbidden modules loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    if extra is not None:
        extra(result, run)
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
