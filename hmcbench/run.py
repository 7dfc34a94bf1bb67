"""Run one cell of the benchmark of `advancedhmc_torch` once.

    python3 hmcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in `BENCHMARK.json` names its
configuration (`hmcbench/configs/<config>.json`) and the harness reads its
traffic, the sampling job and its parameters, from
`hmcbench/workloads/<cell>.json`; the job's driver is
`hmcbench/jobs/<job>.py`, each metric's reader `hmcbench/metrics/<metric>.py`,
and the configuration's plain reference `hmcbench/reference/<model>.py`.
All are found by name, so a new configuration, cell, job or metric is a new
file and an entry in `BENCHMARK.json`.

The run makes its data from the configuration's data seed, warms every
shape the job uses on throwaway state (set-up), then times one whole
sampling job (warmup and draws) until the first draw-call boundary after
`--seconds`; the job's warmup starts from the same points and stream in
every run, and `--seed` seeds the draws' stream. After the window it reads
the peak memory, frees the program's state, takes the ESS and checks the
window's output, and a draw step that the job followed after it, against
the float64 reference. The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics with `--trace 0`, its per-layer metrics with
`--trace 1`), `device` (and with `--trace 1` `breakdown`), and last
`checks`, each compared number beside its limit, which also end standard
error. It exits non-zero without a result when there is no CUDA card (or
fewer than the cell asks for), and when `jax`, `jaxlib`, `flax` or
`advancedhmc_tpu` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "advancedhmc_tpu")
# build and kernel caches at fixed paths inside the checkout
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
             "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


def forbidden_modules(modules=None) -> list:
    """Top-level names in `modules` (sys.modules) that are JAX's or the JAX
    package's, compared whole: `advancedhmc_torch` is not `advancedhmc_tpu`."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def load_module(path: Path):
    """A module from a file of the benchmark, found by name."""
    spec = importlib.util.spec_from_file_location(
        f"hmcbench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A cell of BENCHMARK.json with its configuration and traffic files,
    and the metrics that it reports."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def find(cls, bench: dict, name: str, root: Path = ROOT):
        entries = [w for w in bench["workloads"] if w["name"] == name]
        if not entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        entry = entries[0]

        def reported(m):
            return "workloads" not in m or name in m["workloads"]

        return cls(
            name=name, entry=entry,
            config=load_json(root / "hmcbench" / "configs"
                             / f"{entry['config']}.json"),
            traffic=load_json(root / "hmcbench" / "workloads"
                              / f"{name}.json"),
            end_to_end=[m for m in bench["end_to_end"] if reported(m)],
            per_layer=[m for m in bench["per_layer"] if reported(m)])


@dataclasses.dataclass
class Env:
    """What a job driver gets: the program, its target, the traffic, the
    seed, the window's length and the tracer. `open_window()` ends set-up
    and returns the window's start."""

    ah: object
    target: object
    dim: int
    traffic: dict
    seed: int
    seconds: float
    device: str
    tracer: object
    t_start: float
    setup_s: float = None

    def sync(self):
        import torch

        if self.device != "cpu":
            torch.cuda.synchronize()

    def open_window(self) -> float:
        self.sync()
        t0 = time.perf_counter()
        self.setup_s = t0 - self.t_start
        return t0


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _merge(base: dict, over) -> dict:
    return {**base, **(over or {})}


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", chips: int = 1, control: bool = False,
             overrides: dict = None, root: Path = ROOT,
             t_start: float = None, log=print) -> dict:
    """Run cell `name` once and return its result line as a dict.
    `overrides` ({"config": {...}, "traffic": {...}}) replace entries of
    the cell's files (the CPU tests run a cell at a tiny size); `control`
    runs the program in the configuration's lower-precision control
    (`control_args`), against the same reference."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell.find(bench, name, root)
    cfg = _merge(cell.config, (overrides or {}).get("config"))
    traffic = _merge(cell.traffic, (overrides or {}).get("traffic"))
    if device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    import advancedhmc_torch as ah

    from hmcbench.trace import Tracer

    tracer = Tracer(trace and device != "cpu")
    program_args = _merge(cfg["program_args"],
                          cfg["control_args"] if control else None)
    target = getattr(ah, cfg["model"])(
        **program_args, dtype=getattr(torch, cfg["dtype"]), device=device)
    env = Env(ah=ah, target=tracer.wrap_target(target),
              dim=cfg["n_features"] + 1, traffic=traffic, seed=seed,
              seconds=seconds, device=device, tracer=tracer, t_start=t_start)
    job = load_module(root / "hmcbench" / "jobs" / f"{traffic['job']}.py")
    rec = job.run(env)
    peak = rec.pop("memory_peak_bytes")   # read at the window's close
    del env, target, job
    final, blocks = rec.pop("final"), rec.pop("ess_blocks")
    step = rec.pop("check_step")
    draws = torch.cat(blocks)
    del blocks
    if device != "cpu":
        torch.cuda.empty_cache()

    from hmcbench.reference.check import compare, passed
    from hmcbench.reference.ess import effective_sample_size

    rec.update(config=cfg, traffic=traffic, stretch=tracer.stretch,
               ess=effective_sample_size(draws).cpu() * rec["ess_scale"])
    ref = load_module(root / "hmcbench" / "reference"
                      / f"{cfg['model']}.py").Reference(cfg, device)
    checks, unheld = compare(ref, final, draws, traffic["limits"], step)
    n_bad = int((~torch.isfinite(final[0])).any(-1).sum())
    del final, draws, ref, step

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module(root / "hmcbench" / "metrics"
                            / f"{m['name']}.py").read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info = {k: rec[k] for k in ("setup_s", "window_s", "warmup_s", "draws",
                                "calls")}
    info["memory_peak_bytes"] = int(peak)
    log(f"# {name} seed {seed}: " + json.dumps(
        {**info, **rec["info"], "not_compared": unheld}), file=sys.stderr)
    dev = {"platform": "cpu" if device == "cpu" else "gpu",
           "kind": ("cpu" if device == "cpu"
                    else torch.cuda.get_device_name(0)),
           "count": chips, "memory_peak_bytes": int(peak)}
    if device != "cpu":
        dev["power_limit"] = power_limit()
    out = {"correct": passed(checks), "attempted": int(rec["draws"]),
           "failed": n_bad, "metrics": metrics, "device": dev}
    if trace and tracer.stretch is not None:
        dev["busy_s"] = tracer.stretch["busy_s"]
        dev["window_s"] = tracer.stretch["window_s"]
        out["breakdown"] = {k: tracer.stretch[k]
                            for k in ("device_ops", "idle_gaps")}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v!r} limit {lim!r} "
            f"{'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="run the configuration's lower-precision control "
                        "(not part of the benchmark's runs)")
    args = p.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = Cell.find(bench, args.workload).entry["chips"]
    for key, sub in CACHE_ENV.items():
        os.environ[key] = str(ROOT / "hmcbench_cache" / sub)
    # one process with few threads: the host's cores are shared, and the
    # eager loops issue their launches from one Python thread
    os.environ["OMP_NUM_THREADS"] = "1"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hmcbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), chips=chips, control=args.control,
                   t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"hmcbench: loaded in this process: {found}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
