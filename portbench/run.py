#!/usr/bin/env python3
"""The benchmark of shark_tpu_torch: one cell of BENCHMARK.json, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up makes the cell's genes and sample from the seed (cached by cell,
seed and generator in build/portbench/inputs/), builds the run's config
with the port's own command-line parser from the deployment's flags, times
the index build and the classifier's tables (index_s), and warms up with
two passes. The window then runs back-to-back passes of
shark_tpu_torch.pipeline.run_pipeline over the sample for --seconds; every
pass writes its ssv and FASTQ to /dev/null but one, chosen from the seed,
which writes files under TMPDIR. After the window the program's state is
freed, and the plain reference (portbench/reference/) indexes and
classifies the same files on the card: the compared pass must equal it
byte for byte, and every pass must write the reference's counts.

With --trace 0 the last line of standard output holds the cell's
end-to-end metrics; with --trace 1 a few seconds of the window run under
torch.profiler, and the line holds the per-layer metrics, each read by its
own file in portbench/metrics/, and the trace's breakdown.

The run needs as many CUDA cards as the cell names, and the program beside
this directory; without them it exits non-zero and prints no result.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BF_UNIT_BITS = 1 << 33  # shark's "-b" unit (argument_parser.hpp:133)
SHARK_DEFAULTS = {"-k": "17", "-c": "0.6", "-b": "1", "-q": "0"}
FORBIDDEN = ("jax", "jaxlib", "flax", "shark_tpu")
WARMUP_PASSES = 2
KEEP_INPUTS = 6  # seeds' inputs kept a cell
CHECK_LIMITS = {"ssv_lines_differ": 0, "fastq_lines_differ": 0,
                "passes_miscounted": 0}


def verdict(checks: dict) -> bool:
    """`correct`: every number compared at or under its limit."""
    return all(checks[k] <= CHECK_LIMITS[k] for k in checks)


def say(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


class Refused(Exception):
    """The run cannot measure: no card, no program, an unknown cell."""


# ---------------------------------------------------------------------------
# the cell, from BENCHMARK.json and the files it names
# ---------------------------------------------------------------------------


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    end_to_end: list
    per_layer: list

    @classmethod
    def find(cls, root: str, name: str) -> "Cell":
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise Refused(f"no cell {name!r} in BENCHMARK.json")
        w = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

        def mine(m):
            return "workloads" not in m or name in m["workloads"]

        return cls(
            name=name, chips=w["chips"],
            config=load_json(os.path.join(root, conf["file"])),
            traffic=load_json(os.path.join(HERE, "traffic",
                                           w["traffic"] + ".json")),
            end_to_end=[m for m in bench["end_to_end"] if mine(m)],
            per_layer=[m for m in bench["per_layer"] if mine(m)])

    @property
    def paired(self) -> bool:
        return self.traffic["layout"] == "paired"

    def shark_params(self) -> dict:
        """k, c, filter bits, -q and -s of the deployment's flags, by
        shark's documented defaults where a flag is absent."""
        flags = self.config["flags"]
        val = dict(SHARK_DEFAULTS)
        for i, f in enumerate(flags):
            if f in val:
                val[f] = flags[i + 1]
        return {"k": int(val["-k"]), "c": float(val["-c"]),
                "size_bits": int(val["-b"]) * BF_UNIT_BITS,
                "min_quality": int(val["-q"]), "single": "-s" in flags}


def inputs(cell: Cell, seed: int, cache: str) -> dict:
    """The cell's FASTA and FASTQ for `seed`, made once and kept under
    `cache` (the newest KEEP_INPUTS seeds a cell); "written" gives the
    bytes written when they were made now."""
    from portbench import generate

    with open(generate.__file__, "rb") as f:
        digest = hashlib.sha1(
            json.dumps([cell.config["genes"], cell.traffic], sort_keys=True)
            .encode() + f.read()).hexdigest()[:12]
    base = os.path.join(cache, cell.name)
    d = os.path.join(base, f"{seed}-{digest}")
    stamp = os.path.join(d, "done")
    fq = [os.path.join(d, "reads_1.fq")] + (
        [os.path.join(d, "reads_2.fq")] if cell.paired else [])
    paths = {"fasta": os.path.join(d, "genes.fa"), "fastq": fq}
    if os.path.exists(stamp):
        os.utime(stamp)
        return paths
    shutil.rmtree(d, ignore_errors=True)
    generate.write_inputs(d, cell.config, cell.traffic, seed)
    open(stamp, "w").close()
    paths["written"] = sum(os.path.getsize(f)
                           for f in [paths["fasta"], *paths["fastq"]])
    kept = sorted((e for e in os.listdir(base)
                   if os.path.exists(os.path.join(base, e, "done"))),
                  key=lambda e: -os.path.getmtime(
                      os.path.join(base, e, "done")))
    for e in kept[KEEP_INPUTS:]:
        shutil.rmtree(os.path.join(base, e), ignore_errors=True)
    return paths


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


def program_config(cell: Cell, paths: dict, out: dict):
    """The run's SharkConfig through the port's own parser: the
    deployment's flags, every other flag at the port's default."""
    from shark_tpu_torch import cli

    argv = ["-r", paths["fasta"], "-1", paths["fastq"][0]]
    if cell.paired:
        argv += ["-2", paths["fastq"][1], "-p", out["2"]]
    argv += [*cell.config["flags"], "-o", out["1"], "--ssv", out["ssv"]]
    return cli.config_from_args(cli.build_parser().parse_args(argv))


def make_classifier(cfg, index, device):
    """The classifier run_pipeline builds for a one-card `cfg`."""
    from shark_tpu_torch import pipeline
    from shark_tpu_torch.classify.step import Classifier

    if cfg.sharded_bf or cfg.devices > 1:
        raise Refused("the harness runs one-card configurations only")
    return Classifier(index, max_winners=cfg.max_winners, c=cfg.c,
                      device=device,
                      probe=None if cfg.probe == "auto" else cfg.probe,
                      probe_opts=pipeline._probe_opts(cfg))


class Quiet:
    """The program's phase lines (a handful a pass) go here, not to the
    run's standard error; the last pass's are shown after the window."""

    def __init__(self):
        self.last = ""

    @contextlib.contextmanager
    def __call__(self):
        buf = io.StringIO()
        with contextlib.redirect_stderr(buf):
            yield
        self.last = buf.getvalue()


def synchronize(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader gets: the cell, the run's config,
    the classifier (until the program's state is freed), set-up times,
    every pass of the window, the profiled part and its trace."""

    cell: Cell
    cfg: object
    device: object
    clf: object = None
    setup: dict = dataclasses.field(default_factory=dict)
    passes: list = dataclasses.field(default_factory=list)
    trace: dict = None
    launches: dict = None
    paths: dict = None
    sample: object = None  # the reference's parse of the sample
    measured: dict = dataclasses.field(default_factory=dict)

    @property
    def window_passes(self):
        return [p for p in self.passes if not p["warmup"]]

    @property
    def read_len(self) -> int:
        s = self.passes[-1]["stats"]
        return s.get("auto_max_read_len") or self.cfg.max_read_len


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def window(ctx: Context, seconds: float, compare_at: int, out_dir: str,
           trace: bool, quiet: Quiet) -> None:
    """Back-to-back passes for `seconds`; pass `compare_at` writes its
    outputs under `out_dir`. With `trace`, a steady stretch of passes
    after the first third runs under torch.profiler (started once in
    set-up, so that its first start's cost does not land in the window);
    the window does not close while it runs."""
    import torch
    from shark_tpu_torch import kernels
    from shark_tpu_torch.pipeline import run_pipeline

    cfg, clf = ctx.cfg, ctx.clf
    files = {"ssv_path": os.path.join(out_dir, "out.ssv"),
             "out1_path": os.path.join(out_dir, "out_1.fq")}
    if ctx.cell.paired:
        files["out2_path"] = os.path.join(out_dir, "out_2.fq")
    prof = None
    prof_at, prof_len = seconds / 3, max(1.0, min(3.0, seconds / 4))
    w0 = time.perf_counter()
    i = 0
    while True:
        now = time.perf_counter() - w0
        if trace and prof is None and ctx.trace is None and now >= prof_at:
            synchronize(ctx.device)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if str(ctx.device).startswith("cuda"):
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            kernels.LAUNCHES.reset()
            prof.__enter__()
            p0 = time.perf_counter()
        run_cfg = dataclasses.replace(cfg, **files) if i == compare_at else cfg
        t = time.perf_counter()
        with quiet():
            stats = run_pipeline(run_cfg, classifier=clf)
        dt = time.perf_counter() - t
        ctx.passes.append({"stats": stats, "seconds": dt, "warmup": False,
                           "compared": i == compare_at,
                           "profiled": prof is not None})
        i += 1
        if prof is not None and time.perf_counter() - p0 >= prof_len:
            ctx.trace = stop_profile(prof, ctx)
            prof = None
        if (prof is None and i > compare_at
                and time.perf_counter() - w0 >= seconds):
            break
    ctx.setup["window_s"] = time.perf_counter() - w0
    if prof is not None:
        ctx.trace = stop_profile(prof, ctx)


def stop_profile(prof, ctx: Context) -> dict:
    from portbench import trace as trace_mod
    from shark_tpu_torch import kernels

    synchronize(ctx.device)
    prof.__exit__(None, None, None)
    ctx.launches = kernels.LAUNCHES.snapshot()
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        ctx.setup["trace_bytes"] = os.path.getsize(path)
        return trace_mod.summarize(trace_mod.load(path))
    finally:
        os.remove(path)


# ---------------------------------------------------------------------------
# the comparison with the reference
# ---------------------------------------------------------------------------


def lines_differ(got: bytes, want: bytes) -> int:
    """Lines at which two texts differ, position by position, plus the
    difference of their line counts."""
    if got == want:
        return 0
    a, b = got.split(b"\n"), want.split(b"\n")
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def reference(cell: Cell, paths: dict, device, canonical: bool = True):
    """The reference's (index, sample, reads, genes) of the cell's files;
    `canonical=False` gives the control."""
    from portbench.reference import shark as ref

    p = cell.shark_params()
    return ref.run(paths["fasta"], paths["fastq"], p["k"], p["c"],
                   p["size_bits"], p["min_quality"], p["single"], device,
                   canonical=canonical)


def checks(want, got_ssv: bytes, got_fastq: list, counts: list) -> dict:
    """The numbers compared: the ssv and FASTQ lines of a pass that differ
    from the reference's (`want`: its index, sample, reads, genes), and
    the passes whose (associations, reads out) differ from its counts."""
    from portbench.reference import shark as ref

    index, sample, reads, genes = want
    ssv, fastq = ref.render(index, sample, reads, genes)
    n = (len(reads), len(set(reads.tolist())))
    return {"ssv_lines_differ": lines_differ(got_ssv, ssv),
            "fastq_lines_differ": sum(lines_differ(g, w)
                                      for g, w in zip(got_fastq, fastq)),
            "passes_miscounted": sum(tuple(c) != n for c in counts)}


def compare(cell: Cell, ctx: Context, out_dir: str, device) -> dict:
    """The checks of the window: its compared pass's files and every
    pass's counts against the reference."""
    t = time.perf_counter()
    want = reference(cell, ctx.paths, device)
    ctx.sample = want[1]
    say(f"reference: {len(want[2])} associations, "
        f"{len(set(want[2].tolist()))} reads out of {len(want[1])}, in "
        f"{time.perf_counter() - t:.1f} s")

    def read(name):
        with open(os.path.join(out_dir, name), "rb") as f:
            return f.read()

    fastq = [read(o) for o in ("out_1.fq", "out_2.fq")[:len(want[1].mates)]]
    counts = [(q["stats"]["n_associations"], q["stats"]["n_reads_out"])
              for q in ctx.window_passes]
    return checks(want, read("out.ssv"), fastq, counts)


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def device_info(device, chips: int) -> dict:
    import torch

    if not str(device).startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips))}


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def host_speed_ms() -> float:
    """The time a fixed single-threaded CPU job takes (three sorts of the
    same 2^20 integers): the host's speed at that moment, beside the
    window, where /proc/stat and /proc/loadavg read zero, as they can in
    a sandboxed machine."""
    import numpy as np

    x = np.random.default_rng(0).integers(0, 1 << 62, size=1 << 20)
    t = time.perf_counter()
    for _ in range(3):
        np.sort(x)
    return 1e3 * (time.perf_counter() - t)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def quantile(values, q: float) -> float:
    """The q-quantile, inclusive method (q in (0, 1))."""
    if len(values) == 1:
        return values[0]
    n = 100
    return statistics.quantiles(values, n=n, method="inclusive")[
        round(q * n) - 1]


def run(args, allow_cpu: bool = False) -> dict:
    cell = Cell.find(ROOT, args.workload)
    import torch

    if allow_cpu:
        device = "cpu"
    else:
        if not torch.cuda.is_available():
            raise Refused("no CUDA card: the benchmark measures the card "
                          "and does not fall back to the CPU")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"{cell.name} needs {cell.chips} cards, "
                          f"{torch.cuda.device_count()} present")
        device = "cuda:0"
    try:
        import shark_tpu_torch
    except ImportError as e:
        raise Refused(f"the program shark_tpu_torch is not beside "
                      f"portbench/: {e}")
    if not os.path.abspath(shark_tpu_torch.__file__).startswith(ROOT + os.sep):
        raise Refused(f"shark_tpu_torch comes from {shark_tpu_torch.__file__}"
                      f", not from {ROOT}")
    from shark_tpu_torch import kernels
    from shark_tpu_torch.io import native
    from shark_tpu_torch.pipeline import load_or_build_index, run_pipeline
    from shark_tpu_torch.utils.timers import PhaseTimer

    quiet = Quiet()
    # kernels, engine and CUDA context before any timed part: only a
    # checkout's first run builds them
    if native.get_lib() is None:
        raise RuntimeError("the program's C++ engine does not build")
    if device != "cpu":
        kernels.lib()
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats()
        if args.trace:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]):
                torch.ones(1, device=device).sum().item()
    t = time.monotonic()
    paths = inputs(cell, args.seed, os.path.join(ROOT, "build", "portbench",
                                                 "inputs"))
    gen_s = time.monotonic() - t
    cfg = program_config(cell, paths, {"ssv": os.devnull, "1": os.devnull,
                                       "2": os.devnull})
    ctx = Context(cell=cell, cfg=cfg, device=device, paths=paths)
    t = time.perf_counter()
    with quiet():
        index = load_or_build_index(cfg, PhaseTimer())
    t_index = time.perf_counter()
    with quiet():
        ctx.clf = make_classifier(cfg, index, device)
    synchronize(device)
    t_tables = time.perf_counter()
    table = getattr(getattr(ctx.clf, "dix", None), "table", None)
    ctx.setup.update(index_build_s=t_index - t,
                     index_tables_s=t_tables - t_index,
                     index_s=t_tables - t, inputs_s=gen_s,
                     layout=getattr(ctx.clf, "probe", None),
                     table_rows=None if table is None else table.shape[0])
    for _ in range(WARMUP_PASSES):
        with quiet():
            stats = run_pipeline(cfg, classifier=ctx.clf)
        ctx.passes.append({"stats": stats, "seconds": None, "warmup": True})
    ctx.setup["setup_s"] = time.monotonic() - T0
    say(f"set-up {ctx.setup['setup_s']:.2f} s (inputs {gen_s:.2f}, index "
        f"{ctx.setup['index_build_s']:.2f}, tables "
        f"{ctx.setup['index_tables_s']:.2f}); probe layout "
        f"{getattr(ctx.clf, 'probe', '?')}, {index.n_genes} genes")

    compare_at = args.seed % 5
    out_dir = tempfile.mkdtemp(prefix="portbench-")
    try:
        host = host_speed_ms()
        window(ctx, args.seconds, compare_at, out_dir, args.trace, quiet)
        ctx.setup["host"] = (
            f"host speed: a fixed CPU job took {host:.1f} ms before the "
            f"window, {host_speed_ms():.1f} ms after")
        dev = device_info(device, cell.chips)
        for line in quiet.last.strip().splitlines()[-6:]:
            say(f"program (last pass): {line}")
        readers = {m["name"]: load_reader(m["name"])
                   for m in cell.per_layer} if args.trace else {}
        for r in readers.values():
            if hasattr(r, "measure"):
                r.measure(ctx)
        ctx.clf = None
        del index
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
        checks = compare(cell, ctx, out_dir, device)
        ctx.setup["compared_bytes"] = sum(
            os.path.getsize(os.path.join(out_dir, f))
            for f in os.listdir(out_dir))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    passes = ctx.window_passes
    ms = [1e3 * p["seconds"] for p in passes]
    n_reads = sum(p["stats"]["n_reads"] for p in passes)
    deciles = " ".join(f"{q:.0f}" for q in (
        statistics.quantiles(ms, n=10) if len(ms) > 1 else ms))
    say(f"window {ctx.setup['window_s']:.3f} s: {len(passes)} passes of "
        f"{passes[0]['stats']['n_reads']} reads, pass ms median "
        f"{statistics.median(ms):.1f}, deciles {deciles}, max "
        f"{max(ms):.1f}; compared pass "
        f"{compare_at}; profiled passes "
        f"{sum(p['profiled'] for p in passes)}")
    say(ctx.setup["host"])
    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            v = readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"reads_per_s": n_reads / ctx.setup["window_s"],
               "sample_ms_p95": quantile(ms, 0.95),
               "index_s": ctx.setup["index_s"],
               "setup_s": ctx.setup["setup_s"]}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    failed = checks["passes_miscounted"]
    result = {"correct": verdict(checks),
              "attempted": len(passes), "failed": failed,
              "metrics": metrics, "device": dev}
    if args.trace and ctx.trace is not None:
        dev["busy_s"] = ctx.trace["busy_s"]
        dev["window_s"] = ctx.trace["window_s"]
        result["breakdown"] = {"device_ops": ctx.trace["by_op"],
                               "idle_gaps": ctx.trace["idle_gaps"]}
    result["written"] = {"inputs": paths.get("written", 0),
                         "compared_pass": ctx.setup["compared_bytes"],
                         "trace": ctx.setup.get("trace_bytes", 0)}
    result["checks"] = {k: {"value": v, "limit": CHECK_LIMITS[k]}
                        for k, v in checks.items()}
    return result


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, allow_cpu: bool = False) -> int:
    """`allow_cpu` runs the cell on the CPU with the kernels' plain
    versions: a rehearsal for tests, never a measurement."""
    args = parse_args(argv)
    try:
        result = run(args, allow_cpu)
    except Refused as e:
        say(f"refused: {e}")
        return 2
    except Exception:  # noqa: BLE001 - any failure: no result, non-zero
        traceback.print_exc()
        return 1
    written = result.pop("written")
    bad = forbidden_modules()
    if bad:
        say(f"refused: the process loaded {', '.join(bad)}")
        return 3
    try:
        with open("/proc/self/io") as f:
            io_stats = dict(line.split(": ") for line in f.read().splitlines())
        calls = io_stats["wchar"]
    except (OSError, KeyError):
        calls = "not read"
    files = written
    say(f"bytes written to files by this run: {sum(files.values())} "
        f"({', '.join(f'{k} {v}' for k, v in files.items())}); through "
        f"write calls, /dev/null included: {calls}")
    say(f"card: {power_limit()}" if not allow_cpu else "card: none (CPU)")
    for k, v in result["checks"].items():
        say(f"check {k} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
