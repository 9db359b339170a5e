#!/usr/bin/env python3
"""Benchmark of tpu_gnss_torch on one NVIDIA card: capture replay.

    python3 gnss_bench/run.py --workload <cell> --seed <n> --seconds <s>
                              --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the capture format, the receiver's settings, the gates and the limits of
the comparison) and a traffic mix (``traffic/<name>.json``: the capture
length, how many distinct captures a run writes, the sample compared).
Set-up makes the captures on the card from ``--seed`` (``gen/``), writes
them under ``$TMPDIR`` (with a warm start, a previous session's
checkpoint beside them), and runs untimed captures of the cell's own
shape.  The window is a closed loop of ``streams`` threads in the one
process: each stream runs a new ``tpu_gnss_torch.receiver.Receiver`` per
capture and ``process_source`` over its next capture file, cold or
restarted from the checkpoint, and starts captures until ``--seconds``
are used up.
After the window a sample of captures drawn from the seed is compared
with the plain reference (``ref/check.py``); every capture is held to its
configuration's gates, and one that misses them or raises counts in
``failed``.  The last line of standard output is the result's JSON.

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` runs
a fixed number of whole captures in the middle of the window under
``torch.profiler`` and reports the per-layer metrics (``metrics/<name>.py``)
with the device's busy time and a breakdown.  Nothing here imports JAX
or the JAX package; the run ends non-zero if either was loaded.
"""

from __future__ import annotations

import time

_T_PERF = time.perf_counter()

import argparse
import gc
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_gnss")
STAGES = ("receiver.read", "receiver.transfer", "receiver.acquire",
          "receiver.track", "receiver.fetch", "receiver.drain",
          "receiver.nav", "receiver.solve")
# a failed capture counts as infinitely late; JSON has no infinity
LATE_MS = 1e12
# what a traffic mix may set: every key is read, and one that is not
# listed here is refused rather than left unheeded
TRAFFIC_KEYS = {"capture_s", "distinct", "max_written_mb", "warm_captures",
                "sample", "fix", "traced_captures", "start", "streams",
                "sky"}
# how a capture starts: from nothing, or from a previous session's
# checkpoint (``run_receiver --warm-start``)
STARTS = ("cold", "warm")
# the sky a capture carries: the e2e scene's orbits, which take no
# account of the Earth, or the same turned above the truth position's
# horizon (``gen/scene.visible_constellation``)
SKIES = ("e2e", "visible")
# the harness's own clock around a warm start's checkpoint load and
# visibility prediction (``Captures.warm_args``), beside the stage timers
WARM_STAGE = "gnss_bench.warm_start"
# a configuration's loop settings; the program takes the first four as
# options and fixes the last two itself (see ``unheeded``)
LOOP_KEYS = {"pll_bn_hz", "dll_bn_hz", "epochs_per_step", "chunk_s",
             "fll_bn_hz", "corr_spacing"}


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of
    its start (clock ticks since boot), else since this module loaded."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_PERF


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def checkout_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    and no library loading JAX by itself."""
    os.environ["TPU_GNSS_TORCH_CACHE_DIR"] = os.path.join(
        ROOT, "build", "tpu_gnss_torch")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["USE_FLAX"] = "0"


def finite(v):
    """``v``, or None where JSON has no number for it."""
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(workload: str) -> tuple[dict, dict, dict, dict]:
    """``(cell, config, traffic, manifest)`` of a workload name."""
    manifest = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"gnss_bench: no workload {workload!r}; have "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    cfg = load_json(ROOT, conf["file"])
    traffic = load_json(HERE, "traffic", cell["traffic"] + ".json")
    for what, got, want in (("traffic " + cell["traffic"], traffic,
                             TRAFFIC_KEYS),
                            (conf["name"] + " loop", cfg["loop"], LOOP_KEYS)):
        if set(got) != want:
            raise SystemExit(f"gnss_bench: {what} has keys {sorted(got)}; "
                             f"the harness reads exactly {sorted(want)}")
    n = traffic["streams"]
    if (traffic["start"] not in STARTS or traffic["sky"] not in SKIES
            or isinstance(n, bool) or not isinstance(n, int) or n < 1):
        raise SystemExit(f"gnss_bench: traffic {cell['traffic']} has start "
                         f"{traffic['start']!r}, sky {traffic['sky']!r} and "
                         f"streams {n!r}; start is one of {STARTS}, sky one "
                         f"of {SKIES}, streams a whole number >= 1")
    return cell, cfg, traffic, manifest


def reader(name: str):
    """The ``read(ctx)`` of per-layer metric ``name``
    (``metrics/<name>.py``)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "gnss_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def nearest_rank(values, q: float) -> float:
    """The ``q``-quantile of ``values`` by nearest rank (a value that
    occurred)."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def receiver_config(cfg: dict):
    from tpu_gnss_torch.config import ReceiverConfig
    return ReceiverConfig(fs=cfg["fs"], fc=cfg["fc"], max_fo=cfg["max_fo"],
                          fft_len=cfg["fft_len"],
                          snr_threshold=cfg["snr_threshold"],
                          num_chans=cfg["num_chans"],
                          prns=tuple(cfg["prns"]))


def write_checkpoint(plan, path: str) -> None:
    """A previous session's checkpoint of the scene of ``plan``, as the
    port's ``utils.checkpoint.save_state`` writes it: each satellite's
    ephemeris as the ICD quantizes it (``ref/check.quantized``), an
    almanac of the same orbits reduced from it (health 0), and the last
    fix at the scene's position at the receiver time of a capture's first
    sample, with no wall time, so that nothing ages with the host's
    clock."""
    from tpu_gnss_torch.nav.almanac import Almanac
    from tpu_gnss_torch.nav.ephemeris import Ephemeris
    from tpu_gnss_torch.utils.checkpoint import save_state

    from gnss_bench.gen import scene
    from gnss_bench.ref import check
    ephs = {sv.prn: Ephemeris(**check.quantized(sv.eph)) for sv in plan.svs}
    alms = {prn: Almanac.from_ephemeris(prn, e) for prn, e in ephs.items()}
    save_state(path, ephemerides=ephs, almanac=alms,
               meta=dict(last_fix=dict(ecef=[float(v) for v in plan.rx],
                                       tow=scene.T_RX0)))


def warm_start(path: str) -> dict:
    """``process_source``'s warm arguments from the checkpoint at
    ``path``, as ``cli/run_receiver._warm_start`` makes them: the saved
    ephemerides, and the PRNs that the almanac predicts above a 5 degree
    mask from the last fix at its TOW, over the next 30 minutes."""
    from tpu_gnss_torch.nav.almanac import visible_prns
    from tpu_gnss_torch.utils.checkpoint import load_state
    state = load_state(path, device="cpu")
    last = state["meta"]["last_fix"]
    return dict(warm_ephemerides=state["ephemerides"],
                search_prns=visible_prns(state["almanac"], last["ecef"],
                                         float(last["tow"]), mask_deg=5.0,
                                         margin_s=1800.0))


class Captures:
    """The run's captures: made on ``device`` from the seed, written
    under ``tmp``, and removed by :meth:`close`."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 tmp: str):
        import numpy as np
        import torch

        from gnss_bench.gen import scene
        from gnss_bench.ref import check
        self.cfg, self.dir = cfg, tmp
        fs, dur = cfg["fs"], traffic["capture_s"]
        per_mb = dur * fs * (0.125 if cfg["format"] == "1bit" else 2.0) / 1e6
        n = max(1, min(traffic["distinct"],
                       int(traffic["max_written_mb"] // per_mb)))
        self.plan = scene.plan(dur, fs, cfg["scene"]["n_sv"],
                               visible=traffic["sky"] == "visible")
        rng = np.random.default_rng(seed)
        lo, hi = cfg["scene"]["offset_hz"]
        self.offsets = [float(rng.choice((-1.0, 1.0)) * rng.uniform(lo, hi))
                        if hi else 0.0 for _ in range(n)]
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % (1 << 63))
        sig = scene.baseband(self.plan, device)
        os.makedirs(tmp, exist_ok=True)
        self.paths = []
        for i in range(n):
            x = sig + scene.noise(sig.shape[0], cfg["scene"]["noise"], gen,
                                  device)
            raw = (scene.onebit_bytes(x, cfg["fc"], fs)
                   if cfg["format"] == "1bit"
                   else scene.iq8_bytes(x, fs, self.offsets[i]))
            del x
            path = os.path.join(tmp, f"capture_{i}.bin")
            with open(path, "wb") as f:
                raw.tofile(f)
                # the write-back is set-up's, not the window's
                f.flush()
                os.fsync(f.fileno())
            self.paths.append(path)
        del sig
        self.truth = [check.Truth(self.plan, off) for off in self.offsets]
        self.checkpoint = None
        if traffic["start"] == "warm":
            self.checkpoint = os.path.join(tmp, "checkpoint.npz")
            write_checkpoint(self.plan, self.checkpoint)
        self.warm_s = 0.0           # seconds in warm_args, all streams
        self._lock = threading.Lock()

    def warm_args(self) -> dict:
        """``process_source``'s warm arguments from the checkpoint (none
        for a cold start), their seconds added to ``warm_s``."""
        if self.checkpoint is None:
            return {}
        t0 = time.perf_counter()
        out = warm_start(self.checkpoint)
        with self._lock:
            self.warm_s += time.perf_counter() - t0
        return out

    def source(self, i: int):
        from tpu_gnss_torch.io.stream import FileSource1Bit, IQFileSource
        path = self.paths[i % len(self.paths)]
        if self.cfg["format"] == "1bit":
            return FileSource1Bit(path, receiver_config(self.cfg))
        return IQFileSource(path, self.cfg["fs"], "int8")

    def close(self) -> None:
        """Remove the run's directory: its captures and its trace."""
        shutil.rmtree(self.dir, ignore_errors=True)


def one_capture(cfg: dict, caps: Captures, i: int, device):
    """One request: a new receiver and ``process_source`` over capture
    ``i``; with a checkpoint, the checkpoint loaded and the visible PRNs
    predicted first, inside the request's wall.  Returns ``(result or
    None, receiver, wall s, error)``."""
    from tpu_gnss_torch.receiver import Receiver
    lp = cfg["loop"]
    t0 = time.perf_counter()
    try:
        warm = caps.warm_args()
        recv = Receiver(receiver_config(cfg), pll_bn_hz=lp["pll_bn_hz"],
                        dll_bn_hz=lp["dll_bn_hz"],
                        n_coherent=cfg["n_coherent"],
                        epochs_per_step=lp["epochs_per_step"],
                        transfer_dtype=cfg["transfer"], device=device)
        res = recv.process_source(caps.source(i), chunk_s=lp["chunk_s"],
                                  **warm)
    except Exception as exc:          # a failed request, reported
        return None, None, time.perf_counter() - t0, repr(exc)
    return res, recv, time.perf_counter() - t0, None


def unheeded(recv, loop: dict) -> list:
    """The loop settings of the configuration that the program fixes
    itself (``Receiver`` takes no option for them) and runs with another
    value: the reference would follow another loop than the program's.
    Read from the receiver's tracker where it shows them."""
    kw = getattr(getattr(recv, "_tracker", None), "_kw", None) or {}
    return [f"{k}: configuration {loop[k]!r}, program {kw[k]!r}"
            for k in ("fll_bn_hz", "corr_spacing")
            if k in kw and kw[k] != loop[k]]


def layer_targets() -> list:
    """The program's calls into each layer that a traced block wraps in
    spans of the benchmark's own: ``(owner, attribute, layer)``."""
    from tpu_gnss_torch import receiver as rx
    from tpu_gnss_torch.nav import almanac
    from tpu_gnss_torch.track import graph
    from tpu_gnss_torch.utils import checkpoint, xfer
    return [(checkpoint, "load_state", "checkpoint"),
            (almanac, "visible_prns", "checkpoint"),
            (rx.Receiver, "__init__", "receiver_init"),
            (rx.Receiver, "_cold_detections", "acquire"),
            (rx.Receiver, "_transfer", "link"),
            (rx.Receiver, "_mix_chunk_packed", "link"),
            (xfer, "to_device_iq8", "link"),
            (graph.GraphedTracker, "__call__", "track"),
            (rx.Receiver, "_decode_nav", "nav"),
            (rx.Receiver, "_solve_at", "pvt")]


def stage_seconds(caps: Captures) -> dict:
    """The program's stage seconds so far, and the run's warm-start
    seconds under ``WARM_STAGE``."""
    from tpu_gnss_torch.utils.metrics import METRICS
    out = {k: float(sum(METRICS.timings.get(k, []))) for k in STAGES}
    out[WARM_STAGE] = caps.warm_s
    return out


class Tally:
    """What the window's captures gave: walls, failures, seconds of
    signal, the stage seconds and count of the untraced captures, and a
    uniform sample of ``k`` untraced results drawn from ``rng``
    (reservoir sampling).  Streams update it under ``lock``."""

    def __init__(self, k: int, rng):
        self.k, self.rng = k, rng
        self.lock = threading.Lock()
        self.walls, self.errors, self.missed = [], [], []
        self.n_missed = 0            # captures that missed a gate
        self.signal_s = 0.0
        self.stages = dict.fromkeys(STAGES + (WARM_STAGE,), 0.0)
        self.n_untraced, self.signal_untraced = 0, 0.0
        self.sample = []             # (index, result, offset estimate)

    def add(self, i, res, recv, wall, err, gates, capture_s, untraced):
        """Record capture ``i``; an ``untraced`` one feeds the sample and
        counts towards the stage-timer metrics, whose seconds are taken
        over each untraced phase as a whole (:meth:`add_stages`)."""
        self.walls.append(wall if err is None else math.inf)
        if err is not None:
            self.errors.append(err)
            return
        self.signal_s += capture_s
        got = gates(res, recv._if_offset)
        self.n_missed += bool(got)
        self.missed.extend(f"capture {i}: {m}" for m in got)
        if not untraced:
            return
        self.n_untraced += 1
        self.signal_untraced += capture_s
        item = (i, res, float(recv._if_offset))
        if len(self.sample) < self.k:
            self.sample.append(item)
        else:
            j = int(self.rng.integers(0, self.n_untraced))
            if j < self.k:
                self.sample[j] = item

    def add_stages(self, before: dict, after: dict) -> None:
        for k in self.stages:
            self.stages[k] += after[k] - before[k]


def run_streams(n: int, nxt: list, until, capture, budget=None) -> None:
    """``n`` closed loops at once, started together: stream 0 on the
    caller's thread, each other on a thread of its own.  Stream ``s``
    runs ``capture(i)`` for ``i = nxt[s], nxt[s] + n, ...`` while
    ``until()`` holds and, with ``budget``, while that many captures of
    all the streams together are left (the first always runs).  ``nxt``
    is advanced in place; the first error raised in a stream is raised
    here once every stream has ended."""
    start = threading.Barrier(n)
    lock = threading.Lock()
    left = [budget]
    errors = []

    def stream(s):
        try:
            start.wait()
            while True:
                if budget is None:
                    if not until():
                        return
                else:
                    with lock:
                        if not left[0] or (left[0] < budget
                                           and not until()):
                            return
                        left[0] -= 1
                i = nxt[s]
                nxt[s] += n
                capture(i)
        except BaseException as exc:      # raised in the caller
            errors.append(exc)
    threads = [threading.Thread(target=stream, args=(s,),
                                name=f"gnss_bench.stream{s}")
               for s in range(1, n)]
    for t in threads:
        t.start()
    stream(0)
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def held(numbers: dict, limits: dict) -> tuple[dict, list]:
    """``(checks, bad)``: each compared number beside its limit, and the
    names of those past it (a number that is not a number is past it)."""
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in limits.items() if k in numbers}
    return checks, [k for k, c in checks.items()
                    if not c["value"] <= c["limit"]]


def run_cell(cell: dict, cfg: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, device="cuda",
             per_layer=(), kind: str = "", controls=()) -> dict:
    """One run of a cell on ``device``; returns the result's fields
    (without ``device``) and the numbers compared.  ``controls``: lower
    precisions (``"bf16"``) in which the reference also reads the
    sample, in place of the program (``control_numbers``)."""
    import numpy as np
    import torch

    from gnss_bench import trace as tr
    from gnss_bench.ref import check

    # a directory of this run's own under $TMPDIR: two runs never share
    tmp = tempfile.mkdtemp(prefix=f"gnss_bench.{cell['name']}.")
    cuda = torch.device(device).type == "cuda"
    t_in = process_age_s()
    caps = Captures(cfg, traffic, seed, device, tmp)
    try:
        t_caps = process_age_s()
        for i in range(traffic["warm_captures"]):
            _, recv, _, err = one_capture(cfg, caps, i, device)
            if err is not None:
                raise RuntimeError(f"warm-up capture failed: {err}")
            if unheeded(recv, cfg["loop"]):
                raise SystemExit("gnss_bench: the program has no option "
                                 f"for {unheeded(recv, cfg['loop'])}")
            del recv
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t_warm = process_age_s()
        n_caps = len(caps.paths)

        def gates(i):
            return lambda res, off: check.gates(
                res, off, caps.truth[i % n_caps], cfg, traffic)
        tally = Tally(traffic["sample"], np.random.default_rng([seed, 1]))
        summary = None
        trace_path = os.path.join(tmp, "trace.json")
        setup_s = process_age_s()
        print(f"gnss_bench: set-up {setup_s:.2f} s: to the harness "
              f"{t_in:.2f}, captures {t_caps - t_in:.2f}, warm capture(s) "
              f"{t_warm - t_caps:.2f}", file=sys.stderr)
        t_w0 = time.perf_counter()
        n_streams = traffic["streams"]
        nxt = list(range(n_streams))
        last = [t_w0]               # the latest finish

        def capture(i, untraced):
            got = one_capture(cfg, caps, i, device)
            with tally.lock:
                last[0] = max(last[0], time.perf_counter())
                tally.add(i, *got, gates(i), traffic["capture_s"],
                          untraced)

        def untraced_until(t_stop):
            # the stage seconds of the phase as a whole: with several
            # streams a capture's own before and after would count
            # other streams' time
            before = stage_seconds(caps)
            run_streams(n_streams, nxt,
                        lambda: time.perf_counter() - t_w0 < t_stop,
                        lambda i: capture(i, True))
            tally.add_stages(before, stage_seconds(caps))
        if trace:
            untraced_until(0.4 * seconds)
            # a fixed number of whole captures over the streams, profiled
            # (on every thread where streams run on threads of their own)
            with (tr.profiled(trace_path, all_threads=n_streams > 1),
                  tr.spans(layer_targets())):
                run_streams(n_streams, nxt,
                            lambda: time.perf_counter() - t_w0 < seconds,
                            lambda i: capture(i, False),
                            traffic["traced_captures"])
            summary = tr.read(trace_path)
        untraced_until(seconds)
        window_s = last[0] - t_w0
        t_cmp = time.perf_counter()
        peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # the comparison, once the window has closed
        numbers = {}
        control = {c: {} for c in controls}
        for idx, res, off in tally.sample:
            for prec, into in [("float64", numbers)] + list(control.items()):
                got = check.compare(res, off, caps.truth[idx % n_caps],
                                    caps.paths[idx % n_caps], cfg,
                                    cfg["loop"], device, prec)
                for k, v in got.items():
                    into[k] = max(into.get(k, -math.inf), v)
    finally:
        caps.close()
    print(f"gnss_bench: window {window_s:.2f} s, {len(tally.walls)} "
          f"captures; comparison {time.perf_counter() - t_cmp:.2f} s",
          file=sys.stderr)

    n_failed = len(tally.errors) + tally.n_missed
    checks, bad = held(numbers, cfg["limits"])
    out = dict(attempted=len(tally.walls), failed=n_failed,
               correct=bool(tally.sample) and not bad and n_failed == 0,
               errors=tally.errors[:3], missed=tally.missed[:5], bad=bad,
               numbers=numbers, checks=checks, peak=peak,
               control_numbers=control, control_checks={},
               control_correct={})
    for prec, got in control.items():
        # the control read by the same decision as the program's sample
        out["control_checks"][prec], c_bad = held(got, cfg["limits"])
        out["control_correct"][prec] = bool(tally.sample) and not c_bad
    if not trace:
        p90 = nearest_rank(tally.walls, 0.9) * 1e3
        out["metrics"] = {
            "realtime_x": {"value": tally.signal_s / window_s,
                           "unit": "s/s"},
            "capture_p90_ms": {"value": min(p90, LATE_MS), "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        return out
    ctx = dict(stages=tally.stages, signal_s=tally.signal_untraced,
               n_captures=tally.n_untraced, trace=summary, cfg=cfg,
               loop=cfg["loop"], kind=kind)
    out["metrics"] = {}
    t_read = time.perf_counter()
    for m in per_layer:
        v = reader(m["name"])(ctx)
        if v is not None:
            out["metrics"][m["name"]] = {"value": float(v),
                                         "unit": m["unit"]}
    print(f"gnss_bench: per-layer readers {time.perf_counter() - t_read:.2f}"
          " s", file=sys.stderr)
    if summary is not None:
        out["busy_s"], out["window_s"] = summary["busy_s"], summary["window_s"]
        out["breakdown"] = dict(device_ops=summary["device_ops"],
                                idle_gaps=summary["idle_gaps"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, cfg, traffic, manifest = cell_spec(args.workload)

    checkout_caches()
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"gnss_bench: {cell['name']} needs {cell['chips']} CUDA "
              "device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import tpu_gnss_torch  # noqa: F401  (the program; fails outside a checkout)

    kind = torch.cuda.get_device_name(0)
    per_layer = [m for m in manifest["per_layer"]
                 if cell["name"] in m.get("workloads", [cell["name"]])]
    out = run_cell(cell, cfg, traffic, args.seed, args.seconds,
                   bool(args.trace), "cuda", per_layer, kind)
    if not args.trace:
        # the cell's own end-to-end metrics
        wanted = {m["name"] for m in manifest["end_to_end"]
                  if cell["name"] in m.get("workloads", [cell["name"]])}
        out["metrics"] = {k: v for k, v in out["metrics"].items()
                          if k in wanted}
    found = forbidden_modules()
    if found:
        print(f"gnss_bench: the run loaded {found}", file=sys.stderr)
        return 3
    if out["errors"] or out["missed"]:
        print(f"gnss_bench: errors {out['errors']}, missed gates "
              f"{out['missed']}", file=sys.stderr)
    # the numbers compared, each beside its limit, last on stderr
    for k, c in out["checks"].items():
        print(f"check {k}: {float(c['value'])!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"check failed_captures: {out['failed']} (limit 0)",
          file=sys.stderr)
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": out["peak"]}
    if args.trace and "busy_s" in out:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["window_s"]
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = dict(
        {k: [finite(c["value"]), c["limit"]]
         for k, c in out["checks"].items()},
        failed_captures=[out["failed"], 0])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
