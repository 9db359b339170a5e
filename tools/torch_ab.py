"""Parent-vs-change comparison of the PyTorch port on one CUDA card.

    python3 tools/torch_ab.py PARENT_TREE CHANGE_TREE [--warm N] [--cold N]
                              [--out FILE]

Each tree is a checkout holding ``tpu_gnss_torch/`` (for the parent,
``git archive HEAD`` unpacked into a git-ignored directory).  Each tree
gets one worker process that puts the tree first on ``sys.path`` and
builds that tree's kernels there; the two workers then take the same
commands in turns, so that a slow spell of the host falls on both:

* ``kern``, in the order parent, change, change, parent: ``track_corr``
  at the e2e (2.048 Msps, NF 2048) and nottingham (5.456 Msps, NF 16384)
  shapes, one tracking step of 10 epochs x 12 channels
  (``chip_smoke.track_case``), with the host time of one call (wrapper
  and launch, 200 calls enqueued without waiting); ``mix_packed`` at the
  e2e, nottingham and LIVE rates; ``loop_update`` on the e2e 12 x 10 step
  of ``chip_smoke.loop_case``, and that case's 100-step chain from its
  first state with the next step's parameters written each step, with
  the sha256 of its taps, the final state, the output planes and the
  last parameters (the case is made on the CPU through the plain
  versions, so both trees get the same inputs: equal hashes say the two
  kernels agree bit for bit).  Device times per call, calls enqueued
  back to back behind a sleep kernel (``chip_smoke.time_ms``).
* ``run``: the receiver on the 20 s e2e scene (written once, before the
  workers start), a new ``Receiver`` each run: wall seconds of one
  ``process_source``, its host seconds per receiver stage
  (``utils.metrics.METRICS``), the chunks its tracking loop ran eagerly
  and captured (the tracker's ``counts()``, or, in a tree whose trackers
  have none, the keys its private tracker saw and captured) and the
  receiver's ``prewarm_stats`` where it has them.  The first run of each
  worker is its cold run; then ``--warm`` pairs, parent first in even
  pairs and change first in odd ones.
* ``prof``: one more warm run under ``cProfile``, its 25 functions of
  most own time.
* ``--cold N``: then N fresh worker processes per tree, in turns (parent
  first in even rounds), each running ``run`` once and exiting: the
  first ``process_source`` of a process that has only loaded the kernel
  library, as a command-line run's.

Prints the card's ``nvidia-smi`` name and power limit, one JSON line per
tree, whether every ``loop_update`` chain of both trees hashed the same,
and each tree's profile; ``--out`` also writes the JSON to a file.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SMOKE = os.path.join(os.path.dirname(HERE), "chip_smoke.py")

_WORKER = r"""
import cProfile, hashlib, importlib.util, io, json, pstats, sys, time
tree, smoke, capture = sys.argv[1:4]
sys.path.insert(0, tree)
import numpy as np
import torch
spec = importlib.util.spec_from_file_location("smoke", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from tpu_gnss_torch import PRESETS, ReceiverConfig, kernels
from tpu_gnss_torch.io.stream import FileSource1Bit
from tpu_gnss_torch.ops import mxu_track, onebit
from tpu_gnss_torch.receiver import Receiver
from tpu_gnss_torch.track import channel as tc
from tpu_gnss_torch.utils.metrics import METRICS
assert kernels.__file__.startswith(tree), kernels.__file__
dev = torch.device("cuda", 0)
kernels.lib()
fs = 2.048e6
cfg = ReceiverConfig(fs=fs, fc=fs / 4, max_fo=5000.0, fft_len=4096,
                     snr_threshold=17.0, num_chans=12)


def kern():
    res = {}
    for fs_, name in ((2.048e6, "e2e"), (5.456e6, "nottingham")):
        args, kw = cs.track_case(fs_, dev)
        fn = lambda: mxu_track.track_corr(*args, **kw)
        res[f"track_corr {name} ms"] = cs.time_ms(fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        res[f"track_corr {name} host us"] = (time.perf_counter() - t0) * 5e3
        torch.cuda.synchronize()
    live = PRESETS["live"]
    for name, lo_rate, n_bits, s0 in (("e2e", 1.0, 2_048_000, 0),
                                      ("nottingham", 3.0, 5_456_000, 0),
                                      ("live", live.lo_rate, 10_000_000 - 7,
                                       1_000_000_007)):
        rng = np.random.default_rng(n_bits)
        words = onebit.words_to_tensor(rng.integers(
            0, 2 ** 32, -(-n_bits // 32), dtype=np.uint32), dev)
        kw = dict(n_bits=n_bits, lo_rate=lo_rate,
                  phase0_quarters=float((s0 * float(lo_rate)) % 4.0))
        res[f"mix_packed {name} ms"] = cs.time_ms(
            lambda: onebit.mix_packed(words, **kw))
    res.update(loop_kern())
    return res


_loop = {}


def loop_kern():
    if not _loop:
        states, taps, opts = cs.loop_case(fs, torch.device("cpu"))
        _loop.update(states=[t.to(dev) for t in states],
                     taps=[t.to(dev) for t in taps], opts=opts)
    states, taps, opts = _loop["states"], _loop["taps"], _loop["opts"]
    e_sub, n_chan = taps[0].shape[:2]
    aid = tc.aid_tensor(0.0, dev)
    par = torch.empty(e_sub, n_chan, 5, device=dev)
    st = states[0].clone()
    outs = torch.empty(7, e_sub, n_chan, device=dev)
    ms = cs.time_ms(lambda: tc.loop_update(taps[0], st, aid, par, outs, 0,
                                           opts))
    st = states[0].clone()
    outs = torch.empty(7, len(taps) * e_sub, n_chan, device=dev)
    for s, t in enumerate(taps):
        tc.loop_update(t, st, aid, par, outs, s, opts)
    sha = lambda t: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
    return {"loop_update e2e ms": ms,
            "loop_update chain sha256": {
                "taps": sha(torch.stack(taps)), "state": sha(st),
                "outs": sha(outs), "par": sha(par)}}


def tracker_counts(recv):
    tr = recv._tracker
    if hasattr(tr, "counts"):
        return tr.counts()
    # a private tracker without counters ran each key it saw once eagerly
    return {"eager": len(tr._seen), "captures": len(tr._graphs)}


def run():
    recv = Receiver(cfg, device="cuda")
    METRICS.timings.clear()
    before = tracker_counts(recv)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = recv.process_source(FileSource1Bit(capture, cfg))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = tracker_counts(recv)
    return {"wall s": wall, "fixes": len(out.solutions),
            "stage s": {k: sum(v) for k, v in METRICS.timings.items()},
            "tracker": {k: v - before.get(k, 0) for k, v in after.items()},
            "prewarm": getattr(recv, "prewarm_stats", None)}


def prof():
    p = cProfile.Profile()
    p.enable()
    run()
    p.disable()
    buf = io.StringIO()
    pstats.Stats(p, stream=buf).sort_stats("tottime").print_stats(25)
    return {"profile": buf.getvalue()}


print("READY", flush=True)
for line in sys.stdin:
    cmd = line.strip()
    if cmd == "quit":
        break
    out = {"kern": kern, "run": run, "prof": prof}[cmd]()
    print("OUT " + json.dumps(out), flush=True)
"""


class Worker:
    def __init__(self, tree: str, capture: str):
        self.tree = tree
        self.p = subprocess.Popen(
            [sys.executable, "-c", _WORKER, tree, SMOKE, capture],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self._expect("READY")

    def _expect(self, tag: str) -> str:
        for line in self.p.stdout:
            if line.startswith(tag):
                return line[len(tag):].strip()
        raise RuntimeError(f"worker for {self.tree} exited "
                           f"({self.p.wait()})")

    def ask(self, cmd: str) -> dict:
        self.p.stdin.write(cmd + "\n")
        self.p.stdin.flush()
        return json.loads(self._expect("OUT "))

    def close(self) -> None:
        try:
            self.p.stdin.write("quit\n")
            self.p.stdin.close()
            self.p.wait(timeout=60)
        except (OSError, subprocess.TimeoutExpired):
            self.p.kill()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--warm", type=int, default=6)
    ap.add_argument("--cold", type=int, default=0)
    ap.add_argument("--out")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_ab: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    sys.path.insert(0, os.path.abspath(a.change))
    from tpu_gnss_torch.signal import scene
    trees = {"parent": os.path.abspath(a.parent),
             "change": os.path.abspath(a.change)}
    res = {k: {"tree": t, "kern": [], "warm": [], "cold runs": []}
           for k, t in trees.items()}
    with tempfile.TemporaryDirectory() as tmp:
        capture = os.path.join(tmp, "e2e.bin")
        iq, _, _ = scene.build_scene(duration=20.0, fs=2.048e6)
        scene.write_1bit_capture(iq, 2.048e6 / 4, 2.048e6, capture)
        del iq
        workers = {k: Worker(t, capture) for k, t in trees.items()}
        try:
            for k in ("parent", "change", "change", "parent"):
                res[k]["kern"].append(workers[k].ask("kern"))
            for k in ("parent", "change"):
                res[k]["cold"] = workers[k].ask("run")
            for i in range(a.warm):
                for k in (("parent", "change") if i % 2 == 0
                          else ("change", "parent")):
                    res[k]["warm"].append(workers[k].ask("run"))
            profiles = {k: workers[k].ask("prof")["profile"]
                        for k in ("parent", "change")}
        finally:
            for w in workers.values():
                w.close()
        for i in range(a.cold):
            for k in (("parent", "change") if i % 2 == 0
                      else ("change", "parent")):
                w = Worker(trees[k], capture)
                try:
                    res[k]["cold runs"].append(w.ask("run"))
                finally:
                    w.close()
    for k, r in res.items():
        walls = [w["wall s"] for w in r["warm"]]
        stages = {}
        for w in r["warm"]:
            for s, v in w["stage s"].items():
                stages[s] = stages.get(s, 0.0) + v / len(r["warm"])
        r["warm wall s"] = walls
        if walls:
            r["warm wall median s"] = statistics.median(walls)
        if len(walls) > 1:
            q = statistics.quantiles(walls, n=4)
            r["warm wall quartiles s"] = [q[0], q[2]]
        r["warm tracker counts"] = [w["tracker"] for w in r["warm"]]
        if r["cold runs"]:
            r["cold run walls s"] = [w["wall s"] for w in r["cold runs"]]
            r["cold run median s"] = statistics.median(
                r["cold run walls s"])
        r["warm stage mean s"] = stages
        print(json.dumps({"which": k, **{x: y for x, y in r.items()
                                         if x not in ("warm", "cold runs")}}),
              flush=True)
    chains = [r["kern"][i]["loop_update chain sha256"]
              for r in res.values() for i in range(len(r["kern"]))]
    print(json.dumps({"loop_update chains bit-identical":
                      all(c == chains[0] for c in chains)}), flush=True)
    for k, text in profiles.items():
        print(f"--- {k} profile (one warm run, tottime) ---\n{text}",
              flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"card": smi, "results": res, "profiles": profiles},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
