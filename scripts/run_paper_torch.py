"""Sequential queue runner for the reference-scale (paper-protocol) runs
on the CUDA card (the port of ``scripts/run_paper.py``).

The reference's committed results are hours-long single-GPU jobs (CIFAR
50k supersteps, BNN 30k, MNIST CNN 250k / LSTM 1M).  On one card they
run (a) one at a time, so that no stage's steady-state timing shares the
card with another, and (b) as checkpoint-resumable chunked subprocesses,
so that a crash or a hung card costs one chunk, not the run.

Stages live in ``scripts/paper_queue_torch.json`` and are re-read after
every stage, so the queue can be re-prioritized mid-flight without
touching a running job.  An ``argv`` stage is one ``python -m
pmpx_torch.cli run ...`` subprocess; a ``cmd`` stage runs the interpreter
on its own arguments (the terminal summarize step).  On a nonzero exit a
stage is retried after a cool-down, up to ``MAX_ATTEMPTS`` times (every
paper experiment passes ``--resume true``, so a retry continues from its
checkpoint), and then leaves a ``<name>.failed`` marker.  A completed
stage leaves a ``<name>.done`` marker and is skipped on re-entry, so
re-running this script is idempotent; ``"skip": true`` skips a stage.

A stage can also hang without exiting (a wedged card), so each
runs under a stall monitor: if it writes nothing (its log or its
``--out-dir``) for ``STALL_S``, it is SIGTERMed and retried like any
other failure.  Before each stage the queue waits until a bounded probe
of the device answers (:func:`pmpx_torch.transport.probe_device`).

The queue's markers and logs go to ``STATE_DIR`` (under the git-ignored
``results/``); the queue never stages or commits anything.

Usage: nohup python scripts/run_paper_torch.py [queue.json] [--device cpu] \
           > qlog 2>&1 &

``--device`` is the device the probe checks and every ``argv`` stage that
names none runs on (the card unless given); without a card the queue
raises at once.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STATE_DIR = os.path.join(REPO, "results", "paper", "queue")
MAX_ATTEMPTS = 4
# a local card needs no wait for a transport to recover after a failure:
# the cool-down only lets the failed process's memory and files settle
COOLDOWN_S = 15
# no-file-activity threshold before a stage is killed: the longest silence
# of a healthy stage is its start (the kernels' build, ~1-3 min with a
# cold nvcc cache, the data and the warm start) or one checkpoint chunk
# (~1 min on the card, cifar_hmc.PAPER_CHUNK and mnist.PAPER_CHUNK)
STALL_S = 15 * 60
MONITOR_POLL_S = 10
PROBE_TIMEOUT_S = 120
RECOVERY_POLL_S = 60


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def device_answers(device=None, timeout_s: float = PROBE_TIMEOUT_S) -> bool:
    """A bounded probe of ``device`` in a throwaway subprocess."""
    from pmpx_torch.transport import probe_device

    return probe_device(timeout_s=timeout_s, cwd=REPO, device=device)["ok"]


def wait_for_device(device=None) -> None:
    """Block until the device answers a bounded probe.

    Retrying a stage into a hung card only burns its attempts,
    so before every stage, and after any failed attempt, the queue holds
    here (the card is idle: the failed stage's child is gone) until the
    probe answers.
    """
    if device_answers(device):
        return
    log("device not answering; holding the queue until it recovers")
    while not device_answers(device):
        time.sleep(RECOVERY_POLL_S)
    log("device recovered")


def load_stages(path: str):
    with open(path) as f:
        return json.load(f)["stages"]


def _out_dir(argv: list) -> str | None:
    for i, a in enumerate(argv):
        if a in ("--out-dir", "--out_dir") and i + 1 < len(argv):
            return os.path.join(REPO, argv[i + 1])
    return None


def _latest_mtime(paths: list) -> float:
    best = 0.0
    for p in paths:
        if not p:
            continue
        if os.path.isdir(p):
            for name in os.listdir(p):
                try:
                    best = max(best, os.path.getmtime(os.path.join(p, name)))
                except OSError:
                    pass
        elif os.path.exists(p):
            best = max(best, os.path.getmtime(p))
    return best


def _wait_with_stall_monitor(proc, watched: list) -> int:
    """Poll the stage child; SIGTERM it after STALL_S of file silence."""
    started = time.time()
    while True:
        try:  # returns as soon as the child exits
            return proc.wait(timeout=MONITOR_POLL_S)
        except subprocess.TimeoutExpired:
            pass
        quiet = time.time() - max(started, _latest_mtime(watched))
        if quiet > STALL_S:
            log(f"stage pid={proc.pid} silent {quiet / 60:.1f} min — "
                f"SIGTERM (hung device?)")
            proc.send_signal(signal.SIGTERM)
            try:
                return proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                return proc.wait()


def stage_command(stage: dict, device=None) -> list:
    """The stage's command line: a ``cmd`` stage's arguments to the
    interpreter, or ``pmpx_torch.cli run`` on an ``argv`` stage's (with
    ``--device`` where the queue was given one and the stage names
    none)."""
    if "cmd" in stage:
        return [sys.executable] + stage["cmd"]
    argv = list(stage["argv"])
    if device is not None and "--device" not in argv:
        argv += ["--device", str(device)]
    return [sys.executable, "-m", "pmpx_torch.cli", "run"] + argv


def run_stage(stage: dict, device=None) -> bool:
    name = stage["name"]
    marker = os.path.join(STATE_DIR, f"{name}.done")
    if os.path.exists(marker):
        log(f"skip {name} (done)")
        return True
    if stage.get("skip"):
        log(f"skip {name} (marked skip)")
        return True
    logpath = os.path.join(STATE_DIR, f"{name}.log")
    cmd = stage_command(stage, device)
    wait_for_device(device)  # don't launch into a hang a stage hit
    for attempt in range(1, MAX_ATTEMPTS + 1):
        log(f"start {name} attempt {attempt}: {' '.join(cmd)}")
        t0 = time.time()
        with open(logpath, "a") as lf:
            lf.write(f"\n=== attempt {attempt} {time.ctime()} ===\n")
            lf.flush()
            proc = subprocess.Popen(
                cmd, cwd=REPO, stdout=lf, stderr=subprocess.STDOUT
            )
            rc = _wait_with_stall_monitor(proc, [
                logpath,
                _out_dir(stage.get("argv", stage.get("cmd", []))) or "",
            ])
        wall = time.time() - t0
        log(f"{name} attempt {attempt}: rc={rc} wall={wall:.0f}s")
        if rc == 0:
            with open(marker, "w") as f:
                json.dump({"wall_s": wall, "attempts": attempt}, f)
            stale = os.path.join(STATE_DIR, f"{name}.failed")
            if os.path.exists(stale):
                os.remove(stale)
            return True
        if attempt < MAX_ATTEMPTS:
            time.sleep(COOLDOWN_S)
            wait_for_device(device)
    log(f"FAILED {name} after {MAX_ATTEMPTS} attempts")
    with open(os.path.join(STATE_DIR, f"{name}.failed"), "w") as f:
        json.dump(
            {"argv": stage.get("argv", stage.get("cmd")),
             "at": time.time()}, f)
    return False


def main(queue_path: str | None = None, device=None) -> int:
    """Runs the queue until every stage is done or has failed; returns 0,
    or 1 when a stage failed."""
    from pmpx_torch._device import resolve_device

    resolve_device(device)  # no card: raise now, not after a probe
    queue_path = queue_path or os.path.join(REPO, "scripts",
                                            "paper_queue_torch.json")
    os.makedirs(STATE_DIR, exist_ok=True)
    done: set = set()
    failed: dict = {}  # name -> the argv that exhausted its attempts
    stages = load_stages(queue_path)
    while True:
        try:
            stages = load_stages(queue_path)
        except (json.JSONDecodeError, OSError) as e:
            # the queue is live-editable: a mid-write or malformed JSON
            # must not kill hours of pending stages — keep the last-good
            # stage list and retry the read later
            log(f"queue reload failed ({e}); keeping last-good list")
        # a failed stage is skipped only while its argv is unchanged —
        # fixing the argv in the live-edited JSON re-queues it; a
        # .failed marker records why
        pending = [
            s for s in stages
            if s["name"] not in done
            and failed.get(s["name"]) != s.get("argv", s.get("cmd"))
        ]
        if not pending:
            break
        stage = pending[0]
        if run_stage(stage, device):  # failures don't block the queue
            done.add(stage["name"])
            failed.pop(stage["name"], None)
        else:
            failed[stage["name"]] = stage.get("argv", stage.get("cmd"))
    if failed:
        log(f"queue drained with FAILED stages: {sorted(failed)}")
        return 1
    log("queue drained")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("queue", nargs="?", default=None,
                    help="queue JSON (default: scripts/paper_queue_torch.json)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    sys.exit(main(args.queue, args.device))
