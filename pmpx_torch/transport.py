"""Bounded device-health probing for unattended runs (port of
``pmpx/transport.py``).

A device call, or a fresh driver initialisation, can hang with no error
(a wedged card, a stuck driver).  Anything that runs unattended (a
benchmark, a queue, a health check) should first confirm that the device
answers from a throwaway subprocess with a time limit, never from its own
process.  :func:`probe_device` is that probe; ``python -m pmpx_torch.cli
doctor`` wraps it for people.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time

__all__ = ["probe_device", "doctor_report"]

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# argv[1] names the device ("cuda" unless the caller names another); a
# CUDA probe without a card fails, it never answers from the CPU instead
_PROBE_CODE = (
    "import json, sys, torch\n"
    "dev = torch.device(sys.argv[1])\n"
    "if dev.type == 'cuda' and not torch.cuda.is_available():\n"
    "    sys.exit('no CUDA device is available (torch.cuda.is_available() "
    "is false)')\n"
    "a = torch.ones((8, 8), device=dev)\n"
    "(a @ a).sum().item()\n"
    "cuda = dev.type == 'cuda'\n"
    "if cuda:\n"
    "    torch.cuda.synchronize(dev)\n"
    "print(json.dumps({'backend': dev.type, "
    "'n_devices': torch.cuda.device_count(), "
    "'device_kind': torch.cuda.get_device_name(dev) if cuda else 'cpu', "
    "'torch': torch.__version__, 'cuda': torch.version.cuda}))\n"
)


def probe_device(timeout_s: float = 120.0, cwd: str | None = None,
                 device=None) -> dict:
    """Run a small product on ``device`` (``cuda`` unless given) in a
    bounded subprocess.

    Returns ``{"ok": True, "backend", "n_devices", "device_kind", "torch",
    "cuda", "probe_s"}`` on success; ``{"ok": False, "error", "probe_s"}``
    on a timeout or a nonzero exit (no card included).  Never blocks much
    longer than ``timeout_s``: the output goes to temp files (not pipes: a
    grandchild holding a captured pipe would make the drain after the kill
    block forever) and on timeout the whole process *group* is killed, not
    just the direct child.  ``cwd`` defaults to the repo root.
    """
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as fout, \
            tempfile.TemporaryFile("w+") as ferr:
        proc = subprocess.Popen(
            [sys.executable, "-c", _PROBE_CODE, str(device or "cuda")],
            cwd=cwd or _REPO,
            stdout=fout, stderr=ferr, start_new_session=True,
        )
        try:
            rc = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except OSError:
                pass
            proc.wait()
            return {
                "ok": False,
                "error": f"probe did not answer within {timeout_s:.0f}s "
                         "(device or driver wedged?)",
                "probe_s": round(time.perf_counter() - t0, 2),
            }
        dt = round(time.perf_counter() - t0, 2)
        fout.seek(0)
        ferr.seek(0)
        stdout, stderr = fout.read(), ferr.read()
    if rc != 0:
        return {"ok": False, "error": stderr.strip()[-500:], "probe_s": dt}
    try:
        info = json.loads(stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return {
            "ok": False,
            "error": f"unparseable probe output: {stdout[-200:]!r}",
            "probe_s": dt,
        }
    return {"ok": True, "probe_s": dt, **info}


def doctor_report(probe_timeout_s: float = 120.0, device=None) -> dict:
    """Everything an operator needs to know before a long run: the
    visible cards, the native runtime, the datasets on disk and the
    bounded probe of ``device``."""
    from pmpx_torch.data import dataset_presence
    from pmpx_torch.runtime import native_available

    return {
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES", ""),
        "native_runtime": native_available(),
        "datasets": dataset_presence(),
        "device": probe_device(timeout_s=probe_timeout_s, device=device),
    }
