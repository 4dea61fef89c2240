"""The card as ``nvidia-smi`` reads it: its name and power limit, and a
sampler of utilization and memory in use across every process on the
card, 10 times a second. ``nvidia-smi`` ignores ``CUDA_VISIBLE_DEVICES``,
so the card is named by the UUID of torch's device 0, the one the nodes
run on."""

from __future__ import annotations

import shutil
import subprocess
import threading
import time


def _exe() -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi is not on PATH: no reading of the "
                           "card's memory")
    return exe


def visible_uuid() -> str:
    """``nvidia-smi``'s UUID (``GPU-...``) of torch's CUDA device 0."""
    import torch

    uuid = str(torch.cuda.get_device_properties(0).uuid)
    return uuid if uuid.startswith("GPU-") else "GPU-" + uuid


def card_info(uuid: str) -> str:
    """Name, power limit and SM clock limit of the card ``uuid``; raises
    where ``nvidia-smi`` does not know it."""
    out = subprocess.run(
        [_exe(), "-i", uuid, "--query-gpu=uuid,name,power.limit,"
         "clocks.max.sm", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=30)
    line = out.stdout.strip()
    if out.returncode or not line.startswith(uuid):
        raise RuntimeError(f"nvidia-smi does not know the card {uuid}: "
                           f"{out.stderr.strip() or line}")
    return line[len(uuid):].lstrip(", ")


class Sampler:
    """``nvidia-smi -i <uuid>`` in loop mode (``-lms 100``); each line is
    kept with the monotonic time it arrived. ``samples(t0, t1)`` gives
    (time, utilization %, memory used MiB) within [t0, t1]."""

    def __init__(self, uuid: str, period_ms: int = 100) -> None:
        self.uuid = uuid
        self._rows: list[tuple[float, float, float]] = []
        self._proc = subprocess.Popen(
            [_exe(), "-i", uuid,
             "--query-gpu=uuid,utilization.gpu,memory.used",
             "--format=csv,noheader,nounits", "-lms", str(period_ms)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    @property
    def pid(self) -> int | None:
        return self._proc.pid if self._proc is not None else None

    def _read(self) -> None:
        for line in self._proc.stdout:
            parts = [p.strip() for p in line.split(",")]
            if len(parts) != 3 or parts[0] != self.uuid:
                continue
            try:
                self._rows.append((time.monotonic(), float(parts[1]),
                                   float(parts[2])))
            except ValueError:
                continue

    def samples(self, t0: float, t1: float) -> list[tuple]:
        return [r for r in list(self._rows) if t0 <= r[0] <= t1]

    def stop(self) -> None:
        if self._proc is not None:
            self._proc.kill()
            self._proc.wait(timeout=30)
            self._thread.join(timeout=30)
            self._proc = None
