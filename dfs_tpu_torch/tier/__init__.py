"""Hot/cold tiering plane of the port, a copy of dfs_tpu's ``tier/``:
temperature-driven demotion of cold files from full replication to wide EC
stripes. The ledger snapshot (``<node>/tier/ledger.json``) has one format in
both packages.

The paper's design stores every chunk at its replication factor
forever, so steady-state storage amplification is rf (3.0x at the
default rf=3) regardless of how skewed the read traffic is. Real
corpora are Zipf-shaped: a small hot set takes nearly all the reads
while the long tail goes cold and stays cold. This plane trades the
tail's redundancy bytes for reconstruction compute — the storage-system
analogue of activation offloading in a training stack:

- :class:`TemperatureLedger` — a bounded per-digest ledger of last
  access + exponentially-decayed read count, fed by the serve tier's
  read path (cache hits AND misses: temperature is about demand, not
  about where the bytes came from). Persisted as an atomic JSON
  snapshot under ``<data_root>/tier/``; the durable TIER BIT itself
  lives in the digest index (state byte ``_PRESENT_COLD``) and in
  the manifest (``tier="cold"``), which is the cluster-wide truth.
  Losing ledger history is the safe direction: unknown digests are
  treated as read at ledger boot, so ``min_idle_s`` must elapse after
  a restart before anything new becomes demotable.

- :func:`classify` — hot/cold by BYTE-BUDGET percentile, not fixed
  age: files sorted hottest-first keep their replicas until the
  cumulative size crosses ``hot_fraction`` of all referenced bytes;
  everything past the knee is cold-eligible once idle ``min_idle_s``.
  A fixed age threshold needs retuning every time traffic changes
  shape; a byte budget is what capacity planning actually allocates.

- :class:`TierPlane` — the per-node runtime state: the ledger, a
  dedicated single-slot admission class (scan work is background; it
  sheds rather than queues), a :class:`~dfs_tpu_torch.ring.manager.ByteRate`
  credit bucket bounding demotion traffic (demotion must never starve
  user reads), and the
  counters ``tier_stats()`` surfaces. The demotion/promotion protocol
  itself lives in node/runtime.py (it is placement + manifest work; the
  demotion's P+Q encode runs on the node's device);
  this module owns the policy state.

Default-off: ``TierConfig()`` builds none of this and every runtime
seam is one ``None`` check.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path

from dfs_tpu_torch.config import TierConfig
from dfs_tpu_torch.ring.manager import ByteRate
from dfs_tpu_torch.serve.admission import AdmissionGate
from dfs_tpu_torch.store.cas import _atomic_write

_LEDGER_FILE = "ledger.json"
_LEDGER_VERSION = 1


class TemperatureLedger:
    """Bounded per-digest temperature: ``(last_access, decayed heat)``.

    Heat is an exponentially-decayed read count with half-life
    ``half_life_s`` — one read adds 1.0, and the total halves every
    half-life — so "N recent reads" and "N reads last week" classify
    differently without storing any history. Decay is applied lazily at
    read/update time (pure function of the stored ``(last, heat)``
    pair), so an idle ledger costs nothing.

    Bounded at ``entries``: beyond it the stalest-UPDATED digest is
    evicted (update order IS an LRU here — eviction forgets exactly the
    digests that stopped being read, which classification treats as
    cold anyway, with ``boot_at`` as their assumed last access).

    Event-loop-owned: every caller is the node's event loop, so no
    locking — mirrors the SIEVE cache's threading stance.
    """

    def __init__(self, entries: int, half_life_s: float,
                 boot_at: float | None = None) -> None:
        self.entries = int(entries)
        self.half_life_s = float(half_life_s)
        # digests never seen are assumed last-read at ledger boot: a
        # fresh/lost ledger must WAIT OUT min_idle_s before demoting,
        # never demote everything at once
        self.boot_at = time.time() if boot_at is None else float(boot_at)
        self._map: dict[str, list[float]] = {}   # digest -> [last, heat]

    def __len__(self) -> int:
        return len(self._map)

    def _decayed(self, last: float, heat: float, now: float) -> float:
        dt = max(0.0, now - last)
        return heat * math.pow(2.0, -dt / self.half_life_s)

    def note_read(self, digest: str, reads: float = 1.0,
                  now: float | None = None) -> None:
        now = time.time() if now is None else now
        ent = self._map.pop(digest, None)
        if ent is None:
            heat = float(reads)
        else:
            heat = self._decayed(ent[0], ent[1], now) + float(reads)
        self._map[digest] = [now, heat]   # re-insert = move to MRU end
        while len(self._map) > self.entries:
            self._map.pop(next(iter(self._map)))

    def heat(self, digest: str, now: float | None = None) -> float:
        now = time.time() if now is None else now
        ent = self._map.get(digest)
        if ent is None:
            return 0.0
        return self._decayed(ent[0], ent[1], now)

    def last_access(self, digest: str) -> float:
        """Last observed read, or ledger boot for unknown digests (the
        conservative default — see __init__)."""
        ent = self._map.get(digest)
        return ent[0] if ent is not None else self.boot_at

    def file_temperature(self, digests, now: float | None = None
                         ) -> tuple[float, float]:
        """-> (MEAN decayed chunk heat, newest last-access) over a
        file's chunk digests — the classification unit is the FILE
        (demotion re-encodes whole manifests). Mean, not sum: one full
        read heats every chunk by ~1, so the mean approximates the
        file's decayed READ COUNT regardless of chunk count — a summed
        heat would make big files look hotter than small files read
        equally often (and ``promote_reads`` would mean a different
        number of reads per file)."""
        now = time.time() if now is None else now
        heat = 0.0
        last = 0.0
        count = 0
        seen_any = False
        for d in digests:
            count += 1
            ent = self._map.get(d)
            if ent is None:
                continue          # unseen chunks contribute 0 heat
            seen_any = True
            heat += self._decayed(ent[0], ent[1], now)
            last = max(last, ent[0])
        if not seen_any:
            last = self.boot_at
        return (heat / count if count else 0.0), last

    # ---- persistence -------------------------------------------------- #

    def snapshot_to(self, root: Path) -> None:
        """Atomic JSON snapshot (the CAS _atomic_write discipline —
        rename-committed, never a torn file). Called on the worker
        cadence and at shutdown; losing the tail since the last
        snapshot only under-counts heat, which is the safe direction.

        Deliberately NOT fsync'd: heat history is advisory, the durable tier bit
        lives in the digest index + manifests, and a snapshot lost to
        power failure just re-arms the min_idle_s boot grace."""
        root.mkdir(parents=True, exist_ok=True)
        doc = {"version": _LEDGER_VERSION, "bootAt": self.boot_at,
               "entries": {d: [round(e[0], 3), round(e[1], 4)]
                           for d, e in self._map.items()}}
        _atomic_write(root / _LEDGER_FILE,
                      json.dumps(doc, separators=(",", ":")).encode())

    @classmethod
    def restore(cls, root: Path, entries: int, half_life_s: float
                ) -> "TemperatureLedger":
        """Load the last snapshot (best-effort: any damage = fresh
        ledger; the min_idle_s boot grace covers the loss)."""
        led = cls(entries, half_life_s)
        try:
            doc = json.loads((root / _LEDGER_FILE).read_bytes())
            ents = doc["entries"]
            if doc.get("version") != _LEDGER_VERSION \
                    or not isinstance(ents, dict):
                return led
            for d, (last, heat) in ents.items():
                led._map[str(d)] = [float(last), float(heat)]
            while len(led._map) > led.entries:
                led._map.pop(next(iter(led._map)))
        except (OSError, ValueError, TypeError, KeyError):
            pass
        return led


def classify(entries: list[dict], hot_fraction: float,
             min_idle_s: float, now: float | None = None,
             total_bytes: float | None = None) -> set[str]:
    """Byte-budget hot/cold classification -> the set of COLD file ids.

    ``entries``: ``{"fileId", "bytes", "heat", "lastAccess"}`` per
    candidate file (already-cold files are not candidates). Files
    sorted hottest-first (heat, then recency, then id for total order)
    stay hot until their cumulative bytes exceed ``hot_fraction`` of
    the total; past the knee a file is cold only once idle at least
    ``min_idle_s`` — the floor keeps a burst of brand-new files from
    being demoted just for being born into a full hot budget.

    ``total_bytes``: the byte base the budget is a fraction OF —
    callers pass ALL referenced bytes including already-cold files
    (default: just the candidates). Without it the budget would shrink
    every scan as demotions remove bytes from the candidate set, and a
    shrinking budget eventually demotes everything — the hot set must
    be a fraction of the corpus, not of whatever is left.
    """
    total = (sum(e["bytes"] for e in entries)
             if total_bytes is None else total_bytes)
    budget = hot_fraction * total
    order = sorted(entries, key=lambda e: (-e["heat"], -e["lastAccess"],
                                           e["fileId"]))
    cold: set[str] = set()
    acc = 0
    for e in order:
        acc += e["bytes"]
        if acc <= budget:
            continue                       # inside the hot byte budget
        if now is not None and now - e["lastAccess"] < min_idle_s:
            continue                       # too recently read to demote
        cold.add(e["fileId"])
    return cold


class TierPlane:
    """Per-node tiering state: ledger + admission + credits + counters.

    Built only when ``TierConfig.enabled`` (node/runtime.py holds
    ``self.tier = None`` otherwise — every seam is one None check).
    """

    def __init__(self, cfg: TierConfig, root: Path, obs=None) -> None:
        self.cfg = cfg
        self.root = root                   # <data_root>/tier
        self.ledger = TemperatureLedger.restore(
            root, cfg.ledger_entries, cfg.half_life_s)
        # dedicated background admission class: one scan at a time,
        # no queue — an overlapping scan request sheds instead of
        # piling up behind a slow one
        self.gate = AdmissionGate("tier", slots=1, queue_depth=0,
                                  retry_after_s=1.0, obs=obs)
        # demotion byte budget (data read + parity written + deletes
        # all draw from it)
        self.credits = ByteRate(cfg.demote_credit_bytes)
        self.scans = 0
        self.demoted_files = 0
        self.demoted_bytes = 0            # data bytes of demoted files
        self.parity_bytes = 0             # parity written by demotion
        self.reclaimed_bytes = 0          # surplus replica bytes freed
        self.promoted_files = 0
        self.promoted_bytes = 0
        self.errors = 0
        self.credit_stall_s = 0.0
        self.last_scan_at = 0.0           # wall clock of last scan END
        self.last_progress_at = time.monotonic()  # sinceProgressS
        # re-demotion hysteresis (redemote_cooldown_s): wall-clock stamp
        # of each file's last PROMOTION — a file flapping around the
        # promote_reads threshold must not churn encode/decode every
        # scan. In-memory only: a restart forgets the stamps, which errs
        # toward one extra demote-eligible window (the cheap direction).
        self.promoted_at: dict[str, float] = {}

    def note_promoted(self, file_id: str) -> None:
        self.promoted_at[file_id] = time.time()
        # bounded like the ledger: drop the oldest stamps once past the
        # ledger's entry budget — a forgotten stamp only re-opens
        # demote eligibility early, never breaks correctness
        while len(self.promoted_at) > self.cfg.ledger_entries:
            self.promoted_at.pop(next(iter(self.promoted_at)))

    def in_redemote_cooldown(self, file_id: str,
                             now: float | None = None) -> bool:
        """True while ``file_id`` was promoted less than
        ``redemote_cooldown_s`` ago — the demotion scan skips it
        (0 = historical behavior, no hysteresis)."""
        if self.cfg.redemote_cooldown_s <= 0:
            return False
        at = self.promoted_at.get(file_id)
        if at is None:
            return False
        now = time.time() if now is None else now
        return (now - at) < self.cfg.redemote_cooldown_s

    def note_credit_stall(self, s: float) -> None:
        self.credit_stall_s += s

    def note_progress(self) -> None:
        self.last_progress_at = time.monotonic()

    def snapshot_ledger(self) -> None:
        self.ledger.snapshot_to(self.root)
