"""SmartClient: edge chunking and dedup, direct-to-owner striping and the
single-hop commit — a copy of dfs_tpu's ``client/smart.py`` whose
chunking runs through the port's anchored chain on ``device``.

An upload::

    GET /dataplane            ring map, peers' addresses, chunking, rf
    [internal] get_filters    every peer's existence filter, one call
    chunk + sha256 locally    the cluster's parameters, on the card
    [internal] has_chunks     probes only where no filter rules
    [internal] store_chunks   striped to the rf owners, windowed, each
                              slice hash-echo verified
    [internal] has_chunks     the trust round: every filter-credited skip
                              confirmed first-party before the commit
    POST /commit              one coordinator call; the server re-counts
                              durable copies at quorum and heals the
                              chunks below it before the ack

A download runs the plane in reverse: the manifest, owner groups, striped
``get_chunks`` hedged under a token budget, every chunk's sha256 checked
here, then the whole stream's. Any gap falls back to the legacy
coordinator path, which gives the same bytes.

The facade is synchronous: each upload or download runs its own event
loop with a fresh :class:`~dfs_tpu_torch.comm.rpc.InternalClient`, closed
before the loop ends (pooled connections cannot outlive their loop).
Chunking runs in the caller's thread before that loop starts. The state
kept between operations — ring view, filter replicas, echo cache, hedge
tokens, counters — is plain data owned by the calling thread.
"""

from __future__ import annotations

import asyncio
import json
import time
import urllib.parse

from dfs_tpu_torch.cli.client import NodeClient
from dfs_tpu_torch.comm.rpc import InternalClient, RpcError, RpcRemoteError
from dfs_tpu_torch.config import ClientConfig, PeerAddr
from dfs_tpu_torch.fragmenter.base import (fragmenter_from_description,
                                           params_from_description)
from dfs_tpu_torch.index import EchoCache
from dfs_tpu_torch.index.filter import BlockedBloomFilter
from dfs_tpu_torch.ring import RingMap
from dfs_tpu_torch.serve.hedge import HedgePolicy
from dfs_tpu_torch.utils.hashing import is_hex_digest, sha256_hex

# one get_chunks batch per ~8 MiB per peer: big enough to amortize the
# round trip, small enough that a hedged re-request is cheap
_READ_BATCH_BYTES = 8 * 1024 * 1024


class SmartClientError(RuntimeError):
    """The smart path failed and ``cfg.fallback`` is False (the mode that
    must measure the smart plane, not the legacy one standing in for
    it)."""


class _Fallback(Exception):
    """This operation cannot run on the smart plane: degrade to the legacy
    coordinator path. ``reason`` says why."""

    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason


class _ClientRingView:
    """The ring shim :class:`InternalClient` stamps placement ops with
    (epoch, fingerprint) from, and converges through on a
    RingEpochMismatch: the client adopts a peer's newer map as a node
    would. Placement under the old map stays safe, since ``/commit``
    re-counts durable copies under the coordinator's map and heals."""

    def __init__(self, ring: RingMap) -> None:
        self.current = ring
        self.mismatches = 0

    @property
    def epoch(self) -> int:
        return self.current.epoch

    def note_epoch_mismatch(self) -> None:
        self.mismatches += 1

    def adopt(self, ring_dict: dict, source: str = "client") -> bool:
        new = RingMap.from_dict(ring_dict)
        if (new.epoch, new.fingerprint) <= (self.current.epoch,
                                            self.current.fingerprint):
            return False
        self.current = new
        return True


class SmartClient:
    """The data-plane client: :meth:`upload`, :meth:`download`,
    :meth:`stats`, :meth:`close`, and everything :class:`NodeClient` offers
    through :attr:`legacy`. ``device`` is where the client chunks: None is
    the CUDA card (an upload raises without one, it never turns into a
    legacy upload), "cpu" the plain versions. Every
    :class:`~dfs_tpu_torch.config.ClientConfig` knob is a key of
    :meth:`stats` and a ``--client-*`` flag of ``upload``/``download``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 5001,
                 cfg: ClientConfig | None = None,
                 timeout_s: float = 30.0, device=None) -> None:
        self.cfg = cfg or ClientConfig()
        self.legacy = NodeClient(host, port, timeout_s=timeout_s)
        self.timeout_s = timeout_s
        self.device = device
        # None: not fetched yet; False: the server has no /dataplane (the
        # client stays on the legacy path for its lifetime)
        self._boot: dict | bool | None = None
        self._ringview: _ClientRingView | None = None
        self._peers: dict[int, PeerAddr] = {}
        self._rf = 1
        self._desc: dict | None = None     # the node's describe(), checked
        self._frag = None
        # filter replicas: node_id -> {"bloom", "gen", "fetchedAt",
        # "baseAgeS"}, fetched in one get_filters call and refetched when
        # older than cfg.filter_max_age_s
        self._filters: dict[int, dict] = {}
        self._filters_at = 0.0
        self._echo = EchoCache(self.cfg.echo_cache_entries) \
            if self.cfg.echo_cache_entries > 0 else None
        self._hedge = HedgePolicy(
            self.cfg.hedge_floor_s, self.cfg.hedge_cap_s,
            self.cfg.hedge_budget_per_s) \
            if self.cfg.hedge_budget_per_s > 0 else None
        self.counters = {
            "smartUploads": 0, "smartDownloads": 0,
            "legacyUploads": 0, "legacyDownloads": 0,
            "fallbacks": 0, "transferredBytes": 0,
            "dedupSkippedBytes": 0, "probeRpcs": 0, "verifyRpcs": 0,
            "filterFp": 0, "chunksVerified": 0, "healedChunks": 0,
            "filterRefreshes": 0}
        self._last_fallback: str | None = None

    # ------------------------------------------------------------------ #
    # bootstrap
    # ------------------------------------------------------------------ #

    def _bootstrap(self) -> None:
        """Fetch the data-plane description once. A 404 pins this client
        to the legacy path: the server predates the protocol."""
        if self._boot is not None:
            return
        try:
            boot = json.loads(self.legacy._request("GET", "/dataplane"))
        except RuntimeError as e:
            if "HTTP 404" in str(e):
                self._boot = False
                return
            raise
        self._install_boot(boot)

    def _install_boot(self, boot: dict) -> None:
        desc = None
        chunking = boot.get("chunking")
        if chunking and chunking.get("describe"):
            # only the kind and fields are read here: the fragmenter, and
            # the device it needs, wait for the first upload (a download
            # never chunks)
            try:
                params_from_description(chunking["describe"])
                desc = chunking["describe"]
            except (ValueError, KeyError):
                desc = None     # an engine the port cannot chunk: legacy
        self._ringview = _ClientRingView(RingMap.from_dict(boot["ring"]))
        self._peers = {int(p["nodeId"]): PeerAddr(
            node_id=int(p["nodeId"]), host=str(p["host"]),
            port=int(p["port"]), internal_port=int(p["internalPort"]))
            for p in boot["peers"]}
        self._rf = int(boot["replicationFactor"])
        self._desc = desc
        self._boot = boot

    def _smart_ready(self) -> bool:
        self._bootstrap()
        return bool(self._boot) and self._desc is not None \
            and self._ringview is not None

    def _fragmenter(self):
        """The node's chunking engine, built on the first upload: the
        anchored chain on ``device``, or a host strategy (``fixed``,
        ``cdc``) that needs no device. Without a card the anchored
        engine's RuntimeError is not caught: it reaches the caller and
        never becomes a legacy upload."""
        if self._frag is None:
            self._frag = fragmenter_from_description(self._desc,
                                                     device=self.device)
        return self._frag

    def _note_fallback(self, reason: str) -> None:
        self.counters["fallbacks"] += 1
        self._last_fallback = reason

    def _rpc(self) -> InternalClient:
        """A fresh storage-plane client bound to the current event loop
        (one per operation)."""
        return InternalClient(request_timeout_s=self.timeout_s,
                              ring=self._ringview)

    # ------------------------------------------------------------------ #
    # filters
    # ------------------------------------------------------------------ #

    async def _ensure_filters(self, rpc: InternalClient) -> None:
        """One ``get_filters`` call to the bootstrap node, repeated when
        the copy is older than ``filter_max_age_s`` (0: every upload). No
        filters, or a failed call, means the probing path, never an
        error."""
        max_age = self.cfg.filter_max_age_s
        now = time.monotonic()
        if self._filters and max_age > 0 \
                and now - self._filters_at < max_age:
            return
        boot_nid = int(self._boot["nodeId"])  # type: ignore[index]
        try:
            got = await rpc.get_filters(self._peers[boot_nid], retries=1)
        except RpcError:
            # a peer without the op, or a sick node: probe everything
            self._filters = {}
            self._filters_at = now
            return
        filters: dict[int, dict] = {}
        for meta, blob in got:
            try:
                bloom = BlockedBloomFilter(
                    int(meta["capacity"]), int(meta["bitsPerKey"]),
                    buf=bytearray(blob))
                filters[int(meta["nodeId"])] = {
                    "bloom": bloom, "gen": int(meta["gen"]),
                    "fetchedAt": now,
                    "baseAgeS": float(meta.get("ageS", 0.0))}
            except (KeyError, ValueError, TypeError):
                continue   # one malformed entry never poisons the rest
        self._filters = filters
        self._filters_at = now
        self.counters["filterRefreshes"] += 1

    def _filter_verdict(self, nid: int, digest: str) -> bool | None:
        """Tri-state, as ``PeerFilterSet.contains``: True = maybe present
        (verified before the commit), False = absent at the filter's
        generation (send), None = no usable filter (probe). A replica past
        the freshness bound is unusable."""
        st = self._filters.get(nid)
        if st is None:
            return None
        max_age = self.cfg.filter_max_age_s
        if max_age > 0:
            age = st["baseAgeS"] + (time.monotonic() - st["fetchedAt"])
            if age > max_age:
                return None
        try:
            return st["bloom"].contains(digest)
        except ValueError:
            return None

    # ------------------------------------------------------------------ #
    # upload
    # ------------------------------------------------------------------ #

    def upload(self, data: bytes, name: str = "") -> dict:
        """The single-hop upload where the cluster supports it, else the
        legacy coordinator POST. Returns the server's reply plus
        ``clientBytesSent`` (payload bytes that crossed the wire) and
        ``dataPlane`` ("smart" or "legacy")."""
        self._bootstrap()
        if self._smart_ready():
            try:
                return self._upload_smart(data, name)
            except _Fallback as e:
                self._note_fallback(e.reason)
                if not self.cfg.fallback:
                    raise SmartClientError(
                        f"smart upload failed ({e.reason}) and fallback "
                        "is disabled") from e
        elif not self.cfg.fallback:
            raise SmartClientError(
                "cluster has no smart data plane and fallback is "
                "disabled")
        out = self.legacy.upload(data, name)
        out["clientBytesSent"] = len(data)
        out["dataPlane"] = "legacy"
        self.counters["legacyUploads"] += 1
        self.counters["transferredBytes"] += len(data)
        return out

    def _upload_smart(self, data: bytes, name: str) -> dict:
        refs = self._fragmenter().chunk(data)
        table = [[c.offset, c.length, c.digest] for c in refs]
        file_id = sha256_hex(data)
        payload_of = {c.digest: data[c.offset:c.offset + c.length]
                      for c in refs}   # first occurrence wins
        if self._echo is not None:
            self._echo.note_epoch(self._ringview.epoch)
        sent_bytes = asyncio.run(self._stripe_upload(payload_of))
        # the commit stays one coordinator call with a regular upload's
        # ack (fsync before ack, deadline, quorum)
        meta = json.dumps({"fileId": file_id, "size": len(data),
                           "chunks": table}).encode()
        body = len(meta).to_bytes(4, "big") + meta
        q = urllib.parse.urlencode({"name": name})
        try:
            out = json.loads(self.legacy._request(
                "POST", f"/commit?{q}", body=body))
        except RuntimeError as e:
            if "HTTP 409" in str(e) or "HTTP 404" in str(e):
                # chunks not durably present, or an old coordinator:
                # nothing was acked
                raise _Fallback(f"commit refused: {e}") from e
            raise
        out["clientBytesSent"] = sent_bytes + len(body)
        out["dataPlane"] = "smart"
        self.counters["smartUploads"] += 1
        return out

    async def _stripe_upload(self, payload_of: dict[str, bytes]) -> int:
        """Stripe payloads to the rf ring owners; returns the payload
        bytes sent. Raises :class:`_Fallback` when some digest reached no
        owner (the commit would answer 409)."""
        rpc = self._rpc()
        try:
            await self._ensure_filters(rpc)
            ring = self._ringview.current
            per_peer: dict[int, list[str]] = {}
            for d in payload_of:
                for nid in ring.owners(d, self._rf):
                    per_peer.setdefault(nid, []).append(d)
            landed: set[str] = set()   # >= 1 first-party confirmation
            sent = 0

            async def one_peer(nid: int, digests: list[str]) -> None:
                nonlocal sent
                peer = self._peers.get(nid)
                if peer is None:
                    return      # not in the address book: the other
                                # owners and the commit's heal cover it
                # echo-confirmed: skip; filter positive: trusted (verified
                # before the commit); filter negative: send; no verdict:
                # probe
                trusted: list[str] = []
                to_probe: list[str] = []
                to_send: list[str] = []
                for d in digests:
                    if self._echo is not None \
                            and self._echo.confirmed(nid, d):
                        landed.add(d)
                        self.counters["dedupSkippedBytes"] += \
                            len(payload_of[d])
                        continue
                    verdict = self._filter_verdict(nid, d)
                    if verdict is True:
                        trusted.append(d)
                    elif verdict is False:
                        to_send.append(d)
                    else:
                        to_probe.append(d)
                if to_probe:
                    self.counters["probeRpcs"] += 1
                    resp, _ = await rpc.call(
                        peer, {"op": "has_chunks", "digests": to_probe})
                    have = set(resp.get("have", []))
                    for d in to_probe:
                        if d in have:
                            landed.add(d)
                            if self._echo is not None:
                                self._echo.confirm(nid, d)
                            self.counters["dedupSkippedBytes"] += \
                                len(payload_of[d])
                        else:
                            to_send.append(d)
                # await first, then add: `sent += await ...` reads `sent`
                # before the suspension and loses the other peers' updates
                n = await self._send_chunks(rpc, peer, nid, to_send,
                                            payload_of, landed)
                sent += n
                # the trust round: every filter-credited skip re-checked
                # first-party before the commit; a stale or corrupt bloom
                # costs this probe and a real send, never a phantom
                if trusted:
                    self.counters["verifyRpcs"] += 1
                    resp, _ = await rpc.call(
                        peer, {"op": "has_chunks", "digests": trusted})
                    have = set(resp.get("have", []))
                    heal = [d for d in trusted if d not in have]
                    for d in trusted:
                        if d in have:
                            landed.add(d)
                            if self._echo is not None:
                                self._echo.confirm(nid, d)
                            self.counters["dedupSkippedBytes"] += \
                                len(payload_of[d])
                    if heal:
                        self.counters["filterFp"] += len(heal)
                        n = await self._send_chunks(
                            rpc, peer, nid, heal, payload_of, landed)
                        sent += n

            results = await asyncio.gather(
                *(one_peer(n, ds) for n, ds in per_peer.items()),
                return_exceptions=True)
            hard = [r for r in results
                    if isinstance(r, BaseException)
                    and not isinstance(r, RpcError)]
            if hard:
                raise hard[0]
            not_landed = [d for d in payload_of if d not in landed]
            if not_landed:
                # every owner of some digest unreachable (the RpcErrors
                # swallowed above): the commit would answer 409
                raise _Fallback(
                    f"{len(not_landed)} chunks reached no owner")
            return sent
        finally:
            rpc.close()

    async def _send_chunks(self, rpc: InternalClient, peer: PeerAddr,
                           nid: int, digests: list[str],
                           payload_of: dict[str, bytes],
                           landed: set[str]) -> int:
        """A windowed slice train to one owner, each slice's hash echo
        verified."""
        if not digests:
            return 0
        items = [(d, payload_of[d]) for d in digests]
        slices = _slice_items(items, _READ_BATCH_BYTES)
        sent = 0

        def on_slice(part: list[tuple[str, bytes]],
                     echoed: list[str]) -> None:
            nonlocal sent
            got = set(echoed)
            missing = [d for d, _ in part if d not in got]
            if missing:
                raise RpcRemoteError(
                    f"hash echo mismatch from node {nid}")
            for d, b in part:
                landed.add(d)
                sent += len(b)
                self.counters["transferredBytes"] += len(b)
                if self._echo is not None:
                    self._echo.confirm(nid, d)

        try:
            await rpc.store_chunks_windowed(
                peer, "client-upload", slices,
                window=self.cfg.window, on_slice=on_slice)
        except RpcError:
            if self._echo is not None:
                self._echo.drop(nid)
            raise
        return sent

    # ------------------------------------------------------------------ #
    # download
    # ------------------------------------------------------------------ #

    def download(self, file_id: str) -> bytes:
        """A striped read from the owners, every chunk's digest and the
        whole stream's hash checked here. EC manifests and any gap that
        cannot be mended fall back to the legacy coordinator read."""
        self._bootstrap()
        if self._smart_ready():
            try:
                return self._download_smart(file_id)
            except _Fallback as e:
                self._note_fallback(e.reason)
                if not self.cfg.fallback:
                    raise SmartClientError(
                        f"smart download failed ({e.reason}) and "
                        "fallback is disabled") from e
        elif not self.cfg.fallback:
            raise SmartClientError(
                "cluster has no smart data plane and fallback is "
                "disabled")
        data = self.legacy.download(file_id)
        self.counters["legacyDownloads"] += 1
        return data

    def _download_smart(self, file_id: str) -> bytes:
        try:
            mdoc = self.legacy.manifest(file_id)
        except RuntimeError as e:
            raise _Fallback(f"manifest fetch failed: {e}") from e
        if mdoc.get("ec"):
            raise _Fallback("ec manifest (coordinator decodes parity)")
        chunks = [(int(c["offset"]), int(c["length"]), str(c["digest"]))
                  for c in mdoc.get("chunks", [])]
        size = int(mdoc.get("size", 0))
        got = asyncio.run(self._stripe_download(file_id, chunks))
        out = bytearray(size)
        for off, ln, d in chunks:
            out[off:off + ln] = got[d]
        data = bytes(out)
        if is_hex_digest(file_id) and sha256_hex(data) != file_id:
            # every chunk was verified, so a whole-stream miss means a
            # wrong or torn manifest: re-read through the coordinator
            raise _Fallback("assembled stream hash mismatch")
        self.counters["smartDownloads"] += 1
        return data

    async def _stripe_download(self, file_id: str,
                               chunks: list[tuple[int, int, str]]
                               ) -> dict[str, bytes]:
        """digest -> verified bytes for every chunk, striped across the
        owners (``cfg.stripe`` batches in flight), hedged under the token
        budget; a missed chunk walks its candidates, then takes a ranged
        coordinator read."""
        rpc = self._rpc()
        try:
            ring = self._ringview.current
            need: dict[str, int] = {}
            span_of: dict[str, tuple[int, int]] = {}
            for off, ln, d in chunks:
                if d not in need:
                    need[d] = ln
                    span_of[d] = (off, ln)
            # digests spread round-robin over their owner sets, so the rf
            # replicas share the reads
            groups: dict[int, list[str]] = {}
            for i, (d, ln) in enumerate(need.items()):
                owners = [n for n in ring.owners(d, self._rf)
                          if n in self._peers]
                if not owners:
                    continue
                groups.setdefault(owners[i % len(owners)], []).append(d)
            out: dict[str, bytes] = {}
            sem = asyncio.Semaphore(self.cfg.stripe)

            async def fetch_group(nid: int, digests: list[str]) -> None:
                for batch in _batch_digests(digests, need,
                                            _READ_BATCH_BYTES):
                    expect = sum(need[d] for d in batch)
                    async with sem:
                        try:
                            pairs = await self._hedged_get(
                                rpc, nid, batch, expect)
                        except RpcError:
                            continue    # the mop-up covers the batch
                    for d, view in pairs:
                        b = bytes(view)
                        if d in need and sha256_hex(b) == d:
                            out[d] = b
                            self.counters["chunksVerified"] += 1

            await asyncio.gather(
                *(fetch_group(n, ds) for n, ds in groups.items()))
            # mop-up: a candidate walk for anything missed (wrong owner,
            # dead peer, corrupt reply), then a ranged coordinator read
            for d in [d for d in need if d not in out]:
                b = await self._fetch_one(rpc, ring, d, need[d])
                if b is None:
                    off, ln = span_of[d]
                    try:
                        b = await asyncio.to_thread(
                            self.legacy.download_range, file_id, off,
                            off + ln)
                    except RuntimeError as e:
                        raise _Fallback(
                            f"chunk {d[:12]}… unrecoverable: {e}") from e
                    if sha256_hex(b) != d:
                        raise _Fallback(
                            f"chunk {d[:12]}… digest mismatch from "
                            "coordinator")
                    self.counters["chunksVerified"] += 1
                    self.counters["healedChunks"] += 1
                out[d] = b
            return out
        finally:
            rpc.close()

    async def _fetch_one(self, rpc: InternalClient, ring: RingMap,
                         digest: str, length: int) -> bytes | None:
        for nid in ring.owners(digest, len(ring.active_ids())):
            peer = self._peers.get(nid)
            if peer is None:
                continue
            try:
                pairs = await rpc.get_chunks(peer, [digest], retries=1,
                                             expect_bytes=length)
            except RpcError:
                continue
            for d, view in pairs:
                b = bytes(view)
                if d == digest and sha256_hex(b) == digest:
                    self.counters["chunksVerified"] += 1
                    self.counters["healedChunks"] += 1
                    return b
        return None

    async def _hedged_get(self, rpc: InternalClient, nid: int,
                          digests: list[str], expect: int):
        """Client-side hedging under the token budget: the batch races to
        the next owner when the primary outlives the delay and a token is
        left."""
        peer = self._peers[nid]
        hedge = self._hedge
        backup = None
        if hedge is not None:
            ring = self._ringview.current
            backup = next(
                (self._peers[n] for n in
                 ring.owners(digests[0], len(ring.active_ids()))
                 if n != nid and n in self._peers), None)
        if hedge is None or backup is None:
            return await rpc.get_chunks(peer, digests,
                                        expect_bytes=expect)
        task = asyncio.create_task(
            rpc.get_chunks(peer, digests, expect_bytes=expect))
        btask: asyncio.Task | None = None

        async def reap() -> None:
            task.cancel()
            if btask is not None:
                btask.cancel()
            await asyncio.gather(
                task, *([btask] if btask is not None else []),
                return_exceptions=True)

        # no latency history at the client: the floor is the delay
        delay = hedge.delay_s(None)
        try:
            return await asyncio.wait_for(asyncio.shield(task), delay)
        except asyncio.TimeoutError:
            pass                        # primary in flight: hedge below
        except asyncio.CancelledError:
            await reap()
            raise
        if not hedge.take():
            try:
                return await task
            except asyncio.CancelledError:
                await reap()
                raise
        hedge.note_fired()
        btask = asyncio.create_task(
            rpc.get_chunks(backup, digests, expect_bytes=expect))
        try:
            done, _ = await asyncio.wait(
                {task, btask}, return_when=asyncio.FIRST_COMPLETED)
        except asyncio.CancelledError:
            await reap()
            raise
        first, other = (task, btask) if task in done else (btask, task)
        if first.exception() is None:
            other.cancel()
            try:
                await other
            except (asyncio.CancelledError, RpcError):
                pass
            if first is btask:
                hedge.note_won()
            return first.result()
        try:
            got = await other
        except asyncio.CancelledError:
            await reap()
            raise
        if other is btask:
            hedge.note_won()
        return got

    # ------------------------------------------------------------------ #
    # introspection, lifecycle
    # ------------------------------------------------------------------ #

    def stats(self) -> dict:
        """Every ClientConfig field and the data-plane counters."""
        out = {"window": self.cfg.window,
               "stripe": self.cfg.stripe,
               "hedgeBudgetPerS": self.cfg.hedge_budget_per_s,
               "hedgeFloorS": self.cfg.hedge_floor_s,
               "hedgeCapS": self.cfg.hedge_cap_s,
               "filterMaxAgeS": self.cfg.filter_max_age_s,
               "echoCacheEntries": self.cfg.echo_cache_entries,
               "fallback": self.cfg.fallback,
               "smart": self._smart_ready(),
               "ringEpoch": self._ringview.epoch
               if self._ringview is not None else None,
               "ringMismatches": self._ringview.mismatches
               if self._ringview is not None else 0,
               "filterPeers": sorted(self._filters),
               "lastFallback": self._last_fallback,
               **self.counters}
        if self._echo is not None:
            out["echoCache"] = self._echo.stats()
        if self._hedge is not None:
            out["hedge"] = self._hedge.stats()
        return out

    def close(self) -> None:
        """Nothing pooled outlives an operation; kept for symmetry."""


def _slice_items(items: list[tuple[str, bytes]],
                 max_bytes: int) -> list[list[tuple[str, bytes]]]:
    out: list[list[tuple[str, bytes]]] = []
    cur: list[tuple[str, bytes]] = []
    size = 0
    for d, b in items:
        if cur and size + len(b) > max_bytes:
            out.append(cur)
            cur, size = [], 0
        cur.append((d, b))
        size += len(b)
    if cur:
        out.append(cur)
    return out


def _batch_digests(digests: list[str], length_of: dict[str, int],
                   max_bytes: int) -> list[list[str]]:
    out: list[list[str]] = []
    cur: list[str] = []
    size = 0
    for d in digests:
        if cur and size + length_of[d] > max_bytes:
            out.append(cur)
            cur, size = [], 0
        cur.append(d)
        size += length_of[d]
    if cur:
        out.append(cur)
    return out
