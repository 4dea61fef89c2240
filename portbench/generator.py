"""The one general traffic generator. A mix (``traffic/<mix>.json``) is
data; this module turns it into bodies and drives the entry with them.

Bodies come from the seed alone. With ``base: "corpus"`` the agents'
base files are a fixed corpus, one file per agent, each ``file_bytes``
random bytes from ``(corpus_seed, i)``, and the seed deals them out:
agent ``a`` stores file ``i`` of a permutation drawn from the seed. Every
seed so stores the same files, with the same chunk sizes and so the same
work; what the seed changes is who sends which file and every edit. An
agent's upload ``g`` in a stream (``warm`` before the window, ``window``
inside it) is its base with the mix's ``edits`` applied in order, each
edit's offset and bytes drawn from ``(seed, a, stream, g)``. Edits are
not cumulative, so any upload can be rebuilt from its numbers. ``base:
"fresh"`` makes every upload new random bytes from ``(seed, a, stream,
g)`` (first backups).

An agent is a closed loop: one process per agent, which sends its next
upload only once the last one is acknowledged. An upload is sent from the
base file's own buffer and the edits' new bytes, with no copy of the
whole, so that making bodies takes next to no time from the nodes.
"""

from __future__ import annotations

import http.client
import json
import time

import numpy as np

STREAMS = {"warm": 1, "window": 2}


def _rng(*key: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(
        [k % 2**64 for k in key])))


def corpus_index(mix: dict, seed: int, agent: int) -> int:
    """The corpus file that the seed deals to ``agent``."""
    return int(_rng(seed).permutation(mix["agents"])[agent])


def base_file(mix: dict, seed: int, agent: int) -> np.ndarray | None:
    """Agent ``agent``'s stored base file, or None for a mix without one."""
    if mix["base"] != "corpus":
        return None
    rng = _rng(mix["corpus_seed"], corpus_index(mix, seed, agent))
    return np.frombuffer(rng.bytes(mix["file_bytes"]), np.uint8)


def pieces(mix: dict, seed: int, agent: int, stream: str, g: int,
           base: np.ndarray | None) -> list:
    """Upload ``g`` of ``stream`` (``warm`` or ``window``) by ``agent``, as
    the buffers that make it up in order: slices of ``base`` (no copy) and
    the edits' new bytes."""
    rng = _rng(seed, agent, STREAMS[stream], g)
    if mix["base"] == "fresh":
        return [np.frombuffer(rng.bytes(mix["file_bytes"]), np.uint8)]
    if mix["base"] != "corpus":
        raise ValueError(f"unknown base {mix['base']!r}")
    out, size = [base], base.shape[0]
    for e in mix["edits"]:
        n = int(e["bytes"])
        if e["kind"] == "overwrite":
            at = int(rng.integers(0, size - n + 1))
            out = _splice(out, at, n, rng.bytes(n))
        elif e["kind"] == "insert":
            at = int(rng.integers(0, size + 1))
            out = _splice(out, at, 0, rng.bytes(n))
            size += n
        else:
            raise ValueError(f"unknown edit {e['kind']!r}")
    return out


def _splice(parts: list, at: int, cut: int, new: bytes) -> list:
    """``parts`` with bytes [at, at + cut) replaced by ``new``."""
    head, tail, pos = [], [], 0
    for p in parts:
        end = pos + len(p)
        if pos < at:
            head.append(p[:at - pos])
        if end > at + cut:
            tail.append(p[max(0, at + cut - pos):])
        pos = end
    return [q for q in head + [np.frombuffer(new, np.uint8)] + tail
            if len(q)]


def body(mix: dict, seed: int, agent: int, stream: str, g: int,
         base: np.ndarray | None) -> np.ndarray:
    """Upload ``g`` of ``stream`` by ``agent``, whole."""
    return np.concatenate(pieces(mix, seed, agent, stream, g, base))


def blocks(parts: list, block: int):
    """The bytes of ``parts`` in ``block``-byte pieces (the last shorter),
    slices where a block lies inside one part, joined where it spans two."""
    pending, have = [], 0
    for p in parts:
        mv = memoryview(p)
        while len(mv):
            take = min(block - have, len(mv))
            pending.append(mv[:take])
            have += take
            mv = mv[take:]
            if have == block:
                yield pending[0] if len(pending) == 1 else b"".join(pending)
                pending, have = [], 0
    if have:
        yield pending[0] if len(pending) == 1 else b"".join(pending)


def upload(port: int, parts: list, name: str, block: int,
           timeout: float = 600.0) -> dict:
    """One chunked POST /upload of the bytes of ``parts``, in
    ``block``-byte pieces, framed here so that no block is copied. Returns
    the record: monotonic start and end, status, the answer's JSON."""
    def framed():
        for b in blocks(parts, block):
            yield f"{len(b):X}\r\n".encode("ascii")
            yield b
            yield b"\r\n"
        yield b"0\r\n\r\n"

    rec = {"bytes": sum(len(p) for p in parts), "status": 0, "resp": None,
           "error": None}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    rec["t_start"] = time.monotonic()
    try:
        conn.request("POST", f"/upload?name={name}", body=framed(),
                     headers={"Transfer-Encoding": "chunked"})
        r = conn.getresponse()
        payload = r.read()
        rec["status"] = r.status
        if r.status == 201:
            rec["resp"] = json.loads(payload)
        else:
            rec["error"] = payload[:300].decode("utf-8", "replace")
    except (OSError, http.client.HTTPException, ValueError) as e:
        rec["error"] = f"{type(e).__name__}: {e}"
    finally:
        rec["t_end"] = time.monotonic()
        conn.close()
    return rec


def agent_main(conn, mix: dict, seed: int, agent: int, port: int,
               chunk: dict) -> None:
    """One agent process, driven by the harness over ``conn``:

    1. stores its base file and its warm uploads, answers ``ready``;
    2. on ``("go", start, t1)`` sends uploads back to back from
       ``start`` and starts none after ``t1``; answers ``done`` with every
       record and the seconds it spent making bodies;
    3. on ``("verify", gs)`` answers the SHA-256 of each acknowledged
       upload, and for each ``g`` in ``gs`` the reference chunk table;
    4. exits; any other message in place of the next one ends it."""
    import hashlib

    from portbench.reference import anchored

    name = f"agent{agent}"
    block = mix["block_bytes"]
    base = base_file(mix, seed, agent)
    setup = []
    if base is not None:
        setup.append(upload(port, [base], f"{name}-base.img", block))
    for i in range(mix["warm_uploads"]):
        setup.append(upload(port, pieces(mix, seed, agent, "warm", i, base),
                            f"{name}-warm{i}.img", block))
    conn.send(("ready", setup))

    msg = conn.recv()
    if msg[0] != "go":
        return
    start, t1 = msg[1], msg[2]
    records, build_s, g = [], 0.0, 0
    time.sleep(max(0.0, start - time.monotonic()))
    while time.monotonic() < t1:
        b0 = time.monotonic()
        parts = pieces(mix, seed, agent, "window", g, base)
        build_s += time.monotonic() - b0
        rec = upload(port, parts, f"{name}-g{g}.img", block)
        rec["g"] = g
        records.append(rec)
        g += 1
    conn.send(("done", records, {"build_s": build_s}))

    msg = conn.recv()
    if msg[0] != "verify":
        return
    params = anchored.params_for(chunk["min"], chunk["avg"],
                                 chunk["max"])
    sums, tables = {}, {}
    for rec in records:
        if rec["status"] == 201:
            g = rec["g"]
            parts = pieces(mix, seed, agent, "window", g, base)
            h = hashlib.sha256()
            for p in parts:
                h.update(p)
            sums[g] = h.hexdigest()
            if g in msg[1]:
                tables[g] = anchored.chunk_table(np.concatenate(parts),
                                                 params)
    conn.send(("verified", sums, tables))
