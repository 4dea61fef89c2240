"""Synchronous HTTP client of one node (a copy of the parts of dfs_tpu's
``cli/client.py`` that the port's routes serve), on urllib. A
``trace_id`` on upload or download rides the ``X-Dfs-Trace`` header.
``upload_resume`` chunks the body in this process, on the CUDA card
unless ``device="cpu"`` is asked for."""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass

DEFAULT_TIMEOUT_S = 5.0


@dataclass(frozen=True)
class RemoteFile:
    file_id: str
    name: str
    size: int = 0
    chunks: int = 0


class NodeClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 5001,
                 timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
        self.base = f"http://{host}:{port}"
        self.timeout_s = timeout_s

    def _request(self, method: str, path: str, body=None,
                 headers: dict | None = None) -> bytes:
        req = urllib.request.Request(self.base + path, data=body,
                                     method=method, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            detail = e.read().decode("utf-8", "replace")
            raise RuntimeError(f"HTTP {e.code}: {detail}") from e

    def status(self) -> str:
        return self._request("GET", "/status").decode()

    def list_files(self) -> list[RemoteFile]:
        items = json.loads(self._request("GET", "/files"))
        return [RemoteFile(file_id=i["fileId"],
                           name=i.get("name", i["fileId"]),
                           size=i.get("size", 0), chunks=i.get("chunks", 0))
                for i in items]

    @staticmethod
    def _trace_headers(trace_id: str | None) -> dict:
        """The ``X-Dfs-Trace`` carrier of a client-minted trace id: the
        nodes tag every span of the request with it, and :meth:`trace`
        stitches them afterwards."""
        if not trace_id:
            return {}
        from dfs_tpu_torch.obs import new_span_id

        return {"X-Dfs-Trace": f"{trace_id}-{new_span_id()}"}

    def upload(self, data: bytes, name: str, ec: int = 0,
               trace_id: str | None = None) -> dict:
        """Whole-body upload; ``ec`` > 0 erasure-codes it with k = ec."""
        params = {"name": name}
        if ec:
            params["ec"] = str(ec)
        q = urllib.parse.urlencode(params)
        return json.loads(self._request(
            "POST", f"/upload?{q}", body=data,
            headers=self._trace_headers(trace_id)))

    def upload_stream(self, blocks, name: str) -> dict:
        """Upload with chunked transfer encoding (urllib sends a
        length-less iterable chunked); the node ingests it in bounded
        memory."""
        q = urllib.parse.urlencode({"name": name})
        return json.loads(self._request("POST", f"/upload?{q}",
                                        body=iter(blocks)))

    def chunking(self) -> dict:
        return json.loads(self._request("GET", "/chunking"))

    def missing(self, digests: list[str]) -> list[str]:
        body = json.dumps(digests).encode()
        return json.loads(self._request(
            "POST", "/missing", body=body))["missing"]

    def upload_resume(self, data: bytes, name: str,
                      trace_id: str | None = None, device=None) -> dict:
        """Resumable upload: chunk locally with the node's advertised
        parameters (on ``device``: None is the CUDA card, raising without
        one; "cpu" the plain versions), ask which digests the cluster
        lacks, and send only those payloads with the table. Returns the
        node's reply plus ``clientBytesSent``. A node without a
        describable fragmenter gets a plain upload; a 409 (a chunk
        vanished between the probe and the resume) falls back to one."""
        from dfs_tpu_torch.fragmenter.base import fragmenter_from_description
        from dfs_tpu_torch.utils.hashing import sha256_hex

        try:
            desc = self.chunking()
        except RuntimeError:
            out = self.upload(data, name, trace_id=trace_id)
            out["clientBytesSent"] = len(data)
            return out
        frag = fragmenter_from_description(desc["describe"], device=device)
        refs = frag.chunk(data)
        by_digest = {c.digest: c for c in refs}        # first occurrence
        missing = set(self.missing(list(by_digest)))
        provided = [(d, data[c.offset:c.offset + c.length])
                    for d, c in by_digest.items() if d in missing]
        meta = json.dumps({
            "fileId": sha256_hex(data),
            "size": len(data),
            "chunks": [[c.offset, c.length, c.digest] for c in refs],
            "provided": [d for d, _ in provided]}).encode()
        body = (len(meta).to_bytes(4, "big") + meta
                + b"".join(b for _, b in provided))
        q = urllib.parse.urlencode({"name": name})
        try:
            out = json.loads(self._request(
                "POST", f"/upload_resume?{q}", body=body,
                headers=self._trace_headers(trace_id)))
        except RuntimeError as e:
            if "HTTP 409" not in str(e):
                raise
            out = self.upload(data, name, trace_id=trace_id)
            out["clientBytesSent"] = len(body) + len(data)
            return out
        out["clientBytesSent"] = len(body)
        return out

    def download(self, file_id: str, trace_id: str | None = None) -> bytes:
        q = urllib.parse.urlencode({"fileId": file_id})
        return self._request("GET", f"/download?{q}",
                             headers=self._trace_headers(trace_id))

    def download_range(self, file_id: str, start: int, end: int) -> bytes:
        """Bytes [start, end) through an HTTP Range request (206)."""
        q = urllib.parse.urlencode({"fileId": file_id})
        return self._request("GET", f"/download?{q}",
                             headers={"Range": f"bytes={start}-{end - 1}"})

    def scrub(self) -> dict:
        """One integrity sweep of the node's CAS (``POST /scrub``)."""
        return json.loads(self._request("POST", "/scrub", body=b""))

    def manifest(self, file_id: str) -> dict:
        q = urllib.parse.urlencode({"fileId": file_id})
        return json.loads(self._request("GET", f"/manifest?{q}"))

    def metrics(self) -> dict:
        return json.loads(self._request("GET", "/metrics"))

    def metrics_prom(self) -> str:
        """The OpenMetrics page (``/metrics?format=prom``)."""
        return self._request("GET", "/metrics?format=prom").decode()

    def trace(self, trace_id: str) -> dict:
        """The stitched spans of one trace, gathered by the contacted
        node from every peer."""
        q = urllib.parse.urlencode({"traceId": trace_id})
        return json.loads(self._request("GET", f"/trace?{q}"))

    def events(self, since: float = 0.0, limit: int = 256) -> dict:
        """Recent flight-recorder events of the contacted node."""
        q = urllib.parse.urlencode({"since": since, "limit": limit})
        return json.loads(self._request("GET", f"/events?{q}"))

    def doctor(self, cluster: bool = True) -> dict:
        """The doctor report (``GET /doctor``); render it with
        :func:`dfs_tpu_torch.obs.doctor.render_report`."""
        q = urllib.parse.urlencode({"cluster": "1" if cluster else "0"})
        return json.loads(self._request("GET", f"/doctor?{q}"))

    def census(self, cluster: bool = True) -> dict:
        """The census and capacity report (``GET /census``); render it
        with :func:`dfs_tpu_torch.obs.census.render_census` or
        ``render_df``."""
        q = urllib.parse.urlencode({"cluster": "1" if cluster else "0"})
        return json.loads(self._request("GET", f"/census?{q}"))

    def history(self, name: str | None = None) -> dict:
        """``GET /metrics/history``: the series directory, or one
        series at both resolutions."""
        path = "/metrics/history"
        if name:
            path += "?" + urllib.parse.urlencode({"name": name})
        return json.loads(self._request("GET", path))

    def ring_status(self, cluster: bool = True) -> dict:
        """``GET /ring``: epoch, members, migration and rebalance state,
        and every peer's epoch."""
        q = urllib.parse.urlencode({"cluster": "1" if cluster else "0"})
        return json.loads(self._request("GET", f"/ring?{q}"))

    def ring_admin(self, action: str, node_id: int | None = None,
                   weight: float | None = None) -> dict:
        """``POST /ring``: add, drain, remove or reweight a member; the
        contacted node bumps the epoch and pushes it to every peer."""
        body: dict = {"action": action}
        if node_id is not None:
            body["nodeId"] = node_id
        if weight is not None:
            body["weight"] = weight
        return json.loads(self._request(
            "POST", "/ring", body=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}))

    def delete(self, file_id: str) -> str:
        q = urllib.parse.urlencode({"fileId": file_id})
        return self._request("DELETE", f"/files?{q}").decode()
