"""The smart client (a port of dfs_tpu's ``client`` package): an SDK that
runs the data plane at the client's edge. It chunks and hashes locally
with the cluster's exact parameters (on the CUDA card by default), reads
the peers' existence filters so it sends only what is missing, stripes
payloads straight to the rf ring owners over the storage plane (windowed,
each slice hash-echo verified) and commits with one coordinator call.
Downloads stripe reads across the owners, hedged under a token budget,
and verify every chunk and the whole stream at the client.

It falls back to the legacy coordinator path
(:class:`dfs_tpu_torch.cli.client.NodeClient`) where the smart plane
cannot run: a server without ``/dataplane``, a refused commit, chunks
that reached no owner, an EC manifest, an undescribable fragmenter. A
missing card is not among them: it raises.
"""

from dfs_tpu_torch.client.smart import SmartClient, SmartClientError

__all__ = ["SmartClient", "SmartClientError"]
