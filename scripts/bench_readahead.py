#!/usr/bin/env python3
"""Download readahead alone, on an NVIDIA card: what ``serve --readahead
2`` does to a streamed download against ``--readahead 0``, every other
flag at its default (no cache, no hedging).

The 256 MiB body of ``chip_smoke.py`` (seed 20261016) is streamed in 1 MiB
blocks to node 1 of 5 ``python -m dfs_tpu_torch.cli.main serve`` processes
(rf 2, write quorum 2, fsync on, chunking on the card). The cluster is then
restarted on the same data root with ``--readahead`` 0, 2, 2, 0 and node 3
(which did not coordinate the upload) serves the file whole each time;
every download is checked byte-identical. Times are the host clock from
the request to the last byte. The page cache holds the chunk files after
the upload, so every download reads them warm.

The first line of output names the card and its power limit; then one
JSON object per download and a summary.

    python scripts/bench_readahead.py     # from the repository root
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_readahead: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    body = np.random.default_rng(cs.SEED).integers(
        0, 256, size=cs.BODY_BYTES, dtype=np.uint8).tobytes()
    blocks = [body[i:i + cs.BLOCK_BYTES]
              for i in range(0, len(body), cs.BLOCK_BYTES)]
    times: dict[int, list[float]] = {0: [], 2: []}
    with tempfile.TemporaryDirectory(prefix=".bench_readahead_",
                                     dir=ROOT) as data:
        data = Path(data)
        fid = None
        for k, ra in enumerate((0, 2, 2, 0)):
            with cs.serve_cluster(ROOT, ".bench_readahead_",
                                  ("--readahead", str(ra)),
                                  data_root=data) as c:
                if fid is None:
                    t0 = time.perf_counter()
                    fid = cs._upload(c.port[1], iter(blocks), "ra.bin",
                                     chunked=True)["fileId"]
                    cs.emit({"upload_s": time.perf_counter() - t0})
                t0 = time.perf_counter()
                st, _, got = cs._http(c.port[3], "GET",
                                      f"/download?fileId={fid}")
                secs = time.perf_counter() - t0
                cs.check(st == 200 and got == body,
                         f"download {k} (readahead {ra}) not identical")
                del got
                times[ra].append(secs)
                cs.emit({"download": k, "readahead": ra, "seconds": secs,
                         "gib_s": len(body) / 2**30 / secs,
                         "identical": True})
    cs.emit({"summary": {f"readahead_{ra}_s": ts
                         for ra, ts in times.items()},
             "order": [0, 2, 2, 0], "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
