#!/usr/bin/env python3
"""Smoke test of dfs_tpu_torch on NVIDIA cards: builds the CUDA kernels,
holds each against its plain PyTorch version at the shapes the main paths
give it (kernels 1 and 5: states on live rows, dead rows 0, K5's states
equal to K1's; with the longest chunk, the chain floor and the time per
compression), times it (``ms``: 100 launches back to back behind a device
spin that covers their enqueue, per launch; ``ms_n20`` the same at 20;
``ms_single``: one event pair around one call, host gap included), then
drives the paths end to end and checks each against the NumPy oracle:

- ``e2e``: a LocalNode streaming a 128 MiB upload through the anchored
  CDC + SHA-256 chain at the default parameters (64 MiB windows, two in
  flight), checked against the oracle, hashlib and a download (kernels
  1-4);
- ``cluster``: the node as users run it — 5 ``python -m
  dfs_tpu_torch.cli.main serve`` processes on the card (rf 2, write quorum
  2, fsync on), the same 128 MiB streamed to node 1 over HTTP in 1 MiB
  chunked blocks; the chunk table against the oracle, every chunk read
  back from both of its owners' stores, downloads from a node that did not
  coordinate (whole and a Range), a re-upload to another node that moves
  0 B, two concurrent 32 MiB uploads to node 1 (both oracle-equal), and a
  download after one owner is SIGKILLed (kernels 1-4, counted by node 1's
  ``/metrics``: its launches move across the streamed upload); and
  erasure coding as users run it: a 32 MiB body uploaded whole with
  ``?ec=3`` to node 1 before the kill (chunked on the card, kernels 1-4,
  P+Q encoded on the card), its table, its parity digests and every
  shard's holder checked, and read back from node 1 after nodes 3 and 4
  are both SIGKILLed (by decode);
- ``cluster_obs_off``: the ``cluster`` phase's warm-up and streamed 128 MiB
  upload again, on 5 fresh processes with ``--trace-ring 0 --journal-bytes
  0 --sentinel-interval 0`` (tracing, journal and sentinel off), its upload
  time beside the default one's (kernels 1-4 in node 1);
- ``ec_codec``: the EC codec on the card at that file's stripes (k=3 and
  k=1, padded per stripe): the batched encode the node runs against the
  NumPy oracle stripe by stripe, timed; the batched decode in torch on
  the card against the NumPy decode in each erasure case; the sharded EC
  step on 4 slots of the first card;
- ``sim_sketch``: the similarity plane's min-hash sketcher on the card over
  every chunk of that 32 MiB file (default SimConfig: 16 lanes, 8-byte
  shingles, 64 KiB window) against the NumPy oracle, timed by one event
  pair per call beside its bound, and the sharded sketch step on 4 slots
  of the first card;
- ``cluster_sim``: 5 ``serve --sim`` processes (rf 2, write quorum 2,
  fsync on) on fresh ports and a fresh root: that 32 MiB file streamed to
  node 1, then generation 2 (one 4-byte overwrite every 64 KiB); both
  tables against the oracle, both read back from node 3 and generation 2
  from node 5 after SIGKILL of node 3; after the nodes stop, every chunk
  of both generations opened through the port's ChunkStore on both of its
  owners (deltas reconstructed) and hashed; deltas written > 0 and their
  bytes below 10% of the raw bytes they replace (kernels 1-4 in node 1);
- ``cluster_serve``: the serving tier as users run it: 5 ``serve``
  processes (rf 2, write quorum 2, fsync on) with ``--cache-bytes 512 MiB
  --readahead 2 --hedge-budget 50 --hedge-floor 0.04 --hedge-cap 0.3``,
  node 5 also ``--download-slots 2 --queue-depth 6``. The 128 MiB body
  streamed to node 1 (table against the oracle, kernels 1-4 in node 1);
  node 3 reads it cold (readahead) and hot (cache), both identical, timed
  beside the ``cluster`` phase's download; 32 concurrent ``Range: bytes=
  0-33554431`` reads on node 1, two rounds, every body identical, cache
  hits after the second; the shed curve on node 5 at 2, 8, 16 and 32
  readers, each level a 32 MiB window node 5 has not read (no 503 at 8 or
  fewer, at least one at 32, every 503 with Retry-After, every 206
  identical); ``X-Dfs-Deadline: 0`` answered 503 at node 5 (its gate's
  ``deadlineShed``) and node 1 (``deadline_drops``) with ``downloads``
  unchanged; node 1 reads the file whole with node 3 SIGSTOPped, identical,
  its hedge fired and won;
- ``cluster_index_tier``: the dedup/index plane and tiering as users run
  them: 5 ``serve --index --tier --tier-ec-k 3 --tier-min-idle 0
  --tier-half-life 86400 --tier-hot-fraction 0.5`` processes (rf 2, write
  quorum 2, fsync on; the index at its defaults). (a) The 32 MiB EC body
  A streamed to node 1 (table against the oracle, kernels 1-4 in node 1);
  (b) once every node holds its peers' filters at their own versions, A
  again to node 2: 0 B moved, probe RPCs skipped, filter-trusted copies
  verified before the ack (node 2's ``has_chunks`` calls printed); (c) a
  fresh 32 MiB body C to node 2 (table against the oracle; its
  ``probesSkipped`` grows by every peer placement); (d) C read twice from
  node 3, then ``POST /tier`` on node 1 demotes A alone (cold k=3
  manifest, P+Q encoded on ``cuda:0``, the stored bytes over the 5 data
  roots fall); (e) A read from node 5 after SIGKILL of nodes 3 and 4;
  (f) nodes 3 and 4 restarted with the same flags: each ``/scrub`` heals
  nothing (the index reopened consistent with the CAS walk); (g) A read
  from node 1 until it promotes, then read again (identical, stored bytes
  back up). Every time on its own line, then node 1's and node 2's
  ``index`` and ``tier`` sections;
- ``cluster_chaos``: the fault-injection and tracing planes as users run
  them: 5 ``serve --chaos --chaos-seed 13`` processes (rf 2, write quorum
  2, fsync on; tracing, journal and sentinel at their defaults), step (d)
  first (as ``bench_chaos.py`` runs its slow_peer scenario first: the
  doctor reads 60 s windows of RPC means, which the other steps' bulk
  transfers would fill). (a) The
  32 MiB EC body streamed to node 1 with ``X-Dfs-Trace`` (table against
  the oracle, kernels 1-4 in node 1), ``GET /trace`` on node 3 stitching
  spans of at least 2 nodes with ``http./upload``, ``upload.fragment``,
  ``rpc.store_chunks`` and ``peer.store_chunks``, every parent present but
  the client's; ``upload.fragment``'s seconds beside ``chain_stages``'
  whole-chain time for the same windows; (b) ``POST /chaos {"partition":
  "2"}`` on node 1, ten 1 MiB uploads ack by handoff, node 1's ``/events``
  holds trace-stamped ``chaos_inject`` events, node 1's ``/doctor`` sees
  node 2 cut (``dead_peer`` or a peer failed), healed and repaired, node 3
  reads them back identical; (c) ``{"disk_full": true}`` on node 2: an
  upload there answers 507 and journals ``disk_pressure``, node 2 still
  serves (a), an upload at node 1 acks; (d) ``serve_delay_s`` 0.5 on node
  3 and ``rpc_truncate_rate`` 0.05 on node 1: uploads ack, read back from
  node 5, node 1's ``/doctor`` names node 3 in a ``slow_peer`` finding
  (asked up to 3 times late in the fault) and its RPC table names node 3
  its slowest peer; (e) node 4 restarted armed at each of the four
  upload-path crash points: each upload dies by SIGKILL without an ack; a
  clean restart reads every acked file back identical, journals
  ``boot_sweep``, and no manifest on node 4 names a chunk held by fewer
  than 2 nodes. After (b), (c) and (e) the census at node 1 is clean
  (under- and over-replicated 0, every peer answering; no orphan after (b)
  and (c)), repair rounds on every node until it is; (f) in this process, one
  ``AnchoredCudaFragmenter.chunk`` of the 32 MiB EC body inside
  ``device_trace`` and an ``upload.fragment`` span: the exported trace
  holds kernels 1-4's launches inside that range (path ``device_trace``);
- ``cluster_ring``: the elastic ring as users run it (dfs_tpu's
  ``bench_chaos.py`` add_remove_node scenario with ``bench_rebalance.py``'s
  gates): 4 ``serve`` processes (rf 2, write quorum 2, fsync on,
  ``--ring-vnodes 64 --ring-members 1,2,3
  --ring-rebalance-credit-bytes 2097152``, repair every 2 s), node 4 a
  standby. (a) A 32 MiB body (seed 20261018) to node 1 (table against the
  oracle, kernels 1-4 in node 1); (b) open-loop load of 48,000 B uploads at
  4/s on nodes 1-3 (4 s of warm-up first), ``POST /ring {"action": "add",
  "nodeId": 4}`` without a weight (the derived weight in [0.25, 4]), node 4
  SIGKILLed 0.25 s after the answer, the body read from node 2 with the window open (identical), one
  traced upload through the fault; (c) node 4 restarted: it resumes epoch
  1 from ``ring.json``, every node reaches it with one fingerprint and
  closes its window within 90 s; (d) ``drain`` node 4 under the load:
  moved bytes <= 1.5 x the theoretical minimum + 2 x the bytes uploaded
  meanwhile, and each node's rate <= the credit x 1.35 (or under one
  credit-second moved); (e) the census clean (orphans reported), node 4
  empty, every acked file and the body identical from nodes 1-3, the
  traced upload stitched at node 1, no ``epoch_mismatch`` or
  ``rebalance_stuck`` from the doctor; every node's ``ring.rebalance``
  printed; the phase within 180 s;
- ``cluster_client``: resumable uploads and the smart client as users run
  them (dfs_tpu's ``bench_client.py`` full mode): 3 ``serve --chaos
  --index --index-filter-sync 0.5 --index-background-compact
  --index-echo-cache 4096`` processes (rf 2, write quorum 2, fsync on) and
  the port's ``SmartClient`` in this process, chunking on ``cuda:0``.
  (a) 8 x 4 MiB (``random.Random(19)``) up through node 1 (the first two
  tables against the oracle), the filters synced, one contiguous 1% region
  xor-mutated, everything again through a fresh client at node 2: the
  payload sent <= 3% of the replicated corpus, the mutated file identical
  through node 3's legacy read; (b) 6 x 2 MiB (seed 47; cut from 4 MiB to
  keep the run inside its limit) read through node 1's relay and then
  striped, with ``rpc_delay_s`` 0.1 on every node: a
  speedup of at least 2; (c) client hedging 20/s, 0.05-0.5 s, one peer's
  filter replica set to all ones at the client, ``serve_delay_s`` 0.25 on
  node 3, 8 MiB (seed 83) up and down: identical from every node's legacy
  read, every chunk verified at the client, false positives seen; (d) the
  legacy client, a client pinned to the legacy path (same fileId) and the
  smart path reading the legacy upload; kernels 1-4 counted in this
  process from (a) to the end of (d); (e) ``upload --resume`` of (c)'s
  body with 8 MiB (seed 84) appended through the CLI at node 2 (sent <=
  60%, fileId = sha256, identical), ``upload --smart`` and ``download
  --smart`` of 4 MiB through the CLI, and a ``POST /commit`` naming a
  digest nobody holds: 409, no manifest. Within 120 s;
- ``cluster_sidecar``: the chunk+hash sidecar as users run it (dfs_tpu's
  ``dfs.Sidecar`` gRPC contract, served by the port's own HTTP/2 stack).
  (a) A ``SidecarServer(fragmenter="auto")`` in this process on
  ``cuda:0``: Health, ChunkHash, ChunkHashStream and ChunkHashDuplex
  through the port's ``SidecarClient`` on the 32 MiB EC body, the 128 MiB
  body streamed through ChunkHashStream by the port's C++ client
  (``native/sidecar_client.cpp``, POSIX sockets only; its host seconds and
  GiB/s beside ``e2e``'s in-process fragment GiB/s), Health, ChunkHash and
  ChunkHashDuplex through the C++ client on the EC body: every table equal
  to the oracle, fileId from the digests; a duplex of the EC body repeated
  without end, cancelled after its first batch, then one more call
  served. (b) One ``serve --nodes 1
  --replication-factor 1 --sidecar-port`` process delegating to (a)'s
  server: the EC body uploaded chunked and with Content-Length (manifest
  equal to the oracle, fileId = sha256, download identical), ``/chunking``
  equal to Health's ``describe``, and the node's own K1-K4 launches 0.
  (c) The ``sidecar`` subcommand as a process, started with (b) at the
  phase's start: its Health names ``cdc-anchored-cuda`` with the walk's
  window, a 2 MiB ChunkHash equals the oracle, and SIGTERM ends it with
  exit 0 within 10 s. K1-K4 launched in this process over (a) and (b)
  (path ``cluster_sidecar``). Within 90 s;
- ``aligned``: aligned CDC v2 (``cdc-aligned-cuda``): the 128 MiB body
  through ``AlignedCudaFragmenter.chunk`` and ``manifest_stream`` (1 MiB
  blocks), tables == ``chunk_file_np`` and the fileId from the digest
  chain; a 3 MiB segment with ``cpu_cutoff=0`` (32 strips padded to 128
  lanes on the card); an 8 MiB upload to an in-process
  ``StorageNodeServer`` (rf 1, fsync on) built from
  ``NodeConfig(fragmenter="cdc-aligned-cuda")``: table == oracle, fileId
  = sha256, download identical, ``/dataplane`` chunking null (kernels 3
  and 1, at least 2 launches each over the body);
- ``v1``: the body through ``CudaCdcFragmenter`` (``cdc-cuda``, dfs_tpu's
  ``cdc-tpu``) ``chunk`` and ``manifest_stream``, tables == the host
  ``cdc`` engine's (kernel 7: one launch for ``chunk``, none of kernel 6;
  one a flush for the stream);
- ``rolling_sharded``: the body through the rolling walk
  (``ShardedCdcFragmenter``, ``cdc --cdc-devices N``) on 2 and 4 slots of
  the first card, and one slot per card with two or more cards, tables ==
  the host ``cdc`` engine's (no hand-written kernel: the bitmap is plain
  torch, as dfs_tpu's was XLA);
- ``sharded_step``: ``make_sharded_step`` on a 2 x 2 mesh of 4 slots of the
  first card: two 8 MiB streams' bitmaps, the count and 64 messages'
  states (kernel 6) == the NumPy bitmap and hashlib;
- ``anchored_host``: the body through the host ``cdc-anchored`` engine
  (``native/cdc_core.cpp``), whole and streamed, == the oracle;
- ``large_chunks``: restic's chunker sizes (512 KiB / 1 MiB / 8 MiB: 8
  MiB lanes of 131,072 blocks, the wide layout of kernels 1 and 5) on a
  seeded 64 MiB body: the ``auto`` anchored walk (kernels 1-4),
  ``cdc-aligned-cuda`` (kernels 3 and 1) and the sharded aligned step on
  4 slots of the first card (kernels 3 and 5), each table ==
  ``chunk_file_anchored_np`` or ``chunk_file_np``, kernels 1 and 5 timed
  on the walk's region beside their chain floor; one anchored region at
  32 MiB lanes (2^19 blocks) == the oracle; kernels 1 and 5 with the wide
  layout forced at small geometries == the narrow layout and the plain
  versions; kernel 7 on one span of 2^31 - 1 bytes == hashlib, timed; and
  ``digest_many`` on a 2.3 GiB flush (two kernel 7 calls) == hashlib;
- ``kernel:sha256_blocks``: kernel 6 at 16 rows x 64 blocks against its
  plain version (exact; also rows of 0, -1, 17 and 99 blocks), timed
  alone, with the 128 x 256 shape beside it;
- ``kernel:sha256_spans``: kernel 7 against its plain version on 64 spans
  of up to 64 blocks at every start offset mod 16 (exact), and against
  hashlib on every span of the host ``cdc`` table of the 128 MiB body in
  one launch; that launch timed beside the bucketed kernel 6 calls the v1
  path made before it, on the same spans packed ahead of time (kernel 7
  must take at most a tenth of their time);
- ``multihost``: two processes (``chip_smoke.py --multihost-worker``), 2
  slots each on ``cuda:0``, one gloo group: the rolling step, the carry
  step and the anchored pass B over the global mesh at dp 1 and 2, each
  process's slots == the oracles (kernels 6, 2, 3 and 5 in the workers);
- ``sharded_parity``: both sharded anchored passes and the aligned step on
  a toy geometry, on a mesh of 4 slots on the first card (kernels 2, 3, 5);
- ``sharded_production``: both sharded anchored passes on a 64 MiB region
  at the default parameters over one slot per card (kernels 2, 3, 5);
- ``sharded_walk``: the window-batched walk over the same 128 MiB body on
  one slot per card and on 4 slots of the first card (kernels 1-4).

Each path runs with the launch counters set to 0 just before it and read
just after; a kernel of the path that never launched fails the run.
Kernels 1 and 5 are held against their plain versions (which walk the
region's 2048 blocks in Python, ~40 s each) by a child process,
``chip_smoke.py --strip-refs OUT``, and read before the kernels table.
That child, ``cluster_sim`` and ``cluster_index_tier`` run side by side
(nothing compares those phases' seconds; their device work runs in the
nodes' processes); every other phase runs alone.

    python3 chip_smoke.py            # from the repository root; one card

Each phase prints one JSON line (``timing`` gives each phase's seconds).
Before the last line come the card's
``nvidia-smi`` name and power limit and the ``{"kernels": [...]}`` table
(``launches`` counted on the path named by ``launches_path``, and on
every path in ``launches_by_path``); the last
line is ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero. Without CUDA it exits 2 and prints no result. It imports nothing
of JAX or of the dfs_tpu package.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import contextlib
import hashlib
import http.client
import json
import os
import random
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

SEED = 20261016
# the body of e2e, cluster, cluster_obs_off, cluster_serve and the sharded
# walk: 128 MiB (three 64 MiB windows at the 48 MiB stride), cut from 256
# MiB so the run stays well inside its time limit
BODY_BYTES = 128 * 1024 * 1024
# the EC body of ec_codec, sim_sketch, cluster's EC upload, cluster_sim,
# cluster_index_tier, cluster_chaos, cluster_sidecar and device_trace: 32
# MiB, cut from 64 MiB to make room for the large_chunks phase in the
# time limit
EC_BYTES = 32 * 1024 * 1024
EC_K = 3
BLOCK_BYTES = 1024 * 1024
REGION_BYTES = 64 * 1024 * 1024
CLUSTER_NODES = 5
# cluster's two concurrent uploads: 32 MiB each (one window apiece, as 64
# MiB was), cut from 64 MiB so the run keeps a margin under its limit
CONCURRENT_BYTES = 32 * 1024 * 1024
# cluster_sim's generation 2: one 4-byte overwrite every 64 KiB
SIM_EDIT_AT = 12_345
SIM_EDIT_STRIDE = 64 * 1024
# cluster_serve: dfs_tpu's serve bench workload (32 readers of a 32 MiB
# range) and its shed settings (2 download slots, a queue of 6)
SERVE_CACHE_BYTES = 512 * 1024 * 1024
SERVE_READERS = 32
SERVE_RANGE_BYTES = 32 * 1024 * 1024
SERVE_SLOTS, SERVE_QUEUE = 2, 6
SERVE_CURVE = (2, 8, 16, 32)
# cluster_index_tier: dfs_tpu's reference deployment with both planes on —
# the index at its defaults; tiering at k = 3 (5 nodes fit k + 2) with
# bench_tiering.py's idle floor and half-life, and a hot fraction that
# keeps one of two EC-body-sized files replicated
TIER_FLAGS = ("--index", "--tier", "--tier-ec-k", "3", "--tier-min-idle",
              "0", "--tier-half-life", "86400", "--tier-hot-fraction",
              "0.5")
# cluster_chaos: dfs_tpu's bench_chaos.py cluster (every node serve --chaos
# at one seed, the defaults otherwise: tracing, journal and sentinel on),
# 1 MiB bodies for the fault steps, the slow peer's 0.5 s and the torn
# frames' 5%; the phase's time bound
CHAOS_FLAGS = ("--chaos", "--chaos-seed", "13")
CHAOS_SMALL_BYTES = 1024 * 1024
CHAOS_PARTITION_UPLOADS = 10
CHAOS_SLOW_UPLOADS = 5
CHAOS_PHASE_BOUND_S = 240.0
# cluster_ring: bench_chaos.py's add_remove_node scenario on its own
# 4-process cluster (ring members 1-3 at 64 vnodes, node 4 a standby) with
# bench_rebalance.py's full-mode credit and gates, its seed body and
# bench_chaos.py --tiny's open-loop load (48,000 B at 4/s on nodes 1-3)
RING_NODES = 4
RING_SEED = 20261018
RING_BYTES = 32 * 1024 * 1024   # cut from 64 MiB to keep the run in its limit
RING_CREDIT = 2 * 1024 * 1024
RING_FLAGS = ("--ring-vnodes", "64", "--ring-members", "1,2,3",
              "--ring-rebalance-credit-bytes", str(RING_CREDIT),
              "--repair-interval", "2")
RING_PAYLOAD, RING_RATE, RING_WARM_S = 48_000, 4.0, 4.0
RING_KILL_DELAY_S = 0.25
RING_CONVERGE_S = 90.0
RING_PHASE_BOUND_S = 180.0
# cluster_client: dfs_tpu's bench_client.py full mode — 3 serve processes
# (scripts/chaos_harness.py boots every node with --chaos) with its index
# flags, its corpora (random.Random(seed).randbytes) and gates; the smart
# client runs in this process and chunks on cuda:0
CLIENT_NODES = 3
CLIENT_FLAGS = ("--chaos", "--index", "--index-filter-sync", "0.5",
                "--index-background-compact", "--index-echo-cache", "4096")
CLIENT_FILE_BYTES = 4 * 1024 * 1024
# (b)'s files: 2 MiB, cut from bench_client.py's 4 MiB so the whole run
# keeps a margin under its time limit
CLIENT_STRIPED_BYTES = 2 * 1024 * 1024
CLIENT_PHASE_BOUND_S = 120.0
# cluster_sidecar: the phase's time bound and the CLI sidecar's ChunkHash
SIDECAR_PHASE_BOUND_S = 90.0
# the aligned phase's node upload (8 MiB: one segment of 64 strips, padded
# to 128 lanes on the card)
ALIGNED_NODE_BYTES = 8 * 1024 * 1024
SIDECAR_CLI_BYTES = 2 * 1024 * 1024
# large_chunks: restic's chunker sizes (github.com/restic/chunker:
# MinSize 512 KiB, MaxSize 8 MiB, a 1 MiB average) on a 64 MiB body; the
# largest lane dfs_tpu's default 64 MiB region allows (32 MiB, 2^19
# blocks) at 4 / 8 / 32 MiB chunks; kernel 7 on one span of 2^31 - 1
# bytes; digest_many on a flush of 300 payloads of about 8 MiB (2.3 GiB)
LARGE_BYTES = 64 * 1024 * 1024
RESTIC_SIZES = (512 * 1024, 1024 * 1024, 8 * 1024 * 1024)
LANE32_SIZES = (4 * 1024 * 1024, 8 * 1024 * 1024, 32 * 1024 * 1024)
K7_LONG_SPAN = 2**31 - 1
DIGEST_FLUSH_PAYLOADS = 300
# the tracing-off twin of the cluster phase's upload
OBS_OFF_FLAGS = ("--trace-ring", "0", "--journal-bytes", "0",
                 "--sentinel-interval", "0")

# H100 SXM peaks at the full 700 W power limit: HBM bandwidth (NVIDIA data
# sheet), and the INT32 rate every kernel here is held to — 132 SMs x 64
# INT32 lanes per SM (the CUDA C++ Programming Guide's throughput table for
# compute capability 9.0: 32-bit add, logic and shift) x the 1.98 GHz boost
# clock (NVIDIA H100 Tensor Core GPU Architecture white paper)
PEAK_BYTES_S = 3.35e12
BOOST_HZ = 1.98e9
PEAK_INT_OPS_S = 132 * 64 * BOOST_HZ
# 32-bit integer instructions per live block-lane as compiled (LOP3 takes
# any 3-input logic, IADD3 a 3-input add, SHF a rotate). Kernel 5: the
# producer warp's schedule (48 words x: two sigmas of SHF, SHF, SHR, LOP3,
# then 2 IADD3 = 10) and its adding of K (64), the consumer warp's rounds
# (64 x: two Sigmas of 3 SHF + LOP3, Ch and Maj one LOP3 each, 4 adds =
# 14) and feed-forward (8). Kernel 1 adds the Gear window (32 bytes x
# extract, table load, shift, add) and the candidate test (2)
K5_OPS_PER_BLOCK = 48 * 10 + 64 + 64 * 14 + 8
K1_OPS_PER_BLOCK = 32 * 4 + 2 + K5_OPS_PER_BLOCK
# The chain floor: SHA-256 is sequential within a chunk, so a launch takes
# at least its longest chunk's compressions one after another. Two limits
# per compression of one chain (one thread; its warp alone on its
# scheduler): the dependency path, 64 rounds of at least 4 dependent
# instructions (SHF, LOP3, IADD3, IADD3) of about 4 cycles; and the issue
# rate, 64 rounds of 12 INT32 instructions as compiled (6 SHF, 4 LOP3,
# 2 IADD3; the other adds go to the FMA pipe) on a scheduler's 16 INT32
# lanes, 2 cycles per warp instruction. The larger, 1536 cycles, is used.
CHAIN_CYCLES_PER_COMPRESSION = max(64 * 4 * 4, 64 * 12 * 2)
# Kernel 4's chain floor: its steps one after another, each one
# shared-memory load (about 30 cycles on Hopper, as microbenchmarks of the
# architecture read it) and the 9 dependent integer instructions of a step
# of the walk in csrc/select_walk.cu as compiled (two compare-selects and a
# max for pred; the range test, a select and an add for the next x, its
# clamp; shift and mask for the ring offset) at about 4 cycles each. Its
# operations: per tile, in the records kernel, two tests and selects, a
# max and the running max (5); per step about 12
SELECT_CYCLES_PER_STEP = 30 + 9 * 4
K4_OPS_PER_TILE, K4_OPS_PER_STEP = 5, 12

REPLACES = {
    "strip_chunk_states": "dfs_tpu/ops/sha256_strip.py:264",
    "repack_lanes": "dfs_tpu/ops/repack.py:144",
    "bswap_transpose": "dfs_tpu/ops/layout.py:39",
    "select_walk": "dfs_tpu/ops/select_pallas.py:62",
    "strip_states": "dfs_tpu/ops/sha256_strip.py:140",
    # XLA in dfs_tpu, not Pallas: the batched scan of _sha256_blocks_impl,
    # and the gather, padding and packing of digest_gathered before it
    "sha256_blocks": "dfs_tpu/ops/sha256_jax.py:130",
    "sha256_spans": "dfs_tpu/ops/pack_jax.py:28",
}
# the path whose run counts each kernel's launches in the kernels table
LAUNCHES_PATH = {"strip_chunk_states": "e2e", "repack_lanes": "e2e",
                 "bswap_transpose": "e2e", "select_walk": "e2e",
                 "strip_states": "sharded_production",
                 "sha256_blocks": "sharded_step", "sha256_spans": "v1"}
# the v1 path's kernel 6 calls before kernel 7 (``kernel:sha256_spans``'s
# "before" side): chunks grouped by power-of-two block count, at most
# V1_HASH_BATCH rows a call at the 64-block bucket
V1_HASH_BATCH = 512


def emit(obj) -> None:
    # one write a line: two phases may emit from their own threads
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def single_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` runs of one event pair around one call of
    ``fn``: the call's host work (checks, allocation, the ctypes call) lies
    between the events, so for a short kernel this reads the host gap too.
    Kept for the plain versions, the chain stages and ``ms_single``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms(fn, n: int, reps: int = 3) -> float:
    """Device time per launch of ``fn``: ``n`` calls back to back between
    one event pair, divided by ``n`` (median of ``reps``). A device spin
    enqueued first covers the host's enqueue of all ``n`` calls, so the
    queue already holds them when the start event runs and the host's
    per-call work never idles the card; a run in which the spin ended
    before the host had enqueued the last call is repeated with a spin
    twice as long."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    spin_ms = 2 * (time.perf_counter() - t0) * 1e3 + 1.0
    torch.cuda.synchronize()
    times = []
    for _ in range(reps + 8):
        if len(times) == reps:
            break
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # cycles at 2 GHz: no H100 clock is higher, so the spin lasts at
        # least spin_ms
        torch.cuda._sleep(int(spin_ms * 2e6))
        start.record()
        for _ in range(n):
            fn()
        covered = not start.query()
        end.record()
        end.synchronize()
        if covered:
            times.append(start.elapsed_time(end) / n)
        else:
            spin_ms *= 2
    check(len(times) == reps, "cuda_ms: the device spin never covered the "
          f"host's enqueue of {n} calls")
    return statistics.median(times)


def kernel_times(fn, single_reps: int = 20) -> dict:
    """``ms`` per launch back to back at N = 100, the same at N = 20, and
    the single-launch reading ``ms_single``."""
    t = {"ms_n20": cuda_ms(fn, 20), "ms_n100": cuda_ms(fn, 100),
         "ms_single": single_ms(fn, reps=single_reps)}
    t["ms"] = t["ms_n100"]
    t["n20_n100_within_5pct"] = abs(t["ms_n20"] - t["ms_n100"]) \
        <= 0.05 * t["ms_n100"]
    return t


def max_abs_err(a, b) -> int:
    """Largest elementwise |a - b| over u32/i32 tensors (as integers)."""
    import torch

    from dfs_tpu_torch.utils import u32

    def wide(t):
        return u32.widen(t) if t.dtype == torch.uint32 else t.to(torch.int64)

    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((wide(a) - wide(b)).abs().max()) if a.numel() else 0


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def path_launches(kernels, path: str, needed) -> dict:
    """The launch counts of the path just driven; fails if a kernel of the
    path never launched."""
    counts = kernels.launch_counts()
    for name in needed:
        check(counts[name] > 0, f"kernel {name} never launched on {path}")
    return counts


_ports_lock = threading.Lock()
_ports_given: set[int] = set()


def _free_ports(n: int) -> list[int]:
    """``n`` ports free now and not handed out before in this run (two
    clusters may start side by side)."""
    with _ports_lock:
        socks, ports = [], []
        while len(ports) < n:
            socks.append(socket.socket())
            socks[-1].bind(("127.0.0.1", 0))
            port = socks[-1].getsockname()[1]
            if port not in _ports_given:
                ports.append(port)
                _ports_given.add(port)
        for s in socks:
            s.close()
        return ports


def _http(port: int, method: str, path: str, body=None,
          headers: dict | None = None, chunked: bool = False,
          timeout: float = 900.0) -> tuple[int, dict, bytes]:
    """One HTTP request to a node on localhost: (status, headers, body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {},
                     encode_chunked=chunked)
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _upload(port: int, body, name: str, chunked: bool = False,
            ec: int = 0, headers: dict | None = None) -> dict:
    st, _, out = _http(port, "POST", f"/upload?name={name}"
                       + (f"&ec={ec}" if ec else ""), body=body,
                       headers=headers, chunked=chunked)
    check(st == 201, f"upload {name} to :{port} answered {st}: {out[:300]}")
    return json.loads(out)


def _metrics(port: int) -> dict:
    st, _, out = _http(port, "GET", "/metrics", timeout=60)
    check(st == 200, f"/metrics on :{port} answered {st}")
    return json.loads(out)


def ec_stripes(body: bytes, table: list, k: int, np):
    """The stripes of a file at width ``k`` as the node forms them: the
    chunks of ``table`` grouped by ``ec_stripe_groups``, each shard a view
    of ``body``, and each stripe's padded length. Returns (groups, the
    encode's input, the shards zero-padded into [k, shard_len] arrays)."""
    from dfs_tpu_torch.meta.manifest import (ChunkRef, ec_stripe_groups,
                                             stripe_shard_len)

    view = memoryview(body)
    chunks = tuple(ChunkRef(i, o, ln, d) for i, (o, ln, d)
                   in enumerate(table))
    groups = ec_stripe_groups(chunks, k)
    stripes, padded = [], []
    for grp in groups:
        pad = stripe_shard_len(grp)
        shards = [view[c.offset:c.offset + c.length] for c in grp]
        arr = np.zeros((len(grp), pad), dtype=np.uint8)
        for j, b in enumerate(shards):
            arr[j, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        stripes.append((shards, pad))
        padded.append(arr)
    return groups, stripes, padded


def ec_codec_phase(body: bytes, table: list, dev, np) -> list:
    """The ``ec_codec`` phase (module docstring). Returns the NumPy
    oracle's (p, q) of every k=3 stripe, which the cluster phase holds the
    uploaded manifest's parity digests to."""
    import torch

    from dfs_tpu_torch.ops import ec as E
    from dfs_tpu_torch.parallel.mesh import make_mesh
    from dfs_tpu_torch.parallel.sharded_cdc import (make_ec_step,
                                                    shard_ec_inputs)

    def same(a, b) -> bool:
        return a.dtype == b.dtype and a.shape == b.shape \
            and bool(np.array_equal(a, b))

    out: dict = {"phase": "ec_codec", "bytes": len(body), "k": EC_K,
                 "chunks": len(table)}
    parity3 = None
    for k in (EC_K, 1):
        groups, stripes, padded = ec_stripes(body, table, k, np)
        t0 = time.perf_counter()
        want = [E.encode_pq_np(a) for a in padded]
        oracle_s = time.perf_counter() - t0
        if k == EC_K:
            parity3 = want
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = E.encode_stripes(stripes, device=dev)
        call_s = time.perf_counter() - t0
        check(len(got) == len(want) and all(
            same(g[0], w[0]) and same(g[1], w[1])
            for g, w in zip(got, want)),
            f"encode_stripes on {dev} != encode_pq_np at k={k}")
        plan = E.StripePlan(stripes)
        packed = torch.from_numpy(plan.pack(stripes)).to(dev)
        # one event pair per call: the encode is hundreds of small
        # launches, more than the launch queue holds behind a device spin
        ms = single_ms(lambda: plan.encode(packed), reps=10)
        data_bytes = sum(c.length for grp in groups for c in grp)
        parity_bytes = 2 * sum(st[1] for st in stripes)
        moved = data_bytes + parity_bytes
        bound_ms = moved / PEAK_BYTES_S * 1e3
        # the decode: each erasure case over every stripe it applies to,
        # in torch on the card against the NumPy decode and the shards
        cases = {0: lambda a: ([None] + list(a[1:]), True, False),
                 1: lambda a: ([None] + list(a[1:]), False, True),
                 2: lambda a: ([None] + list(a[1:-1]) + [None], True, True)}
        decode = {}
        for case, lose in cases.items():
            batch, orig = [], []
            for a, (p, q) in zip(padded, want):
                if case == 2 and len(a) < 2:
                    continue
                data, hp, hq = lose(a)
                batch.append((data, p if hp else None, q if hq else None))
                orig.append(a)
            t0 = time.perf_counter()
            rec_np = E.recover_stripes_np(batch)
            np_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            rec_dev = E.recover_stripes(batch, device=dev)
            dev_s = time.perf_counter() - t0
            check(all(len(r) == len(a) and all(same(x, y) and same(x, z)
                                               for x, y, z in zip(r, rn, a))
                      for r, rn, a in zip(rec_dev, rec_np, orig)),
                  f"recover_stripes on {dev} != NumPy decode (k={k}, "
                  f"case {case})")
            decode[case] = {"stripes": len(batch), "numpy_s": np_s,
                            "device_s": dev_s}
        out[f"k{k}"] = {
            "stripes": len(stripes), "groups": len(plan.groups),
            "data_bytes": data_bytes, "parity_bytes": parity_bytes,
            "packed_bytes": plan.in_bytes + plan.out_bytes,
            "encode_ms": ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "encode_call_s": call_s, "oracle_numpy_s": oracle_s,
            "encode_exact": True, "decode": decode, "decode_exact": True}
    check(E.encode_stripes([], device=dev) == []
          and E.recover_stripes([], device=dev) == [],
          "the zero-length file has stripes")

    # the sharded step on 4 slots of the card: the most common (width,
    # bucket) group of the k=3 stripes, cut to a multiple of 4
    _, stripes, padded = ec_stripes(body, table, EC_K, np)
    plan = E.StripePlan(stripes)
    kk, bucket, idxs, _, _ = max(plan.groups, key=lambda g: len(g[2]))
    idxs = idxs[:len(idxs) // 4 * 4]
    arr = np.zeros((len(idxs), kk, bucket), dtype=np.uint8)
    for r, s_ in enumerate(idxs):
        arr[r, :, :padded[s_].shape[1]] = padded[s_]
    mesh = make_mesh(4, device=[dev] * 4)
    p, q, nb = make_ec_step(mesh, kk)(shard_ec_inputs(
        mesh, arr.view(np.uint32)))
    torch.cuda.synchronize()
    p = p.view(torch.int32).cpu().numpy().view(np.uint8)
    q = q.view(torch.int32).cpu().numpy().view(np.uint8)
    for r in range(len(idxs)):
        wp, wq = E.encode_pq_np(arr[r])
        check(same(p[r], wp) and same(q[r], wq),
              f"make_ec_step stripe {r} != encode_pq_np")
    check(int(nb) == 2 * arr.shape[0] * bucket, "make_ec_step parity bytes")
    out["sharded_step"] = {"slots": 4, "stripes": len(idxs), "k": kk,
                           "bucket": bucket, "exact": True}
    emit(out)
    return parity3


@contextlib.contextmanager
def serve_cluster(root: Path, prefix: str, extra: tuple = (),
                  per_node: dict | None = None,
                  data_root: Path | None = None,
                  nodes: int = CLUSTER_NODES):
    """``nodes`` (default ``CLUSTER_NODES``) ``python -m
    dfs_tpu_torch.cli.main serve``
    processes on fresh ports and a fresh data root under ``root`` (or
    ``data_root``, to restart on the same disk; rf 2, write quorum 2,
    fsync on, no repair loop, plus ``extra`` flags and a node's
    ``per_node[i]`` flags), each answering ``/status``. Yields their
    directory, HTTP ports, processes, start-up seconds and
    ``restart(*ids)`` (starts those nodes again together, with the same
    flags, on the same disk, and returns the seconds until every one
    answers ``/status``); on failure the nodes' log tails go to
    stderr; every process is killed on the way out."""
    ids = list(range(1, nodes + 1))
    ports = _free_ports(2 * nodes)
    http_port = {i: ports[2 * (i - 1)] for i in ids}
    procs: dict[int, subprocess.Popen] = {}
    logs = []
    with tempfile.TemporaryDirectory(prefix=prefix, dir=root) as d:
        d = Path(d)
        (d / "cluster.json").write_text(json.dumps({
            "replication_factor": 2,
            "peers": [{"node_id": i, "host": "127.0.0.1",
                       "port": http_port[i],
                       "internal_port": ports[2 * (i - 1) + 1]}
                      for i in ids]}))
        env = dict(os.environ, PYTHONPATH=str(root))

        def spawn(i: int) -> None:
            logs.append(open(d / f"node{i}.log", "ab"))
            procs[i] = subprocess.Popen(
                [sys.executable, "-m", "dfs_tpu_torch.cli.main", "serve",
                 "--node-id", str(i), "--cluster-config",
                 str(d / "cluster.json"),
                 "--data-root", str(data_root or d / "data"),
                 "--write-quorum", "2", "--durability", "fsync",
                 "--repair-interval", "0", *extra,
                 *(per_node or {}).get(i, ())],
                cwd=root, env=env, stdout=logs[-1],
                stderr=subprocess.STDOUT)

        def wait_up(i: int, t0: float) -> None:
            while True:
                check(procs[i].poll() is None,
                      f"node {i} exited {procs[i].returncode}")
                try:
                    if _http(http_port[i], "GET", "/status",
                             timeout=5)[0] == 200:
                        return
                except OSError:
                    pass
                check(time.perf_counter() - t0 < 300,
                      f"node {i} did not answer /status")
                time.sleep(0.5)

        def restart(*which: int) -> float:
            for i in which:
                if procs[i].poll() is None:
                    procs[i].kill()
                procs[i].wait(timeout=60)
            t0 = time.perf_counter()
            for i in which:
                spawn(i)
            for i in which:
                wait_up(i, t0)
            return time.perf_counter() - t0

        try:
            t0 = time.perf_counter()
            for i in ids:
                spawn(i)
            for i in ids:
                wait_up(i, t0)
            yield types.SimpleNamespace(dir=d, port=http_port, procs=procs,
                                        start_s=time.perf_counter() - t0,
                                        restart=restart)
        except BaseException:
            for i in ids:
                log = d / f"node{i}.log"
                if log.is_file():
                    tail = log.read_bytes()[-3000:].decode("utf-8", "replace")
                    print(f"--- node {i} log tail ---\n{tail}",
                          file=sys.stderr)
            raise
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                p.wait(timeout=60)
            for f in logs:
                f.close()


def sim_sketch_phase(body: bytes, table: list, dev, np) -> None:
    """The ``sim_sketch`` phase (module docstring)."""
    import torch

    from dfs_tpu_torch.config import SimConfig
    from dfs_tpu_torch.parallel.mesh import make_mesh
    from dfs_tpu_torch.parallel.sharded_cdc import sketch_rows_fn
    from dfs_tpu_torch.sim.sketch import (SimSketcher, SketchPlan,
                                          lane_tensor, sketch_np, sketch_rows)

    cfg = SimConfig(enabled=True)
    q, lanes = cfg.shingle_bytes, cfg.sketch_size
    skt = SimSketcher(cfg, device=dev)
    view = memoryview(body)
    chunks = [view[o:o + ln] for o, ln, _ in table]
    check(all(len(c) <= skt.window for c in chunks),
          "a chunk of the default chain is longer than the sketch window")
    t0 = time.perf_counter()
    want = np.stack([sketch_np(np.frombuffer(c, np.uint8), lanes, q,
                               skt.lanes_a, skt.lanes_b) for c in chunks])
    oracle_s = time.perf_counter() - t0
    skt.sketch_many(chunks[:64])                     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = skt.sketch_many(chunks)
    call_s = time.perf_counter() - t0
    check(np.array_equal(got, want), "SimSketcher on the card != sketch_np")
    # the device part alone: one event pair per call, as ec_codec (the
    # sketch is thousands of small launches)
    plan = SketchPlan([len(c) for c in chunks], q)
    packed = torch.from_numpy(plan.pack(chunks)).to(dev)
    a, b = lane_tensor(skt.lanes_a, dev), lane_tensor(skt.lanes_b, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mib = torch.cuda.memory_allocated(dev) / 2**20
    ms = single_ms(lambda: plan.sketch(
        packed, lambda blk, ln: sketch_rows(blk, ln, a, b, q)),
        reps=5, warmup=1)
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20 - base_mib
    # the sharded step on 4 slots of the card, the same rows
    four = sketch_rows_fn(make_mesh(4, device=[dev] * 4), skt.lanes_a,
                          skt.lanes_b, q)
    got4 = plan.sketch(packed, four).view(torch.int32).cpu().numpy()
    check(np.array_equal(got4.view(np.uint32), want[plan.order]),
          "make_sketch_step on 4 slots of the card != sketch_np")
    ms4 = single_ms(lambda: plan.sketch(packed, four), reps=3, warmup=1)
    in_bytes = plan.data_bytes + 4 * len(chunks)
    out_bytes = len(chunks) * lanes * 4
    ops = plan.live_positions * (2 * q + 4 * lanes)
    bound_bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES_S * 1e3
    bound_ops_ms = ops / PEAK_INT_OPS_S * 1e3
    emit({"phase": "sim_sketch", "bytes": len(body), "chunks": len(chunks),
          "lanes": lanes, "shingle_bytes": q, "window": skt.window,
          "groups": len(plan.groups), "packed_bytes": plan.nbytes,
          "positions_computed": plan.positions,
          "positions_unpadded": plan.live_positions,
          "padding_frac": plan.positions / max(1, plan.live_positions) - 1,
          "ms": ms, "ms_4_slots": ms4,
          "bound_ms": max(bound_bytes_ms, bound_ops_ms),
          "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms
          else "operations", "bound_bytes_ms": bound_bytes_ms,
          "bound_ops_ms": bound_ops_ms, "ops": ops,
          "peak_mib": peak_mib, "sketch_many_s": call_s,
          "oracle_numpy_s": oracle_s, "exact": True,
          "exact_4_slots": True})


def _disk_bytes(path: Path) -> int:
    """Bytes of every file under ``path`` (a node's chunks/, deltas/
    included)."""
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def cluster_sim_phase(root: Path, body: bytes, table: list, params,
                      np) -> dict:
    """The ``cluster_sim`` phase (module docstring). Returns node 1's
    kernel launches across both uploads."""
    from dfs_tpu_torch.ops.cdc_anchored import chunk_file_anchored_np
    from dfs_tpu_torch.ring import static_replica_set
    from dfs_tpu_torch.store.cas import ChunkStore

    gen2 = bytearray(body)
    for off in range(SIM_EDIT_AT, len(gen2), SIM_EDIT_STRIDE):
        gen2[off:off + 4] = bytes(x ^ 0xFF for x in gen2[off:off + 4])
    gen2 = bytes(gen2)
    table2 = chunk_file_anchored_np(np.frombuffer(gen2, np.uint8), params)
    gens = {1: (body, table), 2: (gen2, table2)}
    blocks = {g: [b[i:i + BLOCK_BYTES] for i in range(0, len(b), BLOCK_BYTES)]
              for g, (b, _) in gens.items()}
    ids = list(range(1, CLUSTER_NODES + 1))
    with serve_cluster(root, ".chip_smoke_sim_", ("--sim",)) as c:
        d, port = c.dir, c.port
        nodes = {i: d / "data" / f"node-{i}" / "chunks" for i in ids}
        warm = np.random.default_rng(SEED + 2).integers(
            0, 256, size=8 * 2**20, dtype=np.uint8).tobytes()
        _upload(port[1], warm, "warm.bin")   # the chain and the sketch
        m0 = _metrics(port[1])["frag"]["launches"]
        up_s, info, disk = {}, {}, {}
        for g in (1, 2):
            t0 = time.perf_counter()
            info[g] = _upload(port[1], iter(blocks[g]), f"gen{g}.bin",
                              chunked=True)
            up_s[g] = time.perf_counter() - t0
            disk[g] = {i: _disk_bytes(nodes[i]) for i in ids}
        m1 = _metrics(port[1])
        launches = {k: m1["frag"]["launches"][k] - m0[k] for k in m0}
        for k in ("strip_chunk_states", "repack_lanes", "bswap_transpose",
                  "select_walk"):
            check(launches[k] > 0, f"kernel {k} never launched in node 1 "
                  "during the sim uploads")
        check(m1["sim"]["enabled"] and m1["sim"]["device"] == "cuda:0",
              f"node 1 sketches on {m1['sim'].get('device')}")
        for g, (b, tbl) in gens.items():
            fid = hashlib.sha256(b).hexdigest()
            check(info[g]["fileId"] == fid, f"gen {g} fileId != sha256")
            st, _, doc = _http(port[1], "GET", f"/manifest?fileId={fid}",
                               timeout=120)
            check([(x["offset"], x["length"], x["digest"])
                   for x in json.loads(doc)["chunks"]] == tbl,
                  f"gen {g} chunk table != numpy oracle")
        dl_s = {}
        for g, (b, _) in gens.items():
            t0 = time.perf_counter()
            st, _, got = _http(port[3], "GET", "/download?fileId="
                               + hashlib.sha256(b).hexdigest())
            dl_s[g] = time.perf_counter() - t0
            check(st == 200 and got == b, f"gen {g} from node 3 not identical")
        sims = {i: _metrics(port[i])["sim"] for i in ids}
        c.procs[3].send_signal(signal.SIGKILL)
        c.procs[3].wait(timeout=60)
        t0 = time.perf_counter()
        st, _, got = _http(port[5], "GET", "/download?fileId="
                           + hashlib.sha256(gen2).hexdigest())
        killed_s = time.perf_counter() - t0
        check(st == 200 and got == gen2,
              "gen 2 from node 5 after SIGKILL of node 3 not identical")
        del got
        for i in ids:
            if i != 3:
                sims[i] = _metrics(port[i])["sim"]
        for p in c.procs.values():
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)

        # after the nodes stop: every chunk of both generations on both of
        # its owners, through the port's ChunkStore (deltas reconstructed)
        stores = {i: ChunkStore(nodes[i]) for i in ids}
        old = {dg for _, _, dg in table}
        new = {dg: ln for _, ln, dg in table2 if dg not in old}
        delta_copies = 0
        for g, (_, tbl) in gens.items():
            for dg in {dg for _, _, dg in tbl}:
                for o in static_replica_set(dg, ids, 2):
                    b = stores[o].get(dg)
                    check(b is not None and hashlib.sha256(b).hexdigest()
                          == dg, f"gen {g} chunk {dg[:12]} missing or "
                          f"corrupt on owner {o}")
                    if g == 2 and dg in new \
                            and stores[o].delta_base(dg) is not None:
                        delta_copies += 1
    per_node = {}
    for i in ids:
        raw2 = sum(ln for dg, ln in new.items()
                   if i in static_replica_set(dg, ids, 2))
        per_node[i] = {k: sims[i][k] for k in (
            "sketched", "deltasWritten", "deltaBytes", "rawBytesDeferred",
            "deltaReads", "deltaChunks", "encodeAttempts")}
        per_node[i].update({"disk_after_gen1": disk[1][i],
                            "disk_after_gen2": disk[2][i],
                            "gen2_stored_bytes": disk[2][i] - disk[1][i],
                            "gen2_raw_would_be": raw2})
    written = sum(v["deltasWritten"] for v in per_node.values())
    dbytes = sum(v["deltaBytes"] for v in per_node.values())
    deferred = sum(v["rawBytesDeferred"] for v in per_node.values())
    check(written > 0, "no node wrote a delta for generation 2")
    check(dbytes < 0.1 * deferred, f"delta bytes {dbytes} not below 10% of "
          f"the raw bytes they replace ({deferred})")
    eligible = [dg for dg, ln in new.items() if ln >= 4096]
    gib = len(body) / 2**30
    emit({"phase": "cluster_sim", "nodes": CLUSTER_NODES, "rf": 2,
          "write_quorum": 2, "durability": "fsync", "sim": True,
          "bytes": len(body), "edits": len(range(SIM_EDIT_AT, len(body),
                                                 SIM_EDIT_STRIDE)),
          "chunks_gen1": len(table), "chunks_gen2": len(table2),
          "new_chunks_gen2": len(new), "eligible_new_chunks": len(eligible),
          "eligible_copies": 2 * len(eligible),
          "delta_copies": delta_copies,
          "delta_rate": delta_copies / max(1, 2 * len(eligible)),
          "upload_gen1_s": up_s[1], "upload_gen1_gib_s": gib / up_s[1],
          "upload_gen2_s": up_s[2], "upload_gen2_gib_s": gib / up_s[2],
          "transferred_gen2": info[2]["transferredBytes"],
          "download_gen1_s": dl_s[1], "download_gen2_s": dl_s[2],
          "download_gen2_after_kill_s": killed_s,
          "deltas_written": written, "delta_bytes": dbytes,
          "raw_bytes_deferred": deferred,
          "delta_frac": dbytes / max(1, deferred), "per_node": per_node,
          "oracle_equal": True, "file_id_ok": True,
          "both_generations_identical": True,
          "both_owners_hold_every_chunk": True, "launches": launches})
    return launches


def cluster_phase(root: Path, body: bytes, blocks: list, oracle: list,
                  params, rng, np, ec_body: bytes, ec_table: list,
                  ec_parity: list) -> dict:
    """The ``cluster`` phase (module docstring). Returns node 1's kernel
    launches across the streamed 128 MiB upload and across the EC
    upload."""
    from dfs_tpu_torch.meta.manifest import Manifest, ec_stripe_groups
    from dfs_tpu_torch.ops.cdc_anchored import chunk_file_anchored_np
    from dfs_tpu_torch.ring import static_ec_shard_node, static_replica_set

    ids = list(range(1, CLUSTER_NODES + 1))
    with serve_cluster(root, ".chip_smoke_cluster_") as c:
        d, http_port, procs, start_s = c.dir, c.port, c.procs, c.start_s
        # warm-up: the chain's first launches in node 1's process
        _upload(http_port[1], body[:8 * 2**20], "warm.bin")

        m0 = _metrics(http_port[1])["frag"]["launches"]
        # the disk's dirty pages written back first: an earlier phase's
        # writeback is not billed to this upload (nor to cluster_obs_off's)
        os.sync()
        t0 = time.perf_counter()
        info = _upload(http_port[1], iter(blocks), "cluster.bin",
                       chunked=True)
        upload_s = time.perf_counter() - t0
        m1 = _metrics(http_port[1])
        # where the upload's time went, node by node: the CAS tier's
        # busy and queued seconds and its fsyncs; node 1's stalls and
        # phase latencies
        where = {}
        for i in ids:
            mi = m1 if i == 1 else _metrics(http_port[i])
            where[i] = {"fsyncs": mi["durability"]["fsyncs"],
                        "chunks_stored": mi.get("chunks_stored", 0),
                        "cas": mi["ingest"]["cas"],
                        "latency": {
                            k: v for k, v in mi["latency"].items()
                            if k.startswith(("upload.",
                                             "peer.store_chunks",
                                             "peer.has_chunks"))}}
        where[1]["stalls"] = m1["ingest"]["stalls"]
        launches = {k: m1["frag"]["launches"][k] - m0[k] for k in m0}
        for k in ("strip_chunk_states", "repack_lanes",
                  "bswap_transpose", "select_walk"):
            check(launches[k] > 0, f"kernel {k} never launched in "
                  "node 1 during the cluster upload")
        check(m1["frag"]["device"].startswith("cuda:"),
              f"node 1 chunks on {m1['frag']['device']}")
        fid = hashlib.sha256(body).hexdigest()
        check(info["fileId"] == fid, "cluster fileId != sha256(body)")
        st, _, doc = _http(http_port[1], "GET",
                           f"/manifest?fileId={fid}", timeout=120)
        table = [(c["offset"], c["length"], c["digest"])
                 for c in json.loads(doc)["chunks"]]
        check(table == oracle, "cluster chunk table != numpy oracle")

        # the replication guarantee, read back: each chunk on both of
        # its owners, hashing to its digest
        for _, _, dg in table:
            for o in static_replica_set(dg, ids, 2):
                p = d / "data" / f"node-{o}" / "chunks" / dg[:2] / dg
                check(p.is_file() and hashlib.sha256(
                    p.read_bytes()).hexdigest() == dg,
                    f"chunk {dg[:12]} missing or corrupt on owner {o}")

        t0 = time.perf_counter()
        st, _, got = _http(http_port[3], "GET", f"/download?fileId={fid}")
        download_s = time.perf_counter() - t0
        check(st == 200 and got == body,
              "download from node 3 not identical")
        del got
        lo = len(body) // 3 + 12_345
        hi = min(len(body) - 1, lo + 999_999)
        st, h, part = _http(http_port[4], "GET",
                            f"/download?fileId={fid}",
                            headers={"Range": f"bytes={lo}-{hi}"})
        check(st == 206 and part == body[lo:hi + 1]
              and h.get("Content-Range")
              == f"bytes {lo}-{hi}/{len(body)}", "range read not exact")
        again = _upload(http_port[2], body, "cluster-again.bin")
        check(again["transferredBytes"] == 0,
              f"re-upload moved {again['transferredBytes']} B")

        # two uploads at once to node 1: two walks on the card, one
        # plain body (the whole-body walk), one chunked (the stream)
        two = [rng.integers(0, 256, size=CONCURRENT_BYTES,
                            dtype=np.uint8).tobytes() for _ in range(2)]
        res: dict[int, object] = {}

        def up(k: int) -> None:
            try:
                b = two[k]
                res[k] = _upload(
                    http_port[1], b if k == 0 else iter(
                        [b[i:i + BLOCK_BYTES]
                         for i in range(0, len(b), BLOCK_BYTES)]),
                    f"concurrent{k}.bin", chunked=k == 1)
            except BaseException as e:  # noqa: BLE001 — checked below
                res[k] = e

        t0 = time.perf_counter()
        threads = [threading.Thread(target=up, args=(k,)) for k in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        concurrent_s = time.perf_counter() - t0
        for k in (0, 1):
            check(isinstance(res[k], dict), f"concurrent upload {k} "
                  f"failed: {res[k]}")
            kid = res[k]["fileId"]
            check(kid == hashlib.sha256(two[k]).hexdigest(),
                  f"concurrent upload {k} fileId != sha256")
            st, _, doc = _http(http_port[1], "GET",
                               f"/manifest?fileId={kid}", timeout=120)
            check([(c["offset"], c["length"], c["digest"])
                   for c in json.loads(doc)["chunks"]]
                  == chunk_file_anchored_np(
                      np.frombuffer(two[k], np.uint8), params),
                  f"concurrent upload {k} chunk table != numpy oracle")
        fsyncs = _metrics(http_port[1])["durability"]["fsyncs"]

        # erasure coding: the EC body whole to node 1 at k=3, chunked
        # and encoded on the card; every shard once, on its holder
        e0 = _metrics(http_port[1])["frag"]
        t0 = time.perf_counter()
        ec_info = _upload(http_port[1], ec_body, "ec.bin", ec=EC_K)
        ec_upload_s = time.perf_counter() - t0
        e1 = _metrics(http_port[1])["frag"]
        ec_launches = {k: e1["launches"][k] - e0["launches"][k]
                       for k in e0["launches"]}
        for k in ("strip_chunk_states", "repack_lanes",
                  "bswap_transpose", "select_walk"):
            check(ec_launches[k] > 0, f"kernel {k} never launched in "
                  "node 1 during the EC upload")
        enc = e1["ecEncode"]
        check(enc["device"] == "cuda:0"
              and enc["calls"] == e0["ecEncode"]["calls"] + 1,
              f"node 1's EC encode ran on {enc['device']} "
              f"({enc['calls']} calls)")
        ec_fid = hashlib.sha256(ec_body).hexdigest()
        check(ec_info["fileId"] == ec_fid, "EC fileId != sha256(body)")
        st, _, doc = _http(http_port[1], "GET",
                           f"/manifest?fileId={ec_fid}", timeout=120)
        ecm = Manifest.from_json(doc)
        check([(c.offset, c.length, c.digest) for c in ecm.chunks]
              == ec_table, "EC chunk table != numpy oracle")
        check(ecm.ec is not None and ecm.ec.k == EC_K
              and len(ecm.ec.stripes) == len(ec_parity),
              "EC manifest layout")
        check(all(st_.p == hashlib.sha256(p.tobytes()).hexdigest()
                  and st_.q == hashlib.sha256(q.tobytes()).hexdigest()
                  for st_, (p, q) in zip(ecm.ec.stripes, ec_parity)),
              "EC P/Q digests != sha256 of encode_pq_np")
        check(ec_info["ecParityBytes"]
              == sum(2 * st_.shard_len for st_ in ecm.ec.stripes),
              "ecParityBytes")
        shards = 0
        for s_, (st_, grp) in enumerate(zip(
                ecm.ec.stripes, ec_stripe_groups(ecm.chunks, EC_K))):
            digests = [c.digest for c in grp] + [st_.p, st_.q]
            for j, dg in enumerate(digests):
                o = static_ec_shard_node(ec_fid, s_, j, ids)
                p = d / "data" / f"node-{o}" / "chunks" / dg[:2] / dg
                check(p.is_file() and hashlib.sha256(
                    p.read_bytes()).hexdigest() == dg,
                    f"EC shard {dg[:12]} missing or corrupt on its "
                    f"holder {o}")
                shards += 1

        # node loss: SIGKILL an owner, read from a survivor that asks
        # node 3 first for the chunks node 3 and node 4 own
        procs[3].send_signal(signal.SIGKILL)
        procs[3].wait(timeout=60)
        t0 = time.perf_counter()
        st, _, got = _http(http_port[5], "GET", f"/download?fileId={fid}")
        degraded_s = time.perf_counter() - t0
        check(st == 200 and got == body,
              "download after SIGKILL of node 3 not identical")
        del got

        # a second node lost: every EC stripe has lost two shards; node
        # 1 reads the EC file whole by decode
        procs[4].send_signal(signal.SIGKILL)
        procs[4].wait(timeout=60)
        dec0 = _metrics(http_port[1]).get("ec_decodes", 0)
        t0 = time.perf_counter()
        st, _, got = _http(http_port[1], "GET",
                           f"/download?fileId={ec_fid}")
        ec_two_down_s = time.perf_counter() - t0
        check(st == 200 and got == ec_body,
              "EC download with nodes 3 and 4 killed not identical")
        del got
        ec_decodes = _metrics(http_port[1]).get("ec_decodes", 0) - dec0
        check(ec_decodes > 0, "EC download with two nodes killed "
              "decoded nothing")
    gib = len(body) / 2**30
    emit({"phase": "cluster", "nodes": CLUSTER_NODES, "rf": 2,
          "write_quorum": 2, "durability": "fsync", "bytes": len(body),
          "block_bytes": BLOCK_BYTES, "start_s": start_s,
          "chunks": len(table), "upload_s": upload_s,
          "upload_gib_s": gib / upload_s,
          "download_s": download_s, "download_gib_s": gib / download_s,
          "download_after_kill_s": degraded_s,
          "download_after_kill_gib_s": gib / degraded_s,
          "concurrent_bytes": 2 * CONCURRENT_BYTES,
          "concurrent_s": concurrent_s, "oracle_equal": True,
          "file_id_ok": True, "both_owners_hold_every_chunk": True,
          "range_exact": True,
          "reupload_transferred": again["transferredBytes"],
          "concurrent_oracle_equal": True,
          "node1_device": m1["frag"]["device"],
          "node1_fsyncs": fsyncs, "after_upload": where,
          "launches": launches})
    ec_gib = len(ec_body) / 2**30
    emit({"phase": "cluster_ec", "nodes": CLUSTER_NODES, "k": EC_K,
          "bytes": len(ec_body), "chunks": len(ecm.chunks),
          "stripes": len(ecm.ec.stripes), "shards": shards,
          "parity_bytes": ec_info["ecParityBytes"],
          "upload_s": ec_upload_s, "upload_gib_s": ec_gib / ec_upload_s,
          "download_two_killed_s": ec_two_down_s,
          "download_two_killed_gib_s": ec_gib / ec_two_down_s,
          "ec_decodes": ec_decodes, "encode": enc, "oracle_equal": True,
          "file_id_ok": True, "parity_digests_equal_oracle": True,
          "every_shard_on_its_holder": True, "launches": ec_launches})
    return launches, ec_launches, download_s, upload_s


def _get_many(port: int, path: str, n: int, headers: dict) -> list:
    """``n`` concurrent GETs released together by a barrier: (status,
    headers, body) each."""
    gate = threading.Barrier(n)
    out: list = [None] * n

    def one(k: int) -> None:
        try:
            gate.wait(timeout=60)
            out[k] = _http(port, "GET", path, headers=headers, timeout=300)
        except BaseException as e:  # noqa: BLE001 — checked by the caller
            out[k] = e

    threads = [threading.Thread(target=one, args=(k,)) for k in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return out


def cluster_serve_phase(root: Path, body: bytes, blocks: list,
                        oracle: list, cluster_download_s: float) -> dict:
    """The ``cluster_serve`` phase (module docstring). Returns node 1's
    kernel launches across the upload."""
    from dfs_tpu_torch.meta.manifest import Manifest

    fid = hashlib.sha256(body).hexdigest()
    gib = len(body) / 2**30
    tier = ("--cache-bytes", str(SERVE_CACHE_BYTES), "--readahead", "2",
            "--hedge-budget", "50", "--hedge-floor", "0.04",
            "--hedge-cap", "0.3")
    shed_node = CLUSTER_NODES
    t_phase = time.perf_counter()
    with serve_cluster(root, ".chip_smoke_serve_", tier, per_node={
            shed_node: ("--download-slots", str(SERVE_SLOTS),
                        "--queue-depth", str(SERVE_QUEUE))}) as c:
        port, procs = c.port, c.procs
        # 1. the upload, chunked on the card in node 1
        m0 = _metrics(port[1])["frag"]["launches"]
        t0 = time.perf_counter()
        info = _upload(port[1], iter(blocks), "serve.bin", chunked=True)
        upload_s = time.perf_counter() - t0
        m1 = _metrics(port[1])
        launches = {k: m1["frag"]["launches"][k] - m0[k] for k in m0}
        counts = ("fired", "won", "denied")
        upload_hedge = {k: m1["serve"]["hedge"][k] for k in counts}
        for k in ("strip_chunk_states", "repack_lanes",
                  "bswap_transpose", "select_walk"):
            check(launches[k] > 0, f"kernel {k} never launched in "
                  "node 1 during the cluster_serve upload")
        check(info["fileId"] == fid, "cluster_serve fileId != sha256")
        st, _, doc = _http(port[1], "GET", f"/manifest?fileId={fid}",
                           timeout=120)
        check([(x["offset"], x["length"], x["digest"])
               for x in json.loads(doc)["chunks"]] == oracle,
              "cluster_serve chunk table != numpy oracle")
        # what every read of the file pays on its node's event loop
        # before any chunk: the manifest load (json + ChunkRefs)
        parse = []
        for _ in range(5):
            t0 = time.perf_counter()
            Manifest.from_json(doc)
            parse.append(time.perf_counter() - t0)

        # 2. node 3 reads it cold (readahead 2), then hot (its cache)
        dl = {}
        for kind in ("cold", "hot"):
            t0 = time.perf_counter()
            st, _, got = _http(port[3], "GET", f"/download?fileId={fid}")
            dl[kind] = time.perf_counter() - t0
            check(st == 200 and got == body,
                  f"{kind} download from node 3 not identical")
            del got
        s3 = _metrics(port[3])["serve"]
        check(s3["cache"]["hits"] > 0, "node 3's hot read hit no cache")

        # 3. hot Range reads on node 1: 32 readers of the first 32 MiB
        rng_hdr = {"Range": f"bytes=0-{SERVE_RANGE_BYTES - 1}"}
        want = body[:SERVE_RANGE_BYTES]
        rounds = []
        for r in range(2):
            f0 = _metrics(port[1])["serve"]["flight"]["coalesced"]
            t0 = time.perf_counter()
            res = _get_many(port[1], f"/download?fileId={fid}",
                            SERVE_READERS, rng_hdr)
            secs = time.perf_counter() - t0
            for x in res:
                check(isinstance(x, tuple) and x[0] == 206 and x[2] == want,
                      f"hot Range read round {r + 1} not identical: "
                      f"{x if not isinstance(x, tuple) else x[0]}")
            s1 = _metrics(port[1])["serve"]
            rounds.append({"seconds": secs,
                           "gib_s": SERVE_READERS * SERVE_RANGE_BYTES
                           / 2**30 / secs,
                           "coalesced": s1["flight"]["coalesced"] - f0,
                           "cache_hits": s1["cache"]["hits"]})
            del res
        check(rounds[1]["cache_hits"] > 0,
              "node 1's second round hit no cache")

        # 4. the shed curve on node 5 (2 slots + a queue of 6). A Range
        # read gives its slot back before its body is written, and one
        # served from the cache never yields in between, so hot readers
        # never overlap: each level reads a 32 MiB window node 5 has not
        # read yet, and its readers wait on one origin fetch together
        curve = []
        for level, n in enumerate(SERVE_CURVE):
            lo = level * SERVE_RANGE_BYTES
            want = body[lo:lo + SERVE_RANGE_BYTES]
            res = _get_many(port[shed_node], f"/download?fileId={fid}", n,
                            {"Range": f"bytes={lo}-"
                                      f"{lo + SERVE_RANGE_BYTES - 1}"})
            ok = shed = 0
            for x in res:
                check(isinstance(x, tuple), f"shed curve request failed: "
                      f"{x}")
                if x[0] == 503:
                    check("Retry-After" in x[1], "503 without Retry-After")
                    shed += 1
                else:
                    check(x[0] == 206 and x[2] == want,
                          f"shed curve answer {x[0]} not an identical 206")
                    ok += 1
            if n <= SERVE_SLOTS + SERVE_QUEUE:
                check(shed == 0, f"{shed} of {n} shed at concurrency {n}")
            curve.append({"concurrency": n, "range_start": lo, "ok": ok,
                          "shed": shed})
            del res
        check(curve[-1]["shed"] > 0, "no 503 at concurrency "
              f"{SERVE_CURVE[-1]}")

        # 5. an expired deadline: 503 + Retry-After, nothing downloaded;
        # at node 5 the gate sheds it, at node 1 (no gate) the read path
        deadline = {}
        for i in (shed_node, 1):
            b0 = _metrics(port[i])
            st, h, _ = _http(port[i], "GET", f"/download?fileId={fid}",
                             headers={"X-Dfs-Deadline": "0"})
            b1 = _metrics(port[i])
            check(st == 503 and "Retry-After" in h,
                  f"expired deadline at node {i} answered {st}")
            check(b1.get("downloads", 0) == b0.get("downloads", 0),
                  f"expired deadline at node {i} still downloaded")
            adm0, adm1 = (x["serve"]["admission"] for x in (b0, b1))
            deadline[i] = {
                "status": st, "retry_after": h.get("Retry-After"),
                "deadline_shed": adm1["download"]["deadlineShed"]
                - adm0["download"]["deadlineShed"]
                if "download" in adm1 else None,
                "deadline_drops": b1.get("deadline_drops", 0)
                - b0.get("deadline_drops", 0)}
        check(deadline[shed_node]["deadline_shed"] == 1,
              "node 5's gate did not count the deadline shed")
        check(deadline[1]["deadline_drops"] >= 1,
              "node 1 did not drop the expired read")

        # 6. the hedge: node 3 stopped, node 1 reads the whole file
        h0 = _metrics(port[1])["serve"]["hedge"]
        procs[3].send_signal(signal.SIGSTOP)
        try:
            t0 = time.perf_counter()
            st, _, got = _http(port[1], "GET", f"/download?fileId={fid}")
            hedged_s = time.perf_counter() - t0
        finally:
            procs[3].send_signal(signal.SIGCONT)
        check(st == 200 and got == body,
              "download with node 3 stopped not identical")
        del got
        h1 = _metrics(port[1])["serve"]["hedge"]
        hedge = {k: h1[k] - h0[k] for k in counts}
        check(hedge["fired"] > 0 and hedge["won"] > 0,
              f"node 1's hedge with node 3 stopped: {hedge}")
    emit({"phase": "cluster_serve", "nodes": CLUSTER_NODES, "rf": 2,
          "flags": " ".join(tier), f"node{shed_node}_flags":
          f"--download-slots {SERVE_SLOTS} --queue-depth {SERVE_QUEUE}",
          "bytes": len(body), "upload_s": upload_s,
          "upload_gib_s": gib / upload_s, "oracle_equal": True,
          "upload_hedge_node1": upload_hedge,
          "manifest_bytes": len(doc),
          "manifest_parse_s": statistics.median(parse),
          "download_cold_s": dl["cold"], "download_cold_gib_s":
          gib / dl["cold"], "download_hot_s": dl["hot"],
          "download_hot_gib_s": gib / dl["hot"],
          "cluster_download_s": cluster_download_s,
          "node3_cache": {k: v for k, v in s3["cache"].items()
                          if k != "temperature"},
          "node3_hedge": {k: s3["hedge"][k] for k in counts},
          "hot_range": {"readers": SERVE_READERS,
                        "range_bytes": SERVE_RANGE_BYTES,
                        "rounds": rounds},
          "shed_curve": curve, "deadline": deadline,
          "hedged_download_s": hedged_s,
          "hedged_download_gib_s": gib / hedged_s, "hedge": hedge,
          "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    return launches


def _peers_synced(ports: dict) -> tuple[bool, dict]:
    """True once every node's replica of every peer's filter is at that
    peer's own (generation, version). Returns the verdict and each node's
    ``index`` section."""
    idx = {i: _metrics(p)["index"] for i, p in ports.items()}
    for i, st in idx.items():
        peers = st.get("peerFilters", {}).get("peers", {})
        for j, own in idx.items():
            if j == i:
                continue
            rep = peers.get(str(j))
            if rep is None or rep["gen"] != own["filter"]["generation"] \
                    or rep["version"] != own["filter"]["version"]:
                return False, idx
    return True, idx


def _has_chunks_calls(m: dict) -> dict:
    return {k: v["count"] for k, v in m["rpcClient"].items()
            if k.endswith(":has_chunks")}


def cluster_index_tier_phase(root: Path, body_a: bytes, table_a: list,
                             params, np) -> dict:
    """The ``cluster_index_tier`` phase (module docstring). Returns the
    kernel launches of the uploads: node 1's across A and node 2's across
    the re-upload of A and C."""
    from dfs_tpu_torch.ops.cdc_anchored import chunk_file_anchored_np
    from dfs_tpu_torch.ring import static_replica_set

    ids = list(range(1, CLUSTER_NODES + 1))
    body_c = np.random.default_rng(SEED + 2).integers(
        0, 256, size=EC_BYTES, dtype=np.uint8)
    table_c = chunk_file_anchored_np(body_c, params)
    body_c = body_c.tobytes()
    t_phase = time.perf_counter()        # set-up (body C, its oracle) done
    fid_a = hashlib.sha256(body_a).hexdigest()
    fid_c = hashlib.sha256(body_c).hexdigest()
    blocks = {f: [b[i:i + BLOCK_BYTES] for i in range(0, len(b), BLOCK_BYTES)]
              for f, b in ((fid_a, body_a), (fid_c, body_c))}
    times: dict = {}

    def timed(what: str, fn):
        t0 = time.perf_counter()
        out = fn()
        times[what] = time.perf_counter() - t0
        emit({"phase": "cluster_index_tier:time", "what": what,
              "seconds": times[what]})
        return out

    def table_of(port: int, fid: str) -> tuple[list, dict]:
        st, _, doc = _http(port, "GET", f"/manifest?fileId={fid}",
                           timeout=120)
        check(st == 200, f"/manifest {fid[:12]} answered {st}")
        doc = json.loads(doc)
        return [(x["offset"], x["length"], x["digest"])
                for x in doc["chunks"]], doc

    def stored(d: Path) -> int:
        return sum(_disk_bytes(d / "data" / f"node-{i}" / "chunks")
                   for i in ids)

    with serve_cluster(root, ".chip_smoke_tier_", TIER_FLAGS) as c:
        d, port = c.dir, c.port
        # (a) A streamed to node 1: table == oracle, K1-K4 in node 1
        m0 = _metrics(port[1])["frag"]["launches"]
        info_a = timed("upload_a_node1", lambda: _upload(
            port[1], iter(blocks[fid_a]), "a.bin", chunked=True))
        m1 = _metrics(port[1])
        launches = {k: m1["frag"]["launches"][k] - m0[k] for k in m0}
        for k in ("strip_chunk_states", "repack_lanes", "bswap_transpose",
                  "select_walk"):
            check(launches[k] > 0, f"kernel {k} never launched in node 1 "
                  "during the upload of A")
        check(info_a["fileId"] == fid_a, "A's fileId != sha256")
        check(table_of(port[1], fid_a)[0] == table_a,
              "A's chunk table != numpy oracle")

        # (b) the filters replicate; A again, to node 2, moves 0 B
        t0 = time.perf_counter()
        while True:
            ok, idx = _peers_synced(port)
            if ok:
                break
            check(time.perf_counter() - t0 < 30,
                  "peer filters not replicated within 30 s")
            time.sleep(0.25)
        times["filter_sync_wait"] = time.perf_counter() - t0
        emit({"phase": "cluster_index_tier:time", "what":
              "filter_sync_wait", "seconds": times["filter_sync_wait"]})
        n2a = _metrics(port[2])
        info_a2 = timed("reupload_a_node2", lambda: _upload(
            port[2], iter(blocks[fid_a]), "a-again.bin", chunked=True))
        n2b = _metrics(port[2])
        ix_a, ix_b = n2a["index"], n2b["index"]
        probes_before, probes_after = (_has_chunks_calls(n2a),
                                       _has_chunks_calls(n2b))
        probe_calls = {k: v - probes_before.get(k, 0)
                       for k, v in probes_after.items()}
        trusted = ix_b["filterTrusted"] - ix_a["filterTrusted"]
        check(info_a2["transferredBytes"] == 0,
              f"re-upload of A moved {info_a2['transferredBytes']} B")
        check(info_a2["minCopies"] >= 2, "re-upload of A below 2 copies")
        check(ix_b["probeRpcsSkipped"] > ix_a["probeRpcsSkipped"],
              "re-upload of A skipped no probe RPC")
        check(trusted > 0, "re-upload of A trusted no filter positive")
        check(ix_b["filterFp"] == ix_a["filterFp"]
              and not n2b.get("index_verify_failures"),
              "a trusted copy of A failed its verification")
        # the verification round: one has_chunks per peer credited
        check(sum(probe_calls.values()) <= CLUSTER_NODES - 1,
              f"re-upload of A probed more than the verify round: "
              f"{probe_calls}")

        # (c) C, fresh, to node 2: every (peer, digest) placement was
        # answered by a filter (ruled out, or trusted and verified)
        info_c = timed("upload_c_node2", lambda: _upload(
            port[2], iter(blocks[fid_c]), "c.bin", chunked=True))
        n2c = _metrics(port[2])
        launches2 = {k: n2c["frag"]["launches"][k] - n2a["frag"]["launches"][k]
                     for k in m0}
        check(info_c["fileId"] == fid_c, "C's fileId != sha256")
        check(table_of(port[2], fid_c)[0] == table_c,
              "C's chunk table != numpy oracle")
        pairs = sum(1 for dg in {dg for _, _, dg in table_c}
                    for o in static_replica_set(dg, ids, 2) if o != 2)
        skipped_c = n2c["index"]["probesSkipped"] \
            - ix_b["probesSkipped"]
        fp_c = n2c["index"]["filterFp"] - ix_b["filterFp"]
        check(skipped_c == pairs, f"C: probesSkipped grew by {skipped_c}, "
              f"want the {pairs} placements the filters answered")

        # (d) C read twice from node 3, then a scan on node 1 demotes A
        for r in range(2):
            st, _, got = timed(f"read_c_node3_{r + 1}", lambda: _http(
                port[3], "GET", f"/download?fileId={fid_c}"))
            check(st == 200 and got == body_c, "C from node 3 not identical")
        del got
        bytes_hot = stored(d)
        st, _, out = timed("tier_scan_node1", lambda: _http(
            port[1], "POST", "/tier", body=b""))
        check(st == 200, f"POST /tier answered {st}: {out[:300]}")
        scan = json.loads(out)
        check(scan["demoted"] == 1 and scan["cold"] == 1,
              f"scan did not demote exactly A: {scan}")
        _, doc_a = table_of(port[1], fid_a)
        check(doc_a.get("tier") == "cold" and doc_a.get("ec", {}).get("k")
              == 3, "A's manifest is not cold k=3 EC")
        check(table_of(port[1], fid_c)[1].get("tier") is None,
              "C was demoted")
        m1d = _metrics(port[1])
        enc = m1d["frag"]["ecEncode"]
        check(enc["device"] == "cuda:0" and enc["calls"] >= 1,
              f"demotion encoded on {enc['device']}")
        bytes_cold = stored(d)
        check(bytes_cold < bytes_hot, f"stored bytes {bytes_hot} -> "
              f"{bytes_cold} did not fall")

        # (e) nodes 3 and 4 SIGKILLed: A from node 5, by decode
        for i in (3, 4):
            c.procs[i].send_signal(signal.SIGKILL)
            c.procs[i].wait(timeout=60)
        st, _, got = timed("cold_read_a_node5_two_down", lambda: _http(
            port[5], "GET", f"/download?fileId={fid_a}"))
        check(st == 200 and got == body_a,
              "A from node 5 with nodes 3, 4 down not identical")
        del got
        decodes5 = _metrics(port[5]).get("ec_decodes", 0)

        # (f) nodes 3 and 4 back with the same flags: the LSI reopened
        # after SIGKILL agrees with the CAS walk
        scrubs = {}
        timed("restart_nodes_3_4", lambda: c.restart(3, 4))
        for i in (3, 4):
            st, _, out = _http(port[i], "POST", "/scrub", body=b"")
            check(st == 200, f"/scrub on node {i} answered {st}")
            scrubs[i] = json.loads(out)
            check(scrubs[i]["healedMissing"] == 0
                  and scrubs[i]["healedPhantom"] == 0,
                  f"node {i}'s index disagreed with its CAS: {scrubs[i]}")
            check(_metrics(port[i])["index"]["lsi"]["rebuilds"] == 0,
                  f"node {i} rebuilt its index at boot")

        # (g) A read from node 1 until it promotes. The promotion check
        # runs before a read feeds the ledger, so with
        # --tier-promote-reads 2 the third read (after node 5's read above
        # heated node 1's shards) starts it; a later read only if the
        # promotion did not come
        reads = 0
        while True:
            st, _, got = timed(f"read_a_node1_{reads + 1}", lambda: _http(
                port[1], "GET", f"/download?fileId={fid_a}"))
            reads += 1
            check(st == 200 and got == body_a, "A from node 1 not identical")
            del got
            if reads < 3:
                continue
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 60 \
                    and _metrics(port[1])["tier"]["promotedFiles"] == 0:
                time.sleep(0.1)
            if _metrics(port[1])["tier"]["promotedFiles"] == 1:
                break
            check(reads < 5, "A never promoted")
        times["promotion_after_read"] = time.perf_counter() - t0
        emit({"phase": "cluster_index_tier:time",
              "what": "promotion_after_read",
              "seconds": times["promotion_after_read"], "reads": reads})
        check(table_of(port[1], fid_a)[1].get("tier") is None,
              "A promoted but its manifest is still cold")
        st, _, got = timed("read_a_node1_promoted", lambda: _http(
            port[1], "GET", f"/download?fileId={fid_a}"))
        check(st == 200 and got == body_a, "promoted A not identical")
        del got
        check(table_of(port[1], fid_a)[1].get("ec") is None,
              "promoted A still carries its EC layout")
        bytes_promoted = stored(d)
        check(bytes_promoted > bytes_cold, f"stored bytes after promotion "
              f"{bytes_promoted} not above {bytes_cold}")
        final = {i: _metrics(port[i]) for i in (1, 2)}
    for i in (1, 2):
        emit({"phase": "cluster_index_tier:node", "node": i,
              "index": final[i]["index"], "tier": final[i]["tier"]})
    both = {k: launches[k] + launches2[k] for k in launches}
    emit({"phase": "cluster_index_tier", "nodes": CLUSTER_NODES, "rf": 2,
          "write_quorum": 2, "durability": "fsync", "flags": TIER_FLAGS,
          "bytes_a": len(body_a), "bytes_c": len(body_c),
          "chunks_a": len(table_a), "chunks_c": len(table_c),
          "times_s": times,
          "upload_a_gib_s": len(body_a) / 2**30 / times["upload_a_node1"],
          "reupload_a": {"transferred": info_a2["transferredBytes"],
                         "dedup_skipped": info_a2["dedupSkippedBytes"],
                         "filter_trusted": trusted,
                         "probe_rpcs_skipped": ix_b["probeRpcsSkipped"]
                         - ix_a["probeRpcsSkipped"],
                         "has_chunks_calls": probe_calls,
                         "has_chunks_calls_total": probes_after},
          "upload_c": {"transferred": info_c["transferredBytes"],
                       "peer_placements": pairs,
                       "probes_skipped": skipped_c, "filter_fp": fp_c},
          "scan": scan, "ec_encode": enc,
          "stored_bytes": {"hot": bytes_hot, "cold": bytes_cold,
                           "promoted": bytes_promoted},
          "ec_decodes_node5": decodes5, "scrub_after_restart": scrubs,
          "promote_reads_taken": reads,
          "launches_node1_a": launches, "launches_node2_a_c": launches2,
          "oracle_equal": True, "identical_reads": True,
          "seconds": time.perf_counter() - t_phase})
    return both


def cluster_obs_off_phase(root: Path, blocks: list, oracle: list,
                          body_len: int, upload_default_s: float) -> dict:
    """The ``cluster_obs_off`` phase (module docstring): the ``cluster``
    phase's warm-up and streamed upload on 5 fresh processes with tracing,
    the journal and the sentinel off. Returns node 1's kernel launches."""
    fid = None
    with serve_cluster(root, ".chip_smoke_obs_off_", OBS_OFF_FLAGS) as c:
        port = c.port
        _upload(port[1], b"".join(blocks[:8]), "warm.bin")
        m0 = _metrics(port[1])["frag"]["launches"]
        os.sync()                        # as the cluster phase does
        t0 = time.perf_counter()
        info = _upload(port[1], iter(blocks), "cluster.bin", chunked=True)
        upload_s = time.perf_counter() - t0
        m1 = _metrics(port[1])
        launches = {k: m1["frag"]["launches"][k] - m0[k] for k in m0}
        for k in ("strip_chunk_states", "repack_lanes",
                  "bswap_transpose", "select_walk"):
            check(launches[k] > 0, f"kernel {k} never launched in node 1 "
                  "during the tracing-off upload")
        fid = info["fileId"]
        st, _, doc = _http(port[1], "GET", f"/manifest?fileId={fid}",
                           timeout=120)
        check([(x["offset"], x["length"], x["digest"])
               for x in json.loads(doc)["chunks"]] == oracle,
              "tracing-off cluster chunk table != numpy oracle")
        o = m1["obs"]
        check(o["traceRing"] == 0 and o["spans"] == 0
              and o["journal"] == {"enabled": False}
              and o["sentinel"] == {"enabled": False},
              f"tracing-off node 1 still observes: {o}")
    gib = body_len / 2**30
    emit({"phase": "cluster_obs_off", "flags": list(OBS_OFF_FLAGS),
          "bytes": body_len, "start_s": c.start_s, "upload_s": upload_s,
          "upload_gib_s": gib / upload_s,
          "upload_default_s": upload_default_s,
          "off_over_default": upload_s / upload_default_s,
          "oracle_equal": True, "launches": launches})
    return launches


def _trace_header() -> tuple[str, str, dict]:
    tid, sid = os.urandom(16).hex(), os.urandom(8).hex()
    return tid, sid, {"X-Dfs-Trace": f"{tid}-{sid}"}


def _events(port: int, since: float = 0.0) -> list:
    st, _, out = _http(port, "GET", f"/events?since={since}&limit=4096",
                       timeout=60)
    check(st == 200, f"/events on :{port} answered {st}")
    return json.loads(out)["events"]


def _chaos(port: int, knobs: dict) -> dict:
    st, _, out = _http(port, "POST", "/chaos",
                       body=json.dumps(knobs).encode(), timeout=60)
    check(st == 200, f"POST /chaos {knobs} on :{port} answered {st}: "
          f"{out[:200]}")
    return json.loads(out)


def _rpc_by_peer(m: dict) -> dict:
    """peer -> [calls, seconds] over node m's client RPC table."""
    out: dict = {}
    for key, row in m["rpcClient"].items():
        peer = key.split(":", 1)[0]
        acc = out.setdefault(peer, [0, 0.0])
        acc[0] += row["count"]
        acc[1] += row["seconds"]
    return out


def _get_json(port: int, path: str, timeout: float = 120.0) -> dict:
    st, _, out = _http(port, "GET", path, timeout=timeout)
    check(st == 200, f"GET {path} on :{port} answered {st}: {out[:200]}")
    return json.loads(out)


def _census_gate(rep: dict, require_no_orphans: bool) -> dict:
    """bench_chaos.py's census gate: under- and over-replicated 0, every
    peer answering, and (unless uploads were aborted) no orphan."""
    out = {"under_replicated": rep.get("underReplicatedTotal", -1),
           "over_replicated": rep.get("overReplicatedTotal", -1),
           "orphaned": rep.get("orphanedTotal", -1),
           "in_flight": rep.get("inFlightTotal", -1),
           "peers_failed": rep.get("peersFailed", -1),
           # diverging buckets past the drill cap: their copies count as
           # unknown, as in dfs_tpu (reported, not gated)
           "unchecked_buckets": rep.get("uncheckedBuckets", -1)}
    out["census_clean"] = (out["under_replicated"] == 0
                          and out["over_replicated"] == 0
                          and out["peers_failed"] == 0
                          and (not require_no_orphans
                               or out["orphaned"] == 0))
    return out


def _census_clean(port: dict, coord: int, what: str,
                  require_no_orphans: bool, timeout: float = 90.0) -> dict:
    """Repair rounds on every node (all at once) until ``GET /census`` at
    ``coord`` passes the gate; fails the run past ``timeout``. Returns the
    gate's numbers with the rounds and seconds it took."""
    t0 = time.perf_counter()
    rounds = 0
    while True:
        rep = _get_json(port[coord], "/census")
        gate = _census_gate(rep, require_no_orphans)
        if gate["census_clean"]:
            break
        check(time.perf_counter() - t0 < timeout,
              f"census at node {coord} not clean {what}: {gate}")
        # every node's repair at once (a stray waits for its holders'
        # confirmations, so a round may take two passes)
        with concurrent.futures.ThreadPoolExecutor(len(port)) as pool:
            sts = list(pool.map(lambda i: _http(port[i], "POST", "/repair",
                                                body=b"", timeout=600)[0],
                                sorted(port)))
        check(all(st == 200 for st in sts), f"/repair answered {sts}")
        rounds += 1
    return {**gate, "repair_rounds": rounds,
            "seconds": time.perf_counter() - t0,
            "digests": rep.get("digests"),
            "histogram": rep.get("replicationHistogram")}


def _doctor_rules(port: int) -> tuple[dict, list]:
    doc = _get_json(port, "/doctor")
    return doc, [(f["rule"], f.get("peers") or [])
                 for f in doc.get("findings", [])]


def cluster_chaos_phase(root: Path, body: bytes, table: list, np,
                        chain_ms: float) -> dict:
    """The ``cluster_chaos`` phase (module docstring), steps (a)-(e) on 5
    ``serve --chaos`` processes. Returns node 1's kernel launches across
    the traced upload of step (a)."""
    from dfs_tpu_torch.chaos import CRASH_POINTS
    from dfs_tpu_torch.meta.manifest import Manifest

    ids = list(range(1, CLUSTER_NODES + 1))
    rng = np.random.default_rng(SEED + 3)

    def small() -> bytes:
        return rng.integers(0, 256, size=CHAOS_SMALL_BYTES,
                            dtype=np.uint8).tobytes()

    acked: dict[str, bytes] = {}         # fileId -> body, every ack
    fid = hashlib.sha256(body).hexdigest()
    blocks = [body[i:i + BLOCK_BYTES] for i in range(0, len(body),
                                                      BLOCK_BYTES)]
    times: dict = {}
    out: dict = {"phase": "cluster_chaos", "nodes": CLUSTER_NODES,
                 "flags": list(CHAOS_FLAGS)}
    per_node: dict[int, tuple] = {}
    t_phase = time.perf_counter()
    with serve_cluster(root, ".chip_smoke_chaos_", CHAOS_FLAGS,
                       per_node=per_node) as c:
        d, port, procs = c.dir, c.port, c.procs
        out["start_s"] = c.start_s

        # (d), run first: node 3 slow, node 1's frames torn at 5%: uploads
        # ack, nothing acked is lost, node 1's table and doctor name node 3
        # slowest. First, as bench_chaos.py runs its slow_peer scenario
        # first: the doctor's slow_peer rule reads 60 s windows of every
        # node's RPC means, and the bulk transfers of the other steps
        # would sit in them
        t0 = time.perf_counter()
        _chaos(port[3], {"serve_delay_s": 0.5})
        _chaos(port[1], {"rpc_truncate_rate": 0.05})
        r0 = _rpc_by_peer(_metrics(port[1]))
        slow = []
        for k in range(CHAOS_SLOW_UPLOADS):
            b = small()
            inf = _upload(port[1], b, f"slow{k}.bin")
            acked[inf["fileId"]] = b
            slow.append(inf["fileId"])
        # the doctor's verdict late in the fault window, polled up to 3
        # times as bench_chaos.py's scenario_slow_peer polls it: the
        # windowed per-peer means need enough slow calls to dominate
        slow_named, slow_polls = False, 0
        for _ in range(3):
            slow_polls += 1
            _, rules = _doctor_rules(port[1])
            slow_named = any(r == "slow_peer" and 3 in peers
                             for r, peers in rules)
            if slow_named:
                break
            time.sleep(2.0)
        check(slow_named, f"node 1's doctor names no slow node 3: {rules}")
        m = _metrics(port[1])
        r1 = _rpc_by_peer(m)
        means = {p: (r1[p][1] - r0.get(p, [0, 0.0])[1])
                 / (r1[p][0] - r0.get(p, [0, 0.0])[0])
                 for p in r1 if r1[p][0] > r0.get(p, [0, 0.0])[0]}
        torn = m["chaos"]["injected"].get("rpc_truncate", 0)
        _chaos(port[1], {"rpc_truncate_rate": 0.0})
        _chaos(port[3], {"serve_delay_s": 0.0})
        for f in slow:
            st, _, got = _http(port[5], "GET", f"/download?fileId={f}")
            check(st == 200 and got == acked[f],
                  f"slow-peer upload {f[:12]} not identical on node 5")
        check(max(means, key=means.get) == "3",
              f"node 1's slowest peer is not node 3: {means}")
        times["d_s"] = time.perf_counter() - t0
        out["d"] = {"uploads": len(slow), "torn_frames": torn,
                    "mean_rpc_s_by_peer": means, "seconds": times["d_s"],
                    "doctor_named_slow_peer": slow_named,
                    "doctor_polls": slow_polls, "doctor_rules": rules}
        emit({"phase": "cluster_chaos:d", **out["d"]})

        # (a) the EC body streamed to node 1 under X-Dfs-Trace, stitched
        # at node 3
        tid, sid, hdr = _trace_header()
        m0 = _metrics(port[1])["frag"]["launches"]
        t0 = time.perf_counter()
        info = _upload(port[1], iter(blocks), "traced.bin", chunked=True,
                       headers=hdr)
        times["a_upload_s"] = time.perf_counter() - t0
        m1 = _metrics(port[1])
        launches = {k: m1["frag"]["launches"][k] - m0[k] for k in m0}
        for k in ("strip_chunk_states", "repack_lanes",
                  "bswap_transpose", "select_walk"):
            check(launches[k] > 0, f"kernel {k} never launched in node 1 "
                  "during the traced upload")
        check(info["fileId"] == fid, "traced upload fileId != sha256")
        st, _, doc = _http(port[1], "GET", f"/manifest?fileId={fid}",
                           timeout=120)
        check([(x["offset"], x["length"], x["digest"])
               for x in json.loads(doc)["chunks"]] == table,
              "traced upload chunk table != numpy oracle")
        acked[fid] = body
        st, _, doc = _http(port[3], "GET", f"/trace?traceId={tid}",
                           timeout=120)
        check(st == 200, f"/trace on node 3 answered {st}")
        doc = json.loads(doc)
        spans = doc["spans"]
        names = {x["name"] for x in spans}
        nodes = {x["node"] for x in spans}
        need = {"http./upload", "upload.fragment", "rpc.store_chunks",
                "peer.store_chunks"}
        check(need <= names, f"stitched trace lacks {need - names}")
        check(len(nodes) >= 2, f"stitched trace spans nodes {nodes}")
        span_ids = {x["s"] for x in spans}
        roots = [x for x in spans if x["p"] not in span_ids]
        check([x["name"] for x in roots] == ["http./upload"]
              and roots[0]["p"] == sid,
              f"stitched trace: spans without their parent {roots[:3]}")
        frag = [x for x in spans if x["name"] == "upload.fragment"]
        windows = launches["strip_chunk_states"]
        out["a"] = {"upload_s": times["a_upload_s"], "bytes": len(body),
                    "oracle_equal": True, "spans": len(spans),
                    "span_nodes": sorted(nodes),
                    "peers_failed": doc["peersFailed"],
                    "names": sorted(names), "launches": launches,
                    "upload_fragment_s": [x["d"] for x in frag],
                    "windows": windows,
                    "chain_stages_whole_chain_ms": chain_ms,
                    "chain_ms_x_windows": chain_ms * windows}
        emit({"phase": "cluster_chaos:a", **out["a"]})

        # (b) node 1 cut from node 2: ten uploads ack by handoff, the
        # journal holds the trace-stamped faults; healed and repaired,
        # node 3 reads every one back
        t0 = time.perf_counter()
        _chaos(port[1], {"partition": "2"})
        part = []
        for k in range(CHAOS_PARTITION_UPLOADS):
            b = small()
            inf = _upload(port[1], b, f"part{k}.bin")
            check(inf["handoffChunks"] > 0 and inf["minCopies"] >= 2,
                  f"partitioned upload {k}: {inf}")
            acked[inf["fileId"]] = b
            part.append(inf["fileId"])
        evs = _events(port[1])
        cut = [e for e in evs if e["type"] == "chaos_inject"
               and e.get("kind") == "partition"]
        # every upload is its own trace; the health probe loop's faults
        # carry none
        traced = {e["trace"] for e in cut if e.get("trace")}
        check(len(traced) >= CHAOS_PARTITION_UPLOADS,
              f"node 1 journaled partition faults of {len(traced)} traces "
              f"for {CHAOS_PARTITION_UPLOADS} uploads")
        # node 1's doctor while the link is cut: node 2 does not answer
        doc, rules = _doctor_rules(port[1])
        saw_dead = any(r == "dead_peer" and 2 in peers
                       for r, peers in rules) or doc["peersFailed"] >= 1
        check(saw_dead, f"node 1's doctor does not see node 2 cut: {rules}")
        _chaos(port[1], {"partition": ""})
        st, _, rep = _http(port[1], "POST", "/repair", body=b"",
                           timeout=600)
        check(st == 200, f"/repair answered {st}")
        for f in part:
            st, _, got = _http(port[3], "GET", f"/download?fileId={f}")
            check(st == 200 and got == acked[f],
                  f"partitioned upload {f[:12]} not identical on node 3")
        census_b = _census_clean(port, 1, "after the partition heals",
                                 require_no_orphans=True)
        times["b_s"] = time.perf_counter() - t0
        out["b"] = {"uploads": len(part), "partition_faults": len(cut),
                    "traced_faults": sum(1 for e in cut if e.get("trace")),
                    "fault_traces": len(traced),
                    "repair": json.loads(rep), "seconds": times["b_s"],
                    "doctor_saw_dead_link": saw_dead,
                    "doctor_peers_failed": doc["peersFailed"],
                    "doctor_rules": rules, "census": census_b}
        emit({"phase": "cluster_chaos:b", **out["b"]})

        # (c) node 2's disk full: 507 and disk_pressure there, reads of
        # (a) still served by it, uploads at node 1 still ack
        t0 = time.perf_counter()
        _chaos(port[2], {"disk_full": True})
        full_st, _, msg = _http(port[2], "POST", "/upload?name=full.bin",
                                body=small())
        check(full_st == 507, f"upload to a full node answered {full_st}: "
              f"{msg[:200]}")
        # the journal's writer thread lands the event a moment later
        t1 = time.perf_counter()
        while not any(e["type"] == "disk_pressure"
                      for e in _events(port[2])):
            check(time.perf_counter() - t1 < 10.0,
                  "node 2 journaled no disk_pressure")
            time.sleep(0.25)
        t1 = time.perf_counter()
        st, _, got = _http(port[2], "GET", f"/download?fileId={fid}")
        read_s = time.perf_counter() - t1
        check(st == 200 and got == body,
              "the full node's download not identical")
        del got
        b = small()
        inf = _upload(port[1], b, "beside-full.bin")
        acked[inf["fileId"]] = b
        _chaos(port[2], {"disk_full": False})
        census_c = _census_clean(port, 1, "after the disk frees",
                                 require_no_orphans=True)
        times["c_s"] = time.perf_counter() - t0
        out["c"] = {"status": full_st, "full_node_read_s": read_s,
                    "node1_upload_min_copies": inf["minCopies"],
                    "seconds": times["c_s"], "census": census_c}
        emit({"phase": "cluster_chaos:c", **out["c"]})

        # (e) node 4 restarted armed at each upload-path crash point:
        # each upload dies with its process, by SIGKILL, unacked
        crashes = {}
        for point in sorted(p for p in CRASH_POINTS
                            if p.startswith(("place.", "upload."))):
            per_node[4] = ("--chaos-crash-point", point)
            restart_s = c.restart(4)
            acked_now = False
            try:
                st, _, _ = _http(port[4], "POST", "/upload?name=doomed.bin",
                                 body=small(), timeout=120)
                acked_now = st == 201
            except OSError:
                pass                     # the connection died with it
            rc = procs[4].wait(timeout=60)
            check(rc == -signal.SIGKILL and not acked_now,
                  f"{point}: exit {rc}, acked {acked_now}")
            crashes[point] = {"restart_s": restart_s, "rc": rc}
        per_node.pop(4)
        t_clean = time.time()
        restart_s = c.restart(4)
        t1 = time.perf_counter()
        for f, b in acked.items():
            st, _, got = _http(port[4], "GET", f"/download?fileId={f}")
            check(st == 200 and got == b,
                  f"acked {f[:12]} not identical on the restarted node 4")
        read_back_s = time.perf_counter() - t1
        sweep = [e for e in _events(port[4], since=t_clean - 1.0)
                 if e["type"] == "boot_sweep"]
        check(sweep, "the clean restart journaled no boot_sweep")
        # no manifest on node 4 names a chunk held by fewer than the
        # write quorum's 2 nodes
        held = {}
        for i in ids:
            cdir = d / "data" / f"node-{i}" / "chunks"
            for sub in cdir.iterdir() if cdir.is_dir() else ():
                if sub.is_dir() and len(sub.name) == 2:
                    for fp in sub.iterdir():
                        held[fp.name] = held.get(fp.name, 0) + 1
        manifests = 0
        for mp in (d / "data" / "node-4" / "manifests").glob("*.json"):
            man = Manifest.from_json(mp.read_text())
            manifests += 1
            thin = [x for x in man.all_digests() if held.get(x, 0) < 2]
            check(not thin, f"manifest {man.file_id[:12]} on node 4 names "
                  f"{len(thin)} chunk(s) held by fewer than 2 nodes")
        # crash-aborted uploads may leave orphans: reported, not gated
        census_e = _census_clean(port, 1, "after the crash restarts",
                                 require_no_orphans=False)
        out["e"] = {"census": census_e,
                    "crashes": crashes, "clean_restart_s": restart_s,
                    "acked_files": len(acked),
                    "read_back_s": read_back_s,
                    "boot_sweep": {k: sweep[-1].get(k)
                                   for k in ("tmps", "orphans")},
                    "manifests_checked": manifests}
        emit({"phase": "cluster_chaos:e", **out["e"]})
        out["events_node1"] = len(_events(port[1]))
    out["seconds"] = time.perf_counter() - t_phase
    out["within_bound"] = out["seconds"] <= CHAOS_PHASE_BOUND_S
    out["launches"] = launches
    out["zero_acked_loss"] = True
    emit({k: v for k, v in out.items()
          if k not in ("a", "b", "c", "d", "e")})
    return launches


class _OpenLoopLoad:
    """bench_chaos.py's open-loop upload load: one ``RING_PAYLOAD``-byte
    body every 1/``RING_RATE`` s round-robin on ``nodes``, issued on
    schedule whatever the answers (a pool of senders); every 201 is
    checked (fileId == sha256) and kept as acked."""

    def __init__(self, port: dict, nodes: list, np) -> None:
        self.port, self.nodes, self.np = port, nodes, np
        self.rng = np.random.default_rng(RING_SEED + 1)
        self.acked: dict[str, bytes] = {}
        self.failed: dict = {}
        self.sent = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._senders: list[threading.Thread] = []

    def _one(self, k: int, body: bytes) -> None:
        nid = self.nodes[k % len(self.nodes)]
        try:
            st, _, out = _http(self.port[nid], "POST",
                               f"/upload?name=load{k}.bin", body=body,
                               timeout=120)
        except OSError as e:
            st, out = type(e).__name__, b""
        with self._lock:
            if st == 201:
                fid = json.loads(out)["fileId"]
                self.acked[fid] = body
                if fid != hashlib.sha256(body).hexdigest():
                    self.failed["ack_hash_mismatch"] = \
                        self.failed.get("ack_hash_mismatch", 0) + 1
            else:
                self.failed[str(st)] = self.failed.get(str(st), 0) + 1

    def _run(self) -> None:
        t0 = time.perf_counter()
        k = 0
        while not self._stop.is_set():
            wait = t0 + k / RING_RATE - time.perf_counter()
            if wait > 0 and self._stop.wait(wait):
                break
            body = self.rng.integers(0, 256, size=RING_PAYLOAD,
                                     dtype=self.np.uint8).tobytes()
            t = threading.Thread(target=self._one, args=(k, body),
                                 daemon=True)
            t.start()
            self._senders.append(t)
            k += 1
        self.sent = k

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join()
        for t in self._senders:
            t.join(timeout=180)
        with self._lock:
            return {"sent": self.sent, "acked": len(self.acked),
                    "failed": dict(self.failed)}


def _catalog(port: int) -> dict:
    """digest -> length over every manifest the node holds."""
    out: dict = {}
    for f in _get_json(port, "/files"):
        st, _, doc = _http(port, "GET", f"/manifest?fileId={f['fileId']}",
                           timeout=120)
        if st == 200:
            for c in json.loads(doc)["chunks"]:
                out.setdefault(c["digest"], c["length"])
    return out


def _ring_view(port: int):
    from dfs_tpu_torch.ring import RingMap

    st = _get_json(port, "/ring?cluster=0")
    return RingMap.from_dict({"epoch": st["epoch"], "vnodes": st["vnodes"],
                              "members": st["members"]}), st


def _rebalance(port: dict) -> dict:
    return {i: _metrics(port[i])["ring"]["rebalance"] for i in port}


def _wait_ring(port: dict, epoch: int, settled: bool) -> float:
    """Seconds until every node holds ``epoch`` with one fingerprint (and,
    with ``settled``, has closed its migration window); fails past
    ``RING_CONVERGE_S``."""
    t0 = time.perf_counter()
    while True:
        views = {}
        for i in port:
            try:
                views[i] = _ring_view(port[i])
            except (OSError, SystemExit):
                views[i] = None      # not answering yet: asked again
        fps = {v[0].fingerprint for v in views.values() if v is not None}
        ok = (all(v is not None and v[0].epoch == epoch
                  for v in views.values()) and len(fps) == 1
              and (not settled
                   or not any(v[1]["migrating"] for v in views.values())))
        if ok:
            return time.perf_counter() - t0
        check(time.perf_counter() - t0 < RING_CONVERGE_S,
              f"ring did not converge on epoch {epoch}: " + str(
                  {i: None if v is None else (v[0].epoch, v[0].fingerprint,
                                              v[1]["migrating"])
                   for i, v in views.items()}))
        time.sleep(0.5)


def _min_movement(catalog: dict, old, new, rf: int = 2) -> int:
    """bench_rebalance.py's theoretical minimum: every byte of every copy
    at a new owner that was not at an old one."""
    return sum(ln * len(set(new.owners(d, rf)) - set(old.owners(d, rf)))
               for d, ln in catalog.items())


def cluster_ring_phase(root: Path, np, params) -> dict:
    """The ``cluster_ring`` phase (module docstring): steps (a)-(e) on 4
    ``serve`` processes, ring members 1-3 and node 4 a standby. Returns
    node 1's kernel launches across the seed upload of step (a)."""
    from dfs_tpu_torch.ops import cdc_anchored as A

    body_np = np.random.default_rng(RING_SEED).integers(
        0, 256, size=RING_BYTES, dtype=np.uint8)
    table = A.chunk_file_anchored_np(body_np, params)
    body = body_np.tobytes()
    del body_np
    fid = hashlib.sha256(body).hexdigest()
    blocks = [body[i:i + BLOCK_BYTES] for i in range(0, len(body),
                                                      BLOCK_BYTES)]
    out: dict = {"phase": "cluster_ring", "nodes": RING_NODES,
                 "flags": list(RING_FLAGS), "bytes": RING_BYTES}
    os.sync()           # the earlier phases' writeback is not this phase's
    t_phase = time.perf_counter()
    with serve_cluster(root, ".chip_smoke_ring_", RING_FLAGS,
                       nodes=RING_NODES) as c:
        port, procs = c.port, c.procs
        out["start_s"] = c.start_s

        # (a) seed: the 32 MiB body to node 1, chunked on the card
        m0 = _metrics(port[1])["frag"]["launches"]
        t0 = time.perf_counter()
        info = _upload(port[1], iter(blocks), "ring-seed.bin", chunked=True)
        seed_s = time.perf_counter() - t0
        m1 = _metrics(port[1])["frag"]["launches"]
        launches = {k: m1[k] - m0[k] for k in m0}
        for k in ("strip_chunk_states", "repack_lanes", "bswap_transpose",
                  "select_walk"):
            check(launches[k] > 0, f"kernel {k} never launched in node 1 "
                  "during the ring seed upload")
        check(info["fileId"] == fid, "ring seed fileId != sha256")
        doc = _get_json(port[1], f"/manifest?fileId={fid}")
        check([(x["offset"], x["length"], x["digest"])
               for x in doc["chunks"]] == table,
              "ring seed chunk table != numpy oracle")
        ring0, _ = _ring_view(port[1])
        check(ring0.active_ids() == [1, 2, 3] and ring0.vnodes == 64,
              f"epoch 0 ring {ring0.to_dict()}")
        to_move = _min_movement(_catalog(port[1]), ring0,
                                ring0.hashed({1: 1.0, 2: 1.0, 3: 1.0,
                                              4: 1.0}, 1, 64))
        out["a"] = {"upload_s": seed_s, "oracle_equal": True,
                    "launches": launches, "chunks": len(table),
                    "bytes_to_move_on_add": to_move}
        emit({"phase": "cluster_ring:a", **out["a"]})

        # (b) node 4 added under load without a weight, SIGKILLed 0.25 s
        # later; the body read from node 2 while the window is open; one
        # traced upload through the fault
        load = _OpenLoopLoad(port, [1, 2, 3], np)
        load.start()
        # bench_chaos.py warms the cluster with the load before the add:
        # every node has chunked on its card before the membership moves
        time.sleep(RING_WARM_S)
        t_add = time.perf_counter()
        st, _, add = _http(port[1], "POST", "/ring", body=json.dumps(
            {"action": "add", "nodeId": 4}).encode(), timeout=120)
        add_post_s = time.perf_counter() - t_add
        check(st == 200, f"POST /ring add answered {st}: {add[:200]}")
        add = json.loads(add)
        weight = {m["nodeId"]: m["weight"]
                  for m in add["ring"]["members"]}[4]
        check(0.25 <= weight <= 4.0 and add["epoch"] == 1,
              f"ring add: epoch {add['epoch']}, derived weight {weight}")
        # as bench_chaos.py: the kill comes 0.25 s after the add answers
        time.sleep(RING_KILL_DELAY_S)
        procs[4].send_signal(signal.SIGKILL)
        kill_after_add_s = time.perf_counter() - t_add
        rc4 = procs[4].wait(timeout=60)
        check(rc4 == -signal.SIGKILL, f"node 4 exit {rc4}")
        moved_at_kill = _metrics(port[1])["ring"]["rebalance"]
        peer_admin = {}
        for i in (2, 3):
            lat = _metrics(port[i])["latency"]
            peer_admin[i] = {k: lat.get(k) for k in (
                "peer.get_census", "peer.propose_ring", "peer.has_chunks",
                "peer.store_chunks")}
        views = {i: _ring_view(port[i])[1] for i in (1, 2, 3)}
        check(all(v["epoch"] == 1 and v["migrating"]
                  for v in views.values()),
              f"the window is not open on nodes 1-3: {views}")
        t0 = time.perf_counter()
        st, _, got = _http(port[2], "GET", f"/download?fileId={fid}")
        window_read_s = time.perf_counter() - t0
        check(st == 200 and got == body,
              "the body read from node 2 mid-window is not identical")
        del got
        check(_ring_view(port[2])[1]["migrating"],
              "the window closed before the mid-window read ended")
        tid, _, hdr = _trace_header()
        traced_body = hashlib.sha256(tid.encode()).digest() * 1500
        traced = _upload(port[1], traced_body, "ring-traced.bin",
                         headers=hdr)
        # stitched at once: hundreds of uploads later its spans are gone
        # from the rings
        spans = _get_json(port[1], f"/trace?traceId={tid}")["spans"]
        span_nodes = {x["node"] for x in spans}
        check(len(span_nodes) >= 2 and "http./upload"
              in {x["name"] for x in spans},
              f"the traced upload stitched nodes {span_nodes}")
        m1 = _metrics(port[1])
        admin_rpc = {k: v for k, v in m1["rpcClient"].items()
                     if k.endswith((":get_census", ":propose_ring"))}
        dual = {i: r["dualReadHits"] for i, r in _rebalance(
            {i: port[i] for i in (1, 2, 3)}).items()}
        out["b"] = {"derived_weight": weight, "epoch": add["epoch"],
                    "pushed": add["pushed"], "add_post_s": add_post_s,
                    "http_ring_latency": m1["latency"].get("http./ring"),
                    "admin_rpc": admin_rpc, "peer_latency": peer_admin,
                    "trace_nodes": sorted(span_nodes),
                    "trace_spans": len(spans), "kill_rc": rc4,
                    "kill_after_add_s": kill_after_add_s,
                    "window_read_s": window_read_s,
                    "window_read_identical": True,
                    "dual_read_hits": dual,
                    "node1_bytes_moved_at_kill":
                        moved_at_kill["bytesMoved"],
                    "traced_upload_copies": traced["minCopies"]}
        emit({"phase": "cluster_ring:b", **out["b"]})

        # (c) node 4 restarted: it resumes the epoch and the open window
        # from ring.json, and the cluster converges on the add's epoch
        restart_s = c.restart(4)
        resumed, _ = _ring_view(port[4])
        check(resumed.epoch == 1, f"node 4 resumed epoch {resumed.epoch}")
        epoch_s = _wait_ring(port, 1, settled=False)
        settle_s = _wait_ring(port, 1, settled=True)
        out["c"] = {"restart_s": restart_s, "resumed_epoch": resumed.epoch,
                    "one_fingerprint_s": epoch_s,
                    "migration_done_s": epoch_s + settle_s,
                    "add_to_done_s": time.perf_counter() - t_add}
        emit({"phase": "cluster_ring:c", **out["c"]})

        # (d) drain node 4 under the same load; bench_rebalance.py's gates
        # on the drain's movement and per-node rate
        pre_cat = _catalog(port[1])
        ring1, _ = _ring_view(port[1])
        pre = _rebalance(port)
        walks0 = {i: _metrics(port[i]).get("repairs", 0) for i in port}
        t0 = time.perf_counter()
        st, _, drain = _http(port[1], "POST", "/ring", body=json.dumps(
            {"action": "drain", "nodeId": 4}).encode(), timeout=120)
        check(st == 200, f"POST /ring drain answered {st}: {drain[:200]}")
        drain = json.loads(drain)
        _wait_ring(port, 2, settled=True)
        drain_s = time.perf_counter() - t0
        loaded = load.stop()
        post = _rebalance(port)
        walks = {i: _metrics(port[i]).get("repairs", 0) - walks0[i]
                 for i in port}
        post_cat = _catalog(port[1])
        ring2, _ = _ring_view(port[1])
        per_node = {i: {k: post[i][k] - pre[i][k]
                        for k in ("bytesMoved", "pushes", "creditStallS",
                                  "dualReadHits")} for i in port}
        moved = sum(v["bytesMoved"] for v in per_node.values())
        min_bytes = _min_movement(pre_cat, ring1, ring2)
        new_bytes = sum(ln for d, ln in post_cat.items()
                        if d not in pre_cat)
        bound = 1.5 * min_bytes + 2 * new_bytes
        rates = {i: v["bytesMoved"] / max(drain_s, 1e-6)
                 for i, v in per_node.items()}
        bw_ok = {i: per_node[i]["bytesMoved"] <= RING_CREDIT
                 or rates[i] <= RING_CREDIT * 1.35 for i in port}
        check(min_bytes > 0 and moved <= bound,
              f"drain moved {moved} B > 1.5 x {min_bytes} + 2 x "
              f"{new_bytes}")
        check(all(bw_ok.values()),
              f"drain rate above the credit x 1.35: {rates}")
        out["d"] = {"epoch": drain["epoch"], "seconds": drain_s,
                    "moved_bytes": moved, "min_bytes": min_bytes,
                    "concurrent_new_bytes": new_bytes,
                    "moved_bound": bound, "moved_within_bound": True,
                    "rate_bytes_s": rates, "credit": RING_CREDIT,
                    "bandwidth_ok": True, "per_node": per_node,
                    "repair_walks": walks,
                    "load": loaded}
        emit({"phase": "cluster_ring:d", **out["d"]})

        # (e) the census clean, node 4 empty, everything acked identical
        # from nodes 1-3, the traced upload stitched, the doctor quiet on
        # the ring
        check(loaded["failed"].get("ack_hash_mismatch", 0) == 0,
              "an upload acked with a fileId != sha256")
        census = _census_clean(port, 1, "after the drain",
                               require_no_orphans=False)
        rep = _get_json(port[1], "/census")
        cas4 = rep["capacity"]["nodes"]["4"]["casChunks"]
        check(cas4 == 0, f"node 4 still holds {cas4} chunk(s)")
        acked = dict(load.acked)
        acked[fid] = body
        acked[traced["fileId"]] = traced_body
        t0 = time.perf_counter()

        def read_back(item) -> str | None:
            f, b, i = item
            st, _, got = _http(port[i], "GET", f"/download?fileId={f}")
            return None if st == 200 and got == b else \
                f"acked {f[:12]} not identical on node {i} ({st})"

        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            bad = [e for e in pool.map(read_back, [
                (f, b, i) for f, b in acked.items() for i in (1, 2, 3)])
                if e is not None]
        check(not bad, f"{len(bad)} read(s) not identical: {bad[:3]}")
        read_s = time.perf_counter() - t0
        doc, rules = _doctor_rules(port[1])
        bad = [r for r in rules if r[0] in ("epoch_mismatch",
                                            "rebalance_stuck")]
        check(not bad, f"the doctor names {bad}")
        final = _rebalance(port)
        out["e"] = {"census": census, "node4_cas_chunks": cas4,
                    "acked_files": len(acked), "read_back_s": read_s,
                    "zero_acked_loss": True,
                    "trace_nodes": sorted(span_nodes),
                    "doctor_rules": rules,
                    "rebalance": {i: {k: r[k] for k in (
                        "bytesMoved", "pushes", "creditStallS",
                        "dualReadHits", "lastSeconds", "lastBytesMoved")}
                        for i, r in final.items()}}
        emit({"phase": "cluster_ring:e", **out["e"]})
    out["seconds"] = time.perf_counter() - t_phase
    out["within_bound"] = out["seconds"] <= RING_PHASE_BOUND_S
    check(out["within_bound"], f"cluster_ring took {out['seconds']:.1f} s "
          f"(bound {RING_PHASE_BOUND_S} s)")
    out["launches"] = launches
    emit({k: v for k, v in out.items()
          if k not in ("a", "b", "c", "d", "e")})
    return launches


def _randbytes(n_files: int, file_bytes: int, seed: int) -> list:
    """bench_client.py's corpora: ``random.Random(seed).randbytes``."""
    rng = random.Random(seed)
    return [rng.randbytes(file_bytes) for _ in range(n_files)]


def _cli(root: Path, cwd: str, port: int, *argv: str) -> tuple[str, float]:
    """One ``python -m dfs_tpu_torch.cli.main`` run against ``port``, as a
    user runs it: (stdout, seconds). A non-zero exit fails the run."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "dfs_tpu_torch.cli.main", "--port",
         str(port), "--timeout", "300", *argv], cwd=cwd,
        env=dict(os.environ, PYTHONPATH=str(root)), capture_output=True,
        text=True, timeout=300)
    check(r.returncode == 0, f"cli {argv} exited {r.returncode}: "
          f"{r.stderr[-800:]}")
    return r.stdout, time.perf_counter() - t0


def cluster_client_phase(root: Path, np, params, kernels) -> dict:
    """The ``cluster_client`` phase (module docstring): bench_client.py's
    four gates with the port's SmartClient in this process, then the
    resumed upload and the ``--smart`` commands through the CLI and a
    refused commit. Returns this process's kernel launches from step (a)
    to the end of step (d)."""
    from dfs_tpu_torch.cli.client import NodeClient
    from dfs_tpu_torch.client import SmartClient
    from dfs_tpu_torch.config import ClientConfig
    from dfs_tpu_torch.ops import cdc_anchored as A

    t_phase = time.perf_counter()
    out: dict = {"phase": "cluster_client", "nodes": CLIENT_NODES,
                 "flags": list(CLIENT_FLAGS)}

    def smart(port: int, **kw) -> SmartClient:
        kw.setdefault("fallback", False)
        return SmartClient(port=port, cfg=ClientConfig(**kw),
                           timeout_s=300.0)

    def table_of(port: int, fid: str) -> list:
        doc = _get_json(port, f"/manifest?fileId={fid}")
        return [(c["offset"], c["length"], c["digest"])
                for c in doc["chunks"]]

    with serve_cluster(root, ".chip_smoke_client_", CLIENT_FLAGS,
                       nodes=CLIENT_NODES) as cl:
        port = cl.port
        legacy = {i: NodeClient(port=p, timeout_s=300.0)
                  for i, p in port.items()}
        out["start_s"] = cl.start_s

        # (a) dedup_reupload: 8 x 4 MiB up through node 1, the filters
        # synced, one contiguous 1% region xor-mutated, everything again
        # through a fresh client at node 2
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        corpus = _randbytes(8, CLIENT_FILE_BYTES, 19)
        total = sum(len(b) for b in corpus)
        c1 = smart(port[1])
        for i, data in enumerate(corpus):
            info = c1.upload(data, name=f"base{i}.bin")
            check(info["dataPlane"] == "smart", f"(a) upload {i}: {info}")
            if i < 2:
                check(table_of(port[1], info["fileId"])
                      == A.chunk_file_anchored_np(
                          np.frombuffer(data, np.uint8), params),
                      f"(a) upload {i}: table != numpy oracle")
        up1_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        while not _peers_synced(port)[0]:
            check(time.perf_counter() - t1 < 30, "(a) filters never synced")
            time.sleep(0.3)
        sync_s = time.perf_counter() - t1
        region = total // 100
        mid = len(corpus) // 2
        mut = bytearray(corpus[mid])
        start = len(mut) // 3
        for i in range(start, min(len(mut), start + region)):
            mut[i] ^= 0xA5
        corpus[mid] = bytes(mut)
        t1 = time.perf_counter()
        c2 = smart(port[2])
        for i, data in enumerate(corpus):
            info = c2.upload(data, name=f"re{i}.bin")
            check(info["dataPlane"] == "smart", f"(a) re-upload {i}: {info}")
        up2_s = time.perf_counter() - t1
        sent = c2.counters["transferredBytes"]
        ratio = sent / (2 * total)
        same = legacy[3].download(hashlib.sha256(corpus[mid]).hexdigest()) \
            == corpus[mid]
        out["a"] = {"corpus_bytes": total, "mutated_bytes": region,
                    "payload_sent": sent, "sent_ratio": ratio,
                    "budget_ratio": 0.03, "legacy_identical": same,
                    "verify_rpcs": c2.counters["verifyRpcs"],
                    "probe_rpcs": c2.counters["probeRpcs"],
                    "dedup_skipped_bytes": c2.counters["dedupSkippedBytes"],
                    "upload_s": up1_s, "filter_sync_s": sync_s,
                    "reupload_s": up2_s,
                    "seconds": time.perf_counter() - t0}
        emit({"phase": "cluster_client:a", **out["a"]})
        check(ratio <= 0.03, f"(a) re-upload sent {ratio:.4f} of the "
              "replicated corpus (> 0.03)")
        check(same, "(a) the mutated file differs through node 3")

        # (b) striped_speedup: 0.1 s on every storage-plane RPC of every
        # node; the files read through node 1's relay, then striped
        t0 = time.perf_counter()
        files = _randbytes(6, CLIENT_STRIPED_BYTES, 47)
        cs = smart(port[1])
        fids = [cs.upload(d, name=f"s{i}.bin")["fileId"]
                for i, d in enumerate(files)]
        for p in port.values():
            _chaos(p, {"rpc_delay_s": 0.1})
        try:
            t1 = time.perf_counter()
            for fid, want in zip(fids, files):
                check(legacy[1].download(fid) == want,
                      "(b) relay download differs")
            t_legacy = time.perf_counter() - t1
            reader = smart(port[1])
            t1 = time.perf_counter()
            for fid, want in zip(fids, files):
                check(reader.download(fid) == want,
                      "(b) striped download differs")
            t_smart = time.perf_counter() - t1
        finally:
            for p in port.values():
                _chaos(p, {"rpc_delay_s": 0.0})
        speedup = t_legacy / max(t_smart, 1e-9)
        out["b"] = {"files": len(files), "file_bytes": CLIENT_STRIPED_BYTES,
                    "legacy_s": t_legacy, "striped_s": t_smart,
                    "speedup": speedup, "floor": 2.0,
                    "smart_downloads": reader.counters["smartDownloads"],
                    "seconds": time.perf_counter() - t0}
        emit({"phase": "cluster_client:b", **out["b"]})
        check(reader.counters["smartDownloads"] == len(files),
              "(b) a striped read fell back")
        check(speedup >= 2.0, f"(b) striped speedup {speedup:.2f} < 2.0")

        # (c) verified_stale_and_slow: client hedging on, one peer's filter
        # replica all ones at the client, node 3 serving 0.25 s late
        t0 = time.perf_counter()
        data_c = _randbytes(1, 8 * 1024 * 1024, 83)[0]
        cc = smart(port[1], hedge_budget_per_s=20.0, hedge_floor_s=0.05,
                   hedge_cap_s=0.5)
        cc.upload(_randbytes(1, 64 * 1024, 5)[0], name="warm.bin")
        check(bool(cc._filters), "(c) the client fetched no filters")
        victim = sorted(cc._filters)[0]
        buf = cc._filters[victim]["bloom"].buf
        buf[:] = b"\xff" * len(buf)
        _chaos(port[CLIENT_NODES], {"serve_delay_s": 0.25})
        try:
            info = cc.upload(data_c, name="fresh.bin")
            check(info["dataPlane"] == "smart", f"(c) upload: {info}")
            got = cc.download(info["fileId"])
        finally:
            _chaos(port[CLIENT_NODES], {"serve_delay_s": 0.0})
        fid_c = info["fileId"]
        every = all(legacy[i].download(fid_c) == data_c for i in port)
        out["c"] = {"chunks": info["chunks"], "victim": victim,
                    "identical_smart": got == data_c,
                    "identical_every_node": every,
                    "chunks_verified": cc.counters["chunksVerified"],
                    "filter_fp": cc.counters["filterFp"],
                    "healed_chunks": cc.counters["healedChunks"],
                    "hedge": cc._hedge.stats(),
                    "seconds": time.perf_counter() - t0}
        emit({"phase": "cluster_client:c", **out["c"]})
        check(got == data_c and every, "(c) bytes differ")
        check(cc.counters["chunksVerified"] >= info["chunks"],
              "(c) not every chunk verified at the client")
        check(cc.counters["filterFp"] > 0, "(c) the stale filter never hit")

        # (d) interop: the legacy client, a client pinned to the legacy
        # path, and the smart path reading what the legacy path wrote
        t0 = time.perf_counter()
        data_d = _randbytes(1, 300 * 1024, 7)[0]
        info = legacy[1].upload(data_d, "legacy.bin")
        legacy_ok = legacy[1].download(info["fileId"]) == data_d
        pinned = SmartClient(port=port[2], cfg=ClientConfig(),
                             timeout_s=300.0)
        pinned._boot = False
        info2 = pinned.upload(data_d, "pinned.bin")
        pinned_ok = info2["dataPlane"] == "legacy" \
            and info2["fileId"] == info["fileId"] \
            and pinned.download(info2["fileId"]) == data_d
        cross = smart(port[3]).download(info["fileId"]) == data_d
        launches = path_launches(kernels, "cluster_client",
                                 ("strip_chunk_states", "repack_lanes",
                                  "bswap_transpose", "select_walk"))
        out["d"] = {"legacy_ok": legacy_ok, "pinned_ok": pinned_ok,
                    "cross_read_ok": cross,
                    "seconds": time.perf_counter() - t0}
        emit({"phase": "cluster_client:d", **out["d"],
              "launches": launches})
        check(legacy_ok and pinned_ok and cross, f"(d) interop {out['d']}")

        # (e) the CLI: a resumed upload of (c)'s body with 8 MiB appended,
        # --smart up and down, then a commit naming a digest nobody holds
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix=".chip_smoke_cli_",
                                         dir=root) as wd:
            f = Path(wd) / "resume.bin"
            body_e = data_c + _randbytes(1, 8 * 1024 * 1024, 84)[0]
            f.write_bytes(body_e)
            g = Path(wd) / "smart.bin"
            body_g = _randbytes(1, 4 * 1024 * 1024, 85)[0]
            g.write_bytes(body_g)
            fid_g = hashlib.sha256(body_g).hexdigest()

            def smart_round_trip():
                up = _cli(root, wd, port[1], "upload", "--smart", str(g))
                return up, _cli(root, wd, port[3], "download", "--smart",
                                fid_g, "--out", "dl")

            # the resume at node 2 runs beside the --smart upload at node 1
            # and its --smart download at node 3 (two users; each process
            # mostly starts up)
            with concurrent.futures.ThreadPoolExecutor(2) as ex:
                resume = ex.submit(_cli, root, wd, port[2], "upload",
                                   "--resume", str(f))
                smart_rt = ex.submit(smart_round_trip)
                (text, resume_s) = resume.result()
                ((text_up, smart_up_s),
                 (text_down, smart_down_s)) = smart_rt.result()
            m = re.search(r"fileId=([0-9a-f]{64}) chunks=(\d+) "
                          r"clientSent=(\d+)B of (\d+)B", text)
            check(m is not None, f"(e) resume output: {text!r}")
            sent_e = int(m.group(3))
            check(m.group(1) == hashlib.sha256(body_e).hexdigest(),
                  "(e) resume fileId != sha256")
            check(sent_e <= 0.6 * len(body_e),
                  f"(e) resume sent {sent_e} of {len(body_e)} B")
            check(legacy[1].download(m.group(1)) == body_e,
                  "(e) resumed file differs")
            check(text_up.startswith("Uploaded (smart): "),
                  f"(e) --smart upload: {text_up!r}")
            check(text_down.startswith("dataPlane=smart"),
                  f"(e) --smart download: {text_down!r}")
            check((Path(wd) / "dl" / "smart.bin").read_bytes() == body_g,
                  "(e) --smart round trip differs")
        ghost = hashlib.sha256(b"held by nobody").hexdigest()
        fid_x = hashlib.sha256(b"ghost stream").hexdigest()
        meta = json.dumps({"fileId": fid_x, "size": 10,
                           "chunks": [[0, 10, ghost]]}).encode()
        st, _, text = _http(port[1], "POST", "/commit?name=ghost.bin",
                            body=len(meta).to_bytes(4, "big") + meta,
                            timeout=60)
        st_m = _http(port[1], "GET", f"/manifest?fileId={fid_x}",
                     timeout=60)[0]
        out["e"] = {"resume_bytes": len(body_e), "resume_client_sent": sent_e,
                    "resume_sent_ratio": sent_e / len(body_e),
                    "resume_s": resume_s, "smart_up_s": smart_up_s,
                    "smart_down_s": smart_down_s, "ghost_commit": st,
                    "ghost_manifest": st_m,
                    "seconds": time.perf_counter() - t0}
        emit({"phase": "cluster_client:e", **out["e"]})
        check(st == 409, f"(e) ghost commit answered {st}: {text[:200]}")
        check(st_m == 404, f"(e) ghost manifest answered {st_m}")
        counters = {i: {k: m_.get(k) for k in (
            "uploads_committed", "uploads_resumed", "probe_failures",
            "commit_probe_failures")} for i, m_ in
            ((i, _metrics(p)) for i, p in port.items())}
    out["node_counters"] = counters
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = launches
    emit({"phase": "cluster_client", "seconds": out["seconds"],
          "start_s": out["start_s"], "node_counters": counters,
          "launches": launches, "bound_s": CLIENT_PHASE_BOUND_S})
    check(out["seconds"] <= CLIENT_PHASE_BOUND_S,
          f"cluster_client took {out['seconds']:.1f} s "
          f"(bound {CLIENT_PHASE_BOUND_S} s)")
    return launches


def cluster_sidecar_phase(root: Path, body: bytes, oracle: list,
                          ec_body: bytes, ec_table: list, params,
                          fragment_gib_s: float, np, kernels) -> dict:
    """The ``cluster_sidecar`` phase (module docstring). Returns this
    process's kernel launches over steps (a) and (b)."""
    from dfs_tpu_torch.native import build_sidecar_client
    from dfs_tpu_torch.ops import cdc_anchored as A
    from dfs_tpu_torch.ops.cdc_v2 import file_id_from_digests
    from dfs_tpu_torch.sidecar import SidecarClient, SidecarServer

    t_phase = time.perf_counter()
    needed = ("strip_chunk_states", "repack_lanes", "bswap_transpose",
              "select_walk")
    ec_fid = file_id_from_digests([d for _, _, d in ec_table])
    env = dict(os.environ, PYTHONPATH=str(root))
    procs: dict[str, subprocess.Popen] = {}

    def rows(chunks) -> list:
        return [(c["offset"], c["length"], c["digest"]) for c in chunks]

    def cpp(*argv: str) -> tuple[list, float]:
        t0 = time.perf_counter()
        r = subprocess.run([str(binary), "127.0.0.1", str(srv.port), *argv],
                           capture_output=True, timeout=300)
        check(r.returncode == 0, f"sidecar_client {argv[1:]} exited "
              f"{r.returncode}: {r.stderr[-500:]!r}")
        return ([json.loads(ln) for ln in r.stdout.splitlines()
                 if ln.strip()], time.perf_counter() - t0)

    srv = SidecarServer(port=0, fragmenter="auto")
    srv.start()
    ports = _free_ports(3)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_sidecar_",
                                     dir=root) as wd:
        wd = Path(wd)
        logs = {k: open(wd / f"{k}.log", "wb") for k in ("serve", "cli")}
        try:
            # (b)'s node and (c)'s sidecar start now: their start-up
            # overlaps (a)
            t_start = time.perf_counter()
            procs["serve"] = subprocess.Popen(
                [sys.executable, "-m", "dfs_tpu_torch.cli.main", "serve",
                 "--node-id", "1", "--nodes", "1", "--replication-factor",
                 "1", "--write-quorum", "1", "--base-port", str(ports[0]),
                 "--base-internal-port", str(ports[1]), "--data-root",
                 str(wd / "data"), "--repair-interval", "0",
                 "--sidecar-port", str(srv.port)], cwd=root, env=env,
                stdout=logs["serve"], stderr=subprocess.STDOUT)
            procs["cli"] = subprocess.Popen(
                [sys.executable, "-m", "dfs_tpu_torch.cli.main", "sidecar",
                 "--sidecar-port", str(ports[2])], cwd=root, env=env,
                stdout=subprocess.PIPE, stderr=logs["cli"], text=True)
            cli_up: dict = {}

            def read_listening() -> None:
                cli_up["line"] = procs["cli"].stdout.readline()
                cli_up["s"] = time.perf_counter() - t_start

            reader = threading.Thread(target=read_listening, daemon=True)
            reader.start()

            # (a) the port's client on the EC body, then the C++ client
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            binary = build_sidecar_client()
            build_s = time.perf_counter() - t0
            c = SidecarClient(srv.port)
            health = c.health()
            check(health["fragmenter"] == "cdc-anchored-cuda"
                  and health["window"] == srv.fragmenter.stream_span(),
                  f"(a) Health {health}")
            ec_blocks = [ec_body[i:i + 4 * BLOCK_BYTES]
                         for i in range(0, len(ec_body), 4 * BLOCK_BYTES)]
            client_s = {}
            t0 = time.perf_counter()
            unary = c.chunk_hash(ec_body)
            client_s["ChunkHash"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            stream = c.chunk_hash_stream(iter(ec_blocks))
            client_s["ChunkHashStream"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            duplex = list(c.chunk_hash_duplex(iter(ec_blocks)))
            client_s["ChunkHashDuplex"] = time.perf_counter() - t0
            for what, table, fid in (
                    ("ChunkHash", unary["chunks"], unary["fileId"]),
                    ("ChunkHashStream", stream["chunks"], stream["fileId"]),
                    ("ChunkHashDuplex",
                     [x for m in duplex[:-1] for x in m["chunks"]],
                     duplex[-1]["fileId"])):
                check(rows(table) == ec_table and fid == ec_fid,
                      f"(a) SidecarClient {what}: table != oracle")
            body_f, ec_f = wd / "body.bin", wd / "ec.bin"
            body_f.write_bytes(body)
            ec_f.write_bytes(ec_body)
            (table,), stream_s = cpp(str(body_f), "ChunkHashStream")
            check(rows(table["chunks"]) == oracle
                  and table["size"] == len(body),
                  "(a) C++ ChunkHashStream of the body: table != oracle")
            (h,), _ = cpp(str(ec_f), "Health")
            check(h == health, f"(a) C++ Health {h}")
            (table,), _ = cpp(str(ec_f), "ChunkHash")
            check(rows(table["chunks"]) == ec_table
                  and table["fileId"] == ec_fid,
                  "(a) C++ ChunkHash: table != oracle")
            lines, duplex_s = cpp(str(ec_f), "ChunkHashDuplex")
            check(rows(x for ln in lines[:-1] for x in ln["chunks"])
                  == ec_table and lines[-1]["done"]
                  and lines[-1]["fileId"] == ec_fid,
                  "(a) C++ ChunkHashDuplex: table != oracle")
            # a duplex left after its first batch (the body repeated
            # without end: the walk is mid-stream), then one more call
            def endless():
                while True:
                    yield from ec_blocks

            replies = c.chunk_hash_duplex(endless())
            check(bool(next(replies)["chunks"]), "(a) no first batch")
            replies.close()
            t0 = time.perf_counter()
            while srv.buffered() and time.perf_counter() - t0 < 30:
                time.sleep(0.05)
            check(srv.buffered() == [], "(a) the cancelled call stayed open")
            after = c.chunk_hash(ec_body[:3 * 1024 * 1024])
            check(rows(after["chunks"]) == A.chunk_file_anchored_np(
                np.frombuffer(ec_body[:3 * 1024 * 1024], np.uint8), params),
                "(a) the call after the cancel: table != oracle")
            out_a = {"client_methods_s": client_s, "cpp_build_s": build_s,
                     "cpp_stream_bytes": len(body), "cpp_stream_s": stream_s,
                     "cpp_stream_gib_s": len(body) / stream_s / 2**30,
                     "e2e_fragment_gib_s": fragment_gib_s,
                     "cpp_duplex_s": duplex_s, "window": health["window"],
                     "duplex_batches": len(duplex) - 1,
                     "cancelled_then_served": True,
                     "peak_stream_buffered": srv.peak_buffered,
                     "oracle_equal": True}
            emit({"phase": "cluster_sidecar:a", **out_a})

            # (b) a node delegating its chunking to (a)'s server
            t0 = time.perf_counter()
            while True:
                check(procs["serve"].poll() is None,
                      f"(b) serve exited {procs['serve'].returncode}")
                try:
                    if _http(ports[0], "GET", "/status", timeout=5)[0] \
                            == 200:
                        break
                except OSError:
                    pass
                check(time.perf_counter() - t_start < 300,
                      "(b) serve did not answer /status")
                time.sleep(0.3)
            serve_up_s = time.perf_counter() - t_start
            sha = hashlib.sha256(ec_body).hexdigest()
            t1 = time.perf_counter()
            up1 = _upload(ports[0], iter(
                [ec_body[i:i + BLOCK_BYTES]
                 for i in range(0, len(ec_body), BLOCK_BYTES)]),
                "sidecar-chunked.bin", chunked=True)
            chunked_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            up2 = _upload(ports[0], ec_body, "sidecar-whole.bin")
            whole_s = time.perf_counter() - t1
            check(up1["fileId"] == up2["fileId"] == sha,
                  "(b) fileId != sha256(body)")
            man = _get_json(ports[0], f"/manifest?fileId={sha}")
            check(rows(man["chunks"]) == ec_table,
                  "(b) manifest != oracle")
            check(man["fragmenter"] == "sidecar:cdc-anchored-cuda",
                  f"(b) manifest fragmenter {man['fragmenter']}")
            t1 = time.perf_counter()
            st, _, got = _http(ports[0], "GET", f"/download?fileId={sha}")
            download_s = time.perf_counter() - t1
            check(st == 200 and got == ec_body, "(b) download differs")
            chunking = _get_json(ports[0], "/chunking")
            check(chunking["describe"] == health["describe"],
                  f"(b) /chunking {chunking}")
            node_launches = _metrics(ports[0])["frag"]["launches"]
            check(all(v == 0 for v in node_launches.values()),
                  f"(b) the node launched kernels itself: {node_launches}")
            launches = path_launches(kernels, "cluster_sidecar", needed)
            out_b = {"serve_up_s": serve_up_s, "chunked_upload_s": chunked_s,
                     "whole_upload_s": whole_s, "download_s": download_s,
                     "manifest_oracle_equal": True, "file_id_ok": True,
                     "download_identical": True,
                     "chunking_equals_describe": True,
                     "node_launches": node_launches}
            emit({"phase": "cluster_sidecar:b", **out_b,
                  "launches": launches})

            # (c) the subcommand: Health, a 2 MiB ChunkHash, SIGTERM
            reader.join(timeout=300)
            line = cli_up.get("line", "")
            check(line.startswith(f"sidecar listening on 127.0.0.1:"
                                  f"{ports[2]} (fragmenter="
                                  "cdc-anchored-cuda)"),
                  f"(c) sidecar printed {line!r}")
            cli_up_s = cli_up["s"]
            cc = SidecarClient(ports[2])
            h = cc.health()
            check(h["fragmenter"] == "cdc-anchored-cuda"
                  and h["window"] == srv.fragmenter.stream_span(),
                  f"(c) Health {h}")
            part = body[:SIDECAR_CLI_BYTES]
            check(rows(cc.chunk_hash(part)["chunks"])
                  == A.chunk_file_anchored_np(np.frombuffer(part, np.uint8),
                                              params),
                  "(c) ChunkHash: table != oracle")
            t1 = time.perf_counter()
            procs["cli"].send_signal(signal.SIGTERM)
            rc = procs["cli"].wait(timeout=10)
            stop_s = time.perf_counter() - t1
            check(rc == 0, f"(c) sidecar exited {rc} on SIGTERM")
            emit({"phase": "cluster_sidecar:c", "up_s": cli_up_s,
                  "window": h["window"], "chunk_hash_bytes": len(part),
                  "sigterm_exit": rc, "stop_s": stop_s,
                  "oracle_equal": True})
        except BaseException:
            for k, f in logs.items():
                f.flush()
                tail = (wd / f"{k}.log").read_bytes()[-3000:]
                print(f"--- {k} log tail ---\n"
                      f"{tail.decode('utf-8', 'replace')}", file=sys.stderr)
            raise
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                proc.wait(timeout=60)
            for f in logs.values():
                f.close()
            srv.stop()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "cluster_sidecar", "seconds": seconds,
          "bound_s": SIDECAR_PHASE_BOUND_S, "launches": launches})
    check(seconds <= SIDECAR_PHASE_BOUND_S,
          f"cluster_sidecar took {seconds:.1f} s "
          f"(bound {SIDECAR_PHASE_BOUND_S} s)")
    return launches


# ---------------------------------------------------------------------------
# the strategies ported last: aligned v2, v1, the rolling walk, the host
# anchored engine, multihost
# ---------------------------------------------------------------------------

def _triples(chunks) -> list:
    return [(c.offset, c.length, c.digest) for c in chunks]


def aligned_phase(root: Path, body: bytes, body_np, blocks: list,
                  kernels) -> dict:
    """The ``aligned`` phase (module docstring). Returns this process's
    launches over the body's ``chunk`` and ``manifest_stream``."""
    import asyncio

    import torch

    from dfs_tpu_torch.config import ClusterConfig, NodeConfig
    from dfs_tpu_torch.fragmenter.cdc_aligned import AlignedCudaFragmenter
    from dfs_tpu_torch.node.runtime import StorageNodeServer
    from dfs_tpu_torch.ops import cdc_pipeline
    from dfs_tpu_torch.ops.cdc_v2 import (AlignedCdcParams, chunk_file_np,
                                          file_id_from_digests)

    params = AlignedCdcParams()
    needed = ("bswap_transpose", "strip_chunk_states")
    t0 = time.perf_counter()
    oracle = chunk_file_np(body_np, params)
    oracle_s = time.perf_counter() - t0
    fid = file_id_from_digests([d for _, _, d in oracle])
    frag = AlignedCudaFragmenter(params, device="cuda")
    frag.chunk(body[:ALIGNED_NODE_BYTES])                # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    table = _triples(frag.chunk(body))
    chunk_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m = frag.manifest_stream(iter(blocks), "aligned.bin")
    stream_s = time.perf_counter() - t0
    counts = path_launches(kernels, "aligned", needed)
    for k in needed:
        check(counts[k] >= 2, f"aligned: {k} launched {counts[k]} times")
    check(table == oracle, "aligned chunk table != chunk_file_np")
    check(_triples(m.chunks) == oracle and m.file_id == fid
          and m.size == len(body), "aligned streamed manifest != oracle")

    # one sub-4 MiB segment on the card: 32 strips padded to 128 lanes
    small = AlignedCudaFragmenter(params, cpu_cutoff=0, device="cuda")
    n_small = 3 * 1024 * 1024
    kernels.reset_launch_counts()
    check(_triples(small.chunk(body[:n_small])) ==
          chunk_file_np(body_np[:n_small], params),
          "aligned 3 MiB segment != oracle")
    check(kernels.launch_counts()["strip_chunk_states"] == 1,
          "aligned 3 MiB segment did not run on the card")
    small_shape = cdc_pipeline.make_segment_fn(params, 32, 128).shape

    # the node as serve builds it: rf 1, fsync on, cdc-aligned-cuda
    data = body[:ALIGNED_NODE_BYTES]
    ports = _free_ports(2)

    async def upload(d: Path):
        cfg = NodeConfig(node_id=1,
                         cluster=ClusterConfig.localhost(1, *ports, 1),
                         data_root=d, fragmenter="cdc-aligned-cuda",
                         health_probe_s=0)
        node = StorageNodeServer(cfg)
        await node.start()
        try:
            async def gen():
                for i in range(0, len(data), BLOCK_BYTES):
                    yield data[i:i + BLOCK_BYTES]

            t0 = time.perf_counter()
            mm, st = await node.upload_stream(gen(), "aligned-node.bin")
            up_s = time.perf_counter() - t0
            _, got = await node.download(mm.file_id)
            return (mm, st, up_s, bytes(got), node.dataplane_info(),
                    node.store.chunks.fsync_count())
        finally:
            await node.stop()

    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_aligned_",
                                     dir=root) as d:
        mm, st, up_s, got, dataplane, fsyncs = asyncio.run(upload(Path(d)))
    node_counts = path_launches(kernels, "aligned:node", needed)
    check(mm.fragmenter == "cdc-aligned-cuda" and _triples(mm.chunks) ==
          chunk_file_np(body_np[:ALIGNED_NODE_BYTES], params),
          "aligned node upload table != oracle")
    check(mm.file_id == hashlib.sha256(data).hexdigest() and got == data,
          "aligned node upload: fileId or download")
    check(dataplane["chunking"] is None and fsyncs > 0,
          "aligned node: /dataplane chunking not null, or no fsync")
    emit({"phase": "aligned", "bytes": len(body), "chunks": len(oracle),
          "chunk_s": chunk_s, "chunk_gib_s": len(body) / chunk_s / 2**30,
          "stream_s": stream_s, "stream_gib_s": len(body) / stream_s / 2**30,
          "oracle_s": oracle_s, "file_id_from_digests": True,
          "small_segment": {"bytes": n_small, **small_shape},
          "node": {"bytes": len(data), "upload_s": up_s,
                   "chunks": len(mm.chunks), "fsyncs": fsyncs,
                   "launches": {k: node_counts[k] for k in needed}},
          "launches": counts, "oracle_equal": True})
    return counts


def rolling_phase(body: bytes, blocks: list, cdc_oracle: list,
                  n_cards: int, kernels) -> dict:
    """The ``rolling_sharded`` phase: the body through the rolling walk on
    2 and 4 slots of the first card (and one slot per card with two or
    more cards), each table == the host ``cdc`` engine's. The walk runs
    no hand-written kernel (dfs_tpu's step is XLA: the plain bitmap)."""
    import torch

    from dfs_tpu_torch.config import CDCParams, FragmenterConfig
    from dfs_tpu_torch.fragmenter.cdc_sharded import ShardedCdcFragmenter

    dev = torch.device("cuda", 0)
    fid = hashlib.sha256(body).hexdigest()
    meshes = [(f"{n}_slots_one_card", n, [dev] * n) for n in (2, 4)]
    if n_cards >= 2:
        meshes.append(("all_cards", n_cards, None))
    out = {}
    for label, n, slots in meshes:
        walk = ShardedCdcFragmenter(CDCParams(), FragmenterConfig(devices=n),
                                    device=slots)
        walk.manifest_stream(iter(blocks[:4]), "warm")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        m = walk.manifest_stream(iter(blocks), "rolling.bin")
        walk_s = time.perf_counter() - t0
        check(_triples(m.chunks) == cdc_oracle and m.file_id == fid,
              f"rolling {label} table != the host cdc engine's")
        out[label] = {"slots": walk.mesh.size,
                      "region_bytes": walk.region_bytes, "seconds": walk_s,
                      "gib_s": len(body) / walk_s / 2**30,
                      "launches": kernels.launch_counts()}
    emit({"phase": "rolling_sharded", "bytes": len(body),
          "chunks": len(cdc_oracle), "meshes": out, "oracle_equal": True})
    return out


def v1_phase(body: bytes, blocks: list, cdc_oracle: list, kernels) -> dict:
    """The ``v1`` phase: the body through ``CudaCdcFragmenter.chunk`` (one
    transfer, the device Gear bitmap, one kernel 7 launch over the
    resident array) and ``manifest_stream`` (one kernel 7 launch a flush
    of host payloads), each table == the host ``cdc`` engine's. Returns
    the launches over both."""
    import torch

    from dfs_tpu_torch.fragmenter.cdc_cuda import CudaCdcFragmenter

    frag = CudaCdcFragmenter(device="cuda")
    frag.chunk(body[:frag.tile_size])                    # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    table = _triples(frag.chunk(body))
    chunk_s = time.perf_counter() - t0
    at_chunk = kernels.launch_counts()
    t0 = time.perf_counter()
    m = frag.manifest_stream(iter(blocks), "v1.bin")
    stream_s = time.perf_counter() - t0
    counts = path_launches(kernels, "v1", ("sha256_spans",))
    check(at_chunk["sha256_spans"] == 1 and at_chunk["sha256_blocks"] == 0,
          f"v1 chunk: kernel 7 launched {at_chunk['sha256_spans']} times, "
          f"kernel 6 {at_chunk['sha256_blocks']} times (want 1 and 0)")
    check(table == cdc_oracle, "v1 chunk table != the host cdc engine's")
    check(_triples(m.chunks) == cdc_oracle and
          m.file_id == hashlib.sha256(body).hexdigest(),
          "v1 streamed manifest != the host cdc engine's")
    emit({"phase": "v1", "bytes": len(body), "chunks": len(table),
          "chunk_s": chunk_s, "chunk_gib_s": len(body) / chunk_s / 2**30,
          "stream_s": stream_s, "stream_gib_s": len(body) / stream_s / 2**30,
          "k7_launches_chunk": at_chunk["sha256_spans"],
          "k7_launches_stream": counts["sha256_spans"]
          - at_chunk["sha256_spans"],
          "k6_launches": counts["sha256_blocks"],
          "launches": counts, "oracle_equal": True})
    return counts


def sharded_step_phase(np, kernels) -> dict:
    """The ``sharded_step`` phase: ``make_sharded_step`` on a 2 x 2 mesh of
    4 slots of the first card: two 8 MiB streams tiled over sp and 64
    messages hashed over the slots (kernel 6); bitmap == the NumPy Gear
    bitmap, count == its population, states == hashlib."""
    import torch

    from dfs_tpu_torch.config import CDCParams
    from dfs_tpu_torch.parallel import sharded_cdc as S
    from dfs_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(SEED + 3)
    data = rng.integers(0, 256, size=(2, 8 * 1024 * 1024), dtype=np.uint8)
    msgs = [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(0, 8192, size=64)]
    dev = torch.device("cuda", 0)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rec = S.rolling_sharded_parity_check(make_mesh(4, device=[dev] * 4),
                                         CDCParams(), data, msgs)
    counts = path_launches(kernels, "sharded_step", ("sha256_blocks",))
    emit({"phase": "sharded_step", "mesh": "2 x 2 slots of cuda:0",
          "seconds": time.perf_counter() - t0, **rec, "oracle_equal": True,
          "launches": counts})
    return counts


def anchored_host_phase(body: bytes, blocks: list, oracle: list,
                        params) -> None:
    """The ``anchored_host`` phase: the body through dfs_tpu's host
    ``cdc-anchored`` engine (the C++ core, hashlib), whole and streamed
    in 64 MiB windows, == the NumPy oracle."""
    from dfs_tpu_torch.fragmenter.base import get_fragmenter
    from dfs_tpu_torch.fragmenter.cdc_anchored import AnchoredCpuFragmenter

    frag = get_fragmenter("cdc-anchored")
    check(isinstance(frag, AnchoredCpuFragmenter) and frag.params == params,
          "cdc-anchored is not the host engine at the default parameters")
    t0 = time.perf_counter()
    table = _triples(frag.chunk(body))
    chunk_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    streamed = [(c.offset, c.length, c.digest)
                for b in frag.chunks_stream(iter(blocks)) for c in b]
    stream_s = time.perf_counter() - t0
    check(table == oracle and streamed == oracle,
          "native cdc-anchored table != numpy oracle")
    emit({"phase": "anchored_host", "bytes": len(body), "chunks": len(table),
          "chunk_s": chunk_s, "chunk_gib_s": len(body) / chunk_s / 2**30,
          "stream_s": stream_s, "stream_gib_s": len(body) / stream_s / 2**30,
          "oracle_equal": True})


def multihost_phase(root: Path) -> dict:
    """The ``multihost`` phase: two processes (``chip_smoke.py
    --multihost-worker``), each bringing 2 slots on ``cuda:0``, join one
    gloo group; ``multihost_parity_check`` runs the rolling step (kernel
    6), the carry step and the anchored pass B (kernels 2, 3 and 5) over
    the global mesh and holds each process's slots to the oracles.
    Returns the workers' launches."""
    coord = f"127.0.0.1:{_free_ports(1)[0]}"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_mh_",
                                     dir=root) as d:
        outs = [Path(d) / f"worker{pid}.json" for pid in (0, 1)]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--multihost-worker", coord, str(pid), str(outs[pid])],
            cwd=root) for pid in (0, 1)]
        try:
            rcs = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        check(rcs == [0, 0], f"multihost workers exited {rcs}")
        recs = [json.loads(o.read_text()) for o in outs]
    launches = {k: sum(r["launches"][k] for r in recs)
                for k in recs[0]["launches"]}
    for k in ("sha256_blocks", "repack_lanes", "bswap_transpose",
              "strip_states"):
        check(launches[k] > 0, f"kernel {k} never launched on multihost")
    emit({"phase": "multihost", "processes": 2,
          "slots": "2 per process on cuda:0, gloo",
          "seconds": time.perf_counter() - t0, "workers": recs,
          "oracle_equal": True, "launches": launches})
    return launches


def multihost_worker(coord: str, pid: int, out_path: str) -> int:
    """``chip_smoke.py --multihost-worker COORD PID OUT``, one of the
    ``multihost`` phase's processes."""
    import torch

    from dfs_tpu_torch import kernels
    from dfs_tpu_torch.parallel.multihost import (init_multihost,
                                                  multihost_parity_check)

    init_multihost(coord, 2, pid)
    dev = torch.device("cuda", 0)
    kernels.reset_launch_counts()
    rec = multihost_parity_check([dev, dev], cols=1024 * 1024)
    torch.cuda.synchronize()
    rec["launches"] = kernels.launch_counts()
    Path(out_path).write_text(json.dumps(rec))
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def k6_row(kernel_row, np, dev) -> None:
    """Kernel 6 at 16 rows x 64 blocks against its plain version (exact;
    rows of 0 and -1 blocks and one past the axis beside full rows), then
    timed alone on 16 full rows; the 128 x 256 shape of the issue's
    prediction is timed too."""
    import torch

    from dfs_tpu_torch.ops import sha256 as S

    rng = np.random.default_rng(SEED + 4)
    words = S.u32_tensor(rng.integers(0, 2**32, size=(16, 64, 16),
                                        dtype=np.uint64).astype(np.uint32),
                           dev)
    nb = np.full((16,), 64, np.int32)
    nb[:4] = (0, -1, 17, 99)
    mixed = torch.from_numpy(nb).to(dev)
    full = torch.full((16,), 64, dtype=torch.int32, device=dev)
    err = max_abs_err(S.sha256_blocks(words, mixed),
                      S.sha256_blocks_plain(words, mixed))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out_p = S.sha256_blocks_plain(words, full)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    out_k = S.sha256_blocks(words, full)
    err = max(err, max_abs_err(out_k, out_p))
    t = kernel_times(lambda: S.sha256_blocks(words, full))
    big = S.u32_tensor(rng.integers(0, 2**32, size=(128, 256, 16),
                                      dtype=np.uint64).astype(np.uint32), dev)
    big_n = torch.full((128,), 256, dtype=torch.int32, device=dev)
    big_ms = cuda_ms(lambda: S.sha256_blocks(big, big_n), 20)
    blocks = 16 * 64
    kernel_row("sha256_blocks", err, t, plain_ms,
               nbytes(words, full, out_k), blocks * K5_OPS_PER_BLOCK,
               "16 rows x 64 blocks; also nblocks 0, -1, 17 and 99",
               chain_floor_ms=64 * CHAIN_CYCLES_PER_COMPRESSION / BOOST_HZ
               * 1e3, cycles_per_compression=t["ms"] * 1e-3 * BOOST_HZ / 64,
               cycles_from="ms x 1.98 GHz / 64 blocks", ms_128x256=big_ms,
               chain_floor_128x256_ms=256 * CHAIN_CYCLES_PER_COMPRESSION
               / BOOST_HZ * 1e3)


def v1_k6_buckets(lengths: list[int]):
    """(blocks, rows, [indices]) of each kernel 6 call the v1 path made
    before kernel 7: chunks by power-of-two block count, ascending, rows
    a call sized so every call holds about V1_HASH_BATCH x 64 blocks."""
    by_blocks: dict[int, list[int]] = {}
    for i, ln in enumerate(lengths):
        nb = 1 << ((ln + 8) // 64).bit_length()
        by_blocks.setdefault(nb, []).append(i)
    for nb, idxs in sorted(by_blocks.items()):
        rows = max(16, min(V1_HASH_BATCH, 1 << (max(
            1, V1_HASH_BATCH * 64 // nb) - 1).bit_length()))
        for lo in range(0, len(idxs), rows):
            yield nb, rows, idxs[lo:lo + rows]


def k7_row(kernel_row, kernels, body: bytes, cdc_oracle: list, np,
           dev) -> None:
    """Kernel 7: exact against its plain version on 64 spans of up to 64
    blocks at every start offset mod 16 (the array's last byte included),
    then over every span of the host ``cdc`` table of the body in one
    launch, against hashlib. That launch (the span table already on the
    card) timed beside the v1 path's kernel 6 calls before it, on the
    same spans packed ahead of time bucket by bucket (``bucketed_k6_ms``:
    all of them back to back); the launch must take at most a tenth of
    their time."""
    import torch

    from dfs_tpu_torch.ops import sha256 as S
    from dfs_tpu_torch.ops.pack import pack_gathered

    rng = np.random.default_rng(SEED + 5)
    small = torch.from_numpy(rng.integers(0, 256, size=64 * 4096 + 7,
                                          dtype=np.uint8)).to(dev)
    s_lens = rng.integers(0, 4088, size=64)       # <= 64 blocks padded
    s_lens[:5] = (0, 1, 55, 56, 4087)
    s_starts = 4096 * np.arange(64) + np.arange(64) % 16
    s_starts[-1] = small.shape[0] - int(s_lens[-1])   # ends at the end
    check(max((s_lens + 8) // 64 + 1) <= 64, "k7 small set: <= 64 blocks")
    got = S.sha256_spans(small, s_starts, s_lens)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = S.sha256_spans_plain(small, s_starts, s_lens)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = max_abs_err(got, want)

    data = torch.from_numpy(np.frombuffer(body, np.uint8).copy()).to(dev)
    starts = np.array([o for o, _, _ in cdc_oracle], np.int64)
    lens = np.array([ln for _, ln, _ in cdc_oracle], np.int64)
    out = S.sha256_spans(data, starts, lens)
    check(S.state_to_hex(out) == [d for _, _, d in cdc_oracle],
          "sha256_spans != hashlib on the body's spans")
    n = starts.shape[0]
    table = torch.from_numpy(S.span_table(starts, lens,
                                          data.shape[0])).to(dev)
    res = torch.empty_like(out)

    def launch():
        kernels.launch("sha256_spans", dev, data.data_ptr(), data.numel(),
                       table.data_ptr(), res.data_ptr(), n)
    t = kernel_times(launch)
    check(max_abs_err(res, out) == 0, "sha256_spans timed launch differs")
    wrapper_ms_single = single_ms(lambda: S.sha256_spans(data, starts, lens),
                                  reps=5)

    packed = []
    for nb, rows, group in v1_k6_buckets(lens.tolist()):
        st = np.zeros(rows, np.int32)
        ln = np.full(rows, -1, np.int32)          # -1: a padding row
        st[:len(group)], ln[:len(group)] = starts[group], lens[group]
        packed.append(pack_gathered(data, torch.from_numpy(st).to(dev),
                                    torch.from_numpy(ln).to(dev), nb * 64))

    def bucketed():
        for w, nblk in packed:
            S.sha256_blocks(w, nblk)
    bucketed_ms = cuda_ms(bucketed, 3)
    n_calls = len(packed)
    del packed
    blocks = (lens + 8) // 64 + 1
    longest = int(blocks.max())
    check(t["ms"] <= bucketed_ms / 10, f"sha256_spans {t['ms']} ms is more "
          f"than a tenth of the bucketed kernel 6 calls' {bucketed_ms} ms")
    kernel_row("sha256_spans", err, t, plain_ms,
               nbytes(data, table, res), int(blocks.sum()) * K5_OPS_PER_BLOCK,
               "64 spans <= 64 blocks, every offset mod 16, vs plain "
               f"(exact); {n} spans of the {len(body)}-byte body vs hashlib",
               spans=n, blocks=int(blocks.sum()), longest_span_blocks=longest,
               chain_floor_ms=longest * CHAIN_CYCLES_PER_COMPRESSION
               / BOOST_HZ * 1e3, bucketed_k6_ms=bucketed_ms,
               bucketed_launches=n_calls,
               wrapper_ms_single=wrapper_ms_single)


def scan_inputs(words, params, n: int):
    """Kernel 1's inputs for the region in ``words`` (``n`` bytes, final,
    from 0) at ``params``, made as the chain makes them: the anchor
    tiles, K4's walk, the descriptors, K2 and K3. Returns (words_t,
    real_blocks)."""
    import torch

    from dfs_tpu_torch.ops import cdc_anchored as A
    from dfs_tpu_torch.ops.layout import bswap_transpose
    from dfs_tpu_torch.ops.repack import repack_lanes
    from dfs_tpu_torch.ops.select import select_walk

    shape = A.make_chain_fn(params, words.shape[0], 128, "tight").shape
    tiles = A.anchor_tiles(words, params, shape["m_words"])
    scal = torch.tensor([0, n, 1], dtype=torch.int32, device=words.device)
    bounds = select_walk(tiles, scal, shape["cap"], params.seg_min,
                         params.seg_max)
    (_, _, w_off, sh8, real_blocks, _, _, _) = A.descriptors(
        bounds, scal[0], shape["s_pad"])
    words_t = bswap_transpose(repack_lanes(
        words, w_off, sh8, params.chunk.strip_blocks * 16))
    return words_t, real_blocks


def large_chunks_phase(root: Path, np, kernels, dev) -> dict:
    """The ``large_chunks`` phase: restic's chunker sizes (512 KiB / 1 MiB
    / 8 MiB; 8 MiB lanes, 131,072 blocks) on a seeded 64 MiB body. (a) The
    ``auto`` anchored walk (K1-K4), (b) ``cdc-aligned-cuda`` (K3 + K1) and
    (c) the sharded aligned step on 4 slots of the card (K5), each table
    == the port's oracle (``chunk_file_anchored_np``, ``chunk_file_np``).
    (d) One anchored region at 32 MiB lanes (2^19 blocks; 4 / 8 / 32 MiB
    chunks) == the oracle. (e) K1 and K5 with the wide layout forced at
    small geometries (selection CTAs of 1, 3 and 8 lanes; chain CTAs of
    one lane and of several) == the narrow layout and the plain versions.
    (f) K7 on one span of 2^31 - 1 bytes (made on the card) == hashlib,
    timed, on a stream of its own beside the oracles, (e) and (g). (g)
    ``digest_many`` on a flush of 2.3 GiB of 8 MiB payloads (two K7
    calls) == hashlib. Then, with the card to themselves, K1 and K5 timed
    on (a)'s region beside their chain floor. Returns the launch counts
    of (a)-(d)."""
    import torch

    from dfs_tpu_torch.config import CDCParams
    from dfs_tpu_torch.fragmenter.base import (_aligned_params,
                                               _anchored_params,
                                               get_fragmenter)
    from dfs_tpu_torch.fragmenter.cdc_cuda import CudaCdcFragmenter
    from dfs_tpu_torch.ops import cdc_anchored as A
    from dfs_tpu_torch.ops import cdc_pipeline as P
    from dfs_tpu_torch.ops import sha256 as H
    from dfs_tpu_torch.ops.cdc_v2 import (AlignedCdcParams, BLOCK,
                                          chunk_file_np, cut_capacity)
    from dfs_tpu_torch.ops.sha256_strip import (list_capacity, plan_strip,
                                                strip_chunk_states,
                                                strip_chunk_states_plain,
                                                strip_states,
                                                strip_states_plain,
                                                zero_dead_states)
    from dfs_tpu_torch.parallel import sharded_cdc as S
    from dfs_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    restic, lane32 = CDCParams(*RESTIC_SIZES), CDCParams(*LANE32_SIZES)
    rec: dict = {"sizing": dict(zip(("min", "avg", "max"), RESTIC_SIZES))}
    launches = {}
    rng = np.random.default_rng(SEED + 4)
    body_np = rng.integers(0, 256, size=LARGE_BYTES, dtype=np.uint8)
    body = body_np.tobytes()
    anchored = _anchored_params(restic)
    aligned = _aligned_params(restic)
    bps = aligned.strip_blocks
    check(anchored.chunk == aligned and bps * BLOCK == RESTIC_SIZES[2],
          "restic sizing: 8 MiB lanes")
    k14 = ("strip_chunk_states", "repack_lanes", "bswap_transpose",
           "select_walk")

    # (f) kernel 7 on one span of 2^31 - 1 bytes, on a stream of its own:
    # its ~34 s chain holds one SM; the oracles, (e) and (g) run beside it
    n7 = K7_LONG_SPAN
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    data7 = torch.randint(0, 256, (n7,), dtype=torch.uint8, device=dev,
                          generator=gen)
    s7 = torch.cuda.Stream(dev)
    s7.wait_stream(torch.cuda.current_stream(dev))
    start7 = torch.cuda.Event(enable_timing=True)
    end7 = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(s7):
        start7.record()
        out7 = H.sha256_spans(data7, [0], [n7])
        end7.record()

    # the oracles, on the host while K7 runs
    t0 = time.perf_counter()
    oracle = A.chunk_file_anchored_np(body_np, anchored)
    rec["anchored_oracle_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    aligned_oracle = chunk_file_np(body_np, aligned)
    rec["aligned_oracle_s"] = time.perf_counter() - t0
    params32 = _anchored_params(lane32)
    check(params32.seg_max == LANE32_SIZES[2], "32 MiB lanes")
    t0 = time.perf_counter()
    oracle32 = A.chunk_file_anchored_np(body_np, params32)
    rec["lane32_oracle_s"] = time.perf_counter() - t0

    # (e) the wide layout forced at a small geometry
    checked = []
    # 45 lanes: one lane a chain CTA; 300 (more than the SMs): several
    for min_b, avg_b, max_b, sbps, sel, s in ((1, 2, 8, 256, 1, 45),
                                              (8, 16, 64, 256, 3, 300),
                                              (4, 8, 32, 96, 8, 300)):
        cp = AlignedCdcParams(min_blocks=min_b, avg_blocks=avg_b,
                              max_blocks=max_b, strip_blocks=sbps)
        r = np.random.default_rng(sbps + sel)
        wt = torch.from_numpy(r.integers(0, 2**32, size=(sbps * 16, s),
                                         dtype=np.uint32).view(np.int32)
                              ).view(torch.uint32).to(dev)
        rb = r.integers(0, sbps + 1, size=s).astype(np.int32)
        rb[:3] = (sbps, 1, 0)
        a = (wt, torch.from_numpy(rb).to(dev), cp.seed, cp.mask, min_b,
             max_b)
        nar = strip_chunk_states(*a, layout="narrow")
        wid = strip_chunk_states(*a, layout="wide", select_lanes=sel)
        pl = strip_chunk_states_plain(*a)
        err = max(max(max_abs_err(x, y) for x, y in zip(nar, wid)),
                  max_abs_err(wid[0], pl[0]), max_abs_err(wid[1], pl[1]),
                  max_abs_err(wid[2], zero_dead_states(pl[2], pl[0])))
        flags = torch.from_numpy((r.random((sbps, s)) < 0.2).astype(
            np.int32)).to(dev)
        k5 = strip_states(wt, flags, layout="wide")
        err = max(err, max_abs_err(k5, strip_states(wt, flags,
                                                    layout="narrow")),
                  max_abs_err(k5, zero_dead_states(
                      strip_states_plain(wt, flags), flags)))
        check(err == 0, f"wide layout at bps {sbps}, {sel} selection "
              f"lanes: max abs err {err}")
        checked.append({"bps": sbps, "lanes": s, "min_blocks": min_b,
                        "select_lanes": sel, "max_abs_err": err})
    rec["wide_forced"] = checked

    # (g) digest_many on a flush past 2^31 bytes: two kernel 7 calls
    big, step_off = RESTIC_SIZES[2], (LARGE_BYTES - RESTIC_SIZES[2]) // 16
    pool = [body[i * step_off:i * step_off + big - 4096 * i]
            for i in range(17)]
    payloads = [pool[i % len(pool)] for i in range(DIGEST_FLUSH_PAYLOADS)]
    total = sum(len(x) for x in payloads)
    check(total > 2**31, "the flush holds more than 2^31 bytes")
    v1 = CudaCdcFragmenter(restic, device=dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    digests = v1.digest_many(payloads)
    flush_s = time.perf_counter() - t0
    parts = kernels.launch_counts()["sha256_spans"]
    want = [hashlib.sha256(x).hexdigest() for x in pool]
    check(digests == [want[i % len(pool)] for i in range(len(payloads))],
          "digest_many on a 2^31-byte flush != hashlib")
    check(parts == -(-total // v1.split_bytes),
          f"digest_many: {parts} kernel 7 calls for {total} bytes")
    rec["digest_flush"] = {"payloads": len(payloads), "bytes": total,
                           "k7_calls": parts, "seconds": flush_s,
                           "hashlib_equal": True}
    del payloads, pool, digests

    # (f), its result, before (a)-(d): the walks stage through pinned
    # host buffers, whose allocation waits for the whole card
    end7.synchronize()
    k7_ms = start7.elapsed_time(end7)
    host = data7.cpu().numpy()
    del data7
    check(H.state_to_hex(out7)[0] == hashlib.sha256(host).hexdigest(),
          f"sha256_spans on a {n7}-byte span != hashlib")
    del host
    blocks7 = (n7 + 8) // 64 + 1
    rec["k7_long_span"] = {
        "bytes": n7, "blocks": blocks7, "ms": k7_ms,
        "chain_floor_ms": blocks7 * CHAIN_CYCLES_PER_COMPRESSION
        / BOOST_HZ * 1e3,
        "cycles_per_compression": k7_ms * 1e-3 * BOOST_HZ / blocks7,
        "hashlib_equal": True}

    # (a) the auto anchored walk
    frag = get_fragmenter("auto", cdc_params=restic, device=dev)
    check(frag.params == anchored, "auto: restic's anchored parameters")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = _triples(frag.chunk(body))
    rec["anchored_chunk_s"] = time.perf_counter() - t0
    launches["large_chunks:anchored"] = path_launches(
        kernels, "large_chunks:anchored", k14)
    check(got == oracle, "restic anchored walk != chunk_file_anchored_np")
    rec["anchored_chunks"] = len(oracle)
    rec["longest_chunk_bytes"] = max(ln for _, ln, _ in oracle)

    # (b) cdc-aligned-cuda
    frag = get_fragmenter("cdc-aligned-cuda", cdc_params=restic, device=dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = _triples(frag.chunk(body))
    rec["aligned_chunk_s"] = time.perf_counter() - t0
    launches["large_chunks:aligned"] = path_launches(
        kernels, "large_chunks:aligned",
        ("bswap_transpose", "strip_chunk_states"))
    check(got == aligned_oracle, "restic cdc-aligned-cuda != chunk_file_np")
    rec["aligned_chunks"] = len(aligned_oracle)

    # (c) the sharded aligned step, 8 strips over 4 slots of the card
    n_strips = LARGE_BYTES // aligned.strip_len
    mesh = make_mesh(4, device=[dev] * 4)
    step = S.make_aligned_step(mesh, aligned)
    words_le = body_np.view("<u4").reshape(n_strips, bps * 16)
    rbs = np.full((n_strips,), bps, np.int32)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cf, states, n_chunks = step(*S.shard_aligned_inputs(mesh, words_le, rbs))
    torch.cuda.current_stream(dev).synchronize()
    rec["sharded_step_s"] = time.perf_counter() - t0
    launches["large_chunks:sharded_step"] = path_launches(
        kernels, "large_chunks:sharded_step",
        ("bswap_transpose", "strip_states"))
    count, q, dig = P.compact_half(
        cf.to(dev), states.to(dev), bps=bps,
        c_max=cut_capacity(n_strips, aligned), t_tile=128,
        k_max=128 // aligned.min_blocks + 2)
    count = int(count)
    check(count == int(n_chunks), "sharded step: count != its cuts")
    ends = (q[:count].cpu().numpy().astype(np.int64) + 1) * BLOCK
    offs = np.concatenate([[0], ends[:-1]])
    got = [(int(o), int(e - o), h) for o, e, h in zip(
        offs, ends, H.state_to_hex(dig[:count]))]
    check(got == aligned_oracle, "restic sharded aligned step != "
          "chunk_file_np")
    del cf, states, dig, q, step, mesh

    # (d) one anchored region at 32 MiB lanes
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got, consumed = A.region_chunks(body_np, np.zeros(8, np.uint8), 0, True,
                                    params32, device=dev)
    rec["lane32_region_s"] = time.perf_counter() - t0
    launches["large_chunks:lane32"] = path_launches(
        kernels, "large_chunks:lane32", k14)
    check(got == oracle32 and consumed == LARGE_BYTES,
          "32 MiB-lane region != chunk_file_anchored_np")
    rec["lane32"] = {"sizing": dict(zip(("min", "avg", "max"),
                                        LANE32_SIZES)),
                     "chunks": len(oracle32), "longest_chunk_bytes":
                     max(ln for _, ln, _ in oracle32)}

    torch.cuda.synchronize()

    # K1 and K5 on the walk's first region, timed beside the chain floor
    words = A.words_tensor(A.region_buffer(body_np, np.zeros(8, np.uint8),
                                           anchored)).to(dev)
    words_t, real_blocks = scan_inputs(words, anchored, LARGE_BYTES)
    args = (words_t, real_blocks, aligned.seed, aligned.mask,
            aligned.min_blocks, aligned.max_blocks)
    cf, since, states = strip_chunk_states(*args)
    check(max_abs_err(strip_states(words_t, cf), states) == 0,
          "restic lanes: strip_states != strip_chunk_states' states")
    longest = int(since.max())
    floor_ms = longest * CHAIN_CYCLES_PER_COMPRESSION / BOOST_HZ * 1e3
    rec["strip"] = {
        "lanes": int(words_t.shape[1]), "bps": bps,
        "plan_k1": str(plan_strip("k1", bps, list_capacity(
            bps, aligned.min_blocks, aligned.max_blocks), True)),
        "plan_k5": str(plan_strip("k5", bps, bps)),
        "live_blocks": int(real_blocks.sum()),
        "longest_chunk_blocks": longest, "chain_floor_ms": floor_ms,
        "k1_ms": single_ms(lambda: strip_chunk_states(*args), reps=3,
                           warmup=1),
        "k5_ms": single_ms(lambda: strip_states(words_t, cf), reps=3,
                           warmup=1)}
    for k in ("k1", "k5"):
        rec["strip"][f"{k}_cycles_per_compression"] = \
            rec["strip"][f"{k}_ms"] * 1e-3 * BOOST_HZ / longest
    del words, words_t, cf, since, states, args

    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "large_chunks", "bytes": LARGE_BYTES, **rec,
          "launches": launches, "oracle_equal": True})
    return {**launches, "large_chunks:strip": rec["strip"],
            "large_chunks:k7": rec["k7_long_span"]}


def region_inputs(rng, dev, np) -> types.SimpleNamespace:
    """One 64 MiB region (``rng``'s first draw) at the default parameters,
    through the port's own plain anchor pass: the words, the chain's shape,
    the anchor tiles and the walk's scalars."""
    import torch

    from dfs_tpu_torch.ops import cdc_anchored as A

    params = A.AnchoredCdcParams()
    region = rng.integers(0, 256, size=REGION_BYTES, dtype=np.uint8)
    words = A.words_tensor(A.region_buffer(region, np.zeros(8, np.uint8),
                                           params)).to(dev)
    shape = A.make_chain_fn(params, words.shape[0], 128, "tight").shape
    tiles = A.anchor_tiles(words, params, shape["m_words"])
    scal = torch.tensor([0, REGION_BYTES, 1], dtype=torch.int32, device=dev)
    return types.SimpleNamespace(params=params, words=words, shape=shape,
                                 tiles=tiles, scal=scal)


def strip_refs(out_path: str) -> int:
    """``chip_smoke.py --strip-refs OUT``, the child process ``main``
    starts beside the cluster phases: kernels 1 and 5 against their plain
    versions on the region's full-shape inputs (the plain versions walk
    the 2048 blocks in Python, ~40 s each, one timed run). Kernels 2-4
    make the inputs, as on the main path (``main`` holds them to their
    plain versions). Writes the errors and the plain times to
    ``out_path`` as JSON."""
    import numpy as np
    import torch

    from dfs_tpu_torch.ops.sha256_strip import (strip_chunk_states,
                                                strip_chunk_states_plain,
                                                strip_states,
                                                strip_states_plain,
                                                zero_dead_states)

    dev = torch.device("cuda", 0)
    r = region_inputs(np.random.default_rng(SEED), dev, np)
    cp = r.params.chunk
    t_k, real_blocks = scan_inputs(r.words, r.params, REGION_BYTES)
    args = (t_k, real_blocks, cp.seed, cp.mask, cp.min_blocks, cp.max_blocks)
    out_k = strip_chunk_states(*args)
    s_k = strip_states(t_k, out_k[0])

    def timed(fn):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    out_p, k1_ms = timed(lambda: strip_chunk_states_plain(*args))
    k1_err = max(max_abs_err(out_k[0], out_p[0]),
                 max_abs_err(out_k[1], out_p[1]),
                 max_abs_err(out_k[2], zero_dead_states(out_p[2],
                                                        out_p[0])))
    del out_p
    s_p, k5_ms = timed(lambda: strip_states_plain(t_k, out_k[0]))
    k5_err = max_abs_err(s_k, zero_dead_states(s_p, out_k[0]))
    Path(out_path).write_text(json.dumps({
        "strip_chunk_states": {"err": k1_err, "plain_ms": k1_ms},
        "strip_states": {"err": k5_err, "plain_ms": k5_ms}}))
    return 0


def device_trace_phase(body: bytes, table: list, kernels) -> dict:
    """Step (f) of ``cluster_chaos``: one ``AnchoredCudaFragmenter.chunk``
    of the EC body inside ``device_trace`` and an ``upload.fragment``
    span in this process; the exported trace must hold the launches of
    K1-K4 inside that range. Returns the path's launch counts."""
    import torch

    from dfs_tpu_torch.fragmenter.cdc_anchored import AnchoredCudaFragmenter
    from dfs_tpu_torch.utils.trace import device_trace, kernels_within, span

    frag = AnchoredCudaFragmenter(device="cuda")
    frag.chunk(body[:frag.region_bytes])            # warm
    torch.cuda.synchronize()
    needed = ("strip_chunk_states", "repack_lanes", "bswap_transpose",
              "select_walk")
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_prof_",
                                     dir=Path(__file__).resolve().parent
                                     ) as tdir:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with device_trace(tdir):
            with span("upload.fragment"):
                got = frag.chunk(body)
        trace_s = time.perf_counter() - t0
        counts = path_launches(kernels, "device_trace", needed)
        check([(x.offset, x.length, x.digest) for x in got] == table,
              "traced chunk table != numpy oracle")
        trace_file = Path(tdir) / "trace.json"
        inside = kernels_within(str(trace_file), "upload.fragment",
                                {k: kernels.DEVICE_FUNCS[k] for k in needed})
        trace_bytes = trace_file.stat().st_size
    check(all(inside[k] > 0 for k in needed),
          f"device trace: kernels inside upload.fragment {inside}")
    emit({"phase": "cluster_chaos:f", "bytes": len(body),
          "seconds": trace_s, "trace_bytes": trace_bytes,
          "kernels_inside_range": inside, "launches": counts,
          "oracle_equal": True})
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from dfs_tpu_torch import kernels
    from dfs_tpu_torch.config import FragmenterConfig
    from dfs_tpu_torch.fragmenter.cdc_anchored_sharded import \
        ShardedAnchoredCudaFragmenter
    from dfs_tpu_torch.node import LocalNode
    from dfs_tpu_torch.ops import cdc_anchored as A
    from dfs_tpu_torch.ops.layout import (bswap_transpose,
                                          bswap_transpose_plain)
    from dfs_tpu_torch.ops.repack import repack_lanes, repack_lanes_plain
    from dfs_tpu_torch.ops.select import select_walk, select_walk_plain
    from dfs_tpu_torch.ops.sha256_strip import (live_state_rows,
                                                strip_chunk_states,
                                                strip_states)
    from dfs_tpu_torch.parallel import sharded_cdc as S
    from dfs_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", 0)
    t_run = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    emit({"phase": "card", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    kernels.build_all()
    regs = {k: " ".join(ln.split("info    : ", 1)[-1] for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln)
            for k, v in kernels.build_log.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "ptxas": regs})

    # ---- one 64 MiB region at the default parameters, through the
    # port's own plain anchor pass and descriptors ----
    rng = np.random.default_rng(SEED)
    reg = region_inputs(rng, dev, np)
    params, words, shape, tiles, scal = (reg.params, reg.words, reg.shape,
                                         reg.tiles, reg.scal)
    cp = params.chunk
    m_words, cap, s_pad = shape["m_words"], shape["cap"], shape["s_pad"]
    lane_words = cp.strip_blocks * 16
    torch.cuda.synchronize()
    rows = []

    def kernel_row(name, err, t, plain_ms, in_bytes, ops, note, **extra):
        bound_bytes_ms = in_bytes / PEAK_BYTES_S * 1e3
        bound_ops_ms = ops / PEAK_INT_OPS_S * 1e3
        row = {"name": name, "route": "cuda",
               "source": f"dfs_tpu_torch/csrc/{kernels.KERNELS[name][0]}",
               "replaces": REPLACES[name], "launches": None,
               "max_abs_err": err, "ms": t["ms"],
               "ms_single": t["ms_single"], "plain_ms": plain_ms,
               "bound_ms": max(bound_bytes_ms, bound_ops_ms),
               "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms
               else "operations", "library_ms": None}
        emit({"phase": f"kernel:{name}", **row, **t, "bytes": in_bytes,
              "ops": ops, **extra, "parity": note, "exact": err == 0})
        check(err == 0, f"{name} disagrees with its plain version "
              f"(max abs err {err})")
        check(t["n20_n100_within_5pct"], f"{name}: the back-to-back time "
              f"per launch depends on N ({t['ms_n20']} ms at 20, "
              f"{t['ms_n100']} ms at 100)")
        rows.append(row)

    # K4: the select walk; besides the region's own walk, at the same
    # shape, a table with no anchor (every bound forced), a carried start
    # on a non-final region that ends mid-tile, and the region's anchors
    # walked at the seg_max of large chunk sizes (512 KiB and 4 MiB: fewer
    # steps between the kernel's chunk checks, and steps longer than a
    # chunk)
    def walk(tl, sc):
        return select_walk(tl, sc, cap, params.seg_min, params.seg_max)

    def walk_plain(tl, sc):
        return select_walk_plain(tl, sc, cap, params.seg_min, params.seg_max)

    b_k = walk(tiles, scal)
    err = max_abs_err(b_k, walk_plain(tiles, scal))
    for tl, sc in ((torch.full_like(tiles, A.NO_ANCHOR), scal),
                   (tiles, torch.tensor([12345, REGION_BYTES - 1000, 0],
                                        dtype=torch.int32, device=dev))):
        err = max(err, max_abs_err(walk(tl, sc), walk_plain(tl, sc)))
    m_tiles = tiles.shape[1]
    for lo, hi in ((384 * 1024, 512 * 1024), (3 * 2**20, 4 * 2**20)):
        c = m_tiles * A.TILE_BYTES // lo + 1
        err = max(err, max_abs_err(select_walk(tiles, scal, c, lo, hi),
                                   select_walk_plain(tiles, scal, c, lo, hi)))
    steps = int((b_k >= 0).sum()) + 1
    kernel_row("select_walk", err, kernel_times(lambda: walk(tiles, scal)),
               single_ms(lambda: walk_plain(tiles, scal), reps=3, warmup=1),
               nbytes(tiles, scal, b_k),
               m_tiles * K4_OPS_PER_TILE + steps * K4_OPS_PER_STEP,
               f"full shape: tiles [2, {m_tiles}], cap {cap}; also no "
               "anchors, start0 12345 on a non-final region, and seg_max "
               "512 KiB and 4 MiB",
               steps=steps, chain_floor_ms=steps * SELECT_CYCLES_PER_STEP
               / BOOST_HZ * 1e3)

    (starts, seg_lens, w_off, sh8, real_blocks, tail_len, consumed,
     nseg) = A.descriptors(b_k, scal[0], s_pad)

    # K2: repack
    p_k = repack_lanes(words, w_off, sh8, lane_words)
    p_p = repack_lanes_plain(words, w_off, sh8, lane_words)
    kernel_row("repack_lanes", max_abs_err(p_k, p_p),
               kernel_times(lambda: repack_lanes(words, w_off, sh8,
                                                 lane_words)),
               single_ms(lambda: repack_lanes_plain(words, w_off, sh8,
                                                    lane_words), reps=5),
               nbytes(words, w_off, sh8, p_k), 0,
               f"full shape: [{s_pad}, {lane_words}]")
    del p_p

    # K3: bswap + transpose
    t_k = bswap_transpose(p_k)
    t_p = bswap_transpose_plain(p_k)
    kernel_row("bswap_transpose", max_abs_err(t_k, t_p),
               kernel_times(lambda: bswap_transpose(p_k)),
               single_ms(lambda: bswap_transpose_plain(p_k), reps=5),
               nbytes(p_k, t_k), 0,
               f"full shape: [{s_pad}, {lane_words}] -> transposed")
    del t_p

    # K6: batched SHA-256 (the v1 path, the rolling sharded step)
    k6_row(kernel_row, np, dev)

    # K1 and K5 at full shape: timed here; held against their plain
    # versions (which walk the 2048 blocks in Python, ~40 s each) by the
    # child process ``strip_refs`` on the same inputs, started beside the
    # cluster phases and read before the table. cutflag and since exact on
    # every row; states exact on the live rows and 0 on the dead ones (the
    # plain states with their dead rows zeroed); K5's states == K1's here
    args = (t_k, real_blocks, cp.seed, cp.mask, cp.min_blocks, cp.max_blocks)
    out_k = strip_chunk_states(*args)
    cf_k = out_k[0]
    live = live_state_rows(cf_k)
    dead_rows = int((~live).sum())
    live_blocks = int(real_blocks.sum())
    longest = int(out_k[1].max())
    s_k = strip_states(t_k, cf_k)
    check(max_abs_err(s_k, out_k[2]) == 0,
          "strip_states disagrees with strip_chunk_states' states")

    def chain_info(ms):
        floor_ms = longest * CHAIN_CYCLES_PER_COMPRESSION / BOOST_HZ * 1e3
        return {"longest_chunk_blocks": longest,
                "chain_floor_ms": floor_ms,
                "us_per_compression": ms * 1e3 / longest,
                "live_rows": int(live.sum()), "dead_rows": dead_rows}

    k1_t = kernel_times(lambda: strip_chunk_states(*args), single_reps=10)
    k5_t = kernel_times(lambda: strip_states(t_k, cf_k), single_reps=10)
    strip_rows = [
        ("strip_chunk_states", k1_t, nbytes(t_k, real_blocks, *out_k),
         live_blocks * K1_OPS_PER_BLOCK,
         f"full shape: {s_pad} lanes x {cp.strip_blocks} blocks "
         f"({live_blocks} live); states on live rows, dead rows 0"),
        ("strip_states", k5_t, nbytes(t_k, cf_k, s_k),
         live_blocks * K5_OPS_PER_BLOCK,
         f"full shape: {s_pad} lanes x {cp.strip_blocks} blocks "
         f"({live_blocks} live), K1's cutflag; states on live rows, "
         "dead rows 0; states == K1's")]
    del s_k

    # where one region's time goes, stage by stage (device time, one event
    # pair per call as in earlier runs, so the columns stay comparable)
    chain = A.make_chain_fn(params, words.shape[0], 128, "tight")
    cf32, since, srows = A.scan_half(words, w_off, sh8, real_blocks, cp,
                                     s_pad)
    stages = {
        "anchor_tiles": lambda: A.anchor_tiles(words, params, m_words),
        "select_walk": lambda: select_walk(tiles, scal, cap, params.seg_min,
                                           params.seg_max),
        "descriptors": lambda: A.descriptors(b_k, scal[0], s_pad),
        "scan_half": lambda: A.scan_half(words, w_off, sh8, real_blocks, cp,
                                         s_pad),
        "compact_half": lambda: A.compact_half(
            cf32, since, srows, words, w_off, sh8, real_blocks, tail_len,
            starts, seg_lens, bps=cp.strip_blocks, s_pad=s_pad,
            c_max=shape["c_max"], t_tile=shape["t_tile"],
            k_max=shape["k_max"]),
        "whole_chain": lambda: chain(words, 0, REGION_BYTES, True),
    }
    stage_ms = {k: single_ms(fn, reps=5, warmup=1)
                for k, fn in stages.items()}
    emit({"phase": "chain_stages", "region_bytes": REGION_BYTES,
          "lanes": s_pad, "segments": int(nseg), "ms": stage_ms})
    del stages, cf32, since, srows, t_k, p_k, out_k, words, tiles

    # ---- the main path: LocalNode streaming upload on the card ----
    body_np = rng.integers(0, 256, size=BODY_BYTES, dtype=np.uint8)
    body = body_np.tobytes()
    blocks = [body[i:i + BLOCK_BYTES] for i in range(0, BODY_BYTES,
                                                     BLOCK_BYTES)]
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=root) as d:
        node = LocalNode(d, device="cuda")
        frag = node.fragmenter
        check(frag.region_bytes == REGION_BYTES and frag.max_inflight == 2,
              "default fragmenter geometry")
        frag.chunk(body[:REGION_BYTES * 2])            # warm-up walk
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = frag.chunk(body)
        frag_s = time.perf_counter() - t0

        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        m, st = node.upload_stream(iter(blocks), name="smoke.bin")
        upload_s = time.perf_counter() - t0
        launches = {"e2e": path_launches(
            kernels, "e2e", ("strip_chunk_states", "repack_lanes",
                             "bswap_transpose", "select_walk"))}

        windows = -(-(BODY_BYTES - REGION_BYTES) // frag.stride) + 1
        got = [(c.offset, c.length, c.digest) for c in m.chunks]
        oracle = A.chunk_file_anchored_np(body_np, params)
        check(got == oracle, "upload chunk table != numpy oracle")
        check([(c.offset, c.length, c.digest) for c in table] == oracle,
              "fragmenter.chunk table != numpy oracle")
        check(m.file_id == hashlib.sha256(body).hexdigest(),
              "fileId != sha256(body)")
        check(node.download(m.file_id) == body, "download not identical")
        _, st2 = node.upload_stream(iter(blocks), name="smoke.bin")
        check(st2["transferredBytes"] == 0, "re-upload transferred bytes")
        edited = bytearray(body)
        for off, ins in ((120_000_005, b"\x01"), (60_000_003, b"\x02" * 77),
                         (10_000_001, b"\x03" * 7)):
            edited[off:off] = ins
        m3, st3 = node.upload(bytes(edited), name="smoke-edit.bin")
        dedup = st3["dedupSkippedBytes"] / len(edited)
        check(dedup > 0.9, f"edited copy deduped only {dedup:.3f}")
        check(node.download(m3.file_id) == bytes(edited),
              "edited download not identical")
        emit({"phase": "e2e", "bytes": BODY_BYTES, "block_bytes": BLOCK_BYTES,
              "windows": windows, "chunks": len(m.chunks),
              "unique_chunks": st["uniqueChunks"],
              "fragment_s": frag_s,
              "fragment_gib_s": BODY_BYTES / frag_s / 2**30,
              "upload_s": upload_s,
              "upload_gib_s": BODY_BYTES / upload_s / 2**30,
              "launches": launches["e2e"], "oracle_equal": True,
              "file_id_ok": True, "download_identical": True,
              "reupload_transferred": st2["transferredBytes"],
              "edit_dedup_fraction": dedup,
              "fsyncs": node.store.chunks.fsync_count()})
        node.close()
    del edited

    # ---- the node as users run it: a 5-process cluster on the card ----
    ec_rng = np.random.default_rng(SEED + 1)
    ec_body = ec_rng.integers(0, 256, size=EC_BYTES, dtype=np.uint8)
    ec_table = A.chunk_file_anchored_np(ec_body, params)
    ec_body = ec_body.tobytes()
    phase_s: dict = {}

    def timed_phase(name: str, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            phase_s[name] = time.perf_counter() - t0

    # ---- the strategies ported last, in this process on the card ----
    from dfs_tpu_torch.fragmenter.cdc_cpu import CpuCdcFragmenter

    cdc_oracle = _triples(CpuCdcFragmenter().chunk(body))
    timed_phase("kernel:sha256_spans", k7_row, kernel_row, kernels, body,
                cdc_oracle, np, dev)
    launches["aligned"] = timed_phase("aligned", aligned_phase, root, body,
                                      body_np, blocks, kernels)
    launches["v1"] = timed_phase("v1", v1_phase, body, blocks, cdc_oracle,
                                 kernels)
    for label, rec in timed_phase(
            "rolling_sharded", rolling_phase, body, blocks, cdc_oracle,
            torch.cuda.device_count(), kernels).items():
        launches[f"rolling_sharded:{label}"] = rec["launches"]
    launches["sharded_step"] = timed_phase("sharded_step",
                                           sharded_step_phase, np, kernels)
    timed_phase("anchored_host", anchored_host_phase, body, blocks, oracle,
                params)
    del body_np, cdc_oracle
    large = timed_phase("large_chunks", large_chunks_phase, root, np,
                        kernels, dev)
    large_strip = large.pop("large_chunks:strip")
    large_k7 = large.pop("large_chunks:k7")
    launches.update(large)

    ec_parity = timed_phase("ec_codec", ec_codec_phase, ec_body, ec_table,
                            dev, np)
    timed_phase("sim_sketch", sim_sketch_phase, ec_body, ec_table, dev, np)
    (launches["cluster"], launches["cluster_ec"], cluster_download_s,
     cluster_upload_s) = timed_phase(
        "cluster", cluster_phase, root, body, blocks, oracle, params, rng,
        np, ec_body, ec_table, ec_parity)
    launches["cluster_obs_off"] = timed_phase(
        "cluster_obs_off", cluster_obs_off_phase, root, blocks, oracle,
        len(body), cluster_upload_s)
    # the ring phase, bound to 180 s, runs early, before the phases that
    # write and delete the most
    launches["cluster_ring"] = timed_phase(
        "cluster_ring", cluster_ring_phase, root, np, params)
    launches["cluster_serve"] = timed_phase(
        "cluster_serve", cluster_serve_phase, root, body, blocks, oracle,
        cluster_download_s)
    # cluster_sim and cluster_index_tier run side by side, and the K1/K5
    # plain references in a child beside them: nothing compares these
    # phases' seconds, and their device work is in the nodes' processes
    refs_path = Path(tempfile.mkdtemp(prefix=".chip_smoke_refs_",
                                      dir=root)) / "strip_refs.json"
    refs_proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--strip-refs",
         str(refs_path)], cwd=root)
    atexit.register(lambda: refs_proc.poll() is None and refs_proc.kill())
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        sim = ex.submit(timed_phase, "cluster_sim", cluster_sim_phase, root,
                        ec_body, ec_table, params, np)
        tier = ex.submit(timed_phase, "cluster_index_tier",
                         cluster_index_tier_phase, root, ec_body, ec_table,
                         params, np)
        launches["cluster_sim"] = sim.result()
        launches["cluster_index_tier"] = tier.result()
    launches["cluster_chaos"] = timed_phase(
        "cluster_chaos", cluster_chaos_phase, root, ec_body, ec_table, np,
        stage_ms["whole_chain"])
    launches["cluster_client"] = timed_phase(
        "cluster_client", cluster_client_phase, root, np, params, kernels)
    launches["cluster_sidecar"] = timed_phase(
        "cluster_sidecar", cluster_sidecar_phase, root, body, oracle,
        ec_body, ec_table, params, BODY_BYTES / frag_s / 2**30, np, kernels)
    t0 = time.perf_counter()
    check(refs_proc.wait(timeout=900) == 0,
          f"the strip_refs child exited {refs_proc.returncode}")
    refs = json.loads(refs_path.read_text())
    refs_path.unlink()
    refs_path.parent.rmdir()
    phase_s["strip_refs_wait"] = time.perf_counter() - t0
    for name, t, in_bytes, ops, note in strip_rows:
        kernel_row(name, refs[name]["err"], t, refs[name]["plain_ms"],
                   in_bytes, ops, note, **chain_info(t["ms"]),
                   plain_in_child_beside_clusters=True)
    launches["device_trace"] = timed_phase(
        "device_trace", device_trace_phase, ec_body, ec_table, kernels)

    # ---- the multi-device anchored path ----
    n_cards = torch.cuda.device_count()
    slots4 = [dev] * 4                  # 4 slots, 4 streams, one card
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    parity = S.anchored_sharded_parity_check(make_mesh(4, device=slots4), 4)
    S.aligned_sharded_parity_check(make_mesh(4, device=slots4), 4)
    torch.cuda.synchronize()
    launches["sharded_parity"] = path_launches(
        kernels, "sharded_parity",
        ("repack_lanes", "bswap_transpose", "strip_states"))
    emit({"phase": "sharded_parity", "slots": 4, "mesh": "4 x cuda:0",
          "seconds": time.perf_counter() - t0, "anchored": parity,
          "aligned_ok": True, "oracle_equal": True,
          "launches": launches["sharded_parity"]})

    kernels.reset_launch_counts()
    prod = S.anchored_sharded_production_check(make_mesh(n_cards), n_cards)
    launches["sharded_production"] = path_launches(
        kernels, "sharded_production",
        ("repack_lanes", "bswap_transpose", "strip_states"))
    emit({"phase": "sharded_production", "mesh": f"{n_cards} card(s)",
          **prod, "oracle_equal": True,
          "launches": launches["sharded_production"]})

    for label, cfg, slots in (
            ("all_cards", FragmenterConfig(devices=n_cards), None),
            ("4_slots_one_card", FragmenterConfig(devices=4), slots4)):
        walk = ShardedAnchoredCudaFragmenter(params, cfg, device=slots)
        walk.chunk(body[:walk.region_bytes * 2])          # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = [(c.offset, c.length, c.digest)
               for batch in walk.chunks_stream(iter(blocks)) for c in batch]
        walk_s = time.perf_counter() - t0
        path = f"sharded_walk:{label}"
        launches[path] = path_launches(
            kernels, path, ("strip_chunk_states", "repack_lanes",
                            "bswap_transpose", "select_walk"))
        check(got == oracle, f"{path} chunk table != numpy oracle")
        emit({"phase": "sharded_walk", "mesh": label,
              "slots": walk.mesh.size, "region_bytes": walk.region_bytes,
              "windows": -(-(BODY_BYTES - walk.region_bytes)
                           // walk.stride) + 1,
              "chunks": len(got), "seconds": walk_s,
              "gib_s": BODY_BYTES / walk_s / 2**30, "oracle_equal": True,
              "launches": launches[path]})

    launches["multihost"] = timed_phase("multihost", multihost_phase, root)

    emit({"phase": "timing", "seconds": phase_s,
          "total_s": time.perf_counter() - t_run})
    for row in rows:
        if row["name"] in ("strip_chunk_states", "strip_states"):
            k = "k1" if row["name"] == "strip_chunk_states" else "k5"
            row["restic_lanes"] = {
                "ms_single": large_strip[f"{k}_ms"],
                "chain_floor_ms": large_strip["chain_floor_ms"],
                "longest_chunk_blocks": large_strip["longest_chunk_blocks"],
                "lanes": large_strip["lanes"], "bps": large_strip["bps"]}
        if row["name"] == "sha256_spans":
            row["long_span"] = large_k7
        row["launches_path"] = LAUNCHES_PATH[row["name"]]
        row["launches"] = launches[row["launches_path"]][row["name"]]
        row["launches_by_path"] = {p: c[row["name"]]
                                   for p, c in launches.items()}
    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--strip-refs":
        sys.exit(strip_refs(sys.argv[2]))
    if len(sys.argv) == 5 and sys.argv[1] == "--multihost-worker":
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(multihost_worker(sys.argv[2], int(sys.argv[3]),
                                  sys.argv[4]))
    sys.exit(main())
