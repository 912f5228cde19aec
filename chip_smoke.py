#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``lakesoul_tpu_torch``).

    python3 chip_smoke.py            # needs one CUDA card; no arguments

Drives the port's two ANN paths on the card — the single-index IVF-RaBitQ
serving path, with 1-bit and with 4-bit ex-codes, and the sharded ANN
plane, at 4 bits (built from a table, and served over the Flight
gateway's ``ann_search``) and at 1 — then the table vector index (served
over ``vector_search`` too, by the Flight gateway and by the Flight SQL
server), then its three training steps (the Titanic
MLP, read from a table, ResNet-50 and BERT-base MLM, each on a fixed batch
and fed from a table), Switch-Base-8 (BERT-base with 8 experts), its state
saved and restored sharded, and every sharded train step under one NCCL
rank, then the table →
train-step loader on a 20M-row table beside a stock DataLoader and its device
replay cache, the fleet train role and the SQL layer on that table, the
deployable Flight SQL server, storage proxy (direct and in front of a fake
S3) and console on it, then the scan plane (a gateway and two worker processes, then a fleet the
autoscaler owns) feeding the same step and the fleet train role through it,
that table compacted by the leased compactor, then the always-fresh loop
(CDC writer, leased compactors, the follower on the card), and fails if
any phase fails.  Each phase prints one JSON line carrying its wall
``seconds`` (see ``emit``):

1. device  — requires CUDA; prints ``nvidia-smi``'s name and power limit.
2. build   — builds every kernel from ``lakesoul_tpu_torch/csrc/`` with one
             nvcc per source, all started together.
3. kernels — holds each of the five kernels against its plain PyTorch
             version at the serving shapes and at ragged edges, both modes
             and every query tile of the batch kernel included (rtol 1e-5,
             atol 1e-4: float32 sums taken in another order; for the
             estimates of ``packed_estimate_batch`` and ``ragged_score``
             the rtol is of the magnitude of the terms an estimate sums,
             see ``estimate_check`` and ``ragged_check``); requires a
             query's values from the batch kernel to be bitwise the same
             whatever the batch and the query tile; holds ``packed_dot`` in
             both modes (product, and ``packed_estimate`` with unprobed
             values exactly +inf) at every copy width, codes bases that
             are not 16-byte aligned included; holds ``ragged_score``
             on ragged plans at d 128, 512, 100 and 130, with tiles that
             more than four chunks of queries name, and at a 64-row tile;
             and times kernel, plain
             version, a PyTorch yardstick and the card's bound at the shapes
             the paths give them (``packed_dot`` and ``packed_scan`` are
             timed in the slice phase on the path's own inputs, and
             ``ragged_score`` in the plane phase on the plane's own item
             tables, each after its path's timed run; the batch kernel's
             record is its estimate mode, which the path runs, with the
             product-only mode beside it as ``product_*``).
3b. register — the port's kernel register (``tensorplane/smoke.py``
             ``run_smoke()``): the reference's five Pallas cases, under their
             names and on their seeded inputs, each launching the port's
             kernels (all seven ``extern "C"`` entry points) against their
             plain versions (rtol = atol = 2e-4, the reference's case
             tolerance); every case must pass, no reference kernel uncovered;
             and the register's entry points must be the ``extern "C"``
             functions that the lint's device index reads from ``csrc/``,
             each with its binding (``register_problems`` empty).
4. slice   — builds a 1,000,000 x 512 index (nlist 1024, 1-bit, fht,
             raw vectors kept) from a seeded, L2-normalized mixture of 1024
             gaussians, then batch_search, single search, per-cluster
             packed scans and an AnnEndpoint under 16 client threads;
             recall@10 against the exact ``bruteforce_topk`` oracle on the
             card; the kernel path held against the plain path on the CPU,
             for the batch and for the 16 resident single searches; both
             fused estimates held on the path's own tables; ``packed_dot``
             run in its product mode by the 4 non-resident searches and in
             its estimate mode by the 16 resident ones; no [N, Q]
             elementwise pass left in the 256-query batch's profile; one
             resident single search's profile on a line of its own.
5. ex_slice — the slice's data through a 4-bit ex-code index (nlist 1024,
             ``fht``, raw kept): train, 4 non-resident and 16 resident single
             searches, batch_search, an AnnEndpoint under 16 client threads,
             recall@10 at nprobe = nlist against the ``bruteforce_topk``
             oracle; the batch, the resident and the non-resident searches
             held against the same index on the CPU, a query's answer the
             same alone and in a 256-query batch; the batch's profile and
             peak device memory.
6. repro   — ``kmeans`` run twice on one plane shard's rows (759,722 x 128,
             k 512) must give bitwise-equal centroids and assignments.
7. plane   — once at the repo's ANN scale leg's ``total_bits = 4``
             (``benchmarks/micro.py``), once at 1 bit, as the plane first ran:
             builds a 10,000,000 x 128 plane (nlist 512 a shard, a 768 MiB
             shard budget: 15 shards at 4 bits, 14 at 1) with
             ``ShardedAnnBuilder`` from a seeded mixture of 4096 centres,
             opens it, runs a 1024-query batch_search, a mixed-nprobe batch,
             a ShardedAnnEndpoint under 64 pipelining clients, and recall@10
             against the ``bruteforce_topk`` oracle over all 10M rows (taken
             once, in the 4-bit plane's path, for both: one corpus, one set
             of queries); requires the scale leg's recall floor 0.95 at 4
             bits; holds ``ragged_score`` against its plain version on every
             shard's real item tables, requires a query's item scores
             bitwise the same in the 1024-query tables, in 16 queries' and
             alone, and the grouping by tile to make no host-device sync;
             builds a 2-shard, 200k-row plane twice, requires equal shard
             digests (the bytes of every array of every segment), and holds
             the plane's kernel path against it opened on the CPU.  One
             plane is freed before the next is built.  The 4-bit plane
             takes the scale leg's own route (micro.py:1382-1415): its
             corpus written as a non-PK LSF table and built through
             ``iter_table_vectors`` (batches of 262,144) in a process of
             its own (``--plane-table``: write and build seconds, its RSS,
             whose growth over the leg is held to half of micro.py's 4096
             MB ceiling); and a 200k-row primary-key table through
             ``build_table_ann_plane``, opened on the card and on the CPU
             (``ragged_topk_host`` and the native re-rank), equal top-10.
7b. vector_table — the slice's 1,000,000 x 512 corpus as a 4-bucket
             primary-key LSF table: ``build_vector_index`` (nlist 256 a
             shard, 1 bit, fht, raw kept), 64 ``vector_search`` queries at
             nprobe 256 (``packed_dot``'s product mode, counted) and
             ``scan().vector_search(...).to_arrow()`` on 8; recall@10 >= 0.5
             against ``bruteforce_topk``, the first 16 queries' ids = the
             same table searched with ``device="cpu"`` (all 64 before the
             detectors phase came), the scans' rows = the ids with
             the corpus's vectors; build seconds, search p50 / p99 (the
             searches share one ``TableVectorIndex``, so they run with the
             shards open; the first, which opens them, is timed apart).
7c. gateway_ann — inside the 4-bit plane's phase: an in-process
             ``LakeSoulFlightServer`` (JWT secret) over the table the plane
             was built from, the plane bound as ``AnnPlaneBinding(
             ShardedAnnEndpoint(...), "default", "corpus")``; a user
             registered in the table's metadata logs in (basic credentials
             → bearer), then the endpoint's traffic (64 clients × 64
             requests at mixed nprobe, each client one request at a time,
             all in a process of their own: ``--gateway-clients``) goes
             through ``ann_search``: every answer's ids and distances
             bit-equal to the in-process endpoint's for the same (query,
             nprobe), ``ragged_score`` launched (counted from 0 around the
             traffic); QPS, p50 / p99 beside the endpoint's.
7d. gateway_vector — the table index behind the gateway's
             ``vector_search`` (``device=None``: the card; the server holds
             the opened shards): the 64 queries, each answer bit-equal to
             the direct ``vector_search``'s, ``packed_dot`` launched
             (counted); p50 / p99 beside the direct calls'.
7e. flight_sql_vector — the same behind an in-process
             ``LakeSoulFlightSqlServer`` (``device=None``): ``SELECT
             count(*)`` over Flight SQL = ``count_rows()``, then the 64
             queries through the JSON fall-through's ``vector_search``, each
             bit-equal to the direct call's, ``packed_dot`` launched
             (counted).
8. mlp     — BASELINE config 1 as ``examples/titanic_mlp.py`` runs it: the
             example's 2,000 synthetic rows (its own copy) written to a
             ``hash_bucket_num=4`` table keyed by ``passenger_id``, an
             upsert of the first 200 (merge-on-read), then 5 epochs of
             ``scan().batch_size(256).auto_shard().to_torch_iter(transform=
             ...)`` into ``MLP(4, hidden=64)`` with Adam 1e-2, each batch
             standardised as the example does; requires every row
             delivered each epoch and train accuracy > 0.7 (the example's
             floor); step ms and rows/s.
9. resnet50 — BASELINE config 2 at full width: ``ResNetConfig()`` (depth 50,
             width 64, 1000 classes, bf16), SGD 0.05, one fixed batch of
             256 seeded 224² images; first card = CPU on 2 images with the
             weights carried across by ``models/convert.py``: loss and logits
             rtol 1e-4 (logits atol 1e-4 · max |logit|) at float32 and at
             float64, four leaves' gradients atol 1e-3 · max |g| at float64
             and, at float32, no further from the float64 gradients than 2x
             the CPU's own float32 gradients are (float32 cannot resolve
             this gradient: see ``hold_card_to_cpu``), the bf16 loss within
             2e-2 (``resnet50_hold`` line); then 3 warm-up and 20 timed
             steps, every loss finite and the last 5 below the first 5 on
             average; step ms (median, CUDA events), images/s, peak GB,
             ``mfu`` (model FLOPs over the bf16 dense peak) and the 8 kernels
             with the most device time in one profiled step.
9b. resnet50_table — the same step fed from an image table as
             ``examples/resnet_from_table.py`` builds it at ImageNet's
             shapes (10,240 seeded 224² uint8 images, ``hash_bucket_num=4``,
             LSF) through ``to_torch_iter(transform=...)``, the float pass
             on the card; one untimed and one timed epoch: images/s beside
             the fixed batch's, busy share over 8 batches, the ``queue``
             share and stage sums, peak pinned and device GB; every epoch's
             rows, finite losses, ``shard(0, 4)`` card = CPU by sha256.
10. bert_base — BASELINE config 3 at full width: ``BertConfig.base()``, AdamW
             1e-4 (weight decay 1e-4), one fixed batch of 256 × 128 (seeded
             lengths 64-128, 15 % of the valid positions labelled and masked);
             the same numbers as resnet50, sequences/s and tokens/s; card =
             CPU with the gradients held at float32 (``bert_base_hold``
             line).  No hand kernel lies on the training path: the
             reference computes its models without Pallas, so the port
             runs them on torch ops.
10b. bert_base_table — the same step fed from a C4-style token table
             (6,144 seeded documents × 128, ``hash_bucket_num=4``, LSF, a 5 %
             upsert wave) with the example's masking on the host; the
             numbers of 9b with sequences/s and tokens/s.
10c. moe_bert_base — Switch-Base-8 (Fedus et al. 2021: BERT-base's widths,
             8 experts, top-1, capacity factor 1.25, aux 0.01):
             ``BertConfig(n_experts=8)`` on bert_base's step and batch; card =
             CPU at float32 (gradients too) and bf16 (``moe_bert_base_hold``
             line), the loss falls, step ms, ``mfu`` (each token through one
             expert, plus the router), peak GB, each expert's load and the
             share of tokens dropped past capacity, per layer.
10d. checkpoint — ``moe_bert_base``'s Switch-Base-8 and AdamW after its
             steps under a world-size-1 NCCL ``plan=`` state, saved by the
             sharded ``TrainCheckpointer`` (``torch.distributed.checkpoint``)
             into the git-ignored ``.scratch/`` and restored into a state
             built from another seed: every parameter and moment bit-equal;
             one more step from each, losses within the step's own
             run-to-run difference (two passes at learning rate 0); save s,
             restore s, GB written, peak device GB and host RSS.
10e. parallel — one NCCL process group of world size 1 (a ``file://`` store)
             and ``make_mesh()`` over it: at BERT-base widths (float32, 32 ×
             128) the plan step with ring and with Ulysses attention, the
             pipeline step (4 microbatches) and the MoE plan step, and the
             ResNet-50 plan step (float32, 16 × 224²), each first loss within
             1e-4 of the plain single-device step's on the same weights and
             batch; ``cross_chip_topk`` = the host's stable merge.  The code
             path on the card, not its scaling: one card.
11. loader — ``bench.py``'s headline train leg on the card: its 20,000,000-row
             table (``id``, ``f0..f15`` float32, ``label``; 500k-row chunks
             from seed 0, ``hash_bucket_num=8``, LSF, one 5 % upsert wave
             from seed 1, so the scan merges on read), read by
             ``to_torch_iter(transform=..., io_threads=2)`` in batches of
             524,288 rows, each a ``[16, B]`` float32 array, into one
             ``MLP(16, hidden=256)`` Adam 1e-3 step a batch (transposed on
             the card); one untimed epoch, then the best of 2.  Beside it
             the comparator ``bench.py`` names: the same rows as parquet
             (zstd 1, no dictionary) through ``pyarrow.dataset`` and a
             stock ``DataLoader`` (``pin_memory``, spawned workers, 2 and
             0, best of) into the same step from the same weights.
             Requires every row delivered each epoch (= ``count_rows``),
             the native merge library loaded, and the card's batches of
             one hash bucket (``shard(0, 8)``, no transform), copied back,
             byte-equal to the same scan delivered to the CPU (with the
             reuse ring armed too).  Reports both rows/s and their ratio,
             the step's device ms, the device's busy share over 8 batches,
             the scan's stage sums over a timed epoch, peak pinned and
             device bytes, and the host's CPU count and model.  Then
             ``bench.py``'s ``train_hbm`` leg: ``cache="device"``, one fill
             epoch and the best of 2 replay epochs
             (``hbm_resident_replay_rows_per_s``), required >= 2.0x the
             streamed rows/s (micro.py:1514-1518), a replay epoch = a
             streamed epoch by sha256 and free of host-device syncs; at
             half the epoch's bytes the spill (resident prefix + streamed
             tail = the stream, counters > 0); permuted replays equal under
             one seed, the stream's rows as a multiset, reordered the next
             epoch.
11b. fleet_train — on the loader's table, ``python -m
             lakesoul_tpu_torch.fleet train --device-put`` as two processes
             on the one card (process index 0/2 and 1/2, batch 524,288),
             publishing to a fleet spool: each rank's sha256 = the shard
             oracle in this process (``digest_batch`` over
             ``scan.shard(rank, 2).to_torch_iter(device="cpu")``), rows
             summing to ``count_rows()``, a card seen by each, both members
             read back by ``FleetAggregator``; rows/s per rank.
11c. sql   — on the loader's table, pandas unimportable:
             ``scan.filter("f0 > 0.5 AND label = 1")`` through
             ``to_torch_iter`` into the MLP step, rows = a numpy count of the
             unfiltered columns; ``SqlSession``'s ``GROUP BY label`` count and
             ``avg(f0)`` = numpy's (counts exact, means 1e-6 relative); host
             seconds.
11c.1 flight_sql — ``python -m lakesoul_tpu_torch.service.flight_sql
             --port 0 --jwt-secret ... --metrics-port ...`` on the loader's
             warehouse (the card by default): a GROUP BY and a filtered,
             ordered SELECT over ``FlightSqlClient`` = the in-process
             ``SqlSession``'s by sha256, a prepared statement run with two
             bound id ranges, ``GetTables`` with the schema, a 1,048,576-row
             ingest inside a transaction (invisible before the commit,
             visible after; its id replayed: refused by the same server, a
             no-op through a second one; a rollback leaves no row and no
             file), the ingested table read on the card by ``to_torch_iter``
             = the rows ingested by sha256, ``lakesoul_flight_*`` on
             ``/metrics``, SIGINT → exit 0, no child.  Statement s, DoGet
             rows/s, ingest rows/s, commit s.
11c.2 storage_proxy — ``python -m lakesoul_tpu_torch.service.storage_proxy``
             on the same warehouse: every live data file fetched in 8 MiB
             Range GETs through ``ProxyStorageClient`` = the local file by
             sha256, ``list_objects`` covering them, another domain's table
             403, a 64 MiB multipart PUT in 4 parts read back; restarted
             with ``LAKESOUL_PROXY_S3_*`` in front of a stdlib fake S3 that
             checks every SigV4 signature with the port's ``sigv4``: the PUT
             and the ranged GETs again.  GB/s direct and through the
             upstream.
11c.3 console — ``python -m lakesoul_tpu_torch.service.console -w WH -c
             "count bench"`` prints ``count_rows()``; ``-c lint`` the clean
             line, exit 0.
11c.4 lint — three ``python -m lakesoul_tpu_torch.analysis`` children,
             started with the console's: ``--format sarif`` over the port
             exits 0 with a SARIF 2.1.0 log of 40 rules and no result; over a
             module seeded with a bare ``threading.Thread(...).start()``, a
             ``subprocess.Popen(...)`` and a ``ctypes`` binding one argument
             short of the ``extern "C"`` prototype in a ``csrc/seeded.cu``
             beside it, it exits 1 with exactly ``raw-thread``,
             ``raw-process`` and ``kernel-abi`` on those lines; ``--rule
             nosuch`` exits 2.  Files linted, rules, findings, the lint's
             own wall seconds (``lint_seconds``; it runs beside
             ``flight_sql``, so the phase's ``seconds`` is what it adds).
11c.5 detectors — ``chip_smoke.py --detectors DIR``, a child started with
             the lint's, with ``LAKESOUL_LOCKCHECK``, ``_RACECHECK``,
             ``_LEAKCHECK``, ``_FSCHECK``, ``_TXNCHECK`` and ``_TRACECHECK``
             set; it enables all six detectors and, inside one leakcheck
             scope: builds the three kernel sources afresh into DIR (three
             threads loading at once: tracecheck counts one ``nvcc`` build
             per source), writes the loader's schema at 2M rows in 4 buckets
             with a 5 % upsert wave, reads one epoch into the MLP step with
             the pinned reuse ring armed (racecheck's canary checks each
             slot's copy event), holds a one-rank NCCL group (its
             ``/dev/shm`` descriptors recorded, none left once destroyed),
             runs 8 threads searching one ``AnnEndpoint`` over a 100k x 128
             index in bursts of 1-64 plus one resident single search a burst
             (``packed_dot`` and ``packed_dot_batch`` launch; each searched
             row finds itself), one ``LeasedCompactionService`` pass beside a
             writer of 4 commits, and one scan-plane session with one worker
             read on the card; then ``fscheck.replay(device)`` over its
             spool, manifest and obs docs and ``txncheck.replay()``.  Every
             detector records 0 violations, every hot function stays within
             its signature budget, rows = ``count_rows()`` each time.  Then
             one seeded fault a detector, each from a clean slate and each
             recorded exactly once: an ABBA lock cycle on the port's pool,
             an unguarded cross-thread write, an unjoined thread, a rename
             of an unfsynced ``manifest.json``, a READ COMMITTED lost update
             and a shape thrash past budget.  The parent reads its one line
             after ``lint``; the phase's ``seconds`` is what it adds.
11d. scanplane — on the loader's table, ``python -m
             lakesoul_tpu_torch.scanplane service --workers 2`` as a child
             (its spool on ``/dev/shm`` when ``df`` shows room for the
             table's ~1.5 GB of segments, else the git-ignored ``.scratch/``;
             which, recorded): ``t.scan().via_scanplane(location)
             .to_torch_iter(...)`` at batch 524,288 into the loader's MLP step
             on the card, a cold epoch (the workers decode while the trainer
             reads) and a warm one (the spooled session), rows =
             ``count_rows()`` each; a remote epoch's card batches copied back
             = the local ``to_torch_iter``'s by sha256, and again with
             ``LAKESOUL_FLEET_TRANSPORT=stream``; the shm rung negotiated, both
             workers' ``lakesoul_scan_stage_seconds`` series merged here;
             rows/s beside the local loader's, busy and ``queue`` shares,
             spool bytes, service start seconds.  The service is stopped by
             SIGINT; a worker alive afterwards fails the run.
11e. fleet_train_location — inside 11d: the two ``fleet train`` ranks of
             11b with ``--location`` (reading through the gateway), each =
             the shard oracle of 11b, rows summing to ``count_rows()``.
11f. autoscale — inside 11d, on a fresh spool: ``python -m
             lakesoul_tpu_torch.scanplane service --workers 0`` serves and
             ``python -m lakesoul_tpu_torch.fleet autoscale --min-workers 2
             --max-workers 4`` owns the workers; a cold ``via_scanplane``
             epoch of raw batches into the MLP step (features stacked on the
             card), one worker SIGKILLed once rows flow: a ``worker_exit``
             line and a ``spawn`` after it, the epoch's card batches = the
             local loader's by sha256, no process alive after the
             autoscaler's SIGINT; cold rows/s beside 11d's.
11g. compaction — the loader's table through ``python -m
             lakesoul_tpu_torch.compaction --once --min-file-num 2``: the
             head one CompactionCommit that added every live file, each
             bucket in at most ceil(rows / max_file_rows) + 1 files (the
             writer's roll), none merging on read, ``CALL clean`` through ``SqlSession``
             returning the cleaner's columns, then a raw epoch into the
             step = 11d's pre-compaction epoch by sha256; compaction
             seconds and the loader's rows/s after it beside before it.
12. freshness — the always-fresh loop (``benchmarks/micro.py``'s three
             roles) on its own warehouse under ``.scratch/``: ``python -m
             lakesoul_tpu_torch.freshness writer`` (24 commits of 65,536
             CDC upserts, 0.5 s apart, 4 buckets), a victim ``python -m
             lakesoul_tpu_torch.compaction`` hung in its leased job and
             SIGKILLed, a peer taking over, and ``to_torch_iter(follow=...)``
             on the card under flaky poll and object-store faults (p 0.3),
             its ``follow_state_json()`` taken halfway and resumed by a
             second iterator: rows (copied back) = the writer's oracle by
             sha256, a ``fence=<n >= 2>`` CompactionCommit, the freshness SLO
             (p99 <= ``LAKESOUL_FRESHNESS_SLO_S``) in budget, the throughput
             floor held, no child alive after; p50 / p99 / max seconds,
             rows/s, compaction commits, kill-to-fenced-commit seconds.

Each ANN path's kernel launch counts (and each gateway phase's) are set to 0
just before it is driven and read just after; every kernel must have run on
its path.

The last three lines are the command's seconds (``command``), the kernels'
JSON record and ``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import re
import secrets
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 0
DEVICE = "cuda"
N_VECTORS, DIM, NLIST = 1_000_000, 512, 1024
N_QUERIES, N_ORACLE, N_HOLD = 1024, 256, 32
N_SCAN_QUERIES = 16  # queries whose probed clusters the slice scans one by one
RTOL, ATOL = 1e-5, 1e-4
RECALL_FLOOR = 0.5  # the reference's own bar at full probe (tests/test_e2e_glove.py:182)
EX_BITS = 4  # the ex slice's total_bits
# the plane: the repo's ANN scale leg (benchmarks/micro.py:1203-1214, 1217-1231,
# 1243-1244, 1323, total_bits 4 at :1405), then the same plane at 1 bit
PLANE_ROWS, PLANE_DIM, PLANE_NLIST, PLANE_CENTERS = 10_000_000, 128, 512, 4096
PLANE_BITS = (4, 1)
PLANE_TABLE_BITS = 4  # the plane built from a table (the scale leg's bits)
PLANE_BUDGET = 768 << 20
PLANE_CHUNK = 500_000
PLANE_NPROBE, PLANE_RERANK = 48, 64
PLANE_MIXED = (48, 16, 32, 64)  # per-request nprobe in the mixed batch and at the endpoint
SERVE_CLIENTS, SERVE_PER_CLIENT, SERVE_DEPTH = 64, 64, 16
SERVE_MAX_BATCH, SERVE_WAIT_MS = 1024, 3.0
LEG_RECALL_FLOOR = 0.95  # micro.py:1205's floor for the 4-bit plane: fails the run
SMALL_PLANE_ROWS, SMALL_PLANE_SHARDS, N_PLANE_HOLD = 200_000, 2, 64
REPRO_ROWS = 759_722  # one shard of the 1-bit plane: kmeans run twice on its rows
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, f32 FLOP/s off the
# tensor cores, dense bf16 FLOP/s on them
PEAK_BYTES_S, PEAK_F32_FLOP_S, PEAK_BF16_FLOP_S = 3.35e12, 67e12, 989e12
BATCH_CASES = (1, 8, 13, 16, 17, 32, 33, 256)  # packed_dot_batch's nq: every tile, full and ragged
PROBE_SHARE = 0.25  # share of (cluster, query) pairs probed in the estimate checks' tables
PATH_PROBE_SHARE = 32 / NLIST  # the slice's nprobe / nlist: the estimate mode is timed at it
# packed_dot's (d, row offset) cases: 16-byte words, 4-byte words (d8 % 16 != 0
# or a base 4 bytes off), single bytes (d8 = 13 at an odd offset)
SINGLE_CASES = ((512, 0), (100, 0), (416, 0), (512, 4), (100, 13))
EST_FLOPS = 10  # f32 operations of the fused estimator per probed (query, row)
TILE_SWEEP = (8, 16, 32, 256)  # nq at which every query tile is timed
RAGGED_CHUNK = 32  # queries a chunk in csrc/ragged_score.cu: a heavy tile loops over several
RAGGED_WIDTHS = (128, 512, 100, 130)  # d of the ragged checks: one slab, four; 130: 4-byte copies
# timings some kernels add to their record: the batch kernel's probed share,
# f32 bound and product-only mode beside its estimate mode (the mode the
# path runs), packed_scan's device-only time, packed_dot's estimate mode
# beside its product mode (the path runs both)
EXTRA_TIMINGS = ("probed_share", "tensor_core_flop", "bound_ms_f32_cuda_cores", "product_ms",
                 "product_plain_ms", "product_library_ms", "product_bound_ms", "product_bound_by",
                 "product_tensor_core_flop", "product_bound_ms_f32_cuda_cores", "device_ms",
                 "library_device_ms", "grouping_ms", "grouping_device_ms", "estimate_ms",
                 "estimate_device_ms", "estimate_plain_ms", "estimate_bound_ms",
                 "estimate_bound_by", "estimate_probed_share", "one_bit_plane")
# the training phases: BASELINE configs 1 (Titanic MLP), 2 (ResNet-50) and 3
# (BERT-base MLM); no hand kernel lies on their path (the reference's models
# have no Pallas kernel), so they add none to the kernels line
TITANIC_ROWS, TITANIC_BATCH, TITANIC_EPOCHS, TITANIC_LR = 2000, 256, 5, 1e-2
TITANIC_UPSERT, TITANIC_BUCKETS = 200, 4  # examples/titanic_mlp.py:64-70
TITANIC_FLOOR = 0.7  # examples/titanic_mlp.py:100
TITANIC_FEATURES = ("pclass", "age", "fare", "sex")
RESNET_BATCH, RESNET_IMG, RESNET_LR = 256, 224, 0.05  # examples/resnet_from_table.py:73
BERT_BATCH, BERT_SEQ, BERT_MIN_LEN = 256, 128, 64  # the BERT paper's phase-1 shape
BERT_LABEL_SHARE, BERT_MASK_ID = 0.15, 3  # examples/bert_mlm_from_table.py:79-82
WARMUP_STEPS, TIMED_STEPS, LOSS_WINDOW = 3, 20, 5
HOLD_BATCH = 2  # card = CPU at full width on 2 examples
HOLD_RTOL, HOLD_GRAD_ATOL, HOLD_BF16_LOSS = 1e-4, 1e-3, 2e-2
HOLD_F32_SPREAD = 2.0  # ResNet-50's float32 gradients: the card within 2x the CPU's own error
PROFILE_TOP = 8
# Switch-Base-8 (Fedus et al. 2021: T5-Base widths, 8 experts) and
# the parallel layer on one card (NCCL world size 1)
MOE_EXPERTS = 8
PAR_BATCH, PAR_MICRO, PAR_RESNET_BATCH = 32, 4, 16
# the loader phase: bench.py's table (bench.py:82-93, 174-242) and train leg
# (bench.py:374-423), its DataLoader comparator (bench.py:343-361, 557-);
# the storage core and the loader are host code: no hand kernel on the path
LOADER_ROWS, LOADER_CHUNK, LOADER_BUCKETS, LOADER_FEATURES = 20_000_000, 500_000, 8, 16
LOADER_UPSERT_FRAC, LOADER_UPSERT_CHUNK = 0.05, 2_000_000
LOADER_BATCH, LOADER_HIDDEN, LOADER_LR, LOADER_IO_THREADS = 524_288, 256, 1e-3, 2
LOADER_TIMED_EPOCHS, LOADER_PROFILE_BATCHES, LOADER_STEP_ITERS = 2, 8, 20
LOADER_WORKERS = (2, 0)  # the DataLoader comparator's num_workers, best of
TENSOR_REPLAY_FLOOR = 2.0  # benchmarks/micro.py:1514-1518: replay >= 2x the streamed rows/s
REPLAY_EPOCHS = 2  # replay epochs timed after the fill epoch, best of
# slice 5's fleet train role and slice 6's SQL layer on the loader's table
FLEET_RANKS, FLEET_TIMEOUT_S = 2, 300
# the scan plane on the loader's table: its service's worker processes, how
# long its first line and its stop may take, a spool row's bytes (id int64,
# f0..f15 float32, label int32) and the share of /dev/shm's free bytes kept
SCANPLANE_WORKERS, SCANPLANE_START_S, SCANPLANE_STOP_S = 2, 120, 30
SPOOL_ROW_BYTES, SPOOL_SPARE = 76, 1.25
# the always-fresh loop (benchmarks/micro.py:1010-1190 at this scale): the
# writer role's commits, rows a commit, keyspace (commits 9-24 upsert the
# first eight's keys) and buckets; the follower's batch; the compactors'
# lease TTL; the faults' probability; and the deadline of every wait
FRESH_COMMITS, FRESH_ROWS, FRESH_KEYSPACE, FRESH_BUCKETS = 24, 65_536, 524_288, 4
FRESH_INTERVAL_S, FRESH_BATCH, FRESH_TTL_S, FRESH_FAULT_P = 0.5, 65_536, 2.0, 0.3
FRESH_DEADLINE_S, FRESH_TPUT_FLOOR = 180.0, 100.0  # micro.py's throughput floor, rows/s
# the compaction run on the loader's table, and the autoscaled fleet's bounds
COMPACT_TIMEOUT_S, AUTOSCALE_MIN, AUTOSCALE_MAX, AUTOSCALE_WAIT_S = 600, 2, 4, 60.0
# profiled windows device_ms_per_launch takes at most: the profiler has
# handed back a window with no device time in it (seen on the 4-bit plane's
# item grouping), and a second window then measures the same calls
PROFILE_WINDOWS = 2
# slice 6's Flight SQL server, storage proxy and console on the loader's
# table: the transaction's ingest rows, how long a deployable may take to
# print its first lines, a filtered SELECT of ~2.9 % of the rows, a prepared
# statement run with two id ranges, the proxy's Range GET size and its
# multipart object
FSQL_INGEST_ROWS, SERVICE_START_S = 1_048_576, 120
FSQL_SELECT = "SELECT id, f0, f1, label FROM bench WHERE f1 > 1.9 ORDER BY id"
FSQL_PREPARED = "SELECT id, f0, label FROM bench WHERE id >= ? AND id < ? ORDER BY id"
FSQL_BOUNDS = ((1_000_000, 1_400_000), (15_000_000, 15_250_000))
PROXY_RANGE, PROXY_MP_BYTES, PROXY_MP_PARTS = 8 << 20, 64 << 20, 4
CONSOLE_LINT = "lint clean: no unsuppressed findings"
# the lint phase's seeded module: one bare thread, one bare child process and
# a ctypes binding one argument short of its C entry point (LINT_SEEDED_CU,
# written beside it as csrc/seeded.cu), each a finding on its own line
# (LINT_SEEDED_LINES)
LINT_SEEDED = ("import ctypes\nimport subprocess\nimport threading\n\n"
               "from lakesoul_tpu_torch import _build\n\n\ndef spawn():\n"
               "    threading.Thread(target=print).start()\n"
               "    return subprocess.Popen([\"true\"])\n\n\n"
               "SEEDED = _build.entry(_build.load(\"seeded\"), \"ls_seeded\", "
               "[ctypes.c_void_p, ctypes.c_int64])\n")
LINT_SEEDED_CU = ('extern "C" {\n\nint ls_seeded(const void* x, int64_t n, int d, void* stream) '
                  "{\n  return 0;\n}\n\n}  // extern \"C\"\n")
LINT_SEEDED_LINES = {("raw-thread", 9), ("raw-process", 10), ("kernel-abi", 13)}
LINT_RULES = 40
# the detectors phase (``chip_smoke.py --detectors DIR``, a child with the six
# LAKESOUL_*CHECK variables set): the loader's schema at 2M rows in 4 buckets
# with a 5 % upsert wave, one ring-armed epoch at this batch; 8 threads
# searching one AnnEndpoint over a 100k x 128 index in bursts of these sizes;
# a compaction pass beside a writer of these commits; the one-worker scan
# plane over these columns; the tracecheck thrash's distinct row counts
DET_ROWS, DET_BUCKETS, DET_CHUNK, DET_BATCH = 2_000_000, 4, 250_000, 262_144
DET_ANN_ROWS, DET_ANN_DIM, DET_ANN_NLIST, DET_ANN_NPROBE = 100_000, 128, 64, 16
DET_ANN_THREADS, DET_ANN_BURSTS = 8, (1, 3, 8, 17, 32, 64)
DET_WRITER_COMMITS, DET_WRITER_ROWS, DET_VERSION_GAP = 4, 10_000, 3
DET_PLANE_COLUMNS, DET_THRASH = ["id", "f0", "label"], 9
DET_VARS = ("LAKESOUL_LOCKCHECK", "LAKESOUL_RACECHECK", "LAKESOUL_LEAKCHECK",
            "LAKESOUL_FSCHECK", "LAKESOUL_TXNCHECK", "LAKESOUL_TRACECHECK")
DET_TIMEOUT_S = 300
SQL_FILTER = "f0 > 0.5 AND label = 1"
SQL_GROUP_BY = ("SELECT label, count(*) AS n, avg(f0) AS mean_f0 FROM bench GROUP BY label "
                "ORDER BY label")
# slice 4's table feeds (examples/resnet_from_table.py, bert_mlm_from_table.py)
# at the models' full widths
RESNET_TABLE_ROWS, FEED_BUCKETS = 10_240, 4  # 40 batches of 256, ~1.54 GB of pixels
RESNET_CLASSES = 1000  # ResNetConfig()'s head: the labels are drawn below it
BERT_TABLE_ROWS, BERT_UPSERT_FRAC = 6_144, 0.05  # 24 batches of 256 x 128
FEED_PROFILE_BATCHES = 8
# the 4-bit plane's table leg (micro.py:1382-1415) and its RSS ceiling, armed
# when the leg starts under half of it (micro.py:1208-1210, 1389-1392)
PLANE_TABLE_BATCH, ANN_SCALE_RSS_CEILING_MB = 262_144, 4096
# the slice's corpus as a table: build_vector_index / vector_search
VT_BUCKETS, VT_NLIST, VT_NPROBE, VT_CHUNK = 4, 256, 256, 250_000
VT_QUERIES, VT_SCAN_QUERIES = 64, 8
# the card = CPU hold's CPU searches at a time: each copies the ~2 GB of raw
# vectors it re-ranks from, so one at a time leaves memory bandwidth idle
# between its copies (four took 1.3x less wall time than one on an 8-core
# host, answers equal)
VT_CPU_THREADS = 4
# ... and how many of the VT_QUERIES it holds there: all but the 9 whose CPU
# searches (~2.0 s each on an 8-core host) pay for the detectors phase's
# time past the +10 s it may add (26.5 s: its own 10.4 s plus 16.1 s of
# flight_sql and storage_proxy beside its child, measured in one call)
VT_CPU_HOLD = 55
# name -> (source, TPU kernel body it replaces, the PyTorch yardstick timed beside it)
KERNELS = {
    "packed_dot_batch": ("lakesoul_tpu_torch/csrc/packed_dot.cu",
                         "lakesoul_tpu/vector/kernels.py:158",
                         "none for the estimate mode; torch.matmul over pre-unpacked f32 bits "
                         "beside the product mode (product_library_ms)"),
    "packed_dot": ("lakesoul_tpu_torch/csrc/packed_dot.cu", "lakesoul_tpu/vector/kernels.py:147",
                   "torch.matmul over pre-unpacked f32 bits beside the product mode; none for "
                   "the estimate mode"),
    "packed_scan": ("lakesoul_tpu_torch/csrc/packed_dot.cu", "lakesoul_tpu/vector/kernels.py:40",
                    "torch.mv over pre-unpacked f32 bits"),
    "bruteforce_distances": ("lakesoul_tpu_torch/csrc/bruteforce.cu",
                             "lakesoul_tpu/vector/kernels.py:455", "torch.mv(x, q)"),
    "ragged_score": ("lakesoul_tpu_torch/csrc/ragged_score.cu",
                     "lakesoul_tpu/annplane/ragged.py:89",
                     "torch.bmm over the gathered tiles and query rows, gather included"),
}


def ptxas_kernels(log: str) -> list:
    """nvcc -Xptxas -v's report, one entry a compiled kernel: its mangled
    name up to the parameter list, registers, spill stores and loads."""
    out, name, spill = [], None, (0, 0)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1).split("EEv")[0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append([name, int(m.group(1)), *spill])
    return out


def device_kind(torch) -> str:
    """The card's name (``"cpu"`` when a rehearsal runs on the CPU)."""
    return "cpu" if DEVICE == "cpu" else torch.cuda.get_device_name(0)


_PHASE_STARTS: list = []  # perf_counter at each running phase function's entry


def timed_phase(fn):
    """Marks ``fn``'s entry, so that each line it emits carries its wall
    ``seconds`` (see :func:`emit`)."""
    import functools

    @functools.wraps(fn)
    def run(*args, **kwargs):
        _PHASE_STARTS.append(time.perf_counter())
        try:
            return fn(*args, **kwargs)
        finally:
            _PHASE_STARTS.pop()

    return run


def emit(phase: str, **fields) -> None:
    """One JSON line for ``phase``.  Every line carries ``seconds``: the
    phase's own when it states one, else the wall seconds since the
    innermost running :func:`timed_phase` function was entered (the whole phase for
    its closing line, the part so far for a line it emits on the way)."""
    if "seconds" not in fields and _PHASE_STARTS:
        fields["seconds"] = time.perf_counter() - _PHASE_STARTS[-1]
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def bound(n_bytes: float, flops: float, bf16_flops: float = 0.0) -> tuple[float, str]:
    """Least time on the card for the work (ms) and what bounds it: f32
    operations at the CUDA-core peak, bf16 tensor-core operations at theirs."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = (flops / PEAK_F32_FLOP_S + bf16_flops / PEAK_BF16_FLOP_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def batch_bound(n: int, d8: int, d: int, nq: int, nlist: int = 0,
                probed: float | None = None) -> dict:
    """The batch kernel's bound: three bf16 products (the exact split of the
    f32 query) on the tensor cores, against each byte read or written once;
    the f32 product on the CUDA cores beside it, the old design's bound.
    The estimate mode (``probed``: the share of (row, query) pairs whose
    cluster the query probes) adds the per-row vectors and the (cluster,
    query) tables and writes [nq, N]; it needs the product and EST_FLOPS
    f32 operations only for the probed pairs, +inf elsewhere."""
    n_bytes = n * d8 + nq * d * 4 + n * nq * 4
    share, flops = 1.0, 0.0
    if probed is not None:
        share = probed
        n_bytes += n * (3 * 4 + 8) + nlist * nq * (4 + 4 + 1)
        flops = EST_FLOPS * n * nq * share
    tc_flop = 3 * 2.0 * n * d * nq * share
    ms, by = bound(n_bytes, flops, tc_flop)
    return {"bound_ms": ms, "bound_by": by, "tensor_core_flop": tc_flop,
            "bound_ms_f32_cuda_cores": bound(n_bytes, flops + 2.0 * n * d * nq * share)[0]}


def probed_share(torch, cluster_id, probe_mask) -> float:
    """The share of (row, query) pairs whose cluster the query probes:
    ``probe_mask[cluster_id].mean()`` without the [N, nq] gather."""
    rows = torch.bincount(cluster_id, minlength=probe_mask.shape[0]).double()
    return float(rows @ probe_mask.double().sum(1)) / (len(cluster_id) * probe_mask.shape[1])


def estimate_tables(torch, g, n: int, nq: int, nlist: int, share: float = PROBE_SHARE):
    """Seeded per-row and per-(cluster, query) inputs of the estimate mode in
    the resident bundle's layout: rows sorted by cluster, ``share`` of the
    (cluster, query) pairs probed."""
    dev = g.device
    return (torch.rand(n, device=dev, generator=g) * 2 + 0.1,          # norms
            torch.rand(n, device=dev, generator=g) * 0.3 + 0.6,        # factors
            torch.randn(n, device=dev, generator=g),                   # code_dot_c
            torch.sort(torch.randint(0, nlist, (n,), device=dev, generator=g)).values,
            torch.rand(nlist, nq, device=dev, generator=g) < share,    # probe_mask
            torch.rand(nlist, nq, device=dev, generator=g) * 4,        # csq_c
            torch.randn(nlist, nq, device=dev, generator=g))           # csum_c


def first_queries(tables, nq: int):
    """The estimate inputs of the first nq queries: (cluster, query) tables
    cut to nq columns."""
    return tuple(t[:, :nq].contiguous() if t.ndim == 2 else t for t in tables)


def estimate_check(torch, K, codes, q, tables, d: int) -> float:
    """``packed_estimate_batch`` (q [nq, d], tables [nlist, nq]; out
    [nq, N]) or ``packed_estimate`` (q [d], tables [nlist]; out [N]) against
    its plain version on the same inputs.  Unprobed values must be +inf in
    both.  Each other estimate norm² + csq + 2·norm·dot/factor sums terms
    that cancel, dot itself a sum over bits, so the float32 error of two
    summation orders scales with the terms: |kernel - plain| <= ATOL +
    RTOL·(norm² + |csq| + 2·norm/|factor| · (2·|cdc| + 2·bits·|q| +
    |csum|)/√d)."""
    norms, factors, cdc, cluster, probe, csq, csum = tables
    batch = q.ndim == 2
    kernel, plain = ((K.packed_estimate_batch, K.packed_estimate_batch_torch) if batch
                     else (K.packed_estimate, K.packed_estimate_torch))

    def per_row(t):  # a (cluster[, query]) table at each row, in the output's layout
        return t[cluster].T if batch else t[cluster]

    got = kernel(codes, q, *tables, d=d)
    want = plain(codes, q, *tables, d=d)
    torch.cuda.synchronize()
    held = torch.isfinite(want)
    require(torch.equal(got[~held], want[~held]) and bool((want[~held] > 0).all()),
            "the estimate mode's unprobed values are not all +inf")
    del want
    mag = K.packed_dot_batch_torch(codes, q.abs()).T if batch else K.packed_dot_torch(codes, q.abs())
    dot_mag = (2.0 * cdc.abs() + 2.0 * mag + per_row(csum.abs())) / d**0.5
    del mag
    scale = norms * norms + per_row(csq.abs()) + 2.0 * norms / factors.abs() * dot_mag
    del dot_mag
    want = plain(codes, q, *tables, d=d)
    return max_err(torch, got[held], want[held], scale[held])


def time_ms(torch, fn, iters: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(torch, got, want, scale=None) -> float:
    """Max |got - want|, after requiring |got - want| <= ATOL + RTOL·scale,
    where ``scale`` (default |want|) is the magnitude of the float32 terms
    summed into each value."""
    torch.cuda.synchronize()
    require(got.shape == want.shape, f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), "non-finite kernel output")
    err = (got - want).abs()
    scale = want.abs() if scale is None else scale
    require(bool((err <= ATOL + RTOL * scale).all()),
            f"kernel disagrees with its plain version (max abs err {err.max().item()})")
    return err.max().item() if got.numel() else 0.0


def wrappers(K, R) -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    return {"packed_dot_batch": K.packed_dot_batch, "packed_dot": K.packed_dot,
            "packed_scan": K.packed_scan, "bruteforce_distances": K.bruteforce_distances,
            "ragged_score": R.ragged_score}


def reset_launches(K, R) -> None:
    for w in wrappers(K, R).values():
        w.launches = 0


def read_launches(K, R) -> dict:
    return {name: w.launches for name, w in wrappers(K, R).items()}


def ragged_plan(torch, R, rng, d: int, dev, *, nlist=40, nq=37, tile=128, heavy=False):
    """A seeded shard in the resident layout (random cluster sizes, some 0,
    then one tile of pad rows at the end) and a ragged probe plan over it,
    through ``plan_items``.  ``heavy``: every query also probes the largest
    cluster, so each of its tiles is named by all ``nq`` queries."""
    counts = rng.integers(0, 700, nlist)
    counts[::7] = 0
    padded = (counts + tile - 1) // tile * tile
    n_pad = int(padded.sum()) + tile
    tile_start = np.concatenate([[0], np.cumsum(padded[:-1] // tile)]).astype(np.int32)
    tile_count = (padded // tile).astype(np.int32)
    codes = torch.zeros((n_pad, d), device=dev)
    a = torch.zeros(n_pad, device=dev)
    b = torch.full((n_pad,), float(R.PAD_B), device=dev)
    h = torch.zeros(n_pad, device=dev)
    for c in range(nlist):
        rs, n_c = int(tile_start[c]) * tile, int(counts[c])
        codes[rs:rs + n_c] = torch.from_numpy(rng.integers(0, 2, (n_c, d)).astype(np.float32))
        a[rs:rs + n_c] = torch.from_numpy(rng.random(n_c).astype(np.float32) + 0.5)
        b[rs:rs + n_c] = torch.from_numpy(rng.random(n_c).astype(np.float32) * 10)
        h[rs:rs + n_c] = torch.from_numpy(rng.random(n_c).astype(np.float32))
    pairs_q, pairs_c = [], []
    for q in range(nq):
        probed = np.sort(rng.choice(nlist, rng.integers(1, nlist), replace=False))
        if heavy:
            probed = np.union1d(probed, [int(np.argmax(counts))])
        pairs_q += [q] * len(probed)
        pairs_c += probed.tolist()
    csq = rng.random(len(pairs_q)).astype(np.float32) * 5
    csum = rng.random(len(pairs_q)).astype(np.float32)
    items = R.plan_items(pairs_q, pairs_c, csq, csum, tile_start, tile_count)
    q_glob = torch.from_numpy(rng.normal(size=(nq, d)).astype(np.float32) / d**0.5).to(dev)
    return items, q_glob, codes, a, b, h


def ragged_check(torch, R, items, q_glob, codes, a, b, h, tile=128) -> float:
    """``ragged_score`` against ``ragged_score_torch`` on the same tables.
    Each estimate b + csq - h·csum - a·g is a difference of terms (on the
    plane ~3e3 for |a·g| and |b|) that cancel, so the float32 error of two
    summation orders scales with the terms, not with the estimate:
    |kernel - plain| <= ATOL + RTOL·(|b| + |csq| + |h·csum| + |a·g|)."""
    dev = codes.device
    iq, it, csq, csum = (torch.from_numpy(np.asarray(x)).to(dev) for x in items)
    want = R.ragged_score_torch(iq, it, csq, csum, q_glob, codes, a, b, h, tile=tile)
    rows = it.long()[:, None] * tile + torch.arange(tile, device=dev)
    known = b[rows] + csq[:, None] - h[rows] * csum[:, None]  # want = known - a·g
    scale = b[rows].abs() + csq.abs()[:, None] + (h[rows] * csum[:, None]).abs() \
        + (known - want).abs()
    got = R.ragged_score(*items, q_glob, codes, a, b, h, tile=tile)
    return max_err(torch, got, want, scale)


def ragged_bound(items, q_glob, codes, tile=128) -> tuple[float, str, dict]:
    """The least time for ``ragged_score`` on these tables: each input byte
    read once (the tiles the items name, their a/b/h, the item tables, the
    query rows), the output written once; 2·M·tile·d FLOP."""
    m, d = len(items[0]), codes.shape[1]
    per_tile = np.bincount(np.asarray(items[1]))
    tiles = int((per_tile > 0).sum())
    n_bytes = tiles * tile * (d + 3) * 4 + m * 16 + q_glob.shape[0] * d * 4 + m * tile * 4
    reread = m * tile * d * 4 + 3 * m * tile * 4 + m * tile * 4 + m * d * 4
    ms, by = bound(n_bytes, 2.0 * m * tile * d)
    return ms, by, {"items": m, "tiles": tiles, "queries": int(q_glob.shape[0]), "d": d,
                    "bytes": n_bytes, "bytes_reread_per_item": reread,
                    "bound_ms_reread_per_item": bound(reread, 0.0)[0],
                    "heaviest_tile_items": int(per_tile.max(initial=0)),
                    "mean_items_per_probed_tile": m / max(tiles, 1)}


def ragged_invariance(torch, R, items, q_glob, sh, n_alone: int = 4) -> dict:
    """A query's item scores bitwise the same whatever batch its items ride
    in: from ``items`` (a big batch's tables of one shard), from the rows of
    16 of its queries — the first that probes the heaviest tile, and the
    next ones — and from tables that hold each of ``n_alone`` of them
    alone.  The plane's "alone = in a batch" checks rest on this."""
    dev = q_glob.device
    iq, it = np.asarray(items[0]), np.asarray(items[1])
    full = R.ragged_score(*items, q_glob, sh.codes, sh.a, sh.b, sh.h)
    qs = np.unique(iq)
    first = int(np.searchsorted(qs, iq[it == np.bincount(it).argmax()][0]))
    batch16 = qs[max(0, min(first, len(qs) - 16)):][:16]

    def same(sel) -> bool:
        keep = np.isin(iq, sel)
        sub = (np.searchsorted(sel, iq[keep]).astype(np.int32),
               *(np.asarray(x)[keep] for x in items[1:]))
        got = R.ragged_score(*sub, q_glob[torch.from_numpy(sel).to(dev)].contiguous(), sh.codes,
                             sh.a, sh.b, sh.h)
        return torch.equal(got, full[torch.from_numpy(np.flatnonzero(keep)).to(dev)])

    return {"queries_of_batch": len(qs), "batch16": same(batch16),
            "alone": [same(batch16[i:i + 1]) for i in range(min(n_alone, len(batch16)))]}


def single_tables(torch, g, n: int, share: float):
    """``estimate_tables`` for one query: the estimate mode's [nlist] tables."""
    return tuple(t[:, 0].contiguous() if t.ndim == 2 else t
                 for t in estimate_tables(torch, g, n, 1, NLIST, share))


def single_bound(n: int, d8: int, d: int, share: float | None = None) -> tuple[float, str]:
    """``packed_dot``'s bound.  Product mode: the codes and the query read
    once, [N] written, 2·d operations a row.  Estimate mode (``share``: of
    the rows whose cluster is probed): every cluster id, the [nlist] tables,
    and only for probed rows their codes and three floats and 2·d +
    EST_FLOPS operations; [N] written."""
    if share is None:
        return bound(n * d8 + d * 4 + n * 4, 2.0 * n * d)
    n_bytes = 8 * n + NLIST * (1 + 4 + 4) + share * n * (d8 + 12) + 4 * n + d * 4
    return bound(n_bytes, share * n * (2.0 * d + EST_FLOPS))


def single_query_checks(torch, K, dev) -> tuple[float, int]:
    """``packed_dot`` in both modes against its plain versions: every copy
    width (SINGLE_CASES), the estimate mode at PROBE_SHARE and at the path's
    share.  Returns (max abs err, cases)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    err, cases = 0.0, 0
    for n in (1_048_576, 1000):
        for d, offset in SINGLE_CASES:
            d8 = (d + 7) // 8
            flat = torch.randint(0, 256, (n * d8 + offset,), dtype=torch.uint8, device=dev,
                                 generator=g)
            codes = flat[offset:].view(n, d8)  # base `offset` bytes into the allocation
            q = torch.randn(d, device=dev, generator=g) / d**0.5
            err = max(err, max_err(torch, K.packed_dot(codes, q), K.packed_dot_torch(codes, q)))
            for share in (PROBE_SHARE, PATH_PROBE_SHARE):
                tables = single_tables(torch, g, n, share)
                err = max(err, estimate_check(torch, K, codes, q, tables, d))
            cases += 3
            del flat, codes, tables
    return err, cases


def single_query_timing(torch, K, codes, q, tables, d: int) -> dict:
    """``packed_dot``'s record: both modes timed on a resident single
    search's own inputs (the bundle's codes, the rotated query, the path's
    per-cluster tables), after the main path, so no profiler session runs
    before the path's own timings."""
    n, d8 = codes.shape
    share = probed_share(torch, tables[3], tables[4][:, None])
    bits = K.unpack_bits(codes, q.shape[0])
    b_ms, b_by = single_bound(n, d8, d)
    e_ms, e_by = single_bound(n, d8, d, share)

    def product():
        return K.packed_dot(codes, q)

    def estimate():
        return K.packed_estimate(codes, q, *tables, d=d)

    rec = {
        "ms": time_ms(torch, product, 200),
        "device_ms": device_ms_per_launch(torch, product, 200, "packed_dot_kernel"),
        "plain_ms": time_ms(torch, lambda: K.packed_dot_torch(codes, q), 20),
        "library_ms": time_ms(torch, lambda: torch.matmul(bits, q), 100),
        "bound_ms": b_ms, "bound_by": b_by, "shape": [n, d8, d],
        "estimate_ms": time_ms(torch, estimate, 200),
        "estimate_device_ms": device_ms_per_launch(torch, estimate, 200, "packed_dot_kernel"),
        "estimate_plain_ms": time_ms(
            torch, lambda: K.packed_estimate_torch(codes, q, *tables, d=d), 20),
        "estimate_bound_ms": e_ms, "estimate_bound_by": e_by, "estimate_probed_share": share,
    }
    del bits
    return rec


@timed_phase
def phase_kernels(torch, K, R) -> dict:
    """Each kernel against its plain version; timings at the serving shapes."""
    t0 = time.perf_counter()
    dev = DEVICE
    g = torch.Generator(device=dev).manual_seed(SEED)
    errs = dict.fromkeys(KERNELS, 0.0)
    cases = 0
    for n in (1_048_576, 1000):
        for d in (512, 100):
            d8 = (d + 7) // 8
            codes = torch.randint(0, 256, (n, d8), dtype=torch.uint8, device=dev, generator=g)
            tables = estimate_tables(torch, g, n, max(BATCH_CASES), NLIST)
            # queries scaled like the rotated unit-norm queries of the slice;
            # every query tile of the batch kernel, full and ragged, both modes
            for nq in BATCH_CASES:
                q = torch.randn(nq, d, device=dev, generator=g) / d**0.5
                e = max_err(torch, K.packed_dot_batch(codes, q), K.packed_dot_batch_torch(codes, q))
                e = max(e, estimate_check(torch, K, codes, q, first_queries(tables, nq), d))
                errs["packed_dot_batch"] = max(errs["packed_dot_batch"], e)
                cases += 2
            del tables

    # timings at the shapes the serving path gives the kernels: the resident
    # bundle of 1M rows pads to 1,048,576; batch_search runs chunks of 256
    # queries, the endpoint's batches of ~15 pad to 16
    n, d = 1_048_576, DIM
    d8 = d // 8
    codes = torch.randint(0, 256, (n, d8), dtype=torch.uint8, device=dev, generator=g)
    q = torch.randn(256, d, device=dev, generator=g) / d**0.5
    tables = estimate_tables(torch, g, n, 256, NLIST)

    # tile invariance, bitwise: a query's values do not depend on the batch
    # or on the query tile, in either mode
    prod = {qg: K.packed_dot_batch(codes, q, query_group=qg) for qg in K.QUERY_GROUPS}
    est = {qg: K.packed_estimate_batch(codes, q, *tables, d=d, query_group=qg)
           for qg in K.QUERY_GROUPS}
    q16, t16 = q[:16].contiguous(), first_queries(tables, 16)
    invariance = {
        "tiles_nq256_product": all(torch.equal(prod[qg], prod[64]) for qg in K.QUERY_GROUPS),
        "tiles_nq256_estimate": all(torch.equal(est[qg], est[64]) for qg in K.QUERY_GROUPS),
        "nq16_of_256_product": torch.equal(prod[K.pick_query_group(256)][:, :16],
                                           K.packed_dot_batch(codes, q16)),
        "nq16_of_256_estimate": torch.equal(est[K.pick_query_group(256)][:16],
                                            K.packed_estimate_batch(codes, q16, *t16, d=d)),
    }
    require(all(invariance.values()), f"the batch kernel is not tile-invariant: {invariance}")
    del prod, est
    tables = estimate_tables(torch, g, n, 256, NLIST, PATH_PROBE_SHARE)
    bits = K.unpack_bits(codes, d)

    def batch_timing(nq: int) -> dict:
        """The estimate mode, which the path runs, in the record's own keys
        (no single PyTorch call computes it: library_ms is null); the
        product-only mode beside it, with torch.matmul as its yardstick."""
        qn, tn = q[:nq].contiguous(), first_queries(tables, nq)
        share = probed_share(torch, tn[3], tn[4])
        return {
            "ms": time_ms(torch, lambda: K.packed_estimate_batch(codes, qn, *tn, d=d), 20),
            "plain_ms": time_ms(
                torch, lambda: K.packed_estimate_batch_torch(codes, qn, *tn, d=d), 5),
            "library_ms": None,
            **batch_bound(n, d8, d, nq, NLIST, share), "probed_share": share,
            "shape": [n, d8, nq, d],
            "product_ms": time_ms(torch, lambda: K.packed_dot_batch(codes, qn), 20),
            "product_plain_ms": time_ms(torch, lambda: K.packed_dot_batch_torch(codes, qn), 20),
            "product_library_ms": time_ms(torch, lambda: torch.matmul(bits, qn.T), 20),
            **{f"product_{k}": v for k, v in batch_bound(n, d8, d, nq).items()},
        }

    rec = {"packed_dot_batch": {**batch_timing(256), "endpoint_nq16": batch_timing(16),
                                "tile_invariance": invariance}}
    del bits

    # every query tile of the batch kernel at the batch sizes around the
    # choice, both modes, each held against the plain version, then timed
    tiles = {}
    for nq in TILE_SWEEP:
        qn, tn = q[:nq].contiguous(), first_queries(tables, nq)
        want = K.packed_dot_batch_torch(codes, qn)
        row = {"picked": K.pick_query_group(nq)}
        for qg in K.QUERY_GROUPS:
            e = max_err(torch, K.packed_dot_batch(codes, qn, query_group=qg), want)
            errs["packed_dot_batch"] = max(errs["packed_dot_batch"], e)
            cases += 1
            row[f"qg{qg}_ms"] = time_ms(torch, lambda: K.packed_dot_batch(codes, qn, query_group=qg), 20)
            row[f"qg{qg}_estimate_ms"] = time_ms(
                torch, lambda: K.packed_estimate_batch(codes, qn, *tn, d=d, query_group=qg), 20)
        tiles[f"nq{nq}"] = row
        del want
    del codes, tables

    errs["packed_dot"], n_single = single_query_checks(torch, K, dev)
    cases += n_single

    # packed_scan: one cluster's estimate, at the cluster sizes of the slice
    # and at a whole 1M-row code set
    for n in (1, 1000, 1_048_576):
        for d in (100, 512):
            c = torch.randint(0, 256, (n, (d + 7) // 8), dtype=torch.uint8, device=dev, generator=g)
            nm = torch.rand(n, device=dev, generator=g) * 2
            fc = torch.rand(n, device=dev, generator=g) * 0.5 + 0.5
            q1 = torch.randn(d, device=dev, generator=g) / d**0.5
            e = max_err(torch, K.packed_scan(c, nm, fc, q1, d=d),
                        K.packed_scan_torch(c, nm, fc, q1, d=d))
            errs["packed_scan"] = max(errs["packed_scan"], e)
            cases += 1
    n, d = 1_048_576, DIM
    bits = K.unpack_bits(c, d)
    b_ms, b_by = bound(n * d // 8 + d * 4 + 3 * n * 4, 2.0 * n * d)
    rec["packed_scan_1m"] = {
        "ms": time_ms(torch, lambda: K.packed_scan(c, nm, fc, q1, d=d), 200),
        "plain_ms": time_ms(torch, lambda: K.packed_scan_torch(c, nm, fc, q1, d=d), 20),
        "library_ms": time_ms(torch, lambda: torch.mv(bits, q1), 100),
        "bound_ms": b_ms, "bound_by": b_by, "shape": [n, d // 8, d],
    }
    del c, bits

    # bruteforce: small and ragged widths, then the plane oracle's shape
    for n, dd in [(n, dd) for n in (1, 1000) for dd in (100, 128, 512)] + [(10_000_000, 128)]:
        x = torch.randn(n, dd, device=dev, generator=g)
        qx = torch.randn(dd, device=dev, generator=g)
        e = max_err(torch, K.bruteforce_distances(x, qx), K.bruteforce_distances_torch(x, qx))
        errs["bruteforce_distances"] = max(errs["bruteforce_distances"], e)
        cases += 1
    b_ms, b_by = bound(n * dd * 4 + dd * 4 + n * 4, 4.0 * n * dd)
    rec["bruteforce_distances"] = {
        "ms": time_ms(torch, lambda: K.bruteforce_distances(x, qx), 20),
        "plain_ms": time_ms(torch, lambda: K.bruteforce_distances_torch(x, qx), 5),
        "library_ms": time_ms(torch, lambda: torch.mv(x, qx), 20),
        "bound_ms": b_ms, "bound_by": b_by, "shape": [n, dd],
    }
    del x

    # ragged_score: seeded ragged plans over random cluster sizes (some 0),
    # M = 1 / Q = 1, a pad item, and an item on the last tile of the codes
    rng = np.random.default_rng(SEED)
    for d in RAGGED_WIDTHS:
        items, q_glob, codes, a, b, h = ragged_plan(torch, R, rng, d, dev)
        errs["ragged_score"] = max(errs["ragged_score"],
                                   ragged_check(torch, R, items, q_glob, codes, a, b, h))
        # M = 1 and Q = 1: the last real tile, then the pad tile at the end
        # of the codes, whose every row must score as a hole
        pad_tile = len(codes) // 128 - 1
        for tile_i in (pad_tile - 1, pad_tile):
            one = (np.zeros(1, np.int32), np.array([tile_i], np.int32),
                   np.ones(1, np.float32), np.full(1, 0.5, np.float32))
            q1 = q_glob[:1].contiguous()
            errs["ragged_score"] = max(errs["ragged_score"],
                                       ragged_check(torch, R, one, q1, codes, a, b, h))
        require(bool((R.ragged_score(*one, q1, codes, a, b, h) >= float(R.PAD_EST_VALID)).all()),
                "a pad row scored below PAD_EST_VALID")
        # heavy tiles: every tile of the largest cluster named by more than
        # four chunks of queries, so a block loops over chunks on one tile
        items, q_glob, codes, a, b, h = ragged_plan(torch, R, rng, d, dev,
                                                    nq=4 * RAGGED_CHUNK + 5, heavy=True)
        require(np.bincount(items[1]).max() >= 4 * RAGGED_CHUNK, "no heavy tile in the plan")
        errs["ragged_score"] = max(errs["ragged_score"],
                                   ragged_check(torch, R, items, q_glob, codes, a, b, h))
        cases += 4
    # a tile of 64 rows: the kernel's second band of 64 rows holds none
    items, q_glob, codes, a, b, h = ragged_plan(torch, R, rng, 128, dev, tile=64, heavy=True)
    errs["ragged_score"] = max(errs["ragged_score"],
                               ragged_check(torch, R, items, q_glob, codes, a, b, h, tile=64))
    cases += 1
    emit("kernels", seconds=time.perf_counter() - t0, cases=cases, max_abs_err=errs,
         timings=rec, batch_tiles=tiles,
         library_calls={k: v[2] for k, v in KERNELS.items()})
    return {"errs": errs, "timings": rec}


@timed_phase
def phase_register(kind: str) -> dict:
    """The port's kernel register (``tensorplane/smoke.py``) on the card:
    each of the reference's five Pallas kernels' cases launches the port's
    kernels (all seven entry points) on the reference's seeded case inputs
    and holds them against their plain versions; every case must pass and
    no reference kernel may be uncovered.  Its launches count on no path:
    each path sets the counts to 0 before it is driven."""
    from lakesoul_tpu_torch.analysis.engine import package_root
    from lakesoul_tpu_torch.analysis.rules.device import (BINDING_TEXT, index_tree,
                                                          register_problems)
    from lakesoul_tpu_torch.tensorplane.smoke import run_smoke, smoke_cases

    t0 = time.perf_counter()
    report = run_smoke()
    # the register's entry points against the lint's device index of csrc/
    idx = index_tree(package_root(), text_filter=BINDING_TEXT)
    registered = sorted({(p.entry_point, os.path.basename(p.source))
                         for case in smoke_cases() for p in case.ports})
    indexed = sorted((name, os.path.basename(e.source))
                     for name, entries in idx.entries.items() for e in entries)
    problems = register_problems(idx)
    rec = {"device_kind": kind, "seconds": time.perf_counter() - t0, **report,
           "entry_points": {"registered": registered, "indexed": indexed,
                            "problems": problems}}
    emit("register", **rec)
    require(report["ok"] and all(c["status"] == "pass" for c in report["cases"])
            and not report["kernel_enumeration"]["uncovered"],
            f"the kernel register failed on the card: {report['cases']}")
    require(registered == indexed and not problems,
            f"the register's entry points disagree with csrc/: {registered} {indexed} {problems}")
    return rec


def make_data(torch, dev):
    """Seeded mixture of NLIST gaussians on the unit sphere, L2-normalized
    like CLIP embeddings; queries are fresh draws of the same mixture."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    fn = torch.nn.functional.normalize
    centers = fn(torch.randn(NLIST, DIM, device=dev, generator=g), dim=1)
    sigma = 0.75 / DIM**0.5  # noise norm 0.75 around each unit center

    def draw(m):
        comp = torch.randint(0, NLIST, (m,), device=dev, generator=g)
        return fn(centers[comp] + sigma * torch.randn(m, DIM, device=dev, generator=g), dim=1)

    return draw(N_VECTORS), draw(N_QUERIES)


def profile(torch, fn) -> dict:
    """Device time of one call by kernel, from torch.profiler: where the
    time goes, and the share of the call's wall time the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = sorted(
        ((ev.self_device_time_total / 1e3, ev.key, ev.count) for ev in prof.key_averages()
         if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
        reverse=True,
    )
    device_ms = sum(r[0] for r in rows)
    require(device_ms > 0, "the profiler saw no device time")
    return {
        "wall_ms": wall_ms, "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
        "top": [{"kernel": k[:120], "ms": ms, "calls": c} for ms, k, c in rows[:12]],
    }


def device_ms_per_launch(torch, fn, iters: int, name: str) -> float:
    """Device time per call of ``fn`` from torch.profiler: the self device
    time of the kernels whose name holds ``name`` (every kernel for "") over
    ``iters`` calls, without the host's time between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_WINDOWS):
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(ev.self_device_time_total for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA and name in ev.key)
        if us > 0:
            break
    require(us > 0, f"the profiler saw no device time for {name or 'the call'} in "
                    f"{PROFILE_WINDOWS} windows")
    return us / 1e3 / iters


def same_topk(ids_a, d_a, ids_b, d_b) -> bool:
    """Equal ids except where distances tie within 1e-5; dists allclose at
    rtol 1e-5 with an absolute floor of 1e-5 of the list's largest distance."""
    d_a, d_b = np.asarray(d_a, np.float64), np.asarray(d_b, np.float64)
    if len(ids_a) != len(ids_b):
        return False
    atol = max(ATOL, RTOL * float(np.abs(d_a).max(initial=0.0)))
    if not np.allclose(d_b, d_a, rtol=RTOL, atol=atol):
        return False
    for i in np.flatnonzero(np.asarray(ids_a) != np.asarray(ids_b)):
        tie = np.abs(d_a - d_a[i]) <= 1e-5 * max(1.0, abs(d_a[i]))
        tie[i] = False
        if not tie.any():
            return False
    return True


def caught_inputs(K, name: str, drive) -> tuple:
    """The (args, kwargs) of the one call that ``drive()`` makes to the
    kernel wrapper ``K.<name>``, which still runs."""
    caught, real = [], getattr(K, name)

    def catch(*args, **kw):
        caught.append((args, kw))
        return real(*args, **kw)

    setattr(K, name, catch)
    try:
        drive()
    finally:
        setattr(K, name, real)
    (call,) = caught
    return call


def cluster_scans(torch, K, index, queries, nprobe: int) -> list:
    """Each query's probed clusters scanned one by one, as the reference's
    per-cluster entry point ``packed_scan`` does: the cluster's codes
    against the rotated query residual P(query - centroid).  Returns the
    (codes, norms, factors, residual, estimates) of every scan."""
    d = index.quantizer.padded_dim
    out = []
    for q in queries:
        probe = index._probe(q, nprobe)
        for c in probe.tolist():
            cl = index.clusters[c]
            if len(cl.ids):
                r = index.quantizer.rotate_query(q, index.centroids[c]).contiguous()
                out.append((cl.codes, cl.norms, cl.factors, r,
                            K.packed_scan(cl.codes, cl.norms, cl.factors, r, d=d)))
    return out


@timed_phase
def phase_slice(torch, K, R) -> dict:
    from lakesoul_tpu_torch.vector import IvfRabitqIndex, SearchParams, VectorIndexConfig
    from lakesoul_tpu_torch.vector.oracle import recall_at_k

    t0 = time.perf_counter()
    dev = DEVICE
    x, queries = make_data(torch, dev)
    torch.cuda.synchronize()
    ids = np.arange(N_VECTORS, dtype=np.uint64)
    qs_np = queries.cpu().numpy()
    cfg = VectorIndexConfig("embedding", DIM, nlist=NLIST, total_bits=1, rotator="fht", seed=SEED)
    params = SearchParams(top_k=10, nprobe=32, rerank_depth=100)
    full = SearchParams(top_k=10, nprobe=NLIST, rerank_depth=100)
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path, counted: build → search → batch → scan → serve → oracle
    reset_launches(K, R)
    t = time.perf_counter()
    index = IvfRabitqIndex.train(x, ids, cfg, keep_raw=True)  # device=None: the card
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    require(index.num_vectors == N_VECTORS, "index lost vectors")
    for q in qs_np[:4]:  # the non-resident single-query path: packed_dot's product mode
        got, _ = index.search(q, params)
        require(len(got) == 10, "non-resident search returned fewer than 10")
    product_launches = K.packed_dot.launches
    index.enable_device_cache()
    index.batch_search(qs_np[:256], params)  # warm-up: concatenates the resident bundle
    t = time.perf_counter()
    b_ids, b_d = index.batch_search(qs_np, params)
    batch_s = time.perf_counter() - t
    t = time.perf_counter()
    f_ids, f_d = index.batch_search(qs_np[:N_ORACLE], full)
    full_s = time.perf_counter() - t
    single_ms, singles = [], []
    before = K.packed_dot.launches
    for q in qs_np[:16]:  # the resident single-query path: packed_dot's estimate mode
        t = time.perf_counter()
        singles.append(index.search(q, params))
        single_ms.append((time.perf_counter() - t) * 1e3)
        require(len(singles[-1][0]) == 10, "resident search returned fewer than 10")
    estimate_launches = K.packed_dot.launches - before
    t = time.perf_counter()
    scans = cluster_scans(torch, K, index, queries[:N_SCAN_QUERIES], params.nprobe)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t
    served, errors, serve_s, stats = serve_slice(index, params, qs_np)
    # exact oracle on the card: one bruteforce_topk launch per oracle query
    t = time.perf_counter()
    top = torch.stack([K.bruteforce_topk(x, qo, 10).indices for qo in queries[:N_ORACLE]])
    oracle_s = time.perf_counter() - t
    launches = read_launches(K, R)
    # ---- end of the counted main path

    require(not errors and len(served) == 256, f"serving failed: {errors[:3]}")
    bundle = index._get_device_bundle()
    n_pad = len(bundle["codes"])
    on_path = ("packed_dot", "packed_dot_batch", "packed_scan", "bruteforce_distances")
    require(all(launches[k] for k in on_path), f"a kernel never ran on the main path: {launches}")
    packed_dot_modes = {"product": product_launches, "estimate": estimate_launches}
    require(packed_dot_modes == {"product": 4, "estimate": 16},
            f"packed_dot's modes on the path: {packed_dot_modes}, not 4 product and 16 estimate")
    for i, (ids_i, d_i) in served.items():
        require(same_topk(b_ids[i], b_d[i], ids_i, d_i), f"endpoint result {i} != batch_search")
    require(all(len(r) == 10 and np.isfinite(d).all() for r, d in zip(b_ids, b_d)),
            "batch_search returned short or non-finite results")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    index.batch_search(qs_np[:256], params)
    batch_peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
    prof_batch = profile(torch, lambda: index.batch_search(qs_np[:256], params))
    prof_single = profile(torch, lambda: index.search(qs_np[0], params))
    emit("profile_single", **prof_single)
    # one pass over the [N, Q] estimates at the memory's rate takes at least
    # this long; no kernel that long may remain but the fused kernel and the
    # top-k's own (radix select, sort)
    nq_pass_ms = n_pad * 256 * 4 / PEAK_BYTES_S * 1e3
    allowed = ("packed_batch_kernel", "topk", "radix", "kth", "sort")
    passes = [r for r in prof_batch["top"] if r["ms"] >= nq_pass_ms
              and not any(a in r["kernel"].lower() for a in allowed)]
    require(not passes, f"an [N, Q] pass besides the fused kernel and the top-k: {passes}")

    truth = [set(ids[row].tolist()) for row in top.cpu().numpy()]
    recall = recall_at_k(truth, b_ids[:N_ORACLE])
    recall_full = recall_at_k(truth, f_ids)
    require(recall_full >= RECALL_FLOOR, f"recall@10 at nprobe=nlist {recall_full} < {RECALL_FLOOR}")

    # each kernel on the main path's own inputs against its plain version;
    # the estimate modes' inputs are caught from one 256-query batch_search
    # and from one resident single search
    args, kw = caught_inputs(K, "packed_estimate_batch",
                             lambda: index.batch_search(qs_np[:256], params))
    fused = K.packed_estimate_batch
    codes_b, q_b, *path_tables = args
    path_est_err = estimate_check(torch, K, codes_b, q_b, path_tables, kw["d"])
    path_share = probed_share(torch, path_tables[3], path_tables[4])
    path_nq16 = torch.equal(
        fused(*args, **kw)[:16],
        fused(codes_b, q_b[:16].contiguous(), *first_queries(path_tables, 16), **kw))
    require(path_nq16, "the path's 16-query estimates differ from its 256-query ones")
    del args, codes_b, q_b, path_tables
    args, kw = caught_inputs(K, "packed_estimate", lambda: index.search(qs_np[0], params))
    path_single_err = estimate_check(torch, K, args[0], args[1], args[2:], kw["d"])
    single_timing = single_query_timing(torch, K, args[0], args[1], args[2:], kw["d"])
    del args
    q_glob = index.quantizer.rotate(queries[:256]).contiguous()
    q_ep = q_glob[:16].contiguous()  # the endpoint's padded batch
    errs = {
        "packed_dot_batch": max(
            max_err(torch, K.packed_dot_batch(bundle["codes"], q_glob),
                    K.packed_dot_batch_torch(bundle["codes"], q_glob)),
            max_err(torch, K.packed_dot_batch(bundle["codes"], q_ep),
                    K.packed_dot_batch_torch(bundle["codes"], q_ep)),
            path_est_err,
        ),
        "packed_dot": max(max_err(torch, K.packed_dot(bundle["codes"], q_glob[0]),
                                  K.packed_dot_torch(bundle["codes"], q_glob[0])),
                          path_single_err),
        "packed_scan": max(max_err(torch, est, K.packed_scan_torch(c, nm, fc, r, d=DIM))
                           for c, nm, fc, r, est in scans),
        "bruteforce_distances": max_err(torch, K.bruteforce_distances(x, queries[0]),
                                        K.bruteforce_distances_torch(x, queries[0])),
    }
    # packed_scan timed at the largest cluster the scans met
    c, nm, fc, r, _ = max(scans, key=lambda sc: len(sc[0]))
    bits = K.unpack_bits(c, DIM)
    n_c = len(c)
    b_ms, b_by = bound(n_c * DIM // 8 + DIM * 4 + 3 * n_c * 4, 2.0 * n_c * DIM)
    scan_timing = {
        "ms": time_ms(torch, lambda: K.packed_scan(c, nm, fc, r, d=DIM), 200),
        "plain_ms": time_ms(torch, lambda: K.packed_scan_torch(c, nm, fc, r, d=DIM), 200),
        "library_ms": time_ms(torch, lambda: torch.mv(bits, r), 200),
        "bound_ms": b_ms, "bound_by": b_by, "shape": [n_c, DIM // 8, DIM],
        "device_ms": device_ms_per_launch(
            torch, lambda: K.packed_scan(c, nm, fc, r, d=DIM), 200, "packed_scan_kernel"),
        "library_device_ms": device_ms_per_launch(torch, lambda: torch.mv(bits, r), 200, ""),
    }
    del scans, bits

    # the kernel path against the plain path: the same index on the CPU
    t = time.perf_counter()
    cpu_index = IvfRabitqIndex.from_state(index.state(), device="cpu")
    cpu_index.enable_device_cache()
    c_ids, c_d = cpu_index.batch_search(qs_np[:N_HOLD], params)
    g_ids, g_d = index.batch_search(qs_np[:N_HOLD], params)
    held = sum(same_topk(c_ids[i], c_d[i], g_ids[i], g_d[i]) for i in range(N_HOLD))
    single_held = sum(same_topk(*cpu_index.search(q, params), *singles[i])
                      for i, q in enumerate(qs_np[:len(singles)]))
    hold_s = time.perf_counter() - t
    require(held == N_HOLD, f"kernel path != plain path on {N_HOLD - held} of {N_HOLD} queries")
    require(single_held == len(singles),
            f"resident single search != plain path on {len(singles) - single_held} queries")

    emit(
        "slice", seconds=time.perf_counter() - t0, vectors=N_VECTORS, dim=DIM, nlist=NLIST,
        build_s=build_s, batch_qps=N_QUERIES / batch_s, batch_s=batch_s,
        batch_qps_full_probe=N_ORACLE / full_s,
        single_search_ms_p50=float(np.median(single_ms)), single_search_ms=single_ms,
        serving_qps=256 / serve_s, serving_p50_s=stats["latency_p50"],
        serving_p99_s=stats["latency_p99"], serving_mean_batch=stats["mean_batch"],
        serving_batches=stats["batches"], recall_at_10_nprobe32=recall,
        recall_at_10_full_probe=recall_full, peak_device_gb=peak_gb,
        cluster_scans=launches["packed_scan"], cluster_scan_s=scan_s, oracle_s=oracle_s,
        batch_peak_device_gb=batch_peak_gb, nq_pass_floor_ms=nq_pass_ms,
        path_estimates_nq16_of_256_bitwise=path_nq16, path_probed_share_256=path_share,
        launches=launches, packed_dot_modes=packed_dot_modes, main_path_max_abs_err=errs,
        plain_path_held=f"{held}/{N_HOLD}",
        single_plain_path_held=f"{single_held}/{len(singles)}",
        plain_path_s=hold_s,
        profile_batch_256=prof_batch, packed_scan_timing=scan_timing,
    )
    return {"launches": launches, "errs": errs, "packed_scan_timing": scan_timing,
            "packed_dot_timing": single_timing}


def serve_slice(index, params, qs_np) -> tuple[dict, list, float, dict]:
    """An AnnEndpoint under 16 client threads, 16 queries each."""
    from lakesoul_tpu_torch.vector import AnnEndpoint

    served, errors = {}, []
    with AnnEndpoint(index, params, max_batch=256, max_wait_ms=5) as ep:
        def client(c):
            try:
                for i in range(c * 16, c * 16 + 16):
                    served[i] = ep.search(qs_np[i], timeout=120)
            except Exception as e:  # surfaced by the caller: a failed client fails the phase
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(c,)) for c in range(16)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        serve_s = time.perf_counter() - t
        stats = ep.stats()
    return served, errors, serve_s, stats


@timed_phase
def phase_ex_slice(torch, K, R) -> dict:
    """The slice's data through a 4-bit ex-code index: no kernel of the
    port lies on its search path (the reference computes it outside any
    Pallas kernel), so the path's kernel is the oracle's."""
    from lakesoul_tpu_torch.vector import IvfRabitqIndex, SearchParams, VectorIndexConfig
    from lakesoul_tpu_torch.vector.oracle import recall_at_k

    t0 = time.perf_counter()
    x, queries = make_data(torch, DEVICE)
    torch.cuda.synchronize()
    ids = np.arange(N_VECTORS, dtype=np.uint64)
    qs_np = queries.cpu().numpy()
    cfg = VectorIndexConfig("embedding", DIM, nlist=NLIST, total_bits=EX_BITS, rotator="fht",
                            seed=SEED)
    params = SearchParams(top_k=10, nprobe=32, rerank_depth=100)
    full = SearchParams(top_k=10, nprobe=NLIST, rerank_depth=100)
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path, counted: build → search → batch → serve → oracle
    reset_launches(K, R)
    t = time.perf_counter()
    index = IvfRabitqIndex.train(x, ids, cfg, keep_raw=True)  # device=None: the card
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    require(index.num_vectors == N_VECTORS, "index lost vectors")
    require(index.clusters[0].codes.dtype == torch.int8, "4-bit ex-codes are not int8")
    nonresident = [index.search(q, params) for q in qs_np[:4]]
    index.enable_device_cache()
    index.batch_search(qs_np[:256], params)  # warm-up: concatenates the resident bundle
    t = time.perf_counter()
    b_ids, b_d = index.batch_search(qs_np, params)
    batch_s = time.perf_counter() - t
    t = time.perf_counter()
    f_ids, _ = index.batch_search(qs_np[:N_ORACLE], full)
    full_s = time.perf_counter() - t
    single_ms, singles = [], []
    for q in qs_np[:16]:  # a resident single ex search takes the batch path, one query
        t = time.perf_counter()
        singles.append(index.search(q, params))
        single_ms.append((time.perf_counter() - t) * 1e3)
    served, errors, serve_s, stats = serve_slice(index, params, qs_np)
    t = time.perf_counter()
    top = torch.stack([K.bruteforce_topk(x, qo, 10).indices for qo in queries[:N_ORACLE]])
    oracle_s = time.perf_counter() - t
    launches = read_launches(K, R)
    # ---- end of the counted main path

    require(launches["bruteforce_distances"] > 0, f"the oracle never ran: {launches}")
    require(not errors and len(served) == 256, f"serving failed: {errors[:3]}")
    for i, (ids_i, d_i) in served.items():
        require(same_topk(b_ids[i], b_d[i], ids_i, d_i), f"endpoint result {i} != batch_search")
    require(all(len(r) == 10 and np.isfinite(d).all()
                for r, d in zip(b_ids + [s[0] for s in singles], b_d + [s[1] for s in singles])),
            "ex searches returned short or non-finite results")
    truth = [set(ids[row].tolist()) for row in top.cpu().numpy()]
    recall = recall_at_k(truth, b_ids[:N_ORACLE])
    recall_full = recall_at_k(truth, f_ids)
    require(recall_full >= RECALL_FLOOR, f"ex recall@10 at nprobe=nlist {recall_full} < {RECALL_FLOOR}")
    # a query's answer alone, as in the 256-query batch it rode in above
    alone = [index.batch_search(qs_np[i:i + 1], params) for i in range(16)]
    alone_held = sum(same_topk(b_ids[i], b_d[i], a[0][0], a[1][0]) for i, a in enumerate(alone))
    require(alone_held == 16, f"{16 - alone_held} of 16 answers differ alone and in a batch")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    index.batch_search(qs_np[:256], params)
    batch_peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
    prof_batch = profile(torch, lambda: index.batch_search(qs_np[:256], params))
    g_ids, g_d = index.batch_search(qs_np[:N_HOLD], params)
    del x, top

    # the card's path against the same index on the CPU
    t = time.perf_counter()
    cpu_index = IvfRabitqIndex.from_state(index.state(), device="cpu")
    del index
    nonres_held = sum(same_topk(*cpu_index.search(q, params), *nonresident[i])
                      for i, q in enumerate(qs_np[:4]))
    cpu_index.enable_device_cache()
    c_ids, c_d = cpu_index.batch_search(qs_np[:N_HOLD], params)
    held = sum(same_topk(c_ids[i], c_d[i], g_ids[i], g_d[i]) for i in range(N_HOLD))
    single_held = sum(same_topk(*cpu_index.search(q, params), *singles[i])
                      for i, q in enumerate(qs_np[:len(singles)]))
    hold_s = time.perf_counter() - t
    require(held == N_HOLD, f"ex batch != plain path on {N_HOLD - held} of {N_HOLD} queries")
    require(single_held == len(singles),
            f"resident ex search != plain path on {len(singles) - single_held} queries")
    require(nonres_held == 4, f"non-resident ex search != plain path on {4 - nonres_held} of 4")

    emit(
        "ex_slice", seconds=time.perf_counter() - t0, vectors=N_VECTORS, dim=DIM, nlist=NLIST,
        total_bits=EX_BITS, build_s=build_s, batch_qps=N_QUERIES / batch_s, batch_s=batch_s,
        batch_qps_full_probe=N_ORACLE / full_s,
        single_search_ms_p50=float(np.median(single_ms)), single_search_ms=single_ms,
        serving_qps=256 / serve_s, serving_p50_s=stats["latency_p50"],
        serving_p99_s=stats["latency_p99"], serving_mean_batch=stats["mean_batch"],
        serving_batches=stats["batches"], recall_at_10_nprobe32=recall,
        recall_at_10_full_probe=recall_full, oracle_s=oracle_s, peak_device_gb=peak_gb,
        batch_peak_device_gb=batch_peak_gb, launches=launches,
        alone_in_batch_held=f"{alone_held}/16", plain_path_held=f"{held}/{N_HOLD}",
        single_plain_path_held=f"{single_held}/{len(singles)}",
        nonresident_plain_path_held=f"{nonres_held}/4", plain_path_s=hold_s,
        profile_batch_256=prof_batch,
    )
    return {"launches": launches}


def plane_chunks(torch, dev, n: int):
    """The scale leg's clustered corpus, generated on the card chunk by
    chunk: 4096 centres of scale 3.0 plus unit noise
    (``_ann_scale_corpus_chunks``).  Yields ``(lo, hi, rows)``, then
    returns the generator and the centres for the queries' draw."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    centers = torch.randn(PLANE_CENTERS, PLANE_DIM, device=dev, generator=g) * 3.0
    for lo in range(0, n, PLANE_CHUNK):
        hi = min(n, lo + PLANE_CHUNK)
        comp = torch.randint(0, PLANE_CENTERS, (hi - lo,), device=dev, generator=g)
        yield lo, hi, centers[comp] + torch.randn(hi - lo, PLANE_DIM, device=dev, generator=g)
    return g, centers


def make_plane_data(torch, dev, n: int, n_q: int):
    """The corpus of :func:`plane_chunks` whole, and fresh draws of the same
    mixture as queries."""
    x = torch.empty((n, PLANE_DIM), device=dev)
    chunks = plane_chunks(torch, dev, n)
    while True:
        try:
            lo, hi, rows = next(chunks)
        except StopIteration as done:
            g, centers = done.value
            break
        x[lo:hi] = rows
    comp = torch.randint(0, PLANE_CENTERS, (n_q,), device=dev, generator=g)
    return x, centers[comp] + torch.randn(n_q, PLANE_DIM, device=dev, generator=g)


def plane_stream(x, n: int):
    for lo in range(0, n, PLANE_CHUNK):
        hi = min(n, lo + PLANE_CHUNK)
        yield x[lo:hi], np.arange(lo, hi, dtype=np.uint64)


def serve_plane(ep, qs_np) -> tuple[dict, list, float]:
    """``SERVE_CLIENTS`` threads, each keeping ``SERVE_DEPTH`` submits in
    flight (``_ann_serve_qps``), every request with its own nprobe."""
    served, errors = {}, []
    lock = threading.Lock()

    def client(ci):
        try:
            inflight = collections.deque()
            for j in range(SERVE_PER_CLIENT):
                qi, npb = (ci * 31 + j) % len(qs_np), PLANE_MIXED[(ci + j) % len(PLANE_MIXED)]
                inflight.append(((qi, npb), ep.submit(qs_np[qi], nprobe=npb)))
                if len(inflight) >= SERVE_DEPTH:
                    key, fut = inflight.popleft()
                    res = fut.result(timeout=300)
                    with lock:
                        served[key] = res
            while inflight:
                key, fut = inflight.popleft()
                res = fut.result(timeout=300)
                with lock:
                    served[key] = res
        except Exception as e:  # surfaced by the caller: a failed client fails the phase
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(SERVE_CLIENTS)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    return served, errors, time.perf_counter() - t


def gateway_clients(workdir: str) -> int:
    """``chip_smoke.py --gateway-clients DIR``: :func:`serve_gateway` in a
    process of its own, so the clients' threads do not share the gateway's
    interpreter.  Reads ``DIR/args.json`` (location, token and the parent's
    traffic sizes) and ``DIR/queries.npy``; writes ``DIR/answers.json``."""
    global SERVE_CLIENTS, SERVE_PER_CLIENT, PLANE_MIXED
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(workdir, "args.json")) as f:
        args = json.load(f)
    SERVE_CLIENTS, SERVE_PER_CLIENT = args["clients"], args["per_client"]
    PLANE_MIXED = tuple(args["mixed"])
    answers, lat, errors, wall = serve_gateway(args["location"], args["token"],
                                               np.load(os.path.join(workdir, "queries.npy")))
    with open(os.path.join(workdir, "answers.json"), "w") as f:
        json.dump({"answers": [[list(k), a] for k, a in answers], "lat": lat, "errors": errors,
                   "wall": wall}, f)
    return 0


def serve_gateway(loc: str, token: str, qs_np) -> tuple[list, list, list, float]:
    """``serve_plane``'s traffic through the gateway's ``ann_search``:
    SERVE_CLIENTS threads, each a Flight client sending its SERVE_PER_CLIENT
    requests one after another, the same (query, nprobe) keys.  Returns
    (key, answer) pairs, latencies in s, errors and the wall seconds."""
    from lakesoul_tpu_torch.service import LakeSoulFlightClient

    answers, lat, errors = [], [], []
    lock = threading.Lock()

    def client(ci):
        try:
            c = LakeSoulFlightClient(loc, token=token)
            for j in range(SERVE_PER_CLIENT):
                qi, npb = (ci * 31 + j) % len(qs_np), PLANE_MIXED[(ci + j) % len(PLANE_MIXED)]
                t0 = time.perf_counter()
                raw = c.action("ann_search", {"plane": "plane4", "query": qs_np[qi].tolist(),
                                              "nprobe": int(npb)})[0]
                dt = time.perf_counter() - t0
                with lock:
                    answers.append(((qi, int(npb)), json.loads(raw)))
                    lat.append(dt)
        except Exception as e:  # surfaced by the caller: a failed client fails the phase
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(SERVE_CLIENTS)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    return answers, lat, errors, time.perf_counter() - t


def same_answer(ans: dict, ids, dists) -> bool:
    """A gateway answer (JSON) = an in-process answer, ids and float32
    distances bit for bit."""
    return (ans["ids"] == [int(i) for i in ids]
            and np.array_equal(np.asarray(ans["distances"], np.float32),
                               np.asarray(dists, np.float32)))


@timed_phase
def phase_gateway_ann(torch, K, R, L, plane, params, qs_np, served: dict, endpoint: dict,
                      wh: str, kind: str) -> dict:
    """The 4-bit plane served over Flight: an in-process
    ``LakeSoulFlightServer`` (a JWT secret) on the table the plane was built
    from, the plane bound as ``AnnPlaneBinding(ShardedAnnEndpoint(plane,
    ...), "default", "corpus")``; a user registered in the table's metadata
    logs in (basic credentials → bearer), then ``serve_plane``'s traffic
    goes through ``ann_search`` from a client process of its own
    (``--gateway-clients``).  Every answer must equal the in-process
    endpoint's for the same (query, nprobe) exactly, and ``ragged_score``
    must launch (counted from 0 around the traffic)."""
    from lakesoul_tpu_torch.annplane import AnnPlaneBinding, ShardedAnnEndpoint
    from lakesoul_tpu_torch.service import LakeSoulFlightClient, LakeSoulFlightServer
    from lakesoul_tpu_torch.service.jwt import UserRegistry

    catalog = L.LakeSoulCatalog(wh)
    password = secrets.token_hex(8)
    UserRegistry(catalog.client).register("chip_smoke", password)
    t0 = time.perf_counter()
    with ShardedAnnEndpoint(plane, params, max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS,
                            max_pending=2 * SERVE_CLIENTS * SERVE_DEPTH,
                            name="chip_smoke_gateway") as ep:
        server = LakeSoulFlightServer(catalog, jwt_secret=secrets.token_hex(16), device=DEVICE,
                                      ann_planes={"plane4": AnnPlaneBinding(ep, "default",
                                                                            "corpus")})
        threading.Thread(target=server.serve, daemon=True).start()
        try:
            loc = f"grpc://127.0.0.1:{server.port}"
            token = LakeSoulFlightClient(loc, basic_auth=("chip_smoke", password)).login()
            setup_s = time.perf_counter() - t0
            LakeSoulFlightClient(loc, token=token).action(
                "ann_search", {"plane": "plane4", "query": qs_np[0].tolist()})  # warm
            cdir = tempfile.mkdtemp(prefix="chip_smoke_clients_")
            with open(os.path.join(cdir, "args.json"), "w") as f:
                json.dump({"location": loc, "token": token, "clients": SERVE_CLIENTS,
                           "per_client": SERVE_PER_CLIENT, "mixed": list(PLANE_MIXED)}, f)
            np.save(os.path.join(cdir, "queries.npy"), qs_np)
            reset_launches(K, R)
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--gateway-clients",
                                   cdir], capture_output=True, text=True, timeout=900)
            launches = read_launches(K, R)
            stats = ep.stats()
            require(proc.returncode == 0, f"the gateway's clients exited {proc.returncode}: "
                                          f"{proc.stderr[-3000:]}")
            with open(os.path.join(cdir, "answers.json")) as f:
                out = json.load(f)
            shutil.rmtree(cdir, ignore_errors=True)
            answers = [(tuple(k), a) for k, a in out["answers"]]
            lat, errors, wall = out["lat"], out["errors"], out["wall"]
        finally:
            server.shutdown()
    n_req = SERVE_CLIENTS * SERVE_PER_CLIENT
    held = sum(same_answer(ans, *served[key]) for key, ans in answers)
    lat_ms = np.array(lat) * 1e3 if lat else np.zeros(1)
    rec = {"config": f"4-bit plane behind LakeSoulFlightServer ann_search, {SERVE_CLIENTS} "
                     f"clients x {SERVE_PER_CLIENT} at mixed nprobe {list(PLANE_MIXED)}",
           "device_kind": kind, "requests": len(answers), "setup_s": setup_s,
           "qps": len(answers) / wall, "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)), "endpoint_qps": endpoint["qps"],
           "endpoint_p50_ms": endpoint["p50_s"] * 1e3, "endpoint_p99_ms": endpoint["p99_s"] * 1e3,
           "mean_batch": stats["mean_batch"], "held_exactly": f"{held}/{len(answers)}",
           "launches": launches, "errors": errors[:3]}
    emit("gateway_ann", **rec)
    require(not errors and len(answers) == n_req, f"gateway clients failed: {errors[:3]}")
    require(held == n_req, f"{n_req - held} of {n_req} gateway answers != the endpoint's")
    require(launches["ragged_score"] > 0, f"ragged_score never ran behind the gateway: "
                                          f"{launches}")
    return {"launches": launches}


def plane_digests(root: str) -> list:
    """One sha256 a shard of a plane directory: over its centroids and the
    bytes of every array of every segment, field by field (the npz files
    themselves carry their write times)."""
    from lakesoul_tpu_torch.annplane import PlaneManifestStore
    from lakesoul_tpu_torch.annplane.build import shard_root
    from lakesoul_tpu_torch.vector.manifest import ManifestStore

    out = []
    for e in PlaneManifestStore(root).read()["shards"]:
        store = ManifestStore(shard_root(root, e["shard"]))
        st = store.state(store.read_manifest_at(e["generation"]))
        h = hashlib.sha256(np.ascontiguousarray(st["centroids"]).tobytes())
        for seg in st["clusters"] + sum(st["deltas"], []):
            for f in sorted(seg):
                h.update(f.encode() + np.ascontiguousarray(seg[f]).tobytes())
        out.append(h.hexdigest()[:16])
    return out


def plane_config(bits: int):
    from lakesoul_tpu_torch.annplane import AnnPlaneConfig
    from lakesoul_tpu_torch.vector import VectorIndexConfig

    index_cfg = VectorIndexConfig("emb", PLANE_DIM, nlist=PLANE_NLIST, total_bits=bits, seed=SEED)
    return AnnPlaneConfig(index=index_cfg, shard_budget_bytes=PLANE_BUDGET, keep_raw=True)


def corpus_digest(chunks) -> float:
    """Float64 sums over the corpus's chunks: the two processes' corpora
    agree."""
    return sum(float(rows.double().sum()) for rows in chunks)


def plane_table_build(workdir: str) -> int:
    """The 4-bit plane's build leg, the scale leg's own route
    (``benchmarks/micro.py:1382-1415``), run as ``chip_smoke.py
    --plane-table DIR`` in a process of its own so that its peak RSS is the
    leg's: the scale leg's corpus (``make_plane_data``, the same seeded draw
    as the parent's) written as a non-PK LSF table (``id`` int64, ``emb``
    FixedSizeList<float32, 128>), then ``ShardedAnnBuilder(root, cfg).build(
    iter_table_vectors(table, "emb", "id", batch_size=262_144))`` into
    ``DIR/plane``.  Prints one JSON line: write and build seconds, the RSS
    at the leg's start and the build's peak, the manifest, the corpus
    digest."""
    import pyarrow as pa
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lakesoul_tpu_torch as L
    from lakesoul_tpu_torch.annplane import ShardedAnnBuilder, iter_table_vectors

    rss_before_cuda = rss_mb()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.zeros(1, device=DEVICE)  # the CUDA context, before the leg starts
    schema = pa.schema([("id", pa.int64()), ("emb", pa.list_(pa.float32(), PLANE_DIM))])
    sums = []
    with RssPeak() as rss:
        t = L.LakeSoulCatalog(os.path.join(workdir, "wh")).create_table(
            "corpus", schema, properties={"lakesoul.file_format": "lsf"})
        t0 = time.perf_counter()
        for lo, hi, rows in plane_chunks(torch, DEVICE, PLANE_ROWS):
            sums.append(float(rows.double().sum()))
            t.write_arrow(pa.table({
                "id": np.arange(lo, hi, dtype=np.int64),
                "emb": pa.FixedSizeListArray.from_arrays(
                    pa.array(rows.cpu().numpy().reshape(-1)), PLANE_DIM)}, schema=schema))
            del rows
        write_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        manifest = ShardedAnnBuilder(os.path.join(workdir, "plane"), plane_config(4)).build(
            iter_table_vectors(t, "emb", "id", batch_size=PLANE_TABLE_BATCH))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    print(json.dumps({"write_s": write_s, "build_s": build_s, "rss_before_cuda_mb": rss_before_cuda,
                      "rss_start_mb": rss.start_mb,
                      "build_peak_rss_mb": rss.peak_mb,
                      "peak_device_reserved_mb": torch.cuda.max_memory_reserved() / 2**20,
                      "table_bytes": dir_bytes(os.path.join(workdir, "wh")),
                      "corpus_digest": sum(sums), "manifest": manifest}), flush=True)
    return 0


def build_plane_from_table(torch, x, workdir: str) -> tuple[dict, dict]:
    """Run :func:`plane_table_build` in a child process and hold its
    record: the plane complete with every row, the same corpus as ``x``,
    and micro.py's RSS ceiling when the leg started under half of it."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--plane-table", workdir],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        print(proc.stderr[-8000:], file=sys.stderr)
    require(proc.returncode == 0, f"the plane's table build exited {proc.returncode}")
    leg = json.loads(proc.stdout.strip().splitlines()[-1])
    manifest = leg.pop("manifest")
    leg["rss_gate_armed"] = leg["rss_start_mb"] < 0.5 * ANN_SCALE_RSS_CEILING_MB
    leg["rss_ceiling_mb"] = ANN_SCALE_RSS_CEILING_MB
    leg["rss_growth_mb"] = leg["build_peak_rss_mb"] - leg["rss_start_mb"]
    emit("plane_table_leg", **leg, shards=len(manifest["shards"]))
    require(manifest["complete"] and manifest["total_rows"] == PLANE_ROWS,
            f"the table-built plane: complete {manifest['complete']}, "
            f"{manifest['total_rows']} rows")
    require(leg["corpus_digest"] == corpus_digest(
                x[lo:lo + PLANE_CHUNK] for lo in range(0, PLANE_ROWS, PLANE_CHUNK)),
            "the table build's corpus differs from this process's")
    if leg["rss_gate_armed"]:
        require(leg["build_peak_rss_mb"] <= ANN_SCALE_RSS_CEILING_MB,
                f"the build's peak RSS {leg['build_peak_rss_mb']} MB > "
                f"{ANN_SCALE_RSS_CEILING_MB}")
    else:
        # a process with a CUDA context can start above half the ceiling
        # before the leg does anything (the card's sandbox reports ~4.9 GB):
        # hold the leg's own growth to what the rule lets an armed start
        # grow, half the ceiling
        require(leg["rss_growth_mb"] <= 0.5 * ANN_SCALE_RSS_CEILING_MB,
                f"the build's RSS grew {leg['rss_growth_mb']} MB over the leg, more than "
                f"half of {ANN_SCALE_RSS_CEILING_MB}")
    return manifest, leg


def table_plane_hold(torch, L, x, qs_np, cfg, params, workdir: str) -> dict:
    """``build_table_ann_plane`` over SMALL_PLANE_ROWS of the corpus in a
    primary-key table (``hash_bucket_num=4``, LSF): the plane opened on the
    card must answer N_PLANE_HOLD queries as it does opened on the CPU,
    which runs ``ragged_topk_host`` and the native re-rank, ties aside."""
    import pyarrow as pa

    from lakesoul_tpu_torch.annplane import AnnPlane, build_table_ann_plane

    schema = pa.schema([("id", pa.int64()), ("emb", pa.list_(pa.float32(), PLANE_DIM))])
    t = L.LakeSoulCatalog(os.path.join(workdir, "small_wh")).create_table(
        "small", schema, primary_keys=["id"], hash_bucket_num=FEED_BUCKETS,
        properties={"lakesoul.file_format": "lsf"})
    t.write_arrow(pa.table({
        "id": np.arange(SMALL_PLANE_ROWS, dtype=np.int64),
        "emb": pa.FixedSizeListArray.from_arrays(
            pa.array(x[:SMALL_PLANE_ROWS].cpu().numpy().reshape(-1)), PLANE_DIM)},
        schema=schema))
    t0 = time.perf_counter()
    manifest = build_table_ann_plane(t, "emb", config=cfg)
    build_s = time.perf_counter() - t0
    require(manifest["complete"] and manifest["total_rows"] == SMALL_PLANE_ROWS,
            "build_table_ann_plane lost rows")
    root = f"{t.info.table_path}/_ann_plane/emb"
    on_card, on_cpu = AnnPlane.open(root), AnnPlane.open(root, device="cpu")
    g_ids, g_d = on_card.batch_search(qs_np[:N_PLANE_HOLD], params)
    c_ids, c_d = on_cpu.batch_search(qs_np[:N_PLANE_HOLD], params)
    held = sum(same_topk(c_ids[i], c_d[i], g_ids[i], g_d[i]) for i in range(N_PLANE_HOLD))
    require(held == N_PLANE_HOLD, f"the table-built plane on the card != on the CPU "
                                  f"(ragged_topk_host) on {N_PLANE_HOLD - held} queries")
    return {"rows": SMALL_PLANE_ROWS, "shards": len(manifest["shards"]), "build_s": build_s,
            "card_equals_cpu_host_path": f"{held}/{N_PLANE_HOLD}"}


@timed_phase
def phase_repro(torch, x) -> dict:
    """``kmeans`` twice from one seed on one plane shard's rows: the
    centroids and assignments must be bitwise equal."""
    from lakesoul_tpu_torch.vector.kmeans import kmeans

    rows = x[:REPRO_ROWS]
    runs, secs = [], []
    for _ in range(2):
        t = time.perf_counter()
        runs.append(kmeans(rows, PLANE_NLIST, iters=10, seed=SEED))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    (c1, a1), (c2, a2) = runs
    same = {"centroids": torch.equal(c1, c2), "assignments": torch.equal(a1, a2)}
    require(all(same.values()), f"kmeans is not reproducible: {same}")
    emit("repro", rows=REPRO_ROWS, dim=PLANE_DIM, k=PLANE_NLIST, iters=10, kmeans_s=secs,
         bitwise_equal=same)
    return {"kmeans_s": secs}


@timed_phase
def phase_plane(torch, K, R, x, queries, bits: int, top=None) -> dict:
    """One plane at ``bits`` over the corpus ``x``.  ``top``: the oracle's
    exact top-10 rows of the first N_ORACLE queries, from an earlier plane
    of the same corpus; None takes it here, in the counted path."""
    from lakesoul_tpu_torch.annplane import (
        AnnPlane,
        AnnPlaneConfig,
        ShardedAnnBuilder,
        ShardedAnnEndpoint,
    )
    from lakesoul_tpu_torch.vector import SearchParams
    from lakesoul_tpu_torch.vector.oracle import recall_at_k

    import lakesoul_tpu_torch as L

    t0 = time.perf_counter()
    dev = DEVICE
    qs_np = queries.cpu().numpy()
    cfg = plane_config(bits)
    index_cfg = cfg.index
    from_table = bits == PLANE_TABLE_BITS
    params = SearchParams(top_k=10, nprobe=PLANE_NPROBE, rerank_depth=PLANE_RERANK)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_plane_")
    try:
        root = os.path.join(workdir, "plane")
        torch.cuda.reset_peak_memory_stats()

        # ---- the main path, counted: build → open → batch → serve → oracle
        reset_launches(K, R)
        table_leg = None
        if from_table:  # the scale leg's route: a table, then the bounded scan
            manifest, table_leg = build_plane_from_table(torch, x, workdir)
            build_s = table_leg["build_s"]
        else:
            t = time.perf_counter()
            manifest = ShardedAnnBuilder(root, cfg).build(plane_stream(x, PLANE_ROWS))
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t
        require(manifest["complete"] and manifest["total_rows"] == PLANE_ROWS,
                "the plane lost rows")
        t = time.perf_counter()
        plane = AnnPlane.open(root)  # device=None: the card
        torch.cuda.synchronize()
        open_s = time.perf_counter() - t
        require(plane.num_vectors == PLANE_ROWS, "the opened plane lost rows")
        plane.batch_search(qs_np[:64], params)  # warm-up
        t = time.perf_counter()
        b_ids, b_d = plane.batch_search(qs_np, params)
        batch_s = time.perf_counter() - t
        mixed = np.array([PLANE_MIXED[i % len(PLANE_MIXED)] for i in range(64)], np.int64)
        m_ids, m_d = plane.batch_search(qs_np[:64], params, nprobes=mixed)
        single = [plane.search(qs_np[i], SearchParams(top_k=10, nprobe=int(mixed[i]),
                                                      rerank_depth=PLANE_RERANK))
                  for i in range(64)]
        with ShardedAnnEndpoint(plane, params, max_batch=SERVE_MAX_BATCH,
                                max_wait_ms=SERVE_WAIT_MS,
                                max_pending=2 * SERVE_CLIENTS * SERVE_DEPTH,
                                name=f"chip_smoke_plane_{bits}bit") as ep:
            ep.search(qs_np[0])  # warm the dispatch path
            served, errors, serve_s = serve_plane(ep, qs_np)
            stats = ep.stats()
        t = time.perf_counter()
        oracle_here = top is None
        if oracle_here:
            top = torch.stack([K.bruteforce_topk(x, qo, 10).indices
                               for qo in queries[:N_ORACLE]]).cpu().numpy()
        oracle_s = time.perf_counter() - t
        launches = read_launches(K, R)
        # ---- end of the counted main path

        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        on_path = ("ragged_score", "bruteforce_distances") if oracle_here else ("ragged_score",)
        require(all(launches[k] for k in on_path),
                f"a kernel never ran on the plane's path: {launches}")
        require(all(len(r) == 10 and np.isfinite(d).all() for r, d in zip(b_ids, b_d)),
                "batch_search returned short or non-finite results")
        for i in range(64):
            require(same_topk(single[i][0], single[i][1], m_ids[i], m_d[i]),
                    f"mixed-nprobe batch result {i} != its own search")
        n_req = SERVE_CLIENTS * SERVE_PER_CLIENT
        require(not errors and stats["requests"] == n_req + 1, f"serving failed: {errors[:3]}")
        keys = sorted(served)
        want_ids, want_d = [], []
        for lo in range(0, len(keys), SERVE_MAX_BATCH):
            chunk = keys[lo:lo + SERVE_MAX_BATCH]
            w = plane.batch_search(qs_np[[k[0] for k in chunk]], params,
                                   nprobes=np.array([k[1] for k in chunk]))
            want_ids += w[0]
            want_d += w[1]
        for key, wi, wd in zip(keys, want_ids, want_d):
            require(same_topk(wi, wd, *served[key]), f"endpoint result {key} != batch_search")
        truth = [set(row.tolist()) for row in top]
        recall = recall_at_k(truth, b_ids[:N_ORACLE])
        floor = LEG_RECALL_FLOOR if bits == 4 else RECALL_FLOOR
        require(recall >= floor, f"{bits}-bit plane recall@10 {recall} < {floor}")
        # the plane behind the Flight gateway (the 4-bit plane: it has the
        # table it was built from to check RBAC against)
        gateway = (phase_gateway_ann(
            torch, K, R, L, plane, params, qs_np, served,
            {"qps": n_req / serve_s, "p50_s": stats["latency_p50"],
             "p99_s": stats["latency_p99"]}, os.path.join(workdir, "wh"), device_kind(torch))
            if from_table else None)
        prof = profile(torch, lambda: plane.batch_search(qs_np, params))

        # ragged_score on every shard's real item tables from one 256-query
        # batch, against its plain version on the card; timed on the 1024-
        # query batch's tables of the shard with the most items
        qt = torch.as_tensor(qs_np, device=dev)

        def shard_tables(nq):
            nprobes = np.full(nq, PLANE_NPROBE, np.int64)
            pq, pgc, csq, csum, q_glob = plane.probe_pairs(qt[:nq], nprobes)
            sel = plane.shard_of[pgc]
            for si, sh in enumerate(plane.shards):
                m = sel == si
                yield sh, q_glob, R.plan_items(pq[m], plane.local_cluster[pgc[m]], csq[m],
                                               csum[m], sh.tile_start, sh.tile_count)

        ragged_err, ragged_items = 0.0, 0
        for sh, q_glob, items in shard_tables(N_ORACLE):
            ragged_err = max(ragged_err, ragged_check(torch, R, items, q_glob, sh.codes, sh.a,
                                                      sh.b, sh.h))
            ragged_items += len(items[0])
        sh, q_glob, items = max(shard_tables(N_QUERIES), key=lambda t: len(t[2][0]))
        ragged_err = max(ragged_err, ragged_check(torch, R, items, q_glob, sh.codes, sh.a, sh.b,
                                                  sh.h))
        invariance = ragged_invariance(torch, R, items, q_glob, sh)
        require(invariance["batch16"] and all(invariance["alone"]),
                f"ragged_score scores depend on the batch: {invariance}")
        t_items = [torch.from_numpy(np.asarray(v)).to(dev) for v in items]
        n_tiles = len(sh.codes) // sh.tile
        # the grouping adds no sync between host and device: the debug mode
        # raises on any
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            R.group_items_by_tile(t_items[1], n_tiles)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        b_ms, b_by, b_work = ragged_bound(items, q_glob, sh.codes)
        tiles_view = sh.codes.view(-1, 128, PLANE_DIM)

        def score():
            return R.ragged_score(*items, q_glob, sh.codes, sh.a, sh.b, sh.h)

        ragged_timing = {
            "ms": time_ms(torch, score, 20),
            "device_ms": device_ms_per_launch(torch, score, 20, "ragged_score_kernel"),
            "grouping_ms": time_ms(torch, lambda: R.group_items_by_tile(t_items[1], n_tiles), 20),
            "grouping_device_ms": device_ms_per_launch(
                torch, lambda: R.group_items_by_tile(t_items[1], n_tiles), 20, ""),
            "plain_ms": time_ms(torch, lambda: R.ragged_score_torch(
                *t_items, q_glob, sh.codes, sh.a, sh.b, sh.h), 5),
            "library_ms": time_ms(torch, lambda: torch.bmm(
                tiles_view[t_items[1].long()], q_glob[t_items[0].long(), :, None]), 5),
            "bound_ms": b_ms, "bound_by": b_by, "shape": b_work,
            "batch_invariance": invariance,
        }
        del t_items, tiles_view, plane, sh, q_glob
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()

        # reproducible: a small plane built twice gives equal shard digests;
        # the kernel path against the plain path: that plane opened on the
        # card and on the CPU
        small_cfg = AnnPlaneConfig(
            index=index_cfg, keep_raw=True,
            shard_budget_bytes=SMALL_PLANE_ROWS // SMALL_PLANE_SHARDS * cfg.bytes_per_vector(),
        )
        digests = []
        for i in range(2):
            small_root = os.path.join(workdir, f"small{i}")
            ShardedAnnBuilder(small_root, small_cfg).build(plane_stream(x, SMALL_PLANE_ROWS))
            digests.append(plane_digests(small_root))
        require(len(digests[0]) == SMALL_PLANE_SHARDS and digests[0] == digests[1],
                f"the small plane built twice differs: {digests}")
        t = time.perf_counter()
        on_card, on_cpu = AnnPlane.open(small_root), AnnPlane.open(small_root, device="cpu")
        g_ids, g_d = on_card.batch_search(qs_np[:N_PLANE_HOLD], params)
        c_ids, c_d = on_cpu.batch_search(qs_np[:N_PLANE_HOLD], params)
        held = sum(same_topk(c_ids[i], c_d[i], g_ids[i], g_d[i]) for i in range(N_PLANE_HOLD))
        hold_s = time.perf_counter() - t
        require(held == N_PLANE_HOLD,
                f"plane kernel path != plain path on {N_PLANE_HOLD - held} of {N_PLANE_HOLD}")
        del on_card, on_cpu
        table_hold = (table_plane_hold(torch, L, x, qs_np, small_cfg, params, workdir)
                      if from_table else None)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    emit(
        "plane", seconds=time.perf_counter() - t0, total_bits=bits, vectors=PLANE_ROWS,
        dim=PLANE_DIM, nlist_per_shard=PLANE_NLIST, shards=len(manifest["shards"]),
        rows_per_shard=manifest["rows_per_shard"], shard_budget_bytes=PLANE_BUDGET,
        reduced=(None if from_table else
                 {"corpus": "generated on the card, not written to and scanned from a table "
                            "(the 4-bit plane takes the table route)"}),
        table_leg=table_leg, table_plane_hold=table_hold, build_s=build_s, open_s=open_s, peak_device_gb=peak_gb,
        batch_qps=N_QUERIES / batch_s, batch_s=batch_s, nprobe=PLANE_NPROBE,
        rerank_depth=PLANE_RERANK, mixed_nprobe_batch_held="64/64",
        serving_qps=n_req / serve_s, serving_p50_s=stats["latency_p50"],
        serving_p99_s=stats["latency_p99"], serving_mean_batch=stats["mean_batch"],
        serving_batches=stats["batches"], serving_requests=n_req,
        endpoint_held=f"{len(keys)}/{len(keys)} distinct (query, nprobe)",
        recall_at_10=recall, recall_floor=floor, oracle_taken_here=oracle_here,
        oracle_s=oracle_s, launches=launches, ragged_main_path_max_abs_err=ragged_err,
        ragged_items_checked=ragged_items, ragged_timing=ragged_timing,
        small_plane_digests=digests[0], small_plane_digests_equal=True,
        plain_path_held=f"{held}/{N_PLANE_HOLD}", plain_path_s=hold_s,
        profile_batch_1024=prof,
    )
    return {"launches": launches, "errs": {"ragged_score": ragged_err},
            "ragged_timing": ragged_timing, "top": top, "gateway": gateway}


def make_synthetic_titanic(n: int = TITANIC_ROWS, seed: int = SEED) -> dict:
    """Synthetic passengers with a survival rule the MLP can learn: the
    copy of ``examples/titanic_mlp.py:23-41`` that returns numpy columns,
    not a table."""
    rng = np.random.default_rng(seed)
    pclass = rng.integers(1, 4, n).astype(np.int32)
    age = np.clip(rng.normal(30, 14, n), 1, 80).astype(np.float32)
    fare = (rng.gamma(2.0, 15.0, n) * (4 - pclass)).astype(np.float32)
    sex = rng.integers(0, 2, n).astype(np.int32)  # 1 = female
    logits = 1.8 * sex - 0.9 * (pclass - 2) - 0.02 * (age - 30) + 0.01 * fare
    survived = (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(np.int32)
    return {"passenger_id": np.arange(n, dtype=np.int64), "pclass": pclass, "age": age,
            "fare": fare, "sex": sex, "survived": survived}


def titanic_features(cols: dict) -> np.ndarray:
    """The example's transform: the feature columns, standardised over the
    rows given (per batch in training)."""
    x = np.stack([cols[c].astype(np.float32) for c in TITANIC_FEATURES], axis=1)
    return (x - x.mean(0)) / (x.std(0) + 1e-6)


def train_steps(torch, step, batch) -> dict:
    """WARMUP_STEPS then TIMED_STEPS of ``step(*batch)`` on one fixed batch,
    each timed steps between CUDA events.  Requires every loss finite and the
    mean of the last LOSS_WINDOW losses below the mean of the first."""
    losses = [step(*batch) for _ in range(WARMUP_STEPS)]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    events[0].record()
    for i in range(TIMED_STEPS):
        losses.append(step(*batch))
        events[i + 1].record()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
    losses = [float(v) for v in losses]
    require(all(np.isfinite(losses)), f"a non-finite training loss: {losses}")
    first, last = np.mean(losses[:LOSS_WINDOW]), np.mean(losses[-LOSS_WINDOW:])
    require(last < first, f"the loss did not fall: first {first}, last {last}")
    return {"step_ms": float(np.median(ms)), "step_ms_all": ms, "losses": losses,
            "loss_first_mean": float(first), "loss_last_mean": float(last)}


def hold_card_to_cpu(torch, M, C, model, make_cpu, run, leaves, *, f64_grads=False) -> dict:
    """Card = CPU at full width: ``model``'s weights carried to a CPU copy
    (``make_cpu``) through the reference's param tree, then ``run(m, dev)``
    → (loss, logits) on both.  float32: loss and logits rtol HOLD_RTOL
    (logits atol HOLD_RTOL · max |logit|), the gradients of ``leaves`` atol
    HOLD_GRAD_ATOL · max |g|; bf16: the loss within HOLD_BF16_LOSS relative.
    The card's float32 and bf16 model is ``model`` itself, its compute dtype
    switched for the check and restored.

    ``f64_grads`` (ResNet-50): a randomly initialised 50-layer net with batch
    statistics on 2 images has a float32 gradient that float32 cannot
    resolve — the CPU's own float32 gradients lie up to ~20 % from their
    float64 values, and a 1-ulp change of the input moves them as much.  So
    the gradients are held card = CPU at float64 instead (both models
    converted; the same atol), and at float32 the card's distance from the
    float64 gradient must be at most HOLD_F32_SPREAD × the CPU's own (or
    HOLD_GRAD_ATOL, if larger)."""
    import dataclasses

    sd = C.from_reference_params(C.to_reference_params(model))
    cpu = make_cpu()
    cpu.load_state_dict(sd)
    train_cfg, got = model.cfg, {}
    sides = [("float32", "card", DEVICE, model), ("float32", "cpu", "cpu", cpu),
             ("bfloat16", "card", DEVICE, model), ("bfloat16", "cpu", "cpu", cpu)]
    if f64_grads:
        card64, cpu64 = make_cpu().double(), make_cpu().double()
        card64.load_state_dict(sd)
        cpu64.load_state_dict(sd)
        sides += [("float64", "card", DEVICE, card64.to(DEVICE)), ("float64", "cpu", "cpu", cpu64)]
    try:
        for dtype, side, dev, m in sides:
            m.cfg = dataclasses.replace(train_cfg, dtype=dtype)
            m.zero_grad(set_to_none=True)
            t = time.perf_counter()
            loss, logits = run(m, dev)
            grads = {}
            if dtype != "bfloat16":
                loss.backward()
                named = dict(m.named_parameters())
                grads = {k: named[k].grad.detach().double().cpu() for k in leaves}
            got[dtype, side] = (loss.item(), logits.detach().double().cpu(), grads,
                                time.perf_counter() - t)
            m.zero_grad(set_to_none=True)
    finally:
        model.cfg = train_cfg
        model.zero_grad(set_to_none=True)

    def rel(a, b):  # max |a - b| over max |b|, per leaf
        return {k: ((a[k] - b[k]).abs().max() / b[k].abs().max()).item() for k in leaves}

    out, ok = {}, {}
    for dtype in ("float32", "bfloat16", "float64")[:3 if f64_grads else 2]:
        (lc, xc, gc, tc), (lp, xp, gp, tp) = got[dtype, "card"], got[dtype, "cpu"]
        rec = {"loss_card": lc, "loss_cpu": lp, "loss_rel_err": abs(lc - lp) / abs(lp),
               "card_s": tc, "cpu_s": tp}
        if dtype == "bfloat16":
            ok["bfloat16_loss"] = rec["loss_rel_err"] <= HOLD_BF16_LOSS
        else:
            err = (xc - xp).abs()
            rec["logits_max_abs_err"] = err.max().item()
            rec["logits_err_over_tol"] = (err / (HOLD_RTOL * (xp.abs() + xp.abs().max()))
                                          ).max().item()
            rec["grad_err_over_max"] = rel(gc, gp)
            ok[f"{dtype}_loss"] = rec["loss_rel_err"] <= HOLD_RTOL
            ok[f"{dtype}_logits"] = rec["logits_err_over_tol"] <= 1.0
        out[dtype] = rec
    f32 = out["float32"]
    if f64_grads:
        truth = got["float64", "cpu"][2]
        f32["card_grad_from_f64"] = rel(got["float32", "card"][2], truth)
        f32["cpu_grad_from_f64"] = rel(got["float32", "cpu"][2], truth)
        ok["float32_grads_within_cpu_spread"] = all(
            f32["card_grad_from_f64"][k] <= max(HOLD_GRAD_ATOL,
                                                HOLD_F32_SPREAD * f32["cpu_grad_from_f64"][k])
            for k in leaves)
        ok["float64_grads"] = all(v <= HOLD_GRAD_ATOL
                                  for v in out["float64"]["grad_err_over_max"].values())
    else:
        ok["float32_grads"] = all(v <= HOLD_GRAD_ATOL for v in f32["grad_err_over_max"].values())
    out["held"] = {"loss_rtol": HOLD_RTOL, "logits_rtol": HOLD_RTOL,
                   "logits_atol_of_max": HOLD_RTOL, "grad_atol_of_max": HOLD_GRAD_ATOL,
                   "grads_at": "float64" if f64_grads else "float32",
                   "bfloat16_loss_rel": HOLD_BF16_LOSS}
    if f64_grads:
        out["held"]["float32_grads_within_cpu_spread_x"] = HOLD_F32_SPREAD
    out["ok"] = ok
    return out


def resnet_flops(model, img: int) -> float:
    """Model FLOPs of one training step per image: 2 × the multiply-adds of
    every conv and of the head, from the model's own weight shapes and the
    SAME output sizes (ceil(in / stride)), × 3 for forward and backward."""
    def conv_macs(w, size):
        return size * size * w.shape[0] * w.shape[1] * w.shape[2] * w.shape[3]

    size = -(-img // 2)
    macs = conv_macs(model.stem.conv, size)
    size = -(-size // 2)  # the max-pool
    for stage, blocks in enumerate(model.stages):
        for b, blk in enumerate(blocks):
            out = -(-size // (2 if stage > 0 and b == 0 else 1))
            macs += conv_macs(blk.conv1, size) + conv_macs(blk.conv2, out) + conv_macs(blk.conv3, out)
            if hasattr(blk, "proj"):
                macs += conv_macs(blk.proj, out)
            size = out
    macs += model.head.w.numel()
    return 3 * 2.0 * macs


def bert_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 × the encoder's matmul params ×
    tokens, + 12 · T · h · L a token for the attention's QKᵀ and PV
    (2 · T · h each, forward; × 3 with the backward), + 6 × the tied head's
    V · h × tokens (padded positions count: the step computes them)."""
    h, f, L = cfg.hidden, cfg.ff, cfg.layers
    return tokens * (6.0 * L * (4 * h * h + 2 * h * f) + 12.0 * seq * h * L
                     + 6.0 * cfg.vocab_size * h)


@timed_phase
def phase_mlp(torch, M, L, kind: str) -> dict:
    """BASELINE config 1 (Titanic) as the example runs it: the 2,000
    synthetic rows written to a hash-partitioned primary-key table and
    upserted (merge-on-read), then ``MLP(4, hidden=64)`` and Adam 1e-2,
    batch 256, 5 epochs of ``to_torch_iter`` over the table, each batch
    standardised on the host as the example's transform does; every row must
    arrive each epoch and train accuracy pass the example's floor 0.7.  Step
    ms: CUDA events around each step; rows/s: rows delivered over the
    epochs' wall time."""
    import pyarrow as pa

    data = make_synthetic_titanic()
    wh = tempfile.mkdtemp(prefix="chip_smoke_titanic_")
    try:
        table = pa.table(data)
        t = L.LakeSoulCatalog(wh).create_table(
            "titanic", table.schema, primary_keys=["passenger_id"],
            hash_bucket_num=TITANIC_BUCKETS)
        t.write_arrow(table)
        t.upsert(table.slice(0, TITANIC_UPSERT))  # a correction wave: merge-on-read

        def transform(b):
            return {"x": titanic_features(b), "y": b["survived"].astype(np.int32)}

        model = M.MLP(len(TITANIC_FEATURES), hidden=64, seed=SEED, device=DEVICE)
        step = M.make_mlp_train_step(model, M.adam(model.parameters(), TITANIC_LR),
                                     device=DEVICE)
        events, losses, epoch_rows, epoch_s = [], [], [], []
        t0 = time.perf_counter()
        for _ in range(TITANIC_EPOCHS):
            rows, te = 0, time.perf_counter()
            for b in t.scan().batch_size(TITANIC_BATCH).auto_shard().to_torch_iter(
                    transform=transform, drop_remainder=False, device=DEVICE):
                pair = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                pair[0].record()
                losses.append(step(b["x"], b["y"]))
                pair[1].record()
                events.append(pair)
                rows += int(b["y"].shape[0])
            epoch_rows.append(rows)
            epoch_s.append(time.perf_counter() - te)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(wh, ignore_errors=True)
    require(epoch_rows == [TITANIC_ROWS] * TITANIC_EPOCHS,
            f"the Titanic table delivered {epoch_rows} rows a epoch, not {TITANIC_ROWS}")
    ms = [a.elapsed_time(b) for a, b in events]
    losses = [float(v) for v in losses]
    require(all(np.isfinite(losses)), "a non-finite MLP loss")
    with torch.no_grad():
        logits = model(torch.from_numpy(titanic_features(data)).to(DEVICE))
    acc = float((logits.argmax(1).cpu().numpy() == data["survived"]).mean())
    require(acc > TITANIC_FLOOR, f"the MLP's train accuracy {acc} is not above {TITANIC_FLOOR}")
    rec = {"config": "BASELINE config 1 (Titanic MLP)", "device_kind": kind,
           "rows": TITANIC_ROWS, "batch": TITANIC_BATCH, "epochs": TITANIC_EPOCHS,
           "table": {"hash_bucket_num": TITANIC_BUCKETS, "primary_key": "passenger_id",
                     "upserted_rows": TITANIC_UPSERT},
           "epoch_rows": epoch_rows, "epoch_s": epoch_s, "steps": len(ms),
           "step_ms": float(np.median(ms)),
           "rows_per_s": sum(epoch_rows) / wall, "wall_s": wall,
           "accuracy": acc, "accuracy_floor": TITANIC_FLOOR,
           "loss_first": losses[0], "loss_last": losses[-1]}
    emit("mlp", **rec)
    return rec


@timed_phase
def phase_resnet50(torch, M, C, kind: str) -> dict:
    """BASELINE config 2: ``ResNet(ResNetConfig())`` (depth 50, width 64,
    1000 classes, bf16), SGD 0.05, one fixed batch of 256 seeded normal
    224² images with labels in [0, 1000); card = CPU first (see
    ``hold_card_to_cpu``; leaves: stem conv, the first block's conv2, the
    last stage's proj, the head).  mfu: ``resnet_flops`` × batch over the
    median step time, over the bf16 dense peak (989 TFLOP/s)."""
    import torch.nn.functional as F

    model = M.ResNet(M.ResNetConfig(), seed=SEED, device=DEVICE)
    g = torch.Generator().manual_seed(SEED + 1)
    hx = torch.randn(HOLD_BATCH, RESNET_IMG, RESNET_IMG, 3, generator=g)
    hy = torch.randint(0, model.cfg.num_classes, (HOLD_BATCH,), generator=g)

    def run(m, dev):
        logits = M.resnet_forward(m, hx.to(dev))
        return F.cross_entropy(logits, hy.to(dev)), logits

    hold = hold_card_to_cpu(
        torch, M, C, model, lambda: M.ResNet(model.cfg, device="cpu"), run,
        ("stem.conv", "stages.0.0.conv2", f"stages.{len(model.stages) - 1}.0.proj", "head.w"),
        f64_grads=True)
    emit("resnet50_hold", **hold)
    require(all(hold["ok"].values()), f"ResNet-50 on the card != on the CPU: {hold['ok']}")

    gd = torch.Generator(device=DEVICE).manual_seed(SEED)
    images = torch.randn(RESNET_BATCH, RESNET_IMG, RESNET_IMG, 3, device=DEVICE, generator=gd)
    labels = torch.randint(0, model.cfg.num_classes, (RESNET_BATCH,), device=DEVICE, generator=gd)
    step = M.make_resnet_train_step(model, M.sgd(model.parameters(), RESNET_LR), device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    run_rec = train_steps(torch, step, (images, labels))
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = profile(torch, lambda: step(images, labels))
    flops = resnet_flops(model, RESNET_IMG) * RESNET_BATCH
    sec = run_rec["step_ms"] / 1e3
    rec = {"config": "BASELINE config 2 (ResNet-50, ImageNet shapes)", "device_kind": kind,
           "batch": RESNET_BATCH, "image": RESNET_IMG, "dtype": model.cfg.dtype,
           "optimizer": f"sgd {RESNET_LR}", "warmup_steps": WARMUP_STEPS,
           "timed_steps": TIMED_STEPS, **run_rec, "images_per_s": RESNET_BATCH / sec,
           "peak_gb": peak, "model_flop_per_step": flops,
           "mfu": flops / sec / PEAK_BF16_FLOP_S, "mfu_peak_flop_s": PEAK_BF16_FLOP_S,
           "profile": {**prof, "top": prof["top"][:PROFILE_TOP]},
           "held": hold["held"],
           "data": "one fixed batch of seeded normal images: the step alone; the "
                   "resnet50_table phase feeds it from a table"}
    emit("resnet50", **rec)
    return rec


def bert_batch(torch, gen, n: int, vocab: int, dev):
    """n × BERT_SEQ seeded token ids; each row a seeded length in
    [BERT_MIN_LEN, BERT_SEQ], the mask False past it; BERT_LABEL_SHARE of the
    valid positions labelled with their token and replaced by [MASK] in the
    input, the rest of the labels -100."""
    ids = torch.randint(4, vocab, (n, BERT_SEQ), generator=gen)
    lengths = torch.randint(BERT_MIN_LEN, BERT_SEQ + 1, (n,), generator=gen)
    mask = torch.arange(BERT_SEQ)[None, :] < lengths[:, None]
    picked = mask & (torch.rand(n, BERT_SEQ, generator=gen) < BERT_LABEL_SHARE)
    labels = torch.where(picked, ids, -100)
    ids = torch.where(picked, BERT_MASK_ID, ids)
    return ids.to(dev), labels.to(dev), mask.to(dev)


@timed_phase
def phase_bert_base(torch, M, C, kind: str) -> dict:
    """BASELINE config 3: ``BertConfig.base()`` (30,522 × 768, 12 layers, 12
    heads, ff 3072, bf16) through ``make_bert_train_state`` (AdamW 1e-4,
    weight decay 1e-4) and ``make_bert_train_step``, one fixed batch of
    256 × 128 (``bert_batch``); card = CPU first (leaves: tok_emb, layer
    0's wq, layer 11's w2, mlm_bias).  mfu: ``bert_flops`` over the median
    step time, over the bf16 dense peak (989 TFLOP/s)."""
    model, opt = M.make_bert_train_state(M.BertConfig.base(), seed=SEED, device=DEVICE)
    hid, hlab, hmask = bert_batch(torch, torch.Generator().manual_seed(SEED + 1), HOLD_BATCH,
                                  model.cfg.vocab_size, "cpu")

    def run(m, dev):
        logits = M.bert_forward(m, hid.to(dev), hmask.to(dev))
        return M.masked_nll(logits, hlab.to(dev)), logits

    last = len(model.layers) - 1
    hold = hold_card_to_cpu(
        torch, M, C, model, lambda: M.Bert(model.cfg, device="cpu"), run,
        ("tok_emb", "layers.0.wq", f"layers.{last}.w2", "mlm_bias"))
    emit("bert_base_hold", **hold)
    require(all(hold["ok"].values()), f"BERT-base on the card != on the CPU: {hold['ok']}")

    ids, labels, mask = bert_batch(torch, torch.Generator().manual_seed(SEED), BERT_BATCH,
                                   model.cfg.vocab_size, DEVICE)
    step = M.make_bert_train_step(model, opt, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    run_rec = train_steps(torch, step, (ids, labels, mask))
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = profile(torch, lambda: step(ids, labels, mask))
    tokens = BERT_BATCH * BERT_SEQ
    flops = bert_flops(model.cfg, tokens, BERT_SEQ)
    sec = run_rec["step_ms"] / 1e3
    rec = {"config": "BASELINE config 3 (BERT-base MLM)", "device_kind": kind,
           "batch": BERT_BATCH, "seq": BERT_SEQ, "dtype": model.cfg.dtype,
           "optimizer": "adamw 1e-4, weight decay 1e-4", "warmup_steps": WARMUP_STEPS,
           "timed_steps": TIMED_STEPS, **run_rec, "sequences_per_s": BERT_BATCH / sec,
           "tokens_per_s": tokens / sec, "valid_tokens": int(mask.sum()),
           "labelled_tokens": int((labels >= 0).sum()), "peak_gb": peak,
           "model_flop_per_step": flops, "mfu": flops / sec / PEAK_BF16_FLOP_S,
           "mfu_peak_flop_s": PEAK_BF16_FLOP_S,
           "profile": {**prof, "top": prof["top"][:PROFILE_TOP]}, "held": hold["held"],
           "data": "one fixed batch of seeded token ids: the step alone; the "
                   "bert_base_table phase feeds it from a table"}
    emit("bert_base", **rec)
    return rec


def moe_flops(cfg, tokens: int, seq: int) -> float:
    """``bert_flops`` with each token counted once through one expert (its
    FFN's 2 · h · f a layer, as the dense FFN's) plus the router's h · E."""
    return bert_flops(cfg, tokens, seq) + tokens * 6.0 * cfg.layers * cfg.hidden * cfg.n_experts


def moe_routing(torch, MB, model, ids, mask) -> dict:
    """One no-grad forward with ``models.bert.moe_ffn`` wrapped: each layer's
    tokens per expert (its argmax of the float32 router, as the layer
    computes it) and the share dropped past capacity (first come keeps C)."""
    from lakesoul_tpu_torch.parallel.moe import moe_capacity

    cfg, orig, loads = model.cfg, MB.moe_ffn, []

    def spy(x, gate_w, *args, **kw):
        counts = torch.bincount(torch.softmax(x.float() @ gate_w.float(), -1).argmax(-1),
                                minlength=cfg.n_experts)
        loads.append(counts)
        return orig(x, gate_w, *args, **kw)

    MB.moe_ffn = spy
    try:
        with torch.no_grad():
            MB.bert_forward(model, ids, mask)
    finally:
        MB.moe_ffn = orig
    n = ids.numel()
    cap = moe_capacity(n, cfg.n_experts, cfg.capacity_factor)
    dropped = [float((c - c.clamp(max=cap)).sum()) / n for c in loads]
    return {"capacity": cap, "tokens": n, "dropped_share_by_layer": dropped,
            "dropped_share": float(np.mean(dropped)),
            "expert_load_by_layer": [(c.float() / n).tolist() for c in loads]}


@timed_phase
def phase_moe_bert_base(torch, M, C, kind: str) -> dict:
    """Switch-Base-8 (Fedus et al. 2021): BERT-base's widths (T5-Base's)
    with every FFN a top-1 MoE of 8 experts, capacity factor 1.25, aux
    weight 0.01 — ``BertConfig(n_experts=8)`` — through
    ``make_bert_train_state`` (AdamW 1e-4) and ``make_bert_train_step`` on
    ``bert_base``'s fixed 256 × 128 batch; card = CPU first (leaves:
    tok_emb, layer 0's router and first expert weights, the last layer's
    second, mlm_bias), then what ``bert_base`` reports, with ``mfu`` from
    ``moe_flops``, and the routing: each expert's load and the share of
    tokens dropped past capacity, per layer."""
    import lakesoul_tpu_torch.models.bert as MB

    cfg = M.BertConfig(n_experts=MOE_EXPERTS)
    model, opt = M.make_bert_train_state(cfg, seed=SEED, device=DEVICE)
    hid, hlab, hmask = bert_batch(torch, torch.Generator().manual_seed(SEED + 1), HOLD_BATCH,
                                  cfg.vocab_size, "cpu")

    def run(m, dev):
        logits, aux = M.bert_forward(m, hid.to(dev), hmask.to(dev), with_aux=True)
        return M.masked_nll(logits, hlab.to(dev)) + m.cfg.moe_aux_weight * aux, logits

    last = len(model.layers) - 1
    hold = hold_card_to_cpu(
        torch, M, C, model, lambda: M.Bert(model.cfg, device="cpu"), run,
        ("tok_emb", "layers.0.moe.gate_w", "layers.0.moe.w1", f"layers.{last}.moe.w2",
         "mlm_bias"))
    emit("moe_bert_base_hold", **hold)
    require(all(hold["ok"].values()), f"MoE BERT-base on the card != on the CPU: {hold['ok']}")

    ids, labels, mask = bert_batch(torch, torch.Generator().manual_seed(SEED), BERT_BATCH,
                                   cfg.vocab_size, DEVICE)
    routing = moe_routing(torch, MB, model, ids, mask)
    step = M.make_bert_train_step(model, opt, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    run_rec = train_steps(torch, step, (ids, labels, mask))
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = profile(torch, lambda: step(ids, labels, mask))
    tokens = BERT_BATCH * BERT_SEQ
    flops = moe_flops(cfg, tokens, BERT_SEQ)
    sec = run_rec["step_ms"] / 1e3
    rec = {"config": "Switch-Base-8 (BERT-base widths, 8 experts, top-1, capacity 1.25, "
                     "aux 0.01; Fedus et al. 2021)", "device_kind": kind,
           "params": sum(p.numel() for p in model.parameters()),
           "batch": BERT_BATCH, "seq": BERT_SEQ, "dtype": cfg.dtype,
           "optimizer": "adamw 1e-4, weight decay 1e-4", "warmup_steps": WARMUP_STEPS,
           "timed_steps": TIMED_STEPS, **run_rec, "sequences_per_s": BERT_BATCH / sec,
           "tokens_per_s": tokens / sec, "peak_gb": peak, "model_flop_per_step": flops,
           "flops_counted": "6 x (attention projections + one expert's FFN + the router) x "
                            "tokens + attention QK/PV + the tied head, padded positions too",
           "mfu": flops / sec / PEAK_BF16_FLOP_S, "mfu_peak_flop_s": PEAK_BF16_FLOP_S,
           "routing": routing, "profile": {**prof, "top": prof["top"][:PROFILE_TOP]},
           "held": hold["held"],
           "reduced": "Switch-Base-8 puts an MoE layer in every other block; the "
                      "reference's design (and the port) in every block"}
    emit("moe_bert_base", **rec)
    return rec, (model, opt, (ids, labels, mask))


@timed_phase
def phase_checkpoint(torch, M, state, kind: str, root: str) -> dict:
    """Switch-Base-8 after ``moe_bert_base``'s timed steps, put under a
    world-size-1 NCCL ``plan=`` state (``make_bert_train_state(plan=)``,
    then its weights and AdamW state loaded), saved by the sharded
    ``TrainCheckpointer`` (``torch.distributed.checkpoint``) into ``root``
    and restored into a state built fresh from another seed: every
    parameter and both moments of every one bit-equal.  Then one step from
    the restored and one from the unbroken state on the same batch: their
    losses must agree within the step's own run-to-run difference, measured
    here as two passes of the same step with a learning rate of 0 (SGD: the
    parameters stay bit for bit), bitwise if those agree, and the
    parameters after the step, which the restored hyperparameters and
    moments move, must be bit-equal.  The directory is deleted after the
    phase."""
    import torch.distributed as dist

    from lakesoul_tpu_torch.parallel import make_mesh

    model, opt, batch = state
    cfg = model.cfg
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        plan = make_mesh()
        live, live_opt = M.make_bert_train_state(cfg, plan=plan, seed=SEED)
        live.load_state_dict(model.state_dict())
        live_opt.load_state_dict(opt.state_dict())
        del model, opt, state
        torch.cuda.empty_cache()
        step_no = WARMUP_STEPS + TIMED_STEPS + 2  # the hold's and the profile's steps too
        ckpt = M.TrainCheckpointer(root, max_to_keep=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with RssPeak() as host:
            t0 = time.perf_counter()
            ckpt.save(step_no, live.state_dict(), live_opt.state_dict(), plan=plan)
            save_s = time.perf_counter() - t0
        written = dir_bytes(root)
        fresh, fresh_opt = M.make_bert_train_state(cfg, plan=plan, seed=SEED + 5)
        with RssPeak() as host_restore:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, at = ckpt.restore_latest(
                like=(fresh.state_dict(), fresh_opt.state_dict()), plan=plan)
            fresh.load_state_dict(params)
            fresh_opt.load_state_dict(opt_state)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        del params, opt_state
        peak_device = torch.cuda.max_memory_allocated() / 1e9
        require(at == step_no, f"restored step {at}, saved {step_no}")
        pairs = list(zip(live.named_parameters(), fresh.named_parameters()))
        unequal = [n for (n, p), (_, q) in pairs if not torch.equal(p, q)]
        unequal += [f"{n}.{k}" for (n, p), (_, q) in pairs
                    for k in ("exp_avg", "exp_avg_sq", "step")
                    if not torch.equal(live_opt.state[p][k], fresh_opt.state[q][k])]
        require(not unequal, f"restored state != saved: {unequal[:8]}")
        # the step's run-to-run difference: the same step twice, learning rate 0
        probe = M.make_bert_train_step(live, torch.optim.SGD(live.parameters(), lr=0.0),
                                       plan=plan)
        twice = [float(probe(*batch)) for _ in range(2)]
        spread = abs(twice[0] - twice[1])
        unbroken = float(M.make_bert_train_step(live, live_opt, plan=plan)(*batch))
        restored = float(M.make_bert_train_step(fresh, fresh_opt, plan=plan)(*batch))
        after_equal = all(torch.equal(p, q) for (_, p), (_, q) in
                          zip(live.named_parameters(), fresh.named_parameters()))
        require(np.isfinite(unbroken) and abs(restored - unbroken) <= spread,
                f"the restored state's next loss {restored} != the unbroken {unbroken} "
                f"(run-to-run {spread})")
        # the update reads the restored hyperparameters and moments, which the
        # loss (taken before it) does not: both states' parameters after the
        # step must be bit-equal (the step is deterministic on the card)
        require(after_equal,
                "the parameters after the restored state's step != the unbroken state's")
        rec = {"config": "Switch-Base-8 (moe_bert_base's state after its steps) under a "
                         "world-size-1 NCCL plan", "device_kind": kind,
               "params": sum(p.numel() for p in live.parameters()), "step": step_no,
               "mesh": {a: getattr(plan, a) for a in plan.axis_names},
               "save_s": save_s, "restore_s": restore_s, "gb_written": written / 1e9,
               "save_gb_per_s": written / 1e9 / save_s,
               "restore_gb_per_s": written / 1e9 / restore_s,
               "peak_device_gb": peak_device, "host_rss_mb_before": host.start_mb,
               "host_peak_rss_mb_save": host.peak_mb,
               "host_peak_rss_mb_restore": host_restore.peak_mb, "bit_equal": True,
               "loss_unbroken": unbroken, "loss_restored": restored,
               "step_run_to_run": spread, "probe_losses": twice,
               "params_equal_after_the_step": after_equal}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
        shutil.rmtree(root, ignore_errors=True)
    rec["host_rss_mb_after"] = rss_mb()  # the staging copies, once the phase let go of them
    emit("checkpoint", **rec)
    return rec


@timed_phase
def phase_parallel(torch, M, C, kind: str) -> dict:
    """The parallel layer on the card: one NCCL process group of world size
    1 (a ``file://`` store in a temporary directory), ``make_mesh()`` over it,
    and each plan step beside the plain single-device step on the same
    weights (``Bert(cfg, seed=SEED)``) and batch: BERT-base widths at
    float32 (TF32 off) on PAR_BATCH × 128 with ``sequence_parallel="ring"``
    and ``"ulysses"``, the pipeline step (``n_micro=4``), the MoE plan step
    (8 experts), and the ResNet-50 plan step on PAR_RESNET_BATCH × 224²
    (the batch norm's group path); each first loss must equal the plain
    step's within HOLD_RTOL.  Then ``cross_chip_topk`` on the card = the
    host's stable merge.  This shows the code path runs on the card (every
    gradient sum goes through NCCL), not that it scales: one card."""
    import torch.distributed as dist

    from lakesoul_tpu_torch.annplane.collective import cross_chip_topk
    from lakesoul_tpu_torch.parallel import make_mesh

    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
    rec, ok = {"device_kind": kind, "world_size": 1, "backend": "nccl",
               "dtype": "float32", "batch": PAR_BATCH, "seq": BERT_SEQ,
               "note": "world size 1: the code path on the card, not its scaling"}, {}
    try:
        plan = make_mesh()
        rec["mesh"] = {a: getattr(plan, a) for a in plan.axis_names}
        ids, labels, mask = bert_batch(torch, torch.Generator().manual_seed(SEED + 2), PAR_BATCH,
                                       M.BertConfig().vocab_size, DEVICE)

        def two_losses(step, *batch):
            t = time.perf_counter()
            losses = [float(step(*batch)) for _ in range(2)]
            return {"losses": losses, "s": time.perf_counter() - t}

        def compare(name, plain, planned):
            err = abs(planned["losses"][0] - plain["losses"][0]) / abs(plain["losses"][0])
            rec[name] = {"plain": plain, "plan": planned, "first_loss_rel_err": err}
            ok[name] = bool(np.isfinite(planned["losses"]).all()) and err <= HOLD_RTOL

        for n_experts in (0, MOE_EXPERTS):
            cfg = M.BertConfig(dtype="float32", n_experts=n_experts)
            model, opt = M.make_bert_train_state(cfg, seed=SEED, device=DEVICE)
            plain = two_losses(M.make_bert_train_step(model, opt, device=DEVICE),
                               ids, labels, mask)
            del model, opt
            modes = ("ring", "ulysses") if not n_experts else ("ring",)
            for mode in modes:
                model, opt = M.make_bert_train_state(cfg, plan=plan, seed=SEED)
                step = M.make_bert_train_step(model, opt, plan=plan, sequence_parallel=mode)
                compare(f"bert_{mode}" if not n_experts else "moe_bert",
                        plain, two_losses(step, ids, labels, mask))
                del model, opt, step
            if not n_experts:
                model, opt = M.make_bert_pipeline_train_state(cfg, plan, seed=SEED)
                step = M.make_bert_pipeline_train_step(model, opt, plan, n_micro=PAR_MICRO)
                compare("bert_pipeline", plain, two_losses(step, ids, labels, mask))
                del model, opt, step
            torch.cuda.empty_cache()

        g = torch.Generator(device=DEVICE).manual_seed(SEED)
        images = torch.randn(PAR_RESNET_BATCH, RESNET_IMG, RESNET_IMG, 3, device=DEVICE,
                             generator=g)
        classes = torch.randint(0, RESNET_CLASSES, (PAR_RESNET_BATCH,), device=DEVICE,
                                generator=g)
        rcfg = M.ResNetConfig(dtype="float32")
        steps = {}
        for name, kw in (("plain", {"device": DEVICE}), ("plan", {"plan": plan})):
            model = M.ResNet(rcfg, seed=SEED, device=DEVICE)
            steps[name] = two_losses(M.make_resnet_train_step(
                model, M.sgd(model.parameters(), RESNET_LR), **kw), images, classes)
            del model
        compare("resnet50", steps["plain"], steps["plan"])
        rec["resnet50"]["batch"] = PAR_RESNET_BATCH

        gt = torch.Generator(device=DEVICE).manual_seed(SEED)
        d = (torch.randint(0, 16, (64,), device=DEVICE, generator=gt) / 16).float()
        rows = torch.randint(0, 1 << 20, (64,), device=DEVICE, generator=gt, dtype=torch.int32)
        md, mr, msrc = cross_chip_topk(d, rows, k=10, group=plan.group("dp"))
        order = np.argsort(d.cpu().numpy(), kind="stable")[:10]
        ok["cross_chip_topk"] = bool(
            np.array_equal(md.cpu().numpy(), d.cpu().numpy()[order])
            and np.array_equal(mr.cpu().numpy(), rows.cpu().numpy()[order])
            and (msrc.cpu().numpy() == 0).all())
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    rec["ok"] = ok
    emit("parallel", **rec)
    require(all(ok.values()), f"a plan step's loss != the plain step's: {ok}")
    return rec


def resnet_table_transform(b: dict) -> dict:
    """``examples/resnet_from_table.py``'s transform, split at the copy to
    the card: here the uint8 pixels become an NHWC view and the labels
    int32; the division by 255 into float32 runs on the card after the
    uint8 batch lands (``resnet_table_images``), so a quarter of the bytes
    cross the link and the host does no float pass."""
    return {"x": b["pixels"].reshape(-1, RESNET_IMG, RESNET_IMG, 3),
            "y": b["label"].astype(np.int32)}


def resnet_example_transform(b: dict) -> dict:
    """The example's transform whole, on the host (timed beside the split)."""
    imgs = b["pixels"].reshape(-1, RESNET_IMG, RESNET_IMG, 3).astype(np.float32) / 255.0
    return {"x": imgs, "y": b["label"].astype(np.int32)}


def resnet_table_images(torch, x):
    """The card's half of the transform: uint8 NHWC → float32 / 255."""
    return x.to(torch.float32).div_(255.0)


def bert_table_transform(rng):
    """``examples/bert_mlm_from_table.py``'s transform on the host: 15 % of
    the positions drawn from ``rng`` (numpy), labelled with their token and
    replaced by [MASK] = 3, labels -100 elsewhere, an all-ones mask."""
    def transform(b):
        ids = b["tokens"]
        labels = np.full_like(ids, -100)
        mask_pos = rng.random(ids.shape) < BERT_LABEL_SHARE
        labels[mask_pos] = ids[mask_pos]
        masked = ids.copy()
        masked[mask_pos] = BERT_MASK_ID
        return {"ids": masked.astype(np.int32), "labels": labels.astype(np.int32),
                "mask": np.ones_like(ids, dtype=bool)}

    return transform


def feed_epochs(torch, make_iter, train, rows_of, expect: int) -> list:
    """One untimed epoch, then one timed, each through a fresh iterator:
    every epoch must deliver ``expect`` rows and every loss be finite; per
    epoch the rows/s, the stage sums and the ``queue`` stage's share of the
    wall time (how long the step waited on the loader)."""
    from lakesoul_tpu_torch.obs.stages import stage_seconds

    epochs = []
    for e in range(2):
        before = stage_seconds()
        rows, losses = 0, []
        t0 = time.perf_counter()
        for b in make_iter():
            losses.append(train(b))
            rows += int(rows_of(b))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = stage_seconds()
        losses = [float(v) for v in losses]
        require(rows == expect, f"epoch {e} delivered {rows} rows, not {expect}")
        require(all(np.isfinite(losses)), f"a non-finite loss in epoch {e}: {losses}")
        stages = {k: after[k] - before[k] for k in after}
        epochs.append({"timed": e > 0, "rows": rows, "wall_s": wall, "rows_per_s": rows / wall,
                       "steps": len(losses), "loss_first": losses[0], "loss_last": losses[-1],
                       "stage_seconds": stages, "queue_share": stages["queue"] / wall})
    return epochs


def feed_busy(torch, make_iter, train) -> dict:
    """The card's busy share over FEED_PROFILE_BATCHES batches of the live
    feed (profile() runs them once to warm, once traced)."""
    it = iter(make_iter())

    def feed():
        for _ in range(FEED_PROFILE_BATCHES):
            train(next(it))

    busy = profile(torch, feed)
    it.close()
    return busy


def reset_peaks(torch) -> None:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if hasattr(torch.cuda, "reset_peak_host_memory_stats"):
        torch.cuda.reset_peak_host_memory_stats()


@timed_phase
def phase_resnet50_table(torch, M, L, kind: str, fixed_images_per_s: float) -> dict:
    """BASELINE config 2 fed from a table, as ``examples/resnet_from_table.py``
    builds it at ImageNet's shapes: ``image_id`` int64 primary key,
    ``pixels`` FixedSizeList<uint8, 150528> (224² × 3), ``label`` int32 <
    1000, ``hash_bucket_num=4``, LSF, RESNET_TABLE_ROWS seeded images, then
    ``scan().auto_shard().batch_size(256).to_torch_iter(transform=...)``
    into the resnet50 phase's step (``ResNetConfig()``, bf16, SGD 0.05).
    Requires every epoch's rows, finite losses, and ``shard(0, 4)``'s card
    batches, copied back, = its CPU batches by sha256."""
    import pyarrow as pa

    n_px = RESNET_IMG * RESNET_IMG * 3
    schema = pa.schema([("image_id", pa.int64()), ("pixels", pa.list_(pa.uint8(), n_px)),
                        ("label", pa.int32())])
    wh = tempfile.mkdtemp(prefix="chip_smoke_images_")
    try:
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED)
        pixels = rng.integers(0, 256, (RESNET_TABLE_ROWS, n_px), dtype=np.uint8)
        labels = rng.integers(0, RESNET_CLASSES, RESNET_TABLE_ROWS).astype(np.int32)
        t = L.LakeSoulCatalog(wh).create_table(
            "imagenet", schema, primary_keys=["image_id"], hash_bucket_num=FEED_BUCKETS,
            properties={"lakesoul.file_format": "lsf"})
        t.write_arrow(pa.table({
            "image_id": np.arange(RESNET_TABLE_ROWS, dtype=np.int64),
            "pixels": pa.FixedSizeListArray.from_arrays(pixels.reshape(-1), n_px),
            "label": labels}, schema=schema))
        write_s = time.perf_counter() - t0
        del pixels
        table_bytes = dir_bytes(wh)
        count = t.scan().count_rows()
        require(count == RESNET_TABLE_ROWS, f"count_rows {count} != {RESNET_TABLE_ROWS}")

        model = M.ResNet(M.ResNetConfig(), seed=SEED, device=DEVICE)
        step = M.make_resnet_train_step(model, M.sgd(model.parameters(), RESNET_LR),
                                        device=DEVICE)

        def make_iter():
            return t.scan().auto_shard().batch_size(RESNET_BATCH).to_torch_iter(
                transform=resnet_table_transform, device=DEVICE)

        def train(b):
            return step(resnet_table_images(torch, b["x"]), b["y"])

        def rows_of(b):
            return b["y"].shape[0]

        reset_peaks(torch)
        epochs = feed_epochs(torch, make_iter, train, rows_of, count)
        peak_device = torch.cuda.max_memory_allocated()
        pinned = pinned_stats(torch)
        busy = feed_busy(torch, make_iter, train)

        # where the float pass runs: the example's whole transform on the
        # host beside the card's half on one delivered batch
        hb = next(iter(t.scan().batch_size(RESNET_BATCH).to_torch_iter(device_put=False)))
        host_ms = []
        for _ in range(3):
            t1 = time.perf_counter()
            resnet_example_transform(hb)
            host_ms.append((time.perf_counter() - t1) * 1e3)
        xb = torch.from_numpy(resnet_table_transform(hb)["x"]).to(DEVICE)
        card_ms = time_ms(torch, lambda: resnet_table_images(torch, xb), 10)
        del hb, xb

        # the card's batches = the CPU's: one hash bucket, no transform
        shard = t.scan().shard(0, FEED_BUCKETS).batch_size(RESNET_BATCH)
        rows_id = lambda b: b["image_id"].shape[0]  # noqa: E731
        want = batches_sha(shard.to_torch_iter(device="cpu", drop_remainder=False),
                           lambda v: v.numpy(), rows_id)
        got = batches_sha(shard.to_torch_iter(device=DEVICE, drop_remainder=False),
                          lambda v: v.cpu().numpy(), rows_id)
        require(want[1] > 0 and got == want,
                f"the card's batches of shard(0, {FEED_BUCKETS}) != the CPU's: {got} {want}")
    finally:
        shutil.rmtree(wh, ignore_errors=True)
    timed = epochs[-1]
    rec = {"config": "BASELINE config 2 fed from an image table (examples/resnet_from_table.py "
                     "at ImageNet's shapes)", "device_kind": kind, "rows": count,
           "batch": RESNET_BATCH, "image": RESNET_IMG, "hash_bucket_num": FEED_BUCKETS,
           "write_s": write_s, "table_bytes": table_bytes, "epochs": epochs,
           "images_per_s": timed["rows_per_s"], "fixed_batch_images_per_s": fixed_images_per_s,
           "queue_share": timed["queue_share"], "stage_seconds": timed["stage_seconds"],
           "busy_batches": FEED_PROFILE_BATCHES,
           "device_busy_share": busy["device_busy_share"], "busy_profile": busy,
           "peak_device_gb": peak_device / 1e9,
           "peak_pinned_gb": (pinned.get("allocated_bytes.peak") or 0) / 1e9,
           "transform": {"host_part": "uint8 NHWC view + int32 labels",
                         "card_part": "float32 / 255 after the copy",
                         "example_transform_on_host_ms": host_ms,
                         "card_part_ms": card_ms},
           "card_equals_cpu": {"shard": f"0/{FEED_BUCKETS}", "rows": want[1],
                               "sha256": want[0]}}
    emit("resnet50_table", **rec)
    return rec


@timed_phase
def phase_bert_base_table(torch, M, L, kind: str, fixed: dict) -> dict:
    """BASELINE config 3 fed from a C4-style token table, as
    ``examples/bert_mlm_from_table.py`` builds it at BERT-base's widths:
    ``doc_id`` int64 primary key, ``tokens`` FixedSizeList<int32, 128>,
    ``hash_bucket_num=4``, LSF, BERT_TABLE_ROWS seeded documents with tokens
    in [4, 30522), one upsert wave of BERT_UPSERT_FRAC (so the scan merges
    on read); batches of 256 × 128 with the example's masking into
    ``BertConfig.base()`` and AdamW 1e-4.  Requires every epoch's rows and
    finite losses."""
    import pyarrow as pa

    model, opt = M.make_bert_train_state(M.BertConfig.base(), seed=SEED, device=DEVICE)
    vocab = model.cfg.vocab_size
    schema = pa.schema([("doc_id", pa.int64()), ("tokens", pa.list_(pa.int32(), BERT_SEQ))])

    def docs(ids, rng):
        tok = rng.integers(4, vocab, (len(ids), BERT_SEQ)).astype(np.int32)
        return pa.table({"doc_id": ids, "tokens": pa.FixedSizeListArray.from_arrays(
            tok.reshape(-1), BERT_SEQ)}, schema=schema)

    wh = tempfile.mkdtemp(prefix="chip_smoke_c4_")
    try:
        rng = np.random.default_rng(SEED)
        t0 = time.perf_counter()
        t = L.LakeSoulCatalog(wh).create_table(
            "c4", schema, primary_keys=["doc_id"], hash_bucket_num=FEED_BUCKETS,
            properties={"lakesoul.file_format": "lsf"})
        t.write_arrow(docs(np.arange(BERT_TABLE_ROWS, dtype=np.int64), rng))
        n_up = int(BERT_TABLE_ROWS * BERT_UPSERT_FRAC)
        t.upsert(docs(np.sort(rng.choice(BERT_TABLE_ROWS, n_up, replace=False)), rng))
        write_s = time.perf_counter() - t0
        count = t.scan().count_rows()
        require(count == BERT_TABLE_ROWS, f"count_rows {count} != {BERT_TABLE_ROWS}")
        step = M.make_bert_train_step(model, opt, device=DEVICE)
        transform = bert_table_transform(np.random.default_rng(SEED))

        def make_iter():
            return t.scan().auto_shard().batch_size(BERT_BATCH).to_torch_iter(
                transform=transform, device=DEVICE)

        def train(b):
            return step(b["ids"], b["labels"], b["mask"])

        def rows_of(b):
            return b["ids"].shape[0]

        reset_peaks(torch)
        epochs = feed_epochs(torch, make_iter, train, rows_of, count)
        peak_device = torch.cuda.max_memory_allocated()
        pinned = pinned_stats(torch)
        busy = feed_busy(torch, make_iter, train)
    finally:
        shutil.rmtree(wh, ignore_errors=True)
    timed = epochs[-1]
    rec = {"config": "BASELINE config 3 fed from a C4-style token table with an upsert wave "
                     "(examples/bert_mlm_from_table.py at BERT-base's widths)",
           "device_kind": kind, "rows": count, "upserted_rows": n_up, "batch": BERT_BATCH,
           "seq": BERT_SEQ, "hash_bucket_num": FEED_BUCKETS, "write_s": write_s,
           "epochs": epochs, "sequences_per_s": timed["rows_per_s"],
           "tokens_per_s": timed["rows_per_s"] * BERT_SEQ,
           "fixed_batch_sequences_per_s": fixed["sequences_per_s"],
           "fixed_batch_tokens_per_s": fixed["tokens_per_s"],
           "queue_share": timed["queue_share"], "stage_seconds": timed["stage_seconds"],
           "busy_batches": FEED_PROFILE_BATCHES,
           "device_busy_share": busy["device_busy_share"], "busy_profile": busy,
           "peak_device_gb": peak_device / 1e9,
           "peak_pinned_gb": (pinned.get("allocated_bytes.peak") or 0) / 1e9}
    emit("bert_base_table", **rec)
    return rec


@timed_phase
def phase_vector_table(torch, K, R, L, kind: str) -> dict:
    """The slice's corpus as a table (1,000,000 × 512, ``id`` int64 primary
    key, ``hash_bucket_num=4``, LSF, written in VT_CHUNK-row commits, so
    every bucket merges on read) through ``build_vector_index("emb",
    nlist=256, total_bits=1, rotator="fht")`` (4 shards, 1,024 lists, raw
    kept), VT_QUERIES ``vector_search`` queries at nprobe 256 and
    ``scan().vector_search(...).to_arrow()`` on VT_SCAN_QUERIES of them,
    with the ``bruteforce_topk`` oracle in the counted path.  Requires
    recall@10 >= 0.5, the first VT_CPU_HOLD queries' ids = the same table
    searched with ``device="cpu"`` (ties aside), and each scan's rows = its
    query's ids with the corpus's vectors."""
    import pyarrow as pa

    from lakesoul_tpu_torch.vector.builder import TableVectorIndex
    from lakesoul_tpu_torch.vector.oracle import recall_at_k

    x, queries = make_data(torch, DEVICE)
    queries = queries[:VT_QUERIES]
    qs_np = queries.cpu().numpy()
    schema = pa.schema([("id", pa.int64()), ("emb", pa.list_(pa.float32(), DIM))])
    wh = tempfile.mkdtemp(prefix="chip_smoke_vectors_")
    try:
        t0 = time.perf_counter()
        t = L.LakeSoulCatalog(wh).create_table(
            "embeddings", schema, primary_keys=["id"], hash_bucket_num=VT_BUCKETS,
            properties={"lakesoul.file_format": "lsf"})
        for lo in range(0, N_VECTORS, VT_CHUNK):
            hi = min(N_VECTORS, lo + VT_CHUNK)
            t.write_arrow(pa.table({
                "id": np.arange(lo, hi, dtype=np.int64),
                "emb": pa.FixedSizeListArray.from_arrays(
                    pa.array(x[lo:hi].cpu().numpy().reshape(-1)), DIM)}, schema=schema))
        write_s = time.perf_counter() - t0

        # ---- the main path, counted: build → search → scan → oracle
        reset_launches(K, R)
        t0 = time.perf_counter()
        indexed = t.build_vector_index("emb", nlist=VT_NLIST, total_bits=1, rotator="fht")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        # the searches share one handle, which holds the opened shards on
        # the card: p50 / p99 time searches with the shards open, the first
        # search (which opens them) is timed on its own
        index = TableVectorIndex(DEVICE)
        t0 = time.perf_counter()
        t.vector_search("emb", qs_np[0], top_k=10, nprobe=VT_NPROBE, index=index)
        first_s = time.perf_counter() - t0
        got, lat = [], []
        for q in qs_np:
            t0 = time.perf_counter()
            got.append(t.vector_search("emb", q, top_k=10, nprobe=VT_NPROBE, index=index))
            lat.append(time.perf_counter() - t0)
        scans = [t.scan().vector_search("emb", q, top_k=10, nprobe=VT_NPROBE,
                                        index=index).to_arrow()
                 for q in qs_np[:VT_SCAN_QUERIES]]
        top = torch.stack([K.bruteforce_topk(x, q, 10).indices for q in queries]).cpu().numpy()
        launches = read_launches(K, R)
        # ---- end of the counted main path
        index.release()

        require(indexed == N_VECTORS, f"build_vector_index indexed {indexed} rows")
        require(launches["packed_dot"] > 0 and launches["bruteforce_distances"] > 0,
                f"a kernel never ran on the table index's path: {launches}")
        require(all(len(i) == 10 and np.isfinite(d).all() for i, d in got),
                "vector_search returned short or non-finite results")
        recall = recall_at_k([set(r.tolist()) for r in top], [i for i, _ in got])
        require(recall >= RECALL_FLOOR, f"table index recall@10 {recall} < {RECALL_FLOOR}")
        x_np = None
        for (ids, _), tab in zip(got, scans):
            want = np.sort(ids.astype(np.int64))
            order = np.argsort(tab.column("id").to_numpy())
            require(np.array_equal(tab.column("id").to_numpy()[order], want),
                    "scan().vector_search rows != the search's ids")
            emb = np.asarray(tab.column("emb").combine_chunks().values).reshape(-1, DIM)[order]
            x_np = x[torch.from_numpy(want)].cpu().numpy()
            require(np.array_equal(emb, x_np), "scan().vector_search rows != the corpus's")
        t0 = time.perf_counter()
        with TableVectorIndex("cpu") as cpu_index:
            def on_cpu(q):
                return t.vector_search("emb", q, top_k=10, nprobe=VT_NPROBE, index=cpu_index)

            cpu = [on_cpu(qs_np[0])]  # opens the CPU shards, then VT_CPU_THREADS at a time
            with ThreadPoolExecutor(VT_CPU_THREADS) as pool:
                cpu += list(pool.map(on_cpu, qs_np[1:VT_CPU_HOLD]))
        cpu_s = time.perf_counter() - t0
        held = sum(same_topk(c[0], c[1], g[0], g[1]) for c, g in zip(cpu, got))
        require(held == VT_CPU_HOLD, f"the table index on the card != on the CPU on "
                                     f"{VT_CPU_HOLD - held} of {VT_CPU_HOLD} queries")
        gateway = phase_gateway_vector(K, R, t, qs_np, got, lat, kind)
        flight_sql = phase_flight_sql_vector(K, R, t, qs_np, got, kind)
    finally:
        shutil.rmtree(wh, ignore_errors=True)
    del x, queries
    lat_ms = np.array(lat) * 1e3
    rec = {"config": "the slice's corpus as a table: 1,000,000 x 512, id primary key, "
                     "hash_bucket_num 4, 1-bit fht, raw kept", "device_kind": kind,
           "rows": N_VECTORS, "dim": DIM, "hash_bucket_num": VT_BUCKETS, "nlist": VT_NLIST,
           "lists": VT_NLIST * VT_BUCKETS, "nprobe": VT_NPROBE, "write_s": write_s,
           "build_s": build_s, "first_search_s": first_s, "queries": VT_QUERIES,
           "search_p50_ms": float(np.percentile(lat_ms, 50)),
           "search_p99_ms": float(np.percentile(lat_ms, 99)),
           "recall_at_10": recall, "recall_floor": RECALL_FLOOR,
           "scan_vector_search_held": f"{len(scans)}/{len(scans)}",
           "card_equals_cpu": f"{held}/{VT_CPU_HOLD}", "cpu_search_s": cpu_s,
           "cpu_search_threads": VT_CPU_THREADS,
           "launches": launches}
    emit("vector_table", **rec)
    return {"launches": launches, "gateway": gateway, "flight_sql_vector": flight_sql}


@timed_phase
def phase_gateway_vector(K, R, t, qs_np, direct: list, direct_lat: list, kind: str) -> dict:
    """The table index served over Flight: an in-process
    ``LakeSoulFlightServer`` (a JWT secret, ``device=None``: the card) on the
    table's catalog, a bearer token, the VT_QUERIES queries through the
    ``vector_search`` action.  Each answer must equal the direct
    ``vector_search`` of the counted main path exactly, and ``packed_dot``
    must launch (counted from 0 around the queries)."""
    from lakesoul_tpu_torch.service import LakeSoulFlightClient, LakeSoulFlightServer
    from lakesoul_tpu_torch.service.jwt import Claims, JwtServer

    secret = secrets.token_hex(16)
    server = LakeSoulFlightServer(t.catalog, jwt_secret=secret, device=None)
    threading.Thread(target=server.serve, daemon=True).start()
    try:
        client = LakeSoulFlightClient(f"grpc://127.0.0.1:{server.port}",
                                      token=JwtServer(secret).create_token(Claims("chip_smoke")))

        def ask(q):
            return json.loads(client.action("vector_search", {
                "table": t.info.table_name, "column": "emb", "query": q.tolist(), "top_k": 10,
                "nprobe": VT_NPROBE})[0])

        t0 = time.perf_counter()
        ask(qs_np[0])  # opens the shards on the card, as the direct path's first search
        first_s = time.perf_counter() - t0
        reset_launches(K, R)
        got, lat = [], []
        for q in qs_np:
            t0 = time.perf_counter()
            got.append(ask(q))
            lat.append(time.perf_counter() - t0)
        launches = read_launches(K, R)
    finally:
        server.shutdown()
    held = sum(same_answer(g, *d) for g, d in zip(got, direct))
    lat_ms, d_ms = np.array(lat) * 1e3, np.array(direct_lat) * 1e3
    rec = {"config": "the table index behind LakeSoulFlightServer vector_search, "
                     f"{len(qs_np)} queries at nprobe {VT_NPROBE}", "device_kind": kind,
           "first_s": first_s, "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "direct_p50_ms": float(np.percentile(d_ms, 50)),
           "direct_p99_ms": float(np.percentile(d_ms, 99)),
           "held_exactly": f"{held}/{len(qs_np)}", "launches": launches}
    emit("gateway_vector", **rec)
    require(held == len(qs_np), f"{len(qs_np) - held} of {len(qs_np)} gateway answers != the "
                                "direct vector_search's")
    require(launches["packed_dot"] > 0, f"packed_dot never ran behind the gateway: {launches}")
    return {"launches": launches}


@timed_phase
def phase_flight_sql_vector(K, R, t, qs_np, direct: list, kind: str) -> dict:
    """The table index behind the Flight SQL server: an in-process
    ``LakeSoulFlightSqlServer`` (a JWT secret, ``device=None``: the card) on
    the table's catalog; ``SELECT count(*)`` over Flight SQL must equal
    ``count_rows()``, and the VT_QUERIES queries through the JSON
    fall-through's ``vector_search`` action on the same server must each
    equal the direct ``vector_search`` exactly, ``packed_dot`` launched
    (counted from 0 around the queries)."""
    from lakesoul_tpu_torch.service import (FlightSqlClient, LakeSoulFlightClient,
                                            LakeSoulFlightSqlServer)
    from lakesoul_tpu_torch.service.jwt import Claims, JwtServer

    secret = secrets.token_hex(16)
    server = LakeSoulFlightSqlServer(t.catalog, jwt_secret=secret,
                                     device=None if DEVICE == "cuda" else DEVICE)
    threading.Thread(target=server.serve, daemon=True).start()
    try:
        loc = f"grpc://127.0.0.1:{server.port}"
        token = JwtServer(secret).create_token(Claims("chip_smoke"))
        sql = FlightSqlClient(loc, token=token)
        t0 = time.perf_counter()
        counted = sql.execute(f"SELECT count(*) AS c FROM {t.info.table_name}").column(
            "c").to_pylist()
        count_s = time.perf_counter() - t0
        sql.close()
        client = LakeSoulFlightClient(loc, token=token)

        def ask(q):
            return json.loads(client.action("vector_search", {
                "table": t.info.table_name, "column": "emb", "query": q.tolist(), "top_k": 10,
                "nprobe": VT_NPROBE})[0])

        t0 = time.perf_counter()
        ask(qs_np[0])  # opens the shards on the card, as the direct path's first search
        first_s = time.perf_counter() - t0
        reset_launches(K, R)
        got, lat = [], []
        for q in qs_np:
            t0 = time.perf_counter()
            got.append(ask(q))
            lat.append(time.perf_counter() - t0)
        launches = read_launches(K, R)
    finally:
        server.shutdown()
    rows = t.scan().count_rows()
    held = sum(same_answer(g, *d) for g, d in zip(got, direct))
    lat_ms = np.array(lat) * 1e3
    rec = {"config": "the table index behind LakeSoulFlightSqlServer: SELECT count(*) over "
                     f"Flight SQL, then {len(qs_np)} vector_search actions at nprobe "
                     f"{VT_NPROBE}", "device_kind": kind, "count": counted, "count_rows": rows,
           "count_s": count_s, "first_s": first_s, "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)), "held_exactly": f"{held}/{len(qs_np)}",
           "launches": launches}
    emit("flight_sql_vector", **rec)
    require(counted == [rows], f"Flight SQL count(*) {counted} != count_rows() {rows}")
    require(held == len(qs_np), f"{len(qs_np) - held} of {len(qs_np)} Flight SQL server "
                                "answers != the direct vector_search's")
    require(launches["packed_dot"] > 0,
            f"packed_dot never ran behind the Flight SQL server: {launches}")
    return {"launches": launches}


def loader_schema():
    import pyarrow as pa

    fields = [("id", pa.int64())] + [(f"f{i}", pa.float32()) for i in range(LOADER_FEATURES)]
    return pa.schema(fields + [("label", pa.int32())])


def loader_chunks(n_rows: int, chunk: int = LOADER_CHUNK, seed: int = SEED):
    """``bench.py``'s rows (its ``_chunks``, bench.py:180-188, as this
    script's own copy): ``chunk``-row tables from one seeded generator."""
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    for start in range(0, n_rows, chunk):
        n = min(chunk, n_rows - start)
        cols = {"id": np.arange(start, start + n, dtype=np.int64)}
        for i in range(LOADER_FEATURES):
            cols[f"f{i}"] = rng.normal(size=n).astype(np.float32)
        cols["label"] = rng.integers(0, 2, n).astype(np.int32)
        yield pa.table(cols, schema=loader_schema())


def loader_upsert_wave(t, seed: int, n_rows: int) -> int:
    """``bench.py``'s ``_upsert_wave`` (bench.py:191-222, this script's own
    copy): re-write LOADER_UPSERT_FRAC of the keys, sampled without
    replacement from disjoint id ranges, in chunks.  Returns the rows
    upserted."""
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    n_up = int(n_rows * LOADER_UPSERT_FRAC)
    n_chunks = max(1, -(-n_up // LOADER_UPSERT_CHUNK))
    span = n_rows // n_chunks

    def sample(n, k):
        out = np.unique(rng.integers(0, n, int(k * 1.1) + 16, dtype=np.int64))
        while out.size < k:
            out = np.unique(np.concatenate([out, rng.integers(0, n, k, dtype=np.int64)]))
        rng.shuffle(out)
        return out[:k]

    for c in range(n_chunks):
        take = min(LOADER_UPSERT_CHUNK, n_up - c * LOADER_UPSERT_CHUNK)
        lo = c * span
        piece = lo + sample(min(span, n_rows - lo), take)
        cols = {"id": piece}
        for i in range(LOADER_FEATURES):
            cols[f"f{i}"] = rng.normal(size=len(piece)).astype(np.float32)
        cols["label"] = rng.integers(0, 2, len(piece)).astype(np.int32)
        t.upsert(pa.table(cols, schema=loader_schema()))
    return n_up


def loader_transform(b: dict) -> dict:
    """``bench.py``'s ``col_transform`` (bench.py:417-423): the feature
    columns concatenated into one ``[F, B]`` array, a straight memcpy.  Two
    differences: float32 (numpy has no bfloat16 without ml_dtypes; cast on
    the card if wanted) and no trim to a step multiple (a batch is one step
    here, so every delivered row is trained on); labels ride as int8."""
    x = np.concatenate([b[f"f{i}"] for i in range(LOADER_FEATURES)])
    return {"x": x.reshape(LOADER_FEATURES, -1), "y": b["label"].astype(np.int8)}


class ParquetFiles:
    """The comparator's dataset (``bench.py``'s ``bench_torch_baseline_e2e``
    in its PyTorch form): a stock map-style dataset, one parquet file (one
    500k-row row group, so one batch, as ``to_batches(batch_size=B)`` gives
    there) an item, read through ``pyarrow.dataset``.  Module-level, so that
    spawned DataLoader workers unpickle it."""

    def __init__(self, files):
        self.files = list(files)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int):
        import pyarrow.dataset as pads

        return pads.dataset(self.files[i], format="parquet").to_table()


def stack_collate(items):
    """The comparator's collate (bench.py:590-597): ``[B, F]`` float32 by
    ``np.stack`` and int32 labels, as torch tensors."""
    import torch

    t = items[0]
    x = np.stack([t.column(f"f{i}").to_numpy() for i in range(LOADER_FEATURES)], axis=1)
    y = t.column("label").to_numpy().astype(np.int32)
    return torch.from_numpy(x), torch.from_numpy(y)


def host_info() -> dict:
    """The host a loader's rows/s mostly measures: CPU count and model (the
    first processor's ``/proc/cpuinfo`` fields, which a sandbox may blank)."""
    import platform

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if not ln.strip():
                    break
                key, _, val = ln.partition(":")
                fields[key.strip()] = val.strip()
    except OSError:
        pass
    return {"cpu_count": os.cpu_count(), "cpu_model": fields.get("model name"),
            "cpu_vendor": fields.get("vendor_id"), "cpu_family": fields.get("cpu family"),
            "cpu_model_number": fields.get("model"), "machine": platform.machine()}


def dir_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)


def hash_batch(h, b, to_host) -> None:
    """Fold one batch's columns into ``h``: name, then bytes, in name order."""
    for name in sorted(b):
        h.update(name.encode())
        h.update(to_host(b[name]).tobytes())


def batches_sha(batches, to_host, rows_of=lambda b: b["id"].shape[0]) -> tuple[str, int]:
    """sha256 over every batch's columns (:func:`hash_batch`) and the rows
    seen."""
    h, rows = hashlib.sha256(), 0
    for b in batches:
        hash_batch(h, b, to_host)
        rows += int(rows_of(b))
    return h.hexdigest(), rows


def rss_mb() -> float:
    """This process's resident set now, MB (``/proc/self/statm``, else
    ``VmRSS``)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20
    except (OSError, IndexError, ValueError):
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmRSS:"):
                    return int(ln.split()[1]) / 1024.0
    raise RuntimeError("this process's resident set cannot be read")


class RssPeak:
    """The peak of :func:`rss_mb` while the block runs, sampled every 10 ms
    on a thread.  (micro.py reads ``ru_maxrss``, which a process started by
    fork + exec inherits from its parent, and the card's sandbox shows no
    ``VmHWM``.)"""

    def __enter__(self):
        self.start_mb = self.peak_mb = rss_mb()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.01):
            self.peak_mb = max(self.peak_mb, rss_mb())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak_mb = max(self.peak_mb, rss_mb())
        return False


def counter_value(name: str) -> float:
    from lakesoul_tpu_torch.obs import registry

    return registry().counter(name).value


def loader_replay(torch, t, make_step, count: int, streamed_rows_per_s: float) -> dict:
    """``bench.py``'s ``train_hbm`` leg on the same table and step: one
    untimed fill epoch with ``cache="device"``, then the best of
    REPLAY_EPOCHS replay epochs.  Requires every epoch's rows, replay >=
    TENSOR_REPLAY_FLOOR x the streamed rows/s, a replay epoch = a streamed
    epoch by sha256, no host-device sync on a replay epoch; at half the
    epoch's bytes the spill (a resident prefix + the streamed tail = the
    streamed epoch, its counters > 0); and permuted replays equal under one
    seed, a multiset of the stream's rows, in another order the next
    epoch."""
    def cached(**kw):
        return t.scan().batch_size(LOADER_BATCH).to_torch_iter(
            io_threads=LOADER_IO_THREADS, drop_remainder=False, device=DEVICE,
            cache="device", **kw)

    def rows_of(b):
        return b["y"].shape[0]

    step = make_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    it = cached(transform=loader_transform)
    rows = 0
    t0 = time.perf_counter()
    for b in it:
        step(b["x"].t(), b["y"])
        rows += int(rows_of(b))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    st = it.stats()["replay"]
    require(rows == count and st["ready"] and not st["spilled"],
            f"the fill epoch: {rows} rows, replay stats {st}")
    epochs = []
    for _ in range(REPLAY_EPOCHS):
        rows, loss = 0, None
        t0 = time.perf_counter()
        for b in it:
            loss = step(b["x"].t(), b["y"])
            rows += int(rows_of(b))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require(rows == count, f"a replay epoch delivered {rows} rows, not {count}")
        require(bool(torch.isfinite(loss)), "a non-finite loss in a replay epoch")
        epochs.append({"rows": rows, "wall_s": wall, "rows_per_s": rows / wall})
    best = max(e["rows_per_s"] for e in epochs)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ratio = best / streamed_rows_per_s
    require(ratio >= TENSOR_REPLAY_FLOOR,
            f"replay {best:.0f} rows/s is {ratio:.2f}x the stream, under {TENSOR_REPLAY_FLOOR}x")
    # no host-device sync on a replay epoch: the debug mode raises on any
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        synced_rows = sum(int(rows_of(b)) for b in it)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    require(synced_rows == count, "the sync-checked replay epoch lost rows")
    to_host = lambda v: v.cpu().numpy()  # noqa: E731
    replay_sha = batches_sha(it, to_host, rows_of)
    stream_sha = batches_sha(
        t.scan().batch_size(LOADER_BATCH).to_torch_iter(
            transform=loader_transform, io_threads=LOADER_IO_THREADS, drop_remainder=False,
            device=DEVICE), to_host, rows_of)
    require(replay_sha == stream_sha, f"a replay epoch != a streamed epoch: {replay_sha} "
                                      f"{stream_sha}")
    resident_bytes = st["resident_bytes"]
    del it
    torch.cuda.empty_cache()

    # at half the epoch's bytes: a resident prefix, then the streamed tail
    spilled_before = (counter_value("lakesoul_replay_spilled_batches_total"),
                      counter_value("lakesoul_replay_spilled_bytes_total"))
    it = cached(transform=loader_transform, replay_budget_bytes=resident_bytes // 2)
    rows = sum(int(rows_of(b)) for b in it)
    sst = it.stats()["replay"]
    spilled_delta = (counter_value("lakesoul_replay_spilled_batches_total") - spilled_before[0],
                     counter_value("lakesoul_replay_spilled_bytes_total") - spilled_before[1])
    t0 = time.perf_counter()
    spill_sha = batches_sha(it, to_host, rows_of)
    spill_s = time.perf_counter() - t0
    require(rows == count and sst["spilled"] and sst["ready"], f"the spill: {sst}")
    require(all(v > 0 for v in spilled_delta), f"the spill counters did not move: {spilled_delta}")
    require(spill_sha == stream_sha, f"resident prefix + streamed tail != the stream: "
                                     f"{spill_sha} {stream_sha}")
    spill = dict(vars(it._replay.spill))
    del it
    torch.cuda.empty_cache()

    # permuted: the rows as the table holds them (the permutation takes the
    # leading dim, so no transform here), two iterators under one seed
    def epoch_columns(batches):
        cols = collections.defaultdict(list)
        for b in batches:
            for k, v in b.items():
                cols[k].append(v)
        return {k: torch.cat(v) for k, v in cols.items()}

    def by_id(cols):
        order = torch.argsort(cols["id"])
        return {k: v[order] for k, v in cols.items()}

    a, b_ = cached(replay_permute=True, replay_seed=SEED), cached(replay_permute=True,
                                                                 replay_seed=SEED)
    stream_cols = epoch_columns(a)  # the fill epoch is the stream
    for _ in b_:
        pass
    a1, b1 = epoch_columns(a), epoch_columns(b_)
    same_seed = all(torch.equal(a1[k], b1[k]) for k in a1)
    multiset = all(torch.equal(x, y) for x, y in zip(by_id(a1).values(),
                                                      by_id(stream_cols).values()))
    del b1, b_
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the permuted replay adds no sync either
    try:
        a2 = epoch_columns(a)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    moved = not torch.equal(a1["id"], a2["id"])
    permuted = not torch.equal(a1["id"], stream_cols["id"])
    n_rows = int(a1["id"].shape[0])
    require(n_rows == count and same_seed and multiset and moved and permuted,
            f"permuted replay: rows {n_rows}, same seed {same_seed}, multiset {multiset}, "
            f"another order next epoch {moved}, permuted {permuted}")
    del a, a1, a2, stream_cols
    torch.cuda.empty_cache()
    return {"fill_epoch_s": fill_s, "replay_epochs": epochs,
            "hbm_resident_replay_rows_per_s": best, "streamed_rows_per_s": streamed_rows_per_s,
            "replay_over_stream": ratio, "replay_floor": TENSOR_REPLAY_FLOOR,
            "resident_bytes": resident_bytes, "resident_batches": st["resident_batches"],
            "peak_device_gb": peak_gb, "replay_sha256": replay_sha[0],
            "replay_equals_stream": True, "no_sync_on_replay": True,
            "spill": {"budget_bytes": resident_bytes // 2, "record": spill,
                      "resident_batches": sst["resident_batches"],
                      "resident_rows": sst["resident_rows"],
                      "spilled_batches_delta": spilled_delta[0],
                      "spilled_bytes_delta": spilled_delta[1],
                      "hybrid_epoch_s": spill_s, "prefix_plus_tail_equals_stream": True},
            "permute": {"seed": SEED, "rows": n_rows, "same_seed_equal": same_seed,
                        "multiset_of_stream": multiset, "next_epoch_reordered": moved}}


def pinned_stats(torch) -> dict:
    """PyTorch's caching host allocator's byte counters (pinned memory), as
    far as this torch exposes them."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return {"note": "torch.cuda.host_memory_stats is absent in this torch"}
    return {k: v for k, v in stats().items() if "bytes" in k}


def run_fleet_ranks(wh: str, extra=(), env_extra=None) -> tuple[list, float]:
    """``python -m lakesoul_tpu_torch.fleet train --device-put`` as
    FLEET_RANKS processes on the one card; their JSON lines and the wall
    seconds.  A rank still running at FLEET_TIMEOUT_S is killed."""
    t0 = time.perf_counter()
    procs = []
    for rank in range(FLEET_RANKS):
        env = child_env(LAKESOUL_FLEET_PROCESS_INDEX=str(rank),
                        LAKESOUL_FLEET_PROCESS_COUNT=str(FLEET_RANKS), **(env_extra or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "lakesoul_tpu_torch.fleet", "train", "--warehouse", wh,
             "--table", "bench", "--batch-size", str(LOADER_BATCH), "--device-put", *extra],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=FLEET_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:  # past the timeout: stop every rank
            if p.poll() is None:
                p.kill()
                p.wait()
    lines = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f"fleet train rank {rank} exited {p.returncode}: "
                                   f"{err[-3000:]}")
        lines.append(json.loads(out.strip().splitlines()[-1]))
    return lines, time.perf_counter() - t0


def check_fleet_lines(lines: list, oracle: list, count: int, what: str) -> None:
    """Each rank's (rows, sha256) = the shard oracle's, each saw a card, and
    the ranks' rows sum to ``count_rows()``."""
    for rank, (ln, want) in enumerate(zip(lines, oracle)):
        require((ln["rows"], ln["sha256"]) == (want["rows"], want["sha256"]),
                f"{what} rank {rank}: {ln} != the shard oracle {want}")
        require(ln["local_devices"] >= 1 and ln["process_index"] == rank,
                f"{what} rank {rank} saw no card: {ln}")
    require(sum(ln["rows"] for ln in lines) == count,
            f"{what}: the ranks' rows {[ln['rows'] for ln in lines]} do not sum to {count}")


@timed_phase
def phase_fleet_train(torch, L, wh: str, count: int, kind: str) -> dict:
    """``python -m lakesoul_tpu_torch.fleet train --device-put`` as two
    processes on the one card (``LAKESOUL_FLEET_PROCESS_INDEX`` / ``_COUNT``
    0/2 and 1/2) over the loader's table, publishing to a fleet spool: each
    rank's sha256 must equal ``digest_batch`` folded over
    ``scan.shard(rank, 2).to_torch_iter(device="cpu")`` here, the ranks'
    rows must sum to ``count_rows()``, each must see a card, and the fleet
    aggregator must read both members.  Returns the record, whose
    ``oracle`` the ``--location`` leg (``phase_scanplane``) is held to."""
    from lakesoul_tpu_torch.fleet.multihost import digest_batch
    from lakesoul_tpu_torch.obs.fleet import FleetAggregator

    spool = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        lines, wall = run_fleet_ranks(wh, env_extra={"LAKESOUL_OBS_SPOOL": spool})
        members = FleetAggregator(spool, stale_after_s=3600).members()
    finally:
        shutil.rmtree(spool, ignore_errors=True)
    t0 = time.perf_counter()
    oracle = []
    for rank in range(FLEET_RANKS):
        scan = L.LakeSoulCatalog(wh).scan("bench").batch_size(LOADER_BATCH).shard(rank,
                                                                                 FLEET_RANKS)
        digest, rows = hashlib.sha256(), 0
        for b in scan.to_torch_iter(device="cpu", drop_remainder=False):
            rows += digest_batch(digest, b)
        oracle.append({"rows": rows, "sha256": digest.hexdigest()})
    oracle_s = time.perf_counter() - t0
    rec = {"config": f"{FLEET_RANKS} fleet train processes on one card over the loader's "
                     f"table, batch {LOADER_BATCH}, --device-put", "device_kind": kind,
           "ranks": [{**ln, "rows_per_s": ln["rows"] / ln["elapsed_s"]} for ln in lines],
           "oracle": oracle, "oracle_s": oracle_s, "wall_s": wall, "count_rows": count,
           "fleet_members": sorted(m["service_id"] for m in members),
           "fleet_member_chips": sorted(m["chips"] for m in members)}
    emit("fleet_train", **rec)
    check_fleet_lines(lines, oracle, count, "fleet train")
    require(rec["fleet_members"] == [f"rank{r}" for r in range(FLEET_RANKS)]
            and min(rec["fleet_member_chips"]) >= 1,
            f"the fleet spool holds {rec['fleet_members']}, chips {rec['fleet_member_chips']}")
    return rec


@timed_phase
def phase_sql(torch, M, L, t, kind: str) -> dict:
    """The SQL layer on the loader's table, with pandas unimportable:
    ``scan.filter(SQL_FILTER)`` feeds ``to_torch_iter`` into the loader's
    MLP step, its rows = a numpy count over the same columns read without
    the filter; ``SqlSession`` runs SQL_GROUP_BY: counts equal numpy's,
    means within 1e-6 relative.  Host seconds."""
    from lakesoul_tpu_torch.sql import SqlSession

    held = sys.modules.get("pandas", False)
    sys.modules["pandas"] = None  # any import of pandas on this path raises
    try:
        model = M.MLP(LOADER_FEATURES, hidden=LOADER_HIDDEN, seed=SEED, device=DEVICE)
        step = M.make_mlp_train_step(model, M.adam(model.parameters(), LOADER_LR), device=DEVICE)
        t0 = time.perf_counter()
        rows, loss = 0, None
        for b in t.scan().filter(SQL_FILTER).batch_size(LOADER_BATCH).to_torch_iter(
                transform=loader_transform, io_threads=LOADER_IO_THREADS,
                drop_remainder=False, device=DEVICE):
            loss = step(b["x"].t(), b["y"])
            rows += int(b["y"].shape[0])
        torch.cuda.synchronize()
        filter_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cols = t.scan().select(["f0", "label"]).to_arrow()
        f0 = cols.column("f0").to_numpy()
        label = cols.column("label").to_numpy()
        want_rows = int(((f0 > 0.5) & (label == 1)).sum())
        numpy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = SqlSession(t.catalog, device=DEVICE).execute(SQL_GROUP_BY)
        sql_s = time.perf_counter() - t0
    finally:
        if held is False:
            del sys.modules["pandas"]
        else:
            sys.modules["pandas"] = held
    groups = out.to_pylist()
    want = [{"label": int(k), "n": int((label == k).sum()),
             "mean_f0": float(np.mean(f0[label == k], dtype=np.float64))}
            for k in np.unique(label)]
    rec = {"device_kind": kind, "filter": SQL_FILTER, "rows_delivered": rows,
           "numpy_rows": want_rows, "filter_s": filter_s, "loss_last": float(loss),
           "numpy_s": numpy_s, "query": SQL_GROUP_BY, "sql_s": sql_s, "groups": groups,
           "numpy_groups": want, "pandas_blocked": True}
    emit("sql", **rec)
    require(rows == want_rows > 0, f"the filtered feed gave {rows} rows, numpy {want_rows}")
    require(bool(torch.isfinite(loss)), "a non-finite loss in the filtered feed's step")
    require(len(groups) == len(want) and all(
        g["label"] == w["label"] and g["n"] == w["n"]
        and abs(g["mean_f0"] - w["mean_f0"]) <= 1e-6 * abs(w["mean_f0"])
        for g, w in zip(groups, want)), f"GROUP BY {groups} != numpy {want}")
    return rec


def arrow_sha(tab) -> str:
    """sha256 over a result's column names, types and values, in order."""
    h = hashlib.sha256()
    for name, col in zip(tab.column_names, tab.columns):
        col = col.combine_chunks()
        h.update(f"{name}:{col.type}".encode())
        h.update(col.to_numpy(zero_copy_only=False).tobytes())
    return h.hexdigest()


def columns_sha(cols: dict) -> tuple[str, int]:
    """sha256 over numpy columns sorted by ``id``, names in order; rows."""
    order = np.argsort(cols["id"], kind="stable")
    h = hashlib.sha256()
    for name in sorted(cols):
        h.update(name.encode())
        h.update(np.ascontiguousarray(cols[name][order]).tobytes())
    return h.hexdigest(), int(len(order))


def first_lines(proc, n: int, timeout_s: float = SERVICE_START_S) -> tuple[list, float]:
    """The first ``n`` lines ``proc`` prints (fewer past ``timeout_s``) and
    the seconds they took."""
    lines, t0 = [], time.perf_counter()

    def read():
        for _ in range(n):
            line = proc.stdout.readline()
            if not line:
                return
            lines.append(line)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    reader.join(timeout_s)
    return list(lines), time.perf_counter() - t0


def card_default() -> tuple:
    """A deployable's ``--device``: none on the card (its default), the
    CPU's when a rehearsal sets DEVICE."""
    return () if DEVICE == "cuda" else ("--device", DEVICE)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def log_tail(log) -> str:
    log.seek(0)
    return log.read()[-3000:]


def stop_service(proc, log, what: str) -> int:
    """SIGINT a deployable that starts no child; require it to exit 0 with
    no child left; its exit code."""
    children = proc_children(proc.pid)
    stop_child(proc)
    alive = [pid for pid in children if proc_alive(pid)]
    for pid in alive:
        os.kill(pid, signal.SIGKILL)
    require(not alive, f"{what} left children alive after SIGINT: {alive}")
    require(proc.returncode == 0, f"{what} exited {proc.returncode} on SIGINT: {log_tail(log)}")
    return proc.returncode


def start_fake_s3(access_key: str, secret_key: str):
    """A stdlib S3 endpoint on 127.0.0.1 holding objects in memory, which
    checks every request's SigV4 signature with the port's ``sigv4`` (the
    signer the CPU tests hold against AWS's published examples); returns
    the server, its objects and its count of refused signatures."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from lakesoul_tpu_torch.service import sigv4

    objects, refused = {}, [0]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _signed(self) -> bool:
            path, _, query = self.path.partition("?")
            if sigv4.verify_signature(self.command, path, query, dict(self.headers),
                                      secret_keys={access_key: secret_key}):
                return True
            refused[0] += 1
            self.send_error(403, "SignatureDoesNotMatch")
            return False

        def do_PUT(self):
            if self._signed():
                objects[self.path] = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        def do_GET(self):
            if not self._signed():
                return
            body = objects.get(self.path)
            if body is None:
                self.send_error(404, "NoSuchKey")
                return
            lo, hi, rng = 0, len(body), self.headers.get("Range", "")
            if rng.startswith("bytes="):
                lo_s, _, hi_s = rng[6:].partition("-")
                lo, hi = int(lo_s), int(hi_s) + 1 if hi_s else len(body)
                self.send_response(206)
                self.send_header("Content-Range", f"bytes {lo}-{hi - 1}/{len(body)}")
            else:
                self.send_response(200)
            self.send_header("Content-Length", str(hi - lo))
            self.end_headers()
            self.wfile.write(body[lo:hi])

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, objects, refused


@timed_phase
def phase_flight_sql(torch, L, t, count: int, kind: str) -> dict:
    """The deployable Flight SQL server on the loader's table: ``python -m
    lakesoul_tpu_torch.service.flight_sql --port 0 --jwt-secret ...
    --metrics-port ...`` as a child (the card by default).  Through
    ``FlightSqlClient`` with a bearer token: SQL_GROUP_BY and FSQL_SELECT
    equal the in-process ``SqlSession``'s answers by sha256; FSQL_PREPARED
    prepared once, run with both FSQL_BOUNDS, each = the literal statement
    in process; ``GetTables`` lists ``bench`` with its schema; a
    FSQL_INGEST_ROWS-row table in the loader's schema ingested inside
    ``begin_transaction`` is invisible before ``commit`` and visible after,
    its transaction id replayed to the same server is refused and to a
    second server on the warehouse is a no-op, a rolled-back transaction
    leaves no row and no staged file; the ingested table read through
    ``to_torch_iter`` on the card, copied back, = the ingested rows by
    sha256; ``/metrics`` serves ``lakesoul_flight_*`` series; SIGINT stops
    the server with exit 0 and no child left.  Statement seconds, DoGet
    rows/s, ingest rows/s, commit seconds."""
    import urllib.request

    import pyarrow as pa
    import pyarrow.flight as flight

    from lakesoul_tpu_torch.service import FlightSqlClient, LakeSoulFlightSqlServer
    from lakesoul_tpu_torch.service import _flight_sql_pb2 as pb
    from lakesoul_tpu_torch.service.flight_sql import _pack, bind_parameters
    from lakesoul_tpu_torch.service.jwt import Claims, JwtServer
    from lakesoul_tpu_torch.sql import SqlSession

    cat = t.catalog
    wh, db = cat.warehouse, cat.client.store.db_path
    secret, mport = secrets.token_hex(16), free_port()
    log = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "lakesoul_tpu_torch.service.flight_sql", "--warehouse", wh,
         "--db-path", db, "--host", "127.0.0.1", "--port", "0", "--jwt-secret", secret,
         "--metrics-port", str(mport), *card_default()],
        env=child_env(), stdout=subprocess.PIPE, stderr=log, text=True)
    name = "fsql_ingest"
    try:
        lines, start_s = first_lines(proc, 2)
        head = "Flight SQL server on grpc://127.0.0.1:"
        require(len(lines) == 2 and lines[1].startswith(head) and "(auth=jwt)" in lines[1],
                f"the Flight SQL server printed {lines} in {start_s:.1f} s: {log_tail(log)}")
        port = int(lines[1][len(head):].split()[0])
        require(port > 0, f"--port 0 printed port {port}")
        loc = f"grpc://127.0.0.1:{port}"
        token = JwtServer(secret).create_token(Claims("chip_smoke"))
        client = FlightSqlClient(loc, token=token)
        raw = flight.FlightClient(loc)
        opts = flight.FlightCallOptions(headers=[(b"authorization", f"Bearer {token}".encode())])
        local = SqlSession(cat, device=DEVICE)

        # statements: GetFlightInfo runs the query, DoGet streams its result
        statements = []
        for q in (SQL_GROUP_BY, FSQL_SELECT):
            desc = flight.FlightDescriptor.for_command(
                _pack(pb.CommandStatementQuery(query=q)))
            t0 = time.perf_counter()
            info = raw.get_flight_info(desc, options=opts)
            info_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = raw.do_get(info.endpoints[0].ticket, options=opts).read_all()
            get_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = local.execute(q)
            local_s = time.perf_counter() - t0
            statements.append({"query": q, "rows": got.num_rows, "statement_s": info_s,
                               "do_get_s": get_s, "do_get_rows_per_s": got.num_rows / get_s,
                               "in_process_s": local_s, "sha256": arrow_sha(got),
                               "in_process_sha256": arrow_sha(want)})
            require(got.num_rows > 0 and arrow_sha(got) == arrow_sha(want),
                    f"Flight SQL's answer to {q!r} != SqlSession's: {got.slice(0, 3).to_pylist()} "
                    f"{want.slice(0, 3).to_pylist()}")

        handle = client.prepare(FSQL_PREPARED)
        prepared = []
        for lo, hi in FSQL_BOUNDS:
            t0 = time.perf_counter()
            got = client.execute_prepared(handle, params=[lo, hi])
            run_s = time.perf_counter() - t0
            want = local.execute(bind_parameters(FSQL_PREPARED, None, [lo, hi]))
            prepared.append({"bounds": [lo, hi], "rows": got.num_rows, "seconds": run_s})
            require(got.num_rows == hi - lo and arrow_sha(got) == arrow_sha(want),
                    f"the prepared statement on [{lo}, {hi}) != SqlSession's")
        client.close_prepared(handle)

        tables = client.get_tables(table_pattern="bench", include_schema=True).to_pylist()
        require(len(tables) == 1 and pa.ipc.read_schema(pa.py_buffer(
            tables[0]["table_schema"])).equals(t.schema),
                f"GetTables does not list bench with its schema: {tables}")

        # transactions
        data = next(loader_chunks(FSQL_INGEST_ROWS, FSQL_INGEST_ROWS, seed=SEED + 14))

        def count_of() -> int:
            return client.execute(f"SELECT count(*) AS c FROM {name}").column("c").to_pylist()[0]

        txn = client.begin_transaction()
        t0 = time.perf_counter()
        n = client.ingest(name, data, transaction_id=txn, primary_keys=["id"])
        ingest_s = time.perf_counter() - t0
        before_commit = count_of()
        t0 = time.perf_counter()
        client.commit(txn)
        commit_s = time.perf_counter() - t0
        after_commit = count_of()
        require(n == FSQL_INGEST_ROWS and before_commit == 0 and after_commit == n,
                f"transaction: ingested {n}, {before_commit} rows before commit, "
                f"{after_commit} after")
        try:
            client.ingest(name, data, transaction_id=txn)
            refused = None
        except flight.FlightError as e:
            refused = str(e).split(". Detail:")[0]
        require(refused is not None and "already ended" in refused,
                f"a replay of the ended transaction was not refused: {refused}")
        peer = LakeSoulFlightSqlServer(L.LakeSoulCatalog(wh, db_path=db), jwt_secret=secret,
                                       device=None if DEVICE == "cuda" else DEVICE)
        threading.Thread(target=peer.serve, daemon=True).start()
        try:
            peer_client = FlightSqlClient(f"grpc://127.0.0.1:{peer.port}", token=token)
            replayed = peer_client.ingest(name, data, transaction_id=txn)
            peer_client.close()
        finally:
            peer.shutdown()
        after_replay = count_of()
        require(after_replay == n, f"the replay to a second server added rows: {after_replay}")
        table_dir = cat.table(name).info.table_path
        files_before = sorted(os.listdir(table_dir))
        txn2 = client.begin_transaction()
        ids = np.arange(FSQL_INGEST_ROWS, 2 * FSQL_INGEST_ROWS, dtype=np.int64)
        client.ingest(name, data.set_column(0, "id", pa.array(ids)), transaction_id=txn2)
        client.rollback(txn2)
        after_rollback = count_of()
        require(after_rollback == n and sorted(os.listdir(table_dir)) == files_before,
                f"the rollback left {after_rollback - n} rows or staged files")

        # the ingested table on the card
        batches, on_card = [], True
        for b in cat.table(name).scan().batch_size(LOADER_BATCH).to_torch_iter(
                device=DEVICE, drop_remainder=False):
            on_card = on_card and all(v.device.type == torch.device(DEVICE).type
                                      for v in b.values())
            batches.append({k: v.cpu().numpy() for k, v in b.items()})
        card = columns_sha({k: np.concatenate([b[k] for b in batches]) for k in batches[0]})
        want = columns_sha({c: data.column(c).to_numpy() for c in data.column_names})
        require(on_card and card == want,
                f"the ingested table read on the card {card} != the ingested rows {want}")

        text = urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics", timeout=10).read()
        series = sorted({line.split("{")[0].split()[0] for line in text.decode().splitlines()
                         if line.startswith("lakesoul_flight_")})
        require(len(series) > 0, "/metrics serves no lakesoul_flight_* series")
        client.close()
        raw.close()
    finally:
        code = stop_service(proc, log, "the Flight SQL server")
        if name in cat.list_tables():
            cat.drop_table(name)
    rec = {"config": "python -m lakesoul_tpu_torch.service.flight_sql (the card, JWT) over the "
                     "loader's 20M-row table", "device_kind": kind, "count_rows": count,
           "start_s": start_s, "statements": statements, "prepared": prepared,
           "get_tables": "bench with its schema", "ingest_rows": n, "ingest_s": ingest_s,
           "ingest_rows_per_s": n / ingest_s, "commit_s": commit_s,
           "rows_before_commit": before_commit, "rows_after_commit": after_commit,
           "replay_same_server": refused, "replay_second_server_rows_read": replayed,
           "rows_after_replay": after_replay, "rows_after_rollback": after_rollback,
           "card_sha256": card[0], "card_rows": card[1], "metrics_series": series,
           "sigint_exit": code}
    emit("flight_sql", **rec)
    return rec


@timed_phase
def phase_storage_proxy(L, t, kind: str) -> dict:
    """The deployable storage proxy on the loader's table, twice at once:
    ``python -m lakesoul_tpu_torch.service.storage_proxy --port 0
    --jwt-secret ...`` in direct mode, and with ``LAKESOUL_PROXY_S3_*``
    pointing at :func:`start_fake_s3`.  Direct: every live data file fetched
    through ``ProxyStorageClient`` in PROXY_RANGE ``Range`` GETs, each = its
    local file by sha256; ``list_objects`` covers the live files with their
    sizes; a table of another domain answers 403; a PROXY_MP_BYTES multipart
    PUT in PROXY_MP_PARTS parts round-trips.  Through the S3 upstream: the
    object PUT and read back in ranged GETs, = by sha256, no signature
    refused.  GB/s direct and through the upstream; each stopped by SIGINT,
    exit 0, no child."""
    from lakesoul_tpu_torch.service.jwt import Claims, JwtServer
    from lakesoul_tpu_torch.service.storage_proxy import ProxyStorageClient

    cat = t.catalog
    wh, db = cat.warehouse, cat.client.store.db_path
    secret = secrets.token_hex(16)
    token = JwtServer(secret).create_token(Claims("chip_smoke"))
    files = sorted({p for u in t.scan().scan_plan() for p in u.data_files})
    blob = np.random.default_rng(SEED + 14).integers(0, 256, PROXY_MP_BYTES,
                                                     dtype=np.uint8).tobytes()
    blob_sha = hashlib.sha256(blob).hexdigest()
    key = "default/bench/_chip_smoke/proxy.bin"

    def ranged_sha(client, k: str, size: int) -> tuple[str, float]:
        h, wait = hashlib.sha256(), 0.0
        for lo in range(0, size, PROXY_RANGE):
            t0 = time.perf_counter()
            piece = client.get(k, range_header=f"bytes={lo}-{min(size, lo + PROXY_RANGE) - 1}")
            wait += time.perf_counter() - t0
            h.update(piece)
        return h.hexdigest(), wait

    access, s3_secret = "AKIDCHIPSMOKE", secrets.token_hex(20)
    fake, objects, refused = start_fake_s3(access, s3_secret)
    envs = {"direct": {}, "s3-upstream": {
        "LAKESOUL_PROXY_S3_ENDPOINT": f"http://127.0.0.1:{fake.server_port}",
        "LAKESOUL_PROXY_S3_BUCKET": "lake", "LAKESOUL_PROXY_S3_ACCESS_KEY": access,
        "LAKESOUL_PROXY_S3_SECRET_KEY": s3_secret}}
    procs = {}
    for mode, env in envs.items():
        log = tempfile.TemporaryFile(mode="w+")
        procs[mode] = (subprocess.Popen(
            [sys.executable, "-m", "lakesoul_tpu_torch.service.storage_proxy", "--warehouse", wh,
             "--db-path", db, "--host", "127.0.0.1", "--port", "0", "--jwt-secret", secret],
            env=child_env(**env), stdout=subprocess.PIPE, stderr=log, text=True), log)
    fenced = "proxy_fenced"
    try:
        clients, start_s = {}, {}
        head = "storage proxy on http://127.0.0.1:"
        for mode, (proc, log) in procs.items():
            lines, start_s[mode] = first_lines(proc, 1)
            require(len(lines) == 1 and lines[0].startswith(head)
                    and f"({mode}, auth=jwt)" in lines[0],
                    f"the {mode} proxy printed {lines} in {start_s[mode]:.1f} s: "
                    f"{log_tail(log)}")
            clients[mode] = ProxyStorageClient(
                f"http://127.0.0.1:{int(lines[0][len(head):].split()[0])}", token=token)

        # ---- direct
        client = clients["direct"]
        fetched, get_s, local_equal = 0, 0.0, 0
        for path in files:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                local = hashlib.file_digest(f, "sha256").hexdigest()
            k = path[len(wh) + 1:]
            require(client.head(k) == size, f"HEAD {k} != its {size} bytes")
            got, wait = ranged_sha(client, k, size)
            fetched, get_s = fetched + size, get_s + wait
            local_equal += got == local
        require(local_equal == len(files) > 0,
                f"{len(files) - local_equal} of {len(files)} files fetched != their local bytes")
        listed = dict(client.list_objects("default/bench"))
        missing = [p for p in files if listed.get(p[len(wh) + 1:]) != os.path.getsize(p)]
        require(not missing, f"list_objects misses {len(missing)} live files: {missing[:3]}")
        cat.client.create_table(fenced, f"{wh}/default/{fenced}", loader_schema(),
                                domain="chip_smoke_other")
        try:
            client.get(f"default/{fenced}/part-0.lsf")
            forbidden = None
        except PermissionError as e:
            forbidden = str(e)
        require(forbidden is not None and "403" in forbidden,
                f"a table of another domain was not refused with 403: {forbidden}")
        part = PROXY_MP_BYTES // PROXY_MP_PARTS
        t0 = time.perf_counter()
        upload = client.initiate_multipart(key)
        for i in range(PROXY_MP_PARTS):
            client.upload_part(key, upload, i + 1, blob[i * part:(i + 1) * part])
        client.complete_multipart(key, upload)
        mp_s = time.perf_counter() - t0
        mp_sha, mp_get_s = ranged_sha(client, key, PROXY_MP_BYTES)
        require(mp_sha == blob_sha, "the multipart object read back != its parts")
        client.delete(key)

        # ---- through the S3 upstream, to the fake S3 that checks every signature
        client = clients["s3-upstream"]
        t0 = time.perf_counter()
        client.put(key, blob)
        up_put_s = time.perf_counter() - t0
        up_sha, up_get_s = ranged_sha(client, key, PROXY_MP_BYTES)
        stored = hashlib.sha256(objects.get(f"/lake/{key}", b"")).hexdigest()
    finally:
        children = {mode: proc_children(proc.pid) for mode, (proc, _) in procs.items()}
        for proc, _ in procs.values():
            stop_child(proc)
        fake.shutdown()
        fake.server_close()
        if fenced in cat.list_tables():
            cat.drop_table(fenced)
    exits = {mode: proc.returncode for mode, (proc, _) in procs.items()}
    alive = [pid for pids in children.values() for pid in pids if proc_alive(pid)]
    require(not alive and set(exits.values()) == {0},
            f"the proxies exited {exits} on SIGINT, children alive {alive}")
    require(up_sha == blob_sha == stored, "the object through the S3 upstream != its bytes")
    require(refused[0] == 0, f"the fake S3 refused {refused[0]} signatures")
    gb = 1e9
    rec = {"config": "python -m lakesoul_tpu_torch.service.storage_proxy (JWT) over the loader's "
                     "20M-row table, direct and with LAKESOUL_PROXY_S3_* to a stdlib fake S3 "
                     "checking SigV4", "device_kind": kind, "files": len(files),
           "bytes": fetched, "range_bytes": PROXY_RANGE, "start_s": start_s,
           "direct_get_s": get_s, "direct_get_gb_per_s": fetched / get_s / gb,
           "files_equal": local_equal, "listed": len(listed),
           "other_domain": forbidden.split(":")[0], "multipart_bytes": PROXY_MP_BYTES,
           "multipart_parts": PROXY_MP_PARTS, "multipart_put_s": mp_s,
           "multipart_put_gb_per_s": PROXY_MP_BYTES / mp_s / gb,
           "multipart_get_gb_per_s": PROXY_MP_BYTES / mp_get_s / gb,
           "upstream_put_s": up_put_s, "upstream_put_gb_per_s": PROXY_MP_BYTES / up_put_s / gb,
           "upstream_get_s": up_get_s, "upstream_get_gb_per_s": PROXY_MP_BYTES / up_get_s / gb,
           "signatures_refused": refused[0], "sigint_exit": exits}
    emit("storage_proxy", **rec)
    return rec


def start_console(t) -> dict:
    """``python -m lakesoul_tpu_torch.service.console -w WH -c ...`` for
    ``count bench`` and ``lint``, and the lint phase's three ``python -m
    lakesoul_tpu_torch.analysis`` children, started together; they run
    beside the Flight SQL and proxy phases, and :func:`phase_console` and
    :func:`phase_lint` read them.  The lint children are each read by a
    thread that notes when its child ended: their ``seconds`` are their own."""
    started = time.perf_counter()
    procs = {line: subprocess.Popen(
        [sys.executable, "-m", "lakesoul_tpu_torch.service.console", "-w", t.catalog.warehouse,
         "-c", line, *card_default()], env=child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for line in ("count bench", "lint")}
    seeded_dir = tempfile.mkdtemp(prefix="lakesoul-lint-")
    seeded = os.path.join(seeded_dir, "seeded.py")
    with open(seeded, "w") as f:
        f.write(LINT_SEEDED)
    os.makedirs(os.path.join(seeded_dir, "csrc"))
    with open(os.path.join(seeded_dir, "csrc", "seeded.cu"), "w") as f:
        f.write(LINT_SEEDED_CU)
    lint = {}
    for name, args in (("port_sarif", ["--format", "sarif"]),
                       ("seeded", [seeded, "--no-baseline", "--format", "json"]),
                       ("unknown_rule", ["--rule", "nosuch"])):
        proc = subprocess.Popen([sys.executable, "-m", "lakesoul_tpu_torch.analysis", *args],
                                env=child_env(), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        run = {"proc": proc, "started": time.perf_counter()}

        def read(run=run):
            run["out"], run["err"] = run["proc"].communicate()
            run["seconds"] = time.perf_counter() - run["started"]

        run["reader"] = threading.Thread(target=read, daemon=True)
        run["reader"].start()
        lint[name] = run
    return {"started": started, "procs": procs, "lint": lint, "seeded_dir": seeded_dir}


def kill_console(console: dict) -> None:
    runs = [*console["procs"].values(), *(r["proc"] for r in console["lint"].values())]
    for proc in runs:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    for run in console["lint"].values():
        run["reader"].join()
    shutil.rmtree(console["seeded_dir"], ignore_errors=True)


@timed_phase
def phase_console(console: dict, count: int, kind: str) -> dict:
    """The console children of :func:`start_console`: ``count bench`` prints
    ``count_rows()``; ``lint`` prints the clean line; each exits 0."""
    outs = {}
    for line, proc in console["procs"].items():
        try:
            out, err = proc.communicate(timeout=SERVICE_START_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        outs[line] = {"exit": proc.returncode, "stdout": out, "stderr_tail": err[-2000:],
                      "seconds_since_start": time.perf_counter() - console["started"]}
    emit("console", device_kind=kind, count_rows=count, runs=outs)
    for line, run in outs.items():
        require(run["exit"] == 0, f"console -c {line!r} exited {run['exit']}")
    require(outs["count bench"]["stdout"] == f"{count}\n",
            f"console count printed {outs['count bench']['stdout']!r}, not {count}")
    require(outs["lint"]["stdout"] == CONSOLE_LINT + "\n",
            f"console lint printed {outs['lint']['stdout']!r}")
    return outs


@timed_phase
def phase_lint(console: dict, kind: str) -> dict:
    """The lint children of :func:`start_console`: the port lints clean
    under SARIF with all its 40 rules, the seeded module gives exactly its
    three findings, the device pack's ``kernel-abi`` among them (so the clean
    answer is not a lint that linted nothing), and an unknown rule is an
    analyser error."""
    from lakesoul_tpu_torch.analysis.engine import _iter_py_files, package_root

    runs = console["lint"]
    for run in runs.values():
        run["reader"].join(SERVICE_START_S)
        if run["reader"].is_alive():
            run["proc"].kill()
            run["reader"].join()
    exits = {name: run["proc"].returncode for name, run in runs.items()}
    seconds = {name: run["seconds"] for name, run in runs.items()}
    try:
        sarif = json.loads(runs["port_sarif"]["out"])
        (sarif_run,) = sarif["runs"]
        rules = [r["id"] for r in sarif_run["tool"]["driver"]["rules"]]
        results = sarif_run["results"]
    except (ValueError, KeyError, TypeError):
        sarif, rules, results = {}, [], None
    try:
        seeded = {(f["rule"], f["line"]) for f in json.loads(runs["seeded"]["out"])}
    except (ValueError, KeyError, TypeError):
        seeded = None
    files = sum(1 for _ in _iter_py_files([package_root()]))
    emit("lint", device_kind=kind, files_linted=files, rules=len(rules),
         findings=None if results is None else len(results),
         seeded_findings=sorted(seeded) if seeded is not None else None,
         exits=exits, lint_seconds=seconds["port_sarif"], child_seconds=seconds,
         stderr_tail={name: run["err"][-2000:] for name, run in runs.items()})
    require(exits["port_sarif"] == 0, f"the port's lint exited {exits['port_sarif']}")
    require(sarif.get("version") == "2.1.0" and len(rules) == len(set(rules)) == LINT_RULES,
            f"the port's SARIF log is version {sarif.get('version')!r} with {len(rules)} rules")
    require(results == [], f"the port's lint reported {results!r}")
    require(exits["seeded"] == 1, f"the seeded module's lint exited {exits['seeded']}")
    require(seeded == LINT_SEEDED_LINES, f"the seeded module's findings are {seeded!r}")
    require(exits["unknown_rule"] == 2 and "engine error" in runs["unknown_rule"]["err"],
            f"--rule nosuch exited {exits['unknown_rule']}")
    return {"exits": exits, "seconds": seconds, "files": files, "rules": len(rules)}


class DetCounter:
    """The racecheck seed: a field two threads write with no lock."""

    def __init__(self):
        self.value = 0

    def bump(self, n: int) -> None:
        for _ in range(n):
            self.value += 1


def shm_fds() -> list:
    """This process's open ``/dev/shm`` descriptors' targets."""
    out = []
    for name in os.listdir("/proc/self/fd"):
        try:
            target = os.readlink(f"/proc/self/fd/{name}")
        except OSError:
            continue
        if target.startswith("/dev/shm/"):
            out.append(target)
    return sorted(out)


def start_detectors() -> dict:
    """``chip_smoke.py --detectors DIR`` with the six ``LAKESOUL_*CHECK``
    variables set, started beside the Flight SQL and proxy phases as the
    lint children are; :func:`phase_detectors` reads it.  A reader thread
    notes when it ended: its ``seconds`` are its own."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_detectors_")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--detectors", workdir],
                            env=child_env(**dict.fromkeys(DET_VARS, "1")),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    run = {"proc": proc, "started": time.perf_counter(), "workdir": workdir}

    def read():
        run["out"], run["err"] = proc.communicate()
        run["seconds"] = time.perf_counter() - run["started"]

    run["reader"] = threading.Thread(target=read, daemon=True)
    run["reader"].start()
    return run


def kill_detectors(run: dict) -> None:
    if run["proc"].poll() is None:
        run["proc"].kill()
    run["proc"].wait()
    run["reader"].join()
    shutil.rmtree(run["workdir"], ignore_errors=True)


@timed_phase
def phase_detectors(run: dict, kind: str) -> dict:
    """The detectors child (see the module docstring, 11c.5): it exits 0
    and its line shows 0 violations on the real work, each of the six
    seeded faults caught exactly once, every kernel wrapper within its
    signature budget and one build per kernel source."""
    run["reader"].join(DET_TIMEOUT_S)
    if run["reader"].is_alive():
        run["proc"].kill()
        run["reader"].join()
    rec = None
    for line in (run.get("out") or "").splitlines():
        if line.startswith('{"phase": "detectors"'):
            rec = json.loads(line)
    exit_code = run["proc"].returncode
    emit("detectors", device_kind=kind, exit=exit_code, child_seconds=run.get("seconds"),
         record=rec, stderr_tail=(run.get("err") or "")[-3000:])
    require(rec is not None, f"the detectors child printed no record (exit {exit_code})")
    require(exit_code == 0, f"the detectors child exited {exit_code}: {rec.get('failed')}")
    require(all(n == 0 for n in rec["real_violations"].values()),
            f"violations on the real work: {rec['real_violations']} {rec['real_rendered']}")
    require(set(rec["seeded"]) == set(DET_SEEDED_KINDS) and
            all(rec["seeded"][name] == [kind] for name, kind in DET_SEEDED_KINDS.items()),
            f"a seeded fault was not caught exactly once: {rec['seeded']}")
    require(rec["builds"] == {name: 1 for name in rec["sources"]},
            f"kernel builds in the child: {rec['builds']}")
    require(rec["rows"]["epoch"] == rec["rows"]["count_rows"] and
            rec["rows"]["scanplane"] == rec["rows"]["count_after_writer"] ==
            rec["rows"]["epoch_after_compaction"],
            f"rows read != count_rows(): {rec['rows']}")
    return rec


DET_SEEDED_KINDS = {"lockgraph": "lock-cycle", "racecheck": "shared-state-write",
                    "leakcheck": "thread-leak", "fscheck": "unfsynced-rename",
                    "txncheck": "lost-update", "tracecheck": "retrace-budget"}


def detectors_child(workdir: str) -> int:
    """``chip_smoke.py --detectors DIR``: the six runtime detectors armed
    around real work on the card, then one seeded fault each.  Prints one
    ``{"phase": "detectors", ...}`` line; exits 1 if a check failed."""
    import datetime
    from pathlib import Path

    import torch

    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lakesoul_tpu_torch.analysis import (fscheck, leakcheck, lockgraph, racecheck,
                                             tracecheck, txncheck)

    dets = {"lockgraph": lockgraph, "racecheck": racecheck, "leakcheck": leakcheck,
            "fscheck": fscheck, "txncheck": txncheck, "tracecheck": tracecheck}
    failed = []

    def check(cond: bool, what: str) -> None:
        if not cond:
            failed.append(what)

    check(all(m.env_requested() for m in dets.values()), "a LAKESOUL_*CHECK variable is not set")
    for m in dets.values():
        m.reset()
        m.enable()
    t_start = time.perf_counter()
    on_card = DEVICE == "cuda"
    import lakesoul_tpu_torch as L
    from lakesoul_tpu_torch import _build
    from lakesoul_tpu_torch import models as M
    from lakesoul_tpu_torch.vector import kernels as K

    rec = {"device": DEVICE, "sources": list(_build.SOURCES), "seconds_of": {}}
    timer = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal timer
        now = time.perf_counter()
        rec["seconds_of"][name] = now - timer
        timer = now

    scope = leakcheck.scope("detectors")
    scope.__enter__()
    # 1. the kernel libraries, built afresh in this process: three threads
    # load the three sources at once (each source must build exactly once)
    loaders = []
    if on_card:
        _build.BUILD_DIR = Path(workdir) / "build"
        loaders = [threading.Thread(target=_build.load, args=(name,), name=f"det-load-{name}")
                   for name in _build.SOURCES]
        for th in loaders:
            th.start()
    # 2. the loader's table at 2M rows, one epoch into the MLP step with the
    # pinned reuse ring armed (the canary checks each slot's copy event)
    cat = L.LakeSoulCatalog(os.path.join(workdir, "wh"))
    t = cat.create_table("det", loader_schema(), primary_keys=["id"],
                         hash_bucket_num=DET_BUCKETS, properties={"lakesoul.file_format": "lsf"})
    for chunk in loader_chunks(DET_ROWS, DET_CHUNK):
        t.write_arrow(chunk)
    upserted = loader_upsert_wave(t, SEED + 1, DET_ROWS)
    count = t.scan().count_rows()
    lap("table")
    model = M.MLP(LOADER_FEATURES, hidden=LOADER_HIDDEN, seed=SEED, device=DEVICE)
    step = M.make_mlp_train_step(model, M.adam(model.parameters(), LOADER_LR), device=DEVICE)

    def epoch() -> tuple:
        it = t.scan().batch_size(DET_BATCH).to_torch_iter(
            transform=loader_transform, io_threads=LOADER_IO_THREADS, drop_remainder=False,
            device=DEVICE)
        rows, loss = 0, None
        for b in it:
            loss = step(b["x"].t(), b["y"])
            rows += int(b["y"].shape[0])
        if on_card:
            torch.cuda.synchronize()
        return rows, it._ring is not None, bool(torch.isfinite(loss))

    os.environ["LAKESOUL_COLLATE_REUSE"] = "1"
    try:
        rows_epoch, ring_armed, finite = epoch()
    finally:
        del os.environ["LAKESOUL_COLLATE_REUSE"]
    check(finite, "a non-finite loss in the epoch")
    check(ring_armed or not on_card, "the reuse ring did not arm on the card")
    lap("epoch")
    # 3. a one-rank process group (NCCL on the card) inside the scope: the
    # /dev/shm descriptors it holds while alive, none once destroyed
    import torch.distributed as dist

    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    ones = torch.ones(4, device=DEVICE)
    dist.all_reduce(ones)
    shm_during_group = shm_fds()
    dist.destroy_process_group()
    lap("process_group")
    # 4. one leased compaction pass beside a writer
    from lakesoul_tpu_torch.compaction.service import LeasedCompactionService

    svc = LeasedCompactionService(cat, service_id="det-compactor", lease_ttl_s=30.0,
                                  version_gap=DET_VERSION_GAP)
    written = []

    def writer() -> None:
        import pyarrow as pa

        for c in range(DET_WRITER_COMMITS):
            base = DET_ROWS + c * DET_WRITER_ROWS
            part = next(loader_chunks(DET_WRITER_ROWS, DET_WRITER_ROWS, seed=SEED + 10 + c))
            ids = pa.array(np.arange(base, base + DET_WRITER_ROWS, dtype=np.int64))
            t.write_arrow(part.set_column(0, "id", ids))
            written.append(DET_WRITER_ROWS)

    w = threading.Thread(target=writer, name="det-writer")
    w.start()
    outcome = svc.poll_once()
    w.join()
    count_after = t.scan().count_rows()
    check(outcome.get("compacted", 0) >= 1, f"the compaction pass compacted nothing: {outcome}")
    check(count_after == count + sum(written), f"count_rows {count_after} after the writer")
    rows_after, _, _ = epoch()
    lap("compaction")
    # 5. one scan-plane session with one worker, its rows read on the card,
    # then the crash-prefix replay of its spool, manifest and obs docs
    from lakesoul_tpu_torch.obs import FleetPublisher
    from lakesoul_tpu_torch.scanplane.client import ScanPlaneClient
    from lakesoul_tpu_torch.scanplane.delivery import ScanPlaneDelivery
    from lakesoul_tpu_torch.scanplane.worker import ScanPlaneWorker
    from lakesoul_tpu_torch.service.flight import LakeSoulFlightServer

    spool = os.path.join(workdir, "spool")
    os.makedirs(spool)
    server = LakeSoulFlightServer(cat, "grpc://127.0.0.1:0",
                                  scanplane=ScanPlaneDelivery(cat, spool, wait_s=120.0),
                                  device=DEVICE)
    serving = threading.Thread(target=server.serve, name="det-gateway")
    serving.start()
    stop = threading.Event()
    worker = ScanPlaneWorker(cat, spool, lease_ttl_s=30, poll_interval_s=0.02, worker_id="det-w0")
    pump = threading.Thread(target=worker.run_forever, kwargs={"stop_event": stop},
                            name="det-worker")
    pump.start()
    try:
        scan = t.scan().select(DET_PLANE_COLUMNS).batch_size(DET_BATCH).via_scanplane(
            ScanPlaneClient(f"grpc://127.0.0.1:{server.port}"))
        rows_plane = sum(int(b["id"].shape[0]) for b in scan.to_torch_iter(
            device=DEVICE, drop_remainder=False))
    finally:
        stop.set()
        pump.join(60)
        server.shutdown()
        serving.join(60)
    obs_spool = os.path.join(workdir, "obs")
    os.makedirs(obs_spool)
    FleetPublisher(obs_spool, flush_s=60.0).flush(reason="detectors")
    lap("scanplane")
    # 6. after the host work above, which the kernel builds overlap: 8
    # threads searching one AnnEndpoint in bursts of mixed sizes, and each one
    # resident single search a burst
    for th in loaders:
        th.join()
    lap("kernel_build_wait")
    from lakesoul_tpu_torch.vector import AnnEndpoint, IvfRabitqIndex, SearchParams, VectorIndexConfig

    rng = np.random.default_rng(SEED + 2)
    xv = rng.normal(size=(DET_ANN_ROWS, DET_ANN_DIM)).astype(np.float32)
    index = IvfRabitqIndex.train(xv, np.arange(DET_ANN_ROWS),
                                 VectorIndexConfig("v", DET_ANN_DIM, nlist=DET_ANN_NLIST),
                                 device=DEVICE)
    index.enable_device_cache()
    params = SearchParams(top_k=10, nprobe=DET_ANN_NPROBE, rerank_depth=200)
    before = (K.packed_dot.launches, K.packed_dot_batch.launches)
    endpoint = AnnEndpoint(index, params, max_batch=64,
                           max_pending=DET_ANN_THREADS * max(DET_ANN_BURSTS))
    hits, errors = [], []

    def searcher(i: int) -> None:
        r = np.random.default_rng(SEED + 100 + i)
        try:
            for burst in DET_ANN_BURSTS:
                want = r.integers(0, DET_ANN_ROWS, burst)
                futures = [endpoint.submit(xv[j]) for j in want]
                hits.extend(int(f.result(60)[0][0]) == int(j) for f, j in zip(futures, want))
                ids, _ = index.search(xv[want[0]], params)
                hits.append(int(ids[0]) == int(want[0]))
        except Exception as e:  # recorded: a searcher's failure fails the phase
            errors.append(f"{type(e).__name__}: {e}")

    searchers = [threading.Thread(target=searcher, args=(i,), name=f"det-search-{i}")
                 for i in range(DET_ANN_THREADS)]
    for th in searchers:
        th.start()
    for th in searchers:
        th.join()
    endpoint.close()
    ann_launches = {"packed_dot": K.packed_dot.launches - before[0],
                    "packed_dot_batch": K.packed_dot_batch.launches - before[1]}
    check(not errors, f"searcher errors: {errors[:3]}")
    check(np.mean(hits) >= 0.95, f"the searched rows found themselves {np.mean(hits):.3f} of the time")
    check(not on_card or all(n > 0 for n in ann_launches.values()),
          f"a kernel was not launched by the searchers: {ann_launches}")
    ann_stats = endpoint.stats()
    lap("ann")
    scope.__exit__(None, None, None)
    traced = sorted({a.kind for op in fscheck.ops() for p in (op.path, op.dst)
                     if p and (a := fscheck.classify(p)) is not None})
    fs_ops = len(fscheck.ops())
    fscheck.replay(device=DEVICE)
    txns = len(txncheck.transactions())
    txncheck.replay()
    lap("replays")
    real = {name: m.violations() for name, m in dets.items()}
    rec["real_violations"] = {name: len(v) for name, v in real.items()}
    rec["real_rendered"] = {name: [x.render()[:2000] for x in v[:3]] for name, v in real.items() if v}
    signatures = tracecheck.signature_counts()
    rec.update(
        builds=tracecheck.build_counts(),
        loads=tracecheck.load_counts(), signatures=signatures,
        wrappers_within_budget=all(n <= tracecheck.DEFAULT_BUDGET for n in signatures.values()),
        shm_fds_during_process_group=shm_during_group, shm_fds_after=shm_fds(),
        fscheck={"ops": fs_ops, "artifact_kinds": traced}, txncheck={"transactions": txns},
        racecheck_hot_classes=[f"{m}.{c}" for m, c in racecheck.HOT_CLASSES],
        rows={"count_rows": count, "epoch": rows_epoch, "upserted": upserted,
              "count_after_writer": count_after, "epoch_after_compaction": rows_after,
              "scanplane": rows_plane},
        compaction=outcome, ann={"launches": ann_launches, "hit_rate": float(np.mean(hits)),
                                 "queries": len(hits), "endpoint": ann_stats},
    )
    check(rec["wrappers_within_budget"], f"a hot function over budget: {signatures}")
    check(not on_card or rec["builds"] == {name: 1 for name in _build.SOURCES},
          f"kernel builds in this process: {rec['builds']}")
    check(rows_epoch == count, f"the epoch read {rows_epoch} rows, count_rows {count}")
    check(rows_plane == count_after == rows_after,
          f"scan plane {rows_plane}, epoch {rows_after}, count_rows {count_after}")
    check({"range-segment", "range-sidecar", "session-manifest", "obs-doc"} <= set(traced),
          f"the crash replay did not trace the spool, manifest and obs docs: {traced}")
    # 7. one seeded fault per detector, each from a clean slate: each must be
    # recorded exactly once
    for m in dets.values():
        m.reset()
    seeded = {}

    def seed(name: str, fault) -> None:
        mark = len(dets[name].violations())
        fault()
        seeded[name] = [v.kind for v in dets[name].violations()[mark:]]

    def abba() -> None:
        from lakesoul_tpu_torch.runtime.pool import get_pool

        a, b = threading.Lock(), threading.Lock()

        def first():
            with a:
                with b:
                    pass

        def second():
            with b:
                with a:
                    pass

        for fn in (first, second):
            get_pool().submit(fn).result()

    def unguarded() -> None:
        racecheck.instrument_class(DetCounter)
        c = DetCounter()
        for i in range(2):
            th = threading.Thread(target=c.bump, args=(50,), name=f"det-race-{i}")
            th.start()
            th.join()

    def unjoined() -> None:
        hold = threading.Event()
        with leakcheck.scope("seeded"):
            threading.Thread(target=hold.wait, name="det-seeded-leak", daemon=True).start()
        hold.set()

    def unfsynced() -> None:
        d = os.path.join(workdir, "seeded-session")
        os.makedirs(d)
        with open(os.path.join(d, "manifest.json.tmp-seeded"), "w") as f:
            f.write("{}")
        os.replace(os.path.join(d, "manifest.json.tmp-seeded"), os.path.join(d, "manifest.json"))

    def lost_update() -> None:
        store = cat.client.store
        store.acquire_lease("detectors-seeded", "victim", ttl_ms=60_000)
        txncheck.reset()

        def victim():
            with store.transaction() as conn:
                store._exec(conn, "SELECT expires_at_ms FROM lease WHERE lease_key=?",
                            ("detectors-seeded",)).fetchone()
                store._exec(conn, "UPDATE lease SET expires_at_ms=? WHERE lease_key=?",
                            (999, "detectors-seeded"))

        th = threading.Thread(target=victim, name="det-victim")
        th.start()
        th.join()
        with store.transaction() as conn:
            store._exec(conn, "UPDATE lease SET expires_at_ms=?, holder_id=? WHERE lease_key=?",
                        (111, "thief", "detectors-seeded"))
        txncheck.replay()

    def thrash() -> None:
        q = torch.ones(32, device=DEVICE)
        for n in range(1, DET_THRASH + 1):
            K.bruteforce_distances(torch.ones((n * 7, 32), device=DEVICE), q)

    thrash_before = K.bruteforce_distances.launches
    for name, fault in (("lockgraph", abba), ("racecheck", unguarded), ("leakcheck", unjoined),
                        ("fscheck", unfsynced), ("txncheck", lost_update), ("tracecheck", thrash)):
        seed(name, fault)
    lap("seeded")
    rec["seeded"] = seeded
    rec["seeded_expected"] = DET_SEEDED_KINDS
    rec["thrash_launches"] = K.bruteforce_distances.launches - thrash_before
    for name, kinds in seeded.items():
        check(kinds == [DET_SEEDED_KINDS[name]], f"{name} recorded {kinds} for its seeded fault")
    for m in dets.values():
        m.disable()
    rec["seconds"] = time.perf_counter() - t_start
    rec["failed"] = failed
    print(json.dumps({"phase": "detectors", **rec}, default=str), flush=True)
    return 1 if failed else 0


def proc_children(pid: int) -> list:
    """The pids whose parent is ``pid`` (from ``/proc``)."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        if int(fields[1]) == pid:
            out.append(int(name))
    return out


def proc_alive(pid: int) -> bool:
    """True while ``pid`` runs (a zombie counts as ended)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def spool_base(need_bytes: int) -> tuple[str, str]:
    """``/dev/shm`` when ``df`` shows room for ``need_bytes`` with a quarter
    to spare, else the git-ignored ``.scratch/`` beside this script; and
    which it is."""
    try:
        free = shutil.disk_usage("/dev/shm").free
    except OSError:
        free = 0
    if free >= SPOOL_SPARE * need_bytes and os.access("/dev/shm", os.W_OK):
        return "/dev/shm", "tmpfs /dev/shm"
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".scratch")
    os.makedirs(base, exist_ok=True)
    return base, "disk .scratch/"


def child_env(**extra) -> dict:
    """This process's environment with the checkout on ``PYTHONPATH``, for
    the port's entry points run as children."""
    here = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ, PYTHONPATH=os.pathsep.join([here, os.environ.get("PYTHONPATH", "")]),
                **extra)


def stop_child(proc, timeout_s: float = SCANPLANE_STOP_S) -> None:
    """SIGINT (the port's entry points stop what they own on it), SIGKILL
    past ``timeout_s``."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout_s)


def start_scanplane_service(wh: str, spool: str, log, workers: int = SCANPLANE_WORKERS) -> tuple:
    """``python -m lakesoul_tpu_torch.scanplane service`` with ``workers``
    workers on ``spool`` (its log to ``log``); returns the process, its first
    line (``{"location", "spool"}``) and the seconds it took to print it."""
    t0 = time.perf_counter()
    svc = subprocess.Popen(
        [sys.executable, "-m", "lakesoul_tpu_torch.scanplane", "service", "--warehouse", wh,
         "--workers", str(workers), "--spool", spool],
        env=child_env(), stdout=subprocess.PIPE, stderr=log, text=True)
    first = []
    reader = threading.Thread(target=lambda: first.append(svc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(SCANPLANE_START_S)
    start_s = time.perf_counter() - t0
    if not first or not first[0].strip():
        stop_scanplane_service(svc)
        require(False, f"the scan-plane service printed no first line in {start_s:.1f} s")
    return svc, json.loads(first[0]), start_s


def stop_scanplane_service(svc) -> list:
    """SIGINT (the service stops its workers and waits for them: SIGTERM
    would end it at once and orphan them), then SIGKILL past
    SCANPLANE_STOP_S; the pids of its workers still alive afterwards, each
    then killed."""
    children = proc_children(svc.pid)
    stop_child(svc)
    alive = [pid for pid in children if proc_alive(pid)]
    for pid in alive:
        os.kill(pid, signal.SIGKILL)
    return alive


def worker_stage_labels() -> list:
    """The ``worker=`` labels of this process's ``lakesoul_scan_stage_seconds``
    series: the scan-plane workers whose stages were merged here."""
    from lakesoul_tpu_torch.obs import registry
    from lakesoul_tpu_torch.obs.stages import STAGE_FAMILY

    return sorted({m.group(1) for key in registry().snapshot() if key.startswith(STAGE_FAMILY)
                   for m in [re.search(r'worker="([^"]+)"', key)] if m})


def card_step_batch(torch, b) -> tuple:
    """The loader's step inputs built on the card from a raw batch: the
    feature columns stacked to ``[B, F]`` and the labels."""
    return torch.stack([b[f"f{i}"] for i in range(LOADER_FEATURES)], dim=1), b["label"]


def wait_until(pred, timeout_s: float, poll_s: float = 0.05) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll_s)
    return bool(pred())


@timed_phase
def phase_autoscale(torch, M, t, count: int, local: tuple, fixed_cold_rows_per_s: float,
                  kind: str) -> dict:
    """The scan plane's fleet sized by the autoscaler, on a fresh spool:
    ``python -m lakesoul_tpu_torch.scanplane service --workers 0`` serves
    only, and ``python -m lakesoul_tpu_torch.fleet autoscale --min-workers
    2 --max-workers 4`` owns the workers.  A cold ``via_scanplane`` epoch of
    raw batches feeds the loader's MLP step on the card (the features
    stacked there); once rows flow one worker, its pid from a ``spawn``
    line, is SIGKILLed (``tests/test_fleet_chaos.py:108-200``).  Requires a
    ``worker_exit`` line for it and a ``spawn`` after, the epoch's card
    batches (copied back) = the local scan's by sha256, and no worker alive
    after the autoscaler's SIGINT (its children listed first)."""
    wh = t.catalog.warehouse
    base, medium = spool_base(count * SPOOL_ROW_BYTES)
    spool = tempfile.mkdtemp(prefix="chip_smoke_autoscale_", dir=base)
    log_path = spool + ".log"
    events: list = []
    spawned = lambda: [e["pid"] for e in list(events) if e.get("event") == "spawn"]  # noqa: E731
    children, victim, alive = [], None, []
    with open(log_path, "w") as log:
        svc, handle, start_s = start_scanplane_service(wh, spool, log, workers=0)
        scaler = None
        try:
            t0 = time.perf_counter()
            scaler = subprocess.Popen(
                [sys.executable, "-m", "lakesoul_tpu_torch.fleet", "autoscale",
                 "--warehouse", wh, "--spool", spool, "--min-workers", str(AUTOSCALE_MIN),
                 "--max-workers", str(AUTOSCALE_MAX), "--poll-s", "0.2",
                 "--worker-lease-ttl-s", str(FRESH_TTL_S), "--worker-poll-s", "0.05"],
                env=child_env(), stdout=subprocess.PIPE, stderr=log, text=True)

            def pump():  # the autoscaler's JSON event lines, stamped on arrival
                for line in scaler.stdout:
                    try:
                        events.append({**json.loads(line), "at": time.perf_counter()})
                    except ValueError:
                        continue

            threading.Thread(target=pump, daemon=True).start()
            require(wait_until(lambda: len(spawned()) >= AUTOSCALE_MIN, AUTOSCALE_WAIT_S),
                    f"the autoscaler spawned {spawned()} in {AUTOSCALE_WAIT_S} s: {events[-5:]}")
            min_s = time.perf_counter() - t0
            model = M.MLP(LOADER_FEATURES, hidden=LOADER_HIDDEN, seed=SEED, device=DEVICE)
            step = M.make_mlp_train_step(model, M.adam(model.parameters(), LOADER_LR),
                                         device=DEVICE)
            to_host = lambda v: v.cpu().numpy()  # noqa: E731
            h, rows, loss = hashlib.sha256(), 0, None
            t0 = time.perf_counter()
            for b in t.scan().batch_size(LOADER_BATCH).via_scanplane(
                    handle["location"]).to_torch_iter(drop_remainder=False, device=DEVICE):
                hash_batch(h, b, to_host)
                rows += int(b["id"].shape[0])
                loss = step(*card_step_batch(torch, b))
                if victim is None:  # rows flow: kill one autoscaled worker
                    victim = spawned()[0]
                    os.kill(victim, signal.SIGKILL)
                    killed_at = time.perf_counter()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

            def backfill():
                snap = list(events)
                exits = [i for i, e in enumerate(snap)
                         if e.get("event") == "worker_exit" and e.get("pid") == victim]
                return next((e for e in snap[exits[0] + 1:] if e.get("event") == "spawn"),
                            None) if exits else None

            require(wait_until(lambda: backfill() is not None, AUTOSCALE_WAIT_S),
                    f"no worker_exit for {victim} and spawn after it: {events[-8:]}")
            backfill_s = backfill()["at"] - killed_at
            children = proc_children(scaler.pid)
        finally:
            t0 = time.perf_counter()
            if scaler is not None:
                children = sorted(set(children) | set(proc_children(scaler.pid)))
                stop_child(scaler)
                alive = [pid for pid in sorted(set(children) | set(spawned())) if proc_alive(pid)]
                for pid in alive:
                    os.kill(pid, signal.SIGKILL)
            alive += stop_scanplane_service(svc)
            stop_s = time.perf_counter() - t0
            shutil.rmtree(spool, ignore_errors=True)
            with open(log_path) as f:
                log_tail = f.read()[-3000:]
            os.unlink(log_path)
    sha = (h.hexdigest(), rows)
    rec = {"config": f"python -m lakesoul_tpu_torch.fleet autoscale --min-workers "
                     f"{AUTOSCALE_MIN} --max-workers {AUTOSCALE_MAX} behind a --workers 0 "
                     "service on the loader's table; raw batches into MLP(16, hidden=256)",
           "device_kind": kind, "spool_medium": medium, "service_start_s": start_s,
           "min_fleet_s": min_s, "cold_rows_per_s": rows / wall, "cold_wall_s": wall,
           "fixed_two_worker_cold_rows_per_s": fixed_cold_rows_per_s,
           "loss_last": float(loss), "spawns": len(spawned()), "victim": victim,
           "backfill_s": backfill_s, "stop_s": stop_s,
           "events": collections.Counter(e.get("event") for e in events),
           "batches_sha": sha[0], "local_sha": local[0], "rows": rows,
           "workers_alive_after_stop": alive}
    emit("autoscale", **rec)
    require(not alive, f"processes {alive} outlived the autoscaled fleet; its log: {log_tail}")
    require(sha == local, f"the autoscaled fleet's card batches {sha} != the local scan's {local}")
    require(bool(torch.isfinite(loss)), "a non-finite loss in the autoscaled epoch")
    return rec


@timed_phase
def phase_scanplane(torch, M, L, t, count: int, local_rows_per_s: float, fleet_oracle: list,
                    kind: str) -> dict:
    """The scan plane on the loader's table: ``python -m
    lakesoul_tpu_torch.scanplane service --workers 2`` as a child process,
    its spool on ``/dev/shm`` when there is room.  ``t.scan().via_scanplane(
    location).to_torch_iter(batch_size=524,288, ...)`` feeds the loader's
    MLP step on the card for a cold epoch (the workers decode while the
    trainer reads) and a warm one (the spooled session), each delivering
    ``count_rows()`` rows; a third remote epoch's card batches, copied back,
    must equal the local ``to_torch_iter``'s by sha256, and so must a fourth
    with ``LAKESOUL_FLEET_TRANSPORT=stream``; the shm rung must have been
    negotiated and both workers' stage series merged here.  Then the
    ``fleet_train --location`` leg: two ranks of ``fleet train`` read
    through the gateway, each = the shard oracle.  The service is stopped
    by SIGINT; a worker still alive afterwards fails the run."""
    from lakesoul_tpu_torch.obs import registry
    from lakesoul_tpu_torch.obs.stages import stage_seconds

    def shm_negotiated():
        return registry().counter("lakesoul_fleet_transport_negotiated_total",
                                  transport="shm").value

    wh = t.catalog.warehouse
    base, medium = spool_base(count * SPOOL_ROW_BYTES)
    spool = tempfile.mkdtemp(prefix="chip_smoke_spool_", dir=base)
    log_path = spool + ".log"
    shm_before = shm_negotiated()
    feed_kw = {"transform": loader_transform, "io_threads": LOADER_IO_THREADS}
    with open(log_path, "w") as log:
        svc, handle, start_s = start_scanplane_service(wh, spool, log)
        try:
            loc = handle["location"]
            model = M.MLP(LOADER_FEATURES, hidden=LOADER_HIDDEN, seed=SEED, device=DEVICE)
            step = M.make_mlp_train_step(model, M.adam(model.parameters(), LOADER_LR),
                                         device=DEVICE)

            def remote(**kw):
                return t.scan().batch_size(LOADER_BATCH).via_scanplane(loc).to_torch_iter(
                    drop_remainder=False, device=DEVICE, **kw)

            epochs = []
            for name in ("cold", "warm"):
                before = stage_seconds()
                rows, loss = 0, None
                t0 = time.perf_counter()
                for b in remote(**feed_kw):
                    loss = step(b["x"].t(), b["y"])
                    rows += int(b["y"].shape[0])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                after = stage_seconds()
                require(rows == count, f"the scan plane's {name} epoch delivered {rows} rows, "
                                       f"not {count}")
                require(bool(torch.isfinite(loss)), f"a non-finite loss in the {name} epoch")
                stages = {k: after[k] - before[k] for k in after}
                epochs.append({"epoch": name, "rows": rows, "wall_s": wall,
                               "rows_per_s": rows / wall, "loss_last": float(loss),
                               "queue_share": stages["queue"] / wall, "stage_seconds": stages})
            it = iter(remote(**feed_kw))

            def feed():
                for _ in range(LOADER_PROFILE_BATCHES):
                    b = next(it)
                    step(b["x"].t(), b["y"])

            busy = profile(torch, feed)
            it.close()
            del it
            to_host = lambda v: v.cpu().numpy()  # noqa: E731
            card = batches_sha(remote(), to_host)
            local = batches_sha(t.scan().batch_size(LOADER_BATCH).to_torch_iter(
                drop_remainder=False, device=DEVICE), to_host)
            os.environ["LAKESOUL_FLEET_TRANSPORT"] = "stream"
            try:
                stream = batches_sha(remote(), to_host)
            finally:
                del os.environ["LAKESOUL_FLEET_TRANSPORT"]
            shm_ranges = shm_negotiated() - shm_before
            workers = worker_stage_labels()
            spool_bytes = dir_bytes(spool)
            lines, fleet_wall = run_fleet_ranks(wh, extra=("--location", loc))
        finally:
            alive = stop_scanplane_service(svc)
            shutil.rmtree(spool, ignore_errors=True)
            with open(log_path) as f:
                log_tail = f.read()[-3000:]
            os.unlink(log_path)
    fleet = {"config": f"{FLEET_RANKS} fleet train processes on one card through the "
                       f"scan-plane gateway, batch {LOADER_BATCH}, --device-put --location",
             "device_kind": kind, "ranks": [{**ln, "rows_per_s": ln["rows"] / ln["elapsed_s"]}
                                            for ln in lines],
             "oracle": fleet_oracle, "wall_s": fleet_wall, "count_rows": count}
    emit("fleet_train_location", **fleet)
    check_fleet_lines(lines, fleet_oracle, count, "fleet train --location")
    cold, warm = epochs
    rec = {"config": f"python -m lakesoul_tpu_torch.scanplane service, {SCANPLANE_WORKERS} "
                     "workers, on the loader's 20M-row table, via_scanplane().to_torch_iter("
                     f"batch {LOADER_BATCH}) into MLP(16, hidden=256)", "device_kind": kind,
           "spool_medium": medium, "service_start_s": start_s,
           "cold_rows_per_s": cold["rows_per_s"], "warm_rows_per_s": warm["rows_per_s"],
           "local_loader_rows_per_s": local_rows_per_s,
           "warm_over_local": warm["rows_per_s"] / local_rows_per_s,
           "device_busy_share": busy["device_busy_share"], "busy_batches": LOADER_PROFILE_BATCHES,
           "queue_share_cold": cold["queue_share"], "queue_share_warm": warm["queue_share"],
           "epochs": epochs, "spool_bytes": spool_bytes,
           "spool_bytes_per_row": spool_bytes / count, "batches_sha": card[0],
           "local_sha": local[0], "stream_sha": stream[0], "rows_hashed": card[1],
           "shm_negotiated": shm_ranges, "worker_stage_labels": workers,
           "workers_alive_after_stop": alive}
    emit("scanplane", **rec)
    require(not alive, f"scan-plane workers {alive} outlived the service's stop; its log: "
                       f"{log_tail}")
    require(card == local and card[1] == count,
            f"the scan plane's card batches {card} != the local iterator's {local}")
    require(stream == local, f"the forced stream transport's batches {stream} != {local}")
    require(shm_ranges > 0, "the shm transport was never negotiated")
    require(len(workers) >= SCANPLANE_WORKERS,
            f"stage series merged from workers {workers}, not from {SCANPLANE_WORKERS}")
    rec["autoscale"] = phase_autoscale(torch, M, t, count, local, cold["rows_per_s"], kind)
    return rec


def compacted_buckets(t, files_before: set, rows: int) -> list:
    """Requires ``t`` (one partition, hash buckets) to have been compacted
    whole: its head is one CompactionCommit, every file of every bucket was
    added by that commit, no file from before it is live, the buckets hold
    ``rows`` rows, and each bucket holds at most ceil(r / per_flush) + 1
    files for its r rows.  That bound is the writer's: the compaction
    writes the buckets one after another into one writer, which flushes
    every bucket it buffers once ``max_file_rows`` rows (or its byte
    budget) are buffered, so a bucket spans at most that many flushes.
    Returns each bucket's files, rows (from the footers) and bound."""
    from lakesoul_tpu_torch.io.formats import format_for
    from lakesoul_tpu_torch.meta.entity import CommitOp

    store = t.catalog.client.store
    heads = store.get_all_latest_partition_info(t.info.table_id)
    require(len(heads) == 1 and heads[0].commit_op == CommitOp.COMPACTION
            and len(heads[0].snapshot) == 1,
            f"the partition head is not one CompactionCommit: "
            f"{[(h.commit_op, len(h.snapshot)) for h in heads]}")
    (commit,) = store.get_data_commit_info(t.info.table_id, heads[0].partition_desc,
                                           heads[0].snapshot)
    added = {op.path for op in commit.file_ops if op.file_op.value == "add"}
    cfg = t.io_config()
    row_bytes = -(-sum(f.type.bit_width + 1 for f in t.schema) // 8)  # values + validity
    per_flush = min(cfg.max_file_rows, cfg.memory_budget_bytes // row_bytes)
    buckets = []
    for u in t.scan().scan_plan():
        r = sum(format_for(p).count_rows(p) for p in u.data_files)
        buckets.append({"bucket": u.bucket_id, "files": len(u.data_files), "rows": r,
                        "most_files": -(-r // per_flush) + 1, "paths": set(u.data_files)})
    live = set().union(*(b.pop("paths") for b in buckets))
    require(live == added and not live & files_before,
            f"after compaction {len(live - added)} live files were not added by the "
            f"CompactionCommit and {len(live & files_before)} are from before it")
    require(sum(b["rows"] for b in buckets) == rows,
            f"the compacted buckets hold {sum(b['rows'] for b in buckets)} rows, not {rows}")
    require(all(b["files"] <= b["most_files"] for b in buckets),
            f"a compacted bucket holds more files than its rows roll into "
            f"(per flush {per_flush}): {buckets}")
    return buckets


@timed_phase
def phase_compaction(torch, M, L, t, count: int, local: tuple, make_step, port_iter,
                     streamed_rows_per_s: float, kind: str) -> dict:
    """The loader's table compacted by the deployable leased compactor:
    ``python -m lakesoul_tpu_torch.compaction --once --min-file-num 2`` as a
    child with a deadline (8 buckets, each merging on read: the 5 % upsert
    wave).  Requires every bucket to have been rewritten by the
    compaction's one commit into no more files than its rows roll into
    (:func:`compacted_buckets`) and to read without a merge after it,
    ``CALL clean`` through the port's ``SqlSession`` to return
    the reference cleaner's columns, and
    then a raw epoch into the loader's MLP step on the card (the features
    stacked there), copied back, = the same run's pre-compaction epoch
    (``scanplane``'s local one) by sha256.  Reports the compaction's
    seconds and the loader's rows/s after it (best of the loader's timed
    epochs, same iterator and step) beside before it: what merge on read
    costs the loader."""
    from lakesoul_tpu_torch.sql import SqlSession

    cat = t.catalog
    files_before = {p for u in t.scan().scan_plan() for p in u.data_files}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "lakesoul_tpu_torch.compaction", "--warehouse", cat.warehouse,
         "--db-path", cat.client.store.db_path, "--once", "--min-file-num", "2",
         "--service-id", "chip-smoke"],
        env=child_env(), capture_output=True, text=True, timeout=COMPACT_TIMEOUT_S)
    compact_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"the compactor exited {proc.returncode}: {proc.stderr[-3000:]}")
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    buckets = compacted_buckets(t, files_before, count)
    plan = t.scan().scan_plan()
    t0 = time.perf_counter()
    cleaned = SqlSession(cat, device=DEVICE).execute("CALL clean()")
    clean_s = time.perf_counter() - t0
    to_host = lambda v: v.cpu().numpy()  # noqa: E731
    step = make_step()
    h, rows, loss = hashlib.sha256(), 0, None
    for b in t.scan().batch_size(LOADER_BATCH).to_torch_iter(drop_remainder=False,
                                                             device=DEVICE):
        hash_batch(h, b, to_host)
        rows += int(b["id"].shape[0])
        loss = step(*card_step_batch(torch, b))
    torch.cuda.synchronize()
    sha = (h.hexdigest(), rows)
    epochs = []
    step = make_step()
    for _ in range(LOADER_TIMED_EPOCHS):
        n = 0
        t0 = time.perf_counter()
        for b in port_iter():
            step(b["x"].t(), b["y"])
            n += int(b["y"].shape[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require(n == count, f"after compaction the loader delivered {n} rows, not {count}")
        epochs.append({"rows": n, "wall_s": wall, "rows_per_s": n / wall})
    after = max(e["rows_per_s"] for e in epochs)
    rec = {"config": "python -m lakesoul_tpu_torch.compaction --once --min-file-num 2 on the "
                     "loader's 20M-row table (8 buckets, one 5 % upsert wave), then CALL clean",
           "device_kind": kind, "compact_s": compact_s, "outcome": counts,
           "files_before": len(files_before), "buckets_after": buckets,
           "buckets_merging_after": sum(bool(u.primary_keys) for u in plan),
           "units_after": len(plan), "clean_s": clean_s, "clean": cleaned.to_pylist(),
           "clean_columns": cleaned.column_names, "batches_sha": sha[0],
           "pre_compaction_sha": local[0], "rows": rows, "loss_last": float(loss),
           "loader_rows_per_s_before": streamed_rows_per_s, "loader_rows_per_s_after": after,
           "after_over_before": after / streamed_rows_per_s, "epochs_after": epochs}
    emit("compaction", **rec)
    require(counts.get("compacted", 0) >= 1, f"the compactor compacted nothing: {counts}")
    require(len(plan) == LOADER_BUCKETS and not any(u.primary_keys for u in plan),
            f"after compaction {len(plan)} buckets, merging "
            f"{[u.bucket_id for u in plan if u.primary_keys]}")
    require(cleaned.column_names == ["versions_dropped", "files_deleted", "discarded_deleted",
                                     "partitions_expired"] and cleaned.num_rows == 1,
            f"CALL clean returned {cleaned.column_names}")
    require(sha == local, f"after compaction and clean the card's batches {sha} != the "
                          f"pre-compaction epoch's {local}")
    require(bool(torch.isfinite(loss)), "a non-finite loss after compaction")
    return rec


@timed_phase
def phase_loader(torch, M, L, kind: str) -> dict:
    """``bench.py``'s train leg on the card and its DataLoader comparator
    (see the module docstring, phase 11), then ``fleet_train`` and ``sql``
    on the same table.  The table and the parquet copy live in a temp dir,
    removed after the phase."""
    from lakesoul_tpu_torch import native
    from lakesoul_tpu_torch.obs.stages import stage_seconds

    require(native.available(), "the port's native merge library did not load")
    root = tempfile.mkdtemp(prefix="chip_smoke_loader_")
    try:
        # the table: bench.py's build_table (bench.py:225-242)
        t0 = time.perf_counter()
        t = L.LakeSoulCatalog(os.path.join(root, "wh")).create_table(
            "bench", loader_schema(), primary_keys=["id"], hash_bucket_num=LOADER_BUCKETS,
            properties={"lakesoul.file_format": "lsf"})
        for chunk in loader_chunks(LOADER_ROWS):
            t.write_arrow(chunk)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        upserted = loader_upsert_wave(t, SEED + 1, LOADER_ROWS)
        upsert_s = time.perf_counter() - t0
        table_bytes = dir_bytes(os.path.join(root, "wh"))
        # the comparator's parquet copy of the same rows (bench.py:343-361)
        import pyarrow.parquet as pq

        t0 = time.perf_counter()
        pq_dir = os.path.join(root, "parquet")
        os.makedirs(pq_dir)
        files = []
        for i, chunk in enumerate(loader_chunks(LOADER_ROWS)):
            files.append(os.path.join(pq_dir, f"part-{i:05d}.parquet"))
            pq.write_table(chunk, files[-1], compression="zstd", compression_level=1,
                           use_dictionary=False)
        parquet_s = time.perf_counter() - t0
        parquet_bytes = dir_bytes(pq_dir)
        count = t.scan().count_rows()
        require(count == LOADER_ROWS, f"count_rows {count} != the {LOADER_ROWS} rows written")

        def make_step():
            # one fresh model and optimizer a leg: every leg starts from the
            # same weights (seed SEED)
            model = M.MLP(LOADER_FEATURES, hidden=LOADER_HIDDEN, seed=SEED, device=DEVICE)
            return M.make_mlp_train_step(model, M.adam(model.parameters(), LOADER_LR),
                                         device=DEVICE)

        def port_iter():
            return t.scan().batch_size(LOADER_BATCH).to_torch_iter(
                transform=loader_transform, io_threads=LOADER_IO_THREADS,
                drop_remainder=False, device=DEVICE)

        # the port's feed: one untimed epoch, then the best of the timed ones
        step = make_step()
        epochs = []
        torch.cuda.reset_peak_memory_stats()
        if hasattr(torch.cuda, "reset_peak_host_memory_stats"):
            torch.cuda.reset_peak_host_memory_stats()
        for e in range(1 + LOADER_TIMED_EPOCHS):
            before = stage_seconds()
            rows, loss = 0, None
            t0 = time.perf_counter()
            for b in port_iter():
                loss = step(b["x"].t(), b["y"])  # [F, B] → [B, F] on the card
                rows += int(b["y"].shape[0])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = stage_seconds()
            require(rows == count, f"the loader delivered {rows} rows in epoch {e}, not {count}")
            require(bool(torch.isfinite(loss)), "a non-finite loss in the loader's step")
            epochs.append({"timed": e > 0, "rows": rows, "wall_s": wall,
                           "rows_per_s": rows / wall, "loss_last": float(loss),
                           "stage_seconds": {k: after[k] - before[k] for k in after}})
        best = max((ep for ep in epochs if ep["timed"]), key=lambda ep: ep["rows_per_s"])
        peak_device = torch.cuda.max_memory_allocated()
        pinned = pinned_stats(torch)

        # the step alone, on one delivered batch
        it = iter(port_iter())
        b = next(it)
        x, y = b["x"].t(), b["y"]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(LOADER_STEP_ITERS + 1)]
        ev[0].record()
        for i in range(LOADER_STEP_ITERS):
            step(x, y)
            ev[i + 1].record()
        torch.cuda.synchronize()
        step_ms = float(np.median([a.elapsed_time(c) for a, c in zip(ev[:-1], ev[1:])]))
        step_device_ms = device_ms_per_launch(torch, lambda: step(x, y), LOADER_STEP_ITERS, "")

        # the device's busy share over LOADER_PROFILE_BATCHES batches of the
        # live feed (profile() runs the batches once to warm, once traced)
        def feed():
            for _ in range(LOADER_PROFILE_BATCHES):
                b = next(it)
                step(b["x"].t(), b["y"])

        busy = profile(torch, feed)
        it.close()
        del it, b, x, y

        # the card's batches = the CPU's, byte for byte: one hash bucket,
        # no transform, and again with the pinned reuse ring armed
        shard = t.scan().shard(0, LOADER_BUCKETS).batch_size(LOADER_BATCH)
        want = batches_sha(shard.to_torch_iter(device="cpu", drop_remainder=False),
                           lambda v: v.numpy())
        got = batches_sha(shard.to_torch_iter(device=DEVICE, drop_remainder=False),
                          lambda v: v.cpu().numpy())
        os.environ["LAKESOUL_COLLATE_REUSE"] = "1"
        try:
            ring_it = shard.to_torch_iter(device=DEVICE, drop_remainder=False)
            require(ring_it._ring is not None, "the reuse ring did not arm on the card")
            got_ring = batches_sha(ring_it, lambda v: v.cpu().numpy())
        finally:
            del os.environ["LAKESOUL_COLLATE_REUSE"]
        require(want[1] > 0 and got == want,
                f"the card's batches of shard(0, {LOADER_BUCKETS}) != the CPU's: {got} {want}")
        require(got_ring == want, f"with the reuse ring the card's batches != the CPU's: "
                                  f"{got_ring} {want}")

        # bench.py's train_hbm leg: the device replay cache on the same table
        replay = loader_replay(torch, t, make_step, count, best["rows_per_s"])

        # the comparator: pyarrow.dataset -> DataLoader -> the same step
        from torch.utils.data import DataLoader

        baseline = {}
        for workers in LOADER_WORKERS:
            kw = ({"num_workers": workers, "persistent_workers": True,
                   "multiprocessing_context": "spawn"} if workers else {})
            loader = DataLoader(ParquetFiles(files), batch_size=1, collate_fn=stack_collate,
                                pin_memory=True, **kw)
            step = make_step()
            runs = []
            for _ in range(LOADER_TIMED_EPOCHS):  # best of: the first pays worker start-up
                rows, loss = 0, None
                t0 = time.perf_counter()
                for xb, yb in loader:
                    loss = step(xb.to(DEVICE, non_blocking=True), yb.to(DEVICE, non_blocking=True))
                    rows += int(yb.shape[0])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                require(rows == LOADER_ROWS, f"the DataLoader delivered {rows} rows")
                runs.append({"rows": rows, "wall_s": wall, "rows_per_s": rows / wall,
                             "loss_last": float(loss)})
            del loader  # stops the persistent workers
            baseline[f"workers_{workers}"] = runs
        base_best = max(r["rows_per_s"] for runs in baseline.values() for r in runs)
        fleet = phase_fleet_train(torch, L, os.path.join(root, "wh"), count, kind)
        phase_sql(torch, M, L, t, kind)
        console = start_console(t)
        detectors = start_detectors()
        try:
            phase_flight_sql(torch, L, t, count, kind)
            phase_storage_proxy(L, t, kind)
        except BaseException:
            kill_console(console)
            kill_detectors(detectors)
            raise
        try:
            phase_console(console, count, kind)
            phase_lint(console, kind)
            phase_detectors(detectors, kind)
        finally:
            kill_console(console)
            kill_detectors(detectors)
        plane = phase_scanplane(torch, M, L, t, count, best["rows_per_s"], fleet["oracle"],
                                kind)
        # the scan plane is the last phase to read the table as written
        phase_compaction(torch, M, L, t, count, (plane["local_sha"], plane["rows_hashed"]),
                         make_step, port_iter, best["rows_per_s"], kind)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    rec = {"config": "bench.py train leg: 20M-row hash-bucketed LSF table, one 5 % upsert "
                     "wave, into MLP(16, hidden=256) Adam 1e-3",
           "device_kind": kind, "host": host_info(), "rows": LOADER_ROWS,
           "batch": LOADER_BATCH, "hash_bucket_num": LOADER_BUCKETS,
           "upserted_rows": upserted, "io_threads": LOADER_IO_THREADS,
           "native_merge": native.available(), "count_rows": count,
           "write_s": write_s, "upsert_s": upsert_s, "parquet_write_s": parquet_s,
           "table_bytes": table_bytes, "parquet_bytes": parquet_bytes,
           "rows_per_s": best["rows_per_s"], "epochs": epochs,
           "stage_seconds_best_epoch": best["stage_seconds"],
           "dataloader_rows_per_s": base_best, "dataloader": baseline,
           "ratio_vs_dataloader": best["rows_per_s"] / base_best,
           "step_ms": step_ms, "step_device_ms": step_device_ms,
           "busy_batches": LOADER_PROFILE_BATCHES,
           "device_busy_share": busy["device_busy_share"], "busy_profile": busy,
           "peak_device_bytes": peak_device,
           "peak_pinned_bytes": pinned.get("allocated_bytes.peak"), "pinned": pinned,
           "card_equals_cpu": {"shard": f"0/{LOADER_BUCKETS}", "rows": want[1],
                               "sha256": want[0], "reuse_ring_too": True},
           "replay": replay, "hbm_resident_replay_rows_per_s":
               replay["hbm_resident_replay_rows_per_s"],
           "replay_over_stream": replay["replay_over_stream"]}
    emit("loader", **rec)
    return rec


@timed_phase
def phase_freshness(torch, L, kind: str) -> dict:
    """The always-fresh loop (``benchmarks/micro.py:1010-1190``) with the
    port's roles and the consumer on the card, on its own warehouse under
    the git-ignored ``.scratch/``: ``python -m lakesoul_tpu_torch.freshness
    writer`` streams FRESH_COMMITS checkpointed CDC upserts of FRESH_ROWS
    rows (commits 9-24 re-write the first eight's keys); a victim ``python
    -m lakesoul_tpu_torch.compaction`` hangs inside its leased job
    (``LAKESOUL_FAULTS=compaction.leased_job:1:hang:300``) and is SIGKILLed
    once the store shows its lease, a peer taking over; this process follows
    the table with ``to_torch_iter(follow=...)`` on the card under flaky
    poll and object-store faults (p 0.3), takes ``follow_state_json()``
    halfway, stops, and resumes a second iterator from it.  A stream ends
    through its ``stop_event`` once the follower has handed over every row
    (``lakesoul_follow_rows_total``) and the iterator drains what is in
    flight.  Requires both iterators' rows (copied back) to total the
    writer's, with its oracle sha256; a ``fence=<n>`` CompactionCommit with
    n >= 2 (the takeover); the freshness SLO (p99 <=
    ``LAKESOUL_FRESHNESS_SLO_S``, 10 s by default) in budget and the
    throughput floor held; and no child alive after the phase."""
    import pyarrow as pa

    from lakesoul_tpu_torch.freshness import SloMonitor, ThroughputSlo
    from lakesoul_tpu_torch.freshness.__main__ import oracle_sha
    from lakesoul_tpu_torch.meta.entity import CommitOp, now_millis
    from lakesoul_tpu_torch.obs import registry
    from lakesoul_tpu_torch.runtime import faults
    from lakesoul_tpu_torch.runtime.resilience import RetryPolicy

    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".scratch")
    os.makedirs(base, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_fresh_", dir=base)
    wh, db = os.path.join(root, "wh"), os.path.join(root, "meta.db")
    env = child_env(LAKESOUL_RETRY_SEED="7")
    env.pop("LAKESOUL_FAULTS", None)
    expected = FRESH_COMMITS * FRESH_ROWS
    slo_target = float(os.environ.get("LAKESOUL_FRESHNESS_SLO_S", 10.0))
    catalog = L.LakeSoulCatalog(wh, db_path=db)
    schema = pa.schema([("id", pa.int64()), ("seq", pa.int64()), ("v", pa.float64())])
    t = catalog.create_table("fresh", schema, primary_keys=["id"],
                             hash_bucket_num=FRESH_BUCKETS, cdc=True)
    store = catalog.client.store
    lease_key = f"compaction/{t.info.table_id}/-5"
    start_ts = now_millis() - 1
    logs = open(os.path.join(root, "children.log"), "w")
    procs: dict = {}

    def compactor(service_id: str, fault: bool):
        e = dict(env, LAKESOUL_FAULTS="compaction.leased_job:1:hang:300") if fault else env
        return subprocess.Popen(
            [sys.executable, "-m", "lakesoul_tpu_torch.compaction", "--warehouse", wh,
             "--db-path", db, "--lease-ttl-s", str(FRESH_TTL_S), "--poll-s", "0.1",
             "--version-gap", "3", "--service-id", service_id],
            env=e, stdout=subprocess.DEVNULL, stderr=logs)

    killed: dict = {}
    closing = threading.Event()

    def kill_and_replace():
        deadline = time.monotonic() + FRESH_DEADLINE_S
        while time.monotonic() < deadline and not closing.is_set():
            lease = store.get_lease(lease_key)
            if lease is not None and lease.holder == "victim":
                procs["victim"].send_signal(signal.SIGKILL)
                procs["victim"].wait(10.0)
                killed["wall_ms"] = now_millis()
                procs["peer"] = compactor("peer", False)
                return
            time.sleep(0.05)

    slo = SloMonitor(target_s=slo_target, budget_fraction=0.05, slo="chip-smoke-freshness")
    tput = ThroughputSlo(FRESH_TPUT_FLOOR, slo="chip-smoke-freshness-tput")
    counter = registry().counter("lakesoul_follow_rows_total")
    got = {"seq": [], "id": [], "v": []}
    stops = [threading.Event(), threading.Event()]

    def follow_iter(stop, **opts):
        return t.scan().select(["id", "seq", "v"]).batch_size(FRESH_BATCH).to_torch_iter(
            follow={"poll_interval": 0.05, "stop_event": stop, "slo": slo,
                    "retry_policy": RetryPolicy(max_attempts=12, base_delay_s=0.002,
                                                max_delay_s=0.05, seed=7), **opts},
            device=DEVICE, drop_remainder=False)

    def take(b) -> int:
        for k in got:  # card batches copied back
            got[k].append(b[k].cpu().numpy())
        return int(b["seq"].shape[0])

    def takeover_committed() -> bool:
        # the peer's CompactionCommits, stamped with a token past the victim's
        fenced[:] = [v for v in store.get_partition_versions(t.info.table_id, "-5")
                     if v.commit_op == CommitOp.COMPACTION and v.expression.startswith("fence=")
                     and int(v.expression.split("=", 1)[1]) >= 2]
        return bool(fenced)

    t_phase = time.perf_counter()
    first, fenced, alive = 0, [], []
    killer = threading.Thread(target=kill_and_replace, daemon=True)
    try:
        procs["victim"] = compactor("victim", True)
        procs["writer"] = subprocess.Popen(
            [sys.executable, "-m", "lakesoul_tpu_torch.freshness", "writer", "--warehouse", wh,
             "--db-path", db, "--create", "--table", "fresh", "--commits", str(FRESH_COMMITS),
             "--rows-per-commit", str(FRESH_ROWS), "--keyspace", str(FRESH_KEYSPACE),
             "--hash-buckets", str(FRESH_BUCKETS), "--interval-s", str(FRESH_INTERVAL_S)],
            env=env, stdout=subprocess.PIPE, stderr=logs, text=True)
        killer.start()
        # every wait of the phase has a deadline: past it the streams stop
        # and the row check fails
        watchdog = threading.Timer(FRESH_DEADLINE_S, lambda: [e.set() for e in stops])
        watchdog.daemon = True
        watchdog.start()
        faults.clear()
        for point in ("follow.poll", "object_store.cat_file", "object_store.open"):
            faults.install(f"{point}:{FRESH_FAULT_P}:flaky")
        tput.start()
        t0 = time.perf_counter()
        it = follow_iter(stops[0], start_timestamp_ms=start_ts)
        saved = None
        for b in it:
            first += take(b)
            if first >= expected // 2:
                saved = it.follow_state_json()  # beside a model checkpoint
                stops[0].set()
                break
        del it  # closes the first stream's pipeline
        require(saved is not None, f"the first iterator ended at {first} rows")
        resume_at = time.perf_counter() - t0
        base_rows = counter.value
        writer = procs["writer"]

        def stop_when_delivered():
            wait_until(lambda: writer.poll() is not None
                       and counter.value - base_rows >= expected - first, FRESH_DEADLINE_S)
            stops[1].set()

        threading.Thread(target=stop_when_delivered, daemon=True).start()
        second = sum(take(b) for b in follow_iter(stops[1], state=saved))
        follow_s = time.perf_counter() - t0
        tput.add_rows(first + second)
        watchdog.cancel()
        faults.clear()
        out, _ = writer.communicate(timeout=FRESH_DEADLINE_S)
        oracle = json.loads(out.strip().splitlines()[-1])
        if killed:
            wait_until(takeover_committed, FRESH_DEADLINE_S, 0.2)
        compactions = [v for v in store.get_partition_versions(t.info.table_id, "-5")
                       if v.commit_op == CommitOp.COMPACTION]
    finally:
        faults.clear()
        for e in stops:
            e.set()
        closing.set()
        if killer.is_alive():
            killer.join(15.0)
        for proc in list(procs.values()):
            stop_child(proc)
        logs.close()
        alive = [p.pid for p in procs.values() if proc_alive(p.pid)]
        for pid in alive:
            os.kill(pid, signal.SIGKILL)
        with open(os.path.join(root, "children.log")) as f:
            log_tail = f.read()[-3000:]
        shutil.rmtree(root, ignore_errors=True)
    cols = {k: np.concatenate(v) if v else np.empty(0) for k, v in got.items()}
    sha = oracle_sha(list(zip(cols["seq"].tolist(), cols["id"].tolist(), cols["v"].tolist())))
    snap = slo.snapshot()
    rate = tput.evaluate()
    rec = {"config": f"freshness writer {FRESH_COMMITS} x {FRESH_ROWS} rows (keyspace "
                     f"{FRESH_KEYSPACE}, {FRESH_BUCKETS} buckets, {FRESH_INTERVAL_S} s apart), "
                     f"leased compactors (TTL {FRESH_TTL_S} s, victim SIGKILLed, peer), "
                     f"to_torch_iter(follow=..., batch {FRESH_BATCH}) on the card, faults p "
                     f"{FRESH_FAULT_P}", "device_kind": kind,
           "rows": int(cols["seq"].size), "expected_rows": expected,
           "rows_first_iterator": first, "resume_after_s": resume_at,
           "oracle_rows": oracle["rows"], "sha256": sha, "oracle_sha256": oracle["sha256"],
           "freshness_p50_s": snap["p50_s"], "freshness_p99_s": snap["p99_s"],
           "freshness_max_s": snap["max_s"], "slo_target_s": slo_target,
           "slo_in_budget": snap["in_budget"], "slo_violations": snap["violations"],
           "commits_observed": snap["count"], "follow_s": follow_s,
           "rows_per_s": int(cols["seq"].size) / follow_s,
           "throughput": rate, "compaction_commits": len(compactions),
           "fenced_commits": [v.expression for v in fenced],
           "kill_to_fenced_commit_s": (min(v.timestamp for v in fenced) - killed["wall_ms"])
           / 1000.0 if fenced and killed else None,
           "victim_killed": bool(killed), "writer_rc": procs["writer"].returncode,
           "children_alive_after": alive, "phase_s": time.perf_counter() - t_phase}
    emit("freshness", **rec)
    require(procs["writer"].returncode == 0, f"the writer exited {procs['writer'].returncode}: "
                                             f"{log_tail}")
    require(rec["rows"] == expected == oracle["rows"],
            f"the follower delivered {rec['rows']} rows, the writer wrote {oracle['rows']}")
    require(sha == oracle["sha256"], "the delivered rows differ from the writer's oracle")
    require(bool(killed), "the victim compactor never held a lease")
    require(bool(fenced), f"no fence=<n >= 2> CompactionCommit: {[v.expression for v in compactions]}")
    require(snap["in_budget"] and snap["p99_s"] <= slo_target and snap["count"] >= 1,
            f"the freshness SLO failed: {snap}")
    require(rate["ok"], f"the throughput SLO failed: {rate}")
    require(not alive, f"children {alive} outlived the phase; their log: {log_tail}")
    return rec


def main(argv: list) -> int:
    """``chip_smoke.py`` runs every phase; ``--plane-table DIR`` is the
    4-bit plane's table build leg, which the plane phase starts as a
    process of its own."""
    if argv[:1] == ["--plane-table"]:
        return plane_table_build(argv[1])
    if argv[:1] == ["--gateway-clients"]:
        return gateway_clients(argv[1])
    if argv[:1] == ["--detectors"]:
        return detectors_child(argv[1])

    started = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lakesoul_tpu_torch import _build
    from lakesoul_tpu_torch.annplane import ragged as R
    from lakesoul_tpu_torch.vector import kernels as K

    # 1. device: full float32 in every matmul, stated and set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", seconds=time.perf_counter() - started, kind=kind,
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, allow_tf32_matmul=False,
         allow_tf32_cudnn=False)

    # 2. build every kernel from csrc/
    t = time.perf_counter()
    report = _build.build()
    emit("build", seconds=time.perf_counter() - t, sources=list(_build.SOURCES),
         built=sorted(report), ptxas=[k for r in report.values() for k in ptxas_kernels(r["log"])])

    from lakesoul_tpu_torch import models as M
    from lakesoul_tpu_torch.models import convert as C

    import lakesoul_tpu_torch as L

    kernels = phase_kernels(torch, K, R)
    phase_register(kind)
    sl = phase_slice(torch, K, R)
    torch.cuda.empty_cache()
    ex = phase_ex_slice(torch, K, R)
    torch.cuda.empty_cache()
    planes, top = {}, None
    x, queries = make_plane_data(torch, DEVICE, PLANE_ROWS, N_QUERIES)
    phase_repro(torch, x)
    for bits in PLANE_BITS:  # one plane freed before the next
        planes[bits] = phase_plane(torch, K, R, x, queries, bits, top)
        top = planes[bits]["top"]
        torch.cuda.empty_cache()
    del x, queries
    torch.cuda.empty_cache()
    # the slice's corpus as a table: build_vector_index / vector_search
    vt = phase_vector_table(torch, K, R, L, kind)
    torch.cuda.empty_cache()

    # 8-10. the training steps (no hand kernel on their path), the MLP's rows
    # read from a table, ResNet-50 and BERT-base on a fixed batch and fed
    # from tables
    phase_mlp(torch, M, L, kind)
    rn = phase_resnet50(torch, M, C, kind)
    torch.cuda.empty_cache()
    phase_resnet50_table(torch, M, L, kind, rn["images_per_s"])
    torch.cuda.empty_cache()
    bb = phase_bert_base(torch, M, C, kind)
    torch.cuda.empty_cache()
    phase_bert_base_table(torch, M, L, kind, bb)
    torch.cuda.empty_cache()
    # 10c-10e. Switch-Base-8, its state saved and restored sharded, and every
    # plan step under NCCL on one card
    phase_checkpoint(torch, M, phase_moe_bert_base(torch, M, C, kind)[1], kind,
                     os.path.join(os.path.dirname(os.path.abspath(__file__)), ".scratch",
                                  "chip_smoke_checkpoint"))
    torch.cuda.empty_cache()
    phase_parallel(torch, M, C, kind)
    torch.cuda.empty_cache()

    # 11-11c. the table -> train-step loader and its replay cache, then the
    # fleet train role and the SQL layer on its table (host code and torch
    # ops: no hand kernel on their path)
    phase_loader(torch, M, L, kind)
    torch.cuda.empty_cache()
    # 12. the always-fresh loop: CDC writer, leased compactors, the follower
    # on the card
    phase_freshness(torch, L, kind)

    # ragged_score's record: the scale leg's 4-bit plane, the 1-bit plane's beside it
    timings = {**kernels["timings"], "packed_scan": sl["packed_scan_timing"],
               "packed_dot": sl["packed_dot_timing"],
               "ragged_score": {**planes[4]["ragged_timing"],
                                "one_bit_plane": planes[1]["ragged_timing"]}}
    gateways = [p[g] for p in (*planes.values(), vt) for g in ("gateway", "flight_sql_vector")
                if p.get(g)]
    require(len(gateways) == 3, "a gateway phase did not run")
    paths = [sl, ex, *planes.values(), vt, *gateways]
    record = []
    for name, (source, replaces, library_call) in KERNELS.items():
        t = timings[name]
        record.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(p["launches"][name] for p in paths),
            "max_abs_err": max([kernels["errs"][name]]
                               + [p.get("errs", {}).get(name, 0.0) for p in paths]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "shape": t["shape"],
            "library_call": library_call, **{k: t[k] for k in EXTRA_TIMINGS if k in t},
        })
    require(all(r["launches"] > 0 for r in record), "a kernel never ran on its path")
    emit("command", seconds=time.perf_counter() - started)
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
