#!/usr/bin/env python3
"""Drive nhd_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (one line each; the last line is the contract line):

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: the CUDA kernels (one nvcc per source, in parallel, into
   nhd_tpu_torch/_build/) and the native assignment core;
3. kernels vs plain: each solve kernel against its plain PyTorch version
   on the card, exact equality, at the solve buckets of both cells'
   clusters (cfg4: G=1 and G=2, U=2, K=7; cfg3: K=2; N=1000 in Np=1024
   rows, the main path's own inputs, first solve of each bucket) and a
   wide bucket (G=3, U=2, K=8, so C=8, A=512, N=4096, random from a seed);
   CUDA-event median times over 30 launches; rank_top on each bucket's
   planes at the batch's rank width (R = 512), timed beside its empty-body
   launch, its hand-counted bound, torch.topk alone on the same sel plane
   and the eager chain it replaced (``eager_rank_chain``, kept here as a
   yardstick only), and rank_merge on the candidates of cfg4's G=2 bucket
   cut into 4 shards, equal to the unsharded rank at every slot; both
   rank kernels, timed the same way, on the ``RANK_TIMED`` rows of the
   sweep (R = 2,048 at N = 16,384, past 1,024 winners; every type row
   padding, at N = 1,024 and 4,096); then every
   kernel on every edge shape of nhd_tpu_torch/kernels/sweep.py (random
   from a seed); plus the CUDA matcher against the serial oracle on a
   small random cluster;
4. cfg4:10kx1k-cap, speculative: 10,000 workload_mix pods on 1,000
   cap_cluster nodes through ``BatchScheduler(device="cuda")`` with the
   card's default (round 0 is the speculative megaround; one warm
   schedule, reset, one timed schedule), then the same batch on
   ``device="cpu"`` with ``NHD_TPU_SPECULATE=1``: every pod must land on
   the same node with the same mapping and NICs; round 0 must be one
   graph replay (one ``megaround_graph`` launch; ``spec_gate`` once
   before the WHILE node and once a pass, each claim kernel once a pass,
   as many passes as iterations); then one more cuda schedule,
   its megaround's fixed trip issued launch by launch
   (``speculate.REPLAY`` off), that copies the inputs of every solve
   (classic rounds and live megaround buckets) and of every call of
   ``spec_gate`` and the claim kernels, and each kernel against its plain
   version on each copy (dead iterations' calls, which return at once,
   counted, not compared; the claim kernels and ``spec_gate`` timed at
   the first iteration) and rank_top on the planes of every classic
   solve; then the whole megaround replayed from its
   starting state on the card's host loop and through the plain versions
   on the CPU: claims, counts, need left and iterations equal;
5. cfg3:10kx1k-sat, speculative: the same on bench_cluster nodes
   (NIC-saturated);
6. cfg4:10kx1k-cap, classic: phase 4 with ``NHD_TPU_SPECULATE=0`` on both
   sides (the classic rounds stay checked on the card); its profile read
   op by op (``rank_attribution``: the solve kernels, then the rank:
   rank_top, or the eager chain's torch.topk, gathers, sums and stack
   where an older tree ran it);
7. the daemon: cfg4's pending set (nhd_tpu_torch/sim/pending.py: 10,000
   Triad-config pods of workload_mix's three shapes on 1,000 cfg4 nodes of
   a FakeClusterBackend) through the port's ``Scheduler(device="cuda")``
   by its normal turn (node inventory, replay, ``check_pending_pods``
   scans until nothing more binds); every kernel must launch; then the
   same scenario on ``device="cpu"`` with speculation on (the card's
   default): every pod's node, solved config and NAD annotation and the
   bound count identical, the solver guard at full fidelity with no
   fault, retry or degrade; wall, binds per second and the daemon's bind
   latency histogram; then once more on the card under torch.profiler
   (not counted): device busy against the daemon's wall;
8. the solver guard on the card: ``audit_device_rows`` over every row of
   cfg4's resident state after a schedule finds nothing (and the
   16-row audit is timed); one injected ``dispatch`` fault in a classic
   cfg4 schedule is retried once with every pod placed as the fault-free
   run (``NHD_GUARD_RETRIES=2``: floor unmoved; ``=1``: floor at the
   non-resident rung, whose solves still launch the kernels on the card);
   the wall per round with the guard on against ``NHD_GUARD=0``;
9. cfg5:100kx10k-stream through the streaming tiler (bench.py
   cfg5, run_stream): 100,000 workload_mix pods (groups
   default/edge/batch/fed1/fed2) on 10,000 cap_cluster nodes, not cut.
   (a) ``StreamingScheduler(device="cuda", tile_nodes=16384,
   chunk_pods=100_000, placement="routed")`` after a warm run on a
   throwaway cluster: wall, pods/s, p99 bind, rounds, megaround
   iterations and phases; then the same batch on ``device="cpu"`` with
   ``NHD_TPU_SPECULATE=1`` and through the untiled
   ``BatchScheduler(device="cuda")``: every pod's node, mapping and NICs
   identical to the card's. (b) the same cell at ``tile_nodes=4096``: three
   tiles and three worker threads launching on the card; placements equal
   to the CPU run of the same tiling, the launch counts equal to the sum
   of what each tile sub-call's thread launched, both walls. (c) every
   solve and claim-kernel call of (a) copied and held to its plain
   version at the tile's size (Np=16,384); the first solve of each bucket
   and the first megaround iteration timed beside the kernel's empty-body
   launch on the same grid (kernel_variants.py's ``empty`` variant) and
   its bound. (d) 10,000 cfg4 nodes and 2,000 Triad pods (cut from
   100,000: this part tests the daemon's routing past NHD_STREAM_NODES)
   through ``Scheduler(device="cuda")``: the tiler engaged, every kernel
   launched, every pod's node, solved config and NAD identical to a
   ``device="cpu"`` run with speculation on and the same tile. (e) (a)
   once more under torch.profiler, not counted: device busy against the
   wall;
10. the CLI over HTTP: the port's ``StubApiServer`` (k8s/apistub.py), in
   this process, holds 1,000 cfg4 nodes with NFD labels and a ConfigMap
   for each of 1,000 pods of workload_mix's three Triad shapes (cut from
   10,000: each pod costs three HTTP writes on a threading stub; 2,000
   until phases 11-12 joined, 1,500 until phase 15 did). (b)
   ``python -m nhd_tpu_torch.cli --device cuda`` runs as a subprocess
   whose in-cluster REST client points at the stub, with
   ``NHD_MIN_BUSY_SECS=0``, a metrics port and a journal. Once it is up
   (its pod watch streams and /metrics answers) the pods are created
   through the stub, each announced on the pod watch, at most 200 not
   yet bound at a time, so they reach the scheduler through the
   admission front door; until every pod is bound (or binds stop for
   40 s). /metrics is scraped mid-run and at the end, then SIGINT (the
   CLI's clean exit): exit code 0, the journal written, and the
   kernels' launches the CLI process counted, each above 0; every pod
   bound; binds/s, each pod's create-to-bind p50/p99, the admission,
   guard and jit families, the wall. (c) the same CLI with ``--device
   cpu`` against a fresh stub: every pod bound, and every pod of the
   batches both journals record alike from the first on on the same
   node with the same solved config and NAD. (d) (b)'s journal replayed
   in this process through ``replay_journal``, fold by fold as recorded,
   on cuda (its launches a separate reading, each above 0) and on the
   CPU, (c)'s on cuda, and the golden journal (tests/fixtures/journal)
   on both: 0 divergences and equal decisions;
11. the device-fault storm on the card (nhd_tpu_torch/sim/storm.py, in
   this process, with ``--device-plane --bind-parity``, ``NHD_PIPELINE=1``
   and speculation on): (a) the reference's matrix, profile
   ``device-faults``, seeds 0-2, 40 steps, 4 nodes; (b) one seed at phase
   7's width, 1,000 nodes (resident rows Np = 1,024); each matrix once
   on cuda and once on the CPU. Every cell: its bound set equal to its
   own fault-free control on cuda and to the CPU run of the seed, its
   fault tallies by site, bit flips and churn restarts equal to the CPU
   run's, the end-state audit bit-exact, no guard give-up; over the
   matrix at least one fault at each of ``dispatch``, ``upload`` and
   ``megaround`` and one bit flip. (c) the negative control: flips only
   with ``NHD_GUARD=0`` on cuda must leave corruption the audit reports
   and no repair. Every kernel launches in the phase;
12. the kernel cache (nhd_tpu_torch/solver/aot.py) on the card, each
   probe a fresh ``python -m nhd_tpu_torch.solver.aot --first-bind-probe
   --device cuda`` in a temporary ``NHDC_AOT_DIR``: (a) cold, empty,
   ``--save`` (nvcc builds all ten libraries inside the bind: the nine
   kernels and the WHILE node's helper); (b) a
   restart without prewarm; (c) a restart with ``--prewarm`` (no build,
   no library load inside the bind); (d) a copy with one library
   truncated and one meta's fingerprint edited, ``--prewarm``: both
   quarantined (kept under ``quarantine/``), rebuilt, the pod bound;
   (e) the storm of tests/test_aot.py:151 (seed 11, 60 steps, ``light``)
   recorded here, then in a fresh process prewarmed and replayed: the
   jit-stats compiles flat, no library built or loaded, hits grown; (f)
   the CLI with ``--prewarm`` on phase 10's 1,000-node stub, twice (the
   first start records what it serves, the second warms it), 200 pods
   each: its prewarm line and its time to come up beside phase 10's,
   with the start-up steps read from its log;
13. the node mesh on the card (nhd_tpu_torch/parallel/; every shard on
   ``cuda:0``, so this is more launches of the same kernels, never a
   multi-GPU speed; the megaround of one device's shards is one graph):
   (a) the three solve kernels on each shard of an
   8-way mesh of cfg4's resident state (128 rows each) against their
   plain versions, solve_planes with its shard's ``node_base`` also
   against the unsharded planes' columns and, at ``node_base`` 0, its
   old output, and rank_top on each shard's planes with its node_base;
   shard 3 timed beside its bound and the empty launch; rank_merge on the
   8 shards' candidates, equal to the unsharded rank at every slot;
   (b) ``solve_bucket_ranked_sharded`` at cfg4 over 2, 4 and 8 shards
   equal to the single-device rank at every slot of every bucket; (c)
   cfg4:10kx1k-cap through ``BatchScheduler(mesh=4 shards)``,
   speculative and classic (warm, then counted): every pod
   placed as the single-device card run and the CPU run of phases 4 and
   6, the same rounds and megaround iterations, wall and launches
   beside one card's; the speculative round 0 one graph replay over the
   shards (one ``megaround_graph``, 1 + iterations of ``spec_gate``, no
   pinned status pull); then every claim-kernel and gate call of the
   mesh megaround's fixed trip once more (not counted) against its plain
   version, ``spec_elect`` and ``spec_apply`` at a shard's shapes,
   ``spec_fill`` over the joined plan, the first of each timed beside
   its bound and empty launch; (d) the port's cfg6 probe
   (``parallel/spmd_bench.run_probe(4096, 1024, 8)``: parity, churn rows
   O(changed rows) with no wholesale upload, a flat prewarm); (e) one
   injected ``megaround`` fault on the 4-shard mesh: the mesh condemned,
   the batch re-dispatched on one device, every pod placed as the
   fault-free classic run; (f) two processes on the card, each its own
   CUDA context on ``cuda:0``, one gloo group over a FileStore
   (``chip_smoke.mesh_child``): the global sharded solve over 2 x 4
   shards equal to the one-process mesh and to one device, and each
   rank's region of a 16-node federation placed as on the CPU; (g) the
   mesh's megaround graph from the encoded state of cfg4 over 4 shards
   and of cfg6 over 8 (``chip_smoke.mesh_graph``): the graph, its fixed
   trip, its host loop, the plain versions on the card and the graph's
   loop on the CPU's shards bit for bit; its WHILE node's passes counted
   on the card; a pass's launches; the host loop, the graph (live and
   with no need) and one card's graph in turns; the replay alone, live
   and with no need; a dispatch's host parts; then the process's graph
   cache (entries, captures, so an eviction shows);
14. the port's nhdsan and nhdrace on the card, in a fresh process that
   installs the deadlock sanitizer before any port module builds a lock
   (``chip_smoke.race_child``; its log in chiprun_out/race-child.log):
   (a) phase 11's cells through the storm on cuda under ``NHD_RACE=1
   NHD_SAN=1`` (the reference's device-chaos posture, phase 11's knobs):
   each cell's bound set and faults by site equal to phase 11's
   uninstrumented card run, 0 race witnesses; (b) cfg5's 10,000 nodes in
   three 4,096-node tiles, 2,000 pods (phase 9 (d)'s cut), the tile
   workers launching on cuda under nhdrace with the tiler's merge state
   watched: placements equal to the same input run uninstrumented in
   this process while the child starts, 0 race witnesses; (c) one cell
   (seed 0, 4 nodes, 5 steps: the injected race fires at install) with
   ``NHD_RACE_INJECT=1`` must report the injected race; over the child's
   life 0 wait-for-graph cycles. Each leg's wall beside its
   uninstrumented one; every kernel launches in (a) and in (b);
15. the megaround as one CUDA graph replay, its loop a WHILE node: from
   the starting state of the megarounds of phases 4, 5 and 9 (cfg4, cfg3
   and cfg5's 16,384-row tile), the graph (a cache of its own, so its
   first dispatch captures) against the fixed trip launch by launch
   (``speculate.REPLAY`` off), the host loop on the card, the plain
   versions on the card and, for cfg4 and cfg3, the plain replay on the
   CPU of phases 4-5: claims, counts, need left, iterations and node
   state bit for bit; a graph whose body also counts its passes on the
   card (``passes_of``): as many as the iterations, and none with no
   need; then the host loop, the graph and the graph with no need, in
   turns from the starting state, ``GRAPH_TIMED`` times each: host wall
   per dispatch, wall to its end and CUDA-event device time; the replay
   alone, live and with no need; the capture's time; and one cfg4
   replay's kernels under torch.profiler beside the count the launches
   say (``replay_kernels``), in this process and in a fresh one
   (``replay_profile_child``, full cfg4 width), where no more
   ``spec_gate`` launches than 1 + the iterations may show;
16. the operator gates on the card (nhd_tpu_torch/sim/soak.py,
   trace_demo.py, trace_replay.py, fleet_demo.py, obs/fleet_top.py;
   each part in this process, on cuda, then on the CPU with speculation
   on where it says so; each part's wall printed): (a) phase 7's run,
   cfg4's pending set of 10,000 pods on 1,000 nodes, with the flight
   recorder on, its ring sized from the pods
   (``trace_demo.ring_capacity``: 131,072): 0 spans dropped, the trace
   valid, every bound pod carrying solve/select/assign/bind and a
   scheduled decision on its node (a pod the scan found never waited in
   the watch queue: no queue_wait), placements equal to phase 7's run
   with the recorder off, the first batch's round-0 span carrying the
   megaround's claims, every solve kernel, the claim kernels and
   ``spec_gate`` launched; binds/s and wall beside phase 7's; (b) the
   trace demo at its defaults: each pod's span names (all five), the
   decisions and the round spans equal to the CPU run's; (c) the replay
   demo's four acts, then its card-recorded journal replayed on the CPU
   with 0 divergences; (d) the fleet demo: the same seed, cross-replica
   journeys by pod and fleet payload (times masked) as the CPU run;
   (e) the soak, 4 seeds x 60 steps at 4 nodes: every seed clean, the
   totals equal to the CPU's; (f) during phase 10's mid-run scrape,
   ``obs.fleet_top`` over the CLI's metrics port: exit 0 and its fleet
   artifact valid;
17. the policy engine, tiered preemption, churn past the stream
   threshold and the other storm modes on the card, each part on cuda
   and then on the CPU with the card's defaults made explicit
   (speculation, round pipelining, the rank cap; ``CARD_DEFAULTS``),
   each part's wall printed: (a) phase 7's cell with its nodes in
   cfg8:hetero's two generations (sim/pending.py ``hetero_class``: gen-b
   on the first half) under ``NHD_POLICY=1`` and cfg8's throughput
   matrix: every pod's node, solved config and NAD and the bound count
   equal to the CPU's, every scored batch without a megaround or a claim
   kernel, the solve kernels and rank_top launched; the aggregate placed
   throughput (bench.py:738-744), wall and binds/s beside the
   ``NHD_POLICY=0`` control on the card, which must place as phase 7;
   every solve and rank_top call of one scored cfg4 schedule through
   ``BatchScheduler`` copied and held to its plain version on the card,
   and of one over ``POLICY_WIDE_NODES`` nodes, whose rows take
   rank_select.cuh's wide path (64-bit words; no whole row of 1,024 keys
   or fewer needs them at any score: ``sweep.rank_words``); (b) after
   (a), ``PREEMPTORS`` tier-2 pods of the largest shape into the filled
   fleet: the fenced evictions, the victims, every pod's outcome (the
   preemptors' and the requeued victims') and the evictions of each
   batch equal to the CPU's, each batch within its eviction budget; and
   bench.py's micro-cell (2 nodes, 5 tier-0 then 2 tier-2 pods): its
   evictions above 0 and equal to the CPU's; (c) phase 9 (d)'s 10,000
   cfg4 nodes and 2,000 pods through the daemon past NHD_STREAM_NODES
   in three 4,096-node tiles (routed, persistent contexts under
   NHD_DELTA_STATE), then ``CHURN_TURNS`` turns of a seeded cfg7-mix
   script (creates, deletes of bound pods, cordon and maintenance
   toggles, group moves) applied through the fake backend and met by
   the daemon's inventory and watch path: after every turn every pod's
   node, solved config and NAD, the binds and the device-state counters
   equal to the CPU daemon's run of the same script, each turn's rows
   uploaded within bench.py:382-396's changed-row budget, the turn
   before's binds charged to it beside its own (a batch's claimed rows
   upload at the next batch's first solve), no full rebuild after the
   first turn, the megaround graph, the claim kernels, spec_gate and
   the solve kernels launched; the tile sub-calls launching from two
   threads or more; (d) the storm matrices of ``STORM_MODES`` (policy,
   tenant, HA, federation) through nhd_tpu_torch/sim/storm.py in this
   process: every cell's invariants held on cuda, each matrix equal to
   the CPU's with ``STORM_MASKED`` masked, the policy cells' scored
   batches without a megaround, the solve kernels launched in each
   mode. ``--only=17[:PARTS]`` runs phases 1-2 and this phase alone;
18. the kernels JSON line: per kernel its launches in phases 4-7 and
   9-14 (counts set to 0 just before each counted run and read just
   after; a megaround graph replay adds what its capture recorded;
   phase 10's and the subprocesses of 12 and 13 are those processes'
   own, from start to exit; 13's (a), (b) and (g) are comparisons, not
   counted; 14's are its child's (a) and (b) runs; phases 16 and 17 keep
   their parts' launches in their own reports, each part's required
   there), its
   time, its plain
   version's time and its bound — the solve kernels and rank_top at the
   cfg4 G=2 bucket, rank_merge over its 4 shards, the claim kernels and
   ``spec_gate`` at cfg4's first megaround iteration; ``library_ms`` is
   torch.topk alone on the rank kernels' keys (no single PyTorch call
   computes any other kernel). A path launches the rank kernels where it
   dispatched a classic rank (``RANKED``, from the jit stats): each
   phase requires them there. A bound counts the bytes and operations of
   the real type and node rows only (padded rows are sliced off and need
   no work); a
   claim kernel's counts what its iteration's data needs (the live type
   rows, the elected nodes, the nodes that took copies).

Exits non-zero, printing no result line, without CUDA, outside the
repository, or when any phase fails. A fuller report goes to
chiprun_out/chip_smoke_report.json.
"""

import collections
import contextlib
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the
# card's one non-tensor-core rate (float32), used for the kernels'
# compares and integer adds alike
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12
GROUPS = ["default", "edge", "batch"]
N_TIMED = 30
#: the cells' size: pods per batch, nodes per cluster; and the wide
#: bucket's node count
CELL_PODS, CELL_NODES, WIDE_N = 10_000, 1_000, 4096
#: RANK_SWEEP rows phase 3 times both rank kernels on: R = 2,048 at
#: cfg5's tile width (past 1,024 winners, only under NHD_TPU_RANK_CAP),
#: and every type row padding in each regime of rank_select.cuh
RANK_TIMED = ((8, 16384, 2, 2048, 4, 0, "sparse"), (4, 1024, 2, 512, 1, 0, "zero"),
              (8, 4096, 2, 512, 2, 0, "zero"))
#: the daemon phase's pending set: cfg4 nodes and pods (DAEMON_CUT names
#: a cut of the pod count, if one was made to stay in the time limit)
DAEMON_NODES, DAEMON_PODS, DAEMON_CUT = 1_000, 10_000, None
#: alternating guard-on / NHD_GUARD=0 schedule pairs timed in phase 8
GUARD_COST_PAIRS = 5
#: phase 9, cfg5:100kx10k-stream (bench.py): pods, nodes, groups, the
#: tiler's accelerator tile and chunk, the split tile of part (b), and the
#: warm run's pods (bench.py run_stream's)
FED_PODS, FED_NODES = 100_000, 10_000
FED_GROUPS = ["default", "edge", "batch", "fed1", "fed2"]
FED_TILE, FED_CHUNK, FED_SPLIT_TILE, FED_WARM_PODS = 16384, 100_000, 4096, 4096
#: phase 9 (d): the daemon past NHD_STREAM_NODES, and the cut it makes
STREAM_DAEMON_NODES, STREAM_DAEMON_PODS = 10_000, 2_000
STREAM_DAEMON_CUT = ("pods cut from 100,000 to 2,000: this part tests the "
                     "routing past NHD_STREAM_NODES; per-pod daemon host "
                     "work is phase 7's subject")
#: phase 10, the CLI over HTTP: cfg4 nodes and Triad pods on the stub
#: API server, the cut, how long binds must stop before the run is over
#: (longer than the daemon's 30 s idle before a periodic scan; once
#: every pod is bound, a short settle), the CLI's own time limit, and
#: the wait for its first bind after the first pod
CLI_NODES, CLI_PODS = 1_000, 1_000
CLI_CUT = ("pods cut from 10,000 to 1,000: each pod costs three HTTP writes "
           "(annotate, bind, event) on a threading stub; phase 7 keeps the "
           "10,000-pod set on the fake backend; 2,000 until phases 11-12 "
           "joined the smoke, 1,500 until phase 15 did")
CLI_QUIET_S, CLI_SETTLE_S, CLI_RUN_S, CLI_FIRST_BIND_S = 40.0, 2.0, 300, 120.0
#: phase 10: the wait for the CLI to come up, and the most pods created
#: and not yet bound at a time, below the admission queue's tenant lane
#: cap (NHD_ADMIT_TENANT_CAP, 256) so the front door sheds none
CLI_READY_S, CLI_BACKLOG = 180.0, 200
#: phase 11: the device-fault matrices (label, seeds, nodes, steps): the
#: reference's (Makefile:17-18, tools/chaos_storm.py:434) and one seed at
#: phase 7's cluster width; the knobs of --device-plane and the card's
#: defaults made explicit, so the CPU runs take the same rounds
CHAOS_CELLS = (("device-faults 4 nodes", 3, 4, 40),
               ("device-faults 1000 nodes", 1, 1_000, 40))
CHAOS_ENV = dict(NHD_TPU_DEVICE_STATE="1", NHD_GUARD_AUDIT_INTERVAL="1",
                 NHD_GUARD_AUDIT_ROWS="0", NHD_PIPELINE="1",
                 NHD_TPU_SPECULATE="1", NHD_MESH="off")
CHAOS_CONTROL_STEPS = 25
#: phase 12 (f): pods fed to each --prewarm start of the CLI
PREWARM_CLI_PODS = 200
#: phase 13, the node mesh on the card: the shard counts of the sharded
#: rank, the shards of the cfg4 batch and of the guard's rung, the rank
#: width, the cfg6 probe's sizes (bench.py:898-940: pods, nodes, shards,
#: churn rounds) and the two-process leg (ranks x shards each)
MESH_SHARDS = (2, 4, 8)
MESH_BATCH_SHARDS = 4
MESH_R = 512
CFG6 = (4096, 1024, 8, 4)
#: cfg6's groups and its pods, cycled from a catalog of 256 (the probe's,
#: parallel/spmd_bench.py)
CFG6_GROUPS = ["default", "edge"]
MESH_RANKS, MESH_RANK_SHARDS = 2, 4
#: phase 14, the sanitized legs: phase 11's cells under nhdsan and
#: nhdrace (the reference's device-chaos posture, Makefile:198), the
#: tiler's three 4,096-node tiles of cfg5 at phase 9 (d)'s 2,000-pod cut,
#: the injected-race control (seeds, nodes, steps) and the child's limit
RACE_ENV = dict(CHAOS_ENV, NHD_RACE="1", NHD_SAN="1")
RACE_TILER_PODS = STREAM_DAEMON_PODS
RACE_CONTROL = (1, 4, 5)
RACE_CHILD_S = 600
#: the cfg4 batch's results on one card and on the CPU, by cell name,
#: for phase 13's placements
RESULTS = {}
#: phase 15: each megaround's starting state (``Capture.megarounds``) by
#: cell, and the plain replay's results on the CPU (phases 4, 5 and 9)
SNAPS = {}
PLAIN_REPLAYS = {}
#: phase 15: replays timed per cell, and the dead-iteration probe's
GRAPH_TIMED = 20
#: phase 16 (a): each pod's (node, solved config, NAD) as phase 7's
#: counted run on the card left it
DAEMON_OUTCOME = {}
#: phase 16: each part's figures, for the report
OPS = {}
#: phase 16 (e): the soak's seeds, steps and nodes on each device
SOAK_SEEDS, SOAK_STEPS, SOAK_NODES = 4, 60, 4
#: phase 17: each part's figures, for the report
POLICY = {}
#: phase 17: the card's defaults made explicit for every CPU run (the
#: speculative round 0, round pipelining, the rank cap), so both sides
#: take the same rounds
CARD_DEFAULTS = dict(NHD_TPU_SPECULATE="1", NHD_PIPELINE="1",
                     NHD_TPU_RANK_CAP="512")
#: phase 17 (a): the nodes of the second scored schedule copied, whose
#: rank rows (Np = 4,096) pass rank_select.cuh's whole-row limit of 1,024
#: keys, and (b) the tier-2 preemptors sent into the filled fleet
POLICY_WIDE_NODES, PREEMPTORS = 4096, 4
#: phase 17 (c): the churn script's seed, turns and events a turn
#: (bench.py cfg7's mix), and what was cut
CHURN_SEED, CHURN_TURNS, CHURN_EVENTS = 7, 4, 200
CHURN_CUT = ("cfg7's stream (10,000 events a second for 60 simulated s, "
             "bench.py:1300-1305) cut to 4 turns of 200 events: the part "
             "holds every turn to the CPU daemon's run of the same script, "
             "and the CPU side must fit the smoke's time limit")
#: phase 17 (d): the storm matrices of the other modes (Makefile:19-22,
#: :167-185) at the Makefile's sizes, each (mode, arguments), the knobs
#: both sides run under (the card's defaults made explicit) and the
#: summary fields masked in the comparison: ``wall_seconds``, the
#: matrix's wall clock (``time.time``), the one field no run can repeat
STORM_MODES = (
    ("policy", ["--policy", "--profiles", "mixed-gen,quota-storm,maint-wave",
                "--seeds", "3", "--steps", "40"]),
    ("tenant", ["--tenant", "--profiles", "tenant-storm", "--seeds", "2",
                "--steps", "40"]),
    ("ha", ["--ha", "--profiles", "ha-light,ha-storm", "--seeds", "6",
            "--steps", "50"]),
    ("federation", ["--federation", "3", "--replicas", "3", "--profiles",
                    "fed-light,fed-storm", "--nodes", "6", "--seeds", "6",
                    "--steps", "50"]),
)
STORM_ENV = dict(CARD_DEFAULTS, NHD_MESH="off")
STORM_MASKED = frozenset({"wall_seconds"})
#: phase 16: the span names every pod bound by a scan batch carries (a
#: pod found by the scan never waited in the watch queue, so it has no
#: queue_wait span; (b) drives the watch path and holds all five)
SCAN_SPANS = frozenset({"solve", "select", "assign", "bind"})
#: the kernels of a speculative batch on one device, and on a mesh of
#: one device's shards (one graph replay of the same body over the
#: shards): the solve kernels, the claim kernels and spec_gate (the rank
#: kernels run only in the classic rounds after the megaround, where
#: there are any)
SPEC_PATH = ("nic_node_masks", "nic_any_first", "solve_planes",
             "spec_elect", "spec_fill", "spec_apply", "spec_gate")
ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_JOURNAL = os.path.join(ROOT, "tests", "fixtures", "journal",
                              "golden_churn.journal.jsonl")


def card(torch):
    """The one card this script drives."""
    return torch.device("cuda", 0)


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


#: the key beside a counted run's launches that holds its classic rank
#: dispatches (kernel.dispatch_ranked's jit-stats uses; a key the kernel
#: cache prewarms counts one, and launches rank_top once)
RANKED = "ranked_dispatches"


def ranked_uses(shapes=None):
    """The classic rank dispatches in a jit-stats ``shapes`` map (this
    process's when None): each ``solve_ranked`` use launches rank_top,
    once a shard, and rank_merge once on a mesh."""
    if shapes is None:
        from nhd_tpu_torch.obs.jitstats import JIT_STATS

        shapes = JIT_STATS.snapshot()["shapes"]
    return sum(n for k, n in shapes.items() if k.startswith("solve_ranked:"))


def require_launched(label, launches, path, *, mesh=False):
    """Fail unless every kernel of *path* launched in the counted run of
    *launches* and, where that run dispatched a classic rank
    (``launches[RANKED]`` > 0), rank_top did, and rank_merge on a *mesh*.
    A run whose rounds all ran in the megaround dispatches no rank and
    needs neither."""
    need = list(path)
    if launches.get(RANKED):
        need += ["rank_top"] + (["rank_merge"] if mesh else [])
    missing = [k for k in need if not launches.get(k)]
    if missing:
        fail(f"{label}: kernels {missing} were never launched (classic rank "
             f"dispatches: {launches.get(RANKED, 0)})")


def add_launches(total, launches):
    """Add one reading of ``kernels.LAUNCHES`` (or a part of it) to *total*."""
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_time_ms(torch, fn, n=N_TIMED, prep=None):
    """Median device time of one call of *fn*, from CUDA events around each
    call. A spin kernel queued first holds the card while the host
    enqueues all calls, so host launch overhead does not enter the times.
    *prep*, queued before each start event, restores what *fn* writes in
    place, so every call does the same work."""
    for _ in range(3):
        if prep is not None:
            prep()
        fn()
    torch.cuda.synchronize()
    sleep = getattr(torch.cuda, "_sleep", None)
    if sleep is not None:
        sleep(int(5e8))
    pairs = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        if prep is not None:
            prep()
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def max_abs_err(torch, got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            return float("inf")
        if g.numel():
            d = (g.to(torch.float64) - w.to(torch.float64)).abs().max()
            err = max(err, float(d))
    return err


def needed_bytes(name, tensors, real):
    """Bytes kernel *name* must move: each tensor of its interface
    (inputs, then outputs, as abi.ABI lists them) read or written once,
    with the type axis T and the node axis N cut to their real lengths.
    Padded type rows and padded node rows are sliced off by the host: no
    answer needs them."""
    from nhd_tpu_torch.kernels.abi import ABI

    total = 0
    for arg, t in zip(ABI[name].args, tensors, strict=True):
        n = t.element_size()
        for sym, size in zip(arg.dims, t.shape, strict=True):
            n *= min(size, real.get(sym, size))
        total += n
    return total


def needed_ops(name, args, outs, real):
    """The compares and adds this data needs, over the real T and N."""
    T, N = real["T"], real["N"]
    if name == "nic_node_masks":
        nic_count, _sw, gpu_free_sw, combo = args[:4]
        U, S, G = nic_count.shape[1], gpu_free_sw.shape[1], combo.shape[1]
        return N * outs[0].shape[1] * (U + S + G * G + G)
    if name == "nic_any_first":
        unchosen = args[4]  # [CA, UK]
        # one decision per (t, n, ca) slot, and every pick that passes ran
        # its whole slot loop: two compares per chosen slot
        chosen_min = int((~unchosen).sum(1).min())
        passing = int(outs[2][:T, :N].sum())
        return T * N * unchosen.shape[0] + 2 * chosen_min * passing
    # solve_planes: per (t, n) the combo, GPU, CPU and misc-slot loops
    C, U, G = args[21].shape[2], args[8].shape[1], args[18].shape[1]
    return T * N * (10 + C * (U * G + U * (U * G + U + 1) + 4))


def bound_of(moved, ops):
    """(bound_ms, bound_by, bytes, ops): the larger of *moved* bytes at the
    card's memory rate and *ops* at its vector rate."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / VECTOR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), moved, ops


def bounds(name, args, outs, real):
    """(bound_ms, bound_by, bytes, ops) for one launch on this data."""
    tensors = [a for a in args if hasattr(a, "element_size")] + list(outs)
    return bound_of(needed_bytes(name, tensors, real),
                    needed_ops(name, args, outs, real))


def _distinct(*cols):
    """How many distinct rows the equal-length index columns *cols* hold."""
    import torch

    if not cols[0].numel():
        return 0
    return int(torch.stack(cols, 1).unique(dim=0).shape[0])


def claim_needs(name, t, real, kw):
    """(bytes, ops) claim kernel *name* needs at one megaround iteration.
    *t* holds its tensors by interface name as the call found them (and,
    for spec_elect, the ``plan`` it wrote); *real* the real node count N.
    Counted from this iteration's data, each needed word read once and
    each written word written once: the cand plane of the live type rows
    (need > 0) at every real node and the pref plane where cand is set;
    the node rows of the elected nodes (spec_elect) or of the nodes that
    took copies (spec_apply) and the distinct table rows they use; with
    NIC sharing off, the rx headroom of a claiming node's NICs and the
    NICs it takes; the switches of its PCI GPU slots. spec_fill reads the
    elect row of every real node and the rest of the plan at winners."""
    import torch

    from nhd_tpu_torch.kernels.reference import _elected_rows

    N = real["N"]
    plan = t["plan"][:, :N]
    elected = plan[0] >= 0
    if name == "spec_fill":
        wins = int(elected.sum())
        rows = int(plan[0][elected].unique().numel())
        # elect everywhere; hi and cap read, count written at winners; the
        # need of each row with winners read and written; the progress flag
        return 4 * N + 12 * wins + 8 * rows + 4, N + 3 * wins
    sharing = kw["sharing"]
    U = t["cpu_free"].shape[1]
    K = t["nic_free"].shape[2]
    UK = U * K
    pick = elected if name == "spec_elect" else elected & (plan[6] > 0)
    ns = pick.nonzero().flatten()
    n_pick = int(ns.numel())
    p = plan[:, ns].long()
    tt, ca, _, _, occ = _elected_rows(t["trow"], p, t["cpu_g"], t["cpu_m"],
                                      t["gpu_g"], t["nic_occ"], t["smt"][ns], U)
    C_t = t["trow"][tt, 1].long()
    cb = torch.minimum(p[3].clamp(min=0), C_t - 1)
    mb = p[4].clamp(0, U - 1)
    s = (~t["smt"][ns]).long()
    # the [U] demand rows of cpu_g, cpu_m and gpu_g the picked nodes read
    tables = 4 * U * (_distinct(s, tt, cb) + _distinct(s, tt, mb)
                      + _distinct(tt, cb))
    if name == "spec_elect":
        live = t["status"][1:] > 0
        lt = live.nonzero().flatten()
        off = t["plane_off"][lt]
        idx = (off[:, :1] + off[:, 1:]
               + torch.arange(N, device=off.device)[None, :])
        cand = int((t["planes"][idx] != 0).sum()) if N else 0
        node_rows = 1 + 4 * U + 4 * U + 4 + (0 if sharing else 4 * UK)
        if not sharing:
            tables += 4 * U * _distinct(tt, ca)
        moved = (4 * t["status"].shape[0] + 16 * int(lt.numel()) + 4 * N * int(lt.numel())
                 + 4 * cand + 12 * n_pick + 16 * _distinct(tt)
                 + n_pick * node_rows + tables + 7 * 4 * N)
        ops = (N * int(lt.numel()) + 2 * cand
               + n_pick * U * (6 + (0 if sharing else K)))
        return moved, ops
    # spec_apply: one gpu_uk row per distinct (type, ca); nic_rx and
    # nic_tx rows with sharing on, the nic_occ row with it off
    tables += (4 * UK + (8 * UK if sharing else 4 * U)) * _distinct(tt, ca)
    k = p[6]
    per_node = (12 + 1 + 2 * (8 * U + 4) + 8 + (1 if kw["respect_busy"] else 0))
    if sharing:
        nic = n_pick * 16 * UK  # rx and tx of every slot, read and written
    else:
        free = t["nic_free"][ns][..., 0] > 0                       # [n, U, K]
        room = (k[:, None].float() * occ)[..., None]
        taken = free & (free.int().cumsum(2) <= room)
        nic = n_pick * 4 * UK + 8 * int(taken.sum())  # rx read, taken zeroed
    guk = t["gpu_uk"][tt, ca] != 0                                 # [n, UK]
    sw = t["nic_sw"][ns].reshape(n_pick, UK)
    S = t["gpu_free_sw"].shape[1]
    on_sw = guk & (sw >= 0) & (sw < S)
    switches = _distinct(on_sw.nonzero()[:, 0], sw[on_sw]) if n_pick else 0
    # the elect and count rows everywhere; A, C and hugepages of each type;
    # the switch of each PCI GPU slot, and each such switch read and written
    moved = (8 * N + n_pick * per_node + 12 * _distinct(tt) + tables + nic
             + 4 * int(guk.sum()) + 8 * switches)
    ops = n_pick * (4 * U + (2 * UK if sharing else UK)) + int(guk.sum())
    return moved, ops


def gate_needs(t):
    """(bytes, ops) of one ``spec_gate`` call: the status vector and the
    bucket offsets read once, the control tensor read and written; one
    add a type row, one compare a bucket and the alive flag's three."""
    TT1, B1 = t["status"].shape[0], t["offsets"].shape[0]
    return 4 * TT1 + 4 * B1 + 8 * (B1 + 1), (TT1 - 1) + 2 * (B1 - 1) + 3


def claim_bound(name, t, real, kw):
    """(bound_ms, bound_by, bytes, ops) of one claim-kernel (or
    ``spec_gate``) call."""
    return bound_of(*(gate_needs(t) if name == "spec_gate"
                      else claim_needs(name, t, real, kw)))


def rank_needs(name, t, out, real):
    """(bytes, ops) one rank-kernel call needs over the real type rows,
    counted by hand (the interface counts every plane and node row whole).
    rank_top: the sel plane over the real T x N, per winner its four
    decision-plane words, the 2U + 1 free words of each distinct winning
    node, and the nine output rows; one compare a key and 2U adds a
    winner. rank_merge: row 0 of the candidates over the real T, the
    other eight words of each winner and the nine output rows; one
    compare a key. *t* holds the call's tensors by interface name, *out*
    its [9, T, R] result."""
    T = real["T"]
    R = out.shape[2]
    if name == "rank_top":
        N, U = real["N"], t["gpu_free"].shape[1]
        nodes = int(out[1, :T].unique().numel())
        return (4 * T * N + 16 * T * R + 4 * (2 * U + 1) * nodes + 36 * T * R,
                T * N + 2 * U * T * R)
    M = t["cand"].shape[2]
    return 4 * T * M + 32 * T * R + 36 * T * R, T * M


def rank_bound(name, t, out, real):
    """(bound_ms, bound_by, bytes, ops) of one rank-kernel call."""
    return bound_of(*rank_needs(name, t, out, real))


def eager_rank_chain(torch, planes, gpu_free, cpu_free, hp_free, R):
    """The rank as eager torch ops, as the port computed it before
    rank_top: torch.topk, four gathers, two row sums over the node axis,
    three index gathers and a stack. A yardstick for rank_top's time
    only: its val-0 slots may order otherwise, and nothing on the main
    path calls it."""
    val, idx = torch.topk(planes[0], R, dim=1)

    def gat(p):
        return torch.gather(planes[p], 1, idx)

    i32 = torch.int32
    return torch.stack([
        val, idx.to(i32), gat(3), gat(4), gat(5), gat(7),
        gpu_free.sum(1, dtype=i32)[idx], cpu_free.sum(1, dtype=i32)[idx],
        hp_free.to(i32)[idx],
    ])


def check_rank(torch, label, name, args, kw, real, *, timed=False, floors=None):
    """Rank kernel *name* against its plain version on *args* (its inputs
    in interface order) and *kw*, exactly; with *timed*, its time, its
    plain version's, its hand-counted bound, torch.topk alone on the same
    keys and R (the library yardstick), for rank_top the eager chain it
    replaced, and with *floors* its empty-body launch. Returns the
    numbers and the kernel's output."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.kernels import reference
    from nhd_tpu_torch.kernels.abi import ABI

    kfn, pfn = getattr(kernels, name), getattr(reference, name)
    got, want = kfn(*args, **kw), pfn(*args, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    if err != 0.0:
        fail(f"{name} disagrees with its plain version at {label}: max abs err {err}")
    res = {"max_abs_err": err}
    if not timed:
        return res, got
    t = dict(zip((a.name for a in ABI[name].inputs), args))
    keys = args[0][0]
    R = got.shape[2]
    res["ms"] = cuda_time_ms(torch, lambda: kfn(*args, **kw))
    res["plain_ms"] = cuda_time_ms(torch, lambda: pfn(*args, **kw))
    res["topk_ms"] = res["library_ms"] = cuda_time_ms(
        torch, lambda: torch.topk(keys, R, dim=1))
    if name == "rank_top":
        res["chain_ms"] = cuda_time_ms(
            torch, lambda: eager_rank_chain(torch, *args[:4], R))
    bound_ms, bound_by, moved, ops = rank_bound(name, t, got, real)
    res.update(bound_ms=bound_ms, bound_by=bound_by, bytes=moved, ops=ops)
    floor = ""
    if floors is not None:
        res["floor_ms"] = floor_ms(torch, floors, name, args, kw)
        floor = f", empty launch {res['floor_ms']:.4f} ms"
    chain = f", the eager chain {res['chain_ms']:.4f} ms" if "chain_ms" in res else ""
    log(f"kernel {name} @ {label} R={R}: exact; {res['ms']:.4f} ms (plain "
        f"{res['plain_ms']:.4f} ms, torch.topk alone {res['topk_ms']:.4f} ms{chain}, "
        f"bound {bound_ms:.6f} ms by {bound_by}, {moved} B, {ops} ops{floor})")
    return res, got


def check_merge(torch, label, cand, whole, real, *, timed=False):
    """rank_merge on a mesh's candidates *cand* (each shard's rank_top,
    joined in shard order) against its plain version, and the merged rank
    against the unsharded rank *whole* at every slot: a shard's zero
    candidates are its lowest-index zero nodes, in order."""
    from nhd_tpu_torch import kernels

    R = whole.shape[2]
    res, merged = check_rank(torch, label, "rank_merge",
                             (cand, kernels.live_gate(cand.device)), {"R": R},
                             real, timed=timed,
                             floors=build_floors() if timed else None)
    if not torch.equal(merged, whole):
        fail(f"rank_merge at {label} is not the unsharded rank at every slot")
    return res


def rank_rows(torch, dev, report):
    """Both rank kernels on the ``RANK_TIMED`` sweep rows against their
    plain versions, exactly, timed as in ``check_rank`` beside the empty
    launch on the same grid (rank_merge on the row's shards' candidates)."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.kernels import sweep

    gate = kernels.live_gate(dev)
    for row in RANK_TIMED:
        c = sweep.rank_case(sweep.RANK_SWEEP.index(row), *row)
        up = {k: torch.from_numpy(c[k]).to(dev)
              for k in ("planes", "gpu_free", "cpu_free", "hp_free", "cand")}
        label = f"sweep (T, N, U, R, S, node_base, fill)={row}"
        res = {}
        res["rank_top"], _ = check_rank(
            torch, label, "rank_top",
            (up["planes"], up["gpu_free"], up["cpu_free"], up["hp_free"], gate),
            {"R": c["R"], "node_base": c["node_base"]}, {"T": row[0], "N": row[1]},
            timed=True, floors=build_floors())
        res["rank_merge"], _ = check_rank(
            torch, f"{label} merge (M={up['cand'].shape[2]})", "rank_merge",
            (up["cand"], gate), {"R": c["merge_R"]}, {"T": row[0]},
            timed=True, floors=build_floors())
        report["kernels"][label] = res


def stage(kernel_mod, reference, node, pod):
    """Each kernel's (args, keywords) at one solve, the intermediate inputs
    made by the plain versions."""
    m_args = kernel_mod.mask_args(node, pod)
    valid, pci_ok = reference.nic_node_masks(*m_args)
    n_args, n_kw = kernel_mod.nic_args(node, pod, valid, pci_ok)
    nic = reference.nic_any_first(*n_args, **n_kw)
    return {
        "nic_node_masks": (m_args, {}),
        "nic_any_first": (n_args, n_kw),
        "solve_planes": (kernel_mod.plane_args(node, pod, *nic), {}),
    }


def floor_ms(torch, floors, name, args, kw, prep=None):
    """Median time of kernel *name*'s empty-body variant (``floors``, from
    ``build_floors``) launched on the same grid as *args* give it."""
    import kernel_variants as kv

    return cuda_time_ms(torch, kv.caller(torch, floors[name], name, args, kw),
                        prep=prep)


@functools.lru_cache(maxsize=None)
def build_floors():
    """{kernel: entry point} of each kernel built with an empty body
    (kernel_variants.py's ``empty`` variants), one nvcc per source, all
    started together, into the git-ignored build directory; built once
    per process."""
    import kernel_variants as kv

    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.kernels import build

    libs = kv.build_all({(k, "empty"): kv.variant_source(k, "empty")
                         for k in kernels.KERNELS},
                        os.path.join(str(build.BUILD_DIR), "floors"))
    return {k: kv.entry(libs[(k, "empty")], k) for k in kernels.KERNELS}


def check_kernels(torch, label, node, pod, report, real, *, timed=True,
                  floors=None, R=None):
    """One solve's kernels against their plain versions on the card, on
    the same inputs; with *timed*, also their times and bounds (and, with
    *floors*, the empty-body launch on the same grid). *real*: the real
    type and node counts {"T": ..., "N": ...} of the padded tensors. With
    *R* (a classic round's rank width), rank_top too, on the planes."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.kernels import reference
    from nhd_tpu_torch.solver import kernel as kernel_mod

    staged = stage(kernel_mod, reference, node, pod)
    out = {}
    for name in kernels.SOLVE_KERNELS:
        args, kw = staged[name]
        kfn = getattr(kernels, name)
        pfn = getattr(reference, name)
        got = kfn(*args, **kw)
        want = pfn(*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        if err != 0.0:
            fail(f"{name} disagrees with its plain version at {label}: "
                 f"max abs err {err}")
        out[name] = {"max_abs_err": err}
        planes = want  # solve_planes comes last: the rank's input
        if not timed:
            continue
        ms = cuda_time_ms(torch, lambda: kfn(*args, **kw))
        plain_ms = cuda_time_ms(torch, lambda: pfn(*args, **kw))
        outs = got if isinstance(got, tuple) else (got,)
        bound_ms, bound_by, moved, ops = bounds(name, args, outs, real)
        out[name].update({
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": moved, "ops": ops,
        })
        floor = ""
        if floors is not None:
            out[name]["floor_ms"] = floor_ms(torch, floors, name, args, kw)
            floor = f", empty launch {out[name]['floor_ms']:.4f} ms"
        log(f"kernel {name} @ {label}: exact; {ms:.4f} ms (plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms by {bound_by}, "
            f"{moved} B, {ops} ops{floor})")
    if R is not None:
        a = dict(zip(kernel_mod._ARG_ORDER, node))
        args = (planes, a["gpu_free"], a["cpu_free"], a["hp_free"],
                kernels.live_gate(planes.device))
        out["rank_top"], _ = check_rank(
            torch, label, "rank_top", args, {"R": R}, real, timed=timed,
            floors=build_floors() if timed else None)
    report["kernels"][label] = out
    return out


class Capture:
    """What one schedule sends to the kernels, copied as it happens: every
    solve (classic rounds through ``solve_ranked``, megaround iterations
    through ``speculate.solve_planes``) as (G, real, node tensors, pod
    tensors, the rank width R of a classic round or None), a megaround
    solve whose bucket gate was 0 only counted
    (``dead_solves``: its kernels launch and return at once); every call
    of a claim kernel or ``spec_gate`` as (name, its tensors by interface
    name as the call found them, keywords); every megaround's starting
    state as (node tensors by name, bucket pods, needs, respect_busy)."""

    def __init__(self):
        self.solves, self.claims, self.megarounds = [], [], []
        self.dead_solves = 0


@contextlib.contextmanager
def spy_claims(calls):
    """While inside, every call of a claim kernel or ``spec_gate`` appends
    (name, its input tensors by interface name, cloned as the call found
    them, keywords) to *calls*."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.kernels.abi import ABI

    orig = {name: getattr(kernels, name)
            for name in (kernels.GATE_KERNEL, *kernels.CLAIM_KERNELS)}

    def spy(name):
        names = [a.name for a in ABI[name].inputs]

        def call(*args, **kw):
            # the held output buffer (spec_elect's plan) stays the call's:
            # each check allocates its own
            calls.append((name, {n: a.clone() for n, a in zip(names, args)},
                          {k: v for k, v in kw.items() if k != "out"}))
            return orig[name](*args, **kw)
        return call

    for name in orig:
        setattr(kernels, name, spy(name))
    try:
        yield calls
    finally:
        for name, fn in orig.items():
            setattr(kernels, name, fn)


def capture_schedule(torch, sched, nodes, items):
    """One more schedule of the batch (allocation state reset) through the
    spies of ``Capture``, the megaround's fixed trip issued launch by
    launch (``speculate.REPLAY`` off: a replay runs no Python to spy on).
    Runs after the counted run, so its launches are not counted; fails
    unless the spies saw every launch of the schedule. Returns (results,
    stats, Capture)."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.solver import speculate
    from nhd_tpu_torch.solver.device_state import DeviceClusterState

    cap = Capture()
    real_types = {}
    solve_ranked = DeviceClusterState.solve_ranked
    megaround = DeviceClusterState.megaround
    solve_planes = speculate.solve_planes

    def spy_ranked(self, pods, R):
        self._flush_staged()  # the claims this solve must see
        cap.solves.append((
            pods.G, {"T": pods.n_types, "N": self.N},
            [t.clone() for t in self.tensors()], self.pod_tensors(pods),
            min(R, self.Np),
        ))
        return solve_ranked(self, pods, R)

    def spy_megaround(self, bucket_pods, needs, respect_busy):
        self._flush_staged()
        real_types.clear()
        real_types.update({p.G: p.n_types for p in bucket_pods})
        real_types["N"] = self.N
        cap.megarounds.append((
            {k: v.clone() for k, v in self._dev.items()}, list(bucket_pods),
            [n.copy() for n in needs], respect_busy, self.N,
        ))
        return megaround(self, bucket_pods, needs, respect_busy)

    def spy_planes(G, U, K, node, pod, out=None, gate=None, **place):
        if gate is not None and int(gate[0]) == 0:
            cap.dead_solves += 1
        else:
            cap.solves.append((
                G, {"T": real_types[G], "N": real_types["N"]},
                [t.clone() for t in node], pod, None,
            ))
        return solve_planes(G, U, K, node, pod, out=out, gate=gate, **place)

    for n in nodes.values():
        n.reset_resources()
    kernels.reset_launches()
    DeviceClusterState.solve_ranked = spy_ranked
    DeviceClusterState.megaround = spy_megaround
    speculate.solve_planes = spy_planes
    speculate.REPLAY = False
    try:
        with spy_claims(cap.claims):
            results, stats = sched.schedule(nodes, items, now=0.0)
    finally:
        DeviceClusterState.solve_ranked = solve_ranked
        DeviceClusterState.megaround = megaround
        speculate.solve_planes = solve_planes
        speculate.REPLAY = True
    torch.cuda.synchronize()
    # the spies saw every launch, or a seam moved and a check would miss it
    for name in kernels.SOLVE_KERNELS:
        if kernels.LAUNCHES[name] != len(cap.solves) + cap.dead_solves:
            fail(f"{name} launched {kernels.LAUNCHES[name]} times, but the spies "
                 f"saw {len(cap.solves)} solves and {cap.dead_solves} dead ones")
    for name in (kernels.GATE_KERNEL, *kernels.CLAIM_KERNELS):
        seen = sum(1 for c in cap.claims if c[0] == name)
        if kernels.LAUNCHES[name] != seen:
            fail(f"{name} launched {kernels.LAUNCHES[name]} times, but the spies "
                 f"saw {seen} calls")
    ranked = sum(1 for s in cap.solves if s[4] is not None)
    if kernels.LAUNCHES["rank_top"] != ranked:
        fail(f"rank_top launched {kernels.LAUNCHES['rank_top']} times, but the "
             f"spies saw {ranked} classic solves")
    return results, stats, cap


def claim_args(name, t):
    """Kernel *name*'s inputs from *t* by interface name; a gate the call
    did not pass (the host loop of a mesh passes none) is the live one."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.kernels.abi import ABI

    dev = next(iter(t.values())).device
    return [t[a.name] if a.name in t else kernels.live_gate(dev)
            for a in ABI[name].inputs]


def run_claim(torch, fn, name, snap, kw):
    """Call claim kernel (or plain version) *fn* on a copy of *snap*;
    returns the copy (in-place tensors updated) with ``plan`` set to the
    plan the call wrote or read."""
    t = {k: v.clone() for k, v in snap.items()}
    out = fn(*claim_args(name, t), **kw)
    if name == "spec_elect":
        t["plan"] = out
    return t


def check_claims(torch, label, calls, report, real, *, timed, floors=None):
    """Each captured claim-kernel call, kernel and plain version on two
    copies of its inputs: every tensor the call writes must be equal.
    With *timed*, the first call of each kernel is also timed (its
    in-place inputs restored before every launch) and bounded, and with
    *floors* its empty-body launch on the same grid timed too."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.kernels import reference
    from nhd_tpu_torch.kernels.abi import ABI

    out = {}
    dead = 0
    for i, (name, snap, kw) in enumerate(calls):
        if "gate" in snap and int(snap["gate"][0]) == 0:
            dead += 1  # a dead iteration: the kernel returns at once
            continue
        kfn = getattr(kernels, name)
        pfn = getattr(reference, name)
        got = run_claim(torch, kfn, name, snap, kw)
        want = run_claim(torch, pfn, name, snap, kw)
        torch.cuda.synchronize()
        err = 0.0
        for k in want:
            err = max(err, max_abs_err(torch, got[k], want[k]))
        if err != 0.0:
            fail(f"{name} disagrees with its plain version at {label} call {i}: "
                 f"max abs err {err}")
        if not timed or name in out:
            continue
        work = {k: v.clone() for k, v in snap.items()}
        written = [a.name for a in ABI[name].inputs if a.inplace]

        def prep(work=work, written=written, snap=snap):
            for k in written:
                work[k].copy_(snap[k])

        args = claim_args(name, work)
        ms = cuda_time_ms(torch, lambda: kfn(*args, **kw), prep=prep)
        plain_ms = cuda_time_ms(torch, lambda: pfn(*args, **kw), prep=prep)
        t = dict(snap)
        if name != "spec_gate":
            t["plan"] = want["plan"]
        bound_ms, bound_by, moved, ops = claim_bound(name, t, real, kw)
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bytes": moved, "ops": ops,
                     "largest_buffer": max(v.numel() for v in snap.values())}
        floor = ""
        if floors is not None:
            out[name]["floor_ms"] = floor_ms(torch, floors, name, args, kw,
                                             prep=prep)
            floor = f", empty launch {out[name]['floor_ms']:.4f} ms"
        log(f"kernel {name} @ {label} iteration 0: exact; {ms:.4f} ms (plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms by {bound_by}, "
            f"{moved} B, {ops} ops{floor}; largest buffer "
            f"{out[name]['largest_buffer']} elements)")
    if timed:
        report["kernels"][label] = out
    if dead:
        log(f"{label}: {dead} calls of dead iterations returned at once "
            "(not compared: they write nothing)")
    return out


def replay_megaround(torch, label, snap, report):
    """The megaround from its captured starting state, kernels on the card
    against the plain versions on the CPU: claims, counts, need left,
    iterations and the projected node state must be equal. Returns the
    card run's wall time in ms (kernels built, one sync per iteration),
    its iterations, and the wall time of its table setup alone."""
    from nhd_tpu_torch.solver.kernel import _MUTABLE, _pad_pow2, upload_pods
    from nhd_tpu_torch.solver.speculate import run_megaround, spec_iters, spec_tables

    state, bucket_pods, needs, respect_busy, _n = snap
    U = int(state["cpu_free"].shape[1])
    K = int(state["nic_free"].shape[2])
    outs = []
    for dev in (card(torch), torch.device("cpu")):
        node = {k: v.to(dev, copy=True) for k, v in state.items()}
        pods = [upload_pods(p, _pad_pow2(p.n_types), U, K, dev) for p in bucket_pods]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spec_tables(bucket_pods, pods, U, K, int(state["hp_free"].shape[0]), dev)
        torch.cuda.synchronize()
        setup_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        res = run_megaround(node, bucket_pods, pods, needs, U, K, spec_iters(),
                            respect_busy)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        outs.append(([t.cpu() for t in res] + [node[k].cpu() for k in _MUTABLE],
                     ms, setup_ms))
    (got, ms, setup_ms), (want, cpu_ms, _) = outs
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            fail(f"{label}: the megaround on the card and its plain replay differ")
    PLAIN_REPLAYS[label] = want
    its = int(want[3])
    log(f"{label}: megaround replay exact (claims, counts, need left, "
        f"{its} iterations, node state); card {ms:.2f} ms (its table setup "
        f"{setup_ms:.2f} ms, so {(ms - setup_ms) / max(its, 1):.3f} ms an "
        f"iteration), plain on the CPU {cpu_ms:.2f} ms")
    return ms, its, setup_ms


def wide_bucket(torch, dev):
    """A G=3, U=2, K=8 bucket at N=4096 with T=8 types, random from a seed
    (bandwidths on a 0.5 Gbps grid)."""
    import types

    import numpy as np

    from nhd_tpu_torch.policy.classes import MAX_CLASSES
    from nhd_tpu_torch.solver.kernel import to_device, upload_pods

    rng = np.random.default_rng(2026)
    N, U, K, S, T, G = WIDE_N, 2, 8, 16, 8, 3
    nic_count = rng.integers(0, K + 1, (N, U)).astype(np.int32)
    absent = np.arange(K)[None, None, :] >= nic_count[:, :, None]
    nic_free = (rng.integers(0, 200, (N, U, K, 2)) * 0.5).astype(np.float32)
    nic_free[absent] = -1.0
    nic_sw = (np.arange(U)[:, None] * K + np.arange(K)[None, :]).astype(np.int32)
    nic_sw = np.broadcast_to(nic_sw, (N, U, K)).copy()
    nic_sw[absent] = -1
    cluster = types.SimpleNamespace(
        numa_nodes=np.full(N, U, np.int8),
        smt=rng.random(N) < 0.7,
        active=rng.random(N) < 0.95,
        maintenance=rng.random(N) < 0.03,
        busy=rng.random(N) < 0.1,
        gpuless=rng.random(N) < 0.2,
        group_mask=rng.integers(1, 4, N).astype(np.int64),
        hp_free=rng.integers(0, 257, N).astype(np.int32),
        cpu_free=rng.integers(0, 33, (N, U)).astype(np.int32),
        gpu_free=rng.integers(0, 5, (N, U)).astype(np.int32),
        nic_count=nic_count, nic_free=nic_free, nic_sw=nic_sw,
        gpu_free_sw=rng.integers(0, 3, (N, S)).astype(np.int32),
        node_class=rng.integers(0, 3, N).astype(np.int32),
    )
    gpu_dem = rng.integers(0, 2, (T, G)).astype(np.int32)
    pods = types.SimpleNamespace(
        G=G, n_types=T,
        cpu_dem_smt=rng.integers(0, 7, (T, G + 1)).astype(np.int32),
        cpu_dem_raw=rng.integers(0, 9, (T, G + 1)).astype(np.int32),
        gpu_dem=gpu_dem,
        rx=(rng.integers(0, 100, (T, G)) * 0.5).astype(np.float32),
        tx=(rng.integers(0, 60, (T, G)) * 0.5).astype(np.float32),
        hp=rng.integers(0, 9, T).astype(np.int32),
        needs_gpu=gpu_dem.sum(1) > 0,
        map_pci=rng.random(T) < 0.5,
        group_mask=rng.integers(1, 4, T).astype(np.int64),
        class_score=rng.integers(0, 4, (T, MAX_CLASSES)).astype(np.int32),
    )
    from nhd_tpu_torch.solver.kernel import _ARG_ORDER

    node = [to_device(getattr(cluster, n), dev) for n in _ARG_ORDER]
    return node, upload_pods(pods, T, U, K, dev)


def sweep_check(torch, dev, report):
    """Every kernel against its plain version on every edge shape of
    kernels/sweep.py, exactly (the claim kernels each on its own copy of
    the inputs, spec_fill and spec_apply fed the plain plan; spec_fill
    also on the plans and needs of ``FILL_SWEEP``, drawn directly). These
    launches are not the main path's: the counts are reset before each
    timed schedule."""
    import numpy as np

    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.kernels import reference, sweep

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def hold(name, label, args, kw):
        got = getattr(kernels, name)(*args, **kw)
        want = getattr(reference, name)(*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        if err != 0.0:
            fail(f"{name} disagrees with its plain version on sweep shape "
                 f"{label}: max abs err {err}")

    for i, shape in enumerate(sweep.NODE_SWEEP):
        hold("nic_node_masks", f"(N, U, K, S, G, C, A, fill)={shape}",
             [up(a) for a in sweep.node_case(i, *shape)], {})
    for i, shape in enumerate(sweep.NIC_SWEEP):
        args, kw = sweep.nic_case(i, *shape)
        hold("nic_any_first", f"(T, N, U, K, C, A, fill)={shape}",
             [up(a) for a in args], kw)
    for i, shape in enumerate(sweep.PLANE_SWEEP):
        hold("solve_planes", f"(T, N, U, G, C, NCLS, fill)={shape}",
             [up(a) for a in sweep.plane_case(i, *shape)], {})
    for i, shape in enumerate(sweep.SPEC_SWEEP):
        case = sweep.spec_case(i, *shape)
        t = {k: up(v) for k, v in case.items() if isinstance(v, np.ndarray)}
        kw = dict(sharing=case["sharing"], respect_busy=case["respect_busy"])
        calls = [("spec_elect", {k: t[k] for k in sweep.SPEC_ELECT_ARGS}, kw)]
        plan = reference.spec_elect(*(t[k].clone() for k in sweep.SPEC_ELECT_ARGS), **kw)
        status = t["status"].clone()
        status[0] = 0
        calls.append(("spec_fill", {"plan": plan, "status": status,
                                    "gate": t["gate"]}, {}))
        plan = plan.clone()
        reference.spec_fill(plan, status.clone())
        calls.append(("spec_apply", {"plan": plan, **{k: t[k] for k in sweep.SPEC_APPLY_ARGS}},
                      kw))
        check_claims(torch, f"sweep (N, U, K, S, buckets, sharing, busy, fill)={shape}",
                     calls, report, {"N": shape[0]}, timed=False)
    for i, shape in enumerate(sweep.FILL_SWEEP):
        plan, status = (up(a) for a in sweep.fill_case(i, *shape))
        check_claims(torch, f"fill sweep (TT, N, fill)={shape}",
                     [("spec_fill", {"plan": plan, "status": status,
                                     "gate": kernels.live_gate(dev)}, {})],
                     report, {"N": shape[1]}, timed=False)
    for i, shape in enumerate(sweep.GATE_SWEEP):
        case = sweep.gate_case(i, *shape)
        status, offsets, ctl = (up(a) for a in case)
        for cap in sweep.GATE_CAPS:
            check_claims(torch, f"gate sweep (TT, B, fill)={shape}, cap {cap}",
                         [("spec_gate", {"status": status, "offsets": offsets,
                                         "ctl": ctl},
                           {"iters": sweep.gate_iters(case[2], cap)})],
                         report, {}, timed=False)
    for i, shape in enumerate(sweep.RANK_SWEEP):
        case = sweep.rank_case(i, *shape)
        args = [up(case[k]) for k in ("planes", "gpu_free", "cpu_free", "hp_free")]
        gate = kernels.live_gate(dev)
        hold("rank_top", f"(T, N, U, R, S, node_base, fill)={shape}", [*args, gate],
             {"R": case["R"], "node_base": case["node_base"]})
        hold("rank_merge", f"(T, N, U, R, S, node_base, fill)={shape}",
             [up(case["cand"]), gate], {"R": case["merge_R"]})
    report["sweep"] = {
        "nic_node_masks": [list(s) for s in sweep.NODE_SWEEP],
        "nic_any_first": [list(s) for s in sweep.NIC_SWEEP],
        "solve_planes": [list(s) for s in sweep.PLANE_SWEEP],
        "claim_kernels": [repr(s) for s in sweep.SPEC_SWEEP],
        "spec_fill": [list(s) for s in sweep.FILL_SWEEP],
        "spec_gate": [list(s) for s in sweep.GATE_SWEEP],
        "rank": [list(s) for s in sweep.RANK_SWEEP],
    }
    log(f"sweep: nic_node_masks exact on {len(sweep.NODE_SWEEP)} shapes (G in "
        f"{sorted({s[4] for s in sweep.NODE_SWEEP})}, C*A in "
        f"{sorted({s[5] * s[6] for s in sweep.NODE_SWEEP})}, fills "
        f"{sorted({s[7] for s in sweep.NODE_SWEEP})}); nic_any_first exact on "
        f"{len(sweep.NIC_SWEEP)} shapes (A in {sorted({s[5] for s in sweep.NIC_SWEEP})}, "
        f"C in {sorted({s[4] for s in sweep.NIC_SWEEP})}, U*K in "
        f"{sorted({s[2] * s[3] for s in sweep.NIC_SWEEP})}); solve_planes exact "
        f"on {len(sweep.PLANE_SWEEP)} shapes (C in "
        f"{sorted({s[4] for s in sweep.PLANE_SWEEP})}, tied skew, no feasible combo); "
        f"spec_elect, spec_fill, spec_apply exact on {len(sweep.SPEC_SWEEP)} shapes "
        "(1-3 buckets, N in "
        f"{sorted({s[0] for s in sweep.SPEC_SWEEP})}, type rows in "
        f"{sorted({sum(b[0] for b in s[4]) for s in sweep.SPEC_SWEEP})}, U*K in "
        f"{sorted({s[1] * s[2] for s in sweep.SPEC_SWEEP})}, both NIC-sharing branches, "
        f"both busy rules, fills {sorted({s[7] for s in sweep.SPEC_SWEEP})}); "
        f"spec_fill exact on {len(sweep.FILL_SWEEP)} fill shapes (TT in "
        f"{sorted({s[0] for s in sweep.FILL_SWEEP})}, N in "
        f"{sorted({s[1] for s in sweep.FILL_SWEEP})}, fills "
        f"{sorted({s[2] for s in sweep.FILL_SWEEP})}); spec_gate exact on "
        f"{len(sweep.GATE_SWEEP)} shapes at caps {list(sweep.GATE_CAPS)} (TT in "
        f"{sorted({s[0] for s in sweep.GATE_SWEEP})}, B in "
        f"{sorted({s[1] for s in sweep.GATE_SWEEP})}, fills "
        f"{sorted({s[2] for s in sweep.GATE_SWEEP})}); rank_top and rank_merge "
        f"exact on {len(sweep.RANK_SWEEP)} shapes (N in "
        f"{sorted({s[1] for s in sweep.RANK_SWEEP})}, R in "
        f"{sorted({s[3] for s in sweep.RANK_SWEEP})}, shards "
        f"{sorted({s[4] for s in sweep.RANK_SWEEP})}, fills "
        f"{sorted({s[6] for s in sweep.RANK_SWEEP})})")


def oracle_check(dev):
    """The CUDA matcher against the serial oracle on a small input."""
    import random

    from nhd_tpu_torch.core.request import CpuRequest, GroupRequest, PodRequest
    from nhd_tpu_torch.core.topology import MapMode, SmtMode
    from nhd_tpu_torch.sim import SynthNodeSpec, make_node
    from nhd_tpu_torch.solver.matcher import find_nodes
    from nhd_tpu_torch.solver.oracle import find_node

    rng = random.Random(11)
    nodes = {}
    for i in range(12):
        spec = SynthNodeSpec(
            name=f"node{i:03d}", phys_cores=rng.choice([8, 12, 16]),
            nics_per_numa=rng.choice([1, 2, 3]),
            gpus_per_numa=rng.choice([0, 1, 2]),
            groups=rng.choice(["default", "edge"]),
        )
        node = make_node(spec)
        for core in node.cores:
            if rng.random() < 0.2:
                core.used = True
        nodes[node.name] = node
    reqs = []
    for _ in range(24):
        groups = tuple(
            GroupRequest(
                proc=CpuRequest(rng.randint(2, 5), SmtMode.ON),
                misc=CpuRequest(rng.randint(0, 1), SmtMode.ON),
                gpus=rng.choice([0, 1]), nic_rx_gbps=rng.choice([0.0, 5.0, 20.0]),
                nic_tx_gbps=rng.choice([0.0, 5.0]),
            )
            for _ in range(rng.choice([1, 2, 3]))
        )
        reqs.append(PodRequest(
            groups=groups, misc=CpuRequest(1, SmtMode.ON),
            hugepages_gb=rng.choice([0, 4]),
            map_mode=rng.choice([MapMode.NUMA, MapMode.PCI]),
            node_groups=frozenset({rng.choice(["default", "edge"])}),
        ))
    got = find_nodes(nodes, reqs, now=0.0, device=dev)
    placed = 0
    for r, g in zip(reqs, got):
        want = find_node(nodes, r, now=0.0)
        if (want is None) != (g is None) or (
            want is not None and (want.node, dict(want.mapping))
            != (g.node, dict(g.mapping))
        ):
            fail(f"CUDA matcher disagrees with the oracle: {want} vs {g}")
        placed += g is not None
    if placed == 0:
        fail("oracle check placed nothing")
    log(f"oracle check: {len(reqs)} requests on 12 nodes, CUDA matcher == "
        f"serial oracle ({placed} placeable)")


@contextlib.contextmanager
def env(**values):
    """Environment knobs set for the duration (None: unset)."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def profile_schedule(torch, sched, nodes, items, speculative):
    """One more schedule of the same batch (allocation state reset) under
    torch.profiler (device_profile). Runs after the counted run, so its
    launches are not counted."""
    for n in nodes.values():
        n.reset_resources()
    with env(NHD_TPU_SPECULATE=None if speculative else "0"):
        return device_profile(
            torch, lambda: sched.schedule(nodes, items, now=0.0))


def device_profile(torch, fn):
    """*fn* once under torch.profiler: device busy time (sum of kernel and
    copy time on the card) against the wall, and the largest device and
    host entries."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    from torch.autograd import DeviceType

    # device-side activity (kernels, copies, memsets), one stream: the sum
    # of their spans is the busy time
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _ in by_name.values())
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    top_dev = ops[:6]
    top_host = sorted(
        prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True
    )[:5]
    return {
        "wall_s": wall, "device_busy_s": busy_us / 1e6,
        "idle_share": 1.0 - busy_us / 1e6 / wall if busy_us else None,
        "top_device": [(k[:60], round(us, 1), n) for k, (us, n) in top_dev],
        "device_ops": [(k[:120], us, n) for k, (us, n) in ops],
        "top_host": [(e.key, round(e.self_cpu_time_total, 1), e.count)
                     for e in top_host],
    }


#: profiler name fragments of a classic round's device work, in order: the
#: three solve kernels, the rank kernels, then the eager chain the rank was
#: before them (torch.topk, the gathers and indexing, the free-total sums,
#: the stack), so a share stays comparable across the two
RANK_GROUPS = (
    ("nic_node_masks", ("nic_node_masks",)),
    ("nic_any_first", ("nic_any_first",)),
    ("solve_planes", ("solve_planes",)),
    ("rank_top", ("rank_top",)),
    ("rank_merge", ("rank_merge",)),
    ("topk", ("topk", "sort", "radix", "bitonic")),
    ("row update", ("index_copy",)),
    ("gather", ("scatter_gather", "gather")),
    ("index", ("index",)),
    ("sum", ("reduce",)),
    ("stack", ("cat",)),
    ("copy", ("memcpy", "memset", "copy", "elementwise")),
)
RANK_CHAIN = ("rank_top", "rank_merge", "topk", "gather", "index", "sum", "stack")


def rank_attribution(name, profile):
    """The device time of one classic schedule by op group (``RANK_GROUPS``)
    and the share the rank (``RANK_CHAIN``) holds of the busy time."""
    groups = {}
    for op, us, n in profile["device_ops"]:
        low = op.lower()
        g = next((k for k, frags in RANK_GROUPS if any(f in low for f in frags)),
                 "other")
        t_us, t_n = groups.get(g, (0.0, 0))
        groups[g] = (t_us + us, t_n + n)
    busy = sum(us for us, _ in groups.values())
    share = sum(groups.get(g, (0.0, 0))[0] for g in RANK_CHAIN) / busy if busy else None
    log(f"{name} device time by op (us, launches): " + "; ".join(
        f"{g} {us:.1f} ({n})" for g, (us, n) in groups.items())
        + f"; the rank {share if share is None else round(share, 4)} of "
        f"{busy:.1f} us busy; every op: {profile['device_ops']}")
    return {"groups_us": groups, "rank_share": share, "busy_us": busy}


def run_cell(torch, name, cluster_fn, report, launches_total, *, speculative):
    """Phases 4-6: warm + timed schedule on CUDA (speculation as the card's
    default has it, or off), then the CPU run with speculation set the same
    way, then the captured schedule and every kernel against its plain
    version on its inputs."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.sim.workloads import workload_mix
    from nhd_tpu_torch.solver import BatchItem, BatchScheduler

    reqs = workload_mix(CELL_PODS, GROUPS)
    items = [BatchItem(("ns", f"p{i}"), r) for i, r in enumerate(reqs)]
    nodes = cluster_fn(CELL_NODES, GROUPS)
    sched = BatchScheduler(device=card(torch), respect_busy=False, register_pods=False)
    with env(NHD_TPU_SPECULATE=None if speculative else "0"):
        sched.schedule(nodes, items, now=0.0)  # warm: builds, caches, allocator
        for n in nodes.values():
            n.reset_resources()
        torch.cuda.synchronize()
        kernels.reset_launches()
        ranked0 = ranked_uses()
        t0 = time.perf_counter()
        results, stats = sched.schedule(nodes, items, now=0.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        launches[RANKED] = ranked_uses() - ranked0
    # the speculative path: the megaround's kernels, and rank_top only if
    # a classic round followed it (cfg4 and cfg3 place or certify every
    # pod in the megaround); the classic path: the solve kernels and
    # rank_top in every round
    require_launched(name, launches, SPEC_PATH if speculative else
                     kernels.SOLVE_KERNELS + ("rank_top",))
    # one rank_top a classic dispatch, and no merge on one device
    if (launches["rank_top"], launches["rank_merge"]) != (launches[RANKED], 0):
        fail(f"{name}: rank_top launched {launches['rank_top']} times and "
             f"rank_merge {launches['rank_merge']} for {launches[RANKED]} "
             "classic rank dispatches")
    add_launches(launches_total, launches)
    spec_it = stats.counters.get("spec_iterations", 0)
    if speculative and not spec_it:
        fail(f"{name}: the card's default did not run the speculative round 0")
    if speculative:
        # round 0 is one replay: spec_gate before the WHILE node, then the
        # body's gate and claim kernels once a pass, one pass an iteration
        want = {kernels.GRAPH: 1, kernels.GATE_KERNEL: 1 + spec_it,
                **{k: spec_it for k in kernels.CLAIM_KERNELS}}
        got = {k: launches[k] for k in want}
        if got != want:
            fail(f"{name}: the megaround was not one graph replay of "
                 f"{spec_it} passes: {got}")
    elif launches[kernels.GRAPH]:
        fail(f"{name}: NHD_TPU_SPECULATE=0 replayed a megaround graph")
    if not speculative and spec_it:
        fail(f"{name}: NHD_TPU_SPECULATE=0 still ran the megaround")
    placed = sum(1 for r in results if r.node)
    p99 = stats.bind_latency_percentile(results, 99)
    phases = " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in sorted(stats.phases.items()))
    spec_ms = stats.phases.get("spec_dispatch", 0.0) * 1e3
    log(f"{name} cuda: placed {placed}/{len(items)} rounds={stats.rounds} "
        f"megaround iterations={spec_it} megaround={spec_ms:.2f}ms "
        f"claims_r0={stats.counters.get('claims_r0', 0)} "
        f"rejects_r0={stats.counters.get('rejects_r0', 0)} "
        f"certified={stats.counters.get('certified_unschedulable', 0)} "
        f"wall={wall:.4f}s ({placed / wall:.0f} pods/s) p99_bind={p99 * 1e3:.1f}ms "
        f"solve={stats.solve_seconds:.4f}s select={stats.select_seconds:.4f}s "
        f"assign={stats.assign_seconds:.4f}s launches={launches}")
    log(f"{name} phases: {phases}")

    t1 = time.perf_counter()
    with env(NHD_TPU_SPECULATE="1" if speculative else "0"):
        cpu_res, cpu_stats = BatchScheduler(
            device="cpu", respect_busy=False, register_pods=False
        ).schedule(cluster_fn(CELL_NODES, GROUPS), items, now=0.0)
    cpu_wall = time.perf_counter() - t1
    same_placements(name, results, cpu_res, "the CPU run")
    RESULTS[name] = (results, cpu_res)
    if placed == 0:
        fail(f"{name}: nothing placed")
    if (cpu_stats.rounds, cpu_stats.counters.get("spec_iterations", 0)) != (
            stats.rounds, spec_it):
        fail(f"{name}: rounds or megaround iterations differ on cuda and cpu")
    log(f"{name} cpu: placed {sum(1 for r in cpu_res if r.node)} "
        f"rounds={cpu_stats.rounds} megaround iterations="
        f"{cpu_stats.counters.get('spec_iterations', 0)} wall={cpu_wall:.4f}s; "
        "every pod's node, mapping and NICs identical to the cuda run")

    # every solve and claim-kernel call of the batch: each kernel against
    # its plain version at this cell's shapes and states
    with env(NHD_TPU_SPECULATE=None if speculative else "0"):
        again, _, cap = capture_schedule(torch, sched, nodes, items)
    if [(r.node, r.nic_list) for r in again] != [(r.node, r.nic_list) for r in results]:
        fail(f"{name}: a second cuda schedule of the batch placed differently")
    for i, (G, real, node, pod, R) in enumerate(cap.solves):
        check_kernels(torch, f"{name} solve {i} G={G} T={real['T']}",
                      node, pod, report, real, timed=False, R=R)
    ranked = sum(1 for s in cap.solves if s[4] is not None)
    log(f"{name} kernels vs plain: all {len(cap.solves)} solves of the batch "
        f"(buckets {sorted({s[0] for s in cap.solves})}, every round and live "
        f"megaround bucket; with the {cap.dead_solves} gated ones as many as the "
        f"solve kernels' launches) and the rank_top of its {ranked} classic "
        "solves, exact")
    cell = {}
    if speculative:
        if not cap.megarounds or not cap.claims:
            fail(f"{name}: the captured schedule ran no megaround")
        real = {"N": cap.megarounds[0][4]}
        check_claims(torch, f"{name} megaround", cap.claims, report, real, timed=True)
        its = sum(1 for c in cap.claims if c[0] == kernels.GATE_KERNEL) - 1
        log(f"{name} claim kernels and spec_gate vs plain: all {len(cap.claims)} "
            f"calls ({its} iterations of the fixed trip, each closed by its gate, "
            f"{cap.dead_solves} solves of dead buckets or iterations), exact")
        SNAPS[name] = cap.megarounds[0]
        replays = [replay_megaround(torch, f"{name} megaround {i}", snap, report)
                   for i, snap in enumerate(cap.megarounds)]
        cell["megaround_replay_ms"] = [ms for ms, _, _ in replays]
        cell["megaround_iterations"] = [it for _, it, _ in replays]
        cell["megaround_setup_ms"] = [ms for _, _, ms in replays]
    del cap
    profile = profile_schedule(torch, sched, nodes, items, speculative)
    idle = profile["idle_share"]
    log(f"{name} profile: wall={profile['wall_s']:.4f}s device_busy="
        f"{profile['device_busy_s']:.6f}s idle_share="
        f"{'not measured' if idle is None else f'{idle:.4f}'}; "
        f"top device: {profile['top_device']}; top host: {profile['top_host']}")
    if not speculative:
        cell["rank_attribution"] = rank_attribution(name, profile)
    cell.update({
        "profile": profile, "speculative": speculative,
        "placed": placed, "pods": len(items), "rounds": stats.rounds,
        "megaround_iterations_run": spec_it, "megaround_ms": spec_ms,
        "wall_s": wall, "pods_per_s": placed / wall, "p99_bind_s": p99,
        "solve_s": stats.solve_seconds, "select_s": stats.select_seconds,
        "assign_s": stats.assign_seconds, "phases_s": stats.phases,
        "counters": stats.counters, "launches": launches,
        "cpu_wall_s": cpu_wall, "cpu_rounds": cpu_stats.rounds,
    })
    report["cells"][name] = cell
    return placed


def pod_outcome(backend):
    """Each pod's (node, solved config, NAD) on a fake backend."""
    from nhd_tpu_torch.k8s.interface import CFG_ANNOTATION, NAD_ANNOTATION

    return {key: (p.node, p.annotations.get(CFG_ANNOTATION),
                  p.annotations.get(NAD_ANNOTATION))
            for key, p in sorted(backend.pods.items())}


def cfg4_daemon(device, n_pods, n_nodes, node_class=None):
    """cfg4's pending set (sim/pending.py; with *node_class*, each node in
    its class) on a fresh fake backend, and the port's Scheduler on
    *device* over it. Returns (backend, scheduler)."""
    import queue

    import nhd_tpu_torch.sim as sim
    from nhd_tpu_torch.k8s.fake import FakeClusterBackend
    from nhd_tpu_torch.scheduler import core
    from nhd_tpu_torch.scheduler.events import WatchQueue
    from nhd_tpu_torch.sim import pending

    backend = FakeClusterBackend()
    pending.fill_cfg4(backend, sim, n_nodes, n_pods, node_class=node_class)
    return backend, core.Scheduler(backend, WatchQueue(), queue.Queue(),
                                   respect_busy=False, device=device)


def _daemon_run(device, n_pods, n_nodes=DAEMON_NODES, tile=None):
    """cfg4's pending set driven through the port's Scheduler on *device*
    by its normal turn (``cfg4_daemon``; with *tile*, the streaming tile
    the daemon uses past NHD_STREAM_NODES). Returns the drive's numbers
    and each pod's (node, solved config, NAD)."""
    from nhd_tpu_torch.scheduler import core
    from nhd_tpu_torch.sim import pending

    backend, sched = cfg4_daemon(device, n_pods, n_nodes)
    saved = core.STREAM_TILE_NODES
    core.STREAM_TILE_NODES = tile or saved
    try:
        got = pending.drive(sched)
    finally:
        core.STREAM_TILE_NODES = saved
    got["streamed"] = sched._stream is not None
    got["tile_nodes"] = (sched._stream.tile_nodes if got["streamed"] else None)
    got["batch_s"] = sum(sched.perf[k] for k in (
        "solve_seconds_total", "select_seconds_total", "assign_seconds_total"))
    return got, pod_outcome(backend)


def daemon_phase(torch, report, launches_total, smi):
    """Phase 7: cfg4's pending set through the port's daemon on the card
    (counts set to 0 just before, read just after; every kernel must
    launch), then the same scenario on the CPU with speculation on, as
    the card's default has it: every pod's node and solved config the
    same, the same bound count, and the guard at full fidelity with no
    fault, retry or degrade."""
    from nhd_tpu_torch.k8s.retry import API_COUNTERS
    from nhd_tpu_torch.obs import histo
    from nhd_tpu_torch.solver.guard import GUARD, RUNG_MESH, RUNG_NAMES

    base = API_COUNTERS.snapshot()
    # the daemon's own bind latency (batch admission to bound, per pod)
    bind_h = histo.HISTOGRAMS["bind_latency_seconds"]
    bind_h.reset()
    got, _wall, launches = counted(
        torch, lambda: _daemon_run(card(torch), DAEMON_PODS))
    got, outcome = got
    DAEMON_OUTCOME.update(outcome)
    cum, _sum, _count = bind_h.snapshot()
    edges = list(zip((*bind_h.buckets, float("inf")), cum))
    bind_ms = {f"p{int(q * 100)}": histo.quantile_from_buckets(edges, q) * 1e3
               for q in (0.5, 0.99)}
    # speculative batches; rank_top where a batch's megaround left pods
    # to a classic round
    require_launched("daemon", launches, SPEC_PATH)
    add_launches(launches_total, launches)
    now = API_COUNTERS.snapshot()
    moved = {k: now[k] - base[k] for k in (
        "guard_faults_total", "guard_retries_total", "guard_degradations_total")}
    if GUARD.floor != RUNG_MESH or any(moved.values()):
        fail(f"daemon: guard left full fidelity (floor {RUNG_NAMES[GUARD.floor]}, "
             f"{moved})")
    rate = got["bound"] / got["wall"]
    log(f"daemon cuda: {DAEMON_NODES} nodes, {DAEMON_PODS} pending pods "
        f"(cut: {DAEMON_CUT or 'none'}); bound {got['bound']} in "
        f"{got['turns']} turns, wall={got['wall']:.4f}s ({rate:.0f} binds/s), "
        f"of which the batches (solve, select, assign) {got['batch_s']:.4f}s; "
        f"bind latency (histogram) p50={bind_ms['p50']:.1f}ms "
        f"p99={bind_ms['p99']:.1f}ms; guard rung {RUNG_NAMES[GUARD.floor]}, {moved}; launches={launches}; "
        f"{smi}")
    t0 = time.perf_counter()
    # the card's default runs the speculative round 0; the CPU run is
    # asked for it, so both take the same rounds
    with env(NHD_TPU_SPECULATE="1"):
        cpu_got, cpu_outcome = _daemon_run("cpu", DAEMON_PODS)
    cpu_wall = time.perf_counter() - t0
    diff = [k for k in outcome if outcome[k] != cpu_outcome.get(k)]
    if diff or cpu_got["bound"] != got["bound"]:
        fail(f"daemon: {len(diff)} pods bound differently on cuda and cpu "
             f"(first: {diff[:1]}), bound {got['bound']} vs {cpu_got['bound']}")
    if got["bound"] == 0:
        fail("daemon: nothing bound")
    log(f"daemon cpu: bound {cpu_got['bound']} in {cpu_got['turns']} turns, "
        f"wall={cpu_got['wall']:.4f}s (whole run {cpu_wall:.2f}s); every pod's "
        "node, solved config and NAD identical to the cuda run")
    # once more on the card under the profiler (not counted): the device's
    # busy time against the daemon's wall
    profile = device_profile(
        torch, lambda: _daemon_run(card(torch), DAEMON_PODS))
    log(f"daemon profile: wall={profile['wall_s']:.4f}s (fill, inventory and "
        f"scans) device_busy={profile['device_busy_s']:.6f}s idle_share="
        f"{profile['idle_share']}; top device: {profile['top_device'][:3]}")
    report["daemon"] = {
        "nodes": DAEMON_NODES, "pods": DAEMON_PODS, "cut": DAEMON_CUT,
        "bound": got["bound"], "turns": got["turns"], "wall_s": got["wall"],
        "batch_s": got["batch_s"], "binds_per_s": rate, "launches": launches,
        "bind_latency_ms": bind_ms,
        "guard": moved, "cpu_wall_s": cpu_got["wall"], "profile": profile,
        "smi": smi,
    }


def fed_items(n, key="ns"):
    from nhd_tpu_torch.sim.workloads import workload_mix
    from nhd_tpu_torch.solver import BatchItem

    return [BatchItem((key, f"p{i}"), r)
            for i, r in enumerate(workload_mix(n, FED_GROUPS))]


def fed_nodes(n=None):
    from nhd_tpu_torch.sim.workloads import cap_cluster

    return cap_cluster(FED_NODES if n is None else n, FED_GROUPS)


def streamer(device, tile):
    """The tiler as bench.py run_stream drives it on an accelerator."""
    from nhd_tpu_torch.solver import StreamingScheduler

    return StreamingScheduler(device=device, tile_nodes=tile,
                              chunk_pods=FED_CHUNK, placement="routed",
                              respect_busy=False, register_pods=False)


@contextlib.contextmanager
def spans(stream_sched):
    """Wrap a StreamingScheduler's tile sub-calls, tile context builds and
    chunk encodes for the duration. Yields the dict they fill: "calls",
    one (thread, what that thread launched during the sub-call, wall s)
    per sub-call; "contexts" and "encodes", the wall of each build and
    each chunk encode."""
    import threading

    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.solver import encode

    got = {"calls": [], "contexts": [], "encodes": []}
    batch = stream_sched.batch
    sub, make, enc = batch.schedule, batch.make_context, encode.encode_pods

    def timed(fn, key):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                got[key].append(time.perf_counter() - t0)
        return run

    def spy(*args, **kw):
        before = kernels.thread_launches()
        t0 = time.perf_counter()
        try:
            return sub(*args, **kw)
        finally:
            after = kernels.thread_launches()
            got["calls"].append((threading.get_ident(),
                                 {n: after[n] - before[n] for n in kernels.COUNTED},
                                 time.perf_counter() - t0))

    batch.schedule, batch.make_context = spy, timed(make, "contexts")
    encode.encode_pods = timed(enc, "encodes")
    try:
        yield got
    finally:
        del batch.schedule, batch.make_context
        encode.encode_pods = enc


def wall_split(wall, got):
    """Where a tiler run's wall went, from ``spans``: the tile context
    builds, the chunk encodes, the sub-calls (summed over threads) and the
    tiler's own host work (the rest of a one-tile run)."""
    ctx, enc = sum(got["contexts"]), sum(got["encodes"])
    calls = sum(w for _t, _c, w in got["calls"])
    return {"context_build_s": ctx, "chunk_encode_s": enc, "subcalls_s": calls,
            "tiler_rest_s": wall - ctx - enc - calls}


def placed_as(results):
    return [(r.node, None if r.mapping is None else dict(r.mapping), r.nic_list)
            for r in results]


def same_placements(label, got, want, what):
    got, want = placed_as(got), placed_as(want)
    diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if diff or len(got) != len(want):
        i = diff[0] if diff else None
        fail(f"{label}: {len(diff)} pods placed differently from {what} "
             f"(first: {None if i is None else (got[i], want[i])})")


def counted(torch, fn):
    """(fn's result, wall seconds, launches) with the counts set to 0 just
    before and read just after; the launches carry the run's classic rank
    dispatches under ``RANKED`` (those since the jit stats' last reset if
    *fn* reset them)."""
    from nhd_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    ranked0 = ranked_uses()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    ranked = ranked_uses()
    launches[RANKED] = ranked - ranked0 if ranked >= ranked0 else ranked
    return out, wall, launches


def stream_phase(torch, report, launches_total, smi):
    """Phase 9: cfg5 through the streaming tiler on the card (module
    docstring, parts a-e)."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.solver import BatchScheduler

    dev = card(torch)
    out = {"pods": FED_PODS, "nodes": FED_NODES, "smi": smi}
    items = fed_items(FED_PODS)

    def launched_all(label, launches):
        # speculative tiles; rank_top where a tile took a classic round
        require_launched(label, launches, SPEC_PATH)
        add_launches(launches_total, launches)

    def summary(label, res, stats, wall, launches):
        placed = sum(1 for r in res if r.node)
        p99 = stats.bind_latency_percentile(res, 99)
        phases = " ".join(f"{k}={v:.3f}s" for k, v in sorted(stats.phases.items()))
        log(f"{label}: placed {placed}/{len(res)} wall={wall:.4f}s "
            f"({placed / wall:.0f} pods/s) p99_bind={p99:.4f}s rounds={stats.rounds} "
            f"megaround iterations={stats.counters.get('spec_iterations', 0)} "
            f"launches={launches}; phases: {phases}")
        return {"placed": placed, "wall_s": wall, "pods_per_s": placed / wall,
                "p99_bind_s": p99, "rounds": stats.rounds,
                "megaround_iterations": stats.counters.get("spec_iterations", 0),
                "phases_s": stats.phases, "counters": stats.counters,
                "launches": launches}

    # (a) one 16,384-node tile, as run_stream drives an accelerator
    t0 = time.perf_counter()
    nodes = fed_nodes()
    build_s = time.perf_counter() - t0
    streamer(dev, FED_TILE).schedule(fed_nodes(), fed_items(FED_WARM_PODS, "w"),
                                     now=0.0)
    sched = streamer(dev, FED_TILE)
    with spans(sched) as got_a:
        (res, stats), wall, launches = counted(
            torch, lambda: sched.schedule(nodes, items, now=0.0))
    launched_all("cfg5 (a)", launches)
    a = summary(f"cfg5 (a) cuda, tile {FED_TILE}, {FED_NODES} nodes "
                f"(cluster built in {build_s:.1f}s)", res, stats, wall, launches)
    if a["placed"] != FED_PODS:
        fail(f"cfg5 is capacity-matched: placed {a['placed']}/{FED_PODS}")
    a["split_s"] = wall_split(wall, got_a)
    log("cfg5 (a) wall split: " + " ".join(
        f"{k}={v:.4f}" for k, v in a["split_s"].items()))
    t0 = time.perf_counter()
    with env(NHD_TPU_SPECULATE="1"):
        cpu_res, cpu_stats = streamer("cpu", FED_TILE).schedule(
            fed_nodes(), items, now=0.0)
    a["cpu_wall_s"] = time.perf_counter() - t0
    same_placements("cfg5 (a)", res, cpu_res, "the CPU run")
    del cpu_res
    (ub_res, ub_stats), a["untiled_wall_s"], _ = counted(
        torch, lambda: BatchScheduler(device=dev, respect_busy=False,
                                      register_pods=False).schedule(
            fed_nodes(), items, now=0.0))
    same_placements("cfg5 (a)", res, ub_res, "the untiled BatchScheduler on cuda")
    del ub_res
    log(f"cfg5 (a): every pod's node, mapping and NICs identical on cuda, on the "
        f"CPU (speculation on; {a['cpu_wall_s']:.2f}s with the cluster build) and "
        f"through the untiled BatchScheduler on cuda ({a['untiled_wall_s']:.2f}s "
        f"with the cluster build); {smi}")
    out["a"] = a

    # (b) three tiles, three workers launching on the card
    rem = FED_NODES % FED_SPLIT_TILE
    streamer(dev, FED_SPLIT_TILE).schedule(
        fed_nodes(FED_SPLIT_TILE + rem), fed_items(FED_WARM_PODS, "w"), now=0.0)
    split = streamer(dev, FED_SPLIT_TILE)
    nodes_b = fed_nodes()
    with spans(split) as got_b:
        (res_b, stats_b), wall_b, launches_b = counted(
            torch, lambda: split.schedule(nodes_b, items, now=0.0))
    del nodes_b
    launched_all("cfg5 (b)", launches_b)
    calls = got_b["calls"]
    summed = {k: sum(c[k] for _t, c, _w in calls) for k in kernels.COUNTED}
    if summed != {k: launches_b[k] for k in kernels.COUNTED}:
        fail(f"cfg5 (b): launch counts {launches_b} differ from the sum over "
             f"the tile sub-calls {summed}")
    threads = len({t for t, c, _w in calls if any(c.values())})
    if threads < 2:
        fail(f"cfg5 (b): the tiles launched from {threads} thread(s)")
    b = summary(f"cfg5 (b) cuda, tile {FED_SPLIT_TILE} ({-(-FED_NODES // FED_SPLIT_TILE)} "
                f"tiles)", res_b, stats_b, wall_b, launches_b)
    b["split_s"] = wall_split(wall_b, got_b)
    b["subcall_s"] = [w for _t, _c, w in calls]
    log("cfg5 (b) spans (summed over threads): " + " ".join(
        f"{k}={v:.4f}" for k, v in b["split_s"].items() if k != "tiler_rest_s")
        + f"; sub-calls {[round(w, 4) for w in b['subcall_s']]}s")
    t0 = time.perf_counter()
    with env(NHD_TPU_SPECULATE="1"):
        cpu_b, _ = streamer("cpu", FED_SPLIT_TILE).schedule(fed_nodes(), items, now=0.0)
    b["cpu_wall_s"] = time.perf_counter() - t0
    same_placements("cfg5 (b)", res_b, cpu_b, "the CPU run of the same tiling")
    del cpu_b, res_b
    b.update({"subcalls": len(calls), "threads": threads})
    log(f"cfg5 (b): {len(calls)} tile sub-calls on {threads} threads launched "
        f"{summed} in all, equal to the counts; placements identical to the CPU "
        f"run; walls: cuda {wall_b:.4f}s (one tile: {wall:.4f}s), cpu "
        f"{b['cpu_wall_s']:.2f}s with the cluster build; {smi}")
    out["b"] = b

    # (c) every kernel at the tile's size, on (a)'s own inputs
    floors = build_floors()
    again, _, cap = capture_schedule(torch, sched, nodes, items)
    same_placements("cfg5 (c)", again, res, "the counted cuda run")
    del again
    timed_g = set()
    for i, (G, real, node, pod, R) in enumerate(cap.solves):
        first = G not in timed_g
        timed_g.add(G)
        check_kernels(torch, f"cfg5 solve {i} G={G} T={real['T']} N={real['N']} "
                      f"(Np={node[0].shape[0]})", node, pod, report, real,
                      timed=first, floors=floors if first else None, R=R)
    if all(s[4] is None for s in cap.solves):
        # every pod placed in the megaround: rank_top timed on the tile's
        # first solve at the accelerator's rank width all the same
        from nhd_tpu_torch.kernels import reference
        from nhd_tpu_torch.solver import kernel as kernel_mod

        G, real, node, pod, _ = cap.solves[0]
        a = dict(zip(kernel_mod._ARG_ORDER, node))
        planes = reference.solve_planes(
            *stage(kernel_mod, reference, node, pod)["solve_planes"][0])
        report["kernels"]["cfg5 rank_top"], _ = check_rank(
            torch, f"cfg5 tile G={G} T={real['T']} N={real['N']} "
            f"(Np={node[0].shape[0]}; no classic round)", "rank_top",
            (planes, a["gpu_free"], a["cpu_free"], a["hp_free"],
             kernels.live_gate(planes.device)),
            {"R": min(kernel_mod.rank_cap(True), planes.shape[2])}, real,
            timed=True, floors=floors)
    real = {"N": cap.megarounds[0][4]}
    check_claims(torch, "cfg5 megaround", cap.claims, report, real, timed=True,
                 floors=floors)
    SNAPS["cfg5:100kx10k-stream tile"] = cap.megarounds[0]
    log(f"cfg5 (c) kernels vs plain: all {len(cap.solves)} solves and "
        f"{len(cap.claims)} claim-kernel calls of the batch, exact")
    out["c"] = {"solves": len(cap.solves), "claim_calls": len(cap.claims)}
    del cap

    # (d) the daemon past NHD_STREAM_NODES
    (got, outcome), _wall, launches_d = counted(
        torch, lambda: _daemon_run(dev, STREAM_DAEMON_PODS, STREAM_DAEMON_NODES))
    if not got["streamed"]:
        fail("cfg5 (d): the daemon did not build its streaming tiler")
    launched_all("cfg5 (d)", launches_d)
    with env(NHD_TPU_SPECULATE="1"):
        cpu_got, cpu_outcome = _daemon_run("cpu", STREAM_DAEMON_PODS,
                                           STREAM_DAEMON_NODES, got["tile_nodes"])
    diff = [k for k in outcome if outcome[k] != cpu_outcome.get(k)]
    if diff or cpu_got["bound"] != got["bound"] or not got["bound"]:
        fail(f"cfg5 (d): {len(diff)} pods bound differently on cuda and cpu "
             f"(first: {diff[:1]}), bound {got['bound']} vs {cpu_got['bound']}")
    log(f"cfg5 (d) daemon: {STREAM_DAEMON_NODES} cfg4 nodes, {STREAM_DAEMON_PODS} "
        f"pending pods ({STREAM_DAEMON_CUT}); streaming tiler engaged (tile "
        f"{got['tile_nodes']}), bound {got['bound']} in {got['turns']} turns, "
        f"wall={got['wall']:.4f}s, batches {got['batch_s']:.4f}s, "
        f"launches={launches_d}; every pod's node, solved config and NAD "
        f"identical to the cpu run (wall {cpu_got['wall']:.4f}s); {smi}")
    out["d"] = {"bound": got["bound"], "turns": got["turns"], "wall_s": got["wall"],
                "batch_s": got["batch_s"], "launches": launches_d,
                "cpu_wall_s": cpu_got["wall"], "cut": STREAM_DAEMON_CUT}

    # (e) (a) once more under the profiler, not counted
    for n in nodes.values():
        n.reset_resources()
    profile = device_profile(torch, lambda: streamer(dev, FED_TILE).schedule(
        nodes, items, now=0.0))
    log(f"cfg5 (e) profile: wall={profile['wall_s']:.4f}s device_busy="
        f"{profile['device_busy_s']:.6f}s idle_share={profile['idle_share']}; "
        f"top device: {profile['top_device']}; top host: {profile['top_host']}")
    out["e"] = profile
    report["stream"] = out


class _DispatchFault:
    """Raise InjectedDeviceFault at the first *n* calls at *site*."""

    def __init__(self, n, site="dispatch"):
        self.left, self.site = n, site

    def __call__(self, site, detail=""):
        from nhd_tpu_torch.solver.guard import InjectedDeviceFault

        if site == self.site and self.left > 0:
            self.left -= 1
            raise InjectedDeviceFault(f"injected at {site} ({detail})")


def guard_phase(torch, report, smi):
    """Phase 8: the solver guard on the card. A full audit of cfg4's
    resident state after a schedule must find nothing; the budgeted
    batch-start audit (NHD_GUARD_AUDIT_ROWS=16) is timed; one injected
    dispatch fault in a classic cfg4 schedule must retry once and place
    every pod as the fault-free run, floor unmoved; with
    NHD_GUARD_RETRIES=1 the same fault drops to the non-resident rung,
    which still launches the kernels on the card and places the same;
    then the wall per round with the guard on against NHD_GUARD=0."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.k8s.retry import API_COUNTERS
    from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
    from nhd_tpu_torch.solver import BatchItem, BatchScheduler, guard
    from nhd_tpu_torch.solver.encode import ClusterDelta
    from nhd_tpu_torch.solver.guard import GUARD, RUNG_HOST, RUNG_MESH, RUNG_NAMES

    items = [BatchItem(("ns", f"p{i}"), r)
             for i, r in enumerate(workload_mix(CELL_PODS, GROUPS))]
    out = {}

    # the full audit and the budgeted one, after a schedule
    nodes = cap_cluster(CELL_NODES, GROUPS)
    sched = BatchScheduler(device=card(torch), respect_busy=False,
                           register_pods=False)
    ctx = sched.make_context(
        nodes, now=0.0, delta=ClusterDelta(nodes, now=0.0, respect_busy=False))
    sched.schedule(ctx.nodes, items, context=ctx)
    ctx.dev._flush_staged()
    t0 = time.perf_counter()
    errs = guard.audit_device_rows(ctx.dev, range(ctx.dev.N))
    full_ms = (time.perf_counter() - t0) * 1e3
    if errs:
        fail(f"guard: the full audit of cfg4's resident state found {errs[:2]}")
    with env(NHD_GUARD_AUDIT_ROWS="16"):
        budget_ms = []
        for _ in range(N_TIMED):
            t0 = time.perf_counter()
            if GUARD.run_audit(ctx.dev):
                fail("guard: a budgeted audit found a defect")
            budget_ms.append((time.perf_counter() - t0) * 1e3)
    out["audit_full_ms"] = full_ms
    out["audit_16_rows_ms"] = statistics.median(budget_ms)
    log(f"guard audit: every row of cfg4's resident state ({ctx.dev.N} rows, "
        f"15 tensors) equals the host mirror, one pull, {full_ms:.3f}ms; "
        f"NHD_GUARD_AUDIT_ROWS=16: median {out['audit_16_rows_ms']:.3f}ms "
        f"over {N_TIMED}")
    del ctx

    def classic(**knobs):
        with env(NHD_TPU_SPECULATE="0", **knobs):
            return BatchScheduler(
                device=card(torch), respect_busy=False, register_pods=False,
            ).schedule(cap_cluster(CELL_NODES, GROUPS), items, now=0.0)

    def placements(res):
        return [(r.node, r.nic_list) for r in res]

    clean, clean_stats = classic()
    for retries, want_floor in (("2", RUNG_MESH), ("1", RUNG_HOST)):
        GUARD.reset()
        base = API_COUNTERS.snapshot()
        inj = _DispatchFault(1)
        guard.set_fault_injector(inj)
        kernels.reset_launches()
        try:
            res, stats = classic(NHD_GUARD_RETRIES=retries)
        finally:
            guard.set_fault_injector(None)
        launches = dict(kernels.LAUNCHES)
        now = API_COUNTERS.snapshot()
        moved = {k: now[k] - base[k] for k in (
            "guard_faults_total", "guard_retries_total",
            "guard_degradations_total", "guard_repairs_total")}
        floor = GUARD.floor
        if inj.left or moved["guard_retries_total"] != 1:
            fail(f"guard: the injected dispatch fault was not retried once: {moved}")
        if placements(res) != placements(clean):
            fail(f"guard: placements after the injected fault (retries "
                 f"{retries}) differ from the fault-free run")
        if floor != want_floor:
            fail(f"guard: floor {RUNG_NAMES[floor]} after one fault at "
                 f"NHD_GUARD_RETRIES={retries}, expected {RUNG_NAMES[want_floor]}")
        # classic rounds: the solve kernels and rank_top at every rung
        if any(launches[k] == 0 for k in (*kernels.SOLVE_KERNELS, "rank_top")):
            fail(f"guard: a solve or rank kernel did not launch on the card at "
                 f"rung {RUNG_NAMES[floor]}: {launches}")
        log(f"guard fault (NHD_GUARD_RETRIES={retries}): one injected dispatch "
            f"fault, {moved}, floor {RUNG_NAMES[floor]}, rounds "
            f"{stats.rounds} (fault-free {clean_stats.rounds}), every pod placed "
            f"as the fault-free run; solve kernels launched {launches}")
        out[f"fault_retries_{retries}"] = {
            "counters": moved, "floor": RUNG_NAMES[floor], "rounds": stats.rounds,
            "launches": launches,
        }
    GUARD.reset()

    # the guard's cost per round: every batch audits (interval 1, 16
    # rows) and screens each pulled rank tensor, against NHD_GUARD=0.
    # One warm scheduler per setting, the nodes built before the clock
    # starts, classic cfg4 (3 rounds), alternating on/off; the first
    # pair warms up and is not kept
    scheds = {on: BatchScheduler(device=card(torch), respect_busy=False,
                                 register_pods=False) for on in ("1", "0")}
    walls = {"1": [], "0": []}
    audits, runs = [], []
    for rep in range(1 + GUARD_COST_PAIRS):
        for on in ("1", "0"):
            nodes = cap_cluster(CELL_NODES, GROUPS)
            with env(NHD_GUARD=on, NHD_TPU_SPECULATE="0",
                     NHD_GUARD_AUDIT_INTERVAL="1", NHD_GUARD_AUDIT_ROWS="16"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _res, stats = scheds[on].schedule(nodes, items, now=0.0)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            if rep == 0:
                continue
            walls[on].append(wall / stats.rounds * 1e3)
            if on == "1":
                audits.append(stats.phases.get("guard_audit", 0.0) * 1e3)
            runs.append({"guard": on, "wall_s": wall, "rounds": stats.rounds,
                         "phases_s": stats.phases})
    GUARD.reset()
    out.update({"round_ms_guard_on": walls["1"], "round_ms_guard_off": walls["0"],
                "batch_start_audit_ms": audits, "cost_runs": runs, "smi": smi})
    log(f"guard cost: classic cfg4 wall per round over {GUARD_COST_PAIRS} "
        f"alternating pairs, median guard on "
        f"{statistics.median(walls['1']):.2f}ms vs NHD_GUARD=0 "
        f"{statistics.median(walls['0']):.2f}ms (on: "
        f"{[round(w, 2) for w in walls['1']]}, off: "
        f"{[round(w, 2) for w in walls['0']]}); batch-start audit "
        f"{[round(a, 3) for a in audits]}ms; {smi}")
    report["guard"] = out


def stub_cluster(n_nodes, n_pods):
    """A started StubApiServer holding *n_nodes* cfg4 nodes (NFD labels
    from the port's sim, groups default/edge/batch in turn, 256 GiB of
    hugepages) and one ConfigMap for each of *n_pods* pods of
    workload_mix's three Triad shapes; and those pods, not yet created,
    as ``(name, add_pod keywords)`` in creation order: each with its
    node group in the nhd_groups annotation and ``schedulerName:
    nhd-scheduler``, the pending set of sim/pending.py as a real API
    server would receive it."""
    import nhd_tpu_torch.sim as sim
    from nhd_tpu_torch.k8s.apistub import StubApiServer
    from nhd_tpu_torch.k8s.interface import CFG_TYPE_ANNOTATION, GROUPS_ANNOTATION
    from nhd_tpu_torch.sim import pending

    stub = StubApiServer().start()
    for i in range(n_nodes):
        spec = sim.SynthNodeSpec(name=f"node{i:05d}",
                                 groups=pending.GROUPS[i % len(pending.GROUPS)],
                                 **pending.CFG4_NODE)
        hp = f"{spec.hugepages_gb}Gi"
        stub.add_node(spec.name, labels=sim.make_node_labels(spec),
                      internal_ip=f"10.0.{i >> 8}.{i & 255}",
                      hugepages_capacity=hp, hugepages_allocatable=hp)
    cfgs = pending.pod_configs(sim.make_triad_config)
    pods = []
    for i in range(n_pods):
        name = f"pod-{i:05d}"
        stub.add_configmap(f"{name}-cfg", "default",
                           {"triad.cfg": cfgs[i % len(cfgs)]})
        group = pending.GROUPS[(i // len(cfgs)) % len(pending.GROUPS)]
        pods.append((name, dict(uid=f"uid-{i:05d}", configmap=f"{name}-cfg",
                                scheduler="nhd-scheduler",
                                annotations={GROUPS_ANNOTATION: group,
                                             CFG_TYPE_ANNOTATION: "triad"})))
    return stub, pods


def create_pod(stub, name, kw):
    """Create one pod as the API server does: stored, then announced on
    the pod watch (the stream's copy taken now, before any bind)."""
    import copy

    pod = stub.add_pod(name, **kw)
    stub.queue_watch_event("/api/v1/pods", "ADDED", copy.deepcopy(pod))


def quantiles_ms(values):
    """p50/p99 (nearest rank) of *values*, seconds, in ms."""
    import math

    v = sorted(values)
    return {f"p{q}": v[max(math.ceil(q / 100 * len(v)) - 1, 0)] * 1e3
            for q in (50, 99)} if v else {"p50": None, "p99": None}


def log_tail(path, n=40):
    with open(path) as fh:
        lines = fh.read().splitlines()
    return f" (log {path}, last lines:\n" + "\n".join(lines[-n:]) + ")"


#: CLI starts retried on another metrics port when its bind found the
#: port taken (``free_port`` probes it, the CLI binds it seconds later)
CLI_REBINDS = 2


def free_port():
    """A port free on every interface, below Linux's ephemeral range
    (32768 and up): a port the kernel handed out and took back could be
    handed again to the CLI's own gRPC server (``--rpc-port 0``) before
    the metrics server binds it."""
    import random
    import socket

    start = random.randrange(20000, 32000)
    for port in range(start, start + 500):
        with socket.socket() as s:
            try:
                s.bind(("", port))
            except OSError:
                continue
            return port
    fail("no free port below the ephemeral range for /metrics")


def scrape(port):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as r:
        return r.read().decode()


def bind_quantiles_ms(text):
    """p50/p99 of ``nhd_bind_latency_seconds`` from a /metrics text, by
    the same interpolation the repo's scrapes use (a quantile past the
    top finite edge reads as that edge), its count, and how many binds
    lie past the top finite edge."""
    from nhd_tpu_torch.obs.histo import quantile_from_buckets

    edges = []
    for line in text.splitlines():
        if line.startswith('nhd_bind_latency_seconds_bucket{le="'):
            le = line.split('"')[1]
            edges.append((float("inf") if le == "+Inf" else float(le),
                          int(float(line.split()[-1]))))
    count = edges[-1][1] if edges else 0
    above = count - edges[-2][1] if len(edges) > 1 else 0
    return ({f"p{int(q * 100)}": quantile_from_buckets(edges, q) * 1e3
             for q in (0.5, 0.99)}, count, above)


def request_kinds(requests):
    """The stub's request log counted by method and resource (watch
    streams apart), in order of count."""
    counts = {}
    for method, path, _ctype, _body in requests:
        parts = [p for p in path.split("?")[0].split("/") if p]
        if "watch=true" in path:
            kind = "watch " + parts[-1]
        elif parts[-1] in ("binding", "events", "nodes", "pods", "triadsets"):
            kind = parts[-1]
        else:
            kind = parts[-2] if len(parts) > 1 else parts[-1]
            kind = {"pods": "pod", "configmaps": "configmap",
                    "nodes": "node"}.get(kind, kind)
        key = f"{method} {kind}"
        counts[key] = counts.get(key, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def families(text, *prefixes):
    return [line for line in text.splitlines()
            if line.startswith(prefixes)]


def jit_shapes(lines):
    """{shape key: uses} from the ``nhd_jit_shape_uses_total`` lines of a
    /metrics scrape."""
    out = {}
    for line in lines:
        if line.startswith('nhd_jit_shape_uses_total{shape="'):
            key, _, n = line[len('nhd_jit_shape_uses_total{shape="'):].rpartition('"} ')
            out[key] = int(float(n))
    return out


def fleet_top(port, top_dir):
    """Phase 16 (f): one pass of the port's fleet top
    (``nhd_tpu_torch.obs.fleet_top``, as an operator runs it) over the
    CLI's metrics port, writing its fleet artifact into *top_dir*.
    Returns its exit code, printed lines and artifact path."""
    import io

    from nhd_tpu_torch.obs import fleet_top as top

    path = os.path.join(top_dir, "fleet-top.json")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = top.main([f"http://127.0.0.1:{port}", "--timeout", "10",
                       "--json-out", path])
    return {"rc": rc, "lines": buf.getvalue().splitlines(), "path": path,
            "wall_s": time.perf_counter() - t0}


def scrape_until_answered(port, done, out, top_dir=None):
    """The mid-run scrape, on its own thread: /metrics goes through the
    scheduler thread's RPC queue, which answers 503 after 5 s while that
    thread is committing a batch; try once a second until it answers or
    the run is over, and keep the answer or the last error. With
    *top_dir*, fleet top scrapes the same port too, until it reaches it
    (``out["top"]``)."""
    tries = 0
    while not done.is_set():
        tries += 1
        try:
            if "text" not in out:
                out["text"] = scrape(port)
            if top_dir is None:
                break
            out["top"] = fleet_top(port, top_dir)
            if out["top"]["rc"] == 0:
                break
        except OSError as exc:
            out["error"] = f"{exc}"
        done.wait(1.0)
    out["tries"] = tries


def cli_ready(stub, port):
    """The CLI has finished starting: its pod watch streams (the relist
    that seeds it is done) and /metrics answers (the scheduler thread
    finished its startup scan and serves its RPC queue)."""
    if not stub.watch_connects.get("/api/v1/pods"):
        return False
    try:
        scrape(port)
    except OSError:
        return False
    return True


def run_cli(device, n_nodes, n_pods, workdir, label, log_dir="chiprun_out",
            extra_args=(), extra_env=None, top_dir=None):
    """Phase 10 (b)/(c): ``python -m nhd_tpu_torch.cli`` on *device*
    against a fresh stub holding the nodes. Once the CLI is up, the
    pods are created through the stub, each announced on the pod watch,
    at most CLI_BACKLOG created and not yet bound at a time; until every
    pod is bound (and a short settle) or binds stop for CLI_QUIET_S.
    /metrics is scraped from the first bind on (until answered; with
    *top_dir*, by fleet top too) and at the end, then SIGINT, the CLI's
    clean exit. Returns what the run
    showed, the kernels' launches the CLI printed at its exit, and each
    pod's (node, solved config, NAD) as the stub holds them."""
    import signal
    import threading

    from nhd_tpu_torch.k8s.interface import CFG_ANNOTATION, NAD_ANNOTATION

    stub, pods = stub_cluster(n_nodes, n_pods)
    jdir = os.path.join(workdir, f"journal-{label}")
    os.makedirs(log_dir, exist_ok=True)
    log_path = os.path.join(log_dir, f"cli-{label}.log")
    port = free_port()
    child_env = dict(
        os.environ,
        KUBERNETES_SERVICE_HOST="127.0.0.1",
        KUBERNETES_SERVICE_PORT=str(stub.port),
        KUBERNETES_SERVICE_SCHEME="http",
        NHD_K8S_TOKEN_FILE=os.path.join(workdir, "no-token"),
        NHD_MIN_BUSY_SECS="0",
        # the card's default made explicit, so the CPU run takes the same
        # rounds (the speculative round 0) as the card's
        NHD_TPU_SPECULATE="1",
        PYTHONPATH=os.pathsep.join(
            [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
    )
    child_env.update(extra_env or {})
    cmd = [sys.executable, "-m", "nhd_tpu_torch.cli", "--device", device,
           "--rpc-port", "0", "--metrics-port", str(port), "--journal", jdir,
           "--run-seconds", str(CLI_RUN_S), *extra_args]
    out = {"device": device, "cmd": " ".join(cmd[1:]), "backlog": CLI_BACKLOG}
    if signal.getsignal(signal.SIGINT) is signal.SIG_IGN:
        # a SIGINT ignored by whatever started this script would be
        # inherited: the CLI's clean exit is its KeyboardInterrupt
        signal.signal(signal.SIGINT, signal.default_int_handler)
    with open(log_path, "w") as fh:
        t0, t0_wall = time.perf_counter(), time.time()
        proc = subprocess.Popen(
            cmd, stdout=fh, stderr=subprocess.STDOUT, text=True, env=child_env,
            cwd=ROOT,
        )
        done, mid = threading.Event(), {}
        rebinds = 0
        try:
            while not cli_ready(stub, port):
                if proc.poll() is not None:
                    if rebinds < CLI_REBINDS and "Address already in use" in log_tail(log_path):
                        # another socket took the metrics port between its
                        # probe and the CLI's bind: the same run on another
                        rebinds += 1
                        port = free_port()
                        cmd[cmd.index("--metrics-port") + 1] = str(port)
                        out["cmd"] = " ".join(cmd[1:])
                        proc = subprocess.Popen(
                            cmd, stdout=fh, stderr=subprocess.STDOUT, text=True,
                            env=child_env, cwd=ROOT,
                        )
                        continue
                    fail(f"cli {label}: exited early with {proc.returncode}"
                         f"{log_tail(log_path)}")
                if time.perf_counter() - t0 > CLI_READY_S:
                    fail(f"cli {label}: not up within {CLI_READY_S:.0f}s"
                         f"{log_tail(log_path)}")
                time.sleep(0.1)
            out["metrics_rebinds"] = rebinds
            scraper = threading.Thread(target=scrape_until_answered,
                                       args=(port, done, mid, top_dir),
                                       daemon=True)
            feed0 = time.perf_counter()
            created, bound_at = {}, {}
            seen = fed = 0
            first = last = None
            while True:
                now = time.perf_counter()
                n = len(stub.bindings)
                for _ns, name, _body in stub.bindings[seen:n]:
                    bound_at.setdefault(name, now)
                if n != seen:
                    seen, last = n, now
                    if first is None:
                        first = now
                        scraper.start()
                while fed < n_pods and fed - len(bound_at) < CLI_BACKLOG:
                    name, kw = pods[fed]
                    created[name] = time.perf_counter()
                    create_pod(stub, name, kw)
                    fed += 1
                if proc.poll() is not None:
                    fail(f"cli {label}: exited early with {proc.returncode}"
                         f"{log_tail(log_path)}")
                if first is None and now - feed0 > CLI_FIRST_BIND_S:
                    fail(f"cli {label}: no bind within {CLI_FIRST_BIND_S:.0f}s "
                         f"of the first pod{log_tail(log_path)}")
                # every pod bound: no scan can decide anything more, so
                # the journal is complete; else give the daemon's periodic
                # scan (after 30 s idle) its chance at what is left
                if last is not None and (
                        now - last >= CLI_QUIET_S
                        or (len(bound_at) == n_pods and now - last >= CLI_SETTLE_S)):
                    break
                time.sleep(0.02)
            done.set()
            scraper.join(timeout=30)
            end = scrape(port)
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            stub.stop()
        wall = time.perf_counter() - t0
    with open(log_path) as fh:
        text = fh.read()
    if rc != 0:
        fail(f"cli {label}: exit code {rc} after SIGINT{log_tail(log_path)}")
    written = [line for line in text.splitlines() if "journal written to" in line]
    if not written:
        fail(f"cli {label}: no 'journal written to' line{log_tail(log_path)}")
    out["journal"] = written[-1].split("journal written to", 1)[1].strip()
    printed = [line for line in text.splitlines()
               if line.startswith("kernel launches: ")]
    if len(printed) != 1:
        fail(f"cli {label}: no 'kernel launches' line{log_tail(log_path)}")
    out["launches"] = json.loads(printed[0].split(": ", 1)[1])
    graphs = [line for line in text.splitlines()
              if line.startswith("megaround graphs: ")]
    out["graphs"] = json.loads(graphs[0].split(": ", 1)[1]) if graphs else None
    out["rpc_line"] = next((line.split(": ", 1)[-1] for line in text.splitlines()
                            if "stats RPC" in line), "no stats RPC line")
    out["bound"], out["total"], out["fed"] = len(bound_at), n_pods, fed
    out["ready_s"], out["first_bind_s"] = feed0 - t0, first - feed0
    out["startup_s"] = startup_marks(text, t0_wall)
    out["prewarm_line"] = next(
        (line.split(": ", 1)[-1] for line in text.splitlines()
         if "prewarm: " in line), None)
    out["bind_span_s"] = last - first
    out["binds_per_s"] = (seen - 1) / (last - first) if last > first else None
    # every pod's create to its bind, stamped in this process by the poll
    # (20 ms): what a pod's owner waits
    out["bind_ms"] = quantiles_ms([bound_at[k] - created[k] for k in bound_at])
    out["wall_s"] = wall
    hist, count, above = bind_quantiles_ms(end)
    out["metrics_bind_ms"] = {**hist, "count": count, "past_top_edge": above}
    out["mid_scrape"] = (
        f"{bind_quantiles_ms(mid['text'])[1]} binds counted"
        if "text" in mid else f"unanswered ({mid.get('error')})"
    ) + f", {mid.get('tries', 0)} tries"
    out["top"] = mid.get("top")
    out["requests"] = request_kinds(stub.requests)
    out["admission"] = families(end, "nhd_admission_")
    out["guard"] = families(end, "nhd_guard_")
    out["jit"] = families(end, "nhd_jit_")
    outcome = {
        key: (p["spec"].get("nodeName"),
              p["metadata"]["annotations"].get(CFG_ANNOTATION),
              p["metadata"]["annotations"].get(NAD_ANNOTATION))
        for key, p in sorted(stub.pods.items())
    }
    return out, outcome


#: CLI log lines that mark its start-up steps, in order
STARTUP_MARKS = (
    ("imports", "nhd_tpu_torch version"),
    ("device", "solver device: "),
    ("prewarm", "prewarm: "),
    ("serving", "stats RPC"),
)


def startup_marks(text, t0_wall):
    """Seconds from the CLI's spawn to the first log line of each start-up
    step (``STARTUP_MARKS``; the log's millisecond timestamps, read
    against the wall clock at spawn)."""
    import datetime

    marks = {}
    for line in text.splitlines():
        for name, marker in STARTUP_MARKS:
            if name not in marks and marker in line:
                try:
                    stamp = datetime.datetime.strptime(
                        line[:23], "%Y-%m-%d %H:%M:%S,%f").timestamp()
                except ValueError:
                    continue
                marks[name] = stamp - t0_wall
    return marks


def metrics_bind_text(got):
    m = got["metrics_bind_ms"]
    if m["past_top_edge"]:
        return (f"/metrics histogram saturated: {m['past_top_edge']} of "
                f"{m['count']} binds past its top finite edge, not a reading")
    return (f"/metrics histogram p50={m['p50']:.1f}ms p99={m['p99']:.1f}ms "
            f"over {m['count']} binds")


def journal_batches(path):
    """The batches a CLI journal recorded, in the order the scheduler
    folded them out of its admission queue: each the (ns, pod) it
    solved together (the port's replay folds them so)."""
    from nhd_tpu_torch.obs.journal import load_journal
    from nhd_tpu_torch.sim.replay import recorded_folds

    return recorded_folds(load_journal(path)[1])


def replay(torch, label, path, device, counted=False):
    """Phase 10 (d): one journal through the port's replay_journal on
    *device*, under the knobs its genesis recorded (the busy window,
    read once at import, set on the node module for the run). Returns
    its decision signatures, the wall and (counted) the kernels'
    launches in the run."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.core import node as node_mod
    from nhd_tpu_torch.obs.journal import load_journal
    from nhd_tpu_torch.sim.replay import _decision_sig, replay_journal

    genesis = next(e for e in load_journal(path)[1] if e["ev"] == "genesis")
    knobs = {k: v for k, v in (genesis.get("knobs") or {}).items()
             if not k.startswith("NHD_JOURNAL")}
    saved = node_mod.MIN_BUSY_SECS
    node_mod.MIN_BUSY_SECS = float(knobs.get("NHD_MIN_BUSY_SECS") or 30)
    try:
        with env(**knobs):
            if counted:
                torch.cuda.synchronize()
                kernels.reset_launches()
                ranked0 = ranked_uses()
            t0 = time.perf_counter()
            result = replay_journal([path], device=device)
            if counted:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = None
            if counted:
                launches = dict(kernels.LAUNCHES)
                launches[RANKED] = ranked_uses() - ranked0
    finally:
        node_mod.MIN_BUSY_SECS = saved
    if result.diverged:
        fail(f"replay {label} on {device}: {len(result.divergences)} "
             f"divergence(s), first {result.first_divergence}")
    if not result.recorded:
        fail(f"replay {label}: the journal recorded no decisions")
    sig = [(d.get("ns"), d.get("pod"), _decision_sig(d)) for d in result.replayed]
    log(f"replay {label} on {device}: {len(result.replayed)} decisions against "
        f"{len(result.recorded)} recorded, 0 divergences, knob drift "
        f"{sorted(result.knob_drift) or 'none'}, wall={wall:.3f}s"
        + (f", launches={launches}" if counted else ""))
    return sig, wall, launches


def same_prefix(batches, other):
    """How many batches, from the first, the two runs decided alike."""
    k = 0
    while k < min(len(batches), len(other)) and batches[k] == other[k]:
        k += 1
    return k


def compare_runs(got, outcome, cpu, cpu_outcome):
    """Phase 10 (c): the cuda and the cpu CLI runs. Both bind every pod;
    the batches both journals record alike from the first on, in the
    same order and from the same cluster, leave the same state, so every
    pod in them must sit on the same node with the same solved config
    and NAD (past the first batch that differs, the states may differ).
    Returns the verdict and both runs' batches."""
    for run in (got, cpu):
        if run["bound"] != CLI_PODS:
            fail(f"cli {run['device']}: bound {run['bound']}/{CLI_PODS}")
    batches = journal_batches(got["journal"])
    cpu_batches = journal_batches(cpu["journal"])
    k = same_prefix(batches, cpu_batches)
    keys = [key for b in batches[:k] for key in b]
    diff = [key for key in keys if outcome[key] != cpu_outcome[key]]
    if diff:
        fail(f"cli: {len(diff)} of {len(keys)} pods in the batches both "
             f"runs share bound differently on cuda and cpu (first: "
             f"{diff[0]}: {outcome[diff[0]]} vs {cpu_outcome[diff[0]]})")
    if k == len(batches) == len(cpu_batches):
        compared = (f"same batches ({k}): every pod's node, solved config "
                    "and NAD identical on cuda and cpu")
    else:
        compared = (f"the admission timing split the pods differently: "
                    f"cuda {len(batches)} batches, cpu {len(cpu_batches)}; "
                    f"the first {k} alike, and their {len(keys)} pods' "
                    "node, solved config and NAD identical; past them "
                    "each run's journal is replayed on the other device "
                    "in (d)")
    log(f"cli cuda vs cpu: {compared}; cuda batch sizes "
        f"{[len(b) for b in batches]}; cpu batch sizes "
        f"{[len(b) for b in cpu_batches]}")
    return compared, batches, cpu_batches


def cli_phase(torch, report, launches_total, smi):
    """Phase 10: the CLI over HTTP on the card, the same on the CPU, and
    the journals replayed (module docstring)."""
    import tempfile

    from nhd_tpu_torch import kernels

    with tempfile.TemporaryDirectory(prefix="nhd-cli-") as work:
        got, outcome = run_cli("cuda", CLI_NODES, CLI_PODS, work, "cuda",
                               top_dir=work)
        fleet_top_check(got.get("top"), smi)
        log(f"cli cuda: {CLI_NODES} nodes, {CLI_PODS} pods created over HTTP "
            f"as watch events, at most {CLI_BACKLOG} unbound at a time (cut: "
            f"{CLI_CUT}); up {got['ready_s']:.2f}s after start; bound "
            f"{got['bound']}/{got['total']}, first bind "
            f"{got['first_bind_s']:.3f}s after the first pod, "
            f"{got['binds_per_s'] or 0:.1f} binds/s (first to last bind "
            f"{got['bind_span_s']:.3f}s), create-to-bind p50="
            f"{got['bind_ms']['p50']:.1f}ms p99={got['bind_ms']['p99']:.1f}ms "
            f"(stamped by this script's 20 ms poll); {metrics_bind_text(got)} "
            f"(mid-run scrape: {got['mid_scrape']}), wall={got['wall_s']:.2f}s; "
            f"{smi}")
        log(f"cli cuda: stats RPC plane: {got['rpc_line']}")
        log(f"cli cuda: HTTP requests the stub served: {got['requests']}")
        log(f"cli cuda /metrics admission: {'; '.join(got['admission'])}")
        log(f"cli cuda /metrics guard: {'; '.join(got['guard'])}")
        log(f"cli cuda /metrics jit: {'; '.join(got['jit'])}")
        log(f"cli cuda: kernel launches the CLI process printed at its exit: "
            f"{got['launches']}; {smi}")
        g = got["graphs"] or {}
        per = {k[:-2]: g[k] / g["dispatches"] * 1e3
               for k in g if k.endswith("_s") and k != "capture_s" and g.get("dispatches")}
        log(f"cli cuda: megaround graphs {g}; host ms a dispatch by part "
            f"{ {k: round(v, 4) for k, v in per.items()} }, in all "
            f"{sum(per.values()):.4f} ms")
        if got["bound"] != CLI_PODS:
            fail(f"cli cuda: bound {got['bound']}/{CLI_PODS}")
        if sorted(got["launches"]) != sorted(kernels.COUNTED):
            fail(f"cli cuda: launch counts for {sorted(got['launches'])}")
        # the CLI process's classic rank dispatches, from its last /metrics
        got["launches"][RANKED] = ranked_uses(jit_shapes(got["jit"]))
        # speculative batches (one graph replay each, no mesh); rank_top
        # where a batch's megaround left pods to a classic round
        require_launched("cli cuda", got["launches"],
                         SPEC_PATH + (kernels.GRAPH,))
        add_launches(launches_total, got["launches"])
        cpu, cpu_outcome = run_cli("cpu", CLI_NODES, CLI_PODS, work, "cpu")
        log(f"cli cpu: up {cpu['ready_s']:.2f}s, bound {cpu['bound']}/"
            f"{cpu['total']}, {cpu['binds_per_s'] or 0:.1f} binds/s, "
            f"create-to-bind p50={cpu['bind_ms']['p50']:.1f}ms "
            f"p99={cpu['bind_ms']['p99']:.1f}ms, wall={cpu['wall_s']:.2f}s, "
            f"launches {cpu['launches']}")
        compared, batches, cpu_batches = compare_runs(got, outcome, cpu,
                                                      cpu_outcome)
        # (d) replays: (b)'s journal on the card (its launches a separate,
        # in-process reading) and on the CPU, (c)'s on the card: each
        # run's live decisions re-derived on the other device from the
        # same batches; the golden journal on both
        sig, wall, launches = replay(torch, "cli journal", got["journal"],
                                     card(torch), counted=True)
        require_launched("cli replay", launches, SPEC_PATH)
        cpu_sig, cpu_wall, _ = replay(torch, "cli journal", got["journal"], "cpu")
        if sig != cpu_sig:
            fail("cli replay: decisions differ between cuda and cpu")
        _, cross_wall, _ = replay(torch, "cpu cli journal", cpu["journal"],
                                  card(torch))
        gold, gold_wall, _ = replay(torch, "golden", GOLDEN_JOURNAL, card(torch))
        gold_cpu, _, _ = replay(torch, "golden", GOLDEN_JOURNAL, "cpu")
        if gold != gold_cpu:
            fail("golden replay: decisions differ between cuda and cpu")
        log(f"cli journal's in-process cuda replay launches (not the CLI "
            f"run's): {launches}; {smi}")
    report["cli"] = {
        "nodes": CLI_NODES, "pods": CLI_PODS, "cut": CLI_CUT, "cuda": got,
        "cpu": cpu, "compared": compared, "batches": [len(b) for b in batches],
        "cpu_batches": [len(b) for b in cpu_batches], "replay_s": wall,
        "replay_cpu_s": cpu_wall, "cpu_journal_on_card_s": cross_wall,
        "golden_replay_s": gold_wall,
        "replay_launches": launches, "smi": smi,
    }


def fleet_top_check(top, smi):
    """Phase 16 (f), read after phase 10's card run: fleet top reached
    the CLI's metrics port during the mid-run scrape, and the fleet
    artifact it wrote validates."""
    from nhd_tpu_torch.obs.fleet import validate_fleet_artifact

    if top is None or top["rc"] != 0:
        fail(f"fleet top: never reached the CLI's metrics port during the "
             f"run ({top and top['lines']})")
    with open(top["path"]) as fh:
        art = json.load(fh)
    errs = validate_fleet_artifact(art)
    if errs:
        fail(f"fleet top: its artifact is invalid: {errs}")
    payload = art["payload"]
    OPS["f"] = {"wall_s": top["wall_s"], "lines": top["lines"],
                "replicas": [r["replica"] for r in payload["replicas"]]}
    log(f"ops (f) fleet top over the CLI's metrics port mid-run: exit 0 in "
        f"{top['wall_s']:.3f}s, artifact valid ({len(payload['replicas'])} "
        f"replica(s), worst burn {payload['slo']['worst_burn_rates']}, "
        f"{payload['device_state']['deltas_total']} state deltas); "
        f"{' | '.join(line.strip() for line in top['lines'][1:])}; {smi}")


def storm_matrix(device, seeds, nodes, steps, path):
    """One device-faults matrix through the port's storm (sim/storm.py),
    in this process, under phase 11's posture; returns its summary and,
    on the card, the kernels' launches (counts set to 0 just before)."""
    import torch

    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.sim import storm

    with env(**CHAOS_ENV):
        if device == "cuda":
            torch.cuda.synchronize()
            kernels.reset_launches()
        ranked0 = ranked_uses()
        t0 = time.perf_counter()
        rc = storm.main([
            "--profiles", "device-faults", "--seeds", str(seeds),
            "--steps", str(steps), "--nodes", str(nodes), "--device-plane",
            "--bind-parity", "--device", device, "--json-out", path,
        ])
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = None
        if device == "cuda":
            launches = dict(kernels.LAUNCHES)
            launches[RANKED] = ranked_uses() - ranked0
    with open(path) as fh:
        summary = json.load(fh)
    if rc != 0 or not summary["ok"]:
        bad = [(c["seed"], c["violations"][:3], c["stuck_pods"][:3])
               for c in summary["cells"] if not c["ok"]]
        fail(f"storm on {device} ({nodes} nodes): failed cells {bad}")
    summary["wall_s"] = wall
    return summary, launches


def chaos_phase(torch, report, launches_total, smi):
    """Phase 11: the device-fault storm on the card (module docstring)."""
    import tempfile

    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.k8s.retry import API_COUNTERS
    from nhd_tpu_torch.sim.chaos import ChaosSim
    from nhd_tpu_torch.sim.faults import FaultProfile
    from nhd_tpu_torch.solver import guard

    out = {"smi": smi}
    phase = dict.fromkeys(kernels.COUNTED + (RANKED,), 0)
    sites_total = {}
    flips_total = 0
    with tempfile.TemporaryDirectory(prefix="nhd-chaos-") as work:
        for label, seeds, nodes, steps in CHAOS_CELLS:
            got, launches = storm_matrix(
                "cuda", seeds, nodes, steps, os.path.join(work, label + ".json"))
            cpu, _ = storm_matrix(
                "cpu", seeds, nodes, steps, os.path.join(work, label + "-cpu.json"))
            for k in phase:
                phase[k] += launches.get(k, 0)
            for c, cc in zip(got["cells"], cpu["cells"], strict=True):
                seed = c["seed"]
                if not c.get("bind_parity"):
                    fail(f"chaos {label} seed {seed}: bound set differs from "
                         "its fault-free control on cuda")
                if c["bound_set"] != cc["bound_set"]:
                    fail(f"chaos {label} seed {seed}: bound set differs from "
                         "the CPU run of the same seed")
                for key in ("faults_injected", "faults_by_site", "bit_flips",
                            "restarts"):
                    if c[key] != cc[key]:
                        fail(f"chaos {label} seed {seed}: {key} {c[key]} on "
                             f"cuda, {cc[key]} on the CPU")
                if c["guard_giveups"]:
                    fail(f"chaos {label} seed {seed}: the guard gave up "
                         f"{c['guard_giveups']} time(s)")
                for site, n in c["faults_by_site"].items():
                    sites_total[site] = sites_total.get(site, 0) + n
                flips_total += c["bit_flips"]
                log(f"chaos {label} seed {seed}: {nodes} nodes, {steps} steps, "
                    f"bound {len(c['bound_set'])} as its fault-free control "
                    f"and the CPU run; faults by site {c['faults_by_site']}, "
                    f"slow dispatches {c['faults_injected']['device_slow_dispatches']}, "
                    f"bit flips {c['bit_flips']}, end-state audit bit-exact, "
                    f"guard rung at the end {c['guard_rung_end']}, give-ups 0, "
                    f"restarts {c['restarts']} (the churn's, as on the CPU)")
            log(f"chaos {label}: matrix wall {got['wall_s']:.2f}s on cuda "
                f"(controls included), {cpu['wall_s']:.2f}s on the CPU; "
                f"launches {launches}; {smi}")
            out[label] = {"cuda": got, "cpu": cpu, "launches": launches}
        for site in ("dispatch", "upload", "megaround"):
            if not sites_total.get(site):
                fail(f"chaos: no injected fault landed at {site} "
                     f"({sites_total})")
        if not flips_total:
            fail("chaos: no bit flip landed over the matrix")
        # (c) the negative control: flips with the guard off must survive
        # whole steps, and nothing may repair them
        with env(**CHAOS_ENV, NHD_GUARD="0"):
            guard.GUARD.reset()
            repairs = API_COUNTERS.get("guard_repairs_total")

            def control_run():
                sim = ChaosSim(seed=0, api_faults=FaultProfile(
                    name="flips-only", device_bit_flip=0.5), device="cuda")
                fired = 0
                for _ in range(CHAOS_CONTROL_STEPS):
                    before = sim.stats.bit_flips
                    sim.step()
                    if sim.stats.bit_flips > before and sim.device_audit_errors():
                        fired += 1
                sim.quiesce()
                return sim, fired

            (sim, fired), _wall, control = counted(torch, control_run)
            repaired = API_COUNTERS.get("guard_repairs_total") - repairs
            guard.GUARD.reset()
        for k in phase:
            phase[k] += control.get(k, 0)
        log(f"chaos negative control (NHD_GUARD=0, flips only, seed 0, "
            f"{CHAOS_CONTROL_STEPS} steps on cuda): {sim.stats.bit_flips} "
            f"flips, {fired} survived their step (the audit reports them), "
            f"{repaired} repairs")
        if not sim.stats.bit_flips or not fired:
            fail("chaos negative control: no corruption survived a step; "
                 "the control is vacuous")
        if repaired:
            fail(f"chaos negative control: {repaired} repair(s) with the "
                 "guard off")
    # speculative steps (the storm runs with NHD_MESH=off); rank_top where
    # a step's megaround left pods, or a faulted batch retried, classic
    require_launched("chaos", phase, SPEC_PATH)
    add_launches(launches_total, phase)
    log(f"chaos: faults by site over the matrix {sites_total}, bit flips "
        f"{flips_total}; launches in the phase {phase}; {smi}")
    out.update(sites=sites_total, flips=flips_total, launches=phase,
               control={"flips": sim.stats.bit_flips, "fired": fired})
    report["chaos"] = out


def probe(label, directory, *args):
    """Phase 12: one first-bind probe, a fresh process on the card with
    the kernel cache in *directory*; returns its JSON line and the
    process wall."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "nhd_tpu_torch.solver.aot",
         "--first-bind-probe", "--device", "cuda", *args],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, NHDC_AOT_DIR=directory),
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"probe {label}: exit {proc.returncode}: {proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    got["process_s"] = wall
    log(f"probe {label}: first_bind_s={got['first_bind_s']:.4f} "
        f"second_bind_s={got['second_bind_s']:.4f} "
        f"prewarm_s={got['prewarm_s']:.4f} programs={got['programs']} "
        f"quarantined={got['quarantined']} libraries={got['libraries']} "
        f"built={got['built']} (in the bind: {got['bind_builds']} built, "
        f"{got['bind_loads']} loaded, {got.get('bind_captures')} megaround graphs "
        f"captured) bound={got['bound']} "
        f"process={wall:.2f}s")
    return got


def zero_recompile_child():
    """Phase 12 (e), in a fresh process: prewarm from NHDC_AOT_DIR, then
    the storm of tests/test_aot.py:151 on the card; prints one JSON
    line. The phase holds the counters it prints."""
    import torch

    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.kernels import build
    from nhd_tpu_torch.obs.jitstats import JIT_STATS
    from nhd_tpu_torch.sim.chaos import ChaosSim
    from nhd_tpu_torch.sim.faults import PROFILES
    from nhd_tpu_torch.solver import aot

    summary = aot.prewarm(device="cuda")
    warm, built = JIT_STATS.snapshot(), dict(build.COUNTS)
    t0 = time.perf_counter()
    sim = ChaosSim(seed=11, n_nodes=4, api_faults=PROFILES["light"],
                   device="cuda")
    sim.run(60)
    sim.quiesce()
    torch.cuda.synchronize()
    steady = JIT_STATS.snapshot()
    print(json.dumps({
        "prewarm": {k: summary[k] for k in
                    ("loaded", "libraries", "built", "quarantined", "seconds")},
        "warm": {k: warm[k] for k in ("compiles_total", "cache_hits_total")},
        "steady": {k: steady[k] for k in ("compiles_total", "cache_hits_total")},
        "escaped": sorted(set(steady["shapes"]) - set(warm["shapes"])),
        "builds": build.COUNTS["builds"] - built["builds"],
        "loads": build.COUNTS["loads"] - built["loads"],
        "storm_s": time.perf_counter() - t0,
        "launches": dict(kernels.LAUNCHES),
        "ranked": ranked_uses(steady["shapes"]),
    }), flush=True)
    return 0


def prewarm_phase(torch, report, launches_total, smi):
    """Phase 12: the kernel cache on the card (module docstring)."""
    import glob
    import shutil
    import tempfile

    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.kernels.abi import SOURCES
    from nhd_tpu_torch.sim.chaos import ChaosSim
    from nhd_tpu_torch.sim.faults import PROFILES
    from nhd_tpu_torch.solver import aot, guard

    out = {"smi": smi}
    phase = dict.fromkeys(kernels.COUNTED + (RANKED,), 0)
    # the name prefixes of the cache's manifest entries
    manifest = tuple(f"{kind}_" for kind in aot.JIT_KIND)

    def add(launches, ranked):
        for k in kernels.COUNTED:
            phase[k] += launches.get(k, 0)
        phase[RANKED] += ranked

    with tempfile.TemporaryDirectory(prefix="nhd-aot-") as work:
        cache = os.path.join(work, "aot")
        os.makedirs(cache)
        cold = probe("(a) cold, empty cache, --save", cache, "--save")
        if cold["bind_builds"] != len(SOURCES):
            fail(f"probe (a): {cold['bind_builds']} libraries built in the "
                 f"bind, expected {len(SOURCES)}")
        if not any(glob.glob(os.path.join(cache, p + "*.json"))
                   for p in manifest):
            fail("probe (a): no manifest entry recorded")
        restart = probe("(b) restart, no prewarm", cache)
        warm = probe("(c) restart, --prewarm", cache, "--prewarm")
        for got, what in ((restart, "(b)"), (warm, "(c)")):
            if got["bind_builds"] or got["built"] or got["quarantined"]:
                fail(f"probe {what}: built or quarantined on a valid cache")
        if not warm["programs"] or warm["bind_loads"]:
            fail(f"probe (c): {warm['programs']} programs warmed, "
                 f"{warm['bind_loads']} libraries loaded in the bind")
        # (d) a copy with one library truncated and one meta edited
        damaged = os.path.join(work, "damaged")
        shutil.copytree(cache, damaged)
        so = glob.glob(os.path.join(damaged, "libnic_any_first-*.so"))[0]
        with open(so, "r+b") as fh:
            fh.truncate(64)
        meta_path = glob.glob(os.path.join(damaged, "libspec_fill-*.json"))[0]
        with open(meta_path) as fh:
            meta = json.load(fh)
        meta["fingerprint"] = "edited"
        with open(meta_path, "w") as fh:
            json.dump(meta, fh)
        fixed = probe("(d) one library truncated, one meta edited, --prewarm",
                      damaged, "--prewarm")
        qdir = os.path.join(damaged, "quarantine")
        moved = sorted(os.listdir(qdir)) if os.path.isdir(qdir) else []
        want = sorted([os.path.basename(so), os.path.basename(so)[:-3] + ".json",
                       os.path.basename(meta_path),
                       os.path.basename(meta_path)[:-5] + ".so"])
        if fixed["quarantined"] != 2 or fixed["built"] != 2 or moved != want:
            fail(f"probe (d): quarantined {fixed['quarantined']}, built "
                 f"{fixed['built']}, quarantine/ holds {moved}")
        log(f"probe (d): quarantine/ holds {moved}; both rebuilt and loaded")
        for got in (cold, restart, warm, fixed):
            add(got["launches"], got["ranked"])
        # (e) the storm of tests/test_aot.py:151 recorded here, then
        # replayed in a fresh process after prewarm
        storm_dir = os.path.join(work, "storm")
        libraries_only = shutil.ignore_patterns(
            *(p + "*" for p in manifest), "quarantine")
        shutil.copytree(cache, storm_dir, ignore=libraries_only)
        aot.configure(directory=storm_dir, save=True)
        # the shapes the earlier phases' faults quarantined in this
        # process are not recorded: start the guard clean, as a fresh
        # daemon would
        guard.GUARD.reset()
        try:
            sim = ChaosSim(seed=11, n_nodes=4, api_faults=PROFILES["light"],
                           device="cuda")
            sim.run(60)
            sim.quiesce()
            aot.AOT.drain()
        finally:
            aot.reset()
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c",
             "import sys, chip_smoke; sys.exit(chip_smoke.zero_recompile_child())"],
            capture_output=True, text=True, timeout=600, cwd=ROOT,
            env=dict(os.environ, NHDC_AOT_DIR=storm_dir),
        )
        if proc.returncode != 0:
            fail(f"zero-recompile child: exit {proc.returncode}: "
                 f"{proc.stderr[-3000:]}")
        z = json.loads(proc.stdout.strip().splitlines()[-1])
        z["process_s"] = time.perf_counter() - t0
        add(z["launches"], z["ranked"])
        log(f"zero-recompile (seed 11, 60 steps, light, fresh process): "
            f"prewarm {z['prewarm']}; compiles {z['warm']['compiles_total']} "
            f"-> {z['steady']['compiles_total']}, hits "
            f"{z['warm']['cache_hits_total']} -> {z['steady']['cache_hits_total']}, "
            f"escaped {z['escaped']}, libraries built {z['builds']} and loaded "
            f"{z['loads']} after prewarm; storm {z['storm_s']:.2f}s, process "
            f"{z['process_s']:.2f}s")
        if (z["steady"]["compiles_total"] != z["warm"]["compiles_total"]
                or z["escaped"]):
            fail(f"zero-recompile: shape escape {z['escaped']}")
        if z["builds"] or z["loads"]:
            fail("zero-recompile: a library was built or loaded after prewarm")
        if z["steady"]["cache_hits_total"] <= z["warm"]["cache_hits_total"]:
            fail("zero-recompile: the storm dispatched nothing")
        # (f) the CLI with --prewarm on phase 10's stub: a first start
        # records what it serves, the second warms it
        cli_dir = os.path.join(work, "cli")
        shutil.copytree(cache, cli_dir, ignore=libraries_only)
        starts = []
        for i in (1, 2):
            got, _ = run_cli("cuda", CLI_NODES, PREWARM_CLI_PODS, work,
                             f"cuda-prewarm-{i}", extra_args=["--prewarm"],
                             extra_env={"NHDC_AOT_DIR": cli_dir})
            if got["bound"] != PREWARM_CLI_PODS or not got["prewarm_line"]:
                fail(f"cli --prewarm start {i}: bound {got['bound']}, "
                     f"prewarm line {got['prewarm_line']!r}")
            add(got["launches"], ranked_uses(jit_shapes(got["jit"])))
            starts.append(got)
            log(f"cli --prewarm start {i} ({CLI_NODES} nodes, "
                f"{PREWARM_CLI_PODS} pods): {got['prewarm_line']}; up "
                f"{got['ready_s']:.2f}s after start (phase 10 without "
                f"--prewarm: {report['cli']['cuda']['ready_s']:.2f}s); "
                f"start-up marks {got['startup_s']} (phase 10: "
                f"{report['cli']['cuda']['startup_s']}); first bind "
                f"{got['first_bind_s']:.3f}s after the first pod; {smi}")
    # speculative binds and prewarms on one card; rank_top where a bind
    # took a classic round or a prewarm warmed a ranked key
    require_launched("prewarm", phase, SPEC_PATH)
    add_launches(launches_total, phase)
    out.update(cold=cold, restart=restart, prewarmed=warm, damaged=fixed,
               zero_recompile=z, cli=starts, launches=phase)
    report["prewarm"] = out


def shard_kernels(torch, report, cluster, buckets):
    """Phase 13 (a): the solve kernels on each shard of an 8-way mesh of
    cfg4's resident state on the card, against their plain versions (and
    solve_planes against the unsharded planes' columns); solve_planes at
    node_base 0 is its old output; shard 3 timed beside its bound and
    the empty launch."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.kernels import reference
    from nhd_tpu_torch.parallel.sharding import make_mesh
    from nhd_tpu_torch.solver import kernel as kernel_mod
    from nhd_tpu_torch.solver.device_state import DeviceClusterState

    dev = card(torch)
    S = CFG6[2]
    state = DeviceClusterState(cluster, dev, make_mesh(n_shards=S, device=dev.type))
    one = DeviceClusterState(cluster, dev)
    Ns, floors, out, parts = state.shard_rows, build_floors(), {}, []
    for G, pods in sorted(buckets.items()):
        args, _ = stage(kernel_mod, reference, one.tensors(),
                        one.pod_tensors(pods))["solve_planes"]
        old = kernels.solve_planes(*args)
        explicit = kernels.solve_planes(*args, node_base=0, n_global=one.Np)
        full = reference.solve_planes(*args)
        torch.cuda.synchronize()
        if not (torch.equal(old, explicit) and torch.equal(old, full)):
            fail(f"mesh: solve_planes at node_base 0 is not its old output (G={G})")
        for s, node in enumerate(state.shard_tensors()):
            staged = stage(kernel_mod, reference, node, state.pod_tensors(pods))
            place = dict(node_base=s * Ns, n_global=state.Np)
            real = {"T": pods.n_types, "N": max(0, min(Ns, cluster.n_nodes - s * Ns))}
            label = f"cfg4 G={G} shard {s} of {S} (rows {s * Ns}-{(s + 1) * Ns - 1})"
            for name in kernels.SOLVE_KERNELS:
                args, kw = staged[name]
                kw = place if name == "solve_planes" else kw
                kfn, pfn = getattr(kernels, name), getattr(reference, name)
                got, want = kfn(*args, **kw), pfn(*args, **kw)
                torch.cuda.synchronize()
                err = max_abs_err(torch, got, want)
                if err != 0.0:
                    fail(f"{name} disagrees with its plain version at {label}: {err}")
                if name == "solve_planes" and not torch.equal(
                        got, full[:, :, s * Ns:(s + 1) * Ns]):
                    fail(f"mesh: solve_planes at {label} is not the unsharded "
                         "planes' columns")
                if s != 3:
                    continue
                ms = cuda_time_ms(torch, lambda: kfn(*args, **kw))
                plain_ms = cuda_time_ms(torch, lambda: pfn(*args, **kw))
                outs = got if isinstance(got, tuple) else (got,)
                bound_ms, bound_by, moved, ops = bounds(name, args, outs, real)
                fl = floor_ms(torch, floors, name, args, kw)
                out.setdefault(f"G={G}", {})[name] = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved,
                    "ops": ops, "floor_ms": fl,
                }
                log(f"mesh kernel {name} @ {label}: exact; {ms:.4f} ms (plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms by {bound_by}, "
                    f"empty launch {fl:.4f} ms)")
            # the shard's candidates: rank_top over its rows, indices global
            a = dict(zip(kernel_mod._ARG_ORDER, node))
            args = (got, a["gpu_free"], a["cpu_free"], a["hp_free"],
                    kernels.live_gate(dev))
            res, part = check_rank(torch, label, "rank_top", args,
                                   {"R": min(MESH_R, Ns), "node_base": s * Ns},
                                   real, timed=s == 3, floors=floors)
            parts.append(part)
            if s == 3:
                out[f"G={G}"]["rank_top"] = res
        # the merge of the shards' candidates: the unsharded rank, every slot
        cand = torch.cat(parts, dim=2)
        parts.clear()
        a = dict(zip(kernel_mod._ARG_ORDER, one.tensors()))
        whole = reference.rank_top(full, a["gpu_free"], a["cpu_free"],
                                   a["hp_free"], R=min(MESH_R, cand.shape[2]))
        out[f"G={G}"]["rank_merge"] = check_merge(
            torch, f"cfg4 G={G} over {S} shards", cand, whole,
            {"T": pods.n_types}, timed=True)
    log(f"mesh (a): the solve kernels and rank_top exact on all {S} shards of "
        "every cfg4 bucket; solve_planes' shards are the unsharded planes' "
        "columns; rank_merge exact, and equal to the unsharded rank at every slot")
    report["mesh"]["a"] = out


def mesh_child(rank, world, store):
    """Phase 13 (f), in one of *world* processes on the card: a gloo
    group over a FileStore, the global sharded solve over every
    process's shards (each process its own CUDA context on the card)
    against the one-process mesh and the single-device rank, and the
    region pattern against the CPU; prints one JSON line."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.parallel import multihost
    from nhd_tpu_torch.parallel.sharding import make_mesh, solve_bucket_ranked_sharded
    from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
    from nhd_tpu_torch.solver import BatchItem, StreamingScheduler
    from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods
    from nhd_tpu_torch.solver.kernel import solve_bucket_ranked

    dev = card(torch)
    multihost.initialize(f"file://{store}", num_processes=world,
                         process_id=rank, backend="gloo")
    cluster = encode_cluster(cap_cluster(CELL_NODES, GROUPS), now=0.0)
    buckets = encode_pods(workload_mix(CELL_PODS, GROUPS), cluster.interner)
    mesh = make_mesh([dev] * MESH_RANK_SHARDS, group=dist.group.WORLD)
    alone = make_mesh([dev] * mesh.size)
    t0 = time.perf_counter()
    for G, pods in sorted(buckets.items()):
        got = solve_bucket_ranked_sharded(cluster, pods, MESH_R, mesh)
        same = solve_bucket_ranked_sharded(cluster, pods, MESH_R, alone)
        one = solve_bucket_ranked(cluster, pods, MESH_R, device=dev).cpu().numpy()
        if not np.array_equal(got, same):
            raise SystemExit(f"rank {rank}: G={G} differs from the one-process mesh")
        if not np.array_equal(got, one):
            raise SystemExit(f"rank {rank}: G={G} differs from one device")
    solve_s = time.perf_counter() - t0
    # the region pattern (the reference's scenario): this rank's region of
    # a 16-node federation, 16 pods through the streaming tiler, on the
    # card and on the CPU (with speculation on, the card's default)
    placed, scheduled = {}, {}
    for device in ("cuda", "cpu"):
        region = multihost.local_nodes(cap_cluster(16, ["default"]))
        items = [BatchItem(("ns", f"r{rank}-p{i}"), r)
                 for i, r in enumerate(workload_mix(16, ["default"]))]
        with env(NHD_TPU_SPECULATE=None if device == "cuda" else "1"):
            res, stats = StreamingScheduler(
                tile_nodes=4, respect_busy=False,
                device=dev if device == "cuda" else device,
            ).schedule(region, items, now=0.0)
        placed[device] = [(r.node, r.nic_list) for r in res]
        scheduled[device] = stats.scheduled
    torch.cuda.synchronize()
    print(json.dumps({"rank": rank, "solve_s": solve_s, "placed": placed,
                      "scheduled": scheduled, "mine": sorted(region),
                      "launches": dict(kernels.LAUNCHES)}), flush=True)
    dist.destroy_process_group()
    return 0


def mesh_rank_check(torch, label, cluster, buckets, mesh):
    """``solve_bucket_ranked_sharded`` over *mesh* against the single-device
    rank on the lead shard's device: equal at every slot of every bucket
    (a shard's zero candidates are its lowest-index zero nodes, in order),
    at ``MESH_R``."""
    import numpy as np

    from nhd_tpu_torch.parallel.sharding import solve_bucket_ranked_sharded
    from nhd_tpu_torch.solver.kernel import solve_bucket_ranked

    for G, pods in sorted(buckets.items()):
        one = solve_bucket_ranked(cluster, pods, MESH_R,
                                  device=mesh.devices[0]).cpu().numpy()
        got = solve_bucket_ranked_sharded(cluster, pods, MESH_R, mesh)
        if not (got.shape == one.shape and np.array_equal(got, one)):
            fail(f"{label}: the rank over {mesh.size} shards differs from one "
                 f"device (G={G})")


@contextlib.contextmanager
def status_pulls():
    """While inside, every ``HostPull`` the megaround module makes (the
    host loop's pinned pull of the status, one an iteration) appends
    one to the yielded list."""
    from nhd_tpu_torch.solver import speculate

    pulls = []
    pull = speculate.HostPull

    class Counted(pull):
        def __init__(self, *a, **kw):
            pulls.append(1)
            super().__init__(*a, **kw)

    speculate.HostPull = Counted
    try:
        yield pulls
    finally:
        speculate.HostPull = pull


def mesh_batch(torch, label, mesh, items, speculative):
    """cfg4's batch through ``BatchScheduler(mesh=)`` on the card, the
    card's default (speculative) or classic: a warm schedule, then one
    counted. Fails unless a dispatch ran on the mesh and every kernel of
    the path launched: classic, the solve kernels on each shard, rank_top
    on each and rank_merge; speculative, the megaround's kernels and the
    rank kernels if a classic round followed, with round 0 one graph
    replay over the shards (one ``megaround_graph``, 1 + iterations of
    ``spec_gate``, one ``spec_fill`` and S of ``spec_elect`` and
    ``spec_apply`` a pass, no status pull). Returns (scheduler, nodes,
    results, stats, wall, launches)."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.obs.jitstats import JIT_STATS
    from nhd_tpu_torch.sim.workloads import cap_cluster
    from nhd_tpu_torch.solver import BatchScheduler
    from nhd_tpu_torch.solver.kernel import mesh_desc

    nodes = cap_cluster(CELL_NODES, GROUPS)
    sched = BatchScheduler(device=mesh.devices[0], respect_busy=False,
                           register_pods=False, mesh=mesh)
    with env(NHD_TPU_SPECULATE=None if speculative else "0"):
        sched.schedule(nodes, items, now=0.0)  # warm
        for n in nodes.values():
            n.reset_resources()
        JIT_STATS.reset()
        with status_pulls() as pulls:
            (results, stats), wall, launches = counted(
                torch, lambda: sched.schedule(nodes, items, now=0.0))
    shapes = JIT_STATS.snapshot()["shapes"]
    if not any(k.endswith(f"_M{mesh_desc(mesh)}") for k in shapes):
        fail(f"{label}: no dispatch ran on the mesh: {sorted(shapes)}")
    path = SPEC_PATH if speculative else kernels.SOLVE_KERNELS + kernels.RANK_KERNELS
    require_launched(label, launches, path, mesh=True)
    spec_it = stats.counters.get("spec_iterations", 0)
    if speculative:
        want = {kernels.GRAPH: 1, kernels.GATE_KERNEL: 1 + spec_it,
                "spec_fill": spec_it, "spec_elect": mesh.size * spec_it,
                "spec_apply": mesh.size * spec_it}
        got = {k: launches[k] for k in want}
        if got != want or pulls or not spec_it:
            fail(f"{label}: round 0 was not one graph replay of {spec_it} passes "
                 f"over {mesh.size} shards: {got}, {len(pulls)} status pulls")
    elif launches[kernels.GRAPH] or spec_it:
        fail(f"{label}: NHD_TPU_SPECULATE=0 ran the megaround")
    return sched, nodes, results, stats, wall, launches


def mesh_children(label, world):
    """Run ``mesh_child`` in *world* processes at once (one gloo group
    over a FileStore in a temporary directory); their JSON lines, in rank
    order. Fails on a child's non-zero exit or a 300 s timeout."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="nhd-mesh-") as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             "import sys, chip_smoke; sys.exit(chip_smoke.mesh_child("
             "int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]))",
             str(rank), str(world), os.path.join(tmp, "store")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        ) for rank in range(world)]
        try:
            got = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    children = []
    for rank, (p, (so, se)) in enumerate(zip(procs, got)):
        if p.returncode != 0:
            fail(f"{label}: rank {rank} exited {p.returncode}: {se[-2000:]}")
        children.append(json.loads(so.strip().splitlines()[-1]))
    return children


def mesh_phase(torch, report, launches_total, smi):
    """Phase 13: the node mesh on the card (module docstring, parts a-g)."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.obs.jitstats import JIT_STATS
    from nhd_tpu_torch.parallel.sharding import make_mesh
    from nhd_tpu_torch.parallel.spmd_bench import run_probe
    from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
    from nhd_tpu_torch.solver import BatchItem, BatchScheduler, guard, speculate
    from nhd_tpu_torch.solver import kernel as kernel_mod
    from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods
    from nhd_tpu_torch.solver.guard import GUARD, RUNG_NAMES, RUNG_SINGLE

    dev = card(torch)
    report["mesh"] = out = {}
    phase = dict.fromkeys(kernels.COUNTED, 0)

    def count(launches):
        for k in kernels.COUNTED:
            phase[k] += launches.get(k, 0)

    cluster = encode_cluster(cap_cluster(CELL_NODES, GROUPS), now=0.0)
    cluster.busy[:] = False
    buckets = encode_pods(workload_mix(CELL_PODS, GROUPS), cluster.interner)
    t = {"a": time.perf_counter()}
    shard_kernels(torch, report, cluster, buckets)

    # (b) the sharded rank on 2, 4 and 8 shards of cuda:0
    t["b"] = time.perf_counter()
    for S in MESH_SHARDS:
        mesh_rank_check(torch, "mesh (b)", cluster, buckets,
                        make_mesh(n_shards=S, device=dev.type))
    log(f"mesh (b): solve_bucket_ranked_sharded at cfg4 over {MESH_SHARDS} shards "
        f"of cuda:0 equals the single-device rank at every slot "
        f"(R={MESH_R}, buckets {sorted(buckets)})")

    # (c) cfg4 through BatchScheduler over a 4-shard mesh
    t["c"] = time.perf_counter()
    mesh = make_mesh(n_shards=MESH_BATCH_SHARDS, device=dev.type)
    desc = kernel_mod.mesh_desc(mesh)
    items = [BatchItem(("ns", f"p{i}"), r)
             for i, r in enumerate(workload_mix(CELL_PODS, GROUPS))]
    out["c"] = {}
    for name, speculative in (("cfg4:10kx1k-cap", True),
                              ("cfg4:10kx1k-cap classic", False)):
        label = f"{name} mesh {desc}"
        sched, nodes, results, stats, wall, launches = mesh_batch(
            torch, label, mesh, items, speculative)
        count(launches)
        single, cpu = RESULTS[name]
        same_placements(label, results, single, "the single-device card run")
        same_placements(label, results, cpu, "the CPU run")
        spec_it = stats.counters.get("spec_iterations", 0)
        cell = report["cells"][name]
        if (stats.rounds, spec_it) != (cell["rounds"], cell["megaround_iterations_run"]):
            fail(f"{label}: rounds / megaround iterations {stats.rounds} / {spec_it}"
                 f" differ from one device's {cell['rounds']} / "
                 f"{cell['megaround_iterations_run']}")
        placed = sum(1 for r in results if r.node)
        out["c"][name] = {"wall_s": wall, "rounds": stats.rounds,
                          "megaround_iterations": spec_it, "launches": launches,
                          "placed": placed, "one_device_wall_s": cell["wall_s"],
                          "one_device_launches": cell["launches"],
                          "megaround_ms": stats.phases.get("spec_dispatch", 0.0) * 1e3}
        log(f"{label}: placed {placed}/{len(items)} as one card and as the CPU "
            f"(node, mapping, NICs); rounds={stats.rounds} megaround iterations="
            f"{spec_it} megaround={out['c'][name]['megaround_ms']:.3f}ms (one card: "
            f"{cell['megaround_ms']:.3f}ms) wall={wall:.4f}s (one card: "
            f"{cell['wall_s']:.4f}s) "
            f"launches={launches} (one card: {cell['launches']})")
        if speculative:
            # every claim-kernel and gate call of the mesh megaround's
            # fixed trip once more (not counted): each against its plain
            # version, spec_elect and spec_apply at a shard's shapes,
            # spec_fill over the joined plan; the first call of each timed
            # (shard 0: all rows real)
            for n in nodes.values():
                n.reset_resources()
            calls = []
            speculate.REPLAY = False  # a replay runs no Python to spy on
            try:
                with env(NHD_TPU_SPECULATE=None), spy_claims(calls):
                    again, _ = sched.schedule(nodes, items, now=0.0)
            finally:
                speculate.REPLAY = True
            same_placements(label, again, results, "its counted run")
            floors = build_floors()
            shard = [c for c in calls if c[0] in ("spec_elect", "spec_apply")]
            joined = [c for c in calls if c[0] in ("spec_fill", "spec_gate")]
            out["claims"] = {
                "shard": check_claims(torch, f"{label} shard 0", shard, report,
                                      {"N": min(CELL_NODES, kernel_mod.pad_nodes(
                                          CELL_NODES, MESH_BATCH_SHARDS)
                                          // MESH_BATCH_SHARDS)},
                                      timed=True, floors=floors),
                "joined": check_claims(torch, f"{label} joined plan", joined,
                                       report, {"N": CELL_NODES}, timed=True,
                                       floors=floors),
            }
            log(f"{label}: all {len(calls)} claim-kernel and gate calls of the "
                f"mesh megaround's fixed trip exact ({len(shard)} at shard shapes, "
                f"{len(joined)} over the joined plan or the shared status)")

    # (d) the port's cfg6 probe
    t["d"] = time.perf_counter()
    rec, wall, launches = counted(
        torch, lambda: run_probe(*CFG6[:3], CFG6[3], device=dev.type))
    count(launches)
    out["d"] = {**rec, "probe_s": wall, "launches": launches}
    sp = rec["spmd"]
    log(f"mesh (d) cfg6 probe {CFG6[0]} pods x {CFG6[1]} nodes over {sp['shards']} "
        f"shards on {sp['distinct_devices']} device(s): parity ok; gang wall "
        f"{rec['wall']:.4f}s, rounds {rec['rounds']}, p99 bind "
        f"{rec['p99_bind_ms']:.1f} ms; churn rows {sp['rows_uploaded']} "
        f"(mesh {sp['mesh_rows_uploaded']}, budget {sp['upload_budget']}), "
        f"wholesale {sp['wholesale_uploads']}; prewarm {sp['prewarm_loaded']} keys "
        f"({sp['mesh_keys_loaded']} mesh), solve_ranked flat; {wall:.1f}s")

    # (e) the guard's mesh rung: one megaround fault on the 4-shard mesh
    t["e"] = time.perf_counter()
    GUARD.reset()
    inj = _DispatchFault(1, "megaround")
    guard.set_fault_injector(inj)
    try:
        with env(NHD_GUARD_RETRIES="1", NHD_TPU_SPECULATE=None):
            JIT_STATS.reset()
            (res, stats), wall, launches = counted(torch, lambda: BatchScheduler(
                device=dev, respect_busy=False, register_pods=False, mesh=mesh,
            ).schedule(cap_cluster(CELL_NODES, GROUPS), items, now=0.0))
        floor, allow_mesh = GUARD.floor, GUARD.allow_mesh()
    finally:
        guard.set_fault_injector(None)
        GUARD.reset()
    if inj.left:
        fail("mesh (e): the injected megaround fault never fired")
    if floor != RUNG_SINGLE or allow_mesh:
        fail(f"mesh (e): floor {RUNG_NAMES[floor]} after a mesh megaround fault")
    single_keys = [k for k in JIT_STATS.snapshot()["shapes"]
                   if k.startswith("solve_ranked:") and "_M" not in k]
    if not single_keys:
        fail("mesh (e): the round did not re-dispatch on one device")
    require_launched("mesh (e) after the fault", launches, kernels.SOLVE_KERNELS)
    count(launches)
    same_placements("mesh (e)", res, RESULTS["cfg4:10kx1k-cap classic"][0],
                    "the fault-free classic run (a faulted batch never speculates "
                    "again)")
    out["e"] = {"wall_s": wall, "rounds": stats.rounds, "launches": launches}
    log(f"mesh (e): one megaround fault on the {desc} mesh condemned it (floor "
        f"{RUNG_NAMES[floor]}); the batch re-dispatched on one device "
        f"({len(single_keys)} single-device solve keys) and placed every pod as "
        f"the fault-free classic run; wall {wall:.4f}s, {stats.rounds} rounds")

    # (f) two processes on the card over gloo
    t["f"] = time.perf_counter()
    children = mesh_children("mesh (f)", MESH_RANKS)
    for c in children:
        if not c["scheduled"]["cuda"]:
            fail(f"mesh (f): rank {c['rank']} placed nothing in its region")
        if c["placed"]["cuda"] != c["placed"]["cpu"]:
            fail(f"mesh (f): rank {c['rank']}'s region placed differently on cuda "
                 "and cpu")
        if not all(node in c["mine"] for node, _ in c["placed"]["cuda"] if node):
            fail(f"mesh (f): rank {c['rank']} placed outside its region")
    regions = [set(c["mine"]) for c in children]
    if set.intersection(*regions) or len(set.union(*regions)) != 16:
        fail("mesh (f): the ranks' regions are not an exact cover")
    out["f"] = children
    log(f"mesh (f): {MESH_RANKS} processes x {MESH_RANK_SHARDS} shards on cuda:0 over "
        f"gloo: the global sharded solve equals the one-process mesh and one "
        f"device (solve {[round(c['solve_s'], 3) for c in children]} s); each "
        f"region placed as on the CPU, an exact cover")

    # (g) the mesh's megaround graph alone, at cfg4 over 4 shards and cfg6
    # over 8, against its host loop, its fixed trip, the plain versions
    # and the CPU, with its replay timed
    t["g"] = time.perf_counter()
    cfg6 = encode_cluster(cap_cluster(CFG6[1], CFG6_GROUPS), now=0.0)
    cfg6.busy[:] = False
    catalog = workload_mix(256, CFG6_GROUPS)
    out["g"] = {
        f"cfg4:10kx1k-cap over {MESH_BATCH_SHARDS}": mesh_graph(
            torch, f"mesh (g) cfg4 over {MESH_BATCH_SHARDS} shards", cluster,
            list(buckets.values()), MESH_BATCH_SHARDS, smi),
        f"cfg6:4kx1k-spmd over {CFG6[2]}": mesh_graph(
            torch, f"mesh (g) cfg6 over {CFG6[2]} shards", cfg6,
            list(encode_pods([catalog[i % len(catalog)] for i in range(CFG6[0])],
                             cfg6.interner).values()), CFG6[2], smi),
    }
    stats = speculate.graph_stats()
    out["graphs"] = stats
    log(f"mesh: the process's megaround graphs after the phase: {stats['entries']} "
        f"entries (at most {speculate.MegaroundCache.MAX_ENTRIES}), "
        f"{stats['captures']} captured, {stats['dispatches']} dispatches, "
        f"{stats['replays']} replays")

    t["end"] = time.perf_counter()
    # the mesh's megaround is one graph over the shards, spec_gate in it;
    # (c)'s classic batch ranks on every shard and merges
    for k in SPEC_PATH + kernels.RANK_KERNELS:
        if phase[k] == 0:
            fail(f"mesh: kernel {k} was never launched in the phase")
    add_launches(launches_total, phase)
    steps = "abcdefg"
    out["seconds"] = {p: (t[steps[i + 1]] if i + 1 < len(steps) else t["end"]) - t[p]
                      for i, p in enumerate(steps)}
    out["launches"] = phase
    log(f"mesh: phase 13 in {t['end'] - t['a']:.1f}s of command time "
        f"({ {k: round(v, 1) for k, v in out['seconds'].items()} }); launches in "
        f"the phase {phase}; every number: {smi}; one card, so no multi-GPU speed")


def mesh_graph(torch, label, cluster, bucket_pods, S, smi):
    """Phase 13 (g) at one cell: the megaround of *cluster*'s encoded
    state and *bucket_pods*' whole need over S shards of the card, as the
    mesh's graph (a cache of its own, so its first dispatch captures),
    its fixed trip (``speculate.REPLAY`` off), its host loop, the host
    loop through the plain versions on the card and the graph's loop on S
    shards of the CPU: claims, counts, need left, iterations and every
    shard's node state bit for bit. Then the passes the WHILE node runs,
    counted on the card (``passes_of``): the iterations live, none with
    no need; the body's tally (S of each solve kernel a bucket, of
    spec_elect and spec_apply, one spec_fill and one spec_gate); the
    host loop, the graph, the graph with no need and one card's graph of
    the same cell in turns from the starting state (``GRAPH_TIMED``
    each: host wall per dispatch, wall to its end, CUDA-event device
    time); the replay alone, live and with no need (medians of
    ``GRAPH_TIMED``); and the dispatch's host parts. Returns the cell's
    numbers."""
    import numpy as np

    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.parallel.sharding import make_mesh
    from nhd_tpu_torch.solver import speculate
    from nhd_tpu_torch.solver.device_state import DeviceClusterState
    from nhd_tpu_torch.solver.kernel import _ARG_ORDER, _MUTABLE, _pad_pow2
    from nhd_tpu_torch.solver.speculate import MegaroundCache, run_megaround_shards

    dev = card(torch)
    U, K, iters = cluster.U, cluster.K, speculate.spec_iters()
    needs = [np.bincount(p.pod_type, minlength=_pad_pow2(p.n_types)).astype(np.int32)
             for p in bucket_pods]
    zero = [np.zeros_like(n) for n in needs]
    meshes = {"cuda": make_mesh(n_shards=S, device=dev.type),
              "cpu": make_mesh([torch.device("cpu")] * S)}
    caches = {k: MegaroundCache() for k in ("graph", "fixed trip", "CPU", "one card")}

    def fresh(kind="cuda"):
        """The encoded state, resident anew: on the card's S shards, on
        the CPU's, or on the card unsharded (``one``)."""
        if kind == "one":
            return DeviceClusterState(cluster, dev)
        return DeviceClusterState(cluster, dev if kind == "cuda" else "cpu",
                                  meshes[kind])

    def loop(state, need=needs):
        tensors = [state.shard_pod_tensors(p) for p in bucket_pods]
        return run_megaround_shards(
            state.shards, bucket_pods, [[pt[s] for pt in tensors] for s in range(S)],
            need, U, K, iters, False)

    def graph(state, need=needs, cache=caches["graph"]):
        return cache.run(state.shards, bucket_pods, need, U, K, iters, False)

    def fixed(state):
        speculate.REPLAY = False
        try:
            return graph(state, cache=caches["fixed trip"])
        finally:
            speculate.REPLAY = True

    def plain(state):
        with plain_on_card():
            return loop(state)

    runs = {}
    for kind, fn, where in (("host loop", loop, "cuda"), ("graph", graph, "cuda"),
                            ("fixed trip", fixed, "cuda"),
                            ("plain on the card", plain, "cuda"),
                            ("CPU replay", lambda st: graph(st, cache=caches["CPU"]),
                             "cpu")):
        state = fresh(where)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(state)
        torch.cuda.synchronize()
        runs[kind] = ([t.cpu() for t in res]
                      + [sh[n].cpu() for sh in state.shards for n in _MUTABLE],
                      time.perf_counter() - t0)
    want = runs["host loop"][0]
    for kind, (got, _s) in runs.items():
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"{label}: the host loop and the {kind} differ")
    its = int(want[3])
    (entry,) = caches["graph"].entries()
    if entry.graph is None or len(entry.shards) != S:
        fail(f"{label}: the dispatch captured no graph over {S} shards")
    if caches["fixed trip"].entries()[0].graph is not None:
        fail(f"{label}: REPLAY off captured a graph")
    B = len(bucket_pods)
    body = {k: n for k, n in entry.body_tally.items() if n}
    want_body = {**{k: S * B for k in kernels.SOLVE_KERNELS}, "spec_elect": S,
                 "spec_apply": S, "spec_fill": 1, "spec_gate": 1}
    if body != want_body or {k: n for k, n in entry.tally.items() if n} != {
            "spec_gate": 1}:
        fail(f"{label}: a pass records {body} after {entry.tally}, expected "
             f"{want_body} after one spec_gate")

    # the passes the WHILE node runs, counted on the card by a body with
    # one more op: one a live iteration, none without need
    passes = graph_passes(torch, label,
                          lambda need, cache: graph(fresh(), need, cache),
                          needs, zero, its)

    # in turns from the starting state: the mesh's host loop, its graph
    # live and with no need, and one card's graph of the same cell
    states = {"host loop": fresh(), "graph": fresh(), "one card": fresh("one")}
    start = {k: [{n: t.clone() for n, t in sh.items()} for sh in st.shards]
             for k, st in states.items()}

    def reset(kind):
        which = {"graph, no need": "graph", "one card's graph": "one card"}.get(kind, kind)
        for sh, first in zip(states[which].shards, start[which]):
            for n in _MUTABLE:
                sh[n].copy_(first[n])

    med = in_turns(torch, (
        ("host loop", lambda: loop(states["host loop"])),
        ("graph", lambda: graph(states["graph"])),
        ("graph, no need", lambda: graph(states["graph"], zero)),
        ("one card's graph", lambda: graph(states["one card"],
                                           cache=caches["one card"]))), reset)
    parts = {k: round(v / entry.dispatches * 1e3, 4) for k, v in entry.host_s.items()}

    # the replay alone on the card, its buffers restored before each
    # launch, live and with no need
    Ns = int(start["graph"][0]["hp_free"].shape[0])
    replay_ms, _restore = replay_alone(
        torch, entry, bucket_pods, needs, zero, U, K,
        {n: torch.cat([sh[n] for sh in start["graph"]]) for n in _ARG_ORDER},
        n=GRAPH_TIMED)
    per_pass = (replay_ms["live"] - replay_ms["dead"]) / max(its, 1)
    cell = {"shards": S, "node_rows": S * Ns, "iterations": its, "passes": passes,
            "capture_s": entry.capture_s, "first_s": {k: v[1] for k, v in runs.items()},
            "medians": med, "replay_device_ms": replay_ms, "ms_per_pass": per_pass,
            "host_parts_ms": parts, "tally": entry.tally, "body_tally": body}
    log(f"{label} (Np={S * Ns}, {S} x {Ns} rows): graph == fixed trip == host loop "
        f"== plain on the card == the CPU's {S} shards (claims, counts, need left, "
        f"{its} iterations, node state); the node ran {passes['live'][0]} passes "
        f"counted on the card ({passes['no need'][0]} with no need); a pass "
        f"records {body}; capture {entry.capture_s * 1e3:.2f} ms (first "
        f"dispatches, s: { {k: round(v, 4) for k, v in cell['first_s'].items()} }); "
        f"medians of {GRAPH_TIMED}: "
        + "; ".join(f"{k} host {m['host_ms']:.3f} ms, wall {m['wall_ms']:.3f} ms, "
                    f"device {m['device_ms']:.4f} ms" for k, m in med.items())
        + f"; the replay alone on the card {replay_ms['live']:.4f} ms, with no need "
        f"{replay_ms['dead']:.4f} ms, so a pass {per_pass:.4f} ms; a dispatch's "
        f"host parts (mean ms) {parts}; {smi}")
    return cell


#: mesh_dispatch_child: schedules and megaround dispatches timed a tree
MESH_DISPATCH_RUNS = 20


def mesh_dispatch_child(root=ROOT):
    """The mesh's megaround dispatch on the card through the port in
    *root* (this checkout, or an earlier commit unpacked beside it, so
    that two versions are timed in one call), in a fresh process
    (``python -c``): cfg4:10kx1k-cap through ``BatchScheduler(mesh=4
    shards)`` as phase 13 (c) runs it, a warm schedule and then
    ``MESH_DISPATCH_RUNS`` more, each one's ``spec_dispatch`` and wall;
    then ``DeviceClusterState.megaround`` alone at cfg4 over 4 shards and
    cfg6 over 8, from the encoded state, warm and then
    ``MESH_DISPATCH_RUNS`` times (host time to its return, wall to its
    end). Prints one JSON line of medians."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import nhd_tpu_torch
    from nhd_tpu_torch.parallel.sharding import make_mesh
    from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
    from nhd_tpu_torch.solver import BatchItem, BatchScheduler
    from nhd_tpu_torch.solver.device_state import DeviceClusterState
    from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods
    from nhd_tpu_torch.solver.kernel import _MUTABLE, _pad_pow2

    dev = card(torch)
    out = {"root": os.path.dirname(os.path.abspath(nhd_tpu_torch.__file__)),
           "smi": smi_line()}
    mesh = make_mesh(n_shards=MESH_BATCH_SHARDS, device=dev.type)
    items = [BatchItem(("ns", f"p{i}"), r)
             for i, r in enumerate(workload_mix(CELL_PODS, GROUPS))]
    nodes = cap_cluster(CELL_NODES, GROUPS)
    sched = BatchScheduler(device=dev, respect_busy=False, register_pods=False,
                           mesh=mesh)
    spec, wall = [], []
    for r in range(MESH_DISPATCH_RUNS + 1):
        for n in nodes.values():
            n.reset_resources()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _res, stats = sched.schedule(nodes, items, now=0.0)
        torch.cuda.synchronize()
        if r:  # the first warms
            wall.append((time.perf_counter() - t0) * 1e3)
            spec.append(stats.phases.get("spec_dispatch", 0.0) * 1e3)
    out["cfg4 batch over 4"] = {"spec_dispatch_ms": statistics.median(spec),
                                "wall_ms": statistics.median(wall),
                                "spread_ms": [min(spec), max(spec)]}
    cfg6 = encode_cluster(cap_cluster(CFG6[1], CFG6_GROUPS), now=0.0)
    catalog = workload_mix(256, CFG6_GROUPS)
    cfg4 = encode_cluster(cap_cluster(CELL_NODES, GROUPS), now=0.0)
    for label, cluster, reqs, S in (
            ("cfg4 megaround over 4", cfg4, workload_mix(CELL_PODS, GROUPS),
             MESH_BATCH_SHARDS),
            ("cfg6 megaround over 8", cfg6,
             [catalog[i % len(catalog)] for i in range(CFG6[0])], CFG6[2])):
        cluster.busy[:] = False
        buckets = list(encode_pods(reqs, cluster.interner).values())
        needs = [np.bincount(p.pod_type, minlength=_pad_pow2(p.n_types)).astype(np.int32)
                 for p in buckets]
        state = DeviceClusterState(cluster, dev, make_mesh(n_shards=S, device=dev.type))
        start = [{n: sh[n].clone() for n in _MUTABLE} for sh in state.shards]
        host, wall = [], []
        for r in range(MESH_DISPATCH_RUNS + 1):
            for sh, first in zip(state.shards, start):
                for n in _MUTABLE:
                    sh[n].copy_(first[n])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = state.megaround(buckets, needs, False)
            t1 = time.perf_counter()
            its = int(res[3])
            torch.cuda.synchronize()
            if r:
                host.append((t1 - t0) * 1e3)
                wall.append((time.perf_counter() - t0) * 1e3)
        out[label] = {"iterations": its, "host_ms": statistics.median(host),
                      "wall_ms": statistics.median(wall)}
    print(json.dumps(out), flush=True)
    return 0


def race_child(workdir):
    """Phase 14, in a fresh process: nhdsan installed before any port
    module builds a lock (torch first, so its own stay raw), then (a)
    phase 11's cells through the storm on cuda under ``NHD_RACE=1``, (b)
    the tiler's three tiles of cfg5 on cuda under nhdrace, (c) one cell
    with ``NHD_RACE_INJECT=1``. Writes race.json into *workdir*."""
    import torch

    os.environ.update(RACE_ENV)
    from nhd_tpu_torch.sanitizer import install

    san = install()
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.sanitizer import install_races, uninstall_races
    from nhd_tpu_torch.sim import storm

    def run_storm(label, seeds, nodes, steps):
        path = os.path.join(workdir, label + ".json")
        (rc, _), wall, launches = counted(torch, lambda: (storm.main([
            "--profiles", "device-faults", "--seeds", str(seeds),
            "--steps", str(steps), "--nodes", str(nodes), "--device-plane",
            "--bind-parity", "--device", "cuda", "--json-out", path,
        ]), None))
        with open(path) as fh:
            summary = json.load(fh)
        return {"rc": rc, "wall_s": wall, "launches": launches,
                "ok": summary["ok"],
                "races": [r["key"] for r in summary["races"]["races"]],
                "watched": summary["races"]["watched_fields"],
                "cells": [{k: c.get(k) for k in (
                    "seed", "ok", "bind_parity", "bound_set",
                    "faults_by_site")} for c in summary["cells"]]}

    out = {"storms": {label: run_storm(label, seeds, nodes, steps)
                      for label, seeds, nodes, steps in CHAOS_CELLS}}
    # (b) the tiler: warm on one tile's worth of nodes, then counted
    rs = install_races()
    rem = FED_NODES % FED_SPLIT_TILE
    streamer("cuda", FED_SPLIT_TILE).schedule(
        fed_nodes(FED_SPLIT_TILE + rem), fed_items(FED_WARM_PODS, "w"),
        now=0.0)
    split = streamer("cuda", FED_SPLIT_TILE)
    nodes, items = fed_nodes(), fed_items(RACE_TILER_PODS)
    with spans(split) as got:
        (res, _), wall, launches = counted(
            torch, lambda: split.schedule(nodes, items, now=0.0))
    uninstall_races()
    rep = rs.report()
    out["tiler"] = {
        "wall_s": wall, "launches": launches,
        "placed": [repr(p) for p in placed_as(res)],
        "threads": len({t for t, c, _w in got["calls"] if any(c.values())}),
        "races": [r["key"] for r in rep["races"]],
        "watched": rep["watched_fields"]}
    # (c) the negative control: the injected race must be reported
    os.environ["NHD_RACE_INJECT"] = "1"
    out["control"] = run_storm("control", *RACE_CONTROL)
    del os.environ["NHD_RACE_INJECT"]
    report = san.report()
    out["cycles"] = report["cycles"]
    out["hold_while_blocking"] = [
        {k: w.get(k) for k in ("blocking", "at", "held", "count")}
        for w in report["hold_while_blocking"]]
    out["locks"] = len(report["locks"])
    with open(os.path.join(workdir, "race.json"), "w") as fh:
        json.dump(out, fh)
    return 0


def race_phase(torch, report, launches_total, smi):
    """Phase 14: the port's nhdsan and nhdrace on the card (module
    docstring, parts a-c)."""
    import tempfile

    from nhd_tpu_torch import kernels

    dev = card(torch)
    out = {"smi": smi}
    with tempfile.TemporaryDirectory(prefix="nhd-race-") as work:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "import sys, chip_smoke; "
             "sys.exit(chip_smoke.race_child(sys.argv[1]))", work],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=ROOT)
        try:
            # (b)'s plain leg, in this process (warm since phase 9), while
            # the child starts up (its storms come after its imports)
            split = streamer(dev, FED_SPLIT_TILE)
            nodes, items = fed_nodes(), fed_items(RACE_TILER_PODS)
            (res, _), plain_wall, plain_launches = counted(
                torch, lambda: split.schedule(nodes, items, now=0.0))
            plain = [repr(p) for p in placed_as(res)]
            del nodes, res
            text, _ = proc.communicate(timeout=RACE_CHILD_S)
        except subprocess.TimeoutExpired:
            fail(f"race (a-c): the child ran past {RACE_CHILD_S} s")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        child_s = time.perf_counter() - t0
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "race-child.log"), "w") as fh:
            fh.write(text)
        if proc.returncode != 0:
            fail(f"race (a-c): the child exited {proc.returncode}: "
                 f"{text[-2000:]}")
        with open(os.path.join(work, "race.json")) as fh:
            got = json.load(fh)
    phase = dict.fromkeys(kernels.COUNTED + (RANKED,), 0)

    def launched_all(label, launches):
        # phase 11's storms and phase 9's tiles: speculative on one card;
        # rank_top where a classic round ran
        require_launched(label, launches, SPEC_PATH)
        for k in phase:
            phase[k] += launches.get(k, 0)

    # (a) phase 11's cells: bound as the uninstrumented card run, 0 races
    for label, seeds, nodes_n, steps in CHAOS_CELLS:
        leg, ref = got["storms"][label], report["chaos"][label]["cuda"]
        if leg["rc"] != 0 or not leg["ok"]:
            fail(f"race (a) {label}: the storm failed under nhdsan/nhdrace "
                 f"(exit {leg['rc']}, races {leg['races']})")
        if leg["races"]:
            fail(f"race (a) {label}: race witnesses {leg['races']}")
        for c, rc in zip(leg["cells"], ref["cells"], strict=True):
            for key in ("bound_set", "faults_by_site"):
                if c[key] != rc[key]:
                    fail(f"race (a) {label} seed {c['seed']}: {key} differs "
                         f"from phase 11's uninstrumented card run")
        launched_all(f"race (a) {label}", leg["launches"])
        log(f"race (a) {label}: {seeds} seed(s) x {steps} steps x {nodes_n} "
            f"nodes on cuda under NHD_RACE=1 NHD_SAN=1: bound sets and faults "
            f"by site equal phase 11's uninstrumented run, 0 race witnesses "
            f"({len(leg['watched'])} watched fields); wall {leg['wall_s']:.2f}s "
            f"instrumented against {ref['wall_s']:.2f}s plain "
            f"({leg['wall_s'] / ref['wall_s']:.2f}x); launches "
            f"{leg['launches']}; {smi}")
        out[label] = {"wall_s": leg["wall_s"], "plain_wall_s": ref["wall_s"],
                      "launches": leg["launches"],
                      "watched": len(leg["watched"])}
    # (b) the tiler under nhdrace: placed as the plain run, 0 races
    tiler = got["tiler"]
    if tiler["placed"] != plain:
        diff = sum(a != b for a, b in zip(tiler["placed"], plain))
        fail(f"race (b): {diff} pods placed differently under nhdsan/nhdrace")
    if tiler["races"]:
        fail(f"race (b): race witnesses {tiler['races']}")
    if not any(k.endswith("BatchStats.rounds") for k in tiler["watched"]):
        fail("race (b): the tiler's merge state was not watched")
    if tiler["threads"] < 2:
        fail(f"race (b): the tiles launched from {tiler['threads']} thread(s)")
    launched_all("race (b)", tiler["launches"])
    log(f"race (b) tiler: {FED_NODES} cfg5 nodes in tiles of {FED_SPLIT_TILE}, "
        f"{RACE_TILER_PODS} pods ({STREAM_DAEMON_CUT}), {tiler['threads']} tile "
        f"threads launching on cuda under nhdsan/nhdrace: placements equal the "
        f"plain run, 0 race witnesses; wall {tiler['wall_s']:.4f}s instrumented "
        f"against {plain_wall:.4f}s plain ({tiler['wall_s'] / plain_wall:.2f}x); "
        f"launches {tiler['launches']} (plain {plain_launches}); {smi}")
    out["tiler"] = {"wall_s": tiler["wall_s"], "plain_wall_s": plain_wall,
                    "threads": tiler["threads"], "launches": tiler["launches"]}
    # (c) the negative control, and no cycle over the child's life
    control = got["control"]
    if control["rc"] == 0 or control["races"] != [
            "sanitizer/races:_InjectedRace.counter"]:
        fail(f"race (c): the injected race was not reported "
             f"(exit {control['rc']}, races {control['races']})")
    if got["cycles"]:
        fail(f"race: {len(got['cycles'])} wait-for-graph cycle(s): "
             f"{got['cycles'][:1]}")
    log(f"race (c) control (NHD_RACE_INJECT=1, seed 0, 4 nodes, "
        f"{RACE_CONTROL[2]} steps): "
        f"exit {control['rc']}, reported {control['races']}; over the child "
        f"0 cycle witnesses, hold-while-blocking sites "
        f"{got['hold_while_blocking']}, {got['locks']} instrumented locks; "
        f"child process "
        f"{child_s:.1f}s; {smi}")
    add_launches(launches_total, phase)
    out.update(control=control["races"], cycles=0, child_s=child_s,
               hold_while_blocking=got["hold_while_blocking"],
               launches=phase)
    report["race"] = out


@contextlib.contextmanager
def plain_on_card():
    """While inside, every kernel wrapper takes its plain version, on the
    card's tensors too (a check, never the port's path)."""
    from nhd_tpu_torch import kernels

    on_cpu = kernels._on_cpu
    kernels._on_cpu = lambda t: True
    try:
        yield
    finally:
        kernels._on_cpu = on_cpu


@contextlib.contextmanager
def passes_of(torch, dev):
    """While inside, a megaround graph captured (a fresh cache's) has one
    more op in its WHILE body, the first: one added to the yielded
    counter on the card, so a replay counts the passes the node ran."""
    from nhd_tpu_torch.solver import speculate

    passes = torch.zeros(1, dtype=torch.int32, device=dev)
    iteration = speculate.megaround_iteration

    def counted(*args, **kw):
        passes.add_(1)
        return iteration(*args, **kw)

    speculate.megaround_iteration = counted
    try:
        yield passes
    finally:
        speculate.megaround_iteration = iteration


def graph_passes(torch, label, dispatch, needs, zero, its):
    """The passes a WHILE node runs, counted on the card by a body with
    one more op (``passes_of``, in a fresh cache's graph): *dispatch(need,
    cache)* from the starting state, warm, live and with no need. Fails
    unless the node ran one pass a live iteration (*its*) and none
    without need; returns {kind: (passes counted, iteration word)}."""
    from nhd_tpu_torch.solver.speculate import MegaroundCache

    passes = {}
    with passes_of(torch, card(torch)) as counter:
        counting = MegaroundCache()
        for kind, need in (("warm", zero), ("live", needs), ("no need", zero)):
            torch.cuda.synchronize()
            counter.zero_()
            res = dispatch(need, counting)
            torch.cuda.synchronize()
            passes[kind] = (int(counter), int(res[3]))
    if passes["live"] != (its, its) or passes["no need"] != (0, 0):
        fail(f"{label}: the WHILE node ran passes (counted, iteration word) "
             f"{passes}, expected ({its}, {its}) live and (0, 0) with no need")
    return passes


def in_turns(torch, plan, restore):
    """Each dispatch of *plan* ((kind, call) pairs) ``GRAPH_TIMED`` times,
    in turns whose order reverses every other round, *restore(kind)*
    before each: by kind, the medians of the host wall to the call's
    return, the wall to its end and its CUDA-event device time."""
    times = {k: {"host_ms": [], "wall_ms": [], "device_ms": []} for k, _ in plan}
    for r in range(GRAPH_TIMED):
        for kind, call in (plan if r % 2 == 0 else plan[::-1]):
            restore(kind)
            torch.cuda.synchronize()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            s.record()
            call()
            e.record()
            host = time.perf_counter() - t0
            torch.cuda.synchronize()
            times[kind]["host_ms"].append(host * 1e3)
            times[kind]["wall_ms"].append((time.perf_counter() - t0) * 1e3)
            times[kind]["device_ms"].append(s.elapsed_time(e))
    return {k: {m: statistics.median(v) for m, v in t.items()} for k, t in times.items()}


def replay_alone(torch, entry, bucket_pods, needs, zero, U, K, start, n=N_TIMED):
    """The replay of *entry*'s graph alone on the card, live and with no
    need, *n* times each (``cuda_time_ms``), its buffers restored before
    each launch: the table buffer filled for that need, the node copy
    from *start* ([Np] tensors by name). Returns the median ms by kind
    and the restore."""
    from nhd_tpu_torch.solver import speculate
    from nhd_tpu_torch.solver.kernel import _ARG_ORDER

    Ns = int(start["hp_free"].shape[0]) // len(entry.shards)
    shapes = speculate._shapes(bucket_pods)
    tables = {}
    for kind, need in (("live", needs), ("dead", zero)):
        entry.buf.fill(speculate.trip_arrays(bucket_pods, need, shapes, U, K, Ns))
        tables[kind] = entry.buf.dev.clone()
    entry._digest = None  # filled by hand: the next dispatch rebuilds

    def restore(kind):
        entry.buf.dev.copy_(tables[kind])
        for k in _ARG_ORDER:
            entry.node[k].copy_(start[k])

    replay = entry.loop if entry.graph is None else entry.graph.replay
    return {kind: cuda_time_ms(torch, replay, n=n, prep=functools.partial(restore, kind))
            for kind in ("live", "dead")}, restore


def replay_kernels(torch, replay, prep):
    """One replay under torch.profiler (its buffers restored by *prep*
    first): the device kernels it records by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prep()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        replay()
        torch.cuda.synchronize()
    names = collections.Counter(
        e.name for e in prof.events() if e.device_type == DeviceType.CUDA)
    return {k[:80]: n for k, n in sorted(names.items())}


def replay_profile_child():
    """Phase 15's profiler reading, in a fresh process (``python -c``): a
    cfg4 megaround (``CELL_NODES`` cap_cluster nodes, ``CELL_PODS``
    pods' need) dispatched once through a new graph, then one replay from
    the same start under torch.profiler. Prints one JSON line: the
    iterations, the kernels the launches say the replay ran (two resets
    and the tally before the node, a pass's two headroom copies and
    tally once an iteration) and those the profiler recorded, by name."""
    import numpy as np
    import torch

    from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
    from nhd_tpu_torch.solver import speculate
    from nhd_tpu_torch.solver.device_state import DeviceClusterState
    from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods
    from nhd_tpu_torch.solver.kernel import _ARG_ORDER, _pad_pow2

    cluster = encode_cluster(cap_cluster(CELL_NODES, GROUPS), now=0.0)
    cluster.busy[:] = False
    buckets = list(encode_pods(workload_mix(CELL_PODS, GROUPS),
                               cluster.interner).values())
    needs = [np.bincount(p.pod_type, minlength=_pad_pow2(p.n_types)).astype(np.int32)
             for p in buckets]
    state = DeviceClusterState(cluster, card(torch))
    start = {k: v.clone() for k, v in state._dev.items()}
    its = int(state.megaround(buckets, needs, False)[3])
    (entry,) = speculate.GRAPHS.entries()
    control = speculate.control_arrays(needs, speculate._shapes(buckets))

    def prep():
        entry.buf.fill(control)
        for k in _ARG_ORDER:
            entry.node[k].copy_(start[k])

    seen = replay_kernels(torch, entry.graph.replay, prep)
    gates = sum(n for k, n in seen.items() if "spec_gate" in k)
    print(json.dumps({
        "iterations": its, "gates": gates,
        "counted": 2 + sum(entry.tally.values())
        + its * (sum(entry.body_tally.values()) + 2),
        "profiled": sum(seen.values()), "by_name": seen}), flush=True)
    return 0


def graph_phase(torch, report, smi):
    """Phase 15: the megaround as one graph replay, its loop a WHILE node
    (module docstring)."""
    import numpy as np

    from nhd_tpu_torch.solver import speculate
    from nhd_tpu_torch.solver.kernel import _MUTABLE, _pad_pow2, upload_pods
    from nhd_tpu_torch.solver.speculate import (
        MegaroundCache,
        _shapes,
        run_megaround,
        spec_iters,
        trip_arrays,
    )

    dev = card(torch)
    iters = spec_iters()
    out = report["graph"] = {"smi": smi, "iters": iters}
    t_phase = time.perf_counter()
    for label, snap in SNAPS.items():
        state, bucket_pods, needs, respect_busy, _n = snap
        U = int(state["cpu_free"].shape[1])
        K = int(state["nic_free"].shape[2])
        start = {k: v.to(dev, copy=True) for k, v in state.items()}
        pods = [upload_pods(p, _pad_pow2(p.n_types), U, K, dev) for p in bucket_pods]
        cache = MegaroundCache()  # its own, so its first dispatch captures
        fixed_cache = MegaroundCache()
        zero = [np.zeros_like(n) for n in needs]

        def loop(node, need=needs):
            return run_megaround(node, bucket_pods, pods, need, U, K, iters,
                                 respect_busy)

        def graph(node, need=needs, cache=cache):
            return cache.run([node], bucket_pods, need, U, K, iters, respect_busy)

        def fixed(node, need=needs):
            speculate.REPLAY = False
            try:
                return fixed_cache.run([node], bucket_pods, need, U, K, iters,
                                       respect_busy)
            finally:
                speculate.REPLAY = True

        def result(res, node):
            return [t.cpu() for t in res] + [node[k].cpu() for k in _MUTABLE]

        runs = {}
        for kind, fn in (("host loop", loop), ("graph", graph),
                         ("fixed trip", fixed), ("plain", loop)):
            node = {k: v.clone() for k, v in start.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "plain":
                with plain_on_card():
                    res = fn(node)
            else:
                res = fn(node)
            torch.cuda.synchronize()
            runs[kind] = (result(res, node), time.perf_counter() - t0, node)
        entry = cache.entries()[0]
        if dev.type == "cuda" and entry.graph is None:
            fail(f"graph {label}: the dispatch captured no graph")
        if fixed_cache.entries()[0].graph is not None:
            fail(f"graph {label}: REPLAY off captured a graph")
        replay = entry.loop if entry.graph is None else entry.graph.replay
        want = runs["host loop"][0]
        cpu = PLAIN_REPLAYS.get(f"{label} megaround 0")
        for kind, got in (("graph", runs["graph"][0]),
                          ("fixed trip", runs["fixed trip"][0]),
                          ("plain", runs["plain"][0]), ("CPU plain replay", cpu)):
            if got is not None and not all(torch.equal(g, w) for g, w in zip(got, want)):
                fail(f"graph {label}: the host loop and the {kind} differ")
        its = int(want[3])

        # the passes the WHILE node runs, counted on the card by a body
        # with one more op: one a live iteration, none without need
        passes = graph_passes(
            torch, f"graph {label}",
            lambda need, cache: graph({k: v.clone() for k, v in start.items()},
                                      need, cache), needs, zero, its)

        # the host loop against the graph, in turns from the start state:
        # host wall per dispatch (the loop's includes its per-iteration
        # pulls; the graph's is the enqueue) and device time by events
        nodes = {"host loop": runs["host loop"][2], "graph": runs["graph"][2]}

        def reset(kind):
            for k in _MUTABLE:
                nodes["host loop" if kind == "host loop" else "graph"][k].copy_(start[k])

        med = in_turns(torch, (
            ("host loop", lambda: loop(nodes["host loop"])),
            ("graph", lambda: graph(nodes["graph"])),
            ("graph, no need", lambda: graph(nodes["graph"], zero))), reset)
        # the replay alone, on the card: its buffers restored on the card
        # before each launch (cuda_time_ms), live and with no need; and
        # the host's parts of a dispatch
        shapes = _shapes(bucket_pods)
        Np = int(start["hp_free"].shape[0])
        host_ms = {"table build": [], "replay enqueue": []}
        for _ in range(GRAPH_TIMED):
            t0 = time.perf_counter()
            live_arrays = trip_arrays(bucket_pods, needs, shapes, U, K, Np)
            host_ms["table build"].append((time.perf_counter() - t0) * 1e3)
        replay_ms, restore = replay_alone(torch, entry, bucket_pods, needs, zero,
                                          U, K, start)
        for _ in range(GRAPH_TIMED):
            restore("live")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            replay()
            host_ms["replay enqueue"].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        host_ms = {k: statistics.median(v) for k, v in host_ms.items()}
        host_ms["dispatch parts"] = {k: round(v / entry.dispatches * 1e3, 4)
                                     for k, v in entry.host_s.items()}
        del live_arrays
        per_pass = (replay_ms["live"] - replay_ms["dead"]) / max(its, 1)
        # the kernels of one replay: before the node (two resets, one
        # gate), then a pass's (two headroom copies, the tally's kernels)
        # once an iteration; the profiler's own reading beside it
        body = sum(entry.body_tally.values()) + 2
        counted_kernels = 2 + sum(entry.tally.values()) + its * body
        profiled = None
        if label.startswith("cfg4"):
            profiled = replay_kernels(torch, replay, functools.partial(restore, "live"))
        cell = {
            "iterations": its, "passes": passes,
            "capture_s": entry.capture_s, "first_dispatch_s": runs["graph"][1],
            "fixed_trip_first_s": runs["fixed trip"][1],
            "host_loop_first_s": runs["host loop"][1], "medians": med,
            "ms_per_pass": per_pass, "tally": entry.tally,
            "body_tally": entry.body_tally, "replay_kernels": counted_kernels,
            "profiled_kernels": profiled,
            "replay_device_ms": replay_ms, "host_parts_ms": host_ms,
            "node_rows": int(start["hp_free"].shape[0]),
        }
        out[label] = cell
        prof = ""
        if profiled is not None:
            prof = (f"; torch.profiler over one replay records "
                    f"{sum(profiled.values())} kernels ({profiled})")
        log(f"graph {label} (Np={cell['node_rows']}): WHILE graph == fixed trip == "
            f"host loop == plain on the card"
            f"{' == plain replay on the CPU' if cpu is not None else ''} "
            f"(claims, counts, need left, {its} iterations, node state); the node ran "
            f"{passes['live'][0]} passes counted on the card ({passes['no need'][0]} "
            f"with no need); capture "
            f"{'none' if entry.capture_s is None else f'{entry.capture_s * 1e3:.2f} ms'} "
            f"(first dispatch {runs['graph'][1] * 1e3:.2f} ms, the fixed trip's first "
            f"{runs['fixed trip'][1] * 1e3:.2f} ms, the host loop's first "
            f"{runs['host loop'][1] * 1e3:.2f} ms); medians of {GRAPH_TIMED}: "
            + "; ".join(f"{k} host {m['host_ms']:.3f} ms, wall {m['wall_ms']:.3f} ms, "
                        f"device {m['device_ms']:.4f} ms" for k, m in med.items())
            + f"; the replay alone on the card {replay_ms['live']:.4f} ms, with no "
            f"need {replay_ms['dead']:.4f} ms, so a pass {per_pass:.4f} ms; host: "
            f"the table build {host_ms['table build']:.3f} ms, the replay's enqueue "
            f"{host_ms['replay enqueue']:.3f} ms, a dispatch's parts (mean ms) "
            f"{host_ms['dispatch parts']}; launches a replay: {entry.tally} before "
            f"the node, {entry.body_tally} a pass, {counted_kernels} kernels with the "
            f"resets and headroom copies{prof}; {smi}")
    # the profiler over one cfg4 replay in a fresh process: no pass after
    # the exit may show (more spec_gate launches than 1 + iterations)
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, chip_smoke; sys.exit(chip_smoke.replay_profile_child())"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    if proc.returncode != 0:
        fail(f"graph: the profiled replay's process exited {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    fresh = out["profiled_replay"] = json.loads(proc.stdout.strip().splitlines()[-1])
    if fresh["gates"] > fresh["iterations"] + 1:
        fail(f"graph: the profiler saw {fresh['gates']} spec_gate launches in a "
             f"replay of {fresh['iterations']} iterations")
    log(f"graph: cfg4 replay under torch.profiler in a fresh process: "
        f"{fresh['iterations']} iterations, {fresh['counted']} kernels by the "
        f"launches, {fresh['profiled']} recorded ({fresh['gates']} of spec_gate); "
        f"{fresh['by_name']}; {smi}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"graph: phase 15 in {out['seconds']:.1f}s of command time")


#: a correlation ID's process counter (``c000019``, after any scope)
CORR_SEQ = re.compile(r"c\d{6}")


def pod_span_names(spans):
    """Each pod's span names (``ns/name`` -> names), over every
    correlation ID a span naming the pod was recorded under."""
    spans = list(spans)
    pod_of = {}
    for s in spans:
        pod = (s.attrs or {}).get("pod")
        if pod is not None and s.corr is not None:
            pod_of.setdefault(s.corr, pod)
    out = {}
    for s in spans:
        pod = pod_of.get(s.corr)
        if pod is not None:
            out.setdefault(pod, set()).add(s.name)
    return out


def decision_view(d):
    """A decision record as two runs of one drive share it on any
    device: (ns, pod, outcome, node, the names of its phases, its
    explain reasons); its stamp, corr and phase times left out."""
    return (d["ns"], d["pod"], d["outcome"], d["node"],
            tuple(sorted(d["phases"])),
            tuple(sorted((d.get("reasons") or {}).items())))


def cross_journeys(merged):
    """The cross-replica journeys of a merged trace, keyed by pod
    (``ns/name``, from the spans' ``pod`` arg; corr IDs are process
    counters, a pod's name is not): (replicas, span names in order,
    shards)."""
    from nhd_tpu_torch.obs.chrome import (
        journey_replicas,
        pod_journeys,
        scheduled_journeys,
    )

    journeys = scheduled_journeys(pod_journeys(merged))
    out = {}
    for corr, events in sorted(journeys.items()):
        reps = journey_replicas(merged, corr, journeys)
        if len(reps) < 2:
            continue
        args = [ev.get("args") or {} for ev in events]
        pod = next((a["pod"] for a in args if a.get("pod")),
                   CORR_SEQ.sub("c*", corr))
        out[pod] = (sorted(reps), [ev["name"] for ev in events],
                    sorted({a["shard"] for a in args
                            if a.get("shard") is not None}))
    return out


def masked(obj):
    """*obj* (an artifact, a payload, a report) as two runs of one seed
    share it on any device and in any process: every float (a time, or
    a rate of times) and bucket table, the wall stamp and the revision
    masked, correlation counters replaced by ``c*``."""
    if isinstance(obj, dict):
        return {CORR_SEQ.sub("c*", str(k)): (
            None if k in ("buckets", "created_unix", "git_rev")
            else masked(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [masked(v) for v in obj]
    if isinstance(obj, float):
        return None
    if isinstance(obj, str):
        return CORR_SEQ.sub("c*", obj)
    return obj


def round_claims(spans):
    """The round spans' (name, claims, rejects) in order (batch.py)."""
    return [(s.name, s.attrs.get("claims"), s.attrs.get("rejects"))
            for s in spans if s.name.startswith("round")]


def latest_decisions(decisions):
    """Each pod's newest decision (``ns/name`` -> record), from a
    newest-first list."""
    out = {}
    for d in decisions:
        out.setdefault(f"{d['ns']}/{d['pod']}", d)
    return out


def gc_paused(fn):
    """(fn(), seconds the cyclic garbage collector paused it, its
    collections), from ``gc.callbacks``."""
    import gc

    acc, start = {"s": 0.0, "n": 0}, []

    def watch(phase, _info):
        if phase == "start":
            start.append(time.perf_counter())
        elif start:
            acc["s"] += time.perf_counter() - start.pop()
            acc["n"] += 1

    gc.callbacks.append(watch)
    try:
        out = fn()
    finally:
        gc.callbacks.remove(watch)
    return out, acc["s"], acc["n"]


def recorder_part(torch, report, smi):
    """Phase 16 (a): phase 7's run (cfg4's pending set, 10,000 pods on
    1,000 nodes, through ``Scheduler(device="cuda")``) with the flight
    recorder on, its ring sized from the pods; counts set to 0 just
    before and read just after. Then the same run with the recorder off
    once more, so on and off stand in turns (phase 7, on, off), each
    with the collector's pauses."""
    from nhd_tpu_torch import obs
    from nhd_tpu_torch.sim.trace_demo import ring_capacity

    capacity = ring_capacity(DAEMON_PODS)
    rec = obs.enable(capacity=capacity, decision_capacity=capacity)
    try:
        ((got, outcome), _wall, launches), gc_s, gc_n = gc_paused(
            lambda: counted(torch, lambda: _daemon_run(card(torch),
                                                       DAEMON_PODS)))
        spans = rec.spans()
        decisions = rec.recent_decisions(capacity)
        dropped = rec.dropped()
        n_spans, n_decisions = len(spans), len(decisions)
        t0 = time.perf_counter()
        schema = obs.validate_chrome_trace(obs.chrome_trace(rec))
        export_s = time.perf_counter() - t0
    finally:
        obs.disable()
    require_launched("recorder", launches, SPEC_PATH)
    if dropped:
        fail(f"recorder: the ring (capacity {capacity}) dropped {dropped} "
             f"of {len(spans) + dropped} spans")
    if schema:
        fail(f"recorder: trace invalid: {schema[:5]}")
    if len(decisions) >= capacity:
        fail(f"recorder: the decision ring ({capacity}) filled up")
    diff = [k for k in outcome if outcome[k] != DAEMON_OUTCOME.get(k)]
    if diff or len(outcome) != len(DAEMON_OUTCOME):
        fail(f"recorder: {len(diff)} pods bound differently from phase 7's "
             f"run with the recorder off (first: {diff[:1]})")
    names = pod_span_names(spans)
    newest = latest_decisions(decisions)
    bound = {f"{ns}/{pod}": v[0] for (ns, pod), v in outcome.items()
             if v[0] is not None}
    short = [p for p in bound if not SCAN_SPANS <= names.get(p, set())]
    if short:
        fail(f"recorder: {len(short)} bound pods lack one of "
             f"{sorted(SCAN_SPANS)} (first: {short[0]}: "
             f"{sorted(names.get(short[0], ()))})")
    wrong = [p for p, node in bound.items()
             if p not in newest or newest[p]["outcome"] != "scheduled"
             or newest[p]["node"] != node
             or not SCAN_SPANS <= set(newest[p]["phases"])]
    if wrong:
        fail(f"recorder: {len(wrong)} bound pods' decisions disagree with "
             f"their bind (first: {wrong[0]}: {newest.get(wrong[0])})")
    rounds = round_claims(spans)
    r0 = [c for n, c, _r in rounds if n == "round0"]
    if not r0 or not r0[0]:
        fail(f"recorder: the first batch's round-0 span carries no claims "
             f"from the megaround ({rounds[:4]})")
    waited = sum(1 for p in bound if "queue_wait" in names.get(p, ()))
    del spans, decisions, names, newest, rec  # the ring, out of the off run
    (after, after_outcome), gc_off_s, gc_off_n = gc_paused(
        lambda: _daemon_run(card(torch), DAEMON_PODS))
    if after_outcome != outcome:
        fail("recorder: the run with the recorder off again placed "
             "differently")
    rate = got["bound"] / got["wall"]
    off = report["daemon"]
    OPS["a"] = {
        "pods": DAEMON_PODS, "nodes": DAEMON_NODES, "capacity": capacity,
        "spans": n_spans, "decisions": n_decisions, "dropped": dropped,
        "bound": got["bound"], "wall_s": got["wall"], "binds_per_s": rate,
        "off_wall_s": off["wall_s"], "off_binds_per_s": off["binds_per_s"],
        "off_after_wall_s": after["wall"], "gc_s": gc_s, "gc_n": gc_n,
        "off_after_gc_s": gc_off_s, "off_after_gc_n": gc_off_n,
        "export_validate_s": export_s, "round0_claims": r0,
        "queue_wait_pods": waited, "launches": launches,
    }
    log(f"ops (a) recorder on at cfg4's width: {DAEMON_PODS} pods on "
        f"{DAEMON_NODES} nodes, bound {got['bound']} (placements equal to "
        f"phase 7's), ring {capacity} holding {n_spans} spans "
        f"({n_spans / DAEMON_PODS:.2f} a pod), 0 dropped, "
        f"{n_decisions} decisions, trace valid (export and check "
        f"{export_s:.3f}s); every bound pod carries "
        f"{'/'.join(sorted(SCAN_SPANS))} and a scheduled decision on its "
        f"node ({waited} a queue_wait: scan batches have none); round-0 "
        f"claims by batch {r0}; wall={got['wall']:.4f}s "
        f"({rate:.0f} binds/s; collector pauses {gc_s:.3f}s in {gc_n}) "
        f"against the recorder off in phase 7 {off['wall_s']:.4f}s "
        f"({off['binds_per_s']:.0f} binds/s) and right after "
        f"{after['wall']:.4f}s ({after['bound'] / after['wall']:.0f} "
        f"binds/s; collector pauses {gc_off_s:.3f}s in {gc_off_n}), on/off "
        f"{got['wall'] / off['wall_s']:.3f}x and "
        f"{got['wall'] / after['wall']:.3f}x; launches={launches}; {smi}")


def trace_view(torch, device, work):
    """The trace demo (``sim/trace_demo.py``) at its defaults on
    *device*: its exit code, printed lines, each pod's span names, the
    decisions, the round spans and the binds; the counts set to 0 just
    before and read just after."""
    import io

    from nhd_tpu_torch import obs
    from nhd_tpu_torch.sim import trace_demo as td

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            (code, rec, backend), wall, launches = counted(
                torch, lambda: td.demo(pods=6, nodes=4, device=device,
                                       out=work, capacity=td.ring_capacity(6)))
        view = {
            "code": code,
            "pods": {p: sorted(n) for p, n in pod_span_names(rec.spans()).items()},
            "decisions": [decision_view(d) for d in rec.recent_decisions(256)],
            "rounds": round_claims(rec.spans()),
            "binds": {f"{k[0]}/{k[1]}": p.node for k, p in backend.pods.items()},
        }
    finally:
        obs.disable()
    return view, buf.getvalue().splitlines(), wall, launches


def trace_part(torch, smi):
    """Phase 16 (b): the trace demo on the card, then on the CPU with
    speculation on (the card's default): each pod's span names, the
    decisions and the round spans' claims equal."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="nhd-trace-") as work:
        got, lines, wall, launches = trace_view(torch, card(torch), work)
        with env(NHD_TPU_SPECULATE="1"):
            cpu, _cpu_lines, cpu_wall, _ = trace_view(torch, "cpu", work)
    if got["code"] != 0:
        fail(f"trace demo on cuda: exit {got['code']}: {lines}")
    require_launched("trace demo", launches, SPEC_PATH)
    for key in ("code", "binds", "pods", "decisions", "rounds"):
        if got[key] != cpu[key]:
            fail(f"trace demo: {key} differ between cuda and cpu: "
                 f"{got[key]} / {cpu[key]}")
    OPS["b"] = {"wall_s": wall, "cpu_wall_s": cpu_wall, "lines": lines,
                "rounds": got["rounds"], "launches": launches}
    log(f"ops (b) trace demo on cuda: {lines[0]}; {lines[2]}; span names "
        f"and decisions of all {len(got['pods'])} pods and the round spans "
        f"{got['rounds']} equal to the CPU run with speculation on; "
        f"wall={wall:.3f}s (cpu {cpu_wall:.3f}s); launches={launches}; {smi}")


def replay_part(torch, smi):
    """Phase 16 (c): the replay demo's four acts on the card (recorded
    with speculation on, the card's default made explicit so the
    journal's knobs name it), then its journal replayed on the CPU."""
    import io
    import tempfile

    from nhd_tpu_torch.sim import trace_replay as tr

    buf = io.StringIO()
    with tempfile.TemporaryDirectory(prefix="nhd-replay-") as work:
        with env(NHD_TPU_SPECULATE="1"), contextlib.redirect_stdout(buf):
            code, wall, launches = counted(
                torch, lambda: tr.demo(card(torch), workdir=work))
        lines = buf.getvalue().splitlines()
        if code != 0:
            fail(f"replay demo on cuda: exit {code}: {lines}")
        require_launched("replay demo", launches, SPEC_PATH)
        path = os.path.join(work, "churn.journal.jsonl")
        sig, cpu_wall, _ = replay(torch, "replay demo's cuda journal", path,
                                  "cpu")
    OPS["c"] = {"wall_s": wall, "cpu_replay_s": cpu_wall, "lines": lines,
                "decisions": len(sig), "launches": launches}
    acts = [line.split(": ", 1)[1] for line in lines
            if line.startswith("trace-replay: act")]
    log(f"ops (c) replay demo on cuda: {' | '.join(acts)}; demo PASS in "
        f"{wall:.3f}s; its journal replayed on the CPU: {len(sig)} decisions, "
        f"0 divergences ({cpu_wall:.3f}s); launches={launches}; {smi}")


def fleet_run(torch, device, out):
    """The fleet demo (``sim/fleet_demo.py``) at its defaults on
    *device*, its artifacts into *out*: exit code, printed lines, the
    chosen seed, the cross-replica journeys by pod and the masked fleet
    payload, with the process-wide tallies the payload folds in set to
    0 first."""
    import glob
    import io

    from nhd_tpu_torch.k8s.retry import API_COUNTERS
    from nhd_tpu_torch.sim import fleet_demo as fd
    from nhd_tpu_torch.solver.guard import GUARD

    API_COUNTERS.reset()
    GUARD.reset()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code, wall, launches = counted(
            torch, lambda: fd.main(["--out-dir", out, "--device", str(device)]))
    view = {"code": code, "seed": None, "journeys": None, "payload": None}
    for path in glob.glob(os.path.join(out, "*.json")):
        with open(path) as fh:
            obj = json.load(fh)
        name = os.path.basename(path)
        if name.startswith("journey-seed"):
            view["seed"] = int(name[len("journey-seed"):-len(".json")])
            view["journeys"] = cross_journeys(obj)
        else:
            view["payload"] = masked(obj["payload"])
    return view, buf.getvalue().splitlines(), wall, launches


def fleet_part(torch, smi):
    """Phase 16 (d): the fleet demo on the card, then on the CPU with
    speculation on: the same seed, cross-replica journeys by pod and
    fleet payload (times masked)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="nhd-fleet-") as work:
        got, lines, wall, launches = fleet_run(
            torch, card(torch), os.path.join(work, "cuda"))
        with env(NHD_TPU_SPECULATE="1"):
            cpu, _, cpu_wall, _ = fleet_run(torch, "cpu",
                                            os.path.join(work, "cpu"))
    if got["code"] != 0 or got["seed"] is None:
        fail(f"fleet demo on cuda: exit {got['code']}: {lines}")
    require_launched("fleet demo", launches, SPEC_PATH)
    for key in ("code", "seed", "journeys", "payload"):
        if got[key] != cpu[key]:
            fail(f"fleet demo: {key} differ between cuda and cpu: "
                 f"{got[key]} / {cpu[key]}")
    OPS["d"] = {"wall_s": wall, "cpu_wall_s": cpu_wall, "seed": got["seed"],
                "cross_replica": len(got["journeys"]), "lines": lines,
                "launches": launches}
    log(f"ops (d) fleet demo on cuda: seed {got['seed']}, "
        f"{len(got['journeys'])} cross-replica journeys "
        f"({sorted(got['journeys'])}); seed, journeys by pod and payload "
        f"(times masked) equal to the CPU run; {' | '.join(lines[1:4])}; "
        f"wall={wall:.3f}s (cpu {cpu_wall:.3f}s); launches={launches}; {smi}")


def soak_part(torch, smi):
    """Phase 16 (e): the soak, SOAK_SEEDS x SOAK_STEPS at SOAK_NODES
    nodes, on the card and then on the CPU with speculation on: every
    seed clean, the totals equal."""
    import io

    from nhd_tpu_torch.sim import soak

    argv = ["--seeds", str(SOAK_SEEDS), "--steps", str(SOAK_STEPS),
            "--nodes", str(SOAK_NODES), "--device"]
    runs = {}
    for side, device in (("cuda", str(card(torch))), ("cpu", "cpu")):
        buf = io.StringIO()
        with env(NHD_TPU_SPECULATE="1"), contextlib.redirect_stdout(buf):
            code, wall, launches = counted(
                torch, lambda: soak.main(argv + [device]))
        lines = buf.getvalue().splitlines()
        if code != 0 or not lines or not lines[-1].startswith("SOAK OK"):
            fail(f"soak on {side}: exit {code}: {lines}")
        runs[side] = (lines[-1].split(" — ", 1)[1], wall, launches)
    totals, wall, launches = runs["cuda"]
    require_launched("soak", launches, SPEC_PATH)
    if totals != runs["cpu"][0]:
        fail(f"soak: totals differ between cuda and cpu: {totals} / "
             f"{runs['cpu'][0]}")
    OPS["e"] = {"seeds": SOAK_SEEDS, "steps": SOAK_STEPS, "nodes": SOAK_NODES,
                "totals": totals, "wall_s": wall, "cpu_wall_s": runs["cpu"][1],
                "launches": launches}
    log(f"ops (e) soak on cuda: {SOAK_SEEDS} seeds x {SOAK_STEPS} steps at "
        f"{SOAK_NODES} nodes, all clean, {totals} (equal to the CPU's); "
        f"wall={wall:.3f}s (cpu {runs['cpu'][1]:.3f}s); launches={launches}; "
        f"{smi}")


def ops_phase(torch, report, smi):
    """Phase 16: the operator gates on the card (module docstring, parts
    a-e; (f) ran inside phase 10)."""
    walls = {}
    for part, fn in (("a", lambda: recorder_part(torch, report, smi)),
                     ("b", lambda: trace_part(torch, smi)),
                     ("c", lambda: replay_part(torch, smi)),
                     ("d", lambda: fleet_part(torch, smi)),
                     ("e", lambda: soak_part(torch, smi))):
        t0 = time.perf_counter()
        fn()
        walls[part] = time.perf_counter() - t0
    if "f" not in OPS:
        fail("fleet top: phase 10's mid-run scrape did not run it")
    report["ops"] = dict(OPS, part_s=walls, smi=smi)
    log(f"ops: phase 16's parts (a)-(e) took "
        + " / ".join(f"{walls[p]:.1f}" for p in sorted(walls))
        + f" s of command time ({sum(walls.values()):.1f} s; (f) "
        f"{OPS['f']['wall_s']:.3f} s inside phase 10); {smi}")


# ---------------------------------------------------------------------------
# phase 17: the policy engine, tiered preemption, churn past the stream
# threshold, and the tenant, HA and federation storms on the card
# ---------------------------------------------------------------------------


def policy_env():
    """The policy engine on, with cfg8:hetero's throughput matrix
    (bench.py:716-719) as the operator sets it (``NHD_POLICY_TPUT``)."""
    from nhd_tpu_torch.sim import pending

    return dict(NHD_POLICY="1",
                NHD_POLICY_TPUT=json.dumps(pending.HETERO_MATRIX))


@contextlib.contextmanager
def batch_calls():
    """While inside, every ``BatchScheduler.schedule`` call (the daemon's
    batches, each tile sub-call of the tiler) appends (its thread, whether
    a live scoring matrix was on, what that thread launched during the
    call) to the yielded list."""
    import threading

    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.policy.scoring import scoring_active
    from nhd_tpu_torch.solver.batch import BatchScheduler

    calls = []
    inner = BatchScheduler.schedule

    def spy(self, *args, **kw):
        scored = scoring_active()
        before = kernels.thread_launches()
        try:
            return inner(self, *args, **kw)
        finally:
            after = kernels.thread_launches()
            calls.append((threading.get_ident(), scored,
                          {n: after[n] - before[n] for n in kernels.COUNTED}))

    BatchScheduler.schedule = spy
    try:
        yield calls
    finally:
        BatchScheduler.schedule = inner


def scored_without_megaround(label, calls):
    """Fail unless some batch of *calls* (``batch_calls``) ran under a live
    scoring matrix, and no scored batch replayed a megaround or launched a
    claim kernel or spec_gate. Returns the scored batches' count."""
    from nhd_tpu_torch import kernels

    scored = [c for _t, s, c in calls if s]
    if not scored:
        fail(f"{label}: no batch ran under the scoring matrix")
    spec = (kernels.GRAPH, kernels.GATE_KERNEL, *kernels.CLAIM_KERNELS)
    bad = [c for c in scored if any(c[k] for k in spec)]
    if bad:
        fail(f"{label}: {len(bad)} scored batches launched the megaround "
             f"(first: {bad[0]})")
    return len(scored)


def timed_run(fn):
    """(fn(), wall seconds, {}): ``counted``'s shape for a CPU run."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0, {}


def placed_tput(outcome, n_nodes):
    """cfg8:hetero's aggregate placed throughput (bench.py:738-744): over
    the bound pods of ``fill_cfg4``, the matrix's throughput of the pod's
    workload kind (its shape: the second is CPU-only) on its node's
    generation."""
    from nhd_tpu_torch.sim import pending

    total = 0.0
    for (_ns, name), (node, _cfg, _nad) in outcome.items():
        if node is None or not name.startswith("pod-"):
            continue
        kind = "cpu" if int(name[4:]) % 3 == 1 else "gpu"
        total += pending.HETERO_MATRIX[kind][
            pending.hetero_class(int(node[4:]), n_nodes)]
    return total


def policy_daemon(device, count, *, preempt=True):
    """Phase 7's cell split into cfg8:hetero's two generations
    (``pending.fill_cfg4(node_class=hetero_class)``) through the port's
    daemon on *device* by its normal turn; then, with *preempt*, tier-2
    preemptors into the filled fleet (``pending.create_preemptors``,
    ``preempt_batch``). *count* runs a thunk as ``counted`` does. Returns
    the drive's figures and outcome, and the preemption's."""
    import nhd_tpu_torch.sim as sim
    from nhd_tpu_torch.sim import pending

    backend, sched = cfg4_daemon(device, DAEMON_PODS, DAEMON_NODES,
                                 node_class=pending.hetero_class)
    with batch_calls() as calls:
        got, wall, launches = count(lambda: pending.drive(sched))
    a = {"got": got, "wall": wall, "launches": launches, "calls": calls,
         "outcome": pod_outcome(backend)}
    if not preempt:
        return a, None
    pods = pending.create_preemptors(backend, sim, PREEMPTORS)
    with batch_calls() as calls_b:
        per_batch, wall_b, launches_b = count(
            lambda: pending.preempt_batch(sched, pods))
    b = {"per_batch": per_batch, "wall": wall_b, "launches": launches_b,
         "calls": calls_b, "evictions": [e[:4] for e in backend.evict_log],
         "outcome": pod_outcome(backend),
         "preemptors": [(ns, p) for p, ns, _uid in pods]}
    return a, b


def micro_cell(device):
    """bench.py:667-692's preemption micro-cell on *device*: the fenced
    evictions and each pod's outcome."""
    import queue

    import nhd_tpu_torch.sim as sim
    from nhd_tpu_torch.k8s.fake import FakeClusterBackend
    from nhd_tpu_torch.scheduler import core
    from nhd_tpu_torch.scheduler.events import WatchQueue
    from nhd_tpu_torch.sim import pending

    backend = FakeClusterBackend()
    n = pending.preempt_micro_cell(
        backend, sim, lambda b: core.Scheduler(
            b, WatchQueue(), queue.Queue(), respect_busy=False, device=device))
    return n, [e[:4] for e in backend.evict_log], pod_outcome(backend)


def rank_rows_by_words(torch, node, pod, real):
    """The real type rows of one solve's sel plane (its plain version's,
    on the card) by the words rank_select.cuh sorts them in: "whole 32",
    "whole 64" or "wide 64" (``sweep.rank_words``)."""
    from nhd_tpu_torch.kernels import reference, sweep
    from nhd_tpu_torch.solver import kernel as kernel_mod

    planes = reference.solve_planes(
        *stage(kernel_mod, reference, node, pod)["solve_planes"][0])
    keys = planes[0][:real["T"]]
    n = keys.shape[1]
    span = (keys.max(1).values.long() - keys.min(1).values.long()).tolist()
    got = collections.Counter()
    for s in span:
        got[f"{'whole' if n <= sweep.RANK_WHOLE_MAX else 'wide'} "
            f"{sweep.rank_words(n, s)}"] += 1
    return got, max(span)


def scored_copies(torch, label, n_nodes):
    """One scored classic schedule of cfg4's batch over *n_nodes*
    cap_cluster nodes in cfg8:hetero's two generations, through
    ``BatchScheduler`` on the card, every solve and rank_top call copied
    and held to its plain version (``capture_schedule``,
    ``check_kernels``). Returns the solves, the rows by word width and the
    widest key span."""
    from nhd_tpu_torch.sim import pending
    from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
    from nhd_tpu_torch.solver import BatchItem, BatchScheduler

    nodes = cap_cluster(n_nodes, GROUPS)
    for i, n in enumerate(nodes.values()):
        n.node_class = pending.hetero_class(i, n_nodes)
    items = [BatchItem(("ns", f"p{i}"), r)
             for i, r in enumerate(workload_mix(CELL_PODS, GROUPS))]
    sched = BatchScheduler(device=card(torch), respect_busy=False,
                           register_pods=False)
    _res, stats, cap = capture_schedule(torch, sched, nodes, items)
    if cap.megarounds or cap.claims or stats.counters.get("spec_iterations"):
        fail(f"{label}: a scored schedule ran the megaround")
    words, widest = collections.Counter(), 0
    for i, (G, real, node, pod, R) in enumerate(cap.solves):
        if R is None:
            fail(f"{label}: solve {i} was not a classic round's")
        check_kernels(torch, f"{label} solve {i} G={G} T={real['T']}",
                      node, pod, {"kernels": {}}, real, timed=False, R=R)
        got, span = rank_rows_by_words(torch, node, pod, real)
        words.update(got)
        widest = max(widest, span)
    return {"solves": len(cap.solves), "rounds": stats.rounds,
            "words": dict(words), "widest_span": widest}


def policy_part(torch, smi):
    """Phase 17 (a) and (b): the policy engine at cfg4's width and tiered
    preemption on the card, each against the CPU."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.policy import preempt

    penv = policy_env()
    dev = card(torch)
    with env(**penv):
        a, b = policy_daemon(dev, lambda fn: counted(torch, fn))
    with env(**penv, **CARD_DEFAULTS):
        cpu_a, cpu_b = policy_daemon("cpu", timed_run)
    # (a) the scored run against the CPU
    diff = [k for k in a["outcome"] if a["outcome"][k] != cpu_a["outcome"].get(k)]
    if diff or a["got"]["bound"] != cpu_a["got"]["bound"] or not a["got"]["bound"]:
        fail(f"policy (a): {len(diff)} pods bound differently on cuda and cpu "
             f"(first: {diff[:1]}), bound {a['got']['bound']} vs "
             f"{cpu_a['got']['bound']}")
    scored = scored_without_megaround("policy (a)", a["calls"])
    la = a["launches"]
    require_launched("policy (a)", la, kernels.SOLVE_KERNELS + ("rank_top",))
    spec = (kernels.GRAPH, kernels.GATE_KERNEL, *kernels.CLAIM_KERNELS)
    if any(la[k] for k in spec):
        fail(f"policy (a): the scored daemon run launched the megaround: {la}")
    # the control: the same fleet with the policy off places as phase 7
    with env(NHD_POLICY="0", NHD_POLICY_TPUT=None):
        ctl, _ = policy_daemon(dev, lambda fn: counted(torch, fn),
                               preempt=False)
    require_launched("policy control", ctl["launches"], SPEC_PATH)
    diff = [k for k in ctl["outcome"] if ctl["outcome"][k] != DAEMON_OUTCOME.get(k)]
    if diff or len(ctl["outcome"]) != len(DAEMON_OUTCOME):
        fail(f"policy control (NHD_POLICY=0): {len(diff)} pods bound "
             f"differently from phase 7's run (first: {diff[:1]})")
    tput = placed_tput(a["outcome"], DAEMON_NODES)
    tput_off = placed_tput(ctl["outcome"], DAEMON_NODES)
    # every solve and rank_top call of one scored schedule, at cfg4's
    # width and at POLICY_WIDE_NODES (rows past rank_select.cuh's whole-row
    # limit: its wide regime, 64-bit words)
    copies = {}
    with env(**penv):
        for n_nodes in (CELL_NODES, POLICY_WIDE_NODES):
            copies[n_nodes] = scored_copies(
                torch, f"policy scored schedule N={n_nodes}", n_nodes)
    words = collections.Counter()
    for c in copies.values():
        words.update(c["words"])
    if not words.get("wide 64"):
        fail(f"policy (a): no scored rank_top row took rank_select.cuh's "
             f"wide path: {dict(words)}")
    rate = a["got"]["bound"] / a["got"]["wall"]
    rate_off = ctl["got"]["bound"] / ctl["got"]["wall"]
    log(f"policy (a) cuda: {DAEMON_NODES} cfg4 nodes in two generations "
        f"(gen-b on the first half), {DAEMON_PODS} pods, NHD_POLICY=1 with "
        f"{penv['NHD_POLICY_TPUT']}: bound {a['got']['bound']} in "
        f"{a['got']['turns']} turns, {scored} scored batches, none with a "
        f"megaround; placed throughput {tput:.1f} against {tput_off:.1f} "
        f"with the policy off ({tput / tput_off - 1:+.2%}); wall="
        f"{a['got']['wall']:.4f}s ({rate:.0f} binds/s; policy off "
        f"{ctl['got']['wall']:.4f}s, {rate_off:.0f} binds/s); every pod's "
        f"node, solved config and NAD identical to the CPU run (wall "
        f"{cpu_a['got']['wall']:.4f}s); the policy-off control placed as "
        f"phase 7; launches={la}; control launches={ctl['launches']}; {smi}")
    log(f"policy (a) scored schedules copied: "
        + "; ".join(f"N={n}: {c['solves']} solves in {c['rounds']} rounds, "
                    f"rank rows by words {c['words']}, widest key span "
                    f"{c['widest_span']}" for n, c in copies.items())
        + "; every solve kernel and rank_top call exact against its plain "
        "version on the card")
    # (b) tiered preemption into the filled fleet
    for key in ("evictions", "outcome"):
        if b[key] != cpu_b[key]:
            fail(f"policy (b): {key} differ between cuda and cpu")
    if b["per_batch"] != cpu_b["per_batch"]:
        fail(f"policy (b): evictions by batch differ: {b['per_batch']} / "
             f"{cpu_b['per_batch']}")
    if not b["evictions"]:
        fail("policy (b): the tier-2 preemptors evicted nothing")
    over = [n for n in b["per_batch"]
            if sum(n.values()) > preempt.round_budget()
            or any(v > preempt.tenant_budget() for v in n.values())]
    if over:
        fail(f"policy (b): a batch broke its eviction budget "
             f"({preempt.round_budget()} a batch, "
             f"{preempt.tenant_budget()} a tenant): {over}")
    lb = b["launches"]
    require_launched("policy (b)", lb, kernels.SOLVE_KERNELS + ("rank_top",))
    scored_b = scored_without_megaround("policy (b)", b["calls"])
    victims = sorted({(ns, pod) for ns, pod, _uid, _node in b["evictions"]})
    placed_pre = [b["outcome"][k][0] for k in b["preemptors"]]
    rebound = sum(1 for v in victims if b["outcome"][v][0] is not None)
    with env(**penv):
        n_micro, ev_micro, out_micro = micro_cell(dev)
    with env(**penv, **CARD_DEFAULTS):
        cpu_micro = micro_cell("cpu")
    if (n_micro, ev_micro, out_micro) != cpu_micro or not n_micro:
        fail(f"policy (b) micro-cell: {n_micro} evictions on cuda, "
             f"{cpu_micro[0]} on the CPU (or outcomes differ)")
    log(f"policy (b) cuda: {PREEMPTORS} tier-2 pods of the largest shape into "
        f"the filled fleet: {len(b['evictions'])} fenced evictions over "
        f"{len(b['per_batch'])} batches ({b['per_batch']}; budget "
        f"{preempt.round_budget()} a batch, {preempt.tenant_budget()} a "
        f"tenant, held), victims {victims}, {rebound} of them bound again, "
        f"preemptors on {placed_pre}; {scored_b} scored batches, none with a "
        f"megaround; evictions, victims and every pod's node, config and NAD "
        f"identical to the CPU run; wall={b['wall']:.4f}s (cpu "
        f"{cpu_b['wall']:.4f}s); launches={lb}; micro-cell (bench.py:667-692) "
        f"{n_micro} evictions, as on the CPU; {smi}")
    POLICY["a"] = {
        "bound": a["got"]["bound"], "turns": a["got"]["turns"],
        "wall_s": a["got"]["wall"], "binds_per_s": rate,
        "cpu_wall_s": cpu_a["got"]["wall"], "placed_tput": tput,
        "placed_tput_off": tput_off, "off_wall_s": ctl["got"]["wall"],
        "off_binds_per_s": rate_off, "scored_batches": scored,
        "launches": la, "control_launches": ctl["launches"],
        "copies": copies, "rank_words": dict(words),
    }
    POLICY["b"] = {
        "preemptors": PREEMPTORS, "evictions": len(b["evictions"]),
        "per_batch": b["per_batch"], "victims": victims, "rebound": rebound,
        "wall_s": b["wall"], "cpu_wall_s": cpu_b["wall"], "launches": lb,
        "micro_evictions": n_micro,
    }


#: phase 17 (c): the device-state counters held to the CPU each turn
DEVICE_STATE_COUNTERS = ("device_state_rows_uploaded_total",
                         "device_state_deltas_total",
                         "device_state_full_rebuilds_total")


def turn_budgets(turns, n_nodes):
    """bench.py:382-396's changed-row budget for each turn of *turns*
    (dicts of binds, batches and the ``DEVICE_STATE_COUNTERS`` moves):
    2·(row patches + binds) + full rebuilds·*n_nodes* + 64 a batch, where
    a turn's binds are its own and the turn before's, since a batch's
    claimed rows upload at the next batch's first solve."""
    budgets, before = [], 0
    for t in turns:
        budgets.append(2 * (t["device_state_deltas_total"] + before
                            + t["binds"])
                       + t["device_state_full_rebuilds_total"] * n_nodes
                       + 64 * t["batches"])
        before = t["binds"]
    return budgets


def churn_daemon(device, count, script):
    """Phase 9 (d)'s 10,000 cfg4 nodes and 2,000 pods through the port's
    daemon on *device*, past NHD_STREAM_NODES in FED_SPLIT_TILE tiles with
    routed placement (bench.py cfg7's tiler) and persistent tile contexts
    (NHD_DELTA_STATE), then each turn of *script* (``pending.churn_script``)
    applied through the backend and one ``pending.churn_turn``. *count*
    runs a thunk as ``counted`` does. Returns each turn's figures: the
    events, binds, batches, the device-state counters' moves, launches,
    the batch calls (``batch_calls``) and every pod's outcome."""
    import nhd_tpu_torch.sim as sim
    from nhd_tpu_torch.k8s.retry import API_COUNTERS
    from nhd_tpu_torch.scheduler import core
    from nhd_tpu_torch.scheduler.controller import Controller
    from nhd_tpu_torch.sim import pending

    if not core.DELTA_STATE:
        fail("churn: NHD_DELTA_STATE is off; the persistent tiles need it")
    backend, sched = cfg4_daemon(device, STREAM_DAEMON_PODS,
                                 STREAM_DAEMON_NODES)
    ctrl = Controller(backend, sched.nqueue)
    saved = core.STREAM_TILE_NODES, core.STREAM_PLACEMENT
    core.STREAM_TILE_NODES, core.STREAM_PLACEMENT = FED_SPLIT_TILE, "routed"
    turns = []

    def turn(fn, events):
        c0 = API_COUNTERS.snapshot()
        b0 = sched.perf["batches_total"]
        with batch_calls() as calls:
            binds, wall, launches = count(fn)
        c1 = API_COUNTERS.snapshot()
        turns.append({
            "events": events, "binds": binds, "wall": wall,
            "launches": launches, "calls": calls,
            "batches": int(sched.perf["batches_total"] - b0),
            **{k: c1[k] - c0[k] for k in DEVICE_STATE_COUNTERS},
            "outcome": pod_outcome(backend),
        })

    try:
        turn(lambda: pending.drive(sched)["bound"], {"create": STREAM_DAEMON_PODS})
        if sched._stream is None or not sched._stream.persistent:
            fail("churn: the daemon did not build a persistent streaming tiler")
        for i, events in enumerate(script):
            done = pending.apply_events(backend, sim, events)
            turn(lambda i=i: pending.churn_turn(sched, ctrl, float(i + 1)),
                 done)
    finally:
        core.STREAM_TILE_NODES, core.STREAM_PLACEMENT = saved
    return turns


def churn_part(torch, smi):
    """Phase 17 (c): churn past the stream threshold through the daemon,
    on the card against the CPU after every turn."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.sim import pending

    script = pending.churn_script(CHURN_SEED, CHURN_TURNS, CHURN_EVENTS,
                                  STREAM_DAEMON_NODES)
    got = churn_daemon(card(torch), lambda fn: counted(torch, fn), script)
    with env(**CARD_DEFAULTS):
        cpu = churn_daemon("cpu", timed_run, script)
    threads = []
    rows = []
    budgets = {side: turn_budgets(turns, STREAM_DAEMON_NODES)
               for side, turns in (("cuda", got), ("cpu", cpu))}
    for i, (t, c) in enumerate(zip(got, cpu, strict=True)):
        label = f"churn turn {i}"
        diff = [k for k in t["outcome"] if t["outcome"][k] != c["outcome"].get(k)]
        if diff or len(t["outcome"]) != len(c["outcome"]) or t["binds"] != c["binds"]:
            fail(f"{label}: {len(diff)} pods differ between cuda and cpu "
                 f"(first: {diff[:1]}), binds {t['binds']} vs {c['binds']}")
        for side, turn in (("cuda", t), ("cpu", c)):
            if turn["device_state_rows_uploaded_total"] > budgets[side][i]:
                fail(f"{label} on {side}: "
                     f"{turn['device_state_rows_uploaded_total']} rows "
                     f"uploaded against a changed-row budget of "
                     f"{budgets[side][i]}")
        budget = budgets["cuda"][i]
        if i and t["device_state_full_rebuilds_total"]:
            fail(f"{label}: {t['device_state_full_rebuilds_total']} full "
                 "rebuilds with no node added or removed")
        counters = [k for k in DEVICE_STATE_COUNTERS if t[k] != c[k]]
        if counters:
            fail(f"{label}: device-state counters differ from the CPU's: "
                 f"{[(k, t[k], c[k]) for k in counters]}")
        require_launched(label, t["launches"], SPEC_PATH + (kernels.GRAPH,))
        launching = {th for th, _s, n in t["calls"]
                     if any(n[k] for k in kernels.SOLVE_KERNELS)}
        threads.append(len(launching))
        rows.append({k: t[k] for k in (
            "events", "binds", "batches", "wall", "launches",
            *DEVICE_STATE_COUNTERS)})
        rows[-1].update(budget=budget, cpu_wall=c["wall"],
                        threads=threads[-1])
        log(f"{label}: events {t['events']}, bound {t['binds']} in "
            f"{t['batches']} batches, rows uploaded "
            f"{t['device_state_rows_uploaded_total']} ("
            f"{t['device_state_deltas_total']} patches, "
            f"{t['device_state_full_rebuilds_total']} rebuilds), wall "
            f"{t['wall']:.4f}s (cpu {c['wall']:.4f}s); every pod's node, "
            f"solved config and NAD and the counters identical to the CPU; "
            f"a changed-row budget of {budget} (this turn's and the last "
            f"turn's binds); "
            f"tile sub-calls launching from {threads[-1]} threads; "
            f"launches={t['launches']}")
    if max(threads) < 2:
        fail(f"churn: the tiles of a turn launched from {max(threads)} "
             "thread at most")
    log(f"churn: {STREAM_DAEMON_NODES} cfg4 nodes in {FED_SPLIT_TILE}-node "
        f"tiles (routed, persistent), {STREAM_DAEMON_PODS} pods then "
        f"{CHURN_TURNS} turns of {CHURN_EVENTS} cfg7-mix events ({CHURN_CUT}); "
        f"tile sub-calls launching from {threads} threads by turn; {smi}")
    POLICY["c"] = {"turns": rows, "threads": threads,
                   "cut": CHURN_CUT}


def storm_run(device, argv, path):
    """One storm matrix (sim/storm.py) in this process on *device* under
    ``STORM_ENV``: its summary, wall, launches (the card's; counts set to
    0 just before) and its batch calls (``batch_calls``)."""
    import torch

    from nhd_tpu_torch.sim import storm

    count = (lambda fn: counted(torch, fn)) if device != "cpu" else timed_run
    with env(**STORM_ENV), batch_calls() as calls:
        rc, wall, launches = count(lambda: storm.main(
            argv + ["--device", device, "--json-out", path]))
    with open(path) as fh:
        summary = json.load(fh)
    if rc != 0 or not summary["ok"]:
        bad = [(c["profile"], c["seed"], c["violations"][:3])
               for c in summary["cells"] if not c["ok"]]
        fail(f"storm {argv} on {device}: failed cells {bad}")
    return summary, wall, launches, calls


def storm_part(torch, smi):
    """Phase 17 (d): the storm matrices of the policy, tenant, HA and
    federation modes, each on the card and on the CPU."""
    import tempfile

    from nhd_tpu_torch import kernels

    out = {}
    with tempfile.TemporaryDirectory(prefix="nhd-storms-") as work:
        for mode, argv in STORM_MODES:
            got, wall, launches, calls = storm_run(
                str(card(torch)), argv, os.path.join(work, mode + ".json"))
            cpu, cpu_wall, _, _ = storm_run(
                "cpu", argv, os.path.join(work, mode + "-cpu.json"))
            masked_got = {k: v for k, v in got.items() if k not in STORM_MASKED}
            masked_cpu = {k: v for k, v in cpu.items() if k not in STORM_MASKED}
            if masked_got != masked_cpu:
                bad = [i for i, (x, y) in enumerate(zip(got["cells"], cpu["cells"]))
                       if x != y]
                fail(f"storm {mode}: the matrix differs from the CPU's "
                     f"(cells {bad[:4]}; {got['cells'][bad[0]] if bad else ''})")
            require_launched(f"storm {mode}", launches, kernels.SOLVE_KERNELS)
            scored = (scored_without_megaround(f"storm {mode}", calls)
                      if mode == "policy" else 0)
            out[mode] = {"cells": got["cells_total"], "wall_s": wall,
                         "cpu_wall_s": cpu_wall, "launches": launches,
                         "scored_batches": scored}
            log(f"storm {mode} ({' '.join(argv)}): {got['cells_total']} cells, "
                f"every one's invariants held on cuda; the matrix equal to the "
                f"CPU's with {sorted(STORM_MASKED)} masked"
                + (f"; {scored} scored batches, none with a megaround"
                   if mode == "policy" else "")
                + f"; wall {wall:.2f}s (cpu {cpu_wall:.2f}s)"
                + f"; launches={launches}; {smi}")
    POLICY["d"] = out


def policy_phase(torch, report, smi, parts="abcd"):
    """Phase 17 (module docstring): (a) and (b) together, (c), (d); each
    part's wall printed, its launches kept in ``report["policy"]``."""
    walls = {}
    for part, fn in (("ab", lambda: policy_part(torch, smi)),
                     ("c", lambda: churn_part(torch, smi)),
                     ("d", lambda: storm_part(torch, smi))):
        if not set(part) & set(parts):
            continue
        t0 = time.perf_counter()
        fn()
        walls[part] = time.perf_counter() - t0
    report["policy"] = dict(POLICY, part_s=walls, smi=smi)
    log("policy: phase 17's parts " + " / ".join(
        f"({p}) {walls[p]:.1f}" for p in walls)
        + f" s of command time ({sum(walls.values()):.1f} s); {smi}")


def main(argv=None):
    # --only=17[:PARTS] runs phases 1-2 and then phase 17 alone (its parts
    # among a, b, c, d; a and b run together), preceded for (a) by phase
    # 7's card run, whose placements its control is held to; it prints
    # neither the kernels line nor the contract line
    only = None
    for arg in sys.argv[1:] if argv is None else argv:
        if arg == "--only=17" or arg.startswith("--only=17:"):
            only = arg.partition(":")[2] or "abcd"
        else:
            fail(f"unknown argument {arg!r} (known: --only=17[:PARTS])")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    try:
        import nhd_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"run from the repository root (nhd_tpu_torch not importable: {exc})")

    report = {"kernels": {}, "cells": {}}
    # 1. device
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {smi} | torch: {kind} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}")
    report["device"] = {"smi": smi, "kind": kind}

    # 2. build
    from nhd_tpu_torch import kernels, native
    from nhd_tpu_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all()
    for name in kernels.KERNELS:
        build.load(name)
    have_native = native.available()
    build_s = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    log(f"build: {len(logs)} kernels compiled in {build_s:.2f}s "
        f"(nvcc {build.BUILD_SECONDS['total']:.2f}s); native core: {have_native}")
    if not have_native:
        fail("native assignment core did not build")
    report["build_s"] = build_s
    if only is not None:
        t0 = time.perf_counter()
        if set("ab") & set(only):
            _got, outcome = _daemon_run(card(torch), DAEMON_PODS)
            DAEMON_OUTCOME.update(outcome)
        t1 = time.perf_counter()
        policy_phase(torch, report, smi, only)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_policy.json"), "w") as fh:
            json.dump(report, fh, indent=1, default=str)
        log(f"phase 17 alone, parts {only}: passed in "
            f"{time.perf_counter() - t1:.1f} s (phase 7's card run first: "
            f"{t1 - t0:.1f} s); {smi}")
        return 0

    # 3. kernels vs plain on the card
    from nhd_tpu_torch.sim.workloads import bench_cluster, cap_cluster, workload_mix
    from nhd_tpu_torch.solver.device_state import DeviceClusterState
    from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods

    import numpy as np

    from nhd_tpu_torch.kernels import reference
    from nhd_tpu_torch.solver import kernel as kernel_mod

    dev = card(torch)
    headline = None
    for cell, cluster_fn in (("cfg4", cap_cluster), ("cfg3", bench_cluster)):
        cluster = encode_cluster(cluster_fn(CELL_NODES, GROUPS), now=0.0)
        cluster.busy[:] = False
        state = DeviceClusterState(cluster, dev)
        buckets = encode_pods(workload_mix(CELL_PODS, GROUPS), cluster.interner)
        # the rank width a classic round of the batch takes (batch.py)
        R = kernel_mod.rank_budget(
            max(int(np.bincount(b.pod_type).max()) for b in buckets.values()),
            cluster.n_nodes, accelerator=True)
        for G, pods in sorted(buckets.items()):
            Tp = state.pod_tensors(pods).dem_rx.shape[0]
            label = (f"{cell} G={G} U={cluster.U} K={cluster.K} T={pods.n_types} "
                     f"(Tp={Tp}) N={cluster.n_nodes} (Np={state.Np})")
            real = {"T": pods.n_types, "N": cluster.n_nodes}
            res = check_kernels(torch, label, state.tensors(), state.pod_tensors(pods),
                                report, real, R=R)
            if cell == "cfg4" and G == 2:
                # the mesh's merge at cfg4 over MESH_BATCH_SHARDS shards: a
                # shard's planes are the unsharded planes' columns (13 (a))
                a = dict(zip(kernel_mod._ARG_ORDER, state.tensors()))
                free = (a["gpu_free"], a["cpu_free"], a["hp_free"])
                planes = reference.solve_planes(*stage(
                    kernel_mod, reference, state.tensors(),
                    state.pod_tensors(pods))["solve_planes"][0])
                S = MESH_BATCH_SHARDS
                Ns = state.Np // S
                cand = torch.cat([reference.rank_top(
                    planes[:, :, s * Ns:(s + 1) * Ns].contiguous(),
                    *(f[s * Ns:(s + 1) * Ns] for f in free),
                    R=min(R, Ns), node_base=s * Ns) for s in range(S)], dim=2)
                res["rank_merge"] = check_merge(
                    torch, f"{label} over {S} shards", cand,
                    reference.rank_top(planes, *free, R=R), real, timed=True)
                report["kernels"][label] = headline = res
        del state
    node, pod = wide_bucket(torch, dev)
    check_kernels(torch, f"wide G=3 U=2 K=8 T=8 N={WIDE_N}", node, pod, report,
                  {"T": 8, "N": WIDE_N}, R=min(kernel_mod.rank_cap(True), WIDE_N))
    del node, pod
    rank_rows(torch, dev, report)
    sweep_check(torch, dev, report)
    oracle_check(dev)

    # 4, 5, 6. main path: the card's default (speculative), then classic
    launches_total = dict.fromkeys(kernels.COUNTED, 0)
    run_cell(torch, "cfg4:10kx1k-cap", cap_cluster, report, launches_total,
             speculative=True)
    run_cell(torch, "cfg3:10kx1k-sat", bench_cluster, report, launches_total,
             speculative=True)
    run_cell(torch, "cfg4:10kx1k-cap classic", cap_cluster, report,
             launches_total, speculative=False)
    for cell in ("cfg4:10kx1k-cap", "cfg4:10kx1k-cap classic"):
        if report["cells"][cell]["placed"] != CELL_PODS:
            fail(f"{cell} is capacity-matched: every pod must place")
    claim_headline = report["kernels"]["cfg4:10kx1k-cap megaround"]

    # 7. the daemon: cfg4's pending set through the system's own entry point
    daemon_phase(torch, report, launches_total, smi)
    # 8. the solver guard on the card
    guard_phase(torch, report, smi)
    # 9. cfg5 through the streaming tiler
    stream_phase(torch, report, launches_total, smi)

    # 10. the CLI over HTTP on the card
    cli_phase(torch, report, launches_total, smi)
    # 11. the device-fault storm on the card
    t0 = time.perf_counter()
    chaos_phase(torch, report, launches_total, smi)
    # 12. the kernel cache: prewarm, quarantine, first bind
    t1 = time.perf_counter()
    prewarm_phase(torch, report, launches_total, smi)
    # 13. the node mesh on the card
    t2 = time.perf_counter()
    mesh_phase(torch, report, launches_total, smi)
    # 14. nhdsan and nhdrace on the card
    t3 = time.perf_counter()
    race_phase(torch, report, launches_total, smi)
    t4 = time.perf_counter()
    # 15. the megaround as one graph replay against the host loop
    graph_phase(torch, report, smi)
    t5 = time.perf_counter()
    # 16. the operator gates: recorder at full width, demos, soak
    ops_phase(torch, report, smi)
    t6 = time.perf_counter()
    # 17. the policy engine, preemption, churn past the stream threshold,
    # the other storm modes
    policy_phase(torch, report, smi)
    report["phase_s"] = {"11": t1 - t0, "12": t2 - t1, "13": t3 - t2,
                         "14": t4 - t3, "15": t5 - t4, "16": t6 - t5,
                         "17": time.perf_counter() - t6}
    log("phases 11 / 12 / 13 / 14 / 15 / 16 / 17: " + " / ".join(
        f"{report['phase_s'][p]:.1f}" for p in (
            "11", "12", "13", "14", "15", "16", "17"))
        + " s of command time")

    # 18. kernels line
    meta = {
        "nic_node_masks": ("nhd_tpu_torch/kernels/nic_node_masks.cu",
                           "nhd_tpu/solver/kernel.py:136"),
        "nic_any_first": ("nhd_tpu_torch/kernels/nic_any_first.cu",
                          "attic/nic_pallas.py:89"),
        "solve_planes": ("nhd_tpu_torch/kernels/solve_planes.cu",
                         "nhd_tpu/solver/kernel.py:41"),
        "spec_elect": ("nhd_tpu_torch/kernels/spec_elect.cu",
                       "nhd_tpu/solver/speculate.py:301"),
        "spec_fill": ("nhd_tpu_torch/kernels/spec_fill.cu",
                      "nhd_tpu/solver/speculate.py:406"),
        "spec_apply": ("nhd_tpu_torch/kernels/spec_apply.cu",
                       "nhd_tpu/solver/speculate.py:448"),
        "spec_gate": ("nhd_tpu_torch/kernels/spec_gate.cu",
                      "nhd_tpu/solver/speculate.py:533"),
        "rank_top": ("nhd_tpu_torch/kernels/rank_top.cu",
                     "nhd_tpu/solver/kernel.py:297"),
        "rank_merge": ("nhd_tpu_torch/kernels/rank_merge.cu",
                       "nhd_tpu/solver/kernel.py:477"),
    }
    # the solve and rank kernels at the cfg4 G=2 bucket (rank_merge over
    # its 4 shards), the claim kernels and spec_gate at cfg4's first
    # megaround iteration; library_ms: torch.topk alone on the rank's keys
    at = {**headline, **claim_headline}
    line = {"kernels": [
        {
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches_total[name],
            "max_abs_err": at[name]["max_abs_err"],
            "ms": at[name]["ms"], "plain_ms": at[name]["plain_ms"],
            "bound_ms": at[name]["bound_ms"],
            "bound_by": at[name]["bound_by"],
            "library_ms": at[name].get("library_ms"),
        }
        for name in kernels.KERNELS
    ]}
    report["kernels_line"] = line
    report["launches_total"] = launches_total
    log(f"launches over phases 4-7 and 9-14: {launches_total}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_report.json"), "w") as fh:
        json.dump(report, fh, indent=1, default=str)
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
