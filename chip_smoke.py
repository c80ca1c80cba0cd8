#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``emqx_tpu_torch``) on one NVIDIA card.

Drives the port's publish routing step through the entry points a broker
calls — ``RouterModel.subscribe / refresh / publish_batch`` — at the
BASELINE config-2 scale (~1M subscriptions of the vehicle-fleet tree,
``bench.py:125-213``), on the flat trie and on the subscription-sharded
trie (``ShardedTrieIndex(4)``) and on both tries placed over a mesh of
devices (``RouterModel(mesh=...)``, the card four times), and through
the entry points of ``emqx_tpu_torch/entry.py`` (``entry()`` and
``dryrun_multichip``), builds the
eleven CUDA kernels from
``emqx_tpu_torch/csrc/``, holds every kernel against its plain-torch
version on the card, and checks sampled routing results against the
port's host oracle trie.  Each routing step is two kernel launches: the
trie walk in its compacted mode (``walk_compact``, ``walk_compact_sharded``,
whose epilogue writes the trimmed fids, the overflow flags and, when the
step packs them, the counters, after a memset in the same entry), then
``fanout_pool``, which also sets ``fan_any``; all the outputs lie in one
packed block, copied to the host in one copy.  The walk's candidate-block
mode, its count-only mode (``walk_count``, ``match_counts``) and the two
compact kernels are off the step and are held against their plain
versions in the kernels phase.  The models run with their kernel
telemetry on (the steps pack their counters); the steps with the counters
off are checked and timed beside them.  The serving phase drives the
port's serving plane around a model on the card — ``Broker.publish_batch``
and ``PublishPipeline.submit`` + ``flush``, the entry points the servers
call — with the subscriptions made through ``Broker.subscribe``.  Its flat
leg is the app as a deployment boots it: a HOCON config parsed by the
port's ``Config`` into ``BrokerApp.from_config``, which builds the
``RouterModel`` on the card and the app's whole hook chain (access control,
rewrite, topic metrics, auto-subscribe, the rule engine, shared
subscriptions, the retainer, delayed publish, ``$SYS``); its network leg
serves MQTT clients over sockets from the app's own listeners, with their
credentials; its services leg drives the app's services (the rule engine
co-batched on the step, shared subscriptions, the retainer, ``$SYS``); and
its app leg holds the app's access control and hook services to their
contracts over wire clients.  The durable path then boots a second app
from a config of its own, with persistent sessions, an exhook provider,
authn on MySQL, authz on MongoDB, a Kafka bridge and the management API;
the gateway path loads the five protocol gateways (STOMP, MQTT-SN, CoAP,
LwM2M, ExProto) into it, and the cluster path clusters it with a second
node on the card.  The native path serves MQTT clients and the C++ load
generator from the app's ``native`` listener, the port's C++ epoll host
(``emqx_tpu_torch/native``, built with g++ beside the kernels), whose
device lane batches permitted publishes through the routing step.

Phases (each one's failure exits non-zero).  Each of the sixteen paths
runs with the launch counts set to 0 just before it and read just after,
and fails if one of its kernels was not launched:

1. device  — print the card's name and power limit (nvidia-smi);
2. build   — nvcc build of the kernels, with its seconds; the native
             library's g++ build on a thread beside it and the first paths
             (its seconds logged, the run fails where it does not build);
3. load    — 1M bench-shape filters, one random slot each, refresh;
4. slice   — (flat path) publish_batch on 8×16384 and 8×64 topics of
             bench.py's plain mix, ≥2048 sampled topics checked against
             the oracle, topics/s and p50/p99 of synchronous steps; then
             24 broadcast filters subscribed to 96 slots each (dense-pool
             rows, which nearly every topic matches), refresh, and the
             same measurements on that dense mix; one step raises the
             launch counts of the walk and of fanout_pool by one each and
             no other, with the counters on and off;
5. churn   — (flat path) 256 subscribes + 256 unsubscribes, one refresh
             through the patch kernel, which reads the update block in
             place from pinned host memory (``refresh_upload_ms`` is the
             host's staging of it); new filters route, removed ones do
             not; then 8 more subscribes and a refresh under
             torch.profiler, whose trace must show the patch kernel and
             no copy;
6. idle    — the card's idle share inside one publish_batch(16384), from a
             torch.profiler trace, which must hold one device-to-host
             copy; then one device step traced between two spin kernels:
             the walk, the fan-out and the memset, and no other kernel,
             with the counters on and off;
7. bitmap  — (bitmap fan-out path) a dense [F, W] subscriber bitmap of
             every (filter, slot) on the card; the dense-mix batches
             published again, their untrimmed [B, 128] fids through
             fanout_bitmaps and bitmap_to_counts, each topic's count equal
             to its decoded slot count outside the fallback rows;
8. sharded — (sharded path) the same subscriptions, broadcast overlay off,
             in RouterModel(ShardedTrieIndex(4)); the slice phases on the
             plain and the dense mix and the churn again, sampled topics
             checked against the oracle and against the flat model; the
             launch counts and the traced steps again;
   mesh    — (mesh path) a RouterModel on a (2, 2) mesh of the card four
             times over the flat model's index and host state (as the
             reference's ``sharded_trie_models`` fixture clones a model;
             the devices logged): the dense mix at B=16384 and 64 through
             publish_batch_submit / collect equals the single-card
             model's results, and the raw step's five outputs, counters on
             and off, equal its step's exactly, one mesh step launching the
             walk and fanout_pool once per device; the overlay lifted
             through the mesh model (patches, no upload), the single-card
             model brought in step (a whole upload), the plain mix at
             16384 and 64 the same way and sampled against the host
             oracle; a churn of 128 new and 128 removed filters in one
             refresh, which patches every device and uploads nothing,
             probed against the oracle, then undone; one new filter
             patching every device (the replicas); a Broker over the mesh
             model whose step raises hands the error on (D1: no host
             batch, no failover); the overlay back;
   mesh_s4 — (mesh_s4 path) the same over the sharded model's S=4 trie on
             (2, 2) (two shards a device, the merged compact launched once
             per device too; one new filter patching only its owning tp
             rank's devices), then on (1, 4) at B=64;
   entry   — (entry and entry_s4 paths) the entry points
             (``emqx_tpu_torch/entry.py``) on models of its own:
             ``entry()``'s ``fn(*args)`` on the card equals the plain step
             on CPU copies of its arguments exactly, counters off and on,
             each call one launch of the walk and one of fanout_pool;
             ``dryrun_multichip(4)`` over the card four times ((2, 2)),
             then ``dryrun_multichip(1)`` (``python -m
             emqx_tpu_torch.entry`` on one card), at 200,000 filters
             (100,040 distinct): both legs' lines (the flat leg equal to
             the host oracle on all 64 topics, the sharded S=4 leg on
             every topic that did not fall back), and each leg's
             ``publish_batch`` equal to a single-card ``_build_model``
             twin's; ``entry`` counts the entry() calls and the flat
             legs' launches, ``entry_s4`` the sharded legs';
9. serving — (serving path) ``BrokerApp.from_config`` of the smoke's
             config (``app_conf``: ``router.device`` at K=32, M=128,
             ``ret_cap`` 16, 8192 slots, 8 levels, batches of 512 at depth
             4, knee 0; a TCP and a WS listener on 127.0.0.1; a built-in
             DB of every wire client keyed by client id; a file ACL that
             denies publishes on ``secret/#``, ``no_match = deny``;
             flapping detection; one rewrite rule; one auto-subscribe
             template; ``node.data_dir`` in a temporary directory), its
             parse, app build and model refresh timed: the model is the
             one the boot built, on the card, with no host matcher, the
             pipeline's knee 0 and no implicit spill, the app's
             DeviceMetricsFold the model's hook (behind a tap); then the
             1M filters subscribed through the app's broker by 131,072
             session ids (16 a slot), the app's CM holding a recording
             channel for 4096 of them:
             Broker.publish_batch on the plain mix at B=16384 and 64, the
             pipeline flushing on a worker thread while another thread
             subscribes and patches, the fold's cost (telemetry on and
             off in turns), then the dense overlay through the broker at
             B=64 and 16384 and through the pipeline; on ≥2048 sampled
             messages per mix the delivery maps equal the host path's
             (Broker.publish), the channels got what the host path
             routes, in order; no device failover, no host batch, one
             step per device batch, the fold's batches and totals those
             the model handed it; a host-dispatch leg (models on the card
             under EMQX_TPU_CPU_KERNEL=host answer as the step, which auto
             picks; its launches are logged apart and count on no path);
             then (network path) the app's own TCP and WS listeners
             (``app.listeners.start_all``), and MQTT clients in a child
             process of their own (``--network-clients``, the port's
             MqttClient, WS through the port's codec), each CONNECTing with
             its built-in DB credentials and auto-subscribed by the app:
             1024 TCP and 64 WS subscribers (v5) SUBSCRIBE over the wire to 4
             filters of the tree each, 2 at QoS 0 and 2 at QoS 1, 64 of
             them also to ``fleet/f0/#`` (the patch kernel carries them to
             the card); 64 TCP and 8 WS publishers (v3.1.1) send a QoS 0
             burst (384 each, none awaited) and QoS 1 commands (128 each,
             one in flight), half the topics from the wire filters, half
             from the plain mix, with the dense overlay's broadcast
             subscriptions lifted, then 2048 QoS 0 messages with them back;
             per leg a ``network`` line (messages/s from the first byte
             sent to the last expected delivery, publish→delivery and
             PUBACK p50/p99, device batch mean and max, steps per batch);
             every subscriber's deliveries equal, as a multiset, what the
             host path routes to its wire subscriptions, each publisher's
             order is kept per QoS, every QoS 1 publish is acked, no
             failover, host batch or ERROR record on the pipeline's
             logger, one step per device batch; the soft open-file limit is
             raised to the hard one (both logged; a cut of the client
             counts would be logged as one);
             then (native path) the app's ``native`` listener (the port's
             ``NativeBrokerServer``, device lane on; its start mirrors the
             1M subscriptions into the C++ table), the dense overlay lifted
             and no rule attached, the model warmed at every power-of-two
             batch size: 64 v5 subscribers (the network phase's child
             process) SUBSCRIBE to 4 new filters under ``lane/`` each (2
             exact, 2 wildcards; the patch kernel carries them to the card),
             8 v3.1.1 publishers publish each of their 64 topics once (half
             ``lane/``, half the plain mix; the Python path earns the
             permits), then 512 QoS 0 and 64 QoS 1 messages each: every
             subscriber's deliveries equal, as a multiset, what the host
             path routes, in order per publisher and topic; the ``lane/``
             messages park on the device lane (``lane_in``), the plain-mix
             ones (Python audiences) punt to the pipeline; no stale trip, no
             lane punt, no D5 error, one step per lane or pipeline batch,
             native QoS 1 deliveries with packet ids of 32768 and up; then
             the C++ load generator (8 subscribers, 8 publishers, QoS 0,
             window 8192, 20,000 messages each) against the listener:
             messages/s, p50/p99, ``lane_dwell`` p50/p99, the lane's batch
             mean and max, received = sent (``native:`` lines);
             then (services path) the app's own services, the dense
             overlay lifted: BASELINE config 5, 8 rules on live traffic
             (``fleet/+/vehicle/+/part/+/m{r}``, r < 8) and 992 on
             ``rules/fleet{r}/+/telemetry``, each ``SELECT topic FROM``
             its filter with a recording action, and a ``republish`` rule
             to ``rp/${topic}`` with a recording channel on ``rp/#``,
             co-batched on the step through one refresh; publish_batch at
             B=16384 and 64 and the pipeline, with the rules attached and
             then deleted (``aux_release``): on every message the fired
             rules equal ``rules_for_topic`` on the engine's host trie,
             each at most once, the host trie answered exactly the step's
             fallback rows, every republish reached the channel, a sample
             delivers as the host path; BASELINE config 4, 100,000 groups
             x 4 members on ``$share/g{g}/fleet/f{g%512}/group{g}/+``
             (each message to one member, round robin within ±1,
             dispatches/s per message and batched) and 100,000 retained
             messages through retained publishes (``Retainer.match`` for
             512 fleets against a plain scan, a subscriber gets its set,
             lookups/s cold and warm), then the groups leave (every
             session's end walks every group's members, as the
             reference's ``member_down`` does); one
             ``SysHeartbeat.publish_kernel``
             reaching a ``$SYS/#`` subscriber with the fold's values;
             the rule engine's spill rows on the card: an app over a
             model with M=8 and ``ret_cap`` 4, 6 rules and 10
             subscribers, 6 topics in one ``publish_batch`` (one step):
             the 3 rows past ``ret_cap`` fire their rules from the
             engine's host trie, the other 3 from the step's aux column,
             each rule once, ``kernel_overflow`` 3, all of it equal to the
             same app over a CPU model (``services spill``);
             then (app path) the overload protection fed the zero-lag
             ticks its listeners' housekeeping missed while they were
             down (its lag average would refuse every new connection,
             ``app olp``), the app's listeners up again and wire
             clients in the smoke's own process: 64 CONNECTs timed through
             the built-in DB; a wrong password (0x86), a client id not in
             the DB (0x87) and a banned one (0x8A) refused; 3 abnormal
             disconnects ban a client id (flapping); a QoS 1 publish on
             ``secret/x`` gets PUBACK 0x87 and runs no step; the rewrite
             rule's source topic delivered on its destination by the step;
             a new client's auto-subscription on the card in one patch
             launch, then delivered; TopicMetrics of a registered filter
             equal the messages sent and delivered; ``app.tick()``;
             ``app.prometheus()`` carries the fold's gauges and
             ``app.kernel_summary()`` its stage percentiles; 512 sampled
             messages from 4 publishers to 16 subscribers deliver what the
             host path routes; no failover, no host batch, one step a
             device batch (``app ...`` lines; every thread's stack each
             10 s while the leg runs, its GC pauses on ``app gc``);
             then (serving_s4 path) the same broker code over
             ShardedTrieIndex(4) at 125,000 filters, wired by hand;
10. durable — (durable path) the serving phase's apps freed, a second app
             booted by ``BrokerApp.from_config`` of ``durable_conf``
             (the same ``router.device``; ``durable.enable``, which keeps
             sessions in the port's ``NativeDurableStore``, the native
             library built on a thread beside nvcc; one exhook server over the
             framed transport, the port's ``HookProvider`` on a thread;
             authn on ``MiniMySQL``, salted sha256; authz on
             ``MiniMongo``, publishes on ``vault/#`` denied), the 1M
             filters subscribed through its broker by 131,072 session ids;
             clients in the network phase's child process (its pool):
             256 persistent v5 subscribers (QoS 1, 4 filters each) away
             while 8 publishers send 2048 QoS 1 messages, each session's
             markers equal to what the host oracle trie routes to it,
             then resumed, each with exactly its pending messages in
             publisher order and no marker left after its PUBACKs; 512
             messages through the exhook, a third dropped and a third
             rewritten, delivered as the host path delivers them, the
             batched verdicts the per-message ones; 64 CONNECTs timed
             through MySQL, a wrong password 0x86, an unknown user 0x87,
             a publish MongoDB denies PUBACK 0x87 with no step; a rule
             with a Kafka bridge action (snappy) co-batched on the step
             in one patch, its messages in ``MiniKafka``'s log in order,
             0 fallback rows; the management API through ``CtlClient``
             (``/status``, ``/kernel/stats`` equal to the fold,
             ``/clients`` and ``/subscriptions`` equal to the CM and the
             broker, ``/publish`` delivered); one step a device batch, no
             failover, no host batch (``durable ...`` lines);
11. gateway — (gateway path, on the durable app) STOMP, MQTT-SN, CoAP,
             LwM2M and ExProto (its framed ``HandlerServer``, not gRPC:
             the card's machine has no ``grpcio``) loaded through
             ``app.gateway.load`` on 127.0.0.1, their clients in the
             smoke's own loop on the port's codecs, each a row of MySQL
             and of MongoDB's ACL: 64 STOMP clients on 4 filters of the
             tree each (2 of them new wildcards), 64 MQTT-SN clients
             (REGISTER, SUBSCRIBE to 4), 32 CoAP observers (2 each), 16
             LwM2M endpoints (their downlink filters), 16 ExProto
             connections (2 each), the new filters on the card in patch
             launches (count and refresh logged); 8 MQTT v5 publishers
             send 2048 QoS 0 and 256 QoS 1 messages, half on the
             gateway clients' filters, through the pipeline to the step:
             every client's deliveries equal, as a multiset, what the host
             path routes to its subscriptions, each publisher's order
             kept per QoS; uplinks (16 STOMP SENDs, 16 MQTT-SN QoS 1
             PUBLISHes, 8 CoAP POSTs a client, a LwM2M update and notify)
             reach 16 MQTT v5 subscribers as the host path routes them,
             with no step (the reference's ``GwContext.publish``);
             ``CtlClient`` against the ``GatewayManager`` (the five
             gateways, STOMP's clients, a ``DELETE`` kick whose socket
             drops), ``emqx_ctl gateway list`` (``gateway ...`` lines);
12. cluster — (cluster path) the durable app as ``ClusterNode("n1")``
             and a second app on the card from ``n2_conf`` as
             ``ClusterNode("n2")`` over ``TcpTransport``: n2 joins and
             bootstraps n1's 951,238 routes (seconds, the process's RSS);
             128 MQTT v5 subscribers on n2 (4 filters, 2 of them new
             wildcards), their routes flushed to n1; 8 publishers on n1
             send 2048 QoS 0 and 256 QoS 1 messages (n1's step, forwarded
             to n2), 8 on n2 send 1024 QoS 0 (n2's step, forwarded to
             n1): n2's subscribers and n1's sampled sessions get what the
             host oracle of the cluster's routes sends them, each
             publisher's order kept per filter; 16 persistent clients of
             n1 resume on n2 (``cm.takeover``), each with its 16 pending
             messages once and in order; ``PUT /configs`` on n1 commits a
             cluster transaction both nodes apply (``/cluster_rpc``: one
             tnx id); n2's transport closes, n1 ticks ``heartbeat_misses
             + 1`` times, holds no route to n2 and keeps routing; no
             failover, no host batch, one step a device batch on either
             node (``cluster ...`` lines);
13. kernels — each kernel against its plain version at its path's shapes
             (exact equality), its median time over single launches after
             an L2 flush (``ms``, CUDA events), its time per launch in a
             run of 20 back-to-back launches over 4 rotating copies of its
             batch inputs (``run_ms``), the plain version's time, and the
             bound from this run's bytes and operations, with the walk's
             mean live frontier per level; ``floor_ms``, an empty kernel
             timed as ``ms`` is; the mesh_s4 path's group walks
             (``shard_base`` > 0, two shards a device on B/2 rows, one on
             64) equal their plain versions, and the compact kernel at the
             groups' merged shape equals its plain version and the
             single-card sharded walk; the fused routing steps equal their plain
             composites (flat and S=4, B=16384 and 64, ret_cap 16 and
             None), with the counters off too (None, the other four
             outputs those of the counted step, also from a block whose
             bytes were 0xFF first), and a RouterModel with its kernel
             telemetry off hands its telemetry hook None; the steps (with
             the counters on and off) and ``pack_counters`` timed and
             bounded alike on a ``composites`` line; the popcount at
             shapes and an
             alignment that take each path of its kernel, the patch
             kernel from blocks on the card and in pinned memory at caps
             64 to 4096 on the flat and the stacked tables (a pageable
             block must raise); small edge-case tries at S ∈ {1, 4} (K
             and M overflow, '$' topics, C < M, a trie of every {a, +}
             path for wide frontiers) through every walk mode, where one
             shard equals the flat step and each fused step its plain
             composite, and the count-only walk its plain version and the
             candidate walk's count; both fan-outs at shapes and
             alignments that take each path of their gather-OR kernel.

Output: progress lines, then the nvidia-smi line, one JSON line
``{"kernels": [...], "floor_ms": ...}``, and last ``{"ok": true,
"device": {...}}``.  A kernel's ``launches`` is the sum of its launches
over the paths above that list it among their kernels (``PATHS``: flat,
bitmap, sharded, mesh, mesh_s4, entry, entry_s4, serving, network,
native, services, app, serving_s4, durable, gateway, cluster), each
path's own in
``launches_by_path``.  A
``phase seconds`` line gives each part's seconds.

Run from the root of a checkout, on a machine with one CUDA card and
nvcc::

    python3 chip_smoke.py
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import faulthandler
import functools
import gc
import itertools
import json
import logging
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12     # H100 SXM non-tensor float32 peak, the table's
SECTOR = 32                  # bytes of one DRAM sector: what a scattered
                             # 4-byte access really moves (logged beside
                             # the bound, which counts the 4 bytes needed)
SLEEP_CYCLES = 2_000_000     # ~1 ms of idle card ahead of a timed launch
RANK_MAX = 16                # router_kernels.cu kRankMax: next frontiers of
                             # up to this many candidates are ranked

REPLACES = {
    "walk_compact": "emqx_tpu/ops/trie_match.py:213",
    "walk_compact_sharded": "emqx_tpu/ops/trie_match.py:366",
    "trie_walk": "emqx_tpu/ops/trie_match.py:213",
    "compact": "emqx_tpu/ops/trie_match.py:316",
    "fanout_pool": "emqx_tpu/ops/fanout.py:51",
    "patch": "emqx_tpu/models/router_model.py:192",
    "trie_walk_sharded": "emqx_tpu/ops/trie_match.py:366",
    "compact_sharded": "emqx_tpu/ops/trie_match.py:399",
    "fanout_bitmaps": "emqx_tpu/ops/fanout.py:22",
    "bitmap_counts": "emqx_tpu/ops/fanout.py:83",
    "walk_count": "emqx_tpu/ops/trie_match.py:298",
}
# the kernels each path must launch (their counts go on the kernels line)
PATHS = {
    "flat": ("walk_compact", "fanout_pool", "patch"),
    "bitmap": ("fanout_bitmaps", "bitmap_counts"),
    "sharded": ("walk_compact_sharded", "fanout_pool", "patch"),
    "serving": ("walk_compact", "fanout_pool", "patch"),
    "serving_s4": ("walk_compact_sharded", "fanout_pool", "patch"),
    "network": ("walk_compact", "fanout_pool", "patch"),
    "services": ("walk_compact", "fanout_pool", "patch"),
    "app": ("walk_compact", "fanout_pool", "patch"),
    "durable": ("walk_compact", "fanout_pool", "patch"),
    "gateway": ("walk_compact", "fanout_pool", "patch"),
    "cluster": ("walk_compact", "fanout_pool", "patch"),
    "native": ("walk_compact", "fanout_pool", "patch"),
    "mesh": ("walk_compact", "fanout_pool", "patch"),
    "mesh_s4": ("walk_compact_sharded", "compact", "fanout_pool", "patch"),
    "entry": ("walk_compact", "fanout_pool"),
    "entry_s4": ("walk_compact_sharded", "compact", "fanout_pool"),
}
SOURCE = "emqx_tpu_torch/csrc/router_kernels.cu"
N_FILTERS = 1_000_000        # BASELINE config 2 (~1M subscriptions)
BATCH = 16384                # the step's batch, as bench.py sec_kernel
SHARDS = 4                   # bench.py _tenm_sharded_arm's trie shards
MESH_SHAPE = (2, 2)          # the mesh paths' (dp, tp), one card 4 times
MESH_WIDE = (1, 4)           # mesh_s4's second mesh (one shard a device)
MESH_CHURN = 128             # the mesh churn's new and removed filters
MESH_ORACLE = 512            # plain-mix topics checked against the oracle
DRYRUN_FILTERS = 200_000     # the entry phase's dry runs (entry.py's
                             # default GRAFT_DRYRUN_FILTERS)
SESSIONS = 131_072           # the serving phase's session ids: 16 a slot
RECORDED = 4096              # of them with a recording channel in the CM
SERVE_S4_FILTERS = 125_000   # the serving phase's S=4 leg, cut in depth
NET_SUBS = 1024              # the network phase: TCP subscribers (v5),
NET_WS_SUBS = 64             # WS subscribers (v5),
NET_DENSE_SUBS = 64          # TCP subscribers also on NET_DENSE_FILTER,
NET_PUBS = 64                # TCP publishers (v3.1.1),
NET_WS_PUBS = 8              # WS publishers (v3.1.1),
NET_BURST = 384              # QoS 0 messages a publisher, none awaited,
NET_COMMANDS = 128           # QoS 1 messages a publisher, one in flight,
NET_DENSE = 2048             # QoS 0 messages of the dense-overlay leg
NET_DENSE_FILTER = "fleet/f0/#"   # one of the dense overlay's filters
NAT_SUBS = 64                # the native path: v5 subscribers on lane/,
NAT_PUBS = 8                 # publishers (v3.1.1),
NAT_TOPICS = 64              # topics a publisher: half lane/, half plain,
NAT_QOS0 = 512               # QoS 0 messages a publisher,
NAT_QOS1 = 64                # QoS 1 messages a publisher, one in flight,
NAT_LOADGEN = 20_000         # load-generator messages a publisher (8 of them)
SERVICE_GROUPS = 100_000     # the services phase: shared groups (config 4)
# its spill leg (tests/test_torch_rules.py's co-batch boundary case, M=8,
# ret_cap 4): the rules' filters, the subscriptions, and the topics, the
# first three matching more than ret_cap filters
SPILL_FILTERS = ["s/+/+", "s/#", "+/+/+", "#", "s/x/+", "s/+/y"]
SPILL_SUBS = SPILL_FILTERS + ["s/x/y", "s/x/#", "+/x/y", "+/+/y"]
SPILL_TOPICS = ["s/x/y", "s/q/y", "s/x/z", "t/q/z", "s/q", "u"]
APP_SUBS = 16                # the app leg: v5 subscribers over the wire,
APP_PUBS = 4                 # publishers (v3.1.1),
APP_MESSAGES = 512           # sampled QoS 0 messages they send,
APP_CONNECTS = 64            # CONNECTs timed through the built-in DB,
APP_FLAP = 3                 # abnormal disconnects that trip a ban
APP_SECRET = "secret/#"      # the file ACL denies publishes here
APP_REWRITE = ("rw/#", "^rw/(.+)$", "app/rw/$1")  # source, re, destination
APP_AUTO = "auto/%c"         # the auto-subscribe template (%c: clientid)
APP_METRICS = "app/tm/+"     # a topic registered with TopicMetrics
STALL_DUMP_S = 10.0          # the app leg's stack dumps while it stalls
DUR_SUBS = 256               # the durable path: persistent v5 subscribers,
DUR_PUBS = 8                 # publishers (v5),
DUR_MESSAGES = 2048          # QoS 1 messages while the subscribers are away,
DUR_EXHOOK = 512             # QoS 0 messages through the exhook,
DUR_CONNECTS = 64            # CONNECTs timed through MySQL,
DUR_BRIDGE = 512             # QoS 0 messages of the bridge leg
DUR_SECRET = "vault/#"       # the MongoDB ACL denies publishes here
DUR_KAFKA_TOPIC = "mqtt-bridge"   # the bridge's Kafka topic
DUR_AUTHN_QUERY = ("SELECT password_hash, salt, is_superuser FROM "
                   "mqtt_user WHERE username = ${clientid} LIMIT 1")
# the gateway path: STOMP clients (4 filters each, 2 of them new
# wildcards), MQTT-SN clients (4 filters), CoAP observers (2), LwM2M
# endpoints (their downlink filter), ExProto connections (2); MQTT v5
# publishers and their QoS 0 and QoS 1 messages; MQTT v5 subscribers of
# the uplinks, and the uplinks each STOMP, MQTT-SN and CoAP client sends
GATEWAY = {"stomp": 64, "sn": 64, "coap": 32, "lwm2m": 16, "exproto": 16,
           "pubs": 8, "qos0": 2048, "qos1": 256, "up_subs": 16,
           "up_stomp": 16, "up_sn": 16, "up_coap": 8}
# the cluster path: n2's MQTT v5 subscribers (4 filters each, 2 of them
# new wildcards), publishers on each node, n1's QoS 0 and QoS 1 messages,
# n2's QoS 0 messages, n1's persistent clients resumed on n2 and the QoS 1
# messages each has pending, n1's session ids with a recording channel
# (besides the owners of n2's filters), n1's messages after n2 is down
CLUSTER = {"subs": 128, "pubs": 8, "qos0": 2048, "qos1": 256,
           "n2_msgs": 1024, "takeover": 16, "pending": 16,
           "recorded": 1024, "after": 512}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


T0 = time.time()


def log(msg: str) -> None:
    """One progress line, with the seconds since the process started."""
    print(f"[smoke] {msg} (t={time.time() - T0:.1f}s)", flush=True)


# ---------------------------------------------------------------------------
# the config-2 workload, same shape as bench.py:125-213
# ---------------------------------------------------------------------------


def build_filters(n: int, rng: np.random.Generator) -> list[str]:
    """Vehicle-fleet topic tree, 7 levels deep, ~10% '+' wildcards, a few
    percent '#' (bench.py build_filters)."""
    n_vehicles = max(1000, n // 2)
    kinds = rng.random(n)
    vids = rng.integers(0, n_vehicles, n)
    fleets = rng.integers(0, 512, n)
    metrics = rng.integers(0, 16, n)
    parts = rng.integers(0, 8, n)
    out = []
    for k, v, fl, m, p in zip(kinds.tolist(), vids.tolist(), fleets.tolist(),
                              metrics.tolist(), parts.tolist()):
        if k < 0.80:
            out.append(f"fleet/f{fl}/vehicle/v{v}/part/p{p}/m{m}")
        elif k < 0.90:
            out.append(f"fleet/f{fl}/vehicle/+/part/p{p}/m{m}")
        elif k < 0.95:
            out.append(f"fleet/f{fl}/vehicle/v{v}/part/+/m{m}")
        elif k < 0.98:
            out.append(f"fleet/f{fl}/vehicle/v{v}/#")
        else:
            out.append(f"fleet/+/vehicle/v{v}/part/p{p}/#")
    return out


def make_topics(live: list[str], rng: np.random.Generator, count: int,
                n_vehicles: int) -> list[str]:
    """Publish into the subscribed tree: a random subscribed filter with
    its wildcards instantiated (bench.py make_topics)."""
    picks = rng.integers(0, len(live), count)
    v = rng.integers(0, n_vehicles, count)
    p = rng.integers(0, 8, count)
    m = rng.integers(0, 16, count)
    fl = rng.integers(0, 512, count)
    topics = []
    for i in range(count):
        out = []
        for j, w in enumerate(live[picks[i]].split("/")):
            if w == "+":
                out.append(f"v{v[i]}" if j == 3 else
                           f"p{p[i]}" if j == 5 else f"f{fl[i]}")
            elif w == "#":
                out.extend([f"part/p{p[i]}", f"m{m[i]}"][: 7 - j])
                break
            else:
                out.append(w)
        topics.append("/".join(out))
    return topics


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def pct(xs) -> dict:
    return {"p50_ms": float(np.percentile(xs, 50)),
            "p99_ms": float(np.percentile(xs, 99))}


def time_ms(fn, reps: int, flush=None) -> float:
    """Median device time of ``fn()`` over ``reps`` launches (CUDA events),
    after one warm-up; ``flush()`` runs before each launch, untimed.  A
    sleep kernel queued ahead of the start event keeps the card busy while
    the host queues ``fn``'s launches, so the host's wrapper time stays
    outside the measured window."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def run_ms(fn, inputs: tuple, n: int = 20, copies: int = 4) -> float:
    """Per-launch device time of ``fn(*inputs)`` in a run of ``n``
    back-to-back launches: one CUDA-event pair around the run, divided by
    ``n``, over ``copies`` rotating copies of the batch inputs (the tables
    stay as they are), after one warm-up.  The sleep ahead of the start
    event is lengthened until it outlasts the host's queueing of the run,
    so the card never waits on the host inside the window."""
    import torch

    def copy(x):            # a pinned host input stays pinned
        if not x.is_cuda and x.is_pinned():
            return torch.empty_like(x, pin_memory=True).copy_(x)
        return x.clone()

    sets = [inputs] + [tuple(copy(x) for x in inputs)
                       for _ in range(copies - 1)]
    fn(*inputs)
    cycles = 20 * SLEEP_CYCLES
    while True:
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        a.record()
        for i in range(n):
            fn(*sets[i % copies])
        b.record()
        outran = a.query()          # the sleep ended before the last launch
        b.synchronize()
        if not outran:
            return a.elapsed_time(b) / n
        check(cycles < 1000 * SLEEP_CYCLES, "run_ms: the host cannot queue "
              "the run inside a ~1 s sleep")
        cycles *= 4


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def walk_traffic(tm, trie, tokens, lengths, sys_flags, K: int,
                 max_probes: int) -> dict:
    """What the trie walk needs on these inputs, from a replay of it.

    ``values``: the table values it must read, 4 bytes each in the bound
    (each node field it uses, parent and word per probe round, the child
    on a hit); ``records``: the 16-byte records it loads (a node per live
    lane and level, an edge-table slot per probe round), one 32-byte
    sector each; ``ops``: int32 thread operations (each next-frontier
    selection the kernel makes: ~6 per lane for each of its n live
    candidates and ~6 to place them where n ≤ RANK_MAX, else the 64-wide
    sort network; ~8 per probe round, ~20 per hashed lane); ``ranked`` /
    ``sorts``: the selections made each way; ``live``: the mean live
    frontier per level over all topics and ``walking`` over the topics
    whose frontier is not empty yet."""
    import torch
    B, L = tokens.shape
    toks = torch.cat([tokens, torch.zeros_like(tokens[:, :1])], 1)
    frontier = torch.full((B, K), -1, dtype=torch.int32, device=tokens.device)
    frontier[:, 0] = 0
    last = lengths.clamp(0, L)
    values = records = probes = lanes = ranked = sorts = select_ops = 0
    live, walking = [], []
    for i in range(L + 1):
        valid = frontier >= 0
        n_live = valid.sum(1)
        live.append(float(n_live.float().mean()))
        walking.append(float(n_live[n_live > 0].float().mean())
                       if bool((n_live > 0).any()) else 0.0)
        node = torch.where(valid, frontier, 0).long()
        adv = (i < lengths)[:, None]
        open_ = ~(sys_flags & (i == 0))[:, None]
        values += int((valid & (i <= lengths)[:, None] & open_).sum()
                      + (valid & (i == lengths)[:, None]).sum()
                      + (valid & adv & open_).sum())
        records += int(valid.sum())
        exact, iters = tm._probe_exact(trie, torch.where(adv, frontier, -1),
                                       toks[:, i:i + 1].expand(B, K),
                                       max_probes)
        n_it = int(iters.sum())
        probes += n_it
        records += n_it
        lanes += int((valid & adv).sum())
        values += 2 * n_it + int((exact >= 0).sum())
        plus = torch.where(valid & adv & open_, trie.plus_child[node], -1)
        nxt = torch.cat([exact, plus], 1)
        n_next = (nxt >= 0).sum(1)
        selects = (i < last) & (n_next > 0)
        rank = selects & (n_next <= RANK_MAX)
        ranked += int(rank.sum())
        sorts += int((selects & ~rank).sum())
        select_ops += int((n_next[rank] + 1).sum()) * 32 * 6
        frontier = torch.sort(nxt, dim=1, descending=True).values[:, :K]
    # the network: 21 compare-exchange stages over 64 values (shuffle,
    # compare, select)
    ops = select_ops + sorts * 64 * 21 * 3 + probes * 8 + lanes * 20
    return dict(values=values, records=records, ops=ops, ranked=ranked,
                sorts=sorts, live=live, walking=walking)


def walk_bytes(traffic: dict, B: int, L: int, out_bytes: int,
               inputs: bool = True) -> tuple[int, int]:
    """(needed bytes, bytes with a 32-byte sector per record) of a walk:
    the topic inputs (when ``inputs``), its outputs and its table reads."""
    io = (B * (L * 4 + 4 + 1) if inputs else 0) + out_bytes
    return (io + traffic["values"] * 4,
            io + traffic["records"] * SECTOR)


def fanout_pool_work(rowmap, pool, fids) -> tuple[int, int, int]:
    """(bytes, operations, scattered accesses) that ``fanout_pool`` needs
    on these inputs: the fids, a rowmap word per valid fid, each used pool
    row once and the output; a compare and a select per fid and an OR per
    word of each selected row; a scattered rowmap word per valid fid."""
    import torch
    B, M = fids.shape
    W = pool.shape[1]
    valid = fids >= 0
    prow = rowmap[torch.where(valid, fids, 0).long()]
    dense = valid & (prow >= 0)
    used = torch.unique(prow[dense])
    return (B * M * 4 + int(valid.sum()) * 4 + used.numel() * W * 4
            + B * W * 4, B * M * 2 + int(dense.sum()) * W, int(valid.sum()))


def fanout_bitmaps_work(bitmaps, fids) -> tuple[int, int, int]:
    """The same for ``fanout_bitmaps``: the fids, each used bitmap row once
    and the output; one scattered row per valid fid."""
    import torch
    B, M = fids.shape
    F, W = bitmaps.shape
    valid = (fids >= 0) & (fids < F)
    rows = torch.unique(fids[valid]).numel()
    return (B * M * 4 + rows * W * 4 + B * W * 4,
            B * M * 2 + int(valid.sum()) * W, int(valid.sum()))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def load(n_filters: int, seed: int, device) -> dict:
    from emqx_tpu_torch import RouterModel, TrieIndex
    from emqx_tpu_torch.router.trie import Trie
    rng = np.random.default_rng(seed)
    t0 = time.time()
    filters = build_filters(n_filters, rng)
    slot_of = rng.integers(0, 8192, len(filters)).tolist()
    model = RouterModel(TrieIndex(max_levels=8), n_sub_slots=8192, K=32,
                        M=128, kernel_telemetry=True, device=device)
    subs: dict[str, dict[int, int]] = {}
    for f, s in zip(filters, slot_of):
        model.subscribe(f, s)
        d = subs.setdefault(f, {})
        d[s] = d.get(s, 0) + 1
    t1 = time.time()
    model.refresh()
    torch_sync(device)
    t2 = time.time()
    oracle = Trie()
    for f in subs:
        oracle.insert(f)
    t3 = time.time()
    arrays = model.index.arrays
    trie = model._trie_dev
    log(f"load: {len(subs)} distinct filters, {arrays.n_nodes} nodes, "
        f"H={arrays.ht_parent.shape[0]} N={arrays.plus_child.shape[0]}, "
        f"trie records {(trie.edges.numel() + trie.nodes.numel()) * 4} "
        f"bytes; "
        f"subscribe {t1 - t0:.1f}s, refresh (build + upload) "
        f"{t2 - t1:.1f}s, oracle {t3 - t2:.1f}s")
    live = [f for f in model.index.filters if f is not None]
    # the set-up heap (the oracle's ~7M nodes and dicts above all) is the
    # smoke's, not the router's: freeze it so the cyclic GC does not walk
    # it for seconds inside the timed phases
    gc.collect()
    gc.freeze()
    return dict(model=model, subs=subs, oracle=oracle, rng=rng, live=live,
                n_vehicles=max(1000, n_filters // 2), bcast=set())


def add_broadcast(st: dict, slots: dict | None = None) -> None:
    """Subscribe 24 broadcast filters to 96 slots each (>64: promoted into
    the dense pool) and refresh.  ``fleet/+/vehicle/+/part/+/m{m}`` for all
    16 metrics matches nearly every 7-level topic, so this is the
    heavy-fan-out mix, not bench.py's own.  ``slots`` repeats an earlier
    overlay's slots."""
    model, rng, subs = st["model"], st["rng"], st["subs"]
    bcast = [f"fleet/+/vehicle/+/part/+/m{m}" for m in range(16)] + [
        f"fleet/f{fl}/#" for fl in range(0, 512, 64)]
    if slots is None:
        slots = {f: rng.choice(8192, 96, replace=False).tolist()
                 for f in bcast}
    for f in bcast:
        check(f not in subs, f"broadcast filter {f!r} is already subscribed")
        st["oracle"].insert(f)
        subs[f] = dict.fromkeys(slots[f], 1)
        for s in slots[f]:
            model.subscribe(f, s)
    model.refresh()
    torch_sync(model.device)
    check(len(model._dense_row) >= 16, "broadcast filters not promoted")
    st["bcast"], st["bcast_slots"] = set(bcast), slots


def remove_broadcast(st: dict) -> None:
    """Take the broadcast overlay off the model, the oracle and the
    subscription table: back to the plain mix's subscriptions."""
    model, subs = st["model"], st["subs"]
    for f in st["bcast"]:
        for s in subs.pop(f):
            model.unsubscribe(f, s)
        st["oracle"].delete(f)
    model.refresh()
    torch_sync(model.device)
    st["bcast"] = set()


def run_step(model, args, ret_cap: int | None, with_counters: bool = True):
    """The model's device step (flat or sharded) on uploaded ``(tokens,
    lengths, sys_flags)``, its counters packed unless ``with_counters`` is
    False."""
    return model._step(
        model._trie_dev, model._rowmap_dev, model._pool_dev, *args,
        K=model.K, M=model.M, max_probes=model.index.max_probes,
        ret_cap=ret_cap, with_counters=with_counters)


def path_counts(name: str, counts: dict | None = None) -> dict:
    """Read the launch counts after a path (or take ``counts``, a mesh
    path's :class:`Windows`) and check that it launched each of its
    kernels."""
    import torch

    from emqx_tpu_torch.ops import _build
    if counts is None:
        torch.cuda.synchronize()
        counts = _build.launch_counts()
    log(f"launches on the {name} path: {json.dumps(counts)}")
    missing = [k for k in PATHS[name] if counts[k] == 0]
    check(not missing, f"the {name} path launched no {missing}: {counts}")
    return {k: counts[k] for k in PATHS[name]}


def step_launches(st: dict) -> dict:
    """One device step on the dense mix's first batch, with the counters
    on and then off: each must raise the launch counts of its walk and of
    fanout_pool by exactly one each, and no other."""
    import torch

    from emqx_tpu_torch.ops import _build
    model = st["model"]
    tok, lens, sysf, _ = model.index.tokenize(st["big"][0])
    args = [torch.from_numpy(x).to(model.device) for x in (tok, lens, sysf)]
    walk = "walk_compact_sharded" if model._sharded else "walk_compact"
    for with_counters in (True, False):
        before = _build.launch_counts()
        run_step(model, args, model.ret_cap, with_counters)
        torch_sync(model.device)
        delta = {k: v - before[k] for k, v in _build.launch_counts().items()
                 if v != before[k]}
        check(delta == {walk: 1, "fanout_pool": 1},
              f"one step (counters {with_counters}) launched {delta}, not "
              f"its walk and fanout_pool once")
    log(f"step launches ({st.get('name', 'flat')} trie, counters on and "
        f"off): {json.dumps(delta)}")
    return delta


def spin_traced(prepare, what: str) -> tuple[list[str], int]:
    """The device events of ``prepare(attempt)()`` under torch.profiler,
    between two spin kernels that bracket it on the card's clock, and the
    sessions it took.  A session that kept fewer than both spins dropped
    device events near its edges (sessions opened minutes into a long
    process have done so) and is repeated with more idle host time around
    the work, at most three times; ``prepare`` runs before each session,
    untraced."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    for attempt, pad_s in enumerate((0.2, 1.0, 3.0, 10.0)):
        work = prepare(attempt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(pad_s)
            work()
            torch.cuda.synchronize()
            time.sleep(pad_s)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == cuda]
        spins = sum("spin_kernel" in n for n in names)
        if spins == 2:
            return [n for n in names if "spin_kernel" not in n], attempt + 1
        log(f"{what}: the trace kept {spins} of its 2 spin kernels with "
            f"{pad_s} s around it; again")
    raise SmokeFailure(f"the profiler kept no whole trace of {what}")


def traced_step(st: dict, with_counters: bool = True) -> dict:
    """One device step on the dense mix's first batch (uploaded), traced
    by :func:`spin_traced`: the device must run the walk, the memset of
    the counters and fan_any (of fan_any alone with the counters off), and
    the fan-out, and no other kernel or copy."""
    import torch
    model, tag = st["model"], st.get("name", "flat")
    tag = f"{tag} trie, counters {'on' if with_counters else 'off'}"
    tok, lens, sysf, _ = model.index.tokenize(st["big"][0])
    args = [torch.from_numpy(x).to(model.device) for x in (tok, lens, sysf)]
    run_step(model, args, model.ret_cap, with_counters)
    work, sessions = spin_traced(
        lambda _: lambda: run_step(model, args, model.ret_cap, with_counters),
        f"traced step ({tag})")
    kinds = [sum(k in n for n in work)
             for k in ("walk_compact_kernel", "Memset", "row_or_kernel<true")]
    check(kinds == [1, 1, 1] and len(work) == 3,
          f"the traced step ({tag}) ran {work}, not the walk, the memset "
          f"and the fan-out once each")
    out = {"device_events": work, "sessions": sessions}
    log(f"traced step ({tag}): " + json.dumps(out))
    return out


def torch_sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def check_against_oracle(st: dict, topics, result, sample) -> int:
    matched, _aux, slots, fallback = result
    model, oracle, subs = st["model"], st["oracle"], st["subs"]
    fb = set(fallback)
    L = model.index.max_levels
    for b in sample:
        want = set(oracle.match(topics[b]))
        if b in fb:
            check(len(topics[b].split("/")) > L or len(want) > model.ret_cap,
                  f"fallback row {b} ({topics[b]!r}) is neither too long "
                  f"nor over ret_cap")
            continue
        check(set(matched[b]) == want and len(matched[b]) == len(want),
              f"topic {topics[b]!r}: matched {sorted(matched[b])} != oracle "
              f"{sorted(want)}")
        want_slots = sorted({s for f in want for s in subs[f]})
        check(slots[b] == want_slots,
              f"topic {topics[b]!r}: slots differ from the oracle's")
    return len(sample)


def slice_phase(st: dict, batch: int, mix: str, n_big: int = 8,
                n_small: int = 8, lat_big: int = 20,
                lat_small: int = 200) -> dict:
    """publish_batch and the device step at ``batch`` and 64 topics.  Where
    ``st`` holds a ``cross`` list, the checked topics and their results are
    kept there for :func:`cross_check`."""
    import torch
    model, rng = st["model"], st["rng"]
    big = [make_topics(st["live"], rng, batch, st["n_vehicles"])
           for _ in range(n_big)]
    small = [make_topics(st["live"], rng, 64, st["n_vehicles"])
             for _ in range(n_small)]
    checked = 0
    t0 = time.time()
    results = [model.publish_batch(t) for t in big]
    t_big = time.time() - t0
    cross = st.get("cross")          # set on the sharded phase's state
    for topics, res in zip(big, results):
        sample = rng.choice(len(topics), min(len(topics), -(-2048 // n_big)),
                            replace=False).tolist()
        checked += check_against_oracle(st, topics, res, sample)
        if cross is not None:
            cross.append((mix, [topics[b] for b in sample],
                          [tuple(r[b] for r in res[:3]) for b in sample],
                          {sample.index(b) for b in res[3] if b in sample}))
    n_fallback = sum(len(r[3]) for r in results)
    for topics in small:
        checked += check_against_oracle(st, topics, model.publish_batch(
            topics), range(len(topics)))
    check(checked >= 2048, f"only {checked} topics checked")
    dense_hit = sum(bool(set(m) & st["bcast"]) for r in results
                    for m in r[0])
    check(dense_hit > 0 or not st["bcast"],
          "no topic matched a dense-pool filter")
    slots_per_topic = float(np.mean([len(x) for r in results for x in r[2]]))
    del results

    class Stages:           # the model's telemetry hook: per-batch stages
        def __init__(self):
            self.by_b: dict[int, list] = {}

        def on_batch(self, counters, *, n_topics, submit_ns, step_ns,
                     decode_ns, **_):
            self.by_b.setdefault(n_topics, []).append(
                (submit_ns / 1e6, step_ns / 1e6, decode_ns / 1e6))

    stages = Stages()
    model.telemetry = stages

    # synchronous latencies: publish_batch end to end (host clock), and
    # the device step alone on uploaded tokens
    def lat(topics_list, reps):
        ts = []
        for i in range(reps):
            t = time.perf_counter()
            model.publish_batch(topics_list[i % len(topics_list)])
            ts.append((time.perf_counter() - t) * 1e3)
        return ts

    def step_args(topics):
        tok, lens, sysf, _ = model.index.tokenize(topics)
        dev = model.device
        return [torch.from_numpy(x).to(dev) for x in (tok, lens, sysf)]

    def step_lat(args_list, reps):
        ts = []
        for i in range(reps):
            torch_sync(model.device)
            t = time.perf_counter()
            run_step(model, args_list[i % len(args_list)], model.ret_cap)
            torch_sync(model.device)
            ts.append((time.perf_counter() - t) * 1e3)
        return ts

    pub_big, pub_small = lat(big, lat_big), lat(small, lat_small)
    model.telemetry = None
    big_args = [step_args(t) for t in big]
    small_args = [step_args(t) for t in small]
    step_big, step_small = step_lat(big_args, lat_big), \
        step_lat(small_args, lat_small)
    # device-step throughput: 8 launches in flight, synchronised at the end
    torch_sync(model.device)
    t = time.perf_counter()
    for _ in range(4):
        for a in big_args:
            run_step(model, a, model.ret_cap)
    torch_sync(model.device)
    step_tps = 4 * len(big_args) * batch / (time.perf_counter() - t)

    out = {
        "publish_topics_per_s": n_big * batch / t_big,
        "step_topics_per_s": step_tps,
        f"publish_{batch}": pct(pub_big), "publish_64": pct(pub_small),
        f"step_{batch}": pct(step_big), "step_64": pct(step_small),
        "checked_topics": checked, "fallback_rows": n_fallback,
        "dense_matched_topics": dense_hit,
        "slots_per_topic": slots_per_topic,
    }
    # median submit (tokenize + upload + launch), wait (device step and
    # copy back) and decode, in ms, per publish_batch size
    for n, rows in stages.by_b.items():
        med = np.median(np.asarray(rows), axis=0).tolist()
        out[f"publish_{n}_stages_ms"] = dict(zip(
            ("submit", "wait", "decode"), med))
    log(f"slice ({st.get('name', 'flat')} trie, {mix} mix): "
        + json.dumps(out))
    st["big"] = big
    return out


def churn_filters(st: dict, n: int) -> tuple[list, list]:
    """``n`` new filters of the tree (one in four with a '+'), named after
    the phase's state so each churn adds its own, and ``n`` subscribed
    exact filters of one slot to remove."""
    rng, subs = st["rng"], st["subs"]
    tag = st.get("name", "flat")
    new = sorted({f"fleet/f{fl}/vehicle/v{tag}{i}/part/p{i % 8}/m{i % 16}"
                  if i % 4 else
                  f"fleet/f{fl}/vehicle/v{tag}{i}/part/+/m{i % 16}"
                  for i, fl in enumerate(rng.integers(0, 512, n).tolist())})
    candidates = [f for f, s in subs.items()
                  if "+" not in f and "#" not in f and len(s) == 1]
    return new, [candidates[i] for i in
                 rng.choice(len(candidates), n, replace=False).tolist()]


def apply_churn(st: dict, model, new: list, gone: list) -> None:
    """Subscribe ``new`` (filter i to slot i) and unsubscribe ``gone``
    through ``model``, keeping the phase's table and oracle in step."""
    subs, oracle = st["subs"], st["oracle"]
    for i, f in enumerate(new):
        model.subscribe(f, i)
        subs[f] = {i: 1}
        oracle.insert(f)
    for f in gone:
        for s, c in subs.pop(f).items():
            for _ in range(c):
                model.unsubscribe(f, s)
        oracle.delete(f)


def churn_probe(st: dict, model, new: list, gone: list) -> None:
    """After a churn: each new filter routes to its slot, no removed one
    routes, and the probe topics equal the host oracle."""
    probe = [f.replace("+", "p3") for f in new] + gone
    matched, _, slots, fallback = res = model.publish_batch(probe)
    check(not fallback, f"fallback rows in the churn probe: {fallback}")
    for b, f in enumerate(new):
        check(f in matched[b] and b in slots[b],
              f"new filter {f!r} does not route")
    for b, f in enumerate(gone, start=len(new)):
        check(f not in matched[b], f"removed filter {f!r} still routes")
    check_against_oracle(st, probe, res, range(len(probe)))


def churn_phase(st: dict) -> dict:
    import torch

    from emqx_tpu_torch.models import router_model as rm
    model = st["model"]
    new, gone = churn_filters(st, 256)
    uploads, patches = model.upload_count, model.patch_count
    apply_churn(st, model, new, gone)
    shards = getattr(model.index, "shards", [model.index])
    pending = max(sum(len(ix.pending[n]) for ix in shards)
                  for n in shards[0].pending)
    cap = rm._patch_bucket(max(pending, len(model._rowmap_dirty),
                               len(model._pool_dirty)))
    # the refresh's host part and any cyclic-GC pause inside the window
    # are logged beside its total, to tell host, GC and device time apart
    gc_ms = []

    def on_gc(phase, _info, start=[0.0]):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            gc_ms.append((time.perf_counter() - start[0]) * 1e3)

    gc.callbacks.append(on_gc)
    staged_ns = model.patch_upload_ns
    try:
        t = time.perf_counter()
        model.refresh()
        host_ms = (time.perf_counter() - t) * 1e3
        torch_sync(model.device)
        refresh_ms = (time.perf_counter() - t) * 1e3
    finally:
        gc.callbacks.remove(on_gc)
    check(model.upload_count == uploads,
          "churn refresh re-uploaded the tables instead of patching")
    check(model.patch_count == patches + 1, "churn refresh did not patch")
    churn_probe(st, model, new, gone)
    out = {"subscribed": len(new), "unsubscribed": len(gone),
           "refresh_ms": refresh_ms, "refresh_host_ms": host_ms,
           "refresh_upload_ms": (model.patch_upload_ns - staged_ns) / 1e6,
           "gc_ms_in_refresh": sum(gc_ms), "patch_cap": cap}
    if torch.device(model.device).type == "cuda":
        out["traced_refresh"] = traced_refresh(st)
    log(f"churn ({st.get('name', 'flat')} trie): " + json.dumps(out))
    return out


def traced_refresh(st: dict) -> dict:
    """8 more subscribes, then one refresh traced by :func:`spin_traced`:
    the session must hold the patch kernel and no copy (the kernel reads
    the pinned update block in place), and the new filters must route
    after it."""
    model, tag = st["model"], st.get("name", "flat")
    new = []

    def prepare(attempt):
        new[:] = [f"fleet/f{i}/vehicle/v{tag}t{attempt}{i}/part/p1/m1"
                  for i in range(8)]
        for i, f in enumerate(new):
            model.subscribe(f, 100 + i)
        patches = model.patch_count

        def work():
            model.refresh()
            check(model.patch_count == patches + 1,
                  "traced refresh did not patch")
        return work

    names, sessions = spin_traced(prepare, f"traced refresh ({tag} trie)")
    copies = [n for n in names if "Memcpy" in n or "HtoD" in n]
    check(any("patch_kernel" in n for n in names),
          f"the traced refresh shows no patch kernel: {names}")
    check(not copies, f"the traced refresh copies to the card: {copies}")
    matched, _, slots, _ = model.publish_batch(new)
    for b, f in enumerate(new):
        check(f in matched[b] and 100 + b in slots[b],
              f"new filter {f!r} does not route after the traced refresh")
    return {"device_events": names, "memcpy": len(copies),
            "sessions": sessions}


def dense_bitmaps(model, subs: dict):
    """The dense ``[F, W]`` subscriber bitmap of every (filter, slot) of
    the subscription table, F = the model's fid space, on its device."""
    import torch
    F, W = len(model.index.filters), model.bitmap_words
    fids, slots = [], []
    for f, d in subs.items():
        fid = model.index.fid_of(f)
        check(fid is not None, f"subscribed filter {f!r} has no fid")
        fids += [fid] * len(d)
        slots += list(d)
    fids, slots = np.asarray(fids, np.int64), np.asarray(slots, np.int64)
    key = fids * W + slots // 32
    bit = np.left_shift(np.uint64(1), (slots % 32).astype(np.uint64))
    order = np.argsort(key, kind="stable")
    key, bit = key[order], bit[order]
    uniq, start = np.unique(key, return_index=True)
    words = np.zeros(F * W, np.uint32)
    words[uniq] = np.bitwise_or.reduceat(bit, start).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32).reshape(F, W)).to(
        model.device)


def bitmap_phase(st: dict) -> dict:
    """The heavy-fan-out form on the flat model: a dense bitmap row per
    filter, ORed by fanout_bitmaps over each topic's untrimmed [B, M]
    compacted fids and counted by bitmap_to_counts.  The dense-mix batches
    are published again (the churn changed the table since the slice);
    each batch's counts must equal the plain popcount's, and each topic's
    count its decoded slot count outside the fallback rows."""
    import torch

    from emqx_tpu_torch.ops import fanout as fo
    model = st["model"]
    t = time.time()
    bitmaps = dense_bitmaps(model, st["subs"])
    torch_sync(model.device)
    t_build = time.time() - t
    checked = n_fallback = 0
    first = None
    for topics in st["big"]:
        _, _, slots, fallback = model.publish_batch(topics)
        tok, lens, sysf, _ = model.index.tokenize(topics)
        args = [torch.from_numpy(x).to(model.device)
                for x in (tok, lens, sysf)]
        fids = run_step(model, args, ret_cap=None)[0]
        fan = fo.fanout_bitmaps(bitmaps, fids)
        counts = fo.bitmap_to_counts(fan)
        check(torch.equal(counts, fo.bitmap_to_counts_plain(fan)),
              "bitmap_to_counts != plain on a bitmap-path batch")
        counts = counts.cpu().numpy()
        fb = set(fallback)
        for b in range(len(topics)):
            if b in fb:
                continue
            check(counts[b] == len(slots[b]),
                  f"topic {topics[b]!r}: bitmap count {counts[b]} != "
                  f"{len(slots[b])} decoded slots")
            checked += 1
        n_fallback += len(fb)
        if first is None:
            first = dict(bitmaps=bitmaps, fids=fids, fan=fan)
    out = {"filters": bitmaps.shape[0], "words": bitmaps.shape[1],
           "bitmap_bytes": bitmaps.numel() * 4, "build_s": t_build,
           "checked_topics": checked, "fallback_rows": n_fallback,
           "fids_width": first["fids"].shape[1]}
    log("bitmap: " + json.dumps(out))
    check(checked >= 2048, f"only {checked} bitmap counts checked")
    return first


def load_sharded(st: dict, n_shards: int) -> dict:
    """The flat model's subscriptions (broadcast overlay off) in a
    RouterModel on ShardedTrieIndex(n_shards), refreshed; returns its
    phase state, which shares the oracle and the subscription table."""
    from emqx_tpu_torch import RouterModel, ShardedTrieIndex
    remove_broadcast(st)
    t0 = time.time()
    model = RouterModel(ShardedTrieIndex(n_shards, max_levels=8),
                        n_sub_slots=8192, K=32, M=128, kernel_telemetry=True,
                        device=st["model"].device)
    for f, d in st["subs"].items():
        for s, c in d.items():
            for _ in range(c):
                model.subscribe(f, s)
    t1 = time.time()
    model.refresh()
    torch_sync(model.device)
    t2 = time.time()
    trie = model._trie_dev
    info = {
        "shards": n_shards,
        "filters": [sum(f is not None for f in ix.filters)
                    for ix in model.index.shards],
        "nodes": [ix.arrays.n_nodes for ix in model.index.shards],
        "shard_N": [ix.arrays.plus_child.shape[0]
                    for ix in model.index.shards],
        "H": trie.edges.shape[1], "padded_N": trie.nodes.shape[1],
        "stacked_bytes": (trie.edges.numel() + trie.nodes.numel()) * 4,
        "fid_space": len(model.index.filters),
        "rebuilds": model.index.rebuild_count,
        "subscribe_s": t1 - t0, "refresh_s": t2 - t1,
    }
    log("load (sharded trie): " + json.dumps(info))
    gc.collect()
    gc.freeze()
    return dict(st, model=model, flat=st["model"], name=f"s{n_shards}",
                bcast=set(), cross=[])


def cross_check(sh: dict, bcast_slots: dict) -> int:
    """The sharded model's checked topics against the flat model's
    results: the same matched filters (as sets: the sharded merge is
    shard-major) and slots, outside the union of both fallback sets.  The
    flat model holds the plain mix's subscriptions, as the sharded one did
    in its plain slice; it gets the same broadcast overlay before the
    dense mix's topics."""
    flat = sh["flat"]
    n = 0
    for mix, topics, got, fb_sh in sorted(sh["cross"], key=lambda c:
                                          c[0] != "plain"):
        if mix == "dense" and not flat._dense_row:
            for f, slots in bcast_slots.items():
                for s in slots:
                    flat.subscribe(f, s)
            flat.refresh()
        matched, _, slots, fallback = flat.publish_batch(topics)
        skip = fb_sh | set(fallback)
        for i, (m, _aux, sl) in enumerate(got):
            if i in skip:
                continue
            check(sorted(m) == sorted(matched[i]) and sl == slots[i],
                  f"{mix} topic {topics[i]!r}: sharded {sorted(m)} / "
                  f"{len(sl)} slots != flat {sorted(matched[i])} / "
                  f"{len(slots[i])} slots")
            n += 1
    log(f"sharded vs flat: {n} topics agree outside the fallback rows")
    check(n >= 2048, f"only {n} topics cross-checked")
    return n


# ---------------------------------------------------------------------------
# the mesh paths: RouterModel(mesh=...) over one card four times
# ---------------------------------------------------------------------------


def card_mesh(shape: tuple, device="cuda:0"):
    """A ``shape`` mesh of the card repeated (the driver's machine has one
    card): every partition, gather, patch route and counter fold runs for
    real; only the cross-card waits are trivially met."""
    import torch

    from emqx_tpu_torch.parallel.mesh import make_mesh
    n = shape[0] * shape[1]
    return make_mesh(n, shape=shape, devices=[torch.device(device)] * n)


class Windows:
    """A mesh path's launch counts, summed over its windows: each window
    sets every count to 0 just before a stretch of the path's own work and
    reads them just after.  The single-card model the path compares with
    runs between windows, where no count is read."""

    def __init__(self):
        self.counts: dict = {}

    def __enter__(self):
        from emqx_tpu_torch.ops import _build
        _build.reset_launch_counts()
        return self

    def __exit__(self, *exc):
        import torch

        from emqx_tpu_torch.ops import _build
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        for k, v in _build.launch_counts().items():
            self.counts[k] = self.counts.get(k, 0) + v
        return False


def mesh_clone(proto, mesh):
    """A RouterModel on ``mesh`` over ``proto``'s index and host state,
    taken as the reference's ``sharded_trie_models`` fixture takes it
    (``tests/test_multichip_scale.py``): no second 1M build, one upload."""
    import torch

    from emqx_tpu_torch import RouterModel
    m = RouterModel(proto.index, n_sub_slots=proto.n_sub_slots, K=proto.K,
                    M=proto.M, ret_cap=proto.ret_cap,
                    dense_threshold=proto.dense_threshold, mesh=mesh,
                    kernel_telemetry=True)
    m._subs, m._aux_refs = proto._subs, proto._aux_refs
    m._sub_mask, m._aux_mask = proto._sub_mask, proto._aux_mask
    m._dense_row, m._row_free = dict(proto._dense_row), list(proto._row_free)
    m._next_row = proto._next_row
    m._rowmap_host = proto._rowmap_host.copy()
    m._pool_host = proto._pool_host.copy()
    m.refresh()
    torch_sync(m.device)
    return m


def resync(proto, m) -> None:
    """The single-card model back in step with the mesh model that changed
    their shared index: its host state the mesh model's, its trie and pool
    uploaded whole (the mesh model drained the index's updates)."""
    proto._subs, proto._aux_refs = m._subs, m._aux_refs
    proto._sub_mask, proto._aux_mask = m._sub_mask, m._aux_mask
    proto._dense_row, proto._row_free = dict(m._dense_row), list(m._row_free)
    proto._next_row = m._next_row
    proto._trie_dev = proto._pool_host = None
    proto._rowmap_dirty.clear()
    proto._pool_dirty.clear()
    proto.refresh()


def mesh_launches(m) -> dict:
    """The launches of one mesh step: each kernel of the step once per
    device (the merged compact too on the sharded trie)."""
    n = m.mesh.size
    if m._sharded:
        return {"walk_compact_sharded": n, "compact": n, "fanout_pool": n}
    return {"walk_compact": n, "fanout_pool": n}


def mesh_compare(m, proto, topics, what: str, win: Windows) -> dict:
    """``topics`` through the single-card model first (outside the path's
    windows), then in a window through the mesh model's
    ``publish_batch_submit`` / ``collect``: equal results; and the raw
    step on the same batch, counters on and off: the five outputs equal
    the single card's exactly, and one mesh step launches what
    :func:`mesh_launches` says."""
    import torch

    from emqx_tpu_torch.ops import _build
    tok, lens, sysf, _ = m.index.tokenize(topics)
    sh = m.shardings["batch_dp" if m._sharded else "batch_full"]
    grids = [sh.split(torch.from_numpy(x)) for x in (tok, lens, sysf)]
    single = [torch.from_numpy(x).to(proto.device)
              for x in (tok, lens, sysf)]
    timed = len(topics) == BATCH and m.device.type == "cuda"

    def step(model, a):
        return lambda: model._step_block(
            model._trie_dev, model._rowmap_dev, model._pool_dev, *a,
            K=model.K, M=model.M, max_probes=model.index.max_probes,
            ret_cap=model.ret_cap)

    def sync_ms(fn):
        ts = []
        for _ in range(20):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return float(np.median(ts))

    want = proto.publish_batch(topics)
    refs = {wc: run_step(proto, single, proto.ret_cap, wc)
            for wc in (True, False)}
    out = {"topics": len(topics), "single_publish_ms": None}
    if timed:
        # the step as publish_batch_submit launches it (its packed blocks,
        # no assembly): its device time per step in a back-to-back run of
        # 10 (the card four times: every device's stream is the card's
        # one; a run of 10 stays inside the stream's queue of launches),
        # and a synchronous step's host wall, p50 of 20; the single
        # card's beside them
        t = time.perf_counter()
        proto.publish_batch(topics)
        out["single_publish_ms"] = (time.perf_counter() - t) * 1e3
        out["single_step_run_ms"] = run_ms(step(proto, single), (), n=10)
        out["single_step_sync_ms"] = sync_ms(step(proto, single))
    with win:
        t = time.perf_counter()
        got = m.publish_batch_collect(m.publish_batch_submit(topics))
        out["publish_ms"] = (time.perf_counter() - t) * 1e3
        check(got == want, f"{what}: the mesh's publish results differ "
              f"from the single card's")
        for wc in (True, False):
            before = _build.launch_counts()
            res = run_step(m, grids, m.ret_cap, wc)
            torch_sync(m.device)
            delta = {k: v - before[k]
                     for k, v in _build.launch_counts().items()
                     if v != before[k]}
            check(delta == mesh_launches(m), f"{what}: one mesh step "
                  f"(counters {wc}) launched {delta}, not "
                  f"{mesh_launches(m)}")
            check(steps_equal(res, refs[wc]), f"{what}: the mesh step's "
                  f"five outputs (counters {wc}) differ from the single "
                  f"card's")
        if timed:
            out["step_run_ms"] = run_ms(step(m, grids), (), n=10)
            out["step_sync_ms"] = sync_ms(step(m, grids))
    dense = {m.index.filters[f] for f in m._dense_row}
    out["fallback_rows"] = len(got[3])
    out["dense_hits"] = sum(bool(dense.intersection(x)) for x in got[0])
    return out


def overlay(m, slots: dict, on: bool) -> None:
    """The broadcast overlay subscribed (``on``) or lifted through ``m``,
    then one refresh, which must patch and not re-upload."""
    ups = m.upload_count
    for f, ss in slots.items():
        for s in ss:
            (m.subscribe if on else m.unsubscribe)(f, s)
    m.refresh()
    torch_sync(m.device)
    check(m.upload_count == ups, "the overlay re-uploaded the mesh's tables")


def mesh_churn(ms: dict, m) -> dict:
    """Churn through the mesh model: MESH_CHURN new filters and as many
    unsubscribed in one refresh, which patches and does not re-upload (a
    patch launch on every device holding an updated element); new filters
    route, removed ones do not, the probe equals the host oracle; then the
    churn undone the same way; then one new filter, whose refresh patches
    only the devices holding its element (every device of the flat trie's
    replicas, the owning tp rank's of a sharded trie)."""
    import torch

    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.parallel.mesh import DP, TP
    from emqx_tpu_torch.router.index import shard_of_filter
    subs, oracle, tag = ms["subs"], ms["oracle"], ms["name"]
    new, gone = churn_filters(ms, MESH_CHURN)
    gone_slots = {f: subs[f] for f in gone}
    ups, pats = m.upload_count, m.patch_count

    def refresh(what):
        before = _build.launch_counts()["patch"]
        t = time.perf_counter()
        m.refresh()
        torch_sync(m.device)
        ms_ = (time.perf_counter() - t) * 1e3
        check(m.upload_count == ups, f"{what} re-uploaded the tables")
        return _build.launch_counts()["patch"] - before, ms_

    apply_churn(ms, m, new, gone)
    launched, refresh_ms = refresh("the churn")
    check(m.patch_count == pats + 1, "the churn refresh did not patch")
    check(launched == m.mesh.size, f"the churn patched {launched} devices, "
          f"not all {m.mesh.size}")
    churn_probe(ms, m, new, gone)
    for i, f in enumerate(new):
        m.unsubscribe(f, i)
        subs.pop(f)
        oracle.delete(f)
    for f in gone:
        for s, c in gone_slots[f].items():
            for _ in range(c):
                m.subscribe(f, s)
        subs[f] = gone_slots[f]
        oracle.insert(f)
    undone, _ = refresh("undoing the churn")
    one = f"fleet/f1/vehicle/v{tag}one/part/p1/m1"
    m.subscribe(one, 7)
    owners, _ = refresh("one subscribe")
    want = m.mesh.size
    if m._sharded:
        want = m.mesh.shape[DP]       # the owning tp rank's devices
        rank = shard_of_filter(one, m.n_shards) // (
            m.n_shards // m.mesh.shape[TP])
    check(owners == want, f"one subscribe patched {owners} devices, not "
          f"the {want} that hold its element")
    check(one in m.publish_batch([one.replace("+", "p1")])[0][0],
          f"{one!r} does not route on the mesh")
    m.unsubscribe(one, 7)
    refresh("one unsubscribe")
    out = {"subscribed": len(new), "unsubscribed": len(gone),
           "refresh_ms": refresh_ms, "patch_launches": launched,
           "undo_patch_launches": undone, "one_filter_patch_launches": owners,
           "uploads": m.upload_count, "patches": m.patch_count}
    if m._sharded:
        out["one_filter_tp_rank"] = rank
    return out


def mesh_failure(m) -> dict:
    """D1 over a card mesh, with the failure inside the mesh step: the
    walk raising on the mesh's second device (the first device's walk
    queued), the fan-out raising on its second device (every walk, the
    first device's gather and fan-out queued), and the assembly of the
    devices' blocks raising at collect.  A Broker over the mesh model
    re-raises the first two at submit and the third at collect; no batch
    is served from the host and no failover is counted.  Over a CPU mesh
    (the plain versions; its assembly runs at submit) the broker fails
    over to the host each time and counts it, as the reference does."""
    from emqx_tpu_torch.broker.broker import Broker
    from emqx_tpu_torch.core.message import Message
    from emqx_tpu_torch.models import router_model as rm
    from emqx_tpu_torch.observe.metrics import Metrics
    on_card = m.device.type == "cuda"
    metrics = Metrics()
    broker = Broker(node="mesh", router_model=m, metrics=metrics)
    if on_card:
        walk = ("launch_walk_compact_sharded" if m._sharded
                else "launch_walk_compact")
        fan = "launch_fanout_pool"
    else:
        walk = ("match_compact_sharded_plain" if m._sharded
                else "match_compact_plain")
        fan = "fanout_pool_plain"
    out = {}
    for owner, name, nth, stage in ((rm.tm, walk, 2, "submit"),
                                    (rm.fo, fan, 2, "submit"),
                                    (rm, "assemble", 1, "collect")):
        real, calls = getattr(owner, name), [0]

        def failing(*a, _real=real, _name=name, _nth=nth, **k):
            calls[0] += 1
            if calls[0] == _nth:
                raise RuntimeError(f"the mesh step failed in {_name}")
            return _real(*a, **k)

        setattr(owner, name, failing)
        where = None
        try:
            token = broker.publish_batch_submit(
                [Message(topic="fleet/f1/x", payload=b"x")])
            where = "collect"
            broker.publish_batch_collect(token)
        except RuntimeError as e:
            check(on_card and f"failed in {name}" in str(e),
                  f"a failing {name} over a CPU mesh raised: {e}")
            check(where == (None if stage == "submit" else "collect"),
                  f"a failing {name} raised at "
                  f"{where or 'submit'}, not at {stage}")
        else:
            check(not on_card, f"a failing {name} in the mesh step was "
                  f"served from the host")
        finally:
            setattr(owner, name, real)
        check(calls[0] == nth, f"{name} was called {calls[0]} times, not "
              f"{nth}")
        out[name] = "raised at " + stage if on_card else "failed over"
    want = 0 if on_card else 3
    check(metrics.val("messages.device_failover") == want,
          f"{metrics.val('messages.device_failover')} failovers counted "
          f"over a {m.device.type} mesh, not {want}")
    return out


def align_to_subs(st: dict) -> int:
    """Bring the single-card model's filter set to the subscription table
    (the flat model never saw the sharded path's churn); returns the
    filters added or removed."""
    model, subs = st["model"], st["subs"]
    have = {f for f in model.index.filters if f is not None}
    n = 0
    for f in have - subs.keys():
        for s, c in dict(model._subs[model.index.fid_of(f)]).items():
            for _ in range(c):
                model.unsubscribe(f, s)
        n += 1
    for f in subs.keys() - have:
        for s, c in subs[f].items():
            for _ in range(c):
                model.subscribe(f, s)
        n += 1
    model.refresh()
    return n


def mesh_path(st: dict, shape: tuple, name: str, extra=None,
              device="cuda:0") -> tuple:
    """One mesh path over the single-card model of ``st`` (whose broadcast
    overlay is on): the mesh model cloned from it on ``shape``; the dense
    mix (the slices' first B=16384 batch and 64 of it), the overlay lifted
    through the mesh model, the plain mix (16384 and 64 new topics,
    sampled against the host oracle), the churn, D1, the overlay back;
    each batch through submit / collect and the raw step equal to the
    single card's (:func:`mesh_compare`).  ``extra(m, proto, st, win)``
    runs more on the mesh model's host state (mesh_s4's (1, 4) mesh).
    The mesh model's work runs in the windows of one :class:`Windows`; the
    single card's (its alignment, its results, its resyncs) between them.
    Returns the path's results and its windows' launch counts."""
    import torch
    proto = st["model"]
    aligned = align_to_subs(st)
    win = Windows()
    with win:
        t = time.time()
        m = mesh_clone(proto, card_mesh(shape, device))
    devices = [str(d) for d in m.mesh.devices.flat]
    log(f"{name}: {'S=%d' % m.n_shards if m._sharded else 'flat'} trie on "
        f"a {shape} mesh of {devices} in {time.time() - t:.1f} s")
    out = {"shape": list(shape), "devices": devices, "aligned": aligned}
    dense = st["big"][0]
    out["dense"] = mesh_compare(m, proto, dense, f"{name} dense 16384", win)
    out["dense_64"] = mesh_compare(m, proto, dense[:64], f"{name} dense 64",
                                   win)
    check(out["dense"]["dense_hits"] > 0, f"{name}: no dense-pool match")
    slots = st["bcast_slots"]
    with win:
        overlay(m, slots, on=False)
    for f in slots:
        st["subs"].pop(f)
        st["oracle"].delete(f)
    resync(proto, m)
    rng = st["rng"]
    ms = dict(st, model=m, name=name)
    for B in (BATCH, 64):
        topics = make_topics(st["live"], rng, B, st["n_vehicles"])
        out[f"plain_{B}"] = mesh_compare(m, proto, topics,
                                         f"{name} plain {B}", win)
        n = min(B, MESH_ORACLE)
        with win:
            check_against_oracle(ms, topics, m.publish_batch(topics[:n]),
                                 range(n))
    with win:
        out["churn"] = mesh_churn(ms, m)
    resync(proto, m)
    out["plain_after_churn"] = mesh_compare(
        m, proto, make_topics(st["live"], rng, 64, st["n_vehicles"]),
        f"{name} plain 64 after the churn", win)
    with win:
        out["failure"] = mesh_failure(m)
    if extra is not None:
        out.update(extra(m, proto, st, win))
    with win:
        overlay(m, slots, on=True)
    for f, ss in slots.items():
        st["subs"][f] = dict.fromkeys(ss, 1)
        st["oracle"].insert(f)
    st["bcast"] = set(slots)
    resync(proto, m)
    out["dense_after"] = mesh_compare(m, proto, dense[:64],
                                      f"{name} dense 64, the overlay back",
                                      win)
    del m
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    log(f"{name} path: " + json.dumps(out))
    return out, win.counts


def mesh_wide(m, proto, st: dict, win: Windows) -> dict:
    """mesh_s4's second mesh, (1, 4): one shard a device, the plain mix's
    64 topics; the batch and the raw step equal the single card's."""
    with win:
        w = mesh_clone(proto, card_mesh(MESH_WIDE, proto.device))
    topics = make_topics(st["live"], st["rng"], 64, st["n_vehicles"])
    return {"wide": {"shape": list(MESH_WIDE), **mesh_compare(
        w, proto, topics, f"mesh_s4 {MESH_WIDE} plain 64", win)}}


def mesh_phase(st: dict, sh: dict, device="cuda:0") -> dict:
    """The paths ``mesh`` (the flat trie on a (2, 2) mesh) and ``mesh_s4``
    (the S=4 trie on (2, 2), then (1, 4) at B=64), each with its launch
    counts summed over its windows (:class:`Windows`: every count set to 0
    just before each stretch of the path's own work, read just after).
    Returns the counts and each path's results."""
    counts, out = {}, {}
    out["mesh"], win = mesh_path(st, MESH_SHAPE, "mesh", device=device)
    counts["mesh"] = path_counts("mesh", win)
    out["mesh_s4"], win = mesh_path(sh, MESH_SHAPE, "mesh_s4",
                                    extra=mesh_wide, device=device)
    counts["mesh_s4"] = path_counts("mesh_s4", win)
    return counts, out


@contextlib.contextmanager
def env_var(name: str, value: str):
    """The environment variable ``name`` set to ``value`` inside."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


class DryrunTap:
    """Standard output during a dry run (``entry.dryrun_multichip``): keeps
    what it prints and splits its launches between two :class:`Windows`.
    The flat leg's window is open from the start; its line (``dryrun_
    multichip OK:``, printed after the flat leg's last launch and before
    the sharded leg's first) closes it and opens the sharded leg's, which
    :meth:`close` closes."""

    def __init__(self, flat: Windows, sharded: Windows):
        self.flat, self.sharded, self.text = flat, sharded, []
        self.flat.__enter__()

    def write(self, s: str) -> int:
        self.text.append(s)
        if s.startswith("dryrun_multichip OK:"):
            self.flat.__exit__(None, None, None)
            self.sharded.__enter__()
        return len(s)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.sharded.__exit__(None, None, None)


@contextlib.contextmanager
def recorded_batches():
    """Every ``RouterModel.publish_batch`` call made inside, as ``(model,
    topics, result)``."""
    from emqx_tpu_torch.models.router_model import RouterModel
    calls, orig = [], RouterModel.publish_batch

    def publish_batch(self, topics):
        res = orig(self, topics)
        calls.append((self, list(topics), res))
        return res

    RouterModel.publish_batch = publish_batch
    try:
        yield calls
    finally:
        RouterModel.publish_batch = orig


def dryrun(n: int, devices, windows: tuple, filters: int,
           device) -> dict:
    """``entry.dryrun_multichip(n, devices)`` at ``filters`` filters, its
    launches in ``windows`` (the flat leg's, the sharded leg's); each
    leg's lines checked (at least 100,000 distinct filters at 200,000;
    the flat leg equal to the oracle on all 64 topics, the sharded leg on
    every non-fallback one, which the run asserts) and its
    ``publish_batch`` result equal to a single-device ``_build_model``
    twin's on ``device`` (built outside the windows)."""
    from emqx_tpu_torch import entry as E
    tap = DryrunTap(*windows)
    t = time.time()
    with env_var("GRAFT_DRYRUN_FILTERS", str(filters)), \
            recorded_batches() as calls, contextlib.redirect_stdout(tap):
        E.dryrun_multichip(n, devices=devices)
    tap.close()
    secs = time.time() - t
    lines = "".join(tap.text).splitlines()
    check(len(lines) == 2 and lines[0].startswith("dryrun_multichip OK: ")
          and lines[1].startswith("dryrun_multichip sharded OK: ")
          and len(calls) == 2, f"dry run over {n}: printed {lines}, "
          f"{len(calls)} publish_batch calls")
    for line in lines:
        log(line)
    distinct = int(re.search(r" filters=(\d+) ", lines[0]).group(1))
    check(distinct >= 100_000 or filters < 200_000,
          f"dry run over {n}: {distinct} distinct filters")
    check(lines[0].endswith(" oracle_parity=64/64"),
          f"dry run over {n}: {lines[0]}")
    t_twin = time.time()
    for model, topics, res in calls:
        # the twin runs the step, also on the CPU (a model reads the
        # variable when it is built)
        with env_var("EMQX_TPU_CPU_KERNEL", "xla"):
            twin = E._build_model(
                n_filters=filters, n_slots=model.n_sub_slots,
                trie_shards=model.n_shards if model._sharded else None,
                device=device)
        want = twin.publish_batch(topics)
        check(res == want, f"dry run over {n} (S={model.n_shards}): the "
              f"mesh's result differs from the single-device twin's")
    return {"n": n, "mesh": list(calls[0][0].mesh.devices.shape),
            "filters": distinct, "lines": lines, "seconds": secs,
            "twin_seconds": time.time() - t_twin}


def entry_phase(card: str, device="cuda:0",
                filters: int = DRYRUN_FILTERS) -> tuple[dict, dict]:
    """The paths ``entry`` and ``entry_s4``: the port's entry points
    (``emqx_tpu_torch/entry.py``) as its user calls it.  ``entry()`` on
    ``device``: ``fn(*args)`` equals ``router_step_plain`` on CPU copies
    of its arguments exactly, with the counters off (None) and on, each
    call one launch of the walk and one of the fan-out; then
    ``dryrun_multichip(4)`` over the card four times ((2, 2)) and
    ``dryrun_multichip(1)`` (``python -m emqx_tpu_torch.entry`` on one
    card) at ``filters`` filters (:func:`dryrun`).  ``entry``'s launches
    are summed over the entry() calls and the flat legs' windows,
    ``entry_s4``'s over the sharded legs'."""
    import torch

    from emqx_tpu_torch import entry as E
    from emqx_tpu_torch.models import router_model as rm
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.ops import trie_match as tm
    t_start = time.time()
    flat, sharded = Windows(), Windows()
    with flat:
        fn, args = E.entry(device=device)
    trie = tm.DeviceTrie(edges=args[0].edges.cpu(), nodes=args[0].nodes.cpu())
    cpu_args = (trie, *(a.cpu() for a in args[1:]))
    on_card = torch.device(device).type == "cuda"
    steps = {}
    for with_counters in (False, True):
        want = rm.router_step_plain(*cpu_args, **fn.keywords,
                                    with_counters=with_counters)
        with flat:
            before = _build.launch_counts()
            got = fn(*args, with_counters=with_counters)
            torch_sync(device)
            delta = {k: v - before[k] for k, v in
                     _build.launch_counts().items() if v != before[k]}
        check(delta == ({"walk_compact": 1, "fanout_pool": 1} if on_card
                        else {}), f"entry: one call launched {delta}")
        check(steps_equal([None if g is None else g.cpu() for g in got],
                          want), f"entry: fn(*args) != the plain step "
              f"(with_counters={with_counters})")
        steps[f"counters_{'on' if with_counters else 'off'}"] = delta
        if not with_counters:
            shapes = [None if o is None else list(o.shape) for o in got]
    log(f"entry OK: {shapes} ({card}); launches a call "
        f"{json.dumps(steps)}")
    runs = [dryrun(4, [torch.device(device)] * 4, (flat, sharded), filters,
                   device)]
    if on_card:
        runs.append(dryrun(min(8, torch.cuda.device_count()), None,
                           (flat, sharded), filters, device))
    counts = {"entry": path_counts("entry", flat.counts),
              "entry_s4": path_counts("entry_s4", sharded.counts)}
    out = {"card": card, "entry_shapes": shapes, "dryruns": runs,
           "seconds": time.time() - t_start}
    log("entry phase: " + json.dumps(
        {"card": card, "seconds": out["seconds"],
         "dryruns": [{k: r[k] for k in ("n", "mesh", "filters", "seconds",
                                        "twin_seconds")} for r in runs]}))
    return counts, out


def idle_phase(st: dict) -> dict:
    """The card's idle share inside one ``publish_batch`` of the dense mix,
    from a torch.profiler trace: 1 - (union of the device's kernel and copy
    intervals that fall inside the call) / the call's span, both on the
    trace's clock.  A trace with no device event is reported as not
    measured, not as an idle card."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    model, topics = st["model"], st["big"][0]
    model.publish_batch(topics)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("smoke_publish_batch"):
            model.publish_batch(topics)
        torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # the range shows up twice: on the host, and as a device-side
    # annotation that is no device work of its own
    call = [e for e in events if e.name == "smoke_publish_batch"
            and e.device_type != cuda]
    check(len(call) == 1, "the profiler lost the publish_batch span")
    lo, hi = call[0].time_range.start, call[0].time_range.end
    spans = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                   for e in events
                   if e.device_type == cuda and e.name != call[0].name
                   and not getattr(e, "is_user_annotation", False)
                   and e.time_range.end > lo and e.time_range.start < hi)
    busy, end = 0.0, lo
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    dtoh = sum("DtoH" in e.name for e in events if e.device_type == cuda
               and e.time_range.end > lo and e.time_range.start < hi)
    out = {"batch": len(topics), "call_ms": (hi - lo) / 1e3,
           "device_events": len(spans), "device_busy_ms": busy / 1e3,
           "idle_share": 1 - busy / (hi - lo) if spans else None,
           "dtoh_copies": dtoh if spans else None}
    log(("idle: " if spans else "idle: not measured (no device event in "
         "the trace): ") + json.dumps(out))
    check(not spans or dtoh == 1, f"publish_batch copied its results back "
          f"in {dtoh} copies, not in one")
    return out


def small_tries(tm, fo, device) -> int:
    """Kernel == plain on small random tries that reach the edge rows:
    '$' topics, empty and unknown levels, too-long topics, K=4 overflow,
    M=8 truncation, C < M (K=4, L=5: C=48 < M=128); both walk modes and
    the compacts, and the sharded ones on the same filters at S ∈ {1, 4},
    where one shard's step equals the flat step bit for bit; then a trie
    of every ``{a, +}`` path, whose frontiers double per level, so the
    walk selects next frontiers both ways (ranked and by the sort
    network, checked by replay); the count-only walk against its plain
    version and the candidate walk's count; the fused steps with the
    counters on and off; the bitmap kernels on random bitmaps, and both
    fan-outs at the shapes of :func:`fanout_shapes`."""
    import torch

    from emqx_tpu_torch.models import router_model as rm
    from emqx_tpu_torch.router.index import ShardedTrieIndex, TrieIndex
    rng = np.random.default_rng(7)
    alphabet = ["a", "b", "c", "", "$SYS", "+", "#"]

    def random_case(levels):
        filters = []
        for _ in range(3000):
            ws = [alphabet[i] for i in rng.integers(0, 7, rng.integers(1, 8))]
            if "#" in ws:
                ws = ws[: ws.index("#") + 1]
            filters.append("/".join(ws))
        # 999 topics: a ragged last block in every launch
        topics = ["/".join(alphabet[i] if i < 5 else "zz" for i in
                           rng.integers(0, 6, rng.integers(1, levels + 3)))
                  for _ in range(999)]
        return filters, topics

    def wide_case(levels):
        paths = [[]]
        for _ in range(levels):
            paths = [p + [w] for p in paths for w in ("a", "+")]
        filters = sorted({"/".join(p[:n]) + tail for p in paths
                          for n in range(1, levels + 1)
                          for tail in ("", "/#")})
        topics = ["/".join(rng.choice(["a", "b"], rng.integers(1, levels + 1),
                                      p=[0.9, 0.1])) for _ in range(999)]
        return filters, topics

    cases = [(random_case, K, M, levels) for K, M, levels in
             [(32, 128, 6), (4, 8, 6), (8, 16, 5), (32, 8, 8), (4, 128, 5)]]
    cases += [(wide_case, 32, 128, 6), (wide_case, 16, 8, 6)]
    n = ranked = sorts = 0
    for make, K, M, levels in cases:
        filters, topics = make(levels)
        ix = TrieIndex(max_levels=levels)
        sharded = {S: ShardedTrieIndex(S, max_levels=levels) for S in (1, 4)}
        for f in filters:
            if f:
                ix.insert(f)
                for six in sharded.values():
                    six.insert(f)
        tok, lens, sysf, _ = ix.tokenize(topics)
        args = [torch.from_numpy(x).to(device) for x in (tok, lens, sysf)]
        trie = tm.device_trie(ix.ensure(), device)
        traffic = walk_traffic(tm, trie, *args, K, ix.max_probes)
        ranked += traffic["ranked"]
        sorts += traffic["sorts"]
        cand, stats = tm.match_batch_stats(trie, *args, K=K,
                                           max_probes=ix.max_probes)
        want = tm.match_batch_plain(trie, *args, K=K,
                                    max_probes=ix.max_probes)
        check(torch.equal(cand, want[0]) and torch.equal(stats, want[1]),
              f"trie walk != plain on a small trie (K={K})")
        fids, trunc = tm.compact_fids(cand, M=M)
        wf, wt = tm.compact_fids_plain(cand, M=M)
        check(torch.equal(fids, wf) and torch.equal(trunc, wt),
              f"compact != plain on a small trie (M={M})")
        got = tm.match_compact(trie, *args, K=K, M=M,
                               max_probes=ix.max_probes)
        want = tm.match_compact_plain(trie, *args, K=K, M=M,
                                      max_probes=ix.max_probes)
        check(all(torch.equal(g, w) for g, w in zip(got, want))
              and torch.equal(got[0], fids),
              f"walk_compact != plain on a small trie (K={K}, M={M})")
        got = tm.match_counts(trie, *args, K=K, max_probes=ix.max_probes)
        want = tm.match_counts_plain(trie, *args, K=K,
                                     max_probes=ix.max_probes)
        check(all(torch.equal(g, w) for g, w in zip(got, want))
              and torch.equal(got[0], (cand >= 0).sum(1, dtype=torch.int32))
              and torch.equal(got[1], stats[:, 3] != 0),
              f"walk_count != plain or the cand walk's count on a small "
              f"trie (K={K})")
        F = len(ix.filters) + 8
        rowmap = torch.full((F,), -1, dtype=torch.int32)
        rowmap[torch.from_numpy(rng.choice(F, 40, replace=False))] = \
            torch.arange(40, dtype=torch.int32)
        pool = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (64, 7))
                                .astype(np.int32))
        rowmap, pool = rowmap.to(device), pool.to(device)
        check(torch.equal(fo.fanout_pool(rowmap, pool, fids),
                          fo.fanout_pool_plain(rowmap, pool, fids)),
              "fanout != plain on a small trie")
        for ret_cap, wc in ((4, True), (None, True), (4, False)):
            kw = dict(K=K, M=M, max_probes=ix.max_probes, ret_cap=ret_cap,
                      with_counters=wc)
            check(steps_equal(rm.router_step(trie, rowmap, pool, *args, **kw),
                              rm.router_step_plain(trie, rowmap, pool, *args,
                                                   **kw)),
                  f"fused step != plain on a small trie (K={K}, M={M}, "
                  f"ret_cap={ret_cap}, counters {wc})")
        if K == 4 and M == 8:
            check(bool(stats[:, 3].any()) and bool(trunc.any()),
                  "small tries reach no overflow or truncation")
        for S, six in sharded.items():
            strie = tm.stacked_device_trie(six.ensure(), device)
            scand, sstats = tm.match_batch_sharded_stats(
                strie, *args, K=K, max_probes=six.max_probes)
            want = tm.match_batch_sharded_plain(strie, *args, K=K,
                                                max_probes=six.max_probes)
            check(torch.equal(scand, want[0]) and torch.equal(sstats, want[1]),
                  f"sharded walk != plain on a small trie (S={S}, K={K})")
            got = tm.compact_sharded(scand, M=M, n_shards=S)
            want = tm.compact_sharded_plain(scand, M=M, n_shards=S)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"sharded compact != plain on a small trie (S={S}, M={M})")
            got = tm.match_compact_sharded(strie, *args, n_shards=S, K=K,
                                           M=M, max_probes=six.max_probes)
            want = tm.match_compact_sharded_plain(
                strie, *args, n_shards=S, K=K, M=M,
                max_probes=six.max_probes)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"walk_compact_sharded != plain on a small trie (S={S}, "
                  f"K={K}, M={M})")
            if K == 4 and M == 8:
                check(bool(got[2].any()),
                      f"small sharded tries reach no truncation (S={S})")
            for ret_cap, wc in ((4, True), (None, True), (4, False)):
                kw = dict(K=K, M=M, max_probes=six.max_probes,
                          ret_cap=ret_cap, n_shards=S, with_counters=wc)
                check(steps_equal(
                    rm.router_step_sharded(strie, rowmap, pool, *args, **kw),
                    rm.router_step_sharded_plain(strie, rowmap, pool, *args,
                                                 **kw)),
                      f"fused sharded step != plain on a small trie (S={S}, "
                      f"K={K}, M={M}, ret_cap={ret_cap}, counters {wc})")
            if S == 1:
                kw = dict(K=K, M=M, max_probes=ix.max_probes, ret_cap=4,
                          with_counters=True)
                flat = rm.router_step(trie, rowmap, pool, *args, **kw)
                one = rm.router_step_sharded(strie, rowmap, pool, *args,
                                             n_shards=1, **kw)
                check(all(torch.equal(a, b) for a, b in zip(flat[:4], one))
                      and torch.equal(flat[4], one[4][0]),
                      f"one-shard step != flat step (K={K}, M={M})")
        n += 1
    check(ranked > 0 and sorts > 0, f"the small tries select next frontiers "
          f"{ranked} times ranked and {sorts} times by the network")
    log(f"small tries: {ranked} ranked and {sorts} network selections")
    bitmaps = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (500, 7))
                               .astype(np.int32)).to(device)
    fids = torch.from_numpy(rng.integers(-1, 500, (300, 40))
                            .astype(np.int32)).to(device)
    fan = fo.fanout_bitmaps(bitmaps, fids)
    check(torch.equal(fan, fo.fanout_bitmaps_plain(bitmaps, fids)),
          "fanout_bitmaps != plain on random bitmaps")
    check(torch.equal(fo.bitmap_to_counts(fan),
                      fo.bitmap_to_counts_plain(fan)),
          "bitmap_to_counts != plain on random bitmaps")
    log(f"fan-out shapes: {fanout_shapes(fo, device, rng)} agree")
    return n


def steps_equal(got, want) -> bool:
    """The five step outputs equal, dtypes and shapes included (counters
    None on both sides where they are off)."""
    import torch
    return all((g is None and w is None) or (
        g is not None and w is not None and g.dtype == w.dtype
        and g.shape == w.shape and torch.equal(g, w))
        for g, w in zip(got, want))


def fused_steps(st: dict, sh: dict) -> int:
    """The fused steps against their plain composites on the card, all five
    outputs exactly: flat and S=4, on the dense mix's first batch (B=16384)
    and its first 64 topics, with the models' ret_cap and with none.  With
    the counters off each step's counters are None and its other four
    outputs those of the counted step, also when it writes into a block
    whose every byte was 0xFF first (fan_any's memset)."""
    import torch

    from emqx_tpu_torch.models import router_model as rm
    n = 0
    for s, fused, plain in ((st, rm.router_step, rm.router_step_plain),
                            (sh, rm.router_step_sharded,
                             rm.router_step_sharded_plain)):
        model = s["model"]
        kw = dict(K=model.K, M=model.M, max_probes=model.index.max_probes)
        if model._sharded:
            kw["n_shards"] = model.n_shards
        tables = (model._trie_dev, model._rowmap_dev, model._pool_dev)
        tag = s.get("name", "flat")
        for batch in (s["big"][0], s["big"][0][:64]):
            tok, lens, sysf, _ = model.index.tokenize(batch)
            args = [torch.from_numpy(x).to(model.device)
                    for x in (tok, lens, sysf)]
            for ret_cap in (model.ret_cap, None):
                got = fused(*tables, *args, ret_cap=ret_cap,
                            with_counters=True, **kw)
                want = plain(*tables, *args, ret_cap=ret_cap,
                             with_counters=True, **kw)
                check(steps_equal(got, want),
                      f"fused step != plain ({tag} trie, B={len(batch)}, "
                      f"ret_cap={ret_cap})")
                off = fused(*tables, *args, ret_cap=ret_cap, **kw)
                check(steps_equal(off, plain(*tables, *args, ret_cap=ret_cap,
                                             **kw))
                      and off[4] is None and steps_equal(off[:4], got[:4]),
                      f"counters-off step != its plain composite or the "
                      f"counted step ({tag} trie, B={len(batch)}, "
                      f"ret_cap={ret_cap})")
                size = rm.router_step_block(*tables, *args, ret_cap=ret_cap,
                                            **kw)[0].numel()
                dirty = torch.full((size,), 0xFF, dtype=torch.uint8,
                                   device=model.device)
                block, regions = rm.router_step_block(
                    *tables, *args, ret_cap=ret_cap, out=dirty, **kw)
                check(steps_equal(rm.step_views(block, regions), off),
                      f"counters-off step into a 0xFF block != the step "
                      f"({tag} trie, B={len(batch)}, ret_cap={ret_cap})")
                n += 1
    log(f"fused steps: {n} cases equal their plain composites, counters "
        f"on and off")
    return n


def telemetry_off(st: dict) -> dict:
    """A RouterModel with kernel telemetry off, and its twin with it on,
    on the card with the same 5000 of the load's filters (and 16
    broadcast filters, promoted into the dense pool): one
    ``publish_batch(64)`` through each gives the same results, the host
    oracle's, and hands the recording hook None and the ``[C]`` counters.
    """
    from emqx_tpu_torch import RouterModel, TrieIndex
    from emqx_tpu_torch.ops import trie_match as tm
    from emqx_tpu_torch.router.trie import Trie
    rng = np.random.default_rng(17)
    live = st["live"][:5000]
    bcast = [f"fleet/+/vehicle/+/part/+/m{m}" for m in range(16)]

    class Hook:
        def __init__(self):
            self.counters = []

        def on_batch(self, counters, **_):
            self.counters.append(counters)

    oracle = Trie()
    for f in live + bcast:
        oracle.insert(f)
    topics = make_topics(live, rng, 64, st["n_vehicles"])
    out = {}
    for on in (True, False):
        model = RouterModel(TrieIndex(max_levels=8), n_sub_slots=8192,
                            kernel_telemetry=on, device=st["model"].device)
        for i, f in enumerate(live):
            model.subscribe(f, i % 8192)
        for f in bcast:
            for s in range(70):
                model.subscribe(f, s)
        model.telemetry = hook = Hook()
        out[on] = model.publish_batch(topics)
        check(len(hook.counters) == 1, "the hook saw no batch")
        c = hook.counters[0]
        check((c is None) if not on else (
            c is not None and c.shape == (len(tm.KERNEL_COUNTER_FIELDS),)),
              f"kernel_telemetry={on}: on_batch got {c!r}")
    check(out[True] == out[False], "telemetry on and off route differently")
    matched, _, _, fallback = out[False]
    for b, t in enumerate(topics):
        check(b in fallback or sorted(matched[b]) == sorted(oracle.match(t)),
              f"telemetry-off model: topic {t!r} matched {matched[b]}")
    res = {"topics": len(topics), "fallback_rows": len(fallback),
           "dense_matched_topics": sum(bool(set(m) & set(bcast))
                                       for m in matched)}
    check(res["dense_matched_topics"] > 0, "no topic reached the dense pool")
    log("telemetry off: on_batch got None, results equal the counted "
        "model's and the oracle's: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# the serving plane: Broker, CM, PublishPipeline and the kernel fold over a
# RouterModel on the card
# ---------------------------------------------------------------------------


class RecordingChannel:
    """A CM channel that keeps, in order, what it is sent.  The parity
    harness (``tests/test_torch_harness.py``) keeps its own, and its own
    :class:`FoldTap`: it keys deliveries by qos too and pickles the blocks
    across processes, and the smoke imports nothing from the tests."""

    def __init__(self) -> None:
        self.got: list[tuple] = []
        self.conn_state = "connected"     # a shared pick asks

    def handle_deliver(self, items):
        return items

    def send(self, items) -> None:
        self.got.extend((t, m.topic, bytes(m.payload)) for t, m in items)


class FoldTap:
    """The model's telemetry hook: keeps every counters block and stage
    timing the model hands over, then hands them to the fold."""

    def __init__(self, fold) -> None:
        self.fold = fold
        self.blocks: list = []
        self.stages: list[tuple] = []
        self.sizes: list[int] = []

    def on_batch(self, counters, **kw) -> None:
        self.blocks.append(None if counters is None else np.array(counters))
        self.stages.append((kw["submit_ns"], kw["step_ns"], kw["decode_ns"]))
        self.sizes.append(kw["n_topics"])
        self.fold.on_batch(counters, **kw)

    def on_host_batch(self, n_topics: int) -> None:
        self.fold.on_host_batch(n_topics)


def set_telemetry(sv: dict, on: bool) -> None:
    """Counters packed and the fold attached, or neither: the model and
    the app around it as ``kernel_telemetry`` on or off leaves them."""
    sv["model"].set_kernel_telemetry(on)
    sv["model"].telemetry = sv["tap"] if on else None


def password(cid: str) -> str:
    """The built-in DB password of a wire client of the smoke; none for the
    native load generator's clients (``lgs<i>``, ``lgp<i>``), which send
    none."""
    return "" if cid.startswith("lg") else f"pw-{cid}"


def app_users(subs: int = NET_SUBS + NET_WS_SUBS,
              pubs: int = NET_PUBS + NET_WS_PUBS) -> list[str]:
    """Every client id that CONNECTs with credentials: the network phase's
    subscribers and publishers, the native path's (its wire clients and
    the load generator's) and the app leg's clients."""
    return ([f"n{i}" for i in range(subs)] + [f"np{j}" for j in range(pubs)]
            + [f"v{i}" for i in range(NAT_SUBS)]
            + [f"vp{j}" for j in range(NAT_PUBS)]
            # the load generator's: subscribers lgs0-7, publishers
            # lgp8-15 (one count over both)
            + [f"lgs{i}" for i in range(8)] + [f"lgp{i}" for i in range(8, 16)]
            + [f"a{i}" for i in range(APP_CONNECTS)]
            + [f"ap{j}" for j in range(APP_PUBS)]
            + ["aw", "ab", "af", "aa", "ax", "arw", "atm"])


def app_conf(data_dir: str, users: list[str]) -> str:
    """The HOCON config the serving leg boots from: the routing step on
    the card at the smoke's widths, a TCP, a WS and a ``native`` listener
    (the C++ host, its device lane on) on 127.0.0.1,
    a built-in DB of ``users`` keyed by client id (sha256, the schema's
    default hash), a file ACL that denies publishes on APP_SECRET and
    allows everything else (``no_match = deny``), flapping detection, one
    topic rewrite rule, one auto-subscribe template, and ``node.data_dir``
    in a temporary directory."""
    boot = ",\n".join(f'{{ user_id = "{u}", password = "{password(u)}" }}'
                       for u in users)
    src, regex, dest = APP_REWRITE
    return f"""
    node {{ name = "n1@127.0.0.1", data_dir = "{data_dir}" }}
    router.device {{
      enable = true, max_levels = 8, n_sub_slots = 8192, frontier_k = 32,
      match_cap = 128, return_cap = 16, batch_max = 512,
      pipeline_depth = 4, min_batch = 0
    }}
    listeners {{
      default {{ type = tcp, bind = "127.0.0.1:0" }}
      ws {{ type = ws, bind = "127.0.0.1:0" }}
      native {{ type = native, bind = "127.0.0.1:0", device_lane = "on" }}
    }}
    authentication = [{{
      mechanism = password_based, backend = built_in_database,
      user_id_type = clientid,
      bootstrap_users = [
{boot}
      ]
    }}]
    authorization {{
      no_match = deny
      sources = [{{ type = file,
        rules = "deny all publish {APP_SECRET}\\nallow all all #" }}]
    }}
    flapping_detect {{ enable = true, max_count = {APP_FLAP},
                       window_time = 60s, ban_time = 5m }}
    rewrite = [{{ action = publish, source_topic = "{src}",
                 re = "{regex}", dest_topic = "{dest}" }}]
    auto_subscribe.topics = [{{ topic = "{APP_AUTO}", qos = 1 }}]
    """


def boot_app(device, users: list[str], conf_of=app_conf,
             prefix: str = "chip_smoke_app_") -> tuple:
    """``BrokerApp.from_config`` of ``conf_of(data_dir, users)`` (the
    serving leg's :func:`app_conf` by default), as a deployment boots:
    the config parsed by the port's ``Config``, the app built with its
    ``RouterModel`` on the card (on a CPU rehearsal: that model on the CPU,
    through ``router_model=``), the boot's refresh timed.  The model is the
    one the boot built, with no host matcher, the pipeline's knee 0 and no
    implicit spill, and the kernel fold attached.  Returns the app, its
    config, its data directory and the boot's times."""
    import tempfile

    import torch

    from emqx_tpu_torch.app import BrokerApp
    from emqx_tpu_torch.config.config import Config
    from emqx_tpu_torch.models import router_model as rm
    from emqx_tpu_torch.observe.device_metrics import DeviceMetricsFold
    from emqx_tpu_torch.router.index import TrieIndex
    data_dir = tempfile.mkdtemp(prefix=prefix)
    t0 = time.perf_counter()
    conf = Config()
    conf.init_load(conf_of(data_dir, users))
    t1 = time.perf_counter()
    overrides, refresh_s = {}, []
    on_card = torch.device(device).type == "cuda"
    if not on_card:
        overrides["router_model"] = rm.RouterModel(
            TrieIndex(max_levels=8), n_sub_slots=8192, K=32, M=128,
            ret_cap=16, device=device)
    refresh = rm.RouterModel.refresh

    def timed_refresh(self, *a, **kw):
        t = time.perf_counter()
        out = refresh(self, *a, **kw)
        torch_sync(self.device)
        refresh_s.append(time.perf_counter() - t)
        return out

    rm.RouterModel.refresh = timed_refresh
    try:
        if not on_card:
            overrides["router_model"].refresh()
        app = BrokerApp.from_config(conf, **overrides)
    finally:
        rm.RouterModel.refresh = refresh
    t2 = time.perf_counter()
    model, pipe = app.broker.model, app.pipeline
    check(model is not None and model.device.type
          == torch.device(device).type and len(refresh_s) == 1,
          f"from_config built no model on {device}")
    check(model._host_matcher is None,
          "a model on the card serves from the host matcher")
    check(isinstance(app.device_metrics, DeviceMetricsFold)
          and model.telemetry is app.device_metrics,
          "the app's kernel fold is not the model's telemetry hook")
    check(pipe.min_device_batch == 0 and pipe.device_knee() == 0
          and pipe.spill_deadline_ms() is None and pipe.depth == 4
          and pipe.max_batch == 512,
          f"the app's pipeline over a model on {device} bypasses batches "
          f"to the host: knee {pipe.device_knee()}, spill "
          f"{pipe.spill_deadline_ms()} ms")
    boot = {"parse_s": t1 - t0, "app_build_s": t2 - t1 - refresh_s[0],
            "model_refresh_s": refresh_s[0], "users": len(users),
            "model_device": str(model.device)}
    return app, conf, data_dir, boot


def serving_load(n_filters: int, seed: int, device, shards: int | None,
                 sessions: int = SESSIONS, recorded: int = RECORDED,
                 users: list[str] | None = None, boot_fn=None) -> dict:
    """The port's Broker over a RouterModel on ``device``, the bench-shape
    filters (those :func:`load` makes from the same seed) subscribed
    through ``Broker.subscribe`` by ``sessions`` session ids (16 a slot of
    the 8192 at the defaults), the model refreshed; a CM with a recording
    channel for ``recorded`` of the session ids, a PublishPipeline at depth
    4 whose knee over the card's model must be 0 (every batch runs the
    step, no implicit spill), and a DeviceMetricsFold with the broker's
    Metrics and DegradationLedger behind a :class:`FoldTap`.  The flat leg
    (no ``shards``) is the app booted from its config (:func:`boot_app`,
    ``users`` in its built-in DB): the broker, CM, pipeline, fold, metrics
    and ledger are the app's.  The S=4 leg wires the same parts by hand,
    as the app wires them (its config builds a flat trie).  ``boot_fn``,
    where given, boots the flat leg's app in place of :func:`boot_app`
    (the durable path's second app)."""
    from emqx_tpu_torch import RouterModel, ShardedTrieIndex
    from emqx_tpu_torch.broker.broker import Broker
    from emqx_tpu_torch.broker.cm import CM
    from emqx_tpu_torch.broker.pipeline import PublishPipeline
    from emqx_tpu_torch.observe.device_metrics import DeviceMetricsFold
    from emqx_tpu_torch.observe.metrics import DegradationLedger, Metrics
    from emqx_tpu_torch.observe.trace import SpanCollector
    rng = np.random.default_rng(seed)
    t0 = time.time()
    app = conf = data_dir = boot = None
    if shards:
        model = RouterModel(ShardedTrieIndex(shards, max_levels=8),
                            n_sub_slots=8192, K=32, M=128, ret_cap=16,
                            kernel_telemetry=True, device=device)
        check(model._host_matcher is None,
              "a model on the card serves from the host matcher")
        metrics = Metrics()
        ledger = DegradationLedger(metrics)
        broker = Broker(node="n1", router_model=model, metrics=metrics)
        broker.ledger = ledger
        cm = CM()
        fold = DeviceMetricsFold(metrics, ledger=ledger,
                                 spans=SpanCollector(), model=model,
                                 node="n1")
        pipe = PublishPipeline(broker, cm)
        pipe.depth = 4
    else:
        app, conf, data_dir, boot = (boot_fn or functools.partial(
            boot_app, device, users or app_users()))()
        log("serve boot (from_config): " + json.dumps(boot))
        model, broker, cm = app.broker.model, app.broker, app.cm
        metrics, ledger, fold, pipe = (app.metrics, app.ledger,
                                       app.device_metrics, app.pipeline)
    t_sub = time.time()
    filters = build_filters(n_filters, rng)
    owners = rng.integers(0, sessions, len(filters)).tolist()
    for f, s in zip(filters, owners):
        broker.subscribe(f"c{s}", f)
    t1 = time.time()
    model.refresh()
    torch_sync(device)
    t2 = time.time()
    channels = {}
    for s in rng.choice(sessions, min(recorded, sessions // 2),
                        replace=False).tolist():
        channels[f"c{s}"] = RecordingChannel()
        cm.register_channel(f"c{s}", channels[f"c{s}"])
    model.telemetry = tap = FoldTap(fold)
    check(pipe.min_device_batch == 0 and pipe.device_knee() == 0
          and pipe.spill_deadline_ms() is None,
          f"the pipeline over a model on {device} bypasses batches to the "
          f"host: knee {pipe.device_knee()}, spill "
          f"{pipe.spill_deadline_ms()} ms")
    per_slot = [len(v) for v in broker.slots._sids_of.values()]
    info = {
        "trie": f"s{shards}" if shards else "flat",
        "app": app is not None,
        "subscriptions": len(filters),
        "distinct_filters": sum(f is not None for f in model.index.filters),
        "sessions": len(broker.subscription),
        "slots": len(per_slot),
        "sessions_per_slot": {"min": min(per_slot),
                              "mean": float(np.mean(per_slot)),
                              "max": max(per_slot)},
        "recorded_sessions": len(channels),
        "setup_s": t_sub - t0, "subscribe_s": t1 - t_sub,
        "refresh_s": t2 - t1,
    }
    log("serve load: " + json.dumps(info))
    gc.collect()
    gc.freeze()
    return dict(model=model, broker=broker, cm=cm, pipe=pipe, fold=fold,
                tap=tap, metrics=metrics, ledger=ledger, channels=channels,
                rng=rng, live=list(dict.fromkeys(filters)),
                n_vehicles=max(1000, n_filters // 2), sessions=sessions,
                name=info["trie"], batches=0, untapped=0,
                launch0=model.launch_count, app=app, conf=conf,
                data_dir=data_dir, boot=boot)


def serve_overlay(sv: dict) -> None:
    """The dense overlay through the broker: 24 broadcast filters (those
    of :func:`add_broadcast`), each subscribed by 96 session ids, then a
    refresh."""
    broker, rng = sv["broker"], sv["rng"]
    bcast = [f"fleet/+/vehicle/+/part/+/m{m}" for m in range(16)] + [
        f"fleet/f{fl}/#" for fl in range(0, 512, 64)]
    for f in bcast:
        for s in rng.choice(sv["sessions"], 96, replace=False).tolist():
            broker.subscribe(f"c{s}", f)
    sv["model"].refresh()
    torch_sync(sv["model"].device)
    check(len(sv["model"]._dense_row) >= 16,
          "broadcast filters not promoted into the dense pool")
    sv["bcast"] = set(bcast)


def messages(sv: dict, count: int) -> list:
    """``count`` messages of the subscribed tree; the payload is the
    message's place in its list."""
    from emqx_tpu_torch.core.message import Message
    return [Message(topic=t, payload=b"%d" % i) for i, t in enumerate(
        make_topics(sv["live"], sv["rng"], count, sv["n_vehicles"]))]


def sub_topics(deliveries: dict) -> dict:
    """A delivery map as ``{sid: sorted sub_topics}``."""
    return {sid: sorted(t for t, _ in items)
            for sid, items in deliveries.items()}


def serve_mix(sv: dict, mix: str, batch: int, n_batches: int, reps: int,
              n_check: int, card: str) -> dict:
    """``Broker.publish_batch`` on ``n_batches`` batches of ``batch``
    messages, ``reps`` (at least ``n_batches``) timed calls over them in
    turn, split into the hook fold (the broker's submit less the model's),
    the model's submit, wait and decode (its telemetry hook) and the
    delivery-map build (the broker's collect less the model's wait and
    decode); each batch's first call's delivery maps against the host
    path's (``Broker.publish``, the Router's oracle walk) on ``n_check``
    sampled messages in all, checked after the call is timed."""
    broker, rng, tap = sv["broker"], sv["rng"], sv["tap"]
    batches = [messages(sv, batch) for _ in range(n_batches)]
    per = -(-n_check // n_batches)
    checked = deliveries = 0
    rows = []
    for i in range(max(reps, n_batches)):
        msgs = batches[i % n_batches]
        n0 = len(tap.stages)
        t0 = time.perf_counter_ns()
        token = broker.publish_batch_submit(msgs)
        t1 = time.perf_counter_ns()
        maps = broker.publish_batch_collect(token)
        t2 = time.perf_counter_ns()
        sv["batches"] += 1
        check(len(tap.stages) == n0 + 1, "the model's hook saw no batch")
        sub, wait, dec = tap.stages[-1]
        rows.append((t2 - t0, t1 - t0 - sub, sub, wait, dec,
                     t2 - t1 - wait - dec))
        if i >= n_batches:
            continue
        deliveries += sum(len(v) for d in maps for v in d.values())
        for b in rng.choice(len(msgs), min(len(msgs), per),
                            replace=False).tolist():
            got, want = sub_topics(maps[b]), sub_topics(broker.publish(
                msgs[b]))
            check(got == want, f"{sv['name']} {mix} {msgs[b].topic!r}: the "
                  f"device path delivers {got}, the host path {want}")
            checked += 1
    check(checked >= n_check, f"only {checked} messages checked")
    ms = np.asarray(rows, dtype=np.float64) / 1e6
    out = {"card": card, "trie": sv["name"], "mix": mix, "batch": batch,
           "calls": len(rows), "checked_messages": checked,
           "deliveries_per_message": deliveries / (batch * n_batches)}
    for j, name in enumerate(("total", "hook_fold", "model_submit",
                              "model_wait", "model_decode", "map_build")):
        out[name] = pct(ms[:, j])
    log(f"serve_{sv['name']}_{mix}_{batch}: " + json.dumps(out))
    return out


def serve_pipeline(sv: dict, mix: str, n_msgs: int, card: str) -> dict:
    """``PublishPipeline.submit`` of ``n_msgs`` messages, then one
    ``flush`` on a worker thread (as the server's ``asyncio.to_thread``)
    while another thread subscribes 64 new filters in the model and
    refreshes after each (a patch): every batch runs the step on the default
    stream, and each recording channel gets, in submission order, what
    the host path delivers to its session."""
    import threading

    import torch
    model, pipe, broker = sv["model"], sv["pipe"], sv["broker"]
    msgs = messages(sv, n_msgs)
    for ch in sv["channels"].values():
        ch.got.clear()
    b0, h0, l0 = pipe.batches, pipe.host_batches, model.launch_count
    p0 = model.patch_count
    for m in msgs:
        pipe.submit(m)
    cuda = model.device.type == "cuda"
    streams, took = [], []
    # new filters the topics match, in the model only (the broker holds
    # no subscription to them, so they deliver nothing): each refresh
    # patches the trie while the steps run
    rng = sv["rng"]
    churn = [(f"fleet/f{k}/vehicle/+/part/p{q}/+", int(s)) for k, q, s in zip(
        rng.integers(0, 512, 64).tolist(), rng.integers(0, 8, 64).tolist(),
        rng.integers(0, 8192, 64).tolist())]

    def on_stream():
        if cuda:
            streams.append(torch.cuda.current_stream()
                           == torch.cuda.default_stream())

    def flush():
        on_stream()
        t = time.perf_counter()
        took.append((pipe.flush(), time.perf_counter() - t))

    def subscribe():
        on_stream()
        for f, s in churn:
            model.subscribe(f, s)
            model.refresh()

    threads = [threading.Thread(target=flush),
               threading.Thread(target=subscribe)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "a worker thread hangs")
    patches = model.patch_count - p0
    check(patches > 0, "the subscribing thread patched nothing")
    for f, s in churn:
        model.unsubscribe(f, s)
    model.refresh()
    check(all(streams), "a worker thread runs on a non-default stream")
    check(took and took[0][0] == n_msgs, f"the flush took {took}")
    n_batches = pipe.batches - b0
    sv["batches"] += n_batches
    check(n_batches == -(-n_msgs // pipe.max_batch),
          f"{n_batches} batches for {n_msgs} messages")
    check(pipe.host_batches == h0, "the pipeline served a batch on the host")
    check(model.launch_count - l0 == n_batches,
          f"{model.launch_count - l0} steps for {n_batches} batches")
    want = {sid: [] for sid in sv["channels"]}
    for m in msgs:
        for sid, items in broker.publish(m).items():
            if sid in want:
                want[sid].extend((t, m.topic, bytes(m.payload))
                                 for t, _ in items)
    got = 0
    for sid, ch in sv["channels"].items():
        check(sorted(ch.got) == sorted(want[sid]),
              f"{sv['name']} {mix}: channel {sid} got {len(ch.got)} "
              f"messages, the host path routes {len(want[sid])}")
        order = [int(p) for _, _, p in ch.got]
        check(order == sorted(order), f"channel {sid}: out of order")
        got += len(ch.got)
    out = {"card": card, "trie": sv["name"], "mix": mix, "depth": pipe.depth,
           "max_batch": pipe.max_batch, "messages": n_msgs,
           "batches": n_batches, "messages_per_s": n_msgs / took[0][1],
           "patches_beside": patches,
           "recorded_deliveries": got}
    log(f"serve_{sv['name']}_{mix}_pipeline: " + json.dumps(out))
    return out


def serve_fold_cost(sv: dict, batch: int, reps: int, card: str) -> dict:
    """The same ``publish_batch`` calls with kernel telemetry on (counters
    packed, the fold attached) and off (neither), in turns."""
    broker = sv["broker"]
    batches = [messages(sv, batch) for _ in range(4)]
    ts = {True: [], False: []}
    for i in range(2 * reps):
        on = i % 2 == 0
        set_telemetry(sv, on)
        t = time.perf_counter()
        broker.publish_batch(batches[(i // 2) % len(batches)])
        ts[on].append((time.perf_counter() - t) * 1e3)
        sv["batches"] += 1
        sv["untapped"] += not on
    set_telemetry(sv, True)
    out = {"card": card, "trie": sv["name"], "batch": batch, "calls": reps,
           "telemetry_on": pct(ts[True]), "telemetry_off": pct(ts[False])}
    log(f"serve_{sv['name']}_fold_cost_{batch}: " + json.dumps(out))
    return out


def serve_checks(sv: dict) -> dict:
    """No device failover, no host batch, one step per device batch, and
    the fold's batches and counter totals those the model handed it."""
    from emqx_tpu_torch.observe.device_metrics import (
        KERNEL_COUNTER_FIELDS, _PEAK_FIELDS)
    model, fold, tap = sv["model"], sv["fold"], sv["tap"]
    failovers = sv["metrics"].val("messages.device_failover")
    check(failovers == 0, f"{failovers} device failovers")
    check(sv["ledger"].totals().get("device_failover", 0) == 0,
          "the ledger holds a device failover")
    check(sv["pipe"].host_batches == 0 and model._host_matcher is None
          and model.host_match_count == 0, "a batch was served on the host")
    launches = model.launch_count - sv["launch0"]
    check(launches == sv["batches"],
          f"{launches} steps for {sv['batches']} device batches")
    check(fold.batches == len(tap.blocks) == launches - sv["untapped"],
          f"the fold saw {fold.batches} batches, the model ran "
          f"{launches} ({sv['untapped']} untapped)")
    blocks = np.stack([b.reshape(-1, len(KERNEL_COUNTER_FIELDS))
                       for b in tap.blocks])
    want = {n: int(blocks[:, :, i].max() if n in _PEAK_FIELDS
                   else blocks[:, :, i].sum())
            for i, n in enumerate(KERNEL_COUNTER_FIELDS)}
    check(fold.totals == want,
          f"fold totals {fold.totals} != the blocks' {want}")
    out = {"trie": sv["name"], "device_batches": sv["batches"],
           "launches": launches, "fold_batches": fold.batches,
           "fold_totals": fold.totals,
           "kernel_overflow_rows": sv["ledger"].totals().get(
               "kernel_overflow", 0),
           "device_failover": failovers}
    log(f"serve_{sv['name']}_checks: " + json.dumps(out))
    return out


def host_dispatch_leg(device, seed: int, card: str) -> dict:
    """RouterModels on ``device`` built under ``EMQX_TPU_CPU_KERNEL=host``
    (the host matcher on its ``native`` backend, the C++ ``NativeSubTable``,
    no step) and with the variable unset (auto: the step, on the card),
    flat and S=4, on 5000 of the bench-shape filters,
    16 broadcast filters on 70 slots each and aux filters: the host ones
    answer as the step does outside its fallback rows, and as the oracle
    trie on those; ``host_match_count`` is the number of batches and no
    step runs.  The variable is restored afterwards."""
    import os

    import torch

    from emqx_tpu_torch import RouterModel, ShardedTrieIndex, TrieIndex
    from emqx_tpu_torch.router.trie import Trie
    rng = np.random.default_rng(seed)
    live = build_filters(5000, rng)
    bcast = [f"fleet/+/vehicle/+/part/+/m{m}" for m in range(16)]
    aux = ["fleet/+/vehicle/#", "$SYS/#", "+/f1/#"]
    oracle = Trie()
    for f in live + bcast + aux:
        oracle.insert(f)
    batches = [make_topics(live, rng, 64, 2500) for _ in range(3)]
    batches[0][-4:] = ["$SYS/a/b", "$SYS", "fleet/f1", "a/" * 9 + "b"]
    kernel_mode = "auto" if torch.device(device).type == "cuda" else "xla"
    saved = os.environ.get("EMQX_TPU_CPU_KERNEL")
    out = {}
    try:
        for shards in (None, 4):
            res = {}
            for mode in ("host", kernel_mode):
                if mode == "auto":
                    os.environ.pop("EMQX_TPU_CPU_KERNEL", None)
                else:
                    os.environ["EMQX_TPU_CPU_KERNEL"] = mode
                model = RouterModel(
                    ShardedTrieIndex(shards, max_levels=8) if shards
                    else TrieIndex(max_levels=8), n_sub_slots=8192,
                    kernel_telemetry=True, device=device)
                check((model._host_matcher is not None) == (mode == "host"),
                      f"EMQX_TPU_CPU_KERNEL={mode}: host matcher "
                      f"{model._host_matcher}")
                if mode == "host":
                    # the reference's choice: the C++ table where the
                    # native library builds, as it must here
                    backend = model._host_matcher.backend
                    check(backend == "native", f"the host matcher's "
                          f"backend is {backend!r}, not the native table")
                for i, f in enumerate(live):
                    model.subscribe(f, i % 8192)
                for f in bcast:
                    for s in range(70):
                        model.subscribe(f, s)
                for f in aux:
                    model.aux_register(f)
                res[mode] = [model.publish_batch(t) for t in batches]
                want_launches = 0 if mode == "host" else len(batches)
                check(model.launch_count == want_launches
                      and model.host_match_count == len(batches)
                      - want_launches,
                      f"{mode}: {model.launch_count} steps, "
                      f"{model.host_match_count} host batches")
            n = 0
            for topics, h, k in zip(batches, res["host"], res[kernel_mode]):
                check(h[3] == [], "the host matcher has fallback rows")
                for b, t in enumerate(topics):
                    if b in k[3]:      # the step's fallback: the oracle's
                        ok = sorted(set(h[0][b] + h[1][b])) == sorted(
                            oracle.match(t))
                    else:
                        ok = (sorted(h[0][b]) == sorted(k[0][b])
                              and sorted(h[1][b]) == sorted(k[1][b])
                              and h[2][b] == k[2][b])
                    check(ok, f"host matcher, topic {t!r}: {h[0][b]} "
                          f"{h[1][b]} {h[2][b]} != the step's {k[0][b]} "
                          f"{k[1][b]} {k[2][b]}")
                    n += 1
            out[f"s{shards}" if shards else "flat"] = n
    finally:
        if saved is None:
            os.environ.pop("EMQX_TPU_CPU_KERNEL", None)
        else:
            os.environ["EMQX_TPU_CPU_KERNEL"] = saved
    res = {"card": card, "topics_checked": out,
           "kernel_mode": kernel_mode, "backend": backend}
    log("serve host dispatch: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# the network phase: MQTT clients over sockets into the port's servers
# ---------------------------------------------------------------------------


def ws_client(base):
    """``base``, an ``MqttClient``, speaking MQTT over RFC 6455 through
    the port's WS codec: the upgrade handshake with the ``mqtt``
    subprotocol, masked binary frames out, frames decoded in."""
    import base64
    import os

    from emqx_tpu_torch.broker import ws
    from emqx_tpu_torch.mqtt import packet as P
    from emqx_tpu_torch.mqtt.frame import serialize

    class WsClient(base):
        async def connect(self, timeout: float = 30.0):
            self._reader, self._writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port), timeout)
            key = base64.b64encode(os.urandom(16)).decode()
            self._writer.write((
                "GET /mqtt HTTP/1.1\r\nHost: localhost\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n"
                "Sec-WebSocket-Protocol: mqtt\r\n\r\n").encode())
            resp = await asyncio.wait_for(
                self._reader.readuntil(b"\r\n\r\n"), timeout)
            if (b" 101 " not in resp.split(b"\r\n")[0]
                    or ws.accept_key(key).encode() not in resp):
                raise ConnectionError(f"WS upgrade refused: {resp[:80]!r}")
            self._ws = ws.FrameDecoder(require_mask=False)
            self._recv_task = asyncio.create_task(self._recv_loop())
            await self._send(P.Connect(
                proto_ver=self.proto_ver, clean_start=self.clean_start,
                keepalive=self.keepalive, clientid=self.clientid,
                username=self.username, password=self.password))
            self.connack = await self._expect(P.CONNACK, timeout)
            if self.connack.reason_code != P.RC_SUCCESS:
                raise ConnectionRefusedError(hex(self.connack.reason_code))
            return self.connack

        async def _send(self, pkt) -> None:
            self._writer.write(ws.encode_frame(
                ws.OP_BINARY, serialize(pkt, self.proto_ver), mask=True))
            await self._writer.drain()

        async def _recv_loop(self) -> None:
            try:
                while True:
                    data = await self._reader.read(65536)
                    if not data:
                        break
                    for op, payload in self._ws.feed(data):
                        if op == ws.OP_CLOSE:
                            return
                        if op == ws.OP_BINARY:
                            for pkt in self._parser.feed(payload):
                                await self._route_in(pkt)
            except (ConnectionError, asyncio.CancelledError):
                pass

    return WsClient


def network_clients() -> int:
    """The network phase's clients, in a process of their own (``python3
    chip_smoke.py --network-clients``, started by the phase): one JSON line
    in with the deployment, then one command a line; one JSON line out for
    each."""
    asyncio.run(_network_clients())
    return 0


async def _network_clients() -> None:
    from emqx_tpu_torch.mqtt import packet as P
    from emqx_tpu_torch.mqtt.client import MqttClient

    async def read():
        line = await asyncio.to_thread(sys.stdin.readline)
        return json.loads(line) if line else None

    def write(obj) -> None:
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()

    class Sub(MqttClient):
        """Keeps (arrival ns, topic, payload, qos, packet id) of each
        PUBLISH it is sent, and acks QoS 1 and 2 as the base client
        does."""

        async def _route_in(self, pkt) -> None:
            if pkt.type != P.PUBLISH:
                return await super()._route_in(pkt)
            self.got.append((time.monotonic_ns(), pkt.topic,
                             pkt.payload.decode(), pkt.qos, pkt.packet_id))
            if pkt.qos == 1:
                await self._send(P.PubAck(packet_id=pkt.packet_id))
            elif pkt.qos == 2:
                await self._send(P.PubRec(packet_id=pkt.packet_id))

    async def in_chunks(coros, n: int = 128) -> None:
        for i in range(0, len(coros), n):
            await asyncio.gather(*coros[i:i + n])

    spec = await read()
    if spec.get("pool"):
        return await _client_pool(read, write)
    kinds = {(False, True): Sub, (True, True): ws_client(Sub),
             (False, False): MqttClient, (True, False): ws_client(MqttClient)}
    ports = {False: spec["tcp_port"], True: spec["ws_port"]}
    subs = [kinds[(s["ws"], True)](
        port=ports[s["ws"]], clientid=s["cid"], proto_ver=5, keepalive=600,
        username=s["cid"], password=s["password"].encode())
        for s in spec["subs"]]
    pubs = [kinds[(p["ws"], False)](
        port=ports[p["ws"]], clientid=p["cid"], proto_ver=4, keepalive=600,
        username=p["cid"], password=p["password"].encode())
        for p in spec["pubs"]]
    for c in subs:
        c.got = []
    t0 = time.perf_counter()
    await in_chunks([c.connect(timeout=60.0) for c in subs + pubs])
    t1 = time.perf_counter()

    async def subscribe(c, filters):
        for f, qos in filters:
            ack = await c.subscribe(f, qos=qos)
            if ack.reason_codes != [qos]:
                raise RuntimeError(f"{c.clientid} {f}: {ack.reason_codes}")

    await in_chunks([subscribe(c, s["filters"])
                     for c, s in zip(subs, spec["subs"])])
    write({"ready": True, "connect_s": t1 - t0,
           "subscribe_s": time.perf_counter() - t1})
    while True:
        cmd = await read()
        if cmd is None or cmd.get("cmd") == "close":
            break
        for c in subs:
            c.got = []
        errors, pubacks = [], []

        async def publish(j, c, plan):
            for k, (topic, qos) in enumerate(plan):
                t = time.monotonic_ns()
                try:
                    await c.publish(topic, b"%d:%d:%d" % (j, k, t), qos=qos)
                except Exception as e:         # noqa: BLE001 — reported
                    errors.append(f"{c.clientid} #{k}: {e!r}")
                    return
                if qos:
                    pubacks.append(time.monotonic_ns() - t)

        t_first = time.monotonic_ns()
        await asyncio.gather(*(publish(j, c, plan) for j, (c, plan)
                               in enumerate(zip(pubs, cmd["plans"]))))
        t_sent = time.monotonic_ns()
        deadline = time.monotonic() + cmd["timeout_s"]
        while (any(len(c.got) < n for c, n in zip(subs, cmd["expect"]))
               and time.monotonic() < deadline):
            await asyncio.sleep(0.005)
        short = [c.clientid for c, n in zip(subs, cmd["expect"])
                 if len(c.got) < n]
        t_last = max([c.got[-1][0] for c in subs if c.got] + [t_sent])
        await asyncio.sleep(0.25)              # late or duplicate deliveries
        write({"leg": cmd["leg"], "t_first_ns": t_first, "t_sent_ns": t_sent,
               "t_last_ns": t_last, "puback_ns": pubacks, "errors": errors,
               "short": short, "received": [c.got for c in subs]})
    await in_chunks([c.disconnect() for c in subs + pubs])
    write({"closed": True})


async def _client_pool(read, write) -> None:
    """The durable path's clients: a pool of v5 TCP clients the parent
    drives one command a line, one JSON line out for each.

    - ``connect``: ``clients`` (``cid``, ``port``, ``clean``, ``expiry``,
      ``password``, ``filters`` to subscribe), ``chunk`` of them at once;
      out, per client id: the CONNACK code, ``session_present``, the
      CONNECT's start (``t0_ns``) and milliseconds, the SUBACK codes;
    - ``publish``: ``plans``, per client id ``[topic, qos, payload]`` in
      order, one in flight (``{t}`` in a payload: the send's
      ``monotonic_ns``); out: per client id its PUBACK codes, and the
      PUBACK latencies;
    - ``wait``: until each client id of ``expect`` holds that many
      deliveries (or ``timeout_s``), then 0.25 s more for late or
      duplicate ones; out: each one's deliveries ``(arrival ns, topic,
      payload, qos)``, which it then forgets, and those still short;
    - ``disconnect``: ``cids`` send DISCONNECT and close;
    - ``close``: every client disconnects, and the process ends."""
    from emqx_tpu_torch.mqtt import packet as P
    from emqx_tpu_torch.mqtt.client import MqttClient

    class Pooled(MqttClient):
        """Keeps each PUBLISH it is sent and acks QoS 1."""

        async def _route_in(self, pkt) -> None:
            if pkt.type != P.PUBLISH:
                return await super()._route_in(pkt)
            self.got.append((time.monotonic_ns(), pkt.topic,
                             pkt.payload.decode(), pkt.qos))
            if pkt.qos == 1:
                await self._send(P.PubAck(packet_id=pkt.packet_id))

    clients: dict = {}
    write({"ready": True})
    while True:
        cmd = await read()
        if cmd is None or cmd["cmd"] == "close":
            break
        if cmd["cmd"] == "connect":
            res = {}

            async def one(c) -> None:
                cl = Pooled(
                    port=c["port"], clientid=c["cid"], proto_ver=5,
                    clean_start=c.get("clean", True), keepalive=600,
                    username=c["cid"], password=c["password"].encode(),
                    properties={"Session-Expiry-Interval": c["expiry"]}
                    if c.get("expiry") else {})
                cl.got = []
                t0 = time.monotonic_ns()
                try:
                    ack = await cl.connect(timeout=120.0)
                except ConnectionRefusedError:
                    res[c["cid"]] = {"rc": cl.connack.reason_code,
                                     "t0_ns": t0}
                    return
                r = res[c["cid"]] = {
                    "rc": ack.reason_code, "present": ack.session_present,
                    "t0_ns": t0, "ms": (time.monotonic_ns() - t0) / 1e6,
                    "suback": []}
                for f, qos in c.get("filters", []):
                    r["suback"] += (await cl.subscribe(f, qos=qos)
                                    ).reason_codes
                clients[c["cid"]] = cl

            todo, n = cmd["clients"], cmd.get("chunk", 128)
            for i in range(0, len(todo), n):
                await asyncio.gather(*(one(c) for c in todo[i:i + n]))
            write({"connected": res})
        elif cmd["cmd"] == "publish":
            rcs, lat = {}, []

            async def pub(cid, plan) -> None:
                cl, rcs[cid] = clients[cid], []
                for topic, qos, payload in plan:
                    t = time.monotonic_ns()
                    body = payload.replace("{t}", str(t)).encode()
                    pid = cl._pid() if qos else None
                    await cl._send(P.Publish(topic=topic, payload=body,
                                             qos=qos, packet_id=pid))
                    if qos:
                        ack = await cl._expect(P.PUBACK, 120.0)
                        rcs[cid].append(ack.reason_code)
                        lat.append(time.monotonic_ns() - t)

            t_first = time.monotonic_ns()
            await asyncio.gather(*(pub(c, p) for c, p in
                                   cmd["plans"].items()))
            write({"pubacks": rcs, "puback_ns": lat, "t_first_ns": t_first,
                   "t_sent_ns": time.monotonic_ns()})
        elif cmd["cmd"] == "wait":
            want = cmd["expect"]
            end = time.monotonic() + cmd["timeout_s"]
            while (any(len(clients[c].got) < n for c, n in want.items())
                   and time.monotonic() < end):
                await asyncio.sleep(0.005)
            await asyncio.sleep(0.25)
            got = {c: clients[c].got for c in want}
            for c in want:
                clients[c].got = []
            write({"received": got, "short": [
                c for c, n in want.items() if len(got[c]) < n]})
        elif cmd["cmd"] == "disconnect":
            await asyncio.gather(*(clients.pop(c).disconnect()
                                   for c in cmd["cids"]))
            write({"disconnected": len(cmd["cids"])})
    await asyncio.gather(*(c.disconnect() for c in clients.values()))
    write({"closed": True})


class ErrorRecords(logging.Handler):
    """Keeps every record at ERROR or above on the logger it is added to."""

    def __init__(self) -> None:
        super().__init__(logging.ERROR)
        self.records: list = []

    def emit(self, record) -> None:
        self.records.append(self.format(record))


def wire_listeners(conf) -> dict:
    """The config's asyncio listeners (tcp, ws): the ``native`` one runs
    in its own path (:func:`native_phase`)."""
    return {k: v for k, v in conf.get("listeners").items()
            if v.get("type") != "native"}


def fd_limit(need: int) -> tuple[int, dict]:
    """Raise the soft limit on open files to the hard one; the number of
    files the phase may open, and both limits."""
    import resource
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = need if hard == resource.RLIM_INFINITY else hard
    if soft != resource.RLIM_INFINITY and soft < want:
        resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))
    now = resource.getrlimit(resource.RLIMIT_NOFILE)
    info = {"soft_before": soft, "hard": hard, "soft": now[0]}
    log("network open-file limits: " + json.dumps(info))
    return now[0], info


def net_topics(sv: dict, wire: list, rng, count: int,
               dense_every: int = 0) -> list[str]:
    """``count`` topics: half instantiated from the wire-subscribed
    filters, half from the smoke's plain mix, shuffled; with
    ``dense_every``, every such topic under ``fleet/`` moved to the
    subtree of NET_DENSE_FILTER."""
    half = count // 2
    topics = (make_topics(wire, rng, half, sv["n_vehicles"])
              + make_topics(sv["live"], rng, count - half, sv["n_vehicles"]))
    topics = [topics[i] for i in rng.permutation(count).tolist()]
    if dense_every:
        root = NET_DENSE_FILTER.split("/")[1]
        for i in range(0, count, dense_every):
            ws = topics[i].split("/")
            if ws[0] == "fleet" and len(ws) > 1:
                ws[1] = root
                topics[i] = "/".join(ws)
    return topics


def net_expect(sv: dict, pubs: list, plans: list, sub_ids: dict) -> tuple:
    """What the host path routes (``Broker.publish`` on the same broker)
    to each network subscriber for ``plans``: per subscriber, a Counter of
    (topic, publisher, sequence, delivered qos)."""
    from collections import Counter

    from emqx_tpu_torch.core.message import Message
    broker = sv["broker"]
    want = [Counter() for _ in sub_ids]
    for j, (pub, plan) in enumerate(zip(pubs, plans)):
        for k, (topic, qos) in enumerate(plan):
            for sid, items in broker.publish(Message(
                    topic=topic, payload=b"", qos=qos,
                    from_=pub["cid"])).items():
                i = sub_ids.get(sid)
                if i is None:
                    continue
                for sub_topic, _ in items:
                    q = min(qos, broker.suboption[(sid, sub_topic)].qos)
                    want[i][(topic, j, k, q)] += 1
    return want


def net_leg_checks(name: str, res: dict, want: list, subs: list,
                   plans: list, by_topic: bool = False) -> dict:
    """The client side of one leg: no publish error, every expected
    delivery and no other, each publisher's order kept at each subscriber
    (per delivered QoS, and per topic with ``by_topic``: the native
    host's lane and its punts to the pipeline keep a topic's order, not a
    publisher's across topics), every QoS 1 publish acked; the
    latencies."""
    from collections import Counter
    check(not res["errors"], f"network {name}: publish errors "
          f"{res['errors'][:5]}")
    check(not res["short"], f"network {name}: {len(res['short'])} "
          f"subscribers short of their deliveries, e.g. {res['short'][:5]}")
    lat, n = [], 0
    for s, got, w in zip(subs, res["received"], want):
        seen, last = Counter(), {}
        for t_ns, topic, payload, qos, _pid in got:
            j, k, stamp = map(int, payload.split(":"))
            seen[(topic, j, k, qos)] += 1
            key = (j, qos, topic) if by_topic else (j, qos)
            check(last.get(key, -1) <= k,
                  f"network {name}: {s['cid']} got publisher {j}'s message "
                  f"{k} after {last.get(key)} at QoS {qos}")
            last[key] = k
            lat.append((t_ns - stamp) / 1e6)
        check(seen == w, f"network {name}: {s['cid']} got {len(got)} "
              f"messages, the host path routes {sum(w.values())}: missing "
              f"{list((w - seen).items())[:3]}, extra "
              f"{list((seen - w).items())[:3]}")
        n += len(got)
    acks = [t / 1e6 for t in res["puback_ns"]]
    qos1 = sum(q == 1 for plan in plans for _, q in plan)
    check(len(acks) == qos1, f"network {name}: {len(acks)} PUBACKs for "
          f"{qos1} QoS 1 publishes")
    msgs = sum(map(len, plans))
    out = {"messages": msgs, "deliveries": n,
           "messages_per_s": msgs / ((res["t_last_ns"] - res["t_first_ns"])
                                     / 1e9),
           "send_s": (res["t_sent_ns"] - res["t_first_ns"]) / 1e9,
           "delivery_ms": pct(lat) if lat else None}
    if acks:
        out["puback_ms"] = pct(acks)
    return out


async def _network_run(sv: dict, card: str, spec: dict, legs: list,
                       overlay: list) -> dict:
    """Serve the legs: the TCP and WS servers over the serving leg's broker
    and pipeline, the clients' process, then per leg the host path's
    expectation, the clients' run and both sides' checks."""
    import os
    model, pipe, tap, broker = sv["model"], sv["pipe"], sv["tap"], sv["broker"]
    app = sv["app"]
    errors = ErrorRecords()
    logging.getLogger("emqx_tpu_torch.pipeline").addHandler(errors)
    started = await app.listeners.start_all(wire_listeners(sv["conf"]))
    check(sorted(started) == ["tcp:default", "ws:ws"],
          f"the app's listeners: {started}")
    tcp, wss = app.listeners.find("tcp:default"), app.listeners.find("ws:ws")
    spec.update(tcp_port=tcp.port, ws_port=wss.port)
    proc = await asyncio.create_subprocess_exec(
        sys.executable, os.path.abspath(__file__), "--network-clients",
        stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE,
        limit=1 << 30)

    async def ask(obj, timeout: float):
        proc.stdin.write((json.dumps(obj) + "\n").encode())
        await proc.stdin.drain()
        line = await asyncio.wait_for(proc.stdout.readline(), timeout)
        check(bool(line), "the network clients' process ended early")
        return json.loads(line)

    out = {"legs": []}
    try:
        p0 = model.patch_count
        ready = await ask(spec, 600)
        out.update(connect_s=ready["connect_s"],
                   subscribe_s=ready["subscribe_s"])
        sub_ids = {s["cid"]: i for i, s in enumerate(spec["subs"])}
        n_wire = sum(len(s["filters"]) for s in spec["subs"])
        auto = {c: APP_AUTO.replace("%c", c) for c in sub_ids}
        check(sum(len(set(broker.subscription.get(c, ())) - {auto[c]})
                  for c in sub_ids) == n_wire,
              "the wire subscriptions are not in the broker")
        check(all(auto[c] in broker.subscription.get(c, ())
                  for c in sub_ids), "a client lacks its auto-subscription")
        for name, plans, dense in legs:
            if dense:                     # the overlay back, for this leg
                for sid, f in overlay:
                    broker.subscribe(sid, f)
                model.refresh()
            t0 = time.time()
            want = net_expect(sv, spec["pubs"], plans, sub_ids)
            expect_s = time.time() - t0
            b0, l0, h0 = pipe.batches, model.launch_count, pipe.host_batches
            m0, s0 = pipe.published, len(tap.sizes)
            res = await ask({"leg": name, "plans": plans,
                             "expect": [sum(w.values()) for w in want],
                             "timeout_s": 300}, 900)
            msgs = sum(map(len, plans))
            for _ in range(6000):         # the tail routed to no client
                if pipe.published - m0 >= msgs:
                    break
                await asyncio.sleep(0.01)
            line = {"card": card, "leg": name, **net_leg_checks(
                name, res, want, spec["subs"], plans)}
            batches = pipe.batches - b0
            steps = model.launch_count - l0
            sizes = tap.sizes[s0:]
            check(pipe.published - m0 == msgs,
                  f"network {name}: the pipeline routed "
                  f"{pipe.published - m0} of {msgs} messages")
            check(pipe.host_batches == h0 and model.host_match_count == 0,
                  f"network {name}: a batch was served on the host")
            check(steps == batches == len(sizes) and sum(sizes) == msgs,
                  f"network {name}: {steps} steps, {batches} device "
                  f"batches, {len(sizes)} batches seen by the model")
            check(sv["metrics"].val("messages.device_failover") == 0,
                  f"network {name}: a device failover")
            check(not errors.records, f"network {name}: the pipeline "
                  f"logged {errors.records[:3]}")
            line.update(device_batches=batches,
                        batch_mean=float(np.mean(sizes)),
                        batch_max=int(max(sizes)),
                        steps_per_batch=steps / batches,
                        host_expect_s=expect_s)
            log("network: " + json.dumps(line))
            out["legs"].append(line)
        out["patches"] = model.patch_count - p0
        check(out["patches"] > 0, "no wire subscription reached the card "
              "through a patch")
        closed = await ask({"cmd": "close"}, 300)
        check(closed.get("closed") is True, f"the clients answered {closed}")
        await asyncio.wait_for(proc.wait(), 60)
        check(proc.returncode == 0,
              f"the clients' process exited {proc.returncode}")
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
        await app.listeners.stop_all()
        logging.getLogger("emqx_tpu_torch.pipeline").removeHandler(errors)
    return out


def network_phase(sv: dict, seed: int, card: str, subs: int = NET_SUBS,
                  ws_subs: int = NET_WS_SUBS,
                  dense_subs: int = NET_DENSE_SUBS, pubs: int = NET_PUBS,
                  ws_pubs: int = NET_WS_PUBS, burst: int = NET_BURST,
                  commands: int = NET_COMMANDS,
                  dense: int = NET_DENSE) -> dict:
    """The network entry over the serving leg's state (its 1M
    subscriptions, broker, CM, pipeline and fold): the port's
    ``BrokerServer`` and ``WsBrokerServer`` on 127.0.0.1, MQTT clients in a
    process of their own.  ``subs`` TCP and ``ws_subs`` WS subscribers
    SUBSCRIBE over the wire to 4 filters of the subscribed tree each (2 at
    QoS 0, 2 at QoS 1), ``dense_subs`` of them also to NET_DENSE_FILTER;
    ``pubs`` TCP and ``ws_pubs`` WS publishers run three legs: a QoS 0
    burst of ``burst`` messages each, QoS 1 commands (``commands`` each,
    one in flight), both with the dense overlay's broadcast subscriptions
    lifted, then ``dense`` QoS 0 messages with them back.  Every
    subscriber's deliveries are held to the host path's."""
    t_start = time.time()
    n_clients = subs + ws_subs + pubs + ws_pubs
    limit, limits = fd_limit(2 * n_clients + 512)
    if 2 * n_clients + 512 > limit:
        scale = (limit - 512) / (2 * n_clients)
        subs, ws_subs, pubs, ws_pubs = (max(1, int(x * scale)) for x in (
            subs, ws_subs, pubs, ws_pubs))
        dense_subs = min(dense_subs, subs)
        log(f"network: CUT to {subs} + {ws_subs} subscribers and {pubs} + "
            f"{ws_pubs} publishers by an open-file limit of {limit}")
    rng = np.random.default_rng(seed + 9)
    live = sv["live"]
    spec_subs = []
    for i in range(subs + ws_subs):
        fs = [live[k] for k in rng.choice(len(live), 4, replace=False)]
        filters = [[fs[0], 0], [fs[1], 0], [fs[2], 1], [fs[3], 1]]
        if i < dense_subs:
            filters.append([NET_DENSE_FILTER, 0])
        spec_subs.append({"cid": f"n{i}", "ws": i >= subs,
                          "password": password(f"n{i}"),
                          "filters": filters})
    spec_pubs = [{"cid": f"np{j}", "ws": j >= pubs,
                  "password": password(f"np{j}")}
                 for j in range(pubs + ws_pubs)]
    wire = [f for s in spec_subs for f, _ in s["filters"]
            if f != NET_DENSE_FILTER]
    n_pubs = len(spec_pubs)

    def plans(count: int, qos: int, dense_every: int = 0):
        """``count`` messages at ``qos``, dealt to the publishers in turn."""
        topics = net_topics(sv, wire, rng, count, dense_every)
        return [[[t, qos] for t in topics[j::n_pubs]]
                for j in range(n_pubs)]

    legs = [("qos0_burst", plans(burst * n_pubs, 0), False),
            ("qos1_commands", plans(commands * n_pubs, 1), False),
            ("dense_qos0", plans(dense, 0, dense_every=8), True)]
    broker = sv["broker"]
    overlay = [(sid, f) for f in sorted(sv["bcast"])
               for sid in sorted(broker.subscriber.get(f, ()))]
    for sid, f in overlay:
        broker.unsubscribe(sid, f)
    sv["model"].refresh()
    spec = {"subs": spec_subs, "pubs": spec_pubs}
    out = asyncio.run(_network_run(sv, card, spec, legs, overlay))
    sv["listeners_down_at"] = time.monotonic()
    olp = sv["app"].olp
    out.update(olp={"lag_ms": olp.lag_ms,
                    "overloaded": olp.is_overloaded()},
               card=card, limits=limits, subscribers={"tcp": subs,
               "ws": ws_subs, "dense": dense_subs},
               publishers={"tcp": pubs, "ws": ws_pubs},
               wire_subscriptions=len(wire) + dense_subs,
               seconds=time.time() - t_start)
    log("network phase: " + json.dumps({k: v for k, v in out.items()
                                         if k != "legs"}))
    return out


# ---------------------------------------------------------------------------
# the native path: the C++ epoll host (a ``native`` listener of the app)
# whose device lane feeds the routing step on the card
# ---------------------------------------------------------------------------


class LaneBatches:
    """Wraps the model's ``publish_batch_submit`` on its instance and
    keeps the size of each batch the native server's lane pump submits
    (calls from other threads, the pipeline's, pass through unrecorded)."""

    PUMP = "emqx-lane-pump"

    def __init__(self, model) -> None:
        import threading
        self.model, self.sizes = model, []
        inner = model.publish_batch_submit

        def submit(topics, *a, **kw):
            if threading.current_thread().name == self.PUMP:
                self.sizes.append(len(topics))
            return inner(topics, *a, **kw)
        model.publish_batch_submit = submit

    def close(self) -> None:
        del self.model.publish_batch_submit


def lane_filters(rng, n: int) -> list:
    """``n`` filter lists of the native leg: the vehicle-fleet tree's shape
    under a root of its own (``lane/``), 2 exact filters and 2 wildcards
    (a ``+`` vehicle, a ``#`` under a vehicle) each, over 16 fleets and 64
    vehicles so that subscribers share topics.  No session of the 1M holds
    a filter there: a topic under ``lane/`` has only native audiences, and
    rides the device lane (a topic with a Python session's audience punts
    to the pipeline before it parks, as the reference's host does)."""
    out = []
    for _ in range(n):
        fl, v, p, m = (int(rng.integers(0, k)) for k in (16, 64, 8, 16))
        v2, m2 = int(rng.integers(0, 64)), int(rng.integers(0, 16))
        out.append([f"lane/f{fl}/vehicle/v{v}/part/p{p}/m{m}",
                    f"lane/f{fl}/vehicle/v{v2}/part/p{p}/m{m2}",
                    f"lane/f{fl}/vehicle/+/part/p{p}/m{m}",
                    f"lane/f{fl}/vehicle/v{v2}/#"])
    return out


def native_stats(server) -> dict:
    st = server.fast_stats()
    return {k: st[k] for k in ("lane_in", "lane_out", "lane_punts",
                               "lane_stale", "lane_fallback", "punts",
                               "fast_in", "native_acks")}


def stat_delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


async def _native_run(sv: dict, card: str, spec: dict, legs: list,
                      loadgen: int) -> dict:
    """Serve the native legs: the app's ``native`` listener (device lane
    on), the wire clients in the network phase's child process, then per
    leg the host path's expectation, the clients' run and the checks;
    then the load generator against the same listener."""
    from emqx_tpu_torch import native
    from emqx_tpu_torch.broker.native_server import PERMIT_TTL_S
    model, pipe, app = sv["model"], sv["pipe"], sv["app"]
    errors = ErrorRecords()
    for name in ("emqx_tpu_torch.pipeline", "emqx_tpu_torch.native_server"):
        logging.getLogger(name).addHandler(errors)
    conf = {k: v for k, v in sv["conf"].get("listeners").items()
            if v.get("type") == "native"}
    t = time.perf_counter()
    started = await app.listeners.start_all(conf)
    start_s = time.perf_counter() - t
    check(started == ["native:native"], f"the app's native listener: "
          f"{started}")
    lst = app.listeners.find("native:native")
    server = lst._srv
    check(server.device_lane == "on" and server._lane_on
          and server._lane_model() is model,
          "the native listener's device lane is off or not on the model")
    spec.update(tcp_port=lst.port, ws_port=lst.port)
    lanes = LaneBatches(model)
    clients = ClientPool("native")
    out = {"legs": [], "listener_start_s": start_s}
    try:
        p0 = model.patch_count
        ready = await clients.start(spec)
        out.update(connect_s=ready["connect_s"],
                   subscribe_s=ready["subscribe_s"])
        # the host path's deliveries, once the wire subscriptions are in
        # and before the legs: the legs run inside one permit period of
        # the server (PERMIT_TTL_S from its start), after which every
        # publisher re-earns its permits through the Python path
        sub_ids = {s["cid"]: i for i, s in enumerate(spec["subs"])}
        t = time.perf_counter()
        legs = [(name, plans, net_expect(sv, spec["pubs"], plans, sub_ids))
                for name, plans in legs]
        out["host_expect_s"] = time.perf_counter() - t
        n_pairs = sum(len({t for t, _ in plan}) for plan in legs[0][1])
        for name, plans, want in legs:
            flushed = server._last_permit_flush
            lane_topics = sum(t.startswith("lane/") for plan in plans
                              for t, _ in plan)
            msgs = sum(map(len, plans))
            s0, n0 = native_stats(server), len(lanes.sizes)
            b0, l0, m0 = pipe.batches, model.launch_count, pipe.published
            h0 = pipe.host_batches
            res = await clients.ask({"leg": name, "plans": plans,
                                     "expect": [sum(w.values()) for w in want],
                                     "timeout_s": 300}, 900)
            punted = msgs - (lane_topics if name != "warm" else 0)
            for _ in range(6000):         # the punted tail, to no client
                if pipe.published - m0 >= punted:
                    break
                await asyncio.sleep(0.01)
            if name == "warm":            # every (publisher, topic) earns
                await _until(lambda: sum(map(len, server._granted.values()))
                             >= n_pairs, "native: the warm publishes' "
                             "permits", 60.0)
            await asyncio.sleep(0.2)
            check(server._last_permit_flush == flushed, f"native {name}: "
                  f"the permits' {PERMIT_TTL_S:.0f} s flush fell in the leg")
            d = stat_delta(s0, native_stats(server))
            line = {"card": card, "leg": name, **net_leg_checks(
                f"native {name}", res, want, spec["subs"], plans,
                by_topic=True)}
            sizes = lanes.sizes[n0:]
            steps = model.launch_count - l0
            batches = pipe.batches - b0
            check(pipe.host_batches == h0 and model.host_match_count == 0,
                  f"native {name}: a batch was served on the host")
            check(server.lane_error is None,
                  f"native {name}: the lane's step failed (D5): "
                  f"{server.lane_error!r}")
            check(d["lane_stale"] == 0 and d["lane_punts"] == 0,
                  f"native {name}: lane stats {d}")
            check(steps == batches + len(sizes),
                  f"native {name}: {steps} steps for {batches} pipeline "
                  f"and {len(sizes)} lane batches")
            check(pipe.published - m0 == punted,
                  f"native {name}: the pipeline routed "
                  f"{pipe.published - m0} of {punted} punted messages")
            check(sum(sizes) == d["lane_in"] == d["lane_out"],
                  f"native {name}: lane batches of {sum(sizes)} topics, "
                  f"lane stats {d}")
            if name != "warm":
                # every topic under lane/ has only native audiences: it
                # parks on the lane; a plain-mix topic punts at the host
                check(d["lane_in"] == lane_topics
                      and d["punts"] == msgs - lane_topics,
                      f"native {name}: {d['lane_in']} laned of "
                      f"{lane_topics} lane topics, {d['punts']} punts of "
                      f"{msgs - lane_topics} plain-mix messages: {d}")
                pids = [pid for got in res["received"]
                        for *_, qos, pid in got if qos == 1]
                check(all(p >= 32768 for p in pids),
                      f"native {name}: QoS 1 deliveries with packet ids "
                      f"below 32768: {sorted(pids)[:5]}")
                line["qos1_deliveries"] = len(pids)
            check(sv["metrics"].val("messages.device_failover") == 0,
                  f"native {name}: a device failover")
            check(not errors.records, f"native {name}: logged "
                  f"{errors.records[:3]}")
            line.update(lane=d, lane_batches=len(sizes),
                        lane_batch_mean=float(np.mean(sizes)) if sizes
                        else 0.0, lane_batch_max=max(sizes, default=0),
                        pipeline_batches=batches, steps=steps,
                        lane_share=d["lane_in"] / msgs)
            log("native: " + json.dumps(line))
            out["legs"].append(line)
        out["patches"] = model.patch_count - p0
        check(out["patches"] > 0, "no lane subscription reached the card "
              "through a patch")
        await clients.close()
        # the throughput leg: the C++ load generator (8 subscribers on
        # lg/<i>/+, 8 publishers, QoS 0, windowed), as bench.py's
        # bench_device_lane runs it
        s0, n0 = native_stats(server), len(lanes.sizes)
        l0, b0 = model.launch_count, pipe.batches
        hist0 = server.latency_summary().get("lane_dwell", {}).get(
            "count", 0)
        res = await asyncio.to_thread(
            native.loadgen_run, "127.0.0.1", lst.port, n_subs=8, n_pubs=8,
            msgs_per_pub=loadgen, qos=0, payload_len=16, window=8192)
        await asyncio.sleep(0.3)          # the telemetry's 100 ms cadence
        d = stat_delta(s0, native_stats(server))
        sizes = lanes.sizes[n0:]
        dwell = server.latency_summary().get("lane_dwell", {})
        check(res["errors"] == 0 and res["sent"] == 8 * loadgen
              and res["received"] == res["sent"],
              f"native loadgen: {res}, fan-out 1 expected")
        check(d["lane_stale"] == 0 and d["lane_punts"] == 0
              and server.lane_error is None,
              f"native loadgen: lane stats {d}, {server.lane_error!r}")
        check(d["lane_in"] >= res["sent"] * 0.9 and sizes,
              f"native loadgen: {d['lane_in']} of {res['sent']} laned")
        check(model.launch_count - l0 == pipe.batches - b0 + len(sizes),
              "native loadgen: not one step a batch")
        wall = res["wall_ns"] / 1e9
        line = {"card": card, "leg": "loadgen", "subscribers": 8,
                "publishers": 8, "qos": 0, "window": 8192,
                "sent": res["sent"], "received": res["received"],
                "messages_per_s": res["received"] / wall,
                "p50_ms": res["p50_ns"] / 1e6, "p99_ms": res["p99_ns"] / 1e6,
                "lane_dwell_us": {k: dwell.get(k) for k in (
                    "p50_us", "p99_us", "count")},
                "lane_dwell_new": dwell.get("count", 0) - hist0,
                "lane": d, "lane_batches": len(sizes),
                "lane_batch_mean": float(np.mean(sizes)),
                "lane_batch_max": max(sizes),
                "steps": model.launch_count - l0}
        log("native: " + json.dumps(line))
        out["loadgen"] = line
        check(not errors.records, f"native: logged {errors.records[:3]}")
    finally:
        lanes.close()
        await clients.kill()
        t = time.perf_counter()
        await app.listeners.stop_all()
        out["listener_stop_s"] = time.perf_counter() - t
        for name in ("emqx_tpu_torch.pipeline",
                     "emqx_tpu_torch.native_server"):
            logging.getLogger(name).removeHandler(errors)
    return out


def warm_lane(model, top: int = 16384) -> float:
    """Run the model's step once at every power-of-two batch size up to
    ``top`` (the lane pump's batches take any size up to LANE_MAX_BATCH):
    the first step of a new size pays the card's lazy set-up and a pinned
    host block, which the timed legs must not.  Returns the seconds."""
    t = time.perf_counter()
    b = 1
    while b <= top:
        model.publish_batch(["lane/warm"] * b)
        b *= 2
    return time.perf_counter() - t


def native_phase(sv: dict, seed: int, card: str, subs: int = NAT_SUBS,
                 pubs: int = NAT_PUBS, topics: int = NAT_TOPICS,
                 qos0: int = NAT_QOS0, qos1: int = NAT_QOS1,
                 loadgen: int = NAT_LOADGEN) -> dict:
    """The native entry over the serving leg's state (its 1M
    subscriptions, broker, CM, pipeline and fold), the dense overlay and
    no rule attached (a topic a rule matches earns no permit): the app's
    ``native`` listener (the port's ``NativeBrokerServer``, device lane
    on), MQTT clients in the network phase's child process.  ``subs`` v5
    subscribers SUBSCRIBE to 4 filters each (:func:`lane_filters`: 2 at
    QoS 0, 2 at QoS 1, new to the card); ``pubs`` v3.1.1 publishers each
    have ``topics`` topics, half under the subscribers' filters and half
    of the plain mix: a warm leg publishes each once (the Python path
    earns its permit), then ``qos0`` QoS 0 and ``qos1`` QoS 1 messages a
    publisher.  Every subscriber's deliveries equal, as a multiset, what
    the host path routes, in order per publisher and topic; the lane
    topics park on the lane (``lane_in``) and the plain-mix ones punt to
    the pipeline; no stale trip, no lane punt, no D5 error, one step per
    lane or pipeline batch; native QoS 1 deliveries carry packet ids of
    32768 and up.  Then the C++ load generator against the listener."""
    t_start = time.time()
    rng = np.random.default_rng(seed + 17)
    broker, model = sv["broker"], sv["model"]
    overlay = [(sid, f) for f in sorted(sv.get("bcast", ()))
               for sid in sorted(broker.subscriber.get(f, ()))]
    for sid, f in overlay:
        broker.unsubscribe(sid, f)
    model.refresh()
    warm_s = warm_lane(model)
    spec_subs = []
    lists = lane_filters(rng, subs)
    for i, fs in enumerate(lists):
        spec_subs.append({"cid": f"v{i}", "ws": False,
                          "password": password(f"v{i}"),
                          "filters": [[fs[0], 0], [fs[1], 1], [fs[2], 0],
                                      [fs[3], 1]]})
    spec_pubs = [{"cid": f"vp{j}", "ws": False,
                  "password": password(f"vp{j}")} for j in range(pubs)]
    wire = [f for fs in lists for f in fs]
    per_pub = []
    for _ in range(pubs):
        lane = make_topics(wire, rng, topics // 2, 64)
        plain = make_topics(sv["live"], rng, topics - topics // 2,
                            sv["n_vehicles"])
        per_pub.append(list(dict.fromkeys(lane + plain)))

    def plans(count: int, qos: int) -> list:
        return [[[ts[k], qos] for k in rng.integers(0, len(ts), count)]
                for ts in per_pub]

    legs = [("warm", [[[t, 0] for t in ts] for ts in per_pub]),
            ("qos0", plans(qos0, 0)), ("qos1", plans(qos1, 1))]
    spec = {"subs": spec_subs, "pubs": spec_pubs}
    try:
        out = asyncio.run(_native_run(sv, card, spec, legs, loadgen))
    finally:
        for sid, f in overlay:
            broker.subscribe(sid, f)
        model.refresh()
    out.update(card=card, warm_s=warm_s, subscribers=subs,
               publishers=pubs, topics_per_publisher=topics,
               overlay_lifted=len(overlay), seconds=time.time() - t_start)
    log("native phase: " + json.dumps({k: v for k, v in out.items()
                                        if k not in ("legs", "loadgen")}))
    return out


# ---------------------------------------------------------------------------
# the services phase: the app's services wired onto the serving leg's broker
# ---------------------------------------------------------------------------


class RuleTap:
    """The broker's ``rules_matched_fn`` in front of the engine's
    ``on_matched``: per call, the message, whether its rules came from the
    step's aux column (or from the engine's host trie: aux None) and the
    rules the recording action saw fire for it."""

    def __init__(self, app) -> None:
        self.inner = app.rules.on_matched
        self.fired: list[str] = []
        self.calls: list[tuple] = []

    def record(self, cols: dict, _args: dict) -> None:
        self.fired.append(cols["__rule_id"])

    def on_matched(self, msg, aux) -> None:
        n = len(self.fired)
        self.inner(msg, aux)
        self.calls.append((msg, aux is None, self.fired[n:]))


def rules_checks(app, tap: RuleTap, rp_channel, what: str,
                 overflow0: int, rp0: int) -> dict:
    """Every message's fired rules equal ``rules_for_topic`` on the
    engine's host trie, each rule at most once; every republish reached
    the recording channel; the host trie answered exactly the step's
    fallback rows (every other row fired from the aux column)."""
    host_rows = 0
    for msg, host, fired in tap.calls:
        want = sorted(r.id for r in app.rules.rules_for_topic(msg.topic))
        check(len(set(fired)) == len(fired),
              f"rules {what}: a rule fired twice on {msg.topic!r}: {fired}")
        check(sorted(fired) == want, f"rules {what}: {msg.topic!r} fired "
              f"{sorted(fired)}, the host trie matches {want}")
        host_rows += host
    overflow = app.ledger.totals().get("kernel_overflow", 0) - overflow0
    check(host_rows == overflow, f"rules {what}: {host_rows} rows matched "
          f"on the host trie, {overflow} fallback rows")
    republished = sum(f.count("rp") for _, _, f in tap.calls)
    got = rp_channel.got[rp0:]
    check(len(got) == republished and all(
        t == "rp/#" and topic.startswith("rp/fleet/") for t, topic, _ in got),
        f"rules {what}: {republished} republishes, the channel got "
        f"{len(got)}")
    out = {"messages": len(tap.calls), "fired": sum(len(f) for *_, f in
                                                    tap.calls),
           "fallback_rows": host_rows, "republished": republished}
    tap.calls.clear()
    return out


def rules_run(app, sv: dict, tap: RuleTap, rp_channel,
              attached: bool, big: int, n_pipe: int, card: str) -> dict:
    """``Broker.publish_batch`` on the plain mix at B=``big`` (3 batches)
    and B=64 (50), then the pipeline (depth 4, 512 a batch) on ``n_pipe``
    messages flushed on a worker thread: the rule checks on every message,
    one step a device batch, no host batch; a sample's delivery maps
    against the host path (``Broker.publish``)."""
    import threading
    broker, model, pipe, rng = app.broker, sv["model"], sv["pipe"], sv["rng"]
    led = app.ledger.totals
    out = {"card": card, "rules": len(app.rules.rules), "attached": attached}
    for batch, n_batches in ((big, 3), (64, 50)):
        batches = [messages(sv, batch) for _ in range(n_batches)]
        o0, r0, l0 = led().get("kernel_overflow", 0), len(rp_channel.got), \
            model.launch_count
        ts = []
        for msgs in batches:
            t = time.perf_counter()
            maps = broker.publish_batch(msgs)
            ts.append((time.perf_counter() - t) * 1e3)
        check(model.launch_count - l0 == n_batches,
              f"{model.launch_count - l0} steps for {n_batches} batches")
        res = rules_checks(app, tap, rp_channel, f"B={batch}", o0, r0)
        check(attached or res["fired"] == 0, "a detached rule fired")
        # the last batch's deliveries against the host path (which fires
        # its rules in the hook; those fires and republishes are dropped)
        n_fired, n_rp = len(tap.fired), len(rp_channel.got)
        for b in rng.choice(len(msgs), min(len(msgs), 256),
                            replace=False).tolist():
            got, want = sub_topics(maps[b]), sub_topics(broker.publish(
                msgs[b]))
            check(got == want, f"rules B={batch} {msgs[b].topic!r}: the "
                  f"device path delivers {got}, the host path {want}")
        del tap.fired[n_fired:], rp_channel.got[n_rp:]
        out[f"publish_batch_{batch}"] = dict(res, calls=n_batches,
                                             **pct(ts))
    msgs = messages(sv, n_pipe)
    o0, r0, l0 = led().get("kernel_overflow", 0), len(rp_channel.got), \
        model.launch_count
    b0, h0 = pipe.batches, pipe.host_batches
    for m in msgs:
        pipe.submit(m)
    took = []

    def flush():
        t = time.perf_counter()
        took.append((pipe.flush(), time.perf_counter() - t))

    th = threading.Thread(target=flush)
    th.start()
    th.join(timeout=600)
    check(not th.is_alive() and took and took[0][0] == n_pipe,
          f"the pipeline's flush took {took}")
    n_batches = pipe.batches - b0
    check(pipe.host_batches == h0 and n_batches == -(-n_pipe //
                                                     pipe.max_batch)
          and model.launch_count - l0 == n_batches,
          f"pipeline: {n_batches} batches, {pipe.host_batches - h0} on the "
          f"host, {model.launch_count - l0} steps")
    res = rules_checks(app, tap, rp_channel, "pipeline", o0, r0)
    check(attached or res["fired"] == 0, "a detached rule fired")
    out["pipeline"] = dict(res, depth=pipe.depth, max_batch=pipe.max_batch,
                           batches=n_batches,
                           messages_per_s=n_pipe / took[0][1])
    log(f"services rules {'attached' if attached else 'detached'}: "
        + json.dumps(out))
    return out


def rules_leg(app, sv: dict, card: str, big: int,
              n_pipe: int, n_dead: int) -> dict:
    """BASELINE config 5 (``bench.py:2669-2681``): 8 rules on live
    traffic (``fleet/+/vehicle/+/part/+/m{r}``, r < 8: half the plain
    mix's topics fire one) and ``n_dead`` on ``rules/fleet{r}/+/telemetry``
    (no topic matches them), each ``SELECT topic FROM "<filter>"`` with a
    recording action, and one ``republish`` rule on a live filter to
    ``rp/${topic}``, which a recording channel subscribes to; co-batched
    on the step through one refresh (its ms), run attached, then every
    rule deleted (``aux_release``), a refresh, and the same run
    detached."""
    model, broker = sv["model"], app.broker
    tap = RuleTap(app)
    broker.rules_matched_fn = tap.on_matched
    app.rules.register_action("record", tap.record)
    rp = RecordingChannel()
    app.cm.register_channel("rp0", rp)
    broker.subscribe("rp0", "rp/#")
    live = [f"fleet/+/vehicle/+/part/+/m{r}" for r in range(8)]
    dead = [f"rules/fleet{r}/+/telemetry" for r in range(n_dead)]
    record = [{"function": "record"}]
    t0 = time.perf_counter()
    for i, f in enumerate(live + dead):
        app.rules.create_rule(f"r{i}", f'SELECT topic FROM "{f}"', record)
    app.rules.create_rule("rp", f'SELECT topic FROM "{live[0]}"', record + [
        {"function": "republish", "args": {"topic": "rp/${topic}"}}])
    t1 = time.perf_counter()
    p0, u0 = model.patch_count, model.upload_count
    model.refresh()
    torch_sync(model.device)
    t2 = time.perf_counter()
    check(len(model._aux_refs) == len(live) + len(dead),
          f"{len(model._aux_refs)} aux filters in the trie")
    out = {"create_ms": (t1 - t0) * 1e3, "attach_refresh_ms": (t2 - t1) * 1e3,
           "attach_refresh": {"patches": model.patch_count - p0,
                              "uploads": model.upload_count - u0},
           "aux_filters": len(model._aux_refs)}
    out["attached"] = rules_run(app, sv, tap, rp, True, big, n_pipe, card)
    t0 = time.perf_counter()
    for rid in list(app.rules.rules):
        app.rules.delete_rule(rid)
    t1 = time.perf_counter()
    model.refresh()
    torch_sync(model.device)
    out.update(delete_ms=(t1 - t0) * 1e3,
               detach_refresh_ms=(time.perf_counter() - t1) * 1e3)
    check(not model._aux_refs and not app.rules.rules,
          f"{len(model._aux_refs)} aux filters left after the deletes")
    out["detached"] = rules_run(app, sv, tap, rp, False, big, n_pipe, card)
    log("services rules: " + json.dumps(
        {k: v for k, v in out.items() if k not in ("attached", "detached")}
        | {"card": card}))
    return out


def shared_retained_leg(app, sv: dict, card: str, groups: int,
                        big: int, members: int = 4) -> dict:
    """BASELINE config 4 (``bench.py:952-1046``): ``groups`` groups of
    ``members`` on ``$share/g{g}/fleet/f{g%512}/group{g}/+`` through
    ``Broker.subscribe`` (shared routes live on the host Router, not on the
    step); ``Broker.publish_batch`` on ``fleet/f{g%512}/group{g}/x``: each
    message reaches exactly one member of its group, and under round robin
    a group's members share its stream within ±1; per-message and batched
    dispatches/s over 50,000 picks (bench.py's); ``groups`` retained
    messages on ``fleet/f{g%512}/group{g}/state`` through retained
    publishes (the ``_retain_on_publish`` hook), ``Retainer.match`` of
    ``fleet/f{f}/+/state`` for every fleet against a plain scan with the
    port's ``topic.match``, a subscriber of one such filter through
    ``Broker.subscribe`` that gets that set through the CM, and retained
    lookups/s cold and warm (bench.py's)."""
    from emqx_tpu_torch.core import topic as T
    from emqx_tpu_torch.core.message import Message
    broker, model, rng = app.broker, sv["model"], np.random.default_rng(7)
    out = {"card": card, "groups": groups, "members": members}
    if groups < 100_000:
        out["reduced"] = f"groups {groups} of bench.py's 100,000"

    def filt(g):
        return f"fleet/f{g % 512}/group{g}/+"

    t0 = time.perf_counter()
    for g in range(groups):
        for k in range(members):
            broker.subscribe(f"g{g}m{k}", f"$share/g{g}/{filt(g)}")
    out["subscribe_s"] = time.perf_counter() - t0
    check(len(app.shared._tab) == groups, f"{len(app.shared._tab)} groups")
    l0 = model.launch_count
    hot = rng.choice(groups, big // 64, replace=False).tolist()
    streams = [rng.permutation(np.repeat(hot, 64)).tolist(),
               rng.integers(0, groups, big).tolist()]
    ts, counts = [], {}
    for gs in streams:
        msgs = [Message(topic=f"fleet/f{g % 512}/group{g}/x", payload=b"%d"
                        % i, from_=f"pub{i % 97}") for i, g in enumerate(gs)]
        t = time.perf_counter()
        maps = broker.publish_batch(msgs)
        ts.append((time.perf_counter() - t) * 1e3)
        for g, d in zip(gs, maps):
            check(len(d) == 1, f"group g{g}: delivered to {sorted(d)}")
            (sid, items), = d.items()
            check(sid.startswith(f"g{g}m") and len(items) == 1
                  and items[0][0] == f"$share/g{g}/{filt(g)}",
                  f"group g{g}: delivered {d}")
            counts.setdefault(g, {}).setdefault(sid, 0)
            counts[g][sid] += 1
    check(model.launch_count - l0 == len(streams), "a step per batch")
    spread = max(max(c.values()) - min(c.values()) if len(c) == members
                 else max(c.values()) for c in counts.values())
    check(spread <= 1, f"round robin spread {spread} within a group")
    picks = rng.integers(0, groups, 50_000).tolist()
    msg = Message(topic="x", payload=b"p")
    t0 = time.perf_counter()
    n = sum(len(app.shared.dispatch(f"g{g}", filt(g), msg,
                                    deliver_fn=lambda s, nd: True))
            for g in picks)
    per_msg = len(picks) / (time.perf_counter() - t0)
    legs = [(f"g{g}", filt(g), msg) for g in picks]
    t0 = time.perf_counter()
    got = app.shared.dispatch_batch(legs)
    batched = len(legs) / (time.perf_counter() - t0)
    check(n == len(picks) and all(p is not None for p in got),
          "a dispatch picked no member")
    out.update(publish_batch_ms=ts, round_robin_spread=spread,
               dispatches_per_s={"per_message": per_msg,
                                 "batched": batched})
    # retained: one per group, through retained publishes (the app's
    # retainer may already hold its $SYS topics)
    l0, r0 = model.launch_count, len(app.retainer)
    topics = [f"fleet/f{g % 512}/group{g}/state" for g in range(groups)]
    t0 = time.perf_counter()
    for i in range(0, groups, big):
        broker.publish_batch([Message(topic=t, payload=b"s" + t.encode(),
                                      flags={"retain": True})
                              for t in topics[i:i + big]])
    out["retain_publish_s"] = time.perf_counter() - t0
    check(len(app.retainer) == r0 + groups and model.launch_count - l0 ==
          -(-groups // big), f"{len(app.retainer) - r0} retained")
    t0 = time.perf_counter()
    found = {f: {m.topic for m in app.retainer.match(f"fleet/f{f}/+/state")}
             for f in range(512)}
    cold = 512 / (time.perf_counter() - t0)
    reps, t0 = 10, time.perf_counter()
    for _ in range(reps):
        for f in range(512):
            app.retainer.match(f"fleet/f{f}/+/state")
    warm = reps * 512 / (time.perf_counter() - t0)
    # the plain scan: every stored topic against its own fleet's filter,
    # and every stored topic against every filter for 8 fleets
    stored = [t for t in app.retainer.topics() if t.startswith("fleet/")]
    want = {f: set() for f in range(512)}
    for t in stored:
        f = int(t.split("/")[1][1:])
        if T.match(t, f"fleet/f{f}/+/state"):
            want[f].add(t)
    for f in rng.choice(512, 8, replace=False).tolist():
        check({t for t in stored if T.match(t, f"fleet/f{f}/+/state")}
              == want[f], f"fleet f{f}: the scan differs")
    check(found == want, "Retainer.match differs from the plain scan for "
          f"{[f for f in range(512) if found[f] != want[f]][:8]}")
    ch = RecordingChannel()
    app.cm.register_channel("ret0", ch)
    broker.subscribe("ret0", "fleet/f7/+/state")
    check(sorted(t for _, t, _ in ch.got) == sorted(want[7])
          and all(p == b"s" + t.encode() for _, t, p in ch.got),
          f"the retained subscriber got {len(ch.got)} of {len(want[7])}")
    out.update(retained=len(app.retainer), retained_per_lookup=len(want[7]),
               retained_lookups_per_s={"cold": cold, "warm": warm})
    # the groups leave: every session's end purges it from every group
    # (SharedSub.member_down, as the reference's), so 100,000 groups would
    # cost each later disconnect a walk of 400,000 members on the loop
    t0 = time.perf_counter()
    for g in range(groups):
        for k in range(members):
            broker.unsubscribe(f"g{g}m{k}", f"$share/g{g}/{filt(g)}")
    model.refresh()
    out["unsubscribe_s"] = time.perf_counter() - t0
    check(not app.shared._tab, f"{len(app.shared._tab)} groups left")
    log("services shared+retained: " + json.dumps(out))
    return out


def sys_leg(app, card: str) -> dict:
    """One ``SysHeartbeat.publish_kernel()`` over the leg's fold: a
    ``$SYS/#`` subscriber gets ``$SYS/brokers/<node>/kernel/<stage>/
    p50|p99|count`` for every stage, with the fold's values."""
    ch = RecordingChannel()
    app.cm.register_channel("sys0", ch)
    app.broker.subscribe("sys0", "$SYS/#")
    ch.got.clear()              # the retained $SYS topics the app's ticks left
    app.sys.publish_kernel()
    got = {t: p for _, t, p in ch.got}
    want = {}
    for stage, h in app.device_metrics.stage_hists().items():
        base = f"$SYS/brokers/{app.broker.node}/kernel/{stage}"
        want[f"{base}/p50"] = f"{h.percentile(0.5) / 1e6:.3f}".encode()
        want[f"{base}/p99"] = f"{h.percentile(0.99) / 1e6:.3f}".encode()
        want[f"{base}/count"] = str(int(h.count)).encode()
    check(got == want and len(want) >= 9,
          f"$SYS kernel heartbeat: got {got}, the fold's {want}")
    out = {"card": card, "topics": len(got),
           "batches": app.device_metrics.batches,
           "kernel": {t.rsplit("/kernel/", 1)[1]: p.decode()
                      for t, p in got.items()}}
    log("services $SYS: " + json.dumps(out))
    return out


def spill_app(model):
    """The port's app over ``model``: a rule ``SELECT topic FROM`` each
    of ``SPILL_FILTERS`` with a recording action, a subscriber on each of
    ``SPILL_SUBS``, and a recorder of each ``on_matched`` call's aux (None:
    the row spilled, and its rules fire from the engine's host trie)."""
    from emqx_tpu_torch.app import BrokerApp
    app = BrokerApp(router_model=model)
    fired, seen = [], []
    app.rules.register_action("record", lambda cols, args: fired.append(
        (cols["__rule_id"], cols["topic"])))
    for i, f in enumerate(SPILL_FILTERS):
        app.rules.create_rule(f"r{i}", f'SELECT topic FROM "{f}"',
                              [{"function": "record"}])
    for i, f in enumerate(SPILL_SUBS):
        app.broker.subscribe(f"c{i}", f)
    inner = app.broker.rules_matched_fn

    def on_matched(m, aux):
        seen.append((m.topic, None if aux is None else sorted(aux)))
        inner(m, aux)

    app.broker.rules_matched_fn = on_matched
    return app, fired, seen


def spill_leg(card: str, device) -> dict:
    """The rule engine's spill rows on the step: an app over a model on
    ``device`` with M=8 and ``ret_cap`` 4 (``tests/test_torch_rules.py``'s
    co-batch boundary case), ``SPILL_TOPICS`` in one ``publish_batch``:
    one step (one launch of the walk and one of the fan-out on the card);
    the first three rows spill (aux None: their rules fire from the
    engine's host trie), the other three ride the step's aux column; every
    (rule, topic) fires once and as ``rules_for_topic`` says;
    ``kernel_overflow`` 3; all of it, the delivery maps too, equal to the
    same app over a CPU model running the step's plain version."""
    from emqx_tpu_torch import RouterModel, TrieIndex
    from emqx_tpu_torch.core.message import Message
    from emqx_tpu_torch.ops import _build
    runs = {}
    for dev in (device, "cpu"):
        with env_var("EMQX_TPU_CPU_KERNEL", "xla"):    # on the CPU too
            model = RouterModel(TrieIndex(max_levels=4), n_sub_slots=64,
                                M=8, ret_cap=4, kernel_telemetry=True,
                                device=dev)
        app, fired, seen = spill_app(model)
        model.refresh()
        torch_sync(model.device)
        msgs = [Message(topic=t, payload=b"x") for t in SPILL_TOPICS]
        steps, before = model.launch_count, _build.launch_counts()
        maps = app.broker.publish_batch(msgs)
        torch_sync(model.device)
        delta = {k: v - before[k] for k, v in _build.launch_counts().items()
                 if v != before[k]}
        want = ({"walk_compact": 1, "fanout_pool": 1}
                if model.device.type == "cuda" else {})
        check(model.launch_count == steps + 1 and delta == want,
              f"spill ({model.device}): {model.launch_count - steps} "
              f"steps, launches {delta}")
        rules = sorted((r.id, t) for t in SPILL_TOPICS
                       for r in app.rules.rules_for_topic(t))
        check(sorted(fired) == rules and len(set(fired)) == len(fired),
              f"spill ({model.device}): fired {sorted(fired)}, the host "
              f"trie's rules {rules}")
        runs[dev] = (sorted(fired), seen, [sorted(d) for d in maps],
                     app.ledger.totals().get("kernel_overflow"))
    fired, seen, maps, overflow = runs[device]
    check(runs[device] == runs["cpu"], f"spill: the model on {device} "
          f"{runs[device]} != the CPU model's {runs['cpu']}")
    check([a is None for _, a in seen] == [True] * 3 + [False] * 3
          and overflow == 3, f"spill: aux {seen}, kernel_overflow "
          f"{overflow}")
    check(maps[0] == [f"c{i}" for i in range(len(SPILL_SUBS))],
          f"spill: {SPILL_TOPICS[0]!r} delivered to {maps[0]}")
    out = {"card": card, "topics": len(SPILL_TOPICS), "steps": 1,
           "spilled": sum(a is None for _, a in seen),
           "fired": len(fired), "kernel_overflow": overflow,
           "deliveries": sum(map(len, maps)),
           "aux": {t: a for t, a in seen}}
    log("services spill: " + json.dumps(out))
    return out


def services_phase(sv: dict, card: str, big: int = BATCH,
                   n_pipe: int = BATCH, n_dead: int = 992,
                   groups: int = SERVICE_GROUPS) -> dict:
    """The app's services over the serving leg's state (its 1M
    subscriptions from 131,072 session ids, broker, CM, pipeline and
    fold), the dense overlay lifted: the rules co-batched on the step
    (config 5), shared subscriptions and the retainer (config 4), and the
    ``$SYS`` kernel heartbeat; no device failover, no host batch."""
    t_start = time.time()
    broker, model = sv["broker"], sv["model"]
    for f in sorted(sv["bcast"]):
        for sid in sorted(broker.subscriber.get(f, ())):
            broker.unsubscribe(sid, f)
    model.refresh()
    app = sv["app"]
    h0 = sv["pipe"].host_batches
    out = {"rules": rules_leg(app, sv, card, big, n_pipe, n_dead),
           "shared_retained": shared_retained_leg(app, sv, card, groups,
                                                  big),
           "sys": sys_leg(app, card),
           "spill": spill_leg(card, model.device)}
    failovers = app.metrics.val("messages.device_failover")
    check(failovers == 0 and sv["pipe"].host_batches == h0
          and model.host_match_count == 0,
          f"{failovers} device failovers, "
          f"{sv['pipe'].host_batches - h0} host batches")
    out["seconds"] = time.time() - t_start
    log(f"services phase: {json.dumps({'card': card, 'seconds': out['seconds']})}")
    return out


# ---------------------------------------------------------------------------
# the app leg: the config-booted app's access control and hook services
# over wire clients, the routing step on the card
# ---------------------------------------------------------------------------


async def dispatched(pipe) -> None:
    """Until every batch ``pipe`` has counted as published is dispatched:
    ``flush`` runs after the flush thread's drain in progress, whose
    dispatches follow its counts."""
    await asyncio.to_thread(pipe.flush)


async def _until(cond, what: str, timeout: float = 30.0) -> None:
    end = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < end, f"app: timed out waiting for {what}")
        await asyncio.sleep(0.005)


async def _app_run(sv: dict, card: str, subs: int, pubs: int, n_msgs: int,
                   connects: int) -> dict:
    """The app leg's clients, in the smoke's own loop (a few dozen), over
    the app's TCP listener; see :func:`app_phase`."""
    from collections import Counter

    from emqx_tpu_torch.core.message import Message
    from emqx_tpu_torch.mqtt import packet as P
    from emqx_tpu_torch.mqtt.client import MqttClient
    from emqx_tpu_torch.ops import _build
    app, model, pipe, broker = sv["app"], sv["model"], sv["pipe"], sv["broker"]
    on_card = model.device.type == "cuda"
    errors = ErrorRecords()
    logging.getLogger("emqx_tpu_torch.pipeline").addHandler(errors)
    await app.listeners.start_all(wire_listeners(sv["conf"]))
    port = app.listeners.find("tcp:default").port
    b0, l0, h0 = pipe.batches, model.launch_count, pipe.host_batches

    class Stamped(MqttClient):
        """Keeps (arrival ns, topic, payload) of each PUBLISH it gets."""

        async def _route_in(self, pkt) -> None:
            if pkt.type == P.PUBLISH:
                self.got.append((time.monotonic_ns(), pkt.topic,
                                 bytes(pkt.payload)))
            await super()._route_in(pkt)

    def client(cid: str, secret: str | None = None, ver: int = 5):
        c = Stamped(port=port, clientid=cid, proto_ver=ver, keepalive=600,
                    username=cid,
                    password=(secret or password(cid)).encode())
        c.got = []
        return c

    async def connack(c) -> int:
        try:
            await c.connect(timeout=30.0)
        except ConnectionRefusedError:
            pass
        else:
            await c.disconnect()
        return c.connack.reason_code

    out = {"card": card}
    live = []
    # a stalled loop shows where it stands: every thread's stack, each
    # STALL_DUMP_S while the leg runs; and the leg's GC pauses
    faulthandler.dump_traceback_later(STALL_DUMP_S, repeat=True)
    gc_ms, gc_t0 = [], []

    def gc_pause(phase, info):
        if phase == "start":
            gc_t0[:] = [time.perf_counter()]
        elif gc_t0:
            gc_ms.append((info["generation"],
                          (time.perf_counter() - gc_t0[0]) * 1e3))

    gc.callbacks.append(gc_pause)
    try:
        # CONNECT through the built-in DB (sha256), one at a time
        conn_ms = []
        for i in range(connects):
            c = client(f"a{i}")
            t = time.perf_counter()
            await c.connect(timeout=30.0)
            conn_ms.append((time.perf_counter() - t) * 1e3)
            if conn_ms[-1] > 1e3:
                log(f"app: CONNECT a{i} took {conn_ms[-1]:.1f} ms")
            live.append(c)
        for c in live[subs:]:
            await c.disconnect()
        live = live[:subs]
        out["connect_ms"] = pct(conn_ms)
        # refused: a wrong password, a client id not in the DB, a banned one
        app.access.banned.create("clientid", "ab", by="chip_smoke",
                                 reason="banned by the smoke",
                                 duration_s=300.0)
        rcs = {"wrong_password": await connack(client("aw", "wrong")),
               "unknown_clientid": await connack(client("nobody")),
               "banned": await connack(client("ab"))}
        check(rcs == {"wrong_password": P.RC_BAD_USER_NAME_OR_PASSWORD,
                      "unknown_clientid": P.RC_NOT_AUTHORIZED,
                      "banned": P.RC_BANNED},
              f"app: CONNACK reason codes {rcs}")
        # flapping: APP_FLAP abnormal disconnects ban the client id
        for k in range(APP_FLAP):
            c = client("af")
            await c.connect(timeout=30.0)
            await c.close()                   # no DISCONNECT: abnormal
            await _until(lambda: app.cm.lookup_channel("af") is None
                         or app.cm.lookup_channel("af").conn_state
                         != "connected", "the flapping client's close")
        await _until(lambda: app.access.banned.look_up("clientid", "af")
                     is not None, "the flapping ban")
        rcs["flapping"] = await connack(client("af"))
        check(rcs["flapping"] == P.RC_BANNED,
              f"app: a flapping client reconnects with {rcs['flapping']}")
        out["connack"] = rcs
        log("app access: " + json.dumps(
            {"card": card, "connects": connects,
             "connect_ms": out["connect_ms"], "connack": rcs}))
        # a publish the ACL denies: PUBACK 0x87, and no step runs
        px = client("ax")
        await px.connect(timeout=30.0)
        l1, m1 = model.launch_count, pipe.published
        await px._send(P.Publish(topic=APP_SECRET.replace("#", "x"),
                                 payload=b"s", qos=1, packet_id=7))
        ack = await px._expect(P.PUBACK, 30.0)
        await asyncio.sleep(0.2)
        check(ack.reason_code == P.RC_NOT_AUTHORIZED
              and model.launch_count == l1 and pipe.published == m1,
              f"app: a denied publish got PUBACK 0x{ack.reason_code:02x}, "
              f"{model.launch_count - l1} steps")
        # the rewrite rule: rw/... is delivered on app/rw/..., by the step
        src, _, dest = APP_REWRITE
        rw = client("arw")
        await rw.connect(timeout=30.0)
        await rw.subscribe(dest.replace("$1", "#"), qos=0)
        l1 = model.launch_count
        await px.publish("rw/x/y", b"rw", qos=1)
        got = await rw.recv(30.0)
        rewritten = dest.replace("$1", "x/y")
        check(got.topic == rewritten and got.payload == b"rw"
              and model.launch_count > l1,
              f"app: the rewrite delivered {got.topic!r} after "
              f"{model.launch_count - l1} steps")
        # auto-subscribe: a new client's filter reaches the card in one
        # patch, then a delivery on it
        k0 = dict(_build.launch_counts())
        p0 = model.patch_count
        aa = client("aa")
        await aa.connect(timeout=30.0)
        auto = APP_AUTO.replace("%c", "aa")
        check(auto in broker.subscription.get("aa", ()),
              "app: no auto-subscription")
        await px.publish(auto, b"auto", qos=1)
        got = await aa.recv(30.0)
        patches = model.patch_count - p0
        patch_launches = (_build.launch_counts()["patch"] - k0["patch"]
                          if on_card else patches)
        check(got.topic == auto and patches == 1 and patch_launches == 1,
              f"app: the auto-subscription delivered {got.topic!r} after "
              f"{patches} patches, {patch_launches} patch launches")
        # topic metrics of a registered filter
        app.topic_metrics.register(APP_METRICS)
        tm = client("atm")
        await tm.connect(timeout=30.0)
        await tm.subscribe(APP_METRICS.replace("+", "#"), qos=0)
        for k in range(8):
            await px.publish(APP_METRICS.replace("+", str(k)), b"tm", qos=1)
        for _ in range(8):
            await tm.recv(30.0)
        tmm = app.topic_metrics.metrics(APP_METRICS)
        check(tmm["messages.in"] == 8 and tmm["messages.qos1.in"] == 8
              and tmm["messages.out"] == 8,
              f"app: topic metrics of {APP_METRICS}: {tmm}")
        out["topic_metrics"] = tmm
        log("app hooks: " + json.dumps(
            {"card": card, "denied_puback": ack.reason_code,
             "rewrite": rewritten, "auto_patches": patches,
             "auto_patch_launches": patch_launches, "topic_metrics": tmm}))
        # sampled messages: deliveries equal the host path's
        rng = np.random.default_rng(sv["sessions"] + 11)
        wire = []
        for c in live:
            for q, f in enumerate(sv["live"][k] for k in rng.choice(
                    len(sv["live"]), 4, replace=False).tolist()):
                await c.subscribe(f, qos=q % 2, rh=2)
                wire.append(f)
        senders = [client(f"ap{j}", ver=4) for j in range(pubs)]
        for c in senders:
            await c.connect(timeout=30.0)
        topics = net_topics(sv, wire, rng, n_msgs)
        plans = [topics[j::pubs] for j in range(pubs)]
        ids = {c.clientid: i for i, c in enumerate(live)}
        want = [Counter() for _ in live]
        for j, plan in enumerate(plans):
            for k, t in enumerate(plan):
                for sid, items in broker.publish(Message(
                        topic=t, payload=b"", from_=f"ap{j}")).items():
                    if sid in ids:
                        want[ids[sid]][(t, j, k)] += len(items)
        for c in live:
            c.got.clear()
        l1, b1 = model.launch_count, pipe.batches

        async def send(j, c, plan):
            for k, t in enumerate(plan):
                await c.publish(t, b"app:%d:%d:%d" % (
                    j, k, time.monotonic_ns()), qos=0)

        await asyncio.gather(*(send(j, c, plan) for j, (c, plan)
                               in enumerate(zip(senders, plans))))
        n_want = [sum(w.values()) for w in want]
        await _until(lambda: all(
            sum(p.startswith(b"app:") for _, _, p in c.got) >= n
            for c, n in zip(live, n_want)), "the sampled deliveries", 120.0)
        await asyncio.sleep(0.25)             # late or duplicate deliveries
        lat = []
        for c, w in zip(live, want):
            seen = Counter()
            for t_ns, topic, payload in c.got:
                if payload.startswith(b"app:"):
                    j, k, stamp = map(int, payload[4:].split(b":"))
                    seen[(topic, j, k)] += 1
                    lat.append((t_ns - stamp) / 1e6)
            check(seen == w, f"app: {c.clientid} got {sum(seen.values())} "
                  f"sampled messages, the host path routes "
                  f"{sum(w.values())}")
        steps, batches = model.launch_count - l1, pipe.batches - b1
        check(steps == batches >= 1, f"app: {steps} steps for {batches} "
              f"device batches")
        out["sampled"] = {"messages": n_msgs, "deliveries": len(lat),
                          "subscribers": len(live), "steps": steps,
                          "delivery_ms": pct(lat)}
        log("app sampled: " + json.dumps({"card": card, **out["sampled"]}))
        for c in live + senders + [px, rw, aa, tm]:
            await c.disconnect()
    finally:
        faulthandler.cancel_dump_traceback_later()
        gc.callbacks.remove(gc_pause)
        out["gc"] = {"collections": len(gc_ms),
                     "max_ms": max((m for _, m in gc_ms), default=0.0),
                     "full": sum(g == 2 for g, _ in gc_ms)}
        log("app gc: " + json.dumps(out["gc"]))
        await app.listeners.stop_all()
        logging.getLogger("emqx_tpu_torch.pipeline").removeHandler(errors)
    check(pipe.host_batches == h0 and model.host_match_count == 0,
          "app: a batch was served on the host")
    check(pipe.batches - b0 == model.launch_count - l0,
          f"app: {model.launch_count - l0} steps for {pipe.batches - b0} "
          f"device batches")
    check(app.metrics.val("messages.device_failover") == 0,
          "app: a device failover")
    check(not errors.records, f"app: the pipeline logged "
          f"{errors.records[:3]}")
    return out


def app_phase(sv: dict, card: str, subs: int = APP_SUBS,
              pubs: int = APP_PUBS, n_msgs: int = APP_MESSAGES,
              connects: int = APP_CONNECTS) -> dict:
    """The config-booted app over the serving leg's state, its listeners
    up again, wire clients in the smoke's own process: CONNECTs timed
    through the built-in DB; a wrong password (0x86), a client id not in
    the DB (0x87) and a banned one (0x8A) refused; APP_FLAP abnormal
    disconnects ban a client id (flapping); a QoS 1 publish the ACL denies
    gets PUBACK 0x87 and runs no step; the rewrite rule's source topic is
    delivered on its destination, routed by the step; a new client's
    auto-subscription reaches the card in one patch launch and then
    delivers; TopicMetrics of a registered filter count what was sent and
    delivered; ``app.tick()``; ``app.prometheus()`` carries the kernel
    fold's gauges and ``app.kernel_summary()`` its stage percentiles; on
    ``n_msgs`` sampled messages every subscriber gets what the host path
    (``app.broker.publish``) routes to it; one step a device batch, no
    failover, no host batch."""
    t_start = time.time()
    app = sv["app"]
    # the overload protection's lag is a moving average that only the
    # listeners' housekeeping ticks update: the network phase's last
    # reading stood still while the listeners were down (overloaded, the
    # app refuses every new connection at accept)
    olp = idle_olp(app, sv["listeners_down_at"], "app")
    check(not app.olp.is_overloaded(), f"app: the overload protection "
          f"refuses new connections: {olp}")
    out = asyncio.run(_app_run(sv, card, subs, pubs, n_msgs, connects))
    out["olp"] = olp
    t = time.perf_counter()
    app.tick()
    out["tick_ms"] = (time.perf_counter() - t) * 1e3
    text = app.prometheus()
    for name in ("emqx_kernel_batches", "emqx_kernel_filters_total",
                 "emqx_latency_kernel_step_seconds_count"):
        check(name in text, f"app: the exposition lacks {name}")
    ks = app.kernel_summary()
    check(ks["batches"] == app.device_metrics.batches and ks["gauges"]
          and all(ks["stages"][s]["count"] > 0
                  for s in ("submit", "step", "decode")),
          f"app: kernel_summary {ks.get('stages')}")
    out["kernel_step_us"] = {k: ks["stages"]["step"][k]
                             for k in ("p50_us", "p99_us")}
    out["seconds"] = time.time() - t_start
    log("app phase: " + json.dumps(
        {k: out[k] for k in ("card", "tick_ms", "kernel_step_us",
                             "seconds")}))
    return out


def serving_phase(seed: int, device, card: str, n_filters: int = N_FILTERS,
                  n_s4: int = SERVE_S4_FILTERS, sessions: int = SESSIONS,
                  big: int = BATCH, n_pipe: int = BATCH,
                  net: dict | None = None,
                  native: dict | None = None,
                  services: dict | None = None,
                  app: dict | None = None) -> dict:
    """The serving plane over a model on the card: the flat leg at the
    smoke's deployment, booted from its config; the network phase, the
    native path, the services phase and the app leg on its state
    (``net``, ``native``, ``services``, ``app``: their sizes, for a
    rehearsal), then the host-dispatch leg, then the S=4 leg at ``n_s4``
    filters.  The two serving legs, the network and the native path, the
    services phase and the app leg are each their own launch-count path;
    the host-dispatch leg's launches are logged apart and count on no
    path.  Each part's seconds are in ``seconds``."""
    import shutil

    from emqx_tpu_torch.ops import _build
    out, secs = {}, {}
    t = time.time()
    _build.reset_launch_counts()
    sv = serving_load(n_filters, seed, device, None, sessions)
    out["boot"] = sv["boot"]
    secs["serving_load"] = time.time() - t
    t = time.time()
    out["flat"] = [
        # 6 calls at B=16384, cut from 12 to pay for the native path
        # (the p50 of 6 calls still spans the host's spread)
        serve_mix(sv, "plain", big, 4, 6, 2048, card),
        serve_mix(sv, "plain", 64, 32, 200, 2048, card),
        serve_pipeline(sv, "plain", n_pipe, card),
        serve_fold_cost(sv, big, 4, card),
        serve_fold_cost(sv, 64, 100, card)]
    serve_overlay(sv)
    out["flat"] += [
        serve_mix(sv, "dense", 64, 32, 100, 2048, card),
        # one batch, one call, timed and then checked: the delivery-map
        # loop visits ~98 slots x 16 sessions x the matched filters a
        # message; cut from three calls at B=16384, then two, then one
        # (28-47 s), and to B=4096 to pay for the native path
        serve_mix(sv, "dense", big // 4, 1, 1, min(512, big // 4), card),
        serve_pipeline(sv, "dense", 2048, card)]
    out["flat_checks"] = serve_checks(sv)
    out["counts"] = path_counts("serving")
    secs["serving"] = time.time() - t
    # the network entry over the same state: MQTT clients over sockets
    t = time.time()
    _build.reset_launch_counts()
    out["network"] = network_phase(sv, seed, card, **(net or {}))
    out["network_counts"] = path_counts("network")
    secs["network"] = time.time() - t
    # the native entry over the same state: the C++ host's device lane,
    # before any rule is attached (a topic a rule matches earns no permit)
    t = time.time()
    _build.reset_launch_counts()
    out["native"] = native_phase(sv, seed, card, **(native or {}))
    out["native_counts"] = path_counts("native")
    secs["native"] = time.time() - t
    # the app's services over the same state: rules co-batched on the
    # step, shared subscriptions, the retainer, $SYS
    t = time.time()
    _build.reset_launch_counts()
    out["services"] = services_phase(sv, card, **(services or {}))
    out["services_counts"] = path_counts("services")
    secs["services"] = time.time() - t
    # the config-booted app's access control and hook services over wire
    # clients, on the same state
    t = time.time()
    _build.reset_launch_counts()
    out["app"] = app_phase(sv, card, **(app or {}))
    out["app_counts"] = path_counts("app")
    secs["app"] = time.time() - t
    shutil.rmtree(sv["data_dir"], ignore_errors=True)
    sv["model"].telemetry = sv["fold"].model = None    # the only cycle
    del sv
    # a check beside the path: its small kernel models' launches are
    # logged on their own and stay off the kernels line
    t = time.time()
    _build.reset_launch_counts()
    out["host_dispatch"] = host_dispatch_leg(device, seed + 3, card)
    torch_sync(device)
    log("launches of the host-dispatch leg (off the kernels line): "
        + json.dumps(_build.launch_counts()))
    secs["host_dispatch"] = time.time() - t
    t = time.time()
    _build.reset_launch_counts()
    sv = serving_load(n_s4, seed, device, SHARDS, sessions)
    out["s4"] = [
        serve_mix(sv, "plain", big, 4, 4, 2048, card),
        serve_mix(sv, "plain", 64, 32, 100, 2048, card),
        serve_pipeline(sv, "plain", n_pipe // 4, card)]
    serve_overlay(sv)
    out["s4"].append(serve_mix(sv, "dense", 64, 32, 50, 2048, card))
    out["s4_checks"] = serve_checks(sv)
    out["s4_counts"] = path_counts("serving_s4")
    secs["serving_s4"] = time.time() - t
    out["seconds"] = secs
    return out


# ---------------------------------------------------------------------------
# the durable and integrations path: a second config-booted app with
# persistent sessions, an exhook provider, authn on MySQL and authz on
# MongoDB, a Kafka bridge and the management API, the step on the card
# ---------------------------------------------------------------------------


def marking_provider():
    """The port's ``HookProvider`` the durable path's exhook server runs:
    it drops a message whose payload starts ``drop:``, moves one whose
    payload starts ``rw:`` to its ``rewrite_to`` topic, and passes the
    rest; it counts its ``OnMessagePublish`` calls and its
    ``client.connected`` notices."""
    import threading

    from emqx_tpu_torch.exhook import proto
    from emqx_tpu_torch.exhook.provider import HookProvider

    class Marking(HookProvider):
        def __init__(self) -> None:
            self.rewrite_to = ""
            self.publishes = self.connected = 0
            self._lock = threading.Lock()

        def on_message_publish(self, args):
            with self._lock:
                self.publishes += 1
            m = args["message"]
            if m["payload"].startswith(b"drop:"):
                return {"type": proto.STOP_AND_RETURN,
                        "value": {"drop": True}}
            if m["payload"].startswith(b"rw:"):
                return {"type": proto.STOP_AND_RETURN, "value": {
                    "message": {**m, "topic": self.rewrite_to}}}
            return None

        def on_client_connected(self, args):
            with self._lock:
                self.connected += 1

    return Marking()


def durable_users(subs: int = DUR_SUBS, pubs: int = DUR_PUBS,
                  connects: int = DUR_CONNECTS) -> list[str]:
    """Every client id of the durable path's own legs, each a user of its
    MySQL table: the persistent subscribers, the publishers, the CONNECTs
    timed through MySQL and the denied publisher."""
    return ([f"d{i}" for i in range(subs)] + [f"dp{j}" for j in range(pubs)]
            + [f"dc{i}" for i in range(connects)] + ["dx"])


def durable_servers(users: list[str], blank=()) -> dict:
    """The in-repo servers the durable app uses, threads of this process:
    ``MiniMySQL`` holding ``users`` (salted sha256, the password
    :func:`password` gives, or an empty one for those in ``blank``),
    ``MiniMongo`` holding an ACL for every client
    (deny publishes on DUR_SECRET, allow everything else), ``MiniKafka``
    with one partition of DUR_KAFKA_TOPIC, and the exhook provider
    (:func:`marking_provider`) on a ``ProviderServer``."""
    from emqx_tpu_torch.access.hashing import HashSpec, hash_password
    from emqx_tpu_torch.connector.kafka import MiniKafka
    from emqx_tpu_torch.connector.mongodb import MiniMongo
    from emqx_tpu_torch.connector.mysql import MiniMySQL
    from emqx_tpu_torch.exhook.provider import ProviderServer
    spec = HashSpec(name="sha256", salt_position="prefix")
    mysql = MiniMySQL(user="root", password="")
    blank = set(blank)
    mysql.tables["mqtt_user"] = [
        {"username": u, "salt": f"s-{u}", "is_superuser": "0",
         "password_hash": hash_password(
             spec, f"s-{u}".encode(),
             b"" if u in blank else password(u).encode()).decode()}
        for u in users]
    mongo = MiniMongo()
    mongo.collections["mqtt_acl"] = [
        {"scope": "all", "permission": "deny", "action": "publish",
         "topics": [DUR_SECRET]},
        {"scope": "all", "permission": "allow", "action": "all",
         "topics": ["#"]}]
    provider = marking_provider()
    out = {"mysql": mysql.start(), "mongo": mongo.start(),
           "kafka": MiniKafka(topics={DUR_KAFKA_TOPIC: 1}).start(),
           "exhook": ProviderServer(provider), "provider": provider}
    out["exhook"].start()
    return out


def durable_conf(data_dir: str, _users, servers: dict) -> str:
    """The durable path's HOCON config: the routing step on the card at
    the smoke's widths, a TCP listener on 127.0.0.1, ``durable.enable``
    (sessions on the port's ``NativeDurableStore`` in ``node.data_dir``), one
    exhook server over the framed transport (the card's machine has no
    ``grpcio``, so a ``grpc://`` server would fail the boot there, as the
    reference's does), authentication on MySQL (salted sha256, the row
    looked up by client id: the MQTT-SN and LwM2M gateways authenticate by
    client id alone) and authorization on MongoDB (``no_match = deny``),
    and ``node.data_dir`` in a temporary directory.  The node is ``n1``
    of the cluster path."""
    ex, my, mo = (servers[k].port for k in ("exhook", "mysql", "mongo"))
    return f"""
    node {{ name = "n1@127.0.0.1", data_dir = "{data_dir}" }}
    router.device {{
      enable = true, max_levels = 8, n_sub_slots = 8192, frontier_k = 32,
      match_cap = 128, return_cap = 16, batch_max = 512,
      pipeline_depth = 4, min_batch = 0
    }}
    listeners.default {{ type = tcp, bind = "127.0.0.1:0" }}
    durable.enable = true
    exhook.servers = [{{
      name = smoke, url = "framed://127.0.0.1:{ex}", pool_size = 4,
      request_timeout = 60, failed_action = deny, auto_reconnect = false
    }}]
    authentication = [{{
      mechanism = password_based, backend = mysql,
      server = "127.0.0.1:{my}", username = root, password = "",
      database = mqtt,
      query = "{DUR_AUTHN_QUERY}",
      password_hash_algorithm {{ name = sha256, salt_position = prefix }}
    }}]
    authorization {{
      no_match = deny
      sources = [{{ type = mongodb, server = "127.0.0.1:{mo}",
                   database = mqtt, collection = mqtt_acl,
                   filter {{ scope = all }} }}]
    }}
    """


def boot_durable(device, servers: dict, users: list[str]) -> tuple:
    """:func:`boot_app` of :func:`durable_conf`: besides its checks, the
    boot put the persistent sessions on the port's ``NativeDurableStore``
    under ``node.data_dir`` (the native library builds: no D4 warning),
    the exhook server is loaded with ``message.publish`` and
    ``client.connected``, authn is the MySQL provider and authz the MongoDB
    source."""
    from emqx_tpu_torch import native
    from emqx_tpu_torch.access.db_backends import MongoAclSource, \
        SqlAuthnProvider
    from emqx_tpu_torch.session.persistent import NativeDurableStore
    check(native.available(), f"durable: the native library does not "
          f"build: {native.build_error()}")
    warned = ErrorRecords()
    warned.setLevel(logging.WARNING)
    app_log = logging.getLogger("emqx_tpu_torch.app")
    app_log.addHandler(warned)
    try:
        app, conf, data_dir, boot = boot_app(
            device, users, functools.partial(durable_conf, servers=servers),
            prefix="chip_smoke_durable_")
    finally:
        app_log.removeHandler(warned)
    d4 = [r for r in warned.records if "durable.enable" in r]
    store = app.persistent.store
    check(isinstance(store, NativeDurableStore) and not d4
          and store.native.dir.startswith(data_dir),
          f"durable: the boot is not on NativeDurableStore: "
          f"{type(store).__name__}, {warned.records}")
    ex = app.exhook.servers.get("smoke") if app.exhook else None
    check(ex is not None and ex.loaded and set(ex.hooks_wanted) == {
        "message.publish", "client.connected"},
        f"durable: the exhook server {ex and ex.hooks_wanted}")
    check([type(p) for p in app.access.authn.providers] == [
        SqlAuthnProvider] and any(isinstance(s, MongoAclSource)
                                  for s in app.access.authz.sources),
          "durable: authn or authz is not on the databases")
    boot.update(store=type(store).__name__, store_dir=store.native.dir,
                exhook_hooks=sorted(ex.hooks_wanted))
    return app, conf, data_dir, boot


class DurableStamps:
    """Times two seams of the durable app while a leg runs: the
    persistent sessions' ``persist_message`` (the host trie walk each
    published message takes in the hook fold) and the broker's
    ``publish_batch_submit`` + ``publish_batch_collect`` (what the
    pipeline calls a batch), each wrapped on its instance."""

    def __init__(self, app) -> None:
        self.app, self.ns = app, {"persist": 0, "publish_batch": 0}
        self.calls = {"persist": 0, "publish_batch": 0}
        ps, br = app.persistent, app.broker
        self._saved = [(ps, "persist_message", ps.persist_message),
                       (br, "publish_batch_submit", br.publish_batch_submit),
                       (br, "publish_batch_collect",
                        br.publish_batch_collect)]
        for obj, name, fn in self._saved:
            key = "persist" if obj is ps else "publish_batch"
            setattr(obj, name, self._timed(key, fn))

    def _timed(self, key, fn):
        def wrapped(*a, **kw):
            t = time.perf_counter_ns()
            try:
                return fn(*a, **kw)
            finally:
                self.ns[key] += time.perf_counter_ns() - t
                self.calls[key] += fn.__name__ != "publish_batch_collect"
        return wrapped

    def close(self) -> dict:
        for obj, name, _fn in self._saved:
            delattr(obj, name)
        return {"persist_ms": self.ns["persist"] / 1e6,
                "persist_calls": self.calls["persist"],
                "publish_batch_ms": self.ns["publish_batch"] / 1e6,
                "publish_batches": self.calls["publish_batch"],
                "persist_share": self.ns["persist"]
                / max(1, self.ns["publish_batch"])}


def stored_markers(store, sid: str) -> list:
    """``(topic, payload)`` of each message the durable store keeps for
    session ``sid`` (``NativeDurableStore``: the native store's pending
    rows, read without consuming them)."""
    tok = store.native.lookup(sid)
    return [(r[5], r[6]) for r in store.native.fetch(tok)] if tok else []


def stored_guids(store, sids) -> set:
    """The guids of the messages the store keeps for ``sids``."""
    out = set()
    for sid in sids:
        tok = store.native.lookup(sid)
        if tok:
            out.update(r[0] for r in store.native.fetch(tok))
    return out


def _ids(payload: str) -> tuple:
    """(publisher, sequence) of a durable-path payload
    ``[mark:]j:k:stamp``."""
    j, k = payload.split(":")[-3:-1]
    return int(j), int(k)


def _stream_checks(what: str, got: list, want) -> list:
    """A client's deliveries against ``want`` (a Counter of (delivered
    topic, publisher, sequence)): equal as multisets, so no duplicate and
    none missing, and each publisher's order kept; the (arrival ns,
    stamp ns) of each."""
    from collections import Counter
    seen, last, stamps = Counter(), {}, []
    for t_ns, topic, payload, _qos in got:
        j, k = _ids(payload)
        seen[(topic, j, k)] += 1
        check(last.get(j, -1) < k, f"{what}: publisher {j}'s "
              f"message {k} after {last.get(j)}")
        last[j] = k
        stamps.append((t_ns, int(payload.rsplit(":", 1)[1])))
    check(seen == want, f"{what}: got {sum(seen.values())} "
          f"messages, want {sum(want.values())}: missing "
          f"{list((want - seen).items())[:3]}, extra "
          f"{list((seen - want).items())[:3]}")
    return stamps


def _host_routes(broker, msgs: list, ids: list) -> dict:
    """The host path's (``Broker.publish``, the hook chain included)
    routing of ``msgs`` (payload ``[mark:]j:k:0``) to the client ids
    ``ids``: a Counter of (delivered topic, publisher, sequence) each."""
    from collections import Counter
    want = {c: Counter() for c in ids}
    for m in msgs:
        j, k = _ids(m.payload.decode())
        for sid, items in broker.publish(m).items():
            if sid in want:
                for _st, d in items:
                    want[sid][(d.topic, j, k)] += 1
    return want


async def _durable_run(sv: dict, card: str, servers: dict, subs: int,
                       pubs: int, n_msgs: int, n_exhook: int,
                       connects: int, n_bridge: int) -> dict:
    """The durable path's legs over the durable app's listener, the
    clients in the network phase's child process (its client pool); see
    :func:`durable_phase`."""
    from collections import Counter

    from emqx_tpu_torch.connector.kafka import KafkaConnector
    from emqx_tpu_torch.core import topic as T
    from emqx_tpu_torch.core.message import Message
    from emqx_tpu_torch.mgmt.api import ManagementApi
    from emqx_tpu_torch.mgmt.cli import CtlClient
    from emqx_tpu_torch.mqtt import packet as P
    from emqx_tpu_torch.router.trie import Trie
    app, model, pipe, broker = sv["app"], sv["model"], sv["pipe"], sv["broker"]
    store, provider = app.persistent.store, servers["provider"]
    errors = ErrorRecords()
    logging.getLogger("emqx_tpu_torch.pipeline").addHandler(errors)
    await app.listeners.start_all(sv["conf"].get("listeners"))
    port = app.listeners.find("tcp:default").port
    pool = ClientPool("durable")
    ask = pool.ask

    async def routed(m0: int, count: int) -> None:
        """Until the pipeline has routed ``count`` messages since ``m0``
        and dispatched them: it counts a batch before its flush thread
        dispatches it, and a session resumed in between gets the stored
        copy and then the late dispatch (a duplicate; R15's race)."""
        for _ in range(12000):
            if pipe.published - m0 >= count:
                await dispatched(pipe)
                return
            await asyncio.sleep(0.01)
        check(False, f"durable: the pipeline routed {pipe.published - m0} "
              f"of {count} messages")

    def spec(cid: str, **kw) -> dict:
        return {"cid": cid, "port": port, "password": password(cid), **kw}

    async def connect(clients: list, what: str) -> dict:
        """The pool connects ``clients`` 32 at a time, each slice once
        the overload protection admits new connections: the persistent
        sessions' CONNECTs (MySQL, the native store) can stall the loop
        past its lag limit, and then the next CONNECTs would be closed
        at accept with no CONNACK (R7)."""
        got = {}
        for i in range(0, len(clients), 32):
            await olp_settled(app, what)
            got.update((await ask({"cmd": "connect",
                                   "clients": clients[i:i + 32]}, 900)
                        )["connected"])
        return got

    out = {"card": card}
    b0, l0, h0 = pipe.batches, model.launch_count, pipe.host_batches
    mgmt = None
    rng = np.random.default_rng(sv["sessions"] + 23)
    try:
        await pool.start()
        # -- 1. persistent sessions -----------------------------------------
        live = sv["live"]
        sub_specs = [spec(f"d{i}", clean=False, expiry=3600, filters=[
            [live[k], 1] for k in rng.choice(len(live), 4,
                                             replace=False).tolist()])
            for i in range(subs)]
        sids = [s["cid"] for s in sub_specs]
        p0 = model.patch_count
        r = await connect(sub_specs, "durable subscribers")
        check(all(r[c]["rc"] == 0 and r[c]["suback"] == [1] * 4
                  for c in sids), "durable: a subscriber was refused")
        await ask({"cmd": "disconnect", "cids": sids}, 300)
        await _until(lambda: not any(
            getattr(app.cm.lookup_channel(c), "conn_state", None)
            == "connected" for c in sids), "the subscribers' disconnects")
        check(all(sorted(store.get_session(s["cid"])["subs"])
                  == sorted(f for f, _ in s["filters"]) for s in sub_specs),
              "durable: the store lacks a session's subscriptions")
        pub_ids = [f"dp{j}" for j in range(pubs)]
        r = (await ask({"cmd": "connect", "clients": [
            spec(c) for c in pub_ids]}, 300))["connected"]
        check(all(r[c]["rc"] == 0 for c in pub_ids),
              "durable: a publisher was refused")
        wire = [f for s in sub_specs for f, _ in s["filters"]]
        topics = net_topics(sv, wire, rng, n_msgs)
        plans = {c: [[t, 1, f"{j}:{k}:{{t}}"] for k, t in
                     enumerate(topics[j::pubs])]
                 for j, c in enumerate(pub_ids)}
        stamps = DurableStamps(app)
        m0, s0 = pipe.published, stored_guids(store, sids)
        t0 = time.perf_counter()
        res = await ask({"cmd": "publish", "plans": plans}, 900)
        await routed(m0, n_msgs)
        send_s = time.perf_counter() - t0
        share = stamps.close()
        check(all(rc == [0] * len(plans[c])
                  for c, rc in res["pubacks"].items()),
              "durable: a QoS 1 publish was not acked 0")
        # markers: per session, what the host oracle trie routes to the
        # session's filters (exact filters by name, wildcards by the trie)
        trie, exact = Trie(), {}
        owners: dict = {}
        for s in sub_specs:
            for f, _ in s["filters"]:
                owners.setdefault(f, set()).add(s["cid"])
                if T.wildcard(f):
                    trie.insert(f)
        want = {c: Counter() for c in sids}
        for c, plan in plans.items():
            j = pub_ids.index(c)
            for k, (t, _q, _p) in enumerate(plan):
                for f in {t, *trie.match(t)} & owners.keys():
                    for sid in owners[f]:
                        want[sid][(t, j, k)] = 1
        markers = 0
        for c in sids:
            got = Counter()
            for topic, payload in stored_markers(store, c):
                j, k = _ids(payload.decode())
                check(any(T.match(topic, f) for f in owners
                          if c in owners[f]),
                      f"durable: {c}'s marker of {topic!r} matches none of "
                      f"its filters")
                got[(topic, j, k)] += 1
            check(got == want[c], f"durable: {c} has {sum(got.values())} "
                  f"markers, the host oracle routes "
                  f"{sum(want[c].values())} of the messages to it")
            markers += len(got)
        check(markers > 0, "durable: no marker stored")
        stored = len(stored_guids(store, sids) - s0)
        # the subscribers resume (clean_start = false): the takeover of
        # their disconnected sessions, whose routes stayed on the card
        p1 = model.patch_count
        r = await connect([spec(c, clean=False, expiry=3600) for c in sids],
                          "durable resume")
        check(all(r[c]["rc"] == 0 and r[c]["present"] for c in sids),
              "durable: a resume found no session")
        res = await ask({"cmd": "wait", "expect": {
            c: sum(want[c].values()) for c in sids}, "timeout_s": 300}, 900)
        check(not res["short"], f"durable: {len(res['short'])} resumed "
              f"subscribers short of their pending messages")
        resume_ms = []
        for c in sids:
            got = res["received"][c]
            _stream_checks(f"durable resume {c}", got, want[c])
            if got:
                resume_ms.append((got[-1][0] - r[c]["t0_ns"]) / 1e6)
        await _until(lambda: not any(stored_markers(store, c)
                                     for c in sids),
                     "the resumed markers' PUBACKs")
        out["persistent"] = {
            "card": card, "leg": "persistent", "subscribers": subs,
            "publishers": pubs, "messages": n_msgs,
            "markers_stored": markers, "messages_stored": stored,
            "send_s": send_s,
            "subscribe_patches": p1 - p0,
            "resume_patches": model.patch_count - p1,
            "resume_ms": pct(resume_ms), "persist": share}
        log("durable: " + json.dumps(out["persistent"]))
        # -- 2. the exhook --------------------------------------------------
        provider.rewrite_to = make_topics(wire, rng, 1,
                                          sv["n_vehicles"])[0]
        topics = net_topics(sv, wire, rng, n_exhook)
        marks = [("", "drop:", "rw:")[i % 3] for i in range(n_exhook)]
        plans = {c: [[t, 0, f"{marks[i]}{j}:{k}:{{t}}"] for k, (i, t) in
                     enumerate(list(enumerate(topics))[j::pubs])]
                 for j, c in enumerate(pub_ids)}
        host = [Message(topic=t, payload=p.replace("{t}", "0").encode(),
                        from_=c) for c, plan in plans.items()
                for t, _q, p in plan]
        want = _host_routes(broker, host, sids)
        fold_ms, each = [], []
        for m in host:
            t = time.perf_counter()
            v = app.hooks.run_fold("message.publish", (), m)
            fold_ms.append((time.perf_counter() - t) * 1e3)
            each.append(None if v.headers.get("allow_publish") is False
                        else v.topic)
        batch = [None if v is None else v.topic
                 for v in app.exhook.on_message_publish_batch(host)]
        check(batch == each, "durable: the batched exhook verdicts differ "
              "from the per-message ones")
        check(each == [None if m.payload.startswith(b"drop:") else
                       provider.rewrite_to if m.payload.startswith(b"rw:")
                       else m.topic for m in host],
              "durable: the exhook verdicts do not follow the marks")
        calls0, m0 = provider.publishes, pipe.published
        res = await ask({"cmd": "publish", "plans": plans}, 900)
        await routed(m0, n_exhook)
        res = await ask({"cmd": "wait", "expect": {
            c: sum(want[c].values()) for c in sids}, "timeout_s": 300}, 900)
        check(not res["short"], "durable exhook: subscribers short")
        lat = []
        for c in sids:
            lat += [(t - s) / 1e6 for t, s in _stream_checks(
                f"durable exhook {c}", res["received"][c], want[c])]
        calls = provider.publishes - calls0
        check(calls == n_exhook == pipe.published - m0,
              f"durable exhook: {calls} OnMessagePublish calls for "
              f"{pipe.published - m0} messages folded")
        out["exhook"] = {
            "card": card, "leg": "exhook", "messages": n_exhook,
            "dropped": each.count(None),
            "rewritten": marks.count("rw:"), "provider_calls": calls,
            "deliveries": len(lat), "fold_ms_per_message": pct(fold_ms),
            "delivery_ms": pct(lat) if lat else None}
        log("durable: " + json.dumps(out["exhook"]))
        # -- 3. DB-backed access ---------------------------------------------
        await olp_settled(app, "durable access")
        r = (await ask({"cmd": "connect", "chunk": 1, "clients": [
            spec(f"dc{i}") for i in range(connects)]}, 900))["connected"]
        conn_ms = [r[c]["ms"] for c in r if r[c]["rc"] == 0]
        check(len(conn_ms) == connects, "durable: a MySQL user was refused")
        await ask({"cmd": "disconnect", "cids": list(r)}, 300)
        r = (await ask({"cmd": "connect", "clients": [
            dict(spec("dx"), password="wrong"),
            dict(spec("nobody"), password="x")]}, 300))["connected"]
        rcs = {"right_password": 0, "wrong_password": r["dx"]["rc"],
               "unknown_user": r["nobody"]["rc"]}
        # the reference's answers on a SQL backend (the port's tests hold
        # its authn on MySQL to them): a wrong password 0x86; a user with
        # no row, whom every provider ignores, the chain's 0x87
        check(rcs == {"right_password": 0,
                      "wrong_password": P.RC_BAD_USER_NAME_OR_PASSWORD,
                      "unknown_user": P.RC_NOT_AUTHORIZED},
              f"durable: CONNACK codes through MySQL {rcs}")
        r = (await ask({"cmd": "connect", "clients": [spec("dx")]}, 300)
             )["connected"]
        check(r["dx"]["rc"] == 0, "durable: dx refused")
        l1, m1 = model.launch_count, pipe.published
        res = await ask({"cmd": "publish", "plans": {"dx": [[
            DUR_SECRET.replace("#", "x"), 1, "dx:0:{t}"]]}}, 300)
        await asyncio.sleep(0.2)
        check(res["pubacks"]["dx"] == [P.RC_NOT_AUTHORIZED]
              and model.launch_count == l1 and pipe.published == m1,
              f"durable: a publish MongoDB denies got PUBACK "
              f"{res['pubacks']['dx']}, {model.launch_count - l1} steps")
        out["access"] = {"card": card, "leg": "access",
                         "connects": connects, "connect_ms": pct(conn_ms),
                         "connack": rcs,
                         "denied_puback": res["pubacks"]["dx"][0]}
        log("durable: " + json.dumps(out["access"]))
        # -- 4. a Kafka bridge on a rule co-batched on the step ---------------
        # the rule's filter: a subscriber's, one word made a wildcard, so
        # that it is new to the trie (its attach patches the card) and
        # matches every topic of the subscriber's filter
        known, ws = set(live), wire[0].split("/")
        rule_filter = next(f for f in (
            "/".join(ws[:i] + ["+"] + ws[i + 1:])
            for i in reversed(range(len(ws))) if ws[i] not in "+#")
            if f not in known)
        kafka = servers["kafka"]
        app.bridges.create(
            "kafka", "up", KafkaConnector(port=kafka.port,
                                          compression="snappy"),
            {"kafka_topic": DUR_KAFKA_TOPIC, "key_template": "${clientid}",
             "value_template": "${payload}"},
            batch_size=64, batch_time_s=0.05)
        p1 = model.patch_count
        app.rules.create_rule("to-kafka", f'SELECT * FROM "{rule_filter}"',
                              [{"function": "kafka:up", "args": {}}])
        model.refresh()
        attach_patches = model.patch_count - p1
        check(attach_patches == 1, f"durable: the rule's attach took "
              f"{attach_patches} patches")
        tap = RuleTap(app)
        broker.rules_matched_fn = tap.on_matched
        on_rule = make_topics([wire[0]], rng, n_bridge // 2,
                              sv["n_vehicles"])
        others = [t for t in net_topics(sv, wire[1:], rng, n_bridge)
                  if not T.match(t, rule_filter)][:n_bridge - len(on_rule)]
        plans = {pub_ids[0]: [[t, 0, f"0:{k}:{{t}}"]
                              for k, t in enumerate(on_rule)]}
        for j, c in enumerate(pub_ids[1:], 1):
            plans[c] = [[t, 0, f"{j}:{k}:{{t}}"] for k, t in
                        enumerate(others[j - 1::pubs - 1])]
        o0 = app.ledger.totals().get("kernel_overflow", 0)
        m0, t0 = pipe.published, time.perf_counter()
        await ask({"cmd": "publish", "plans": plans}, 900)
        await routed(m0, n_bridge)
        log_of = kafka.records
        want_log = [(pub_ids[0].encode(), p) for p in (
            f"0:{k}:" for k in range(len(on_rule)))]
        await _until(lambda: sum(map(len, log_of.values())) >= len(on_rule),
                     "the bridge's records in Kafka", 120.0)
        bridge_s = time.perf_counter() - t0
        await asyncio.sleep(0.25)
        ((topic, _part), records), = log_of.items()
        got = [(k, v.decode().rsplit(":", 1)[0] + ":") for k, v in records]
        check(topic == DUR_KAFKA_TOPIC and got == want_log,
              f"durable: Kafka holds {len(records)} records, want "
              f"{len(want_log)} in order")
        host_rows = sum(h for _m, h, _f in tap.calls)
        overflow = app.ledger.totals().get("kernel_overflow", 0) - o0
        check(host_rows == overflow == 0, f"durable bridge: {host_rows} "
              f"rows on the rules' host trie, {overflow} fallback rows")
        broker.rules_matched_fn = tap.inner
        # the leg's deliveries to the subscribers, dropped
        await ask({"cmd": "wait", "expect": {c: 0 for c in sids},
                   "timeout_s": 1}, 120)
        worker = app.bridges.get("kafka:up").worker
        out["bridge"] = {
            "card": card, "leg": "bridge", "rule_filter": rule_filter,
            "messages": n_bridge, "records": len(records),
            "attach_patches": attach_patches, "fallback_rows": overflow,
            "bridge_messages_per_s": len(records) / bridge_s,
            "worker": dict(worker.metrics)}
        log("durable: " + json.dumps(out["bridge"]))
        # -- 5. the management API -------------------------------------------
        mgmt = ManagementApi(app)
        mgmt.start(host="127.0.0.1", port=0)
        ctl = CtlClient(f"http://127.0.0.1:{mgmt.port}")
        get_ms: dict = {}

        def get(path: str):
            t = time.perf_counter()
            body = ctl.request("GET", path)
            get_ms.setdefault(path.split("?")[0], []).append(
                (time.perf_counter() - t) * 1e3)
            return body

        status = await asyncio.to_thread(get, "/api/v5/status")
        check(status.get("status") == "running", f"durable mgmt: {status}")
        await asyncio.sleep(0.1)
        stats = await asyncio.to_thread(get, "/api/v5/kernel/stats")
        fold = json.loads(json.dumps(app.device_metrics.snapshot()))
        stats.pop("ts_ms"), fold.pop("ts_ms")
        check(stats == fold, "durable mgmt: /kernel/stats differs from the "
              "app's kernel fold")
        clients = await asyncio.to_thread(get, "/api/v5/clients?limit=10000")
        by_id = {c["clientid"]: c for c in clients["data"]}
        for c in sids:
            ch = app.cm.lookup_channel(c)
            check(by_id[c]["connected"] == (ch.conn_state == "connected")
                  and by_id[c]["subscriptions_cnt"]
                  == len(ch.session.subscriptions) == 4,
                  f"durable mgmt: /clients on {c}: {by_id[c]}")
        # /subscriptions lists every (client id, filter), sorted, and pages
        # the list: the one page that holds the persistent clients'.  It
        # builds and sorts the 1M suboptions for every page, past
        # CtlClient's 10 s timeout at this size (ROADMAP.md §3 R9), so the
        # page is asked with a longer one
        import urllib.request
        before = sum(1 for sid, _ in broker.suboption if sid < min(sids))
        n_wire, limit = len(wire), 1024
        while before % limit + n_wire > limit:
            limit *= 2
        subs_ms, got_subs = [], {}

        def page_of(k: int) -> dict:
            req = urllib.request.Request(
                f"{ctl.base}/api/v5/subscriptions?page={k}&limit={limit}")
            req.add_header("Authorization", ctl._auth_header())
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as resp:
                body = json.loads(resp.read())
            subs_ms.append((time.perf_counter() - t) * 1e3)
            return body

        for k in (before // limit + 1,):
            for it in (await asyncio.to_thread(page_of, k))["data"]:
                if it["clientid"] in sids:
                    got_subs.setdefault(it["clientid"], set()).add(
                        (it["topic"], it["qos"]))
        for c in sids:
            check(got_subs.get(c) == {(f, broker.suboption[(c, f)].qos)
                                      for f in broker.subscription[c]},
                  f"durable mgmt: /subscriptions of {c}")
        target = sub_specs[0]
        t_pub = make_topics([target["filters"][0][0]], rng, 1,
                            sv["n_vehicles"])[0]
        l1 = model.launch_count
        want = Counter({c: len(items) for c, items in broker.publish(
            Message(topic=t_pub, payload=b"")).items() if c in sids})
        body = await asyncio.to_thread(
            ctl.request, "POST", "/api/v5/publish",
            {"topic": t_pub, "payload": "mgmt:0:0", "qos": 1})
        res = await ask({"cmd": "wait", "expect": dict(want),
                         "timeout_s": 60}, 120)
        check(not res["short"] and all(
            [(t, p) for _n, t, p, _q in res["received"][c]]
            == [(t_pub, "mgmt:0:0")] * n for c, n in want.items()),
            f"durable mgmt: /publish reached "
            f"{ {c: res['received'][c][-3:] for c in want} }")
        for _ in range(16):
            await asyncio.to_thread(get, "/api/v5/status")
            await asyncio.to_thread(get, "/api/v5/kernel/stats")
        out["mgmt"] = {"card": card, "leg": "mgmt",
                       "get_ms": pct([t for ts in get_ms.values()
                                      for t in ts]),
                       "gets": sum(map(len, get_ms.values())),
                       "subscriptions_page_ms": pct(subs_ms),
                       "publish_id": body["id"],
                       "publish_deliveries": sum(want.values()),
                       "publish_steps": model.launch_count - l1,
                       "kernel_batches": stats["summary"]["batches"]}
        log("durable: " + json.dumps(out["mgmt"]))
        await pool.close()
    finally:
        await pool.kill()
        if mgmt is not None:
            mgmt.stop()
        await app.listeners.stop_all()
        logging.getLogger("emqx_tpu_torch.pipeline").removeHandler(errors)
    steps, batches = model.launch_count - l0, pipe.batches - b0
    check(pipe.host_batches == h0 and model.host_match_count == 0,
          "durable: a batch was served on the host")
    check(steps == batches, f"durable: {steps} steps for {batches} device "
          f"batches")
    check(app.metrics.val("messages.device_failover") == 0,
          "durable: a device failover")
    check(not errors.records, f"durable: the pipeline logged "
          f"{errors.records[:3]}")
    out.update(device_batches=batches, steps_per_batch=steps / batches,
               provider_connected=provider.connected)
    return out


def free_heap() -> None:
    """Free what the finished phases left: the heap their set-ups froze
    against GC pauses is collected, what lives on frozen again (the next
    set-up's collections then skip the earlier phases' tables), and the
    card's cached blocks released."""
    import torch
    t = time.perf_counter()
    gc.unfreeze()
    freed = gc.collect()
    gc.freeze()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    log(f"free heap: {freed} objects in {time.perf_counter() - t:.2f} s")


def durable_phase(seed: int, device, card: str, n_filters: int = N_FILTERS,
                  sessions: int = SESSIONS, subs: int = DUR_SUBS,
                  pubs: int = DUR_PUBS, n_msgs: int = DUR_MESSAGES,
                  n_exhook: int = DUR_EXHOOK, connects: int = DUR_CONNECTS,
                  n_bridge: int = DUR_BRIDGE, gateway: dict = GATEWAY,
                  cluster: dict = CLUSTER) -> dict:
    """The durable and integrations path: :func:`durable_conf` booted by
    ``BrokerApp.from_config`` (:func:`boot_durable`) with its servers
    (:func:`durable_servers`), the serving leg's 1M filters subscribed
    through its broker by ``sessions`` session ids; then, clients in the
    child process's pool, over the app's TCP listener:

    1. persistent sessions — ``subs`` v5 subscribers (``clean_start =
       false``, session expiry 3600 s) SUBSCRIBE at QoS 1 to 4 filters of
       the tree each and disconnect; ``pubs`` publishers send ``n_msgs``
       QoS 1 messages, half on those filters, through the pipeline to the
       step: each session's stored markers are what the host oracle trie
       routes to its filters; the subscribers resume (the takeover of
       their disconnected sessions, whose routes stayed on the card) and
       each gets exactly its pending messages, each publisher's order
       kept, and no marker is left after their PUBACKs; the share of
       ``persist_message`` in the broker's batch calls;
    2. exhook — ``n_exhook`` QoS 0 messages, a third marked for the
       provider to drop and a third to move to a topic of the tree: the
       subscribers get what the host path (``Broker.publish`` under the
       same hook chain) routes, the provider folded each message once, and
       ``ExhookMgr.on_message_publish_batch`` gives the per-message
       verdicts;
    3. DB-backed access — ``connects`` CONNECTs timed through MySQL; a
       wrong password (0x86), a wrong user's password and an unknown user
       (0x87, both: the chain's answer when MySQL has no such row);
       a QoS 1 publish on DUR_SECRET, which MongoDB denies: PUBACK 0x87
       and no step;
    4. bridge — a rule ``SELECT * FROM`` one live filter with a Kafka
       bridge action (snappy on) co-batched on the step (one patch at
       attach); ``n_bridge`` QoS 0 messages, half on the rule's filter
       from one publisher: those land in ``MiniKafka``'s log, exactly and
       in order, with 0 fallback rows;
    5. management — the port's ``ManagementApi`` on 127.0.0.1 through
       ``CtlClient``: ``/status``, ``/kernel/stats`` equal to the app's
       kernel fold, ``/clients`` and ``/subscriptions`` equal to the CM
       and the broker for the persistent clients, ``/publish`` delivering
       one message (the host path, as the reference's);

    one step a device batch, no failover, no host batch, no ERROR record
    on the pipeline's logger (``durable`` path).  Then, on the same app:

    6. gateways (``gateway`` path, :func:`gateway_leg`) — STOMP (TCP),
       MQTT-SN, CoAP and LwM2M (UDP) and ExProto (TCP, its framed
       ``HandlerServer`` running a line protocol) loaded through
       ``app.gateway.load`` on 127.0.0.1, each client a row of MySQL (by
       client id; MQTT-SN and LwM2M carry no password) and of MongoDB's
       ACL: STOMP clients on 4 filters each (2 of them new wildcards),
       MQTT-SN clients REGISTER an uplink topic and SUBSCRIBE to 4, CoAP
       observers on 2, LwM2M endpoints registered (their downlink filter),
       ExProto connections on 2; the new filters reach the card in patch
       launches (their refresh timed); MQTT v5 publishers send QoS 0 and
       QoS 1 messages, half on the gateway clients' filters, through the
       pipeline to the step: every client's deliveries equal, as a
       multiset, what the host path routes to its subscriptions, each
       publisher's order kept per QoS; uplinks (STOMP SENDs, MQTT-SN QoS 1
       PUBLISHes, CoAP POSTs, a LwM2M update and notify) reach MQTT v5
       subscribers as the host path routes them, by the reference's host
       path (``GwContext.publish``, no step); ``CtlClient`` lists the
       gateways and STOMP's clients as the manager does, a ``DELETE``
       kicks one (its socket drops), ``emqx_ctl gateway list``;
    7. cluster (``cluster`` path, :func:`cluster_leg`) — the app as
       ``ClusterNode("n1")`` and a second app booted from its own config
       (:func:`n2_conf`, the step on the card) as ``ClusterNode("n2")``,
       over ``TcpTransport``: n2 joins and bootstraps every route of n1
       (seconds and RSS); n2's MQTT v5 subscribers on 4 filters each (2 of
       them new wildcards), their route deltas flushed to n1; n1's
       publishers send QoS 0 and QoS 1 messages (n1's step, forwarded to
       n2), n2's send QoS 0 messages on filters both nodes hold (n2's
       step, forwarded to n1): n2's subscribers and a sample of n1's
       sessions (stamped recording channels) get what the host oracle of
       the cluster's routes sends them; n1's persistent clients resume on
       n2 through ``cm.takeover``, each with its pending messages once, in
       order; ``PUT /configs`` on n1's ``ManagementApi`` commits a cluster
       transaction both nodes apply, ``/cluster_rpc`` the same tnx id on
       both; n2's transport closes, ``heartbeat_misses + 1`` ticks of n1
       purge its routes, and n1 keeps routing; one step a device batch,
       no failover, no host batch on either node.

    Each path's launch counts are set to 0 just before it and read just
    after it (``counts``)."""
    from emqx_tpu_torch.ops import _build
    t_start = time.time()
    gw_users, blank = gateway_users(gateway)
    users = (durable_users(subs, pubs, connects) + gw_users
             + cluster_users(cluster)[0])
    limit, limits = fd_limit(2 * len(users) + 512)
    check(2 * len(users) + 512 <= limit,
          f"durable: an open-file limit of {limit}")
    servers = durable_servers(users, blank)
    sv = None
    try:
        sv = serving_load(n_filters, seed, device, None, sessions,
                          recorded=0, boot_fn=functools.partial(
                              boot_durable, device, servers, users))
        olp = sv["app"].olp
        log("durable olp: " + json.dumps(
            {"lag_ms": olp.lag_ms, "overloaded": olp.is_overloaded()}))
        check(not olp.is_overloaded(), "durable: the overload protection "
              "refuses new connections")
        out = asyncio.run(_durable_run(sv, card, servers, subs, pubs,
                                       n_msgs, n_exhook, connects,
                                       n_bridge))
        sv["listeners_down_at"] = time.monotonic()
        out.update(boot=sv["boot"], limits=limits,
                   seconds=time.time() - t_start)
        log("durable phase: " + json.dumps(
            {k: out[k] for k in ("card", "boot", "device_batches",
                                 "steps_per_batch", "seconds")}))
        counts = {"durable": path_counts("durable")}
        secs = {"durable": time.time() - t_start}
        t = time.time()
        _build.reset_launch_counts()
        out["gateway"] = gateway_leg(sv, card, gateway)
        counts["gateway"] = path_counts("gateway")
        secs["gateway"] = time.time() - t
        t = time.time()
        _build.reset_launch_counts()
        out["cluster"] = cluster_leg(sv, device, card, cluster)
        counts["cluster"] = path_counts("cluster")
        secs["cluster"] = time.time() - t
        out["counts"], out["path_seconds"] = counts, secs
        return out
    finally:
        for name in ("mysql", "mongo", "kafka", "exhook"):
            servers[name].stop()
        if sv is not None:
            import shutil
            sv["app"].bridges.stop_all()
            shutil.rmtree(sv["data_dir"], ignore_errors=True)
            sv["model"].telemetry = sv["fold"].model = None


class ClientPool:
    """The network phase's child process (``python3 chip_smoke.py
    --network-clients``) driven one JSON command a line: a client pool
    (:func:`_client_pool`), or given a deployment ``spec``, that fleet of
    subscribers and publishers (:func:`_network_clients`)."""

    def __init__(self, what: str) -> None:
        self.what, self.proc = what, None

    async def start(self, spec: dict | None = None) -> dict:
        import os
        self.proc = await asyncio.create_subprocess_exec(
            sys.executable, os.path.abspath(__file__), "--network-clients",
            stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE,
            limit=1 << 30)
        ready = await self.ask(spec or {"pool": True}, 600)
        check(ready.get("ready") is True,
              f"{self.what}: the clients did not start")
        return ready

    async def ask(self, obj, timeout: float):
        self.proc.stdin.write((json.dumps(obj) + "\n").encode())
        await self.proc.stdin.drain()
        line = await asyncio.wait_for(self.proc.stdout.readline(), timeout)
        check(bool(line), f"{self.what}: the clients' process ended early")
        return json.loads(line)

    async def close(self) -> None:
        closed = await self.ask({"cmd": "close"}, 300)
        check(closed.get("closed") is True, f"the clients answered {closed}")
        await asyncio.wait_for(self.proc.wait(), 60)
        check(self.proc.returncode == 0,
              f"the clients' process exited {self.proc.returncode}")

    async def kill(self) -> None:
        if self.proc is not None and self.proc.returncode is None:
            self.proc.kill()
            await self.proc.wait()


def idle_olp(app, down_at: float, what: str) -> dict:
    """Feed the overload protection the zero-lag ticks a running listener
    would have taken on the idle loop since ``down_at`` (its lag average
    stands still while no listener runs, ``ROADMAP.md`` R7)."""
    from emqx_tpu_torch.broker.server import HOUSEKEEP_INTERVAL
    olp = {"lag_ms_before": app.olp.lag_ms,
           "overloaded_before": app.olp.is_overloaded()}
    idle_ticks = int((time.monotonic() - down_at) // HOUSEKEEP_INTERVAL)
    for _ in range(idle_ticks):
        app.olp.note_lag(0.0)
    olp.update(idle_ticks=idle_ticks, lag_ms=app.olp.lag_ms)
    log(f"{what} olp: " + json.dumps(olp))
    return olp


async def olp_settled(app, what: str) -> float:
    """Wait, the app's listeners up, until the overload protection admits
    new connections: the lag average a leg's stalls of the loop left
    (the checks' host-path walks run on it) decays on the listeners' own
    housekeeping ticks (R7); overloaded, the app closes a new connection
    at accept, with no CONNACK.  Returns the seconds waited."""
    t, lag = time.perf_counter(), app.olp.lag_ms
    await _until(lambda: not app.olp.is_overloaded(), f"{what}: the "
                 f"overload protection's lag average to decay "
                 f"({lag:.1f} ms)", 120.0)
    waited = time.perf_counter() - t
    if waited > 0.01:
        log(f"{what} olp: a lag average of {lag:.1f} ms refused new "
            f"connections for {waited:.2f} s")
    return waited


def sub_lists(sv: dict, rng, n: int, exact: int, wild: int) -> list:
    """``n`` filter lists over the subscribed tree, no filter twice in a
    list: ``exact`` live filters, then ``wild`` new wildcards (a live
    filter with its last plain word below the root made ``+``, where no
    session of the broker holds that filter yet: its subscription patches
    the card)."""
    live, held = sv["live"], sv["broker"].subscriber
    out = []
    for _ in range(n):
        fs: list[str] = []
        while len(fs) < exact + wild:
            f = live[int(rng.integers(len(live)))]
            if len(fs) >= exact:
                ws = f.split("/")
                f = next((g for g in ("/".join(ws[:i] + ["+"] + ws[i + 1:])
                                      for i in reversed(range(1, len(ws)))
                                      if ws[i] not in ("+", "#"))
                          if g not in held), None)
            if f is not None and f not in fs:
                fs.append(f)
        out.append(fs)
    return out


def publisher_plans(pubs: list, qos0: list, qos1: list,
                    first: int = 0) -> dict:
    """Per publisher (the ``j``-th from ``first``), its share of the
    ``qos0`` topics at QoS 0 and then of the ``qos1`` topics at QoS 1, as
    the client pool's ``[topic, qos, "j:k:{t}"]``."""
    n = len(pubs)
    return {c: [[t, q, f"{j}:{k}:{{t}}"] for k, (t, q) in enumerate(
        [(t, 0) for t in qos0[i::n]] + [(t, 1) for t in qos1[i::n]])]
        for i, (j, c) in enumerate(enumerate(pubs, first))}


def qos_of(plans: dict, first: int = 0) -> dict:
    """(publisher, sequence) -> QoS of :func:`publisher_plans`' messages."""
    return {(j, k): q for j, plan in enumerate(plans.values(), first)
            for k, (_t, q, _p) in enumerate(plan)}


def acked(res: dict, plans: dict) -> bool:
    """Every QoS 1 publish of ``plans`` got PUBACK 0."""
    return all(rcs == [0] * sum(1 for _t, q, _p in plans[c] if q)
               for c, rcs in res["pubacks"].items())


def order_kept(what: str, got: list, qos: dict, key=lambda x: None) -> None:
    """Each publisher's messages in ``got`` (``(arrival ns, topic,
    payload, ...)``) in the order it sent them, per QoS and per ``key``
    of a delivery: a message that two filters of a subscriber match
    comes twice, in a row."""
    last: dict = {}
    for x in got:
        j, k = _ids(x[2])
        lane = (j, qos[(j, k)], key(x))
        check(last.get(lane, -1) <= k, f"{what}: publisher {j}'s message "
              f"{k} after {last.get(lane)}")
        last[lane] = k


def counter_check(what: str, got, want) -> None:
    check(got == want, f"{what}: got {sum(got.values())}, the host path "
          f"routes {sum(want.values())}: missing "
          f"{list((want - got).items())[:3]}, extra "
          f"{list((got - want).items())[:3]}")


# ---------------------------------------------------------------------------
# the gateway path: five protocol gateways loaded into the durable app
# ---------------------------------------------------------------------------


class _Datagrams(asyncio.DatagramProtocol):
    def __init__(self, on_data) -> None:
        self.on_data = on_data

    def datagram_received(self, data, addr) -> None:
        self.on_data(data)


class GwDevice:
    """One gateway client of the smoke, on the port's own codec: what it
    is delivered, ``(arrival ns, topic, payload, subscription key)``, and
    a queue of every other frame it receives."""

    kind = "?"

    def __init__(self, cid: str) -> None:
        self.cid, self.got, self.closed = cid, [], False
        self.ctl: asyncio.Queue = asyncio.Queue()
        self.connect_ms = 0.0

    async def reply(self, timeout: float = 60.0):
        return await asyncio.wait_for(self.ctl.get(), timeout)

    async def udp(self, port: int) -> None:
        self.tr, _ = await asyncio.get_running_loop(
        ).create_datagram_endpoint(lambda: _Datagrams(self._on),
                                   remote_addr=("127.0.0.1", port))


class StompDevice(GwDevice):
    kind = "stomp"

    async def open(self, port: int, filters: list) -> None:
        from emqx_tpu_torch.gateway import stomp as ST
        self.ST, self.f, self.state = ST, ST.Frame(), b""
        self.r, self.w = await asyncio.open_connection("127.0.0.1", port)
        self._reader = asyncio.create_task(self._read())
        t0 = time.perf_counter()
        self.send("CONNECT", {"accept-version": "1.2", "client-id": self.cid,
                              "login": self.cid,
                              "passcode": password(self.cid)})
        rep = await self.reply()
        check(rep.command == "CONNECTED", f"gateway stomp {self.cid}: "
              f"{rep.command} {rep.headers}")
        self.connect_ms = (time.perf_counter() - t0) * 1e3
        for k, f in enumerate(filters):
            self.send("SUBSCRIBE", {"id": str(k), "destination": f,
                                    "receipt": f"s{k}"})
            rep = await self.reply()
            check(rep.command == "RECEIPT", f"gateway stomp {self.cid} "
                  f"SUBSCRIBE {f}: {rep.command}")

    def send(self, cmd: str, headers: dict, body: bytes = b"") -> None:
        self.w.write(self.f.serialize(self.ST.StompFrame(cmd, headers, body)))

    async def uplink(self, topic: str, payload: str) -> None:
        self.send("SEND", {"destination": topic, "receipt": "u"},
                  payload.encode())
        rep = await self.reply()
        check(rep.command == "RECEIPT", f"gateway stomp {self.cid} SEND: "
              f"{rep.command}")

    async def _read(self) -> None:
        while True:
            try:
                data = await self.r.read(65536)
            except ConnectionError:
                data = b""
            if not data:
                self.closed = True
                return
            now = time.monotonic_ns()
            pkts, self.state = self.f.parse(data, self.state)
            for p in pkts:
                if p.command == "MESSAGE":
                    self.got.append((now, p.headers["destination"],
                                     p.body.decode(),
                                     p.headers["subscription"]))
                else:
                    self.ctl.put_nowait(p)

    def close(self) -> None:
        self._reader.cancel()
        self.w.close()


class SnDevice(GwDevice):
    """An MQTT-SN client: it REGISTERs its uplink topic and SUBSCRIBEs by
    topic name; a delivery's topic is the one its id was registered
    for."""

    kind = "mqttsn"

    async def open(self, port: int, filters: list, uplink: str) -> None:
        from emqx_tpu_torch.gateway import mqttsn as SN
        self.SN, self.f, self.names, self.mid = SN, SN.Frame(), {}, 0
        await self.udp(port)
        t0 = time.perf_counter()
        self.send(SN.SnMessage(SN.CONNECT, flags=SN.F_CLEAN, duration=600,
                               clientid=self.cid))
        rep = await self.reply()
        check(rep.type == SN.CONNACK and rep.rc == SN.RC_ACCEPTED,
              f"gateway mqttsn {self.cid}: CONNACK {rep.rc}")
        self.connect_ms = (time.perf_counter() - t0) * 1e3
        self.send(SN.SnMessage(SN.REGISTER, msg_id=self._mid(),
                               topic_name=uplink))
        rep = await self.reply()
        check(rep.type == SN.REGACK and rep.rc == SN.RC_ACCEPTED,
              f"gateway mqttsn {self.cid}: REGACK {rep.rc}")
        self.up_tid = rep.topic_id
        for f in filters:
            self.send(SN.SnMessage(SN.SUBSCRIBE, flags=SN.qos_flags(0),
                                   msg_id=self._mid(), topic_name=f))
            rep = await self.reply()
            check(rep.type == SN.SUBACK and rep.rc == SN.RC_ACCEPTED,
                  f"gateway mqttsn {self.cid} SUBSCRIBE {f}: {rep.rc}")
            if rep.topic_id:
                self.names[rep.topic_id] = f

    def _mid(self) -> int:
        self.mid += 1
        return self.mid

    def send(self, m) -> None:
        self.tr.sendto(self.f.serialize(m))

    async def uplink(self, topic: str, payload: str) -> None:
        SN = self.SN
        self.send(SN.SnMessage(SN.PUBLISH, flags=SN.qos_flags(1),
                               topic_id=self.up_tid, msg_id=self._mid(),
                               data=payload.encode()))
        rep = await self.reply()
        check(rep.type == SN.PUBACK and rep.rc == SN.RC_ACCEPTED,
              f"gateway mqttsn {self.cid} PUBLISH: {rep.type} {rep.rc}")

    def _on(self, data: bytes) -> None:
        SN, now = self.SN, time.monotonic_ns()
        for m in self.f.parse(data, None)[0]:
            if m.type == SN.REGISTER:
                self.names[m.topic_id] = m.topic_name
            elif m.type == SN.PUBLISH:
                self.got.append((now, self.names.get(m.topic_id),
                                 m.data.decode(), None))
            else:
                self.ctl.put_nowait(m)

    def close(self) -> None:
        self.tr.close()


class CoapDevice(GwDevice):
    """A CoAP observer: a notification carries no topic (a delivery's topic
    is None) and the token of the first observation that matches it, not
    of the filter it was routed by (a delivery's key is None); a CON
    notification is ACKed."""

    kind = "coap"

    async def open(self, port: int, filters: list) -> None:
        from emqx_tpu_torch.gateway import coap as C
        self.C, self.f, self.mid = C, C.Frame(), 0
        await self.udp(port)
        t0 = time.perf_counter()
        for k, f in enumerate(filters):
            rep = await self.request(C.GET, f"ps/{f}", token=b"o%d" % k,
                                     options=[(C.OPT_OBSERVE, b"")])
            check(rep.code == C.CONTENT, f"gateway coap {self.cid} observe "
                  f"{f}: 0x{rep.code:02x}")
            if not k:
                self.connect_ms = (time.perf_counter() - t0) * 1e3

    async def request(self, code: int, path: str, payload: bytes = b"",
                      token: bytes = b"", options=(), queries=None):
        C = self.C
        self.mid = self.mid % 0xFFFF + 1
        opts = list(options) + C.uri_path_opts(path)
        for q in (queries if queries is not None else [
                f"clientid={self.cid}", f"username={self.cid}",
                f"password={password(self.cid)}"]):
            opts.append((C.OPT_URI_QUERY, q.encode()))
        self.tr.sendto(self.f.serialize(C.CoapMessage(
            C.CON, code, self.mid, token, opts, payload)))
        return await self.reply()

    async def uplink(self, topic: str, payload: str) -> None:
        rep = await self.request(self.C.POST, f"ps/{topic}", payload.encode())
        check(rep.code == self.C.CHANGED, f"gateway coap {self.cid} POST: "
              f"0x{rep.code:02x}")

    def ack(self, m) -> None:
        self.tr.sendto(self.f.serialize(self.C.CoapMessage(
            self.C.ACK, self.C.EMPTY, m.mid, b"")))

    def _on(self, data: bytes) -> None:
        C, now = self.C, time.monotonic_ns()
        for m in self.f.parse(data, None)[0]:
            if m.type == C.ACK:
                self.ctl.put_nowait(m)
            elif m.code == C.CONTENT and m.opt(C.OPT_OBSERVE) is not None:
                self.got.append((now, None, m.payload.decode(), None))
                if m.type == C.CON:
                    self.ack(m)
            elif m.type == C.CON and m.code == C.POST:
                # a LwM2M downlink command: lwm2m/<ep>/dn/... as POST
                # dn/...; a retransmission (its ACK was late) is ACKed
                # again and not delivered twice (RFC 7252 §4.5)
                self.ack(m)
                if m.mid not in self.seen:
                    self.seen.add(m.mid)
                    self.got.append((now, f"lwm2m/{self.ep}/" + "/".join(
                        m.uri_path()), m.payload.decode(), None))
            else:
                self.ctl.put_nowait(m)

    def close(self) -> None:
        self.tr.close()


class Lwm2mDevice(CoapDevice):
    """A LwM2M endpoint: it registers (the gateway subscribes it to its
    downlink filter), takes each downlink command (a CON POST to
    ``dn/...``) with an empty ACK, and sends an update and a notify."""

    kind = "lwm2m"

    async def open(self, port: int, ep: str) -> None:
        from emqx_tpu_torch.gateway import coap as C
        self.C, self.f, self.mid, self.ep = C, C.Frame(), 0, ep
        self.seen: set = set()
        await self.udp(port)
        t0 = time.perf_counter()
        rep = await self.request(C.POST, "rd", b"</1/0>,</3/0>", queries=[
            f"ep={ep}", "lt=3600", "lwm2m=1.0"])
        check(rep.code == C.CREATED, f"gateway lwm2m {ep}: register "
              f"0x{rep.code:02x}")
        self.connect_ms = (time.perf_counter() - t0) * 1e3
        self.reg = "/".join(v.decode() for v in rep.opts(C.OPT_LOCATION_PATH))

    async def uplinks(self) -> None:
        C = self.C
        for path, body, q in ((self.reg, b"", ["lt=7200"]),
                              (self.reg + "/notify", b"21.5", [])):
            rep = await self.request(C.POST, path, body, queries=q)
            check(rep.code == C.CHANGED, f"gateway lwm2m {self.ep}: POST "
                  f"{path} 0x{rep.code:02x}")


def line_protocol():
    """The ExProto path's external protocol, served by the port's
    ``HandlerServer``: lines ``AUTH <client id> <password>`` and ``SUB
    <filter>`` (each answered ``OK``), and each delivery sent back as
    ``MSG <topic> <payload>``."""
    import threading

    from emqx_tpu_torch.gateway.exproto import ConnectionHandler

    class Lines(ConnectionHandler):
        def __init__(self) -> None:
            self.buf: dict = {}
            self._lock = threading.Lock()

        def on_received_bytes(self, args):
            with self._lock:
                data = self.buf.pop(args["conn"], b"") + bytes.fromhex(
                    args["bytes_hex"])
                *lines, self.buf[args["conn"]] = data.split(b"\n")
            out = []
            for line in lines:
                verb, *rest = line.decode().split(" ")
                if verb == "AUTH":
                    out.append({"type": "authenticate", "clientid": rest[0],
                                "username": rest[0], "password": rest[1]})
                elif verb == "SUB":
                    out.append({"type": "subscribe", "topic": rest[0],
                                "qos": 0})
                out.append({"type": "send", "bytes_hex": b"OK\n".hex()})
            return out

        def on_received_messages(self, args):
            return [{"type": "send", "bytes_hex": (
                f"MSG {m['topic']} ".encode()
                + bytes.fromhex(m["payload_hex"]) + b"\n").hex()}
                for m in args["messages"]]

        def on_socket_closed(self, args):
            with self._lock:
                self.buf.pop(args["conn"], None)
            return []

    return Lines()


class ExprotoDevice(GwDevice):
    kind = "exproto"

    async def open(self, port: int, filters: list) -> None:
        self.r, self.w = await asyncio.open_connection("127.0.0.1", port)
        self._reader = asyncio.create_task(self._read())
        t0 = time.perf_counter()
        self.w.write(f"AUTH {self.cid} {password(self.cid)}\n".encode())
        check(await self.reply() == "OK", f"gateway exproto {self.cid}: AUTH")
        self.connect_ms = (time.perf_counter() - t0) * 1e3
        for f in filters:
            self.w.write(f"SUB {f}\n".encode())
            check(await self.reply() == "OK",
                  f"gateway exproto {self.cid}: SUB {f}")

    async def _read(self) -> None:
        while True:
            try:
                line = await self.r.readline()
            except ConnectionError:
                line = b""
            if not line:
                self.closed = True
                return
            now = time.monotonic_ns()
            words = line.decode().rstrip("\n").split(" ", 2)
            if words[0] == "MSG":
                self.got.append((now, words[1], words[2], None))
            else:
                self.ctl.put_nowait(words[0])

    def close(self) -> None:
        self._reader.cancel()
        self.w.close()


def gateway_users(n: dict = GATEWAY) -> tuple[list, list]:
    """The gateway path's client ids, each a user of the durable app's
    MySQL table, and those of them whose protocol carries no password
    (MQTT-SN and LwM2M authenticate by client id alone: their rows hold an
    empty one)."""
    blank = [f"gsn{i}" for i in range(n["sn"])] + [
        f"lwm2m-gep{i}" for i in range(n["lwm2m"])]
    return ([f"gst{i}" for i in range(n["stomp"])]
            + [f"gco{i}" for i in range(n["coap"])]
            + [f"gex{i}" for i in range(n["exproto"])]
            + [f"gp{j}" for j in range(n["pubs"])]
            + [f"gu{s}" for s in range(n["up_subs"])] + blank), blank


def gateway_leg(sv: dict, card: str, n: dict = GATEWAY) -> dict:
    """The gateway path over the durable app; see :func:`durable_phase`."""
    t_start = time.time()
    olp = idle_olp(sv["app"], sv["listeners_down_at"], "gateway")
    try:
        out = asyncio.run(_gateway_run(sv, card, n))
    finally:
        sv["listeners_down_at"] = time.monotonic()
    out.update(olp=olp, seconds=time.time() - t_start)
    log("gateway path: " + json.dumps(
        {k: out[k] for k in ("card", "olp_wait_s", "subscriptions",
                             "downlink", "uplink", "mgmt", "device_batches",
                             "steps_per_batch", "seconds")}))
    return out


async def _gateway_run(sv: dict, card: str, n: dict) -> dict:
    """The gateway path's legs over the durable app, the gateway clients
    in the smoke's own loop and the MQTT clients in the child process's
    pool."""
    from collections import Counter
    from contextlib import redirect_stdout
    from io import StringIO

    from emqx_tpu_torch.core.message import Message
    from emqx_tpu_torch.gateway.coap import CoapGateway
    from emqx_tpu_torch.gateway.exproto import ExprotoGateway, HandlerServer
    from emqx_tpu_torch.gateway.lwm2m import Lwm2mGateway
    from emqx_tpu_torch.gateway.mqttsn import MqttsnGateway
    from emqx_tpu_torch.gateway.stomp import StompGateway
    from emqx_tpu_torch.mgmt import cli
    from emqx_tpu_torch.mgmt.api import ManagementApi
    from emqx_tpu_torch.mgmt.cli import CtlClient
    app, model, pipe, broker = sv["app"], sv["model"], sv["pipe"], sv["broker"]
    rng = np.random.default_rng(sv["sessions"] + 31)
    errors = ErrorRecords()
    logging.getLogger("emqx_tpu_torch.pipeline").addHandler(errors)
    handler = HandlerServer(line_protocol())
    handler.start()
    gws = {"stomp": StompGateway(port=0), "mqttsn": MqttsnGateway(port=0),
           "coap": CoapGateway(port=0), "lwm2m": Lwm2mGateway(port=0),
           "exproto": ExprotoGateway(handler_port=handler.port, port=0)}
    pool, mgmt, devs = ClientPool("gateway"), None, []
    out: dict = {"card": card}
    b0, l0, h0 = pipe.batches, model.launch_count, pipe.host_batches
    try:
        for gw in gws.values():
            app.gateway.load(gw)
            await gw.start_listeners()
        await app.listeners.start_all(sv["conf"].get("listeners"))
        port = app.listeners.find("tcp:default").port
        await pool.start()
        # -- the gateway clients; their new filters reach the card -----------
        up = n["up_subs"]
        filters, kinds = {}, {k: [] for k in gws}
        for kind, cls, prefix, count, exact, wild in (
                ("stomp", StompDevice, "gst", n["stomp"], 2, 2),
                ("mqttsn", SnDevice, "gsn", n["sn"], 2, 2),
                ("coap", CoapDevice, "gco", n["coap"], 1, 1),
                ("exproto", ExprotoDevice, "gex", n["exproto"], 1, 1)):
            for i, fs in enumerate(sub_lists(sv, rng, count, exact, wild)):
                d = cls(f"{prefix}{i}")
                filters[d.cid] = fs
                kinds[kind].append((d, (gws[kind].port, fs) + (
                    (f"up/mqttsn/g{i % up}",) if kind == "mqttsn" else ())))
        for i in range(n["lwm2m"]):
            d = Lwm2mDevice(f"lwm2m-gep{i}")
            filters[d.cid] = [f"lwm2m/gep{i}/dn/#"]
            kinds["lwm2m"].append((d, (gws["lwm2m"].port, f"gep{i}")))
        new = {f for fs in filters.values() for f in fs
               if f not in broker.subscriber}
        p0 = model.patch_count
        for pairs in kinds.values():
            await asyncio.gather(*(d.open(*a) for d, a in pairs))
            devs += [d for d, _a in pairs]
        for d in devs:
            check(broker.subscription.get(d.cid) == set(filters[d.cid]),
                  f"gateway {d.kind} {d.cid}: the broker holds "
                  f"{broker.subscription.get(d.cid)}")
        t = time.perf_counter()
        model.refresh()
        torch_sync(model.device)
        out["subscriptions"] = {
            "filters": sum(map(len, filters.values())),
            "new_filters": len(new),
            "patches": model.patch_count - p0,
            "refresh_ms": (time.perf_counter() - t) * 1e3}
        log("gateway subscriptions: " + json.dumps(out["subscriptions"]))
        check(out["subscriptions"]["patches"] >= 1,
              "gateway: the new filters reached the card in no patch")
        # -- downlinks: MQTT v5 publishers, the pipeline, the step -----------
        pub_ids = [f"gp{j}" for j in range(n["pubs"])]
        wire = [f for fs in filters.values() for f in fs]
        plans = publisher_plans(pub_ids, net_topics(sv, wire, rng, n["qos0"]),
                                net_topics(sv, wire, rng, n["qos1"]))
        qos = qos_of(plans)
        index = {d.cid: d for d in devs}

        def expect() -> dict:
            """What the host path (``Broker.publish``) routes to each
            gateway client: a Counter of (topic, publisher, sequence,
            subscription key); a CoAP notification carries no topic."""
            want = {c: Counter() for c in index}
            for j, (c, plan) in enumerate(plans.items()):
                for k, (t, q, _p) in enumerate(plan):
                    for sid, items in broker.publish(Message(
                            topic=t, payload=b"", qos=q, from_=c)).items():
                        d = index.get(sid)
                        for sub_topic, _m in items if d else ():
                            want[sid][(
                                None if d.kind == "coap" else t, j, k,
                                str(filters[sid].index(sub_topic))
                                if d.kind == "stomp" else None)] += 1
            return want

        want = await asyncio.to_thread(expect)
        total = sum(sum(w.values()) for w in want.values())
        out["olp_wait_s"] = await olp_settled(app, "gateway")
        r = (await pool.ask({"cmd": "connect", "clients": [
            {"cid": c, "port": port, "password": password(c)}
            for c in pub_ids]}, 300))["connected"]
        check(all(r[c]["rc"] == 0 for c in pub_ids),
              "gateway: a publisher was refused")
        b1, l1, m0 = pipe.batches, model.launch_count, pipe.published
        res = await pool.ask({"cmd": "publish", "plans": plans}, 900)
        check(acked(res, plans), "gateway: a QoS 1 publish was not acked 0")
        end = time.monotonic() + 300
        while (any(len(index[c].got) < sum(w.values())
                   for c, w in want.items()) and time.monotonic() < end):
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.25)
        lat = {k: [] for k in gws}
        last = res["t_first_ns"]
        for c, d in index.items():
            counter_check(f"gateway {d.kind} {c}", Counter(
                (tp, *_ids(p), k_) for _t, tp, p, k_ in d.got), want[c])
            order_kept(f"gateway {d.kind} {c}", d.got, qos,
                       key=lambda x: x[3])
            lat[d.kind] += [(t - int(p.rsplit(":", 1)[1])) / 1e6
                            for t, _tp, p, _k in d.got]
            last = max([last] + [t for t, *_ in d.got])
            d.got = []
        check(total > 0 and all(lat.values()), "gateway: a protocol got no "
              f"delivery: { {k: len(v) for k, v in lat.items()} }")
        out["downlink"] = {
            "messages": pipe.published - m0, "deliveries": total,
            "messages_per_s": (pipe.published - m0) / max(
                1e-9, (last - res["t_first_ns"]) / 1e9),
            "device_batches": pipe.batches - b1,
            "steps": model.launch_count - l1,
            "puback_ms": pct(np.array(res["puback_ns"]) / 1e6)}
        # -- uplinks: the gateway clients publish, by the host path ----------
        up_ids = [f"gu{s}" for s in range(up)]
        await olp_settled(app, "gateway uplinks")
        r = (await pool.ask({"cmd": "connect", "clients": [
            {"cid": c, "port": port, "password": password(c),
             "filters": [[f"up/+/g{s}", 1], [f"lwm2m/gep{s}/up/#", 0]]}
            for s, c in enumerate(up_ids)]}, 300))["connected"]
        check(all(r[c]["rc"] == 0 and r[c]["suback"] == [1, 0]
                  for c in up_ids), "gateway: an uplink subscriber refused")
        senders = [(d, f"up/{kind}/g{i % up}", n[key])
                   for kind, key in (("stomp", "up_stomp"),
                                     ("mqttsn", "up_sn"), ("coap", "up_coap"))
                   for i, (d, _a) in enumerate(kinds[kind])]
        lwm2m = [d for d, _a in kinds["lwm2m"]]

        def expect_up() -> dict:
            """The host path's routing of each sender's uplink topic to
            the uplink subscribers, its count of messages apart."""
            want = {c: Counter() for c in up_ids}
            for j, (_d, topic, count) in enumerate(senders):
                for sid, items in broker.publish(Message(
                        topic=topic, payload=b"")).items():
                    for k in range(count) if sid in want else ():
                        want[sid][(topic, j, k)] += len(items)
            return want

        want_up = await asyncio.to_thread(expect_up)
        l2, b2 = model.launch_count, pipe.batches

        async def send_up(j: int, d, topic: str, count: int) -> None:
            for k in range(count):
                await d.uplink(topic, f"{j}:{k}:{time.monotonic_ns()}")

        t0 = time.monotonic_ns()
        await asyncio.gather(*(send_up(j, *s) for j, s in enumerate(senders)),
                             *(d.uplinks() for d in lwm2m))
        res = await pool.ask({"cmd": "wait", "expect": {
            c: sum(want_up[c].values()) + 2 * (s < len(lwm2m))
            for s, c in enumerate(up_ids)}, "timeout_s": 120}, 300)
        check(not res["short"], f"gateway uplinks: {len(res['short'])} "
              f"subscribers short, e.g. {res['short'][:3]}")
        up_lat = {"stomp": [], "mqttsn": [], "coap": []}
        last = t0
        for s, c in enumerate(up_ids):
            got = res["received"][c]
            lw = [(x[1], json.loads(x[2])["ep"]) for x in got
                  if x[1].startswith("lwm2m/")]
            check(lw == [(f"lwm2m/gep{s}/up/{e}", f"gep{s}")
                         for e in ("update", "notify")][:2 * (s < len(lwm2m))],
                  f"gateway uplinks: {c} got the LwM2M uplinks {lw}")
            got = [x for x in got if not x[1].startswith("lwm2m/")]
            for (t, st), x in zip(_stream_checks(
                    f"gateway uplinks {c}", got, want_up[c]), got):
                up_lat[senders[_ids(x[2])[0]][0].kind].append((t - st) / 1e6)
                last = max(last, t)
        check(model.launch_count == l2 and pipe.batches == b2,
              f"gateway uplinks: {model.launch_count - l2} steps; the host "
              f"path takes none")
        sent = sum(c for _d, _t, c in senders) + 2 * len(lwm2m)
        out["uplink"] = {
            "messages": sent, "deliveries": sum(map(len, res["received"]
                                                    .values())),
            "messages_per_s": sent / max(1e-9, (last - t0) / 1e9)}
        for kind, pairs in kinds.items():
            stats = {"clients": len(pairs),
                     "connect_ms": pct([d.connect_ms for d, _a in pairs]),
                     "deliveries": len(lat[kind]),
                     "delivery_ms": pct(lat[kind])}
            if up_lat.get(kind):
                stats.update(uplinks=len(up_lat[kind]),
                             uplink_ms=pct(up_lat[kind]))
            out[kind] = stats
            log(f"gateway {kind}: " + json.dumps(stats))
        # -- management through CtlClient and emqx_ctl -----------------------
        mgmt = ManagementApi(app)
        mgmt.start(host="127.0.0.1", port=0)
        url = f"http://127.0.0.1:{mgmt.port}"
        ctl = CtlClient(url)
        listed = await asyncio.to_thread(ctl.request, "GET",
                                         "/api/v5/gateways")
        check(sorted((g["name"], g["current_connections"])
                     for g in listed["data"])
              == sorted((k, len(v)) for k, v in kinds.items()),
              f"gateway mgmt: /gateways {listed['data']}")
        clients = await asyncio.to_thread(
            ctl.request, "GET", "/api/v5/gateways/stomp/clients")
        check([c["clientid"] for c in clients["data"]] == [
            c["clientid"] for c in app.gateway.clients("stomp")],
            "gateway mgmt: /gateways/stomp/clients is not the manager's")
        kicked = kinds["stomp"][0][0]
        await asyncio.to_thread(
            ctl.request, "DELETE",
            f"/api/v5/gateways/stomp/clients/{kicked.cid}")
        await _until(lambda: kicked.closed, "the kicked client's socket")
        check(kicked.cid not in app.gateway.contexts["stomp"].sessions
              and app.cm.lookup_channel(kicked.cid) is None,
              f"gateway mgmt: {kicked.cid} keeps its session")
        text = StringIO()
        with redirect_stdout(text):
            rc = cli.main(["--url", url, "gateway", "list"])
        check(rc == 0 and all(g in text.getvalue() for g in gws),
              f"gateway mgmt: emqx_ctl gateway list: {text.getvalue()}")
        out["mgmt"] = {"gateways": len(listed["data"]),
                       "stomp_clients": len(clients["data"]),
                       "kicked": kicked.cid}
        await pool.close()
    finally:
        await pool.kill()
        if mgmt is not None:
            mgmt.stop()
        for d in devs:
            d.close()
        for gw in gws.values():
            if gw.listener is not None:
                await gw.stop_listeners()
        handler.stop()
        await app.listeners.stop_all()
        logging.getLogger("emqx_tpu_torch.pipeline").removeHandler(errors)
    steps, batches = model.launch_count - l0, pipe.batches - b0
    check(pipe.host_batches == h0 and model.host_match_count == 0,
          "gateway: a batch was served on the host")
    check(steps == batches, f"gateway: {steps} steps for {batches} device "
          f"batches")
    check(app.metrics.val("messages.device_failover") == 0,
          "gateway: a device failover")
    check(not errors.records, f"gateway: the pipeline logged "
          f"{errors.records[:3]}")
    out.update(device_batches=batches, steps_per_batch=steps / batches)
    return out


# ---------------------------------------------------------------------------
# the cluster path: the durable app and a second node on the card
# ---------------------------------------------------------------------------


def rss_mb() -> float:
    """This process's resident set (``VmRSS``), in MiB."""
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    return float("nan")


def cluster_users(n: dict = CLUSTER) -> tuple[list, list]:
    """The cluster path's client ids: those of n1 (its publishers and the
    persistent clients that move to n2; users of the durable app's MySQL
    table) and those of n2 (its subscribers, its publishers and the same
    persistent clients; its built-in DB)."""
    moving = [f"ct{i}" for i in range(n["takeover"])]
    return ([f"cp{j}" for j in range(n["pubs"])] + moving,
            [f"cs{i}" for i in range(n["subs"])]
            + [f"cq{j}" for j in range(n["pubs"])] + moving)


def n2_conf(data_dir: str, users: list[str]) -> str:
    """n2's HOCON config: the routing step on the card at the smoke's
    widths, a TCP listener on 127.0.0.1 and a built-in DB of ``users``
    keyed by client id."""
    boot = ",\n".join(f'{{ user_id = "{u}", password = "{password(u)}" }}'
                      for u in users)
    return f"""
    node {{ name = "n2@127.0.0.1", data_dir = "{data_dir}" }}
    router.device {{
      enable = true, max_levels = 8, n_sub_slots = 8192, frontier_k = 32,
      match_cap = 128, return_cap = 16, batch_max = 512,
      pipeline_depth = 4, min_batch = 0
    }}
    listeners.default {{ type = tcp, bind = "127.0.0.1:0" }}
    authentication = [{{
      mechanism = password_based, backend = built_in_database,
      user_id_type = clientid,
      bootstrap_users = [
{boot}
      ]
    }}]
    """


class StampedChannel(RecordingChannel):
    """A recording channel that also keeps when each delivery arrived
    (``time.monotonic_ns``)."""

    def __init__(self) -> None:
        super().__init__()
        self.at: list[int] = []

    def send(self, items) -> None:
        super().send(items)
        self.at.extend([time.monotonic_ns()] * len(items))


def cluster_leg(sv: dict, device, card: str, n: dict = CLUSTER) -> dict:
    """The cluster path; see :func:`durable_phase`."""
    import shutil

    from emqx_tpu_torch.cluster import harness
    from emqx_tpu_torch.cluster.node import ClusterNode
    from emqx_tpu_torch.cluster.transport import TcpTransport
    t_start = time.time()
    app2, conf2, dir2, boot2 = boot_app(device, cluster_users(n)[1], n2_conf,
                                        prefix="chip_smoke_n2_")
    log("cluster n2 boot (from_config): " + json.dumps(boot2))
    t1, t2 = TcpTransport("n1"), TcpTransport("n2")
    t1.add_peer("n2", t2.host, t2.port)
    t2.add_peer("n1", t1.host, t1.port)
    n1 = ClusterNode("n1", t1, app=sv["app"])
    n2 = ClusterNode("n2", t2, app=app2)
    up = {"n1": n1, "n2": n2}             # nodes whose transport is open
    try:
        router = sv["broker"].router
        routes = len(router.dump())
        rss0, t = rss_mb(), time.perf_counter()
        n2.join(["n1"])
        # R12: the seed's replication cursor for a joiner stays at 0, so
        # its next flush would send its whole route log again, every
        # route n2's bootstrap snapshot already holds, in one call that
        # at 1M outlasts the transport's 10 s timeout and is retried on
        # every flush (the takeover's too); the cursor goes to the log's
        # head, which the snapshot covers (no route changed since)
        with n1._lock:
            resent = router.seq - n1._peer_cursor.get("n2", 0)
            n1._peer_cursor["n2"] = router.seq
        harness.sync([n1, n2])
        join = {"routes": routes, "join_s": time.perf_counter() - t,
                "rss_mb_before": rss0, "rss_mb_after": rss_mb(),
                "r12_deltas_not_resent": resent}
        log("cluster join: " + json.dumps(join))
        got = sum(d == "n1" for _t, d in app2.broker.router.dump())
        check(n1.alive_peers() == ["n2"] and n2.alive_peers() == ["n1"]
              and got == routes, f"cluster: after the join n2 holds {got} "
              f"of n1's {routes} routes; members {n1.alive_peers()}, "
              f"{n2.alive_peers()}")
        olp = idle_olp(sv["app"], sv["listeners_down_at"], "cluster")
        out = asyncio.run(_cluster_run(sv, app2, conf2, up, card, n))
        out.update(join=join, n2_boot=boot2, olp=olp,
                   seconds=time.time() - t_start)
        log("cluster path: " + json.dumps(
            {k: out[k] for k in ("card", "join", "olp_wait_s", "takeover",
                                 "conf", "nodedown", "n1_device_batches",
                                 "n2_device_batches", "seconds")}))
        return out
    finally:
        harness.stop(list(up.values()))
        sv["listeners_down_at"] = time.monotonic()
        app2.bridges.stop_all()
        app2.broker.model.telemetry = app2.device_metrics.model = None
        shutil.rmtree(dir2, ignore_errors=True)


async def _cluster_run(sv: dict, app2, conf2, up: dict, card: str,
                       n: dict) -> dict:
    """The cluster path's legs over both nodes' listeners, the clients in
    the child process's pool; ``up``: the nodes whose transport is open
    (n2's closes in the last leg)."""
    from collections import Counter

    from emqx_tpu_torch.cluster import harness
    from emqx_tpu_torch.core import topic as T
    from emqx_tpu_torch.mgmt.api import ManagementApi
    from emqx_tpu_torch.mgmt.cli import CtlClient
    from emqx_tpu_torch.router.trie import Trie
    n1, n2 = up["n1"], up["n2"]
    app1, broker1 = sv["app"], sv["broker"]
    apps = {"n1": app1, "n2": app2}
    rng = np.random.default_rng(sv["sessions"] + 41)
    errors = ErrorRecords()
    logging.getLogger("emqx_tpu_torch.pipeline").addHandler(errors)
    base = {k: (a.broker.model.launch_count, a.pipeline.batches,
                a.pipeline.host_batches) for k, a in apps.items()}
    pool, mgmts, chans = ClientPool("cluster"), [], {}
    out: dict = {"card": card}
    try:
        await app1.listeners.start_all(sv["conf"].get("listeners"))
        await app2.listeners.start_all(conf2.get("listeners"))
        ports = {k: a.listeners.find("tcp:default").port
                 for k, a in apps.items()}
        out["olp_wait_s"] = await olp_settled(app1, "cluster")
        await pool.start()

        def spec(cid: str, node: str, **kw) -> dict:
            return {"cid": cid, "port": ports[node],
                    "password": password(cid), **kw}

        # -- n2's subscribers; their route deltas reach n1 by flush ----------
        sub_ids = [f"cs{i}" for i in range(n["subs"])]
        fs = dict(zip(sub_ids, sub_lists(sv, rng, n["subs"], 2, 2)))
        r = (await pool.ask({"cmd": "connect", "clients": [
            spec(c, "n2", filters=[[f, 1] for f in fs[c]])
            for c in sub_ids]}, 600))["connected"]
        check(all(r[c]["rc"] == 0 and r[c]["suback"] == [1] * 4
                  for c in sub_ids), "cluster: an n2 subscriber was refused")
        await asyncio.to_thread(harness.sync, [n1, n2])
        wire = sorted({f for f4 in fs.values() for f in f4})
        to_n2 = {t for t, d in broker1.router.dump() if d == "n2"}
        check(to_n2 >= set(wire), f"cluster: n1 lacks "
              f"{len(set(wire) - to_n2)} of n2's routes")
        # -- n1's sampled sessions get stamped recording channels -----------
        tree = [f for f4 in fs.values() for f in f4[:2]]
        sample = {s for f in tree for s in broker1.subscriber.get(f, ())}
        sample |= {f"c{s}" for s in rng.choice(
            sv["sessions"], n["recorded"], replace=False).tolist()}
        for s in sorted(sample):
            if s in broker1.subscription:
                chans[s] = StampedChannel()
                app1.cm.register_channel(s, chans[s])
        # -- publishers on both nodes; n1's persistent clients, away ---------
        p1 = [f"cp{j}" for j in range(n["pubs"])]
        p2 = [f"cq{j}" for j in range(n["pubs"])]
        moving = [f"ct{i}" for i in range(n["takeover"])]
        await olp_settled(app1, "cluster n1")
        r = (await pool.ask({"cmd": "connect", "clients": [
            spec(c, "n1") for c in p1] + [spec(c, "n2") for c in p2] + [
            spec(c, "n1", clean=False, expiry=3600,
                 filters=[[f"takeover/{c}/+", 1]]) for c in moving]},
            300))["connected"]
        check(all(r[c]["rc"] == 0 for c in p1 + p2 + moving),
              "cluster: a publisher or persistent client was refused")
        await pool.ask({"cmd": "disconnect", "cids": moving}, 300)
        await _until(lambda: not any(
            getattr(app1.cm.lookup_channel(c), "conn_state", None)
            == "connected" for c in moving), "the persistent clients' "
            "disconnects")
        # -- the host oracle of the cluster's routes ------------------------
        tries = []
        for owners in ({c: fs[c] for c in sub_ids},
                       {s: broker1.subscription[s] for s in chans}):
            trie, by_filter = Trie(), {}
            for sid, f4 in owners.items():
                for f in f4:
                    by_filter.setdefault(f, []).append(sid)
                    if T.wildcard(f):
                        trie.insert(f)
            tries.append((trie, by_filter))

        def oracle(plans: dict, first: int) -> tuple:
            """Per n2 subscriber a Counter of (topic, publisher, sequence);
            per sampled session of n1 one of (filter, topic, publisher,
            sequence)."""
            want = ({c: Counter() for c in sub_ids},
                    {s: Counter() for s in chans})
            for j, plan in enumerate(plans.values(), first):
                for k, (t, _q, _p) in enumerate(plan):
                    for side, (trie, by_filter) in enumerate(tries):
                        for f in {t, *trie.match(t)} & by_filter.keys():
                            for sid in by_filter[f]:
                                want[side][sid][
                                    (t, j, k) if side == 0
                                    else (f, t, j, k)] += 1
            return want

        async def direction(name: str, node: str, plans: dict,
                            first: int) -> dict:
            """``plans`` published on ``node``: its step routes them to its
            own sessions and forwards them to the other node."""
            app = apps[node]
            want2, want1 = await asyncio.to_thread(oracle, plans, first)
            for ch in chans.values():
                ch.got, ch.at = [], []
            m0 = app.pipeline.published
            res = await pool.ask({"cmd": "publish", "plans": plans}, 900)
            check(acked(res, plans),
                  f"cluster {name}: a QoS 1 publish was not acked 0")
            got = await pool.ask({"cmd": "wait", "expect": {
                c: sum(w.values()) for c, w in want2.items()},
                "timeout_s": 300}, 900)
            check(not got["short"], f"cluster {name}: "
                  f"{len(got['short'])} n2 subscribers short")
            await _until(lambda: sum(map(len, (ch.got for ch in
                                               chans.values())))
                         >= sum(sum(w.values()) for w in want1.values()),
                         f"n1's sampled sessions' deliveries ({name})", 300)
            await asyncio.sleep(0.25)
            qos = qos_of(plans, first)
            lat2, lat1, last = [], [], res["t_first_ns"]
            for c in sub_ids:
                rec = got["received"][c]
                counter_check(f"cluster {name} n2 {c}", Counter(
                    (t, *_ids(p)) for _n, t, p, _q in rec), want2[c])
                check(all(q == qos[_ids(p)] for _n, _t, p, q in rec),
                      f"cluster {name}: {c} got a message at another QoS")
                # a forward rides the lane of its filter (TcpTransport's
                # per-key order): a publisher's order holds per filter,
                # checked where one filter of the subscriber matches
                lanes = [(*x, [f for f in fs[c] if T.match(x[1], f)])
                         for x in rec]
                order_kept(f"cluster {name} n2 {c}",
                           [x for x in lanes if len(x[4]) == 1], qos,
                           key=lambda x: x[4][0])
                lat2 += [(t_ns - int(p.rsplit(":", 1)[1])) / 1e6
                         for t_ns, _t, p, _q in rec]
                last = max([last] + [x[0] for x in rec])
            for s, ch in chans.items():
                rec = [(at, t, p.decode(), f)
                       for (f, t, p), at in zip(ch.got, ch.at)]
                counter_check(f"cluster {name} n1 {s}", Counter(
                    (f, t, *_ids(p)) for _n, t, p, f in rec), want1[s])
                order_kept(f"cluster {name} n1 {s}", rec, qos,
                           key=lambda x: x[3])
                lat1 += [(at - int(p.rsplit(":", 1)[1])) / 1e6
                         for at, _t, p, _f in rec]
                last = max([last] + ch.at)
            sent = sum(map(len, plans.values()))
            check(app.pipeline.published - m0 == sent, f"cluster {name}: "
                  f"{node}'s pipeline routed {app.pipeline.published - m0} "
                  f"of {sent}")
            stats = {"messages": sent, "n2_deliveries": len(lat2),
                     "n1_sampled_deliveries": len(lat1),
                     "messages_per_s": sent / max(
                         1e-9, (last - res["t_first_ns"]) / 1e9),
                     "n2_delivery_ms": pct(lat2) if lat2 else None,
                     "n1_delivery_ms": pct(lat1) if lat1 else None}
            log(f"cluster {name}: " + json.dumps(stats))
            return stats

        out["n1_to_n2"] = await direction("n1->n2", "n1", publisher_plans(
            p1, net_topics(sv, wire, rng, n["qos0"]),
            net_topics(sv, wire, rng, n["qos1"])), 0)
        out["n2_to_n1"] = await direction("n2->n1", "n2", publisher_plans(
            p2, make_topics(tree, rng, n["n2_msgs"], sv["n_vehicles"]), [],
            first=n["pubs"]), n["pubs"])
        check(out["n1_to_n2"]["n2_deliveries"]
              and out["n2_to_n1"]["n1_sampled_deliveries"],
              "cluster: a direction forwarded nothing")
        # -- n1's persistent clients resume on n2: cm.takeover ---------------
        pending = {c: [[f"takeover/{c}/m{k}", 1, f"0:{k}:{{t}}"]
                       for k in range(n["pending"])] for c in moving}
        m0 = app1.pipeline.published
        res = await pool.ask({"cmd": "publish", "plans": {
            p1[0]: [x for c in moving for x in pending[c]]}}, 300)
        check(res["pubacks"][p1[0]] == [0] * n["pending"] * len(moving),
              "cluster takeover: a QoS 1 publish was not acked 0")
        await _until(lambda: app1.pipeline.published - m0
                     >= n["pending"] * len(moving), "the pending messages")
        # n1's takeover hands n2 only what the session holds: a message
        # n1 dispatches after it is lost (ROADMAP R15)
        await dispatched(app1.pipeline)
        await olp_settled(app2, "cluster takeover")
        r = (await pool.ask({"cmd": "connect", "clients": [
            spec(c, "n2", clean=False, expiry=3600) for c in moving]},
            300))["connected"]
        check(all(r[c]["rc"] == 0 and r[c]["present"] for c in moving),
              f"cluster takeover: a resume on n2 found no session: "
              f"{ {c: r[c].get('present') for c in moving} }")
        got = await pool.ask({"cmd": "wait", "expect": {
            c: n["pending"] for c in moving}, "timeout_s": 120}, 300)
        check(not got["short"], f"cluster takeover: {len(got['short'])} "
              f"clients short of their pending messages")
        for c in moving:
            check([(t, p.rsplit(":", 1)[0]) for _n, t, p, _q
                   in got["received"][c]]
                  == [(t, f"0:{k}") for k, (t, _q, _p) in enumerate(
                      pending[c])], f"cluster takeover: {c} got "
                  f"{[x[1:3] for x in got['received'][c][:4]]}")
            check(app1.cm.lookup_channel(c) is None
                  and app2.cm.lookup_channel(c) is not None,
                  f"cluster takeover: {c} still lives on n1")
        out["takeover"] = {"clients": len(moving), "pending": n["pending"],
                           "connect_ms": pct([r[c]["ms"] for c in moving])}
        log("cluster takeover: " + json.dumps(out["takeover"]))
        # -- PUT /configs commits a cluster transaction ---------------------
        for node, app in ((n1, app1), (n2, app2)):
            m = ManagementApi(app, cluster_node=node)
            m.start(host="127.0.0.1", port=0)
            mgmts.append(m)
        ctls = [CtlClient(f"http://127.0.0.1:{m.port}") for m in mgmts]
        value = int(app1.config.get("mqtt.max_inflight")) + 7
        t = time.perf_counter()
        put = await asyncio.to_thread(ctls[0].request, "PUT",
                                      "/api/v5/configs",
                                      {"path": "mqtt.max_inflight",
                                       "value": value})
        commit_ms = (time.perf_counter() - t) * 1e3
        check(put == {"value": value}, f"cluster conf: PUT /configs {put}")
        # the coordinator commits, then casts the entry to its peers
        await _until(lambda: all(a.config.get("mqtt.max_inflight") == value
                                 for a in apps.values()),
                     "the config transaction on both nodes")
        applied_ms = (time.perf_counter() - t) * 1e3
        tnx = [sorted((x["node"], x["tnx_id"]) for x in (
            await asyncio.to_thread(c.request, "GET", "/api/v5/cluster_rpc")
        )["data"]) for c in ctls]
        check(tnx[0] == tnx[1] and len(tnx[0]) == 2
              and tnx[0][0][1] == tnx[0][1][1] >= 1,
              f"cluster conf: /cluster_rpc on n1 and n2: {tnx}")
        out["conf"] = {"commit_ms": commit_ms, "applied_ms": applied_ms,
                       "tnx_id": tnx[0][0][1]}
        log("cluster conf: " + json.dumps(out["conf"]))
        # -- n2 goes down; n1 purges its routes and keeps routing -----------
        await pool.ask({"cmd": "disconnect", "cids": sub_ids + p2 + moving},
                       300)
        await app2.listeners.stop_all()
        await asyncio.to_thread(up.pop("n2").transport.close)
        ticks, t = n1.heartbeat_misses + 1, time.perf_counter()
        for _ in range(ticks):
            await asyncio.to_thread(n1.tick)
        purge_s = time.perf_counter() - t
        left = sum(d == "n2" for _t, d in broker1.router.dump())
        check(not left and not n1.alive_peers(), f"cluster nodedown: n1 "
              f"keeps {left} routes to n2, members {n1.members}")
        l1, b1, m0 = (app1.broker.model.launch_count, app1.pipeline.batches,
                      app1.pipeline.published)
        after = publisher_plans(p1, make_topics(
            sv["live"], rng, n["after"], sv["n_vehicles"]), [])
        await pool.ask({"cmd": "publish", "plans": after}, 300)
        await _until(lambda: app1.pipeline.published - m0 >= n["after"],
                     "n1's routing after n2 went down", 120)
        steps = app1.broker.model.launch_count - l1
        batches = app1.pipeline.batches - b1
        check(batches > 0 and steps == batches, f"cluster nodedown: "
              f"{steps} steps for {batches} device batches on n1")
        out["nodedown"] = {"ticks": ticks, "purge_s": purge_s,
                           "messages_after": n["after"],
                           "batches_after": batches}
        log("cluster nodedown: " + json.dumps(out["nodedown"]))
        await pool.close()
    finally:
        await pool.kill()
        for m in mgmts:
            m.stop()
        for a in apps.values():
            await a.listeners.stop_all()
        for s in chans:
            app1.cm.unregister_channel(s)
        logging.getLogger("emqx_tpu_torch.pipeline").removeHandler(errors)
    for k, a in apps.items():
        steps = a.broker.model.launch_count - base[k][0]
        batches = a.pipeline.batches - base[k][1]
        check(a.pipeline.host_batches == base[k][2]
              and a.broker.model.host_match_count == 0,
              f"cluster: a batch was served on the host of {k}")
        check(batches > 0 and steps == batches, f"cluster: {steps} steps "
              f"for {batches} device batches on {k}")
        check(a.metrics.val("messages.device_failover") == 0,
              f"cluster: a device failover on {k}")
        out[f"{k}_device_batches"] = batches
    check(not errors.records, f"cluster: the pipeline logged "
          f"{errors.records[:3]}")
    return out


def fanout_shapes(fo, device, rng: np.random.Generator) -> int:
    """Both fan-outs against their plain versions at shapes that take each
    path of the gather-OR kernel: 16-byte fids (M % 4 == 0) and rows (W %
    4 == 0), neither, each alone through a contiguous tensor whose data
    starts 4 bytes past a 16-byte boundary, M past one 128-fid chunk, W
    past one 256-word tile, B = 1 and B not a multiple of 8; fids hold
    -1, fids >= F, a topic whose every fid selects one row, and rowmap
    rows >= P."""
    import torch

    def on_card(a: np.ndarray, misaligned: bool) -> torch.Tensor:
        if not misaligned:
            return torch.from_numpy(a).to(device)
        buf = torch.empty(a.size + 4, dtype=torch.int32, device=device)
        t = buf[1:1 + a.size].view(a.shape)
        t.copy_(torch.from_numpy(a))
        check(t.data_ptr() % 16 == 4, "the misaligned tensor is aligned")
        return t

    F, P = 600, 64
    shapes = [  # B, M, W, fids misaligned, table misaligned
        (999, 128, 256, False, False), (999, 77, 5, False, False),
        (999, 128, 256, True, False), (999, 128, 256, False, True),
        (1, 130, 260, False, False), (77, 132, 516, False, False),
        (77, 132, 516, True, True)]
    for B, M, W, mis_f, mis_t in shapes:
        rowmap = np.full(F, -1, np.int32)
        dense = rng.choice(F, 40, replace=False)
        rowmap[dense] = rng.permutation(P)[:40]
        rowmap[rng.choice(np.flatnonzero(rowmap < 0), 5)] = P + 3
        pool = rng.integers(-2 ** 31, 2 ** 31, (P, W)).astype(np.int32)
        bitmaps = rng.integers(-2 ** 31, 2 ** 31, (F, W)).astype(np.int32)
        fids = rng.integers(0, F + 20, (B, M)).astype(np.int32)
        fids[rng.random((B, M)) < 0.5] = -1
        fids[0] = dense[0]                        # every fid, one row
        args = (on_card(rowmap, False), on_card(pool, mis_t),
                on_card(bitmaps, mis_t), on_card(fids, mis_f))
        what = f"B={B} M={M} W={W} misaligned fids {mis_f} table {mis_t}"
        check(torch.equal(fo.fanout_pool(args[0], args[1], args[3]),
                          fo.fanout_pool_plain(args[0], args[1], args[3])),
              f"fanout_pool != plain ({what})")
        check(torch.equal(fo.fanout_bitmaps(args[2], args[3]),
                          fo.fanout_bitmaps_plain(args[2], args[3])),
              f"fanout_bitmaps != plain ({what})")
    return len(shapes)


def bitmap_count_shapes(fo, device, rng: np.random.Generator) -> int:
    """The popcount against its plain version at shapes that take each
    path of its kernel: W % 4 == 0 (16-byte loads) or not, one and more
    than one 256-word tile, W = 1, B = 1, B not a multiple of 8 and the
    bitmap path's B; and a contiguous [16384, 256] tensor whose data
    starts 4 bytes past a 16-byte boundary (the scalar path)."""
    import torch
    shapes = [(B, W, False) for W in (1, 3, 255, 256, 257)
              for B in (1, 33, BATCH)] + [(BATCH, 256, True)]
    for B, W, misaligned in shapes:
        words = rng.integers(-2 ** 31, 2 ** 31, (B, W)).astype(np.int32)
        words[rng.random((B, W)) < 0.3] = 0
        words[0] = -1                              # a full row
        if misaligned:
            buf = torch.empty(B * W + 4, dtype=torch.int32, device=device)
            fan = buf[1:1 + B * W].view(B, W)
            fan.copy_(torch.from_numpy(words))
            check(fan.data_ptr() % 16 == 4, "the misaligned tensor is aligned")
        else:
            fan = torch.from_numpy(words).to(device)
        got = fo.bitmap_to_counts(fan)
        check(torch.equal(got, fo.bitmap_to_counts_plain(fan))
              and int(got[0]) == 32 * W,
              f"bitmap_to_counts != plain (B={B} W={W} misaligned "
              f"{misaligned})")
    return len(shapes)


def patch_blocks(rm, tm, trie, rowmap, pool, cap: int,
                 rng: np.random.Generator) -> np.ndarray:
    """A ``[PATCH_ROWS, cap]`` block of random updates to these tables,
    3/4 of cap unique per target (so every write is defined), padded as
    refresh pads; a stacked trie's fields through (shard, element)
    pairs."""
    n_upd = cap * 3 // 4
    stacked = trie.edges.dim() == 3
    sizes = {n: (tuple(getattr(trie, n).shape) if stacked
                 else getattr(trie, n).shape[0]) for n in tm.TRIE_FIELDS}
    sizes["rowmap"], sizes["pool"] = rowmap.shape[0], tuple(pool.shape)

    def vals():
        return rng.integers(-1, 1 << 20, n_upd).astype(np.int32)

    tupd = {}
    for n in tm.TRIE_FIELDS:
        if stacked:
            S, stride = sizes[n]
            flat = rng.choice(S * stride, n_upd, replace=False)
            v = vals()
            sidx, v = rm._pad_to(cap, (flat // stride).astype(np.int32), v)
            eidx, _ = rm._pad_to(cap, (flat % stride).astype(np.int32), v)
            tupd[n] = ((sidx, eidx), v)
        else:
            tupd[n] = rm._pad_to(cap, rng.choice(
                sizes[n], n_upd, replace=False).astype(np.int32), vals())
    rupd = rm._pad_to(cap, rng.choice(sizes["rowmap"], n_upd,
                                      replace=False).astype(np.int32), vals())
    W = pool.shape[1]
    cells = rng.choice(pool.shape[0] * W, n_upd, replace=False)
    rows, pvals = rm._pad_to(cap, (cells // W).astype(np.int32),
                             rng.integers(0, 1 << 30, n_upd).astype(np.int32))
    cols, _ = rm._pad_to(cap, (cells % W).astype(np.int32),
                         (cells % W).astype(np.int32))
    return rm.patch_block(cap, tupd, rupd, (rows, cols, pvals), sizes)


def table_copies(tm, trie, rowmap, pool) -> tuple:
    return (tm.DeviceTrie(edges=trie.edges.clone(), nodes=trie.nodes.clone()),
            rowmap.clone(), pool.clone())


def tables_equal(a: tuple, b: tuple) -> bool:
    import torch
    return all(torch.equal(x, y) for x, y in zip(
        (a[0].edges, a[0].nodes, *a[1:]), (b[0].edges, b[0].nodes, *b[1:])))


def patch_shapes(rm, tm, models, rng: np.random.Generator) -> int:
    """The patch kernel against its plain version on copies of the flat
    and the stacked live tables: a block on the card and a pinned host
    block at caps 64 to 4096; a pageable host block with tables on the
    card must raise."""
    import torch
    n = 0
    for model in models:
        tables = (model._trie_dev, model._rowmap_dev, model._pool_dev)
        ka, kb = table_copies(tm, *tables), table_copies(tm, *tables)
        for cap in (64, 256, 1024, 4096):
            upd = patch_blocks(rm, tm, *tables, cap, rng)
            pinned = torch.from_numpy(upd).pin_memory()
            for block in (torch.from_numpy(upd).to(model.device), pinned):
                rm.apply_patches(*ka, block)
                rm.apply_patches_plain(*kb, torch.from_numpy(upd).to(
                    model.device))
                check(tables_equal(ka, kb),
                      f"patch != plain (cap {cap}, block on "
                      f"{'pinned host' if block is pinned else 'the card'}, "
                      f"{model.n_shards} shard(s))")
                n += 1
            try:
                rm.apply_patches(*ka, torch.from_numpy(upd))
            except ValueError:
                pass
            else:
                raise SmokeFailure("a pageable update block was taken")
        del ka, kb
    return n


def kernels_phase(st: dict, sh: dict, bm: dict, by_path: dict,
                  patch_cap: int) -> tuple[list[dict], float]:
    """One row per kernel at its path's shapes: the flat kernels on the
    flat model's dense mix, the sharded ones on the sharded model's, the
    bitmap ones on the bitmap path's first batch; each with ``launches``,
    its launches summed over the paths of ``by_path`` (path → kernel →
    launches), and ``launches_by_path``, the paths' own; with ``ms`` (one
    launch after an L2 flush, as every earlier run took it) and
    ``run_ms`` (a run of back-to-back launches).  Returns the rows and
    ``floor_ms``, an empty kernel timed as ``ms`` is.  Logs the routing
    steps and ``pack_counters`` timed and bounded the same way."""
    import torch

    from emqx_tpu_torch.models import router_model as rm
    from emqx_tpu_torch.ops import fanout as fo
    from emqx_tpu_torch.ops import trie_match as tm
    counts = {}
    for path in by_path.values():
        for k, v in path.items():
            counts[k] = counts.get(k, 0) + v
    model = st["model"]
    dev = model.device
    trie, rowmap, pool = model._trie_dev, model._rowmap_dev, model._pool_dev
    K, M, P = model.K, model.M, model.index.max_probes
    tok, lens, sysf, _ = model.index.tokenize(st["big"][0])
    args = tuple(torch.from_numpy(x).to(dev) for x in (tok, lens, sysf))
    B, L = tok.shape
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    floor_ms = time_ms(lambda: torch.cuda._sleep(1), 20, flush)
    log(f"timing floor: an empty kernel takes {floor_ms} ms as ms is taken")
    rows = []

    def row(name, got, want, fn, inputs, plain_ms, n_bytes, n_ops,
            sector_bytes, library_ms=None):
        """``fn(*inputs)`` launches the kernel on the batch inputs;
        ``sector_bytes``: ``n_bytes`` with a whole 32-byte sector moved for
        each scattered access, logged beside the bound."""
        err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
        check(err == 0, f"{name}: kernel differs from plain (max abs {err})")
        b, by = bound_ms(n_bytes, n_ops)
        ms = time_ms(lambda: fn(*inputs), 20, flush)
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[name],
                     "launches": counts.get(name, 0),
                     "launches_by_path": {p: c[name] for p, c in
                                          by_path.items() if name in c},
                     "max_abs_err": err,
                     "ms": ms, "run_ms": run_ms(fn, inputs),
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "library_ms": library_ms})
        sector_ms, _ = bound_ms(sector_bytes, n_ops)
        log(f"kernel {name}: {json.dumps(rows[-1])}; bound with a "
            f"{SECTOR}-byte sector per scattered access {sector_ms} ms")

    def sectored(n_bytes, scattered):
        return n_bytes + scattered * (SECTOR - 4)

    def log_traffic(name, traffic):
        log(f"{name} replay: " + json.dumps({
            k: traffic[k] for k in ("values", "records", "ranked", "sorts",
                                    "live", "walking")}))

    # 1. the step's walk, compacted as it walks (flat)
    traffic = walk_traffic(tm, trie, *args, K, P)
    log_traffic("flat walk", traffic)
    C = (L + 1) * 2 * K
    width = min(M, C)
    fids, fstats = tm.match_compact(trie, *args, K=K, M=M, max_probes=P)
    nb = walk_bytes(traffic, B, L, B * width * 4 + B * 16)
    row("walk_compact", (fids, fstats),
        tm.match_compact_plain(trie, *args, K=K, M=M, max_probes=P),
        lambda *a: tm.match_compact(trie, *a, K=K, M=M, max_probes=P), args,
        time_ms(lambda: tm.match_compact_plain(trie, *args, K=K, M=M,
                                               max_probes=P), 5, flush),
        nb[0], traffic["ops"], nb[1])
    # 2. the walk in its cand mode (match_batch)
    cand, stats = tm.match_batch_stats(trie, *args, K=K, max_probes=P)
    want = tm.match_batch_plain(trie, *args, K=K, max_probes=P)
    nb = walk_bytes(traffic, B, L, B * C * 4 + B * 16)
    row("trie_walk", (cand, stats), want,
        lambda *a: tm.match_batch_stats(trie, *a, K=K, max_probes=P), args,
        time_ms(lambda: tm.match_batch_plain(trie, *args, K=K, max_probes=P),
                5, flush),
        nb[0], traffic["ops"], nb[1])
    # 2b. the walk counted only (match_counts): its plain version and the
    # cand-mode walk's count, exactly
    got = tm.match_counts(trie, *args, K=K, max_probes=P)
    check(torch.equal(got[0], (cand >= 0).sum(1, dtype=torch.int32))
          and torch.equal(got[1], stats[:, 3] != 0),
          "walk_count != the cand-mode walk's counts and overflow")
    nb = walk_bytes(traffic, B, L, B * 5)
    row("walk_count", got,
        tm.match_counts_plain(trie, *args, K=K, max_probes=P),
        lambda *a: tm.match_counts(trie, *a, K=K, max_probes=P), args,
        time_ms(lambda: tm.match_counts_plain(trie, *args, K=K,
                                              max_probes=P), 5, flush),
        nb[0], traffic["ops"], nb[1])
    # 3. compact, from a flushed L2 like the others, so that the HBM rate
    # of its bound holds
    got = tm.compact_fids(cand, M=M)
    row("compact", got, tm.compact_fids_plain(cand, M=M),
        lambda c: tm.compact_fids(c, M=M), (cand,),
        time_ms(lambda: tm.compact_fids_plain(cand, M=M), 5, flush),
        B * C * 4 + B * width * 4 + B, B * C * 4, B * C * 4 + B * width * 4
        + B)
    check(torch.equal(got[0], fids), "walk_compact != trie_walk + compact")
    # 4. fan-out over the live dense pool
    W = pool.shape[1]
    out = fo.fanout_pool(rowmap, pool, fids)
    check(bool((out != 0).any()), "fan-out found no dense-pool row")
    fan_bytes, fan_ops, fan_gathers = fanout_pool_work(rowmap, pool, fids)
    row("fanout_pool", (out,), (fo.fanout_pool_plain(rowmap, pool, fids),),
        lambda f: fo.fanout_pool(rowmap, pool, f), (fids,),
        time_ms(lambda: fo.fanout_pool_plain(rowmap, pool, fids), 5, flush),
        fan_bytes, fan_ops, sectored(fan_bytes, fan_gathers))
    # 5. patch scatter at the churn's update-block size, on copies of the
    # live tables, from a pinned host block as refresh stages it (the time
    # from a block on the card is logged beside it)
    rng = np.random.default_rng(3)
    upd = patch_blocks(rm, tm, trie, rowmap, pool, patch_cap, rng)
    pinned = torch.from_numpy(upd).pin_memory()
    on_card = torch.from_numpy(upd).to(dev)
    ka, kb = table_copies(tm, trie, rowmap, pool), \
        table_copies(tm, trie, rowmap, pool)
    rm.apply_patches(*ka, pinned)
    rm.apply_patches_plain(*kb, on_card)
    got = [ka[0].edges, ka[0].nodes, *ka[1:]]
    want = [kb[0].edges, kb[0].nodes, *kb[1:]]
    plain_ms = time_ms(lambda: rm.apply_patches_plain(*kb, on_card), 20,
                       flush)
    card_ms = time_ms(lambda: rm.apply_patches(*ka, on_card), 20, flush)
    n_upd = patch_cap * 3 // 4
    patch_bytes = rm.PATCH_ROWS * patch_cap * 4 + 8 * n_upd * 4
    row("patch", got, want, lambda u: rm.apply_patches(*ka, u), (pinned,),
        plain_ms, patch_bytes, 8 * patch_cap * 4,
        sectored(patch_bytes, 8 * n_upd), library_ms=plain_ms)
    log(f"patch from a block on the card: {card_ms} ms")
    del ka, kb, want, out, got
    # 6. the sharded step's walk, compacted as it walks, on the sharded
    # model's dense mix; its table reads counted per shard by the same
    # replay, the topic inputs once
    smodel = sh["model"]
    strie = smodel._trie_dev
    S = strie.edges.shape[0]
    stok, slens, ssys, _ = smodel.index.tokenize(sh["big"][0])
    sargs = tuple(torch.from_numpy(x).to(dev) for x in (stok, slens, ssys))
    straffic = [walk_traffic(tm, tm.shard_trie(strie, s), *sargs, K, P)
                for s in range(S)]
    for s, t in enumerate(straffic):
        log_traffic(f"shard {s} walk", t)
    out_w = min(M, S * width)

    def sharded_bytes(out_bytes):
        per = [walk_bytes(t, B, L, 0, inputs=s == 0)
               for s, t in enumerate(straffic)]
        return (sum(p[0] for p in per) + out_bytes,
                sum(p[1] for p in per) + out_bytes)

    sops = sum(t["ops"] for t in straffic)
    got = tm.match_compact_sharded(strie, *sargs, n_shards=S, K=K, M=M,
                                   max_probes=P)
    nb = sharded_bytes(B * out_w * 4 + S * B * 16 + B)
    row("walk_compact_sharded", got,
        tm.match_compact_sharded_plain(strie, *sargs, n_shards=S, K=K, M=M,
                                       max_probes=P),
        lambda *a: tm.match_compact_sharded(strie, *a, n_shards=S, K=K, M=M,
                                            max_probes=P), sargs,
        time_ms(lambda: tm.match_compact_sharded_plain(
            strie, *sargs, n_shards=S, K=K, M=M, max_probes=P), 3, flush),
        nb[0], sops, nb[1])
    sfids = got[0]
    # 7. the sharded walk in its cand mode (match_batch_sharded)
    scand, sstats = tm.match_batch_sharded_stats(strie, *sargs, K=K,
                                                 max_probes=P)
    want = tm.match_batch_sharded_plain(strie, *sargs, K=K, max_probes=P)
    nb = sharded_bytes(S * B * C * 4 + S * B * 16)
    row("trie_walk_sharded", (scand, sstats), want,
        lambda *a: tm.match_batch_sharded_stats(strie, *a, K=K,
                                                max_probes=P), sargs,
        time_ms(lambda: tm.match_batch_sharded_plain(
            strie, *sargs, K=K, max_probes=P), 3, flush),
        nb[0], sops, nb[1])
    del want
    # 8. the sharded compact on that candidate block
    got = tm.compact_sharded(scand, M=M, n_shards=S)
    cs_bytes = S * B * C * 4 + B * out_w * 4 + B + S * B * 4
    row("compact_sharded", got,
        tm.compact_sharded_plain(scand, M=M, n_shards=S),
        lambda c: tm.compact_sharded(c, M=M, n_shards=S), (scand,),
        time_ms(lambda: tm.compact_sharded_plain(scand, M=M, n_shards=S), 5,
                flush),
        cs_bytes, S * B * C * 4, cs_bytes)
    check(torch.equal(got[0], sfids),
          "walk_compact_sharded != trie_walk_sharded + compact_sharded")
    del scand, sstats, got
    # 8b. the mesh_s4 path's group walks and merged compact at its shapes
    log("mesh_s4 kernels: " + json.dumps(mesh_groups(
        tm, strie, sargs, S, K, M, P, sfids, flush)))
    # 9. the bitmap fan-out over the dense [F, W] bitmap, on the untrimmed
    # fids of the bitmap path's first batch
    bitmaps, bfids = bm["bitmaps"], bm["fids"]
    Bb = bfids.shape[0]
    Wb = bitmaps.shape[1]
    fan = fo.fanout_bitmaps(bitmaps, bfids)
    bm_bytes, bm_ops, bm_gathers = fanout_bitmaps_work(bitmaps, bfids)
    row("fanout_bitmaps", (fan,), (fo.fanout_bitmaps_plain(bitmaps, bfids),),
        lambda f: fo.fanout_bitmaps(bitmaps, f), (bfids,),
        time_ms(lambda: fo.fanout_bitmaps_plain(bitmaps, bfids), 5, flush),
        bm_bytes, bm_ops, sectored(bm_bytes, bm_gathers))
    # 10. popcount per topic of that fan-out
    row("bitmap_counts", (fo.bitmap_to_counts(fan),),
        (fo.bitmap_to_counts_plain(fan),), fo.bitmap_to_counts, (fan,),
        time_ms(lambda: fo.bitmap_to_counts_plain(fan), 5, flush),
        Bb * Wb * 4 + Bb * 4, Bb * Wb * 2, Bb * Wb * 4 + Bb * 4)
    log("library_ms: none for the walks in all three modes, compact, "
        "fanout_pool, the sharded compact (no PyTorch call computes them), "
        "fanout_bitmaps "
        "(no OR reduction over gathered rows) or bitmap_counts (no "
        "popcount); patch's is its plain version, 8 index_put_ calls")
    fused_steps(st, sh)
    telemetry_off(st)
    composites_line(st, sh, counts, args, sargs, traffic, straffic, flush)
    erng = np.random.default_rng(5)
    n_counts = bitmap_count_shapes(fo, dev, erng)
    n_patch = patch_shapes(rm, tm, (model, smodel), erng)
    log(f"edge shapes: bitmap_to_counts at {n_counts} shapes and patch at "
        f"{n_patch} blocks agree; a pageable block raises")
    log(f"kernels: {small_tries(tm, fo, dev)} small edge-case tries agree")
    return rows, floor_ms


def mesh_groups(tm, strie, sargs, S: int, K: int, M: int, P: int, sfids,
                flush) -> dict:
    """The stacked walk on a group of shards against its plain version at
    the mesh_s4 path's shapes: on (2, 2) each tp rank walks S/2 = 2 shards
    (shard_base 0 and 2) on its dp group's B/2 rows, on (1, 4) one shard
    (shard_base 0..3) on 64 rows; each group in the stats mode and as the
    mesh step launches it (a step of no fids and cap M, counters on and
    off: its flag the group's K spill or truncation, its acc the ``[S/tp,
    C]`` counters); then the compact kernel on the groups' merged rows,
    against its plain version, and its fids against the single-card
    sharded walk's.  The group walks' and the compact's launches count on
    no path."""
    import torch

    from emqx_tpu_torch.models import router_model as rm
    out = {}
    B = sargs[0].shape[0]
    C = len(tm.KERNEL_COUNTER_FIELDS)
    for (dp, tp), rows in ((MESH_SHAPE, B // MESH_SHAPE[0]), (MESH_WIDE, 64)):
        S_l = S // tp
        a = tuple(x[:rows] for x in sargs)
        groups = []
        for j in range(tp):
            part = tm.DeviceTrie(edges=strie.edges[j * S_l:(j + 1) * S_l],
                                 nodes=strie.nodes[j * S_l:(j + 1) * S_l])
            kw = dict(n_shards=S, shard_base=j * S_l, K=K, M=M,
                      max_probes=P)
            what = (f"the group walk (shards {j * S_l}..{(j + 1) * S_l - 1} "
                    f"of {S}, {rows} rows)")
            got = tm.match_compact_sharded(part, *a, **kw)
            want = tm.match_compact_sharded_plain(part, *a, **kw)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"{what} != its plain version")
            groups.append(got[0])
            flag_want = (want[1][:, :, 3] != 0).any(0) | want[2]
            counters_want = rm._shard_counters(want[1], M)
            for words in (S_l * C + 1, 1):
                flag = torch.empty(rows, dtype=torch.bool, device=a[0].device)
                acc = torch.full((words,), -1, dtype=torch.int32,
                                 device=a[0].device)
                fids = tm.launch_walk_compact_sharded(
                    part, *a, step=tm.StepOut(None, flag, acc, M), **kw)[0]
                check(torch.equal(fids, want[0])
                      and torch.equal(flag, flag_want)
                      and acc[-1].item() == 0
                      and (words == 1 or torch.equal(
                          acc[:-1].view(S_l, C), counters_want)),
                      f"{what} launched as the mesh step launches it "
                      f"(counters {'on' if words > 1 else 'off'}): its "
                      f"fids, flag or counters != the plain version's")
        merged = torch.cat(groups, 1)
        Mout = sfids.shape[1]
        got = tm.compact_fids(merged, M=Mout)
        want = tm.compact_fids_plain(merged, M=Mout)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"compact at the merged shape {tuple(merged.shape)} != plain")
        check(torch.equal(got[0], sfids[:rows]),
              f"the groups' merged compact ({dp}, {tp}) != the single-card "
              f"sharded walk")
        out[f"{dp}x{tp}"] = {
            "rows": rows, "shards_per_device": S_l,
            "merged": list(merged.shape),
            "compact_ms": time_ms(lambda: tm.compact_fids(merged, M=Mout),
                                  20, flush)}
    return out


def composites_line(st, sh, counts, args, sargs, traffic, straffic,
                    flush) -> None:
    """The routing steps (flat and S=4: two kernel launches each, the
    walk's with its memset), with the counters on and off, and
    ``pack_counters``, timed as the kernels are (``ms``, ``run_ms``; the
    steps' ``plain_ms`` is their torch composite around the two bare
    kernels, the steps as PRs 1–5 ran them), with bounds from their inputs
    and outputs read or written once, the walk's table values from its
    replay and the fan-out's from its inputs.  ``launches`` are calls on
    the paths: a step per ``walk_compact`` / ``walk_compact_sharded``
    launch, on the counters-on row (the paths' steps pack them; the count
    includes the launch check's counters-off step); the walk's epilogue
    packs the counters, so ``pack_counters`` has none."""
    import torch

    from emqx_tpu_torch.models import router_model as rm
    from emqx_tpu_torch.ops import trie_match as tm
    out = []
    C = len(tm.KERNEL_COUNTER_FIELDS)
    for (name, s, a, walk), wc in itertools.product(
            (("router_step", st, args, [traffic]),
             ("router_step_sharded", sh, sargs, straffic)), (True, False)):
        model = s["model"]
        plain = (functools.partial(rm.router_step_sharded_plain,
                                   n_shards=model.n_shards)
                 if model._sharded else rm.router_step_plain)
        rowmap, pool = model._rowmap_dev, model._pool_dev
        B, L = a[0].shape
        res = run_step(model, a, model.ret_cap, wc)
        full = run_step(model, a, None, wc)[0]
        fb, fo_ops, _ = fanout_pool_work(rowmap, pool, full)
        W = pool.shape[1]
        n_bytes = (B * (L * 4 + 4 + 1) + sum(t["values"] for t in walk) * 4
                   + fb - B * full.shape[1] * 4 - B * W * 4
                   + sum(x.numel() * x.element_size() for x in res
                         if x is not None))
        n_ops = sum(t["ops"] for t in walk) + fo_ops
        b, by = bound_ms(n_bytes, n_ops)
        walk_name = "walk_compact_sharded" if model.n_shards > 1 \
            else "walk_compact"
        # the paths' steps pack their counters: the walk's count goes on
        # the counters-on row
        out.append({"name": name, "with_counters": wc,
                    **({"launches": counts.get(walk_name, 0)} if wc else {}),
                    "ms": time_ms(lambda: run_step(model, a, model.ret_cap,
                                                   wc), 20, flush),
                    "run_ms": run_ms(lambda *x: run_step(
                        model, x, model.ret_cap, wc), a),
                    "plain_ms": time_ms(lambda: plain(
                        model._trie_dev, rowmap, pool, *a, K=model.K,
                        M=model.M, max_probes=model.index.max_probes,
                        ret_cap=model.ret_cap, with_counters=wc), 20, flush),
                    "bound_ms": b, "bound_by": by})
    # the flat step's counters, as router_step_plain packs them
    model = st["model"]
    trie, M = model._trie_dev, model.M
    kp = dict(K=model.K, max_probes=model.index.max_probes)
    stats = tm.match_compact(trie, *args, M=M, **kp)[1]
    n = stats[:, 2]
    kw = dict(frontier_peak=stats[:, 0].max(),
              probe_iters=stats[:, 1].sum(dtype=torch.int32),
              cand_pre=n.sum(dtype=torch.int32),
              cand_post=n.clamp(max=M).sum(dtype=torch.int32),
              compact_peak=n.clamp(max=M).max(),
              overflow_rows=stats[:, 3].sum(dtype=torch.int32),
              trunc_rows=(n > M).sum(dtype=torch.int32))
    names = list(kw)
    b, by = bound_ms(C * 4 + C * 4, 0)
    out.append({"name": "pack_counters", "launches": 0,
                "ms": time_ms(lambda: tm.pack_counters(**kw), 20, flush),
                "run_ms": run_ms(lambda *v: tm.pack_counters(
                    **dict(zip(names, v))), tuple(kw.values())),
                "bound_ms": b, "bound_by": by})
    log(f"composites ({device_line()}): " + json.dumps(out))


class NativeBuild:
    """The port's native library (``emqx_tpu_torch/native``: g++ of the
    C++ host, its load generator, snappy and bcrypt into
    ``emqx_tpu_torch/_build/native/``) built on a thread; ``join`` logs
    its seconds and fails the run where it did not build."""

    def __init__(self) -> None:
        import threading
        self.t0, self.seconds = time.time(), None
        self.thread = threading.Thread(target=self._build, daemon=True,
                                       name="native-build")
        self.thread.start()

    def _build(self) -> None:
        from emqx_tpu_torch import native
        native.available()
        self.seconds = time.time() - self.t0

    def join(self) -> None:
        from emqx_tpu_torch import native
        self.thread.join()
        ok = native.available()
        log(f"native build: {self.seconds:.1f}s "
            f"({native._LIB_PATH}): "
            + ("ok" if ok else f"FAILED: {native.build_error()}"))
        check(ok, f"the native library does not build: "
              f"{native.build_error()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42,
                    help="seed of the filters, topics and churn")
    ap.add_argument("--network-clients", action="store_true",
                    help="serve as the network phase's client process "
                    "(the phase starts it; not for use by hand)")
    a = ap.parse_args(argv)
    if a.network_clients:
        return network_clients()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        from emqx_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 1
    try:
        t_start = time.time()
        secs = {}
        dev_line = device_line()
        log(f"device: {dev_line}; torch {torch.__version__} "
            f"cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}")
        # the native library (g++, the C++ host) builds on a thread of its
        # own while nvcc builds the kernels and the first paths run
        native_build = NativeBuild()
        t = time.time()
        libs = _build.build_all()
        log(f"build: {time.time() - t:.1f}s ({', '.join(map(str, libs))})")
        secs["build"] = time.time() - t_start
        t = time.time()
        st = load(N_FILTERS, a.seed, "cuda")
        # path 1: the flat routing step
        _build.reset_launch_counts()
        slice_phase(st, BATCH, "plain")
        add_broadcast(st)
        slice_phase(st, BATCH, "dense")
        step_launches(st)
        churn_out = churn_phase(st)
        by_path = {"flat": path_counts("flat")}
        idle_phase(st)
        traced_step(st)
        traced_step(st, with_counters=False)
        # path 2: the dense-bitmap fan-out, on the flat model
        _build.reset_launch_counts()
        bm = bitmap_phase(st)
        by_path["bitmap"] = path_counts("bitmap")
        # path 3: the sharded routing step, on the same subscriptions
        bcast_slots = st["bcast_slots"]
        sh = load_sharded(st, SHARDS)
        _build.reset_launch_counts()
        slice_phase(sh, BATCH, "plain")
        add_broadcast(sh, bcast_slots)
        slice_phase(sh, BATCH, "dense")
        step_launches(sh)
        churn_phase(sh)
        by_path["sharded"] = path_counts("sharded")
        traced_step(sh)
        traced_step(sh, with_counters=False)
        cross_check(sh, bcast_slots)
        secs["flat_bitmap_sharded"] = time.time() - t
        # paths 4-5: the flat and the sharded trie on a mesh (the card
        # four times), over the same host state
        t = time.time()
        by_path.update(mesh_phase(st, sh)[0])
        secs["mesh"] = time.time() - t
        # paths 6-7: the entry points (entry(), dryrun_multichip) on their
        # own models
        t = time.time()
        by_path.update(entry_phase(dev_line)[0])
        secs["entry"] = time.time() - t
        native_build.join()
        # path 4: the serving plane (broker, pipeline, CM and the kernel
        # fold around a model on the card), its flat and its S=4 leg
        serve = serving_phase(a.seed, "cuda", dev_line)
        secs.update(serve["seconds"])
        by_path["serving"] = serve["counts"]
        by_path["network"] = serve["network_counts"]
        by_path["native"] = serve["native_counts"]
        by_path["services"] = serve["services_counts"]
        by_path["app"] = serve["app_counts"]
        by_path["serving_s4"] = serve["s4_counts"]
        # paths 5-7: the durable and integrations path, then the gateways
        # and the cluster, on a second app; the serving phase's apps go
        # first (host RAM holds one 1M app)
        t = time.time()
        free_heap()
        _build.reset_launch_counts()
        dur = durable_phase(a.seed, "cuda", dev_line)
        by_path.update(dur["counts"])
        secs.update(dur["path_seconds"])
        secs["durable_gateway_cluster"] = time.time() - t
        t = time.time()
        rows, floor_ms = kernels_phase(st, sh, bm, by_path,
                                       churn_out["patch_cap"])
        check(sorted(r["name"] for r in rows) == sorted(_build.KERNELS),
              f"the kernels line lacks "
              f"{sorted(set(_build.KERNELS) - {r['name'] for r in rows})}")
        torch.cuda.synchronize()
        secs["kernels"] = time.time() - t
        secs["total"] = time.time() - t_start
        log(f"phase seconds ({dev_line}): " + json.dumps(secs))
        log(f"total {time.time() - t_start:.1f}s")
    except SmokeFailure as e:
        log(f"phase seconds so far: {json.dumps(secs)}")
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(dev_line)
    print(json.dumps({"kernels": rows, "floor_ms": floor_ms}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
