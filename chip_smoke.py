#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card; hold its kernels to their plain
versions.

Run from the repository root, on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):

1. environment: the card's name, and its name and power limit as
   ``nvidia-smi`` reports them;
2. build: ``nvcc`` builds every ``csrc/*.cu`` of the port (seconds printed,
   and ptxas' registers, shared memory and spills of every kernel
   instantiation), and ``g++`` the native core (``native/greedy.cpp``);
3. kernels: each kernel against its plain PyTorch version on the card, on the
   same inputs, at every shape the main paths give it and at edge shapes:
   the round scan bit for bit (integers: tolerance 0), also at the quality
   solver's greedy-leg shapes of configs 2, 4 and 5, at every slot count
   1, 2, 4, ..., 16,384, at the cluster form's 32,768, 65,536 and 131,072
   and the scratch form's 262,144 (C not a power of two above 2), and at C
   = 131,072 and 131,073, with small lags and with lags that force the
   two-key form, at 16,385 consumers and on the ``global`` solve's
   carried rounds at 20,000, at config 5's shape forced into
   the two-key form (lags near 2^40), at the cold chain of phase 4f's
   config-3-shaped streams (16,384 rows, 64 slots) and with negative gains;
   each case in
   the key form ``packed_rank_bits`` gives it and, where that is the
   packed key, in the two-key form too, every launch twice to the same
   bits, the form logged; the f32 quality
   kernels within ``max |kernel - plain| <= 1e-5 * max |plain|`` (f32 sums
   in another order and an approximate exp), each run twice to the same
   bits: the plan statistics (K3) at the dedup shapes of configs 2, 4 and
   5 and of two of config 3's topics (C 64) and at every U = 1, 17,
   1,024, 4,096 and C = 1, 16, 31, 512, 1,000, 1,024, 1,025, 2,000,
   16,384 (C ascending), in each ``need`` (both, load, colsum; the
   marginal asked for alone equal bit for bit to its ``need="both"``
   value) and in each kernel form that takes the shape (the cluster and
   pass forms up to C = 1,024, the column form above); superblock
   partials and the mirror-prox step at config 5 with C 1000 and 16, and
   at the duals the plain linear loop holds after its last step at config
   5, also at edge shapes (C = 1, 2, not a multiple of 128, and 1,025,
   2,000 and 16,384; trailing tiles all padding and all-zero weights, at
   a register width and at a column width); K3, K4 and K5 at C = 16,385
   (the last column tile one consumer wide), 20,000 and 60,000, after the
   forms by width (registers up to 1,024 consumers, ceil(C / 1,024)
   column tiles above); and torch's argmin / argmax on the
   card take the first index among ties, as the JAX package's do; the
   resident-state digest (K6) bit for bit, each case launched twice to the
   same bits, at BASELINE config 5's resident shape (B 131,072, C 1,000,
   M 133), clean and with each corruption class, at phase 4f's
   config-3-shaped streams' (B 16,384, C 64), at B = 7 and 8, B = 1,027
   (not a multiple of 4), C = 1, C = 16,384, M = 0 and a wrapping lag sum,
   C = 20,000 (the histogram in shared memory) and 100,000 (in the
   scratch), there also through the batched and shard entries; from the
   profiler, one call of
   K3 (configs 2 and 4, ``need`` load and colsum) and of K6 (config 5)
   enqueues one kernel and no memset; the streaming engine's bulk
   refine on the card bit for bit against the port's CPU path from a
   drifted config-5 resident state; the P-step scan (K7) bit for bit
   against its plain version on the card, each case launched twice to the
   same bits, and a case the packed key admits also in the two-key form,
   at C = 1, 2, 31, 32, 33, 1,000, 1,024, 1,025, 16,384, 16,385 and
   20,000 (and 20,000 eligible of 24,000: the cluster form; 65,537, and
   131,072 eligible of 140,000, each a round and a part, held to the round
   identity on K1's plain version, ``scan_by_rounds``), with
   all-zero lags, lags near 2^62 (wrapping totals), an eligible mask and a
   mask with none eligible, padding rows (at the end and in the middle),
   config 3's 256 topics x 64 rows, E = 1, 2 and 33 eligible of 1,000
   consumers and 2 of 16,384, and four topics of their own valid lengths
   with padding in the middle, then the main path's own inputs at configs
   5 (131,072 padded rows, 100k valid, C 1,000) and 3 bit for bit against
   the plain version on CPU copies (timed on the host clock), also as the
   main path calls it (the lags' range from the host, the same plan);
   ``refine_batched`` (16 rounds) on the
   card bit for bit against the port's CPU path at config 3, at its shape
   with 16 consumers and on the config-5 topic; and
   ``native.assign_native`` at config 5 equal to the ``rounds`` solve on
   the card;
4. main paths, each with every launch count set to 0 just before it and
   read just after, through the port's ``LagBasedPartitionAssignor(
   device="cuda")`` with a ``FakeBroker``, with the host rung off
   (``tpu.assignor.host.fallback=false``) and the watchdog at its default
   deadline (the solve in its ``klba-solve`` worker thread, as users run
   it): every ``assign()`` of phases 4 and 5 checks that
   ``last_stats.fallback_used`` is False and that
   ``klba_ladder_rung_total`` did not move, so a kernel fault fails the run
   instead of hiding behind the host greedy (phase 4e alone turns the rung
   on);
   a. ``rounds`` and ``global`` on BASELINE config 5 (1 topic, 100k
      partitions, 1k consumers) and config 3 (256 topics x 64 partitions,
      64 consumers): every ``assign()`` launches the round-scan kernel,
      keeps each topic's count spread <= 1 and equals the port's CPU path;
      the README example gives its documented answer;
   b. ``sinkhorn`` on BASELINE configs 2 (1k x 16), 4 (10k x 512, 90 %
      zero lag: the dense path) and 5 (the linear path): the plan-statistics
      kernel launches at 2 and 4, the mirror-prox step (and so the
      superblock partials) at 5, the round scan at all three; every
      partition is assigned once, count spread <= 1, peak member load no
      worse than the ``rounds`` solver's, the additive bound at config 5; a
      second ``assign()`` gives the same assignment; the port's CPU path
      on the same input meets the same invariants (both quality ratios
      printed);
   c. the streaming engine ``StreamingAssignor(num_consumers=1000,
      refine_iters=512, imbalance_guardrail=1.25)`` at full config 5 in four
      legs: bench.py's 10-epoch drift schedule (seed 5), three delta epochs
      (at most 512 changed lags, on one consumer's partitions), a member
      leaving and one joining, and a corruption drill (one flipped bit of
      the resident choice raises ``CorruptStateDetected``, the next epoch
      heals).  Every epoch keeps each partition in [0, C), count spread
      <= 1 and, warm and untripped, churn <= 2 * 512 + repaired rows; the
      digest kernel launches once per refine dispatch and the round scan
      once per cold chain; a second run on the card and a run of the port's
      CPU engine at the card's bucket give the same bits;
   d. ``scan``, ``native``, and ``rounds`` and ``scan`` with
      ``tpu.assignor.refine.iters=16`` at configs 5 and 3: every ``scan``
      ``assign()`` launches K7; ``scan`` and ``native`` equal ``rounds``;
      ``rounds`` + refine keeps each topic's count spread <= 1 and its peak
      <= the greedy one, equals the port's CPU path and ``scan`` + refine;
   e. the fault ladder at BASELINE config 5: first the watchdog's cost,
      ``assign()`` at configs 5 and 3 ``rounds`` with the default deadline
      and with ``solve.timeout.ms=0`` (inline) in turns (medians of 2
      each); then assignors (``rounds``, host rung on,
      ``breaker.failures=1``, an hour's cooldown, ``solve.timeout.ms`` 10x
      the config-5 solve median, at least 1 s) through legs (a) and (b) at
      config 5 and (c)-(g) at config 5 cut to ``LADDER_P`` partitions (the
      host rung's Python greedy takes ~18-25 s a leg at the full 100,000):
      (a) no fault:
      K1 launches, the ``assign.solve`` span histogram grows by one; (b) a
      ``device.solve`` raise and (c) a ``device.compile`` raise: no K1
      launch, the host rung's answer equal to (a)'s (b) or to (f)'s (c),
      the rung counter +1,
      one ``rebalance`` flight record, with ``fallback_used``, and two
      dumps (the breaker's trip and the ladder's)
      (the breaker, opened by the one failure, is reset after each); (d) a
      ``device.solve`` hang of twice the deadline: a solve timeout, the
      breaker open, the host's answer; (e) no fault with the breaker open:
      rejected without running, no K1 launch, the host's answer; (f) after
      ``reset_accelerator()``: K1 launches, and (c)-(e)'s host answers
      equal its bits; (g) ``host.fallback=false`` with a ``device.solve``
      raise: ``assign()`` raises ``FaultError``.  Each abandoned worker is
      waited for.  Then the streaming engine at config 5 under a
      ``device.corrupt.choice`` plan: the cold epoch adopts a flipped
      resident choice, the next epoch's refine dispatch (K6 launched)
      raises ``CorruptStateDetected`` and the quarantine counter moves, the
      epoch after heals; both equal the port's CPU engine at the card's
      bucket;
   f. the sidecar: the port's ``AssignorService(port=0, device="cuda",
      host_fallback=False, metrics_port=0)`` through
      ``AssignorServiceClient`` over TCP: ``ping``; ``rounds``, ``global``
      and ``scan`` at config 5, each equal to phase 4a's answer (``scan``
      to ``rounds``), member lists in order, K1 (K7 for ``scan``)
      launched exactly once, ``fallback_used`` false and
      ``klba_ladder_rung_total{method=assign,rung=none}`` up by one;
      ``sinkhorn`` at configs 4 (K3) and 5 (K4, K5) with phase 4b's
      invariants; a stream with ``{"refine_iters": 512, "guardrail":
      1.25}`` replaying phase 4c's first 16 epochs (the cold start, the 10
      drift epochs, the 3 delta epochs as ``lag_delta`` from the client's
      ``LagDeltaTracker``, the second acked by ``AssignmentDeltaTracker``
      and so answered with an ``assignment_delta``, a stale
      ``base_epoch`` answered ``resync`` with the previous assignment, the
      member leaving (the epoch sent dense with ``encoding: "zlib"``) and
      one joining), every epoch's choice equal to phase 4c's bit for bit,
      K1 once for the cold chain and K6 once a refine dispatch;
      ``stream_flight`` (one record an epoch), ``recommend``, ``stats``
      (one live stream, every breaker closed, a linear solve recorded, the
      kernel rule) and ``klba_requests_total{method="stream_assign"}`` in
      the ``metrics`` Prometheus view and on ``GET /metrics``; four
      clients at once, 8 mixed requests each (config 3 ``rounds``,
      ``sinkhorn`` on 4 of config 3's topics, a stream of its own at
      config 3's shape), every answer equal to a lone client's, whose
      answers are held against a sidecar on the CPU (``rounds`` and the
      streams equal, ``sinkhorn`` to phase 4b's rule on both and a quality
      ratio within 2 % of the CPU's); the
      config-5 ``rounds`` round trip (median of 3), its bytes, the
      server's ``wire.assign`` and ``assign.solve`` spans and the stream
      epoch walls by type against phase 4c's; ``stop()`` leaves no service
      thread.  The sequential legs' launches count into the kernels line;
   g. boot and restart, at config 5's streaming shape (P 100,000, C 1,000,
      resident B 131,072), the host rung off: (a) in a fresh process,
      ``warmup(max_partitions=100_000, consumers=[1000], solvers=("rounds",
      "scan", "global", "stream", "sinkhorn"), device="cuda")`` returns a
      row for every job (the rows and seconds printed), and that process's
      first config-5 ``rounds`` ``assign()`` builds nothing
      (``compile_count()`` moves by 0); its wall is printed beside the first
      ``assign()`` of a second fresh process without the warm-up, and
      the warm-up launches every kernel (its sharded job, with a mesh
      manager, is phase 4i's); (b)
      sidecar A (``snapshot_path`` in a temporary directory) serves two
      streams through phase 4c's first 6 epochs (each equal to phase 4c's
      choice), ``drain`` over the wire writes the final snapshot and a
      request during the drain is answered ``DrainReject``; sidecar B boots
      on the same snapshot with ``recovery_prestack`` and
      ``recovery_warmup``: ``stats.lifecycle`` reports both streams
      recovered and pre-stacked, load outcome ``ok``, and each stream's next
      epoch equals phase 4c's epoch 7 bit for bit with no round-scan launch,
      one digest launch and no build; the boot's walls (recovery, pre-stack,
      recovery warm-up) and the first epochs' walls beside phase 4c's are
      printed; (c) on B, with the scrubber every 100 ms, one flipped bit of
      an idle stream's resident choice is caught by the scrubber's audit
      (``klba_scrub_failures_total{buffer="choice"}`` + 1, the stream
      quarantined), and its next epoch equals the uncorrupted stream's on
      the same lags; the audit's wall at B 131,072 (median of 5).  The
      phase's launches (both processes of (a) included) count into the
      kernels line.  Phases 4f and 4g run their sidecars with
      ``coalesce_max_batch=1`` (every epoch inline); phase 4h drives the
      coalescer;
   h. the megabatch coalescer, the host rung off: (a) ``bench.py``'s
      ``multistream_32g`` shape (32 streams, P 4,096, C 16, ``refine_iters``
      64, ``refine_threshold=None``, lags from seeds 6000 + g): 32 serial
      engines inline, then 32 engines through one ``MegabatchCoalescer``
      (batch cap 32): 2 warm-up waves, 4 timed waves, a locked delta wave
      (every row a delta), a ``coalesce.flush`` fault wave (every row
      re-run on the card's single-stream dispatch); every row equal to the
      serial engine's epoch, the roster locked after the first wave
      (re-stacks flat, roster hits counting), one batched K6 launch a wave,
      no build in the timed loop, serial and coalesced epochs/s and the
      mean batch size, and one profiled locked wave's device busy time and
      idle share; (b) the batched K6 at config 5's resident shape (4 rows
      of B 131,072, C 1,000, M 133) bit for bit against four single-row
      launches and the plain version, clean and with each corruption class
      in one row, and timed (event, alone, plain, bound); then four engines
      at config 5 (``refine_iters`` 512, guardrail 1.25) in one locked wave:
      every row equal to its inline twin, one K6 launch for the wave, its
      wall and idle share profiled; (c) the port's sidecar with
      ``coalesce_max_batch=32`` and four concurrent streams: every answer
      equal to an inline sidecar's, ``stats.coalesce`` filled in; (d)
      ``assign_stream_batch`` and ``assign_stream_global`` at config 3
      equal to the plugin's ``rounds`` / ``global`` answers, one K1
      launch each.  Its launches count into the kernels line, and it prints
      a JSON ``coalesce`` line;
   i. the P-sharded solve on virtual shards of the card (every shard's
      tensors on ``cuda:0``; every line says "virtual"): (a) K5 at Sb = 8,
      4, 2 and 1 superblocks (a shard of a 1-, 2-, 4- and 8-way mesh) on
      config 5's blocks at the duals its loop ends with, against its plain
      version and with each superblock's partial bit-equal to the Sb = 8
      launch's, each shape timed; (b) config 5's cold solve (``bench.py``'s
      100,000 x 1,000, Zipf 1.1, seed 5) at D = 1 (``solve_linear_sharded``
      on a one-shard mesh), 2 and 4 (``StreamingAssignor(num_consumers=
      1000, mesh_backend=manager)``): the linear duals' choices bit-equal
      across D, with 2 x D x rounds K5 launches and one K1 a solve, held to
      the card's single-device linear cold solve (equal, or every partition
      once, count spread <= 1, the additive bound and both quality ratios
      reported); the exchange program (the mode pinned to ``sinkhorn``) at
      D = 1 bit-equal to ``seed_reference`` + ``refine_assignment`` at the
      same budget, at D = 2 and 4 count spread <= 1 and quality within 10 %
      of the single-device cold chain's; at 65,536 x 256 the card's
      exchange program equal to the port's CPU run at D = 2 and 4; every
      engine leg fails if its manager degrades, ``sharded_solve`` is False
      or ``klba_sharded_dispatch_total`` does not move; (c) config 3's
      [256, 64] table through ``sharded.topics.assign_sharded`` on
      (topics, members) = (4, 1) and (2, 2), without and with a 16-round
      refine, bit-equal to ``assign_batched_rounds``, one K1 launch a shard;
      (d) the port's ``AssignorService(device="cuda", host_fallback=False,
      mesh_devices=4)`` on 4 virtual shards: a config-5 ``stream_assign``
      cold epoch answers ``sharded_solve: true`` equal to (b)'s D = 4
      linear choice, 3 warm epochs follow (the first rebuilds and places the
      resident state, one K6; the next two digest it with one K6 shard
      launch a shard), ``stats.mesh`` is filled in; then under a ``mesh.collective`` fault the manager degrades one rung
      (the series move) and the stream's cold epoch is single-device and
      valid; (e) with ``--sharded`` alone, the config-5 cold solves on the
      host clock (median of 3) at D = 1, 2, 4 for both programs beside the
      single-device cold solves, and one profiled D = 4 linear solve
      (device busy, idle share).  These are virtual shards on one card: the
      times measure the host loop over shards, not multi-GPU scaling.  Its
      launches of (b)-(d) count into the kernels line, and it prints a JSON
      ``sharded`` line;
   j. placement on 4 virtual shards of the card: (a) K6's shard entry
      (``state_digest_sharded``) on config 5's resident state at D = 1, 2,
      4, 8, clean and with each corruption class, bit for bit against the
      one-state K6 on the gathered state and its plain version, each
      shard's partial lanes and histogram against the plain shard version,
      C = 16,385 answered alike on both devices, and timed at D = 4 (event, alone,
      plain, bound); (b) a config-5 stream through
      ``StreamingAssignor(mesh_backend=manager)``: the sharded cold epoch,
      phase 4c's 10-epoch drift and 3 delta epochs, every epoch after the
      cold one bit-equal to a single-device engine seeded with the cold
      choice, the state placed in 4 shards of B/4 rows, the placement
      counter moved, one K6 shard launch a shard for each placed warm
      epoch, then a ``device.corrupt.choice`` drill caught and healed; (c)
      ``multistream_32g`` through a coalescer on a 4-way streams mesh and a
      (2, 2) 2-D mesh: every row equal to its serial engine, the roster
      placed 8 rows a device, the batched K6 once a device a locked wave,
      one device's locked rows through the batched K6 against its plain
      version (clean and one corrupted row), the locked waves' walls beside
      phase 4h's; (d) a ``mesh.collective``
      fault at the warm boundary degrades the manager and the epoch is
      answered.  It prints a JSON ``placement`` line;
   k. federation, three port sidecars
      (``AssignorService(device="cuda", host_fallback=False)``) in full
      mesh over loopback TCP: (a) ``bench.py``'s config 12 (3 shards x
      2,048, C 8, seed 0xFED12, 16 rounds): rung ``global`` on all three,
      quality within 5 % of the port's single-leader ``sinkhorn`` on the
      6,144 rows, every captured ``peer_sync`` payload lag-free, a full
      partition served ``last_good_global`` / ``local_only`` with zero
      request errors, a heal re-converged within 16 rounds, stale and
      fenced duals rejected and counted; every ``local_only`` answer of
      (a)-(c) (K1) equal bit for bit to the plain ``rounds`` path on the
      same rows (the port's CPU solve); (b) config 5 split round-robin by
      partition id over the three sidecars: rung ``global``, each shard's
      counts within floor / ceil, quality beside the single-leader
      config-5 ``sinkhorn``'s, the walls of ``federated_assign`` and of one
      exchange round, K3's event time and launches, ``round_local_shard``'s
      wall and refine rounds; (c) capacity 1:2:1 over the members: each
      shard's counts equal ``apportion_counts``; (d) K3 at the shards'
      U_pad against its plain version.  It prints a JSON ``federation``
      line.  The launches of 4j (b)-(d) and 4k (a)-(c) count into the
      kernels line;
   l. wide groups: one topic of 200,000 partitions (uniform lags, seed 0)
      subscribed by 20,000 members, above the 16,384 slots of K1's
      register network, through ``assign()`` with the host rung off:
      ``rounds`` (K1's cluster form) and ``global`` equal to the port's CPU
      solve (the plain version), ``scan`` (K7's cluster form) equal to
      ``rounds``, ``sinkhorn`` in linear mode (K4, K5, K1) with every
      partition once, count spread <= 1, a peak no worse than ``rounds``'
      and within total / C + max lag; a streaming cold epoch and two warm
      epochs (K1 cold, K6 in each refine) equal to the port's CPU engine;
      then every kernel held to its plain version at those shapes (K1 and
      K6, on the engine's resident state, bit for bit; K3, K4, K5 to the
      f32 tolerance) and timed there (event and device time alone, the
      plain version, the bound; for K3 and K5 the library yardstick, K5's
      one superblock at a time), the profiler's name of K1's and K7's
      kernel there checked against the form their width takes.  Every K1
      and K7 launch of its ``assign()`` and stream legs is named by form
      (the kernels line's ``wide_group_forms``; no scratch at 20,000).
      Its launches count into the kernels line, its differences into the
      kernels line's ``max_abs_err``, and it prints a JSON ``wide`` line;
   m. wide groups on every other path, at phase 4l's group and with its
      answers, the host rung off: (a) the sidecar over TCP:
      ``rounds``, ``scan``, ``global`` and linear ``sinkhorn`` each equal
      to phase 4l's in-process answer, then a stream through phase 4l's
      cold and two heated warm epochs (zlib both ways on the cold one,
      ``lag_delta`` on the warm ones, the second acked into an
      ``assignment_delta``), each equal to phase 4l's epoch; the bytes and
      round trips printed; (b) four streams of that shape (lags from seeds
      6000 + g, ``refine_iters`` 32, ``refine_threshold=None``) through
      ``MegabatchCoalescer(max_batch=4)``: a re-stack wave, two locked
      waves and a locked delta wave, every row equal to a serial engine's
      epoch, one batched K6 launch a wave, and K6's batched entry on the
      locked state [4 x B 262,144, C 20,000] bit for bit against its plain
      version and four single launches, timed; (c) the sharded duals at D
      = 1, 2, 4 virtual shards, A and B bit-identical across D, K5 at Sb
      8, 4, 2 on the group's blocks at those duals against its plain
      version and each superblock's bits equal to Sb 8's, timed; the
      exchange program at 65,536 x 20,000 (phase 4l's first lags), D 2,
      equal to its CPU run; the engine with the manager at D 4: its sharded
      cold epoch (K1 once, in the tail) equal to the one-shard solve; the
      topic axis, 16 topics x 25,000 partitions, 20,000 members, on (1, 1),
      (4, 1) and (2, 2), refine 0 and 16, each equal to (1, 1), and (1, 1)
      to ``assign_stream_batch`` (one K1 launch a shard, up to 16 clusters
      a launch); (d) that engine's two heated warm epochs and one delta
      epoch on its 4 placed shards, each equal to an unplaced engine
      seeded with the cold choice, and K6's shard entry on the placed
      state bit for bit against the one-state K6 and its plain version,
      timed; (e) three port sidecars with the group split round-robin three
      ways (66,667 / 66,667 / 66,666 rows), 16 rounds: rung ``global``,
      each shard count-balanced, quality within 7.5 % of phase 4l's
      ``sinkhorn`` (provisional: the JAX package's federation is 5.0 %
      from its leader at 10,000 members and 10 rows a member on the CPU),
      a partition answered on one sidecar
      ``last_good_global`` / ``local_only`` with zero request errors and
      healed, and K3's column
      form (``need="both"``) at one round's shape against its plain
      version, timed.  Every K1 and K7 launch is named by form: the
      cluster form, no scratch.  Its launches count into the kernels line
      (``wide_paths_forms`` there), its differences into ``max_abs_err``,
      and it prints a JSON ``wide_paths`` line;
   n. the fenced takeover, ``bench.py``'s ``handoff_storm`` at config 5's
      width: ``TAKEOVER_N`` (4) streams of 100,000 partitions x 1,000
      members (lags uniform in [0, 10^6) from ``default_rng(9000 + i)``,
      phase 4c's stream options), sidecars on the ``object`` backend (lease
      TTL 2 s, wait 30 s, explicit snapshots), ``coalesce_max_batch`` 4,
      the host rung off.  Sidecar A serves 4 serial cold chains (one K1
      each) and two
      concurrent warm waves through the coalescer (batched K6), snapshots
      and stops holding the lease; B boots with ``resync_max_inflight=2``
      and must report ``takeover_crash`` and 4 streams recovered, and its
      concurrent first-epoch storm must be valid, ``warm_restart`` and
      bit-equal to engines on the card seeded with A's choices, with no
      build and no K1, at most 2 dense rebuilds at once; A's stale write
      is then refused as fenced with the backend's version unmoved; B
      serves a second concurrent wave (equal to those engines' next
      epoch) and drains; C boots with ``recovery_prestack`` and must
      report ``takeover_drain`` within 5 s and 4 streams pre-stacked, and
      its storm must be bit-equal to its own baseline with no build and no
      dense rebuild.  Its launches count into the kernels line, and it
      prints a JSON ``takeover`` line (modes, waits, boot walls, streams
      recovered and pre-stacked, each storm's walls, faults, launches and
      builds, the fenced writes and overwrites);
   o. the scenario fleet and the trace plane (``bench.py``'s configs 16
      and 17) through the port's sidecars: (a) the whole corpus of
      ``kafka_lag_based_assignor_tpu_torch.scenarios`` (all 12 scenarios,
      fast or not: seeded traces composed with fault planes, replayed over
      the wire, each gated by its degradation envelope), every sidecar
      booted with the service kwargs its scenario gives it, so with the
      host rung ON (the faulted scenarios' envelopes allow rung
      ``host_snake``; every clean scenario's envelope has ``max_rung=
      "none"``, so a kernel fault there fails the run instead of falling
      back), the cross-axis mesh scenario on 8 virtual shards of the card:
      every envelope must hold, no answer may be invalid, and every steady
      phase must build nothing; the counts ``bench.py`` reports
      (scenarios, composed, crash-restart, served, sheds, invalid,
      quarantines, corruptions planted) are printed; (b) the corpus'
      ``skew_storm`` (``hot_skew_storm``, seed 1101) at config 5's width,
      100,000 partitions x 1,000 members, 10 epochs: every epoch valid, at
      rung ``none``, unshed, no build; its steady churn printed beside the
      envelope's 0.75 (set at 192 x 4: reported, not gated); (c) the
      tracing probe: the warm no-op epoch at config 5's shape
      (``refine_iters`` 64, threshold 1000), the traced scope against the
      flat request scope by ``bench.py``'s paired estimator, its marginal
      cost below 1 % of the epoch and no build in the traced loop; two
      port sidecars at P 2,048, C 8 with ``peer.partition`` injected after
      the hello: one joined trace of >= 2 segments, kept as anomalous; a
      coalescing sidecar (4 streams, 3 concurrent rounds): every request
      trace of the last round linked both ways to its ``coalesce.wave``
      trace.  Its launches count into the kernels line, and it prints a
      JSON ``scenarios`` line;
5. times, with CUDA events, medians of 30 runs after warm-up: each kernel
   alone at its main-path shape, its plain version on the card, the
   library yardstick where there is one, and its bound; the device time
   of each kernel alone (``torch.profiler``, by kernel name), of all the
   device work one call enqueues (kernels, memsets and copies: "all
   ops"), and of K3's library yardstick (all its ops), the round
   scan's at config 5 and at config 3 ``global`` with its time a round and
   a network stage, and K4's kernel launches a step; the streaming epoch
   walls by type (cold, and the medians of the
   no-op, warm-refine and delta epochs), the host reads of a warm epoch and
   one profiled warm-refine epoch; K7 alone at configs 5 and 3 and at the
   direct API's ``K7_TIMED`` shapes (event and device time, time a row,
   rounds x stages, bound; its plain version on the card, a median at
   config 3 and one call on the first 10,000 rows of config 5's processing
   order, equal to the kernel there and beside its time).

``python3 chip_smoke.py --cells`` measures the phase-4 cells after the
builds: the ``assign()`` wall on the host clock at config 5 (``rounds``,
``sinkhorn``, ``scan``, ``rounds`` + 16 refine rounds; medians of 3 after
one warm-up) and config 4 (``sinkhorn``; median of 30 after 3), split into
lag read, solve and the rest, then for each phase-4 cell one ``assign()``
under ``torch.profiler``: the device's busy time and its idle share of the
wall.

It prints the card's name and power limit, one JSON ``ladder`` line (phase
4e's legs, drill and watchdog cost), one JSON ``sidecar`` line (phase 4f's
walls and bytes), one JSON ``lifecycle`` line (phase 4g's warm-up rows,
boot, first epochs and scrub walls, and its launches), one JSON
``coalesce`` line (phase 4h's rates, walls, idle shares and K6 times), one
JSON ``sharded`` line (phase 4i's checks and K5 times by superblock count;
with ``--sharded``, the cold solves' walls and idle share), one JSON ``placement``, one JSON ``federation``,
one JSON ``wide``, one JSON ``wide_paths``, one JSON ``takeover`` and one
JSON ``scenarios`` line (phases 4j, 4k, 4l, 4m, 4n and 4o), one JSON
``profiler`` line (the profiler's clock skew
after the builds, around phase 4f and after phase 5, and its sessions
recorded and discarded), one JSON ``phases_s`` line (each phase's seconds,
phases 1 and 2 together), one JSON ``kernels`` line, and as its last line
``{"ok": true, "device": {...}}``.  Without a card it exits 1 and prints no
result.  ``python3 chip_smoke.py --wide`` runs, after the builds, phase 3's
checks past 16,384 consumers and phase 4l, and prints the ``wide`` line;
``--wide-paths`` runs, after the builds, phase 4l and then phase 4m, and
prints the ``wide_paths`` line; ``--takeover`` runs, after the builds, phase
4n alone and prints the ``takeover`` line; ``--scenarios`` runs, after the
builds, phase 4o alone and prints the ``scenarios`` line.

``python3 chip_smoke.py --coalesce`` runs phase 4h alone (after the builds)
and prints its ``coalesce`` line; ``--sharded`` runs phase 4i alone (after
the builds) and prints its ``sharded`` line; ``--placement`` and
``--federated`` run phases 4j and 4k alone (after the builds).  ``python3 chip_smoke.py --sidecar`` runs
phase 4f alone (after the builds,
phase 4a and one phase-4c run it is held to) and prints its ``sidecar``
line; ``--lifecycle`` runs phase 4g alone (after the builds and one
phase-4c run) and prints its ``lifecycle`` line (``--lifecycle-child warm
|cold`` is the fresh process of its step (a)).  ``--profiler-probe`` runs ``profiler_probe`` (torch.profiler's
device records in a fresh process; no build) and prints it as JSON.  Eight
more modes time kernels alone::

    python3 chip_smoke.py --k1-times           # phase 5's K1 times only
    python3 chip_smoke.py --k1-ab ROOT [ROOT ...]
    python3 chip_smoke.py --k7-times           # phase 5's K7 times only
    python3 chip_smoke.py --k7-ab ROOT [ROOT ...]
    python3 chip_smoke.py --k36-times          # K3 and K6 (and K4, K5 alone)
    python3 chip_smoke.py --k36-ab ROOT [ROOT ...]
    python3 chip_smoke.py --wide-times         # K3, K4, K5 wide and at configs 4, 5
    python3 chip_smoke.py --wide-ab ROOT [ROOT ...]

``--k36-times`` times K3 at the dedup shapes of configs 2 and 4 (``need``
load and colsum, through the public wrapper; a package without ``need``
computes both) and its library yardstick, K6 at config 5's resident
state, K4 and K5 alone at config 5, and the quality ratio of the dense
``sinkhorn`` cells (configs 2 and 4); where the package has two K3 forms,
each form alone at U = 1,024, 2,048, 4,096 and C = 16, 512, 1,024.
``--wide-times`` times K5 and K4 at phase 4l's blocks and K3 (``need=load``,
beside its plain version) at U 1,024 by 20,000 consumers, and the control
shapes K3 at config 4 (each ``need``) and K4, K5 at config 5, each with a
digest of its output's bits, then phase 4l's ``sinkhorn`` ``assign()``
(three walls on the host clock, and one profiled call's K4 and K5 device
time, with a digest of its assignment), and digests of phase 4l's
``rounds``, ``global`` and ``scan`` answers and stream epochs;
``--wide-ab`` fails if two checkouts' control digests (the configs' and
those answers') differ, or one checkout's digests at any shape.  The ``-ab``
modes run the matching ``-times`` mode once for each checkout ROOT,
in that order, each in a process that imports the port's package from
that ROOT (its kernels build under ROOT), for example a parent commit
unpacked with ``git archive`` beside this one: ``--k36-ab parent . .
parent``.  ``--device-share CFG SOLVER REFINE`` (REFINE 0 for none) prints
one phase-4 cell's profiled ``assign()`` as JSON: ``--cells`` runs it when
the cell's profiler sessions in its own process all lost their records.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from contextlib import ExitStack

import numpy as np
import torch

from kafka_lag_based_assignor_tpu_torch import native
from kafka_lag_based_assignor_tpu_torch.assignor import LagBasedPartitionAssignor
from kafka_lag_based_assignor_tpu_torch.models import sinkhorn
from kafka_lag_based_assignor_tpu_torch.ops import (
    _build,
    batched,
    dispatch,
    linear_ot,
    linear_ot_cuda,
    plan_stats,
    plan_stats_cuda,
    refine,
    rounds_cuda,
    scan_cuda,
    state_digest_cuda,
    streaming,
)
from kafka_lag_based_assignor_tpu_torch.ops.packing import (
    pad_bucket,
    pad_topic_rows,
    table_rows,
)
from kafka_lag_based_assignor_tpu_torch.ops.rounds_kernel import round_rows
from kafka_lag_based_assignor_tpu_torch.ops.scan_kernel import (
    pack_shift_for,
    sort_partitions_with,
)
from kafka_lag_based_assignor_tpu_torch.testing import (
    baseline_workload,
    broker_for,
    lag_rows,
    stream_drift,
    stream_lags0,
    zipf_lags,
)
from kafka_lag_based_assignor_tpu_torch.types import GroupSubscription, Subscription
from kafka_lag_based_assignor_tpu_torch.utils import scrub
from kafka_lag_based_assignor_tpu_torch.utils.observability import (
    count_constrained_bound,
)

# H100 SXM peaks (NVIDIA's data sheet): HBM3 bandwidth, and the non-tensor
# float32 rate, used for the kernel's int64 compare-exchanges, which have no
# published peak of their own (it over-states the integer rate, so the
# bound stays a lower bound).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# The exp rate: 16 ex2 results a clock on each SM (the multi-function
# unit's throughput for compute capability 9.0 in NVIDIA's CUDA programming
# guide), 132 SMs, 1.98 GHz boost clock.  One f32 exp is one ex2 after a
# multiply, so this bounds any softmax from below.
EXPS_PER_S = 16 * 132 * 1.98e9
REPEATS = 30
# The idle time on each side of a profiler step, on a session's first try:
# torch.profiler keeps a device record only when its timestamp falls inside
# the step's window on the host's clock, and the device's timestamps can
# sit off the host's (``profiler_skew``).  Each retry of a session that lost
# records pads four times as long, up to SKEW_PAD_S.
PROFILER_PAD_S = 0.1
# The pad of ``profiler_skew``, wide enough that the device records of an
# offset clock still fall inside its session, and the longest retry pad.
SKEW_PAD_S = 2.0
# Profiler sessions recorded and discarded (lost records) in this process.
SESSIONS = {"recorded": 0, "discarded": 0}
# nvidia-smi's name and power limit of the card, printed again beside the
# results (the build logs push the first print out of a short tail).
CARD = []
T_START = time.perf_counter()
# Each phase's seconds in the full run, by phase (``lap``).
PHASE_S = {}
# Dynamic shared memory a block may use on the H100 (227 KB).
SMEM_PER_BLOCK = 232448
# The f32 kernels' tolerance against their plain versions, relative to the
# largest entry: sums run in another order.
F32_TOL = 1e-5
SINKHORN_CONFIGS = (2, 4, 5)
# Duals iterations of an assign() (the tpu.assignor.sinkhorn.iters default).
LINEAR_ITERS = 24

# Every kernel's launch counter: (name, the object holding ``launches``).
COUNTERS = (
    ("rounds_scan", rounds_cuda.rounds_scan),
    ("plan_stats", plan_stats.plan_stats),
    ("superblock_partials", linear_ot_cuda.superblock_partials),
    ("mirror_prox_step", linear_ot_cuda.mirror_prox_step),
    ("state_digest", refine.state_digest),
    ("scan_greedy", scan_cuda.scan_greedy),
    ("state_digest_rows", refine.state_digest_rows),
    ("state_digest_sharded", refine.state_digest_sharded),
)
# The name each kernel has in the profiler (a substring of it): K5 is the
# pass K4 launches twice; K3's forms are klba_plan_stats_cluster,
# klba_plan_stats_pass and, above 1,024 consumers, klba_plan_stats_rows and
# _cols (the column form's two launches, as klba_linear_ot_pass_rows and
# _cols are K4's and K5's).
KERNEL_NAMES = {
    "rounds_scan": "rounds_scan_kernel",
    "plan_stats": "klba_plan_stats_",
    "superblock_partials": "klba_linear_ot_pass",
    "mirror_prox_step": "klba_linear_ot_pass",
    "state_digest": "digest_",
    "scan_greedy": "scan_greedy_kernel",
    "state_digest_rows": "digest_",
    "state_digest_sharded": "state_digest_shard_kernel",
}
# The streaming engine at BASELINE config 5, as bench.py drives it: P
# partitions, C consumers, and the warm epoch's exchange budget.
STREAM_P = 100_000
STREAM_C = 1000
STREAM_BUDGET = 512
# The parity solvers' quality mode in path d: tpu.assignor.refine.iters.
REFINE_ITERS = 16


def log(*parts) -> None:
    print(*parts, flush=True)


def lap(phase: str) -> None:
    """Record the seconds since the last lap (or the start) as ``phase``'s."""
    PHASE_S[phase] = time.perf_counter() - T_START - sum(PHASE_S.values())


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def reset_counts() -> None:
    for _, fn in COUNTERS:
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS}


# -- phase 1 ---------------------------------------------------------------


def environment() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda},"
        f" {torch.cuda.device_count()} visible)")
    log(smi)
    CARD.append(smi)
    return name


# -- phase 2 ---------------------------------------------------------------


def build() -> None:
    for name, seconds in _build.build_all().items():
        log(f"built csrc/{name}.cu in {seconds:.2f} s")
        log(_build.build_log(name).strip())
    t0 = time.perf_counter()
    native.load()
    log(f"built native/greedy.cpp with g++ into {native.library_path()} in "
        f"{time.perf_counter() - t0:.2f} s")


# -- phase 3 ---------------------------------------------------------------


def round_inputs(lags: np.ndarray, n_valid: np.ndarray, C: int, device,
                 rows: int | None = None):
    """Kernel inputs as the main path makes them: each topic's rows sorted
    into processing order and cut into rounds (gains, valid, totals0).
    ``rows`` bounds the rows the rounds cover (default the most valid
    rows of any topic; the quality solver's greedy leg covers every padded
    row)."""
    T, P = lags.shape
    lags_t = torch.from_numpy(lags).to(device)
    pids = torch.arange(P, dtype=torch.int32, device=device).expand(T, P)
    valid = torch.arange(P, device=device)[None, :] < torch.from_numpy(n_valid).to(device)[:, None]
    _, sl, sv = sort_partitions_with(lags_t, pids, valid, pack_shift=0)
    gains, ok, R, _ = round_rows(sl, sv, C, int(n_valid.max()) if rows is None else rows)
    return (
        gains.reshape(T, R, C).contiguous(),
        ok.reshape(T, R, C).to(torch.uint8).contiguous(),
        torch.zeros(C, dtype=torch.int64, device=device),
    )


#: log2 of the slot counts past the register network that phase 3 checks:
#: 32,768, 65,536 and 131,072 slots (the cluster form) and 262,144 (the
#: scratch form, the keys in device scratch).
WIDE_LOG_SLOTS = (15, 16, 17, 18)


def slot_form(slots: int) -> str:
    """The form K1 and K7 take at ``slots`` slots, as the CUDA sources pick
    it: "registers", "cluster" or "scratch"."""
    if slots <= rounds_cuda.REGISTER_SLOTS:
        return "registers"
    return "cluster" if slots <= rounds_cuda.CLUSTER_SLOTS else "scratch"


#: What each form's kernel name ends in, after ``KERNEL_NAMES``' prefix.
FORM_SUFFIX = {"registers": "<", "cluster": "_cluster<", "scratch": "_wide<"}


def slot_class_cases(rng, logs=tuple(range(15)) + WIDE_LOG_SLOTS):
    """Two cases at each slot count N = 1, 2, 4, ..., 16,384 (the register
    form), 32,768, 65,536 and 131,072 (the cluster form) and 262,144 (the
    scratch form) (C not a power of two where C > 2, so every class has pad
    slots), and at C = 131,072 (the cluster form full) and 131,073 (the
    scratch form's least C): small lags, which admit the packed key, and
    lags from 2 to 4 times 2^(61 - rank_bits) over the rows, which force the
    two-key form.  The odd C of these takes the kernel's slot-at-a-time
    loads from 4,096 slots up; the ``_vector`` cases, at 4,096, 8,192 and
    32,768 slots (4, 8 and 2 a thread), have a C that is a multiple of that
    and must take its 16-byte loads and stores."""
    shapes = [(f"slots{1 << n}", {1: 1, 2: 2, 4: 3}.get(1 << n, (1 << n) // 2 + (1 << n) // 8 + 1))
              for n in logs]
    shapes += [("slots131072_full", 1 << 17), ("slots262144_least", (1 << 17) + 1)]
    vector = [("slots4096_vector", 3000), ("slots8192_vector", 6000),
              ("slots32768_vector", 20000)]
    shapes = [(n, c) for n, c in shapes + vector
              if rounds_cuda.slots_for(c).bit_length() - 1 in logs]
    for name, C in shapes:
        P = 3 * C + 5
        lo = 2 ** (62 - max(1, (C - 1).bit_length())) // P
        yield (f"{name}_packed", rng.integers(0, 10**6, (2, P)), np.full(2, P), C, False,
               None, "packed")
        yield (f"{name}_two_key", rng.integers(lo, 2 * lo, (2, P)), np.full(2, P), C, False,
               None, "two-key")


def kernel_cases():
    """(name, lags [T, P], valid rows per topic, C, carry across topics,
    rows the rounds cover or None, the key form it must take or None)."""
    rng = np.random.default_rng(7)

    def full(T, P):
        return np.full(T, P)

    # The quality solver's greedy leg at each sinkhorn cell: the padded
    # topic, every padded row scanned (ops/rounds_kernel.assign_topic_rounds
    # without n_valid).
    for config in SINKHORN_CONFIGS:
        lags, members = baseline_workload(config)
        lags_p, _, valid = pad_topic_rows(lags["t0"])
        yield (f"sinkhorn_greedy_config{config}", lags_p[None],
               np.array([int(valid.sum())]), len(members), False, lags_p.shape[0], None)
    yield ("config5_narrow", rng.integers(0, 20_000, (1, 100_000)),
           full(1, 100_000), 1000, False, None, None)
    yield ("config5_wide", rng.integers(2**20, 2**31, (1, 100_000)),
           full(1, 100_000), 1000, False, None, None)
    table = rng.integers(0, 1000, (256, 64))
    yield "config3_rounds", table, full(256, 64), 64, False, None, None
    # The cold chain of phase 4f's concurrent streams (config 3's shape,
    # the first client epoch's lags).
    yield ("config3_stream", zipf_lags(np.random.default_rng(3), 16384)[None],
           full(1, 16384), 64, False, None, None)
    yield "config3_global", table, full(256, 64), 64, True, None, None
    yield "one_consumer", rng.integers(0, 10**6, (4, 50)), full(4, 50), 1, False, None, None
    yield ("fewer_rows_than_consumers", rng.integers(0, 10**6, (3, 128)),
           np.array([100, 7, 1]), 700, False, None, None)
    yield "ties", rng.integers(0, 3, (8, 5000)), full(8, 5000), 300, False, None, None
    yield ("register_slots", rng.integers(0, 10**9, (2, 40_000)), full(2, 40_000),
           rounds_cuda.REGISTER_SLOTS, False, None, None)
    yield from wide_kernel_cases(rng, logs=tuple(range(15)) + WIDE_LOG_SLOTS)
    # Config 5's shape with lags near 2^40: the sum, about 2^56.6, passes
    # 2^51 (rank_bits 10) but stays below the 2^63 sentinel.
    yield ("config5_two_key", rng.integers(2**40 - 2**36, 2**40, (1, 100_000)),
           np.full(1, 100_000), 1000, False, None, "two-key")
    yield ("negative_gains", rng.integers(-1000, 10**6, (3, 3000)), np.full(3, 3000), 300,
           False, None, "two-key")


def wide_kernel_cases(rng, logs=WIDE_LOG_SLOTS):
    """The slot classes ``logs`` (by default those past the register
    network), then K1's cluster form on the ``global`` solve's carried
    rounds (4 topics of 30,000 rows, 20,000 consumers) and at one consumer
    above the register network's 16,384 slots."""
    yield from slot_class_cases(rng, logs)
    yield ("wide_global", rng.integers(0, 10**6, (4, 30_000)), np.full(4, 30_000), 20_000,
           True, None, None)
    yield ("register_slots_plus_one", rng.integers(0, 10**9, (2, 40_000)),
           np.full(2, 40_000), rounds_cuda.REGISTER_SLOTS + 1, False, None, None)


def scan_diff(got, want) -> int:
    """max |diff| over the (choice, totals) of two round scans."""
    return max(int((got[0].long() - want[0].long()).abs().max()),
               int((got[1] - want[1]).abs().max()))


def kernels_vs_plain(device, cases=None) -> int:
    """K1 bit for bit against its plain version: every case (of
    ``kernel_cases`` unless given) in the form ``packed_rank_bits`` gives it
    (through the wrapper) and, where that is the packed key, in the two-key
    form too; each launch twice, to the same bits.  Logs whether each launch
    moved its rows with vector loads or a slot at a time.  Returns max
    |diff| (0)."""
    worst = 0
    for name, lags, n_valid, C, carry, rows, form in (kernel_cases() if cases is None
                                                       else cases):
        gains, valid, totals0 = round_inputs(lags.astype(np.int64), n_valid, C, device,
                                             rows)
        rb = rounds_cuda.packed_rank_bits(gains, valid, totals0, carry)
        if form is not None and (rb > 0) != (form == "packed"):
            raise AssertionError(f"{name}: rank_bits {rb}, expected the {form} form")
        want = rounds_cuda.rounds_scan_torch(gains, valid, totals0, carry, rb)
        errs, io = {}, set()
        if rb:  # the plain version's two bodies agree
            errs["plain two-key"] = scan_diff(
                rounds_cuda.rounds_scan_torch(gains, valid, totals0, carry, 0), want)
        for key_rb in sorted({rb, 0}, reverse=True):
            first = (rounds_cuda.rounds_scan(gains, valid, totals0, carry) if key_rb == rb
                     else rounds_cuda._launch(gains, valid, totals0, carry, key_rb))
            again = rounds_cuda._launch(gains, valid, totals0, carry, key_rb)
            sync(device)
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError(f"rounds_scan {name}: two runs differ")
            errs["packed" if key_rb else "two-key"] = scan_diff(first, want)
            io.add("vector" if rounds_cuda.vector_io(gains, valid, first[0]) else "scalar")
        err = max(errs.values())
        worst = max(worst, err)
        log(f"kernel vs plain  {name:26s} T={gains.shape[0]} R={gains.shape[1]} "
            f"C={C} carry={carry} rank_bits {rb}: max |diff| {errs}, two runs equal, "
            f"{'/'.join(sorted(io))} loads")
        if err:
            raise AssertionError(f"rounds_scan disagrees with its plain version on {name}")
        if "_vector_" in name and io != {"vector"}:
            raise AssertionError(f"rounds_scan {name}: took {io} loads, not the vector path")
    return worst


def scan_cases():
    """(name, sorted lags [T, P], valid [T, P], C, eligible or None): K7's
    inputs, each topic's rows in processing order (lag descending, padding
    last) unless the name says otherwise."""
    rng = np.random.default_rng(17)

    def rows(T, P, lo=0, hi=10**6, n_valid=None):
        lags = -np.sort(-rng.integers(lo, hi, (T, P)), axis=1)
        n = np.full(T, P) if n_valid is None else np.asarray(n_valid)
        valid = np.arange(P)[None, :] < n[:, None]
        return np.where(valid, lags, 0), valid

    for C in (1, 2, 31, 32, 33, 1000, 1024, 1025, 16384):
        yield f"C{C}", *rows(2, min(3 * C + 7, 3000)), C, None
    yield from wide_scan_cases(rng)
    yield "all_zero_lags", *rows(2, 2000, 0, 1), 300, None
    # 12 rows of about 2^62 a consumer: the totals wrap past 2^63.
    yield "near_2^62", *rows(2, 600, 2**62 - 2**40, 2**62), 50, None
    yield "eligible_mask", *rows(3, 2500), 1000, rng.random(1000) < 0.5
    yield "none_eligible", *rows(2, 100), 40, np.zeros(40, bool)
    yield "padding_rows", *rows(4, 1500, n_valid=[1500, 1, 0, 777]), 100, None
    lags, valid = rows(2, 500)
    yield "padding_in_the_middle", lags, valid & (rng.random((2, 500)) < 0.8), 64, None
    yield "config3", *rows(256, 64, 0, 1000), 64, None
    # The direct API's eligible masks, a few of many consumers (E small
    # against C), and a batch of topics with their own valid lengths and
    # padding in the middle: K7_TIMED times these too.
    for E, C in ((1, 1000), (2, 1000), (33, 1000), (2, 16384)):
        mask = np.zeros(C, bool)
        mask[rng.choice(C, E, replace=False)] = True
        yield f"E{E}_of_C{C}", *rows(2, 4096), C, mask
    lags, valid = rows(4, 4096, n_valid=[4096, 3000, 1, 0])
    yield "padded_batch", lags, valid & (rng.random((4, 4096)) < 0.8), 100, None


def wide_scan_cases(rng=None):
    """K7 past the register network (more than 16,384 eligible consumers):
    20,000 consumers over two rounds and a part (packed key) and over one
    and a part (two-key form), one consumer above the register network,
    20,000 eligible of 24,000 (the cluster form at 32,768 slots); 65,537
    consumers over one round and a part (the cluster form at 131,072
    slots) and 131,072 eligible of 140,000 over one round and a part (its
    least full and the last cluster slot count, with a mask).  The cases in
    ``ROUND_HELD`` are held to ``scan_by_rounds``."""
    rng = np.random.default_rng(18) if rng is None else rng

    def rows(T, P, lo=0, hi=10**6):
        return -np.sort(-rng.integers(lo, hi, (T, P)), axis=1), np.ones((T, P), bool)

    yield "C20000", *rows(2, 2 * 20_000 + 7), 20_000, None
    yield "C20000_two_key", *rows(1, 20_000 + 7, 2**62 - 2**40, 2**62), 20_000, None
    yield "C16385", *rows(1, 16_385 + 9), 16_385, None
    mask = np.zeros(24_000, bool)
    mask[rng.choice(24_000, 20_000, replace=False)] = True
    yield "E20000_of_C24000", *rows(1, 20_011), 24_000, mask
    lags, valid = rows(2, 65_537 + 4_099)
    valid[1, 777] = False
    yield "E65537", lags, valid, 65_537, None
    mask = np.zeros(140_000, bool)
    mask[rng.choice(140_000, 131_072, replace=False)] = True
    yield "E131072_of_C140000", *rows(1, 131_072 + 777), 140_000, mask


#: K7's cases whose plain version, a torch step a row (about 0.35 ms each
#: on the card), would take 23-46 s: they are held to ``scan_by_rounds``.
ROUND_HELD = ("E65537", "E131072_of_C140000")


def scan_by_rounds(L, V, C: int, E):
    """K7's function by its round decomposition, on K1's plain version: per
    topic, the eligible consumers (``E`` a uint8 mask or None) and the valid
    rows compacted, ``rounds_scan_torch`` over [1, R, E] from zero totals in
    the two-key form (totals wrap), its positions mapped back to consumer
    indices.  Returns (choice, counts, totals) as ``scan_greedy_torch``."""
    T, P = L.shape
    dev = L.device
    ids = (torch.arange(C, device=dev) if E is None
           else torch.nonzero(E.bool()).flatten())
    n_eligible = ids.numel()
    choice = torch.full((T, P), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros((T, C), dtype=torch.int32, device=dev)
    totals = torch.zeros((T, C), dtype=torch.int64, device=dev)
    for t in range(T):
        rows = torch.nonzero(V[t].bool()).flatten()
        n = rows.numel()
        if n_eligible == 0 or n == 0:
            continue
        R = -(-n // n_eligible)
        gains = torch.zeros(R * n_eligible, dtype=torch.int64, device=dev)
        ok = torch.zeros(R * n_eligible, dtype=torch.uint8, device=dev)
        gains[:n], ok[:n] = L[t, rows], 1
        seat, tot = rounds_cuda.rounds_scan_torch(
            gains.view(1, R, n_eligible), ok.view(1, R, n_eligible),
            torch.zeros(n_eligible, dtype=torch.int64, device=dev))
        seat = seat.flatten()[:n].long()
        choice[t, rows] = ids[seat].int()
        counts[t, ids] = torch.bincount(seat, minlength=n_eligible).int()
        totals[t, ids] = tot[0]
    return choice, counts, totals


def scan_vs_plain(device, wide_only: bool = False) -> tuple:
    """K7 bit for bit against its plain version, each case launched twice
    to the same bits: the ``scan_cases`` against the plain version on the
    card (``ROUND_HELD`` against ``scan_by_rounds``), then the main path's
    inputs at configs 5 and 3 (``k7_cases``) against the plain version on
    CPU copies, timed on the host clock; any difference raises.
    ``wide_only``: the cases past the register network alone.
    Returns (the max |diff|, {config: the CPU plain version's ms})."""

    def check(name, L, V, C, E, want, where, lag_range=None):
        n_eligible, rb = scan_cuda.scan_plan(L, V, C, E)
        first = scan_cuda.scan_greedy(L, V, C, E)
        again = scan_cuda._launch(L, V, C, E)
        # A packed case also in the two-key form, which must give its bits.
        two_key = scan_cuda._launch(L, V, C, E, rank_bits=0) if rb else first
        # The main path's call: the plan from the host's range, no read.
        ranged = first
        if lag_range is not None:
            if scan_cuda.scan_plan(L, V, C, E, lag_range) != (n_eligible, rb):
                raise AssertionError(f"scan_greedy {name}: the host's range plans otherwise")
            ranged = scan_cuda.scan_greedy(L, V, C, E, lag_range=lag_range)
        sync(device)
        if not all(torch.equal(a, b) for x in (again, ranged) for a, b in zip(first, x)):
            raise AssertionError(f"scan_greedy {name}: two runs differ")
        for got in (first, two_key):
            if not all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, want)):
                raise AssertionError(f"scan_greedy disagrees with its plain version on {name}"
                                     f" (rank_bits {rb if got is first else 0})")
        log(f"kernel vs plain  scan_greedy {name:22s} T={L.shape[0]} P={L.shape[1]} C={C} "
            f"E={n_eligible} rank_bits {rb}: bit-equal to the plain version {where}"
            f"{' (and in the two-key form)' if rb else ''}, two runs equal, "
            f"{int((first[0] >= 0).sum())} rows assigned")

    for name, lags, valid, C, elig in (wide_scan_cases() if wide_only else scan_cases()):
        L = torch.from_numpy(lags.astype(np.int64)).to(device)
        V = torch.from_numpy(valid.astype(np.uint8)).to(device)
        E = None if elig is None else torch.from_numpy(elig.astype(np.uint8)).to(device)
        if name in ROUND_HELD:
            check(name, L, V, C, E, scan_by_rounds(L, V, C, E),
                  "as its round decomposition (on K1's plain version) on the card")
        else:
            check(name, L, V, C, E, scan_cuda.scan_greedy_torch(L, V, C, E), "on the card")
    cpu_ms = {}
    for name, sl, sv, C, lag_range in ([] if wide_only else k7_cases(device)):
        start = time.perf_counter()
        want = scan_cuda.scan_greedy(sl.cpu(), sv.cpu(), C)
        cpu_ms[name] = (time.perf_counter() - start) * 1e3
        check(f"main path {name}", sl, sv, C, None, want,
              f"on the CPU ({cpu_ms[name]!r} ms there)", lag_range)
    return 0, cpu_ms


def refine_batched_vs_cpu(device) -> None:
    """``refine_batched`` (16 rounds) on the card against the port's CPU
    path from the same greedy start, bit for bit: config 3 (T 256, where
    one partition a consumer leaves nothing to exchange), its shape with 16
    consumers (topics that stop in different rounds) and the config-5
    topic at its padded shape."""
    lags3, members3 = baseline_workload(3)
    table = np.stack([lags3[t] for t in sorted(lags3)])
    lags5, members5 = baseline_workload(5)
    cases = [("config 3", table, table.shape[1], len(members3)),
             ("config 3 shape, 16 consumers", table, table.shape[1], 16),
             ("config 5", pad_topic_rows(lags5["t0"])[0][None], lags5["t0"].size,
              len(members5))]
    for name, lags, n_valid, C in cases:
        T, P = lags.shape
        L = torch.from_numpy(lags).to(device)
        pids = torch.arange(P, dtype=torch.int32, device=device).expand(T, P).contiguous()
        V = (torch.arange(P, device=device) < n_valid).expand(T, P).contiguous()
        greedy = batched.assign_batched_rounds(L, pids, V, C)
        got = batched.refine_batched(L, V, greedy[0], C, REFINE_ITERS)
        want = batched.refine_batched(L.cpu(), V.cpu(), greedy[0].cpu(), C, REFINE_ITERS)
        for what, g, w in zip(("choice", "counts", "totals"), got, want):
            if not torch.equal(g.cpu(), w):
                raise AssertionError(f"refine_batched {name}: {what} differs from the CPU path")
        spread = int((got[1].amax(1) - got[1].amin(1)).max())
        peak_before, peak_after = int(greedy[2].amax()), int(got[2].amax())
        if spread > 1 or (got[2].amax(1) > greedy[2].amax(1)).any():
            raise AssertionError(f"refine_batched {name}: spread {spread} or a peak rose")
        log(f"refine_batched on the card = CPU path at {name} (T={T} P={P} C={C}): "
            f"{int((got[0] != greedy[0]).sum())} rows moved, peak {peak_before} -> "
            f"{peak_after}, count spread {spread}")


def native_vs_rounds(device) -> None:
    """``native.assign_native`` at config 5 equal to the ``rounds`` solve on
    the card, member list order included."""
    lags, members = baseline_workload(5)
    rows, subs = lag_rows(lags), {m: ["t0"] for m in members}
    t0 = time.perf_counter()
    got = native.assign_native(rows, subs)
    wall = (time.perf_counter() - t0) * 1e3
    if got != dispatch.assign_device(rows, subs, kernel="rounds", device=device):
        raise AssertionError("assign_native at config 5 differs from rounds on the card")
    log(f"assign_native at config 5 = rounds on the card ({wall:.3f} ms on the host)")


def f32_check(kind: str, name: str, got, want, again) -> float:
    """Hold one f32 kernel output to its plain version (module docstring's
    tolerance) and to a second run's bits; returns max |kernel - plain|."""
    worst, scale = 0.0, 0.0
    for g, w, a in zip(got, want, again):
        if not torch.equal(g, a):
            raise AssertionError(f"{kind} {name}: two runs differ")
        worst = max(worst, float((g - w).abs().max()))
        scale = max(scale, float(w.abs().max()))
    log(f"kernel vs plain  {kind:19s} {name:28s} max |diff| {worst!r} "
        f"(max |plain| {scale!r}, ratio {worst / scale if scale else 0.0!r})")
    if not worst <= F32_TOL * scale:
        raise AssertionError(f"{kind} disagrees with its plain version on {name}")
    return worst


def dedup_case(config: int, device, topic: str = "t0"):
    """The dedup weights of one topic of a BASELINE config, as the dense
    path makes them."""
    lags, members = baseline_workload(config)
    lags_p, _, valid = pad_topic_rows(lags[topic])
    return tuple(
        torch.from_numpy(a).to(device)
        for a in sinkhorn._dedup_weights(lags_p, valid, len(members))
    ), len(members)


def blocks_case(config: int, device, tile: int = 1024):
    """The mirror-prox row blocks of a BASELINE config: ws_b, cnt_b
    [8, tpb, tile], as the linear path makes them."""
    lags, members = baseline_workload(config)
    lags_p, _, valid = pad_topic_rows(lags["t0"])
    C = len(members)
    P2, t, _ = linear_ot.plan_shape(lags_p.shape[0], tile)
    ws, cnt = linear_ot._ws_cnt(
        torch.from_numpy(lags_p).to(device), torch.from_numpy(valid).to(device),
        sinkhorn._scale_np(lags_p, valid, C),
    )
    return (linear_ot._to_blocks(ws, P2, 8, t),
            linear_ot._to_blocks(cnt, P2, 8, t)), C


def random_duals(C: int, device, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(C, generator=g).mul_(0.3).to(device),
            torch.randn(C, generator=g).mul_(0.1).to(device))


def plan_stats_cases(device):
    """(name, ws_u, count_u, wsum_u, A, B): the dense path's shapes at
    configs 2 and 4, config 5's (the dedup cap), two of config 3's topics
    (phase 4f's concurrent ``sinkhorn`` requests), every U = 1, 17, 1,024,
    4,096 at every C = 1, 16, 31, 512, 1,000, 1,024, 1,025, 2,000, 16,384
    (C ascending), ``wide_plan_stats_cases`` and all-zero weights (at 100
    and at 2,000 consumers)."""
    g = torch.Generator().manual_seed(1)
    for config in (2, 4, 5):
        (ws, cnt, wsum), C = dedup_case(config, device)
        yield (f"config{config} U={ws.shape[0]} C={C}", ws, cnt, wsum,
               *random_duals(C, device))
    for topic in ("t000", "t015"):
        (ws, cnt, wsum), C = dedup_case(3, device, topic)
        yield (f"config3 {topic} U={ws.shape[0]} C={C}", ws, cnt, wsum,
               *random_duals(C, device))
    for C in (1, 16, 31, 512, 1000, 1024, 1025, 2000, 16384):
        for U in (1, 17, 1024, 4096):
            ws = torch.rand(U, generator=g).mul_(4.0)
            cnt = torch.randint(0, 5, (U,), generator=g).float()
            cnt[0] = 1.0  # at least one live row
            yield (f"random U={U} C={C}", *(x.to(device) for x in (ws, cnt, ws * cnt)),
                   *random_duals(C, device, U + C))
    yield from wide_plan_stats_cases(device)
    zeros = torch.zeros(64, device=device)
    for C in (100, 2000):
        yield f"all-zero weights U=64 C={C}", zeros, zeros, zeros, *random_duals(C, device)


def wide_plan_stats_cases(device):
    """K3's column form past 16,384 consumers: C = 16,385 (17 column tiles,
    the last one consumer wide), 20,000 (phase 4l's group) and 60,000, at U
    = 17 and 1,024."""
    g = torch.Generator().manual_seed(4)
    for C in (16385, 20000, 60000):
        for U in (17, 1024):
            ws = torch.rand(U, generator=g).mul_(4.0)
            cnt = torch.randint(0, 5, (U,), generator=g).float()
            cnt[0] = 1.0
            yield (f"random U={U} C={C}", *(x.to(device) for x in (ws, cnt, ws * cnt)),
                   *random_duals(C, device, U + C))


def plan_stats_vs_plain(device, cases=None) -> float:
    """K3 against its plain version at every case of ``plan_stats_cases``,
    in each ``need`` and each form that takes the shape, every launch twice
    to the same bits, and the marginal asked for alone equal bit for bit to
    its ``need="both"`` value.  Returns max |kernel - plain|."""
    worst = 0.0
    for name, *args in (plan_stats_cases(device) if cases is None else cases):
        U, C = args[0].shape[0], args[3].shape[0]
        forms = ["cluster", "pass"] if C <= plan_stats_cuda.REG_COLS else ["columns"]
        chosen = plan_stats_cuda.form_for(U, C)
        ratios = {}
        for form in forms:
            both = None
            for need in ("both", "load", "colsum"):
                got = (plan_stats.plan_stats(*args, need=need) if form == chosen
                       else plan_stats_cuda.launch(*args, need=need, form=form))
                again = plan_stats_cuda.launch(*args, need=need, form=form)
                want = plan_stats.plan_stats_torch(*args, need=need)
                if [g is None for g in got] != [w is None for w in want]:
                    raise AssertionError(f"plan_stats {name} {need}: returned {got}")
                pairs = [(g, w, a) for g, w, a in zip(got, want, again) if w is not None]
                err, scale = 0.0, 0.0
                for g, w, a in pairs:
                    if not torch.equal(g, a):
                        raise AssertionError(f"plan_stats {name} {need} {form}: two runs differ")
                    err = max(err, float((g - w).abs().max()))
                    scale = max(scale, float(w.abs().max()))
                if not err <= F32_TOL * scale:
                    raise AssertionError(f"plan_stats disagrees with its plain version on "
                                         f"{name} need={need} form={form}: {err} of {scale}")
                if need == "both":
                    both = got
                else:
                    i = 0 if need == "load" else 1
                    if not torch.equal(got[i], both[i]):
                        raise AssertionError(f"plan_stats {name} {form}: need={need} differs "
                                             f"from need=both")
                worst = max(worst, err)
                ratios[f"{form}/{need}"] = err / scale if scale else 0.0
        log(f"kernel vs plain  plan_stats {name:28s} (form {chosen}): max |diff| / max |plain| "
            + ", ".join(f"{k} {v:.3g}" for k, v in ratios.items())
            + "; two runs equal; alone = both")
    return worst


def loop_duals(ws_b, cnt_b, C: int, device):
    """The duals (A, B) the linear loop holds after its last step on these
    blocks: the main path's loop and iteration count, with the plain step.
    The duals grow along the loop, and with them the logits' magnitude."""
    eta = linear_ot.MIRROR_PROX_ETA
    A, B, rounds = linear_ot.mirror_prox(
        lambda A, B, sc, prev: linear_ot_cuda.mirror_prox_step_torch(
            ws_b, cnt_b, A, B, sc, prev, eta),
        C, LINEAR_ITERS, float(cnt_b.sum()), device=device)
    log(f"linear loop duals at config 5: {rounds} rounds, max |A| {float(A.abs().max())!r}, "
        f"max |B| {float(B.abs().max())!r}, max |ws * A| "
        f"{float(ws_b.max()) * float(A.abs().max())!r}")
    return A, B


def linear_cases(device):
    """(name, ws_b, cnt_b, A, B): config 5's blocks with C 1000 (its main
    path) at random duals and at the duals its loop ends with, and with C
    16; then edge shapes: C = 1, 2, 130, then 1,025, 2,000 and 16,384 (the
    column form, 2, 2 and 16 column tiles); trailing tiles all padding (65
    real rows in [8, 8, 64]) and all-zero weights, each at a register width
    and at a column width."""
    g = torch.Generator().manual_seed(2)
    (ws_b, cnt_b), C = blocks_case(5, device)
    yield f"config5 {list(ws_b.shape)} C={C}", ws_b, cnt_b, *random_duals(C, device)
    yield (f"config5 {list(ws_b.shape)} C={C} loop duals", ws_b, cnt_b,
           *loop_duals(ws_b, cnt_b, C, device))
    yield f"config5 {list(ws_b.shape)} C=16", ws_b, cnt_b, *random_duals(16, device, 16)
    for shape, C in (((8, 2, 8), 2), ((8, 4, 64), 130), ((8, 1, 8), 1), ((8, 1, 8), 1025),
                     ((8, 2, 8), 2000), ((8, 1, 8), 16384)):
        ws = torch.rand(shape, generator=g).mul_(3.0)
        cnt = (torch.rand(shape, generator=g) < 0.8).float()
        yield (f"random {list(shape)} C={C}", ws.to(device), cnt.to(device),
               *random_duals(C, device, C))
    ws = torch.zeros((8, 8, 64))
    cnt = torch.zeros((8, 8, 64))
    ws.view(-1)[:65] = torch.rand(65, generator=g).mul_(3.0)
    cnt.view(-1)[:65] = 1.0
    for C in (100, 2000):
        yield (f"65 real rows in [8, 8, 64] C={C}", ws.to(device), cnt.to(device),
               *random_duals(C, device, C))
    zeros = torch.zeros((8, 1, 8), device=device)
    for C in (5, 2000):
        yield f"all-zero weights [8, 1, 8] C={C}", zeros, zeros, *random_duals(C, device)


def tile_form(C: int) -> str:
    """The form the built row-tile pass of K3, K4 and K5 takes at C
    consumers: ``"registers"`` (A and B in a lane's registers) or ``"N
    column tiles"`` (the column form), from ``klba_row_tile_col_tiles``."""
    n = linear_ot_cuda._bind().klba_row_tile_col_tiles(C)
    return f"{n} column tiles" if n else "registers"


def linear_limits(device) -> dict:
    """Both linear-OT wrappers past 16,384 consumers against their plain
    versions: C = 16,385 (the last column tile one consumer wide), 20,000
    and 60,000, each run twice to the same bits.  Before that, the forms by
    width: the register forms up to 1,024 consumers, each within a block's
    shared memory, and the column form above with ceil(C / 1,024) column
    tiles, as ``plan_stats_cuda``'s geometry mirrors them.  Returns max
    |diff| by kernel."""
    lib = linear_ot_cuda._bind()
    widths = (1, 2, 16, 130, 1000, 1024, 1025, 2000, 16384, 16385, 20000, 38000, 57300,
              60000, 100000)
    smem = {c: lib.klba_row_tile_smem_bytes(c) for c in widths}
    tiles = {c: lib.klba_row_tile_col_tiles(c) for c in widths}
    if max(smem.values()) > SMEM_PER_BLOCK:
        raise AssertionError(f"row-tile shared memory {smem} above {SMEM_PER_BLOCK} bytes")
    want = {c: 0 if c <= plan_stats_cuda.REG_COLS else -(-c // plan_stats_cuda.COL_TILE)
            for c in widths}
    if tiles != want or any((smem[c] > 0) != (tiles[c] == 0) for c in widths):
        raise AssertionError(f"row-tile forms: column tiles {tiles}, smem {smem}; "
                             f"plan_stats_cuda's geometry expects {want}")
    log(f"row-tile shared memory by C (bytes): {smem}; column tiles by C: {tiles}")
    g = torch.Generator().manual_seed(5)
    worst = {"superblock_partials": 0.0, "mirror_prox_step": 0.0}
    for shape, C in (((8, 1, 8), 16385), ((8, 2, 64), 16385), ((8, 1, 8), 20000),
                     ((8, 2, 64), 20000), ((8, 1, 8), 60000), ((8, 2, 64), 60000)):
        ws = torch.rand(shape, generator=g).mul_(3.0).to(device)
        cnt = (torch.rand(shape, generator=g) < 0.8).float().to(device)
        A, B = random_duals(C, device, C)
        name = f"random {list(shape)} C={C} ({tile_form(C)})"
        got = linear_ot_cuda.superblock_partials(ws, cnt, A, B)
        again = linear_ot_cuda.superblock_partials(ws, cnt, A, B)
        want = linear_ot._superblock_partials(ws, cnt, A, B)
        worst["superblock_partials"] = max(worst["superblock_partials"], f32_check(
            "superblock_partials", name, got, want, again))
        scalars = (torch.tensor(1.0, device=device), torch.tensor(float("inf"), device=device))
        step = (ws, cnt, A, B, *scalars)
        got = linear_ot_cuda.mirror_prox_step(*step, eta=linear_ot.MIRROR_PROX_ETA)
        again = linear_ot_cuda.mirror_prox_step(*step, eta=linear_ot.MIRROR_PROX_ETA)
        want = linear_ot_cuda.mirror_prox_step_torch(*step, eta=linear_ot.MIRROR_PROX_ETA)
        worst["mirror_prox_step"] = max(worst["mirror_prox_step"], f32_check(
            "mirror_prox_step", name, got, want, again))
    return worst


def first_index_ties(device) -> None:
    """The quality path relies on torch.argmin / argmax returning the first
    index among ties on the card, as jnp.argmin / argmax do."""
    g = torch.Generator().manual_seed(3)
    x = torch.randint(0, 3, (64, 4096), generator=g).to(device)
    first = torch.arange(4096).expand(64, 4096)
    for got, hit in ((x.argmin(dim=1), x == x.min(dim=1, keepdim=True).values),
                     (x.argmax(dim=1), x == x.max(dim=1, keepdim=True).values)):
        want = torch.where(hit.cpu(), first, 4096).min(dim=1).values
        if not torch.equal(got.cpu(), want):
            raise AssertionError("argmin / argmax on the card do not take the first tie")
    log("argmin / argmax on the card take the first index among ties")


def quality_kernels_vs_plain(device) -> dict:
    """The f32 kernels against their plain versions; max |diff| by kernel."""
    first_index_ties(device)
    worst = {"plan_stats": plan_stats_vs_plain(device), "superblock_partials": 0.0,
             "mirror_prox_step": 0.0}
    for name, ws_b, cnt_b, A, B in linear_cases(device):
        got = linear_ot_cuda.superblock_partials(ws_b, cnt_b, A, B)
        again = linear_ot_cuda.superblock_partials(ws_b, cnt_b, A, B)
        want = linear_ot._superblock_partials(ws_b, cnt_b, A, B)
        worst["superblock_partials"] = max(
            worst["superblock_partials"],
            f32_check("superblock_partials", name, got, want, again),
        )
        for sc, prev in ((1.0, float("inf")), (0.5, 0.0)):
            scalars = (torch.tensor(sc, device=device), torch.tensor(prev, device=device))
            step = (ws_b, cnt_b, A, B, *scalars)
            got = linear_ot_cuda.mirror_prox_step(*step, eta=linear_ot.MIRROR_PROX_ETA)
            again = linear_ot_cuda.mirror_prox_step(*step, eta=linear_ot.MIRROR_PROX_ETA)
            want = linear_ot_cuda.mirror_prox_step_torch(
                *step, eta=linear_ot.MIRROR_PROX_ETA)
            worst["mirror_prox_step"] = max(
                worst["mirror_prox_step"],
                f32_check("mirror_prox_step", f"{name} sc={sc} prev={prev}",
                          got, want, again),
            )
    torch.cuda.synchronize()
    for k, v in linear_limits(device).items():
        worst[k] = max(worst[k], v)
    return worst


def resident_case(B: int, P: int, C: int, device, seed: int = 0):
    """A consistent resident state on ``device``: lags int64[B] (0 past P),
    a count-balanced choice over [:P] (-1 past it), and the row table and
    counts built from them."""
    rng = np.random.default_rng(seed)
    lags = np.zeros(B, np.int64)
    lags[:P] = rng.integers(0, 10**9, P)
    choice = np.full(B, -1, np.int32)
    choice[:P] = rng.permutation(np.arange(P) % C)
    lags_t, choice_t = torch.from_numpy(lags).to(device), torch.from_numpy(choice).to(device)
    tab, counts, _ = refine.build_choice_tables(
        lags_t, torch.arange(B, device=device) < P, choice_t, C, table_rows(B, C)
    )
    return lags_t, choice_t, counts, tab


def corrupted(kind: str, lags, choice, counts, tab, C: int):
    """Copies of the four buffers with one corruption class applied."""
    lags, choice, counts, tab = (t.clone() for t in (lags, choice, counts, tab))
    if kind == "choice -2":
        choice[7] = -2
    elif kind == "choice C":
        choice[9] = C
    elif kind == "choice C+5":
        choice[11] = C + 5
    elif kind == "counts +1":
        counts[-1] += 1
    elif kind == "counts -1":
        counts[0] -= 1
    elif kind == "table bit flip":
        tab[2, 1] ^= 1 << 5
    elif kind == "table slot names another row":
        tab[4, 0] = tab[4, 1]
    elif kind == "table sentinel":
        tab[1, int(counts[1])] = 0
    elif kind == "table row out of range":
        tab[5, 0] = -7
    elif kind == "lag sum wraps":
        lags[:4] = 2**62 + 3
    return lags, choice, counts, tab


DIGEST_KINDS = ("clean", "choice -2", "choice C", "choice C+5", "counts +1",
                "counts -1", "table bit flip", "table slot names another row",
                "table sentinel", "table row out of range", "lag sum wraps")


def digest_cases(device):
    """(name, lags, choice, counts, C, row_tab, P): config 5's resident
    shape clean and corrupted, phase 4f's concurrent streams' (config 3's
    shape, 16,384 rows and 64 consumers), then the edge shapes."""
    B = pad_bucket(STREAM_P)
    base = resident_case(B, STREAM_P, STREAM_C, device)
    for kind in DIGEST_KINDS:
        lags, choice, counts, tab = corrupted(kind, *base, STREAM_C)
        yield (f"config5 B={B} C={STREAM_C} M={tab.shape[1]} {kind}", lags, choice, counts,
               STREAM_C, tab, STREAM_P)
    for B, P, C, kind in ((16384, 16384, 64, "clean"), (16384, 16384, 64, "counts +1"),
                          (16384, 16384, 64, "table bit flip"),
                          (8, 5, 3, "clean"), (8, 5, 3, "counts +1"), (7, 5, 3, "clean"),
                          (1027, 1000, 24, "clean"), (1027, 1000, 24, "choice C+5"),
                          (1027, 1000, 24, "table bit flip"), (1024, 1000, 1, "clean"),
                          (65536, 3 * 16384, 16384, "clean"),
                          (65536, 3 * 16384, 16384, "choice C+5"),
                          (65536, 3 * 16384, 16384, "table sentinel"),
                          (4096, 4000, 24, "lag sum wraps")):
        lags, choice, counts, tab = corrupted(kind, *resident_case(B, P, C, device, B + C), C)
        yield f"B={B} C={C} M={tab.shape[1]} {kind}", lags, choice, counts, C, tab, P
    # M = 0: a table with no slots (lane 4 is then |0 - sum of assigned rows|).
    lags, choice, counts, _ = resident_case(1024, 1000, 24, device, 5)
    tab = torch.empty((24, 0), dtype=torch.int32, device=device)
    yield "B=1024 C=24 M=0 clean", lags, choice, counts, 24, tab, 1000
    yield from wide_digest_cases(device)


def wide_digest_cases(device):
    """K6 past 16,384 consumers: C = 20,000 (the histogram in shared
    memory) and 100,000 (in the scratch), clean and corrupted."""
    for B, P, C, kinds in ((65536, 60000, 20000, ("clean", "choice C+5", "counts +1",
                                                   "table sentinel")),
                           (262144, 250000, 100000, ("clean", "choice C", "table bit flip",
                                                     "lag sum wraps"))):
        base = resident_case(B, P, C, device, C)
        for kind in kinds:
            lags, choice, counts, tab = corrupted(kind, *base, C)
            yield (f"B={B} C={C} M={tab.shape[1]} {kind}", lags, choice, counts, C, tab, P)


def digest_plain(lags, choice, counts, C: int, tab):
    base = refine._state_digest_torch(lags, choice, counts, C)
    return torch.cat([base, refine._row_tab_lane_torch(lags, choice, tab, counts, C)[None]])


def digest_vs_plain(device, wide_only: bool = False) -> int:
    """K6 against its plain version, bit for bit (``wide_only``: the cases
    past 16,384 consumers alone); at those, its batched and shard entries
    too; returns max |diff| (0)."""
    worst = 0
    for name, lags, choice, counts, C, tab, P in (wide_digest_cases(device) if wide_only
                                                  else digest_cases(device)):
        got = refine.state_digest(lags, choice, counts, C, row_tab=tab)
        again = refine.state_digest(lags, choice, counts, C, row_tab=tab)
        four = refine.state_digest(lags, choice, counts, C)
        want = digest_plain(lags, choice, counts, C, tab)
        sync(device)
        err = int((got - want).abs().max())
        worst = max(worst, err)
        if not torch.equal(got, again):
            raise AssertionError(f"state_digest {name}: two runs differ")
        log(f"kernel vs plain  state_digest {name:52s}: {got.tolist()} max |diff| {err}, "
            f"two runs equal")
        if err or not torch.equal(four, want[:4]):
            raise AssertionError(f"state_digest disagrees with its plain version on {name}")
        if tab.shape[1] == 0:
            continue  # no table: the host check's lane 4 does not apply
        fails = scrub.digest_failures(got.cpu().numpy(), P, int(lags.sum()))
        if ("clean" in name or "wraps" in name) != (fails == []):
            raise AssertionError(f"state_digest on {name}: host check gave {fails}")
    return max(worst, wide_digest_entries(device))


def wide_digest_entries(device) -> int:
    """K6's batched and shard entries past 16,384 consumers, bit for bit:
    ``state_digest_rows`` over a clean and a corrupted state and
    ``state_digest_sharded`` over 2 and 4 row shards, against the plain
    version, at C = 20,000 (the histogram in shared memory) and 100,000 (in
    the scratch).  Returns max |diff| (0)."""
    worst = 0
    for B, P, C in ((65536, 60000, 20000), (262144, 250000, 100000)):
        clean = resident_case(B, P, C, device, C)
        bad = corrupted("choice C+5", *clean, C)
        want = torch.stack([digest_plain(*x[:3], C, x[3]) for x in (clean, bad)])
        got = refine.state_digest_rows(*(torch.stack([a, b]) for a, b in
                                        zip(clean[:3], bad[:3])), C,
                                       torch.stack([clean[3], bad[3]]))
        sync(device)
        err = int((got - want).abs().max())
        for D in (2, 4):
            offsets = [B // D * d for d in range(D)]
            shards = [torch.tensor_split(t, D) for t in clean[:2]]
            part = refine.state_digest_sharded(shards[0], shards[1], clean[2], C, clean[3],
                                               offsets)
            err = max(err, int((part.to(device) - want[0]).abs().max()))
        worst = max(worst, err)
        log(f"kernel vs plain  state_digest_rows / _sharded (D 2, 4) B={B} C={C}: "
            f"max |diff| {err}")
        if err:
            raise AssertionError(f"K6's batched or shard entry disagrees at C={C}")
    return worst


def drifted_resident(device):
    """A config-5 engine on ``device`` after its cold start, and the lags
    of six epochs of bench.py's drift (so the drain and the heat-up have
    happened): (engine, int64 lags)."""
    rng, lags0 = stream_lags0(STREAM_P)
    engine = stream_engine(device)
    choice = engine.rebalance(lags0)
    lags = lags0.astype(np.float64)
    for epoch in range(6):
        lags = stream_drift(rng, lags, epoch, choice, STREAM_C)
    return engine, lags.astype(np.int64)


def bulk_refine_vs_cpu(device) -> None:
    """The warm bulk refine (fan 8, budget 512, the engine's quality limit)
    on the card against the port's CPU path from the same drifted config-5
    resident state, bit for bit."""
    engine, lags = drifted_resident(device)
    choice_p, row_tab, counts, _ = engine._resident
    lags_p = streaming._pad_lags(torch.from_numpy(lags).to(device), choice_p.shape[0])
    totals = streaming._resident_totals(lags_p, row_tab, counts)
    limit = engine._quality_limit(count_constrained_bound(lags, STREAM_C),
                                  float(lags.sum(dtype=np.float64)))
    kw = dict(num_consumers=STREAM_C, iters=STREAM_BUDGET, max_pairs=min(STREAM_C // 2, 16),
              exchange_budget=STREAM_BUDGET, quality_limit=limit, bulk_transfer=True, fan=8)
    state = (lags_p, choice_p, row_tab, counts, totals)
    got = refine.refine_rounds_resident(*state, **kw)
    want = refine.refine_rounds_resident(*(t.cpu() for t in state), **kw)
    for name, g, w in zip(("choice", "row_tab", "counts", "totals"), got, want):
        if not torch.equal(g.cpu(), w):
            raise AssertionError(f"bulk refine on the card: {name} differs from the CPU path")
    if got[4:] != want[4:] or got[5] == 0:
        raise AssertionError(f"bulk refine: rounds/exchanges {got[4:]} vs CPU {want[4:]}")
    log(f"bulk refine on the card = CPU path at config 5 (B={choice_p.shape[0]}, "
        f"M={row_tab.shape[1]}, limit {limit!r}): {got[4]} rounds, {got[5]} exchanges, "
        f"peak {int(totals.max())} -> {int(got[3].max())}")


# -- phase 4 ---------------------------------------------------------------


def subscription(members, topics) -> GroupSubscription:
    return GroupSubscription({m: Subscription(tuple(topics)) for m in members})


def plugin(lags, members, solver, device, refine=None, **configs):
    """A configured assignor with its broker, and the assign() arguments;
    ``refine`` sets tpu.assignor.refine.iters.  The host rung is off
    (``tpu.assignor.host.fallback=false``) unless ``configs`` turn it on,
    so a kernel fault fails the run instead of hiding behind the host
    greedy; the watchdog keeps its default deadline (120 s) unless
    ``configs`` set one."""
    broker = broker_for(lags)
    assignor = LagBasedPartitionAssignor(lambda props: broker, device=device)
    configs = {"group.id": "chip-smoke", "tpu.assignor.solver": solver,
               "tpu.assignor.host.fallback": "false", **configs}
    if refine is not None:
        configs["tpu.assignor.refine.iters"] = str(refine)
    assignor.configure(configs)
    return assignor, broker.cluster(), subscription(members, sorted(lags))


def rung_count():
    """The host rung's counter; None for a package without the registry
    (a parent checkout under the ``-ab`` modes)."""
    try:
        from kafka_lag_based_assignor_tpu_torch.utils import metrics
    except ImportError:
        return None
    return metrics.REGISTRY.counter(
        "klba_ladder_rung_total", {"method": "assign", "rung": "host_greedy"}).value


def checked_assign(assignor, cluster, group):
    """One assign() that the device answered: ``fallback_used`` False and
    the host rung's counter unmoved."""
    rung = rung_count()
    out = assignor.assign(cluster, group)
    if getattr(assignor.last_stats, "fallback_used", False) or rung_count() != rung:
        raise AssertionError(f"{assignor.last_stats.solver}: answered by the host rung")
    return out


def assign_once(lags, members, solver, device, refine=None):
    assignor, cluster, group = plugin(lags, members, solver, device, refine)
    out = checked_assign(assignor, cluster, group)
    return {
        m: [(tp.topic, tp.partition) for tp in a.partitions]
        for m, a in out.group_assignment.items()
    }, assignor.last_stats


def main_path(device) -> tuple:
    """Path a: ``rounds`` and ``global``.  Returns (the round-scan launches
    counted from just before the path to just after it, the config-5
    answers by solver, which phase 4f holds the sidecar to)."""
    reset_counts()
    lags, members = baseline_workload(1)
    got, _ = assign_once(lags, members, "rounds", device)
    if got != {"C0": [("t0", 0)], "C1": [("t0", 2), ("t0", 1)]}:
        raise AssertionError(f"README example gave {got}")

    runs = [(cfg, solver) for cfg in (5, 3) for solver in ("rounds", "global")]
    workloads = {cfg: baseline_workload(cfg) for cfg in (5, 3)}
    results = {}
    for cfg, solver in runs:
        before = rounds_cuda.rounds_scan.launches
        results[cfg, solver] = assign_once(*workloads[cfg], solver, device)
        grew = rounds_cuda.rounds_scan.launches - before
        if device.type == "cuda" and grew < 1:
            raise AssertionError(f"config {cfg} {solver}: no round-scan launch")
    launches = read_counts()["rounds_scan"]

    for (cfg, solver), (got, stats) in results.items():
        lags, members = workloads[cfg]
        for topic in lags:
            counts = [sum(t == topic for t, _ in tps) for tps in got.values()]
            if max(counts) - min(counts) > 1:
                raise AssertionError(f"config {cfg} {solver}: spread > 1 on {topic}")
        want, _ = assign_once(lags, members, solver, torch.device("cpu"))
        if got != want:
            raise AssertionError(f"config {cfg} {solver}: differs from the CPU path")
        log(f"main path  config {cfg} {solver:6s}: {stats.num_partitions} partitions, "
            f"{stats.num_members} members, quality_ratio {stats.quality_ratio!r}, "
            f"wall {stats.wall_ms:.3f} ms (solve {stats.solve_ms:.3f} ms), "
            "equal to the CPU path")
    log(f"main path (rounds, global): rounds_scan launched {launches} times")
    return launches, {solver: results[5, solver][0] for solver in ("rounds", "global")}


def check_quality(label: str, lags, members, got, greedy_peak, linear: bool):
    """The quality solve's invariants on one single-topic result: every
    partition once, count spread <= 1, peak load no worse than greedy's
    and, in linear mode, within the additive bound.  Returns the peak."""
    arr = lags["t0"]
    held = {m: [p for _, p in tps] for m, tps in got.items()}
    if sorted(p for ps in held.values() for p in ps) != list(range(arr.size)):
        raise AssertionError(f"{label}: not every partition assigned exactly once")
    counts = [len(held[m]) for m in members]
    if max(counts) - min(counts) > 1:
        raise AssertionError(f"{label}: count spread {max(counts) - min(counts)}")
    peak = max(int(arr[ps].sum()) if ps else 0 for ps in held.values())
    if peak > greedy_peak:
        raise AssertionError(f"{label}: peak {peak} above greedy's {greedy_peak}")
    if linear:
        bound = linear_ot.additive_bound(arr, np.ones(arr.size, bool), len(members))
        if peak > bound:
            raise AssertionError(f"{label}: peak {peak} above the additive bound {bound}")
    return peak


def greedy_peak(lags, got) -> int:
    arr = lags["t0"]
    return max(int(arr[[p for _, p in tps]].sum()) if tps else 0 for tps in got.values())


def sinkhorn_path(device) -> dict:
    """Path b: ``sinkhorn`` at BASELINE configs 2, 4 and 5.  Returns every
    kernel's launches counted from just before the path to just after."""
    workloads = {cfg: baseline_workload(cfg) for cfg in SINKHORN_CONFIGS}
    peaks = {cfg: greedy_peak(workloads[cfg][0],
                              assign_once(*workloads[cfg], "rounds", device)[0])
             for cfg in SINKHORN_CONFIGS}
    reset_counts()
    results = {}
    for cfg in SINKHORN_CONFIGS:
        before = read_counts()
        got, stats = assign_once(*workloads[cfg], "sinkhorn", device)
        rounds = linear_ot.last_solve_info() if cfg == 5 else None
        again, _ = assign_once(*workloads[cfg], "sinkhorn", device)
        grew = {k: v - before[k] for k, v in read_counts().items()}
        needed = ["rounds_scan"] + (
            ["mirror_prox_step", "superblock_partials"] if cfg == 5 else ["plan_stats"])
        if device.type == "cuda" and any(grew[k] < 1 for k in needed):
            raise AssertionError(f"config {cfg} sinkhorn: launches {grew}, "
                                 f"needed {needed}")
        if got != again:
            raise AssertionError(f"config {cfg} sinkhorn: a second assign() differs")
        results[cfg] = (got, stats, grew, rounds)
    launches = read_counts()

    for cfg, (got, stats, grew, rounds) in results.items():
        lags, members = workloads[cfg]
        peak = check_quality(f"config {cfg} sinkhorn", lags, members, got,
                             peaks[cfg], linear=cfg == 5)
        cpu, cpu_stats = assign_once(lags, members, "sinkhorn", torch.device("cpu"))
        check_quality(f"config {cfg} sinkhorn (CPU)", lags, members, cpu,
                      peaks[cfg], linear=cfg == 5)
        log(f"main path  config {cfg} sinkhorn: {stats.num_partitions} partitions, "
            f"{stats.num_members} members, peak {peak} (greedy {peaks[cfg]}), "
            f"quality_ratio {stats.quality_ratio!r} (CPU path "
            f"{cpu_stats.quality_ratio!r}; same assignment: {got == cpu}), "
            f"wall {stats.wall_ms:.3f} ms (solve {stats.solve_ms:.3f} ms), "
            f"launches in two assign() {grew}"
            + (f", duals rounds {rounds['duals_rounds']}" if rounds else ""))
    log(f"main path (sinkhorn): launches {launches}")
    return launches


def topic_loads(lags, got) -> dict:
    """{topic: (count spread, peak member load)} of an assignment."""
    counts, loads = {}, {}
    for member, tps in got.items():
        for topic, p in tps:
            counts.setdefault(topic, {}).setdefault(member, 0)
            counts[topic][member] += 1
            loads.setdefault(topic, {}).setdefault(member, 0)
            loads[topic][member] += int(lags[topic][p])
    members = len(got)
    return {t: (max(c.values()) - (min(c.values()) if len(c) == members else 0),
                max(loads[t].values())) for t, c in counts.items()}


SOLVER_RUNS = (("rounds", None), ("scan", None), ("native", None), ("rounds", REFINE_ITERS),
               ("scan", REFINE_ITERS))


def solver_path(device) -> dict:
    """Path d: ``scan``, ``native``, and ``rounds`` and ``scan`` with 16
    refine rounds at BASELINE configs 5 and 3.  Every ``scan`` assign()
    launches K7; ``scan`` and ``native`` equal ``rounds``; ``rounds`` +
    refine keeps each topic's count spread <= 1 and its peak <= the greedy
    one, equals the port's CPU path, and equals ``scan`` + refine.  Returns
    every kernel's launches counted from just before the path to just
    after."""
    workloads = {cfg: baseline_workload(cfg) for cfg in (5, 3)}
    reset_counts()
    results = {}
    for cfg in (5, 3):
        for solver, refine_iters in SOLVER_RUNS:
            before = scan_cuda.scan_greedy.launches
            results[cfg, solver, refine_iters] = assign_once(*workloads[cfg], solver, device,
                                                             refine_iters)
            if (solver == "scan" and device.type == "cuda"
                    and scan_cuda.scan_greedy.launches - before < 1):
                raise AssertionError(f"config {cfg} scan: no scan_greedy launch")
    launches = read_counts()

    for cfg in (5, 3):
        lags, members = workloads[cfg]
        greedy, _ = results[cfg, "rounds", None]
        refined, _ = results[cfg, "rounds", REFINE_ITERS]
        for solver, refine_iters in SOLVER_RUNS[1:]:
            want = refined if refine_iters else greedy
            if results[cfg, solver, refine_iters][0] != want:
                raise AssertionError(f"config {cfg} {solver} refine {refine_iters}: differs "
                                     f"from rounds")
        before, after = topic_loads(lags, greedy), topic_loads(lags, refined)
        for topic, (spread, peak) in after.items():
            if spread > 1 or peak > before[topic][1]:
                raise AssertionError(f"config {cfg} rounds + refine: {topic} spread {spread}, "
                                     f"peak {peak} against greedy {before[topic][1]}")
        cpu, _ = assign_once(lags, members, "rounds", torch.device("cpu"), REFINE_ITERS)
        if cpu != refined:
            raise AssertionError(f"config {cfg} rounds + refine: differs from the CPU path")
        moved = sum(len(set(refined[m]) - set(greedy[m])) for m in greedy)
        for solver, refine_iters in SOLVER_RUNS:
            _, stats = results[cfg, solver, refine_iters]
            log(f"main path  config {cfg} {solver:6s} refine {refine_iters}: "
                f"quality_ratio {stats.quality_ratio!r}, wall {stats.wall_ms:.3f} ms (solve "
                f"{stats.solve_ms:.3f} ms), device {stats.device}")
        log(f"main path  config {cfg}: scan = native = rounds; scan + refine = rounds + refine "
            f"= the CPU path; refine moved {moved} partitions, peak "
            f"{max(p for _, p in before.values())} -> {max(p for _, p in after.values())}")
    log(f"main path (scan, native, refine): launches {launches}")
    return launches


def stream_engine(device):
    """The streaming engine as bench.py drives it at BASELINE config 5."""
    return streaming.StreamingAssignor(
        num_consumers=STREAM_C, refine_iters=STREAM_BUDGET, imbalance_guardrail=1.25,
        device=device,
    )


def heat(lags: np.ndarray, choice: np.ndarray, C: int) -> np.ndarray:
    """The lags with the partitions (at most 512) of the consumer at the
    median load scaled so that its total is 1.15x the refine threshold: the
    kept assignment needs a refine, and since the refine never raises the
    peak, the guardrail cannot trip (1.02 * 1.15 < 1.25)."""
    totals = np.bincount(choice, weights=lags, minlength=C)
    c = int(np.argsort(totals, kind="stable")[C // 2])
    rows = np.flatnonzero(choice == c)[:512]
    mean = lags.sum(dtype=np.float64) / C
    target = 1.15 * 1.02 * max(count_constrained_bound(lags, C), 1.0) * mean
    out = lags.copy()
    out[rows] = (lags[rows] * (target / totals[c])).astype(np.int64)
    return out


def outcomes(engine) -> dict:
    return {"delta": dict(engine.delta_epochs), "readback": dict(engine.rb_delta_epochs)}


class StreamRun:
    """The four streaming legs on one fresh engine, each epoch checked as it
    runs.  ``model`` tracks what the engine's resident state should be (live
    or stale, and the lags its host mirror holds), from which each epoch's
    delta and readback outcomes are predicted."""

    def __init__(self, device, bucket=None):
        self.device = device
        self.engine = stream_engine(device)
        if bucket is not None:  # the CPU engine at the card's padded shape
            self.engine._bucket = bucket
        self.records = []
        self.live, self.mirror = False, None

    def epoch(self, leg: str, lags: np.ndarray, corrupt: bool = False):
        """One rebalance; returns its choice (None when it raised, as a
        corrupted epoch must)."""
        engine, C = self.engine, self.engine.num_consumers
        launches, before = read_counts(), outcomes(engine)
        t0 = time.perf_counter()
        try:
            choice, raised = engine.rebalance(lags), None
        except scrub.CorruptStateDetected as exc:
            if not corrupt:
                raise
            choice, raised = None, exc.buffers
        sync(self.device)
        wall = (time.perf_counter() - t0) * 1e3
        s = None if raised else dataclasses.replace(engine.last_stats)
        grew = {k: v - launches[k] for k, v in read_counts().items()}
        moved = {side: {o: n - before[side][o] for o, n in d.items() if n != before[side][o]}
                 for side, d in outcomes(engine).items()}
        label = f"stream {leg} epoch {len(self.records)}"
        if corrupt:
            if raised is None or "choice" not in raised or not engine.quarantined:
                raise AssertionError(f"{label}: a flipped choice bit gave {raised}")
            refined, cold = True, False
        else:
            refined, cold = s.refined, s.cold_start
            counts = np.bincount(choice, minlength=C)
            if choice.min() < 0 or choice.max() >= C or counts.max() - counts.min() > 1:
                raise AssertionError(f"{label}: choice outside [0, C) or count spread > 1")
            if not cold and s.churn > 2 * STREAM_BUDGET + s.repaired_rows:
                raise AssertionError(f"{label}: churn {s.churn} past the budget's bound")
        # Predicted outcomes: a warm dispatch over a live resident plans a
        # delta upload (applied when at most 512 lags changed since the
        # mirror) and reads back O(changed); a stale resident is rebuilt.
        want = {"delta": {}, "readback": {}}
        if refined and self.live and (corrupt or s.repaired_rows == 0):
            n = int((lags != self.mirror).sum())
            want["delta"] = {"applied" if n <= 512 else "fallback": 1}
            want["readback"] = {} if corrupt else {"applied": 1}
        if moved != want:
            raise AssertionError(f"{label}: outcomes {moved}, expected {want}")
        if self.device.type == "cuda" and (
                grew["state_digest"] != int(refined) + int(cold)
                or grew["rounds_scan"] != int(cold)):
            raise AssertionError(f"{label}: launches {grew} for refined={refined} cold={cold}")
        if corrupt:
            self.live, self.mirror = False, None
        elif refined or cold:
            self.live, self.mirror = True, lags.copy()
        self.last_lags = lags
        kind = ("corrupt" if corrupt else "trip" if s.guardrail_tripped else "cold" if cold
                else "noop" if not refined else "delta" if moved["delta"].get("applied")
                else "refine")
        self.records.append((leg, kind, choice, s, moved, raised, wall))
        log(f"{label:28s} {kind:7s} wall {wall:9.3f} ms "
            + (f"raised CorruptStateDetected({raised})" if corrupt else
               f"churn {s.churn} repaired {s.repaired_rows} quality_ratio "
               f"{s.quality_ratio:.4f} rounds {s.refine_rounds} exchanges "
               f"{s.refine_exchanges}")
            + f" outcomes {moved} launches {grew}")
        return choice

    def remap(self, old_to_new: np.ndarray, C: int) -> None:
        self.engine.remap_members(old_to_new, C)
        self.live, self.mirror = False, None

    def run(self) -> "StreamRun":
        rng, lags0 = stream_lags0(STREAM_P)
        choice = self.epoch("schedule", lags0)
        lags = lags0.astype(np.float64)
        for e in range(10):  # bench.py's drift schedule
            lags = stream_drift(rng, lags, e, choice, STREAM_C)
            choice = self.epoch("schedule", lags.astype(np.int64))
        cur = lags.astype(np.int64)
        for _ in range(3):
            cur = heat(cur, choice, STREAM_C)
            choice = self.epoch("delta", cur)
        leave = np.arange(STREAM_C, dtype=np.int32) - (np.arange(STREAM_C) > STREAM_C // 2)
        leave[STREAM_C // 2] = -1
        self.remap(leave, STREAM_C - 1)
        choice = self.epoch("membership", cur)
        self.remap(np.arange(STREAM_C - 1, dtype=np.int32), STREAM_C)
        choice = self.epoch("membership", cur)
        # The drill: a live resident, one flipped bit of its choice tensor,
        # then the same lags twice: the first dispatch raises, the next heals.
        cur = heat(cur, choice, STREAM_C)
        choice = self.epoch("drill", cur)
        resident_choice = self.engine._resident[0]
        host = resident_choice[:STREAM_P].cpu().numpy()
        resident_choice[:STREAM_P].copy_(torch.from_numpy(scrub.flip_bit(host, seed=5)))
        cur = heat(cur, choice, STREAM_C)
        self.epoch("drill", cur, corrupt=True)
        self.epoch("drill", cur)
        if self.engine.quarantined or self.engine.needs_dense_resync:
            raise AssertionError("the epoch after the corrupted one did not heal")
        return self


def same_runs(a: StreamRun, b: StreamRun, what: str) -> None:
    """Two runs of the legs give the same bits at every epoch."""
    for i, (x, y) in enumerate(zip(a.records, b.records)):
        if not (x[0] == y[0] and np.array_equal(x[2], y[2]) and x[3] == y[3]
                and x[4:6] == y[4:6]):
            raise AssertionError(f"stream epoch {i} ({x[0]}): {what} differ")
    if len(a.records) != len(b.records):
        raise AssertionError(f"stream: {what} ran {len(a.records)} and {len(b.records)} epochs")
    log(f"stream: {what} give the same choice, stats and outcomes at all "
        f"{len(a.records)} epochs")


def streaming_path(device):
    """Path c: the streaming engine at full config 5.  Returns (the launches
    of the first run on the card, counted from just before it to just after,
    and the second run, whose walls phase 5 reports)."""
    reset_counts()
    first = StreamRun(device).run()
    launches = read_counts()
    log(f"main path (streaming): launches {launches}")
    second = StreamRun(device).run()
    same_runs(first, second, "two runs on the card")
    cpu = StreamRun(torch.device("cpu"), bucket=pad_bucket).run()
    same_runs(first, cpu, "the card and the CPU engine at the card's bucket")
    return launches, second


# -- phase 4e --------------------------------------------------------------

# Legs (c)-(g) of the ladder run config 5 cut to this many partitions: they
# drill the compile fault, the watchdog's timeout, the open breaker, its
# reset and the strict raise, and hold the host rung's answers to K1's at
# this size (legs (a) and (b) do that at the full 100,000); each host-rung
# leg at the full size costs ~18-25 s.
LADDER_P = 20_000


def join_abandoned_workers(timeout: float = 120.0) -> None:
    """Wait for the watchdog's abandoned ``klba-solve`` workers."""
    for t in threading.enumerate():
        if t.name == "klba-solve":
            t.join(timeout)
            if t.is_alive():
                raise AssertionError("an abandoned klba-solve worker is still running")


def ladder_series() -> dict:
    """The port registry's values that the ladder legs move."""
    from kafka_lag_based_assignor_tpu_torch.utils import metrics

    reg = metrics.REGISTRY
    return {
        "rung": rung_count(),
        "assign_solve_spans": reg.histogram("klba_span_duration_ms",
                                            {"span": "assign.solve"}).count,
        "timeouts": reg.counter("klba_solve_timeouts_total", {"key": "rounds"}).value,
        "rejected": reg.counter("klba_solve_rejected_total", {"key": "rounds"}).value,
        "flight_dumps": metrics.FLIGHT.dump_count(),
    }


def watchdog_call_overhead(device, calls: int = 200) -> dict:
    """What a call through the watchdog costs against the same call
    inline (host clock, median of ``calls`` each, in turns): a no-op, and
    one small launch with its host read on the caller's CUDA device and
    stream, entered as the plugin's solve enters them.  Microseconds."""
    from kafka_lag_based_assignor_tpu_torch.utils.device import carry_cuda_context
    from kafka_lag_based_assignor_tpu_torch.utils.watchdog import Watchdog

    wd = Watchdog(timeout_s=120.0)
    x = torch.zeros(1, device=device)
    ctx = carry_cuda_context(device)

    def launch():
        with ctx():
            return float(x.add(1).item())

    out = {}
    for name, fn in (("noop", lambda: None), ("launch_and_read", launch)):
        samples = {"worker": [], "inline": []}
        for i in range(2 * calls + 4):
            mode = ("worker", "inline")[(i + i // 2) % 2]
            t0 = time.perf_counter()
            wd.call(fn) if mode == "worker" else fn()
            if i >= 4:
                samples[mode].append((time.perf_counter() - t0) * 1e6)
        med = {m: statistics.median(v) for m, v in samples.items()}
        out[name] = {"worker_us": med["worker"], "inline_us": med["inline"],
                     "cost_us": med["worker"] - med["inline"], "n": calls}
    log(f"watchdog call overhead (medians of {calls} each, in turns): " + "; ".join(
        f"{k}: worker {v['worker_us']!r} us, inline {v['inline_us']!r} us" for k, v in
        out.items()))
    return out


def watchdog_cost(device, pairs: int = 2) -> dict:
    """``assign()`` at configs 5 and 3 ``rounds`` with the watchdog at its
    default (the solve in the ``klba-solve`` worker) and inline
    (``solve.timeout.ms=0``), in turns (w, i, i, w, ...) after one warm-up
    each: medians of the wall and the solve (host clock, ending in a
    synchronize), and their difference; and the cost of one watchdog call
    alone (``watchdog_call_overhead``)."""
    out = {"call_overhead": watchdog_call_overhead(device)}
    for cfg in (5, 3):
        lags, members = baseline_workload(cfg)
        runs = {"watchdog": plugin(lags, members, "rounds", device),
                "inline": plugin(lags, members, "rounds", device,
                                 **{"tpu.assignor.solve.timeout.ms": "0"})}
        if runs["inline"][0]._watchdog.timeout_s is not None:
            raise AssertionError("solve.timeout.ms=0 did not turn the watchdog off")
        samples = {mode: [] for mode in runs}
        for mode, (assignor, cluster, group) in runs.items():
            checked_assign(assignor, cluster, group)
        for i in range(2 * pairs):
            mode = ("watchdog", "inline")[(i + i // 2) % 2]
            assignor, cluster, group = runs[mode]
            t0 = time.perf_counter()
            checked_assign(assignor, cluster, group)
            sync(device)
            samples[mode].append(((time.perf_counter() - t0) * 1e3,
                                  assignor.last_stats.solve_ms))
        cell = {mode: {"wall_ms": statistics.median(w for w, _ in v),
                       "solve_ms": statistics.median(s for _, s in v), "n": len(v)}
                for mode, v in samples.items()}
        cell["solve_cost_ms"] = cell["watchdog"]["solve_ms"] - cell["inline"]["solve_ms"]
        cell["wall_cost_ms"] = cell["watchdog"]["wall_ms"] - cell["inline"]["wall_ms"]
        out[cfg] = cell
        log(f"watchdog cost  config {cfg} rounds (medians of {pairs} each, in turns): "
            f"worker wall {cell['watchdog']['wall_ms']!r} ms solve "
            f"{cell['watchdog']['solve_ms']!r} ms; inline wall {cell['inline']['wall_ms']!r} "
            f"ms solve {cell['inline']['solve_ms']!r} ms; solve difference "
            f"{cell['solve_cost_ms']!r} ms")
    return out


def ladder_legs(device, timeout_ms: int) -> dict:
    """Legs (a)-(g) of the fault ladder through port assignors (``rounds``,
    host rung on, ``breaker.failures=1``, an hour's cooldown,
    ``solve.timeout.ms`` = ``timeout_ms``): (a) and (b) on one at BASELINE
    config 5, (c)-(f) on one at config 5 cut to ``LADDER_P`` partitions,
    (g) on a strict one at that size; each checked as it runs.  Returns
    each leg's outcome, launches and wall."""
    from kafka_lag_based_assignor_tpu_torch.utils import faults, metrics

    knobs = {"tpu.assignor.host.fallback": "true", "tpu.assignor.breaker.failures": "1",
             "tpu.assignor.breaker.cooldown.ms": "3600000",
             "tpu.assignor.solve.timeout.ms": str(timeout_ms)}
    full = plugin(*baseline_workload(5), "rounds", device, **knobs)
    cut_lags, cut_members = baseline_workload(5, partitions=LADDER_P)
    cut = plugin(cut_lags, cut_members, "rounds", device, **knobs)
    hang_s = 2 * timeout_ms / 1e3
    legs, answers = {}, {}

    def leg(name, plan=None, run=full, ref="a"):
        assignor, cluster, group = run
        inj = None
        if plan is not None:
            inj = faults.FaultInjector(seed=9).plan(plan[0], plan[1], **plan[2])
        before, k1 = ladder_series(), rounds_cuda.rounds_scan.launches
        seq = max((r["seq"] for r in metrics.FLIGHT.records()), default=-1)
        t0 = time.perf_counter()
        raised = None
        try:
            if inj is None:
                out = assignor.assign(cluster, group)
            else:
                with faults.injected(inj):
                    out = assignor.assign(cluster, group)
            answers[name] = {m: [(tp.topic, tp.partition) for tp in a.partitions]
                             for m, a in out.group_assignment.items()}
        except faults.FaultError:
            raised = "FaultError"
        sync(device)
        wall = (time.perf_counter() - t0) * 1e3
        join_abandoned_workers()
        stats = assignor.last_stats
        rec = {"raised": raised, "wall_ms": wall,
               "partitions": sum(len(v) for v in cluster.partitions_by_topic.values()),
               "k1_launches": rounds_cuda.rounds_scan.launches - k1,
               **{k: v - before[k] for k, v in ladder_series().items()}}
        if raised is None:
            rec.update(fallback_used=stats.fallback_used, breaker_state=stats.breaker_state,
                       solve_ms=stats.solve_ms, same_as=ref,
                       same=answers[name] == answers[ref] if ref in answers else None,
                       flight_records=[(r["kind"], r.get("fallback_used"))
                                       for r in metrics.FLIGHT.records() if r["seq"] > seq])
        legs[name] = rec
        log(f"ladder leg ({name}) {json.dumps(rec)}")
        return rec

    def expect(name, ok: bool) -> None:
        if not ok:
            raise AssertionError(f"ladder leg ({name}): {legs[name]}")

    r = leg("a")
    expect("a", r["k1_launches"] >= 1 and not r["fallback_used"] and r["rung"] == 0
           and r["assign_solve_spans"] == 1 and r["breaker_state"] == "closed")
    # (b) at the full size, held to (a); (c) on the cut assignor, held to
    # (f) below.
    for name, point, run, ref in (("b", "device.solve", full, "a"),
                                  ("c", "device.compile", cut, "f")):
        r = leg(name, (point, "raise", {}), run=run, ref=ref)
        # The breaker trip dumps inside the request, the ladder's dump after
        # it (the JAX plugin's order): two dumps, one rebalance record.
        expect(name, r["k1_launches"] == 0 and r["fallback_used"]
               and r["same"] is not False
               and r["rung"] == 1 and r["flight_dumps"] == 2
               and r["flight_records"] == [("rebalance", True)]
               and r["breaker_state"] == "open")  # breaker.failures=1
        run[0].reset_accelerator()
    # (c)-(e) are answered by the host rung; (f), K1 after the reset, is the
    # answer they are held to, checked once it has run.
    r = leg("d", ("device.solve", "hang", {"delay_s": hang_s}), run=cut, ref="f")
    expect("d", r["k1_launches"] == 0 and r["fallback_used"] and r["timeouts"] == 1
           and r["breaker_state"] == "open" and r["rung"] == 1)
    r = leg("e", run=cut, ref="f")
    expect("e", r["k1_launches"] == 0 and r["fallback_used"] and r["rejected"] == 1
           and r["breaker_state"] == "open")
    cut[0].reset_accelerator()
    r = leg("f", run=cut, ref="f")
    expect("f", r["k1_launches"] >= 1 and not r["fallback_used"]
           and r["breaker_state"] == "closed" and r["rung"] == 0)
    for name in ("c", "d", "e"):
        legs[name]["same"] = answers[name] == answers["f"]
        expect(name, legs[name]["same"])
    strict = plugin(cut_lags, cut_members, "rounds", device)
    r = leg("g", ("device.solve", "raise", {}), run=strict)
    expect("g", r["raised"] == "FaultError" and r["k1_launches"] == 0 and r["rung"] == 0)
    return legs


def stream_drill(device) -> dict:
    """The streaming engine at config 5 under a ``device.corrupt.choice``
    plan: the cold epoch adopts a flipped resident choice, the next epoch's
    refine dispatch (K6) raises CorruptStateDetected and quarantines, the
    one after heals; the card's choices equal the port's CPU engine's at
    the card's bucket, epoch by epoch."""
    from kafka_lag_based_assignor_tpu_torch.utils import faults, metrics

    def quarantine(outcome):
        return metrics.REGISTRY.counter("klba_quarantine_total",
                                        {"buffer": "choice", "outcome": outcome}).value

    _, lags0 = stream_lags0(STREAM_P)
    runs = {}
    for dev in (device, torch.device("cpu")):
        engine = stream_engine(dev)
        if dev.type == "cpu":
            engine._bucket = pad_bucket
        q0 = (quarantine("quarantined"), quarantine("healed"))
        inj = faults.FaultInjector(seed=11).plan("device.corrupt.choice")
        with faults.injected(inj):
            c0 = engine.rebalance(lags0)
        lags1 = heat(lags0, c0, STREAM_C)
        k6 = refine.state_digest.launches
        t0 = time.perf_counter()
        try:
            engine.rebalance(lags1)
            raised = None
        except scrub.CorruptStateDetected as exc:
            raised = exc.buffers
        sync(dev)
        detect_ms = (time.perf_counter() - t0) * 1e3
        k6 = refine.state_digest.launches - k6
        q1 = (quarantine("quarantined"), quarantine("healed"))
        t0 = time.perf_counter()
        c2 = engine.rebalance(lags1)
        sync(dev)
        heal_ms = (time.perf_counter() - t0) * 1e3
        q2 = (quarantine("quarantined"), quarantine("healed"))
        runs[dev.type] = dict(
            c0=c0, c2=c2, raised=raised, k6=k6, detect_ms=detect_ms, heal_ms=heal_ms,
            fired=inj.fired("device.corrupt.choice"),
            quarantined=q1[0] - q0[0], healed=q2[1] - q1[1],
            healthy=not engine.quarantined and not engine.needs_dense_resync)
    card, cpu = runs[device.type], runs["cpu"]
    if not (card["fired"] == 1 and card["raised"] is not None and "choice" in card["raised"]
            and card["k6"] >= 1 and card["quarantined"] == 1 and card["healed"] == 1
            and card["healthy"]):
        raise AssertionError(f"stream corruption drill on the card: {card}")
    if not (np.array_equal(card["c0"], cpu["c0"]) and np.array_equal(card["c2"], cpu["c2"])
            and card["raised"] == cpu["raised"]):
        raise AssertionError("stream corruption drill: the card and the CPU engine differ")
    out = {k: card[k] for k in ("raised", "k6", "detect_ms", "heal_ms", "quarantined",
                                "healed")}
    log(f"stream corruption drill at config 5: {json.dumps(out)}; the cold and the "
        "healed epoch equal the CPU engine's at the card's bucket")
    return out


def ladder_path(device) -> tuple:
    """Phase 4e, the fault ladder on the card: the watchdog's cost, then,
    with every count set to 0, legs (a)-(g) and the streaming corruption
    drill at config 5.  Returns (the launches of the legs and the drill,
    the ``ladder`` line)."""
    cost = watchdog_cost(device)
    timeout_ms = int(math.ceil(max(10 * cost[5]["watchdog"]["solve_ms"], 1000.0)))
    reset_counts()
    legs = ladder_legs(device, timeout_ms)
    drill = stream_drill(device)
    launches = read_counts()
    join_abandoned_workers()
    log(f"main path (ladder): launches {launches}")
    return launches, {"config": 5, "legs_partitions": {"a-b": 100_000, "c-g": LADDER_P},
                      "solve_timeout_ms": timeout_ms, "legs": legs,
                      "stream_drill": drill, "watchdog_cost": cost}


# -- phase 4f --------------------------------------------------------------

# The sidecar's stream options: phase 4c's engine (refine_iters 512,
# guardrail 1.25) over the wire.
SIDECAR_STREAM_OPTS = {"refine_iters": STREAM_BUDGET, "guardrail": 1.25}
# Phase 4c's legs the sidecar replays, by epoch index: the cold start and
# the 10 drift epochs, 3 delta epochs, the member leaving and joining.
SIDECAR_EPOCHS = 16
# The config-5 ``assign`` round trips the sidecar's median is taken over.
SIDECAR_ROUND_TRIPS = 3


def wire_rows(arr: np.ndarray, pids=None) -> list:
    pids = range(arr.size) if pids is None else pids
    return [[int(p), int(v)] for p, v in zip(pids, arr.tolist())]


def wire_topics(lags) -> dict:
    return {topic: wire_rows(arr) for topic, arr in lags.items()}


def wire_answer(result) -> dict:
    return {m: [(t, int(p)) for t, p in tps] for m, tps in result["assignments"].items()}


def wire_choice(assignments, members) -> np.ndarray:
    """A single-topic stream answer as a choice vector: each partition's
    member index (the partition ids are 0..P-1)."""
    choice = np.full(sum(len(tps) for tps in assignments.values()), -1, dtype=np.int32)
    for i, m in enumerate(members):
        for _, p in assignments[m]:
            choice[p] = i
    return choice


def counted(fn):
    """(fn(), every kernel's launches during it): a sequential leg."""
    reset_counts()
    out = fn()
    return out, read_counts()


def add_counts(total: dict, grew: dict) -> None:
    for k, v in grew.items():
        total[k] += v


def at_once(label: str, calls: dict, timeout: float = 600.0) -> tuple:
    """Every ``calls[key]()`` on a thread of its own, all started together:
    ({key: result}, {key: its wall in ms}, the whole wall in ms).  Raises
    if a call raised or had not returned after ``timeout`` seconds."""
    got, walls, errors = {}, {}, []

    def one(key, fn):
        t0 = time.perf_counter()
        try:
            got[key] = fn()
        except Exception as exc:  # noqa: BLE001 — raised below
            errors.append(f"{key}: {exc!r}")
        walls[key] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=one, args=item, name=f"{label}-{item[0]}")
               for item in calls.items()]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    wall = (time.perf_counter() - t0) * 1e3
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"{label}: {errors or 'a call did not return'}")
    return got, walls, wall


def assign_rung(rung: str) -> int:
    from kafka_lag_based_assignor_tpu_torch.utils import metrics

    return metrics.REGISTRY.counter("klba_ladder_rung_total",
                                    {"method": "assign", "rung": rung}).value


def sidecar_assign(client, device, answers: dict, launches: dict) -> None:
    """``rounds``, ``global`` and ``scan`` at config 5 over TCP: each equals
    phase 4a's in-process answer (``scan`` the ``rounds`` one), member
    lists in order, launches K1 (K7 for ``scan``) exactly once, answers on
    the card (``fallback_used`` false) and moves the ``none`` rung by one."""
    lags, members = baseline_workload(5)
    params = {"topics": wire_topics(lags), "subscriptions": {m: ["t0"] for m in members}}
    for solver, want, kernel in (("rounds", answers["rounds"], "rounds_scan"),
                                 ("global", answers["global"], "rounds_scan"),
                                 ("scan", answers["rounds"], "scan_greedy")):
        rung = assign_rung("none")
        result, grew = counted(lambda: client.request("assign", {**params, "solver": solver}))
        add_counts(launches, grew)
        stats = result["stats"]
        if wire_answer(result) != want:
            raise AssertionError(f"sidecar config 5 {solver}: differs from phase 4a's answer")
        if (stats["fallback_used"] or stats["device"] != device.type
                or assign_rung("none") != rung + 1):
            raise AssertionError(f"sidecar config 5 {solver}: not answered on the card: {stats}")
        if device.type == "cuda" and (grew[kernel] != 1 or sum(grew.values()) != 1):
            raise AssertionError(f"sidecar config 5 {solver}: launches {grew}")
        log(f"sidecar  config 5 {solver:6s}: equal to phase 4a's answer; launches {grew}; "
            f"quality_ratio {stats['quality_ratio']!r}")


def sidecar_sinkhorn(client, device, launches: dict) -> None:
    """``sinkhorn`` over the wire at config 4 (the dense path: K3) and 5
    (the linear path: K4 and K5), each with phase 4b's invariants."""
    for cfg in (4, 5):
        lags, members = baseline_workload(cfg)
        peak = greedy_peak(lags, assign_once(lags, members, "rounds", device)[0])
        params = {"topics": wire_topics(lags), "subscriptions": {m: ["t0"] for m in members},
                  "solver": "sinkhorn"}
        result, grew = counted(lambda: client.request("assign", params))
        add_counts(launches, grew)
        needed = ["rounds_scan"] + (
            ["mirror_prox_step", "superblock_partials"] if cfg == 5 else ["plan_stats"])
        if result["stats"]["fallback_used"] or (
                device.type == "cuda" and any(grew[k] < 1 for k in needed)):
            raise AssertionError(f"sidecar config {cfg} sinkhorn: launches {grew}, "
                                 f"needed {needed}, stats {result['stats']}")
        got = check_quality(f"sidecar config {cfg} sinkhorn", lags, members, wire_answer(result),
                            peak, linear=cfg == 5)
        log(f"sidecar  config {cfg} sinkhorn: peak {got} (greedy {peak}), quality_ratio "
            f"{result['stats']['quality_ratio']!r}; launches {grew}")


class WireStream:
    """Phase 4c's legs replayed through ``stream_assign``: the client's
    ``LagDeltaTracker`` turns each epoch's lags into dense rows or a
    ``lag_delta``, ``AssignmentDeltaTracker`` holds the dense view (and
    acks it where asked), and every epoch is checked against the same epoch
    of phase 4c's run on the card."""

    def __init__(self, client, device, reference: StreamRun, launches: dict):
        from kafka_lag_based_assignor_tpu_torch.lag import (
            AssignmentDeltaTracker,
            LagDeltaTracker,
        )

        self.client, self.device = client, device
        self.reference, self.launches = reference, launches
        self.members = [f"c{i:04d}" for i in range(STREAM_C)]
        self.up, self.down = LagDeltaTracker(), AssignmentDeltaTracker()
        self.walls, self.shapes, self.epochs = [], [], 0

    def request(self, params: dict) -> dict:
        params = {"stream_id": "config5", "topic": "t0", "members": self.members,
                  "options": SIDECAR_STREAM_OPTS, **params}
        t0 = time.perf_counter()
        result, grew = counted(lambda: self.client.request("stream_assign", params))
        wall = (time.perf_counter() - t0) * 1e3
        add_counts(self.launches, grew)
        view = self.down.note_result(result, self.members)
        self.up.note_result(result)
        return result, view, grew, wall

    def epoch(self, lags: np.ndarray, ack: bool = False, encoding=None) -> np.ndarray:
        from kafka_lag_based_assignor_tpu_torch import service

        if encoding == "zlib":
            params = {"lags": service.encode_lags_zlib(wire_rows(lags)), "encoding": "zlib"}
            self.up.params_for(wire_rows(lags))  # the tracker's pending read
        else:
            params = self.up.params_for(wire_rows(lags))
        if ack:
            self.down.stamp(params)
        result, view, grew, wall = self.request(params)
        s = result["stream"]
        choice = wire_choice(view, self.members)
        leg, kind, want, ws, *_ = self.reference.records[self.epochs]
        label = f"sidecar stream epoch {self.epochs} ({leg}, {kind})"
        if not np.array_equal(choice, want):
            raise AssertionError(f"{label}: differs from phase 4c's choice")
        if (s["cold_start"], s["refined"], s["churn"], s["repaired_rows"]) != (
                ws.cold_start, ws.refined, ws.churn, ws.repaired_rows):
            raise AssertionError(f"{label}: stats {s} against phase 4c's {ws}")
        if s["fallback_used"] or self.device.type == "cuda" and (
                grew["state_digest"] != int(s["refined"]) + int(s["cold_start"])
                or grew["rounds_scan"] != int(s["cold_start"])):
            raise AssertionError(f"{label}: launches {grew} for {s}")
        shape = ("lag_delta" if "lag_delta" in params else encoding or "dense",
                 "assignment_delta" if "assignment_delta" in result else "dense")
        if ack and shape[1] != "assignment_delta":
            raise AssertionError(f"{label}: an acked epoch was answered dense")
        log(f"{label:44s} wall {wall:9.3f} ms up {shape[0]:9s} down {shape[1]:16s} "
            f"churn {s['churn']} quality_ratio {s['quality_ratio']:.4f} launches {grew}")
        self.walls.append((kind, wall))
        self.shapes.append(shape)
        self.epochs += 1
        return choice

    def stale_base(self) -> None:
        """A ``lag_delta`` on the epoch before the stream's: answered
        ``resync`` with the previous assignment, no device work."""
        held = wire_choice(self.down.assignments(self.members), self.members)
        epoch = self.reference.records[self.epochs - 1]
        result, view, grew, _ = self.request({"lag_delta": {
            "indices": [0], "values": [1], "base_epoch": 0}})
        if (not result["stream"]["resync"] or any(grew.values())
                or not np.array_equal(wire_choice(view, self.members), held)
                or not np.array_equal(held, epoch[2])):
            raise AssertionError(f"sidecar stream stale base: {result['stream']}, {grew}")
        log("sidecar stream stale base_epoch: resync with the previous assignment")

    def run(self) -> "WireStream":
        rng, lags0 = stream_lags0(STREAM_P)
        choice = self.epoch(lags0)
        lags = lags0.astype(np.float64)
        for e in range(10):  # bench.py's drift schedule, as phase 4c
            lags = stream_drift(rng, lags, e, choice, STREAM_C)
            choice = self.epoch(lags.astype(np.int64))
        cur = lags.astype(np.int64)
        for i in range(3):
            cur = heat(cur, choice, STREAM_C)
            choice = self.epoch(cur, ack=i == 1)
        self.stale_base()
        # Phase 4c's remaps by name: c0500 leaves (the later members shift
        # down by one), then c1000 joins at the end.
        self.members = [m for m in self.members if m != f"c{STREAM_C // 2:04d}"]
        self.epoch(cur, encoding="zlib")
        self.members = self.members + [f"c{STREAM_C:04d}"]
        self.epoch(cur)
        if self.epochs != SIDECAR_EPOCHS or ("lag_delta", "assignment_delta") not in self.shapes:
            raise AssertionError(f"sidecar stream: {self.epochs} epochs, {self.shapes}")
        return self


def sidecar_observability(client, svc, device) -> None:
    """``stream_flight`` (one record an epoch), ``recommend``, ``stats``
    and the registry over the wire and over plain HTTP."""
    import urllib.request

    flight = client.request("stream_flight", {"stream_id": "config5"})["records"]
    rec = client.request("recommend")["streams"]
    stats = client.request("stats")
    prom = client.request("metrics", {"view": "prometheus"})["prometheus"]
    host, port = svc.metrics_address
    with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=60) as r:
        scraped = r.read().decode()
    series = 'klba_requests_total{method="stream_assign"}'
    problems = [
        len(flight) != SIDECAR_EPOCHS and f"{len(flight)} flight records",
        "config5" not in rec and "recommend misses the stream",
        stats["live_streams"] != 1 and f"live_streams {stats['live_streams']}",
        any(b["state"] != "closed" for b in stats["breakers"].values()) and "a breaker open",
        stats["quality"]["last_linear_solve"] is None and "no linear solve recorded",
        set(stats["quality"]["kernel"].values()) != {device.type == "cuda"} and "kernel rule",
        series not in prom and "prometheus view", series not in scraped and "GET /metrics",
    ]
    if any(problems):
        raise AssertionError(f"sidecar observability: {[p for p in problems if p]}")
    log(f"sidecar observability: {len(flight)} flight records, recommend "
        f"{rec['config5']['recommended_consumers']} consumers, breakers "
        f"{sorted(stats['breakers'])} closed, requests {stats['requests_served']}, "
        f"GET /metrics {len(scraped)} bytes")


def comparable(result: dict, device: bool = True) -> dict:
    """An answer without its times (the stats' walls) and, with ``device``
    false, without the device that answered it."""
    dropped = ("wall_ms", "lag_read_ms", "solve_ms") + (() if device else ("device",))
    out = dict(result)
    if "stats" in out:
        out["stats"] = {k: v for k, v in out["stats"].items() if k not in dropped}
    return out


# Topics of config 3 in the concurrent leg's ``sinkhorn`` requests: the
# dense solve of one 64-partition topic is a host loop of small launches,
# and all 256 topics would hold four clients for minutes.
SIDECAR_SINKHORN_TOPICS = 4


def same_as_cpu(plan, lags, card: list, cpu: list) -> None:
    """The lone client's answers on the card against the same requests to
    a sidecar on the CPU (the plain versions): ``rounds`` and the streams
    equal (all but the answering device); ``sinkhorn`` held to phase 4b's
    rule on both (every partition of each topic once, each topic's count
    spread <= 1 and peak <= the ``rounds`` answer's) and to a quality ratio
    within 2 % of the CPU's."""
    greedy = topic_loads(lags, card[0]["assignments"])
    for i, ((kind, _), a, b) in enumerate(zip(plan, card, cpu)):
        if kind != "sinkhorn":
            if comparable(a, device=False) != comparable(b, device=False):
                raise AssertionError(f"sidecar concurrency: request {i} ({kind}) on the card "
                                     f"differs from the CPU sidecar's")
            continue
        for side, got in (("card", a), ("CPU", b)):
            held = {}
            for _, tps in got["assignments"].items():
                for t, p in tps:
                    held.setdefault(t, []).append(p)
            loads = topic_loads(lags, got["assignments"])
            bad = [t for t, ps in held.items() if sorted(ps) != list(range(lags[t].size))]
            bad += [t for t, (spread, peak) in loads.items()
                    if spread > 1 or peak > greedy[t][1]]
            if bad or len(held) != SIDECAR_SINKHORN_TOPICS:
                raise AssertionError(f"sidecar concurrency: sinkhorn on the {side}: topics "
                                     f"{bad[:4]} break phase 4b's rule, {len(held)} topics")
        qa, qb = a["stats"]["quality_ratio"], b["stats"]["quality_ratio"]
        if not qa <= 1.02 * qb:
            raise AssertionError(f"sidecar concurrency: sinkhorn quality ratio {qa} on the "
                                 f"card, {qb} on the CPU")
        log(f"sidecar concurrency: sinkhorn quality ratio {qa!r} on the card, {qb!r} on the "
            f"CPU; same assignment: {a['assignments'] == b['assignments']}")


def sidecar_concurrency(svc, clients: int = 4) -> dict:
    """Four clients at once, each 8 mixed requests (config 3 ``rounds``,
    ``sinkhorn`` on ``SIDECAR_SINKHORN_TOPICS`` of config 3's topics, and
    a stream of its own at config 3's shape, 16,384 partitions and 64
    consumers): every answer equals the one a lone client got for the same
    request, and the lone client's answers are held against a sidecar on
    the CPU (``same_as_cpu``).  Launch counts are not read here.  Returns
    the lone client's walls by request kind and the concurrent leg's
    wall."""
    from kafka_lag_based_assignor_tpu_torch import service

    lags, members = baseline_workload(3)
    subset = {t: lags[t] for t in sorted(lags)[:SIDECAR_SINKHORN_TOPICS]}
    assign = {
        "rounds": {"topics": wire_topics(lags), "solver": "rounds",
                   "subscriptions": {m: sorted(lags) for m in members}},
        "sinkhorn": {"topics": wire_topics(subset), "solver": "sinkhorn",
                     "subscriptions": {m: sorted(subset) for m in members}},
    }
    rng = np.random.default_rng(3)
    stream_lags = [zipf_lags(rng, 64 * len(lags)) for _ in range(4)]
    plan = [("rounds", None), ("sinkhorn", None), ("stream", 0), ("stream", 1),
            ("rounds", None), ("stream", 2), ("rounds", None), ("stream", 3)]
    walls = {}

    def run(address, sid, label=None):
        answers = []
        with service.AssignorServiceClient(*address, timeout_s=600) as c:
            for kind, e in plan:
                t0 = time.perf_counter()
                if kind == "stream":
                    r = c.request("stream_assign", {"stream_id": sid, "topic": "t0",
                                                    "members": members,
                                                    "lags": wire_rows(stream_lags[e])})
                else:
                    r = c.request("assign", assign[kind])
                walls.setdefault((label or sid, kind), []).append(
                    (time.perf_counter() - t0) * 1e3)
                answers.append(comparable(r))
        return answers

    want = run(svc.address, "alone")
    on_cpu = service.AssignorService(port=0, device="cpu", host_fallback=False,
                                     coalesce_max_batch=1).start()
    try:
        same_as_cpu(plan, lags, want, run(on_cpu.address, "alone", "cpu"))
    finally:
        on_cpu.stop()
    got, _, wall = at_once(
        "sidecar concurrency",
        {k: lambda k=k: run(svc.address, f"client{k}") for k in range(clients)}, timeout=900)
    for k, answers in got.items():
        for i, (a, b) in enumerate(zip(answers, want)):
            if a != b:
                raise AssertionError(f"sidecar concurrency: client {k} request {i} "
                                     f"({plan[i][0]}) differs from the lone client's")
    with service.AssignorServiceClient(*svc.address) as c:
        for sid in ["alone"] + [f"client{k}" for k in range(clients)]:
            c.stream_reset(sid)
    alone = {kind: statistics.median(w) for (sid, kind), w in walls.items() if sid == "alone"}
    cpu = {kind: statistics.median(w) for (sid, kind), w in walls.items() if sid == "cpu"}
    log(f"sidecar concurrency: {clients} clients x {len(plan)} requests equal to a lone "
        f"client's answers, which equal a CPU sidecar's, in {wall:.3f} ms; the lone "
        f"client's medians {alone}, on the CPU sidecar {cpu}")
    return {"requests": clients * len(plan), "wall_ms": wall, "alone_ms": alone,
            "cpu_sidecar_ms": cpu}


def sidecar_times(client, svc, launches: dict, stream: WireStream, reference: StreamRun) -> dict:
    """The config-5 ``rounds`` round trip through the client (median of
    ``SIDECAR_ROUND_TRIPS``), its request and response bytes on a raw
    connection, the server's ``wire.assign`` and ``assign.solve`` spans over
    those calls (registry
    log2-bucket p50, and the mean), and the stream epoch walls by type over
    the wire against phase 4c's in-process ones."""
    import socket

    from kafka_lag_based_assignor_tpu_torch.utils import metrics

    lags, members = baseline_workload(5)
    params = {"topics": wire_topics(lags), "subscriptions": {m: ["t0"] for m in members}}
    before = metrics.REGISTRY.snapshot()
    walls = []
    for _ in range(SIDECAR_ROUND_TRIPS):
        t0 = time.perf_counter()
        _, grew = counted(lambda: client.request("assign", params))
        walls.append((time.perf_counter() - t0) * 1e3)
        add_counts(launches, grew)
    spans = metrics.histogram_deltas(before, metrics.REGISTRY.snapshot())
    line = json.dumps({"id": 1, "method": "assign", "params": params}).encode() + b"\n"
    with socket.create_connection(svc.address, timeout=600) as sock, sock.makefile("rwb") as f:
        def exchange():
            f.write(line)
            f.flush()
            return f.readline()

        reply, grew = counted(exchange)
        add_counts(launches, grew)
    out = {"assign_round_trip_ms": statistics.median(walls), "assign_round_trips_ms": walls,
           "request_bytes": len(line), "response_bytes": len(reply)}
    for span in ("wire.assign", "assign.solve"):
        h = spans[f"klba_span_duration_ms{{span={span}}}"]
        if h["count"] != SIDECAR_ROUND_TRIPS:
            raise AssertionError(f"sidecar times: {h['count']} {span} spans for "
                                 f"{SIDECAR_ROUND_TRIPS} calls")
        out[span] = {"p50_bucket_ms": h["p50"], "mean_ms": h["sum"] / h["count"]}
    by_kind = {}
    for kind, wall in stream.walls:
        by_kind.setdefault(kind, {"wire": [], "in_process": []})["wire"].append(wall)
    for leg, kind, *_, wall in reference.records[:SIDECAR_EPOCHS]:
        by_kind[kind]["in_process"].append(wall)
    out["stream_epoch_ms"] = {
        kind: {"n": len(w["wire"]), "wire_p50": statistics.median(w["wire"]),
               "in_process_p50": statistics.median(w["in_process"])}
        for kind, w in sorted(by_kind.items())}
    log(f"sidecar times: config 5 rounds round trip p50 {out['assign_round_trip_ms']!r} ms "
        f"({len(line)} bytes up, {len(reply)} down); server wire.assign mean "
        f"{out['wire.assign']['mean_ms']!r} ms, assign.solve mean "
        f"{out['assign.solve']['mean_ms']!r} ms; stream epochs {out['stream_epoch_ms']}")
    return out


def service_threads() -> list:
    return [t.name for t in threading.enumerate()
            if t.name in ("klba-service", "klba-metrics-http")
            or "process_request_thread" in t.name]


def sidecar_path(device, answers: dict, reference: StreamRun) -> tuple:
    """Phase 4f, the sidecar on the card: the port's ``AssignorService``
    (host rung off, the ``/metrics`` listener on) through
    ``AssignorServiceClient`` over TCP.  Every sequential leg counts its
    launches from 0; the concurrent leg is not counted.  Returns (the
    launches, the ``sidecar`` line)."""
    from kafka_lag_based_assignor_tpu_torch import service

    launches = {name: 0 for name, _ in COUNTERS}
    # Every epoch inline (phase 4h drives the coalescer).
    svc = service.AssignorService(port=0, device=device, host_fallback=False,
                                  metrics_port=0, coalesce_max_batch=1).start()
    try:
        with service.AssignorServiceClient(*svc.address, timeout_s=900) as client:
            if not client.ping():
                raise AssertionError("sidecar: ping")
            sidecar_assign(client, device, answers, launches)
            sidecar_sinkhorn(client, device, launches)
            stream = WireStream(client, device, reference, launches).run()
            sidecar_observability(client, svc, device)
            concurrent = sidecar_concurrency(svc)
            times_ = sidecar_times(client, svc, launches, stream, reference)
    finally:
        svc.stop()
    for _ in range(100):
        if not service_threads():
            break
        time.sleep(0.05)
    if service_threads():
        raise AssertionError(f"sidecar: threads left after stop(): {service_threads()}")
    log(f"main path (sidecar): launches {launches}; service stopped, no thread left; "
        f"threads alive: {sorted(t.name for t in threading.enumerate())}")
    name = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    return launches, {"config": 5, "device": name, "concurrent": concurrent, **times_}


# -- phase 4g --------------------------------------------------------------

# The warm-up phase 4g runs at config 5's shape: the solvers, and the rows
# it must return (the stream job, one delta epoch at each K = 16..512 of
# the default ladder, the dense and the linear quality solve, the three
# batched solves).
LIFECYCLE_SOLVERS = ("rounds", "scan", "global", "stream", "sinkhorn")
LIFECYCLE_ROWS = (["stream"] + ["stream_delta"] * 6
                  + ["sinkhorn", "linear", "rounds", "scan", "global"])
# Phase 4c's epochs each stream of sidecar A serves before the drain; the
# restart's first epoch is phase 4c's next one, a warm refine.
LIFECYCLE_EPOCHS = 6
LIFECYCLE_SIDS = ("config5-a", "config5-b")
# The scrubber's cadence on sidecar B.
LIFECYCLE_SCRUB_MS = 100.0


def lifecycle_child(mode: str, device: str = "cuda") -> dict:
    """``--lifecycle-child warm|cold``, in a fresh process: with ``warm``
    the warm-up at config 5's shape first (every job must return a row),
    then the process's first config-5 ``rounds`` ``assign()``: its wall,
    its launches and the builds it paid (``compile_count()`` delta)."""
    from kafka_lag_based_assignor_tpu_torch.utils.observability import (
        compile_count,
        install_compile_counter,
    )
    from kafka_lag_based_assignor_tpu_torch.warmup import warmup

    out = {"mode": mode}
    install_compile_counter()
    if mode == "warm":
        reset_counts()
        t0 = time.perf_counter()
        rows = warmup(max_partitions=STREAM_P, consumers=[STREAM_C],
                      solvers=LIFECYCLE_SOLVERS, device=device)
        out["warmup_s"] = time.perf_counter() - t0
        out["warmup_launches"] = read_counts()
        # The batched K6 runs only in coalesced waves, which this warm-up
        # (coalesce_max_batch=1) does not drive, and K6's shard entry only on
        # a placed state, which it makes without a mesh manager neither.
        if device == "cuda" and not all(
                v for k, v in out["warmup_launches"].items()
                if k not in ("state_digest_rows", "state_digest_sharded")):
            raise AssertionError(f"warm-up: a kernel never launched: "
                                 f"{out['warmup_launches']}")
        out["rows"] = [list(r) for r in rows]
        if [r[0] for r in rows] != LIFECYCLE_ROWS:
            raise AssertionError(f"warm-up: rows {[r[0] for r in rows]}, expected "
                                 f"{LIFECYCLE_ROWS} (a job failed and was skipped)")
    lags, members = baseline_workload(5)
    builds = compile_count()
    reset_counts()
    t0 = time.perf_counter()
    _, stats = assign_once(lags, members, "rounds", torch.device(device))
    # The assign() call's own wall (its RebalanceStats), and with the
    # plugin's set-up (a 100k-partition FakeBroker and configure()).
    out["first_assign_ms"] = stats.wall_ms
    out["first_assign_with_setup_ms"] = (time.perf_counter() - t0) * 1e3
    out["first_assign_stats"] = {"lag_read_ms": stats.lag_read_ms, "solve_ms": stats.solve_ms}
    out["launches"] = read_counts()
    out["builds"] = compile_count() - builds
    if mode == "warm" and out["builds"] != 0:
        raise AssertionError(f"warm-up: the first assign() after it built {out['builds']} "
                             "kernels")
    return out


def lifecycle_child_run(mode: str) -> dict:
    argv = [sys.executable, os.path.abspath(__file__), "--lifecycle-child", mode]
    done = subprocess.run(argv, capture_output=True, text=True, timeout=400)
    lines = done.stdout.strip().splitlines()
    if done.returncode != 0 or not lines:
        raise AssertionError(f"lifecycle child {mode} exited {done.returncode}: "
                             f"{done.stdout[-3000:]}{done.stderr[-3000:]}")
    return json.loads(lines[-1])["lifecycle_child"]


def lifecycle_warmup() -> tuple:
    """4g (a): the warm-up in a fresh process and, in another, the first
    ``assign()`` without it.  Returns (the launches of both, the report)."""
    warm = lifecycle_child_run("warm")
    cold = lifecycle_child_run("cold")
    for row in warm["rows"]:
        log(f"lifecycle warm-up {row[0]:12s} T={row[1]:<4d} P={row[2]} C={row[3]} "
            f"{row[4]:.3f} s")
    log(f"lifecycle warm-up: {warm['warmup_s']:.3f} s in all; the first config-5 rounds "
        f"assign() after it {warm['first_assign_ms']:.3f} ms ({warm['builds']} builds), "
        f"without it {cold['first_assign_ms']:.3f} ms ({cold['builds']} builds; the "
        "libraries phase 2 built are on disk in both)")
    launches = {k: warm["warmup_launches"][k] + warm["launches"][k] + cold["launches"][k]
                for k in warm["launches"]}
    log(f"lifecycle warm-up launches {warm['warmup_launches']}")
    return launches, {"warm": warm, "cold": cold}


def reference_lags(reference: StreamRun, n: int) -> list:
    """The lags of phase 4c's first ``n`` epochs (the cold start, then
    bench.py's drift under the choice each epoch served)."""
    rng, lags0 = stream_lags0(STREAM_P)
    out, lags = [lags0], lags0.astype(np.float64)
    for e in range(n - 1):
        lags = stream_drift(rng, lags, e, reference.records[e][2], STREAM_C)
        out.append(lags.astype(np.int64))
    return out


def epoch_span_ms() -> tuple:
    from kafka_lag_based_assignor_tpu_torch.utils import metrics

    h = metrics.REGISTRY.histogram("klba_span_duration_ms", {"span": "stream.epoch"})
    return h.count, h.sum


class LifecycleClient:
    """One client of a phase-4g sidecar: dense config-5 stream epochs,
    each checked against the choice it must give, its launches counted
    and its walls kept (the round trip, and the engine's epoch from the
    server's ``stream.epoch`` span)."""

    def __init__(self, svc, launches: dict):
        from kafka_lag_based_assignor_tpu_torch import service

        self.device = svc.device
        self.client = service.AssignorServiceClient(*svc.address, timeout_s=600)
        self.members = [f"c{i:04d}" for i in range(STREAM_C)]
        self.launches = launches

    def epoch(self, sid: str, lags, want, label: str, expect=None) -> dict:
        n0, s0 = epoch_span_ms()
        t0 = time.perf_counter()
        result, grew = counted(lambda: self.client.stream_assign(
            sid, "t0", wire_rows(lags), self.members, options=SIDECAR_STREAM_OPTS))
        wall = (time.perf_counter() - t0) * 1e3
        n1, s1 = epoch_span_ms()
        add_counts(self.launches, grew)
        choice = wire_choice(result["assignments"], self.members)
        s = result["stream"]
        if want is not None and not np.array_equal(choice, want):
            raise AssertionError(f"{label} {sid}: differs from the choice it must give")
        if s["fallback_used"] or (expect is not None and self.device.type == "cuda" and {
                k: grew[k] for k in expect} != expect):
            raise AssertionError(f"{label} {sid}: launches {grew}, expected {expect}; {s}")
        epoch_ms = (s1 - s0) if n1 == n0 + 1 else None
        log(f"{label} {sid}: wall {wall:9.3f} ms (engine epoch {epoch_ms!r} ms) "
            f"cold_start {s['cold_start']} refined {s['refined']} warm_restart "
            f"{s['warm_restart']} churn {s['churn']} launches {grew}")
        return {"wall_ms": wall, "epoch_ms": epoch_ms, "choice": choice, "stream": s}

    def close(self) -> None:
        self.client.close()


def timed(fn, into: list):
    def run(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            into.append((time.perf_counter() - t0) * 1e3)
    return run


def lifecycle_restart(device, reference: StreamRun, root: str) -> tuple:
    """4g (b) and (c): sidecar A serves two streams through phase 4c's first
    ``LIFECYCLE_EPOCHS`` epochs and drains over the wire; sidecar B boots on its snapshot
    (pre-stack and recovery warm-up on), and each stream's next epoch is
    phase 4c's next epoch, bit for bit, with no cold chain and one digest;
    then B's scrubber catches a flipped bit of an idle stream's resident
    choice and the next epoch heals.  Returns (the launches, the report)."""
    from kafka_lag_based_assignor_tpu_torch import service
    from kafka_lag_based_assignor_tpu_torch import warmup as warmup_mod
    from kafka_lag_based_assignor_tpu_torch.utils import metrics
    from kafka_lag_based_assignor_tpu_torch.utils.observability import compile_count
    from kafka_lag_based_assignor_tpu_torch.utils.overload import ShedReject

    launches = {name: 0 for name, _ in COUNTERS}
    path = os.path.join(root, "snapshot.json")
    lags = reference_lags(reference, LIFECYCLE_EPOCHS + 2)
    rec = reference.records
    if not rec[LIFECYCLE_EPOCHS][3].refined:
        raise AssertionError(f"phase 4c's epoch {LIFECYCLE_EPOCHS + 1} is not a refine: the "
                             "restart check needs one")
    knobs = dict(port=0, device=device, host_fallback=False, snapshot_path=path,
                 snapshot_interval_s=3600.0, coalesce_max_batch=1)
    report = {}
    # (b) 1: sidecar A through phase 4c's first LIFECYCLE_EPOCHS epochs, then the drain.
    a = service.AssignorService(scrub_interval_ms=0, **knobs).start()
    client = LifecycleClient(a, launches)
    try:
        for k in range(LIFECYCLE_EPOCHS):
            for sid in LIFECYCLE_SIDS:
                client.epoch(sid, lags[k], rec[k][2], f"lifecycle A epoch {k}")
        t0 = time.perf_counter()
        drain = client.client.request("drain")
        if drain != {"state": "draining", "initiated": True}:
            raise AssertionError(f"lifecycle drain answered {drain}")
        try:
            client.client.stream_assign(LIFECYCLE_SIDS[0], "t0", wire_rows(lags[0]),
                                        client.members, options=SIDECAR_STREAM_OPTS)
            raise AssertionError("lifecycle: a request during the drain was admitted")
        except ShedReject as exc:
            if exc.rung != "draining":
                raise
            rejected = {"class": exc.klass, "rung": exc.rung,
                        "retry_after_ms": exc.retry_after_ms}
        if not a.wait_stopped(120):
            raise AssertionError("lifecycle: sidecar A did not finish its drain")
        report["drain_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        client.close()
        a.stop()
    with open(path, "rb") as f:
        doc = json.loads(f.read())
    if sorted(doc["sections"]["streams"]["body"]) != sorted(LIFECYCLE_SIDS):
        raise AssertionError("lifecycle: the final snapshot lacks a stream")
    report["snapshot_bytes"] = os.path.getsize(path)
    log(f"lifecycle: drained in {report['drain_ms']:.3f} ms; a request during the drain "
        f"was rejected {rejected}; final snapshot {report['snapshot_bytes']} bytes")
    # (b) 2: sidecar B on the same snapshot, its boot phases timed.
    b = service.AssignorService(scrub_interval_ms=LIFECYCLE_SCRUB_MS, recovery_prestack=True,
                                recovery_warmup=True, **knobs)
    prestack_ms, warmup_ms = [], []
    b._prestack_recovered = timed(b._prestack_recovered, prestack_ms)
    real_warmup = warmup_mod.warmup
    warmup_mod.warmup = timed(real_warmup, warmup_ms)
    reset_counts()
    try:
        t0 = time.perf_counter()
        b.start()
        boot_ms = (time.perf_counter() - t0) * 1e3
    finally:
        warmup_mod.warmup = real_warmup
    add_counts(launches, read_counts())
    client = LifecycleClient(b, launches)
    try:
        lc = client.client.request("stats")["lifecycle"]
        recovery = lc["recovery"]
        if (recovery["outcome"], recovery["streams_recovered"],
                recovery.get("streams_prestacked")) != ("ok", 2, 2):
            raise AssertionError(f"lifecycle: B recovered {recovery}")
        report["boot"] = {"start_ms": boot_ms, "recovery_ms": recovery["duration_ms"],
                          "prestack_ms": prestack_ms[0], "recovery_warmup_ms": warmup_ms[0],
                          "recovery": recovery}
        log(f"lifecycle B boot: start() {boot_ms:.3f} ms: recovery "
            f"{recovery['duration_ms']:.3f} ms, prestack {prestack_ms[0]:.3f} ms, recovery "
            f"warm-up {warmup_ms[0]:.3f} ms; {recovery}")
        # (b) 4: the next epoch of each stream is phase 4c's next one.
        builds = compile_count()
        ref = rec[LIFECYCLE_EPOCHS]
        first = {}
        for sid in LIFECYCLE_SIDS:
            got = client.epoch(sid, lags[LIFECYCLE_EPOCHS], ref[2],
                               f"lifecycle B epoch {LIFECYCLE_EPOCHS}",
                               expect={"rounds_scan": 0, "state_digest": 1})
            if not got["stream"]["warm_restart"] or got["stream"]["cold_start"]:
                raise AssertionError(f"lifecycle B {sid}: not a warm restart: {got['stream']}")
            first[sid] = {"wall_ms": got["wall_ms"], "epoch_ms": got["epoch_ms"]}
        if compile_count() != builds:
            raise AssertionError("lifecycle B: the first epochs after the restart built "
                                 f"{compile_count() - builds} kernels")
        warm = [r[6] for r in rec if r[1] == "refine"]
        report["first_epochs"] = first
        report["phase_4c"] = {"warm_refine_p50_ms": statistics.median(warm),
                              "cold_ms": rec[0][6], "epoch_11_ms": ref[6]}
        log(f"lifecycle B: first epochs after the restart {first}, bit-equal to phase 4c's "
            f"epoch {LIFECYCLE_EPOCHS + 1}, no build; phase 4c in-process: warm refine p50 "
            f"{report['phase_4c']['warm_refine_p50_ms']:.3f} ms, cold "
            f"{rec[0][6]:.3f} ms, its epoch {LIFECYCLE_EPOCHS + 1} {ref[6]:.3f} ms")
        report["scrub"] = lifecycle_scrub(b, client, lags[LIFECYCLE_EPOCHS + 1], metrics)
    finally:
        client.close()
        b.stop()
    return launches, report


def lifecycle_scrub(svc, client: LifecycleClient, lags, metrics) -> dict:
    """4g (c): one flipped bit of the idle stream ``config5-b``'s resident
    choice; B's scrubber must count it in ``klba_scrub_failures_total{buffer=
    "choice"}`` and quarantine the stream, whose next epoch then equals the
    uncorrupted ``config5-a``'s on the same lags.  Also the audit's wall at
    B 131,072 on the clean stream (median of 5)."""
    from kafka_lag_based_assignor_tpu_torch.utils import scrub as scrub_lib

    sid_ok, sid_bad = LIFECYCLE_SIDS
    failures = metrics.REGISTRY.counter("klba_scrub_failures_total", {"buffer": "choice"})
    st = svc._streams[sid_bad]
    before = failures.value
    with st.lock:
        resident = st.engine._resident[0]
        host = resident[:STREAM_P].cpu().numpy()
        resident[:STREAM_P].copy_(torch.from_numpy(scrub.flip_bit(host, seed=5)))
        sync(resident.device)
        t0 = time.perf_counter()
    while failures.value == before and time.perf_counter() - t0 < 30:
        time.sleep(0.005)
    detect_ms = (time.perf_counter() - t0) * 1e3
    with st.lock:  # the audit quarantines under the lock, after counting
        quarantined_now = st.engine.quarantined
    if failures.value != before + 1 or not quarantined_now:
        raise AssertionError(f"lifecycle scrub: failures {failures.value - before}, "
                             f"quarantined {st.engine.quarantined}")
    quarantined = svc.scrub_stats()["quarantined_streams"]
    healthy = client.epoch(sid_ok, lags, None, "lifecycle B heal leg",
                           expect={"rounds_scan": 0})
    healed = client.epoch(sid_bad, lags, healthy["choice"], "lifecycle B heal leg",
                          expect={"rounds_scan": 0})
    if st.engine.quarantined or svc.scrub_stats()["quarantined_streams"] != 0:
        raise AssertionError("lifecycle scrub: the epoch after the audit did not heal")
    audits = []
    st_ok = svc._streams[sid_ok]
    for _ in range(5):
        with st_ok.lock:
            t0 = time.perf_counter()
            audited, fails = scrub_lib.audit_engine(st_ok.engine)
            audits.append((time.perf_counter() - t0) * 1e3)
        if not audited or fails:
            raise AssertionError(f"lifecycle scrub: the clean stream audited {fails}")
    out = {"detect_ms": detect_ms, "quarantined_streams": quarantined,
           "heal_wall_ms": healed["wall_ms"], "heal_epoch_ms": healed["epoch_ms"],
           "audit_ms": statistics.median(audits), "audit_ms_all": audits,
           "interval_ms": LIFECYCLE_SCRUB_MS}
    log(f"lifecycle scrub: the flipped choice bit caught {detect_ms:.3f} ms after the flip "
        f"(cadence {LIFECYCLE_SCRUB_MS} ms), stream quarantined, healed to the uncorrupted "
        f"stream's bits; audit at B {pad_bucket(STREAM_P)} {out['audit_ms']:.3f} ms "
        f"(median of 5: {audits})")
    return out


def lifecycle_path(device, reference: StreamRun) -> tuple:
    """Phase 4g, boot and restart: (a) the warm-up, (b) the restart, (c)
    the scrub.  Every leg counts its launches from 0; the sum is the
    phase's.  The process-wide quality knobs are restored after it (the
    warm-up sizes the tile from the card's free memory).  Returns (the
    launches, the ``lifecycle`` line)."""
    import tempfile

    t0 = time.perf_counter()
    with dispatch.quality_scope(dispatch.quality_mode(), dispatch.quality_tile()):
        launches, warm = lifecycle_warmup()
        with tempfile.TemporaryDirectory(prefix="klba-lifecycle-") as root:
            restart_launches, restart = lifecycle_restart(device, reference, root)
    add_counts(launches, restart_launches)
    seconds = time.perf_counter() - t0
    log(f"main path (boot and restart): launches {launches}; {seconds:.3f} s")
    return launches, {"warmup": warm, **restart, "launches": launches, "seconds": seconds,
                      "device": torch.cuda.get_device_name(0)}



# -- phase 5 ---------------------------------------------------------------


# -- phase 4h: the megabatch coalescer --------------------------------------

# bench.py's multistream_32g shape: streams, partitions, consumers, the warm
# exchange budget, and the warm-up and timed waves.
MS_G, MS_P, MS_C, MS_BUDGET = 32, 4096, 16, 64
MS_WARM, MS_TIMED = 2, 4
# Config 5's resident shape in one locked wave of four streams.
C5_ROWS = 4


def ms_lags(rng) -> np.ndarray:
    """bench.py's stable int32 payload range (the upload dtype is part of the
    coalescer's shape key)."""
    return rng.integers(10**6, 10**8, MS_P).astype(np.int64)


def coalesce_series() -> dict:
    from kafka_lag_based_assignor_tpu_torch.utils import metrics

    reg = metrics.REGISTRY
    out = {name: reg.counter(f"klba_coalesce_{name}_total").value
           for name in ("roster_hits", "restack", "roster_invalidations", "dead_rows",
                        "deadline_reroutes")}
    for path in ("megabatch", "single", "fallback"):
        out[f"flushes_{path}"] = reg.counter("klba_coalesce_flushes_total",
                                             {"path": path}).value
    for outcome in ("applied", "fallback"):
        out[f"delta_{outcome}"] = reg.counter("klba_delta_epochs_total",
                                              {"outcome": outcome}).value
    h = reg.histogram("klba_coalesce_batch_size").state()
    out["batch_count"], out["batch_sum"] = h["count"], h["sum"]
    return out


def series_moved(before: dict) -> dict:
    return {k: v - before[k] for k, v in coalesce_series().items()}


def submit_wave(engines, lags_list, coal) -> tuple:
    """Every engine's ``submit_epoch`` at once, one thread each; returns
    (choices, wall ms).  A failed epoch raises."""
    got, _, wall = at_once("coalesced wave", {
        i: lambda i=i: engines[i].submit_epoch(lags_list[i], coal) for i in range(len(engines))})
    return [got[i] for i in range(len(engines))], wall


def profiled_wave(engines, make_lags, coal) -> dict:
    """One wave under torch.profiler: its wall, the device's busy time (every
    op it enqueued) and idle share, the K6 kernels' time and count.  A
    session that lost the digest kernel's record is repeated (up to five in
    all), each try a fresh wave of ``make_lags()``; ``epochs`` lists every
    wave's lags, in order, for the caller's inline twins to replay."""
    from torch.profiler import ProfilerActivity, profile

    epochs = []
    for attempt in range(5):
        lags_list = make_lags()
        epochs.append(lags_list)
        SESSIONS["recorded"] += 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_for(attempt))
            got, wall = submit_wave(engines, lags_list, coal)
            torch.cuda.synchronize()
            time.sleep(pad_for(attempt))
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "Activity Buffer" not in e.key]
        digest = [e for e in events if KERNEL_NAMES["state_digest"] in e.key]
        if digest:
            busy = sum(e.self_device_time_total for e in events) / 1e3
            return {"choices": got, "epochs": epochs, "wall_ms": wall, "busy_ms": busy,
                    "idle_share": 1 - busy / wall,
                    "digest_ms": sum(e.self_device_time_total for e in digest) / 1e3,
                    "digest_kernels": sum(e.count for e in digest),
                    "top": [(e.key[:48], e.self_device_time_total / 1e3, e.count)
                            for e in sorted(events, key=lambda e: -e.self_device_time_total)[:5]]}
        SESSIONS["discarded"] += 1
    raise AssertionError("profiled wave: no session recorded the digest kernel")


def multistream(device) -> tuple:
    """4h (a): 32 serial engines against 32 through one coalescer, the same
    seeded lags; returns (launches of the coalesced waves, the report)."""
    from kafka_lag_based_assignor_tpu_torch.ops.coalesce import MegabatchCoalescer
    from kafka_lag_based_assignor_tpu_torch.utils import faults
    from kafka_lag_based_assignor_tpu_torch.utils.observability import (
        compile_count,
        install_compile_counter,
    )

    install_compile_counter()

    def engines():
        return [streaming.StreamingAssignor(num_consumers=MS_C, refine_iters=MS_BUDGET,
                                            refine_threshold=None, device=device)
                for _ in range(MS_G)]

    # The epochs: cold, the warm-up waves, the timed waves, a delta wave
    # (every row eight lags changed) and the flush-fault wave, the same
    # seeded lags for both engine sets; a profiled wave after them.
    rngs = [np.random.default_rng(6000 + g) for g in range(MS_G)]
    epochs = [[ms_lags(r) for r in rngs] for _ in range(1 + MS_WARM + MS_TIMED)]
    epochs.append([lg + (np.arange(MS_P) < 8) * (1 + np.arange(MS_P) % 5)
                   for lg in epochs[-1]])
    epochs.append([ms_lags(r) for r in rngs])
    profiled_lags = [ms_lags(r) for r in rngs]

    serial = engines()
    want = []
    walls = []
    for e, lags_list in enumerate(epochs):
        t0 = time.perf_counter()
        want.append([eng.rebalance(lg) for eng, lg in zip(serial, lags_list)])
        walls.append((time.perf_counter() - t0) * 1e3)
    timed = slice(1 + MS_WARM, 1 + MS_WARM + MS_TIMED)
    serial_eps = MS_G * MS_TIMED / (sum(walls[timed]) / 1e3)

    co = engines()
    coal = MegabatchCoalescer(window_s=2.0, max_batch=MS_G, lock_waves=1, device=device)
    report = {}
    try:
        for eng, lg in zip(co, epochs[0]):
            eng.rebalance(lg)
        reset_counts()
        base = coalesce_series()
        wave_walls = []
        builds = None
        for e in range(1, len(epochs)):
            if e == timed.start:
                builds = compile_count()
            if e == len(epochs) - 1:
                with faults.injected(faults.FaultInjector().plan("coalesce.flush", times=1)):
                    got, wall = submit_wave(co, epochs[e], coal)
            else:
                got, wall = submit_wave(co, epochs[e], coal)
            wave_walls.append(wall)
            for g in range(MS_G):
                if not np.array_equal(got[g], want[e][g]):
                    raise AssertionError(f"coalesce 4h(a): wave {e} stream {g} differs from "
                                         "its serial engine")
            if e == 1:
                moved = series_moved(base)
                if (moved["restack"], moved["roster_hits"]) != (1, 0):
                    raise AssertionError(f"coalesce 4h(a): the first wave did not re-stack "
                                         f"once: {moved}")
                if not all(type(eng._resident).__name__ == "ResidentRow" for eng in co):
                    raise AssertionError("coalesce 4h(a): the roster did not lock")
            if e == timed.stop - 1 and compile_count() != builds:
                raise AssertionError("coalesce 4h(a): the timed loop built a kernel")
            if e == timed.stop:
                moved = series_moved(base)
                if moved["delta_applied"] != MS_G:
                    raise AssertionError(f"coalesce 4h(a): the delta wave applied "
                                         f"{moved['delta_applied']} of {MS_G} rows")
        launches = read_counts()
        moved = series_moved(base)
        locked_waves = MS_WARM - 1 + MS_TIMED + 1
        if (moved["restack"], moved["roster_hits"], moved["flushes_fallback"]) != (
                1, locked_waves, 1):
            raise AssertionError(f"coalesce 4h(a): roster series {moved}")
        if launches["state_digest_rows"] != 1 + locked_waves:
            raise AssertionError(f"coalesce 4h(a): {launches['state_digest_rows']} batched "
                                 f"K6 launches for {1 + locked_waves} batched waves")
        if launches["state_digest"] != MS_G or launches["rounds_scan"] != 0:
            raise AssertionError(f"coalesce 4h(a): the fault wave's single dispatches: "
                                 f"{launches}")
        # After the fault wave the roster re-stacks; the next wave locks it
        # again and is the profiled one.
        submit_wave(co, profiled_lags, coal)
        prof = profiled_wave(co, lambda: [ms_lags(r) for r in rngs], coal)
    finally:
        coal.close(timeout_s=60)
    co_eps = MS_G * MS_TIMED / (sum(wave_walls[timed.start - 1:timed.stop - 1]) / 1e3)
    report = {
        "serial_epochs_per_s": serial_eps, "coalesced_epochs_per_s": co_eps,
        "speedup": co_eps / serial_eps,
        "mean_batch": moved["batch_sum"] / moved["batch_count"],
        "serial_wave_ms": walls[timed], "coalesced_wave_ms": wave_walls[timed.start - 1:
                                                                      timed.stop - 1],
        "delta_wave_ms": wave_walls[timed.stop - 1], "fault_wave_ms": wave_walls[-1],
        "series": moved, "launches": launches,
        "profiled_wave": {k: v for k, v in prof.items() if k not in ("choices", "epochs")},
    }
    log(f"coalesce 4h(a) multistream_32g: {MS_G} streams x P {MS_P} x C {MS_C}, budget "
        f"{MS_BUDGET}: serial {serial_eps!r} epochs/s, coalesced {co_eps!r} epochs/s "
        f"({co_eps / serial_eps!r}x), mean batch {report['mean_batch']!r}; every row equal "
        f"to its serial engine; series {moved}; launches {launches}; profiled locked wave "
        f"wall {prof['wall_ms']!r} ms, device busy {prof['busy_ms']!r} ms, idle share "
        f"{prof['idle_share']!r}, K6 {prof['digest_ms']!r} ms x{prof['digest_kernels']}")
    return launches, report


def rows_digest_held(bufs, C: int, P: int, label: str, victim=None, kind: str = "clean"):
    """K6's batched entry on the rows ``bufs`` [(lags, choice, counts, tab)]
    against one single launch a row and the plain version, bit for bit,
    twice; each row's host check (``P`` valid rows) fails just where row
    ``victim`` carries the corruption ``kind``.  Returns (max |diff| (0),
    the digests)."""
    lags, choice, counts, tab = (torch.stack([b[k] for b in bufs]).contiguous()
                                 for k in range(4))
    got = refine.state_digest_rows(lags, choice, counts, C, tab)
    again = refine.state_digest_rows(lags, choice, counts, C, tab)
    single = torch.stack([refine.state_digest(*b[:3], C, row_tab=b[3]) for b in bufs])
    plain = torch.stack([digest_plain(*b[:3], C, b[3]) for b in bufs])
    err = int((got - plain).abs().max())
    if err or not torch.equal(got, single) or not torch.equal(got, again):
        raise AssertionError(f"{label}: state_digest_rows ({kind}) gave {got.tolist()}, the "
                             f"single launches {single.tolist()}, plain {plain.tolist()}")
    for n, b in enumerate(bufs):
        fails = scrub.digest_failures(got[n].cpu().numpy(), P, int(b[0].sum()))
        if (n == victim and kind not in ("clean", "lag sum wraps")) != bool(fails):
            raise AssertionError(f"{label}: state_digest_rows {kind} row {n}: host check {fails}")
    return err, got


def rows_digest_times(rows, C: int, label: str) -> dict:
    """K6's batched entry timed on ``rows`` (one launch), beside one single
    launch a row, the plain version and its bound."""
    lags, choice, counts, tab = (torch.stack([r[k] for r in rows]).contiguous()
                                 for k in range(4))
    t = op_times(lambda: refine.state_digest_rows(lags, choice, counts, C, tab),
                 KERNEL_NAMES["state_digest_rows"])
    plain = median_event_ms(lambda: [digest_plain(*r[:3], C, r[3]) for r in rows])
    singles = median_event_ms(lambda: [refine.state_digest(*r[:3], C, row_tab=r[3])
                                       for r in rows])
    (N, B), M = lags.shape, tab.shape[2]
    slots = int(torch.clamp(counts, max=M).sum())
    moved = N * (8 * B + 4 * (B + C + C * M) + 8 * 5) + 4 * slots
    bound = moved / HBM_BYTES_PER_S * 1e3
    if t["launches"] != 1:
        raise AssertionError(f"state_digest_rows enqueued {t['launches']} kernels a call")
    out = dict(ms=t["event_ms"], alone_ms=t["alone_ms"], all_ops_ms=t["all_ops_ms"],
               plain_ms=plain, four_single_launches_ms=singles, bound_ms=bound,
               bound_by="bytes", library_ms=None, rows=N, B=B, C=C, M=M, bytes=moved)
    log(f"times  state_digest_rows {label} at {N} x (B={B} C={C} M={M}): event "
        f"{t['event_ms']!r} ms, alone {t['alone_ms']!r} ms ({t['kernels']} kernel, "
        f"{t['memsets']} memsets), {N} single launches {singles!r} ms, plain version "
        f"{plain!r} ms, bound {bound!r} ms ({moved} bytes), {t['event_ms'] / bound:.1f}x")
    return out


def digest_rows_check(device) -> tuple:
    """4h (b) first half: the batched K6 at config 5's resident shape, four
    rows, clean and with each corruption class in one row
    (``rows_digest_held``); then its times.  Returns (max |diff|, the
    times)."""
    B = pad_bucket(STREAM_P)
    rows = [resident_case(B, STREAM_P, STREAM_C, device, seed) for seed in range(C5_ROWS)]
    worst = 0
    for kind in DIGEST_KINDS:
        victim = len(kind) % C5_ROWS
        bufs = [corrupted(kind, *r, STREAM_C) if n == victim else r
                for n, r in enumerate(rows)]
        err, _ = rows_digest_held(bufs, STREAM_C, STREAM_P, "coalesce 4h(b) config 5",
                                  victim, kind)
        worst = max(worst, err)
        log(f"kernel vs plain  state_digest_rows config5 x{C5_ROWS} {kind:30s} (row {victim}): "
            f"equal to {C5_ROWS} single launches and the plain version, two runs equal")
    return worst, rows_digest_times(rows, STREAM_C, "config5")


def config5_wave(device) -> tuple:
    """4h (b) second half: four engines at config 5 in one locked wave, each
    row equal to its inline twin, one batched K6 launch and nothing else for
    the wave, its wall and idle share profiled."""
    from kafka_lag_based_assignor_tpu_torch.ops.coalesce import MegabatchCoalescer

    def engines():
        return [streaming.StreamingAssignor(num_consumers=STREAM_C, refine_iters=STREAM_BUDGET,
                                            imbalance_guardrail=1.25, device=device)
                for _ in range(C5_ROWS)]

    # Each warm epoch: a 5 % drift, then one consumer heated past the refine
    # threshold (``heat``), so that every row refines and none trips the
    # guardrail.  The inline engines make the epochs; the coalesced ones
    # replay them.
    rng = np.random.default_rng(55)
    base = [zipf_lags(np.random.default_rng(500 + n), STREAM_P) for n in range(C5_ROWS)]
    inline, co = engines(), engines()

    def warm_lags(which):
        return [heat((lg * rng.lognormal(0.0, 0.05, STREAM_P)).astype(np.int64),
                     eng.export_state(), STREAM_C) for lg, eng in zip(base, which)]

    epochs = [base]
    want = [[eng.rebalance(lg) for eng, lg in zip(inline, base)]]
    for _ in range(2):
        lags = warm_lags(inline)
        epochs.append(lags)
        want.append([eng.rebalance(lg) for eng, lg in zip(inline, lags)])
        if not all(eng.last_stats.refined and not eng.last_stats.guardrail_tripped
                   for eng in inline):
            raise AssertionError("coalesce 4h(b): an inline epoch did not refine warm")
    coal = MegabatchCoalescer(window_s=2.0, max_batch=C5_ROWS, lock_waves=1, device=device)
    try:
        for eng, lg in zip(co, epochs[0]):
            eng.rebalance(lg)
        submit_wave(co, epochs[1], coal)  # re-stack, lock
        reset_counts()
        got, wall = submit_wave(co, epochs[2], coal)
        launches = read_counts()
        wave_stats = ([eng.last_stats.refine_rounds for eng in co],
                      [eng.last_stats.refine_exchanges for eng in co])
        if not all(wave_stats[0]):
            raise AssertionError(f"coalesce 4h(b): a row ran no refine round: {wave_stats}")
        if launches != {**{k: 0 for k in launches}, "state_digest_rows": 1}:
            raise AssertionError(f"coalesce 4h(b): a locked config-5 wave launched {launches}")
        for n in range(C5_ROWS):
            if not np.array_equal(got[n], want[2][n]):
                raise AssertionError(f"coalesce 4h(b): row {n} differs from inline")
        prof = profiled_wave(co, lambda: warm_lags(co), coal)
        for lags in prof["epochs"]:
            last = [eng.rebalance(lg) for eng, lg in zip(inline, lags)]
        for n in range(C5_ROWS):
            if not np.array_equal(prof["choices"][n], last[n]):
                raise AssertionError(f"coalesce 4h(b): profiled row {n} differs from inline")
    finally:
        coal.close(timeout_s=60)
    out = {"wave_ms": wall, "rounds": wave_stats[0], "exchanges": wave_stats[1],
           "launches": launches,
           "profiled_wave": {k: v for k, v in prof.items() if k not in ("choices", "epochs")}}
    log(f"coalesce 4h(b) config 5 x{C5_ROWS}: locked wave {wall!r} ms (rounds "
        f"{out['rounds']}, exchanges {out['exchanges']}), one batched K6 launch, rows equal "
        f"to inline; profiled wave {prof['wall_ms']!r} ms, busy {prof['busy_ms']!r} ms, "
        f"idle share {prof['idle_share']!r}, K6 {prof['digest_ms']!r} ms "
        f"x{prof['digest_kernels']}")
    return launches, out


def coalesced_sidecar(device) -> tuple:
    """4h (c): a sidecar with ``coalesce_max_batch=32`` and four concurrent
    streams against an inline sidecar; every answer equal, ``stats.coalesce``
    filled in.  Returns (launches, report)."""
    from kafka_lag_based_assignor_tpu_torch import service

    opts = {"refine_iters": MS_BUDGET, "guardrail": None, "refine_threshold": None}
    rng = np.random.default_rng(77)
    epochs = [[ms_lags(rng) for _ in range(4)] for _ in range(5)]
    members = [f"m{i:02d}" for i in range(MS_C)]

    def serve(svc):
        answers = []
        with ExitStack() as stack:
            clients = [stack.enter_context(service.AssignorServiceClient(*svc.address,
                                                                         timeout_s=600))
                       for _ in range(4)]
            for lags_list in epochs:
                got = at_once("coalesce 4h(c)", {
                    i: lambda i=i: clients[i].stream_assign(
                        f"s{i}", "t0", wire_rows(lags_list[i]), members, options=opts)
                    for i in range(4)})[0]
                answers.append([wire_answer(got[i]) for i in range(4)])
                for g in got.values():
                    if g["stream"]["degraded_rung"] != "none":
                        raise AssertionError(f"coalesce 4h(c): stream answer {g['stream']}")
            stats = clients[0].request("stats")
        return answers, stats

    inline = service.AssignorService(port=0, device=device, host_fallback=False,
                                     coalesce_max_batch=1, scrub_interval_ms=0).start()
    try:
        want, _ = serve(inline)
    finally:
        inline.stop()
    svc = service.AssignorService(port=0, device=device, host_fallback=False,
                                  coalesce_max_batch=32, coalesce_window_ms=50.0,
                                  scrub_interval_ms=0).start()
    try:
        base = coalesce_series()
        reset_counts()
        got, stats = serve(svc)
        launches = read_counts()
        moved = series_moved(base)
    finally:
        svc.stop()
    if got != want:
        raise AssertionError("coalesce 4h(c): the coalesced sidecar's answers differ")
    co = stats.get("coalesce")
    if not isinstance(co, dict) or set(co) != {
            "locked_rosters", "stream_sharded_rosters", "roster_hits", "restack_flushes",
            "roster_invalidations", "dead_rows_dropped"}:
        raise AssertionError(f"coalesce 4h(c): stats.coalesce {co}")
    if moved["batch_count"] < 1 or moved["flushes_fallback"]:
        raise AssertionError(f"coalesce 4h(c): series {moved}")
    log(f"coalesce 4h(c) sidecar coalesce_max_batch=32, 4 streams x {len(epochs)} epochs: "
        f"answers equal to the inline sidecar's; stats.coalesce {co}; series {moved}; "
        f"launches {launches}")
    return launches, {"stats_coalesce": co, "series": moved}


def dense_stream_paths(device) -> tuple:
    """4h (d): ``assign_stream_batch`` / ``assign_stream_global`` at config 3
    equal to the plugin's ``rounds`` / ``global`` answers, one K1 launch
    each.  Returns (launches, report)."""
    lags, members = baseline_workload(3)
    topics = sorted(lags)
    table = np.stack([lags[t] for t in topics])
    order = sorted(members)
    report = {}
    total = {name: 0 for name, _ in COUNTERS}
    for solver, fn in (("rounds", lambda: batched.assign_stream_batch(table, 64, device)),
                       ("global", lambda: batched.assign_stream_global(table, 64, device)[0])):
        want, _ = assign_once(lags, members, solver, device)
        reset_counts()
        t0 = time.perf_counter()
        choice = fn().cpu().numpy()
        wall = (time.perf_counter() - t0) * 1e3
        grew = read_counts()
        if grew["rounds_scan"] != 1 or sum(grew.values()) != 1:
            raise AssertionError(f"coalesce 4h(d): {solver} dense path launched {grew}")
        add_counts(total, grew)
        got = {m: set() for m in order}
        for t, topic in enumerate(topics):
            for p in range(table.shape[1]):
                got[order[choice[t, p]]].add((topic, p))
        if any(got[m] != set(want[m]) for m in order):
            raise AssertionError(f"coalesce 4h(d): the dense {solver} path differs from the "
                                 "plugin's answer")
        report[solver] = {"wall_ms": wall}
        log(f"coalesce 4h(d) config 3 dense {solver}: equal to the plugin's answer, one K1 "
            f"launch, {wall!r} ms on the host clock (upload and readback included)")
    return total, report


def coalesce_path(device) -> tuple:
    """Phase 4h: (a) multistream_32g, (b) config 5's batched K6 and locked
    wave, (c) the coalesced sidecar, (d) the dense stream paths.  Returns
    (the launches of the driven paths, the batched K6's max |diff|, its
    times, the ``coalesce`` line)."""
    launches = {name: 0 for name, _ in COUNTERS}
    report = {}
    grew, report["multistream_32g"] = multistream(device)
    add_counts(launches, grew)
    digest_err, digest_times = digest_rows_check(device)
    grew, report["config5_wave"] = config5_wave(device)
    add_counts(launches, grew)
    grew, report["sidecar"] = coalesced_sidecar(device)
    add_counts(launches, grew)
    grew, report["dense_paths"] = dense_stream_paths(device)
    add_counts(launches, grew)
    report["state_digest_rows"] = digest_times
    log(f"coalesce path launches {launches}")
    return launches, digest_err, digest_times, report


# -- phase 4i: the P-sharded solve on virtual shards --------------------------

# Mesh sizes of the sharded cold solve, and the engine's cold refine budget
# (StreamingAssignor's cold_refine_iters default, which the sidecar's
# engines keep).
SHARDED_SIZES = (1, 2, 4)
SHARDED_BUDGET = 64
# Host-clock repeats of each timed cold solve (phase 4i (e)).
SHARDED_REPEATS = 3


def virtual_mesh(D: int, device):
    """A ("p",) mesh of ``D`` virtual shards on ``device``."""
    from kafka_lag_based_assignor_tpu_torch.sharded.mesh import Mesh

    return Mesh([device] * D, ("p",))


def sharded_series() -> dict:
    from kafka_lag_based_assignor_tpu_torch.utils import metrics

    reg = metrics.REGISTRY
    out = {f"dispatch_{p}": reg.counter("klba_sharded_dispatch_total", {"path": p}).value
           for p in ("solve", "linear", "rounding")}
    out["degrade_1d_single"] = reg.counter("klba_mesh_degrade_total",
                                           {"from": "1d", "to": "single"}).value
    out["degraded_solve"] = reg.counter("klba_mesh_degraded_total", {"reason": "solve"}).value
    return out


def assignment_facts(label: str, lags: np.ndarray, choice: np.ndarray, C: int,
                     linear: bool) -> dict:
    """Every partition once (a consumer in [0, C)), count spread <= 1, with
    ``linear`` the additive bound; returns the quality ratio and peak."""
    choice = np.asarray(choice)
    if choice.shape != lags.shape or choice.min() < 0 or choice.max() >= C:
        raise AssertionError(f"sharded 4i {label}: not every partition assigned once")
    counts = np.bincount(choice, minlength=C)
    totals = np.bincount(choice, weights=lags, minlength=C)
    if counts.max() - counts.min() > 1:
        raise AssertionError(f"sharded 4i {label}: count spread {counts.max() - counts.min()}")
    bound = linear_ot.additive_bound(lags, np.ones(lags.shape[0], bool), C)
    if linear and totals.max() > bound * (1 + 1e-6) + 0.5:
        raise AssertionError(f"sharded 4i {label}: peak {totals.max()} above the additive "
                             f"bound {bound}")
    ratio = float(totals.max() / totals.mean()) / max(count_constrained_bound(lags, C), 1.0)
    return {"quality_ratio": ratio, "peak": float(totals.max()), "additive_bound": bound}


def k5_superblock_shapes(device, case=None, sbs=(8, 4, 2, 1), phase: str = "4i") -> dict:
    """4i (a): K5 at Sb = 8, 4, 2, 1 (a shard of a 1-, 2-, 4- or 8-way
    mesh) on config 5's blocks at the duals the linear loop ends with:
    against its plain version, and each superblock's partial with the same
    bits whatever Sb it was launched with.  Each shape's event time and
    device time alone.  ``case`` (ws_b, cnt_b, A, B) and ``sbs`` give
    another shape (phase 4m: the wide group's blocks, Sb 8, 4, 2)."""
    if case is None:
        (ws_b, cnt_b), C = blocks_case(5, device)
        A, B = loop_duals(ws_b, cnt_b, C, device)
    else:
        ws_b, cnt_b, A, B = case
        C = A.shape[0]
    full = linear_ot_cuda.superblock_partials(ws_b, cnt_b, A, B)
    worst, times = 0.0, {}
    for Sb in sbs:
        for d in range(8 // Sb):
            w, c = (x[d * Sb:(d + 1) * Sb].contiguous() for x in (ws_b, cnt_b))
            got = linear_ot_cuda.superblock_partials(w, c, A, B)
            again = linear_ot_cuda.superblock_partials(w, c, A, B)
            want = linear_ot._superblock_partials(w, c, A, B)
            worst = max(worst, f32_check("superblock_partials",
                                         f"{phase} Sb={Sb} shard {d} of {8 // Sb} (virtual)",
                                         got, want, again))
            for g, f in zip(got, full):
                if not torch.equal(g, f[d * Sb:(d + 1) * Sb]):
                    raise AssertionError(f"sharded {phase}: K5's superblock partials at Sb={Sb} "
                                         "differ from the same superblocks at Sb=8")
        w, c = ws_b[:Sb].contiguous(), cnt_b[:Sb].contiguous()
        call = lambda: linear_ot_cuda.superblock_partials(w, c, A, B)  # noqa: E731
        times[Sb] = {"event_ms": median_event_ms(call),
                     "alone_ms": device_ms(call, KERNEL_NAMES["superblock_partials"])[0]}
        log(f"sharded {phase} K5 at Sb={Sb} [{Sb}, {ws_b.shape[1]}, {ws_b.shape[2]}] C={C}: "
            f"{times[Sb]} ms; every superblock's partial bit-equal to Sb=8's")
    return {"max_abs_err": worst, "ms_by_sb": times}


def sharded_cold_solves(device, lags: np.ndarray, launches: dict) -> dict:
    """4i (b): config 5's cold solve P-sharded at D = 1, 2, 4 on virtual
    shards, the linear duals (D = 1 direct, 2 and 4 through the engine with
    the manager as its backend) and the exchange program (the mode pinned to
    "sinkhorn"), each held as the module docstring says."""
    from kafka_lag_based_assignor_tpu_torch.sharded import solve as sharded_solve
    from kafka_lag_based_assignor_tpu_torch.sharded.mesh import MeshManager

    C = STREAM_C
    report = {}

    def engine_cold(D: int):
        mgr = MeshManager(devices=D).configure()
        if not (mgr.active and mgr.virtual and mgr.size == D):
            raise AssertionError(f"sharded 4i: a {D}-shard manager did not come up: "
                                 f"{mgr.status()}")
        engine = streaming.StreamingAssignor(num_consumers=C, mesh_backend=mgr,
                                             device=device)
        before = sharded_series()
        choice, grew = counted(lambda: engine.rebalance(lags))
        moved = {k: v - before[k] for k, v in sharded_series().items()}
        if (not engine.last_stats.sharded_solve or not mgr.active
                or not any(moved[k] for k in ("dispatch_solve", "dispatch_linear"))):
            raise AssertionError(f"sharded 4i: the D={D} cold epoch did not run sharded "
                                 f"({mgr.status()}, {moved})")
        return choice, grew

    def check_linear_launches(label, grew, D):
        rounds = linear_ot.last_solve_info()["duals_rounds"]
        if (grew["superblock_partials"] != 2 * D * rounds or grew["rounds_scan"] != 1
                or grew["mirror_prox_step"] != 0):
            raise AssertionError(f"sharded 4i(b) {label}: launches {grew} for {rounds} "
                                 f"duals rounds on {D} shards")

    linear = {}
    (linear[1], _, _, _), grew = counted(lambda: sharded_solve.solve_linear_sharded(
        virtual_mesh(1, device), lags, C, refine_iters=SHARDED_BUDGET))
    check_linear_launches("linear D=1", grew, 1)
    add_counts(launches, grew)
    for D in (2, 4):
        linear[D], grew = engine_cold(D)
        check_linear_launches(f"linear D={D}", grew, D)
        add_counts(launches, grew)
        if not np.array_equal(linear[D], linear[1]):
            raise AssertionError(f"sharded 4i(b): the linear choice at D={D} differs from D=1")
    with dispatch.quality_scope("linear"):
        single = stream_engine(device)
        single.mesh_backend = None
        single_choice = single.rebalance(lags)
    same = bool(np.array_equal(single_choice, linear[1]))
    facts = {label: assignment_facts(label, lags, ch, C, True)
             for label, ch in (("sharded linear", linear[1]),
                               ("single-device linear", single_choice))}
    report["linear"] = {"equal_across_D": True, "equal_to_single_device": same,
                        "rows_differing_from_single_device":
                            int((single_choice != linear[1]).sum()), **facts}
    log(f"sharded 4i(b) linear: D=1, 2, 4 bit-equal (virtual shards); against the card's "
        f"single-device linear cold solve: {'equal' if same else 'differs'} "
        f"({report['linear']['rows_differing_from_single_device']} rows); {facts}")

    exchange = {}
    (exchange[1], _, _, rounds), grew = counted(lambda: sharded_solve.solve_sharded(
        virtual_mesh(1, device), lags, C, refine_iters=SHARDED_BUDGET))
    add_counts(launches, grew)
    dev_lags = torch.from_numpy(lags).to(device)
    twin = refine.refine_assignment(
        dev_lags, torch.ones_like(dev_lags, dtype=torch.bool),
        torch.from_numpy(sharded_solve.seed_reference(lags, C)).to(device), C,
        iters=SHARDED_BUDGET)[0].cpu().numpy()
    if not np.array_equal(exchange[1], twin):
        raise AssertionError("sharded 4i(b): the D=1 exchange program differs from "
                             "seed_reference + refine_assignment")
    cold_chain = stream_engine(device)
    cold_chain.mesh_backend = None
    chain_q = assignment_facts("single-device cold chain", lags, cold_chain.rebalance(lags),
                               C, False)["quality_ratio"]
    ex_facts = {}
    with dispatch.quality_scope("sinkhorn"):
        for D in (2, 4):
            exchange[D], grew = engine_cold(D)
            add_counts(launches, grew)
            ex_facts[D] = assignment_facts(f"exchange D={D}", lags, exchange[D], C, False)
            if ex_facts[D]["quality_ratio"] > max(1.1, 1.1 * chain_q):
                raise AssertionError(f"sharded 4i(b): exchange D={D} quality "
                                     f"{ex_facts[D]['quality_ratio']} against the cold "
                                     f"chain's {chain_q}")
    report["exchange"] = {"d1_equal_to_twin": True, "d1_rounds": rounds,
                          "cold_chain_quality_ratio": chain_q,
                          **{f"D{D}": f for D, f in ex_facts.items()}}
    log(f"sharded 4i(b) exchange: D=1 bit-equal to seed_reference + refine_assignment "
        f"({rounds} rounds); D=2, 4 {ex_facts}; single-device cold chain quality {chain_q!r}")

    # The card's exchange program against the port's CPU run of it, where
    # both pick the same padded bucket (65,536 rows).
    small = zipf_lags(np.random.default_rng(13), 65_536)
    for D in (2, 4):
        got, grew = counted(lambda: sharded_solve.solve_sharded(
            virtual_mesh(D, device), small, 256, refine_iters=SHARDED_BUDGET))
        add_counts(launches, grew)
        want = sharded_solve.solve_sharded(virtual_mesh(D, torch.device("cpu")), small, 256,
                                           refine_iters=SHARDED_BUDGET)
        for g, w in zip(got, want):
            if not np.array_equal(np.asarray(g), np.asarray(w)):
                raise AssertionError(f"sharded 4i(b): the exchange program at 65,536 x 256, "
                                     f"D={D}, differs between the card and the CPU")
    log("sharded 4i(b) exchange at 65,536 x 256: the card equals the CPU at D=2 and 4")
    report["exchange"]["card_equals_cpu_65536x256"] = True
    return report, linear[4]


def sharded_topics(device, launches: dict, case=None, shapes=((4, 1), (2, 2)),
                   phase: str = "4i(c)") -> dict:
    """4i (c): config 3's [256, 64] table (64 consumers) through
    ``assign_sharded`` on (topics, members) = (4, 1) and (2, 2), without and
    with the per-topic refine: bit-equal to the single-device batched solve
    (and that, without refine, to ``assign_stream_batch``), each topic's
    counts within one, one K1 launch a shard.  ``case`` (table, C) and
    ``shapes`` give another table (phase 4m: 16 x 25,000 at 20,000 members
    on (1, 1), (4, 1) and (2, 2), up to 16 clusters a launch)."""
    from kafka_lag_based_assignor_tpu_torch.sharded import topics

    if case is None:
        lags, _ = baseline_workload(3)
        table, C = np.stack([lags[t] for t in sorted(lags)]), 64
    else:
        table, C = case
    pids = np.tile(np.arange(table.shape[1], dtype=np.int32), (table.shape[0], 1))
    valid = np.ones(table.shape, bool)
    on_card = [torch.from_numpy(a).to(device) for a in (table, pids, valid)]
    name = f"{table.shape[0]} x {table.shape[1]}, C={C}"
    report = {}
    for refine_iters in (0, REFINE_ITERS):
        want, grew = counted(lambda: batched.assign_batched_rounds(
            *on_card, num_consumers=C, refine_iters=refine_iters))
        add_counts(launches, grew)
        if not refine_iters:
            dense, grew = counted(lambda: batched.assign_stream_batch(table, C, device=device))
            add_counts(launches, grew)
            if not torch.equal(dense.long(), want[0].long()):
                raise AssertionError(f"sharded {phase} {name}: assign_stream_batch differs "
                                     "from the batched solve")
        counts = want[1].cpu()
        if int((counts.max(dim=1).values - counts.min(dim=1).values).max()) > 1:
            raise AssertionError(f"sharded {phase} {name} refine {refine_iters}: count "
                                 "spread > 1")
        for shape in shapes:
            n = shape[0] * shape[1]
            mesh = topics.make_mesh([device] * n, *shape)
            got, grew = counted(lambda: topics.assign_sharded(
                mesh, table, pids, valid, C, refine_iters=refine_iters))
            add_counts(launches, grew)
            same = all(torch.equal(g, w) for g, w in zip(got[:3], want))
            if (not same or not torch.equal(got[3], want[2].sum(dim=0))
                    or device.type == "cuda" and grew["rounds_scan"] != n):
                raise AssertionError(f"sharded {phase} {name} on {shape} refine "
                                     f"{refine_iters}: equal {same}, launches {grew}")
            report[f"{shape[0]}x{shape[1]}_refine{refine_iters}"] = grew["rounds_scan"]
            log(f"sharded {phase} {name} on (topics, members) = {shape} (virtual), refine "
                f"{refine_iters}: equal to the single-device batched solve"
                f"{'' if refine_iters else ' and assign_stream_batch'}, one K1 launch a shard")
    return report


def sharded_sidecar(device, lags0: np.ndarray, want4: np.ndarray, launches: dict) -> dict:
    """4i (d): the port's sidecar with ``mesh_devices=4`` on 4 virtual shards
    (floor 65,536): a config-5 ``stream_assign`` cold epoch answers
    ``sharded_solve: true`` equal to (b)'s D=4 linear choice, 3 warm epochs
    follow (the first rebuilds and places the resident state, the next two
    digest it shard by shard), ``stats.mesh`` is filled in; then a ``mesh.collective`` fault
    degrades the manager one rung, the series move, and the next stream's
    cold epoch is single-device and valid."""
    from kafka_lag_based_assignor_tpu_torch import service
    from kafka_lag_based_assignor_tpu_torch.utils import faults

    members = [f"c{i:04d}" for i in range(STREAM_C)]
    svc = service.AssignorService(port=0, device=device, host_fallback=False,
                                  mesh_devices=4, coalesce_max_batch=1,
                                  scrub_interval_ms=0).start()
    report = {}
    try:
        client = service.AssignorServiceClient(*svc.address)

        def epoch(sid, lags):
            before = sharded_series()
            t0 = time.perf_counter()
            result, grew = counted(lambda: client.request("stream_assign", {
                "stream_id": sid, "topic": "t0", "members": members,
                "lags": wire_rows(lags)}))
            wall = (time.perf_counter() - t0) * 1e3
            add_counts(launches, grew)
            moved = {k: v - before[k] for k, v in sharded_series().items()}
            choice = wire_choice(result["assignments"], members)
            assignment_facts(f"sidecar {sid}", lags, choice, STREAM_C, False)
            return result["stream"], choice, moved, wall

        s, choice, moved, wall = epoch("mesh5", lags0)
        if not s["sharded_solve"] or not moved["dispatch_linear"] or svc._mesh.rung != "1d":
            raise AssertionError(f"sharded 4i(d): the cold epoch was not sharded: {s}, "
                                 f"{moved}, {svc._mesh.status()}")
        if not np.array_equal(choice, want4):
            raise AssertionError("sharded 4i(d): the sidecar's cold epoch differs from (b)'s "
                                 "D=4 linear choice")
        walls, lags = [wall], lags0
        for e in range(3):
            # One consumer heated past the refine threshold (not the
            # guardrail): every warm epoch refines, the first rebuilding the
            # resident state from the sharded cold epoch's choice.
            lags = heat(lags, choice, STREAM_C)
            s, choice, _, wall = epoch("mesh5", lags)
            walls.append(wall)
            # counted() zeroed the counts at the epoch's start: the first
            # rebuilds the state (one K6) and places it; the next digest the
            # placed state with one K6 shard launch a shard.
            want = (1, 0) if e == 0 else (0, 4)
            if (s["cold_start"] or s["fallback_used"] or not s["refined"]
                    or (refine.state_digest.launches,
                        refine.state_digest_sharded.launches) != want):
                raise AssertionError(f"sharded 4i(d): warm epoch {e} answered {s}")
        mesh_stats = client.request("stats", {})["mesh"]
        if not (mesh_stats["active"] and mesh_stats["devices"] == 4 and mesh_stats["virtual"]):
            raise AssertionError(f"sharded 4i(d): stats.mesh {mesh_stats}")
        log(f"sharded 4i(d) sidecar: cold epoch sharded (virtual, 4 shards) and equal to "
            f"(b)'s D=4 choice; 3 warm epochs; walls {walls} ms; stats.mesh {mesh_stats}")
        with faults.injected(faults.FaultInjector(5).plan("mesh.collective", "raise",
                                                          times=1)):
            s, _, moved, _ = epoch("mesh5-fault", lags0)
        if (s["sharded_solve"] or svc._mesh.rung != "single"
                or moved["degrade_1d_single"] != 1 or moved["degraded_solve"] != 1):
            raise AssertionError(f"sharded 4i(d): the fault leg answered {s}, moved {moved}, "
                                 f"{svc._mesh.status()}")
        log(f"sharded 4i(d) mesh.collective fault: degraded 1d -> single, the stream's cold "
            f"epoch single-device and valid; {svc._mesh.status()}")
        report = {"cold_and_warm_walls_ms": walls, "stats_mesh": mesh_stats,
                  "after_fault": svc._mesh.status()}
    finally:
        svc.stop()
    return report


def sharded_times(device, lags: np.ndarray) -> dict:
    """4i (e): the config-5 cold solve on the host clock, median of
    SHARDED_REPEATS, at D = 1, 2, 4 for both programs, against the
    single-device cold solves (the linear one on K4, and the greedy cold
    chain); then one profiled D=4 linear solve (device busy, idle share)."""
    from torch.profiler import ProfilerActivity, profile

    from kafka_lag_based_assignor_tpu_torch.sharded import solve as sharded_solve

    C = STREAM_C

    def wall(fn) -> float:
        out = []
        for _ in range(SHARDED_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    def single(mode):
        def run():
            with dispatch.quality_scope(mode):
                eng = stream_engine(device)
                eng.mesh_backend = None
                eng.rebalance(lags)
        return run

    times = {"single_linear_ms": wall(single("linear")),
             "single_cold_chain_ms": wall(single("auto"))}
    for D in SHARDED_SIZES:
        mesh = virtual_mesh(D, device)
        times[f"linear_D{D}_ms"] = wall(lambda: sharded_solve.solve_linear_sharded(
            mesh, lags, C, refine_iters=SHARDED_BUDGET))
        times[f"exchange_D{D}_ms"] = wall(lambda: sharded_solve.solve_sharded(
            mesh, lags, C, refine_iters=SHARDED_BUDGET))
    log(f"sharded 4i(e) config-5 cold solves on the host clock (virtual shards on one card, "
        f"median of {SHARDED_REPEATS}): {json.dumps(times)}")
    mesh = virtual_mesh(4, device)
    for attempt in range(5):
        SESSIONS["recorded"] += 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_for(attempt))
            t0 = time.perf_counter()
            sharded_solve.solve_linear_sharded(mesh, lags, C, refine_iters=SHARDED_BUDGET)
            torch.cuda.synchronize()
            span = (time.perf_counter() - t0) * 1e3
            time.sleep(pad_for(attempt))
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "Activity Buffer" not in e.key]
        k5 = [e for e in events if KERNEL_NAMES["superblock_partials"] in e.key]
        if k5:
            busy = sum(e.self_device_time_total for e in events) / 1e3
            times["profiled_linear_D4"] = {
                "wall_ms": span, "busy_ms": busy, "idle_share": 1 - busy / span,
                "k5_ms": sum(e.self_device_time_total for e in k5) / 1e3,
                "k5_kernels": sum(e.count for e in k5),
                "top": [(e.key[:48], e.self_device_time_total / 1e3, e.count)
                        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:5]],
            }
            log(f"sharded 4i(e) profiled D=4 linear solve: {times['profiled_linear_D4']}")
            return times
        SESSIONS["discarded"] += 1
    raise AssertionError("sharded 4i(e): no profiler session recorded K5")


def sharded_path(device, times: bool = False) -> tuple:
    """Phase 4i: (a) K5 at every superblock count a shard takes, (b) config
    5's sharded cold solves, (c) the topic-axis backend, (d) the sidecar
    with ``mesh_devices=4``, and with ``times`` (``--sharded``) (e) the
    cold solves' times.  Every shard is a virtual shard on the card.  Returns (the launches of the driven paths (b)-(d), K5's max
    |diff| at the shard shapes, the ``sharded`` line)."""
    from kafka_lag_based_assignor_tpu_torch.sharded import mesh as mesh_mod

    t0 = time.perf_counter()
    launches = {name: 0 for name, _ in COUNTERS}
    report = {"shards": "virtual: every shard's tensors on cuda:0"}
    k5 = k5_superblock_shapes(device)
    report["k5_ms_by_sb"] = k5["ms_by_sb"]
    _, lags = stream_lags0(STREAM_P)
    mesh_mod.set_virtual_shards(4, device)
    try:
        report["cold"], want4 = sharded_cold_solves(device, lags, launches)
        report["topics"] = sharded_topics(device, launches)
        report["sidecar"] = sharded_sidecar(device, lags, want4, launches)
        if times:
            report["times"] = sharded_times(device, lags)
    finally:
        mesh_mod.set_virtual_shards(None)
    report["launches"] = dict(launches)
    report["seconds"] = time.perf_counter() - t0
    log(f"sharded path launches {launches} in {report['seconds']!r} s")
    return launches, k5["max_abs_err"], report


# -- phase 4j: placement on virtual shards ----------------------------------

# The mesh sizes K6's shard entry is held at (a shard of a 1-, 2-, 4- and
# 8-way mesh), and the size of the placed paths (b)-(d).
PLACEMENT_SIZES = (1, 2, 4, 8)
PLACEMENT_D = 4


def split_rows(lags, choice, D: int) -> tuple:
    """(lag shards, choice shards, row offsets) of a state cut into D
    contiguous row shards, each a tensor of its own (virtual shards)."""
    ls = [t.clone() for t in torch.tensor_split(lags, D)]
    cs = [t.clone() for t in torch.tensor_split(choice, D)]
    offsets = np.cumsum([0] + [t.shape[0] for t in ls[:-1]]).tolist()
    return ls, cs, offsets


def digest_sharded_plain(ls, cs, counts, C: int, tab, offsets):
    """The plain version of ``state_digest_sharded`` on the same tensors:
    ``_state_digest_shard_torch`` a shard, then the same combine."""
    B = sum(int(t.shape[0]) for t in ls)
    parts = [refine._state_digest_shard_torch(l, c, counts, C, tab, lo, B, d == 0)
             for d, (l, c, lo) in enumerate(zip(ls, cs, offsets))]
    return refine.combine_shard_digests(sum(p for p, _ in parts),
                                        sum(h.long() for _, h in parts), counts)


def shard_digest_held(ls, cs, counts, C: int, tab, offsets, single, label: str) -> int:
    """K6's shard entry on the row shards ``ls`` / ``cs`` (first rows at
    ``offsets``) against the one-state K6's ``single`` on the gathered state
    and against its plain version, bit for bit, twice; each shard's partial
    lanes and histogram against the plain shard version.  Returns max
    |diff| (0)."""
    B = sum(int(t.shape[0]) for t in ls)
    got = refine.state_digest_sharded(ls, cs, counts, C, tab, offsets)
    again = refine.state_digest_sharded(ls, cs, counts, C, tab, offsets)
    plain = digest_sharded_plain(ls, cs, counts, C, tab, offsets)
    err = int((got - plain).abs().max())
    if err or not torch.equal(got, single) or not torch.equal(got, again):
        raise AssertionError(f"{label}: state_digest_sharded D={len(ls)} {got.tolist()} against "
                             f"one-state K6 {single.tolist()} and plain {plain.tolist()}")
    for d in range(len(ls)):
        args = (ls[d], cs[d], counts, C, tab, offsets[d], B, d == 0)
        part, hist = state_digest_cuda.launch_shard(*args)
        p_part, p_hist = refine._state_digest_shard_torch(*args)
        if not (torch.equal(part, p_part) and torch.equal(hist, p_hist)):
            raise AssertionError(f"{label}: shard {d} of {len(ls)}: partial {part.tolist()} "
                                 f"against plain {p_part.tolist()}")
    return err


def shard_digest_times(ls, cs, counts, C: int, tab, offsets, label: str) -> dict:
    """K6's shard entry timed on these shards (one launch a shard), beside
    its plain version and its bound."""
    call = lambda: refine.state_digest_sharded(ls, cs, counts, C, tab, offsets)  # noqa: E731
    t = op_times(call, KERNEL_NAMES["state_digest_sharded"])
    D = len(ls)
    if t["launches"] != D:
        raise AssertionError(f"state_digest_sharded launched {t['launches']} kernels for "
                             f"{D} shards")
    plain = median_event_ms(lambda: digest_sharded_plain(ls, cs, counts, C, tab, offsets))
    B, M = sum(int(x.shape[0]) for x in ls), tab.shape[1]
    slots = int(torch.clamp(counts, max=M).sum())
    # The function's own bytes: the rows (lags, choice) once, the table and
    # counts once, the choices of the valid slots, and the int64[5] digest.
    # This design reads the replicated table and counts once a shard and
    # writes a partial a shard on top of that (``design_bytes``).
    moved = 12 * B + 4 * C + 4 * C * M + 4 * slots + 40
    design = 12 * B + D * (4 * C + 4 * C * M + 40 + 4 * C) + 4 * slots
    out = dict(ms=t["event_ms"], alone_ms=t["alone_ms"], all_ops_ms=t["all_ops_ms"],
               plain_ms=plain, bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library_ms=None, shards=D, B=B, C=C, M=M, bytes=moved, design_bytes=design,
               design_bound_ms=design / HBM_BYTES_PER_S * 1e3, launches=t["launches"])
    log(f"times  state_digest_sharded {label} at D={D} (B={B} C={C} M={M}): event "
        f"{t['event_ms']!r} ms, alone {t['alone_ms']!r} ms ({t['launches']} launches, "
        f"{t['kernels']} kernels, {t['memsets']} memsets), all ops {t['all_ops_ms']!r} ms, "
        f"plain {plain!r} ms, bound {out['bound_ms']!r} ms ({moved} bytes; this design "
        f"moves {design} bytes, {out['design_bound_ms']!r} ms)")
    return out


def sharded_digest_check(device) -> tuple:
    """4j (a): ``state_digest_sharded`` on config 5's resident state (B
    131,072, C 1,000, M 133) at D = 1, 2, 4, 8, clean and under each
    corruption class of ``digest_cases`` (``shard_digest_held``); then its
    times at D = 4.  Returns (max |diff| (0), the times)."""
    B = pad_bucket(STREAM_P)
    base = resident_case(B, STREAM_P, STREAM_C, device)
    worst = 0
    for kind in DIGEST_KINDS:
        lags, choice, counts, tab = corrupted(kind, *base, STREAM_C)
        single = refine.state_digest(lags, choice, counts, STREAM_C, row_tab=tab)
        for D in PLACEMENT_SIZES:
            ls, cs, offsets = split_rows(lags, choice, D)
            worst = max(worst, shard_digest_held(ls, cs, counts, STREAM_C, tab, offsets,
                                                 single, f"placement 4j(a) {kind}"))
        log(f"kernel vs plain  state_digest_sharded config5 {kind:30s}: D = 1, 2, 4, 8 equal to "
            f"the one-state K6 {single.tolist()} and to the plain version")
    wide = []
    for dev in (device, torch.device("cpu")):
        z = torch.zeros(8, dtype=torch.int32, device=dev)
        C = 16385  # one above the register network's slots: answered alike
        wide.append(refine.state_digest_sharded(
            [z.long()], [z], torch.zeros(C, dtype=torch.int32, device=dev), C,
            torch.zeros((C, 1), dtype=torch.int32, device=dev), [0]).cpu())
    if not torch.equal(*wide):
        raise AssertionError(f"state_digest_sharded at C=16385: card {wide[0].tolist()}, "
                             f"CPU {wide[1].tolist()}")
    lags, choice, counts, tab = base
    ls, cs, offsets = split_rows(lags, choice, PLACEMENT_D)
    return worst, shard_digest_times(ls, cs, counts, STREAM_C, tab, offsets, "config5")


def profiled_call(fn, kernel: str) -> tuple:
    """(``fn()``, its profile): the call's wall, the device's busy time
    (every op it enqueued) and idle share, and the time and launches of the
    kernels named ``kernel``.  A session without a record of them is
    repeated (up to five in all)."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(5):
        SESSIONS["recorded"] += 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_for(attempt))
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            time.sleep(pad_for(attempt))
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "Activity Buffer" not in e.key]
        hits = [e for e in events if kernel in e.key]
        if hits:
            busy = sum(e.self_device_time_total for e in events) / 1e3
            return out, {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
                         "kernel_ms": sum(e.self_device_time_total for e in hits) / 1e3,
                         "kernel_launches": sum(e.count for e in hits),
                         "top": [(e.key[:48], e.self_device_time_total / 1e3, e.count)
                                 for e in sorted(events,
                                                 key=lambda e: -e.self_device_time_total)[:5]]}
        SESSIONS["discarded"] += 1
    raise AssertionError(f"profiled call: no session recorded kernels named {kernel!r}")


def placement_series() -> dict:
    from kafka_lag_based_assignor_tpu_torch.utils import metrics

    reg = metrics.REGISTRY
    return {"placed": reg.counter("klba_resident_placed_total", {"axis": "p"}).value,
            "degrade_1d_single": reg.counter("klba_mesh_degrade_total",
                                             {"from": "1d", "to": "single"}).value}


def placed_stream(device, launches: dict) -> dict:
    """4j (b): config 5's stream through ``StreamingAssignor(mesh_backend=
    manager)`` on 4 virtual shards: the sharded cold epoch, phase 4c's
    10-epoch drift and 3 delta epochs.  The cold epoch is the sharded linear
    solve (phase 4c's is the single-device cold chain), so the reference is
    a single-device engine seeded with the cold choice: every later epoch's
    choice is bit-equal to it.  Each shard holds B/4 rows of choice and
    lags, the placement counter moves, the placed warm epochs digest with
    K6's shard entry; then a ``device.corrupt.choice`` drill is caught and
    healed."""
    from kafka_lag_based_assignor_tpu_torch.sharded.mesh import MeshManager
    from kafka_lag_based_assignor_tpu_torch.sharded.resident import PlacedResident
    from kafka_lag_based_assignor_tpu_torch.utils import faults

    mgr = MeshManager(devices=PLACEMENT_D).configure()
    engine = streaming.StreamingAssignor(num_consumers=STREAM_C, refine_iters=STREAM_BUDGET,
                                         imbalance_guardrail=1.25, mesh_backend=mgr,
                                         device=device)
    before = placement_series()
    rng, lags0 = stream_lags0(STREAM_P)
    reset_counts()
    t0 = time.perf_counter()
    choice = engine.rebalance(lags0)
    walls = [(time.perf_counter() - t0) * 1e3]
    if not engine.last_stats.sharded_solve:
        raise AssertionError("placement 4j(b): the cold epoch was not sharded")
    cold, epochs, choices, kinds = choice, [], [], []
    digests = [0, 0]  # the K6 launches the epochs must make: one-state, shards
    lags = lags0.astype(np.float64)
    for e in range(13):
        if e < 10:
            lags = stream_drift(rng, lags, e, choice, STREAM_C)
            cur = lags.astype(np.int64)
        else:
            cur = heat(epochs[-1], choice, STREAM_C)
        placed_before = isinstance(engine._resident, PlacedResident)
        t0 = time.perf_counter()
        choice = engine.rebalance(cur)
        sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
        epochs.append(cur)
        choices.append(choice)
        s = engine.last_stats
        kinds.append("cold" if s.cold_start and not s.refined else "noop" if not s.refined
                     else "placed" if placed_before else "build")
        # A refine on a placed state: one K6 shard launch a shard; on a
        # rebuilt one: one K6; a cold epoch here is the sharded linear solve.
        digests[0] += int(s.refined and not placed_before)
        digests[1] += PLACEMENT_D * int(s.refined and placed_before)
    grew = read_counts()
    add_counts(launches, grew)
    res = engine._resident
    B = pad_bucket(STREAM_P)
    if not isinstance(res, PlacedResident) or [int(s[0].shape[0]) for s in res.shards] != [
            B // PLACEMENT_D] * PLACEMENT_D or [int(s[3].shape[0]) for s in res.shards] != [
            B // PLACEMENT_D] * PLACEMENT_D:
        raise AssertionError(f"placement 4j(b): the resident state is not placed in "
                             f"{PLACEMENT_D} row shards: {type(res).__name__}")
    moved = {k: v - before[k] for k, v in placement_series().items()}
    if (moved["placed"] < 1 or kinds.count("placed") < 1 or (
            device.type == "cuda"
            and [grew["state_digest"], grew["state_digest_sharded"]] != digests)):
        raise AssertionError(f"placement 4j(b): epochs {kinds}, series {moved}, launches {grew}")
    ref = stream_engine(device)
    ref.mesh_backend = None
    ref.seed_choice(cold)
    for e, (cur, got) in enumerate(zip(epochs, choices)):
        if not np.array_equal(ref.rebalance(cur), got):
            raise AssertionError(f"placement 4j(b): epoch {e + 1} differs from the "
                                 "single-device engine seeded with the cold choice")
    # The drill: the flip lands in the owning shard as the next state is
    # adopted; the dispatch after it catches it and the one after heals.
    cur = heat(epochs[-1], choice, STREAM_C)
    with faults.injected(faults.FaultInjector(5).plan("device.corrupt.choice", times=1)):
        choice = engine.rebalance(cur)
    audited, fails = scrub.audit_engine(engine)
    cur = heat(cur, choice, STREAM_C)
    try:
        engine.rebalance(cur)
        raise AssertionError("placement 4j(b): the corrupted placed state was not caught")
    except scrub.CorruptStateDetected as exc:
        caught = list(exc.buffers)
    healed = engine.rebalance(cur)
    if (not audited or fails != ["choice"] or "choice" not in caught or engine.quarantined
            or not isinstance(engine._resident, PlacedResident)):
        raise AssertionError(f"placement 4j(b): drill audit {fails}, caught {caught}")
    assignment_facts("placement 4j(b) healed", cur, healed, STREAM_C, False)
    cur = heat(cur, healed, STREAM_C)
    _, prof = profiled_call(lambda: engine.rebalance(cur),
                            KERNEL_NAMES["state_digest_sharded"])
    if not engine.last_stats.refined or prof["kernel_launches"] != PLACEMENT_D:
        raise AssertionError(f"placement 4j(b): the profiled epoch {prof}")
    report = {"epochs": kinds, "walls_ms": walls, "series": moved, "launches": grew,
              "shard_rows": B // PLACEMENT_D, "drill": {"audit": fails, "caught": caught},
              "profiled_placed_epoch": prof}
    log(f"placement 4j(b) config-5 stream on {PLACEMENT_D} virtual shards: epochs {kinds}; "
        f"every epoch after the sharded cold one equal to the single-device engine; walls "
        f"{walls} ms; series {moved}; launches {grew}; the corrupt.choice drill caught and "
        f"healed; one profiled placed warm epoch {prof}")
    return report


def placed_rows_digest(batch, label: str) -> int:
    """4j (c): the rows of a locked placed batch on its first device, the
    stacked state that device's batched K6 launch digests in the next wave
    (8 x 4,096, C 16), through ``rows_digest_held``, clean and with one
    corrupted row under a few corruption classes; a corrupted row's digest
    must differ from its clean one.  Returns max |diff| (0)."""
    with batch.lock:
        rows = [tuple(t.parts[0][n].clone() for t in (batch.lags, batch.choice,
                                                      batch.counts, batch.row_tab))
                for n in range(batch.choice.parts[0].shape[0])]
    worst, clean, victim = 0, None, 1
    for kind in ("clean", "choice C", "counts +1", "table bit flip"):
        bufs = [corrupted(kind, *r, MS_C) if n == victim else r for n, r in enumerate(rows)]
        err, got = rows_digest_held(bufs, MS_C, MS_P, f"placement 4j(c) {label}", victim, kind)
        worst = max(worst, err)
        clean = got[victim].clone() if clean is None else clean
        if (kind != "clean") == torch.equal(got[victim], clean):
            raise AssertionError(f"placement 4j(c) {label}: the {kind} row's digest "
                                 f"{got[victim].tolist()} against clean {clean.tolist()}")
    log(f"kernel vs plain  state_digest_rows {label} one device's {len(rows)} placed rows "
        f"(B={rows[0][0].shape[0]} C={MS_C}): clean and one corrupted row (choice C, counts "
        "+1, table bit flip) equal to the single launches and the plain version")
    return worst


def placed_waves(device, launches: dict, unplaced_ms=None) -> dict:
    """4j (c): ``multistream_32g`` (32 x 4,096, C 16, budget 64) through a
    coalescer on a 4-way streams mesh and a (2, 2) 2-D mesh of virtual
    shards: every row equal to its serial engine; the roster locks placed
    (8 rows a device), each locked wave launches the batched K6 once a
    device, and ``stream_sharded_rosters`` is 1; one device's locked rows
    through the batched K6 against its plain version."""
    from kafka_lag_based_assignor_tpu_torch.ops.coalesce import MegabatchCoalescer
    from kafka_lag_based_assignor_tpu_torch.sharded.megabatch import RowShards
    from kafka_lag_based_assignor_tpu_torch.sharded.mesh import MeshManager

    def engines(mgr):
        return [streaming.StreamingAssignor(num_consumers=MS_C, refine_iters=MS_BUDGET,
                                            refine_threshold=None, mesh_backend=mgr,
                                            device=device)
                for _ in range(MS_G)]

    rngs = [np.random.default_rng(6000 + g) for g in range(MS_G)]
    epochs = [[ms_lags(r) for r in rngs] for _ in range(1 + MS_WARM + 3)]
    epochs.append([lg + (np.arange(MS_P) < 8) * (1 + np.arange(MS_P) % 5)
                   for lg in epochs[-1]])
    serial = engines(None)
    want = [[eng.rebalance(lg) for eng, lg in zip(serial, lags)] for lags in epochs]
    report = {}
    for spec in ("streams", "2x2"):
        kw = {} if spec == "streams" else {"shape": spec}
        mgr = MeshManager(devices=PLACEMENT_D, solve_min_rows=1 << 30, **kw).configure()
        co = engines(mgr)
        coal = MegabatchCoalescer(window_s=2.0, max_batch=MS_G, lock_waves=1,
                                  mesh_manager=mgr, device=device)
        walls = []
        try:
            for eng, lg in zip(co, epochs[0]):
                eng.rebalance(lg)
            reset_counts()
            for e in range(1, len(epochs)):
                got, wall = submit_wave(co, epochs[e], coal)
                walls.append(wall)
                for g in range(MS_G):
                    if not np.array_equal(got[g], want[e][g]):
                        raise AssertionError(f"placement 4j(c) {spec}: wave {e} stream {g} "
                                             "differs from its serial engine")
            grew = read_counts()
            with coal._roster_lock:
                batches = [r.batch for r in coal._rosters.values() if r.batch is not None]
            stats = coal.stats()
            rows_err = placed_rows_digest(batches[0], spec) if len(batches) == 1 else None
            prof = profiled_wave(co, lambda: [ms_lags(r) for r in rngs], coal)
        finally:
            coal.close(timeout_s=60)
        locked = len(epochs) - 2
        batch = batches[0] if len(batches) == 1 else None
        if (batch is None or batch.mesh is None or not isinstance(batch.choice, RowShards)
                or [p.shape[0] for p in batch.choice.parts] != [MS_G // PLACEMENT_D] * 4
                or stats["stream_sharded_rosters"] != 1 or (
                    device.type == "cuda"
                    and grew["state_digest_rows"] != 1 + PLACEMENT_D * locked)):
            raise AssertionError(f"placement 4j(c) {spec}: batch {batch and batch.mesh}, "
                                 f"stats {stats}, launches {grew}")
        add_counts(launches, grew)
        prof = {k: v for k, v in prof.items() if k not in ("choices", "epochs")}
        report["rows_digest_err"] = max(report.get("rows_digest_err", 0), rows_err)
        report[spec] = {"mesh": dict(batch.mesh.shape), "locked_wave_ms": walls[1:],
                        "restack_wave_ms": walls[0], "stats": stats, "launches": grew,
                        "profiled_wave": prof}
        log(f"placement 4j(c) multistream_32g on the {spec} mesh ({dict(batch.mesh.shape)}, "
            f"virtual): every row equal to its serial engine; locked waves {walls[1:]} ms "
            f"(phase 4h's unplaced locked waves: {unplaced_ms} ms); stats {stats}; "
            f"launches {grew}; one profiled placed wave {prof}")
    return report


def placed_fault(device, launches: dict) -> dict:
    """4j (d): a ``mesh.collective`` fault at a placed stream's warm boundary
    degrades the manager (1d -> single) and the epoch is still answered (cold,
    single-device), valid."""
    from kafka_lag_based_assignor_tpu_torch.sharded.mesh import MeshManager
    from kafka_lag_based_assignor_tpu_torch.sharded.resident import PlacedResident
    from kafka_lag_based_assignor_tpu_torch.utils import faults

    mgr = MeshManager(devices=PLACEMENT_D).configure()
    engine = streaming.StreamingAssignor(num_consumers=STREAM_C, refine_iters=STREAM_BUDGET,
                                         refine_threshold=None, mesh_backend=mgr,
                                         device=device)
    _, lags = stream_lags0(STREAM_P)
    reset_counts()
    choice = engine.rebalance(lags)
    lags = heat(lags, choice, STREAM_C)
    choice = engine.rebalance(lags)
    if not isinstance(engine._resident, PlacedResident):
        raise AssertionError("placement 4j(d): the warm epoch did not place the state")
    before = placement_series()
    lags = heat(lags, choice, STREAM_C)
    with faults.injected(faults.FaultInjector(9).plan("mesh.collective", "raise", times=1)):
        choice = engine.rebalance(lags)
    add_counts(launches, read_counts())
    s = engine.last_stats
    moved = {k: v - before[k] for k, v in placement_series().items()}
    facts = assignment_facts("placement 4j(d)", lags, choice, STREAM_C, False)
    if (mgr.rung != "single" or not s.cold_start or s.sharded_solve
            or moved["degrade_1d_single"] != 1 or engine._resident is None
            or isinstance(engine._resident, PlacedResident)):
        raise AssertionError(f"placement 4j(d): the fault answered {s}, {mgr.status()}, "
                             f"{moved}")
    log(f"placement 4j(d) mesh.collective at the warm boundary: degraded 1d -> single, the "
        f"epoch answered cold single-device, quality {facts['quality_ratio']!r}")
    return {"after_fault": mgr.status(), "quality_ratio": facts["quality_ratio"]}


def placement_path(device, unplaced_ms=None) -> tuple:
    """Phase 4j: (a) K6's shard entry, (b) a placed config-5 stream, (c)
    placed coalescer waves, (d) the warm-boundary fault.  Every shard a
    virtual shard of the card.  Returns (the launches of (b)-(d), K6's
    shard entry's max |diff|, its times, the ``placement`` line)."""
    from kafka_lag_based_assignor_tpu_torch.sharded import mesh as mesh_mod

    t0 = time.perf_counter()
    launches = {name: 0 for name, _ in COUNTERS}
    report = {"shards": f"virtual: {PLACEMENT_D} shards of cuda:0"}
    err, report["state_digest_sharded"] = sharded_digest_check(device)
    mesh_mod.set_virtual_shards(PLACEMENT_D, device)
    try:
        report["stream"] = placed_stream(device, launches)
        report["waves"] = placed_waves(device, launches, unplaced_ms)
        report["fault"] = placed_fault(device, launches)
    finally:
        mesh_mod.set_virtual_shards(None)
        mesh_mod.deactivate()
    report["launches"] = dict(launches)
    report["seconds"] = time.perf_counter() - t0
    log(f"placement path launches {launches} in {report['seconds']!r} s")
    return launches, err, report["state_digest_sharded"], report


# -- phase 4k: federation ----------------------------------------------------

# bench.py's config 12: three shards of 2,048 lags, C 8, seed 0xFED12, and the
# round budget.
FED_N, FED_P, FED_C, FED_ROUNDS = 3, 2048, 8, 16
# The weighted leg's per-consumer capacity, 1:2:1 over the members.
FED_CAPACITY = [1.0, 2.0, 1.0, 1.0, 2.0, 1.0, 1.0, 2.0]


def local_only_vs_plain(resp, lags: np.ndarray, members, pids, device) -> None:
    """A ``local_only`` answer (the ``rounds`` solve, one K1 on the card)
    against the same rows through the port's ``rounds`` solve on the CPU,
    where the same packing feeds the plain version (``rounds_scan_torch``):
    equal bit for bit, and answered on the card."""
    from kafka_lag_based_assignor_tpu_torch import service

    want, _ = service._solve({"t0": wire_rows(lags, pids)}, {m: ["t0"] for m in members},
                             "rounds", host_fallback=False, device="cpu")
    got = local_choice(resp, members, pids)
    plain = local_choice({"assignments": want}, members, pids)
    if resp["stats"]["device"] != device.type or not np.array_equal(got, plain):
        raise AssertionError(f"federation 4k: a local_only answer on {resp['stats']['device']} "
                             f"differs from the plain rounds path in "
                             f"{int((got != plain).sum())} rows")


class FedTrio:
    """Three port sidecars on the card in full mesh over loopback TCP.  Every
    answer at rung ``local_only`` is held to the plain ``rounds`` path
    (``local_only_vs_plain``) and counted in ``local_only_checked``."""

    def __init__(self, device, prefix: str, rounds: int = FED_ROUNDS, **kw):
        import socket

        from kafka_lag_based_assignor_tpu_torch import service

        socks = [socket.socket() for _ in range(FED_N)]
        for s in socks:
            s.bind(("127.0.0.1", 0))
        ports = [s.getsockname()[1] for s in socks]
        for s in socks:
            s.close()
        self.ids = [f"{prefix}{i}" for i in range(FED_N)]
        self.device, self.local_only_checked = device, 0
        self.svcs, self.clients = [], []
        for i in range(FED_N):
            peers = ",".join(f"{self.ids[j]}=127.0.0.1:{ports[j]}"
                             for j in range(FED_N) if j != i)
            svc = service.AssignorService(
                port=ports[i], device=device, host_fallback=False, coalesce_max_batch=1,
                scrub_interval_ms=0, breaker_cooldown_s=0.5, federation_self_id=self.ids[i],
                federation_peers=peers, federation_rounds=rounds,
                federation_sync_timeout_s=300.0, **kw).start()
            self.svcs.append(svc)
            self.clients.append(service.AssignorServiceClient(*svc.address, timeout_s=600.0))

    def assign(self, i: int, lags: np.ndarray, members, pids=None) -> tuple:
        t0 = time.perf_counter()
        r = self.clients[i].federated_assign("t0", wire_rows(lags, pids), members)
        wall = (time.perf_counter() - t0) * 1e3
        if r["federation"]["rung"] == "local_only":
            pids = np.arange(lags.shape[0]) if pids is None else pids
            local_only_vs_plain(r, lags, members, pids, self.device)
            self.local_only_checked += 1
        return r, wall

    def close(self) -> None:
        for c in self.clients:
            c.close()
        for s in self.svcs:
            s.stop()


def local_choice(resp, members, pids) -> np.ndarray:
    """A federated answer as each local row's member index."""
    where = {int(p): k for k, p in enumerate(pids)}
    choice = np.full(len(pids), -1, np.int32)
    for j, m in enumerate(members):
        for _, p in resp["assignments"][m]:
            choice[where[int(p)]] = j
    return choice


def fed_quality(shards, choices, C: int) -> float:
    totals = sum(np.bincount(ch, weights=s.astype(np.float64), minlength=C)
                 for s, ch in zip(shards, choices))
    return float(totals.max() / totals.mean())


def capture_peer_wire():
    """Record every peer_sync request and response a port sidecar sends or
    receives (the encoded bytes), by wrapping the links' transport."""
    from kafka_lag_based_assignor_tpu_torch.federated import peers, wire

    captured = []
    real = peers._PeerLink.request

    def request(self, params):
        captured.append(wire.encode(params))
        resp = real(self, params)
        captured.append(wire.encode(resp))
        return resp

    peers._PeerLink.request = request
    return captured, lambda: setattr(peers._PeerLink, "request", real)


def partition_drill(trio, shards, members, pids, who, label: str) -> tuple:
    """A full partition (every peer link cut): sidecars ``who`` answer from
    their last good duals (``last_good_global``), then sidecar 0, its cache
    expired, on its own rows (``local_only``, held to the plain rounds
    path), with zero request errors; after the heal each of ``who``
    converges again at rung ``global`` within FED_ROUNDS.  Returns (the
    rungs, the heal's federation blocks)."""
    from kafka_lag_based_assignor_tpu_torch.utils import faults

    errors = [svc.errors for svc in trio.svcs]
    with faults.injected(faults.FaultInjector(13).plan("peer.partition", times=0)):
        part = [trio.assign(i, shards[i], members, pids[i])[0]["federation"]["rung"]
                for i in who]
        fed0 = trio.svcs[0]._federation
        with fed0._cache_lock:
            fed0._last_good["at"] -= fed0.max_staleness_s + 1.0
        part.append(trio.assign(0, shards[0], members, pids[0])[0]["federation"]["rung"])
    if (part != ["last_good_global"] * len(who) + ["local_only"]
            or [svc.errors for svc in trio.svcs] != errors):
        raise AssertionError(f"{label}: partition rungs {part}")
    for svc in trio.svcs:
        svc._watchdog.reset()
    heal = [trio.assign(i, shards[i], members, pids[i])[0]["federation"] for i in who]
    if any(h["rung"] != "global" or h["rounds"] > FED_ROUNDS for h in heal):
        raise AssertionError(f"{label}: the heal answered {heal}")
    return part, heal


def fed_config12(device, launches: dict) -> dict:
    """4k (a): config 12 (3 shards x 2,048, C 8, seed 0xFED12, 16 rounds):
    rung global on all three, quality within 5 % of the port's single-leader
    ``sinkhorn`` on the 6,144 concatenated rows, every captured peer_sync
    payload lag-free; a full partition serves last_good_global (and, with
    the cache expired, local_only) with zero request errors, a heal
    re-converges within 16 rounds; stale and fenced duals are rejected and
    counted."""
    from kafka_lag_based_assignor_tpu_torch.federated import wire
    from kafka_lag_based_assignor_tpu_torch.utils import metrics

    members = [f"m{j}" for j in range(FED_C)]
    rng = np.random.default_rng(0xFED12)
    shards = [rng.integers(0, 10**6, FED_P).astype(np.int64) for _ in range(FED_N)]
    pids = np.arange(FED_P)
    trio = FedTrio(device, "dc")
    captured, restore = capture_peer_wire()
    report = {}
    try:
        reset_counts()
        for i in range(FED_N):
            trio.assign(i, shards[i], members)
        out = [trio.assign(i, shards[i], members) for i in range(FED_N)]
        grew = read_counts()
        add_counts(launches, grew)
        rungs = [r["federation"]["rung"] for r, _ in out]
        if rungs != ["global"] * FED_N:
            raise AssertionError(f"federation 4k(a): rungs {rungs}")
        choices = [local_choice(r, members, pids) for r, _ in out]
        fed_q = fed_quality(shards, choices, FED_C)
        full = np.concatenate(shards)
        lags_p, pids_p, valid = pad_topic_rows(full)
        _, _, leader = sinkhorn.assign_topic_sinkhorn(lags_p, pids_p, valid, FED_C,
                                                      device=device)
        leader = np.asarray(torch.as_tensor(leader).cpu(), np.float64)
        leader_q = float(leader.max() / leader.mean())
        if not fed_q <= leader_q * 1.05:
            raise AssertionError(f"federation 4k(a): quality {fed_q} against the leader's "
                                 f"{leader_q}")
        for payload in captured:
            for s in shards:
                wire.assert_lag_free(payload, s)
        reset_counts()
        part, heal = partition_drill(trio, shards, members, [None] * FED_N, range(FED_N),
                                     "federation 4k(a)")
        drill = read_counts()
        add_counts(launches, drill)
        if device.type == "cuda" and drill["rounds_scan"] < 1:
            raise AssertionError(f"federation 4k(a): the local_only rung launched {drill}")

        def stale(reason):
            return metrics.REGISTRY.counter("klba_peer_stale_duals_total",
                                            {"reason": reason}).value

        fed = trio.svcs[1]._federation
        before = {r: stale(r) for r in ("stale_epoch", "fenced")}
        ok = fed.serve_sync(wire.sync_request("x", 9, 0, FED_C, scale=1.0, phase="hello",
                                              fence_token=5))
        old = fed.serve_sync(wire.sync_request("x", 3, 0, FED_C, scale=1.0, phase="hello",
                                               fence_token=5))
        fenced = fed.serve_sync(wire.sync_request("x", 10, 0, FED_C, scale=1.0,
                                                  phase="hello", fence_token=3))
        if ("rejected" in ok or old.get("rejected") != "stale_epoch"
                or fenced.get("rejected") != "fenced"
                or stale("stale_epoch") != before["stale_epoch"] + 1
                or stale("fenced") != before["fenced"] + 1):
            raise AssertionError(f"federation 4k(a): stale {old}, fenced {fenced}")
        report = {"rungs": rungs, "rounds": [r["federation"]["rounds"] for r, _ in out],
                  "walls_ms": [w for _, w in out], "quality": fed_q, "leader_quality": leader_q,
                  "payloads_audited": len(captured), "partition_rungs": part,
                  "heal_rounds": [h["rounds"] for h in heal], "launches": grew,
                  "partition_launches": drill, "local_only_checked": trio.local_only_checked}
        log(f"federation 4k(a) config 12 on 3 port sidecars (card): rungs {rungs}, rounds "
            f"{report['rounds']}, walls {report['walls_ms']} ms, quality {fed_q!r} against the "
            f"single-leader sinkhorn's {leader_q!r}; {len(captured)} peer_sync payloads "
            f"lag-free; partition {part} with zero request errors; heal rounds "
            f"{report['heal_rounds']}; stale and fenced duals rejected and counted; launches "
            f"{grew}, in the partition and heal {drill}; {trio.local_only_checked} local_only "
            "answers equal to the plain rounds path")
    finally:
        restore()
        trio.close()
    return report


def fed_config5(device, launches: dict) -> dict:
    """4k (b): config 5 (100,000 x 1,000, Zipf 1.1, seed 5) split round-robin
    by partition id over the three sidecars: rung global, each shard's
    counts within floor / ceil, the quality against the port's
    single-leader config-5 ``sinkhorn``; the walls of ``federated_assign``
    and of one exchange round, K3's event time and launches, and the
    ``round_local_shard`` wall and refine rounds."""
    from kafka_lag_based_assignor_tpu_torch.ops import fedsolve
    from kafka_lag_based_assignor_tpu_torch.utils import metrics

    lags_by_topic, members = baseline_workload(5)
    full = lags_by_topic["t0"]
    C = len(members)
    pids = [np.arange(i, full.shape[0], FED_N) for i in range(FED_N)]
    shards = [full[p] for p in pids]
    trio = FedTrio(device, "c5")
    span = metrics.REGISTRY.histogram("klba_span_duration_ms", {"span": "federation.round"})
    try:
        for i in range(FED_N):
            trio.assign(i, shards[i], members, pids[i])
        reset_counts()
        h0 = span.state()
        out = [trio.assign(i, shards[i], members, pids[i]) for i in range(FED_N)]
        h1 = span.state()
        grew = read_counts()
        add_counts(launches, grew)
        fed = [r["federation"] for r, _ in out]
        if any(f["rung"] != "global" for f in fed):
            raise AssertionError(f"federation 4k(b): {fed}")
        choices = [local_choice(r, members, p) for (r, _), p in zip(out, pids)]
        for i, ch in enumerate(choices):
            counts = np.bincount(ch, minlength=C)
            if ch.min() < 0 or counts.max() - counts.min() > 1:
                raise AssertionError(f"federation 4k(b): shard {i} counts "
                                     f"{counts.min()}..{counts.max()}")
        fed_q = fed_quality(shards, choices, C)
        lags_p, pids_p, valid = pad_topic_rows(full)
        _, _, leader = sinkhorn.assign_topic_sinkhorn(lags_p, pids_p, valid, C, device=device)
        leader = np.asarray(torch.as_tensor(leader).cpu(), np.float64)
        leader_q = float(leader.max() / leader.mean())
        rounds = sum(f["rounds"] for f in fed)
        if device.type == "cuda" and grew["plan_stats"] < rounds:
            raise AssertionError(f"federation 4k(b): {grew['plan_stats']} K3 launches for "
                                 f"{rounds} exchange rounds")
        round_ms = (h1["sum"] - h0["sum"]) / max(h1["count"] - h0["count"], 1)
        cache = trio.svcs[0]._federation._last_good
        scale, base = cache["scale"], cache["base_load"]
        weights = fedsolve.shard_dedup(shards[0], np.ones(shards[0].shape[0], bool), scale)
        k3 = median_event_ms(lambda: fedsolve.shard_marginals(*weights, cache["A"],
                                                              cache["B"], device=device))
        seen = []
        real = refine.refine_rounds_resident

        def spy(*a, **kw):
            res = real(*a, **kw)
            seen.append((res[4], res[5]))
            return res

        _, prof = profiled_call(lambda: trio.assign(0, shards[0], members, pids[0]),
                                KERNEL_NAMES["plan_stats"])
        refine.refine_rounds_resident = spy
        try:
            t0 = time.perf_counter()
            fedsolve.round_local_shard(shards[0], C, cache["A"], cache["B"], scale, base,
                                       device=device)
            sync(device)
            local_ms = (time.perf_counter() - t0) * 1e3
        finally:
            refine.refine_rounds_resident = real
        report = {"rows": [int(s.shape[0]) for s in shards], "rounds": [f["rounds"] for f in fed],
                  "converged": [f["converged"] for f in fed], "walls_ms": [w for _, w in out],
                  "round_ms": round_ms, "quality": fed_q, "leader_quality": leader_q,
                  "k3_event_ms": k3, "k3_launches": grew["plan_stats"],
                  "round_local_shard_ms": local_ms, "refine_rounds_exchanges": seen,
                  "launches": grew, "profiled_assign": prof}
        log(f"federation 4k(b) config 5 split {report['rows']} over 3 sidecars (card): rung "
            f"global, rounds {report['rounds']} (converged {report['converged']}), "
            f"federated_assign walls {report['walls_ms']} ms, one exchange round {round_ms!r} "
            f"ms (span mean), quality {fed_q!r} against the single-leader sinkhorn's "
            f"{leader_q!r}; K3 event {k3!r} ms at the shard's U_pad {weights[0].shape[0]}, "
            f"{grew['plan_stats']} launches; round_local_shard {local_ms!r} ms, refine "
            f"(rounds, exchanges) {seen}; one profiled federated_assign {prof}")
    finally:
        trio.close()
    return report


def fed_weighted(device, launches: dict) -> dict:
    """4k (c): three sidecars advertising capacity 1:2:1 over the members:
    every shard's counts equal ``apportion_counts`` of its rows."""
    from kafka_lag_based_assignor_tpu_torch.ops import fedsolve

    members = [f"m{j}" for j in range(FED_C)]
    rng = np.random.default_rng(0xFED13)
    shards = [rng.integers(0, 10**6, FED_P).astype(np.int64) for _ in range(FED_N)]
    trio = FedTrio(device, "w", federation_capacity=FED_CAPACITY)
    try:
        reset_counts()
        for i in range(FED_N):
            trio.assign(i, shards[i], members)
        out = [trio.assign(i, shards[i], members)[0] for i in range(FED_N)]
        add_counts(launches, read_counts())
        frac = np.asarray(FED_CAPACITY) / sum(FED_CAPACITY)
        target = fedsolve.apportion_counts(FED_P, frac)
        for i, r in enumerate(out):
            sizes = np.array([len(r["assignments"][m]) for m in members])
            if r["federation"]["rung"] != "global" or not np.array_equal(sizes, target):
                raise AssertionError(f"federation 4k(c): shard {i} {r['federation']}, "
                                     f"counts {sizes} against {target}")
        log(f"federation 4k(c) capacity {FED_CAPACITY}: rung global, every shard's counts "
            f"{target.tolist()} = apportion_counts")
        return {"counts": target.tolist()}
    finally:
        trio.close()


def fed_k3_args(lags: np.ndarray, C: int, device) -> list:
    """K3's inputs in one exchange round on a federated shard: the shard's
    dedup under the global scale (``FED_N`` such shards) and duals at C."""
    from kafka_lag_based_assignor_tpu_torch.ops import fedsolve

    w = fedsolve.shard_dedup(lags, np.ones(lags.shape[0], bool),
                             float(lags.sum()) * FED_N / C)
    return [torch.from_numpy(a).to(device) for a in w] + list(random_duals(C, device))


def fed_k3_check(device, shards=None) -> float:
    """4k (d): K3 at the federated shards' U_pad (config 12's and config 5's
    shard dedup under their global scales; ``shards``, (name, lags, C)
    triples, gives others) against its plain version, ``need="both"``."""
    if shards is None:
        rng = np.random.default_rng(0xFED12)
        c12 = rng.integers(0, 10**6, FED_P).astype(np.int64)
        full = baseline_workload(5)[0]["t0"]
        shards = (("config12 shard", c12, FED_C), ("config5 shard", full[0::FED_N], STREAM_C))
    worst = 0.0
    for name, lags, C in shards:
        args = fed_k3_args(lags, C, device)
        got = plan_stats.plan_stats(*args, need="both")
        again = plan_stats.plan_stats(*args, need="both")
        want = plan_stats.plan_stats_torch(*args, need="both")
        worst = max(worst, f32_check("plan_stats", f"{name} U={args[0].shape[0]} C={C}",
                                     got, want, again))
    return worst


def federation_path(device) -> tuple:
    """Phase 4k: (a) config 12 on three sidecars, (b) config 5 split three
    ways, (c) the weighted form, (d) K3 at the shards' shapes.  Returns (the
    launches of (a)-(c), K3's max |diff|, the ``federation`` line)."""
    t0 = time.perf_counter()
    launches = {name: 0 for name, _ in COUNTERS}
    report = {}
    k3_err = fed_k3_check(device)
    report["config12"] = fed_config12(device, launches)
    report["config5"] = fed_config5(device, launches)
    report["weighted"] = fed_weighted(device, launches)
    report["launches"] = dict(launches)
    report["seconds"] = time.perf_counter() - t0
    log(f"federation path launches {launches} in {report['seconds']!r} s")
    return launches, k3_err, report


def median_event_ms(fn, repeats: int = REPEATS) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def network(n: int) -> tuple:
    """(stages, compare-exchanges) of one bitonic sort of ``n`` keys, on
    ``rounds_cuda.slots_for(n)`` slots."""
    slots = rounds_cuda.slots_for(n)
    log_n = int(math.log2(slots))
    stages = log_n * (log_n + 1) // 2
    return stages, stages * (slots // 2)


def bound_ms(T: int, R: int, C: int) -> tuple:
    """The least time for the work: each input read once, each output
    written once, over the HBM rate; or the compare-exchanges of the
    bitonic network over the scalar rate — whichever is larger."""
    moved = T * R * C * (8 + 1 + 4) + C * 8 + T * C * 8
    stages, compares = network(C)
    ops = T * R * compares
    by_bytes, by_ops = moved / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations", stages


def k1_cases(device):
    """K1's two timed shapes, as the main path makes them: (name, (gains,
    valid, totals0), carry).  Config 5 is one block of 100 rounds of 1,000
    consumers; config 3 ``global`` one block of 256 rounds of 64."""
    lags, members = baseline_workload(5)
    P = lags["t0"].size
    yield ("config 5", round_inputs(lags["t0"][None], np.array([P]), len(members), device),
           False)
    lags, members = baseline_workload(3)
    table = np.stack([lags[t] for t in sorted(lags)])
    yield ("config 3 global",
           round_inputs(table, np.full(len(table), table.shape[1]), len(members), device), True)


def k1_wide_cases(device):
    """K1 past the register network, for the A/B modes: phase 4l's rounds
    (T 1, R 10, C 20,000: 32,768 slots) and 10 rounds of 60,000 and of
    120,000 consumers (65,536 and 131,072 slots), uniform lags from seed 1.
    Yields as ``k1_cases``."""
    arr = wide_workload()[0]["t0"]
    yield "wide group", round_inputs(arr[None], np.array([WIDE_P]), WIDE_C, device), False
    rng = np.random.default_rng(1)
    for C in (60_000, 120_000):
        yield (f"{rounds_cuda.slots_for(C)} slots",
               round_inputs(rng.integers(0, 10**6, (1, 10 * C)), np.array([10 * C]), C, device),
               False)


def k1_times(device, cases=None) -> dict:
    """K1 through its wrapper at each of ``cases`` (``k1_cases``): the
    CUDA-event time (the wrapper's checks and host read included), the
    device time alone (profiler, by kernel name) and the kernels it ran, per
    round and per network stage, beside the bound, with a digest of its
    output's bits; past the register network also its plain version's
    event time (median of 5).  Uses only the wrapper's public interface, so
    that it times any version of the package on the path."""
    out = {}
    for name, (gains, valid, totals0), carry in (k1_cases(device) if cases is None else cases):
        T, R, C = gains.shape
        depth = T * R if carry else R  # rounds in one block's chain

        def fn():
            return rounds_cuda.rounds_scan(gains, valid, totals0, carry)

        event = median_event_ms(fn)
        prof = device_profile(fn, KERNEL_NAMES["rounds_scan"])
        alone, per_call = prof["alone_ms"], prof["launches"]
        bound, bound_by, stages = bound_ms(T, R, C)
        packed = getattr(rounds_cuda, "packed_rank_bits", None)
        rank_bits = packed(gains, valid, totals0, carry) if packed else None
        two_key = None
        if rank_bits:  # the same inputs forced into the two-key form
            two_key, _ = device_ms(
                lambda: rounds_cuda._launch(gains, valid, totals0, carry, 0),
                KERNEL_NAMES["rounds_scan"])
        plain = None
        if rounds_cuda.slots_for(C) > rounds_cuda.REGISTER_SLOTS:
            plain = median_event_ms(lambda: rounds_cuda.rounds_scan_torch(
                gains, valid, totals0, carry, rank_bits or 0), 5)
        out[name] = {
            "T": T, "R": R, "C": C, "carry": carry, "rank_bits": rank_bits,
            "event_ms": event, "alone_ms": alone, "launches_a_call": per_call,
            "kernels": sorted(prof["by_kernel"]), "bits": bits(fn()),
            "ns_a_round": alone * 1e6 / depth, "ns_a_stage": alone * 1e6 / (depth * stages),
            "two_key_alone_ms": two_key, "plain_ms": plain, "bound_ms": bound,
            "bound_by": bound_by,
        }
        log(f"times  rounds_scan at {name} (T={T} R={R} C={C} carry={carry}, rank_bits "
            f"{rank_bits}): event {event!r} ms, device time alone {alone!r} ms "
            f"({per_call!r} kernels a call: {out[name]['kernels']}), "
            f"{alone * 1e6 / depth!r} ns a round, "
            f"{alone * 1e6 / (depth * stages)!r} ns a stage of {stages}, bound {bound!r} ms "
            f"({bound_by}); forced into the two-key form, alone {two_key!r} ms; plain "
            f"{plain!r} ms; bits {out[name]['bits']}")
    return out


# assign() walls at config 5 take about 2-3 s each: their medians are of
# fewer runs.
CONFIG5_WALL_REPEATS = 3
# The warm-ups before each config-5 median: in one run on the H100 the
# medians after one and after three warm-ups differed by less than the
# three timed calls' own spread (PERF.md).
CONFIG5_WARMUPS = 1
# The config-5 assignors the medians warmed, by (cfg, solver, refine):
# ``profiled_assign`` profiles those cells on them.
WARMED = {}


def assign_walls(cfg: int, solver: str, device, repeats: int = REPEATS, refine=None):
    """Medians of ``repeats`` ``assign()`` calls (at most
    ``CONFIG5_WALL_REPEATS`` at config 5) after 3 warm-ups
    (``CONFIG5_WARMUPS`` at config 5), host clock, ending in a synchronize:
    (wall, lag read, solve, min wall).  At config 5 it logs every call's
    wall and lag read, warm-ups included, and keeps the assignor in
    ``WARMED``."""
    warmups = 3
    if cfg == 5:
        repeats, warmups = min(repeats, CONFIG5_WALL_REPEATS), CONFIG5_WARMUPS
    lags, members = baseline_workload(cfg)
    run = plugin(lags, members, solver, device, refine)
    walls, parts = [], []
    for _ in range(repeats + warmups):
        t0 = time.perf_counter()
        checked_assign(*run)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        stats = run[0].last_stats
        parts.append((stats.lag_read_ms, stats.solve_ms))
    if cfg == 5:
        WARMED[(cfg, solver, refine)] = run
        log(f"assign() walls at config 5 {solver} refine {refine}, warm-ups included: "
            f"{walls} ms, lag reads {[p[0] for p in parts]} ms")
    walls, parts = walls[warmups:], parts[warmups:]
    return (statistics.median(walls), statistics.median(p[0] for p in parts),
            statistics.median(p[1] for p in parts), min(walls))


def times(device) -> dict:
    """K1 at config 5 (the launch alone, through the wrapper, the plain
    version) and ``k1_times``.  Returns the kernels-line fields."""
    lags, members = baseline_workload(5)
    P = lags["t0"].size
    C = len(members)
    gains, valid, totals0 = round_inputs(lags["t0"][None], np.array([P]), C, device)
    T, R, _ = gains.shape
    rb = rounds_cuda.packed_rank_bits(gains, valid, totals0)
    kernel = median_event_ms(lambda: rounds_cuda._launch(gains, valid, totals0, False, rb))
    wrapper = median_event_ms(lambda: rounds_cuda.rounds_scan(gains, valid, totals0))
    plain = median_event_ms(
        lambda: rounds_cuda.rounds_scan_torch(gains, valid, totals0, False, rb))
    plain_two_key = median_event_ms(
        lambda: rounds_cuda.rounds_scan_torch(gains, valid, totals0, False, 0))
    bound, bound_by, stages = bound_ms(T, R, C)
    log(f"times at config 5 (T={T} R={R} C={C}, rank_bits {rb}, {R * stages} network "
        f"stages): kernel {kernel!r} ms ({kernel * 1e6 / (R * stages):.1f} ns a stage), "
        f"wrapper with its checks {wrapper!r} ms, plain version on the card {plain!r} ms "
        f"(its two-key body {plain_two_key!r} ms), bound {bound!r} ms ({bound_by})")
    alone = k1_times(device)["config 5"]["alone_ms"]
    return dict(ms=kernel, alone_ms=alone, plain_ms=plain, bound_ms=bound, bound_by=bound_by,
                library_ms=None)


def cell_times(device) -> None:
    """``--cells``: the ``assign()`` walls of the phase-4 cells on the host
    clock, medians of ``CONFIG5_WALL_REPEATS`` at config 5 (``rounds``,
    ``sinkhorn``, ``scan``, ``rounds`` + 16 refine rounds) and of
    ``REPEATS`` at config 4 (``sinkhorn``), each split into lag read, solve
    and the rest, then every cell's device share (``device_shares``).
    These measure cells; the checks of those cells are phases 4a-4d's."""
    for cfg, solver, refine_iters in ((5, "rounds", None), (4, "sinkhorn", None),
                                      (5, "sinkhorn", None), (5, "scan", None),
                                      (5, "rounds", REFINE_ITERS)):
        wall, lag_read, solve, fastest = assign_walls(cfg, solver, device, refine=refine_iters)
        log(f"assign() at config {cfg} {solver} refine {refine_iters}, medians of "
            f"{CONFIG5_WALL_REPEATS if cfg == 5 else REPEATS} (host clock): wall {wall!r} ms "
            f"(min {fastest!r}), lag read {lag_read!r} ms (FakeBroker), solve {solve!r} ms, "
            f"the rest (stats, result objects) {wall - lag_read - solve!r} ms")
    device_shares(device)


def k7_cases(device):
    """K7's inputs as the main path makes them, at configs 5 and 3: each
    topic padded to its bucket, sorted into processing order.  Yields
    (name, sorted lags, sorted valid, C, the lags' range as ``dispatch``
    hands it to the wrapper, or None where the wrapper takes none)."""
    host_range = getattr(scan_cuda, "host_lag_range", None)
    for cfg in (5, 3):
        lags, members = baseline_workload(cfg)
        table = np.stack([pad_topic_rows(lags[t])[0] for t in sorted(lags)])
        n_valid = np.array([lags[t].size for t in sorted(lags)])
        T, P = table.shape
        L = torch.from_numpy(table).to(device)
        pids = torch.arange(P, dtype=torch.int32, device=device).expand(T, P)
        V = torch.arange(P, device=device)[None, :] < torch.from_numpy(n_valid).to(device)[:, None]
        _, sl, sv = sort_partitions_with(L, pids, V, pack_shift_for(int(table.max()), P - 1))
        yield (f"config {cfg}", sl.contiguous(), sv.to(torch.uint8).contiguous(), len(members),
               host_range(table, n_valid) if host_range else None)


def k7_bound(T: int, P: int, C: int, E: int, n_valid) -> tuple:
    """(bound ms, "bytes" or "operations"): each input read once and each
    output written once over the HBM rate, or the compare-exchanges the
    function needs over the scalar rate: per topic, ceil(n / E) sorts of E
    keys (``network``) for its n valid rows."""
    moved = T * P * (8 + 1 + 4) + T * C * (4 + 8)
    compares = network(E)[1] * sum(-(-int(n) // E) for n in n_valid) if E else 0
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = compares / SCALAR_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def once_event_ms(fn) -> tuple:
    """(CUDA-event ms of one ``fn()`` call, its result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


# Rows of config 5's processing order that K7's plain version runs on the
# card in phase 5: its loop is one torch step a row, and all 100,000 took
# about 35 s of the script.
K7_PLAIN_ROWS = 10_000
# The direct-API cases of ``scan_cases`` that ``k7_times`` times beside
# the main path's: E small against C, and padding in the middle.
K7_TIMED = ("E1_of_C1000", "E33_of_C1000", "E2_of_C16384", "padded_batch")


def k7_inputs(device):
    """K7's timed inputs: the main path's at configs 5 and 3 (``k7_cases``),
    then ``K7_TIMED``.  Yields (name, sorted lags, sorted valid, C,
    eligible or None, the lags' range or None)."""
    for name, sl, sv, C, lag_range in k7_cases(device):
        yield name, sl, sv, C, None, lag_range
    for name, lags, valid, C, elig in scan_cases():
        if name in K7_TIMED:
            yield (name, torch.from_numpy(lags.astype(np.int64)).to(device),
                   torch.from_numpy(valid.astype(np.uint8)).to(device), C,
                   None if elig is None else torch.from_numpy(elig.astype(np.uint8)).to(device),
                   None)


def k7_wide_inputs(device):
    """K7 past the register network, for the A/B modes: phase 4l's input
    (``wide_scan_input``: 10 rounds of 20,000, 32,768 slots) and 10 rounds
    of 60,000 and of 120,000 consumers (65,536 and 131,072 slots), uniform
    lags from seed 1 in processing order.  Yields as ``k7_inputs``."""
    sl, sv, lag_range = wide_scan_input(device)
    yield "wide group", sl, sv, WIDE_C, None, lag_range
    rng = np.random.default_rng(1)
    for C in (60_000, 120_000):
        lags = -np.sort(-rng.integers(0, 10**6, (1, 10 * C)), axis=1)
        yield (f"{rounds_cuda.slots_for(C)} slots", torch.from_numpy(lags).to(device),
               torch.ones(lags.shape, dtype=torch.uint8, device=device), C, None,
               scan_cuda.host_lag_range(lags, np.array([10 * C])))


def k7_times(device, inputs=None) -> dict:
    """K7 through its wrapper at each of ``inputs`` (``k7_inputs``), called
    as the main path calls it (with the lags' range where this version
    takes one): CUDA-event time (the wrapper's host work included), device
    time alone (profiler, by kernel name) and the kernels it ran, time a
    valid row of the deepest topic, its depth as the round form has it
    (rounds of E rows, stages of a sort of next_pow2(E) slots), the bound
    and a digest of its output's bits.  Uses only the wrapper's public
    interface, so that it times any version of the package (``--k7-ab``)."""
    out = {}
    for name, sl, sv, C, elig, lag_range in (k7_inputs(device) if inputs is None else inputs):
        T, P = sl.shape
        n_valid = sv.sum(dim=1).tolist()
        depth = int(max(n_valid))
        E = C if elig is None else int(elig.sum())
        rounds, stages = -(-depth // max(E, 1)), network(E)[0]
        ranged = {} if lag_range is None else {"lag_range": lag_range}

        def fn():
            return scan_cuda.scan_greedy(sl, sv, C, elig, **ranged)

        event = median_event_ms(fn)
        prof = device_profile(fn, KERNEL_NAMES["scan_greedy"])
        alone, per_call = prof["alone_ms"], prof["launches"]
        bound, bound_by = k7_bound(T, P, C, E, n_valid)
        out[name] = {"T": T, "P": P, "C": C, "E": E, "depth": depth, "rounds": rounds,
                     "stages": stages, "event_ms": event, "alone_ms": alone,
                     "launches_a_call": per_call, "kernels": sorted(prof["by_kernel"]),
                     "bits": bits(fn()), "ns_a_step": alone * 1e6 / max(depth, 1),
                     "bound_ms": bound, "bound_by": bound_by}
        log(f"times  scan_greedy at {name} (T={T} P={P} C={C} E={E}, {depth} valid rows in "
            f"the deepest topic: {rounds} rounds x {stages} stages): event {event!r} ms, "
            f"device time alone {alone!r} ms ({per_call!r} kernels a call: "
            f"{out[name]['kernels']}), {alone * 1e6 / max(depth, 1)!r} ns a row, bound "
            f"{bound!r} ms ({bound_by}); bits {out[name]['bits']}")
    return out


def solver_times(device, plain_cpu_ms: dict) -> dict:
    """K7's times (``k7_times``), its plain version on the card at configs 5
    (one call on the first K7_PLAIN_ROWS rows of the processing order, a
    torch loop of as many steps, whose output must equal the kernel's on
    the same rows, and the kernel's time there) and 3 (median).  Returns
    the kernels-line fields: the standard
    ones at config 5, where K7 spends its time (``plain_ms`` on the cut
    rows, beside the kernel's ``plain_rows_ms`` there); config 3's under
    ``config3_*``; the CPU plain version's time from phase 3 (all config
    5's rows) under ``plain_cpu_ms``."""
    k7 = k7_times(device)
    for name, sl, sv, C, _ in k7_cases(device):
        if name == "config 3":
            plain = median_event_ms(lambda: scan_cuda.scan_greedy_torch(sl, sv, C))
        else:
            sl, sv = sl[:, :K7_PLAIN_ROWS].contiguous(), sv[:, :K7_PLAIN_ROWS].contiguous()
            plain, want = once_event_ms(lambda: scan_cuda.scan_greedy_torch(sl, sv, C))
            if not all(torch.equal(a, b) for a, b in zip(scan_cuda.scan_greedy(sl, sv, C), want)):
                raise AssertionError(f"scan_greedy disagrees with its plain version at {name}")
            k7[name]["plain_rows"] = K7_PLAIN_ROWS
            k7[name]["plain_rows_ms"] = median_event_ms(lambda: scan_cuda.scan_greedy(sl, sv, C))
        k7[name]["plain_ms"] = plain
        log(f"times  scan_greedy's plain version on the card at {name}: {plain!r} ms"
            + (f" (one call on the first {K7_PLAIN_ROWS} rows; the kernel there "
               f"{k7[name]['plain_rows_ms']!r} ms)" if name == "config 5" else ""))
    c3, c5 = k7["config 3"], k7["config 5"]
    return dict(ms=c5["event_ms"], alone_ms=c5["alone_ms"], plain_ms=c5["plain_ms"],
                bound_ms=c5["bound_ms"], bound_by=c5["bound_by"], library_ms=None,
                depth=c5["depth"], rounds=c5["rounds"], stages=c5["stages"],
                ns_a_step=c5["ns_a_step"], plain_rows=c5["plain_rows"],
                plain_rows_ms=c5["plain_rows_ms"], plain_cpu_ms=plain_cpu_ms["config 5"],
                config3_ms=c3["event_ms"], config3_alone_ms=c3["alone_ms"],
                config3_plain_ms=c3["plain_ms"], config3_bound_ms=c3["bound_ms"],
                config3_plain_cpu_ms=plain_cpu_ms["config 3"],
                direct_api={name: {k: k7[name][k] for k in ("E", "alone_ms", "event_ms")}
                            for name in K7_TIMED})


def exp_bound(exps: int, moved: int) -> tuple:
    """(bound ms, "operations" or "bytes"): the larger of the exps over the
    card's exp rate and the bytes over its memory rate."""
    by_ops, by_bytes = exps / EXPS_PER_S * 1e3, moved / HBM_BYTES_PER_S * 1e3
    return max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes"


def softmax_library(ws, A, B, weights):
    """The library yardstick: torch.softmax over the materialized logits,
    then one matrix product per weight vector (timed, never used by the
    port)."""
    x = torch.softmax(-ws[:, None] * A + B, dim=1)
    return [torch.mv(x.T, w) for w in weights]


def superblock_library(ws_b, cnt_b, A, B):
    Sb = ws_b.shape[0]
    x = torch.softmax(-ws_b.reshape(-1)[:, None] * A + B, dim=1).reshape(Sb, -1, A.shape[0])
    return [torch.matmul(w.reshape(Sb, 1, -1), x) for w in (ws_b, cnt_b)]


def superblock_library_each(ws_b, cnt_b, A, B):
    """``superblock_library`` one superblock at a time: at the wide group
    the whole plan is 21 GB, one superblock's 2.6 GB."""
    return [superblock_library(ws_b[s:s + 1], cnt_b[s:s + 1], A, B)
            for s in range(ws_b.shape[0])]




def pad_for(attempt: int) -> float:
    """The idle pad on each side of a profiler step on try ``attempt``."""
    return min(PROFILER_PAD_S * 4 ** attempt, SKEW_PAD_S)


def profiler_skew(label: str) -> dict:
    """How far torch.profiler's device timestamps sit from its host ones,
    ``label``-ed with the process's age: 20 times, one one-kernel op on the
    idle card, then a wait for it; the gap from each op's start on the host
    to its kernel's start on the device (tens of microseconds when the two
    clocks agree; an offset between them moves every gap by the same
    amount).  Logged and returned as its median, least and largest."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1024, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(SKEW_PAD_S)
        for _ in range(20):
            x.add_(1)
            torch.cuda.synchronize()
            time.sleep(0.002)
        time.sleep(SKEW_PAD_S)
    events = prof.events()
    ops = sorted(e.time_range.start for e in events if e.name == "aten::add_")
    kernels = sorted(e.time_range.start for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "elementwise" in e.name)
    gaps = [(k - o) / 1e3 for o, k in zip(ops, kernels)] if len(ops) == len(kernels) else []
    out = {"at": label, "age_s": time.perf_counter() - T_START, "ops": len(ops),
           "kernels": len(kernels), "gap_ms": statistics.median(gaps) if gaps else None,
           "min_ms": min(gaps) if gaps else None, "max_ms": max(gaps) if gaps else None}
    log(f"profiler skew {json.dumps(out)}")
    return out


def profiler_probe() -> dict:
    """The profiler alone in a fresh process, torch's own kernels only:
    ``profiler_skew`` three times back to back, again after 50,000
    launches with no profiler on, again after a minute idle, two
    ``device_profile`` calls of one op, then after each of 12 bursts of
    launches.  Returns the probes and the sessions counted."""
    x = torch.zeros(1 << 20, device="cuda")
    probes = [profiler_skew(f"fresh {i}") for i in range(3)]
    for _ in range(50_000):
        x.add_(1)
    torch.cuda.synchronize()
    probes += [profiler_skew(f"after 50,000 launches {i}") for i in range(2)]
    time.sleep(60)
    probes += [profiler_skew(f"after a minute idle {i}") for i in range(2)]
    for _ in range(2):
        device_profile(lambda: x.mul_(1.0), "elementwise")
    # Four minutes of bursts: 5 s of launches, 10 s idle, one probe.
    a = torch.randn(2048, 2048, device="cuda")
    for i in range(12):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 5:
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()
        time.sleep(10)
        probes.append(profiler_skew(f"burst {i}"))
    return {"probes": probes, "sessions": SESSIONS}


def device_profile(fn, kernel: str, repeats: int = REPEATS) -> dict:
    """What one ``fn()`` enqueues on the device, from torch.profiler's CUDA
    activity over ``repeats`` (REPEATS) calls, divided by their count: ``alone_ms``, the time
    in the CUDA kernels whose name holds ``kernel`` (one of KERNEL_NAMES),
    and ``launches``, their count; ``all_ops_ms``, the time of everything
    the call enqueued (kernels, memsets and copies); ``kernels`` and
    ``memsets``, the counts of each; ``by_kernel``, ``alone_ms`` split by
    kernel name.  Unlike the CUDA-event time it leaves
    out the host's launch gaps.  A session first runs ``repeats`` calls with
    the profiler warming up (their records are dropped), then records
    as many.  A session that lost records (an op counted a number of
    times that is not a multiple of ``repeats``) or gave the named kernels no
    time is repeated, up to five in all; raises when none was whole, so that
    neither a renamed kernel nor a lost record can read as a cheaper call.
    Each step's calls sit between two idle pads (``pad_for``)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        sessions = []
        SESSIONS["recorded"] += 1
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: sessions.append(p.key_averages())) as prof:
            for _ in range(2):
                time.sleep(pad_for(attempt))
                for _ in range(repeats):
                    fn()
                torch.cuda.synchronize()
                time.sleep(pad_for(attempt))
                prof.step()
        cuda = [e for e in sessions[-1]
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "Activity Buffer" not in e.key]
        hits = [e for e in cuda if kernel in e.key]
        lost = [(e.key[:40], e.count) for e in cuda if e.count % repeats]
        if hits and sum(e.self_device_time_total for e in hits) > 0 and not lost:
            def ms(events):
                return sum(e.self_device_time_total for e in events) / repeats / 1e3

            def count(events):
                return sum(e.count for e in events) // repeats

            return {
                "alone_ms": ms(hits),
                "by_kernel": {e.key[:60]: ms([e]) for e in hits},
                "launches": count(hits),
                "all_ops_ms": ms(cuda),
                "kernels": count(e for e in cuda
                                 if "Memset" not in e.key and "Memcpy" not in e.key),
                "memsets": count(e for e in cuda if "Memset" in e.key),
            }
        SESSIONS["discarded"] += 1
        log(f"profiler session {attempt + 1} lost records or gave no time to kernels named "
            f"{kernel!r}; it recorded {[(e.key[:40], e.count) for e in cuda]}")
    raise AssertionError(f"no whole profiler session for kernels named {kernel!r}")


def device_ms(fn, kernel: str) -> tuple:
    """(device time alone, launches) of one ``fn()`` in the kernels named
    ``kernel`` (``device_profile``)."""
    prof = device_profile(fn, kernel)
    return prof["alone_ms"], prof["launches"]


def op_times(fn, kernel: str, repeats: int = REPEATS) -> dict:
    """CUDA-event time of ``fn()`` (median of ``repeats``) beside its
    ``device_profile``."""
    return {"event_ms": median_event_ms(fn, repeats),
            **device_profile(fn, kernel, repeats)}


def call_plan_stats(args, need: str):
    """K3 through its public wrapper for ``need``; a package without
    ``need`` (this change's parent) computes both marginals."""
    if HAS_NEED:
        return plan_stats.plan_stats(*args, need=need)
    return plan_stats.plan_stats(*args)


HAS_NEED = "need" in inspect.signature(plan_stats.plan_stats).parameters


def one_launch_a_call(device) -> None:
    """From the profiler: one call of K3 at the dense main path's shapes
    (configs 2 and 4, ``need`` load and colsum) and of K6 at config 5's
    resident state enqueues one kernel and no memset."""
    calls = []
    for config in (2, 4):
        (ws, cnt, wsum), C = dedup_case(config, device)
        args = (ws, cnt, wsum, *random_duals(C, device))
        for need in ("load", "colsum"):
            calls.append((f"plan_stats config {config} need={need}", "plan_stats",
                          lambda args=args, need=need: call_plan_stats(args, need)))
    lags, choice, counts, tab = resident_case(pad_bucket(STREAM_P), STREAM_P, STREAM_C, device)
    calls.append(("state_digest config 5", "state_digest",
                  lambda: refine.state_digest(lags, choice, counts, STREAM_C, row_tab=tab)))
    for label, name, fn in calls:
        prof = device_profile(fn, KERNEL_NAMES[name])
        log(f"enqueued a call  {label}: {prof['kernels']!r} kernels, {prof['memsets']!r} "
            f"memsets")
        if prof["kernels"] != 1 or prof["memsets"] != 0:
            raise AssertionError(f"{label}: a call enqueued {prof}, not one kernel")


def k3_times(device) -> dict:
    """K3 through its public wrapper at the dense path's shapes (configs 2
    and 4), for each ``need`` (``op_times``), and its library yardstick for
    the load alone (softmax and one ``mv``, beside need=load) and for both
    marginals (softmax and two, beside need=both): CUDA-event time and
    device time of all its ops.  Returns {config: row}."""
    out = {}
    for config in (2, 4):
        (ws, cnt, wsum), C = dedup_case(config, device)
        A, B = random_duals(C, device)
        args = (ws, cnt, wsum, A, B)
        row = {"U_pad": ws.shape[0], "U": int((cnt > 0).sum()), "C": C}
        for need in ("load", "colsum", "both"):
            row[need] = op_times(lambda: call_plan_stats(args, need),
                                 KERNEL_NAMES["plan_stats"])
        for need, weights in (("load", (wsum,)), ("both", (wsum, cnt))):
            def library(weights=weights):
                return softmax_library(ws, A, B, weights)

            row[f"library_{need}"] = {"event_ms": median_event_ms(library),
                                      "all_ops_ms": device_profile(library, "")["all_ops_ms"]}
        out[config] = row
        log(f"times  plan_stats at config {config} (U_pad {row['U_pad']}, {row['U']} with "
            f"weight, C {C}): " + "; ".join(
                f"need={need} event {row[need]['event_ms']!r} ms, alone "
                f"{row[need]['alone_ms']!r} ms, all ops {row[need]['all_ops_ms']!r} ms "
                f"({row[need]['kernels']!r} kernels, {row[need]['memsets']!r} memsets)"
                for need in ("load", "colsum", "both"))
            + "; " + "; ".join(
                f"library yardstick for need={need} event {row[f'library_{need}']['event_ms']!r}"
                f" ms, device time (all its ops) {row[f'library_{need}']['all_ops_ms']!r} ms"
                for need in ("load", "both")))
    return out


def quality_times(device) -> dict:
    """Each f32 kernel at its main-path shape: kernel (K3 through its
    wrapper for the load, as the duals loop's first call), plain version
    and library yardstick (CUDA events, medians of 30), the kernel's device
    time alone and of all its ops (profiler) and its bound; then the
    sinkhorn walls.  Returns {name: kernels-line fields}."""
    k3 = k3_times(device)[4]
    (ws, cnt, wsum), C = dedup_case(4, device)
    A, B = random_duals(C, device)
    U = int((cnt > 0).sum())
    out = {"plan_stats": dict(
        zip(("bound_ms", "bound_by"), exp_bound(U * C, 4 * (2 * ws.shape[0] + 3 * C))),
        ms=k3["load"]["event_ms"], alone_ms=k3["load"]["alone_ms"],
        all_ops_ms=k3["load"]["all_ops_ms"],
        plain_ms=median_event_ms(
            lambda: plan_stats.plan_stats_torch(ws, cnt, wsum, A, B, "load")),
        library_ms=k3["library_load"]["event_ms"],
        library_alone_ms=k3["library_load"]["all_ops_ms"],
    )}
    shapes = {"plan_stats": f"config 4: U_pad {ws.shape[0]} ({U} with weight), C {C}, "
                            "need=load"}

    (ws_b, cnt_b), C = blocks_case(5, device)
    A, B = random_duals(C, device)
    # Rows with a weight: the corrector pass and K5 compute those with ws or
    # cnt non-zero, the predictor those with ws non-zero.
    rows = int(((ws_b != 0) | (cnt_b != 0)).sum())
    load_rows = int((ws_b != 0).sum())
    Sb = ws_b.shape[0]
    sc, prev = torch.tensor(1.0, device=device), torch.tensor(float("inf"), device=device)
    eta = linear_ot.MIRROR_PROX_ETA

    def k5():
        return linear_ot_cuda.superblock_partials(ws_b, cnt_b, A, B)

    def k4():
        return linear_ot_cuda.mirror_prox_step(ws_b, cnt_b, A, B, sc, prev, eta=eta)

    out["superblock_partials"] = dict(
        zip(("bound_ms", "bound_by"),
            exp_bound(rows * C, 4 * (2 * ws_b.numel() + 2 * C + 2 * Sb * C))),
        ms=median_event_ms(k5),
        plain_ms=median_event_ms(lambda: linear_ot._superblock_partials(ws_b, cnt_b, A, B)),
        library_ms=median_event_ms(lambda: superblock_library(ws_b, cnt_b, A, B)),
    )
    out["mirror_prox_step"] = dict(
        zip(("bound_ms", "bound_by"),
            exp_bound((rows + load_rows) * C, 4 * (2 * ws_b.numel() + 2 * C + 2 + 3 * C))),
        ms=median_event_ms(k4),
        plain_ms=median_event_ms(lambda: linear_ot_cuda.mirror_prox_step_torch(
            ws_b, cnt_b, A, B, sc, prev, eta=eta)),
        library_ms=None,
    )
    shape = f"config 5: {list(ws_b.shape)} ({rows} valid rows), C {C}"
    # K5 with both marginals is the launch of K4's corrector pass; the
    # predictor pass launches it for the load only.
    shapes.update(superblock_partials=f"{shape}, both marginals",
                  mirror_prox_step=shape)
    for name, fn in (("superblock_partials", k5), ("mirror_prox_step", k4)):
        prof = device_profile(fn, KERNEL_NAMES[name])
        out[name].update(alone_ms=prof["alone_ms"], all_ops_ms=prof["all_ops_ms"])
    per_step = device_profile(k4, KERNEL_NAMES["mirror_prox_step"])["launches"]
    if per_step > 2:
        raise AssertionError(f"mirror_prox_step launched {per_step} kernels a step")
    log(f"mirror_prox_step: {per_step!r} kernel launches a step (profiler)")

    for name, t in out.items():
        log(f"times  {name:19s} at {shapes[name]}: kernel {t['ms']!r} ms (device time "
            f"alone {t['alone_ms']!r} ms, all ops {t['all_ops_ms']!r} ms), plain version "
            f"{t['plain_ms']!r} ms, library yardstick {t['library_ms']!r} ms, bound "
            f"{t['bound_ms']!r} ms ({t['bound_by']}), {t['ms'] / t['bound_ms']:.1f}x the bound")
    return out


def profiled_assign(cfg: int, solver: str, refine_iters, device) -> dict:
    """One assign() of a phase-4 cell under torch.profiler: its wall (ms,
    host clock), the device's busy time (ms), the port's kernels' part of
    it and the five busiest device ops.  The cell's assignor is the one
    phase 5's medians warmed (``WARMED``), else a new one after one
    ``assign()``.  A session first runs one assign() with the profiler
    warming up (its records are dropped), then records one.  Every
    main-path cell launches a port kernel, so a session that recorded none
    of them lost its records: it is repeated, up to three in all, with the
    pads of ``pad_for``; ``None`` when none was whole."""
    from torch.profiler import ProfilerActivity, profile, schedule

    run = WARMED.pop((cfg, solver, refine_iters), None)
    if run is None:
        run = plugin(*baseline_workload(cfg), solver, device, refine_iters)
        checked_assign(*run)
    assignor, cluster, group = run
    ours = tuple(dict.fromkeys(KERNEL_NAMES.values()))
    for attempt in range(3):
        sessions, walls = [], []
        SESSIONS["recorded"] += 1
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: sessions.append(p.key_averages())) as prof:
            for _ in range(2):
                time.sleep(pad_for(attempt))
                t0 = time.perf_counter()
                checked_assign(assignor, cluster, group)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                time.sleep(pad_for(attempt))
                prof.step()
        events = [
            e for e in (sessions[-1] if sessions else [])
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "Activity Buffer" not in e.key
        ]
        kernels = sum(
            e.self_device_time_total for e in events if any(k in e.key for k in ours)
        ) / 1e3
        if kernels > 0:
            top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
            return {
                "wall_ms": walls[-1],
                "sessions": attempt + 1,
                "busy_ms": sum(e.self_device_time_total for e in events) / 1e3,
                "kernels_ms": kernels,
                "top": [(e.key[:48], e.self_device_time_total / 1e3, e.count) for e in top],
            }
        SESSIONS["discarded"] += 1
        log(f"profiler session {attempt + 1} of an assign() recorded no port kernel; it "
            f"recorded {[(e.key[:40], e.count) for e in events]}")
    return None


def device_shares(device) -> None:
    """One profiled assign() per main-path cell: the device's busy time
    (kernels and copies, from torch.profiler's CUDA activity), the port's
    kernels' share of it, and the device's idle share of the wall.  A cell
    whose sessions all lost their records is profiled again in a new
    process (``--device-share``), whose profiler starts afresh; it raises
    when that fails too."""
    cells = [(cfg, solver, None) for cfg in (5, 3) for solver in ("rounds", "global")]
    cells += [(cfg, "sinkhorn", None) for cfg in SINKHORN_CONFIGS]
    cells += [(cfg, solver, refine_iters) for cfg in (5, 3)
              for solver, refine_iters in (("scan", None), ("rounds", REFINE_ITERS))]
    for cfg, solver, refine_iters in cells:
        share = profiled_assign(cfg, solver, refine_iters, device)
        label = solver if refine_iters is None else f"{solver}+refine{refine_iters}"
        if share is None:
            log(f"device share  config {cfg} {label}: profiled again in a new process")
            share = device_share_in_child(cfg, solver, refine_iters)
        log(f"device share  config {cfg} {label:16s}: profiler sessions "
            f"{share.get('sessions', 'new process')}, wall {share['wall_ms']!r} ms (profiled), "
            f"device busy {share['busy_ms']!r} ms, of which the port's kernels "
            f"{share['kernels_ms']!r} ms; idle share {1 - share['busy_ms'] / share['wall_ms']!r}; "
            "top: " + "; ".join(f"{k} {ms:.3f} ms x{n}" for k, ms, n in share["top"]))


def device_share_in_child(cfg: int, solver: str, refine_iters) -> dict:
    """``profiled_assign`` of one cell in a new process of this script (its
    kernels are built already); raises when that process fails or its
    sessions lost their records too."""
    argv = [sys.executable, os.path.abspath(__file__), "--device-share", str(cfg), solver,
            str(refine_iters or 0)]
    done = subprocess.run(argv, capture_output=True, text=True, timeout=300)
    lines = done.stdout.strip().splitlines()
    share = json.loads(lines[-1]).get("device_share") if done.returncode == 0 and lines else None
    if share is None:
        raise AssertionError(
            f"no profiler session of an assign() at config {cfg} {solver} recorded a port "
            f"kernel, in this process or a new one (rc {done.returncode}): "
            f"{done.stdout[-2000:]}{done.stderr[-2000:]}")
    return share


def profiled_epoch(engine, lags: np.ndarray):
    """One rebalance under torch.profiler: (stats, wall ms, device busy ms,
    the digest kernel's ms, device-to-host copies, top device events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_PAD_S)
        t0 = time.perf_counter()
        engine.rebalance(lags)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILER_PAD_S)
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and "Activity Buffer" not in e.key
    ]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    digest = sum(e.self_device_time_total for e in events
                 if KERNEL_NAMES["state_digest"] in e.key) / 1e3
    reads = sum(e.count for e in events if "DtoH" in e.key)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    return engine.last_stats, wall, busy, digest, reads, top


def stream_times(run: StreamRun):
    """The digest kernel at the resident state the legs left (config 5)
    through its wrapper (``op_times``), its plain version and its bound;
    the epoch walls of ``run`` by type; one profiled warm-refine epoch.
    Returns the kernels-line fields."""
    engine = run.engine
    choice_p, row_tab, counts, lags_p = engine._resident
    C, M = engine.num_consumers, row_tab.shape[1]
    t = op_times(lambda: refine.state_digest(lags_p, choice_p, counts, C, row_tab=row_tab),
                 KERNEL_NAMES["state_digest"])
    plain = median_event_ms(lambda: digest_plain(lags_p, choice_p, counts, C, row_tab))
    # Each input read once, the owner of every valid slot gathered once, the
    # five lanes written once.
    valid_slots = int(torch.clamp(counts, max=M).sum())
    moved = 8 * lags_p.numel() + 4 * (choice_p.numel() + C + C * M + valid_slots) + 8 * 5
    bound = moved / HBM_BYTES_PER_S * 1e3
    log(f"times  state_digest at B={lags_p.numel()} C={C} M={M} ({valid_slots} valid slots): "
        f"wrapper {t['event_ms']!r} ms (device time alone {t['alone_ms']!r} ms, all ops "
        f"{t['all_ops_ms']!r} ms: {t['kernels']!r} kernels, {t['memsets']!r} memsets), plain "
        f"version {plain!r} ms, bound {bound!r} ms ({moved} bytes), "
        f"{t['event_ms'] / bound:.1f}x the bound")

    walls = {}
    for leg, kind, *_, wall in run.records:
        walls.setdefault(kind, []).append(wall)
    log("stream epoch walls (host clock, second run on the card): " + "; ".join(
        f"{kind} p50 {statistics.median(w)!r} ms of {len(w)} (min {min(w)!r}, max {max(w)!r})"
        for kind, w in sorted(walls.items())))

    rng = np.random.default_rng(9)
    lags = (run.last_lags * rng.lognormal(0.0, 0.05, run.last_lags.shape[0])).astype(np.int64)
    lags = heat(lags, engine.export_state(), C)
    s, wall, busy, digest, reads, top = profiled_epoch(engine, lags)
    if not s.refined or s.guardrail_tripped:
        raise AssertionError(f"the profiled epoch did not refine warm: {s}")
    log(f"profiled warm-refine epoch (dense upload): wall {wall!r} ms, {s.refine_rounds} "
        f"rounds, {s.refine_exchanges} exchanges, device busy {busy!r} ms, of which "
        f"state_digest {digest!r} ms; idle share {1 - busy / wall!r}; {reads} device-to-host "
        "copies; top: " + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms "
                                    f"x{e.count}" for e in top))
    return dict(ms=t["event_ms"], alone_ms=t["alone_ms"], all_ops_ms=t["all_ops_ms"],
                plain_ms=plain, bound_ms=bound, bound_by="bytes", library_ms=None)


# -- phase 4l: wide groups ---------------------------------------------------

#: One topic of WIDE_P partitions subscribed by WIDE_C members: a group above
#: the 16,384 slots of K1's register network, which the JAX package answers.
WIDE_P = 200_000
WIDE_C = 20_000
#: The wide streaming engine's refine budget.
WIDE_REFINE = 32
#: Timed calls of K4 and K5 (and their plain versions) at the wide group:
#: a call there takes 0.1-0.25 s.
WIDE_SLOW_REPEATS = 5


def wide_workload():
    """Phase 4l's group: WIDE_P uniform lags in [0, 10^6) from seed 0 and
    WIDE_C members."""
    lags = {"t0": np.random.default_rng(0).integers(0, 10**6, WIDE_P)}
    return lags, [f"m{i:05d}" for i in range(WIDE_C)]


def wide_engine(device):
    return streaming.StreamingAssignor(num_consumers=WIDE_C, refine_iters=WIDE_REFINE,
                                       imbalance_guardrail=1.25, device=device)


def wide_stream(device) -> tuple:
    """A streaming cold epoch and two warm epochs (each heated so that its
    kept assignment needs a refine) at the wide group, on the card and on
    the port's CPU engine at the card's bucket: every epoch equal, count
    spread <= 1, K1 in the cold chain and K6 in each warm refine.  Returns
    (the card's engine, {epoch: wall ms}, [(lags, choice)] an epoch)."""
    arr = wide_workload()[0]["t0"]
    card, cpu = wide_engine(device), wide_engine(torch.device("cpu"))
    cpu._bucket = pad_bucket
    lags, walls, records = arr, {}, []
    for epoch in ("cold", "warm 1", "warm 2"):
        before = read_counts()
        start = time.perf_counter()
        got = card.rebalance(lags)
        walls[epoch] = (time.perf_counter() - start) * 1e3
        grew = {k: v - before[k] for k, v in read_counts().items()}
        s = card.last_stats
        want = cpu.rebalance(lags)
        if not np.array_equal(np.asarray(got), np.asarray(want)):
            raise AssertionError(f"wide stream {epoch}: the card's epoch differs from the CPU's")
        counts = np.bincount(np.asarray(got), minlength=WIDE_C)
        if counts.max() - counts.min() > 1 or np.asarray(got).min() < 0:
            raise AssertionError(f"wide stream {epoch}: count spread or an unassigned row")
        need = "rounds_scan" if epoch == "cold" else "state_digest"
        if grew[need] < 1 or (epoch != "cold" and not s.refined):
            raise AssertionError(f"wide stream {epoch}: {need} launched {grew[need]} times, "
                                 f"refined {s.refined}")
        log(f"wide stream {epoch}: equal to the CPU engine, cold {s.cold_start}, refined "
            f"{s.refined} in {s.refine_rounds} rounds, launches {grew}, wall "
            f"{walls[epoch]!r} ms")
        records.append((lags, np.asarray(got)))
        lags = heat(lags, np.asarray(got), WIDE_C)
    return card, walls, records


def held_exact(kind: str, got, want, again) -> int:
    """Hold one integer kernel output to its plain version and to a second
    run, bit for bit; returns max |kernel - plain| (0)."""
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"{kind} at the wide group: two runs differ")
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    log(f"kernel vs plain  {kind:19s} at the wide group: max |diff| {err}, two runs equal")
    if err:
        raise AssertionError(f"{kind} disagrees with its plain version at the wide group")
    return err


def wide_times(device, engine) -> dict:
    """Each kernel at the wide group's shapes (K3 at U 1,024 beside them,
    in its pass form): first held to its plain version on the same inputs
    (K1 and K6 bit for bit, K6 on the wide engine's own resident state,
    whose digest must also pass the host check; K3, K4 and K5 to F32_TOL,
    each also run twice to the same bits; K7 is held at this shape by
    ``wide_path``'s ``scan`` = ``rounds``), then timed: CUDA-event time
    (median of 30) and device time alone, the plain version's event time
    and the bound.  Returns {kernel: times and ``max_abs_err``}."""
    arr = wide_workload()[0]["t0"]
    out = {}
    gains, valid, totals0 = round_inputs(arr[None], np.array([WIDE_P]), WIDE_C, device)
    T, R, C = gains.shape
    rb = rounds_cuda.packed_rank_bits(gains, valid, totals0)
    err = held_exact("rounds_scan", rounds_cuda.rounds_scan(gains, valid, totals0),
                     rounds_cuda.rounds_scan_torch(gains, valid, totals0, False, rb),
                     rounds_cuda.rounds_scan(gains, valid, totals0))
    bound, by, _ = bound_ms(T, R, C)
    out["rounds_scan"] = dict(
        op_times(lambda: rounds_cuda.rounds_scan(gains, valid, totals0),
                 KERNEL_NAMES["rounds_scan"]),
        plain_ms=median_event_ms(
            lambda: rounds_cuda.rounds_scan_torch(gains, valid, totals0, False, rb)),
        bound_ms=bound, bound_by=by, max_abs_err=err,
        shape=f"T {T} R {R} C {C}, rank_bits {rb}")
    sl, sv, lag_range = wide_scan_input(device)
    Pp = sl.shape[1]
    bound, by = k7_bound(1, Pp, WIDE_C, WIDE_C, [WIDE_P])
    out["scan_greedy"] = dict(
        op_times(lambda: scan_cuda.scan_greedy(sl, sv, WIDE_C, lag_range=lag_range),
                 KERNEL_NAMES["scan_greedy"]),
        plain_ms=None, bound_ms=bound, bound_by=by,
        shape=f"T 1 P {Pp} ({WIDE_P} valid) E {WIDE_C}")
    choice_p, row_tab, counts, lags_p = engine._resident
    M = row_tab.shape[1]
    got = refine.state_digest(lags_p, choice_p, counts, WIDE_C, row_tab=row_tab)
    err = held_exact("state_digest", [got],
                     [digest_plain(lags_p, choice_p, counts, WIDE_C, row_tab)],
                     [refine.state_digest(lags_p, choice_p, counts, WIDE_C, row_tab=row_tab)])
    fails = scrub.digest_failures(got.cpu().numpy(), WIDE_P, int(lags_p.sum()))
    if fails:
        raise AssertionError(f"state_digest of the wide engine's state: host check gave {fails}")
    valid_slots = int(torch.clamp(counts, max=M).sum())
    moved = 8 * lags_p.numel() + 4 * (choice_p.numel() + WIDE_C + WIDE_C * M + valid_slots) + 40
    out["state_digest"] = dict(
        op_times(lambda: refine.state_digest(lags_p, choice_p, counts, WIDE_C, row_tab=row_tab),
                 KERNEL_NAMES["state_digest"]),
        plain_ms=median_event_ms(lambda: digest_plain(lags_p, choice_p, counts, WIDE_C,
                                                      row_tab)),
        bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes", max_abs_err=err,
        shape=f"B {lags_p.numel()} C {WIDE_C} M {M} (the engine's resident state)")
    ws_b, cnt_b, A, B = wide_blocks(device)
    rows = int(((ws_b != 0) | (cnt_b != 0)).sum())
    load_rows = int((ws_b != 0).sum())
    Sb = ws_b.shape[0]
    sc, prev = torch.tensor(1.0, device=device), torch.tensor(float("inf"), device=device)
    eta = linear_ot.MIRROR_PROX_ETA
    form = tile_form(WIDE_C)
    name = f"{list(ws_b.shape)} C {WIDE_C}, {form}"
    err = f32_check("superblock_partials", f"wide group {name}",
                    linear_ot_cuda.superblock_partials(ws_b, cnt_b, A, B),
                    linear_ot._superblock_partials(ws_b, cnt_b, A, B),
                    linear_ot_cuda.superblock_partials(ws_b, cnt_b, A, B))
    moved = 4 * (2 * ws_b.numel() + 2 * WIDE_C + 2 * Sb * WIDE_C)
    bound, by = exp_bound(rows * WIDE_C, moved)
    slow = WIDE_SLOW_REPEATS

    def k5_library():
        return superblock_library_each(ws_b, cnt_b, A, B)

    out["superblock_partials"] = dict(
        op_times(lambda: linear_ot_cuda.superblock_partials(ws_b, cnt_b, A, B),
                 KERNEL_NAMES["superblock_partials"], slow),
        plain_ms=median_event_ms(lambda: linear_ot._superblock_partials(ws_b, cnt_b, A, B),
                                 slow),
        library_ms=median_event_ms(k5_library, slow),
        library_alone_ms=device_profile(k5_library, "", slow)["all_ops_ms"],
        bound_ms=bound, bound_by=by, bound_2exp_ms=exp_bound(2 * rows * WIDE_C, moved)[0],
        max_abs_err=err,
        shape=f"{list(ws_b.shape)} ({rows} rows with weight) C {WIDE_C}, {form}")
    step = (ws_b, cnt_b, A, B, sc, prev)
    err = f32_check("mirror_prox_step", f"wide group {name}",
                    linear_ot_cuda.mirror_prox_step(*step, eta=eta),
                    linear_ot_cuda.mirror_prox_step_torch(*step, eta=eta),
                    linear_ot_cuda.mirror_prox_step(*step, eta=eta))
    moved = 4 * (2 * ws_b.numel() + 2 * WIDE_C + 2 + 3 * WIDE_C)
    bound, by = exp_bound((rows + load_rows) * WIDE_C, moved)
    out["mirror_prox_step"] = dict(
        op_times(lambda: linear_ot_cuda.mirror_prox_step(*step, eta=eta),
                 KERNEL_NAMES["mirror_prox_step"], slow),
        plain_ms=median_event_ms(lambda: linear_ot_cuda.mirror_prox_step_torch(
            *step, eta=eta), slow),
        library_ms=None, bound_ms=bound, bound_by=by,
        bound_2exp_ms=exp_bound(2 * (rows + load_rows) * WIDE_C, moved)[0],
        max_abs_err=err, shape=name)
    args = wide_k3_args(device)
    ws_u, wsum_u = args[0], args[2]
    U = ws_u.shape[0]
    k3_name = f"U {U} C {WIDE_C}, need=load, {plan_stats_cuda.form_for(U, WIDE_C)} form, {form}"
    err = f32_check("plan_stats", f"wide group {k3_name}",
                    plan_stats.plan_stats(*args, need="load")[:1],
                    plan_stats.plan_stats_torch(*args, need="load")[:1],
                    plan_stats.plan_stats(*args, need="load")[:1])
    moved = 4 * (2 * U + 3 * WIDE_C)
    bound, by = exp_bound(U * WIDE_C, moved)

    def k3_library():
        return softmax_library(ws_u, args[3], args[4], (wsum_u,))

    out["plan_stats"] = dict(
        op_times(lambda: plan_stats.plan_stats(*args, need="load"), KERNEL_NAMES["plan_stats"]),
        plain_ms=median_event_ms(lambda: plan_stats.plan_stats_torch(*args, need="load")),
        library_ms=median_event_ms(k3_library),
        library_alone_ms=device_profile(k3_library, "")["all_ops_ms"],
        bound_ms=bound, bound_by=by, bound_2exp_ms=exp_bound(2 * U * WIDE_C, moved)[0],
        max_abs_err=err, shape=k3_name)
    for name in ("rounds_scan", "scan_greedy"):
        kernel = KERNEL_NAMES[name] + FORM_SUFFIX[slot_form(rounds_cuda.slots_for(WIDE_C))]
        if not all(kernel in k for k in out[name]["by_kernel"]):
            raise AssertionError(f"{name} at the wide group ran {out[name]['by_kernel']}, "
                                 f"not {kernel}")
    for name, t in out.items():
        log(f"times at the wide group  {name:19s} {t['shape']}: event {t['event_ms']!r} ms, "
            f"device time alone {t['alone_ms']!r} ms ({t['launches']} launches: "
            f"{t['by_kernel']}), plain "
            f"{t['plain_ms']!r} ms, library yardstick {t.get('library_ms')!r} ms (all its ops "
            f"{t.get('library_alone_ms')!r} ms), bound {t['bound_ms']!r} ms ({t['bound_by']}; "
            f"two exps an entry {t.get('bound_2exp_ms')!r} ms)")
    return out


def wide_scan_input(device):
    """K7's input at the wide group as ``scan`` makes it: the topic padded
    to its bucket (P_pad 262,144), sorted into processing order; (sorted
    lags, sorted valid, the lags' range as ``dispatch`` hands it over)."""
    table = pad_topic_rows(wide_workload()[0]["t0"])[0][None]
    Pp = table.shape[1]
    L = torch.from_numpy(table).to(device)
    pids = torch.arange(Pp, dtype=torch.int32, device=device).expand(1, Pp)
    V = torch.arange(Pp, device=device)[None, :] < WIDE_P
    _, sl, sv = sort_partitions_with(L, pids, V, pack_shift_for(int(table.max()), Pp - 1))
    return (sl.contiguous(), sv.to(torch.uint8).contiguous(),
            scan_cuda.host_lag_range(table, np.array([WIDE_P])))


def wide_blocks(device):
    """Phase 4l's linear blocks (ws_b, cnt_b [8, 32, 1024] of the wide
    group's lags, as the linear path makes them) and random duals (A, B)
    at WIDE_C."""
    arr = wide_workload()[0]["t0"]
    lags_p, _, valid_p = pad_topic_rows(arr)
    P2, t, _ = linear_ot.plan_shape(lags_p.shape[0], 1024)
    ws, cnt = linear_ot._ws_cnt(torch.from_numpy(lags_p).to(device),
                                torch.from_numpy(valid_p).to(device),
                                sinkhorn._scale_np(lags_p, valid_p, WIDE_C))
    return (linear_ot._to_blocks(ws, P2, 8, t), linear_ot._to_blocks(cnt, P2, 8, t),
            *random_duals(WIDE_C, device))


def wide_k3_args(device):
    """K3's inputs beside the wide group: U 1,024 value rows (seed 6) and
    random duals at WIDE_C."""
    g = torch.Generator().manual_seed(6)
    U = 1024
    ws_u = torch.rand(U, generator=g).mul_(4.0).to(device)
    cnt_u = torch.randint(1, 5, (U,), generator=g).float().to(device)
    return (ws_u, cnt_u, ws_u * cnt_u, *random_duals(WIDE_C, device))


def bits(out) -> str:
    """A digest of a kernel call's output tensors' bits (None entries
    skipped)."""
    h = hashlib.sha256()
    for t in out:
        if t is not None:
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def wide_ab_times(device) -> dict:
    """K3, K4 and K5 at the wide group's shapes (``wide_blocks``,
    ``wide_k3_args``; K3's plain version beside it) and, as the control, at
    config 4 (K3, each ``need``) and config 5 (K4, K5): CUDA-event time and
    device time alone of each, and a digest of each output's bits
    (``bits``); then phase 4l's ``sinkhorn`` ``assign()``: three walls on
    the host clock and one profiled call (K4's and K5's device time alone,
    and all its device work), with a digest of its assignment; then a digest
    of each of phase 4l's ``rounds``, ``global`` and ``scan`` assignments
    and of its three stream epochs on the card (``wide_stream``'s, without
    the CPU engine), which ``--wide-ab`` holds equal across checkouts.  Uses
    only interfaces this change's parent has too."""
    ws_b, cnt_b, A, B = wide_blocks(device)
    args = wide_k3_args(device)
    (ws5, cnt5), C5 = blocks_case(5, device)
    A5, B5 = random_duals(C5, device)
    (ws4, cnt4, wsum4), C4 = dedup_case(4, device)
    args4 = (ws4, cnt4, wsum4, *random_duals(C4, device))
    sc, prev = torch.tensor(1.0, device=device), torch.tensor(float("inf"), device=device)
    eta = linear_ot.MIRROR_PROX_ETA
    k5, k4 = linear_ot_cuda.superblock_partials, linear_ot_cuda.mirror_prox_step
    # The controls first: a card that has just run the parent's 0.1 s
    # wide launches may hold other clocks than one that has idled.
    calls = {
        "K5 config 5": ("superblock_partials", REPEATS, lambda: k5(ws5, cnt5, A5, B5)),
        "K4 config 5": ("mirror_prox_step", REPEATS,
                        lambda: k4(ws5, cnt5, A5, B5, sc, prev, eta=eta)),
    }
    for need in ("load", "colsum", "both"):
        calls[f"K3 config 4 {need}"] = (
            "plan_stats", REPEATS, lambda need=need: plan_stats.plan_stats(*args4, need=need))
    calls.update({
        "K5 wide": ("superblock_partials", WIDE_SLOW_REPEATS, lambda: k5(ws_b, cnt_b, A, B)),
        "K4 wide": ("mirror_prox_step", WIDE_SLOW_REPEATS,
                    lambda: k4(ws_b, cnt_b, A, B, sc, prev, eta=eta)),
        "K3 wide load": ("plan_stats", REPEATS, lambda: plan_stats.plan_stats(*args, need="load")),
    })
    out = {}
    for name, (kernel, repeats, fn) in calls.items():
        out[name] = dict(op_times(fn, KERNEL_NAMES[kernel], repeats), bits=bits(fn()))
    out["K3 wide load"]["plain_ms"] = median_event_ms(
        lambda: plan_stats.plan_stats_torch(*args, need="load"))
    lags, members = wide_workload()

    def assign():
        return assign_once(lags, members, "sinkhorn", device)

    walls = []
    for _ in range(3):
        start = time.perf_counter()
        got = assign()[0]
        walls.append((time.perf_counter() - start) * 1e3)
    prof = device_profile(assign, KERNEL_NAMES["mirror_prox_step"], 1)
    out["sinkhorn wide assign"] = dict(
        walls_ms=walls, alone_ms=prof["alone_ms"], launches=prof["launches"],
        all_ops_ms=prof["all_ops_ms"], bits=assignment_bits(got))
    for solver in ("rounds", "global", "scan"):
        out[f"{solver} wide assign"] = dict(
            bits=assignment_bits(assign_once(lags, members, solver, device)[0]))
    engine, arr, epochs = wide_engine(device), lags["t0"], []
    for _ in range(3):
        epochs.append(np.asarray(engine.rebalance(arr)))
        arr = heat(arr, epochs[-1], WIDE_C)
    out["wide stream epochs"] = dict(bits=bits([torch.from_numpy(np.stack(epochs))]))
    return out


def assignment_bits(assignment: dict) -> str:
    """A digest of an ``assign()`` answer (member -> partitions)."""
    return hashlib.sha256(json.dumps(sorted(assignment.items())).encode()).hexdigest()[:16]


class FormSpy:
    """While entered, records the form (``slot_form``) of every K1 and K7
    launch through the wrappers, as (kernel, slots, form), and the bytes
    of scratch the wrappers allocate for them (``wide_scratch``)."""

    def __init__(self):
        self.forms = []
        self.scratch_bytes = 0

    def __enter__(self):
        k1, k7, scratch = rounds_cuda._launch, scan_cuda._launch, rounds_cuda.wide_scratch
        self._saved = [(rounds_cuda, "_launch", k1), (scan_cuda, "_launch", k7),
                       (rounds_cuda, "wide_scratch", scratch),
                       (scan_cuda, "wide_scratch", scan_cuda.wide_scratch)]

        def note(kernel, slots):
            self.forms.append((kernel, slots, slot_form(slots)))

        def k1_launch(gains, *args, **kw):
            note("rounds_scan", rounds_cuda.slots_for(gains.shape[2]))
            return k1(gains, *args, **kw)

        def k7_launch(sorted_lags, sorted_valid, C, eligible, *args, **kw):
            E = C if eligible is None else int(eligible.bool().sum())
            note("scan_greedy", rounds_cuda.slots_for(E))
            return k7(sorted_lags, sorted_valid, C, eligible, *args, **kw)

        def wide_scratch(*args, **kw):
            out = scratch(*args, **kw)
            self.scratch_bytes += 0 if out is None else out.numel()
            return out

        rounds_cuda._launch, scan_cuda._launch = k1_launch, k7_launch
        rounds_cuda.wide_scratch = scan_cuda.wide_scratch = wide_scratch
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)


def wide_path(device) -> tuple:
    """Phase 4l: the wide group (one topic, WIDE_P partitions, WIDE_C
    members) through ``assign()`` with the host rung off: ``rounds`` (K1's
    cluster form) equal to the port's CPU solve, which runs K1's plain
    version; ``scan`` (K7's cluster form) equal to ``rounds``; ``global``
    equal to the CPU solve; ``sinkhorn`` in linear mode (K4, K5 and K1)
    with every partition once, count spread <= 1, a peak no worse than
    ``rounds``' and within total / C + max lag; then ``wide_stream`` and
    ``wide_times``.  K1's and K7's launches in the assign() and stream legs
    are named by form (``FormSpy``): at 20,000 members the cluster form,
    with no scratch.  Returns (launches from just before the path to just
    after its assign() and stream legs, the report, the answers phase 4m
    holds its paths to: each solver's and the stream's epochs)."""
    lags, members = wide_workload()
    start_path = time.perf_counter()
    reset_counts()
    got, walls, cpu, forms = {}, {}, torch.device("cpu"), {}
    need = {"rounds": ["rounds_scan"], "scan": ["scan_greedy"], "global": ["rounds_scan"],
            "sinkhorn": ["mirror_prox_step", "superblock_partials", "rounds_scan"]}
    spy = FormSpy()
    for solver, kernels in need.items():
        before = read_counts()
        start = time.perf_counter()
        with spy:
            got[solver], stats = assign_once(lags, members, solver, device)
        walls[solver] = (time.perf_counter() - start) * 1e3
        grew = {k: v - before[k] for k, v in read_counts().items()}
        if any(grew[k] < 1 for k in kernels):
            raise AssertionError(f"wide {solver}: launches {grew}, expected {kernels}")
        forms[solver] = spy.forms[-(grew["rounds_scan"] + grew["scan_greedy"]):]
        log(f"wide group {solver:8s}: assign() {walls[solver]!r} ms (solve {stats.solve_ms!r} "
            f"ms), quality_ratio {stats.quality_ratio!r}, launches {grew}, K1/K7 forms "
            f"{forms[solver]}")
    for solver in ("rounds", "global"):
        if got[solver] != assign_once(lags, members, solver, cpu)[0]:
            raise AssertionError(f"wide {solver}: differs from the plain path (CPU)")
    if got["scan"] != got["rounds"]:
        raise AssertionError("wide scan: differs from rounds")
    arr = lags["t0"]
    peak = greedy_peak(lags, got["rounds"])
    for solver in ("rounds", "global"):
        counts = [len(got[solver].get(m, [])) for m in members]
        if max(counts) - min(counts) > 1:
            raise AssertionError(f"wide {solver}: count spread > 1")
    q_peak = check_quality("wide sinkhorn", lags, members, got["sinkhorn"], peak, True)
    if q_peak > arr.sum() / WIDE_C + arr.max():
        raise AssertionError(f"wide sinkhorn: peak {q_peak} above total / C + max lag")
    with spy:
        engine, stream_walls, stream_records = wide_stream(device)
    forms["stream"] = spy.forms[sum(map(len, forms.values())):]
    launches = read_counts()
    if len(spy.forms) != launches["rounds_scan"] + launches["scan_greedy"]:
        raise AssertionError(f"wide group: {launches} launches, forms {spy.forms}")
    want = slot_form(rounds_cuda.slots_for(WIDE_C))
    if {f[2] for f in spy.forms} != {want} or (want != "scratch" and spy.scratch_bytes):
        raise AssertionError(f"wide group: K1/K7 took {spy.forms} with "
                             f"{spy.scratch_bytes} bytes of scratch, not the {want} form")
    log(f"wide group: every K1/K7 launch ({len(spy.forms)}) in the {want} form, "
        f"{spy.scratch_bytes} bytes of scratch")
    path_s = time.perf_counter() - start_path
    log(f"wide group: rounds and global equal to the CPU path, scan equal to rounds, "
        f"sinkhorn peak {q_peak} (rounds {peak}, total / C + max lag "
        f"{arr.sum() / WIDE_C + arr.max():.1f}); assign() and stream legs {path_s:.1f} s")
    kernel_times = wide_times(device, engine)
    report = {"P": WIDE_P, "C": WIDE_C, "assign_ms": walls, "stream_ms": stream_walls,
              "forms": {leg: [[f[0], f[2]] for f in fs] for leg, fs in forms.items()},
              "scratch_bytes": spy.scratch_bytes,
              "sinkhorn_peak": q_peak, "rounds_peak": peak, "legs_s": path_s,
              "times": kernel_times, "card": CARD[0] if CARD else None,
              "phase_s": time.perf_counter() - start_path}
    return launches, report, {**got, "stream": stream_records}


# -- phase 4m: wide groups on every path ----------------------------------------

#: Phase 4m's coalesced streams (phase 4l's shape each), their lags' first
#: seed, and the rows the delta wave changes in each.
WP_STREAMS, WP_SEED, WP_DELTA_ROWS = 4, 6000, 8
#: The topic axis at the wide width: T topics of P partitions, uniform lags
#: from seed 16; (topics, members) mesh shapes and refine budgets.
WP_TOPICS, WP_TOPIC_P = 16, 25_000
WP_TOPIC_SHAPES = ((1, 1), (4, 1), (2, 2))
#: The exchange program held to its CPU run: phase 4l's first 65,536 lags
#: (the bucket both devices pick), all 20,000 members, D 2, 16 refine
#: rounds.  The CPU takes seconds there; the whole group would take minutes.
WP_EXCHANGE_P, WP_EXCHANGE_REFINE = 65_536, 16
#: Virtual shards of the sharded duals and of the placed stream.
WP_DUALS_D = (1, 2, 4)
WP_PLACED_D = 4
#: Provisional: the federated answer's quality (max over mean member load)
#: at most this factor of phase 4l's single-leader ``sinkhorn``'s.  At 10
#: partitions a member each of three shards is count-balanced on its own
#: (3 or 4 a member), and the JAX package's federation stays as far from
#: its leader, the more so the more members: 3.6 %, 4.6 % and 5.0 % above
#: it at 2,000, 6,000 and 10,000 members (uniform lags, seed 0, 16 rounds,
#: ``tests/test_torch_wide_fed_quality.py`` run as a script), the port
#: within 0.07 % of it each time.  The 5 % that config 12's 256 rows a
#: member keep (phase 4k) is past the JAX package's own answer there; no
#: CPU run reached 20,000 members, so the bound leaves room for that
#: growth.
WP_FED_QUALITY = 1.075


def wide_sidecar(device, answers: dict, launches: dict) -> dict:
    """4m (a): the port's sidecar (``AssignorService(device=..., host_fallback=
    False, metrics_port=0)``) over TCP at the wide group: ``rounds``,
    ``scan``, ``global`` and linear ``sinkhorn``, each equal to phase 4l's
    in-process answer for that solver, answered on the card with its
    kernels launched; then a stream (``refine_iters`` 32, guardrail 1.25)
    through phase 4l's cold and two heated warm epochs: the cold epoch's
    lags zlib-encoded up and its answer zlib-encoded down, the warm epochs
    as ``lag_delta`` from the client's ``LagDeltaTracker``, the second
    acked and so answered with an ``assignment_delta``, each epoch's choice
    equal to ``wide_stream``'s.  Every request's and reply's bytes on the
    raw connection and its round-trip wall."""
    import socket

    from kafka_lag_based_assignor_tpu_torch import service
    from kafka_lag_based_assignor_tpu_torch.lag import (
        AssignmentDeltaTracker,
        LagDeltaTracker,
    )

    lags, members = wide_workload()
    params = {"topics": wire_topics(lags), "subscriptions": {m: ["t0"] for m in members}}
    need = {"rounds": ["rounds_scan"], "scan": ["scan_greedy"], "global": ["rounds_scan"],
            "sinkhorn": ["mirror_prox_step", "superblock_partials", "rounds_scan"]}
    report = {"assign": {}, "stream": []}
    svc = service.AssignorService(port=0, device=device, host_fallback=False, metrics_port=0,
                                  coalesce_max_batch=1, scrub_interval_ms=0).start()
    try:
        with socket.create_connection(svc.address, timeout=600) as sock, \
                sock.makefile("rwb") as f:
            def call(method: str, p: dict) -> tuple:
                line = json.dumps({"id": 1, "method": method, "params": p}).encode() + b"\n"
                t0 = time.perf_counter()
                f.write(line)
                f.flush()
                reply = f.readline()
                wall = (time.perf_counter() - t0) * 1e3
                msg = json.loads(reply)
                if "error" in msg:
                    raise AssertionError(f"wide paths 4m(a) {method}: {msg['error']}")
                return msg["result"], {"request_bytes": len(line), "reply_bytes": len(reply),
                                       "round_trip_ms": wall}

            for solver, kernels in need.items():
                (result, sizes), grew = counted(
                    lambda: call("assign", {**params, "solver": solver}))
                add_counts(launches, grew)
                stats = result["stats"]
                if wire_answer(result) != answers[solver]:
                    raise AssertionError(f"wide paths 4m(a) {solver}: differs from phase 4l's "
                                         "in-process answer")
                if (stats["fallback_used"] or stats["device"] != device.type
                        or device.type == "cuda" and any(grew[k] < 1 for k in kernels)):
                    raise AssertionError(f"wide paths 4m(a) {solver}: stats {stats}, "
                                         f"launches {grew}")
                report["assign"][solver] = {**sizes, "launches": grew}
                log(f"wide paths 4m(a) sidecar {solver:8s}: equal to phase 4l's answer; "
                    f"{sizes}; launches {grew}")
            up, down = LagDeltaTracker(), AssignmentDeltaTracker()
            base = {"stream_id": "wide", "topic": "t0", "members": members,
                    "options": {"refine_iters": WIDE_REFINE, "guardrail": 1.25}}
            for k, (epoch_lags, want) in enumerate(answers["stream"]):
                rows = wire_rows(epoch_lags)
                if k == 0:
                    p = {"lags": service.encode_lags_zlib(rows), "encoding": "zlib",
                         "accept_encoding": "zlib"}
                    up.params_for(rows)  # the tracker's pending read
                else:
                    p = up.params_for(rows)
                    if k == 2:
                        down.stamp(p)
                (result, sizes), grew = counted(lambda: call("stream_assign", {**base, **p}))
                add_counts(launches, grew)
                shape = ("zlib" if k == 0 else "lag_delta" if "lag_delta" in p else "dense",
                         "zlib" if "assignments_encoded" in result
                         else "assignment_delta" if "assignment_delta" in result else "dense")
                result = service.decode_wire_assignments(result)
                view = down.note_result(result, members)
                up.note_result(result)
                s = result["stream"]
                need_k = "rounds_scan" if k == 0 else "state_digest"
                if (not np.array_equal(wire_choice(view, members), want)
                        or shape != (("zlib", "zlib"), ("lag_delta", "dense"),
                                     ("lag_delta", "assignment_delta"))[k]
                        or s["fallback_used"] or s["cold_start"] != (k == 0)
                        or device.type == "cuda" and grew[need_k] < 1):
                    raise AssertionError(f"wide paths 4m(a) stream epoch {k}: shape {shape}, "
                                         f"stats {s}, launches {grew}, equal "
                                         f"{np.array_equal(wire_choice(view, members), want)}")
                report["stream"].append({**sizes, "shape": shape, "refined": s["refined"],
                                         "launches": grew})
                log(f"wide paths 4m(a) sidecar stream epoch {k}: equal to wide_stream's; up "
                    f"{shape[0]}, down {shape[1]}; {sizes}; launches {grew}")
    finally:
        svc.stop()
    return report


def wide_coalesce(device, launches: dict) -> tuple:
    """4m (b): ``WP_STREAMS`` streams of phase 4l's shape (lags from seeds
    6000 + g, ``refine_iters`` 32, ``refine_threshold=None``) through one
    ``MegabatchCoalescer(max_batch=4)``: a wave that re-stacks and locks the
    roster, two locked dense waves and a locked delta wave (8 rows a
    stream), every row equal to the same stream's inline epoch on a serial
    engine, one batched K6 launch and no other kernel a wave.  After the
    third wave the locked state [4 x B 262,144, C 20,000] through K6's
    batched entry against its plain version and four single launches, bit
    for bit, and timed.  Returns (max |diff| (0), the report)."""
    from kafka_lag_based_assignor_tpu_torch.ops.coalesce import MegabatchCoalescer

    def engines():
        return [streaming.StreamingAssignor(num_consumers=WIDE_C, refine_iters=WIDE_REFINE,
                                            refine_threshold=None, device=device)
                for _ in range(WP_STREAMS)]

    rngs = [np.random.default_rng(WP_SEED + g) for g in range(WP_STREAMS)]
    waves = [[r.integers(0, 10**6, WIDE_P).astype(np.int64) for r in rngs] for _ in range(4)]
    delta = [lg.copy() for lg in waves[-1]]
    for lg, r in zip(delta, rngs):
        lg[r.choice(WIDE_P, WP_DELTA_ROWS, replace=False)] += 10**5
    waves.append(delta)
    inline, co = engines(), engines()
    t0 = time.perf_counter()
    want, grew = counted(lambda: [[np.asarray(e.rebalance(lg)) for e, lg in zip(inline, wave)]
                                  for wave in waves])
    serial_ms = (time.perf_counter() - t0) * 1e3
    add_counts(launches, grew)
    add_counts(launches, counted(lambda: [e.rebalance(lg) for e, lg in zip(co, waves[0])])[1])
    coal = MegabatchCoalescer(window_s=2.0, max_batch=WP_STREAMS, lock_waves=1, device=device)
    walls, worst, times = [], 0, None
    try:
        for w in range(1, len(waves)):
            before = coalesce_series()
            (got, wall), grew = counted(lambda: submit_wave(co, waves[w], coal))
            add_counts(launches, grew)
            moved = series_moved(before)
            walls.append(wall)
            if device.type == "cuda" and grew != {**{k: 0 for k in grew},
                                                  "state_digest_rows": 1}:
                raise AssertionError(f"wide paths 4m(b) wave {w}: launches {grew}")
            for g in range(WP_STREAMS):
                if not np.array_equal(np.asarray(got[g]), want[w][g]):
                    raise AssertionError(f"wide paths 4m(b) wave {w}: row {g} differs from "
                                         "its inline epoch")
            if w == len(waves) - 1 and moved["delta_applied"] < WP_STREAMS:
                raise AssertionError(f"wide paths 4m(b): the delta wave moved {moved}")
            log(f"wide paths 4m(b) coalesced wave {w} ({'delta' if w == 4 else 'dense'}): "
                f"{wall!r} ms, rows equal to inline, launches {grew}, series {moved}")
            if w == 3:
                worst, times = wide_rows_digest(co[0]._resident.batch)
    finally:
        coal.close(timeout_s=60)
    report = {"streams": WP_STREAMS, "wave_ms": walls, "serial_epochs_ms": serial_ms,
              "rows_digest": times}
    return worst, report


def wide_rows_digest(batch) -> tuple:
    """4m (b): K6's batched entry on a locked wide batch
    (``rows_digest_held``, every row passing the host check); then timed."""
    rows = [tuple(t[n] for t in (batch.lags, batch.choice, batch.counts, batch.row_tab))
            for n in range(batch.lags.shape[0])]
    err, _ = rows_digest_held(rows, WIDE_C, WIDE_P, "wide paths 4m(b)")
    log(f"kernel vs plain  state_digest_rows wide x{len(rows)}: equal to {len(rows)} single "
        "launches and the plain version, every row passing the host check")
    return err, rows_digest_times(rows, WIDE_C, "wide")


def wide_linear_duals(device, arr: np.ndarray, launches: dict) -> tuple:
    """4m (c), the duals: the wide group's sharded mirror-prox duals
    (``_linear_duals_sharded``, K5 on each shard's 8 / D superblocks) at
    D = 1, 2, 4 virtual shards, A and B bit-identical on every shard and
    across D, 2 x D x rounds K5 launches each.  Returns (the D = 1 duals,
    the blocks and their C, rounds)."""
    from kafka_lag_based_assignor_tpu_torch.sharded import solve as sharded_solve

    P2, tile, _ = linear_ot.plan_shape(WIDE_P, dispatch.quality_tile())
    lags_p = np.zeros(P2, np.int64)
    lags_p[:WIDE_P] = arr
    valid = np.arange(P2) < WIDE_P
    scale = sinkhorn._scale_np(lags_p, valid, WIDE_C)
    duals = {}
    for D in WP_DUALS_D:
        lp, vp = sharded_solve._place_inputs(virtual_mesh(D, device), lags_p, valid)
        (A, B, rounds), grew = counted(lambda: sharded_solve._linear_duals_sharded(
            lp, vp, scale, float(WIDE_P), WIDE_C, LINEAR_ITERS, tile))
        add_counts(launches, grew)
        if device.type == "cuda" and grew["superblock_partials"] != 2 * D * rounds:
            raise AssertionError(f"wide paths 4m(c) duals D={D}: launches {grew} for "
                                 f"{rounds} rounds")
        if not all(torch.equal(a, A[0]) and torch.equal(b, B[0]) for a, b in zip(A, B)):
            raise AssertionError(f"wide paths 4m(c) duals D={D}: the shards disagree")
        duals[D] = (A[0], B[0], rounds)
        if not (torch.equal(A[0], duals[1][0]) and torch.equal(B[0], duals[1][1])
                and rounds == duals[1][2]):
            raise AssertionError(f"wide paths 4m(c) duals: D={D} differs from D=1")
        log(f"wide paths 4m(c) linear duals at D={D} (virtual; K5 at Sb={8 // D}): "
            f"{rounds} rounds, bit-identical to D=1 on every shard; launches {grew}")
    ws, cnt = linear_ot._ws_cnt(torch.from_numpy(lags_p).to(device),
                                torch.from_numpy(valid).to(device), scale)
    blocks = (linear_ot._to_blocks(ws, P2, 8, tile), linear_ot._to_blocks(cnt, P2, 8, tile))
    return duals[1], blocks


def wide_sharded_and_placed(device, arr: np.ndarray, launches: dict) -> tuple:
    """4m (c) and (d): the duals (``wide_linear_duals``) and K5 at Sb 8, 4,
    2 on the wide group's blocks at those duals (``k5_superblock_shapes``);
    the exchange program at WP_EXCHANGE_P x WIDE_C, D = 2, card against
    CPU; the wide stream through ``StreamingAssignor(mesh_backend=manager)``
    on 4 virtual shards: the sharded linear cold epoch (K1 once, in the
    tail) equal to the one-shard ``solve_linear_sharded``, then two heated
    warm epochs after a 5 % drift and one heated epoch alone (a delta
    upload), each equal to an unplaced engine seeded with the cold choice,
    the placed ones digested with K6's shard entry, which is then held to
    the one-state K6 on the gathered state and to its plain version, bit
    for bit, and timed; then the topic axis (``sharded_topics`` on
    WP_TOPICS x WP_TOPIC_P, uniform lags from seed 16).
    Returns (K5's max |diff|, K6 shard's max |diff| (0), the report)."""
    from kafka_lag_based_assignor_tpu_torch.sharded import mesh as mesh_mod

    mesh_mod.set_virtual_shards(WP_PLACED_D, device)
    try:
        return wide_sharded_legs(device, arr, launches)
    finally:
        mesh_mod.set_virtual_shards(None)


def wide_sharded_legs(device, arr: np.ndarray, launches: dict) -> tuple:
    """The legs of ``wide_sharded_and_placed``, with WP_PLACED_D virtual
    shards of ``device`` configured for the mesh manager."""
    from kafka_lag_based_assignor_tpu_torch.sharded import solve as sharded_solve
    from kafka_lag_based_assignor_tpu_torch.sharded.mesh import MeshManager
    from kafka_lag_based_assignor_tpu_torch.sharded.resident import PlacedResident

    report = {}
    (A, B, rounds), (ws_b, cnt_b) = wide_linear_duals(device, arr, launches)
    k5 = k5_superblock_shapes(device, (ws_b, cnt_b, A, B), (8, 4, 2), "4m(c)")
    report["duals"] = {"rounds": rounds, "equal_across_D": True, "k5": k5}

    small = arr[:WP_EXCHANGE_P]
    got, grew = counted(lambda: sharded_solve.solve_sharded(
        virtual_mesh(2, device), small, WIDE_C, refine_iters=WP_EXCHANGE_REFINE))
    add_counts(launches, grew)
    want = sharded_solve.solve_sharded(virtual_mesh(2, torch.device("cpu")), small, WIDE_C,
                                       refine_iters=WP_EXCHANGE_REFINE)
    if not all(np.array_equal(np.asarray(g), np.asarray(w)) for g, w in zip(got, want)):
        raise AssertionError("wide paths 4m(c): the exchange program differs between the "
                             "card and the CPU")
    report["exchange"] = {"P": WP_EXCHANGE_P, "C": WIDE_C, "D": 2, "rounds": got[3]}
    log(f"wide paths 4m(c) exchange program {WP_EXCHANGE_P} x {WIDE_C}, D=2 (virtual): the "
        f"card equals the CPU ({got[3]} refine rounds)")

    (one, _, _, _), grew = counted(lambda: sharded_solve.solve_linear_sharded(
        virtual_mesh(1, device), arr, WIDE_C, refine_iters=64))
    add_counts(launches, grew)
    mgr = MeshManager(devices=WP_PLACED_D).configure()
    if not (mgr.active and mgr.size == WP_PLACED_D):
        raise AssertionError(f"wide paths 4m(d): the manager did not come up: {mgr.status()}")
    engine = streaming.StreamingAssignor(num_consumers=WIDE_C, refine_iters=WIDE_REFINE,
                                         imbalance_guardrail=1.25, mesh_backend=mgr,
                                         device=device)
    cold, grew = counted(lambda: engine.rebalance(arr))
    add_counts(launches, grew)
    if (not engine.last_stats.sharded_solve or not np.array_equal(cold, one)
            or device.type == "cuda" and grew["rounds_scan"] != 1):
        raise AssertionError(f"wide paths 4m(c): the D={WP_PLACED_D} cold epoch (sharded "
                             f"{engine.last_stats.sharded_solve}) against D=1: equal "
                             f"{np.array_equal(cold, one)}; launches {grew}")
    log(f"wide paths 4m(c) sharded cold epoch through the engine at D={WP_PLACED_D}: equal to "
        f"D=1's solve_linear_sharded; launches {grew}")
    ref = wide_engine(device)
    ref.seed_choice(cold)
    rng, lags, choice, epochs = np.random.default_rng(44), arr, cold, []
    for k in range(3):
        if k < 2:
            lags = (lags * rng.lognormal(0.0, 0.05, WIDE_P)).astype(np.int64)
        lags = heat(lags, np.asarray(choice), WIDE_C)
        placed = isinstance(engine._resident, PlacedResident)
        delta0 = engine.delta_epochs["applied"]
        choice, grew = counted(lambda: engine.rebalance(lags))
        add_counts(launches, grew)
        kind = "delta" if engine.delta_epochs["applied"] > delta0 else "dense"
        shard_k6 = grew["state_digest_sharded"]
        want, ref_grew = counted(lambda: ref.rebalance(lags))
        add_counts(launches, ref_grew)
        if (not np.array_equal(choice, want) or not engine.last_stats.refined
                or (k == 2) != (kind == "delta")
                or device.type == "cuda" and placed and shard_k6 != WP_PLACED_D):
            raise AssertionError(f"wide paths 4m(d) epoch {k + 1} ({kind}, placed {placed}): "
                                 f"launches {grew}, refined {engine.last_stats.refined}")
        epochs.append({"kind": kind, "placed": placed, "launches": grew})
        log(f"wide paths 4m(d) placed stream epoch {k + 1} ({kind}, placed before {placed}): "
            f"equal to the unplaced engine; launches {grew}")
    res = engine._resident
    if not isinstance(res, PlacedResident) or len(res.shards) != WP_PLACED_D:
        raise AssertionError("wide paths 4m(d): the resident state is not placed")
    err, times = wide_shard_digest(res)
    report["placed"] = {"epochs": epochs, "shard_digest": times}
    table = np.random.default_rng(16).integers(0, 10**6, (WP_TOPICS, WP_TOPIC_P))
    report["topics"] = sharded_topics(device, launches, (table.astype(np.int64), WIDE_C),
                                      WP_TOPIC_SHAPES, "4m(c)")
    return k5["max_abs_err"], err, report


def wide_shard_digest(res) -> tuple:
    """4m (d): K6's shard entry on a placed wide state (``shard_digest_held``
    against the one-state K6 on the gathered state), passing the host
    check; then timed."""
    choice, tab, counts, lags = res.gather()
    ls, cs, offsets = res.lag_shards, res.choice_shards, res.row_offsets
    single = refine.state_digest(lags, choice, counts, WIDE_C, row_tab=tab)
    err = shard_digest_held(ls, cs, counts, WIDE_C, tab, offsets, single, "wide paths 4m(d)")
    if scrub.digest_failures(single.cpu().numpy(), WIDE_P, int(lags.sum())):
        raise AssertionError(f"wide paths 4m(d): the placed state's digest {single.tolist()} "
                             "fails the host check")
    return err, shard_digest_times(ls, cs, counts, WIDE_C, tab, offsets, "wide placed")


def wide_federation(device, leader: dict, launches: dict) -> tuple:
    """4m (e): three port sidecars over loopback with phase 4l's group split
    round-robin by partition id (66,667 / 66,667 / 66,666 rows), WIDE_C
    members, 16 rounds: rung ``global`` on all three, each shard's counts
    within floor / ceil, quality within ``WP_FED_QUALITY`` of phase 4l's
    single-leader ``sinkhorn`` (``leader``); a full partition answered on
    sidecar 0 ``last_good_global`` (and, with the cache expired,
    ``local_only``, held to the plain rounds path) with zero request
    errors, a heal re-converged; then K3's column
    form (``need="both"``) at one exchange round's shape against its plain
    version, and timed.  Returns (K3's max |diff|, the report)."""
    lags, members = wide_workload()
    full = lags["t0"]
    pids = [np.arange(i, WIDE_P, FED_N) for i in range(FED_N)]
    shards = [full[p] for p in pids]
    owner = {m: j for j, m in enumerate(members)}
    totals = np.zeros(WIDE_C)
    for m, tps in leader.items():
        totals[owner[m]] += full[[p for _, p in tps]].sum()
    leader_q = float(totals.max() / totals.mean())
    trio = FedTrio(device, "wide", rounds=FED_ROUNDS)
    try:
        reset_counts()
        for i in range(FED_N):
            trio.assign(i, shards[i], members, pids[i])
        out = [trio.assign(i, shards[i], members, pids[i]) for i in range(FED_N)]
        fed = [r["federation"] for r, _ in out]
        if any(f["rung"] != "global" for f in fed):
            raise AssertionError(f"wide paths 4m(e): {fed}")
        choices = [local_choice(r, members, p) for (r, _), p in zip(out, pids)]
        for i, ch in enumerate(choices):
            counts = np.bincount(ch, minlength=WIDE_C)
            if ch.min() < 0 or counts.max() - counts.min() > 1:
                raise AssertionError(f"wide paths 4m(e): shard {i} counts "
                                     f"{counts.min()}..{counts.max()}")
        fed_q = fed_quality(shards, choices, WIDE_C)
        if not fed_q <= leader_q * WP_FED_QUALITY:
            raise AssertionError(f"wide paths 4m(e): quality {fed_q} against phase 4l's "
                                 f"sinkhorn {leader_q}")
        part, heal = partition_drill(trio, shards, members, pids, [0], "wide paths 4m(e)")
        grew = read_counts()
        add_counts(launches, grew)
        if device.type == "cuda" and (grew["plan_stats"] < sum(f["rounds"] for f in fed)
                                      or grew["rounds_scan"] < 1):
            raise AssertionError(f"wide paths 4m(e): launches {grew}")
        report = {"rows": [int(s.shape[0]) for s in shards],
                  "rounds": [f["rounds"] for f in fed],
                  "converged": [f["converged"] for f in fed],
                  "walls_ms": [w for _, w in out], "quality": fed_q,
                  "leader_quality": leader_q, "partition_rungs": part,
                  "heal_rounds": [h["rounds"] for h in heal], "launches": grew,
                  "local_only_checked": trio.local_only_checked}
        log(f"wide paths 4m(e) federation, {report['rows']} rows over 3 sidecars, C={WIDE_C}: "
            f"rung global, rounds {report['rounds']}, walls {report['walls_ms']} ms, quality "
            f"{fed_q!r} against phase 4l's sinkhorn {leader_q!r}; partition {part} with zero "
            f"request errors, heal rounds {report['heal_rounds']}; launches {grew}")
    finally:
        trio.close()
    k3_err = fed_k3_check(device, (("wide shard", shards[0], WIDE_C),))
    args = fed_k3_args(shards[0], WIDE_C, device)
    t = op_times(lambda: plan_stats.plan_stats(*args, need="both"), KERNEL_NAMES["plan_stats"])
    plain_ms = median_event_ms(lambda: plan_stats.plan_stats_torch(*args, need="both"))
    U = args[0].shape[0]
    # One exp an entry of the [U, C] plan; the three value vectors and the
    # duals read once, the two marginals written once.
    bound, by = exp_bound(U * WIDE_C, 4 * (3 * U + 4 * WIDE_C))
    library = median_event_ms(lambda: softmax_library(args[0], args[3], args[4],
                                                      (args[2], args[1])))
    report["k3_both"] = dict(ms=t["event_ms"], alone_ms=t["alone_ms"], plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, library_ms=library, U=U, C=WIDE_C,
                             launches=t["launches"])
    log(f"times  plan_stats need=both at one wide exchange round (U={U} C={WIDE_C}): "
        f"{report['k3_both']}")
    return k3_err, report


def wide_paths(device, answers: dict) -> tuple:
    """Phase 4m: the wide group on every other path, each held to phase
    4l's answers or the port's own plain path: (a) the sidecar, (b) the
    coalescer, (c) the sharded programs and the topic axis, (d) placement,
    (e) federation.  Every K1 and K7 launch is named by form (``FormSpy``):
    at 20,000 members the cluster form, with no scratch.  Returns (the
    main paths' launches, the kernel checks' max |diff| by kernel, the
    ``wide_paths`` report, which holds the kernels' times)."""
    t0 = time.perf_counter()
    launches = {name: 0 for name, _ in COUNTERS}
    arr = wide_workload()[0]["t0"]
    report, seconds = {}, {}
    spy = FormSpy()
    with spy:
        for leg, run in (
                ("sidecar", lambda: wide_sidecar(device, answers, launches)),
                ("coalesce", lambda: wide_coalesce(device, launches)),
                ("sharded", lambda: wide_sharded_and_placed(device, arr, launches)),
                ("federation", lambda: wide_federation(device, answers["sinkhorn"], launches))):
            start = time.perf_counter()
            report[leg] = run()
            seconds[leg] = time.perf_counter() - start
    rows_err, report["coalesce"] = report["coalesce"]
    k5_err, shard_err, report["sharded"] = report["sharded"]
    k3_err, report["federation"] = report["federation"]
    want = slot_form(rounds_cuda.slots_for(WIDE_C))
    if device.type == "cuda" and (
            len(spy.forms) != launches["rounds_scan"] + launches["scan_greedy"]
            or {f[2] for f in spy.forms} != {want} or spy.scratch_bytes):
        raise AssertionError(f"wide paths: launches {launches}, K1/K7 forms {spy.forms}, "
                             f"{spy.scratch_bytes} bytes of scratch")
    report.update(launches=launches, seconds=seconds, scratch_bytes=spy.scratch_bytes,
                  forms=sorted({(f[0], f[2]) for f in spy.forms}),
                  card=CARD[0] if CARD else None, phase_s=time.perf_counter() - t0)
    log(f"wide paths: every K1/K7 launch ({len(spy.forms)}) in the {want} form, no scratch; "
        f"launches {launches}; legs {seconds} s")
    errs = {"superblock_partials": k5_err, "plan_stats": k3_err, "state_digest_rows": rows_err,
            "state_digest_sharded": shard_err}
    return launches, errs, report


# -- phase 4n: the fenced takeover -------------------------------------------

# bench.py's handoff_storm (config 10) at config 5's width: N streams of
# STREAM_P x STREAM_C behind sidecars that share one object backend, its
# lease TTL and wait, and sidecar B's cap on concurrent dense rebuilds.
TAKEOVER_N = 4
TAKEOVER_TTL_S = 2.0
TAKEOVER_WAIT_S = 30.0
TAKEOVER_INFLIGHT = 2


class TakeoverFleet:
    """Phase 4n's streams and sidecars: each stream's lags drawn from its
    own ``default_rng(9000 + i)``, epoch after epoch, as bench.py's
    handoff_storm draws them; every sidecar on the card with the host rung
    off, the ``object`` backend in ``root`` and explicit snapshots only."""

    def __init__(self, device, root: str, launches: dict):
        self.sids = [f"h{i}" for i in range(TAKEOVER_N)]
        self.members = [f"c{j:04d}" for j in range(STREAM_C)]
        self.rngs = [np.random.default_rng(9000 + i) for i in range(TAKEOVER_N)]
        self.device = device
        self.launches = launches
        self.knobs = dict(port=0, device=device, host_fallback=False, scrub_interval_ms=0,
                          snapshot_path=root, snapshot_backend="object",
                          snapshot_lease_ttl_s=TAKEOVER_TTL_S,
                          snapshot_lease_wait_s=TAKEOVER_WAIT_S, snapshot_interval_s=3600.0,
                          coalesce_max_batch=TAKEOVER_N)

    def lags(self) -> dict:
        """Every stream's next epoch."""
        return {sid: rng.integers(0, 10**6, STREAM_P).astype(np.int64)
                for sid, rng in zip(self.sids, self.rngs)}

    def boot(self, **kw) -> tuple:
        """(a started sidecar, its ``start()`` wall in ms)."""
        from kafka_lag_based_assignor_tpu_torch import service

        reset_counts()
        t0 = time.perf_counter()
        svc = service.AssignorService(**self.knobs, **kw).start()
        wall = (time.perf_counter() - t0) * 1e3
        add_counts(self.launches, read_counts())
        return svc, wall

    def baseline(self, choices: dict, *epochs: dict) -> dict:
        """What an uninterrupted sidecar answers: for each stream, phase
        4c's engine on the card seeded with ``choices`` and rebalanced on
        each of ``epochs`` in turn; its last answer."""
        out = {}
        for sid in self.sids:
            engine = stream_engine(self.device)
            engine.seed_choice(choices[sid])
            for lags in epochs:
                out[sid] = np.asarray(engine.rebalance(lags[sid]))
        return out

    def check(self, label: str, sid: str, result: dict, want=None,
              warm_restart: bool = False, cold: bool = False) -> dict:
        """One answer's faults, counted: invalid (not every partition once,
        or a count spread above 1), mismatched (not ``want``'s bits), not a
        warm restart where one is due, or not answered warm or cold on the
        card's engine."""
        s = result["stream"]
        pids = sorted(p for tps in result["assignments"].values() for _, p in tps)
        sizes = [len(result["assignments"].get(m, ())) for m in self.members]
        faults = {
            "invalid": int(pids != list(range(STREAM_P)) or max(sizes) - min(sizes) > 1),
            "mismatched": int(want is not None and not np.array_equal(
                wire_choice(result["assignments"], self.members), want)),
            "not_warm_restart": int(warm_restart and not s["warm_restart"]),
            "off_engine": int(s["fallback_used"] or s["degraded_rung"] != "none"
                              or s["shed"] is not None or s["cold_start"] != cold),
        }
        if any(faults.values()):
            raise AssertionError(f"takeover {label} {sid}: {faults}; {s}")
        return faults

    def wave(self, svc, label: str, lags: dict, want=None, warm_restart: bool = False) -> dict:
        """Every stream's epoch at once, one client each; every answer
        checked.  Returns the walls, the faults, the launches and the
        builds (``compile_count()`` delta)."""
        from kafka_lag_based_assignor_tpu_torch import service
        from kafka_lag_based_assignor_tpu_torch.utils.observability import compile_count

        rows = {sid: wire_rows(lags[sid]) for sid in self.sids}
        with ExitStack() as stack:
            clients = {sid: stack.enter_context(
                service.AssignorServiceClient(*svc.address, timeout_s=600)) for sid in self.sids}
            builds = compile_count()
            reset_counts()
            got, walls, wall = at_once(f"takeover {label}", {
                sid: lambda sid=sid: clients[sid].stream_assign(
                    sid, "t0", rows[sid], self.members, options=SIDECAR_STREAM_OPTS)
                for sid in self.sids})
            grew = read_counts()
        add_counts(self.launches, grew)
        faults = {"invalid": 0, "mismatched": 0, "not_warm_restart": 0, "off_engine": 0}
        for sid in self.sids:
            add_counts(faults, self.check(label, sid, got[sid],
                                          None if want is None else want[sid], warm_restart))
        lat = sorted(walls.values())
        out = {"wall_ms": wall, "p50_ms": statistics.median(lat), "max_ms": lat[-1],
               "warm_restarts": sum(bool(g["stream"]["warm_restart"]) for g in got.values()),
               **faults, "builds": compile_count() - builds, "launches": grew}
        if out["builds"]:
            raise AssertionError(f"takeover {label}: {out['builds']} kernel builds")
        log(f"takeover {label}: {TAKEOVER_N} epochs at once in {wall:.3f} ms (p50 "
            f"{out['p50_ms']:.3f}, max {out['max_ms']:.3f}); faults {faults}; launches {grew}")
        return out


def takeover_boot(svc, boot_ms: float, mode: str) -> dict:
    """The boot's hand-off and recovery, held to ``mode`` and every stream."""
    h, rec = dict(svc._last_handoff or {}), dict(svc._last_recovery or {})
    if (h.get("acquired"), h.get("mode"), rec.get("outcome"),
            rec.get("streams_recovered")) != (True, mode, "ok", TAKEOVER_N):
        raise AssertionError(f"takeover: expected a {mode} of {TAKEOVER_N} streams; "
                             f"hand-off {h}, recovery {rec}")
    out = {"mode": h["mode"], "token": h["token"], "waited_ms": h["waited_ms"],
           "boot_ms": boot_ms, "recovery_ms": rec["duration_ms"],
           "streams_recovered": rec["streams_recovered"],
           "streams_prestacked": rec.get("streams_prestacked", 0),
           "seeded_depth": rec.get("seeded_depth")}
    log(f"takeover boot: {out}")
    return out


def takeover_path(device) -> tuple:
    """Phase 4n, bench.py's handoff_storm on the card: sidecar A serves N
    config-5-wide streams (serial cold chains, then two concurrent warm
    waves through the coalescer), snapshots and crashes holding the lease;
    B takes over with ``resync_max_inflight=2`` and answers its first-epoch
    storm bit-equal to engines seeded with A's choices, with no build and
    no K1; A's stale write is fenced; B serves a second wave and drains; C
    takes over with the pre-stack and answers its storm bit-equal to its
    own baseline with no build and no dense rebuild.  Returns (the
    launches, the ``takeover`` line)."""
    import tempfile

    from kafka_lag_based_assignor_tpu_torch import service
    from kafka_lag_based_assignor_tpu_torch.utils import metrics

    def series(name, **labels):
        return metrics.REGISTRY.counter(name, labels or None).value

    t_phase = time.perf_counter()
    launches = {name: 0 for name, _ in COUNTERS}
    report = {"streams": TAKEOVER_N, "partitions": STREAM_P, "consumers": STREAM_C,
              "backend": "object", "lease_ttl_s": TAKEOVER_TTL_S}
    svcs = []
    with tempfile.TemporaryDirectory(prefix="klba-takeover-") as root:
        fleet = TakeoverFleet(device, root, launches)
        try:
            # A: serial cold chains, two concurrent warm waves, a snapshot,
            # then a crash (stop without the drain: the lease stays held).
            a, boot_a = fleet.boot()
            svcs.append(a)
            cold = []
            lags = fleet.lags()
            with service.AssignorServiceClient(*a.address, timeout_s=600) as client:
                for sid in fleet.sids:
                    t0 = time.perf_counter()
                    result, grew = counted(lambda: client.stream_assign(
                        sid, "t0", wire_rows(lags[sid]), fleet.members,
                        options=SIDECAR_STREAM_OPTS))
                    cold.append((time.perf_counter() - t0) * 1e3)
                    add_counts(launches, grew)
                    fleet.check("A cold", sid, result, cold=True)
                    if device.type == "cuda" and grew["rounds_scan"] != 1:
                        raise AssertionError(f"takeover A cold {sid}: launches {grew}")
            waves = [fleet.wave(a, f"A warm wave {k}", fleet.lags()) for k in range(2)]
            if device.type == "cuda" and not all(w["launches"]["state_digest_rows"] for w in waves):
                raise AssertionError("takeover A: a warm wave did not go through the coalescer")
            if not a.snapshot_now()["ok"]:
                raise AssertionError("takeover A: the snapshot was not written")
            choices_a = {sid: a._streams[sid].engine.export_state() for sid in fleet.sids}
            a.stop()
            report["a"] = {"boot_ms": boot_a, "cold_chain_ms": cold,
                           "warm_waves_ms": [w["wall_ms"] for w in waves]}
            log(f"takeover A: cold chains {cold} ms, warm waves "
                f"{report['a']['warm_waves_ms']} ms; snapshot written, A stopped holding "
                "the lease")

            # B: the crash takeover, paced, then A's stale write.
            lags_b = fleet.lags()
            want_b = fleet.baseline(choices_a, lags_b)
            paced = series("klba_resync_paced_total")
            b, boot_b = fleet.boot(resync_max_inflight=TAKEOVER_INFLIGHT)
            svcs.append(b)
            crash = takeover_boot(b, boot_b, "takeover_crash")
            crash["storm"] = fleet.wave(b, "B storm", lags_b, want_b, warm_restart=True)
            crash["paced"] = series("klba_resync_paced_total") - paced
            crash["high_water"] = b._resync_pacer.high_water
            if device.type == "cuda" and crash["storm"]["launches"]["rounds_scan"]:
                raise AssertionError(f"takeover B storm: {crash['storm']['launches']}")
            if crash["high_water"] > TAKEOVER_INFLIGHT:
                raise AssertionError(f"takeover B: {crash['high_water']} dense rebuilds at once")
            fenced = series("klba_snapshot_writes_total", outcome="fenced")
            version = b._snapshot_store.backend.version()
            stale = a.snapshot_now()
            overwrites = int(bool(stale.get("ok"))) + int(
                b._snapshot_store.backend.version() != version)
            report["fenced_stale_writes"] = series("klba_snapshot_writes_total",
                                                   outcome="fenced") - fenced
            report["adopted_state_overwrites"] = overwrites
            if overwrites or report["fenced_stale_writes"] != 1 or not stale.get("fenced"):
                raise AssertionError(f"takeover: A's stale write answered {stale}; "
                                     f"{overwrites} overwrites")
            log(f"takeover: A's stale write fenced ({stale.get('error')}); backend version "
                f"{version} unmoved; B paced {crash['paced']} epochs, high water "
                f"{crash['high_water']}")

            # B's second wave (through the coalescer), then the drain.
            lags_b2 = fleet.lags()
            want_b2 = fleet.baseline(choices_a, lags_b, lags_b2)
            crash["wave_2"] = fleet.wave(b, "B wave 2", lags_b2, want_b2)
            if device.type == "cuda" and not crash["wave_2"]["launches"]["state_digest_rows"]:
                raise AssertionError("takeover B: wave 2 did not go through the coalescer")
            choices_b = {sid: b._streams[sid].engine.export_state() for sid in fleet.sids}
            t0 = time.perf_counter()
            if not b.begin_drain() or not b.wait_stopped(120):
                raise AssertionError("takeover B: the drain did not finish")
            crash["drain_ms"] = (time.perf_counter() - t0) * 1e3

            # C: the drain hand-off with the pre-stack.
            lags_c = fleet.lags()
            want_c = fleet.baseline(choices_b, lags_c)
            c, boot_c = fleet.boot(recovery_prestack=True)
            svcs.append(c)
            drain = takeover_boot(c, boot_c, "takeover_drain")
            if drain["waited_ms"] >= 5_000.0 or drain["streams_prestacked"] != TAKEOVER_N:
                raise AssertionError(f"takeover C: {drain}")
            stale_resident = [sid for sid in fleet.sids
                              if c._streams[sid].engine.needs_dense_resync]
            if stale_resident:
                raise AssertionError(f"takeover C: not pre-stacked: {stale_resident}")
            drain["storm"] = fleet.wave(c, "C storm", lags_c, want_c, warm_restart=True)
            # The pacer gives a slot only to an epoch whose resident state
            # must be rebuilt from a dense upload.
            drain["dense_rebuilds"] = c._resync_pacer.high_water
            if device.type == "cuda" and drain["storm"]["launches"]["rounds_scan"]:
                raise AssertionError(f"takeover C storm: {drain['storm']['launches']}")
            if drain["dense_rebuilds"]:
                raise AssertionError("takeover C: a first epoch rebuilt its resident densely")
        finally:
            for svc in svcs:
                svc.stop()
    report.update(crash=crash, drain=drain, launches=launches,
                  builds=sum(leg["storm"]["builds"] for leg in (crash, drain))
                  + crash["wave_2"]["builds"],
                  seconds=time.perf_counter() - t_phase, card=CARD[0] if CARD else None)
    log(f"main path (takeover): launches {launches}; {report['seconds']:.3f} s")
    return launches, report


# -- phase 4o: the scenario fleet and the trace plane ------------------------

# bench.py's scenario_fleet (config 16) runs the whole corpus; its
# skew_storm scenario runs again at config 5's width (the trace's own
# generator, seed and schedule; 10 epochs), where the envelope's churn
# bound (set at 192 x 4) is reported, not gated.
SKEW_P, SKEW_C, SKEW_EPOCHS = STREAM_P, STREAM_C, 10
# bench.py's tracing probe (config 17): the warm no-op epoch's engine at
# config 5's shape, the paired estimator's pairs, the 1 % budget
# (bench.py's gate), and the sidecars' shape for the federated join and the
# wave links.
TRACE_NOOP_ITERS, TRACE_NOOP_THRESHOLD = 64, 1000.0
TRACE_NULL_PAIRS, TRACE_PAIRS, TRACE_P50_RUNS = 600, 2400, 200
TRACE_BUDGET = 0.01
TRACE_P, TRACE_C, TRACE_W = 2048, 8, 4


# Row ids a corrupted row table can hold for phase 4o's 512-row states:
# one past the end (the next row's first slot in a stacked wave), far past
# it, a high bit flipped, negative past one wrap.
CORRUPT_ROWS = (513, 512 + 12345, 2**30, -(512 + 7))


def corrupted_refine(device) -> dict:
    """4o, first: the refine bodies on a corrupted row table, on the card,
    against the same call on the CPU (the plain path).  Three resident
    states (P 480 of B 512, C 8; a rounds solve, then drifted lags), row 1's
    heaviest and lightest consumers' first slots overwritten with each of
    ``CORRUPT_ROWS``: the wave's batched refine (``coalesce._epoch_rows``)
    and the single-stream refine (both bodies) must finish without a
    device-side assert and give the CPU's bits, the clean rows' answers
    included (the ``wave_corruption`` scenario's flips once ended the
    sidecar's CUDA context here).  Returns the cases held."""
    from kafka_lag_based_assignor_tpu_torch.ops import coalesce
    from kafka_lag_based_assignor_tpu_torch.ops.packing import table_rows
    from kafka_lag_based_assignor_tpu_torch.ops.rounds_kernel import assign_topic_rounds

    rng = np.random.default_rng(7)
    N, P, B, C = 3, 480, 512, 8
    rows = []
    for _ in range(N):
        lags = np.zeros(B, np.int64)
        lags[:P] = rng.integers(10**6, 10**8, P)
        lt = torch.from_numpy(lags)
        valid = torch.arange(B) < P
        choice, _, _ = assign_topic_rounds(lt, torch.arange(B, dtype=torch.int32), valid, C,
                                           n_valid=P)
        lags[:P] = rng.integers(10**6, 10**8, P)
        tab, counts, totals = refine.build_choice_tables(lt, valid, choice, C, table_rows(B, C))
        rows.append((lt, choice.to(torch.int32), tab, counts, totals))
    held = []
    for bad in CORRUPT_ROWS:
        stacked = [torch.stack([r[k] for r in rows]) for k in range(5)]
        for c in (int(rows[1][4].argmax()), int(rows[1][4].argmin())):
            stacked[2][1, c, :5] = bad
        limits = torch.full((N,), -1.0, dtype=torch.float64)

        def wave(dev):
            lags, choice, tab, counts, _ = (t.to(dev) for t in stacked)
            return coalesce._epoch_rows(lags.to(torch.int32), choice, tab, counts,
                                        limits.to(dev), C, 32, 4, 32)

        def single(dev, bulk):
            kw = dict(bulk_transfer=True, fan=8) if bulk else {}
            return refine.refine_rounds_resident(
                *(t[1].to(dev) for t in stacked), C, iters=32, max_pairs=4,
                exchange_budget=32, quality_limit=-1.0, **kw)

        for label, run in (("wave", wave), ("parity", lambda d: single(d, False)),
                           ("bulk", lambda d: single(d, True))):
            got, want = run(device), run(torch.device("cpu"))
            sync(device)
            for k, (g, w) in enumerate(zip(got, want)):
                g = g.cpu() if isinstance(g, torch.Tensor) else torch.as_tensor(g)
                w = w if isinstance(w, torch.Tensor) else torch.as_tensor(w)
                if not torch.equal(g, w):
                    raise AssertionError(f"scenarios 4o: the {label} refine on a row table "
                                         f"holding {bad} differs from the CPU in output {k}")
            held.append(f"{label} {bad}")
    log(f"scenarios 4o: the refine bodies on corrupted row tables ({list(CORRUPT_ROWS)}) on "
        f"the card equal the CPU bit for bit, no device-side assert: {len(held)} cases")
    return {"cases": held}


def fleet_leg(device) -> dict:
    """4o (a): the whole corpus (all 12 scenarios, fast or not) through the
    port's sidecars on ``device``, each booted with the service kwargs the
    corpus gives it (the host rung on, as the faulted scenarios' envelopes
    need; every clean scenario's envelope has ``max_rung="none"``, so a
    kernel fault there fails the run instead of hiding behind the host
    rung); the cross-axis mesh scenario on 8 virtual shards of the card.
    Every envelope must hold, no assignment may be invalid, and every
    steady phase must build nothing (the kernels were built in phase 2)."""
    from kafka_lag_based_assignor_tpu_torch.scenarios import CORPUS, run_fleet

    reset_counts()
    t0 = time.perf_counter()
    fleet = run_fleet(device=device, log=log)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    rows = fleet["scenarios"]
    steady_builds = {r["scenario"]: r["compiles_by_phase"].get("steady", 0)
                     for r in rows if r.get("compiles_by_phase") is not None}
    report = {
        "scenarios": len(rows),
        "composed_fault_scenarios": sum(
            1 for r in rows
            if len(r["planes"]) >= 2 or (r["planes"] and r["crash_epoch"] is not None)),
        "crash_restart_scenarios": sum(1 for r in rows if r["crash_epoch"] is not None),
        "served": sum(r["served"] for r in rows),
        "sheds": sum(r["sheds"] for r in rows),
        "invalid": sum(r["invalid"] for r in rows),
        "quarantines": sum(r.get("quarantines", 0) for r in rows),
        "corruptions_planted": sum(r.get("corruptions_planted", 0) for r in rows),
        "twin_mismatches": {r["scenario"]: r["twin_mismatches"] for r in rows
                            if r.get("twin_mismatches") is not None},
        "mesh_degrades": {r["scenario"]: r["mesh_degrades"] for r in rows
                          if r.get("mesh_degrades")},
        "steady_builds": steady_builds,
        "wall_s": {r["scenario"]: r["wall_s"] for r in rows},
        "violations": fleet["violations"],
        "failed": [(r["scenario"], r["violations"]) for r in rows if r["violations"]],
        "launches": launches, "seconds": seconds,
    }
    fed = [r for r in rows if "federation_ladder" in r]
    report["federation_ladder"] = {r["scenario"]: [e["rung"] for e in r["federation_ladder"]]
                                   for r in fed}
    log(f"scenarios 4o(a): {report['scenarios']} scenarios ({report['composed_fault_scenarios']} "
        f"composed, {report['crash_restart_scenarios']} crash-restart), served "
        f"{report['served']}, sheds {report['sheds']}, invalid {report['invalid']}, quarantines "
        f"{report['quarantines']}, corruptions planted {report['corruptions_planted']}, "
        f"violations {report['violations']}; steady builds {steady_builds}; launches "
        f"{launches}; {seconds:.1f} s")
    if (not fleet["ok"] or len(rows) != len(CORPUS) or report["invalid"]
            or any(steady_builds.values()) or len(steady_builds) != len(rows) - len(fed)):
        raise AssertionError(f"scenarios 4o(a): {report}")
    # K1 and K6 in every stream scenario, K3 in the federated one's
    # exchanges, K5 and K6's shard entry in the mesh scenario's sharded
    # solves and placed state.
    if device.type == "cuda" and not all(launches[k] for k in (
            "rounds_scan", "plan_stats", "superblock_partials", "state_digest",
            "state_digest_rows", "state_digest_sharded")):
        raise AssertionError(f"scenarios 4o(a): a kernel of the fleet's paths never "
                             f"launched: {launches}")
    return report


def skew_storm_wide(device) -> dict:
    """4o (b): the corpus' ``skew_storm`` (``hot_skew_storm``, seed 1101)
    at config 5's width, ``SKEW_P`` x ``SKEW_C``, ``SKEW_EPOCHS`` epochs,
    through a port sidecar on ``device`` booted with the scenario's kwargs
    (its warm-up at that shape): every epoch answered, valid (complete,
    count spread <= 1), at rung ``none`` and unshed, no build in any phase;
    the steady churn is reported beside the envelope's bound."""
    from kafka_lag_based_assignor_tpu_torch.scenarios import corpus, evaluate, generate
    from kafka_lag_based_assignor_tpu_torch.scenarios.replay import replay

    sc = corpus.get_scenario("skew_storm")
    trace = generate(sc.trace, sc.seed, partitions=SKEW_P, consumers=SKEW_C,
                     epochs=SKEW_EPOCHS)
    reset_counts()
    t0 = time.perf_counter()
    res = replay(trace, service_kwargs=dict(sc.service_kwargs), device=device)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    recs = res.records
    steady = [r.churn for r in recs if r.phase == "steady" and r.churn is not None]
    violations = evaluate(res, sc.envelope)
    report = {
        "partitions": SKEW_P, "consumers": SKEW_C, "epochs": len(trace.epochs),
        "trace_sha256": res.trace_sha256,
        "rungs": [r.rung for r in recs], "valid": [r.valid for r in recs],
        "latency_ms": [r.latency_ms for r in recs], "churn": [r.churn for r in recs],
        "steady_churn_max": max(steady), "churn_bound": sc.envelope.max_steady_churn,
        "builds_by_phase": res.compiles_by_phase, "envelope_violations": violations,
        "replay_wall_s": res.wall_s, "launches": launches, "seconds": seconds,
    }
    log(f"scenarios 4o(b): skew_storm at {SKEW_P} x {SKEW_C}, {len(recs)} epochs: rungs "
        f"{report['rungs']}, epoch walls {[round(x) for x in report['latency_ms']]} ms, "
        f"steady churn max {report['steady_churn_max']!r} (envelope bound "
        f"{sc.envelope.max_steady_churn}, reported), builds {res.compiles_by_phase}, "
        f"launches {launches}; {seconds:.1f} s")
    if (len(recs) != SKEW_EPOCHS or not all(r.ok and r.valid for r in recs)
            or any(r.rung != "none" or r.shed is not None for r in recs)
            or any(res.compiles_by_phase.values())
            or [v for v in violations if not v.startswith("steady-state churn")]):
        raise AssertionError(f"scenarios 4o(b): {report}")
    if device.type == "cuda" and not (launches["rounds_scan"] and launches["state_digest"]):
        raise AssertionError(f"scenarios 4o(b): launches {launches}")
    return report


def trace_overhead(device) -> dict:
    """4o (c) 1: bench.py's tracing cost on the warm no-op epoch at config
    5's shape (``refine_iters`` 64, threshold 1000), the traced client scope
    against the flat request scope the sidecar wrapped every request in
    before the trace plane, by bench.py's order-cancelling paired estimator
    (alternating order, 20 %-trimmed means per order, averaged), at the
    default healthy sample rate 0.01; no build in the traced loop."""
    from contextlib import contextmanager

    from kafka_lag_based_assignor_tpu_torch.utils import metrics as m
    from kafka_lag_based_assignor_tpu_torch.utils import trace as trace_mod
    from kafka_lag_based_assignor_tpu_torch.utils.observability import (
        compile_count,
        install_compile_counter,
    )

    install_compile_counter()
    coll = trace_mod.collector()
    prev_rate = coll.sample_rate
    coll.sample_rate = 0.01
    lags = np.random.default_rng(8).integers(1, 10**6, size=STREAM_P)
    eng = streaming.StreamingAssignor(num_consumers=STREAM_C, refine_iters=TRACE_NOOP_ITERS,
                                      refine_threshold=TRACE_NOOP_THRESHOLD, device=device)
    eng.rebalance(lags)
    eng.rebalance(lags)
    with m.request_scope(kind="client", root_name="client"):
        eng.rebalance(lags)

    @contextmanager
    def flat_scope():
        ctx = m._RequestCtx(m.mint_request_id(), m.REGISTRY.clock())
        m._tls.ctx = ctx
        try:
            yield
        finally:
            m._tls.ctx = None
            m._teardown_ctx(ctx, finish=True)

    def run(scope):
        def one():
            t0 = time.perf_counter()
            with scope():
                eng.rebalance(lags)
            return (time.perf_counter() - t0) * 1e6
        return one

    plain = run(flat_scope)
    traced = run(lambda: m.request_scope(kind="client", root_name="client"))

    def trimmed_mean(xs, frac=0.2):
        xs = np.sort(np.asarray(xs))
        k = int(len(xs) * frac)
        return float(xs[k: len(xs) - k].mean())

    def paired_delta(fa, fb, pairs):
        ab, ba = [], []
        for i in range(pairs):
            if i & 1:
                b = fb()
                ba.append(b - fa())
            else:
                a = fa()
                ab.append(fb() - a)
        return (trimmed_mean(ab) + trimmed_mean(ba)) / 2

    try:
        builds = compile_count()
        null_us = paired_delta(plain, plain, TRACE_NULL_PAIRS)
        marginal_us = paired_delta(plain, traced, TRACE_PAIRS)
        warm_builds = compile_count() - builds
        p50_us = float(np.percentile([plain() for _ in range(TRACE_P50_RUNS)], 50))
    finally:
        coll.sample_rate = prev_rate
    ratio = max(0.0, marginal_us) / p50_us
    out = {"noop_p50_ms": p50_us / 1e3, "marginal_us": marginal_us, "null_us": null_us,
           "overhead_ratio": ratio, "budget": TRACE_BUDGET, "warm_builds": warm_builds,
           "noop": not (eng.last_stats.refined or eng.last_stats.cold_start)}
    log(f"scenarios 4o(c) tracing: no-op epoch p50 {out['noop_p50_ms']!r} ms, marginal "
        f"{marginal_us!r} us (estimator null {null_us!r} us), overhead {ratio:.4%}, "
        f"{warm_builds} builds in the traced loop")
    if ratio >= TRACE_BUDGET or warm_builds or not out["noop"]:
        raise AssertionError(f"scenarios 4o(c) tracing overhead: {out}")
    return out


def settled_traces(coll, trace_id, want: int = 1, deadline_s: float = 10.0) -> list:
    t0 = time.perf_counter()
    while True:
        got = coll.traces(trace_id=trace_id)
        if len(got) >= want or time.perf_counter() - t0 > deadline_s:
            return got
        time.sleep(0.01)


def trace_federated_join(device) -> dict:
    """4o (c) 2: bench.py's two-sidecar drill on the card: two port
    sidecars federated at P ``TRACE_P`` (a shard each), C ``TRACE_C``; both
    shards registered and the dual cache warmed; then sidecar 0's
    ``federated_assign`` with ``peer.partition`` injected after the hello
    (the context crosses, every exchange round then fails): a degraded
    rung, and ``join_trace`` over the kept segments rebuilds ONE complete
    trace of >= 2 segments whose origin is kept as anomalous."""
    from kafka_lag_based_assignor_tpu_torch import service
    from kafka_lag_based_assignor_tpu_torch.utils import faults
    from kafka_lag_based_assignor_tpu_torch.utils import trace as trace_mod

    coll = trace_mod.collector()
    prev_rate = coll.sample_rate
    coll.sample_rate = 1.0
    rng = np.random.default_rng(0x7AC17)
    shards = [rng.integers(0, 10**6, TRACE_P).astype(np.int64) for _ in range(2)]
    members = [f"m{j}" for j in range(TRACE_C)]
    ids = ("tr0", "tr1")
    svcs, clients = [], []
    try:
        import socket

        socks = [socket.socket() for _ in range(2)]
        for s in socks:
            s.bind(("127.0.0.1", 0))
        ports = [s.getsockname()[1] for s in socks]
        for s in socks:
            s.close()
        for i in range(2):
            svcs.append(service.AssignorService(
                port=ports[i], device=device, host_fallback=False, coalesce_max_batch=1,
                scrub_interval_ms=0.0, breaker_cooldown_s=0.5, federation_self_id=ids[i],
                federation_peers=f"{ids[1 - i]}=127.0.0.1:{ports[1 - i]}",
                federation_rounds=8, federation_sync_timeout_s=300.0).start())
            clients.append(service.AssignorServiceClient(*svcs[i].address, timeout_s=600.0))

        def fed(i):
            return clients[i].federated_assign("t0", wire_rows(shards[i]), members)

        for _ in range(2):
            fed(0)
            fed(1)
        reset_counts()
        with faults.injected(faults.FaultInjector(17).plan("peer.partition", times=0,
                                                           after=1)):
            r = fed(0)
        launches = read_counts()
        tid = clients[0].last_trace_id
        t0 = time.perf_counter()
        while True:
            entries = settled_traces(coll, tid, want=2)
            verdict = trace_mod.join_trace(entries)
            if verdict["complete"] or time.perf_counter() - t0 > 10.0:
                break
            time.sleep(0.01)
    finally:
        coll.sample_rate = prev_rate
        for c in clients:
            c.close()
        for svc in svcs:
            svc.stop()
    origins = [e for e in entries if e["root"]["parent_id"] is None]
    out = {"rung": r["federation"]["rung"], "trace_id": tid, "join": verdict,
           "segments": len(entries),
           "remote_segments": sum(1 for e in entries if e["root"]["parent_id"] is not None),
           "origin_outcome": origins[0]["outcome"] if origins else None,
           "origin_anomalies": origins[0]["anomalies"] if origins else None,
           "launches": launches}
    log(f"scenarios 4o(c) federated join: rung {out['rung']}, trace {tid}: {verdict}; origin "
        f"{out['origin_outcome']} {out['origin_anomalies']}; launches {launches}")
    if (out["rung"] not in ("last_good_global", "local_only") or not verdict["complete"]
            or verdict["segments"] < 2 or len(origins) != 1 or not out["remote_segments"]
            or out["origin_outcome"] != "kept_anomalous"):
        raise AssertionError(f"scenarios 4o(c) federated join: {out}")
    return out


def trace_wave_links(device) -> dict:
    """4o (c) 3: bench.py's wave drill on the card: a port sidecar with
    ``coalesce_max_batch`` ``TRACE_W`` and a 500 ms window, ``TRACE_W``
    streams at P ``TRACE_P``, C ``TRACE_C`` with every epoch dispatched
    (``guardrail`` and ``refine_threshold`` off), three concurrent rounds:
    every request trace of the last round links to its ``coalesce.wave``
    trace, and that wave trace links back to the request."""
    from kafka_lag_based_assignor_tpu_torch import service
    from kafka_lag_based_assignor_tpu_torch.utils import trace as trace_mod

    coll = trace_mod.collector()
    prev_rate = coll.sample_rate
    coll.sample_rate = 1.0
    rng = np.random.default_rng(0x7AC17 + 1)
    members = [f"m{j}" for j in range(TRACE_C)]
    opts = {"guardrail": None, "refine_threshold": None}
    sids = [f"w{i}" for i in range(TRACE_W)]
    svc = service.AssignorService(
        port=0, device=device, host_fallback=False, coalesce_max_batch=TRACE_W,
        coalesce_window_ms=500.0, scrub_interval_ms=3600_000.0,
        breaker_cooldown_s=0.5).start()
    clients = {sid: service.AssignorServiceClient(*svc.address, timeout_s=300.0)
               for sid in sids}
    links, missing = {}, []
    try:
        reset_counts()
        for k in range(3):
            lags = {sid: rng.integers(0, 10**6, TRACE_P) for sid in sids}
            at_once(f"4o wave round {k}", {
                sid: (lambda s=sid: clients[s].stream_assign(
                    s, "t0", wire_rows(lags[s]), members, options=opts))
                for sid in sids})
        launches = read_counts()
        for sid in sids:
            tid = clients[sid].last_trace_id
            forward = [ln["trace_id"] for e in settled_traces(coll, tid)
                       for ln in e.get("links", []) if ln.get("relation") == "wave"]
            if not forward:
                missing.append(f"{sid}: no wave link")
                continue
            back = [ln for e in settled_traces(coll, forward[-1])
                    for ln in e.get("links", [])
                    if ln.get("relation") == "request" and ln.get("trace_id") == tid]
            links[sid] = forward[-1]
            if not back:
                missing.append(f"{sid}: wave {forward[-1]} has no link back")
    finally:
        coll.sample_rate = prev_rate
        for c in clients.values():
            c.close()
        svc.stop()
    out = {"waves": sorted(set(links.values())), "linked": sorted(links),
           "missing": missing, "launches": launches}
    log(f"scenarios 4o(c) wave links: {len(links)} of {TRACE_W} requests linked both ways to "
        f"{len(out['waves'])} wave trace(s); launches {launches}")
    if missing or len(links) != TRACE_W:
        raise AssertionError(f"scenarios 4o(c) wave links: {out}")
    if device.type == "cuda" and not launches["state_digest_rows"]:
        raise AssertionError(f"scenarios 4o(c) wave links: no coalesced wave: {launches}")
    return out


def scenarios_path(device) -> tuple:
    """Phase 4o: (a) the scenario fleet, (b) ``skew_storm`` at config 5's
    width, (c) bench.py's tracing probe.  Returns (the launches of (a),
    (b) and the drills of (c), the ``scenarios`` report)."""
    t0 = time.perf_counter()
    report, seconds = {}, {}
    for leg, run in (("corrupted_refine", corrupted_refine), ("fleet", fleet_leg),
                     ("skew_storm_wide", skew_storm_wide),
                     ("trace_overhead", trace_overhead),
                     ("trace_federated_join", trace_federated_join),
                     ("trace_wave_links", trace_wave_links)):
        start = time.perf_counter()
        report[leg] = run(device)
        seconds[leg] = time.perf_counter() - start
    launches = {name: 0 for name, _ in COUNTERS}
    for leg in ("fleet", "skew_storm_wide", "trace_federated_join", "trace_wave_links"):
        add_counts(launches, report[leg]["launches"])
    report.update(launches=launches, seconds=seconds, phase_s=time.perf_counter() - t0,
                  card=CARD[0] if CARD else None)
    log(f"main path (scenarios): launches {launches}; legs {seconds} s")
    return launches, report


SOURCES = {
    "rounds_scan": ("csrc/rounds_scan.cu", "ops/rounds_pallas.py:194"),
    "plan_stats": ("csrc/plan_stats.cu", "ops/plan_stats.py:184"),
    "superblock_partials": ("csrc/linear_ot.cu", "ops/linear_ot_pallas.py:169"),
    "mirror_prox_step": ("csrc/linear_ot.cu", "ops/linear_ot_pallas.py:226"),
    "state_digest": ("csrc/state_digest.cu", "ops/linear_ot_pallas.py:350"),
    # The same kernel over a wave's rows: the JAX package vmaps the Pallas
    # call over the wave (ops/coalesce.py::_epoch_rows).
    "state_digest_rows": ("csrc/state_digest.cu", "ops/linear_ot_pallas.py:350"),
    # One shard of a placed state a launch: the JAX package runs the Pallas
    # call on the gathered state (the partitioner's all-gather).
    "state_digest_sharded": ("csrc/state_digest.cu", "ops/linear_ot_pallas.py:350"),
    # No Pallas kernel: the JAX package's lax.scan in this function.
    "scan_greedy": ("csrc/scan_greedy.cu", None),
}
COUNTERPARTS = {"scan_greedy": "kafka_lag_based_assignor_tpu/ops/scan_kernel.py::"
                               "assign_topic_scan"}


def kernel_line(name, launches, err, t: dict) -> dict:
    source, replaces = SOURCES[name]
    line = {
        "name": name,
        "route": "cuda",
        "source": f"kafka_lag_based_assignor_tpu_torch/{source}",
        "replaces": None if replaces is None else f"kafka_lag_based_assignor_tpu/{replaces}",
        "launches": launches,
        "max_abs_err": err,
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                             "alone_ms")},
    }
    if name in COUNTERPARTS:
        line["counterpart"] = COUNTERPARTS[name]
    for key in ("library_alone_ms", "depth", "rounds", "stages", "ns_a_step", "plain_rows",
                "plain_rows_ms", "plain_cpu_ms", "config3_ms", "config3_alone_ms", "config3_plain_ms",
                "config3_bound_ms", "config3_plain_cpu_ms", "direct_api", "design_bound_ms"):
        if key in t:
            line[key] = t[key]
    return line


def k36_times(device) -> dict:
    """K3 (``k3_times``), K6 through its wrapper at config 5's resident
    state, K5 and K4 alone at config 5, K1 alone (``k1_times``), the dense
    ``sinkhorn`` cells' quality ratios and K3's pass form (both marginals)
    at U 1,024 and C 2,000 and 16,384 and at U 4,096 and C 2,000; where the
    package has two K3 forms, each form alone at U = 1,024, 2,048, 4,096 and
    C = 16, 512, 1,024.  Uses only interfaces this change's parent has too,
    apart from the forms."""
    out = {"plan_stats": k3_times(device)}
    lags, choice, counts, tab = resident_case(pad_bucket(STREAM_P), STREAM_P, STREAM_C, device)
    out["state_digest"] = op_times(
        lambda: refine.state_digest(lags, choice, counts, STREAM_C, row_tab=tab),
        KERNEL_NAMES["state_digest"])
    (ws_b, cnt_b), C = blocks_case(5, device)
    A, B = random_duals(C, device)
    sc, prev = torch.tensor(1.0, device=device), torch.tensor(float("inf"), device=device)
    out["superblock_partials"] = device_ms(
        lambda: linear_ot_cuda.superblock_partials(ws_b, cnt_b, A, B),
        KERNEL_NAMES["superblock_partials"])[0]
    out["mirror_prox_step"] = device_ms(
        lambda: linear_ot_cuda.mirror_prox_step(ws_b, cnt_b, A, B, sc, prev,
                                                eta=linear_ot.MIRROR_PROX_ETA),
        KERNEL_NAMES["mirror_prox_step"])[0]
    out["rounds_scan"] = {name: t["alone_ms"] for name, t in k1_times(device).items()}
    out["quality_ratio"] = {
        cfg: assign_once(*baseline_workload(cfg), "sinkhorn", device)[1].quality_ratio
        for cfg in (2, 4)}
    # The pass form where the cluster cannot serve (C > 1,024), both
    # marginals, as both packages compute them.
    g = torch.Generator().manual_seed(3)
    wide = {}
    for U, C in ((1024, 2000), (1024, 16384), (4096, 2000)):
        ws = torch.rand(U, generator=g).mul_(4.0).to(device)
        cnt = torch.randint(0, 5, (U,), generator=g).float().to(device)
        args = (ws, cnt, ws * cnt, *random_duals(C, device, C))
        wide[f"U={U} C={C}"] = op_times(lambda: call_plan_stats(args, "both"),
                                        KERNEL_NAMES["plan_stats"])
    out["plan_stats_wide"] = wide
    if hasattr(plan_stats_cuda, "form_for"):
        g = torch.Generator().manual_seed(4)
        forms = {}
        for U in (1024, 2048, 4096):
            for C in (16, 512, 1024):
                ws = torch.rand(U, generator=g).mul_(4.0).to(device)
                cnt = torch.randint(0, 5, (U,), generator=g).float().to(device)
                args = (ws, cnt, ws * cnt, *random_duals(C, device, C))
                forms[f"U={U} C={C}"] = {
                    form: device_ms(lambda: plan_stats_cuda.launch(*args, need="load",
                                                                   form=form),
                                    KERNEL_NAMES["plan_stats"])[0]
                    for form in ("cluster", "pass")}
                forms[f"U={U} C={C}"]["chosen"] = plan_stats_cuda.form_for(U, C)
        out["forms"] = forms
    k3 = out["plan_stats"]
    log(f"k36  K3 alone (load/colsum/both): " + "; ".join(
        f"config {cfg} " + " / ".join(f"{k3[cfg][need]['alone_ms']!r}"
                                      for need in ("load", "colsum", "both"))
        + f" ms, library (load/both) {k3[cfg]['library_load']['all_ops_ms']!r} / "
        f"{k3[cfg]['library_both']['all_ops_ms']!r} ms" for cfg in (2, 4))
        + "; K3 pass form (both): " + "; ".join(
            f"{shape} alone {t['alone_ms']!r} ms all ops {t['all_ops_ms']!r} ms"
            for shape, t in out["plan_stats_wide"].items())
        + f"; K6 "
        f"alone {out['state_digest']['alone_ms']!r} ms, all ops "
        f"{out['state_digest']['all_ops_ms']!r} ms, event {out['state_digest']['event_ms']!r} "
        f"ms; K5 {out['superblock_partials']!r} ms; K4 {out['mirror_prox_step']!r} ms; "
        f"K1 {out['rounds_scan']}; quality ratios {out['quality_ratio']}")
    for shape, t in out.get("forms", {}).items():
        log(f"k36  K3 forms at {shape}: cluster {t['cluster']!r} ms, pass {t['pass']!r} ms, "
            f"chosen {t['chosen']}")
    return out


def ab(mode: str, roots) -> None:
    """Run ``--{mode}-times`` for the package of each checkout in ``roots``,
    in that order, each in a process of its own that imports the package
    from that root (for example parent, change, change, parent)."""
    runs = []
    for root in roots:
        proc = subprocess.run(
            [sys.executable, "-P", os.path.abspath(__file__), f"--{mode}-times"], cwd=root,
            env={**os.environ, "PYTHONPATH": os.path.abspath(root)},
            capture_output=True, text=True, timeout=900,
        )
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            raise AssertionError(f"{mode} times of {root} exited {proc.returncode}")
        runs.append({"root": root, **json.loads(proc.stdout.strip().splitlines()[-1])})
    if mode == "wide":
        by_root = {}
        for run in runs:
            by_root.setdefault(run["root"], []).append(run)
            log(f"wide a/b  {run['root']}: " + "; ".join(
                f"{name} " + ", ".join(f"{k} {t[k]!r}" for k in (
                    "alone_ms", "event_ms", "plain_ms", "walls_ms", "all_ops_ms", "bits")
                    if k in t) for name, t in run["wide_times"].items()))
        for name in runs[0]["wide_times"]:
            # The configs' shapes, and the wide group's integer answers,
            # which no form of a kernel may change.
            control = "config" in name or name.startswith(
                ("rounds", "global", "scan", "wide stream"))
            for root, same in by_root.items():
                if len({r["wide_times"][name]["bits"] for r in same}) > 1:
                    raise AssertionError(f"wide a/b: {name} differs between runs of {root}")
            if control and len({r["wide_times"][name]["bits"] for r in runs}) > 1:
                raise AssertionError(f"wide a/b: {name} has other bits in another checkout")
        log(json.dumps({"wide_ab": runs}))
        return
    for run in runs:
        if mode in ("k1", "k7"):
            log(f"{mode} a/b  {run['root']}: " + "; ".join(
                f"{name} alone {t['alone_ms']!r} ms event {t['event_ms']!r} ms"
                + (f" plain {t['plain_ms']!r} ms" if t.get("plain_ms") is not None else "")
                + f" bits {t['bits']} {t['kernels']}"
                for name, t in run[f"{mode}_times"].items()))
        else:
            t = run["k36_times"]
            log(f"k36 a/b  {run['root']}: " + "; ".join(
                f"K3 config {cfg} load alone {t['plan_stats'][cfg]['load']['alone_ms']!r} ms "
                f"all ops {t['plan_stats'][cfg]['load']['all_ops_ms']!r} ms event "
                f"{t['plan_stats'][cfg]['load']['event_ms']!r} ms"
                for cfg in ("2", "4"))
                + "; K3 pass form (both): " + "; ".join(
                    f"{shape} alone {w['alone_ms']!r} ms all ops {w['all_ops_ms']!r} ms"
                    for shape, w in t["plan_stats_wide"].items())
                + f"; K6 alone {t['state_digest']['alone_ms']!r} ms all ops "
                f"{t['state_digest']['all_ops_ms']!r} ms event "
                f"{t['state_digest']['event_ms']!r} ms; K5 {t['superblock_partials']!r} ms; "
                f"K4 {t['mirror_prox_step']!r} ms; K1 {t['rounds_scan']}; quality ratios "
                f"{t['quality_ratio']}")
    if mode in ("k1", "k7"):
        # Every checkout computes the same function: the same bits.
        for name in runs[0][f"{mode}_times"]:
            if len({r[f"{mode}_times"][name]["bits"] for r in runs}) > 1:
                raise AssertionError(f"{mode} a/b: {name} has other bits in another checkout")
    log(json.dumps({f"{mode}_ab": runs}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script measures the "
              "port on the card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    for mode in ("k1", "k7", "k36", "wide"):
        if sys.argv[1:2] == [f"--{mode}-ab"]:
            ab(mode, sys.argv[2:])
            return 0
    name = environment()
    if sys.argv[1:] == ["--k1-times"]:
        cases = [*k1_cases(device), *k1_wide_cases(device)]
        log(json.dumps({"k1_times": k1_times(device, cases), "device": name}))
        return 0
    if sys.argv[1:] == ["--k7-times"]:
        inputs = [*k7_inputs(device), *k7_wide_inputs(device)]
        log(json.dumps({"k7_times": k7_times(device, inputs), "device": name}))
        return 0
    if sys.argv[1:] == ["--k36-times"]:
        _build.build_all()
        log(json.dumps({"k36_times": k36_times(device), "device": name}))
        return 0
    if sys.argv[1:] == ["--wide-times"]:
        log(json.dumps({"wide_times": wide_ab_times(device), "device": name}))
        return 0
    if sys.argv[1:] == ["--profiler-probe"]:
        log(json.dumps({"profiler_probe": profiler_probe(), "device": name,
                        "env": {k: os.environ.get(k) for k in ("TEARDOWN_CUPTI",)}}))
        return 0
    if sys.argv[1:] == ["--sidecar"]:
        build()
        answers = main_path(device)[1]
        launches, sidecar = sidecar_path(device, answers, StreamRun(device).run())
        log(json.dumps({"sidecar": sidecar, "launches": launches, "device": name}))
        return 0
    if sys.argv[1:] == ["--coalesce"]:
        build()
        launches, digest_err, _, report = coalesce_path(device)
        log(f"card: {CARD[0]}")
        log(json.dumps({"coalesce": report, "launches": launches,
                        "max_abs_err": digest_err, "device": name}, default=str))
        return 0
    if sys.argv[1:] == ["--sharded"]:
        build()
        launches, k5_err, report = sharded_path(device, times=True)
        log(f"card: {CARD[0]}")
        log(json.dumps({"sharded": report, "launches": launches, "max_abs_err": k5_err,
                        "device": name}, default=str))
        return 0
    if sys.argv[1:] == ["--placement"]:
        build()
        launches, err, times_, report = placement_path(device)
        log(f"card: {CARD[0]}")
        log(json.dumps({"placement": report, "launches": launches, "max_abs_err": err,
                        "device": name}, default=str))
        return 0
    if sys.argv[1:] == ["--federated"]:
        build()
        launches, err, report = federation_path(device)
        log(f"card: {CARD[0]}")
        log(json.dumps({"federation": report, "launches": launches, "max_abs_err": err,
                        "device": name}, default=str))
        return 0
    if sys.argv[1:] == ["--wide"]:
        build()
        kernels_vs_plain(device, wide_kernel_cases(np.random.default_rng(7)))
        scan_vs_plain(device, wide_only=True)
        digest_vs_plain(device, wide_only=True)
        plan_stats_vs_plain(device, wide_plan_stats_cases(device))
        linear_limits(device)
        launches, report, _ = wide_path(device)
        log(f"card: {CARD[0]}")
        log(json.dumps({"wide": report, "launches": launches, "device": name}, default=str))
        return 0
    if sys.argv[1:] == ["--wide-paths"]:
        build()
        answers = wide_path(device)[2]
        launches, errs, report = wide_paths(device, answers)
        log(f"card: {CARD[0]}")
        log(json.dumps({"wide_paths": report, "max_abs_err": errs, "device": name},
                       default=str))
        return 0
    if sys.argv[1:] == ["--takeover"]:
        build()
        launches, report = takeover_path(device)
        log(f"card: {CARD[0]}")
        log(json.dumps({"takeover": report, "device": name}, default=str))
        return 0
    if sys.argv[1:] == ["--cells"]:
        build()
        cell_times(device)
        log(f"card: {CARD[0]}")
        return 0
    if sys.argv[1:] == ["--scenarios"]:
        build()
        launches, report = scenarios_path(device)
        log(f"card: {CARD[0]}")
        log(json.dumps({"scenarios": report, "device": name}, default=str))
        return 0
    if sys.argv[1:] == ["--lifecycle"]:
        build()
        launches, lifecycle = lifecycle_path(device, StreamRun(device).run())
        log(json.dumps({"lifecycle": lifecycle, "device": name}, default=str))
        return 0
    if sys.argv[1:2] == ["--lifecycle-child"]:
        log(json.dumps({"lifecycle_child": lifecycle_child(sys.argv[2])}))
        return 0
    if sys.argv[1:2] == ["--device-share"]:
        cfg, solver, refine_iters = int(sys.argv[2]), sys.argv[3], int(sys.argv[4]) or None
        log(json.dumps({"device_share": profiled_assign(cfg, solver, refine_iters, device)}))
        return 0
    build()
    lap("1-2")
    skew = [profiler_skew("after the builds")]
    max_err = kernels_vs_plain(device)
    f32_err = quality_kernels_vs_plain(device)
    digest_err = digest_vs_plain(device)
    one_launch_a_call(device)
    bulk_refine_vs_cpu(device)
    scan_err, k7_plain_cpu_ms = scan_vs_plain(device)
    refine_batched_vs_cpu(device)
    native_vs_rounds(device)
    lap("3")
    rounds_launches, answers = main_path(device)
    lap("4a")
    launches = sinkhorn_path(device)
    lap("4b")
    stream_launches, stream_run = streaming_path(device)
    lap("4c")
    solver_launches = solver_path(device)
    lap("4d")
    ladder_launches, ladder = ladder_path(device)
    lap("4e")
    skew.append(profiler_skew("before phase 4f"))
    sidecar_launches, sidecar = sidecar_path(device, answers, stream_run)
    skew.append(profiler_skew("after phase 4f"))
    lap("4f")
    lifecycle_launches, lifecycle = lifecycle_path(device, stream_run)
    lap("4g")
    coalesce_launches, digest_rows_err, digest_rows_t, coalesce = coalesce_path(device)
    lap("4h")
    sharded_launches, k5_shard_err, sharded = sharded_path(device)
    lap("4i")
    placement_launches, shard_digest_err, shard_digest_t, placement = placement_path(
        device, coalesce["multistream_32g"]["coalesced_wave_ms"])
    lap("4j")
    federation_launches, fed_k3_err, federation = federation_path(device)
    lap("4k")
    wide_launches, wide, wide_answers = wide_path(device)
    lap("4l")
    paths_launches, paths_err, wide_paths_report = wide_paths(device, wide_answers)
    lap("4m")
    takeover_launches, takeover = takeover_path(device)
    lap("4n")
    scenario_launches, scenarios = scenarios_path(device)
    lap("4o")
    launches["rounds_scan"] += (rounds_launches + stream_launches["rounds_scan"]
                                + solver_launches["rounds_scan"]
                                + ladder_launches["rounds_scan"])
    launches["state_digest"] = (stream_launches["state_digest"]
                                + ladder_launches["state_digest"])
    launches["scan_greedy"] = solver_launches["scan_greedy"]
    for k, v in sidecar_launches.items():
        launches[k] += v
    for k, v in lifecycle_launches.items():
        launches[k] += v
    # Phase 4h: the coalesced waves' batched K6, their single-stream
    # dispatches and the dense stream paths' K1.
    for k, v in coalesce_launches.items():
        launches[k] += v
    # Phase 4i: K5 on each virtual shard, K1 in the sharded solves' tails and
    # the topic-axis backend, and the sidecar's warm epochs' K6.
    for k, v in sharded_launches.items():
        launches[k] += v
    # Phase 4j: K6's shard entry on placed states, the batched K6 a device of
    # placed waves, K5 and K1 in the placed stream's sharded cold epochs.
    # Phase 4k: K3 a federated exchange round, K1 on the local_only rung.
    # Phase 4l: K1, K7, K4, K5 and K6 at the wide group (20,000 members).
    # Phase 4m: every other path at that group: the sidecar's solvers and
    # stream, the coalescer's waves (batched K6), the sharded duals (K5 a
    # shard), the topic axis and the sharded tail (K1), the placed stream
    # (K6's shard entry) and federation (K3, K1 on the local_only rung).
    # Phase 4n: K1 in sidecar A's cold chains and the boots' warm-ups, K6's
    # single entry in the restarted dispatches and the pre-stack, its batched
    # entry in the coalesced waves.
    # Phase 4o: the scenario fleet's sidecars (K1 cold chains, K6 single and
    # batched, K3 in the federated scenario's exchanges, the mesh
    # scenario's sharded programs), skew_storm at config 5's width and the
    # tracing probe's federated join and coalesced waves.
    for k, v in (*placement_launches.items(), *federation_launches.items(),
                 *wide_launches.items(), *paths_launches.items(),
                 *takeover_launches.items(), *scenario_launches.items()):
        launches[k] += v
    f32_err["superblock_partials"] = max(f32_err["superblock_partials"], k5_shard_err,
                                         paths_err["superblock_partials"])
    f32_err["plan_stats"] = max(f32_err["plan_stats"], fed_k3_err, paths_err["plan_stats"])
    shard_digest_err = max(shard_digest_err, paths_err["state_digest_sharded"])
    digest_rows_err = max(digest_rows_err, placement["waves"]["rows_digest_err"],
                          paths_err["state_digest_rows"])
    wide_err = {k: t["max_abs_err"] for k, t in wide["times"].items() if "max_abs_err" in t}
    max_err = max(max_err, wide_err.pop("rounds_scan"))
    digest_err = max(digest_err, wide_err.pop("state_digest"))
    for k, v in wide_err.items():
        f32_err[k] = max(f32_err[k], v)
    k1 = times(device)
    quality = quality_times(device)
    digest = stream_times(stream_run)
    k7 = solver_times(device, k7_plain_cpu_ms)
    skew.append(profiler_skew("after phase 5"))
    lap("5")
    line = [dict(kernel_line("rounds_scan", launches["rounds_scan"], max_err, k1),
                 also_replaces="kafka_lag_based_assignor_tpu/ops/rounds_pallas.py:160")]
    for k, t in quality.items():
        line.append(kernel_line(k, launches[k], f32_err[k], t))
    line.append(kernel_line("state_digest", launches["state_digest"], digest_err, digest))
    line.append(kernel_line("scan_greedy", launches["scan_greedy"], scan_err, k7))
    # Phase 4l's K1 and K7 launches by leg, each named by its form, and the
    # kernel the profiler saw at that width.
    for entry in line:
        if entry["name"] in ("rounds_scan", "scan_greedy"):
            entry["wide_group_forms"] = {
                leg: [form for kernel, form in fs if kernel == entry["name"]]
                for leg, fs in wide["forms"].items()}
            entry["wide_group_kernels"] = sorted(wide["times"][entry["name"]]["by_kernel"])
            entry["wide_paths_forms"] = sorted({form for kernel, form in wide_paths_report["forms"]
                                                if kernel == entry["name"]})
    line.append(kernel_line("state_digest_rows", launches["state_digest_rows"],
                            digest_rows_err, digest_rows_t))
    line.append(kernel_line("state_digest_sharded", launches["state_digest_sharded"],
                            shard_digest_err, shard_digest_t))
    log(json.dumps({"ladder": ladder}))
    log(json.dumps({"sidecar": sidecar}))
    log(json.dumps({"lifecycle": lifecycle}, default=str))
    log(json.dumps({"coalesce": coalesce}, default=str))
    log(json.dumps({"sharded": sharded}, default=str))
    log(json.dumps({"placement": placement}, default=str))
    log(json.dumps({"federation": federation}, default=str))
    log(json.dumps({"wide": wide}, default=str))
    log(json.dumps({"wide_paths": wide_paths_report}, default=str))
    log(json.dumps({"takeover": takeover}, default=str))
    log(json.dumps({"scenarios": scenarios}, default=str))
    log(json.dumps({"profiler": {"skew": skew, "sessions": SESSIONS,
                                 "pad_s": PROFILER_PAD_S, "skew_pad_s": SKEW_PAD_S}}))
    log(json.dumps({"phases_s": PHASE_S}))
    log(f"card: {CARD[0]}")
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
