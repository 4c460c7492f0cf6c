"""Chip smoke run of the PyTorch/CUDA port (``reporter_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of the match program (one nvcc per source,
sm_90a, all started together; kernels 3-5 with their sparse
instantiations, counted apart as ``<name>[sparse]``, kernel 2 with its
wide32 one, the dedup claim and scatter kernels, the probe-outcome
counters, the log-depth Viterbi kernels and kernel 2's tiered
instantiations, the mesh's sharded probe, segment histogram and slab
kernels) and the native host core, builds the metro-scale grid city (120 x 120 blocks of 150 m, UBODT
delta 3000 m, cuckoo layout) and moves it to the card, then:

  1. holds each of kernels 1-4 against its plain PyTorch version on the
     card at both of the bucketed path's shapes (B=512, T=64 from
     TraceSynthesizer(seed=7) and B=128, T=256 from seed 8; K=8), and at
     512 x 64 times both with CUDA events beside the kernel's bound;
  2. holds kernel 5 (the chain) against its plain version at the long
     path's shape (64 x 256, the second window of 64 traces of 2,048
     points from seed 9, continuing the first window's carries) and at
     the session shape (512 x 4 against a 65,536-slot slab: continuing,
     fresh and padding rows), and times both;
  3. drives each path through the launch counters (every count set to 0
     just before, read just after): the bucketed path,
     ``SegmentMatcher(device="cuda").match_many`` over the 512 x 64 and
     128 x 256 cohorts, each held against the plain versions' composition;
     the long path, ``match_many`` over the 64 x 2,048 cohort (8 windows
     of 256), held window by window against the plain composition; the
     session path, the 512 x 64 cohort streamed as 512 sessions in 16
     steps of 4 points through ``SessionEngine`` with the session slab,
     held bit for bit against the host-carry path and against the long
     path of a matcher with 4-point windows;
  4. serves 8 /report requests, one 2,048-point /report and 8 vehicles'
     streaming submits on the metro city, then replays the 6 recorded
     /report fixtures on the 8 x 8 fixture grid under the serving
     defaults (the sparse model on) and diffs them against the recorded
     responses;
  5. the sparse-gap model, on cohorts A (every 9th point of the 512 x 64
     cohort: 512 x 8 at 45 s), B (every 12th of the 64 x 2,048 one: 64 x
     171 at 60 s) and L (16 x 512 at 60 s, seed 12): kernels 1-4 at
     K = 16 on A and B with the sparse instantiations of kernels 3 and 4,
     kernel 5's sparse instantiation at L's 16 x 256 (K = 16) and on the
     slab at 512 x 4 (K = 8), each against its plain version and the
     first of each timed; then, each through the launch counters, a
     sparse-on matcher's ``match_many`` over A and B (uncalibrated, K =
     16, and with $REPORTER_CALIBRATION = CALIBRATION.json, K = 8) held
     against the plain composition; the long path over L held window by
     window; A streamed as 512 sessions in 2 steps of 4 on host carries
     (every step sparse, equal to the sparse long path with 4-point
     windows) and on the slab (step 1 sparse, step 2 dense, as the
     reference labels a slab-carried step; equal to the plain steps); and
     8 /report of A on the serving defaults, equal to the plain
     composition;
  6. the gap-conditioned breakage where it decides (``gap_flip``): A, B
     and L, and the slab step's input, with each step's time gap scaled
     by a seeded factor in [0.5, 2] and the breakage distance and break
     speed set inside the data, so that the dense and the sparse
     thresholds disagree on steps and seams: kernels 1-4 on A and B and
     kernel 5 at L's window and on the slab, each against its plain
     version, the sparse breaks differing from the dense instantiation's.
     The session step is also held on host carries (kernel 5's
     [B]-leading mode at 512 x 4), dense and sparse;
  7. the UBODT memory system: the metro table repacked into the wide32
     layout (``relayout``); kernel 2's wide32 instantiation against its
     plain version and against the cuckoo kernel on the same keys, and
     the deduplicated probe (claim, kernel 2 over the distinct keys,
     scatter) against the plain full-width probe in both layouts, at 512
     x 64, 128 x 256, the session step's 512 x 4, the long cohort's
     chunk-major pre input (512 windows of 256) and A at K = 16; an
     all-distinct key set that forces the full-width fallback on the
     card; kernel 5's wide32 seam, dense (64 x 256, the slab) and sparse
     (L's window, the slab); ``probe_stats`` against its plain version
     in both layouts and on A with a 400 m table (beyond-delta misses);
     each new kernel and the end-to-end dedup probe timed at 512 x 64
     beside kernel 2 alone, ``torch.unique`` as the claim's yardstick;
     then, through the launch counters, a wide32 + dedup matcher that
     samples the probe diagnostic on every dense dispatch over the
     bucketed, long and sparse A paths, each output equal to the cuckoo
     matcher's without dedup and to the plain composition, and the 8
     /report of A and the fixture replay under
     $REPORTER_UBODT_LAYOUT=wide32 $REPORTER_PROBE_DEDUP=1 answering as
     under the defaults;
  8. the log-depth (assoc) forward: ``viterbi_assoc`` against its plain
     version at 512 x 64, 128 x 256 and the session step's 512 x 4, its
     sparse instantiation on A and B and their ``gap_flip`` inputs,
     ``viterbi_chain_assoc`` at the long window and on the slab, its
     sparse instantiation at L's window and on the slab (also flipped),
     each timed beside the scan or chain kernel on the same inputs, and
     the crossover (both forwards at T = 16, 64, 256, K = 8 and 16); then,
     through the launch counters, a matcher with ``viterbi_kernel="assoc"``
     over the bucketed, long, session (128 sessions x 4 steps) and sparse
     A and L paths (no scan or chain kernel launched; outputs equal to the
     plain composition of the assoc forward), the count of traces each
     path decodes otherwise than the scan matcher, an ``"auto"`` matcher
     (the scan at 512 x 64, the assoc kernels at 128 x 256 and on the
     long windows), and 8 /report plus the fixture replay under
     $REPORTER_VITERBI=assoc.
  9. the tiered UBODT (hot arena on the card, the table's pages
     page-locked in host memory and read in place): the host link's peak
     (its PCIe generation and width as nvidia-smi reads them) beside its
     measured rate (a timed pinned -> device copy of 256 MiB); for each
     layout, at a 1-byte budget (every row cold), 64 MiB after one
     maintenance pass on the 512 x 64 cohort's own probes (about half its
     rows hot; the pass timed, and a second one) and the table's size
     (every row hot): the memory check (the tier's device
     allocations at most its arena, slot map and counters + 1 MiB, the
     pages page-locked host memory), kernel 2's ``[tiered]``
     instantiation, the dedup probe and its forced fallback against their
     plain versions and the untiered probe, bit for bit, with equal
     per-bucket fetch counts and hit/miss totals, the probe's staging of
     cold rows (``ubodt_cold_mark``, ``ubodt_cold_gather``) against the
     plain twin ``stage_plain``: its staged set in the twin's, its staged
     rows equal to their pages, its staged plus in-place rows (the
     overflow, printed) equal to the distinct cold rows the probe reads,
     the chain kernels' seams (scan and assoc, dense and sparse, long
     window and slab) the same way, and the tiered kernel timed beside the untiered one (with
     every row cold, the dedup probe too, and kernel 2 on two more key
     sets of the cohort's size, one that repeats no row within reach of
     a cache and one that repeats 256 keys: what caches serve of cold
     rows); then, through the launch
     counters, matchers at the 64 MiB budget over the bucketed, long,
     session, sparse A and L, assoc and wide32 + dedup paths, each output
     equal to the untiered matcher's; the 512 sessions through a slab of
     128 hot slots over 256 pinned host pages (promotion, demotion and
     spill) equal to the host-carry path; 8 /report and the fixture
     replay under $REPORTER_UBODT_HOT_BYTES equal to the untiered answers.
  10. the device mesh, every rank on this card (explicit device lists):
     kernel 2's bucket-range instantiation ``ubodt_probe[sharded]`` (and
     ``[wide32,sharded]``) at gp 2, 4 and 8 on the 512 x 64 cohort's keys,
     each rank against its plain version and the ranks' pmin / pmax
     against the untiered kernel 2, bit for bit, one rank of gp 4 timed;
     the chain kernels reading a seam resolved over 4 gp ranks against
     their in-kernel probe, bit for bit (scan and assoc, dense at 64 x 256
     and 512 x 4, sparse at L's window and 512 x 4); kernel 4's
     chosen-slot output against the plain decode and
     ``segment_histogram`` against its plain version at 512 x 64 and 128
     x 256 (counts exact, sums within rtol 1e-5), timed at both, at 512
     x 64 beside four ``index_add_`` calls; ``slab_gather_owned`` /
     ``slab_scatter_owned`` at dp 2 and 4 against their plain versions
     and the single slab, bit
     for bit (timed at rank 0 of dp 2 and 4, K = 8; of dp 2 at K = 16
     and at B = 4,096); then, through the launch counters, a dp2 and a
     dp2 x gp4 matcher over the bucketed, long and sparse A paths (and
     wide32 on gp4), and 512 sessions x 4 steps on the slot-sharded slab with
     evictions mid-stream, each answer equal to one card's;
     ``graph_sharded_match_fn`` on dp2 x gp4 against
     ``match_and_histogram``; 8 /report and the fixture replay under
     $REPORTER_DEVICES=2, then $REPORTER_DEVICES=8
     $REPORTER_GRAPH_DEVICES=4, equal to one card's.
  11. the redesigned kernels on edge inputs (``probe_edges``,
     ``recursion_edges``): kernel 2's family on a ragged key set of table
     rows, the empty marker's key (-1, 0) (several hits a row), keys that
     miss and the cohort's keys, on the cuckoo and wide32 tables,
     untiered, tiered at 64 MiB and every rank of gp 4, each equal to its
     plain version with equal fetch counts, ``n_live`` at 0, 3,001 and
     past the key count writing exactly the live outputs, the dedup
     probe's fallback and compact probe exact; kernels 4 and 5 in every
     instantiation (K = 1, 2, 4, 8, 16, 32, carried or not, dense or
     sparse) at B = 1, 16 and 512 rows (and 64, 256: every block size of
     their launch), and on 16 rows with x legs of NaN beside y legs of 0
     (in the windows and at the seam), each equal to its plain version.
  12. the redesigned sweep and transition build on edge inputs
     (``sweep_edges``, ``build_edges``, ``design_shapes``): kernel 1 at
     every K of 1-32 on the metro city (cap 8) and at K = 1, 2, 8, 16, 32
     on grid cities whose cells hold 2, 24 and 56 items, over nodes (ties),
     block centres (all miss), points beyond the borders, on cell lines,
     near roads, points whose x is NaN beside a node's y and invalid
     points, full and packed; kernel 3, dense and sparse, at K = 1, 2, 4,
     8, 16, 32 (and 3, 24) and B x T in {1, 16, 512} x {2, 3, 64, 2048}
     on synthetic candidates (same-edge forward, jitter and loop pairs,
     empty slots, dt <= 0, headings at +-pi and beyond, x legs of NaN
     beside y legs of 0) and probe results (finite, 0, +inf): each equal
     to its plain version bit for bit; both timed at 512 x 64, 128 x 256,
     64 x 2,048 (K = 8) and A's 512 x 16 (K = 16), kernel 1 also on each
     cap.
  13. the redesigned log-depth forward and dedup claim on edge inputs
     (``assoc_edges``, ``claim_edges``): every instantiation <K, CARRY,
     SPARSE> of the assoc template at K = 1, 2, 4, 8, 16, 32 and T = 2, 3,
     17, 64, 256 on rows that restart, break at step 0, break at every
     step, break for a dead source, end in padding or are all padding,
     tie, or never break, with a NaN gc at a few steps, fresh and
     continuing live carries of the long cohort (x legs of NaN beside y
     legs of 0 at the seam; on a 64-slot slab too: rows with ``use``
     false, padding rows), the seam tiered (equal fetch counts) and
     resolved over a gp-4 view; the claim on key runs with (-1, -1) keys, all keys equal, all
     (-1, -1) and all distinct past the budget, in both layouts and in
     count mode: each equal to its plain version (packed and carry bit for
     bit, aux rtol 1e-4; distinct counts exact).
  14. the redesigned slab kernels (row 11c) on edge inputs
     (``slab_edges``): at K = 1, 2, 3, 4, 7, 8, 9, 16, 27, 32, B = 1, 7,
     33, 512, 4,096 and dp 1, 2, 4, 8, on slot maps whose live rows are
     all rank 0's, all other ranks', none (all padding), anywhere, or the
     boundary slots of every shard, over a slab with -0.0 and NaN payloads
     in every float leaf (and shards that are views one row into their
     storage): each rank's gather and scatter equal their plain versions
     bit for bit, the psum of the gathers is the slab's rows and the
     scattered slab has exactly its live rows written; then one
     ``session_step_arena_mesh`` at dp 2 and 4 (512 x 4 on the 65,536-slot
     slab) equal to the single-slab step and timed whole and in its parts
     (``mesh_step_split``).  The slab kernels are also timed in phase 10
     at dp 4, at K = 16 and at B = 4,096.
  15. the redesigned dedup scatter (row 8b's) and probe-outcome counters
     (row 12) on edge inputs and at the main path's shapes
     (``scatter_edges``, ``stats_edges``, ``redesign_shapes``): the
     scatter launch at n = 1, 3, 5, 1,023, 1,025, 4,097 and 2,064,383 keys
     (n % 4 != 0: the scalar tail) within the budget and past it (the
     fused full-width probe), both layouts, with and without first_edge,
     equal to the plain probe bit for bit; ``probe_outcomes`` at K = 1, 2,
     3, 4, 6, 8, 12, 16, 32 (both kernels: a warp a step, a lane 4 pairs
     where K % 4 == 0) and B x T from 0 x 2 and 1 x 1 (nothing launched) and 3 x
     2 (fewer steps than the grid's warps) to 512 x 65, on dist with +-inf
     and NaN, same-edge and negative candidates, invalid points, gaps
     exactly at the breakage distance and delta and x legs of NaN beside
     y legs of 0, counts and need mask equal to the plain version's bit
     for bit; then both timed (and so paired
     under ``--pair``): the scatter at 512 x 64 on the cuckoo table, 128 x
     256 in both layouts and cohort A (512 x 16, K = 16) on the 400 m
     table, ``probe_stats`` at 512 x 64 on the wide32 probe's dist, 128 x
     256 and A on the 400 m table.  The scatter is also timed on the
     all-distinct keys past the budget (``dedup_fallback``) and on the
     tiered table at 64 MiB (``tier_kernel_phases``, its (0, 0) tail
     count compared across trees), and at 512 x 64 beside its closest
     PyTorch composition (``memory_phases``: three calls).
  16. the redesigned segment histogram (row 11b) on edge inputs
     (``histogram_edges``): T = 1, 2, 31, 32, 33, 64, 255, 256, 257 and
     2,048 (a warp a chunk of 64 points, one to four warps a row, at T
     <= 256, a block a row past it), B = 0 (nothing launched), 1, 7, 64,
     20,000
     (more rows than the persistent grid's warps), K = 1, 2, 4, 8, rows
     unmatched, on one segment, re-entering segments, broken at every
     step, with route entries of +-inf, NaN, 0 and -0.0 and chosen edges
     whose segment is -1 or outside [0, S), and S = 4 (every row's adds
     on four bins): counts bit for bit, sums within rtol 1e-5.

  17. the bench's realistic OSM city (``osm_phases``, after phase 4):
     ``realistic_city_network(120, 120, spacing_m=150, seed=3)`` through
     the PBF round trip, cell_size 100, the native cuckoo UBODT at delta
     3,000 m (14,390 nodes, 49,926 edges, a grid_items cap of 20,
     10,711,548 rows, 536.9 MB: checked), and bench.py's cohorts from one
     TraceSynthesizer(seed=7): 512 x 64, 128 x 256, 16 x 1,024.  Kernels
     1-4 against their plain versions at 512 x 64 (timed) and 128 x 256,
     kernel 5 at the long window (16 x 256) and the serving slab; the
     bucketed, long (four windows of 256) and session (16 steps of 4)
     paths through the launch counters, each held as on the grid city;
     ``probe_stats`` (kernel 12) against its plain version on the 512 x 64
     batch, its hits, misses and beyond-delta misses printed beside the
     grid city's; segment agreement against the truth per cohort; the
     first 100 short traces on the card, on the CPU baseline
     (``backend="cpu"``) and on the port with ``device="cpu"``: the card
     must part from the baseline on exactly the traces where the port on
     the CPU does (``baseline_phase``); and the city's PBF imported by
     ``python -m reporter_tpu_torch.tiles.osm --json`` in a process of its
     own, 8 /report served from that network through
     ``parse_service_config`` and ``build_matcher`` with the serving
     defaults, each equal to ``match_many`` on a second matcher of the
     same config.  Kernels 1-5 carry the city's times, bounds and launches
     under ``"osm"`` in the kernels line.
  18. the batch request and its wire on the same city (``wire_phase``):
     the OSM CLI's one call also writes the RPTT tiles (``-o``), which
     ``load_network_tiles`` must read back to the ``--json`` network (its
     edges in the tiles' order); a ``{"network": {"type": "tiles"}}``
     config through ``parse_service_config``, ``build_matcher`` and the
     serving defaults to a matcher on the card, served with the default
     ``max_inflight`` (4 on the card); one /trace_attributes_batch body of
     64 traces of the 512 x 64 cohort, 8 of the 128 x 256 and one of the
     16 x 1,024 (the long path) sent as JSON, gzip JSON, binary in and out,
     and binary in with JSON out, and one binary /report, three rounds of
     each, every send through the launch counters (kernels 1-5; the
     /report's 64 points kernels 1-4): every answer a 200, each binary one
     under the wire's Content-Type, the four decoded result lists equal to
     each other and to ``report()`` over ``match_many`` on a second matcher
     of the same config; the same body under ``X-Reporter-Deadline-Ms: 0``
     answered 504 with no kernel launched.  Each encoding's body bytes and
     request wall (the median of its three) are printed beside the card's
     name and power limit.
  19. service recovery on the same city and its tiles config with the
     serving defaults (``recovery_phase``, after phase 18), every send
     of this process through the launch counters, the fault variables set
     and cleared in this process: (1) faults off, 8 /report and one
     /trace_attributes_batch equal report() over match_many on a second
     matcher, no fault fired, no trip, nothing degraded; (2)
     REPORTER_FAULT_DISPATCH=uuid:poison-veh with quarantine_after 2 and
     150 ms windows: 8 concurrent /report, the poison 500 "failed its
     device batch alone", the 7 innocents equal the second matcher's with
     kernels 1-4 launched by the bisect, twice, then the poison refused
     422 with no launch; the same for streaming submits on the slab; (3)
     REPORTER_FAULT_DEVICE_HANG=2.5:1 with watchdog_s 0.4 and
     reattach_probe_s 0.25 (REPORTER_FAULT_DISPATCH=uuid:_warmup holds the
     re-attach probe off meanwhile): /report and a binary
     /trace_attributes_batch answer 200 degraded, equal to report() over
     the CPU baseline, 16 streaming vehicles 200 degraded, /health
     degraded; cleared, the service re-attaches within 20 s, answers on
     the card equal to the second matcher, and each session rebuilds once
     from its replay (equal to the windowed decode, points_total exact);
     then a finish that queues a 2.5 s ``torch.cuda._sleep`` before its
     fetch: the watchdog trips while the finisher blocks in the CUDA
     copy; (4) 512 sessions of the 512 x 64 cohort, 16 steps of 4 on the
     slab, handed after step 8 from service A to service B on the second
     matcher by GET /sessions?export=1 + POST /sessions, by POST {"pop"}
     and by a sync checkpoint directory (``read_checkpoints``): steps 9-16
     on B equal the uninterrupted run's answers and records bit for bit;
     (5) ``python -m reporter_tpu_torch.serve`` on the tiles config in a
     process of its own, once its deferred engine has attached (/health
     names the backend): SIGTERM with a 16 x 1,024 /trace_attributes_batch
     inflight, which answers 200 equal to the second matcher, while a new
     /report and /health answer 503 "draining"; the process exits 0.  It
     prints each step's wall, the degraded answers' wall beside the card's,
     the re-attach time, the handoff's bytes and times and the drain's time
     to exit.  Every other phase is checked to run with no fault fired, no
     trip and nothing degraded (``quiet``).
  20. the serving process's observability on the same served matcher
     (``observability_phase``, after phase 19): (1) 16 /report, one binary
     /trace_attributes_batch of 24 traces, 8 streaming vehicles x 4
     submits and one /report poisoned by REPORTER_FAULT_DISPATCH, each
     with its X-Reporter-Trace, echoed: /metrics parses and holds every
     family the package registers with its labels, its request, trace,
     point and dispatch counts equal the traffic and the launch
     counters' deltas (``reporter_kernel_launches_total`` each kernel's), /statusz has the JAX package's keys,
     /debug/traces holds every trace id sent (the poisoned one by right),
     /debug/slo counts the requests, the device memory gauge reads at
     least the 536.9 MB table; (2) GET /debug/attrib?capture=1&reps=3:
     the profiler sees every launch of every kernel of its path under its
     stage label, each label above 0 s; a capture of match_many over the
     512 x 64 cohort prints each kernel's device time a launch beside
     phase 17's CUDA-event time and the (unattributed) share; a capture
     during another answers 409; /debug/profile?seconds=1 over live
     traffic parses, with every path kernel under its label and nothing
     unattributed; (3) REPORTER_QUALITY_SAMPLE_EVERY=4 for one service:
     16 /report (``QUALITY_REQUESTS``), the shadow-oracle agreement per
     cohort equal to the
     port's on the CPU; (4) match_many over the 512 x 64 cohort with the
     stage ranges off and on (``attrib.set_scopes``), bit-identical, eight
     rounds of off, on, on, off: each side's median wall and quartiles,
     and a range's own cost times the ranges a call opens.

  21. the batched and streaming modes on the same city (``modes_phase``,
     after phase 20), on phase 17's matcher: (1) the batch pipeline in
     process, ``run_pipeline`` over an archive of the first quarters of the
     512 x 64 and 16 x 1,024 cohorts (128 x 64 and 4 x 1,024, 4 source
     files; vehicles 0-15 pause 300 s after their 32nd point: 148 windows at
     the 120 s inactivity; ``MODES_BATCH_DEPTH``), phases 1 and 3 on two
     spawned workers, micro-batches of 256, privacy 2, hourly tiles: 0
     failures, every window matched, kernels 1-5 launched, its tiles equal
     by path and sorted rows to the same pipeline's on the port on the CPU
     (resumed from the card run's shards), the CPU baseline's share of
     equal rows printed; (2) ``python -m reporter_tpu_torch.batch --device
     cuda --warmup --metrics`` in a process of its own on the city's
     ``file`` config: exit 0, the same tiles, its metrics line counting the
     148 windows; (3) the 512 x 64 cohort as SV lines in time order through
     the stream topology (micro-batches of 16, privacy 2, hourly tiles,
     every line stamped with one arrival instant): ``LocalMatcherClient``
     on the card, equal to it on the port on the CPU, ``HttpMatcherClient``
     against a ReporterService on the card matcher, ``python -m
     reporter_tpu_torch.stream`` fed the lines on stdin against that
     server, and a checkpoint after half of the lines restored into a
     fresh pipeline fed the rest, each with the card's tiles.  It prints
     each run's wall and points/s, the batch's three phase walls and the
     launches.
  22. the serving fleet on the same city (``fleet_phase``, after phase
     21): ``python -m reporter_tpu_torch.tools.fleet --replicas 2 --warmup
     --session-checkpoint 0.5 --session-checkpoint-sync --device cuda`` on
     phase 18's tiles config, its own workdir (build/fleet) and free
     ports, up once the router's /fleet shows both replicas healthy and
     each /health attached and warmed; (1) the 512 x 64 cohort as /report
     through the router (32 threads) and one binary
     /trace_attributes_batch of 73 traces, each answer equal to the same
     request to phase 18's second matcher behind a ReporterService in this
     process (the frame byte for byte), every uuid on its rendezvous
     primary with a stable X-Reporter-Replica, both replicas serving; 64
     /report timed through the router and direct; (2) 128 streaming
     vehicles x 4 submits of 4 points, every answer (here and after) equal
     to an uninterrupted in-process session's; (3) SIGKILL of the replica
     holding the most sessions under a windowed load: no client error but
     a shed, the supervisor's ``rehome`` line in scale_events.jsonl, the
     router's GET /sessions back to the exact answered-point total, the
     re-homed vehicles' next answers from the survivor, one respawn (the
     victim's), the rebalance moving them back; (4) SIGUSR1: one rolling
     restart under load, zero non-shed errors, one restart a replica; (5)
     SIGTTIN: a --warmup replica held out of the ring until its /health
     reports it attached, admitted, serving; SIGTTOU: it drains away (exit
     0); (6) SIGTERM: the supervisor and every child exit 0.  Kernels 1-5
     must launch on every replica that served, read as deltas of
     ``reporter_kernel_launches_total`` on the router's federated
     /metrics; no replica degraded or off the card.  It prints each
     replica's boot-to-healthy and warm walls and device bytes, the
     router and direct /report walls, the failover, re-home, respawn,
     rolling-restart and scale walls.

  23. the tiered UBODT on a gp mesh (kernel rows 10 x 11a,
     ``mesh_tier_kernels``, ``mesh_tier_paths``): kernel 2's
     ``[tiered,sharded]`` and ``[wide32,tiered,sharded]`` instantiations at
     gp 2 and 4, at 1 byte, 64 MiB (as seeded, and after one maintenance
     pass) and a whole range a rank, on the 512 x 64 cohort's keys: every
     rank against its plain version with its own fetch counts and its
     staging checked as in phase 9, the ranks' pmin / pmax against the
     untiered kernel 2, bit for bit, the pages registered with CUDA once;
     rank 0 of gp 4 timed, and its mark and gather alone; then a dp2 x gp4
     tiered matcher (64 MiB a rank, every rank on this card) over the
     bucketed, long, session-slab and sparse A paths (and wide32 at 512 x
     64), each answer equal to the untiered card's, before and after a
     maintenance pass.
  24. the multi-controller entry point (``multihost_phase``): ``python -m
     reporter_tpu_torch.parallel.multihost --device cuda`` under NCCL at
     world size 1 (gp 1 and 2) and in two processes under gloo (gp 1 and
     2), each config's line byte-identical across its processes and equal
     to the in-process mesh's on the same global batch, kernels 1-4
     launched in every process; two NCCL processes on the one card exit 2
     with the one-rank-a-GPU message.
  25. the reference's default host plane and the per-window carry
     program (``host_plane_phase``), on the grid and phase 17's realistic
     city: the columnar pack (``extract_columns`` + ``_fill_rows(cols=)``)
     equal to the legacy loop bit for bit, times included, at 512 x 64,
     128 x 256, 64 x 2,048 and on 256 traces cut to lengths 1-16 with
     int, float and mixed times, both timed; ``match_many`` with
     host_pack on and off, equal wire on the bucketed and long paths, and
     a 512-session x 4-point slab step through ``match_sessions``, equal
     output, aux and beams; ``build_records`` against the Python loop on
     the 512 x 64 and 128 x 256 association columns, byte for byte
     through json.dumps, both timed; 64 of the realistic city's 512 x 64
     as one RPTC /trace_attributes_batch and as JSON through the port's
     server, equal answers, the binary one packed from the side channel
     with no point dict walked, no ``_columns`` in any body or
     /debug/traces; the 64 x 2,048 and realistic 16 x 1,024 cohorts
     through ``long_precompute=False`` matchers under scan and assoc,
     through the launch counters: wire and compact output (every seam
     column) equal to the hoisted path's, kernels 1-3 and the chain
     kernel once a window, no pre dispatch.  Every association call of
     the phase must take the records extension.  It prints each wall
     beside the card's name and power limit.

Phase 0 builds the kernels, the native core and the records extension
(``native/records_ext.c`` with gcc against the interpreter's headers: a
machine without them fails here with the compiler's message) and the
cities; the breakdowns of phase 3 time the columnar pack beside the
legacy loop (equal bit for bit) and check that association took the
records extension.  The cohorts are synthesized
during the build in worker processes (``prefetch_cohorts``: the same seeds and
code, so the same traces, each checked to come from the same city).
Before the phases it times ``torch.cuda._sleep(1)``, a one-thread kernel,
under ``time_ms`` (``launch_floor``): the least time that timer reads for
a launch, printed as ``floor_ms`` and written beside the kernels' list.
Each phase prints ``phase <n>: <wall> s`` when it ends; an exception in a
phase prints ``chip_smoke: failed in phase <n> after <s> s: <message>``
on stdout, writes what build/chip_smoke.json has so far (the finished
phases' walls, the failure and its traceback) and exits non-zero.

    python3 chip_smoke.py --pair PARENT [TREE ...]

runs the same phases and also times every kernel call the phases time
against the kernels built from other checkouts, the parent first, in one
process: each build's SASS instruction counts (``cuobjdump``), then each
call timed in turns (the trees, this tree twice, the trees in reverse),
its outputs and a tiered table's fetch counts equal across the builds bit
for bit; writes chiprun_out/pair.json (``pair_setup``, ``_paired``).

    python3 chip_smoke.py --tier [--pair PARENT ...]

runs only phase 0's build and city and the kernel checks and times of
phases 9 and 23 (``tier_focus``; chiprun_out/tier_focus.json).

Prints the card's name and power limit, one line per phase, a
``{"kernels": [...], "floor_ms": ...}`` line, and as its last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without CUDA it exits non-zero before printing any result.  Details go to
build/chip_smoke.json.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

# published H100 SXM peaks the bounds are taken against: HBM bytes/s, and
# float32 operations/s outside the tensor cores (every kernel here is
# scalar float32/int32 work)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
REPO = os.path.dirname(os.path.abspath(__file__))


def check(cond, msg):
    if not cond:
        raise RuntimeError("check failed: " + msg)


# the run so far: each finished phase's wall, and a failure (``phase``)
_RUN = {"t0": time.perf_counter(), "phases": {}, "failed": None}


def _write_report(report):
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)


@contextlib.contextmanager
def phase(label):
    """Run one phase: print ``phase <label>: <wall> s`` when it ends.  An
    exception in it prints ``chip_smoke: failed in phase <label> after <s>
    s: <message>`` on stdout (once: an enclosing phase passes it on),
    writes what build/chip_smoke.json has so far (every finished phase's
    wall, the failure and its traceback) and propagates: the run still
    exits non-zero."""
    t0 = time.perf_counter()
    try:
        yield
    except BaseException as e:
        if not getattr(e, "_chip_smoke_phase", None):
            import traceback

            dt = time.perf_counter() - t0
            msg = " ".join(("%s: %s" % (type(e).__name__, e)).split())
            _RUN["failed"] = {"phase": label, "after_s": dt, "message": msg,
                              "traceback": traceback.format_exc()}
            print("chip_smoke: failed in phase %s after %.1f s: %s" % (label, dt, msg),
                  flush=True)
            _write_report({"phases": _RUN["phases"], "failed": _RUN["failed"],
                           "wall_s": time.perf_counter() - _RUN["t0"]})
            try:
                e._chip_smoke_phase = label
            except AttributeError:
                pass
        raise
    dt = time.perf_counter() - t0
    _RUN["phases"][label] = dt
    print("phase %s: %.1f s" % (label, dt), flush=True)


_FLUSH = []
# --pair: {tree tag: {kernel name: Kernel of that tree's build}}, and what
# the paired timings found (``_paired``)
_PAIR = {}
_PAIRED = {"sass": {}, "cases": {}}


def time_ms(fn, reps=20, warmup=3, cold_l2=False, queued=True, prep=None, label=None,
            tier=None, same=None):
    """Median device time of one call of ``fn`` over ``reps`` calls, in ms,
    from CUDA events.  Under ``--pair`` a call with a ``label`` (a kernel's
    call) is timed against the other trees' builds too (``_paired``).

    With ``queued`` the calls are enqueued behind a spin kernel, so the
    host's work in each call (output allocation, argument checks, the
    ctypes call) runs while the card spins and none of it lands between
    the events; the spin is lengthened until the card is still spinning
    when the last call has been enqueued.  Without ``cold_l2`` the calls
    run back to back with an event between each two.  With it, a write of
    a 256 MB buffer (five times the L2) precedes each call and an event
    pair brackets the call alone, for a kernel whose main-path inputs are
    cold in L2.  ``queued=False`` (the plain versions, whose many small
    ops are launch-bound on the host) lets the host's gaps count, as they
    do for a caller.  ``prep`` (a call that restores what ``fn`` changes,
    such as a slab step's slab) runs before each call, outside its event
    pair, so that every timed call starts from the same state.  ``same``
    (default: bit for bit) compares two trees' outputs under ``--pair``."""
    kw = dict(reps=reps, warmup=warmup, cold_l2=cold_l2, queued=queued, prep=prep)
    return _paired(fn, label, tier, kw, same) if _PAIR and label else _median_ms(fn, **kw)


def _median_ms(fn, reps, warmup, cold_l2, queued, prep):
    """``time_ms`` of this tree's build."""
    import torch

    if cold_l2 and not _FLUSH:
        _FLUSH.append(torch.empty(64 << 20, dtype=torch.int32, device="cuda"))
    for _ in range(warmup):
        if prep is not None:
            prep()
        fn()
    torch.cuda.synchronize()
    cycles = 50_000_000  # ~25 ms at the H100's clock
    for _attempt in range(4):
        if queued:
            torch.cuda._sleep(cycles)
        spun = torch.cuda.Event()
        spun.record()
        if cold_l2 or prep is not None:
            pairs = [(torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
            for a, b in pairs:
                if cold_l2:
                    _FLUSH[0].zero_()
                if prep is not None:
                    prep()
                a.record()
                fn()
                b.record()
        else:
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
            marks[0].record()
            for m in marks[1:]:
                fn()
                m.record()
            pairs = list(zip(marks, marks[1:]))
        ahead = not spun.query()
        torch.cuda.synchronize()
        if ahead or not queued:
            return statistics.median(a.elapsed_time(b) for a, b in pairs)
        cycles *= 4
    raise RuntimeError("timing: the host did not get ahead of the card")


def _paired(fn, label, tier, kw, same=None):
    """``time_ms`` under ``--pair``: the outputs of ``fn`` (from the state
    ``prep`` restores) under each other tree's kernels equal this tree's
    (bit for bit, or by ``same``) where this tree's two calls agree (a
    claim's order may not), and with ``tier`` so do the fetch counts and
    hit/miss totals;
    then the builds are timed in turns (the trees, this tree twice, the
    trees in reverse).  Records the case under ``label`` in ``_PAIRED``
    and returns this tree's mean."""
    prep = kw["prep"]

    def call():
        if prep is not None:
            prep()
        return fn()
    want, dk = _tier_delta(tier, call)
    same = same or _outputs_equal
    steady = same(want, call())
    for tag, ks in _PAIR.items():
        with design(ks):
            got, dp = _tier_delta(tier, call)
        check(not steady or same(got, want),
              "%s: %s's kernels give this tree's outputs bit for bit" % (label, tag))
        _same_fetches(dk, dp, "%s against %s" % (label, tag))
    builds = dict(_PAIR, change={})
    t = {}
    for tag in list(_PAIR) + ["change", "change"] + list(_PAIR)[::-1]:
        with design(builds[tag]):
            t.setdefault(tag, []).append(_median_ms(fn, **kw))
    mine = statistics.mean(t["change"])
    ratio = {tag: mine / statistics.mean(t[tag]) for tag in _PAIR}
    key, i = label, 2
    while key in _PAIRED["cases"]:
        key, i = "%s #%d" % (label, i), i + 1
    _PAIRED["cases"][key] = {"ms": t, "ratio": ratio, "outputs_compared": steady}
    print("pair %-56s %s  change/%s, outputs %s" % (key, "  ".join(
        "%s %s" % (tag, " ".join("%.4f" % x for x in v)) for tag, v in t.items()),
        " ".join("%s %.3f" % kv for kv in ratio.items()),
        "equal" if steady else "vary between calls: not compared"))
    return mine


def max_abs_err(pairs):
    """Largest |kernel - plain| over every output (equal entries, infinities
    included, count 0)."""
    import torch

    worst = 0.0
    for a, b in pairs:
        d = (a.double() - b.double()).abs()
        d = torch.where(a == b, torch.zeros_like(d), d)
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst


def bound(nbytes, nops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = nops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build():
    from reporter_tpu_torch import native
    from reporter_tpu_torch._build import build_all
    from reporter_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    out = build_all({**_kernels.build_jobs(), **native.build_jobs()})
    _kernels.build_kernels()  # binds (nothing stale left to build)
    native.require_lib()
    # the records extension: a machine without the interpreter's headers
    # fails here with the compiler's message, never runs on in Python
    native.require_records_ext()
    dt = time.perf_counter() - t0
    print("build: %d libraries in %.1f s (nvcc sm_90a + g++ + gcc, in parallel)"
          % (len(out), dt))
    for lib, text in sorted(out.items()):
        regs = ptxas_report(text)
        if regs:
            _RUN.setdefault("ptxas", {})[os.path.basename(lib)] = regs
            print("  %s: %s" % (os.path.basename(lib), regs))
    return dt


def _short_names(mangled):
    """Each kernel function's name with its template arguments, without
    its parameters (c++filt where it is found, else as given)."""
    import re

    try:
        names = subprocess.run(["c++filt"], input="\n".join(mangled), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
    except FileNotFoundError:
        names = []
    if len(names) != len(mangled):
        names = list(mangled)
    out = []
    for nm in names:
        m = re.search(r"(\w+(?:<[^()]*>)?)\(", nm)  # the kernel and its template arguments
        out.append(m.group(1) if m else nm)
    return out


def ptxas_report(text):
    """"function: Used N registers, ..." for each kernel function that an
    ``nvcc -Xptxas -v`` output compiled."""
    import re

    names, regs = [], []
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            names.append(m.group(1))
        elif "registers" in ln and len(regs) < len(names):
            regs.append(ln.split("ptxas info    :")[-1].strip())
    return "; ".join("%s: %s" % kv for kv in zip(_short_names(names[:len(regs)]), regs))


def metro_city(rows, device):
    from reporter_tpu_torch import native
    from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
    from reporter_tpu_torch.tiles.arrays import build_graph_arrays
    from reporter_tpu_torch.tiles.network import grid_city
    from reporter_tpu_torch.tiles.ubodt import build_ubodt

    t0 = time.perf_counter()
    arrays = build_graph_arrays(grid_city(rows, rows, spacing_m=150.0), cell_size=100.0)
    t1 = time.perf_counter()
    lib = native.require_lib() if device.type == "cuda" else None
    ubodt = build_ubodt(arrays, delta=3000.0, lib=lib)
    t2 = time.perf_counter()
    matcher = SegmentMatcher(arrays=arrays, ubodt=ubodt,
                             config=MatcherConfig(quality_aux=True), device=device)
    t3 = time.perf_counter()
    info = {
        "grid": "%dx%d blocks of 150 m" % (rows, rows),
        "nodes": arrays.num_nodes, "edges": arrays.num_edges,
        "cell_rows_cap": int(arrays.grid_items.shape[1]),
        "ubodt_rows": int(ubodt.num_rows), "ubodt_buckets": int(ubodt.n_buckets),
        "ubodt_mb": ubodt.packed.nbytes / 1e6,
        "graph_s": t1 - t0, "ubodt_s": t2 - t1, "to_device_s": t3 - t2,
    }
    print("metro city: %(grid)s, %(nodes)d nodes, %(edges)d edges, UBODT "
          "%(ubodt_rows)d rows in %(ubodt_buckets)d buckets = %(ubodt_mb).1f MB "
          "(graph %(graph_s).1f s, ubodt %(ubodt_s).1f s, to card "
          "%(to_device_s).1f s)" % info)
    return matcher, info


# the cohorts the run synthesizes: (city, seed, n, T, dt), the osm city's
# three from one synthesizer as one job
COHORTS = (("grid", 9, 64, 2048, 5.0), ("grid", 7, 512, 64, 5.0),
           ("osm", 7, 0, 0, 5.0), ("grid", 12, 16, 512, 60.0), ("grid", 8, 128, 256, 5.0))
_COHORT_JOBS = {}  # key -> Future of (arrays digest, cohort, seconds)


def _digest(arrays):
    """A digest of the graph arrays a synthesizer walks."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for name in ("node_x", "node_y", "edge_from", "edge_to", "edge_len", "edge_speed",
                 "out_start", "out_edges", "edge_seg"):
        h.update(np.ascontiguousarray(getattr(arrays, name)).tobytes())
    return h.hexdigest()


def _city_arrays(kind):
    """The graph arrays of the metro grid city or the osm city, built as
    ``metro_city`` and ``osm_city`` build them."""
    from reporter_tpu_torch.tiles.arrays import build_graph_arrays

    if kind == "grid":
        from reporter_tpu_torch.tiles.network import grid_city

        return build_graph_arrays(grid_city(120, 120, spacing_m=150.0), cell_size=100.0)
    from reporter_tpu_torch.synth.osm_city import realistic_city_network

    return build_graph_arrays(realistic_city_network(120, 120, spacing_m=150.0, seed=3),
                              cell_size=100.0)


def _synth(arrays, key):
    """One cohort of ``COHORTS``: trace dicts (the grid's), or the osm
    city's three SyntheticTrace lists (``osm_cohorts``)."""
    from reporter_tpu_torch.synth import TraceSynthesizer

    kind, seed, n, T, dt = key
    if kind == "osm":
        synth = TraceSynthesizer(arrays, seed=seed)
        return [synth.batch(512, 64, dt=5.0, sigma=5.0),
                synth.batch(128, 256, dt=5.0, sigma=5.0),
                synth.batch(16, 1024, dt=5.0, sigma=5.0, max_tries=400)]
    return [s.trace for s in TraceSynthesizer(arrays, seed=seed).batch(
        n, T, dt=dt, sigma=5.0, max_tries=100)]


def _synth_job(key):
    """A worker process's cohort: (its city's arrays digest, the cohort,
    seconds)."""
    t0 = time.perf_counter()
    arrays = _city_arrays(key[0])
    return _digest(arrays), _synth(arrays, key), time.perf_counter() - t0


def prefetch_cohorts():
    """Synthesize every cohort of ``COHORTS`` in worker processes (one each,
    started together, before the kernels build), so that the host's route
    searches overlap the build and the phases; ``cohort`` and
    ``osm_cohorts`` take them, each checked to come from the same city.
    The same seeds and code give the same traces as synthesizing inline.
    Returns the pool (shut down at the end of the run)."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=len(COHORTS), mp_context=multiprocessing.get_context("spawn"))
    for key in COHORTS:
        _COHORT_JOBS[key] = pool.submit(_synth_job, key)
    return pool


def _take(arrays, key):
    """A cohort of ``COHORTS``: from its worker when one was started (its
    city's digest must equal ``arrays``'), else synthesized here."""
    t0 = time.perf_counter()
    job = _COHORT_JOBS.pop(key, None)
    if job is None:
        return _synth(arrays, key), time.perf_counter() - t0, "here"
    digest, out, secs = job.result(timeout=900)
    check(digest == _digest(arrays), "cohort %s synthesized on the same city" % (key,))
    return out, secs, "in a worker process, waited %.1f s" % (time.perf_counter() - t0)


def cohort(matcher, seed, n, T, dt=5.0):
    traces, secs, where = _take(matcher.arrays, ("grid", seed, n, T, dt))
    print("cohort %dx%d at %g s synthesized in %.1f s (%s)" % (n, T, dt, secs, where))
    return traces


def subsample(traces, every):
    """Every ``every``-th point of each trace: the same drives sampled
    sparsely (uuids kept apart from the dense cohort's)."""
    return [dict(tr, uuid="%s/%d" % (tr["uuid"], every), trace=tr["trace"][::every])
            for tr in traces]


def bucket_rows(matcher, traces, T):
    """The bucketed path's packed [4, B, T] input of a cohort, on the card."""
    import torch

    from reporter_tpu_torch.ops import viterbi as V

    px, py, tm, valid, _times = matcher._fill_rows(traces, list(range(len(traces))), T)
    return torch.from_numpy(V.pack_inputs(px, py, tm, valid)).to(matcher.device)


def session_rows(matcher, traces, j, Wn=4, pad=16):
    """A session step's packed [4, B + pad, Wn] input: each trace's points
    j .. j+Wn as the session packer lays them out, then ``pad``
    all-invalid rows."""
    import numpy as np
    import torch

    from reporter_tpu_torch.ops import viterbi as V

    items = [{"points": tr["trace"][j:j + Wn], "t0": tr["trace"][0]["time"]}
             for tr in traces]
    px, py, tm, valid, _n = matcher._fill_session_rows(items, range(len(traces)), Wn)
    return torch.from_numpy(V.pack_inputs(*(np.concatenate(
        [a, np.zeros((pad, Wn), a.dtype)]) for a in (px, py, tm, valid)))).to(matcher.device)


def kernel_phases(matcher, xin, timed, p=None, K=None, sp=None, flip=False):
    """Each kernel against its plain version at one of the main path's
    shapes (the packed [4, B, T] input ``xin``): the full call's every
    output, and the main path's call (which skips the outputs the scan
    never reads) equal to the full call on what it returns.  ``timed``:
    also time the main path's call of each kernel and of its plain
    version, beside the bound of that call's work.  ``p`` and ``K``
    default to the matcher's; with ``sp`` (a sparse cohort's parameters)
    kernels 3 and 4 run their sparse instantiations.  ``flip`` (an input
    and parameters from ``gap_flip``): also check that the sparse scan's
    breaks differ from the dense instantiation's on the same input."""
    import numpy as np
    import torch

    from reporter_tpu_torch.ops import viterbi as V
    from reporter_tpu_torch.ops.candidates import candidate_sweep, candidate_sweep_plain
    from reporter_tpu_torch.ops.hashtable import ubodt_lookup, ubodt_lookup_plain

    dev = matcher.device
    B, T = xin.shape[1], xin.shape[2]
    K = K or matcher.cfg.beam_k
    p = p or matcher._params
    tag = "" if sp is None else "[sparse]"
    x, y, t, v = V.unpack_inputs(xin)
    px, py = x.cpu().numpy(), y.cpu().numpy()
    dg, du = matcher._dg, matcher._du
    rows = []

    def same(got, full, what):
        check(all(torch.equal(u, w) for u, w in zip(got, full)),
              what + ": the main path's call equals the full call")

    # kernel 1: candidate sweep (+ emission, edge-row node ids)
    args1 = (dg, x, y, v, K, p.search_radius, p.sigma_z)
    s1 = candidate_sweep(*args1)
    s0 = candidate_sweep_plain(*args1)
    check(_sweep_equal(s1, s0), "candidate_sweep equals its plain version bit for bit")
    err1 = max_abs_err([(getattr(s1.cand, f), getattr(s0.cand, f))
                        for f in ("edge", "offset", "dist", "cx", "cy")]
                       + [(s1.emis, s0.emis), (s1.to_node, s0.to_node)])
    lean1 = candidate_sweep(*args1, full=False)
    same([lean1.cand.edge, lean1.cand.offset, lean1.emis, lean1.to_node, lean1.from_node],
         [s1.cand.edge, s1.cand.offset, s1.emis, s1.to_node, s1.from_node],
         "candidate_sweep")
    cap = dg.cap
    fx = (px - np.float32(dg.grid_x0)) / np.float32(dg.cell_size)
    fy = (py - np.float32(dg.grid_y0)) / np.float32(dg.cell_size)
    cx0 = np.clip(np.floor(fx).astype(np.int64), 0, dg.grid_nx - 1)
    cy0 = np.clip(np.floor(fy).astype(np.int64), 0, dg.grid_ny - 1)
    sx = np.where(fx - np.floor(fx) >= 0.5, 1, -1)
    sy = np.where(fy - np.floor(fy) >= 0.5, 1, -1)
    cells = set()
    for ccy in (cy0, np.clip(cy0 + sy, 0, dg.grid_ny - 1)):
        for ccx in (cx0, np.clip(cx0 + sx, 0, dg.grid_nx - 1)):
            cells.update((ccy * dg.grid_nx + ccx).ravel().tolist())
    n_edges = int(torch.unique(s1.cand.edge[s1.cand.edge >= 0]).numel())
    P = B * T
    # reads: px, py, valid, each distinct cell row once, the two node lanes
    # of each distinct candidate edge; writes: the 5 [P, K] outputs the
    # main path keeps (edge, offset, emis, to/from node).  ~30 float
    # operations per shape segment of the 4*cap swept.
    b1, by1 = bound(12 * P + len(cells) * 32 * cap + 8 * n_edges + 20 * P * K,
                    30 * 4 * cap * P)
    rows.append(dict(name="candidate_sweep", route="cuda",
                     source="reporter_tpu_torch/csrc/candidate_sweep.cu",
                     replaces="reporter_tpu/ops/candidates.py:88",
                     tolerance="exact (every output bit for bit)",
                     fn=lambda: candidate_sweep(*args1, full=False),
                     plain=lambda: candidate_sweep_plain(*args1, full=False), cold_l2=True,
                     max_abs_err=err1, bound_ms=b1, bound_by=by1))

    # kernel 2: UBODT probe over the [B, T-1, K, K] key grid
    a_keys = s1.to_node[:, :-1, :, None]
    b_keys = s1.from_node[:, 1:, None, :]
    r1 = ubodt_lookup(du, a_keys, b_keys)
    r0 = ubodt_lookup_plain(du, a_keys, b_keys)
    check(all(torch.equal(u, w) for u, w in zip(r1, r0)), "ubodt_probe")
    err2 = max_abs_err(zip(r1, r0))
    same(ubodt_lookup(du, a_keys, b_keys, with_first=False)[:2], r1[:2], "ubodt_probe")
    buckets = torch.unique(probe_buckets(du, a_keys, b_keys))
    N = torch.broadcast_tensors(a_keys, b_keys)[0].numel()
    hit = float(torch.isfinite(r1[0]).float().mean())
    # reads: the two [B, T, K] key arrays, each distinct 512-byte bucket
    # row the probe reads once (a key's second row only where its first
    # misses); writes: dist and time (the main path skips first_edge).
    # ~40 integer operations per probe.
    b2, by2 = bound(8 * P * K + 512 * int(buckets.numel()) + 8 * N, 40 * N)
    rows.append(dict(name="ubodt_probe", route="cuda",
                     source="reporter_tpu_torch/csrc/ubodt_probe.cu",
                     replaces="reporter_tpu/ops/hashtable.py:138",
                     tolerance="exact",
                     fn=lambda: ubodt_lookup(du, a_keys, b_keys, with_first=False),
                     plain=lambda: ubodt_lookup_plain(du, a_keys, b_keys, with_first=False),
                     cold_l2=True, max_abs_err=err2, bound_ms=b2, bound_by=by2,
                     probes=N, distinct_rows=int(buckets.numel()), hit_rate=hit))

    # kernel 3: transition build
    args3 = (dg, s1.cand, x, y, t, r1[0], r1[1], p)
    l1 = V.transition_build(*args3, sp=sp)
    l0 = V.transition_build_plain(*args3, sp=sp)
    check(_bits_equal(l1, l0), "transition_build%s equals its plain version bit for bit" % tag)
    err3 = max_abs_err(zip(l1, l0))
    lean3 = V.transition_build(*args3, with_route=False, sp=sp)
    same([lean3[0], lean3[2]], [l1[0], l1[2]], "transition_build" + tag)
    # reads: candidate edge + offset, px/py/times, probe dist + time, the
    # distinct candidate edges' rows; writes: logp and gc (the main path
    # skips route).  ~45 float operations per (t, i, j), ~55 with the
    # sparse model's beta(dt) and plausibility terms.
    b3, by3 = bound(8 * P * K + 12 * P + 8 * N + 32 * n_edges + 4 * N + 4 * B * (T - 1),
                    (45 if sp is None else 55) * N)
    rows.append(dict(name="transition_build" + tag, route="cuda",
                     source="reporter_tpu_torch/csrc/transition_build.cu",
                     replaces="reporter_tpu/ops/viterbi.py:%d" % (196 if sp is None else 247),
                     tolerance="exact (logp, route, gc bit for bit)",
                     fn=lambda: V.transition_build(*args3, with_route=False, sp=sp),
                     plain=lambda: V.transition_build_plain(*args3, with_route=False, sp=sp),
                     cold_l2=False, max_abs_err=err3, bound_ms=b3, bound_by=by3))

    # kernel 4: scan recursion, backtrace, compact gather, confidence
    args4 = (s1.emis, l1[0], l1[2], v, s1.cand.edge, s1.cand.offset, p.breakage_distance, t,
             sp)
    k4 = V.viterbi_scan(*args4)
    k0 = V.viterbi_scan_plain(*args4)
    check(torch.equal(k4[0], k0[0]), "viterbi_scan%s packed" % tag)
    check(torch.allclose(k4[1], k0[1], rtol=1e-4, atol=0), "viterbi_scan%s aux" % tag)
    err4 = max_abs_err([(k4[0], k0[0])])
    # reads: emis, logp, gc, valid (and times for the sparse breakage), the
    # chosen slot's edge + offset and the last slot's edge per point;
    # writes: packed + aux.  2 K^2 float operations (add, compare) per step.
    b4, by4 = bound(4 * P * K + 4 * N + 4 * B * (T - 1) + 4 * P + 12 * P + 12 * P + 16 * B
                    + (0 if sp is None else 4 * P), 2 * N)
    rows.append(dict(name="viterbi_scan" + tag, route="cuda",
                     source="reporter_tpu_torch/csrc/viterbi_scan.cu",
                     replaces="reporter_tpu/ops/viterbi.py:%d" % (447 if sp is None else 458),
                     tolerance="packed exact; aux rtol 1e-4",
                     fn=lambda: V.viterbi_scan(*args4),
                     plain=lambda: V.viterbi_scan_plain(*args4), cold_l2=False,
                     max_abs_err=err4, bound_ms=b4, bound_by=by4,
                     aux_max_abs_err=max_abs_err([(k4[1], k0[1])])))
    if flip:
        kd = V.viterbi_scan(*args4[:-1], None)
        n_flip = int((kd[0][2] != k4[0][2]).sum())
        check(n_flip > 0, "viterbi_scan%s: the per-step gap-conditioned breakage changed "
              "breaks against the dense threshold" % tag)
        rows[-1]["breaks_flipped"] = n_flip
        print("kernel viterbi_scan%s %dx%d K=%d: %d points break differently from the dense "
              "instantiation on the same input" % (tag, B, T, K, n_flip))

    if timed and dev.type == "cuda":
        for r in rows:
            r["ms"] = time_ms(r["fn"], cold_l2=r["cold_l2"],
                              label="%s %dx%d K=%d" % (r["name"], B, T, K))
            r["plain_ms"] = time_ms(r["plain"], cold_l2=r["cold_l2"], queued=False)
    for r in rows:
        print("kernel %-25s %dx%d K=%d max_abs_err=%-9.3g kernel_ms=%s plain_ms=%s "
              "bound_ms=%.4f (%s) within tolerance: %s"
              % (r["name"], B, T, K, r["max_abs_err"],
                 "%.4f" % r["ms"] if "ms" in r else "-",
                 "%.4f" % r["plain_ms"] if "plain_ms" in r else "-", r["bound_ms"],
                 r["bound_by"], r["tolerance"]))
    return rows


def probe_buckets(du, a, b, lo=0, n=None):
    """The bucket rows kernel 2's warp probe (``csrc/ubodt.cuh``
    ``warp_probe``) reads for the keys (a, b) broadcast, repeats kept:
    each key's first-hash row and, on a cuckoo table, its second-hash row
    only where the first row does not hold the key.  With a gp rank's
    range [lo, lo + n) only rows inside it count, and a second row is
    skipped only where the first row is in range and holds the key.
    ``du``: the whole untiered table (on the keys' device)."""
    import torch

    from reporter_tpu_torch.ops import hashtable as H

    sa, sb = (t.reshape(-1) for t in torch.broadcast_tensors(a, b))
    n = du.bmask + 1 if n is None else n
    h1 = H.device_pair_hash(sa, sb, du.bmask)
    in1 = (h1 >= lo) & (h1 < lo + n)
    if du.wide:
        return h1[in1]
    held = []
    for i in range(0, sa.numel(), 1 << 18):
        e = du.packed[h1[i:i + (1 << 18)]].reshape(-1, du.packed.shape[1] // H.ROW_W, H.ROW_W)
        held.append(((e[:, :, H.F_SRC] == sa[i:i + (1 << 18), None])
                     & (e[:, :, H.F_DST] == sb[i:i + (1 << 18), None])).any(1))
    held = torch.cat(held) if held else torch.zeros(0, dtype=torch.bool, device=sa.device)
    h2 = H.device_pair_hash2(sa, sb, du.bmask)
    in2 = (h2 >= lo) & (h2 < lo + n) & ~(in1 & held)
    return torch.cat([h1[in1], h2[in2]])


def _carry_same(a, b):
    """Every leaf of two TraceCarry equal byte for byte."""
    return all(x.cpu().numpy().tobytes() == y.cpu().numpy().tobytes()
               for x, y in zip(a, b))


def _seam_rows(dg, du, carry_edge, first_edge):
    """Distinct UBODT bucket rows and edge rows the seam transitions of a
    batch read: the probes (to(carry edge i), from(first candidate j))."""
    import torch

    from reporter_tpu_torch.ops.hashtable import device_pair_hash, device_pair_hash2

    def node(e, lane):
        rows = dg.edge_rows[torch.where(e >= 0, e, 0).long()][..., lane]
        return rows.contiguous().view(torch.int32)
    a = node(carry_edge, 0)[:, :, None].expand(-1, -1, first_edge.shape[1]).reshape(-1)
    b = node(first_edge, 1)[:, None, :].expand(-1, carry_edge.shape[1], -1).reshape(-1)
    buckets = torch.unique(torch.cat([device_pair_hash(a, b, du.bmask),
                                      device_pair_hash2(a, b, du.bmask)]))
    edges = torch.unique(torch.cat([carry_edge.reshape(-1), first_edge.reshape(-1)]))
    return int(buckets.numel()), int(edges.numel())


def chain_phases(matcher, long_traces, traces64, timed, sp=None, long_pk=None,
                 sess_pk=None, flip=None, kernel="scan", tier=None):
    """Kernel 5 against its plain version at its two main-path shapes: the
    long path's window (64 x 256, continuing live carries) and the
    session step against the serving slab (512 x 4, 65,536 slots), the
    latter also on host carries (the slab's rows gathered).  With ``sp``
    its sparse instantiation, at the (p, K) of ``long_pk`` for the long
    window and of ``sess_pk`` for the slab step (default: the matcher's
    parameters and K).  ``flip`` (a seed): both shapes' inputs and
    parameters go through ``gap_flip``, and the sparse chain's breaks
    must differ from the dense instantiation's, with seams among the
    steps whose decision the sparse threshold flips.  ``kernel`` "assoc":
    the log-depth kernel ``viterbi_chain_assoc`` against the plain version
    of the same forward instead, timed beside kernel 5 on the same
    inputs.  ``tier`` (the TieredTable behind ``matcher._du``): the seam's
    fetch counts and hit/miss totals of each kernel call must equal its
    plain version's."""
    import numpy as np
    import torch

    from reporter_tpu_torch.ops import viterbi as V

    dev = matcher.device
    dg, du = matcher._dg, matcher._du
    p, K = long_pk or (matcher._params, matcher.cfg.beam_k)
    out = {}

    # long path: window 1 of the long cohort, from window 0's carries
    W = matcher.max_trace_points
    B = len(long_traces)
    two = [dict(tr, trace=tr["trace"][:2 * W]) for tr in long_traces]
    px, py, tm, valid, _t = matcher._fill_rows(two, list(range(B)), 2 * W)
    xin = torch.from_numpy(V.pack_inputs(px, py, tm, valid)).to(dev)
    x0, x1 = xin[:, :, :W].contiguous(), xin[:, :, W:].contiguous()
    if flip is not None:
        (x0, x1), p, sp = gap_flip([x0, x1], p, sp, flip)
    pre0 = V.precompute_batch_packed(dg, du, x0, p, K, sp)
    carry = V.viterbi_chain(dg, du, pre0.emis, pre0.logp, pre0.gc, *V.unpack_inputs(x0),
                            pre0.cand.edge, pre0.cand.offset, p,
                            V.initial_carry_batch(B, K, dev), sp=sp)[2]
    check(bool(carry.active.all()), "live carries after window 0")
    pre = V.precompute_batch_packed(dg, du, x1, p, K, sp)
    args = (dg, du, pre.emis, pre.logp, pre.gc, *V.unpack_inputs(x1), pre.cand.edge,
            pre.cand.offset, p, carry)
    k5, dk = _tier_delta(tier, lambda: V.viterbi_chain(*args, sp=sp, kernel=kernel))
    p5, dp = _tier_delta(tier, lambda: V.viterbi_chain_plain(*args, sp=sp, kernel=kernel))
    _same_fetches(dk, dp, "viterbi_chain seam (long)")
    check(torch.equal(k5[0], p5[0]), "viterbi_chain packed (long)")
    check(_carry_same(k5[2], p5[2]), "viterbi_chain carry-out (long)")
    check(torch.allclose(k5[1], p5[1], rtol=1e-4, atol=0), "viterbi_chain aux (long)")
    if flip is not None:
        flipped = _breaks_flipped(args, k5[0], carry, x1, p, sp, "long", kernel=kernel)
    n_rows, n_edges = _seam_rows(dg, du, carry.edge, pre.cand.edge[:, 0])
    T = W
    slot_b = 12 * K + 17
    # reads: emis, logp, gc, px/py/times/valid, candidate edge + offset, the
    # carry, the seam's distinct bucket and edge rows; writes: packed, aux,
    # the carry.  2 K^2 operations per step, ~80 per seam pair.
    nbytes = (4 * B * T * K + 4 * B * (T - 1) * K * K + 4 * B * (T - 1) + 16 * B * T
              + 8 * B * T * K + 2 * slot_b * B + 512 * n_rows + 32 * n_edges
              + 12 * B * T + 16 * B)
    bl, byl = bound(nbytes, 2 * K * K * (T - 1) * B + 80 * K * K * B)
    if kernel == "assoc":  # the log-depth forward's adds and compares
        bl, byl = bound(nbytes, B * (_assoc_ops(T, K) + 80 * K * K))
    out["long"] = dict(shape="%dx%d K=%d" % (B, T, K),
                       fn=lambda: V.viterbi_chain(*args, sp=sp, kernel=kernel),
                       plain=lambda: V.viterbi_chain_plain(*args, sp=sp, kernel=kernel),
                       bound_ms=bl,
                       bound_by=byl, max_abs_err=max_abs_err([(k5[0], p5[0])]),
                       aux_max_abs_err=max_abs_err([(k5[1], p5[1])]),
                       seam_bucket_rows=n_rows)
    if flip is not None:
        out["long"].update(flipped)

    # session step against the serving slab: 480 rows continue their
    # beams, 16 start fresh on slots that hold old beams, 16 are padding
    S, B, Wn = matcher.cfg.max_sessions, len(traces64), 4
    p, K = sess_pk or (matcher._params, matcher.cfg.beam_k)
    slot_b = 12 * K + 17
    rng = np.random.default_rng(5)
    slots = np.full(B, S, np.int32)
    slots[:B - 16] = rng.choice(S, B - 16, replace=False)

    slab = V.initial_carry_batch(S, K, dev)
    # xs1 is the input main() holds kernels 1-4 at (kernel_phases), so the
    # pre both sides share below was itself checked against its plain version
    xs0, xs1 = (session_rows(matcher, traces64[:B - 16], j, Wn) for j in (0, Wn))
    if flip is not None:
        (xs0, xs1), p, sp = gap_flip([xs0, xs1], p, sp, flip + 1)
    pre0 = V.precompute_batch_packed(dg, du, xs0, p, K, sp)
    V.viterbi_chain(dg, du, pre0.emis, pre0.logp, pre0.gc, *V.unpack_inputs(xs0),
                    pre0.cand.edge, pre0.cand.offset, p, slab, slots, np.zeros(B, bool),
                    sp=sp)
    use = np.zeros(B, bool)
    use[:B - 32] = True
    pre = V.precompute_batch_packed(dg, du, xs1, p, K, sp)
    slab_k = V.TraceCarry(*(t.clone() for t in slab))
    slab_p = V.TraceCarry(*(t.clone() for t in slab))
    sargs = (dg, du, pre.emis, pre.logp, pre.gc, *V.unpack_inputs(xs1), pre.cand.edge,
             pre.cand.offset, p)
    ka, dk = _tier_delta(tier, lambda: V.viterbi_chain(*sargs, slab_k, slots, use, sp=sp,
                                                       kernel=kernel))
    pa, dp = _tier_delta(tier, lambda: V.viterbi_chain_plain(*sargs, slab_p, slots, use,
                                                             sp=sp, kernel=kernel))
    _same_fetches(dk, dp, "viterbi_chain seam (arena)")
    check(torch.equal(ka[0], pa[0]), "viterbi_chain packed (arena)")
    check(_carry_same(slab_k, slab_p), "viterbi_chain slab (arena)")
    check(not _carry_same(slab_k, slab), "the arena step wrote the slab")
    check(torch.allclose(ka[1], pa[1], rtol=1e-4, atol=0), "viterbi_chain aux (arena)")
    # the same step on host carries, the slab's rows gathered: kernel 5's
    # [B]-leading mode at the session shape, through the entry point
    rows = torch.from_numpy(np.minimum(slots, S - 1).astype(np.int64)).to(dev)
    usem = torch.from_numpy(use).to(dev)
    hc = V.TraceCarry(*(torch.where(usem.view((B,) + (1,) * (g.dim() - 1)), g[rows], i)
                        for g, i in zip(slab, V.initial_carry_batch(B, K, dev))))
    hk = V.session_step_packed(dg, du, xs1, p, K, hc, sp, kernel)
    hp = V.session_step_packed_plain(dg, du, xs1, p, K, hc, sp, kernel)
    check(torch.equal(hk[0], hp[0]) and _carry_same(hk[2], hp[2]),
          "viterbi_chain packed and carry-out (host carries)")
    check(torch.allclose(hk[1], hp[1], rtol=1e-4, atol=0), "viterbi_chain aux (host carries)")
    live_rows = slice(0, B - 16)
    check(torch.equal(hk[0], ka[0]) and _carry_same(
        [c[live_rows] for c in hk[2]], [c[rows[live_rows]] for c in slab_k]),
        "the host-carry step equals the slab step")
    if flip is not None:
        flipped = _breaks_flipped(sargs + (slab,), ka[0], hc, xs1, p, sp, "arena",
                                  dict(slots=slots, use_carry=use), kernel)
    live = torch.from_numpy(slots[:B - 32].astype(np.int64)).to(dev)
    in_edge = slab.edge[live]
    n_rows, n_edges = _seam_rows(dg, du, in_edge, pre.cand.edge[:B - 32, 0])
    T = Wn
    nbytes = (4 * B * T * K + 4 * B * (T - 1) * K * K + 4 * B * (T - 1) + 16 * B * T
              + 8 * B * T * K + 5 * B + slot_b * ((B - 32) + (B - 16))
              + 512 * n_rows + 32 * n_edges + 12 * B * T + 16 * B)
    ba, bya = bound(nbytes, 2 * K * K * (T - 1) * B + 80 * K * K * B)
    if kernel == "assoc":
        ba, bya = bound(nbytes, B * (_assoc_ops(T, K) + 80 * K * K))
    saved = V.TraceCarry(*(t.clone() for t in slab_k))
    out["arena"] = dict(shape="%dx%d K=%d slab %d" % (B, T, K, S),
                        fn=lambda: V.viterbi_chain(*sargs, slab_k, slots, use, sp=sp,
                                                   kernel=kernel),
                        reset=lambda: [d.copy_(v) for d, v in zip(slab_k, saved)],
                        plain=lambda: V.viterbi_chain_plain(*sargs, slab_p, slots, use,
                                                            sp=sp, kernel=kernel),
                        bound_ms=ba, bound_by=bya,
                        max_abs_err=max_abs_err([(ka[0], pa[0]), (hk[0], hp[0])]),
                        aux_max_abs_err=max_abs_err([(ka[1], pa[1]), (hk[1], hp[1])]),
                        seam_bucket_rows=n_rows)
    if flip is not None:
        out["arena"].update(flipped)
    name = ("viterbi_chain_assoc" if kernel == "assoc" else "viterbi_chain") + (
        "" if sp is None else "[sparse]")
    scan = {"long": lambda: V.viterbi_chain(*args, sp=sp),  # kernel 5, same inputs
            "arena": lambda: V.viterbi_chain(*sargs, slab_k, slots, use, sp=sp)}
    for what, r in out.items():
        if timed and dev.type == "cuda":
            r["ms"] = time_ms(r["fn"], cold_l2=False, prep=r.get("reset"),
                              label="%s %s %s" % (name, what, r["shape"]))
            r["plain_ms"] = time_ms(r["plain"], cold_l2=False, queued=False)
            if kernel == "assoc":
                r["scan_ms"] = time_ms(scan[what], cold_l2=False, prep=r.get("reset"),
                                       label="viterbi_chain%s %s %s (assoc's inputs)" % (
                                           "" if sp is None else "[sparse]", what,
                                           r["shape"]))
        print("kernel %-27s %-22s max_abs_err=%-9.3g kernel_ms=%s plain_ms=%s%s "
              "bound_ms=%.4f (%s) within tolerance: packed, carry/slab exact; aux rtol 1e-4"
              % (name, r["shape"], r["max_abs_err"],
                 "%.4f" % r["ms"] if "ms" in r else "-",
                 "%.4f" % r["plain_ms"] if "plain_ms" in r else "-",
                 " viterbi_chain_ms=%.4f" % r["scan_ms"] if "scan_ms" in r else "",
                 r["bound_ms"], r["bound_by"]))
    return out


def _tier_delta(tier, fn):
    """(fn(), (per-bucket fetch counts, [hits, misses]) that the call added
    to ``tier``); (fn(), None) without a tier."""
    import torch

    if tier is None:
        return fn(), None
    if tier.dev.type == "cuda":
        torch.cuda.synchronize(tier.dev)
    c0, t0 = tier.counts.clone(), tier.totals.clone()
    out = fn()
    if tier.dev.type == "cuda":
        torch.cuda.synchronize(tier.dev)
    return out, ((tier.counts - c0).cpu(), (tier.totals - t0).cpu().tolist())


def _same_fetches(dk, dp, what):
    """A kernel call's fetch counts and totals equal its plain version's."""
    import torch

    if dk is None:
        return
    check(torch.equal(dk[0], dp[0]) and dk[1] == dp[1] and sum(dk[1]) > 0,
          "%s: the kernel's fetch counts and hit/miss totals %s equal the plain "
          "version's %s" % (what, dk[1], dp[1]))


def gap_flip(xins, p, sp, seed):
    """An input on which the sparse model's gap-conditioned breakage
    decides.  ``xins``: consecutive packed [4, B, W] windows of the same
    rows.  Every valid step's time gap is scaled by a factor drawn from
    [0.5, 2] (``seed``), so gaps vary from step to step and from row to
    row, window seams included.  The thresholds are set inside the data,
    as the reference's own breakage test shrinks breakage_distance: the
    dense breakage distance at the 40th percentile of the steps'
    straight-line distances, the break speed at the 80th percentile of
    their implied speeds.  A step between the two thresholds breaks under
    the dense model and not under the sparse one, so a kernel that
    misreads a step's gap, or the seam's, disagrees with its plain
    version.  Returns (windows on ``xins``' device, p', sp')."""
    import numpy as np
    import torch

    a = torch.cat(xins, 2).cpu().numpy().astype(np.float64)
    x, y, t, ok = a[0], a[1], a[2], a[3] != 0
    step = ok[:, 1:] & ok[:, :-1]  # valid points form each row's prefix
    dt = np.diff(t, axis=1) * np.random.default_rng(seed).uniform(0.5, 2.0, step.shape)
    t2 = t.copy()
    t2[:, 1:] = np.where(ok[:, 1:], t[:, :1] + np.cumsum(np.where(step, dt, 0.0), 1),
                         t[:, 1:])
    gc = np.hypot(np.diff(x, axis=1), np.diff(y, axis=1))[step]
    gap = np.diff(t2, axis=1)[step]
    brk = float(np.quantile(gc, 0.4))
    speed = float(np.quantile(gc / np.maximum(gap, 1.0), 0.8))
    a[2] = t2
    out = torch.from_numpy(a.astype(np.float32)).to(xins[0].device)
    cuts = np.cumsum([w.shape[2] for w in xins])[:-1]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    print("gap_flip: %d steps, gaps %.1f-%.1f s, breakage_distance %.1f m, break_speed "
          "%.2f m/s: %d steps flip" % (gc.size, gap.min(), gap.max(), brk, speed, int(
              ((gc > brk) & (gc <= np.maximum(brk, speed * gap))).sum())))
    return ([w.contiguous() for w in torch.tensor_split(out, list(cuts), 2)],
            p._replace(breakage_distance=f32(brk)), sp._replace(break_speed=f32(speed)))


def _breaks_flipped(args, packed, carry, xin, p, sp, what, slab_kw=None, kernel="scan"):
    """After a sparse chain call (``args`` + ``slab_kw``, giving ``packed``)
    from carries ``carry`` (leading [B]) over the window ``xin``: the rows
    whose seam decision the sparse threshold flips (the seam's distance
    beyond breakage_distance but within the gap-conditioned threshold)
    must exist, and the dense instantiation on the same input must break
    differently.  A slab call's slab is cloned for the dense run."""
    import torch

    from reporter_tpu_torch.ops import viterbi as V
    from reporter_tpu_torch.ops.candidates import hypot_like_jax

    px, py, tm, valid = V.unpack_inputs(xin)
    gc0 = hypot_like_jax(px[:, 0] - carry.x, py[:, 0] - carry.y)
    brk0 = V.sparse_breakage(p.breakage_distance, sp, tm[:, 0] - carry.t)
    seams = int((carry.active & (valid[:, 0] != 0) & (gc0 > p.breakage_distance.to(gc0.device))
                 & (gc0 <= brk0)).sum())
    name = "viterbi_chain%s[sparse]" % ("_assoc" if kernel == "assoc" else "")
    check(seams > 0, "%s (%s): seams whose break the gap decides" % (name, what))
    if slab_kw:
        args = args[:-1] + (V.TraceCarry(*(t.clone() for t in args[-1])),)
    dense = V.viterbi_chain(*args, **(slab_kw or {}), sp=None, kernel=kernel)[0]
    n = int((dense[2] != packed[2]).sum())
    check(n > 0, "%s (%s): the gap-conditioned breakage changed breaks against the dense "
          "threshold" % (name, what))
    print("kernel %s (%s): %d points break differently from the dense instantiation, %d "
          "seams' decisions flipped by the gap" % (name, what, n, seams))
    return {"breaks_flipped": n, "seams_flipped": seams}


def _counted(path_kernels, drive, absent=()):
    """Drive one path with every launch count set to 0 just before and read
    just after; on the card every kernel of the path must have launched,
    and none of ``absent``."""
    import torch

    from reporter_tpu_torch.ops import _kernels

    _kernels.reset_launches()
    t0 = time.perf_counter()
    res = drive()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: kern.launches for k, kern in _kernels.KERNELS.items()}
    if torch.cuda.is_available():
        check(all(launches[k] > 0 for k in path_kernels),
              "every kernel of the path launched: %s" % json.dumps(launches))
        check(not any(launches[k] for k in absent),
              "no kernel off the path launched (%s): %s" % (absent, json.dumps(launches)))
    return res, dt, launches


PROBE_FAMILY = ("ubodt_probe", "ubodt_probe[wide32]", "ubodt_probe[tiered]",
                "ubodt_probe[wide32,tiered]", "ubodt_probe[sharded]",
                "ubodt_probe[wide32,sharded]", "ubodt_probe[tiered,sharded]",
                "ubodt_probe[wide32,tiered,sharded]", "ubodt_cold_mark",
                "ubodt_cold_gather", "ubodt_dedup_claim", "ubodt_dedup_scatter",
                "probe_stats")


def _path_kernels(matcher, kernels, sampled=False):
    """(kernels, absent): the kernels a path of ``matcher`` must launch,
    its table's probe (the instantiation for its layout and tiering, a
    tiered one with its staging's mark and gather; and
    the dedup kernels with probe dedup, the
    diagnostic's when ``sampled`` and the sampler is on) in place of
    ``ubodt_probe``, and the probe-family kernels it must not launch."""
    from reporter_tpu_torch.ops.hashtable import probe_kernel_name

    probe = (probe_kernel_name(matcher._du),)
    if "tiered" in probe[0]:
        probe += ("ubodt_cold_mark", "ubodt_cold_gather")
    if matcher.probe_dedup:
        probe += ("ubodt_dedup_claim", "ubodt_dedup_scatter")
    if sampled and matcher._probe_every:
        probe += ("probe_stats",)
    return (tuple(k for k in kernels if k != "ubodt_probe") + probe,
            tuple(k for k in PROBE_FAMILY if k not in probe))


def _forward(matcher, T, carried, sparse=False, kernels=None):
    """(kernels, absent): ``kernels`` (a path tuple whose last entry is the
    Viterbi kernel) with that entry replaced by the one a dispatch of
    window length T launches under the matcher's forward (the assoc
    kernels where ``_kernel_for(T)`` is "assoc"), and the other forward's
    kernel, which must not launch."""
    tag = "[sparse]" if sparse else ""
    scan, assoc = (("viterbi_chain", "viterbi_chain_assoc") if carried
                   else ("viterbi_scan", "viterbi_assoc"))
    use, other = ((assoc, scan) if matcher._kernel_for(T) == "assoc" else (scan, assoc))
    kernels = kernels or (BUCKETED if not carried else CARRIED)
    return kernels[:-1] + (use + tag,), (other + tag,)


BUCKETED = ("candidate_sweep", "ubodt_probe", "transition_build", "viterbi_scan")
CARRIED = ("candidate_sweep", "ubodt_probe", "transition_build", "viterbi_chain")
SPARSE_BUCKETED = ("candidate_sweep", "ubodt_probe", "transition_build[sparse]",
                   "viterbi_scan[sparse]")
SPARSE_CARRIED = ("candidate_sweep", "ubodt_probe", "transition_build[sparse]",
                  "viterbi_chain[sparse]")


def long_path(matcher, traces, slabel="", base=None, plain=True):
    """The long path: ``match_many`` over 64 traces of 2,048 points (8
    windows of 256) through the launch counters, then the group's
    per-point output held against the plain composition window by window
    on the card.  With ``slabel`` the traces are that sparse cohort's and
    ``matcher`` has the model on: the sparse programs at the cohort's K.
    ``base`` (a matcher with another table layout or dedup setting): its
    output must be the same.  ``plain=False`` skips the plain composition
    (for a matcher whose ``base`` was held against it)."""
    import numpy as np
    import torch

    from reporter_tpu_torch.ops import viterbi as V

    dev = matcher.device
    W = matcher.max_trace_points
    matcher.match_many(traces[:1])  # first-call set-up outside the count
    path, other = _forward(matcher, W, True, bool(slabel),
                           SPARSE_CARRIED if slabel else CARRIED)
    kernels, absent = _path_kernels(matcher, path)
    res, dt, launches = _counted(kernels, lambda: matcher.match_many(traces),
                                 absent + other)
    check(len(res) == len(traces) and all(r["segments"] for r in res), "long path results")
    n_pts = sum(len(tr["trace"]) for tr in traces)
    rate = {"traces": len(traces), "T": len(traces[0]["trace"]), "s": dt,
            "traces_per_s": len(traces) / dt, "points_per_s": n_pts / dt}
    print("long path %s%dx%d: %.3f s, %.1f traces/s, %.0f points/s, launches %s"
          % ("(sparse %s) " % slabel if slabel else "", len(traces), rate["T"], dt,
             rate["traces_per_s"], rate["points_per_s"], json.dumps(launches)))
    n_chunks = -(-rate["T"] // W)
    chain = path[-1]
    if dev.type == "cuda":
        check(launches["candidate_sweep"] == 1 and launches[chain] == n_chunks,
              "one pre dispatch and one chain dispatch per window")
    if slabel:
        check(matcher.sparse.dispatch.get(slabel, 0) >= len(traces),
              "the long traces dispatched as cohort %s" % slabel)

    handles = matcher._dispatch_long(traces, list(range(len(traces))), (), slabel)
    check(len(handles) == 1, "one long group")
    group, (edge, offset, breaks), _times, _aux = matcher._fetch_long_aux(handles[0])
    px, py, tm, valid, _t = matcher._fill_rows(traces, group, n_chunks * W)
    xin = torch.from_numpy(V.pack_inputs(px, py, tm, valid)).to(dev)
    p, sp, K = (matcher.sparse.params_for(slabel) if slabel
                else (matcher._params, None, matcher.cfg.beam_k))
    carry = V.initial_carry_batch(len(group), K, dev)
    parts = []
    for c in range(n_chunks if plain else 0):
        xc = xin[:, :, c * W:(c + 1) * W].contiguous()
        pre = V.precompute_batch_packed_plain(matcher._dg, matcher._du, xc, p, K, sp)
        packed, _a, carry = V.chain_batch_carry_packed_aux_plain(
            matcher._dg, matcher._du, pre, xc, p, K, carry, sp, matcher._kernel_for(W))
        parts.append(V.unpack_compact(packed.cpu().numpy()))
    B = len(group)
    if plain:
        want = [np.concatenate([q[f] for q in parts], 1) for f in range(3)]
        check(np.array_equal(edge[:B], want[0]) and offset[:B].tobytes() == want[1].tobytes()
              and np.array_equal(breaks[:B], want[2]),
              "long path output equals the plain composition")
        print("long path [%d, %d x %d] K=%d (%s) equals the plain composition window by "
              "window" % (B, n_chunks, W, K, chain))
    if base is not None:
        (hb,) = base._dispatch_long(traces, list(range(len(traces))), (), slabel)
        _g, (e2, o2, b2), _t, _a = base._fetch_long_aux(hb)
        check(np.array_equal(edge, e2) and offset.tobytes() == o2.tobytes()
              and np.array_equal(breaks, b2), "long path output equals the %s table's, "
              "dedup %s" % (base._du.layout, base.probe_dedup))
        print("long path output equals the %s matcher's (dedup %s)"
              % (base._du.layout, base.probe_dedup))
    return launches, rate


def _clocked(fn, acc, key, finish_key=None):
    """``fn`` with its host time added to ``acc[key]``; with ``finish_key``
    fn returns a finish() whose time goes to ``acc[finish_key]``."""
    def run(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
        if finish_key is None:
            return out

        def finish():
            t1 = time.perf_counter()
            res = out()
            acc[finish_key] = acc.get(finish_key, 0.0) + time.perf_counter() - t1
            return res
        return finish
    return run


def long_breakdown(matcher, traces):
    """Host-clock split of the long cohort through the matcher's own steps:
    packing, the device program (upload, the pre dispatch, the chain
    dispatches, fetch), association and report()."""
    import torch

    from reporter_tpu_torch.ops import viterbi as V
    from reporter_tpu_torch.report import report as report_fn

    W = matcher.max_trace_points
    idxs = list(range(len(traces)))
    n_chunks = -(-max(len(t["trace"]) for t in traces) // W)
    if matcher.device.type == "cuda":
        torch.cuda.synchronize(matcher.device)
    (px, py, tm, valid, times), _l, pack_ms, legacy_ms = _pack_both(matcher, traces,
                                                                     n_chunks * W)
    t0 = time.perf_counter()
    xin = V.pack_inputs(px, py, tm, valid)
    t1 = time.perf_counter()
    handle = (idxs, *matcher._dispatch_long_group(xin, n_chunks, W, matcher._params))
    group, host_parts, outs, aux = handle
    tail = torch.cat(outs, 2) if len(outs) > 1 else outs[0]
    _g, res, _t, aux = matcher._fetch_long_aux((group, host_parts, tail, times, aux))
    t2 = time.perf_counter()
    results = [None] * len(traces)
    _r, n_ext, n_py = _records_delta(lambda: matcher._associate_and_store(
        idxs, *res, times, results, aux=aux))
    t3 = time.perf_counter()
    check(n_ext == 1 and n_py == 0, "association through the records extension")
    for tr, r in zip(traces, results):
        r.pop("_quality", None)
        report_fn(r, tr, 15, {0, 1, 2}, {0, 1, 2})
    t4 = time.perf_counter()
    out = {"pack_ms": pack_ms + (t1 - t0) * 1e3, "pack_legacy_ms": legacy_ms + (t1 - t0) * 1e3,
           "device_ms": (t2 - t1) * 1e3, "assoc_ms": (t3 - t2) * 1e3,
           "report_ms": (t4 - t3) * 1e3}
    print("breakdown %dx%d (long): pack %.1f ms (legacy loop %.1f ms), device program incl. "
          "transfers %.2f ms, association %.1f ms (records extension), report() %.1f ms"
          % (len(traces), n_chunks * W, out["pack_ms"], out["pack_legacy_ms"],
             out["device_ms"], out["assoc_ms"], out["report_ms"]))
    return out


def session_path(matcher, traces64):
    """The session path: the 512 x 64 cohort as 512 sessions in 16 steps of
    4 points through ``SessionEngine`` with the session slab at its
    serving size, through the launch counters; held bit for bit against
    the host-carry path and the long path of a matcher with 4-point
    windows.  Returns the slab matcher (the serve phase reuses it)."""
    from dataclasses import replace

    import numpy as np

    from reporter_tpu_torch.matching import SegmentMatcher, SessionEngine, SessionStore
    from reporter_tpu_torch.matching.arena import carry_host

    cfg = matcher.cfg
    am = SegmentMatcher(arrays=matcher.arrays, ubodt=matcher.ubodt,
                        config=replace(cfg, session_arena=True), device=matcher.device)
    check(am.session_arena.hot_slots == 65536, "serving slab of 65,536 slots")
    steps, Wn = len(traces64[0]["trace"]) // 4, 4

    def stream(m, traces, split=None):
        eng = SessionEngine(m, SessionStore(cfg.max_sessions, cfg.session_ttl_s),
                            tail_points=cfg.session_tail_points)
        if split is not None:  # host clocks around the engine's own steps
            eng.associate = _clocked(eng.associate, split, "association")
            m.match_sessions_async = _clocked(m.match_sessions_async, split, "dispatch",
                                              "device_and_fetch")
        for j in range(0, steps * Wn, Wn):
            eng.match_many([dict(tr, trace=tr["trace"][j:j + Wn]) for tr in traces])
        m.__dict__.pop("match_sessions_async", None)
        return eng

    warm = stream(am, [dict(traces64[0], uuid="warm")])  # set-up outside the count
    warm.store.drop("warm")
    split = {}
    path, other = _forward(am, Wn, True)
    kernels, absent = _path_kernels(am, path)
    eng, dt, launches = _counted(kernels, lambda: stream(am, traces64, split), other + absent)
    n = len(traces64)
    split = {k + "_ms_per_step": v * 1e3 / steps for k, v in split.items()}
    split["engine_rest_ms_per_step"] = dt * 1e3 / steps - sum(split.values())
    rate = {"sessions": n, "steps": steps, "points_per_step": Wn, "s": dt,
            "steps_per_s": steps / dt, "points_per_s": n * steps * Wn / dt,
            "breakdown": split}
    print("session path %d sessions x %d steps of %d: %.3f s, %.2f steps/s, %.0f points/s, "
          "launches %s" % (n, steps, Wn, dt, rate["steps_per_s"], rate["points_per_s"],
                           json.dumps(launches)))
    print("session step breakdown (ms per step): %s"
          % ", ".join("%s %.1f" % (k[:-12], v) for k, v in split.items()))
    if matcher.device.type == "cuda":
        check(launches[path[-1]] == steps, "one slab step per session step")
    host = stream(matcher, traces64)
    oracle = SegmentMatcher(arrays=matcher.arrays, ubodt=matcher.ubodt,
                            config=replace(cfg, length_buckets=[Wn]), device=matcher.device)
    (h,) = oracle._dispatch_long(traces64, list(range(n)))
    group, (edge, offset, breaks), _t, _a = oracle._fetch_long_aux(h)
    for row, i in enumerate(group):
        u = traces64[i]["uuid"]
        s, hs = eng.store.peek(u), host.store.peek(u)
        check(s.records == hs.records, "slab path records equal host-carry path (%s)" % u)
        a, b = carry_host(s.carry), carry_host(hs.carry)
        check(all(np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in a),
              "slab beam equals host-carry beam (%s)" % u)
        rec = np.array([(r[0], r[2]) for r in s.records])
        off = np.array([r[1] for r in s.records], np.float32)
        check(np.array_equal(rec[:, 0], edge[row]) and np.array_equal(rec[:, 1], breaks[row])
              and off.tobytes() == offset[row].tobytes(),
              "session records equal the 4-point-window long path (%s)" % u)
    print("session path: %d sessions' records and beams equal on the slab and host-carry "
          "paths, and equal the long path with 4-point windows" % n)
    rate["arena"] = am.session_arena.summary()
    return am, launches, rate


def main_path(matcher, cohorts, xins, base=None, plain=True):
    """The bucketed path through the launch counters, then, for each cohort,
    the packed program held against the plain versions' composition on
    the same batch (``plain=False`` skips it) and, with ``base``, against
    that matcher's program under the same forward."""
    import torch

    from reporter_tpu_torch.ops import _kernels
    from reporter_tpu_torch.ops import viterbi as V

    dev = matcher.device
    matcher.match_many(cohorts[0][:4])  # first-call set-up outside the count
    _kernels.reset_launches()
    rates = []
    for traces in cohorts:
        t0 = time.perf_counter()
        res = matcher.match_many(traces)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        n_pts = sum(len(tr["trace"]) for tr in traces)
        check(len(res) == len(traces) and all(r["segments"] for r in res),
              "main path results")
        rates.append({"traces": len(traces), "T": len(traces[0]["trace"]), "s": dt,
                      "traces_per_s": len(traces) / dt, "points_per_s": n_pts / dt})
        print("main path %dx%d: %.3f s, %.1f traces/s, %.0f points/s"
              % (len(traces), len(traces[0]["trace"]), dt, len(traces) / dt, n_pts / dt))
    launches = {k: kern.launches for k, kern in _kernels.KERNELS.items()}
    print("main path launches: %s" % json.dumps(launches))
    fwd = {_forward(matcher, matcher._bucket_len(len(trs[0]["trace"])), False)[0][-1]
           for trs in cohorts}
    other = {"viterbi_scan", "viterbi_assoc"} - fwd
    kernels, absent = _path_kernels(matcher, BUCKETED[:-1] + tuple(sorted(fwd)), sampled=True)
    absent += tuple(sorted(other))
    if dev.type == "cuda":
        check(all(launches[k] > 0 for k in kernels), "every kernel launched on the main path")
        check(not any(launches[k] for k in absent), "no kernel off the main path launched")
    p = matcher._params
    for xin in xins:
        kern = matcher._kernel_for(xin.shape[2])
        got = V.match_batch_compact_packed_aux(matcher._dg, matcher._du, xin, p,
                                               matcher.cfg.beam_k, None, matcher.probe_dedup,
                                               kern)
        if plain:
            want = V.match_batch_compact_packed_aux_plain(matcher._dg, matcher._du, xin, p,
                                                          matcher.cfg.beam_k, kernel=kern)
            check(torch.equal(got[0], want[0]),
                  "main path packed output equals the plain versions'")
            check(torch.allclose(got[1], want[1], rtol=1e-4, atol=0), "main path aux")
            print("main path packed [3,%d,%d] equals the plain composition (%s), aux within "
                  "rtol 1e-4" % (*xin.shape[1:], kern))
        if base is not None:
            b = V.match_batch_compact_packed_aux(base._dg, base._du, xin, p, base.cfg.beam_k,
                                                 kernel=kern)
            check(torch.equal(got[0], b[0]) and torch.equal(got[1], b[1]),
                  "main path output equals the %s table's without dedup" % base._du.layout)
            print("main path packed [3,%d,%d] (%s, dedup %s%s) equals the %s matcher's output"
                  % (*xin.shape[1:], matcher._du.layout, matcher.probe_dedup,
                     ", tiered" if matcher.tiering is not None else "", base._du.layout))
    return launches, rates


def breakdown(matcher, traces):
    """Host-clock split of one bucketed batch through the matcher's own
    steps: packing (the columnar pack, the default, and the legacy loop
    beside it, equal bit for bit), the device program (upload, kernels
    1-4, fetch), association (through the records extension, checked)
    and report()."""
    import torch

    from reporter_tpu_torch.report import report as report_fn

    idxs = list(range(len(traces)))
    T = matcher._bucket_len(len(traces[0]["trace"]))
    if matcher.device.type == "cuda":
        torch.cuda.synchronize(matcher.device)
    (px, py, tm, valid, times), _l, pack_ms, legacy_ms = _pack_both(matcher, traces, T)
    t1 = time.perf_counter()
    res, aux = matcher._collect_batch(matcher._dispatch_batch(px, py, tm, valid))
    t2 = time.perf_counter()
    results = [None] * len(traces)
    _r, n_ext, n_py = _records_delta(lambda: matcher._associate_and_store(
        idxs, *res, times, results, aux=aux))
    t3 = time.perf_counter()
    check(n_ext == 1 and n_py == 0, "association through the records extension")
    for tr, r in zip(traces, results):
        r.pop("_quality", None)
        report_fn(r, tr, 15, {0, 1, 2}, {0, 1, 2})
    t4 = time.perf_counter()
    out = {"pack_ms": pack_ms, "pack_legacy_ms": legacy_ms, "device_ms": (t2 - t1) * 1e3,
           "assoc_ms": (t3 - t2) * 1e3, "report_ms": (t4 - t3) * 1e3}
    print("breakdown %dx%d: pack %.1f ms (legacy loop %.1f ms), device program incl. "
          "transfers %.2f ms, association %.1f ms (records extension), report() %.1f ms"
          % (len(traces), T, out["pack_ms"], out["pack_legacy_ms"], out["device_ms"],
             out["assoc_ms"], out["report_ms"]))
    return out


def _post_raw(port, path, data, headers):
    """POST ``data`` to the port's server: (status, headers, body bytes),
    an error status included."""
    import urllib.error

    req = urllib.request.Request("http://127.0.0.1:%d%s" % (port, path), data=data,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post(port, body):
    req = urllib.request.Request("http://127.0.0.1:%d/report" % port,
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _serve(matcher, threshold, *batches):
    """Answer each batch of requests concurrently through one port HTTP
    server, the batches one after the other; one answer list per batch."""
    from reporter_tpu_torch.serve import ReporterService

    service = ReporterService(matcher, threshold_sec=threshold, max_batch=64, max_wait_ms=10)
    server = service.make_server("127.0.0.1", 0)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    outs = []
    try:
        for requests in batches:
            out = [None] * len(requests)

            def one(i):
                out[i] = _post(port, requests[i])

            workers = [threading.Thread(target=one, args=(i,)) for i in range(len(requests))]
            for w in workers:
                w.start()
            for w in workers:
                w.join(300)
            check(not any(w.is_alive() for w in workers), "requests answered")
            outs.append(out)
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        th.join(10)
    return outs


def _diff(got, want, path):
    if isinstance(want, dict):
        check(isinstance(got, dict) and set(got) == set(want), "%s keys" % path)
        for k in want:
            _diff(got[k], want[k], "%s.%s" % (path, k))
    elif isinstance(want, list):
        check(isinstance(got, list) and len(got) == len(want), "%s length" % path)
        for i, (g, w) in enumerate(zip(got, want)):
            _diff(g, w, "%s[%d]" % (path, i))
    elif isinstance(want, float):
        check(abs(got - want) <= 0.01, "%s: %r != %r" % (path, got, want))
    else:
        check(got == want, "%s: %r != %r" % (path, got, want))


def serve_phase(matcher, traces, long_trace, device):
    """Windowed, long and streaming /report on the metro city through the
    launch counters, then the recorded fixtures."""
    # 8 vehicles, 4 streaming submits of 4 points each, submitted together
    streams = [dict(tr, uuid="veh-%d" % i, stream=True, trace=tr["trace"][j:j + 4])
               for j in range(0, 16, 4) for i, tr in enumerate(traces[8:16])]
    requests = traces[:8] + [long_trace]
    t0 = time.perf_counter()

    (answers, *streamed), _dt, launches = _counted(BUCKETED + CARRIED, lambda: _serve(
        matcher, 15, requests, *(streams[j:j + 8] for j in range(0, len(streams), 8))))
    for code, body in answers:
        check(code == 200, "metro /report status %s" % code)
        check({"datastore", "segment_matcher", "stats"} <= set(body)
              and set(body) <= {"datastore", "segment_matcher", "stats", "shape_used"},
              "metro /report schema")
        check(body["segment_matcher"]["segments"], "metro /report segments")
    want = json.loads(json.dumps(matcher.match(long_trace)["segments"]))
    check(answers[-1][1]["segment_matcher"]["segments"] == want,
          "the long /report's segments equal match()")
    for k, batch in enumerate(streamed):
        for code, body in batch:
            check(code == 200 and body["session"]["seq"] == k + 1
                  and body["session"]["points_total"] == 4 * (k + 1),
                  "streaming /report status and session block")
    n_reports = sum(len(b["datastore"]["reports"]) for _c, b in answers)
    print("serve metro: 8 /report and one %d-point /report answered 200, 8 vehicles x 4 "
          "streaming submits answered 200, in %.2f s (%d datastore reports), launches %s"
          % (len(long_trace["trace"]), time.perf_counter() - t0, n_reports,
             json.dumps(launches)))
    fixtures = replay_fixtures(device)
    return n_reports, launches, fixtures


def replay_fixtures(device, what="the serving defaults"):
    """The 6 recorded /report fixtures on their 8 x 8 grid through a matcher
    built as serve/__main__.py builds it (the environment read then),
    each answer diffed against the recorded response."""
    from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
    from reporter_tpu_torch.serve.__main__ import serving_defaults
    from reporter_tpu_torch.tiles.arrays import build_graph_arrays
    from reporter_tpu_torch.tiles.network import grid_city
    from reporter_tpu_torch.tiles.ubodt import build_ubodt

    with open(os.path.join(REPO, "tests", "fixtures", "report_fixtures.json")) as f:
        recorded = json.load(f)
    net = recorded["network"]
    arrays = build_graph_arrays(grid_city(net["rows"], net["cols"], net["spacing_m"]),
                                cell_size=100.0)
    # the serving defaults: the sparse model on, which leaves these dense
    # traces (median gaps 10-30 s) on the dense programs
    fixture_matcher = SegmentMatcher(arrays=arrays, ubodt=build_ubodt(arrays, delta=3000.0),
                                     config=serving_defaults(MatcherConfig()), device=device)
    (answers,) = _serve(fixture_matcher, recorded["threshold_sec"],
                        [fx["request"] for fx in recorded["fixtures"]])
    for fx, (code, body) in zip(recorded["fixtures"], answers):
        check(code == 200, "fixture status")
        _diff(body, fx["response"], fx["request"]["uuid"])
    print("serve fixtures: %d recorded /report responses replayed equal under %s (table %s, "
          "dedup %s)" % (len(recorded["fixtures"]), what, fixture_matcher.ubodt_layout,
                         fixture_matcher.probe_dedup))
    return answers


def sparse_matcher(matcher, calibration=None, **cfg_kw):
    """A matcher over ``matcher``'s city with the sparse-gap model on
    (``cfg.sparse``), and with ``calibration`` read through
    $REPORTER_CALIBRATION when the model is built."""
    from dataclasses import replace

    from reporter_tpu_torch.matching import SegmentMatcher

    saved = os.environ.pop("REPORTER_CALIBRATION", None)
    if calibration:
        os.environ["REPORTER_CALIBRATION"] = calibration
    try:
        sm = SegmentMatcher(arrays=matcher.arrays, ubodt=matcher.ubodt,
                            config=replace(matcher.cfg, sparse=True, **cfg_kw),
                            device=matcher.device)
    finally:
        os.environ.pop("REPORTER_CALIBRATION", None)
        if saved is not None:
            os.environ["REPORTER_CALIBRATION"] = saved
    check(sm.sparse.enabled and bool(sm.sparse.calibration) == bool(calibration),
          "sparse model on, calibrated: %s" % bool(calibration))
    return sm


def sparse_main_path(sm, cohorts, xins, what, base=None, plain=True):
    """The bucketed path of a sparse-on matcher over the sparse cohorts
    through the launch counters (each cohort's traces dispatched as its
    gap cohort), then each cohort's packed program held against the plain
    composition at the cohort's parameters and K (and, with ``base``,
    against that matcher's program)."""
    import torch

    from reporter_tpu_torch.ops import viterbi as V

    dev = sm.device
    sm.match_many(cohorts[0][:4])  # first-call set-up outside the count
    sm.sparse.dispatch.clear()
    rates = []

    def drive():
        for traces in cohorts:
            t0 = time.perf_counter()
            res = sm.match_many(traces)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            check(len(res) == len(traces) and all(r["segments"] for r in res),
                  "sparse path results")
            label = sm.sparse.label_for_trace(traces[0])
            _p, sp, k = sm.sparse.params_for(label)
            n_pts = sum(len(tr["trace"]) for tr in traces)
            rates.append({"cohort": label, "K": k, "vmax": float(sp.vmax),
                          "traces": len(traces), "T": len(traces[0]["trace"]), "s": dt,
                          "traces_per_s": len(traces) / dt, "points_per_s": n_pts / dt})
            print("sparse path (%s) %dx%d, cohort %s, K=%d, vmax %g: %.3f s, %.1f traces/s, "
                  "%.0f points/s" % (what, len(traces), len(traces[0]["trace"]), label, k,
                                     float(sp.vmax), dt, len(traces) / dt, n_pts / dt))

    fwd = {_forward(sm, sm._bucket_len(len(trs[0]["trace"])), False, True)[0][-1]
           for trs in cohorts}
    other = {"viterbi_scan[sparse]", "viterbi_assoc[sparse]"} - fwd
    kernels, absent = _path_kernels(sm, SPARSE_BUCKETED[:-1] + tuple(sorted(fwd)))
    _r, _dt, launches = _counted(kernels, drive, absent + tuple(sorted(other)))
    want = {r["cohort"]: r["traces"] for r in rates}
    check(sm.sparse.dispatch == want, "sparse dispatch counts %s == %s"
          % (sm.sparse.dispatch, want))
    print("sparse path (%s) dispatch per cohort %s, launches %s"
          % (what, json.dumps(sm.sparse.dispatch), json.dumps(launches)))
    for r, xin in zip(rates, xins):
        p, sp, k = sm.sparse.params_for(r["cohort"])
        kern = sm._kernel_for(xin.shape[2])
        got = V.match_batch_compact_packed_aux(sm._dg, sm._du, xin, p, k, sp, sm.probe_dedup,
                                               kern)
        if plain:
            want = V.match_batch_compact_packed_aux_plain(sm._dg, sm._du, xin, p, k, sp,
                                                          kernel=kern)
            check(torch.equal(got[0], want[0]),
                  "sparse packed output equals the plain versions'")
            check(torch.allclose(got[1], want[1], rtol=1e-4, atol=0), "sparse aux")
            print("sparse path (%s) packed [3,%d,%d] K=%d equals the plain composition, aux "
                  "within rtol 1e-4" % (what, xin.shape[1], xin.shape[2], k))
        if base is not None:
            b = V.match_batch_compact_packed_aux(base._dg, base._du, xin, p, k, sp)
            check(torch.equal(got[0], b[0]) and torch.equal(got[1], b[1]),
                  "sparse output equals the %s table's without dedup" % base._du.layout)
            print("sparse path (%s) packed output equals the %s matcher's"
                  % (what, base._du.layout))
    return launches, rates


def sparse_session_path(matcher, traces, label):
    """Cohort ``traces`` (one gap cohort, 8 points each) streamed as
    sessions in 2 steps of 4 points through ``SessionEngine``, the sparse
    model on, through the launch counters.  With host carries every step
    is sparse, and equals the sparse long path with 4-point windows bit
    for bit (``sparse_beam_k`` = 8 there, the sessions' K).  On the slab a
    later step's carry is an ``ArenaRef``, which labels dense, as in the
    reference: step 1 is sparse and step 2 dense, held bit for bit against
    the plain composition of those two steps."""
    import numpy as np

    from reporter_tpu_torch.matching import SessionEngine, SessionStore
    from reporter_tpu_torch.matching.arena import carry_host
    from reporter_tpu_torch.ops import viterbi as V

    cfg = matcher.cfg
    dev = matcher.device
    n, Wn = len(traces), 4
    hm = sparse_matcher(matcher, sparse_beam_k=8, session_arena=False)
    am = sparse_matcher(matcher, sparse_beam_k=8, session_arena=True)

    def stream(m, trs):
        eng = SessionEngine(m, SessionStore(cfg.max_sessions, cfg.session_ttl_s),
                            tail_points=cfg.session_tail_points)
        for j in (0, Wn):
            eng.match_many([dict(tr, trace=tr["trace"][j:j + Wn]) for tr in trs])
        return eng

    out = {}
    for name, m, kernels, per_session in (
            ("host-carry", hm, SPARSE_CARRIED, 2),
            ("slab", am, SPARSE_CARRIED + ("transition_build", "viterbi_chain"), 1)):
        stream(m, [dict(traces[0], uuid="warm")]).store.drop("warm")  # set-up
        m.sparse.dispatch.clear()
        eng, dt, launches = _counted(kernels, lambda: stream(m, traces))
        check(m.sparse.dispatch == {label: per_session * n},
              "%s sessions: sparse steps per cohort %s" % (name, m.sparse.dispatch))
        out[name] = (eng, {"s": dt, "steps_per_s": 2 / dt, "points_per_s": 2 * Wn * n / dt,
                           "dispatch": dict(m.sparse.dispatch), "launches": launches})
        print("sparse session path (%s) %d sessions x 2 steps of %d: %.3f s, sparse steps "
              "%s, launches %s" % (name, n, Wn, dt, json.dumps(m.sparse.dispatch),
                                   json.dumps(launches)))

    host = out["host-carry"][0]
    oracle = sparse_matcher(matcher, sparse_beam_k=8, length_buckets=[Wn])
    (h,) = oracle._dispatch_long(traces, list(range(n)), (), label)
    group, (edge, offset, breaks), _t, _a = oracle._fetch_long_aux(h)
    for row, i in enumerate(group):
        recs = host.store.peek(traces[i]["uuid"]).records
        rec = np.array([(r[0], r[2]) for r in recs])
        off = np.array([r[1] for r in recs], np.float32)
        check(np.array_equal(rec[:, 0], edge[row]) and np.array_equal(rec[:, 1], breaks[row])
              and off.tobytes() == offset[row].tobytes(),
              "sparse host-carry sessions equal the 4-point-window sparse long path")

    slab = out["slab"][0]
    dg, du, K = am._dg, am._du, cfg.beam_k
    p_sp, sp, _k = am.sparse.params_for(label)
    xs = [session_rows(am, traces, j, Wn, pad=0) for j in (0, Wn)]
    pk0, _a0, c1 = V.session_step_packed_plain(dg, du, xs[0], p_sp, K,
                                               V.initial_carry_batch(n, K, dev), sp)
    pk1, _a1, c2 = V.session_step_packed_plain(dg, du, xs[1], am._params, K, c1)
    steps = [V.unpack_compact(pk.cpu().numpy()) for pk in (pk0, pk1)]
    leaves = {f: t.cpu().numpy() for f, t in zip(V.TraceCarry._fields, c2)}
    for row, tr in enumerate(traces):
        s = slab.store.peek(tr["uuid"])
        rec = np.array([(r[0], r[2]) for r in s.records])
        off = np.array([r[1] for r in s.records], np.float32)
        e = np.concatenate([st[0][row] for st in steps])
        o = np.concatenate([st[1][row] for st in steps])
        b = np.concatenate([st[2][row] for st in steps])
        check(np.array_equal(rec[:, 0], e) and np.array_equal(rec[:, 1], b)
              and off.tobytes() == o.tobytes(),
              "slab sessions equal the plain sparse step then the plain dense step")
        beam = carry_host(s.carry)
        check(all(np.asarray(beam[f]).tobytes() == leaves[f][row].tobytes()
                  for f in leaves), "slab beam equals the plain composition's")
    print("sparse session path: %d sessions' records equal the 4-point-window sparse long "
          "path (host carries) and the plain sparse-then-dense steps (slab, beams too)" % n)
    return ({k: v[1] for k, v in out.items()},
            {k: v[1]["launches"] for k, v in out.items()})


def sparse_serve_phase(matcher, traces):
    """8 /report requests of a sparse cohort on the serving matcher built
    as serve/__main__.py builds it (the sparse model on by default),
    through the launch counters; each answer's segments equal those the
    plain composition gives through the same association."""
    from reporter_tpu_torch.device import upload
    from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
    from reporter_tpu_torch.ops import viterbi as V
    from reporter_tpu_torch.serve.__main__ import serving_defaults

    sv = SegmentMatcher(arrays=matcher.arrays, ubodt=matcher.ubodt,
                        config=serving_defaults(MatcherConfig()), device=matcher.device)
    check(sv.sparse.enabled and sv.session_arena is not None, "serving defaults")
    requests = traces[:8]
    kernels, absent = _path_kernels(sv, SPARSE_BUCKETED)
    (answers,), dt, launches = _counted(kernels, lambda: _serve(sv, 15, requests), absent)
    label = sv.sparse.label_for_trace(requests[0])
    check(sv.sparse.dispatch == {label: len(requests)},
          "served traces dispatched sparse: %s" % sv.sparse.dispatch)
    idxs = list(range(len(requests)))
    T = sv._bucket_len(len(requests[0]["trace"]))
    px, py, tm, valid, times = sv._fill_rows(requests, idxs, T)
    p, sp, k = sv.sparse.params_for(label)
    packed, aux = V.match_batch_compact_packed_aux_plain(
        sv._dg, sv._du, upload(V.pack_inputs(px, py, tm, valid), sv.device), p, k, sp)
    results = [None] * len(requests)
    sv._associate_and_store(idxs, *V.unpack_compact(packed.cpu().numpy()), times, results,
                            aux=aux.cpu().numpy())
    for (code, body), r in zip(answers, results):
        check(code == 200, "sparse /report status %s" % code)
        check(body["segment_matcher"]["segments"] == json.loads(json.dumps(r["segments"])),
              "sparse /report segments equal the plain composition's")
    print("serve sparse: 8 /report of cohort %s answered 200 in %.2f s, K=%d, equal to the "
          "plain composition, dispatch %s, launches %s"
          % (label, dt, k, json.dumps(sv.sparse.dispatch), json.dumps(launches)))
    return launches, answers


# -- the UBODT memory system: wide32 layout, probe dedup, probe diagnostic ----

def wide_table(matcher):
    """The metro cuckoo table repacked into the wide32 layout (rows
    extracted, native single-hash packer), with its size and time."""
    from reporter_tpu_torch import native

    t0 = time.perf_counter()
    uw = matcher.ubodt.relayout("wide32", lib=native.require_lib())
    info = {"rows": int(uw.num_rows), "buckets": int(uw.n_buckets),
            "mb": uw.packed.nbytes / 1e6, "relayout_s": time.perf_counter() - t0,
            "cuckoo_mb": matcher.ubodt.packed.nbytes / 1e6}
    check(uw.layout == "wide32" and uw.num_rows == matcher.ubodt.num_rows, "wide32 relayout")
    print("wide32 table: %(rows)d rows in %(buckets)d buckets x 1 KB = %(mb).1f MB "
          "(cuckoo %(cuckoo_mb).1f MB), relayout %(relayout_s).1f s" % info)
    return uw, info


def memory_matcher(matcher, ubodt_w, probe_every=0, **cfg_kw):
    """A matcher over ``matcher``'s city on the wide32 table with probe
    dedup (``cfg_kw`` on top), sampling the probe diagnostic every
    ``probe_every``-th dense bucketed dispatch."""
    from dataclasses import replace

    from reporter_tpu_torch.matching import SegmentMatcher

    saved = os.environ.pop("REPORTER_OBS_PROBE_EVERY", None)
    os.environ["REPORTER_OBS_PROBE_EVERY"] = str(probe_every)
    try:
        mw = SegmentMatcher(arrays=matcher.arrays, ubodt=ubodt_w, device=matcher.device,
                            config=replace(matcher.cfg, ubodt_layout="wide32",
                                           probe_dedup=True, **cfg_kw))
    finally:
        os.environ.pop("REPORTER_OBS_PROBE_EVERY", None)
        if saved is not None:
            os.environ["REPORTER_OBS_PROBE_EVERY"] = saved
    check(mw._du.wide and mw.probe_dedup and mw._probe_every == probe_every,
          "wide32 + dedup matcher")
    return mw


def _same(a, b):
    """Two result tuples equal element for element (None only matching
    None)."""
    import torch

    return all(x is y is None or (x is not None and y is not None and torch.equal(x, y))
               for x, y in zip(a, b))


def long_pre_rows(matcher, traces):
    """The long path's pre input of a cohort: the windows of every trace
    folded into the batch as chunk-major rows, [4, n_chunks * B, W]."""
    import torch

    from reporter_tpu_torch.ops import viterbi as V

    W, B = matcher.max_trace_points, len(traces)
    n_chunks = -(-max(len(t["trace"]) for t in traces) // W)
    px, py, tm, valid, _t = matcher._fill_rows(traces, list(range(B)), n_chunks * W)
    x = V.pack_inputs(px, py, tm, valid).reshape(4, B, n_chunks, W).transpose(0, 2, 1, 3)
    return torch.from_numpy(x.reshape(4, n_chunks * B, W).copy()).to(matcher.device)


def memory_phases(matcher, du_w, xin, timed, p=None, K=None, what=""):
    """Kernel 2's wide32 instantiation and the dedup kernels at one of the
    main path's shapes (the packed [4, B, T] input ``xin``): the sweep's
    [B, T-1, K, K] key grid probed on the wide32 table against its plain
    version and against the cuckoo kernel on the same keys (same content,
    same answers), then the deduplicated probe (claim, probe, scatter) in
    both layouts against the plain full-width probe, its distinct count
    against the plain count.  ``timed``: also time each new kernel beside
    its bound, its plain version and the library call, and the end-to-end
    dedup probe beside kernel 2 alone, in both layouts."""
    import torch

    from reporter_tpu_torch.ops import hashtable as H
    from reporter_tpu_torch.ops import viterbi as V
    from reporter_tpu_torch.ops.candidates import candidate_sweep

    K = K or matcher.cfg.beam_k
    p = p or matcher._params
    dev, du_c = matcher.device, matcher._du
    x, y, _t, v = V.unpack_inputs(xin)
    B, T = x.shape
    sw = candidate_sweep(matcher._dg, x, y, v, K, p.search_radius, p.sigma_z, False)
    a, b = sw.to_node[:, :-1, :, None], sw.from_node[:, 1:, None, :]
    w1, w0 = H.ubodt_lookup(du_w, a, b), H.ubodt_lookup_plain(du_w, a, b)
    check(_same(w1, w0), "ubodt_probe[wide32] %s" % what)
    c1 = H.ubodt_lookup(du_c, a, b)
    check(_same(w1, c1), "ubodt_probe[wide32] equals the cuckoo kernel on the same keys")
    sa, sb = torch.broadcast_tensors(a, b)
    N = sa.numel()
    plain_u = int(H.ubodt_lookup_dedup_plain(du_w, a, b).n_unique[0])
    out = {"shape": "%dx%d K=%d" % (B, T, K), "n": N,
           "wide_err": max_abs_err(zip(w1, w0)), "dedup_err": 0.0}
    for layout, du, full in (("cuckoo", du_c, c1), ("wide32", du_w, w1)):
        for with_first in (True, False):
            d = H.ubodt_lookup_dedup(du, a, b, with_first)
            check(_same(d[:3], full[:2] + (full[2] if with_first else None,)),
                  "dedup probe (%s) equals the full-width probe %s" % (layout, what))
        n_unique = int(d.n_unique[0])
        check(n_unique == plain_u and n_unique <= d.m,
              "dedup distinct count %d == plain %d, within the budget %d"
              % (n_unique, plain_u, d.m))
        out[layout] = {"m": d.m, "n_unique": n_unique, "ratio": N / n_unique}
    check(int(H.count_distinct_pairs(a, b, torch.ones((), dtype=torch.bool, device=dev)))
          == plain_u, "count_distinct_pairs")
    print("memory %s %s: n %d, m %d, n_unique %d, n / n_unique %.2f; wide32 probe, dedup "
          "(both layouts) and the distinct count exact"
          % (what, out["shape"], N, out["wide32"]["m"], plain_u, N / plain_u))
    if not timed or dev.type != "cuda":
        return out, []

    P = B * T
    m = out["wide32"]["m"]
    cnt = torch.empty(1, dtype=torch.int32, device=dev)
    claim = H._claim(sa, sb, None, m, cnt)
    compact = H._probe(du_w, claim[2], claim[3], False, n_live=cnt)
    key64 = H._pair_keys(sa.reshape(-1), sb.reshape(-1))
    uniq, inv = torch.unique(key64, return_inverse=True)
    lo = ((uniq & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    cd, ct, _ = H.ubodt_lookup_plain(du_w, (uniq >> 32).to(torch.int32), lo.to(torch.int32),
                                     False)
    wb = int(torch.unique(H.device_pair_hash(sa.reshape(-1), sb.reshape(-1),
                                             du_w.bmask)).numel())
    U = plain_u

    def compose():
        """The closest PyTorch composition of the scatter (three calls, not
        one): each key's compact index, then the results at it."""
        idx = torch.index_select(claim[1], 0, claim[0])
        return [torch.index_select(c, 0, idx).reshape(sa.shape) for c in compact[:2]]
    check(_bits_equal(compose(), H._scatter(du_w, sa, sb, claim, cnt, m, compact)[:2]),
          "the scatter's PyTorch composition equals the kernel")
    rows = [
        # reads: the two [B, T, K] key arrays, each distinct 1 KB bucket row
        # once; writes: dist and time.  ~30 integer operations per probe.
        dict(name="ubodt_probe[wide32]", source="reporter_tpu_torch/csrc/ubodt_probe.cu",
             replaces="reporter_tpu/ops/hashtable.py:144",
             fn=lambda: H.ubodt_lookup(du_w, a, b, False),
             plain=lambda: H.ubodt_lookup_plain(du_w, a, b, False), cold_l2=True,
             nbytes=8 * P * K + 1024 * wb + 8 * N, nops=30 * N, distinct_rows=wb,
             library=None),
        # reads: the key arrays; writes: each key's slot, the distinct keys
        # and their compact indices.  ~25 integer operations per key.
        dict(name="ubodt_dedup_claim", source="reporter_tpu_torch/csrc/ubodt_dedup.cu",
             replaces="reporter_tpu/ops/hashtable.py:160",
             fn=lambda: H._claim(sa, sb, None, m, cnt),
             plain=lambda: torch.unique(H._pair_keys(sa.reshape(-1), sb.reshape(-1)),
                                        return_inverse=True),
             cold_l2=True, nbytes=8 * P * K + 4 * N + 12 * U, nops=25 * N,
             library=lambda: torch.unique(key64, return_inverse=True)),
        # reads: each key's slot, the distinct slots' compact indices and
        # results; writes: dist and time.
        dict(name="ubodt_dedup_scatter", source="reporter_tpu_torch/csrc/ubodt_dedup.cu",
             replaces="reporter_tpu/ops/hashtable.py:198",
             fn=lambda: H._scatter(du_w, sa, sb, claim, cnt, m, compact),
             plain=lambda: [r[inv].reshape(sa.shape) for r in (cd, ct)], cold_l2=False,
             nbytes=4 * N + 12 * U + 8 * N, nops=4 * N, library=None, composition=compose),
    ]
    for r in rows:
        r["bound_ms"], r["bound_by"] = bound(r.pop("nbytes"), r.pop("nops"))
        r["ms"] = time_ms(r["fn"], cold_l2=r["cold_l2"],
                          label="%s %s" % (r["name"], out["shape"]))
        r["plain_ms"] = time_ms(r["plain"], cold_l2=r["cold_l2"], queued=False)
        r["library_ms"] = (None if r["library"] is None
                           else time_ms(r["library"], cold_l2=True, queued=False))
        if "composition" in r:  # timed as the kernel is: device time, L2 warm
            r["composition_ms"] = time_ms(r.pop("composition"), cold_l2=r["cold_l2"])
        r["max_abs_err"] = 0.0
        print("kernel %-25s %s kernel_ms=%.4f plain_ms=%.4f library_ms=%s bound_ms=%.4f (%s)%s"
              % (r["name"], out["shape"], r["ms"], r["plain_ms"],
                 "-" if r["library_ms"] is None else "%.4f" % r["library_ms"], r["bound_ms"],
                 r["bound_by"], " composition_ms=%.4f" % r["composition_ms"]
                 if "composition_ms" in r else ""))
    e2e = {}
    for layout, du in (("cuckoo", du_c), ("wide32", du_w)):
        e2e[layout] = {
            "probe_ms": time_ms(lambda: H.ubodt_lookup(du, a, b, False), cold_l2=True,
                                label="%s %s" % (H.probe_kernel_name(du), out["shape"])),
            "dedup_ms": time_ms(lambda: H.ubodt_lookup_dedup(du, a, b, False), cold_l2=True,
                                label="dedup probe %s %s" % (layout, out["shape"])),
            "compact_probe_ms": time_ms(
                lambda: H._probe(du, claim[2], claim[3], False, n_live=cnt), cold_l2=True,
                label="dedup compact probe %s %s" % (layout, out["shape"]))}
        print("memory %s %s: kernel 2 alone %.4f ms, dedup probe (claim + probe + scatter) "
              "%.4f ms, its compact probe %.4f ms"
              % (layout, out["shape"], e2e[layout]["probe_ms"], e2e[layout]["dedup_ms"],
                 e2e[layout]["compact_probe_ms"]))
    out["timing"] = e2e
    return out, rows


def dedup_fallback(matcher, du_w, n):
    """The port of tests/test_ubodt.py's overflow case: ``n`` all-distinct
    keys (the metro table's first n rows, all hits), more than the budget,
    through the deduplicated probe in both layouts: bit for bit the plain
    probe's answers, the fallback reported and counted."""
    import torch

    from reporter_tpu_torch.ops import hashtable as H

    rows = matcher.ubodt.rows()
    s = torch.from_numpy(rows[0][:n]).to(matcher.device)
    d = torch.from_numpy(rows[1][:n]).to(matcher.device)
    out = {}
    for layout, du in (("cuckoo", matcher._du), ("wide32", du_w)):
        H.DEDUP.reset()
        got = H.ubodt_lookup(du, s, d, dedup=True)
        check(_same(got, H.ubodt_lookup_plain(du, s, d)),
              "dedup fallback (%s) equals the plain probe" % layout)
        summ = H.DEDUP.summary()
        n_unique = summ["last"][2]
        check(summ["dedup_fallbacks"] == 1 and n_unique > summ["last"][1],
              "the fallback was taken and counted: %s" % summ)
        out[layout] = {"n": n, "m": summ["last"][1], "n_unique_at_least": n_unique,
                       "dedup_fallbacks": summ["dedup_fallbacks"]}
        if matcher.device.type == "cuda":  # the claim and the whole probe, fallen back
            m, cnt = summ["last"][1], torch.empty(1, dtype=torch.int32, device=s.device)
            out[layout]["claim_ms"] = time_ms(lambda: H._claim(s, d, None, m, cnt), cold_l2=True,
                                              label="ubodt_dedup_claim fallback %d" % n)
            out[layout]["dedup_ms"] = time_ms(lambda: H.ubodt_lookup_dedup(du, s, d, False),
                                              cold_l2=True,
                                              label="dedup probe fallback %s %d" % (layout, n))
            fn, got_s = scatter_launch(du, s, d, m)  # the fused full-width probe
            check(_bits_equal(got_s[:2], got[:2]), "scatter fallback (%s) equals the probe"
                  % layout)
            out[layout]["scatter_ms"] = time_ms(
                fn, cold_l2=True, label="ubodt_dedup_scatter fallback %s %d" % (layout, n))
        print("dedup fallback %s: %d all-distinct keys, m %d, distinct count > m (%d when the "
              "claim stopped), full-width probe on the card, equal to the plain probe"
              % (layout, n, summ["last"][1], n_unique))
    return out


def stats_phases(matcher, du_w, xin, xin_a, timed):
    """``probe_stats`` against its plain version: ``ubodt_probe_stats`` at
    512 x 64 in both layouts (identical counts), the kernel's counts and
    mask alone, timed; then on cohort A with a table of the metro rows
    within 400 m and delta 400, where beyond-delta misses exist.  Returns
    (the counts, the timed row, the 400 m table on the device)."""
    import torch

    from reporter_tpu_torch import native
    from reporter_tpu_torch.ops import viterbi as V
    from reporter_tpu_torch.ops.candidates import candidate_sweep
    from reporter_tpu_torch.ops.diagnostics import (
        probe_outcomes, probe_outcomes_plain, ubodt_probe_stats, ubodt_probe_stats_plain,
    )
    from reporter_tpu_torch.ops.hashtable import ubodt_lookup
    from reporter_tpu_torch.tiles.ubodt import ubodt_from_columns

    dg, p, K = matcher._dg, matcher._params, matcher.cfg.beam_k
    delta = float(matcher.cfg.ubodt_delta)
    got = {}
    for layout, du in (("cuckoo", matcher._du), ("wide32", du_w)):
        s1 = ubodt_probe_stats(dg, du, xin, p, K, delta).cpu()
        s0 = ubodt_probe_stats_plain(dg, du, xin, p, K, delta).cpu()
        check(torch.equal(s1, s0), "probe_stats (%s): %s == %s" % (layout, s1, s0))
        got[layout] = s1.tolist()
    check(got["cuckoo"] == got["wide32"], "probe stats equal in both layouts")
    x, y, _t, v = V.unpack_inputs(xin)
    B, T = x.shape
    sw = candidate_sweep(dg, x, y, v, K, p.search_radius, p.sigma_z, False)
    dist = ubodt_lookup(matcher._du, sw.to_node[:, :-1, :, None],
                        sw.from_node[:, 1:, None, :], False)[0]
    args = (dist, sw.cand.edge, v, x, y, p.breakage_distance, delta)
    k1, k0 = probe_outcomes(*args), probe_outcomes_plain(*args)
    check(torch.equal(k1[0][:4].cpu(), k0[0].cpu()) and torch.equal(k1[1].bool(), k0[1]),
          "probe_stats counts and need mask")

    rows = matcher.ubodt.rows()
    keep = rows[2] <= 400.0
    cut = ubodt_from_columns(*(c[keep] for c in rows), 400.0,
                             lib=native.require_lib()).to_device(matcher.device)
    c1 = ubodt_probe_stats(dg, cut, xin_a, p, K, 400.0).cpu()
    c0 = ubodt_probe_stats_plain(dg, cut, xin_a, p, K, 400.0).cpu()
    check(torch.equal(c1, c0) and int(c1[3]) > 0,
          "probe_stats with delta 400 (beyond-delta misses): %s == %s" % (c1, c0))
    got["A_delta400"] = c1.tolist()
    print("probe_stats 512x64 (both layouts) %s; cohort A on the 400 m table %s "
          "(pairs, miss, costly, beyond delta, distinct): equal to the plain version"
          % (got["cuckoo"], got["A_delta400"]))
    row = None
    if timed and matcher.device.type == "cuda":
        N, P = dist.numel(), B * T
        # reads: dist, the candidates' edges, valid/px/py; writes: the need
        # mask and the counts.  ~12 operations per pair.
        bms, bby = bound(4 * N + 4 * P * K + 12 * P + N + 20, 12 * N)
        row = dict(name="probe_stats", source="reporter_tpu_torch/csrc/probe_stats.cu",
                   replaces="reporter_tpu/ops/diagnostics.py:24",
                   ms=time_ms(lambda: probe_outcomes(*args),
                              label="probe_stats %dx%d K=%d" % (B, T, K)),
                   plain_ms=time_ms(lambda: probe_outcomes_plain(*args), queued=False),
                   bound_ms=bms, bound_by=bby, library_ms=None, max_abs_err=max_abs_err(
                       [(k1[0][:4], k0[0]), (k1[1], k0[1].to(torch.uint8))]))
        print("kernel %-25s %dx%d K=%d kernel_ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s)"
              % ("probe_stats", B, T, K, row["ms"], row["plain_ms"], bms, bby))
    return got, row, cut


def memory_serve_phase(arrays, ubodt_w, tr_a, default_answers, default_fixtures, device):
    """The 8 /report of cohort A and the fixture replay with
    $REPORTER_UBODT_LAYOUT=wide32 and $REPORTER_PROBE_DEDUP=1 on the
    serving defaults: the same answers as under the defaults."""
    from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
    from reporter_tpu_torch.serve.__main__ import serving_defaults

    env = {"REPORTER_UBODT_LAYOUT": "wide32", "REPORTER_PROBE_DEDUP": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        sv = SegmentMatcher(arrays=arrays, ubodt=ubodt_w,
                            config=serving_defaults(MatcherConfig()), device=device)
        check(sv._du.wide and sv.probe_dedup, "the environment selects wide32 and dedup")
        kernels, absent = _path_kernels(sv, SPARSE_BUCKETED)
        (answers,), dt, launches = _counted(kernels, lambda: _serve(sv, 15, tr_a[:8]),
                                            absent)
        check(answers == default_answers, "/report answers equal the defaults'")
        fixtures = replay_fixtures(device, "REPORTER_UBODT_LAYOUT=wide32 REPORTER_PROBE_DEDUP=1")
        check(fixtures == default_fixtures, "fixture answers equal the defaults'")
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    print("serve wide32 + dedup (environment): 8 /report of cohort A in %.2f s and the 6 "
          "fixtures answered as under the defaults, launches %s" % (dt, json.dumps(launches)))
    return launches


def _assoc_ops(T, K):
    """Adds and compares of the log-depth forward over one trace of T points
    at K: level 0's maps, every up- and down-sweep combine (K^2 map entries
    and K restart entries, K add-compare pairs each), the scores and the
    backpointers from the prefixes, the alive recursion."""
    n = T - 1
    levels = [n]
    while levels[-1] >= 2:
        levels.append(levels[-1] // 2)
    combines = sum(c // 2 for c in levels[:-1]) + sum((c - 1) // 2 for c in levels[:-1])
    return (K * K * n + combines * 2 * K * (K * K + K) + 2 * 2 * K * K * n + 2 * K * n)


def assoc_phases(matcher, xin, timed, p=None, K=None, sp=None, flip=False):
    """The log-depth kernel ``viterbi_assoc`` (its sparse instantiation
    with ``sp``) against its plain version at one of the main path's
    shapes (the packed [4, B, T] input ``xin``; kernels 1-3 give its
    inputs, held on the same input by ``kernel_phases``): packed output bit
    for bit, aux rtol 1e-4.  Prints how many traces the scan kernel decodes
    otherwise on the same input (the reference expects 0, near ties
    aside).  ``timed``: the kernel, the scan kernel and the plain version
    timed beside the bound.  ``flip`` (a ``gap_flip`` input): the sparse
    breaks must differ from the dense instantiation's."""
    import torch

    from reporter_tpu_torch.ops import viterbi as V

    B, T = xin.shape[1], xin.shape[2]
    K = K or matcher.cfg.beam_k
    p = p or matcher._params
    tag = "" if sp is None else "[sparse]"
    pre = V.precompute_batch_packed(matcher._dg, matcher._du, xin, p, K, sp)
    _x, _y, t, v = V.unpack_inputs(xin)
    args = (pre.emis, pre.logp, pre.gc, v, pre.cand.edge, pre.cand.offset,
            p.breakage_distance, t, sp)
    ka = V.viterbi_scan(*args, kernel="assoc")
    pa = V.viterbi_scan_plain(*args, kernel="assoc")
    check(torch.equal(ka[0], pa[0]), "viterbi_assoc%s packed %dx%d" % (tag, B, T))
    check(torch.allclose(ka[1], pa[1], rtol=1e-4, atol=0), "viterbi_assoc%s aux" % tag)
    ks = V.viterbi_scan(*args)
    differ = int((ka[0] != ks[0]).any(0).any(1).sum())
    P, N = B * T, B * (T - 1) * K * K
    # bytes as kernel 4's at this shape; operations those the log-depth
    # forward does
    b, by = bound(4 * P * K + 4 * N + 4 * B * (T - 1) + 4 * P + 12 * P + 12 * P + 16 * B
                  + (0 if sp is None else 4 * P), B * _assoc_ops(T, K))
    row = dict(name="viterbi_assoc" + tag, route="cuda",
               source="reporter_tpu_torch/csrc/viterbi_assoc.cu",
               replaces="reporter_tpu/ops/viterbi.py:674", shape="%dx%d K=%d" % (B, T, K),
               max_abs_err=max_abs_err([(ka[0], pa[0])]),
               aux_max_abs_err=max_abs_err([(ka[1], pa[1])]), bound_ms=b, bound_by=by,
               traces_differing_from_scan=differ)
    if flip:
        kd = V.viterbi_scan(*args[:-1], None, kernel="assoc")
        row["breaks_flipped"] = int((kd[0][2] != ka[0][2]).sum())
        check(row["breaks_flipped"] > 0, "viterbi_assoc%s: the per-step gap-conditioned "
              "breakage changed breaks against the dense threshold" % tag)
    if timed and matcher.device.type == "cuda":
        row["ms"] = time_ms(lambda: V.viterbi_scan(*args, kernel="assoc"),
                            label="viterbi_assoc%s %s" % (tag, row["shape"]))
        row["scan_ms"] = time_ms(lambda: V.viterbi_scan(*args),
                                 label="viterbi_scan%s %s (assoc's inputs)" % (tag, row["shape"]))
        row["plain_ms"] = time_ms(lambda: V.viterbi_scan_plain(*args, kernel="assoc"),
                                  queued=False)
    print("kernel %-27s %-16s max_abs_err=%-9.3g kernel_ms=%s viterbi_scan_ms=%s plain_ms=%s "
          "bound_ms=%.4f (%s)%s; %d traces decode otherwise under the scan; within "
          "tolerance: packed exact, aux rtol 1e-4"
          % (row["name"], row["shape"], row["max_abs_err"],
             *("%.4f" % row[k] if k in row else "-" for k in ("ms", "scan_ms", "plain_ms")),
             b, by, ", %d breaks flipped" % row["breaks_flipped"] if flip else "", differ))
    return row


def crossover(matcher, traces64, traces256):
    """The H100's scan-versus-assoc crossover: ``viterbi_scan`` and
    ``viterbi_assoc`` timed on the same inputs at T = 16 (the 512 x 64
    cohort cut to 16 points), 64 (512 x 64) and 256 (128 x 256), at K = 8
    and 16 (dense precompute at that K), each held equal first."""
    import torch

    from reporter_tpu_torch.ops import viterbi as V

    xins = {16: bucket_rows(matcher, [dict(t, trace=t["trace"][:16]) for t in traces64], 16),
            64: bucket_rows(matcher, traces64, 64), 256: bucket_rows(matcher, traces256, 256)}
    p = matcher._params
    out = []
    for K in (8, 16):
        for T, xin in xins.items():
            pre = V.precompute_batch_packed(matcher._dg, matcher._du, xin, p, K)
            _x, _y, _t, v = V.unpack_inputs(xin)
            args = (pre.emis, pre.logp, pre.gc, v, pre.cand.edge, pre.cand.offset,
                    p.breakage_distance)
            a = V.viterbi_scan(*args, kernel="assoc")
            check(torch.equal(a[0], V.viterbi_scan_plain(*args, kernel="assoc")[0]),
                  "viterbi_assoc at %dx%d K=%d" % (xin.shape[1], T, K))
            r = {"B": xin.shape[1], "T": T, "K": K}
            out.append(r)
            if matcher.device.type != "cuda":
                continue
            shape = "%dx%d K=%d (crossover)" % (r["B"], T, K)
            r["scan_ms"] = time_ms(lambda: V.viterbi_scan(*args), label="viterbi_scan " + shape)
            r["assoc_ms"] = time_ms(lambda: V.viterbi_scan(*args, kernel="assoc"),
                                    label="viterbi_assoc " + shape)
            print("crossover %dx%d K=%d: viterbi_scan %.4f ms, viterbi_assoc %.4f ms (%.2fx)"
                  % (r["B"], T, K, r["scan_ms"], r["assoc_ms"], r["assoc_ms"] / r["scan_ms"]))
    return out


def _differing(a, b):
    """How many rows of two (edge, offset, breaks) results differ."""
    import numpy as np

    return int(sum(not (np.array_equal(x[0], y[0]) and x[1].tobytes() == y[1].tobytes()
                        and np.array_equal(x[2], y[2]))
                   for x, y in zip(zip(*a), zip(*b))))


def assoc_paths(matcher, sm, traces64, traces256, traces2048, tr_a, tr_l, xins, xin_a):
    """Every path through a matcher with ``viterbi_kernel="assoc"``, each
    through the launch counters (the assoc kernels launch, the scan and
    chain kernels do not) and held against the plain composition of the
    assoc forward: bucketed (512 x 64, 128 x 256), long (64 x 2,048),
    sessions (128 sessions x 4 steps of 4, slab == host carries == the
    4-point-window long path), sparse A and L.  Then one ``"auto"``
    matcher: 512 x 64 takes the scan kernel, 128 x 256 and the long
    windows the assoc kernels.  Counts the traces each path decodes
    otherwise than the scan matcher."""
    from dataclasses import replace

    from reporter_tpu_torch.matching import SegmentMatcher

    def with_kernel(m, kernel):
        return SegmentMatcher(arrays=m.arrays, ubodt=m.ubodt, device=m.device,
                              config=replace(m.cfg, viterbi_kernel=kernel))

    am = with_kernel(matcher, "assoc")
    out = {"launches": {}, "differing": {}}
    out["launches"]["bucketed"], out["bucketed"] = main_path(am, [traces64, traces256], xins)
    out["launches"]["long"], out["long"] = long_path(am, traces2048)
    short = [dict(t, trace=t["trace"][:16]) for t in traces64[:128]]
    _am, out["launches"]["session"], out["session"] = session_path(am, short)
    sam = sparse_matcher(am)
    out["launches"]["sparse_bucketed"], out["sparse"] = sparse_main_path(
        sam, [tr_a], [xin_a], "assoc")
    out["launches"]["sparse_long"], out["sparse_long"] = long_path(sam, tr_l, "ge60")

    for name, (m0, m1, trs, slabel) in {
            "512x64": (matcher, am, traces64, ""), "128x256": (matcher, am, traces256, ""),
            "long": (matcher, am, traces2048, ""), "sparse A": (sm, sam, tr_a, "45-60"),
            "sparse L": (sm, sam, tr_l, "ge60")}.items():
        got = []
        for m in (m0, m1):
            if len(trs[0]["trace"]) > m.max_trace_points:
                (h,) = m._dispatch_long(trs, list(range(len(trs))), (), slabel)
                got.append(m._fetch_long_aux(h)[1])
            else:
                T = m._bucket_len(len(trs[0]["trace"]))
                px, py, tm, valid, _t = m._fill_rows(trs, list(range(len(trs))), T)
                got.append(m._collect_batch(m._dispatch_batch(px, py, tm, valid, (),
                                                              slabel))[0])
        out["differing"][name] = _differing(*got)
    print("assoc vs scan matcher: traces decoded otherwise %s (the reference expects 0, "
          "near ties aside)" % json.dumps(out["differing"]))

    auto = SegmentMatcher(arrays=matcher.arrays, ubodt=matcher.ubodt, device=matcher.device,
                          config=replace(matcher.cfg, viterbi_kernel="auto"))
    check(auto._kernel_for(64) == "scan" and auto._kernel_for(256) == "assoc",
          "auto: the threshold at 256")
    auto.match_many(traces64[:4])
    runs = {}
    for what, trs, path, other in (
            ("512x64", traces64, BUCKETED, ("viterbi_assoc",)),
            ("128x256", traces256, BUCKETED[:-1] + ("viterbi_assoc",), ("viterbi_scan",)),
            ("long", traces2048, CARRIED[:-1] + ("viterbi_chain_assoc",), ("viterbi_chain",))):
        _r, _dt, runs[what] = _counted(path, lambda: auto.match_many(trs), other)
    out["launches"]["auto"] = runs
    print("auto: 512x64 launched viterbi_scan %d, viterbi_assoc %d; 128x256 viterbi_assoc %d, "
          "viterbi_scan %d; long viterbi_chain_assoc %d, viterbi_chain %d"
          % (runs["512x64"]["viterbi_scan"], runs["512x64"]["viterbi_assoc"],
             runs["128x256"]["viterbi_assoc"], runs["128x256"]["viterbi_scan"],
             runs["long"]["viterbi_chain_assoc"], runs["long"]["viterbi_chain"]))
    return out


def assoc_serve_phase(matcher, traces, device):
    """Serve under $REPORTER_VITERBI=assoc: 8 /report of the 512 x 64 cohort
    through the launch counters on the serving defaults (the assoc kernel,
    not the scan), each answer's segments equal to the assoc matcher's
    match(), then the 6 recorded fixtures replayed equal."""
    from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
    from reporter_tpu_torch.serve.__main__ import serving_defaults

    saved = os.environ.get("REPORTER_VITERBI")
    os.environ["REPORTER_VITERBI"] = "assoc"
    try:
        sv = SegmentMatcher(arrays=matcher.arrays, ubodt=matcher.ubodt,
                            config=serving_defaults(MatcherConfig()), device=device)
        check(sv._kernel_mode == "assoc", "serve under REPORTER_VITERBI=assoc")
        requests = traces[:8]
        (answers,), dt, launches = _counted(
            BUCKETED[:-1] + ("viterbi_assoc",), lambda: _serve(sv, 15, requests),
            ("viterbi_scan",))
        want = sv.match_many(requests)
        for (code, body), w in zip(answers, want):
            check(code == 200 and body["segment_matcher"]["segments"]
                  == json.loads(json.dumps(w["segments"])), "assoc /report equals match()")
        print("serve assoc: 8 /report answered 200 in %.2f s, equal to match(), launches %s"
              % (dt, json.dumps(launches)))
        replay_fixtures(device, "REPORTER_VITERBI=assoc")
    finally:
        if saved is None:
            os.environ.pop("REPORTER_VITERBI", None)
        else:
            os.environ["REPORTER_VITERBI"] = saved
    return launches


# -- 9. the tiered UBODT and the session arena's cold tier -----------------------

TIER_PARTIAL = 64 << 20  # the partial hot budget (about half the cohort's rows)


# PCIe per-lane rate (GT/s) and line-code efficiency by generation
PCIE_LANE = {1: (2.5, 8 / 10), 2: (5.0, 8 / 10), 3: (8.0, 128 / 130), 4: (16.0, 128 / 130),
             5: (32.0, 128 / 130), 6: (64.0, 242 / 256)}


def host_link(dev):
    """The host link: its peak rate per direction, bytes/s, from the PCIe
    generation and width nvidia-smi reports (Gen5 x16, the H100 SXM5's
    host interface, where it reports none), the bound's denominator; and
    its measured rate, a pinned -> device copy of 256 MiB (median of 5),
    a reading beside it."""
    import torch

    if dev.type != "cuda":
        return None
    q = "pcie.link.gen.max,pcie.link.width.max,pcie.link.gen.current,pcie.link.width.current"
    got = subprocess.run(["nvidia-smi", "--query-gpu=" + q, "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout
    try:
        gen, width, gen_now, width_now = (int(x) for x in got.splitlines()[0].split(","))
        spec = "nvidia-smi"
    except (ValueError, IndexError):
        gen, width, gen_now, width_now, spec = 5, 16, None, None, "assumed (nvidia-smi: %r)" % got
    rate, code = PCIE_LANE[gen]
    peak = rate * 1e9 * width * code / 8
    src = torch.empty(64 << 20, dtype=torch.int32, pin_memory=True)
    dst = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    ms = time_ms(lambda: dst.copy_(src, non_blocking=True), reps=5, warmup=1, queued=False)
    copy = src.numel() * 4 / (ms / 1e3)
    print("host link: PCIe Gen%d x%d (%s; now Gen%s x%s), peak %.2f GB/s per direction; "
          "pinned -> device copy of 256 MiB in %.3f ms = %.2f GB/s (%.1f %% of peak)"
          % (gen, width, spec, gen_now, width_now, peak / 1e9, ms, copy / 1e9,
             100 * copy / peak))
    return {"gen": gen, "width": width, "source": spec, "gen_now": gen_now,
            "width_now": width_now, "peak_bytes_per_s": peak, "copy_bytes_per_s": copy,
            "copy_ms": ms}


def tier_table(ubodt, budget, dev, keys=None):
    """A TieredTable of ``ubodt`` at ``budget`` bytes on ``dev``; with
    ``keys`` (a, b) one tiered probe of them then one maintenance pass,
    and on the card that pass and a second one after another probe of
    the keys timed (host clock, the card idle before and after: the cost
    on the collect thread).  On the card, the memory check: the tier's
    device allocations are at
    most its arena, slot map and counters plus 1 MiB, and the pages are
    host memory, page-locked (CUDA's memory type 1)."""
    import torch

    from reporter_tpu_torch.ops import _kernels
    from reporter_tpu_torch.ops import hashtable as H
    from reporter_tpu_torch.tiles.tiering import TieredTable

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        m0 = torch.cuda.memory_allocated(dev)
    tier = TieredTable(ubodt, budget, device=dev)
    info = {"budget": budget, "capacity_rows": tier.capacity, "layout": ubodt.layout}
    passes = 0 if keys is None else 2 if cuda else 1
    for npass in range(passes):
        H.ubodt_lookup(tier.device(), *keys, False)
        tier.drain_stats()
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        moved = tier.maintain()
        if cuda:
            torch.cuda.synchronize(dev)
        info["maintain_%d" % (npass + 1)] = dict(moved, ms=(time.perf_counter() - t0) * 1e3)
    info.update(hot_rows=tier.resident_rows, pinned_bytes=tier.pinned_bytes)
    if cuda:
        torch.cuda.synchronize(dev)
        used = torch.cuda.memory_allocated(dev) - m0
        arena, slot_map, _p, counts, totals = tier.source()
        allowed = (4 * (arena.numel() + slot_map.numel() + counts.numel())
                   + 8 * totals.numel() + tier.stage_bytes() + (1 << 20))
        check(used <= allowed, "tiered table's device memory %d B <= arena + slot map + "
              "counters + staging (%d B) + 1 MiB = %d B" % (used, tier.stage_bytes(),
                                                            allowed))
        kind = _kernels.memory_type(tier.pages_t.data_ptr())
        check(tier.pages_t.device.type == "cpu" and kind == 1,
              "the pages are host memory, page-locked (memory type %d)" % kind)
        info.update(device_bytes=used, allowed_bytes=allowed,
                    torch_is_pinned=bool(tier.pages_t.is_pinned()))
        print("tiered %s table at %d B: %d/%d rows hot, device memory %d B (<= %d B), pages "
              "%d B page-locked in host memory (torch is_pinned %s); maintenance passes %s"
              % (ubodt.layout, budget, tier.resident_rows, tier.n_buckets, used, allowed,
                 tier.pinned_bytes, info["torch_is_pinned"],
                 json.dumps({k: v for k, v in info.items() if k.startswith("maintain_")})))
    return tier, info


def _distinct_split(tier, du, a, b):
    """(distinct hot rows, distinct cold rows, distinct buckets) kernel 2
    reads for the keys (a, b) under the tier's current slot map
    (``probe_buckets`` on ``du``, the untiered table)."""
    import torch

    buckets = torch.unique(probe_buckets(du, a, b))
    hot = tier.source()[1][buckets.to(tier.dev)] >= 0
    n_hot = int(hot.sum())
    return n_hot, int(buckets.numel()) - n_hot, int(buckets.numel())


def _stage_delta(rank, fn):
    """(fn(), [staged rows, in-place cold rows] that the call added to one
    rank's staging counts)."""
    import torch

    if rank.dev.type == "cuda":
        torch.cuda.synchronize(rank.dev)
    s0 = rank.stage_stats.clone()
    out = fn()
    if rank.dev.type == "cuda":
        torch.cuda.synchronize(rank.dev)
    return out, (rank.stage_stats - s0).cpu().tolist()


def staged_check(tier, rank, du, a, b, ds, what):
    """The staging of one tiered probe of the keys (a, b) on ``rank``, whose
    staging counts grew by ``ds``: the plain twin's bucket set
    (``stage_plain``) is the distinct cold rows the probe reads
    (``probe_buckets`` on ``du``, the untiered table, over the rank's
    range, cold under its slot map); the staged and in-place rows sum to
    them, the staged ones the first ``stage_cap``, so that the link
    carries each distinct cold row once; on the card the kernel's staged
    set (its list, in claim order) lies in the twin's, equals it when none
    is past the capacity, and its staged rows are their pages' bit for
    bit.  Returns (staged, in place, distinct cold rows)."""
    import numpy as np
    import torch

    read = torch.unique(probe_buckets(du, a, b, rank.lo, rank.n)) - rank.lo
    cold = read[rank.slot_map[read.to(rank.dev)].to(read.device) < 0].cpu()
    twin = tier.stage_plain(a, b, rank).cpu()
    check(torch.equal(twin, cold), "%s: the plain twin's staging list is the %d distinct "
          "cold rows the probe reads (%d)" % (what, cold.numel(), twin.numel()))
    n_cold = int(cold.numel())
    check(ds[0] + ds[1] == n_cold and ds[0] == min(n_cold, rank.stage_cap),
          "%s: staged %d and in place %d rows of %d distinct cold rows (capacity %d)"
          % (what, ds[0], ds[1], n_cold, rank.stage_cap))
    if rank.dev.type == "cuda":
        got = tier.staged_list(rank)
        check(len(got) == ds[0] and len(np.unique(got)) == len(got)
              and bool(np.isin(got, twin.numpy()).all()),
              "%s: the kernel's %d staged buckets are distinct and in the twin's set"
              % (what, len(got)))
        check(torch.equal(rank.stage.rows[:len(got)].cpu(),
                          tier.pages_t[torch.from_numpy(got + rank.lo)]),
              "%s: the staged rows equal their pages bit for bit" % what)
    return ds[0], ds[1], n_cold


def stage_kernel_rows(view, du, a, b, link, P, K):
    """The staging kernels of tiered view ``view`` alone on the keys (a,
    b), each call after an L2 flush: ``ubodt_cold_mark`` (a new
    dispatch's claims of the keys' cold first rows in the view's range)
    and ``ubodt_cold_gather`` (those rows over the host link),
    the list held against the distinct cold first-hash rows and the
    staged rows against their pages; beside the plain versions
    (``stage_plain``; the rows gathered from the pages on the host and
    copied to the card) and their bounds.  Returns their kernels-line
    rows."""
    import numpy as np
    import torch

    from reporter_tpu_torch.ops import hashtable as H

    sa, sb = torch.broadcast_tensors(a, b)
    dims, s_str, d_str = H._grid(sa, sb)
    keys = tuple(H.ptr(t) for t in (sa, sb, dims, s_str, d_str))
    tier, r, dev = view.tier, view.rank, sa.device

    def mark():
        with H.table_args(view) as (_table, targs):
            H._cold_mark(view, dev, keys, targs[0], None)

    def gather():
        with H.table_args(view) as (table, _targs):
            H._cold_gather(view, dev, table)
    mark()
    gather()
    torch.cuda.synchronize(dev)
    first = tier.staged_list(r)
    h1 = H.device_pair_hash(sa.reshape(-1), sb.reshape(-1), du.bmask) - r.lo
    b1 = torch.unique(h1[(h1 >= 0) & (h1 < r.n)])
    cold1 = b1[r.slot_map[b1] < 0].cpu().numpy()
    check(len(first) == min(len(cold1), r.stage_cap) and bool(np.isin(first, cold1).all())
          and len(np.unique(first)) == len(first),
          "the mark claims each distinct cold first row once (%d of %d)"
          % (len(first), len(cold1)))
    check(torch.equal(r.stage.rows[:len(first)].cpu(),
                      tier.pages_t[torch.from_numpy(first + r.lo)]),
          "the gather's rows equal their pages bit for bit")
    idx = torch.from_numpy(first + r.lo)
    row_bytes = tier.lanes * 4
    n0 = len(first)
    src = "reporter_tpu_torch/csrc/ubodt_probe.cu"
    rep = "reporter_tpu/tiles/tiering.py:586"  # the pages' bulk gather of a dispatch
    # the mark: the two [B, T, K] key arrays, each distinct in-range first
    # bucket's slot-map entry, each claim's stage-map entry read and
    # written and its list entry
    mark_b = bound(8 * P * K + 4 * int(b1.numel()) + 20 * n0, 0)
    gather_ms_bound = (row_bytes * n0 / link["peak_bytes_per_s"]
                       + (row_bytes + 4) * n0 / PEAK_BYTES_S) * 1e3
    rows = [dict(name="ubodt_cold_mark", route="cuda", source=src, replaces=rep,
                 max_abs_err=0.0, library_ms=None, claimed=n0,
                 ms=time_ms(mark, cold_l2=True),
                 plain_ms=time_ms(lambda: tier.stage_plain(a, b, r), reps=3, warmup=1,
                                  cold_l2=True, queued=False),
                 bound_ms=mark_b[0], bound_by=mark_b[1]),
            dict(name="ubodt_cold_gather", route="cuda", source=src, replaces=rep,
                 max_abs_err=0.0, library_ms=None, rows=n0,
                 ms=time_ms(gather, cold_l2=True, prep=mark),
                 plain_ms=time_ms(lambda: tier.pages_t[idx].to(dev), reps=3, warmup=1,
                                  cold_l2=True, queued=False),
                 bound_ms=gather_ms_bound, bound_by="bytes")]
    for x in rows:
        print("kernel %-34s %s alone: %d cold first rows, kernel_ms=%.4f plain_ms=%.4f "
              "bound_ms=%.4f (%s)" % (x["name"], H.probe_kernel_name(view), n0, x["ms"],
                                      x["plain_ms"], x["bound_ms"], x["bound_by"]))
    return rows


def cold_cache_probe(tier, du, a, b):
    """What caches serve of cold rows: the all-cold kernel 2 on three key
    sets of one size (the broadcast of ``a`` and ``b``), each call after
    an L2 flush: the cohort's own keys; ``scattered``, random pairs of the
    cohort's nodes (seeded), whose buckets are uniform, so a bucket's
    repeats lie about n_buckets fetches (n_buckets rows, 537 MB) apart,
    ten times the 50 MB L2; ``repeated``, the cohort's first 256 keys
    cycled, whose few rows any cache would hold.  Returns each one's
    time, distinct buckets, and fetched bytes (the rows the kernel reads,
    ``probe_buckets`` on ``du``, the untiered table) over time."""
    import torch

    from reporter_tpu_torch.ops import hashtable as H

    sa, sb = (t.reshape(-1).contiguous() for t in torch.broadcast_tensors(a, b))
    n, dev = sa.numel(), sa.device
    gen = torch.Generator(device=dev).manual_seed(1234)
    pick = lambda: torch.randint(0, n, (n,), device=dev, generator=gen)  # noqa: E731
    cyc = torch.arange(n, device=dev) % 256
    sets = {"cohort": (a, b), "scattered": (sa[pick()], sb[pick()]),
            "repeated": (sa[cyc], sb[cyc])}
    u = tier.ubodt
    row_bytes = 4 * u.bucket_entries * 8
    out = {}
    for name, (s, d) in sets.items():
        read = probe_buckets(du, s, d)
        distinct = int(torch.unique(read).numel())
        ms = time_ms(lambda: H.ubodt_lookup(tier.device(), s, d, False), cold_l2=True,
                     label="%s all cold, %s keys" % (H.probe_kernel_name(tier.device()), name),
                     tier=tier)
        fetched = read.numel() * row_bytes
        out[name] = {"ms": ms, "distinct_buckets": distinct, "fetched_bytes": fetched,
                     "fetched_bytes_per_s": fetched / (ms / 1e3)}
    print("cold rows and caches (%s, all cold, %d keys): %s" % (
        u.layout, n, "; ".join(
            "%s %.4f ms, %d rows read (%d distinct), %.2f GB/s fetched" % (
                k, v["ms"], v["fetched_bytes"] // row_bytes, v["distinct_buckets"],
                v["fetched_bytes_per_s"] / 1e9)
            for k, v in out.items())))
    return out


def tier_kernel_phases(matcher, ubodt, xin, link, sm=None, tr_l=None, tr_a=None,
                       sparse_pk=None, traces2048=None, traces64=None, timed=True):
    """Kernel 2's tiered instantiation for ``ubodt``'s layout against its
    plain version, bit for bit, with equal fetch counts and hit/miss
    totals, at three occupancies: a 1-byte budget (every row cold), 64 MiB
    after one maintenance pass on the cohort's own traffic (about half
    hot), and the table's size (every row hot); at each, the dedup probe
    and its forced fallback the same way, and the chain kernels' seams
    (scan and assoc, dense and sparse, the long window and the slab) on
    the tiered table through ``chain_phases``.  ``timed``: the tiered
    kernel at each occupancy beside the untiered kernel on the same keys,
    the dedup probe and ``cold_cache_probe`` with every row cold, and row
    10's bound: the hot side's bytes over HBM's peak, the cold rows'
    over the host link's peak (``link``, ``host_link``'s)."""
    import copy

    import torch

    from reporter_tpu_torch.ops import hashtable as H
    from reporter_tpu_torch.ops import viterbi as V
    from reporter_tpu_torch.ops.candidates import candidate_sweep

    dev, K, p = matcher.device, matcher.cfg.beam_k, matcher._params
    x, y, _t, v = V.unpack_inputs(xin)
    B, T = x.shape
    sw = candidate_sweep(matcher._dg, x, y, v, K, p.search_radius, p.sigma_z, False)
    a, b = sw.to_node[:, :-1, :, None], sw.from_node[:, 1:, None, :]
    du = ubodt.to_device(dev)
    want = H.ubodt_lookup(du, a, b)
    rows = ubodt.rows()
    n_fb = 1 << 16  # all distinct: past the dedup budget of 32,768
    fs = torch.from_numpy(rows[0][:n_fb]).to(dev)
    fd = torch.from_numpy(rows[1][:n_fb]).to(dev)
    fwant = H.ubodt_lookup(du, fs, fd)
    row_bytes = 4 * ubodt.bucket_entries * 8
    out = {}
    for occ, budget in (("cold", 1), ("partial", TIER_PARTIAL),
                        ("hot", ubodt.n_buckets * row_bytes)):
        tier, info = tier_table(ubodt, budget, dev, (a, b))
        tdu = tier.device()
        name = H.probe_kernel_name(tdu)
        r0 = tier.rank()
        (got, ds), dk = _tier_delta(tier, lambda: _stage_delta(
            r0, lambda: H.ubodt_lookup(tdu, a, b)))
        (plain, dsp), dp = _tier_delta(tier, lambda: _stage_delta(
            r0, lambda: H.ubodt_lookup_plain(tdu, a, b)))
        check(_same(got, want) and _same(plain, want), "%s (%s) equals the untiered probe"
              % (name, occ))
        _same_fetches(dk, dp, "%s (%s)" % (name, occ))
        check(ds == dsp, "%s (%s): staged and in-place rows %s equal the plain version's %s"
              % (name, occ, ds, dsp))
        staged, inplace, _n = staged_check(tier, r0, du, a, b, ds, "%s (%s)" % (name, occ))
        n_hot, n_cold, n_b = _distinct_split(tier, du, a, b)
        if occ == "cold":
            check(dk[1][0] == 0 and n_hot == 0, "every fetch cold at a 1-byte budget")
        if occ == "hot":
            check(dk[1][1] == 0 and n_cold == 0, "every fetch hot at the table's size")
        if occ == "partial":
            check(dk[1][0] > 0 and dk[1][1] > 0, "hits and misses at the partial budget")
        dd, ddk = _tier_delta(tier, lambda: H.ubodt_lookup_dedup(tdu, a, b))
        ddp_, ddp = _tier_delta(tier, lambda: H.ubodt_lookup_dedup_plain(tdu, a, b))
        check(_same(dd[:3], want) and _same(ddp_[:3], want) and int(dd.n_unique[0]) <= dd.m,
              "dedup probe (%s) equals the untiered probe" % occ)
        _same_fetches(ddk, ddp, "dedup probe (%s)" % occ)
        H.DEDUP.reset()
        fb, fbk = _tier_delta(tier, lambda: H.ubodt_lookup(tdu, fs, fd, dedup=True))
        fbp, fbp_d = _tier_delta(tier, lambda: H.ubodt_lookup_dedup_plain(tdu, fs, fd))
        check(_same(fb, fwant) and _same(fbp[:3], fwant) and H.DEDUP.summary()[
            "dedup_fallbacks"] == 1, "dedup fallback (%s) equals the untiered probe" % occ)
        _same_fetches(fbk, fbp_d, "dedup fallback (%s)" % occ)
        r = dict(info, shape="%dx%d K=%d" % (B, T, K), hits=dk[1][0], misses=dk[1][1],
                 distinct_hot_rows=n_hot, distinct_cold_rows=n_cold, distinct_buckets=n_b,
                 staged_rows=staged, inplace_cold_rows=inplace,
                 stage_rows_cap=r0.stage_cap, stage_bytes=tier.stage_bytes(r0),
                 max_abs_err=max_abs_err(zip(got, plain)))
        print("%s %s at %s occupancy: %d hits, %d misses (%d/%d distinct rows hot); kernel, "
              "plain, dedup and fallback equal the untiered probe, fetch counts and totals "
              "equal the plain versions'; staged %d rows x %d B over the link, %d past the "
              "capacity of %d read in place (overflow), = the %d distinct cold rows read, "
              "the kernel's staged set in the plain twin's"
              % (name, r["shape"], occ, dk[1][0], dk[1][1], n_hot, n_b, staged, row_bytes,
                 inplace, r0.stage_cap, n_cold))
        mt = copy.copy(matcher)
        mt._du = tdu
        seams = {}
        for kern in ("scan", "assoc"):
            if traces2048 is not None:
                seams[kern] = chain_phases(mt, traces2048, traces64, timed=False,
                                           kernel=kern, tier=tier)
            if sm is not None:
                smt = copy.copy(sm)
                smt._du = tdu
                seams[kern + "[sparse]"] = chain_phases(smt, tr_l, tr_a, timed=False,
                                                        kernel=kern, tier=tier, **sparse_pk)
        r["seam_max_abs_err"] = max([0.0] + [c["max_abs_err"] for s_ in seams.values()
                                             for c in s_.values()])
        if timed and dev.type == "cuda":
            P, N = B * T, torch.broadcast_tensors(a, b)[0].numel()
            r["ms"] = time_ms(lambda: H.ubodt_lookup(tdu, a, b, False), cold_l2=True,
                              label="%s %s %s" % (name, r["shape"], occ), tier=tier)
            r["untiered_ms"] = time_ms(lambda: H.ubodt_lookup(du, a, b, False), cold_l2=True,
                                       label="%s %s (beside %s)" % (
                                           H.probe_kernel_name(du), r["shape"], occ))
            if occ == "partial":  # the plain version gathers cold rows on the host: slow
                r["plain_ms"] = time_ms(lambda: H.ubodt_lookup_plain(tdu, a, b, False),
                                        reps=3, warmup=1, cold_l2=True, queued=False)
            # HBM: the keys, each distinct bucket's slot-map entry, the hot
            # rows, dist and time out; the host link: the cold rows
            hbm = 8 * P * K + 4 * n_b + row_bytes * n_hot + 8 * N
            r["bound_ms"] = (hbm / PEAK_BYTES_S
                             + row_bytes * n_cold / link["peak_bytes_per_s"]) * 1e3
            r["bound_by"] = "bytes"
            if occ == "partial":  # the scatter's (0, 0) tail count, compared across trees
                sa, sb = torch.broadcast_tensors(a, b)
                fn, got_s = scatter_launch(tdu, sa, sb, H._budget(N))
                check(_bits_equal(got_s[:2], want[:2]), "scatter (%s) equals the probe" % occ)
                r["scatter_ms"] = time_ms(fn, label="ubodt_dedup_scatter %s %s %s" % (
                    name, r["shape"], occ), tier=tier)
            if occ == "cold":
                r["dedup_ms"] = time_ms(lambda: H.ubodt_lookup_dedup(tdu, a, b, False),
                                        cold_l2=True, label="dedup probe %s %s %s" % (
                                            name, r["shape"], occ), tier=tier)
                r["caches"] = cold_cache_probe(tier, du, a, b)
            print("kernel %-26s %s %-7s kernel_ms=%.4f untiered kernel_ms=%.4f plain_ms=%s "
                  "bound_ms=%.4f (bytes: %d hot rows over HBM, %d cold rows over the link)%s"
                  % (name, r["shape"], occ, r["ms"], r["untiered_ms"],
                     "%.4f" % r["plain_ms"] if "plain_ms" in r else "-", r["bound_ms"], n_hot,
                     n_cold, " dedup_ms=%.4f" % r["dedup_ms"] if "dedup_ms" in r else ""))
        out[occ] = r
        tier.close()
    return out


def tier_paths(matcher, ubodt_w, sm, traces64, traces256, traces2048, tr_a, tr_l, xins,
               xin_a):
    """Matchers at the partial budget ($REPORTER_UBODT_HOT_BYTES-sized
    config) over every path, through the launch counters, each output
    equal to the untiered matcher's: the bucketed path (both cohorts), the
    long path, the session path (slab, host carries, 4-point long
    oracle), the sparse cohorts A (bucketed) and L (long), and the assoc
    forward's bucketed and long paths; then a wide32 + dedup matcher's
    bucketed and long paths (``ubodt_probe[wide32,tiered]``)."""
    from dataclasses import replace

    from reporter_tpu_torch.matching import SegmentMatcher

    def tiered(base, **kw):
        return SegmentMatcher(arrays=base.arrays, ubodt=base.ubodt, device=base.device,
                              config=replace(base.cfg, ubodt_hot_bytes=TIER_PARTIAL, **kw))

    mt = tiered(matcher)
    check(mt.tiering is not None and mt._du.tier is mt.tiering, "tiered matcher")
    out = {"launches": {}, "rates": {}}
    out["launches"]["bucketed"], out["rates"]["bucketed"] = main_path(
        mt, [traces64, traces256], xins, base=matcher, plain=False)
    out["launches"]["long"], out["rates"]["long"] = long_path(mt, traces2048, base=matcher,
                                                              plain=False)
    _am, out["launches"]["session"], out["rates"]["session"] = session_path(mt, traces64)
    smt = tiered(sm)
    out["launches"]["sparse"], out["rates"]["sparse"] = sparse_main_path(
        smt, [tr_a], [xin_a], "tiered", base=sm, plain=False)
    out["launches"]["sparse_long"], out["rates"]["sparse_long"] = long_path(
        smt, tr_l, "ge60", base=sm, plain=False)
    base_a = SegmentMatcher(arrays=matcher.arrays, ubodt=matcher.ubodt, device=matcher.device,
                            config=replace(matcher.cfg, viterbi_kernel="assoc"))
    mta = tiered(matcher, viterbi_kernel="assoc")
    out["launches"]["assoc"], out["rates"]["assoc"] = main_path(
        mta, [traces64, traces256], xins, base=base_a, plain=False)
    out["launches"]["assoc_long"], out["rates"]["assoc_long"] = long_path(
        mta, traces2048, base=base_a, plain=False)
    mwt = memory_matcher(matcher, ubodt_w, ubodt_hot_bytes=TIER_PARTIAL)
    check(mwt._du.wide and mwt.tiering is not None, "tiered wide32 + dedup matcher")
    out["launches"]["wide32"], out["rates"]["wide32"] = main_path(
        mwt, [traces64], xins[:1], base=matcher, plain=False)
    out["launches"]["wide32_long"], out["rates"]["wide32_long"] = long_path(
        mwt, traces2048, base=matcher, plain=False)
    out["tier"] = {"summary": mt.tiering.summary(), "hits": mt.tiering.hits,
                   "misses": mt.tiering.misses, "evictions": mt.tiering.evictions,
                   "maintenance_passes": mt.tiering.maintenance_passes}
    print("tiered matcher (%d B hot): every path equals the untiered matcher's; tier %s"
          % (TIER_PARTIAL, json.dumps(out["tier"])))
    return out


def session_cold_tier(matcher, traces64, hot=128, cold=256, steps=8, group=128):
    """The 512 x 64 cohort as 512 sessions in ``steps`` steps of 4 points,
    submitted in groups of ``group``, through a slab of ``hot`` slots over
    ``cold`` pinned host pages (promotion, demotion and spill at every
    group), through the launch counters; records and beams equal the
    host-carry path's."""
    from dataclasses import replace

    import numpy as np

    from reporter_tpu_torch.matching import SegmentMatcher, SessionEngine, SessionStore
    from reporter_tpu_torch.matching.arena import carry_host

    cfg = matcher.cfg
    slot_b = 12 * cfg.beam_k + 17
    cm = SegmentMatcher(arrays=matcher.arrays, ubodt=matcher.ubodt, device=matcher.device,
                        config=replace(cfg, session_arena=True,
                                       session_arena_bytes=hot * slot_b,
                                       session_arena_cold_bytes=cold * slot_b))
    arena = cm.session_arena
    check((arena.hot_slots, arena.cold_slots) == (hot, cold), "slab of %d + %d" % (hot, cold))

    def stream(m):
        eng = SessionEngine(m, SessionStore(cfg.max_sessions, cfg.session_ttl_s),
                            tail_points=cfg.session_tail_points)
        for j in range(0, steps * 4, 4):
            for g in range(0, len(traces64), group):
                eng.match_many([dict(tr, trace=tr["trace"][j:j + 4])
                                for tr in traces64[g:g + group]])
        return eng

    path, other = _forward(cm, 4, True)
    kernels, absent = _path_kernels(cm, path)
    eng, dt, launches = _counted(kernels, lambda: stream(cm), other + absent)
    summ = arena.summary()
    check(summ["promotions"] > 0 and summ["evictions"] > 0 and summ["readbacks"] > 0,
          "promotion, demotion and spill happened: %s" % summ)
    host = stream(matcher)
    for tr in traces64:
        u = tr["uuid"]
        s, hs = eng.store.peek(u), host.store.peek(u)
        check(s.records == hs.records, "cold-tier records equal host-carry path (%s)" % u)
        a, b = carry_host(s.carry), carry_host(hs.carry)
        check(all(np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in a),
              "cold-tier beam equals host-carry beam (%s)" % u)
    print("session cold tier: %d sessions x %d steps in groups of %d through %d hot slots and "
          "%d cold pages in %.3f s: promotions %d, evictions %d, readbacks %d; records and "
          "beams equal the host-carry path's, launches %s"
          % (len(traces64), steps, group, hot, cold, dt, summ["promotions"],
             summ["evictions"], summ["readbacks"], json.dumps(launches)))
    return launches, dict(summ, s=dt)


def tier_serve_phase(arrays, ubodt, tr_a, default_answers, default_fixtures, device):
    """The 8 /report of cohort A and the fixture replay with
    $REPORTER_UBODT_HOT_BYTES at the partial budget on the serving
    defaults: the same answers as the untiered defaults'."""
    from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
    from reporter_tpu_torch.serve.__main__ import serving_defaults

    env = {"REPORTER_UBODT_HOT_BYTES": str(TIER_PARTIAL)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        sv = SegmentMatcher(arrays=arrays, ubodt=ubodt,
                            config=serving_defaults(MatcherConfig()), device=device)
        check(sv.tiering is not None and sv.tiering.hot_bytes == TIER_PARTIAL,
              "the environment tiers the table")
        kernels, absent = _path_kernels(sv, SPARSE_BUCKETED)
        (answers,), dt, launches = _counted(kernels, lambda: _serve(sv, 15, tr_a[:8]),
                                            absent)
        check(answers == default_answers, "/report answers equal the untiered defaults'")
        fixtures = replay_fixtures(device, "REPORTER_UBODT_HOT_BYTES=%d" % TIER_PARTIAL)
        check(fixtures == default_fixtures, "fixture answers equal the untiered defaults'")
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    print("serve tiered (REPORTER_UBODT_HOT_BYTES=%d): 8 /report of cohort A in %.2f s and "
          "the 6 fixtures answered as untiered, launches %s"
          % (TIER_PARTIAL, dt, json.dumps(launches)))
    return launches

MESH_GP = (2, 4, 8)  # gp ranks of the sharded probe's checks


def _views(du, gp):
    """Rank g of gp's bucket-range views of ``du`` (on its device, no
    copy) and the ShardedUBODT over them; each slice holds 1/gp of the
    table's bytes."""
    from reporter_tpu_torch.tiles.ubodt import ShardedUBODT

    views = [du.shard(g, gp) for g in range(gp)]
    for v in views:
        check(v.packed.numel() * 4 == du.packed.numel() * 4 // gp,
              "a gp rank's slice holds 1/%d of the table" % gp)
    return views, ShardedUBODT(views)


def mesh_probe_phases(matcher, du_w, xin, timed):
    """Kernel 11a: at gp 2, 4 and 8, for both layouts, on a cohort's
    [B, T-1, K, K] keys, each rank's ``ubodt_probe[sharded]`` equals its
    plain version bit for bit, and the ranks' pmin / pmax equals the
    untiered kernel 2 bit for bit.  Times one rank of gp 4 (the dp2 x gp4
    mesh's) after an L2 flush, beside its bound: the rank's in-range
    distinct rows."""
    import torch

    from reporter_tpu_torch.ops import viterbi as V
    from reporter_tpu_torch.ops.candidates import candidate_sweep
    from reporter_tpu_torch.ops.hashtable import ubodt_lookup, ubodt_lookup_plain

    p, K = matcher._params, matcher.cfg.beam_k
    x, y, _t, v = V.unpack_inputs(xin)
    sw = candidate_sweep(matcher._dg, x, y, v, K, p.search_radius, p.sigma_z, False)
    a, b = sw.to_node[:, :-1, :, None], sw.from_node[:, 1:, None, :]
    ka, kb = (t.reshape(-1) for t in torch.broadcast_tensors(a, b))
    N = ka.numel()
    rows = {}
    for du in (matcher._du, du_w):
        name = "ubodt_probe[%ssharded]" % ("wide32," if du.wide else "")
        want = ubodt_lookup(du, a, b)
        buckets = torch.unique(probe_buckets(du, a, b))
        row_b = 4 * du.packed.shape[1]
        for gp in MESH_GP:
            views, sharded = _views(du, gp)
            for view in views:
                got = ubodt_lookup(view, a, b)
                plain = ubodt_lookup_plain(view, a, b)
                check(all(torch.equal(g, w) for g, w in zip(got, plain)),
                      "%s rank %d/%d equals its plain version" % (name, view.lo, gp))
            merged = ubodt_lookup(sharded, a, b)
            check(all(torch.equal(g, w) for g, w in zip(merged, want)),
                  "%s pmin/pmax over gp=%d equals the untiered kernel 2" % (name, gp))
            if gp == 4:
                r0 = views[0]
                mine = int(torch.unique(probe_buckets(du, a, b, r0.lo,
                                                      r0.local_buckets)).numel())
                # reads: the [B, T, K] keys, the rank's distinct in-range
                # rows the probe reads once (a key's second row only where
                # its first is out of range or misses); writes: dist and
                # time; ~40 integer ops a probe
                bnd, by = bound(8 * sw.to_node.numel() + row_b * mine + 8 * N, 40 * N)
                rows[name] = dict(
                    name=name, route="cuda", source="reporter_tpu_torch/csrc/ubodt_probe.cu",
                    replaces="reporter_tpu/ops/hashtable.py:249", max_abs_err=0.0,
                    bound_ms=bnd, bound_by=by, library_ms=None, probes=N, gp=4,
                    rank_rows=mine, distinct_rows=int(buckets.numel()),
                    fn=lambda r0=r0: ubodt_lookup(r0, a, b, with_first=False),
                    plain=lambda r0=r0: ubodt_lookup_plain(r0, a, b, with_first=False),
                    merged=lambda s=sharded: ubodt_lookup(s, a, b, with_first=False))
        print("kernel %-27s %d keys at gp 2, 4, 8: every rank equals its plain version and "
              "the ranks' pmin/pmax equals kernel 2 (%s), bit for bit"
              % (name, N, du.layout))
    for r in rows.values():
        if timed:
            r["ms"] = time_ms(r["fn"], cold_l2=True, label="%s gp4 rank 0 %d probes" % (
                r["name"], N))
            r["plain_ms"] = time_ms(r["plain"], cold_l2=True, queued=False)
            r["merged_ms"] = time_ms(r["merged"], cold_l2=True, queued=False)
        print("kernel %-27s rank 0 of gp 4, %d probes, %d of %d distinct rows in range: "
              "kernel_ms=%s plain_ms=%s all four ranks + pmin/pmax %s ms bound_ms=%.4f (%s)"
              % (r["name"], N, r["rank_rows"], r["distinct_rows"],
                 "%.4f" % r["ms"] if "ms" in r else "-",
                 "%.4f" % r["plain_ms"] if "plain_ms" in r else "-",
                 "%.4f" % r["merged_ms"] if "merged_ms" in r else "-", r["bound_ms"],
                 r["bound_by"]))
    return list(rows.values())


def mesh_seam_phases(matcher, sm, long_traces, traces64, tr_l, tr_a, pk, timed):
    """The chain kernels' seam on a gp mesh: with the table split over 4
    gp ranks the seam's [B, K, K] probe resolves outside the launch and the
    chain kernels read it; their outputs equal the in-kernel probe's bit
    for bit, scan and assoc, dense (the long cohort's 64 x 256 window, the
    512 x 4 session step on carries gathered from a slab) and sparse (L's
    16 x 256 window at K = 16, the session step at A's parameters)."""
    import numpy as np
    import torch

    from reporter_tpu_torch.ops import viterbi as V

    out = {}
    for m, trs_long, trs_sess, (lp, lk), (spar, sk), sp in (
            (matcher, long_traces, traces64, (matcher._params, matcher.cfg.beam_k),
             (matcher._params, matcher.cfg.beam_k), None),
            (sm, tr_l, tr_a, pk["long_pk"], pk["sess_pk"], pk["sp"])):
        dev, dg, du = m.device, m._dg, m._du
        _views_, sharded = _views(du, 4)
        W = m.max_trace_points
        B = len(trs_long)
        two = [dict(tr, trace=tr["trace"][:2 * W]) for tr in trs_long]
        px, py, tm, valid, _t = m._fill_rows(two, list(range(B)), 2 * W)
        xin = torch.from_numpy(V.pack_inputs(px, py, tm, valid)).to(dev)
        x0, x1 = xin[:, :, :W].contiguous(), xin[:, :, W:].contiguous()
        pre0 = V.precompute_batch_packed(dg, du, x0, lp, lk, sp)
        carry = V.viterbi_chain(dg, du, pre0.emis, pre0.logp, pre0.gc, *V.unpack_inputs(x0),
                                pre0.cand.edge, pre0.cand.offset, lp,
                                V.initial_carry_batch(B, lk, dev), sp=sp)[2]
        pre = V.precompute_batch_packed(dg, du, x1, lp, lk, sp)
        largs = (pre.emis, pre.logp, pre.gc, *V.unpack_inputs(x1), pre.cand.edge,
                 pre.cand.offset, lp, carry)
        # the session step: 512 rows (496 sessions, 16 padding) from a slab
        # of 65,536 slots, 464 continuing, 32 fresh, on host carries
        S, Bs = 65536, len(trs_sess)
        rng = np.random.default_rng(6)
        slots = np.full(Bs, S, np.int32)
        slots[:Bs - 16] = rng.choice(S, Bs - 16, replace=False)
        slab = V.initial_carry_batch(S, sk, dev)
        xs0, xs1 = (session_rows(m, trs_sess[:Bs - 16], j, 4) for j in (0, 4))
        p0 = V.precompute_batch_packed(dg, du, xs0, spar, sk, sp)
        V.viterbi_chain(dg, du, p0.emis, p0.logp, p0.gc, *V.unpack_inputs(xs0), p0.cand.edge,
                        p0.cand.offset, spar, slab, slots, np.zeros(Bs, bool), sp=sp)
        use = np.zeros(Bs, bool)
        use[:Bs - 32] = True
        rows = torch.from_numpy(np.minimum(slots, S - 1).astype(np.int64)).to(dev)
        usem = torch.from_numpy(use).to(dev)
        hc = V.TraceCarry(*(torch.where(usem.view((Bs,) + (1,) * (g.dim() - 1)), g[rows], i)
                            for g, i in zip(slab, V.initial_carry_batch(Bs, sk, dev))))
        ps = V.precompute_batch_packed(dg, du, xs1, spar, sk, sp)
        sargs = (ps.emis, ps.logp, ps.gc, *V.unpack_inputs(xs1), ps.cand.edge,
                 ps.cand.offset, spar, hc)
        tag = "" if sp is None else "[sparse]"
        for kernel in ("scan", "assoc"):
            for what, args in (("long", largs), ("session", sargs)):
                probing = V.viterbi_chain(dg, du, *args, sp=sp, kernel=kernel)
                resolved = V.viterbi_chain(dg, sharded, *args, sp=sp, kernel=kernel)
                check(torch.equal(probing[0], resolved[0]) and torch.equal(probing[1], resolved[1])
                      and _carry_same(probing[2], resolved[2]),
                      "the resolved seam equals the in-kernel probe (%s%s, %s, %s)"
                      % (kernel, tag, what, du.layout))
                key = "%s%s_%s" % (kernel, tag, what)
                out[key] = {"shape": "%dx%d K=%d" % (args[0].shape[0], args[0].shape[1],
                                                      args[0].shape[2])}
                if timed and sp is None and kernel == "scan" and what == "long":
                    out[key]["probing_ms"] = time_ms(
                        lambda: V.viterbi_chain(dg, du, *args, sp=sp, kernel=kernel),
                        label="viterbi_chain %s (the seam's probing side)" % (
                            out[key]["shape"]))
                    out[key]["resolved_ms"] = time_ms(
                        lambda: V.viterbi_chain(dg, sharded, *args, sp=sp, kernel=kernel),
                        queued=False)
    print("chain seam on a gp=4 mesh: the resolved [B, K, K] seam equals the in-kernel "
          "probe bit for bit (scan and assoc; dense 64x256 and 512x4, sparse 16x256 and "
          "512x4); %s" % json.dumps({k: v for k, v in out.items() if len(v) > 1}))
    return out


def _hist_same(a, b):
    """Two ``SegmentHistogram``s: counts bit for bit, the time and distance
    sums within rtol 1e-5 (the adds' order differs between designs)."""
    import torch

    return (torch.equal(a.point_count, b.point_count) and torch.equal(a.trace_count, b.trace_count)
            and all(torch.allclose(x, y, rtol=1e-5, atol=1e-3) for x, y in zip(a[2:], b[2:])))


def histogram_phases(matcher, xins, timed):
    """Kernel 11b and kernel 4's chosen-slot output: on each decoded batch
    the scan kernel's ``choice`` equals the plain decode's exactly, and
    ``segment_histogram`` equals its plain version on the same inputs:
    counts exact, time and distance sums within rtol 1e-5 (the atomics'
    order).  Timed at 512 x 64 beside four ``index_add_`` calls on the
    same inputs (the yardstick), and at 128 x 256 alone (both labelled,
    so ``--pair`` times both against every tree)."""
    import torch

    from reporter_tpu_torch.ops import histogram as Hg
    from reporter_tpu_torch.ops import viterbi as V

    dg, du, p, K = matcher._dg, matcher._du, matcher._params, matcher.cfg.beam_k
    S = len(matcher.arrays.seg_ids)
    row = None
    for xin in xins:
        x, y, t, v = V.unpack_inputs(xin)
        pre, packed, aux, choice = V.match_batch_full(dg, du, x, y, t, v, p, K)
        pre0, packed0, _a0, choice0 = V.match_batch_full(dg, du, x, y, t, v, p, K, plain=True)
        check(torch.equal(choice, choice0) and torch.equal(packed, packed0),
              "viterbi_scan's chosen slots equal the plain decode's")
        check(torch.allclose(pre.route, pre0.route, rtol=1e-6, atol=0),
              "the transition build's route")
        hargs = (choice, pre.route, pre.cand.edge, packed[2], t, dg.edge_seg, S)
        hk = Hg.segment_histogram(*hargs)
        hp = Hg.segment_histogram_plain(*hargs)
        check(torch.equal(hk.point_count, hp.point_count)
              and torch.equal(hk.trace_count, hp.trace_count), "histogram counts exact")
        for f in ("time_in_segment", "distance_in_segment"):
            check(torch.allclose(getattr(hk, f), getattr(hp, f), rtol=1e-5, atol=1e-3),
                  "histogram %s within rtol 1e-5" % f)
        err = max_abs_err(zip(hk, hp))
        B, T = t.shape
        matched = int((choice[0] >= 0).sum())
        routed = int(((choice[0] >= 0) & (choice[1] >= 0)).sum())
        seg = Hg.point_segments(choice, pre.cand.edge, dg.edge_seg)
        n_edges = int(torch.unique(torch.gather(
            pre.cand.edge, 2, choice[0].clamp(min=0).long()[..., None])).numel())
        # reads: choice, breaks, times once; the chosen candidate edge, the
        # chosen route entry and the edge's segment id per point; writes
        # the [4, S] output.  Operations: ~40 a point (the runs' scan, 5
        # steps of 4 values, and the step's terms).
        bnd, by = bound(16 * B * T + 4 * matched + 4 * routed + 4 * n_edges + 16 * S,
                        40 * B * T)
        print("kernel %-27s %dx%d S=%d: %d matched points, counts exact, sums within rtol "
              "1e-5 (max_abs_err %.3g)" % ("segment_histogram", B, T, S, matched, err))
        if row is None:
            flat = torch.where(seg >= 0, seg, S).reshape(-1)
            same = ((seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] >= 0) & (packed[2][:, 1:] == 0))
            step = torch.where(same, seg[:, 1:], S).reshape(-1)
            dt = torch.where(same, t[:, 1:] - t[:, :-1], 0.0).reshape(-1)
            rd = Hg.chosen_route(choice, pre.route)[:, 1:]
            dd = torch.where(same & torch.isfinite(rd), rd, 0.0).reshape(-1)
            first = torch.sort(flat.view(B, T), 1).values
            first = torch.where(torch.cat([torch.ones_like(first[:, :1], dtype=torch.bool),
                                           first[:, 1:] != first[:, :-1]], 1), first, S)
            first = first.reshape(-1)
            ones = torch.ones_like(flat, dtype=torch.float32)
            bins = torch.zeros((4, S + 1), dtype=torch.float32, device=t.device)

            def library():  # four index_add_ calls: the yardstick, not the port
                bins.zero_()
                bins[0].index_add_(0, flat, ones)
                bins[1].index_add_(0, first, ones)
                bins[2].index_add_(0, step, dt)
                bins[3].index_add_(0, step, dd)
            library()
            check(torch.equal(bins[:2, :S], torch.stack([hk.point_count, hk.trace_count])),
                  "the index_add_ yardstick computes the same counts")
            row = dict(name="segment_histogram", route="cuda",
                       source="reporter_tpu_torch/csrc/segment_histogram.cu",
                       replaces="reporter_tpu/parallel/mesh.py:75", max_abs_err=err,
                       bound_ms=bnd, bound_by=by, shape="%dx%d S=%d" % (B, T, S),
                       fn=lambda: Hg.segment_histogram(*hargs),
                       plain=lambda: Hg.segment_histogram_plain(*hargs), library=library)
        else:
            row["max_abs_err"] = max(row["max_abs_err"], err)
            shape = "%dx%d S=%d" % (B, T, S)
            row.setdefault("shapes", {})[shape] = {"bound_ms": bnd, "bound_by": by}
            if timed:
                row["shapes"][shape]["ms"] = time_ms(
                    lambda a=hargs: Hg.segment_histogram(*a), label="segment_histogram " + shape,
                    same=_hist_same)
            print("kernel %-27s %s kernel_ms=%s bound_ms=%.4f (%s)" % (
                "segment_histogram", shape, "%.4f" % row["shapes"][shape]["ms"]
                if timed else "-", bnd, by))
    if timed:
        row["ms"] = time_ms(row["fn"], label="segment_histogram " + row["shape"],
                            same=_hist_same)
        row["plain_ms"] = time_ms(row["plain"], queued=False)
        row["library_ms"] = time_ms(row["library"], queued=False)
    print("kernel %-27s %s kernel_ms=%s plain_ms=%s library_ms=%s (4 x index_add_) "
          "bound_ms=%.4f (%s)" % (row["name"], row["shape"],
                                  "%.4f" % row["ms"] if "ms" in row else "-",
                                  "%.4f" % row["plain_ms"] if "plain_ms" in row else "-",
                                  "%.4f" % row["library_ms"] if "library_ms" in row else "-",
                                  row["bound_ms"], row["bound_by"]))
    row.setdefault("library_ms", None)
    return row


def slab_phases(device, K, timed, S=65536, B=512, timed_dps=(2, 4)):
    """Kernel 11c: the slot-sharded slab's gather and scatter at dp 2 and
    4, B sessions' rows (all but 32 live, 16 fresh, 16 padding) of a
    65,536-slot slab whose rows are seeded bit patterns (NaN payloads and
    -0.0 included): every rank equals its plain version bit for bit, the
    psum of the ranks' gathers is the single slab's rows (zeros for
    padding), and the scattered shards are the single slab with its owned
    rows written.  Timed at rank 0 of each dp in ``timed_dps``.  Returns
    (the kernels' rows at the first of them, {call: ms})."""
    import numpy as np
    import torch

    from reporter_tpu_torch.ops import collectives
    from reporter_tpu_torch.ops import viterbi as V

    rng = np.random.default_rng(13)
    W = 3 * K + 5

    def carry_of(words):
        return V.carry_from_words(torch.from_numpy(words).to(device), K)
    raw = rng.integers(-2 ** 31, 2 ** 31, (S, W), dtype=np.int64).astype(np.int32)
    raw[:, 3 * K + 3] &= 1  # active: a bool byte
    raw[:8, 0] = np.array([0x80000000, 0x7FC00001] * 4, np.uint32).view(np.int32)  # -0.0, NaN
    slab = carry_of(raw)
    slots = np.full(B, S, np.int32)
    slots[:B - 16] = rng.choice(S, B - 16, replace=False)
    slots[:8] = np.arange(8)  # the NaN and -0.0 rows
    # live slots are distinct (one row a session): a later row that drew one
    # of those eight takes the least slot no row holds
    again = np.flatnonzero(slots[8:B - 16] < 8) + 8
    slots[again] = np.setdiff1d(np.arange(S), slots[:B - 16])[:len(again)]
    sl = torch.from_numpy(slots).to(device)
    live = slots < S
    want = np.where(live[:, None], raw[np.minimum(slots, S - 1)], np.int32(0))
    new = rng.integers(-2 ** 31, 2 ** 31, (B, W), dtype=np.int64).astype(np.int32)
    new[:, 3 * K + 3] &= 1
    after = raw.copy()
    after[slots[live]] = new[live]
    rows, times = {}, {}
    for dp in (2, 4):
        s_local = S // dp
        shards = [V.TraceCarry(*(t[r * s_local:(r + 1) * s_local].clone() for t in slab))
                  for r in range(dp)]
        gk = [V.slab_gather_owned(sh, sl, r * s_local) for r, sh in enumerate(shards)]
        gp = [V.slab_gather_owned_plain(sh, sl, r * s_local) for r, sh in enumerate(shards)]
        check(all(torch.equal(a, b) for a, b in zip(gk, gp)),
              "slab_gather_owned equals its plain version (dp %d)" % dp)
        total = collectives.psum(gk)[0].cpu().numpy()
        check(total.tobytes() == want.tobytes(),
              "the psum of the ranks' gathers is the slab's rows bit for bit (dp %d)" % dp)
        words = torch.from_numpy(new).to(device)
        sk = [V.TraceCarry(*(t.clone() for t in sh)) for sh in shards]
        sp_ = [V.TraceCarry(*(t.clone() for t in sh)) for sh in shards]
        for r in range(dp):
            V.slab_scatter_owned(sk[r], words, sl, r * s_local)
            V.slab_scatter_owned_plain(sp_[r], words, sl, r * s_local)
        check(all(_carry_same(a, b) for a, b in zip(sk, sp_)),
              "slab_scatter_owned equals its plain version (dp %d)" % dp)
        joined = torch.cat([V.carry_words(sh) for sh in sk]).cpu().numpy()
        check(joined.tobytes() == after.tobytes(),
              "the scattered shards are the slab with its owned rows written (dp %d)" % dp)
        if dp not in timed_dps:
            continue
        owned = int(((slots >= 0) & (slots < s_local)).sum())
        slot_b = 12 * K + 17
        for name, fn, plain, nbytes in (
                ("slab_gather_owned",
                 lambda sh=shards[0]: V.slab_gather_owned(sh, sl, 0),
                 lambda sh=shards[0]: V.slab_gather_owned_plain(sh, sl, 0),
                 slot_b * owned + 4 * B + 4 * B * W),
                ("slab_scatter_owned",
                 lambda sh=sk[0], w=words: V.slab_scatter_owned(sh, w, sl, 0),
                 lambda sh=sp_[0], w=words: V.slab_scatter_owned_plain(sh, w, sl, 0),
                 4 * owned * W + 4 * B + slot_b * owned)):  # unowned rows: nothing read
            bnd, by = bound(nbytes, B * W)
            what = "dp %d rank 0, %d rows (%d owned) of a %d-slot slab, K=%d" % (
                dp, B, owned, S, K)
            r = dict(name=name, route="cuda", source="reporter_tpu_torch/csrc/slab_shard.cu",
                     replaces="reporter_tpu/ops/viterbi.py:%d" % (
                         1047 if "gather" in name else 1082),
                     max_abs_err=0.0, bound_ms=bnd, bound_by=by, library_ms=None,
                     owned_rows=owned, fn=fn, plain=plain)
            if timed:
                r["ms"] = times["%s dp %d K=%d B=%d" % (name, dp, K, B)] = time_ms(
                    fn, label="%s dp %d rank 0 K=%d B=%d" % (name, dp, K, B))
                r["plain_ms"] = time_ms(plain, queued=False)
            rows.setdefault(name, r)
            print("kernel %-27s %s: equal its plain version at dp 2 and 4, bit for bit; "
                  "kernel_ms=%s plain_ms=%s bound_ms=%.5f (%s)"
                  % (name, what, "%.4f" % r["ms"] if "ms" in r else "-",
                     "%.4f" % r["plain_ms"] if "plain_ms" in r else "-", bnd, by))
    return list(rows.values()), times


def launch_floor(smi):
    """The least time ``time_ms`` reads for a kernel launch: a one-thread
    kernel of PyTorch's (``torch.cuda._sleep(1)``), queued behind the
    spin, back to back, an event between each two.  Printed with the
    card's name and power limit."""
    import torch

    floor = time_ms(lambda: torch.cuda._sleep(1), reps=100)
    print("launch floor: floor_ms=%.4f (torch.cuda._sleep(1) under time_ms: queued, back to "
          "back, an event between each two) on %s" % (floor, smi))
    return floor


SLAB_MAPS = ("rank 0", "none owned", "padding", "shuffled", "boundaries")
SLAB_KS = (1, 2, 3, 4, 7, 8, 9, 16, 27, 32)  # every words-a-lane count, K % 4 both ways
SLAB_BS = (1, 7, 33, 512, 4096)
SLAB_DPS = (1, 2, 4, 8)


def slab_edge_slots(S, dp, B, kind, seed=0):
    """[B] int32 global slot map of an S-slot slab split over dp ranks
    (numpy), live slots distinct, S a padding row: every live row owned by
    rank 0 ("rank 0"), by the other ranks ("none owned"; all padding at dp
    1), all padding, distinct slots anywhere with an eighth of the rows
    padding ("shuffled"), or the slots lo - 1, lo, lo + S_local - 1 and lo +
    S_local of every shard ("boundaries"), as many as B holds; rows in a
    seeded order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    s_local = S // dp
    if kind == "rank 0":
        live = rng.choice(s_local, min(B, s_local), replace=False)
    elif kind == "none owned":
        live = s_local + rng.choice(S - s_local, min(B, S - s_local), replace=False)
    elif kind == "padding":
        live = np.zeros(0, np.int64)
    elif kind == "shuffled":
        live = rng.choice(S, min(B - B // 8, S), replace=False)
    elif kind == "boundaries":
        edges = {lo + d for lo in range(0, S, s_local) for d in (-1, 0, s_local - 1, s_local)}
        live = rng.permutation(sorted(e for e in edges if 0 <= e < S))[:B]
    else:
        raise ValueError(kind)
    out = np.full(B, S, np.int32)
    out[:len(live)] = live
    return out[rng.permutation(B)]


def slab_edge_words(S, K, seed=0):
    """[S, 3K + 5] int32 slab rows (numpy): seeded bit patterns, the active
    word 0 or 1, every float word -0.0 on rows 3i and a NaN payload on rows
    3i + 1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    W = 3 * K + 5
    raw = rng.integers(-2 ** 31, 2 ** 31, (S, W), dtype=np.int64).astype(np.int32)
    raw[:, 3 * K + 3] &= 1
    floats = np.r_[0:K, 2 * K:3 * K, 3 * K:3 * K + 3]  # scores, offset, x, y, t
    raw[0::3, floats] = np.int32(-2 ** 31)  # -0.0
    raw[1::3, floats] = np.array(0x7FC00001, np.uint32).view(np.int32)
    return raw


def slab_edges(device, S=32768):
    """Kernel 11c on edge inputs: at every K of ``SLAB_KS``, B of
    ``SLAB_BS``, dp of ``SLAB_DPS`` and slot map of ``SLAB_MAPS`` over an
    S-slot slab (-0.0 and NaN payloads in every float leaf), each rank's
    gather and scatter equal their plain versions bit for bit, the psum of
    the ranks' gathers is the slab's rows (zeros for padding) and the
    scattered slab is the slab with its live rows written; at B = 33 and
    512 also on shards whose leaves are views one row into their storage
    (4-byte and 1-byte offsets).  Untimed."""
    import numpy as np
    import torch

    from reporter_tpu_torch.ops import collectives
    from reporter_tpu_torch.ops import viterbi as V

    t0 = time.perf_counter()
    n = 0
    for K in SLAB_KS:
        raw = slab_edge_words(S + 1, K, seed=K)
        full = V.carry_from_words(torch.from_numpy(raw).to(device), K)
        words_all = torch.from_numpy(raw[1:]).to(device)
        aligned = V.carry_from_words(words_all, K)
        new_all = torch.from_numpy(slab_edge_words(max(SLAB_BS), K, seed=100 + K)).to(device)
        bad = []
        for B in SLAB_BS:
            new = new_all[:B]
            for dp in SLAB_DPS:
                s_local = S // dp
                for kind in SLAB_MAPS:
                    for off in ((0, 1) if B in (33, 512) and kind == "shuffled" else (0,)):
                        case = "K=%d B=%d dp %d %s%s" % (K, B, dp, kind, " offset" if off else "")
                        np_slots = slab_edge_slots(S, dp, B, kind, seed=K * 7 + B + dp)
                        sl = torch.from_numpy(np_slots).to(device)
                        src = full if off else aligned
                        slab = V.TraceCarry(*(t[off:] for t in src))
                        shards = [V.TraceCarry(*(t[r * s_local:(r + 1) * s_local] for t in slab))
                                  for r in range(dp)]
                        gk = [V.slab_gather_owned(sh, sl, r * s_local)
                              for r, sh in enumerate(shards)]
                        gp = [V.slab_gather_owned_plain(sh, sl, r * s_local)
                              for r, sh in enumerate(shards)]
                        live = (sl < S)[:, None]
                        want = torch.where(live, words_all[sl.long().clamp(max=S - 1)], 0)
                        bad.append((case + " gather", sum((a != b).sum() for a, b in zip(gk, gp))
                                    + (collectives.psum(gk)[0] != want).sum()))
                        outs = []
                        for scatter in (V.slab_scatter_owned, V.slab_scatter_owned_plain):
                            store = V.TraceCarry(*(t.clone() for t in src))
                            view = V.TraceCarry(*(t[off:] for t in store))
                            for r in range(dp):
                                scatter(V.TraceCarry(*(t[r * s_local:(r + 1) * s_local]
                                                       for t in view)), new, sl, r * s_local)
                            outs.append(V.carry_words(view))
                        after = words_all.clone()
                        keep = sl < S
                        after[sl[keep].long()] = new[keep]
                        bad.append((case + " scatter", (outs[0] != outs[1]).sum()
                                    + (outs[0] != after).sum()))
                        n += 1
        counts = torch.stack([b for _, b in bad]).cpu().numpy()
        check(not counts.any(), "slab kernels equal their plain versions and the slab: %s"
              % [c for (c, _), k in zip(bad, counts) if k][:8])
    dt = time.perf_counter() - t0
    print("slab edges: %d cases (K %s, B %s, dp %s, maps %s; shards one row into their storage "
          "at B = 33, 512): gather and scatter equal their plain versions and the slab bit for "
          "bit, -0.0 and NaN payloads kept, in %.1f s" % (
              n, list(SLAB_KS), list(SLAB_BS), list(SLAB_DPS), list(SLAB_MAPS), dt))
    return {"cases": n, "s": dt}


def mesh_step_split(matcher, traces64, timed, dps=(2, 4)):
    """One ``session_step_arena_mesh`` at dp 2 and 4: 512 rows of 4 points
    (480 continuing, 16 fresh, 16 padding; K = 8) against the 65,536-slot
    slab split over the ranks (every rank on this card), equal to the
    single-slab step (packed and slab bit for bit), timed whole and in its
    parts as the step runs them: the 11c kernels (every rank's gather and
    scatter), the psum and the all-gather, the words <-> carry glue
    (``mesh_carry_in``: ``carry_from_words`` and the ``where`` with
    ``initial_carry_batch``; ``carry_words``), kernels 1-3 and kernel 5,
    each part through the functions the step calls.  Events around each part,
    back to back, with the host's gaps (the step's Python and launches are
    the caller's time).  Returns {part: ms} for each dp (untimed: {})."""
    import numpy as np
    import torch

    from reporter_tpu_torch.ops import collectives
    from reporter_tpu_torch.ops import viterbi as V

    dev = matcher.device
    dg, du, p = matcher._dg, matcher._du, matcher._params
    S, B, K, Wn = matcher.cfg.max_sessions, len(traces64), matcher.cfg.beam_k, 4
    rng = np.random.default_rng(5)
    slots = np.full(B, S, np.int32)
    slots[:B - 16] = rng.choice(S, B - 16, replace=False)
    use = np.zeros(B, bool)
    use[:B - 32] = True
    xs0, xs1 = (session_rows(matcher, traces64[:B - 16], j, Wn) for j in (0, Wn))
    slab = V.initial_carry_batch(S, K, dev)
    V.session_step_arena(dg, du, xs0, p, K, slab, slots, np.zeros(B, bool))
    one = V.TraceCarry(*(t.clone() for t in slab))
    want = V.session_step_arena(dg, du, xs1, p, K, one, slots, use)
    out = {}
    for dp in dps:
        s_local, b_local = S // dp, B // dp
        shards = [V.TraceCarry(*(t[r * s_local:(r + 1) * s_local].clone() for t in slab))
                  for r in range(dp)]
        saved = [V.TraceCarry(*(t.clone() for t in sh)) for sh in shards]

        def restore(shards=shards, saved=saved):
            for sh, sv in zip(shards, saved):
                for d, v in zip(sh, sv):
                    d.copy_(v)
        ranks = [(dg, du)] * dp
        xins = [xs1[:, r * b_local:(r + 1) * b_local].contiguous() for r in range(dp)]
        step = lambda ranks=ranks, xins=xins, shards=shards: V.session_step_arena_mesh(  # noqa: E731
            ranks, xins, p, K, shards, slots, use)
        packed, _aux = step()
        check(torch.equal(torch.cat(packed, 1), want[0]),
              "the dp %d mesh step's packed output equals one slab's" % dp)
        check(_carry_same(V.TraceCarry(*(torch.cat(leaf) for leaf in zip(*shards))), one),
              "the dp %d mesh step's slab equals one slab's" % dp)
        # the parts, on the step's own intermediates
        restore()
        sls, usem = V.mesh_slot_rows(slots, use, shards)
        gathered = [V.slab_gather_owned(sh, sl, r * s_local)
                    for r, (sh, sl) in enumerate(zip(shards, sls))]
        words = collectives.psum(gathered)
        mine = [slice(r * b_local, (r + 1) * b_local) for r in range(dp)]
        glue_in = lambda: [V.mesh_carry_in(w[rows], usem[rows], K)  # noqa: E731
                           for w, rows in zip(words, mine)]
        carries = glue_in()
        pres = [V.precompute_batch_packed(dg, du, x, p, K) for x in xins]
        outs = [V.chain_batch_carry_packed_aux(dg, du, pr, x, p, K, c)
                for pr, x, c in zip(pres, xins, carries)]
        cwords = [V.carry_words(o[2]) for o in outs]
        cw = collectives.all_gather(cwords)
        parts = {
            "step": (step, restore),
            "11c kernels": (lambda: ([V.slab_gather_owned(sh, sl, r * s_local)
                                      for r, (sh, sl) in enumerate(zip(shards, sls))],
                                     [V.slab_scatter_owned(sh, w, sl, r * s_local)
                                      for r, (sh, w, sl) in enumerate(zip(shards, cw, sls))]),
                            restore),
            "psum + all_gather": (lambda: (collectives.psum(gathered),
                                           collectives.all_gather(cwords)), None),
            "glue": (lambda: (glue_in(), [V.carry_words(o[2]) for o in outs]), None),
            "kernels 1-3": (lambda: [V.precompute_batch_packed(dg, du, x, p, K) for x in xins],
                            None),
            "kernel 5": (lambda: [V.chain_batch_carry_packed_aux(dg, du, pr, x, p, K, c)
                                  for pr, x, c in zip(pres, xins, carries)], None),
        }
        if not timed:  # the CPU rehearsal: each part runs once
            for fn, _prep in parts.values():
                fn()
            continue
        # under --pair only the step and its 11c part run another tree's
        # code: those two are paired, the rest timed on this tree's build
        ms = {name: time_ms(fn, reps=50, prep=prep, queued=False,
                            label="mesh step dp %d: %s" % (dp, name)
                            if name in ("step", "11c kernels") else None)
              for name, (fn, prep) in parts.items()}
        restore()
        out["dp%d" % dp] = ms
        print("mesh session step dp %d (512 x 4, K=%d, %d-slot slab over %d ranks on one card): "
              "%s ms (events around each part, host gaps included)"
              % (dp, K, S, dp, ", ".join("%s %.4f" % kv for kv in ms.items())))
    return out


def mesh_matcher(matcher, devices, graph_devices=1, ubodt=None, **cfg_kw):
    """A matcher over ``matcher``'s city (its table, or ``ubodt``) on a dp
    x gp mesh whose ranks all share ``matcher``'s card (the chip machine
    has one)."""
    from dataclasses import replace

    from reporter_tpu_torch.matching import SegmentMatcher

    ubodt = ubodt or matcher.ubodt
    cfg_kw.setdefault("ubodt_layout", ubodt.layout)
    mm = SegmentMatcher(arrays=matcher.arrays, ubodt=ubodt,
                        config=replace(matcher.cfg, devices=devices,
                                       graph_devices=graph_devices, **cfg_kw),
                        device=[matcher.device] * devices)
    check(mm._mesh is not None and mm._mesh.shape.get("gp", 1) == graph_devices,
          "a %d-device mesh with gp=%d" % (devices, graph_devices))
    return mm


def _wire(results):
    return json.dumps(results, sort_keys=True)


def mesh_paths(matcher, sm, ubodt_w, traces64, traces256, traces2048, tr_a, xin64):
    """Every path on a dp2 matcher and a dp2 x gp4 matcher (ranks sharing
    the card), through the launch counters, each answer wire-identical to
    the 1-card matcher's: ``match_many`` over 512 x 64, 128 x 256, the
    long cohort and sparse A (and 512 x 64 on the wide32 table split over
    gp); 512 sessions x 4 steps on the slot-sharded slab in groups of
    128 through 256 hot slots and 512 pinned pages (evictions and
    promotions mid-stream), equal to the host-carry path;
    and ``graph_sharded_match_fn`` on the dp2 x gp4 mesh against
    ``match_and_histogram`` on one card."""
    import numpy as np
    import torch

    from reporter_tpu_torch.matching import SessionEngine, SessionStore
    from reporter_tpu_torch.matching.arena import carry_host
    from reporter_tpu_torch.ops import viterbi as V
    from reporter_tpu_torch.parallel import graph_sharded_match_fn, make_mesh2
    from reporter_tpu_torch.parallel import match_and_histogram

    base = {}
    for key, m, trs in (("64", matcher, traces64), ("256", matcher, traces256),
                        ("long", matcher, traces2048), ("A", sm, tr_a)):
        base[key] = _wire(m.match_many(trs))
    cfg = matcher.cfg
    slot_b = 12 * cfg.beam_k + 17
    n = len(traces64)  # 512 on the card: 256 hot slots, 512 pages, groups of 128
    hot, cold, group, steps = n // 2, n, n // 4, 4

    def stream(m):
        eng = SessionEngine(m, SessionStore(cfg.max_sessions, cfg.session_ttl_s),
                            tail_points=cfg.session_tail_points)
        for j in range(0, steps * 4, 4):
            for g in range(0, len(traces64), group):
                eng.match_many([dict(tr, trace=tr["trace"][j:j + 4])
                                for tr in traces64[g:g + group]])
        return eng
    host = stream(matcher)
    out = {"launches": {}, "s": {}}
    for label, devices, gp in (("dp2", 2, 1), ("dp2xgp4", 8, 4)):
        mm = mesh_matcher(matcher, devices, gp)
        smm = mesh_matcher(matcher, devices, gp, sparse=True)
        cases = [("64", mm, traces64, BUCKETED, 64), ("256", mm, traces256, BUCKETED, 256),
                 ("long", mm, traces2048, CARRIED, 256), ("A", smm, tr_a, SPARSE_BUCKETED, 16)]
        if gp > 1:
            cases.append(("64", mesh_matcher(matcher, devices, gp, ubodt=ubodt_w), traces64,
                          BUCKETED, 64))
        for key, m, trs, path, T in cases:
            m.match_many(trs[:2])  # first-call set-up outside the count
            fwd, other = _forward(m, T, key == "long", key == "A", path)
            kernels, absent = _path_kernels(m, fwd)
            res, dt, launches = _counted(kernels, lambda: m.match_many(trs), absent + other)
            name = "%s_%s%s" % (label, key, "_wide32" if m._du.wide else "")
            check(_wire(res) == base[key], "%s match_many is wire-identical to one card" % name)
            out["launches"][name] = launches
            out["s"][name] = dt
        am = mesh_matcher(matcher, devices, gp, session_arena=True,
                          session_arena_bytes=hot * slot_b // devices,
                          session_arena_cold_bytes=cold * slot_b)
        arena = am.session_arena
        check((arena.hot_slots, arena.cold_slots) == (hot, cold), "mesh slab of %d + %d"
              % (hot, cold))
        fwd, other = _forward(am, 4, True)
        kernels, absent = _path_kernels(am, fwd)
        kernels += ("slab_gather_owned", "slab_scatter_owned")
        eng, dt, launches = _counted(kernels, lambda: stream(am), other + absent)
        summ = arena.summary()
        check(summ["promotions"] > 0 and summ["evictions"] > 0,
              "evictions and promotions mid-stream: %s" % summ)
        for tr in traces64:
            u = tr["uuid"]
            s, hs = eng.store.peek(u), host.store.peek(u)
            check(s.records == hs.records, "%s slab records equal one card's (%s)" % (label, u))
            a, b = carry_host(s.carry), carry_host(hs.carry)
            check(all(np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in a),
                  "%s slab beam equals one card's (%s)" % (label, u))
        out["launches"][label + "_session"] = launches
        out["s"][label + "_session"] = dt
        out[label + "_arena"] = summ
        print("mesh %s: match_many over 512x64, 128x256, 64x2048 and sparse A wire-identical "
              "to one card (%s s); 512 sessions x %d steps on the slot-sharded slab (%d hot "
              "slots over %d ranks, %d cold pages: %d promotions, %d evictions) equal to one "
              "card's host carries in %.3f s; launches %s"
              % (label, ", ".join("%s %.3f" % (k, v) for k, v in out["s"].items()
                                   if k.startswith(label) and not k.endswith("session")),
                 steps, hot, devices // gp, cold, summ["promotions"], summ["evictions"], dt,
                 json.dumps({k: v for k, v in launches.items() if v})))
    # graph_sharded_match_fn on the dp2 x gp4 mesh against one card
    S = len(matcher.arrays.seg_ids)
    mesh = make_mesh2(2, 4, [matcher.device] * 8)
    x, y, t, v = V.unpack_inputs(xin64)
    fn = graph_sharded_match_fn(mesh, cfg.beam_k, S)
    fn(matcher._dg, matcher._du, x, y, t, v, matcher._params)  # the table's placement
    (rs, hs), dt, launches = _counted(
        ("candidate_sweep", "ubodt_probe[sharded]", "transition_build", "viterbi_scan",
         "segment_histogram"),
        lambda: fn(matcher._dg, matcher._du, x, y, t, v, matcher._params), ("ubodt_probe",))
    r1, h1 = match_and_histogram(matcher._dg, matcher._du, x, y, t, v, matcher._params,
                                 cfg.beam_k, S)
    check(torch.equal(rs.idx, r1.idx) and torch.equal(rs.breaks, r1.breaks),
          "graph_sharded_match_fn idx equals one card's")
    check(torch.equal(hs.point_count, h1.point_count)
          and torch.equal(hs.trace_count, h1.trace_count), "mesh histogram counts exact")
    for f in ("time_in_segment", "distance_in_segment"):
        check(torch.allclose(getattr(hs, f), getattr(h1, f), rtol=1e-5, atol=1e-3),
              "mesh histogram %s within rtol 1e-5" % f)
    out["launches"]["graph_sharded_match_fn"] = launches
    out["s"]["graph_sharded_match_fn"] = dt
    print("graph_sharded_match_fn on dp2 x gp4 (512x64): idx equals match_and_histogram on one "
          "card, counts exact, sums within rtol 1e-5, in %.3f s, launches %s"
          % (dt, json.dumps({k: v for k, v in launches.items() if v})))
    return out


def mesh_serve_phase(arrays, ubodt, tr_a, default_answers, default_fixtures, device):
    """8 /report of cohort A and the fixture replay through a service whose
    matcher is built under $REPORTER_DEVICES / $REPORTER_GRAPH_DEVICES (a
    dp2 mesh, then a dp2 x gp4 one, the ranks on the one card) on the
    serving defaults: the answers of one card."""
    from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
    from reporter_tpu_torch.serve.__main__ import serving_defaults

    out = {}
    for n, gp in ((2, 1), (8, 4)):
        env = {"REPORTER_DEVICES": str(n), "REPORTER_GRAPH_DEVICES": str(gp)}
        label = "dp2" if gp == 1 else "dp2 x gp4"
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            sv = SegmentMatcher(arrays=arrays, ubodt=ubodt,
                                config=serving_defaults(MatcherConfig()), device=[device] * n)
            check(sv._mesh is not None and sv._mesh.n_dp == 2 and sv._mesh.n_gp == gp,
                  "the environment builds a %s mesh" % label)
            kernels, absent = _path_kernels(sv, SPARSE_BUCKETED)
            (answers,), dt, launches = _counted(kernels, lambda: _serve(sv, 15, tr_a[:8]),
                                                absent)
            check(answers == default_answers, "/report answers on %s equal one card's" % label)
            fixtures = replay_fixtures([device] * n, "a %s mesh on one card" % label)
            check(fixtures == default_fixtures, "fixture answers on %s equal one card's" % label)
        finally:
            for k, v in saved.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
        print("serve on a %s mesh: 8 /report of cohort A in %.2f s and the 6 fixtures "
              "answered as on one card, launches %s"
              % (label, dt, json.dumps({k: v for k, v in launches.items() if v})))
        out[label] = launches
    return out

# -- phase 11: the redesigned kernels (kernel 2's family, the recursion of
# kernels 4 and 5) on edge inputs, and the paired timing against a parent

def edge_keys(matcher, a, b, n_rows=4096, n_empty=1024, n_miss=1024, n_cohort=857):
    """A ragged key set (7,001 keys) that takes every branch of kernel 2's
    warp probe, in a seeded order so that every warp's 32 keys mix them:
    table rows' keys (hits, all distinct), the empty marker's key (-1, 0),
    which meets every empty entry of its rows, node ids past the graph
    (all miss) and the cohort's first keys.  Returns (src, dst) int32 on
    the card; more distinct keys than half the count, so the dedup probe
    takes its full-width fallback on them."""
    import torch

    dev = matcher.device
    rows = matcher.ubodt.rows()
    nn = matcher.arrays.num_nodes
    ka, kb = (t.reshape(-1)[:n_cohort] for t in torch.broadcast_tensors(a, b))
    i32 = dict(dtype=torch.int32, device=dev)
    s = torch.cat([torch.from_numpy(rows[0][:n_rows]).to(**i32), torch.full((n_empty,), -1, **i32),
                   torch.arange(nn, nn + n_miss, **i32), ka])
    d = torch.cat([torch.from_numpy(rows[1][:n_rows]).to(**i32), torch.zeros(n_empty, **i32),
                   torch.arange(n_miss, **i32), kb])
    perm = torch.randperm(s.numel(), generator=torch.Generator().manual_seed(11)).to(dev)
    return s[perm].contiguous(), d[perm].contiguous()


def _probe_into(u, s, d, n_live):
    """Kernel 2 (the instantiation table ``u`` asks) over 1-d keys with the
    device count ``n_live`` into outputs filled with a sentinel first (a
    NaN payload, first edge -7), so that what the launch left unwritten
    shows."""
    import torch

    from reporter_tpu_torch.ops import hashtable as H

    n, dev = s.numel(), s.device
    dist = torch.full((n,), 0x7FC0DEAD, dtype=torch.int32, device=dev).view(torch.float32)
    time_ = dist.clone()
    first = torch.full((n,), -7, dtype=torch.int32, device=dev)
    return H._probe(u, s, d, True, n_live=n_live, out=(dist, time_, first))


def _bits_equal(a, b):
    """Two result tuples equal bit for bit (NaN payloads included)."""
    import torch

    def bits(t):
        return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.uint8)
    return all(x.dtype == y.dtype and bits(x).equal(bits(y)) for x, y in zip(a, b))


def _sweep_equal(a, b):
    """Two sweeps' outputs equal bit for bit, and unwritten (None) alike."""
    fa, fb = ([s.cand.edge, s.cand.offset, s.cand.dist, s.cand.cx, s.cand.cy, s.emis,
               s.to_node, s.from_node] for s in (a, b))
    return (all((x is None) == (y is None) for x, y in zip(fa, fb))
            and _bits_equal([x for x in fa if x is not None], [y for y in fb if y is not None]))


def probe_edges(matcher, ubodt_w, du_w, xin):
    """Kernel 2's family on ``edge_keys``: for the cuckoo and wide32
    tables, untiered, tiered at the partial budget (after one maintenance
    pass on the cohort's keys: hot and cold rows) and every rank of gp 4
    (most keys out of the rank's range), the kernel equals its plain
    version bit for bit, with equal fetch counts and hit/miss totals on
    the tiered tables; with ``n_live`` 0, 3,001 and above the key count,
    exactly the first n_live outputs are written, equal to the plain
    probe's, and a tiered launch counts exactly their fetches; the dedup
    probe (its full-width fallback on the keys, its compact probe on the
    keys three times over) equals the plain probe.  Returns a summary."""
    import torch

    from reporter_tpu_torch.ops import hashtable as H
    from reporter_tpu_torch.ops import viterbi as V
    from reporter_tpu_torch.ops.candidates import candidate_sweep

    dev, p, K = matcher.device, matcher._params, matcher.cfg.beam_k
    x, y, _t, v = V.unpack_inputs(xin)
    sw = candidate_sweep(matcher._dg, x, y, v, K, p.search_radius, p.sigma_z, False)
    a, b = sw.to_node[:, :-1, :, None], sw.from_node[:, 1:, None, :]
    s, d = edge_keys(matcher, a, b)
    n = s.numel()
    s3, d3 = s.repeat(3), d.repeat(3)
    out = {"keys": n}
    for ubodt, du in ((matcher.ubodt, matcher._du), (ubodt_w, du_w)):
        # the (-1, 0) key's rows: how many empty entries it meets (each a hit)
        e = torch.tensor([-1], dtype=torch.int32, device=dev)
        z = torch.zeros(1, dtype=torch.int32, device=dev)
        hs = [H.device_pair_hash(e, z, du.bmask)] + (
            [] if du.wide else [H.device_pair_hash2(e, z, du.bmask)])
        ent = du.packed[torch.cat(hs)].reshape(-1, 8)
        out[du.layout + "_empty_hits"] = int(((ent[:, 0] == -1) & (ent[:, 1] == 0)).sum())
        tier, _info = tier_table(ubodt, TIER_PARTIAL, dev, (a, b))
        tables = [(du.layout, du, None), (du.layout + " tiered", tier.device(), tier)]
        tables += [("%s gp4 rank %d" % (du.layout, g), view, None)
                   for g, view in enumerate(_views(du, 4)[0])]
        for what, u, tr in tables:
            name = H.probe_kernel_name(u)
            got, dk = _tier_delta(tr, lambda: H.ubodt_lookup(u, s, d))
            want, dp = _tier_delta(tr, lambda: H.ubodt_lookup_plain(u, s, d))
            check(_bits_equal(got, want), "%s (%s) on the edge keys equals its plain version"
                  % (name, what))
            _same_fetches(dk, dp, "%s (%s) edge keys" % (name, what))
            for c in ((0, 3001, n + 1) if dev.type == "cuda" else ()):
                cnt = torch.tensor([c], dtype=torch.int32, device=dev)
                outs, dk = _tier_delta(tr, lambda: _probe_into(u, s, d, cnt))
                live = c if c <= n else 0
                check(_bits_equal([o[:live] for o in outs], [w[:live] for w in want]),
                      "%s (%s) n_live %d: the live outputs equal the plain probe" % (name, what, c))
                check(bool((outs[2][live:] == -7).all()) and bool(
                    (outs[0][live:].view(torch.int32) == 0x7FC0DEAD).all()),
                      "%s (%s) n_live %d: nothing written past the live count" % (name, what, c))
                if tr is not None:
                    ref, dp = _tier_delta(tr, lambda: H.ubodt_lookup_plain(u, s[:live], d[:live])
                                          if live else None)
                    if live:
                        _same_fetches(dk, dp, "%s n_live %d" % (name, c))
                    else:
                        check(int(dk[0].abs().sum()) == 0 and dk[1] == [0, 0],
                              "%s n_live %d: no fetch counted" % (name, c))
            if not getattr(u, "sharded", False):
                for ks, kd, path in ((s, d, "fallback"), (s3, d3, "compact")):
                    H.DEDUP.reset()
                    dd, dk = _tier_delta(tr, lambda: H.ubodt_lookup_dedup(u, ks, kd))
                    dq, dp = _tier_delta(tr, lambda: H.ubodt_lookup_dedup_plain(u, ks, kd))
                    full = H.ubodt_lookup_plain(u, ks, kd)
                    fell = int(dd.n_unique[0]) > dd.m
                    check(fell == (path == "fallback") and _bits_equal(dd[:3], full)
                          and _bits_equal(dq[:3], full),
                          "dedup probe (%s, %s) on the edge keys equals the plain probe"
                          % (what, path))
                    _same_fetches(dk, dp, "dedup probe (%s, %s)" % (what, path))
        tier.close()
        print("probe edges %s: %d keys ((-1, 0) meets %d empty entries in its rows), untiered, "
              "tiered and every gp-4 rank: kernel = plain bit for bit, n_live 0 / 3001 / n+1 "
              "exact, fetch counts equal; dedup fallback and compact probe exact"
              % (du.layout, n, out[du.layout + "_empty_hits"]))
    return out


def nan_legs(xin, seam=None, prev=None, frac=0.02, seed=0):
    """A copy of the packed [4, B, T] input ``xin`` in which a seeded
    ``frac`` of the points (t >= 1), and with ``seam`` the point t = seam
    of every fourth row (b % 4 == 1), have an x of NaN and their
    predecessor's y: steps whose x leg is NaN beside a y leg of 0 (the
    legs for which ``rtt::hypot_like_jax`` once gave 0 where ``jnp.hypot``
    gives NaN).  A point at t = 0 (``seam`` 0) takes the last y of
    ``prev``, the packed input of the window before: the seam's step
    from the carried point."""
    import numpy as np
    import torch

    out = xin.clone()
    B, T = out.shape[1:]
    pick = np.random.default_rng(seed).uniform(size=(B, T)) < frac
    pick[:, 0] = False
    if seam is not None:
        pick[1::4, seam] = True
    first = prev[1, :, -1:] if prev is not None else out[1, :, :1]
    prev_y = torch.cat([first, out[1, :, :-1]], 1)
    m = torch.from_numpy(pick).to(out.device)
    out[1] = torch.where(m, prev_y, out[1])
    out[0] = torch.where(m, torch.full_like(out[0], float("nan")), out[0])
    return out


def recursion_edges(matcher, xin64, xin_a, pa, ka, spa):
    """Kernels 4 and 5 (the redesigned recursion) in every instantiation
    <K, CARRY, SPARSE>, K = 1, 2, 4, 8, 16 and 32, each against its plain
    version: on the first B rows of the 512 x 64 cohort the scan (with its
    chosen slots) and the chain over the rows' second 32 points continuing
    the carries of their first 32 (both windows held); on cohort A's
    first B rows (512 x 16 at 45 s, its parameters ``pa``, ``spa``) the
    sparse scan and the sparse chain over two windows of 8.  B = 1, 16
    and 512, and 64 and 256 at the matcher's K and 64 at A's (``ka``), so
    that the block sizing takes each branch (32, 64 and 128 threads at K
    = 8) and the shared-memory ring each depth; at every K also on 16 rows
    of each with x legs of NaN beside y legs of 0 (``nan_legs``: inside
    the windows and at the second window's seam).  Returns the shapes
    checked."""
    import torch

    from reporter_tpu_torch.ops import viterbi as V

    dev, dg, du = matcher.device, matcher._dg, matcher._du
    p, K8 = matcher._params, matcher.cfg.beam_k
    done = []

    def scan(x, p_, K, sp, what):
        pre = V.precompute_batch_packed(dg, du, x, p_, K, sp)
        _x, _y, t, v = V.unpack_inputs(x)
        args = (pre.emis, pre.logp, pre.gc, v, pre.cand.edge, pre.cand.offset,
                p_.breakage_distance, t, sp)
        kw = {} if sp is not None else {"with_choice": True}
        k, q = V.viterbi_scan(*args, **kw), V.viterbi_scan_plain(*args, **kw)
        check(torch.equal(k[0], q[0]) and all(torch.equal(u, w) for u, w in zip(k[2:], q[2:]))
              and torch.allclose(k[1], q[1], rtol=1e-4, atol=0),
              "%s equals its plain version" % what)

    def chain(x, p_, K, sp, what):
        """Two windows (x's halves), the second from the first's carries."""
        W = x.shape[2] // 2
        carry = V.initial_carry_batch(x.shape[1], K, dev)
        for w, xw in enumerate((x[:, :, :W].contiguous(), x[:, :, W:].contiguous())):
            pre = V.precompute_batch_packed(dg, du, xw, p_, K, sp)
            args = (dg, du, pre.emis, pre.logp, pre.gc, *V.unpack_inputs(xw), pre.cand.edge,
                    pre.cand.offset, p_, carry)
            k, q = V.viterbi_chain(*args, sp=sp), V.viterbi_chain_plain(*args, sp=sp)
            check(torch.equal(k[0], q[0]) and _carry_same(k[2], q[2])
                  and torch.allclose(k[1], q[1], rtol=1e-4, atol=0),
                  "%s (window %d) equals its plain version" % (what, w))
            carry = k[2]

    nan64 = nan_legs(xin64[:, :16], seam=32, seed=1)
    nan_a = nan_legs(xin_a[:, :16], seam=8, seed=2)
    for K in (1, 2, 4, 8, 16, 32):
        for B in (1, 16, 64, 256, 512) if K == K8 else (1, 16, 512):
            x = xin64[:, :B].contiguous()
            scan(x, p, K, None, "viterbi_scan %dx64 K=%d" % (B, K))
            chain(x, p, K, None, "viterbi_chain %dx32 K=%d" % (B, K))
            done.append("%dx64 K=%d" % (B, K))
        for B in (1, 16, 64, 512) if K == ka else (1, 16, 512):
            x = xin_a[:, :B].contiguous()
            scan(x, pa, K, spa, "viterbi_scan[sparse] %dx16 K=%d" % (B, K))
            chain(x, pa, K, spa, "viterbi_chain[sparse] %dx8 K=%d" % (B, K))
            done.append("sparse %dx16 K=%d" % (B, K))
        # x legs of NaN beside y legs of 0, in the windows and at the seam
        scan(nan64, p, K, None, "viterbi_scan 16x64 K=%d (NaN x legs)" % K)
        chain(nan64, p, K, None, "viterbi_chain 16x32 K=%d (NaN x legs)" % K)
        scan(nan_a, pa, K, spa, "viterbi_scan[sparse] 16x16 K=%d (NaN x legs)" % K)
        chain(nan_a, pa, K, spa, "viterbi_chain[sparse] 16x8 K=%d (NaN x legs)" % K)
        done.append("NaN x legs 16x64, sparse 16x16 K=%d" % K)
    print("recursion edges: viterbi_scan (with chosen slots) and viterbi_chain (two windows), "
          "dense on the 512 x 64 cohort's first B rows and sparse on A's, at K = 1, 2, 4, 8, "
          "16, 32 and B = 1, 16, 512 (and 64, 256 at K = %d, 64 at K = %d), and on 16 rows "
          "with x legs of NaN beside y legs of 0 (in the windows and at the seam): each equal "
          "to its plain version" % (K8, ka))
    return done


# -- phase 12: the redesigned candidate sweep (kernel 1) and transition
# build (kernel 3, dense and sparse) on edge inputs, and timed at the main
# path's shapes.  The input makers are numpy only: tests/test_torch_sweep_design.py
# holds the plain versions against the JAX package on the same inputs.

SWEEP_CELLS = ((100.0, 2), (200.0, None), (450.0, None))  # caps 2, 24, 56 on 150 m blocks
SWEEP_KINDS = ("node", "block centre", "border", "cell line", "near road", "NaN x", "uniform")


def sweep_edge_points(arrays, B=16, T=256, seed=0):
    """[B, T] float32 px, py and valid of points that take the sweep's
    edge branches, in a seeded order: graph nodes (every edge that meets
    there ties), block centres (75 m from the roads of the grid cities'
    150 m blocks: every item misses), points beyond each border of the
    grid (clamped cells repeat), points exactly on cell lines and
    midlines (the quadrant's side decided at 0 and 0.5), points near the
    roads, points whose x is NaN and whose y is a node's (the cell lookup
    takes x's cell index to 0, the grid's empty margin column: no item,
    no candidate) and uniform points over the grid; valid 0 for the first
    row and a seeded tenth of the rest.  Also returns each point's kind, its index
    in ``SWEEP_KINDS``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, per = B * T, B * T // 8
    nx, ny, cs = arrays.grid_nx, arrays.grid_ny, np.float32(arrays.cell_size)
    x0, y0 = np.float32(arrays.grid_x0), np.float32(arrays.grid_y0)
    w, h = nx * cs, ny * cs
    node = rng.integers(0, arrays.num_nodes, per)
    nxy = np.stack([arrays.node_x[node], arrays.node_y[node]], 1)
    centre = np.stack([arrays.node_x[node[::-1]], arrays.node_y[node[::-1]]], 1) + 75.0
    side = rng.integers(0, 4, per)
    along = rng.uniform(-100.0, max(w, h) + 100.0, per)
    out = rng.uniform(1.0, 600.0, per)
    border = np.stack([np.select([side == 0, side == 1], [x0 - out, x0 + w + out], x0 + along),
                       np.select([side == 2, side == 3], [y0 - out, y0 + h + out], y0 + along)], 1)
    cells = np.stack([rng.integers(0, nx, per), rng.integers(0, ny, per)], 1).astype(np.float32)
    half = rng.integers(0, 2, (per, 2)).astype(np.float32) * np.float32(0.5)
    lines = np.stack([x0, y0]) + (cells + half) * cs
    along_x = rng.integers(0, 2, per) == 1
    run, across = rng.uniform(-60.0, 60.0, per), rng.uniform(-3.0, 3.0, per)
    near = nxy[rng.permutation(per)] + np.stack([np.where(along_x, run, across),
                                                 np.where(along_x, across, run)], 1)
    rest = np.stack([rng.uniform(x0, x0 + w, n - 6 * per), rng.uniform(y0, y0 + h, n - 6 * per)], 1)
    nan_x = np.stack([np.full(per, np.nan), arrays.node_y[rng.integers(0, arrays.num_nodes, per)]],
                     1)
    groups = [nxy, centre, border, lines, near, nan_x, rest]
    pts = np.concatenate(groups).astype(np.float32)
    kind = np.concatenate([np.full(len(g), i) for i, g in enumerate(groups)])
    order = rng.permutation(n)
    pts, kind = pts[order], kind[order]
    valid = (rng.uniform(size=n) >= 0.1).astype(np.float32)
    valid[:T] = 0.0
    return (pts[:, 0].reshape(B, T).copy(), pts[:, 1].reshape(B, T).copy(),
            valid.reshape(B, T), kind.reshape(B, T))


PI32 = 3.14159265358979323846  # rounds to the kernels' kPi in float32
# headings that take every branch of the kernels' angle difference: +-pi,
# their neighbours, 0, +-pi/2 and values outside [-pi, pi] (fmodf's own
# range), beside uniform ones
EDGE_HEADINGS = (PI32, -PI32, 3.1415925, -3.1415925, 0.0, PI32 / 2, -PI32 / 2, 10.0, -10.0,
                 7.0, -7.0, 2 * PI32)


def nan_steps(px, py, frac=0.03, seed=0):
    """Copies of the [B, T] float32 points ``px``, ``py`` in which a seeded
    ``frac`` of the points t >= 1 (and the last row's last point) have an
    x of NaN and their predecessor's y: steps whose x leg is NaN beside a
    y leg of 0."""
    import numpy as np

    px, py = px.copy(), py.copy()
    B, T = px.shape
    pick = np.random.default_rng(seed).uniform(size=(B, max(T - 1, 0))) < frac
    if B and T >= 2:
        pick[-1, -1] = True
    px[:, 1:][pick], py[:, 1:][pick] = np.nan, py[:, :-1][pick]
    return px, py


def build_edge_inputs(B, T, K, back_tol, seed=0, E=48):
    """Numpy inputs of the transition build (kernel 3) that take its edge
    branches: [E, 8] edge rows (lengths 0-500 m, speeds 0 to 30 m/s,
    headings from ``EDGE_HEADINGS`` and uniform), [B, T, K] candidates
    (empty slots -1; a third of slots keep the previous point's edge, its
    offset moved forward, back within ``back_tol`` (jitter), back exactly
    ``back_tol`` or back beyond it (a loop)), [B, T] points (some
    repeated: gc 0) and times (gaps of -1 to 120 s: some <= 0), and [B,
    T-1, K, K] probe results (finite, 0 and +inf).  Returns a dict of
    float32 / int32 arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f32 = np.float32
    rows = np.zeros((E, 8), f32)
    rows[:, 0] = rng.integers(0, 1000, E).astype(np.int32).view(f32)
    rows[:, 1] = rng.integers(0, 1000, E).astype(np.int32).view(f32)
    rows[:, 2] = np.where(rng.uniform(size=E) < 0.1, 0.0, rng.uniform(1.0, 500.0, E))
    rows[:, 3] = rng.choice([0.0, 0.05, 0.1, 5.0, 13.9, 30.0], E)
    heads = np.asarray(EDGE_HEADINGS, f32)
    for c in (4, 5):
        pick = rng.uniform(size=E) < 0.6
        rows[:, c] = np.where(pick, rng.choice(heads, E), rng.uniform(-PI32, PI32, E))
    edge = rng.integers(0, E, (B, T, K)).astype(np.int32)
    edge[rng.uniform(size=(B, T, K)) < 0.15] = -1
    offset = rng.uniform(0.0, 400.0, (B, T, K)).astype(f32)
    keep = rng.uniform(size=(B, T - 1, K)) < 0.35
    step = rng.choice([0, 1, 2, 3, 4], (B, T - 1, K))
    tol = f32(back_tol)
    delta = np.select([step == 0, step == 1, step == 2, step == 3],
                      [rng.uniform(0.0, 80.0, step.shape), -rng.uniform(0.0, tol, step.shape),
                       np.full(step.shape, -tol), -rng.uniform(tol, 300.0, step.shape)],
                      0.0).astype(f32)
    for t in range(1, T):
        k = keep[:, t - 1]
        edge[:, t][k] = edge[:, t - 1][k]
        offset[:, t - 1][k & (step[:, t - 1] == 2)] = tol  # then 0 - tol: exactly back
        offset[:, t][k] = offset[:, t - 1][k] + delta[:, t - 1][k]
    px = rng.uniform(-3000.0, 3000.0, (B, T)).astype(f32)
    py = rng.uniform(-3000.0, 3000.0, (B, T)).astype(f32)
    rep = rng.uniform(size=(B, T - 1)) < 0.05
    px[:, 1:][rep], py[:, 1:][rep] = px[:, :-1][rep], py[:, :-1][rep]
    gaps = rng.choice([-1.0, 0.0, 0.5, 1.0, 5.0, 45.0, 60.0, 120.0], (B, T - 1))
    times = np.concatenate([np.zeros((B, 1)), np.cumsum(gaps, 1)], 1).astype(f32)
    shape = (B, T - 1, K, K)
    u = rng.uniform(size=shape)
    sp_dist = np.where(u < 0.2, np.inf, np.where(u < 0.3, 0.0,
                                                 rng.uniform(0.0, 3000.0, shape))).astype(f32)
    v = rng.uniform(size=shape)
    sp_time = np.where(u < 0.2, np.inf, np.where(v < 0.1, 0.0, np.where(
        v > 0.97, np.inf, rng.uniform(0.0, 300.0, shape)))).astype(f32)
    return dict(edge_rows=rows, edge=edge, offset=offset, px=px, py=py, times=times,
                sp_dist=sp_dist, sp_time=sp_time)


def sweep_graphs(device, rows=16):
    """{cap: DeviceGraph on ``device``} of a ``rows`` x ``rows`` grid city
    of 150 m blocks at each of ``SWEEP_CELLS``: 100 m cells cut to 2
    items (``bucket_cap=2``: 4 * cap < K for K > 2, the pad path), 200 m
    cells (cap 24) and 450 m cells (cap 56: the chunked selection)."""
    from reporter_tpu_torch.tiles.arrays import build_graph_arrays
    from reporter_tpu_torch.tiles.network import grid_city

    net = grid_city(rows, rows, spacing_m=150.0)
    out = {}
    for cell, cap in SWEEP_CELLS:
        arrays = build_graph_arrays(net, cell_size=cell, bucket_cap=cap)
        dg = arrays.to_device(device)
        out[dg.cap] = (arrays, dg)
    return out


def sweep_edges(matcher, xin, timed):
    """Kernel 1 (the redesigned sweep) against its plain version bit for
    bit, ``full`` true and false: on the metro city (cap 8) at every K of
    1-32 over ``sweep_edge_points`` and the first 4,096 points of the
    packed cohort ``xin``; on ``sweep_graphs``' caps 2, 24 and 56 at K =
    1, 2, 8, 16 and 32 over their own edge points.  ``timed``: also time
    kernel 1 at K = 8 and 16 on each of those caps over 32,768 points (512
    x 64 of edge points), a labelled call that ``--pair`` compares.
    Returns {graph: [K checked]}."""
    import torch

    from reporter_tpu_torch.ops import viterbi as V
    from reporter_tpu_torch.ops.candidates import candidate_sweep, candidate_sweep_plain

    dev, p = matcher.device, matcher._params
    x, y, _t, v = V.unpack_inputs(xin)
    graphs = {8: (matcher.arrays, matcher._dg)}
    graphs.update(sweep_graphs(dev))
    done = {}

    def on(a):
        return torch.from_numpy(a).to(dev)

    for cap, (arrays, dg) in graphs.items():
        pts = [on(a) for a in sweep_edge_points(arrays, seed=cap)[:3]]
        if cap == 8:
            pts = [torch.cat([a, b.reshape(-1)[:4096].reshape(16, 256)])
                   for a, b in zip(pts, (x, y, v))]
        ks = range(1, 33) if cap == 8 else (1, 2, 8, 16, 32)
        for K in ks:
            for full in (True, False):
                args = (dg, *pts, K, p.search_radius, p.sigma_z, full)
                check(_sweep_equal(candidate_sweep(*args), candidate_sweep_plain(*args)),
                      "candidate_sweep cap %d K=%d full=%s on the edge points equals its plain "
                      "version bit for bit" % (cap, K, full))
        done["cap %d" % cap] = list(ks)
        if timed and cap != 8 and dev.type == "cuda":
            big = [on(a) for a in sweep_edge_points(arrays, 512, 64, seed=100 + cap)[:3]]
            for K in (8, 16):
                args = (dg, *big, K, p.search_radius, p.sigma_z, False)
                check(_sweep_equal(candidate_sweep(*args), candidate_sweep_plain(*args)),
                      "candidate_sweep cap %d 512x64 K=%d equals its plain version" % (cap, K))
                done["cap %d 512x64 K=%d ms" % (cap, K)] = time_ms(
                    lambda: candidate_sweep(*args), cold_l2=True,
                    label="candidate_sweep cap %d 512x64 K=%d" % (cap, K))
    print("sweep edges: candidate_sweep on nodes, block centres, beyond the borders, on cell "
          "lines, near roads, x NaN beside a node's y, valid 0: cap 8 at K = 1-32, caps 2, 24, "
          "56 at K = 1, 2, 8, 16, 32, full and packed: each equal to its plain version bit for "
          "bit%s" % ("".join("; %s %.4f" % kv for kv in done.items() if kv[0].endswith("ms"))))
    return done


def build_edges(matcher, pa, spa):
    """Kernel 3 (the redesigned transition build), dense and sparse (the
    sparse cohort's parameters ``pa``, ``spa``), against its plain version
    bit for bit (logp, route and gc; the packed call's logp and gc equal
    the full call's) on ``build_edge_inputs`` with x legs of NaN beside y
    legs of 0 at a few steps (``nan_steps``) at every K of 1, 2, 4, 8, 16
    and 32, and 3 and 24 (the run-time-K instantiation), with B in 1, 16,
    512 and T in 2, 3, 64, 2,048 where the pairs number at most 2^23: every
    block shape, a block's steps across traces and a partial last block.
    Returns the shapes checked."""
    import types

    import torch

    from reporter_tpu_torch.ops import viterbi as V
    from reporter_tpu_torch.ops.candidates import Candidates

    dev, p = matcher.device, matcher._params
    back_tol = 2.0 * float(p.sigma_z) + 5.0
    done = []
    for K in (1, 2, 4, 8, 16, 32, 3, 24):
        for B in (1, 16, 512):
            for T in (2, 3, 64, 2048):
                if B * (T - 1) * K * K > 1 << 23:
                    continue
                raw = build_edge_inputs(B, T, K, back_tol, seed=K * 10007 + B * 31 + T)
                raw["px"], raw["py"] = nan_steps(raw["px"], raw["py"], seed=K + B + T)
                a = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
                dg = types.SimpleNamespace(edge_rows=a["edge_rows"])
                cand = Candidates(a["edge"], a["offset"], None, None, None)
                for p_, sp in ((p, None), (pa, spa)):
                    args = (dg, cand, a["px"], a["py"], a["times"], a["sp_dist"], a["sp_time"],
                            p_)
                    got = V.transition_build(*args, sp=sp)
                    want = V.transition_build_plain(*args, sp=sp)
                    lean = V.transition_build(*args, with_route=False, sp=sp)
                    what = "transition_build%s %dx%d K=%d" % (
                        "" if sp is None else "[sparse]", B, T, K)
                    check(_bits_equal(got, want) and _bits_equal([lean[0], lean[2]],
                                                                 [got[0], got[2]]),
                          what + " on the edge inputs equals its plain version bit for bit")
                done.append("%dx%d K=%d" % (B, T, K))
    print("build edges: transition_build and [sparse] at K = 1, 2, 4, 8, 16, 32, 3, 24 and "
          "B x T in {1, 16, 512} x {2, 3, 64, 2048} (%d shapes): same-edge forward, jitter and "
          "loop pairs, empty slots, dt <= 0, headings at +-pi and outside it, probe results "
          "finite, 0 and +inf: each equal to its plain version bit for bit" % len(done))
    return done


def design_shapes(matcher, shapes, pa, spa):
    """Kernel 1 and kernel 3 (dense, and sparse with ``pa``, ``spa``) at
    the main path's shapes, each (packed input, K) of ``shapes``: each
    held against its plain version bit for bit and timed in the packed
    path's call, labelled for ``--pair``.  Returns {label: ms}."""
    from reporter_tpu_torch.ops import viterbi as V
    from reporter_tpu_torch.ops.candidates import candidate_sweep, candidate_sweep_plain
    from reporter_tpu_torch.ops.hashtable import ubodt_lookup

    dg, du, p = matcher._dg, matcher._du, matcher._params
    out = {}
    for xin, K in shapes:
        x, y, t, v = V.unpack_inputs(xin)
        B, T = x.shape
        args1 = (dg, x, y, v, K, p.search_radius, p.sigma_z, False)
        sw = candidate_sweep(*args1)
        check(_sweep_equal(sw, candidate_sweep_plain(*args1)),
              "candidate_sweep %dx%d K=%d equals its plain version" % (B, T, K))
        calls = {"candidate_sweep": (lambda: candidate_sweep(*args1), True)}
        dist, time_, _ = ubodt_lookup(du, sw.to_node[:, :-1, :, None],
                                      sw.from_node[:, 1:, None, :], with_first=False)
        for tag, p_, sp in (("", p, None), ("[sparse]", pa, spa)):
            args3 = (dg, sw.cand, x, y, t, dist, time_, p_)
            check(_bits_equal(V.transition_build(*args3, sp=sp),
                              V.transition_build_plain(*args3, sp=sp)),
                  "transition_build%s %dx%d K=%d equals its plain version" % (tag, B, T, K))
            calls["transition_build" + tag] = (
                lambda a=args3, s=sp: V.transition_build(*a, with_route=False, sp=s), False)
        for name, (fn, cold) in calls.items():
            label = "%s %dx%d K=%d" % (name, B, T, K)
            if x.device.type == "cuda":
                out[label] = time_ms(fn, cold_l2=cold, label=label)
    print("design shapes: kernels 1 and 3 equal their plain versions bit for bit; %s"
          % "; ".join("%s %.4f ms" % kv for kv in out.items()))
    return out


# -- phase 13: the redesigned log-depth forward (row 9, every instantiation
# of its template) and dedup claim (row 8b) on edge inputs.  The input
# makers are numpy only: tests/test_torch_assoc_design.py emulates both
# designs on the same inputs against the JAX package.

ASSOC_KINDS = ("plain", "break at 0", "every step broken", "dead source", "padded tail",
               "all padding", "ties", "no breaks")
ASSOC_TS = (2, 3, 17, 64, 256)


def assoc_edge_inputs(B, T, K, seed=0):
    """Numpy inputs of the log-depth forward at B x T x K whose rows take
    its branches, row b of kind ``ASSOC_KINDS[b % 8]``: restarts (random
    infeasible transitions and dead emissions), a hard break at step 0,
    every step broken, a dead-source break (a point with no alive
    emission, and a step whose live sources reach nothing), a padded
    tail, an all-padding row, ties (values on a 0.25 grid) and a row with
    nothing dead.  Returns float32 emis [B, T, K] (-1e30 dead and on
    padding), logp [B, T-1, K, K], gc [B, T-1], valid [B, T] (0/1, a
    prefix), times [B, T] (gaps of -1 to 120 s), init [B, K] (the
    emissions at t = 0 with a third of the slots dead, as a carried beam
    has them), int32 cand_edge [B, T, K] (-1 where dead), float32
    cand_offset and the breakage distance ``brk``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f32, neg, n = np.float32, np.float32(-1e30), T - 1
    emis = rng.uniform(-20.0, 0.0, (B, T, K)).astype(f32)
    emis[rng.uniform(size=(B, T, K)) < 0.2] = neg
    logp = rng.uniform(-30.0, 0.0, (B, n, K, K)).astype(f32)
    logp[rng.uniform(size=(B, n, K, K)) < 0.4] = neg
    gc = rng.uniform(0.0, 100.0, (B, n)).astype(f32)
    valid = np.ones((B, T), f32)
    for b in range(B):
        kind = ASSOC_KINDS[b % len(ASSOC_KINDS)]
        if kind == "break at 0":
            gc[b, 0] = 1e5
        elif kind == "every step broken":
            gc[b] = 1e5
        elif kind == "dead source":
            emis[b, rng.integers(0, T)] = neg
            s = rng.integers(0, n)
            logp[b, s, emis[b, s] > neg / 2] = neg
        elif kind == "padded tail":
            valid[b, rng.integers(1, T):] = 0.0
        elif kind == "all padding":
            valid[b] = 0.0
        elif kind == "ties":
            emis[b] = np.where(emis[b] > neg / 2, -rng.integers(0, 8, (T, K)) / 4.0, neg)
            logp[b] = np.where(logp[b] > neg / 2, -rng.integers(0, 8, (n, K, K)) / 4.0, neg)
        elif kind == "no breaks":
            emis[b] = rng.uniform(-20.0, 0.0, (T, K))
            logp[b] = rng.uniform(-30.0, 0.0, (n, K, K))
    emis[valid == 0] = neg
    gaps = rng.choice([-1.0, 0.0, 0.5, 5.0, 45.0, 60.0, 120.0], (B, n))
    times = np.concatenate([np.zeros((B, 1)), np.cumsum(gaps, 1)], 1).astype(f32)
    init = emis[:, 0].copy()
    init[rng.uniform(size=(B, K)) < 0.33] = neg
    cand_edge = np.where(emis > neg / 2, rng.integers(0, 1000, (B, T, K)), -1).astype(np.int32)
    cand_offset = rng.uniform(0.0, 400.0, (B, T, K)).astype(f32)
    return dict(emis=emis, logp=logp, gc=gc, valid=valid, times=times, init=init,
                cand_edge=cand_edge, cand_offset=cand_offset, brk=150.0)


def claim_edge_keys(n=200_000, seed=0):
    """Numpy int32 (src, dst) key sets of n keys for the dedup claim, by
    name: "runs" (runs of a few keys repeated, as neighbouring steps give
    them, with (-1, -1), (-1, x) and (x, -1) keys mixed in), "all equal",
    "(-1, -1) only" and "all distinct" (n distinct pairs: more than the
    budget n // 2, the fallback); and a uint8 mask of about half the
    positions for count mode."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 5000, (n // 16 + 1, 2))
    runs = np.repeat(base, 16, 0)[:n].copy()
    swap = rng.uniform(size=n) < 0.3
    runs[swap] = base[rng.integers(0, len(base), int(swap.sum()))]
    runs[rng.uniform(size=n) < 0.02] = -1
    runs[rng.uniform(size=n) < 0.01, 0] = -1
    runs[rng.uniform(size=n) < 0.01, 1] = -1
    flat = rng.permutation(n * 4)[:n]
    keys = {"runs": runs, "all equal": np.full((n, 2), 77), "(-1, -1) only": np.full((n, 2), -1),
            "all distinct": np.stack([flat // 7919, flat % 7919], 1)}
    keys = {k: (v[:, 0].astype(np.int32), v[:, 1].astype(np.int32)) for k, v in keys.items()}
    return keys, (rng.uniform(size=n) < 0.5).astype(np.uint8)


def _assoc_same(k, q):
    """Two (packed, aux[, carry]) results: packed and carry bit for bit,
    aux within rtol 1e-4."""
    import torch

    return (torch.equal(k[0], q[0]) and torch.allclose(k[1], q[1], rtol=1e-4, atol=0)
            and (len(k) < 3 or _carry_same(k[2], q[2])))


def assoc_edges(matcher, sm, ubodt, long_traces, B=16):
    """Phase 13, row 9: every instantiation <K, CARRY, SPARSE> of the
    log-depth template at K = 1, 2, 4, 8, 16, 32 and T = 2, 3, 17, 64, 256
    against its plain version (packed output and carry bit for bit, aux
    rtol 1e-4).  Fresh windows (``viterbi_assoc[sparse]``) on
    ``assoc_edge_inputs`` (B rows: every kind twice).  Continued windows
    (``viterbi_chain_assoc[sparse]``): the first B traces of the long
    cohort cut to 2T points, the second T continuing the carries of the
    first (the seam probes the metro table; x legs of NaN beside y legs
    of 0 at every fourth row's seam and at a few points, ``nan_legs``),
    with emis, logp, gc and valid replaced by ``assoc_edge_inputs``' (gc
    NaN at 3 % of the steps, as such a leg gives it); at T = 3 and 17
    also on a 64-slot slab (a quarter of the rows with ``use`` false, two
    padding rows);
    at K = 8 and 16, T = 17, the seam resolved over a gp-4 view of the
    table and on a tiered table (``TIER_PARTIAL``: fetch counts and
    hit/miss totals equal to the plain version's).  The sparse model's
    parameters are cohort L's (``sm``).  Returns the cases checked."""
    import numpy as np
    import torch

    from reporter_tpu_torch.ops import viterbi as V

    dev, dg, du = matcher.device, matcher._dg, matcher._du
    pb, spb, _kb = sm.sparse.params_for("ge60")
    done = []
    tier, _info = tier_table(ubodt, TIER_PARTIAL, dev)
    sharded = _views(du, 4)[1]
    for T in ASSOC_TS:
        two = [dict(tr, trace=tr["trace"][:2 * T]) for tr in long_traces[:B]]
        px, py, tm, valid, _t = matcher._fill_rows(two, list(range(B)), 2 * T)
        xin = torch.from_numpy(V.pack_inputs(px, py, tm, valid)).to(dev)
        x0 = xin[:, :, :T].contiguous()
        x1 = nan_legs(xin[:, :, T:].contiguous(), seam=0, prev=x0, seed=T)
        for K in (1, 2, 4, 8, 16, 32):
            raw = assoc_edge_inputs(B, T, K, seed=T * 64 + K)
            # the gc of a step whose x leg is NaN beside a y leg of 0
            raw["gc"][np.random.default_rng(T + K).uniform(size=raw["gc"].shape) < 0.03] = np.nan
            e = {k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v)
                 for k, v in raw.items()}
            for p, sp in ((matcher._params, None), (pb, spb)):
                tag = "" if sp is None else "[sparse]"
                args = (e["emis"], e["logp"], e["gc"], e["valid"], e["cand_edge"],
                        e["cand_offset"], e["brk"], e["times"], sp)
                check(_assoc_same(V.viterbi_scan(*args, kernel="assoc"),
                                  V.viterbi_scan_plain(*args, kernel="assoc")),
                      "viterbi_assoc%s %dx%d K=%d (edge inputs) equals its plain version"
                      % (tag, B, T, K))
                pre0 = V.precompute_batch_packed(dg, du, x0, p, K, sp)
                carry = V.viterbi_chain(dg, du, pre0.emis, pre0.logp, pre0.gc,
                                        *V.unpack_inputs(x0), pre0.cand.edge, pre0.cand.offset,
                                        p, V.initial_carry_batch(B, K, dev), sp=sp)[2]
                pre = V.precompute_batch_packed(dg, du, x1, p, K, sp)
                x, y, t, _v = V.unpack_inputs(x1)
                win = (e["emis"], e["logp"], e["gc"], x, y, t, e["valid"], pre.cand.edge,
                       pre.cand.offset, p)
                what = "viterbi_chain_assoc%s %dx%d K=%d" % (tag, B, T, K)
                tables = [("", du, None)]
                if K in (8, 16) and T == 17:
                    tables += [(" tiered", tier.device(), tier)]
                for tname, u, tr in tables:
                    got, dk = _tier_delta(tr, lambda: V.viterbi_chain(
                        dg, u, *win, carry, sp=sp, kernel="assoc"))
                    want, dp = _tier_delta(tr, lambda: V.viterbi_chain_plain(
                        dg, u, *win, carry, sp=sp, kernel="assoc"))
                    check(_assoc_same(got, want), "%s%s (edge inputs) equals its plain version"
                          % (what, tname))
                    _same_fetches(dk, dp, what + tname)
                if K in (8, 16) and T == 17:
                    check(_assoc_same(V.viterbi_chain(dg, sharded, *win, carry, sp=sp,
                                                      kernel="assoc"), got),
                          "%s: the seam resolved over gp 4 equals the in-kernel probe" % what)
                if T in (3, 17):
                    S = 64
                    rng = np.random.default_rng(T * K)
                    slots = rng.choice(S, B, replace=False).astype(np.int32)
                    slots[-2:] = S
                    use = rng.uniform(size=B) > 0.25
                    use[-2:] = False
                    slab = V.initial_carry_batch(S, K, dev)
                    rows = torch.from_numpy(slots[:-2].astype(np.int64)).to(dev)
                    for f, c in zip(slab, carry):
                        f[rows] = c[:-2]
                    sk, sq = (V.TraceCarry(*(f.clone() for f in slab)) for _ in range(2))
                    got = V.viterbi_chain(dg, du, *win, sk, slots, use, sp=sp, kernel="assoc")
                    want = V.viterbi_chain_plain(dg, du, *win, sq, slots, use, sp=sp,
                                                 kernel="assoc")
                    check(_assoc_same(got[:2], want[:2]) and _carry_same(sk, sq),
                          "%s on a slab (use false, padding rows) equals its plain version"
                          % what)
                done.append("%s%s T=%d K=%d" % ("assoc", tag, T, K))
    tier.close()
    print("assoc edges: viterbi_assoc and viterbi_chain_assoc, dense and sparse, at K = 1, 2, "
          "4, 8, 16, 32 and T = %s on every kind of row (%s), carried and on a slab, the seam "
          "tiered and resolved over gp 4: each equal to its plain version (packed and carry "
          "bit for bit, aux rtol 1e-4)" % (", ".join(map(str, ASSOC_TS)), ", ".join(ASSOC_KINDS)))
    return done


def claim_edges(matcher, du_w):
    """Phase 13, row 8b: the dedup claim on ``claim_edge_keys`` (both
    layouts): the deduplicated probe equals the plain probe bit for bit;
    its distinct count equals ``torch.unique``'s where it is within the
    budget and exceeds the budget where the set has more keys (the
    fallback); in count mode (the mask) the count equals the plain
    count.  Returns {set: (n_unique, m)}."""
    import torch

    from reporter_tpu_torch.ops import hashtable as H

    dev = matcher.device
    sets, mask = claim_edge_keys()
    maskt = torch.from_numpy(mask).to(dev)
    out = {}
    for name, (s, d) in sets.items():
        s, d = torch.from_numpy(s).to(dev), torch.from_numpy(d).to(dev)
        want_u = int(torch.unique(H._pair_keys(s, d)).numel())
        for du in (matcher._du, du_w):
            r = H.ubodt_lookup_dedup(du, s, d)
            check(_same(r[:3], H.ubodt_lookup_plain(du, s, d)),
                  "dedup probe (%s, %s) equals the plain probe" % (name, du.layout))
            u = int(r.n_unique[0])
            check(u == want_u if want_u <= r.m else u > r.m,
                  "claim (%s): distinct count %d against %d, budget %d" % (name, u, want_u, r.m))
        cnt = int(H.count_distinct_pairs(s, d, maskt))
        check(cnt == int(H.count_distinct_pairs_plain(s, d, maskt)),
              "count mode (%s): %d distinct among the masked keys" % (name, cnt))
        out[name] = (u, r.m)
    print("claim edges: %s: the dedup probe exact in both layouts, distinct counts exact "
          "within the budget and past it at the fallback, count mode exact"
          % "; ".join("%s n_unique %d (m %d)" % (k, *v) for k, v in out.items()))
    return out


STATS_BRK, STATS_DELTA = 2000.0, 1500.0  # probe_stats' edge thresholds
# the row kernel at K = 1, 2, 3, 6 (scalar need bytes at 1 and 3), the quad
# kernel at 4 (8 steps a warp), 8 (2), 12 (36 quads a step), 16 and 32
STATS_KS = (1, 2, 3, 4, 6, 8, 12, 16, 32)
STATS_SHAPES = ((0, 2), (1, 1), (1, 2), (3, 2), (2, 3), (5, 65), (None, 2), (None, 65))


def stats_edge_inputs(B, T, K, seed=0):
    """Numpy inputs of ``probe_outcomes`` (dist [B, T-1, K, K] f32, cand_edge
    [B, T, K] i32, valid, px, py [B, T] f32) for thresholds ``STATS_BRK``
    and ``STATS_DELTA``: dist finite, +inf, -inf and NaN; candidate edges
    of a few ids (same-edge pairs), -1 and -2; points invalid (0) and
    valid (1 and 0.5); steps whose straight-line gap is exactly the
    breakage distance or delta (legs (d, 0) and (0.6 d, 0.8 d)), an eighth
    of a metre either side, inf (a y of inf), NaN (two in a row) and an x
    leg of NaN beside a y leg of 0 (a point whose x is NaN and whose y is
    its predecessor's).  Coordinates are multiples of 1/8 below 2^20, so
    every step's finite legs are exact."""
    import numpy as np

    rng = np.random.default_rng(seed)
    kinds = rng.integers(0, 4, (B, max(T - 1, 0), K, K))
    dist = np.where(kinds == 0, rng.uniform(0, 3000, kinds.shape), np.where(
        kinds == 1, np.inf, np.where(kinds == 2, -np.inf, np.nan))).astype(np.float32)
    edge = rng.integers(-2, 6, (B, T, K)).astype(np.int32)
    valid = rng.choice(np.array([0.0, 1.0, 0.5], np.float32), (B, T), p=[0.1, 0.8, 0.1])
    legs = []
    for d in (STATS_BRK, STATS_DELTA):
        legs += [(d, 0.0), (0.6 * d, 0.8 * d), (d + 0.125, 0.0), (d - 0.125, 0.0)]
    pick = rng.integers(0, len(legs) + 2, (B, max(T - 1, 0)))
    dx = rng.integers(0, 8 * 2500, pick.shape) / 8.0
    dy = rng.integers(0, 8 * 2500, pick.shape) / 8.0
    for i, (lx, ly) in enumerate(legs):
        dx[pick == i], dy[pick == i] = lx, ly
    px = np.concatenate([np.zeros((B, 1)), np.cumsum(dx, 1)], 1).astype(np.float32)
    py = np.concatenate([np.zeros((B, 1)), np.cumsum(dy, 1)], 1).astype(np.float32)
    py[rng.uniform(size=(B, T)) < 0.01] = np.inf
    if B and T >= 3:
        py[0, 1:3] = np.inf
    px, py = nan_steps(px, py, seed=seed + 1)
    return dict(dist=dist, cand_edge=edge, valid=valid, px=px, py=py)


def stats_edges(device, big=512):
    """Phase 15, row 12: ``probe_outcomes`` on ``stats_edge_inputs`` at every
    K of ``STATS_KS`` and each (B, T) of ``STATS_SHAPES`` (None: ``big``
    traces), B = 0 and T = 1 (nothing launched, counts 0) and a step count
    that does not fill the grid among them: the counts and the need mask
    equal the plain version's bit for bit, slot [4] 0.  Returns the
    number of cases."""
    import torch

    from reporter_tpu_torch.ops.diagnostics import probe_outcomes, probe_outcomes_plain

    n = 0
    for K in STATS_KS:
        for B, T in STATS_SHAPES:
            B = big if B is None else B
            t = {k: torch.from_numpy(v).to(device)
                 for k, v in stats_edge_inputs(B, T, K, seed=K * 131 + T).items()}
            args = (t["dist"], t["cand_edge"], t["valid"], t["px"], t["py"], STATS_BRK,
                    STATS_DELTA)
            got, want = probe_outcomes(*args), probe_outcomes_plain(*args)
            check(torch.equal(got[0][:4].cpu(), want[0].cpu()) and int(got[0][4]) == 0
                  and torch.equal(got[1].cpu(), want[1].to(torch.uint8).cpu()),
                  "probe_stats edges K=%d B=%d T=%d: %s == %s" % (K, B, T, got[0].tolist(),
                                                                want[0].tolist()))
            n += 1
    shapes = [(big if B is None else B, T) for B, T in STATS_SHAPES]
    print("probe_stats edges: %d cases (K = %s, B x T = %s) equal to the plain version, counts "
          "and need mask bit for bit" % (n, STATS_KS, shapes))
    return n


# -- phase 16: the redesigned segment histogram (row 11b) on edge inputs.
# The input maker is numpy only: tests/test_torch_histogram_design.py
# emulates the kernel's design on the same inputs against the JAX package.

HIST_KINDS = ("random", "unmatched", "one segment", "re-entry", "every step broken",
              "route specials", "segment outside")
HIST_TS = (1, 2, 31, 32, 33, 64, 255, 256, 257)  # PT = 1, 2, 4, 8 and the block branch
HIST_BS = (0, 1, 7)


def histogram_edge_inputs(B, T, K=4, S=64, kind=None, seed=0):
    """Numpy decoded inputs of ``segment_histogram`` at B x T x K over S
    segments, row b of kind ``HIST_KINDS[b % 7]`` (or ``kind``): random
    runs of segments (a chosen slot of -1 a tenth of the time, a chosen
    candidate edge of -1, read as edge 0, breaks a tenth of the time); no
    point matched; every point on one segment; runs that re-enter two
    or three segments; a break at every step; chosen route entries of
    +inf, -inf, NaN, 0 and -0.0; chosen edges whose segment is -1 or at
    or past S (S, S + 1, 2 S, 2^31 - 1: dropped, as the reference's
    segment_sum drops them).  Route metres are multiples of 1/8 below 512
    and times multiples of 0.5 below 2^17, so every partial sum below
    2^20 is exact in float32 whatever the order.  Returns choice [2, B,
    T] i32 (slot, backpointer), route [B, T-1, K, K] f32, cand_edge [B,
    T, K] i32, breaks [B, T] i32, times [B, T] f32 and edge_seg [E] i32
    with E = 4 S + 8: edge e's segment is e % S below 4 S, -1 for the
    next four edges, then the four outside [0, S)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    E = 4 * S + 8
    edge_seg = (np.arange(E) % S).astype(np.int64)
    edge_seg[4 * S:4 * S + 4] = -1
    edge_seg[4 * S + 4:] = [S, S + 1, 2 * S, 2 ** 31 - 1]
    idx = rng.integers(0, K, (B, T))
    src = rng.integers(0, K, (B, T))
    src[rng.uniform(size=(B, T)) < 0.1] = -1
    brk = (rng.uniform(size=(B, T)) < 0.1).astype(np.int32)
    seg = np.zeros((B, T), np.int64)
    for b in range(B):
        k = kind or HIST_KINDS[b % len(HIST_KINDS)]
        runs = np.repeat(rng.integers(0, S, T), rng.integers(1, 9, T))[:T]
        if k == "one segment":
            runs[:] = rng.integers(0, S)
        elif k == "re-entry":
            pool = rng.choice(S, min(3, S), replace=False)
            runs = np.repeat(pool[rng.integers(0, len(pool), T)], rng.integers(1, 4, T))[:T]
        seg[b] = runs
        if k == "unmatched":
            idx[b] = -1
        elif k == "random":
            idx[b][rng.uniform(size=T) < 0.1] = -1
        elif k == "every step broken":
            brk[b] = 1
    # an edge of each point's segment at its chosen slot, the other slots random
    cand_edge = rng.integers(-1, E, (B, T, K))
    edge = seg + S * rng.integers(0, 4, (B, T))
    rows = np.array([kind or HIST_KINDS[b % len(HIST_KINDS)] for b in range(B)])
    outside = (rows == "segment outside")[:, None] & (rng.uniform(size=(B, T)) < 0.5)
    edge[outside] = 4 * S + rng.integers(0, 8, int(outside.sum()))
    clamp = (rows == "random")[:, None] & (rng.uniform(size=(B, T)) < 0.05)
    edge[clamp] = -1  # read as edge 0
    bb, tt = np.nonzero(idx >= 0)
    cand_edge[bb, tt, idx[bb, tt]] = edge[bb, tt]
    route = (rng.integers(0, 4096, (B, max(T - 1, 0), K, K)) / 8.0).astype(np.float32)
    spec = (rows == "route specials")[:, None] & (idx >= 0) & (src >= 0)
    spec[:, 0] = False
    bb, tt = np.nonzero(spec)
    route[bb, tt - 1, src[bb, tt], idx[bb, tt]] = rng.choice(
        np.array([np.inf, -np.inf, np.nan, 0.0, -0.0], np.float32), len(bb))
    gaps = rng.choice([0.0, 0.5, 1.0, 5.0, 30.0], (B, T))
    gaps[:, 0] = rng.integers(0, 100_000, B)
    times = np.cumsum(gaps, 1).astype(np.float32)
    choice = np.stack([idx, src]).astype(np.int32)
    return dict(choice=choice, route=route, cand_edge=cand_edge.astype(np.int32), breaks=brk,
                times=times, edge_seg=edge_seg.astype(np.int32))


def histogram_edges(device):
    """Phase 16, row 11b: ``segment_histogram`` against its plain version
    (counts bit for bit, the time and distance sums within rtol 1e-5) on
    ``histogram_edge_inputs``: at every T of ``HIST_TS`` and B of
    ``HIST_BS`` (B = 0: nothing launched, zeros) with every kind of row,
    at K = 1, 4 and 8; each kind alone over 64 rows at T = 64 and 256;
    T = 2,048 (the block-a-row branch); 7 rows (a grid that the rows do
    not fill) and 20,000 rows (more than the persistent grid's warps) at
    T = 64; and S = 4 at 512 x 64 and 128 x 256, where every row's runs
    hit four bins (the atomics' contention).  Returns the number of
    cases."""
    import torch

    from reporter_tpu_torch.ops import histogram as Hg

    cases = [(B, T, K, 64, None) for T in HIST_TS for B in HIST_BS for K in (1, 4, 8)]
    cases += [(64, T, 4, 64, k) for T in (64, 256) for k in HIST_KINDS]
    cases += [(7, 2048, 4, 64, None), (64, 2048, 8, 64, None), (7, 64, 8, 64, None),
              (20_000, 64, 2, 64, None), (512, 64, 8, 4, None), (128, 256, 8, 4, None)]
    for n, (B, T, K, S, kind) in enumerate(cases):
        a = {k: torch.from_numpy(v).to(device) for k, v in histogram_edge_inputs(
            B, T, K, S, kind, seed=n).items()}
        hargs = (a["choice"], a["route"], a["cand_edge"], a["breaks"], a["times"],
                 a["edge_seg"], S)
        got, want = Hg.segment_histogram(*hargs), Hg.segment_histogram_plain(*hargs)
        what = "segment_histogram %dx%d K=%d S=%d %s" % (B, T, K, S, kind or "mixed")
        check(torch.equal(got.point_count, want.point_count)
              and torch.equal(got.trace_count, want.trace_count), what + ": counts exact")
        for f in ("time_in_segment", "distance_in_segment"):
            check(torch.allclose(getattr(got, f), getattr(want, f), rtol=1e-5, atol=0),
                  "%s: %s within rtol 1e-5" % (what, f))
    print("histogram edges: %d cases (T = %s and 2048, B = %s, 7, 64 and 20,000, K = 1, 2, 4, "
          "8, S = 64 and 4, rows %s): segment_histogram equal to its plain version, counts "
          "bit for bit, sums within rtol 1e-5" % (len(cases), HIST_TS, HIST_BS,
                                                  ", ".join(HIST_KINDS)))
    return len(cases)


SCATTER_NS = (1, 3, 5, 1023, 1025, 4097, 2_064_383)  # n % 4 = 1, 3, 1, 3, 1, 1, 3


def scatter_edge_keys(rows, n, seed=0):
    """Numpy int32 (src, dst) of n keys for the dedup scatter: runs of
    table keys (hits), keys that miss and the empty marker (-1, 0), with
    about n / 8 distinct; and n distinct table keys (for the fallback)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pool = max(1, n // 8)
    src = rows[0][rng.integers(0, len(rows[0]), pool)].copy()
    dst = rows[1][rng.integers(0, len(rows[1]), pool)].copy()
    hit = rng.uniform(size=pool) < 0.7
    pick = rng.integers(0, len(rows[0]), int(hit.sum()))
    src[hit], dst[hit] = rows[0][pick], rows[1][pick]
    empty = rng.uniform(size=pool) < 0.05
    src[empty], dst[empty] = -1, 0
    at = rng.integers(0, pool, n)
    distinct = rng.permutation(len(rows[0]))[:n]
    return ((src[at].astype(np.int32), dst[at].astype(np.int32)),
            (rows[0][distinct].astype(np.int32), rows[1][distinct].astype(np.int32)))


def scatter_launch(du, sa, sb, m, with_first=False):
    """The claim and the compact probe of keys (sa, sb) at budget ``m`` on
    table ``du``: (a call of the scatter launch alone, its outputs).  On
    the CPU (a rehearsal) the call is the plain deduplicated probe."""
    import torch

    from reporter_tpu_torch.ops import hashtable as H

    if sa.device.type != "cuda":
        cpu = lambda: tuple(H.ubodt_lookup_dedup_plain(du, sa, sb, with_first)[:3])  # noqa: E731
        return cpu, cpu()
    cnt = torch.empty(1, dtype=torch.int32, device=sa.device)
    claim = H._claim(sa, sb, None, m, cnt)
    compact = H._probe(du, claim[2], claim[3], with_first, n_live=cnt)
    fn = lambda: H._scatter(du, sa, sb, claim, cnt, m, compact)  # noqa: E731
    return fn, fn()


def scatter_edges(matcher, du_w, ns=SCATTER_NS):
    """Phase 15, row 8b's scatter: the scatter launch at every n of
    ``SCATTER_NS`` (n % 4 != 0: the scalar tail) on ``scatter_edge_keys``
    within the budget (m = n) and, from n = 3, on n distinct keys past it
    (m = 1: the fused full-width probe), in both layouts, with and without
    first_edge: each equal to the plain full-width probe bit for bit.
    Returns the number of cases."""
    import torch

    from reporter_tpu_torch.ops import hashtable as H

    dev, rows, k = matcher.device, matcher.ubodt.rows(), 0
    for n in ns:
        runs, distinct = scatter_edge_keys(rows, n, seed=n)
        for (s, d), m in ((runs, n), (distinct, 1)):
            if n < 3 and m == 1:
                continue
            s, d = torch.from_numpy(s).to(dev), torch.from_numpy(d).to(dev)
            for du in (matcher._du, du_w):
                for wf in (True, False):
                    _fn, got = scatter_launch(du, s, d, m, wf)
                    check(_bits_equal([x for x in got if x is not None],
                                      [x for x in H.ubodt_lookup_plain(du, s, d, wf)
                                       if x is not None]),
                          "scatter n=%d m=%d (%s, first %s) equals the plain probe"
                          % (n, m, du.layout, wf))
                    k += 1
    print("scatter edges: %d cases (n = %s, within the budget and past it, both layouts, with "
          "and without first_edge) equal to the plain probe bit for bit" % (k, ns))
    return k


def sweep_keys(matcher, xin, p=None, K=None):
    """The sweep of a packed [4, B, T] batch at K and its probe's key grid:
    (sweep, src, dst broadcast to [B, T-1, K, K], (px, py, valid))."""
    import torch

    from reporter_tpu_torch.ops import viterbi as V
    from reporter_tpu_torch.ops.candidates import candidate_sweep

    K, p = K or matcher.cfg.beam_k, p or matcher._params
    x, y, _t, v = V.unpack_inputs(xin)
    sw = candidate_sweep(matcher._dg, x, y, v, K, p.search_radius, p.sigma_z, False)
    sa, sb = torch.broadcast_tensors(sw.to_node[:, :-1, :, None], sw.from_node[:, 1:, None, :])
    return sw, sa, sb, (x, y, v)


def redesign_shapes(matcher, sm, du_w, cut, xin64, xin256, xin_a, pa, ka, timed):
    """Phase 15, rows 8b's scatter and 12 at the main path's shapes: the
    scatter launch alone (after the claim and the compact probe) and
    ``probe_outcomes`` alone, each against its plain version bit for bit
    and, ``timed``, timed with a label (so ``--pair`` times every tree):
    the scatter at 512 x 64 on the cuckoo table (wide32 in
    ``memory_phases``), 128 x 256 in both layouts and cohort A (512 x 16,
    K = 16) on the 400 m table; ``probe_stats`` at 512 x 64 on the wide32
    probe's dist (the cuckoo one in ``stats_phases``), 128 x 256 and A on
    the 400 m table (beyond-delta misses).  Returns {label: ms}."""
    import torch

    from reporter_tpu_torch.ops import hashtable as H
    from reporter_tpu_torch.ops.diagnostics import probe_outcomes, probe_outcomes_plain

    out = {}
    cases = [(matcher, xin64, None, None, [matcher._du], du_w),
             (matcher, xin256, None, None, [matcher._du, du_w], matcher._du),
             (sm, xin_a, pa, ka, [cut], cut)]
    for mm, xin, p, K, tables, sdu in cases:
        sw, sa, sb, (x, y, v) = sweep_keys(mm, xin, p, K)
        B, T = x.shape
        shape = "%dx%d K=%d" % (B, T, sw.cand.edge.shape[-1])
        for du in tables:
            tag = "%s %s%s" % (du.layout, shape, " delta 400" if du is cut else "")
            fn, got = scatter_launch(du, sa, sb, H._budget(sa.numel()))
            check(_bits_equal(got[:2], H.ubodt_lookup_plain(du, sa, sb, False)[:2]),
                  "scatter (%s) equals the plain probe" % tag)
            if timed:
                out["ubodt_dedup_scatter " + tag] = time_ms(
                    fn, label="ubodt_dedup_scatter " + tag)
        dist = H.ubodt_lookup(sdu, sa, sb, False)[0]
        delta = 400.0 if sdu is cut else float(matcher.cfg.ubodt_delta)
        pp = p or mm._params
        args = (dist, sw.cand.edge, v, x, y, pp.breakage_distance, delta)
        got, want = probe_outcomes(*args), probe_outcomes_plain(*args)
        tag = "%s %s%s" % (sdu.layout, shape, " delta 400" if sdu is cut else "")
        check(torch.equal(got[0][:4].cpu(), want[0].cpu())
              and torch.equal(got[1].cpu(), want[1].to(torch.uint8).cpu()),
              "probe_stats (%s) counts %s and need mask" % (tag, want[0].tolist()))
        if sdu is cut:
            check(int(want[0][3]) > 0, "beyond-delta misses on the 400 m table")
        if timed:
            out["probe_stats " + tag] = time_ms(lambda: probe_outcomes(*args),
                                                label="probe_stats " + tag)
    print("redesign shapes: the scatter and probe_stats equal their plain versions at "
          "512x64, 128x256 and A on the 400 m table; %s"
          % ", ".join("%s %.4f ms" % kv for kv in out.items()))
    return out


# -- the bench's realistic OSM city (phase 17) ---------------------------------

# the bench's default city at 120 x 120, seed 3, 150 m blocks, cell_size
# 100 and a cuckoo table at delta 3000, as the JAX package's builders
# make it (the port's must give the same)
OSM_FIGURES = {"nodes": 14390, "edges": 49926, "cell_rows_cap": 20,
               "ubodt_rows": 10711548, "ubodt_mb": 536.9}


def osm_city(rows, device, seed=3):
    """The bench's default city (``BENCH_SCENARIO=osm``) from the port's
    modules, as bench.py builds it: ``realistic_city_network`` through the
    PBF round trip, ``build_graph_arrays(cell_size=100)``, the native cuckoo
    UBODT at delta 3,000 m, and a matcher with the confidence aux on.  At
    120 x 120 its figures must equal ``OSM_FIGURES``."""
    from reporter_tpu_torch import native
    from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
    from reporter_tpu_torch.synth.osm_city import realistic_city_network
    from reporter_tpu_torch.tiles.arrays import build_graph_arrays
    from reporter_tpu_torch.tiles.ubodt import build_ubodt

    t0 = time.perf_counter()
    net = realistic_city_network(rows, rows, spacing_m=150.0, seed=seed)
    t1 = time.perf_counter()
    arrays = build_graph_arrays(net, cell_size=100.0)
    t2 = time.perf_counter()
    lib = native.require_lib() if device.type == "cuda" else None
    ubodt = build_ubodt(arrays, delta=3000.0, lib=lib)
    t3 = time.perf_counter()
    matcher = SegmentMatcher(arrays=arrays, ubodt=ubodt,
                             config=MatcherConfig(quality_aux=True), device=device)
    t4 = time.perf_counter()
    info = {
        "city": "realistic %dx%d, 150 m, seed %d (PBF round trip)" % (rows, rows, seed),
        "nodes": arrays.num_nodes, "edges": arrays.num_edges,
        "cell_rows_cap": int(arrays.grid_items.shape[1]),
        "ubodt_rows": int(ubodt.num_rows), "ubodt_buckets": int(ubodt.n_buckets),
        "ubodt_mb": round(ubodt.packed.nbytes / 1e6, 1),
        "network_s": t1 - t0, "graph_s": t2 - t1, "ubodt_s": t3 - t2, "to_device_s": t4 - t3,
    }
    print("osm city: %(city)s, %(nodes)d nodes, %(edges)d edges, grid_items cap "
          "%(cell_rows_cap)d, UBODT %(ubodt_rows)d rows in %(ubodt_buckets)d buckets = "
          "%(ubodt_mb).1f MB (network %(network_s).1f s, graph %(graph_s).1f s, ubodt "
          "%(ubodt_s).1f s, to card %(to_device_s).1f s)" % info)
    if rows == 120 and seed == 3:
        got = {k: info[k] for k in OSM_FIGURES}
        check(got == OSM_FIGURES, "the realistic city's figures %s equal %s"
              % (got, OSM_FIGURES))
    return matcher, net, info


def osm_cohorts(arrays, scale=1):
    """The bench's three cohorts as bench.py synthesizes them: one
    synthesizer (seed 7), then 512 x 64, 128 x 256 and 16 x 1,024 (400
    tries), every 5 s with 5 m noise (``scale`` divides the counts for a
    rehearsal); SyntheticTrace lists."""
    from reporter_tpu_torch.synth import TraceSynthesizer

    t0 = time.perf_counter()
    if scale == 1:
        out, secs, where = _take(arrays, ("osm", 7, 0, 0, 5.0))
    else:
        synth = TraceSynthesizer(arrays, seed=7)
        out = [synth.batch(512 // scale, 64, dt=5.0, sigma=5.0),
               synth.batch(128 // scale, 256, dt=5.0, sigma=5.0),
               synth.batch(16 // scale, 1024, dt=5.0, sigma=5.0, max_tries=400)]
        secs, where = time.perf_counter() - t0, "here"
    print("osm cohorts %s synthesized in %.1f s (%s)" % (
        ", ".join("%dx%d" % (len(c), len(c[0].trace["trace"])) for c in out), secs, where))
    return out


def probe_misses(matcher, xin):
    """Kernel 12's probe outcomes over one packed batch at the matcher's
    parameters, held against its plain version: pairs probed, hits,
    misses, costly misses, beyond-delta misses, distinct pairs."""
    import torch

    from reporter_tpu_torch.ops.diagnostics import ubodt_probe_stats, ubodt_probe_stats_plain

    args = (matcher._dg, matcher._du, xin, matcher._params, matcher.cfg.beam_k,
            float(matcher.cfg.ubodt_delta))
    got = ubodt_probe_stats(*args)
    check(torch.equal(got, ubodt_probe_stats_plain(*args)),
          "probe_stats equals its plain version")
    pairs, miss, costly, beyond, distinct = (int(v) for v in got.cpu())
    return {"pairs": pairs, "hit": pairs - miss, "miss": miss, "costly_miss": costly,
            "beyond_delta": beyond, "distinct": distinct}


def agreement(matcher, straces):
    """Mean segment agreement of ``match_many``'s per-point edges (the
    diagnostics block) against the synthesizer's truth."""
    import numpy as np

    from reporter_tpu_torch.synth.generator import segment_agreement

    res = matcher.match_many([s.trace for s in straces])
    return float(np.mean([segment_agreement(matcher.arrays, np.asarray(r["_quality"]["edge"]),
                                            s) for r, s in zip(res, straces)]))


def baseline_phase(matcher, traces):
    """The first traces of a cohort matched three ways: the card's path,
    the CPU baseline (``backend="cpu"``, same arrays and table) and the
    port on ``device="cpu"`` (the plain versions).  The card's records
    must part from the baseline's on exactly the traces where the port on
    the CPU parts from it."""
    from reporter_tpu_torch.matching import SegmentMatcher

    def run(m):
        t0 = time.perf_counter()
        out = m.match_many(traces)
        return [r["segments"] for r in out], time.perf_counter() - t0

    base_m = SegmentMatcher(arrays=matcher.arrays, ubodt=matcher.ubodt, config=matcher.cfg,
                            backend="cpu")
    host_m = SegmentMatcher(arrays=matcher.arrays, ubodt=matcher.ubodt, config=matcher.cfg,
                            device="cpu")
    card, card_s = run(matcher)
    base, base_s = run(base_m)
    host, host_s = run(host_m)
    ids = lambda segs: [s.get("segment_id") for s in segs]  # noqa: E731
    n = len(traces)
    parted_card = [i for i in range(n) if card[i] != base[i]]
    parted_host = [i for i in range(n) if host[i] != base[i]]
    out = {"traces": n, "identical_records": n - len(parted_card),
           "identical_segment_ids": sum(ids(c) == ids(b) for c, b in zip(card, base)),
           "card_equals_port_on_cpu": sum(c == h for c, h in zip(card, host)),
           "parted": [traces[i]["uuid"] for i in parted_card],
           "cpu_baseline_s": base_s, "cpu_baseline_traces_per_s": n / base_s,
           "card_s": card_s, "port_on_cpu_s": host_s}
    print("osm baseline: card vs CPU baseline %d/%d identical records, %d/%d identical "
          "segment-id sequences; the card equals the port on the CPU on %d/%d; parted on "
          "%s (card), %s (port on the CPU); CPU baseline %.1f s (%.2f traces/s), card "
          "%.2f s, port on the CPU %.1f s"
          % (out["identical_records"], n, out["identical_segment_ids"], n,
             out["card_equals_port_on_cpu"], n, out["parted"],
             [traces[i]["uuid"] for i in parted_host], base_s, n / base_s, card_s, host_s))
    check(parted_card == parted_host, "the card parts from the CPU baseline on exactly the "
          "traces where the port on the CPU does")
    return out


def osm_serve_phase(net, rows, traces, device):
    """The city's PBF written and imported by the OSM CLI in a process of
    its own (``--json``, and the RPTT tiles with ``-o`` in the same call,
    which phase 18 reads), then 8 /report requests served from a
    ``{"network": {"type": "file"}}`` config through
    ``parse_service_config`` and ``build_matcher`` with the serving
    defaults, through the launch counters: each answer's segments equal
    the records ``match_many`` gives on a second matcher built from the
    same config on the same card."""
    from reporter_tpu_torch.serve.__main__ import serving_defaults
    from reporter_tpu_torch.serve.service import build_matcher, parse_service_config
    from reporter_tpu_torch.synth.osm_city import realistic_city
    from reporter_tpu_torch.tiles.osm import write_pbf

    d = os.path.join(REPO, "build", "osm_city")
    os.makedirs(d, exist_ok=True)
    pbf, net_json, cfg_json = (os.path.join(d, n) for n in
                               ("city.osm.pbf", "net.json", "config.json"))
    t0 = time.perf_counter()
    write_pbf(pbf, *realistic_city(rows, rows, 150.0, 3))
    tiles = os.path.join(d, "tiles")
    r = subprocess.run([sys.executable, "-m", "reporter_tpu_torch.tiles.osm", pbf,
                        "--json", net_json, "-o", tiles], cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    check(r.returncode == 0, "the OSM CLI: %s" % r.stderr[-2000:])
    with open(net_json) as f:
        check(json.load(f) == json.loads(json.dumps(net.to_dict())),
              "the CLI's network equals the city built in this process")
    t1 = time.perf_counter()
    with open(cfg_json, "w") as f:
        json.dump({"network": {"type": "file", "path": net_json}}, f)

    def served():
        cfg, conf = parse_service_config(cfg_json)
        return build_matcher(serving_defaults(cfg), conf, device=device)
    sv = served()
    t2 = time.perf_counter()
    requests = traces[:8]
    kernels, absent = _path_kernels(sv, BUCKETED)
    (answers,), dt, launches = _counted(kernels, lambda: _serve(sv, 15, requests), absent)
    want = served().match_many(requests)
    for (code, body), w in zip(answers, want):
        check(code == 200, "osm /report status %s" % code)
        check(body["segment_matcher"]["segments"] == json.loads(json.dumps(w["segments"])),
              "osm /report segments equal match_many on a matcher of the same config")
    print("serve osm: the CLI wrote %s and %s from the city's PBF in %.1f s; the served "
          "matcher built from the JSON in %.1f s; 8 /report answered 200 in %.2f s, equal to "
          "match_many on a matcher of the same config, launches %s"
          % (os.path.relpath(net_json, REPO), os.path.relpath(tiles, REPO), t1 - t0, t2 - t1,
             dt, json.dumps(launches)))
    return launches, net_json, tiles


def tile_order(net_d):
    """A RoadNetwork JSON as the RPTT tiles hold it: its edges by level,
    then by the tile of their from-node at that level, then in network
    order, and speeds at the format's float32."""
    import numpy as np

    from reporter_tpu_torch.tiles.hierarchy import TileHierarchy

    h = TileHierarchy()
    lat, lon, edges = net_d["nodes"]["lat"], net_d["nodes"]["lon"], net_d["edges"]
    order = sorted(range(len(edges)), key=lambda i: (
        edges[i]["level"], h.tile_id(edges[i]["level"], lat[edges[i]["from"]],
                                     lon[edges[i]["from"]]), i))
    return {"nodes": net_d["nodes"],
            "edges": [dict(edges[i], speed_kph=float(np.float32(edges[i]["speed_kph"])))
                      for i in order]}


ROUNDS_18 = 3  # sends of each encoding in phase 18


def wire_phase(net_json, tiles, traces64, traces256, traces1024, device, card=""):
    """Phase 18: /trace_attributes_batch on the city loaded from the OSM
    CLI's RPTT tiles, in four encodings and a binary /report, through the
    launch counters; the deadline's 504 with no launch."""
    import gzip

    from reporter_tpu_torch.ops import _kernels
    from reporter_tpu_torch.report import report as report_fn
    from reporter_tpu_torch.serve import ReporterService, wire
    from reporter_tpu_torch.serve.__main__ import serving_defaults
    from reporter_tpu_torch.serve.service import build_matcher, parse_service_config
    from reporter_tpu_torch.tiles.codec import load_network_tiles

    t0 = time.perf_counter()
    with open(net_json) as f:
        want_net = tile_order(json.load(f))
    got_net = json.loads(json.dumps(load_network_tiles(tiles).to_dict()))
    check(got_net == want_net, "the RPTT tiles read back to the --json network (%d edges)"
          % len(want_net["edges"]))
    t_load = time.perf_counter() - t0
    cfg_json = os.path.join(os.path.dirname(net_json), "config_tiles.json")
    with open(cfg_json, "w") as f:
        json.dump({"network": {"type": "tiles", "path": tiles}}, f)

    def served():
        cfg, conf = parse_service_config(cfg_json)
        return build_matcher(serving_defaults(cfg), conf, device=device)
    sv = served()
    traces = traces64[:64] + traces256[:8] + traces1024[:1]
    body = {"traces": traces}
    js = json.dumps(body).encode()
    frame = wire.encode_request(json.loads(js))
    json_h = {"Content-Type": "application/json"}
    bin_h = {"Content-Type": wire.CONTENT_TYPE, "Accept": wire.CONTENT_TYPE}
    sends = {
        "json": ("/trace_attributes_batch", js, json_h),
        "gzip": ("/trace_attributes_batch", gzip.compress(js),
                 dict(json_h, **{"Content-Encoding": "gzip"})),
        "binary": ("/trace_attributes_batch", frame, bin_h),
        "binary in, json out": ("/trace_attributes_batch", frame,
                                {"Content-Type": wire.CONTENT_TYPE}),
        "binary /report": ("/report", wire.encode_request(json.loads(json.dumps(traces[0]))),
                           bin_h),
    }
    # the batch runs both buckets and the long trace's carried windows; the
    # one /report, a 64-point trace, only the bucketed kernels
    paths = {how: _path_kernels(sv, BUCKETED if how == "binary /report"
                                else BUCKETED + CARRIED[-1:]) for how in sends}
    service = ReporterService(sv, threshold_sec=15, max_batch=128, max_wait_ms=10)
    if device.type == "cuda":
        check(service.batcher.max_inflight == 4, "the default max_inflight on the card is 4")
    server = service.make_server("127.0.0.1", 0)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    out, launches, walls = {}, {}, {how: [] for how in sends}
    try:
        # three rounds of every encoding in turn, each send through the
        # launch counters; an encoding's wall is its median
        for rnd in range(ROUNDS_18):
            for how, (path, data, headers) in sends.items():
                (code, hdrs, raw), dt, counts = _counted(
                    (), lambda: _post_raw(port, path, data, headers))
                check(code == 200, "phase 18 %s: status %s %s" % (how, code, raw[:300]))
                if device.type == "cuda":
                    kernels, absent = paths[how]
                    check(all(counts[k] > 0 for k in kernels)
                          and not any(counts[k] for k in absent),
                          "phase 18 %s: kernels %s launched, none of %s: %s"
                          % (how, kernels, absent, json.dumps(counts)))
                binary = how in ("binary", "binary /report")
                check(wire.is_wire(hdrs.get("Content-Type")) == binary,
                      "phase 18 %s: Content-Type %s" % (how, hdrs.get("Content-Type")))
                payload = wire.decode_response(raw) if binary else json.loads(raw)
                if rnd:
                    check(payload == out[how]["payload"], "phase 18 %s: every round answers "
                          "alike" % how)
                    launches[how] = {k: launches[how][k] + v for k, v in counts.items()}
                else:
                    out[how] = {"request_bytes": len(data), "response_bytes": len(raw),
                                "payload": payload}
                    launches[how] = counts
                walls[how].append(dt)
        for how, o in out.items():
            o["wall_s"] = statistics.median(walls[how])
            o["walls_s"] = walls[how]
        (code, _h, raw), _dt, late = _counted(
            (), lambda: _post_raw(port, "/trace_attributes_batch", js,
                                  dict(json_h, **{"X-Reporter-Deadline-Ms": "0"})),
            tuple(_kernels.KERNELS))
        check(code == 504 and not any(late.values()),
              "a deadline of 0 ms answers 504 with no launch: %s %s" % (code, raw[:200]))
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        th.join(10)
    second = served()
    want = []
    for m, tr in zip(second.match_many(traces), traces):
        m.pop("_quality", None)
        mo = tr["match_options"]
        want.append(report_fn(m, tr, 15, set(mo["report_levels"]), set(mo["transition_levels"]),
                              mode=mo.get("mode", "auto")))
    want = json.dumps(want, sort_keys=True)
    for how in ("json", "gzip", "binary", "binary in, json out"):
        check(json.dumps(out[how]["payload"]["results"], sort_keys=True) == want,
              "phase 18 %s: the results equal report() over match_many on a second matcher "
              "of the same config" % how)
    check(json.dumps([out["binary /report"]["payload"]], sort_keys=True)
          == json.dumps(json.loads(want)[:1], sort_keys=True),
          "phase 18: the binary /report equals its report()")
    n_reports = sum(len(r["datastore"]["reports"]) for r in out["json"]["payload"]["results"])
    print("phase 18 wire (%s): /trace_attributes_batch of %d traces (%d points), %d datastore "
          "reports; %s; the tiles read back in %.1f s; deadline 0 ms: 504, no launch; launches "
          "of the %d JSON sends %s" % (
              card, len(traces), sum(len(t["trace"]) for t in traces), n_reports, "; ".join(
                  "%s: request %d B, response %d B, wall %.3f s (median of %s)" % (
                      how, o["request_bytes"], o["response_bytes"], o["wall_s"],
                      ", ".join("%.3f" % w for w in o["walls_s"]))
                  for how, o in out.items()), t_load, ROUNDS_18, json.dumps(launches["json"])))
    total = {k: sum(run[k] for run in launches.values()) for k in launches["json"]}
    return {"encodings": {how: {k: v for k, v in o.items() if k != "payload"}
                          for how, o in out.items()},
            "tiles_load_s": t_load, "launches": launches}, total, (cfg_json, sv, second)


# -- phase 19: service recovery on the card ------------------------------------

_RECOVERY_BASE = []  # the recovery counts phase 19 left behind (empty before it)


def recovery_counts():
    """The faults fired per point and the service's fault-domain events
    (watchdog trips, degraded entries and answers) in this process."""
    from reporter_tpu_torch import faults
    from reporter_tpu_torch.serve import service

    c = service.counts()
    return {"injected": {p: faults.injected(p) for p in faults.POINTS},
            **{k: c[k] for k in ("watchdog_trips", "degraded_entries", "degraded_requests")}}


def quiet(label):
    """Every phase but 19 runs with no fault armed: no injected fault, no
    watchdog trip, no degraded answer (the counts phase 19 left, or none)."""
    from reporter_tpu_torch import faults

    now = recovery_counts()
    want = (_RECOVERY_BASE[-1] if _RECOVERY_BASE else
            {"injected": {p: 0 for p in faults.POINTS}, "watchdog_trips": 0,
             "degraded_entries": 0, "degraded_requests": 0})
    armed = [v for v in os.environ if v.startswith("REPORTER_FAULT_")]
    check(now == want and not armed, "%s ran with no fault injected, no watchdog trip and "
          "nothing degraded: %s (armed %s)" % (label, json.dumps(now), armed))


class _Served:
    """A ReporterService on its own HTTP server (port 0), closed with it."""

    def __init__(self, matcher, **kw):
        from reporter_tpu_torch.serve import ReporterService

        self.svc = ReporterService(matcher, threshold_sec=15, **kw)
        self.server = self.svc.make_server("127.0.0.1", 0)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def post(self, path, body, headers=None):
        """(status, headers, parsed body): JSON in and out unless ``body`` is
        bytes (sent as they are under ``headers``)."""
        raw = body if isinstance(body, bytes) else json.dumps(body).encode()
        code, hdrs, out = _post_raw(self.port, path, raw,
                                    headers or {"Content-Type": "application/json"})
        from reporter_tpu_torch.serve import wire

        return code, hdrs, (out if wire.is_wire(hdrs.get("Content-Type")) else json.loads(out))

    def get(self, path):
        import urllib.error

        try:
            with urllib.request.urlopen("http://127.0.0.1:%d%s" % (self.port, path),
                                        timeout=300) as r:
                raw = r.read()
                return r.status, json.loads(raw), len(raw)
        except urllib.error.HTTPError as e:
            raw = e.read()
            return e.code, json.loads(raw), len(raw)

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.svc.close()
        self.thread.join(10)


def _reports(matcher, traces):
    """report() over ``match_many`` on ``matcher``, as the service renders
    each trace (JSON round-tripped)."""
    from reporter_tpu_torch.report import report as report_fn

    out = []
    for m, tr in zip(matcher.match_many(traces), traces):
        m.pop("_quality", None)
        mo = tr["match_options"]
        out.append(report_fn(m, tr, 15, set(mo["report_levels"]), set(mo["transition_levels"]),
                             mode=mo.get("mode", "auto")))
    return json.loads(json.dumps(out))


def _parallel(fn, items):
    """fn(item) for every item on a thread of its own; the answers in order."""
    out = [None] * len(items)
    workers = [threading.Thread(target=lambda i=i: out.__setitem__(i, fn(items[i])))
               for i in range(len(items))]
    for w in workers:
        w.start()
    for w in workers:
        w.join(300)
    check(not any(w.is_alive() for w in workers), "every request answered")
    return out


def _arm(**points):
    """Set (a value) or clear (None) REPORTER_FAULT_<POINT> variables in this
    process, then re-arm every count."""
    from reporter_tpu_torch import faults

    for point, spec in points.items():
        var = "REPORTER_FAULT_" + point.upper()
        if spec is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = spec
    faults.reset()


def _no_age(body):
    body = json.loads(json.dumps(body))
    if isinstance(body.get("session"), dict):
        body["session"].pop("age_s", None)
    if isinstance(body.get("_stream"), dict):
        body["_stream"]["session"].pop("age_s", None)
    return body


def _stream_sub(tr, uuid, j, n=4):
    return dict(tr, uuid=uuid, stream=True, trace=tr["trace"][j:j + n])


def _wait_reattach(svc, timeout=20.0):
    t0 = time.perf_counter()
    while svc.degraded and time.perf_counter() - t0 < timeout:
        time.sleep(0.01)
    check(not svc.degraded, "re-attached within %.0f s" % timeout)
    return time.perf_counter() - t0


def _sleep_cycles(seconds):
    """``torch.cuda._sleep`` cycles that spin the card about ``seconds``,
    from a timed spin of 10^7 cycles."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    return int(10_000_000 * seconds * 1e3 / a.elapsed_time(b))


def recovery_faults_off(sv, second, t64, t256, t1024):
    """19.1: with no fault armed, 8 concurrent /report and one
    /trace_attributes_batch equal report() over match_many on the second
    matcher, through the launch counters; nothing fires, nothing trips."""
    a = _Served(sv, max_batch=128, max_wait_ms=10)
    body = {"traces": t64[8:24] + t256[:4] + t1024[:1]}
    kernels, absent = _path_kernels(sv, BUCKETED + CARRIED[-1:])
    try:
        t0 = time.perf_counter()
        (answers, batch), dt, launches = _counted(kernels, lambda: (
            _parallel(lambda tr: a.post("/report", tr), t64[:8]),
            a.post("/trace_attributes_batch", body)), absent)
        t1 = time.perf_counter()
        one = a.post("/report", t64[0])
        card_s = time.perf_counter() - t1
        health = a.get("/health")[1]
    finally:
        a.close()
    check([c for c, _h, _b in answers] == [200] * 8 and batch[0] == 200, "19.1 statuses")
    check([b for _c, _h, b in answers] == _reports(second, t64[:8]),
          "19.1 /report answers equal report() over match_many on the second matcher")
    check(batch[2] == {"results": _reports(second, body["traces"])},
          "19.1 the batch answer equals report() over match_many on the second matcher")
    check(one[2] == _reports(second, t64[:1])[0] and health["degraded"] is False,
          "19.1 one more /report on the card, not degraded")
    quiet("phase 19.1")
    print("phase 19.1 faults off: 8 /report + 1 /trace_attributes_batch (%d traces) 200, equal "
          "to the second matcher, in %.3f s; one /report alone %.3f s; no fault injected, no "
          "trip; launches %s" % (len(body["traces"]), t1 - t0, card_s, json.dumps(launches)))
    return {"wall_s": t1 - t0, "card_report_s": card_s}, launches


def recovery_poison(sv, second, t64):
    """19.2: REPORTER_FAULT_DISPATCH=uuid:poison-veh, quarantine_after 2,
    150 ms windows: 8 concurrent /report, 7 innocent; the poison answers
    500 "failed its device batch alone", the 7 equal the second matcher's,
    kernels 1-4 launched by the bisect; round 3's poison is refused 422
    with no launch; the same for streaming submits on the slab."""
    from reporter_tpu_torch.ops import _kernels
    from reporter_tpu_torch.serve import service as service_mod

    innocent = [dict(t64[24 + i], uuid="p19-veh-%d" % i) for i in range(7)]
    poison = dict(t64[31], uuid="poison-veh")
    want = _reports(second, innocent)
    s_inn = [(t64[32 + i], "p19-s-%d" % i) for i in range(5)]
    s_poi = (t64[37], "poison-veh")
    ref = _Served(second, max_batch=128, max_wait_ms=1, session_wait_ms=1)
    _arm(dispatch="uuid:poison-veh")
    b = _Served(sv, max_batch=128, max_wait_ms=150, session_wait_ms=150,
                robustness={"quarantine_after": 2})
    kernels, absent = _path_kernels(sv, BUCKETED)
    s_path, s_other = _forward(sv, 4, True)
    s_kernels, s_absent = _path_kernels(sv, s_path)
    out, launches, walls = {}, {}, []
    isolated0 = service_mod.counts()["poison_isolations"]
    try:
        for rnd in range(2):
            t0 = time.perf_counter()
            ans, _dt, counts = _counted(kernels, lambda: _parallel(
                lambda tr: b.post("/report", tr), innocent + [poison]), absent)
            walls.append(time.perf_counter() - t0)
            check(ans[-1][0] == 500 and "failed its device batch alone" in ans[-1][2]["error"],
                  "19.2 the poison fails alone: %s %s" % (ans[-1][0], ans[-1][2]))
            check([a[0] for a in ans[:-1]] == [200] * 7 and [a[2] for a in ans[:-1]] == want,
                  "19.2 the 7 innocents equal the second matcher's reports (round %d)" % rnd)
            launches["round %d" % (rnd + 1)] = counts
        (code, _h, body), _dt, late = _counted((), lambda: b.post("/report", poison),
                                                tuple(_kernels.KERNELS))
        check(code == 422 and "quarantined" in body["error"] and not any(late.values()),
              "19.2 round 3: the poison refused 422 with no launch: %s %s" % (code, body))
        isolated1 = service_mod.counts()["poison_isolations"]
        check((isolated1 - isolated0, b.svc.batcher.quarantined()) == (2, 1),
              "19.2 two isolations, one uuid quarantined")
        # streaming submits on the slab: 4 points each, two rounds, then the
        # repeat offender refused
        for rnd, j in enumerate((0, 4)):
            subs = [_stream_sub(tr, u, j) for tr, u in s_inn + [s_poi]]
            ans, _dt, counts = _counted(s_kernels, lambda: _parallel(
                lambda sub: b.post("/report", sub), subs), s_other + s_absent)
            check(ans[-1][0] == 500 and "failed its device batch alone" in ans[-1][2]["error"],
                  "19.2 the streaming poison fails alone")
            want_s = [_no_age(ref.svc.handle_report(json.loads(json.dumps(s)))[1])
                      for s in subs[:-1]]
            check([a[0] for a in ans[:-1]] == [200] * 5
                  and [_no_age(a[2]) for a in ans[:-1]] == want_s,
                  "19.2 the 5 streaming innocents equal a service on the second matcher "
                  "(round %d)" % rnd)
            launches["stream round %d" % (rnd + 1)] = counts
        (code, _h, body), _dt, late = _counted(
            (), lambda: b.post("/report", _stream_sub(s_poi[0], s_poi[1], 8)),
            tuple(_kernels.KERNELS))
        check(code == 422 and not any(late.values()), "19.2 the streaming poison refused 422")
        code, _h, body = b.post("/report", _stream_sub(s_inn[0][0], s_inn[0][1], 8))
        check(code == 200 and body["session"]["points_total"] == 12,
              "19.2 an innocent session streams on")
        # the windowed batcher's, then the session batcher's
        isolations = (isolated1 - isolated0,
                      service_mod.counts()["poison_isolations"] - isolated1)
    finally:
        _arm(dispatch=None)
        b.close()
        ref.close()
    print("phase 19.2 poison: rounds of 8 concurrent /report %s s, the poison 500 alone, the 7 "
          "equal to the second matcher; round 3 422, no launch; streaming on the slab the same "
          "(5 innocents + the poison, 4 points a submit); isolations %s; launches round 1 %s"
          % (", ".join("%.3f" % w for w in walls), isolations,
             json.dumps(launches["round 1"])))
    return {"walls_s": walls, "isolations": isolations}, launches


def recovery_watchdog(sv, second, t64, device):
    """19.3: a hung finish (REPORTER_FAULT_DEVICE_HANG=2.5:1, watchdog 0.4 s,
    re-attach probe every 0.25 s) trips the watchdog; /report, a binary
    /trace_attributes_batch and 16 streaming vehicles answer 200 degraded
    from the CPU baseline (the first two equal report() over it), /health
    says degraded; REPORTER_FAULT_DISPATCH=uuid:_warmup holds the re-attach
    probe (its dummy traces' uuid) off until both are cleared; then the
    service re-attaches, answers on the card equal to the second matcher,
    and each session rebuilds once from its replay.  Then a real device
    wait: one finish queues ``torch.cuda._sleep`` for 2.5 s on the stream
    before its fetch, and the watchdog trips while the finisher blocks in
    the CUDA copy."""
    from reporter_tpu_torch.matching import SegmentMatcher
    from reporter_tpu_torch.serve import wire

    cpu = SegmentMatcher(arrays=sv.arrays, ubodt=sv.ubodt, config=sv.cfg, backend="cpu")
    tr = dict(t64[40], uuid="w19-veh")
    batch = {"traces": [dict(t, uuid="w19-b-%d" % i) for i, t in enumerate(t64[41:45])]}
    vehicles = [(t64[48 + i], "w19-s-%d" % i) for i in range(16)]
    bin_h = {"Content-Type": wire.CONTENT_TYPE, "Accept": wire.CONTENT_TYPE}
    rb = {"watchdog_s": 0.4, "reattach_probe_s": 0.25}
    _arm(device_hang="2.5:1", dispatch="uuid:_warmup")
    c = _Served(sv, max_batch=128, max_wait_ms=5, session_wait_ms=1, robustness=rb)
    out, launches = {}, {}
    try:
        t0 = time.perf_counter()
        code, _h, body = c.post("/report", tr)
        out["degraded_report_s"] = time.perf_counter() - t0
        want = _reports(cpu, [tr])[0]
        check(code == 200 and body.pop("degraded", None) is True and body == want,
              "19.3 the wedged /report answers 200 degraded, equal to report() over the CPU "
              "baseline")
        t0 = time.perf_counter()
        code, hdrs, frame = c.post("/trace_attributes_batch",
                                   wire.encode_request(json.loads(json.dumps(batch))), bin_h)
        out["degraded_batch_s"] = time.perf_counter() - t0
        check(code == 200 and wire.response_degraded(frame)
              and wire.decode_response(frame) == {"results": _reports(cpu, batch["traces"]),
                                                  "degraded": True},
              "19.3 the binary batch answers degraded, equal to the CPU baseline's reports")
        check(c.get("/health")[1]["degraded"] is True, "19.3 /health says degraded")
        t0 = time.perf_counter()
        first = _parallel(lambda v: c.post("/report", _stream_sub(v[0], v[1], 0)), vehicles)
        out["degraded_stream_s"] = time.perf_counter() - t0
        check(all(a[0] == 200 and a[2]["degraded"] is True and a[2]["session"]["points_total"]
                  == 4 for a in first), "19.3 16 streaming vehicles answer 200 degraded")
        held = c.svc.degraded
        _arm(device_hang=None, dispatch=None)
        out["reattach_after_clear_s"] = _wait_reattach(c.svc)
        out["degraded_window_s"] = c.svc.reattach_s
        check(held, "19.3 degraded until the faults were cleared")
        kernels, absent = _path_kernels(sv, BUCKETED)
        t0 = time.perf_counter()
        (code, _h, body), _dt, launches["report"] = _counted(
            kernels, lambda: c.post("/report", tr), absent)
        out["card_report_s"] = time.perf_counter() - t0
        check(code == 200 and "degraded" not in body and body == _reports(second, [tr])[0],
              "19.3 after re-attach /report runs on the card, equal to the second matcher")
        code, _h, body = c.post("/trace_attributes_batch", batch)
        check(code == 200 and body == {"results": _reports(second, batch["traces"])},
              "19.3 after re-attach the batch equals the second matcher")
        s_path, s_other = _forward(sv, 16, True)
        s_kernels, s_absent = _path_kernels(sv, s_path)
        rebuilt, _dt, launches["rebuild"] = _counted(s_kernels, lambda: _parallel(
            lambda v: c.post("/report", _stream_sub(v[0], v[1], 4)), vehicles),
            s_other + s_absent)
        windowed = _reports(second, [dict(v[0], uuid=v[1], trace=v[0]["trace"][:8])
                                     for v in vehicles])
        for (code, _h, body), w in zip(rebuilt, windowed):
            check(code == 200 and "degraded" not in body and body["session"]["rebuilt"] is True
                  and body["session"]["points_total"] == 8 and body["datastore"] == w["datastore"],
                  "19.3 each session rebuilds once from its replay, equal to the windowed "
                  "decode of its 8 points")
        again = _parallel(lambda v: c.post("/report", _stream_sub(v[0], v[1], 8)), vehicles)
        check(all(a[0] == 200 and a[2]["session"]["rebuilt"] is False
                  and a[2]["session"]["points_total"] == 12 for a in again),
              "19.3 the next step carries the rebuilt beam")
        trips = sum(b.trips for b in c.svc._retired)
        check(trips == 1 and c.svc.batcher.trips == 0, "19.3 one watchdog trip")
    finally:
        _arm(device_hang=None, dispatch=None)
        c.close()
    if device.type == "cuda":
        out["real_wait"] = recovery_real_wait(sv, second, tr, rb)
    print("phase 19.3 watchdog: degraded /report %.3f s (after re-attach %.3f s), binary batch of "
          "%d %.3f s, 16 streaming vehicles %.3f s, all from the CPU baseline; re-attached "
          "%.3f s after the faults cleared (%.3f s degraded); sessions rebuilt once each; "
          "launches after re-attach %s%s" % (
              out["degraded_report_s"], out["card_report_s"], len(batch["traces"]),
              out["degraded_batch_s"], out["degraded_stream_s"], out["reattach_after_clear_s"],
              out["degraded_window_s"], json.dumps(launches["report"]),
              "; real device wait: %s" % json.dumps(out["real_wait"]) if "real_wait" in out
              else ""))
    return out, launches


def recovery_real_wait(sv, second, tr, rb):
    """One finish first queues a 2.5 s ``torch.cuda._sleep`` on the current
    (the matcher's) stream, so its fetch blocks inside CUDA: the watchdog
    must trip while the finisher is still blocked there."""
    import torch

    cycles = _sleep_cycles(2.5)
    state = {"armed": True, "in_fetch": False}
    orig = sv.match_many_async

    def wedged(traces):
        finish = orig(traces)
        if not state.pop("armed", False):
            return finish

        def spin_then_finish():
            torch.cuda._sleep(cycles)
            state["in_fetch"] = True
            try:
                return finish()
            finally:
                state["in_fetch"] = False
                state["fetched"] = time.perf_counter()
        return spin_then_finish

    d = _Served(sv, max_wait_ms=5, robustness=rb)
    sv.match_many_async = wedged
    try:
        t0 = time.perf_counter()
        code, _h, body = d.post("/report", tr)
        answered = time.perf_counter()
        blocked = state["in_fetch"]
        check(code == 200 and body.get("degraded") is True and blocked,
              "19.3 the watchdog tripped while the finisher blocked in the CUDA fetch "
              "(answered %.3f s, still blocked %s)" % (answered - t0, blocked))
        reattach = _wait_reattach(d.svc)
        code, _h, body = d.post("/report", tr)
        check(code == 200 and "degraded" not in body and body == _reports(second, [tr])[0],
              "19.3 after the real wait the card answers again")
        check(sum(b.trips for b in d.svc._retired) == 1, "19.3 one trip on the real wait")
    finally:
        sv.__dict__.pop("match_many_async", None)
        d.close()
    return {"degraded_answer_s": answered - t0, "fetch_returned_s": state["fetched"] - t0,
            "reattach_s": reattach, "sleep_cycles": cycles}


def recovery_handoff(sv, second, t64):
    """19.4: the 512 x 64 cohort as sessions in 16 steps of 4 on the slab:
    uninterrupted on service A (the card's matcher); then steps 1-8 on A,
    the sessions handed to service B on the second matcher by GET
    /sessions?export=1 + POST /sessions, by POST {"pop"}, and by a sync
    checkpoint directory read back with ``read_checkpoints``, and steps
    9-16 on B: records and answers equal A's bit for bit."""
    from reporter_tpu_torch.matching.session import read_checkpoints

    uuids = ["h19-" + tr["uuid"] for tr in t64]
    steps = len(t64[0]["trace"]) // 4
    s_path, s_other = _forward(sv, 4, True)
    s_kernels, s_absent = _path_kernels(sv, s_path)
    launches = {}

    def steps_counted(served, js, what):
        """The sessions' steps ``js`` through the launch counters."""
        out, _dt, launches[what] = _counted(s_kernels, lambda: [
            [_no_age(a) for a in served.svc.session_batcher.match_many(
                [_stream_sub(tr, u, 4 * j) for tr, u in zip(t64, uuids)])] for j in js],
            s_other + s_absent)
        return out

    def records(served):
        return [served.svc.session_store.peek(u).records for u in uuids]

    def drop(served):
        for u in uuids:
            served.svc.session_store.drop(u)

    def unimported(answers):
        for a in answers:
            a["_stream"]["session"].pop("imported")
        return answers

    a = _Served(sv, max_batch=128)
    t0 = time.perf_counter()
    want = [unimported(x) for x in steps_counted(a, range(steps), "uninterrupted")]
    step_s = (time.perf_counter() - t0) / steps
    want_records = records(a)
    drop(a)
    a.close()
    out = {"sessions": len(uuids), "steps": steps, "step_s": step_s}
    ckpt_root = os.path.join(REPO, "build", "recovery_ckpt")
    for how in ("export", "pop", "checkpoint"):
        rb = ({"session_checkpoint_s": 3600, "session_checkpoint_sync": True,
               "session_checkpoint_dir": ckpt_root} if how == "checkpoint" else {})
        a = _Served(sv, max_batch=128, robustness=rb)
        b = _Served(second, max_batch=128)
        try:
            t0 = time.perf_counter()
            head = steps_counted(a, range(steps // 2), how + " head")
            head_s = time.perf_counter() - t0
            check([unimported(h) for h in head] == want[: steps // 2],
                  "19.4 %s: steps 1-%d equal the uninterrupted run" % (how, steps // 2))
            t0 = time.perf_counter()
            if how == "export":
                code, body, n_out = a.get("/sessions?export=1")
                check(code == 200 and len(body["sessions"]) == len(uuids), "19.4 export")
                wires = body["sessions"]
            elif how == "pop":
                code, _h, body = a.post("/sessions", {"pop": uuids})
                wires = body["sessions"]
                n_out = len(json.dumps(body, separators=(",", ":")))
                check(code == 200 and len(wires) == len(uuids) and len(a.svc.session_store) == 0,
                      "19.4 pop removes every session")
            else:
                d = a.svc.session_checkpointer.dir
                wires = read_checkpoints(d)
                n_out = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
                check(len(wires) == len(uuids), "19.4 one checkpoint file a session")
            out_s = time.perf_counter() - t0
            data = json.dumps({"sessions": wires})
            t0 = time.perf_counter()
            code, _h, res = b.post("/sessions", json.loads(data))
            in_s = time.perf_counter() - t0
            check(code == 200 and res["imported"] == len(uuids) and res["rebuild_pending"] == 0,
                  "19.4 %s: every session imported with its beam" % how)
            tail = [unimported(x) for x in steps_counted(b, range(steps // 2, steps),
                                                         how + " tail")]
            check(tail == want[steps // 2:], "19.4 %s: steps %d-%d on the second matcher equal "
                  "the uninterrupted run's answers" % (how, steps // 2 + 1, steps))
            check(records(b) == want_records, "19.4 %s: records equal bit for bit" % how)
            out[how] = {"head_s": head_s, "out_bytes": n_out, "out_s": out_s,
                        "import_bytes": len(data), "import_s": in_s}
        finally:
            drop(a)
            drop(b)
            a.close()
            b.close()
    print("phase 19.4 handoff: %d sessions x %d steps of 4, %.3f s a step; %s; steps %d-%d on "
          "the second matcher equal the uninterrupted run bit for bit each way" % (
              len(uuids), steps, step_s, "; ".join(
                  "%s %d B in %.3f s, import %d B in %.3f s (steps 1-%d %.3f s)" % (
                      how, o["out_bytes"], o["out_s"], o["import_bytes"], o["import_s"],
                      steps // 2, o["head_s"])
                  for how, o in out.items() if isinstance(o, dict)), steps // 2 + 1, steps))
    return out, launches


def recovery_drain(cfg_json, second, t1024, device):
    """19.5: ``python -m reporter_tpu_torch.serve`` on the tiles config in a
    process of its own (1.5 s batch windows): an inflight 16 x 1,024
    /trace_attributes_batch, then SIGTERM; the inflight request answers 200
    equal to the second matcher, a new /report 503 "draining" with
    Retry-After, /health 503 "draining", and the process exits 0."""
    import signal
    import urllib.error

    with open(cfg_json) as f:
        conf = json.load(f)
    conf["batch"] = {"max_wait_ms": 1500}
    path = os.path.join(os.path.dirname(cfg_json), "config_drain.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    argv = [sys.executable, "-m", "reporter_tpu_torch.serve", path, "127.0.0.1:0"]
    if device.type != "cuda":
        argv[3:3] = ["--device", "cpu"]
    env = dict(os.environ, REPORTER_DRAIN_GRACE_S="60", REPORTER_REPLICA_ID="rep-drain")
    t_boot = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    log_tail = []
    try:
        port = None
        while port is None and time.perf_counter() - t_boot < 300:
            line = proc.stderr.readline()
            if not line:
                check(proc.poll() is None, "the serve process booted: %s"
                      % b"".join(log_tail[-20:]).decode(errors="replace"))
                continue
            log_tail.append(line)
            if b"on 127.0.0.1:" in line:
                port = int(line.split(b"on 127.0.0.1:")[1].split()[0])
        check(port is not None, "the serve process logged its port")
        boot_s = time.perf_counter() - t_boot
        threading.Thread(target=lambda: log_tail.extend(proc.stderr), daemon=True).start()

        def call(path_, body=None):
            if body is None:
                try:
                    with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path_),
                                                timeout=60) as r:
                        return r.status, dict(r.headers), json.loads(r.read())
                except urllib.error.HTTPError as e:
                    return e.code, dict(e.headers), json.loads(e.read())
            code, hdrs, raw = _post_raw(port, path_, json.dumps(body).encode(),
                                        {"Content-Type": "application/json"})
            return code, hdrs, json.loads(raw)

        check(call("/health")[0] == 200, "19.5 the serve process answers /health")
        # the boot is deferred: /health answers "warming" from the bind and
        # names the backend once the engine is attached
        _v, attach_s = _until(lambda: call("/health")[2].get("backend"),
                              "19.5 the engine attached", 300, 0.05)
        body = {"traces": t1024[:16]}
        inflight = {}
        th = threading.Thread(target=lambda: inflight.update(
            r=call("/trace_attributes_batch", body)))
        th.start()
        time.sleep(0.6)  # inside its 1.5 s batch window
        t_sig = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        time.sleep(0.3)
        code, hdrs, late = call("/report", t1024[0])
        check(code == 503 and late.get("status") == "draining"
              and int(hdrs.get("Retry-After", 0)) >= 1,
              "19.5 a new /report during the drain: 503 draining with Retry-After")
        code, _h, health = call("/health")
        check(code == 503 and health["status"] == "draining", "19.5 /health 503 draining")
        th.join(300)
        code, hdrs, got = inflight["r"]
        check(code == 200 and got == {"results": _reports(second, body["traces"])}
              and hdrs.get("X-Reporter-Replica") == "rep-drain",
              "19.5 the inflight batch answers 200, equal to the second matcher")
        rc = proc.wait(timeout=90)
        exit_s = time.perf_counter() - t_sig
        check(rc == 0, "19.5 the process exits 0 after the drain: %s"
              % b"".join(log_tail[-20:]).decode(errors="replace"))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    print("phase 19.5 drain: the serve process bound on the tiles config in %.1f s and "
          "attached its engine %.1f s later; SIGTERM with a 16 x 1,024 "
          "/trace_attributes_batch inflight: it answered 200 equal to the second matcher, a "
          "new /report 503 draining, /health 503 draining; exit 0 %.2f s after the signal"
          % (boot_s, attach_s, exit_s))
    return {"boot_s": boot_s, "attach_s": attach_s, "exit_after_sigterm_s": exit_s}


def recovery_phase(cfg_json, sv, second, t64, t256, t1024, device, card=""):
    """Phase 19: service recovery on the realistic city's tiles config with
    the serving defaults (``recovery_faults_off``, ``recovery_poison``,
    ``recovery_watchdog``, ``recovery_handoff``, ``recovery_drain``), every
    send through the launch counters; returns (figures, launches)."""
    from reporter_tpu_torch import faults

    t0 = time.perf_counter()
    info, runs = {}, []
    info["faults_off"], launches = recovery_faults_off(sv, second, t64, t256, t1024)
    runs.append(launches)
    info["poison"], launches = recovery_poison(sv, second, t64)
    runs.extend(launches.values())
    info["watchdog"], launches = recovery_watchdog(sv, second, t64, device)
    runs.extend(launches.values())
    info["handoff"], launches = recovery_handoff(sv, second, t64)
    runs.extend(launches.values())
    info["drain"] = recovery_drain(cfg_json, second, t1024, device)
    info["counts"] = recovery_counts()
    info["wall_s"] = time.perf_counter() - t0
    _RECOVERY_BASE.append(info["counts"])
    check(not any(v.startswith("REPORTER_FAULT_") for v in os.environ), "faults cleared")
    print("phase 19 recovery (%s): %.1f s; faults fired %s" % (
        card, info["wall_s"], json.dumps({p: n for p, n in info["counts"]["injected"].items()
                                          if n})))
    total = {k: sum(r[k] for r in runs) for k in runs[0]}
    faults.reset()
    return info, total


# -- phase 20: the serving process's observability on the card ----------------

# the top-level keys of the JAX package's /statusz
STATUSZ_KEYS = {
    "uptime_s", "replica", "draining", "warming", "backend", "viterbi_kernel",
    "threshold_sec", "batch", "degraded", "wedged", "crashed", "robustness",
    "latency_buckets_s", "batch_fill_buckets", "flight", "attrib", "slo", "quality",
    "sparse", "sessions", "session_arena", "ubodt_tier", "adaptive", "checkpoint",
    "economics", "memory", "metrics"}
# the realistic city's table (phase 17): the device memory gauge reads at least it
TABLE_BYTES_MIN = 536.9e6
VITERBI = ("viterbi_scan", "viterbi_chain", "viterbi_assoc", "viterbi_chain_assoc")


def _p20(t64, i):
    """Phase 20's i-th trace of the short cohort, from its second half."""
    return t64[(len(t64) // 2 + i) % len(t64)]


def _get_raw(port, path, headers=None):
    """GET a path of the port's server: (status, headers, body bytes)."""
    import urllib.error

    req = urllib.request.Request("http://127.0.0.1:%d%s" % (port, path),
                                 headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _prom(text):
    """Prometheus text -> ({family: kind}, {(sample name, labels): value}),
    refusing any line that is not a comment or a sample."""
    import re

    fams, samples = {}, {}
    sample_re = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
    label_re = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _h, _t, name, kind = line.split(" ")
            fams[name] = kind
            continue
        if line.startswith("# HELP ") or not line:
            continue
        m = sample_re.match(line)
        check(m is not None, "a Prometheus sample line: %r" % line[:200])
        labels = tuple(label_re.findall(m.group(3) or ""))
        samples[(m.group(1), labels)] = float(m.group(4))
    return fams, samples


def _sample_sum(samples, name, **match):
    return sum(v for (n, labels), v in samples.items() if n == name
               and all(dict(labels).get(k) == w for k, w in match.items()))


def observability_phase(sv, t64, t256, osm_ms, device, card=""):
    """Phase 20: the serving process's observability on the realistic
    city's tiles config under the serving defaults (``sv``, phases 18 and
    19's matcher): 20.1 the metrics, status, trace, SLO and memory
    surfaces after a fixed mix (``obs_mix``); 20.2 the profiler's stage
    attribution of the hand-written kernels (``obs_attrib``); 20.3 the
    shadow-oracle quality windows against the port on the CPU
    (``obs_quality``); 20.4 ``match_many`` with the stage ranges off and
    on (``obs_scopes``).  Returns the figures."""
    t0 = time.perf_counter()
    info = {"mix": obs_mix(sv, t64, t256, device),
            "attrib": obs_attrib(sv, t64, osm_ms, device, card),
            "quality": obs_quality(sv, t64),
            "scopes": obs_scopes(sv, t64)}
    info["wall_s"] = time.perf_counter() - t0
    print("phase 20 observability (%s): %.1f s" % (card, info["wall_s"]))
    return info


def obs_mix(sv, t64, t256, device):
    """20.1: 16 /report, one binary /trace_attributes_batch of 24 traces, 8
    streaming vehicles x 4 submits of 4 points, then one /report poisoned
    by REPORTER_FAULT_DISPATCH, each with its own X-Reporter-Trace, through
    the launch counters; a fresh SLO engine and a flight recorder that
    keeps every trace.  /metrics parses and holds every family the port
    registers (tools/check_metrics.py's scan of the package, the batch and
    stream modules' too) with its labels; its request, trace, point and dispatch counts equal the
    traffic and the launch counters' deltas; /statusz has the JAX
    package's keys; /debug/traces holds every trace id sent, the poisoned
    one by right; /debug/slo counts the requests; the device memory gauge
    reads at least the city's table."""
    import importlib.util

    import torch

    # the batch, stream and fleet modules' families register at import
    import reporter_tpu_torch.batch.pipeline  # noqa: F401
    import reporter_tpu_torch.obs.federation  # noqa: F401
    import reporter_tpu_torch.serve.autoscale  # noqa: F401
    import reporter_tpu_torch.serve.router  # noqa: F401
    import reporter_tpu_torch.stream.checkpoint  # noqa: F401
    import reporter_tpu_torch.stream.topology  # noqa: F401
    from reporter_tpu_torch.obs import flight as obs_flight
    from reporter_tpu_torch.obs import metrics as obs_metrics
    from reporter_tpu_torch.ops import _kernels
    from reporter_tpu_torch.serve import wire

    spec = importlib.util.spec_from_file_location(
        "check_metrics", os.path.join(REPO, "tools", "check_metrics.py"))
    check_metrics = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check_metrics)
    want_fams = check_metrics.registered_labels(os.path.join(REPO, "reporter_tpu_torch"))
    reports = [dict(_p20(t64, i), uuid="p20-r-%d" % i) for i in range(16)]
    batch = [dict(t, uuid="p20-b-%d" % i)
             for i, t in enumerate([_p20(t64, 16 + i) for i in range(20)] + t256[:4])]
    vehicles = [(_p20(t64, 36 + v), "p20-s-%d" % v) for v in range(8)]
    poison = dict(_p20(t64, 44), uuid="p20-poison")
    saved = obs_flight.RECORDER
    obs_flight.RECORDER = obs_flight.FlightRecorder(capacity=256, slow_ms=250,
                                                    sample_every=1)
    b = _Served(sv, max_batch=128, max_wait_ms=2, session_wait_ms=2, slo={})
    sent, codes = [], {}
    try:
        before = obs_metrics.REGISTRY.snapshot()
        _kernels.reset_launches()
        t_mix = time.perf_counter()
        for i, tr in enumerate(reports):
            tid = "p20-report-%d" % i
            code, hdrs, _body = b.post("/report", tr, {"Content-Type": "application/json",
                                                        "X-Reporter-Trace": tid})
            sent.append(tid)
            codes[tid] = (code, hdrs.get("X-Reporter-Trace"))
        code, hdrs, raw = _post_raw(b.port, "/trace_attributes_batch",
                                    wire.encode_request({"traces": batch}),
                                    {"Content-Type": wire.CONTENT_TYPE,
                                     "Accept": wire.CONTENT_TYPE,
                                     "X-Reporter-Trace": "p20-batch"})
        sent.append("p20-batch")
        codes["p20-batch"] = (code, hdrs.get("X-Reporter-Trace"))
        check(code == 200 and len(wire.decode_response(raw)["results"]) == 24,
              "20.1 the binary batch of 24 traces: %s" % code)
        for j in (0, 4, 8, 12):
            for tr, u in vehicles:
                tid = "p20-%s-%d" % (u, j)
                code, hdrs, _body = b.post("/report", _stream_sub(tr, u, j),
                                           {"Content-Type": "application/json",
                                            "X-Reporter-Trace": tid})
                sent.append(tid)
                codes[tid] = (code, hdrs.get("X-Reporter-Trace"))
        _arm(dispatch="uuid:p20-poison")
        try:
            code, hdrs, _body = b.post("/report", poison,
                                       {"Content-Type": "application/json",
                                        "X-Reporter-Trace": "p20-poison"})
        finally:
            _arm(dispatch=None)
        sent.append("p20-poison")
        codes["p20-poison"] = (code, hdrs.get("X-Reporter-Trace"))
        if device.type == "cuda":
            torch.cuda.synchronize()
        launches = {k: kern.launches for k, kern in _kernels.KERNELS.items()}
        mix_s = time.perf_counter() - t_mix
        check(all(c == (200 if t != "p20-poison" else 500) and echo == t
                  for t, (c, echo) in codes.items()),
              "20.1 every answer 200 (the poison 500) and echoing its X-Reporter-Trace: %s"
              % json.dumps({t: c for t, c in codes.items() if c[0] != 200}))
        code, hdrs, raw = _get_raw(b.port, "/metrics", {"X-Reporter-Trace": "p20-scrape"})
        check(code == 200 and hdrs.get("Content-Type", "").startswith("text/plain")
              and hdrs.get("X-Reporter-Trace") == "p20-scrape", "20.1 /metrics answers text")
        fams, samples = _prom(raw.decode())
        check(set(fams) == set(want_fams), "20.1 /metrics holds every family the port "
              "registers, and no other: missing %s, extra %s" % (
                  sorted(set(want_fams) - set(fams)), sorted(set(fams) - set(want_fams))))
        snap = obs_metrics.REGISTRY.snapshot()
        check(all(tuple(snap[n]["labelnames"]) == want_fams[n] for n in want_fams),
              "20.1 every family's labels as registered")
        for (name, labels), _v in samples.items():
            base = name
            for suffix in ("_bucket", "_sum", "_count"):
                if fams.get(name) is None and name.endswith(suffix):
                    base = name[: -len(suffix)]
            names = tuple(k for k, _ in labels if k != "le")
            check(names == want_fams[base], "20.1 %s's sample labels %s" % (name, names))

        def delta(name, **match):
            def total(s):
                return sum(v for lv, v in s[name]["samples"]
                           if all(dict(zip(s[name]["labelnames"], lv)).get(k) == w
                                  for k, w in match.items()))
            return total(snap) - total(before)

        req = {(e, o): delta("reporter_requests_total", endpoint=e, outcome=o)
               for e, o in (("report", "ok"), ("report", "error"), ("report_stream", "ok"),
                            ("trace_attributes_batch", "ok"))}
        check(req == {("report", "ok"): 16, ("report", "error"): 1,
                      ("report_stream", "ok"): 32, ("trace_attributes_batch", "ok"): 1},
              "20.1 reporter_requests_total counts the traffic: %s" % req)
        matched = reports + batch
        n_pts = sum(len(t["trace"]) for t in matched)
        check((delta("reporter_traces_matched_total"), delta("reporter_points_matched_total"))
              == (len(matched), n_pts),
              "20.1 traces and points matched equal the windowed traffic's %d, %d"
              % (len(matched), n_pts))
        viterbi = sum(v for k, v in launches.items() if k.split("[")[0] in VITERBI)
        dispatched = delta("reporter_dispatch_total")
        # on host cores the plain versions run: no launch to count
        check(dispatched == viterbi > 0 if device.type == "cuda" else dispatched > 0,
              "20.1 reporter_dispatch_total's delta %d equals the Viterbi kernels' launches %d"
              % (dispatched, viterbi))
        counted = {k: delta("reporter_kernel_launches_total", kernel=k) for k in launches}
        check(counted == launches, "20.1 reporter_kernel_launches_total's deltas equal the "
              "launch counters: %s" % json.dumps({k: (v, launches[k]) for k, v in
                                                  counted.items() if v != launches[k]}))
        check(delta("reporter_faults_injected_total", point="dispatch") == 1
              and delta("reporter_poison_isolated_total") == 1,
              "20.1 one fault fired, one poison isolated")
        code, _h, raw = _get_raw(b.port, "/statusz")
        statusz = json.loads(raw)
        check(code == 200 and set(statusz) == STATUSZ_KEYS,
              "20.1 /statusz has the JAX package's keys: %s" % sorted(
                  set(statusz) ^ STATUSZ_KEYS))
        code, _h, raw = _get_raw(b.port, "/debug/traces?n=512")
        kept = {t["trace_id"]: t for t in json.loads(raw)["traces"]}
        check(code == 200 and set(sent) <= set(kept),
              "20.1 /debug/traces holds every trace id sent: missing %s"
              % sorted(set(sent) - set(kept)))
        check(kept["p20-poison"]["retained"] == "error" and kept["p20-poison"]["poison"],
              "20.1 the poisoned trace kept by right: %s" % kept["p20-poison"])
        code, _h, raw = _get_raw(b.port, "/debug/slo")
        routes = json.loads(raw)["routes"]
        got = {r: (routes[r]["good"], routes[r]["bad"]) for r in routes}
        check(got == {"report": (16, 1), "report_stream": (32, 0),
                      "trace_attributes_batch": (1, 0)},
              "20.1 /debug/slo counts the requests: %s" % got)
        mem = _sample_sum(samples, "reporter_device_memory_bytes", space="device",
                          subsystem="in_use")
        if device.type == "cuda":
            check(mem >= TABLE_BYTES_MIN, "20.1 reporter_device_memory_bytes{space="
                  "\"device\"} in_use %.1f MB >= the table's 536.9 MB" % (mem / 1e6))
        for path in ("/debug/cost", "/debug/history", "/health"):
            check(_get_raw(b.port, path)[0] == 200, "20.1 %s answers" % path)
    finally:
        b.close()
        obs_flight.RECORDER = saved
    print("20.1 mix: %d requests in %.2f s; /metrics %d families, %d samples, %d bytes; "
          "device memory in_use %.1f MB, limit %.1f MB; dispatches %d = Viterbi launches; "
          "launches %s" % (
              len(sent), mix_s, len(fams), len(samples), len(raw),
              mem / 1e6, _sample_sum(samples, "reporter_device_memory_bytes", space="device",
                                     subsystem="limit") / 1e6,
              dispatched, json.dumps({k: v for k, v in launches.items() if v})))
    return {"requests": len(sent), "wall_s": mix_s, "families": len(fams),
            "samples": len(samples), "device_in_use_mb": mem / 1e6, "launches": launches}


def obs_attrib(sv, t64, osm_ms, device, card=""):
    """20.2: GET /debug/attrib?capture=1&reps=3: every hand-written kernel
    of its path is seen by the profiler once per launch of the capture
    window (the warm call before it is not captured: launches = 3/4 of the
    counters' delta over the request), under its stage label; every path
    label reads more than 0 s.  Then a capture of ``match_many`` over the
    512 x 64 cohort (3 reps after one warm call outside the window), whose
    per-launch device time is set beside phase 17's CUDA-event time of
    the same kernel at the same shape, launches equal to the counters'.
    A capture while another holds the profiler answers 409 naming it;
    /debug/profile?seconds=1 over live traffic writes a trace directory
    that ``parse_trace_dir`` reads."""
    import torch

    from reporter_tpu_torch.obs import attrib, profiler
    from reporter_tpu_torch.ops import _kernels

    kernels, _absent = _path_kernels(sv, BUCKETED)
    b = _Served(sv, max_batch=128, max_wait_ms=2)
    out = {}
    try:
        _kernels.reset_launches()
        t0 = time.perf_counter()
        code, _h, raw = _get_raw(b.port, "/debug/attrib?capture=1&reps=3")
        out["endpoint_wall_s"] = time.perf_counter() - t0
        check(code == 200, "20.2 /debug/attrib?capture=1 answers: %s %s" % (code, raw[:300]))
        res = json.loads(raw)["attrib"]
        labels = {_kernels.KERNELS[k].stage for k in kernels}
        check(all(res["stages_ms"].get(lb, 0.0) > 0.0 for lb in labels),
              "20.2 every path label reads more than 0 s: %s" % res["stages_ms"])
        card_only = device.type == "cuda"  # on host cores no kernel launches
        if card_only:
            counts = {k: kern.launches for k, kern in _kernels.KERNELS.items()
                      if kern.launches}
            check(set(counts) == set(kernels), "20.2 the capture's path launched %s: %s"
                  % (kernels, counts))
            seen = {k: v["launches"] for k, v in res["kernels"].items()}
            check(seen == {k: n * 3 // 4 for k, n in counts.items()}
                  and all(n % 4 == 0 for n in counts.values()),
                  "20.2 the profiler saw every launch of the window: %s against %s"
                  % (seen, counts))
            check(all(res["kernels"][k]["stage"] == _kernels.KERNELS[k].stage
                      for k in kernels), "20.2 each kernel under its stage label")
        out["endpoint"] = {k: res[k] for k in ("stages_ms", "unattributed_frac", "kernels",
                                                "attributed_by", "wall_s")}
        # the main path's shape, set beside phase 17's times
        rows = t64[:512]
        sv.match_many(rows)
        if device.type == "cuda":
            torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        cap = attrib.capture(lambda: sv.match_many(rows), reps=3, warm=False)
        out["window_wall_s"] = time.perf_counter() - t0
        counts = {k: kern.launches for k, kern in _kernels.KERNELS.items() if kern.launches}
        seen = {k: v["launches"] for k, v in cap["kernels"].items()}
        check(seen == counts and (bool(seen) or not card_only),
              "20.2 512 x 64: the profiler saw every launch: %s against %s"
              % (seen, counts))
        table = {}
        for k, v in sorted(cap["kernels"].items()):
            per = v["device_ms"] / v["launches"]
            table[k] = {"stage": v["stage"], "launches": v["launches"],
                        "device_ms": v["device_ms"], "per_launch_ms": per,
                        "phase17_ms": osm_ms.get(k),
                        "ratio": per / osm_ms[k] if osm_ms.get(k) else None}
        out["main_shape"] = {"stages_ms": cap["stages_ms"],
                             "unattributed_frac": cap["unattributed_frac"],
                             "device_total_ms": cap["device_total_ms"],
                             "attributed_by": cap["attributed_by"], "kernels": table,
                             "host_frac": cap["host_frac"]}
        print("20.2 attribution (%s): endpoint window %.2f s, stages %s, unattributed %.4f; "
              "512 x 64 window %.2f s (3 reps), device %.4f ms, unattributed share %.4f, "
              "by %s; per label: %s" % (
                  card, out["endpoint_wall_s"], json.dumps(res["stages_ms"]),
                  res["unattributed_frac"], out["window_wall_s"], cap["device_total_ms"],
                  cap["unattributed_frac"], json.dumps(cap["attributed_by"]), "; ".join(
                      "%s [%s] %d launches, %.4f ms/launch, phase 17 %s ms, ratio %s" % (
                          k, r["stage"], r["launches"], r["per_launch_ms"],
                          "%.4f" % r["phase17_ms"] if r["phase17_ms"] else "-",
                          "%.3f" % r["ratio"] if r["ratio"] else "-")
                      for k, r in table.items())))
        # single flight: a capture while another holds the profiler is a 409
        with profiler.session("attrib", trace_id="p20-owner"):
            code, _h, raw = _get_raw(b.port, "/debug/attrib?capture=1&reps=1")
        busy = json.loads(raw)
        check(code == 409 and busy["inflight"]["trace_id"] == "p20-owner",
              "20.2 a second capture answers 409 naming the first: %s %s" % (code, busy))
        # /debug/profile over live traffic
        stop = threading.Event()

        def traffic():
            i = 0
            while not stop.is_set():
                b.post("/report", dict(_p20(t64, 45 + i % 16), uuid="p20-prof-%d" % i))
                i += 1
        th = threading.Thread(target=traffic, daemon=True)
        th.start()
        try:
            code, _h, raw = _get_raw(b.port, "/debug/profile?seconds=1")
        finally:
            stop.set()
            th.join(60)
        prof = json.loads(raw)
        check(code == 200, "20.2 /debug/profile answers: %s %s" % (code, prof))
        parsed = attrib.parse_trace_dir(prof["trace_dir"])
        check(parsed["platform"] == "cuda" and parsed["device_total_ms"] > 0
              if card_only else bool(parsed["stages_ms"]),
              "20.2 the profile's trace directory parses with the traffic's work in it: %s"
              % parsed["stages_ms"])
        if card_only:
            # the batchers' threads launch: every launch under its label,
            # nothing left unattributed
            got = {k: (v["stage"], v["launches"] > 0) for k, v in parsed["kernels"].items()}
            check(parsed["unattributed_frac"] == 0
                  and got == {k: (_kernels.KERNELS[k].stage, True) for k in kernels},
                  "20.2 /debug/profile attributes every path kernel under its label and "
                  "nothing else: unattributed %s, kernels %s, path %s"
                  % (parsed["unattributed_frac"], got, kernels))
        out["profile"] = {"stages_ms": parsed["stages_ms"],
                          "kernels": {k: v["launches"] for k, v in parsed["kernels"].items()}}
        print("20.2 /debug/profile?seconds=1 over live /report traffic: stages %s"
              % json.dumps(parsed["stages_ms"]))
    finally:
        b.close()
    return out


QUALITY_REQUESTS = 16  # phase 20.3's /report: every 4th is held against the oracle


def obs_quality(sv, t64):
    """20.3: REPORTER_QUALITY_SAMPLE_EVERY=4 (and REPORTER_QUALITY_PACE=0,
    no self-throttle) for one service only: 16 /report, the quality engine
    drained; its agreement per cohort equals, exactly, a QualityEngine on
    the port on the CPU (the same arrays, table and config) fed the same
    sampled traces with the CPU's edges."""
    import dataclasses

    from reporter_tpu_torch.matching import SegmentMatcher
    from reporter_tpu_torch.obs import quality as obs_quality

    traces = [dict(_p20(t64, 61 + i), uuid="p20-q-%d" % i) for i in range(QUALITY_REQUESTS)]
    os.environ["REPORTER_QUALITY_SAMPLE_EVERY"] = "4"
    os.environ["REPORTER_QUALITY_PACE"] = "0"
    try:
        b = _Served(sv, max_batch=128, max_wait_ms=2)
    finally:
        del os.environ["REPORTER_QUALITY_SAMPLE_EVERY"]
        del os.environ["REPORTER_QUALITY_PACE"]
    t0 = time.perf_counter()
    try:
        eng = b.svc.quality
        check(eng is not None and eng.sample_every == 4, "20.3 the quality engine is on")
        for tr in traces:
            code, _h, _body = b.post("/report", tr)
            check(code == 200, "20.3 /report answers 200")
        check(eng.drain(120.0), "20.3 the quality engine drained")
        card = eng.report()
    finally:
        b.close()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # windowed traffic only: the CPU matcher needs no session slab
    cpu = SegmentMatcher(arrays=sv.arrays, ubodt=sv.ubodt, device="cpu",
                         config=dataclasses.replace(sv.cfg, session_arena=False))
    ref = obs_quality.QualityEngine(cpu, sample_every=1, window_s=card["window_s"],
                                    target=card["target"], slo_feed=lambda v, w: None,
                                    start_worker=False)
    # the oracle is the same f64 host code on both sides: the CPU engine
    # reuses the card engine's oracles, whose per-source route memo changes
    # no result; the production edges are each side's own
    ref._oracles = eng._oracles
    build_s = time.perf_counter() - t0
    sampled = traces[3::4]
    t0 = time.perf_counter()
    for tr in sampled:
        q = cpu.match_many([tr])[0]["_quality"]
        ref.compare(tr, q["edge"])
    cpu_s = time.perf_counter() - t0
    want = ref.report()
    check(card["samples_compared"] == len(sampled) and card["cohorts"] == want["cohorts"]
          and card["overall"] == want["overall"],
          "20.3 the card's agreement per cohort equals the port on the CPU: %s against %s"
          % (json.dumps(card["cohorts"]), json.dumps(want["cohorts"])))
    print("20.3 quality: %d of %d /report sampled, agreement %s, cohorts %s; equal to the "
          "port on the CPU (served and drained %.1f s; the CPU matcher built in %.1f s, "
          "its %d matches and compares %.1f s)" % (
              card["samples_compared"], len(traces), card["overall"],
              json.dumps(card["cohorts"]), card_s, build_s, len(sampled), cpu_s))
    return {"overall": card["overall"], "cohorts": card["cohorts"], "wall_s": card_s,
            "cpu_build_s": build_s, "cpu_s": cpu_s}


def obs_scopes(sv, t64, pairs=8, n_ranges=20000):
    """20.4: match_many over the 512 x 64 cohort with the stage ranges off
    and on (``attrib.set_scopes``; REPORTER_STAGE_SCOPES is read at
    import), each warmed once, then ``pairs`` rounds of off, on, on, off:
    bit-identical answers; each side's median wall and quartiles.  The
    ranges' own cost: ``n_ranges`` enters and exits of a launch's range
    timed on the host with the ranges on and off, times the ranges one
    call opens (one a launch on the card), over the median wall."""
    import statistics

    from reporter_tpu_torch.obs import attrib
    from reporter_tpu_torch.ops import _kernels

    rows = t64[:512]
    outs, walls = {}, {False: [], True: []}
    per_range = {}
    prev = attrib.scopes_enabled()
    try:
        for on in (False, True):
            attrib.set_scopes(on)
            outs[on] = json.dumps(sv.match_many(rows), sort_keys=True)
        n0 = sum(k.launches for k in _kernels.KERNELS.values())
        sv.match_many(rows)
        ranges = sum(k.launches for k in _kernels.KERNELS.values()) - n0
        for _ in range(pairs):
            for on in (False, True, True, False):
                attrib.set_scopes(on)
                t0 = time.perf_counter()
                out = sv.match_many(rows)
                walls[on].append(time.perf_counter() - t0)
                check(json.dumps(out, sort_keys=True) == outs[on],
                      "20.4 a repeat's answers equal its first")
        for on in (False, True):
            attrib.set_scopes(on)
            t0 = time.perf_counter()
            for _ in range(n_ranges):
                with attrib.stage("candidate-sweep", "candidate_sweep"):
                    pass
            per_range[on] = (time.perf_counter() - t0) / n_ranges
    finally:
        attrib.set_scopes(prev)
    check(outs[False] == outs[True], "20.4 the answers are bit-identical with the stage "
          "ranges off and on")
    res = {"ranges_per_call": ranges,
           "range_us": {"off": per_range[False] * 1e6, "on": per_range[True] * 1e6}}
    for on, key in ((False, "off"), (True, "on")):
        q = statistics.quantiles(walls[on], n=4, method="inclusive")
        res[key] = {"median_s": statistics.median(walls[on]), "q1_s": q[0], "q3_s": q[2],
                    "min_s": min(walls[on]), "max_s": max(walls[on]), "walls_s": walls[on]}
    res["on_over_off"] = res["on"]["median_s"] / res["off"]["median_s"]
    res["ranges_share"] = (ranges * (per_range[True] - per_range[False])
                           / res["off"]["median_s"])
    print("20.4 match_many 512 x 64, %d walls a side (off, on, on, off x %d): scopes off "
          "median %.4f s (quartiles %.4f, %.4f; %.4f-%.4f), on median %.4f s (quartiles "
          "%.4f, %.4f; %.4f-%.4f), on / off %.4f; answers identical.  A range %.3f us on, "
          "%.3f us off, %d a call: %.6f of the off median" % (
              2 * pairs, pairs, res["off"]["median_s"], res["off"]["q1_s"],
              res["off"]["q3_s"], res["off"]["min_s"], res["off"]["max_s"],
              res["on"]["median_s"], res["on"]["q1_s"], res["on"]["q3_s"],
              res["on"]["min_s"], res["on"]["max_s"], res["on_over_off"],
              res["range_us"]["on"], res["range_us"]["off"], ranges, res["ranges_share"]))
    return res


# -- phase 21: the batched and streaming modes on the card --------------------

SV_21 = ",sv,\\|,0,2,3,1,4"  # uuid|epoch|lat|lon|accuracy
T_ARRIVE_21 = 1_460_000_000_000  # every stream line's arrival stamp (ms)
STREAM_21 = dict(privacy=2, quantisation=3600, source="P21S", report_levels=(0, 1),
                 transition_levels=(0, 1), flush_interval_sec=300, microbatch_size=16)
BATCH_21 = dict(valuer='lambda l: tuple(l.split("|"))', time_pattern=None, microbatch=256,
                inactivity=120, privacy=2, quantisation=3600, report_levels={0, 1},
                transition_levels={0, 1}, source="P21")


def _sv_line(uuid, p, t=None):
    """One ``uuid|epoch|lat|lon|accuracy`` row, lat / lon at float32 (the
    stream's point serde keeps float32, so a restored point is the fed
    one)."""
    import numpy as np

    return "%s|%d|%r|%r|%d" % (uuid, int(round(p["time"])) if t is None else t,
                               float(np.float32(p["lat"])), float(np.float32(p["lon"])),
                               p["accuracy"])


MODES_BATCH_DEPTH = 4  # phase 21's batch archive holds the cohorts' first 1/4


def modes_archive(d, t64, t1024, gap_vehicles=64):
    """The batch archive: both cohorts as SV rows over 4 source files
    (round robin), uuids distinct across the cohorts; vehicles 0 to
    ``gap_vehicles`` - 1 of the 64-point cohort pause 300 s after their
    32nd point, so the 120 s inactivity cuts their drives in two.  Returns
    (rows, windows)."""
    os.makedirs(d, exist_ok=True)
    rows = []
    for tag, cohort in (("c64", t64), ("c1024", t1024)):
        for v, tr in enumerate(cohort):
            for j, p in enumerate(tr["trace"]):
                gap = 300 if tag == "c64" and v < gap_vehicles and j >= 32 else 0
                rows.append(_sv_line("%s-%d" % (tag, v), p, int(round(p["time"])) + gap))
    files = [open(os.path.join(d, "part-%d.sv" % i), "w") for i in range(4)]
    try:
        for i, row in enumerate(rows):
            files[i % 4].write(row + "\n")
    finally:
        for f in files:
            f.close()
    return len(rows), len(t64) + min(gap_vehicles, len(t64)) + len(t1024)


def modes_tiles(*dirs):
    """{tile path: sorted CSV rows} of every tile file under ``dirs`` (file
    names carry a uuid4: only the tile path and the rows compare)."""
    tiles = {}
    for d in dirs:
        for root, _dirs, files in os.walk(d):
            for name in files:
                with open(os.path.join(root, name)) as f:
                    lines = f.read().strip().split("\n")
                check(lines[0].startswith("segment_id,next_segment_id,"),
                      "a tile file opens with the CSV header")
                tiles.setdefault(os.path.relpath(root, d), []).extend(lines[1:])
    return {k: sorted(v) for k, v in tiles.items()}


def _tile_count(tiles):
    return sum(len(v) for v in tiles.values())


def _fam_sum(name):
    from reporter_tpu_torch.obs import metrics as obs

    fam = obs.REGISTRY.snapshot().get(name, {"samples": []})
    return sum(v for _lv, v in fam["samples"])


class _Watched:
    """A matcher client that counts its requests and its None answers."""

    def __init__(self, client):
        self.client, self.requests, self.none = client, 0, 0

    def report_many(self, requests):
        out = self.client.report_many(requests)
        self.requests += len(requests)
        self.none += sum(r is None for r in out)
        return out


def _phase_walls(walls):
    """Time run_pipeline's three phases: the module's phase functions
    wrapped in place (run_pipeline calls them by name); returns the
    restore function."""
    from reporter_tpu_torch.batch import pipeline

    saved = {n: getattr(pipeline, n) for n in ("get_traces", "make_matches", "report_tiles")}

    def wrap(name, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                walls[name] = time.perf_counter() - t0
        return timed
    for n, fn in saved.items():
        setattr(pipeline, n, wrap(n, fn))
    return lambda: [setattr(pipeline, n, fn) for n, fn in saved.items()]


def modes_batch(matcher, cpu, base, d, n_points, n_windows):
    """21.1: ``run_pipeline`` over the archive on the card (phases 1 and 3
    on two spawned workers), through the launch counters; then the same
    pipeline resumed from the card run's shards (phases 2 and 3) on the
    port on the CPU (``cpu``) and on the CPU baseline (``base``), each on
    a thread of its own beside 21.2's CLI process (``side``: 21.2 runs
    while they do).  Returns (figures, the card's tiles, the side runs'
    figures and tiles once joined)."""
    from reporter_tpu_torch.batch import run_pipeline

    kernels = BUCKETED + ("viterbi_chain",)
    fails, wins, requeues = (_fam_sum("reporter_batch_report_failures_total"),
                             _fam_sum("reporter_batch_windows_matched_total"),
                             _fam_sum("reporter_batch_shard_requeues_total"))
    walls = {}
    restore = _phase_walls(walls)
    try:
        (trace_dir, match_dir), dt, launches = _counted(kernels, lambda: run_pipeline(
            matcher, archive_spec=os.path.join(d, "archive"), dest_store="dir:" + os.path.join(
                d, "card"), cleanup=False, concurrency=2, **BATCH_21))
    finally:
        restore()
    d_fail = _fam_sum("reporter_batch_report_failures_total") - fails
    d_win = _fam_sum("reporter_batch_windows_matched_total") - wins
    d_req = _fam_sum("reporter_batch_shard_requeues_total") - requeues
    check(d_fail == 0 and d_win == n_windows and d_req == 0, "21.1 the batch on the card: %d "
          "failures, %d windows matched of %d built, %d work units requeued from dead "
          "workers" % (d_fail, d_win, n_windows, d_req))
    card = modes_tiles(os.path.join(d, "card"))
    check(card, "21.1 the card's batch wrote tiles")
    out = {"wall_s": dt, "points_per_s": n_points / dt, "phase_walls_s": dict(walls),
           "windows": d_win, "tiles": len(card), "rows": _tile_count(card),
           "launches": launches}

    def resumed(name, m):
        t0 = time.perf_counter()
        run_pipeline(m, trace_dir=trace_dir, dest_store="dir:" + os.path.join(d, name),
                     cleanup=False, concurrency=1, **BATCH_21)
        return time.perf_counter() - t0, modes_tiles(os.path.join(d, name))
    side = _Beside({"cpu": lambda: resumed("cpu", cpu),
                    "baseline": lambda: resumed("baseline", base)})

    def joined():
        res = side.join()
        out["cpu_wall_s"], cpu_tiles = res["cpu"]
        out["baseline_wall_s"], base_tiles = res["baseline"]
        check(cpu_tiles == card, "21.1 the card's batch tiles equal, by path and sorted rows, "
              "the same pipeline's on the port on the CPU")
        import collections
        import shutil

        got, base_rows = collections.Counter(), collections.Counter()
        for k, rows in card.items():
            got.update((k, r) for r in rows)
        for k, rows in base_tiles.items():
            base_rows.update((k, r) for r in rows)
        out["baseline_shared_rows"] = sum((got & base_rows).values()) / max(
            1, sum(got.values()))
        shutil.rmtree(trace_dir, ignore_errors=True)
        shutil.rmtree(match_dir, ignore_errors=True)
    return out, card, joined


class _Beside:
    """Callables run each on a thread of their own; ``join`` returns their
    results by name, or raises the first one's exception."""

    def __init__(self, fns):
        self.results, self.errors = {}, []

        def run(name, fn):
            try:
                self.results[name] = fn()
            except BaseException as e:  # noqa: BLE001 - raised again in join
                self.errors.append(e)
        self.threads = [threading.Thread(target=run, args=kv, daemon=True)
                        for kv in fns.items()]
        for t in self.threads:
            t.start()

    def join(self, timeout=900):
        for t in self.threads:
            t.join(timeout)
        check(not any(t.is_alive() for t in self.threads), "the side runs ended")
        if self.errors:
            raise self.errors[0]
        return self.results


def modes_batch_cli(cfg_json, d, device, n_windows, want):
    """21.2: ``python -m reporter_tpu_torch.batch --device ... --warmup
    --metrics`` in a process of its own on the city's ``file`` config:
    exit 0, 21.1's tiles, a metrics line that counts every window."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "reporter_tpu_torch.batch", "--device", device.type,
         "--src", os.path.join(d, "archive"), "--match-config", cfg_json,
         "--src-valuer", BATCH_21["valuer"], "--src-time-pattern", "",
         "--dest", "dir:" + os.path.join(d, "cli"), "--privacy", "2", "--quantisation",
         "3600", "--inactivity", "120", "--microbatch", "256", "--concurrency", "2",
         "--report-levels", "0,1", "--transition-levels", "0,1", "--source-id", "P21",
         "--warmup", "--metrics"], cwd=REPO, capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    check(r.returncode == 0, "21.2 the batch CLI exits 0: %s" % r.stderr[-3000:])
    snap = json.loads(r.stdout.strip().splitlines()[-1])
    total = lambda n: sum(v for _lv, v in snap.get(n, {"samples": []})["samples"])  # noqa: E731
    wins, fails = (total("reporter_batch_windows_matched_total"),
                   total("reporter_batch_report_failures_total"))
    check(wins == n_windows and fails == 0, "21.2 the CLI's --metrics line counts %d windows "
          "(%d failures), want %d" % (wins, fails, n_windows))
    check(modes_tiles(os.path.join(d, "cli")) == want,
          "21.2 the batch CLI's tiles equal 21.1's")
    return {"wall_s": dt, "windows": wins, "warmup_shapes": total("reporter_warmup_shapes_total"),
            "warmup_s": total("reporter_warmup_seconds_total"),
            "dispatches": total("reporter_dispatch_total")}


def _stream_run(client, lines, out, lo=0, hi=None, ckpt_in=None, ckpt_out=None):
    """``lines[lo:hi]`` through ``build_pipeline`` with ``client``, every
    line stamped with one arrival instant (the CLI's clock on a fast stdin)
    and closed at it, or checkpointed to ``ckpt_out`` instead of closed."""
    from reporter_tpu_torch.stream.checkpoint import load_file, save_file
    from reporter_tpu_torch.stream.topology import build_pipeline

    p = build_pipeline(format_config=SV_21, client=client, output=out, **STREAM_21)
    if ckpt_in:
        check(load_file(p, ckpt_in), "21.3 the checkpoint loads")
    for line in lines[lo:hi]:
        p.feed(line, T_ARRIVE_21)
    if ckpt_out:
        save_file(p, ckpt_out)
    else:
        p.close(T_ARRIVE_21)
    check(p.dropped == 0, "21.3 every line formatted")
    return p


def modes_stream(matcher, cpu, t64, d):
    """21.3: the 64-point cohort as SV lines in time order through the
    stream topology: ``LocalMatcherClient`` on the card (through the launch
    counters) and on the port on the CPU; ``HttpMatcherClient`` against a
    ReporterService on the card matcher's own HTTP server; the stream CLI
    fed the lines on stdin against it; a checkpoint after half of the
    lines restored into a fresh pipeline fed the rest.  Every run's tiles
    equal the card's."""
    from reporter_tpu_torch.stream.client import HttpMatcherClient, LocalMatcherClient
    from reporter_tpu_torch.utils.httppool import POOL

    rows = sorted((int(round(p["time"])), v, _sv_line("s64-%d" % v, p))
                  for v, tr in enumerate(t64) for p in tr["trace"])
    lines = [r[2] for r in rows]
    out = {"lines": len(lines)}
    runs = {}

    def timed(name, fn, dirs=None):
        t0 = time.perf_counter()
        res = fn()
        dt = time.perf_counter() - t0
        out[name] = {"wall_s": dt, "points_per_s": len(lines) / dt}
        runs[name] = modes_tiles(*(dirs or [os.path.join(d, name)]))
        return res
    local = _Watched(LocalMatcherClient(matcher, threshold_sec=15))
    _p, _dt, launches = timed("local", lambda: _counted(
        BUCKETED, lambda: _stream_run(local, lines, os.path.join(d, "local"))))
    check(local.none == 0 and local.requests > 0, "21.3 the card answered all %d requests "
          "(%d None)" % (local.requests, local.none))
    want = runs["local"]
    check(want, "21.3 the card's stream wrote tiles")
    out["local"].update(requests=local.requests, tiles=len(want), rows=_tile_count(want),
                        launches=launches)
    on_cpu = _Watched(LocalMatcherClient(cpu, threshold_sec=15))
    timed("cpu", lambda: _stream_run(on_cpu, lines, os.path.join(d, "cpu")))
    check(on_cpu.none == 0, "21.3 the port on the CPU answered every request")
    served = _Served(matcher, max_batch=64, max_wait_ms=2)
    url = "http://127.0.0.1:%d/report" % served.port
    try:
        http = _Watched(HttpMatcherClient(url))
        _p, _dt, out["http_launches"] = timed("http", lambda: _counted(
            BUCKETED, lambda: _stream_run(http, lines, os.path.join(d, "http"))))
        check(http.none == 0, "21.3 the server answered every request (%d None)" % http.none)

        def cli():
            r = subprocess.run(
                [sys.executable, "-m", "reporter_tpu_torch.stream", "--format", SV_21,
                 "--reporter-url", url, "--privacy", "2", "--quantisation", "3600",
                 "--flush-interval", "300", "--source", STREAM_21["source"], "--output",
                 os.path.join(d, "cli"), "--reports", "0,1", "--transitions", "0,1",
                 "--microbatch", "16"], cwd=REPO, input="\n".join(lines) + "\n",
                capture_output=True, text=True, timeout=300)
            check(r.returncode == 0, "21.3 the stream CLI exits 0: %s" % r.stderr[-3000:])
        _r, _dt, out["cli_launches"] = timed("cli", lambda: _counted(BUCKETED, cli))
    finally:
        served.close()
        POOL.close()
    ck = os.path.join(d, "half.ckpt")
    half = len(lines) // 2
    first = _Watched(LocalMatcherClient(matcher, threshold_sec=15))
    second = _Watched(LocalMatcherClient(matcher, threshold_sec=15))

    def restart():
        _stream_run(first, lines, os.path.join(d, "restart", "a"), hi=half, ckpt_out=ck)
        _stream_run(second, lines, os.path.join(d, "restart", "b"), lo=half, ckpt_in=ck)
    timed("restart", restart, [os.path.join(d, "restart", n) for n in "ab"])
    check(first.none == second.none == 0, "21.3 the restarted run answered every request")
    for name in ("cpu", "http", "cli", "restart"):
        check(runs[name] == want, "21.3 the %s run's tiles equal the card's local run's"
              % name)
    out["checkpoint_bytes"] = os.path.getsize(ck)
    return out


def modes_phase(matcher, t64, t1024, cfg_json, device, card="", gap_vehicles=64):
    """Phase 21: the batched and streaming modes on the city (phase 17's
    matcher, its 64- and 1,024-point cohorts): 21.1 the batch pipeline in
    process (``modes_batch``), 21.2 its CLI in a process of its own
    (``modes_batch_cli``), 21.3 the stream topology with its clients, CLI
    and checkpoint (``modes_stream``).  The CPU side is the port on the CPU
    over the same arrays, table and config."""
    import shutil

    from reporter_tpu_torch.matching import SegmentMatcher

    t0 = time.perf_counter()
    d = os.path.join(REPO, "build", "modes")
    shutil.rmtree(d, ignore_errors=True)
    # the batch archive at a quarter of the cohorts' depth (the run's time:
    # the three batch runs beside the CLI are phase 21's longest path)
    half = MODES_BATCH_DEPTH
    n_points, n_windows = modes_archive(os.path.join(d, "archive"), t64[:len(t64) // half],
                                        t1024[:len(t1024) // half], gap_vehicles // half)
    cpu = SegmentMatcher(arrays=matcher.arrays, ubodt=matcher.ubodt, config=matcher.cfg,
                         device="cpu")
    base = SegmentMatcher(arrays=matcher.arrays, ubodt=matcher.ubodt, config=matcher.cfg,
                          backend="cpu")
    batch, tiles, joined = modes_batch(matcher, cpu, base, d, n_points, n_windows)
    try:
        cli = modes_batch_cli(cfg_json, d, device, n_windows, tiles)
    finally:
        joined()
    stream = modes_stream(matcher, cpu, t64, os.path.join(d, "stream"))
    info = {"points": n_points, "windows": n_windows, "batch": batch, "batch_cli": cli,
            "stream": stream, "wall_s": time.perf_counter() - t0}
    print("21.1 batch (%s): %d windows (%d points) matched on the card, 0 failures, in %.2f s "
          "(%.0f points/s; gather %.2f s, match %.2f s, report %.2f s), %d tiles / %d rows "
          "equal to the port on the CPU (%.2f s); the CPU baseline (%.2f s) shares %.4f of "
          "the card's rows (both resumed from the card run's shards, on threads beside "
          "21.2); launches %s" % (
              card, batch["windows"], n_points, batch["wall_s"], batch["points_per_s"],
              batch["phase_walls_s"].get("get_traces", 0.0),
              batch["phase_walls_s"].get("make_matches", 0.0),
              batch["phase_walls_s"].get("report_tiles", 0.0), batch["tiles"], batch["rows"],
              batch["cpu_wall_s"], batch["baseline_wall_s"], batch["baseline_shared_rows"],
              json.dumps(batch["launches"])))
    print("21.2 batch CLI (%s): exit 0 in %.1f s, %.0f points/s (its own process: the city's "
          "table built, warmup %d shapes in %.2f s), %d windows, tiles equal to 21.1's" % (
              card, cli["wall_s"], n_points / cli["wall_s"], cli["warmup_shapes"],
              cli["warmup_s"], cli["windows"]))
    print("21.3 stream (%s): %d lines; %s; tiles equal to the card's local run; local "
          "launches %s" % (card, stream["lines"], "; ".join(
              "%s %.2f s (%.0f points/s)" % (k, stream[k]["wall_s"], stream[k]["points_per_s"])
              for k in ("local", "cpu", "http", "cli", "restart")),
              json.dumps(stream["local"]["launches"])))
    print("phase 21 modes (%s): %.1f s" % (card, info["wall_s"]))
    shutil.rmtree(d, ignore_errors=True)
    return info, {"batch": batch.pop("launches"),
                  "stream": stream["local"].pop("launches"),
                  "stream_http": stream.pop("http_launches"),
                  "stream_cli": stream.pop("cli_launches")}


# -- phase 22: the serving fleet on the card -----------------------------------

FLEET_STREAM = 128  # streaming vehicles of phase 22
FLEET_KERNELS = BUCKETED + ("viterbi_chain",)  # kernels 1-4 and 5


def _free_ports(n):
    """(base, router): ``n`` consecutive free ports from ``base`` and one
    more free port for the router (bound and released, so a race with
    another process is possible but harmless here: nothing else binds)."""
    import socket

    def free(p=0):
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", p))
            return s.getsockname()[1]
        except OSError:
            return None
        finally:
            s.close()
    while True:
        base = free()
        if base and base + n < 65536 and all(free(base + i) for i in range(1, n)):
            return base, free()


def _http(url, body=None, headers=None, timeout=120):
    """(status, headers, body bytes) of a GET (``body`` None) or POST; a
    transport error raises."""
    import urllib.error

    data = body if body is None or isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers=dict(
        headers or ({"Content-Type": "application/json"} if data is not None else {})))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _jget(url, timeout=30):
    code, _h, raw = _http(url, timeout=timeout)
    return code, json.loads(raw)


def _pool(fn, items, workers=32):
    """fn(item) for every item on ``workers`` threads; the answers in order."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(workers) as ex:
        return list(ex.map(fn, items))


def _until(cond, what, timeout=300.0, step=0.1):
    """Poll ``cond`` until it answers truthy; its answer and the seconds it
    took.  A timeout fails the run."""
    t0 = time.perf_counter()
    while True:
        got = cond()
        if got:
            return got, time.perf_counter() - t0
        check(time.perf_counter() - t0 < timeout, "%s within %.0f s" % (what, timeout))
        time.sleep(step)


class _Load:
    """Windowed /report requests through the router on ``threads`` threads
    until ``stop``: every answer counted by status (a 429 is a shed; any
    other non-200, or a transport error, is an error)."""

    def __init__(self, url, traces, threads=4):
        self.codes, self.errors = {}, []
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._url, self._traces = url, traces
        self._threads = [threading.Thread(target=self._run, args=(i, threads), daemon=True)
                         for i in range(threads)]
        for t in self._threads:
            t.start()

    def _run(self, i, n):
        k = i
        while not self._stop.is_set():
            tr = self._traces[k % len(self._traces)]
            k += n
            try:
                code = _http(self._url + "/report", tr, timeout=60)[0]
            except Exception as e:  # noqa: BLE001 - a transport error is counted
                code = "error"
                with self._lock:
                    self.errors.append(str(e)[:200])
            with self._lock:
                self.codes[code] = self.codes.get(code, 0) + 1

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(120)
        bad = {c: n for c, n in self.codes.items() if c not in (200, 429)}
        return {"answers": sum(self.codes.values()), "shed": self.codes.get(429, 0),
                "errors": sum(bad.values()), "codes": {str(c): n for c, n in self.codes.items()},
                "transport": self.errors[:3]}


class _Fleet22:
    """``python -m reporter_tpu_torch.tools.fleet`` in a process of its own
    and what phase 22 reads of it: the router's surfaces, fleet.json, the
    scale events and the supervisor's log."""

    def __init__(self, cfg_json, device, d):
        base, rport = _free_ports(3)
        self.wd = os.path.join(d, "wd")
        self.url = "http://127.0.0.1:%d" % rport
        argv = [sys.executable, "-m", "reporter_tpu_torch.tools.fleet", "--config", cfg_json,
                "--replicas", "2", "--base-port", str(base), "--router-port", str(rport),
                "--workdir", self.wd, "--warmup", "--session-checkpoint", "0.5",
                "--session-checkpoint-sync", "--device", device.type,
                "--federate-every", "1", "--up-timeout", "300"]
        env = dict(os.environ, REPORTER_ROUTER_PROBE_S="0.25", REPORTER_FEDERATION_PULL_S="0.5")
        self.log_path = os.path.join(d, "supervisor.log")
        self.t0 = time.perf_counter()
        with open(self.log_path, "wb") as log:
            self.proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=log,
                                         stderr=subprocess.STDOUT)

    def state(self):
        try:
            with open(os.path.join(self.wd, "fleet.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def replicas(self):
        """rid -> (url, pid, restarts) from fleet.json."""
        st = self.state() or {"replicas": []}
        return {r["id"]: (r["url"], r["pid"], r["restarts"]) for r in st["replicas"]}

    def events(self):
        try:
            with open(os.path.join(self.wd, "scale_events.jsonl")) as f:
                return [json.loads(line) for line in f if line.strip()]
        except OSError:
            return []

    def log(self):
        with open(self.log_path, errors="replace") as f:
            return f.read()

    def fleet(self):
        """rid (or url) -> the router's view of the replica."""
        try:
            code, body = _jget(self.url + "/fleet", timeout=10)
        except Exception:  # noqa: BLE001 - the router is booting
            return {}
        return {(r["id"] or r["url"]): r for r in body["replicas"]} if code == 200 else {}

    def healthy(self, rids):
        """Every replica in ``rids`` attached, warmed and in the router's ring."""
        view = self.fleet()
        if set(view) != set(rids) or not all(view[r]["state"] == "healthy" for r in rids):
            return False
        for rid, (url, _pid, _n) in self.replicas().items():
            try:
                code, h = _jget(url + "/health", timeout=5)
            except Exception:  # noqa: BLE001
                return False
            if code != 200 or h.get("warming") or not h.get("backend"):
                return False
        return True

    def metrics(self):
        return _prom(_http(self.url + "/metrics?pull=1")[2].decode())[1]

    def launches(self):
        """rid -> {kernel: launches} from the federated /metrics."""
        out = {}
        for (name, labels), v in self.metrics().items():
            if name == "reporter_kernel_launches_total":
                lab = dict(labels)
                if "replica" in lab:
                    out.setdefault(lab["replica"], {})[lab["kernel"]] = v
        return out

    def sessions(self):
        return _jget(self.url + "/sessions")[1]

    def settled(self, vehicles, rids, points):
        """The router's /sessions holds ``points`` points, and each replica
        of ``rids`` exactly the vehicles whose rendezvous primary it is
        (a handoff or rebalance has finished moving them)."""
        from reporter_tpu_torch.serve.router import rendezvous_score

        urls = {r: v[0] for r, v in self.replicas().items()}
        if set(urls) != set(rids):
            return False
        want = {r: 0 for r in rids}
        for u in vehicles:
            want[max(rids, key=lambda r: rendezvous_score(u, urls[r]))] += 1
        fs = self.sessions()
        got = {r: (fs["replicas"].get(r) or {}).get("sessions") for r in rids}
        return fs["points_total"] == points and got == want

    def check_replicas(self, device, what):
        """No replica degraded, none off the card (its /health)."""
        for rid, (url, _pid, _n) in self.replicas().items():
            code, h = _jget(url + "/health", timeout=10)
            check(code == 200 and h["degraded"] is False, "phase 22 %s: %s not degraded: %s"
                  % (what, rid, json.dumps(h)[:300]))
            check(str(h["device"]).startswith(device.type), "phase 22 %s: %s on %s, not %s"
                  % (what, rid, h["device"], device.type))

    def close(self):
        """Stop every process the supervisor started, whatever state it is in."""
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        st = self.state() or {"replicas": [], "router": {}}
        for pid in [r["pid"] for r in st["replicas"]] + [st["router"].get("pid")]:
            if pid:
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass


def _strip_session(body):
    """A streaming answer without the session block's per-process fields."""
    body = _no_age(json.loads(body) if isinstance(body, bytes) else body)
    if isinstance(body.get("session"), dict):
        body["session"].pop("imported", None)
    return body


def _first_diff(a, b, path=""):
    """Where two JSON values first differ (for a failed check's message)."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b)):
            if a.get(k) != b.get(k):
                return _first_diff(a.get(k), b.get(k), path + "/" + str(k))
    elif isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return _first_diff(x, y, "%s[%d]" % (path, i))
    return "%s: %s != %s" % (path, json.dumps(a)[:200], json.dumps(b)[:200])


def _launch_delta(before, after, rids, kernels, device, what):
    """Each replica's launches of ``kernels`` between two reads of the
    federated /metrics; on the card each must be above 0."""
    out = {r: {k: after.get(r, {}).get(k, 0) - before.get(r, {}).get(k, 0) for k in kernels}
           for r in rids}
    if device.type == "cuda":
        check(all(v > 0 for r in rids for v in out[r].values()),
              "phase 22 %s: kernels 1-5 launched on every replica that served: %s"
              % (what, json.dumps(out)))
    return out


def fleet_phase(cfg_json, second, t64, t256, t1024, device, card=""):
    """Phase 22: the serving fleet on the card: the supervisor
    (``python -m reporter_tpu_torch.tools.fleet --replicas 2 --warmup
    --session-checkpoint 0.5 --session-checkpoint-sync --device ...``) on
    phase 18's tiles config, the router in front; 22.1 the 512 x 64
    cohort as /report and one binary /trace_attributes_batch through the
    router, equal to ``second`` behind a ReporterService in this process;
    22.2 streaming vehicles; 22.3 SIGKILL of the replica holding the most
    sessions under load, the checkpoint re-home and the respawn; 22.4
    SIGUSR1's rolling restart under load; 22.5 a scale-up (SIGTTIN) held
    out of the ring until attached, then a scale-down (SIGTTOU); 22.6
    SIGTERM.  Returns the figures."""
    import shutil
    import signal

    from reporter_tpu_torch.serve import wire
    from reporter_tpu_torch.serve.router import rendezvous_score

    t_phase = time.perf_counter()
    d = os.path.join(REPO, "build", "fleet")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    ref = _Served(second)  # the same requests, uninterrupted, in this process
    fleet = _Fleet22(cfg_json, device, d)
    info = {}
    try:
        # -- boot: both replicas attached and warmed, in the router's ring --
        seen_at = {}

        def up():
            for rid, (url, _pid, _n) in fleet.replicas().items():
                if rid not in seen_at:
                    try:
                        code, h = _jget(url + "/health", timeout=2)
                        if code == 200 and h.get("backend") and not h.get("warming"):
                            seen_at[rid] = time.perf_counter() - fleet.t0
                    except Exception:  # noqa: BLE001 - still booting
                        pass
            return fleet.healthy(["rep-0", "rep-1"])
        _until(up, "the fleet up", timeout=400, step=0.1)
        rids = ["rep-0", "rep-1"]
        m0 = fleet.metrics()
        info["boot_to_healthy_s"] = seen_at
        info["warm_s"] = {r: _sample_sum(m0, "reporter_warmup_seconds_total", replica=r)
                          for r in rids}
        info["device_bytes"] = {r: {s: _sample_sum(m0, "reporter_device_memory_bytes",
                                                   replica=r, space="device", subsystem=s)
                                    for s in ("in_use", "reserved", "limit")} for r in rids}
        fleet.check_replicas(device, "boot")
        l0 = fleet.launches()
        urls = {r: v[0] for r, v in fleet.replicas().items()}

        # -- 22.1 windowed /report and one binary batch through the router --
        t0 = time.perf_counter()
        got = _pool(lambda tr: _http(fleet.url + "/report", tr), t64)
        report_s = time.perf_counter() - t0
        want = _pool(lambda tr: ref.post("/report", tr), t64)
        by_uuid = {}
        for tr, (code, hdrs, raw), (wcode, _wh, wbody) in zip(t64, got, want):
            check(code == wcode == 200 and json.loads(raw) == wbody,
                  "22.1 /report %s through the router equals the in-process service's"
                  % tr["uuid"])
            by_uuid[tr["uuid"]] = hdrs.get("X-Reporter-Replica")
        primary = {u: max(rids, key=lambda r: rendezvous_score(u, urls[r])) for u in by_uuid}
        check(by_uuid == primary, "22.1 every uuid on its rendezvous primary")
        check(set(by_uuid.values()) == set(rids), "22.1 both replicas took traffic: %s"
              % json.dumps({r: list(by_uuid.values()).count(r) for r in rids}))
        again = _pool(lambda tr: _http(fleet.url + "/report", tr)[1].get("X-Reporter-Replica"),
                      t64[:64])
        check(again == [by_uuid[tr["uuid"]] for tr in t64[:64]],
              "22.1 X-Reporter-Replica stable per uuid")
        batch = {"traces": t64[:64] + t256[:8] + t1024[:1]}
        frame = wire.encode_request(json.loads(json.dumps(batch)))
        bin_h = {"Content-Type": wire.CONTENT_TYPE, "Accept": wire.CONTENT_TYPE}
        t0 = time.perf_counter()
        code, hdrs, raw = _http(fleet.url + "/trace_attributes_batch", frame, bin_h)
        batch_s = time.perf_counter() - t0
        rcode, _rh, rraw = ref.post("/trace_attributes_batch", frame, bin_h)
        check(code == rcode == 200 and raw == rraw and wire.is_wire(hdrs.get("Content-Type")),
              "22.1 the binary batch of %d traces through the router equals the in-process "
              "service's frame byte for byte" % len(batch["traces"]))
        check(hdrs.get("X-Reporter-Replica") == primary.get(t64[0]["uuid"]),
              "22.1 the batch routes by its first trace's uuid")

        # router-added wall: the same request through the router and direct
        walls = {"router": [], "direct": []}
        for tr in t64[:64]:
            for how, base in (("router", fleet.url), ("direct", urls[by_uuid[tr["uuid"]]])):
                t0 = time.perf_counter()
                check(_http(base + "/report", tr)[0] == 200, "22.1 a timed /report")
                walls[how].append(time.perf_counter() - t0)
        info["walls_s"] = {k: {"median": statistics.median(v),
                               "quartiles": statistics.quantiles(v, n=4),
                               "min": min(v), "max": max(v)} for k, v in walls.items()}

        # -- 22.2 streaming vehicles through the router ---------------------
        vehicles = [("f22-%03d" % i, tr) for i, tr in enumerate(t64[:FLEET_STREAM])]
        home, answered = {}, [0]

        def submit(j):
            subs = [_stream_sub(tr, u, 4 * j) for u, tr in vehicles]
            got = _pool(lambda s: _http(fleet.url + "/report", s), subs)
            want = _pool(lambda s: ref.post("/report", s), subs)
            for (u, _tr), (code, hdrs, raw), (wcode, _wh, wbody) in zip(vehicles, got, want):
                a, b = _strip_session(raw), _strip_session(wbody)
                check(code == wcode == 200 and a == b,
                      "22 submit %d of %s through the router equals the uninterrupted "
                      "in-process session's: %s %s %s" % (j + 1, u, code, wcode,
                                                          _first_diff(a, b)))
            answered[0] += 4 * len(vehicles)
            return {u: h.get("X-Reporter-Replica") for (u, _t), (_c, h, _r) in zip(vehicles, got)}
        t0 = time.perf_counter()
        for j in range(4):
            at = submit(j)
            for u, r in at.items():
                check(home.setdefault(u, r) == r, "22.2 a vehicle stays on its replica")
        stream_s = time.perf_counter() - t0
        fs = fleet.sessions()
        check(fs["points_total"] == answered[0] and fs["sessions"] == len(vehicles),
              "22.2 the router's /sessions counts %d sessions, %d points: %s"
              % (len(vehicles), answered[0], json.dumps(fs)[:300]))
        info["launches_served"] = _launch_delta(l0, fleet.launches(), rids, FLEET_KERNELS,
                                                device, "22.1-22.2")
        info["report"] = {"requests": len(t64), "wall_s": report_s, "batch_wall_s": batch_s,
                          "stream_wall_s": stream_s,
                          "by_replica": {r: list(by_uuid.values()).count(r) for r in rids}}

        # -- 22.3 SIGKILL under load: failover, re-home, respawn ------------
        per = {r: (fs["replicas"].get(r) or {}).get("sessions") or 0 for r in rids}
        victim = max(rids, key=lambda r: per[r])
        moved = [u for u, r in home.items() if r == victim]
        load = _Load(fleet.url, t64[-128:])
        _until(lambda: load.codes.get(200, 0) >= 8, "the load running", 60, 0.05)
        t_kill, t_kill_unix = time.perf_counter(), time.time()
        os.kill(fleet.replicas()[victim][1], signal.SIGKILL)
        _v, failover_s = _until(lambda: fleet.fleet().get(victim, {}).get("state")
                                not in ("healthy", None), "22.3 the router sees the death",
                                60, 0.02)
        ev, _dt = _until(lambda: [e for e in fleet.events() if e.get("event") == "rehome"
                                  and e.get("replica") == victim], "22.3 the re-home", 60, 0.05)
        rehome_s = ev[0]["t_unix"] - t_kill_unix
        check(ev[0]["rehomed"] == len(moved) and ev[0]["no_target"] == 0,
              "22.3 the supervisor re-homed the victim's %d sessions: %s"
              % (len(moved), json.dumps(ev[0])))
        _until(lambda: fleet.sessions()["points_total"] == answered[0],
               "22.3 the router's /sessions back to %d points" % answered[0], 60, 0.05)
        converge_s = time.perf_counter() - t_kill
        at = submit(4)  # each re-homed vehicle's next answer
        check(all(at[u] != victim for u in moved), "22.3 the re-homed vehicles answered by "
              "the survivor")
        restarts = {r: v[2] for r, v in fleet.replicas().items()}
        check(restarts == {victim: 1, **{r: 0 for r in rids if r != victim}},
              "22.3 one respawn, the victim's: %s" % restarts)
        _until(lambda: fleet.healthy(rids), "22.3 the respawned replica back", 400, 0.1)
        respawn_s = time.perf_counter() - t_kill
        killed = load.stop()
        check(killed["errors"] == 0, "22.3 no client error but a shed under the SIGKILL: %s"
              % json.dumps(killed))
        uuids = [u for u, _tr in vehicles]
        _until(lambda: fleet.settled(uuids, rids, answered[0]),
               "22.3 the rebalance settled, /sessions exact", 60, 0.05)
        at = submit(5)
        check(all(at[u] == home[u] for u in moved), "22.3 the rebalance brought every "
              "re-homed vehicle back to the respawned replica")
        fleet.check_replicas(device, "after the SIGKILL")
        info["kill"] = {"victim": victim, "sessions": len(moved), "failover_s": failover_s,
                        "rehome_s": rehome_s, "sessions_exact_s": converge_s,
                        "respawn_s": respawn_s, "load": killed}

        # -- 22.4 the rolling restart under load ----------------------------
        load = _Load(fleet.url, t64[-128:])
        _until(lambda: load.codes.get(200, 0) >= 8, "the load running", 60, 0.05)
        t_roll = time.perf_counter()
        os.kill(fleet.proc.pid, signal.SIGUSR1)
        _until(lambda: "rolling restart complete" in fleet.log()
               or "rolling restart FAILED" in fleet.log(), "22.4 the rolling restart", 600, 0.2)
        check("rolling restart FAILED" not in fleet.log(), "22.4 the rolling restart")
        _until(lambda: fleet.healthy(rids), "22.4 the fleet healthy", 120, 0.1)
        rolling_s = time.perf_counter() - t_roll
        rolled = load.stop()
        check(rolled["errors"] == 0, "22.4 zero non-shed errors through the rolling restart: %s"
              % json.dumps(rolled))
        restarts = {r: v[2] for r, v in fleet.replicas().items()}
        check(restarts == {victim: 2, **{r: 1 for r in rids if r != victim}},
              "22.4 one restart each, no respawn unasked: %s" % restarts)
        _until(lambda: fleet.settled(uuids, rids, answered[0]),
               "22.4 the handoffs settled, /sessions exact", 60, 0.05)
        l1 = fleet.launches()
        _pool(lambda tr: check(_http(fleet.url + "/report", tr)[0] == 200, "22.4 /report"),
              t64[:64])
        submit(6)
        info["launches_after_restart"] = _launch_delta(l1, fleet.launches(), rids,
                                                       FLEET_KERNELS, device, "22.4")
        fleet.check_replicas(device, "after the rolling restart")
        info["rolling"] = {"wall_s": rolling_s, "load": rolled}

        # -- 22.5 scale up (held out until attached), then down -------------
        t_up = time.perf_counter()
        os.kill(fleet.proc.pid, signal.SIGTTIN)
        (new,), _dt = _until(lambda: [r for r in fleet.replicas() if r not in rids],
                             "22.5 the scale-up spawned", 30, 0.05)
        held = []

        def admitted():
            url = fleet.replicas()[new][0]
            try:
                code, h = _jget(url + "/health", timeout=2)
            except Exception:  # noqa: BLE001 - not bound yet
                return False
            view = fleet.fleet().get(new) or fleet.fleet().get(url) or {}
            if not h.get("backend"):
                held.append(not view.get("available"))
            return any(e.get("event") == "admitted" and e.get("replica") == new
                       for e in fleet.events())
        _until(admitted, "22.5 the scale-up admitted", 400, 0.05)
        scale_up_s = time.perf_counter() - t_up
        check(held and all(held), "22.5 the warming replica held out of the ring "
              "(%d reads before attach, %d routable)" % (len(held), held.count(False)))
        _until(lambda: fleet.healthy(rids + [new]), "22.5 three replicas healthy", 60, 0.1)
        urls = {r: v[0] for r, v in fleet.replicas().items()}
        _until(lambda: fleet.settled(uuids, rids + [new], answered[0]),
               "22.5 the rebalance settled, /sessions exact", 60, 0.05)
        l2 = fleet.launches()
        got = _pool(lambda tr: _http(fleet.url + "/report", tr), t64[:128])
        check(all(c == 200 for c, _h, _r in got), "22.5 /report with three replicas")
        at = submit(7)
        info["launches_scaled"] = _launch_delta(l2, fleet.launches(), [new], FLEET_KERNELS,
                                                device, "22.5")
        check(new in at.values(), "22.5 the added replica took streaming vehicles")
        fleet.check_replicas(device, "scaled up")
        t_down = time.perf_counter()
        os.kill(fleet.proc.pid, signal.SIGTTOU)
        ev, _dt = _until(lambda: [e for e in fleet.events() if e.get("event") == "removed"
                                  and e.get("replica") == new], "22.5 the scale-down", 120, 0.05)
        scale_down_s = time.perf_counter() - t_down
        check(ev[0]["exit_rc"] == 0 and set(fleet.replicas()) == set(rids),
              "22.5 the scale-down drained %s, exit 0" % new)
        _until(lambda: fleet.settled(uuids, rids, answered[0]),
               "22.5 the drain's handoff settled, /sessions exact", 60, 0.05)
        submit(8)
        info["scale"] = {"replica": new, "up_s": scale_up_s, "down_s": scale_down_s,
                         "held_reads": len(held)}

        # -- 22.6 SIGTERM: every child exits 0 -------------------------------
        pids = [v[1] for v in fleet.replicas().values()] + [fleet.state()["router"]["pid"]]
        t_term = time.perf_counter()
        fleet.proc.send_signal(signal.SIGTERM)
        rc = fleet.proc.wait(180)
        check(rc == 0, "22.6 the supervisor and every child exit 0 on SIGTERM: %s"
              % fleet.log()[-2000:])

        def gone(pid):
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                return True
            except OSError:
                return False
            return False
        check(all(gone(p) for p in pids), "22.6 no child left")
        info["sigterm_s"] = time.perf_counter() - t_term
        info["stream"] = {"vehicles": len(vehicles), "points": answered[0]}
    finally:
        fleet.close()
        ref.close()
    info["wall_s"] = time.perf_counter() - t_phase
    ks = info["kill"]
    print("phase 22 fleet (%s): 2 replicas --warmup on the tiles config; boot to healthy %s s, "
          "warm %s s; device bytes in use %s" % (
              card, json.dumps({r: round(v, 2) for r, v in info["boot_to_healthy_s"].items()}),
              json.dumps({r: round(v, 2) for r, v in info["warm_s"].items()}),
              json.dumps({r: int(v["in_use"]) for r, v in info["device_bytes"].items()})))
    w = info["walls_s"]
    print("22.1 %d /report through the router in %.2f s (32 threads), equal to the in-process "
          "service, %s; the 73-trace binary batch %.3f s, its frame equal byte for byte; "
          "/report wall router %.4f s (quartiles %s, %.4f-%.4f), direct %.4f s (quartiles %s, "
          "%.4f-%.4f)" % (
              info["report"]["requests"], info["report"]["wall_s"],
              json.dumps(info["report"]["by_replica"]), info["report"]["batch_wall_s"],
              w["router"]["median"], ", ".join("%.4f" % q for q in w["router"]["quartiles"]),
              w["router"]["min"], w["router"]["max"], w["direct"]["median"],
              ", ".join("%.4f" % q for q in w["direct"]["quartiles"]), w["direct"]["min"],
              w["direct"]["max"]))
    print("22.2-22.3 %d vehicles x 9 submits of 4, every answer equal to the uninterrupted "
          "in-process session's; SIGKILL %s (%d sessions) under load: the router saw it in "
          "%.2f s, the re-home at %.2f s, /sessions exact at %.2f s, the respawn healthy at "
          "%.1f s; load %s" % (
              FLEET_STREAM, ks["victim"], ks["sessions"], ks["failover_s"], ks["rehome_s"],
              ks["sessions_exact_s"], ks["respawn_s"], json.dumps(ks["load"]["codes"])))
    print("22.4 rolling restart %.1f s, load %s; 22.5 scale-up admitted in %.1f s (held out "
          "for %d reads), scale-down %.1f s; 22.6 SIGTERM: every child exit 0 in %.1f s; "
          "launches on the replicas %s; phase 22 %.1f s" % (
              info["rolling"]["wall_s"], json.dumps(info["rolling"]["load"]["codes"]),
              info["scale"]["up_s"], info["scale"]["held_reads"], info["scale"]["down_s"],
              info["sigterm_s"], json.dumps(info["launches_served"]), info["wall_s"]))
    return info


MESH_TIER_GP = (2, 4)  # gp ranks of phase 23's tiered checks


def _rank_delta(rank, fn):
    """(fn(), (the fetch counts [n], [hits, misses]) the call added to one
    gp rank of a tiered table)."""
    import torch

    torch.cuda.synchronize(rank.dev)
    c0, t0 = rank.counts.clone(), rank.totals.clone()
    out = fn()
    torch.cuda.synchronize(rank.dev)
    return out, ((rank.counts - c0).cpu(), (rank.totals - t0).cpu().tolist())


def mesh_tier_kernels(matcher, ubodt_w, du_w, xin, link, timed):
    """Kernel 2's ``[tiered,sharded]`` and ``[wide32,tiered,sharded]``
    instantiations (row 10 x 11a): for each layout, at gp 2 and 4, at a
    1-byte budget a rank (every row cold), 64 MiB a rank as seeded (the
    prefix of each rank's range: hot and cold rows mixed) and after one
    maintenance pass on the cohort's own probes (a rank's capacity holds
    its range's probed rows: every fetch hot), and each rank's whole
    range (every row hot), on the 512 x 64 cohort's keys: each rank's
    kernel equals its plain version bit for bit with equal per-rank fetch
    counts and hit/miss totals, each rank counts exactly the fetches of
    its own range (the bincount of the keys' home buckets), the ranks'
    totals sum to the untiered count of rows read, and the ranks' pmin /
    pmax equals the untiered kernel 2 bit for bit.  The pages are
    registered with CUDA once for all ranks: one registered buffer holds
    them, each rank's first page is page-locked host memory (type 1).
    Times rank 0 of gp 4 at 64 MiB, seeded and after the pass, beside its
    plain version and bound: the rank's hot side over HBM's peak plus its
    distinct cold rows over the host link's peak."""
    import torch

    from reporter_tpu_torch.ops import _kernels, collectives
    from reporter_tpu_torch.ops import hashtable as H
    from reporter_tpu_torch.ops import viterbi as V
    from reporter_tpu_torch.ops.candidates import candidate_sweep
    from reporter_tpu_torch.parallel import make_mesh2
    from reporter_tpu_torch.tiles.tiering import TieredTable

    dev, K, p = matcher.device, matcher.cfg.beam_k, matcher._params
    x, y, _t, v = V.unpack_inputs(xin)
    sw = candidate_sweep(matcher._dg, x, y, v, K, p.search_radius, p.sigma_z, False)
    a, b = sw.to_node[:, :-1, :, None], sw.from_node[:, 1:, None, :]
    ka, kb = (t.reshape(-1) for t in torch.broadcast_tensors(a, b))
    N, P = ka.numel(), x.numel()
    rows, info = {}, []
    for ubodt, du in ((matcher.ubodt, matcher._du), (ubodt_w, du_w)):
        want = H.ubodt_lookup(du, a, b)
        hashes = [H.device_pair_hash(ka, kb, du.bmask)]
        if not du.wide:
            hashes.append(H.device_pair_hash2(ka, kb, du.bmask))
        home = sum(torch.bincount(h, minlength=du.bmask + 1) for h in hashes).cpu()
        row_bytes = 4 * ubodt.bucket_entries * 8
        for gp in MESH_TIER_GP:
            shard = (du.bmask + 1) // gp
            for occ, budget in (("cold", 1), ("seeded", TIER_PARTIAL),
                                ("partial", TIER_PARTIAL), ("hot", shard * row_bytes)):
                torch.cuda.synchronize(dev)
                m0 = torch.cuda.memory_allocated(dev)
                tier = TieredTable(ubodt, budget, mesh=make_mesh2(1, gp, [dev] * gp))
                sharded = tier.device()
                name = H.probe_kernel_name(sharded)
                maintain_ms = None
                if occ == "partial":
                    H.ubodt_lookup(sharded, a, b, False)
                    tier.drain_stats()
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    tier.maintain()
                    torch.cuda.synchronize(dev)
                    maintain_ms = (time.perf_counter() - t0) * 1e3
                torch.cuda.synchronize(dev)
                used = torch.cuda.memory_allocated(dev) - m0
                host = tier.pages_t.data_ptr()
                regs = [(s, e[2]) for s, e in _kernels._HOST.items()
                        if s <= host < s + e[2]]
                check(regs == [(host, tier.pages.nbytes)],
                      "the pages registered once, whole: %s" % regs)
                check(all(_kernels.memory_type(host + r.lo * tier.lanes * 4) == 1
                          for r in tier._ranks.values()),
                      "every rank's first page is page-locked host memory")
                outs, totals, staging = [], [0, 0], [0, 0, 0]
                for view in sharded.shards:
                    r = view.rank
                    (got, ds), dk = _rank_delta(r, lambda: _stage_delta(
                        r, lambda: H.ubodt_lookup(view, a, b)))
                    (plain, dsp), dp = _rank_delta(r, lambda: _stage_delta(
                        r, lambda: H.ubodt_lookup_plain(view, a, b)))
                    check(all(torch.equal(g, w) for g, w in zip(got, plain)),
                          "%s rank %d/%d (%s) equals its plain version" % (name, r.g, gp, occ))
                    check(torch.equal(dk[0], dp[0]) and dk[1] == dp[1],
                          "%s rank %d/%d (%s): fetch counts and totals %s equal the plain "
                          "version's %s" % (name, r.g, gp, occ, dk[1], dp[1]))
                    check(ds == dsp, "%s rank %d/%d (%s): staged and in-place rows %s equal "
                          "the plain version's %s" % (name, r.g, gp, occ, ds, dsp))
                    staging = [x + y for x, y in zip(staging, staged_check(
                        tier, r, du, a, b, ds, "%s rank %d/%d (%s)" % (name, r.g, gp, occ)))]
                    check(torch.equal(dk[0].to(torch.int64), home[r.lo:r.lo + r.n]),
                          "%s rank %d/%d (%s) counts exactly its range's fetches"
                          % (name, r.g, gp, occ))
                    totals = [totals[0] + dk[1][0], totals[1] + dk[1][1]]
                    outs.append(got)
                merged = (collectives.pmin([o[0] for o in outs])[0],
                          collectives.pmin([o[1] for o in outs])[0],
                          collectives.pmax([o[2] for o in outs])[0])
                check(all(torch.equal(g, w) for g, w in zip(merged, want)),
                      "%s pmin/pmax over gp=%d (%s) equals the untiered kernel 2" % (
                          name, gp, occ))
                check(sum(totals) == N * len(hashes), "the ranks' fetches %d sum to the "
                      "untiered rows read %d" % (sum(totals), N * len(hashes)))
                if occ == "cold":
                    check(totals[0] == 0, "every fetch cold at a 1-byte budget")
                if occ == "hot":
                    check(totals[1] == 0, "every fetch hot at a rank's whole range")
                if occ == "seeded":
                    check(totals[0] > 0 and totals[1] > 0,
                          "hits and misses at 64 MiB a rank, as seeded")
                if occ == "partial":
                    check(totals[0] > 0, "hits at 64 MiB a rank after a pass")
                per_rank = [{"g": r.g, "hot_rows": len(tier._hot_g[r.g]),
                             "hot_bytes": len(tier._hot_g[r.g]) * row_bytes}
                            for r in (vw.rank for vw in sharded.shards)]
                stage_bytes = sum(tier.stage_bytes(vw.rank) for vw in sharded.shards)
                rec = {"layout": ubodt.layout, "gp": gp, "occupancy": occ, "budget": budget,
                       "hits": totals[0], "misses": totals[1], "device_bytes": used,
                       "stage_bytes": stage_bytes, "staged_rows": staging[0],
                       "inplace_cold_rows": staging[1], "distinct_cold_rows": staging[2],
                       "maintain_ms": maintain_ms, "ranks": per_rank}
                info.append(rec)
                print("%s gp %d %s: %d hits, %d misses over %d keys; ranks' hot bytes %s, "
                      "device bytes in use %d before the probes (staging %d B after), "
                      "maintain %s ms; each rank equals its plain version with its own fetch "
                      "counts, pmin/pmax equals kernel 2; the ranks staged %d rows x %d B, %d "
                      "read in place past the capacity (overflow), = their %d distinct cold "
                      "rows read" % (name, gp, occ, totals[0], totals[1], N,
                                     [x_["hot_bytes"] for x_ in per_rank], used, stage_bytes,
                                     "%.1f" % maintain_ms if maintain_ms is not None else "-",
                                     staging[0], row_bytes, staging[1], staging[2]))
                if gp == 4 and occ in ("seeded", "partial"):
                    r0 = sharded.shards[0]
                    bk = torch.unique(probe_buckets(du, a, b, r0.lo, r0.local_buckets))
                    n_hot = int((r0.rank.slot_map[(bk - r0.lo).to(dev)] >= 0).sum())
                    n_cold = int(bk.numel()) - n_hot
                    # HBM: the keys, each distinct bucket's slot-map entry,
                    # the hot rows, dist and time out; the link: cold rows
                    hbm = 8 * P * K + 4 * int(bk.numel()) + row_bytes * n_hot + 8 * N
                    row = dict(name=name, route="cuda",
                               source="reporter_tpu_torch/csrc/ubodt_probe.cu",
                               replaces="reporter_tpu/tiles/tiering.py:538",
                               max_abs_err=0.0, library_ms=None, gp=4, probes=N,
                               rank_hot_rows=n_hot, rank_cold_rows=n_cold,
                               bound_ms=(hbm / PEAK_BYTES_S
                                         + row_bytes * n_cold / link["peak_bytes_per_s"])
                               * 1e3, bound_by="bytes")
                    if timed:
                        row["ms"] = time_ms(lambda: H.ubodt_lookup(r0, a, b, False),
                                            cold_l2=True, label="%s gp4 rank 0 %d probes %s"
                                            % (name, N, occ))
                        row["plain_ms"] = time_ms(
                            lambda: H.ubodt_lookup_plain(r0, a, b, False), reps=3,
                            warmup=1, cold_l2=True, queued=False)
                    print("kernel %-34s rank 0 of gp 4 at 64 MiB (%s), %d probes, %d hot and "
                          "%d cold distinct rows: kernel_ms=%s plain_ms=%s bound_ms=%.4f (bytes)"
                          % (name, occ, N, n_hot, n_cold, "%.4f" % row["ms"] if "ms" in row
                             else "-", "%.4f" % row["plain_ms"] if "plain_ms" in row
                             else "-", row["bound_ms"]))
                    if timed:
                        row["stage_kernels"] = stage_kernel_rows(r0, du, a, b, link, P, K)
                    # the kernels line: the seeded state, hot and cold rows mixed
                    rows.setdefault(name, {})[occ] = row
                tier.close()
    out = [dict(rows[n]["seeded"], after_maintain={
        k: rows[n]["partial"].get(k) for k in ("ms", "plain_ms", "bound_ms", "rank_hot_rows",
                                                "rank_cold_rows")})
           for n in ("ubodt_probe[tiered,sharded]", "ubodt_probe[wide32,tiered,sharded]")]
    # the staging kernels' rows: the cuckoo rank's, seeded (its cold rows),
    # with the wide32 rank's beside them
    if timed:
        wide = {x["name"]: x for x in out[1]["stage_kernels"]}
        out += [dict(x, wide32={k: wide[x["name"]][k] for k in ("ms", "plain_ms", "bound_ms")})
                for x in out[0]["stage_kernels"]]
    return out, info


def mesh_tier_paths(matcher, ubodt_w, traces64, traces256, traces2048, tr_a):
    """A dp2 x gp4 tiered matcher (64 MiB a rank, every rank on this card)
    through the launch counters over the bucketed (512 x 64, 128 x 256),
    long (64 x 2,048), session-slab (512 sessions x 4 steps) and sparse A
    paths, each answer wire-identical to the untiered single-card
    matcher's; after a maintenance pass the bucketed and sparse answers
    again; and a wide32 one over 512 x 64.  Returns ({path: launches},
    {path: s}, {tier summaries})."""
    import numpy as np

    from reporter_tpu_torch.matching import SessionEngine, SessionStore
    from reporter_tpu_torch.matching.arena import carry_host

    sm = sparse_matcher(matcher)
    base = {key: _wire(m.match_many(trs)) for key, m, trs in (
        ("64", matcher, traces64), ("256", matcher, traces256),
        ("long", matcher, traces2048), ("A", sm, tr_a))}
    cfg = matcher.cfg
    slot_b = 12 * cfg.beam_k + 17
    n = len(traces64)
    hot, cold = n // 2, n
    kw = dict(ubodt_hot_bytes=TIER_PARTIAL)
    mt = mesh_matcher(matcher, 8, 4, **kw)
    smt = mesh_matcher(matcher, 8, 4, sparse=True, **kw)
    wmt = mesh_matcher(matcher, 8, 4, ubodt=ubodt_w, **kw)
    for m in (mt, smt, wmt):
        check(m.tiering is not None and m.tiering.n_gp == 4
              and m.tiering.summary()["hot_bytes_total"] == 4 * TIER_PARTIAL,
              "a tier a gp rank, %d B each" % TIER_PARTIAL)
    launches, walls = {}, {}
    cases = [("64", mt, traces64, BUCKETED, 64), ("256", mt, traces256, BUCKETED, 256),
             ("long", mt, traces2048, CARRIED, 256), ("A", smt, tr_a, SPARSE_BUCKETED, 16),
             ("64", wmt, traces64, BUCKETED, 64)]
    for rnd in ("", "_maintained"):
        for key, m, trs, path, T in cases:
            if rnd and key in ("256", "long"):
                continue
            if not rnd:
                m.match_many(trs[:2])  # first-call set-up outside the count
            fwd, other = _forward(m, T, key == "long", key == "A", path)
            kernels, absent = _path_kernels(m, fwd)
            res, dt, ln = _counted(kernels, lambda: m.match_many(trs), absent + other)
            name = "tiered_dp2xgp4_%s%s%s" % (key, "_wide32" if m.ubodt.layout == "wide32"
                                              else "", rnd)
            check(_wire(res) == base[key], "%s is wire-identical to the untiered card" % name)
            launches[name], walls[name] = ln, dt
        if not rnd:
            for m in (mt, smt, wmt):
                m.tiering.maintain()
    am = mesh_matcher(matcher, 8, 4, session_arena=True,
                      session_arena_bytes=hot * slot_b // 8,
                      session_arena_cold_bytes=cold * slot_b, **kw)
    fwd, other = _forward(am, 4, True)
    kernels, absent = _path_kernels(am, fwd)
    kernels += ("slab_gather_owned", "slab_scatter_owned")

    def stream(m):  # groups of a quarter: the slab holds each at once
        eng = SessionEngine(m, SessionStore(cfg.max_sessions, cfg.session_ttl_s),
                            tail_points=cfg.session_tail_points)
        for j in range(0, 16, 4):
            for g in range(0, n, n // 4):
                eng.match_many([dict(tr, trace=tr["trace"][j:j + 4])
                                for tr in traces64[g:g + n // 4]])
        return eng
    host = stream(matcher)
    eng, dt, ln = _counted(kernels, lambda: stream(am), other + absent)
    for tr in traces64:
        u = tr["uuid"]
        s, hs = eng.store.peek(u), host.store.peek(u)
        check(s.records == hs.records, "tiered mesh slab records equal one card's (%s)" % u)
        a_, b_ = carry_host(s.carry), carry_host(hs.carry)
        check(all(np.asarray(a_[k]).tobytes() == np.asarray(b_[k]).tobytes() for k in a_),
              "tiered mesh slab beam equals one card's (%s)" % u)
    launches["tiered_dp2xgp4_session"], walls["tiered_dp2xgp4_session"] = ln, dt
    summaries = {"cuckoo": mt.tiering.summary(), "wide32": wmt.tiering.summary()}
    print("tiered dp2 x gp4 (64 MiB a rank): match_many over 512x64, 128x256, 64x2048, "
          "sparse A and wide32 512x64 wire-identical to the untiered card, again after a "
          "maintenance pass; 512 sessions x 4 steps on the slot-sharded slab equal one "
          "card's; walls %s; tier %s"
          % (", ".join("%s %.3f s" % kv for kv in walls.items()),
             json.dumps(summaries["cuckoo"])))
    for m in (mt, smt, wmt, am):
        m.tiering.close()
    return launches, walls, summaries


MULTIHOST = (  # name, processes, backend, local devices, gp
    ("nccl_gp1", 1, "nccl", 1, 1), ("nccl_gp2", 1, "nccl", 2, 2),
    ("gloo_gp1", 2, "gloo", 1, 1), ("gloo_gp2", 2, "gloo", 1, 2))


def multihost_phase(device):
    """``python -m reporter_tpu_torch.parallel.multihost --device cuda`` on
    this card (the kernels already built): NCCL at world size 1 (gp 1, and
    gp 2 over 2 local ranks), two processes under gloo (gp 1, and gp 2,
    where every probe's pmin / pmax crosses the processes), all at once on
    free ports; each config's lines are byte-identical across its
    processes and equal to the in-process ``sharded_match_fn`` /
    ``graph_sharded_match_fn`` over [cuda:0] * n on the same global batch;
    each child's kernel-launch deltas show kernels 1-4 (and at gp 2
    ``ubodt_probe[sharded]``).  Two processes under NCCL on one card exit
    2 with the one-rank-a-GPU message."""
    import torch

    from reporter_tpu_torch.ops.viterbi import MatchParams
    from reporter_tpu_torch.parallel import (
        graph_sharded_match_fn, make_mesh, make_mesh2, sharded_match_fn,
    )
    from reporter_tpu_torch.synth.generator import dryrun_scenario, example_grid_batch

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               GLOO_LOG_LEVEL="ERROR")
    runs = list(MULTIHOST) + [("nccl_refused", 2, "nccl", 1, 1)]
    base_port, _spare = _free_ports(len(runs))
    ports = range(base_port, base_port + len(runs))
    t0 = time.perf_counter()
    procs = {}
    for (name, n, backend, local, gp), port in zip(runs, ports):
        procs[name] = [subprocess.Popen(
            [sys.executable, "-m", "reporter_tpu_torch.parallel.multihost",
             "--coordinator", "127.0.0.1:%d" % port, "--processes", str(n),
             "--process-id", str(i), "--device", "cuda", "--backend", backend,
             "--local-devices", str(local), "--graph-devices", str(gp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO)
            for i in range(n)]
    outs = {}
    try:
        for name, ps in procs.items():
            outs[name] = [(p.communicate(timeout=240)[0].decode(errors="replace"),
                           p.returncode) for p in ps]
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.communicate(timeout=30)
    wall = time.perf_counter() - t0
    rc_refused = [rc for _o, rc in outs["nccl_refused"]]
    check(rc_refused == [2, 2] and all("one rank a GPU" in o for o, _rc in
                                       outs["nccl_refused"]),
          "two NCCL processes on one card refused: %s" % outs["nccl_refused"])
    cfg, arrays, ubodt = dryrun_scenario()
    S = len(arrays.seg_ids)
    result = {"wall_s": wall, "runs": {}}
    for name, n, backend, local, gp in MULTIHOST:
        for o, rc in outs[name]:
            check(rc == 0, "multihost %s exit 0: %s" % (name, o[-2000:]))
        lines = [[ln for ln in o.splitlines() if ln.startswith("multihost dryrun ok")]
                 for o, _rc in outs[name]]
        check(all(len(ls) == 1 for ls in lines) and len({ls[0] for ls in lines}) == 1,
              "multihost %s: one line, byte-identical across processes: %s" % (name, lines))
        n_dev = n * local
        devs = [device] * n_dev
        fn = (graph_sharded_match_fn(make_mesh2(n_dev // gp, gp, devs), cfg.beam_k, S)
              if gp > 1 else sharded_match_fn(make_mesh(n_dev, devs), cfg.beam_k, S))
        px, py, tm, vd = (torch.from_numpy(x_).to(device)
                          for x_ in example_grid_batch(arrays, 2 * n_dev, 16, seed=3))
        res, hist = fn(arrays.device_graph(), ubodt.device_ubodt(), px, py, tm, vd,
                       MatchParams.from_config(cfg))
        want = ("multihost dryrun ok: %d devices (%d local, gp %d), batch %d, %d matched "
                "points, hist_total %.1f" % (n_dev, local, gp, 2 * n_dev,
                                             int((res.idx >= 0).sum()),
                                             float(hist.point_count.sum())))
        check(lines[0][0] == want, "multihost %s: %r equals the in-process mesh's %r"
              % (name, lines[0][0], want))
        probe = "ubodt_probe[sharded]" if gp > 1 else "ubodt_probe"
        deltas = []
        for o, _rc in outs[name]:
            ln = [x_ for x_ in o.splitlines() if x_.startswith("multihost kernel launches: ")]
            d = json.loads(ln[0].split(": ", 1)[1]) if ln else {}
            check(all(d.get(k, 0) > 0 for k in ("candidate_sweep", probe, "transition_build",
                                                "viterbi_scan")),
                  "multihost %s: kernels 1-4 launched in every process: %s" % (name, d))
            deltas.append(d)
        result["runs"][name] = {"line": lines[0][0], "launches": deltas}
        print("multihost %-9s %d process(es) x %d local, %s: %s; launches %s"
              % (name, n, local, backend, lines[0][0], json.dumps(deltas)))
    print("multihost: 4 configs and the refused NCCL pair in %.1f s (all at once)" % wall)
    return result


def osm_phases(device, rows=120, grid_misses=None, timed=True, scale=1, card=""):
    """Phase 17: the bench's realistic city (``osm_city``) through the main
    path: its cohorts (``osm_cohorts``); kernels 1-4 against their plain
    versions at 512 x 64 (timed) and 128 x 256, kernel 5 at the long
    window (16 x 256) and the serving slab (512 x 4); the bucketed, long
    (16 x 1,024: four windows of 256) and session (16 steps of 4) paths
    through the launch counters, each held as on the grid city; kernel
    12's misses beside the grid's; agreement against the truth; the CPU
    baseline on the first 100 short traces (``baseline_phase``); serve
    from the OSM CLI's network (``osm_serve_phase``); phase 18's batch
    request and its wire from the CLI's tiles (``wire_phase``); phases 19
    and 20 on its served matcher; phase 21's batched and streaming modes
    (``modes_phase``) on this phase's matcher and cohorts; phase 22's fleet
    (``fleet_phase``) on phase 18's tiles config."""
    with phase(17):
        matcher, net, info = osm_city(rows, device)
        short, med, long_ = osm_cohorts(matcher.arrays, scale)
        t64, t256, t1024 = ([s.trace for s in c] for c in (short, med, long_))
        xin64, xin256 = bucket_rows(matcher, t64, 64), bucket_rows(matcher, t256, 256)
        rows64 = kernel_phases(matcher, xin64, timed=timed)
        rows256 = kernel_phases(matcher, xin256, timed=False)
        chain = chain_phases(matcher, t1024, t64, timed=timed)
        launches, rates = main_path(matcher, [t64, t256], [xin64, xin256])
        long_launches, long_rate = long_path(matcher, t1024)
        _am, sess_launches, sess_rate = session_path(matcher, t64)
        misses = probe_misses(matcher, xin64)
        print("osm probe outcomes %dx%d: %s; the grid city's (same shape): %s"
              % (*xin64.shape[1:], json.dumps(misses), json.dumps(grid_misses)))
        agree = {name: agreement(matcher, c) for name, c in
                 (("short", short), ("med", med), ("long", long_))}
        print("osm segment agreement against the truth: %s"
              % ", ".join("%s %.4f" % kv for kv in agree.items()))
        base = baseline_phase(matcher, t64[:100 // scale])
        serve_launches, net_json, tiles = osm_serve_phase(net, rows, t64, device)
    with phase(18):
        wire_info, wire_launches, served = wire_phase(net_json, tiles, t64, t256, t1024,
                                                      device, card)
        quiet("phases 1-4, 17 and 18")
    with phase(19):
        recovery, recovery_launches = recovery_phase(*served, t64, t256, t1024, device, card)
    with phase(20):
        # phase 20 on the matcher phases 18 and 19 serve, beside phase 17's times
        osm_ms = {r["name"]: r["ms"] for r in rows64 if r.get("ms")}
        if chain["long"].get("ms"):
            osm_ms["viterbi_chain"] = chain["long"]["ms"]
        observability = observability_phase(served[1], t64, t256, osm_ms, device, card)
        _RECOVERY_BASE.append(recovery_counts())
        check(not any(v.startswith("REPORTER_FAULT_") for v in os.environ), "faults cleared")
    with phase(21):
        modes, modes_launches = modes_phase(matcher, t64, t1024,
                                            os.path.join(os.path.dirname(net_json),
                                                         "config.json"),
                                            device, card, gap_vehicles=64 // scale)
        quiet("phase 21")
    with phase(22):
        fleet = fleet_phase(served[0], served[2], t64, t256, t1024, device, card)
        quiet("phase 22")
    strip = lambda d: {k: v for k, v in d.items() if not callable(v)}  # noqa: E731
    return {"city": info, "kernels": [strip(r) for r in rows64],
            "kernels_128x256": [strip(r) for r in rows256],
            "chain": {k: strip(c) for k, c in chain.items()},
            "launches": {"bucketed": launches, "long": long_launches,
                         "session": sess_launches, "serve": serve_launches,
                         "batch_wire": wire_launches, "recovery": recovery_launches,
                         **{"modes_" + k: v for k, v in modes_launches.items()}},
            "wire": wire_info, "recovery": recovery, "observability": observability,
            "modes": modes, "fleet": fleet,
            "main_path": rates, "long_path": long_rate, "session_path": sess_rate,
            "probe_outcomes": misses, "grid_probe_outcomes": grid_misses,
            "agreement": agree, "baseline": base,
            # phase 25's inputs on this city (taken out before the report)
            "_ctx": (matcher, t64, t1024)}


def _packs_equal(a, b):
    """Two ``_fill_rows`` results equal bit for bit, times included."""
    return (all(x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
                for x, y in zip(a[:4], b[:4]))
            and len(a[4]) == len(b[4])
            and all(list(a[4][r]) == list(b[4][r]) for r in range(len(a[4]))))


def _host_ms(fn):
    """(fn(), its host wall in ms)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def _pack_both(matcher, traces, T, reps=1):
    """(columnar pack, legacy pack, columnar ms, legacy ms) of ``traces``
    at T: ``extract_columns`` + ``_fill_rows(cols=...)`` against
    ``_fill_rows(cols=None)``, held equal bit for bit; each wall the
    median of ``reps``, taken in turns."""
    from reporter_tpu_torch.matching.columnar import extract_columns

    idxs = list(range(len(traces)))
    walls = ([], [])
    for _ in range(reps):
        got, ms = _host_ms(lambda: matcher._fill_rows(traces, idxs, T,
                                                      extract_columns(traces)))
        legacy, legacy_ms = _host_ms(lambda: matcher._fill_rows(traces, idxs, T))
        walls[0].append(ms)
        walls[1].append(legacy_ms)
    check(_packs_equal(got, legacy), "the columnar pack of %dx%d equals the legacy loop's "
          "bit for bit" % (len(traces), T))
    return got, legacy, statistics.median(walls[0]), statistics.median(walls[1])


def _records_delta(fn):
    """``fn()`` and how many association calls it made through the
    records extension and through the Python loop."""
    from reporter_tpu_torch.matching import assoc_native as A

    e0, p0 = A.records_ext_calls, A.records_py_calls
    out = fn()
    return out, A.records_ext_calls - e0, A.records_py_calls - p0


def ragged_traces(traces, seed=25):
    """Copies of ``traces`` cut to seeded lengths 1-16, their times int on
    every third trace, mixed int and float on the next, float on the
    rest."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i, tr in enumerate(traces):
        pts = [dict(p) for p in tr["trace"][:int(rng.integers(1, 17))]]
        for j, p in enumerate(pts):
            if i % 3 == 0 or (i % 3 == 1 and j % 2 == 0):
                p["time"] = int(p["time"])
        out.append(dict(tr, uuid="%s/r" % tr["uuid"], trace=pts))
    return out


def host_pack_paths(matcher, traces64, traces256, traces2048):
    """Phase 25 (1): ``match_many`` on the card with host_pack on and off,
    equal wire on the bucketed and long paths, and one 512-session x
    4-point slab step through ``match_sessions``, equal packed output, aux
    and beams."""
    from dataclasses import replace

    import numpy as np

    from reporter_tpu_torch.matching import SegmentMatcher
    from reporter_tpu_torch.matching.arena import carry_host

    def mk(hp, **kw):
        m = SegmentMatcher(arrays=matcher.arrays, ubodt=matcher.ubodt, device=matcher.device,
                           config=replace(matcher.cfg, host_pack=hp, **kw))
        check(m._host_pack is hp, "host_pack %s" % hp)
        return m

    off = mk(False)
    walls = {}
    for name, trs in (("bucketed", traces64 + traces256), ("long", traces2048)):
        t0 = time.perf_counter()
        a = matcher.match_many(trs)
        t1 = time.perf_counter()
        b = off.match_many(trs)
        walls[name] = {"host_pack_s": t1 - t0, "legacy_s": time.perf_counter() - t1}
        check(_wire(a) == _wire(b), "%s match_many: host_pack on and off give equal wire"
              % name)
    items = [{"points": tr["trace"][:4], "carry": None, "t0": float(tr["trace"][0]["time"]),
              "pkey": (), "uuid": "hp-%d" % i} for i, tr in enumerate(traces64)]
    outs = []
    for hp in (True, False):
        m = mk(hp, session_arena=True)
        t0 = time.perf_counter()
        res = m.match_sessions(items)
        walls["session_%s" % ("host_pack" if hp else "legacy")] = time.perf_counter() - t0
        outs.append([(r[0], r[1], carry_host(r[2])) for r in res])
    for (ra, xa, ca), (rb, xb, cb) in zip(*outs):
        check(all(np.asarray(u).tobytes() == np.asarray(v).tobytes() for u, v in zip(ra, rb))
              and np.asarray(xa).tobytes() == np.asarray(xb).tobytes()
              and all(np.asarray(ca[k]).tobytes() == np.asarray(cb[k]).tobytes() for k in ca),
              "the slab step's output, aux and beam equal with host_pack on and off")
    print("host_pack on and off: equal wire on the bucketed (%d traces) and long (%dx%d) "
          "paths and equal slab steps (%d sessions x 4 points): %s"
          % (len(traces64) + len(traces256), len(traces2048), len(traces2048[0]["trace"]),
             len(items), json.dumps(walls)))
    return walls


def records_phase(matcher, traces, T):
    """Phase 25 (2): the association output of one bucketed batch; the
    records extension's ``build_records`` against the port's Python loop
    on the same columns, byte for byte through json.dumps, both timed."""
    import numpy as np

    from reporter_tpu_torch import native
    from reporter_tpu_torch.matching import assoc_native as A
    from reporter_tpu_torch.matching.columnar import extract_columns

    B = len(traces)
    px, py, tm, valid, times = matcher._fill_rows(traces, list(range(B)), T,
                                                  extract_columns(traces))
    (edge, offset, breaks), _aux = matcher._collect_batch(
        matcher._dispatch_batch(px, py, tm, valid))
    abs_tm, n_pts = np.zeros((B, T)), np.zeros(B, np.int32)
    times.fill_abs(abs_tm, n_pts)
    cols = A.association_columns(
        matcher.arrays, matcher.ubodt, edge[:B], offset[:B], breaks[:B], abs_tm, n_pts,
        matcher.cfg.queue_speed_threshold_kph / 3.6, 2.0 * matcher.cfg.sigma_z + 5.0,
        native.require_lib())
    ext = native.require_records_ext()
    ext_ms, py_ms = [], []
    for _ in range(5):  # in turns
        got, ms = _host_ms(lambda: ext.build_records(B, *cols))
        want, ms2 = _host_ms(lambda: A.records_py(B, *cols))
        ext_ms.append(ms)
        py_ms.append(ms2)
    check(json.dumps(got) == json.dumps(want), "build_records equals the Python loop at "
          "%dx%d" % (B, T))
    out = {"records": sum(len(r) for r in got), "ext_ms": statistics.median(ext_ms),
           "python_ms": statistics.median(py_ms), "ext_ms_all": ext_ms,
           "python_ms_all": py_ms}
    print("records %dx%d: %d records, build_records %.2f ms, the Python loop %.2f ms "
          "(medians of 5 in turns: %s / %s), equal through json.dumps"
          % (B, T, out["records"], out["ext_ms"], out["python_ms"],
             ", ".join("%.2f" % v for v in ext_ms), ", ".join("%.2f" % v for v in py_ms)))
    return out


def binary_ingress(matcher, traces):
    """Phase 25 (3): ``traces`` as one binary (RPTC)
    /trace_attributes_batch and as JSON through the port's server: equal
    answers, the binary request packed from the side channel with no
    point dict walked, no ``_columns`` in any body."""
    from reporter_tpu_torch.matching import columnar
    from reporter_tpu_torch.serve import wire

    body = {"traces": traces}
    served = _Served(matcher)
    try:
        t0 = time.perf_counter()
        code, _h, js = _post_raw(served.port, "/trace_attributes_batch",
                                 json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
        t1 = time.perf_counter()
        check(code == 200, "JSON /trace_attributes_batch status %s" % code)
        frame = wire.encode_request(body)
        before = dict(columnar.COUNTS)
        t2 = time.perf_counter()
        code, _h, raw = _post_raw(served.port, "/trace_attributes_batch", frame,
                                  {"Content-Type": wire.CONTENT_TYPE})
        t3 = time.perf_counter()
        delta = {k: columnar.COUNTS[k] - before[k] for k in before}
        check(code == 200, "binary /trace_attributes_batch status %s" % code)
        _c, _h, traced = _post_raw(served.port, "/debug/traces?n=512", None, {})
    finally:
        served.close()
    check(delta == {"side_channel": len(traces), "walked": 0},
          "the binary batch packed from the side channel, no dict walked: %s" % delta)
    check(json.loads(raw) == json.loads(js), "the binary batch answers as its JSON twin")
    check(b"_columns" not in raw and b"_columns" not in js and b"_columns" not in traced,
          "no response or /debug/traces entry holds _columns")
    out = {"traces": len(traces), "json_s": t1 - t0, "binary_s": t3 - t2,
           "json_bytes": len(json.dumps(body)), "binary_bytes": len(frame), **delta}
    print("binary ingress: %d traces, JSON %d bytes in %.3f s, RPTC %d bytes in %.3f s, "
          "equal answers; extract_columns took %d traces from the side channel, walked %d"
          % (len(traces), out["json_bytes"], out["json_s"], out["binary_bytes"],
             out["binary_s"], delta["side_channel"], delta["walked"]))
    return out


def carry_window_paths(hoisted, traces, what):
    """Phase 25 (4): ``traces`` (longer than the top bucket) through
    ``long_precompute=False`` matchers under scan and assoc, through the
    launch counters: wire equal to the hoisted matcher's of the same
    forward, the compact [3, B, T] output equal at every column (every
    seam column included), kernels 1-3 and the chain kernel once a window
    of the one group, no pre dispatch.  Returns the launch counts by
    forward."""
    from dataclasses import replace

    import numpy as np

    from reporter_tpu_torch.matching import SegmentMatcher
    from reporter_tpu_torch.matching import matcher as M

    W = hoisted.max_trace_points
    n_win = -(-max(len(t["trace"]) for t in traces) // W)
    idxs = list(range(len(traces)))
    launches, walls = {}, {}
    for kernel in ("scan", "assoc"):
        def mk(pre):
            return SegmentMatcher(arrays=hoisted.arrays, ubodt=hoisted.ubodt,
                                  device=hoisted.device,
                                  config=replace(hoisted.cfg, long_precompute=pre,
                                                 viterbi_kernel=kernel))
        ref = hoisted if kernel == hoisted._kernel_mode else mk(True)
        leg = mk(False)
        check(ref._long_pre and not leg._long_pre, "the two long programs")
        leg.match_many(traces[:1])  # first-call set-up outside the count
        path, other = _forward(leg, W, True)
        kernels, absent = _path_kernels(leg, path)
        fam = M.C_DISPATCH_COHORT
        d0 = {k: fam.labels("long", k).value for k in ("carry", "pre", "chain")}
        got, dt, counts = _counted(kernels, lambda: leg.match_many(traces), absent + other)
        d = {k: fam.labels("long", k).value - d0[k] for k in d0}
        check(d == {"carry": n_win, "pre": 0, "chain": 0},
              "one carry dispatch a window, no pre or chain dispatch: %s" % d)
        if hoisted.device.type == "cuda":
            check(all(counts[k] == n_win for k in kernels),
                  "kernels 1-3 and the chain kernel once a window: %s"
                  % json.dumps({k: counts[k] for k in kernels}))
        t0 = time.perf_counter()
        want = ref.match_many(traces)
        walls[kernel] = {"legacy_s": dt, "hoisted_s": time.perf_counter() - t0}
        # the legacy program has no aux: its quality blocks carry no margins
        qg, qw = ([r.pop("_quality", None) for r in rs] for rs in (got, want))
        check(_wire(got) == _wire(want), "%s %s: the per-window program's wire equals the "
              "hoisted path's" % (what, kernel))
        check([q and {k: q[k] for k in ("edge", "n_points", "breaks")} for q in qg]
              == [q and {k: q[k] for k in ("edge", "n_points", "breaks")} for q in qw],
              "%s %s: the quality blocks' edges and breaks equal" % (what, kernel))
        comp = []
        for m in (ref, leg):
            (h,) = m._dispatch_long(traces, idxs)
            group, (edge, offset, breaks), _t, _a = m._fetch_long_aux(h)
            comp.append((group, edge, offset.view(np.int32), breaks))
        (ga, *a), (gb, *b) = comp
        check(ga == gb and all(np.array_equal(x, y) for x, y in zip(a, b)),
              "%s %s: compact output equal at every column" % (what, kernel))
        check(all(np.array_equal(x[:, c], y[:, c]) for x, y in zip(a, b)
                  for c in range(W, a[0].shape[1], W)),
              "%s %s: compact output equal at every seam column" % (what, kernel))
        launches[kernel] = counts
        print("per-window carry %s %dx%d (%d windows of %d, %s): equal to the hoisted "
              "path, wire and compact; launches %s; legacy %.3f s, hoisted %.3f s"
              % (what, len(traces), len(traces[0]["trace"]), n_win, W, kernel,
                 json.dumps({k: counts[k] for k in kernels}), dt, walls[kernel]["hoisted_s"]))
    return launches, walls


def host_plane_phase(matcher, traces64, traces256, traces2048, osm, card=""):
    """Phase 25: the reference's default host plane and the per-window
    carry program on the grid city and on phase 17's realistic city
    (``osm``: its matcher and its 512 x 64 and 16 x 1,024 cohorts)."""
    t_start = time.perf_counter()
    om, o64, o1024 = osm
    # (1) the packer at the path's shapes and on ragged lengths 1-16
    packs = {}
    for trs, T in ((traces64, 64), (traces256, 256), (traces2048, 2048),
                   (ragged_traces(traces64[:256]), 16)):
        _g, _l, ms, legacy_ms = _pack_both(matcher, trs, T, reps=5)
        packs["%dx%d" % (len(trs), T)] = {"pack_ms": ms, "pack_legacy_ms": legacy_ms}
    print("columnar pack equals the legacy loop bit for bit (medians of 5 in turns): %s"
          % json.dumps(packs))
    (paths, n_ext, n_py) = _records_delta(
        lambda: host_pack_paths(matcher, traces64, traces256, traces2048))
    # (2) the records extension against the Python loop
    records = {"%dx%d" % (len(t), T): records_phase(matcher, t, T)
               for t, T in ((traces64, 64), (traces256, 256))}
    # (3) binary ingress on the realistic city
    (ingress, e2, p2) = _records_delta(lambda: binary_ingress(om, o64[:64]))
    # (4) the per-window carry program
    (carry, e3, p3) = _records_delta(lambda: (
        carry_window_paths(matcher, traces2048, "grid"),
        carry_window_paths(om, o1024, "osm")))
    counts = {"records_ext_calls": n_ext + e2 + e3, "records_py_calls": n_py + p2 + p3}
    check(counts["records_ext_calls"] > 0 and counts["records_py_calls"] == 0,
          "every association call of phase 25 took the records extension: %s" % counts)
    out = {"pack": packs, "paths": paths, "records": records, "ingress": ingress,
           "carry_launches": {"grid": carry[0][0], "osm": carry[1][0]},
           "carry_walls": {"grid": carry[0][1], "osm": carry[1][1]}, **counts,
           "wall_s": time.perf_counter() - t_start, "card": card}
    walls = {"pack_ms": packs, "paths_s": paths,
             "records_ms": {k: {f: r[f] for f in ("ext_ms", "python_ms")}
                            for k, r in records.items()},
             "ingress_s": {f: ingress[f] for f in ("json_s", "binary_s")},
             "carry_s": out["carry_walls"]}
    print("phase 25 walls on %s: %s" % (card, json.dumps(walls)))
    print("phase 25 counters: %s; wall %.1f s on %s" % (json.dumps(counts), out["wall_s"],
                                                       card))
    return out


def parent_kernels(parent, tag):
    """Every kernel library of ``KERNELS`` that ``parent`` (a checkout of
    another tree) has, built from its sources as this tree's are, into
    build/pair/<tag>/, and bound: ({name: Kernel}, {library: nvcc
    output})."""
    import copy
    import ctypes

    from reporter_tpu_torch._build import build_all
    from reporter_tpu_torch.ops import _kernels

    csrc = os.path.join(os.path.abspath(parent), "reporter_tpu_torch", "csrc")
    out_dir = os.path.join(REPO, "build", "pair", tag)
    os.makedirs(out_dir, exist_ok=True)
    headers = [os.path.join(csrc, f) for f in sorted(os.listdir(csrc)) if f.endswith(".cuh")]
    bases = {k.base for k in _kernels.KERNELS.values()
             if os.path.exists(os.path.join(csrc, k.base + ".cu"))}
    jobs = {os.path.join(out_dir, "lib%s.so" % base): (
        [_kernels.nvcc_path()] + _kernels.NVCC_FLAGS + [os.path.join(csrc, base + ".cu")],
        [os.path.join(csrc, base + ".cu")] + headers) for base in sorted(bases)}
    out = build_all(jobs)
    bound_ = {}
    for name, k in _kernels.KERNELS.items():
        if k.base in bases:
            pk = copy.copy(k)
            pk.library, pk._fn = os.path.join(out_dir, "lib%s.so" % k.base), None
            lib = ctypes.CDLL(pk.library)
            if k.base == "ubodt_probe" and not hasattr(lib, "ubodt_cold_mark_launch"):
                # a tree from before the staged tiered probe: no staging, and
                # its tiered probe reads cold rows in place (_unstaged)
                if name in ("ubodt_cold_mark", "ubodt_cold_gather"):
                    pk._fn = pk._err = lambda *a: 0  # noqa: E731
                    bound_[name] = pk
                    continue
                if "tiered" in name:
                    pk.argtypes = k.argtypes[:-len(_kernels._STAGE)]
                    pk._bind()
                    pk._fn = _unstaged(pk._fn, len(_kernels._STAGE))
                    bound_[name] = pk
                    continue
            pk._bind()
            if k.base == "segment_histogram":  # before PR 13 the wrapper zeroed the output
                with open(os.path.join(csrc, k.base + ".cu")) as f:
                    pk.zeroes_output = "zeroed by the caller" not in f.read()
            bound_[name] = pk
    return bound_, out


def _unstaged(fn, n_stage):
    """A tiered probe's launcher of a tree from before the staged probe
    (``parent_kernels``): the ``n_stage`` staging arguments dropped, the
    stream kept."""
    def launch(*args):
        return fn(*args[:-1 - n_stage], args[-1])
    return launch


class _DeviceFloats:
    """``n`` float32 at a device address, for ``torch.as_tensor``."""

    def __init__(self, addr, n):
        self.__cuda_array_interface__ = {"shape": (n,), "typestr": "<f4",
                                         "data": (addr, False), "version": 2}


def _zeroed_first(fn):
    """A ``segment_histogram`` launcher of a tree whose wrapper zeroed the
    [4, S] output with ``torch.zeros``: the output is zeroed as there (a
    fill on the current stream) before the launch."""
    import torch

    def launch(*args):
        S, out = args[9], args[10].value
        torch.as_tensor(_DeviceFloats(out, 4 * S), device="cuda").zero_()
        return fn(*args)
    return launch


class design:
    """Within the block, the wrappers launch the given kernels' entry
    points (another build of the same C interface) in place of this
    tree's; the launch counters stay this tree's.  A histogram build
    whose launcher does not zero its output gets the fill its own
    wrapper made (``_zeroed_first``)."""

    def __init__(self, kernels):
        self.kernels = kernels

    def __enter__(self):
        import ctypes

        from reporter_tpu_torch.ops import viterbi as V
        from reporter_tpu_torch.ops._kernels import KERNELS

        self.saved = {n: (KERNELS[n]._fn, KERNELS[n]._err) for n in self.kernels}
        for n, k in self.kernels.items():
            fn = k._fn if getattr(k, "zeroes_output", True) else _zeroed_first(k._fn)
            KERNELS[n]._fn, KERNELS[n]._err = fn, k._err
        self.ws = V._assoc_ws_floats
        assoc = self.kernels.get("viterbi_assoc")
        if assoc is not None and not hasattr(ctypes.CDLL(assoc.library),
                                             "viterbi_assoc_workspace"):
            # a build from before the workspace query: its kernels take
            # every level and the [T, K] scores in the workspace
            def old(T, K, carry, ours=self.ws):
                levels = [T - 1]
                while levels[-1] >= 2:
                    levels.append(levels[-1] // 2)
                return max(ours(T, K, carry), sum(levels) * (K * K + K) + T * K)
            V._assoc_ws_floats = old

    def __exit__(self, *exc):
        from reporter_tpu_torch.ops import viterbi as V
        from reporter_tpu_torch.ops._kernels import KERNELS

        for n, fe in self.saved.items():
            KERNELS[n]._fn, KERNELS[n]._err = fe
        V._assoc_ws_floats = self.ws


def sass_counts(libs):
    """{kernel function (demangled, without its parameters): SASS
    instruction count} over the built libraries, read by ``cuobjdump
    --dump-sass`` (nothing is launched)."""
    import re

    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    counts, fn = {}, None
    for lib in libs:
        text = subprocess.run([cuobjdump, "--dump-sass", lib], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = 0
            elif fn is not None and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
                counts[fn] += 1
    return dict(zip(_short_names(list(counts)), counts.values()))


def _outputs_equal(a, b):
    """Two wrapper results equal bit for bit (tensors, tuples, carries)."""
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and _bits_equal([a], [b])
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_outputs_equal(x, y) for x, y in zip(a, b))
    return a == b


def pair_setup(trees):
    """``--pair TREE [TREE ...]``: every kernel library of each TREE (a
    checkout; the parent first) built and bound into ``_PAIR``, so that
    every labelled ``time_ms`` of the run also times those builds
    (``_paired``); prints each build's registers and each kernel
    function's SASS instruction count in every build."""
    from reporter_tpu_torch.ops import _kernels

    for i, tree in enumerate(trees):
        tag = "%d_%s" % (i, os.path.basename(os.path.abspath(tree)))
        _PAIR[tag], nvcc_out = parent_kernels(tree, tag)
        for lib, text in sorted(nvcc_out.items()):
            regs = ptxas_report(text)
            _PAIRED.setdefault("ptxas", {}).setdefault(tag, {})[os.path.basename(lib)] = regs
            print("  %s %s: %s" % (tag, os.path.basename(lib), regs))
    builds = dict({t: ks.values() for t, ks in _PAIR.items()},
                  change=_kernels.KERNELS.values())
    sass = {tag: sass_counts(sorted({k.library for k in ks})) for tag, ks in builds.items()}
    for fn_name in sorted(set().union(*sass.values())):
        print("sass %-64s %s" % (fn_name[:64], " ".join(
            "%s %s" % (tag, sass[tag].get(fn_name, "-")) for tag in builds)))
    _PAIRED["sass"] = sass


def main(pair=()):
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: CUDA is not available\n")
        return 2
    import reporter_tpu_torch  # noqa: F401 - fails outside a checkout

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print("python %s, torch %s, cuda %s" % (sys.version.split()[0], torch.__version__,
                                            torch.version.cuda))
    t_start = _RUN["t0"] = time.perf_counter()
    device = torch.device("cuda", torch.cuda.current_device())
    with phase(0):
        pool = prefetch_cohorts()
        build_s = build()
        if pair:
            pair_setup(pair)
        floor_ms = launch_floor(smi.splitlines()[0])
        matcher, city = metro_city(120, device)
        traces64 = cohort(matcher, 7, 512, 64)
        traces256 = cohort(matcher, 8, 128, 256)
        traces2048 = cohort(matcher, 9, 64, 2048)
        xin64, xin256 = bucket_rows(matcher, traces64, 64), bucket_rows(matcher, traces256, 256)
    with phase(1):
        rows = kernel_phases(matcher, xin64, timed=True)
        rows256 = kernel_phases(matcher, xin256, timed=False)
        # the session steps' shape: 496 sessions' 4 new points and 16 padding rows
        rows4 = kernel_phases(matcher, session_rows(matcher, traces64[:-16], 4), timed=False)
    with phase(2):
        chain = chain_phases(matcher, traces2048, traces64, timed=True)
    with phase(3):
        launches, rates = main_path(matcher, [traces64, traces256], [xin64, xin256])
        long_launches, long_rate = long_path(matcher, traces2048)
        arena_matcher, sess_launches, sess_rate = session_path(matcher, traces64)
        split = [breakdown(matcher, trs) for trs in (traces64, traces256)]
        split.append(long_breakdown(matcher, traces2048))
    with phase(4):
        n_reports, serve_launches, fixtures = serve_phase(arena_matcher, traces64,
                                                          traces2048[0], device)
        quiet("phases 1-4")
    # the bench's realistic city through the same paths (phase 17), kernel
    # 12's misses there beside the grid city's; phases 18-22 on it
    osm = osm_phases(device, grid_misses=probe_misses(matcher, xin64),
                     card=smi.splitlines()[0])
    osm_ctx = osm.pop("_ctx")
    quiet("phases 17-22")

    # the sparse-gap model: cohorts A (every 9th point of the 512 x 64
    # cohort: 512 x 8 at 45 s, "45-60", bucket 16) and B (every 12th of the
    # 64 x 2,048 one: 64 x 171 at 60 s, "ge60", bucket 256), uncalibrated
    # at K = 16; L, 16 x 512 at 60 s (two windows of 256)
    with phase(5):
        tr_a, tr_b = subsample(traces64, 9), subsample(traces2048, 12)
        tr_l = cohort(matcher, 12, 16, 512, dt=60.0)
        sm = sparse_matcher(matcher)
        xin_a, xin_b = bucket_rows(sm, tr_a, 16), bucket_rows(sm, tr_b, 256)
        pa_, spa, ka = sm.sparse.params_for("45-60")
        pb_, spb, kb = sm.sparse.params_for("ge60")
        check(ka == kb == 16, "uncalibrated sparse cohorts at K = 16")
        rows_a = kernel_phases(sm, xin_a, timed=True, p=pa_, K=ka, sp=spa)
        rows_b = kernel_phases(sm, xin_b, timed=False, p=pb_, K=kb, sp=spb)
        chain_sp = chain_phases(sm, tr_l, tr_a, timed=True, sp=spb, long_pk=(pb_, kb),
                                sess_pk=(pa_, matcher.cfg.beam_k))
        sp_launches, sp_rates = sparse_main_path(sm, [tr_a, tr_b], [xin_a, xin_b],
                                                 "uncalibrated")
        cm = sparse_matcher(matcher, calibration=os.path.join(REPO, "CALIBRATION.json"))
        check([cm.sparse.params_for(c)[2] for c in ("45-60", "ge60")] == [8, 8],
              "calibrated cohorts at K = 8")
        cal_launches, cal_rates = sparse_main_path(
            cm, [tr_a, tr_b], [bucket_rows(cm, tr_a, 16), bucket_rows(cm, tr_b, 256)],
            "calibrated")
        sp_long_launches, sp_long_rate = long_path(sm, tr_l, "ge60")
        sp_sess_rate, sp_sess_launches = sparse_session_path(matcher, tr_a, "45-60")
        sp_serve_launches, sp_answers = sparse_serve_phase(matcher, tr_a)
    with phase(6):
        # the same shapes on inputs where the gap-conditioned breakage
        # decides (gap_flip): kernels 1-4 on A and B, kernel 5 on L's
        # window and the slab
        flip_rows, flips = [], []
        for seed, (x_s, p_s, sp_s, k_s) in enumerate(((xin_a, pa_, spa, ka),
                                                      (xin_b, pb_, spb, kb)), 21):
            (x_f,), p_f, sp_f = gap_flip([x_s], p_s, sp_s, seed)
            flips.append((x_f, p_f, k_s, sp_f))
            flip_rows.append(kernel_phases(sm, x_f, False, p_f, k_s, sp_f, flip=True))
        chain_flip = chain_phases(sm, tr_l, tr_a, timed=False, sp=spb, long_pk=(pb_, kb),
                                  sess_pk=(pa_, matcher.cfg.beam_k), flip=31)
        quiet("phases 5-6")

    # the UBODT memory system: the metro table in the wide32 layout, kernel
    # 2's wide32 instantiation and the dedup kernels at every shape class
    # of kernel 2 (both layouts), the forced fallback, kernel 5's wide32
    # seam, the probe diagnostic, then the paths on a wide32 + dedup
    # matcher that samples the diagnostic on every dense dispatch
    with phase(7):
        ubodt_w, wide_info = wide_table(matcher)
        mw = memory_matcher(matcher, ubodt_w, probe_every=1)
        du_w = mw._du
        mem, mem_rows = memory_phases(matcher, du_w, xin64, True, what="bucketed")
        mem_shapes = [mem] + [memory_phases(matcher, du_w, x, False, what=w)[0] for x, w in (
            (xin256, "bucketed"), (session_rows(matcher, traces64[:-16], 4), "session step"),
            (long_pre_rows(matcher, traces2048), "long pre"))]
        mem_shapes.append(memory_phases(sm, du_w, xin_a, False, p=pa_, K=ka, what="sparse A")[0])
        fallback = dedup_fallback(matcher, du_w, mem["n"])
        chain_w = chain_phases(mw, traces2048, traces64, timed=False)
        smw = sparse_matcher(mw)
        chain_w_sp = chain_phases(smw, tr_l, tr_a, timed=False, sp=spb, long_pk=(pb_, kb),
                                  sess_pk=(pa_, matcher.cfg.beam_k))
        stats, stats_row, cut = stats_phases(matcher, du_w, xin64, xin_a, timed=True)
        mem_launches, mem_rates = main_path(mw, [traces64, traces256], [xin64, xin256], base=matcher)
        check(mw.probe_stats["samples"] > 0 and mw.probe_stats["pairs"] > 0,
              "the sampled probe diagnostic: %s" % mw.probe_stats)
        print("probe diagnostic sampled on the wide32 + dedup main path: %s"
              % json.dumps(mw.probe_stats))
        mem_long_launches, mem_long_rate = long_path(mw, traces2048, base=matcher)
        mem_sp_launches, mem_sp_rates = sparse_main_path(smw, [tr_a], [xin_a], "wide32 + dedup",
                                                         base=sm)
        mem_serve_launches = memory_serve_phase(matcher.arrays, ubodt_w, tr_a, sp_answers,
                                                fixtures, device)
        quiet("phase 7")

    # the log-depth (assoc) forward: its four kernels against their plain
    # versions at every shape class above (the sparse ones also where the
    # gap-conditioned breakage decides), the crossover against the scan
    # kernel, every path through an assoc matcher and an auto one, serve
    # under REPORTER_VITERBI=assoc
    with phase(8):
        as_rows = [assoc_phases(matcher, xin64, True), assoc_phases(matcher, xin256, False),
                   assoc_phases(matcher, session_rows(matcher, traces64[:-16], 4), False)]
        as_sp = [assoc_phases(sm, xin_a, True, pa_, ka, spa),
                 assoc_phases(sm, xin_b, False, pb_, kb, spb)]
        as_sp += [assoc_phases(sm, x_f, False, p_f, k_f, sp_f, flip=True)
                  for x_f, p_f, k_f, sp_f in flips]
        chain_as = chain_phases(matcher, traces2048, traces64, timed=True, kernel="assoc")
        sp_kw = dict(sp=spb, long_pk=(pb_, kb), sess_pk=(pa_, matcher.cfg.beam_k), kernel="assoc")
        chain_as_sp = chain_phases(sm, tr_l, tr_a, timed=True, **sp_kw)
        chain_as_flip = chain_phases(sm, tr_l, tr_a, timed=False, flip=31, **sp_kw)
        cross = crossover(matcher, traces64, traces256)
        assoc = assoc_paths(matcher, sm, traces64, traces256, traces2048, tr_a, tr_l,
                            [xin64, xin256], xin_a)
        assoc["serve_launches"] = assoc_serve_phase(matcher, traces64, device)
        quiet("phase 8")

    # the tiered UBODT (kernel row 10): kernel 2's tiered instantiations,
    # the dedup probe and the chain seams at three occupancies in both
    # layouts, every path through tiered matchers, the session arena's
    # cold tier, serve under REPORTER_UBODT_HOT_BYTES
    with phase(9):
        link = host_link(device)
        tier_k = {u.layout: tier_kernel_phases(
            matcher, u, xin64, link, sm, tr_l, tr_a,
            dict(sp=spb, long_pk=(pb_, kb), sess_pk=(pa_, matcher.cfg.beam_k)),
            traces2048, traces64) for u in (matcher.ubodt, ubodt_w)}
        tiered = tier_paths(matcher, ubodt_w, sm, traces64, traces256, traces2048, tr_a, tr_l,
                            [xin64, xin256], xin_a)
        cold_launches, cold_tier = session_cold_tier(matcher, traces64)
        tiered["launches"]["session_cold_tier"] = cold_launches
        tiered["launches"]["serve"] = tier_serve_phase(matcher.arrays, matcher.ubodt, tr_a,
                                                       sp_answers, fixtures, device)
        quiet("phase 9")

    # the device mesh (kernel row 11), every rank on this card: kernel 11a
    # at gp 2, 4, 8 in both layouts, the chain kernels' resolved seam,
    # kernel 11b with kernel 4's chosen slots, kernel 11c at dp 2 and 4,
    # then every path on dp2 and dp2 x gp4 matchers, the histogram
    # program on the 2-D mesh, serve and the fixtures on a dp2 x gp4 mesh
    with phase(10):
        mesh_probe = mesh_probe_phases(matcher, du_w, xin64, timed=True)
        mesh_seam = mesh_seam_phases(matcher, sm, traces2048, traces64, tr_l, tr_a,
                                     dict(sp=spb, long_pk=(pb_, kb),
                                          sess_pk=(pa_, matcher.cfg.beam_k)), timed=True)
        hist_row = histogram_phases(matcher, [xin64, xin256], timed=True)
        slab_rows, slab_ms = slab_phases(device, matcher.cfg.beam_k, timed=True)
        slab_ms.update(slab_phases(device, 16, True, timed_dps=(2,))[1])
        slab_ms.update(slab_phases(device, matcher.cfg.beam_k, True, B=4096, timed_dps=(2,))[1])
        mesh = mesh_paths(matcher, sm, ubodt_w, traces64, traces256, traces2048, tr_a, xin64)
        mesh["serve_launches"] = mesh_serve_phase(matcher.arrays, matcher.ubodt, tr_a,
                                                  sp_answers, fixtures, device)
        quiet("phase 10")

    # the redesigned kernels (kernel 2's family, the recursion of kernels 4
    # and 5) on edge inputs, each against its plain version
    with phase(11):
        probe_edge = probe_edges(matcher, ubodt_w, du_w, xin64)
        rec_edge = recursion_edges(matcher, xin64, xin_a, pa_, ka, spa)

    # the redesigned sweep and transition build (kernels 1 and 3) on edge
    # inputs, each against its plain version, and timed at the main path's
    # shapes (the long cohort's 64 x 2,048 too)
    with phase(12):
        sweep_edge = sweep_edges(matcher, xin64, timed=True)
        build_edge = build_edges(matcher, pa_, spa)
        shape_ms = design_shapes(matcher, [(xin64, 8), (xin256, 8),
                                           (bucket_rows(matcher, traces2048, 2048), 8),
                                           (xin_a, ka)], pa_, spa)

    # the redesigned log-depth forward (row 9) and dedup claim (row 8b) on
    # edge inputs, each against its plain version
    with phase(13):
        assoc_edge = assoc_edges(matcher, sm, matcher.ubodt, traces2048)
        claim_edge = claim_edges(matcher, du_w)

    # the redesigned slab kernels (row 11c) on edge inputs, each against its
    # plain version, and the mesh session step's time split into its parts
    with phase(14):
        slab_edge = slab_edges(device)
        mesh_step = mesh_step_split(matcher, traces64, timed=True)

    # the redesigned dedup scatter (row 8b) and probe-outcome counters (row
    # 12) on edge inputs and at the main path's shapes, each against its
    # plain version
    with phase(15):
        scatter_edge = scatter_edges(matcher, du_w)
        stats_edge = stats_edges(device)
        shape15 = redesign_shapes(matcher, sm, du_w, cut, xin64, xin256, xin_a, pa_, ka, True)

    # the redesigned segment histogram (row 11b) on edge inputs, against its
    # plain version (timed at both bucketed shapes in histogram_phases)
    with phase(16):
        hist_edge = histogram_edges(device)
        quiet("phases 11-16")

    # the tiered UBODT on a gp mesh (rows 10 x 11a): kernel 2's tiered and
    # sharded instantiations a rank at three occupancies in both layouts,
    # then every path on a tiered dp2 x gp4 matcher
    with phase(23):
        mesh_tier_rows, mesh_tier_info = mesh_tier_kernels(matcher, ubodt_w, du_w, xin64,
                                                           link, timed=True)
        mt_launches, mt_walls, mt_summ = mesh_tier_paths(matcher, ubodt_w, traces64,
                                                         traces256, traces2048, tr_a)
        quiet("phase 23")

    # the multi-controller entry point on this card: NCCL at world size 1,
    # two processes under gloo
    with phase(24):
        multihost = multihost_phase(device)
        quiet("phase 24")

    # the reference's default host plane (the columnar packer, binary
    # ingress into it, the records extension) and the per-window carry
    # program, on the grid and the realistic city
    with phase(25):
        host_plane = host_plane_phase(matcher, traces64, traces256, traces2048, osm_ctx,
                                      smi.splitlines()[0])
        del osm_ctx
        quiet("phase 25")

    # launches over the counted runs of every path but serve's; kernels
    # 1-4's times and bounds at 512 x 64, max_abs_err over both bucketed
    # shapes, the session step's and the sparse cohorts A and B (K = 16),
    # gap_flip's included; kernel 5's at the long path's 64 x 256; the
    # sparse instantiations' at cohort A's 512 x 16 (kernels 3, 4) and
    # cohort L's 16 x 256 (5)
    runs = [launches, long_launches, sess_launches, sp_launches, cal_launches,
            sp_long_launches, *sp_sess_launches.values(), mem_launches, mem_long_launches,
            mem_sp_launches, *(v for k, v in assoc["launches"].items() if k != "auto"),
            *assoc["launches"]["auto"].values(),
            *(v for k, v in tiered["launches"].items() if k != "serve"),
            *mesh["launches"].values(), *mt_launches.values(),
            *(v for k, v in osm["launches"].items() if k != "serve"),
            *(v for c in host_plane["carry_launches"].values() for v in c.values())]
    total = {k: sum(r[k] for r in runs) for k in launches}
    # kernels 1-5 on the realistic city: its times, bounds and launches
    # beside the grid's (phase 17)
    osm_runs = [v for k, v in osm["launches"].items() if k != "serve"]
    osm_rows = {r["name"]: r for r in osm["kernels"]}
    osm_rows["viterbi_chain"] = osm["chain"]["long"]

    def on_osm(name):
        r = osm_rows[name]
        return {"launches": sum(x[name] for x in osm_runs), **{
            k: r.get(k) for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}}
    kernels = [{
        "name": r["name"], "route": r["route"], "source": r["source"],
        "replaces": r["replaces"], "launches": total[r["name"]],
        "max_abs_err": max(x["max_abs_err"] for x in (r, r2, r4, ra, rb, fa, fb)),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None, "osm": on_osm(r["name"]),
    } for r, r2, r4, ra, rb, fa, fb in zip(
        rows, rows256, rows4, *(rs[:2] + rows[2:] for rs in (rows_a, rows_b, *flip_rows)))]
    cl = chain["long"]
    kernels.append({
        "name": "viterbi_chain", "route": "cuda",
        "source": "reporter_tpu_torch/csrc/viterbi_chain.cu",
        "replaces": "reporter_tpu/ops/viterbi.py:447", "launches": total["viterbi_chain"],
        "max_abs_err": max(c["max_abs_err"] for c in chain.values()), "ms": cl["ms"],
        "plain_ms": cl["plain_ms"], "bound_ms": cl["bound_ms"], "bound_by": cl["bound_by"],
        "library_ms": None, "osm": on_osm("viterbi_chain")})
    kernels.extend({
        "name": r["name"], "route": r["route"], "source": r["source"],
        "replaces": r["replaces"], "launches": total[r["name"]],
        "max_abs_err": max(x["max_abs_err"] for x in rs), "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None} for r, *rs in zip(rows_a[2:], rows_a[2:], rows_b[2:],
                                                *(f[2:] for f in flip_rows)))
    cs = chain_sp["long"]
    kernels.append({
        "name": "viterbi_chain[sparse]", "route": "cuda",
        "source": "reporter_tpu_torch/csrc/viterbi_chain.cu",
        "replaces": "reporter_tpu/ops/viterbi.py:498",
        "launches": total["viterbi_chain[sparse]"],
        "max_abs_err": max(c["max_abs_err"] for c in (*chain_sp.values(),
                                                       *chain_flip.values())),
        "ms": cs["ms"],
        "plain_ms": cs["plain_ms"], "bound_ms": cs["bound_ms"], "bound_by": cs["bound_by"],
        "library_ms": None})
    # the memory system's kernels: times and bounds at 512 x 64, errors
    # over every shape (each check above is exact, so 0)
    kernels.extend({
        "name": r["name"], "route": "cuda", "source": r["source"], "replaces": r["replaces"],
        "launches": total[r["name"]], "max_abs_err": max(
            [r["max_abs_err"]] + ([x["wide_err"] for x in mem_shapes]
                                  if r["name"] == "ubodt_probe[wide32]" else [])),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for r in mem_rows + [stats_row])
    # the assoc kernels: times and bounds at 512 x 64 (viterbi_assoc), A's
    # 512 x 16 at K = 16 ([sparse]), the long window 64 x 256 and L's
    # 16 x 256 at K = 16 (the chain's); errors over every shape
    cas = {"": chain_as, "[sparse]": {**chain_as_sp, **{
        "flip_" + k: v for k, v in chain_as_flip.items()}}}
    for tag, rs in (("", as_rows), ("[sparse]", as_sp)):
        kernels.append({
            "name": "viterbi_assoc" + tag, "route": "cuda", "source": rs[0]["source"],
            "replaces": rs[0]["replaces"], "launches": total["viterbi_assoc" + tag],
            "max_abs_err": max(r["max_abs_err"] for r in rs), "ms": rs[0]["ms"],
            "plain_ms": rs[0]["plain_ms"], "bound_ms": rs[0]["bound_ms"],
            "bound_by": rs[0]["bound_by"], "library_ms": None})
    for tag, c in cas.items():
        kernels.append({
            "name": "viterbi_chain_assoc" + tag, "route": "cuda",
            "source": "reporter_tpu_torch/csrc/viterbi_assoc.cu",
            "replaces": "reporter_tpu/ops/viterbi.py:674",
            "launches": total["viterbi_chain_assoc" + tag],
            "max_abs_err": max(r["max_abs_err"] for r in c.values()), "ms": c["long"]["ms"],
            "plain_ms": c["long"]["plain_ms"], "bound_ms": c["long"]["bound_ms"],
            "bound_by": c["long"]["bound_by"], "library_ms": None})
    # the tiered instantiations of kernel 2 (row 10): times, bounds and the
    # plain version's at 512 x 64 at the partial budget; errors over every
    # occupancy, the seams' included (each check above is exact, so 0)
    for layout, name in (("cuckoo", "ubodt_probe[tiered]"),
                         ("wide32", "ubodt_probe[wide32,tiered]")):
        r = tier_k[layout]["partial"]
        kernels.append({
            "name": name, "route": "cuda", "source": "reporter_tpu_torch/csrc/ubodt_probe.cu",
            "replaces": "reporter_tpu/tiles/tiering.py:538", "launches": total[name],
            "max_abs_err": max(max(o["max_abs_err"], o["seam_max_abs_err"])
                               for o in tier_k[layout].values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    # the mesh's kernels (row 11): times and bounds of one gp rank of 4 at
    # 512 x 64, the histogram at 512 x 64, the slab kernels at dp 2 rank 0
    for r in mesh_probe + [hist_row] + slab_rows:
        kernels.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": total[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    # the tiered instantiations on a gp mesh (row 10 x 11a): rank 0 of gp 4
    # at 64 MiB; errors over every rank, gp and occupancy (exact, so 0)
    for r in mesh_tier_rows:
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")})
        kernels[-1]["launches"] = total[r["name"]]
    strip = lambda d: {k: v for k, v in d.items() if not callable(v)}  # noqa: E731
    report = {
        "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "city": city, "main_path": rates, "breakdown": split,
        "long_path": long_rate, "session_path": sess_rate,
        "launches": {"bucketed": launches, "long": long_launches, "session": sess_launches,
                     "serve": serve_launches, "sparse_bucketed": sp_launches,
                     "sparse_bucketed_calibrated": cal_launches,
                     "sparse_long": sp_long_launches, "sparse_session": sp_sess_launches,
                     "sparse_serve": sp_serve_launches},
        "sparse": {"bucketed": sp_rates, "calibrated": cal_rates, "long": sp_long_rate,
                   "session": sp_sess_rate,
                   "kernels_k16": {"%s_%s" % (r["name"], shape): {
                       k: v for k, v in r.items() if k in (
                           "ms", "plain_ms", "bound_ms", "max_abs_err", "aux_max_abs_err",
                           "probes", "distinct_rows", "hit_rate")}
                       for shape, rs in (("512x16", rows_a), ("64x256", rows_b)) for r in rs},
                   "chain": {name: strip(c) for name, c in chain_sp.items()},
                   "gap_flip": {
                       "viterbi_scan[sparse]": [f[3]["breaks_flipped"] for f in flip_rows],
                       **{"viterbi_chain[sparse]_" + name: strip(c)
                          for name, c in chain_flip.items()}}},
        "memory": {"wide32_table": wide_info, "shapes": mem_shapes, "fallback": fallback,
                   "probe_stats": stats, "sampled": mw.probe_stats,
                   "chain_wide32": {k: strip(c) for k, c in (*chain_w.items(),
                                                 *(("sparse_" + n, c) for n, c in
                                                   chain_w_sp.items()))},
                   "main_path": mem_rates, "long_path": mem_long_rate,
                   "sparse": mem_sp_rates,
                   "launches": {"bucketed": mem_launches, "long": mem_long_launches,
                                "sparse": mem_sp_launches, "serve": mem_serve_launches},
                   "kernels": {r["name"]: strip(r) for r in mem_rows}},
        "assoc": {"kernels": [strip(r) for r in as_rows + as_sp],
                  "chain": {tag + name: strip(r) for tag, c in cas.items()
                            for name, r in c.items()},
                  "crossover": cross, **{k: v for k, v in assoc.items()}},
        "tiering": {"host_link": link, "kernels": tier_k,
                    "paths": tiered, "session_cold_tier": cold_tier},
        "mesh": {"kernels": [strip(r) for r in mesh_probe + [hist_row] + slab_rows],
                 "seam": mesh_seam, "slab_ms": slab_ms, "step_split": mesh_step, **mesh},
        "redesign_edges": {"probe": probe_edge, "recursion": rec_edge, "sweep": sweep_edge,
                           "build": build_edge, "shapes": shape_ms, "assoc": assoc_edge,
                           "claim": claim_edge, "slab": slab_edge,
                           "scatter": scatter_edge, "probe_stats": stats_edge,
                           "histogram": hist_edge},
        "redesign_shapes": shape15,
        "mesh_tiering": {"kernels": mesh_tier_rows, "ranks": mesh_tier_info,
                         "launches": mt_launches, "s": mt_walls, "summary": mt_summ},
        "multihost": multihost,
        "host_plane": host_plane,
        "osm": osm,
        "floor_ms": floor_ms,
        "metro_reports": n_reports, "peak_memory_mb": torch.cuda.max_memory_allocated() / 1e6,
        "kernels": kernels,
        "extra": dict({"%s_%d" % (r["name"], T): {k: v for k, v in r.items() if k in (
            "probes", "distinct_rows", "hit_rate", "max_abs_err", "aux_max_abs_err")}
            for T, rs in ((64, rows), (256, rows256), (4, rows4)) for r in rs},
            **{"viterbi_chain_" + name: strip(c) for name, c in chain.items()}),
        "phases": _RUN["phases"],
        "wall_s": time.perf_counter() - t_start,
    }
    _write_report(report)
    pool.shutdown()
    print("wall %.1f s, peak device memory %.0f MB"
          % (report["wall_s"], report["peak_memory_mb"]))
    if pair:
        _PAIRED.update(card=smi, trees=[os.path.abspath(t) for t in pair])
        os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO, "chiprun_out", "pair.json"), "w") as f:
            json.dump(_PAIRED, f, indent=1)
        print(json.dumps({"pair": {k: v["ratio"] for k, v in _PAIRED["cases"].items()}}))
    print(json.dumps({"kernels": kernels, "floor_ms": floor_ms}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def tier_focus(pair=()):
    """``--tier``: phase 0's build and the grid city with its 512 x 64
    cohort, then only the kernel checks and times of phases 9 and 23
    (kernel rows 10 and 10 x 11a: ``tier_kernel_phases`` in both layouts
    without the seams, ``cold_cache_probe`` among them, and
    ``mesh_tier_kernels``), no path: the short check of a change to kernel
    2's tiered instantiations, paired with ``--pair``.  Writes
    chiprun_out/tier_focus.json; prints no ``ok`` line."""
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: CUDA is not available\n")
        return 2
    import reporter_tpu_torch  # noqa: F401 - fails outside a checkout

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])
    device = torch.device("cuda", torch.cuda.current_device())
    with phase(0):
        build()
        if pair:
            pair_setup(pair)
        floor_ms = launch_floor(smi.splitlines()[0])
        matcher, _city = metro_city(120, device)
        xin64 = bucket_rows(matcher, cohort(matcher, 7, 512, 64), 64)
        ubodt_w, _info = wide_table(matcher)
        du_w = ubodt_w.to_device(device)
    with phase(9):
        link = host_link(device)
        tier_k = {u.layout: tier_kernel_phases(matcher, u, xin64, link)
                  for u in (matcher.ubodt, ubodt_w)}
    with phase(23):
        mesh_rows, mesh_info = mesh_tier_kernels(matcher, ubodt_w, du_w, xin64, link,
                                                 timed=True)
    out = {"card": smi, "floor_ms": floor_ms, "host_link": link, "tiering": tier_k,
           "mesh_tiering": {"kernels": mesh_rows, "ranks": mesh_info},
           "ptxas": _RUN.get("ptxas"), "phases": _RUN["phases"],
           "wall_s": time.perf_counter() - _RUN["t0"]}
    if pair:
        _PAIRED.update(card=smi, trees=[os.path.abspath(t) for t in pair])
        out["pair"] = _PAIRED
        print(json.dumps({"pair": {k: v["ratio"] for k, v in _PAIRED["cases"].items()}}))
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "tier_focus.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print("tier focus: %.1f s on %s" % (out["wall_s"], smi))
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Chip smoke run of the PyTorch/CUDA port.")
    ap.add_argument("--pair", metavar="TREE", nargs="+", default=(),
                    help="also time every kernel call against the kernels built from each "
                    "TREE, a checkout (the parent first): pair_setup, _paired")
    ap.add_argument("--tier", action="store_true",
                    help="only phase 0's build and city, then the kernel checks and times "
                    "of phases 9 and 23 (tier_focus)")
    args = ap.parse_args()
    sys.exit(tier_focus(args.pair) if args.tier else main(args.pair))
