#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (avenir_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --b4     # B4 alone (below)

Phases, in order; any failure exits non-zero:

1. print the card's name and power limit (nvidia-smi) and build the CUDA
   kernels ``avenir_tpu_torch/csrc/{cooc_pair,cross,knn_tourney,knn_topk,
   gram_probe}.cu`` (one nvcc each) and the native CSV encoder
   (``runtime/native/csv_encode.cpp``, g++), all started together,
   printing each build time and ptxas report;
2. hold each count kernel against its plain PyTorch version on the card —
   exact int equality — and time the kernel, the plain version and a
   library yardstick the port never calls, with CUDA events; B1, B2 and B3
   are the pair histogram of cooc_pair.cu in the four layouts of plan():
   - B1 (fmaj, jmaj): the hospital-readmission shape 11 × 12 × 2 at 16M
     rows and the main path's 10 × 13 × 2 chunk, jmaj 20 × 3 × 2 at 1M
     rows, the wide tree's K = 1 shape 30 × 8 × 2 (jmaj) at 1M rows, ragged
     row counts with invalid codes and labels in fmaj and jmaj, skewed
     (95% of codes in one bin) fmaj and jmaj at 1M rows, zero rows in
     both, and at one class (C = 1, the correlation jobs' feature pairs:
     churn 5 × 6 × 1 jmaj and hospital 10 × 13 × 1 fmaj at 250K rows,
     ragged with invalid codes and labels) (yardstick: ``torch._int_mm``
     on a materialized int8 one-hot);
   - B2 (cls): 20 × 20 × 2 at 4M rows and at the main path's 250K-row
     chunk, ragged/invalid, zero rows, and skewed at 1M rows; B3 (clsb):
     100 × 20 × 2 at 1M rows, ragged/invalid, zero rows, skewed at 1M
     rows, and 2 × 3072 × 2 at 100K rows, whose 3072 × 3072 pair table
     exceeds shared memory (yardstick: one ``torch._int_mm`` per class on
     its materialized int8 one-hot);
   - B4 (cross.cu): 10 × 13 at 1M rows with 2, 16, 18 and 54 selectors,
     1024 selectors (the gate; 16-bit counters), 24 × 32 × 1024 (the gate
     on both sides), ragged with invalid codes and selectors, codes and
     selectors as views at a 4-byte offset with 1,000,001 rows, every row
     and 90% of rows in one bin and one selector, one row (the wrapper's
     floor), zero rows
     (yardstick: one ``torch.bincount`` over the composite index built
     beforehand);
3. generate a 1M-row hospital CSV and run BayesianDistribution,
   BayesianPredictor and MutualInformation through the port's CLI entry on
   ``cuda`` with ``stream.chunk.rows=250000``, then with ``--device cpu``;
   the NB model and predictions must be byte-identical, the MI part file
   equal field by field with numbers within 2e-6, B1 launched once per
   MI chunk, and the stream's retried tasks one per chunk and one for the
   end of the file.  Every job here parses through the native encoder.
   Then MutualInformation on a seeded 20 × 20 × 2 dataset of 1M
   rows in 250K-row chunks on both devices: counts byte-identical, MI
   within 2e-6, B2 launched once per chunk;
4. the tree jobs on the same CSV through the CLI on ``cuda`` and ``cpu``:
   DecisionTreeBuilder with its defaults, and with ``split.search=binary``
   and ``tree.hist.mode=subtract``; its predict mode on the test CSV; and
   ClassPartitionGenerator.  Model files agree (the tree contract: equal
   but for scores within 1e-6), predictions byte-identical, split lines
   equal with numbers within 2e-6, and B4 launched once per level table;
5. ``DecisionTree.fit`` on a seeded 30 × 8 × 2 dataset of 1M rows (binary
   search, depth 4): on ``cuda`` its levels must pack onto jmaj, cls, cls
   and clsb (B1, B2, B3), on ``cpu`` take the plain route, and the trees
   agree;
5b. the main path's host side on phase 3's CSV: (a) the native encoder
   against the Python one (equal arrays, both times); (b) ``python -m
   avenir_tpu_torch.pipeline run`` with an NB and an MI stage in 250K-row
   chunks on ``cuda``: one SharedScan (FusedStages 2, Scans 1, Chunks 4),
   B1 launched 4 times, NB byte-identical to phase 3's ``cuda`` and
   ``cpu`` models, MI to its ``cuda`` file and within 2e-6 of its ``cpu``
   file; (c) the same with ``scan.fuse=false`` and (d) with
   ``stream.prefetch.depth=0`` and the default 2 again, files
   byte-identical, walls printed, and the fused run's host side timed in
   parts; (e) a mixed schema (age, weight and height continuous: 7 × 4 ×
   2 binned + 3 continuous) fused on ``cuda`` through ``hist.gram_moments``
   (4 calls, B1 4), its NB model byte-identical to the standalone ``cuda``
   BayesianDistribution's and within relative 1e-5 of the fused CPU
   run's;
5c. the correlation family and stream checkpoints on a 1M-row churn CSV
   (``datagen/churn.py``: 5 categorical features, 2 classes) in 250K-row
   chunks: (a) CramerCorrelation against the class (B1 at C = 2) and over
   the feature pairs (B1 at C = 1), HeterogeneityReductionCorrelation
   with ``concentration`` and ``uncertainty``, NB and MI, through the CLI
   on ``cuda`` and then ``--device cpu``, and CramerCorrelation over the
   feature pairs of phase 3's hospital CSV (10 × 13 × 1): part files
   byte-identical, B1 once a chunk with its C printed, walls printed;
   (b) ``python -m avenir_tpu_torch.pipeline run`` with NB, MI, Cramér and
   heterogeneity stages: one SharedScan (FusedStages 4, Scans 1,
   Chunks 4), B1 4 times, each part file byte-identical to its
   standalone ``cuda`` job's; (c) MutualInformation and CramerCorrelation
   crashed on ``cuda`` after chunk 2 (``stream.checkpoint.dir``, a
   snapshot a chunk): no part file, snapshots left, B1 2; ``--resume`` on
   ``cuda``: the uninterrupted part file, ``Records::Processed`` 1M, B1 2,
   the snapshots gone; crashed again and resumed with ``--device cpu``:
   MI converts the G snapshot to the same bytes, Cramér refuses it (its
   stale-key gate, as in the JAX package); (d) FisherDiscriminant on
   phase 5b's mixed schema on ``cuda`` and the CPU (largest relative
   difference printed), and a SharedScan with an MI and a Fisher consumer
   on ``cuda``: ``gram_moments`` once a chunk, the model equal to the
   standalone fit on the same chunks;
6. each count kernel again at the main paths' own inputs: every call that
   phases 3–5c and 11 made on ``cuda`` to the count wrappers was recorded
   (the MI jobs' chunks, the pipelines' chunks, the correlation jobs'
   chunks at C = 1 and 2 and the resumed runs', the hospital trees' levels
   with 2, 4, 8 and 16 selectors, the wide tree's packed levels K = 1, 2,
   4, 8, the forest's bagged levels),
   and each is
   held exactly against its plain version; the first call of each path
   and shape is timed with its plain version, yardstick and bound;
7. the kNN kernels against their plain versions, timed likewise
   (yardstick: cuBLAS's bf16 A·Bᵀ per 16,384-row block with
   ``torch.topk(3)`` per 2048-row segment for B5, ``torch.topk(kk)`` per
   row for B6), each kernel handed the schema's used lanes as the search
   hands them: B5 on categorical 6 × 10 data at 4,096 × 262,144 refs
   (keys bit-equal: every d² is an integer sum), B5 and B6 on categorical
   5 × 10, whose 56 used lanes let them contract 64 of W = 128 columns
   (bit-equal to the plain version over all 128), at the knn_qps shape
   (6 × 10 + 8 continuous, 4,096 × 1M; keys within KEY_TOL + one
   truncation step, assembled re-ranked results and certificates equal)
   and with a short last block; B6 on categorical and mixed data at
   4,096 × 16,384 refs with kk 18 and 128, a 12-row set and heavy
   duplicates; each on a categorical schema too wide to keep its query
   tile resident in shared memory (B5 at W 896, B6 at W 2688: the tile is
   streamed), keys and slots bit-equal; and B6 at the 10K path's shape
   (2,048 × 10,240 refs, 9 continuous, kk 18) with its references in one
   range (S = 1, no merge) beside the wrapper's ranges;
8. the kNN paths: (a) NearestNeighbor through the CLI on a seeded 1M-row
   elearn training CSV and 4,096 test rows on ``cuda`` (B5 once), then
   with ``--device cpu`` on the first 1,024 test rows: predictions
   byte-identical but for rows the exact scan served on either device,
   whose distances must agree within 1e-6; (b) NearestNeighbor with
   validation and the gaussian kernel, and SameTypeSimilarity, on 10,000
   elearn rows and 2,000 test rows on both devices (B6 once each): part
   files byte-identical (same exception) and validation counters equal;
   (c) ``KNN.predict`` at the knn_qps shape on ``cuda`` (B5 once) against
   a float64 oracle on its first 256 rows.  Each prints its launch counts
   and how many rows failed the certificate and went to the exact scan;
9. B5 and B6 again on every call the kNN paths made on ``cuda``, held
   against their plain versions with the used lanes the search handed
   them (which must be the schema's); the first of each path and shape
   timed, its bound over the used lanes and real rows read from the model
   and test set the path ran;
10. the three TPU probes' counterparts (``avenir_tpu_torch/probes.py``),
    one JSON line each: B5 in its variants ``dotonly``, ``dotkey``,
    ``full`` and ``full_insert`` at 4,096 × 1M refs on the elearn (w 60)
    and knn_qps (w 114) schemas; the one-hot MMA gram of
    ``csrc/gram_probe.cu`` (B1's kernel before the pair histogram),
    ``full`` and ``dotonly``, beside the pair histogram (``pair``) at a
    hospital MI chunk, the wide tree's K = 1 shape and 11 × 12 × 2 at 16M
    rows; its int8 ``mma.sync`` stage on X staged from [N, W] (``rows``)
    and [W, N] (``cols``) at W 384, 16M rows.  Each full variant is held
    against its plain version, with the plain version's time, a library
    yardstick and the bound beside it;
11. the remaining families (run after 5c and before 6, so that phase 6
    holds the forest's B4 calls): (a) ``RandomForest(num_trees=5, seed=1)``
    on phase 3's 1M-row hospital CSV at the tree jobs' depth on ``cuda``,
    each tree's B4 launches equal to its level tables, then the same
    forest on its first 100K rows on ``cuda`` and the CPU (the tree
    contract, votes within 1e-6), and BaggingSampler and
    UnderSamplingBalancer on the CSV twice on ``cuda`` and once on the
    CPU, part files byte-equal; (b) MarkovStateTransitionModel on 100K
    customers' sequences of ``event_seq``'s planted matrix (drawn in bulk,
    ``datagen/hmm_seq.py``), HiddenMarkovModelBuilder on 20K tagged
    sequences of a planted 6-state × 12-observation HMM (and partially
    tagged on 5K), each on ``cuda`` and the CPU, byte-identical and near
    the planted model; ``ViterbiDecoder("scan").decode_codes`` at 80K ×
    210 on ``cuda`` (twice), its first 2,000 records equal on the CPU scan
    and the ``cuda`` ``"assoc"``; the ViterbiStatePredictor job on 10K of
    those sequences (the cut: the host string work of all 16.8M tokens
    would cost more of the script's time than it shows) on both devices,
    byte-identical; (c) LogisticRegressionJob on the 1M-row CSV, whole and
    in 250K-row chunks, on ``cuda`` and the CPU (histories within 1e-5 of
    each row's largest coefficient, equal iterations and status), and
    five iterations on ``cuda`` resumed on the CPU from the coefficient
    file.  Only the forest launches a kernel; the phase prints each wall
    and its own with the card's name and power limit;
11b. the bandit family, the chombo and text jobs and the online learners
    (after 11; no kernel runs on these paths, so the phase resets the
    launch counts before it and fails unless they read 0 after it):
    (a) ``epsilon_greedy_select``, ``ucb1_select`` and ``softmax_select``
    at 1M groups × 12 arms (half the groups ragged, ~5% of arms untried) on
    ``cuda`` and the CPU, selections equal, the host draw (numpy threefry,
    12M Gumbel words) timed apart from the device selection; (b) the four
    bandit jobs through the CLI on 100K groups × 12 arms (a tenth of the
    groups ragged: 1.15M rows, read by ``GroupState.from_rows``'s Python
    loop) on ``cuda`` and ``--device cpu``, part files byte-identical;
    (c) the tutorial's
    price-optimisation loop (bandit job, the ``price_opt`` revenue
    oracle's ``inc_<round>`` file, RunningAggregator) at its 100 products
    for 20 rounds with GreedyRandomBandit and SoftMaxBandit on both
    devices, every round's files byte-identical (20 rounds, not the
    tutorial's open-ended loop: each round is a few job runs of host
    string work, and 20 already cover the ε decay and the state's growth);
    (d) NumericalAttrStats on phase 3's 1M-row CSV, conditioned on the
    class column and not, whole and in 250K-row chunks, on both devices:
    count, min and max equal, the float64 moments within rtol 1e-12, the
    largest gap printed; (e) WordCounter and NB's text path (train, then
    validate on 50K held-out lines) on a seeded two-class corpus of 200K
    lines × 12 words from a Zipf vocabulary of 20K words that the script
    writes itself (the JAX package has no text generator), on both
    devices, part files byte-identical, without stemming (the Porter
    stemmer is ~10 µs of Python a token: stemming 2.4M tokens four times
    would cost the phase about 100 s and show nothing the CPU tests do
    not); (f) the ``lead_gen`` closed loop through
    ``ReinforcementLearnerServer`` for each of the four learners at 10K
    events (the cut: IntervalEstimator takes a percentile over every
    reward it has kept on every event, so its cost grows with the square
    of the events), each converging to page3, with events/s and p50/p99
    latency.  Every wall is printed with the card's name and power limit.
    The phase takes ~2.5 min, all host Python (PERF.md §5);
12. (after 5b, before 5c; ~25 s) the telemetry plane on the card, over
    phase 3's CSV and phase 5b's pipeline: (a) the NB + MI pipeline with
    ``trace.on``, ``profile.on`` and ``tenant.id=smoke`` between two
    untraced runs: part files byte-identical to phase 5b's, B1 4 each
    time, the journal ``run-<id>.proc-0-smoke.jsonl`` with the span tree
    pipeline.run → scan.fused → scan → 4 scan.chunk, one analytic
    ``scan.chunk`` program whose bytes are B1's bound
    (``hist.gram_work``) with 4 dispatches, ``cuda:0`` memory gauges, and
    every event in the golden schema; the traced and untraced walls and
    their ratio printed; (b) with ``trace.xla.dir``: one Chrome trace of
    the fused stage, B1's ``pair_kernel`` in it 4 times (no CUDA kernel
    event fails the phase), and the device's busy and idle share of the
    scan's and the stage's windows; (c) DecisionTreeBuilder as in phase 4
    with ``trace.on`` and ``profile.on``: the model byte-identical to
    phase 4's, one ``tree.level`` program per key, dispatches equal to
    the levels, B4 as untraced; (d) BayesianDistribution with
    ``blackbox.dir`` and ``blackbox.watchdog.sec`` in a fresh process:
    exit 0, no live bundle left, a capture taken inside the run rendered
    by ``telemetry bundle``; (e) ``python -m avenir_tpu_torch.telemetry``
    ``tree``, ``profile --peak-tflops 989`` (printed), ``metrics`` and
    ``diff`` on (a)'s journals, each exit 0;
12b. (after 12; ~10 s) the planner on the card over phase 3's CSV:
    NB | BayesianPredictor | MI | Cramér (Cramér's ``uses`` edge naming
    the NB model) through ``python -m avenir_tpu_torch.pipeline run``
    staged and with ``plan.on=true``: part files byte-identical, B1 4 in
    each run (one per 250K-row chunk), the planned unit of 3 stages on the
    kernel route with fuse and share-gram fired (``plan explain``
    printed); a correlation-only pipeline planned through the pruned B1
    width (2 of 10 binned columns), byte-identical to staged; the same
    without ``stream.chunk.rows`` (two units over one input) with
    encode-once, B1 once a unit; the walls printed;
12c. (after 8c, whose elearn CSVs it reads; ~25 s) the serving plane on
    the card: ``ScoringPlane`` replays of NB (phase 3's model, 2,000 test
    rows), the tree (phase 4's), LR (phase 11's coefficients), the HMM
    (phase 11's, 300 sequences padded to 256 steps), kNN over phase 8a's
    1M references (512 rows, B5) and over 8b's 10K (2,000 rows, B6,
    gaussian kernel), each byte-identical to its batch job's part file
    (LR: ``predict_batch`` over the file), B5 / B6 launched once per
    dispatch of the batch-size histogram plus once per warmed bucket,
    0 recompiles; a ``ScoreHTTPServer`` on 127.0.0.1 over the six models
    (``/score`` equal to the replays, ``/healthz``, ``/stats``,
    ``/metrics``); a ``ReplicaPool`` of 2 replicas on cuda:0 with one
    killed at its 2nd dispatch (every response byte-identical, none lost
    or doubled); B5 alone at buckets 1, 8 and 64 against the 1M
    references (CUDA events) beside the whole dispatch; one JSON line of
    requests/s, p50/p99 ms and launches per model. Its B5/B6 calls are
    held in phase 9;
13. (after 12c, whose replay it reads; ~70 s) the stream plane and the
    tenancy arbiter on the card: (a) ``StreamAnalytics`` over phase 3's
    1M-row CSV in 65,536-row panes, windows of 4 panes sliding by 1, the
    four consumers and a drift threshold, on cuda (B1 33: 17 warmed
    buckets, all ballast, and 16 panes, the ragged tail on the 32,768
    bucket) and on the CPU: part files byte-identical, 13 windows, 0
    recompiles, the pane-close p50/p99 printed; (b) killed after pane 10
    and by ``fault.fold.crash.after``, each resumed byte-identical to (a)
    from its restored window, and a cuda snapshot refused with
    ``--device cpu``; (c) every B1 call of (a) held against its plain
    version (phase 6's path cases, after 13), listed per bucket as
    ``stream_buckets`` in B1's entry; (d) drift → retrain → swap of a
    served tree (B4 a level) and NB model over a stream whose class the
    script swaps halfway: version bumped, the refit equal to the batch
    job's, a request before the swap answered by the old model and one
    after by the new; (e) two tenants side by side, the NB + MI pipeline
    under ``tenant.batch`` (B1) and a kNN replay over 1M references under
    ``tenant.online`` (B5), each byte-identical to its untenanted run,
    granted + shed = submitted per tenant, and a queue-depth shed of
    batch that leaves online whole;
14. (after 13, whose part files it reads; ~15 s) the ``shard.*`` plane on
    the card's local devices, a one-device mesh on one H100: (a) phase
    5b's NB + MI pipeline with ``shard.devices=all`` (each 250K-row chunk
    padded to its 262,144-row target, B1 once per shard) and (b) phase
    13's ``StreamAnalytics`` likewise, each byte-identical to its
    unsharded run; (c) ``shard.devices=2`` refused with ConfigError
    before any stage on one card (run and byte-identical on two or
    more); (d) ``shard.allreduce.quantized=true`` over the CSV's first
    20,000 rows in 127-row chunks under ``profile.on``, byte-identical
    to the unsharded run, with one ``shard.topology`` naming the card
    and one ``shard.skew`` a chunk; one ``shard`` JSON line of launches
    per shard and walls beside the unsharded ones. Its B1 calls of (a)
    are held in phase 6's path cases after 13;
15. (after 14; ~35 s) ``data.parallel.auto`` on the card: (a)
    ``auto_mesh`` is None on one card (a data mesh needs two); (b) NB,
    MI and Cramér streamed over phase 3's 1M rows, ClassPartitionGenerator
    and DecisionTreeBuilder on them, NumericalAttrStats on the first
    20,000, phase 5b's NB + MI pipeline and phase 13's stream, each with
    the key true and false: part files byte-identical, B1 and B4
    launches equal on one card (per shard, n times, on n ≥ 2), both walls
    printed; (c) the quantized reduce of random int32 partials [8, 32,
    64] in [0, 100,000) bit-equal between cuda and the CPU (ROADMAP Queue
    3, item 10), and the 5b pipeline with ``shard.devices=all`` and
    ``shard.allreduce.quantized=true`` at 250K-row chunks (partial cells
    far past 127) byte-identical between cuda and the CPU; one
    ``automesh`` JSON line;
16. (after 15; ~40 s) the model steps' ``mesh=`` seams on the card: (a)
    ``auto_mesh`` None on one card; NearestNeighbor over phase 8a's 1M
    references (B5 1) and 8b's 10K (B6 1), LogisticRegressionJob on phase
    3's 1M rows, the three Markov jobs on phase 11 (b)'s CSVs and
    ``ScoringPlane`` replays of the kNN (1M and 10K) and Viterbi
    servables on phase 12c's rows, each with ``data.parallel.auto`` true
    and false: part files and responses byte-identical, launches equal,
    both walls printed; (b) the five explicit steps of
    ``parallel/collectives.py`` and ``viterbi_time_sharded`` on a
    one-device ``cuda`` mesh against a one-slot CPU mesh (counts exact,
    moments within 1e-12, the LR step within relative 1e-6, kNN at 512 ×
    131,072 within 1e-6 with equal indices, the Viterbi path at T =
    4,096 equal and equal to the sequential decoder on the card); one
    ``model_mesh`` JSON line;
17. (after 16; ~60 s) the process plane on the card through ``python -m
    avenir_tpu_torch.launch --nprocs 2`` (each rank ``chip_smoke.py
    --fleet-worker``, its own CUDA context on ``cuda:0``, joined over a
    ``TCPStore`` on gloo): (a) NB, MI (B1 2 a rank: chunks 0 and 2, 1 and
    3) and MI on a 1M-row 20 × 20 × 2 CSV (B2 2 a rank), part files
    byte-identical to the one-process runs, each rank's wall and
    ``collective.wait`` beside the one-process walls; (b) NB killed on
    both ranks after its first snapshot and relaunched with ``--resume``:
    (a)'s bytes; (c) the 5b pipeline on a global 2 × 1 mesh
    (``shard.devices=all``, ``shard.proc.axis=proc``; B1 4 a rank) = 5b's
    part files; (d) window snapshots written under ``:mesh:proc2xdata1``
    (the fleet's) and ``:mesh:data1`` (one process, ``shard.devices=all``)
    resumed unsharded: refused without ``shard.reshard.on.restore``, and
    with it phase 13's windows from the restore on; (e) streamed
    LogisticRegressionJob over the fleet within the LR contract of phase
    11's one-process history; (f) the join against a bound socket that
    never listens raises ``LaunchError`` within its 3 s timeout; one
    ``fleet`` JSON line;
18. (after 17; ~60–120 s) the serving fleet on the card, over phase 12c's
    models and rows, every worker a serving CLI process with its own CUDA
    context on ``cuda:0`` (those that serve kNN inside ``chip_smoke.py
    --serve-worker``, which sets the launch counts to 0 before the CLI
    loads and warms and writes them out after SIGTERM).  A serving conf holds
    one schema, so: (a) two ``python -m avenir_tpu_torch.launch --serve
    --nprocs 2 --http-port 0`` fleets side by side, ``knn`` over phase
    8a's 1M references (B5) and ``knn10k`` over 8b's 10K (B6): the rows
    POSTed to each router answer as phase 12c's replays, ``/healthz``
    aggregates both workers, ``/metrics`` carries ``worker="router"``,
    the workers' ``/stats`` requests sum to the rows, each worker's own
    B5/B6 count equals its 7 warmed buckets plus its ``/stats``
    dispatches (between ceil(requests / 8) and requests: the router's 8
    client threads POST single rows), and after SIGTERM the merged
    ``fleet-<run>.jsonl`` holds one ``serve.request`` span per router
    rid; (b) NB and the tree behind an in-process ``GlobalRouter`` over
    the port's ``WorkerSpawner`` with ``fleet.pool.autoscale.on`` (min
    2): ``w0`` SIGKILLed a quarter into 2,000 NB requests, every answer
    phase 12c's, none lost or doubled, ``failovers`` ≥ 1, a
    ``fleet.pool.scale`` up/replace and the replacement answering; (c)
    ``POST /swap`` of NB to a second artifact through the router: both
    live workers at version 2, ready capacity at the floor or above, and
    both answering as the new artifact's batch predictor; (d) a RESP
    server in this process on port 0 and two serving CLI workers with
    ``serve.request.queue`` (NB and ``knn10k``): LPUSHed rows answer as
    phase 12c's replays, each worker's requests equal the rows and its own
    counts its warmed buckets plus dispatches (B6; none for NB), and the
    lead-gen loop over
    the three ``Redis*`` transports equals the loop over ``InProcQueue``s;
    (e) ``ProcessServingFleet`` (2 forked workers, each a bad fork of this
    CUDA process where any CUDA call raises) equals
    ``ShardedServingFleet``; one ``serve_fleet`` JSON line with every
    wall and the routers' ``stats()``;
19. print a ``walls_s`` JSON line (the native encoder's build, native
    against Python encode, phases 3, 4, 5b, 5c, 8, 11, 11b, 12b, 12c,
    13, 14, 15, 16, 17 and 18's walls) with the card's name and power limit,
    then the kernels' JSON line (B1's and B4's launches also by phase 12's
    traced paths, B1's by 12b's planned paths, 13's stream and tenant
    paths, 14's sharded paths, 15's ``auto_*`` paths and 17's ``fleet_*``
    paths by rank, B2's by 17's ``fleet_mi_wide`` ranks, B4's by 15's
    tree jobs and 13's tree refit, B5's and B6's by 12c's serving paths,
    16's ``mm_*`` paths and 18's ``serve_fleet_w<k>`` workers (B6's also
    by 18's ``serve_resp`` worker) and B5's by 13's tenant path), its numbers
    from the main-path cases of phases 6 and 9 (B1: a hospital MI chunk;
    B2: a 20 × 20 × 2 MI chunk; B3: the wide tree's K = 8 level; B4: the
    hospital tree's deepest level, with the forest's launches and its
    deepest level under ``forest``; B5: the 1M-row NearestNeighbor job;
    B6: the 10K-row NearestNeighbor job) and one entry per probe
    (``launches`` 0: no path runs them), then the last line
    ``{"ok": true, "device": {...}}``.

Bounds: B1–B4 count the work their inputs need, a sparse product — codes
and labels (selectors) read once, G (the level table) written once, over
the memory rate — with the dense product of the one-hots beside it as
``dense_ops_bound_ms``; B5–B6 their bf16 operations over the used
lanes.

``--b4`` runs B4 alone, in about a minute with its build: phase 2's B4
cases, the hospital tree's level tables (``DecisionTree.fit`` on 1M seeded
hospital rows, held and timed as phase 6 holds them) and the host µs of a
1-row call, printed as one JSON line.  It measures the package beside the
script, so to hold a change against its parent on one card, copy this
file into an unpacked parent (``git archive``) and run both copies in one
call: parent, change, change, parent.

Each phase that drives a path sets every launch count to 0 just before it
and reads the counts just after.  It imports nothing of JAX and nothing of
the JAX package, and exits non-zero without printing a result when no CUDA
device is available.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

MI_TOL = 2e-6            # MI numbers: float32 statistics printed to 6 places
SCORE_TOL = 1e-6         # tree split scores (the tree contract)
ROWS_E2E = 1_000_000
CHUNK_ROWS = 250_000
KNN_REFS = 1_000_000     # the repo's kNN width (benchmarks/knn_qps.py)
KNN_BATCH = 4096
KNN_CPU_ROWS = 1024      # the --device cpu run's share of the 1M-ref job
KNN_K = 10
DIST_TOL = 1e-6          # distances of rows the exact scan served
PAD_D2 = 1e29            # d² of a pad reference (ops/knn.py's _PADC, 1e30)
KEY_TOL = 1e-5           # |Δd²| of two float32 summation orders (B5, B6)
KERNEL_SOURCES = ("cooc_pair", "cross", "knn_tourney", "knn_topk", "gram_probe")
# launch counts: kernel id → (ops module, wrapper, attribute)
COUNTS = {"B1": ("hist", "cooc_counts_cols", "launches"),
          "B2": ("hist", "cooc_counts_cols", "cls_launches"),
          "B3": ("hist", "cooc_counts_cols", "clsb_launches"),
          "B4": ("hist", "cross_cooc_counts_cols", "launches"),
          "B5": ("knn", "knn_tourney", "launches"),
          "B6": ("knn", "knn_topk", "launches")}
# the main path of each kernel in the kernels line: (path, which call)
MAIN_PATH = {"B1": ("mi", "first"), "B2": ("mi_wide", "first"),
             "B3": ("wide_tree", "first"), "B4": ("tree", "last"),
             "B5": ("knn_job", "first"), "B6": ("knn_small_nn", "first")}


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median per-call ms over ``iters`` calls, each bracketed by CUDA
    events (``avenir_tpu_torch.probes.time_ms``)."""
    from avenir_tpu_torch.probes import time_ms as probe_time_ms

    return probe_time_ms(fn, iters, warmup)


def make_case(n, f, b, c, invalid, seed, skew=0.0):
    """Seeded codes [F, n] and labels [n] on the card; with ``skew`` > 0
    that share of the codes is moved into one bin (b // 2)."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    codes = torch.randint(0, b, (f, n), dtype=torch.int32, device="cuda",
                          generator=gen)
    if skew:
        hot = torch.rand((f, n), device="cuda", generator=gen) < skew
        codes[hot] = b // 2
    labels = torch.randint(0, c, (n,), dtype=torch.int32, device="cuda",
                           generator=gen)
    if invalid and n:
        k = max(n // 50, 1)
        for val in (-1, b, b + 7):                 # dropped cells
            rows = torch.randint(0, n, (k,), device="cuda", generator=gen)
            feats = torch.randint(0, f, (k,), device="cuda", generator=gen)
            codes[feats, rows] = val
        for val in (-1, c):                        # dropped rows
            labels[torch.randint(0, n, (k,), device="cuda", generator=gen)] = val
    return codes, labels


def library_gram(codes, labels, b, c):
    """(call, buffers) for the yardstick: ``call()`` is one torch._int_mm
    XᵀX on the int8 one-hot X materialized in device memory, laid out per
    plan(); ``buffers`` keeps X alive while it is timed."""
    import torch

    from avenir_tpu_torch.ops import hist

    f, n = codes.shape
    mode, jcp, wp = hist.plan(f, b, c)
    wf = torch.as_tensor(hist.w_index(f, b, c), device="cuda")   # [F, B, C]
    ok = ((labels >= 0) & (labels < c))[None, :] & (codes >= 0) & (codes < b)
    w = wf[torch.arange(f, device="cuda")[:, None],
           codes.clamp(0, b - 1).long(), labels.clamp(0, c - 1).long()[None, :]]
    npad = -(-n // 8) * 8                  # _int_mm needs K % 8 == 0
    x = torch.zeros((npad, wp), dtype=torch.int8, device="cuda")
    rows = torch.arange(n, device="cuda")[None, :].expand(f, n)
    x[rows[ok], w[ok]] = 1
    del w, ok, rows
    xt = x.t().contiguous()
    return (lambda: torch._int_mm(xt, x)), (x, xt)


def kernel_cases(hist):
    """Phase 2: B1 against its plain version on the card."""
    import torch

    cases = [
        ("hospital 16M rows (fmaj, wp 384)", 16_000_000, 11, 12, 2, False, 0.0),
        # the CSV job's own shape (10 binned features × 13 bins × 2 classes,
        # also fmaj, wp 384) at the chunk the main path hands the kernel
        ("10x13x2 at 250K rows (fmaj, wp 384)", CHUNK_ROWS, 10, 13, 2,
         False, 0.0),
        ("jmaj 20x3x2, 1M rows (wp 128)", 1 << 20, 20, 3, 2, False, 0.0),
        # the wide tree's K = 1 level (30 features × 8 bins × 2 classes)
        ("wide tree K = 1 shape 30x8x2, 1M rows (jmaj, wp 512)", 1_000_000,
         30, 8, 2, False, 0.0),
        ("ragged 100003 rows, invalid codes and labels", 100_003, 11, 12, 2,
         True, 0.0),
        ("jmaj 20x3x2 ragged 100003 rows, invalid codes and labels",
         100_003, 20, 3, 2, True, 0.0),
        ("skewed 10x13x2, 95% in one bin, 1M rows (fmaj)", 1_000_000, 10,
         13, 2, True, 0.95),
        ("skewed 30x8x2, 95% in one bin, 1M rows (jmaj)", 1_000_000, 30, 8,
         2, True, 0.95),
        ("zero rows", 0, 11, 12, 2, False, 0.0),
        ("jmaj zero rows", 0, 20, 3, 2, False, 0.0),
        # one class, as the correlation jobs count feature pairs: churn
        # (5 features, 6 bins with the unseen-value bin) and the hospital
        ("C = 1: churn pairs 5x6x1 at 250K rows (jmaj, wp 128)", CHUNK_ROWS,
         5, 6, 1, False, 0.0),
        ("C = 1: hospital pairs 10x13x1 at 250K rows (fmaj, wp 384)",
         CHUNK_ROWS, 10, 13, 1, False, 0.0),
        ("C = 1: ragged 100003 rows, invalid codes and labels", 100_003, 10,
         13, 1, True, 0.0),
    ]
    results = []
    for i, (label, n, f, b, c, invalid, skew) in enumerate(cases):
        codes, labels = make_case(n, f, b, c, invalid, seed=i, skew=skew)
        mode, jcp, wp = hist.plan(f, b, c)
        assert mode in ("fmaj", "jmaj"), (label, mode)
        reset_counts()
        g = hist.cooc_counts_cols(codes, labels, b, c)
        if read_counts() != only(B1=1 if n else 0):
            raise AssertionError(f"B1 did not launch once on {label}: "
                                 f"{read_counts()}")
        ref = hist.cooc_counts_cols_ref(codes, labels, b, c)
        torch.cuda.synchronize()
        err = int((g.long() - ref.long()).abs().max()) if g.numel() else 0
        if not torch.equal(g, ref):
            raise AssertionError(f"B1 disagrees with its plain version on "
                                 f"{label}: max |diff| {err}")
        big = n >= 1_000_000
        ms = time_ms(lambda: hist.cooc_counts_cols(codes, labels, b, c),
                     iters=10 if big else 20)
        plain_ms = time_ms(
            lambda: hist.cooc_counts_cols_ref(codes, labels, b, c),
            iters=3 if big else 5, warmup=1)
        library_ms = None
        if n:
            call, keep = library_gram(codes, labels, b, c)
            lib_g = call()
            torch.cuda.synchronize()
            if not torch.equal(lib_g, g):
                raise AssertionError(f"library yardstick disagrees on {label}")
            library_ms = time_ms(call, iters=5 if big else 20)
            del keep, lib_g
        row = {"kernel": "B1", "case": label, "n": n, "f": f, "b": b, "c": c,
               "mode": mode, "skew": skew,
               "wp": wp, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               **gram_bound(f, n, wp * wp, f * b * c, n)}
        log("B1 case:", json.dumps(row))
        results.append(row)
        del codes, labels, g, ref
        torch.cuda.empty_cache()
    return results


def gram_bound(f: int, n: int, g_cells: int, used: int, n_eff: int) -> dict:
    """The bound of a one-hot gram (B1–B3) as the work these inputs need
    (``hist.gram_work``, which the profiler's analytic ``scan.chunk`` cost
    reads too): a sparse product, so the codes [F, n] and labels [n] read
    once and G (``g_cells`` int32) written once, over the memory rate.
    Beside it, as ``dense_ops_bound_ms``, the dense product of the
    one-hots: an int8 multiply-add per row for each upper-triangle cell of
    the ``used`` lanes, over ``n_eff`` rows, at the int8 peak."""
    from avenir_tpu_torch.ops import hist

    nbytes, ops = hist.gram_work(f, n, g_cells, used, n_eff)
    return {"bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
            "dense_ops_bound_ms": ops / PEAK_INT8_OPS * 1e3}


def write_props(path: str, props: dict) -> str:
    """A properties file of ``props`` (keys whose value is None left out)."""
    with open(path, "w") as fh:
        fh.write("".join(f"{k}={v}\n" for k, v in props.items()
                         if v is not None))
    return path


def ops_module(name: str):
    import importlib

    return importlib.import_module(f"avenir_tpu_torch.ops.{name}")


def reset_counts() -> None:
    for mod, fn, attr in COUNTS.values():
        setattr(getattr(ops_module(mod), fn), attr, 0)


def read_counts() -> dict:
    return {k: getattr(getattr(ops_module(mod), fn), attr)
            for k, (mod, fn, attr) in COUNTS.items()}


def only(**launches) -> dict:
    """The counts of a run that launched these kernels and no other."""
    return {k: launches.get(k, 0) for k in COUNTS}


class Recorder:
    """Keeps the arguments of every call a driven path makes to the kernel
    wrappers (the two count wrappers, B5's and B6's), which run and count
    as before, so that phases 6 and 9 can hold each kernel against its
    plain version on the path's own inputs.

    A wrapper counts its launches on its module-level name, which is the
    shim while the shim is on: the shim starts with the wrapper's counts
    (``functools.wraps`` copies them) and hands them back when it comes
    off."""

    WRAPPERS = (("hist", "cooc_counts_cols"), ("hist", "cross_cooc_counts_cols"),
                ("knn", "knn_tourney"), ("knn", "knn_topk"))

    def __init__(self):
        self.calls = []                    # (wrapper name, path, args)

    @contextlib.contextmanager
    def on(self, path: str):
        import functools

        saved = {(mod, name): getattr(ops_module(mod), name)
                 for mod, name in self.WRAPPERS}

        def shim(name, fn):
            @functools.wraps(fn)
            def call(*args, **kwargs):
                self.calls.append((name, path, args, kwargs))
                return fn(*args, **kwargs)
            return call

        for (mod, name), fn in saved.items():
            setattr(ops_module(mod), name, shim(name, fn))
        try:
            yield
        finally:
            for (mod, name), fn in saved.items():
                shim = getattr(ops_module(mod), name)
                for attr in vars(fn):
                    setattr(fn, attr, getattr(shim, attr))
                setattr(ops_module(mod), name, fn)


def bound(nbytes: float, ops: float):
    """(bound ms, what bounds it) at the published H100 peaks."""
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    ops_ms = ops / PEAK_INT8_OPS * 1e3
    return max(bytes_ms, ops_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def per_class_library(codes, labels, b, c):
    """(call, buffers) for the B2/B3 yardstick: ``call()`` is one
    torch._int_mm X_cᵀX_c per class on the int8 one-hot X_c of class c's
    rows, materialized in device memory beforehand, laid out per plan()."""
    import torch

    from avenir_tpu_torch.ops import hist

    f, n = codes.shape
    _mode, _jcp, wp = hist.plan(f, b, c)
    w2 = torch.as_tensor(hist.w_index(f, b, c)[:, :, 0], device="cuda")
    feats = torch.arange(f, device="cuda")[:, None]
    mats = []
    for k in range(c):
        rows = (labels == k).nonzero()[:, 0]
        ck = codes[:, rows]
        nk = rows.numel()
        ok = (ck >= 0) & (ck < b)
        w = w2[feats, ck.clamp(0, b - 1).long()]
        x = torch.zeros((max(-(-nk // 8) * 8, 8), wp), dtype=torch.int8,
                        device="cuda")
        r = torch.arange(nk, device="cuda")[None, :].expand(f, nk)
        x[r[ok], w[ok]] = 1
        del ck, ok, w, r
        mats.append((x.t().contiguous(), x))
    return (lambda: torch.stack([torch._int_mm(xt, x) for xt, x in mats])), mats


def per_class_cases(hist):
    """Phase 2: B2 and B3 against the plain version on the card."""
    import torch

    cases = [
        ("B2", "20x20x2 at 4M rows (cls, wp 512)", 4_000_000, 20, 20, 2, False,
         0.0),
        ("B2", "20x20x2 at 250K rows (cls, wp 512)", CHUNK_ROWS, 20, 20, 2,
         False, 0.0),
        ("B2", "ragged 100003 rows, invalid codes and labels (cls)", 100_003,
         20, 20, 2, True, 0.0),
        ("B2", "zero rows (cls)", 0, 20, 20, 2, False, 0.0),
        ("B3", "100x20x2 at 1M rows (clsb, wp 2000, TR 400)", 1_000_000,
         100, 20, 2, False, 0.0),
        ("B3", "ragged 100003 rows, invalid codes and labels (clsb)", 100_003,
         100, 20, 2, True, 0.0),
        ("B3", "zero rows (clsb)", 0, 100, 20, 2, False, 0.0),
        # most rows in one bin: the pair tables' atomics meet on one cell
        ("B2", "skewed 20x20x2 at 1M rows, 95% of codes in one bin (cls)",
         1_000_000, 20, 20, 2, True, 0.95),
        ("B3", "skewed 100x20x2 at 1M rows, 95% of codes in one bin (clsb)",
         1_000_000, 100, 20, 2, True, 0.95),
        # a 3072 x 3072 pair table exceeds shared memory: f1's bins in bands
        ("B3", "banded pairs 2x3072x2 at 100K rows (clsb, wp 6144)", 100_000,
         2, 3072, 2, True, 0.0),
    ]
    results = []
    for i, (kid, label, n, f, b, c, invalid, skew) in enumerate(cases):
        codes, labels = make_case(n, f, b, c, invalid, seed=100 + i, skew=skew)
        mode, _jcp, wp = hist.plan(f, b, c)
        assert mode == ("cls" if kid == "B2" else "clsb"), (label, mode)
        reset_counts()
        g = hist.cooc_counts_cols(codes, labels, b, c)
        if read_counts()[kid] != (1 if n else 0):
            raise AssertionError(f"{kid} did not launch once on {label}")
        ref = hist.cooc_counts_cols_ref(codes, labels, b, c)
        torch.cuda.synchronize()
        err = int((g.long() - ref.long()).abs().max()) if n else 0
        if not torch.equal(g, ref):
            raise AssertionError(f"{kid} disagrees with its plain version on "
                                 f"{label}: max |diff| {err}")
        big = n >= 1_000_000
        ms = time_ms(lambda: hist.cooc_counts_cols(codes, labels, b, c),
                     iters=10 if big else 20)
        plain_ms = time_ms(
            lambda: hist.cooc_counts_cols_ref(codes, labels, b, c),
            iters=3 if big else 5, warmup=1)
        library_ms = None
        if n:
            call, keep = per_class_library(codes, labels, b, c)
            if not torch.equal(call(), g):
                raise AssertionError(f"library yardstick disagrees on {label}")
            library_ms = time_ms(call, iters=5 if big else 20)
            del keep
        # the dense form: each row adds one int8 multiply-add to each
        # upper-triangle cell of its own class's F·B used lanes
        row = {"kernel": kid, "case": label, "n": n, "f": f, "b": b, "c": c,
               "mode": mode, "wp": wp, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               **gram_bound(f, n, c * wp * wp, f * b, n)}
        log(f"{kid} case:", json.dumps(row))
        results.append(row)
        del codes, labels, g, ref
        torch.cuda.empty_cache()
    return results


def make_cross_case(n, f, b, s, invalid, seed, skew=0.0, offset=0):
    """Seeded codes [F, n] and selectors [n] on the card.  ``skew``: that
    share of the rows has every code in one bin and one selector;
    ``offset``: both are contiguous views that start ``offset`` int32 into
    their buffers (4-byte aligned, not 16)."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    codes = torch.empty(offset + f * n, dtype=torch.int32, device="cuda")
    sel = torch.empty(offset + n, dtype=torch.int32, device="cuda")
    codes, sel = codes[offset:].view(f, n), sel[offset:]
    codes.random_(0, b, generator=gen)
    sel.random_(0, s, generator=gen)
    if skew and n:
        hot = torch.rand(n, device="cuda", generator=gen) < skew
        codes[:, hot] = b // 2
        sel[hot] = s // 2
    if invalid and n:
        k = max(n // 50, 1)
        for val in (-1, b, b + 7):                 # dropped cells
            rows = torch.randint(0, n, (k,), device="cuda", generator=gen)
            feats = torch.randint(0, f, (k,), device="cuda", generator=gen)
            codes[feats, rows] = val
        for val in (-1, s, s + 9):                 # dropped rows
            sel[torch.randint(0, n, (k,), device="cuda", generator=gen)] = val
    return codes, sel


def cross_library(codes, sel, b, s):
    """(call, buffers) for the B4 yardstick: ``call()`` is one
    torch.bincount over the composite (f·B + bin)·S + sel index of the
    valid cells, built beforehand."""
    import torch

    f = codes.shape[0]
    ok = ((sel >= 0) & (sel < s))[None, :] & (codes >= 0) & (codes < b)
    idx = ((torch.arange(f, device=codes.device)[:, None] * b
            + codes.long()) * s + sel.long()[None, :])[ok]
    return (lambda: torch.bincount(idx, minlength=f * b * s)), idx


def cross_bound(f: int, n: int, b: int, s: int, n_eff: int) -> dict:
    """B4's bound as the work these inputs need (``hist.cross_work``), a
    sparse product: the codes [F, n] and selectors [n] read once and the
    [F, B, S] table written once, over the memory rate.  Beside it, as
    ``dense_ops_bound_ms``, the dense XᵀY form: 2·F·B·S int8
    multiply-adds for each of the ``n_eff`` rows that count."""
    from avenir_tpu_torch.ops import hist

    nbytes, ops = hist.cross_work(f, n, b, s, n_eff)
    return {"bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
            "dense_ops_bound_ms": ops / PEAK_INT8_OPS * 1e3}


def cross_cases(hist):
    """Phase 2: B4 against its plain version on the card."""
    import torch

    cases = [
        # label, n, F, B, S, invalid codes and selectors, skewed share of
        # the rows, view offset
        ("10x13, 2 selectors at 1M rows (hospital root)", 1_000_000, 10, 13, 2,
         False, 0.0, 0),
        ("10x13, 16 selectors at 1M rows (hospital depth 4)", 1_000_000, 10,
         13, 16, False, 0.0, 0),
        ("10x13, 18 selectors at 1M rows", 1_000_000, 10, 13, 18, False,
         0.0, 0),
        ("10x13, 54 selectors at 1M rows", 1_000_000, 10, 13, 54, False,
         0.0, 0),
        ("10x13, 1024 selectors at 1M rows (the gate)", 1_000_000, 10, 13,
         1024, False, 0.0, 0),
        ("24x32, 1024 selectors at 1M rows (the gate, widest X)", 1_000_000,
         24, 32, 1024, False, 0.0, 0),
        ("ragged 100003 rows, invalid codes and selectors", 100_003, 10, 13,
         54, True, 0.0, 0),
        ("views at a 4-byte offset, 1000001 rows, invalid", 1_000_001, 10,
         13, 16, True, 0.0, 1),
        ("skewed: every row in one bin and selector, 1M rows", 1_000_000, 10,
         13, 16, False, 1.0, 0),
        ("skewed: 90% of rows in one bin and selector, 1M rows", 1_000_000,
         10, 13, 16, False, 0.9, 0),
        ("one row (the wrapper's floor)", 1, 10, 13, 16, False, 0.0, 0),
        ("zero rows (cross)", 0, 10, 13, 54, False, 0.0, 0),
    ]
    results = []
    for i, (label, n, f, b, s, invalid, skew, offset) in enumerate(cases):
        codes, sel = make_cross_case(n, f, b, s, invalid, seed=200 + i,
                                     skew=skew, offset=offset)
        reset_counts()
        t = hist.cross_cooc_counts_cols(codes, sel, b, s)
        if read_counts()["B4"] != (1 if n else 0):
            raise AssertionError(f"B4 did not launch once on {label}")
        ref = hist.cross_cooc_counts_cols_ref(codes, sel, b, s)
        torch.cuda.synchronize()
        err = int((t.long() - ref.long()).abs().max()) if n else 0
        if not torch.equal(t, ref):
            raise AssertionError(f"B4 disagrees with its plain version on "
                                 f"{label}: max |diff| {err}")
        ms = time_ms(lambda: hist.cross_cooc_counts_cols(codes, sel, b, s),
                     iters=50 if n < 1000 else 20)
        plain_ms = time_ms(
            lambda: hist.cross_cooc_counts_cols_ref(codes, sel, b, s),
            iters=5, warmup=1)
        library_ms = None
        if n:
            call, keep = cross_library(codes, sel, b, s)
            if not torch.equal(call().to(torch.int32).reshape(f, b, s), t):
                raise AssertionError(f"library yardstick disagrees on {label}")
            library_ms = time_ms(call, iters=20)
            del keep
        n_eff = int((((sel >= 0) & (sel < s))
                     & ((codes >= 0) & (codes < b)).any(0)).sum())
        row = {"kernel": "B4", "case": label, "n": n, "f": f, "b": b,
               "num_sel": s, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               **cross_bound(f, n, b, s, n_eff)}
        log("B4 case:", json.dumps(row))
        results.append(row)
        del codes, sel, t, ref
        torch.cuda.empty_cache()
    return results


def run_cli(argv):
    """The port's CLI entry in this process; returns its stdout."""
    from avenir_tpu_torch.__main__ import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"CLI {argv[0]} exited {rc}")
    return buf.getvalue()


def counter(out: str, name: str) -> int:
    for line in out.splitlines():
        if line.strip().startswith(name + "="):
            return int(line.strip().split("=", 1)[1])
    raise AssertionError(f"counter {name} missing from job output:\n{out}")


def compare_mi(a_path: str, b_path: str) -> float:
    """Field-by-field MI part-file comparison; returns the max numeric diff."""
    with open(a_path) as fa, open(b_path) as fb:
        a, b = fa.read().splitlines(), fb.read().splitlines()
    if len(a) != len(b):
        raise AssertionError(f"MI part files differ in length: {len(a)} vs {len(b)}")
    worst = 0.0
    for la, lb in zip(a, b):
        fa_, fb_ = la.split(","), lb.split(",")
        if len(fa_) != len(fb_):
            raise AssertionError(f"MI lines differ: {la!r} vs {lb!r}")
        for x, y in zip(fa_, fb_):
            try:
                dx = abs(float(x) - float(y))
            except ValueError:
                if x != y:
                    raise AssertionError(f"MI lines differ: {la!r} vs {lb!r}")
                continue
            if dx > MI_TOL:
                raise AssertionError(f"MI numbers differ by {dx}: {la!r} vs {lb!r}")
            worst = max(worst, dx)
    return worst


def same_bytes(a: str, b: str, what: str) -> None:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError(f"{what} part files differ between cuda and cpu")


def jobs_phase(hist, rec: Recorder, work: str, walls: dict):
    """Phase 3: the three CLI jobs on cuda, then on the CPU; returns B1's
    launches in the cuda run and puts each job's wall into ``walls``."""
    from avenir_tpu_torch.core.csv_io import write_csv
    from avenir_tpu_torch.datagen.hosp_readmit import (HOSP_SCHEMA_JSON,
                                                      generate_hosp_readmit)

    t0 = time.perf_counter()
    rows = generate_hosp_readmit(ROWS_E2E + 100_000, seed=11)
    train, test = os.path.join(work, "train.csv"), os.path.join(work, "test.csv")
    write_csv(train, rows[:ROWS_E2E])
    write_csv(test, rows[ROWS_E2E:])
    schema = os.path.join(work, "hosp.json")
    with open(schema, "w") as fh:
        json.dump(HOSP_SCHEMA_JSON, fh)
    log(f"jobs: generated {ROWS_E2E} training rows in "
        f"{time.perf_counter() - t0:.1f} s")
    common = [f"-Dfeature.schema.file.path={schema}",
              f"-Dstream.chunk.rows={CHUNK_ROWS}"]
    out = {}
    launches = None
    for dev in ("cuda", "cpu"):
        o = lambda name: os.path.join(work, f"{dev}_{name}")
        if dev == "cuda":
            reset_counts()                     # the main path's run only
        t0 = time.perf_counter()
        run_cli(["BayesianDistribution", *common, train, o("nb"), "--device", dev])
        t_nb = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred_out = run_cli(["BayesianPredictor", *common,
                            f"-Dbayesian.model.file.path={o('nb')}",
                            "-Dprediction.mode=validation",
                            test, o("pred"), "--device", dev])
        t_pred = time.perf_counter() - t0
        t0 = time.perf_counter()
        with rec.on("mi") if dev == "cuda" else contextlib.nullcontext():
            mi_out = run_cli(
                ["MutualInformation", *common,
                 "-Dmutual.info.score.algorithms=mim,mifs,jmi,disr,mrmr",
                 train, o("mi"), "--device", dev])
        t_mi = time.perf_counter() - t0
        # the stream's chunks; each is one retried task, and so is the read
        # that finds the end of the file
        chunks = -(-ROWS_E2E // CHUNK_ROWS)
        if counter(mi_out, "attempts") != chunks + 1:
            raise AssertionError(f"MI job's stream ran "
                                 f"{counter(mi_out, 'attempts')} tasks for "
                                 f"{chunks} chunks")
        walls[f"{dev} BayesianDistribution"] = t_nb
        walls[f"{dev} BayesianPredictor"] = t_pred
        walls[f"{dev} MutualInformation"] = t_mi
        if dev == "cuda":
            counts = read_counts()
            launches = counts["B1"]
            if counts != only(B1=chunks):
                raise AssertionError(f"NB + MI jobs launched {counts}")
            if launches != chunks:
                raise AssertionError(f"B1 launched {launches} times for "
                                     f"{chunks} MI chunks")
        if counter(mi_out, "Processed") != ROWS_E2E:
            raise AssertionError("MI job did not process every row")
        log(f"jobs on {dev}: BayesianDistribution {t_nb:.2f} s, "
            f"BayesianPredictor {t_pred:.2f} s (accuracy "
            f"{counter(pred_out, 'accuracy')}), MutualInformation "
            f"{t_mi:.2f} s over {chunks} chunks")
        out[dev] = {k: os.path.join(o(k), "part-00000") for k in ("nb", "pred", "mi")}
    same_bytes(out["cuda"]["nb"], out["cpu"]["nb"], "NB model")
    same_bytes(out["cuda"]["pred"], out["cpu"]["pred"], "NB prediction")
    worst = compare_mi(out["cuda"]["mi"], out["cpu"]["mi"])
    with open(out["cuda"]["mi"]) as fh:
        mi_lines = fh.read().splitlines()
    # per feature one featureClassMI line, per pair three, per scorer a
    # header and one line per feature
    f = sum(line.startswith("featureClassMI,") for line in mi_lines)
    if f != 10 or len(mi_lines) != f + 3 * (f * (f - 1) // 2) + 5 * (f + 1):
        raise AssertionError(f"MI part file has {len(mi_lines)} lines for "
                             f"{f} features")
    log(f"jobs: NB model and predictions byte-identical cuda vs cpu; MI "
        f"fields equal, max numeric diff {worst}")
    return launches, train, test, schema


def wide_dataset(n: int, f: int, b: int, seed: int):
    """A seeded [n, f] dataset of b-bin codes whose binary label depends on
    the first six features, so every frontier node has a split to take."""
    import numpy as np

    from avenir_tpu_torch.core.encoding import EncodedDataset

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b, size=(n, f)).astype(np.int32)
    logit = (codes[:, :6] - (b - 1) / 2) @ np.array([1.0, -0.8, 0.6, -0.5,
                                                      0.4, 0.3])
    labels = (logit + rng.normal(0, 2.0, n) > 0).astype(np.int32)
    return EncodedDataset(
        codes=codes, cont=np.zeros((n, 0), np.float32), labels=labels,
        n_bins=np.full(f, b, np.int32), class_values=["0", "1"],
        binned_ordinals=list(range(f)))


def mi_wide_phase(hist, rec: Recorder) -> int:
    """Phase 3b: MutualInformation on a 20 × 20 × 2 schema (plan: cls) on
    cuda and cpu; returns B2's launches on cuda."""
    import numpy as np

    from avenir_tpu_torch.models import mutual_info as mi

    ds = wide_dataset(ROWS_E2E, 20, 20, seed=12)
    chunks = [ds.slice(s, s + CHUNK_ROWS) for s in range(0, ROWS_E2E, CHUNK_ROWS)]
    reset_counts()
    t0 = time.perf_counter()
    with rec.on("mi_wide"):
        got = mi.MutualInformation(device="cuda").fit(chunks)
    t_cuda = time.perf_counter() - t0
    counts = read_counts()
    if counts != only(B2=len(chunks)):
        raise AssertionError(f"MI 20x20x2 launched {counts} for "
                             f"{len(chunks)} chunks")
    t0 = time.perf_counter()
    want = mi.MutualInformation(device="cpu").fit(chunks)
    t_cpu = time.perf_counter() - t0
    for name in ("class_counts", "feature_class_counts", "pair_class_counts"):
        if not np.array_equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"MI 20x20x2 {name} differ cuda vs cpu")
    worst = 0.0
    for name in ("feature_class_mi", "feature_pair_mi", "pair_class_mi",
                 "feature_pair_class_cond_mi"):
        worst = max(worst, float(np.abs(getattr(got, name)
                                        - getattr(want, name)).max()))
    if worst > MI_TOL:
        raise AssertionError(f"MI 20x20x2 statistics differ by {worst}")
    log(f"MI 20x20x2 over {len(chunks)} chunks of {CHUNK_ROWS} rows: cuda "
        f"{t_cuda:.2f} s, cpu {t_cpu:.2f} s; counts byte-identical, max MI "
        f"diff {worst}; B2 launched {counts['B2']} times")
    return counts["B2"]


def same_tree(a: str, b: str, what: str) -> float:
    """The tree contract: equal JSON but for node scores within SCORE_TOL;
    returns the largest score difference."""
    ja, jb = json.loads(a), json.loads(b)
    na, nb = ja.pop("nodes"), jb.pop("nodes")
    if ja != jb or len(na) != len(nb):
        raise AssertionError(f"{what}: trees differ ({len(na)} vs {len(nb)} "
                             f"nodes)")
    worst = 0.0
    for x, y in zip(na, nb):
        d = abs(x.pop("score") - y.pop("score"))
        if x != y or d > SCORE_TOL:
            raise AssertionError(f"{what}: node {x['id']} differs: {x} vs {y}")
        worst = max(worst, d)
    return worst


def tree_phase_table(out: str) -> dict:
    """TreePhase counters of a DecisionTreeBuilder run → {level: (table,
    select, partition) µs}."""
    levels: dict = {}
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("level.") and ".us=" in line:
            key, val = line.split("=")
            _, lv, phase, _ = key.split(".")
            levels.setdefault(int(lv), {})[phase] = int(val)
    return {lv: (v["table"], v["select"], v["partition"])
            for lv, v in sorted(levels.items())}


def tree_jobs_phase(hist, rec: Recorder, work: str, train: str, test: str,
                    schema: str, job_walls: dict) -> dict:
    """Phase 4: the tree jobs through the CLI on cuda and cpu; returns
    B4's launches on cuda by job (each job's counts are reset just before
    it) and puts each job's wall into ``job_walls``."""
    common = [f"-Dfeature.schema.file.path={schema}"]
    jobs = [
        ("tree", ["DecisionTreeBuilder", *common, "-Dtree.hist.phase.stats=true",
                  train]),
        ("tree_bin", ["DecisionTreeBuilder", *common, "-Dsplit.search=binary",
                      "-Dtree.hist.mode=subtract",
                      "-Dtree.hist.phase.stats=true", train]),
        ("pred", ["DecisionTreeBuilder", *common,
                  "-Dprediction.mode=validation", test]),
        ("cpg", ["ClassPartitionGenerator", *common,
                 "-Doutput.split.prob=true", train]),
    ]
    b4 = {}
    out = {}
    for dev in ("cuda", "cpu"):
        o = lambda name: os.path.join(work, f"{dev}_{name}")  # noqa: E731
        walls = []
        for name, argv in jobs:
            argv = list(argv)
            if name == "pred":
                argv.insert(1, f"-Dtree.model.file.path={o('tree')}")
            reset_counts()
            t0 = time.perf_counter()
            with rec.on(name) if dev == "cuda" else contextlib.nullcontext():
                text = run_cli([*argv, o(name), "--device", dev])
            job_walls[f"{dev} {name}"] = time.perf_counter() - t0
            walls.append(f"{name} {job_walls[f'{dev} {name}']:.2f} s")
            counts = read_counts()
            levels = tree_phase_table(text)
            if dev == "cuda":
                # one level table per level of each fit, one for the
                # split-scoring job; the predictor builds none
                want = len(levels) if name.startswith("tree") else (
                    1 if name == "cpg" else 0)
                if counts != only(B4=want):
                    raise AssertionError(f"{name} on cuda launched {counts}, "
                                         f"expected B4 {want}")
                b4[name] = counts["B4"]
                for lv, (tab, sel, part) in levels.items():
                    log(f"TreePhase cuda {name} level {lv}: table {tab} us, "
                        f"select {sel} us, partition {part} us")
            if name == "pred":
                log(f"tree predict on {dev}: accuracy "
                    f"{counter(text, 'accuracy')}")
        log(f"tree jobs on {dev}: " + ", ".join(walls))
        out[dev] = {name: os.path.join(o(name), "part-00000")
                    for name, _ in jobs}
    for name in ("tree", "tree_bin"):
        with open(out["cuda"][name]) as fa, open(out["cpu"][name]) as fb:
            a, b = fa.read().splitlines(), fb.read().splitlines()
        if len(a) != 2 or len(b) != 2 or a[1] != b[1]:
            raise AssertionError(f"{name} model files differ in shape or "
                                 f"encoder state")
        d = same_tree(a[0], b[0], name)
        log(f"{name}: cuda and cpu trees agree ({len(json.loads(a[0])['nodes'])}"
            f" nodes, max score diff {d})")
    same_bytes(out["cuda"]["pred"], out["cpu"]["pred"], "tree prediction")
    worst = 0.0
    with open(out["cuda"]["cpg"]) as fa, open(out["cpu"]["cpg"]) as fb:
        a, b = fa.read().splitlines(), fb.read().splitlines()
    if len(a) != len(b) or not a:
        raise AssertionError("split files differ in length")
    for la, lb in zip(a, b):
        fa_, fb_ = la.split(";"), lb.split(";")
        if len(fa_) != len(fb_) or fa_[:2] != fb_[:2] or fa_[3:] != fb_[3:]:
            raise AssertionError(f"split lines differ: {la!r} vs {lb!r}")
        d = abs(float(fa_[2]) - float(fb_[2]))
        if d > MI_TOL:
            raise AssertionError(f"split scores differ by {d}: {la!r} vs {lb!r}")
        worst = max(worst, d)
    log(f"tree jobs: predictions byte-identical cuda vs cpu; {len(a)} split "
        f"lines equal, max score diff {worst}; B4 launched {b4}")
    return b4


def wide_tree_phase(hist, rec: Recorder) -> dict:
    """Phase 5: DecisionTree.fit on a 30 × 8 × 2 dataset at 1M rows on cuda
    (packed levels: B1, B2, B3) and cpu (plain); returns the cuda counts."""
    from avenir_tpu_torch.models import tree

    ds = wide_dataset(ROWS_E2E, 30, 8, seed=13)
    models, counts = {}, None
    for dev in ("cuda", "cpu"):
        trainer = tree.DecisionTree(max_depth=4, split_search="binary",
                                    level_packed="auto",
                                    collect_phase_stats=True, device=dev)
        reset_counts()
        t0 = time.perf_counter()
        with rec.on("wide_tree") if dev == "cuda" else contextlib.nullcontext():
            models[dev] = trainer.fit(ds).to_string()
        wall = time.perf_counter() - t0
        routes = [s["path"] + (":" + hist.pack_disjoint(
            s["contracted_slots"], 30, 8, 2).mode if s["path"] == "packed"
            else "") for s in trainer.level_stats]
        log(f"wide tree 30x8x2 on {dev}: {wall:.2f} s, routes {routes}")
        for s in trainer.level_stats:
            log(f"  level {s['level']}: frontier {s['frontier']}, table "
                f"{s['table_ms']} ms, select {s['select_ms']} ms, partition "
                f"{s['partition_ms']} ms")
        if dev == "cuda":
            counts = read_counts()
            if routes != ["packed:jmaj", "packed:cls", "packed:cls",
                          "packed:clsb"]:
                raise AssertionError(f"wide tree routes {routes}")
            if counts != only(B1=1, B2=2, B3=1):
                raise AssertionError(f"wide tree launched {counts}")
        elif routes != ["plain"] * 4:
            raise AssertionError(f"wide tree routes on cpu {routes}")
    d = same_tree(models["cuda"], models["cpu"], "wide tree")
    log(f"wide tree: cuda and cpu trees agree (max score diff {d}); "
        f"launches {counts}")
    return counts


def run_pipeline(argv) -> dict:
    """The port's pipeline CLI in this process; returns its counters as
    {stage: {group: {name: value}}}."""
    from avenir_tpu_torch.pipeline.__main__ import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"pipeline {argv} exited {rc}")
    out, stage, group = {}, None, None
    for line in buf.getvalue().splitlines():
        if line.startswith("stage "):
            stage = out.setdefault(line[len("stage "):], {})
        elif line.startswith("  "):
            group = stage.setdefault(line.strip(), {})
        elif line.startswith("\t"):
            k, v = line.strip().split("=", 1)
            group[k] = int(v)
    return out


def pipeline_conf(work: str, name: str, train: str, schema: str) -> str:
    """A properties file declaring the NB + MI pipeline over ``train``."""
    props = {
        "pipeline.stages": "nb,mi",
        "pipeline.bind.train": train,
        "pipeline.stage.nb.job": "BayesianDistribution",
        "pipeline.stage.nb.input": "train",
        "pipeline.stage.nb.output": "nb_model",
        "pipeline.stage.mi.job": "MutualInformation",
        "pipeline.stage.mi.input": "train",
        "pipeline.stage.mi.output": "mi_out",
        "feature.schema.file.path": schema,
        "stream.chunk.rows": str(CHUNK_ROWS),
        "mutual.info.score.algorithms": "mim,mifs,jmi,disr,mrmr",
    }
    return write_props(os.path.join(work, f"{name}.properties"), props)


def compare_rel(a_path: str, b_path: str, rtol: float) -> float:
    """Field-by-field comparison of two model files: text and integer
    fields equal, floats within ``rtol``; returns the largest relative
    difference."""
    with open(a_path) as fa, open(b_path) as fb:
        a, b = fa.read().splitlines(), fb.read().splitlines()
    if len(a) != len(b):
        raise AssertionError(f"model files differ in length: {len(a)} vs {len(b)}")
    worst = 0.0
    for la, lb in zip(a, b):
        fa_, fb_ = la.split(","), lb.split(",")
        if len(fa_) != len(fb_):
            raise AssertionError(f"model lines differ: {la!r} vs {lb!r}")
        for x, y in zip(fa_, fb_):
            if x == y:
                continue
            try:
                d = abs(float(x) - float(y)) / max(abs(float(y)), 1e-30)
            except ValueError:
                raise AssertionError(f"model lines differ: {la!r} vs {lb!r}")
            if "." not in x + y or d > rtol:
                raise AssertionError(f"model lines differ: {la!r} vs {lb!r}")
            worst = max(worst, d)
    return worst


def pipeline_phase(rec: Recorder, work: str, train: str, schema: str,
                   walls: dict) -> dict:
    """Phase 5b: the main path's host side and the fused pipeline on
    phase 3's 1M-row hospital CSV; returns B1's launches by path.

    (a) the native encoder against the Python one through
    ``Job.encode_input``; (b) ``python -m avenir_tpu_torch.pipeline run``
    with an NB and an MI stage in 250K-row chunks on cuda (one SharedScan,
    B1 once a chunk), its part files against phase 3's; (c) the same with
    ``scan.fuse=false``; (d) with ``stream.prefetch.depth=0``, and with
    the default depth 2 again, and the fused run's host side timed in
    parts (the retried stream alone, the staging alone, the scan of
    chunks already on the card); (e) a mixed schema (age, weight and height
    continuous) fused on cuda (``hist.gram_moments``), against the
    standalone BayesianDistribution on cuda and the fused run on the CPU."""
    import copy

    import numpy as np

    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.datagen.hosp_readmit import HOSP_SCHEMA_JSON
    from avenir_tpu_torch.jobs.base import Job
    from avenir_tpu_torch.ops import hist

    conf = JobConfig({"feature.schema.file.path": schema})
    t0 = time.perf_counter()
    _e, nat, _ = Job.encode_input(conf, train, need_rows=False)
    walls["native encode 1M"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _e, py, _ = Job.encode_input(conf, train)
    walls["python encode 1M"] = time.perf_counter() - t0
    for key in ("codes", "labels", "cont", "ids"):
        a, b = getattr(nat, key), getattr(py, key)
        if a.shape != b.shape or not np.array_equal(a.astype(b.dtype), b):
            raise AssertionError(f"native and Python encoders differ in {key}")
    log(f"pipeline (a): 1M rows encoded natively in "
        f"{walls['native encode 1M']:.3f} s, by the Python encoder in "
        f"{walls['python encode 1M']:.3f} s; arrays equal")
    del nat, py

    chunks = -(-ROWS_E2E // CHUNK_ROWS)
    fused_group = {"FusedStages": 2, "Scans": 1, "Chunks": chunks}
    path = pipeline_conf(work, "nb_mi", train, schema)
    parts = {}
    runs = (("fused", []), ("unfused", ["-Dscan.fuse=false"]),
            ("depth0", ["-Dstream.prefetch.depth=0"]), ("fused again", []))
    launches = {}
    for name, extra in runs:
        ws = os.path.join(work, "ws_" + name.replace(" ", "_"))
        reset_counts()
        t0 = time.perf_counter()
        with rec.on("pipeline") if name == "fused" else contextlib.nullcontext():
            counters = run_pipeline(["run", path, f"-Dpipeline.workspace={ws}",
                                     *extra])
        walls[f"pipeline {name}"] = time.perf_counter() - t0
        counts = read_counts()
        if counts != only(B1=chunks):
            raise AssertionError(f"pipeline {name} launched {counts}")
        for stage in ("nb", "mi"):
            got = counters[stage].get("SharedScan")
            if got != (None if name == "unfused" else fused_group):
                raise AssertionError(f"pipeline {name}: stage {stage} "
                                     f"SharedScan counters {got}")
            if counters[stage]["Records"]["Processed"] != ROWS_E2E:
                raise AssertionError(f"pipeline {name}: stage {stage} did "
                                     f"not process every row")
        if name == "fused":
            launches["pipeline"] = counts["B1"]
        parts[name] = {a: os.path.join(ws, a, "part-00000")
                       for a in ("nb_model", "mi_out")}
        log(f"pipeline ({name}): {walls[f'pipeline {name}']:.2f} s, "
            f"launches {counts}, counters {json.dumps(counters)}")
    fused = parts["fused"]
    for dev in ("cuda", "cpu"):
        same_bytes(fused["nb_model"], os.path.join(work, f"{dev}_nb",
                                                   "part-00000"),
                   f"fused NB model and phase 3's {dev}")
    same_bytes(fused["mi_out"], os.path.join(work, "cuda_mi", "part-00000"),
               "fused MI and phase 3's cuda")
    worst = compare_mi(fused["mi_out"], os.path.join(work, "cpu_mi",
                                                      "part-00000"))
    for name in ("unfused", "depth0", "fused again"):
        for art in ("nb_model", "mi_out"):
            same_bytes(parts[name][art], fused[art], f"pipeline {name} {art}")
    log(f"pipeline (b)-(d): NB byte-identical to phase 3's cuda and cpu "
        f"models, MI to phase 3's cuda file (cpu: max diff {worst}); "
        f"scan.fuse=false and prefetch depth 0 byte-identical; walls: fused "
        f"{walls['pipeline fused']:.2f} s and {walls['pipeline fused again']:.2f}"
        f" s (depth 2), depth 0 {walls['pipeline depth0']:.2f} s, unfused "
        f"{walls['pipeline unfused']:.2f} s; phase 3 on cuda: NB "
        f"{walls['cuda BayesianDistribution']:.2f} s + MI "
        f"{walls['cuda MutualInformation']:.2f} s")

    # the host breakdown of the fused run: the retried stream alone (read,
    # parse, encode), the staging alone (pinned copies to the card), and
    # the scan over chunks already on the card (B1, the host accumulation
    # each chunk waits for, the read-out and the consumers' finalize)
    import torch

    from avenir_tpu_torch.pipeline import scan
    from avenir_tpu_torch.runtime.feeder import CudaStage
    from avenir_tpu_torch.utils.metrics import Counters

    sconf = JobConfig({"feature.schema.file.path": schema,
                       "stream.chunk.rows": str(CHUNK_ROWS)})
    t0 = time.perf_counter()
    host = list(Job.iter_encoded_retrying(sconf, train, Job.encoder_for(sconf),
                                          Counters()))
    walls["breakdown: read + parse + encode"] = time.perf_counter() - t0
    stage = CudaStage(torch.device("cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = [stage(ds) for ds in host]
    for item in staged:
        item.event.synchronize()
    walls["breakdown: staging (pinned copies)"] = time.perf_counter() - t0
    on_card = [item.item for item in staged]
    for _ in range(2):                      # the second is the one kept
        engine = scan.SharedScan(device="cuda")
        engine.register(scan.NaiveBayesConsumer(name="nb"))
        engine.register(scan.MutualInfoConsumer(name="mi"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run(on_card)
        walls["breakdown: scan of staged chunks"] = time.perf_counter() - t0
    log("pipeline host breakdown (s): " + json.dumps(
        {k: v for k, v in walls.items() if k.startswith("breakdown")}))
    del host, staged, on_card

    mixed = copy.deepcopy(HOSP_SCHEMA_JSON)
    for field in mixed["fields"][1:4]:          # age, weight, height
        for key in ("bucketWidth", "min", "max"):
            field.pop(key)
    mixed_schema = os.path.join(work, "hosp_mixed.json")
    with open(mixed_schema, "w") as fh:
        json.dump(mixed, fh)
    path = pipeline_conf(work, "mixed", train, mixed_schema)
    gram_calls = []
    real = hist.gram_moments

    def spy(*args):
        gram_calls.append(tuple(args[0].shape) + tuple(args[2].shape[1:]))
        return real(*args)

    out = {}
    for dev in ("cuda", "cpu"):
        ws = os.path.join(work, f"ws_mixed_{dev}")
        reset_counts()
        hist.gram_moments = spy
        t0 = time.perf_counter()
        try:
            with rec.on("pipeline_mixed") if dev == "cuda" else \
                    contextlib.nullcontext():
                counters = run_pipeline(["run", path,
                                         f"-Dpipeline.workspace={ws}",
                                         "--device", dev])
        finally:
            hist.gram_moments = real
        walls[f"{dev} pipeline mixed"] = time.perf_counter() - t0
        counts = read_counts()
        if counters["nb"].get("SharedScan") != fused_group:
            raise AssertionError(f"mixed pipeline on {dev}: {counters}")
        if dev == "cuda":
            if (gram_calls != [(CHUNK_ROWS, 7, 3)] * chunks
                    or counts != only(B1=chunks)):
                raise AssertionError(f"mixed pipeline on cuda: gram_moments "
                                     f"calls {gram_calls}, launches {counts}")
            launches["pipeline_mixed"] = counts["B1"]
            n_gram = len(gram_calls)
        out[dev] = os.path.join(ws, "nb_model", "part-00000")
    reset_counts()
    t0 = time.perf_counter()
    run_cli(["BayesianDistribution", f"-Dfeature.schema.file.path={mixed_schema}",
             f"-Dstream.chunk.rows={CHUNK_ROWS}", train,
             os.path.join(work, "cuda_nb_mixed"), "--device", "cuda"])
    walls["cuda BayesianDistribution mixed"] = time.perf_counter() - t0
    same_bytes(out["cuda"], os.path.join(work, "cuda_nb_mixed", "part-00000"),
               "mixed fused NB and standalone cuda NB")
    rel = compare_rel(out["cuda"], out["cpu"], 1e-5)
    log(f"pipeline (e): mixed schema 7 x 4 x 2 binned + 3 continuous fused "
        f"on cuda through gram_moments ({n_gram} calls, B1 "
        f"{launches['pipeline_mixed']}), {walls['cuda pipeline mixed']:.2f} "
        f"s; NB model byte-identical to the standalone cuda "
        f"BayesianDistribution; against the fused cpu run "
        f"({walls['cpu pipeline mixed']:.2f} s) largest relative difference "
        f"{rel}")
    walls["mixed NB cuda vs cpu max rel diff"] = rel
    return launches


def journal_of(directory: str) -> str:
    """The one journal file a traced run wrote under ``directory``."""
    names = [n for n in os.listdir(directory) if n.endswith(".jsonl")]
    if len(names) != 1:
        raise AssertionError(f"{directory}: expected one journal, got {names}")
    return os.path.join(directory, names[0])


def check_schema(events: list, what: str) -> None:
    """Every event's key set is one of the golden schema's shapes (the
    writer stamp, the tenant and replica labels and a retroactive ``at``
    set aside; ``trace``/``span`` absent outside any span)."""
    from avenir_tpu_torch.telemetry import schema

    free = lambda keys: (set(keys) - schema.STAMP_KEYS  # noqa: E731
                         - {"replica", "tenant", "at"}) | {"trace", "span"}
    for e in events:
        if free(e) not in [free(s) for s in schema.event_shapes(e["ev"])]:
            raise AssertionError(f"{what}: {e['ev']} keys {sorted(e)} are "
                                 f"not in the golden schema")


def span_children(events: list) -> dict:
    """span id → (name, parent id, [child span ids]) from a journal."""
    spans = {}
    for e in events:
        if e["ev"] == "span.open":
            spans[e["span"]] = (e["name"], e.get("parent"), [])
    for sid, (_name, parent, _kids) in spans.items():
        if parent in spans:
            spans[parent][2].append(sid)
    return spans


def device_busy(trace_path: str, window: str) -> dict:
    """From a ``torch.profiler`` Chrome trace: the ``window`` range (a
    stage's or ``scan``'s ``record_function``), the CUDA kernels inside it,
    and the share of the window the union of their intervals covers."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == window and e.get("ph") == "X"]
    if len(ranges) != 1:
        raise AssertionError(f"{trace_path}: {len(ranges)} {window!r} ranges")
    t0, t1 = ranges[0]["ts"], ranges[0]["ts"] + ranges[0]["dur"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") == "kernel" and e.get("ph") == "X")
    if not kernels:
        raise AssertionError(f"{trace_path}: the trace holds no CUDA kernel "
                             f"event (CUPTI recorded no kernel activity)")
    inside = [(max(a, t0), min(b, t1), n) for a, b, n in kernels
              if b > t0 and a < t1]
    busy, end = 0.0, t0
    for a, b, _n in inside:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"window_ms": (t1 - t0) / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / (t1 - t0), "idle_share": 1 - busy / (t1 - t0),
            "kernels": len(inside),
            "pair_kernel": sum("pair_kernel" in n for _a, _b, n in inside),
            "pair_kernel_in_trace": sum("pair_kernel" in n
                                        for _a, _b, n in kernels)}


def telemetry_phase(work: str, train: str, schema: str, b4_tree: dict,
                    walls: dict) -> dict:
    """Phase 12: the telemetry plane on the card, over phase 3's CSV and
    phase 5b's pipeline; returns B1's and B4's launches by path.

    (a) the NB + MI pipeline traced and profiled (``tenant.id=smoke``)
    between two untraced runs: part files and B1 launches as untraced,
    the journal's span tree, its analytic ``scan.chunk`` program (the bytes
    of B1's bound), its dispatches and ``cuda:0`` memory gauges, every
    event in the golden schema; (b) with ``trace.xla.dir``: one Chrome
    trace per stage, B1's ``pair_kernel`` in it once a chunk, and the
    device's busy share of the scan's and the stage's windows; (c) the
    exhaustive tree traced and profiled: phase 4's model bytes, one
    ``tree.level`` program per key, dispatches equal to the levels, B4's
    launches as untraced; (d) a ``blackbox.dir`` job in a fresh process:
    exit 0, no live bundle left, a capture taken inside it rendered by
    ``telemetry bundle``; (e) the telemetry CLI's ``tree``, ``profile``,
    ``metrics`` and ``diff`` on (a)'s journals."""
    from avenir_tpu_torch.ops import hist
    from avenir_tpu_torch.telemetry import spans as tel
    from avenir_tpu_torch.telemetry.journal import read_events

    chunks = -(-ROWS_E2E // CHUNK_ROWS)
    path = pipeline_conf(work, "nb_mi", train, schema)
    untraced = os.path.join(work, "ws_fused")
    launches = {}

    # (a) traced pipeline, between two untraced runs on the same card
    traced_walls, plain_walls = [], []
    for name in ("plain", "traced_a", "traced_b", "plain_again"):
        ws = os.path.join(work, f"ws_tel_{name}")
        extra = [] if name.startswith("plain") else [
            "-Dtrace.on=true", "-Dprofile.on=true", "-Dtenant.id=smoke",
            f"-Dtrace.journal.dir={os.path.join(work, 'tel_' + name)}"]
        reset_counts()
        t0 = time.perf_counter()
        try:
            run_pipeline(["run", path, f"-Dpipeline.workspace={ws}", *extra])
        finally:
            tel.tracer().disable()
        wall = time.perf_counter() - t0
        (plain_walls if name.startswith("plain") else traced_walls).append(wall)
        counts = read_counts()
        if counts != only(B1=chunks):
            raise AssertionError(f"telemetry (a) {name} launched {counts}")
        for art in ("nb_model", "mi_out"):
            same_bytes(os.path.join(ws, art, "part-00000"),
                       os.path.join(untraced, art, "part-00000"),
                       f"telemetry (a) {name} {art} against phase 5b's")
    launches["pipeline_traced"] = chunks
    journal = journal_of(os.path.join(work, "tel_traced_a"))
    if not (os.path.basename(journal).startswith("run-")
            and os.path.basename(journal).endswith(".proc-0-smoke.jsonl")):
        raise AssertionError(f"telemetry (a): journal name {journal}")
    events = read_events(journal)
    check_schema(events, "telemetry (a)")
    spans = span_children(events)
    roots = [s for s, (n, p, _k) in spans.items() if n == "pipeline.run"
             and p is None]
    fused = [k for k in spans[roots[0]][2] if spans[k][0] == "scan.fused"] \
        if len(roots) == 1 else []
    scans = [k for k in spans[fused[0]][2] if spans[k][0] == "scan"] \
        if len(fused) == 1 else []
    chunk_spans = [k for k in spans[scans[0]][2]
                   if spans[k][0] == "scan.chunk"] if len(scans) == 1 else []
    if len(chunk_spans) != chunks:
        raise AssertionError(f"telemetry (a): span tree pipeline.run "
                             f"{roots} → scan.fused {fused} → scan {scans} → "
                             f"scan.chunk {chunk_spans}")
    compiled = [e for e in events if e["ev"] == "program.compiled"
                and e["site"] == "scan.chunk"]
    want_bytes = hist.gram_work(10, CHUNK_ROWS, *hist.gram_cells(10, 13, 2),
                                CHUNK_ROWS)[0]
    if (len(compiled) != 1 or compiled[0]["source"] != "analytic"
            or compiled[0]["bytes_accessed"] != want_bytes):
        raise AssertionError(f"telemetry (a): scan.chunk programs {compiled}, "
                             f"want one analytic at {want_bytes} bytes")
    profiles = [e for e in events if e["ev"] == "program.profile"
                and e["key"] == compiled[0]["key"]]
    if not profiles or profiles[-1]["dispatches"] != chunks:
        raise AssertionError(f"telemetry (a): scan.chunk profile {profiles}")
    mem = [e for e in events if e["ev"] == "device.memory"
           and e["device"] == "cuda:0" and e["bytes_in_use"] > 0]
    if not mem:
        raise AssertionError("telemetry (a): no device.memory for cuda:0")
    walls["phase 12 pipeline untraced"] = statistics.mean(plain_walls)
    walls["phase 12 pipeline traced"] = statistics.mean(traced_walls)
    walls["tracing overhead ratio"] = (statistics.mean(traced_walls)
                                       / statistics.mean(plain_walls))
    log(f"telemetry (a): untraced {plain_walls} s, traced {traced_walls} s, "
        f"ratio {walls['tracing overhead ratio']:.3f}; {len(events)} events "
        f"in {os.path.basename(journal)}, span tree pipeline.run → "
        f"scan.fused → scan → {chunks} scan.chunk, scan.chunk program "
        f"{compiled[0]['key']} analytic {want_bytes} bytes, "
        f"{profiles[-1]['dispatches']} dispatches, "
        f"{profiles[-1]['wall_ms']} ms; {len(mem)} cuda:0 memory samples "
        f"(peak {max(e['peak_bytes'] for e in mem)} bytes)")

    # (b) the device trace of the fused stage
    xla = os.path.join(work, "xla")
    ws = os.path.join(work, "ws_tel_xla")
    reset_counts()
    t0 = time.perf_counter()
    try:
        run_pipeline(["run", path, f"-Dpipeline.workspace={ws}",
                      f"-Dtrace.xla.dir={xla}"])
    finally:
        tel.tracer().disable()
    walls["phase 12 pipeline with device trace"] = time.perf_counter() - t0
    counts = read_counts()
    if counts != only(B1=chunks):
        raise AssertionError(f"telemetry (b) launched {counts}")
    launches["pipeline_xla"] = chunks
    if sorted(os.listdir(xla)) != ["nb"]:
        raise AssertionError(f"telemetry (b): stage traces {os.listdir(xla)}")
    traces = os.listdir(os.path.join(xla, "nb"))
    if len(traces) != 1 or not traces[0].endswith(".pt.trace.json"):
        raise AssertionError(f"telemetry (b): traces {traces}")
    trace_path = os.path.join(xla, "nb", traces[0])
    scan_busy = device_busy(trace_path, "scan")
    stage_busy = device_busy(trace_path, "nb")
    if scan_busy["pair_kernel"] != chunks or \
            stage_busy["pair_kernel_in_trace"] != chunks:
        raise AssertionError(f"telemetry (b): pair_kernel {scan_busy}, "
                             f"{stage_busy}")
    walls["device busy share, fused scan"] = scan_busy["busy_share"]
    walls["device busy share, fused stage"] = stage_busy["busy_share"]
    log("telemetry (b): device trace " + json.dumps(
        {"scan": scan_busy, "stage": stage_busy}))
    log(f"device busy share {scan_busy['busy_share']:.4f} / idle share "
        f"{scan_busy['idle_share']:.4f} of the fused scan "
        f"({scan_busy['window_ms']:.2f} ms); busy "
        f"{stage_busy['busy_share']:.4f} / idle {stage_busy['idle_share']:.4f}"
        f" of the whole stage ({stage_busy['window_ms']:.2f} ms)")

    # (c) the traced tree
    tel_tree = os.path.join(work, "tel_tree")
    reset_counts()
    try:
        text = run_cli(["DecisionTreeBuilder",
                        f"-Dfeature.schema.file.path={schema}",
                        "-Dtree.hist.phase.stats=true", "-Dtrace.on=true",
                        "-Dprofile.on=true", f"-Dtrace.journal.dir={tel_tree}",
                        train, os.path.join(work, "tel_tree_model"),
                        "--device", "cuda"])
    finally:
        tel.tracer().disable()
    counts = read_counts()
    levels = len(tree_phase_table(text))
    if counts != only(B4=b4_tree["tree"]):
        raise AssertionError(f"telemetry (c): traced tree launched {counts}, "
                             f"untraced B4 {b4_tree['tree']}")
    launches["tree_traced"] = counts["B4"]
    same_bytes(os.path.join(work, "tel_tree_model", "part-00000"),
               os.path.join(work, "cuda_tree", "part-00000"),
               "telemetry (c) traced tree and phase 4's cuda tree")
    events = read_events(journal_of(tel_tree))
    check_schema(events, "telemetry (c)")
    compiled = [e for e in events if e["ev"] == "program.compiled"
                and e["site"] == "tree.level"]
    totals = {e["key"]: e["dispatches"] for e in events
              if e["ev"] == "program.profile" and e["site"] == "tree.level"}
    if (len({e["key"] for e in compiled}) != len(compiled)
            or set(totals) != {e["key"] for e in compiled}
            or sum(totals.values()) != levels):
        raise AssertionError(f"telemetry (c): tree.level programs "
                             f"{compiled}, dispatches {totals}, levels "
                             f"{levels}")
    log(f"telemetry (c): traced tree byte-identical to phase 4's, B4 "
        f"{counts['B4']} as untraced, {len(compiled)} tree.level programs, "
        f"{sum(totals.values())} dispatches over {levels} levels")

    # (d) the flight recorder in a fresh process
    bb = os.path.join(work, "bb")
    driver = (
        "import sys\n"
        "from avenir_tpu_torch.__main__ import main\n"
        "from avenir_tpu_torch.jobs import get_job\n"
        "from avenir_tpu_torch.telemetry import blackbox\n"
        "job = type(get_job('BayesianDistribution'))\n"
        "run = job.execute\n"
        "def execute(self, *a):\n"
        "    run(self, *a)\n"
        "    print('CAPTURE', blackbox.capture('smoke'))\n"
        "job.execute = execute\n"
        "sys.exit(main(sys.argv[1:]))\n")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c", driver, "BayesianDistribution",
         f"-Dfeature.schema.file.path={schema}",
         f"-Dstream.chunk.rows={CHUNK_ROWS}", f"-Dblackbox.dir={bb}",
         "-Dblackbox.watchdog.sec=600", "-Dtrace.run.id=smoke", train,
         os.path.join(work, "bb_nb"), "--device", "cuda"],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    walls["phase 12 blackbox job"] = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"telemetry (d) exited {res.returncode}:\n"
                             f"{res.stdout}\n{res.stderr}")
    capture = next((ln.split(" ", 1)[1] for ln in res.stdout.splitlines()
                    if ln.startswith("CAPTURE ")), "None")
    left = sorted(os.listdir(bb))
    if capture == "None" or left != [os.path.basename(capture)]:
        raise AssertionError(f"telemetry (d): capture {capture}, left {left}")
    same_bytes(os.path.join(work, "bb_nb", "part-00000"),
               os.path.join(work, "cuda_nb", "part-00000"),
               "telemetry (d) NB and phase 3's cuda")
    cli = [sys.executable, "-m", "avenir_tpu_torch.telemetry"]
    out = subprocess.run([*cli, "bundle", capture], cwd=HERE,
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0 or "reason=smoke" not in out.stdout:
        raise AssertionError(f"telemetry (d): bundle rc {out.returncode}:\n"
                             f"{out.stdout}\n{out.stderr}")
    log(f"telemetry (d): blackbox job exit 0 in "
        f"{walls['phase 12 blackbox job']:.2f} s, no live bundle left, "
        f"capture {os.path.basename(capture)} rendered")

    # (e) the CLI on the card's journals
    jb = journal_of(os.path.join(work, "tel_traced_b"))
    for argv in (["tree", journal], ["profile", journal, "--peak-tflops",
                                     "989"],
                 ["metrics", journal], ["diff", journal, jb]):
        out = subprocess.run([*cli, *argv], cwd=HERE, capture_output=True,
                             text=True, timeout=120)
        if out.returncode != 0 or not out.stdout:
            raise AssertionError(f"telemetry (e) {argv[0]} rc "
                                 f"{out.returncode}:\n{out.stderr}")
        if argv[0] == "profile":
            log("telemetry (e) profile:\n" + out.stdout.rstrip())
    log("telemetry (e): tree, profile, metrics and diff exit 0")
    return launches


def expect_raise(exc_type, match: str, fn) -> str:
    """Call ``fn`` and return the message of the ``exc_type`` it must raise
    with ``match`` in it; any other outcome fails the phase."""
    try:
        fn()
    except exc_type as e:
        if match not in str(e):
            raise
        return str(e)
    raise AssertionError(f"expected {exc_type.__name__} ({match!r})")


def b1_classes(rec: Recorder, path: str) -> list:
    """The class count C of every B1-route call recorded on ``path``."""
    return [args[3] for name, p, args, _kw in rec.calls
            if name == "cooc_counts_cols" and p == path]


# phase 5c's standalone jobs on the churn CSV: (name, job, -D arguments)
CORR_JOBS = (
    ("cramer_class", "CramerCorrelation", ["-Ddest.attributes=6"]),
    ("cramer_pairs", "CramerCorrelation", []),
    ("het_concentration", "HeterogeneityReductionCorrelation",
     ["-Dheterogeneity.algorithm=concentration"]),
    ("het_uncertainty", "HeterogeneityReductionCorrelation",
     ["-Dheterogeneity.algorithm=uncertainty"]),
    ("nb", "BayesianDistribution", []),
    ("mi", "MutualInformation",
     ["-Dmutual.info.score.algorithms=mim,mifs,jmi,disr,mrmr"]),
)


def correlation_phase(rec: Recorder, work: str, train: str, schema: str,
                      walls: dict) -> dict:
    """Phase 5c: the correlation family, the kill-and-resume of the
    streamed count jobs and Fisher; returns B1's launches by path.

    (a) the correlation jobs (and NB and MI) through the CLI on a 1M-row
    churn CSV in 250K-row chunks, on cuda and then on the CPU: part files
    byte-identical, B1 once a chunk (C printed), and CramerCorrelation over
    the feature pairs of phase 3's hospital CSV; (b) a four-stage pipeline
    (NB, MI, Cramér against the class, heterogeneity) as one SharedScan,
    each part file byte-identical to its standalone cuda job's; (c) MI and
    Cramér crashed on cuda after two chunks with a snapshot a chunk, then
    resumed on cuda (the same bytes, every row counted, the snapshots
    gone), and crashed again and resumed on the CPU (MI: G converted to
    the agg route's tensors, the same bytes; Cramér refuses the gram
    snapshot on its agg route, as the JAX package does); (d)
    FisherDiscriminant on phase 5b's mixed schema on cuda and the CPU, and
    a SharedScan with an MI and a Fisher consumer (``gram_moments`` once a
    chunk) equal to the standalone fit on the same chunks."""
    from avenir_tpu_torch.core.csv_io import write_csv
    from avenir_tpu_torch.datagen.churn import CHURN_SCHEMA_JSON, generate_churn

    t0 = time.perf_counter()
    churn = os.path.join(work, "churn.csv")
    write_csv(churn, generate_churn(ROWS_E2E, seed=13))
    churn_schema = os.path.join(work, "churn.json")
    with open(churn_schema, "w") as fh:
        json.dump(CHURN_SCHEMA_JSON, fh)
    log(f"correlation: generated {ROWS_E2E} churn rows in "
        f"{time.perf_counter() - t0:.1f} s")
    chunks = -(-ROWS_E2E // CHUNK_ROWS)
    common = [f"-Dfeature.schema.file.path={churn_schema}",
              f"-Dstream.chunk.rows={CHUNK_ROWS}"]
    part = lambda d: os.path.join(d, "part-00000")  # noqa: E731
    out = lambda name, dev: os.path.join(work, f"corr_{dev}_{name}")  # noqa: E731
    launches = {}
    runs = [(name, job, common + extra, churn) for name, job, extra in CORR_JOBS]
    runs.append(("cramer_hosp_pairs", "CramerCorrelation",
                 [f"-Dfeature.schema.file.path={schema}",
                  f"-Dstream.chunk.rows={CHUNK_ROWS}"], train))

    # (a) each job on cuda, then on the CPU
    for name, job, args, data in runs:
        for dev in ("cuda", "cpu"):
            path = f"corr_{name}"
            reset_counts()
            t0 = time.perf_counter()
            with rec.on(path) if dev == "cuda" else contextlib.nullcontext():
                text = run_cli([job, *args, data, out(name, dev),
                                "--device", dev])
            walls[f"{dev} {job} {name}"] = time.perf_counter() - t0
            counts = read_counts()
            if counter(text, "Processed") != ROWS_E2E:
                raise AssertionError(f"{name} on {dev} did not count every row")
            want = only(B1=chunks if job != "BayesianDistribution" else 0)
            if dev == "cuda":
                if counts != want:
                    raise AssertionError(f"{name} on cuda launched {counts}")
                launches[path] = counts["B1"]
            elif counts != only():
                raise AssertionError(f"{name} on cpu launched {counts}")
        same_bytes(part(out(name, "cuda")), part(out(name, "cpu")), name)
        log(f"correlation (a) {name}: {job} cuda "
            f"{walls[f'cuda {job} {name}']:.2f} s, cpu "
            f"{walls[f'cpu {job} {name}']:.2f} s, part files byte-identical;"
            f" B1 launches {launches[f'corr_{name}']} at C = "
            f"{b1_classes(rec, f'corr_{name}')}")
    for name in ("cramer_pairs", "cramer_hosp_pairs"):
        if b1_classes(rec, f"corr_{name}") != [1] * chunks:
            raise AssertionError(f"{name}: B1 was not run at C = 1")
    if b1_classes(rec, "corr_cramer_class") != [2] * chunks:
        raise AssertionError("cramer_class: B1 was not run at C = 2")

    # (b) NB, MI, Cramér against the class and heterogeneity as one scan
    props = {
        "pipeline.stages": "nb,mi,cramer,het",
        "pipeline.bind.train": churn,
        "feature.schema.file.path": churn_schema,
        "stream.chunk.rows": str(CHUNK_ROWS),
        "mutual.info.score.algorithms": "mim,mifs,jmi,disr,mrmr",
        "pipeline.stage.cramer.prop.dest.attributes": "6",
        "pipeline.stage.het.prop.heterogeneity.algorithm": "concentration",
    }
    stages = {"nb": "BayesianDistribution", "mi": "MutualInformation",
              "cramer": "CramerCorrelation",
              "het": "HeterogeneityReductionCorrelation"}
    for stage, job in stages.items():
        props[f"pipeline.stage.{stage}.job"] = job
        props[f"pipeline.stage.{stage}.input"] = "train"
        props[f"pipeline.stage.{stage}.output"] = f"{stage}_out"
    conf_path = write_props(os.path.join(work, "corr_pipeline.properties"),
                            props)
    ws = os.path.join(work, "ws_corr")
    reset_counts()
    t0 = time.perf_counter()
    with rec.on("pipeline_corr"):
        counters = run_pipeline(["run", conf_path, f"-Dpipeline.workspace={ws}"])
    walls["pipeline nb+mi+cramer+het"] = time.perf_counter() - t0
    counts = read_counts()
    if counts != only(B1=chunks):
        raise AssertionError(f"four-stage pipeline launched {counts}")
    launches["pipeline_corr"] = counts["B1"]
    group = {"FusedStages": 4, "Scans": 1, "Chunks": chunks}
    for stage, alone in (("nb", "nb"), ("mi", "mi"), ("cramer", "cramer_class"),
                         ("het", "het_concentration")):
        if counters[stage].get("SharedScan") != group:
            raise AssertionError(f"stage {stage}: {counters[stage]}")
        same_bytes(part(os.path.join(ws, f"{stage}_out")),
                   part(out(alone, "cuda")), f"fused {stage} and standalone")
    log(f"correlation (b): NB + MI + Cramér + heterogeneity in one "
        f"SharedScan ({json.dumps(group)}), {walls['pipeline nb+mi+cramer+het']:.2f}"
        f" s, B1 {counts['B1']} at C = {b1_classes(rec, 'pipeline_corr')}; "
        f"each part file byte-identical to its standalone cuda job's")

    # (c) kill on cuda, resume on cuda, and on the CPU
    ckpt = os.path.join(work, "corr_ckpt")
    keys = [f"-Dstream.checkpoint.dir={ckpt}",
            "-Dstream.checkpoint.interval.chunks=1"]
    for name, job, extra in (CORR_JOBS[5], CORR_JOBS[1]):
        args = [job, *common, *extra, *keys]

        def crash(dst):
            reset_counts()
            expect_raise(RuntimeError, "injected crash after chunk 2",
                         lambda: run_cli([*args,
                                          "-Dstream.fault.crash.after.chunks=2",
                                          churn, dst, "--device", "cuda"]))
            if read_counts() != only(B1=2):
                raise AssertionError(f"{name} crash run launched {read_counts()}")
            if os.path.exists(part(dst)) or not os.listdir(ckpt):
                raise AssertionError(f"{name}: the crash left a part file or "
                                     f"no snapshot")

        for dev in ("cuda", "cpu"):
            dst = os.path.join(work, f"corr_resume_{name}_{dev}")
            crash(dst)
            reset_counts()
            resume = [*args, churn, dst, "--device", dev, "--resume"]
            if name == "cramer_pairs" and dev == "cpu":
                msg = expect_raise(ValueError, "different device/kernel layout",
                                   lambda: run_cli(resume))
                log(f"correlation (c) {name}: a cuda snapshot resumed on the "
                    f"cpu is refused: {msg[:90]}...")
                shutil.rmtree(ckpt)
                continue
            t0 = time.perf_counter()
            with rec.on(f"resume_{name}") if dev == "cuda" else \
                    contextlib.nullcontext():
                text = run_cli(resume)
            walls[f"{dev} resume {name}"] = time.perf_counter() - t0
            if read_counts() != only(B1=chunks - 2 if dev == "cuda" else 0):
                raise AssertionError(f"{name} resume on {dev} launched "
                                     f"{read_counts()}")
            same_bytes(part(dst), part(out(name, "cuda")),
                       f"{name} resumed on {dev} and uninterrupted")
            if counter(text, "Processed") != ROWS_E2E or os.path.exists(ckpt):
                raise AssertionError(f"{name} resume on {dev}: rows "
                                     f"{counter(text, 'Processed')}, "
                                     f"snapshots left {os.path.exists(ckpt)}")
            log(f"correlation (c) {name}: crashed on cuda after chunk 2, "
                f"resumed on {dev} in {walls[f'{dev} resume {name}']:.2f} s: "
                f"byte-identical, Records::Processed {ROWS_E2E}, snapshots "
                f"removed")
    launches["resume_mi"] = chunks - 2
    launches["resume_cramer_pairs"] = chunks - 2

    # (d) Fisher on the mixed hospital schema
    import numpy as np

    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.jobs.base import Job
    from avenir_tpu_torch.models import fisher
    from avenir_tpu_torch.ops import hist
    from avenir_tpu_torch.pipeline import scan
    from avenir_tpu_torch.utils.metrics import Counters

    mixed_schema = os.path.join(work, "hosp_mixed.json")
    for dev in ("cuda", "cpu"):
        reset_counts()
        t0 = time.perf_counter()
        run_cli(["FisherDiscriminant", f"-Dfeature.schema.file.path={mixed_schema}",
                 train, out("fisher", dev), "--device", dev])
        walls[f"{dev} FisherDiscriminant"] = time.perf_counter() - t0
        if read_counts() != only():
            raise AssertionError(f"Fisher on {dev} launched {read_counts()}")
    rel = compare_rel(part(out("fisher", "cuda")), part(out("fisher", "cpu")),
                      1e-9)
    walls["Fisher cuda vs cpu max rel diff"] = rel
    sconf = JobConfig({"feature.schema.file.path": mixed_schema,
                       "stream.chunk.rows": str(CHUNK_ROWS)})
    host = list(Job.iter_encoded_retrying(sconf, train, Job.encoder_for(sconf),
                                          Counters()))
    gram_calls = []
    real = hist.gram_moments

    def spy(*a):
        gram_calls.append(tuple(a[0].shape))
        return real(*a)

    engine = scan.SharedScan(device="cuda")
    engine.register(scan.MutualInfoConsumer(name="mi"))
    engine.register(scan.FisherConsumer(name="fisher"))
    reset_counts()
    hist.gram_moments = spy
    try:
        with rec.on("scan_mi_fisher"):
            res = engine.run(host)
    finally:
        hist.gram_moments = real
    if read_counts() != only(B1=chunks) or len(gram_calls) != chunks:
        raise AssertionError(f"MI + Fisher scan: launches {read_counts()}, "
                             f"gram_moments {gram_calls}")
    launches["scan_mi_fisher"] = chunks
    alone = fisher.FisherDiscriminant(device="cuda").fit(host)
    for key in ("mean", "var", "count", "pooled_var", "boundary"):
        if not np.array_equal(getattr(res["fisher"], key), getattr(alone, key)):
            raise AssertionError(f"scan Fisher {key} differs from the fit's")
    names = ["age", "weight", "height"]
    with open(part(out("fisher", "cuda"))) as fh:
        job_lines = fh.read().splitlines()
    worst = 0.0
    for a, b in zip(res["fisher"].to_lines(names), job_lines):
        for x, y in zip(a.split(",")[1:], b.split(",")[1:]):
            worst = max(worst, abs(float(x) - float(y)) / max(abs(float(y)), 1e-30))
    if len(job_lines) != 3 or worst > 1e-9:
        raise AssertionError(f"scan Fisher against the job: {worst}")
    log(f"correlation (d): FisherDiscriminant cuda "
        f"{walls['cuda FisherDiscriminant']:.2f} s, cpu "
        f"{walls['cpu FisherDiscriminant']:.2f} s, largest relative "
        f"difference {rel}; MI + Fisher SharedScan on cuda: gram_moments "
        f"{len(gram_calls)} calls, B1 {chunks}, the Fisher model equal to "
        f"the standalone fit on the same chunks, within {worst} of the "
        f"whole-input job")
    del host
    return launches


# ---------------------------------------------------------------------------
# phase 11: the samplers and RandomForest, the Markov family, logistic
# regression
# ---------------------------------------------------------------------------

FOREST_TREES = 5
FOREST_CPU_ROWS = 100_000    # the forest's cuda-against-cpu check
CHAIN_CUSTOMERS = 100_000    # MarkovStateTransitionModel's sequences
HMM_FIT_SEQS = 20_000        # HiddenMarkovModelBuilder's tagged sequences
VITERBI_R, VITERBI_T = 80_000, 210   # the email-marketing tutorial's decode
ASSOC_R = 2_000              # "assoc" at a smaller R: R·T·S³ floats
VITERBI_JOB_SEQS = 10_000    # the predictor job's CSV (host string work)
LR_REL = 1e-5                # LR history: |Δ| ≤ LR_REL · the row's max |w|


def forest_phase(rec: Recorder, work: str, train: str, schema: str,
                 walls: dict) -> int:
    """Phase 11 (a): RandomForest(num_trees=5, seed=1) on the 1M-row
    hospital CSV on cuda at the tree jobs' depth, each tree's B4 launches
    held to its level tables; the same forest on 100K rows on cuda and the
    CPU (the tree contract, votes within 1e-6); BaggingSampler and
    UnderSamplingBalancer on the CSV, twice on cuda and once on the CPU,
    part files byte-equal.  Returns the forest's B4 launches."""
    import numpy as np

    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.jobs.base import Job
    from avenir_tpu_torch.models import tree

    conf = JobConfig({"feature.schema.file.path": schema})
    enc, ds, _ = Job.encode_input(conf, train, need_rows=False)
    is_cat = [f.is_categorical for f in enc.binned_fields]
    per_tree = []
    real_fit = tree.DecisionTree.fit

    def spy(self, *a, **k):
        before = read_counts()["B4"]
        model = real_fit(self, *a, **k)
        routes = [s["path"] for s in self.level_stats]
        per_tree.append((read_counts()["B4"] - before, routes))
        return model

    tree.DecisionTree.fit = spy
    try:
        forest = tree.RandomForest(num_trees=FOREST_TREES, seed=1,
                                   collect_phase_stats=True, device="cuda")
        reset_counts()
        t0 = time.perf_counter()
        with rec.on("forest"):
            models = forest.fit(ds, is_cat)
        walls["cuda RandomForest fit"] = time.perf_counter() - t0
        counts = read_counts()
    finally:
        tree.DecisionTree.fit = real_fit
    launches = counts["B4"]
    if counts != only(B4=launches) or len(per_tree) != FOREST_TREES:
        raise AssertionError(f"forest launched {counts} over {len(per_tree)} "
                             f"trees")
    for i, (n, routes) in enumerate(per_tree):
        if not routes or routes != ["cross"] * len(routes) or n != len(routes):
            raise AssertionError(f"forest tree {i}: B4 {n} for level routes "
                                 f"{routes}")
    t0 = time.perf_counter()
    pred, votes = forest.predict(models, ds)
    walls["cuda RandomForest predict"] = time.perf_counter() - t0
    # each tree adds its leaf's class distribution, or zeros where a row
    # reaches a leaf its bootstrap sample left empty
    trees_voting = votes.sum(1) * FOREST_TREES
    if (votes.shape != (ds.num_rows, 2) or not np.isfinite(votes).all()
            or np.abs(trees_voting - np.rint(trees_voting)).max() > 1e-4
            or trees_voting.max() > FOREST_TREES + 1e-4):
        raise AssertionError("forest votes are not means of the trees' "
                             "leaf distributions")
    acc = float((pred == ds.labels).mean())
    base = float(max(np.bincount(ds.labels)) / ds.num_rows)
    log(f"forest (a): {FOREST_TREES} trees on {ds.num_rows} rows on cuda in "
        f"{walls['cuda RandomForest fit']:.2f} s (predict "
        f"{walls['cuda RandomForest predict']:.2f} s), B4 per tree "
        f"{[n for n, _ in per_tree]} = {launches}, nodes "
        f"{[len(m.nodes) for m in models]}, training accuracy {acc:.4f} "
        f"(majority {base:.4f})")
    small = ds.slice(0, FOREST_CPU_ROWS)
    fits = {}
    for dev in ("cuda", "cpu"):
        f = tree.RandomForest(num_trees=FOREST_TREES, seed=1, device=dev)
        t0 = time.perf_counter()
        ms = f.fit(small, is_cat)
        walls[f"{dev} RandomForest fit {FOREST_CPU_ROWS}"] = \
            time.perf_counter() - t0
        fits[dev] = (ms, f.predict(ms, small)[1])
    worst = max(same_tree(a.to_string(), b.to_string(), f"forest tree {i}")
                for i, (a, b) in enumerate(zip(fits["cuda"][0],
                                               fits["cpu"][0])))
    dv = float(np.abs(fits["cuda"][1] - fits["cpu"][1]).max())
    if dv > 1e-6:
        raise AssertionError(f"forest votes differ cuda vs cpu by {dv}")
    log(f"forest (a): {FOREST_CPU_ROWS} rows, cuda and cpu trees agree (max "
        f"score diff {worst}), votes within {dv}; cuda "
        f"{walls[f'cuda RandomForest fit {FOREST_CPU_ROWS}']:.2f} s, cpu "
        f"{walls[f'cpu RandomForest fit {FOREST_CPU_ROWS}']:.2f} s")
    common = [f"-Dfeature.schema.file.path={schema}"]
    for job, keys in (("BaggingSampler", ["-Dseed=7"]),
                      ("UnderSamplingBalancer", ["-Dseed=7"])):
        parts = []
        for run, dev in enumerate(("cuda", "cuda", "cpu")):
            out = os.path.join(work, f"{job}_{run}")
            reset_counts()
            t0 = time.perf_counter()
            text = run_cli([job, *common, *keys, train, out, "--device", dev])
            walls[f"{dev} {job} run {run}"] = time.perf_counter() - t0
            if read_counts() != only():
                raise AssertionError(f"{job} launched {read_counts()}")
            parts.append(os.path.join(out, "part-00000"))
        same_bytes(parts[0], parts[1], f"{job} (two cuda runs)")
        same_bytes(parts[0], parts[2], job)
        log(f"forest (a): {job} processed {counter(text, 'Processed')} "
            f"emitted {counter(text, 'Emitted')}; cuda "
            f"{walls[f'cuda {job} run 0']:.2f} s and "
            f"{walls[f'cuda {job} run 1']:.2f} s, cpu "
            f"{walls[f'cpu {job} run 2']:.2f} s; part files byte-equal")
    return launches


def write_rows(path: str, rows) -> None:
    with open(path, "w") as fh:
        for r in rows:
            fh.write(",".join(r))
            fh.write("\n")


def markov_phase(work: str, walls: dict) -> None:
    """Phase 11 (b): MarkovStateTransitionModel on 100K customers' state
    sequences drawn from event_seq's planted matrix; HiddenMarkovModelBuilder
    on 20K tagged sequences of a planted 6-state × 12-observation HMM (and
    partially tagged on 5K); ViterbiDecoder("scan").decode_codes at 80K ×
    210 on cuda, its first 2,000 records against the CPU and "assoc"; the
    ViterbiStatePredictor job on 10K sequences.  Every job on cuda and the
    CPU, part files byte-identical; no count kernel launched."""
    import numpy as np
    import torch

    from avenir_tpu_torch.datagen import hmm_seq
    from avenir_tpu_torch.datagen.event_seq import (STATES,
                                                    planted_transition_matrix)
    from avenir_tpu_torch.models import markov as mk

    def both(name, argv):
        outs = []
        for dev in ("cuda", "cpu"):
            out = os.path.join(work, f"{name}_{dev}")
            reset_counts()
            t0 = time.perf_counter()
            text = run_cli([*argv, out, "--device", dev])
            walls[f"{dev} {name}"] = time.perf_counter() - t0
            if read_counts() != only():
                raise AssertionError(f"{name} launched {read_counts()}")
            outs.append(os.path.join(out, "part-00000"))
        same_bytes(outs[0], outs[1], name)
        return outs[0], text

    trans = planted_transition_matrix(7)
    chain = hmm_seq.sample_chain(trans, np.full(9, 1 / 9), CHAIN_CUSTOMERS,
                                 10, 40, seed=3)
    chain_csv = os.path.join(work, "chain.csv")
    write_rows(chain_csv, hmm_seq.code_rows(chain, STATES))
    part, text = both("MarkovStateTransitionModel",
                      ["MarkovStateTransitionModel",
                       f"-Dmodel.states={','.join(STATES)}", chain_csv])
    with open(part) as fh:
        model = mk.MarkovChainModel.from_lines(fh.read().splitlines())
    err = float(np.abs(model.transition_probs() - trans).max())
    if err > 0.02:
        raise AssertionError(f"Markov chain is {err} from the planted matrix")
    log(f"markov (b): MarkovStateTransitionModel on "
        f"{counter(text, 'Processed')} sequences "
        f"({int((chain >= 0).sum())} states): cuda "
        f"{walls['cuda MarkovStateTransitionModel']:.2f} s, cpu "
        f"{walls['cpu MarkovStateTransitionModel']:.2f} s, byte-identical, "
        f"max |P - planted| {err:.4f}")

    a, b, pi = hmm_seq.planted_hmm(6, 12, seed=2)
    s_names = [f"S{i}" for i in range(6)]
    o_names = [f"O{i}" for i in range(12)]
    states, obs = hmm_seq.sample_hmm(a, b, pi, HMM_FIT_SEQS, 10, 40, seed=4)
    tagged_csv = os.path.join(work, "tagged.csv")
    write_rows(tagged_csv, hmm_seq.tagged_rows(states, obs, s_names, o_names))
    vocab = [f"-Dmodel.states={','.join(s_names)}",
             f"-Dmodel.observations={','.join(o_names)}"]
    part, _ = both("HiddenMarkovModelBuilder",
                   ["HiddenMarkovModelBuilder", *vocab, tagged_csv])
    with open(part) as fh:
        hmm = mk.HMMModel.from_lines(fh.read().splitlines())
    err = max(float(np.abs(hmm.transition - a).max()),
              float(np.abs(hmm.emission - b).max()))
    if err > 0.03:
        raise AssertionError(f"HMM is {err} from the planted model")
    partial_csv = os.path.join(work, "partial.csv")
    write_rows(partial_csv, hmm_seq.partial_rows(states[:5000], obs[:5000],
                                                 s_names, o_names))
    both("HiddenMarkovModelBuilder partial",
         ["HiddenMarkovModelBuilder", *vocab, "-Dpartially.tagged=true",
          partial_csv])
    log(f"markov (b): HiddenMarkovModelBuilder on {HMM_FIT_SEQS} tagged "
        f"sequences: cuda {walls['cuda HiddenMarkovModelBuilder']:.2f} s, "
        f"cpu {walls['cpu HiddenMarkovModelBuilder']:.2f} s, byte-identical, "
        f"max |A, B - planted| {err:.4f}; partially tagged on 5000: cuda "
        f"{walls['cuda HiddenMarkovModelBuilder partial']:.2f} s, "
        f"byte-identical")

    tstates, tobs = hmm_seq.sample_hmm(a, b, pi, VITERBI_R, VITERBI_T,
                                       VITERBI_T, seed=5)
    gpu = mk.ViterbiDecoder(hmm, method="scan", device="cuda")
    obs_dev = torch.from_numpy(tobs).cuda()
    torch.cuda.synchronize()
    reset_counts()
    for i in range(2):
        t0 = time.perf_counter()
        paths = gpu.decode_codes(obs_dev)
        walls[f"cuda Viterbi scan {VITERBI_R}x{VITERBI_T} run {i}"] = \
            time.perf_counter() - t0
    if read_counts() != only():
        raise AssertionError(f"Viterbi launched {read_counts()}")
    acc = float((paths == tstates).mean())
    if paths.shape != tobs.shape or paths.min() < 0 or acc < 0.6:
        raise AssertionError(f"Viterbi paths {paths.shape}, accuracy {acc}")
    sub = tobs[:ASSOC_R]
    cpu = mk.ViterbiDecoder(hmm, method="scan", device="cpu").decode_codes(sub)
    t0 = time.perf_counter()
    assoc = mk.ViterbiDecoder(hmm, method="assoc",
                              device="cuda").decode_codes(sub)
    walls[f"cuda Viterbi assoc {ASSOC_R}x{VITERBI_T}"] = \
        time.perf_counter() - t0
    if not (np.array_equal(cpu, paths[:ASSOC_R])
            and np.array_equal(assoc, cpu)):
        raise AssertionError("Viterbi paths differ between cuda scan, cpu "
                             "scan and cuda assoc")
    log(f"markov (b): Viterbi scan at {VITERBI_R} x {VITERBI_T} on cuda "
        f"{walls[f'cuda Viterbi scan {VITERBI_R}x{VITERBI_T} run 0']:.3f} s, "
        f"again {walls[f'cuda Viterbi scan {VITERBI_R}x{VITERBI_T} run 1']:.3f}"
        f" s, state accuracy {acc:.4f}; first {ASSOC_R} records equal on the "
        f"cpu scan and the cuda assoc "
        f"({walls[f'cuda Viterbi assoc {ASSOC_R}x{VITERBI_T}']:.3f} s)")
    obs_csv = os.path.join(work, "obs.csv")
    write_rows(obs_csv, hmm_seq.code_rows(tobs[:VITERBI_JOB_SEQS], o_names))
    model_dir = os.path.dirname(part)
    part, _ = both("ViterbiStatePredictor",
                   ["ViterbiStatePredictor",
                    f"-Dhmm.model.file.path={model_dir}", obs_csv])
    with open(part) as fh:
        lines = fh.read().splitlines()
    want = [",".join([f"C{r:07d}"] + [s_names[c] for c in row])
            for r, row in enumerate(paths[:VITERBI_JOB_SEQS])]
    if lines != want:
        raise AssertionError("ViterbiStatePredictor lines differ from "
                             "decode_codes")
    log(f"markov (b): ViterbiStatePredictor on {VITERBI_JOB_SEQS} sequences "
        f"(the cut: {VITERBI_JOB_SEQS} of {VITERBI_R} rows, the host string "
        f"work of 16.8M tokens costing more than it shows): cuda "
        f"{walls['cuda ViterbiStatePredictor']:.2f} s, cpu "
        f"{walls['cpu ViterbiStatePredictor']:.2f} s, byte-identical and "
        f"equal to decode_codes")


def lr_history(path: str):
    import numpy as np

    with open(path) as fh:
        lines = [ln for ln in fh.read().splitlines() if ln]
    return [np.array([float(v) for v in ln.split(",")]) for ln in lines
            if not ln.startswith("status")], lines[-1]


def close_histories(got, want, what: str) -> float:
    """Rows pairwise within LR_REL of the row's largest coefficient;
    returns the largest such relative difference."""
    import numpy as np

    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} vs {len(want)} iterations")
    worst = 0.0
    for g, w in zip(got, want):
        d = float(np.abs(g - w).max() / np.abs(w).max())
        if d > LR_REL:
            raise AssertionError(f"{what}: histories differ by {d}")
        worst = max(worst, d)
    return worst


def lr_phase(work: str, train: str, schema: str, walls: dict) -> None:
    """Phase 11 (c): LogisticRegressionJob on the 1M-row hospital CSV,
    whole input and in 250K-row chunks, on cuda and the CPU; then five
    iterations on cuda resumed from the coefficient file on the CPU."""
    common = [f"-Dfeature.schema.file.path={schema}"]
    hists = {}
    for mode, keys in (("whole", []),
                       ("streamed", [f"-Dstream.chunk.rows={CHUNK_ROWS}"])):
        for dev in ("cuda", "cpu"):
            out = os.path.join(work, f"lr_{mode}_{dev}")
            reset_counts()
            t0 = time.perf_counter()
            text = run_cli(["LogisticRegressionJob", *common, *keys, train,
                            out, "--device", dev])
            walls[f"{dev} LogisticRegressionJob {mode}"] = \
                time.perf_counter() - t0
            if read_counts() != only():
                raise AssertionError(f"LR launched {read_counts()}")
            hists[mode, dev] = (*lr_history(os.path.join(out, "part-00000")),
                                counter(text, "Run"))
        (g, gs, gn), (w, ws, wn) = hists[mode, "cuda"], hists[mode, "cpu"]
        if gs != ws or gn != wn:
            raise AssertionError(f"LR {mode}: {gs}/{gn} vs {ws}/{wn}")
        d = close_histories(g, w, f"LR {mode}")
        log(f"lr (c): LogisticRegressionJob {mode} on {ROWS_E2E} rows: cuda "
            f"{walls[f'cuda LogisticRegressionJob {mode}']:.2f} s, cpu "
            f"{walls[f'cpu LogisticRegressionJob {mode}']:.2f} s, {gn} "
            f"iterations, {gs}; histories within {d:.2e} of each row's "
            f"largest coefficient")
    coeff = os.path.join(work, "lr_resume_coeff.txt")
    keys = [*common, f"-Dcoeff.file.path={coeff}"]
    run_cli(["LogisticRegressionJob", *keys, "-Diteration.limit=5", train,
             os.path.join(work, "lr_first"), "--device", "cuda"])
    run_cli(["LogisticRegressionJob", *keys, train,
             os.path.join(work, "lr_rest"), "--device", "cpu"])
    got, status = lr_history(os.path.join(work, "lr_rest", "part-00000"))
    want, want_status = hists["whole", "cuda"][:2]
    if status != want_status:
        raise AssertionError(f"resumed LR {status} vs {want_status}")
    d = close_histories(got, want, "resumed LR")
    log(f"lr (c): 5 iterations on cuda resumed on the cpu from the "
        f"coefficient file: {len(got)} iterations, {status}, within {d:.2e} "
        f"of the straight cuda run")


def families_phase(rec: Recorder, work: str, train: str, schema: str,
                   walls: dict) -> int:
    """Phase 11: (a), (b) and (c) above; returns the forest's B4
    launches."""
    t0 = time.perf_counter()
    b4 = forest_phase(rec, work, train, schema, walls)
    markov_phase(work, walls)
    lr_phase(work, train, schema, walls)
    walls["families phase"] = time.perf_counter() - t0
    log(f"families: phase 11 in {walls['families phase']:.1f} s on "
        f"{card_line()}")
    return b4


# phase 11b: the bandit family and its price loop, NumericalAttrStats,
# the text jobs and the online learners; sizes in the module docstring
BANDIT_GROUPS = 1_000_000
BANDIT_ARMS = 12
BANDIT_JOB_GROUPS = 100_000
PRICE_PRODUCTS = 100
PRICE_ROUNDS = 20
TEXT_LINES = 200_000
TEXT_VALIDATE = 50_000
TEXT_WORDS = 12
TEXT_VOCAB = 20_000
RL_EVENTS = 10_000
MOMENT_RTOL = 1e-12


def bandit_state(g: int, k: int, seed: int, ragged: float):
    """counts, mean rewards and valid mask [g, k]: a share ``ragged`` of the
    groups with 2..k arms, the rest with k; about 5% of the valid arms
    untried."""
    import numpy as np

    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 50, (g, k)).astype(np.float64)
    counts[rng.random((g, k)) < 0.05] = 0
    arms = np.where(rng.random(g) < ragged, rng.integers(2, k + 1, g), k)
    valid = np.arange(k)[None, :] < arms[:, None]
    counts[~valid] = 0
    rewards = np.where(counts > 0, rng.random((g, k)) * 100.0, 0.0)
    return counts, rewards, valid


def selection_phase(walls: dict) -> None:
    """Phase 11b (a): the three device selection functions at 1M groups ×
    12 arms on cuda and the CPU, selections equal.  Each is called twice:
    the first call draws on the host (numpy threefry, timed inside) and
    selects on the device; the second finds its draws kept from the
    first, so its wall is the device selection with its copies."""
    import types

    import numpy as np
    import torch

    from avenir_tpu_torch.models import bandits
    from avenir_tpu_torch.utils import prng

    g, k = BANDIT_GROUPS, BANDIT_ARMS
    counts, rewards, valid = bandit_state(g, k, seed=31, ragged=0.5)
    key = prng.prng_key(7)
    kept, draw_s = {}, [0.0]

    def keep(fn):
        def call(key, shape, *args):
            at = (fn.__name__, key.tobytes(), tuple(np.atleast_1d(shape)), args)
            if at not in kept:
                t0 = time.perf_counter()
                kept[at] = fn(key, shape, *args)
                draw_s[0] += time.perf_counter() - t0
            return kept[at]
        return call

    eps = np.random.default_rng(3).random(g).astype(np.float32) * 0.5
    picks, row = {}, {}
    bandits.prng = types.SimpleNamespace(split=prng.split,
                                         uniform=keep(prng.uniform),
                                         gumbel=keep(prng.gumbel))
    try:
        for dev in ("cuda", "cpu"):
            c, r, v = bandits._state_tensors(counts, rewards, valid,
                                             torch.device(dev))
            e = torch.from_numpy(eps).to(dev)
            fns = {"epsilon_greedy": lambda: bandits.epsilon_greedy_select(key, c, r, v, e),
                   "ucb1": lambda: bandits.ucb1_select(key, c, r, v),
                   "softmax": lambda: bandits.softmax_select(key, c, r, v, 0.1)}
            for name, fn in fns.items():
                kept.clear()
                draw_s[0] = 0.0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn().cpu()
                row[f"{dev} {name} s"] = time.perf_counter() - t0
                row[f"{dev} {name} host draw s"] = draw_s[0]
                t0 = time.perf_counter()
                picks[dev, name] = fn().cpu().numpy()
                row[f"{dev} {name} device selection s"] = time.perf_counter() - t0
    finally:
        bandits.prng = prng
    for name in ("epsilon_greedy", "ucb1", "softmax"):
        if not np.array_equal(picks["cuda", name], picks["cpu", name]):
            n = int((picks["cuda", name] != picks["cpu", name]).sum())
            raise AssertionError(f"{name}: {n} selections differ cuda vs cpu")
    walls.update({f"bandit select {n}": s for n, s in row.items()})
    log(f"bandits (a): {g} groups x {k} arms, selections equal cuda vs cpu; "
        f"{json.dumps(row)} on {card_line()}")


def write_lines(path: str, lines) -> None:
    with open(path, "w") as fh:
        fh.write("\n".join(lines))
        fh.write("\n")


BANDIT_JOBS = [("GreedyRandomBandit", ["-Dprob.reduction.algorithm=auer",
                                       "-Dauer.greedy.constant=2"]),
               ("AuerDeterministic", []),
               ("SoftMaxBandit", ["-Dtemp.constant=0.1"]),
               ("RandomFirstGreedyBandit", ["-Dexploration.count.factor=2"])]


def bandit_jobs_phase(work: str, walls: dict) -> None:
    """Phase 11b (b): the four bandit jobs through the CLI on 100K groups ×
    12 arms on cuda and the CPU, part files byte-identical."""
    counts, rewards, valid = bandit_state(BANDIT_JOB_GROUPS, BANDIT_ARMS,
                                          seed=32, ragged=0.1)
    data = os.path.join(work, "bandit_state.csv")
    write_lines(data, (f"grp{gi:06d},item{ai},{int(counts[gi, ai])},"
                       f"{rewards[gi, ai]:.4f}"
                       for gi, ai in zip(*valid.nonzero())))
    row = {}
    for job, props in BANDIT_JOBS:
        outs = {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(work, f"{dev}_{job}")
            t0 = time.perf_counter()
            text = run_cli([f"org.avenir.reinforce.{job}", *props, "-Dseed=3",
                            "-Dcurrent.round.num=4", data, out, "--device", dev])
            row[f"{dev} {job}"] = time.perf_counter() - t0
            if counter(text, "Selected") != BANDIT_JOB_GROUPS:
                raise AssertionError(f"{job} selected for {counter(text, 'Selected')} groups")
            outs[dev] = os.path.join(out, "part-00000")
        same_bytes(outs["cuda"], outs["cpu"], job)
    walls.update({f"bandit job {n}": s for n, s in row.items()})
    log(f"bandits (b): {int(valid.sum())} rows of {BANDIT_JOB_GROUPS} groups, "
        f"the four jobs byte-identical cuda vs cpu; walls s {json.dumps(row)} "
        f"on {card_line()}")


def price_loop(work: str, tag: str, job: str, props: dict, dev: str):
    """The tutorial's round loop, file for file, on ``dev`` → (every round's
    (selection, aggregate) bytes, how many products the last round priced
    at or next to their optimum)."""
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.datagen.price_opt import generate_price_opt
    from avenir_tpu_torch.jobs import get_job

    sim = generate_price_opt(n_products=PRICE_PRODUCTS, seed=5)
    base = os.path.join(work, f"price_{tag}_{dev}")
    indir = os.path.join(base, "input")
    os.makedirs(indir)
    write_lines(os.path.join(indir, "agg.txt"),
                [f"{pid},{price},0,0,0" for pid, p in sim.products.items()
                 for price in p.prices])
    files = []
    for rnd in range(1, PRICE_ROUNDS + 1):
        conf = JobConfig({"current.round.num": str(rnd), "count.ordinal": "2",
                          "reward.ordinal": "4", "seed": str(100 + rnd), **props})
        get_job(job).run(conf, indir, os.path.join(base, "select"), device=dev)
        with open(os.path.join(base, "select", "part-00000"), "rb") as fh:
            sel = fh.read()
        picks = [ln.split(",") for ln in sel.decode().splitlines()]
        write_lines(os.path.join(indir, f"inc_{rnd}.txt"),
                    [f"{pid},{price},{sim.reward(pid, price):.3f}"
                     for pid, price in picks])
        get_job("org.chombo.mr.RunningAggregator").run(
            JobConfig({"quantity.attr": "2", "incremental.file.prefix": "inc"}),
            indir, os.path.join(base, "agg_out"), device=dev)
        with open(os.path.join(base, "agg_out", "part-00000"), "rb") as fh:
            agg_bytes = fh.read()
        files.append((sel, agg_bytes))
        shutil.rmtree(indir)
        os.makedirs(indir)
        with open(os.path.join(indir, "agg.txt"), "wb") as fh:
            fh.write(agg_bytes)
    near = 0
    for pid, price in picks:
        p = sim.products[pid]
        near += abs(p.prices.index(int(price)) - p.prices.index(p.optimal_price)) <= 1
    return files, near


def price_phase(work: str, walls: dict) -> None:
    """Phase 11b (c): the price-optimisation loop at the tutorial's 100
    products for 20 rounds with GreedyRandomBandit and SoftMaxBandit on
    cuda and the CPU, every round's files byte-identical."""
    row = {}
    for tag, job, props in (
            ("greedy", "org.avenir.reinforce.GreedyRandomBandit",
             {"prob.reduction.algorithm": "linear",
              "random.selection.prob": "0.5", "prob.reduction.constant": "8.0"}),
            ("softmax", "org.avenir.reinforce.SoftMaxBandit",
             {"temp.constant": "0.05"})):
        runs = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            runs[dev] = price_loop(work, tag, job, props, dev)
            row[f"{dev} {tag}"] = time.perf_counter() - t0
        for rnd, (a, b) in enumerate(zip(runs["cuda"][0], runs["cpu"][0]), 1):
            if a != b:
                raise AssertionError(f"price loop {tag}: round {rnd} differs "
                                     f"cuda vs cpu")
        row[f"{tag} near-optimal of {PRICE_PRODUCTS}"] = runs["cuda"][1]
    walls.update({f"price loop {n}": s for n, s in row.items()
                  if n.endswith(("greedy", "softmax"))})
    log(f"bandits (c): price loop {PRICE_PRODUCTS} products x {PRICE_ROUNDS} "
        f"rounds, every round's selection and aggregate byte-identical cuda "
        f"vs cpu; {json.dumps(row)} on {card_line()}")


def numerical_stats_phase(work: str, train: str, schema: str,
                          walls: dict) -> None:
    """Phase 11b (d): NumericalAttrStats on phase 3's 1M-row hospital CSV,
    conditioned on the class column and not, whole and in 250K-row chunks,
    on cuda and the CPU: count, min and max equal, moments within rtol
    1e-12, the largest gap printed."""
    import numpy as np

    row, worst = {}, 0.0
    for cond in (True, False):
        for chunk in (None, CHUNK_ROWS):
            tag = f"{'cond' if cond else 'all'} {'chunked' if chunk else 'whole'}"
            props = [f"-Dfeature.schema.file.path={schema}"]
            props += ["-Dcond.attr.ord=11"] if cond else []
            props += [f"-Dstream.chunk.rows={chunk}"] if chunk else []
            files = {}
            for dev in ("cuda", "cpu"):
                out = os.path.join(work, f"nas_{dev}_{len(props)}_{bool(chunk)}")
                t0 = time.perf_counter()
                text = run_cli(["org.chombo.mr.NumericalAttrStats", *props,
                                train, out, "--device", dev])
                row[f"{dev} {tag}"] = time.perf_counter() - t0
                if counter(text, "Processed") != ROWS_E2E:
                    raise AssertionError(f"NumericalAttrStats {tag} counted "
                                         f"{counter(text, 'Processed')} rows")
                with open(os.path.join(out, "part-00000")) as fh:
                    files[dev] = fh.read().splitlines()
            if len(files["cuda"]) != len(files["cpu"]) or len(files["cuda"]) != (6 if cond else 3):
                raise AssertionError(f"NumericalAttrStats {tag}: {len(files['cuda'])} "
                                     f"and {len(files['cpu'])} lines")
            for a, b in zip(files["cuda"], files["cpu"]):
                fa, fb = a.split(","), b.split(",")
                if fa[:-7] != fb[:-7] or fa[-2:] != fb[-2:]:
                    raise AssertionError(f"NumericalAttrStats {tag}: {a!r} vs {b!r}")
                x = np.array([float(v) for v in fa[-7:-2]])
                y = np.array([float(v) for v in fb[-7:-2]])
                gap = float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-300)))
                if gap > MOMENT_RTOL:
                    raise AssertionError(f"NumericalAttrStats {tag}: moments "
                                         f"{gap} apart: {a!r} vs {b!r}")
                worst = max(worst, gap)
    walls.update({f"NumericalAttrStats {n}": s for n, s in row.items()})
    log(f"stats (d): NumericalAttrStats on {ROWS_E2E} rows, count/min/max "
        f"equal cuda vs cpu, moments at most {worst:.3e} apart (relative); "
        f"walls s {json.dumps(row)} on {card_line()}")


def zipf_corpus(path: str, lines: int, seed: int) -> None:
    """``text,class`` lines of TEXT_WORDS words drawn from a Zipf vocabulary
    of TEXT_VOCAB words (letters with English suffixes); class ``spam``
    shifts the ranks, so the classes differ."""
    import numpy as np

    suffixes = ["", "s", "ing", "ed", "ation", "ness"]
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    idx = np.arange(TEXT_VOCAB)
    stems = ["".join(letters[[(i // 26 ** p) % 26 for p in range(4)]]) for i in idx]
    vocab = np.array([s + suffixes[i % len(suffixes)] for i, s in enumerate(stems)])
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 2, lines)
    ranks = np.minimum(rng.zipf(1.3, (lines, TEXT_WORDS)), TEXT_VOCAB) - 1
    ranks = (ranks + 97 * cls[:, None]) % TEXT_VOCAB
    words = vocab[ranks]
    names = np.array(["ham", "spam"])[cls]
    write_lines(path, (" ".join(w) + "," + c for w, c in zip(words, names)))


def text_phase(work: str, walls: dict) -> None:
    """Phase 11b (e): WordCounter, then NB text train and validate, on a
    seeded two-class Zipf corpus, on cuda and the CPU; part files
    byte-identical."""
    corpus = os.path.join(work, "corpus.txt")
    held = os.path.join(work, "corpus_validate.txt")
    t0 = time.perf_counter()
    zipf_corpus(corpus, TEXT_LINES, seed=41)
    zipf_corpus(held, TEXT_VALIDATE, seed=42)
    row = {"corpus generation": time.perf_counter() - t0}
    outs, texts = {}, {}
    for dev in ("cuda", "cpu"):
        steps = [
            ("WordCounter", ["org.avenir.text.WordCounter",
                             "-Dtext.field.ordinal=0", corpus]),
            ("NB text train", ["BayesianDistribution", "-Dtabular.input=false",
                               corpus]),
            ("NB text validate", [
                "BayesianPredictor", "-Dtabular.input=false",
                "-Dprediction.mode=validation",
                "-Dpositive.class.value=spam",
                f"-Dbayesian.model.file.path={os.path.join(work, dev + '_NB_text_train')}",
                held])]
        for name, argv in steps:
            out = os.path.join(work, f"{dev}_{name.replace(' ', '_')}")
            t0 = time.perf_counter()
            texts[dev, name] = run_cli([*argv, out, "--device", dev])
            row[f"{dev} {name}"] = time.perf_counter() - t0
            outs[dev, name] = os.path.join(out, "part-00000")
    for name in ("WordCounter", "NB text train", "NB text validate"):
        same_bytes(outs["cuda", name], outs["cpu", name], name)
        if texts["cuda", name] != texts["cpu", name]:
            raise AssertionError(f"{name}: counters differ cuda vs cpu")
    acc = counter(texts["cuda", "NB text validate"], "accuracy")
    if acc < 70:
        raise AssertionError(f"NB text validation accuracy {acc}")
    distinct = counter(texts["cuda", "WordCounter"], "Distinct")
    walls.update({f"text {n}": s for n, s in row.items()})
    log(f"text (e): {TEXT_LINES} lines x {TEXT_WORDS} words, {distinct} "
        f"distinct words, NB validation accuracy {acc} on {TEXT_VALIDATE} "
        f"held-out lines; part files byte-identical cuda vs cpu; walls s "
        f"{json.dumps(row)} on {card_line()}")


def learners_phase(walls: dict) -> None:
    """Phase 11b (f): the lead_gen closed loop through
    ReinforcementLearnerServer for each learner at RL_EVENTS events, each
    converging to page3; events/s and p50/p99 latency."""
    from avenir_tpu_torch.datagen.lead_gen import BEST_ACTION, LeadGenSimulator
    from avenir_tpu_torch.models.online_rl import LEARNER_REGISTRY, create_learner
    from avenir_tpu_torch.pipeline import ReinforcementLearnerServer

    rows = {}
    for name in sorted(LEARNER_REGISTRY):
        sim = LeadGenSimulator(n_events=RL_EVENTS, seed=3)
        learner = create_learner(name, sim.actions, {
            "min.sample": 20, "min.reward.distr.sample": 20,
            "prob.reduction.constant": 30.0, "max.reward": 100.0}, seed=5)
        srv = ReinforcementLearnerServer(learner, events=sim, rewards=sim,
                                         actions=sim)
        t0 = time.perf_counter()
        n = srv.run()
        wall = time.perf_counter() - t0
        stats = srv.stats()["rl"]
        if n != RL_EVENTS or stats["requests"] != RL_EVENTS:
            raise AssertionError(f"{name}: served {n} of {RL_EVENTS} events")
        if sim.best_selected() != BEST_ACTION:
            raise AssertionError(f"{name} converged to {sim.best_selected()}: "
                                 f"{sim.selections}")
        rows[name] = {"events_per_s": RL_EVENTS / wall, "wall_s": wall,
                      "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
                      "share_page3": sim.selections[BEST_ACTION] / RL_EVENTS}
        walls[f"rl {name}"] = wall
    log(f"learners (f): lead_gen {RL_EVENTS} events each, all converged to "
        f"{BEST_ACTION}: {json.dumps(rows)} on {card_line()}")


def bandit_text_phase(work: str, train: str, schema: str, walls: dict) -> None:
    """Phase 11b: (a)-(f) above, between a reset and a read of the launch
    counts: no kernel runs on these paths."""
    t0 = time.perf_counter()
    reset_counts()
    selection_phase(walls)
    bandit_jobs_phase(work, walls)
    price_phase(work, walls)
    numerical_stats_phase(work, train, schema, walls)
    text_phase(work, walls)
    learners_phase(walls)
    counts = read_counts()
    if counts != only():
        raise AssertionError(f"phase 11b launched kernels: {counts}")
    walls["phase 11b"] = time.perf_counter() - t0
    log(f"phase 11b in {walls['phase 11b']:.1f} s, launches {json.dumps(counts)} "
        f"on {card_line()}")


def path_cases(hist, rec: Recorder) -> list:
    """Phase 6: each kernel against its plain version, exactly, on every
    input the driven paths gave it on cuda; the first call of each path and
    shape (and, apart, the first whose rows are all ballast) is timed with
    its plain version, yardstick and bound.  The bound
    counts this data's work: the rows that carry a valid label (selector)
    and at least one valid code, which leaves out a tree's settled rows."""
    import torch

    results, timed, seen = [], set(), {}
    for name, path, args, _kwargs in rec.calls:
        if name not in ("cooc_counts_cols", "cross_cooc_counts_cols"):
            continue
        codes, vec, b, k = args
        i = seen[path] = seen.get(path, -1) + 1
        f, n = codes.shape
        cross = name == "cross_cooc_counts_cols"
        if cross:
            kid, shape, wp = "B4", f"{f}x{b}, {k} selectors", None
            fn, ref = hist.cross_cooc_counts_cols, hist.cross_cooc_counts_cols_ref
        else:
            mode, _jcp, wp = hist.plan(f, b, k)
            kid = {"cls": "B2", "clsb": "B3"}.get(mode, "B1")
            shape = f"{f}x{b}x{k} ({mode}, wp {wp})"
            fn, ref = hist.cooc_counts_cols, hist.cooc_counts_cols_ref
        got, want = fn(codes, vec, b, k), ref(codes, vec, b, k)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        label = f"{path} call {i}: {shape} at {n} rows"
        if not torch.equal(got, want):
            raise AssertionError(f"{kid} disagrees with its plain version on "
                                 f"{label}: max |diff| {err}")
        row = {"kernel": kid, "path": path, "call": i, "case": label, "n": n,
               "max_abs_err": err}
        # a call whose every row is ballast (a stream's warm pane) is timed
        # apart from a call of real rows at the same shape
        ballast = not bool(((vec >= 0) & (vec < k)).any())
        if (path, shape, n, ballast) not in timed:
            timed.add((path, shape, n, ballast))
            big = n >= 1_000_000
            row["ms"] = time_ms(lambda: fn(codes, vec, b, k),
                                iters=10 if big else 20)
            row["plain_ms"] = time_ms(lambda: ref(codes, vec, b, k),
                                      iters=3 if big else 5, warmup=1)
            if cross:
                call, keep = cross_library(codes, vec, b, k)
                lib = call().to(torch.int32).reshape(f, b, k)
            else:
                call, keep = (library_gram if kid == "B1"
                              else per_class_library)(codes, vec, b, k)
                lib = call()
            if not torch.equal(lib, got):
                raise AssertionError(f"library yardstick disagrees on {label}")
            row["library_ms"] = time_ms(call, iters=5 if big else 20)
            del keep, lib
            n_eff = int((((vec >= 0) & (vec < k))
                         & ((codes >= 0) & (codes < b)).any(0)).sum())
            if cross:
                row.update(cross_bound(f, n, b, k, n_eff))
            else:          # upper triangle of the used lanes (per class: F·B)
                row.update(gram_bound(f, n, *hist.gram_cells(f, b, k), n_eff))
            row["n_eff"] = n_eff
            log(f"{kid} path case:", json.dumps(row))
        results.append(row)
        del got, want
    torch.cuda.empty_cache()
    log(f"path cases: {len(results)} recorded calls equal to their plain "
        f"versions")
    return results


def hospital_tree_levels(hist) -> list:
    """The hospital tree (``DecisionTree`` at depth 4, as the tree jobs of
    phase 4 fit it) on 1M seeded hospital rows on cuda: its level tables
    recorded, then held and timed as phase 6 holds them."""
    from avenir_tpu_torch.core.encoding import DatasetEncoder
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.datagen.hosp_readmit import (HOSP_SCHEMA_JSON,
                                                      generate_hosp_readmit)
    from avenir_tpu_torch.models import tree

    enc = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON))
    ds = enc.fit_transform(generate_hosp_readmit(ROWS_E2E, seed=11))
    is_cat = [f.is_categorical for f in enc.binned_fields]
    rec = Recorder()
    with rec.on("tree"):
        tree.DecisionTree(max_depth=4, device="cuda").fit(ds, is_cat)
    return path_cases(hist, rec)


def host_us(fn, calls: int = 2000) -> float:
    """Host µs a call of ``fn`` takes, over ``calls`` calls back to back
    (the card idle under them: each enqueues, nothing waits)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def cross_main() -> int:
    """``--b4``: B4 alone — its build, the phase-2 cases, the hospital
    tree's level tables (phase 6) and the host µs of a 1-row call — as one
    JSON line.  It measures the ``avenir_tpu_torch`` beside this file, so
    a copy of this file in another checkout measures that checkout."""
    import torch

    from avenir_tpu_torch.ops import _build, hist
    from avenir_tpu_torch.runtime import native

    card = card_line()
    t0 = time.perf_counter()
    _build.build("cross")
    build_s = time.perf_counter() - t0
    codes = torch.ones((10, 1), dtype=torch.int32, device="cuda")
    sel = torch.ones(1, dtype=torch.int32, device="cuda")
    one_row_us = host_us(lambda: hist.cross_cooc_counts_cols(codes, sel, 13,
                                                             16))
    log(json.dumps({"checkout": HERE, "card": card, "build_s": build_s,
                    "one_row_host_us": one_row_us,
                    "phase2": cross_cases(hist),
                    "tree": hospital_tree_levels(hist)}))
    return 0


# ---------------------------------------------------------------------------
# kNN: B5 (knn_tourney.cu) and B6 (knn_topk.cu)
# ---------------------------------------------------------------------------

def knn_data(n, m, f, fc, nb, seed, dup=1):
    """Seeded references and queries as knn_qps.make_ds draws them (codes
    uniform, continuous normal, normalized to the references' range), on
    the card: (q_mat, r_mat, n_real, codes_q, cont01_q, codes_r, cont01_r,
    w_used).  ``dup`` > 1 repeats the first n / dup references."""
    import numpy as np
    import torch

    from avenir_tpu_torch.models import knn as mknn
    from avenir_tpu_torch.ops import knn as tk

    rng = np.random.default_rng(seed)
    base = -(-n // dup)
    codes_r = np.tile(rng.integers(0, nb, (base, f)).astype(np.int32),
                      (dup, 1))[:n]
    cont_r = np.tile(rng.normal(size=(base, fc)).astype(np.float32),
                     (dup, 1))[:n]
    codes_q = rng.integers(0, nb, (m, f)).astype(np.int32)
    cont_q = rng.normal(size=(m, fc)).astype(np.float32)
    lo, hi = cont_r.min(0), cont_r.max(0)
    cr01 = mknn._normalize01(cont_r, lo, hi)
    cq01 = mknn._normalize01(cont_q, lo, hi)
    r_mat, n_real = tk.prepare_refs(codes_r, cr01, nb)
    q_mat, _ = tk.prepare_queries(codes_q, cq01, nb)
    dev = torch.device("cuda")
    return (q_mat.to(dev), r_mat.to(dev), n_real,
            torch.from_numpy(codes_q).to(dev), torch.from_numpy(cq01).to(dev),
            torch.from_numpy(codes_r).to(dev), torch.from_numpy(cr01).to(dev),
            tk.used_lanes(f, nb, fc))


def knn_bound(kid, q, r, m, n, w_used):
    """(bound ms, what bounds it): 2·m·n·w bf16 operations over the used
    lanes w = F·B + 6·Fc + 6 at 989 TFLOP/s, against the operands read once
    and the outputs written once at 3.35 TB/s."""
    from avenir_tpu_torch.ops import knn as tk

    out = (3 * q.shape[0] * tk._round_up(r.shape[0] // tk.SEG, 128) * 4
           if kid == "B5" else q.shape[0] * tk.SLOTS * 8)
    nbytes = (q.numel() + r.numel()) * 2 + out
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    ops_ms = 2 * m * n * w_used / PEAK_BF16_FLOPS * 1e3
    return max(bytes_ms, ops_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def tourney_library(q, r):
    """The B5 yardstick: per 16,384-row block, cuBLAS's bf16 A @ Bᵀ and
    torch.topk(3) over each 2048-row segment."""
    from avenir_tpu_torch.ops import knn as tk

    def call():
        return [(q @ r[s0:s0 + tk.TB].T).view(q.shape[0], -1, tk.SEG)
                .topk(3, dim=2, largest=False).values
                for s0 in range(0, r.shape[0], tk.TB)]
    return call


def topk_library(q, r, kk):
    """The B6 yardstick: per 16,384-row block, cuBLAS's bf16 A @ Bᵀ and
    torch.topk(kk) over each row, merged across blocks by one more topk."""
    import torch

    from avenir_tpu_torch.ops import knn as tk

    def call():
        best = None
        for s0 in range(0, r.shape[0], tk.TB):
            v = (q @ r[s0:s0 + tk.TB].T).topk(kk, dim=1, largest=False).values
            best = v if best is None else torch.cat([best, v], 1).topk(
                kk, dim=1, largest=False).values
        return best
    return call


def topk_ranges(q, r, kk, splits=None) -> int:
    """The number of reference ranges B6 runs for these operands."""
    import torch

    from avenir_tpu_torch.ops import knn as tk

    with torch.cuda.device(q.device):
        rows, slots = tk._topk_geometry(q.device.index, q.shape[1], kk)
    return tk.topk_splits(q.shape[0], r.shape[0], kk, rows, slots, splits)[0]


def check_tourney(q, r, got, want, what):
    """B5 against its plain version.  Both sum the same exact bf16 products
    in float32 in another order, so a d² may differ by ~1e-6, which near
    zero spans several truncation steps and may swap near-tied columns.
    Each key's truncated d² must equal the plain version's within
    KEY_TOL + one step (2⁻¹² relative); a key whose column differs must
    name a reference whose d², recomputed, is within the same of the
    kernel's.  Returns (keys that differ, keys whose column differs,
    max |Δ truncated d²| over real references)."""
    import torch

    differ = swapped = 0
    worst = 0.0
    seg_base = torch.arange(got[0].shape[1], device=q.device) * 2048
    for g, w in zip(got, want):
        dg = (g & ~2047).view(torch.float32)
        dw = (w & ~2047).view(torch.float32)
        real = dw < PAD_D2             # pad references sit at ~1e30
        gap = (dg - dw).abs()
        tol = KEY_TOL + torch.maximum(dg, dw) * 2.0 ** -12
        if bool(((gap > tol) & real).any()):
            raise AssertionError(f"B5 keys on {what} differ by up to "
                                 f"{float(gap[real].max())} in d²")
        if bool(real.any()):
            worst = max(worst, float(gap[real].max()))
        differ += int((g != w).sum())
        moved = ((g & 2047) != (w & 2047)) & real
        swapped += int(moved.sum())
        if bool(moved.any()):
            rows, segs = moved.nonzero(as_tuple=True)
            refs = seg_base[segs] + (g[rows, segs] & 2047)
            d2 = (q[rows].float() * r[refs].float()).sum(1)
            if bool(((d2 - dg[rows, segs]).abs()
                     > tol[rows, segs]).any()):
                raise AssertionError(f"B5 on {what} names a reference whose "
                                     f"d² is not its key's")
    return differ, swapped, worst


def check_topk(got, want, kk, exact, what):
    """B6 against its plain version.  Exact data: equal.  Otherwise every
    slot's d² within 1e-5 and the kept sets equal but for members within
    2e-5 of the row's kk-th d².  Returns (rows whose sets differ, max |Δd²|
    over the kk slots)."""
    import torch

    (d, i), (wd, wi) = got, want
    if not (torch.equal(i[:, kk:], wi[:, kk:]) and torch.equal(d[:, kk:], wd[:, kk:])):
        raise AssertionError(f"B6 slots past kk on {what} are not empty")
    # pad references (d² ~1e30, a float32 ulp there ~1e23) are held by
    # index: every pad has the same d² within one computation
    pad = wd[:, :kk] >= PAD_D2
    if not torch.equal(pad, d[:, :kk] >= PAD_D2) or \
            not torch.equal(i[:, :kk][pad], wi[:, :kk][pad]):
        raise AssertionError(f"B6 pad slots on {what} differ")
    worst = float((d[:, :kk] - wd[:, :kk]).abs()[~pad].max())
    if exact:
        if not (torch.equal(d, wd) and torch.equal(i, wi)):
            raise AssertionError(f"B6 disagrees with its plain version on {what}")
        return 0, worst
    if worst > KEY_TOL:
        raise AssertionError(f"B6 d² on {what} differ by {worst}")
    mine, theirs = i[:, :kk], wi[:, :kk]
    in_theirs = (mine[:, :, None] == theirs[:, None, :]).any(2)
    in_mine = (theirs[:, :, None] == mine[:, None, :]).any(2)
    edge = torch.where(pad, -1.0, wd[:, :kk]).max(1, keepdim=True).values
    far = (((d[:, :kk] - edge).abs() > 2e-5) & ~in_theirs).any() | \
        (((wd[:, :kk] - edge).abs() > 2e-5) & ~in_mine).any()
    if bool(far):
        raise AssertionError(f"B6 kept sets on {what} differ away from the "
                             f"kk-th d²")
    return int((~in_theirs).any(1).sum()), worst


def knn_cases():
    """Phase 7: B5 and B6 against their plain versions on the card, timed
    with the plain version, the library yardstick and the bound."""
    import torch

    from avenir_tpu_torch.ops import knn as tk

    cases = [
        ("B5", "categorical 6x10, 4096 x 262144 refs", 262_144, 6, 0, 18, 1),
        # 5 × 10 + 6 = 56 used lanes: the kernel contracts 64 of W = 128
        ("B5", "categorical 5x10 (contracted 64 of W 128), 4096 x 262144 refs",
         262_144, 5, 0, 18, 1),
        ("B6", "categorical 5x10 (contracted 64 of W 128), 4096 x 16384 refs, "
         "kk 18", 16_384, 5, 0, 18, 1),
        ("B5", "knn_qps shape 6x10 + 8 continuous, 4096 x 1M refs",
         KNN_REFS, 6, 8, 18, 1),
        ("B5", "short last block, n = 8*2048 + 1 (4x6 + 3 continuous)",
         8 * 2048 + 1, 4, 3, 20, 1),
        ("B6", "categorical 6x10, 4096 x 16384 refs, kk 18", 16_384, 6, 0, 18, 1),
        ("B6", "categorical 6x10, 4096 x 16384 refs, kk 128", 16_384, 6, 0, 128, 1),
        ("B6", "mixed 6x10 + 8, 4096 x 16384 refs, kk 18", 16_384, 6, 8, 18, 1),
        ("B6", "mixed 6x10 + 8, 4096 x 16384 refs, kk 128", 16_384, 6, 8, 128, 1),
        ("B6", "tiny set n = 12, k = 10 (pads in the slots)", 12, 3, 2, 18, 1),
        ("B6", "heavy duplicates, 4096 x 16384 refs, kk 18", 16_384, 4, 2, 18, 160),
        # wider than the kernels keep resident: the query tile is streamed
        ("B5", "wide categorical 80x10 (W 896), 4096 x 65536 refs",
         65_536, 80, 0, 18, 1),
        ("B6", "wide categorical 268x10 (W 2688), 4096 x 16384 refs, kk 18",
         16_384, 268, 0, 18, 1),
    ]
    # the 10K NearestNeighbor path's shape (elearn: 9 continuous, w 60),
    # with the references in one range (no merge) and in the wrapper's
    path_shape = [
        ("B6", f"10K path shape 9 continuous, 2048 x 10240 refs, kk 18, {s}",
         10_240, 0, 9, 18, 1, 2048, splits)
        for s, splits in (("one reference range", 1),
                          ("the wrapper's ranges", None))]
    results = []
    for i, (kid, label, n, f, fc, kk, dup, m, splits) in enumerate(
            [c + (KNN_BATCH, None) for c in cases] + path_shape):
        q, r, n_real, cq, xq, cr, xr, w_used = knn_data(
            n, m, f, fc, 10, seed=300 + i, dup=dup)
        reset_counts()
        wc = tk.contraction_width(q.shape[1], w_used)
        if kid == "B5":
            got = tk.knn_tourney(q, r, used=w_used)
            want = tk.knn_tourney_ref(q, r)
            torch.cuda.synchronize()
            differ, swapped, err = check_tourney(q, r, got, want, label)
            if fc == 0 and differ:
                raise AssertionError(f"B5 keys on exact d² differ: {label}")
            row = {"keys_differ": differ, "columns_differ": swapped}
            if n == KNN_REFS:
                # assembled, re-ranked results and certificates equal
                res = [tk.finish(cq, xq, cr, xr, n_real,
                                 tk.assemble(o, KNN_BATCH, kk), KNN_K, f + fc)
                       for o in (got, want)]
                for a, b in zip(*res):
                    if not torch.equal(a, b):
                        raise AssertionError(f"B5 search results differ on "
                                             f"{label}")
                row["certified"] = int(res[0][2].sum())
            fn = lambda: tk.knn_tourney(q, r, used=w_used)  # noqa: E731
            ref = lambda: tk.knn_tourney_ref(q, r)  # noqa: E731
            lib = tourney_library(q, r)
        else:
            got = tk.knn_topk(q, r, kk, splits=splits, used=w_used)
            want = tk.knn_topk_ref(q, r, kk)
            torch.cuda.synchronize()
            swapped, err = check_topk(got, want, kk, fc == 0, label)
            row = {"rows_swapped_at_kk": swapped,
                   "splits": topk_ranges(q, r, kk, splits)}
            fn = lambda: tk.knn_topk(q, r, kk, splits=splits,  # noqa: E731
                                     used=w_used)
            ref = lambda: tk.knn_topk_ref(q, r, kk)  # noqa: E731
            lib = topk_library(q, r, kk)
        if read_counts()[kid] != 1:
            raise AssertionError(f"{kid} did not launch once on {label}")
        big = n >= KNN_REFS
        bound_ms, bound_by = knn_bound(kid, q, r, m, n_real, w_used)
        row.update({"kernel": kid, "case": label, "n": n_real, "m": m,
                    "w": q.shape[1], "w_used": w_used, "w_contracted": wc,
                    "kk": kk,
                    "max_abs_err": err,
                    "ms": time_ms(fn, iters=10 if big else 20),
                    "plain_ms": time_ms(ref, iters=3, warmup=1),
                    "library_ms": time_ms(lib, iters=5 if big else 20),
                    "bound_ms": bound_ms, "bound_by": bound_by})
        log(f"{kid} case:", json.dumps(row))
        results.append(row)
        del q, r, cq, xq, cr, xr, got, want
        torch.cuda.empty_cache()
    return results


class NeighborCapture:
    """Wraps ``models.knn.nearest_neighbors`` while on: keeps each call's
    (distances, indices) and the rows the exact scan served in it, and in
    ``used`` the last call's (used lanes w = F·B + 6·Fc + 6, test rows,
    references), taken from the model and test set it was given."""

    def __init__(self):
        self.calls = []
        self.used = None

    @contextlib.contextmanager
    def on(self):
        from avenir_tpu_torch.models import knn as mknn
        from avenir_tpu_torch.ops import knn as tk

        inner = mknn.nearest_neighbors

        def call(*args, **kwargs):
            import numpy as np

            mknn._nearest_neighbors_kernel.last_fallback = np.zeros(0, np.int64)
            model, test = args[0], args[1]
            self.used = (tk.used_lanes(model.codes.shape[1], model.num_bins,
                                       model.cont.shape[1]), test.num_rows,
                         model.num_refs)
            d, i = inner(*args, **kwargs)
            self.calls.append((d, i, mknn._nearest_neighbors_kernel.last_fallback))
            return d, i

        mknn.nearest_neighbors = call
        try:
            yield self
        finally:
            mknn.nearest_neighbors = inner


def same_but_fallback(a_path, b_path, cap_a, cap_b, per_row, what, rows=None):
    """Part files equal line for line, but for rows the exact scan served
    on either device, whose distances must agree within DIST_TOL; compares
    the first ``rows`` test rows (``per_row`` lines each).  Returns the
    number of rows the exact scan served on either device."""
    import numpy as np

    with open(a_path) as fa, open(b_path) as fb:
        a, b = fa.read().splitlines(), fb.read().splitlines()
    (da, _ia, fa_), (db, _ib, fb_) = cap_a.calls[-1], cap_b.calls[-1]
    n = rows if rows is not None else len(b) // per_row
    a, da = a[:n * per_row], da[:n]
    if len(a) != len(b) or len(b) != n * per_row:
        raise AssertionError(f"{what}: part files of {len(a)} and {len(b)} lines")
    served = set(fa_[fa_ < n].tolist()) | set(fb_.tolist())
    for r in range(n):
        if a[r * per_row:(r + 1) * per_row] != b[r * per_row:(r + 1) * per_row]:
            if r not in served:
                raise AssertionError(f"{what}: row {r} differs between cuda "
                                     f"and cpu and no scan served it")
    if served:
        s = sorted(served)
        gap = float(np.abs(da[s] - db[s]).max())
        if gap > DIST_TOL:
            raise AssertionError(f"{what}: scan-served rows' distances differ "
                                 f"by {gap}")
    return len(served)


def validation_counters(out: str) -> dict:
    return {name: counter(out, name)
            for name in ("accuracy", "recall", "precision", "correct",
                         "incorrect")}


def knn_job_phase(rec: Recorder, work: str, used: dict, walls: dict) -> dict:
    """Phase 8a: NearestNeighbor through the CLI on a seeded 1M-row elearn
    training CSV and 4,096 test rows on cuda (B5 once), then on the CPU
    for the first 1,024 test rows; returns the launches on cuda and puts
    the cuda run's shape (NeighborCapture.used) into ``used``."""
    from avenir_tpu_torch.core.csv_io import write_csv
    from avenir_tpu_torch.datagen.elearn import (ELEARN_SCHEMA_JSON,
                                                 generate_elearn)

    t0 = time.perf_counter()
    rows = generate_elearn(KNN_REFS + KNN_BATCH, seed=21)
    train = os.path.join(work, "elearn_train.csv")
    test = os.path.join(work, "elearn_test.csv")
    test_cpu = os.path.join(work, "elearn_test_cpu.csv")
    write_csv(train, rows[:KNN_REFS])
    write_csv(test, rows[KNN_REFS:])
    write_csv(test_cpu, rows[KNN_REFS:KNN_REFS + KNN_CPU_ROWS])
    schema = os.path.join(work, "elearn.json")
    with open(schema, "w") as fh:
        json.dump(ELEARN_SCHEMA_JSON, fh)
    log(f"knn job: generated {KNN_REFS} training rows in "
        f"{time.perf_counter() - t0:.1f} s")
    common = [f"-Dfeature.schema.file.path={schema}",
              f"-Dtraining.data.path={train}", f"-Dtop.match.count={KNN_K}"]
    caps, outs, counts = {}, {}, None
    for dev, data in (("cuda", test), ("cpu", test_cpu)):
        out = os.path.join(work, f"{dev}_knn")
        caps[dev] = NeighborCapture()
        reset_counts()
        t0 = time.perf_counter()
        with caps[dev].on(), (rec.on("knn_job") if dev == "cuda"
                              else contextlib.nullcontext()):
            run_cli(["NearestNeighbor", *common, data, out, "--device", dev])
        wall = walls[f"{dev} NearestNeighbor 1M"] = time.perf_counter() - t0
        fell = len(caps[dev].calls[-1][2])
        if dev == "cuda":
            counts = read_counts()
            if counts != only(B5=1):
                raise AssertionError(f"NearestNeighbor at 1M refs launched {counts}")
            used["knn_job"] = caps[dev].used
        log(f"knn job on {dev}: NearestNeighbor {wall:.2f} s over "
            f"{KNN_BATCH if dev == 'cuda' else KNN_CPU_ROWS} test rows; "
            f"launches {read_counts() if dev == 'cuda' else 'none (plain)'}; "
            f"{fell} rows failed the certificate and went to the exact scan")
        outs[dev] = os.path.join(out, "part-00000")
    served = same_but_fallback(outs["cuda"], outs["cpu"], caps["cuda"],
                               caps["cpu"], 1, "NearestNeighbor 1M",
                               rows=KNN_CPU_ROWS)
    log(f"knn job: the first {KNN_CPU_ROWS} predictions byte-identical cuda "
        f"vs cpu but for {served} rows the exact scan served (distances "
        f"within {DIST_TOL})")
    return {"knn_job": counts["B5"]}


def knn_small_phase(rec: Recorder, work: str, used: dict, walls: dict) -> dict:
    """Phase 8b: NearestNeighbor (validation, gaussian kernel) and
    SameTypeSimilarity on a 10,000-row elearn training CSV and 2,000 test
    rows, on cuda (B6) and cpu; returns B6's launches per job and puts
    each cuda run's shape into ``used``."""
    from avenir_tpu_torch.core.csv_io import write_csv
    from avenir_tpu_torch.datagen.elearn import (ELEARN_SCHEMA_JSON,
                                                 generate_elearn)

    rows = generate_elearn(12_000, seed=22)
    train = os.path.join(work, "small_train.csv")
    test = os.path.join(work, "small_test.csv")
    write_csv(train, rows[:10_000])
    write_csv(test, rows[10_000:])
    schema = os.path.join(work, "elearn_small.json")
    with open(schema, "w") as fh:
        json.dump(ELEARN_SCHEMA_JSON, fh)
    common = [f"-Dfeature.schema.file.path={schema}",
              f"-Dtraining.data.path={train}", f"-Dtop.match.count={KNN_K}"]
    jobs = [("knn_small_nn", ["NearestNeighbor", *common,
                              "-Dvalidation.mode=true",
                              "-Dkernel.function=gaussian",
                              "-Dpositive.class.value=F"], 1),
            ("knn_small_sts", ["SameTypeSimilarity", *common], KNN_K)]
    b6, caps, outs, text = {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        for name, argv, _per in jobs:
            out = os.path.join(work, f"{dev}_{name}")
            caps[dev, name] = NeighborCapture()
            reset_counts()
            t0 = time.perf_counter()
            with caps[dev, name].on(), (rec.on(name) if dev == "cuda"
                                        else contextlib.nullcontext()):
                text[dev, name] = run_cli([*argv, test, out, "--device", dev])
            wall = walls[f"{dev} {name}"] = time.perf_counter() - t0
            counts = read_counts()
            if dev == "cuda":
                if counts != only(B6=1):
                    raise AssertionError(f"{name} on cuda launched {counts}")
                b6[name] = counts["B6"]
                used[name] = caps[dev, name].used
            log(f"{name} on {dev}: {wall:.2f} s, launches {counts}, "
                f"{len(caps[dev, name].calls[-1][2])} rows went to the exact "
                f"scan")
            outs[dev, name] = os.path.join(out, "part-00000")
    for name, _argv, per in jobs:
        served = same_but_fallback(outs["cuda", name], outs["cpu", name],
                                   caps["cuda", name], caps["cpu", name], per,
                                   name)
        log(f"{name}: part files byte-identical cuda vs cpu but for {served} "
            f"scan-served rows")
    got, want = (validation_counters(text[d, "knn_small_nn"])
                 for d in ("cuda", "cpu"))
    if got != want:
        raise AssertionError(f"validation counters differ: {got} vs {want}")
    log(f"knn small: validation counters equal {got}")
    return b6


def knn_qps_phase(rec: Recorder, used: dict) -> dict:
    """Phase 8c: KNN.predict at the knn_qps shape (6 × 10 categorical + 8
    continuous, 1M references, one batch of 4,096 queries) on cuda,
    checked against a chunked float64 oracle on its first 256 rows; puts
    its shape into ``used``."""
    import numpy as np

    from avenir_tpu_torch.core.encoding import EncodedDataset
    from avenir_tpu_torch.models import knn as mknn

    def make_ds(rng, n, f=6, fc=8, nb=10):
        return EncodedDataset(
            codes=rng.integers(0, nb, size=(n, f)).astype(np.int32),
            cont=rng.normal(size=(n, fc)).astype(np.float32),
            labels=rng.integers(0, 2, size=n).astype(np.int32),
            ids=None, n_bins=np.full(f, nb, np.int32), class_values=["a", "b"],
            binned_ordinals=list(range(f)),
            cont_ordinals=list(range(f, f + fc)))

    rng = np.random.default_rng(0)
    est = mknn.KNN(k=KNN_K, device="cuda")
    model = est.fit(make_ds(rng, KNN_REFS))
    test = make_ds(rng, KNN_BATCH)
    cap = NeighborCapture()
    reset_counts()
    t0 = time.perf_counter()
    with cap.on(), rec.on("knn_qps"):
        res = est.predict(model, test)
    wall = time.perf_counter() - t0
    counts = read_counts()
    if counts != only(B5=1):
        raise AssertionError(f"KNN.predict at 1M refs launched {counts}")
    used["knn_qps"] = cap.used
    # the oracle: float64 d² in 16-row slices (a whole-batch broadcast
    # against 1M references would take ~16 GB)
    cq_all = mknn._normalize01(test.cont[:256], model.cont_lo, model.cont_hi)
    cr = model.cont01().astype(np.float64)
    worst = 0.0
    for r0 in range(0, 256, 16):
        cq = cq_all[r0:r0 + 16].astype(np.float64)
        mism = (test.codes[r0:r0 + 16, None, :] != model.codes[None]).sum(-1)
        d2 = mism + ((cq[:, None, :] - cr[None]) ** 2).sum(-1)
        od = np.sqrt(np.sort(d2, axis=1)[:, :KNN_K] / 14)
        worst = max(worst, float(np.abs(res.neighbor_dist[r0:r0 + 16] - od).max()))
    if worst > 1e-5:
        raise AssertionError(f"KNN.predict at 1M refs vs oracle: max |Δd| {worst}")
    log(f"knn_qps: KNN.predict of {KNN_BATCH} queries over {KNN_REFS} refs "
        f"on cuda {wall:.2f} s (first call: packs and uploads the refs); "
        f"launches {counts}; {len(cap.calls[-1][2])} rows went to the exact "
        f"scan; first 256 rows within {worst:.2e} of the float64 oracle")
    return {"knn_qps": counts["B5"]}


def planner_conf(work: str, name: str, train: str, test: str, schema: str,
                 **extra) -> str:
    """Phase 5b's pipeline conf declared as NB, a non-fusable stage (the NB
    predictor over the test rows, reading the model through ``@nb_model``),
    MI and Cramér (whose ``uses`` edge names the NB model), over phase 3's
    CSV in 250K-row chunks."""
    props = {
        "pipeline.stages": "nb,pred,mi,cramer",
        "pipeline.bind.train": train,
        "pipeline.bind.test": test,
        "pipeline.stage.nb.job": "BayesianDistribution",
        "pipeline.stage.nb.input": "train",
        "pipeline.stage.nb.output": "nb_model",
        "pipeline.stage.pred.job": "BayesianPredictor",
        "pipeline.stage.pred.input": "test",
        "pipeline.stage.pred.output": "nb_pred",
        "pipeline.stage.pred.prop.bayesian.model.file.path": "@nb_model",
        "pipeline.stage.mi.job": "MutualInformation",
        "pipeline.stage.mi.input": "train",
        "pipeline.stage.mi.output": "mi_out",
        "pipeline.stage.cramer.job": "CramerCorrelation",
        "pipeline.stage.cramer.input": "train",
        "pipeline.stage.cramer.output": "cramer_out",
        "pipeline.stage.cramer.prop.dest.attributes": "11",
        "pipeline.stage.cramer.uses": "nb_model",
        "feature.schema.file.path": schema,
        "stream.chunk.rows": str(CHUNK_ROWS),
        "mutual.info.score.algorithms": "mim,mifs,jmi,disr,mrmr",
        **extra,
    }
    return write_props(os.path.join(work, f"{name}.properties"), props)


def corr_conf(work: str, name: str, train: str, schema: str,
              **extra) -> str:
    """A correlation-only pipeline whose members read two of the hospital
    schema's ten binned columns (ordinals 4 and 5): Cramér of employment
    and family status against the class (ordinal 11), and heterogeneity
    of employment against family status."""
    props = {
        "pipeline.stages": "cramer,het",
        "pipeline.bind.train": train,
        "pipeline.stage.cramer.job": "CramerCorrelation",
        "pipeline.stage.cramer.input": "train",
        "pipeline.stage.cramer.output": "cramer_out",
        "pipeline.stage.cramer.prop.source.attributes": "4,5",
        "pipeline.stage.cramer.prop.dest.attributes": "11",
        "pipeline.stage.het.job": "HeterogeneityReductionCorrelation",
        "pipeline.stage.het.input": "train",
        "pipeline.stage.het.output": "het_out",
        "pipeline.stage.het.prop.source.attributes": "4",
        "pipeline.stage.het.prop.dest.attributes": "5",
        "pipeline.stage.het.prop.heterogeneity.algorithm": "uncertainty",
        "feature.schema.file.path": schema,
        "stream.chunk.rows": str(CHUNK_ROWS),
        **extra,
    }
    return write_props(os.path.join(work, f"{name}.properties"), props)


def planner_phase(rec: Recorder, work: str, train: str, test: str,
                  schema: str, walls: dict) -> dict:
    """Phase 12b: the planner on the card over phase 3's 1M-row CSV;
    returns B1's launches by path.

    (a) NB | BayesianPredictor | MI | Cramér staged and with ``plan.on``:
    part files byte-identical, the planned unit on the kernel route with
    fuse and share-gram fired, B1 once a 250K-row chunk in both runs;
    (b) the plan verb's explain printed; (c) a correlation-only pipeline
    planned through the pruned B1 width (2 of 10 binned columns), its part
    files byte-identical to the staged run's; (d) the same conf without
    ``stream.chunk.rows`` and with the heterogeneity stage opted out of
    packing (two units over one input) shows encode-once, B1 once a unit,
    part files byte-identical."""
    from avenir_tpu_torch.ops import hist

    chunks = -(-ROWS_E2E // CHUNK_ROWS)
    launches = {}

    def run(name, path, record=None, extra=()):
        ws = os.path.join(work, "ws_" + name)
        reset_counts()
        t0 = time.perf_counter()
        with rec.on(record) if record else contextlib.nullcontext():
            counters = run_pipeline(["run", path, f"-Dpipeline.workspace={ws}",
                                     *extra])
        walls[f"pipeline {name}"] = time.perf_counter() - t0
        return ws, counters, read_counts()

    def explain(path, extra=()):
        buf = io.StringIO()
        from avenir_tpu_torch.pipeline.__main__ import main as pmain

        with contextlib.redirect_stdout(buf):
            if pmain(["plan", "explain", path, *extra]) != 0:
                raise AssertionError("plan explain failed")
        return buf.getvalue()

    path = planner_conf(work, "planner", train, test, schema)
    ws_s, _c, staged = run("planner_staged", path)
    ws_p, counters, planned = run("planner_planned", path, "pipeline_planned",
                                  ["-Dplan.on=true"])
    for counts, what in ((staged, "staged"), (planned, "planned")):
        if counts != only(B1=chunks):
            raise AssertionError(f"planner {what} run launched {counts}")
    for a in ("nb_model", "nb_pred", "mi_out", "cramer_out"):
        same_bytes(os.path.join(ws_s, a, "part-00000"),
                   os.path.join(ws_p, a, "part-00000"), f"planner {a}")
    group = counters["mi"]["SharedScan"]
    if group != {"FusedStages": 3, "Scans": 1, "Chunks": chunks}:
        raise AssertionError(f"planned unit counters {group}")
    text = explain(path)
    log("planner (b): plan explain on cuda:\n" + text.rstrip())
    if ("rewrites: fuse, share-gram" not in text
            or "program: kernel" not in text
            or "stage pred: job=BayesianPredictor -- not a fusable count job"
            not in text):
        raise AssertionError("planner explain lacks the fired rewrites, the "
                             "kernel route or the staged predictor")
    launches["pipeline_planned"] = planned["B1"]
    log(f"planner (a): NB | predictor | MI | Cramer staged "
        f"{walls['pipeline planner_staged']:.2f} s (B1 {staged['B1']}), "
        f"planned {walls['pipeline planner_planned']:.2f} s (B1 "
        f"{planned['B1']}, one unit of 3 stages, fuse + share-gram); part "
        f"files byte-identical")

    cpath = corr_conf(work, "planner_corr", train, schema)
    ws_cs, _c, cstaged = run("corr_staged", cpath)
    ws_cp, ccount, cplanned = run("corr_planned", cpath, "pipeline_pruned",
                                  ["-Dplan.on=true"])
    for a in ("cramer_out", "het_out"):
        same_bytes(os.path.join(ws_cs, a, "part-00000"),
                   os.path.join(ws_cp, a, "part-00000"), f"pruned {a}")
    ctext = explain(cpath)
    pruned_calls = [args for name, p, args, _kw in rec.calls
                    if p == "pipeline_pruned"]
    if ("prune: 10 -> 2 binned columns" not in ctext
            or ccount["cramer"]["SharedScan"].get("PrunedCols") != 8
            or cplanned != only(B1=chunks)
            or {a[0].shape[0] for a in pruned_calls} != {2}):
        raise AssertionError(f"pruned unit: {ctext!r}, counters {ccount}, "
                             f"launches {cplanned}")
    launches["pipeline_pruned"] = cplanned["B1"]
    log(f"planner (c): correlation-only pipeline staged "
        f"{walls['pipeline corr_staged']:.2f} s (B1 {cstaged['B1']}), planned "
        f"through the pruned width {walls['pipeline corr_planned']:.2f} s "
        f"(B1 {cplanned['B1']} at {pruned_calls[0][0].shape[0]} x "
        f"{pruned_calls[0][2]} x {pruned_calls[0][3]}, plan "
        f"{hist.plan(*(int(x) for x in (pruned_calls[0][0].shape[0], pruned_calls[0][2], pruned_calls[0][3])))}); part "
        f"files byte-identical\n" + ctext.rstrip())

    epath = corr_conf(work, "planner_enc", train, schema,
                      **{"stream.chunk.rows": None,
                         "pipeline.stage.het.prop.scan.pack.on": "false"})
    etext = explain(epath)
    if "encode-once" not in etext or etext.count("scan unit") != 2:
        raise AssertionError(f"encode-once did not fire: {etext!r}")
    ws_es, _c, estaged = run("enc_staged", epath)
    ws_ep, _c, eplanned = run("enc_planned", epath, "pipeline_encode_once",
                              ["-Dplan.on=true"])
    for a in ("cramer_out", "het_out"):
        same_bytes(os.path.join(ws_es, a, "part-00000"),
                   os.path.join(ws_ep, a, "part-00000"), f"encode-once {a}")
    if eplanned != only(B1=2):
        raise AssertionError(f"encode-once run launched {eplanned}")
    launches["pipeline_encode_once"] = eplanned["B1"]
    log(f"planner (d): whole-input correlation pipeline staged "
        f"{walls['pipeline enc_staged']:.2f} s, planned with encode-once "
        f"across 2 units {walls['pipeline enc_planned']:.2f} s (B1 "
        f"{eplanned['B1']}); part files byte-identical\n" + etext.rstrip())
    return launches


SERVE_ROWS = 2000            # request rows replayed per family
SERVE_KNN_1M_ROWS = 512      # of phase 8a's test rows, against 1M refs
SERVE_BUCKETS = (1, 8, 64)


class FirstCapture(NeighborCapture):
    """NeighborCapture keeping in ``used`` the FIRST call's shape (the call
    knn_path_cases times)."""

    def __setattr__(self, key, value):
        if key == "used" and getattr(self, "used", None) is not None:
            return
        super().__setattr__(key, value)


def serve_families(work: str, schema: str) -> dict:
    """Phase 12c's served models: name → (the family's conf keys, the
    request rows' CSV), over the artifacts of phases 3, 4, 8 and 11."""
    j = lambda *p: os.path.join(work, *p)  # noqa: E731
    hospc = {"feature.schema.file.path": schema}
    return {
        "naiveBayes": ({**hospc, "bayesian.model.file.path": j("cuda_nb")},
                       j("serve_hosp.csv")),
        "tree": ({**hospc, "tree.model.file.path": j("cuda_tree")},
                 j("serve_hosp.csv")),
        "logistic": ({**hospc, "coeff.file.path": j("lr_resume_coeff.txt")},
                     j("serve_hosp.csv")),
        "viterbi": ({"hmm.model.file.path":
                     j("HiddenMarkovModelBuilder_cuda"),
                     "serve.sequence.pad.len": "256"}, j("serve_obs.csv")),
        "knn": ({"feature.schema.file.path": j("elearn.json"),
                 "training.data.path": j("elearn_train.csv"),
                 "top.match.count": str(KNN_K)}, j("serve_knn1m.csv")),
        "knn10k": ({"feature.schema.file.path": j("elearn_small.json"),
                    "training.data.path": j("small_train.csv"),
                    "top.match.count": str(KNN_K),
                    "kernel.function": "gaussian"}, j("small_test.csv")),
    }


def serving_phase(rec: Recorder, work: str, test: str, schema: str,
                  used: dict, walls: dict) -> dict:
    """Phase 12c: the serving plane on the card; returns B5's and B6's
    launches by path.

    (a) ``ScoringPlane`` replays on cuda for NB (phase 3's model), the tree
    (phase 4's), LR (phase 11's coefficients), the HMM (phase 11's, its
    sequences padded to 256 steps), kNN over phase 8a's 1M elearn
    references (B5) and over phase 8b's 10K (B6, gaussian kernel), each
    byte-identical to the batch job's part file on the same rows (LR: to
    ``predict_batch`` over the whole file, as it has no batch job); B5 and
    B6 launched once per dispatch of the batcher's histogram plus once
    per warmed bucket, 0 recompiles; (b) a ``ScoreHTTPServer`` on
    127.0.0.1 over all six models: POSTed rows equal the replay's lines,
    ``/healthz``, ``/stats`` and ``/metrics`` answered; (c) a
    ``ReplicaPool`` of 2 replicas on cuda:0 with
    ``fault.serve.dispatch.crash.after=2``: every NB response
    byte-identical, none lost, none scored twice (``requests`` = rows);
    (d) B5 alone at buckets 1, 8 and 64 against the 1M references (CUDA
    events), beside each bucket's whole dispatch; requests/s and p50/p99
    per model printed."""
    import functools

    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.jobs import get_job
    from avenir_tpu_torch.jobs.base import Job, read_lines
    from avenir_tpu_torch.models import logistic as mlr
    from avenir_tpu_torch.ops import knn as tk
    from avenir_tpu_torch.serving import (BucketedMicrobatcher,
                                          ModelRegistry, ReplicaPool,
                                          ScoreHTTPServer)

    def head(src, dst, n):
        with open(src) as fi, open(dst, "w") as fo:
            for i, line in enumerate(fi):
                if i >= n:
                    break
                fo.write(line)
        return dst

    j = lambda *p: os.path.join(work, *p)  # noqa: E731
    hosp = head(test, j("serve_hosp.csv"), SERVE_ROWS)
    head(j("obs.csv"), j("serve_obs.csv"), 300)
    knn1m = head(j("elearn_test.csv"), j("serve_knn1m.csv"),
                 SERVE_KNN_1M_ROWS)
    families = serve_families(work, schema)
    small = families["knn10k"][0]
    hospc = {"feature.schema.file.path": schema}
    # the batch jobs' part files on the same rows, on cuda
    t0 = time.perf_counter()
    oracle = {}
    run_cli(["BayesianPredictor", *[f"-D{k}={v}" for k, v in
                                    families["naiveBayes"][0].items()],
             hosp, j("serve_nb_pred"), "--device", "cuda"])
    oracle["naiveBayes"] = read_lines(j("serve_nb_pred"))
    run_cli(["DecisionTreeBuilder", *[f"-D{k}={v}" for k, v in
                                      families["tree"][0].items()],
             hosp, j("serve_tree_pred"), "--device", "cuda"])
    oracle["tree"] = read_lines(j("serve_tree_pred"))
    conf = JobConfig(dict(families["logistic"][0]))
    _e, ds, _ = Job.encode_input(conf, hosp, with_labels=False,
                                 need_rows=False)
    model = mlr.LogisticRegressionModel.from_history_lines(
        read_lines(j("lr_resume_coeff.txt")))
    probs, pred = mlr.predict_batch(
        model, mlr.design_matrix(ds, device="cuda"), device="cuda")
    oracle["logistic"] = [f"{ln},{int(pred[i])},{probs[i]:.6f}"
                          for i, ln in enumerate(read_lines(hosp))]
    oracle["viterbi"] = read_lines(j("ViterbiStatePredictor_cuda"))[:300]
    oracle["knn"] = read_lines(j("cuda_knn"))[:SERVE_KNN_1M_ROWS]
    run_cli(["NearestNeighbor", *[f"-D{k}={v}" for k, v in small.items()],
             j("small_test.csv"), j("serve_knn10k_pred"), "--device", "cuda"])
    oracle["knn10k"] = read_lines(j("serve_knn10k_pred"))
    walls["serve oracles"] = time.perf_counter() - t0

    launches, stats_line, replayed = {}, {}, {}
    for name, (props, rows) in families.items():
        family = "knn" if name.startswith("knn") else name
        path = {"knn": "serve_knn_1m", "knn10k": "serve_knn_10k"}.get(name)
        cap = FirstCapture()
        reset_counts()
        t0 = time.perf_counter()
        with (rec.on(path) if path else contextlib.nullcontext()), cap.on():
            # a replay queues every row at once: the request timeout is
            # a latency limit for online clients, not for the replay
            counters = get_job("ScoringPlane").run(
                JobConfig({**props, "serve.models": family,
                           "serve.request.timeout.ms": "60000"}), rows,
                j(f"serve_{name}_replay"), device="cuda")
        wall = walls[f"serve {name} replay"] = time.perf_counter() - t0
        counts = read_counts()
        got = replayed[name] = read_lines(j(f"serve_{name}_replay"))
        if got != oracle[name]:
            bad = next(i for i, (a, b) in enumerate(zip(got, oracle[name]))
                       if a != b) if len(got) == len(oracle[name]) else -1
            raise AssertionError(f"serving {name}: replay differs from the "
                                 f"batch job at row {bad}")
        grp = counters.as_dict()[f"Serving.{family}"]
        batches = sum(v for k, v in grp.items() if k.startswith("bucket."))
        warmed = 7                          # serve.bucket.sizes 1, 2, ..., 64
        kid = {"knn": "B5", "knn10k": "B6"}.get(name)
        want = only(**({kid: batches + warmed} if kid else {}))
        if counts != want or grp.get("recompiles", 0) != 0 \
                or grp["requests"] != len(got) or grp["batches"] != batches:
            raise AssertionError(f"serving {name}: launches {counts} (want "
                                 f"{want}), counters {grp}")
        if path:
            launches[path] = counts[kid]
            used[path] = cap.used
        stats_line[name] = {
            "rows": len(got), "batches": batches, "wall_s": round(wall, 4),
            "requests_per_s": round(len(got) / wall, 1),
            "p50_ms": grp["p50_us"] / 1e3, "p99_ms": grp["p99_us"] / 1e3,
            "launches": counts[kid] if kid else 0,
            "histogram": {k: v for k, v in grp.items()
                          if k.startswith("bucket.")}}
        log(f"serving (a): {name} replay of {len(got)} rows on cuda "
            f"byte-identical to the batch job; {json.dumps(stats_line[name])}")

    # (b) the HTTP frontend in this process, on the loopback
    conf_all = {**hospc, **families["naiveBayes"][0], **families["tree"][0],
                **families["logistic"][0]}
    registry = ModelRegistry()
    for name, (props, _rows) in families.items():
        family = "knn" if name.startswith("knn") else name
        from avenir_tpu_torch.serving.registry import FAMILIES

        registry.add(name, FAMILIES[family].from_conf(
            JobConfig({**conf_all, **props}) if family != "knn"
            else JobConfig(dict(props)), device="cuda"))
    batcher = BucketedMicrobatcher.from_conf(registry, JobConfig({}))
    srv = ScoreHTTPServer(batcher, host="127.0.0.1", port=0).start()
    try:
        base = "http://%s:%d" % srv.address
        call = functools.partial(http_get, base)
        for name, (_props, rows) in families.items():
            sent = read_lines(rows)[:5]
            status, body = call("/score", {"model": name, "rows": sent})
            if status != 200 or json.loads(body)["results"] != \
                    replayed[name][:5]:
                raise AssertionError(f"HTTP /score {name}: {status} {body!r}")
        status, body = call("/healthz")
        health = json.loads(body)
        if status != 200 or sorted(health["models"]) != sorted(families):
            raise AssertionError(f"/healthz {status} {health}")
        status, body = call("/stats")
        stats = json.loads(body)
        if status != 200 or any(stats[m]["requests"] != 5 or
                                stats[m].get("recompiles", 0) != 0
                                for m in families):
            raise AssertionError(f"/stats {stats}")
        status, body = call("/metrics")
        if status != 200 or b'process="0"' not in body:
            raise AssertionError(f"/metrics {status}")
        log(f"serving (b): HTTP on {base}: /score for the six models equal to "
            f"the replays, /healthz ready, /stats 5 requests each and 0 "
            f"recompiles, /metrics {len(body.splitlines())} lines")
    finally:
        srv.stop()
        batcher.close()

    # (c) a pool of two replicas on the one card, one killed mid-replay
    rows = read_lines(hosp)[:256]
    pool = ReplicaPool.from_conf(JobConfig({
        **families["naiveBayes"][0], "serve.models": "naiveBayes",
        "pool.replicas": "2", "pool.monitor.interval.ms": "40",
        "pool.failover.retries": "1", "serve.flush.deadline.ms": "20",
        "fault.serve.dispatch.crash.after": "2"}), device="cuda")
    try:
        t0 = time.perf_counter()
        reqs = [pool.submit_nowait("naiveBayes", ln) for ln in rows]
        got = [r.wait(120.0) for r in reqs]
        wall = time.perf_counter() - t0
        pstats = pool.stats()
    finally:
        pool.close()
    if got != oracle["naiveBayes"][:256]:
        raise AssertionError("pool responses differ from the batch job")
    if pstats["pool"].get("replicas.lost") != 1 \
            or pstats["pool"].get("failovers", 0) < 1 \
            or pstats["naiveBayes"]["requests"] != len(rows):
        raise AssertionError(f"pool stats {pstats}")
    log(f"serving (c): ReplicaPool x2 on cuda:0, one replica killed at its "
        f"2nd dispatch: {len(rows)} responses byte-identical in {wall:.3f} s, "
        f"{pstats['pool']['failovers']} failed over, requests "
        f"{pstats['naiveBayes']['requests']} (none lost or doubled)")

    # (d) B5 alone per bucket against the 1M references
    entry = registry.get("knn")
    lines = read_lines(knn1m)
    calls = []
    inner = tk.knn_tourney

    @functools.wraps(inner)            # carries the launch count over
    def grab(*args, **kwargs):
        calls.append((args, kwargs))
        return inner(*args, **kwargs)

    per_bucket = {}
    for b in SERVE_BUCKETS:
        entry.score_lines(lines[:b], b)              # warm the shape
        calls.clear()
        tk.knn_tourney = grab
        try:
            t0 = time.perf_counter()
            out = entry.score_lines(lines[:b], b)
            torch_sync()
            dispatch = (time.perf_counter() - t0) * 1e3
        finally:
            inner.launches = grab.launches
            tk.knn_tourney = inner
        if out != oracle["knn"][:b] or len(calls) != 1:
            raise AssertionError(f"bucket {b}: {len(calls)} B5 calls")
        (q, r), kw = calls[0][0][:2], calls[0][1]
        got_keys, want_keys = inner(q, r, **kw), tk.knn_tourney_ref(q, r)
        check_tourney(q, r, got_keys, want_keys, f"serve bucket {b}")
        per_bucket[b] = {"b5_ms": time_ms(lambda: inner(q, r, **kw), 10),
                         "dispatch_ms": round(dispatch, 3),
                         "q_rows": q.shape[0], "refs": r.shape[0]}
        log(f"serving (d): bucket {b}: B5 {per_bucket[b]['b5_ms']:.4f} ms "
            f"over {q.shape[0]} padded query rows x {r.shape[0]} refs, the "
            f"whole dispatch {dispatch:.3f} ms")
    log(json.dumps({"serving": stats_line, "b5_per_bucket": per_bucket,
                    "card": card_line()}))
    return launches


# phase 13: the stream plane and the tenancy arbiter on phase 3's CSV
STREAM_PROPS = {"stream.pane.rows": "65536", "stream.window.panes": "4",
                "stream.slide.panes": "1",
                "stream.consumers": "classDistribution,naiveBayes,"
                                    "mutualInfo,cramer",
                "stream.drift.threshold": "0.01"}
STREAM_PANES = -(-ROWS_E2E // 65_536)                    # 15 full + a tail
STREAM_BUCKETS = 17                                      # 1, 2, ..., 65,536
DRIFT_PANE_ROWS = 8192


def counter_or_0(out: str, name: str) -> int:
    """A counter the job prints only when it is not zero."""
    return counter(out, name) if f"\t{name}=" in out else 0


def stream_argv(schema: str, *extra) -> list:
    return ["StreamAnalytics", f"-Dfeature.schema.file.path={schema}",
            *[f"-D{k}={v}" for k, v in STREAM_PROPS.items()], *extra]


@contextlib.contextmanager
def pane_timer(out: list):
    """Record the wall of every ``WindowedScan.close_pane`` (encode, pad,
    fold, window merge and finalize, the window's lines) while on; the
    fold's host accumulation waits for the card, so each is synced."""
    from avenir_tpu_torch.stream import windows

    inner = windows.WindowedScan.close_pane

    def timed(self):
        t0 = time.perf_counter()
        try:
            return inner(self)
        finally:
            out.append((time.perf_counter() - t0) * 1e3)

    windows.WindowedScan.close_pane = timed
    try:
        yield out
    finally:
        windows.WindowedScan.close_pane = inner


def lines_from(lines: list, window: int) -> list:
    """A StreamAnalytics part file's lines from window ``window`` on."""
    first = next(i for i, ln in enumerate(lines)
                 if ln.startswith(f"w={window},panes="))
    return lines[first:]


def stream_phase(rec: Recorder, work: str, train: str, schema: str,
                 walls: dict) -> dict:
    """Phase 13 (a)–(c): StreamAnalytics over phase 3's 1M-row CSV; returns
    B1's launches by path.

    (a) 65,536-row panes, windows of 4 panes sliding by 1, the four
    consumers and a drift threshold, on cuda (recorded as ``stream``:
    17 warmed buckets and 16 panes, B1 33) and on the CPU: part files
    byte-identical, 13 windows, 0 ``Stream`` recompiles, the pane-close
    p50/p99 printed; (b) with ``stream.checkpoint.dir`` every 4 panes:
    killed after pane 10 and resumed, killed by ``fault.fold.crash.after``
    and resumed, each byte-identical to (a) from its restored window on;
    a cuda snapshot resumed with ``--device cpu`` refused with ConfigError
    before any output; (c) every B1 call of (a), all-ballast warm panes
    and the ragged tail's bucket included, is held against its plain
    version with phase 6's path cases."""
    import numpy as np

    from avenir_tpu_torch.core.config import ConfigError
    from avenir_tpu_torch.jobs.base import read_lines
    from avenir_tpu_torch.utils.retry import InjectedFault

    j = lambda *p: os.path.join(work, *p)  # noqa: E731
    launches, parts, pane_ms = {}, {}, []
    for dev in ("cuda", "cpu"):
        reset_counts()
        t0 = time.perf_counter()
        with (rec.on("stream") if dev == "cuda"
              else contextlib.nullcontext()), \
                (pane_timer(pane_ms) if dev == "cuda"
                 else contextlib.nullcontext()):
            out = run_cli([*stream_argv(schema), train, j(f"stream_{dev}"),
                           "--device", dev])
        wall = walls[f"{dev} StreamAnalytics 1M"] = time.perf_counter() - t0
        counts = read_counts()
        panes, windows = counter(out, "panes"), counter(out, "windows")
        recompiles = counter_or_0(out, "recompiles")
        if (panes, windows, recompiles) != (STREAM_PANES, 13, 0) or \
                counter(out, "Processed") != ROWS_E2E:
            raise AssertionError(f"StreamAnalytics on {dev}: {panes} panes, "
                                 f"{windows} windows, {recompiles} "
                                 f"recompiles:\n{out}")
        if dev == "cuda":
            want = only(B1=STREAM_BUCKETS + STREAM_PANES)
            if counts != want:
                raise AssertionError(f"StreamAnalytics launched {counts}, "
                                     f"want {want}")
            launches["stream"] = counts["B1"]
            ns = [args[0].shape[1] for name, p, args, _kw in rec.calls
                  if p == "stream"]
            want_ns = ([2 ** i for i in range(STREAM_BUCKETS)]
                       + [65_536] * (STREAM_PANES - 1) + [32_768])
            if ns != want_ns:
                raise AssertionError(f"stream B1 calls at rows {ns}")
        parts[dev] = read_lines(j(f"stream_{dev}"))
        log(f"stream (a) on {dev}: {wall:.2f} s, "
            f"{ROWS_E2E / wall:.0f} rows/s, {panes} panes, {windows} "
            f"windows, 0 recompiles, launches {counts}")
    same_bytes(j("stream_cuda", "part-00000"), j("stream_cpu", "part-00000"),
               "StreamAnalytics")
    drift = [ln for ln in parts["cuda"] if ",drift," in ln]
    if len(drift) != 13 or \
            parts["cuda"][-4] != "w=12,panes=12-15,rows=213568":
        raise AssertionError(f"StreamAnalytics windows: {parts['cuda'][-4:]}")
    p50, p99 = (float(np.percentile(pane_ms, q)) for q in (50, 99))
    walls["stream pane close p50 ms"], walls["stream pane close p99 ms"] = \
        p50, p99
    log(f"stream (a): part files byte-identical cuda vs cpu; pane close "
        f"p50 {p50:.1f} ms, p99 {p99:.1f} ms over {len(pane_ms)} panes "
        f"(encode in Python, B1, merge, finalize); drift lines "
        f"{[ln.split(',', 3)[2:] for ln in drift[-3:]]}")

    # (b) kill and resume
    ck = j("stream_ck")
    durable = [f"-Dstream.checkpoint.dir={ck}",
               "-Dstream.checkpoint.interval.panes=4"]

    def run(tag, *extra, dev="cuda"):
        return run_cli([*stream_argv(schema, *durable, *extra), train,
                        j(f"stream_{tag}"), "--device", dev])

    reset_counts()
    t0 = time.perf_counter()
    drills = (("crash", ("-Dstream.fault.crash.after.panes=10",), RuntimeError,
               "injected crash after pane 9", 5),
              ("fold", ("-Dfault.fold.crash.after=7",), InjectedFault,
               "injected crash at fold boundary 7", 1))
    for tag, extra, exc, match, first in drills:
        expect_raise(exc, match, lambda: run(f"{tag}_x", *extra))
        if os.path.exists(j(f"stream_{tag}_x")):
            raise AssertionError(f"a killed stream ({tag}) left its output")
        run(f"{tag}_r", "-Dstream.resume=true")
        if read_lines(j(f"stream_{tag}_r")) != lines_from(parts["cuda"],
                                                          first):
            raise AssertionError(f"resumed stream ({tag}) differs from (a) "
                                 f"from window {first} on")
        if os.path.exists(ck):
            raise AssertionError("a finished stream left its snapshots")
    expect_raise(RuntimeError, "injected crash",
                 lambda: run("xdev_x", "-Dstream.fault.crash.after.panes=6"))
    msg = expect_raise(ConfigError, "was written under",
                       lambda: run("xdev_r", "-Dstream.resume=true",
                                   dev="cpu"))
    if os.path.exists(j("stream_xdev_r")) or \
            os.path.exists(j("stream_xdev_r.inprogress")):
        raise AssertionError("a refused resume wrote output")
    shutil.rmtree(ck)
    walls["stream kill and resume"] = time.perf_counter() - t0
    counts = read_counts()
    # every run warms its 17 buckets: 27 + 25, 23 + 29, 23 and 0 (refused)
    want = only(B1=STREAM_BUCKETS * 5 + 10 + 8 + 6 + 12 + 6)
    if counts != want:
        raise AssertionError(f"kill and resume launched {counts}, want {want}")
    launches["stream_resume"] = counts["B1"]
    log(f"stream (b): killed after pane 10 and resumed from pane 8, killed "
        f"at fold 7 and resumed from pane 4: both byte-identical to (a) from "
        f"their restored window on; a cuda snapshot on the cpu refused "
        f"({msg[:120]}...); {walls['stream kill and resume']:.1f} s, "
        f"launches {counts}")
    return launches


def swap_class(line: str) -> str:
    head, _, cls = line.rpartition(",")
    return f"{head},{'Y' if cls == 'N' else 'N'}"


def retrain_phase(rec: Recorder, work: str, train: str, schema: str,
                  walls: dict) -> dict:
    """Phase 13 (d): drift → retrain → hot swap on cuda; returns B4's
    launches by path.  Hospital rows in 8,192-row panes, windows of 2
    panes: 4 panes as generated, then 4 whose class the script swaps.  For
    the tree (B4 once per level of the refit) and then NB, a
    ``DriftRetrainController`` over a served model fires on window 2,
    refits on its rows through the port's own job and swaps: the registry
    version bumps, a request before the swap answers as the old model's
    batch job does and one after as the new model's, and the refit's
    artifact equals the batch job's on the window's rows."""
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.jobs.base import Job, read_lines
    from avenir_tpu_torch.serving import BucketedMicrobatcher, ModelRegistry
    from avenir_tpu_torch.stream import (ClassDistributionConsumer,
                                         DriftDetector, DriftRetrainController,
                                         WindowedScan)

    j = lambda *p: os.path.join(work, *p)  # noqa: E731
    rows = []
    with open(train) as fh:
        for line in fh:
            rows.append(line.rstrip("\n"))
            if len(rows) == 8 * DRIFT_PANE_ROWS:
                break
    half = 4 * DRIFT_PANE_ROWS
    stream = rows[:half] + [swap_class(ln) for ln in rows[half:]]
    probe = j("drift_probe.csv")
    with open(j("serve_hosp.csv")) as fh, open(probe, "w") as fo:
        fo.write(fh.readline())
    models = (("tree", "DecisionTreeBuilder", "tree.model.file.path",
               j("cuda_tree"), "serve_tree_pred"),
              ("naiveBayes", "BayesianDistribution",
               "bayesian.model.file.path", j("cuda_nb"), "serve_nb_pred"))
    launches, line = {}, {}
    for family, job, key, model_dir, oracle in models:
        conf = JobConfig({"feature.schema.file.path": schema, key: model_dir,
                          "serve.models": family,
                          "serve.bucket.sizes": "1,2,4",
                          "serve.request.timeout.ms": "60000",
                          "stream.retrain.model": family,
                          "stream.retrain.dir": j(f"retrain_{family}")})
        registry = ModelRegistry.from_conf(conf, device="cuda")
        with BucketedMicrobatcher.from_conf(registry, conf) as batcher:
            probe_line = read_lines(probe)[0]
            before = batcher.submit(family, probe_line)
            controller = DriftRetrainController(
                conf, batcher, DriftDetector(threshold=0.01, min_windows=1,
                                             source="class"))
            ws = WindowedScan(Job.encoder_for(conf),
                              [ClassDistributionConsumer(name="cd")],
                              DRIFT_PANE_ROWS, window_panes=2,
                              retain_rows=True, device="cuda")
            ws.warm()
            path = f"stream_retrain_{family}"
            reset_counts()
            t0 = time.perf_counter()
            with rec.on(path):
                fired = [(w.index, controller.on_window(w))
                         for w in ws.feed(stream)]
            wall = time.perf_counter() - t0
            counts = read_counts()
            after = batcher.submit(family, probe_line)
        swaps = [(i, v) for i, v in fired if v is not None]
        if swaps != [(2, 2)] or registry.version(family) != 2:
            raise AssertionError(f"{family}: swaps {swaps}, version "
                                 f"{registry.version(family)}")
        stage = os.path.join(j(f"retrain_{family}"), "retrain-w2")
        run_cli([job, f"-Dfeature.schema.file.path={schema}",
                 os.path.join(stage, "input.csv"),
                 j(f"retrain_batch_{family}"), "--device", "cuda"])
        same_bytes(os.path.join(stage, "model", "part-00000"),
                   j(f"retrain_batch_{family}", "part-00000"),
                   f"{family} retrain against its batch job")
        predictor = ("DecisionTreeBuilder" if family == "tree"
                     else "BayesianPredictor")
        run_cli([predictor, f"-Dfeature.schema.file.path={schema}",
                 f"-D{key}={os.path.join(stage, 'model')}", probe,
                 j(f"retrain_pred_{family}"), "--device", "cuda"])
        if before != read_lines(j(oracle))[0] or \
                after != read_lines(j(f"retrain_pred_{family}"))[0]:
            raise AssertionError(f"{family}: before {before!r}, after "
                                 f"{after!r}")
        # the panes count classes only (no B1); the tree's refit builds
        # one level table a level (B4), NB's counts need no kernel
        b4 = counts["B4"]
        if (family == "tree") != (b4 > 0) or counts != only(B4=b4):
            raise AssertionError(f"{family} drift loop launched {counts}")
        if b4:
            launches.setdefault("B4", {})[path] = b4
        line[family] = {"drift_to_swap_s": round(controller.last_swap_s, 4),
                        "loop_wall_s": round(wall, 3), "launches": counts,
                        "before": before.rsplit(",", 1)[-1],
                        "after": after.rsplit(",", 1)[-1]}
        walls[f"stream retrain {family}"] = controller.last_swap_s
        log(f"stream (d): {family}: drift on window 2, refit on its "
            f"{2 * DRIFT_PANE_ROWS} rows and swapped (version 2) in "
            f"{controller.last_swap_s:.3f} s; artifact equal to the batch "
            f"job's; the probe answered {before!r} before and {after!r} "
            f"after; launches {counts}")
    log(json.dumps({"drift_retrain_swap": line, "card": card_line()}))
    return launches


def tenancy_phase(rec: Recorder, work: str, train: str, schema: str,
                  used: dict, walls: dict) -> dict:
    """Phase 13 (e): two tenants on the one card (``tenant.batch.share=1``,
    ``tenant.online.share=3``, ``tenant.online.priority=1``); returns B1's
    and B5's launches by path.  Under ``tenant.batch`` the NB + MI pipeline
    of phase 5b runs fused over the 1M-row CSV (B1 once a chunk, in a
    slot), while under ``tenant.online`` a ``ScoringPlane`` kNN replay of
    512 rows runs over phase 8a's 1M references (B5 a dispatch, in a
    slot), both recorded as ``tenant``: each output byte-identical to its
    untenanted run (phase 5b's fused part files, phase 12c's replay), and
    every slot asked for granted (granted + shed = submitted, per
    tenant).  Then a queue-depth drill: with ``tenant.batch.queue.depth=1``
    and the card held by batch, batch's third fold raises TenantShedError
    naming batch, while an online NB request queued beside it answers as
    the batch job does."""
    import threading

    from avenir_tpu_torch import tenancy
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.jobs import get_job
    from avenir_tpu_torch.jobs.base import Job, read_lines
    from avenir_tpu_torch.pipeline import driver, scan
    from avenir_tpu_torch.serving import BucketedMicrobatcher, ModelRegistry
    from avenir_tpu_torch.serving.errors import TenantShedError

    j = lambda *p: os.path.join(work, *p)  # noqa: E731
    contracts = {"tenant.batch.share": "1", "tenant.online.share": "3",
                 "tenant.online.priority": "1"}
    tenancy.reset()
    pool = tenancy.configure(JobConfig(dict(contracts)))
    try:
        pconf = JobConfig.from_file(pipeline_conf(work, "tenant_nb_mi", train,
                                                  schema))
        for k, v in {**contracts, "tenant.id": "batch"}.items():
            pconf.set(k, v)
        knn = JobConfig({"feature.schema.file.path": j("elearn.json"),
                         "training.data.path": j("elearn_train.csv"),
                         "top.match.count": str(KNN_K), "serve.models": "knn",
                         "serve.request.timeout.ms": "60000", **contracts,
                         "tenant.id": "online"})
        result, errors = {}, []

        def batch_side():
            try:
                t0 = time.perf_counter()
                p = driver.Pipeline.from_conf(
                    pconf, workspace=j("ws_tenant"), device="cuda")
                p.run()
                result["batch_wall"] = time.perf_counter() - t0
                result["batch"] = p.counters
            except BaseException as e:          # re-raised below
                errors.append(e)

        cap = FirstCapture()
        reset_counts()
        t0 = time.perf_counter()
        with rec.on("tenant"), cap.on():
            th = threading.Thread(target=batch_side, name="tenant-batch")
            th.start()
            counters = get_job("ScoringPlane").run(
                knn, j("serve_knn1m.csv"), j("tenant_knn_replay"),
                device="cuda")
            result["online_wall"] = time.perf_counter() - t0
            th.join()
        if errors:
            raise errors[0]
        walls["tenant concurrent"] = time.perf_counter() - t0
        counts = read_counts()
        used["tenant"] = cap.used
        for a in ("nb_model", "mi_out"):
            same_bytes(j("ws_tenant", a, "part-00000"),
                       j("ws_fused", a, "part-00000"),
                       f"tenant batch {a} against phase 5b's")
        same_bytes(j("tenant_knn_replay", "part-00000"),
                   j("serve_knn_replay", "part-00000"),
                   "tenant online kNN replay against phase 12c's")
        grp = counters.as_dict()["Serving.knn"]
        dispatches = sum(v for k, v in grp.items() if k.startswith("bucket."))
        chunks = -(-ROWS_E2E // CHUNK_ROWS)
        stats = pool.stats()
        submitted = {"batch": chunks, "online": dispatches}
        for t, n in submitted.items():
            if stats[t]["grants"] + stats[t]["shed"] != n or stats[t]["shed"]:
                raise AssertionError(f"tenant {t}: {stats[t]} for {n} slots "
                                     f"asked")
        if counts != only(B1=chunks, B5=dispatches + 7):
            raise AssertionError(f"tenants launched {counts}")
        launches = {"B1": {"tenant": counts["B1"]},
                    "B5": {"tenant": counts["B5"]}}
        log(f"tenancy (e): batch NB + MI pipeline {result['batch_wall']:.2f} s "
            f"and online kNN replay of {grp['requests']} rows "
            f"{result['online_wall']:.2f} s side by side; outputs "
            f"byte-identical to the untenanted runs; Tenant stats "
            f"{json.dumps(stats)}; launches {counts}")

        # the queue-depth drill
        tenancy.reset()
        pool = tenancy.configure(JobConfig(
            {**contracts, "tenant.batch.queue.depth": "1"}))
        nb = JobConfig({"feature.schema.file.path": schema,
                        "bayesian.model.file.path": j("cuda_nb"),
                        "serve.models": "naiveBayes",
                        "serve.bucket.sizes": "1",
                        "serve.request.timeout.ms": "60000",
                        "tenant.id": "online"})
        enc, ds, _ = Job.encode_input(nb, j("serve_hosp.csv"),
                                      need_rows=False)

        def fold_as_batch():
            eng = scan.SharedScan(device="cuda")
            eng.register(scan.NaiveBayesConsumer(name="nb"))
            with tenancy.tenant_scope("batch"):
                return eng.run(ds)["nb"]

        want = fold_as_batch().class_counts        # batch 1 granted
        with BucketedMicrobatcher.from_conf(
                ModelRegistry.from_conf(nb, device="cuda"), nb) as online:
            hold = pool.slot(tenant="batch")
            hold.__enter__()                       # batch 2 granted
            box = {}
            waiter = threading.Thread(
                target=lambda: box.setdefault("nb", fold_as_batch()))
            waiter.start()                         # batch 3 queued
            req = online.submit_nowait("naiveBayes",
                                       read_lines(j("serve_hosp.csv"))[0])
            deadline = time.monotonic() + 30
            while (pool.queue_depths()["batch"] < 1
                   or pool.queue_depths()["online"] < 1) and \
                    time.monotonic() < deadline:
                time.sleep(0.005)
            try:
                msg = expect_raise(TenantShedError, "tenant 'batch'",
                                   fold_as_batch)   # batch 4 shed
            finally:
                hold.__exit__(None, None, None)
            answer = req.wait(60.0)
            waiter.join(60.0)
        stats = pool.stats()
        if answer != read_lines(j("serve_nb_pred"))[0] or \
                not (box["nb"].class_counts == want).all():
            raise AssertionError("the drill's surviving work answered wrong")
        if (stats["batch"]["grants"], stats["batch"]["shed"]) != (3, 1) or \
                (stats["online"]["grants"], stats["online"]["shed"]) != (1, 0):
            raise AssertionError(f"drill book-keeping {stats}")
        log(f"tenancy (e) drill: batch shed at its queue depth ({msg[:90]}...); "
            f"online answered as the batch job; Tenant stats "
            f"{json.dumps(stats)}")
        return launches
    finally:
        tenancy.reset()


def stream_tenancy_phase(rec: Recorder, work: str, train: str, schema: str,
                         used: dict, walls: dict) -> dict:
    """Phase 13: (a)–(c) ``stream_phase``, (d) ``retrain_phase``, (e)
    ``tenancy_phase``; returns launches by kernel and path."""
    t0 = time.perf_counter()
    out = {"B1": stream_phase(rec, work, train, schema, walls)}
    for kid, paths in retrain_phase(rec, work, train, schema, walls).items():
        out.setdefault(kid, {}).update(paths)
    for kid, paths in tenancy_phase(rec, work, train, schema, used,
                                    walls).items():
        out.setdefault(kid, {}).update(paths)
    walls["phase 13"] = time.perf_counter() - t0
    log(f"phase 13 in {walls['phase 13']:.1f} s, launches {json.dumps(out)}")
    return out


SHARD_SLICE_ROWS = 20_000   # phase 14 (d): the quantized, profiled slice
SHARD_SLICE_CHUNK = 127     # rows a chunk: every partial cell ≤ 127


def shard_phase(rec: Recorder, work: str, train: str, schema: str,
                walls: dict) -> dict:
    """Phase 14: the ``shard.*`` plane on the card's local devices (a
    one-device mesh on one H100); returns B1's launches by path.

    (a) phase 5b's NB + MI pipeline over the 1M-row hospital CSV with
    ``shard.devices=all`` (recorded as ``shard``: each 250K-row chunk
    padded to 262,144 rows and folded by B1 once per shard), part files
    byte-identical to 5b's fused run; (b) phase 13's ``StreamAnalytics``
    with ``shard.devices=all`` (every pane and warm bucket once per
    shard), byte-identical to 13's cuda run; (c) ``shard.devices=2``:
    refused with ConfigError before any stage on one card, run and
    byte-identical on two or more; (d) the pipeline over the CSV's first
    20,000 rows in 127-row chunks with ``shard.allreduce.quantized=true``
    (every partial cell ≤ 127, so the int8 reduction is exact) under
    ``profile.on``: byte-identical to the unsharded run of the slice, one
    ``shard.topology`` naming the card and one ``shard.skew`` a chunk in
    the journal.  Prints launches per shard and the walls beside the
    unsharded ones, with the card's name and power limit."""
    import torch

    from avenir_tpu_torch.core.config import ConfigError
    from avenir_tpu_torch.parallel.mesh import shard_pad_target
    from avenir_tpu_torch.telemetry import spans as tel
    from avenir_tpu_torch.telemetry.journal import read_events

    j = lambda *p: os.path.join(work, *p)  # noqa: E731
    n_dev = torch.cuda.device_count()
    chunks = -(-ROWS_E2E // CHUNK_ROWS)
    path = pipeline_conf(work, "nb_mi", train, schema)
    launches = {}

    # (a) the fused pipeline over the mesh
    reset_counts()
    t0 = time.perf_counter()
    with rec.on("shard"):
        counters = run_pipeline(["run", path,
                                 f"-Dpipeline.workspace={j('ws_shard')}",
                                 "-Dshard.devices=all"])
    walls["shard pipeline"] = time.perf_counter() - t0
    counts = read_counts()
    if counts != only(B1=chunks * n_dev):
        raise AssertionError(f"sharded pipeline launched {counts}")
    if counters["nb"].get("Shard", {}).get("chunks") != chunks or \
            counters["nb"]["SharedScan"]["Chunks"] != chunks or \
            counters["nb"]["Records"]["Processed"] != ROWS_E2E:
        raise AssertionError(f"sharded pipeline counters {counters}")
    for art in ("nb_model", "mi_out"):
        same_bytes(j("ws_shard", art, "part-00000"),
                   j("ws_fused", art, "part-00000"),
                   f"sharded pipeline {art} and phase 5b's fused")
    ns = [args[0].shape[1] for _n, p, args, _kw in rec.calls if p == "shard"]
    want_ns = [shard_pad_target(min(CHUNK_ROWS, ROWS_E2E - i), n_dev) // n_dev
               for i in range(0, ROWS_E2E, CHUNK_ROWS) for _ in range(n_dev)]
    if ns != want_ns:
        raise AssertionError(f"sharded pipeline B1 calls at rows {ns}")
    launches["shard"] = counts["B1"]

    # (b) the stream over the mesh
    reset_counts()
    t0 = time.perf_counter()
    out = run_cli([*stream_argv(schema, "-Dshard.devices=all"), train,
                   j("stream_shard"), "--device", "cuda"])
    walls["shard StreamAnalytics 1M"] = time.perf_counter() - t0
    counts = read_counts()
    want = only(B1=(STREAM_BUCKETS + STREAM_PANES) * n_dev)
    if counts != want or counter_or_0(out, "recompiles") != 0:
        raise AssertionError(f"sharded StreamAnalytics launched {counts} "
                             f"(want {want}):\n{out}")
    same_bytes(j("stream_shard", "part-00000"), j("stream_cuda", "part-00000"),
               "sharded StreamAnalytics and phase 13's")
    launches["shard_stream"] = counts["B1"]

    # (c) two devices
    ws2 = j("ws_shard2")
    reset_counts()
    if n_dev == 1:
        msg = expect_raise(ConfigError, "only 1 device(s) attached (cuda)",
                           lambda: run_pipeline(["run", path,
                                                 f"-Dpipeline.workspace={ws2}",
                                                 "-Dshard.devices=2"]))
        if os.path.exists(ws2) or read_counts() != only():
            raise AssertionError("a refused shard.devices=2 ran a stage")
        two = f"refused on one card: {msg}"
    else:
        run_pipeline(["run", path, f"-Dpipeline.workspace={ws2}",
                      "-Dshard.devices=2"])
        if read_counts() != only(B1=chunks * 2):
            raise AssertionError(f"two-device mesh launched {read_counts()}")
        for art in ("nb_model", "mi_out"):
            same_bytes(j("ws_shard2", art, "part-00000"),
                       j("ws_fused", art, "part-00000"),
                       f"two-device pipeline {art} and phase 5b's")
        two = "ran on cuda:0 and cuda:1, byte-identical"

    # (d) the quantized reduction on a short slice, profiled
    sliced = j("slice.csv")
    with open(train) as src, open(sliced, "w") as dst:
        for _ in range(SHARD_SLICE_ROWS):
            dst.write(src.readline())
    slice_conf = pipeline_conf(work, "nb_mi_slice", sliced, schema)
    small = [f"-Dstream.chunk.rows={SHARD_SLICE_CHUNK}"]
    run_pipeline(["run", slice_conf, f"-Dpipeline.workspace={j('ws_slice')}",
                  *small])
    tel_dir = j("tel_shard")
    reset_counts()
    t0 = time.perf_counter()
    run_pipeline(["run", slice_conf, f"-Dpipeline.workspace={j('ws_sliceq')}",
                  *small, "-Dshard.devices=all",
                  "-Dshard.allreduce.quantized=true", "-Dtrace.on=true",
                  "-Dprofile.on=true", f"-Dtrace.journal.dir={tel_dir}"])
    walls["shard quantized profiled slice"] = time.perf_counter() - t0
    counts = read_counts()
    n_slice = -(-SHARD_SLICE_ROWS // SHARD_SLICE_CHUNK)
    # a fold and a skew probe a chunk, each one B1 launch per shard
    if counts != only(B1=2 * n_slice * n_dev):
        raise AssertionError(f"quantized slice launched {counts}")
    for art in ("nb_model", "mi_out"):
        same_bytes(j("ws_sliceq", art, "part-00000"),
                   j("ws_slice", art, "part-00000"),
                   f"quantized slice {art} and its unsharded run")
    events = read_events(journal_of(tel_dir))
    # the slice's conf switched the process's tracer and profiler on; off
    # again, so no later phase traces, profiles or probes skew
    tel.tracer().disable()
    check_schema(events, "shard phase journal")
    topo = [e for e in events if e["ev"] == "shard.topology"]
    skews = [e for e in events if e["ev"] == "shard.skew"]
    if len(topo) != 1 or \
            topo[0]["device_kind"] != torch.cuda.get_device_name(0) or \
            topo[0]["devices"] != n_dev or len(skews) != n_slice or \
            any(len(e["device_ms"]) != n_dev for e in skews):
        raise AssertionError(f"shard journal: topology {topo}, "
                             f"{len(skews)} skew events")
    launches["shard_quantized_profiled"] = counts["B1"]
    skew_ms = sorted(ms for e in skews for ms in e["device_ms"])
    log(json.dumps({"shard": {
        "devices": n_dev, "launches": launches,
        "launches_per_shard": {k: v // n_dev for k, v in launches.items()},
        "walls_s": {
            "pipeline sharded": walls["shard pipeline"],
            "pipeline unsharded (5b)": walls["pipeline fused again"],
            "stream sharded": walls["shard StreamAnalytics 1M"],
            "stream unsharded (13)": walls["cuda StreamAnalytics 1M"],
            "quantized profiled slice":
                walls["shard quantized profiled slice"]},
        "skew_probe_ms_min_median_max": [skew_ms[0],
                                         statistics.median(skew_ms),
                                         skew_ms[-1]],
        "two_devices": two, "card": card_line()}}))
    return launches


# phase 15: data.parallel.auto (the jobs' implicit data mesh) on the card
AUTO_SLICE_ROWS = 20_000      # NumericalAttrStats' rows: its parse is Python
QUANT_PARTIALS = (8, 32, 64)  # random int32 partials in [0, 100,000)


def automesh_jobs(schema: str) -> list:
    """(tag, argv) of phase 15's jobs: NB, MI and Cramér streamed over
    phase 3's 1M rows, the two tree jobs on them whole, NumericalAttrStats
    (on the first 20,000 rows: its CSV parse is host Python) and phase
    13's stream."""
    common = [f"-Dfeature.schema.file.path={schema}"]
    chunked = [*common, f"-Dstream.chunk.rows={CHUNK_ROWS}"]
    return [
        ("nb", ["BayesianDistribution", *chunked]),
        ("mi", ["MutualInformation", *chunked]),
        ("cramer", ["CramerCorrelation", *chunked]),
        ("cpg", ["ClassPartitionGenerator", *common,
                 "-Doutput.split.prob=true"]),
        ("tree", ["DecisionTreeBuilder", *common, "-Dmax.depth=4"]),
        ("stats", ["NumericalAttrStats", *common, "-Dcond.attr.ord=11"]),
        ("stream", stream_argv(schema)),
    ]


def automesh_phase(work: str, train: str, schema: str, walls: dict) -> dict:
    """Phase 15: ``data.parallel.auto`` on the card; returns B1's and B4's
    launches by path.

    (a) ``auto_mesh`` of the card's devices: None on one card (a mesh
    needs two); (b) NB, MI, Cramér, ClassPartitionGenerator,
    DecisionTreeBuilder, phase 5b's NB + MI pipeline and phase 13's
    stream over phase 3's 1M rows and NumericalAttrStats over its first
    20,000, each with
    ``data.parallel.auto`` true and false: part files byte-identical and
    the launches of the true run n times the false run's over n ≥ 2 cards
    (per shard), equal on one; (c) the quantized reduce of random int32
    partials [8, 32, 64] in [0, 100,000) on cuda bit-equal to the CPU's,
    and phase 5b's pipeline with ``shard.devices=all`` and
    ``shard.allreduce.quantized=true`` at 250K-row chunks (partial cells
    far past 127) byte-identical between cuda and the CPU.  Prints one
    ``automesh`` JSON line with both walls of each job and the card's name
    and power limit."""
    import numpy as np
    import torch

    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.jobs.base import auto_mesh
    from avenir_tpu_torch.parallel import collectives

    j = lambda *p: os.path.join(work, *p)  # noqa: E731
    n_dev = torch.cuda.device_count()
    mesh = auto_mesh(JobConfig({}), "cuda")
    log(f"automesh (a): auto_mesh on cuda over {n_dev} card(s) is "
        f"{None if mesh is None else mesh.sizes}")
    if (mesh is None) != (n_dev < 2) or \
            auto_mesh(JobConfig({"data.parallel.auto": "false"}),
                      "cuda") is not None:
        raise AssertionError(f"auto_mesh on {n_dev} card(s): {mesh}")
    if n_dev < 2:
        log("automesh: one card, so no data mesh: each job below runs "
            "unsharded with data.parallel.auto true and false; the "
            "per-shard launches of a mesh of cards are not exercised here")
    launches, timed = {}, {}
    chunks = -(-ROWS_E2E // CHUNK_ROWS)
    off_want = {"mi": only(B1=chunks), "cramer": only(B1=chunks),
                "cpg": only(B4=1), "nb": only(), "stats": only(),
                "stream": only(B1=STREAM_BUCKETS + STREAM_PANES),
                "pipeline": only(B1=chunks)}
    pipe = pipeline_conf(work, "nb_mi_auto", train, schema)
    sliced = j("auto_slice.csv")
    with open(train) as src, open(sliced, "w") as dst:
        for _ in range(AUTO_SLICE_ROWS):
            dst.write(src.readline())
    for tag, argv in automesh_jobs(schema) + [("pipeline", None)]:
        got = {}
        for auto in ("false", "true"):
            out = j(f"auto_{tag}_{auto}")
            reset_counts()
            t0 = time.perf_counter()
            if tag == "pipeline":
                run_pipeline(["run", pipe, f"-Dpipeline.workspace={out}",
                              f"-Ddata.parallel.auto={auto}"])
            else:
                run_cli([*argv, f"-Ddata.parallel.auto={auto}",
                         sliced if tag == "stats" else train, out,
                         "--device", "cuda"])
            timed[f"{tag} auto={auto}"] = time.perf_counter() - t0
            got[auto] = read_counts()
        off, on = got["false"], got["true"]
        if tag in off_want and off != off_want[tag]:
            raise AssertionError(f"automesh {tag} (auto off) launched {off}")
        if tag == "tree" and (off["B4"] == 0 or off != only(B4=off["B4"])):
            raise AssertionError(f"automesh tree (auto off) launched {off}")
        if on != {k: v * n_dev for k, v in off.items()}:
            raise AssertionError(f"automesh {tag}: auto on launched {on}, "
                                 f"auto off {off} over {n_dev} card(s)")
        for kid in ("B1", "B4"):
            if off[kid]:
                launches.setdefault(kid, {})[f"auto_{tag}_off"] = off[kid]
                launches[kid][f"auto_{tag}_on"] = on[kid]
        arts = (("nb_model", "mi_out") if tag == "pipeline" else ("",))
        for art in arts:
            a = os.path.join(j(f"auto_{tag}_true"), art, "part-00000")
            b = os.path.join(j(f"auto_{tag}_false"), art, "part-00000")
            if tag == "stats" and n_dev > 1:
                compare_rel(a, b, MOMENT_RTOL)   # float64 sums in shard order
            else:
                same_bytes(a, b, f"automesh {tag} {art} auto on and off")
    walls.update({f"phase 15 {k}": v for k, v in timed.items()})
    log(f"automesh (b): part files byte-identical and launches "
        f"{'equal' if n_dev == 1 else f'x{n_dev}'} with data.parallel.auto "
        f"true and false; walls s {json.dumps(timed)}")

    # (c) the quantized reduce on the card (ROADMAP Queue 3, item 10)
    x = np.random.default_rng(0).integers(0, 100_000, size=QUANT_PARTIALS)
    parts = [torch.from_numpy(p.astype(np.int32)) for p in x]
    on_cpu = collectives.quantized_allreduce_sum(parts)
    on_card = collectives.quantized_allreduce_sum(
        [p.cuda() for p in parts]).cpu()
    if on_card.dtype != torch.float32 or not torch.equal(on_card, on_cpu):
        raise AssertionError("the quantized reduce differs between cuda and "
                             "the CPU")
    lossy = int((on_cpu.numpy() != x.sum(0)).sum())
    quant = ["-Dshard.devices=all", "-Dshard.allreduce.quantized=true"]
    flags = os.environ.get("XLA_FLAGS")
    for dev in ("cuda", "cpu"):
        reset_counts()
        t0 = time.perf_counter()
        try:
            # the CPU's shard slots (parallel/mesh.py::host_slots): as many
            # as the cards, so both runs quantize the same partials
            os.environ["XLA_FLAGS"] = \
                f"--xla_force_host_platform_device_count={n_dev}"
            run_pipeline(["run", pipe,
                          f"-Dpipeline.workspace={j('ws_q_' + dev)}",
                          *quant, "--device", dev])
        finally:
            if flags is None:
                os.environ.pop("XLA_FLAGS")
            else:
                os.environ["XLA_FLAGS"] = flags
        timed[f"quantized pipeline {dev}"] = time.perf_counter() - t0
        counts = read_counts()
        want = only(B1=chunks * n_dev) if dev == "cuda" else only()
        if counts != want:
            raise AssertionError(f"quantized pipeline on {dev} launched "
                                 f"{counts}")
        if dev == "cuda":
            launches["B1"]["auto_quantized_pipeline"] = counts["B1"]
    for art in ("nb_model", "mi_out"):
        same_bytes(j("ws_q_cuda", art, "part-00000"),
                   j("ws_q_cpu", art, "part-00000"),
                   f"quantized pipeline {art}")
    # NB's cells are the diagonal, each its row's largest, which the
    # scale maps to 127 exactly; MI's pair cells are the ones it rounds
    with open(j("ws_q_cuda", "mi_out", "part-00000"), "rb") as fa, \
            open(j("auto_pipeline_false", "mi_out", "part-00000"),
                 "rb") as fb:
        mi_rounded = fa.read() != fb.read()
    walls["phase 15 quantized pipeline cuda"] = timed["quantized pipeline cuda"]
    walls["phase 15 quantized pipeline cpu"] = timed["quantized pipeline cpu"]
    log(f"automesh (c): quantized reduce of {list(QUANT_PARTIALS)} partials "
        f"bit-equal cuda vs cpu ({lossy} of {on_cpu.numel()} cells off the "
        f"exact sum); quantized pipeline byte-identical cuda vs cpu, MI "
        f"{'rounded' if mi_rounded else 'exact'} against the exact gram")
    log(json.dumps({"automesh": {
        "devices": n_dev, "auto_mesh": None if mesh is None else mesh.sizes,
        "launches": launches,
        "launches_per_shard": {k: {p: v // n_dev for p, v in d.items()
                                   if p.endswith("_on")}
                               for k, d in launches.items()},
        "walls_s": timed, "quantized_cells_off_exact": lossy,
        "card": card_line()}}))
    return launches


# phase 16: the model steps' mesh= seams (kNN, LR, the Markov family, the
# explicit collective steps, the time-sharded Viterbi) on the card
MM_ROWS = 262_144            # the count and LR steps' rows
MM_KNN_QUERIES = 512         # the kNN step: the CPU scans the same refs
MM_KNN_REFS = 131_072        # (two 65,536-row tiles), so ~2 s there
MM_VITERBI_T = 4096          # one sequence's time axis


def model_mesh_runs(work: str, train: str, schema: str) -> list:
    """(tag, kind, argv or (conf, rows), launches with the key off) of
    phase 16 (a): NearestNeighbor over phase 8a's 1M references and 8b's
    10K, LogisticRegressionJob on phase 3's 1M rows, the three Markov
    jobs on phase 11 (b)'s CSVs, and ``ScoringPlane`` replays of the kNN
    (1M and 10K) and Viterbi servables on phase 12c's rows."""
    from avenir_tpu_torch.datagen.event_seq import STATES

    j = lambda *p: os.path.join(work, *p)  # noqa: E731
    elearn = {"feature.schema.file.path": j("elearn.json"),
              "training.data.path": j("elearn_train.csv"),
              "top.match.count": str(KNN_K)}
    small = {"feature.schema.file.path": j("elearn_small.json"),
             "training.data.path": j("small_train.csv"),
             "top.match.count": str(KNN_K)}
    hmm = j("HiddenMarkovModelBuilder_cuda")
    vocab = [f"-Dmodel.states={','.join(f'S{i}' for i in range(6))}",
             f"-Dmodel.observations={','.join(f'O{i}' for i in range(12))}"]
    as_d = lambda props: [f"-D{k}={v}" for k, v in props.items()]  # noqa: E731
    return [
        ("nn_1m", "job", ["NearestNeighbor", *as_d(elearn),
                          j("elearn_test.csv")], only(B5=1)),
        ("nn_10k", "job", ["NearestNeighbor", *as_d(small),
                           "-Dvalidation.mode=true",
                           "-Dkernel.function=gaussian",
                           "-Dpositive.class.value=F", j("small_test.csv")],
         only(B6=1)),
        ("lr", "job", ["LogisticRegressionJob",
                       f"-Dfeature.schema.file.path={schema}", train], only()),
        ("chain", "job", ["MarkovStateTransitionModel",
                          f"-Dmodel.states={','.join(STATES)}",
                          j("chain.csv")], only()),
        ("hmm", "job", ["HiddenMarkovModelBuilder", *vocab, j("tagged.csv")],
         only()),
        ("viterbi", "job", ["ViterbiStatePredictor",
                            f"-Dhmm.model.file.path={hmm}", j("obs.csv")],
         only()),
        ("serve_knn_1m", "replay", ({**elearn, "serve.models": "knn"},
                                    j("serve_knn1m.csv")), None),
        ("serve_knn_10k", "replay",
         ({**small, "kernel.function": "gaussian", "serve.models": "knn"},
          j("small_test.csv")), None),
        ("serve_viterbi", "replay",
         ({"hmm.model.file.path": hmm, "serve.sequence.pad.len": "256",
           "serve.models": "viterbi"}, j("serve_obs.csv")), None),
    ]


def model_mesh_steps(walls: dict) -> dict:
    """Phase 16 (b): each explicit step of ``parallel/collectives.py`` and
    ``viterbi_time_sharded`` on a one-device ``cuda`` mesh against the
    same step on a one-slot CPU mesh, at the CPU tests' shapes scaled up:
    counts exactly, float64 moments within 1e-12 relative, the LR step
    within relative 1e-6, kNN distances within DIST_TOL and indices equal
    (tie-free continuous data), the Viterbi path equal between the two
    and to the sequential ``_viterbi_batch`` on the card.  Returns
    name → {cuda_ms, cpu_s, max_abs_err}."""
    import numpy as np
    import torch

    from avenir_tpu_torch.datagen import hmm_seq
    from avenir_tpu_torch.models import markov as mk
    from avenir_tpu_torch.parallel import collectives as coll
    from avenir_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(16)
    n, f, fc, c, b = MM_ROWS, 8, 4, 3, 8
    codes = rng.integers(-1, b, size=(n, f)).astype(np.int32)
    labels = rng.integers(-1, c, size=n).astype(np.int32)
    cont = rng.normal(size=(n, fc)).astype(np.float32)
    pairs = np.array([(i, k) for i in range(f) for k in range(i + 1, f)])
    x = rng.normal(size=(n, 32)).astype(np.float32)
    y = (x[:, 0] - x[:, 1] + rng.normal(size=n) > 0).astype(np.float32)
    w = (rng.normal(size=32) * 0.1).astype(np.float32)
    m, nr = MM_KNN_QUERIES, MM_KNN_REFS
    kc = rng.integers(0, 10, size=(m + nr, 6)).astype(np.int32)
    kx = rng.normal(size=(m + nr, 8)).astype(np.float32)
    a, bm, pi = hmm_seq.planted_hmm(6, 12, seed=2)
    _s, obs = hmm_seq.sample_hmm(a, bm, pi, 1, MM_VITERBI_T, MM_VITERBI_T,
                                 seed=6)
    la, lb, lpi = (torch.from_numpy(np.log(np.maximum(v, 1e-12))
                                    .astype(np.float32)) for v in (a, bm, pi))

    def steps(dev):
        one = make_mesh(("data",), devices=[torch.device(dev)])
        grid = make_mesh(("data", "model"), shape=(1, 1),
                         devices=[torch.device(dev)])
        knn = coll.sharded_knn_topk(one, KNN_K, 10, ref_tile=65_536)
        return {
            "nb": lambda: coll.sharded_nb_fit_step(one, c, b, fc)(
                codes, labels, cont),
            "nb_2d": lambda: (lambda fb, cc: (*fb.parts, cc))(
                *coll.sharded_nb_fit_step_2d(grid, c, b)(codes, labels)),
            "mi": lambda: (lambda pa, fb, cc: (*pa.parts, fb, cc))(
                *coll.sharded_mi_step(grid, c, b)(codes, labels, pairs[:, 0],
                                                   pairs[:, 1])),
            "knn": lambda: knn(kc[:m], kx[:m], kc[m:], kx[m:], kx.min(0),
                               kx.max(0), nr),
            "lr": lambda: (coll.sharded_lr_step(one)(w, x, y, n, 0.5,
                                                     0.01),),
            "viterbi_time": lambda: (torch.from_numpy(
                mk.viterbi_time_sharded(la, lb, lpi, obs[0], one)),),
        }

    out = {}
    on_card, on_cpu = steps("cuda"), steps("cpu")
    for name in on_card:
        got = [t.cpu() for t in on_card[name]()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = [t.cpu() for t in on_cpu[name]()]
        cpu_s = time.perf_counter() - t0
        err = 0.0
        for g, v in zip(got, want):
            if g.dtype != v.dtype or g.shape != v.shape:
                raise AssertionError(f"model step {name}: {g.dtype} "
                                     f"{tuple(g.shape)} vs {v.dtype} "
                                     f"{tuple(v.shape)}")
            if g.dtype == torch.float64:
                rel = float(((g - v).abs() / v.abs().clamp_min(1e-300))
                            .max()) if g.numel() else 0.0
                if rel > MOMENT_RTOL:
                    raise AssertionError(f"model step {name}: moments "
                                         f"{rel} apart")
                err = max(err, float((g - v).abs().max()))
            elif g.dtype == torch.float32:
                gap = float((g - v).abs().max())
                bar = (1e-6 * float(v.abs().max()) if name == "lr"
                       else DIST_TOL)
                if gap > bar:
                    raise AssertionError(f"model step {name}: {gap} apart")
                err = max(err, gap)
            elif not torch.equal(g, v):
                raise AssertionError(f"model step {name}: cuda and cpu "
                                     f"differ")
        if name == "viterbi_time":
            seq = mk._viterbi_batch(la.cuda(), lb.cuda(), lpi.cuda(),
                                    torch.from_numpy(obs).cuda().long())
            if not torch.equal(got[0].long(), seq[0].cpu()):
                raise AssertionError("time-sharded Viterbi differs from the "
                                     "sequential decoder on the card")
        ms = time_ms(on_card[name], iters=5, warmup=1)
        out[name] = {"cuda_ms": ms, "cpu_s": cpu_s, "max_abs_err": err}
        walls[f"phase 16 step {name} cpu"] = cpu_s
    return out


def model_mesh_phase(work: str, train: str, schema: str,
                     walls: dict) -> dict:
    """Phase 16: the model steps' ``mesh=`` seams on the card; returns B5's
    and B6's launches by path.

    (a) ``auto_mesh`` of the card's devices (None on one card), then each
    of :func:`model_mesh_runs` with ``data.parallel.auto`` false and true:
    part files and replay responses byte-identical, the launches of the
    two runs equal (NearestNeighbor 1M B5 1, 10K B6 1 with the key off;
    over n ≥ 2 cards the kNN runs take the sharded route, a scan a card,
    and launch nothing with it on), both walls printed; (b)
    :func:`model_mesh_steps`.  Prints one ``model_mesh`` JSON line with
    the card's name and power limit."""
    import torch

    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.jobs import get_job
    from avenir_tpu_torch.jobs.base import auto_mesh

    n_dev = torch.cuda.device_count()
    mesh = auto_mesh(JobConfig({}), "cuda")
    log(f"model mesh (a): auto_mesh on cuda over {n_dev} card(s) is "
        f"{None if mesh is None else mesh.sizes}")
    if (mesh is None) != (n_dev < 2):
        raise AssertionError(f"auto_mesh on {n_dev} card(s): {mesh}")
    launches, timed = {}, {}
    for tag, kind, what, off_want in model_mesh_runs(work, train, schema):
        got = {}
        for auto in ("false", "true"):
            out = os.path.join(work, f"mm_{tag}_{auto}")
            reset_counts()
            t0 = time.perf_counter()
            if kind == "job":
                run_cli([*what[:-1], f"-Ddata.parallel.auto={auto}",
                         what[-1], out, "--device", "cuda"])
            else:
                props, rows = what
                get_job("ScoringPlane").run(
                    JobConfig({**props, "data.parallel.auto": auto,
                               "serve.request.timeout.ms": "60000"}),
                    rows, out, device="cuda")
            timed[f"{tag} auto={auto}"] = time.perf_counter() - t0
            got[auto] = read_counts()
        off, on = got["false"], got["true"]
        if off_want is not None and off != off_want:
            raise AssertionError(f"model mesh {tag} (auto off) launched "
                                 f"{off}")
        knn = tag.startswith(("nn_", "serve_knn"))
        if on != (only() if knn and n_dev > 1 else off):
            raise AssertionError(f"model mesh {tag}: auto on launched {on}, "
                                 f"auto off {off} over {n_dev} card(s)")
        for kid in ("B5", "B6"):
            if off[kid]:
                launches.setdefault(kid, {})[f"mm_{tag}_off"] = off[kid]
                launches[kid][f"mm_{tag}_on"] = on[kid]
        same_bytes(os.path.join(work, f"mm_{tag}_true", "part-00000"),
                   os.path.join(work, f"mm_{tag}_false", "part-00000"),
                   f"model mesh {tag} auto on and off")
    walls.update({f"phase 16 {k}": v for k, v in timed.items()})
    log(f"model mesh (a): part files and responses byte-identical, launches "
        f"{'equal' if n_dev == 1 else 'none on the sharded kNN route'} with "
        f"data.parallel.auto true and false; walls s {json.dumps(timed)}")
    steps = model_mesh_steps(walls)
    log(f"model mesh (b): the five steps and viterbi_time_sharded on a "
        f"one-device cuda mesh equal a one-slot CPU mesh: "
        f"{json.dumps(steps)}")
    log(json.dumps({"model_mesh": {
        "devices": n_dev, "auto_mesh": None if mesh is None else mesh.sizes,
        "launches": launches, "walls_s": timed, "steps": steps,
        "card": card_line()}}))
    return launches


def torch_sync() -> None:
    import torch

    torch.cuda.synchronize()


def knn_path_cases(rec: Recorder, used: dict) -> list:
    """Phase 9: B5 and B6 against their plain versions on every call the
    kNN paths made on cuda; the first call of each path and shape is timed
    with its plain version, yardstick and bound, the bound over the path's
    used lanes and real test rows and references (``used``, as the phases
    read them from the model and test set they ran)."""
    import torch

    from avenir_tpu_torch.ops import knn as tk

    results, timed, seen = [], set(), {}
    for name, path, args, kwargs in rec.calls:
        if name not in ("knn_tourney", "knn_topk"):
            continue
        i = seen[path] = seen.get(path, -1) + 1
        q, r = args[0], args[1]
        wc = tk.contraction_width(q.shape[1], kwargs.get("used"))
        label = (f"{path} call {i}: {q.shape[0]} x {r.shape[0]} refs, W "
                 f"{q.shape[1]}, contracted {wc}")
        if name == "knn_tourney":
            kid = "B5"
            fn = lambda: tk.knn_tourney(q, r, **kwargs)  # noqa: E731
            ref = lambda: tk.knn_tourney_ref(q, r)  # noqa: E731
            lib = tourney_library(q, r)
            differ, swapped, err = check_tourney(q, r, fn(), ref(), label)
            row = {"keys_differ": differ, "columns_differ": swapped}
        else:
            kid, kk = "B6", args[2]
            fn = lambda: tk.knn_topk(q, r, kk, **kwargs)  # noqa: E731
            ref = lambda: tk.knn_topk_ref(q, r, kk)  # noqa: E731
            lib = topk_library(q, r, kk)
            swapped, err = check_topk(fn(), ref(), kk, False, label)
            row = {"rows_swapped_at_kk": swapped, "kk": kk,
                   "splits": topk_ranges(q, r, kk)}
        if kwargs.get("used") != used[path][0]:
            raise AssertionError(f"{path}: the search handed {kid} "
                                 f"{kwargs.get('used')} used lanes, the "
                                 f"schema has {used[path][0]}")
        row["w_contracted"] = wc
        row.update({"kernel": kid, "path": path, "call": i, "case": label,
                    "max_abs_err": err})
        key = (path, tuple(q.shape), tuple(r.shape))
        if key not in timed:
            timed.add(key)
            big = r.shape[0] >= KNN_REFS
            row["ms"] = time_ms(fn, iters=10 if big else 20)
            row["plain_ms"] = time_ms(ref, iters=3, warmup=1)
            row["library_ms"] = time_ms(lib, iters=5 if big else 20)
            w_used, m_real, n_real = used[path]
            if (tk._round_up(max(m_real, tk.TM), tk.TM) != q.shape[0]
                    or r.shape[0] < n_real):
                raise AssertionError(f"{path}: {m_real} test rows x {n_real} "
                                     f"refs do not fit the call's operands "
                                     f"{tuple(q.shape)}, {tuple(r.shape)}")
            row.update({"w_used": w_used, "m": m_real, "n": n_real})
            row["bound_ms"], row["bound_by"] = knn_bound(
                kid, q, r, m_real, n_real, w_used)
            log(f"{kid} path case:", json.dumps(row))
        results.append(row)
    rec.calls.clear()
    torch.cuda.empty_cache()
    log(f"knn path cases: {len(results)} recorded calls held against their "
        f"plain versions")
    return results


# the TPU probes and their counterparts (avenir_tpu_torch/probes.py)
PROBE_SITES = {"knn_tourney": "benchmarks/knn_decomp_probe.py:113",
               "onehot_gram": "benchmarks/cooc_expand_sweep.py:187,214",
               "orient_gram": "benchmarks/dot_orient_probe.py:60,72"}


def probe_phase() -> list:
    """Phase 10: the three probes' counterparts at the main paths' shapes,
    each variant timed (avenir_tpu_torch/probes.py), the kernel each
    breaks down held against its plain version, and the plain version,
    the library yardstick and the bound timed and computed beside it.
    Prints one JSON line per probe; returns the kernels-line entries."""
    import torch

    from avenir_tpu_torch import probes
    from avenir_tpu_torch.ops import hist
    from avenir_tpu_torch.ops import knn as tk

    entries = []
    # B5 in its variants: dot only, dot + keys, the kernel, one insert a key
    cases = []
    for label, (n, m, f, fc, nb) in probes.KNN_SHAPES.items():
        q, r, used = probes.knn_operands(n, m, f, fc, nb, seed=400)
        ms = probes.knn_tourney_probe(q, r, used)
        got = probes.knn_tourney_variant(q, r, "full", used)
        want = tk.knn_tourney_ref(q, r)
        torch.cuda.synchronize()
        _differ, _swapped, err = check_tourney(q, r, got, want, label)
        bound_ms, bound_by = knn_bound("B5", q, r, m, n, used)
        cases.append({"case": label, "ms": ms, "max_abs_err": err,
                      "w_contracted": tk.contraction_width(q.shape[1], used),
                      "plain_ms": time_ms(lambda: tk.knn_tourney_ref(q, r),
                                          iters=3, warmup=1),
                      "library_ms": time_ms(tourney_library(q, r), iters=5),
                      "bound_ms": bound_ms, "bound_by": bound_by})
        del q, r, got, want
        torch.cuda.empty_cache()
    entries.append(("knn_tourney", "csrc/knn_tourney.cu", "full", cases))
    # the one-hot MMA gram (B1 until this slice) beside the pair histogram
    cases = []
    for label, (n, f, b, c) in [*probes.GRAM_SHAPES.items(),
                                ("hospital 11x12x2 fmaj, 16M rows",
                                 (16_000_000, 11, 12, 2))]:
        codes, labels = probes.gram_operands(n, f, b, c, seed=401)
        want = hist.cooc_counts_cols_ref(codes, labels, b, c)
        got = probes.onehot_gram(codes, labels, b, c)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"the one-hot gram disagrees on {label}")
        call, keep = library_gram(codes, labels, b, c)
        big = n >= 1_000_000
        _mode, _jcp, wp = hist.plan(f, b, c)
        cases.append({"case": label,
                      "ms": probes.onehot_gram_probe(codes, labels, b, c,
                                                     iters=10 if big else 20),
                      "max_abs_err": 0,
                      "plain_ms": time_ms(lambda: hist.cooc_counts_cols_ref(
                          codes, labels, b, c), iters=3, warmup=1),
                      "library_ms": time_ms(call, iters=5),
                      **gram_bound(f, n, wp * wp, f * b * c, n)})
        del codes, labels, want, got, keep
        torch.cuda.empty_cache()
    entries.append(("onehot_gram", "csrc/gram_probe.cu", "full", cases))
    # the int8 gram's mma.sync stage on X staged from [N, W] and [W, N]
    n, w = probes.ORIENT_SHAPE
    x_rows, x_cols = probes.orient_operands(n, w, seed=402)
    lib_g = torch._int_mm(x_cols, x_rows)
    block = 1 << 22          # float32 sums of ≤ 4·2^22 stay exact

    def plain():
        g = torch.zeros((w, w), dtype=torch.int32, device="cuda")
        for s0 in range(0, n, block):
            xb = x_rows[s0:s0 + block].float()
            g += (xb.T @ xb).to(torch.int32)
        return g

    for rows in (True, False):
        if not torch.equal(probes.orient_gram(x_rows if rows else x_cols, rows),
                           lib_g):
            raise AssertionError(f"the oriented gram disagrees (rows={rows})")
    if not torch.equal(plain(), lib_g):
        raise AssertionError("the oriented gram's plain version disagrees")
    orient_bound, orient_by = bound(n * w + 4 * w * w, w * (w + 1) * n)
    cases = [{"case": f"W {w}, {n} rows, int8 in [-2, 2]",
              "ms": probes.orient_gram_probe(x_rows, x_cols),
              "max_abs_err": 0, "plain_ms": time_ms(plain, iters=3, warmup=1),
              "library_ms": time_ms(lambda: torch._int_mm(x_cols, x_rows),
                                    iters=3, warmup=1),
              "bound_ms": orient_bound, "bound_by": orient_by}]
    del x_rows, x_cols, lib_g
    torch.cuda.empty_cache()
    entries.append(("orient_gram", "csrc/gram_probe.cu", "rows", cases))

    out = []
    for name, source, main, cases in entries:
        log(json.dumps({"probe": name, "replaces": PROBE_SITES[name],
                        "cases": cases}))
        first = cases[0]
        out.append({
            "name": f"{name} (probe)",
            "route": "cuda",
            "source": "avenir_tpu_torch/" + source,
            "replaces": PROBE_SITES[name],
            "launches": 0,          # on no path: the probes count none
            "on_main_path": False,
            "case": first["case"],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": first["ms"][main],
            "ms_by_variant": first["ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
        })
    return out


# ---------------------------------------------------------------------------
# phase 17: the process plane (python -m avenir_tpu_torch.launch)
# ---------------------------------------------------------------------------

FLEET_PROCS = 2
WIDE_F, WIDE_B = 20, 20      # the 20 × 20 × 2 schema of phase 3b (B2)


def fleet_worker(spec_path: str) -> int:
    """One rank of a phase-17 fleet: ``chip_smoke.py --fleet-worker
    <spec.json>``, started by ``python -m avenir_tpu_torch.launch``.  Joins
    the fleet from the launcher's environment, then runs each task of the
    spec (a job through the port's CLI entry, or a pipeline through its
    CLI) with every launch count set to 0 just before and read just after;
    prints one ``FLEET`` JSON line a task (rank, launches, wall, whether
    the injected crash fired) and one ``FLEETJOIN`` line."""
    from avenir_tpu_torch.launch import join_from_env
    from avenir_tpu_torch.telemetry import spans as tel

    t0 = time.perf_counter()
    rank = join_from_env()
    log("FLEETJOIN " + json.dumps(
        {"rank": rank, "join_ms": (time.perf_counter() - t0) * 1e3}))
    with open(spec_path) as fh:
        tasks = json.load(fh)
    for task in tasks:
        reset_counts()
        t0 = time.perf_counter()
        crashed = False
        try:
            if task["kind"] == "pipeline":
                run_pipeline(task["argv"])
            else:
                run_cli(task["argv"])
        except Exception as e:  # noqa: BLE001
            if not (task.get("expect_crash") and "injected" in str(e)):
                raise
            crashed = True
        finally:
            # a traced task's conf switched the rank's tracer on; off
            # again, so the next task journals only if its conf asks
            tel.tracer().disable()
        log("FLEET " + json.dumps({
            "rank": rank, "tag": task["tag"], "launches": read_counts(),
            "wall_s": time.perf_counter() - t0, "crashed": crashed}))
    return 0


def launch_fleet(work: str, name: str, tasks: list, journal=None) -> dict:
    """Run ``tasks`` in a fleet of FLEET_PROCS ranks through ``python -m
    avenir_tpu_torch.launch`` (each rank ``chip_smoke.py --fleet-worker``);
    returns {"tasks": {(tag, rank): record}, "join_ms": {rank: ms},
    "wall_s": the launcher's wall}."""
    spec = os.path.join(work, f"{name}.json")
    with open(spec, "w") as fh:
        json.dump(tasks, fh)
    argv = [sys.executable, "-m", "avenir_tpu_torch.launch",
            "--nprocs", str(FLEET_PROCS), "--join-timeout-sec", "120",
            "--timeout-sec", "600"]
    if journal:
        argv += ["--journal-dir", journal]
    argv += ["--", os.path.join(HERE, "chip_smoke.py"), "--fleet-worker", spec]
    t0 = time.perf_counter()
    res = subprocess.run(argv, cwd=HERE, capture_output=True, text=True,
                         timeout=900)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"fleet {name} exited {res.returncode}:\n"
                             f"{res.stdout[-6000:]}\n{res.stderr[-3000:]}")
    out = {"tasks": {}, "join_ms": {}, "wall_s": wall}
    for line in res.stdout.splitlines():
        _, _, body = line.partition("] ")
        if body.startswith("FLEET "):
            rec = json.loads(body[len("FLEET "):])
            out["tasks"][rec["tag"], rec["rank"]] = rec
        elif body.startswith("FLEETJOIN "):
            rec = json.loads(body[len("FLEETJOIN "):])
            out["join_ms"][rec["rank"]] = rec["join_ms"]
    missing = [(t["tag"], r) for t in tasks for r in range(FLEET_PROCS)
               if (t["tag"], r) not in out["tasks"]]
    if missing or len(out["join_ms"]) != FLEET_PROCS:
        raise AssertionError(f"fleet {name} reported no record of {missing}:"
                             f"\n{res.stdout[-6000:]}")
    return out


def write_wide_csv(work: str):
    """Phase 3b's seeded 20 × 20 × 2 dataset as a 1M-row CSV (an id, 20
    categorical codes, the class) and its schema."""
    import numpy as np

    ds = wide_dataset(ROWS_E2E, WIDE_F, WIDE_B, seed=12)
    path = os.path.join(work, "wide.csv")
    table = np.concatenate([np.arange(ROWS_E2E)[:, None], ds.codes,
                            ds.labels[:, None]], axis=1)
    np.savetxt(path, table, fmt="%d", delimiter=",")
    fields = [{"name": "id", "ordinal": 0, "id": True, "dataType": "string"}]
    fields += [{"name": f"f{j}", "ordinal": 1 + j, "feature": True,
                "dataType": "categorical",
                "cardinality": [str(v) for v in range(WIDE_B)]}
               for j in range(WIDE_F)]
    fields.append({"name": "cls", "ordinal": 1 + WIDE_F,
                   "dataType": "categorical", "cardinality": ["0", "1"]})
    schema = os.path.join(work, "wide.json")
    with open(schema, "w") as fh:
        json.dump({"fields": fields}, fh)
    return path, schema


def stream_tail(got_path: str, full_path: str, what: str) -> int:
    """A resumed StreamAnalytics part file is the uninterrupted one from
    its first window on; returns that window's index."""
    with open(got_path) as fh:
        tail = fh.read().splitlines()
    with open(full_path) as fh:
        full = fh.read().splitlines()
    first = int(tail[0].split(",")[0][len("w="):])
    if first < 1 or tail != lines_from(full, first):
        raise AssertionError(f"{what}: the resumed windows from w={first} "
                             f"differ from the uninterrupted run's")
    return first


def fleet_phase(work: str, train: str, schema: str, walls: dict,
                dev: str = "cuda") -> dict:
    """Phase 17: the process plane on the card, through ``python -m
    avenir_tpu_torch.launch --nprocs 2``, each rank its own CUDA context
    on ``cuda:0``; returns B1's and B2's launches by path and rank.

    (a) BayesianDistribution, MutualInformation (B1) and MutualInformation
    on a 1M-row 20 × 20 × 2 CSV (B2) in 250K-row chunks, traced: rank 0
    owns chunks 0 and 2, rank 1 chunks 1 and 3 (2 launches a rank), the
    totals merge in one ``all_process_sum_state`` and rank 0 writes part
    files byte-identical to the one-process runs (phase 3's, and one here
    for the wide CSV); each rank's wall, the fleet's wall and each rank's
    ``collective.wait`` beside the one-process walls; (b) NB killed on
    both ranks after its first snapshot (``proc-000-of-002``,
    ``proc-001-of-002``) and relaunched with ``--resume``: (a)'s bytes,
    the snapshots gone; (c) phase 5b's NB + MI pipeline under
    ``shard.devices=all`` and ``shard.proc.axis=proc`` (a global 2 × 1
    mesh: each rank folds its half of every padded chunk, B1 4 a rank):
    part files = 5b's fused run's; (d) elastic restore: phase 13's stream
    under the same global plan, crashed after pane 9 (a window snapshot
    under ``:mesh:proc2xdata1`` every 4 panes), resumed in one process
    unsharded from rank 0's snapshot, and the stream under
    ``shard.devices=all`` in one process (``:mesh:data1``) crashed and
    resumed unsharded: each refused without ``shard.reshard.on.restore``,
    and with it the windows of phase 13's uninterrupted run from the
    restore on; (e) LogisticRegressionJob streamed over the fleet (one
    gradient merge an iteration): the history of phase 11's one-process
    run within the LR contract; (f) the join against an address where
    nothing listens (a socket bound to port 0, never listening) raises
    ``LaunchError`` within its timeout.  Prints one ``fleet`` JSON line
    with the card's name and power limit.  ``dev="cpu"`` rehearses the
    phase on the host (no kernel launches expected) against the same
    reference files made with ``--device cpu``."""
    import socket

    from avenir_tpu_torch.core.config import ConfigError
    from avenir_tpu_torch.launch import LaunchError
    from avenir_tpu_torch.parallel.mesh import init_distributed
    from avenir_tpu_torch.telemetry.journal import read_events

    j = lambda *p: os.path.join(work, *p)  # noqa: E731
    kern = only if dev == "cuda" else (lambda **_: only())
    chunks = -(-ROWS_E2E // CHUNK_ROWS)
    common = [f"-Dfeature.schema.file.path={schema}",
              f"-Dstream.chunk.rows={CHUNK_ROWS}"]
    tel_dir = j("fleet_tel")
    traced = ["-Dtrace.on=true", f"-Dtrace.journal.dir={tel_dir}",
              "-Dtrace.run.id=fleet17"]
    wide_csv, wide_schema = write_wide_csv(work)
    wide = [f"-Dfeature.schema.file.path={wide_schema}",
            f"-Dstream.chunk.rows={CHUNK_ROWS}"]
    reset_counts()
    t0 = time.perf_counter()
    run_cli(["MutualInformation", *wide, wide_csv, j("mi_wide_one"),
             "--device", dev])
    walls["cuda MutualInformation 20x20x2"] = time.perf_counter() - t0
    if read_counts() != kern(B2=chunks):
        raise AssertionError(f"MI 20x20x2 CLI launched {read_counts()}")
    ck = j("fleet_ck")
    ck_keys = [f"-Dstream.checkpoint.dir={ck}",
               "-Dstream.checkpoint.interval.chunks=1"]
    mi_algos = "-Dmutual.info.score.algorithms=mim,mifs,jmi,disr,mrmr"
    half = chunks // FLEET_PROCS

    # (a) and the kill of (b)
    first = launch_fleet(work, "fleet_a", [
        {"tag": "nb", "kind": "job",
         "argv": ["BayesianDistribution", *common, *traced, train,
                  j("fleet_nb"), "--device", dev]},
        {"tag": "mi", "kind": "job",
         "argv": ["MutualInformation", *common, mi_algos, *traced, train,
                  j("fleet_mi"), "--device", dev]},
        {"tag": "mi_wide", "kind": "job",
         "argv": ["MutualInformation", *wide, *traced, wide_csv,
                  j("fleet_mi_wide"), "--device", dev]},
        {"tag": "nb_kill", "kind": "job", "expect_crash": True,
         "argv": ["BayesianDistribution", *common, *ck_keys,
                  "-Dstream.fault.crash.after.chunks=1", train,
                  j("fleet_nb_kill"), "--device", dev]}],
        journal=tel_dir)
    walls["fleet (a) launch"] = first["wall_s"]
    tasks = first["tasks"]
    for rank in range(FLEET_PROCS):
        want = {"nb": only(), "mi": kern(B1=half), "mi_wide": kern(B2=half),
                "nb_kill": only()}
        for tag, launches in want.items():
            if tasks[tag, rank]["launches"] != launches:
                raise AssertionError(f"fleet {tag} rank {rank} launched "
                                     f"{tasks[tag, rank]['launches']}")
        if not tasks["nb_kill", rank]["crashed"]:
            raise AssertionError(f"rank {rank}: the injected crash missed")
    same_bytes(j("fleet_nb", "part-00000"), j("cuda_nb", "part-00000"),
               "fleet NB and the one-process NB")
    same_bytes(j("fleet_mi", "part-00000"), j("cuda_mi", "part-00000"),
               "fleet MI and the one-process MI")
    same_bytes(j("fleet_mi_wide", "part-00000"),
               j("mi_wide_one", "part-00000"), "fleet MI 20x20x2")
    subdirs = sorted(os.listdir(ck))
    if subdirs != [f"proc-{r:03d}-of-002" for r in range(FLEET_PROCS)]:
        raise AssertionError(f"fleet snapshots under {subdirs}")
    merged = [p for p in os.listdir(tel_dir) if p.startswith("fleet-")]
    events = read_events(os.path.join(tel_dir, merged[0]))
    # the three traced tasks' merges; the untraced killed NB journals
    # nothing (each rank turns its tracer off after every task)
    waits = {r: [e["wall_ms"] for e in events
                 if e["ev"] == "collective.wait" and e["proc"] == r]
             for r in range(FLEET_PROCS)}
    if any(len(w) != 3 for w in waits.values()):
        raise AssertionError(f"collective.wait events {waits}")
    waits = {r: dict(zip(("nb", "mi", "mi_wide"), w))
             for r, w in waits.items()}
    log(f"fleet (a): NB, MI and MI 20x20x2 over {FLEET_PROCS} processes "
        f"byte-identical to one process; MI B1 {half} a rank, MI 20x20x2 B2 "
        f"{half} a rank; launcher wall {first['wall_s']:.2f} s")

    # (b) the resume, (c) the global plan, (d)'s fleet snapshot, (e) LR
    wck = j("fleet_wck")
    # the ranks' confs carry their launcher-given trace.writer.suffix, so
    # the drill names its run: a 2 → 1 process restore is deliberate
    run_id = "-Dstream.run.id=fleet17-stream"
    stream_kill = [run_id, f"-Dstream.checkpoint.dir={wck}",
                   "-Dstream.checkpoint.interval.panes=4",
                   "-Dstream.fault.crash.after.panes=9"]
    path = pipeline_conf(work, "nb_mi_fleet", train, schema)
    second = launch_fleet(work, "fleet_b", [
        {"tag": "nb_resume", "kind": "job",
         "argv": ["BayesianDistribution", *common, *ck_keys, train,
                  j("fleet_nb_kill"), "--device", dev, "--resume"]},
        {"tag": "pipeline", "kind": "pipeline",
         "argv": ["run", path, f"-Dpipeline.workspace={j('ws_fleet')}",
                  "-Dshard.devices=all", "-Dshard.proc.axis=proc",
                  "--device", dev]},
        {"tag": "stream_kill", "kind": "job", "expect_crash": True,
         "argv": [*stream_argv(schema, "-Dshard.devices=all",
                               "-Dshard.proc.axis=proc", *stream_kill),
                  train, j("fleet_stream"), "--device", dev]},
        {"tag": "lr", "kind": "job",
         "argv": ["LogisticRegressionJob", *common, train, j("fleet_lr"),
                  "--device", dev]}])
    walls["fleet (b-e) launch"] = second["wall_s"]
    tasks2 = second["tasks"]
    for rank in range(FLEET_PROCS):
        if tasks2["pipeline", rank]["launches"] != kern(B1=chunks):
            raise AssertionError(f"global pipeline rank {rank} launched "
                                 f"{tasks2['pipeline', rank]['launches']}")
        if tasks2["nb_resume", rank]["launches"] != only() or \
                tasks2["lr", rank]["launches"] != only():
            raise AssertionError(f"fleet NB resume / LR launched kernels")
        if not tasks2["stream_kill", rank]["crashed"]:
            raise AssertionError(f"rank {rank}: the stream crash missed")
    same_bytes(j("fleet_nb_kill", "part-00000"), j("fleet_nb", "part-00000"),
               "resumed fleet NB and (a)'s")
    if os.path.exists(ck):
        raise AssertionError("the resumed fleet left its snapshots behind")
    for art in ("nb_model", "mi_out"):
        same_bytes(j("ws_fleet", art, "part-00000"),
                   j("ws_fused", art, "part-00000"),
                   f"global-plan pipeline {art} and phase 5b's")
    got, status = lr_history(j("fleet_lr", "part-00000"))
    want, want_status = lr_history(j("lr_streamed_cuda", "part-00000"))
    if status != want_status:
        raise AssertionError(f"fleet LR {status} vs {want_status}")
    lr_diff = close_histories(got, want, "fleet LR")
    log(f"fleet (b): NB killed on both ranks after its first snapshot, "
        f"resumed: (a)'s bytes; (c) global 2 x 1 pipeline = 5b's, B1 "
        f"{chunks} a rank; (e) LR {len(got)} iterations, {status}, within "
        f"{lr_diff:.2e} of the one-process history")

    # (d) elastic restore: the fleet's window snapshot, and one process's
    full = j("stream_cuda", "part-00000")
    resume = lambda sub, out, *extra: run_cli(  # noqa: E731
        [*stream_argv(schema, run_id, f"-Dstream.checkpoint.dir={sub}",
                      "-Dstream.resume=true", *extra), train, out,
         "--device", dev])
    sub = os.path.join(wck, "proc-000-of-002")
    refused = expect_raise(ConfigError, "shard.reshard.on.restore=true",
                           lambda: resume(sub, j("fleet_d_refused")))
    if os.path.exists(j("fleet_d_refused")):
        raise AssertionError("a refused restore wrote output")
    t0 = time.perf_counter()
    resume(sub, j("fleet_d"), "-Dshard.reshard.on.restore=true")
    walls["cuda StreamAnalytics resumed from the fleet"] = \
        time.perf_counter() - t0
    w_fleet = stream_tail(j("fleet_d", "part-00000"), full,
                          "2-process window snapshot resumed in 1")
    one_ck = j("one_wck")
    kill = [run_id, f"-Dstream.checkpoint.dir={one_ck}",
            "-Dstream.checkpoint.interval.panes=4",
            "-Dstream.fault.crash.after.panes=9"]
    expect_raise(RuntimeError, "injected crash", lambda: run_cli(
        [*stream_argv(schema, "-Dshard.devices=all", *kill), train,
         j("one_stream_kill"), "--device", dev]))
    expect_raise(ConfigError, "':mesh:data1'",
                 lambda: resume(one_ck, j("one_d_refused")))
    resume(one_ck, j("one_d"), "-Dshard.reshard.on.restore=true")
    w_one = stream_tail(j("one_d", "part-00000"), full,
                        "shard.devices=all window snapshot resumed unsharded")
    log(f"fleet (d): window snapshots under :mesh:proc2xdata1 and "
        f":mesh:data1 refused unsharded without the gate ({refused[:60]}...) "
        f"and resumed with it: phase 13's windows from w={w_fleet} and "
        f"w={w_one}")

    # (f) the bounded join against an address where nothing listens
    with socket.socket() as hold:
        hold.bind(("127.0.0.1", 0))          # bound, never listening
        address = f"127.0.0.1:{hold.getsockname()[1]}"
        t0 = time.perf_counter()
        msg = expect_raise(LaunchError, address, lambda: init_distributed(
            coordinator_address=address, num_processes=2, process_id=1,
            timeout_s=3, attempts=1))
        join_fail_s = time.perf_counter() - t0
    if join_fail_s > 10:
        raise AssertionError(f"the failed join took {join_fail_s:.1f} s")
    log(f"fleet (f): join against {address} raised LaunchError in "
        f"{join_fail_s:.2f} s: {msg[:90]}")

    report = {
        "fleet": {
            "procs": FLEET_PROCS, "card": card_line(),
            "one_process_s": {
                "BayesianDistribution": walls["cuda BayesianDistribution"],
                "MutualInformation": walls["cuda MutualInformation"],
                "MutualInformation 20x20x2":
                    walls["cuda MutualInformation 20x20x2"],
                "LogisticRegressionJob streamed":
                    walls.get("cuda LogisticRegressionJob streamed")},
            "rank_s": {f"{tag} p{r}": rec["wall_s"]
                       for (tag, r), rec in {**tasks, **tasks2}.items()},
            "collective_wait_ms": {f"p{r}": w for r, w in waits.items()},
            "join_ms": {**{f"(a) p{r}": ms
                           for r, ms in first["join_ms"].items()},
                        **{f"(b-e) p{r}": ms
                           for r, ms in second["join_ms"].items()}},
            "launcher_s": {"(a)": first["wall_s"], "(b-e)": second["wall_s"]},
            "lr_history_rel_diff": lr_diff,
            "failed_join_s": join_fail_s}}
    log(json.dumps(report))
    per_rank = lambda tag, kid: {  # noqa: E731
        f"fleet_{tag}_p{r}": rec["launches"][kid]
        for (t, r), rec in {**tasks, **tasks2}.items() if t == tag}
    return {"B1": {**per_rank("mi", "B1"), **per_rank("pipeline", "B1"),
                   **per_rank("stream_kill", "B1")},
            "B2": per_rank("mi_wide", "B2")}


# ---------------------------------------------------------------------------
# phase 18: the serving fleet (launch --serve, GlobalRouter, RESP)
# ---------------------------------------------------------------------------

SERVE_WARMED = 7             # serve.bucket.sizes 1, 2, ..., 64: one B5/B6 each
SERVE_MAX_BUCKET = 64
ROUTER_THREADS = 8           # fleet.pool.client.threads: the router's POSTs
FAILOVER_ROWS = 2000         # phase 12c's hospital rows, NB through a router
LEAD_GEN_ROUNDS = 600


def serve_worker(out_dir: str, argv: list) -> int:
    """One serving worker of phase 18: ``chip_smoke.py --serve-worker
    <dir> <serving CLI arguments>``, started by the fleet's spawner
    (``launch --serve ... -- chip_smoke.py --serve-worker <dir>``) or by
    the RESP drill.  Sets every launch count to 0, runs the serving CLI
    (model load, the warmed buckets, then HTTP until SIGTERM) in this
    process, and on the way out writes the counts it reads to
    ``<dir>/<shard suffix>.json``."""
    from avenir_tpu_torch.launch import ENV_SUFFIX
    from avenir_tpu_torch.serving.__main__ import main as serve_main

    reset_counts()
    rc = serve_main(argv)
    path = os.path.join(out_dir, (os.environ.get(ENV_SUFFIX) or "worker")
                        + ".json")
    with open(path + ".tmp", "w") as fh:
        json.dump({"launches": read_counts(), "rc": rc}, fh)
    os.replace(path + ".tmp", path)
    return rc


def serve_worker_argv(out_dir: str) -> list:
    os.makedirs(out_dir, exist_ok=True)
    return [os.path.join(HERE, "chip_smoke.py"), "--serve-worker", out_dir]


class Child:
    """A child process of this script whose merged output a thread reads
    line by line, so that its pipe never fills."""

    def __init__(self, argv, env=None):
        import threading

        self.argv = argv
        self.proc = subprocess.Popen(argv, cwd=HERE, env=env, text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT)
        self.lines = []
        self.stamps = []                 # perf_counter as each line came
        self._cond = threading.Condition()
        self._eof = False
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            with self._cond:
                self.lines.append(line.rstrip("\n"))
                self.stamps.append(time.perf_counter())
                self._cond.notify_all()
        with self._cond:
            self._eof = True
            self._cond.notify_all()

    def wait_for(self, pattern: str, timeout_s: float):
        """The match of the first output line matching ``pattern`` (its
        arrival in ``matched_at``); raises when the child ends first or the
        deadline passes."""
        import re

        rx = re.compile(pattern)
        deadline = time.monotonic() + timeout_s
        seen = 0
        with self._cond:
            while True:
                for i in range(seen, len(self.lines)):
                    m = rx.search(self.lines[i])
                    if m:
                        self.matched_at = self.stamps[i]
                        return m
                seen = len(self.lines)
                left = deadline - time.monotonic()
                if self._eof or left <= 0:
                    raise AssertionError(
                        f"{' '.join(self.argv[:4])}: no line matching "
                        f"{pattern!r} ({'exited' if self._eof else 'timed out'}"
                        f"):\n" + "\n".join(self.lines[-40:]))
                self._cond.wait(min(left, 1.0))

    def stop(self, timeout_s: float = 120.0) -> int:
        """SIGTERM, then the exit code once its output is read."""
        import signal

        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=timeout_s)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        self._reader.join(timeout=30.0)
        return rc

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def http_get(base: str, path: str, payload=None, timeout_s: float = 120.0):
    """(status, body bytes) of a GET, or a POST of ``payload`` as JSON."""
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return resp.status, resp.read()


def worker_stats(url: str, model: str) -> dict:
    """One serving worker's dispatches (its ``/stats`` histogram) and
    requests; no recompiles."""
    _, body = http_get(url, "/stats")
    st = json.loads(body)[model]
    dispatches = sum(v for k, v in st.items() if k.startswith("bucket."))
    if st["batches"] != dispatches or st.get("recompiles", 0):
        raise AssertionError(f"worker {url} stats {st}")
    return {"dispatches": dispatches, "requests": st["requests"]}


def held_launches(counts_file: str, kid, stats: dict, most_rows: int,
                  dev: str) -> dict:
    """A stopped ``--serve-worker``'s launch counts, read back from its
    file and held to phase 12c's reckoning: on the card ``kid`` (B5, B6 or
    None) launched once per warmed bucket and once per dispatch, and no
    other kernel ran; on the CPU nothing launched.  The dispatches lie
    between one a request and ``requests / most_rows``, the most rows
    one batch could hold: the clients' concurrency, or the top bucket."""
    import math

    with open(counts_file) as fh:
        rec = json.load(fh)
    d, n = stats["dispatches"], stats["requests"]
    want = only(**({kid: SERVE_WARMED + d} if kid and dev == "cuda"
                    else {}))
    if rec["rc"] != 0 or rec["launches"] != want or \
            not math.ceil(n / most_rows) <= d <= n:
        raise AssertionError(f"{counts_file}: launches {rec}, want {want}; "
                             f"{d} dispatches for {n} requests at most "
                             f"{most_rows} rows a batch")
    return {"launches": rec["launches"][kid] if kid else 0, **stats}


def scored_rids(journal: str) -> dict:
    """Router rid (``g<n>.a<k>``) → its closed ``serve.request`` spans."""
    from avenir_tpu_torch.telemetry.journal import read_events

    out = {}
    for e in read_events(journal):
        if e.get("ev") == "span.close" and e.get("name") == "serve.request":
            rid = (e.get("attrs") or {}).get("rid") or ""
            if rid.startswith("g"):
                out[rid] = out.get(rid, 0) + 1
    return out


def start_serve_fleet(work: str, name: str, props: dict, model: str,
                      dev: str) -> Child:
    """``python -m avenir_tpu_torch.launch --serve --nprocs 2 --http-port 0``
    over one traced serving conf (its workers on the entry's default,
    ``cuda``, unless ``dev`` is the CPU), each worker the serving CLI
    inside ``chip_smoke.py --serve-worker``, which counts its launches
    into ``<work>/counts_<name>/w<k>.json``."""
    conf = write_props(os.path.join(work, f"fleet_{name}.properties"), {
        **props, "serve.models": model,
        "serve.request.timeout.ms": "60000", "trace.on": "true",
        "trace.journal.dir": os.path.join(work, f"fleet_tel_{name}"),
        "trace.run.id": f"serve-{name}",
        "fleet.pool.client.threads": str(ROUTER_THREADS)})
    return Child([sys.executable, "-m", "avenir_tpu_torch.launch", "--serve",
                  "--conf", conf, "--nprocs", str(FLEET_PROCS),
                  "--http-port", "0", *device_flag(dev), "--",
                  *serve_worker_argv(os.path.join(work, f"counts_{name}"))],
                 env={**os.environ, "PYTHONPATH": HERE})


def drive_serve_fleet(child: Child, work: str, name: str, model: str,
                      rows: list, want: list, t_start: float,
                      dev: str) -> dict:
    """Phase 18 (a) on one fleet: POST the rows to the router (answers =
    ``want``), ``/healthz`` aggregating both workers, ``/metrics`` under
    ``worker="router"``, the workers' ``/stats`` requests summing to the
    rows; then SIGTERM: every router rid scored exactly once in the
    merged journal, the router's stats printed, and each worker's own
    launch counts held to its ``/stats`` dispatches (at most
    ROUTER_THREADS rows a batch: the router's POSTs are single rows)."""
    m = child.wait_for(r"GlobalServe fronting (\d+) worker\(s\) .* on "
                       r"http://([^\s:]+):(\d+)", 600.0)
    up_s = child.matched_at - t_start
    base = f"http://{m.group(2)}:{m.group(3)}"
    t0 = time.perf_counter()
    status, body = http_get(base, "/score", {"model": model, "rows": rows})
    score_s = time.perf_counter() - t0
    if status != 200 or json.loads(body)["results"] != want:
        raise AssertionError(f"fleet {name}: the router's answers differ "
                             f"from phase 12c's")
    status, body = http_get(base, "/healthz")
    health = json.loads(body)
    if status != 200 or not health["ready"] or \
            [(r["worker"], r["ready"]) for r in health["workers"]] != \
            [(f"w{k}", True) for k in range(FLEET_PROCS)]:
        raise AssertionError(f"fleet {name}: /healthz {health}")
    status, body = http_get(base, "/metrics")
    if status != 200 or b'worker="router"' not in body:
        raise AssertionError(f"fleet {name}: /metrics {status}")
    served = {r["worker"]: worker_stats(r["url"], model)
              for r in health["workers"]}
    if sum(st["requests"] for st in served.values()) != len(rows):
        raise AssertionError(f"fleet {name}: the workers' requests {served} "
                             f"do not sum to the {len(rows)} rows")
    t0 = time.perf_counter()
    rc = child.stop()
    stop_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"fleet {name} exited {rc}:\n" +
                             "\n".join(child.lines[-40:]))
    kid = {"knn": "B5", "knn10k": "B6"}[name]
    workers = {w: held_launches(os.path.join(work, f"counts_{name}",
                                             f"{w}.json"),
                                kid, st, ROUTER_THREADS, dev)
               for w, st in served.items()}
    merged = child.wait_for(r"^\[fleet\] merged journal: (\S+)$", 1.0)
    stats = json.loads([ln for ln in child.lines if ln.startswith("{")][-1])
    scored = scored_rids(merged.group(1))
    bases = {rid.rsplit(".a", 1)[0] for rid in scored}
    if set(scored.values()) != {1} or \
            bases != {f"g{i}" for i in range(1, len(rows) + 1)} or \
            stats[model]["requests"] != len(rows):
        raise AssertionError(f"fleet {name}: journal {len(scored)} spans "
                             f"over {len(bases)} rids, stats {stats}")
    log(f"serve fleet (a) {name}: launch --serve up in {up_s:.2f} s, "
        f"{len(rows)} rows through the router in {score_s:.3f} s equal to "
        f"phase 12c's, /healthz {len(health['workers'])} workers ready, "
        f"/metrics worker=\"router\", one serve.request span per router rid, "
        f"stopped in {stop_s:.2f} s; each worker's own {kid} count = "
        f"{SERVE_WARMED} warmed + its dispatches: {json.dumps(workers)}")
    log(json.dumps({"serve_fleet_router_stats": {name: stats}}))
    return {"workers": workers, "walls": {"up_s": up_s, "score_s": score_s,
                                          "stop_s": stop_s},
            "stats": stats}


def failover_and_swap(work: str, schema: str, rows: list, want: list,
                      nb2: str, want2: list, dev: str) -> dict:
    """Phase 18 (b) and (c): an in-process ``GlobalRouter`` over the
    port's ``WorkerSpawner`` (NB and the tree from phase 12c's conf, two
    workers, ``fleet.pool.autoscale.on`` with min 2): ``w0`` SIGKILLed
    once a quarter of the stream is answered; every answer = ``want``,
    none lost or doubled, the replacement spawned and serving; then
    ``POST /swap`` of NB to ``nb2`` through the router's front end: each
    live worker at version 2, ready capacity at the floor or above, and
    both answering ``want2``."""
    import signal

    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.serving import ScoreHTTPServer
    from avenir_tpu_torch.serving.global_pool import (GlobalRouter,
                                                      WorkerClient,
                                                      WorkerSpawner)
    from avenir_tpu_torch.telemetry import spans as tel
    from avenir_tpu_torch.telemetry.journal import read_events

    families = serve_families(work, schema)
    props = {**families["naiveBayes"][0], **families["tree"][0],
             "serve.models": "naiveBayes,tree",
             "serve.request.timeout.ms": "60000",
             "fleet.pool.autoscale.on": "true",
             "fleet.pool.autoscale.min": "2",
             "fleet.pool.autoscale.interval.sec": "0.5",
             "fleet.pool.monitor.interval.ms": "100",
             "fleet.pool.failover.retries": "2",
             "fleet.pool.swap.floor": "1"}
    conf = write_props(os.path.join(work, "fleet_failover.properties"),
                       props)
    journal_dir = tempfile.mkdtemp(prefix="failover_", dir=work)
    tel.tracer().enable(journal_dir)
    spawner = WorkerSpawner(conf, "serve-failover", echo=False,
                            device="cpu" if dev == "cpu" else None,
                            env={**os.environ, "PYTHONPATH": HERE})
    walls = {}
    t0 = time.perf_counter()
    workers = [spawner.spawn() for _ in range(FLEET_PROCS)]
    walls["spawn 2 workers"] = time.perf_counter() - t0
    router = GlobalRouter.from_conf(JobConfig(props), workers=workers,
                                    spawner=spawner.spawn)
    try:
        t0 = time.perf_counter()
        reqs = [router.submit_nowait("naiveBayes", ln) for ln in rows]
        deadline = time.monotonic() + 300.0
        while sum(r.result is not None for r in reqs) < len(rows) // 4:
            if time.monotonic() > deadline:
                raise AssertionError("failover: the stream stalled")
            time.sleep(0.005)
        os.kill(workers[0].proc.pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        got = [r.wait(120.0) for r in reqs]
        walls["stream with w0 killed"] = time.perf_counter() - t0
        if got != want:
            raise AssertionError("failover: answers differ from phase 12c's")
        deadline = time.monotonic() + 300.0
        while time.monotonic() < deadline:
            fleet = router.stats()["fleet"]
            if fleet.get("workers.spawned") == 1 and fleet["ready"] == 2:
                break
            time.sleep(0.1)
        walls["kill to replacement ready"] = time.perf_counter() - t_kill
        stats = router.stats()
        fleet = stats["fleet"]
        if fleet.get("workers.spawned") != 1 or fleet["ready"] != 2 or \
                fleet.get("workers.lost") != 1 or \
                fleet.get("failovers", 0) < 1 or \
                stats["naiveBayes"]["requests"] != len(rows):
            raise AssertionError(f"failover: router stats {stats}")
        rows_by = {r["worker"]: r for r in router.health()["workers"]}
        if sorted(rows_by) != ["w0", "w1", "w2"] or rows_by["w0"]["alive"]:
            raise AssertionError(f"failover: fleet {rows_by}")
        clients = {w: WorkerClient(*rows_by[w]["url"][7:].split(":"), name=w)
                   for w in ("w1", "w2")}
        if clients["w2"].score("naiveBayes", rows[:64]) != want[:64]:
            raise AssertionError("failover: the replacement's answers differ")
        log(f"serve fleet (b): w0 SIGKILLed after {len(rows) // 4} of "
            f"{len(rows)} answers; all {len(rows)} byte-identical to phase "
            f"12c's in {walls['stream with w0 killed']:.3f} s, "
            f"{fleet['failovers']} failed over, requests "
            f"{stats['naiveBayes']['requests']} (none lost or doubled); w2 "
            f"spawned and ready {walls['kill to replacement ready']:.2f} s "
            f"after the kill and answering")

        # (c) the rolling swap through the router's front end
        t0 = time.perf_counter()
        with ScoreHTTPServer(router) as front:
            status, body = http_get(
                "http://%s:%d" % front.address, "/swap",
                {"model": "naiveBayes",
                 "props": {"feature.schema.file.path": schema,
                           "bayesian.model.file.path": nb2}})
        walls["rolling swap"] = time.perf_counter() - t0
        swap = json.loads(body)
        if status != 200 or swap["versions"] != {"w1": 2, "w2": 2} or \
                swap["min_ready"] < swap["floor"]:
            raise AssertionError(f"swap: {status} {swap}")
        for w, client in clients.items():
            if client.score("naiveBayes", rows[:256]) != want2[:256]:
                raise AssertionError(f"swap: {w} does not answer as the "
                                     f"new artifact's one-process plane")
        log(f"serve fleet (c): POST /swap to the router rolled NB to a second "
            f"artifact in {walls['rolling swap']:.2f} s: versions "
            f"{swap['versions']}, min_ready {swap['min_ready']} >= floor "
            f"{swap['floor']}; w1 and w2 answer as the new plane")
        stats = router.stats()
    finally:
        router.close(retire_workers=True)
        tel.tracer().disable()
    events = [e for name in os.listdir(journal_dir)
              for e in read_events(os.path.join(journal_dir, name))]
    scales = [(e["direction"], e["reason"]) for e in events
              if e["ev"] == "fleet.pool.scale"]
    ups = [(e["worker"], e["reason"]) for e in events
           if e["ev"] == "fleet.pool.worker.up"]
    downs = [(e["worker"], e["reason"]) for e in events
             if e["ev"] == "fleet.pool.worker.down"]
    swaps = [e["worker"] for e in events if e["ev"] == "fleet.pool.swap"]
    if scales != [("up", "replace")] or ("w2", "replace") not in ups or \
            ("w0", "died") not in downs or swaps != ["w1", "w2"]:
        raise AssertionError(f"failover journal: scale {scales}, up {ups}, "
                             f"down {downs}, swaps {swaps}")
    log(json.dumps({"serve_fleet_router_stats": {"failover": stats}}))
    return walls


def fake_redis():
    """A threaded RESP server on 127.0.0.1, port 0, with the list commands
    the RL loop and the scoring front end use (there is no Redis here)."""
    import socketserver
    import threading
    from collections import defaultdict, deque

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            buf = b""
            while True:
                try:
                    chunk = self.request.recv(65536)
                except OSError:
                    return
                if not chunk:
                    return
                buf += chunk
                while True:
                    args, buf = self._parse(buf)
                    if args is None:
                        break
                    self.request.sendall(self._execute(args))

        @staticmethod
        def _parse(buf):
            if not buf.startswith(b"*") or b"\r\n" not in buf:
                return None, buf
            head, rest = buf.split(b"\r\n", 1)
            args = []
            for _ in range(int(head[1:])):
                if not rest.startswith(b"$") or b"\r\n" not in rest:
                    return None, buf
                lh, rest2 = rest.split(b"\r\n", 1)
                n = int(lh[1:])
                if len(rest2) < n + 2:
                    return None, buf
                args.append(rest2[:n].decode())
                rest = rest2[n + 2:]
            return args, rest

        def _execute(self, args):
            lists = self.server.lists
            bulk = lambda v: b"$%d\r\n%s\r\n" % (len(v.encode()),  # noqa
                                                 v.encode())
            with self.server.lock:
                cmd = args[0].upper()
                if cmd == "PING":
                    return b"+PONG\r\n"
                if cmd == "SELECT":
                    return b"+OK\r\n"
                if cmd == "LPUSH":
                    lists[args[1]].appendleft(args[2])
                    return b":%d\r\n" % len(lists[args[1]])
                if cmd == "RPOP":
                    q = lists.get(args[1])
                    if len(args) == 3:
                        if not q:
                            return b"*-1\r\n"
                        vals = [q.pop() for _ in range(min(int(args[2]),
                                                           len(q)))]
                        return b"*%d\r\n" % len(vals) + b"".join(
                            bulk(v) for v in vals)
                    return bulk(q.pop()) if q else b"$-1\r\n"
                if cmd == "LLEN":
                    return b":%d\r\n" % len(lists.get(args[1], ()))
                if cmd == "DEL":
                    return b":%d\r\n" % int(lists.pop(args[1], None)
                                            is not None)
                return b"-ERR unknown command '%s'\r\n" % cmd.encode()

    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), Handler)
    srv.daemon_threads = True
    srv.lists = defaultdict(deque)
    srv.lock = threading.Lock()
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def lead_gen_loop(transport: str, address) -> tuple:
    """The lead-gen closed loop (intervalEstimator, seeded rewards) over
    the three ``Redis*`` transports or ``InProcQueue``s: (actions, the
    learner's checkpoint)."""
    import numpy as np

    from avenir_tpu_torch.models import online_rl as orl
    from avenir_tpu_torch.pipeline import resp
    from avenir_tpu_torch.pipeline import streaming as st

    ctr = {"page1": (30, 12), "page2": (60, 30), "page3": (80, 10)}
    rng = np.random.default_rng(7)
    learner = orl.create_learner("intervalEstimator", list(ctr),
                                 {"min.reward.distr.sample": 15}, seed=3)
    names = ("eventQueue", "actionQueue", "rewardQueue")
    if transport == "redis":
        host, port = address
        server = st.ReinforcementLearnerServer(
            learner, st.RedisEventSource(host, port, queue=names[0]),
            st.RedisRewardReader(host, port, queue=names[2]),
            st.RedisActionWriter(host, port, queue=names[1]))
        sim = {q: resp.RedisListQueue(q, host=host, port=port) for q in names}
    else:
        sim = {q: st.InProcQueue() for q in names}
        server = st.ReinforcementLearnerServer(
            learner, st.QueueEventSource(sim[names[0]]),
            st.QueueRewardReader(sim[names[2]]),
            st.QueueActionWriter(sim[names[1]]))
    actions = []
    for n in range(1, LEAD_GEN_ROUNDS + 1):
        sim["eventQueue"].push(f"ev{n},{n}")
        if not server.process_one():
            raise AssertionError(f"lead-gen over {transport}: no event {n}")
        msg = sim["actionQueue"].pop()
        actions.append(msg)
        page = msg.split(",")[1]
        sim["rewardQueue"].push(f"{page},{max(rng.normal(*ctr[page]), 0.0)}")
    return actions, server.checkpoint()


def resp_drill(work: str, schema: str, replays: dict, dev: str) -> dict:
    """Phase 18 (d): the fake RESP server in this process; one serving CLI
    worker for NB and one for ``knn10k`` (B6), each with
    ``serve.request.queue`` and the server's bound port (and each inside
    ``chip_smoke.py --serve-worker``), answer LPUSHed rows as phase 12c's
    replays, each worker's ``/stats`` requests equal to the rows and its
    own launch counts to its dispatches (the front end drains the list
    at once, so up to the top bucket a batch); then the lead-gen loop
    over the three ``Redis*`` transports equals the loop over
    ``InProcQueue``s."""
    from avenir_tpu_torch.jobs.base import read_lines
    from avenir_tpu_torch.pipeline.resp import RedisListQueue

    families = serve_families(work, schema)
    srv = fake_redis()
    host, port = srv.server_address
    walls, children = {}, {}
    try:
        t0 = time.perf_counter()
        for name, model in (("naiveBayes", "naiveBayes"), ("knn10k", "knn")):
            conf = write_props(os.path.join(work, f"resp_{name}.properties"),
                               {**families[name][0], "serve.models": model,
                                "serve.request.timeout.ms": "60000",
                                # the front end drains the whole list
                                # into the queue at once
                                "serve.queue.depth": "4096"})
            children[name] = Child(
                [sys.executable, *serve_worker_argv(
                    os.path.join(work, f"counts_resp_{name}")),
                 "--conf", conf, "--http-port", "0",
                 "-D", f"serve.request.queue={name}Req",
                 "-D", f"serve.response.queue={name}Resp",
                 "-D", f"serve.redis.host={host}",
                 "-D", f"serve.redis.port={port}", *device_flag(dev)],
                env={**os.environ, "PYTHONPATH": HERE})
        urls = {}
        for name, child in children.items():
            m = child.wait_for(r"^serving .* on (http://[^\s:]+:\d+) ", 600.0)
            child.wait_for(f"^RESP transport polling '{name}Req'$", 60.0)
            urls[name] = m.group(1)
        walls["two RESP workers up"] = time.perf_counter() - t0
        got = {}
        for name, model in (("naiveBayes", "naiveBayes"), ("knn10k", "knn")):
            want = replays[name]
            requests = RedisListQueue(f"{name}Req", host=host, port=port)
            responses = RedisListQueue(f"{name}Resp", host=host, port=port)
            t0 = time.perf_counter()
            for i, row in enumerate(read_lines(families[name][1])):
                requests.push(f"r{i},{model},{row}")
            out = []
            deadline = time.monotonic() + 300.0
            while len(out) < len(want) and time.monotonic() < deadline:
                out += responses.drain()
                time.sleep(0.002)
            walls[f"RESP {name} {len(want)} rows"] = time.perf_counter() - t0
            answers = dict(msg.split(",", 1) for msg in out)
            if len(out) != len(want) or \
                    [answers.get(f"r{i}") for i in range(len(want))] != want:
                raise AssertionError(f"RESP {name}: {len(out)} responses, "
                                     f"not phase 12c's replay")
            got[name] = len(out)
        served = {name: worker_stats(urls[name], model)
                  for name, model in (("naiveBayes", "naiveBayes"),
                                      ("knn10k", "knn"))}
        for name, child in children.items():
            if child.stop() != 0:
                raise AssertionError(f"RESP worker {name}:\n" +
                                     "\n".join(child.lines[-40:]))
            if served[name]["requests"] != got[name]:
                raise AssertionError(f"RESP worker {name}: {served[name]} "
                                     f"for {got[name]} rows")
        launched = {name: held_launches(
            os.path.join(work, f"counts_resp_{name}", "worker.json"),
            {"knn10k": "B6"}.get(name), served[name], SERVE_MAX_BUCKET, dev)
            for name in children}
        t0 = time.perf_counter()
        over_redis = lead_gen_loop("redis", (host, port))
        walls["lead-gen over Redis"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        in_proc = lead_gen_loop("inproc", None)
        walls["lead-gen over InProcQueue"] = time.perf_counter() - t0
    finally:
        for child in children.values():
            child.kill()
        srv.shutdown()
        srv.server_close()
    if over_redis != in_proc:
        raise AssertionError("lead-gen: the Redis transports' actions differ "
                             "from the in-process queues'")
    late = [a.split(",")[1] for a in in_proc[0][LEAD_GEN_ROUNDS // 2:]]
    if max(set(late), key=late.count) != "page3":
        raise AssertionError("lead-gen: the learner did not converge")
    log(f"serve fleet (d): RESP on 127.0.0.1:{port} (this process): "
        f"{got['naiveBayes']} NB and {got['knn10k']} knn10k rows LPUSHed to "
        f"two serving CLI workers, answers = phase 12c's replays; each "
        f"worker's own counts = {SERVE_WARMED} warmed + its dispatches "
        f"{json.dumps(launched)}; the lead-gen loop over the three Redis* "
        f"transports = over InProcQueues ({LEAD_GEN_ROUNDS} actions, "
        f"converged on page3)")
    return {"walls": walls, "b6": launched["knn10k"]}


def process_fleet_drill(dev: str) -> dict:
    """Phase 18 (e): ``ProcessServingFleet`` (2 forked workers) against
    ``ShardedServingFleet`` on the same learners, on the host.  This
    process holds a CUDA context, so torch marks each forked worker as a
    bad fork where any CUDA call raises; every factory call checks that
    mark, and a worker that touched CUDA would fail ``close()``."""
    import torch

    from avenir_tpu_torch.models import online_rl as orl
    from avenir_tpu_torch.pipeline import streaming as st

    on_cuda = dev == "cuda"
    if on_cuda and not torch.cuda.is_initialized():
        raise AssertionError("phase 18 (e) expects this process's CUDA "
                             "context")
    groups = [f"g{k}" for k in range(8)]

    def factory(forked):
        def make(group):
            if torch.cuda._is_in_bad_fork() != forked:
                raise RuntimeError(f"worker for {group}: bad-fork mark "
                                   f"{torch.cuda._is_in_bad_fork()}")
            learner = orl.create_learner(
                "sampsonSampler", ["p1", "p2", "p3"], {"min.sample": 8},
                seed=11)
            srv = st.ReinforcementLearnerServer(
                learner, st.QueueEventSource(st.InProcQueue()),
                st.QueueRewardReader(st.InProcQueue()),
                st.QueueActionWriter(st.InProcQueue()))
            inner, streams[group] = srv.actions, []

            class Tee:
                def write(self, event_id, acts):
                    inner.write(event_id, acts)
                    streams[group].append((event_id, list(acts)))
                    srv.rewards.queue.push(
                        f"{acts[0]},{10.0 * int(acts[0][1:])}")

            srv.actions = Tee()
            return srv
        return make

    out = {}
    for kind, cls in (("threads", st.ShardedServingFleet),
                      ("processes", st.ProcessServingFleet)):
        streams = {}
        t0 = time.perf_counter()
        fleet = cls(factory(on_cuda and kind == "processes"), num_workers=2,
                    max_pending=64)
        for n in range(1, 201):
            for g in groups:
                fleet.dispatch(g, f"ev{g}{n}", n)
        fleet.close()
        wall = time.perf_counter() - t0
        if kind == "processes":
            streams = {g: [] for g in groups}
            for g, event_id, acts in fleet.actions():
                streams[g].append((event_id, acts))
        out[kind] = (streams, fleet.checkpoints(), wall)
    if out["threads"][:2] != out["processes"][:2]:
        raise AssertionError("ProcessServingFleet differs from "
                             "ShardedServingFleet")
    log(f"serve fleet (e): ProcessServingFleet (2 forked workers, each a bad "
        f"fork of this CUDA process that never touched CUDA) = "
        f"ShardedServingFleet: {len(groups)} groups x 200 events, actions and "
        f"checkpoints equal; {out['processes'][2]:.2f} s against "
        f"{out['threads'][2]:.2f} s")
    return {"process fleet": out["processes"][2],
            "thread fleet": out["threads"][2]}


def device_flag(dev: str) -> list:
    """A child entry's device flag: none on the card (the entry's own
    default), ``--device cpu`` for a CPU rehearsal."""
    return ["--device", "cpu"] if dev == "cpu" else []


def serve_fleet_phase(work: str, test: str, schema: str, walls: dict,
                      dev: str = "cuda") -> dict:
    """Phase 18: the serving fleet on the card, over phase 12c's models and
    rows; returns B5's and B6's launches by path (each fleet worker's).

    A serving conf holds one schema, so each drill serves one family
    group: (a) two ``launch --serve`` fleets side by side, ``knn`` over
    phase 8a's 1M references (B5) and ``knn10k`` over 8b's 10K (B6);
    (b) and (c) NB and the tree behind an in-process router; (d) NB and
    ``knn10k`` over RESP; (e) the process fleet on the host.  ``dev``
    "cpu" rehearses it on the CPU (the children get ``--device cpu``)."""
    from avenir_tpu_torch.jobs.base import read_lines

    t_phase = time.perf_counter()
    j = lambda *p: os.path.join(work, *p)  # noqa: E731
    families = serve_families(work, schema)
    replays = {name: read_lines(j(f"serve_{name}_replay"))
               for name in ("naiveBayes", "knn", "knn10k")}
    fleets = {}
    t0 = time.perf_counter()
    children = {name: start_serve_fleet(work, name, families[name][0], "knn",
                                        dev)
                for name in ("knn", "knn10k")}
    try:
        for name, child in children.items():
            fleets[name] = drive_serve_fleet(
                child, work, name, "knn", read_lines(families[name][1]),
                replays[name], t0, dev)
    finally:
        for child in children.values():
            child.kill()
    # (c)'s second NB artifact: NB trained on phase 3's test rows
    run_cli(["BayesianDistribution", f"-Dfeature.schema.file.path={schema}",
             test, j("fleet_nb_v2"), "--device", dev])
    run_cli(["BayesianPredictor", f"-Dfeature.schema.file.path={schema}",
             f"-Dbayesian.model.file.path={j('fleet_nb_v2')}",
             j("serve_hosp.csv"), j("fleet_nb_v2_pred"), "--device", dev])
    rows = read_lines(j("serve_hosp.csv"))[:FAILOVER_ROWS]
    swap_walls = failover_and_swap(work, schema, rows,
                                   replays["naiveBayes"][:FAILOVER_ROWS],
                                   j("fleet_nb_v2"),
                                   read_lines(j("fleet_nb_v2_pred")), dev)
    resp = resp_drill(work, schema, replays, dev)
    proc = process_fleet_drill(dev)
    report = {
        "card": card_line(),
        "launch_serve": {name: {**f["walls"], "workers": f["workers"]}
                         for name, f in fleets.items()},
        "failover_and_swap_s": swap_walls, "resp_s": resp["walls"],
        "process_fleet_s": proc,
        "phase_s": time.perf_counter() - t_phase}
    walls.update({f"phase 18 {k}": v for k, v in swap_walls.items()})
    walls.update({f"phase 18 {k}": v for k, v in resp["walls"].items()})
    for name, f in fleets.items():
        walls.update({f"phase 18 fleet {name} {k}": v
                      for k, v in f["walls"].items()})
    log(json.dumps({"serve_fleet": report}))
    by_path = lambda name: {  # noqa: E731
        f"serve_fleet_{w}": rec["launches"]
        for w, rec in fleets[name]["workers"].items()}
    return {"B5": by_path("knn"),
            "B6": {**by_path("knn10k"), "serve_resp": resp["b6"]["launches"]}}


def kernel_entry(kid, name, source, replaces, launches_by_path, cases):
    """The kernels-line entry: numbers from the main path's own case."""
    path, which = MAIN_PATH[kid]
    mine = [c for c in cases if c["kernel"] == kid]
    main = [c for c in mine if c.get("path") == path and "ms" in c]
    main = main[0] if which == "first" else main[-1]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches_by_path[path],
        "launches_by_path": launches_by_path,
        "case": main["case"],
        "max_abs_err": max(c["max_abs_err"] for c in mine),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        **({"dense_ops_bound_ms": main["dense_ops_bound_ms"]}
           if "dense_ops_bound_ms" in main else {}),
    }


def main(argv=None) -> int:
    import argparse

    import torch

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--serve-worker"]:    # the serving CLI's own arguments
        return serve_worker(argv[1], argv[2:])   # follow the counts' dir
    ap = argparse.ArgumentParser(description="Chip smoke test of the port.")
    ap.add_argument("--b4", action="store_true",
                    help="time B4 (csrc/cross.cu) alone: phase 2's B4 cases, "
                         "the hospital tree's levels, a 1-row call")
    ap.add_argument("--fleet-worker", metavar="SPEC",
                    help="run as one rank of a phase-17 fleet (started by "
                         "python -m avenir_tpu_torch.launch)")
    args = ap.parse_args(argv)
    if args.fleet_worker:                 # its tasks name their device
        return fleet_worker(args.fleet_worker)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.b4:
        return cross_main()
    from concurrent.futures import ThreadPoolExecutor

    from avenir_tpu_torch.ops import _build, hist
    from avenir_tpu_torch.runtime import native

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    def build(name):
        t0 = time.perf_counter()
        lib = native.build() if name == "native" else _build.build(name)
        return name, lib, time.perf_counter() - t0

    walls = {}
    with ThreadPoolExecutor(len(KERNEL_SOURCES) + 1) as pool:
        for name, lib, secs in pool.map(build, (*KERNEL_SOURCES, "native")):
            log(f"build: {name} in {secs:.2f} s")
            if name == "native":
                walls["native encoder build"] = secs
                continue
            with open(lib[:-3] + ".log") as fh:
                log(fh.read())

    cases = kernel_cases(hist)
    cls_cases = per_class_cases(hist)
    x_cases = cross_cases(hist)
    rec = Recorder()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        b1_mi, train, test, schema = jobs_phase(hist, rec, work, walls)
        b2_mi = mi_wide_phase(hist, rec)
        b4_tree = tree_jobs_phase(hist, rec, work, train, test, schema, walls)
        wide = wide_tree_phase(hist, rec)
        b1_pipe = pipeline_phase(rec, work, train, schema, walls)
        traced = telemetry_phase(work, train, schema, b4_tree, walls)
        b1_plan = planner_phase(rec, work, train, test, schema, walls)
        b1_corr = correlation_phase(rec, work, train, schema, walls)
        b4_forest = families_phase(rec, work, train, schema, walls)
        bandit_text_phase(work, train, schema, walls)
        all_cases = cases + cls_cases + x_cases + path_cases(hist, rec)
        rec.calls.clear()
        all_cases += knn_cases()
        used = {}
        b5 = knn_job_phase(rec, work, used, walls)
        b6 = knn_small_phase(rec, work, used, walls)
        b5.update(knn_qps_phase(rec, used))
        served = serving_phase(rec, work, test, schema, used, walls)
        b5["serve_knn_1m"] = served["serve_knn_1m"]
        b6["serve_knn_10k"] = served["serve_knn_10k"]
        streamed = stream_tenancy_phase(rec, work, train, schema, used,
                                        walls)
        t0 = time.perf_counter()
        sharded = shard_phase(rec, work, train, schema, walls)
        walls["phase 14"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        auto = automesh_phase(work, train, schema, walls)
        walls["phase 15"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mm = model_mesh_phase(work, train, schema, walls)
        walls["phase 16"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fleet = fleet_phase(work, train, schema, walls)
        walls["phase 17"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        served_fleet = serve_fleet_phase(work, test, schema, walls)
        walls["phase 18"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    all_cases += path_cases(hist, rec)       # phase 13's and 14's calls
    all_cases += knn_path_cases(rec, used)
    probes = probe_phase()

    src = "avenir_tpu_torch/csrc/"
    at = "avenir_tpu/ops/pallas_hist.py:"
    forest = [c for c in all_cases if c["kernel"] == "B4"
              and c.get("path") == "forest" and "ms" in c][-1]
    kernels = [
        kernel_entry("B1", "cooc_pair_gram, fmaj/jmaj (B1)",
                     src + "cooc_pair.cu", at + "283",
                     {"mi": b1_mi, "wide_tree": wide["B1"], **b1_pipe,
                      "pipeline_traced": traced["pipeline_traced"],
                      "pipeline_xla": traced["pipeline_xla"], **b1_corr,
                      **b1_plan, **streamed["B1"], **sharded, **auto["B1"],
                      **fleet["B1"]},
                     all_cases),
        kernel_entry("B2", "cooc_pair_gram, cls (B2)", src + "cooc_pair.cu",
                     at + "333", {"mi_wide": b2_mi, "wide_tree": wide["B2"],
                                  **fleet["B2"]},
                     all_cases),
        kernel_entry("B3", "cooc_pair_gram, clsb (B3)", src + "cooc_pair.cu",
                     at + "365", {"wide_tree": wide["B3"]}, all_cases),
        kernel_entry("B4", "cross_counts (B4)", src + "cross.cu", at + "484",
                     {**b4_tree, "tree_traced": traced["tree_traced"],
                      "forest": b4_forest, **streamed["B4"], **auto["B4"]},
                     all_cases),
        kernel_entry("B5", "knn_tourney (B5)", src + "knn_tourney.cu",
                     "avenir_tpu/ops/pallas_knn.py:290",
                     {**b5, **streamed["B5"], **mm.get("B5", {}),
                      **served_fleet["B5"]},
                     all_cases),
        kernel_entry("B6", "knn_topk (B6)", src + "knn_topk.cu",
                     "avenir_tpu/ops/pallas_knn.py:73",
                     {**b6, **mm.get("B6", {}), **served_fleet["B6"]},
                     all_cases),
        *probes,
    ]
    # phase 13 (c): B1 at every pane bucket of the stream, warm panes
    # (all ballast) and the ragged tail's bucket included
    kernels[0]["stream_buckets"] = [
        {k: c[k] for k in ("n", "n_eff", "max_abs_err", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms")}
        for c in all_cases
        if c["kernel"] == "B1" and c.get("path") == "stream" and "ms" in c]
    kernels[3]["forest"] = {"launches": b4_forest, **{
        k: forest[k] for k in ("case", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")}}
    log(json.dumps({"walls_s": walls, "card": card}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
