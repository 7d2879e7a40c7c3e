#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``predictionio_torch``) on one card.

    python3 chip_smoke.py

The quickest proof that the port starts on the GPU. It imports numpy,
torch and ``predictionio_torch`` only (no JAX, nothing of
``predictionio_tpu``), needs one CUDA card, and fails loudly: no phase
catches its own failure, and without CUDA or without the package it
exits non-zero before printing any result.

1. Build every kernel under ``predictionio_torch/ops/kernels/csrc/``
   with ``nvcc`` for sm_90a, one process per source, all started
   together. Meanwhile phase 13's (b) and (c), which launch no kernel,
   run, and the ALS phase's ratings and phase 12's cut of them are
   made.
2. Kernel phase: the ``topk_dot`` kernel against its plain version
   ``topk_dot_reference`` on the card, over I in {513, 26744, 66000},
   D in {32, 64, 128}, B in {1, 8, 64, 128}, k in {8, 16, 128},
   E in {1, 2, 4, 64} (2 and 4 are the serve path's item query with a
   blacklist and a bucketed user blacklist), plus duplicated item rows
   (exact ties), a whole tile of top candidates excluded, and two
   adversarial tables at three shapes each: rows whose scores rise
   along the table (every block's buffer fills and it sorts again and
   again) and every row identical (all ties: ids 0..k-1). Scores
   must agree within
   1e-5 * |q| * max|item| (the kernel sums in another order than
   cuBLAS), on slots scoring above -1e29. Indices must be equal, except
   where the reference itself has two scores within that tolerance (a
   near-tie the summation order may flip): there the kernel's item must
   score within the tolerance of the reference's slot. 60 calls
   alternating over the serve (B=1, I=26744, D=64, k=16, E=1), catalog
   (B=1, I=1M, D=128, k=16, E=1) and widest (B=128, I=66000, D=128,
   k=128, E=64) shapes must each give their shape's first bits (the
   kernel's ticket counters reset), and at each of the three the
   profiler must trace exactly one device kernel and no memset per
   call (the traced counts go on the ``kernels`` line as
   ``traced_per_call``). Then the kernel, the plain version and one library call
   (``torch.matmul`` + ``torch.topk``) are timed at the serve and the
   catalog shape: ``ms`` is device time per call from
   ``torch.profiler`` (the serve table warm in L2 as in serving; the
   512 MB catalog never fits), ``cold_ms`` the same with L2 flushed
   before each call (the case the HBM bound ``bound_ms`` describes),
   ``call_ms`` the CUDA-event time per call of back-to-back calls (the
   host's issue time when that is longer), ``cold_event_ms`` the median
   CUDA-event time of one call after a flush. ``ptxas``'s registers and
   spills of the kernel go on the ``kernels`` line.
3. Serve phase, the port's main path: seeded MovieLens-20M-shaped
   factors (138,493 users, 26,744 items, rank 64) become an ALS model
   via ``als_model_from_arrays``; a COMPLETED engine instance and its
   blob go into a temporary localfs store through the port's storage;
   the port's ``EngineServer`` deploys it on ``cuda`` (127.0.0.1, port
   0) and answers lone sequential queries (users with and without a
   blacklist, items, a whitelist, an unknown user) and a concurrent
   burst of 64 user queries (the micro-batch path), and a user query
   whose k is outside the kernel's caps (the scorer's device route,
   which on a card never moves to the host). Every answer is
   checked against a float64 host computation under the same order
   (score descending, item id ascending); the kernel's launch counter,
   reset just before the deploy, must have risen by at least the number
   of lone user and item queries.
3b. Observability phase, on phase 3's live deployment before it stops.
   First the operator plane, held against the queries phase 3 sent:
   ``GET /admin/data``'s ``unknown_ratio`` and ``queries_seen`` must be
   the unknown user/item references over all references of those
   queries; ``GET /admin/prof?endpoint=/queries.json`` must hold
   ``[handler]`` samples (more checked lone queries are sent until the
   25 Hz sampler has caught one) and ``pio_prof_overhead_ratio`` lie in
   (0, 1] once it has sampled (the clock it meters its passes on is
   reported: the thread CPU clock, or the wall clock where the thread
   clock steps in scheduler ticks); ``GET /admin/anomaly`` must answer 200 with the JAX keys and
   ``GET /admin/tail`` count at least one record a query; then ``cli
   metrics``, ``flight``, ``trace <a query's id>``, ``prof``,
   ``journal``, ``anomalies``, ``data``, ``mem`` and ``top --once`` run
   in process (``cli.main``) against the server, each with the JAX
   command's exit code (``anomalies``: 1 while the sentinel has an
   active anomaly). Then ``GET /readyz`` must be 200, not failed, its ``devices`` probe
   naming the card and its ``kernels`` probe ok; ``GET /metrics`` must
   parse, with ``pio_device_memory_bytes{device="0",kind=...}`` equal
   to ``torch.cuda.memory_stats()`` (allocated current and peak) and
   ``mem_get_info()`` (limit) read around the scrape; a ``POST
   /admin/profile?seconds=3`` window over a burst of 20 lone queries
   (the launch counter reset once the window is open) must count as
   many ``topk_dot`` kernels as the counter, and stay open past the
   burst; an ``IVFIndex`` over the served item factors, flat and int8,
   must reach recall@10 >= 0.95 against ``topk_dot``'s exact top-10 for
   256 seeded users (within the kernel's score tolerance); and a second
   in-process deploy with ``PIO_INDEX_BACKEND=ivf`` must answer the 20
   queries (recall >= 0.95 against float64) and show
   ``pio_index_recall{backend="ivf"}``. Phase 5 reads ``pio_train_mfu``
   right after its training and holds it, in (0, 1], to the analytic
   FLOPs over its own last-epoch step time at the card's bf16 peak. One
   ``{"obs": ...}`` line prints before ``phase_wall_sec``.
3c. Fleet phase, over phase 3's store while its server still runs: two
   replica processes of the port's ``cli deploy --replicas 1`` (built
   by ``deploy_fleet_argv``, so on the card) share ``cuda:0`` under a
   ``FleetSupervisor``, behind an in-process ``QueryRouter``. (a) Lone
   user and item queries through the router are checked against float64
   as in phase 3; both replicas must be named in ``X-PIO-Replica``, and
   the sum of the replicas' ``GET /`` ``topk_dot`` launch counts must
   rise by at least the number of queries routed. (b) The queries phase
   3's server captured (``PIO_FLIGHT_PAYLOADS``) are replayed with
   ``workflow/replay.py``, phase 3's server the reference and the router
   the candidate: top-10 overlap exactly 1.0, mean score delta within
   the kernel's tolerance. Then the federation at the router:
   ``/admin/fleet/metrics``' merged ``pio_http_requests_total`` of
   ``/queries.json`` must equal the sum of the replicas' own
   ``/metrics``; ``/admin/fleet/{tail,prof,journal,anomaly,data}``
   answer 200 with both replicas and neither degraded; a routed query's
   ``/admin/trace`` holds router and replica spans in one tree with no
   placeholder; and the script's ``PIO_PUSH_URL`` sink (the replicas
   push every second) must have received a replica's OpenMetrics
   document. (c) A second COMPLETED instance from other
   seeded factors goes into the store; ``GET /reload`` on the router
   answers 202, the rolling swap ends ``ok`` with every replica on the
   second instance, and none of the queries a thread sends through the
   swap fails (each answer is the first instance's or the second's).
   (d) ``POST /admin/chaos`` on replica r1 sets
   ``batcher@r1:hang``: its attempts time out at the router
   (``PIO_ROUTER_TIMEOUT``), which opens r1's breaker, while hedges
   answer every query 200 from r0; no query is placed on r1 once the
   breaker is open, and it closes again after the rule is cleared. (A
   ``batcher`` error rule would make r1 answer 500, which the router
   passes through as the replica's answer, as the JAX router does: only
   a transport failure charges a replica's breaker.) (e) The replicas
   run with ``PIO_SHED_QUEUE_DEPTH=1``: a concurrent burst of 128
   queries, while a ``batcher:latency:50ms`` rule slows every dispatch,
   gets 429s with ``Retry-After`` and 200s only, each 200 checked
   against float64, and the replicas' ``/admin/resilience`` count the
   sheds; their ``/admin/slo`` states are recorded (its burn windows
   need two samples 60 s apart, so in this phase they read no_data). (f) A
   ``kill -9`` of r0: the next 20 queries answer 200, and the
   supervisor restarts r0 into rotation on the second instance. One
   ``{"fleet": ...}`` line (the phase's wall, each replica's start
   time, the routed p50, the launch counts) prints after ``serve``'s.

4. Two-tower kernel phase: the ``flash_ce`` kernels (the forward, and
   the backward kernel twice: du, then dv with the roles swapped)
   against their plain version ``flash_ce_reference`` over B in {128,
   130, 1000, 8192}, D in {8, 64, 128, 256}, cdt in {float32, bfloat16},
   uniform and real-valued weights, with in-batch duplicate users and
   items and a zero-weight tail; the loss within the JAX package's
   kernel-test tolerance (f32 rtol 1e-5, bf16 5e-3), both gradients
   within its tolerances (f32 rtol 1e-4 / atol 1e-6, bf16 1e-1 / 2e-3)
   and also within the same rtol with an atol scaled to the gradient's
   size (1e-4 / 2e-3 of max|ref|) and a relative norm error of at most
   1e-4 / 2e-2. At the train shape (B=8192, D=128) deliberately wrong
   gradients (zeros, rows shifted, scaled by 0.9, one tile zeroed) must
   fail that check, and two kernel calls there must give the same
   loss, du and dv bit for bit. The ``embed_update``
   kernel against ``embed_update_reference`` at (N, E, B, vocab) =
   (64, 24, 37, 64), (50, 8, 24, 6) (every row collides) and (1M, 128,
   8192, 1M), rtol 1e-5 / atol 1e-6. Both are timed at the train
   phase's shapes (B=8192, D=128, bf16; 8192 rows into a [1M, 128]
   table) against their plain versions and, for ``embed_update``, one
   ``index_add_`` (no single PyTorch call computes the flash-CE loss):
   device time from ``torch.profiler``, for ``embed_update`` with L2
   flushed before each call (``warm_ms`` beside it); for ``flash_ce``
   the forward and the backward kernel apart, and ``ptxas``'s registers
   and spills of each of its kernels.
5. Train phase, the second main path: the repo's stretch two-tower
   configuration (BASELINE.json configs[4], sized in bench.py: 1M
   users, 1M items, 4M positives synthesized as bench.py does from
   ``default_rng(1)``, dim 128, batch 8192, temperature 0.07, lr 3e-3,
   seed 11, bf16, 3 epochs) through ``TwoTowerAlgorithm.train``, with
   the launch counters reset just before: ``flash_ce`` must launch 3
   times and ``embed_update`` twice per step, losses must be finite and
   fall, vectors unit-norm. The model is serialized into a memory
   store, deployed with the port's ``EngineServer`` and asked user and
   item queries over the 1M-item catalog through ``topk_dot``, each
   checked against a float64 host top-k as in the serve phase. Then,
   off the counted path, 20 steps at the same widths are profiled:
   device time per step by kernel group and the device's idle share.
6. ALS train phase, the north star's main path: bench.py's synthetic
   MovieLens-20M ratings (``synthesize`` at ``DEFAULT_KNOBS``: 138,493
   users, 26,744 items, 20,000,000 ratings from ``default_rng(0)``),
   every 20th held out, bench's config (rank 64, 5 iterations, reg
   0.05, block 4096, the rest default: bf16 gather and Gramians, 6-step
   Jacobi CG in bf16). First an ``ALSTrainer`` on ``cuda``: host
   binning (the native one-pass route, ``ops/ragged.py``), the
   transfer, ``compile()`` (one warm alternation), then 5
   timed alternations; its held-out RMSE must land in bench's
   ``RMSE_BAND`` (0.38, 0.48); peak device memory; then, off the timed
   run, device time per alternation by stage (gather+Gramian,
   segment-sum, solve) from ``torch.profiler``, the launches and the
   device's idle share per alternation, and ``work_model`` bytes over
   device time as a share of the card's HBM rate
   (``tools/als_timing.py``); the gather roof
   (``measure_gather_roof``: the user side's gather, mask and reduce
   alone) and the train's slots a second over it; and the put sweep:
   the layout, which the trainer saved to a layout cache of its own,
   put again from the cache's file mapping (warm in the page cache) at
   each of ``PUT_SWEEP``'s settings (the one-shot put first and last,
   chunks of 8, 32 and 64 MB through pinned staging buffers on a side
   stream), each setting's ``put_sec``, ``transfer_sec`` and chunks,
   and its device tensors equal to the first put's. Then the main path, with the launch
   counters reset just before: ``ALSAlgorithm.train`` on ``cuda`` over
   the same prepared ratings (RMSE in the band again), the model stored
   in a memory store and deployed with the port's ``EngineServer``;
   user and item queries through ``topk_dot``, each checked against a
   float64 host top-k of the model's factors, and the kernel's counter
   must rise by at least the number of lone queries.
7. Ingest phase, the data lane of the same main path at bench.py's
   cold-stage width, uncut: the ALS phase's 20,000,000 ratings go into a
   port ``eventlog`` store under the temporary directory (which must
   have ``INGEST_DISK_BYTES`` free) by ``insert_columnar``; 100,000
   events of another name through the event server's JSON row lane
   (``insert_json_batch``); the template's binned request then makes
   one fused native scan+bin with bench's 5% holdout and ``_bench_cfg``'s
   layout knobs: ``n_rows`` plus the holdout must be every rating, and
   both sides must be byte-equal to ``build_compressed_side`` over the
   same split with the ids renumbered in the scan's first-seen order.
   ``ALSTrainer.from_sides`` on ``cuda``, ``compile()``, 5 timed
   alternations: RMSE in the band, the stage profile beside the ALS
   phase's. Then the main path, counters reset: ``ALSAlgorithm.train``
   on the template's binned request, cold (exactly one scan) and again
   on the unchanged events (a layout-cache hit, no scan), the model
   deployed and asked 20 queries through ``topk_dot``, each checked
   against a float64 host top-k. The log and the cache are removed at
   the end, pass or fail.
8. Front-door phase, the same main path from ``pio app new``, at the
   ALS phase's width: in a new temporary ``eventlog`` store
   (``INGEST_DISK_BYTES`` free), ``cli app new ml20m`` and ``cli
   accesskey new ml20m view``; of the first 19,750,000 ratings in time
   order, every ``PROJECT_STRIDE``-th plus each user's and each item's
   first (``depth_cut``: ~5M, every width kept; phase 7 holds the uncut
   20M lane) by ``insert_columnar`` (the bulk lane, as history), the
   store closed; ``cli eventserver`` then takes the last 250,000 as API
   ``rate`` events: 248,000 in ``/batch/events.json`` bodies of 10,000
   over 4 keep-alive connections (every status 201) and 2,000 lone
   ``POST /events.json`` (201 with an ``eventId``); the whitelisted
   key's batch of 990 ``view`` events (201) and 10 ``rate`` events
   (403); 20 ``GET /events.json`` reads that must list exactly that
   user's history and live events; ``/stats.json`` counts equal to
   what was sent. SIGTERM while a 10,000-event batch is in flight: the
   batch is answered and the server exits 0 within
   ``PIO_DRAIN_TIMEOUT``. ``cli train`` (bench's ALS knobs) must log
   the binned lane with one scan of exactly the log's ratings (the cut
   history and the 250,000 live); ``cli
   deploy``'s 20 answers are checked against a float64 host top-k, and
   ``topk_dot``'s launches in its ``GET /`` rise by at least the lone
   queries; ``cli status`` exits 0. The batch route's per-event split
   (native lane, result loop and stats, JSON) is measured in process
   on a store of its own first. The store is removed at the end.
9. ``pio train`` phase: seeded rate events at MovieLens-100K's shape
   (943 users, 1,682 items, 100,000 ratings) go into a localfs event
   store through ``cli app new`` and ``cli import`` of a JSONL file,
   and ``cli export`` must give them back; ``python -m
   predictionio_torch.tools.cli train`` trains ``twotower_engine`` (dim
   64, batch 1024: flash_ce eligible) and ``... cli deploy`` serves it,
   then the same two commands train and serve ``recommendation_engine``
   (ALS, rank 16) over the same events, and again over the same events
   imported into an ``eventlog`` store, where ``cli train``'s log must
   show the binned lane; queries are checked against each stored
   model's factors. The three chains of CLI processes (the eventlog
   store's import, train and deploy; once the localfs store holds the
   events, the two-tower's and the ALS engine's train and deploy) run
   side by side, and phase 11's stream commands run against the
   eventlog chain's live deploy.
10. Eval phase, the evaluation half (``pio eval``). (a) The ALS phase's
   ratings and holdout as ``PreparedRatings``; ``ALSAlgorithm.grid_train``
   on ``cuda`` trains G = 4 candidates at once (``lambda_`` 0.05, 0.02,
   0.1 at 5 iterations of 6 CG steps, and 0.05 at 3 iterations of 4):
   every held-out RMSE finite, candidate 1 in ``RMSE_BAND`` and within
   1e-2 of the ALS phase's ``ALSAlgorithm.train`` (its sequential
   oracle: the same params and seed), candidate 4
   within 1e-2 of one sequential ``ALSAlgorithm.train`` at 3 iterations
   of 4 CG steps. Then an ``ALSGridTrainer`` of the same grid is
   profiled (``tools/als_timing.grid_profile``): device ms, launches
   and idle share per grid alternation. (b) ``python -m
   predictionio_torch.tools.cli eval`` of a module written into the
   temporary directory: an ``Evaluation`` of ``recommendation_engine``
   with a rating-MSE metric, and a generator of three ``lambda_`` (0.01
   to 1.0; 3 folds, rank 64, 3 iterations, f32) over the ``pio train``
   phase's eventlog events. It must exit 0, print the one-liner, log 3
   candidates grid-trained in 3 runs and no fallback, and leave one
   EVALCOMPLETED EvaluationInstance whose JSON scores match an
   in-process sequential ``FastEvalEngineWorkflow`` on the card (rtol
   1e-4, atol 1e-5, the same ranking).
11. Stream phase, the freshness lane over the ingest phase's 20M-event
   log before it is removed, counters reset just before: the
   warm-trained model becomes a COMPLETED instance of that store,
   served by the port's ``EngineServer`` on ``cuda`` and patched by a
   ``StreamUpdater`` on ``cuda`` (``workflow/stream.py``), with
   ``bench.py`` ``_stream_stage``'s traffic: a warm fold of 1 event; a
   throughput fold of 1,000 ratings from 100 new users over 8 existing
   items drawn with ``default_rng(11)``; a fresh user's one rating,
   empty before the fold and answered after it (event to servable),
   the answer checked against a float64 host top-k of the served
   tables and the folded factor within ``FOLD_REL_TOL`` of a float64
   solve of its normal equations; an existing user's one more rating,
   its factor against a float64 solve of its full history over the
   fixed item factors; a new item rated by 5 existing users, appended
   to the served index, its ``{"item": ...}`` answer checked and the
   first query after the patch timed against warm ones; one fold
   published over HTTP to ``POST /model/patch``; the recall probe over
   the patched index at 1.0 (ties within ``topk_dot``'s tolerance
   excepted). Each fold's split (native tail read, history scans,
   solves, publish) is timed around those calls; every solve must run
   on ``cuda:0``. Then ``online_delta_step`` on the train phase's
   stretch tables (1M x 1M x 128) with a 4,096-pair delta and 4 steps:
   losses falling, only the delta's rows returned, within
   ``TT_ONLINE_ATOL``/``TT_ONLINE_RTOL`` of the same call on the CPU.
   ``topk_dot`` must have launched on this path. From the existing
   user's fold on, ``PIO_QUALITY_EVERY=1``: each fold runs the
   shadow-quality probe, whose ``topk_dot`` launches are counted apart
   (each probe at least one); after the HTTP lane's fold its
   ``recall_vs_retrain`` must lie within the least and the most overlap
   a float64 top-k of the folded tables against the shadow allows
   (equal unless near-ties within ``topk_dot``'s tolerance straddle the
   cut), and the server's ``/admin/quality`` must hold the pushed
   report. Then ``PIO_QUALITY_DRIFT_BAND=0`` and the server as the
   reload URL: two more folds breach the band, and the reload lane
   fires once (one ``auto_reload`` in the journal, one in-place
   ``reload`` of the server, one trigger logged). The reload's warm-up
   launches are counted apart too, and the path's count holds neither.
   In the ``pio train``
   phase: ``cli deploy`` of its eventlog ALS engine, ``cli stream
   --once --url U --reload-url U`` against it (exit 0, its stats
   printed), ``cli undeploy`` (the server's process exits 0).

12. Project phase, the engine-project path. (a) Two-tower
   checkpoint/resume at the train phase's stretch configuration: three
   uninterrupted runs, then a run with ``checkpoint_dir`` dropped after
   ``CKPT_STOP_EPOCH`` and a new trainer that restores it on ``cuda``
   (counters reset just before) and runs to epoch 3. The restored
   tables, accumulators and epoch-order generator state must equal what
   was saved byte for byte, the resumed epochs must walk the
   uninterrupted runs' orders, every kernel launch of the resumed steps
   counted, and the resumed tables and step losses must sit within 2x
   the uninterrupted runs' spread (L2 from their mean against the
   largest L2 between two of them: ``embed_update`` combines duplicate
   rows with float atomics). The checkpoint's bytes, save and restore
   seconds are printed; the directory must have room for two kept
   checkpoints and the one being written. (b) The similar-product
   Quick Start in a new temporary ``eventlog`` store at MovieLens-20M
   widths: a ``$set`` for every user and item (items with 1-3 of
   ``PROJECT_CATEGORIES`` categories), the project phase's pairs (every
   ``PROJECT_STRIDE``-th of the ALS phase's 20M, plus each user's and
   each item's first, so both widths stay whole: ~5.1M) as
   ``view`` events and every ``PROJECT_LIKE_EVERY``-th as ``like``
   (rating >= 3.5) or ``dislike``; then ``cli template get
   similarproduct``, ``app_name`` set in the project's engine.json with
   both algorithms at the template defaults (rank 10, 20 iterations),
   ``cli build`` (its manifest stored), ``cli train`` (on ``cuda:0``,
   per its log; in every Quick Start of phases 12 and 13 template get,
   build and train run as ``cli.main`` in this process, and the deploy
   as a ``cli`` process) and ``cli deploy`` (on
   ``cuda:0``, per its deploy line); ``likealgo``'s item factors must
   be finite and their largest |value| within ``LIKE_BOUND_FACTOR``
   (10x) of the same config solved on the card with ``solver="direct"``
   (a failure names the rows; ``python3 chip_smoke.py
   --likealgo-repeat N`` trains it N times alone and counts the trains
   in bounds),
   asked exclusion-only, two-item, blacklist, ``num`` 1, category and
   whitelist queries and an unknown item. Each answer is checked against
   ``StandardizingServing`` over float64 top-ks of the stored models'
   normalized tables; queries are drawn until float32 rounding cannot
   change their answer (no near-tie at a cut). ``topk_dot``'s launches
   in the server's ``GET /`` must rise by 2 per index query, and the
   D=10 kernel on those tables and queries is held against its plain
   version and timed. (c) The e-commerce Quick Start in another new
   store: the same ``$set`` events and the project phase's ratings as
   ``rate`` events; ``cli template get ecommercerecommendation``, ``cli build``,
   ``cli train`` (``unseen_only`` on, template defaults otherwise);
   then, from the stored model, a known user's views of 5 of its best
   items, a constraint ``$set`` of another user's 3 best items and a new
   user's views of 5 consecutive items (the first 5 whose answer
   float32 cannot move) are written, and ``cli deploy`` answers a known
   user, the viewing user (unseenOnly), a category, a blacklist, the
   constrained user and the new user (recent views), each checked
   against a float64 masked top-k of the stored factors. Both stores
   are removed at the end, pass or fail.
13. Families phase, the engine families beyond recommendation. (a) The
   session recommender over phase 12's e-commerce store before it is
   removed (its ratings; 138,493 users; 26,744 items): ``cli template get
   sessionrec``, ``cli train`` on ``cuda:0`` at the
   template defaults (dim 64, 2 heads, 2 layers, max_len 64, dropout
   0.1, batch 256; 541 steps an epoch) but ``SR_EPOCHS`` epochs of the
   default 5, a cut for the script's time limit: its log's read and
   ``build_sequences`` seconds, epoch seconds, step ms, losses (finite,
   the last below the first and below ln V) and peak memory; ``cli
   deploy`` on ``cuda:0``, lone queries by user, by an ``items``
   session and with ``excludeSeen``, each answer held slot for slot
   against a float64 host forward of the stored weights (encoder, last
   position, scores, exclusions, top-k) within ``SR_SCORE_TOL`` of
   |last| * max|item row| (queries float32 could move across the cut
   are skipped), and exactly one ``topk_dot`` launch a query in the
   server's ``GET /``. Then the stored weights carried into a trainer
   on the card over the first ``SR_PROFILE_USERS`` users: one
   full-shape batch's tied loss and gradient norm with dropout off on
   the card and on the CPU (``SR_LOSS_RTOL``, ``SR_GRAD_RTOL``),
   ``blockwise_attention`` (block 16) against ``mha_reference`` on the
   card at atol 1e-5, and 20 steps timed and 20 profiled (device time a
   step, the device's idle share, peak memory). (b) The classification
   Quick Start in a new eventlog store: ``FAM_CLS_USERS`` ``$set``
   users (``plan`` of ``FAM_CLS_LABELS`` labels, Poisson
   ``attr0..attr2``), ``cli template get``/``train`` of both
   algorithms on ``cuda:0``: naive Bayes's ``pi``/``theta`` within 1e-5
   of float64 counts, the logistic model's labels on 2,000 points equal
   to a float64 product of its stored weights (near-ties skipped);
   ``cli deploy``'s answers equal float64 naive Bayes. (c) The
   regression Quick Start over a seeded ``lr_data.txt`` of ``REG_ROWS``
   rows: ``cli template get``/``train`` of SGD (400 iterations, step
   0.2) and ridge on ``cuda:0``, both stored weight vectors within 0.01
   of ``REG_TRUE_W``, ``cli deploy``'s ``AverageServing`` answers within
   1e-5 of float64 of the stored weights;
   ``cli template get``/``train``/``deploy`` of vanilla and
   one answer; categorical naive Bayes (100,000 points) and a Markov
   chain (2,000 states, top 16) on the card against float64.
14. Multi-process phase, the Recommendation engine's main path across
   processes. Two worker processes (``chip_smoke.py --md-worker RANK
   PORT DIR``) start first: each brings up a gloo world of 2 itself
   (NCCL refuses two ranks on one device), then ``initialize_from_env``
   keeps it, on ``cuda:0``, and bins its half of the ALS layout on the
   host. Meanwhile (a), a world of one over NCCL in this process
   (``initialize_from_env`` with the three variables at a free local
   port, 1 and 0): ``topk_dot``, its plain version and ``matmul`` +
   ``topk`` timed on rank 0's slab (B=1, I=13,372, D=64, k=16; the
   bound beside them); once the workers are ready, ``ALSTrainer`` over
   ``create_mesh()`` at ML-20M widths, rank 64, ``MD_ITERS``
   alternations of direct f32 solves, on the front door's cut of the
   ratings (``depth_cut`` of the first ``FD_HISTORY``: 5,051,090, every
   20th held out), against the same train without a mesh (relative
   Frobenius error at most ``MD_FACTOR_TOL``); ``ShardedTopKScorer``
   over phase 3's seeded factors, 64 lone queries excluding 0, 1 or 4
   of the user's best items and one batch of 64 (k = 16), every answer
   held to float64 under phase 2's near-tie rule and exactly one
   ``topk_dot`` launch a call; an ALS model's answers through the
   sharded scorer equal to its retrieval index's; the world destroyed.
   Then (b), once this process writes the workers' ``go`` file: on each
   rank the sharded scorer over its slab (the same queries and checks,
   its launches counted), the sharded ALS train of (a) (factors within
   ``MD_FACTOR_TOL`` of (a)'s, held-out RMSE within ``MD_RMSE_TOL``),
   and a two-process ``run_train`` of the recommendation engine over one
   localfs store at the ``pio train`` phase's ML-100K shape: one
   instance row and one blob (rank 0 alone writes), the same COMPLETED
   id on both ranks, and rank 1's in-process deploy answering a query
   checked against float64 of the stored factors through ``topk_dot``.
   (c) The two-tower trainer at the stretch width (1M users and items,
   dim 128, batch 8192, bf16) for ``MD_TT_STEPS`` steps from one carried
   state (``md_tt_state``): in (a)'s world, over ``create_mesh()``
   against no mesh; on each rank of (b)'s world, DP over ``{"data":
   2}``, then TP over ``{"model": 2}`` with ``shard_embeddings``, each
   rank's losses and whole slab of both tables held to the world of
   one's (``MD_TT_LOSS_RTOL``, ``MD_TT_TABLE_ATOL``), ``flash_ce``
   launched 3 times and ``embed_update`` 2 times a step on every rank;
   the TP run's checkpoint written by rank 0 alone and resumed by both,
   the resumed slabs equal to the saved ones. (d) The session
   recommender at phase 13's widths, one epoch of ``MD_SR_STEPS`` steps
   through ``SessionRecTrainer.run`` with ``seq_axis`` over ``{"seq":
   2}`` (ring attention across the two ranks), then with the batch
   split over ``{"data": 2}``, each epoch's loss held to one process's
   with ``attn_block=16`` (``MD_SR_LOSS_RTOL``). A worker that fails, hangs past
   ``MD_WORKER_TIMEOUT`` or is not ready fails the phase. One
   ``{"multi_device": ...}`` line prints before ``obs``'s (with
   ``twotower`` and ``sessionrec`` entries: ms a step on each rank,
   world of one against two, and the launch counts); the three worlds'
   scorer launches join ``topk_dot``'s ``launches_by_path`` and the
   trainers' launches ``flash_ce``'s and ``embed_update``'s.
15. Storage-tier phase, the Recommendation engine trained and served
   over the ``rest`` tier. Three in-process ``StorageServer``s on
   127.0.0.1, each over its own storage (events in an event log,
   metadata and models in sqlite), behind one ``rest`` source with
   ``REPLICAS=2``: events sharded by ``stable_hash(user) % 3`` onto
   their owner and its successor, metadata and models on servers 0 and
   1. (a) Phase 14's training rows (the front door's ``depth_cut``,
   every 20th held out), ordered by owner shard, go in through
   ``insert_columnar`` (meanwhile the same rows into a local event
   log); each server must hold 0.55-0.78 of them and the three twice
   their number. (b) ``cli.main(["train", ...])`` in this process on
   ``cuda:0`` under the ``rest`` environment (ALS at rank 64,
   ``TIER_ITERS`` alternations of direct f32 solves, the columnar read
   and host binning), then the same over the local log (its native
   binned lane): the tier read numbers ids in the local log's order,
   so the factors must agree within ``TIER_FACTOR_TOL`` of the largest
   magnitude and the held-out RMSE within ``TIER_RMSE_TOL``; the
   instance row and its blob must be on both metadata replicas. (c) An
   ``EngineServer`` on ``cuda`` loads the instance through the tier;
   lone user (a third with a blacklist) and item queries are checked
   against float64 and the ``topk_dot`` counter, reset before the
   deploy, must rise by at least their number. (d) Server 0 stops: the
   tier's ``find_columnar`` must return the same multiset of (user,
   item, rating), ``GET /reload`` must load the instance from the
   surviving replica and answer right, ``serving_status()`` must read
   EVENTDATA and METADATA serving, degraded, server 0 down, and of one
   write a shard (into the repair app below, whose log indexes its ids
   at once), those whose replica set holds server 0 must raise
   ``StorageUnavailableError`` naming it while the other lands; then
   server 0 restarts on its directories. (e) A repair app (every
   ``TIER_REPAIR_STRIDE``-th training row, made in (a)) loses ``TIER_REPAIR_LOST``
   rows of shard 0 on its non-owner replica and the instance row on
   metadata replica 1, written through those servers' own storage;
   ``cli.main(["storagerepair", ...])`` must print exactly that many
   rows and 1 record copied, a second run zeros, and each shard's two
   copies must then hold the same rows. One ``{"storage": ...}`` line
   prints before ``obs``'s; the deploy's launches join ``topk_dot``'s
   ``launches_by_path``.

16. Operator's tools phase (``python3 chip_smoke.py --operator-tools``
   runs it alone, after building the kernels). (a) The kernel-library
   cache, in the background while (b) and (c) run: two fresh
   interpreters (``--cache-child``) over an empty temporary
   ``PIO_COMPILE_CACHE_DIR`` (only their environment holds it; every
   other phase uses the package's shared ``_build/``). The first builds
   ``embed_update`` into ``<dir>/kernels`` (``pio_kernel_build_total
   {result="built"}`` 1, its nvcc seconds); the second loads it
   (``result="cached"`` 1, no build: the cache's files unchanged; ``nvcc
   --version`` still runs, for the key), launches it against its plain
   version as phase 2 does, and reads ``/readyz``'s ``compile_cache``
   probe from an admin server. (b) In a fresh interpreter
   (``--profile-child``), as ``pio train`` runs (a window opened late in
   a long-lived process once lost the device records of its first
   kernels, ROADMAP.md §3, fault 13, now repaired by the capture's
   lead-in; the phase records what a window opened in this process
   loses, ``capture_lead``, from ``tools/profile_window.lead_loss``,
   which must be nothing). There ``run_train`` of the
   two-tower algorithm on phase 14 (c)'s cut (its first 49,152
   positives over the stretch width's id maps, 6 steps, one epoch, the
   trainer's seeded initial state), without and then with
   ``PIO_PROFILE_DIR``:
   ``breakdown.json`` beside the trace, its ``steps`` 1 (one a two-tower
   epoch, as JAX counts), its launches naming ``flash_ce`` 18 and
   ``embed_update`` 12 times (the launch counters agree), the profiled
   tables within ``OT_TABLE_RTOL`` of their scale of the plain run's;
   its ``device_ms_per_step`` printed beside the epoch's device time
   from ``tools/device_time.profile_call``. Then ``cli.main(["train",
   ...])`` in this process under ``PIO_PROFILE_DIR`` of the ``pio
   train`` phase's ALS engine over an ML-100K-shaped store: ALS counts
   no step, so its ``breakdown.json`` is the train's total (JAX's
   branch). (c) An in-process ``EngineServer`` on the card over that
   ALS instance with ``PIO_UPDATE_URL`` at a local server: answers
   checked against float64 through ``topk_dot``, one GET with
   ``component=engine-server``, and no ``pio-upgrade-check`` thread left
   after its stop. One ``{"operator_tools": ...}`` line prints after
   ``storage``'s; (b)'s launches join ``flash_ce``'s and
   ``embed_update``'s ``launches_by_path``, (c)'s ``topk_dot``'s, and the
   ``kernels`` line gains each library's ``load_sec`` and
   ``embed_update``'s cold build and cached load seconds.

17. Last tools phase (``python3 chip_smoke.py --last-tools`` runs it
   alone, over a store of its own: an ML-100K localfs store, its ALS
   engine trained and one ``cli eval`` of the eval phase's sweep, both
   through ``cli.main`` in this process). In the whole script it reads
   the ``pio train`` phase's eventlog store, kept until now: (a)
   ``cli.main(["run", "pio_last_tools.answer", ...])`` in this process,
   the target a module the phase writes into a temporary directory on
   ``sys.path``: it reads the newest COMPLETED ``ml100k-als-el``
   instance through ``get_storage()`` (the storage ``pio run``
   configured), loads the model on ``cuda`` and answers 8 lone user
   queries through ``ALSModel.recommend``, each a flight record under
   its own trace id; every answer is checked against float64 on the
   host in the port's order, ``topk_dot``'s launches rise by at least 8,
   and the passthrough argv and the exit code (3) come back. (b)
   ``cli.main(["shell"])`` with stdin a short script: the bound names,
   ``ctx``'s device (the card) and the app ``storage`` lists. (c) A
   ``DashboardServer`` on port 0 over the store's evaluation instances:
   the index lists them newest first, each
   ``evaluator_results.{txt,html,json}`` is the stored instance's bytes,
   every operator view answers 200 with HTML, ``/flight`` lists (a)'s
   trace ids and ``/memory`` the card's memory (``memory_stats``, the
   card's total). One ``{"last_tools": ...}`` line prints after
   ``operator_tools``'s; (a)'s launches join ``topk_dot``'s
   ``launches_by_path``.

Output: the card's name and power limit (``nvidia-smi``), a ``serve``,
a ``fleet``, a ``train``, an ``als_train``, an ``ingest``, a ``front_door`` (with
the card's line), a ``pio_train``, a ``stream`` (with the card's line),
an ``eval``, a ``project``, a ``families``, a ``multi_device``, a
``storage``, an ``operator_tools`` and a ``last_tools`` line (each with
the card's line),
the ``kernels`` line, and last ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import logging
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

SEED = 20
N_USERS, N_ITEMS, RANK = 138_493, 26_744, 64     # bench.py DEFAULT_KNOBS
# flash_ce gradients against the plain version, per cdt: the JAX
# package's kernel-test tolerances (rtol, atol), then the same rtol with
# an atol scaled to the gradient's own size (a fraction of max|ref|), and
# a bound on ||g - ref|| / ||ref||. The JAX atol alone says nothing at
# the train shape, where |du| is ~1e-4.
GRAD_TOLS = {"float32": (1e-4, 1e-6, 1e-4, 1e-4),
             "bfloat16": (1e-1, 2e-3, 2e-3, 2e-2)}
TOPK_SOURCE = "predictionio_torch/ops/kernels/csrc/topk_dot.cu"
TOPK_REPLACES = "predictionio_tpu/ops/pallas/topk_dot.py:70"
FLASH_SOURCE = "predictionio_torch/ops/kernels/csrc/flash_ce.cu"
FLASH_REPLACES = "predictionio_tpu/ops/pallas/flash_ce.py:192"
EMBED_SOURCE = "predictionio_torch/ops/kernels/csrc/embed_update.cu"
EMBED_REPLACES = "predictionio_tpu/ops/pallas/embed_update.py:100"
# the stretch two-tower configuration (BASELINE.json configs[4]; bench.py)
TT_IDS, TT_POS, TT_DIM, TT_BATCH = 1_000_000, 4_000_000, 128, 8192
TT_EPOCHS = 3
TEMP = 0.07
# bench.py's ALS run: DEFAULT_KNOBS ratings, its 5% holdout, _bench_cfg
# (rank 64 above, 5 iterations, reg 0.05, block 4096), and RMSE_BAND
ALS_RATINGS, ALS_ITERS, ALS_REG, ALS_BLOCK = 20_000_000, 5, 0.05, 4096
RMSE_BAND = (0.38, 0.48)
# free disk the ingest phase needs: the log (~173 bytes an event), its
# index snapshot and two layout-cache entries
INGEST_DISK_BYTES = 6 << 30
# the front-door phase: the ALS phase's ratings, of which the first
# FD_HISTORY, cut to depth_cut's rows, go in as history and the rest
# through the event server
# (batches of FD_BATCH over FD_CONNS connections, then FD_LONE lone
# POSTs); a whitelisted key's batch of FD_VIEWS views and FD_DENIED
# rates; FD_READS reads; the server's drain window
FD_HISTORY, FD_BATCH, FD_CONNS, FD_LONE = 19_750_000, 10_000, 4, 2_000
FD_VIEWS, FD_DENIED, FD_READS = 990, 10, 20
FD_DRAIN_TIMEOUT = 30
# the eval phase: (a) the grid's candidates (lambda_, iterations, CG
# steps), the first the ALS phase's own training; (b) pio eval's sweep
GRID_REGS, GRID_ITERS, GRID_CG = (0.05, 0.02, 0.1, 0.05), (5, 5, 5, 3), \
    (6, 6, 6, 4)
EVAL_REGS, EVAL_K = (0.01, 0.1, 1.0), 3
# the stream phase: bench.py _stream_stage's throughput fold (STREAM_EVENTS
# ratings from STREAM_USERS new users over STREAM_HOT existing items),
# the ratings row whose user gets one more rating, the two-tower online
# step's delta (4,096 pairs: 64 MB of dense [P, P] logits) and steps
STREAM_ENGINE = "als-stream"
STREAM_EVENTS, STREAM_USERS, STREAM_HOT = 1000, 100, 8
STREAM_EXISTING_ROW = 12_345
STREAM_TT_PAIRS, STREAM_TT_STEPS = 4096, 4
# a folded factor against a float64 solve of the same normal equations
# (relative L2): the fold is f32 with 16 Jacobi-CG steps (ops/als.py
# FOLD_IN_CG_ITERS), which stop short of an exact solve at rank 64 (the
# card test test_fold_in_solve_on_the_card_matches_the_cpu holds the same
# bound)
FOLD_REL_TOL = 1e-3
# the online step on the card against the CPU: f32 products summed in
# another order (vectors: absolute; losses: relative)
TT_ONLINE_ATOL, TT_ONLINE_RTOL = 1e-5, 1e-5
# the project phase: the epoch after which the checkpointed two-tower run
# is dropped; the categories an item draws 1-3 of and every how many
# view pairs is also a like or dislike; the e-commerce constraint's
# size (a user's best items) and the views of the seen and the new user
CKPT_STOP_EPOCH = 1
# the similar-product and e-commerce stores (and so the session
# recommender) hold every PROJECT_STRIDE-th rating of the 20M, plus each
# user's and each item's first: a cut of depth for the script's time
# limit, widths kept (PERF.md §4)
PROJECT_STRIDE = 4
PROJECT_CATEGORIES, PROJECT_LIKE_EVERY = 20, 10
ECOM_UNAVAILABLE, ECOM_SEEN_VIEWS, ECOM_NEW_USER_VIEWS = 3, 5, 5
ECOM_APP = "ml20m-ec"
# phase 13: a served session score against float64, relative to
# |last hidden| * max|item row| (two f32 blocks and a 64-term dot); the
# card's step against the CPU's (loss; gradient norm, f32 sums of 26,745
# logits a position in another order); the users whose ratings carry the
# stored weights into the profiled trainer (>= 43 batches of 256)
SR_SCORE_TOL, SR_LOSS_RTOL, SR_GRAD_RTOL = 2e-5, 1e-5, 1e-4
SR_PROFILE_USERS = 12_000
# the template's train: 2 of its default 5 epochs (~7 s an epoch on an
# H100; the loss falls in the first two, 6.25 -> 6.07 of ln V = 10.19)
SR_EPOCHS = 2
# the classification Quick Start: entities, labels, each label's Poisson
# means of attr0..attr2; the regression file's rows and weights
# (tests/test_regression.py's TRUE_W)
FAM_CLS_USERS, FAM_CLS_LABELS = 200_000, 4
CLS_BASES = np.array([[8.0, 1.0, 1.0], [1.0, 8.0, 1.0], [1.0, 1.0, 8.0],
                      [4.0, 4.0, 4.0]])
REG_ROWS = 1_000_000
REG_TRUE_W = np.array([2.0, -1.0, 0.5], dtype=np.float32)
# phase 3c, the fleet: phase 3's captured payloads (its capture ring),
# replica processes, their admission queue limit, routed lone queries,
# the chaos check's hang, router timeout and breaker re-test delay, the
# concurrent burst and the dispatch latency a chaos rule adds during it,
# the queries right after the kill
FLEET_CAPTURE, FLEET_REPLICAS, FLEET_SHED_QUEUE_DEPTH = 256, 2, 1
FLEET_LONE_USERS, FLEET_LONE_ITEMS = 20, 8
FLEET_HANG_SEC, FLEET_ROUTER_TIMEOUT, FLEET_BREAKER_RESET_SEC = 2, 1.0, 2
FLEET_BURST, FLEET_BURST_LATENCY_MS, FLEET_KILL_QUERIES = 128, 50, 20


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def own_split(split: dict, prefix: str) -> dict:
    """The device split by kernel, the port's own kernels by name and
    PyTorch's summed under ``torch ops``."""
    out = {"torch ops": 0.0}
    for name, ms in split.items():
        if prefix in name:
            out[name] = ms
        else:
            out["torch ops"] += ms
    return out


# -- kernel phase ------------------------------------------------------------

def check_topk(q, items, excl, k, s_k, i_k, what: str) -> float:
    """Kernel output against topk_dot_reference; returns max |err|."""
    import torch
    from predictionio_torch.ops.kernels.topk_dot import topk_dot_reference

    s_r, i_r = topk_dot_reference(q, items, excl, k)
    B, I = q.shape[0], items.shape[0]
    tol = 1e-5 * q.norm(dim=1, keepdim=True) * items.norm(dim=1).max()
    live = s_r > -1e29
    err = (s_k - s_r).abs()
    if bool(((err > tol) & live).any()):
        fail(f"topk_dot scores differ ({what}): max err "
             f"{float(err[live].max())} vs tol {float(tol.max())}")
    if s_k.shape != (B, k) or i_k.shape != (B, k):
        fail(f"topk_dot output shape ({what}): {tuple(s_k.shape)}")
    if bool(((i_k < 0) | (i_k >= I)).any()):
        fail(f"topk_dot returned an id outside the table ({what})")
    rows_sorted = torch.sort(i_k.long(), dim=1).values
    if bool((rows_sorted[:, 1:] == rows_sorted[:, :-1]).any()):
        fail(f"topk_dot returned a duplicate id ({what})")
    mismatch = (i_k.long() != i_r.long()) & live
    if bool(mismatch.any()):
        # only a near-tie of the reference may reorder: the kernel's item
        # must score (by the reference's own product) within tol of the slot
        full = q @ items.T
        got = torch.gather(full, 1, i_k.long())
        near = (got - s_r).abs() <= tol
        if bool((mismatch & ~near).any()):
            b, j = [int(x) for x in torch.nonzero(mismatch & ~near)[0]]
            fail(f"topk_dot index differs ({what}) at row {b} slot {j}: "
                 f"kernel {int(i_k[b, j])} vs reference {int(i_r[b, j])}")
    return float(err[live].max()) if bool(live.any()) else 0.0


def kernel_phase() -> dict:
    import torch
    from predictionio_torch.ops import kernels
    from predictionio_torch.ops.kernels import topk_dot as tkd
    from predictionio_torch.tools.device_time import profile_call

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    cases = 0
    for I in (513, 26_744, 66_000):
        for D in (32, 64, 128):
            items = torch.randn((I, D), generator=gen, device=dev)
            for B in (1, 8, 64, 128):
                q = torch.randn((B, D), generator=gen, device=dev)
                for k in (8, 16, 128):
                    for E in (1, 2, 4, 64):
                        # -1 pads, ids in range, and stale ids outside
                        # [0, I) that must be ignored
                        excl = torch.randint(-2, I + 3, (B, E), generator=gen,
                                             device=dev, dtype=torch.int32)
                        s, i = tkd.topk_dot(q, items, excl, k)
                        torch.cuda.synchronize()
                        max_err = max(max_err, check_topk(
                            q, items, excl, k, s, i,
                            f"I={I} D={D} B={B} k={k} E={E}"))
                        cases += 1

    # exact ties: every item row appears twice
    half = torch.randn((N_ITEMS // 2, RANK), generator=gen, device=dev)
    items = torch.cat([half, half])
    q = torch.randn((8, RANK), generator=gen, device=dev)
    excl = torch.full((8, 1), -1, dtype=torch.int32, device=dev)
    s, i = tkd.topk_dot(q, items, excl, 16)
    torch.cuda.synchronize()
    max_err = max(max_err, check_topk(q, items, excl, 16, s, i, "ties"))
    # ties resolve to the lower id first: each twin pair appears in order
    pos = i.long() % (N_ITEMS // 2)
    if not bool((i[:, 0::2].long() < N_ITEMS // 2).all()) or not bool(
            (pos[:, 0::2] == pos[:, 1::2]).all()):
        fail("topk_dot tie order: twins must come lower id first, paired")

    # a whole tile of top candidates excluded: the 64 best items sit in
    # one tile and are all banned, so the answer comes from other tiles
    items = torch.randn((N_ITEMS, RANK), generator=gen, device=dev)
    q = torch.randn((1, RANK), generator=gen, device=dev)
    items[1000:1064] += 10.0 * q / q.norm()
    excl = torch.arange(1000, 1064, dtype=torch.int32,
                        device=dev).reshape(1, 64)
    s, i = tkd.topk_dot(q, items, excl, 8)
    torch.cuda.synchronize()
    max_err = max(max_err, check_topk(q, items, excl, 8, s, i,
                                      "tile excluded"))
    if bool(((i >= 1000) & (i < 1064)).any()):
        fail("topk_dot returned an excluded id")

    # adversarial tables: scores that rise along the table (every block
    # sorts again and again) and every row identical (all ties)
    for name in ("rising", "identical"):
        for I, D, B, k in ((N_ITEMS, RANK, 1, 16), (66_000, 128, 8, 128),
                           (TT_IDS, TT_DIM, 1, 16)):
            q, items = adversarial_table(name, I, D, B, gen)
            excl = torch.full((B, 1), -1, dtype=torch.int32, device=dev)
            s, i = tkd.topk_dot(q, items, excl, k)
            torch.cuda.synchronize()
            what = f"{name} I={I} D={D} B={B} k={k}"
            max_err = max(max_err, check_topk(q, items, excl, k, s, i, what))
            if name == "identical" and not bool(
                    (i == torch.arange(k, device=dev)).all()):
                fail(f"topk_dot on identical rows must return ids 0..k-1 "
                     f"({what})")
            cases += 1

    # the two lone-query shapes the main paths run, and the largest one
    shapes = {"serve": (1, N_ITEMS, RANK, 16, 1),
              "catalog": (1, TT_IDS, TT_DIM, 16, 1),
              "widest": (128, 66_000, 128, 128, 64)}
    inputs = {}
    for name, (B, I, D, k, E) in shapes.items():
        items = torch.randn((I, D), generator=gen, device=dev)
        q = torch.randn((B, D), generator=gen, device=dev)
        excl = (torch.full((B, E), -1, dtype=torch.int32, device=dev)
                if B == 1 else torch.randint(-1, I, (B, E), generator=gen,
                                             device=dev, dtype=torch.int32))
        inputs[name] = (q, items, excl, k)
    # repeated calls, shapes alternating, give their first call's bits:
    # each search's last block puts its ticket counter back to 0
    first = {name: tkd.topk_dot(*args) for name, args in inputs.items()}
    for n in range(60):
        name = list(inputs)[n % len(inputs)]
        s, i = tkd.topk_dot(*inputs[name])
        if not (torch.equal(s, first[name][0])
                and torch.equal(i, first[name][1])):
            fail(f"topk_dot call {n} at the {name} shape differs from the "
                 f"first call's bits")
    torch.cuda.synchronize()
    traced_per_call = {}
    for name, args in inputs.items():
        max_err = max(max_err, check_topk(*args, *first[name], name))
        # one device kernel per call and no memset, from the profiler:
        # the topk kernel is the only one traced, and it ran once a call
        # (CUPTI can drop an event now and then, never add one)
        traced = profile_call(lambda: tkd.topk_dot(*args), 20)
        per_call = traced["kernels_per_call"]
        if (len(traced["kernels"]) != 1 or "topk_dot_kernel" not in
                traced["kernels"][0] or not 0.9 < per_call <= 1.0
                or traced["memsets_per_call"] != 0):
            fail(f"topk_dot at the {name} shape: {per_call} device kernels "
                 f"({traced['kernels']}) and {traced['memsets_per_call']} "
                 f"memsets per call, want one kernel and no memset")
        traced_per_call[name] = {
            key: traced[key] for key in (
                "kernels_per_call", "memsets_per_call", "kernels")}
    timed = {name: time_topk(*inputs[name], shapes[name])
             for name in ("serve", "catalog")}
    serve = timed["serve"]
    return {
        "name": "topk_dot", "route": "cuda", "source": TOPK_SOURCE,
        "replaces": TOPK_REPLACES, "max_abs_err": max_err,
        **{key: serve[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shapes": timed, "traced_per_call": traced_per_call,
        "ptxas": kernels.ptxas_report("topk_dot"), "cases": cases,
        "shape": serve["shape"],
    }


def adversarial_table(name: str, I: int, D: int, B: int, gen):
    """(q, items): ``rising``, rows ordered so that every row of q scores
    them in rising order; ``identical``, one row repeated."""
    import torch

    dev = torch.device("cuda")
    direction = torch.nn.functional.normalize(
        torch.randn(D, generator=gen, device=dev), dim=0)
    q = direction + 0.01 * torch.randn((B, D), generator=gen, device=dev)
    if name == "rising":
        items = torch.linspace(0.1, 10.0, I, device=dev)[:, None] * direction
    else:
        items = torch.randn((1, D), generator=gen, device=dev).repeat(I, 1)
    return q, items.contiguous()


def time_topk(q, items, excl, k, shape) -> dict:
    """The kernel, its plain version and one library call (``torch.matmul``
    + ``torch.topk``) at one shape: ``ms`` is device time per call from
    ``torch.profiler`` (table warm in L2 where it fits), ``cold_ms`` the
    same with L2 flushed before each call, ``call_ms`` the CUDA-event time
    per call of back-to-back calls (the host's issue time when that is
    longer), ``cold_event_ms`` the median CUDA-event time of one call
    after an L2 flush."""
    import torch
    from predictionio_torch.ops.kernels import topk_dot as tkd
    from predictionio_torch.tools.device_time import (call_ms, cold_ms,
                                                      profile_call)
    from predictionio_torch.tools.topk_dot_timing import bound

    B, I, D, _, E = shape
    kernel = lambda: tkd.topk_dot(q, items, excl, k)  # noqa: E731
    plain = lambda: tkd.topk_dot_reference(q, items, excl, k)  # noqa: E731
    library = lambda: torch.topk(q @ items.T, k, dim=1)  # noqa: E731
    # event timing first: launches run slower after profiling
    kernel_call_ms, plain_call_ms, library_call_ms = (
        call_ms(f) for f in (kernel, plain, library))
    kernel_cold_event_ms, library_cold_event_ms = (
        cold_ms(f) for f in (kernel, library))
    warm, plain_warm, library_warm = (
        profile_call(f) for f in (kernel, plain, library))
    kernel_cold, library_cold = (
        profile_call(f, 50, cold=True) for f in (kernel, library))
    bound_ms, bound_by = bound(B, I, D, k, E)
    return {
        "ms": warm["ms"], "cold_ms": kernel_cold["ms"],
        "plain_ms": plain_warm["ms"], "library_ms": library_warm["ms"],
        "library_cold_ms": library_cold["ms"],
        "bound_ms": bound_ms, "bound_by": bound_by,
        "call_ms": kernel_call_ms, "plain_call_ms": plain_call_ms,
        "library_call_ms": library_call_ms,
        "cold_event_ms": kernel_cold_event_ms,
        "library_cold_event_ms": library_cold_event_ms,
        "device_split_ms": warm["split"],
        "shape": f"B={B},I={I},D={D},k={k},E={E}",
    }


# -- serve phase -------------------------------------------------------------

def post(port: int, payload: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


class Truth:
    """Factor tables and id maps of a served model, in float64 on the
    host: what every answer is checked against."""

    def __init__(self, U, V, user_names, item_names):
        self.U = np.asarray(U, np.float64)
        self.V = np.asarray(V, np.float64)
        self.item_names = list(item_names)
        self.users = {n: j for j, n in enumerate(user_names)}
        self.items = {n: j for j, n in enumerate(self.item_names)}
        self.vmax = float(np.linalg.norm(self.V, axis=1).max())


def expected_answer(t: Truth, q: dict):
    """(ids, scores, all scores) the query must get, under (score
    descending, item id ascending)."""
    num = int(q.get("num", 10))
    if "user" in q and q["user"] not in t.users:
        return np.zeros(0, np.int64), np.zeros(0), np.zeros(0)
    qvec = t.U[t.users[q["user"]]] if "user" in q else t.V[t.items[q["item"]]]
    scores = t.V @ qvec
    allowed = np.ones(len(t.V), bool)
    if "whitelist" in q:
        allowed[:] = False
        allowed[[t.items[w] for w in q["whitelist"] if w in t.items]] = True
    allowed[[t.items[b] for b in q.get("blacklist", ()) if b in t.items]] = False
    if "user" not in q:
        allowed[t.items[q["item"]]] = False
    cand = np.flatnonzero(allowed)
    order = np.lexsort((cand, -scores[cand]))[:num]
    return cand[order], scores[cand[order]], scores


def check_answer(t: Truth, q: dict, got: dict, what: str) -> None:
    ids, exp_scores, all_scores = expected_answer(t, q)
    served = got["itemScores"]
    if len(served) != len(ids):
        fail(f"{what}: {len(served)} items served, {len(ids)} expected "
             f"for {q}")
    if not len(ids):
        return
    qvec = t.U[t.users[q["user"]]] if "user" in q else t.V[t.items[q["item"]]]
    tol = 1e-5 * float(np.linalg.norm(qvec)) * t.vmax
    for j, entry in enumerate(served):
        if abs(entry["score"] - exp_scores[j]) > tol:
            fail(f"{what}: slot {j} score {entry['score']} vs "
                 f"{exp_scores[j]} for {q}")
        if entry["item"] != t.item_names[ids[j]]:
            true = all_scores[t.items[entry["item"]]]
            if abs(true - exp_scores[j]) > tol:
                fail(f"{what}: slot {j} item {entry['item']} vs "
                     f"{t.item_names[ids[j]]} for {q}")


def ml20m_factors(rng):
    """Random factors at MovieLens-20M widths from ``rng``, and names."""
    U = (0.3 * rng.standard_normal((N_USERS, RANK))).astype(np.float32)
    V = (0.3 * rng.standard_normal((N_ITEMS, RANK))).astype(np.float32)
    return (U, V, [f"u{j}" for j in range(N_USERS)],
            [f"i{j}" for j in range(N_ITEMS)])


def store_ml20m_instance(storage, instance_id: str, U, V, user_names,
                         item_names) -> None:
    """A COMPLETED ``ml20m`` instance of the recommendation engine, its
    ALS model made from the factors, through the port's storage."""
    from predictionio_torch.data.metadata import EngineInstance, Model
    from predictionio_torch.models.als import ALSParams, als_model_from_arrays
    import datetime as dt

    model = als_model_from_arrays(U, V, user_names, item_names, rank=RANK)
    now = dt.datetime.now(tz=dt.timezone.utc)
    storage.engine_instances().insert(EngineInstance(
        id=instance_id, status="COMPLETED", start_time=now,
        end_time=now, engine_id="ml20m", engine_version="0",
        engine_variant="default",
        engine_factory=("predictionio_torch.templates.recommendation."
                        "recommendation_engine"),
        data_source_params=json.dumps(
            {"name": "", "params": {"app_name": "ml20m"}}),
        preparator_params=json.dumps({"name": "", "params": {}}),
        algorithms_params=json.dumps([{"name": "als", "params":
            dataclasses.asdict(ALSParams(rank=RANK))}]),
        serving_params=json.dumps({"name": "", "params": {}})))
    storage.models().insert(Model(id=instance_id,
                                  models=pickle.dumps([model])))


def localfs_env(root: str) -> dict:
    """The storage variables of one localfs store at ``root`` holding
    every repository."""
    env = {"PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
           "PIO_STORAGE_SOURCES_FS_PATH": root}
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_NAME"] = repo.lower()
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "FS"
    return env


@contextlib.contextmanager
def cli_env(env: dict):
    """The process's storage variables replaced by ``env`` (and the
    storage singleton reset) for an in-process ``cli.main``; the root
    logger's handlers and level, which ``cli.main`` sets, put back."""
    from predictionio_torch.data import storage as storage_mod

    saved = {k: v for k, v in os.environ.items()
             if k.startswith("PIO_STORAGE_")}
    for k in saved:
        del os.environ[k]
    os.environ.update(env)
    storage_mod.set_storage(None)
    logger = logging.getLogger()
    handlers, level = list(logger.handlers), logger.level
    try:
        yield
    finally:
        for k in env:
            os.environ.pop(k, None)
        os.environ.update(saved)
        storage_mod.set_storage(None)
        for handler in list(logger.handlers):
            if handler not in handlers:
                logger.removeHandler(handler)
        logger.setLevel(level)


def serve_phase(after=None) -> dict:
    """Phase 3. ``after(server, truth, store_env, sent)``, when given,
    runs on
    the live deployment once the serve path's own checks and counts are
    done (phase 3b, the observability phase, then phase 3c, the fleet),
    before the server stops; ``store_env`` names the localfs store that
    holds the served instance, ``sent`` the queries the phase sent. The
    server captures its query payloads
    (``PIO_FLIGHT_PAYLOADS``) for phase 3c's replay."""
    import torch
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.ops.kernels import topk_dot as tkd
    from predictionio_torch.serving.engine_server import EngineServer
    from predictionio_torch.templates.recommendation import (
        recommendation_engine)

    rng = np.random.default_rng(SEED)
    U, V, user_names, item_names = ml20m_factors(rng)
    truth = Truth(U, V, user_names, item_names)

    store = tempfile.mkdtemp(prefix="pio_chip_smoke_")
    server = None
    os.environ["PIO_FLIGHT_PAYLOADS"] = str(FLEET_CAPTURE)
    try:
        store_env = localfs_env(store)
        storage = Storage.from_env(store_env)
        store_ml20m_instance(storage, "ml20m-rank64", U, V, user_names,
                             item_names)

        pick = rng.integers(0, N_USERS, size=40)
        pick_items = rng.integers(0, N_ITEMS, size=12)
        lone = []
        for j in range(20):
            lone.append({"user": user_names[pick[j]], "num": 10})
        for j in range(20, 30):
            top = np.argsort(-(V @ U[pick[j]]))[:3]
            lone.append({"user": user_names[pick[j]], "num": 10,
                         "blacklist": [item_names[t] for t in top]
                         + ["not-an-item"]})
        for j in range(30, 33):
            lone.append({"user": user_names[pick[j]], "num": 100})
        for j in range(10):
            lone.append({"item": item_names[pick_items[j]], "num": 10})
        lone.append({"item": item_names[pick_items[10]], "num": 10,
                     "blacklist": [item_names[pick_items[11]]]})
        kernel_queries = len(lone)
        lone.append({"user": user_names[pick[33]], "num": 5,
                     "whitelist": [item_names[t] for t in
                                   rng.integers(0, N_ITEMS, size=50)]})
        lone.append({"user": "no-such-user", "num": 10})
        lone.append({"user": "another-unknown", "num": 10})
        # k bucket 256 is past the kernel's cap: the scorer's device route
        lone.append({"user": user_names[pick[34]], "num": 200,
                     "blacklist": [item_names[pick_items[0]]]})

        # the main path starts here: deploy, warm up, serve
        tkd.launches.reset()
        t0 = time.perf_counter()
        server = EngineServer(recommendation_engine(), "ml20m",
                              host="127.0.0.1", port=0, storage=storage,
                              device="cuda").start()
        deploy_sec = time.perf_counter() - t0
        status = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/", timeout=60).read())
        plan = status["retrieval"][0]["kernel"]
        if not plan["engaged"] or not plan["device"].startswith("cuda"):
            fail(f"topk_dot not engaged on the card: {plan}")
        before = tkd.launches.value
        lat = []
        for j, q in enumerate(lone):
            t0 = time.perf_counter()
            got = post(server.port, q)
            lat.append(time.perf_counter() - t0)
            check_answer(truth, q, got, f"lone query {j}")
        lone_launches = tkd.launches.value - before

        burst = [{"user": user_names[u], "num": 10}
                 for u in rng.integers(0, N_USERS, size=64)]
        answers = [None] * len(burst)

        def send(j):
            answers[j] = post(server.port, burst[j])

        threads = [threading.Thread(target=send, args=(j,))
                   for j in range(len(burst))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        burst_sec = time.perf_counter() - t0
        for j, (q, got) in enumerate(zip(burst, answers)):
            if got is None:
                fail(f"burst query {j} got no answer")
            check_answer(truth, q, got, f"burst query {j}")
        launches = tkd.launches.value
        status = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/", timeout=60).read())
        if lone_launches < kernel_queries:
            fail(f"topk_dot launched {lone_launches} times for "
                 f"{kernel_queries} lone user/item queries")
        # the burst and the k=200 query went through scorers: on the card
        # they must have taken the device route, never the host's
        served = server.deployment.models[0]
        scorers = [served.scorer(), served.retrieval_index()._fallback()]
        if any(s.placement != "device" or s.device.type != "cuda"
               for s in scorers):
            fail(f"a scorer left the card: "
                 f"{[(s.placement, str(s.device)) for s in scorers]}")
        lat_ms = sorted(1e3 * x for x in lat[:kernel_queries])
        peak_mem = torch.cuda.max_memory_allocated()
        if after is not None:
            after(server, truth, store_env, lone + burst)
        return {
            "launches": launches, "lone_queries": len(lone),
            "lone_kernel_queries": kernel_queries,
            "lone_launches": lone_launches, "burst_queries": len(burst),
            "deploy_sec": deploy_sec, "burst_sec": burst_sec,
            "lone_ms_p50": lat_ms[len(lat_ms) // 2],
            "lone_ms_max": lat_ms[-1],
            "batcher": status["batcher"],
            "device": status["device"],
            "peak_mem_bytes": peak_mem,
        }
    finally:
        os.environ.pop("PIO_FLIGHT_PAYLOADS", None)
        if server is not None:
            server.stop()
        shutil.rmtree(store, ignore_errors=True)


# -- observability phase ------------------------------------------------------

def http_json(port: int, path: str, method: str = "GET"):
    """(status, parsed body) of one request; an HTTP error is a status."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 method=method,
                                 data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            raw, code = resp.read(), resp.status
    except urllib.error.HTTPError as e:
        raw, code = e.read(), e.code
    try:
        return code, json.loads(raw)
    except ValueError:
        return code, raw.decode()


def operator_plane_checks(server, truth: Truth, sent) -> dict:
    """Phase 3b's first checks, held against the queries phase 3 sent
    (``sent``): ``/admin/data``'s unknown-entity ratio, ``/admin/prof``'s
    handler samples under ``/queries.json``, ``/admin/anomaly``,
    ``/admin/tail``, and the observability commands run in process
    against the server, each with the JAX command's exit code."""
    import contextlib
    import io

    from predictionio_torch.obs import anomaly, contprof
    from predictionio_torch.tools import cli

    t_checks = time.perf_counter()
    out = {}
    # the unknown-entity ratio over every ref phase 3's queries named
    refs = unknown = 0
    for q in sent:
        for key, known in (("user", truth.users), ("item", truth.items)):
            if key in q:
                refs += 1
                unknown += q[key] not in known
    code, data = http_json(server.port, "/admin/data")
    if (code != 200 or data["queries_seen"] != refs
            or data["unknown_ratio"] != round(unknown / refs, 4)):
        fail(f"/admin/data: {code}, {data.get('queries_seen')} refs and "
             f"an unknown ratio of {data.get('unknown_ratio')}; phase 3 "
             f"sent {refs} refs, {unknown} unknown")
    out["data"] = {"refs": refs, "unknown": unknown,
                   "unknown_ratio": data["unknown_ratio"]}

    # the continuous profile: handler samples under /queries.json (more
    # lone queries, each checked, until the sampler has caught one)
    extra = 0
    deadline = time.monotonic() + 30
    while True:
        code, prof = http_json(server.port,
                               "/admin/prof?endpoint=/queries.json")
        handler = sum(c["cpu"] + c["wait"] for stack, c in
                      (prof.get("folded") or {}).items()
                      if stack.startswith("[handler]"))
        if code != 200 or handler or time.monotonic() > deadline:
            break
        q = sent[extra % len(sent)]
        check_answer(truth, q, post(server.port, q), "profiled lone query")
        extra += 1
    code_all, whole = http_json(server.port, "/admin/prof")
    ratio = whole.get("overhead_ratio") if code_all == 200 else None
    # a sampler that has sampled has metered its own cost: a ratio of
    # 0 is a clock too coarse to see a pass
    if (code != 200 or not handler or ratio is None or not ratio <= 1
            or not (ratio > 0 or whole["total_samples"] == 0)):
        fail(f"/admin/prof: {code}, {handler} handler samples under "
             f"/queries.json, overhead ratio {ratio} metered on "
             f"{contprof.PROFILER.metering_clock()}")
    out["prof"] = {"handler_samples": handler, "extra_queries": extra,
                   "effective_hz": whole["effective_hz"],
                   "overhead_ratio": ratio,
                   "metering_clock": contprof.PROFILER.metering_clock(),
                   "thread_clock_step_sec": contprof.clock_step(
                       time.thread_time),
                   "total_samples": whole["total_samples"]}

    code, report = http_json(server.port, "/admin/anomaly")
    if code != 200 or set(report) != {"window_sec", "active",
                                      "recent_resolved", "scan_ms"}:
        fail(f"/admin/anomaly: {code} {report}")
    out["anomaly_active"] = sorted(report["active"])
    code, tail = http_json(server.port, "/admin/tail")
    if code != 200 or tail.get("total_count", 0) < len(sent):
        fail(f"/admin/tail: {code}, {tail.get('total_count')} records for "
             f"{len(sent)} queries")
    out["tail"] = {"records": tail["total_count"],
                   "dominant_tail_stage": tail.get("dominant_tail_stage")}

    # the observability commands, in process, against this server
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}/queries.json",
        data=json.dumps(sent[0]).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        trace_id = resp.headers["X-PIO-Trace-Id"]
        check_answer(truth, sent[0], json.loads(resp.read()),
                     "traced lone query")
    url = f"http://127.0.0.1:{server.port}"
    commands = {
        "metrics": (["metrics", "--url", url, "--json"], 0),
        "flight": (["flight", "--url", url, "-n", "5"], 0),
        "trace": (["trace", trace_id, "--url", url], 0),
        "prof": (["prof", "--url", url, "--endpoint", "/queries.json"], 0),
        "journal": (["journal", "--url", url, "-n", "20"], 0),
        "anomalies": (["anomalies", "--url", url],
                      1 if anomaly.SENTINEL.scan()["active"] else 0),
        "data": (["data", "--url", url], 0),
        "mem": (["mem", "--url", url], 0),
        "top": (["top", "--url", url, "--once"], 0),
    }
    root = logging.getLogger()
    saved = (list(root.handlers), root.level)
    exits = {}
    try:
        for name, (argv, want) in commands.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                exits[name] = cli.main(argv)
            if exits[name] != want or not buf.getvalue():
                fail(f"pio {' '.join(argv[:2])} exited {exits[name]} "
                     f"(want {want}): {buf.getvalue()[-500:]}")
    finally:
        # cli.main installs its console log handler on the root logger
        for handler in list(root.handlers):
            if handler not in saved[0]:
                root.removeHandler(handler)
        root.setLevel(saved[1])
    out["cli_exits"] = exits
    out["sec"] = time.perf_counter() - t_checks
    return out


def obs_phase(server, truth: Truth, sent) -> dict:
    """Phase 3b, on phase 3's live deployment: the operator plane's
    routes and commands (``operator_plane_checks``), ``/readyz``,
    ``/metrics`` against the allocator, a ``POST /admin/profile``
    capture over a burst of lone queries, an IVF index over the served
    item factors against ``topk_dot``'s exact answers, and a deploy
    with ``PIO_INDEX_BACKEND=ivf``."""
    import torch
    from predictionio_torch.index.ivf import IVFIndex
    from predictionio_torch.obs import metrics, profiler
    from predictionio_torch.ops.kernels import topk_dot as tkd
    from predictionio_torch.serving.engine_server import EngineServer
    from predictionio_torch.templates.recommendation import (
        recommendation_engine)

    t_phase = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    rng = np.random.default_rng(SEED + 3)
    out = {"card": card,
           "operator_plane": operator_plane_checks(server, truth, sent)}

    # (a) readiness: ready, and the device probe names the card
    code, ready = http_json(server.port, "/readyz")
    devices = ready["probes"]["devices"] if isinstance(ready, dict) else {}
    if code != 200 or ready["status"] == "failed" or \
            devices.get("status") != "ok" or card not in devices["reason"]:
        fail(f"/readyz of the card deployment: {code} {ready}")
    if ready["probes"]["kernels"]["status"] != "ok":
        fail(f"/readyz kernel libraries: {ready['probes']['kernels']}")
    out["readyz"] = {"status": ready["status"],
                     "devices": devices["reason"],
                     "kernels": ready["probes"]["kernels"]["reason"]}

    # (b) /metrics parses, and its device gauges are the allocator's
    kinds = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")

    def allocator():
        st = torch.cuda.memory_stats(0)
        return dict(zip(kinds, (st["allocated_bytes.all.current"],
                                st["allocated_bytes.all.peak"],
                                torch.cuda.mem_get_info(0)[1])))

    for _ in range(3):
        before = allocator()
        code, text = http_json(server.port, "/metrics")
        after = allocator()
        if before == after:
            break
    samples = metrics.samples_dict(text)
    if code != 200 or not samples:
        fail(f"/metrics answered {code} with {len(samples)} samples")
    gauges = {kind: samples.get(
        f'pio_device_memory_bytes{{device="0",kind="{kind}"}}')
        for kind in kinds}
    if gauges != {k: float(v) for k, v in after.items()}:
        fail(f"pio_device_memory_bytes {gauges} != memory_stats {after}")
    out["metrics"] = {"samples": len(samples), "device_memory": gauges}

    # (c) a profile window over a burst of lone queries: the profiler's
    # topk_dot count is the launch counter's
    burst = [{"user": f"u{u}", "num": 10}
             for u in rng.integers(0, N_USERS, size=20)]
    captured = {}

    def capture():
        captured["answer"] = http_json(server.port,
                                       "/admin/profile?seconds=3", "POST")

    thread = threading.Thread(target=capture)
    thread.start()
    deadline = time.monotonic() + 60
    while not profiler.active():
        if time.monotonic() > deadline or not thread.is_alive():
            thread.join(timeout=60)
            fail(f"the profile window never opened: {captured}")
        time.sleep(0.002)
    tkd.launches.reset()
    t0 = time.perf_counter()
    for j, q in enumerate(burst):
        check_answer(truth, q, post(server.port, q), f"profiled query {j}")
    burst_sec = time.perf_counter() - t0
    launched = tkd.launches.value
    window_open = profiler.active()
    thread.join(timeout=120)
    code, prof = captured.get("answer", (None, None))
    if not window_open or code != 200:
        fail(f"the 3 s profile window did not cover the {burst_sec:.2f} s "
             f"burst: {code} {prof}")
    counted = profiler.kernel_count(prof["summary"], "topk_dot")
    if counted != launched or launched != len(burst):
        fail(f"profile counted {counted} topk_dot kernels, the launch "
             f"counter {launched}, for {len(burst)} lone queries")
    out["profile"] = {"queries": len(burst), "launches": launched,
                      "profiled_topk_dot": counted,
                      "window_ms": prof["summary"]["window_ms"],
                      "device_ms": prof["summary"]["device_ms"],
                      "idle_share": prof["summary"]["idle_share"],
                      "burst_sec": burst_sec}

    # (d) IVF over the served item factors against topk_dot's exact top-10
    V = truth.V.astype(np.float32)
    users = rng.choice(N_USERS, 256, replace=False)
    Q = truth.U[users].astype(np.float32)
    items = torch.from_numpy(V).cuda()
    kth = []
    for b in range(0, len(Q), tkd.MAX_BATCH):
        q = torch.from_numpy(Q[b:b + tkd.MAX_BATCH]).cuda()
        excl = torch.full((len(q), 1), -1, dtype=torch.int32, device="cuda")
        s_k, _ = tkd.topk_dot(q, items, excl, 16)
        kth.append(s_k[:, 9].cpu().numpy())
    kth = np.concatenate(kth).astype(np.float64)
    tol = 1e-5 * np.linalg.norm(truth.U[users], axis=1) * truth.vmax
    out["ivf"] = {}
    for quant in ("off", "int8"):
        t0 = time.perf_counter()
        index = IVFIndex(quantize=quant)
        index.build(V)
        build_sec = time.perf_counter() - t0
        _, got = index.search(Q, 10)
        true = np.einsum("bd,bkd->bk", truth.U[users], truth.V[got])
        recall = float(np.mean(true >= kth[:, None] - tol[:, None]))
        if recall < 0.95:
            fail(f"IVF ({quant}) recall@10 {recall} < 0.95 against "
                 "topk_dot over 256 users")
        out["ivf"][quant] = {"recall_at_10": recall, "nprobe": index.nprobe,
                             "nlist": len(index._lists),
                             "measured_recall": index.measured_recall,
                             "build_sec": build_sec}
    del items

    # (e) a deploy whose index is IVF answers lone queries
    prev = os.environ.get("PIO_INDEX_BACKEND")
    os.environ["PIO_INDEX_BACKEND"] = "ivf"
    ivf_server = None
    try:
        t0 = time.perf_counter()
        ivf_server = EngineServer(recommendation_engine(), "ml20m",
                                  host="127.0.0.1", port=0,
                                  storage=server.storage, device="cuda",
                                  micro_batch=False).start()
        deploy_sec = time.perf_counter() - t0
        hits = total = 0
        for q in burst:
            served = post(ivf_server.port, q)["itemScores"]
            ids, _, all_scores = expected_answer(truth, q)
            scores = [e["score"] for e in served]
            if len(served) != len(ids) or scores != sorted(scores,
                                                           reverse=True):
                fail(f"IVF deploy answered {served} for {q}")
            kth_q = all_scores[ids[-1]]
            qtol = 1e-5 * float(np.linalg.norm(
                truth.U[truth.users[q["user"]]])) * truth.vmax
            hits += sum(all_scores[truth.items[e["item"]]] >= kth_q - qtol
                        for e in served)
            total += len(ids)
        code, text = http_json(ivf_server.port, "/metrics")
        shown = metrics.samples_dict(text).get('pio_index_recall{backend="ivf"}')
        stats = http_json(ivf_server.port, "/")[1]["retrieval"][0]
        if shown is None or stats["backend"] != "ivf" or hits / total < 0.95:
            fail(f"IVF deploy: pio_index_recall {shown}, index {stats}, "
                 f"served recall {hits / total}")
        out["ivf_deploy"] = {"queries": len(burst),
                             "served_recall_at_10": hits / total,
                             "pio_index_recall": shown,
                             "nprobe": stats["nprobe"],
                             "deploy_sec": deploy_sec}
    finally:
        if ivf_server is not None:
            ivf_server.stop()
        if prev is None:
            os.environ.pop("PIO_INDEX_BACKEND", None)
        else:
            os.environ["PIO_INDEX_BACKEND"] = prev
    out["phase_sec"] = time.perf_counter() - t_phase
    return out


# -- fleet phase -------------------------------------------------------------

def post_routed(port: int, payload: dict, timeout: float = 60):
    """(status, parsed body or None, headers) of one routed query."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, None, dict(e.headers)


def admin_json(port: int, path: str, body=None):
    """(status, parsed body) of an admin GET, or a POST of ``body``."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def replica_launches(fleet) -> int:
    """The sum of the replicas' ``topk_dot`` launch counts, read from
    each replica process's ``GET /``."""
    total = 0
    for replica in fleet.replicas:
        _, page = admin_json(replica.port, "/")
        total += int(page["retrieval"][0]["kernel_launches"])
    return total


class PushSink:
    """An HTTP sink for ``PIO_PUSH_URL``: keeps every pushed body."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.bodies = []
        sink = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                sink.bodies.append(self.rfile.read(length))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/push"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


def routed_requests(samples: dict) -> float:
    """``pio_http_requests_total`` summed over the ``/queries.json``
    route, from flat samples."""
    return sum(v for k, v in samples.items()
               if k.startswith("pio_http_requests_total{")
               and 'route="/queries.json"' in k)


def federation_checks(router, fleet, truth: Truth, sink) -> dict:
    """Phase 3c's federation checks at the router: the merged request
    count against the replicas' own ``/metrics``, every fleet-scoped
    federation with both members and none degraded, one routed query's
    trace stitched across the router and a replica, and a push from a
    replica at the ``PIO_PUSH_URL`` sink."""
    from predictionio_torch.obs import metrics

    t0 = time.perf_counter()
    out = {}
    names = sorted(r.name for r in fleet.replicas)

    def replicas_total():
        total = 0.0
        for r in fleet.replicas:
            code, text = http_json(r.port, "/metrics")
            if code != 200:
                fail(f"fleet: {r.name}'s /metrics answered {code}")
            total += routed_requests(metrics.samples_dict(text))
        return total

    for _ in range(3):
        before = replicas_total()
        code, merged = admin_json(router.port, "/admin/fleet/metrics")
        after = replicas_total()
        if before == after:
            break
    got = routed_requests(merged.get("samples") or {})
    if code != 200 or got != after or not after:
        fail(f"/admin/fleet/metrics: {code}, merged /queries.json "
             f"requests {got} against the replicas' {after}")
    out["metrics"] = {"queries_requests": got,
                      "members": [m["name"] for m in merged["members"]]}
    for route in ("tail", "prof", "journal", "anomaly", "data"):
        code, report = admin_json(router.port, f"/admin/fleet/{route}")
        members = {m["name"]: m["ok"] for m in report.get("members", [])}
        if code != 200 or members != {n: True for n in names}:
            fail(f"/admin/fleet/{route}: {code}, members {members}")
    out["federations"] = ["metrics", "tail", "prof", "journal", "anomaly",
                          "data"]

    trace_id = os.urandom(16).hex()
    q = {"user": next(iter(truth.users)), "num": 10}
    req = urllib.request.Request(
        f"http://127.0.0.1:{router.port}/queries.json",
        data=json.dumps(q).encode(),
        headers={"Content-Type": "application/json",
                 "X-PIO-Trace-Id": trace_id})
    with urllib.request.urlopen(req, timeout=60) as resp:
        check_answer(truth, q, json.loads(resp.read()), "traced routed query")
    code, doc = admin_json(router.port, f"/admin/trace?id={trace_id}")
    if (code != 200 or not doc.get("complete") or doc.get("missing_spans")
            or not {"router", "engineserver"} <= set(doc.get("processes",
                                                          []))):
        fail(f"/admin/trace of a routed query: {code}, processes "
             f"{doc.get('processes')}, complete {doc.get('complete')}, "
             f"missing {doc.get('missing_spans')}")
    out["trace"] = {"spans": doc["span_count"],
                    "processes": doc["processes"]}

    wait_until(lambda: sink.bodies, 10, "a push from a replica")
    pushed = sink.bodies[-1].decode()
    if "PIOEngineServer" not in pushed or not pushed.rstrip().endswith(
            "# EOF"):
        fail(f"the pushed document: {pushed[-300:]}")
    out["pushes"] = len(sink.bodies)
    out["sec"] = time.perf_counter() - t0
    return out


def wait_until(predicate, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.05)
    fail(f"fleet: timed out waiting for {what}")


def fleet_phase(server, truth: Truth, store_env: dict,
                device=None) -> dict:
    """Phase 3c, beside phase 3's live deployment and over its store: two
    replica processes of ``cli deploy`` on the card behind the query
    router (see the module docstring)."""
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.obs import flight, metrics
    from predictionio_torch.resilience.policy import breaker_for
    from predictionio_torch.serving.fleet import (READY, FleetSupervisor,
                                                  deploy_fleet_argv,
                                                  subprocess_fleet)
    from predictionio_torch.serving.router import QueryRouter
    from predictionio_torch.workflow import replay as replay_mod

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 7)
    root = tempfile.mkdtemp(prefix="pio_chip_smoke_fleet_")
    engine_json = os.path.join(root, "engine.json")
    with open(engine_json, "w") as f:
        json.dump({"id": "default", "engineId": "ml20m",
                   "engineFactory": "predictionio_torch.templates."
                                    "recommendation.recommendation_engine",
                   "datasource": {"params": {"app_name": "ml20m"}},
                   "algorithms": [{"name": "als",
                                   "params": {"rank": RANK}}]}, f)
    sink = PushSink()
    child_env = {**store_env, "PIO_FLIGHT_PAYLOADS": "0",
                 "PIO_SHED_QUEUE_DEPTH": str(FLEET_SHED_QUEUE_DEPTH),
                 "PIO_PUSH_URL": sink.url, "PIO_PUSH_INTERVAL_SEC": "1",
                 "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    # the router's breakers: two failures open one, 2 s re-tests it
    router_env = {"PIO_BREAKER_THRESHOLD": "2",
                  "PIO_BREAKER_RESET_SEC": str(FLEET_BREAKER_RESET_SEC)}
    saved = {k: os.environ.get(k) for k in (*router_env,
                                            "PIO_ROUTER_TIMEOUT")}
    os.environ.update(router_env)
    out = {}
    fleet = router = None
    try:
        # -- boot: two `cli deploy --replicas 1` processes on the card
        argv = deploy_fleet_argv(engine_json, device=device)
        members = subprocess_fleet(FLEET_REPLICAS, argv, env=child_env)
        t0 = time.perf_counter()
        fleet = FleetSupervisor(members, probe_interval=0.05).start()
        ready_at = {}

        def all_ready():
            for r in fleet.replicas:
                if r.state == READY and r.name not in ready_at:
                    ready_at[r.name] = round(time.perf_counter() - t0, 3)
            return len(ready_at) == len(fleet.replicas)

        wait_until(all_ready, 180, "the replicas' first readiness")
        router = QueryRouter(fleet, host="127.0.0.1", port=0).start()
        out["replica_start_sec"] = ready_at
        out["replica_pids"] = {r.name: r.proc.pid for r in fleet.replicas}
        for r in fleet.replicas:
            _, page = admin_json(r.port, "/")
            if not page["device"].startswith(
                    "cuda" if device is None else str(device)):
                fail(f"fleet: replica {r.name} serves on {page['device']}")

        # (a) routed lone queries against float64, on both replicas
        users = rng.integers(0, N_USERS, size=FLEET_LONE_USERS)
        items = rng.integers(0, N_ITEMS, size=FLEET_LONE_ITEMS)
        lone = ([{"user": f"u{u}", "num": 10} for u in users]
                + [{"item": f"i{i}", "num": 10} for i in items])
        before = replica_launches(fleet)
        placed, lat = {}, []
        for j, q in enumerate(lone):
            t_q = time.perf_counter()
            status, got, headers = post_routed(router.port, q)
            lat.append(time.perf_counter() - t_q)
            if status != 200:
                fail(f"fleet (a): routed query {j} answered {status}")
            check_answer(truth, q, got, f"fleet routed query {j}")
            name = headers.get("X-PIO-Replica")
            placed[name] = placed.get(name, 0) + 1
        routed_launches = replica_launches(fleet) - before
        if set(placed) != {r.name for r in fleet.replicas}:
            fail(f"fleet (a): queries placed on {placed} only")
        if routed_launches < len(lone):
            fail(f"fleet (a): the replicas launched topk_dot "
                 f"{routed_launches} times for {len(lone)} routed queries")
        lat_ms = sorted(1e3 * x for x in lat)
        out["answers"] = {"queries": len(lone), "placed": placed,
                          "topk_dot_launches": routed_launches,
                          "routed_ms_p50": lat_ms[len(lat_ms) // 2],
                          "routed_ms_max": lat_ms[-1]}

        # (b) phase 3's captured queries replayed: phase 3's server is
        # the reference, the router the candidate
        payloads = [p for p in flight.RECORDER.payloads()
                    if p["route"] == "/queries.json"]
        if len(payloads) < 50:
            fail(f"fleet (b): {len(payloads)} captured payloads")
        report = replay_mod.replay(
            payloads, candidate=replay_mod.http_target(
                f"http://127.0.0.1:{router.port}"),
            baseline=replay_mod.http_target(
                f"http://127.0.0.1:{server.port}"), k=10)
        tol = 1e-5 * float(np.linalg.norm(truth.U, axis=1).max()) * \
            truth.vmax
        if (report["errors"] != {"baseline": 0, "candidate": 0}
                or report["diffed"] != len(payloads)
                or report["mean_overlap"] != 1.0
                or report["worst_overlap"] != 1.0
                or report["mean_score_delta"] > tol):
            fail(f"fleet (b): replay {report['n']} payloads, diffed "
                 f"{report['diffed']}, errors {report['errors']}, overlap "
                 f"{report['mean_overlap']} (worst "
                 f"{report['worst_overlap']}), score delta "
                 f"{report['mean_score_delta']}")
        out["replay"] = {k: report[k] for k in (
            "n", "diffed", "mean_overlap", "worst_overlap",
            "mean_score_delta", "latency_ms")}
        out["federation"] = federation_checks(router, fleet, truth, sink)

        # (c) a rolling hot-swap onto a second instance, under traffic
        U2, V2, user_names, item_names = ml20m_factors(
            np.random.default_rng(SEED + 8))
        truth2 = Truth(U2, V2, user_names, item_names)
        storage = Storage.from_env(store_env)
        store_ml20m_instance(storage, "ml20m-rank64-b", U2, V2, user_names,
                             item_names)
        del U2, V2
        swap_errors, swap_answers = [], []
        stop = threading.Event()

        def loader():
            k = 0
            while not stop.is_set():
                q = {"user": f"u{users[k % len(users)]}", "num": 10}
                k += 1
                status, got, _ = post_routed(router.port, q)
                if status != 200:
                    swap_errors.append(status)
                else:
                    swap_answers.append((q, got))

        loading = threading.Thread(target=loader)
        loading.start()
        try:
            t_swap = time.perf_counter()
            code, _ = admin_json(router.port, "/reload")
            if code != 202:
                fail(f"fleet (c): GET /reload answered {code}")
            snap = wait_until(lambda: (lambda s: s if (
                not s["swap"]["active"] and s["swap"]["last"])
                else None)(fleet.snapshot()), 120, "the rolling swap")
            swap_sec = time.perf_counter() - t_swap
        finally:
            stop.set()
            loading.join(timeout=120)
        if snap["swap"]["last"]["outcome"] != "ok" or swap_errors:
            fail(f"fleet (c): swap {snap['swap']['last']}, failed "
                 f"queries {swap_errors[:5]}")
        versions = {r.name: admin_json(r.port, "/")[1]["engineInstanceId"]
                    for r in fleet.replicas}
        if set(versions.values()) != {"ml20m-rank64-b"}:
            fail(f"fleet (c): replicas serve {versions} after the swap")
        # an answer during the swap is the first instance's or the
        # second's; every answer after it the second's
        for q, got in swap_answers:
            try:
                check_answer(truth2, q, got, "fleet swap")
            except SystemExit:     # not the second's: the first's then
                check_answer(truth, q, got, "fleet swap")
        for j, u in enumerate(users[:8]):
            q = {"user": f"u{u}", "num": 10}
            status, got, _ = post_routed(router.port, q)
            if status != 200:
                fail(f"fleet (c): query after the swap answered {status}")
            check_answer(truth2, q, got, f"fleet query {j} after the swap")
        out["rolling_reload"] = {"swap_sec": round(swap_sec, 3),
                                 "queries_during": len(swap_answers),
                                 "failed_during": len(swap_errors),
                                 "swapped": snap["swap"]["last"]["swapped"]}

        # (d) a chaos rule tagged to r1: its dispatches hang, its attempts
        # time out at the router and open its breaker; the hedge answers
        # from r0 meanwhile
        os.environ["PIO_ROUTER_TIMEOUT"] = str(FLEET_ROUTER_TIMEOUT)
        hung = fleet.replicas[1]
        hedges = metrics.REGISTRY.get("pio_router_hedges_total").value
        rescues = metrics.REGISTRY.get(
            "pio_router_hedge_rescues_total").value
        code, rules = admin_json(hung.port, "/admin/chaos", {
            "spec": f"batcher@{hung.name}:hang:{FLEET_HANG_SEC}s"})
        if code != 200 or not rules["enabled"]:
            fail(f"fleet (d): POST /admin/chaos answered {code} {rules}")
        breaker = breaker_for(f"replica:{hung.name}")
        chaos_statuses, chaos_placed = [], {}
        t_chaos = time.perf_counter()

        def chaos_query():
            status, got, headers = post_routed(
                router.port, {"user": f"u{users[0]}", "num": 10})
            chaos_statuses.append(status)
            name = headers.get("X-PIO-Replica")
            chaos_placed[name] = chaos_placed.get(name, 0) + 1
            return breaker.state == "open"

        wait_until(chaos_query, 60, f"{hung.name}'s breaker to open")
        open_sec = time.perf_counter() - t_chaos
        after_open = dict(chaos_placed)
        for _ in range(10):
            chaos_query()
        served_after = {k: chaos_placed[k] - after_open.get(k, 0)
                        for k in chaos_placed}
        admin_json(hung.port, "/admin/chaos", {"clear": True})
        os.environ.pop("PIO_ROUTER_TIMEOUT")
        if set(chaos_statuses) != {200} or served_after.get(hung.name):
            fail(f"fleet (d): statuses {chaos_statuses}, placed after "
                 f"the breaker opened {served_after}")
        wait_until(lambda: not chaos_query() and breaker.state == "closed",
                   60, f"{hung.name}'s breaker to close")
        out["chaos"] = {
            "rule": f"batcher@{hung.name}:hang:{FLEET_HANG_SEC}s",
            "breaker_open_sec": round(open_sec, 3),
            "queries": len(chaos_statuses),
            "hedges": metrics.REGISTRY.get(
                "pio_router_hedges_total").value - hedges,
            "hedge_rescues": metrics.REGISTRY.get(
                "pio_router_hedge_rescues_total").value - rescues}
        if set(chaos_statuses) != {200}:
            fail(f"fleet (d): statuses while recovering {chaos_statuses}")

        # (e) admission: a concurrent burst past the replicas' low queue
        # limit, with every dispatch slowed by a chaos latency rule (the
        # overload), is shed with 429 + Retry-After, never a 5xx
        for r in fleet.replicas:
            code, _ = admin_json(r.port, "/admin/chaos", {
                "spec": f"batcher:latency:{FLEET_BURST_LATENCY_MS}ms"})
            if code != 200:
                fail(f"fleet (e): POST /admin/chaos answered {code}")
        burst_queries = [{"user": f"u{u}", "num": 10} for u in
                         rng.integers(0, N_USERS, size=FLEET_BURST)]
        burst = [None] * FLEET_BURST
        go = threading.Event()

        def send(j):
            go.wait()
            burst[j] = post_routed(router.port, burst_queries[j])

        threads = [threading.Thread(target=send, args=(j,))
                   for j in range(FLEET_BURST)]
        for t in threads:
            t.start()
        go.set()
        for t in threads:
            t.join(timeout=120)
        for r in fleet.replicas:
            admin_json(r.port, "/admin/chaos", {"clear": True})
        statuses = [b[0] if b else None for b in burst]
        shed = [b for b in burst if b and b[0] == 429]
        if (not shed or set(statuses) - {200, 429}
                or any("Retry-After" not in b[2] for b in shed)):
            fail(f"fleet (e): burst statuses {sorted(map(str, statuses))}")
        for j, b in enumerate(burst):
            if b[0] == 200:
                check_answer(truth2, burst_queries[j], b[1],
                             f"fleet burst query {j}")
        resilience = {r.name: admin_json(r.port, "/admin/resilience")[1]
                      for r in fleet.replicas}
        slo_reports = {r.name: admin_json(r.port, "/admin/slo")[1]
                       for r in fleet.replicas}
        shed_total = sum(v["admission"]["shedTotal"]
                         for v in resilience.values())
        if shed_total < len(shed):
            fail(f"fleet (e): /admin/resilience counts {shed_total} sheds "
                 f"for {len(shed)} 429s")
        out["admission"] = {
            "burst": FLEET_BURST, "dispatch_latency_ms": FLEET_BURST_LATENCY_MS,
            "ok": statuses.count(200),
            "shed_429": len(shed),
            "retry_after": sorted({b[2]["Retry-After"] for b in shed}),
            "shed_total": shed_total,
            "limits": resilience[fleet.replicas[0].name]["admission"][
                "limits"],
            "slo": {name: {e["name"]: e["state"] for e in rep["slos"]}
                    for name, rep in slo_reports.items()}}

        # (f) kill -9 of a replica: queries stay 200, the supervisor
        # restarts it into rotation
        victim = fleet.replicas[0]
        old_pid = victim.proc.pid
        os.kill(old_pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        kill_statuses = []
        for j in range(FLEET_KILL_QUERIES):
            status, got, _ = post_routed(
                router.port, {"user": f"u{users[j]}", "num": 10})
            kill_statuses.append(status)
            if status == 200:
                check_answer(truth2, {"user": f"u{users[j]}", "num": 10},
                             got, f"fleet query {j} after the kill")
        if set(kill_statuses) != {200}:
            fail(f"fleet (f): statuses after the kill {kill_statuses}")
        wait_until(lambda: victim.restarts >= 1 and victim.state == READY,
                   180, f"{victim.name}'s restart")
        restart_sec = time.perf_counter() - t_kill
        if victim.proc.pid == old_pid:
            fail("fleet (f): the restarted replica kept the killed pid")
        _, page = admin_json(victim.port, "/")
        if page["engineInstanceId"] != "ml20m-rank64-b":
            fail(f"fleet (f): the restarted replica serves "
                 f"{page['engineInstanceId']}")
        status, got, headers = post_routed(
            victim.port, {"user": f"u{users[1]}", "num": 10})
        if status != 200:
            fail(f"fleet (f): the restarted replica answered {status}")
        check_answer(truth2, {"user": f"u{users[1]}", "num": 10}, got,
                     "fleet restarted replica")
        out["restart"] = {"restart_sec": round(restart_sec, 3),
                          "queries_after_kill": len(kill_statuses),
                          "restarts": victim.restarts}
        out["snapshot"] = {r["name"]: {k: r[k] for k in (
            "state", "version", "restarts")}
            for r in fleet.snapshot()["replicas"]}
        out["phase_sec"] = round(time.perf_counter() - t_phase, 3)
        return out
    finally:
        if router is not None:
            router.stop()
        if fleet is not None:
            fleet.stop()
        sink.stop()
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        shutil.rmtree(root, ignore_errors=True)


# -- two-tower kernel phase ---------------------------------------------------

def ce_batch(B, D, gen, uniform_w):
    """Unit-norm towers, ids drawn from small ranges (many in-batch
    duplicate users and items), a zero-weight tail of B // 16 rows."""
    import torch

    dev = torch.device("cuda")
    u = torch.nn.functional.normalize(
        torch.randn((B, D), generator=gen, device=dev), dim=1)
    v = torch.nn.functional.normalize(
        torch.randn((B, D), generator=gen, device=dev), dim=1)
    w = (torch.ones(B, device=dev) if uniform_w
         else 0.5 + 4.0 * torch.rand(B, generator=gen, device=dev))
    w[B - max(1, B // 16):] = 0.0
    return (u, v, torch.randint(0, max(2, B // 3), (B,), generator=gen,
                                device=dev),
            torch.randint(0, max(2, B // 4), (B,), generator=gen, device=dev),
            w)


def ce_step(fn, u, v, u_idx, i_idx, w, cdt):
    """One loss forward and backward: (loss, du, dv)."""
    u = u.detach().requires_grad_(True)
    v = v.detach().requires_grad_(True)
    loss = fn(u, v, u_idx, i_idx, w, TEMP, cdt)
    loss.backward()
    return loss.detach(), u.grad, v.grad


def grad_close(g, r, cdt_name: str):
    """(agrees, ||g - r|| / ||r||): ``g`` against the plain version's
    ``r`` under ``GRAD_TOLS[cdt_name]``."""
    rtol, atol, atol_scaled, norm_tol = GRAD_TOLS[cdt_name]
    err = (g - r).abs()
    rel_norm = float((g - r).norm() / r.norm())
    agrees = (not bool((err > atol + rtol * r.abs()).any())
              and not bool((err > atol_scaled * r.abs().max()
                            + rtol * r.abs()).any())
              and rel_norm <= norm_tol)
    return agrees, rel_norm


def grad_controls(g, r, cdt_name: str) -> dict:
    """Deliberately wrong gradients that ``grad_close`` must refuse at
    the shape it checks: zeros, rows shifted by one (a permuted coef),
    a 10% scale error, one 64-row tile zeroed. -> their relative
    errors."""
    import torch

    tile = g.clone()
    tile[:64] = 0.0
    wrong = {"zeros": torch.zeros_like(g), "rows_shifted": g.roll(1, 0),
             "scaled_0.9": 0.9 * g, "one_tile_zeroed": tile}
    out = {}
    for name, bad in wrong.items():
        agrees, rel_norm = grad_close(bad, r, cdt_name)
        if agrees:
            fail(f"flash_ce gradient check passed a wrong gradient "
                 f"({name}, {cdt_name}): it cannot catch a broken kernel")
        out[name] = rel_norm
    return out


def flash_ce_phase() -> dict:
    import torch
    from predictionio_torch.ops import kernels
    from predictionio_torch.ops.kernels import flash_ce as fce
    from predictionio_torch.tools.device_time import (
        BF16_FLOPS, HBM_BYTES_PER_S, SFU_PER_S, call_ms, profile_call)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    max_err, cases = 0.0, 0
    rel_norm_max = {"float32": 0.0, "bfloat16": 0.0}
    controls = {}
    for B in (128, 130, 1000, 8192):
        for D in (8, 64, 128, 256):
            for cdt in (torch.float32, torch.bfloat16):
                for uniform_w in (True, False):
                    batch = ce_batch(B, D, gen, uniform_w)
                    got = ce_step(fce.flash_ce, *batch, cdt)
                    want = ce_step(fce.flash_ce_reference, *batch, cdt)
                    torch.cuda.synchronize()
                    cdt_name = str(cdt).split(".")[-1]
                    l_rtol = 1e-5 if cdt == torch.float32 else 5e-3
                    what = f"B={B} D={D} cdt={cdt_name} uniform_w={uniform_w}"
                    if not bool(torch.isfinite(got[0])) or abs(
                            float(got[0] - want[0])) > l_rtol * abs(
                            float(want[0])):
                        fail(f"flash_ce loss differs ({what}): "
                             f"{float(got[0])} vs {float(want[0])}")
                    for name, g, r in (("du", got[1], want[1]),
                                       ("dv", got[2], want[2])):
                        agrees, rel_norm = grad_close(g, r, cdt_name)
                        if not agrees:
                            fail(f"flash_ce {name} differs ({what}): max "
                                 f"err {float((g - r).abs().max())}, max "
                                 f"|ref| {float(r.abs().max())}, relative "
                                 f"norm err {rel_norm}")
                        max_err = max(max_err, float((g - r).abs().max()))
                        rel_norm_max[cdt_name] = max(rel_norm_max[cdt_name],
                                                     rel_norm)
                        if B == TT_BATCH and D == TT_DIM and uniform_w:
                            controls[f"{name},{cdt_name}"] = grad_controls(
                                g, r, cdt_name)
                    cases += 1

    # timing at the train phase's shape: one loss forward and backward
    B, D, cdt = TT_BATCH, TT_DIM, torch.bfloat16
    batch = ce_batch(B, D, gen, True)
    # partials summed in a fixed order, no atomics: the same bits twice
    first, second = (ce_step(fce.flash_ce, *batch, cdt) for _ in range(2))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        fail("flash_ce is not deterministic: two calls at B=8192, D=128 "
             "gave different loss or gradients")
    kernel = lambda: ce_step(fce.flash_ce, *batch, cdt)  # noqa: E731
    plain = lambda: ce_step(fce.flash_ce_reference, *batch, cdt)  # noqa: E731
    kernel_call_ms, plain_call_ms = call_ms(kernel, 50), call_ms(plain, 10)
    traced, plain_ms = profile_call(kernel, 20), profile_call(plain, 5)["ms"]
    # necessary work: 2 B^2 D products forward and 4 B^2 D backward on
    # the tensor cores (the kernels' logits recompute is a cost of their
    # design), B^2 exponentials forward and 2 B^2 backward on the
    # special-function units; each runs at its own peak, so the larger
    # of the two times (and of the bytes') bounds the kernels
    products_ms = 6.0 * B * B * D / BF16_FLOPS * 1e3
    exps_ms = 3.0 * B * B / SFU_PER_S * 1e3
    bytes_ms = (4 * B * D * 4 + B * (8 + 8 + 4)) / HBM_BYTES_PER_S * 1e3
    ops_ms = max(products_ms, exps_ms)
    kernel_split = own_split(traced["split"], "flash_ce_kernel")
    # the backward kernel is the one template instance with BWD = true
    bwd_ms = sum(ms for name, ms in kernel_split.items()
                 if name.startswith("flash_ce_kernel") and "true" in name)
    fwd_ms = sum(ms for name, ms in kernel_split.items()
                 if name.startswith("flash_ce_kernel") and "true" not in name)
    return {
        "name": "flash_ce", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "max_abs_err": max_err,
        "ms": traced["ms"], "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bound_terms_ms": {"products": products_ms, "exps": exps_ms,
                           "bytes": bytes_ms},
        "grad_rel_norm_err_max": rel_norm_max,
        "grad_controls_rel_norm_err": controls,
        "library_ms": None,
        "library_note": "no single PyTorch call computes this loss",
        "call_ms": kernel_call_ms, "plain_call_ms": plain_call_ms,
        "device_split_ms": kernel_split, "fwd_ms": fwd_ms,
        "bwd_ms": bwd_ms,
        "deterministic": True, "split": fce.split_for(B),
        "ptxas": kernels.ptxas_report("flash_ce"),
        "cases": cases, "shape": f"B={B},D={D},cdt=bfloat16,fwd+bwd",
    }


def embed_update_phase() -> dict:
    import torch
    from predictionio_torch.ops.kernels import embed_update as eu
    from predictionio_torch.tools.device_time import (
        F32_FLOPS, HBM_BYTES_PER_S, call_ms, profile_call)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    max_err = 0.0
    for N, E, B, vocab in ((64, 24, 37, 64), (50, 8, 24, 6),
                           (TT_IDS, TT_DIM, TT_BATCH, TT_IDS)):
        table = torch.randn((N, E), generator=gen, device=dev)
        idx = torch.randint(0, vocab, (B,), generator=gen, device=dev)
        grad = torch.randn((B, E), generator=gen, device=dev)
        scale = torch.rand(B, generator=gen, device=dev)
        want = eu.embed_update_reference(table.clone(), idx, grad, scale)
        eu.embed_update(table, idx, grad, scale)
        torch.cuda.synchronize()
        err = (table - want).abs()
        if bool((err > 1e-6 + 1e-5 * want.abs()).any()):
            fail(f"embed_update differs at N={N} E={E} B={B}: max err "
                 f"{float(err.max())}")
        max_err = max(max_err, float(err.max()))

    # timing at the train phase's shape: 8192 rows into a [1M, 128] table
    scale = scale * 1e-6          # the timed calls keep adding in place
    kernel = lambda: eu.embed_update(table, idx, grad, scale)  # noqa: E731
    plain = lambda: eu.embed_update_reference(  # noqa: E731
        table, idx, grad, scale)
    library = lambda: table.index_add_(  # noqa: E731
        0, idx, -scale[:, None] * grad)
    k_call, p_call, l_call = (call_ms(f) for f in (kernel, plain, library))
    warm_ms, plain_warm_ms, library_warm_ms = (
        profile_call(f)["ms"] for f in (kernel, plain, library))
    # the bound is HBM's: time each call with L2 flushed before it (the
    # warm times above find the rows and gradients in the 50 MB L2)
    kernel_ms, plain_ms, library_ms = (
        profile_call(f, 50, cold=True)["ms"]
        for f in (kernel, plain, library))
    touched = int(torch.unique(idx).numel())
    nbytes = B * E * 4 + B * 8 + B * 4 + 2 * touched * E * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * B * E / F32_FLOPS * 1e3
    return {
        "name": "embed_update", "route": "cuda", "source": EMBED_SOURCE,
        "replaces": EMBED_REPLACES, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "library_note": "table.index_add_(0, idx, -scale[:, None] * grad)",
        "warm_ms": warm_ms, "plain_warm_ms": plain_warm_ms,
        "library_warm_ms": library_warm_ms, "timing": "ms: cold L2",
        "call_ms": k_call, "plain_call_ms": p_call, "library_call_ms": l_call,
        "touched_rows": touched, "shape": f"N={N},E={E},B={B}",
    }


# -- train phase ---------------------------------------------------------------

def synth_positives():
    """bench.py's stretch positives: 64 clusters, 80% in-cluster."""
    rng = np.random.default_rng(1)
    n_clusters = 64
    user_cluster = rng.integers(0, n_clusters, size=TT_IDS)
    uu = rng.integers(0, TT_IDS, size=TT_POS)
    in_cluster = rng.random(TT_POS) < 0.8
    per_cluster = TT_IDS // n_clusters
    ii = np.where(
        in_cluster,
        user_cluster[uu] + n_clusters * rng.integers(0, per_cluster, TT_POS),
        rng.integers(0, TT_IDS, size=TT_POS)).astype(np.int64)
    return uu.astype(np.int64), ii


def step_profile(uu, ii, steps: int = 20) -> dict:
    """Where a steady stretch-width step's time goes: a trainer at the
    train phase's widths on its first ``steps`` batches runs one warm-up
    epoch, one timed epoch and one under ``torch.profiler``; device time
    by kernel group per step, and the device's idle share (1 - device
    time over the timed epoch's wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from predictionio_torch.ops.twotower import (TwoTowerConfig,
                                                 TwoTowerTrainer)

    n = steps * TT_BATCH
    cfg = TwoTowerConfig(dim=TT_DIM, batch_size=TT_BATCH, epochs=3,
                         learning_rate=3e-3, seed=11, temperature=TEMP)
    trainer = TwoTowerTrainer((uu[:n], ii[:n], None), TT_IDS, TT_IDS, cfg,
                              device="cuda")
    trainer.run(epochs=2)
    wall_ms = trainer.epoch_seconds[1] * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.run(epochs=3)
        torch.cuda.synchronize()
    groups = {"flash_ce": 0.0, "embed_update": 0.0, "torch ops": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        group = next((g for g in ("flash_ce", "embed_update")
                      if g + "_kernel" in e.key), "torch ops")
        groups[group] += e.self_device_time_total / 1e3 / steps
    device_ms = sum(groups.values())
    return {"steps": steps, "wall_ms_per_step": wall_ms,
            "device_ms_per_step": device_ms,
            "device_ms_by_group": groups,
            "device_idle_share": 1.0 - device_ms / wall_ms}


def deploy_and_check(engine, storage, engine_id: str, truth: Truth,
                     queries, what: str) -> dict:
    """Deploy the engine's latest instance with the port's EngineServer
    on the card and check every answer."""
    from predictionio_torch.serving.engine_server import EngineServer

    server = EngineServer(engine, engine_id, host="127.0.0.1", port=0,
                          storage=storage, device="cuda").start()
    try:
        lat = []
        for j, q in enumerate(queries):
            t0 = time.perf_counter()
            got = post(server.port, q)
            lat.append(1e3 * (time.perf_counter() - t0))
            check_answer(truth, q, got, f"{what} query {j}")
        lat.sort()
        return {"queries": len(queries), "ms_p50": lat[len(lat) // 2],
                "ms_max": lat[-1]}
    finally:
        server.stop()


def tt_queries(truth: Truth, rng, n_users: int, n_items: int):
    users = [f"u{j}" for j in rng.integers(0, n_users, 12)]
    items = [truth.item_names[j] for j in rng.integers(0, n_items, 6)]
    qs = [{"user": u, "num": 10} for u in users]
    qs += [{"item": i, "num": 10} for i in items]
    qs.append({"user": users[0], "num": 20, "blacklist": items[:2]})
    qs.append({"user": "no-such-user", "num": 10})
    return qs


def train_phase() -> dict:
    import datetime as dt

    import torch
    from predictionio_torch.data.metadata import EngineInstance, Model
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.data.bimap import BiMap
    from predictionio_torch.models.als import PreparedRatings
    from predictionio_torch.models.twotower import (TwoTowerAlgorithm,
                                                    TwoTowerParams)
    from predictionio_torch.ops.kernels import embed_update as eu
    from predictionio_torch.ops.kernels import flash_ce as fce
    from predictionio_torch.ops.kernels import topk_dot as tkd
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.obs import metrics, perfacct
    from predictionio_torch.templates.twotower import twotower_engine
    from predictionio_torch.workflow.train import serialize_models

    t0 = time.perf_counter()
    uu, ii = synth_positives()
    user_names = [f"u{j}" for j in range(TT_IDS)]
    item_names = [f"i{j}" for j in range(TT_IDS)]
    pd = PreparedRatings(user_ids=BiMap.from_vocab(user_names),
                         item_ids=BiMap.from_vocab(item_names),
                         user_idx=uu, item_idx=ii,
                         ratings=np.ones(TT_POS, np.float32))
    setup_sec = time.perf_counter() - t0
    params = TwoTowerParams(dim=TT_DIM, batch_size=TT_BATCH, epochs=TT_EPOCHS,
                            learning_rate=3e-3, seed=11, temperature=TEMP)
    algo = TwoTowerAlgorithm(params)

    # the main path starts here: train, serialize, deploy, serve
    for counter in (fce.launches, eu.launches, tkd.launches):
        counter.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = algo.train(DeviceContext("cuda"), pd)
    train_sec = time.perf_counter() - t0
    flash_launches, embed_launches = fce.launches.value, eu.launches.value
    # the trainer's live MFU gauge (obs/perfacct.py), set from its last
    # epoch: read before any other trainer in this process sets it
    mfu = metrics.REGISTRY.get("pio_train_mfu").labels("twotower").value
    peak_mem = torch.cuda.max_memory_allocated()
    plan = model.kernel_plan
    if not (plan["flash_ce"] and plan["embed_update"]):
        fail(f"the trainer did not plan both kernels: {plan}")
    steps = -(-TT_POS // TT_BATCH) * TT_EPOCHS
    if flash_launches != 3 * steps or embed_launches != 2 * steps:
        fail(f"{steps} steps launched flash_ce {flash_launches} times "
             f"(want {3 * steps}) and embed_update {embed_launches} times "
             f"(want {2 * steps})")
    losses = model.train_losses
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"two-tower losses not finite and falling: {losses}")
    for side, vecs in (("user", model.user_factors),
                       ("item", model.item_factors)):
        norms = np.linalg.norm(vecs, axis=1)
        if not np.all(np.abs(norms - 1.0) < 1e-4):
            fail(f"{side} vectors not unit-norm: {norms.min()}..{norms.max()}")

    storage = Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    now = dt.datetime.now(tz=dt.timezone.utc)
    storage.engine_instances().insert(EngineInstance(
        id="tt-stretch", status="COMPLETED", start_time=now, end_time=now,
        engine_id="tt-stretch", engine_version="0", engine_variant="default",
        engine_factory="predictionio_torch.templates.twotower.twotower_engine",
        data_source_params=json.dumps({"name": "", "params": {}}),
        preparator_params=json.dumps({"name": "", "params": {}}),
        algorithms_params=json.dumps([{"name": "twotower", "params":
                                       dataclasses.asdict(params)}]),
        serving_params=json.dumps({"name": "", "params": {}})))
    storage.models().insert(Model(id="tt-stretch",
                                  models=serialize_models([model])))
    truth = Truth(model.user_factors, model.item_factors, user_names,
                  item_names)
    epoch_sec = [float(x) for x in model.train_epoch_seconds]
    tables = (model.user_factors, model.item_factors)
    del model
    served = deploy_and_check(twotower_engine(), storage, "tt-stretch", truth,
                              tt_queries(truth, np.random.default_rng(SEED),
                                         TT_IDS, TT_IDS), "train phase")
    topk_launches = tkd.launches.value
    profiled = step_profile(uu, ii)

    steady = min(epoch_sec[1:])
    steps_per_epoch = steps // TT_EPOCHS
    # the gauge against this phase's own clock: the last epoch's steps
    last_step_ms = epoch_sec[-1] / steps_per_epoch * 1e3
    want = (perfacct.twotower_matmul_flops(TT_BATCH, TT_DIM, [TT_DIM])
            / (last_step_ms / 1e3) / perfacct.peak_flops())
    if not (0.0 < mfu <= 1.0) or abs(mfu - want) > 1e-9 * want:
        fail(f"pio_train_mfu {mfu}: want {want} in (0, 1] from the last "
             f"epoch's {last_step_ms:.3f} ms steps")
    return {
        "config": {"users": TT_IDS, "items": TT_IDS, "positives": TT_POS,
                   "dim": TT_DIM, "batch": TT_BATCH, "epochs": TT_EPOCHS,
                   "compute_dtype": "bfloat16", "temperature": TEMP},
        "setup_sec": setup_sec, "train_sec": train_sec,
        "epoch_sec": epoch_sec, "steps_per_epoch": steps_per_epoch,
        "step_ms": steady / steps_per_epoch * 1e3,
        "examples_per_sec": steps_per_epoch * TT_BATCH / steady,
        "losses": losses, "final_loss": losses[-1],
        "loss_bar_0.75_ln_batch": 0.75 * float(np.log(TT_BATCH)),
        "flash_ce_launches": flash_launches,
        "embed_update_launches": embed_launches,
        "topk_dot_launches": topk_launches, "kernel_plan": plan,
        "peak_train_mem_bytes": peak_mem, "serve": served,
        "step_profile": profiled,
        "train_mfu": {"pio_train_mfu": mfu, "last_epoch_step_ms":
                      last_step_ms, "peak_flops": perfacct.peak_flops()},
    }, tables


# -- ALS train phase -----------------------------------------------------------

def synth_ratings():
    """bench.py's ``synthesize`` at DEFAULT_KNOBS from ``default_rng(0)``:
    ratings with planted rank-8 structure, clip(3 + 1.2 z + noise) in
    half-stars, over Zipf-popular items."""
    rng = np.random.default_rng(0)
    n = ALS_RATINGS
    uu = rng.integers(0, N_USERS, size=n, dtype=np.int64)
    ii = (rng.zipf(1.2, size=n) % N_ITEMS).astype(np.int64)
    U = rng.normal(size=(N_USERS, 8)).astype(np.float32)
    V = rng.normal(size=(N_ITEMS, 8)).astype(np.float32)
    z = np.einsum("nk,nk->n", U[uu], V[ii]) / np.sqrt(8.0)
    raw = 3.0 + 1.2 * z + rng.normal(0, 0.35, size=n).astype(np.float32)
    vals = np.clip(np.round(raw * 2.0) / 2.0, 0.5, 5.0).astype(np.float64)
    return uu, ii, vals


def store_and_deploy(model, params, instance_id: str, user_names,
                     item_names, what: str) -> dict:
    """A trained ALS model as a COMPLETED engine instance and its blob in
    a memory store, deployed with the port's EngineServer on the card
    and asked 20 queries, each checked against a float64 host top-k of
    the model's factors."""
    import datetime as dt

    from predictionio_torch.data.metadata import EngineInstance, Model
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.templates.recommendation import (
        recommendation_engine)
    from predictionio_torch.workflow.train import serialize_models

    storage = Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    now = dt.datetime.now(tz=dt.timezone.utc)
    storage.engine_instances().insert(EngineInstance(
        id=instance_id, status="COMPLETED", start_time=now, end_time=now,
        engine_id=instance_id, engine_version="0", engine_variant="default",
        engine_factory=("predictionio_torch.templates.recommendation."
                        "recommendation_engine"),
        data_source_params=json.dumps({"name": "", "params": {}}),
        preparator_params=json.dumps({"name": "", "params": {}}),
        algorithms_params=json.dumps([{"name": "als", "params":
                                       dataclasses.asdict(params)}]),
        serving_params=json.dumps({"name": "", "params": {}})))
    storage.models().insert(Model(id=instance_id,
                                  models=serialize_models([model])))
    truth = Truth(model.user_factors, model.item_factors, user_names,
                  item_names)
    queries = tt_queries(truth, np.random.default_rng(SEED + 5),
                         len(user_names), len(item_names))
    lone = sum(1 for q in queries if "item" in q or q["user"] in truth.users)
    served = deploy_and_check(recommendation_engine(), storage, instance_id,
                              truth, queries, what)
    return {**served, "lone_queries": lone}


#: the put sweep's settings, in run order: PIO_BIN_CHUNK_MB, or None
#: for the one-shot put (PIO_TRANSFER_DOUBLE_BUFFER=0); the one-shot put
#: first and last, so that a drift of the host shows
PUT_SWEEP = (None, 8.0, 32.0, 64.0, None)


def put_sweep(key: str, cfg, trainer) -> dict:
    """The ALS layout put again from its cache entry (a file mapping,
    warm in the page cache after its save) at each of ``PUT_SWEEP``'s
    settings: ``put_sec`` (the copies, the index recombine and a full
    sync), ``transfer_sec`` (first put to last copy) and the chunks;
    every setting's device tensors must equal ``trainer``'s (put from
    the host arrays) bit for bit."""
    import torch
    from predictionio_torch.ops.als import ALSTrainer, load_layout

    want = [t for side in trainer.sides()
            for t in (side.idx, side.val, side.mask, side.seg, side.counts)
            if t is not None]
    saved = {k: os.environ.get(k) for k in ("PIO_BIN_CHUNK_MB",
                                            "PIO_TRANSFER_DOUBLE_BUFFER")}
    points = []
    try:
        for mb in PUT_SWEEP:
            if mb is None:
                os.environ["PIO_TRANSFER_DOUBLE_BUFFER"] = "0"
            else:
                os.environ.pop("PIO_TRANSFER_DOUBLE_BUFFER", None)
                os.environ["PIO_BIN_CHUNK_MB"] = str(mb)
            cached = load_layout(key)
            if cached is None:
                fail("the ALS phase's layout is not in its cache")
            put = ALSTrainer.from_cache(cached, cfg, device="cuda")
            got = [t for side in put.sides()
                   for t in (side.idx, side.val, side.mask, side.seg,
                             side.counts) if t is not None]
            if len(got) != len(want) or not all(
                    a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in zip(got, want)):
                fail(f"the put at PIO_BIN_CHUNK_MB={mb} does not hold the "
                     "host put's device tensors")
            points.append({"chunk_mb": mb, "put_sec": put.put_sec,
                           "transfer_sec": put.transfer_sec,
                           "chunks": put.put_chunks,
                           "load_sec": cached.load_sec})
            del put, got, cached
        if points[0]["chunks"] or not points[1]["chunks"]:
            fail(f"the put sweep did not take its paths: {points}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"bytes": trainer.transfer_bytes, "points": points}


def als_train_phase(ratings) -> dict:
    import torch
    from predictionio_torch.data.bimap import BiMap
    from predictionio_torch.models.als import (ALSAlgorithm, ALSParams,
                                               PreparedRatings)
    from predictionio_torch.ops.als import (ALSConfig, ALSFactors,
                                            ALSTrainer, layout_cache_key,
                                            predict_rmse)
    from predictionio_torch.ops.kernels import embed_update as eu
    from predictionio_torch.ops.kernels import flash_ce as fce
    from predictionio_torch.ops.kernels import topk_dot as tkd
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.tools.als_timing import stage_profile

    uu, ii, vals = ratings
    hold = np.arange(ALS_RATINGS) % 20 == 0          # bench's 5% holdout
    train = (uu[~hold], ii[~hold], vals[~hold].astype(np.float32))
    held = (uu[hold], ii[hold], vals[hold])
    cfg = ALSConfig(rank=RANK, iterations=ALS_ITERS, reg=ALS_REG,
                    block_size=ALS_BLOCK)

    # the trainer alone: binning (its layout saved to a cache of its own
    # for the put sweep), transfer, compile, 5 timed alternations
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cache_dir = tempfile.mkdtemp(prefix="pio_chip_smoke_putcache_")
    old_cache = os.environ.get("PIO_BIN_CACHE_DIR")
    os.environ["PIO_BIN_CACHE_DIR"] = cache_dir
    try:
        trainer = ALSTrainer(train, N_USERS, N_ITEMS, cfg, device="cuda",
                             cache_key="chip-smoke-als")
        trainer.compile()
        t0 = time.perf_counter()
        trainer.step_n()
        train_sec = time.perf_counter() - t0
        roof = trainer.measure_gather_roof()
        puts = put_sweep(layout_cache_key("chip-smoke-als", cfg, 1), cfg,
                         trainer)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
        if old_cache is None:
            os.environ.pop("PIO_BIN_CACHE_DIR", None)
        else:
            os.environ["PIO_BIN_CACHE_DIR"] = old_cache
    train_slots_per_sec = roof["slots_per_iteration"] / (train_sec
                                                          / ALS_ITERS)
    roof.update(train_slots_per_sec=train_slots_per_sec,
                train_over_roof=train_slots_per_sec
                / roof["roof_slots_per_sec"])
    peak_mem = torch.cuda.max_memory_allocated()
    factors = trainer.factors()
    rmse_trainer = predict_rmse(factors, held)
    if not (np.all(np.isfinite(factors.user_factors))
            and np.all(np.isfinite(factors.item_factors))):
        fail("ALS factors are not finite")
    if not RMSE_BAND[0] < rmse_trainer < RMSE_BAND[1]:
        fail(f"ALS held-out RMSE {rmse_trainer} outside {RMSE_BAND}")
    layout = trainer.layout()
    profile = stage_profile(trainer, train_sec * 1e3 / ALS_ITERS)
    timing = {"bin_sec": trainer.bin_sec, "put_sec": trainer.put_sec,
              "put_chunks": trainer.put_chunks,
              "transfer_sec": trainer.transfer_sec,
              "compile_sec": trainer.compile_sec, "train_sec": train_sec,
              "work_model": trainer.work_model(), "gather_roof": roof,
              "put_sweep": puts}
    del trainer
    torch.cuda.empty_cache()

    # the main path: ALSAlgorithm.train, serialize, deploy, serve
    user_names = [f"u{j}" for j in range(N_USERS)]
    item_names = [f"i{j}" for j in range(N_ITEMS)]
    pd = PreparedRatings(user_ids=BiMap.from_vocab(user_names),
                         item_ids=BiMap.from_vocab(item_names),
                         user_idx=train[0], item_idx=train[1],
                         ratings=train[2])
    params = ALSParams(rank=RANK, num_iterations=ALS_ITERS, lambda_=ALS_REG,
                       block_size=ALS_BLOCK)
    for counter in (fce.launches, eu.launches, tkd.launches):
        counter.reset()
    t0 = time.perf_counter()
    algorithm = ALSAlgorithm(params)
    model = algorithm.train(DeviceContext("cuda"), pd)
    algorithm_train_sec = time.perf_counter() - t0
    rmse = predict_rmse(ALSFactors(model.user_factors, model.item_factors),
                        held)
    if not RMSE_BAND[0] < rmse < RMSE_BAND[1]:
        fail(f"ALSAlgorithm.train held-out RMSE {rmse} outside {RMSE_BAND}")
    served = store_and_deploy(model, params, "als-ml20m", user_names,
                              item_names, "ALS phase")
    del model
    topk_launches = tkd.launches.value
    if topk_launches < served["lone_queries"]:
        fail(f"topk_dot launched {topk_launches} times for "
             f"{served['lone_queries']} lone user/item queries to the "
             "trained ALS model")
    if fce.launches.value or eu.launches.value:
        fail("the ALS path launched a two-tower kernel")
    return {
        "config": {"users": N_USERS, "items": N_ITEMS,
                   "ratings": ALS_RATINGS, "held_out": int(hold.sum()),
                   "rank": RANK, "iterations": ALS_ITERS, "reg": ALS_REG,
                   "block_size": ALS_BLOCK, "compute_dtype": "bfloat16",
                   "cg": "jacobi, 6 steps, bfloat16"},
        "layout": layout, **timing,
        "rmse_heldout": rmse_trainer, "rmse_band": RMSE_BAND,
        "peak_train_mem_bytes": peak_mem, "profile": profile,
        "algorithm_train_sec": algorithm_train_sec,
        "algorithm_lane": algorithm.last_train,
        "algorithm_rmse_heldout": rmse,
        "topk_dot_launches": topk_launches, "serve": served,
    }


# -- ingest phase --------------------------------------------------------------

def first_seen(codes: np.ndarray, n: int):
    """(old code -> its rank in first-appearance order, the codes in
    that order): the native scan's dictionary order."""
    uniq, first = np.unique(codes, return_index=True)
    order = uniq[np.argsort(first)]
    remap = np.full(n, -1, np.int64)
    remap[order] = np.arange(len(order))
    return remap, order


def same_side(got, want, what: str) -> None:
    """Two compressed sides must be byte-equal."""
    for name in ("idx_lo", "idx_hi", "val", "mask", "seg", "counts"):
        a, b = getattr(got, name), getattr(want, name)
        if (a is None) != (b is None) or (a is not None and (
                a.dtype != b.dtype or a.shape != b.shape
                or a.tobytes() != b.tobytes())):
            fail(f"{what}: {name} differs from build_compressed_side's")
    for name in ("affine", "row_block", "group_block", "groups_per_shard",
                 "n_shards"):
        if getattr(got, name) != getattr(want, name):
            fail(f"{what}: {name} {getattr(got, name)} != "
                 f"{getattr(want, name)}")


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def temp_store(prefix: str, need: int) -> str:
    """A new temporary directory with ``need`` bytes free, for a
    20M-event log and its layout cache."""
    root = tempfile.mkdtemp(prefix=prefix)
    free = shutil.disk_usage(root).free
    if free < need:
        shutil.rmtree(root, ignore_errors=True)
        fail(f"{root} has {free} bytes free; the 20M-event log and its "
             f"layout cache need {need}")
    return root


CLI = [sys.executable, "-m", "predictionio_torch.tools.cli"]


def eventlog_env(root: str):
    """(the storage environment of an eventlog store at ``root``, the
    CLI subprocesses' environment over it)."""
    env = {"PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
           "PIO_STORAGE_SOURCES_EL_PATH": os.path.join(root, "el")}
    return env, {**os.environ, **env,
                 "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}


def ingest_phase(ratings, coo_profile: dict, tt_tables):
    """The north star's data lane at bench.py's cold-stage width: the
    ALS phase's 20M ratings into a port eventlog store, the row lane,
    the fused scan+bin, a trainer from the binned sides, then the main
    path through ALSAlgorithm (cold, then warm from the layout cache),
    deployed and answered through topk_dot. Then the stream phase runs
    over the same store. -> (ingest, stream)."""
    import torch
    from predictionio_torch.data.storage import EventColumns, Storage
    from predictionio_torch.data.storage import set_storage
    from predictionio_torch.models.als import (ALSAlgorithm, ALSParams,
                                               PreparedRatings)
    from predictionio_torch.ops.als import (ALSConfig, ALSFactors,
                                            ALSTrainer, als_row_cost_slots,
                                            build_compressed_side,
                                            predict_rmse,
                                            side_layout_from_binned)
    from predictionio_torch.ops.kernels import embed_update as eu
    from predictionio_torch.ops.kernels import flash_ce as fce
    from predictionio_torch.ops.kernels import topk_dot as tkd
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.templates.recommendation import (
        RecoDataSource, RecoDataSourceParams)
    from predictionio_torch.tools.als_timing import stage_profile

    uu, ii, vals = ratings
    n = len(uu)
    root = temp_store("pio_chip_smoke_eventlog_", INGEST_DISK_BYTES)
    free = shutil.disk_usage(root).free
    old_cache = os.environ.get("PIO_BIN_CACHE_DIR")
    os.environ["PIO_BIN_CACHE_DIR"] = os.path.join(root, "bin_cache")
    storage = Storage.from_env({"PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
                                "PIO_STORAGE_SOURCES_EL_PATH": root})
    events = storage.events()
    set_storage(storage)
    try:
        app = storage.apps().insert("ml20m")
        events.init(app.id)
        cols = EventColumns(
            entity_codes=uu.astype(np.int32), target_codes=ii.astype(np.int32),
            name_codes=np.zeros(n, np.int32), values=vals,
            times_us=np.arange(n, dtype=np.int64) * 1_000_000,
            entity_vocab=[f"u{j}" for j in range(N_USERS)],
            target_vocab=[f"i{j}" for j in range(N_ITEMS)], names=["rate"])
        t0 = time.perf_counter()
        if events.insert_columnar(cols, app.id, entity_type="user",
                                  target_entity_type="item",
                                  value_property="rating") != n:
            fail("insert_columnar did not take every row")
        ingest_sec = time.perf_counter() - t0
        del cols
        log_bytes = dir_bytes(os.path.join(root, "events"))

        # the event server's row lane: bench.py's 100,000-row JSON array
        # of an event the training read leaves out
        sample = 100_000
        raw = json.dumps([
            {"event": "bench-row", "entityType": "user",
             "entityId": f"u{int(uu[k])}", "targetEntityType": "item",
             "targetEntityId": f"i{int(ii[k])}",
             "properties": {"rating": float(vals[k])},
             "eventTime": f"2026-01-01T{(k // 3600) % 24:02d}:"
                          f"{(k // 60) % 60:02d}:{k % 60:02d}.000Z"}
            for k in range(sample)]).encode()
        t0 = time.perf_counter()
        _, codes, _, _ = events.insert_json_batch(raw, app.id)
        row_lane_sec = time.perf_counter() - t0
        if len(codes) != sample or any(codes):
            fail("the JSON row lane rejected rows")
        del raw

        # the fused scan+bin, as the template's request makes it, with
        # bench's 5% holdout
        source = RecoDataSource(RecoDataSourceParams(app_name="ml20m"))
        request = source.read_training(None).binned_request
        if request is None:
            fail("the template did not take the binned lane on eventlog")
        cfg = ALSConfig(rank=RANK, iterations=ALS_ITERS, reg=ALS_REG,
                        block_size=ALS_BLOCK)
        t0 = time.perf_counter()
        binned = request.bin(skip_mod=20, skip_rem=0, seg_len=cfg.seg_len,
                             n_shards=1, block_size=cfg.block_size,
                             row_cost_slots=als_row_cost_slots(cfg.rank))
        bin_wall_sec = time.perf_counter() - t0
        n_hold = len(binned.holdout[0])
        if binned.n_rows + n_hold != n or n_hold != (n + 19) // 20:
            fail(f"scan+bin kept {binned.n_rows} + {n_hold} held-out rows "
                 f"of {n}")
        # byte-equal to the COO route over the same split, the ids
        # renumbered in the scan's first-seen order
        (ru, users), (ri, items) = (first_seen(uu, N_USERS),
                                    first_seen(ii, N_ITEMS))
        if (binned.entity_vocab != [f"u{j}" for j in users]
                or binned.target_vocab != [f"i{j}" for j in items]):
            fail("the scan's vocabularies are not first-seen order")
        keep = np.arange(n) % 20 != 0
        tu, ti = ru[uu[keep]], ri[ii[keep]]
        tv = vals[keep].astype(np.float32)
        t0 = time.perf_counter()
        want_user = build_compressed_side(tu, ti, tv, len(users), cfg, 1,
                                          None)
        want_item = build_compressed_side(ti, tu, tv, len(items), cfg, 1,
                                          None)
        coo_bin_sec = time.perf_counter() - t0
        user_side = side_layout_from_binned(binned.user_side)
        item_side = side_layout_from_binned(binned.item_side)
        same_side(user_side, want_user, "binned user side")
        same_side(item_side, want_item, "binned item side")
        del want_user, want_item, tu, ti, tv
        held = tuple(np.asarray(a) for a in binned.holdout)

        # a trainer from the binned sides: compile, 5 timed alternations
        torch.cuda.empty_cache()
        trainer = ALSTrainer.from_sides(
            user_side, item_side, len(binned.entity_vocab),
            len(binned.target_vocab), binned.n_rows, cfg, device="cuda")
        del user_side, item_side
        scan = {"scan_sec": binned.scan_sec, "bin_sec": binned.bin_sec,
                "bin_wall_sec": bin_wall_sec}
        del binned
        trainer.compile()
        t0 = time.perf_counter()
        trainer.step_n()
        train_sec = time.perf_counter() - t0
        factors = trainer.factors()
        rmse = predict_rmse(factors, held)
        if not RMSE_BAND[0] < rmse < RMSE_BAND[1]:
            fail(f"binned-lane held-out RMSE {rmse} outside {RMSE_BAND}")
        profile = stage_profile(trainer, train_sec * 1e3 / ALS_ITERS)
        from_sides = {"put_sec": trainer.put_sec,
                      "compile_sec": trainer.compile_sec,
                      "train_sec": train_sec, "rmse_heldout": rmse,
                      "layout": trainer.layout(), "profile": profile,
                      "device_ms_vs_coo_phase":
                      profile["device_ms_per_alternation"]
                      / coo_profile["device_ms_per_alternation"]}
        del trainer, factors
        torch.cuda.empty_cache()

        # the main path: pio train's read and ALSAlgorithm on all the
        # events, cold (one scan+bin, saved to the cache), then warm (the
        # cache, no scan), deployed and answered through topk_dot
        params = ALSParams(rank=RANK, num_iterations=ALS_ITERS,
                           lambda_=ALS_REG, block_size=ALS_BLOCK)
        for counter in (fce.launches, eu.launches, tkd.launches):
            counter.reset()
        runs = {}
        for run in ("cold", "warm"):
            calls = events.bin_columnar_calls
            td = source.read_training(None)
            pd = PreparedRatings(binned_request=td.binned_request,
                                 fingerprint=td.fingerprint)
            algorithm = ALSAlgorithm(params)
            t0 = time.perf_counter()
            model = algorithm.train(DeviceContext("cuda"), pd)
            runs[run] = {"sec": time.perf_counter() - t0,
                         "scans": events.bin_columnar_calls - calls,
                         **algorithm.last_train}
        if runs["cold"]["scans"] != 1 or runs["cold"]["cache_hit"]:
            fail(f"the cold train did not scan once: {runs['cold']}")
        if runs["warm"]["scans"] != 0 or not runs["warm"]["cache_hit"]:
            fail(f"the warm retrain did not load the cache: {runs['warm']}")
        if not (np.all(np.isfinite(model.user_factors))
                and np.all(np.isfinite(model.item_factors))):
            fail("the warm-trained factors are not finite")
        served = store_and_deploy(model, params, "als-eventlog",
                                  list(model.user_ids.keys()),
                                  list(model.item_ids.keys()),
                                  "ingest phase")
        topk_launches = tkd.launches.value
        if topk_launches < served["lone_queries"]:
            fail(f"topk_dot launched {topk_launches} times for "
                 f"{served['lone_queries']} lone queries in the ingest "
                 "phase")
        if fce.launches.value or eu.launches.value:
            fail("the ingest phase launched a two-tower kernel")
        streamed = stream_phase(storage, app.id, model, params, ratings,
                                tt_tables)
        return {
            "events": n, "ingest_sec": ingest_sec,
            "ingest_events_per_sec": n / ingest_sec,
            "log_bytes": log_bytes, "log_bytes_per_event": log_bytes / n,
            "disk_free_bytes": free,
            "row_lane": {"events": sample, "sec": row_lane_sec,
                         "events_per_sec": sample / row_lane_sec},
            **scan, "n_rows": n - n_hold, "held_out": n_hold,
            "coo_native_bin_sec": coo_bin_sec, "from_sides": from_sides,
            "algorithm": runs,
            "events_to_model_sec": ingest_sec + runs["cold"]["sec"],
            "topk_dot_launches": topk_launches, "serve": served,
        }, streamed
    finally:
        set_storage(None)
        events.close()
        shutil.rmtree(root, ignore_errors=True)
        if old_cache is None:
            os.environ.pop("PIO_BIN_CACHE_DIR", None)
        else:
            os.environ["PIO_BIN_CACHE_DIR"] = old_cache


# -- stream phase ----------------------------------------------------------------

def served_truth(server) -> Truth:
    """The served ALS model's tables and vocabularies, in float64."""
    m = server.deployment.models[0]
    return Truth(m.user_factors, m.item_factors, list(m.user_ids.keys()),
                 list(m.item_ids.keys()))


def host_fold(Y: np.ndarray, item_ids, history, reg: float) -> np.ndarray:
    """The explicit ALS-WR fold-in of one user in float64 on the host:
    ``(sum y y^T + reg * n * I) x = sum r y`` over its rated items'
    factors ``Y`` (rows named by ``item_ids``)."""
    rows = np.array([item_ids[name] for name, _ in history], np.int64)
    r = np.array([v for _, v in history], np.float64)
    Yg = np.asarray(Y, np.float64)[rows]
    A = Yg.T @ Yg + reg * len(rows) * np.eye(Yg.shape[1])
    return np.linalg.solve(A, Yg.T @ r)


def rel_err(got, want) -> float:
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / np.linalg.norm(want))


def quality_bounds(model, shadow, k: int, sample: int):
    """The recall_vs_retrain a drift probe must report, from a float64
    top-k of the live tables on the host: the users ``drift_report``
    samples (its seed and order), the shadow's top-k as it computes it,
    and, per user, the least and the most overlap any top-k within
    ``topk_dot``'s score tolerance of the float64 one can have (equal
    unless near-ties straddle the cut). -> (lowest, highest) mean."""
    from predictionio_torch.index.recall import brute_force_topk

    rng = np.random.default_rng(0xD81F7)
    shared = [u for u in shadow.user_ids if u in model.user_ids]
    picked = [shared[int(j)] for j in rng.choice(
        len(shared), min(sample, len(shared)), replace=False)]
    k = min(k, shadow.item_factors.shape[0])
    shadow_vecs = np.stack([shadow.user_factors[shadow.user_ids[u]]
                            for u in picked])
    _, shadow_rows = brute_force_topk(shadow.item_factors, shadow_vecs, k)
    inv_shadow = shadow.inv_items()
    V = np.asarray(model.item_factors, np.float64)
    inv_live = model.item_ids.inverse()
    vmax = float(np.linalg.norm(V, axis=1).max())
    lows, highs = [], []
    for b, user in enumerate(picked):
        want = {inv_shadow[int(r)] for r in shadow_rows[b]}
        u = np.asarray(model.user_factors[model.user_ids[user]], np.float64)
        scores = V @ u
        kth = np.sort(scores)[-k]
        tol = 1e-5 * float(np.linalg.norm(u)) * vmax
        sure = {inv_live[int(r)] for r in np.flatnonzero(scores > kth + tol)}
        tied = {inv_live[int(r)]
                for r in np.flatnonzero(np.abs(scores - kth) <= tol)}
        need = k - len(sure)
        base = len(sure & want)
        lows.append((base + max(0, need - len(tied - want))) / len(want))
        highs.append((base + min(need, len(tied & want))) / len(want))
    return float(np.mean(lows)), float(np.mean(highs))


def stream_phase(storage, app_id: int, model, params, ratings,
                 tt_tables) -> dict:
    """The streaming freshness lane over the ingest phase's 20M-event
    log: the warm-trained model as a COMPLETED instance of that store,
    served by an in-process EngineServer on the card, a StreamUpdater on
    the card patching it; the folds of bench.py's ``_stream_stage``,
    each answer and folded factor checked on the host; then the
    two-tower online step at the train phase's stretch width."""
    import datetime as dt

    import torch
    from predictionio_torch.data.event import Event
    from predictionio_torch.data.metadata import EngineInstance, Model
    from predictionio_torch.index.recall import recall_at_k
    from predictionio_torch.obs import journal, quality
    from predictionio_torch.ops.kernels import embed_update as eu
    from predictionio_torch.ops.kernels import flash_ce as fce
    from predictionio_torch.ops.kernels import topk_dot as tkd
    from predictionio_torch.ops.twotower import online_delta_step
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.serving.engine_server import EngineServer
    from predictionio_torch.templates.recommendation import (
        recommendation_engine)
    from predictionio_torch.workflow import stream
    from predictionio_torch.workflow.train import serialize_models

    phase_t0 = time.perf_counter()
    now = dt.datetime.now(tz=dt.timezone.utc)
    storage.engine_instances().insert(EngineInstance(
        id=STREAM_ENGINE, status="COMPLETED", start_time=now, end_time=now,
        engine_id=STREAM_ENGINE, engine_version="0",
        engine_variant="default",
        engine_factory=("predictionio_torch.templates.recommendation."
                        "recommendation_engine"),
        data_source_params=json.dumps({"name": "", "params": {
            "app_name": "ml20m"}}),
        preparator_params=json.dumps({"name": "", "params": {}}),
        algorithms_params=json.dumps([{"name": "als", "params":
                                       dataclasses.asdict(params)}]),
        serving_params=json.dumps({"name": "", "params": {}})))
    storage.models().insert(Model(id=STREAM_ENGINE,
                                  models=serialize_models([model])))
    events = storage.events()
    inv_items = model.item_ids.inverse()
    engine = recommendation_engine()

    def rate(user, item, value, k=0):
        return Event(event="rate", entity_type="user", entity_id=user,
                     target_entity_type="item", target_entity_id=item,
                     properties={"rating": float(value)},
                     event_time=now + dt.timedelta(seconds=k))

    # the main path: counters reset, serve, stream, fold, answer
    solve, drift_report = stream.fold_in_solve, quality.drift_report
    for counter in (fce.launches, eu.launches, tkd.launches):
        counter.reset()
    t0 = time.perf_counter()
    server = EngineServer(engine, STREAM_ENGINE, host="127.0.0.1", port=0,
                          storage=storage, device="cuda").start()
    deploy_sec = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        updater = stream.StreamUpdater(
            engine, STREAM_ENGINE, storage=storage,
            ctx=DeviceContext("cuda"), patch_servers=[server])
        bind_sec = time.perf_counter() - t0
        folder = updater._folders[0]
        if folder.device.type != "cuda" or updater.device.type != "cuda":
            fail(f"the fold lane is on {folder.device}, not the card")
        local = folder.model

        # the fold's split: the native tail read, the targeted history
        # scans, the solves and the publish, timed around each call
        split = {}
        solve_devices = set()

        def timed(obj, name, key):
            fn = getattr(obj, name)

            def wrapper(*args, **kwargs):
                if key == "solve_sec":
                    solve_devices.add(str(kwargs.get("device")))
                t = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    split[key] += time.perf_counter() - t

            setattr(obj, name, wrapper)

        timed(events, "find_columnar_since", "tail_sec")
        timed(folder, "_fetch_history", "history_sec")
        timed(stream, "fold_in_solve", "solve_sec")
        timed(updater, "_publish", "publish_sec")
        timed(updater, "probe_quality", "quality_sec")
        # the quality probe's own topk_dot launches (its drift reports),
        # apart from the serving's and a breach's reload
        probe_launches = []

        def counted_report(*args, **kwargs):
            before = tkd.launches.value
            try:
                return drift_report(*args, **kwargs)
            finally:
                probe_launches.append(tkd.launches.value - before)

        quality.drift_report = counted_report

        def fold(what: str, n_events: int) -> dict:
            for key in ("tail_sec", "history_sec", "solve_sec",
                        "publish_sec", "quality_sec"):
                split[key] = 0.0
            skipped = dict(updater.groups_skipped)
            stats = updater.poll_once()
            if stats["events"] != n_events or not stats["published"]:
                fail(f"stream phase, {what}: {stats}")
            # the probe runs after the cycle's own clock stopped
            return {**stats, "split": dict(split),
                    "other_sec": stats["seconds"] - sum(
                        v for k, v in split.items() if k != "quality_sec"),
                    "groups_skipped": {
                        k: v - skipped[k]
                        for k, v in updater.groups_skipped.items()}}

        # each existing item a fold touches is scanned for its whole
        # history (and skipped past PIO_STREAM_MAX_GROUP rows after that)
        uu, ii, vals = ratings

        def rows_of(item: str) -> int:
            return int(np.count_nonzero(ii == int(item[1:])))

        # 1. warm fold: one event
        events.insert_batch([rate("stream_warm_u", inv_items[0], 4.0)],
                            app_id)
        warm = fold("warm fold", 1)
        warm["item_history"] = rows_of(inv_items[0])

        # 2. throughput: 1,000 ratings from 100 new users over 8
        # existing items (bench.py _stream_stage)
        rng = np.random.default_rng(11)
        hot = [inv_items[int(i)]
               for i in rng.integers(0, len(inv_items), size=STREAM_HOT)]
        batch = [rate(f"stream_tp_u{k % STREAM_USERS}", hot[k % STREAM_HOT],
                      float(rng.integers(1, 11)) / 2.0, k)
                 for k in range(STREAM_EVENTS)]
        events.insert_batch(batch, app_id)
        tp = fold("throughput fold", STREAM_EVENTS)
        if (tp["touched_users"] != STREAM_USERS
                or tp["touched_items"] != len(set(hot))):
            fail(f"stream phase, throughput fold touched {tp}")
        tp["events_per_sec"] = STREAM_EVENTS / tp["seconds"]
        tp["item_history"] = sorted(rows_of(name) for name in set(hot))

        # 3. event to servable: a fresh user's one rating
        user = "stream_fresh_u"
        q = {"user": user, "num": 10}
        if post(server.port, q)["itemScores"]:
            fail("stream phase: the fresh user answered before its fold")
        t0 = time.perf_counter()
        events.insert_batch([rate(user, inv_items[1], 5.0)], app_id)
        e2s = fold("event to servable", 1)
        answer = post(server.port, q)
        e2s["event_to_servable_ms"] = (time.perf_counter() - t0) * 1e3
        e2s["item_history"] = rows_of(inv_items[1])
        if not answer["itemScores"]:
            fail("stream phase: the fresh user's answer is empty")
        truth = served_truth(server)
        check_answer(truth, q, answer, "stream phase, event to servable")
        served_row = truth.U[truth.users[user]]
        folded = local.user_factors[local.user_ids[user]]
        if not np.array_equal(served_row, folded):
            fail("stream phase: the served row is not the folded row")
        e2s["rel_err_vs_f64"] = rel_err(folded, host_fold(
            local.item_factors, local.item_ids, [(inv_items[1], 5.0)],
            params.lambda_))
        if e2s["rel_err_vs_f64"] > FOLD_REL_TOL:
            fail(f"stream phase: the fresh user's folded factor is "
                 f"{e2s['rel_err_vs_f64']} from the float64 solve")

        # every fold from here on runs the shadow-quality probe (after
        # the event-to-servable fold, whose time stays comparable)
        os.environ["PIO_QUALITY_EVERY"] = "1"

        # 4. an existing user's one more rating: its factor against a
        # float64 solve of its full history over the fixed item factors
        j = int(uu[STREAM_EXISTING_ROW])
        mine = uu == j
        rare_item = inv_items[len(inv_items) - 1]
        events.insert_batch([rate(f"u{j}", rare_item, 4.5)], app_id)
        existing = fold("existing user", 1)
        history = [(f"i{int(k)}", float(v))
                   for k, v in zip(ii[mine], vals[mine])] + [(rare_item, 4.5)]
        want = host_fold(local.item_factors, local.item_ids, history,
                         params.lambda_)
        got = local.user_factors[local.user_ids[f"u{j}"]]
        existing.update(user=f"u{j}", history=len(history),
                        rel_err_vs_f64=rel_err(got, want))
        if existing["rel_err_vs_f64"] > FOLD_REL_TOL:
            fail(f"stream phase: u{j}'s folded factor is "
                 f"{existing['rel_err_vs_f64']} from the float64 solve")
        truth = served_truth(server)
        if not np.array_equal(truth.U[truth.users[f"u{j}"]], got):
            fail("stream phase: the served row is not the folded row")
        for qq in ({"user": f"u{j}", "num": 10}, {"item": rare_item,
                                                  "num": 10}):
            check_answer(truth, qq, post(server.port, qq),
                         "stream phase, existing user")

        # 5. a new item rated by 5 existing users: an appended index row
        index_rows = len(server.deployment.models[0].retrieval_index())
        raters = list(dict.fromkeys(f"u{int(u)}" for u in uu[:50]))[:5]
        item = "stream_new_item"
        events.insert_batch([rate(u, item, 3.0 + k % 3, k)
                             for k, u in enumerate(raters)], app_id)
        new = fold("new item", len(raters))
        served_index = server.deployment.models[0].retrieval_index()
        if len(served_index) != index_rows + 1:
            fail(f"the served index has {len(served_index)} rows after the "
                 f"new item, {index_rows} before")
        q = {"item": item, "num": 10}
        t0 = time.perf_counter()
        first = post(server.port, q)
        new["first_query_ms"] = (time.perf_counter() - t0) * 1e3
        warm_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            again = post(server.port, q)
            warm_ms.append((time.perf_counter() - t0) * 1e3)
        new["warm_query_ms"] = sorted(warm_ms)[len(warm_ms) // 2]
        truth = served_truth(server)
        check_answer(truth, q, first, "stream phase, new item (first)")
        check_answer(truth, q, again, "stream phase, new item (warm)")
        if not first["itemScores"]:
            fail("stream phase: the new item answered nothing")

        # 6. the HTTP lane: one fold published to POST /model/patch
        updater.patch_servers = []
        updater.patch_urls = [f"http://127.0.0.1:{server.port}"]
        applied = server.patches["applied"]
        user = "stream_http_u"
        events.insert_batch([rate(user, inv_items[2], 4.0)], app_id)
        http = fold("HTTP lane", 1)
        if server.patches["applied"] != applied + 1:
            fail(f"the HTTP patch did not land: {server.patches}")
        q = {"user": user, "num": 10}
        check_answer(served_truth(server), q, post(server.port, q),
                     "stream phase, HTTP lane")
        updater.patch_servers, updater.patch_urls = [server], []

        # the probe of that fold: topk_dot's top-k of the folded tables
        # against the shadow, held to a float64 top-k on the host; the
        # HTTP lane pushed the same report to the server
        report = http["quality"]
        lo, hi = quality_bounds(local, updater._shadows[folder.index],
                                quality._k(), quality._sample_n())
        if not (round(lo, 4) - 1e-4 <= report["recall_vs_retrain"]
                <= round(hi, 4) + 1e-4):
            fail(f"stream phase: recall_vs_retrain "
                 f"{report['recall_vs_retrain']} against [{lo}, {hi}] "
                 "from float64")
        if probe_launches != [1, 1, 1]:
            fail(f"stream phase: topk_dot launches per quality probe "
                 f"{probe_launches}")
        code, pushed = http_json(server.port, "/admin/quality")
        if code != 200 or (pushed.get("drift") or {}).get(
                "recall_vs_retrain") != report["recall_vs_retrain"]:
            fail(f"stream phase: the drift push: {code} {pushed}")
        probed = {"report": report, "recall_f64": [lo, hi],
                  "launches_per_probe": list(probe_launches),
                  "quality_sec": [f["split"]["quality_sec"] for f in
                                  (existing, new, http)]}

        # 7. the recall probe over the patched index, through topk_dot
        recall = updater.probe_recall()
        if recall != 1.0:
            # ties excepted: a miss must score within topk_dot's
            # tolerance of the k-th true score
            sample = np.random.default_rng(0x5CA1E).choice(
                len(local.user_ids), 16, replace=False)
            qv = local.user_factors[sample]
            tol = 1e-5 * float(np.linalg.norm(qv, axis=1).max()) * float(
                np.linalg.norm(local.item_factors, axis=1).max())
            if recall_at_k(local.retrieval_index(), qv, 10,
                           vectors=local.item_factors, eps=tol) != 1.0:
                fail(f"stream phase: recall@10 of the patched index "
                     f"{recall}")
        if solve_devices != {"cuda:0"}:
            fail(f"fold_in_solve ran on {solve_devices}, not the card")

        # a drift band every fold breaches: the reload lane (the
        # server's GET /reload) fires once, and not again for the same
        # bound instance
        os.environ["PIO_QUALITY_DRIFT_BAND"] = "0"
        updater.reload_urls = [f"http://127.0.0.1:{server.port}"]
        n_auto = len(journal.JOURNAL.recent(kind="auto_reload"))
        n_reload = len(journal.JOURNAL.recent(kind="reload"))
        n_launched = tkd.launches.value
        with LogRecords("predictionio_torch.workflow.stream") as logs:
            events.insert_batch([rate("stream_breach_u", inv_items[3],
                                      4.0)], app_id)
            breach = fold("drift breach", 1)
            events.insert_batch([rate("stream_breach_v", inv_items[4],
                                      4.0)], app_id)
            again = fold("after the breach", 1)
        # the breach's in-place reload warms the new model's index up:
        # its launches are neither the stream path's nor the probes'
        reload_launches = (tkd.launches.value - n_launched
                           - sum(probe_launches[3:]))
        triggered = [r.getMessage() for r in logs.records
                     if "rolling reload triggered" in r.getMessage()]
        auto = len(journal.JOURNAL.recent(kind="auto_reload")) - n_auto
        reloads = len(journal.JOURNAL.recent(kind="reload")) - n_reload
        if (not breach["quality"]["breached"]
                or not again["quality"]["breached"] or auto != 1
                or reloads != 1 or len(triggered) != 1
                or probe_launches != [1] * 5):
            fail(f"stream phase: a breach fired {auto} auto_reload, the "
                 f"server reloaded {reloads} times, {len(triggered)} "
                 f"triggers logged: {breach['quality']}")
        probed["breach"] = {"breached": breach["quality"]["breached"],
                            "auto_reloads": auto, "server_reloads": reloads,
                            "probes": len(probe_launches)}
        probed["launches"] = sum(probe_launches)
        probed["reload_launches"] = reload_launches

        # 8. the two-tower online step at the stretch width
        U, V = tt_tables
        rng = np.random.default_rng(SEED + 8)
        u_rows = rng.integers(0, len(U), STREAM_TT_PAIRS)
        i_rows = rng.integers(0, len(V), STREAM_TT_PAIRS)
        kw = dict(lr=0.05, steps=STREAM_TT_STEPS, temp=TEMP)
        online_delta_step(U, V, u_rows, i_rows, device="cuda", **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tt_got = online_delta_step(U, V, u_rows, i_rows, device="cuda", **kw)
        tt_ms = (time.perf_counter() - t0) * 1e3
        # the stream path's own: the probes are counted apart
        launches = (tkd.launches.value - probed["launches"]
                    - reload_launches)
        if fce.launches.value or eu.launches.value:
            fail("the stream phase launched a two-tower training kernel")
    finally:
        stream.fold_in_solve = solve
        quality.drift_report = drift_report
        os.environ.pop("PIO_QUALITY_EVERY", None)
        os.environ.pop("PIO_QUALITY_DRIFT_BAND", None)
        server.stop()
    if launches < 1:
        fail("topk_dot did not launch on the stream path")
    tt_cpu = online_delta_step(U, V, u_rows, i_rows, device="cpu", **kw)
    losses = tt_got[4]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"two-tower online losses not falling: {losses}")
    if not (np.array_equal(tt_got[0], np.unique(u_rows))
            and np.array_equal(tt_got[2], np.unique(i_rows))
            and np.array_equal(tt_got[0], tt_cpu[0])
            and np.array_equal(tt_got[2], tt_cpu[2])):
        fail("two-tower online step: touched rows differ")
    tt_err = max(float(np.abs(tt_got[1] - tt_cpu[1]).max()),
                 float(np.abs(tt_got[3] - tt_cpu[3]).max()))
    loss_err = float(np.max(np.abs(np.subtract(losses, tt_cpu[4]))
                            / np.abs(tt_cpu[4])))
    if tt_err > TT_ONLINE_ATOL or loss_err > TT_ONLINE_RTOL:
        fail(f"two-tower online step on the card vs the CPU: vectors "
             f"{tt_err}, losses {loss_err}")
    for vecs in (tt_got[1], tt_got[3]):
        if not np.all(np.abs(np.linalg.norm(vecs, axis=1) - 1.0) < 1e-4):
            fail("two-tower online rows are not unit-norm")
    return {
        "engine": STREAM_ENGINE, "sec": time.perf_counter() - phase_t0,
        "deploy_sec": deploy_sec,
        "bind_sec": bind_sec, "warm": warm, "throughput": tp,
        "events_per_sec": tp["events_per_sec"],
        "event_to_servable": e2s,
        "event_to_servable_ms": e2s["event_to_servable_ms"],
        "existing_user": existing, "new_item": new, "http": http,
        "patches": dict(server.patches), "recall": recall,
        "quality_probe": probed,
        "fold_rel_tol": FOLD_REL_TOL,
        "two_tower": {"pairs": STREAM_TT_PAIRS, "steps": STREAM_TT_STEPS,
                      "table_rows": len(U), "dim": int(U.shape[1]),
                      "ms": tt_ms, "losses": losses,
                      "touched_users": len(tt_got[0]),
                      "touched_items": len(tt_got[2]),
                      "max_abs_err_vs_cpu": tt_err,
                      "loss_rel_err_vs_cpu": loss_err},
        "topk_dot_launches": launches,
    }


# -- front-door phase ----------------------------------------------------------

def iso_at(sec: int) -> str:
    """The API form of an event time ``sec`` seconds after the epoch."""
    import datetime as dt

    t = dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc) + dt.timedelta(
        seconds=int(sec))
    return t.isoformat().replace("+00:00", "Z")


def rate_json(u: int, i: int, v: float, sec: int) -> str:
    return (f'{{"event":"rate","entityType":"user","entityId":"u{u}",'
            f'"targetEntityType":"item","targetEntityId":"i{i}",'
            f'"properties":{{"rating":{v}}},"eventTime":"{iso_at(sec)}"}}')


def view_json(name: str, u: str, i: int, sec: int) -> str:
    return (f'{{"event":"{name}","entityType":"user","entityId":"{u}",'
            f'"targetEntityType":"item","targetEntityId":"i{i}",'
            f'"eventTime":"{iso_at(sec)}"}}')


def send_bodies(port: int, path: str, bodies, conns: int):
    """POST every body over ``conns`` keep-alive connections at once. ->
    ([(status, response bytes)] in body order, wall seconds)."""
    import http.client

    results = [None] * len(bodies)
    errors = []

    def worker(w: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            for j in range(w, len(bodies), conns):
                conn.request("POST", path, body=bodies[j],
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                results[j] = (resp.status, resp.read())
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"{type(e).__name__}: {e}")
        finally:
            conn.close()

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(conns)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        fail(f"batch POSTs failed: {errors[:3]}")
    return results, wall


def batch_statuses(status: int, raw: bytes, what: str) -> list:
    if status != 200:
        fail(f"{what}: POST /batch/events.json answered {status}: "
             f"{raw[:300]!r}")
    return [row["status"] for row in json.loads(raw)]


def batch_lane_split(bodies) -> dict:
    """Where the batch route's server time goes, per event, in this
    process on a store of its own: the native lane alone
    (``insert_json_batch``), ``EventServerCore.create_events_batch`` on
    the same bodies (the native lane, then the per-row result dicts and
    ``Stats.update``), and the response's JSON encoding."""
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.serving.event_server import (AuthData,
                                                         EventServerCore)

    root = tempfile.mkdtemp(prefix="pio_chip_smoke_split_")
    storage = Storage.from_env({"PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
                                "PIO_STORAGE_SOURCES_EL_PATH": root})
    events = storage.events()
    try:
        app = storage.apps().insert("split")
        events.init(app.id)
        core = EventServerCore(storage)
        auth = AuthData(app_id=app.id, channel_id=None, events=[])
        native = route = encode = 0.0
        n = 0
        for body in bodies:
            t0 = time.perf_counter()
            events.insert_json_batch(body, app.id, strict=False)
            t1 = time.perf_counter()
            status, results = core.create_events_batch(auth, body)
            t2 = time.perf_counter()
            json.dumps(results).encode()
            t3 = time.perf_counter()
            if status != 200:
                fail(f"the batch route answered {status} in process")
            native += t1 - t0
            route += t2 - t1
            encode += t3 - t2
            n += len(results)
        return {"events": n, "native_us": 1e6 * native / n,
                "route_us": 1e6 * route / n,
                "result_loop_us": 1e6 * (route - native) / n,
                "encode_us": 1e6 * encode / n}
    finally:
        events.close()
        shutil.rmtree(root, ignore_errors=True)


def front_door_phase(ratings) -> dict:
    """The main path from its front door, at the ALS phase's width: ``cli
    app new`` and ``accesskey new``; the first 19.75M ratings cut to
    ``depth_cut``'s rows as history by ``insert_columnar``; ``cli
    eventserver`` takes the last 250,000 as live traffic (batches over 4
    keep-alive connections, lone POSTs), a whitelisted key's batch (the
    per-row lane, 403s), reads and stats, and drains an in-flight batch
    on SIGTERM; ``cli train`` scans the log's every rating once on the
    binned lane, ``cli deploy`` answers through ``topk_dot``, and ``cli
    status`` passes."""
    import ast
    import http.client

    from predictionio_torch.data.storage import EventColumns, Storage

    uu, ii, vals = ratings
    n = len(uu)
    hist = FD_HISTORY
    # the history's depth is cut (widths kept; phase 7 holds the uncut
    # 20M lane); in_log marks the ratings the log holds, each at its own
    # second, as before the cut
    in_log = depth_cut(uu, ii)
    in_log[hist:] = True
    hist_rows = np.flatnonzero(in_log[:hist])
    n_logged = len(hist_rows) + (n - hist)
    root = temp_store("pio_chip_smoke_front_door_", INGEST_DISK_BYTES)
    env = {"PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
           "PIO_STORAGE_SOURCES_EL_PATH": root}
    here = os.path.dirname(os.path.abspath(__file__))
    sub_env = {**os.environ, **env, "PYTHONPATH": here,
               "PIO_BIN_CACHE_DIR": os.path.join(root, "bin_cache"),
               "PIO_DRAIN_TIMEOUT": str(FD_DRAIN_TIMEOUT)}
    cli = [sys.executable, "-m", "predictionio_torch.tools.cli"]
    server = None
    server_log = os.path.join(root, "eventserver.log")
    try:
        # 1. the app and its keys, through the CLI
        out = run_cli(cli, ["app", "new", "ml20m"], sub_env, here,
                      "front door").stdout
        key = next(line.split(": ", 1)[1] for line in out.splitlines()
                   if line.startswith("Access Key: "))
        out = run_cli(cli, ["accesskey", "new", "ml20m", "view"], sub_env,
                      here, "front door").stdout
        view_key = next(line.split(": ", 1)[1] for line in out.splitlines()
                        if line.startswith("Created new access key: "))

        # 2. the history: bench's bulk lane, then close (one writer)
        storage = Storage.from_env(env)
        app = storage.apps().get_by_name("ml20m")
        cols = EventColumns(
            entity_codes=uu[hist_rows].astype(np.int32),
            target_codes=ii[hist_rows].astype(np.int32),
            name_codes=np.zeros(len(hist_rows), np.int32),
            values=vals[hist_rows],
            times_us=hist_rows.astype(np.int64) * 1_000_000,
            entity_vocab=[f"u{j}" for j in range(N_USERS)],
            target_vocab=[f"i{j}" for j in range(N_ITEMS)], names=["rate"])
        t0 = time.perf_counter()
        if storage.events().insert_columnar(
                cols, app.id, entity_type="user", target_entity_type="item",
                value_property="rating") != len(hist_rows):
            fail("insert_columnar did not take every history row")
        history_sec = time.perf_counter() - t0
        storage.events().close()
        del cols

        # the live traffic, built before the clock starts
        live = [rate_json(u, i, v, k) for k, (u, i, v) in enumerate(
            zip(uu[hist:].tolist(), ii[hist:].tolist(),
                vals[hist:].tolist()), start=hist)]
        n_batched = n - hist - FD_LONE
        bodies = [("[" + ",".join(live[s:min(s + FD_BATCH, n_batched)])
                   + "]").encode() for s in range(0, n_batched, FD_BATCH)]
        lone = [row.encode() for row in live[n_batched:]]
        split = batch_lane_split(bodies[:10])
        rng = np.random.default_rng(SEED + 6)
        read_users = [f"u{j}" for j in rng.choice(uu[hist:], FD_READS,
                                                   replace=False)]
        views = []          # (user, item) of the whitelisted key's views
        wl_rows, wl_want = [], []
        for j in range(FD_VIEWS + FD_DENIED):
            user, item = read_users[j % FD_READS], int(ii[j])
            denied = j % ((FD_VIEWS + FD_DENIED) // FD_DENIED) == 0
            wl_rows.append(view_json("rate" if denied else "view", user,
                                     item, n + j))
            wl_want.append(403 if denied else 201)
            if not denied:
                views.append((user, item, n + j))
        if wl_want.count(403) != FD_DENIED:
            fail("the whitelist batch is not 990 views and 10 rates")
        wl_body = ("[" + ",".join(wl_rows) + "]").encode()
        drain_body = ("[" + ",".join(
            view_json("view", f"u{int(uu[j])}", int(ii[j]), 2 * n + j)
            for j in range(FD_BATCH)) + "]").encode()
        del live

        # 3. the server
        port = free_port()
        with open(server_log, "w") as logf:
            server = subprocess.Popen(
                cli + ["eventserver", "--ip", "127.0.0.1", "--port",
                       str(port)], env=sub_env, cwd=here, stdout=logf,
                stderr=subprocess.STDOUT)
        wait_healthy(port, server, "cli eventserver", server_log, 120)

        # 4. live traffic: batches, lone POSTs, the whitelist, reads, stats
        t_first_post = time.perf_counter()
        results, batch_wall = send_bodies(
            port, f"/batch/events.json?accessKey={key}", bodies, FD_CONNS)
        accepted = 0
        for j, (status, raw) in enumerate(results):
            codes = batch_statuses(status, raw, f"live batch {j}")
            if set(codes) != {201}:
                fail(f"live batch {j}: statuses {sorted(set(codes))}")
            accepted += len(codes)
        if accepted != n_batched:
            fail(f"{accepted} of {n_batched} batched events acknowledged")
        del results, bodies
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        lone_ms = []
        for j, body in enumerate(lone):
            t0 = time.perf_counter()
            conn.request("POST", f"/events.json?accessKey={key}", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read()
            lone_ms.append(1e3 * (time.perf_counter() - t0))
            if resp.status != 201 or "eventId" not in json.loads(raw):
                fail(f"lone POST {j} answered {resp.status}: {raw[:300]!r}")
        t0 = time.perf_counter()
        conn.request("POST", f"/batch/events.json?accessKey={view_key}",
                     body=wl_body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        codes = batch_statuses(resp.status, resp.read(), "whitelist batch")
        wl_sec = time.perf_counter() - t0
        if codes != wl_want:
            fail(f"the whitelisted key's batch answered {codes[:20]}...")
        read_ms = []
        for user in read_users:
            t0 = time.perf_counter()
            conn.request("GET", f"/events.json?accessKey={key}&entityType="
                                f"user&entityId={user}&limit=-1")
            resp = conn.getresponse()
            got = json.loads(resp.read())
            read_ms.append(1e3 * (time.perf_counter() - t0))
            rows = np.flatnonzero((uu == int(user[1:])) & in_log)
            want = sorted([("rate", f"i{int(ii[k])}", float(vals[k]),
                            iso_at(k)) for k in rows]
                          + [("view", f"i{i}", None, iso_at(sec))
                             for u, i, sec in views if u == user])
            have = sorted((d["event"], d.get("targetEntityId"),
                           d.get("properties", {}).get("rating"),
                           d["eventTime"]) for d in got) \
                if resp.status == 200 else []
            if have != want:
                fail(f"GET /events.json for {user}: {len(have)} events, "
                     f"{len(want)} expected")
        conn.request("GET", f"/stats.json?accessKey={key}")
        stats = json.loads(conn.getresponse().read())
        counts = {}
        for bucket in stats["buckets"]:
            for c in bucket["counts"]:
                k = (c["status"], c["event"], c["entityType"])
                counts[k] = counts.get(k, 0) + c["count"]
        want_counts = {(201, "rate", "user"): n - hist,
                       (201, "view", "user"): FD_VIEWS,
                       (403, "rate", "user"): FD_DENIED}
        if counts != want_counts:
            fail(f"/stats.json counts {counts}, sent {want_counts}")

        # 5. SIGTERM with a batch in flight on an open connection
        conn.request("GET", "/healthz")
        conn.getresponse().read()
        conn.request("POST", f"/batch/events.json?accessKey={key}",
                     body=drain_body,
                     headers={"Content-Type": "application/json"})
        t_term = time.perf_counter()
        server.send_signal(signal.SIGTERM)
        resp = conn.getresponse()
        codes = batch_statuses(resp.status, resp.read(), "in-flight batch")
        conn.close()
        if codes != [201] * FD_BATCH:
            fail("the batch in flight at SIGTERM was not acknowledged")
        try:
            rc = server.wait(timeout=FD_DRAIN_TIMEOUT)
        except subprocess.TimeoutExpired:
            fail(f"cli eventserver outlived its {FD_DRAIN_TIMEOUT} s drain")
        drain_sec = time.perf_counter() - t_term
        if rc != 0:
            fail(f"cli eventserver exited {rc} after SIGTERM")

        # 6. train on every rating, deploy, answer through topk_dot
        engine_json = os.path.join(root, "engine.json")
        with open(engine_json, "w") as f:
            json.dump({"id": "default", "engineId": "ml20m-front-door",
                       "engineFactory": ("predictionio_torch.templates."
                                         "recommendation."
                                         "recommendation_engine"),
                       "datasource": {"params": {"app_name": "ml20m"}},
                       "algorithms": [{"name": "als", "params": {
                           "rank": RANK, "num_iterations": ALS_ITERS,
                           "lambda_": ALS_REG, "block_size": ALS_BLOCK}}]},
                      f)
        lone_queries = []

        def queries(truth):
            qs = tt_queries(truth, np.random.default_rng(SEED + 7),
                            N_USERS, len(truth.item_names))
            lone_queries.extend(q for q in qs
                                if "item" in q or q["user"] in truth.users)
            return qs

        served = cli_train_and_deploy(cli, engine_json, "ml20m-front-door",
                                      env, sub_env, here, queries,
                                      "front door")
        lines = [line for line in served["train_log"].splitlines()
                 if "ALS trained on the " in line]
        if len(lines) != 1 or "on the binned lane" not in lines[0]:
            fail(f"cli train did not log one binned-lane train: {lines}")
        trained = ast.literal_eval(lines[0].split(" lane: ", 1)[1])
        if trained["cache_hit"] or "scan_sec" not in trained:
            fail(f"cli train did not scan the log once: {trained}")
        if trained["ratings"] != n_logged:
            fail(f"cli train read {trained['ratings']} ratings of the "
                 f"{n_logged} in the log")
        before = served["retrieval_before"][0]
        after = served["retrieval_after"][0]
        launches = after["kernel_launches"] - before["kernel_launches"]
        if not after["kernel"]["engaged"] or launches < len(lone_queries):
            fail(f"topk_dot launched {launches} times for "
                 f"{len(lone_queries)} lone queries behind cli deploy")

        # 7. status
        out = run_cli(cli, ["status"], sub_env, here, "front door").stdout
        if "(sleeping)" not in out:
            fail(f"cli status: {out}")
        lone_ms.sort()
        return {
            "events": n_logged, "history_events": len(hist_rows),
            "history_cut_from": hist,
            "history_insert_sec": history_sec,
            "live_batch": {"events": n_batched,
                           "requests": len(range(0, n_batched, FD_BATCH)),
                           "connections": FD_CONNS, "sec": batch_wall,
                           "events_per_sec": n_batched / batch_wall,
                           "requests_per_sec":
                           len(range(0, n_batched, FD_BATCH)) / batch_wall},
            "batch_lane_split": split,
            "lone_post": {"events": FD_LONE,
                          "ms_p50": lone_ms[len(lone_ms) // 2],
                          "ms_p99": lone_ms[int(0.99 * len(lone_ms))]},
            "whitelist": {"events": FD_VIEWS + FD_DENIED,
                          "denied": FD_DENIED, "sec": wl_sec,
                          "events_per_sec": (FD_VIEWS + FD_DENIED) / wl_sec},
            "reads": {"count": FD_READS,
                      "ms_max": max(read_ms),
                      "ms_p50": sorted(read_ms)[FD_READS // 2]},
            "drain_sec": drain_sec,
            "cli_train": {"sec": served["train_sec"],
                          "scan_sec": trained["scan_sec"],
                          "bin_sec": trained["native_bin_sec"],
                          "alternations_sec": trained["train_sec"],
                          "put_sec": trained["put_sec"],
                          "ratings": trained["ratings"]},
            "events_to_answers_sec": served["first_answer_at"] - t_first_post,
            "topk_dot_launches": launches,
            "lone_queries": len(lone_queries),
        }
    finally:
        if server is not None and server.poll() is None:
            server.kill()
            server.wait()
        shutil.rmtree(root, ignore_errors=True)


# -- pio train phase -----------------------------------------------------------

def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_cli(cli, args, sub_env: dict, cwd: str, what: str,
            timeout: float = 600) -> subprocess.CompletedProcess:
    """One ``predictionio_torch.tools.cli`` command in a subprocess; a
    non-zero exit fails the run."""
    out = subprocess.run(cli + args, env=sub_env, cwd=cwd,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        fail(f"pio {' '.join(args[:2])} ({what}) exited {out.returncode}: "
             f"{out.stderr[-2000:]}")
    return out


def wait_healthy(port: int, proc, what: str, log_path: str = None,
                 limit: float = 300) -> None:
    """Wait for the server ``proc`` to answer ``GET /healthz``; its output
    is in ``log_path`` or on its stdout pipe."""
    deadline = time.time() + limit
    while True:
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                   timeout=10).read()
            return
        except OSError:
            if proc.poll() is not None or time.time() > deadline:
                if log_path is None:
                    tail = proc.stdout.read()
                else:
                    with open(log_path) as f:
                        tail = f.read()
                fail(f"{what} did not come up: {tail[-2000:]}")
            time.sleep(0.2)


def get_json(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read())


def cli_train_and_deploy(cli, engine_json: str, engine_id: str, env: dict,
                         sub_env: dict, cwd: str, queries, what: str,
                         after=None) -> dict:
    """``cli train`` then ``cli deploy`` of one engine.json in
    subprocesses; every query's answer (``queries``, or ``queries(truth)``
    when it is a function of the stored model) is checked against the
    stored model's factors. ``after(port, proc, deploy_sec)``, when given,
    then runs
    against the live deployment, and owns stopping it. -> the train's
    seconds and log, the stored model and instance id, the wall-clock
    time of the first checked answer, ``GET /``'s retrieval block before
    and after the queries, and what ``after`` returned."""
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.workflow.deploy import load_blob

    t0 = time.perf_counter()
    out = run_cli(cli, ["train", "--engine-json", engine_json], sub_env,
                  cwd, what)
    train_sec = time.perf_counter() - t0
    instance = Storage.from_env(env).engine_instances() \
        .get_latest_completed(engine_id, "0", "default")
    if instance is None:
        fail(f"pio train ({what}) stored no COMPLETED instance")
    model = load_blob(Storage.from_env(env).models()
                      .get(instance.id).models)[0]
    truth = Truth(model.user_factors, model.item_factors,
                  list(model.user_ids.keys()), list(model.item_ids.keys()))
    if callable(queries):
        queries = queries(truth)
    port = free_port()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        cli + ["deploy", "--engine-json", engine_json, "--ip",
               "127.0.0.1", "--port", str(port)],
        env=sub_env, cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    after_out = None
    try:
        wait_healthy(port, proc, f"pio deploy ({what})")
        deploy_sec = time.perf_counter() - t0
        before = get_json(port, "/")["retrieval"]
        first_answer = None
        for j, q in enumerate(queries):
            check_answer(truth, q, post(port, q),
                         f"pio deploy ({what}) query {j}")
            if first_answer is None:
                first_answer = time.perf_counter()
        retrieval_after = get_json(port, "/")["retrieval"]
        if after is not None:
            after_out = after(port, proc, deploy_sec)
    finally:
        if proc.poll() is None:
            proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return {"train_sec": train_sec, "model": model, "instance": instance.id,
            "train_log": out.stderr, "queries": queries,
            "first_answer_at": first_answer, "retrieval_before": before,
            "retrieval_after": retrieval_after, "after": after_out}


def cli_app_with_events(cli, sub_env: dict, cwd: str, app: str,
                        jsonl: str, want: set, what: str) -> dict:
    """``cli app new``, ``cli import`` of a JSONL file, then ``cli
    export``, which must give back the same set of API-format events
    (``eventId`` and ``creationTime`` aside). -> seconds of each."""
    t0 = time.perf_counter()
    run_cli(cli, ["app", "new", app], sub_env, cwd, what)
    t1 = time.perf_counter()
    out = run_cli(cli, ["import", "--appname", app, "--input", jsonl],
                  sub_env, cwd, what)
    if f"Imported {len(want)} event(s)." not in out.stdout:
        fail(f"pio import ({what}): {out.stdout[-500:]}")
    t2 = time.perf_counter()
    exported = f"{jsonl}.{what}.export"
    run_cli(cli, ["export", "--appname", app, "--output", exported],
            sub_env, cwd, what)
    t3 = time.perf_counter()
    with open(exported) as f:
        got = [json.loads(line) for line in f]
    back = {json.dumps({k: v for k, v in d.items()
                        if k not in ("eventId", "creationTime")},
                       sort_keys=True) for d in got}
    if len(got) != len(want) or back != want:
        fail(f"pio export ({what}) did not give back the imported events")
    return {"app_new_sec": t1 - t0, "import_sec": t2 - t1,
            "export_sec": t3 - t2}


def ml100k_eventlog(store: str):
    """(env, subprocess env, engine.json path) of the ``pio train``
    phase's eventlog store and its ALS engine, ``ml100k-als-el``."""
    env = {"PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
           "PIO_STORAGE_SOURCES_EL_PATH": os.path.join(store, "el")}
    sub_env = {**os.environ, **env,
               "PYTHONPATH": os.path.dirname(os.path.abspath(__file__)),
               "PIO_BIN_CACHE_DIR": os.path.join(store, "bin_cache")}
    return env, sub_env, os.path.join(store, "engine-als-eventlog.json")


def stream_cli_checks(cli, sub_env: dict, store: str, el_json: str,
                      port: int, proc, deploy_sec: float) -> dict:
    """On the live ``cli deploy`` of the ``pio train`` phase's eventlog
    ALS engine: ``cli stream --once --url U --reload-url U`` (from the
    tail: it folds nothing, and must exit 0 with its stats), then ``cli
    undeploy``, after which the server's process must exit 0."""
    url = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    out = run_cli(cli, ["stream", "--engine-json", el_json, "--once",
                        "--url", url, "--reload-url", url],
                  sub_env, store, "stream --once")
    stream_sec = time.perf_counter() - t0
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    if stats.get("rebased") is not False or stats.get("events") != 0:
        fail(f"pio stream --once: {out.stdout[-500:]}")
    t0 = time.perf_counter()
    out = run_cli(cli, ["undeploy", "--port", str(port)], sub_env,
                  store, "undeploy")
    if "stopping" not in out.stdout:
        fail(f"pio undeploy: {out.stdout[-500:]}")
    code = proc.wait(timeout=60)
    stop_sec = time.perf_counter() - t0
    if code != 0:
        fail(f"the undeployed server exited {code}: "
             f"{proc.stdout.read()[-2000:]}")
    return {"deploy_sec": deploy_sec, "stream_once": stats,
            "stream_once_sec": stream_sec, "reload_url": url,
            "undeploy_sec": stop_sec, "server_exit": code}


def pio_train_phase(store: str) -> dict:
    """In the directory ``store``, which the caller removes: the eval
    phase reads the eventlog events this phase imports."""
    import datetime as dt

    from predictionio_torch.data.event import Event

    env = {"PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
           "PIO_STORAGE_SOURCES_FS_PATH": store}
    root = os.path.dirname(os.path.abspath(__file__))
    rng = np.random.default_rng(SEED + 3)
    n_users, n_items, n = 943, 1682, 100_000
    us = rng.integers(1, n_users + 1, n)
    its = rng.integers(1, n_items + 1, n)
    rs = rng.integers(1, 6, n)
    t0 = dt.datetime(1998, 1, 1, tzinfo=dt.timezone.utc)
    lines = [json.dumps({k: v for k, v in Event(
        event="rate", entity_type="user", entity_id=f"u{u}",
        target_entity_type="item", target_entity_id=f"i{i}",
        properties={"rating": float(r)},
        event_time=t0 + dt.timedelta(seconds=j)).to_dict(True).items()
        if k not in ("eventId", "creationTime")}, sort_keys=True)
        for j, (u, i, r) in enumerate(zip(us, its, rs))]
    jsonl = os.path.join(store, "ml100k.jsonl")
    with open(jsonl, "w") as f:
        f.write("\n".join(lines) + "\n")
    want = set(lines)
    sub_env = {**os.environ, **env, "PYTHONPATH": root}
    cli = [sys.executable, "-m", "predictionio_torch.tools.cli"]
    rng = np.random.default_rng(SEED + 4)
    queries = [{"user": f"u{u}", "num": 10}
               for u in rng.integers(1, n_users + 1, 10)]
    queries += [{"item": f"i{i}", "num": 5}
                for i in rng.integers(1, n_items + 1, 5)]
    engine_json = os.path.join(store, "engine.json")
    with open(engine_json, "w") as f:
        json.dump({
            "id": "default", "engineId": "ml100k-tt",
            "engineFactory":
                "predictionio_torch.templates.twotower.twotower_engine",
            "datasource": {"params": {"app_name": "ml100k"}},
            "algorithms": [{"name": "twotower", "params": {
                "dim": 64, "batch_size": 1024, "epochs": 5}}]}, f)
    als_json = os.path.join(store, "engine-als.json")
    with open(als_json, "w") as f:
        json.dump({
            "id": "default", "engineId": "ml100k-als",
            "engineFactory": ("predictionio_torch.templates."
                              "recommendation.recommendation_engine"),
            "datasource": {"params": {"app_name": "ml100k"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 16, "num_iterations": 10}}]}, f)
    el_env, el_sub_env, el_json = ml100k_eventlog(store)
    with open(el_json, "w") as f:
        json.dump({"id": "default", "engineId": "ml100k-als-el",
                   "engineFactory": ("predictionio_torch.templates."
                                     "recommendation."
                                     "recommendation_engine"),
                   "datasource": {"params": {"app_name": "ml100k"}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": 16, "num_iterations": 10}}]}, f)
    walls = {}

    def chain(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            walls[name] = time.perf_counter() - t0

    def eventlog_lane():
        # the same events in an eventlog store, through the CLI too:
        # pio train takes the binned lane (its log says so), pio deploy
        # serves the model, and pio stream and undeploy run against it
        io = cli_app_with_events(cli, el_sub_env, store, "ml100k", jsonl,
                                 want, "eventlog")
        served = cli_train_and_deploy(
            cli, el_json, "ml100k-als-el", el_env, el_sub_env, store,
            queries, "ALS, eventlog",
            after=lambda port, proc, deploy_sec: stream_cli_checks(
                cli, el_sub_env, store, el_json, port, proc, deploy_sec))
        return io, served

    # three independent chains of CLI processes, side by side: the
    # eventlog store's; and, once the localfs store holds the events,
    # the two-tower's and the ALS engine's train and deploy over it
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        el_future = pool.submit(chain, "eventlog_chain", eventlog_lane)
        cli_io = chain("localfs_io", cli_app_with_events, cli, sub_env,
                       store, "ml100k", jsonl, want, "localfs")
        tt_future = pool.submit(
            chain, "twotower_chain", cli_train_and_deploy, cli,
            engine_json, "ml100k-tt", env, sub_env, store, queries,
            "two-tower")
        als_future = pool.submit(
            chain, "als_chain", cli_train_and_deploy, cli, als_json,
            "ml100k-als", env, sub_env, store, queries, "ALS")
        tt, als = tt_future.result(), als_future.result()
        el_io, el = el_future.result()
    model = tt["model"]
    plan = model.kernel_plan
    if not (plan["flash_ce"] and plan["embed_update"]):
        fail(f"pio train did not run both kernels: {plan}")
    if not model.train_losses[-1] < model.train_losses[0]:
        fail(f"pio train losses did not fall: {model.train_losses}")
    als_model = als["model"]
    if not (np.all(np.isfinite(als_model.user_factors))
            and np.all(np.isfinite(als_model.item_factors))):
        fail("pio train (ALS) stored factors that are not finite")
    lane = [line for line in el["train_log"].splitlines()
            if "ALS trained on the binned lane" in line]
    if len(lane) != 1:
        fail(f"pio train on eventlog did not log the binned lane: "
             f"{el['train_log'][-2000:]}")
    if len(el["model"].user_ids) != len(als_model.user_ids):
        fail("pio train on eventlog saw other users than on localfs")
    return {"events": n, "cli_io": cli_io, "cli_io_eventlog": el_io,
            "train_sec": tt["train_sec"],
            "losses": model.train_losses, "kernel_plan": plan,
            "queries": len(queries), "instance": tt["instance"],
            "als": {"train_sec": als["train_sec"],
                    "instance": als["instance"],
                    "rank": int(als_model.item_factors.shape[1]),
                    "queries": len(queries)},
            "als_eventlog": {"train_sec": el["train_sec"],
                             "instance": el["instance"],
                             "train_log": lane[0][-600:],
                             "queries": len(queries)},
            "chain_walls_sec": walls, "stream_cli": el["after"]}


# -- eval phase -----------------------------------------------------------------

class LogRecords(logging.Handler):
    """Keeps the records a logger emits while it is attached."""

    def __init__(self, logger: str):
        super().__init__(logging.INFO)
        self.records = []
        self.logger = logging.getLogger(logger)

    def emit(self, record) -> None:
        self.records.append(record)

    def __enter__(self):
        self.logger.addHandler(self)
        self.logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc) -> None:
        self.logger.removeHandler(self)


def grid_phase(ratings, seq_rmse: float) -> dict:
    """(a) ``ALSAlgorithm.grid_train`` of GRID_* on the ALS phase's
    ratings and holdout, each candidate's held-out RMSE against its
    sequential oracle; then a grid trainer of the same candidates,
    profiled."""
    import torch
    from predictionio_torch.data.bimap import BiMap
    from predictionio_torch.models.als import (ALSAlgorithm, ALSParams,
                                               PreparedRatings)
    from predictionio_torch.ops.als import (ALSConfig, ALSFactors,
                                            ALSGridTrainer, predict_rmse)
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.tools.als_timing import grid_profile

    uu, ii, vals = ratings
    hold = np.arange(ALS_RATINGS) % 20 == 0
    train = (uu[~hold], ii[~hold], vals[~hold].astype(np.float32))
    held = (uu[hold], ii[hold], vals[hold])
    pd = PreparedRatings(
        user_ids=BiMap.from_vocab([f"u{j}" for j in range(N_USERS)]),
        item_ids=BiMap.from_vocab([f"i{j}" for j in range(N_ITEMS)]),
        user_idx=train[0], item_idx=train[1], ratings=train[2])
    params = [ALSParams(rank=RANK, num_iterations=it, lambda_=reg,
                        cg_iters=cg, block_size=ALS_BLOCK)
              for reg, it, cg in zip(GRID_REGS, GRID_ITERS, GRID_CG)]
    ctx = DeviceContext("cuda")

    def rmse_of(model) -> float:
        return predict_rmse(ALSFactors(model.user_factors,
                                       model.item_factors), held)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with LogRecords("predictionio_torch.models.als") as log:
        t0 = time.perf_counter()
        models = ALSAlgorithm.grid_train(ctx, pd, params)
        wall_sec = time.perf_counter() - t0
    peak_mem = torch.cuda.max_memory_allocated()
    if models is None or len(models) != len(params):
        fail("ALSAlgorithm.grid_train declined the grid")
    costs = [r.args[1] for r in log.records
             if r.getMessage().startswith("ALS grid of 4 candidates")]
    if len(costs) != 1:
        fail("ALSAlgorithm.grid_train did not log its costs")
    rmses = [rmse_of(m) for m in models]
    if not all(np.isfinite(rmses)):
        fail(f"grid RMSEs not finite: {rmses}")
    del models
    if not RMSE_BAND[0] < rmses[0] < RMSE_BAND[1]:
        fail(f"grid candidate 1 RMSE {rmses[0]} outside {RMSE_BAND}")
    if abs(rmses[0] - seq_rmse) > 1e-2:
        fail(f"grid candidate 1 RMSE {rmses[0]} is not within 1e-2 of the "
             f"ALS phase's {seq_rmse}")
    # candidate 4's sequential oracle: 3 iterations of 4 CG steps
    t0 = time.perf_counter()
    oracle = ALSAlgorithm(params[3]).train(ctx, pd)
    oracle_sec = time.perf_counter() - t0
    oracle_rmse = rmse_of(oracle)
    del oracle
    if abs(rmses[3] - oracle_rmse) > 1e-2:
        fail(f"grid candidate 4 RMSE {rmses[3]} is not within 1e-2 of its "
             f"sequential train's {oracle_rmse}")

    # off the main path: the same grid as a trainer, timed and profiled
    torch.cuda.empty_cache()
    cfg = ALSConfig(rank=RANK, iterations=max(GRID_ITERS), reg=GRID_REGS[0],
                    block_size=ALS_BLOCK, seed=params[0].seed)
    trainer = ALSGridTrainer(train, N_USERS, N_ITEMS, cfg, regs=GRID_REGS,
                             iterations=GRID_ITERS, cg_iters=GRID_CG,
                             device="cuda").compile()
    t0 = time.perf_counter()
    trainer.step_n()
    step_sec = time.perf_counter() - t0
    profile = grid_profile(trainer, step_sec * 1e3 / max(GRID_ITERS))
    layout = {"user_rows": int(trainer.sides()[0].idx.shape[0]),
              "item_rows": int(trainer.sides()[1].idx.shape[0]),
              "seg_len": [int(side.idx.shape[1])
                          for side in trainer.sides()]}
    del trainer
    torch.cuda.empty_cache()
    return {"candidates": {"lambda_": GRID_REGS, "iterations": GRID_ITERS,
                           "cg_iters": GRID_CG},
            "rmse_heldout": rmses, "seq_oracle_rmse": [seq_rmse, oracle_rmse],
            "grid_train_wall_sec": wall_sec, "grid_train_costs": costs[0],
            "oracle_train_sec": oracle_sec, "peak_mem_bytes": peak_mem,
            "layout": layout, "step_n_sec": step_sec, "profile": profile}


EVAL_MODULE = """
from predictionio_torch.core.evaluation import (AverageMetric,
                                                EngineParamsGenerator,
                                                Evaluation)
from predictionio_torch.core.params import EngineParams
from predictionio_torch.models.als import ALSParams
from predictionio_torch.templates.recommendation import (
    RecoDataSourceParams, recommendation_engine)


class RatingMSE(AverageMetric):
    higher_is_better = False

    def calculate_qpa(self, q, p, a):
        match = [s["score"] for s in p["itemScores"] if s["item"] == a["item"]]
        if not match:
            return None
        return (match[0] - a["rating"]) ** 2


Eval = Evaluation(engine=recommendation_engine(), metric=RatingMSE())


class Gen(EngineParamsGenerator):
    def __init__(self):
        super().__init__([EngineParams(
            data_source_params=("", RecoDataSourceParams(
                app_name="ml100k", columnar=False, eval_k=%d)),
            algorithm_params_list=[("als", ALSParams(
                rank=64, num_iterations=3, lambda_=reg,
                compute_dtype="float32", cg_dtype="float32"))])
            for reg in %r])
"""


def pio_eval_phase(store: str) -> dict:
    """(b) ``cli eval`` over the ``pio train`` phase's eventlog events,
    then the same candidates sequentially in this process."""
    import importlib

    from predictionio_torch.core.fast_eval import FastEvalEngineWorkflow
    from predictionio_torch.data.storage import Storage, set_storage
    from predictionio_torch.parallel.context import DeviceContext

    root = os.path.dirname(os.path.abspath(__file__))
    el_env = {"PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
              "PIO_STORAGE_SOURCES_EL_PATH": os.path.join(store, "el")}
    with open(os.path.join(store, "pio_eval_ml100k.py"), "w") as f:
        f.write(EVAL_MODULE % (EVAL_K, EVAL_REGS))
    sub_env = {**os.environ, **el_env,
               "PYTHONPATH": os.pathsep.join([root, store])}
    cli = [sys.executable, "-m", "predictionio_torch.tools.cli"]
    t0 = time.perf_counter()
    out = run_cli(cli, ["eval", "pio_eval_ml100k.Eval", "pio_eval_ml100k.Gen",
                        "--batch", "chip_smoke"], sub_env, store, "pio eval")
    cli_sec = time.perf_counter() - t0
    one_liner = out.stdout.strip().splitlines()[-1]
    want_log = (f"grid tuning: {len(EVAL_REGS)} candidates trained in "
                f"{EVAL_K} grid run(s)")
    if want_log not in out.stderr or "falling back" in out.stderr:
        fail(f"pio eval did not take the grid path: {out.stderr[-2000:]}")
    done = Storage.from_env(el_env).evaluation_instances().get_completed()
    if len(done) != 1 or done[0].evaluator_results != one_liner:
        fail(f"pio eval left {len(done)} EVALCOMPLETED instances, or not "
             f"the one-liner it printed ({one_liner!r})")
    result = json.loads(done[0].evaluator_results_json)
    cli_scores = [s["score"] for s in result["engineParamsScores"]]

    # the sequential oracle: the same candidates, no prefetch, on the card
    sys.path.insert(0, store)
    storage = Storage.from_env(el_env)
    set_storage(storage)
    try:
        module = importlib.import_module("pio_eval_ml100k")
        evaluation, candidates = module.Eval, module.Gen().engine_params_list
        t0 = time.perf_counter()
        ctx = DeviceContext("cuda")
        workflow = FastEvalEngineWorkflow(evaluation.engine, ctx)
        seq_scores = [evaluation.metric.calculate(ctx, workflow.eval(ep))
                      for ep in candidates]
        seq_sec = time.perf_counter() - t0
    finally:
        set_storage(None)
        storage.events().close()
        sys.path.remove(store)
    if workflow.counts["train"] != len(EVAL_REGS) or \
            workflow.counts["grid_dispatches"]:
        fail(f"the sequential oracle did not train one by one: "
             f"{workflow.counts}")
    diff = np.abs(np.array(cli_scores) - np.array(seq_scores))
    if not np.allclose(cli_scores, seq_scores, rtol=1e-4, atol=1e-5) or \
            np.argsort(cli_scores).tolist() != \
            np.argsort(seq_scores).tolist():
        fail(f"pio eval scores {cli_scores} do not match the sequential "
             f"evaluation's {seq_scores}")
    return {"cli_sec": cli_sec, "one_liner": one_liner,
            "grid_log": [line for line in out.stderr.splitlines()
                         if "grid tuning" in line or "ALS grid of" in line],
            "scores": cli_scores, "sequential_scores": seq_scores,
            "max_abs_diff": float(diff.max()), "sequential_sec": seq_sec,
            "best_idx": result["bestIdx"]}


def eval_phase(ratings, seq_rmse: float, store: str) -> dict:
    t0 = time.perf_counter()
    grid = grid_phase(ratings, seq_rmse)
    t1 = time.perf_counter()
    pio_eval = pio_eval_phase(store)
    return {"grid": grid, "grid_phase_sec": t1 - t0, "pio_eval": pio_eval,
            "pio_eval_phase_sec": time.perf_counter() - t1}


# -- project phase -----------------------------------------------------------------

def checkpoint_phase() -> dict:
    """(a) Two-tower checkpoint/resume at the stretch configuration:
    three uninterrupted runs measure the run-to-run spread (the table
    update combines duplicate rows with float atomics); a run with
    ``checkpoint_dir`` stops after ``CKPT_STOP_EPOCH`` and is dropped; a
    new trainer restores it on the card and runs to the end. The restored
    state must equal what was saved byte for byte, the remaining epochs
    must walk the uninterrupted runs' orders, and the resumed step losses
    and tables must sit within 2x the spread."""
    import itertools

    import torch
    from predictionio_torch.ops.kernels import embed_update as eu
    from predictionio_torch.ops.kernels import flash_ce as fce
    from predictionio_torch.ops.twotower import (SIDES, TwoTowerConfig,
                                                 TwoTowerTrainer)

    uu, ii = synth_positives()
    cfg = TwoTowerConfig(dim=TT_DIM, batch_size=TT_BATCH, epochs=TT_EPOCHS,
                         learning_rate=3e-3, seed=11, temperature=TEMP)
    est_bytes = (2 * TT_IDS * TT_DIM + 2 * TT_IDS) * 4
    # two kept checkpoints and the next one being written
    root = temp_store("pio_chip_smoke_ckpt_", 3 * est_bytes)
    free = shutil.disk_usage(root).free

    def trainer(ckdir=None):
        """A trainer whose epoch orders and step losses are recorded."""
        t = TwoTowerTrainer((uu, ii, None), TT_IDS, TT_IDS,
                            dataclasses.replace(cfg, checkpoint_dir=ckdir),
                            device="cuda")
        seen = {"orders": [], "steps": []}
        draw, step = t.epoch_order, t._step

        def epoch_order(perm=None):
            order = draw(perm)
            seen["orders"].append(order.clone())
            return order

        def record_step(rows):
            loss = step(rows)
            seen["steps"].append(loss)
            return loss
        t.epoch_order, t._step = epoch_order, record_step
        return t, seen

    def snapshot(t):
        return torch.cat([t.tables[side].flatten() for side in SIDES])

    try:
        runs = []
        for _ in range(3):
            t, seen = trainer()
            t0 = time.perf_counter()
            losses = t.run()
            torch.cuda.synchronize()
            runs.append({"losses": losses, "tables": snapshot(t),
                         "orders": seen["orders"],
                         "steps": torch.stack(seen["steps"]),
                         "sec": time.perf_counter() - t0})
            del t
        ckdir = os.path.join(root, "tt")
        first, first_seen = trainer(ckdir)
        first_orders = first_seen["orders"]
        first.run(epochs=CKPT_STOP_EPOCH)
        saved = ({side: first.tables[side].clone() for side in SIDES},
                 {side: first.acc[side].clone() for side in SIDES},
                 first._perm_gen.get_state().clone())
        save_sec = first.checkpoint_seconds[-1]
        ckpt_bytes = os.path.getsize(
            os.path.join(ckdir, f"ckpt_{CKPT_STOP_EPOCH}.pkl"))
        del first
        if not torch.equal(first_orders[0], runs[0]["orders"][0]):
            fail("the checkpointed run's first epoch took another order")

        # the resumed run is the counted path: both kernels, counts reset
        for counter in (fce.launches, eu.launches):
            counter.reset()
        t0 = time.perf_counter()
        resumed, resumed_seen = trainer(ckdir)
        resumed_orders = resumed_seen["orders"]
        construct_sec = time.perf_counter() - t0
        if resumed._epochs_done != CKPT_STOP_EPOCH:
            fail(f"the resumed trainer restored {resumed._epochs_done} "
                 f"epochs, not {CKPT_STOP_EPOCH}")
        placed = {resumed.device.type, resumed._perm_gen.device.type,
                  *(resumed.tables[s].device.type for s in SIDES),
                  *(resumed.acc[s].device.type for s in SIDES)}
        if placed != {"cuda"}:
            fail(f"the checkpoint restored onto {sorted(placed)}, not the "
                 "card")
        tables, acc, gen = saved
        for side in SIDES:
            if not (torch.equal(resumed.tables[side], tables[side])
                    and torch.equal(resumed.acc[side], acc[side])):
                fail(f"the restored {side} table or accumulator differs "
                     "from what was saved")
        if not torch.equal(resumed._perm_gen.get_state(), gen):
            fail("the restored epoch-order generator state differs")
        t0 = time.perf_counter()
        resumed_losses = resumed.run()
        torch.cuda.synchronize()
        resume_run_sec = time.perf_counter() - t0
        flash_launches, embed_launches = fce.launches.value, eu.launches.value
        steps = resumed.steps_per_epoch * (TT_EPOCHS - CKPT_STOP_EPOCH)
        if flash_launches != 3 * steps or embed_launches != 2 * steps:
            fail(f"the resumed {steps} steps launched flash_ce "
                 f"{flash_launches} and embed_update {embed_launches} times")
        if len(resumed_orders) != TT_EPOCHS - CKPT_STOP_EPOCH or not all(
                torch.equal(a, b) for a, b in zip(
                    resumed_orders, runs[0]["orders"][CKPT_STOP_EPOCH:])):
            fail("the resumed epochs walked other orders than the "
                 "uninterrupted run")
        kept = sorted(os.listdir(ckdir))
        if kept != [f"ckpt_{e}.pkl" for e in (TT_EPOCHS - 1, TT_EPOCHS)]:
            fail(f"checkpoints kept: {kept}")
        resumed_tables = snapshot(resumed)
        resumed_steps = torch.stack(resumed_seen["steps"])
        restore_sec = resumed.restore_seconds
        resume_saves = list(resumed.checkpoint_seconds)
        del resumed

        # the spread: the largest L2 distance between two uninterrupted
        # runs, over every table entry and over every step loss of the
        # resumed epochs; the resumed run's distance from their mean must
        # be at most twice that (for one noise, 0.82x on average)
        skip = CKPT_STOP_EPOCH * len(runs[0]["steps"]) // TT_EPOCHS
        spread, err, max_abs = {}, {}, {}
        for key, resumed_value in (("tables", resumed_tables),
                                   ("step_losses", resumed_steps)):
            vals = [r[key] if key == "tables" else r["steps"][skip:]
                    for r in runs]
            spread[key] = max(float((a.double() - b.double()).norm())
                              for a, b in itertools.combinations(vals, 2))
            mean = torch.stack(vals).double().mean(dim=0)
            err[key] = float((resumed_value.double() - mean).norm())
            max_abs[key] = max(float((resumed_value - v).abs().max())
                               for v in vals)
            if err[key] > 2 * spread[key]:
                fail(f"the resumed run's {key} sit {err[key]} from the "
                     f"uninterrupted runs' mean, beyond 2x their spread "
                     f"{spread[key]}")
        if not (all(np.isfinite(resumed_losses))
                and resumed_losses[-1] < resumed_losses[0]):
            fail(f"resumed losses not finite and falling: {resumed_losses}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {
        "config": {"users": TT_IDS, "items": TT_IDS, "positives": TT_POS,
                   "dim": TT_DIM, "batch": TT_BATCH, "epochs": TT_EPOCHS,
                   "stop_after": CKPT_STOP_EPOCH},
        "checkpoint_bytes": ckpt_bytes, "free_bytes": free,
        "save_sec": save_sec, "resume_save_sec": resume_saves,
        "restore_sec": restore_sec, "construct_sec": construct_sec,
        "resume_run_sec": resume_run_sec,
        "uninterrupted_sec": [r["sec"] for r in runs],
        "losses": [r["losses"] for r in runs],
        "resumed_losses": resumed_losses,
        "spread_l2": spread, "resumed_l2_from_mean": err,
        "resumed_max_abs": max_abs,
        "flash_ce_launches": flash_launches,
        "embed_update_launches": embed_launches,
    }


def insert_rows(events, app_id: int, rows: list) -> None:
    """API-format event dicts through the eventlog store's JSON row
    lane."""
    _, codes, _, _ = events.insert_json_batch(json.dumps(rows).encode(),
                                              app_id)
    if any(codes):
        fail("the JSON row lane rejected an event")


def put_entities(events, app_id: int, rng) -> dict:
    """A ``$set`` for every user and every item, each item with 1-3 of
    ``PROJECT_CATEGORIES`` categories, through the JSON row lane. ->
    item name -> categories."""
    cats = {f"i{j}": sorted({f"c{c}" for c in rng.integers(
        0, PROJECT_CATEGORIES, 1 + j % 3)}) for j in range(N_ITEMS)}
    rows = ([{"event": "$set", "entityType": "user", "entityId": f"u{j}",
              "eventTime": "2025-12-31T00:00:00.000Z"}
             for j in range(N_USERS)]
            + [{"event": "$set", "entityType": "item", "entityId": name,
                "properties": {"categories": c},
                "eventTime": "2025-12-31T00:00:00.000Z"}
               for name, c in cats.items()])
    insert_rows(events, app_id, rows)
    return cats


def interactions(uu, ii, names, name_codes, times_us, value=None):
    from predictionio_torch.data.storage import EventColumns

    return EventColumns(
        entity_codes=uu.astype(np.int32), target_codes=ii.astype(np.int32),
        name_codes=name_codes.astype(np.int32),
        values=(np.full(len(uu), np.nan) if value is None else value),
        times_us=times_us, entity_vocab=[f"u{j}" for j in range(N_USERS)],
        target_vocab=[f"i{j}" for j in range(N_ITEMS)], names=names)


class LogLines(logging.Handler):
    """The lines the root logger emits while attached, as
    ``LEVEL:name:message``: an in-process ``cli.main``'s stderr."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record) -> None:
        self.lines.append(
            f"{record.levelname}:{record.name}:{record.getMessage()}")


def in_process_cli(argv, store_env: dict, what: str) -> str:
    """``cli.main(argv)`` in this process over the store ``store_env``
    names (which it leaves closed: an event log has one holder), failing
    on a non-zero exit; -> its log lines."""
    from predictionio_torch.data import storage as storage_mod
    from predictionio_torch.tools import cli as pio_cli

    lines = LogLines()
    root = logging.getLogger()
    out = io.StringIO()
    with cli_env(store_env), contextlib.redirect_stdout(out):
        root.addHandler(lines)
        try:
            code = pio_cli.main(argv)
            storage = storage_mod.get_storage()
            close = getattr(storage.events(), "close", None)
            if close is not None:
                close()
        finally:
            root.removeHandler(lines)
    log = "\n".join(lines.lines)
    if code != 0:
        fail(f"pio {argv[0]} ({what}) exited {code}: {out.getvalue()[-1000:]}"
             f" {log[-3000:]}")
    return log


def quick_start(sub_env: dict, root: str, template: str, app: str,
                algorithms: list, what: str, project: str = "project",
                build: bool = True, datasource: dict = None) -> dict:
    """``cli template get`` into ``root/project``, the datasource params
    set in the project's engine.json (``datasource``, else ``app_name``
    ``app``), ``cli build`` (unless ``build`` is false), ``cli train``
    (which must run on ``cuda:0``), each as ``cli.main`` in this process
    (a ``cli`` process costs 7-9 s to start; the deploy stays one). ->
    the engine.json path, seconds of each step, the stored instance's
    models, the train's log."""
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.workflow.deploy import load_blob

    store_env = {k: v for k, v in sub_env.items()
                 if k.startswith("PIO_STORAGE_")}
    proj = os.path.join(root, project)
    secs = {}
    t0 = time.perf_counter()
    in_process_cli(["template", "get", template, proj], store_env, what)
    secs["template_get_sec"] = time.perf_counter() - t0
    ej = os.path.join(proj, "engine.json")
    with open(ej) as f:
        variant = json.load(f)
    variant["datasource"] = {"params": datasource or {"app_name": app}}
    variant["algorithms"] = algorithms
    with open(ej, "w") as f:
        json.dump(variant, f)
    if build:
        t0 = time.perf_counter()
        in_process_cli(["build", "--engine-json", ej], store_env, what)
        secs["build_sec"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stderr = in_process_cli(["train", "--engine-json", ej], store_env,
                            what)
    secs["train_sec"] = time.perf_counter() - t0
    if "on cuda:0" not in stderr:
        fail(f"pio train ({what}) did not train on cuda:0: "
             f"{stderr[-1500:]}")
    storage = Storage.from_env(store_env)
    engine_id = variant["engineFactory"]
    if build and storage.engine_manifests().get(engine_id, "0") is None:
        fail(f"pio build ({what}) registered no manifest")
    instance = storage.engine_instances().get_latest_completed(
        engine_id, "0", "default")
    if instance is None:
        fail(f"pio train ({what}) stored no COMPLETED instance")
    models = load_blob(storage.models().get(instance.id).models)
    return {"engine_json": ej, "secs": secs, "models": models,
            "stderr": stderr,
            "train_log": [line[-500:] for line in stderr.splitlines()
                          if any(key in line for key in (
                              "training read:", "trained:", "took"))]}


def serve_and_check(cli, ej: str, sub_env: dict, root: str, queries,
                    check, what: str) -> dict:
    """``cli deploy`` of the project (which must serve on ``cuda:0``);
    every query's answer goes to ``check(q, answer, label)``; ``GET /``'s
    retrieval block before and after the queries; SIGTERM."""
    port = free_port()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        cli + ["deploy", "--engine-json", ej, "--ip", "127.0.0.1", "--port",
               str(port)],
        env=sub_env, cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        wait_healthy(port, proc, f"pio deploy ({what})")
        deploy_sec = time.perf_counter() - t0
        while True:
            line = proc.stdout.readline()
            if not line:
                fail(f"pio deploy ({what}) printed no deploy line")
            if " deployed on " in line:
                break
        if "(cuda:0)" not in line:
            fail(f"pio deploy ({what}) does not serve on cuda:0: {line}")
        before = get_json(port, "/")["retrieval"]
        lat = []
        for j, q in enumerate(queries):
            t1 = time.perf_counter()
            got = post(port, q)
            lat.append(1e3 * (time.perf_counter() - t1))
            check(q, got, f"pio deploy ({what}) query {j}")
        after = get_json(port, "/")["retrieval"]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return {"deploy_sec": deploy_sec, "query_ms": lat,
            "retrieval_before": before, "retrieval_after": after}


def top_rows(scores: np.ndarray, allowed: np.ndarray, num: int):
    """Rows of the ``num + 1`` best allowed scores under (score
    descending, row ascending)."""
    cand = np.flatnonzero(allowed)
    return cand[np.lexsort((cand, -scores[cand]))[:num + 1]]


def ambiguous(scores: np.ndarray, top: np.ndarray, num: int,
              tol: float) -> bool:
    """Whether float32 rounding could change which rows a top-``num``
    with ``score > 0`` keeps: a near-tie at the cut, or a kept score
    near 0."""
    s = scores[top]
    return bool((len(s) > num and s[num - 1] - s[num] <= 4 * tol)
                or np.any(np.abs(s[:num]) <= 4 * tol))


def check_ranked(expected, ctol: float, got: dict, what: str, q) -> None:
    """``expected``: [(item, score)] in order; the served list must match
    it slot for slot within ``ctol``, an item swapped only with one whose
    expected score is within ``ctol`` of the slot's."""
    served = got["itemScores"]
    if len(served) != len(expected):
        fail(f"{what}: {len(served)} items served, {len(expected)} "
             f"expected for {q}")
    exp = dict(expected)
    for j, (entry, (item, score)) in enumerate(zip(served, expected)):
        if abs(entry["score"] - score) > ctol:
            fail(f"{what}: slot {j} score {entry['score']} vs {score} "
                 f"for {q}")
        if entry["item"] != item and (
                entry["item"] not in exp
                or abs(exp[entry["item"]] - score) > ctol):
            fail(f"{what}: slot {j} item {entry['item']} vs {item} for {q}")


class SimTruth:
    """A similar-product model's row-normalized table in float64."""

    def __init__(self, model):
        self.N = np.asarray(model._normalized, np.float64)
        self.names = list(model.item_ids.keys())
        self.rows = {n: j for j, n in enumerate(self.names)}
        self.cats = model.item_categories

    def answer(self, q):
        """(the algorithm's [(item, score)], its score tolerance, whether
        the answer is ambiguous in float32)."""
        num = int(q.get("num", 10))
        rows = [self.rows[x] for x in q["items"] if x in self.rows]
        if not rows:
            return [], 0.0, False
        qvec = self.N[rows].sum(axis=0)
        scores = self.N @ qvec
        allowed = np.ones(len(self.names), bool)
        allowed[rows] = False
        if q.get("whiteList"):
            wl = np.zeros(len(self.names), bool)
            wl[[self.rows[x] for x in q["whiteList"] if x in self.rows]] = True
            allowed &= wl
        allowed[[self.rows[x] for x in q.get("blackList", ())
                 if x in self.rows]] = False
        if q.get("categories"):
            want = set(q["categories"])
            allowed &= np.array([bool(want & set(self.cats.get(n, ())))
                                 for n in self.names])
        tol = 1e-5 * float(np.linalg.norm(qvec))
        top = top_rows(scores, allowed, num)
        keep = [j for j in top[:num] if scores[j] > 0.0]
        return ([(self.names[j], float(scores[j])) for j in keep], tol,
                ambiguous(scores, top, num, tol))


def standardized(q, answers):
    """StandardizingServing over the algorithms' float64 answers ->
    ([(item, score)], the combined tolerance)."""
    num = int(q.get("num", 10))
    combined, ctol = {}, 0.0
    for items, tol in answers:
        vals = np.array([s for _, s in items], np.float64)
        if num == 1 or not len(vals):
            z, ztol = vals, tol
        else:
            std = vals.std(ddof=1) if len(vals) > 1 else 0.0
            z = (np.zeros_like(vals) if std == 0
                 else (vals - vals.mean()) / std)
            ztol = (0.0 if std == 0 else
                    2 * tol * (1 + float(np.abs(z).max())) / std)
        ctol += ztol
        for (item, _), zs in zip(items, z):
            combined[item] = combined.get(item, 0.0) + float(zs)
    top = sorted(combined.items(), key=lambda kv: -kv[1])[:num]
    return top, ctol + 1e-9


#: how far above the direct solve's largest |item factor| a likealgo
#: train's may lie
LIKE_BOUND_FACTOR = 10.0


def like_rows(ratings):
    """The similar-product phase's like (+1) / dislike (-1) rows: every
    ``PROJECT_LIKE_EVERY``-th rating, a like at >= 3.5, in event-time
    order."""
    uu, ii, vals = ratings
    sel = np.arange(0, len(uu), PROJECT_LIKE_EVERY)
    return uu[sel], ii[sel], np.where(vals[sel] >= 3.5, 1.0, -1.0)


def like_direct_bound(ratings) -> dict:
    """``LikeAlgorithm``'s config solved with ``solver="direct"`` on the
    card over the phase's like pairs (the latest event of a pair wins,
    as the algorithm folds them): the bound a likealgo train's largest
    |item factor| must keep."""
    from predictionio_torch.models._interactions import latest_pairs
    from predictionio_torch.models.similarproduct import (
        LikeAlgorithm, SimilarProductParams)
    from predictionio_torch.ops.als import ALSTrainer

    u, i, v = like_rows(ratings)
    coo = latest_pairs(u, i, v, N_ITEMS)
    cfg = dataclasses.replace(
        LikeAlgorithm.als_config(SimilarProductParams()), solver="direct")
    t0 = time.perf_counter()
    factors = ALSTrainer(coo, N_USERS, N_ITEMS, cfg, device="cuda").run()
    direct = float(np.abs(factors.item_factors).max())
    if not np.isfinite(direct) or direct <= 0.0:
        fail(f"likealgo's direct solve gave a largest |item factor| of "
             f"{direct}")
    return {"pairs": len(coo[0]), "dislikes": int((coo[2] < 0).sum()),
            "direct_max_abs": direct, "direct_sec": time.perf_counter() - t0,
            "bound": LIKE_BOUND_FACTOR * direct}


def like_out_of_bounds(item_factors, item_names, bound: float) -> list:
    """The rows whose factors are not finite or exceed ``bound`` in
    |value|, as (name, largest |finite value|, finite?)."""
    finite = np.isfinite(item_factors).all(1)
    big = np.abs(np.where(np.isfinite(item_factors), item_factors,
                          0.0)).max(1)
    return [(item_names[r], float(big[r]), bool(finite[r]))
            for r in np.flatnonzero(~finite | (big > bound))]


def likealgo_repeat(ratings, runs: int) -> dict:
    """``LikeAlgorithm.train`` on the card ``runs`` times over the
    similar-product phase's likes, each held to ``like_direct_bound``;
    -> the trains in bounds, and each one's largest |item factor|, rows
    out of bounds and seconds."""
    from predictionio_torch.models._interactions import Interactions
    from predictionio_torch.models.similarproduct import (
        LikeAlgorithm, SimilarProductData, SimilarProductParams)
    from predictionio_torch.parallel.context import DeviceContext

    bound = like_direct_bound(ratings)
    u, i, v = like_rows(ratings)
    users = [f"u{j}" for j in range(N_USERS)]
    items = [f"i{j}" for j in range(N_ITEMS)]
    pd = SimilarProductData(users=users, items=items, likes=Interactions(
        entity_vocab=users, target_vocab=items, entity_idx=u,
        target_idx=i, values=v))
    out = []
    for _ in range(runs):
        algo = LikeAlgorithm(SimilarProductParams())
        t0 = time.perf_counter()
        model = algo.train(DeviceContext("cuda"), pd)
        sec = time.perf_counter() - t0
        bad = like_out_of_bounds(model.item_factors,
                                 list(model.item_ids.keys()), bound["bound"])
        f = model.item_factors
        out.append({"max_abs": float(np.abs(f[np.isfinite(f)]).max(
            initial=0.0)), "rows_out_of_bounds": len(bad),
            "first_out_of_bounds": bad[:3], "sec": sec,
            **{k: algo.last_train[k] for k in ("put_sec", "train_sec")}})
    return {**bound, "runs": runs,
            "in_bounds": sum(1 for t in out if not t["rows_out_of_bounds"]),
            "trains": out}


def likealgo_repeat_main(runs: int) -> int:
    """``python3 chip_smoke.py --likealgo-repeat N``: ``likealgo_repeat``
    alone (no kernel is built: the train launches none)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    card = card_line()
    result = likealgo_repeat(project_ratings(synth_ratings()), runs)
    print(json.dumps({"likealgo_repeat": {**result, "card": card}}),
          flush=True)
    if result["in_bounds"] != runs:
        fail(f"{runs - result['in_bounds']} of {runs} likealgo trains "
             "left their bound")
    return 0


def similar_product_phase(ratings) -> dict:
    """(b) The similar-product Quick Start at MovieLens-20M widths."""
    import torch
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.models.similarproduct import SimilarProductModel
    from predictionio_torch.ops.kernels import topk_dot as tkd

    uu, ii, vals = ratings
    n = len(uu)
    root = temp_store("pio_chip_smoke_simprod_", INGEST_DISK_BYTES)
    env, sub_env = eventlog_env(root)
    cli = CLI
    rng = np.random.default_rng(SEED + 12)
    try:
        storage = Storage.from_env(env)
        events = storage.events()
        app = storage.apps().insert("ml20m-sp")
        events.init(app.id)
        t0 = time.perf_counter()
        put_entities(events, app.id, rng)
        times = np.arange(n, dtype=np.int64) * 1_000_000
        events.insert_columnar(
            interactions(uu, ii, ["view"], np.zeros(n), times), app.id,
            entity_type="user", target_entity_type="item")
        sel = np.arange(0, n, PROJECT_LIKE_EVERY)
        likes = vals[sel] >= 3.5
        events.insert_columnar(
            interactions(uu[sel], ii[sel], ["like", "dislike"], ~likes,
                         times[sel]), app.id,
            entity_type="user", target_entity_type="item")
        events.close()
        ingest_sec = time.perf_counter() - t0

        qs = quick_start(sub_env, root, "similarproduct", "ml20m-sp",
                         [{"name": "als", "params": {}},
                          {"name": "likealgo", "params": {}}],
                         "similar product")
        models = qs["models"]
        if len(models) != 2 or not all(
                isinstance(m, SimilarProductModel) for m in models):
            fail(f"pio train stored {[type(m).__name__ for m in models]}")
        for m, algo in zip(models, ("als", "likealgo")):
            finite = np.isfinite(m.item_factors)
            if m.item_factors.shape != (N_ITEMS, 10) or not finite.all():
                fail(f"similar-product {algo} factors "
                     f"{m.item_factors.shape} not finite at rank 10 over "
                     f"{N_ITEMS} items: {int((~finite).any(1).sum())} rows "
                     f"non-finite, the finite ones up to "
                     f"{np.abs(m.item_factors[finite]).max(initial=0.0)}; "
                     f"the train's log ends {qs['train_log'][-6:]}")
        # likealgo's dislikes put confidences below 1: its factors must
        # stay within LIKE_BOUND_FACTOR of a direct solve's
        like = like_direct_bound(ratings)
        bad = like_out_of_bounds(models[1].item_factors,
                                 list(models[1].item_ids.keys()),
                                 like["bound"])
        if bad:
            fail(f"pio train (similar product): {len(bad)} likealgo item "
                 f"rows not finite or above {like['bound']} in |value|, "
                 f"the first {bad[:10]}; the train's log ends "
                 f"{qs['train_log'][-6:]}")
        like["max_abs"] = float(np.abs(models[1].item_factors).max())
        truths = [SimTruth(m) for m in models]

        # queries whose float64 answer float32 cannot change
        popular = [f"i{j}" for j in rng.permutation(min(2000, N_ITEMS))]
        names = truths[0].names
        kinds = {
            "exclusion": lambda a, b: {"items": [a], "num": 10},
            "two items": lambda a, b: {"items": [a, b], "num": 10},
            "blacklist": lambda a, b: {
                "items": [a], "num": 10,
                "blackList": [x for x, _ in truths[0].answer(
                    {"items": [a], "num": 5})[0]]},
            "num 1": lambda a, b: {"items": [a], "num": 1},
            "categories": lambda a, b: {
                "items": [a], "num": 10,
                "categories": sorted(truths[0].cats.get(a, ["c0"]))[:1]},
            "whitelist": lambda a, b: {
                "items": [a], "num": 10,
                "whiteList": [names[j] for j in
                              rng.choice(len(names), 300, replace=False)]},
        }
        queries, expected, skipped = [], [], 0
        for kind, make in kinds.items():
            for a, b in zip(popular[::2], popular[1::2]):
                q = make(a, b)
                answers = [t.answer(q) for t in truths]
                if any(amb for _, _, amb in answers) or not any(
                        ans for ans, _, _ in answers):
                    skipped += 1
                    continue
                queries.append(q)
                expected.append(standardized(q, [(ans, tol) for ans, tol, _
                                                 in answers]))
                break
            else:
                fail(f"no unambiguous {kind} query among the popular "
                     "items")
        queries.append({"items": ["no-such-item"], "num": 10})
        expected.append(([], 1e-9))
        index_queries = sum(1 for q in queries if not q.get("whiteList")
                            and not q.get("categories")
                            and q["items"][0] in truths[0].rows)
        answers = dict(zip(map(json.dumps, queries), expected))

        def check(q, got, what):
            exp, ctol = answers[json.dumps(q)]
            check_ranked(exp, ctol, got, what, q)

        served = serve_and_check(cli, qs["engine_json"], sub_env, root,
                                 queries, check, "similar product")
        launches = (max(r["kernel_launches"] for r in
                        served["retrieval_after"] if r)
                    - max(r["kernel_launches"] for r in
                          served["retrieval_before"] if r))
        if launches < 2 * index_queries:
            fail(f"topk_dot launched {launches} times for {index_queries} "
                 "exclusion-only queries over two models")
        plans = [r["kernel"] for r in served["retrieval_after"] if r]
        if not all(p["engaged"] and p["device"] == "cuda:0" for p in plans):
            fail(f"the similar-product index did not plan the kernel on "
                 f"the card: {plans}")

        # the D=10 kernel on this path's tables and queries, against its
        # plain version, then timed
        dev = torch.device("cuda")
        items = torch.tensor(models[0]._normalized, device=dev)
        errs = []
        for q in queries:
            rows = [truths[0].rows[x] for x in q["items"]
                    if x in truths[0].rows]
            if not rows or q.get("whiteList") or q.get("categories"):
                continue
            excl = rows + [truths[0].rows[x] for x in q.get("blackList", ())]
            qv = items[rows].sum(dim=0, keepdim=True)
            ex = torch.tensor([excl], dtype=torch.int32, device=dev)
            s, i = tkd.topk_dot(qv, items, ex, 16)
            errs.append(check_topk(qv, items, ex, 16, s, i,
                                   "similar product D=10"))
        timing = time_topk(qv, items, ex, 16,
                           (1, N_ITEMS, items.shape[1], 16, ex.shape[1]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"events": {"views": n, "likes": int(len(sel)),
                       "sets": N_USERS + N_ITEMS},
            "ingest_sec": ingest_sec, **qs["secs"],
            "train_log": qs["train_log"], "queries": len(queries),
            "skipped_ambiguous": skipped, "index_queries": index_queries,
            "topk_dot_launches": launches, **{
                k: served[k] for k in ("deploy_sec", "query_ms")},
            "likealgo": like,
            "kernel_d10": {"max_abs_err": max(errs), **timing}}


class EcomTruth:
    """An e-commerce model's tables in float64, and the events written
    around its training: each user's views, the unavailable items."""

    def __init__(self, model, seen: dict, unavailable: set):
        self.U = np.asarray(model.user_factors, np.float64)
        self.V = np.asarray(model.item_factors, np.float64)
        from predictionio_torch.ops.topk import cosine_normalize

        self.N = np.asarray(cosine_normalize(model.item_factors), np.float64)
        self.users = {n: j for j, n in enumerate(model.user_ids.keys())}
        self.names = list(model.item_ids.keys())
        self.rows = {n: j for j, n in enumerate(self.names)}
        self.rated_users = model.rated_users
        self.rated_items = model.rated_items
        self.cats = model.item_categories
        self.seen, self.unavailable = seen, unavailable
        self.vmax = float(np.linalg.norm(self.V, axis=1).max())

    def answer(self, q):
        num = int(q.get("num", 10))
        user = q["user"]
        black = (set(q.get("blackList", ())) | self.seen.get(user, set())
                 | self.unavailable)
        allowed = self.rated_items.copy()
        allowed[[self.rows[x] for x in black if x in self.rows]] = False
        if q.get("categories"):
            want = set(q["categories"])
            allowed &= np.array([bool(want & set(self.cats.get(n, ())))
                                 for n in self.names])
        row = self.users.get(user)
        if row is not None and self.rated_users[row]:
            scores = self.V @ self.U[row]
            tol = 1e-5 * float(np.linalg.norm(self.U[row])) * self.vmax
        else:
            recent = [self.rows[x] for x in self.seen.get(user, ())
                      if x in self.rows]
            if not recent:
                return [], 0.0, False
            qvec = self.N[recent].sum(axis=0)
            scores = self.N @ qvec
            tol = 1e-5 * float(np.linalg.norm(qvec))
        top = top_rows(scores, allowed, num)
        keep = [j for j in top[:num] if scores[j] > 0.0]
        return ([(self.names[j], float(scores[j])) for j in keep], tol,
                ambiguous(scores, top, num, tol))


def ecommerce_phase(ratings, root: str) -> dict:
    """(c) The e-commerce Quick Start at MovieLens-20M widths, in the
    eventlog store at ``root`` (app ``ECOM_APP``; the caller removes
    it)."""
    import datetime as dt

    from predictionio_torch.data.event import Event
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.models.ecommerce import ECommModel

    uu, ii, vals = ratings
    n = len(uu)
    env, sub_env = eventlog_env(root)
    rng = np.random.default_rng(SEED + 13)
    storage = Storage.from_env(env)
    events = storage.events()
    app = storage.apps().insert(ECOM_APP)
    events.init(app.id)
    t0 = time.perf_counter()
    put_entities(events, app.id, rng)
    events.insert_columnar(
        interactions(uu, ii, ["rate"], np.zeros(n),
                     np.arange(n, dtype=np.int64) * 1_000_000,
                     value=vals), app.id, entity_type="user",
        target_entity_type="item", value_property="rating")
    events.close()
    ingest_sec = time.perf_counter() - t0

    qs = quick_start(sub_env, root, "ecommercerecommendation",
                     "ml20m-ec", [{"name": "als", "params": {
                         "app_name": "ml20m-ec", "unseen_only": True}}],
                     "e-commerce")
    (model,) = qs["models"]
    if not isinstance(model, ECommModel) or model.user_factors.shape \
            != (N_USERS, 10) or not np.all(
                np.isfinite(model.item_factors)):
        fail("pio train stored no finite rank-10 e-commerce model")

    # the serve-time events, written once the model exists: a known
    # user's views (unseenOnly), the constraint on another user's
    # best items, a new user's views. The three users are drawn until
    # every query's answer, with those views and that constraint
    # applied, is one float32 cannot move (a user's own top 10 may be
    # clear while the items behind an exclusion are a near-tie)
    base = EcomTruth(model, {}, set())
    clear = ((user, [x for x, _ in ans])
             for user in (f"u{j}" for j in rng.permutation(N_USERS))
             for ans, _, amb in [base.answer({"user": user, "num": 10})]
             if not amb and len(ans) == 10)
    redrawn = 0
    while True:
        (known, _), (seen_user, seen_top), (unavail_user, unavail_top) = \
            [next(clear) for _ in range(3)]
        unavailable = set(unavail_top[:ECOM_UNAVAILABLE])
        # the new user views the first run of consecutive items whose
        # answer float32 cannot move
        for start in range(0, N_ITEMS, ECOM_NEW_USER_VIEWS):
            views = {f"i{j}" for j in range(start,
                                            start + ECOM_NEW_USER_VIEWS)}
            ans, _, amb = EcomTruth(model, {"u-new": views},
                                    unavailable).answer(
                {"user": "u-new", "num": 10})
            if not amb and len(ans) == 10:
                break
        seen = {seen_user: set(seen_top[:ECOM_SEEN_VIEWS]), "u-new": views}
        truth = EcomTruth(model, seen, unavailable)
        cats = sorted(model.item_categories.get(
            truth.answer({"user": known, "num": 1})[0][0][0], ["c0"]))[:1]
        queries = [{"user": known, "num": 10},
                   {"user": seen_user, "num": 10},
                   {"user": known, "num": 10, "categories": cats},
                   {"user": known, "num": 10,
                    "blackList": [x for x, _ in truth.answer(
                        {"user": known, "num": 3})[0]]},
                   {"user": unavail_user, "num": 10},
                   {"user": "u-new", "num": 10}]
        if not any(truth.answer(q)[2] for q in queries):
            break
        redrawn += 1
    t1 = dt.datetime(2027, 1, 1, tzinfo=dt.timezone.utc)
    extra = [Event(event="view", entity_type="user", entity_id=user,
                   target_entity_type="item", target_entity_id=item,
                   event_time=t1 + dt.timedelta(seconds=k))
             for user, items in seen.items()
             for k, item in enumerate(sorted(items))]
    extra.append(Event(event="$set", entity_type="constraint",
                       entity_id="unavailableItems",
                       properties={"items": sorted(unavailable)},
                       event_time=t1))
    events = Storage.from_env(env).events()
    events.insert_batch(extra, app.id)
    events.close()

    expected = []
    for q in queries:
        ans, tol, amb = truth.answer(q)
        if amb:
            fail(f"e-commerce query {q} is ambiguous in float32")
        if not ans:
            fail(f"e-commerce query {q} expects no items")
        expected.append((ans, tol))
    answers = dict(zip(map(json.dumps, queries), expected))

    def check(q, got, what):
        exp, tol = answers[json.dumps(q)]
        check_ranked(exp, tol, got, what, q)
        served = {e["item"] for e in got["itemScores"]}
        if served & (truth.seen.get(q["user"], set()) | unavailable):
            fail(f"{what}: a seen or unavailable item was served "
                 f"for {q}")

    served = serve_and_check(CLI, qs["engine_json"], sub_env, root,
                             queries, check, "e-commerce")
    return {"events": {"rates": n, "sets": N_USERS + N_ITEMS,
                       "serve_time": len(extra)},
            "ingest_sec": ingest_sec, **qs["secs"],
            "train_log": qs["train_log"], "queries": len(queries),
            "redrawn_user_triples": redrawn,
            **{k: served[k] for k in ("deploy_sec", "query_ms")}}


def depth_cut(uu, ii) -> np.ndarray:
    """The rows a depth cut keeps: every ``PROJECT_STRIDE``-th rating
    plus each user's and each item's first, so that every user and item
    still appears."""
    keep = np.zeros(len(uu), bool)
    keep[::PROJECT_STRIDE] = True
    keep[np.unique(uu, return_index=True)[1]] = True
    keep[np.unique(ii, return_index=True)[1]] = True
    return keep


def project_ratings(ratings):
    """The project phase's depth (``depth_cut``)."""
    uu, ii, vals = ratings
    keep = depth_cut(uu, ii)
    return uu[keep], ii[keep], vals[keep]


def project_phase(ratings, ecom_root: str) -> dict:
    """Phase 12; the e-commerce Quick Start in the store at
    ``ecom_root``."""
    t0 = time.perf_counter()
    ckpt = checkpoint_phase()
    t1 = time.perf_counter()
    similar = similar_product_phase(ratings)
    t2 = time.perf_counter()
    ecom = ecommerce_phase(ratings, ecom_root)
    return {"checkpoint": ckpt, "checkpoint_phase_sec": t1 - t0,
            "similar_product": similar, "similar_product_phase_sec": t2 - t1,
            "ecommerce": ecom,
            "ecommerce_phase_sec": time.perf_counter() - t2}


# -- phase 13: the engine families -------------------------------------------------

def np_session_hidden(params: dict, cfg, seq: np.ndarray) -> np.ndarray:
    """float64 host forward of the stored session encoder over one
    1-shifted history ``seq`` [L]: the hidden state at its last real
    position (a plain numpy reading of the flax layout, independent of
    the port's modules)."""
    p = {k: v for k, v in params["params"].items()}
    f = lambda a: np.asarray(a, np.float64)

    def ln(x, w):
        mu = x.mean(-1, keepdims=True)
        var = ((x - mu) ** 2).mean(-1, keepdims=True)
        return (x - mu) / np.sqrt(var + 1e-6) * f(w["scale"]) + f(w["bias"])

    L, dim = len(seq), cfg.dim
    x = f(p["item_embed"]["embedding"])[seq] * dim ** 0.5 \
        + f(p["pos_embed"])[:L]
    causal = np.arange(L)[:, None] >= np.arange(L)[None, :]
    for i in range(cfg.layers):
        b = p[f"block_{i}"]
        h = ln(x, b["LayerNorm_0"])
        qkv = np.einsum("ld,dthe->lthe", h, f(b["DenseGeneral_0"]["kernel"])) \
            + f(b["DenseGeneral_0"]["bias"])
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        s = np.einsum("qhd,khd->hqk", q, k) * q.shape[-1] ** -0.5
        s = np.where(causal[None], s, -np.inf)
        w = np.exp(s - s.max(-1, keepdims=True))
        w /= w.sum(-1, keepdims=True)
        o = np.einsum("hqk,khd->qhd", w, v)
        x = x + np.einsum("qhd,hde->qe", o,
                          f(b["DenseGeneral_1"]["kernel"])) \
            + f(b["DenseGeneral_1"]["bias"])
        h = ln(x, b["LayerNorm_1"]) @ f(b["Dense_0"]["kernel"]) \
            + f(b["Dense_0"]["bias"])
        h = 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi)
                                   * (h + 0.044715 * h ** 3)))
        x = x + h @ f(b["Dense_1"]["kernel"]) + f(b["Dense_1"]["bias"])
    x = ln(x, p["final_norm"]) * (seq > 0)[:, None]
    return x[max(int((seq > 0).sum()) - 1, 0)]


class SessionTruth:
    """A stored session recommender in float64: each query's expected
    ranked answer, its score tolerance and whether float32 could move
    an item across the cut."""

    def __init__(self, model):
        self.model = model
        self.params = model.state.params
        self.emb = np.asarray(self.params["params"]["item_embed"]["embedding"],
                              np.float64)[1:]
        self.names = list(model.item_ids.keys())
        self.rows = {n: j for j, n in enumerate(self.names)}
        self.emax = float(np.linalg.norm(self.emb, axis=1).max())

    def sequence(self, q):
        cfg = self.model.state.cfg
        if "items" in q:
            idx = [self.rows[i] + 1 for i in q["items"] if i in self.rows]
            row = np.zeros(cfg.max_len, np.int64)
            tail = idx[-cfg.max_len:]
            row[:len(tail)] = tail
            return row
        return self.model.state.sequences[
            self.model.user_ids[q["user"]]].astype(np.int64)

    def answer(self, q):
        num = int(q.get("num", 10))
        seq = self.sequence(q)
        last = np_session_hidden(self.params, self.model.state.cfg, seq)
        scores = self.emb @ last
        allowed = np.ones(len(self.names), bool)
        if q.get("excludeSeen"):
            allowed[seq[seq > 0] - 1] = False
        tol = SR_SCORE_TOL * float(np.linalg.norm(last)) * self.emax
        top = top_rows(scores, allowed, num)
        s = scores[top]
        amb = bool(len(s) > num and s[num - 1] - s[num] <= 4 * tol)
        return ([(self.names[j], float(scores[j])) for j in top[:num]], tol,
                amb)


def sessionrec_card_vs_cpu(model, ratings) -> dict:
    """The stored weights carried into a trainer on the card over the
    first ``SR_PROFILE_USERS`` users' ratings (the model's id coding):
    the tied loss and its gradient norm of one full-shape batch [256, 64]
    with dropout off, on the card and on the CPU; blockwise attention
    (``attn_block=16``) against the materialized form on the card; then
    20 steps timed, and 20 more under ``torch.profiler``: device time a
    step and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from predictionio_torch.ops import sessionrec as sr
    from predictionio_torch.ops.attention import (blockwise_attention,
                                                  mha_reference)

    uu, ii, _ = ratings
    u_code = np.full(N_USERS, -1, np.int64)
    i_code = np.full(N_ITEMS, -1, np.int64)
    for j in range(N_USERS):
        u_code[j] = model.user_ids.get(f"u{j}", -1)
    for j in range(N_ITEMS):
        i_code[j] = model.item_ids.get(f"i{j}", -1)
    sel = np.flatnonzero(uu < SR_PROFILE_USERS)
    u, i = u_code[uu[sel]], i_code[ii[sel]]
    ok = (u >= 0) & (i >= 0)
    state = model.state
    t0 = time.perf_counter()
    trainer = sr.SessionRecTrainer(
        (u[ok], i[ok], sel[ok].astype(np.float64)), len(model.user_ids),
        len(model.item_ids), state.cfg, device="cuda", params=state.params)
    setup_sec = time.perf_counter() - t0
    rows = np.flatnonzero((trainer.targets > 0).any(axis=1))
    batches = trainer.epoch_batches(np.random.default_rng(0).permutation(rows))
    if len(batches) < 43:
        fail(f"sessionrec profile: {len(batches)} batches, 43 needed")
    seq = torch.from_numpy(trainer.inputs[batches[0]])
    tgt = torch.from_numpy(trainer.targets[batches[0]])
    if tuple(seq.shape) != (state.cfg.batch_size, state.cfg.max_len):
        fail(f"sessionrec step batch {tuple(seq.shape)}")
    cpu_encoder = sr.SessionEncoder(trainer.n_items, state.cfg)
    cpu_encoder.load_state_dict(sr.params_from_flax(state.params))

    def loss_and_grad_norm(enc, dev):
        loss = sr.tied_loss(enc, seq.to(dev), tgt.to(dev), None)
        grads = torch.autograd.grad(loss, list(enc.parameters()))
        return loss.item(), float(torch.sqrt(sum(
            g.double().square().sum() for g in grads)))

    l_card, g_card = loss_and_grad_norm(trainer.encoder, "cuda")
    l_cpu, g_cpu = loss_and_grad_norm(cpu_encoder, "cpu")
    step = {"loss_card": l_card, "loss_cpu": l_cpu,
            "grad_norm_card": g_card, "grad_norm_cpu": g_cpu,
            "loss_rel_err": abs(l_card - l_cpu) / abs(l_cpu),
            "grad_norm_rel_err": abs(g_card - g_cpu) / abs(g_cpu)}
    if not (step["loss_rel_err"] <= SR_LOSS_RTOL
            and step["grad_norm_rel_err"] <= SR_GRAD_RTOL):
        fail(f"sessionrec step on the card against the CPU: {step}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn(256, state.cfg.max_len, state.cfg.heads,
                           state.cfg.dim // state.cfg.heads, device="cuda",
                           generator=gen) for _ in range(3))
    attn_err = float((blockwise_attention(q, k, v, block_size=16)
                      - mha_reference(q, k, v)).abs().max())
    if not attn_err <= 1e-5:
        fail(f"blockwise attention on the card: max error {attn_err}")

    dev_batches = [(torch.from_numpy(trainer.inputs[b]).cuda(),
                    torch.from_numpy(trainer.targets[b]).cuda())
                   for b in batches[:43]]
    for s_, t_ in dev_batches[:3]:
        trainer.step(s_, t_)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for s_, t_ in dev_batches[3:23]:
        trainer.step(s_, t_)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / 20
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for s_, t_ in dev_batches[23:43]:
            trainer.step(s_, t_)
        torch.cuda.synchronize()
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    ) / 1e3 / 20
    top = sorted(((e.self_device_time_total / 1e3 / 20, e.key)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 reverse=True)[:5]
    return {"setup_sec": setup_sec, "step": step,
            "blockwise_attention_max_err": attn_err,
            "steps_profiled": 20, "wall_ms_per_step": wall_ms,
            "device_ms_per_step": device_ms,
            "device_idle_share": 1.0 - device_ms / wall_ms,
            "step_peak_bytes": peak,
            "top_device_ms_per_step": [[round(ms, 4), key[:60]]
                                       for ms, key in top]}


def sessionrec_phase(root: str, ratings) -> dict:
    """(a) ``cli template get sessionrec``, ``cli train`` at the template
    defaults on the 20M ratings of the e-commerce store at ``root``,
    ``cli deploy``, lone queries checked against float64; then the card
    against the CPU."""
    import ast
    import math

    _, sub_env = eventlog_env(root)
    t0 = time.perf_counter()
    qs = quick_start(sub_env, root, "sessionrec", ECOM_APP,
                     [{"name": "sessionrec",
                       "params": {"epochs": SR_EPOCHS}}], "sessionrec",
                     project="project_sessionrec", build=False)
    (model,) = qs["models"]
    lines = [line for line in qs["stderr"].splitlines()
             if "sessionrec trained: " in line]
    if len(lines) != 1:
        fail(f"pio train (sessionrec) logged {len(lines)} 'trained' lines")
    trained = ast.literal_eval(lines[0].split("sessionrec trained: ", 1)[1])
    losses = trained["losses"]
    bound = math.log(len(model.item_ids) + 1)
    if not (len(losses) == model.state.cfg.epochs
            and all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0] and losses[-1] < bound):
        fail(f"sessionrec losses {losses} (ln V = {bound})")
    if trained["device"] != "cuda:0":
        fail(f"sessionrec trained on {trained['device']}")
    read = [line for line in qs["stderr"].splitlines()
            if "sessionrec training read:" in line]

    truth = SessionTruth(model)
    rng = np.random.default_rng(SEED + 15)
    users = [f"u{j}" for j in rng.permutation(N_USERS)]
    queries, expected, skipped = [], {}, 0
    shapes = ([{"num": 10}] * 3 + [{"num": 10, "excludeSeen": True}] * 3
              + [{"num": 30}])
    for user, shape in zip(users, shapes * 4):
        if len(queries) == len(shapes):
            break
        q = {"user": user, **shape}
        ans, tol, amb = truth.answer(q)
        if amb:
            skipped += 1
            continue
        queries.append(q)
        expected[json.dumps(q)] = (ans, tol)
    for excl in (False, True):
        q = {"items": [truth.names[j] for j in rng.integers(
            0, len(truth.names), 5)], "num": 10, "excludeSeen": excl}
        ans, tol, amb = truth.answer(q)
        if amb:
            skipped += 1
            continue
        queries.append(q)
        expected[json.dumps(q)] = (ans, tol)
    worst = [0.0]

    def check(q, got, what):
        exp, tol = expected[json.dumps(q)]
        check_ranked(exp, tol, got, what, q)
        worst[0] = max([worst[0]] + [abs(e["score"] - s) for e, (_, s)
                                     in zip(got["itemScores"], exp)])
        if q.get("excludeSeen"):
            seen = {truth.names[j - 1] for j in truth.sequence(q) if j > 0}
            if seen & {e["item"] for e in got["itemScores"]}:
                fail(f"{what}: a seen item was served for {q}")

    served = serve_and_check(CLI, qs["engine_json"], sub_env, root, queries,
                             check, "sessionrec")
    launches = (served["retrieval_after"][0]["kernel_launches"]
                - served["retrieval_before"][0]["kernel_launches"])
    if launches != len(queries):
        fail(f"sessionrec deploy: topk_dot launched {launches} times for "
             f"{len(queries)} lone queries")
    card = sessionrec_card_vs_cpu(model, ratings)
    return {"users": len(model.user_ids), "items": len(model.item_ids),
            **qs["secs"], "read_log": read,
            "trained": {k: trained[k] for k in (
                "events", "sequence_sec", "setup_sec", "epoch_sec",
                "steps_per_epoch", "step_ms", "losses", "peak_bytes")},
            "ln_vocab": bound, "queries": len(queries),
            "skipped_ambiguous": skipped, "max_score_err": worst[0],
            "topk_dot_launches": launches,
            **{k: served[k] for k in ("deploy_sec", "query_ms")},
            "card_vs_cpu": card, "phase_sec": time.perf_counter() - t0}


def classification_phase(root: str) -> dict:
    """(b) The classification Quick Start: ``FAM_CLS_USERS`` users with a
    ``plan`` of ``FAM_CLS_LABELS`` labels and Poisson counts
    ``attr0..attr2`` around the label's base, ``$set`` into an eventlog
    store; both algorithms trained on the card and deployed."""
    from predictionio_torch.data.storage import Storage

    env, sub_env = eventlog_env(root)
    rng = np.random.default_rng(SEED + 16)
    labels = rng.integers(0, FAM_CLS_LABELS, FAM_CLS_USERS)
    feats = rng.poisson(CLS_BASES[labels]).astype(np.float64)
    storage = Storage.from_env(env)
    events = storage.events()
    app = storage.apps().insert("cls200k")
    events.init(app.id)
    t0 = time.perf_counter()
    insert_rows(events, app.id, [
        {"event": "$set", "entityType": "user", "entityId": f"c{j}",
         "properties": {"plan": float(labels[j]),
                        **{f"attr{a}": float(feats[j, a]) for a in range(3)}},
         "eventTime": "2026-01-01T00:00:00.000Z"}
        for j in range(FAM_CLS_USERS)])
    events.close()
    ingest_sec = time.perf_counter() - t0
    qs = quick_start(sub_env, root, "classification", "cls200k",
                     [{"name": "naive", "params": {}},
                      {"name": "logistic", "params": {}}],
                     "classification", project="project_cls", build=False)
    nb, lr = qs["models"]
    # naive Bayes against float64 counts of the same points
    onehot = labels[:, None] == np.arange(FAM_CLS_LABELS)[None, :]
    counts, sums = onehot.sum(0).astype(np.float64), onehot.T.astype(
        np.float64) @ feats
    pi = np.log(counts + 1.0) - np.log(FAM_CLS_USERS + FAM_CLS_LABELS)
    theta = np.log(sums + 1.0) - np.log(sums.sum(1, keepdims=True) + 3.0)
    nb_err = max(float(np.abs(nb.pi - pi).max()),
                 float(np.abs(nb.theta - theta).max()))
    if not (np.array_equal(nb.class_labels, np.arange(FAM_CLS_LABELS))
            and nb_err <= 1e-5):
        fail(f"naive Bayes pi/theta {nb_err} from float64")
    # logistic regression's stored weights in float64 on a seeded sample
    pick = rng.choice(FAM_CLS_USERS, 2000, replace=False)
    sample = feats[pick]
    z = ((sample - lr.feature_mean.astype(np.float64))
         / lr.feature_std.astype(np.float64)) @ lr.weights.astype(
             np.float64) + lr.bias.astype(np.float64)
    top2 = np.sort(z, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    lr_pred = lr.predict_batch(sample.astype(np.float32))
    if not np.array_equal(lr_pred[clear], np.argmax(z, 1)[clear]):
        fail("logistic regression predictions differ from float64")
    lr_acc = float(np.mean(np.argmax(z, 1) == labels[pick]))
    # served answers (FirstServing: naive Bayes) against float64
    queries, want = [], {}
    for x in rng.poisson(CLS_BASES[rng.integers(0, FAM_CLS_LABELS, 40)]):
        scores = pi + theta @ x
        top2 = np.sort(scores)[-2:]
        if top2[1] - top2[0] <= 1e-4 * (1 + np.abs(scores).max()):
            continue
        q = {"features": [float(v) for v in x]}
        queries.append(q)
        want[json.dumps(q)] = float(np.argmax(scores))
        if len(queries) == 12:
            break

    def check(q, got, what):
        if got != {"label": want[json.dumps(q)]}:
            fail(f"{what}: {got} for {q}, float64 says "
                 f"{want[json.dumps(q)]}")

    served = serve_and_check(CLI, qs["engine_json"], sub_env, root, queries,
                             check, "classification")
    return {"entities": FAM_CLS_USERS, "ingest_sec": ingest_sec,
            **qs["secs"], "nb_max_err": nb_err,
            "lr_clear_predictions": int(clear.sum()), "lr_accuracy": lr_acc,
            "queries": len(queries),
            **{k: served[k] for k in ("deploy_sec", "query_ms")}}


def regression_phase(root: str) -> dict:
    """(c) The regression Quick Start: a seeded ``lr_data.txt`` of
    ``REG_ROWS`` rows (``y = x . REG_TRUE_W`` plus noise), ``cli train``
    of SGD (400 iterations, step 0.2) and ridge on the card, the stored
    weights against ``REG_TRUE_W``, ``cli deploy``'s ``AverageServing``
    answers against float64 of the stored weights."""
    _, sub_env = eventlog_env(root)
    rng = np.random.default_rng(SEED + 17)
    x = rng.normal(size=(REG_ROWS, 3)).astype(np.float32)
    y = x @ REG_TRUE_W + 0.01 * rng.normal(size=REG_ROWS).astype(np.float32)
    path = os.path.join(root, "lr_data.txt")
    t0 = time.perf_counter()
    np.savetxt(path, np.column_stack([y, x]), fmt="%.8g")
    write_sec = time.perf_counter() - t0
    qs = quick_start(sub_env, root, "regression", None,
                     [{"name": "sgd", "params": {"iterations": 400,
                                                 "step_size": 0.2}},
                      {"name": "ridge", "params": {}}],
                     "regression", project="project_reg", build=False,
                     datasource={"filepath": path})
    models = qs["models"]
    for m in models:
        if not np.allclose(m.weights, REG_TRUE_W, atol=0.01):
            fail(f"regression weights {m.weights} vs {REG_TRUE_W}")
    queries, want = [], {}
    for xq in rng.normal(size=(10, 3)):
        q = {"features": [float(v) for v in xq]}
        queries.append(q)
        want[json.dumps(q)] = np.mean([
            float(np.asarray(m.weights, np.float64) @ xq) + m.intercept
            for m in models])
    err = [0.0]

    def check(q, got, what):
        err[0] = max(err[0], abs(got - want[json.dumps(q)]))
        if not err[0] <= 1e-5:
            fail(f"{what}: {got} for {q}, float64 says "
                 f"{want[json.dumps(q)]}")

    served = serve_and_check(CLI, qs["engine_json"], sub_env, root, queries,
                             check, "regression")
    return {"rows": REG_ROWS, "write_sec": write_sec, **qs["secs"],
            "weights": [[float(v) for v in m.weights] for m in models],
            "intercepts": [m.intercept for m in models],
            "max_answer_err": err[0],
            **{k: served[k] for k in ("deploy_sec", "query_ms")}}


def e2_run() -> dict:
    """(c) The e2 models on the card against float64: categorical naive
    Bayes over seeded points, a Markov chain over a seeded tally."""
    from predictionio_torch.models import markov, naive_bayes

    rng = np.random.default_rng(SEED + 18)
    n, vocab = 100_000, (3, 5, 2, 7)
    lab = rng.integers(0, 4, n)
    vals = np.stack([(lab + rng.integers(0, 2, n) * rng.integers(0, v, n)) % v
                     for v in vocab], 1)
    points = [naive_bayes.LabeledPoint(f"L{l}", [f"v{x}" for x in row])
              for l, row in zip(lab, vals)]
    t0 = time.perf_counter()
    model = naive_bayes.train(points)
    nb_sec = time.perf_counter() - t0
    err, mism = 0.0, 0
    for label, li in model.labels.items():
        rows = lab == int(label[1:])
        err = max(err, abs(model.priors[label] - np.log(rows.mean())))
        for s, v in enumerate(vocab):
            for value, vi in model.vocabs[s].items():
                c = np.count_nonzero(vals[rows, s] == int(value[1:]))
                if c:
                    err = max(err, abs(model.likelihoods[label][s][value]
                                       - np.log(c / rows.sum())))
    batch = [[f"v{int(rng.integers(0, v))}" for v in vocab]
             for _ in range(1000)]
    scores = model.score_batch(batch)
    lik = np.asarray(model._likelihoods, np.float64)
    pri = np.asarray(model._priors, np.float64)
    ids = model.encode_features(batch)
    ref = pri[None, :] + lik[:, np.arange(len(vocab))[None, :],
                             ids].sum(2).T
    finite = np.isfinite(ref)
    score_err = float(np.abs(scores[finite] - ref[finite]).max())
    if not (err <= 1e-5 and score_err <= 1e-5
            and np.array_equal(np.isfinite(scores), finite)):
        fail(f"categorical naive Bayes: tables {err}, scores {score_err}")
    states, top_n = 2000, 16
    tally = (rng.integers(0, states, 200_000), rng.integers(0, states, 200_000),
             rng.integers(1, 9, 200_000).astype(np.float64))
    t0 = time.perf_counter()
    chain = markov.train(tally, states, top_n)
    mk_sec = time.perf_counter() - t0
    dense = np.zeros((states, states))
    np.add.at(dense, (np.repeat(np.arange(states), top_n),
                      chain.indices.reshape(-1)),
              chain.probs.reshape(-1).astype(np.float64))
    cur = rng.dirichlet(np.ones(states))
    got = np.asarray(chain.predict(cur.astype(np.float32)))
    mk_err = float(np.abs(got - cur @ dense).max())
    if not mk_err <= 1e-6:
        fail(f"Markov chain predict {mk_err} from float64")
    return {"naive_bayes": {"points": n, "train_sec": nb_sec,
                            "table_err": err, "score_err": score_err,
                            "device": str(model.device)},
            "markov": {"states": states, "top_n": top_n, "train_sec": mk_sec,
                       "predict_err": mk_err, "device": str(chain.device)}}


def families_rest_phase() -> dict:
    """(b) and (c): classification, regression, vanilla and the e2
    models; one eventlog store, removed at the end."""
    root = temp_store("pio_chip_smoke_families_", 1 << 30)
    try:
        t0 = time.perf_counter()
        cls = classification_phase(root)
        t1 = time.perf_counter()
        reg = regression_phase(root)
        t2 = time.perf_counter()
        _, sub_env = eventlog_env(root)
        qs = quick_start(sub_env, root, "vanilla", "cls200k",
                         [{"name": "algo", "params": {"mult": 3}}],
                         "vanilla", project="project_vanilla", build=False)

        def check(q, got, what):
            if got != {"p": 6.0}:
                fail(f"{what}: {got} for {q}")

        van = serve_and_check(CLI, qs["engine_json"], sub_env, root,
                              [{"q": 2.0}], check, "vanilla")
        t3 = time.perf_counter()
        e2 = e2_run()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"classification": {**cls, "phase_sec": t1 - t0},
            "regression": {**reg, "phase_sec": t2 - t1},
            "vanilla": {**qs["secs"], "deploy_sec": van["deploy_sec"],
                        "phase_sec": t3 - t2},
            "e2": {**e2, "phase_sec": time.perf_counter() - t3}}


# -- multi-device phase --------------------------------------------------------

# phase 14: the ALS train's config (ML-20M widths, rank 64, 2 iterations;
# direct f32 solves, whose factors tests/test_torch_als.py holds to a
# relative Frobenius error of 1e-4 across summation orders), the sharded
# scorer's queries, and the workers' time limit
MD_ITERS, MD_K, MD_LONE, MD_BATCH = 2, 16, 64, 64
MD_FACTOR_TOL, MD_RMSE_TOL = 1e-4, 1e-3
MD_WORKER_TIMEOUT = 300
# phase 14 (c): the two-tower trainer at the stretch width (TT_*, bf16)
# for MD_TT_STEPS steps (one epoch of the first MD_TT_STEPS * TT_BATCH
# positives) from one carried state. DP and TP compute the world of one's
# arithmetic (the same gathered batch through flash_ce, the same rows
# through embed_update); only the float atomics that sum a row's
# duplicates in embed_update reorder, which moves a loss by ~1e-7 and a
# table entry (|x| ~ 0.09) by ~1e-6 after a few steps, so the ranks are
# held to the world of one at rtol 1e-4 (losses) and atol 2e-4 (every
# table entry). (d): the session recommender at phase 13's width (dim 64,
# 2 heads, 2 layers, max_len 64, batch 256, the ML-20M catalog) for one
# epoch over the first MD_SR_USERS users' histories (MD_SR_STEPS steps),
# dropout off: ring attention over two ranks, or the batch split over
# two, against blockwise attention in one process sum f32 products in
# another order, and AdamW moves entries whose gradient is at rounding
# level by +-lr on that rounding, so the epoch's loss is held at rtol
# 1e-4, the CPU tests' epoch tolerance against the JAX trainer
MD_TT_STEPS, MD_TT_LOSS_RTOL, MD_TT_TABLE_ATOL = 6, 1e-4, 2e-4
MD_SR_STEPS, MD_SR_USERS, MD_SR_LOSS_RTOL = 4, 1024, 1e-4


def md_config():
    from predictionio_torch.ops.als import ALSConfig

    return ALSConfig(rank=RANK, iterations=MD_ITERS, reg=ALS_REG,
                     block_size=ALS_BLOCK, solver="direct",
                     compute_dtype="float32", cg_dtype="float32")


def md_ratings(ratings):
    """Phase 14's ratings: the front door's history cut (``depth_cut`` of
    the first ``FD_HISTORY``: 5,051,090, every width kept), every 20th
    held out as in the ALS phase. -> (train COO, held-out COO)."""
    uu, ii, vals = ratings
    rows = np.flatnonzero(depth_cut(uu, ii)[:FD_HISTORY])
    held = np.zeros(len(rows), bool)
    held[::20] = True
    u, i, r = uu[rows], ii[rows], vals[rows].astype(np.float32)
    return (u[~held], i[~held], r[~held]), (u[held], i[held], r[held])


def md_sides(coo, n_shards: int) -> tuple:
    """Both sides of ``coo``'s layout for ``n_shards`` shards (host
    binning, the native one-pass route)."""
    from predictionio_torch.ops.als import build_compressed_side

    u, i, r = coo
    cfg = md_config()
    return (build_compressed_side(u, i, r, N_USERS, cfg, n_shards, None),
            build_compressed_side(i, u, r, N_ITEMS, cfg, n_shards, None))


def md_train(sides, total: int, mesh) -> tuple:
    """``ALSTrainer.from_sides`` on the rank's card over ``mesh`` (None:
    no mesh): one warm alternation, then ``MD_ITERS`` timed. ->
    (factors, ms an alternation)."""
    import torch
    from predictionio_torch.ops.als import ALSTrainer

    trainer = ALSTrainer.from_sides(*sides, N_USERS, N_ITEMS, total,
                                    md_config(), device="cuda",
                                    mesh=mesh).compile()
    t0 = time.perf_counter()
    trainer.step_n()
    ms = 1e3 * (time.perf_counter() - t0) / MD_ITERS
    factors = trainer.factors()
    del trainer
    torch.cuda.empty_cache()
    return factors, ms


def rel_frob(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


def factor_diffs(x_got, y_got, want) -> dict:
    """The larger relative Frobenius error of the two tables against
    ``want`` (an ``ALSFactors``), and the largest element difference."""
    pairs = ((x_got, want.user_factors), (y_got, want.item_factors))
    return {"rel_err": max(rel_frob(a, b) for a, b in pairs),
            "max_abs_diff": max(float(np.abs(a - b).max())
                                for a, b in pairs)}


def md_queries():
    """The sharded scorer's queries, the same on every rank (the scorer
    is SPMD): ``MD_LONE`` lone users with 0, 1 or 4 of their best items
    excluded, and one batch of ``MD_BATCH`` users excluding their best."""
    rng = np.random.default_rng(SEED + 14)
    U, V, _, _ = ml20m_factors(np.random.default_rng(SEED))
    users = rng.integers(0, N_USERS, MD_LONE + MD_BATCH)
    best = np.argsort(-(U[users] @ V.T), axis=1)[:, :4]
    lone = []
    for j in range(MD_LONE):
        e = (0, 1, 4)[j % 3]
        lone.append((users[j:j + 1], best[j:j + 1, :e].astype(np.int32)
                     if e else None))
    batch = (users[MD_LONE:], best[MD_LONE:, :1].astype(np.int32))
    return U, V, lone, batch


def check_scored(truth, users, excl, k: int, scores, ids, what: str):
    """A sharded answer ([B, k] scores and ids for rows ``users``,
    ``excl`` [B, E] or None) against float64 under phase 2's near-tie
    rule: each slot's score within 1e-5 |q| max|item| of the float64
    ranking's, and an id other than the float64 one only where that
    item scores within the same tolerance of the slot."""
    for b, u in enumerate(users):
        q = truth.U[u]
        scores64 = truth.V @ q
        allowed = np.ones(len(truth.V), bool)
        if excl is not None:
            allowed[excl[b][excl[b] >= 0]] = False
        cand = np.flatnonzero(allowed)
        order = cand[np.lexsort((cand, -scores64[cand]))[:k]]
        tol = 1e-5 * float(np.linalg.norm(q)) * truth.vmax
        if len(set(ids[b].tolist())) != k or not allowed[ids[b]].all():
            fail(f"{what}: row {b} repeats or serves an excluded item")
        for j in range(k):
            if abs(float(scores[b, j]) - scores64[order[j]]) > tol:
                fail(f"{what}: row {b} slot {j} score {scores[b, j]} vs "
                     f"{scores64[order[j]]}")
            if ids[b, j] != order[j] and abs(
                    scores64[ids[b, j]] - scores64[order[j]]) > tol:
                fail(f"{what}: row {b} slot {j} item {ids[b, j]} vs "
                     f"{order[j]}")


def md_score_all(scorer, U, lone, batch, truth, what: str) -> dict:
    """Every query through ``scorer`` (counted launches), each answer
    checked against float64. -> launches, lone ms (median, max)."""
    import torch
    from predictionio_torch.ops.kernels import topk_dot as tkd

    dev = scorer.device
    tkd.launches.reset()
    lat = []
    for users, excl in lone:
        t0 = time.perf_counter()
        s, i = scorer.score(torch.as_tensor(U[users], device=dev), MD_K,
                            excl)
        lat.append(1e3 * (time.perf_counter() - t0))
        check_scored(truth, users, excl, MD_K, s, i, f"{what} lone")
    users, excl = batch
    s, i = scorer.score(torch.as_tensor(U[users], device=dev), MD_K, excl)
    launches = tkd.launches.value
    check_scored(truth, users, excl, MD_K, s, i, f"{what} batch")
    calls = len(lone) + 1
    if launches != calls:
        fail(f"{what}: topk_dot launched {launches} times for {calls} "
             "score calls")
    lat.sort()
    return {"launches": launches, "score_calls": calls,
            "lone_ms_p50": lat[len(lat) // 2], "lone_ms_max": lat[-1]}


def md_ml100k_store(root: str) -> dict:
    """A localfs store at the ``pio train`` phase's ML-100K shape (its
    seed): 943 users, 1,682 items, 100,000 rate events. -> its env."""
    from predictionio_torch.data.storage import EventColumns, Storage

    env = localfs_env(root)
    rng = np.random.default_rng(SEED + 3)
    n_users, n_items, n = 943, 1682, 100_000
    us = rng.integers(1, n_users + 1, n)
    its = rng.integers(1, n_items + 1, n)
    rs = rng.integers(1, 6, n)
    storage = Storage.from_env(env)
    app = storage.apps().insert("ml100k")
    storage.events().init(app.id)
    storage.events().insert_columnar(EventColumns(
        entity_codes=(us - 1).astype(np.int32),
        target_codes=(its - 1).astype(np.int32),
        name_codes=np.zeros(n, np.int32), values=rs.astype(np.float64),
        times_us=(883_612_800 + np.arange(n, dtype=np.int64)) * 1_000_000,
        entity_vocab=[f"u{j}" for j in range(1, n_users + 1)],
        target_vocab=[f"i{j}" for j in range(1, n_items + 1)],
        names=["rate"]), app.id, entity_type="user",
        target_entity_type="item", value_property="rating")
    return env


def md_tt_state():
    """(c)'s carried state, on the host: both 1M x 128 tables ~ N(0,
    1/128) from a seeded CPU generator (the same bits in every process),
    zero accumulators, and the stretch config's empty tails."""
    import torch
    from predictionio_torch.ops.twotower import SIDES, TwoTowerState

    gen = torch.Generator().manual_seed(SEED + 140)
    tables = {side: torch.randn((TT_IDS, TT_DIM), generator=gen)
              * TT_DIM ** -0.5 for side in SIDES}
    return TwoTowerState(tables=tables,
                         acc={side: torch.zeros(TT_IDS) for side in SIDES},
                         dense={side: [] for side in SIDES})


def md_tt_data():
    """(c)'s positives (the first ``MD_TT_STEPS`` batches of the stretch
    positives) and its one epoch order."""
    uu, ii = synth_positives()
    n = MD_TT_STEPS * TT_BATCH
    return ((uu[:n], ii[:n], None),
            np.random.default_rng(SEED + 141).permutation(n))


def md_tt_run(pos, perm, state, mesh, **cfg) -> tuple:
    """One epoch (``MD_TT_STEPS`` steps) of the stretch two-tower trainer
    on this process's card over ``mesh`` from ``state``, its kernel
    launches counted. -> (trainer, summary)."""
    import torch
    from predictionio_torch.ops.kernels import embed_update as eu
    from predictionio_torch.ops.kernels import flash_ce as fce
    from predictionio_torch.ops.twotower import (TwoTowerConfig,
                                                 TwoTowerTrainer)

    trainer = TwoTowerTrainer(
        pos, TT_IDS, TT_IDS,
        TwoTowerConfig(dim=TT_DIM, batch_size=TT_BATCH, epochs=1,
                       learning_rate=3e-3, seed=11, temperature=TEMP, **cfg),
        device="cuda", state=state, mesh=mesh)
    torch.cuda.synchronize()
    fce.launches.reset()
    eu.launches.reset()
    losses = trainer.run(perms=[perm])
    torch.cuda.synchronize()
    launches = {"flash_ce": fce.launches.value,
                "embed_update": eu.launches.value}
    if launches != {"flash_ce": 3 * MD_TT_STEPS,
                    "embed_update": 2 * MD_TT_STEPS}:
        fail(f"phase 14 (c): {MD_TT_STEPS} steps over {mesh} launched "
             f"{launches}, 3 and 2 a step expected")
    if not (trainer.kernel_plan["flash_ce"]
            and trainer.kernel_plan["embed_update"]):
        fail(f"phase 14 (c): kernel plan {trainer.kernel_plan}")
    return trainer, {"losses": losses,
                     "ms_per_step": 1e3 * trainer.epoch_seconds[0]
                     / MD_TT_STEPS, "launches": launches}


def md_tt_table_err(trainer, state, ref) -> float:
    """Largest difference of this rank's rows of both tables from the
    world of one's: ``ref`` holds its final rows at the ids the epoch
    touched, every other row is the carried state's."""
    import torch
    from predictionio_torch.ops.twotower import SIDES

    err = 0.0
    for side in SIDES:
        start, stop = trainer.slabs[side]
        want = state.tables[side][start:stop].to("cuda", copy=True)
        ids = torch.as_tensor(ref[f"{side}_ids"], device="cuda")
        rows = torch.as_tensor(ref[f"{side}_rows"], device="cuda")
        own = (ids >= start) & (ids < stop)
        want[ids[own] - start] = rows[own]
        err = max(err, float((trainer.tables[side] - want).abs().max()))
    return err


def md_sr_setup(train):
    """(d)'s data, config and weights: the first ``MD_SR_USERS`` users'
    ratings of phase 14's ALS cut as histories (row order for time) over
    the whole ML-20M catalog, phase 13's widths, dropout off, and one
    seeded CPU initialization (the same in every process)."""
    import torch
    from predictionio_torch.ops import sessionrec as sr

    u, i, _ = train
    keep = u < MD_SR_USERS
    events = (u[keep], i[keep], np.flatnonzero(keep).astype(np.float64))
    cfg = sr.SessionRecConfig(dim=64, heads=2, layers=2, ffn_mult=4,
                              max_len=64, dropout=0.0, batch_size=256,
                              epochs=1, seed=13)
    encoder = sr.SessionEncoder(N_ITEMS, cfg)
    sr.init_encoder(encoder, torch.Generator().manual_seed(SEED + 142))
    return events, cfg, sr.params_to_flax(encoder)


def md_sr_epoch(events, cfg, params, mesh=None) -> dict:
    """One epoch (``MD_SR_STEPS`` steps) of the session recommender
    through ``SessionRecTrainer.run`` on this process's card (over
    ``mesh``): the epoch's loss and the ms a step."""
    from predictionio_torch.ops import sessionrec as sr

    trainer = sr.SessionRecTrainer(events, MD_SR_USERS, N_ITEMS, cfg,
                                   device="cuda", params=params, mesh=mesh)
    losses = trainer.run(epochs=1)
    if trainer.steps_per_epoch != MD_SR_STEPS:
        fail(f"phase 14 (d): an epoch of {trainer.steps_per_epoch} steps, "
             f"{MD_SR_STEPS} expected")
    if not np.isfinite(losses[0]):
        fail(f"phase 14 (d): epoch loss {losses}")
    return {"loss": losses[0], "batch": trainer.batch,
            "ms_per_step": 1e3 * trainer.epoch_seconds[0] / MD_SR_STEPS}


def md_worker_train(rank: int, work: str, tt, sr_setup) -> dict:
    """(c) and (d) on one rank of the gloo world of two: the stretch
    two-tower trainer over ``{"data": 2}`` and over ``{"model": 2}`` with
    ``shard_embeddings`` (checkpointed by rank 0 alone and resumed by
    both), then the session recommender with ``seq_axis`` over
    ``{"seq": 2}`` and with the batch split over ``{"data": 2}``; each
    held to the world of one's results in ``work``."""
    import torch
    from predictionio_torch.ops.twotower import SIDES, TwoTowerTrainer
    from predictionio_torch.parallel import multihost as mh
    from predictionio_torch.parallel.mesh import create_mesh

    pos, perm, state = tt
    ref = np.load(os.path.join(work, "tt_ref.npz"))
    sr_ref = json.load(open(os.path.join(work, "sr_ref.json")))
    out = {}
    t0 = time.perf_counter()
    for name, axes, cfg in (("dp", {"data": 2}, {}),
                            ("tp", {"model": 2},
                             {"shard_embeddings": True,
                              "checkpoint_dir": os.path.join(work, "ckpt")})):
        trainer, summary = md_tt_run(pos, perm, state, create_mesh(axes),
                                     **cfg)
        summary["loss_rel_err"] = max(
            abs(a - b) / abs(b) for a, b in zip(summary["losses"],
                                                ref["losses"]))
        summary["table_max_abs_err"] = md_tt_table_err(trainer, state, ref)
        summary["slabs"] = trainer.slabs
        if (summary["loss_rel_err"] > MD_TT_LOSS_RTOL
                or summary["table_max_abs_err"] > MD_TT_TABLE_ATOL):
            fail(f"phase 14 (c) {name} rank {rank}: {summary} against the "
                 "world of one")
        if name == "tp":
            summary["checkpoint_sec"] = trainer.checkpoint_seconds
            if len(trainer.checkpoint_seconds) != (rank == 0):
                fail(f"phase 14 (c) rank {rank} wrote "
                     f"{len(trainer.checkpoint_seconds)} checkpoints: rank 0 "
                     "alone writes one")
            t1 = time.perf_counter()
            resumed = TwoTowerTrainer(pos, TT_IDS, TT_IDS, trainer.cfg,
                                      device="cuda", state=state,
                                      mesh=trainer.mesh)
            summary["resume_sec"] = time.perf_counter() - t1
            if resumed._epochs_done != 1 or not all(
                    torch.equal(getattr(resumed, part)[side],
                                getattr(trainer, part)[side])
                    for part in ("tables", "acc") for side in SIDES):
                fail(f"phase 14 (c) rank {rank}: the resumed slabs differ "
                     "from the checkpointed ones")
            summary["on_disk"] = sorted(os.listdir(cfg["checkpoint_dir"]))
            del resumed
        out[name] = summary
        del trainer
        torch.cuda.empty_cache()
    out["twotower_sec"] = time.perf_counter() - t0
    mh.barrier("md_tt_done")
    t0 = time.perf_counter()
    events, cfg, params = sr_setup
    out["sessionrec"] = {}
    for name, axes, extra in (("seq_axis", {"seq": 2}, {"seq_axis": "seq"}),
                              ("batch_split", {"data": 2},
                               {"attn_block": 16})):
        sr_run = md_sr_epoch(events, dataclasses.replace(cfg, **extra),
                             params, create_mesh(axes))
        sr_run["loss_rel_err"] = (abs(sr_run["loss"] - sr_ref["loss"])
                                  / abs(sr_ref["loss"]))
        if sr_run["loss_rel_err"] > MD_SR_LOSS_RTOL:
            fail(f"phase 14 (d) {name} rank {rank}: {sr_run} against one "
                 f"process's {sr_ref}")
        out["sessionrec"][name] = sr_run
    out["sessionrec_sec"] = time.perf_counter() - t0
    return out


def md_worker(rank: int, port: int, work: str) -> int:
    """One rank of phase 14 (b): ``chip_smoke.py --md-worker RANK PORT
    DIR``. Joins a gloo world of 2 on ``cuda:0`` and bins its ALS layout
    from ``DIR/coo.npz`` while the parent sets up (a), writes
    ``DIR/ready<r>``, then waits for ``DIR/go``: the sharded scorer
    over phase 3's factors (every answer held to float64, ``topk_dot``'s
    launches one a call); the sharded ALS train; a two-process
    ``run_train`` of the recommendation engine over the localfs store
    that ``DIR/store_env.json`` names, and on rank 1 its deploy and one
    query. Writes ``DIR/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke worker: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from predictionio_torch.core.params import EngineParams
    from predictionio_torch.data.storage import Storage, set_storage
    from predictionio_torch.models.als import ALSParams
    from predictionio_torch.ops.als import predict_rmse
    from predictionio_torch.ops.kernels import topk_dot as tkd
    from predictionio_torch.ops.topk import ShardedTopKScorer
    from predictionio_torch.parallel import multihost as mh
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.parallel.mesh import axis_size, create_mesh
    from predictionio_torch.templates import recommendation as reco_t
    from predictionio_torch.workflow.deploy import prepare_deploy
    from predictionio_torch.workflow.train import run_train

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    # NCCL refuses two ranks on one device: the worker brings up gloo
    # itself, and initialize_from_env leaves that world as it is
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    os.environ.update({"PIO_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                       "PIO_NUM_PROCESSES": "2",
                       "PIO_PROCESS_ID": str(rank)})
    if not mh.initialize_from_env():
        raise SystemExit("chip_smoke worker: no world")
    if mh.rank_device().type != "cuda":
        raise SystemExit("chip_smoke worker: the rank is not on the card")
    mesh = create_mesh()
    if axis_size(mesh, "data") != 2:
        raise SystemExit(f"chip_smoke worker: mesh {mesh}")
    out = {"rank": rank, "device": str(mh.rank_device())}
    U, V, lone, batch = md_queries()
    truth = Truth(U, V, [], [])
    z = np.load(os.path.join(work, "coo.npz"))
    sides = md_sides((z["u"], z["i"], z["r"]), 2)
    total = len(z["u"])
    tt = (*md_tt_data(), md_tt_state())
    sr_setup = md_sr_setup((z["u"], z["i"], z["r"]))
    out["setup_sec"] = time.perf_counter() - t_start
    open(os.path.join(work, f"ready{rank}"), "w").close()
    go = os.path.join(work, "go")
    while not os.path.exists(go):
        if time.perf_counter() - t_start > MD_WORKER_TIMEOUT:
            raise SystemExit("chip_smoke worker: no go from the parent")
        time.sleep(0.05)
    t_go = time.perf_counter()

    scorer = ShardedTopKScorer(V, mesh, device=mh.rank_device())
    out["slab"] = [scorer.slab_start, scorer.slab]
    out["scorer"] = md_score_all(scorer, U, lone, batch, truth,
                                 f"sharded world 2 rank {rank}")
    mh.barrier("md_scorer")
    t_als = time.perf_counter()
    factors, ms = md_train(sides, total, mesh)
    del sides
    out["alternation_ms"] = ms
    out["rmse"] = predict_rmse(factors, (z["hu"], z["hi"], z["hr"]))
    if rank == 0:
        np.savez(os.path.join(work, "factors2.npz"),
                 X=factors.user_factors, Y=factors.item_factors)
    del z, factors

    t_train = time.perf_counter()
    env = json.load(open(os.path.join(work, "store_env.json")))
    storage = Storage.from_env(env)
    set_storage(storage)
    engine = reco_t.recommendation_engine()
    ep = EngineParams(
        data_source_params=("", reco_t.RecoDataSourceParams(
            app_name="ml100k")),
        algorithm_params_list=[("als", ALSParams(rank=16,
                                                 num_iterations=10))])
    inst = run_train(engine, ep, engine_id="ml100k-2proc", storage=storage)
    out["run_train"] = {"id": inst.id, "status": inst.status,
                        "sec": time.perf_counter() - t_train}
    if rank == 1:
        fresh = Storage.from_env(env)
        stored = fresh.engine_instances().get_latest_completed(
            "ml100k-2proc", "0", "default")
        if stored is None or stored.id != inst.id:
            raise SystemExit("chip_smoke worker: the instance is not "
                             "visible to rank 1")
        tkd.launches.reset()
        dep = prepare_deploy(engine, stored, ctx=DeviceContext("cuda"),
                             storage=fresh)
        model = dep.models[0]
        if model.sharded_axis is not None or model.device.type != "cuda":
            raise SystemExit("chip_smoke worker: deployed off the card")
        out["deploy"] = {"answer": dep.query({"user": "u7", "num": 10}),
                         "launches": tkd.launches.value}
    mh.barrier("md_deployed")
    t_tt = time.perf_counter()
    out["train"] = md_worker_train(rank, work, tt, sr_setup)
    del tt
    mh.barrier("md_done")
    now = time.perf_counter()
    out["sec"] = {"scorer": t_als - t_go, "als": t_train - t_als,
                  "run_train_and_deploy": t_tt - t_train,
                  "twotower_and_sessionrec": now - t_tt,
                  "after_go": now - t_go}
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    mh.shutdown()
    return 0


def md_world1_train(work: str, mesh, pos, perm, state, sr_setup) -> dict:
    """(c) and (d) in the world of one: the stretch two-tower trainer over
    ``mesh`` against the same run without one (losses and both whole
    tables), whose losses and touched rows ``work/tt_ref.npz`` keeps for
    the workers; the session recommender's steps in one process with
    blockwise attention, kept in ``work/sr_ref.json``."""
    import torch

    plain, plain_run = md_tt_run(pos, perm, state, None)
    meshed, meshed_run = md_tt_run(pos, perm, state, mesh)
    meshed_run["loss_rel_err"] = max(
        abs(a - b) / abs(b)
        for a, b in zip(meshed_run["losses"], plain_run["losses"]))
    meshed_run["table_max_abs_err"] = max(
        float((meshed.tables[side] - plain.tables[side]).abs().max())
        for side in plain.tables)
    if (meshed_run["loss_rel_err"] > MD_TT_LOSS_RTOL
            or meshed_run["table_max_abs_err"] > MD_TT_TABLE_ATOL):
        fail(f"phase 14 (c): the trainer over the world of one differs "
             f"from the one without a mesh: {meshed_run}")
    ref = {"losses": np.asarray(plain_run["losses"])}
    for side, ids in (("user", pos[0]), ("item", pos[1])):
        touched = np.unique(ids)
        ref[f"{side}_ids"] = touched
        ref[f"{side}_rows"] = plain.tables[side][
            torch.as_tensor(touched, device="cuda")].cpu().numpy()
    np.savez(os.path.join(work, "tt_ref.npz"), **ref)
    del plain, meshed
    torch.cuda.empty_cache()
    events, cfg, params = sr_setup
    sr_one = md_sr_epoch(events, dataclasses.replace(cfg, attn_block=16),
                         params)
    with open(os.path.join(work, "sr_ref.json"), "w") as f:
        json.dump(sr_one, f)
    return {"twotower": {"no_mesh": plain_run, "mesh": meshed_run},
            "sessionrec_attn_block16": sr_one}


def multi_device_phase(ratings) -> dict:
    """Phase 14. (b)'s two ``md_worker`` processes start first and set
    up (imports, the gloo world, their host binning) while (a), a world
    of one over NCCL in this process, sets up (its world, its host
    binning) and times ``topk_dot`` on a world-of-two slab (rank 0's:
    the first ``ceil(I / 2)`` items); (a)'s trains and queries run once
    both workers are ready,
    and the workers touch the card only after (a) has ended and this
    process writes their ``go`` file, so no timed part overlaps
    another's work."""
    import torch
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.models.als import ALSModel, als_model_from_arrays
    from predictionio_torch.ops.als import predict_rmse
    from predictionio_torch.ops.topk import ShardedTopKScorer
    from predictionio_torch.parallel import multihost as mh
    from predictionio_torch.parallel.mesh import create_mesh
    from predictionio_torch.workflow.deploy import load_blob

    t_phase = time.perf_counter()
    train, held = md_ratings(ratings)
    work = tempfile.mkdtemp(prefix="pio_chip_smoke_md_")
    procs = []
    try:
        np.savez(os.path.join(work, "coo.npz"), u=train[0], i=train[1],
                 r=train[2], hu=held[0], hi=held[1], hr=held[2])
        store = {}
        store_thread = threading.Thread(
            target=lambda: store.update(
                env=md_ml100k_store(os.path.join(work, "store")),
                tt=(*md_tt_data(), md_tt_state()), sr=md_sr_setup(train)),
            name="md-store")
        store_thread.start()
        port = free_port()
        logs = []
        for rank in range(2):
            log_path = os.path.join(work, f"worker{rank}.log")
            logs.append(log_path)
            with open(log_path, "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--md-worker", str(rank), str(port), work],
                    stdout=log, stderr=subprocess.STDOUT))

        # (a) world of one, NCCL
        os.environ.update({
            "PIO_COORDINATOR_ADDRESS": f"127.0.0.1:{free_port()}",
            "PIO_NUM_PROCESSES": "1", "PIO_PROCESS_ID": "0"})
        try:
            if not mh.initialize_from_env():
                fail("phase 14: initialize_from_env brought up no world")
            import torch.distributed as dist

            if (dist.get_backend() != "nccl"
                    or mh.rank_device().type != "cuda"):
                fail(f"phase 14: world of one on {dist.get_backend()}, "
                     f"{mh.rank_device()}")
            mesh = create_mesh()
            sides = md_sides(train, 1)
            U, V, lone, batch = md_queries()
            slab = torch.as_tensor(V[:-(-N_ITEMS // 2)], device="cuda")
            slab_timing = time_topk(
                torch.as_tensor(U[lone[0][0]], device="cuda"), slab,
                torch.full((1, 1), -1, dtype=torch.int32, device="cuda"),
                MD_K, (1, slab.shape[0], RANK, MD_K, 1))
            del slab
            t_wait = time.perf_counter()
            store_thread.join()
            while not all(os.path.exists(os.path.join(work, f"ready{r}"))
                          for r in range(2)):
                dead = [r for r, p in enumerate(procs)
                        if p.poll() is not None]
                if dead or time.perf_counter() - t_wait > MD_WORKER_TIMEOUT:
                    log = open(logs[dead[0] if dead else 0]).read()
                    fail(f"phase 14 (b): worker(s) {dead} ended or hung "
                         f"before they were ready:\n{log[-3000:]}")
                time.sleep(0.05)
            ready_wait = time.perf_counter() - t_wait
            meshed, ms1 = md_train(sides, len(train[0]), mesh)
            plain, ms0 = md_train(sides, len(train[0]), None)
            del sides
            world1 = {"alternation_ms": ms1, "no_mesh_alternation_ms": ms0,
                      "factors_vs_no_mesh": factor_diffs(
                          meshed.user_factors, meshed.item_factors, plain),
                      "rmse": predict_rmse(meshed, held),
                      "no_mesh_rmse": predict_rmse(plain, held)}
            if world1["factors_vs_no_mesh"]["rel_err"] > MD_FACTOR_TOL:
                fail(f"phase 14 (a): factors over the mesh differ from "
                     f"the train without one: {world1['factors_vs_no_mesh']}")
            del plain
            truth = Truth(U, V, [], [])
            scorer = ShardedTopKScorer(V, mesh, device="cuda")
            world1["scorer"] = md_score_all(scorer, U, lone, batch, truth,
                                            "sharded world 1")
            # the sharded scorer against phase 3's path: the same
            # model's answers through its retrieval index
            names_u = [f"u{j}" for j in range(N_USERS)]
            names_i = [f"i{j}" for j in range(N_ITEMS)]
            model = als_model_from_arrays(U, V, names_u, names_i,
                                          rank=RANK).to("cuda")
            users = [names_u[int(u)] for u, _ in lone[:16]]
            base = [model.recommend(u, 10) for u in users]
            model.enable_sharded_serving(mesh)
            if [model.recommend(u, 10) for u in users] != base:
                fail("phase 14 (a): the sharded scorer's answers differ "
                     "from the retrieval index's")
            del model, scorer
            t_tt = time.perf_counter()
            world1.update(md_world1_train(work, mesh, *store["tt"],
                                          store["sr"]))
            world1["twotower_and_sessionrec_sec"] = time.perf_counter() - t_tt
            torch.cuda.synchronize()
        finally:
            mh.shutdown()
            for key in ("PIO_COORDINATOR_ADDRESS", "PIO_NUM_PROCESSES",
                        "PIO_PROCESS_ID"):
                os.environ.pop(key, None)
        t_a = time.perf_counter() - t_phase

        # (b) world of two on the one card, over gloo
        if "env" not in store:
            fail("phase 14 (b): the ML-100K store was not made")
        env = store["env"]
        with open(os.path.join(work, "store_env.json"), "w") as f:
            json.dump(env, f)
        open(os.path.join(work, "go"), "w").close()
        t_go = time.perf_counter()
        deadline = time.monotonic() + MD_WORKER_TIMEOUT
        for rank, proc in enumerate(procs):
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                fail(f"phase 14 (b): worker {rank} still running after "
                     f"{MD_WORKER_TIMEOUT} s")
        t_b = time.perf_counter() - t_go
        for rank, proc in enumerate(procs):
            if proc.returncode != 0:
                tail = open(logs[rank]).read()[-3000:]
                fail(f"phase 14 (b): worker {rank} exited "
                     f"{proc.returncode}:\n{tail}")
        ranks = [json.load(open(os.path.join(work, f"rank{r}.json")))
                 for r in range(2)]
        got = np.load(os.path.join(work, "factors2.npz"))
        factor_err = factor_diffs(got["X"], got["Y"], meshed)
        if factor_err["rel_err"] > MD_FACTOR_TOL:
            fail(f"phase 14 (b): the sharded train's factors differ from "
                 f"(a)'s: {factor_err}")
        for r in ranks:
            if abs(r["rmse"] - world1["rmse"]) > MD_RMSE_TOL:
                fail(f"phase 14 (b): rank {r['rank']} RMSE {r['rmse']} vs "
                     f"(a)'s {world1['rmse']}")
        trains = [r["run_train"] for r in ranks]
        if trains[0]["id"] != trains[1]["id"] or {
                t["status"] for t in trains} != {"COMPLETED"}:
            fail(f"phase 14 (b): the ranks' instances differ: {trains}")
        storage = Storage.from_env(env)
        instances = storage.engine_instances().get_all()
        blob = storage.models().get(trains[0]["id"])
        if len(instances) != 1 or blob is None:
            fail(f"phase 14 (b): {len(instances)} instance rows, blob "
                 f"{blob is not None}: one writer expected")
        model = load_blob(blob.models)[0]
        if not isinstance(model, ALSModel):
            fail("phase 14 (b): the stored model is not an ALS model")
        inv_u = model.user_ids.inverse()
        inv_i = model.item_ids.inverse()
        served = Truth(model.user_factors, model.item_factors,
                       [inv_u[j] for j in range(len(inv_u))],
                       [inv_i[j] for j in range(len(inv_i))])
        deploy = ranks[1]["deploy"]
        check_answer(served, {"user": "u7", "num": 10}, deploy["answer"],
                     "phase 14 (b) rank 1's deploy")
        if deploy["launches"] < 1:
            fail("phase 14 (b): rank 1's deploy launched no topk_dot")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    tt1 = world1.pop("twotower")
    tt_launches = {kernel: {
        "world1_no_mesh": tt1["no_mesh"]["launches"][kernel],
        "world1_mesh": tt1["mesh"]["launches"][kernel],
        **{f"world2_{mode}_rank{r['rank']}": r["train"][mode]["launches"][
            kernel] for r in ranks for mode in ("dp", "tp")}}
        for kernel in ("flash_ce", "embed_update")}
    return {
        "world1": world1,
        "world2": [{k: r[k] for k in ("rank", "device", "slab", "scorer",
                                      "alternation_ms", "rmse",
                                      "run_train", "setup_sec", "sec")}
                   for r in ranks],
        "twotower": {
            "steps": MD_TT_STEPS, "batch": TT_BATCH, "ids": TT_IDS,
            "dim": TT_DIM, "loss_rtol": MD_TT_LOSS_RTOL,
            "table_atol": MD_TT_TABLE_ATOL, "world1": tt1,
            "world2": [{"rank": r["rank"], "dp": r["train"]["dp"],
                        "tp": r["train"]["tp"],
                        "sec": r["train"]["twotower_sec"]} for r in ranks],
            "launches": tt_launches},
        "sessionrec": {
            "steps": MD_SR_STEPS, "users": MD_SR_USERS,
            "loss_rtol": MD_SR_LOSS_RTOL,
            "world1_attn_block16": world1.pop("sessionrec_attn_block16"),
            "world2": [{"rank": r["rank"], **r["train"]["sessionrec"],
                        "sec": r["train"]["sessionrec_sec"]}
                       for r in ranks]},
        "world2_factors_vs_world1": factor_err,
        "world2_deploy_launches": ranks[1]["deploy"]["launches"],
        "slab_topk_dot": slab_timing,
        "launches": {"sharded_world1": world1["scorer"]["launches"],
                     "sharded_world2_rank0": ranks[0]["scorer"]["launches"],
                     "sharded_world2_rank1": ranks[1]["scorer"]["launches"]},
        "a_sec": t_a, "a_waited_for_workers_sec": ready_wait,
        "b_after_go_sec": t_b,
        "phase_sec": time.perf_counter() - t_phase,
    }


# -- phase 15: the storage tier ---------------------------------------------

#: three in-process storage servers, events sharded by entity hash with
#: successor replicas, metadata and models on the first two; the engine
#: json's ALS: phase 14's rank, alternations and direct f32 solves
TIER_SERVERS, TIER_REPLICAS = 3, 2
TIER_APP, TIER_REPAIR_APP, TIER_ENGINE = "ml20m-tier", "ml20m-repair", \
    "tier-als"
TIER_ITERS = 2
# factors against the local event log's train: the same layout, initial
# factors and f32 solves, `index_add_` atomics summing in another order
TIER_FACTOR_TOL, TIER_RMSE_TOL = 1e-4, 1e-5
TIER_LONE_USERS, TIER_LONE_ITEMS = 24, 8
# the repair app: every TIER_REPAIR_STRIDE-th training row (repair reads
# rows as JSON, ~1e4 rows/s a server on a host core: a cut of depth),
# and the rows deleted from one shard's non-owner replica
TIER_REPAIR_STRIDE, TIER_REPAIR_LOST = 960, 7
# two copies of ~4.8M events in three logs (~173 bytes an event), the
# local log, the scan spools
TIER_DISK_BYTES = 4 << 30
RECO = "predictionio_torch.templates.recommendation.recommendation_engine"


def tier_server_env(root: str) -> dict:
    """A storage server's own storage: events in an event log, metadata
    and models in sqlite."""
    env = {"PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
           "PIO_STORAGE_SOURCES_EL_PATH": os.path.join(root, "el"),
           "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
           "PIO_STORAGE_SOURCES_DB_PATH": os.path.join(root, "meta.db")}
    for repo, source in (("EVENTDATA", "EL"), ("METADATA", "DB"),
                         ("MODELDATA", "DB")):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_NAME"] = repo.lower()
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = source
    return env


def tier_client_env(ports) -> dict:
    """One ``rest`` source ``CENTRAL`` over the servers, every
    repository on it."""
    env = {"PIO_STORAGE_SOURCES_CENTRAL_TYPE": "rest",
           "PIO_STORAGE_SOURCES_CENTRAL_HOSTS": "127.0.0.1",
           "PIO_STORAGE_SOURCES_CENTRAL_PORTS": ",".join(map(str, ports)),
           "PIO_STORAGE_SOURCES_CENTRAL_REPLICAS": str(TIER_REPLICAS),
           "PIO_STORAGE_SOURCES_CENTRAL_TIMEOUT": "120"}
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_NAME"] = repo.lower()
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "CENTRAL"
    return env


def tier_columns(train):
    """The training ratings as ``EventColumns`` whose rows (and times)
    follow the user's owner shard of three, then the row's place: the
    order the tier's merged read returns them in, so the local log read
    sees the same rows, id orders and initial factors."""
    from predictionio_torch.data.storage import EventColumns, stable_hash

    u, i, r = train
    shard_of = np.fromiter((stable_hash(f"u{j}") % TIER_SERVERS
                            for j in range(N_USERS)), np.int64,
                           count=N_USERS)
    order = np.lexsort((np.arange(len(u)), shard_of[u]))
    return EventColumns(
        entity_codes=u[order].astype(np.int32),
        target_codes=i[order].astype(np.int32),
        name_codes=np.zeros(len(u), np.int32),
        values=r[order].astype(np.float64),
        times_us=1_700_000_000_000_000 + np.arange(len(u), dtype=np.int64),
        entity_vocab=[f"u{j}" for j in range(N_USERS)],
        target_vocab=[f"i{j}" for j in range(N_ITEMS)], names=["rate"])


def row_keys(cols) -> np.ndarray:
    """(user, item, rating) of every row as one sorted int64 key array:
    a multiset that two reads can be compared on."""
    users = np.array([int(s[1:]) for s in cols.entity_vocab], np.int64)
    items = np.array([int(s[1:]) for s in cols.target_vocab], np.int64)
    key = ((users[cols.entity_codes] * N_ITEMS + items[cols.target_codes])
           * 16 + np.round(cols.values * 2).astype(np.int64))
    return np.sort(key)


class TierLog(logging.Handler):
    """The records of one ``cli train``: its ALS fit and stage lines."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.fit, self.stages = None, None

    def emit(self, record):
        if record.getMessage().startswith("ALS trained on the "):
            self.fit = dict(record.args[1])
        pio = getattr(record, "pio", None)
        if isinstance(pio, dict) and "datapath_stages" in pio:
            self.stages = dict(pio["datapath_stages"])


def tier_train(env: dict, engine_json: str, engine_id: str,
               lane: str) -> dict:
    """``cli.main(["train", ...])`` in this process, on the card, with
    ``env`` as its storage; the instance id, its fit and stage seconds."""
    from predictionio_torch.data import storage as storage_mod
    from predictionio_torch.tools import cli

    handler = TierLog()
    loggers = [logging.getLogger(n) for n in (
        "predictionio_torch.models.als", "predictionio_torch.workflow.train")]
    for lg in loggers:
        lg.addHandler(handler)
    t0 = time.perf_counter()
    try:
        with cli_env(env):
            code = cli.main(["train", "--engine-json", engine_json,
                             "--engine-id", engine_id])
    finally:
        for lg in loggers:
            lg.removeHandler(handler)
    sec = time.perf_counter() - t0
    if code != 0 or handler.fit is None or handler.stages is None:
        fail(f"phase 15: cli train of {engine_id} exited {code} (fit "
             f"{handler.fit}, stages {handler.stages})")
    if handler.fit["lane"] != lane:
        fail(f"phase 15: {engine_id} trained on the {handler.fit['lane']} "
             f"lane, not the {lane} lane")
    instance = storage_mod.Storage.from_env(env).engine_instances(
    ).get_latest_completed(engine_id, "0", "default")
    if instance is None:
        fail(f"phase 15: no COMPLETED {engine_id} instance")
    return {"instance": instance.id, "sec": sec, "fit": handler.fit,
            "stages": handler.stages}


def model_rmse(model, held) -> float:
    """Held-out RMSE of an ALS model over (user, item, rating) index
    arrays; a pair the model lacks predicts 0."""
    hu, hi, hr = held
    U, V = np.asarray(model.user_factors), np.asarray(model.item_factors)
    ui = np.array([model.user_ids.get(f"u{j}", -1) for j in hu], np.int64)
    ii = np.array([model.item_ids.get(f"i{j}", -1) for j in hi], np.int64)
    ok = (ui >= 0) & (ii >= 0)
    pred = np.zeros(len(hr), np.float64)
    pred[ok] = np.einsum("nk,nk->n", U[ui[ok]].astype(np.float64),
                         V[ii[ok]].astype(np.float64))
    return float(np.sqrt(np.mean((pred - hr) ** 2)))


def model_truth(model) -> Truth:
    inv_u, inv_i = model.user_ids.inverse(), model.item_ids.inverse()
    return Truth(np.asarray(model.user_factors),
                 np.asarray(model.item_factors),
                 [inv_u[j] for j in range(len(inv_u))],
                 [inv_i[j] for j in range(len(inv_i))])


def tier_queries(truth: Truth, rng):
    """Lone user queries (every third with a blacklist of the user's
    three best items) and item queries."""
    users = rng.choice(len(truth.users), TIER_LONE_USERS, replace=False)
    names_u = list(truth.users)
    qs = []
    for n, j in enumerate(users):
        q = {"user": names_u[int(j)], "num": 10}
        if n % 3 == 0:
            best = np.argsort(-(truth.V @ truth.U[int(j)]))[:3]
            q["blacklist"] = [truth.item_names[int(b)] for b in best]
        qs.append(q)
    for j in rng.choice(len(truth.item_names), TIER_LONE_ITEMS,
                        replace=False):
        qs.append({"item": truth.item_names[int(j)], "num": 10})
    return qs


def tier_start(root: str, port: int = 0):
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.serving.storage_server import StorageServer

    backend = Storage.from_env(tier_server_env(root))
    return backend, StorageServer(storage=backend, host="127.0.0.1",
                                  port=port, bind_retries=5).start()


def tier_stop(backend, server) -> None:
    """Stop a server and release its storage: the event log's writer
    lock and the sqlite connection."""
    server.stop()
    backend.events().close()
    backend.client_for("METADATA").close()


def storage_tier_phase(ratings) -> dict:
    """Phase 15 (see the docstring): ingest, ``cli train`` and deploy
    over three storage servers, then a server down and back, then
    repair."""
    from predictionio_torch.data import storage as storage_mod
    from predictionio_torch.data.event import Event
    from predictionio_torch.data.storage import (Storage,
                                                 StorageUnavailableError,
                                                 stable_hash)
    from predictionio_torch.ops.kernels import topk_dot
    from predictionio_torch.resilience import policy
    from predictionio_torch.serving.engine_server import EngineServer
    from predictionio_torch.templates.recommendation import \
        recommendation_engine
    from predictionio_torch.tools import cli
    from predictionio_torch.workflow.deploy import load_blob

    t_phase = time.perf_counter()
    steps = {}

    def step(name: str) -> None:
        steps[name] = time.perf_counter() - t_phase - sum(steps.values())

    train, held = md_ratings(ratings)
    cols = tier_columns(train)
    n = len(cols)
    root = temp_store("pio_chip_smoke_tier_", TIER_DISK_BYTES)
    roots = [os.path.join(root, f"server{k}") for k in range(TIER_SERVERS)]
    started = [tier_start(r) for r in roots]
    backends = [b for b, _ in started]
    srvs = [s for _, s in started]
    server = None
    try:
        env = tier_client_env([s.port for s in srvs])
        urls = [f"http://127.0.0.1:{s.port}" for s in srvs]
        tier = Storage.from_env(env)
        # (a) ingest; the local log of the same rows (native, off the
        # GIL) fills meanwhile
        work = os.path.join(root, "work")
        os.makedirs(work)
        local_env = {"PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
                     "PIO_STORAGE_SOURCES_EL_PATH": os.path.join(work, "el")}

        def local_ingest():
            local = Storage.from_env(local_env)
            local_app = local.apps().insert(TIER_APP)
            local.events().init(local_app.id)
            local.events().insert_columnar(
                cols, local_app.id, entity_type="user",
                target_entity_type="item", value_property="rating")
            local.events().close()

        app = tier.apps().insert(TIER_APP)
        tier.events().init(app.id)
        with concurrent.futures.ThreadPoolExecutor(TIER_SERVERS) as pool:
            local_done = pool.submit(local_ingest)
            t0 = time.perf_counter()
            if tier.events().insert_columnar(
                    cols, app.id, entity_type="user",
                    target_entity_type="item", value_property="rating") != n:
                fail("phase 15 (a): insert_columnar counted another row "
                     "total")
            ingest_sec = time.perf_counter() - t0
            local_done.result()
            step("setup_ingest_and_local_log")
            rows = list(pool.map(
                lambda b: len(b.events().find_columnar(
                    app.id, time_ordered=False)), backends))
        if sum(rows) != TIER_REPLICAS * n or not all(
                0.55 * n <= r <= 0.78 * n for r in rows):
            fail(f"phase 15 (a): rows per server {rows} of {n} ingested")
        keep = slice(None, None, TIER_REPAIR_STRIDE)
        repair_cols = dataclasses.replace(
            cols, entity_codes=cols.entity_codes[keep],
            target_codes=cols.target_codes[keep],
            name_codes=cols.name_codes[keep], values=cols.values[keep],
            times_us=cols.times_us[keep])
        repair_app = tier.apps().insert(TIER_REPAIR_APP)
        tier.events().init(repair_app.id)
        tier.events().insert_columnar(
            repair_cols, repair_app.id, entity_type="user",
            target_entity_type="item", value_property="rating")
        step("row_counts_and_repair_app")

        # (b) train over the tier, and from the local event log
        engine_json = os.path.join(work, "engine.json")
        with open(engine_json, "w") as f:
            json.dump({"engineFactory": RECO, "datasource": {"params": {
                "app_name": TIER_APP}},
                "algorithms": [{"name": "als", "params": {
                    "rank": RANK, "num_iterations": TIER_ITERS,
                    "lambda_": ALS_REG, "block_size": ALS_BLOCK,
                    "solver": "direct", "compute_dtype": "float32",
                    "cg_dtype": "float32"}}]}, f)
        rest_train = tier_train(env, engine_json, TIER_ENGINE, "coo")
        step("rest_train")
        # the local log bins natively: the same layout bytes as the
        # tier's host binning of the same rows
        local_train = tier_train(local_env, engine_json, TIER_ENGINE,
                                 "binned")
        step("local_train")
        blob = tier.models().get(rest_train["instance"])
        for k in range(TIER_REPLICAS):
            inst = backends[k].engine_instances().get(rest_train["instance"])
            copy = backends[k].models().get(rest_train["instance"])
            if inst is None or inst.status != "COMPLETED" or copy is None \
                    or copy.models != blob.models:
                fail(f"phase 15 (b): metadata replica {k} lacks the "
                     "instance row or its blob")
        model = load_blob(blob.models)[0]
        local_model = load_blob(Storage.from_env(local_env).models().get(
            local_train["instance"]).models)[0]
        if list(model.user_ids.keys()) != list(local_model.user_ids.keys()) \
                or list(model.item_ids.keys()) != list(
                    local_model.item_ids.keys()):
            fail("phase 15 (b): the tier's read numbered ids in another "
                 "order than the local log's")
        scale = max(float(np.abs(np.asarray(t)).max()) for t in (
            local_model.user_factors, local_model.item_factors))
        diff = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                   for a, b in ((model.user_factors, local_model.user_factors),
                                (model.item_factors, local_model.item_factors)))
        rmse, local_rmse = model_rmse(model, held), model_rmse(local_model,
                                                               held)
        if diff > TIER_FACTOR_TOL * scale or abs(rmse - local_rmse) > \
                TIER_RMSE_TOL:
            fail(f"phase 15 (b): factors {diff} apart (limit "
                 f"{TIER_FACTOR_TOL * scale}), RMSE {rmse} vs {local_rmse}")

        step("train_checks")

        # (c) deploy from the tier, answer through topk_dot
        truth = model_truth(model)
        queries = tier_queries(truth, np.random.default_rng(SEED + 15))
        topk_dot.launches.reset()
        t0 = time.perf_counter()
        server = EngineServer(recommendation_engine(),
                              engine_id=TIER_ENGINE, host="127.0.0.1",
                              port=0, storage=tier, device="cuda").start()
        deploy_sec = time.perf_counter() - t0
        lat = []
        for q in queries:
            t0 = time.perf_counter()
            got = post(server.port, q)
            lat.append(1e3 * (time.perf_counter() - t0))
            check_answer(truth, q, got, "phase 15 (c)")
        launches = topk_dot.launches.value
        if launches < len(queries):
            fail(f"phase 15 (c): {launches} topk_dot launches for "
                 f"{len(queries)} lone queries")
        lat.sort()
        step("deploy_and_queries")

        # (d) one server down: server 0, the metadata tier's owner
        tier_stop(*started[0])
        read = tier.events().find_columnar(app.id, value_property="rating",
                                           time_ordered=False)
        if len(read) != n or not np.array_equal(row_keys(read),
                                                row_keys(cols)):
            fail(f"phase 15 (d): {len(read)} rows read of {n}, or another "
                 "multiset")
        del read
        step("failover_read")
        code, body = http_json(server.port, "/reload")
        if code != 200 or body.get("engineInstanceId") != \
                rest_train["instance"]:
            fail(f"phase 15 (d): GET /reload answered {code} {body}")
        for q in queries[:6] + queries[-2:]:
            check_answer(truth, q, post(server.port, q),
                         "phase 15 (d) after reload")
        status = tier.serving_status()
        for repo in ("EVENTDATA", "METADATA"):
            d = status[repo]
            if not (d["serving"] and d["degraded"]) or d["endpoints"].get(
                    urls[0]) is not False:
                fail(f"phase 15 (d): {repo} status {d}")
        writes = {}
        for shard in range(TIER_SERVERS):
            user = next(f"u{j}" for j in range(N_USERS)
                        if stable_hash(f"u{j}") % TIER_SERVERS == shard)
            needs_down = 0 in [(shard + r) % TIER_SERVERS
                               for r in range(TIER_REPLICAS)]
            event = Event(event="rate", entity_type="user", entity_id=user,
                          target_entity_type="item", target_entity_id="i0",
                          properties={"rating": 3.0})
            try:
                # into the repair app: a row write makes the event log
                # index its table's ids first (~15 s at 3.2M rows)
                tier.events().insert(event, repair_app.id)
                writes[shard] = "ok"
            except StorageUnavailableError as e:
                writes[shard] = "unavailable"
                if urls[0] not in str(e):
                    fail(f"phase 15 (d): the failed write does not name "
                         f"{urls[0]}: {e}")
            if (writes[shard] == "ok") == needs_down:
                fail(f"phase 15 (d): a write to shard {shard} "
                     f"(needs the down server: {needs_down}) was "
                     f"{writes[shard]}")
        t0 = time.perf_counter()
        started[0] = tier_start(roots[0], port=srvs[0].port)
        backends[0], srvs[0] = started[0]
        policy.reset_breakers()
        restart_sec = time.perf_counter() - t0
        step("failover_reload_status_writes_restart")

        # (e) repair: one shard's non-owner replica loses rows, the
        # metadata replica the instance row
        lost_shard = 0
        replica = backends[(lost_shard + 1) % TIER_SERVERS]
        victims = [e for e in replica.events().find(repair_app.id)
                   if stable_hash(e.entity_id) % TIER_SERVERS == lost_shard
                   ][:TIER_REPAIR_LOST]
        for e in victims:
            replica.events().delete(e.event_id, repair_app.id)
        backends[1].engine_instances().delete(rest_train["instance"])
        os.environ.update(env)
        runs = []
        try:
            for _ in range(2):
                storage_mod.set_storage(None)
                out = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    code = cli.main(["storagerepair", "--appname",
                                     TIER_REPAIR_APP])
                runs.append((code, out.getvalue().splitlines(),
                             time.perf_counter() - t0))
        finally:
            for k in env:
                os.environ.pop(k, None)
            storage_mod.set_storage(None)
        expect = [(len(victims), 1), (0, 0)]
        for (code, lines, _), (rows_copied, records) in zip(runs, expect):
            want = [f"Event replica repair for app {TIER_REPAIR_APP}: "
                    f"{rows_copied} rows copied, 0 rows deleted",
                    f"Metadata/model replica repair: {records} records "
                    "copied, 0 records deleted"]
            if code != 0 or lines != want:
                fail(f"phase 15 (e): storagerepair exited {code}: {lines}, "
                     f"expected {want}")
        if len(victims) != TIER_REPAIR_LOST:
            fail(f"phase 15 (e): {len(victims)} rows deleted")
        for k in range(TIER_SERVERS):
            owner = sorted((e.entity_id, e.target_entity_id,
                            e.properties.get_opt("rating"))
                           for e in backends[k].events().find(repair_app.id)
                           if stable_hash(e.entity_id) % TIER_SERVERS == k)
            copy = sorted((e.entity_id, e.target_entity_id,
                           e.properties.get_opt("rating"))
                          for e in backends[(k + 1) % TIER_SERVERS].events(
                          ).find(repair_app.id)
                          if stable_hash(e.entity_id) % TIER_SERVERS == k)
            if owner != copy:
                fail(f"phase 15 (e): shard {k}'s replicas differ after "
                     "repair")
        if backends[1].engine_instances().get(rest_train["instance"]) is None:
            fail("phase 15 (e): the instance row was not copied back")
        step("repair")
    finally:
        if server is not None:
            server.stop()
        for b, s in started:
            with contextlib.suppress(Exception):
                tier_stop(b, s)
        shutil.rmtree(root, ignore_errors=True)
    return {
        "servers": TIER_SERVERS, "replicas": TIER_REPLICAS,
        "ingest": {"rows": n, "sec": ingest_sec, "rows_per_server": rows,
                   "rows_per_sec": n / ingest_sec},
        "train": {"rest": rest_train, "local_eventlog": local_train,
                  "factor_max_abs_diff": diff, "factor_scale": scale,
                  "rmse": rmse, "local_rmse": local_rmse},
        "deploy": {"sec": deploy_sec, "lone_queries": len(queries),
                   "lone_ms_p50": lat[len(lat) // 2], "lone_ms_max": lat[-1],
                   "topk_dot_launches": launches},
        "failover": {"down": urls[0], "rows_read": n, "writes": writes,
                     "restart_sec": restart_sec},
        "repair": {"rows": len(repair_cols), "lost": len(victims),
                   "runs": [{"lines": lines, "sec": sec}
                            for _, lines, sec in runs]},
        "steps_sec": steps, "phase_sec": time.perf_counter() - t_phase,
    }


# -- phase 16: the operator's tools -------------------------------------------

# (a) the kernel-library cache: the smallest source, built by one fresh
# interpreter into an empty PIO_COMPILE_CACHE_DIR and loaded cached by a
# second; its check against the plain version uses phase 2's tolerance
OT_CACHE_KERNEL = "embed_update"
OT_CHILD_TIMEOUT = 600
# (b) the profiled two-tower train: phase 14 (c)'s cut (MD_TT_STEPS steps
# of the stretch width, one epoch); two runs of one process differ only
# by embed_update's float atomics, held at OT_TABLE_RTOL of the tables'
# largest magnitude; profile_call times OT_EPOCH_ITERS epochs
OT_TABLE_RTOL, OT_EPOCH_ITERS = 1e-6, 3
OT_ALS_ENGINE = "ml100k-als-prof"


def cache_child(mode: str) -> int:
    """One fresh interpreter of phase 16 (a), run by ``cache_phase``
    under its ``PIO_COMPILE_CACHE_DIR``: load ``OT_CACHE_KERNEL``'s
    library (``built`` or ``cached``), report the build counters, the
    nvcc and load seconds and the library's directory; the ``cached``
    run also holds the kernel to its plain version on the card and
    reads ``/readyz`` of an admin server in this process. Prints one
    JSON line."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.obs import torchmon
    from predictionio_torch.ops import kernels
    from predictionio_torch.ops.kernels import embed_update as eu
    from predictionio_torch.tools.admin import AdminServer

    torch.cuda.init()
    t0 = time.perf_counter()
    kernels.load_library(OT_CACHE_KERNEL)
    request_sec = time.perf_counter() - t0
    counts = {result: torchmon.KERNEL_BUILD_TOTAL.labels(
        OT_CACHE_KERNEL, result).value
        for result in ("built", "cached", "cache_unavailable")}
    out = {"mode": mode, "counts": counts, "request_sec": request_sec,
           "nvcc_sec": torchmon.KERNEL_BUILD_SECONDS.labels(
               OT_CACHE_KERNEL).sum,
           "load_sec": kernels.load_seconds()[OT_CACHE_KERNEL],
           "library_dir": kernels.library_dir(),
           "library": os.path.basename(kernels._library_path(
               OT_CACHE_KERNEL)),
           "ptxas": kernels.ptxas_report(OT_CACHE_KERNEL)}
    if mode == "cached":
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(SEED + 160)
        max_err = 0.0
        eu.launches.reset()
        for N, E, B, vocab in ((64, 24, 37, 64), (TT_IDS, TT_DIM, TT_BATCH,
                                                  TT_IDS)):
            table = torch.randn((N, E), generator=gen, device=dev)
            idx = torch.randint(0, vocab, (B,), generator=gen, device=dev)
            grad = torch.randn((B, E), generator=gen, device=dev)
            scale = torch.rand(B, generator=gen, device=dev)
            want = eu.embed_update_reference(table.clone(), idx, grad, scale)
            eu.embed_update(table, idx, grad, scale)
            torch.cuda.synchronize()
            err = (table - want).abs()
            if bool((err > 1e-6 + 1e-5 * want.abs()).any()):
                fail(f"phase 16 (a): the cached {OT_CACHE_KERNEL} differs "
                     f"at N={N}: max err {float(err.max())}")
            max_err = max(max_err, float(err.max()))
        server = AdminServer(Storage.from_env(
            {"PIO_STORAGE_SOURCES_M_TYPE": "memory"}), host="127.0.0.1",
            port=0).start()
        try:
            ready = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/readyz", timeout=60).read())
        finally:
            server.stop()
        out.update({"max_abs_err": max_err, "launches": eu.launches.value,
                    "readyz_compile_cache": ready["probes"]["compile_cache"],
                    "readyz_kernels": ready["probes"]["kernels"]})
    print(json.dumps(out), flush=True)
    return 0


def cache_phase() -> dict:
    """(a): two fresh interpreters over an empty ``PIO_COMPILE_CACHE_DIR``
    (only their environment holds it): the first builds
    ``OT_CACHE_KERNEL`` (``built`` 1, its nvcc seconds), the second finds
    it (``cached`` 1, no build: the cache's files unchanged), launches it
    against its plain version and reads ``/readyz``'s ``compile_cache``
    probe."""
    cache = tempfile.mkdtemp(prefix="pio_chip_smoke_cache_")
    env = {**os.environ, "PIO_COMPILE_CACHE_DIR": cache,
           "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    env.pop("PIO_COMPILE_CACHE", None)
    runs, listing = {}, {}
    try:
        for mode in ("built", "cached"):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--cache-child",
                 mode], env=env, capture_output=True, text=True,
                timeout=OT_CHILD_TIMEOUT)
            if proc.returncode != 0:
                fail(f"phase 16 (a): the {mode} interpreter exited "
                     f"{proc.returncode}: {proc.stderr[-2000:]}")
            runs[mode] = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[mode]["process_sec"] = time.perf_counter() - t0
            kdir = os.path.join(cache, "kernels")
            listing[mode] = sorted(
                (f, os.stat(os.path.join(kdir, f)).st_mtime_ns)
                for f in os.listdir(kdir))
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    built, cached = runs["built"], runs["cached"]
    kdir = os.path.join(cache, "kernels")
    if built["counts"] != {"built": 1, "cached": 0, "cache_unavailable": 0} \
            or not built["nvcc_sec"] > 0 or built["library_dir"] != kdir:
        fail(f"phase 16 (a): the first interpreter did not build into the "
             f"cache: {built}")
    if cached["counts"] != {"built": 0, "cached": 1, "cache_unavailable": 0} \
            or cached["nvcc_sec"] != 0 or cached["library_dir"] != kdir \
            or cached["library"] != built["library"]:
        fail(f"phase 16 (a): the second interpreter did not load the "
             f"cached library: {cached}")
    names = [f for f, _ in listing["built"]]
    if listing["cached"] != listing["built"] or names != sorted(
            [built["library"], built["library"] + ".log"]):
        fail(f"phase 16 (a): the cache changed under the second "
             f"interpreter, or holds more than the library and its log: "
             f"{listing}")
    if cached["launches"] < 2 or cached["readyz_compile_cache"][
            "status"] != "ok" or cached["readyz_kernels"]["status"] != "ok":
        fail(f"phase 16 (a): launches {cached['launches']}, /readyz "
             f"{cached['readyz_compile_cache']} {cached['readyz_kernels']}")
    return {"kernel": OT_CACHE_KERNEL, "built": built, "cached": cached,
            "cold_nvcc_sec": built["nvcc_sec"],
            "cached_load_sec": cached["load_sec"]}


class CutDataSource:
    """(b)'s data source: the prepared ratings it is handed (phase 14
    (c)'s cut over the stretch width's id maps)."""

    prepared = None


def ot_engine():
    """(b)'s engine: ``CutDataSource``'s prepared ratings into the port's
    two-tower algorithm; the trained model is kept on
    ``algorithm.trained`` (the runs save no blob: a 1M-row model pickles
    to 1 GB)."""
    from predictionio_torch.core import (DataSource, Engine, FirstServing,
                                         IdentityPreparator)
    from predictionio_torch.models.twotower import TwoTowerAlgorithm

    class Source(DataSource):
        def read_training(self, ctx):
            return CutDataSource.prepared

    class Algorithm(TwoTowerAlgorithm):
        trained = None

        def train(self, ctx, pd):
            Algorithm.trained = super().train(ctx, pd)
            return Algorithm.trained

    return Engine(Source, IdentityPreparator, {"twotower": Algorithm},
                  FirstServing), Algorithm


def profile_child(root: str) -> int:
    """``--profile-child``: (b)'s two-tower part in a fresh interpreter,
    as ``pio train`` runs (fault 13 of ROADMAP.md's list: a capture late
    in a long-lived process loses the device records of its window's
    first part): ``run_train`` of the two-tower engine on phase 14 (c)'s
    cut without, then with ``PIO_PROFILE_DIR`` under ``root``; the
    launch counters, the record, the tables and ``profile_call``'s
    epoch. Prints one JSON line."""
    import torch
    from predictionio_torch.core.params import EngineParams
    from predictionio_torch.data.bimap import BiMap
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.models.als import PreparedRatings
    from predictionio_torch.models.twotower import TwoTowerParams
    from predictionio_torch.ops.kernels import embed_update as eu
    from predictionio_torch.ops.kernels import flash_ce as fce
    from predictionio_torch.ops.twotower import (TwoTowerConfig,
                                                 TwoTowerTrainer)
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.tools import profile_window
    from predictionio_torch.tools.device_time import profile_call
    from predictionio_torch.workflow.config import WorkflowParams
    from predictionio_torch.workflow.train import run_train

    (uu, ii, _), _ = md_tt_data()
    n = len(uu)
    CutDataSource.prepared = PreparedRatings(
        user_ids=BiMap.from_vocab([f"u{j}" for j in range(TT_IDS)]),
        item_ids=BiMap.from_vocab([f"i{j}" for j in range(TT_IDS)]),
        user_idx=uu, item_idx=ii, ratings=np.ones(n, np.float32))
    cfg = dict(dim=TT_DIM, batch_size=TT_BATCH, epochs=1, learning_rate=3e-3,
               seed=11, temperature=TEMP)
    engine, algo = ot_engine()
    ep = EngineParams(data_source_params=("", None),
                      preparator_params=("", None),
                      algorithm_params_list=[("twotower",
                                              TwoTowerParams(**cfg))],
                      serving_params=("", None))
    storage = Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    prof_dir = os.path.join(root, "profiles")
    want = {"flash_ce": 3 * MD_TT_STEPS, "embed_update": 2 * MD_TT_STEPS}

    def train(name: str) -> dict:
        torch.cuda.synchronize()
        fce.launches.reset()
        eu.launches.reset()
        t0 = time.perf_counter()
        instance = run_train(engine, ep, engine_id=f"ot-{name}",
                             ctx=DeviceContext("cuda"), storage=storage,
                             workflow_params=WorkflowParams(
                                 save_model=False))
        torch.cuda.synchronize()
        run = {"instance": instance.id, "model": algo.trained,
               "sec": time.perf_counter() - t0,
               "launches": {"flash_ce": fce.launches.value,
                            "embed_update": eu.launches.value}}
        if run["launches"] != want:
            fail(f"phase 16 (b): the {name} train launched "
                 f"{run['launches']}, want {want}")
        return run

    try:
        runs = {"plain": train("plain")}
        os.environ["PIO_PROFILE_DIR"] = prof_dir
        runs["profiled"] = train("profiled")
    finally:
        os.environ.pop("PIO_PROFILE_DIR", None)
        CutDataSource.prepared = None
    out = os.path.join(prof_dir, runs["profiled"]["instance"])
    path = os.path.join(out, "breakdown.json")
    if not os.path.exists(path) or not os.path.exists(
            os.path.join(out, "trace.json")):
        fail(f"phase 16 (b): no breakdown.json and trace.json in {out}")
    with open(path) as f:
        breakdown = json.load(f)
    trace = breakdown.get("trace") or {}
    if breakdown.get("steps") != 1 or trace.get("device") != "cuda":
        fail(f"phase 16 (b): breakdown steps {breakdown.get('steps')} "
             f"(one a two-tower epoch, as JAX counts), device "
             f"{trace.get('device')}")
    named = {k: sum(v for name, v in trace["launches"].items()
                    if name.startswith(k)) for k in want}
    if named != want:
        fail(f"phase 16 (b): the capture counts {named} launches, want "
             f"{want}: {trace['launches']}")
    in_top = {k: sorted(name for name in trace["by_category"]
                        if name.startswith(k)) for k in want}
    table_err, scale = 0.0, 0.0
    for side in ("user_factors", "item_factors"):
        a = np.asarray(getattr(runs["plain"]["model"], side))
        b = np.asarray(getattr(runs["profiled"]["model"], side))
        table_err = max(table_err, float(np.abs(a - b).max()))
        scale = max(scale, float(np.abs(a).max()))
    if not table_err <= OT_TABLE_RTOL * scale:
        fail(f"phase 16 (b): the profiled tables are {table_err} from the "
             f"plain run's (scale {scale})")
    # the epoch's device time by tools/device_time.py, the same cut
    trainer = TwoTowerTrainer((uu, ii, None), TT_IDS, TT_IDS,
                              TwoTowerConfig(**{**cfg, "epochs": 10 ** 6}),
                              device="cuda")
    epoch = profile_call(lambda: trainer.run(trainer._epochs_done + 1),
                         iters=OT_EPOCH_ITERS)
    del trainer, runs
    print(json.dumps({
        "cut": {"positives": n, "steps": MD_TT_STEPS, "epochs": 1,
                "ids": TT_IDS, "dim": TT_DIM, "batch": TT_BATCH},
        "steps": breakdown["steps"],
        "device_ms_per_step": breakdown["device_ms_per_step"],
        "device_time_sec": trace["device_time_sec"],
        "device_time_ms_per_train_step": trace["device_time_sec"] * 1e3
        / MD_TT_STEPS,
        "profile_call_ms_per_epoch": epoch["ms"],
        "profile_call_windows": epoch["windows"],
        "by_category_ms_per_step": breakdown["by_category_ms_per_step"],
        "launches": named, "in_top_8": in_top,
        "table_max_abs_diff": table_err, "table_scale": scale,
        "process_age_sec": profile_window.process_age_sec()}), flush=True)
    return 0


def profile_phase(root: str) -> dict:
    """(b): the two-tower capture in a fresh interpreter
    (``profile_child``), then the ALS ``cli train`` of the ``pio
    train`` phase's ML-100K shape under ``PIO_PROFILE_DIR`` in this
    process."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--profile-child",
         root], env={**os.environ, "PYTHONPATH": os.path.dirname(
             os.path.abspath(__file__))},
        capture_output=True, text=True, timeout=OT_CHILD_TIMEOUT)
    if proc.returncode != 0:
        fail(f"phase 16 (b): the profiled two-tower interpreter exited "
             f"{proc.returncode}: {proc.stderr[-3000:]}")
    twotower = json.loads(proc.stdout.strip().splitlines()[-1])
    twotower["process_sec"] = time.perf_counter() - t0
    return {"twotower": twotower, "als": profiled_cli_train(root)}


def profiled_cli_train(root: str) -> dict:
    """(b)'s ALS: ``cli.main(["train", ...])`` in this process under
    ``PIO_PROFILE_DIR`` over an ML-100K-shaped localfs store (rank 16,
    10 iterations: the ``pio train`` phase's engine). ALS counts no
    step, so its record is the train's total (JAX's ``steps == 0``
    branch)."""
    from predictionio_torch.data import storage as storage_mod
    from predictionio_torch.tools import cli

    store = os.path.join(root, "ml100k")
    env = md_ml100k_store(store)
    engine_json = os.path.join(root, "engine-als.json")
    with open(engine_json, "w") as f:
        json.dump({"id": "default", "engineId": OT_ALS_ENGINE,
                   "engineFactory": RECO,
                   "datasource": {"params": {"app_name": "ml100k"}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": 16, "num_iterations": 10}}]}, f)
    prof_dir = os.path.join(root, "als_profiles")
    t0 = time.perf_counter()
    with cli_env({**env, "PIO_PROFILE_DIR": prof_dir}):
        code = cli.main(["train", "--engine-json", engine_json])
    sec = time.perf_counter() - t0
    instance = storage_mod.Storage.from_env(env).engine_instances(
    ).get_latest_completed(OT_ALS_ENGINE, "0", "default")
    if code != 0 or instance is None:
        fail(f"phase 16 (b): the profiled ALS cli train exited {code}")
    path = os.path.join(prof_dir, instance.id, "breakdown.json")
    if not os.path.exists(path):
        fail(f"phase 16 (b): the ALS train wrote no {path}")
    with open(path) as f:
        breakdown = json.load(f)
    if "steps" in breakdown or breakdown.get("device") != "cuda" or not (
            breakdown.get("device_time_sec", 0) > 0):
        fail(f"phase 16 (b): the ALS record is not JAX's total: "
             f"{sorted(breakdown)}")
    return {"train_sec": sec, "device_time_sec": breakdown["device_time_sec"],
            "by_category": breakdown["by_category"], "env": env,
            "instance": instance.id}


def version_check(env: dict) -> dict:
    """(c): an in-process ``EngineServer`` on the card over (b)'s ALS
    instance with ``PIO_UPDATE_URL`` at a local server: one GET with
    ``component=engine-server``, answers checked against float64 through
    ``topk_dot``, and no ``pio-upgrade-check`` thread after its stop."""
    import http.server

    from predictionio_torch.data.storage import Storage
    from predictionio_torch.ops.kernels import topk_dot as tkd
    from predictionio_torch.serving.engine_server import EngineServer
    from predictionio_torch.templates.recommendation import (
        recommendation_engine)
    from predictionio_torch.workflow.deploy import load_blob

    paths = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            paths.append(self.path)
            body = json.dumps({"version": "99.0.0"}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    updates = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    feed = threading.Thread(target=updates.serve_forever, daemon=True)
    feed.start()
    storage = Storage.from_env(env)
    instance = storage.engine_instances().get_latest_completed(
        OT_ALS_ENGINE, "0", "default")
    truth = model_truth(load_blob(storage.models().get(
        instance.id).models)[0])
    picked = tier_queries(truth, np.random.default_rng(SEED + 161))
    queries = ([q for q in picked if "user" in q][:6]
               + [q for q in picked if "item" in q][:2])
    os.environ["PIO_UPDATE_URL"] = f"http://127.0.0.1:{updates.server_port}/v"
    tkd.launches.reset()
    try:
        server = EngineServer(recommendation_engine(), OT_ALS_ENGINE,
                              host="127.0.0.1", port=0, storage=storage,
                              device="cuda").start()
    finally:
        os.environ.pop("PIO_UPDATE_URL", None)
    try:
        for j, q in enumerate(queries):
            check_answer(truth, q, post(server.port, q),
                         f"phase 16 (c) query {j}")
        wait_until(lambda: paths, 30, "the engine server's version check")
    finally:
        server.stop()
        updates.shutdown()
        updates.server_close()
        feed.join(timeout=10)
    left = [t.name for t in threading.enumerate()
            if t.name == "pio-upgrade-check" and t.is_alive()]
    if paths != ["/v?component=engine-server"] or left:
        fail(f"phase 16 (c): the update server saw {paths}; threads left "
             f"{left}")
    launched = tkd.launches.value
    if launched < len(queries):
        fail(f"phase 16 (c): {launched} topk_dot launches for "
             f"{len(queries)} queries")
    return {"requests": paths, "queries": len(queries),
            "topk_dot_launches": launched, "threads_left": left}


def operator_tools_phase() -> dict:
    """Phase 16: (a) in the background while (b) and (c) run here; then
    the lead a capture window opened in this process loses (fault 13,
    ``tools/profile_window.py``), recorded, not checked."""
    from predictionio_torch.tools import profile_window

    root = tempfile.mkdtemp(prefix="pio_chip_smoke_ot_")
    t0 = time.perf_counter()
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            cache = pool.submit(cache_phase)
            profiled = profile_phase(root)
            als = profiled.pop("als")
            version = version_check(als.pop("env"))
            cache = cache.result()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"cache": cache, "profile": {**profiled, "als": als},
            "version_check": version,
            "capture_lead": profile_window.lead_loss(),
            "phase_sec": time.perf_counter() - t0}


def operator_tools_main() -> int:
    """``python3 chip_smoke.py --operator-tools``: phase 16 alone, after
    building the kernels it launches into the package's ``_build/``."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from predictionio_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    from predictionio_torch.obs import torchmon

    built = kernels.build_all()
    nvcc_sec = {name: torchmon.KERNEL_BUILD_SECONDS.labels(name).sum
                for name in built}
    print(f"built {built} in {time.perf_counter() - t0:.1f}s ({nvcc_sec})",
          flush=True)
    tools = operator_tools_phase()
    print(json.dumps({"operator_tools": {**tools, "card": card}}),
          flush=True)
    print(card, flush=True)
    return 0


# -- phase 17: the last tools ------------------------------------------------

# (a) the pio run job's lone user queries, its passthrough's result count
# and exit code; the engine of the phase's own ML-100K ALS train when the
# pio train phase's store is gone
LT_QUERIES, LT_NUM, LT_EXIT = 8, 10, 3
LT_ALS_ENGINE = "ml100k-als-lt"
LT_TARGET = '''"""A pio run job: the newest COMPLETED instance of an ALS engine,
loaded on the card, answers lone user queries; each is a flight record
under its own trace id. argv: OUT ENGINE_ID NUM USER..."""
import json

from predictionio_torch.data.storage import get_storage
from predictionio_torch.obs import flight, trace
from predictionio_torch.workflow.deploy import load_blob


def answer(argv):
    out, engine_id, num, users = argv[0], argv[1], int(argv[2]), argv[3:]
    storage = get_storage()
    instance = storage.engine_instances().get_latest_completed(
        engine_id, "0", "default")
    (model,) = load_blob(storage.models().get(instance.id).models)
    model.to("cuda")
    answers = []
    for user in users:
        with trace.new_trace() as trace_id:
            key = flight.begin(trace_id, "pio-run", "CALL",
                               "ALSModel.recommend")
            with trace.span("recommend", user=user):
                recs = model.recommend(user, num)
            flight.finish(key, 200)
        answers.append({"user": user, "trace": trace_id, "itemScores": [
            {"item": i, "score": s} for i, s in recs]})
    with open(out, "w") as f:
        json.dump({"instance": instance.id, "argv": list(argv),
                   "device": str(model.device), "answers": answers}, f)
    return %d
''' % LT_EXIT
LT_SHELL = (
    "print(sorted(k for k in ('storage', 'store', 'ctx', 'commands') "
    "if k in globals()))\n"
    "print('device', ctx.device)\n"
    "print('apps', sorted(a.name for a in storage.apps().get_all()))\n")
LT_VIEWS = ("/flight", "/flight?slow=1", "/slo", "/resilience", "/timeline",
            "/quality", "/data", "/memory", "/trace", "/prof", "/fleet",
            "/anomaly")


def last_tools_store(root: str):
    """When the ``pio train`` phase's store is gone: an ML-100K localfs
    store, its ALS engine trained and one ``cli eval`` of the eval
    phase's sweep over it, both through ``cli.main`` in this process.
    -> (storage env, ALS engine id, seconds)."""
    from predictionio_torch.tools import cli

    t0 = time.perf_counter()
    env = md_ml100k_store(os.path.join(root, "ml100k"))
    engine_json = os.path.join(root, "engine-als.json")
    with open(engine_json, "w") as f:
        json.dump({"id": "default", "engineId": LT_ALS_ENGINE,
                   "engineFactory": RECO,
                   "datasource": {"params": {"app_name": "ml100k"}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": 16, "num_iterations": 10}}]}, f)
    with open(os.path.join(root, "pio_eval_ml100k.py"), "w") as f:
        f.write(EVAL_MODULE % (EVAL_K, EVAL_REGS))
    sys.path.insert(0, root)
    try:
        with cli_env(env):
            trained = cli.main(["train", "--engine-json", engine_json])
            evaluated = cli.main(["eval", "pio_eval_ml100k.Eval",
                                  "pio_eval_ml100k.Gen", "--batch",
                                  "chip_smoke"])
    finally:
        sys.path.remove(root)
        sys.modules.pop("pio_eval_ml100k", None)
    if (trained, evaluated) != (0, 0):
        fail(f"phase 17: the store's cli train / eval exited {trained} / "
             f"{evaluated}")
    return env, LT_ALS_ENGINE, time.perf_counter() - t0


def pio_run_check(root: str, env: dict, engine_id: str) -> dict:
    """(a): ``cli.main(["run", "pio_last_tools.answer", ...])`` in this
    process over ``env``: the job's 8 lone user answers against float64
    on the host through ``topk_dot``, its passthrough argv, exit code and
    device."""
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.ops.kernels import topk_dot as tkd
    from predictionio_torch.tools import cli
    from predictionio_torch.workflow.deploy import load_blob

    storage = Storage.from_env(env)
    instance = storage.engine_instances().get_latest_completed(
        engine_id, "0", "default")
    if instance is None:
        fail(f"phase 17 (a): no COMPLETED {engine_id} instance")
    truth = model_truth(load_blob(storage.models().get(
        instance.id).models)[0])
    rng = np.random.default_rng(SEED + 171)
    names = list(truth.users)
    users = [names[int(j)] for j in rng.choice(len(names), LT_QUERIES,
                                               replace=False)]
    with open(os.path.join(root, "pio_last_tools.py"), "w") as f:
        f.write(LT_TARGET)
    out = os.path.join(root, "answers.json")
    argv = [out, engine_id, str(LT_NUM), *users]
    sys.path.insert(0, root)
    before = tkd.launches.value
    t0 = time.perf_counter()
    try:
        with cli_env(env):
            code = cli.main(["run", "pio_last_tools.answer", *argv])
    finally:
        sys.path.remove(root)
        sys.modules.pop("pio_last_tools", None)
    run_sec = time.perf_counter() - t0
    launched = tkd.launches.value - before
    with open(out) as f:
        done = json.load(f)
    if code != LT_EXIT or done["argv"] != argv:
        fail(f"phase 17 (a): pio run exited {code} (want {LT_EXIT}) with "
             f"argv {done['argv']} (want {argv})")
    if done["instance"] != instance.id or not done["device"].startswith(
            "cuda"):
        fail(f"phase 17 (a): the job served {done['instance']} on "
             f"{done['device']}, not {instance.id} on the card")
    for j, got in enumerate(done["answers"]):
        check_answer(truth, {"user": got["user"], "num": LT_NUM}, got,
                     f"phase 17 (a) query {j}")
    if launched < LT_QUERIES:
        fail(f"phase 17 (a): {launched} topk_dot launches for "
             f"{LT_QUERIES} queries")
    return {"exit_code": code, "instance": instance.id,
            "queries": len(done["answers"]), "topk_dot_launches": launched,
            "run_sec": run_sec,
            "traces": [a["trace"] for a in done["answers"]]}


def pio_shell_check(env: dict) -> dict:
    """(b): ``cli.main(["shell"])`` in this process, its stdin a short
    script: the bound names, ``ctx``'s device (the card) and the apps
    ``storage`` lists."""
    from predictionio_torch.tools import cli

    out, err = io.StringIO(), io.StringIO()
    stdin = sys.stdin
    sys.stdin = io.StringIO(LT_SHELL)
    try:
        with cli_env(env), contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            code = cli.main(["shell"])
    finally:
        sys.stdin = stdin
    import torch

    text = out.getvalue()
    card = f"device cuda:{torch.cuda.current_device()}"
    if code != 0 or "['commands', 'ctx', 'storage', 'store']" not in text \
            or card not in text or "'ml100k'" not in text:
        fail(f"phase 17 (b): pio shell exited {code}: {text[-800:]} "
             f"{err.getvalue()[-800:]}")
    return {"exit_code": code,
            "lines": [line for line in text.replace(">>> ", "\n")
                      .splitlines() if line.strip()]}


def dashboard_check(env: dict, traces) -> dict:
    """(c): a ``DashboardServer`` on port 0 in this process over the
    store's evaluation instances: the index newest first, each
    ``evaluator_results.{txt,html,json}`` the stored instance's bytes,
    every operator view 200 with HTML, ``/flight`` listing (a)'s trace
    ids, ``/memory`` the card's memory."""
    import torch

    from predictionio_torch.data.storage import Storage
    from predictionio_torch.tools.dashboard import DashboardServer

    storage = Storage.from_env(env)
    done = storage.evaluation_instances().get_completed()
    if not done:
        fail("phase 17 (c): the store holds no completed evaluation")
    server = DashboardServer(storage=storage, host="127.0.0.1",
                             port=0).start()
    base = f"http://127.0.0.1:{server.port}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()

    t0 = time.perf_counter()
    try:
        status, _, index = get("/")
        at = [index.find(i.id.encode()) for i in done]
        if status != 200 or min(at) < 0 or at != sorted(at):
            fail(f"phase 17 (c): the index does not list "
                 f"{[i.id for i in done]} newest first")
        for instance in done:
            for fmt, field in (("txt", "evaluator_results"),
                               ("html", "evaluator_results_html"),
                               ("json", "evaluator_results_json")):
                status, _, body = get(f"/engine_instances/{instance.id}/"
                                      f"evaluator_results.{fmt}")
                if status != 200 or body != getattr(instance,
                                                    field).encode():
                    fail(f"phase 17 (c): evaluator_results.{fmt} of "
                         f"{instance.id} is not the stored one")
        views = {}
        for path in LT_VIEWS:
            status, ctype, body = get(path)
            if status != 200 or not ctype.startswith("text/html") or \
                    not body.startswith(b"<!DOCTYPE html>"):
                fail(f"phase 17 (c): {path} answered {status} {ctype}")
            views[path] = len(body)
        flight_page = get("/flight")[2].decode()
        missing = [t for t in traces if f"<td>{t[:16]}</td>" not in
                   flight_page]
        if missing:
            fail(f"phase 17 (c): /flight lacks the pio run queries' "
                 f"traces {missing}")
        memory_page = get("/memory")[2].decode()
        total = int(torch.cuda.mem_get_info(0)[1])
        if "Basis <b>memory_stats</b>" not in memory_page or \
                f"of {total:,} B" not in memory_page:
            fail(f"phase 17 (c): /memory does not show the card's "
                 f"{total:,} B: {memory_page[:600]}")
    finally:
        server.stop()
    return {"instances": [i.id for i in done], "views_bytes": views,
            "flight_traces": len(traces), "card_memory_bytes": total,
            "requests_sec": time.perf_counter() - t0}


def last_tools_phase(store_env=None, engine_id=None) -> dict:
    """Phase 17 over the ``pio train`` phase's eventlog store
    (``store_env``, its ALS engine ``engine_id``, its ``cli eval``'s
    instance), or over a store of its own when that is gone."""
    root = tempfile.mkdtemp(prefix="pio_chip_smoke_lt_")
    t0 = time.perf_counter()
    try:
        own_sec = None
        if store_env is None:
            store_env, engine_id, own_sec = last_tools_store(root)
        run = pio_run_check(root, store_env, engine_id)
        shell = pio_shell_check(store_env)
        dashboard = dashboard_check(store_env, run["traces"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"run": run, "shell": shell, "dashboard": dashboard,
            "own_store_sec": own_sec,
            "phase_sec": time.perf_counter() - t0}


def last_tools_main() -> int:
    """``python3 chip_smoke.py --last-tools``: phase 17 alone, over a
    store of its own, after building the kernel it launches."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from predictionio_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    built = kernels.build_all()
    print(f"built {built} in {time.perf_counter() - t0:.1f}s", flush=True)
    tools = last_tools_phase()
    print(json.dumps({"last_tools": {**tools, "card": card}}), flush=True)
    print(card, flush=True)
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from predictionio_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: predictionio_torch not found beside the "
              f"script: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    t_start = time.perf_counter()
    walls = {}

    def mark(phase: str) -> None:
        walls[phase] = time.perf_counter() - t_start - sum(walls.values())

    def timed_build():
        t = time.perf_counter()
        return kernels.build_all(), time.perf_counter() - t

    # phase 13's classification, regression, vanilla and e2 models launch
    # no kernel, and the ratings are host work: both run while nvcc builds
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        build = pool.submit(timed_build)
        t0 = time.perf_counter()
        families_rest = families_rest_phase()
        rest_sec = time.perf_counter() - t0
        t0 = time.perf_counter()
        ratings = synth_ratings()
        project_cut = project_ratings(ratings)
        synth_sec = time.perf_counter() - t0
        built, build_sec = build.result()
    mark("build_with_families_rest_and_ratings")
    from predictionio_torch.obs import torchmon

    # each source's own nvcc seconds (0 where its library was on disk)
    nvcc_sec = {name: torchmon.KERNEL_BUILD_SECONDS.labels(name).sum
                for name in built}
    print(f"built {built} in {build_sec:.1f}s ({nvcc_sec}; meanwhile "
          f"phase 13's (b)-(c) {rest_sec:.1f}s, the ratings "
          f"{synth_sec:.1f}s)", flush=True)
    topk = kernel_phase()
    print(f"topk_dot: {topk['cases']} shapes agree", flush=True)
    flash = flash_ce_phase()
    print(f"flash_ce: {flash['cases']} cases agree", flush=True)
    embed = embed_update_phase()
    print("embed_update: 3 cases agree", flush=True)
    obs, fleet = {}, {}

    def observe(server, truth, store_env, sent):
        mark("kernels_and_serve")
        obs.update(obs_phase(server, truth, sent))
        mark("obs")
        fleet.update(fleet_phase(server, truth, store_env))

    serve = serve_phase(after=observe)
    mark("fleet")
    topk["launches"] = serve["launches"]
    print(json.dumps({"serve": serve, "build_sec": build_sec}), flush=True)
    print(json.dumps({"fleet": {**fleet, "card": card}}), flush=True)
    train, tt_tables = train_phase()
    obs["train_mfu"] = train["train_mfu"]
    flash["launches"] = train["flash_ce_launches"]
    embed["launches"] = train["embed_update_launches"]
    print(json.dumps({"train": train}), flush=True)
    mark("train")
    als = als_train_phase(ratings)
    print(json.dumps({"als_train": {**als, "synth_sec": synth_sec}}),
          flush=True)
    mark("als_train")
    ingest, streamed = ingest_phase(ratings, als["profile"], tt_tables)
    del tt_tables
    print(json.dumps({"ingest": ingest}), flush=True)
    mark("ingest")
    front_door = front_door_phase(ratings)
    print(json.dumps({"front_door": {**front_door, "card": card}}),
          flush=True)
    mark("front_door")
    topk["launches_by_path"] = {
        "serve": serve["launches"], "train_deploy": train["topk_dot_launches"],
        "als_train_deploy": als["topk_dot_launches"],
        "ingest_deploy": ingest["topk_dot_launches"],
        "front_door_deploy": front_door["topk_dot_launches"],
        "stream": streamed["topk_dot_launches"],
        "stream_quality_probe": streamed["quality_probe"]["launches"],
        "stream_drift_reload": streamed["quality_probe"]["reload_launches"],
        "obs_profile": obs["profile"]["launches"],
        "fleet_replicas": fleet["answers"]["topk_dot_launches"]}
    # phase 17 reads the pio train phase's ALS instance and the eval
    # phase's evaluation from this store; it is removed after phase 17
    store = tempfile.mkdtemp(prefix="pio_chip_smoke_ml100k_")
    try:
        pio_train = pio_train_phase(store)
        streamed["cli"] = pio_train.pop("stream_cli")
        print(json.dumps({"pio_train": pio_train}), flush=True)
        mark("pio_train_and_stream_cli")
        print(json.dumps({"stream": {**streamed, "card": card}}),
              flush=True)
        evaluation = eval_phase(ratings, als["algorithm_rmse_heldout"],
                                store)
        print(json.dumps({"eval": {**evaluation, "card": card}}),
              flush=True)
        mark("eval")
        # phase 13's session recommender trains on phase 12's e-commerce
        # store
        ecom_root = temp_store("pio_chip_smoke_ecom_", INGEST_DISK_BYTES)
        try:
            project = project_phase(project_cut, ecom_root)
            print(json.dumps({"project": {**project, "card": card}}),
                  flush=True)
            mark("project")
            sessionrec = sessionrec_phase(ecom_root, project_cut)
        finally:
            shutil.rmtree(ecom_root, ignore_errors=True)
        mark("sessionrec")
        multi_device = multi_device_phase(ratings)
        mark("multi_device")
        storage = storage_tier_phase(ratings)
        del ratings, project_cut
        mark("storage_tier")
        tools = operator_tools_phase()
        mark("operator_tools")
        last = last_tools_phase(ml100k_eventlog(store)[0], "ml100k-als-el")
    finally:
        shutil.rmtree(store, ignore_errors=True)
    mark("last_tools")
    families = {"sessionrec": sessionrec, **families_rest,
                "phase_sec": sessionrec["phase_sec"] + rest_sec,
                "rest_overlapped_build": True}
    print(json.dumps({"families": {**families, "card": card}}), flush=True)
    similar = project["similar_product"]
    topk["launches_by_path"]["similar_product_cli_deploy"] = similar[
        "topk_dot_launches"]
    topk["launches_by_path"]["sessionrec_cli_deploy"] = sessionrec[
        "topk_dot_launches"]
    topk["similar_product_d10"] = similar["kernel_d10"]
    topk["launches_by_path"].update(multi_device["launches"])
    topk["launches_by_path"]["storage_tier_deploy"] = storage["deploy"][
        "topk_dot_launches"]
    topk["sharded_slab"] = multi_device["slab_topk_dot"]
    print(json.dumps({"multi_device": {**multi_device, "card": card}}),
          flush=True)
    for entry, key in ((flash, "flash_ce_launches"),
                       (embed, "embed_update_launches")):
        entry["launches_by_path"] = {
            "train": entry["launches"],
            "checkpoint_resume": project["checkpoint"][key],
            **{f"multi_device_{path}": n for path, n in multi_device[
                "twotower"]["launches"][entry["name"]].items()}}
    print(json.dumps({"storage": {**storage, "card": card}}), flush=True)
    flash["launches_by_path"]["profiled_train"] = tools["profile"][
        "twotower"]["launches"]["flash_ce"]
    embed["launches_by_path"]["profiled_train"] = tools["profile"][
        "twotower"]["launches"]["embed_update"]
    topk["launches_by_path"]["version_check_deploy"] = tools[
        "version_check"]["topk_dot_launches"]
    topk["launches_by_path"]["pio_run"] = last["run"]["topk_dot_launches"]
    embed["build_sec_cold"] = tools["cache"]["cold_nvcc_sec"]
    embed["load_sec_cached"] = tools["cache"]["cached_load_sec"]
    for entry in (topk, flash, embed):
        entry["build_sec"] = nvcc_sec.get(entry["name"])
        entry["load_sec"] = kernels.load_seconds().get(entry["name"])
    print(json.dumps({"operator_tools": {**tools, "card": card}}),
          flush=True)
    print(json.dumps({"last_tools": {**last, "card": card}}), flush=True)
    print(json.dumps({"obs": {**obs, "card_line": card}}), flush=True)
    print(json.dumps({"phase_wall_sec": walls,
                       "script_sec": time.perf_counter() - t_start}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [topk, flash, embed]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--md-worker"]:
        sys.exit(md_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--cache-child"]:
        sys.exit(cache_child(sys.argv[2]))
    if sys.argv[1:2] == ["--profile-child"]:
        sys.exit(profile_child(sys.argv[2]))
    if sys.argv[1:2] == ["--operator-tools"]:
        sys.exit(operator_tools_main())
    if sys.argv[1:2] == ["--last-tools"]:
        sys.exit(last_tools_main())
    if sys.argv[1:2] == ["--likealgo-repeat"]:
        sys.exit(likealgo_repeat_main(int(sys.argv[2])))
    sys.exit(main())
