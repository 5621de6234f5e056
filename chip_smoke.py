"""Drive the PyTorch/CUDA port (``metrics_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and builds every CUDA kernel from ``metrics_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once), and the earlier design of
   ``confusion_matrix`` (``csrc/confusion_atomic.cu``) to time against.
2. Holds each kernel against its plain PyTorch version on the card over the
   JAX package's parity grid plus masked and padded rows: exact equality.
   ``stat_scores`` on its plan's branch and the other shared-memory branch
   forced (one block, many blocks), on both sides of the one-block limit and
   of the shared-memory limit (C = 20,000 takes global atomics);
   ``confusion_matrix`` through the plan's launch and each branch forced (the
   band; the split on one block and on 128 blocks), up to 2,097,152 rows at C = 2,
   20, 238 and 239, on labels out of range at both ends, runs where every
   lane of a warp adds to one cell, and a start off 16 bytes;
   ``binned_stats`` on its plan's branch and, where that is the histogram
   branch, the compare branch forced, over unsorted thresholds with
   repeats, NaN, +-inf and -0.0, scores on thresholds and NaN, +-inf, -0.0
   rows, COCO's (1024, 80, 100), both sides of the histogram's threshold
   limit, and batches of 65,535 and 65,536 rows (packed and wide counters);
   the cases that ran are counted by branch, and the plan's size of the
   histogram's shared memory is held against the kernel's layout for every
   T up to 1,024. ``retrieval_sort`` also at every padded length of its
   bitonic branch and
   across the switch to the all-pairs branch at ``L_MAX``, on rows of one
   value, of NaN only and of +-0, +-inf and NaN, with the all-pairs branch
   forced at the shorter lengths; ``countmin`` also at partial warps and
   blocks, one hot cell a row, depth 1 and 8, widths 1000 and 1023, both
   branches, fractional weights (rtol 1e-6), and the shared branch twice on
   one input (the same bits).
3. Runs the slices. Slice 1: ImageNet-1k validation (50,000 images, 1,000
   classes) in batches of 1,024 (48 full, one of 848) through
   ``Accuracy(average="macro")`` and ``ConfusionMatrix(update_method="matmul")``
   and ``CohenKappa(weights="quadratic")``, ``MatthewsCorrCoef`` and
   ``JaccardIndex`` (all on ``update_method="matmul"``) with ``update``,
   ``forward``, ``compute``, ``state_dict`` and ``reset``. ``stat_scores``
   must launch once per batch (49 times), ``confusion_matrix`` 4 x 49 times
   on its band branch, and the results must equal the same run on the CPU
   (its first 8 batches and the 848-row last one, held against a card run
   over the same 9; counts exactly, values to rtol 1e-6) and an independent
   reference computed from the scores (a bincount: the whole epoch's
   confusion matrices and ``Accuracy``'s tp, fp, tn and fn exactly, every
   epoch value against the CPU's plain compute of the card's states to rtol
   1e-6, and the kappa, MCC and mean IoU in float64 numpy to rtol 1e-5). Slice 7: the same scores through one
   ``MetricCollection`` of eleven members, as a validation epoch logs them
   (``Accuracy``, ``Precision``, ``Recall``, ``F1Score``, ``FBetaScore(beta=0.5)``
   and ``Specificity``, all macro; ``HammingDistance``; ``ConfusionMatrix``,
   ``CohenKappa(weights="quadratic")``, ``MatthewsCorrCoef`` and
   ``JaccardIndex``, all matmul; ``prefix="val_"``): ``update`` on every
   batch, ``compute``, ``forward`` on the last batch, ``state_dict`` into a
   fresh collection, ``reset``. The compute groups must be the JAX package's
   three (the six stat-scores metrics, ``HammingDistance``, the four
   confusion-matrix metrics); ``stat_scores`` must launch 6 + 48 times and
   ``confusion_matrix`` 4 + 48 times over the epoch (one launch a member on
   the first update, one a group after), and one a member in ``forward``.
   The five slice-1 metrics' values (and forward values) must be bit-equal to
   slice 1's standalone metrics, the other six match float64 numpy from the
   bincount matrix (rtol 1e-5; the Hamming counts exactly and its float32
   ``1 - correct / total`` also within atol 2**-23), the first 8 batches
   grouped bit-equal to ungrouped (48 and 32 launches) and equal to the CPU run (counts exactly,
   values to rtol 1e-6). ``2PR / (P + R)`` as a ``CompositionalMetric`` must
   equal ``F1Score(average="micro")`` for micro P and R (rtol 1e-6) and
   float64 numpy for macro ones (rtol 1e-5, four launches an update: P and R
   each stand twice in the tree). The group detection must read the device
   once. Slice 2: the same
   ImageNet scores through ``BinnedAveragePrecision`` and
   ``BinnedRecallAtFixedPrecision`` (100 thresholds; 98 launches of
   ``binned_stats``), and MS-COCO 2014 val multilabel classification (40,504
   images, 80 classes, 39 batches of 1,024 and one of 568) through
   ``BinnedAveragePrecision`` with ``forward`` on the last batch (40
   launches). The ``TPs/FPs/FNs`` states must equal the CPU run and a
   searchsorted/histogram reference exactly, the values the CPU run to rtol
   1e-6; an update must make no host sync. Slice 3, retrieval: MS MARCO
   passage ranking dev (small) re-ranking (6,980 queries x 1,000 BM25
   candidates, 1 relevant passage on 93% of queries and 2 on the rest,
   scores ``N(0, 1) + 2 * relevant`` rounded to 1/256 so that ties occur) in
   updates of 64 queries (109 full and one of 4) through the eight retrieval
   metrics, one ``retrieval_sort`` launch a ``compute`` at (Q, L) =
   (6980, 1024), and the eight functional metrics over the first 200
   queries, one launch a call; TREC DL 2019 passage (43 queries x 1,000,
   graded relevance 0-3) through ``RetrievalNormalizedDCG(k=10)``. Values
   must equal the CPU run to rtol 1e-6, the sorted relevance matrix the CPU
   run exactly, and MRR, MAP and nDCG@10 of the first 200 queries a numpy
   ``argsort(kind="stable")`` reference to rtol 1e-6. Slice 3, streaming: a
   click log of 10,000,000 item ids drawn Zipf(1.1) over 1,000,000 ids, in
   batches of 65,536 (152 full and one partial), through
   ``CountMinHeavyHitters()`` (4 x 1024: the kernel's shared-memory branch),
   ``CountMinHeavyHitters(width=65536)`` (the global-atomics branch) and
   ``HyperLogLog(precision=14)``; every table row must sum to 10,000,000,
   each table must equal a numpy ``np.add.at`` reference exactly, and no
   estimate of the 100 most frequent ids may fall below its true count.
   Semantic segmentation: the Cityscapes val geometry (500 images of 1024 x
   2048, 19 classes and void, ``ignore_index=19``) through
   ``JaccardIndex(update_method="matmul")``, one image an update (500
   launches of ``confusion_matrix`` at 2,097,152 rows on its split branch);
   synthetic label maps made on the card, a class a 32 x 32 patch. The
   epoch's matrix must equal ``torch.bincount`` on the card, the first 8
   images the CPU run (mean IoU to rtol 1e-6). Slice 8, the engines: paths
   1 and 7 again with ``jit_update=True`` (``Accuracy``, ``ConfusionMatrix``)
   and ``fused_update=True`` (the collection), each an update epoch and a
   fresh metric's forward epoch, and the click log through
   ``CountMinHeavyHitters(jit_update=True)``: every update a replay of a
   captured CUDA graph (one a shape bucket: 1 for ``Accuracy`` and the
   sketch, 2 for ``ConfusionMatrix`` and the collection, which have no
   masked update). The results must equal slices 1, 7 and 3e's bit for bit,
   each path count a dispatch a batch and its kernels 49 times a member
   (6 x 49 ``stat_scores`` and 4 x 49 ``confusion_matrix`` for the
   collection, 153 ``countmin``), no engine demote, a warm update make no
   host sync, and ``scan_update`` over 8 stacked batches equal the update
   loop. An update epoch's ``compute`` value must stay as it was across a
   ``reset`` and two more updates (a replay writes the graph's buffers in
   place), and three warm updates of each path under ``torch.profiler``
   must run as many of each kernel, by name, as the registry counted for
   their replays. Each path's update is timed against its eager update in
   turns, with and without the resilience snapshot, beside the capture (a
   first call less a warm one) and the device busy share. Slice 9, sync over
   ``torch.distributed``: four spawned ranks on this card in a gloo group
   (``file://`` rendezvous; NCCL takes one rank a device), the states on the
   card, each rank a contiguous quarter of the data: 12,500 ImageNet images
   (12 batches of 1,024 and one of 212) through slice 7's collection eager
   and fused, ``Accuracy(jit_update=True)`` (update, compute, update,
   compute) and ``ConfusionMatrix(shard_state="world")`` (``pure_sync``:
   250 rows a rank, one reduce-scatter, then assembled; the same state on
   the int8 wire in one all-to-all); MS MARCO split by
   query, unevenly, rank 3 holding none, through the eight retrieval metrics
   (ragged sync, one ``retrieval_sort`` launch a compute); 2,500,000 clicks
   through ``CountMinHeavyHitters`` and ``HyperLogLog(precision=14)`` with
   ``sync_precision="int8"``. ``compute`` syncs: the collection in one bucket
   pass (one collective), and with ``METRICS_TPU_FUSED_SYNC=0`` leaf by leaf.
   Every ImageNet value must be bit-equal to slice 7's single-process epoch,
   the assembled matrix too, MS MARCO's values slice 3's to rtol 1e-6, the
   HyperLogLog registers bit-equal, each int8 count-min cell between the true
   count and the true count plus the up codec's bound (and bit-equal with
   ``METRICS_TPU_QUANT_SYNC=0``); the collectives each rank issued are
   counted and held against ``sync_stats``; no rank may degrade, fail or
   hang. The sync's host time (a ``compute`` less the same compute unsynced)
   is timed fused against per-leaf, in turns. Slice 10, curves, calibration
   and ranking: ImageNet's epoch through a ``MetricCollection`` of
   ``Accuracy(average="macro")``, ``AUROC`` macro and weighted and
   ``CalibrationError(n_bins=15)`` with the l1 (ECE) and max norms (the JAX
   package's three compute groups; the AUROC group's list states hold the
   epoch's 200 MB of scores on the card), and alone ``ROC``, ``HingeLoss``
   on the log-scores, ``KLDivergence`` and ``KLDivergence(log_prob=True)``
   against a seeded teacher distribution, ``dice_score`` over the epoch and
   ``AUROC(compute_on_cpu=True)``, whose list states must be on the CPU after
   every update and whose value must equal the card's to rtol 1e-6; MS-COCO
   2014 val through ``CoverageError``, ``LabelRankingAveragePrecision``,
   ``LabelRankingLoss`` and ``AUROC`` micro and macro; MS MARCO's 6,980,000
   candidate rows as one binary task through ``AUROC(max_fpr=0.1)`` and
   ``ROC``. ``stat_scores`` must launch 49 times (the ``Accuracy`` member)
   and no other kernel; every value must equal the same modules on the CPU
   (rtol 1e-6, the ROC curves bit for bit), the macro AUROC a float64
   Mann-Whitney reference from ``scipy.stats.rankdata``, ECE and MCE a
   float64 numpy histogram, the ranking trio numpy on COCO's first 1,024 rows
   and the partial AUC a float64 numpy McClish reference (rtol 1e-5). Each
   module's update and compute are timed and its host syncs counted. Slice 11,
   regression and pairwise, at each dataset's published size: the NYU-Depth v2
   test split (654 depth maps of 480 x 640, 0.5-10 m, predictions the target
   times log-normal noise, an image an update) through a ``MetricCollection``
   of MSE, RMSE, MAE, MSLE, MAPE (AbsRel), R2 and explained variance, eager,
   with ``fused_update=True`` and with its members on ``jit_update=True``
   (the JAX package's six compute groups: MSE and RMSE share their states;
   both engine paths bit-equal to eager), and its surface normals (307,200 x 3
   an image) through ``R2Score(num_outputs=3, multioutput="variance_weighted")``
   and ``ExplainedVariance(multioutput="raw_values")``; GLUE STS-B dev (1,500
   pairs of 768-d embeddings, gold 0-5 in steps of 0.2) through
   ``PearsonCorrCoef``, ``SpearmanCorrCoef`` (also ``compute_on_cpu=True``)
   and ``CosineSimilarity``, in updates of 32; KonIQ-10k (10,073 MOS, the
   predictions on a 1/256 grid) through PLCC and SROCC, and Pearson in four
   contiguous quarters whose states, stacked in rank order as a sync's gather
   stacks them, must merge to the single instance's value (rtol 1e-5); the M4
   competition's test horizons (100,000 series, 1,277,717 points, an update a
   frequency) through SMAPE, MAPE and WMAPE; freMTPL2 (678,013 policies, ~96%
   without a claim, ``TweedieDevianceScore(power=1)``; 26,639 claim amounts,
   ``power=2`` and ``1.5``) eager and with ``jit_update=True`` (bit-equal);
   MS MARCO dense scoring (6,980 queries of 768 floats against 65,536
   passages) through the pairwise cosine, euclidean and linear functionals
   with ``reduction=None`` and ``"mean"``, the queries against themselves
   (the diagonal zeroed), and manhattan at 1,024 x 8,192 x 768 in row blocks,
   with TF32 off throughout. No kernel of the registry may launch. The values
   must equal the CPU run (NYU-Depth on its first 64 images, the card on the
   same images; rtol 1e-6, counts and Spearman's ranks bit for bit), float64
   closed forms (rtol 1e-5; Tweedie 1e-4), ``scipy.stats.pearsonr`` and
   ``spearmanr`` (rtol 1e-5), and the first 64 rows of each dense matrix
   float64 numpy and the CPU run within float32's bound for the formula. Each
   path's update (eager, fused and engine in turns), compute and epoch are
   timed, host syncs counted, and the depth update's busy share profiled.
   Slice 12, the wrappers and the streaming windows: ImageNet's epoch through
   ``ClasswiseWrapper(Accuracy(average=None))`` (its 1,000 values the
   unwrapped vector's bits, read with no host sync), ``BootStrapper``
   (10 poisson copies of a macro ``Accuracy``, a seeded ``_rng``; its
   copies on the first 8 batches bit-equal to the CPU run), ``MinMaxMetric``,
   ``MetricTracker`` over a three-member collection in three epochs whose
   hit rate grows (the last epoch best) and a fused collection that serves its
   ``ClasswiseWrapper`` member eagerly; NYU-Depth v2's normals with 5% of
   pixels NaN (raw depth holes) through ``MultioutputWrapper(R2Score(), 3)``
   (a float64 closed form over the rows kept, rtol 1e-5; the first 16 images
   equal to the CPU run); an hour-long monitor, ``SlidingWindow(Accuracy,
   window=60)`` at slide 1 and 5 over 1,000 ticks of 1,024 rows, engine and
   eager bit-equal and equal to a fresh ``Accuracy`` over the ticks held (one
   capture, 0 host syncs a warm tick, ``stat_scores`` counted through the
   replays; the first 90 ticks equal to the CPU run), and
   ``fused_window_tick`` on an eager window (one graph launch a warm tick);
   the click log's last hour, ``SlidingWindow(CountMinHeavyHitters(4,
   65536), window=60)`` (the table a fresh sketch's and numpy's over the last
   60 batches, bit for bit) and ``FoldTreeWindow(HyperLogLog(14))`` range
   reads (registers a fresh sketch's, at most 6 merges); and a minute ->
   hour -> day ``ResolutionLadder(QuantileSketch(), (60, 60, 24))`` over
   3,660 ticks of 1,024 log-normal latencies (each level and the whole
   horizon a fresh sketch's, engine and eager bit-equal) beside
   ``TumblingWindow`` and ``ExponentialDecay`` (float64 closed form, rtol
   1e-5). Each path prints its tick or update ms (engine against eager, in
   turns), host syncs, the engine graph's nodes (read through the driver
   API from a graph kept after capture), its replay µs (CUDA events), the
   ``compute`` ms and the busy share, with the card's name and power limit.
   Slice 13, observability: slice 7's collection over ImageNet's epoch in
   three modes (eager, ``fused_update=True``, and each member on
   ``jit_update=True``), each inside one ``telemetry.instrument()`` session
   and ``profiling.track_dispatches()``, then a compute and a reset. Each
   owner's ``update`` spans (of the mode's kind) must equal its
   ``dispatch_stats``, its ``compile`` spans its builds with the causes its
   dispatcher named, the ``compute`` spans and ``reset`` instants the
   members', the ``kernel`` events of ``stat_scores`` and
   ``confusion_matrix`` their launches less the graph replays (one a build's
   warm-up, none a replay), ``telemetry.snapshot()`` the session's counts and
   the tracker the dispatches; the three epochs' values bit-equal. Then
   ``Accuracy(1000)``'s warm engine and eager updates and the fused
   collection's, each with telemetry off, idle and instrumented, in turns
   (the idle/off and instrumented/off ratios), the host syncs of a warm
   engine update inside a session (0), an injected launch fault (one
   ``degrade`` span, cause ``injected:launch``, the value bit-equal to
   eager), 60 eager ticks of slice 12's monitor (a ``window`` event a tick,
   ``read`` events a compute; the host syncs of a monitor tick, a monitor
   read and a tumbling window's tick the same with telemetry idle as off, a
   session adding only the read's live count and the tumbling tick's
   advance) and the click log through a count-min sketch (``sketch`` events
   with its geometry), and both exports of the eager epoch's session read
   back. Each overhead arm's switch is set, and its session entered,
   outside the clock. After the last kernel check that reads a profiler
   capture, one ``torch.profiler`` capture shows the
   ``metrics_tpu.Accuracy.update[aot]`` range.
   Slice 14, the serving stack (``metrics_tpu_torch.serve``): A. an ImageNet-1k
   evaluation service of 1,024 tenants (a fleet's checkpoints or experiments,
   each evaluated continuously) over ``Accuracy(num_classes=1000,
   average="macro")``, 8 flushes of one 64-row submit a tenant (the slices'
   76%-top-1 generator): each flush one stacked launch (a CUDA graph replay
   after the first) and one launch of ``stat_scores``' session axis at (1024,
   64, 1000), no request on the eager path and no degrade; the counts equal a
   host ``np.bincount`` reference, every tenant's value a dedicated ``Accuracy``
   fed the same batches on the card, bit for bit, and the first 64 tenants'
   ``state_digest`` the same stream served on the CPU; then a ragged wave (1-256
   rows a tenant in 1-3 requests, coalesced: one launch a batch bucket) and a
   forward wave of 256 ``ValueTicket``s (one launch; each value a fresh
   ``Accuracy``'s). Printed: flush ms (first, warm, the capture), session-updates
   a second, submit-to-retire p50 and p99 from ``slo_snapshot()``, the mean
   ``queue_us``/``journal_us``/``launch_us``/``retire_us`` of two instrumented
   flushes, ``compute_all`` ms, the host syncs and busy share of a warm flush.
   B. per-advertiser heavy hitters: 256 tenants of ``CountMinHeavyHitters(4,
   1024)``, submits of 4,096 Zipf ids, 2 flushes: one launch of ``countmin``'s
   session axis a flush (the second a replay), the tables bit-equal to dedicated sketches and,
   on 16 tenants, to ``numpy_countmin``. C. ``SlidingWindow(Accuracy(1000,
   macro), window=60)`` over 64 tenants, 4 ticks: coalescing off, one launch a
   tick, ``compute_window`` equal to dedicated windows. D. durability: a
   journaled service at ImageNet width (64 tenants, 16 rows an op, fsync on, a
   checkpoint every 2 flushes, 1 MiB segments) over a 100-op stream with a
   close and a reset, in subprocesses on the card (``--slice14-worker``): the
   never-killed twin and one run SIGKILLed at each of the five crash points,
   then each recovered in a fresh process, whose digest must equal the twin's;
   printed: journal append µs (a request's ``journal_us``, the copy of its
   inputs from the card included, and the frame's write and fsync alone),
   checkpoint ms, recovery ms to the first result.
   E. admission: bursts of twice ``max_queue`` (64) under ``reject`` and
   ``shed-oldest``: each refused request one cause-tagged ``degrade`` span, one
   ``request`` span per admitted submit, and ``slo_snapshot()`` agreeing.
   Slice 15, the serving fabric (``metrics_tpu_torch.fabric``): A. a
   ``ShardedMetricsService`` of 4 shards of 1,024 ImageNet tenants each
   (``Accuracy(num_classes=1000, average="macro")``), 8 flushes of one 64-row
   submit a tenant: one ``stat_scores`` session-axis launch a shard flush, the
   counts a host bincount's, each shard's digest a single ``MetricsService``'s
   fed the same stream, ``compute_all`` the single service's values (its first
   read builds and captures one fleet program), a warm fleet read exactly one
   graph replay with no ``fleet-read`` degrade, timed against the same read
   fanned out per shard, its busy share profiled; ``rollup`` the template's
   compute of numpy's summed counts. B. 4 shards of 256 advertisers'
   ``CountMinHeavyHitters(4, 1024)``, 4,096 Zipf ids a submit, 3 flushes:
   exactly one launch of ``countmin``'s session axis a shard flush (replays
   after the first), tables equal to numpy's count-min, the session axis held
   against its plain version on a flush's inputs; each shard flush timed. C.
   failover and membership on journaled fleets of 4 x 64 ImageNet tenants: a
   ``shard-death`` failover (fence, then replay; the time to the first
   recovered result; the zombie's write refused), a standby promotion that
   replays only the unshipped tail, ``add_shard`` and ``rebalance`` (about a
   fifth of the sessions move), a ``network-partition`` (the old side's
   writes refused) and a ``shard-slow`` shard quarantined by the suspicion
   sweep; every digest an uncrashed twin's. D. time travel: a 1,024-tenant
   service with ``HistoryPolicy(keep_last=4, keep_per_interval_s=1)`` and 12
   checkpoints: ``service_at`` at 6 instants equal to a twin at the same
   journal prefix, ``compute_range`` equal to a service fed the window's
   records, a ``history-corruption`` rung read past and quarantined by
   ``scrub``. E. the crash matrix of a 4-shard fleet, one process a shard on
   the card (``--slice15-worker``; a keep-last-1 ladder, a standby shipped
   every op): shard 0 SIGKILLed at each of the six crash points, then
   recovered in a fresh process, the fleet's union equal to the uncrashed
   twin fleet's.
   Slice 16, the image metrics without a net (``metrics_tpu_torch.image`` and
   ``functional.image``; no kernel of the registry runs), on images made on
   the card from seeds: smooth 1/f-like fields in [0, 1] as targets (three
   octaves of an upsampled random grid), the prediction the target plus
   gaussian noise near 30 dB, clipped. A. Kodak (24 images of 3 x 512 x 768)
   in batches of 4 through one ``MetricCollection`` of PSNR, SSIM, MS-SSIM and
   UQI: the JAX package's two compute groups (``KODAK_GROUPS``), PSNR against
   float64 over the 24, SSIM on a 96 x 96 crop and SSIM and UQI of the first
   two images against float64 numpy, the first two images against the CPU run;
   SSIM under cuDNN's default flags equal to SSIM with TF32 off, the flags as
   the caller left them. B. Cityscapes val at full resolution (500 images of
   3 x 1024 x 2048, batches of 4): ``PeakSignalNoiseRatio()`` eager and with
   ``jit_update=True`` (one captured program, bit-equal to eager, an int64
   count of 3,145,728,000 values and a finite value equal to the float64
   closed form, where the JAX package's int32 count wraps), per-image PSNR
   (``dim=(1, 2, 3)``, 500 values against float64), SSIM and MS-SSIM by
   ``forward`` (the batch value a loop logs, the state reset after it) and
   ``image_gradients``; a 256 x 256 crop against the CPU; each call's ms, host
   syncs (none allowed) and peak memory, and SSIM's window convolution alone
   against its bound. C. BraTS 2021 volumes (8 of the 219 validation cases, 4
   modalities x 155 x 240 x 240; the cut is for time) through a 3-D SSIM by
   ``forward``: each volume's ms and the convolution's against the 11^3
   window's bound, the epoch's compute against the forwards' mean, a crop
   against the CPU and float64 numpy. D. WorldView-3 (20 x 8 x 256 x 256) and
   Indian Pines (1 x 200 x 145 x 145: 20,100 band pairs), endmember spectra
   mixed by seeded abundance maps, through SAM, ERGAS (ratio 4) and
   ``SpectralDistortionIndex``: SAM and ERGAS against float64 numpy, D-lambda
   on a crop against the CPU, each compute's ms, peak memory and host syncs.
   Slice 17, the audio metrics (``metrics_tpu_torch.audio`` and
   ``functional.audio``; no kernel of the registry runs), on signals made on
   the card from seeds: sources are white noise shaped 1/f-like, under a
   syllabic envelope with two silent gaps; each estimate is its source plus
   leakage of the others and noise (SI-SDR 8 to 15 dB), handed out in a
   planted speaker order. A. WSJ0-2mix's test set (3,000 mixtures at 8 kHz, 2
   to 8 s in 0.5 s steps, batches of 8 of one length) through the functional
   PIT over SI-SDR (every planted order recovered),
   ``PermutationInvariantTraining(scale_invariant_signal_distortion_ratio)``
   eager and with ``jit_update=True`` (one captured program a shape, states
   bit-equal to eager) and ``PermutationInvariantTraining(signal_distortion_ratio,
   filter_length=512)`` (12,000 Toeplitz solves); the first two batches
   against the CPU and float64 (numpy SI-SDR, ``scipy.linalg.solve_toeplitz``);
   the SDR engine on three batches, printed as captured or demoted with its
   cause; update and compute ms and host syncs (none allowed), the batched
   512 x 512 solve against its bound. B. WSJ0-3mix (3,000 x 3 speakers) and
   WSJ0-5mix (256 x 5: scipy's Hungarian search, one host read an update):
   every planted order recovered, a batch against the CPU and float64.
   C. VoiceBank+DEMAND's test set (824 utterances at 16 kHz, 1.5 to 10 s,
   noise at 0 to 15 dB) through STOI and extended STOI (each run twice: the
   same bits), SI-SDR and SNR (two batches against the CPU and float64) and
   ``PerceptualEvaluationSpeechQuality(16000, "wb", backend="native")`` (its
   sum equal to the core called on the same host arrays; with
   ``jit_update=True`` the JAX package's warning and the eager update); each
   update and compute's ms and host syncs, STOI's resampling convolution
   against its bound, PESQ's host ms an utterance.
   Slice 18, the text metrics (``metrics_tpu_torch.text`` and
   ``functional.text``; no kernel of the registry runs: strings stay on the
   host, where the edit-distance core, ``metrics_tpu_torch/native``, built
   with ``g++`` at the start of the slice, runs the dynamic programs), on
   corpora made from seeds: Zipf (s = 1.1) vocabularies of synthetic words,
   sentence lengths at each corpus's size, hypotheses the references with
   planted edits. A. LibriSpeech test-clean (2,620 utterances, 52,576 words)
   and test-other (2,939, 52,343) in uppercase words with apostrophes, planted
   WER about 3% and 7%: a substitution is a fresh word of the replaced word's
   length and an insertion a fresh word joined by a tab, fresh meaning made
   of characters no reference holds (lowercase letters, the tab), so every
   planted edit costs one word and one character each of its characters in
   any alignment and the planted alignment no more: WER and CER must equal
   ``float32(planted) / float32(total)`` bit for bit. Batches of 32 go
   through one ``MetricCollection`` of WER, CER, MER, WIL and WIP on the
   card; the same corpus on the CPU gives the same bits; 200 pairs with
   deletions and shifts hold the core's batched Levenshtein to the Python
   DP. B. WMT14 en-de newstest2014 (3,003 segments, one reference), a NIST
   MT02-shaped set (878 segments, four references) and WMT17 en-zh
   newstest2017 (2,001 segments of Chinese from the CJK ranges SacreBLEU's
   ``zh`` tokenizer splits) in batches of 64 through ``BLEUScore`` (the two
   English and German sets), ``SacreBLEUScore`` (``13a``; ``zh`` and
   ``char`` on en-zh), ``CHRFScore`` as chrF and as chrF++ with sentence
   scores, ``TranslationEditRate`` with sentence scores (``normalize`` and
   ``asian_support`` on en-zh) and ``ExtendedEditDistance``: BLEU within
   1e-6 of a float64 BLEU written here (clipped counts, the first closest
   reference length, the brevity penalty), chrF's core bit-equal to its
   ``Counter`` path on 200 segments, EED's core within 1e-12 of the numpy
   grid on 200, TER's core equal to the Python DP's on 100, and every value
   after the first 4 batches equal to the CPU run over them. C. No registry
   kernel launches; ``jit_update=True`` warns with the JAX package's message
   and the engine refuses with its error; an update makes no host sync,
   BLEU's compute none and chrF's one. Each metric's update ms a batch
   (median), the core's share of it, compute ms and each corpus's epoch
   seconds are printed. SacreBLEU's ``intl`` tokenizer needs ``regex``
   (``tests/test_torch_text_mt.py`` holds it on the CPU); it runs on en-de
   where ``regex`` can be imported, and the slice prints whether it ran.
   Slice 19, the text metrics' second part and detection
   (``ROUGEScore``, ``SQuAD``, ``BERTScore``,
   ``detection.MeanAveragePrecision``; no kernel of the registry runs: the
   strings, the longest common subsequences and COCO's matching stay on the
   host, and BERTScore's matcher is a TF32-free batched product). A.
   CNN/DailyMail 3.0.0 test (11,490 pairs in batches of 64): reference
   highlights of 3 to 5 sentences, about 56 Zipf words, with abbreviations
   and initials for the sentence splitter, candidates keeping 3 of their
   sentences, edited. ``ROUGEScore()`` with its default keys (no stemmer):
   every tenth pair is planted (distinct words, k of them replaced by fresh
   ones), so its ROUGE-1 and ROUGE-L precision, recall and F-measure must be
   ``float32((n - k) / n)`` (and the F-measure's formula) bit for bit, every
   25th pair identical (all 1). ``BERTScore()`` over the same pairs with the
   hash embedder, without and with ``idf``, and with an embedder at
   roberta-large's width written here (a seeded 50,265 x 1,024 float32
   table on the card, [CLS] and [SEP] around the words, right padding): the
   identical pairs' F1 within 1e-6 of 1. B. SQuAD v1.1 dev (10,570
   questions, 1 to 6 gold answers, batches of 256): predictions that are a
   gold answer in other case with an article and a stop, a prefix of one
   plus fresh words, fresh words, or missing; the float32 states must be the
   planted sums added batch by batch, and the values ``100 * state / total``
   bit for bit. C. COCO val2017 (80 classes, about 7.3 boxes an image in
   xywh, 100 detections an image from a noisy detector; the first 1,500 of
   its 5,000 images, batches of 8) through
   ``MeanAveragePrecision(box_format="xywh", class_metrics=True)``: values
   finite, float32, int32 classes on the card; a perfect detector on the
   first 160 images gives ``map`` and ``mar_100`` of exactly 1.0. Each part's
   first batches (ROUGE and BERTScore 4 of 64, SQuAD 4 of 256, COCO 160
   images) run again on the CPU: states and values equal (ROUGE's means
   rtol 1e-6, BERTScore rtol and atol 1e-6). An update makes no host
   sync; ROUGE's, SQuAD's and BERTScore's compute none (with ``idf``, four
   reads of ids and masks); mAP's compute reads the card once. Update and
   compute ms and each part's seconds are printed.
   Slice 20, the nets and their metrics (``FrechetInceptionDistance``,
   ``KernelInceptionDistance``, ``InceptionScore``,
   ``LearnedPerceptualImagePatchSimilarity`` and their ``torch.nn`` nets with
   seeded weights; no kernel of the registry runs: the nets are cuDNN's
   convolutions in full float32). A. FID-10k: 10,000 "real" natural images
   and 10,000 "generated" ones (smoothed and noisy) of 299 x 299, made on the
   card from seeds and quantised to uint8, through
   ``InceptionV3FeatureExtractor`` in batches of 200 (images a second, ms a
   batch against the convolutions' bound from the layer shapes, peak
   memory); the generated set again with ``dtype=torch.bfloat16`` (its
   largest feature difference within 5% of the features' scale, its FID
   drift printed); the first 8 images on the CPU within 1e-4 of the
   features' scale. B. FID on the list and the moment path with each
   ``sqrtm_method`` against float64 on the card (1e-4 of the covariances'
   traces; Newton-Schulz 1e-2 of the square root's trace), a set against
   itself about 0, planted diagonal Gaussians (Hadamard columns: exact
   sample moments) in closed form; KID (100 subsets of 1,000; the buffer
   path its list path's bits; the in-graph draw finite) against float64
   over the same ``np.random`` subsets; IS (10 splits) on the head's
   unbiased logits against float64 after the same shuffle, streaming, and
   logits spread evenly over 10 classes giving 10; each metric through its
   own bundled net on the first 500 images a side equal to feeding the
   extracted features. C. LPIPS (alex, vgg, squeeze) over 12,000 64 x 64
   patch pairs (BAPPS 2AFC's size) in batches of 500, alex and vgg over
   slice 16's Kodak pairs, ms an update and pairs a second; identical
   pairs 0 exactly; 16 pairs on the CPU within 1e-5. D. FID's moments,
   KID's buffer, IS's streaming sums (``assignment_rng_key``) and LPIPS
   with ``jit_update=True``: each update a replay of a captured graph, the
   states the eager updates' bits, no host sync a captured update (the
   eager and captured updates' and the computes' syncs printed).
   Slice 21, the static audit held on the card, PyTorch checkpoints and the
   cold start (``run_slice21``). A. Every device case of the port's audit
   registry (``metrics_tpu_torch/analysis/registry.py``, the JAX registry's
   cases and seeded inputs) on the card, with every host sync an error
   (``torch.cuda.set_sync_debug_mode("error")``): the update captured twice
   by the engine (``dispatch.py``; list states: captured as they are), the
   forward where the audit traced one (``forward_engine.py``), compute and
   merge each captured in a CUDA graph; then each kernel-routed family
   again at its main path's width (``Accuracy``, ``ConfusionMatrix`` and
   ``BinnedAveragePrecision`` at (1,024, 1,000), ``CountMinHeavyHitters``
   at 65,536 ids into 4 x 65,536, ``RetrievalMAP`` at 64 MS MARCO queries).
   Each program the committed ``STATIC_AUDIT_TORCH.json`` calls clean must
   capture with no sync and its replay equal eager (integer states bit for
   bit, floats rtol 1e-6); each JX301 or JX401 must raise the sync debug
   mode's error, or, where the finding names a call no CUDA graph can hold,
   break the capture; any other error is a mismatch; 0 mismatches. The kernel cases launch all five kernels and both session
   axes (and the window tick as a captured graph), each output its plain
   version's on the CPU bit for bit. The capstone: the classification
   suite's static collective plan equals the collectives slice 9's ranks
   issue on it (bucketed and leaf by leaf). B. A seeded torch_fidelity-
   layout InceptionV3 state dict saved as ``.pth``, loaded with
   ``weights_path=`` and through the converter's ``.npz``: features of one
   batch of 200 299 x 299 images bit-equal; LPIPS vgg from torchvision and
   lins ``.pth`` files and from its ``.npz`` on 500 64 x 64 pairs, bit-equal.
   C. A fresh process with the built kernels on disk: the seconds from
   ``import`` to the first captured ``Accuracy`` update at (1,024, 1,000),
   against a warm update and the ``nvcc`` build.
   Slice 9's ranks compute inside a session: on each, the ``collective``
   spans and their bytes equal ``sync_stats``. Before the ``kernels`` line
   each kernel's cost-model entry (``model_bytes``, ``model_flops``) must
   give the row's bound.
4. Times each kernel, its plain version and the one PyTorch library call
   that computes the same function (``binned_stats``, ``retrieval_sort``
   and ``countmin`` have none, so a yardstick is timed and named instead)
   at the slices' shapes with CUDA events (median of 25 repetitions),
   beside the least time the card allows (bytes over its memory rate or the
   operations the work needs over its float32 rate, whichever is larger),
   and times whole updates, ``compute`` and each path's epoch (slice 7: a
   grouped and an ungrouped collection update and its three group leaders'
   own updates, timed in turns, the group detection and its host reads, a
   grouped update's host syncs and its device busy share).
   ``stat_scores`` is timed on both branches (one block, many blocks) at
   (1024, 1000), bench.py's (1024, 128) and at 2,048 to 16,384 rows around
   the one-block limit, and its session axis at slice 14's flush (1024, 64,
   1000) against a weighted ``torch.bincount`` over the S * 3C cells; ``binned_stats`` on both (histogram, compare) at
   ImageNet's and COCO's batch and at COCO's width in batches of 4,096 and
   in one update of all 40,504 rows, and on the plan's cluster size against
   the other choice (clusters of 8, or one block a tile);
   ``retrieval_sort`` is timed at both of its launch shapes, (6980, 1024)
   and a functional call's (1, 1000), on each branch; ``countmin`` at both
   widths of the click-log path; their rows carry these ``timings`` and the
   launches by shape, each counted on the main path by the wrapper, per
   branch and shape. ``confusion_matrix`` is timed at both path shapes,
   (1024, 1000) and (2097152, 20), in turns against its earlier design,
   beside the other branch and ``torch.bincount``; three calls at each must be
   three device kernels and no memset or fill under ``torch.profiler`` (a
   capture with fewer device activities than the wrapper counts launches is
   incomplete and taken again); and both
   branches are timed over C = 20 to 240 and 1,024 to 2,097,152 rows, where
   the plan switches. The command time of each part is printed before the
   ``kernels`` line.

The scores and labels are made on the card from a seeded generator: a model
whose top-1 hits the label on about 76% of images, with random scores
elsewhere. The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. There is no CPU mode: without a card the
script fails.
"""
import collections
import contextlib
import ctypes
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np

SEED = 0
N_VAL, NUM_CLASSES, BATCH = 50_000, 1000, 1024  # ILSVRC2012 validation
N_COCO, COCO_CLASSES, COCO_LABELS_PER_IMAGE = 40_504, 80, 2.9  # MS-COCO 2014 val, multilabel
THRESHOLDS = 100  # the binned metrics' default
MIN_PRECISION = 0.5
HEADLINE_CLASSES = 128  # bench.py's headline shape, B = 1024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, NVIDIA data sheet
MARCO_QUERIES, MARCO_CANDIDATES = 6980, 1000  # MS MARCO passage dev (small), BM25 top 1000
MARCO_TWO_RELEVANT = 0.07  # share of queries with 2 relevant passages (1 on the rest)
MARCO_QUERY_BATCH = 64  # queries an update: 64,000 rows
MARCO_FUNCTIONAL_QUERIES = 200
TREC_QUERIES = 43  # TREC DL 2019 passage, graded 0-3
TREC_GRADE_SHARES = (0.04, 0.04, 0.02)  # synthetic shares of grades 1, 2 and 3
CLICKS, CLICK_IDS, CLICK_ZIPF, CLICK_BATCH = 10_000_000, 1_000_000, 1.1, 65_536
HEAVY_HITTERS = 100
# Cityscapes val as a segmentation model's evaluation sees it: 500 images of 1024 x 2048, 19 evaluated classes
# and a void class (19, ignored), one image an update; synthetic label maps with a class per 32 x 32 patch
SEG_IMAGES, SEG_H, SEG_W, SEG_CLASSES, SEG_VOID = 500, 1024, 2048, 20, 19
SEG_PATCH, SEG_ZIPF, SEG_VOID_SHARE, SEG_RIGHT = 32, 1.1, 0.10, 0.94
SEG_CPU_IMAGES = 8
FBETA = 0.5
COLLECTION_CPU_BATCHES = 8
# slice 1's CPU rerun: a prefix of the epoch and its 848-row last batch (forward's tail shape), held against a
# card run over the same batches
SLICE1_CPU_BATCHES = 8
# the ImageNet binned path's CPU rerun: a prefix of the epoch, held against a card run over the same prefix
BINNED_CPU_BATCHES = 8
# slice 10's CPU rerun: the first batches of ImageNet, COCO and MS MARCO, held against card runs over the same prefixes
SLICE10_CPU_BATCHES = 8
# the compute groups the JAX package forms for slice 7's collection (tests/test_torch_collections.py holds
# the port's groups equal to them on the CPU)
COLLECTION_GROUPS = {
    0: ["Accuracy", "Precision", "Recall", "F1Score", "FBetaScore", "Specificity"],
    1: ["HammingDistance"],
    2: ["ConfusionMatrix", "CohenKappa", "MatthewsCorrCoef", "JaccardIndex"],
}
CONFMAT_SWEEP_CLASSES = (20, 64, 128, 240)
CONFMAT_SWEEP_ROWS = (1024, 4096, 16384, 65536, 262144, 2097152)
REPS, INNER = 25, 20
SLEEP_CYCLES = 20_000_000  # ~10 ms of device time: the host queues a whole repetition behind it
PROFILE_PAD_S = 0.01  # host time a profiler window holds on each side of the calls it records
# slice 9: four ranks on the one card in a gloo group (NCCL takes one rank a device), each a contiguous quarter
SYNC_RANKS = 4
SYNC_TIMEOUT_S = 300  # the group's timeout; the parent gives the whole phase SYNC_DEADLINE_S
SYNC_DEADLINE_S = 600
SYNC_TURNS = 7  # repetitions of the sync timings, each in turns (a, b, c, c, b, a)
MARCO_SPLIT = (0, 3000, 3500, 6980, 6980)  # MS MARCO queries by rank: uneven, and rank 3 holds none
SYNC_COLLECTIVES = ("all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor", "all_to_all_single")
# slice 10: the compute groups the JAX package forms for the curve collection (tests/test_torch_curves.py holds
# the port's groups equal to them on the CPU), ECE's bins, the teacher's noise, MS MARCO's partial AUC
CURVE_GROUPS = {0: ["acc"], 1: ["auroc", "auroc_weighted"], 2: ["ece", "mce"]}
ECE_BINS = 15
TEACHER_NOISE = 0.5
MARCO_MAX_FPR = 0.1
RANKING_REF_ROWS = 1024
SYNC_SITES_SAMPLED = 200  # the syncs of a compute whose line in the port is looked up

# slice 11: regression and pairwise at the datasets' published sizes
NYU_IMAGES, NYU_H, NYU_W = 654, 480, 640  # NYU-Depth v2 test split, an image an update
NYU_DEPTH_M, NYU_LOG_NOISE, NYU_NORMAL_NOISE = (0.5, 10.0), 0.1, 0.2  # depth in metres; prediction noise
NYU_CPU_IMAGES = 64  # the CPU rerun's contiguous run of images (the card runs all 654)
STSB_PAIRS, STSB_BATCH, STSB_LEVELS, STSB_NOISE = 1500, 32, 26, 0.15  # GLUE STS-B dev: gold 0-5 in steps of 0.2
EMBED_DIM = 768
KONIQ_IMAGES, KONIQ_BATCH, KONIQ_NOISE, KONIQ_QUARTERS = 10_073, 1024, 0.35, 4  # KonIQ-10k, MOS 1-5
M4_HORIZONS = {"yearly": (23_000, 6), "quarterly": (24_000, 8), "monthly": (48_000, 18), "weekly": (359, 13),
               "daily": (4_227, 14), "hourly": (414, 48)}  # M4 competition: series, test horizon
M4_POINTS, M4_NOISE = 1_277_717, 0.12
FREMTPL_POLICIES, FREMTPL_CLAIMS, FREMTPL_BATCH, FREMTPL_RATE = 678_013, 26_639, 65_536, 0.07  # freMTPL2
DENSE_QUERIES, DENSE_PASSAGES, DENSE_REF_ROWS = 6980, 65_536, 64  # MS MARCO dev queries against a passage shard
MANHATTAN_SHAPE = (1024, 8192, 768)
PAIRWISE = {"cosine": "pairwise_cosine_similarity", "euclidean": "pairwise_euclidean_distance",
            "linear": "pairwise_linear_similarity", "manhattan": "pairwise_manhattan_distance"}
# the compute groups the JAX package forms for the depth collection (tests/test_torch_collections.py holds the
# port's groups equal to them on the CPU)
DEPTH_GROUPS = {0: ["abs_rel"], 1: ["explained_variance"], 2: ["mae"], 3: ["mse", "rmse"], 4: ["msle"], 5: ["r2"]}

# slice 12: the wrappers and the streaming windows
BOOTSTRAPS, BOOT_QUANTILES, BOOT_CPU_BATCHES = 10, (0.025, 0.975), 8
TRACKER_HITS = (0.55, 0.66, 0.76)  # three epochs' top-1 hit rates: the teacher's noise shrinks
NYU_HOLE_SHARE, NYU12_CPU_IMAGES = 0.05, 16  # pixels raw depth leaves without a normal; the CPU rerun's images
MONITOR_WINDOW, MONITOR_TICKS, MONITOR_SLIDES, MONITOR_CPU_TICKS = 60, 1000, (1, 5), 90  # a tick a minute
FUSED_TICKS = 200
# slice 13: the monitor's eager ticks and reads, and the click-log batches through one count-min sketch
SLICE13_TICKS, SLICE13_READ_EVERY, SLICE13_SKETCH_BATCHES = 60, 10, 8
CLICK_WINDOW, CLICK_DEPTH, CLICK_WIDTH = 60, 4, 65536  # the last 60 batches of the click log
HLL_PRECISION, HLL_RANGES = 14, ((0, 60), (7, 38), (45, 60), (59, 60))
LADDER_LEVELS, LADDER_TICKS, LADDER_BATCH = (60, 60, 24), 3660, 1024  # minute -> hour -> day, a tick a second
LATENCY_LOG_MU, LATENCY_LOG_SIGMA, DECAY_HALFLIFE = math.log(20.0), 0.6, 60.0  # request latencies in ms

# slice 14: the serving stack. A: an ImageNet-1k evaluation service of 1,024 tenants (a fleet's checkpoints or
# experiments), 8 flushes of one 64-row submit a tenant, the first 64 tenants rerun on the CPU, then a ragged
# wave and a forward wave; B: per-advertiser count-min sketches; C: a windowed service; D: the crash matrix of a
# journaled service at ImageNet width; E: admission bursts of twice the queue bound
SLICE14_TENANTS, SLICE14_ROWS, SLICE14_FLUSHES, SLICE14_PREFIX, SLICE14_FORWARD = 1024, 64, 8, 64, 256
SLICE14_CM_TENANTS, SLICE14_CM_IDS, SLICE14_CM_NUMPY = 256, 4096, 16
SLICE14_WINDOW_TENANTS, SLICE14_WINDOW_TICKS = 64, 4
SLICE14_DURABLE_TENANTS, SLICE14_DURABLE_OPS, SLICE14_DURABLE_ROWS = 64, 100, 16
SLICE14_CRASH_NTH = {"post-journal": 30, "mid-journal-append": 30, "mid-flush": 5, "mid-checkpoint": 2,
                     "mid-truncate": 2}
SLICE14_WORKER_TIMEOUT_S = 300
SLICE14_MAX_QUEUE = 64
# slice 15: the fabric. A: 4 shards of 1,024 ImageNet tenants, 8 flushes of a 64-row submit a tenant; B: 4 shards of
# 256 advertisers' count-min sketches, 4,096 ids a submit; C: failover and membership on 4 x 64 journaled tenants; D:
# a 1,024-tenant service with a ladder, 12 checkpoints (every tenant in the first round, 128 a round after); E: the
# crash matrix of a 4-shard fleet, one process a shard
SLICE15_SHARDS, SLICE15_TENANTS, SLICE15_ROWS, SLICE15_FLUSHES = 4, 1024, 64, 8
SLICE15_VALUE_SAMPLE = 256  # tenants whose fleet-read value is held against the single service's compute
SLICE15_CM_TENANTS, SLICE15_CM_IDS, SLICE15_CM_FLUSHES, SLICE15_CM_NUMPY = 256, 4096, 3, 16
# the slow shard's sleep: its p99 must pass 4x its peers' on a host twice as slow as the ones measured (PERF.md §5).
# 1,030 requests a shard put a fast shard's p99 at about its 10th longest, so a few host pauses cannot set it; the
# slow shard's 30 slow requests are 2.9% of its 1,030
SLICE15_C_TENANTS, SLICE15_C_ROWS, SLICE15_SLOW_MS, SLICE15_SLOW_WARM, SLICE15_SLOW_OPS = 64, 16, 200, 1000, 30
SLICE15_TT_TENANTS, SLICE15_TT_ROUNDS, SLICE15_TT_ROUND_TENANTS, SLICE15_TT_ROWS = 1024, 12, 128, 8
SLICE15_TT_INTERVAL_S, SLICE15_TT_INSTANTS = 1.0, 6
SLICE15_CHAOS_OPS, SLICE15_CHAOS_SESSIONS, SLICE15_CHAOS_ROWS = 64, 16, 16
SLICE15_CRASH_NTH = {"post-journal": 6, "mid-journal-append": 6, "mid-flush": 2, "mid-checkpoint": 1,
                     "mid-truncate": 2, "mid-history-gc": 1}
# slice 16: the image metrics without a net. A: Kodak (24 images of 3 x 512 x 768) in batches of 4 through one codec
# evaluation collection; B: Cityscapes val at full resolution (500 images of 3 x 1024 x 2048, batches of 4); C: BraTS
# 2021 validation volumes (four modalities x 155 x 240 x 240; 8 of the 219 cases, cut for time); D: WorldView-3
# pan-sharpening as PanCollection's reduced-resolution test ships it (20 x 8 x 256 x 256) and Indian Pines (the 200
# corrected AVIRIS bands of 145 x 145)
KODAK_IMAGES, KODAK_SHAPE, IMAGE_BATCH, KODAK_CPU_IMAGES = 24, (3, 512, 768), 4, 2
CITY_IMAGES, CITY_SHAPE, CITY_CPU_CROP = 500, (3, 1024, 2048), 256
BRATS_VOLUMES, BRATS_SHAPE, BRATS_CPU_CROP = 8, (4, 155, 240, 240), (32, 48, 48)
WV3_SHAPE, PINES_SHAPE, SPECTRAL_ENDMEMBERS = (20, 8, 256, 256), (1, 200, 145, 145), 5
SPECTRAL_CPU_CROP, PINES_CPU_BANDS = 64, 16
IMAGE_OCTAVES = ((64, 1.0), (16, 0.5), (4, 0.25))  # (grid cell in pixels, amplitude): a 1/f-like natural image
IMAGE_NOISE = 0.0316  # the prediction's noise: about 30 dB PSNR on a [0, 1] range
# the compute groups the JAX package forms for the Kodak collection (tests/test_torch_image_paths.py holds the port's
# groups equal to them on the CPU)
KODAK_GROUPS = {0: ["ms_ssim", "ssim", "uqi"], 1: ["psnr"]}
# the tolerances: PSNR and ERGAS rtol 1e-5 and SAM atol 1e-3 (arccos near 0), as tests/test_torch_image.py holds the
# port to the JAX package. The windowed values (SSIM, MS-SSIM, UQI) of these smooth full-size images: each float32 run
# lands within 1.4e-5 of float64 numpy, the card's below and the CPU's above (the two convolutions round their 121-tap
# sums differently; measured on an H100), so each is held to float64 at 2e-5 and the card to the CPU at 5e-5. A 3-D
# SSIM's 1,331-tap sums: to float64 at
# 1e-4 (the JAX package's own 3-D oracle tolerance, tests/image/test_image_params.py), two float32 runs at 2e-4
RTOL16, SAM_ATOL16 = 1e-5, 1e-3
F64_ATOL16, CARD_CPU_ATOL16 = 2e-5, 5e-5
# D-lambda, a mean of |UQI differences| between bands whose windows hold little variance: against the float64 run of
# the same formula at 2e-4 a device (9e-5 seen on the CPU), the card against the CPU at twice that
SPECTRAL_F64_ATOL16 = 2e-4
VOLUME_F64_ATOL16, VOLUME_CARD_CPU_ATOL16 = 1e-4, 2e-4
# slice 17: WSJ0-2mix/3mix test sets (3,000 mixtures at 8 kHz, 2 to 8 s in 0.5 s steps), WSJ0-5mix (256 of them),
# VoiceBank+DEMAND's test set (824 utterances at 16 kHz, 1.5 to 10 s); mixtures of one length go in batches of 8
WSJ_MIXTURES, WSJ5_MIXTURES, WSJ_FS, WSJ_BATCH = 3000, 256, 8000, 8
WSJ_LENGTHS_S = tuple(2.0 + 0.5 * i for i in range(13))
WSJ_SDR_EVERY = 1  # PIT over SDR on every 2-mix batch: 12,000 Toeplitz solves
WSJ_CPU_BATCHES, SDR_TAPS, SDR_ENGINE_BATCHES = 2, 512, 3
VB_UTTERANCES, VB_FS, VB_BATCH, VB_CPU_BATCHES = 824, 16000, 8, 2
VB_LENGTHS_S = tuple(1.5 + 0.5 * i for i in range(18))
VB_PESQ_UTTERANCES = 824
VB_SNR_DB = (0.0, 15.0)  # the test set's noise levels
# the sources: white noise shaped 1/f-like above 200 Hz, a syllabic envelope, two silent gaps of 0.3 s
SPEECH_CORNER_HZ, SYLLABLE_HZ, SPEECH_GAPS, SPEECH_GAP_S = 200.0, 4.0, 2, 0.3
# a separation system's estimates: 0.1 of the other sources leaked in, noise of a seeded level, SI-SDR 8 to 15 dB
SEP_LEAK, SEP_NOISE, SEP_SI_SDR_DB = 0.1, (0.17, 0.38), (8.0, 15.0)
# the tolerances, as tests/test_torch_audio.py holds the port to the JAX package: SNR and SI-SDR within 1e-4 dB of
# float64, STOI 1e-5 between devices; SDR's float32 solve 2e-5 * (1 + 10 ** (SDR / 10)) dB of float64
DB_ATOL17, STOI_ATOL17, SDR_TOL_DB = 1e-4, 1e-5, 2e-5
# slice 18: LibriSpeech test-clean and test-other (utterances, words, planted WER), batches of 32; WMT14 en-de
# newstest2014, a NIST MT02-shaped set and WMT17 en-zh newstest2017 (segments, references, mean length in words, or in
# characters for Chinese), batches of 64; the first MT_CPU_BATCHES batches again on the CPU
LIBRI_SETS = (("test-clean", 2620, 52576, 0.03), ("test-other", 2939, 52343, 0.07))
MT_SETS = (("wmt14-en-de", 3003, 1, 22.0), ("nist-mt02", 878, 4, 30.0), ("wmt17-en-zh", 2001, 1, 45.0))
ASR_BATCH, MT_BATCH, MT_CPU_BATCHES, TEXT_ZIPF = 32, 64, 4, 1.1
TEXT_VOCAB, CJK_INVENTORY = 20_000, 4_000
# the segments the core is held against its plain versions on
CORE_CHECKS = {"levenshtein": 200, "chrf": 200, "eed": 200, "ter": 100}
BLEU_F64_ATOL = 1e-6
TEXT_CARD_CPU_RTOL = 1e-6  # BLEU's and EED's device arithmetic (log, exp, a mean); every count is exact
# slice 19: CNN/DailyMail 3.0.0 test (articles; reference highlights of about 4 sentences and 56 words, candidate
# summaries of about 3 sentences) in batches of 64 through ROUGE and BERTScore, a share of the pairs planted: distinct
# words with k replaced by fresh ones (exact ROUGE-1 and ROUGE-L), or identical (BERTScore F1 of 1); SQuAD v1.1 dev
# (questions, 1 to 6 gold answers) in batches of 256; COCO val2017 (images of 640 x 480, 80 classes, about 7.3 boxes
# an image, 100 detections an image) in batches of 8, the first COCO_MAP_IMAGES of them (the compute is host numpy,
# about 14 ms an image); the first batches or images of each again on the CPU
CNNDM_ARTICLES, CNNDM_REF_SENTS, CNNDM_REF_WORDS, CNNDM_CAND_SENTS, SUMM_BATCH = 11_490, 4, 56, 3, 64
CNNDM_PLANTED_EVERY, CNNDM_IDENTICAL_EVERY, SUMM_CPU_BATCHES = 10, 25, 4
ROBERTA_VOCAB, ROBERTA_WIDTH, ROBERTA_MAX_TOKENS = 50_265, 1024, 512  # roberta-large's embedding table
SQUAD_QUESTIONS, SQUAD_BATCH, SQUAD_CPU_BATCHES = 10_570, 256, 4
COCO_VAL_IMAGES, COCO_VAL_CLASSES, COCO_GT_PER_IMAGE, COCO_DETS, COCO_SIZE = 5000, 80, 7.3, 100, (640, 480)
COCO_BATCH, COCO_MAP_IMAGES, COCO_CPU_IMAGES, COCO_PERFECT_IMAGES = 8, 1500, 160, 160
BERT_CARD_CPU_RTOL, BERT_CARD_CPU_ATOL = 1e-6, 1e-6  # a float32 product summed in another order on each device
# slice 20: FID-10k (10,000 real and 10,000 generated 299 x 299 images, batches of 200) through the bundled
# InceptionV3 (seeded weights), FID, KID (100 subsets of 1,000) and IS (10 splits) on its features and logits, each
# metric through its own net on the first 500 images a side; LPIPS on 12,000 BAPPS 2AFC-shaped 64 x 64 patch pairs
# (batches of 500) and on slice 16's 24 Kodak pairs; the engines on the first ENGINE_BATCHES20 batches
FID_IMAGES, FID_BATCH, FID_SHAPE, FID_CPU_IMAGES, FID_GEN_NOISE = 10_000, 200, (3, 299, 299), 8, 0.02
NET_METRIC_IMAGES, KID_SUBSETS, KID_SUBSET_SIZE, IS_SPLITS, BUNDLED_KID_SUBSET = 500, 100, 1000, 10, 200
BAPPS_PAIRS, BAPPS_BATCH, BAPPS_SHAPE, ENGINE_BATCHES20 = 12_000, 500, (3, 64, 64), 6
# the tolerances: FID on every square root within 1e-4 of tr S1 + tr S2 of float64 (tests/test_torch_image_fid.py's
# eigh tolerance; the compute runs in float64); the card's float32 features within 1e-4 of the CPU's scale, bf16
# within 5e-2; KID within 1e-5 of the kernel's scale; IS rtol 1e-5 of float64, and IS's streaming sums on the card
# within 1e-5 of their scale of the CPU's (tests/test_torch_image_kid_is.py's atol against the JAX package)
FID_TOL20, NET_CARD_CPU_RTOL20, BF16_BOUND20 = 1e-4, 1e-4, 5e-2
KID_ATOL20, IS_RTOL20, IS_STATE_ATOL20, LPIPS_CARD_CPU_ATOL20 = 1e-5, 1e-5, 1e-5, 1e-5
# slice 21: the audit's replays against eager (floats), the checkpoints' batches, the cold start's update shape
AUDIT_RTOL21, AUDIT_ATOL21 = 1e-6, 1e-12
CKPT_IMAGES21, CKPT_PAIRS21, CKPT_LPIPS_HW21, COLD_SHAPE21, COLD_WARM_REPS21 = 200, 500, 64, (1024, 1000), 50

KERNELS = {
    "stat_scores": ("metrics_tpu_torch/csrc/stat_scores.cu", "metrics_tpu/ops/stat_scores.py:39"),
    "confusion_matrix": ("metrics_tpu_torch/csrc/confusion.cu", "metrics_tpu/ops/confusion.py:37"),
    "binned_stats": ("metrics_tpu_torch/csrc/binned_stats.cu", "metrics_tpu/ops/binned_stats.py:43"),
    "retrieval_sort": ("metrics_tpu_torch/csrc/retrieval_sort.cu", "metrics_tpu/ops/retrieval.py:43"),
    "countmin": ("metrics_tpu_torch/csrc/countmin.cu", "metrics_tpu/ops/sketch_ops.py:48"),
}
# the retrieval metrics of the MS MARCO path: (module, constructor arguments, functional, its arguments)
RETRIEVAL = {
    "map": ("RetrievalMAP", {}, "retrieval_average_precision", {}),
    "mrr": ("RetrievalMRR", {}, "retrieval_reciprocal_rank", {}),
    "ndcg@10": ("RetrievalNormalizedDCG", {"k": 10}, "retrieval_normalized_dcg", {"k": 10}),
    "precision@10": ("RetrievalPrecision", {"k": 10}, "retrieval_precision", {"k": 10}),
    "recall@1000": ("RetrievalRecall", {"k": 1000}, "retrieval_recall", {"k": 1000}),
    "hit_rate@10": ("RetrievalHitRate", {"k": 10}, "retrieval_hit_rate", {"k": 10}),
    "fall_out@10": ("RetrievalFallOut", {"k": 10}, "retrieval_fall_out", {"k": 10}),
    "r_precision": ("RetrievalRPrecision", {}, "retrieval_r_precision", {}),
}


def check(cond, message):
    if not cond:
        raise RuntimeError(f"chip_smoke: {message}")


class Laps:
    """Seconds of command time between successive marks, by the part that ended."""

    def __init__(self):
        self.s, self._t = {}, time.perf_counter()

    def mark(self, part):
        now = time.perf_counter()
        self.s[part] = now - self._t
        self._t = now


def by_shape(counts):
    """A wrapper's launches per ``(branch, shape)`` as JSON keys: ``"hist (1024, 1000, 100)"``."""
    return {f"{branch} {shape}": n for (branch, shape), n in sorted(counts.items(), key=lambda kv: -kv[1])}


def at_shape(counts, shape):
    """The launches a wrapper counted at ``shape``, on any branch."""
    return sum(n for (_, s), n in counts.items() if s == shape)


def device_ms(torch, fn, reps=REPS):
    """Median device time of one call of ``fn``, from CUDA events around
    ``INNER`` back-to-back calls queued behind a device-side sleep, so that
    the host's launch cost does not show unless the call itself waits;
    ``reps`` repetitions."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(INNER):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / INNER)
    return statistics.median(times)


def host_ms(torch, fn, reps=REPS):
    """Median wall time of one call of ``fn`` up to the device's completion."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def host_ms_in_turns(torch, fns, reps=REPS, warmup=3, around=None):
    """Median wall time of one call of each of ``fns`` (a dict) up to the
    device's completion, the calls timed in turns within each repetition
    (forward order, then reverse: a, b, b, a) and each call's two readings
    averaged, so that a drift of the host's speed over the repetitions falls
    on every call alike. ``around`` (a dict on some of the same keys) gives a
    call a context, entered before its clock starts and left after it stops."""
    around = around or {}

    def arm(key):
        return around[key]() if key in around else contextlib.nullcontext()

    for key, fn in fns.items():
        for _ in range(warmup):
            with arm(key):
                fn()
    torch.cuda.synchronize()
    order = list(fns.items()) + list(reversed(fns.items()))
    times = {key: [] for key in fns}
    for _ in range(reps):
        lap = {key: 0.0 for key in fns}
        for key, fn in order:
            with arm(key):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                lap[key] += (time.perf_counter() - t0) * 1e3 / 2
        for key, ms in lap.items():
            times[key].append(ms)
    return {key: statistics.median(ms) for key, ms in times.items()}


def syncs_per_call(torch, fn):
    """The host<->device synchronisations one call of ``fn`` makes, each as
    ``file:line`` of the innermost line of the port on the stack, from
    PyTorch's sync debug mode."""
    fn()
    # the debug mode's first switch in a process reports a sync of its own
    torch.cuda.set_sync_debug_mode("warn")
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    found = []

    def note(message, *_args, **_kwargs):
        if "synchroniz" in str(message):
            frames = [f for f in traceback.extract_stack() if "metrics_tpu_torch" in f.filename]
            where = frames[-1] if frames else traceback.extract_stack()[-3]
            found.append(f"{where.filename.rsplit('metrics_tpu_torch/', 1)[-1]}:{where.lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return found


def profiled(torch, fn, calls, warmup=True, pad_s=PROFILE_PAD_S):
    """The device activities (kernels, memsets, copies) of ``calls`` calls of
    ``fn`` under ``torch.profiler``, as (name, µs) pairs; the wall µs of those
    calls; and each kernel's start less its launch call's start (µs), where the
    capture holds as many launch calls as kernels, else None.

    With ``warmup``, a first step of as many calls runs inside the same profiler
    session with tracing set up and its events dropped, and only the second step
    is kept. The recorded window holds ``pad_s`` of host time on each side of
    the calls: the profiler keeps only the device activities whose times, moved
    onto the host's clock, fall within its window, and that move can be off by
    more than a few short kernels last. Neither makes every capture whole on
    the card (part 4 prints how many of each way recorded every kernel), so a
    count that matters is checked against the wrappers' own launch counts."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if warmup:
        prof = profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1, repeat=1), acc_events=True)
    else:
        prof = profile(activities=activities)
    with prof:
        for _ in range(2 if warmup else 1):
            time.sleep(pad_s)
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            time.sleep(pad_s)
            if warmup:
                prof.step()
    # the schedule's step span is also recorded on the device, as an annotation: not an activity
    device = [e for e in prof.events() if str(e.device_type).endswith("CUDA") and not e.is_user_annotation]
    kernels = sorted((e for e in device if "memcpy" not in e.name.lower() and "memset" not in e.name.lower()),
                     key=lambda e: e.time_range.start)
    launch_calls = sorted((e for e in prof.events() if e.name.startswith("cudaLaunch")), key=lambda e: e.time_range.start)
    lag = ([k.time_range.start - c.time_range.start for k, c in zip(kernels, launch_calls)]
           if kernels and len(kernels) == len(launch_calls) else None)
    return [(e.name, e.time_range.elapsed_us()) for e in device], wall_us, lag


def device_busy(torch, fn, steps=10):
    """Device kernel time over wall time for ``steps`` calls of ``fn`` under
    ``torch.profiler`` (after a warm-up step), and the kernels by total time;
    None where the profiler saw no device activity."""
    events, wall_us, _ = profiled(torch, fn, steps)
    by_kernel = {}
    for name, us in events:
        by_kernel[name] = by_kernel.get(name, 0.0) + us
    if not by_kernel:
        return None
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {
        "steps": steps,
        "wall_us_per_step": wall_us / steps,
        "device_us_per_step": sum(by_kernel.values()) / steps,
        "busy_share": sum(by_kernel.values()) / wall_us,
        "top_kernels_us_per_step": {name[:60]: us / steps for name, us in top},
    }


def stat_inputs(torch, preds, target):
    """The stat_scores kernel's inputs as the macro update builds them."""
    from metrics_tpu_torch.functional.classification.stat_scores import _predicted_classes

    pred_cls = _predicted_classes(preds)
    target_cls = target.to(torch.int32)
    correct = pred_cls == target_cls
    w = torch.ones(preds.shape[0], dtype=torch.int32, device=preds.device)
    return target_cls, pred_cls, correct, w


def binned_ops(n, c, t):
    """The operations binned counts need: a binary search of ceil(log2(T + 1))
    compares and one histogram add a score, then one suffix-sum add a (class,
    threshold)."""
    return n * c * (math.ceil(math.log2(t + 1)) + 1) + c * t


def bound(nbytes, ops):
    """The least time (ms) the card could take for the work: bytes over the
    memory rate or operations over the float32 rate, whichever is larger."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def searchsorted_counts(torch, preds, target, thr):
    """Binned ``(tp, fp, fn)`` without the kernel or its plain version. For
    sorted thresholds, ``k = searchsorted(thr, score, right=True)`` counts the
    thresholds a score reaches; a per-class histogram of ``k`` and its suffix
    sum give the prediction-positive and true-positive counts."""
    n, c = preds.shape
    t = thr.shape[0]
    k = torch.searchsorted(thr, preds.contiguous(), right=True)
    flat = (torch.arange(c, device=preds.device) * (t + 1) + k).reshape(-1)
    y = (target == 1).reshape(n, c)
    hist_p = torch.bincount(flat, minlength=c * (t + 1)).reshape(c, t + 1)
    hist_tp = torch.bincount(flat, weights=y.reshape(-1).double(), minlength=c * (t + 1)).reshape(c, t + 1).long()
    # a score reaches thr[j] exactly when k > j
    p = hist_p.flip(1).cumsum(1).flip(1)[:, 1:]
    tp = hist_tp.flip(1).cumsum(1).flip(1)[:, 1:]
    pos = y.sum(0)
    return tp.float(), (p - tp).float(), (pos[:, None] - tp).float()


def coco_data(torch, dev):
    """MS-COCO 2014 val as a multilabel classifier sees it: Bernoulli(2.9/80)
    labels per class and scores ``sigmoid(N(0, 1) + 2 * label)``."""
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    target = (torch.rand(N_COCO, COCO_CLASSES, generator=g, device=dev) < COCO_LABELS_PER_IMAGE / COCO_CLASSES)
    target = target.to(torch.int32)
    scores = torch.sigmoid(torch.randn(N_COCO, COCO_CLASSES, generator=g, device=dev) + 2.0 * target)
    return scores, target


def imagenet_data(torch, dev):
    """ImageNet-1k val as a classifier's evaluation sees it: ``(50000, 1000)``
    softmax scores of seeded logits, the label on top for 76% of rows, and
    the labels."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    labels = torch.randint(0, NUM_CLASSES, (N_VAL,), generator=g, device=dev)
    logits = torch.randn(N_VAL, NUM_CLASSES, generator=g, device=dev)
    hit = torch.rand(N_VAL, generator=g, device=dev) < 0.76
    rows = torch.arange(N_VAL, device=dev)
    logits[rows, labels] = torch.where(hit, logits.amax(dim=1) + 1.0, logits[rows, labels])
    return torch.softmax(logits, dim=1), labels


def marco_data(torch, dev):
    """MS MARCO passage dev (small) as a re-ranker sees it: ``(Q, 1000)``
    scores, bool relevance (1 passage a query, 2 on 7% of queries) and query
    ids, with scores ``N(0, 1) + 2 * relevant`` rounded to 1/256."""
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    q, c = MARCO_QUERIES, MARCO_CANDIDATES
    first = torch.randint(0, c, (q,), generator=g, device=dev)
    second = (first + torch.randint(1, c, (q,), generator=g, device=dev)) % c
    two = torch.rand(q, generator=g, device=dev) < MARCO_TWO_RELEVANT
    target = torch.zeros(q, c, dtype=torch.bool, device=dev)
    rows = torch.arange(q, device=dev)
    target[rows, first] = True
    target[rows, second] |= two
    scores = torch.round((torch.randn(q, c, generator=g, device=dev) + 2.0 * target) * 256) / 256
    qids = (rows * 13 + 1000)[:, None].expand(q, c).contiguous()
    return scores, target, qids


def trec_data(torch, dev):
    """TREC DL 2019 passage shape: 43 queries x 1000 candidates, int32 grades
    0-3 and scores ``N(0, 1) + 0.8 * grade`` rounded to 1/256."""
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    u = torch.rand(TREC_QUERIES, MARCO_CANDIDATES, generator=g, device=dev)
    s1, s2, s3 = TREC_GRADE_SHARES
    grade = (u < s1 + s2 + s3).int() + (u < s2 + s3).int() + (u < s3).int()
    scores = torch.round((torch.randn(u.shape, generator=g, device=dev) + 0.8 * grade) * 256) / 256
    qids = torch.arange(TREC_QUERIES, device=dev)[:, None].expand(u.shape).contiguous()
    return scores, grade.to(torch.int32), qids


def click_stream(torch, dev):
    """10,000,000 item ids drawn Zipf(1.1) over 1,000,000 ids (inverse CDF
    in float64), as float32 (exact below 2^24)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    weight = torch.arange(1, CLICK_IDS + 1, dtype=torch.float64, device=dev) ** -CLICK_ZIPF
    cdf = torch.cumsum(weight, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(CLICKS, generator=g, device=dev, dtype=torch.float64)
    return torch.searchsorted(cdf, u).clamp(max=CLICK_IDS - 1).to(torch.float32)


def numpy_countmin(ids, depth, width):
    """The count-min table of unit-weight keys in numpy: the sketches' hash
    in uint32 arithmetic and ``np.add.at``, independent of the port."""
    bits = ids.astype(np.float32).view(np.uint32)
    table = np.zeros((depth, width), np.float64)
    mult = np.uint32(0x45D9F3B)
    for d in range(depth):
        x = bits ^ np.uint32((d * 0x9E3779B9 + 1) & 0xFFFFFFFF)
        x = (x ^ (x >> np.uint32(16))) * mult
        x = (x ^ (x >> np.uint32(16))) * mult
        x = x ^ (x >> np.uint32(16))
        np.add.at(table[d], (x % np.uint32(width)).astype(np.int64), 1.0)
    return table


def numpy_retrieval(scores, target):
    """Per-query MRR, AP and nDCG@10 (graded) in float64 from ``np.argsort(-p, kind="stable")``."""
    out = {"mrr": [], "map": [], "ndcg@10": []}
    disc = 1.0 / np.log2(np.arange(10) + 2.0)
    for p, t in zip(scores, target):
        st = t[np.argsort(-p, kind="stable")].astype(np.float64)
        rel = st > 0
        hits = np.flatnonzero(rel)
        out["mrr"].append(1.0 / (hits[0] + 1) if hits.size else 0.0)
        out["map"].append(float(np.mean(np.arange(1, hits.size + 1) / (hits + 1))) if hits.size else 0.0)
        ideal = np.sort(t.astype(np.float64))[::-1][:10]
        idcg = float((ideal * disc[: ideal.size]).sum())
        out["ndcg@10"].append(float((st[:10] * disc).sum()) / idcg if idcg > 0 else 0.0)
    return {k: np.asarray(v) for k, v in out.items()}


def numpy_confmat_scores(cm, ignore_index=None):
    """Quadratic-weighted Cohen's kappa, the Matthews correlation coefficient and the mean IoU (absent
    classes 0, the row and score of ``ignore_index`` left out) of a confusion matrix, in float64 numpy."""
    cm = cm.astype(np.float64)
    c, total = cm.shape[0], cm.sum()
    rows, cols = cm.sum(1), cm.sum(0)
    w = (np.arange(c)[:, None] - np.arange(c)[None, :]) ** 2.0
    kappa = 1.0 - (w * cm).sum() / (w * np.outer(rows, cols) / total).sum()
    mcc = (np.trace(cm) * total - rows @ cols) / np.sqrt((total**2 - cols @ cols) * (total**2 - rows @ rows))
    if ignore_index is not None:
        cm = cm.copy()
        cm[ignore_index] = 0
    inter = np.diag(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    kept = [k for k in range(c) if k != ignore_index]
    return {"kappa": kappa, "mcc": mcc, "miou": iou[kept].mean()}


def numpy_stat_family(cm, beta):
    """Macro precision, recall, F1, F-beta and specificity and the Hamming distance of one-hot top-1
    predictions, from a confusion matrix in float64 numpy: classes with no tp, fp or fn leave the
    precision, recall and F averages; a zero denominator scores 0."""
    cm = cm.astype(np.float64)
    n, c = cm.sum(), cm.shape[0]
    tp = np.diag(cm)
    fp, fn = cm.sum(0) - tp, cm.sum(1) - tp
    tn = n - tp - fp - fn
    present = (tp + fp + fn) > 0

    def ratio(num, den):
        return np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)

    prec, rec = ratio(tp, tp + fp), ratio(tp, tp + fn)
    f = {b: ratio((1 + b * b) * prec * rec, b * b * prec + rec) for b in (1.0, beta)}
    return {"precision": prec[present].mean(), "recall": rec[present].mean(), "f1": f[1.0][present].mean(),
            "fbeta": f[beta][present].mean(), "specificity": ratio(tn, tn + fp).mean(),
            "hamming": 2.0 * (n - tp.sum()) / (n * c)}


def merged(*counts):
    """Launch counts by ``(branch, shape)`` of several paths, summed."""
    out = {}
    for by in counts:
        for key, count in by.items():
            out[key] = out.get(key, 0) + count
    return out


def segmentation_data(torch, dev):
    """Cityscapes val geometry as uint8 label maps on the card: a class a 32 x 32 patch with shares
    proportional to (k + 1)^-1.1 over the 19 evaluated classes, 10% of patches void, and predictions
    equal to the target on 94% of pixels, a class drawn from the same shares elsewhere."""
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    cdf = torch.cumsum(torch.arange(1, SEG_VOID + 1, dtype=torch.float64, device=dev) ** -SEG_ZIPF, 0)
    cdf = (cdf / cdf[-1]).float()

    def draw(shape):
        return torch.searchsorted(cdf, torch.rand(shape, generator=g, device=dev)).clamp(max=SEG_VOID - 1)

    ph, pw = SEG_H // SEG_PATCH, SEG_W // SEG_PATCH
    patch = draw((SEG_IMAGES, ph, 1, pw, 1))
    patch = torch.where(torch.rand(patch.shape, generator=g, device=dev) < SEG_VOID_SHARE, SEG_VOID, patch)
    target = patch.to(torch.uint8).expand(-1, -1, SEG_PATCH, -1, SEG_PATCH).reshape(SEG_IMAGES, SEG_H, SEG_W)
    pred = torch.empty_like(target)
    for i in range(SEG_IMAGES):  # an image at a time: the draws stay small
        right = torch.rand((SEG_H, SEG_W), generator=g, device=dev) < SEG_RIGHT
        pred[i] = torch.where(right, target[i], draw((SEG_H, SEG_W)).to(torch.uint8))
    return target, pred, float(cdf[0])


def device_kernels(torch, fn, kernel, calls=3, tries=8):
    """The names of the device activities (kernels, memsets, copies) of ``calls`` calls of ``fn``, from
    ``torch.profiler`` (after a warm-up step), and the number of activities of each capture taken. A capture
    that recorded fewer device activities than the wrapper of ``kernel`` counts launches for ``calls`` calls
    is incomplete and is taken again, up to ``tries`` times: it says nothing about ``fn``, and an activity
    more than the launches still shows."""
    from metrics_tpu_torch.ops import launches

    before = launches()[kernel]
    fn()
    launched = (launches()[kernel] - before) * calls
    captured = []
    for _ in range(tries):
        names = [name for name, _ in profiled(torch, fn, calls)[0]]
        captured.append(len(names))
        if len(names) >= launched:
            break
    return names, captured


# the device kernels of each wrapper's launch as the profiler names them: one a launch (count-min's shared branch
# adds countmin_sum_partials, a second kernel of the same launch, not one of these)
DEVICE_KERNELS = {"stat_scores": ("stat_counts_",), "confusion_matrix": ("confmat_band", "confmat_split"),
                  "countmin": ("countmin_partials", "countmin_global")}


def replayed_kernels(torch, fn, calls=3, tries=8):
    """For ``calls`` warm calls of ``fn`` (engine updates, each a graph replay): per wrapper kernel, the launches
    the registry added (``note_replay``, from the list the capture wrote down) and the device kernels of that
    name ``torch.profiler`` recorded; and the activities of each capture taken. A capture that recorded fewer
    of those kernels than the registry added is incomplete and is taken again, up to ``tries`` times; one
    that recorded more still shows."""
    from metrics_tpu_torch.ops import launches

    before = launches()
    fn()
    per_call = {k: launches()[k] - before[k] for k in DEVICE_KERNELS}
    captured = []
    for _ in range(tries):
        before = launches()
        names = [name for name, _ in profiled(torch, fn, calls)[0]]
        # profiled makes one call, a warm-up step and the kept step
        added = {k: launches()[k] - before[k] for k in DEVICE_KERNELS}
        seen = {k: sum(any(d in n for d in DEVICE_KERNELS[k]) for n in names) for k in DEVICE_KERNELS}
        captured.append(len(names))
        if all(seen[k] >= per_call[k] * calls for k in DEVICE_KERNELS):
            break
    return {k: {"per_update": per_call[k], "registry": per_call[k] * calls, "profiler": seen[k],
                "registry_in_window": added[k], "window_updates": 1 + 2 * calls} for k in DEVICE_KERNELS}, captured


def program_kernels(torch, m, args):
    """Per wrapper kernel, for one replay of ``m``'s engine program: the launches its capture wrote down
    (``program.launched``, what ``note_replay`` adds a replay) and the kernel nodes of that name in its graph,
    read through the CUDA driver API from a copy of ``m`` captured again under :func:`kept_graphs`. Unlike a
    profiler capture this never comes back short."""
    import copy

    twin = copy.deepcopy(m)
    with kept_graphs(torch):
        twin.update(*args)
    program = engine_program(twin)
    names = [n for kind, n in graph_node_list(program.graphs[0]) if kind == "kernel"]
    return {k: {"written": sum(launch[0] == k for launch in program.launched),
                "graph": sum(any(d in n for d in DEVICE_KERNELS[k]) for n in names)} for k in DEVICE_KERNELS}


def curve_members(M, device):
    """Slice 10's ImageNet curve-and-calibration collection; its keys are those of
    ``tests/test_torch_curves.py``, which holds the port's compute groups equal to the JAX package's."""
    return {
        "acc": M.Accuracy(num_classes=NUM_CLASSES, average="macro", device=device),
        "auroc": M.AUROC(num_classes=NUM_CLASSES, device=device),
        "auroc_weighted": M.AUROC(num_classes=NUM_CLASSES, average="weighted", device=device),
        "ece": M.CalibrationError(n_bins=ECE_BINS, device=device),
        "mce": M.CalibrationError(n_bins=ECE_BINS, norm="max", device=device),
    }


def teacher_data(torch, scores):
    """A seeded teacher distribution over the ImageNet classes: the scores'
    log-probabilities plus N(0, 0.5^2) noise, renormalised."""
    g = torch.Generator(device=scores.device).manual_seed(SEED + 6)
    noise = torch.randn(scores.shape, generator=g, device=scores.device)
    return torch.softmax(torch.log(scores) + TEACHER_NOISE * noise, dim=1)


def one_call_syncs(torch, fn):
    """The host syncs of one call of ``fn`` (already warm), as :func:`syncs_per_call` finds them: their
    number, and the most frequent ``file:line`` of the port among the first ``SYNC_SITES_SAMPLED`` (a stack
    walk a sync would cost more than the call itself)."""
    torch.cuda.set_sync_debug_mode("warn")
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    found, count = {}, [0]

    def note(message, *_args, **_kwargs):
        if "synchroniz" in str(message):
            count[0] += 1
            if count[0] > SYNC_SITES_SAMPLED:
                return
            frames = [f for f in traceback.extract_stack() if "metrics_tpu_torch" in f.filename]
            where = frames[-1] if frames else traceback.extract_stack()[-3]
            key = f"{where.filename.rsplit('metrics_tpu_torch/', 1)[-1]}:{where.lineno}"
            found[key] = found.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return count[0], dict(sorted(found.items(), key=lambda kv: -kv[1])[:4])


def run_slice10_imagenet(torch, M, device, data, teacher, on_card=False):
    """ImageNet's epoch through the curve collection and the standalone slice-10 modules: the modules,
    their values, the update seconds and each compute's seconds. ``on_card``: also the
    ``compute_on_cpu=True`` AUROC (held against the collection's own AUROC), its states checked after
    every update."""
    coll = M.MetricCollection(curve_members(M, device))
    alone = {
        "roc": M.ROC(num_classes=NUM_CLASSES, device=device),
        "hinge": M.HingeLoss(device=device),
        "kl": M.KLDivergence(device=device),
        "kl_log_prob": M.KLDivergence(log_prob=True, device=device),
    }
    if on_card:
        alone["auroc_compute_on_cpu"] = M.AUROC(num_classes=NUM_CLASSES, compute_on_cpu=True, device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for (p, t), q in zip(data, teacher):
        coll.update(p, t)
        alone["roc"].update(p, t)
        log_p = torch.log(p)
        alone["hinge"].update(log_p, t)
        alone["kl"].update(q, p)  # D_KL(teacher || model)
        alone["kl_log_prob"].update(torch.log(q), log_p)
        if on_card:
            moved = alone["auroc_compute_on_cpu"]
            moved.update(p, t)
            check(all(v.device.type == "cpu" for v in moved.preds + moved.target),
                  "AUROC(compute_on_cpu=True) holds a list state off the CPU after an update")
    sync()
    update_s = time.perf_counter() - t0
    values, compute_s = {}, {}
    calls = [("collection", coll.compute)] + [(k, m.compute) for k, m in alone.items()]
    calls.append(("dice_score", lambda: M.functional.dice_score(torch.cat([p for p, _ in data]),
                                                                torch.cat([t for _, t in data]))))
    for key, fn in calls:
        sync()
        t0 = time.perf_counter()
        values[key] = fn()
        sync()
        compute_s[key] = time.perf_counter() - t0
    return coll, alone, values, update_s, compute_s


def coco_ranking_modules(M, device):
    return {
        "coverage_error": M.CoverageError(device=device),
        "label_ranking_average_precision": M.LabelRankingAveragePrecision(device=device),
        "label_ranking_loss": M.LabelRankingLoss(device=device),
        "auroc_micro": M.AUROC(num_classes=COCO_CLASSES, average="micro", device=device),
        "auroc_macro": M.AUROC(num_classes=COCO_CLASSES, device=device),
    }


def marco_binary_modules(M, device):
    return {"auroc_max_fpr": M.AUROC(pos_label=1, max_fpr=MARCO_MAX_FPR, device=device),
            "roc": M.ROC(pos_label=1, device=device)}


def run_modules(torch, mods, device, data):
    """Every batch of ``data`` into each of ``mods``, then each one's ``compute``: the modules, their values,
    the update seconds and each compute's seconds."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for batch in data:
        for m in mods.values():
            m.update(*batch)
    sync()
    update_s = time.perf_counter() - t0
    values, compute_s = {}, {}
    for key, m in mods.items():
        t0 = time.perf_counter()
        values[key] = m.compute()
        sync()
        compute_s[key] = time.perf_counter() - t0
    return mods, values, update_s, compute_s


def numpy_macro_auroc(scores, labels):
    """Macro one-vs-rest AUROC in float64 by the Mann-Whitney statistic:
    average ranks (``scipy.stats.rankdata``, ties counted half) of each
    class's scores, the positives' rank sum less its least value, over the
    positive-negative pairs."""
    from scipy.stats import rankdata

    n, c = scores.shape
    ranks = rankdata(np.ascontiguousarray(scores.T, dtype=np.float64), axis=1)  # (C, N)
    n_pos = np.bincount(labels, minlength=c).astype(np.float64)
    rank_pos = np.bincount(labels, weights=ranks[labels, np.arange(n)], minlength=c)
    auc = (rank_pos - n_pos * (n_pos + 1) / 2) / (n_pos * (n - n_pos))
    return float(auc.mean())


def numpy_calibration(conf, correct, bounds):
    """ECE and MCE in float64 from a histogram of float32 confidences over the given boundaries."""
    n_bins = bounds.size - 1
    idx = np.clip(np.searchsorted(bounds, conf, side="left") - 1, 0, n_bins - 1)
    count = np.bincount(idx, minlength=n_bins).astype(np.float64)
    conf_sum = np.bincount(idx, weights=conf.astype(np.float64), minlength=n_bins)
    acc_sum = np.bincount(idx, weights=correct.astype(np.float64), minlength=n_bins)
    safe = np.maximum(count, 1)
    gap = np.abs(acc_sum / safe - conf_sum / safe)
    return float((gap * count / count.sum()).sum()), float(gap.max())


def numpy_partial_auc(scores, target, max_fpr):
    """Binary partial AUC over [0, max_fpr] with the McClish correction in
    float64: the ROC at the distinct scores (a stable descending sort), cut
    by a linear interpolation at ``max_fpr``."""
    order = np.argsort(-scores, kind="stable")
    s, y = scores[order].astype(np.float64), target[order].astype(np.float64)
    idx = np.r_[np.nonzero(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y)[idx]
    fps = 1 + idx - tps
    fpr, tpr = np.r_[0.0, fps] / fps[-1], np.r_[0.0, tps] / tps[-1]
    stop = int(np.searchsorted(fpr, max_fpr, side="right"))
    tpr_cut = tpr[stop - 1] + (max_fpr - fpr[stop - 1]) / (fpr[stop] - fpr[stop - 1]) * (tpr[stop] - tpr[stop - 1])
    x, yv = np.r_[fpr[:stop], max_fpr], np.r_[tpr[:stop], tpr_cut]
    partial = float(np.sum(np.diff(x) * (yv[1:] + yv[:-1]) / 2))
    min_area = 0.5 * max_fpr**2
    return 0.5 * (1 + (partial - min_area) / (max_fpr - min_area))


def numpy_ranking(scores, target):
    """Coverage error, label ranking average precision and label ranking loss
    in float64 (scikit-learn's definitions) for scores with no ties in a row."""
    n, c = scores.shape
    rel = target == 1
    n_rel = rel.sum(1)
    lowest_rel = np.where(rel, scores, np.inf).min(1)
    coverage = np.where(n_rel > 0, (scores >= lowest_rel[:, None]).sum(1), 0).astype(np.float64)
    lrap = np.ones(n)
    loss = np.zeros(n)
    for i in range(n):
        if 0 < n_rel[i] < c:
            geq = scores[i][None, :] >= scores[i][rel[i]][:, None]  # (relevant, all)
            lrap[i] = np.mean(geq[:, rel[i]].sum(1) / geq.sum(1))
            wrong = (scores[i][~rel[i]][None, :] > scores[i][rel[i]][:, None]).sum()
            loss[i] = wrong / (n_rel[i] * (c - n_rel[i]))
    return {"coverage_error": coverage.mean(), "label_ranking_average_precision": lrap.mean(),
            "label_ranking_loss": loss.mean()}


def evaluation_members(M, device, **extra):
    """Slice 7's eleven-member ImageNet evaluation collection (``M`` the port's package); ``extra``
    (``jit_update=True`` in slice 13) goes to every member."""
    macro = dict(num_classes=NUM_CLASSES, average="macro", device=device, **extra)
    matmul = dict(update_method="matmul", device=device, **extra)
    return [M.Accuracy(**macro), M.Precision(**macro), M.Recall(**macro), M.F1Score(**macro),
            M.FBetaScore(beta=FBETA, **macro), M.Specificity(**macro), M.HammingDistance(device=device, **extra),
            M.ConfusionMatrix(NUM_CLASSES, **matmul), M.CohenKappa(NUM_CLASSES, weights="quadratic", **matmul),
            M.MatthewsCorrCoef(NUM_CLASSES, **matmul), M.JaccardIndex(NUM_CLASSES, **matmul)]


def sync_rank(torch, dist, rank, dev):
    """Slice 9 on one rank of the group: its quarter of each path, synced by
    ``compute``. Returns what the parent checks, as numpy arrays and numbers."""
    import metrics_tpu_torch as M
    from metrics_tpu_torch import resilience, telemetry
    from metrics_tpu_torch.ops import launches, reset_launches
    from metrics_tpu_torch.parallel import NoOpEnv

    # every collective the gloo group runs, counted by call (the env reaches them as dist.<call>)
    issued = {}
    for name in SYNC_COLLECTIVES:
        def counted(*args, _call=getattr(dist, name), _name=name, **kwargs):
            issued[_name] = issued.get(_name, 0) + 1
            return _call(*args, **kwargs)
        setattr(dist, name, counted)

    def members_of(mc):
        return list(mc.values(copy_state=False))

    def fresh(metrics):
        for m in metrics:
            m._computed = None

    def timed_compute(metrics, compute, mode):
        """``compute`` with every memo dropped: synced by buckets (``fused``), leaf by leaf (``per_leaf``), or
        not at all (``local``: the same compute on this rank's states)."""
        def run():
            fresh(metrics)
            os.environ["METRICS_TPU_FUSED_SYNC"] = "0" if mode == "per_leaf" else "1"
            for m in metrics:
                m._sync_env = NoOpEnv() if mode == "local" else None
            try:
                compute()
            finally:
                for m in metrics:
                    m._sync_env = None
                os.environ.pop("METRICS_TPU_FUSED_SYNC")
        return run

    def sync_times(metrics, compute, modes=("fused", "per_leaf", "local"), reps=SYNC_TURNS, warmup=3, **extra):
        fns = {mode: timed_compute(metrics, compute, mode) for mode in modes}
        return host_ms_in_turns(torch, {**fns, **extra}, reps=reps, warmup=warmup)

    def npy(values):
        return {k: v.cpu().numpy() for k, v in values.items()}

    def call_counts():
        out = dict(issued)
        issued.clear()
        return out

    def traced(compute, owners):
        """``compute()`` inside a telemetry session (slice 13): its value, and the session's collective spans and
        their bytes beside the collectives and bytes on the wire that ``owners``' sync_stats counted."""
        before = [dict(o.sync_stats) for o in owners]
        with telemetry.instrument() as session:
            value = compute()
        spans = session.spans(name="collective")
        counted = [{k: o.sync_stats.get(k, 0) - b.get(k, 0) for k in ("collectives", "bytes_on_wire")}
                   for o, b in zip(owners, before)]
        return value, {"spans": len(spans), "nbytes": sum(e.attrs["nbytes"] for e in spans),
                       "collectives": sum(c["collectives"] for c in counted),
                       "bytes_on_wire": sum(c["bytes_on_wire"] for c in counted),
                       "sync_spans": session.count(name="sync")}

    out = {"degrades_start": resilience.degrades()}
    # ---------------- ImageNet-1k val: this rank's 12,500 images in batches of 1,024 (12 full, one of 212)
    scores, labels = imagenet_data(torch, dev)
    per = N_VAL // SYNC_RANKS
    scores, labels = scores[rank * per:(rank + 1) * per].clone(), labels[rank * per:(rank + 1) * per].clone()
    torch.cuda.empty_cache()
    batches = [(scores[i:i + BATCH], labels[i:i + BATCH]) for i in range(0, per, BATCH)]
    imagenet = {"batches": len(batches), "last": int(batches[-1][0].shape[0])}
    collections = {}
    for mode, fused in (("eager", False), ("fused", True)):
        mc = M.MetricCollection(evaluation_members(M, dev), prefix="val_", fused_update=fused)
        reset_launches()
        for p, t in batches:
            mc.update(p, t)
        torch.cuda.synchronize()
        launched = dict(launches())
        call_counts()
        values, tel = traced(mc.compute, [mc] + members_of(mc))
        imagenet[mode] = {
            "values": npy(values), "launches": launched, "issued": call_counts(), "sync_stats": mc.sync_stats,
            "telemetry": tel,
            "member_collectives": sum(m.sync_stats["collectives"] for m in members_of(mc)),
            "demotions": mc.dispatch_stats["demotions"], "groups": mc.compute_groups,
            "local_tp": mc["Accuracy"].tp.cpu().numpy(),
        }
        collections[mode] = mc
    eager = collections["eager"]
    os.environ["METRICS_TPU_FUSED_SYNC"] = "0"
    fresh(members_of(eager))
    before = sum(m.sync_stats["collectives"] for m in members_of(eager))
    values = eager.compute()
    imagenet["per_leaf"] = {"values": npy(values), "issued": call_counts(), "sync_stats": eager.sync_stats,
                            "member_collectives": sum(m.sync_stats["collectives"] for m in members_of(eager)) - before}
    os.environ.pop("METRICS_TPU_FUSED_SYNC")
    imagenet["sync_ms"] = sync_times(members_of(eager), eager.compute)
    call_counts()
    # Accuracy through the engine: update, compute (synced), update, compute, against the eager metric
    for jit in (False, True):
        acc = M.Accuracy(num_classes=NUM_CLASSES, average="macro", jit_update=jit, device=dev)
        reset_launches()
        vals = []
        for i, (p, t) in enumerate(batches):
            acc.update(p, t)
            if i in (5, len(batches) - 1):
                vals.append(acc.compute().cpu().numpy())
        imagenet[f"accuracy_jit{int(jit)}"] = {"values": vals, "launches": launches()["stat_scores"],
                                              "demotions": acc.dispatch_stats["demotions"]}
    # ConfusionMatrix sharded over the group: pure_sync leaves this rank C / 4 rows (one reduce-scatter)
    cm = M.ConfusionMatrix(NUM_CLASSES, update_method="matmul", shard_state="world", device=dev)
    reset_launches()
    for p, t in batches:
        cm.update(p, t)
    launched = launches()["confusion_matrix"]
    call_counts()
    synced = cm.pure_sync(cm.state())
    sharded_issued = call_counts()
    imagenet["sharded"] = {
        "launches": launched, "issued": sharded_issued, "sync_stats": cm.sync_stats,
        "shard_shape": list(synced["confmat"].shape), "shard_nbytes": synced["confmat"].nbytes,
        "assembled": cm.assemble_sharded(synced)["confmat"].cpu().numpy(),
    }
    # the same state on the int8 wire: a quantised sharded bucket crosses in one all-to-all (each rank's counts a
    # cell stay below quant.INT_EXACT_BOUND, so the assembled matrix keeps its bits)
    cm8 = M.ConfusionMatrix(NUM_CLASSES, update_method="matmul", shard_state="world", sync_precision="int8", device=dev)
    call_counts()
    synced8 = cm8.pure_sync(cm.state())
    imagenet["sharded_int8"] = {
        "issued": call_counts(), "sync_stats": cm8.sync_stats, "shard_shape": list(synced8["confmat"].shape),
        "assembled": cm8.assemble_sharded(synced8)["confmat"].cpu().numpy(),
    }
    call_counts()
    out["imagenet"] = imagenet
    del scores, labels, batches, collections, eager, cm, synced, cm8, synced8
    torch.cuda.empty_cache()

    # ---------------- MS MARCO: this rank's queries (an uneven split; rank 3 holds none), updates of 64 queries
    m_scores, m_target, m_qids = marco_data(torch, dev)
    qlo, qhi = MARCO_SPLIT[rank], MARCO_SPLIT[rank + 1]
    mine = [(m_scores[i:min(i + MARCO_QUERY_BATCH, qhi)].reshape(-1), m_target[i:min(i + MARCO_QUERY_BATCH, qhi)].reshape(-1),
             m_qids[i:min(i + MARCO_QUERY_BATCH, qhi)].reshape(-1)) for i in range(qlo, qhi, MARCO_QUERY_BATCH)]
    metrics = {key: getattr(M, cls)(device=dev, **kw) for key, (cls, kw, _, _) in RETRIEVAL.items()}
    for p, t, i in mine:
        for m in metrics.values():
            m.update(p, t, i)
    reset_launches()
    call_counts()
    stats0 = {key: m.sync_stats["collectives"] for key, m in metrics.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # rank 3's metrics compute with no update of their own
        values = {key: m.compute() for key, m in metrics.items()}
        torch.cuda.synchronize()
        marco = {"values": npy(values), "launches": launches()["retrieval_sort"], "issued": call_counts(),
                 "collectives": sum(m.sync_stats["collectives"] - stats0[key] for key, m in metrics.items()),
                 "queries": qhi - qlo, "updates": len(mine),
                 "rows": sum(p.numel() for p, _, _ in mine)}
        mp_ = metrics["map"]

        def sync_unsync():
            mp_.sync()
            mp_.unsync()

        # the ragged states are never bucketed, so fused and per-leaf run the same gathers; a local compute
        # scores this rank's queries only (rank 3 has none), so the sync and unsync alone are timed instead
        marco["sync_ms"] = sync_times([mp_], mp_.compute, modes=("fused", "per_leaf"), reps=3, warmup=1,
                                      sync_unsync=sync_unsync)
    call_counts()
    out["marco"] = marco
    del m_scores, m_target, m_qids, mine, metrics, values
    torch.cuda.empty_cache()

    # ---------------- the click log: this rank's 2,500,000 ids, count-min and HyperLogLog on the int8 wire
    clicks = click_stream(torch, dev)
    per = CLICKS // SYNC_RANKS
    mine = clicks[rank * per:(rank + 1) * per].clone()
    del clicks
    click_batches = [mine[i:i + CLICK_BATCH] for i in range(0, per, CLICK_BATCH)]
    sk = M.MetricCollection([M.CountMinHeavyHitters(device=dev), M.HyperLogLog(precision=14, device=dev)],
                            sync_precision="int8", compute_groups=False, fused_update=False)
    reset_launches()
    for x in click_batches:
        sk.update(x)
    click = {"batches": len(click_batches), "launches": launches()["countmin"],
             "local_table": sk["CountMinHeavyHitters"].value.cpu().numpy()}
    for quant_on in ("1", "0"):
        os.environ["METRICS_TPU_QUANT_SYNC"] = quant_on
        before = dict(sk.sync_stats)
        call_counts()
        fresh(members_of(sk))  # a memoised member keeps its value and is left out of the collection's sync
        with telemetry.instrument() as session, sk.sync_context():
            click[f"table{quant_on}"] = sk["CountMinHeavyHitters"].value.cpu().numpy()
            click[f"registers{quant_on}"] = sk["HyperLogLog"].value.cpu().numpy()
            click[f"values{quant_on}"] = npy(sk.compute())
        spans = session.spans(name="collective")
        click[f"telemetry{quant_on}"] = {"spans": len(spans), "nbytes": sum(e.attrs["nbytes"] for e in spans)}
        click[f"issued{quant_on}"] = call_counts()
        click[f"wire{quant_on}"] = {k: v - before.get(k, 0) for k, v in sk.sync_stats.items()}
        os.environ.pop("METRICS_TPU_QUANT_SYNC")
    click["sync_ms"] = sync_times(members_of(sk), sk.compute)
    call_counts()
    out["click"] = click

    # ---------------- slice 21's capstone: the static audit's classification suite (C = 32, no compute groups, as
    # the JAX package's bench counts it), synced by compute: bucketed, then leaf by leaf
    from metrics_tpu_torch.analysis import program_audit

    suite = M.MetricCollection(program_audit.classification_suite(dev), compute_groups=False)
    g_suite = torch.Generator(device=dev).manual_seed(SEED + 21 + rank)
    suite.update(torch.rand(256, 32, generator=g_suite, device=dev),
                 torch.randint(0, 32, (256,), generator=g_suite, device=dev, dtype=torch.int32))
    torch.cuda.synchronize()
    capstone = {}
    for mode in ("fused", "per_leaf"):
        fresh(members_of(suite))
        call_counts()
        os.environ["METRICS_TPU_FUSED_SYNC"] = "0" if mode == "per_leaf" else "1"
        try:
            suite.compute()
        finally:
            os.environ.pop("METRICS_TPU_FUSED_SYNC")
        capstone[mode] = call_counts()
    out["capstone"] = capstone
    out["degrades"] = resilience.degrades()
    return out


def sync_worker(rank, init, results):
    """One rank of slice 9 (a spawned process): joins the gloo group, runs
    :func:`sync_rank` on the card and puts ``(rank, result, error)``."""
    import datetime

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=SYNC_RANKS,
                                timeout=datetime.timedelta(seconds=SYNC_TIMEOUT_S))
        try:
            out = sync_rank(torch, dist, rank, torch.device("cuda", 0))
        finally:
            dist.destroy_process_group()
        results.put((rank, out, None))
    except BaseException:  # noqa: BLE001 -- sent to the parent, which fails the run with it
        results.put((rank, None, traceback.format_exc()))


def run_sync_ranks():
    """Slice 9's four ranks as spawned processes (CUDA is live in this one,
    so no fork) meeting through a ``file://`` rendezvous in a temporary
    directory. Their results by rank; any rank's error, a non-zero exit or
    a hang past ``SYNC_DEADLINE_S`` fails the run, and every worker is
    stopped before this returns."""
    import multiprocessing
    import queue
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=sync_worker, args=(r, init, results)) for r in range(SYNC_RANKS)]
        for p in procs:
            p.start()
        outs, errors = {}, []
        deadline = time.monotonic() + SYNC_DEADLINE_S
        try:
            while len(outs) + len(errors) < SYNC_RANKS:
                try:
                    rank, out, err = results.get(timeout=max(1.0, deadline - time.monotonic()))
                except queue.Empty:
                    raise RuntimeError(f"chip_smoke: slice 9's ranks did not finish in {SYNC_DEADLINE_S} s "
                                       f"(done: {sorted(outs)})") from None
                if err is not None:
                    errors.append(f"rank {rank}:\n{err}")
                else:
                    outs[rank] = out
            check(not errors, "slice 9 failed on a rank:\n" + "\n".join(errors))
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
                check(p.exitcode == 0, f"a slice 9 worker exited with {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
    return [outs[r] for r in range(SYNC_RANKS)]


def run_slice10(torch, dev, batches, coco_batches, marco_batches, laps):
    """Slice 10 (see the module's docstring): returns the kernels' launches on its path and ``stat_scores``'s by
    branch and shape."""
    import metrics_tpu_torch as M
    from metrics_tpu_torch.ops import launches, registry, reset_launches

    cpu = torch.device("cpu")
    teacher = teacher_data(torch, torch.cat([p for p, _ in batches]))
    teacher_batches = [teacher[i:i + BATCH] for i in range(0, N_VAL, BATCH)]
    marco_binary = [(p, t.to(torch.int32)) for p, t, _ in marco_batches]
    reset_launches()
    coll10, alone10, im10, im10_update_s, im10_compute_s = run_slice10_imagenet(
        torch, M, dev, batches, teacher_batches, on_card=True)
    coco_mods, coco10, coco10_update_s, coco10_compute_s = run_modules(
        torch, coco_ranking_modules(M, dev), dev, coco_batches)
    marco_mods, marco10, marco10_update_s, marco10_compute_s = run_modules(
        torch, marco_binary_modules(M, dev), dev, marco_binary)
    slice10_launches = launches()
    slice10_stat_by_shape = registry.launches_by_shape("stat_scores")
    check(slice10_launches == {**{k: 0 for k in slice10_launches}, "stat_scores": len(batches)},
          f"slice 10 launched {slice10_launches}, not stat_scores once a batch ({len(batches)}) and nothing else")
    check(coll10.compute_groups == CURVE_GROUPS,
          f"the curve collection formed the groups {coll10.compute_groups}, not the JAX package's {CURVE_GROUPS}")
    def state_bytes(m):
        states = [getattr(m, k) for k in m._defaults]
        return sum(v.numel() * v.element_size() for x in states for v in (x if isinstance(x, list) else [x]))

    leader_bytes = {group[0]: state_bytes(coll10[group[0]]) for group in CURVE_GROUPS.values()}
    check(all(v.device == dev for v in coll10["auroc"].preds) and
          sum(v.numel() * 4 for v in coll10["auroc"].preds) == N_VAL * NUM_CLASSES * 4,
          "the AUROC group's list state does not hold the epoch's 200 MB of scores on the card")
    moved = alone10["auroc_compute_on_cpu"]
    check(all(v.device.type == "cpu" for v in moved.preds + moved.target), "AUROC(compute_on_cpu=True) states")
    laps.mark("3. slice 10 on the card")

    # the CPU reruns a prefix of each dataset, held against a card run over the same prefix; the whole epochs on
    # the card are held against the float64 references below
    head = SLICE10_CPU_BATCHES
    cpu_im = [(p.cpu(), t.cpu()) for p, t in batches]
    _, _, h_im10, _, _ = run_slice10_imagenet(torch, M, dev, batches[:head], teacher_batches[:head])
    _, h_coco10, _, _ = run_modules(torch, coco_ranking_modules(M, dev), dev, coco_batches[:head])
    _, h_marco10, _, _ = run_modules(torch, marco_binary_modules(M, dev), dev, marco_binary[:head])
    _, _, c_im10, c_im10_update_s, c_im10_compute_s = run_slice10_imagenet(
        torch, M, cpu, cpu_im[:head], [q.cpu() for q in teacher_batches[:head]])
    _, c_coco10, _, c_coco10_compute_s = run_modules(
        torch, coco_ranking_modules(M, cpu), cpu, [(p.cpu(), t.cpu()) for p, t in coco_batches[:head]])
    _, c_marco10, _, c_marco10_compute_s = run_modules(
        torch, marco_binary_modules(M, cpu), cpu, [(p.cpu(), t.cpu()) for p, t in marco_binary[:head]])
    laps.mark("3. slice 10 on the CPU")

    def same_curves(a, b, what):
        a, b = (a, b) if isinstance(a[0], list) else ([[x] for x in a], [[x] for x in b])
        for part_a, part_b, name in zip(a, b, ("fpr", "tpr", "thresholds")):
            check(len(part_a) == len(part_b) and all(x.dtype == y.dtype and torch.equal(x.cpu(), y)
                                                     for x, y in zip(part_a, part_b)),
                  f"{what}: the {name} curves differ from the CPU run")

    def close(got, want, what):
        check(bool(torch.isfinite(got).all()), f"{what} is not finite: {got}")
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0, msg=f"{what} differs from the CPU run")

    for key, got in im10["collection"].items():
        check(bool(torch.isfinite(got).all()), f"ImageNet {key} is not finite: {got}")
    for key, got in h_im10["collection"].items():
        close(got, c_im10["collection"][key], f"ImageNet {key} of the first {head} batches")
    for key in ("hinge", "kl", "kl_log_prob", "dice_score"):
        check(bool(torch.isfinite(im10[key]).all()), f"ImageNet {key} is not finite: {im10[key]}")
        close(h_im10[key], c_im10[key], f"ImageNet {key} of the first {head} batches")
    check(im10["auroc_compute_on_cpu"].device.type == "cpu", "AUROC(compute_on_cpu=True) computed off the CPU")
    torch.testing.assert_close(im10["auroc_compute_on_cpu"], im10["collection"]["auroc"].cpu(), rtol=1e-6, atol=0,
                               msg="AUROC(compute_on_cpu=True) differs from the AUROC on the card")
    same_curves(h_im10["roc"], c_im10["roc"], f"ImageNet ROC of the first {head} batches")
    check(len(im10["roc"][0]) == NUM_CLASSES, "ImageNet ROC is not a curve a class")
    for key in coco10:
        check(bool(torch.isfinite(coco10[key]).all()), f"COCO {key} is not finite: {coco10[key]}")
        close(h_coco10[key], c_coco10[key], f"COCO {key} of the first {head} batches")
    check(bool(torch.isfinite(marco10["auroc_max_fpr"]).all()), "MS MARCO AUROC(max_fpr=0.1) is not finite")
    close(h_marco10["auroc_max_fpr"], c_marco10["auroc_max_fpr"], f"MS MARCO AUROC(max_fpr=0.1) of the first {head} batches")
    same_curves(h_marco10["roc"], c_marco10["roc"], f"MS MARCO ROC of the first {head} batches")

    # independent float64 references
    np_scores = torch.cat([p for p, _ in cpu_im]).numpy()
    np_labels = torch.cat([t for _, t in cpu_im]).numpy()
    ref_auroc = numpy_macro_auroc(np_scores, np_labels)
    np.testing.assert_allclose(float(im10["collection"]["auroc"]), ref_auroc, rtol=1e-5, atol=0,
                               err_msg="macro AUROC differs from the float64 Mann-Whitney reference")
    conf = np_scores.max(1)
    correct = np_scores.argmax(1) == np_labels
    ref_ece, ref_mce = numpy_calibration(conf, correct, coll10["ece"].bin_boundaries.cpu().numpy())
    np.testing.assert_allclose(float(im10["collection"]["ece"]), ref_ece, rtol=1e-5, atol=0,
                               err_msg="ECE differs from the float64 numpy histogram")
    np.testing.assert_allclose(float(im10["collection"]["mce"]), ref_mce, rtol=1e-5, atol=0,
                               err_msg="MCE differs from the float64 numpy histogram")
    c0p, c0t = (x.cpu() for x in coco_batches[0])
    check(c0p.shape[0] == RANKING_REF_ROWS, "the ranking reference's rows")
    np_c0p = c0p.numpy()
    check(all(np.unique(row).size == row.size for row in np_c0p), "COCO's first rows hold tied scores")
    ref_rank = numpy_ranking(np_c0p, c0t.numpy())
    for key, ref in ref_rank.items():
        got = getattr(M.functional, key)(*(x.to(dev) for x in (c0p, c0t)))
        np.testing.assert_allclose(float(got), ref, rtol=1e-5, atol=0,
                                   err_msg=f"COCO {key} on the first {RANKING_REF_ROWS} rows differs from numpy")
    m_np_scores = torch.cat([p for p, _ in marco_binary]).cpu().numpy()
    m_np_target = torch.cat([t for _, t in marco_binary]).cpu().numpy()
    ref_pauc = numpy_partial_auc(m_np_scores, m_np_target, MARCO_MAX_FPR)
    np.testing.assert_allclose(float(marco10["auroc_max_fpr"]), ref_pauc, rtol=1e-5, atol=0,
                               err_msg="MS MARCO partial AUC differs from the float64 numpy McClish reference")
    print(f"slice 10 values: " + json.dumps({
        "imagenet": {k: float(v) for k, v in im10["collection"].items()},
        "imagenet_alone": {k: float(im10[k]) for k in ("hinge", "kl", "kl_log_prob", "dice_score", "auroc_compute_on_cpu")},
        "coco": {k: float(v) for k, v in coco10.items()},
        "marco_auroc_max_fpr": float(marco10["auroc_max_fpr"]), "marco_roc_points": int(marco10["roc"][0].numel()),
        "references": {"macro_auroc_mann_whitney": ref_auroc, "ece": ref_ece, "mce": ref_mce,
                       "marco_partial_auc": ref_pauc, **{f"coco_{k}": v for k, v in ref_rank.items()}}}))
    print(f"slice 10: compute groups {json.dumps(coll10.compute_groups)}; group leaders' state bytes "
          f"{json.dumps(leader_bytes)}; launches {json.dumps(slice10_launches)}, stat_scores by branch and shape "
          f"{json.dumps(by_shape(slice10_stat_by_shape))}; every value equal to the CPU run and the references")
    laps.mark("3. slice 10 references")

    # each module's update (a full batch, fresh metric) and compute (the epoch's, timed above), and the host
    # syncs of one more compute
    p, t = batches[-2]
    q = teacher_batches[-2]
    cp, ct = coco_batches[0]
    mp, mt = marco_binary[0]
    update_fns = {
        "Accuracy": (M.Accuracy(num_classes=NUM_CLASSES, average="macro", device=dev), (p, t)),
        "AUROC": (M.AUROC(num_classes=NUM_CLASSES, device=dev), (p, t)),
        "CalibrationError": (M.CalibrationError(n_bins=ECE_BINS, device=dev), (p, t)),
        "curve collection": (M.MetricCollection(curve_members(M, dev)), (p, t)),
        "ROC": (M.ROC(num_classes=NUM_CLASSES, device=dev), (p, t)),
        "HingeLoss": (M.HingeLoss(device=dev), (torch.log(p), t)),
        "KLDivergence": (M.KLDivergence(device=dev), (q, p)),
        "AUROC(compute_on_cpu=True)": (M.AUROC(num_classes=NUM_CLASSES, compute_on_cpu=True, device=dev), (p, t)),
        "COCO CoverageError": (M.CoverageError(device=dev), (cp, ct)),
        "COCO LabelRankingAveragePrecision": (M.LabelRankingAveragePrecision(device=dev), (cp, ct)),
        "COCO LabelRankingLoss": (M.LabelRankingLoss(device=dev), (cp, ct)),
        "COCO AUROC": (M.AUROC(num_classes=COCO_CLASSES, device=dev), (cp, ct)),
        "MS MARCO AUROC(max_fpr=0.1)": (M.AUROC(pos_label=1, max_fpr=MARCO_MAX_FPR, device=dev), (mp, mt)),
    }
    slice10_update_ms = {k: host_ms(torch, lambda m=m, a=a: m.update(*a), reps=10) for k, (m, a) in update_fns.items()}
    slice10_update_syncs = {k: one_call_syncs(torch, lambda m=m, a=a: m.update(*a))[0] for k, (m, a) in update_fns.items()}
    compute_ms = {**{f"ImageNet {k}": s * 1e3 for k, s in im10_compute_s.items()},
                  **{f"COCO {k}": s * 1e3 for k, s in coco10_compute_s.items()},
                  **{f"MS MARCO {k}": s * 1e3 for k, s in marco10_compute_s.items()}}
    cpu_compute_ms = {**{f"ImageNet {k}": s * 1e3 for k, s in c_im10_compute_s.items()},
                      **{f"COCO {k}": s * 1e3 for k, s in c_coco10_compute_s.items()},
                      **{f"MS MARCO {k}": s * 1e3 for k, s in c_marco10_compute_s.items()}}
    # the compute_on_cpu AUROC computes on CPU tensors (9 s): no device sync to count there
    on_card = [(f"ImageNet {k}", coll10[k]) for k in coll10.keys()]
    on_card += [(f"ImageNet {k}", m) for k, m in alone10.items() if k != "auroc_compute_on_cpu"]
    on_card += [(f"COCO {k}", m) for k, m in coco_mods.items()] + [(f"MS MARCO {k}", m) for k, m in marco_mods.items()]
    # the host syncs of one more compute each (the epoch's compute above is each member's timed call)
    compute_syncs, sync_sites = {}, {}
    for key, m in on_card:
        compute_syncs[key], sites = one_call_syncs(torch, m._compute_impl)
        if sites:
            sync_sites[key] = sites
    # one AUROC compute under the profiler (no warm-up step: a compute records ~50,000 device activities)
    events, wall_us, _ = profiled(torch, coll10["auroc"]._compute_impl, 1, warmup=False)
    auroc_busy = {"wall_ms": wall_us / 1e3, "device_ms": sum(us for _, us in events) / 1e3,
                  "busy_share": sum(us for _, us in events) / wall_us, "activities": len(events)}
    print("slice 10 update ms at a full batch (median of 10): " + json.dumps(slice10_update_ms))
    print("slice 10 host syncs an update: " + json.dumps(slice10_update_syncs))
    print(f"slice 10 epoch updates: ImageNet (collection and five standalone modules) {im10_update_s * 1e3:.1f} ms on "
          f"the card, {c_im10_update_s * 1e3:.1f} ms on the CPU for its first {head} batches; COCO {coco10_update_s * 1e3:.1f} ms; MS MARCO "
          f"{marco10_update_s * 1e3:.1f} ms")
    print("slice 10 compute ms on the card (the epoch's compute, one call): " + json.dumps(compute_ms))
    print(f"slice 10 compute ms on the CPU (plain versions), the first {head} batches: " + json.dumps(cpu_compute_ms))
    print("slice 10 host syncs a compute (on the card): " + json.dumps(compute_syncs))
    print(f"slice 10 compute syncs by the port's line (the first {SYNC_SITES_SAMPLED}): " + json.dumps(sync_sites))
    print("ImageNet AUROC compute under torch.profiler: " + json.dumps(auroc_busy))
    laps.mark("3. slice 10 timings")

    return slice10_launches, slice10_stat_by_shape


def slice11_data(torch, dev):
    """Every slice-11 dataset at its published size, made on ``dev`` from one seeded generator."""
    g = torch.Generator(device=dev).manual_seed(SEED + 11)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=dev)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def unit(x):
        return x / torch.linalg.norm(x, dim=-1, keepdim=True)

    lo, hi = NYU_DEPTH_M
    pixels = NYU_H * NYU_W
    depth_t = lo + (hi - lo) * rand(NYU_IMAGES, pixels)
    depth_p = depth_t * torch.exp(NYU_LOG_NOISE * randn(NYU_IMAGES, pixels))
    normals_t = unit(randn(NYU_IMAGES, pixels, 3))
    normals_p = unit(normals_t + NYU_NORMAL_NOISE * randn(NYU_IMAGES, pixels, 3))
    gold = torch.randint(0, STSB_LEVELS, (STSB_PAIRS,), generator=g, device=dev).float() * 0.2
    agree = (gold / 5 + STSB_NOISE * randn(STSB_PAIRS)).clamp(0, 1)
    emb_a = randn(STSB_PAIRS, EMBED_DIM)
    emb_b = agree[:, None] * emb_a + torch.sqrt(1 - agree * agree)[:, None] * randn(STSB_PAIRS, EMBED_DIM)
    # the model's score of each pair: its embeddings' cosine, computed once so that every run ranks the same bits
    similarity = (emb_a * emb_b).sum(1) / (torch.linalg.norm(emb_a, dim=1) * torch.linalg.norm(emb_b, dim=1))
    mos = 1 + 4 * rand(KONIQ_IMAGES)
    koniq_pred = (torch.round((mos + KONIQ_NOISE * randn(KONIQ_IMAGES)) * 256) / 256).clamp(1, 5)
    m4 = {}
    for name, (series, horizon) in M4_HORIZONS.items():
        level = torch.exp(math.log(10.0) + math.log(1000.0) * rand(series, 1))
        steps = torch.arange(horizon, device=dev, dtype=torch.float32)
        season = 0.1 * torch.sin(0.7 * steps + 2 * math.pi * rand(series, 1))
        target = level * (1 + season + 0.03 * randn(series, horizon))
        m4[name] = (target * torch.exp(M4_NOISE * randn(series, horizon)), target)
    exposure = 0.05 + 0.95 * rand(FREMTPL_POLICIES)
    rate = exposure * FREMTPL_RATE * torch.exp(0.5 * randn(FREMTPL_POLICIES))
    claims = torch.poisson(rate, generator=g)
    frequency = (rate * torch.exp(0.3 * randn(FREMTPL_POLICIES)), claims)
    severity = (torch.exp(7.5 + 0.6 * randn(FREMTPL_CLAIMS)), torch.exp(7.5 + 1.2 * randn(FREMTPL_CLAIMS)))
    return {
        "depth": (depth_p, depth_t), "normals": (normals_p, normals_t), "stsb": (emb_a, emb_b, similarity, gold),
        "koniq": (koniq_pred, mos), "m4": m4, "frequency": frequency, "severity": severity,
        "dense": (randn(DENSE_QUERIES, EMBED_DIM), randn(DENSE_PASSAGES, EMBED_DIM)),
    }


def depth_members(M, device, **kwargs):
    """Slice 11's NYU-Depth v2 collection; its keys are those of ``tests/test_torch_collections.py``, which
    holds the port's compute groups equal to the JAX package's."""
    return {
        "mse": M.MeanSquaredError(device=device, **kwargs),
        "rmse": M.MeanSquaredError(squared=False, device=device, **kwargs),
        "mae": M.MeanAbsoluteError(device=device, **kwargs),
        "msle": M.MeanSquaredLogError(device=device, **kwargs),
        "abs_rel": M.MeanAbsolutePercentageError(device=device, **kwargs),
        "r2": M.R2Score(device=device, **kwargs),
        "explained_variance": M.ExplainedVariance(device=device, **kwargs),
    }


def depth_collection(M, device, mode):
    """The depth collection as ``mode`` runs it: ``eager`` (the eager loop), ``fused`` (one graph an update)
    or ``engine`` (the eager loop over members with ``jit_update=True``)."""
    return M.MetricCollection(depth_members(M, device, **({"jit_update": True} if mode == "engine" else {})),
                              prefix="depth_", fused_update=mode == "fused")


def normals_modules(M, device):
    return {"r2_variance_weighted": M.R2Score(num_outputs=3, multioutput="variance_weighted", device=device),
            "explained_variance_raw": M.ExplainedVariance(multioutput="raw_values", device=device)}


def stsb_scores(M, device):
    return {"pearson": M.PearsonCorrCoef(device=device), "spearman": M.SpearmanCorrCoef(device=device),
            "spearman_compute_on_cpu": M.SpearmanCorrCoef(compute_on_cpu=True, device=device)}


def slice11_counts(mods):
    """Every integer state of the slice's modules, as ``("path module.state", tensor)`` in a fixed order."""
    out = []
    for path, modules in mods.items():
        for name, m in modules.items():
            members = m.items(keep_base=True) if hasattr(m, "compute_groups") else [(name, m)]
            for key, member in members:
                out += [(f"{path} {key}.{s}", getattr(member, s)) for s in member._defaults
                        if not isinstance(getattr(member, s), list) and not getattr(member, s).is_floating_point()]
    return out


def run_slice11_paths(torch, M, device, data, images=None, modes=("eager", "fused", "engine")):
    """Slice 11's module paths on ``device`` (``data`` lying there), NYU-Depth v2 on its first ``images``
    images (all by default) in each of ``modes``: the modules by path, their values, and each path's update
    and compute seconds."""
    mods, values, update_s, compute_s = {}, {}, {}, {}

    def path(name, *parts):
        """``parts``: ``(modules, pairs)`` each, run one after the other; their results together under ``name``."""
        mods[name], values[name], update_s[name], compute_s[name] = {}, {}, 0.0, {}
        for modules, pairs in parts:
            m, v, u, c = run_modules(torch, modules, device, pairs)
            mods[name].update(m)
            values[name].update(v)
            update_s[name] += u
            compute_s[name].update(c)

    depth_pairs = list(zip(*(x[:images] for x in data["depth"])))
    for mode in modes:
        path(f"depth_{mode}", ({"collection": depth_collection(M, device, mode)}, depth_pairs))
    path("normals", (normals_modules(M, device), list(zip(*(x[:images] for x in data["normals"])))))
    emb_a, emb_b, similarity, gold = data["stsb"]
    batches = [slice(i, i + STSB_BATCH) for i in range(0, STSB_PAIRS, STSB_BATCH)]
    path("stsb", (stsb_scores(M, device), [(similarity[b], gold[b]) for b in batches]),
         ({"cosine_mean": M.CosineSimilarity(reduction="mean", device=device)},
          [(emb_a[b], emb_b[b]) for b in batches]))
    pred, mos = data["koniq"]
    koniq_pairs = [(pred[i:i + KONIQ_BATCH], mos[i:i + KONIQ_BATCH]) for i in range(0, KONIQ_IMAGES, KONIQ_BATCH)]
    path("koniq", ({"plcc": M.PearsonCorrCoef(device=device), "srocc": M.SpearmanCorrCoef(device=device)}, koniq_pairs))
    # Pearson in four contiguous quarters, their states stacked in rank order as a sync's gather stacks them
    bounds = [round(k * KONIQ_IMAGES / KONIQ_QUARTERS) for k in range(KONIQ_QUARTERS + 1)]
    quarters = [M.PearsonCorrCoef(device=device) for _ in range(KONIQ_QUARTERS)]
    for q, (a, b) in zip(quarters, zip(bounds, bounds[1:])):
        for i in range(a, b, KONIQ_BATCH):
            q.update(pred[i:min(i + KONIQ_BATCH, b)], mos[i:min(i + KONIQ_BATCH, b)])
    merged = M.PearsonCorrCoef(device=device)
    values["koniq"]["plcc_quarters_merged"] = merged.pure_compute(
        {key: torch.stack([getattr(q, key) for q in quarters]) for key in merged._defaults})
    path("m4", ({"smape": M.SymmetricMeanAbsolutePercentageError(device=device),
                 "mape": M.MeanAbsolutePercentageError(device=device),
                 "wmape": M.WeightedMeanAbsolutePercentageError(device=device)}, list(data["m4"].values())))
    freq_p, freq_t = data["frequency"]
    freq_pairs = [(freq_p[i:i + FREMTPL_BATCH], freq_t[i:i + FREMTPL_BATCH])
                  for i in range(0, FREMTPL_POLICIES, FREMTPL_BATCH)]
    for jit in (False, True):
        path(f"fremtpl_{'engine' if jit else 'eager'}",
             ({"frequency_p1": M.TweedieDevianceScore(power=1, jit_update=jit, device=device)}, freq_pairs),
             ({"severity_p2": M.TweedieDevianceScore(power=2, jit_update=jit, device=device),
               "severity_p1.5": M.TweedieDevianceScore(power=1.5, jit_update=jit, device=device)}, [data["severity"]]))
    return mods, values, update_s, compute_s


def numpy_depth(preds, target):
    """The closed forms of the depth collection's seven values in float64, summed image by image (each
    image's pair of tensors moved to the host in turn)."""
    s = dict.fromkeys(("e", "ee", "t", "tt", "ae", "l", "ape"), 0.0)
    for p, t in zip(preds, target):
        p, t = p.cpu().numpy().astype(np.float64), t.cpu().numpy().astype(np.float64)
        e = t - p
        s["e"] += e.sum()
        s["ee"] += e @ e
        s["t"] += t.sum()
        s["tt"] += t @ t
        s["ae"] += np.abs(e).sum()
        s["l"] += ((np.log1p(p) - np.log1p(t)) ** 2).sum()
        s["ape"] += (np.abs(e) / np.abs(t)).sum()
    n = preds.numel()
    mse = s["ee"] / n
    return {"mse": mse, "rmse": math.sqrt(mse), "mae": s["ae"] / n, "msle": s["l"] / n, "abs_rel": s["ape"] / n,
            "r2": 1 - s["ee"] / (s["tt"] - s["t"] ** 2 / n),
            "explained_variance": 1 - (mse - (s["e"] / n) ** 2) / (s["tt"] / n - (s["t"] / n) ** 2)}


def numpy_normals(preds, target):
    """R2 (variance weighted) and explained variance (per column) of the normals in float64."""
    s = {k: np.zeros(3) for k in ("e", "ee", "t", "tt")}
    for p, t in zip(preds, target):
        # (3, pixels), each column's values contiguous
        p, t = (np.ascontiguousarray(x.cpu().numpy().T, dtype=np.float64) for x in (p, t))
        e = t - p
        s["e"] += e.sum(1)
        s["ee"] += np.einsum("ij,ij->i", e, e)
        s["t"] += t.sum(1)
        s["tt"] += np.einsum("ij,ij->i", t, t)
    n = preds.shape[0] * preds.shape[1]
    tss = s["tt"] - s["t"] ** 2 / n
    r2 = 1 - s["ee"] / tss
    ev = 1 - (s["ee"] / n - (s["e"] / n) ** 2) / (s["tt"] / n - (s["t"] / n) ** 2)
    return {"r2_variance_weighted": float((tss / tss.sum() * r2).sum()), "explained_variance_raw": ev}


def numpy_tweedie(preds, target, power):
    """The mean Tweedie deviance in float64."""
    p, t = preds.astype(np.float64), target.astype(np.float64)
    if power == 1:
        d = 2 * (np.where(t > 0, t * np.log(np.where(t > 0, t, 1) / p), 0.0) + p - t)
    elif power == 2:
        d = 2 * (np.log(p / t) + t / p - 1)
    else:
        d = 2 * (np.maximum(t, 0) ** (2 - power) / ((1 - power) * (2 - power)) - t * p ** (1 - power) / (1 - power)
                 + p ** (2 - power) / (2 - power))
    return float(d.mean())


def numpy_pairwise(fn, x, y):
    """``fn``'s float64 formula (see ``tests/test_torch_pairwise.py``)."""
    x, y = x.astype(np.float64), y.astype(np.float64)
    if fn == "cosine":
        return (x / np.linalg.norm(x, axis=1, keepdims=True)) @ (y / np.linalg.norm(y, axis=1, keepdims=True)).T
    if fn == "euclidean":
        return np.sqrt(np.maximum((x * x).sum(1)[:, None] + (y * y).sum(1)[None] - 2 * x @ y.T, 0))
    if fn == "linear":
        return x @ y.T
    return np.concatenate([np.abs(x[i:i + 4, None, :] - y[None]).sum(-1) for i in range(0, x.shape[0], 4)])


def pairwise_bound(fn, x, y, ref):
    """The absolute bound of two float32 evaluations of ``fn`` (``tests/test_torch_pairwise.py``), with
    1e-6 on top: a dot product's ``D 2**-23 |x| |y|`` (of unit rows for cosine), euclidean's square root
    of ``(D + 2) 2**-22 (|x|^2 + |y|^2)``, and manhattan's ``D 2**-23`` of its value ``ref`` (a sum of
    non-negative terms)."""
    d = x.shape[1]
    nx = np.linalg.norm(x.astype(np.float64), axis=1)[:, None]
    ny = np.linalg.norm(y.astype(np.float64), axis=1)[None]
    if fn in ("linear", "cosine"):
        return d * 2.0**-23 * (nx * ny if fn == "linear" else 1.0) + 1e-6
    if fn == "euclidean":
        return np.sqrt((d + 2) * 2.0**-22 * (nx**2 + ny**2)) + 1e-6
    return d * 2.0**-23 * np.abs(ref) + 1e-6


def run_slice11_dense(torch, M, dev, queries, passages):
    """MS MARCO dense scoring on ``dev``: the first ``DENSE_REF_ROWS`` rows of every matrix, the mean
    reductions, and each call's seconds; the checks that need the whole matrix run here."""
    calls = {name: getattr(M.functional, fn) for name, fn in PAIRWISE.items() if name != "manhattan"}
    rows, means, seconds = {}, {}, {}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def timed(key, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        seconds[key] = time.perf_counter() - t0
        return out

    for name, fn in calls.items():
        check(not torch.backends.cuda.matmul.allow_tf32, f"TF32 is on before pairwise {name}")
        full = timed(f"{name} ({queries.shape[0]}, {passages.shape[0]})", lambda: fn(queries, passages))
        mean = timed(f"{name} mean", lambda: fn(queries, passages, reduction="mean"))
        check(not torch.backends.cuda.matmul.allow_tf32, f"pairwise {name} turned TF32 on")
        check(full.shape == (queries.shape[0], passages.shape[0]) and bool(torch.isfinite(full).all()),
              f"pairwise {name} is not a finite (Q, P) matrix")
        check(torch.equal(mean, full.mean(-1)), f"pairwise {name}'s mean reduction is not its matrix's row mean")
        rows[name], means[name] = full[:DENSE_REF_ROWS], mean
        del full
        own = timed(f"{name} self ({queries.shape[0]}, {queries.shape[0]})", lambda: fn(queries))
        check(torch.equal(torch.diagonal(own), torch.zeros(queries.shape[0], device=dev)),
              f"pairwise {name} of the queries alone does not zero its diagonal")
        rows[f"{name}_self"] = own[:DENSE_REF_ROWS]
        del own
    mq, mp, _ = MANHATTAN_SHAPE
    full = timed(f"manhattan {MANHATTAN_SHAPE}",
                 lambda: M.functional.pairwise_manhattan_distance(queries[:mq], passages[:mp]))
    check(bool(torch.isfinite(full).all()), "pairwise manhattan is not finite")
    rows["manhattan"], means["manhattan"] = full[:DENSE_REF_ROWS], full.mean(-1)
    return rows, means, seconds


def run_slice11(torch, dev, laps):
    """Slice 11 (see the module's docstring): returns the kernels' launches on its path (all 0)."""
    import metrics_tpu_torch as M
    from metrics_tpu_torch.functional.regression.spearman import _rank_data
    from metrics_tpu_torch.ops import launches, reset_launches
    from scipy.stats import pearsonr, spearmanr

    cpu = torch.device("cpu")
    data = slice11_data(torch, dev)
    torch.cuda.synchronize()
    laps.mark("3. slice 11 data")
    reset_launches()
    mods, values, update_s, compute_s = run_slice11_paths(torch, M, dev, data)
    rows, means, dense_s = run_slice11_dense(torch, M, dev, *data["dense"])
    slice11_launches = launches()
    check(all(n == 0 for n in slice11_launches.values()), f"slice 11 launched a kernel: {slice11_launches}")
    groups = mods["depth_eager"]["collection"].compute_groups
    check(groups == DEPTH_GROUPS, f"the depth collection formed the groups {groups}, not the JAX package's "
          f"{DEPTH_GROUPS}")
    for mode in ("fused", "engine"):
        got, want = values[f"depth_{mode}"]["collection"], values["depth_eager"]["collection"]
        check(list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want),
              f"the depth collection's {mode} values are not the eager loop's bits")
        members = mods[f"depth_{mode}"]["collection"]
        for key, m in members.items(keep_base=True):
            e = mods["depth_eager"]["collection"][key]
            check(all(torch.equal(getattr(m, s), getattr(e, s)) for s in m._defaults),
                  f"the depth collection's {mode} state of {key} is not the eager loop's")
    fused_stats = mods["depth_fused"]["collection"].dispatch_stats
    check(fused_stats["dispatches"] == NYU_IMAGES and fused_stats["retraces"] == 1 and fused_stats["demotions"] == 0,
          f"the fused depth collection's dispatch stats {fused_stats}")
    for key, m in mods["depth_engine"]["collection"].items(keep_base=True):
        stats = m.dispatch_stats
        check(stats["demotions"] == 0 and stats["retraces"] <= 1, f"depth {key}'s engine stats {stats}")
    for key in mods["fremtpl_engine"]:
        e, j = mods["fremtpl_eager"][key], mods["fremtpl_engine"][key]
        check(all(torch.equal(getattr(e, s), getattr(j, s)) for s in e._defaults),
              f"freMTPL2 {key}: the engine's states are not the eager update's")
        check(j.dispatch_stats["demotions"] == 0, f"freMTPL2 {key}'s engine demoted: {j.dispatch_stats}")
    moved = mods["stsb"]["spearman_compute_on_cpu"]
    check(all(v.device.type == "cpu" for v in moved.preds + moved.target) and
          values["stsb"]["spearman_compute_on_cpu"].device.type == "cpu",
          "SpearmanCorrCoef(compute_on_cpu=True) holds or computes off the CPU")
    torch.testing.assert_close(values["stsb"]["spearman_compute_on_cpu"], values["stsb"]["spearman"].cpu(), rtol=1e-6,
                               atol=0, msg="SpearmanCorrCoef(compute_on_cpu=True) differs from the one on the card")
    merged, single = values["koniq"]["plcc_quarters_merged"], values["koniq"]["plcc"]
    # float32 moments merged from four quarters against one stream over all rows: rtol 1e-5
    torch.testing.assert_close(merged, single, rtol=1e-5, atol=0,
                               msg="KonIQ's Pearson merged from four quarters differs from the single instance")
    laps.mark("3. slice 11 on the card")

    # the CPU reruns NYU-Depth v2 on its first NYU_CPU_IMAGES images, held against the card on the same images
    nyu_head = {k: tuple(x[:NYU_CPU_IMAGES] for x in data[k]) for k in ("depth", "normals")}
    cpu_data = {k: ({n: tuple(x.cpu() for x in v) for n, v in d.items()} if isinstance(d, dict)
                    else tuple(x.cpu() for x in d)) for k, d in {**data, **nyu_head}.items() if k != "dense"}
    c_mods, c_values, c_update_s, c_compute_s = run_slice11_paths(torch, M, cpu, cpu_data, modes=("eager",))
    h_mods, h_values, _, _ = run_slice11_paths(torch, M, dev, data, images=NYU_CPU_IMAGES, modes=("eager",))
    queries, passages = (x.cpu() for x in data["dense"])
    mq, mp, _ = MANHATTAN_SHAPE
    head = queries[:DENSE_REF_ROWS]
    c_rows = {name: getattr(M.functional, fn)(head, passages[:mp] if name == "manhattan" else passages)
              for name, fn in PAIRWISE.items()}
    for name in ("cosine", "euclidean", "linear"):
        # the first rows of the queries against themselves: the diagonal zeroed as zero_diagonal does
        c_rows[f"{name}_self"] = getattr(M.functional, PAIRWISE[name])(head, queries, zero_diagonal=True)
    laps.mark("3. slice 11 on the CPU")

    def close(got, want, what, rtol=1e-6):
        check(bool(torch.isfinite(got).all()), f"{what} is not finite: {got}")
        torch.testing.assert_close(got.cpu(), want, rtol=rtol, atol=0, msg=f"{what} differs from the CPU run")

    for key, got in h_values["depth_eager"]["collection"].items():
        close(got, c_values["depth_eager"]["collection"][key], f"NYU-Depth {key} (first {NYU_CPU_IMAGES} images)")
    for key, got in h_values["normals"].items():
        close(got, c_values["normals"][key], f"NYU-Depth normals {key} (first {NYU_CPU_IMAGES} images)")
    for path in ("stsb", "koniq", "m4", "fremtpl_eager"):
        for key, got in values[path].items():
            close(got, c_values[path][key], f"{path} {key}")
    counts = slice11_counts({k: (h_mods if k in ("depth_eager", "normals") else mods)[k] for k in c_mods})
    for (key, got), (c_key, want) in zip(counts, slice11_counts(c_mods)):
        check(key == c_key and got.dtype == want.dtype and torch.equal(got.cpu(), want), f"{key}: the count differs")
    for what, x in (("STS-B similarity", data["stsb"][2]), ("STS-B gold", data["stsb"][3]),
                    ("KonIQ prediction", data["koniq"][0]), ("KonIQ MOS", data["koniq"][1])):
        check(torch.equal(_rank_data(x).cpu(), _rank_data(x.cpu())),
              f"{what}: the ranks on the card differ from the CPU's")
    dense_err = {}
    for name, got in rows.items():
        fn = name.replace("_self", "")
        x = head.numpy()
        y = (queries if name.endswith("_self") else passages[:mp] if name == "manhattan" else passages).numpy()
        ref = numpy_pairwise(fn, x, y)
        if name.endswith("_self"):
            np.fill_diagonal(ref, 0.0)  # the first rows' diagonal: (i, i) for i < DENSE_REF_ROWS
        bound = pairwise_bound(fn, x, y, ref)
        g64 = got.cpu().numpy().astype(np.float64)
        dense_err[name] = float(np.max(np.abs(g64 - ref) / bound))
        check(bool(np.all(np.abs(g64 - ref) <= bound)), f"MS MARCO {name}: the first rows exceed the float32 bound "
              "against float64 numpy")
        check(bool(np.all(np.abs(g64 - c_rows[name].numpy()) <= 2 * bound)),
              f"MS MARCO {name}: the first rows differ from the CPU run beyond twice the float32 bound")
    laps.mark("3. slice 11 CPU comparison")

    # independent float64 references (rtol 1e-5: float32 sums of up to 2e8 terms; Tweedie 1e-4, see below)
    refs = {"depth": numpy_depth(*data["depth"]), "normals": numpy_normals(*data["normals"])}
    for key, ref in refs["depth"].items():
        np.testing.assert_allclose(float(values["depth_eager"]["collection"][f"depth_{key}"]), ref, rtol=1e-5, atol=0,
                                   err_msg=f"NYU-Depth {key} differs from its float64 closed form")
    np.testing.assert_allclose(float(values["normals"]["r2_variance_weighted"]),
                               refs["normals"]["r2_variance_weighted"],
                               rtol=1e-5, atol=0, err_msg="the normals' R2 differs from its float64 closed form")
    np.testing.assert_allclose(values["normals"]["explained_variance_raw"].cpu().numpy(),
                               refs["normals"]["explained_variance_raw"], rtol=1e-5, atol=0,
                               err_msg="the normals' explained variance differs from its float64 closed form")
    sim, gold = cpu_data["stsb"][2].numpy(), cpu_data["stsb"][3].numpy()
    a64, b64 = (x.numpy().astype(np.float64) for x in cpu_data["stsb"][:2])
    refs["stsb"] = {"pearson": float(pearsonr(sim, gold)[0]), "spearman": float(spearmanr(sim, gold)[0]),
                    "cosine_mean": float(((a64 * b64).sum(1) / np.linalg.norm(a64, axis=1)
                                          / np.linalg.norm(b64, axis=1)).mean())}
    refs["stsb"]["spearman_compute_on_cpu"] = refs["stsb"]["spearman"]
    kp, km = (x.numpy() for x in cpu_data["koniq"])
    refs["koniq"] = {"plcc": float(pearsonr(kp, km)[0]), "srocc": float(spearmanr(kp, km)[0])}
    refs["koniq"]["plcc_quarters_merged"] = refs["koniq"]["plcc"]
    for path in ("stsb", "koniq"):
        for key, ref in refs[path].items():
            np.testing.assert_allclose(float(values[path][key]), ref, rtol=1e-5, atol=0,
                                       err_msg=f"{path} {key} differs from scipy in float64")
    m4p = np.concatenate([p.numpy().ravel() for p, _ in cpu_data["m4"].values()]).astype(np.float64)
    m4t = np.concatenate([t.numpy().ravel() for _, t in cpu_data["m4"].values()]).astype(np.float64)
    check(m4p.size == M4_POINTS, f"M4 holds {m4p.size} test points, not {M4_POINTS}")
    refs["m4"] = {"smape": float((2 * np.abs(m4p - m4t) / (np.abs(m4t) + np.abs(m4p))).mean()),
                  "mape": float((np.abs(m4p - m4t) / np.abs(m4t)).mean()),
                  "wmape": float(np.abs(m4p - m4t).sum() / np.abs(m4t).sum())}
    fp, ft = (x.numpy() for x in cpu_data["frequency"])
    sp, st = (x.numpy() for x in cpu_data["severity"])
    refs["fremtpl"] = {"frequency_p1": numpy_tweedie(fp, ft, 1), "severity_p2": numpy_tweedie(sp, st, 2),
                       "severity_p1.5": numpy_tweedie(sp, st, 1.5)}
    for key, ref in refs["m4"].items():
        np.testing.assert_allclose(float(values["m4"][key]), ref, rtol=1e-5, atol=0,
                                   err_msg=f"M4 {key} differs from its float64 closed form")
    # each deviance term cancels in float32 where the prediction is near the target: rtol 1e-4
    for key, ref in refs["fremtpl"].items():
        np.testing.assert_allclose(float(values["fremtpl_eager"][key]), ref, rtol=1e-4, atol=0,
                                   err_msg=f"freMTPL2 {key} differs from its float64 closed form")
    zero_share = float((ft == 0).mean())
    laps.mark("3. slice 11 references")

    def plain(v):
        return v.cpu().tolist() if v.numel() > 1 else float(v)

    print("slice 11 values: " + json.dumps({
        **{path: {k: plain(v) for k, v in values[path].items()}
           for path in ("normals", "stsb", "koniq", "m4", "fremtpl_eager")},
        "depth": {k: plain(v) for k, v in values["depth_eager"]["collection"].items()},
        "marco_dense_mean_of_row_means": {k: float(v.mean()) for k, v in means.items()},
        "fremtpl_zero_claim_share": zero_share,
        "references": {k: {n: (x.tolist() if isinstance(x, np.ndarray) else x) for n, x in r.items()}
                       for k, r in refs.items()}}))
    print(f"slice 11: compute groups {json.dumps(groups)}; launches {json.dumps(slice11_launches)}; "
          f"MS MARCO first {DENSE_REF_ROWS} rows' largest error over the float32 bound {json.dumps(dense_err)}; "
          "every value equal to the CPU run and the references, the engine and fused paths bit-equal to eager")
    laps.mark("3. slice 11 values")

    # timings: an update (eager, engine, fused) in turns, its syncs, a compute's syncs, busy shares
    p, t = data["depth"][0][1], data["depth"][1][1]
    depth_colls = {mode: depth_collection(M, dev, mode) for mode in ("eager", "fused", "engine")}
    for c in depth_colls.values():
        c.update(p, t)  # groups formed, programs captured
    depth_update_ms = host_ms_in_turns(torch, {mode: (lambda c=c: c.update(p, t)) for mode, c in depth_colls.items()})
    fp_b, ft_b = data["frequency"][0][:FREMTPL_BATCH], data["frequency"][1][:FREMTPL_BATCH]
    tw = {jit: M.TweedieDevianceScore(power=1, jit_update=jit, device=dev) for jit in (False, True)}
    tweedie_update_ms = host_ms_in_turns(torch, {("engine" if jit else "eager"): (lambda m=m: m.update(fp_b, ft_b))
                                                 for jit, m in tw.items()})
    single = {
        "normals R2Score": (normals_modules(M, dev)["r2_variance_weighted"],
                            (data["normals"][0][1], data["normals"][1][1])),
        "normals ExplainedVariance": (normals_modules(M, dev)["explained_variance_raw"],
                                      (data["normals"][0][1], data["normals"][1][1])),
        "STS-B PearsonCorrCoef": (M.PearsonCorrCoef(device=dev), tuple(x[:STSB_BATCH] for x in data["stsb"][2:])),
        "STS-B SpearmanCorrCoef": (M.SpearmanCorrCoef(device=dev), tuple(x[:STSB_BATCH] for x in data["stsb"][2:])),
        "STS-B CosineSimilarity": (M.CosineSimilarity(device=dev), (data["stsb"][0][:STSB_BATCH],
                                                                    data["stsb"][1][:STSB_BATCH])),
        "M4 SMAPE (monthly)": (M.SymmetricMeanAbsolutePercentageError(device=dev), data["m4"]["monthly"]),
        "freMTPL2 Tweedie p=2 (severity)": (M.TweedieDevianceScore(power=2, device=dev), data["severity"]),
    }
    update_ms = {k: host_ms(torch, lambda m=m, a=a: m.update(*a), reps=10) for k, (m, a) in single.items()}
    update_syncs = {f"depth {mode}": one_call_syncs(torch, lambda c=c: c.update(p, t))[0]
                    for mode, c in depth_colls.items()}
    update_syncs.update({f"freMTPL2 Tweedie p=1 {'engine' if jit else 'eager'}":
                         one_call_syncs(torch, lambda m=m: m.update(fp_b, ft_b))[0] for jit, m in tw.items()})
    update_syncs.update({k: one_call_syncs(torch, lambda m=m, a=a: m.update(*a))[0] for k, (m, a) in single.items()})
    engine_syncs = {k: n for k, n in update_syncs.items() if k.endswith(("fused", "engine")) and n}
    check(not engine_syncs, f"a warm engine update synchronised with the host: {engine_syncs}")
    compute_syncs, warm_compute_ms = {}, {}
    on_card = [(f"depth {k}", m) for k, m in mods["depth_eager"]["collection"].items(keep_base=True)]
    on_card += [(f"{path} {k}", m) for path in ("normals", "koniq", "m4", "fremtpl_eager")
                for k, m in mods[path].items()]
    on_card += [(f"stsb {k}", m) for k, m in mods["stsb"].items() if k != "spearman_compute_on_cpu"]
    for key, m in on_card:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m._compute_impl()
        torch.cuda.synchronize()
        warm_compute_ms[key] = (time.perf_counter() - t0) * 1e3
        compute_syncs[key] = one_call_syncs(torch, m._compute_impl)[0]
    busy = {f"depth {mode}": device_busy(torch, lambda c=c: c.update(p, t)) for mode, c in depth_colls.items()}
    print("slice 11 depth collection update ms an image (median of 25, in turns): " + json.dumps(depth_update_ms))
    print("slice 11 freMTPL2 Tweedie p=1 update ms a batch of 65,536 (median of 25, in turns): "
          + json.dumps(tweedie_update_ms))
    print("slice 11 update ms (median of 10): " + json.dumps(update_ms))
    print("slice 11 host syncs an update: " + json.dumps(update_syncs))
    print("slice 11 epoch update ms on the card: " + json.dumps({k: s * 1e3 for k, s in update_s.items()}))
    print("slice 11 epoch update ms on the CPU: " + json.dumps({k: s * 1e3 for k, s in c_update_s.items()}))
    print("slice 11 compute ms on the card (the epoch's compute): "
          + json.dumps({f"{p_} {k}": s * 1e3 for p_, d in compute_s.items() for k, s in d.items()}))
    print("slice 11 compute ms on the card, a module's own compute again: " + json.dumps(warm_compute_ms))
    print("slice 11 host syncs a compute: " + json.dumps(compute_syncs))
    print("slice 11 MS MARCO dense calls ms: " + json.dumps({k: s * 1e3 for k, s in dense_s.items()}))
    print("slice 11 depth update under torch.profiler: " + json.dumps(busy))
    laps.mark("3. slice 11 timings")
    return slice11_launches


def bits(torch, x):
    """``x`` as integers of its width, so that ``torch.equal`` compares bit for bit (NaN included)."""
    if not x.is_floating_point():
        return x
    return x.contiguous().view({2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()])


def same_bits(torch, a, b):
    """Two tensors, or two metrics' states, equal bit for bit (on one device)."""
    if hasattr(a, "_defaults"):
        return all(same_bits(torch, getattr(a, k), getattr(b, k)) for k in a._defaults)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(bits(torch, a), bits(torch, b.to(a.device)))


@contextlib.contextmanager
def kept_graphs(torch):
    """Every ``torch.cuda.CUDAGraph`` made in the block keeps its ``cudaGraph_t`` after the capture
    (``keep_graph=True``; the graph is instantiated at its first replay), for :func:`graph_nodes`."""
    base = torch.cuda.CUDAGraph

    class Kept(base):
        def __new__(cls, keep_graph=False):
            return super().__new__(cls, True)

        def __init__(self, keep_graph=False):
            super().__init__(True)

    torch.cuda.CUDAGraph = Kept
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = base


def graph_node_list(graph):
    """The nodes of a graph kept by :func:`kept_graphs` (or made with ``keep_graph=True``), as ``(type, name)``
    pairs read through the CUDA driver API: a kernel node's name is its function's (mangled) name, any other
    node's is None."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.cuGraphKernelNodeGetParams_v2.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.cuFuncGetName.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p]
    lib.cuKernelGetName.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p]
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(lib.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    check(lib.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0, "cuGraphGetNodes failed")
    types = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty"}
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(lib.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0, "cuGraphNodeGetType failed")
        name = None
        if kind.value == 0:
            # CUDA_KERNEL_NODE_PARAMS_v2: the CUfunction at byte 0, the CUkernel (set where func is not) at 56
            params = (ctypes.c_byte * 128)()
            check(lib.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params) == 0,
                  "cuGraphKernelNodeGetParams failed")
            func, kern = (ctypes.c_void_p.from_buffer(params, at).value for at in (0, 56))
            got = ctypes.c_char_p()
            err = lib.cuFuncGetName(ctypes.byref(got), ctypes.c_void_p(func)) if func else \
                lib.cuKernelGetName(ctypes.byref(got), ctypes.c_void_p(kern))
            check(err == 0 and got.value, f"the name of a kernel node could not be read: error {err}")
            name = got.value.decode()
        out.append((types.get(kind.value, str(kind.value)), name))
    return out


def graph_nodes(graph):
    """The nodes of a graph kept by :func:`kept_graphs`, by type, read through the CUDA driver API."""
    out = {}
    for kind, _ in graph_node_list(graph):
        out[kind] = out.get(kind, 0) + 1
    return out


def graph_launches(torch, fn, calls=3):
    """What ``calls`` calls of ``fn`` hand the card, read from one CUDA graph they are captured into (after an
    eager call): the graph's nodes as :func:`graph_node_list` gives them, and the wrapper launches the capture
    wrote down (``registry.recording``). Unlike a profiler capture this never comes back short: it lists what
    the stream was given, whatever the card's clock or the profiler's buffers."""
    from metrics_tpu_torch.ops import registry

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with registry.recording() as written, torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    nodes = graph_node_list(graph)
    del graph
    return nodes, [launch[0] for launch in written]


def host_ops(torch, fn, calls=3):
    """The names of the PyTorch operators ``calls`` eager calls of ``fn`` ran, from a host-only
    ``torch.profiler`` capture (after a warm-up call). The host's operator records do not go through the
    card's activity buffers, so they are whole."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
    return [e.name for e in prof.events()]


def engine_program(m):
    """The one captured program ``m``'s engine built."""
    programs = list(m._dispatcher._cache.values())
    check(len(programs) == 1 and len(programs[0].graphs) == 2,
          f"{type(m).__name__}'s engine holds {len(programs)} programs, not one captured program")
    return programs[0]


def engine_graph(m):
    """The first of the two CUDA graphs of the one program ``m``'s engine built."""
    return engine_program(m).graphs[0]


def ladder_ticks(levels, ticks):
    """The ticks each level of a ``ResolutionLadder(levels)`` holds after ``ticks`` ticks, from its rules
    alone: a tick lands in level 0; when tick ``t > 0`` starts on a multiple of level ``l``'s stride, level
    ``l - 1`` is folded into bucket ``(t // stride - 1) % L`` of level ``l`` and cleared, finest level first."""
    held = [[[] for _ in range(size)] for size in levels]
    strides = [math.prod(levels[:lvl]) for lvl in range(len(levels))]
    for t in range(ticks):
        for lvl in range(1, len(levels)):
            if t > 0 and t % strides[lvl] == 0:
                held[lvl][(t // strides[lvl] - 1) % levels[lvl]] = sorted(x for b in held[lvl - 1] for x in b)
                held[lvl - 1] = [[] for _ in range(levels[lvl - 1])]
        held[0][t % levels[0]].append(t)
    return [sorted(x for b in level for x in b) for level in held]


def bootstrapper(M, device, seed):
    b = M.BootStrapper(M.Accuracy(num_classes=NUM_CLASSES, average="macro", device=device), num_bootstraps=BOOTSTRAPS,
                       raw=True, quantile=BOOT_QUANTILES)
    b._rng = np.random.RandomState(seed)
    return b


def run_wrappers(torch, M, device, data, boot_seed):
    """Slice 12's ImageNet wrappers over ``data`` (batches on ``device``): the modules, their values, each
    one's update seconds over the epoch, and ``MinMaxMetric``'s value after every batch."""
    def acc(average):
        return M.Accuracy(num_classes=NUM_CLASSES, average=average, device=device)

    mods = {
        "per_class": acc(None),
        "classwise": M.ClasswiseWrapper(acc(None)),
        "bootstrap": bootstrapper(M, device, boot_seed),
        "minmax": M.MinMaxMetric(acc("macro")),
        "collection_fused": M.MetricCollection({"classwise": M.ClasswiseWrapper(acc(None)), "acc": acc("macro")},
                                               fused_update=True),
        "collection_eager": M.MetricCollection({"classwise": M.ClasswiseWrapper(acc(None)), "acc": acc("macro")},
                                               fused_update=False),
    }
    seconds = {k: 0.0 for k in mods}
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    minmax_raw = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the fused collection says that it serves its wrapper member eagerly
        for p, t in data:
            for key, m in mods.items():
                sync()
                t0 = time.perf_counter()
                m.update(p, t)
                if key == "minmax":
                    minmax_raw.append(m.compute()["raw"])
                sync()
                seconds[key] += time.perf_counter() - t0
    values = {k: m.compute() for k, m in mods.items()}
    return mods, values, seconds, minmax_raw


def tracker_epochs(torch, M, device, labels):
    """``MetricTracker`` over three epochs of label predictions whose top-1 hit rate grows (the teacher's
    noise shrinks): its ``compute_all`` and ``best_metric(return_step=True)``."""
    g = torch.Generator(device=device).manual_seed(SEED + 12)
    tracker = M.MetricTracker(M.MetricCollection({
        "acc": M.Accuracy(num_classes=NUM_CLASSES, average="macro", device=device),
        "precision": M.Precision(num_classes=NUM_CLASSES, average="macro", device=device),
        "f1": M.F1Score(num_classes=NUM_CLASSES, average="macro", device=device)}), maximize=True)
    for hit in TRACKER_HITS:
        tracker.increment()
        other = torch.randint(0, NUM_CLASSES, labels.shape, generator=g, device=device)
        preds = torch.where(torch.rand(labels.shape, generator=g, device=device) < hit, labels, other)
        for i in range(0, labels.shape[0], BATCH):
            tracker.update(preds[i:i + BATCH], labels[i:i + BATCH])
    return tracker.compute_all(), tracker.best_metric(return_step=True)


def nyu_normals_with_holes(torch, dev):
    """Slice 11's NYU-Depth v2 normals (its generator), with a seeded share of pixels that raw depth leaves
    without a normal: their target is NaN on all three components."""
    data = slice11_data(torch, dev)
    preds, target = data["normals"]
    del data
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    holes = torch.rand(target.shape[:2], generator=g, device=dev) < NYU_HOLE_SHARE
    return preds, target.masked_fill(holes[..., None], float("nan"))


def float64_r2_columns(torch, preds, target):
    """R2 of each column over the rows without NaN, in float64 on the card (torch's own float64 sums, none of
    the port's code), image by image; and the rows kept."""
    s = {k: torch.zeros(3, dtype=torch.float64, device=preds.device) for k in ("n", "t", "tt", "ee")}
    for p, t in zip(preds, target):
        p, t = p.double(), t.double()
        keep = ~(torch.isnan(p) | torch.isnan(t))
        p, t = torch.where(keep, p, 0.0), torch.where(keep, t, 0.0)
        s["n"] += keep.sum(0)
        s["t"] += t.sum(0)
        s["tt"] += (t * t).sum(0)
        s["ee"] += ((t - p) ** 2).sum(0)
    s = {k: v.cpu().numpy() for k, v in s.items()}
    return 1 - s["ee"] / (s["tt"] - s["t"] ** 2 / s["n"]), s["n"]


def fed(torch, m, data):
    """``m`` after ``update`` over ``data``, and the seconds that took to the device's completion."""
    sync = torch.cuda.synchronize if m.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for batch in data:
        m.update(*batch)
    sync()
    return m, time.perf_counter() - t0


def range_state(w, lo, hi):
    """The folded inner state of ``FoldTreeWindow.compute_range(lo, hi)``, caught at its inner compute."""
    caught = {}
    inner = w._inner
    real = inner.pure_compute
    inner.pure_compute = lambda state: caught.setdefault("state", state) and real(state)
    try:
        value = w.compute_range(lo, hi)
    finally:
        del inner.pure_compute
    return caught["state"], value


def window_profile(torch, w, args, replays):
    """An engine window's tick: its graph's nodes (captured again under :func:`kept_graphs` on a copy),
    the device µs of one replay of that graph (CUDA events), and the device busy share of ticks."""
    import copy

    twin = copy.deepcopy(w)
    with kept_graphs(torch):
        twin.update(*args)
    graph = engine_graph(twin)
    nodes = graph_nodes(graph)
    replay_us = device_ms(torch, graph.replay, reps=replays) * 1e3
    return {"graph_nodes": nodes, "replay_us": replay_us, "busy": device_busy(torch, lambda: twin.update(*args))}


def run_slice12(torch, dev, laps, batches, click_batches):
    """Slice 12 (see the module's docstring): returns the kernels' launches on its path."""
    import metrics_tpu_torch as M
    from metrics_tpu_torch.ops import fused_window_tick, launches, registry, reset_launches
    from metrics_tpu_torch.streaming import (ExponentialDecay, FoldTreeWindow, ResolutionLadder, SlidingWindow,
                                             TumblingWindow)

    cpu = torch.device("cpu")
    full = [b for b in batches if b[0].shape[0] == BATCH]
    report = {}
    reset_launches()

    # ---------------------------------------------------- ImageNet through the wrappers
    mods, values, wrap_s, minmax_raw = run_wrappers(torch, M, dev, batches, SEED + 12)
    check(list(values["classwise"]) == [f"accuracy_{i}" for i in range(NUM_CLASSES)],
          "ClasswiseWrapper's keys are not accuracy_0 .. accuracy_999")
    check(all(same_bits(torch, v, values["per_class"][i]) for i, v in enumerate(values["classwise"].values())),
          "ClasswiseWrapper's values are not the unwrapped per-class vector's bits")
    check(all(v.device == dev and v.shape == () for v in values["classwise"].values()),
          "ClasswiseWrapper's values are not 0-d tensors on the card")
    fused, eager = values["collection_fused"], values["collection_eager"]
    check(mods["collection_fused"]._fuse_failed and list(fused) == list(eager)
          and all(same_bits(torch, fused[k], eager[k]) for k in eager),
          "the fused collection did not serve its ClasswiseWrapper member eagerly with the eager values")
    boot = values["bootstrap"]
    check(set(boot) == {"mean", "std", "quantile", "raw"} and boot["raw"].shape == (BOOTSTRAPS,)
          and bool(torch.isfinite(boot["raw"]).all()), f"BootStrapper's result {boot}")
    torch.testing.assert_close(boot["mean"], boot["raw"].mean(), rtol=1e-6, atol=0, msg="BootStrapper's mean")
    lo, hi = boot["quantile"].tolist()
    check(lo <= float(boot["mean"]) <= hi and float(boot["std"]) > 0, f"BootStrapper's interval {lo}, {hi}")
    mm = values["minmax"]
    trace = torch.stack(minmax_raw)
    check(same_bits(torch, mm["max"], trace.max()) and same_bits(torch, mm["min"], trace.min()),
          "MinMaxMetric's max and min are not those of its values after every batch")
    torch.testing.assert_close(mm["raw"], values["per_class"].mean(), rtol=1e-6, atol=0,
                               msg="MinMaxMetric's macro accuracy against the per-class vector's mean")
    labels = torch.cat([t for _, t in batches])
    tracker_all, (best, best_step) = tracker_epochs(torch, M, dev, labels)
    check(best_step == {"acc": 2, "precision": 2, "f1": 2} and all(
        bool((v[1:] > v[:-1]).all()) for v in tracker_all.values()),
        f"MetricTracker: best steps {best_step}, values {tracker_all}: not the last, least noisy epoch")
    # the resample copies bit-equal to the CPU run from the same seed, on the first batches
    head = batches[:BOOT_CPU_BATCHES]
    h_boot, _ = fed(torch, bootstrapper(M, dev, SEED + 13), head)
    c_boot, c_boot_s = fed(torch, bootstrapper(M, cpu, SEED + 13), [(p.cpu(), t.cpu()) for p, t in head])
    for a, b in zip(h_boot.metrics, c_boot.metrics):
        check(same_bits(torch, a, b), "a BootStrapper copy on the card differs from the CPU run's")
    torch.testing.assert_close(h_boot.compute()["raw"].cpu(), c_boot.compute()["raw"], rtol=1e-6, atol=0,
                               msg="BootStrapper's copies' values differ from the CPU run")
    report["imagenet_wrappers"] = {
        "bootstrap": {k: v.tolist() for k, v in boot.items()},
        "minmax": {k: float(v) for k, v in mm.items()},
        "tracker_best": best, "tracker_best_step": best_step,
        "update_ms_a_batch": {k: s * 1e3 / len(batches) for k, s in wrap_s.items()},
        "bootstrap_cpu_update_ms_a_batch": c_boot_s * 1e3 / len(head),
        "update_syncs": {k: one_call_syncs(torch, lambda m=m: m.update(*batches[0]))[0] for k, m in mods.items()},
        "classwise_convert_syncs": one_call_syncs(torch, lambda: mods["classwise"]._convert(values["per_class"]))[0],
    }
    check(report["imagenet_wrappers"]["classwise_convert_syncs"] == 0, "ClasswiseWrapper's dict read the card")
    laps.mark("3. slice 12 wrappers")

    # ------------------------------------------- NYU-Depth v2 normals through MultioutputWrapper
    n_p, n_t = nyu_normals_with_holes(torch, dev)
    multi, multi_s = fed(torch, M.MultioutputWrapper(M.R2Score(device=dev), num_outputs=3), zip(n_p, n_t))
    r2 = torch.stack(multi.compute())
    ref_r2, kept_rows = float64_r2_columns(torch, n_p, n_t)
    # float32 sums of 2e8 terms against float64: rtol 1e-5
    np.testing.assert_allclose(r2.cpu().numpy(), ref_r2, rtol=1e-5, atol=0,
                               err_msg="the normals' R2 per column differs from its float64 closed form over the rows kept")
    head_p, head_t = n_p[:NYU12_CPU_IMAGES], n_t[:NYU12_CPU_IMAGES]
    h_multi, _ = fed(torch, M.MultioutputWrapper(M.R2Score(device=dev), num_outputs=3), zip(head_p, head_t))
    c_multi, c_multi_s = fed(torch, M.MultioutputWrapper(M.R2Score(device=cpu), num_outputs=3),
                             zip(head_p.cpu(), head_t.cpu()))
    torch.testing.assert_close(torch.stack(h_multi.compute()).cpu(), torch.stack(c_multi.compute()), rtol=1e-6, atol=0,
                               msg=f"the normals' R2 on the first {NYU12_CPU_IMAGES} images differs from the CPU run")
    report["nyu_normals_multioutput"] = {
        "r2": r2.tolist(), "reference": ref_r2.tolist(), "rows_kept": kept_rows.tolist(),
        "epoch_ms": multi_s * 1e3, "update_ms": multi_s * 1e3 / NYU_IMAGES,
        "update_syncs": one_call_syncs(torch, lambda: multi.update(n_p[0], n_t[0])),
        "cpu_update_ms": c_multi_s * 1e3 / NYU12_CPU_IMAGES,
    }
    del n_p, n_t, head_p, head_t
    laps.mark("3. slice 12 NYU normals")

    # ---------------------------------------------- an hour-long accuracy monitor
    ticks = [full[i % len(full)] for i in range(MONITOR_TICKS)]

    def monitor(slide, jit, device=dev):
        return SlidingWindow(M.Accuracy(num_classes=NUM_CLASSES, average="macro", device=device),
                             window=MONITOR_WINDOW, slide=slide, jit_update=jit)

    monitors = {}
    for slide in MONITOR_SLIDES:
        before = launches()["stat_scores"]
        engine, engine_s = fed(torch, monitor(slide, True), ticks)
        engine_launches = launches()["stat_scores"] - before
        eager, eager_s = fed(torch, monitor(slide, False), ticks)
        stats = engine.dispatch_stats
        check(stats["dispatches"] == MONITOR_TICKS and stats["retraces"] == 1 and stats["demotions"] == 0,
              f"the slide-{slide} monitor's engine: {stats}, not {MONITOR_TICKS} ticks on one capture")
        check(engine_launches == MONITOR_TICKS, f"stat_scores ran {engine_launches} times in {MONITOR_TICKS} ticks")
        check(same_bits(torch, engine, eager), f"the slide-{slide} monitor's engine states are not the eager ticks'")
        held = (engine.num_buckets - 1) * slide + int(engine.in_bucket)
        oracle, _ = fed(torch, M.Accuracy(num_classes=NUM_CLASSES, average="macro", device=dev), ticks[-held:])
        value = engine.compute()
        check(same_bits(torch, value, oracle.compute()) and same_bits(torch, eager.compute(), value),
              f"the slide-{slide} monitor's value is not a fresh Accuracy's over its last {held} ticks")
        folded = engine._cached_fold()
        check(all(same_bits(torch, folded[k], getattr(oracle, k)) for k in folded),
              f"the slide-{slide} monitor's folded counts are not the oracle's")
        p, t = full[0]
        timings = host_ms_in_turns(torch, {"engine": lambda: engine.update(p, t), "eager": lambda: eager.update(p, t)})
        engine._computed = None
        monitors[f"slide{slide}"] = {
            "ticks": MONITOR_TICKS, "held": held, "value": float(value), "retraces": stats["retraces"],
            "stat_scores_launches_engine": engine_launches,
            "epoch_ms": {"engine": engine_s * 1e3, "eager": eager_s * 1e3},
            "tick_ms": timings,
            "host_syncs_a_tick": {"engine": one_call_syncs(torch, lambda: engine.update(p, t)),
                                  "eager": one_call_syncs(torch, lambda: eager.update(p, t))},
            "compute_ms": host_ms(torch, lambda: engine._compute_impl(), reps=10),
            **window_profile(torch, engine, (p, t), replays=10),
        }
        check(monitors[f"slide{slide}"]["host_syncs_a_tick"]["engine"][0] == 0,
              f"a warm engine tick of the slide-{slide} monitor synchronised with the host")
    # CPU rerun of the first ticks: the cursor wraps the ring once
    c_mon, _ = fed(torch, monitor(1, False, cpu), [(p.cpu(), t.cpu()) for p, t in ticks[:MONITOR_CPU_TICKS]])
    h_mon, _ = fed(torch, monitor(1, True), ticks[:MONITOR_CPU_TICKS])
    check(same_bits(torch, c_mon, h_mon), f"the monitor's states after {MONITOR_CPU_TICKS} ticks differ from the CPU run")
    # fused_window_tick on an eager window: one graph launch a tick, against the eager tick
    replays = []
    real_replay = torch.cuda.CUDAGraph.replay

    def counted(graph):
        replays.append(1)
        return real_replay(graph)

    fused, eager = monitor(1, False), monitor(1, False)
    torch.cuda.CUDAGraph.replay = counted
    try:
        for i, (p, t) in enumerate(ticks[:FUSED_TICKS]):
            fused_window_tick(fused, (p, t), {})
            check(len(replays) == i, f"fused_window_tick made {len(replays)} graph launches in {i + 1} ticks")
    finally:
        torch.cuda.CUDAGraph.replay = real_replay
    _, eager_s = fed(torch, eager, ticks[:FUSED_TICKS])
    check(same_bits(torch, fused, eager), "fused_window_tick's states are not the eager ticks'")
    check(fused.dispatch_stats["dispatches"] == FUSED_TICKS and fused.dispatch_stats["retraces"] == 1,
          f"fused_window_tick's engine: {fused.dispatch_stats}")
    p, t = full[1]
    monitors["fused_window_tick"] = {
        "ticks": FUSED_TICKS, "graph_launches_a_warm_tick": len(replays) / (FUSED_TICKS - 1),
        "tick_ms": host_ms_in_turns(torch, {"fused": lambda: fused_window_tick(fused, (p, t), {}),
                                            "eager": lambda: eager.update(p, t)}),
        "host_syncs_a_tick": one_call_syncs(torch, lambda: fused_window_tick(fused, (p, t), {})),
    }
    report["accuracy_monitor"] = monitors
    laps.mark("3. slice 12 accuracy monitor")

    # -------------------------------------------- click-log heavy hitters over the last hour
    def heavy(jit, device=dev):
        return SlidingWindow(M.CountMinHeavyHitters(depth=CLICK_DEPTH, width=CLICK_WIDTH, device=device),
                             window=CLICK_WINDOW, jit_update=jit)

    before = launches()["countmin"]
    hh, hh_s = fed(torch, heavy(True), [(x,) for x in click_batches])
    hh_launches = launches()["countmin"] - before
    hh_eager, hh_eager_s = fed(torch, heavy(False), [(x,) for x in click_batches])
    check(hh.dispatch_stats["retraces"] == 1 and hh.dispatch_stats["demotions"] == 0 and hh_launches == len(click_batches),
          f"the heavy-hitter window's engine: {hh.dispatch_stats}, {hh_launches} count-min launches")
    check(same_bits(torch, hh, hh_eager), "the heavy-hitter window's engine states are not the eager ticks'")
    last = click_batches[-CLICK_WINDOW:]
    cm_oracle, _ = fed(torch, M.CountMinHeavyHitters(depth=CLICK_DEPTH, width=CLICK_WIDTH, device=dev), [(x,) for x in last])
    table = hh._cached_fold()["value"]
    check(same_bits(torch, table, cm_oracle.value), "the window's count-min table is not a fresh sketch's over its hour")
    last_ids = torch.cat(last)
    check(np.array_equal(table.cpu().numpy().astype(np.float64),
                         numpy_countmin(last_ids.cpu().numpy(), CLICK_DEPTH, CLICK_WIDTH)),
          "the window's count-min table differs from the numpy reference over its hour")
    check(float(table.max()) <= last_ids.numel() < 2 ** 24, "a count-min cell passed 2^24")
    ft, ft_s = fed(torch, FoldTreeWindow(M.HyperLogLog(precision=HLL_PRECISION, device=dev), window=CLICK_WINDOW),
                   [(x,) for x in click_batches])
    first = len(click_batches) - CLICK_WINDOW  # logical bucket j holds tick first + j
    ranges = {}
    for lo, hi in HLL_RANGES:
        state, value = range_state(ft, lo, hi)
        fresh, _ = fed(torch, M.HyperLogLog(precision=HLL_PRECISION, device=dev),
                       [(x,) for x in click_batches[first + lo:first + hi]])
        check(same_bits(torch, state["value"], fresh.value) and same_bits(torch, value, fresh.compute()),
              f"HyperLogLog registers over buckets [{lo}, {hi}) are not a fresh sketch's")
        check(ft.range_merge_count <= math.ceil(math.log2(CLICK_WINDOW)), f"{ft.range_merge_count} merges")
        ranges[f"[{lo}, {hi})"] = {"estimate": float(value), "merges": ft.range_merge_count}
    x = click_batches[0]
    report["click_heavy_hitters"] = {
        "ticks": len(click_batches), "countmin_launches_engine": hh_launches,
        "ring_bytes": hh.ring_value.numel() * 4, "max_cell": float(table.max()),
        "epoch_ms": {"engine": hh_s * 1e3, "eager": hh_eager_s * 1e3, "fold_tree_hll": ft_s * 1e3},
        "tick_ms": host_ms_in_turns(torch, {"engine": lambda: hh.update(x), "eager": lambda: hh_eager.update(x)}, reps=10),
        "host_syncs_a_tick": {"engine": one_call_syncs(torch, lambda: hh.update(x)),
                              "eager": one_call_syncs(torch, lambda: hh_eager.update(x))},
        "compute_ms": host_ms(torch, lambda: hh._compute_impl(), reps=10),
        "hll_ranges": ranges,
        **window_profile(torch, hh, (x,), replays=5),
    }
    check(report["click_heavy_hitters"]["host_syncs_a_tick"]["engine"][0] == 0,
          "a warm engine tick of the heavy-hitter window synchronised with the host")
    del hh, hh_eager
    laps.mark("3. slice 12 click-log windows")

    # ------------------------------------------------- a minute -> hour -> day latency ladder
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    lat = torch.exp(LATENCY_LOG_MU + LATENCY_LOG_SIGMA * torch.randn(LADDER_TICKS, LADDER_BATCH, generator=g, device=dev))
    lat_ticks = [(x,) for x in lat]
    ladder, ladder_s = fed(torch, ResolutionLadder(M.QuantileSketch(device=dev), levels=LADDER_LEVELS), lat_ticks)
    ladder_eager, ladder_eager_s = fed(torch, ResolutionLadder(M.QuantileSketch(device=dev), levels=LADDER_LEVELS,
                                                               jit_update=False), lat_ticks)
    check(ladder.dispatch_stats["retraces"] == 1 and ladder.dispatch_stats["demotions"] == 0,
          f"the ladder's engine: {ladder.dispatch_stats}")
    check(same_bits(torch, ladder, ladder_eager), "the ladder's engine states are not the eager ticks'")
    held = ladder_ticks(LADDER_LEVELS, LADDER_TICKS)
    levels = {}
    for lvl, tick_ids in enumerate(held):
        fresh, _ = fed(torch, M.QuantileSketch(device=dev), [lat_ticks[i] for i in tick_ids])
        got = ladder.compute_level(lvl)
        check(same_bits(torch, got, fresh.compute()) and same_bits(torch, got, ladder_eager.compute_level(lvl)),
              f"the ladder's level {lvl} is not a fresh sketch's over its {len(tick_ids)} ticks")
        levels[f"level{lvl}"] = {"ticks": len(tick_ids), "p50_ms": float(got)}
    whole, _ = fed(torch, M.QuantileSketch(device=dev), [lat_ticks[i] for i in sorted(sum(held, []))])
    check(same_bits(torch, ladder.compute(), whole.compute()) and same_bits(torch, ladder.compute(), ladder_eager.compute()),
          "the ladder's whole-horizon value is not a fresh sketch's")
    tumbling, tumbling_s = fed(torch, TumblingWindow(M.MeanMetric(device=dev), window=LADDER_LEVELS[0]), lat_ticks)
    last_full = LADDER_TICKS - LADDER_TICKS % LADDER_LEVELS[0]
    done, _ = fed(torch, M.MeanMetric(device=dev), lat_ticks[last_full - LADDER_LEVELS[0]:last_full])
    check(same_bits(torch, tumbling.compute(), done.compute()), "TumblingWindow's value is not its last window's mean")
    decay, decay_s = fed(torch, ExponentialDecay(M.MeanMetric(device=dev), halflife=DECAY_HALFLIFE), lat_ticks)
    d = float(np.float32(0.5 ** (1.0 / DECAY_HALFLIFE)))
    sums = lat.double().sum(dim=1).cpu().numpy()
    weights = d ** np.arange(LADDER_TICKS - 1, -1, -1, dtype=np.float64)
    closed = float((weights * sums).sum() / (weights.sum() * LADDER_BATCH))
    # float32 recurrences over 3,660 ticks against float64 (each tick's error decays by d): rtol 1e-5
    np.testing.assert_allclose(float(decay.compute()), closed, rtol=1e-5, atol=0,
                               err_msg="ExponentialDecay differs from its float64 closed form")
    x = lat_ticks[0]
    strides = [math.prod(LADDER_LEVELS[:lvl]) for lvl in range(1, len(LADDER_LEVELS))]
    report["latency_ladder"] = {
        "ticks": LADDER_TICKS, "levels": levels, "p50_ms": float(ladder.compute()),
        "cascades": [sum(1 for t in range(1, LADDER_TICKS) if t % s == 0) for s in strides],
        "tumbling_mean_ms": float(tumbling.compute()), "decay_mean_ms": float(decay.compute()), "decay_closed_form": closed,
        "epoch_ms": {"engine": ladder_s * 1e3, "eager": ladder_eager_s * 1e3, "tumbling": tumbling_s * 1e3,
                     "decay": decay_s * 1e3},
        "tick_ms": host_ms_in_turns(torch, {"engine": lambda: ladder.update(*x), "eager": lambda: ladder_eager.update(*x)},
                                    reps=10),
        "host_syncs_a_tick": {"engine": one_call_syncs(torch, lambda: ladder.update(*x)),
                              "eager": one_call_syncs(torch, lambda: ladder_eager.update(*x))},
        "compute_ms": host_ms(torch, lambda: ladder._compute_impl(), reps=10),
        **window_profile(torch, ladder, x, replays=5),
    }
    check(report["latency_ladder"]["host_syncs_a_tick"]["engine"][0] == 0,
          "a warm engine tick of the ladder synchronised with the host")
    laps.mark("3. slice 12 latency ladder")

    slice12_launches = launches()
    by_shape12 = {name: registry.launches_by_shape(name) for name in ("stat_scores", "countmin")}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for path, line in report.items():
        print(f"slice 12 {path} ({card}): " + json.dumps(line, default=float))
    print(f"slice 12 launches {json.dumps(slice12_launches)}")
    return slice12_launches, by_shape12


def slice13_epoch(torch, M, telemetry, profiling, registry, dev, batches, mode):
    """Slice 7's collection over ImageNet's epoch in one of slice 13's modes (``eager``, ``fused``, or
    ``engines``: each member on ``jit_update=True``) inside one telemetry session and a dispatch tracker, then a
    compute and a reset. Returns the session, the collection, the tracker, the launches and the values."""
    engines = mode == "engines"
    members = evaluation_members(M, dev, **({"jit_update": True} if engines else {}))
    mc = M.MetricCollection(members, prefix="val_", fused_update=mode == "fused")
    registry.reset_launches()
    telemetry.reset_counters()
    with telemetry.instrument() as session, profiling.track_dispatches() as tracker:
        for p, t in batches:
            mc.update(p, t)
        values = mc.compute()
        mc.reset()
    torch.cuda.synchronize()
    return session, mc, tracker, registry.launches(), registry.replayed_launches(), values


def check_slice13_epoch(mode, session, mc, tracker, launched, replayed, telemetry):
    """Slice 13's checks on one epoch (see the module's docstring); returns what it counted."""
    owners = [("MetricCollection", mc)] + [(type(m).__name__, m) for m in mc.values(copy_state=False)]
    kind = {"eager": "eager", "fused": "fused-aot", "engines": "aot"}[mode]
    for owner, m in owners:
        updates = session.spans(name="update", owner=owner)
        want = m.dispatch_stats["dispatches"]
        check(len(updates) == want and all(e.kind == kind for e in updates),
              f"slice 13 {mode}: {len(updates)} update spans of {owner} ({sorted({e.kind for e in updates})}) against "
              f"its {want} dispatches")
        builds = m.dispatch_stats["retraces"] + m.forward_stats["retraces"]
        compiles = [e for e in session.spans(name="compile") if e.owner == owner]
        check(len(compiles) == builds, f"slice 13 {mode}: {len(compiles)} compile spans of {owner}, {builds} builds")
        engine = m._dispatcher
        causes = {}
        for (family, cause), n in (engine.causes.items() if engine is not None else ()):
            if family != "scan":
                causes[cause] = causes.get(cause, 0) + n
        got = {}
        for e in compiles:
            got[e.attrs["cause"]] = got.get(e.attrs["cause"], 0) + 1
        check(got == causes, f"slice 13 {mode}: {owner}'s compile causes {got}, the dispatcher named {causes}")
    members = owners[1:]
    check(session.count(name="compute") == len(members) and session.count(name="reset") == len(members),
          f"slice 13 {mode}: {session.count(name='compute')} compute spans, {session.count(name='reset')} resets, "
          f"for {len(members)} members computed and reset once")
    # kernel events: one for each launch that no replay ran (the eager calls and each build's warm-up run)
    kernel_events = {}
    for name, owner in (("stat_scores", "ops.stat_scores"), ("confusion_matrix", "ops.confusion_matrix")):
        events = session.count(name="kernel", owner=owner)
        kernel_events[name] = events
        check(events == launched[name] - replayed[name],
              f"slice 13 {mode}: {events} {name} kernel events for {launched[name]} launches, {replayed[name]} replayed")
        dispatchers = [m._dispatcher for _, m in owners if m._dispatcher is not None]
        in_programs = sum(sum(1 for k in prog.launched if k[0] == name) for d in dispatchers for prog in d._cache.values())
        if mode == "eager":
            check(replayed[name] == 0 and in_programs == 0, f"slice 13 eager: a {name} launch ran in a graph")
        else:
            check(events == in_programs and replayed[name] > 0,
                  f"slice 13 {mode}: {events} {name} kernel events, {in_programs} in the programs' captures (one a build)")
    counters = telemetry.snapshot()
    counted = {}
    for e in session.events:
        key = f"{e.name}:{e.kind}" if e.kind else e.name
        counted[key] = counted.get(key, 0) + 1
    for cause, n in session.retrace_causes().items():
        counted[f"compile:cause:{cause}"] = n
    check({k: v for k, v in counters.items() if k != "collective:bytes"} == counted,
          f"slice 13 {mode}: telemetry.snapshot() {counters} is not the session's counts {counted}")
    dispatches = sum(m.dispatch_stats["dispatches"] for _, m in owners)
    check(tracker.dispatches == dispatches, f"slice 13 {mode}: track_dispatches() {tracker.dispatches}, dispatch_stats {dispatches}")
    return {"events": len(session.events), "updates": session.count(name="update"),
            "compiles": session.count(name="compile"), "causes": session.retrace_causes(),
            "kernel_events": kernel_events, "launches": {k: launched[k] for k in kernel_events},
            "replayed": {k: replayed[k] for k in kernel_events}, "tracker_dispatches": tracker.dispatches}


def run_slice13(torch, dev, laps, batches, click_batches):
    """Slice 13 (see the module's docstring): returns the kernels' launches on its path and by shape."""
    import tempfile

    import metrics_tpu_torch as M
    from metrics_tpu_torch import faults, profiling, telemetry
    from metrics_tpu_torch.ops import registry
    from metrics_tpu_torch.streaming import SlidingWindow, TumblingWindow

    report = {}
    totals = {"stat_scores": 0, "confusion_matrix": 0, "countmin": 0}
    by_shape13 = {name: {} for name in totals}

    def note_launches():
        for name in totals:
            totals[name] += registry.launches()[name]
            by_shape13[name] = merged(by_shape13[name], registry.launches_by_shape(name))

    # ------------------------------------------- the instrumented ImageNet epoch, in three modes
    epochs, values = {}, {}
    for mode in ("eager", "fused", "engines"):
        session, mc, tracker, launched, replayed, vals = slice13_epoch(
            torch, M, telemetry, profiling, registry, dev, batches, mode)
        note_launches()
        epochs[mode] = check_slice13_epoch(mode, session, mc, tracker, launched, replayed, telemetry)
        values[mode] = vals
        if mode == "eager":
            epoch_session = session
    for mode in ("fused", "engines"):
        check(all(same_bits(torch, values[mode][k], values["eager"][k]) for k in values["eager"]),
              f"slice 13: the {mode} epoch's values are not the eager epoch's bits")
    report["epochs"] = epochs
    registry.reset_launches()  # each epoch's launches are noted above
    laps.mark("3. slice 13 instrumented epochs")

    # --------------------------------------------------------------------- overhead, in turns
    p, t = batches[0]
    # each arm's switch is set, and its session entered, outside the clock: a call is timed alone
    arms = {"off": telemetry_off, "instrumented": telemetry.instrument}
    engine_acc = M.Accuracy(num_classes=NUM_CLASSES, average="macro", jit_update=True, device=dev)
    eager_acc = M.Accuracy(num_classes=NUM_CLASSES, average="macro", device=dev)
    fused = M.MetricCollection(evaluation_members(M, dev), prefix="val_", fused_update=True)
    overhead = {}
    for path, m in (("accuracy_engine", engine_acc), ("accuracy_eager", eager_acc), ("collection_fused", fused)):
        fns = {how: (lambda m=m: m.update(p, t)) for how in ("off", "idle", "instrumented")}
        ms = host_ms_in_turns(torch, fns, around=arms)
        overhead[path] = {"ms": ms, "idle_over_off": ms["idle"] / ms["off"],
                          "instrumented_over_off": ms["instrumented"] / ms["off"]}
    with telemetry.instrument():
        syncs = one_call_syncs(torch, lambda: engine_acc.update(p, t))
    check(syncs[0] == 0, f"slice 13: a warm engine update inside a session synchronised with the host: {syncs}")
    overhead["engine_update_syncs_in_a_session"] = syncs[0]
    report["overhead"] = overhead
    note_launches()
    registry.reset_launches()
    laps.mark("3. slice 13 overhead")

    # ------------------------------------------------------------------------- a degrade
    with telemetry.instrument() as session, faults.inject("launch", count=1) as spec:
        engine_acc.update(p, t)
    ref = M.Accuracy(num_classes=NUM_CLASSES, average="macro", device=dev)
    for _ in range(engine_acc._update_count):
        ref.update(p, t)
    degrades = session.spans(name="degrade")
    check(spec.fired == 1 and len(degrades) == 1 and degrades[0].attrs["cause"] == "injected:launch"
          and degrades[0].kind == "dispatch", f"slice 13: the injected launch fault gave {degrades}")
    check(same_bits(torch, engine_acc.compute(), ref.compute()) and same_bits(torch, engine_acc, ref),
          "slice 13: the degraded engine's value is not the eager metric's bits")
    report["degrade"] = {"attrs": {k: v for k, v in degrades[0].attrs.items() if k != "error"},
                         "spans": sorted(f"{e.name}:{e.kind}" for e in session.events)}
    note_launches()
    registry.reset_launches()
    laps.mark("3. slice 13 degrade")

    # ---------------------------------------------------- windows and sketches, eager ticks
    full = [b for b in batches if b[0].shape[0] == BATCH]
    ticks = [full[i % len(full)] for i in range(SLICE13_TICKS)]
    monitor = SlidingWindow(M.Accuracy(num_classes=NUM_CLASSES, average="macro", device=dev), window=MONITOR_WINDOW,
                            slide=1, jit_update=False)
    with telemetry.instrument() as session:
        for i, (p_, t_) in enumerate(ticks):
            monitor.update(p_, t_)
            if i % SLICE13_READ_EVERY == SLICE13_READ_EVERY - 1:
                monitor.compute()
    reads = SLICE13_TICKS // SLICE13_READ_EVERY
    kinds = {}
    for e in session.spans(name="window"):
        kinds[e.kind] = kinds.get(e.kind, 0) + 1
    check(kinds.get("advance", 0) + kinds.get("update", 0) == SLICE13_TICKS and kinds.get("compute") == reads
          and session.count(name="read") == reads,
          f"slice 13: {SLICE13_TICKS} eager monitor ticks and {reads} reads gave the window events {kinds} and "
          f"{session.count(name='read')} reads")
    p_, t_ = full[0]
    # host syncs of an eager call with telemetry off, idle (on, no session) and inside a session: an idle
    # stream adds none; a session adds the tumbling tick's read of whether it advanced and the read's live count
    tumbling = TumblingWindow(M.Accuracy(num_classes=NUM_CLASSES, average="macro", device=dev), window=MONITOR_WINDOW,
                              jit_update=False)
    calls = {"monitor_tick": lambda: monitor.update(p_, t_), "monitor_read": monitor._compute_impl,  # not memoised
             "tumbling_tick": lambda: tumbling.update(p_, t_)}
    window_syncs = {}
    for call, fn in calls.items():
        with telemetry_off():
            off = one_call_syncs(torch, fn)[0]
        idle = one_call_syncs(torch, fn)[0]
        with telemetry.instrument():
            instrumented = one_call_syncs(torch, fn)[0]
        window_syncs[call] = {"off": off, "idle": idle, "instrumented": instrumented}
        added = {"monitor_tick": 0, "monitor_read": 1, "tumbling_tick": 1}[call]
        check(idle == off and instrumented == off + added,
              f"slice 13: an eager {call} syncs {window_syncs[call]} times with telemetry off, idle and in a session")
    sketch = M.CountMinHeavyHitters(depth=CLICK_DEPTH, width=CLICK_WIDTH, device=dev)
    with telemetry.instrument() as sk_session:
        for x in click_batches[:SLICE13_SKETCH_BATCHES]:
            sketch.update(x)
        sketch.compute()
    updates = sk_session.spans(name="sketch", kind="update")
    check(len(updates) == SLICE13_SKETCH_BATCHES and all(
        (e.attrs["depth"], e.attrs["width"]) == (CLICK_DEPTH, CLICK_WIDTH) for e in updates)
          and sk_session.count(name="sketch", kind="compute") == 1
          and sk_session.count(name="kernel", owner="ops.countmin_scatter") == SLICE13_SKETCH_BATCHES,
          f"slice 13: the click-log count-min gave {[(e.kind, e.attrs) for e in sk_session.spans(name='sketch')][:3]}")
    report["windows"] = {"window_events": kinds, "reads": session.count(name="read"),
                         "host_syncs": window_syncs,
                         "sketch_events": sk_session.count(name="sketch")}
    note_launches()
    laps.mark("3. slice 13 windows and sketches")

    # ----------------------------------------------------------------------------- exports
    with tempfile.TemporaryDirectory() as tmp:
        jsonl, chrome = os.path.join(tmp, "epoch.jsonl"), os.path.join(tmp, "epoch.trace.json")
        epoch_session.export_jsonl(jsonl)
        epoch_session.export_chrome_trace(chrome)
        with open(jsonl) as f:
            lines = [json.loads(line) for line in f]
        with open(chrome) as f:
            trace = json.load(f)["traceEvents"]
        phases = {}
        for r in trace:
            phases[r["ph"]] = phases.get(r["ph"], 0) + 1
        check(len(lines) == len(epoch_session.events) and phases.get("X", 0) + phases.get("i", 0) == len(lines),
              f"slice 13: the exports hold {len(lines)} lines and {phases} records for {len(epoch_session.events)} events")
        report["exports"] = {"jsonl_bytes": os.path.getsize(jsonl), "chrome_bytes": os.path.getsize(chrome),
                             "events": len(lines), "ph": phases}

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for path, line in report.items():
        print(f"slice 13 {path} ({card}): " + json.dumps(line, default=float))
    print(f"slice 13 launches {json.dumps(totals)}")
    laps.mark("3. slice 13 exports")
    return totals, by_shape13


@contextlib.contextmanager
def telemetry_off():
    """The port's telemetry switched off (``METRICS_TPU_TELEMETRY=0``) for the block."""
    os.environ["METRICS_TPU_TELEMETRY"] = "0"
    try:
        yield
    finally:
        os.environ.pop("METRICS_TPU_TELEMETRY")


def slice13_profiler_ranges(torch, dev, batches):
    """Slice 13's ``torch.profiler`` capture of three warm engine updates of ``Accuracy(1000)``: the
    ``metrics_tpu.*`` ranges it shows. It runs after every kernel check that reads a profiler capture."""
    import metrics_tpu_torch as M

    p, t = batches[0]
    acc = M.Accuracy(num_classes=NUM_CLASSES, average="macro", jit_update=True, device=dev)
    acc.update(p, t)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            acc.update(p, t)
        torch.cuda.synchronize()
    ranges = sorted({e.key for e in prof.key_averages() if e.key.startswith("metrics_tpu.")})
    check("metrics_tpu.Accuracy.update[aot]" in ranges, f"slice 13: the profiler shows the ranges {ranges}")
    print(f"slice 13 profiler_ranges: {json.dumps(ranges)}")


def top1_scores(torch, g, n, c, hit=0.76):
    """``(n, c)`` softmax scores of seeded logits with the label on top for
    ``hit`` of the rows (the slices' ImageNet generator), and the labels."""
    dev = g.device
    labels = torch.randint(0, c, (n,), generator=g, device=dev)
    logits = torch.randn(n, c, generator=g, device=dev)
    top = torch.rand(n, generator=g, device=dev) < hit
    rows = torch.arange(n, device=dev)
    logits[rows, labels] = torch.where(top, logits.amax(dim=1) + 1.0, logits[rows, labels])
    return torch.softmax(logits, dim=1), labels


def zipf_ids(torch, g, n, ids=CLICK_IDS, s=CLICK_ZIPF):
    """``n`` item ids drawn Zipf(s) over ``ids`` ids, as float32 (the click log's generator)."""
    dev = g.device
    cdf = torch.cumsum(torch.arange(1, ids + 1, dtype=torch.float64, device=dev) ** -s, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, generator=g, device=dev, dtype=torch.float64)
    return torch.searchsorted(cdf, u).clamp(max=ids - 1).to(torch.float32)


def slice14_counts_reference(torch, preds, target, tenants, rows):
    """Per tenant ``(tp, fp, tn, fn)`` of a macro reduce from one ``np.bincount``
    over ``tenant * 3C + [target, pred + C, target + 2C]``, the predicted class
    by ``argmax`` (no NaN in these scores): independent of the port."""
    c = preds.shape[1]
    pred = preds.argmax(dim=1).cpu().numpy().astype(np.int64)
    t = target.cpu().numpy().astype(np.int64)
    tenant = np.repeat(np.arange(tenants), rows)
    flat = np.concatenate([tenant * 3 * c + t, tenant * 3 * c + c + pred, tenant * 3 * c + 2 * c + t])
    w = np.concatenate([np.ones(2 * t.size, np.int64), (pred == t).astype(np.int64)])
    counts = np.bincount(flat, weights=w, minlength=tenants * 3 * c).astype(np.int64).reshape(tenants, 3, c)
    tp = counts[:, 2]
    fp, fn = counts[:, 1] - tp, counts[:, 0] - tp
    return tp, fp, rows - tp - fp - fn, fn


def slice14_worker(phase, root, device):
    """``python3 chip_smoke.py --slice14-worker {run|recover} ROOT DEVICE``:
    slice 14's journaled ImageNet-width service on ``DEVICE`` (the parent's
    card; 64 tenants, fsync on, a checkpoint every 2 flushes, 1 MiB segments) over a fixed stream of
    ``SLICE14_DURABLE_OPS`` ops; ``recover`` first restores (checkpoint plus
    the fenced journal tail) and resumes after the journal's high-water mark.
    Prints one JSON line: the state digest, the journal's high-water mark, and
    the timings the parent reports."""
    import torch

    from metrics_tpu_torch import Accuracy, telemetry
    from metrics_tpu_torch.serve import MetricsService

    t_start = time.perf_counter()
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    svc = MetricsService(Accuracy(num_classes=NUM_CLASSES, average="macro", device=dev),
                         journal_dir=os.path.join(root, "wal"), checkpoint_dir=os.path.join(root, "ckpt"),
                         checkpoint_every=2)
    start_seq, first_result_ms = 0, None
    if phase == "recover":
        svc.recover()
        start_seq = svc.journal.last_seq
        svc.compute(sorted(svc._rows)[0])
        sync()
        first_result_ms = (time.perf_counter() - t_start) * 1e3
    closed = set()
    with telemetry.instrument() as session:
        for i in range(SLICE14_DURABLE_OPS):
            name = f"t{i % SLICE14_DURABLE_TENANTS}"
            op = "close" if i == 40 else "reset" if i == 70 else "update"
            if i + 1 <= start_seq:  # durable before the kill: applied by the replay
                if op == "close":
                    closed.add("t5")
                elif name in closed and op == "update":
                    closed.discard(name)
                continue
            if op == "close":
                svc.close_session("t5")
                closed.add("t5")
            elif op == "reset":
                svc.reset_session("t9")
            else:
                if name in closed:
                    svc.open_session(name)
                    closed.discard(name)
                g = torch.Generator(device=dev).manual_seed(1000 + i)
                svc.submit(name, *top1_scores(torch, g, SLICE14_DURABLE_ROWS, NUM_CLASSES))
            if i % 8 == 7:
                svc.flush()
        svc.drain()
    sync()
    # a request's journal_us: the whole append, the inputs' copy from the card to the host included; the journal
    # span's: the frame's write and fsync
    journal_us = [e.attrs["journal_us"] for e in session.spans(name="request") if not e.attrs.get("replayed")]
    frame_us = [e.dur_us for e in session.spans(name="journal", kind="append")]
    ckpt_ms = [e.dur_us / 1e3 for e in session.spans(name="checkpoint")]
    print(json.dumps({
        "digest": svc.state_digest(), "last_seq": svc.journal.last_seq, "sessions": svc.session_count,
        "journal_us_median": statistics.median(journal_us) if journal_us else None,
        "frame_write_us_median": statistics.median(frame_us) if frame_us else None,
        "journal_appends": len(frame_us), "fsync_us_p50": svc.journal.stats()["fsync_us_p50"],
        "checkpoint_ms_median": statistics.median(ckpt_ms) if ckpt_ms else None, "checkpoints": len(ckpt_ms),
        "recovery_to_first_result_ms": first_result_ms, "replayed_records": svc.stats["replayed_records"],
    }))
    return 0


def run_slice14(torch, dev, laps):
    """Slice 14 (see the module's docstring): returns the kernels' launches on its
    path and by shape, and the session axis's kernel inputs at the service's
    ImageNet flush."""
    import tempfile

    import metrics_tpu_torch as M
    from metrics_tpu_torch import resilience, telemetry
    from metrics_tpu_torch.ops import registry
    from metrics_tpu_torch.dispatch import copy_tensors
    from metrics_tpu_torch.serve import MetricsService, QueueFullError
    from metrics_tpu_torch.functional.classification.stat_scores import _predicted_classes
    from metrics_tpu_torch.utilities.checks import tracing

    totals = {"stat_scores": 0, "countmin": 0}
    by_shape14 = {name: {} for name in totals}

    def note_launches():
        for name in totals:
            totals[name] += registry.launches()[name]
            by_shape14[name] = merged(by_shape14[name], registry.launches_by_shape(name))
        registry.reset_launches()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    degrades0 = sum(resilience.degrades().values())
    report = {"card": card}
    tenants, rows, c = SLICE14_TENANTS, SLICE14_ROWS, NUM_CLASSES
    names = [f"t{i}" for i in range(tenants)]

    # ----------------------------------------------------------- A. the ImageNet-1k evaluation service
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    flushes = [top1_scores(torch, g, tenants * rows, c) for _ in range(SLICE14_FLUSHES)]
    svc = MetricsService(M.Accuracy(num_classes=c, average="macro", device=dev))
    cpu = MetricsService(M.Accuracy(num_classes=c, average="macro", device="cpu"))  # the 64-tenant prefix
    registry.reset_launches()
    flush_ms, submit_ms, per_flush = [], [], []
    stage = {}
    with contextlib.ExitStack() as stack:
        session = None
        for f, (preds, target) in enumerate(flushes):
            if f == SLICE14_FLUSHES - 2:  # the last two flushes inside a session: the request spans' stage shares
                session = stack.enter_context(telemetry.instrument())
            launches0, stats0 = registry.launches()["stat_scores"], svc.stats["launches"]
            t0 = time.perf_counter()
            for i, name in enumerate(names):
                svc.submit(name, preds[i * rows:(i + 1) * rows], target[i * rows:(i + 1) * rows])
            t1 = time.perf_counter()
            svc.drain()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            submit_ms.append((t1 - t0) * 1e3)
            flush_ms.append((t2 - t1) * 1e3)
            per_flush.append((svc.stats["launches"] - stats0, registry.launches()["stat_scores"] - launches0))
        spans = session.spans(name="request")
        check(len(session.spans(name="update", kind="stacked-aot")) == 2 and not session.spans(name="degrade"),
              "slice 14: an instrumented ImageNet flush was not one stacked launch, or it degraded")
    for name in ("queue_us", "journal_us", "launch_us", "retire_us"):
        stage[name] = statistics.mean(e.attrs[name] for e in spans)
    total_stage = sum(stage.values())
    check(per_flush == [(1, 1)] * SLICE14_FLUSHES,
          f"slice 14: (stacked launches, stat_scores launches) a flush were {per_flush}, not (1, 1) each")
    check(registry.launches_by_shape("stat_scores") == {("sessions", (tenants, rows, c)): SLICE14_FLUSHES},
          f"slice 14: stat_scores ran {registry.launches_by_shape('stat_scores')}, not the session axis once a flush")
    check(registry.replayed_launches()["stat_scores"] == SLICE14_FLUSHES - 1,
          "slice 14: the flushes after the first were not graph replays")
    check(svc.stats["fallback_requests"] == 0, "slice 14: a request fell back to the eager path")
    t0 = time.perf_counter()
    values = svc.compute_all()  # the first read: its graph's capture included
    torch.cuda.synchronize()
    compute_all_ms = (time.perf_counter() - t0) * 1e3
    note_launches()  # the service's flushes and read; the references below are not the path's
    # the counts against a bincount on the host, and each tenant against a dedicated metric fed the same batches
    ref_counts = [slice14_counts_reference(torch, p, t, tenants, rows) for p, t in flushes]
    want = [sum(r[k] for r in ref_counts) for k in range(4)]
    for k, leaf in enumerate(("tp", "fp", "tn", "fn")):
        check(np.array_equal(svc._stacked[leaf][[svc._rows[n] for n in names]].cpu().numpy(), want[k]),
              f"slice 14: the service's {leaf} counts differ from the bincount reference")
    dedicated = [M.Accuracy(num_classes=c, average="macro", device=dev) for _ in names]
    for preds, target in flushes:
        for i, m in enumerate(dedicated):
            m.update(preds[i * rows:(i + 1) * rows], target[i * rows:(i + 1) * rows])
    for f, (preds, target) in enumerate(flushes):
        pc, tc = preds[: SLICE14_PREFIX * rows].cpu(), target[: SLICE14_PREFIX * rows].cpu()
        for i in range(SLICE14_PREFIX):
            cpu.submit(names[i], pc[i * rows:(i + 1) * rows], tc[i * rows:(i + 1) * rows])
        cpu.flush()
    check(svc.state_digest(names[:SLICE14_PREFIX]) == cpu.state_digest(),
          "slice 14: the first 64 tenants' state digest differs from the CPU run of the same stream")
    check(all(torch.equal(values[n], m.compute()) for n, m in zip(names, dedicated)),
          "slice 14: a tenant's value differs from a dedicated Accuracy fed the same batches")
    # the session axis's inputs at this flush, for part 4's timings
    p_last, t_last = flushes[-1]
    pred_cls = _predicted_classes(p_last).reshape(tenants, rows).contiguous()
    target_cls = t_last.to(torch.int32).reshape(tenants, rows).contiguous()
    session_inputs = (target_cls, pred_cls, (pred_cls == target_cls).contiguous(),
                      torch.ones(tenants, rows, dtype=torch.int32, device=dev))
    warm = flush_ms[1:-2]
    slo = svc.slo_snapshot()["totals"]["e2e_us"]

    def warm_flush():
        preds, target = flushes[1]
        for i, n in enumerate(names):
            svc.submit(n, preds[i * rows:(i + 1) * rows], target[i * rows:(i + 1) * rows])
        svc.drain()

    # a warm flush of the same signature, after the checks: its host syncs, and the device's busy share
    syncs = syncs_per_call(torch, warm_flush)
    busy = device_busy(torch, warm_flush, steps=2)
    # a warm read of every tenant (each made dirty by a warm flush), beside its graph's replay alone and the
    # same program's body run eagerly
    read = {"compute_all_ms": [], "replay_ms": [], "eager_body_ms": []}
    program = svc._compute_stack[tenants]
    idx = program.idx.cpu().numpy()
    for _ in range(3):
        warm_flush()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.compute_all()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        svc._compute_rows(idx)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with tracing():
            copy_tensors(program.body(svc._phys, program.idx))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, dt in zip(read, (t1 - t0, t2 - t1, t3 - t2)):
            read[k].append(dt * 1e3)
    registry.reset_launches()  # the measurements' launches are not the path's
    del flushes
    report["A_imagenet_service"] = {
        "tenants": tenants, "rows_a_submit": rows, "flushes": SLICE14_FLUSHES,
        "first_flush_ms": flush_ms[0], "warm_flush_ms_median": statistics.median(warm),
        "warm_flush_ms": warm, "capture_ms": flush_ms[0] - statistics.median(warm),
        "instrumented_flush_ms": flush_ms[-2:], "submit_ms_a_flush_median": statistics.median(submit_ms),
        "session_updates_per_s": tenants / (statistics.median(warm) / 1e3),
        "e2e_us_p50": slo["p50"], "e2e_us_p99": slo["p99"],
        "stage_us_mean": stage, "stage_share": {k: v / total_stage for k, v in stage.items()},
        "first_compute_all_ms": compute_all_ms, "warm_read_ms": read,
        "host_syncs_a_flush": len(syncs), "host_sync_sites": syncs,
        "busy": busy,
    }
    laps.mark("3. slice 14 A: the ImageNet-1k service, 1,024 tenants")

    # the ragged wave (1-256 rows a tenant in 1-3 requests, coalesced) and the forward wave
    rng = np.random.RandomState(SEED + 14)
    svc2 = MetricsService(M.Accuracy(num_classes=c, average="macro", device=dev))
    refs2 = [M.Accuracy(num_classes=c, average="macro", device=dev) for _ in names]
    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    totals_rows = rng.randint(1, 257, tenants)
    buckets, merges = set(), 0
    for i, n in enumerate(names):
        k = min(int(rng.randint(1, 4)), int(totals_rows[i]))
        cuts = np.sort(rng.choice(np.arange(1, totals_rows[i]), k - 1, replace=False)) if k > 1 else []
        sizes = np.diff(np.concatenate([[0], cuts, [totals_rows[i]]])).astype(int)
        merges += k - 1
        buckets.add(max(8, 1 << (int(totals_rows[i]) - 1).bit_length()))
        for s in sizes:
            p, t = top1_scores(torch, g, int(s), c)
            svc2.submit(n, p, t)
            refs2[i].update(p, t)
    registry.reset_launches()
    svc2.drain()
    check(svc2.stats["launches"] == len(buckets) and svc2.stats["coalesced_requests"] == merges
          and svc2.stats["fallback_requests"] == 0,
          f"slice 14: the ragged wave made {svc2.stats['launches']} launches and {svc2.stats['coalesced_requests']} "
          f"merges, not {len(buckets)} and {merges}")
    ragged_values = svc2.compute_all()
    fwd = names[:SLICE14_FORWARD]
    batches = [top1_scores(torch, g, rows, c) for _ in fwd]
    tickets = [svc2.submit(n, p, t, return_value=True) for n, (p, t) in zip(fwd, batches)]
    svc2.drain()
    note_launches()
    check(all(torch.equal(ragged_values[n], m.compute()) for n, m in zip(names, refs2)),
          "slice 14: a tenant of the ragged wave differs from its dedicated Accuracy")
    for ticket, (p, t) in zip(tickets, batches):
        fresh = M.Accuracy(num_classes=c, average="macro", device=dev)
        fresh.update(p, t)
        check(torch.equal(ticket.result(timeout=60), fresh.compute()),
              "slice 14: a forward ticket's value differs from a fresh Accuracy on its batch")
    check(svc2.stats["launches"] == len(buckets) + 1, "slice 14: the forward wave was not one stacked launch")
    registry.reset_launches()
    report["A_ragged_and_forward"] = {"ragged_launches": len(buckets), "coalesced_requests": merges,
                                      "forward_tickets": len(fwd)}
    del svc2, refs2
    laps.mark("3. slice 14 A: ragged and forward waves")

    # ----------------------------------------------------------- B. per-advertiser heavy hitters on the click log
    cm_tenants, cm_ids, cm_flushes = SLICE14_CM_TENANTS, SLICE14_CM_IDS, 2
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    click = [zipf_ids(torch, g, cm_tenants * cm_ids) for _ in range(cm_flushes)]
    svc3 = MetricsService(M.CountMinHeavyHitters(depth=CLICK_DEPTH, width=1024, device=dev))
    sketches = [M.CountMinHeavyHitters(depth=CLICK_DEPTH, width=1024, device=dev) for _ in range(cm_tenants)]
    registry.reset_launches()
    cm_per_flush, cm_ms = [], []
    with telemetry.instrument() as session:
        for ids in click:
            before = registry.launches()["countmin"]
            for i in range(cm_tenants):
                svc3.submit(f"adv{i}", ids[i * cm_ids:(i + 1) * cm_ids])
            t0 = time.perf_counter()
            svc3.drain()
            torch.cuda.synchronize()
            cm_ms.append((time.perf_counter() - t0) * 1e3)
            cm_per_flush.append(registry.launches()["countmin"] - before)
    check(cm_per_flush == [1] * cm_flushes and registry.replayed_launches()["countmin"] == 1
          and registry.launches_by_shape("countmin") == {("sessions", (cm_tenants, cm_ids, CLICK_DEPTH, 1024)): 2},
          f"slice 14: countmin ran {cm_per_flush} times a flush ({registry.replayed_launches()['countmin']} "
          f"replayed), not its session axis once each, the second a replay")
    check(svc3.stats["launches"] == cm_flushes and svc3.stats["fallback_requests"] == 0
          and not session.spans(name="degrade"), "slice 14: the heavy-hitter flushes degraded or fell back")
    note_launches()
    for ids in click:
        for i, sk in enumerate(sketches):
            sk.update(ids[i * cm_ids:(i + 1) * cm_ids])
    registry.reset_launches()
    host_ids = [x.cpu().numpy() for x in click]
    for i, sk in enumerate(sketches):
        table = svc3._stacked["value"][svc3._rows[f"adv{i}"]]
        check(torch.equal(table, sk.value), f"slice 14: advertiser {i}'s table differs from a dedicated sketch")
        if i < SLICE14_CM_NUMPY:
            ref = numpy_countmin(np.concatenate([x[i * cm_ids:(i + 1) * cm_ids] for x in host_ids]), CLICK_DEPTH, 1024)
            check(np.array_equal(table.double().cpu().numpy(), ref),
                  f"slice 14: advertiser {i}'s table differs from numpy's")
    report["B_heavy_hitters"] = {"tenants": cm_tenants, "ids_a_submit": cm_ids, "flush_ms": cm_ms,
                                 "countmin_a_flush": cm_per_flush}
    del svc3, sketches, click
    laps.mark("3. slice 14 B: per-advertiser heavy hitters")

    # ----------------------------------------------------------- C. a windowed service
    w_tenants, w_ticks = SLICE14_WINDOW_TENANTS, SLICE14_WINDOW_TICKS
    svc4 = MetricsService(M.SlidingWindow(M.Accuracy(num_classes=c, average="macro", device=dev),
                                          window=MONITOR_WINDOW))
    check(svc4.coalesce is False, "slice 14: a windowed service coalesces")
    windows = [M.SlidingWindow(M.Accuracy(num_classes=c, average="macro", device=dev), window=MONITOR_WINDOW)
               for _ in range(w_tenants)]
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    w_ms, ticks = [], [top1_scores(torch, g, w_tenants * rows, c) for _ in range(w_ticks)]
    registry.reset_launches()
    for p, t in ticks:
        for i in range(w_tenants):
            svc4.submit(f"w{i}", p[i * rows:(i + 1) * rows], t[i * rows:(i + 1) * rows])
        t0 = time.perf_counter()
        svc4.drain()
        torch.cuda.synchronize()
        w_ms.append((time.perf_counter() - t0) * 1e3)
    wvals = svc4.compute_window()
    note_launches()
    for p, t in ticks:
        for i in range(w_tenants):
            windows[i].update(p[i * rows:(i + 1) * rows], t[i * rows:(i + 1) * rows])
    check(all(torch.equal(wvals[f"w{i}"], w.compute()) for i, w in enumerate(windows)),
          "slice 14: a windowed tenant's value differs from a dedicated SlidingWindow")
    check(svc4.stats["launches"] == w_ticks and svc4.stats["fallback_requests"] == 0,
          "slice 14: the windowed service did not make one stacked launch a tick")
    registry.reset_launches()
    report["C_window"] = {"tenants": w_tenants, "ticks": w_ticks, "window": MONITOR_WINDOW, "flush_ms": w_ms}
    del svc4, windows, ticks
    laps.mark("3. slice 14 C: a windowed service")

    # ----------------------------------------------------------- D. durability on the card
    with tempfile.TemporaryDirectory(prefix="slice14-") as root:
        env = dict(os.environ, METRICS_TPU_WAL_SEGMENT_BYTES=str(1 << 20))
        env.pop("METRICS_TPU_CRASH", None)
        here = os.path.abspath(__file__)

        def start(phase, work, crash=None):
            e = dict(env, METRICS_TPU_CRASH=crash) if crash else env
            return subprocess.Popen([sys.executable, here, "--slice14-worker", phase, work, str(dev)], env=e,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        def finish(proc):
            try:
                out, err = proc.communicate(timeout=SLICE14_WORKER_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            return proc.returncode, out, err

        def result(rc, out, err, what):
            check(rc == 0, f"slice 14: the {what} worker failed (rc {rc}): {err[-2000:]}")
            return json.loads(out.strip().splitlines()[-1])

        procs = {"twin": start("run", os.path.join(root, "twin"))}
        for point, nth in SLICE14_CRASH_NTH.items():
            procs[point] = start("run", os.path.join(root, point), crash=f"{point}:{nth}")
        done = {k: finish(p) for k, p in procs.items()}
        twin = result(*done.pop("twin"), "twin")
        for point, (rc, out, err) in done.items():
            check(rc in (-9, 137) and not out.strip(), f"slice 14: crash point {point} did not kill its worker "
                  f"(rc {rc}): {err[-2000:]}")
        recs = {p: start("recover", os.path.join(root, p)) for p in SLICE14_CRASH_NTH}
        recovered = {p: result(*finish(proc), f"{p} recovery") for p, proc in recs.items()}
    for point, got in recovered.items():
        check(got["digest"] == twin["digest"] and got["last_seq"] == twin["last_seq"],
              f"slice 14: the recovery after {point} differs from the never-killed twin")
    report["D_durability"] = {
        "tenants": SLICE14_DURABLE_TENANTS, "ops": SLICE14_DURABLE_OPS, "rows": SLICE14_DURABLE_ROWS,
        "twin": twin, "recovered": recovered,
        "journal_us_median": twin["journal_us_median"], "frame_write_us_median": twin["frame_write_us_median"],
        "checkpoint_ms_median": twin["checkpoint_ms_median"],
        "recovery_to_first_result_ms": {p: r["recovery_to_first_result_ms"] for p, r in recovered.items()},
    }
    laps.mark("3. slice 14 D: the crash matrix on the card")

    # ----------------------------------------------------------- E. admission
    adm = {}
    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    burst = [top1_scores(torch, g, rows, c) for _ in range(2 * SLICE14_MAX_QUEUE)]
    for policy in ("reject", "shed-oldest"):
        svc5 = MetricsService(M.Accuracy(num_classes=c, average="macro", device=dev), max_queue=SLICE14_MAX_QUEUE,
                              admission=policy)
        refused = 0
        with telemetry.instrument() as session:
            for i, (p, t) in enumerate(burst):
                try:
                    svc5.submit(f"t{i % 32}", p, t)
                except QueueFullError:
                    refused += 1
            svc5.drain()
        cause = "queue-full-reject" if policy == "reject" else "queue-full-shed"
        degrades = session.spans(name="degrade", kind="admission")
        requests = session.spans(name="request")
        slo = svc5.slo_snapshot()["totals"]
        refused = refused if policy == "reject" else svc5.stats["shed_requests"]
        admitted = len(burst) - (refused if policy == "reject" else 0)
        check(refused == SLICE14_MAX_QUEUE and len(degrades) == refused
              and all(e.attrs["cause"] == cause for e in degrades),
              f"slice 14: {policy}: {refused} refused with {len(degrades)} degrade spans")
        check(len(requests) == admitted == svc5.stats["submits"]
              and slo["served"] == SLICE14_MAX_QUEUE and slo["rejected" if policy == "reject" else "shed"] == refused,
              f"slice 14: {policy}: {len(requests)} request spans, {svc5.stats['submits']} admitted, slo {slo}")
        adm[policy] = {"refused": refused, "request_spans": len(requests), "served": slo["served"]}
        note_launches()
    report["E_admission"] = adm
    laps.mark("3. slice 14 E: admission")
    check(sum(resilience.degrades().values()) == degrades0, "slice 14: an engine or the service degraded")
    report["path_launches"] = {name: {"total": totals[name], "by_branch_and_shape": {str(k): v for k, v in
                                                                                  by_shape14[name].items()}}
                               for name in totals}
    print(f"slice 14 ({card}): " + json.dumps(report, default=lambda o: o.tolist() if hasattr(o, "tolist") else str(o)))
    return totals, by_shape14, session_inputs


def fleet_names(shard_for, shards, per_shard, prefix="t"):
    """``per_shard`` session names for each of ``shards`` shards, in the order
    they were drawn (``prefix`` and a counter): a fleet whose shards hold the
    same number of tenants, so its session bucket is the per-shard count."""
    names, counts, i = [], [0] * shards, 0
    while min(counts) < per_shard:
        name, i = f"{prefix}{i}", i + 1
        k = shard_for(name)
        if counts[k] < per_shard:
            counts[k] += 1
            names.append(name)
    return names


def slice15_ops():
    """Slice 15 E's global op stream: updates round-robin over the sessions, one close and one reset."""
    ops = []
    for i in range(SLICE15_CHAOS_OPS):
        if i == 20:
            ops.append(("close", "s1"))
        elif i == 33:
            ops.append(("reset", "s3"))
        else:
            ops.append(("update", f"s{i % SLICE15_CHAOS_SESSIONS}", i))
    return ops


def slice15_worker(phase, root, shard, nshards, device):
    """``python3 chip_smoke.py --slice15-worker {run|recover} ROOT SHARD NSHARDS DEVICE``:
    one shard of slice 15 E's fleet on ``DEVICE``, a journaled ImageNet-width
    service (fsync on, a checkpoint every 2 flushes, a keep-last-1 ladder) that
    runs the ops of the global stream whose session the ring gives its shard,
    shipping its journal to an in-process standby after every op; ``recover``
    fences the directory one epoch higher, recovers and finishes the slice.
    Prints one JSON line: the partition's digest and values, the journal's
    high-water mark and the epoch."""
    import torch

    from metrics_tpu_torch import Accuracy, wal
    from metrics_tpu_torch.fabric import HashRing
    from metrics_tpu_torch.serve import HistoryPolicy, MetricsService

    dev, shard, nshards = torch.device(device), int(shard), int(nshards)
    ring = HashRing(list(range(nshards)))
    base = os.path.join(root, f"shard-{shard:02d}")
    journal_dir = os.path.join(base, "wal")
    make = lambda: Accuracy(num_classes=NUM_CLASSES, average="macro", device=dev)  # noqa: E731
    svc = MetricsService(make(), journal_dir=journal_dir, checkpoint_dir=os.path.join(base, "ckpt"),
                         checkpoint_every=2, history=HistoryPolicy(keep_last=1), shard_id=shard, rid_offset=shard,
                         rid_stride=nshards, epoch=wal.read_epoch(journal_dir) + 1)
    t_start = time.perf_counter()
    start_seq, first_result_ms = 0, None
    if phase == "recover":
        svc.recover()
        start_seq = svc.journal.last_seq
        if svc.session_count:
            svc.compute(sorted(svc._rows)[0])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        first_result_ms = (time.perf_counter() - t_start) * 1e3
    standby = wal.StandbyReplica(MetricsService(make(), shard_id=shard, rid_offset=shard, rid_stride=nshards),
                                 source_shard=shard) if phase == "run" else None

    def ship():
        if standby is not None:
            standby.apply(svc.journal.stream_since(standby.cursor), svc.replication_floor())

    closed, local = set(), 0
    for op in slice15_ops():
        name = op[1]
        if ring.owner(name) != shard:
            continue
        local += 1
        if local <= start_seq:  # durable before the kill: applied by the replay
            if op[0] == "close":
                closed.add(name)
            elif op[0] == "update":
                closed.discard(name)
            continue
        if op[0] == "update":
            if name in closed:
                svc.open_session(name)
                closed.discard(name)
            g = torch.Generator(device=dev).manual_seed(1500 + op[2])
            svc.submit(name, *top1_scores(torch, g, SLICE15_CHAOS_ROWS, NUM_CLASSES))
        elif op[0] == "close":
            svc.close_session(name)
            closed.add(name)
        else:
            svc.reset_session(name)
        ship()
        if local % 4 == 0:
            svc.flush()
            ship()
    svc.drain()
    ship()
    if standby is not None and standby.digest() != svc.state_digest():
        raise SystemExit(f"the standby of shard {shard} diverged from its primary")
    values = {n: v.cpu().numpy().tobytes().hex() for n, v in sorted(svc.compute_all().items())}
    print(json.dumps({"digest": svc.state_digest(), "values": values, "last_seq": svc.journal.last_seq,
                      "epoch": svc.epoch, "shard": shard, "recovery_to_first_result_ms": first_result_ms,
                      "replayed_records": svc.stats["replayed_records"]}))
    return 0


def run_slice15(torch, dev, laps):
    """Slice 15 (see the module's docstring): returns the kernels' launches on its
    path and by shape, and the session axis of ``countmin``'s inputs at the
    heavy-hitter fleet's flush."""
    import tempfile

    import metrics_tpu_torch as M
    from metrics_tpu_torch import faults, resilience, telemetry
    from metrics_tpu_torch.fabric import ShardedMetricsService, StaleEpochError
    from metrics_tpu_torch.ops import registry
    from metrics_tpu_torch.ops.sketch_ops import _countmin_sessions_plain, countmin_update_sessions
    from metrics_tpu_torch.serve import HistoryPolicy, MetricsService
    from metrics_tpu_torch.streaming.sketch import _key_bits

    totals = {"stat_scores": 0, "countmin": 0}
    by_shape15 = {name: {} for name in totals}

    def note_launches():
        for name in totals:
            totals[name] += registry.launches()[name]
            by_shape15[name] = merged(by_shape15[name], registry.launches_by_shape(name))
        registry.reset_launches()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    report = {"card": card}
    c, rows, shards = NUM_CLASSES, SLICE15_ROWS, SLICE15_SHARDS
    make = lambda d=dev: M.Accuracy(num_classes=c, average="macro", device=d)  # noqa: E731
    replay = torch.cuda.CUDAGraph.replay

    @contextlib.contextmanager
    def replays_counted():
        seen = []
        torch.cuda.CUDAGraph.replay = lambda self: (seen.append(self), replay(self))[1]
        try:
            yield seen
        finally:
            torch.cuda.CUDAGraph.replay = replay

    def digests_equal(fab, ref, what):
        note_launches()  # the path's launches so far; the reference's reads below are not the path's
        for s in fab._shards:
            if not s.retired:
                check(s.service.state_digest() == ref.state_digest(sorted(s.service._rows)),
                      f"slice 15: {what}: shard {s.shard_id}'s digest differs from the uncrashed twin's")
        registry.reset_launches()

    # ----------------------------------------------------------- A. the fleet
    registry.reset_launches()
    degrades0 = dict(resilience.degrades())
    fab = ShardedMetricsService(make(), num_shards=shards)
    single = MetricsService(make())
    names = fleet_names(fab.shard_for, shards, SLICE15_TENANTS)
    tenants = len(names)
    by_shard = [[n for n in names if fab.shard_for(n) == k] for k in range(shards)]
    g = torch.Generator(device=dev).manual_seed(SEED + 150)
    want = None
    flush_ms, per_flush = [], []
    for f in range(SLICE15_FLUSHES):
        preds, target = top1_scores(torch, g, tenants * rows, c)
        launches0 = registry.launches()["stat_scores"]
        t0 = time.perf_counter()
        for i, name in enumerate(names):
            fab.submit(name, preds[i * rows:(i + 1) * rows], target[i * rows:(i + 1) * rows])
        t1 = time.perf_counter()
        fab.drain()
        torch.cuda.synchronize()
        flush_ms.append({"submit_ms": (t1 - t0) * 1e3, "drain_ms": (time.perf_counter() - t1) * 1e3})
        per_flush.append(registry.launches()["stat_scores"] - launches0)
        note_launches()  # the fleet's flushes; the single service below is the reference
        for i, name in enumerate(names):
            single.submit(name, preds[i * rows:(i + 1) * rows], target[i * rows:(i + 1) * rows])
        single.drain()
        counts = slice14_counts_reference(torch, preds, target, tenants, rows)
        want = counts if want is None else tuple(a + b for a, b in zip(want, counts))
        registry.reset_launches()
        if f == 0:
            first_batch = (preds[:rows].clone(), target[:rows].clone())
        del preds, target
    check(per_flush == [shards] * SLICE15_FLUSHES, f"slice 15 A: stat_scores ran {per_flush} times a fleet flush, "
          f"not once a shard")
    check(all(s.service.stats["launches"] == SLICE15_FLUSHES and s.service.stats["fallback_requests"] == 0
              for s in fab._shards), "slice 15 A: a shard's flush was not one stacked launch")
    position = {n: i for i, n in enumerate(names)}
    for s in fab._shards:
        svc = s.service
        own = sorted(svc._rows)
        idx = [position[n] for n in own]
        for k, leaf in enumerate(("tp", "fp", "tn", "fn")):
            check(np.array_equal(svc._stacked[leaf][[svc._rows[n] for n in own]].cpu().numpy(), want[k][idx]),
                  f"slice 15 A: shard {s.shard_id}'s {leaf} counts differ from the bincount reference")
    digests_equal(fab, single, "A")
    with telemetry.instrument() as session:
        t0 = time.perf_counter()
        values = fab.compute_all()  # the first read: its capture included
        torch.cuda.synchronize()
        first_read_ms = (time.perf_counter() - t0) * 1e3
    note_launches()
    check(len(session.spans(name="compile", kind="fleet-read")) == 1 and len(fab._fleet_programs) == 1,
          "slice 15 A: the first fleet read did not build one program")
    compile_span = session.spans(name="compile", kind="fleet-read")[0].attrs
    sample = names[::max(1, tenants // SLICE15_VALUE_SAMPLE)]
    check(all(torch.equal(values[n], single.compute(n)) for n in sample),
          "slice 15 A: a fleet read value differs from the single service fed the same stream")
    (program,) = fab._fleet_programs.values()

    def dirty():  # every tenant dirty for the next read, without touching the device
        for s in fab._shards:
            s.service._memo.clear()

    read = {"fleet_read_ms": [], "fan_out_ms": []}
    dirty()
    for s in fab._shards:  # the per-shard reads' own captures, one shard after another
        s.service.compute_all()
    laps.mark("3. slice 15 A: the fleet's flushes, its first read, the per-shard reads' captures")
    for _ in range(3):
        dirty()
        torch.cuda.synchronize()
        with replays_counted() as seen:
            t0 = time.perf_counter()
            warm = fab.compute_all()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        check(seen == [program.graph], f"slice 15 A: a warm fleet read made {len(seen)} graph replays, not the "
              "fleet program's one")
        dirty()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fanned = {}
        for part in fab._fan_out(lambda s: s.service.compute_all(), fab._shards):
            fanned.update(part)
        torch.cuda.synchronize()
        read["fleet_read_ms"].append((t1 - t0) * 1e3)
        read["fan_out_ms"].append((time.perf_counter() - t2) * 1e3)
    check(all(torch.equal(warm[n], values[n]) and torch.equal(fanned[n], values[n]) for n in names),
          "slice 15 A: a warm fleet read or the per-shard fan-out differs from the first read")
    check(resilience.degrades().get("fleet-read", 0) == degrades0.get("fleet-read", 0),
          "slice 15 A: a fleet read degraded")
    busy = device_busy(torch, lambda: (dirty(), fab.compute_all()), steps=1)
    t0 = time.perf_counter()
    rolled = fab.rollup()
    torch.cuda.synchronize()
    rollup_ms = (time.perf_counter() - t0) * 1e3
    tmpl = fab._shards[0].service.template
    dtype = fab._shards[0].service._stacked["tp"].dtype
    summed = {leaf: torch.from_numpy(want[k].sum(axis=0)).to(dtype).to(dev)
              for k, leaf in enumerate(("tp", "fp", "tn", "fn"))}
    check(torch.equal(rolled, tmpl.pure_compute(summed)),
          "slice 15 A: the fleet roll-up differs from the template's compute of numpy's summed counts")
    registry.reset_launches()
    report["A_fleet"] = {
        "shards": shards, "tenants_a_shard": SLICE15_TENANTS, "rows_a_submit": rows, "flushes": SLICE15_FLUSHES,
        "flush_ms": flush_ms, "first_read_ms_with_capture": first_read_ms,
        "warm_fleet_read_ms": read["fleet_read_ms"], "warm_fleet_read_ms_median": statistics.median(read["fleet_read_ms"]),
        "fan_out_read_ms": read["fan_out_ms"], "fan_out_read_ms_median": statistics.median(read["fan_out_ms"]),
        "fleet_read_degrades": 0, "fleet_program_cost": {k: compile_span.get(k) for k in ("cost_flops", "cost_bytes")},
        "rollup_ms": rollup_ms, "busy": busy,
    }
    fab.shutdown()
    del fab, single, values, warm, fanned
    laps.mark("3. slice 15 A: the four-shard ImageNet fleet")

    # ----------------------------------------------------------- B. the heavy-hitter fleet
    cm = ShardedMetricsService(M.CountMinHeavyHitters(depth=CLICK_DEPTH, width=1024, device=dev), num_shards=shards)
    advertisers = fleet_names(cm.shard_for, shards, SLICE15_CM_TENANTS, prefix="adv")
    g = torch.Generator(device=dev).manual_seed(SEED + 151)
    clicks = [zipf_ids(torch, g, len(advertisers) * SLICE15_CM_IDS) for _ in range(SLICE15_CM_FLUSHES)]
    ids_of = {n: i for i, n in enumerate(advertisers)}
    registry.reset_launches()
    shard_flush_ms, cm_per_flush = [], []
    cm_inputs = None
    for f, ids in enumerate(clicks):
        for i, n in enumerate(advertisers):
            cm.submit(n, ids[i * SLICE15_CM_IDS:(i + 1) * SLICE15_CM_IDS])
        for s in cm._shards:
            if f == SLICE15_CM_FLUSHES - 1 and s.shard_id == 0:  # the session axis's inputs at this flush
                svc = s.service
                own = sorted(svc._rows)
                keys = torch.stack([ids[ids_of[n] * SLICE15_CM_IDS:(ids_of[n] + 1) * SLICE15_CM_IDS] for n in own])
                before = svc._stacked["value"][[svc._rows[n] for n in own]].clone()
                cm_inputs = (before, _key_bits(keys).contiguous(), torch.ones_like(keys), svc.template._seeds())
            before_n = registry.launches()["countmin"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.service.drain()
            torch.cuda.synchronize()
            shard_flush_ms.append({"flush": f, "shard": s.shard_id, "ms": (time.perf_counter() - t0) * 1e3})
            cm_per_flush.append(registry.launches()["countmin"] - before_n)
    cm_replayed = registry.replayed_launches()["countmin"]
    cm_shape = registry.launches_by_shape("countmin")
    note_launches()
    check(cm_per_flush == [1] * (shards * SLICE15_CM_FLUSHES),
          f"slice 15 B: countmin ran {cm_per_flush} times a shard flush, not once")
    check(cm_shape == {("sessions", (SLICE15_CM_TENANTS, SLICE15_CM_IDS, CLICK_DEPTH, 1024)): shards * SLICE15_CM_FLUSHES}
          and cm_replayed == shards * (SLICE15_CM_FLUSHES - 1),
          f"slice 15 B: countmin ran {cm_shape} ({cm_replayed} replayed), not the session axis once a shard flush")
    host = [x.cpu().numpy() for x in clicks]
    for n in advertisers[::max(1, len(advertisers) // SLICE15_CM_NUMPY)]:
        svc = cm._shards[cm.shard_for(n)].service
        i = ids_of[n]
        ref = numpy_countmin(np.concatenate([x[i * SLICE15_CM_IDS:(i + 1) * SLICE15_CM_IDS] for x in host]),
                             CLICK_DEPTH, 1024)
        check(np.array_equal(svc._stacked["value"][svc._rows[n]].double().cpu().numpy(), ref),
              f"slice 15 B: {n}'s table differs from numpy's count-min")
    sess_got = countmin_update_sessions(*cm_inputs)
    sess_ref = _countmin_sessions_plain(*cm_inputs)
    registry.reset_launches()
    check(torch.equal(sess_got, sess_ref), "slice 15 B: countmin's session axis differs from its plain version")
    check(torch.equal(sess_got, cm._shards[0].service._stacked["value"][
        [cm._shards[0].service._rows[n] for n in sorted(cm._shards[0].service._rows)]]),
          "slice 15 B: shard 0's tables differ from the session axis on its last flush's inputs")
    warm_shard = [r["ms"] for r in shard_flush_ms if r["flush"] > 0]
    report["B_heavy_hitters"] = {
        "shards": shards, "tenants_a_shard": SLICE15_CM_TENANTS, "ids_a_submit": SLICE15_CM_IDS,
        "countmin_a_shard_flush": cm_per_flush, "shard_flush_ms": shard_flush_ms,
        "warm_shard_flush_ms_median": statistics.median(warm_shard),
        "slice14_warm_flush_ms_256_launches": 28.1, "max_abs_err": float((sess_got - sess_ref).abs().max()),
    }
    cm.shutdown()
    del cm, clicks, host
    laps.mark("3. slice 15 B: the heavy-hitter fleet")

    # ----------------------------------------------------------- C. failover and membership
    c_report = {}
    with tempfile.TemporaryDirectory(prefix="slice15-") as root:
        fc = ShardedMetricsService(make(), num_shards=shards, data_dir=os.path.join(root, "c"))
        fs = ShardedMetricsService(make(), num_shards=shards, data_dir=os.path.join(root, "s"), standby=True)
        twin = MetricsService(make())
        c_names = fleet_names(fc.shard_for, shards, SLICE15_C_TENANTS, prefix="c")
        g = torch.Generator(device=dev).manual_seed(SEED + 152)
        c_rows = SLICE15_C_ROWS

        def c_flush(fleets, times=1):
            """``times`` flushes of every tenant on ``fleets`` (the path's launches), then the same on the twin
            (the reference's, not counted)."""
            for _ in range(times):
                p, t = top1_scores(torch, g, len(c_names) * c_rows, c)
                batches = [(n, p[i * c_rows:(i + 1) * c_rows], t[i * c_rows:(i + 1) * c_rows])
                           for i, n in enumerate(c_names)]
                for x in fleets:
                    for batch in batches:
                        x.submit(*batch)
                    x.drain()
                torch.cuda.synchronize()
                note_launches()
                for batch in batches:
                    twin.submit(*batch)
                twin.drain()
                torch.cuda.synchronize()
                registry.reset_launches()

        c_flush((fc, fs), 3)
        fc.checkpoint()
        fs.replicate()
        fs.replicate()
        c_flush((fc, fs), 2)
        # shard death: the next route to shard 1 finds it dead, fences its journal, replays it on a peer
        victim = 1
        zombie = fc._shards[victim].service
        probe_name = next(n for n in c_names if fc.shard_for(n) == victim)
        with faults.inject("shard-death", count=1, shard=victim):
            t0 = time.perf_counter()
            first = fc.compute(probe_name)
            torch.cuda.synchronize()
            death_ms = (time.perf_counter() - t0) * 1e3
        note_launches()  # the fence, the replay on a peer and the read
        event = fc.failover_events[-1]
        twin_first = twin.compute(probe_name)
        registry.reset_launches()
        check(event["cause"] == "killed" and event["shard"] == victim and torch.equal(first, twin_first),
              f"slice 15 C: the shard-death failover went wrong: {event}")
        p0, t0_ = first_batch
        try:
            zombie.submit(probe_name, p0[:c_rows], t0_[:c_rows])
            zombie.flush()
            check(False, "slice 15 C: the zombie's write was not refused")
        except StaleEpochError:
            pass
        digests_equal(fc, twin, "after shard death")
        c_report["shard_death"] = {"failover_ms": event["ms"], "first_recovered_result_ms": death_ms,
                                   "replayed_records": fc._shards[victim].service.stats["replayed_records"]}
        # the standby fleet: promote the standby of shard 2, replaying only the unshipped tail
        total = fs._shards[2].service.journal.last_seq
        shipped = fs._standbys[2].applied_seq
        fs.kill_shard(2)
        fs.fail_over(2)
        sevent = fs.failover_events[-1]
        check(sevent["standby"] and 0 < sevent["replayed"] <= total - shipped,
              f"slice 15 C: the standby promotion replayed {sevent.get('replayed')} records, the unshipped tail is "
              f"{total - shipped}")
        digests_equal(fs, twin, "after the standby promotion")
        c_report["standby"] = {"failover_ms": sevent["ms"], "replayed": sevent["replayed"],
                               "journal_records": total, "shipped": shipped}
        # add a shard and rebalance: about a fifth of the sessions move, their digests the twin's
        fc.add_shard()
        t0 = time.perf_counter()
        moved = fc.rebalance()["moved"]
        torch.cuda.synchronize()
        rebalance_ms = (time.perf_counter() - t0) * 1e3
        check(0 < len(moved) <= 2 * len(c_names) // (shards + 1) and all(fc.shard_for(n) == shards for n in moved),
              f"slice 15 C: the rebalance moved {len(moved)} of {len(c_names)} sessions")
        digests_equal(fc, twin, "after the rebalance")
        moved_values = fc.compute_all()
        note_launches()
        twin_values = twin.compute_all()
        registry.reset_launches()
        check(all(torch.equal(moved_values[n], twin_values[n]) for n in c_names),
              "slice 15 C: a value after the rebalance differs from the twin's")
        c_report["rebalance"] = {"moved": len(moved), "sessions": len(c_names), "ms": rebalance_ms}
        # a network partition: the fabric fences and fails the shard over; the old side's writes bounce
        part = 0
        zombie = fc._shards[part].service
        part_name = next(n for n in c_names if fc.shard_for(n) == part)
        with faults.inject("network-partition", count=1, shard=part):
            fc.compute(part_name)
        pevent = fc.failover_events[-1]
        check(pevent["cause"] == "partition" and pevent["shard"] == part, f"slice 15 C: partition event {pevent}")
        try:
            zombie.submit(part_name, p0[:c_rows], t0_[:c_rows])
            zombie.flush()
            check(False, "slice 15 C: the partitioned side's write was not refused")
        except StaleEpochError:
            pass
        c_flush((fc,), 1)
        digests_equal(fc, twin, "after the partition")
        c_report["partition"] = {"failover_ms": pevent["ms"]}
        fc.shutdown()
        fs.shutdown()
        # a slow shard: closed-loop requests, the slow one sleeping before each flush; the sweep quarantines it
        slow_fleet = ShardedMetricsService(make(), num_shards=shards, data_dir=os.path.join(root, "slow"),
                                           standby=True)
        slow_names = fleet_names(slow_fleet.shard_for, shards, 8, prefix="q")
        p, t = first_batch

        def closed_loop(n_ops):
            for i in range(n_ops):
                n = slow_names[i % len(slow_names)]
                svc = slow_fleet._route(n).service
                svc.submit(n, p[:c_rows], t[:c_rows])
                svc.flush()
                svc.drain()
            torch.cuda.synchronize()

        # enough fast requests a shard that its p99 (about its 10th longest) passes over stray pauses; the slow
        # phase's requests are more than 1% of the slow shard's
        closed_loop(SLICE15_SLOW_WARM * shards)
        slow_fleet.replicate()
        with faults.inject("shard-slow", count=10_000, shard=3, ms=SLICE15_SLOW_MS):
            closed_loop(SLICE15_SLOW_OPS * shards)
            suspects = slow_fleet.suspicion_sweep(min_requests=32)
        p99s = {s.shard_id: s.service.slo_snapshot()["totals"]["e2e_us"]["p99"] for s in slow_fleet._shards}
        check(suspects == [3] and slow_fleet.failover_events[-1]["cause"] == "suspect-slow",
              f"slice 15 C: the suspicion sweep quarantined {suspects} (p99 µs by shard {p99s})")
        c_report["slow_shard"] = {"quarantined": suspects, "p99_us_by_shard": p99s,
                                  "failover_ms": slow_fleet.failover_events[-1]["ms"]}
        slow_fleet.shutdown()
    note_launches()
    report["C_failover_and_membership"] = c_report
    laps.mark("3. slice 15 C: failover and membership")

    # ----------------------------------------------------------- D. time travel
    with tempfile.TemporaryDirectory(prefix="slice15-tt-") as root:
        tt = MetricsService(make(), journal_dir=os.path.join(root, "wal"), checkpoint_dir=os.path.join(root, "ckpt"),
                            history=HistoryPolicy(keep_last=4, keep_per_interval_s=SLICE15_TT_INTERVAL_S))
        tt_names = [f"e{i}" for i in range(SLICE15_TT_TENANTS)]
        g = torch.Generator(device=dev).manual_seed(SEED + 153)
        ops = []  # (name, preds, target) in journal order: op i is seq i + 1
        rounds_ms = []
        for r in range(SLICE15_TT_ROUNDS):
            who = tt_names if r == 0 else [tt_names[(r * SLICE15_TT_ROUND_TENANTS + j) % len(tt_names)]
                                           for j in range(SLICE15_TT_ROUND_TENANTS)]
            p, t = top1_scores(torch, g, len(who) * SLICE15_TT_ROWS, c)
            t0 = time.perf_counter()
            for i, n in enumerate(who):
                batch = (p[i * SLICE15_TT_ROWS:(i + 1) * SLICE15_TT_ROWS], t[i * SLICE15_TT_ROWS:(i + 1) * SLICE15_TT_ROWS])
                tt.submit(n, *batch)
                ops.append((n,) + batch)
            tt.drain()
            tt.checkpoint()
            rounds_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        rungs = tt._ladder_rungs()
        check(tt.stats["checkpoints"] == SLICE15_TT_ROUNDS and len(rungs) >= 4,
              f"slice 15 D: {tt.stats['checkpoints']} checkpoints left {len(rungs)} rungs")
        check(all(tt.journal.first_seq() <= fence + 1 for fence, _ in rungs), "slice 15 D: a rung lost its replay tail")
        records = tt.journal.read_tail(0)
        rung_ts = [float(tt._rung_meta(path)["ts"]) for _, path in rungs]
        # instants inside the retained horizon: the rungs', and records' past the oldest rung's fence
        later = [r for r in records if r.seq > rungs[0][0]]
        instants = sorted(rung_ts[:3] + [later[len(later) // 3].ts, later[2 * len(later) // 3].ts,
                                         later[-1].ts])[:SLICE15_TT_INSTANTS]
        twin = MetricsService(make())
        fed = 0
        at_ms = []
        for when in instants:
            t0 = time.perf_counter()
            scratch, fence = tt.service_at(when)
            probe = min(scratch._rows, default=None)
            value = None if probe is None else scratch.compute(probe)
            torch.cuda.synchronize()
            at_ms.append((time.perf_counter() - t0) * 1e3)
            note_launches()  # the rebuild from a rung and its replay, and the read; the twin is the reference
            for n, p_, t_ in ops[fed:fence]:
                twin.submit(n, p_, t_)
            fed = max(fed, fence)
            twin.drain()
            check(scratch.state_digest() == twin.state_digest(),
                  f"slice 15 D: compute_at at fence {fence} differs from the twin at the same journal prefix")
            check(value is None or torch.equal(value, twin.compute(probe)),
                  f"slice 15 D: a value at fence {fence} differs from the twin's")
            registry.reset_launches()
            scratch.shutdown()
        t1, t2 = later[len(later) // 4].ts, later[len(later) // 2].ts
        picked = [r.seq for r in records if r.ts is not None and t1 < r.ts <= t2]
        ranged = tt.compute_range(t1, t2)
        torch.cuda.synchronize()
        note_launches()
        window = MetricsService(make())  # the reference: a service fed the window's records
        for seq in picked:
            window.submit(*ops[seq - 1])
        window.drain()
        window_values = window.compute_all()
        check(sorted(ranged) == sorted(window_values) and all(torch.equal(ranged[n], window_values[n])
                                                              for n in window_values),
              "slice 15 D: compute_range differs from a service fed the window's records")
        for n, p_, t_ in ops[fed:]:
            twin.submit(n, p_, t_)
        twin.drain()
        torch.cuda.synchronize()
        registry.reset_launches()
        # a rung born corrupt: reads fall back to an older rung, scrub quarantines it
        with faults.inject("history-corruption", count=1):
            tt.checkpoint()
        bad = tt._ladder_rungs()[-1][1]
        with telemetry.instrument() as session:
            scratch, fence = tt.service_at(time.time())
        note_launches()
        check(session.spans(name="degrade", kind="history") and scratch.state_digest() == twin.state_digest(),
              "slice 15 D: a read past the corrupt rung did not fall back to a verified one")
        registry.reset_launches()
        scratch.shutdown()
        report_scrub = tt.scrub()
        check(report_scrub["quarantined"] == [bad] and os.path.exists(bad + ".quarantine"),
              f"slice 15 D: scrub reported {report_scrub}")
        report["D_time_travel"] = {
            "tenants": SLICE15_TT_TENANTS, "checkpoints": tt.stats["checkpoints"], "rungs": len(rungs),
            "journal_records_retained": len(records), "round_ms": rounds_ms, "compute_at_ms": at_ms,
            "compute_range_records": len(picked), "scrub": {k: report_scrub[k] for k in ("checked", "newest_verified")},
        }
        tt.shutdown()
        twin.shutdown()
    note_launches()
    laps.mark("3. slice 15 D: time travel")

    # ----------------------------------------------------------- E. the subprocess crash matrix on the card
    with tempfile.TemporaryDirectory(prefix="slice15-chaos-") as root:
        env = dict(os.environ, METRICS_TPU_WAL_SEGMENT_BYTES="4096")
        env.pop("METRICS_TPU_CRASH", None)
        here = os.path.abspath(__file__)
        nshards = SLICE15_SHARDS

        def start(phase, work, shard, crash=None):
            e = dict(env, METRICS_TPU_CRASH=crash) if crash else env
            return subprocess.Popen([sys.executable, here, "--slice15-worker", phase, work, str(shard), str(nshards),
                                     str(dev)], env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        def finish(proc):
            try:
                out, err = proc.communicate(timeout=SLICE14_WORKER_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            return proc.returncode, out, err

        def result(rc, out, err, what):
            check(rc == 0, f"slice 15 E: the {what} worker failed (rc {rc}): {err[-2000:]}")
            return json.loads(out.strip().splitlines()[-1])

        procs = {("twin", k): start("run", os.path.join(root, "twin"), k) for k in range(nshards)}
        for point, nth in SLICE15_CRASH_NTH.items():
            procs[(point, 0)] = start("run", os.path.join(root, point), 0, crash=f"{point}:{nth}")
        done = {key: finish(p) for key, p in procs.items()}
        twin_fleet = {k: result(*done.pop(("twin", k)), f"twin shard {k}") for k in range(nshards)}
        for (point, _), (rc, out, err) in done.items():
            check(rc in (-9, 137) and not out.strip(),
                  f"slice 15 E: crash point {point} did not kill shard 0 (rc {rc}): {err[-2000:]}")
        recs = {p: start("recover", os.path.join(root, p), 0) for p in SLICE15_CRASH_NTH}
        recovered = {p: result(*finish(proc), f"{p} recovery") for p, proc in recs.items()}
    union = {}
    for k in range(1, nshards):
        union.update(twin_fleet[k]["values"])
    twin_union = dict(union, **twin_fleet[0]["values"])
    for point, got in recovered.items():
        check(got["digest"] == twin_fleet[0]["digest"] and got["last_seq"] == twin_fleet[0]["last_seq"]
              and dict(union, **got["values"]) == twin_union and got["epoch"] == 2,
              f"slice 15 E: the fleet after {point} differs from the uncrashed twin fleet")
    report["E_crash_matrix"] = {
        "shards": nshards, "points": list(SLICE15_CRASH_NTH), "twin_last_seq": {k: v["last_seq"] for k, v in
                                                                                  twin_fleet.items()},
        "recovery_to_first_result_ms": {p: r["recovery_to_first_result_ms"] for p, r in recovered.items()},
        "replayed_records": {p: r["replayed_records"] for p, r in recovered.items()},
    }
    laps.mark("3. slice 15 E: the crash matrix on the card")
    new_degrades = {k: v - degrades0.get(k, 0) for k, v in resilience.degrades().items() if v != degrades0.get(k, 0)}
    # the drills' own degrades: a history read past the corrupt rung and its scrub (D)
    check(set(new_degrades) <= {"history"}, f"slice 15: an engine, the service or a fleet read degraded: {new_degrades}")
    report["path_launches"] = {name: {"total": totals[name], "by_branch_and_shape": {str(k): v for k, v in
                                                                                  by_shape15[name].items()}}
                               for name in totals}
    print(f"slice 15 ({card}): " + json.dumps(report, default=lambda o: o.tolist() if hasattr(o, "tolist") else str(o)))
    return totals, by_shape15, cm_inputs


def natural_images(torch, g, n, shape, dev):
    """``n`` images (or volumes) of ``shape`` (channels first) made on ``dev``:
    three octaves of a seeded coarse grid (cells of 64, 16 and 4 pixels,
    amplitudes 1/f-like), upsampled and summed, each image scaled to [0, 1]."""
    import torch.nn.functional as F

    c, *spatial = shape
    mode = "bilinear" if len(spatial) == 2 else "trilinear"
    out = torch.zeros((n, c, *spatial), device=dev)
    for cell, amp in IMAGE_OCTAVES:
        coarse = torch.rand(n, c, *(max(2, s // cell + 1) for s in spatial), generator=g, device=dev)
        out += amp * F.interpolate(coarse, size=tuple(spatial), mode=mode, align_corners=True)
    flat = out.reshape(n, -1)
    lo, hi = flat.amin(1), flat.amax(1)
    return ((flat - lo[:, None]) / (hi - lo)[:, None]).reshape(out.shape)


def noisy(torch, g, target):
    """The prediction: the target plus seeded gaussian noise near 30 dB, clipped to [0, 1]."""
    return (target + IMAGE_NOISE * torch.randn(target.shape, generator=g, device=target.device)).clamp(0, 1)


def spectral_images(torch, g, n, bands, h, w, dev):
    """``(preds, target)`` of ``n`` images of ``bands`` bands: a few seeded
    endmember spectra (smooth positive bumps over the band axis) mixed by
    abundance maps (a softmax of natural images over the endmembers), so the
    bands correlate; the prediction noisy at 30 dB of the band's scale,
    floored at 1e-3 (ERGAS divides by a band's mean)."""
    e = SPECTRAL_ENDMEMBERS
    axis = torch.linspace(0, 1, bands, device=dev)
    centres = torch.rand(e, 1, generator=g, device=dev)
    widths = 0.1 + 0.3 * torch.rand(e, 1, generator=g, device=dev)
    spectra = 0.1 + torch.exp(-(((axis - centres) / widths) ** 2))
    abundance = torch.softmax(4 * natural_images(torch, g, n, (e, h, w), dev), dim=1)
    target = (abundance[:, :, None] * spectra[None, :, :, None, None]).sum(1)
    preds = (target + IMAGE_NOISE * torch.randn(target.shape, generator=g, device=dev)).clamp_min(1e-3)
    return preds, target


def numpy_windowed(preds, target, size, sigma, c1=None, c2=None):
    """Float64 SSIM (UQI where ``c1`` and ``c2`` are None) of each image of
    ``(B, C, *spatial)`` numpy arrays with a gaussian window of ``size`` taps
    an axis: reflect-pad, valid correlation (the window is separable: one
    axis at a time), crop ``slice(p, size - p)``, mean over channels and
    pixels."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    taps = np.exp(-(x**2) / (2 * sigma**2))
    taps /= taps.sum()
    dims = preds.ndim - 2
    pads = [(size - 1) // 2] * dims

    def correlate(x):
        for axis in range(dims):
            windows = np.lib.stride_tricks.sliding_window_view(np.moveaxis(x, axis, -1), size, axis=-1)
            x = np.moveaxis(windows @ taps, -1, axis)
        return x

    out = []
    for b in range(preds.shape[0]):
        maps = []
        for c in range(preds.shape[1]):
            p = np.pad(preds[b, c].astype(np.float64), [(d, d) for d in pads], mode="reflect")
            t = np.pad(target[b, c].astype(np.float64), [(d, d) for d in pads], mode="reflect")
            mu_p, mu_t = correlate(p), correlate(t)
            s_pp, s_tt = correlate(p * p) - mu_p**2, correlate(t * t) - mu_t**2
            s_pt = correlate(p * t) - mu_p * mu_t
            if c1 is None:
                m = (4 * mu_p * mu_t * s_pt) / ((mu_p**2 + mu_t**2) * (s_pp + s_tt))
            else:
                m = ((2 * mu_p * mu_t + c1) * (2 * s_pt + c2)) / ((mu_p**2 + mu_t**2 + c1) * (s_pp + s_tt + c2))
            maps.append(m[tuple(slice(d, n - d) for d, n in zip(pads, m.shape))])
        out.append(np.mean(maps))
    return np.asarray(out)


def kodak_members(M, dev):
    """The codec evaluation's collection: PSNR, SSIM and MS-SSIM on the
    known [0, 1] range, and UQI."""
    return M.MetricCollection({
        "psnr": M.PeakSignalNoiseRatio(data_range=1.0, device=dev),
        "ssim": M.StructuralSimilarityIndexMeasure(data_range=1.0, device=dev),
        "ms_ssim": M.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device=dev),
        "uqi": M.UniversalImageQualityIndex(device=dev),
    })


def centre(shape, size):
    """Slices of the central ``size`` (one a trailing dim) of ``shape``."""
    return tuple(slice((n - k) // 2, (n - k) // 2 + k) for n, k in zip(shape[-len(size):], size))


def window_bound(shape, taps):
    """The least time (ms) of the five window statistics of images of
    ``shape``: the two inputs read once; ``taps`` multiply-adds an output of
    each statistic."""
    n = math.prod(shape)
    return bound(2 * n * 4, 5 * n * taps * 2)


def peak_mib(torch, fn):
    """Peak device memory (MiB) while ``fn`` runs, over what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def close(torch, got, want, what, **tol):
    """``got`` (any device) against ``want``, NaN where NaN, at ``tol`` (absolute and relative)."""
    torch.testing.assert_close(got.detach().cpu().double(), want.detach().cpu().double(), equal_nan=True,
                               atol=tol.get("atol", 0.0), rtol=tol.get("rtol", 0.0),
                               msg=lambda found: f"{what}: {found}")


def run_slice16(torch, dev, laps):
    """Slice 16 (see the module's docstring): returns the kernels' launches on
    its path (all 0: no image metric reaches a kernel of the registry)."""
    import metrics_tpu_torch as M
    from metrics_tpu_torch.functional.image.helper import _depthwise_conv, _gaussian_kernel_2d, _gaussian_kernel_3d
    from metrics_tpu_torch.functional.image.d_lambda import pair_chunk
    from metrics_tpu_torch.ops import launches, reset_launches

    t_slice = time.perf_counter()
    cpu = torch.device("cpu")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    report = {"card": card}
    windowed = {"atol": CARD_CPU_ATOL16}
    reset_launches()

    # ------------------------------------------------------------ A. Kodak
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    target = natural_images(torch, g, KODAK_IMAGES, KODAK_SHAPE, dev)
    preds = noisy(torch, g, target)
    mc = kodak_members(M, dev)
    for i in range(0, KODAK_IMAGES, IMAGE_BATCH):
        mc.update(preds[i:i + IMAGE_BATCH], target[i:i + IMAGE_BATCH])
    values = mc.compute()
    check(mc.compute_groups == KODAK_GROUPS, f"the Kodak collection formed the groups {mc.compute_groups}, not the "
          f"JAX package's {KODAK_GROUPS}")
    check(all(bool(torch.isfinite(v)) for v in values.values()), f"a Kodak value is not finite: {values}")
    p64, t64 = preds.double(), target.double()
    psnr64 = float(10 * torch.log10(1.0 / ((p64 - t64) ** 2).mean()))
    np.testing.assert_allclose(float(values["psnr"]), psnr64, rtol=RTOL16, err_msg="Kodak PSNR against float64")
    crop = (slice(0, 2), slice(None), *centre(KODAK_SHAPE, (96, 96)))
    ssim_crop = M.functional.structural_similarity_index_measure(preds[crop], target[crop], data_range=1.0,
                                                                 reduction="none")
    want = numpy_windowed(preds[crop].cpu().numpy(), target[crop].cpu().numpy(), 11, 1.5, c1=1e-4, c2=9e-4)
    np.testing.assert_allclose(ssim_crop.cpu().numpy(), want, atol=F64_ATOL16,
                               err_msg="Kodak SSIM on a 96 x 96 crop against float64 numpy")
    # the TF32 guard: the default flag (on) gives the flag-off bits, and the caller's flag stays as it was
    tf32_before = torch.backends.cudnn.allow_tf32
    batch = (preds[:IMAGE_BATCH], target[:IMAGE_BATCH])
    torch.backends.cudnn.allow_tf32 = True
    on = M.functional.structural_similarity_index_measure(*batch, data_range=1.0, reduction="none")
    check(torch.backends.cudnn.allow_tf32 is True, "SSIM left cuDNN's TF32 flag changed")
    torch.backends.cudnn.allow_tf32 = False
    off = M.functional.structural_similarity_index_measure(*batch, data_range=1.0, reduction="none")
    check(torch.backends.cudnn.allow_tf32 is False, "SSIM left cuDNN's TF32 flag changed")
    torch.backends.cudnn.allow_tf32 = True
    check(torch.equal(on, off), "SSIM under the default cuDNN flags differs from SSIM with TF32 off")
    pads = (5, 5, 5, 5)
    pp, tp = (torch.nn.functional.pad(x, pads, mode="reflect") for x in batch)
    stack = torch.cat((pp, tp, pp * pp, tp * tp, pp * tp))
    kernel = _gaussian_kernel_2d(3, (11, 11), (1.5, 1.5), torch.float32, dev)
    tf32_conv = torch.nn.functional.conv2d(stack, kernel, groups=3)  # cuDNN with TF32 allowed
    report["A_tf32_conv_max_abs_diff"] = float((tf32_conv - _depthwise_conv(stack, kernel)).abs().max())
    torch.backends.cudnn.allow_tf32 = tf32_before
    del stack, tf32_conv, pp, tp
    laps.mark("3. slice 16 A: Kodak on the card")
    head = (preds[:KODAK_CPU_IMAGES], target[:KODAK_CPU_IMAGES])
    on_card, on_cpu = kodak_members(M, dev), kodak_members(M, cpu)
    on_card.update(*head)
    on_cpu.update(*(x.cpu() for x in head))
    card_head, cpu_head = on_card.compute(), on_cpu.compute()
    for key, want in cpu_head.items():
        close(torch, card_head[key], want, f"Kodak {key} (first {KODAK_CPU_IMAGES} images) against the CPU",
              **({"rtol": RTOL16} if key == "psnr" else windowed))
    head64 = [x.cpu().numpy() for x in head]
    for key, c in (("ssim", (1e-4, 9e-4)), ("uqi", (None, None))):
        want = float(numpy_windowed(*head64, 11, 1.5, *c).mean())
        for where, got in (("card", card_head[key]), ("CPU", cpu_head[key])):
            np.testing.assert_allclose(float(got), want, atol=F64_ATOL16,
                                       err_msg=f"Kodak {key} (first {KODAK_CPU_IMAGES} images) on the {where} "
                                       "against float64 numpy")
    laps.mark("3. slice 16 A: Kodak on the CPU")
    upd = (preds[-IMAGE_BATCH:], target[-IMAGE_BATCH:])
    timed = kodak_members(M, dev)
    timed.update(preds, target)  # the groups formed, then the epoch's 24 images in one state

    def members_compute():
        return [m._compute_impl() for m in timed.values(copy_state=False)]

    report["A_kodak"] = {
        "values": {k: float(v) for k, v in values.items()}, "psnr_float64": psnr64,
        "groups": mc.compute_groups,
        "collection_update_ms": host_ms(torch, lambda: mc.update(*upd), reps=5),
        "collection_compute_ms": host_ms(torch, members_compute, reps=3),
        "update_syncs": one_call_syncs(torch, lambda: mc.update(*upd))[0],
        "compute_syncs": one_call_syncs(torch, members_compute)[0],
        "compute_peak_mib": peak_mib(torch, members_compute),
    }
    check(report["A_kodak"]["update_syncs"] == 0 and report["A_kodak"]["compute_syncs"] == 0,
          "a Kodak update or compute synchronised with the host")
    print("slice 16 A, Kodak: " + json.dumps(report["A_kodak"]))
    del mc, timed, on_card, preds, target, p64, t64
    laps.mark("3. slice 16 A: Kodak timings")

    # ------------------------------------------------- B. Cityscapes val, full resolution
    g = torch.Generator(device=dev).manual_seed(SEED + 161)
    psnr = M.PeakSignalNoiseRatio(device=dev)
    engine = M.PeakSignalNoiseRatio(jit_update=True, device=dev)
    per_image = M.PeakSignalNoiseRatio(data_range=1.0, dim=(1, 2, 3), reduction="none", device=dev)
    ssim = M.StructuralSimilarityIndexMeasure(data_range=1.0, device=dev)
    ms_ssim = M.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device=dev)
    sse64, per64 = torch.zeros((), dtype=torch.float64, device=dev), []
    lo64 = torch.full((), math.inf, dtype=torch.float64, device=dev)
    hi64 = torch.full((), -math.inf, dtype=torch.float64, device=dev)
    ssim_vals, ms_vals, grad_sums = [], [], torch.zeros(2, dtype=torch.float64, device=dev)
    first = None
    for step in range(CITY_IMAGES // IMAGE_BATCH):
        t = natural_images(torch, g, IMAGE_BATCH, CITY_SHAPE, dev)
        p = noisy(torch, g, t)
        if first is None:
            first = (p[:1].clone(), t[:1].clone())
        psnr.update(p, t)
        engine.update(p, t)
        per_image.update(p, t)
        ssim_vals.append(ssim(p, t))
        ssim.reset()  # the loop logs the batch value; 500 full-resolution images would hold 25 GB a metric
        ms_vals.append(ms_ssim(p, t))
        ms_ssim.reset()
        dy, dx = M.functional.image_gradients(p)
        grad_sums += torch.stack((dy.double().abs().sum(), dx.double().abs().sum()))
        d = (p.double() - t.double()) ** 2
        sse64 += d.sum()
        per64.append(d.reshape(IMAGE_BATCH, -1).mean(1))
        lo64 = torch.minimum(lo64, t.double().min())
        hi64 = torch.maximum(hi64, t.double().max())
    torch.cuda.synchronize()
    laps.mark("3. slice 16 B: Cityscapes epoch on the card")
    n_values = CITY_IMAGES * math.prod(CITY_SHAPE)
    check(psnr.total.dtype == torch.int64 and int(psnr.total) == n_values,
          f"Cityscapes PSNR counted {int(psnr.total)} values ({psnr.total.dtype}), not {n_values} in int64")
    for key in psnr._defaults:
        check(torch.equal(getattr(engine, key), getattr(psnr, key)),
              f"the PSNR engine's {key} is not the eager update's bits")
    value, engine_value, epoch_total = psnr.compute(), engine.compute(), int(psnr.total)
    check(torch.equal(value, engine_value), "the PSNR engine's value is not the eager value's bits")
    psnr_want = 10 * math.log10(float(hi64 - lo64) ** 2 / (float(sse64) / n_values))
    check(bool(torch.isfinite(value)), f"Cityscapes PSNR over {n_values} values is not finite: {value}")
    np.testing.assert_allclose(float(value), psnr_want, rtol=RTOL16, err_msg="Cityscapes PSNR against float64")
    stats = engine.dispatch_stats
    check(stats["dispatches"] == CITY_IMAGES // IMAGE_BATCH and stats["retraces"] == 1 and stats["demotions"] == 0,
          f"the PSNR engine's stats {stats}")
    programs = list(engine._dispatcher._cache.values())
    check(len(programs) == 1 and len(programs[0].graphs) == 2, "the PSNR engine holds no captured program")
    per_value = per_image.compute()
    check(per_value.shape == (CITY_IMAGES,), f"per-image PSNR has the shape {tuple(per_value.shape)}")
    np.testing.assert_allclose(per_value.cpu().numpy(), (-10 * torch.log10(torch.cat(per64))).cpu().numpy(),
                               rtol=RTOL16, err_msg="per-image PSNR against float64")
    ssim_vals, ms_vals = torch.stack(ssim_vals), torch.stack(ms_vals)
    check(bool(((ssim_vals > 0) & (ssim_vals <= 1)).all() and ((ms_vals > 0) & (ms_vals <= 1)).all()),
          "a Cityscapes SSIM or MS-SSIM batch value falls outside (0, 1]")
    # the CPU on a 256 x 256 crop of the first image, against the card on the same crop
    sl = (slice(None), slice(None), *centre(CITY_SHAPE, (CITY_CPU_CROP, CITY_CPU_CROP)))
    fp, ft = first[0][sl], first[1][sl]
    crop_card = {
        "psnr": M.functional.peak_signal_noise_ratio(fp, ft),
        "ssim": M.functional.structural_similarity_index_measure(fp, ft, data_range=1.0),
        "ms_ssim": M.functional.multiscale_structural_similarity_index_measure(fp, ft, data_range=1.0),
    }
    fpc, ftc = fp.cpu(), ft.cpu()
    crop_cpu = {
        "psnr": M.functional.peak_signal_noise_ratio(fpc, ftc),
        "ssim": M.functional.structural_similarity_index_measure(fpc, ftc, data_range=1.0),
        "ms_ssim": M.functional.multiscale_structural_similarity_index_measure(fpc, ftc, data_range=1.0),
    }
    for key, want in crop_cpu.items():
        close(torch, crop_card[key], want, f"Cityscapes {key} on a crop against the CPU",
              **({"rtol": RTOL16} if key == "psnr" else windowed))
    for a, b in zip(M.functional.image_gradients(fp), M.functional.image_gradients(fpc)):
        check(torch.equal(a.cpu(), b), "image_gradients on the card differs from the CPU's")
    laps.mark("3. slice 16 B: Cityscapes on the CPU")
    t = natural_images(torch, g, IMAGE_BATCH, CITY_SHAPE, dev)
    p = noisy(torch, g, t)
    fresh = {"psnr eager": M.PeakSignalNoiseRatio(device=dev), "ssim": M.StructuralSimilarityIndexMeasure(
        data_range=1.0, device=dev), "ms_ssim": M.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0,
                                                                                           device=dev)}
    calls = {
        "psnr eager update": lambda: psnr.update(p, t),
        "psnr engine update": lambda: engine.update(p, t),
        "psnr dim update": lambda: per_image.update(p, t),
        "psnr compute": psnr._compute_impl,
        "psnr dim compute": per_image._compute_impl,
        "ssim forward": lambda: (fresh["ssim"](p, t), fresh["ssim"].reset()),
        "ssim update": lambda: (fresh["ssim"].update(p, t), fresh["ssim"].reset()),
        "ms_ssim forward": lambda: (fresh["ms_ssim"](p, t), fresh["ms_ssim"].reset()),
        "image_gradients": lambda: M.functional.image_gradients(p),
    }
    b_ms = host_ms_in_turns(torch, {k: calls[k] for k in ("psnr eager update", "psnr engine update")}, reps=10)
    b_ms.update({k: host_ms(torch, fn, reps=5) for k, fn in calls.items() if k not in b_ms})
    b_syncs = {k: one_call_syncs(torch, fn)[0] for k, fn in calls.items()}
    check(not any(b_syncs.values()), f"a Cityscapes update, forward or compute synchronised with the host: {b_syncs}")
    b_peak = {k: peak_mib(torch, fn) for k, fn in calls.items()}
    # SSIM's window statistics alone (one depthwise convolution) and the whole SSIM, against the bound
    pp, tp = (torch.nn.functional.pad(x, (5, 5, 5, 5), mode="reflect") for x in (p, t))
    stack = torch.cat((pp, tp, pp * pp, tp * tp, pp * tp))
    kernel = _gaussian_kernel_2d(3, (11, 11), (1.5, 1.5), torch.float32, dev)
    conv_bound = window_bound(tuple(p.shape), 121)
    conv = {"conv_ms": device_ms(torch, lambda: _depthwise_conv(stack, kernel), reps=10),
            "ssim_ms": device_ms(torch, lambda: M.functional.structural_similarity_index_measure(p, t, data_range=1.0),
                                 reps=10),
            "bound_ms": conv_bound[0], "bound_by": conv_bound[1],
            "shape": list(p.shape), "gflop": 5 * p.numel() * 121 * 2 / 1e9, "read_mb": 2 * p.numel() * 4 / 1e6}
    del stack, pp, tp
    report["B_cityscapes"] = {
        "psnr": float(value), "psnr_float64": psnr_want, "total": epoch_total, "engine": stats,
        "per_image_psnr_mean": float(per_value.mean()), "ssim_batch_mean": float(ssim_vals.mean()),
        "ms_ssim_batch_mean": float(ms_vals.mean()), "gradient_abs_sums": grad_sums.tolist(),
        "ms": b_ms, "syncs": b_syncs, "peak_mib": b_peak, "ssim_window": conv,
    }
    print("slice 16 B, Cityscapes: " + json.dumps(report["B_cityscapes"]))
    del psnr, engine, per_image, ssim, ms_ssim, fresh, calls, p, t, first
    laps.mark("3. slice 16 B: Cityscapes timings")

    # ----------------------------------------------------------- C. BraTS 2021 volumes
    g = torch.Generator(device=dev).manual_seed(SEED + 162)
    ssim3d = M.StructuralSimilarityIndexMeasure(data_range=1.0, device=dev)
    forward_ms, fwd_vals, vol0 = [], [], None
    for _ in range(BRATS_VOLUMES):
        t = natural_images(torch, g, 1, BRATS_SHAPE, dev)
        p = noisy(torch, g, t)
        vol0 = (p.clone(), t.clone()) if vol0 is None else vol0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd_vals.append(ssim3d(p, t))
        torch.cuda.synchronize()
        forward_ms.append((time.perf_counter() - t0) * 1e3)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    epoch = ssim3d.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    epoch_peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    fwd_vals = torch.stack(fwd_vals)
    check(bool(((fwd_vals > 0) & (fwd_vals <= 1)).all()), f"a BraTS SSIM falls outside (0, 1]: {fwd_vals}")
    close(torch, epoch, fwd_vals.mean(), "BraTS SSIM over the 8 volumes against the mean of their forward values",
          atol=VOLUME_F64_ATOL16)
    kernel3 = _gaussian_kernel_3d(BRATS_SHAPE[0], (11, 11, 11), (1.5, 1.5, 1.5), torch.float32, dev)
    pp, tp = (torch.nn.functional.pad(x, (5,) * 6, mode="reflect") for x in vol0)
    stack = torch.cat((pp, tp, pp * pp, tp * tp, pp * tp))
    vol_bound = window_bound(tuple(vol0[0].shape), 1331)
    report["C_brats"] = {
        "ssim_by_volume": fwd_vals.tolist(), "ssim_epoch": float(epoch), "forward_ms_by_volume": forward_ms,
        "conv_ms": device_ms(torch, lambda: _depthwise_conv(stack, kernel3), reps=3),
        "bound_ms": vol_bound[0], "bound_by": vol_bound[1], "gflop": 5 * vol0[0].numel() * 1331 * 2 / 1e9,
        "epoch_compute_ms": compute_ms, "epoch_compute_peak_mib": epoch_peak,
        "forward_peak_mib": peak_mib(torch, lambda: ssim3d.forward(*vol0)),
        "forward_syncs": one_call_syncs(torch, lambda: ssim3d.forward(*vol0))[0],
    }
    print("slice 16 C, BraTS: " + json.dumps(report["C_brats"]))
    check(report["C_brats"]["forward_syncs"] == 0, "a BraTS SSIM forward synchronised with the host")
    del stack, pp, tp, ssim3d
    laps.mark("3. slice 16 C: BraTS on the card")
    crop3 = (slice(None), slice(None), *centre(BRATS_SHAPE, BRATS_CPU_CROP))
    cp, ct = vol0[0][crop3], vol0[1][crop3]
    close(torch, M.functional.structural_similarity_index_measure(cp, ct, data_range=1.0),
          M.functional.structural_similarity_index_measure(cp.cpu(), ct.cpu(), data_range=1.0),
          "BraTS SSIM on a crop against the CPU", atol=VOLUME_CARD_CPU_ATOL16)
    want3 = numpy_windowed(cp.cpu().numpy(), ct.cpu().numpy(), 11, 1.5, c1=1e-4, c2=9e-4)
    np.testing.assert_allclose(float(M.functional.structural_similarity_index_measure(cp, ct, data_range=1.0)),
                               want3.mean(), atol=VOLUME_F64_ATOL16, err_msg="BraTS SSIM on a crop against float64")
    del vol0
    laps.mark("3. slice 16 C: BraTS on the CPU")

    # ------------------------------------------------------------ D. spectral
    g = torch.Generator(device=dev).manual_seed(SEED + 163)
    report["D_spectral"] = {}
    for name, (n, bands, h, w) in (("worldview3", WV3_SHAPE), ("indian_pines", PINES_SHAPE)):
        p, t = spectral_images(torch, g, n, bands, h, w, dev)
        mods = {"sam": M.SpectralAngleMapper(device=dev), "ergas": M.ErrorRelativeGlobalDimensionlessSynthesis(
            ratio=4, device=dev), "d_lambda": M.SpectralDistortionIndex(device=dev)}
        for m in mods.values():
            m.update(p, t)
        ms, peak, syncs, vals = {}, {}, {}, {}
        for key, m in mods.items():
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            vals[key] = m.compute()
            torch.cuda.synchronize()
            ms[key] = (time.perf_counter() - t0) * 1e3
            peak[key] = (torch.cuda.max_memory_allocated() - base) / 2**20
            syncs[key] = one_call_syncs(torch, m._compute_impl)[0]
        check(not any(syncs.values()), f"a {name} compute synchronised with the host: {syncs}")
        d_lambda = float(vals["d_lambda"])
        check(math.isfinite(d_lambda) and 0 <= d_lambda <= 1, f"{name} D-lambda {d_lambda} is not in [0, 1]")
        p64, t64 = p.cpu().numpy().astype(np.float64), t.cpu().numpy().astype(np.float64)
        cos = (p64 * t64).sum(1) / (np.linalg.norm(p64, axis=1) * np.linalg.norm(t64, axis=1))
        sam64 = float(np.arccos(np.clip(cos, -1, 1)).mean())
        pf, tf_ = p64.reshape(n, bands, -1), t64.reshape(n, bands, -1)
        rmse = np.sqrt(((pf - tf_) ** 2).mean(-1))
        ergas64 = float((100 * 4 * np.sqrt(((rmse / tf_.mean(-1)) ** 2).sum(1) / bands)).mean())
        np.testing.assert_allclose(float(vals["sam"]), sam64, atol=SAM_ATOL16, err_msg=f"{name} SAM against float64")
        np.testing.assert_allclose(float(vals["ergas"]), ergas64, rtol=RTOL16, err_msg=f"{name} ERGAS against float64")
        # D-lambda on the CPU: a crop (and, for the 200 bands, the first 16) against the card on the same crop
        cb = min(bands, PINES_CPU_BANDS)
        sl = (slice(0, 2), slice(0, cb), slice(0, SPECTRAL_CPU_CROP), slice(0, SPECTRAL_CPU_CROP))
        crop_card = M.functional.spectral_distortion_index(p[sl], t[sl])
        crop_cpu = M.functional.spectral_distortion_index(p[sl].cpu(), t[sl].cpu())
        crop64 = M.functional.spectral_distortion_index(p[sl].cpu().double(), t[sl].cpu().double())
        for where, got in (("card", crop_card), ("CPU", crop_cpu)):
            close(torch, got, crop64, f"{name} D-lambda on a crop on the {where} against float64",
                  atol=SPECTRAL_F64_ATOL16)
        close(torch, crop_card, crop_cpu, f"{name} D-lambda on a crop against the CPU", atol=2 * SPECTRAL_F64_ATOL16)
        report["D_spectral"][name] = {
            "shape": [n, bands, h, w], "pairs": bands * (bands + 1) // 2, "pairs_a_chunk": pair_chunk(t),
            "values": {k: float(v) for k, v in vals.items()}, "sam_float64": sam64, "ergas_float64": ergas64,
            "d_lambda_crop": {"card": float(crop_card), "cpu": float(crop_cpu), "float64": float(crop64)},
            "compute_ms": ms, "compute_peak_mib": peak, "compute_syncs": syncs,
        }
        print(f"slice 16 D, {name}: " + json.dumps(report["D_spectral"][name]))
        del p, t, mods
    laps.mark("3. slice 16 D: spectral")

    slice16_launches = launches()
    check(all(n == 0 for n in slice16_launches.values()), f"slice 16 launched a kernel: {slice16_launches}")
    report["launches"] = slice16_launches
    report["command_s"] = time.perf_counter() - t_slice
    print(f"slice 16 ({card}): " + json.dumps(report, default=lambda o: o.tolist() if hasattr(o, "tolist") else str(o)))
    return slice16_launches


def speech_sources(torch, g, n, spk, samples, fs, dev):
    """``(n, spk, samples)`` speech-shaped sources at ``fs`` Hz, unit RMS: white
    noise shaped 1/f-like above ``SPEECH_CORNER_HZ``, under a syllabic envelope
    (3 to 5 Hz, a random phase each) with ``SPEECH_GAPS`` silent gaps of
    ``SPEECH_GAP_S`` each."""
    white = torch.randn(n, spk, samples, generator=g, device=dev)
    freqs = torch.fft.rfftfreq(samples, 1.0 / fs, device=dev)
    shaped = torch.fft.irfft(torch.fft.rfft(white) / torch.sqrt(1 + freqs / SPEECH_CORNER_HZ), n=samples)
    t = torch.arange(samples, device=dev) / fs
    rate = SYLLABLE_HZ * (0.75 + 0.5 * torch.rand(n, spk, 1, generator=g, device=dev))
    phase = 2 * math.pi * torch.rand(n, spk, 1, generator=g, device=dev)
    envelope = torch.sin(2 * math.pi * rate * t + phase).abs()
    starts = torch.rand(n, spk, SPEECH_GAPS, 1, generator=g, device=dev) * samples
    idx = torch.arange(samples, device=dev)
    silent = ((idx >= starts) & (idx < starts + SPEECH_GAP_S * fs)).any(dim=2)
    x = shaped * envelope * ~silent
    return x / x.square().mean(dim=-1, keepdim=True).sqrt()


def separation_batch(torch, g, n, spk, samples, dev):
    """A separation system's output on ``n`` mixtures of ``spk`` sources at
    ``WSJ_FS``: ``(preds, target, planted)``. Each estimate is its source plus
    ``SEP_LEAK`` of the others and noise of a seeded level (SI-SDR 8 to 15 dB),
    and the estimates come out in a planted order: ``preds[b, k]`` estimates
    ``target[b, planted[b, k]]``, so PIT must find ``argsort(planted)``."""
    target = speech_sources(torch, g, n, spk, samples, WSJ_FS, dev)
    others = target.sum(dim=1, keepdim=True) - target
    sigma = SEP_NOISE[0] + (SEP_NOISE[1] - SEP_NOISE[0]) * torch.rand(n, 1, 1, generator=g, device=dev)
    est = target + SEP_LEAK / math.sqrt(spk - 1) * others + sigma * torch.randn(n, spk, samples, generator=g,
                                                                                   device=dev)
    planted = torch.argsort(torch.rand(n, spk, generator=g, device=dev), dim=1)
    return torch.gather(est, 1, planted[..., None].expand_as(est)), target, planted


def length_batches(mixtures, lengths_s, batch):
    """``(length in s, mixtures)`` batches: mixture ``i`` takes length
    ``lengths_s[i % len(lengths_s)]``, and each length's mixtures go in batches
    of ``batch`` (the last of a length may hold fewer)."""
    out = []
    for k, length in enumerate(lengths_s):
        count = len(range(k, mixtures, len(lengths_s)))
        out += [(length, min(batch, count - i)) for i in range(0, count, batch)]
    return out


def numpy_si_sdr(preds, target):
    """Float64 SI-SDR (dB) over the trailing axis."""
    preds, target = preds.astype(np.float64), target.astype(np.float64)
    alpha = (preds * target).sum(-1, keepdims=True) / (target**2).sum(-1, keepdims=True)
    scaled = alpha * target
    return 10 * np.log10((scaled**2).sum(-1) / ((scaled - preds) ** 2).sum(-1))


def numpy_snr(preds, target):
    preds, target = preds.astype(np.float64), target.astype(np.float64)
    return 10 * np.log10((target**2).sum(-1) / ((target - preds) ** 2).sum(-1))


def numpy_sdr(preds, target, filter_length):
    """Float64 SDR (dB) of row pairs through ``scipy.linalg.solve_toeplitz`` (a Levinson solve)."""
    from scipy.linalg import solve_toeplitz

    preds = preds.reshape(-1, preds.shape[-1]).astype(np.float64)
    target = target.reshape(-1, target.shape[-1]).astype(np.float64)
    preds /= np.linalg.norm(preds, axis=-1, keepdims=True)
    target /= np.linalg.norm(target, axis=-1, keepdims=True)
    n_fft = 2 ** math.ceil(math.log2(2 * preds.shape[-1] - 1))
    t_fft = np.fft.rfft(target, n_fft)
    r_0 = np.fft.irfft(np.abs(t_fft) ** 2, n_fft)[:, :filter_length]
    b = np.fft.irfft(np.conj(t_fft) * np.fft.rfft(preds, n_fft), n_fft)[:, :filter_length]
    coh = np.array([b_row @ solve_toeplitz(r_row, b_row) for r_row, b_row in zip(r_0, b)])
    return 10 * np.log10(coh / (1 - coh))


def sdr_tol(sdr):
    """The float32 SDR's tolerance in dB at each value: its error in the
    coherence grows as 1 / (1 - coh) = 1 + 10 ** (SDR / 10) (tests/test_torch_audio.py)."""
    return SDR_TOL_DB * (1 + 10 ** (np.asarray(sdr, np.float64) / 10))


def best_of(pairs, perm):
    """``pairs[b, j, perm[b, j]]`` averaged over ``j``: the metric of a permutation."""
    return np.take_along_axis(pairs, perm[:, :, None], axis=2)[..., 0].mean(-1)


def pair_matrix(fn, preds, target):
    """``(B, S, S)`` float64 ``fn(preds[b, k], target[b, j])`` at ``[b, j, k]``."""
    spk = preds.shape[1]
    return np.stack([np.stack([fn(preds[:, k], target[:, j]) for k in range(spk)], -1) for j in range(spk)], 1)


def solve_bound(batch, taps):
    """The least time (ms) of a batched ``taps`` x ``taps`` solve: (2/3) taps^3
    operations a matrix (the LU) at the float32 rate, or its matrix, right-hand
    side and solution read and written once."""
    return bound(batch * (taps * taps + 2 * taps) * 4, batch * 2 * taps**3 / 3)


def run_slice17(torch, dev, laps):
    """Slice 17 (see the module's docstring): returns the kernels' launches on
    its path (all 0: no audio metric reaches a kernel of the registry)."""
    import metrics_tpu_torch as M
    import metrics_tpu_torch.functional as tF
    from metrics_tpu_torch import telemetry
    from metrics_tpu_torch.functional.audio._pesq_core import pesq_native
    from metrics_tpu_torch.functional.audio.sdr import _compute_autocorr_crosscorr, _symmetric_toeplitz
    from metrics_tpu_torch.functional.audio.stoi import _resample_kernel, _resample_to_10k
    from metrics_tpu_torch.functional.image.helper import _full_float32
    from metrics_tpu_torch.ops import launches, reset_launches

    t_slice = time.perf_counter()
    cpu = torch.device("cpu")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    report = {"card": card}
    reset_launches()
    si_sdr, sdr = tF.scale_invariant_signal_distortion_ratio, tF.signal_distortion_ratio

    # ------------------------------------------------------------ A. WSJ0-2mix
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    pit_si = M.PermutationInvariantTraining(si_sdr, device=dev)
    pit_si_engine = M.PermutationInvariantTraining(si_sdr, jit_update=True, device=dev)
    pit_sdr = M.PermutationInvariantTraining(sdr, filter_length=SDR_TAPS, device=dev)
    batches = length_batches(WSJ_MIXTURES, WSJ_LENGTHS_S, WSJ_BATCH)
    misses, values, prefix, shapes, solves = torch.zeros((), dtype=torch.int64, device=dev), [], [], set(), 0
    for step, (length, n) in enumerate(batches):
        preds, target, planted = separation_batch(torch, g, n, 2, int(length * WSJ_FS), dev)
        metric, perm = tF.permutation_invariant_training(preds, target, si_sdr)
        misses += (perm.long() != torch.argsort(planted, dim=1)).any(dim=1).sum()
        values.append(metric)
        pit_si.update(preds, target)
        pit_si_engine.update(preds, target)
        shapes.add(tuple(preds.shape))
        if step % WSJ_SDR_EVERY == 0:
            pit_sdr.update(preds, target)
            solves += n * 4
        if step < WSJ_CPU_BATCHES:
            prefix.append((preds, target, planted))
    torch.cuda.synchronize()
    laps.mark("3. slice 17 A: WSJ0-2mix on the card")
    values = torch.cat(values)
    check(int(misses) == 0, f"PIT over SI-SDR missed {int(misses)} of the {WSJ_MIXTURES} planted 2-speaker orders")
    check(int(pit_si.total) == WSJ_MIXTURES and int(pit_sdr.total) == solves // 4,
          f"the 2-mix counts {int(pit_si.total)} and {int(pit_sdr.total)}")
    for key in pit_si._defaults:
        check(torch.equal(getattr(pit_si_engine, key), getattr(pit_si, key)),
              f"the PIT engine's {key} is not the eager update's bits")
    stats = pit_si_engine.dispatch_stats
    programs = list(pit_si_engine._dispatcher._cache.values())
    check(stats["dispatches"] == len(batches) and stats["retraces"] == len(shapes) and stats["demotions"] == 0
          and all(len(p.graphs) == 2 for p in programs), f"the PIT engine's stats {stats} over {len(shapes)} shapes")
    # the card against the CPU port and float64 references on the first batches
    a_prefix = {"si_sdr_max_abs_diff_cpu": 0.0, "si_sdr_max_abs_diff_f64": 0.0, "sdr_max_abs_diff_cpu": 0.0,
                "sdr_max_abs_diff_f64": 0.0, "sdr_range_db": [math.inf, -math.inf]}
    for preds, target, planted in prefix:
        want_perm = torch.argsort(planted, dim=1).cpu()
        p_np, t_np = preds.cpu().numpy(), target.cpu().numpy()
        for fn, key, kwargs in ((si_sdr, "si_sdr", {}), (sdr, "sdr", {"filter_length": SDR_TAPS})):
            got, got_perm = tF.permutation_invariant_training(preds, target, fn, **kwargs)
            want, want_cpu_perm = tF.permutation_invariant_training(preds.cpu(), target.cpu(), fn, **kwargs)
            check(torch.equal(got_perm.cpu(), want_cpu_perm) and torch.equal(want_cpu_perm.long(), want_perm),
                  f"PIT over {key} on the card, on the CPU and the planted orders differ")
            ref = best_of(pair_matrix(numpy_si_sdr if key == "si_sdr" else
                                      (lambda p, t: numpy_sdr(p, t, SDR_TAPS)), p_np, t_np), want_perm.numpy())
            got, want = got.cpu().double().numpy(), want.double().numpy()
            tol = DB_ATOL17 if key == "si_sdr" else sdr_tol(ref)
            check(bool(np.all(np.abs(got - ref) <= tol) and np.all(np.abs(want - ref) <= tol)
                       and np.all(np.abs(got - want) <= 2 * tol)),
                  f"PIT over {key} on the card {got} and the CPU {want} against float64 {ref} (tolerance {tol})")
            a_prefix[f"{key}_max_abs_diff_cpu"] = max(a_prefix[f"{key}_max_abs_diff_cpu"], float(np.abs(got - want).max()))
            a_prefix[f"{key}_max_abs_diff_f64"] = max(a_prefix[f"{key}_max_abs_diff_f64"], float(np.abs(got - ref).max()))
            if key == "sdr":
                a_prefix["sdr_range_db"] = [min(a_prefix["sdr_range_db"][0], float(ref.min())),
                                            max(a_prefix["sdr_range_db"][1], float(ref.max()))]
    laps.mark("3. slice 17 A: WSJ0-2mix against the CPU and float64")
    # the SDR engine: it captures the Toeplitz solve or demotes, and says which
    sdr_engine = M.PermutationInvariantTraining(sdr, filter_length=SDR_TAPS, jit_update=True, device=dev)
    sdr_eager = M.PermutationInvariantTraining(sdr, filter_length=SDR_TAPS, device=dev)
    g_sdr = torch.Generator(device=dev).manual_seed(SEED + 171)
    sdr_batches = [separation_batch(torch, g_sdr, WSJ_BATCH, 2, int(WSJ_LENGTHS_S[0] * WSJ_FS), dev)[:2]
                   for _ in range(SDR_ENGINE_BATCHES)]
    with telemetry.instrument() as session:
        for b in sdr_batches:
            sdr_engine.update(*b)
            sdr_eager.update(*b)
    degrades = [e.attrs for e in session.spans(name="degrade", owner="PermutationInvariantTraining")]
    sdr_stats = dict(sdr_engine.dispatch_stats)
    captured = bool(sdr_engine._dispatcher and any(len(p.graphs) == 2 for p in sdr_engine._dispatcher._cache.values()))
    for key in sdr_eager._defaults:
        check(torch.equal(getattr(sdr_engine, key), getattr(sdr_eager, key)),
              f"the SDR PIT engine's {key} is not the eager update's bits")
    check(captured or sdr_stats.get("demotions", 0) > 0, f"the SDR engine neither captured nor demoted: {sdr_stats}")
    sdr_engine_report = {"captured": captured, "stats": {k: v for k, v in sdr_stats.items() if k != "last_cause"},
                         "cause": None if captured else sdr_stats.get("last_cause"),
                         "errors": [d.get("error") for d in degrades]}
    check(captured or degrades, "the SDR engine demoted without a degrade span")
    print("slice 17 A, SDR under the engine: " + json.dumps(sdr_engine_report, default=str))
    # timings on one warm 4 s batch: updates, computes, syncs; the solve and its bound
    p4, t4 = separation_batch(torch, g_sdr, WSJ_BATCH, 2, 4 * WSJ_FS, dev)[:2]
    fresh_sdr = M.PermutationInvariantTraining(sdr, filter_length=SDR_TAPS, device=dev)
    calls = {
        "pit_si_sdr update": lambda: pit_si.update(p4, t4),
        "pit_si_sdr engine update": lambda: pit_si_engine.update(p4, t4),
        "pit_sdr update": lambda: fresh_sdr.update(p4, t4),
        "pit_si_sdr compute": pit_si._compute_impl,
        "pit_sdr compute": fresh_sdr._compute_impl,
    }
    a_ms = {k: host_ms(torch, fn, reps=5) for k, fn in calls.items()}
    a_syncs = {k: one_call_syncs(torch, fn)[0] for k, fn in calls.items()}
    check(not any(a_syncs.values()), f"a 2-mix update or compute synchronised with the host: {a_syncs}")
    # the solve alone on the systems of the 4 s batch's 32 speaker pairs, as PIT builds them
    t_norm = t4.repeat_interleave(2, dim=1).reshape(-1, t4.shape[-1])
    p_norm = p4.repeat(1, 2, 1).reshape(-1, p4.shape[-1])
    t_norm = t_norm / t_norm.norm(dim=-1, keepdim=True)
    p_norm = p_norm / p_norm.norm(dim=-1, keepdim=True)
    r_0, b = _compute_autocorr_crosscorr(t_norm, p_norm, SDR_TAPS)
    r_0[:, 0] *= 1 + 1e-6
    r = _symmetric_toeplitz(r_0)
    solve_lim = solve_bound(r.shape[0], SDR_TAPS)
    report["A_wsj0_2mix"] = {
        "mixtures": WSJ_MIXTURES, "batches": len(batches), "shapes": len(shapes),
        "si_sdr_pit_mean_db": float(values.mean()), "si_sdr_pit_range_db": [float(values.min()), float(values.max())],
        "pit_si_sdr_value": float(pit_si.compute()), "pit_sdr_value": float(pit_sdr.compute()),
        "sdr_mixtures": int(pit_sdr.total), "toeplitz_solves": solves,
        "engine": {k: v for k, v in stats.items() if k != "last_cause"}, "prefix": a_prefix,
        "ms": a_ms, "syncs": a_syncs,
        "solve": {"batch": r.shape[0], "taps": SDR_TAPS,
                  "solve_ex_ms": device_ms(torch, lambda: torch.linalg.solve_ex(r, b[..., None], check_errors=False),
                                           reps=5),
                  "bound_ms": solve_lim[0], "bound_by": solve_lim[1],
                  "sdr_functional_ms": device_ms(torch, lambda: sdr(p_norm, t_norm), reps=5),
                  "syncs": one_call_syncs(torch, lambda: torch.linalg.solve_ex(r, b[..., None],
                                                                               check_errors=False))[0]},
    }
    check(report["A_wsj0_2mix"]["solve"]["syncs"] == 0, "the batched solve synchronised with the host")
    check(SEP_SI_SDR_DB[0] <= float(values.mean()) <= SEP_SI_SDR_DB[1],
          f"the 2-mix estimates' mean SI-SDR {float(values.mean())} dB is outside {SEP_SI_SDR_DB}")
    print("slice 17 A, WSJ0-2mix: " + json.dumps(report["A_wsj0_2mix"]))
    del pit_si, pit_si_engine, pit_sdr, sdr_engine, sdr_eager, fresh_sdr, prefix, r, b
    laps.mark("3. slice 17 A: WSJ0-2mix timings")

    # ------------------------------------------------------ B. WSJ0-3mix and WSJ0-5mix
    report["B_wsj0_3mix_5mix"] = {}
    for spk, mixtures, seed in ((3, WSJ_MIXTURES, SEED + 172), (5, WSJ5_MIXTURES, SEED + 173)):
        g = torch.Generator(device=dev).manual_seed(seed)
        pit = M.PermutationInvariantTraining(si_sdr, device=dev)
        misses, values = torch.zeros((), dtype=torch.int64, device=dev), []
        first = None
        for length, n in length_batches(mixtures, WSJ_LENGTHS_S, WSJ_BATCH):
            preds, target, planted = separation_batch(torch, g, n, spk, int(length * WSJ_FS), dev)
            metric, perm = tF.permutation_invariant_training(preds, target, si_sdr)
            misses += (perm.long() != torch.argsort(planted, dim=1)).any(dim=1).sum()
            values.append(metric)
            pit.update(preds, target)
            first = first or (preds, target, planted)
        torch.cuda.synchronize()
        values = torch.cat(values)
        check(int(misses) == 0, f"PIT over SI-SDR missed {int(misses)} of the {mixtures} planted {spk}-speaker orders")
        check(int(pit.total) == mixtures, f"the {spk}-mix count {int(pit.total)}")
        preds, target, planted = first
        got, got_perm = tF.permutation_invariant_training(preds, target, si_sdr)
        want, want_perm = tF.permutation_invariant_training(preds.cpu(), target.cpu(), si_sdr)
        ref = best_of(pair_matrix(numpy_si_sdr, preds.cpu().numpy(), target.cpu().numpy()), want_perm.long().numpy())
        check(torch.equal(got_perm.cpu(), want_perm), f"{spk}-mix PIT orders on the card and the CPU differ")
        close(torch, got, want, f"{spk}-mix PIT over SI-SDR against the CPU", atol=2 * DB_ATOL17)
        close(torch, got, torch.from_numpy(ref), f"{spk}-mix PIT over SI-SDR against float64", atol=DB_ATOL17)
        upd = lambda: pit.update(preds, target)  # noqa: E731
        entry = {"speakers": spk, "mixtures": mixtures, "permutations": math.factorial(spk),
                 "search": "exhaustive" if spk < 4 else "hungarian",
                 "value": float(pit.compute()), "si_sdr_pit_mean_db": float(values.mean()),
                 "update_ms": host_ms(torch, upd, reps=5), "compute_ms": host_ms(torch, pit._compute_impl, reps=5),
                 "update_syncs": one_call_syncs(torch, upd), "compute_syncs": one_call_syncs(torch, pit._compute_impl)[0]}
        if spk < 4:
            check(entry["update_syncs"][0] == 0, f"a {spk}-mix PIT update synchronised with the host")
        else:
            check(entry["update_syncs"][0] == 1, f"a {spk}-mix PIT update made {entry['update_syncs']} host syncs, "
                  "not the Hungarian search's one read")
        check(entry["compute_syncs"] == 0, f"a {spk}-mix PIT compute synchronised with the host")
        report["B_wsj0_3mix_5mix"][f"{spk}mix"] = entry
        print(f"slice 17 B, WSJ0-{spk}mix: " + json.dumps(entry))
        del pit, first
    laps.mark("3. slice 17 B: WSJ0-3mix and WSJ0-5mix")

    # ------------------------------------------------------ C. VoiceBank+DEMAND
    g = torch.Generator(device=dev).manual_seed(SEED + 174)
    vb = []
    for length, n in length_batches(VB_UTTERANCES, VB_LENGTHS_S, VB_BATCH):
        samples = int(length * VB_FS)
        clean = speech_sources(torch, g, n, 1, samples, VB_FS, dev)[:, 0]
        noise = speech_sources(torch, g, n, 1, samples, VB_FS, dev)[:, 0].roll(samples // 3, dims=-1)
        noise = noise + torch.randn(n, samples, generator=g, device=dev)  # a babble and a broadband floor
        snr_db = VB_SNR_DB[0] + (VB_SNR_DB[1] - VB_SNR_DB[0]) * torch.rand(n, 1, generator=g, device=dev)
        noise = noise / noise.square().mean(-1, keepdim=True).sqrt() * 10 ** (-snr_db / 20)
        vb.append((clean + noise, clean))
    mods = {"stoi": M.ShortTimeObjectiveIntelligibility(VB_FS, device=dev),
            "estoi": M.ShortTimeObjectiveIntelligibility(VB_FS, extended=True, device=dev),
            "si_sdr": M.ScaleInvariantSignalDistortionRatio(device=dev), "snr": M.SignalNoiseRatio(device=dev)}
    for noisy_b, clean_b in vb:
        for m in mods.values():
            m.update(noisy_b, clean_b)
    torch.cuda.synchronize()
    c_values = {k: float(m.compute()) for k, m in mods.items()}
    check(all(int(m.total) == VB_UTTERANCES for m in mods.values()), "a VoiceBank count is not 824")
    check(all(math.isfinite(v) for v in c_values.values()), f"a VoiceBank value is not finite: {c_values}")
    laps.mark("3. slice 17 C: VoiceBank+DEMAND on the card")
    # STOI twice on the card: the same bits
    again = {k: M.ShortTimeObjectiveIntelligibility(VB_FS, extended=k == "estoi", device=dev) for k in ("stoi", "estoi")}
    for noisy_b, clean_b in vb:
        for m in again.values():
            m.update(noisy_b, clean_b)
    for key, m in again.items():
        check(torch.equal(m.sum_stoi, mods[key].sum_stoi), f"{key} on the card differs between two runs")
    laps.mark("3. slice 17 C: STOI again")
    # the first batches on the CPU, and SNR and SI-SDR against float64
    c_prefix = {}
    for noisy_b, clean_b in vb[:VB_CPU_BATCHES]:
        n_np, c_np = noisy_b.cpu().numpy(), clean_b.cpu().numpy()
        for key, fn, kwargs, tol, f64 in (
            ("snr", tF.signal_noise_ratio, {}, {"atol": DB_ATOL17}, numpy_snr),
            ("si_sdr", si_sdr, {}, {"atol": DB_ATOL17}, numpy_si_sdr),
            ("stoi", tF.short_time_objective_intelligibility, {"fs": VB_FS}, {"atol": STOI_ATOL17}, None),
            ("estoi", tF.short_time_objective_intelligibility, {"fs": VB_FS, "extended": True},
             {"atol": STOI_ATOL17}, None),
        ):
            got, want = fn(noisy_b, clean_b, **kwargs), fn(noisy_b.cpu(), clean_b.cpu(), **kwargs)
            close(torch, got, want, f"VoiceBank {key} on the card against the CPU", **tol)
            c_prefix[key] = max(c_prefix.get(key, 0.0), float((got.cpu().double() - want.double()).abs().max()))
            if f64 is not None:
                close(torch, got, torch.from_numpy(f64(n_np, c_np)), f"VoiceBank {key} against float64", **tol)
    laps.mark("3. slice 17 C: VoiceBank on the CPU")
    # PESQ: the module over the utterances, and its value against the core called on the same host arrays
    pesq = M.PerceptualEvaluationSpeechQuality(VB_FS, "wb", backend="native", device=dev)
    t0 = time.perf_counter()
    done = 0
    for noisy_b, clean_b in vb:
        if done >= VB_PESQ_UTTERANCES:
            break
        pesq.update(noisy_b, clean_b)
        done += noisy_b.shape[0]
    torch.cuda.synchronize()
    pesq_s = time.perf_counter() - t0
    direct = torch.zeros((), dtype=torch.float32, device=dev)
    check_mod = M.PerceptualEvaluationSpeechQuality(VB_FS, "wb", backend="native", device=dev)
    for noisy_b, clean_b in vb[:VB_CPU_BATCHES]:
        check_mod.update(noisy_b, clean_b)
        n_np = noisy_b.detach().to(cpu, torch.float32).numpy()
        c_np = clean_b.detach().to(cpu, torch.float32).numpy()
        scores = np.array([pesq_native(VB_FS, c, p, "wb") for c, p in zip(c_np, n_np)], np.float32)
        direct = direct + float(scores.sum())
    check(torch.equal(check_mod.sum_pesq, direct), "PESQ's module sum differs from the core called on the host arrays")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pesq_jit = M.PerceptualEvaluationSpeechQuality(VB_FS, "wb", backend="native", jit_update=True, device=dev)
    messages = [str(w.message) for w in caught]
    check(messages == ["PerceptualEvaluationSpeechQuality is host_only (host-side update path); ignoring "
                       "jit_update=True — updates run eagerly."], f"PESQ with jit_update=True warned {messages}")
    pesq_jit.update(*vb[0])
    first_pesq = M.PerceptualEvaluationSpeechQuality(VB_FS, "wb", backend="native", device=dev)
    first_pesq.update(*vb[0])
    check(torch.equal(pesq_jit.sum_pesq, first_pesq.sum_pesq) and pesq_jit._dispatcher is None,
          "PESQ with jit_update=True did not run the eager update")
    laps.mark("3. slice 17 C: PESQ")
    # timings on a warm batch of 8 utterances of 5 s; the resampling convolution and its bound
    mid = next(b for b in vb if b[0].shape == (VB_BATCH, 5 * VB_FS))
    fresh = {"stoi": M.ShortTimeObjectiveIntelligibility(VB_FS, device=dev),
             "estoi": M.ShortTimeObjectiveIntelligibility(VB_FS, extended=True, device=dev),
             "si_sdr": M.ScaleInvariantSignalDistortionRatio(device=dev), "snr": M.SignalNoiseRatio(device=dev)}
    c_ms, c_syncs = {}, {}
    for key, m in fresh.items():
        c_ms[f"{key} update"] = host_ms(torch, lambda m=m: m.update(*mid), reps=5)
        c_ms[f"{key} compute"] = host_ms(torch, m._compute_impl, reps=5)
        c_syncs[f"{key} update"] = one_call_syncs(torch, lambda m=m: m.update(*mid))[0]
        c_syncs[f"{key} compute"] = one_call_syncs(torch, m._compute_impl)[0]
    check(not any(c_syncs.values()), f"a VoiceBank update or compute synchronised with the host: {c_syncs}")
    g_up = math.gcd(VB_FS, 10_000)
    up, down = 10_000 // g_up, VB_FS // g_up
    h = _resample_kernel(up, down, dev)
    half = (h.shape[-1] - 1) // 2
    x_up = torch.nn.functional.pad(torch.nn.functional.pad(mid[1][..., None], (0, up - 1)).reshape(VB_BATCH, -1),
                                   (half, half))[:, None, :]

    def conv():
        with _full_float32():
            return torch.nn.functional.conv1d(x_up, h, stride=down)

    n_out = conv().shape[-1]
    conv_lim = bound((x_up.numel() + VB_BATCH * n_out + h.numel()) * 4, VB_BATCH * n_out * h.numel() * 2)
    report["C_voicebank"] = {
        "utterances": VB_UTTERANCES, "batches": len(vb), "values": c_values, "prefix_max_abs_diff_cpu": c_prefix,
        "pesq": {"utterances": done, "value": float(pesq.compute()), "host_s": pesq_s,
                 "host_ms_per_utterance": pesq_s * 1e3 / done},
        "ms": c_ms, "syncs": c_syncs,
        "resample": {"shape": list(mid[1].shape), "up": up, "down": down, "taps": h.numel(), "outputs": n_out,
                     "conv_ms": device_ms(torch, conv, reps=5), "bound_ms": conv_lim[0], "bound_by": conv_lim[1],
                     "resample_ms": device_ms(torch, lambda: _resample_to_10k(mid[1], VB_FS), reps=5),
                     "gflop": VB_BATCH * n_out * h.numel() * 2 / 1e9},
    }
    print("slice 17 C, VoiceBank+DEMAND: " + json.dumps(report["C_voicebank"]))
    del vb, mods, again, fresh, x_up
    laps.mark("3. slice 17 C: VoiceBank timings")

    slice17_launches = launches()
    check(all(n == 0 for n in slice17_launches.values()), f"slice 17 launched a kernel: {slice17_launches}")
    report["launches"] = slice17_launches
    report["command_s"] = time.perf_counter() - t_slice
    print(f"slice 17 ({card}): " + json.dumps(report, default=str))
    return slice17_launches


_UPPER_SYLLABLES = [c + v for c in "BCDFGHJKLMNPRSTVWY" for v in "AEIOU"] + ["TH", "SH", "CH", "ST", "NG"]
_LOWER_SYLLABLES = [c + v for c in "bcdfghklmnprstvwz" for v in "aeiou"] + ["sch", "ei", "ie", "ung", "st"]


def synthetic_vocab(rng, n, syllables, apostrophe=0.0):
    """``n`` distinct words of one to three syllables, in the order a Zipf draw ranks them."""
    words, seen = [], set()
    while len(words) < n:
        for k in rng.randint(1, 4, 4 * n):
            w = "".join(syllables[i] for i in rng.randint(0, len(syllables), k))
            if rng.rand() < apostrophe:
                w += "'S"
            if w not in seen:
                seen.add(w)
                words.append(w)
                if len(words) == n:
                    break
    return words


def zipf_draw(rng, n_types, size):
    """``size`` ranks of a Zipf law (s = ``TEXT_ZIPF``) over ``n_types`` types."""
    p = 1.0 / np.arange(1, n_types + 1) ** TEXT_ZIPF
    return rng.choice(n_types, size, p=p / p.sum())


def corpus_lengths(rng, n, total, sigma=0.6):
    """``n`` log-normal sentence lengths of at least 1 that sum to ``total``."""
    raw = rng.lognormal(0.0, sigma, n)
    lengths = np.maximum(1, np.round(raw / raw.mean() * total / n)).astype(np.int64)
    while lengths.sum() != total:
        step = 1 if lengths.sum() < total else -1
        idx = rng.randint(0, n, abs(int(total - lengths.sum())))
        np.add.at(lengths, idx[lengths[idx] + step >= 1], step)
    return lengths


def fresh_word(rng, k):
    """A word of ``k`` lowercase letters: characters no LibriSpeech-style reference holds."""
    return "".join(chr(97 + c) for c in rng.randint(0, 26, k))


def asr_corpus(rng, vocab, n, total_words, rate):
    """LibriSpeech-shaped references and hypotheses with planted substitutions
    and insertions of fresh words; the planted word and character counts."""
    lengths = corpus_lengths(rng, n, total_words)
    ranks = zipf_draw(rng, len(vocab), total_words)
    draws = rng.rand(total_words, 2)
    refs, hyps, planted_w, planted_c, pos = [], [], 0, 0, 0
    for length in lengths:
        ref = [vocab[i] for i in ranks[pos:pos + length]]
        hyp = []
        for j, w in enumerate(ref):
            if draws[pos + j, 0] < 0.6 * rate:  # a fresh word of the replaced word's length: len(w) characters
                hyp.append(fresh_word(rng, len(w)))
                planted_w, planted_c = planted_w + 1, planted_c + len(w)
            else:
                hyp.append(w)
            if draws[pos + j, 1] < 0.4 * rate:  # a fresh word joined by a tab: its characters and the tab
                word = fresh_word(rng, int(rng.randint(2, 9)))
                hyp[-1] += "\t" + word
                planted_w, planted_c = planted_w + 1, planted_c + len(word) + 1
        pos += length
        refs.append(" ".join(ref))
        hyps.append(" ".join(hyp))
    return hyps, refs, planted_w, planted_c


def edit_words(rng, words, vocab, sub=0.1, dele=0.05, ins=0.05, shift=0.4):
    """``words`` with substitutions and insertions from ``vocab``, deletions and at most one phrase shift."""
    out = []
    for w in words:
        r = rng.rand()
        if r < dele:
            continue
        out.append(vocab[rng.randint(0, len(vocab))] if r < dele + sub else w)
        if rng.rand() < ins:
            out.append(vocab[rng.randint(0, len(vocab))])
    if len(out) > 4 and rng.rand() < shift:
        start = int(rng.randint(0, len(out) - 1))
        size = int(rng.randint(1, min(4, len(out) - start) + 1))
        span, rest = out[start:start + size], out[:start] + out[start + size:]
        at = int(np.clip(start + rng.randint(-8, 9), 0, len(rest)))
        out = rest[:at] + span + rest[at:]
    return out


def mt_corpus(rng, name, n, n_refs, mean_len):
    """A translation test set's shape: ``(preds, targets)`` with ``n_refs``
    references a segment. Words (German-like, English-like for MT02) with
    capitals, commas, numbers and a final stop; for en-zh, characters of the
    CJK Unified Ideographs block with full-width punctuation and an odd Latin
    token. The hypothesis edits a base sentence (fresh words or characters
    substituted and inserted, deletions, a shift); each reference is the base,
    or a paraphrase of it for the second and later ones."""
    zh = name.endswith("zh")
    lengths = corpus_lengths(rng, n, int(n * mean_len))
    if zh:
        inventory = [chr(0x4E00 + i) for i in rng.permutation(0x9FA5 - 0x4E00)[:CJK_INVENTORY]]
        fresh = [chr(0x3400 + i) for i in range(2000)]  # Extension A: in no reference
        tokens, fresh_tokens = inventory, fresh
    else:
        tokens = synthetic_vocab(rng, TEXT_VOCAB, _LOWER_SYLLABLES)
        fresh_tokens = [w + "x" for w in synthetic_vocab(rng, 2000, _UPPER_SYLLABLES)]
    ranks = zipf_draw(rng, len(tokens), int(lengths.sum()))
    preds, targets, pos = [], [], 0
    for length in lengths:
        base = [tokens[i] for i in ranks[pos:pos + length]]
        pos += length
        if not zh:
            base = [w.capitalize() if rng.rand() < 0.25 else w for w in base]
            base = [w + "," if rng.rand() < 0.07 else w for w in base]
            if rng.rand() < 0.2:
                base.insert(int(rng.randint(0, len(base) + 1)), f"{rng.randint(1, 2020)}")
        hyp = edit_words(rng, base, fresh_tokens, sub=0.12, dele=0.05, ins=0.05)
        refs = [base] + [edit_words(rng, base, tokens, sub=0.15, dele=0.05, ins=0.05) for _ in range(n_refs - 1)]
        preds.append(mt_segment(hyp, zh))
        targets.append([mt_segment(r, zh) for r in refs])
    return preds, targets


def mt_segment(tokens, zh):
    """Chinese characters with a full-width comma midway and a full stop; words with spaces and a stop."""
    if zh:
        half = len(tokens) // 2
        return "".join(tokens[:half]) + "，" + "".join(tokens[half:]) + "。"
    return " ".join(tokens) + ("." if tokens else "")


def float64_bleu(preds, targets, n_gram=4):
    """Corpus BLEU in float64, written apart from the port: clipped n-gram
    counts (a reference n-gram's count is its most in any reference), the
    first reference of the closest length, the brevity penalty."""
    num, den = np.zeros(n_gram), np.zeros(n_gram)
    p_len = t_len = 0
    for pred, refs in zip(preds, targets):
        hyp, refs = pred.split(), [r.split() for r in refs]
        p_len += len(hyp)
        diffs = [abs(len(hyp) - len(r)) for r in refs]
        t_len += len(refs[diffs.index(min(diffs))])
        for n in range(1, n_gram + 1):
            grams = collections.Counter(tuple(hyp[i:i + n]) for i in range(len(hyp) - n + 1))
            most = collections.Counter()
            for r in refs:
                for g, c in collections.Counter(tuple(r[i:i + n]) for i in range(len(r) - n + 1)).items():
                    most[g] = max(most[g], c)
            num[n - 1] += sum(min(c, most[g]) for g, c in grams.items())
            den[n - 1] += sum(grams.values())
    if num.min() == 0:
        return 0.0
    bp = 1.0 if p_len > t_len else math.exp(1 - t_len / p_len)
    return bp * math.exp(np.mean(np.log(num / den)))


@contextlib.contextmanager
def native_clock():
    """Seconds spent in the edit-distance core's entry points while the block runs (``spent[0]``)."""
    from metrics_tpu_torch import native

    spent = [0.0]
    names = ("levenshtein_ids", "levenshtein_batch_ids", "ngram_overlap", "eed_score")
    saved = {name: getattr(native, name) for name in names}

    def timed(fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[0] += time.perf_counter() - t0

        return call

    for name in names:
        setattr(native, name, timed(saved[name]))
    try:
        yield spent
    finally:
        for name, fn in saved.items():
            setattr(native, name, fn)


def text_epoch(torch, mods, batches, on_batch=None):
    """Every batch through every module, each update timed to the card's
    completion with the core's seconds inside it; ``on_batch(i)`` after batch
    ``i``. Returns the epoch's seconds and, a module, its median update ms and
    the core's share of its update time."""
    ms = {k: [] for k in mods}
    core = dict.fromkeys(mods, 0.0)
    t_epoch = time.perf_counter()
    with native_clock() as spent:
        for i, (preds, target) in enumerate(batches):
            for key, m in mods.items():
                before, t0 = spent[0], time.perf_counter()
                m.update(preds, target)
                torch.cuda.synchronize()
                ms[key].append((time.perf_counter() - t0) * 1e3)
                core[key] += spent[0] - before
            if on_batch is not None:
                on_batch(i)
    epoch_s = time.perf_counter() - t_epoch
    return epoch_s, {k: {"update_ms_median": statistics.median(v), "core_share": core[k] / (sum(v) / 1e3)}
                     for k, v in ms.items()}


def text_values(m):
    """A text metric's value as host numbers: a float, or a float and a list of sentence scores."""
    value = m.compute()
    if isinstance(value, tuple):
        return [float(value[0]), value[1].reshape(-1).tolist()]
    return float(value)


def text_close(got, want, rtol):
    """Two :func:`text_values`: the scores within ``rtol``, any sentence scores equal."""
    g, w = (got, want) if isinstance(got, float) else (got[0], want[0])
    return abs(g - w) <= rtol * abs(w) and (isinstance(got, float) or got[1] == want[1])


def text_states_equal(torch, a, b):
    for key in a._defaults:
        x, y = getattr(a, key), getattr(b, key)
        pairs = zip(x, y) if isinstance(x, list) else [(x, y)]
        if (isinstance(x, list) and len(x) != len(y)) or not all(torch.equal(u.cpu(), v.cpu()) for u, v in pairs):
            return False
    return True


def mt_modules(M, dev, zh, intl=False):
    mods = {} if zh else {"bleu": M.BLEUScore(device=dev)}
    mods["sacrebleu_13a"] = M.SacreBLEUScore(tokenize="13a", device=dev)
    if intl:
        mods["sacrebleu_intl"] = M.SacreBLEUScore(tokenize="intl", device=dev)
    if zh:
        mods["sacrebleu_zh"] = M.SacreBLEUScore(tokenize="zh", device=dev)
        mods["sacrebleu_char"] = M.SacreBLEUScore(tokenize="char", device=dev)
    mods["chrf"] = M.CHRFScore(n_word_order=0, device=dev)
    mods["chrf++"] = M.CHRFScore(n_word_order=2, return_sentence_level_score=True, device=dev)
    mods["ter"] = M.TranslationEditRate(return_sentence_level_score=True, normalize=zh, asian_support=zh, device=dev)
    mods["eed"] = M.ExtendedEditDistance(device=dev)
    return mods


def run_slice18(torch, dev, laps):
    """Slice 18 (see the module's docstring): returns the kernels' launches on
    its path (all 0: strings stay on the host, and no text metric reaches a
    kernel of the registry)."""
    import metrics_tpu_torch as M
    from metrics_tpu_torch import native
    from metrics_tpu_torch.dispatch import FastDispatchUnsupported
    from metrics_tpu_torch.functional.text.chrf import _sentence_stats, _sentence_stats_plain
    from metrics_tpu_torch.functional.text.eed import _eed_function, _eed_function_plain, _preprocess_en
    from metrics_tpu_torch.functional.text.helper import _edit_distance_py, _edit_distances
    from metrics_tpu_torch.functional.text.ter import _TercomTokenizer, _ter_stats
    from metrics_tpu_torch.ops import launches, reset_launches
    from metrics_tpu_torch.utilities.imports import _REGEX_AVAILABLE

    t_slice = time.perf_counter()
    cpu = torch.device("cpu")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    native.load()
    report = {"card": card, "core_build_s": time.perf_counter() - t0}
    reset_launches()
    rng = np.random.RandomState(SEED + 18)

    # ------------------------------------------------------------ A. LibriSpeech
    vocab = synthetic_vocab(rng, TEXT_VOCAB, _UPPER_SYLLABLES, apostrophe=0.03)
    names = ("WordErrorRate", "CharErrorRate", "MatchErrorRate", "WordInfoLost", "WordInfoPreserved")
    report["A_librispeech"] = {}
    for split, n, words, rate in LIBRI_SETS:
        hyps, refs, planted_w, planted_c = asr_corpus(rng, vocab, n, words, rate)
        batches = [(hyps[i:i + ASR_BATCH], refs[i:i + ASR_BATCH]) for i in range(0, n, ASR_BATCH)]
        coll = M.MetricCollection({k: getattr(M, k)(device=dev) for k in names})
        epoch_s, _ = text_epoch(torch, {"collection": coll}, batches)
        alone = {k: getattr(M, k)(device=dev) for k in names}
        _, per_metric = text_epoch(torch, alone, batches)
        host = M.MetricCollection({k: getattr(M, k)(device=cpu) for k in names})
        for b in batches:
            host.update(*b)
        values, host_values = coll.compute(), host.compute()
        n_chars = sum(len(r) for r in refs)
        wer, cer = coll["WordErrorRate"], coll["CharErrorRate"]
        check(float(wer.errors) == planted_w and float(wer.total) == words and float(cer.errors) == planted_c
              and float(cer.total) == n_chars,
              f"{split}: the error counts {float(wer.errors)}, {float(cer.errors)} are not the planted {planted_w}, "
              f"{planted_c} over {words} words and {n_chars} characters")
        for key, planted, total in (("WordErrorRate", planted_w, words), ("CharErrorRate", planted_c, n_chars)):
            want = np.float32(planted) / np.float32(total)
            check(values[key].cpu().numpy().tobytes() == want.tobytes(),
                  f"{split}: {key} {float(values[key])!r} is not float32({planted}) / float32({total}) = {want!r}")
        for key in names:
            check(values[key].device.type == "cuda" and torch.equal(values[key].cpu(), host_values[key])
                  and text_states_equal(torch, coll[key], host[key]),
                  f"{split}: {key} on the card differs from the CPU run")
        b = batches[len(batches) // 2]
        report["A_librispeech"][split] = {
            "utterances": n, "words": words, "characters": n_chars, "batches": len(batches),
            "planted_word_edits": planted_w, "planted_char_edits": planted_c,
            "values": {k: float(v) for k, v in values.items()}, "epoch_s": epoch_s,
            "update_ms": per_metric, "collection_update_ms": host_ms(torch, lambda b=b: coll.update(*b), reps=5),
            "compute_ms": {k: host_ms(torch, m._compute_impl, reps=5) for k, m in alone.items()},
            "update_syncs": one_call_syncs(torch, lambda b=b: coll.update(*b))[0],
            "compute_syncs": {k: one_call_syncs(torch, m._compute_impl)[0] for k, m in alone.items()},
        }
        entry = report["A_librispeech"][split]
        check(entry["update_syncs"] == 0 and not any(entry["compute_syncs"].values()),
              f"{split}: an error-rate update or compute synchronised with the host: {entry['update_syncs']}, "
              f"{entry['compute_syncs']}")
        print(f"slice 18 A, LibriSpeech {split}: " + json.dumps(entry))
        laps.mark(f"3. slice 18 A: LibriSpeech {split}")
    # the core's batched Levenshtein against the Python DP, on pairs with deletions and shifts, words and characters
    pairs = []
    for ref in refs[:CORE_CHECKS["levenshtein"]]:
        hyp = edit_words(rng, ref.split(), vocab, sub=0.05, dele=0.1, ins=0.03, shift=0.5)
        pairs += [(hyp, ref.split()), (list(" ".join(hyp)), list(ref))]
    check(_edit_distances(pairs) == [_edit_distance_py(a, b) for a, b in pairs],
          "the core's batched Levenshtein differs from the Python DP")
    laps.mark("3. slice 18 A: the core against the Python DP")

    # ------------------------------------------------------------ B. translation
    report["B_translation"] = {}
    for name, n, n_refs, mean_len in MT_SETS:
        zh = name.endswith("zh")
        preds, targets = mt_corpus(rng, name, n, n_refs, mean_len)
        batches = [(preds[i:i + MT_BATCH], targets[i:i + MT_BATCH]) for i in range(0, n, MT_BATCH)]
        intl = name == "wmt14-en-de" and _REGEX_AVAILABLE
        mods = mt_modules(M, dev, zh, intl)
        prefix = {}

        def note_prefix(i, mods=mods, prefix=prefix):
            if i == MT_CPU_BATCHES - 1:
                prefix.update({k: text_values(m) for k, m in mods.items()})

        epoch_s, per_metric = text_epoch(torch, mods, batches, note_prefix)
        values = {k: text_values(m) for k, m in mods.items()}
        host = mt_modules(M, cpu, zh, intl)
        for b in batches[:MT_CPU_BATCHES]:
            for m in host.values():
                m.update(*b)
        for key, m in host.items():
            got, want = prefix[key], text_values(m)
            # BLEU's log and exp and EED's nanmean round apart on the two devices; chrF's score is host arithmetic,
            # TER's one division, the sentence scores host numbers: exact
            rtol = TEXT_CARD_CPU_RTOL if key.startswith(("bleu", "sacrebleu", "eed")) else 0.0
            check(text_close(got, want, rtol), f"{name}: {key} on the card after {MT_CPU_BATCHES} batches, "
                  f"{str(got)[:200]}, differs from the CPU run over them, {str(want)[:200]}")
        entry = {"segments": n, "references": n_refs, "batches": len(batches), "epoch_s": epoch_s,
                 "values": {k: v if isinstance(v, float) else v[0] for k, v in values.items()},
                 "update_ms": per_metric}
        if not zh:
            f64 = float64_bleu(preds, targets)
            entry["bleu_float64"] = f64
            check(abs(values["bleu"] - f64) <= BLEU_F64_ATOL, f"{name}: BLEU {values['bleu']} against float64 {f64}")
        b = batches[len(batches) // 2]
        entry["compute_ms"] = {k: host_ms(torch, m._compute_impl, reps=5) for k, m in mods.items()}
        entry["update_syncs"] = {k: one_call_syncs(torch, lambda m=m: m.update(*b))[0] for k, m in mods.items()}
        entry["compute_syncs"] = {k: one_call_syncs(torch, m._compute_impl)[0] for k, m in mods.items()}
        want_reads = {k: (1 if k.startswith("chrf") else 0) for k in mods}
        check(not any(entry["update_syncs"].values()) and entry["compute_syncs"] == want_reads,
              f"{name}: host syncs {entry['update_syncs']} an update and {entry['compute_syncs']} a compute, not 0 "
              f"and {want_reads}")
        if name == "wmt14-en-de":
            # the core against its plain versions on the first segments
            sample = list(zip(preds, targets))
            for pred, tgts in sample[:CORE_CHECKS["chrf"]]:
                check(_sentence_stats(pred, tgts, 6, 2, False, False, 2.0)
                      == _sentence_stats_plain(pred, tgts, 6, 2, False, False, 2.0),
                      "chrF's core differs from its Counter path")
            gaps = [abs(_eed_function(_preprocess_en(p), _preprocess_en(t[0]))
                        - _eed_function_plain(_preprocess_en(p), _preprocess_en(t[0])))
                    for p, t in sample[:CORE_CHECKS["eed"]]]
            check(max(gaps) <= 1e-12, f"EED's core is {max(gaps)} from the numpy grid")
            tok = _TercomTokenizer()
            sub_p, sub_t = preds[:CORE_CHECKS["ter"]], targets[:CORE_CHECKS["ter"]]
            check(_ter_stats(sub_p, sub_t, tok) == _ter_stats(
                sub_p, sub_t, tok, lambda ps: [_edit_distance_py(a, b) for a, b in ps]),
                "TER through the core differs from TER through the Python DP")
            entry["core_checks"] = dict(CORE_CHECKS, eed_max_abs_diff=max(gaps))
        report["B_translation"][name] = entry
        print(f"slice 18 B, {name}: " + json.dumps(entry))
        laps.mark(f"3. slice 18 B: {name}")
        del mods, host

    # ------------------------------------------------------------ C. the engines refuse
    for cls in ("WordErrorRate", "CHRFScore", "TranslationEditRate"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            m = getattr(M, cls)(jit_update=True, device=dev)
        messages = [str(w.message) for w in caught]
        check(messages == [f"{cls} is host_only (host-side update path); ignoring jit_update=True — updates run "
                           "eagerly."], f"{cls} with jit_update=True warned {messages}")
        m.update(["A B"], ["A C"])
        check(m._dispatcher is None and m.dispatch_stats["dispatches"] == 1,
              f"{cls} with jit_update=True did not run the eager update")
        try:
            m._make_dispatcher().update({}, (), (["A B"], ["A C"]), {})
            refused = None
        except FastDispatchUnsupported as err:
            refused = str(err)
        check(refused == f"{cls} is host_only: its update runs host-side code (strings/tokenizers/native libraries)"
              " the engine cannot trace", f"{cls}'s engine did not refuse with the JAX package's error: {refused}")
    print("slice 18: SacreBLEU's intl tokenizer " + ("ran on WMT14 en-de" if _REGEX_AVAILABLE else
          "is not driven: it needs the regex package, which this machine lacks") +
          "; tests/test_torch_text_mt.py holds it against the JAX package on the CPU")

    slice18_launches = launches()
    check(all(n == 0 for n in slice18_launches.values()), f"slice 18 launched a kernel: {slice18_launches}")
    report["launches"] = slice18_launches
    report["command_s"] = time.perf_counter() - t_slice
    laps.mark("3. slice 18 C: the engines")
    print(f"slice 18 ({card}): " + json.dumps(report, default=str))
    return slice18_launches


def distinct_ranks(rng, n, k):
    """``k`` distinct ranks below ``n``, in a random order."""
    while True:
        ranks = list(dict.fromkeys(rng.randint(0, n, 2 * k).tolist()))
        if len(ranks) >= k:
            return ranks[:k]


def summary_sentence(rng, words):
    """A highlight sentence: the first word capitalized, now and then behind an
    abbreviation (``Mr.``, ``U.S.``, ...) or initials, ending in ``.``, ``!`` or ``?``."""
    words = list(words) or ["news"]
    r = rng.rand()
    if r < 0.12:
        words = [str(rng.choice(["Mr.", "Mrs.", "Dr.", "Sen.", "Gov."])), words[0].capitalize()] + words[1:]
    elif r < 0.18:
        words = ["U.S."] + words
    elif r < 0.22:
        words = [f"{chr(65 + rng.randint(26))}. {chr(65 + rng.randint(26))}.", words[0].capitalize()] + words[1:]
    words[0] = words[0][0].upper() + words[0][1:]
    end = rng.rand()
    return " ".join(words) + ("." if end < 0.8 else "!" if end < 0.9 else "?")


def cnndm_corpus(rng, vocab, n):
    """CNN/DailyMail 3.0.0 test's shape: ``(preds, targets, planted)``. A
    reference highlight has 3 to 5 sentences of Zipf words, about
    ``CNNDM_REF_WORDS`` words in all; its candidate keeps ``CNNDM_CAND_SENTS``
    of them in order, edited (substitutions, deletions, insertions, a shift).
    Every ``CNNDM_PLANTED_EVERY``-th pair is planted: a reference of 40 to 71
    distinct words in four sentences and a candidate of the same words with k
    of them replaced by fresh ones (a word and an ``x``, which no vocabulary
    word holds), so ROUGE-1's and ROUGE-L's hits are ``n - k`` of ``n`` on each
    side; ``planted[i] = (n, k)``. Every ``CNNDM_IDENTICAL_EVERY``-th pair is
    identical (``planted[i] = None``)."""
    ranks = zipf_draw(rng, len(vocab), 2 * n * CNNDM_REF_WORDS)
    preds, targets, planted, pos = [], [], {}, 0
    for i in range(n):
        if i % CNNDM_PLANTED_EVERY == 0:
            n_words = int(rng.randint(40, 72))
            words = [vocab[j] for j in distinct_ranks(rng, len(vocab), n_words)]
            k = int(rng.randint(0, n_words // 3))
            swapped = set(distinct_ranks(rng, n_words, k))
            cand = [vocab[int(rng.randint(len(vocab)))] + "x" if j in swapped else w for j, w in enumerate(words)]
            cuts = np.linspace(0, n_words, CNNDM_REF_SENTS + 1).astype(int)

            def fmt(ws, cuts=cuts):
                return " ".join(" ".join(ws[a:b]).capitalize() + "." for a, b in zip(cuts[:-1], cuts[1:]))

            targets.append(fmt(words))
            preds.append(fmt(cand))
            planted[i] = (n_words, k)
            continue
        n_sents = int(rng.choice([3, 4, 4, 5]))
        lengths = np.maximum(3, rng.poisson(CNNDM_REF_WORDS / CNNDM_REF_SENTS, n_sents))
        sents = []
        for length in lengths:
            sents.append([vocab[j] for j in ranks[pos:pos + length]])
            pos += int(length)
        ref = " ".join(summary_sentence(rng, s) for s in sents)
        if i % CNNDM_IDENTICAL_EVERY == 0:
            preds.append(ref)
            planted[i] = None
        else:
            keep = sorted(rng.choice(n_sents, min(CNNDM_CAND_SENTS, n_sents), replace=False).tolist())
            preds.append(" ".join(summary_sentence(rng, edit_words(rng, sents[j], vocab, sub=0.1, dele=0.1, ins=0.05,
                                                                    shift=0.2)) for j in keep))
        targets.append(ref)
    return preds, targets, planted


class WideEmbedder:
    """An embedder at roberta-large's width: a seeded (50,265 x 1,024)
    float32 table on ``table``'s device. A word's row is a BLAKE2b hash of it
    folded into the vocabulary (3 and up); a sentence is [CLS] (0), its words
    and [SEP] (2), cut at 512 tokens, right-padded with PAD (1). The ids and
    the mask reach the device in one copy."""

    emits_special_tokens = True

    def __init__(self, torch, table):
        self.torch, self.table, self.rows = torch, table, {}

    def row(self, word):
        row = self.rows.get(word)
        if row is None:
            digest = hashlib.blake2b(word.encode("utf-8"), digest_size=8).digest()
            row = self.rows[word] = 3 + int.from_bytes(digest, "little") % (ROBERTA_VOCAB - 3)
        return row

    def __call__(self, sentences):
        torch = self.torch
        rows = [[0] + [self.row(w) for w in s.split()][: ROBERTA_MAX_TOKENS - 2] + [2] for s in sentences]
        length = max(len(r) for r in rows)
        host = np.ones((2, len(rows), length), dtype=np.int32)
        host[1] = 0
        for i, r in enumerate(rows):
            host[0, i, :len(r)] = r
            host[1, i, :len(r)] = 1
        buf = torch.from_numpy(host)
        if self.table.device.type == "cuda":
            buf = buf.pin_memory().to(self.table.device, non_blocking=True)
        ids, mask = buf.unbind(0)
        return self.table[ids], mask, ids


def squad_corpus(rng, vocab, n):
    """SQuAD v1.1 dev's shape: ``(preds, targets, oracle)``, questions with 1
    to 6 gold answers of 1 to 6 words. The prediction is, by construction, a
    gold answer behind "The ", in capitals with a trailing stop (exact match,
    F1 1), the first m words of the one gold answer that shares words with it
    plus j fresh ones (F1 ``2PR / (P + R)`` with P = m / (m + j) and
    R = m / n), fresh words only (0, 0), or missing (0, 0). ``oracle[i]`` is
    question i's (exact match, F1), written here from that construction."""
    words = [w for w in vocab if w not in ("a", "an", "the")]
    preds, targets, oracle = [], [], []
    for i in range(n):
        qid = f"{i:024x}"
        kind = rng.rand()
        n_answers = int(rng.randint(1, 7))
        drawn = [words[j] for j in distinct_ranks(rng, len(words), 6 * n_answers)]
        answers = [drawn[6 * a:6 * a + int(rng.randint(1, 7))] for a in range(n_answers)]
        if kind < 0.45:
            gold = answers[int(rng.randint(n_answers))]
            preds.append({"prediction_text": "The " + " ".join(gold).upper() + ".", "id": qid})
            oracle.append((1.0, 1.0))
        elif kind < 0.75:
            gold = answers[0]
            m, j = int(rng.randint(1, len(gold) + 1)), int(rng.randint(0, 3))
            if m == len(gold) and j == 0:
                j = 1
            pred = gold[:m] + [w + "x" for w in drawn[-j:]] if j else gold[:m]
            preds.append({"prediction_text": " ".join(pred), "id": qid})
            p, r = m / (m + j), m / len(gold)
            oracle.append((0.0, 2 * p * r / (p + r)))
        elif kind < 0.9:
            preds.append({"prediction_text": " ".join(w + "x" for w in drawn[:3]), "id": qid})
            oracle.append((0.0, 0.0))
        else:
            oracle.append((0.0, 0.0))  # no prediction: counted, scored 0
        targets.append({"answers": {"answer_start": [0] * n_answers, "text": [" ".join(a) for a in answers]},
                        "id": qid})
    return preds, targets, oracle


def coco_val(rng, n):
    """COCO val2017's shape, as host arrays: ``n`` images of 640 x 480 with a
    Poisson(7.3) count of ground-truth boxes (a Zipf law over the 80 classes,
    log-uniform sizes from 6 to 400 px: small, medium and large) and
    ``COCO_DETS`` detections each from a noisy detector: one or two jittered
    copies of each ground truth (its class nine times in ten, scores 0.3 to
    1), the rest random boxes of random classes (scores 0 to 0.6). Boxes in
    xywh. Returns per-image counts and the concatenated arrays."""
    w_img, h_img = COCO_SIZE
    n_gt = rng.poisson(COCO_GT_PER_IMAGE, n)
    total = int(n_gt.sum())
    size = np.exp(rng.uniform(np.log(6), np.log(400), (total, 2)))
    size[:, 1] *= rng.uniform(0.5, 1.5, total)
    xy = rng.uniform(0, 1, (total, 2)) * np.maximum(np.array([w_img, h_img]) - size, 1)
    gt_boxes = np.concatenate([xy, size], 1).astype(np.float32)
    gt_labels = zipf_draw(rng, COCO_VAL_CLASSES, total).astype(np.int32)
    det_boxes = np.empty((n * COCO_DETS, 4), np.float32)
    det_scores = rng.uniform(0, 0.6, n * COCO_DETS).astype(np.float32)
    det_labels = rng.randint(0, COCO_VAL_CLASSES, n * COCO_DETS).astype(np.int32)
    rand_wh = np.exp(rng.uniform(np.log(6), np.log(300), (n * COCO_DETS, 2)))
    det_boxes[:] = np.concatenate([rng.uniform(0, 1, (n * COCO_DETS, 2)) * [w_img, h_img], rand_wh], 1)
    start = 0
    for i, g in enumerate(n_gt.tolist()):
        src = np.repeat(np.arange(start, start + g), rng.randint(1, 3, g))[:COCO_DETS]
        d = slice(i * COCO_DETS, i * COCO_DETS + len(src))
        box = gt_boxes[src].astype(np.float64)
        box[:, :2] += rng.normal(0, 0.05, (len(src), 2)) * box[:, 2:]
        box[:, 2:] *= np.exp(rng.normal(0, 0.05, (len(src), 2)))
        det_boxes[d] = box
        det_scores[d] = rng.uniform(0.3, 1.0, len(src))
        det_labels[d] = np.where(rng.rand(len(src)) < 0.9, gt_labels[src], det_labels[d])
        start += g
    return n_gt, gt_boxes, gt_labels, det_boxes, det_scores, det_labels


def coco_images(torch, dev, data, first, count, perfect=False):
    """Images ``first`` to ``first + count`` of :func:`coco_val` as the
    metric's list-of-dicts input, views of one device copy of each array;
    ``perfect``: each image's detections are its ground truths, scored in
    decreasing order."""
    n_gt, gt_boxes, gt_labels, det_boxes, det_scores, det_labels = data
    offsets = np.concatenate([[0], np.cumsum(n_gt)])
    g0, g1 = int(offsets[first]), int(offsets[first + count])
    counts = n_gt[first:first + count].tolist()

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t

    gb, gl = put(gt_boxes[g0:g1]).split(counts), put(gt_labels[g0:g1]).split(counts)
    if perfect:
        scores = np.concatenate([np.linspace(1.0, 0.5, c, dtype=np.float32) for c in counts] or [np.zeros(0, np.float32)])
        preds = [{"boxes": b, "scores": s, "labels": lab}
                 for b, s, lab in zip(gb, put(scores).split(counts), gl)]
    else:
        d = slice(first * COCO_DETS, (first + count) * COCO_DETS)
        db, ds, dl = (put(a[d]).split(COCO_DETS) for a in (det_boxes, det_scores, det_labels))
        preds = [{"boxes": b, "scores": s, "labels": lab} for b, s, lab in zip(db, ds, dl)]
    return preds, [{"boxes": b, "labels": lab} for b, lab in zip(gb, gl)]


def run_slice19(torch, dev, laps):
    """Slice 19 (see the module's docstring): returns the kernels' launches on
    its path (all 0: the text and detection metrics run on the host, and
    BERTScore's matcher is a product and reductions, no kernel of the
    registry)."""
    import metrics_tpu_torch as M
    from metrics_tpu_torch import native
    from metrics_tpu_torch.detection import MeanAveragePrecision
    from metrics_tpu_torch.ops import launches, reset_launches

    t_slice = time.perf_counter()
    cpu = torch.device("cpu")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    native.load()
    reset_launches()
    rng = np.random.RandomState(SEED + 19)
    report = {"card": card}
    vocab = synthetic_vocab(rng, TEXT_VOCAB, _LOWER_SYLLABLES)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # ------------------------------------------------------------ A. CNN/DailyMail
    preds, targets, planted = cnndm_corpus(rng, vocab, CNNDM_ARTICLES)
    batches = [(preds[i:i + SUMM_BATCH], targets[i:i + SUMM_BATCH]) for i in range(0, len(preds), SUMM_BATCH)]
    head = batches[:SUMM_CPU_BATCHES]
    rouge = M.ROUGEScore(device=dev)
    update_ms = []
    for b in batches:
        _, s = timed(lambda b=b: rouge.update(*b))
        update_ms.append(s * 1e3)
    values, compute_s = timed(rouge.compute)
    for key, v in values.items():
        check(v.device == dev and v.dtype == torch.float32 and bool(torch.isfinite(v)), f"CNN/DM ROUGE {key}: {v}")
    states = {k: torch.cat(getattr(rouge, k)).cpu().numpy() for k in ("rouge1_fmeasure", "rouge1_precision",
                                                                     "rouge1_recall", "rougeL_fmeasure",
                                                                     "rougeL_precision", "rougeL_recall")}
    check(all(len(v) == CNNDM_ARTICLES for v in states.values()), "CNN/DM: a ROUGE state lacks samples")
    n_planted = 0
    for i, plant in planted.items():
        if plant is None:
            want = {"fmeasure": 1.0, "precision": 1.0, "recall": 1.0}
        else:
            n_words, k = plant
            p = r = (n_words - k) / n_words
            want = {"fmeasure": 2 * p * r / (p + r), "precision": p, "recall": r}
            n_planted += 1
        for key in ("rouge1", "rougeL"):
            for tp, x in want.items():
                check(states[f"{key}_{tp}"][i] == np.float32(x),
                      f"CNN/DM pair {i}: {key}_{tp} {states[f'{key}_{tp}'][i]!r}, planted {np.float32(x)!r}")
    card_head, host_head = M.ROUGEScore(device=dev), M.ROUGEScore(device=cpu)
    for b in head:
        card_head.update(*b)
        host_head.update(*b)
    check(text_states_equal(torch, card_head, host_head), "CNN/DM: ROUGE's states on the card differ from the CPU's")
    got, want = card_head.compute(), host_head.compute()
    for key in want:
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=TEXT_CARD_CPU_RTOL, atol=0,
                                   msg=f"CNN/DM ROUGE {key} over {len(head)} batches differs from the CPU run")
    mid = batches[len(batches) // 2]
    rouge_entry = {
        "articles": CNNDM_ARTICLES, "batches": len(batches), "planted_pairs": n_planted,
        "identical_pairs": sum(v is None for v in planted.values()),
        "values": {k: float(v) for k, v in values.items()},
        "update_ms_median": statistics.median(update_ms), "epoch_update_s": sum(update_ms) / 1e3,
        "compute_ms": compute_s * 1e3,
        "update_syncs": one_call_syncs(torch, lambda: card_head.update(*mid))[0],
        "compute_syncs": one_call_syncs(torch, card_head._compute_impl)[0],
    }
    check(rouge_entry["update_syncs"] == 0 and rouge_entry["compute_syncs"] == 0,
          f"CNN/DM: ROUGE synchronised with the host: {rouge_entry['update_syncs']} an update, "
          f"{rouge_entry['compute_syncs']} a compute")
    print("slice 19 A, CNN/DailyMail ROUGE: " + json.dumps(rouge_entry))
    laps.mark("3. slice 19 A: CNN/DailyMail ROUGE")

    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    table = torch.randn(ROBERTA_VOCAB, ROBERTA_WIDTH, generator=g, device=dev)
    embedders = {"hash": {}, "hash_idf": {"idf": True}, "roberta_width": {"embedder": WideEmbedder(torch, table)}}
    host_embedders = {"hash": {}, "hash_idf": {"idf": True},
                      "roberta_width": {"embedder": WideEmbedder(torch, table.cpu())}}
    identical = [i for i, v in planted.items() if v is None]
    bert_entry = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the hash embedder's one warning
        for name, kwargs in embedders.items():
            m = M.BERTScore(device=dev, **kwargs)
            for b in batches:
                m.update(*b)
            out, s = timed(m.compute)
            for key, v in out.items():
                check(v.device == dev and v.shape == (CNNDM_ARTICLES,) and bool(torch.isfinite(v).all()),
                      f"CNN/DM BERTScore ({name}) {key}")
            f1 = out["f1"].cpu().numpy()
            check(np.abs(f1[identical] - 1.0).max() <= 1e-6,
                  f"CNN/DM BERTScore ({name}): identical pairs' F1 is {np.abs(f1[identical] - 1.0).max()} from 1")
            card_m, host_m = M.BERTScore(device=dev, **kwargs), M.BERTScore(device=cpu, **host_embedders[name])
            for b in head:
                card_m.update(*b)
                host_m.update(*b)
            got, want = card_m.compute(), host_m.compute()
            gaps = {}
            for key in want:
                torch.testing.assert_close(got[key].cpu(), want[key], rtol=BERT_CARD_CPU_RTOL, atol=BERT_CARD_CPU_ATOL,
                                           msg=f"CNN/DM BERTScore ({name}) {key} differs from the CPU run")
                gaps[key] = float(((got[key].cpu() - want[key]).abs() / want[key].abs().clamp(min=1e-30)).max())
            bert_entry[name] = {"compute_s": s, "f1_mean": float(f1.mean()), "card_cpu_max_rel_gap": gaps,
                                "compute_syncs": one_call_syncs(torch, card_m._compute_impl)[0]}
            del m, out
    want_syncs = {"hash": 0, "hash_idf": 4, "roberta_width": 0}  # idf: ids and masks of both sides, read once each
    check({k: v["compute_syncs"] for k, v in bert_entry.items()} == want_syncs,
          f"CNN/DM BERTScore's compute syncs {bert_entry}, not {want_syncs}")
    del table, embedders, host_embedders
    torch.cuda.empty_cache()
    print("slice 19 A, CNN/DailyMail BERTScore: " + json.dumps(bert_entry))
    report["A_cnndm"] = {"rouge": rouge_entry, "bertscore": bert_entry}
    laps.mark("3. slice 19 A: CNN/DailyMail BERTScore")

    # ------------------------------------------------------------ B. SQuAD v1.1
    s_preds, s_targets, oracle = squad_corpus(rng, vocab, SQUAD_QUESTIONS)
    s_batches = []
    for i in range(0, SQUAD_QUESTIONS, SQUAD_BATCH):
        ids = {t["id"] for t in s_targets[i:i + SQUAD_BATCH]}
        s_batches.append(([p for p in s_preds if p["id"] in ids], s_targets[i:i + SQUAD_BATCH]))
    squad = M.SQuAD(device=dev)
    update_ms = []
    for b in s_batches:
        _, s = timed(lambda b=b: squad.update(*b))
        update_ms.append(s * 1e3)
    out, compute_s = timed(squad.compute)
    # the oracle's states: each batch's Python sums, added in float32 in batch order
    f1_state, em_state = np.float32(0), np.float32(0)
    for i in range(0, SQUAD_QUESTIONS, SQUAD_BATCH):
        em_state = np.float32(em_state + np.float32(sum(e for e, _ in oracle[i:i + SQUAD_BATCH])))
        f1_state = np.float32(f1_state + np.float32(sum(f for _, f in oracle[i:i + SQUAD_BATCH])))
    check(squad.f1_score.cpu().numpy() == f1_state and squad.exact_match.cpu().numpy() == em_state
          and int(squad.total) == SQUAD_QUESTIONS,
          f"SQuAD states {float(squad.f1_score)!r}, {float(squad.exact_match)!r}, {int(squad.total)} against the "
          f"planted {f1_state!r}, {em_state!r}, {SQUAD_QUESTIONS}")
    total32 = torch.tensor(SQUAD_QUESTIONS, dtype=torch.int32)
    for key, state in (("exact_match", em_state), ("f1", f1_state)):
        want = 100.0 * torch.from_numpy(np.asarray(state)) / total32
        check(out[key].device == dev and torch.equal(out[key].cpu(), want), f"SQuAD {key} {out[key]} is not {want}")
    card_head, host_head = M.SQuAD(device=dev), M.SQuAD(device=cpu)
    for b in s_batches[:SQUAD_CPU_BATCHES]:
        card_head.update(*b)
        host_head.update(*b)
    check(text_states_equal(torch, card_head, host_head), "SQuAD's states on the card differ from the CPU's")
    squad_entry = {
        "questions": SQUAD_QUESTIONS, "batches": len(s_batches), "values": {k: float(v) for k, v in out.items()},
        "update_ms_median": statistics.median(update_ms), "compute_ms": compute_s * 1e3,
        "update_syncs": one_call_syncs(torch, lambda: card_head.update(*s_batches[1]))[0],
        "compute_syncs": one_call_syncs(torch, card_head._compute_impl)[0],
    }
    check(squad_entry["update_syncs"] == 0 and squad_entry["compute_syncs"] == 0,
          f"SQuAD synchronised with the host: {squad_entry}")
    report["B_squad"] = squad_entry
    print("slice 19 B, SQuAD v1.1 dev: " + json.dumps(squad_entry))
    laps.mark("3. slice 19 B: SQuAD v1.1 dev")

    # ------------------------------------------------------------ C. COCO val2017
    data = coco_val(rng, COCO_VAL_IMAGES)
    kwargs = {"box_format": "xywh", "class_metrics": True}
    cm = MeanAveragePrecision(device=dev, **kwargs)
    update_ms = []
    for first in range(0, COCO_MAP_IMAGES, COCO_BATCH):
        p_, t_ = coco_images(torch, dev, data, first, COCO_BATCH)
        _, s = timed(lambda p_=p_, t_=t_: cm.update(p_, t_))
        update_ms.append(s * 1e3)
    p_, t_ = coco_images(torch, dev, data, 0, COCO_BATCH)
    fresh = MeanAveragePrecision(device=dev, **kwargs)
    update_syncs = one_call_syncs(torch, lambda: fresh.update(p_, t_))[0]
    result, compute_s = timed(cm.compute)
    check(all(v.device == dev for v in result.values()) and result["classes"].dtype == torch.int32
          and all(v.dtype == torch.float32 for k, v in result.items() if k != "classes"),
          "COCO: the result's devices or dtypes")
    check(result["classes"].numel() == COCO_VAL_CLASSES and all(bool(torch.isfinite(v).all()) for v in result.values()),
          f"COCO: classes {result['classes'].numel()} or a value not finite")
    check(0.0 < float(result["map"]) < 1.0 and float(result["map_50"]) >= float(result["map_75"]),
          f"COCO: map {float(result['map'])}, map_50 {float(result['map_50'])}, map_75 {float(result['map_75'])}")
    head_card, head_host = MeanAveragePrecision(device=dev, **kwargs), MeanAveragePrecision(device=cpu, **kwargs)
    head_card.update(*coco_images(torch, dev, data, 0, COCO_CPU_IMAGES))
    head_host.update(*coco_images(torch, cpu, data, 0, COCO_CPU_IMAGES))
    compute_syncs = one_call_syncs(torch, head_card._compute_impl)[0]
    got, want = head_card.compute(), head_host.compute()
    check(list(got) == list(want) and all(torch.equal(got[k].cpu(), want[k]) for k in want),
          f"COCO: the first {COCO_CPU_IMAGES} images on the card differ from the CPU run")
    perfect = MeanAveragePrecision(device=dev, **kwargs)
    perfect.update(*coco_images(torch, dev, data, 0, COCO_PERFECT_IMAGES, perfect=True))
    best = perfect.compute()
    check(float(best["map"]) == 1.0 and float(best["mar_100"]) == 1.0,
          f"COCO: a perfect detector's map {float(best['map'])!r}, mar_100 {float(best['mar_100'])!r}, not 1.0")
    check(compute_syncs == 1 and update_syncs == 0,
          f"COCO: {update_syncs} host syncs an update and {compute_syncs} a compute, not 0 and 1")
    coco_entry = {
        "images": COCO_MAP_IMAGES, "of": COCO_VAL_IMAGES, "gt_boxes": int(data[0][:COCO_MAP_IMAGES].sum()),
        "detections": COCO_MAP_IMAGES * COCO_DETS, "batches": len(update_ms),
        "values": {k: float(v) for k, v in result.items() if v.numel() == 1},
        "update_ms_median": statistics.median(update_ms), "compute_s": compute_s,
        "compute_ms_per_image": compute_s * 1e3 / COCO_MAP_IMAGES,
        "update_syncs": update_syncs, "compute_syncs": compute_syncs,
    }
    report["C_coco"] = coco_entry
    print("slice 19 C, COCO val2017: " + json.dumps(coco_entry))
    laps.mark("3. slice 19 C: COCO val2017")

    slice19_launches = launches()
    check(all(n == 0 for n in slice19_launches.values()), f"slice 19 launched a kernel: {slice19_launches}")
    report["launches"] = slice19_launches
    report["command_s"] = time.perf_counter() - t_slice
    print(f"slice 19 ({card}): " + json.dumps({k: report[k] for k in ("card", "launches", "command_s")}))
    return slice19_launches


def trunk_macs(torch, net, hw, dev):
    """Multiply-adds of one ``hw`` x ``hw`` image through the InceptionV3,
    counted from the layer shapes: each convolution's output elements times
    its kernel's fan-in, and the head."""
    from metrics_tpu_torch.image.inception_net import BasicConv2d

    macs = [net.fc.weight.numel()]

    def count(module, _inputs, out):
        macs[0] += out[0].numel() * module.conv.weight[0].numel()

    hooks = [m.register_forward_hook(count) for m in net.modules() if isinstance(m, BasicConv2d)]
    try:
        net(torch.zeros(1, 3, hw, hw, device=dev))
    finally:
        for h in hooks:
            h.remove()
    return macs[0]


def fid_images(torch, seed, step, n, dev, generated=False):
    """Batch ``step`` of a FID set as uint8 ``(n, 3, 299, 299)``: natural
    images from a generator seeded by the set and the step; the generated set
    smoothed (a 3 x 3 mean, as a generator loses detail) and noisy."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(seed * 100_003 + step)
    x = natural_images(torch, g, n, FID_SHAPE, dev)
    if generated:
        x = F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)
        x = (x + FID_GEN_NOISE * torch.randn(x.shape, generator=g, device=dev)).clamp(0, 1)
    return (x * 255).round().to(torch.uint8)


def fid64(torch, real, fake):
    """FID of two feature sets in float64 on the card: the means and unbiased
    covariances, and tr sqrt(S1^1/2 S2 S1^1/2) from two eigendecompositions.
    Returns the value, tr S1 + tr S2 and the square root's trace."""
    r, f = real.double(), fake.double()
    s1, s2 = torch.cov(r.T), torch.cov(f.T)
    vals, vecs = torch.linalg.eigh(s1)
    half = (vecs * vals.clamp_min(0).sqrt()) @ vecs.T
    m = half @ s2 @ half
    c = torch.linalg.eigvalsh((m + m.T) / 2).clamp_min(0).sqrt().sum()
    traces = torch.trace(s1) + torch.trace(s2)
    return float(((r.mean(0) - f.mean(0)) ** 2).sum() + traces - 2 * c), float(traces), float(c)


def kid64(torch, real, fake, seed, subsets, size, degree=3, coef=1.0):
    """KID in float64 on the card over the subsets ``np.random`` draws after
    ``seed`` (one permutation a side a subset, real and fake interleaved):
    the unbiased polynomial MMD's mean and biased std, and the mean of the
    first subset's real kernel (the scale of the sums)."""
    np.random.seed(seed)
    gamma = 1.0 / real.shape[1]
    scores, scale = [], None
    for _ in range(subsets):
        ir, if_ = np.random.permutation(real.shape[0])[:size], np.random.permutation(fake.shape[0])[:size]
        x = real[torch.from_numpy(ir).to(real.device)].double()
        y = fake[torch.from_numpy(if_).to(fake.device)].double()
        kxx, kyy, kxy = ((a @ b.T * gamma + coef) ** degree for a, b in ((x, x), (y, y), (x, y)))
        m = size
        off = lambda k: (k.sum() - torch.diagonal(k).sum()) / (m * (m - 1))  # noqa: E731
        scores.append(off(kxx) + off(kyy) - 2 * kxy.sum() / m**2)
        scale = float(kxx.mean()) if scale is None else scale
    s = torch.stack(scores)
    return float(s.mean()), float(s.std(unbiased=False)), scale


def is64(torch, logits, seed, splits):
    """The list path's IS in float64 on the card after the same shuffle
    (``np.random.permutation`` after ``seed``) and torch.chunk's sizes."""
    np.random.seed(seed)
    x = logits[torch.from_numpy(np.random.permutation(logits.shape[0])).to(logits.device)].double()
    p, logp = torch.softmax(x, 1), torch.log_softmax(x, 1)
    scores = []
    for cp, clp in zip(torch.chunk(p, splits), torch.chunk(logp, splits)):
        scores.append(torch.exp((cp * (clp - torch.log(cp.mean(0, keepdim=True)))).sum(1).mean()))
    s = torch.stack(scores)
    return float(s.mean()), float(s.std())


def exact_features(torch, n, d, mu, sd, dev):
    """``n`` features of width ``d`` whose sample mean is ``mu`` and sample
    covariance ``diag(sd**2) * n / (n - 1)`` exactly: ``mu + sd * H``, the
    columns of ``H`` the non-constant columns of a Sylvester Hadamard matrix
    (+-1, orthogonal, mean 0)."""
    h = torch.ones(1, 1, device=dev)
    while h.shape[0] < n:
        h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)], 0)
    return mu + sd * h[:n, 1:d + 1]


def run_slice20(torch, dev, laps):
    """Slice 20 (see the module's docstring): returns the kernels' launches on
    its path (all 0: the nets are cuDNN's convolutions and the metrics'
    arithmetic is products, eigensolvers and reductions)."""
    import torch.nn.functional as F

    import metrics_tpu_torch as M
    from metrics_tpu_torch.functional.image.helper import _full_float32
    from metrics_tpu_torch.image import InceptionV3FeatureExtractor
    from metrics_tpu_torch.image.lpips_net import LPIPSNet
    from metrics_tpu_torch.ops import launches, reset_launches

    t_slice = time.perf_counter()
    cpu = torch.device("cpu")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    report = {"card": card}
    reset_launches()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def quiet(fn):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the seeded nets' "randomly initialized" warning
            return fn()

    # ------------------------------------------------------------ A. InceptionV3 over FID-10k
    ext = quiet(lambda: InceptionV3FeatureExtractor()).to(dev)
    macs = trunk_macs(torch, ext.net, FID_SHAPE[1], dev)
    steps = FID_IMAGES // FID_BATCH
    feats = {"real": [], "fake": []}
    extract_s, peak = 0.0, 0.0
    for side, generated in (("real", False), ("fake", True)):
        for step in range(steps):
            x = fid_images(torch, SEED + 20, step + (steps if generated else 0), FID_BATCH, dev, generated)
            if step == 0 and not generated:
                peak = peak_mib(torch, lambda x=x: ext(x))
            f, s = timed(lambda x=x: ext(x))
            feats[side].append(f)
            extract_s += s
    real, fake = torch.cat(feats["real"]), torch.cat(feats["fake"])
    check(real.shape == fake.shape == (FID_IMAGES, 2048) and real.dtype == torch.float32
          and bool(torch.isfinite(real).all() and torch.isfinite(fake).all()),
          f"FID-10k features: {tuple(real.shape)} {real.dtype}, finite {bool(torch.isfinite(real).all())}")
    batch_ms = extract_s * 1e3 / (2 * steps)
    batch_bound_ms, bound_by = bound(FID_BATCH * (math.prod(FID_SHAPE) + 2048 * 4)
                                     + sum(p.numel() * 4 for p in ext.net.parameters()), 2 * macs * FID_BATCH)
    laps.mark("3. slice 20 A: InceptionV3 over FID-10k")

    x0 = fid_images(torch, SEED + 20, 0, FID_CPU_IMAGES, dev)
    cpu_ext = quiet(lambda: InceptionV3FeatureExtractor())
    want = cpu_ext(x0.cpu())
    got = ext(x0).cpu()
    prefix_err = float((got - want).abs().max())
    check(prefix_err <= NET_CARD_CPU_RTOL20 * float(want.abs().max()),
          f"InceptionV3: the first {FID_CPU_IMAGES} images' features on the card differ from the CPU's by {prefix_err}")

    ext16 = quiet(lambda: InceptionV3FeatureExtractor(dtype=torch.bfloat16)).to(dev)
    fake16, bf16_s = [], 0.0
    for step in range(steps):
        x = fid_images(torch, SEED + 20, step + steps, FID_BATCH, dev, generated=True)
        f, s = timed(lambda x=x: ext16(x))
        fake16.append(f)
        bf16_s += s
    fake16 = torch.cat(fake16)
    bf16_err = float((fake16 - fake).abs().max())
    check(fake16.dtype == torch.float32 and bf16_err <= BF16_BOUND20 * float(fake.abs().max()),
          f"InceptionV3 bf16: largest feature difference {bf16_err} past {BF16_BOUND20} of the features' scale")
    fid_ref, traces, _ = fid64(torch, real, fake)
    fid_bf16 = fid64(torch, real, fake16)[0]
    report["A_inception"] = {
        "images": 2 * FID_IMAGES, "batch": FID_BATCH, "images_per_s": 2 * FID_IMAGES / extract_s,
        "ms_per_batch": batch_ms, "bound_ms_per_batch": batch_bound_ms, "bound_by": bound_by,
        "gmacs_per_image": macs / 1e9, "peak_mib_per_batch": peak, "cpu_prefix_max_abs_err": prefix_err,
        "bf16": {"images": FID_IMAGES, "ms_per_batch": bf16_s * 1e3 / steps, "images_per_s": FID_IMAGES / bf16_s,
                 "max_abs_feature_diff": bf16_err, "feature_scale": float(fake.abs().max()),
                 "fid_float64": fid_bf16, "fid_drift": fid_bf16 - fid_ref},
    }
    print("slice 20 A, InceptionV3 over FID-10k: " + json.dumps(report["A_inception"]))
    laps.mark("3. slice 20 A: bf16 pass and the CPU prefix")

    # ------------------------------------------------------------ B. FID, KID and IS
    fid_tol = FID_TOL20 * traces
    fid_values = {}
    for path, kwargs in (("list", {}), ("moments", {"feature_dim": 2048})):
        for method in (None, "eigh_host", "newton_schulz"):
            m = M.FrechetInceptionDistance(sqrtm_method=method, **kwargs, device=dev)
            for a, b in zip(feats["real"], feats["fake"]):
                m.update(a, real=True)
                m.update(b, real=False)
            value, s = timed(m.compute)
            value = float(value)
            check(math.isfinite(value) and abs(value - fid_ref) <= fid_tol,
                  f"FID ({path}, {method}) {value} against float64 {fid_ref}: past {fid_tol}")
            fid_values[f"{path}/{method}"] = {"value": value, "compute_s": s}
    # the JAX package's precision (x64 off): float32 covariances and a float32 square root, on the same features
    from metrics_tpu_torch.image.fid import _trace_sqrtm_eigh

    s1_32, s2_32 = torch.cov(real.T), torch.cov(fake.T)
    mean_term = float(((real.double().mean(0) - fake.double().mean(0)) ** 2).sum())
    try:  # a reading, not a check: float32 eigensolvers may not converge on a rank-deficient covariance
        fid_f32_sqrt = mean_term + float(torch.trace(s1_32) + torch.trace(s2_32)) - 2 * float(
            _trace_sqrtm_eigh(s1_32, s2_32))
    except torch.linalg.LinAlgError as err:
        fid_f32_sqrt = f"eigh failed: {str(err)[:80]}"
    eigs = torch.linalg.eigvalsh(torch.cov(real.double().T))
    spectrum = {"real_eigs": eigs.numel(), "below_1e-6_of_largest": int((eigs < 1e-6 * eigs.max()).sum())}
    del s1_32, s2_32, eigs
    same = M.FrechetInceptionDistance(device=dev)
    same.update(real, real=True)
    same.update(real, real=False)
    self_fid = float(same.compute())
    check(abs(self_fid) <= FID_TOL20 * 2 * float(torch.cov(real.double().T).trace()),
          f"FID of a set against itself is {self_fid}")
    n_ex = 4096
    mu1, mu2 = 0.5, -0.25
    sd1 = torch.linspace(0.5, 2.0, 2048, device=dev)
    sd2 = torch.linspace(1.5, 0.25, 2048, device=dev)
    planted = M.FrechetInceptionDistance(feature_dim=2048, device=dev)
    planted.update(exact_features(torch, n_ex, 2048, mu1, sd1, dev), real=True)
    planted.update(exact_features(torch, n_ex, 2048, mu2, sd2, dev), real=False)
    closed = 2048 * (mu1 - mu2) ** 2 + n_ex / (n_ex - 1) * float(((sd1.double() - sd2.double()) ** 2).sum())
    closed_traces = n_ex / (n_ex - 1) * float((sd1.double() ** 2 + sd2.double() ** 2).sum())
    planted_fid = float(planted.compute())
    check(abs(planted_fid - closed) <= FID_TOL20 * closed_traces,
          f"FID of the planted diagonal Gaussians {planted_fid}, closed form {closed}")
    laps.mark("3. slice 20 B: FID")

    kid = M.KernelInceptionDistance(subsets=KID_SUBSETS, subset_size=KID_SUBSET_SIZE, device=dev)
    kid_buf = M.KernelInceptionDistance(subsets=KID_SUBSETS, subset_size=KID_SUBSET_SIZE, feature_dim=2048,
                                        max_samples=FID_IMAGES, device=dev)
    for a, b in zip(feats["real"], feats["fake"]):
        for m in (kid, kid_buf):
            m.update(a, real=True)
            m.update(b, real=False)
    np.random.seed(SEED + 201)
    (kid_mean, kid_std), kid_s = timed(kid.compute)
    np.random.seed(SEED + 201)
    kid_buf_vals = kid_buf.compute()
    check(torch.equal(kid_buf_vals[0], kid_mean) and torch.equal(kid_buf_vals[1], kid_std),
          "KID's buffer path is not its list path's bits")
    k_mean64, k_std64, k_scale = kid64(torch, real, fake, SEED + 201, KID_SUBSETS, KID_SUBSET_SIZE)
    check(abs(float(kid_mean) - k_mean64) <= KID_ATOL20 * k_scale and abs(float(kid_std) - k_std64) <= KID_ATOL20 * k_scale,
          f"KID ({float(kid_mean)}, {float(kid_std)}) against float64 ({k_mean64}, {k_std64}), kernel scale {k_scale}")
    kid_graph = M.KernelInceptionDistance(subsets=KID_SUBSETS, subset_size=KID_SUBSET_SIZE, feature_dim=2048,
                                          max_samples=FID_IMAGES, compute_rng_key=SEED + 202, device=dev)
    for a, b in zip(feats["real"], feats["fake"]):
        kid_graph.update(a, real=True)
        kid_graph.update(b, real=False)
    graph_vals, graph_s = timed(kid_graph.compute)
    check(all(bool(torch.isfinite(v)) for v in graph_vals), f"KID with compute_rng_key: {graph_vals}")

    head = ext.net.fc.weight
    with _full_float32():
        logits = [F.linear(f, head) for f in feats["fake"]]  # the head without its bias: 'logits_unbiased'
    all_logits = torch.cat(logits)
    is_list = M.InceptionScore(splits=IS_SPLITS, device=dev)
    is_stream = M.InceptionScore(splits=IS_SPLITS, num_classes=1008, device=dev)
    for lg in logits:
        is_list.update(lg)
        is_stream.update(lg)
    np.random.seed(SEED + 203)
    is_mean, is_std = is_list.compute()
    is_ref = is64(torch, all_logits, SEED + 203, IS_SPLITS)
    check(abs(float(is_mean) - is_ref[0]) <= IS_RTOL20 * is_ref[0] and abs(float(is_std) - is_ref[1]) <= IS_RTOL20 * is_ref[0],
          f"IS list path ({float(is_mean)}, {float(is_std)}) against float64 {is_ref}")
    stream_vals = is_stream.compute()
    check(all(bool(torch.isfinite(v)) for v in stream_vals) and int(is_stream.split_count.sum()) == FID_IMAGES,
          f"IS streaming: {stream_vals}, split counts {is_stream.split_count.tolist()}")
    # the streaming sums on the card against a CPU run of the same metric on the same logits, round-robin and keyed
    is_keyed = M.InceptionScore(splits=IS_SPLITS, num_classes=1008, assignment_rng_key=SEED + 208, device=dev)
    for lg in logits:
        is_keyed.update(lg)
    is_stream_err = {}
    for name, card_m, key in (("round_robin", is_stream, None), ("keyed", is_keyed, SEED + 208)):
        host_m = M.InceptionScore(splits=IS_SPLITS, num_classes=1008, assignment_rng_key=key, device=cpu)
        for lg in logits:
            host_m.update(lg.cpu())
        errs = {}
        for state in ("prob_sum", "plogp_sum"):
            want_s = getattr(host_m, state)
            errs[state] = float((getattr(card_m, state).cpu() - want_s).abs().max()) / float(want_s.abs().max())
        card_v, host_v = card_m.compute(), host_m.compute()
        errs["mean"], errs["std"] = (abs(float(c) - float(h)) / float(host_v[0]) for c, h in zip(card_v, host_v))
        check(torch.equal(card_m.split_count.cpu(), host_m.split_count)
              and all(errs[k] <= IS_STATE_ATOL20 for k in ("prob_sum", "plogp_sum"))
              and errs["mean"] <= IS_RTOL20 and errs["std"] <= IS_RTOL20,
              f"IS streaming ({name}) on the card against the CPU: {errs}, split counts"
              f" {card_m.split_count.tolist()} and {host_m.split_count.tolist()}")
        is_stream_err[name] = errs
    del is_keyed
    k_cls, per = 10, 1000
    onehot = 50.0 * F.one_hot((torch.arange(k_cls * per, device=dev) // IS_SPLITS) % k_cls, k_cls).float()
    planted_is = M.InceptionScore(splits=IS_SPLITS, num_classes=k_cls, device=dev)
    planted_is.update(onehot)
    planted_list = M.InceptionScore(splits=IS_SPLITS, device=dev)
    planted_list.update(onehot)
    np.random.seed(SEED + 204)
    pis_stream, pis_list = float(planted_is.compute()[0]), float(planted_list.compute()[0])
    check(abs(pis_stream - k_cls) <= 1e-4 * k_cls and abs(pis_list - k_cls) <= 1e-2 * k_cls,
          f"IS of logits spread evenly over {k_cls} classes: streaming {pis_stream}, list {pis_list}")
    laps.mark("3. slice 20 B: KID and IS")

    bundled_in = {side: [fid_images(torch, SEED + 20, s + (steps if side == "fake" else 0), FID_BATCH, dev,
                                    side == "fake") for s in range(NET_METRIC_IMAGES // FID_BATCH + 1)]
                  for side in ("real", "fake")}
    for side in bundled_in:
        bundled_in[side][-1] = bundled_in[side][-1][: NET_METRIC_IMAGES % FID_BATCH]
    ext_logits = quiet(lambda: InceptionV3FeatureExtractor(output="logits_unbiased")).to(dev)
    fed = {side: [ext(x) for x in xs] for side, xs in bundled_in.items()}
    fed_logits = [ext_logits(x) for x in bundled_in["fake"]]
    fid_b = quiet(lambda: M.FrechetInceptionDistance(feature=2048, device=dev))
    kid_b = quiet(lambda: M.KernelInceptionDistance(feature=2048, subsets=10, subset_size=BUNDLED_KID_SUBSET,
                                                    device=dev))
    is_b = quiet(lambda: M.InceptionScore(feature="logits_unbiased", splits=IS_SPLITS, device=dev))
    fid_f = M.FrechetInceptionDistance(device=dev)
    kid_f = M.KernelInceptionDistance(subsets=10, subset_size=BUNDLED_KID_SUBSET, device=dev)
    is_f = M.InceptionScore(splits=IS_SPLITS, device=dev)
    for side in ("real", "fake"):
        for x, f in zip(bundled_in[side], fed[side]):
            for mb, mf in ((fid_b, fid_f), (kid_b, kid_f)):
                mb.update(x, real=side == "real")
                mf.update(f, real=side == "real")
    for x, lg in zip(bundled_in["fake"], fed_logits):
        is_b.update(x)
        is_f.update(lg)
    bundled_equal = {"fid": torch.equal(fid_b.compute(), fid_f.compute())}
    for name, mb, mf in (("kid", kid_b, kid_f), ("is", is_b, is_f)):
        np.random.seed(SEED + 205)
        vb = mb.compute()
        np.random.seed(SEED + 205)
        vf = mf.compute()
        bundled_equal[name] = all(torch.equal(a, b) for a, b in zip(vb, vf))
    check(all(bundled_equal.values()), f"a metric through its bundled net differs from the fed features: {bundled_equal}")
    del fid_b, kid_b, is_b, ext_logits
    report["B_metrics"] = {
        "fid_float64": fid_ref, "traces": traces, "fid": fid_values, "fid_self": self_fid,
        "fid_float32_sqrt": fid_f32_sqrt, "spectrum": spectrum,
        "fid_planted": {"value": planted_fid, "closed_form": closed},
        "kid": {"mean": float(kid_mean), "std": float(kid_std), "float64": [k_mean64, k_std64],
                "kernel_scale": k_scale, "compute_s": kid_s, "in_graph": [float(v) for v in graph_vals],
                "in_graph_compute_s": graph_s},
        "is": {"list": [float(is_mean), float(is_std)], "float64": list(is_ref),
               "streaming": [float(v) for v in stream_vals], "streaming_card_cpu_rel_err": is_stream_err,
               "planted_10": [pis_stream, pis_list]},
        "bundled_equal": bundled_equal,
    }
    print("slice 20 B, FID, KID and IS: " + json.dumps(report["B_metrics"]))
    laps.mark("3. slice 20 B: each metric through its bundled net")

    # ------------------------------------------------------------ C. LPIPS
    g = torch.Generator(device=dev).manual_seed(SEED + 206)
    bapps = []
    for _ in range(BAPPS_PAIRS // BAPPS_BATCH):
        ref = natural_images(torch, g, BAPPS_BATCH, BAPPS_SHAPE, dev)
        bapps.append((ref * 2 - 1, noisy(torch, g, ref) * 2 - 1))
    g = torch.Generator(device=dev).manual_seed(SEED + 16)  # slice 16's Kodak pairs
    k_target = natural_images(torch, g, KODAK_IMAGES, KODAK_SHAPE, dev)
    k_preds = noisy(torch, g, k_target)
    lpips_entry = {}
    for net in ("alex", "vgg", "squeeze"):
        metric = quiet(lambda net=net: M.LearnedPerceptualImagePatchSimilarity(net_type=net, device=dev))
        update_ms = []
        for a, b in bapps:
            _, s = timed(lambda a=a, b=b: metric.update(a, b))
            update_ms.append(s * 1e3)
        value = metric.compute()
        check(bool(torch.isfinite(value)) and float(value) > 0 and float(metric.total) == BAPPS_PAIRS,
              f"LPIPS ({net}) over {BAPPS_PAIRS} pairs: {value}, total {float(metric.total)}")
        zero = metric.net(bapps[0][0][:16], bapps[0][0][:16])
        check(torch.equal(zero, torch.zeros_like(zero)), f"LPIPS ({net}) of identical pairs is not 0")
        host = quiet(lambda net=net: LPIPSNet(net_type=net))
        want = host(bapps[0][0][:16].cpu(), bapps[0][1][:16].cpu())
        got = metric.net(bapps[0][0][:16], bapps[0][1][:16]).cpu()
        check(bool((got > 0).all()), f"LPIPS ({net}) of noisy pairs is not above identical pairs' 0: {got.tolist()}")
        check(float((got - want).abs().max()) <= LPIPS_CARD_CPU_ATOL20,
              f"LPIPS ({net}) on the card differs from the CPU by {float((got - want).abs().max())}")
        entry = {"value": float(value), "update_ms_median": statistics.median(update_ms),
                 "pairs_per_s": BAPPS_BATCH / (statistics.median(update_ms) / 1e3)}
        if net != "squeeze":
            kodak = quiet(lambda net=net: M.LearnedPerceptualImagePatchSimilarity(net_type=net, device=dev))
            kodak_ms = []
            for i in range(0, KODAK_IMAGES, IMAGE_BATCH):
                _, s = timed(lambda i=i: kodak.update(k_preds[i:i + IMAGE_BATCH] * 2 - 1,
                                                      k_target[i:i + IMAGE_BATCH] * 2 - 1))
                kodak_ms.append(s * 1e3)
            kv = kodak.compute()
            check(bool(torch.isfinite(kv)) and float(kv) > 0, f"LPIPS ({net}) over Kodak: {kv}")
            entry["kodak"] = {"value": float(kv), "update_ms_median": statistics.median(kodak_ms),
                              "pairs_per_s": IMAGE_BATCH / (statistics.median(kodak_ms) / 1e3)}
        lpips_entry[net] = entry
    report["C_lpips"] = lpips_entry
    print("slice 20 C, LPIPS on BAPPS-shaped patches and Kodak: " + json.dumps(lpips_entry))
    laps.mark("3. slice 20 C: LPIPS")

    # ------------------------------------------------------------ D. the engines
    feat_batches = [((a,), {"real": True}) for a in feats["real"][:ENGINE_BATCHES20]] + \
        [((b,), {"real": False}) for b in feats["fake"][:ENGINE_BATCHES20]]
    cases = {
        "fid_moments": (M.FrechetInceptionDistance, {"feature_dim": 2048}, feat_batches),
        "kid_buffer": (M.KernelInceptionDistance, {"feature_dim": 2048, "max_samples": FID_IMAGES,
                                                   "subsets": 10, "subset_size": BUNDLED_KID_SUBSET}, feat_batches),
        "is_streaming": (M.InceptionScore, {"num_classes": 1008, "splits": IS_SPLITS, "assignment_rng_key": 20},
                         [((lg,), {}) for lg in logits[:ENGINE_BATCHES20]]),
        "lpips_alex": (M.LearnedPerceptualImagePatchSimilarity, {"net_type": "alex"},
                       [((a, b), {}) for a, b in bapps[:ENGINE_BATCHES20]]),
    }
    engines = {}
    for name, (cls, kwargs, batches) in cases.items():
        eager = quiet(lambda: cls(**kwargs, device=dev))
        engine = quiet(lambda: cls(**kwargs, jit_update=True, device=dev))
        for args, kw in batches:
            eager.update(*args, **kw)
            engine.update(*args, **kw)
        torch.cuda.synchronize()
        for key in eager._defaults:
            check(torch.equal(getattr(engine, key), getattr(eager, key)),
                  f"{name}: the captured update's {key} is not the eager update's bits")
        stats = engine.dispatch_stats
        graphs = sum(len(p.graphs) for p in engine._dispatcher._cache.values())
        check(stats["demotions"] == 0 and stats["dispatches"] == len(batches) and graphs >= 2,
              f"{name}: the engine's stats {stats}, {graphs} graphs")
        args, kw = batches[0]
        engines[name] = {
            "dispatches": stats["dispatches"], "retraces": stats["retraces"], "graphs": graphs,
            "eager_update_syncs": one_call_syncs(torch, lambda: eager.update(*args, **kw))[0],
            "engine_update_syncs": one_call_syncs(torch, lambda: engine.update(*args, **kw))[0],
        }
        if name != "kid_buffer":  # its compute draws the host's np.random stream: reads the counts
            engines[name]["compute_syncs"] = one_call_syncs(torch, eager._compute_impl)[0]
        else:
            np.random.seed(SEED + 207)
            engines[name]["compute_syncs"] = one_call_syncs(torch, eager._compute_impl)[0]
    check(all(e["engine_update_syncs"] == 0 for e in engines.values()),
          f"a captured update synced with the host: {engines}")
    report["D_engines"] = engines
    print("slice 20 D, the engines: " + json.dumps(engines))
    laps.mark("3. slice 20 D: the engines")

    slice20_launches = launches()
    check(all(n == 0 for n in slice20_launches.values()), f"slice 20 launched a kernel: {slice20_launches}")
    report["launches"] = slice20_launches
    report["command_s"] = time.perf_counter() - t_slice
    print(f"slice 20 ({card}): " + json.dumps({k: report[k] for k in ("card", "launches", "command_s")}))
    return slice20_launches


def same21(torch, a, b):
    """Replay against eager: integer and bool tensors bit for bit, floats within AUDIT_RTOL21."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(same21(torch, a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(same21(torch, x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        if not isinstance(b, torch.Tensor) or a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.is_floating_point() or a.is_complex():
            return torch.allclose(a, b, rtol=AUDIT_RTOL21, atol=AUDIT_ATOL21, equal_nan=True)
        return torch.equal(a, b)
    return a == b


# the two errors that confirm a finding on the card: the sync debug mode's, and a graph capture that a CUDA
# library call broke
SYNC_ERROR21, CAPTURE_INVALIDATED21 = "called a synchronizing CUDA operation", "cudaErrorStreamCaptureInvalidated"


def sync_free(torch, fn):
    """``fn()`` with every host sync an error: ``("clean", value)``, or the
    error's kind and first line. The kind is ``"synced"`` where the sync
    debug mode raised, ``"capture invalidated"`` where a CUDA library call
    broke a graph capture, and ``"error"`` for any other exception (a fault
    of the case or of this check, which confirms no finding)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        value = fn()
    except Exception as err:  # noqa: BLE001 -- classified: only the two errors above confirm a finding
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        chain, e = [], err
        while e is not None and all(e is not c for c in chain):  # the error and those it was raised from or in
            chain.append(e)
            e = e.__cause__ or e.__context__
        if any(isinstance(c, RuntimeError) and SYNC_ERROR21 in str(c) for c in chain):
            kind = "synced"
        elif any(CAPTURE_INVALIDATED21 in str(c) for c in chain):
            kind = "capture invalidated"
        else:
            kind = "error"
        return kind, f"{type(err).__name__}: {str(err).splitlines()[0] if str(err) else ''}"[:160]
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return "clean", value


COLD_START21 = """
import json, statistics, sys, time
t0 = time.perf_counter()
import torch
import metrics_tpu_torch as M
t_import = time.perf_counter()
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(21)
rows, classes = int(sys.argv[1]), int(sys.argv[2])
p = torch.rand(rows, classes, generator=g, device=dev)
t = torch.randint(0, classes, (rows,), generator=g, device=dev, dtype=torch.int32)
torch.cuda.synchronize()
t_data = time.perf_counter()
acc = M.Accuracy(num_classes=classes, average="macro", jit_update=True, device=dev)
acc.update(p, t)
torch.cuda.synchronize()
t_first = time.perf_counter()
captured = any(len(pr.graphs) == 2 for pr in acc._dispatcher._cache.values())
warm = []
for _ in range(int(sys.argv[3])):
    s = time.perf_counter()
    acc.update(p, t)
    torch.cuda.synchronize()
    warm.append((time.perf_counter() - s) * 1e3)
print(json.dumps({"import_s": t_import - t0, "cuda_and_data_s": t_data - t_import, "first_update_s": t_first - t_data,
                  "import_to_first_captured_update_s": t_first - t0, "captured": captured,
                  "warm_update_ms": statistics.median(warm), "retraces": acc.dispatch_stats["retraces"]}))
"""


def run_slice21(torch, dev, laps, sync_outs=None, build_s=None):
    """Slice 21 (see the module's docstring): the static audit held on the card,
    PyTorch checkpoints at full width, and the cold start. ``sync_outs`` are
    slice 9's ranks' results (the capstone's dynamic count); ``build_s`` the
    ``nvcc`` build's seconds of part 1."""
    import tempfile

    import metrics_tpu_torch as M
    from metrics_tpu_torch import forward_engine
    from metrics_tpu_torch.analysis import program_audit, report as audit_report
    from metrics_tpu_torch.analysis import registry as audit_registry
    from metrics_tpu_torch.image import inception_net, lpips_net
    from metrics_tpu_torch.ops import fused_window_tick, launches, registry, reset_launches
    from metrics_tpu_torch.utilities.checks import tracing

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    t_slice = time.perf_counter()
    report = {"card": card}

    # ------------------------------------------------ A. the program audit, held on the card
    baseline = audit_report.load_baseline()
    check(baseline is not None, "slice 21: STATIC_AUDIT_TORCH.json is missing")
    # what a finding predicts on the card: a call that no CUDA graph can hold breaks the capture; every other
    # JX301 or JX401 is a host sync, which the sync debug mode raises
    predicted = {(f["metric"], f["where"]): (f["code"], "capture invalidated" if "no CUDA graph can hold it" in f["detail"]
                                             else "synced")
                 for f in baseline["findings"] if f["code"] in ("JX301", "JX401")}
    pools = audit_registry.example_inputs(dev)
    cpu_pools = audit_registry.example_inputs("cpu")
    tally = {"cases": 0, "wide_cases": 0, "programs": 0, "clean": 0, "confirmed": [], "captured": 0, "mismatches": [],
             "case_s": {}}

    def hold(name, label, program, outcome, equal=True, detail=""):
        """One program's outcome on the card against the audit's prediction for ``name``."""
        tally["programs"] += 1
        code, expected = predicted.get((name, program), (None, "clean"))
        if outcome == expected and (code is not None or equal):
            if code is None:
                tally["clean"] += 1
            else:
                tally["confirmed"].append(f"{label} {program}: {code}, {outcome}")
        else:
            says = f"{code} ({expected})" if code else "clean"
            tally["mismatches"].append(f"{label} {program}: the audit says {says}, the card {outcome}"
                                       + ("" if equal else ", not the eager values") + (f" ({detail})" if detail else ""))

    # one pool for every graph, and the graphs kept until part A ends: a pool is released with its last graph
    side, pool, kept = torch.cuda.Stream(dev), torch.cuda.graph_pool_handle(), []

    def captured(fn):
        """``fn()`` once on a side stream (the eager value), then captured in a CUDA graph and replayed, as the
        engines run a program (value checks skipped): ``(eager, replayed)``. A program that syncs, or calls
        what no graph can hold, raises."""
        current = torch.cuda.current_stream(dev)
        side.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        # capture_begin on the side stream, not torch.cuda.graph: that empties the allocator's cache each time
        with torch.cuda.stream(side), tracing():
            eager = fn()
            graph.capture_begin(pool=pool)
            try:
                replayed = fn()
            finally:
                graph.capture_end()
        current.wait_stream(side)
        graph.replay()
        kept.append(graph)
        return eager, replayed

    def engine_run(metric, calls):
        """``calls(engine)`` through a fresh dispatcher of ``metric`` with every sync an error: the outcome
        (``sync_free``'s, or "not captured"), the value and the error's line."""
        engine = metric._make_dispatcher()
        outcome, value = sync_free(torch, lambda: calls(engine))
        if outcome == "clean" and not any(len(p.graphs) == 2 for p in engine._cache.values()):
            outcome = "not captured"
        return outcome, value

    def hold_programs(name, label, build, args):
        """Every program the audit traced of ``build()`` on ``args``, on the card: the update captured twice
        by the engine (a list state: captured as it is), the forward by the engine where the audit traced one,
        compute and merge captured; each replay against eager."""
        t_case = time.perf_counter()
        ref = build()
        with tracing():
            s1 = ref.pure_update(ref.default_state(), *args)
            s2 = ref.pure_update(s1, *args)
        names = list(ref._defaults)
        if not any(isinstance(v, list) for v in s1.values()):
            outcome, value = engine_run(build(), lambda e: (e.update({}, (), args, {}), e.update({}, (), args, {}),
                                                             e._read_leaves())[-1])
            equal = outcome != "clean" or same21(torch, tuple(value), tuple(s2[k] for k in names))
        else:  # a list state: no engine serves it
            outcome, value = sync_free(torch, lambda: captured(lambda: ref.pure_update(ref.default_state(), *args)))
            equal = outcome != "clean" or (same21(torch, value[1], value[0]) and same21(torch, value[1], s1))
        tally["captured"] += outcome == "clean"
        hold(name, label, "pure_update", outcome, equal, value if outcome != "clean" else "")
        for program, fn in (("pure_compute", lambda: ref.pure_compute(s2)), ("pure_merge", lambda: ref.pure_merge(s2, s2))):
            outcome, value = sync_free(torch, lambda fn=fn: captured(fn))
            tally["captured"] += outcome == "clean"
            equal = outcome != "clean" or same21(torch, value[1], value[0])
            hold(name, label, program, outcome, equal, value if outcome != "clean" else "")
        if "forward" in baseline["facts"][name]["programs"]:
            fnames, fwd = forward_engine.audit_forward_program(ref)
            with tracing():
                l1, _ = fwd(torch.tensor(1.0, device=dev), tuple(ref.default_state()[n] for n in fnames), *args)
                l2, v2 = fwd(torch.tensor(2.0, device=dev), l1, *args)
            outcome, value = engine_run(build(), lambda e: (e.forward(1.0, {}, (), args, {}),
                                                             e.forward(2.0, {}, (), args, {}), e._read_leaves()))
            tally["captured"] += outcome == "clean"
            equal = outcome != "clean" or (same21(torch, value[1], v2) and same21(torch, tuple(value[2]), tuple(l2)))
            hold(name, label, "pure_forward", outcome, equal, value if outcome != "clean" else "")
        tally["case_s"][label] = time.perf_counter() - t_case

    for case in audit_registry.audit_cases():
        if case.scope != "device":
            continue
        tally["cases"] += 1
        hold_programs(case.name, case.name, lambda case=case: case.build(dev), case.args(pools))
    torch.cuda.synchronize()
    laps.mark("3. slice 21 A: the audit's device cases on the card")
    # each kernel-routed family again at its main path's width, where the wrappers take the main path's branches
    g21 = torch.Generator(device=dev).manual_seed(SEED + 212)
    probs = torch.softmax(torch.randn(BATCH, NUM_CLASSES, generator=g21, device=dev), dim=1)
    labels = torch.randint(0, NUM_CLASSES, (BATCH,), generator=g21, device=dev)
    ids = torch.randint(0, CLICK_IDS, (CLICK_BATCH,), generator=g21, device=dev).float()
    marco = tuple(x[:MARCO_QUERY_BATCH].reshape(-1) for x in marco_data(torch, dev))
    wide = (
        ("Accuracy", lambda: M.Accuracy(num_classes=NUM_CLASSES, average="macro", device=dev), (probs, labels)),
        ("ConfusionMatrix", lambda: M.ConfusionMatrix(num_classes=NUM_CLASSES, update_method="matmul", device=dev),
         (probs, labels)),
        ("BinnedAveragePrecision",
         lambda: M.BinnedAveragePrecision(num_classes=NUM_CLASSES, thresholds=THRESHOLDS, device=dev), (probs, labels)),
        ("CountMinHeavyHitters", lambda: M.CountMinHeavyHitters(depth=CLICK_DEPTH, width=CLICK_WIDTH, device=dev),
         (ids,)),
        ("RetrievalMAP", lambda: M.RetrievalMAP(device=dev), marco),
    )
    reset_launches()
    for name, build, args in wide:
        tally["wide_cases"] += 1
        hold_programs(name, f"{name} {tuple(args[0].shape)}", build, args)
    torch.cuda.synchronize()
    wide_branches = {k: by_shape(registry.launches_by_shape(k)) for k in KERNELS}
    check(all(wide_branches[k] for k in ("stat_scores", "confusion_matrix", "binned_stats", "countmin")),
          f"slice 21: a main-path width launched no kernel: {wide_branches}")
    kept.clear()
    laps.mark("3. slice 21 A: the kernel-routed families at the main paths' widths")

    # the kernel cases: each program on the card (the kernels) against the CPU (the plain versions), bit for bit
    kernel_cases = {}
    reset_launches()
    for case in audit_registry.kernel_cases():
        check(case.scope == "kernel", f"slice 21: {case.name} has no kernel case")
        for program, fn in case.build().items():
            got, want = fn(pools), fn(cpu_pools)
            got, want = (list(x.values()) if isinstance(x, dict) else list(x) if isinstance(x, tuple) else [x]
                         for x in (got, want))
            equal = len(got) == len(want) and all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
            kernel_cases[f"{case.name} {program}"] = equal
            check(equal, f"slice 21: the kernel case {case.name} ({program}) differs from its plain version")
    # the window tick as its captured graph: two ticks equal two eager ones
    tick = M.SlidingWindow(M.Accuracy(num_classes=4, average="macro", device=dev), window=4, slide=2)
    eager_tick = M.SlidingWindow(M.Accuracy(num_classes=4, average="macro", device=dev), window=4, slide=2,
                                 jit_update=False)
    for _ in range(2):
        fused_window_tick(tick, (pools["probs"], pools["labels"]), {})
        eager_tick.update(pools["probs"], pools["labels"])
    graph_ticks = any(len(p.graphs) == 2 for p in tick._fused_tick._cache.values())
    check(graph_ticks and all(torch.equal(getattr(tick, k), getattr(eager_tick, k)) for k in tick._defaults),
          "slice 21: the fused window tick is not a captured graph with the eager ticks' state")
    kernel_launches = launches()
    sessions = {k: sorted({b for (b, _) in registry.launches_by_shape(k)}) for k in ("stat_scores", "countmin")}
    check(all(kernel_launches[k] > 0 for k in KERNELS), f"slice 21: a kernel case launched nothing: {kernel_launches}")
    check(all(any("session" in b for b in branches) for branches in sessions.values()),
          f"slice 21: a session axis did not launch: {sessions}")
    report["A_audit"] = {"device_cases": tally["cases"], "main_path_width_cases": tally["wide_cases"],
                         "programs": tally["programs"], "clean": tally["clean"],
                         "findings_confirmed": len(tally["confirmed"]), "confirmed": tally["confirmed"],
                         "captured": tally["captured"], "main_path_width_branches": wide_branches,
                         "mismatches": len(tally["mismatches"]), "mismatch_list": tally["mismatches"],
                         "kernel_cases": kernel_cases, "kernel_launches": kernel_launches, "branches": sessions,
                         "window_tick_graph": graph_ticks,
                         "slowest_cases_s": dict(sorted(tally["case_s"].items(), key=lambda kv: -kv[1])[:5])}
    print("slice 21 A, the static audit on the card: " + json.dumps(report["A_audit"]))
    check(not tally["mismatches"], f"slice 21: the card disagrees with the audit: {tally['mismatches']}")

    # the capstone: the static plan against the collectives slice 9's four ranks issued on the same suite
    plan = program_audit.classification_suite_sync_plan()
    if sync_outs is not None:
        issued = [{mode: sum(o["capstone"][mode].values()) for mode in ("fused", "per_leaf")} for o in sync_outs]
        report["A_capstone"] = {"plan": plan, "issued_by_rank": issued}
        check(all(i == {"fused": plan["fused_collectives"], "per_leaf": plan["perleaf_collectives"]} for i in issued),
              f"slice 21: the capstone's plan {plan} is not what slice 9's ranks issued: {issued}")
    else:
        report["A_capstone"] = {"plan": plan, "issued_by_rank": "not measured (slice 9 did not run)"}
    print("slice 21 A, the capstone: " + json.dumps(report["A_capstone"]))
    laps.mark("3. slice 21 A: kernel cases and the capstone")

    # ------------------------------------------------ B. PyTorch checkpoints at full width
    g_cpu = torch.Generator().manual_seed(SEED + 210)
    g_dev = torch.Generator(device=dev).manual_seed(SEED + 211)

    def perturbed(state, positive=()):
        """A seeded state: each float weight moved by 1% noise (the heads and variances kept positive)."""
        out = {}
        for k, v in state.items():
            if v.is_floating_point():
                v = v + 0.01 * torch.randn(v.shape, generator=g_cpu, dtype=v.dtype)
                v = v.abs() if any(k.startswith(p) or k.endswith(p) for p in positive) else v
            out[k] = v
        return out

    with tempfile.TemporaryDirectory(prefix="slice21-") as tmp:
        state = perturbed(inception_net.InceptionV3().state_dict(), positive=("running_var",))
        state["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)  # dropped by both paths
        pth, npz = os.path.join(tmp, "pt_inception.pth"), os.path.join(tmp, "inception.npz")
        torch.save(state, pth)
        inception_net.save_params(npz, inception_net.convert_torch_state_dict(inception_net.load_torch(pth)))
        ext_pth = inception_net.InceptionV3FeatureExtractor(weights_path=pth).to(dev)
        ext_npz = inception_net.InceptionV3FeatureExtractor(weights_path=npz).to(dev)
        loaded = ext_pth.net.state_dict()
        check(all(torch.equal(loaded[k].cpu(), v) for k, v in state.items() if k in loaded),
              "slice 21: the .pth did not load its weights")
        images = torch.rand(CKPT_IMAGES21, *FID_SHAPE, generator=g_dev, device=dev) * 2 - 1
        cudnn_deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            f_pth, f_npz = ext_pth(images), ext_npz(images)
        finally:
            torch.backends.cudnn.deterministic = cudnn_deterministic
        inception_equal = torch.equal(f_pth, f_npz)
        del ext_pth, ext_npz, images

        module = lpips_net._LPIPSModule("vgg")
        lstate = perturbed(module.state_dict(), positive=("lin",))
        backbone = {k[len("net."):]: v for k, v in lstate.items() if k.startswith("net.")}
        lins = {k: v for k, v in lstate.items() if k.startswith("lin")}
        b_pth, l_pth, l_npz = (os.path.join(tmp, f) for f in ("vgg_features.pth", "lpips_vgg.pth", "lpips_vgg.npz"))
        torch.save(backbone, b_pth)
        torch.save(lins, l_pth)
        inception_net.save_params(l_npz, lpips_net.convert_torch_state_dict(
            inception_net.load_torch(b_pth), inception_net.load_torch(l_pth), "vgg"))
        net_pth = lpips_net.LPIPSNet("vgg", weights_path=(b_pth, l_pth)).to(dev)
        net_npz = lpips_net.LPIPSNet("vgg", weights_path=l_npz).to(dev)
        check(all(torch.equal(net_pth.net.state_dict()[k].cpu(), v) for k, v in lstate.items()),
              "slice 21: the LPIPS .pth files did not load their weights")
        hw = CKPT_LPIPS_HW21
        a = torch.rand(CKPT_PAIRS21, 3, hw, hw, generator=g_dev, device=dev) * 2 - 1
        b = torch.rand(CKPT_PAIRS21, 3, hw, hw, generator=g_dev, device=dev) * 2 - 1
        torch.backends.cudnn.deterministic = True
        try:
            d_pth, d_npz = net_pth(a, b), net_npz(a, b)
        finally:
            torch.backends.cudnn.deterministic = cudnn_deterministic
        lpips_equal = torch.equal(d_pth, d_npz)
    report["B_checkpoints"] = {"inception": {"images": CKPT_IMAGES21, "shape": list(FID_SHAPE), "bit_equal": inception_equal,
                                             "features_finite": bool(torch.isfinite(f_pth).all())},
                               "lpips_vgg": {"pairs": CKPT_PAIRS21, "hw": hw, "bit_equal": lpips_equal,
                                             "mean": float(d_pth.mean())}}
    print("slice 21 B, PyTorch checkpoints: " + json.dumps(report["B_checkpoints"]))
    check(inception_equal and lpips_equal, f"slice 21: the .pth and .npz paths differ: {report['B_checkpoints']}")
    laps.mark("3. slice 21 B: PyTorch checkpoints")

    # ------------------------------------------------ C. the cold start: a fresh process, the kernels on disk
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (here, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", COLD_START21, str(COLD_SHAPE21[0]), str(COLD_SHAPE21[1]),
                           str(COLD_WARM_REPS21)], cwd=here, env=env, capture_output=True, text=True, timeout=300)
    process_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"slice 21: the cold-start process failed: {proc.stderr[-2000:]}")
    cold = json.loads(proc.stdout.strip().splitlines()[-1])
    cold.update(process_s=process_s, nvcc_build_s=build_s, shape=list(COLD_SHAPE21), card=card)
    report["C_cold_start"] = cold
    print("slice 21 C, the cold start: " + json.dumps(cold))
    check(cold["captured"] and cold["retraces"] == 1, f"slice 21: the cold start's update was not one captured graph: {cold}")
    laps.mark("3. slice 21 C: the cold start")
    report["command_s"] = time.perf_counter() - t_slice
    print(f"slice 21 ({card}): " + json.dumps({"command_s": report["command_s"]}))
    return report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; the port is measured on an NVIDIA card only", file=sys.stderr)
        return 1

    from metrics_tpu_torch import (
        Accuracy,
        BinnedAveragePrecision,
        BinnedRecallAtFixedPrecision,
        CohenKappa,
        ConfusionMatrix,
        F1Score,
        FBetaScore,
        HammingDistance,
        JaccardIndex,
        MatthewsCorrCoef,
        MetricCollection,
        Precision,
        Recall,
        Specificity,
    )
    from metrics_tpu_torch.classification.binned_precision_recall import _linspace_thresholds
    from metrics_tpu_torch.functional.classification.confusion_matrix import _canonicalize_confmat_labels
    from metrics_tpu_torch.ops import (
        _build,
        binned_stat_scores,
        confusion_matrix_counts,
        launches,
        reset_launches,
        stat_scores_counts,
    )
    import metrics_tpu_torch
    from metrics_tpu_torch import CountMinHeavyHitters, HyperLogLog, telemetry
    from metrics_tpu_torch import functional as tF
    from metrics_tpu_torch.ops import countmin_update, registry, sorted_by_preds
    from metrics_tpu_torch.ops.binned_stats import (
        _binned_stat_scores_kernel,
        _binned_stat_scores_plain,
        binned_branch,
        hist_max_thresholds,
        hist_shared_bytes,
    )
    from metrics_tpu_torch.ops.binned_stats import _lib as binned_lib
    from metrics_tpu_torch.ops.confusion import (
        _confmat_kernel,
        _confmat_plain,
        confusion_branch,
        confusion_plan,
        split_shared_bytes,
    )
    from metrics_tpu_torch.ops.confusion import _lib as confusion_lib
    from metrics_tpu_torch.ops.retrieval import _WIDEN, L_MAX, _sorted_by_preds_kernel, _sorted_by_preds_plain, sort_branch
    from metrics_tpu_torch.ops.sketch_ops import (
        _countmin_kernel,
        _countmin_plain,
        _countmin_sessions_plain,
        as_u32_bits,
        countmin_sessions_branch,
        countmin_update_sessions,
        countmin_uses_shared,
        hash_u32,
    )
    from metrics_tpu_torch.retrieval.base import _pad_by_query
    from metrics_tpu_torch.streaming.sketch import _key_bits
    from metrics_tpu_torch.ops.stat_scores import (
        _ONE_BLOCK_ROWS,
        _stat_counts_kernel,
        _stat_counts_plain,
        _stat_counts_sessions_plain,
        stat_scores_branch,
        stat_scores_counts_sessions,
        stat_scores_sessions_branch,
    )
    from metrics_tpu_torch.utilities.data import bucket_pow2, dim_zero_cat, to_onehot

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain one-hot product stays exact float32

    # ------------------------------------------------------------ 1. the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card)
    laps = Laps()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(dev)}")
    t0 = time.perf_counter()
    # and the earlier confusion_matrix design (a zeroed output plus integer atomics), only to time against
    libs = _build.build(_build.SOURCES + ("confusion_atomic",))
    build_s = time.perf_counter() - t0
    print(f"built {', '.join(p.name for p in libs.values())} in {build_s:.2f} s")
    atomic_lib = ctypes.CDLL(str(libs["confusion_atomic"]))
    atomic_lib.confusion_atomic_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    atomic_lib.confusion_atomic_launch.restype = ctypes.c_int

    def confmat_earlier(target, pred, c):
        """The earlier design's launch path: a zeroed output, then its kernel."""
        out = torch.zeros((c, c), dtype=torch.int32, device=dev)
        err = atomic_lib.confusion_atomic_launch(target.data_ptr(), pred.data_ptr(), target.shape[0], c, out.data_ptr(),
                                                 torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"the earlier confusion_matrix design failed to launch: error {err}")
        return out

    laps.mark("1. build")
    t_started = time.perf_counter()
    probe_t = torch.arange(BATCH, device=dev, dtype=torch.int32) % NUM_CLASSES

    def profiler_probe(where):
        """Three confusion_matrix calls in one bare profiler window (no warm-up step, no padding): how many
        kernels it recorded and each one's start less its launch call's (µs), at this point of the run. The
        captures at the confusion_matrix shapes in part 4 read the same late in the run."""
        acts, _, lag = profiled(torch, lambda: confusion_matrix_counts(probe_t, probe_t, NUM_CLASSES), 3,
                                warmup=False, pad_s=0.0)
        print(f"profiler probe {where}, {time.perf_counter() - t_started:.1f} s after the build: "
              + json.dumps({"activities": len(acts), "kernel_less_launch_us": lag}))

    profiler_probe("after the build")

    # -------------------------------------------------- 2. kernel vs plain
    max_err = {name: 0 for name in KERNELS}
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = 0
    stat_cases = {"block": 0, "shared": 0, "global": 0}

    def hold_stat(target, pred, correct, w, c, what):
        """The public entry (the plan's branch), then the other shared-memory branch forced, against the
        plain version: the one-block branch writes every cell, the multi-block branch adds into zeros."""
        planned = stat_scores_branch(target.shape[0], c, dev)
        ref = _stat_counts_plain(target, pred, correct, w, c)
        runs = [(planned, lambda: stat_scores_counts(target, pred, correct, w, c))]
        if planned != "global":
            other = "shared" if planned == "block" else "block"
            runs.append((other, lambda: _stat_counts_kernel(target, pred, correct, w, c, branch=other)))
        for branch, run in runs:
            for a, b in zip(run(), ref):
                check(a.dtype == b.dtype == torch.int32, f"stat_scores dtype {a.dtype} at {what}")
                check(torch.equal(a, b), f"stat_scores ({branch}) differs from its plain version at {what}")
                max_err["stat_scores"] = max(max_err["stat_scores"], int((a - b).abs().max()) if a.numel() else 0)
            stat_cases[branch] += target.shape[0] > 0

    confmat_optin = registry.device_limits(dev, confusion_lib(), "confusion")[1]
    confmat_cases = {}

    def hold_confmat(target, pred, c, what):
        """The public entry (the plan's launch), then each branch forced (the band; where the table fits
        shared memory the split on one block and on 128 blocks), against the plain version."""
        ref = _confmat_plain(target, pred, c)
        runs = [("plan", lambda: confusion_matrix_counts(target, pred, c)),
                ("band", lambda: _confmat_kernel(target, pred, c, branch="band"))]
        if split_shared_bytes(c) <= confmat_optin:
            runs += [(f"split on {b}", lambda b=b: _confmat_kernel(target, pred, c, branch="split", blocks=b))
                     for b in (1, 128)]
        for branch, run in runs:
            got = run()
            check(got.dtype == ref.dtype == torch.int32, f"confusion_matrix dtype {got.dtype}")
            check(torch.equal(got, ref), f"confusion_matrix ({branch}) differs from its plain version at {what}")
            max_err["confusion_matrix"] = max(max_err["confusion_matrix"], int((got - ref).abs().max()))
            confmat_cases[branch] = confmat_cases.get(branch, 0) + (target.shape[0] > 0)

    for n in (0, 1, 100, 128, 129, 512, 1024, _ONE_BLOCK_ROWS, _ONE_BLOCK_ROWS + 1):
        for c in (2, 7, 33, 40, 238, 239, 1000, 20000):
            target = torch.randint(0, c, (n,), generator=g, device=dev, dtype=torch.int32)
            pred = torch.randint(0, c, (n,), generator=g, device=dev, dtype=torch.int32)
            for masked in (False, True):
                w = (torch.randint(0, 2, (n,), generator=g, device=dev, dtype=torch.int32) if masked
                     else torch.ones(n, dtype=torch.int32, device=dev))
                correct = (pred == target) & (w > 0)
                hold_stat(target, pred, correct, w, c, f"n={n} C={c} masked={masked}")
                cases += 1
            if c * c > 64_000_000:
                continue
            # padding label -1 in both columns: it matches no class
            tpad = torch.where(torch.rand(n, generator=g, device=dev) < 0.1, -1, target)
            ppad = torch.where(torch.rand(n, generator=g, device=dev) < 0.1, -1, pred)
            for t_, p_ in ((target, pred), (tpad.to(torch.int32), ppad.to(torch.int32))):
                hold_confmat(t_, p_, c, f"n={n} C={c}")
                cases += 1
    # the flat-index rule of JAX's scatter: pred_cls == C (a NaN score row) adds to tp[0],
    # a negative target under w = 0 wraps into range with weight 0
    for n, c in ((129, 7), (1024, 1000), (_ONE_BLOCK_ROWS + 1, 1000), (1024, 20000)):
        target = torch.randint(0, c, (n,), generator=g, device=dev, dtype=torch.int32)
        pred = torch.randint(0, c, (n,), generator=g, device=dev, dtype=torch.int32)
        w = torch.ones(n, dtype=torch.int32, device=dev)
        pred[::5] = c
        target[1::7], w[1::7] = -1, 0
        target[2::7], w[2::7] = -3 * c, 0
        correct = (pred == target) & (w > 0)
        hold_stat(target, pred, correct, w, c, f"out-of-range classes, n={n} C={c}")
        got = stat_scores_counts(target, pred, correct, w, c)
        check(int(got[2][0]) >= int(((pred == c) & (w > 0)).sum()), "a pred_cls == C row did not reach tp[0]")
        cases += 1
    # long batches up to a segmentation image's 2,097,152 pixels at few classes: labels with both ends out
    # of range, runs of 512 rows on one cell (every lane of a warp adds to one cell), and a start that is not
    # on 16 bytes (the row-by-row loads)
    for n in (65_536, 2_097_152):
        for c in (2, 20, 238, 239):
            target = torch.randint(-1, c + 1, (n,), generator=g, device=dev, dtype=torch.int32)
            pred = torch.randint(-1, c + 1, (n,), generator=g, device=dev, dtype=torch.int32)
            target[::101], pred[1::103] = -(2**31), 2**31 - 1
            runs_t = (torch.arange(n, device=dev) // 512 % c).to(torch.int32)
            runs_p = runs_t.clone()
            runs_p[::97] = (runs_p[::97] + 1) % c
            for kind, (t_, p_) in {"random": (target, pred), "runs of one cell": (runs_t, runs_p),
                                   "misaligned": (target[1:], pred[1:])}.items():
                hold_confmat(t_, p_, c, f"n={n} C={c} {kind}")
                cases += 1
    laps.mark("2. stat_scores and confusion_matrix grid")

    # unsorted, with repeats, +-inf, NaN and -0.0 beside +0.0
    unsorted = torch.tensor([0.5, 0.1, 0.5, 0.9, -float("inf"), float("inf"), 0.0, 0.3, 1.0, float("nan"), -0.0],
                            device=dev)
    optin = registry.device_limits(dev, binned_lib(), "binned_stats")[1]
    t_packed, t_wide = hist_max_thresholds(False, optin), hist_max_thresholds(True, optin)
    hist_bytes = binned_lib().binned_stats_hist_bytes
    for wide in (False, True):
        for t in range(1, 1025):
            check(hist_bytes(t, int(wide)) == hist_shared_bytes(t, wide),
                  f"the plan sizes the histogram at {hist_shared_bytes(t, wide)} bytes for T = {t} (wide {wide}), "
                  f"the kernel's layout at {hist_bytes(t, int(wide))}")
    binned_cases = {"hist": 0, "compare": 0}

    def hold_binned(preds, target, thr, what):
        """The public entry (the plan's branch) and, where that is the histogram branch, the compare
        branch forced, against the plain version."""
        n, c = preds.shape
        planned = binned_branch(n, c, thr.shape[0], dev)[0]
        ref = _binned_stat_scores_plain(preds, target == 1, thr)
        runs = [(planned, lambda: binned_stat_scores(preds, target, thr))]
        if planned == "hist":
            runs.append(("compare", lambda: _binned_stat_scores_kernel(preds, target == 1, thr, compare=True)))
        for branch, run in runs:
            for a, b in zip(run(), ref):
                check(a.dtype == b.dtype == torch.float32 and a.shape == b.shape == (c, thr.shape[0]),
                      f"binned_stats dtype or shape at {what}")
                check(torch.equal(a, b), f"binned_stats ({branch}) differs from its plain version at {what}")
                max_err["binned_stats"] = max(max_err["binned_stats"], float((a - b).abs().max()) if a.numel() else 0.0)
            binned_cases[branch] += n > 0

    def binned_inputs(n, c, thr):
        preds = torch.rand(n, c, generator=g, device=dev)
        if n >= 8:
            # scores exactly on thresholds, then NaN, +inf, -inf and -0.0 rows
            preds[:4] = thr[torch.randint(0, thr.shape[0], (4, c), generator=g, device=dev)]
            preds[4], preds[5], preds[6], preds[7] = float("nan"), float("inf"), -float("inf"), -0.0
        return preds, torch.randint(0, 3, (n, c), generator=g, device=dev)  # 2 is not a positive

    # the threshold limit of the histogram branch and one past it, then the path shapes
    shapes = ((1, 5), (5, 17), (3, 128), (80, 100), (1000, 100), (7, 1), (5, t_packed), (5, t_packed + 1))
    for n in (0, 1, 100, 128, 129, 568, 1024):
        for c, t in shapes:
            thr_sets = [_linspace_thresholds(t, dev)] + ([unsorted] if c in (80, 1000) else [])
            for thr in thr_sets:
                hold_binned(*binned_inputs(n, c, thr), thr, f"n={n} C={c} T={thr.shape[0]}")
                cases += 1
    laps.mark("2. binned_stats grid")
    # long batches: the most rows of the packed counters, then the wide ones at COCO's width (unsorted
    # thresholds too), ImageNet's, and the wide histogram's threshold limit and one past it
    for n, c, t in ((65_535, 80, 100), (65_536, 80, 100), (65_536, 1000, 100), (65_536, 5, t_wide),
                    (65_536, 5, t_wide + 1)):
        for thr in (_linspace_thresholds(t, dev),) + ((unsorted,) if c == 80 else ()):
            hold_binned(*binned_inputs(n, c, thr), thr, f"n={n} C={c} T={thr.shape[0]}")
            cases += 1
    laps.mark("2. binned_stats long batches")

    def hold_sort(p, t, what, all_pairs=False):
        """The kernel against its plain version on the card and on the CPU, bit for bit; ``all_pairs``
        forces that branch at the kernel, with the labels widened as the public entry widens them."""
        if all_pairs:
            got = _sorted_by_preds_kernel(p, t.to(_WIDEN.get(t.dtype, t.dtype)), all_pairs=True).to(t.dtype)
        else:
            got = sorted_by_preds(p, t)
        ref = _sorted_by_preds_plain(p, t)
        check(got.dtype == ref.dtype == t.dtype and got.shape == ref.shape, f"retrieval_sort dtype or shape at {what}")
        check(torch.equal(got, ref), f"retrieval_sort differs from its plain version at {what}")
        check(torch.equal(got.cpu(), _sorted_by_preds_plain(p.cpu(), t.cpu())),
              f"retrieval_sort differs from its plain version on the CPU at {what}")
        max_err["retrieval_sort"] = max(max_err["retrieval_sort"], float((got.double() - ref.double()).abs().max()))

    # the JAX parity grid, then rows holding NaN, +-0, +-inf and ties
    for n in (1, 5, 128, 129, 1000):
        for dtype in (torch.int32, torch.float32, torch.bool):
            p = torch.rand(n, generator=g, device=dev)
            hold_sort(p, torch.randint(0, 2, (n,), generator=g, device=dev).to(dtype), f"n={n} {dtype}")
            cases += 1
    special = torch.tensor([0.0, -0.0, float("nan"), -float("inf"), 1.0, float("nan"), 0.0, -0.0, float("inf")],
                           device=dev)
    order = sorted_by_preds(special, torch.arange(9, device=dev, dtype=torch.int32))
    check(order.tolist() == [8, 4, 0, 1, 6, 7, 3, 2, 5], f"retrieval_sort order of NaN, +-0, +-inf: {order.tolist()}")
    for q, l in ((6, 257), (64, 1024), (3, 3000)):
        p = torch.round(torch.randn(q, l, generator=g, device=dev) * 4) / 4  # ties, and -0.0 from rounding
        p[torch.rand(q, l, generator=g, device=dev) < 0.05] = float("nan")
        p[:, ::37] = float("inf")
        p[:, 1::41] = -float("inf")
        for dtype in (torch.int32, torch.float32, torch.bool, torch.int64, torch.uint8):
            hold_sort(p, torch.randint(0, 4, (q, l), generator=g, device=dev).to(dtype), f"({q}, {l}) {dtype}")
            cases += 1
    # the edges of both branches: every padded length of the bitonic sort and the switch at L_MAX, rows of
    # one value, of NaN only and of +-0, +-inf and NaN among ties, every label dtype; the all-pairs branch
    # forced at the shorter lengths
    pool = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1.0, -1.0], device=dev)
    for l in (1, 2, 31, 32, 33, 255, 257, 1000, 1024, 1025, 4097, L_MAX, L_MAX + 1):
        q = 3 if l <= 4097 else 2
        rows_by_kind = {
            "ties": torch.round(torch.randn(q, l, generator=g, device=dev) * 4) / 4,
            "all equal": torch.full((q, l), 0.5, device=dev),
            "all nan": torch.full((q, l), float("nan"), device=dev),
            "mixed": pool[torch.randint(0, pool.numel(), (q, l), generator=g, device=dev)],
        }
        check(sort_branch(l) == ("bitonic" if l <= L_MAX else "all_pairs"), f"retrieval_sort branch at L={l}")
        for kind, p in rows_by_kind.items():
            for all_pairs in ((False, True) if l <= 4097 else (False,)):
                for dtype in (torch.int32, torch.float32, torch.bool, torch.int64, torch.uint8):
                    t = torch.randint(0, 4, (q, l), generator=g, device=dev).to(dtype)
                    hold_sort(p, t, f"({q}, {l}) {kind} {dtype} all_pairs={all_pairs}", all_pairs)
                    cases += 1
    laps.mark("2. retrieval_sort grid")
    # count-min: the JAX parity grid and both branches, integral weights: exact
    for n in (1, 100, 128, 300, CLICK_BATCH):
        for depth, width in ((2, 128), (4, 1024), (4, 65536)):
            value = torch.randint(0, 50, (depth, width), generator=g, device=dev).float()
            bits = torch.randint(-(2**31), 2**31 - 1, (n,), generator=g, device=dev, dtype=torch.int32)
            bits[::3] = bits[0].clone()  # a hot key
            w = torch.randint(0, 3, (n,), generator=g, device=dev).float()
            seeds = torch.randint(-(2**31), 2**31 - 1, (depth,), generator=g, device=dev, dtype=torch.int32)
            got = countmin_update(value, bits, w, seeds)
            ref = _countmin_plain(value, bits, w, seeds)
            check(got.dtype == ref.dtype == torch.float32 and torch.equal(got, ref),
                  f"countmin differs from its plain version at n={n} ({depth}, {width})")
            max_err["countmin"] = max(max_err["countmin"], float((got - ref).abs().max()))
            cases += 1
    # the edges of the new design: partial warps and blocks, one hot cell a row, depth 1 and 8, widths
    # that are not powers of two, both branches
    for n in (1, 255, 257, CLICK_BATCH):
        for depth, width in ((1, 1000), (8, 1023), (4, 1024), (4, 65536)):
            for hot in ("none", "all"):
                value = torch.randint(0, 50, (depth, width), generator=g, device=dev).float()
                bits = torch.randint(-(2**31), 2**31 - 1, (n,), generator=g, device=dev, dtype=torch.int32)
                if hot == "all":
                    bits[:] = bits[0].clone()
                w = torch.randint(0, 3, (n,), generator=g, device=dev).float()
                seeds = torch.randint(-(2**31), 2**31 - 1, (depth,), generator=g, device=dev, dtype=torch.int32)
                got = countmin_update(value, bits, w, seeds)
                ref = _countmin_plain(value, bits, w, seeds)
                check(torch.equal(got, ref), f"countmin differs from its plain version at n={n} ({depth}, {width}) hot={hot}")
                max_err["countmin"] = max(max_err["countmin"], float((got - ref).abs().max()))
                cases += 1
    # fractional weights: a few keys a cell, so that two summation orders stay within rtol 1e-6; then the
    # shared branch's fixed order: the same input of a full batch with a hot key gives the same bits again
    frac_rel_err = 0.0
    for depth, width in ((4, 1024), (8, 1023), (4, 65536)):
        value = torch.randint(0, 50, (depth, width), generator=g, device=dev).float()
        bits = torch.randint(-(2**31), 2**31 - 1, (4096,), generator=g, device=dev, dtype=torch.int32)
        w = torch.rand(4096, generator=g, device=dev)
        seeds = torch.randint(-(2**31), 2**31 - 1, (depth,), generator=g, device=dev, dtype=torch.int32)
        got, ref = countmin_update(value, bits, w, seeds), _countmin_plain(value, bits, w, seeds)
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=0, msg=f"countmin fractional weights at ({depth}, {width})")
        frac_rel_err = max(frac_rel_err, float(((got - ref).abs() / ref.abs().clamp(min=1e-30)).max()))
        bits = torch.randint(-(2**31), 2**31 - 1, (CLICK_BATCH,), generator=g, device=dev, dtype=torch.int32)
        bits[::3] = bits[0].clone()
        w = torch.rand(CLICK_BATCH, generator=g, device=dev)
        cases += 1
        first = countmin_update(value, bits, w, seeds)
        if countmin_uses_shared(depth, width, dev):
            check(all(torch.equal(countmin_update(value, bits, w, seeds), first) for _ in range(3)),
                  f"countmin's shared branch gave other bits on the same input at ({depth}, {width})")
            cases += 1
    # the session axis: both branches, partial warps, one hot key, a session with no keys, integral weights exact
    for sessions, n, depth, width in ((1, 1, 1, 1), (7, 37, 4, 1000), (64, 513, 8, 1023), (256, 4096, 4, 1024),
                                      (4, CLICK_BATCH, 4, 65536), (3, 0, 4, 64)):
        values = torch.randint(0, 50, (sessions, depth, width), generator=g, device=dev).float()
        bits = torch.randint(-(2**31), 2**31 - 1, (sessions, n), generator=g, device=dev, dtype=torch.int32)
        if n:
            bits[:, ::3] = bits[:, :1].clone()
        w = torch.randint(0, 3, (sessions, n), generator=g, device=dev).float()
        seeds = torch.randint(-(2**31), 2**31 - 1, (depth,), generator=g, device=dev, dtype=torch.int32)
        got = countmin_update_sessions(values, bits, w, seeds)
        ref = _countmin_sessions_plain(values, bits, w, seeds)
        check(torch.equal(got, ref), f"countmin's session axis differs from its plain version at ({sessions}, {n}, "
              f"{depth}, {width})")
        max_err["countmin"] = max(max_err["countmin"], float((got - ref).abs().max()))
        cases += 1
    torch.cuda.synchronize()
    laps.mark("2. countmin grid")
    print(f"kernel vs plain: {cases} cases equal (fractional count-min weights: largest relative difference "
          f"{frac_rel_err:.3g}), max_abs_err {max_err}; kernel runs by branch: stat_scores {json.dumps(stat_cases)}, "
          f"confusion_matrix {json.dumps(confmat_cases)}, "
          f"binned_stats {json.dumps(binned_cases)} (histogram limits T = {t_packed} packed, {t_wide} wide)")

    # ------------------------------------------------------------ 3. the slice
    scores, labels = imagenet_data(torch, dev)
    batches =[(scores[i:i + BATCH], labels[i:i + BATCH]) for i in range(0, N_VAL, BATCH)]
    check(len(batches) == 49 and batches[-1][0].shape[0] == 848, "the slice is 48 batches of 1024 and one of 848")

    # the confusion-matrix family beside ConfusionMatrix, all on the confusion_matrix kernel
    family_kinds = {"cohen_kappa": (CohenKappa, dict(weights="quadratic")), "matthews_corrcoef": (MatthewsCorrCoef, {}),
                    "jaccard_index": (JaccardIndex, {})}

    def run_slice(device, data):
        acc = Accuracy(num_classes=NUM_CLASSES, average="macro", device=device)
        cm = ConfusionMatrix(num_classes=NUM_CLASSES, update_method="matmul", device=device)
        family = {key: cls(num_classes=NUM_CLASSES, update_method="matmul", device=device, **kwargs)
                  for key, (cls, kwargs) in family_kinds.items()}
        acc.reset()
        cm.reset()
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_start = time.perf_counter()
        for i, (p, t) in enumerate(data):
            if i == len(data) - 1:
                batch_vals = (acc(p, t), cm(p, t))  # forward: one update and the batch's value
                family_batch = {key: m(p, t) for key, m in family.items()}
            else:
                acc.update(p, t)
                cm.update(p, t)
                for m in family.values():
                    m.update(p, t)
        values = (acc.compute(), cm.compute())
        family_values = {key: m.compute() for key, m in family.items()}
        if device.type == "cuda":
            torch.cuda.synchronize()
        return acc, cm, family, batch_vals, family_batch, values, family_values, time.perf_counter() - t_start

    reset_launches()
    acc, cm, family, batch_vals, family_batch, values, family_values, epoch_s = run_slice(dev, batches)
    slice1_values, slice1_batch_vals = values, batch_vals  # held for slice 8 (later phases reuse the names)
    counts = launches()
    stat_by_shape = registry.launches_by_shape("stat_scores")
    confmat_slice_by_shape = registry.launches_by_shape("confusion_matrix")
    print(f"slice on the card: 49 batches in {epoch_s * 1e3:.1f} ms, launches {counts}; stat_scores by branch and "
          f"shape {json.dumps(by_shape(stat_by_shape))}; confusion_matrix {json.dumps(by_shape(confmat_slice_by_shape))}")
    check(counts["stat_scores"] == 49, f"stat_scores launched {counts['stat_scores']} times in the slice, not 49")
    confmat_expected = 49 * (1 + len(family))  # ConfusionMatrix and the three of its family, a launch a batch each
    check(counts["confusion_matrix"] == confmat_expected,
          f"confusion_matrix launched {counts['confusion_matrix']} times in the slice, not {confmat_expected}")
    check(sum(stat_by_shape.values()) == 49 and {b for b, _ in stat_by_shape} == {"block"},
          f"stat_scores launches by branch and shape {stat_by_shape}: not 49 on the one-block branch")
    check(confmat_slice_by_shape == {("band", (BATCH, NUM_CLASSES)): 48 * (1 + len(family)),
                                     ("band", (N_VAL - 48 * BATCH, NUM_CLASSES)): 1 + len(family)},
          f"confusion_matrix launches by branch and shape {confmat_slice_by_shape}: not all on the band branch")

    # the CPU rerun: the epoch's first SLICE1_CPU_BATCHES batches and its last (forward's 848 rows), against a
    # card run over the same batches
    cpu = torch.device("cpu")
    head = SLICE1_CPU_BATCHES
    rerun = batches[:head] + batches[-1:]
    h_acc, h_cm, h_family, h_batch_vals, h_family_batch, h_values, h_family_values, _ = run_slice(dev, rerun)
    cpu_batches = [(p.cpu(), t.cpu()) for p, t in rerun]
    c_acc, c_cm, c_family, c_batch_vals, c_family_batch, c_values, c_family_values, cpu_s = run_slice(cpu, cpu_batches)
    check(int(c_batch_vals[1].sum()) == batches[-1][0].shape[0] == 848, "the CPU rerun's forward did not take the last batch")
    print(f"same slice on the CPU (plain versions), its first {head} batches and the last: {cpu_s * 1e3:.1f} ms")
    for name in ("tp", "fp", "tn", "fn"):
        a, b = getattr(h_acc, name), getattr(c_acc, name)
        check(a.dtype == b.dtype == torch.int32 and torch.equal(a.cpu(), b), f"Accuracy.{name} differs from the CPU run")
    check(h_cm.confmat.dtype == torch.int32 and torch.equal(h_cm.confmat.cpu(), c_cm.confmat),
          "confusion matrix differs from the CPU run")
    check(torch.equal(h_batch_vals[1].cpu(), c_batch_vals[1]), "forward's batch confusion matrix differs from the CPU run")
    for got, ref, what in ((h_values[0], c_values[0], "accuracy"), (h_batch_vals[0], c_batch_vals[0], "forward's batch accuracy")):
        check(got.shape == () and bool(torch.isfinite(got)), f"{what} is not a finite scalar: {got}")
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-6, atol=0, msg=f"{what} differs from the CPU run")
    for key, m in h_family.items():
        check(m.confmat.dtype == torch.int32 and torch.equal(m.confmat.cpu(), c_family[key].confmat),
              f"{key} confusion matrix differs from the CPU run")
        for got, ref, what in ((h_family_values[key], c_family_values[key], key),
                               (h_family_batch[key], c_family_batch[key], f"forward's batch {key}")):
            check(got.shape == () and bool(torch.isfinite(got)), f"{what} is not a finite scalar: {got}")
            torch.testing.assert_close(got.cpu(), ref, rtol=1e-6, atol=0, msg=f"{what} differs from the CPU run")

    # an independent reference from the scores: argmax labels, a bincount, macro recall
    ref_cm = torch.bincount(labels * NUM_CLASSES + scores.argmax(dim=1), minlength=NUM_CLASSES**2)
    ref_cm = ref_cm.reshape(NUM_CLASSES, NUM_CLASSES)
    check(torch.equal(cm.confmat.long(), ref_cm), "confusion matrix differs from the bincount of argmax labels")
    # the whole epoch's Accuracy counts, exactly: the matrix's diagonal, column and row sums
    ref_tp = ref_cm.diag()
    ref_fp, ref_fn = ref_cm.sum(dim=0) - ref_tp, ref_cm.sum(dim=1) - ref_tp
    for name, want in (("tp", ref_tp), ("fp", ref_fp), ("tn", N_VAL - ref_tp - ref_fp - ref_fn), ("fn", ref_fn)):
        got = getattr(acc, name)
        check(got.dtype == torch.int32 and torch.equal(got.long(), want),
              f"the epoch's Accuracy.{name} differs from the bincount of argmax labels")
    diag = ref_cm.diag().double()
    support = ref_cm.sum(dim=1).double()
    present = (support + ref_cm.sum(dim=0).double() - diag) > 0
    ref_acc = torch.where(support > 0, diag / support.clamp(min=1), 0.0)[present].mean()
    # float32 (sum of 1000 class scores) against float64: a looser rtol than the CPU comparison
    torch.testing.assert_close(values[0].double(), ref_acc, rtol=1e-5, atol=0, msg="accuracy differs from macro recall")
    bincount_cm = ConfusionMatrix(num_classes=NUM_CLASSES, device=dev)
    for p, t in batches:
        bincount_cm.update(p, t)
    check(torch.equal(bincount_cm.compute(), values[1]), "update_method='bincount' differs from 'matmul'")
    # the family against the bincount matrix, and their values against float64 numpy from it (float32 sums of
    # up to 10^6 cells against float64: rtol 1e-5)
    family_ref = numpy_confmat_scores(ref_cm.cpu().numpy())
    for (key, m), ref_key in zip(family.items(), ("kappa", "mcc", "miou")):
        check(torch.equal(m.confmat.long(), ref_cm), f"{key} confusion matrix differs from the bincount of argmax labels")
        np.testing.assert_allclose(float(family_values[key]), family_ref[ref_key], rtol=1e-5, atol=0,
                                   err_msg=f"{key} differs from the float64 numpy value of the bincount matrix")
    print(f"slice results: macro accuracy {float(values[0]):.6f}, confusion matrix total {int(values[1].sum())}, "
          f"quadratic kappa {float(family_values['cohen_kappa']):.6f}, MCC {float(family_values['matthews_corrcoef']):.6f}, "
          f"mean IoU {float(family_values['jaccard_index']):.6f} (numpy from the bincount matrix "
          f"{json.dumps({k: round(v, 6) for k, v in family_ref.items()})})")

    for metric, cls, kwargs in (
        (acc, Accuracy, dict(num_classes=NUM_CLASSES, average="macro")),
        (cm, ConfusionMatrix, dict(num_classes=NUM_CLASSES, update_method="matmul")),
        *((family[key], cls, dict(num_classes=NUM_CLASSES, update_method="matmul", **kwargs))
          for key, (cls, kwargs) in family_kinds.items()),
    ):
        metric.persistent(True)
        fresh = cls(device=dev, **kwargs)
        fresh.load_state_dict(metric.state_dict())
        check(torch.equal(fresh.compute(), metric.compute()), f"{cls.__name__} state_dict round trip changed the value")
        # the whole epoch's value against the CPU's plain compute of the same states
        twin = cls(device=cpu, **kwargs)
        twin.load_state_dict(metric.state_dict())
        torch.testing.assert_close(metric.compute().cpu(), twin.compute(), rtol=1e-6, atol=0,
                                   msg=f"the epoch's {cls.__name__} differs from the CPU's compute of its states")
        metric.reset()
        check(metric._update_count == 0 and all(int(getattr(metric, k).abs().sum()) == 0 for k in metric._defaults),
              f"{cls.__name__}.reset left state behind")
    print("state_dict round trip and reset: ok")
    laps.mark("3. slice 1, card and CPU")

    # ------------------------------- 3a. slice 7: the ImageNet evaluation collection, compute groups
    def collection_members(device):
        return evaluation_members(metrics_tpu_torch, device)

    def run_collection(device, data, compute_groups=True):
        """A validation epoch as a training loop logs it: ``update`` on every batch, then ``compute``."""
        mc = MetricCollection(collection_members(device), prefix="val_", compute_groups=compute_groups,
                              fused_update=False)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_start = time.perf_counter()
        for p_, t_ in data:
            mc.update(p_, t_)
        out = mc.compute()
        if device.type == "cuda":
            torch.cuda.synchronize()
        return mc, out, time.perf_counter() - t_start

    reset_launches()
    coll, coll_values, coll_epoch_s = run_collection(dev, batches)
    coll_launches = launches()
    coll_stat_by_shape = registry.launches_by_shape("stat_scores")
    coll_confmat_by_shape = registry.launches_by_shape("confusion_matrix")
    check(coll.compute_groups == COLLECTION_GROUPS,
          f"the collection formed the groups {coll.compute_groups}, not the JAX package's {COLLECTION_GROUPS}")
    n_stat, n_conf = len(COLLECTION_GROUPS[0]), len(COLLECTION_GROUPS[2])
    check(coll_launches["stat_scores"] == n_stat + len(batches) - 1,
          f"stat_scores launched {coll_launches['stat_scores']} times in the grouped epoch, not {n_stat + len(batches) - 1}")
    check(coll_launches["confusion_matrix"] == n_conf + len(batches) - 1,
          f"confusion_matrix launched {coll_launches['confusion_matrix']} times in the grouped epoch, "
          f"not {n_conf + len(batches) - 1}")
    check({b for b, _ in coll_stat_by_shape} == {"block"} and {b for b, _ in coll_confmat_by_shape} == {"band"},
          f"the grouped epoch's launches by branch: stat_scores {coll_stat_by_shape}, confusion_matrix {coll_confmat_by_shape}")
    # bit-equal to slice 1's standalone metrics on the same scores
    for key, ref in (("val_Accuracy", values[0]), ("val_ConfusionMatrix", values[1]),
                     ("val_CohenKappa", family_values["cohen_kappa"]),
                     ("val_MatthewsCorrCoef", family_values["matthews_corrcoef"]),
                     ("val_JaccardIndex", family_values["jaccard_index"])):
        check(coll_values[key].dtype == ref.dtype and torch.equal(coll_values[key], ref),
              f"{key} of the collection differs from slice 1's standalone metric: {coll_values[key]} against {ref}")
    # the rest of the family against float64 numpy from the epoch's bincount matrix (float32 sums of 1,000
    # classes against float64: rtol 1e-5). The Hamming distance is 1 - correct / total in float32, as in the
    # JAX package: near 1, correct / total carries an absolute error up to one float32 step at 1.0, which
    # the difference keeps, so its counts are held exactly and its value also within atol 2**-23.
    stat_ref = numpy_stat_family(ref_cm.cpu().numpy(), FBETA)
    positions, wrong = int(ref_cm.sum()) * NUM_CLASSES, int(ref_cm.sum() - ref_cm.diag().sum())
    hamming = coll["HammingDistance"]
    check(int(hamming.total) == positions and int(hamming.correct) == positions - 2 * wrong,
          f"HammingDistance counts {int(hamming.correct)} of {int(hamming.total)} positions: not "
          f"{positions - 2 * wrong} of {positions}")
    for key, ref_key in (("val_Precision", "precision"), ("val_Recall", "recall"), ("val_F1Score", "f1"),
                         ("val_FBetaScore", "fbeta"), ("val_Specificity", "specificity"),
                         ("val_HammingDistance", "hamming")):
        got = coll_values[key]
        check(got.shape == () and got.dtype == torch.float32 and bool(torch.isfinite(got)), f"{key} is {got}")
        np.testing.assert_allclose(float(got), stat_ref[ref_key], rtol=1e-5, atol=2.0**-23 if ref_key == "hamming" else 0,
                                   err_msg=f"{key} differs from the float64 numpy value of the bincount matrix")
    # forward on the last batch: every member's batch value, bit-equal to slice 1's forward values
    reset_launches()
    coll_batch = coll(*batches[-1])
    coll_fwd_launches = launches()
    check(coll_fwd_launches["stat_scores"] == n_stat and coll_fwd_launches["confusion_matrix"] == n_conf,
          f"the collection's forward launched {coll_fwd_launches}: not one a member")
    for key, ref in (("val_Accuracy", batch_vals[0]), ("val_ConfusionMatrix", batch_vals[1]),
                     ("val_CohenKappa", family_batch["cohen_kappa"]),
                     ("val_MatthewsCorrCoef", family_batch["matthews_corrcoef"]),
                     ("val_JaccardIndex", family_batch["jaccard_index"])):
        check(torch.equal(coll_batch[key], ref), f"forward's {key} differs from slice 1's forward value")
    # state_dict into a fresh collection (one checksum pass), then reset
    coll.persistent(True)
    fresh = MetricCollection(collection_members(dev), prefix="val_", fused_update=False)
    fresh.persistent(True)
    payload = coll.state_dict()
    fresh.load_state_dict(payload)
    for key, got in fresh.compute().items():
        check(torch.equal(got, coll.compute()[key]), f"the collection's state_dict round trip changed {key}")
    coll.reset()
    check(all(m._update_count == 0 and all(int(getattr(m, k).abs().sum()) == 0 for k in m._defaults)
              for m in coll.values()), "the collection's reset left state behind")

    # the first batches: grouped against ungrouped on the card (bit-equal), and the grouped run on the CPU
    head = batches[:COLLECTION_CPU_BATCHES]
    reset_launches()
    off, off_values, _ = run_collection(dev, head, compute_groups=False)
    off_launches = launches()
    check(off_launches["stat_scores"] == n_stat * len(head) and off_launches["confusion_matrix"] == n_conf * len(head),
          f"the ungrouped collection launched {off_launches} over {len(head)} batches")
    on, on_values, _ = run_collection(dev, head)
    for key, got in on_values.items():
        check(got.dtype == off_values[key].dtype and torch.equal(got, off_values[key]),
              f"{key}: grouped {got} against ungrouped {off_values[key]} on the first {len(head)} batches")
    c_on, c_on_values, c_head_s = run_collection(cpu, [(p_.cpu(), t_.cpu()) for p_, t_ in head])
    check(c_on.compute_groups == COLLECTION_GROUPS, f"the CPU run formed the groups {c_on.compute_groups}")
    for name in on.keys(keep_base=True):
        for k in on[name]._defaults:
            a, b = getattr(on[name], k), getattr(c_on[name], k)
            check(a.dtype == b.dtype and torch.equal(a.cpu(), b), f"{name}.{k} differs from the CPU run")
    for key, got in on_values.items():
        torch.testing.assert_close(got.cpu(), c_on_values[key], rtol=1e-6, atol=0,
                                   msg=f"{key} of the first {len(head)} batches differs from the CPU run")

    # a CompositionalMetric alone: 2PR / (P + R). Each of P and R stands twice in the tree, and an update
    # reaches a metric once for each place it stands, as in the JAX package: macro P and R launch
    # stat_scores four times an update; micro ones never (their counts need no per-class counts).
    comps, comp_launches = {}, {}
    for avg in ("micro", "macro"):
        pr = Precision(num_classes=NUM_CLASSES, average=avg, device=dev)
        rc = Recall(num_classes=NUM_CLASSES, average=avg, device=dev)
        comps[avg] = 2 * pr * rc / (pr + rc)
        reset_launches()
        for p_, t_ in batches:
            comps[avg].update(p_, t_)
        comp_launches[avg] = launches()["stat_scores"]
    comp_stat_by_shape = registry.launches_by_shape("stat_scores")  # the macro composition's
    check(comp_launches == {"micro": 0, "macro": 4 * len(batches)},
          f"the compositions launched stat_scores {comp_launches} times over {len(batches)} updates")
    f1_micro = F1Score(num_classes=NUM_CLASSES, average="micro", device=dev)
    for p_, t_ in batches:
        f1_micro.update(p_, t_)
    torch.testing.assert_close(comps["micro"].compute(), f1_micro.compute(), rtol=1e-6, atol=0,
                               msg="2PR/(P+R) of micro precision and recall differs from F1Score(average='micro')")
    harmonic = 2 * stat_ref["precision"] * stat_ref["recall"] / (stat_ref["precision"] + stat_ref["recall"])
    np.testing.assert_allclose(float(comps["macro"].compute()), harmonic, rtol=1e-5, atol=0,
                               err_msg="2PR/(P+R) of macro precision and recall differs from float64 numpy")

    # timings: a grouped update against an ungrouped one and against the three leaders' own updates (one call
    # updates the three standalone metrics), all in turns; each leader's own update alone after them
    x_p, x_t = batches[-2]
    leaders = {"accuracy": Accuracy(num_classes=NUM_CLASSES, average="macro", device=dev),
               "hamming": HammingDistance(device=dev),
               "confmat": ConfusionMatrix(NUM_CLASSES, update_method="matmul", device=dev)}
    grouped, ungrouped = (MetricCollection(collection_members(dev), compute_groups=cg, fused_update=False)
                          for cg in (True, False))
    grouped.update(x_p, x_t)  # forms the groups

    def leaders_update():
        for m in leaders.values():
            m.update(x_p, x_t)

    in_turns = host_ms_in_turns(torch, {"leaders": leaders_update, "grouped": lambda: grouped.update(x_p, x_t),
                                        "ungrouped": lambda: ungrouped.update(x_p, x_t)})
    coll_timing = {"leaders_update_ms": in_turns["leaders"], "grouped_update_ms": in_turns["grouped"],
                   "ungrouped_update_ms": in_turns["ungrouped"],
                   "grouped_over_leaders": in_turns["grouped"] / in_turns["leaders"],
                   "ungrouped_over_grouped": in_turns["ungrouped"] / in_turns["grouped"]}
    coll_timing.update({f"{k}_update_ms": ms for k, ms in host_ms_in_turns(
        torch, {k: lambda m=m: m.update(x_p, x_t) for k, m in leaders.items()}).items()})
    coll_timing["grouped_syncs"] = syncs_per_call(torch, lambda: grouped.update(x_p, x_t))
    coll_timing["grouped_syncs_per_update"] = len(coll_timing["grouped_syncs"])

    def detect():
        grouped._init_compute_groups()
        grouped._merge_compute_groups()

    grouped._compute_groups_create_state_ref()  # the members take their leaders' state: detection finds the groups
    coll_timing["group_detection_ms"] = host_ms(torch, detect)
    detection_reads = syncs_per_call(torch, detect)
    check(len(detection_reads) == 1 and grouped.compute_groups == COLLECTION_GROUPS,
          f"group detection read the device {len(detection_reads)} times ({detection_reads}) and formed "
          f"{grouped.compute_groups}")
    coll_timing["group_detection_host_reads"] = len(detection_reads)
    coll_timing["grouped_update_under_profiler"] = device_busy(torch, lambda: grouped.update(x_p, x_t))
    coll_timing["epoch_ms"] = coll_epoch_s * 1e3
    coll_timing["cpu_first_batches_ms"] = c_head_s * 1e3
    print(f"slice 7, the ImageNet evaluation collection ({len(coll)} members, groups "
          f"{json.dumps(coll.compute_groups)}): epoch of {len(batches)} batches in {coll_epoch_s * 1e3:.1f} ms, "
          f"launches {json.dumps(coll_launches)} (ungrouped over {len(head)} batches {json.dumps(off_launches)}, "
          f"forward {json.dumps(coll_fwd_launches)}); values "
          f"{json.dumps({k: round(float(v), 6) for k, v in coll_values.items() if v.ndim == 0})} (numpy "
          f"{json.dumps({k: round(float(v), 6) for k, v in stat_ref.items()})}); 2PR/(P+R): micro "
          f"{float(comps['micro'].compute()):.6f} against F1Score {float(f1_micro.compute()):.6f}, macro "
          f"{float(comps['macro'].compute()):.6f}, stat_scores launches {json.dumps(comp_launches)}; "
          f"{json.dumps(coll_timing)}")
    profiler_probe("after slice 7")
    laps.mark("3. slice 7, evaluation collection, card and CPU")

    # ------------------------------------------------- 3b. slice 2: binned curves
    def run_imagenet_binned(device, data):
        # made on the CPU and moved: the thresholds must follow the states
        ap = BinnedAveragePrecision(num_classes=NUM_CLASSES, thresholds=THRESHOLDS, device="cpu").to(device)
        rap = BinnedRecallAtFixedPrecision(
            num_classes=NUM_CLASSES, min_precision=MIN_PRECISION, thresholds=THRESHOLDS, device=device
        )
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_start = time.perf_counter()
        for p, t in data:
            ap.update(p, t)
            rap.update(p, t)
        values = (torch.stack(ap.compute()), *rap.compute())
        if device.type == "cuda":
            torch.cuda.synchronize()
        return (ap, rap), values, time.perf_counter() - t_start

    def run_coco_binned(device, data):
        m = BinnedAveragePrecision(num_classes=COCO_CLASSES, thresholds=THRESHOLDS, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_start = time.perf_counter()
        for i, (p, t) in enumerate(data):
            if i == len(data) - 1:
                batch_val = torch.stack(m(p, t))  # forward: one update and the batch's value
            else:
                m.update(p, t)
        values = (torch.stack(m.compute()), batch_val)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return (m,), values, time.perf_counter() - t_start

    coco_scores, coco_target = coco_data(torch, dev)
    coco_batches = [(coco_scores[i:i + BATCH], coco_target[i:i + BATCH]) for i in range(0, N_COCO, BATCH)]
    check(len(coco_batches) == 40 and coco_batches[-1][0].shape[0] == 568, "COCO is 39 batches of 1024 and one of 568")
    thr_ref = _linspace_thresholds(THRESHOLDS, dev)
    imagenet_onehot = torch.zeros(N_VAL, NUM_CLASSES, dtype=torch.bool, device=dev)
    imagenet_onehot[torch.arange(N_VAL, device=dev), labels] = True
    binned_paths = {
        "imagenet": (run_imagenet_binned, batches, cpu_batches[:BINNED_CPU_BATCHES], 2 * len(batches),
                     (scores, imagenet_onehot)),
        "coco": (run_coco_binned, coco_batches, [(p.cpu(), t.cpu()) for p, t in coco_batches], len(coco_batches),
                 (coco_scores, coco_target)),
    }
    binned_launches = {}
    binned_by_shape = {}  # by path: the wrapper's launches per (branch, shape)
    binned_metrics = {}
    for path, (run, data, cpu_data, expected, (all_scores, all_target)) in binned_paths.items():
        reset_launches()
        metrics, values, card_s = run(dev, data)
        binned_launches[path] = launches()["binned_stats"]
        path_by_shape = binned_by_shape[path] = registry.launches_by_shape("binned_stats")
        check(binned_launches[path] == expected,
              f"binned_stats launched {binned_launches[path]} times on the {path} path, not {expected}")
        check(sum(path_by_shape.values()) == expected and all(b.startswith("hist") for b, _ in path_by_shape),
              f"binned_stats launches by branch and shape on the {path} path: {path_by_shape}")
        c_metrics, c_values, cpu_path_s = run(cpu, cpu_data)
        # a CPU run over a prefix is held against a card run over the same prefix (made after the path's launches
        # were read); the whole epoch on the card against the searchsorted reference
        head = len(cpu_data)
        head_metrics, head_values = (metrics, values) if head == len(data) else run(dev, data[:head])[:2]
        print(f"{path} binned path: {len(data)} batches in {card_s * 1e3:.1f} ms on the card, the first {head} in "
              f"{cpu_path_s * 1e3:.1f} ms on the CPU (plain versions); binned_stats launches {binned_launches[path]}, "
              f"by branch and shape {json.dumps(by_shape(path_by_shape))}")
        ref = searchsorted_counts(torch, all_scores, all_target, thr_ref)
        for m, h_m, c_m in zip(metrics, head_metrics, c_metrics):
            for name, r in zip(("TPs", "FPs", "FNs"), ref):
                a = getattr(m, name)
                check(a.dtype == torch.float32 and a.shape == (all_scores.shape[1], THRESHOLDS),
                      f"{path} {type(m).__name__}.{name} dtype or shape")
                check(torch.equal(getattr(h_m, name).cpu(), getattr(c_m, name)),
                      f"{path} {type(m).__name__}.{name} of the first {head} batches differs from the CPU run")
                check(torch.equal(a, r), f"{path} {type(m).__name__}.{name} differs from the searchsorted reference")
        for got in values:
            check(bool(torch.isfinite(got).all()), f"{path} values are not finite")
        for got, want in zip(head_values, c_values):
            torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0,
                                       msg=f"{path} values of the first {head} batches differ from the CPU run")
        for m in metrics:
            m.persistent(True)
            kwargs = dict(num_classes=m.num_classes, thresholds=THRESHOLDS, device=dev)
            if isinstance(m, BinnedRecallAtFixedPrecision):
                kwargs["min_precision"] = MIN_PRECISION
            fresh = type(m)(**kwargs)
            fresh.load_state_dict(m.state_dict())
            for a, b in zip(fresh.compute(), m.compute()):
                check(torch.equal(a, b), f"{path} {type(m).__name__} state_dict round trip changed the value")
            m.reset()
            check(m._update_count == 0 and all(int(getattr(m, k).abs().sum()) == 0 for k in m._defaults),
                  f"{path} {type(m).__name__}.reset left state behind")
        binned_metrics[path] = values
        laps.mark(f"3. {path} binned path, card and CPU")
    imagenet_values, coco_values = binned_metrics["imagenet"], binned_metrics["coco"]
    print(f"slice 2 results: ImageNet mean binned AP {float(imagenet_values[0].mean()):.6f}, mean recall at "
          f"precision {MIN_PRECISION} {float(imagenet_values[1].mean()):.6f}; COCO mAP {float(coco_values[0].mean()):.6f} "
          f"(last batch {float(coco_values[1].mean()):.6f}); states equal to the CPU run and the searchsorted "
          "reference; state_dict round trip and reset: ok")

    # ------------------------------------------ 3c. slice 3: retrieval, MS MARCO
    m_scores, m_target, m_qids = marco_data(torch, dev)
    marco_batches = [
        (m_scores[i:i + MARCO_QUERY_BATCH].reshape(-1), m_target[i:i + MARCO_QUERY_BATCH].reshape(-1),
         m_qids[i:i + MARCO_QUERY_BATCH].reshape(-1))
        for i in range(0, MARCO_QUERIES, MARCO_QUERY_BATCH)
    ]
    check(len(marco_batches) == 110 and marco_batches[-1][0].numel() == 4 * MARCO_CANDIDATES,
          "MS MARCO is 109 updates of 64 queries and one of 4")

    def run_marco(device, data):
        metrics = {key: getattr(metrics_tpu_torch, cls)(device=device, **kw) for key, (cls, kw, _, _) in RETRIEVAL.items()}
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_start = time.perf_counter()
        for p, t, i in data:
            for m in metrics.values():
                m.update(p, t, i)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_updates = time.perf_counter()
        values, compute_s = {}, {}
        for key, m in metrics.items():
            t0 = time.perf_counter()
            values[key] = m.compute()
            if device.type == "cuda":
                torch.cuda.synchronize()
            compute_s[key] = time.perf_counter() - t0
        return metrics, values, t_updates - t_start, compute_s, time.perf_counter() - t_start

    def run_functionals(scores, target):
        return {key: torch.stack([getattr(tF, fn)(scores[q], target[q], **kw) for q in range(scores.shape[0])])
                for key, (_, _, fn, kw) in RETRIEVAL.items()}

    reset_launches()
    marco, marco_values, marco_update_s, marco_compute_s, marco_s = run_marco(dev, marco_batches)
    marco_module_launches = launches()["retrieval_sort"]
    head_s, head_t = m_scores[:MARCO_FUNCTIONAL_QUERIES], m_target[:MARCO_FUNCTIONAL_QUERIES]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    functional_values = run_functionals(head_s, head_t)
    torch.cuda.synchronize()
    functional_s = time.perf_counter() - t0
    marco_launches = launches()["retrieval_sort"]
    sort_path_by_shape = registry.launches_by_shape("retrieval_sort")
    expected = len(RETRIEVAL) * (1 + MARCO_FUNCTIONAL_QUERIES)
    check(marco_module_launches == len(RETRIEVAL) and marco_launches == expected,
          f"retrieval_sort launched {marco_module_launches} times in the module computes and {marco_launches} in all"
          f" on the MS MARCO path, not {len(RETRIEVAL)} and {expected}")
    print(f"MS MARCO path on the card: {len(marco_batches)} updates of 8 metrics in {marco_update_s * 1e3:.1f} ms, "
          f"computes {json.dumps({k: round(v * 1e3, 3) for k, v in marco_compute_s.items()})} ms, epoch "
          f"{marco_s * 1e3:.1f} ms; functionals over {MARCO_FUNCTIONAL_QUERIES} queries {functional_s * 1e3:.1f} ms; "
          f"retrieval_sort launches {marco_launches}")

    cpu_marco_batches = [(p.cpu(), t.cpu(), i.cpu()) for p, t, i in marco_batches]
    c_marco, c_marco_values, c_update_s, c_compute_s, c_marco_s = run_marco(cpu, cpu_marco_batches)
    c_functional = run_functionals(head_s.cpu(), head_t.cpu())
    print(f"same MS MARCO path on the CPU (plain versions): updates {c_update_s * 1e3:.1f} ms, epoch {c_marco_s * 1e3:.1f} ms")
    for key, got in marco_values.items():
        check(got.shape == () and got.dtype == torch.float32 and bool(torch.isfinite(got)), f"{key} is not a finite float32 scalar")
        torch.testing.assert_close(got.cpu(), c_marco_values[key], rtol=1e-6, atol=0, msg=f"MS MARCO {key} differs from the CPU run")
        torch.testing.assert_close(functional_values[key].cpu(), c_functional[key], rtol=1e-6, atol=0,
                                   msg=f"functional {key} differs from the CPU run")
    state = [dim_zero_cat(getattr(marco["map"], k)) for k in ("indexes", "preds", "target")]
    pp, pt, _ = _pad_by_query(*state)
    c_pp, c_pt, _ = _pad_by_query(*(s.cpu() for s in state))
    check(pp.shape == (MARCO_QUERIES, 1024), f"MS MARCO pads to {tuple(pp.shape)}, not (6980, 1024)")
    sorted_rel = sorted_by_preds(pp, pt > 0)
    check(torch.equal(sorted_rel.cpu(), sorted_by_preds(c_pp, c_pt > 0)), "the sorted relevance matrix differs from the CPU run")
    reference = numpy_retrieval(head_s.cpu().numpy(), head_t.cpu().numpy())
    for key, ref in reference.items():
        np.testing.assert_allclose(functional_values[key].cpu().double().numpy(), ref, rtol=1e-6, atol=0,
                                   err_msg=f"functional {key} differs from the numpy argsort reference")
    print(f"MS MARCO results: {json.dumps({k: round(float(v), 6) for k, v in marco_values.items()})}; equal to the CPU run "
          f"(rtol 1e-6), sorted relevance equal, first {MARCO_FUNCTIONAL_QUERIES} queries equal to the numpy reference")
    laps.mark("3. MS MARCO path, card and CPU")

    # ------------------------------------------------ 3d. slice 3: TREC DL 2019
    tr_scores, tr_grade, tr_qids = trec_data(torch, dev)

    def run_trec(device):
        m = metrics_tpu_torch.RetrievalNormalizedDCG(k=10, device=device)
        m.update(tr_scores.reshape(-1).to(device), tr_grade.reshape(-1).to(device), tr_qids.reshape(-1).to(device))
        return m.compute()

    reset_launches()
    trec_value = run_trec(dev)
    trec_launches = launches()["retrieval_sort"]
    for key, count in registry.launches_by_shape("retrieval_sort").items():
        sort_path_by_shape[key] = sort_path_by_shape.get(key, 0) + count
    check(trec_launches == 1, f"retrieval_sort launched {trec_launches} times on the TREC DL path, not 1")
    check(sum(sort_path_by_shape.values()) == marco_launches + trec_launches,
          f"retrieval_sort launches by branch and shape {sort_path_by_shape}")
    torch.testing.assert_close(trec_value.cpu(), run_trec(cpu), rtol=1e-6, atol=0, msg="TREC DL nDCG@10 differs from the CPU run")
    trec_ref = numpy_retrieval(tr_scores.cpu().numpy(), tr_grade.cpu().numpy())["ndcg@10"].mean()
    # float32 sums of 43 queries against float64
    np.testing.assert_allclose(float(trec_value), trec_ref, rtol=1e-5, atol=0, err_msg="TREC DL nDCG@10 differs from numpy")
    print(f"TREC DL 2019 graded nDCG@10 {float(trec_value):.6f} (numpy {trec_ref:.6f}); retrieval_sort launches {trec_launches}")

    # ------------------------------------------- 3e. slice 3: click-log sketches
    clicks = click_stream(torch, dev)
    click_batches = [clicks[i:i + CLICK_BATCH] for i in range(0, CLICKS, CLICK_BATCH)]
    check(len(click_batches) == 153 and click_batches[-1].numel() == CLICKS - 152 * CLICK_BATCH,
          "the click stream is 152 batches of 65,536 and one partial")

    def run_sketches(device, data):
        """The three sketches over ``data``; also the count-min launches each sketch's updates made."""
        sketches = (CountMinHeavyHitters(device=device), CountMinHeavyHitters(width=65536, device=device),
                    HyperLogLog(precision=14, device=device))
        sketch_launches = [0] * len(sketches)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_start = time.perf_counter()
        for x in data:
            for i, s in enumerate(sketches):
                before = launches()["countmin"]
                s.update(x)
                sketch_launches[i] += launches()["countmin"] - before
        totals = [s.compute() for s in sketches]
        if device.type == "cuda":
            torch.cuda.synchronize()
        return sketches, totals, time.perf_counter() - t_start, sketch_launches

    check(countmin_uses_shared(4, 1024, dev) and not countmin_uses_shared(4, 65536, dev),
          "the count-min branches are not shared memory at 4 x 1024 and global atomics at 4 x 65536")
    reset_launches()
    sketches, sketch_totals, sketch_s, sketch_launches = run_sketches(dev, click_batches)
    click_launches = launches()["countmin"]
    click_by_shape = registry.launches_by_shape("countmin")
    check(sum(click_by_shape.values()) == click_launches, f"countmin launches by branch and shape {click_by_shape}")
    check(click_launches == 2 * len(click_batches), f"countmin launched {click_launches} times, not {2 * len(click_batches)}")
    check(sketch_launches == [len(click_batches), len(click_batches), 0],
          f"countmin launches by sketch {sketch_launches}, not one an update of each count-min sketch")
    ids_np = clicks.cpu().numpy()
    true_counts = torch.bincount(clicks.long(), minlength=CLICK_IDS)
    top = torch.topk(true_counts, HEAVY_HITTERS)
    overestimate = {}
    for s, total in zip(sketches[:2], sketch_totals[:2]):
        check(s.value.dtype == torch.float32 and bool((s.value.sum(dim=1) == CLICKS).all()),
              f"a count-min row of width {s.width} does not sum to {CLICKS}")
        check(float(total) == CLICKS, f"count-min compute {float(total)} is not {CLICKS}")
        check(np.array_equal(s.value.cpu().numpy().astype(np.float64), numpy_countmin(ids_np, s.depth, s.width)),
              f"the count-min table of width {s.width} differs from the numpy reference")
        est = s.estimate(top.indices.float())
        check(bool((est >= top.values).all()), f"a heavy hitter is underestimated at width {s.width}")
        overestimate[s.width] = float((est - top.values).max())
    hll = sketches[2]
    distinct = int((true_counts > 0).sum())
    hll_err = float(sketch_totals[2]) / distinct - 1.0
    check(abs(hll_err) < 0.05, f"HyperLogLog estimate {float(sketch_totals[2])} is 5% or more off {distinct}")
    c_hll = HyperLogLog(precision=14, device="cpu")
    for x in click_batches:
        c_hll.update(x.cpu())
    check(torch.equal(hll.value.cpu(), c_hll.value), "HyperLogLog registers differ from the CPU run")
    print(f"click stream on the card: {len(click_batches)} batches through 3 sketches in {sketch_s * 1e3:.1f} ms; countmin "
          f"launches {click_launches}; rows sum to {CLICKS}, tables equal the numpy reference; top-{HEAVY_HITTERS} "
          f"overestimate at most {json.dumps(overestimate)}; HyperLogLog {float(sketch_totals[2]):.1f} against {distinct} "
          f"distinct ({hll_err * 100:+.3f}%), registers equal to the CPU run")
    laps.mark("3. TREC DL and click-log paths, card and CPU")

    # ---------------------------------------- 3g. slice 8: the engines (CUDA graphs)
    # Paths 1-4 again through the engines: jit_update=True metrics (one captured graph a shape bucket; the 848-row
    # batch shares the 1024 bucket of Accuracy and the count-min sketch, ConfusionMatrix and the collection get a
    # graph a shape) and the collection's fused update and forward (every member in one graph, no compute groups).
    # Each path's update epoch and a fresh metric's forward epoch must give slice 1's, 7's and 3e's results bit for
    # bit, count one dispatch a batch, launch each kernel once a member and batch (replays counted by the registry),
    # and never demote; a warm update must make no host sync.
    engine_paths = {
        "accuracy": lambda: Accuracy(num_classes=NUM_CLASSES, average="macro", jit_update=True, device=dev),
        "confmat": lambda: ConfusionMatrix(NUM_CLASSES, update_method="matmul", jit_update=True, device=dev),
        "collection": lambda: MetricCollection(collection_members(dev), prefix="val_", fused_update=True),
    }
    engine_expect = {  # (retraces, stat_scores launches, confusion_matrix launches) of an epoch
        "accuracy": (1, len(batches), 0),
        "confmat": (2, 0, len(batches)),
        "collection": (2, n_stat * len(batches), n_conf * len(batches)),
    }
    engine = {}
    engine_path_launches = {"stat_scores": 0, "confusion_matrix": 0, "countmin": 0}
    engine_by_shape = {name: {} for name in engine_path_launches}  # the replays' launches by branch and shape

    def note_engine_launches():
        for name in engine_by_shape:
            engine_path_launches[name] += launches()[name]
            engine_by_shape[name] = merged(engine_by_shape[name], registry.launches_by_shape(name))

    def engine_healthy(stats, what):
        check(stats["demotions"] == 0 and not stats["permanent"], f"{what}: the engine demoted: {stats}")

    for key, make in engine_paths.items():
        retraces, want_stat, want_conf = engine_expect[key]
        for mode in ("update", "forward"):
            m = make()
            reset_launches()
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            first_s, step_vals = None, []
            for i, (p_, t_) in enumerate(batches):
                t_call = time.perf_counter()
                if mode == "update":
                    m.update(p_, t_)
                else:
                    step_vals.append(m(p_, t_))
                if i == 0:
                    torch.cuda.synchronize()
                    first_s = time.perf_counter() - t_call  # the first call: warm-up run and capture
            out = m.compute()
            torch.cuda.synchronize()
            epoch_s = time.perf_counter() - t_start
            got = launches()
            stats = m.dispatch_stats if mode == "update" else m.forward_stats
            n_calls = stats["dispatches"] if mode == "update" else stats["launches"]
            check(n_calls == len(batches) and stats["retraces"] == retraces,
                  f"engine {key} {mode}: {n_calls} calls and {stats['retraces']} programs, not {len(batches)} and {retraces}")
            engine_healthy(m.dispatch_stats, f"engine {key} {mode}")
            engine_healthy(m.forward_stats, f"engine {key} {mode}")
            if key == "collection":
                check(not m._fuse_failed, f"the collection's fused {mode} failed for good")
            check(got["stat_scores"] == want_stat and got["confusion_matrix"] == want_conf,
                  f"engine {key} {mode} launched {got}: not {want_stat} stat_scores and {want_conf} confusion_matrix")
            check({b for b, _ in registry.launches_by_shape("stat_scores")} <= {"block"}
                  and {b for b, _ in registry.launches_by_shape("confusion_matrix")} <= {"band"},
                  f"engine {key} {mode} launched off the slice's branches")
            note_engine_launches()
            # bit-equal to the eager runs of slices 1 and 7
            if key == "accuracy":
                check(torch.equal(out, slice1_values[0]),
                      f"engine Accuracy {mode}: {out} against slice 1's {slice1_values[0]}")
                if mode == "forward":
                    check(torch.equal(step_vals[-1], slice1_batch_vals[0]), "engine Accuracy forward's last batch value")
            elif key == "confmat":
                check(torch.equal(m.confmat.long(), ref_cm) and torch.equal(out, slice1_values[1]),
                      f"engine ConfusionMatrix {mode} differs from slice 1's matrix")
                if mode == "forward":
                    check(torch.equal(step_vals[-1], slice1_batch_vals[1]),
                          "engine ConfusionMatrix forward's last batch value")
            else:
                for k, ref in coll_values.items():
                    check(out[k].dtype == ref.dtype and torch.equal(out[k], ref),
                          f"fused collection {mode}: {k} {out[k]} against slice 7's {ref}")
                if mode == "forward":
                    for k, ref in coll_batch.items():
                        check(torch.equal(step_vals[-1][k], ref), f"fused collection forward's last batch {k}")
                check(m.compute_groups == {i: [n] for i, n in enumerate(m.keys(keep_base=True))},
                      "the fused collection formed compute groups")
            engine[f"{key}_{mode}"] = {"epoch_ms": epoch_s * 1e3, "first_call_ms": first_s * 1e3, "retraces": retraces}
            if mode == "update":
                engine[f"{key}_update_metric"] = m
                # the epoch's value is the epoch's: a reset and two more updates (replays) leave it as it was
                held = {k: v.clone() for k, v in out.items()} if isinstance(out, dict) else out.clone()
                m.reset()
                for p_, t_ in batches[:2]:
                    m.update(p_, t_)
                torch.cuda.synchronize()
                kept = all(torch.equal(out[k], held[k]) for k in held) if isinstance(out, dict) else torch.equal(out, held)
                check(kept, f"engine {key}: the epoch's compute value changed under the next epoch's updates")
            elif key == "accuracy":
                # a forward value is a copy: the next step leaves it as it was
                held = step_vals[0].clone()
                m(*batches[1])
                check(torch.equal(step_vals[0], held), "an engine forward value changed under the next step")

    # path 4: the click log through CountMinHeavyHitters(jit_update=True), masked (the partial batch pads to 65,536)
    cms = CountMinHeavyHitters(jit_update=True, device=dev)
    reset_launches()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for i, x in enumerate(click_batches):
        cms.update(x)
        if i == 0:
            torch.cuda.synchronize()
            cms_first_s = time.perf_counter() - t_start
    cms_total = cms.compute()
    torch.cuda.synchronize()
    engine["countmin_update"] = {"epoch_ms": (time.perf_counter() - t_start) * 1e3, "first_call_ms": cms_first_s * 1e3,
                                 "retraces": 1}
    got = launches()
    note_engine_launches()
    check(cms.dispatch_stats["dispatches"] == len(click_batches) and cms.dispatch_stats["retraces"] == 1,
          f"engine count-min: {cms.dispatch_stats}")
    engine_healthy(cms.dispatch_stats, "engine count-min")
    check(got["countmin"] == len(click_batches) and registry.launches_by_shape("countmin") == {
        ("shared", (CLICK_BATCH, 4, 1024)): len(click_batches)}, f"engine count-min launched {got}")
    check(torch.equal(cms.value, sketches[0].value) and float(cms_total) == CLICKS,
          "the engine's count-min table differs from slice 3e's eager table")

    # scan_update: a stack of 8 batches folded as one graph, against the update loop
    stack_p = torch.stack([p_ for p_, _ in batches[:8]])
    stack_t = torch.stack([t_ for _, t_ in batches[:8]])
    scan_metric = Accuracy(num_classes=NUM_CLASSES, average="macro", device=dev)
    scanned = scan_metric.scan_update(scan_metric.default_state(), stack_p, stack_t)
    again = scan_metric.scan_update(scan_metric.default_state(), stack_p, stack_t)  # a replay
    loop = Accuracy(num_classes=NUM_CLASSES, average="macro", device=dev)
    for p_, t_ in batches[:8]:
        loop.update(p_, t_)
    for k in loop._defaults:
        check(torch.equal(scanned[k], getattr(loop, k)) and torch.equal(again[k], getattr(loop, k)),
              f"scan_update's {k} differs from the update loop")

    # timings at a full batch, in turns: the eager update against the engine's, syncs of a warm update, the capture
    # (a fresh metric's first call less a warm call), the snapshot's share (resilience off in turns) and device busy
    x_p, x_t = batches[-2]
    eager_of = {
        "accuracy": Accuracy(num_classes=NUM_CLASSES, average="macro", device=dev),
        "confmat": ConfusionMatrix(NUM_CLASSES, update_method="matmul", device=dev),
        "collection": MetricCollection(collection_members(dev), fused_update=False),
    }
    eager_of["collection"].update(x_p, x_t)  # forms the groups: the grouped eager update
    x_click = click_batches[0]
    eager_cms = CountMinHeavyHitters(device=dev)

    def without_snapshot(fn):
        def run():
            os.environ["METRICS_TPU_RESILIENCE"] = "0"
            try:
                fn()
            finally:
                del os.environ["METRICS_TPU_RESILIENCE"]
        return run

    for key in ("accuracy", "confmat", "collection", "countmin"):
        if key == "countmin":
            eng, eag, args = cms, eager_cms, (x_click,)
        else:
            eng, eag, args = engine[f"{key}_update_metric"], eager_of[key], (x_p, x_t)
        turns = host_ms_in_turns(torch, {"eager": lambda: eag.update(*args), "engine": lambda: eng.update(*args),
                                         "engine_no_snapshot": without_snapshot(lambda: eng.update(*args))})
        syncs = syncs_per_call(torch, lambda: eng.update(*args))
        check(not syncs, f"a warm engine update of {key} synchronised with the host: {syncs}")
        # the launches note_replay counts are the kernels the replays ran on the card, by name: held on the
        # program's graph, and on torch.profiler's device activities where a capture is whole (one that comes
        # back short late in a run proves nothing)
        in_graph = program_kernels(torch, eng, args)
        replayed, replay_captures = replayed_kernels(torch, lambda: eng.update(*args))
        for name, n in replayed.items():
            check(in_graph[name]["graph"] == in_graph[name]["written"] == n["per_update"]
                  and n["registry_in_window"] == n["per_update"] * n["window_updates"]
                  and n["profiler"] <= n["registry"],
                  f"three warm engine updates of {key}: the registry counted {n['registry']} {name} launches, "
                  f"the profiler recorded {n['profiler']} ({replayed}); one replay's graph holds "
                  f"{in_graph[name]['graph']} and its capture wrote down {in_graph[name]['written']}")
        row = engine.setdefault(f"{key}_update", {})
        row.update({
            "eager_update_ms": turns["eager"], "engine_update_ms": turns["engine"],
            "engine_update_no_snapshot_ms": turns["engine_no_snapshot"],
            "eager_over_engine": turns["eager"] / turns["engine"],
            "engine_syncs_per_update": len(syncs),
            "replayed_kernels_3_updates": replayed, "replay_profiler_captures": replay_captures,
            "program_kernels": in_graph,
            "eager_syncs_per_update": len(syncs_per_call(torch, lambda: eag.update(*args))),
            "engine_under_profiler": device_busy(torch, lambda: eng.update(*args)),
            "eager_under_profiler": device_busy(torch, lambda: eag.update(*args)),
        })
        if "first_call_ms" in row:
            row["capture_ms"] = row["first_call_ms"] - turns["engine"]
        engine_healthy(eng.dispatch_stats, f"engine {key} after the timings")
    fwd_m = engine_paths["accuracy"]()
    fwd_turns = host_ms_in_turns(torch, {"eager": lambda: eager_of["accuracy"](x_p, x_t),
                                         "engine": lambda: fwd_m(x_p, x_t)})
    engine["accuracy_forward"].update({"eager_forward_ms": fwd_turns["eager"], "engine_forward_ms": fwd_turns["engine"],
                                       "eager_over_engine": fwd_turns["eager"] / fwd_turns["engine"]})
    engine_healthy(fwd_m.forward_stats, "engine Accuracy forward after the timings")
    scan_ms = host_ms(torch, lambda: scan_metric.scan_update(scan_metric.default_state(), stack_p, stack_t))
    engine["accuracy_scan"] = {"batches": stack_p.shape[0], "scan_ms": scan_ms, "per_batch_ms": scan_ms / stack_p.shape[0]}
    print("slice 8, the engines: " + json.dumps(
        {k: v for k, v in engine.items() if not k.endswith("_metric")}, default=str))
    laps.mark("3. slice 8, the engines")

    # ------------------------------------- 3f. semantic segmentation, Cityscapes val
    seg_target, seg_pred, top_share = segmentation_data(torch, dev)
    laps.mark("3. segmentation data")

    def seg_batch(i, device):
        """Image ``i`` as one update gets it from a loader: int64 (1, H, W) label maps."""
        return seg_pred[i : i + 1].to(device).long(), seg_target[i : i + 1].to(device).long()

    def new_jaccard(device):
        return JaccardIndex(num_classes=SEG_CLASSES, ignore_index=SEG_VOID, update_method="matmul", device=device)

    jac = new_jaccard(dev)
    reset_launches()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for i in range(SEG_IMAGES):
        jac.update(*seg_batch(i, dev))
        if i == SEG_CPU_IMAGES - 1:
            head_confmat, head_miou = jac.confmat.clone(), jac.compute()
    seg_miou = jac.compute()
    torch.cuda.synchronize()
    seg_epoch_s = time.perf_counter() - t_start
    seg_launches = launches()["confusion_matrix"]
    seg_by_shape = registry.launches_by_shape("confusion_matrix")
    check(seg_launches == SEG_IMAGES, f"confusion_matrix launched {seg_launches} times on the segmentation path")
    check(sum(n for (b, _), n in seg_by_shape.items() if b.startswith("split")) == SEG_IMAGES,
          f"confusion_matrix launches by branch and shape on the segmentation path {seg_by_shape}: not all split")
    # the epoch's matrix against torch.bincount on the card, 50 images at a time
    seg_ref = torch.zeros(SEG_CLASSES**2, dtype=torch.int64, device=dev)
    for i in range(0, SEG_IMAGES, 50):
        flat = seg_target[i : i + 50].reshape(-1).long() * SEG_CLASSES + seg_pred[i : i + 50].reshape(-1).long()
        seg_ref += torch.bincount(flat, minlength=SEG_CLASSES**2)
    check(torch.equal(jac.confmat.long().reshape(-1), seg_ref), "the segmentation confusion matrix differs from bincount")
    c_jac = new_jaccard(cpu)
    for i in range(SEG_CPU_IMAGES):
        c_jac.update(*seg_batch(i, cpu))
    check(torch.equal(head_confmat.cpu(), c_jac.confmat),
          f"the confusion matrix of the first {SEG_CPU_IMAGES} images differs from the CPU run")
    torch.testing.assert_close(head_miou.cpu(), c_jac.compute(), rtol=1e-6, atol=0,
                               msg=f"mean IoU of the first {SEG_CPU_IMAGES} images differs from the CPU run")
    seg_np = numpy_confmat_scores(seg_ref.reshape(SEG_CLASSES, SEG_CLASSES).cpu().numpy(), ignore_index=SEG_VOID)
    np.testing.assert_allclose(float(seg_miou), seg_np["miou"], rtol=1e-5, atol=0,
                               err_msg="the segmentation mean IoU differs from float64 numpy")
    seg_update = new_jaccard(dev)
    seg_img = seg_batch(0, dev)
    seg_timing = {
        "epoch_ms": seg_epoch_s * 1e3,
        "update_ms": host_ms(torch, lambda: seg_update.update(*seg_img)),
        "syncs": syncs_per_call(torch, lambda: seg_update.update(*seg_img)),
    }
    seg_timing["syncs_per_update"] = len(seg_timing["syncs"])
    print(f"segmentation path (Cityscapes val geometry, {SEG_IMAGES} images of {SEG_H} x {SEG_W}, {SEG_CLASSES} classes, "
          f"top class share {top_share:.3f}): mean IoU {float(seg_miou):.6f} (numpy {seg_np['miou']:.6f}); confusion "
          f"matrix equal to bincount, first {SEG_CPU_IMAGES} images equal to the CPU run; confusion_matrix launches "
          f"{json.dumps(by_shape(seg_by_shape))}; {json.dumps(seg_timing)}")
    laps.mark("3. segmentation path, card and CPU")

    # ------------------------------------ 3h. slice 9: sync over torch.distributed, four ranks on the card
    # Four spawned ranks on this card in a gloo group, each a contiguous quarter of slices 7, 3 and 3e's data,
    # synced by compute. Every value against the single-process epoch of those slices: bit-equal for the
    # integer-count states (the collection eager and fused, bucketed and per-leaf; the sharded ConfusionMatrix
    # assembled; the HyperLogLog registers), rtol 1e-6 for MS MARCO, the count-min table within the up codec's
    # bound on the int8 wire and bit-equal without it; every collective counted, no degrade.
    sync_outs = run_sync_ranks()
    ref7 = {k: v.cpu().numpy() for k, v in coll_values.items()}

    def same_bits(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()

    n_sync = -(-(N_VAL // SYNC_RANKS) // BATCH)
    n_click = -(-(CLICKS // SYNC_RANKS) // CLICK_BATCH)
    true_table = sketches[0].value.cpu().numpy()
    locals_ = [o["click"]["local_table"] for o in sync_outs]
    check(np.array_equal(sum(t.astype(np.float64) for t in locals_), true_table.astype(np.float64)),
          "the ranks' count-min tables do not add up to slice 3's")
    # the up codec's bound a block of 256 cells: each rank's decoded table exceeds its own by at most its block's
    # largest count over 126 (metrics_tpu/quant.py:43-46); the sum of the ranks' bounds
    up_bound = np.repeat(np.stack([np.abs(t.reshape(-1, 256)).max(axis=1) / 126 for t in locals_]).sum(axis=0),
                         256).reshape(true_table.shape)
    sync_launches = {"stat_scores": 0, "confusion_matrix": 0, "retrieval_sort": 0, "countmin": 0}
    for r, o in enumerate(sync_outs):
        check(o["degrades"] == {} and o["degrades_start"] == {}, f"rank {r} degraded: {o['degrades']}")
        im = o["imagenet"]
        check(im["batches"] == n_sync and im["last"] == N_VAL // SYNC_RANKS - (n_sync - 1) * BATCH,
              f"rank {r} took {im['batches']} batches")
        for mode in ("eager", "fused", "per_leaf"):
            got = im[mode]["values"]
            check(got.keys() == ref7.keys(), f"rank {r} {mode}: keys {sorted(got)}")
            for key, ref in ref7.items():
                check(same_bits(got[key], ref), f"rank {r} {mode} sync: {key} differs from slice 7's single-process epoch")
        for mode in ("eager", "fused"):
            stats, issued = im[mode]["sync_stats"], im[mode]["issued"]
            check(stats["collectives"] == stats["buckets"] == sum(issued.values()) == 1
                  and im[mode]["member_collectives"] == 0,
                  f"rank {r} {mode}: the collection's sync was not one bucket pass ({stats}, issued {issued})")
            tel = im[mode]["telemetry"]  # slice 13: the compute inside a session
            check(tel["spans"] == tel["collectives"] == 1 and tel["nbytes"] == tel["bytes_on_wire"] > 0
                  and tel["sync_spans"] == 1,
                  f"rank {r} {mode}: the session's collective spans {tel} are not the sync's collectives and bytes")
        check(im["eager"]["groups"] == COLLECTION_GROUPS, f"rank {r} formed the groups {im['eager']['groups']}")
        check(im["fused"]["demotions"] == 0, f"rank {r}: the fused collection demoted")
        pl = im["per_leaf"]
        check(pl["sync_stats"] == im["eager"]["sync_stats"] and pl["member_collectives"] == sum(pl["issued"].values())
              > sum(im["eager"]["issued"].values()),
              f"rank {r} per-leaf: {pl['member_collectives']} collectives counted, issued {pl['issued']}")
        check(im["eager"]["launches"]["stat_scores"] == 6 + n_sync - 1
              and im["eager"]["launches"]["confusion_matrix"] == 4 + n_sync - 1
              and im["fused"]["launches"]["stat_scores"] == 6 * n_sync
              and im["fused"]["launches"]["confusion_matrix"] == 4 * n_sync,
              f"rank {r} kernel launches: eager {im['eager']['launches']}, fused {im['fused']['launches']}")
        a0, a1 = im["accuracy_jit0"], im["accuracy_jit1"]
        check(all(same_bits(x, y) for x, y in zip(a0["values"], a1["values"])) and same_bits(a1["values"][-1], ref7["val_Accuracy"])
              and a0["launches"] == a1["launches"] == n_sync and a1["demotions"] == 0,
              f"rank {r}: Accuracy(jit_update=True) synced {a1['values']} against eager {a0['values']} and slice 1's "
              f"{ref7['val_Accuracy']}, launches {a0['launches']}/{a1['launches']}")
        sh = im["sharded"]
        check(same_bits(sh["assembled"], ref7["val_ConfusionMatrix"])
              and sh["shard_shape"] == [NUM_CLASSES // SYNC_RANKS, NUM_CLASSES]
              and sh["sync_stats"]["sharded_buckets"] == 1 and sh["issued"] == {"reduce_scatter_tensor": 1}
              and sh["launches"] == n_sync,
              f"rank {r}: the sharded ConfusionMatrix ({sh['shard_shape']}, {sh['sync_stats']}, issued {sh['issued']})")
        s8 = im["sharded_int8"]
        check(same_bits(s8["assembled"], ref7["val_ConfusionMatrix"])
              and s8["shard_shape"] == [NUM_CLASSES // SYNC_RANKS, NUM_CLASSES]
              and s8["sync_stats"]["sharded_buckets"] == 1 and s8["issued"] == {"all_to_all_single": 1}
              and s8["sync_stats"]["bytes_on_wire"] < s8["sync_stats"]["bytes_logical"],
              f"rank {r}: the int8 sharded ConfusionMatrix ({s8['shard_shape']}, {s8['sync_stats']}, issued {s8['issued']})")
        mo = o["marco"]
        check(mo["launches"] == len(RETRIEVAL), f"rank {r}: retrieval_sort launched {mo['launches']} times")
        for key, ref in marco_values.items():
            np.testing.assert_allclose(mo["values"][key], ref.cpu().numpy(), rtol=1e-6, atol=0,
                                       err_msg=f"rank {r}: MS MARCO {key} differs from slice 3's")
        cl = o["click"]
        check(cl["batches"] == n_click and cl["launches"] == n_click, f"rank {r}: {cl['launches']} count-min launches")
        hll_ref = sketches[2].value.cpu().numpy()
        check(same_bits(cl["registers1"], hll_ref) and same_bits(cl["registers0"], hll_ref),
              f"rank {r}: the synced HyperLogLog registers differ from slice 3's")
        check(same_bits(cl["values1"]["HyperLogLog"], sketch_totals[2].cpu().numpy()),
              f"rank {r}: the synced HyperLogLog estimate differs from slice 3's")
        check(same_bits(cl["table0"], true_table), f"rank {r}: the full-precision count-min table differs from slice 3's")
        excess = cl["table1"].astype(np.float64) - true_table
        check(bool((excess >= 0).all()) and bool((excess <= up_bound * (1 + 1e-6)).all()),
              f"rank {r}: an int8 count-min cell lies outside [true, true + bound]: excess {excess.min()}..{excess.max()}")
        check(cl["wire1"]["buckets"] == 2 and sum(cl["issued1"].values()) == 2 == cl["wire1"]["collectives"],
              f"rank {r}: the sketches' sync {cl['wire1']}, issued {cl['issued1']}")
        for q in ("1", "0"):
            tel, wire = cl[f"telemetry{q}"], cl[f"wire{q}"]
            check(tel["spans"] == wire["collectives"] and tel["nbytes"] == wire["bytes_on_wire"],
                  f"rank {r}: the click log's collective spans {tel} against its sync_stats {wire} (quantised: {q})")
        for name, n in (("stat_scores", im["eager"]["launches"]["stat_scores"] + im["fused"]["launches"]["stat_scores"]
                         + a0["launches"] + a1["launches"]),
                        ("confusion_matrix", im["eager"]["launches"]["confusion_matrix"]
                         + im["fused"]["launches"]["confusion_matrix"] + sh["launches"]),
                        ("retrieval_sort", mo["launches"]), ("countmin", cl["launches"])):
            sync_launches[name] += n
    check(sum(o["marco"]["queries"] for o in sync_outs) == MARCO_QUERIES and sync_outs[-1]["marco"]["updates"] == 0,
          "the MS MARCO split is not every query, with one rank holding none")
    card = sync_outs[0]
    for path, key in (("ImageNet collection", "imagenet"), ("MS MARCO RetrievalMAP", "marco"), ("click log", "click")):
        times = [o[key]["sync_ms"] for o in sync_outs]
        print(f"slice 9, {path}, host ms by rank (compute synced fused, per_leaf; local: unsynced on this rank's "
              f"states; sync_unsync: sync and unsync alone; median of {SYNC_TURNS if key != 'marco' else 3} turns): "
              + json.dumps(times))
    im = card["imagenet"]
    print("slice 9, ImageNet on 4 ranks (rank 0): " + json.dumps({
        mode: {"sync_stats": im[mode]["sync_stats"], "issued": im[mode]["issued"],
               "member_collectives": im[mode]["member_collectives"], "launches": im[mode].get("launches")}
        for mode in ("eager", "fused", "per_leaf")})
        + f"; sharded ConfusionMatrix {json.dumps({k: v for k, v in im['sharded'].items() if k != 'assembled'})}"
        + f"; on the int8 wire {json.dumps({k: v for k, v in im['sharded_int8'].items() if k != 'assembled'})}")
    print("slice 9, MS MARCO by rank: " + json.dumps([{k: o["marco"][k] for k in ("queries", "updates", "rows", "launches",
                                                                                   "collectives", "issued")}
                                                      for o in sync_outs]))
    print("slice 9, click log (rank 0): " + json.dumps({k: card["click"][k] for k in ("wire1", "wire0", "issued1",
                                                                                      "issued0", "launches")})
          + f"; int8 table excess over the true counts at most {float((card['click']['table1'] - true_table).max())}")
    print("slice 9 kernel launches a rank: " + json.dumps([{
        "stat_scores": o["imagenet"]["eager"]["launches"]["stat_scores"] + o["imagenet"]["fused"]["launches"]["stat_scores"]
        + o["imagenet"]["accuracy_jit0"]["launches"] + o["imagenet"]["accuracy_jit1"]["launches"],
        "confusion_matrix": o["imagenet"]["eager"]["launches"]["confusion_matrix"]
        + o["imagenet"]["fused"]["launches"]["confusion_matrix"] + o["imagenet"]["sharded"]["launches"],
        "retrieval_sort": o["marco"]["launches"], "countmin": o["click"]["launches"]} for o in sync_outs]))
    print("slice 13, the four ranks' collective spans against their sync_stats: " + json.dumps([{
        "imagenet": {mode: o["imagenet"][mode]["telemetry"] for mode in ("eager", "fused")},
        "click": {q: o["click"][f"telemetry{q}"] for q in ("1", "0")}} for o in sync_outs]))
    print(f"slice 9: {SYNC_RANKS} ranks, every value equal to the single-process slices (bit-equal, MS MARCO rtol 1e-6, "
          "count-min within the up codec's bound), no degrade")
    laps.mark("3. slice 9: sync on four ranks")

    # ------------------------------------------ 3i. slice 10: curves, calibration and ranking
    slice10_launches, slice10_stat_by_shape = run_slice10(torch, dev, batches, coco_batches, marco_batches, laps)

    # ------------------------------------------ 3j. slice 11: regression and pairwise
    slice11_launches = run_slice11(torch, dev, laps)

    # ------------------------------------------ 3k. slice 12: the wrappers and the streaming windows
    slice12_launches, slice12_by_shape = run_slice12(torch, dev, laps, batches, click_batches)

    # ------------------------------------------ 3l. slice 13: observability
    slice13_launches, slice13_by_shape = run_slice13(torch, dev, laps, batches, click_batches)

    # ------------------------------------------ 3m. slice 14: the serving stack
    slice14_launches, slice14_by_shape, session_inputs = run_slice14(torch, dev, laps)

    # ------------------------------------------ 3n. slice 15: the serving fabric
    slice15_launches, slice15_by_shape, cm_session_inputs = run_slice15(torch, dev, laps)

    # ------------------------------------------ 3o. slice 16: the image metrics without a net
    run_slice16(torch, dev, laps)

    # ------------------------------------------ 3p. slice 17: the audio metrics
    run_slice17(torch, dev, laps)

    # ------------------------------------------ 3q. slice 18: the text metrics
    run_slice18(torch, dev, laps)

    # ------------------------------------------ 3r. slice 19: summaries, questions, BERTScore and detection
    run_slice19(torch, dev, laps)

    # ------------------------------------------ 3s. slice 20: the nets and their metrics
    run_slice20(torch, dev, laps)

    # ------------------------------------------ 3t. slice 21: the static audit on the card, checkpoints, cold start
    run_slice21(torch, dev, laps, sync_outs=sync_outs, build_s=build_s)

    # ----------------------------------------------------------------- 4. times
    p, t = batches[-2]  # a full batch: B = 1024, C = 1000
    n = p.shape[0]
    target_cls, pred_cls, correct, w = stat_inputs(torch, p, t)
    idx3 = torch.cat([target_cls, pred_cls + NUM_CLASSES, target_cls + 2 * NUM_CLASSES]).long()
    wts3 = torch.cat([w, w, correct.to(torch.int32)]).float()
    t32, p32 = target_cls, pred_cls
    flat = t32.long() * NUM_CLASSES + p32.long()
    for a, b in zip(stat_scores_counts(target_cls, pred_cls, correct, w, NUM_CLASSES),
                    _stat_counts_plain(target_cls, pred_cls, correct, w, NUM_CLASSES)):
        check(torch.equal(a, b), "stat_scores differs from its plain version at the slice's shape")
    check(torch.equal(confusion_matrix_counts(t32, p32, NUM_CLASSES), _confmat_plain(t32, p32, NUM_CLASSES)),
          "confusion_matrix differs from its plain version at the slice's shape")

    y_onehot = to_onehot(t, NUM_CLASSES) == 1  # the binned update's canonical target
    thr_d = _linspace_thresholds(THRESHOLDS, dev)
    for a, b in zip(_binned_stat_scores_kernel(p, y_onehot, thr_d), _binned_stat_scores_plain(p, y_onehot, thr_d)):
        check(torch.equal(a, b), "binned_stats differs from its plain version at the slice's shape")

    # retrieval_sort at the MS MARCO module compute's input; countmin at a full click batch
    rel32 = (pt > 0).to(torch.int32)
    q_rows, l_cols = pp.shape
    check(torch.equal(_sorted_by_preds_kernel(pp, rel32), _sorted_by_preds_plain(pp, rel32)),
          "retrieval_sort differs from its plain version at the MS MARCO shape")
    cm_x = click_batches[0]
    cm_depth, cm_width, cm_n = 4, 1024, cm_x.numel()
    cm_bits, cm_w, cm_seeds = _key_bits(cm_x), torch.ones_like(cm_x), sketches[0]._seeds()
    cm_value = torch.zeros(cm_depth, cm_width, device=dev)
    check(torch.equal(_countmin_kernel(cm_value, cm_bits, cm_w, cm_seeds), _countmin_plain(cm_value, cm_bits, cm_w, cm_seeds)),
          "countmin differs from its plain version at the click batch")
    cm_cols = sketches[0]._indices(cm_x)
    cm_flat = (cm_cols + torch.arange(cm_depth, device=dev)[:, None] * cm_width).reshape(-1)
    cm_w_rep = cm_w.repeat(cm_depth)
    cm_flat_table = torch.zeros(cm_depth * cm_width, device=dev)

    rows = []
    # per kernel: kernel wrapper, plain version, one library call computing the same function (or None)
    # and its name, bytes moved once, operations this batch needs, shape
    timing = {
        "stat_scores": (
            lambda: stat_scores_counts(target_cls, pred_cls, correct, w, NUM_CLASSES),
            lambda: _stat_counts_plain(target_cls, pred_cls, correct, w, NUM_CLASSES),
            lambda: torch.bincount(idx3, weights=wts3, minlength=3 * NUM_CLASSES),
            "torch.bincount weighted, 3C bins",
            n * (4 + 4 + 1 + 4) + 3 * NUM_CLASSES * 4,
            2 * n + int(correct.sum()),  # two adds a row and one a correct row
            {"B": n, "C": NUM_CLASSES},
            None,
        ),
        "confusion_matrix": (
            lambda: confusion_matrix_counts(t32, p32, NUM_CLASSES),
            lambda: _confmat_plain(t32, p32, NUM_CLASSES),
            lambda: torch.bincount(flat, minlength=NUM_CLASSES * NUM_CLASSES),
            "torch.bincount, C^2 bins",
            n * 8 + NUM_CLASSES * NUM_CLASSES * 4,
            n,  # one add a row
            {"B": n, "C": NUM_CLASSES},
            None,
        ),
        "binned_stats": (
            lambda: _binned_stat_scores_kernel(p, y_onehot, thr_d),
            lambda: _binned_stat_scores_plain(p, y_onehot, thr_d),
            None,  # no single PyTorch call computes it
            None,
            n * NUM_CLASSES * (4 + 1) + 3 * NUM_CLASSES * THRESHOLDS * 4,
            binned_ops(n, NUM_CLASSES, THRESHOLDS),
            {"B": n, "C": NUM_CLASSES, "T": THRESHOLDS},
            (lambda: searchsorted_counts(torch, p, y_onehot, thr_d), "torch.searchsorted + 2x torch.bincount + cumsum"),
        ),
        "retrieval_sort": (
            lambda: _sorted_by_preds_kernel(pp, rel32),
            lambda: _sorted_by_preds_plain(pp, rel32),
            None,  # no single PyTorch call: a sort gives the order, a gather the labels
            None,
            q_rows * l_cols * (4 + 4 + 4),
            q_rows * l_cols * math.ceil(math.log2(l_cols)),  # the compares of a comparison sort
            {"Q": q_rows, "L": l_cols},
            (lambda: torch.gather(rel32, 1, torch.argsort(-pp, dim=1, stable=True)),
             "torch.argsort(stable) + torch.gather (the plain version's two calls)"),
        ),
        "countmin": (
            lambda: _countmin_kernel(cm_value, cm_bits, cm_w, cm_seeds),
            lambda: _countmin_plain(cm_value, cm_bits, cm_w, cm_seeds),
            None,  # no single PyTorch call: the hash is several, then index_add_
            None,
            cm_n * (4 + 4) + cm_depth * 4 + 2 * cm_depth * cm_width * 4,
            cm_n * cm_depth * 11,  # the hash (9), the modulo and the add, a key and row
            {"n": cm_n, "depth": cm_depth, "width": cm_width},
            (lambda: cm_flat_table.index_add_(0, cm_flat, cm_w_rep), "index_add_ on precomputed cells (1 of 2+ calls)"),
        ),
    }
    stat_path_by_shape = merged(stat_by_shape, coll_stat_by_shape, comp_stat_by_shape, engine_by_shape["stat_scores"],
                                slice10_stat_by_shape, slice12_by_shape["stat_scores"], slice13_by_shape["stat_scores"],
                                slice14_by_shape["stat_scores"], slice15_by_shape["stat_scores"])
    click_by_shape = merged(click_by_shape, engine_by_shape["countmin"], slice12_by_shape["countmin"],
                            slice13_by_shape["countmin"], slice14_by_shape["countmin"], slice15_by_shape["countmin"])
    # slice 9's launches are the four ranks' together
    path_launches = {"stat_scores": counts["stat_scores"] + coll_launches["stat_scores"] + comp_launches["macro"]
                     + engine_path_launches["stat_scores"] + sync_launches["stat_scores"]
                     + slice10_launches["stat_scores"] + slice12_launches["stat_scores"]
                     + slice13_launches["stat_scores"] + slice14_launches["stat_scores"]
                     + slice15_launches["stat_scores"],
                     "confusion_matrix": counts["confusion_matrix"] + seg_launches + coll_launches["confusion_matrix"]
                     + engine_path_launches["confusion_matrix"] + sync_launches["confusion_matrix"]
                     + slice13_launches["confusion_matrix"],
                     "binned_stats": sum(binned_launches.values()),
                     "retrieval_sort": marco_launches + trec_launches + sync_launches["retrieval_sort"],
                     "countmin": click_launches + engine_path_launches["countmin"] + sync_launches["countmin"]
                     + slice12_launches["countmin"] + slice13_launches["countmin"] + slice14_launches["countmin"]
                     + slice15_launches["countmin"]}
    model_rows = {}
    for name, (kernel, plain, library, library_call, nbytes, ops, shape, yardstick) in timing.items():
        # the cost model's entry of this launch (slice 13): one call inside a session, its kernel event's terms;
        # its bound must be the row's
        with telemetry.instrument() as session:
            kernel()
        (event,) = session.spans(name="kernel")
        model_bytes, model_flops = event.attrs["model_bytes"], event.attrs["model_flops"]
        model_bound = bound(model_bytes, model_flops)
        check(math.isclose(model_bound[0], bound(nbytes, ops)[0], rel_tol=1e-12) and model_bound[1] == bound(nbytes, ops)[1],
              f"{name}: the cost model's entry ({model_bytes} bytes, {model_flops} flops) bounds {model_bound}, "
              f"the row {bound(nbytes, ops)}")
        model_rows[name] = {"model_bytes": model_bytes, "model_flops": model_flops, "bytes": nbytes, "ops": ops,
                            "bound_ms": model_bound[0], "bound_by": model_bound[1], "owner": event.owner}
        # plain, kernel, kernel, plain: each pair within one call, the mean of the two readings
        plain_a, kernel_a, kernel_b, plain_b = (device_ms(torch, f) for f in (plain, kernel, kernel, plain))
        library_ms = device_ms(torch, library) if library else None
        bound_ms, bound_by = bound(nbytes, ops)
        source, replaces = KERNELS[name]
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches[name], "max_abs_err": max_err[name],
            "ms": (kernel_a + kernel_b) / 2, "plain_ms": (plain_a + plain_b) / 2,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "library_call": library_call, "ops": ops, "bytes": nbytes, "shape": shape,
            "model_bytes": model_rows[name]["model_bytes"], "model_flops": model_rows[name]["model_flops"],
        }
        if yardstick:
            row["yardstick_ms"], row["yardstick_call"] = device_ms(torch, yardstick[0]), yardstick[1]
        rows.append(row)
        print(f"{name} at {shape}: kernel {kernel_a:.5f}/{kernel_b:.5f} ms, plain {plain_a:.5f}/{plain_b:.5f} ms, "
              f"library {library_ms} ms, yardstick {row.get('yardstick_ms')} ms, bound {bound_ms:.6f} ms "
              f"({bound_by}: {nbytes} bytes, {ops} operations)")
    print(f"binned_stats launches per path: {json.dumps(binned_launches)}")
    print(f"the cost model's kernel entries beside each row's bound ({torch.cuda.get_device_name(dev)}): "
          + json.dumps(model_rows))
    laps.mark("4. kernel timings at the slice's shapes")

    def launched_branch(name, fn):
        """The branch one call of ``fn`` launches, from the wrapper's own count."""
        reset_launches()
        fn()
        (branch, _), = registry.launches_by_shape(name)
        return branch

    # retrieval_sort at both launch shapes of the path, each branch beside the plain version and the
    # yardstick, in turns within this run; the all-pairs branch is the earlier design's kernel
    fq_p, fq_t = head_s[:1].contiguous(), head_t[:1].to(torch.int32)  # a functional call's (1, 1000) cells
    sort_shapes = {
        "module compute": (pp, rel32, marco_module_launches),
        "functional call": (fq_p, fq_t, marco_launches - marco_module_launches),
    }
    sort_rows = []
    for launch, (sp, st, n_launches) in sort_shapes.items():
        for all_pairs in (False, True):
            check(torch.equal(_sorted_by_preds_kernel(sp, st, all_pairs=all_pairs), _sorted_by_preds_plain(sp, st)),
                  f"retrieval_sort (all_pairs={all_pairs}) differs from its plain version at the {launch} shape")
        bitonic_a, pairs_a, pairs_b, bitonic_b = (device_ms(torch, f) for f in (
            lambda: _sorted_by_preds_kernel(sp, st), lambda: _sorted_by_preds_kernel(sp, st, all_pairs=True),
            lambda: _sorted_by_preds_kernel(sp, st, all_pairs=True), lambda: _sorted_by_preds_kernel(sp, st)))
        sq, sl = sp.shape
        s_bound, s_by = bound(sq * sl * (4 + 4 + 4), sq * sl * math.ceil(math.log2(max(sl, 2))))
        sort_rows.append({
            "launch": launch, "shape": {"Q": sq, "L": sl}, "launches": at_shape(sort_path_by_shape, (sq, sl)),
            "branch": launched_branch("retrieval_sort", lambda: _sorted_by_preds_kernel(sp, st)),
            "ms": (bitonic_a + bitonic_b) / 2, "all_pairs_ms": (pairs_a + pairs_b) / 2,
            "plain_ms": device_ms(torch, lambda: _sorted_by_preds_plain(sp, st)),
            "yardstick_ms": device_ms(torch, lambda: torch.gather(st, 1, torch.argsort(-sp, dim=1, stable=True))),
            "bound_ms": s_bound, "bound_by": s_by,
        })
    trec_shape = (TREC_QUERIES, bucket_pow2(MARCO_CANDIDATES))
    sort_rows.append({"launch": "TREC DL compute", "shape": {"Q": trec_shape[0], "L": trec_shape[1]},
                      "launches": at_shape(sort_path_by_shape, trec_shape),
                      "branch": next(b for (b, sh) in sort_path_by_shape if sh == trec_shape), "ms": None})
    # countmin at both widths of the click-log path: the shared branch at 1024, the global one at 65,536
    wide_value = torch.zeros(cm_depth, 65536, device=dev)
    wide_flat = (sketches[1]._indices(cm_x) + torch.arange(cm_depth, device=dev)[:, None] * 65536).reshape(-1)
    wide_flat_table = torch.zeros(cm_depth * 65536, device=dev)
    cm_widths = {  # each width's launches: those of its sketch's updates on the main path
        cm_width: (cm_value, cm_flat, cm_flat_table, sketch_launches[0]),
        65536: (wide_value, wide_flat, wide_flat_table, sketch_launches[1]),
    }
    cm_rows = []
    for width, (val, flat_cells, flat_table, n_launches) in cm_widths.items():
        check(torch.equal(_countmin_kernel(val, cm_bits, cm_w, cm_seeds), _countmin_plain(val, cm_bits, cm_w, cm_seeds)),
              f"countmin differs from its plain version at the click batch, width {width}")
        plain_a, kernel_a, kernel_b, plain_b = (device_ms(torch, f) for f in (
            lambda: _countmin_plain(val, cm_bits, cm_w, cm_seeds), lambda: _countmin_kernel(val, cm_bits, cm_w, cm_seeds),
            lambda: _countmin_kernel(val, cm_bits, cm_w, cm_seeds), lambda: _countmin_plain(val, cm_bits, cm_w, cm_seeds)))
        c_bound, c_by = bound(cm_n * (4 + 4) + cm_depth * 4 + 2 * cm_depth * width * 4, cm_n * cm_depth * 11)
        cm_rows.append({
            "shape": {"n": cm_n, "depth": cm_depth, "width": width},
            "launches": at_shape(click_by_shape, (cm_n, cm_depth, width)), "sketch_launches": n_launches,
            "branch": launched_branch("countmin", lambda: _countmin_kernel(val, cm_bits, cm_w, cm_seeds)),
            "ms": (kernel_a + kernel_b) / 2, "plain_ms": (plain_a + plain_b) / 2,
            "yardstick_ms": device_ms(torch, lambda: flat_table.index_add_(0, flat_cells, cm_w_rep)),
            "bound_ms": c_bound, "bound_by": c_by,
        })
    # the session axis at slice 15 B's shard flush (256 tables of 4 x 1024, 4,096 keys each): the kernel in turns with
    # its plain version, beside index_add_ on the precomputed S * depth * n cells (the plain version's last call)
    sv, sb, sw, ss = cm_session_inputs
    s_s, s_n = sb.shape
    s_depth, s_width = sv.shape[1:]
    check(torch.equal(countmin_update_sessions(sv, sb, sw, ss), _countmin_sessions_plain(sv, sb, sw, ss)),
          "countmin's session axis differs from its plain version at slice 15's flush")
    with telemetry.instrument() as session:
        countmin_update_sessions(sv, sb, sw, ss)
    (event,) = session.spans(name="kernel")
    s_cells = (hash_u32(as_u32_bits(sb)[:, None, :] ^ as_u32_bits(ss)[None, :, None]) % s_width
               + torch.arange(s_depth, device=dev)[None, :, None] * s_width
               + torch.arange(s_s, device=dev)[:, None, None] * (s_depth * s_width)).reshape(-1)
    s_wts = sw[:, None, :].expand(-1, s_depth, -1).reshape(-1).contiguous()
    s_table = torch.zeros(s_s * s_depth * s_width, device=dev)
    sk_a, sp_a, sp_b, sk_b = (device_ms(torch, f) for f in (
        lambda: countmin_update_sessions(sv, sb, sw, ss), lambda: _countmin_sessions_plain(sv, sb, sw, ss),
        lambda: _countmin_sessions_plain(sv, sb, sw, ss), lambda: countmin_update_sessions(sv, sb, sw, ss)))
    s_nbytes, s_ops = s_s * s_n * 8 + s_depth * 4 + 2 * s_s * s_depth * s_width * 4, s_s * s_n * s_depth * 11
    s_bound, s_by = bound(s_nbytes, s_ops)
    check(math.isclose(bound(event.attrs["model_bytes"], event.attrs["model_flops"])[0], s_bound, rel_tol=1e-12),
          "countmin's session axis: the cost model's entry does not give the row's bound")
    cm_rows.append({
        "launch": "fleet shard flush (session axis)", "shape": {"S": s_s, "n": s_n, "depth": s_depth, "width": s_width},
        "launches": at_shape(click_by_shape, (s_s, s_n, s_depth, s_width)),
        "branch": launched_branch("countmin", lambda: countmin_update_sessions(sv, sb, sw, ss)),
        "plan": countmin_sessions_branch(s_s, s_n, s_depth, s_width, dev),
        "ms": (sk_a + sk_b) / 2, "plain_ms": (sp_a + sp_b) / 2,
        "yardstick_ms": device_ms(torch, lambda: s_table.index_add_(0, s_cells, s_wts)),
        "yardstick_call": "index_add_ on precomputed S * depth * n cells", "bound_ms": s_bound, "bound_by": s_by,
        "bytes": s_nbytes, "ops": s_ops, "model_bytes": event.attrs["model_bytes"],
        "model_flops": event.attrs["model_flops"],
    })
    laps.mark("4. retrieval_sort and countmin at each shape")

    # stat_scores and binned_stats at each shape of their paths, each branch beside the plain version and
    # the library call or yardstick, in turns within this run; the multi-block and compare branches are
    # the earlier designs' kernels. bench.py's headline shape is off the path. Each row's launches are
    # those the wrapper counted at its shape on the main path, and its branch the one the timed call took.
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    hp = torch.rand(BATCH, HEADLINE_CLASSES, generator=g, device=dev)
    ht = torch.randint(0, HEADLINE_CLASSES, (BATCH,), generator=g, device=dev)
    h_inputs = stat_inputs(torch, hp, ht)
    stat_shapes = {"ImageNet batch": (stat_inputs(torch, p, t), NUM_CLASSES), "bench.py headline": (h_inputs, HEADLINE_CLASSES)}
    stat_rows = []
    for launch, (inputs, c) in stat_shapes.items():
        sn = inputs[0].shape[0]
        ref = _stat_counts_plain(*inputs, c)
        for branch in ("block", "shared"):
            check(all(torch.equal(a, b) for a, b in zip(_stat_counts_kernel(*inputs, c, branch=branch), ref)),
                  f"stat_scores ({branch}) differs from its plain version at the {launch} shape")
        block_a, multi_a, multi_b, block_b = (device_ms(torch, f) for f in (
            lambda: _stat_counts_kernel(*inputs, c, branch="block"), lambda: _stat_counts_kernel(*inputs, c, branch="shared"),
            lambda: _stat_counts_kernel(*inputs, c, branch="shared"), lambda: _stat_counts_kernel(*inputs, c, branch="block")))
        s_idx3 = torch.cat([inputs[0], inputs[1] + c, inputs[0] + 2 * c]).long()
        s_wts3 = torch.cat([inputs[3], inputs[3], inputs[2].to(torch.int32)]).float()
        s_bound, s_by = bound(sn * (4 + 4 + 1 + 4) + 3 * c * 4, 2 * sn + int(inputs[2].sum()))
        stat_rows.append({
            "launch": launch, "shape": {"B": sn, "C": c}, "launches": at_shape(stat_path_by_shape, (sn, c)),
            "branch": launched_branch("stat_scores", lambda: stat_scores_counts(*inputs, c)),
            "ms": (block_a + block_b) / 2, "multi_block_ms": (multi_a + multi_b) / 2,
            "plain_ms": device_ms(torch, lambda: _stat_counts_plain(*inputs, c)),
            "library_ms": device_ms(torch, lambda: torch.bincount(s_idx3, weights=s_wts3, minlength=3 * c)),
            "bound_ms": s_bound, "bound_by": s_by,
        })
    # the session axis at slice 14's ImageNet flush (1,024 sessions of 64 rows): the kernel in turns with its plain
    # version, beside one weighted torch.bincount over the S * 3C cells (the same function, not used by the port)
    sess_s, sess_b = session_inputs[0].shape
    sess_ref = _stat_counts_sessions_plain(*session_inputs, NUM_CLASSES)
    check(torch.equal(stat_scores_counts_sessions(*session_inputs, NUM_CLASSES), sess_ref),
          "stat_scores' session axis differs from its plain version at slice 14's flush")
    sess_kernel_a, sess_plain_a, sess_plain_b, sess_kernel_b = (device_ms(torch, f) for f in (
        lambda: stat_scores_counts_sessions(*session_inputs, NUM_CLASSES),
        lambda: _stat_counts_sessions_plain(*session_inputs, NUM_CLASSES),
        lambda: _stat_counts_sessions_plain(*session_inputs, NUM_CLASSES),
        lambda: stat_scores_counts_sessions(*session_inputs, NUM_CLASSES)))
    st_t, st_p, st_c, st_w = session_inputs
    sess_cells = (torch.arange(sess_s, device=dev)[:, None] * 3 * NUM_CLASSES
                  + torch.cat([st_t, st_p + NUM_CLASSES, st_t + 2 * NUM_CLASSES], dim=1)).reshape(-1).long()
    sess_wts = torch.cat([st_w, st_w, st_c.to(torch.int32)], dim=1).reshape(-1).float()
    sess_bound, sess_by = bound(sess_s * sess_b * (4 + 4 + 1 + 4) + sess_s * 3 * NUM_CLASSES * 4,
                                2 * sess_s * sess_b + int(st_c.sum()))
    stat_rows.append({
        "launch": "service flush (session axis)", "shape": {"S": sess_s, "B": sess_b, "C": NUM_CLASSES},
        "launches": at_shape(stat_path_by_shape, (sess_s, sess_b, NUM_CLASSES)),
        "branch": launched_branch("stat_scores", lambda: stat_scores_counts_sessions(*session_inputs, NUM_CLASSES)),
        "plan": stat_scores_sessions_branch(sess_s, sess_b, NUM_CLASSES, dev),
        "ms": (sess_kernel_a + sess_kernel_b) / 2, "plain_ms": (sess_plain_a + sess_plain_b) / 2,
        "library_ms": device_ms(torch, lambda: torch.bincount(sess_cells, weights=sess_wts,
                                                              minlength=sess_s * 3 * NUM_CLASSES)),
        "library_call": "torch.bincount weighted, S * 3C bins", "bound_ms": sess_bound, "bound_by": sess_by,
    })
    # the one-block limit: both branches in turns at batches around it, C = 1000
    one_block_sweep = []
    for sn in (2048, 4096, 6144, 8192, 12288, 16384):
        inputs = stat_inputs(torch, scores[:sn], labels[:sn])
        block_a, multi_a, multi_b, block_b = (device_ms(torch, f) for f in (
            lambda: _stat_counts_kernel(*inputs, NUM_CLASSES, branch="block"),
            lambda: _stat_counts_kernel(*inputs, NUM_CLASSES, branch="shared"),
            lambda: _stat_counts_kernel(*inputs, NUM_CLASSES, branch="shared"),
            lambda: _stat_counts_kernel(*inputs, NUM_CLASSES, branch="block")))
        one_block_sweep.append({"B": sn, "plan": stat_scores_branch(sn, NUM_CLASSES, dev),
                                "block_ms": (block_a + block_b) / 2, "multi_block_ms": (multi_a + multi_b) / 2})
    print(f"stat_scores one block against many blocks at C = {NUM_CLASSES} (one-block limit {_ONE_BLOCK_ROWS} rows): "
          + json.dumps(one_block_sweep))
    laps.mark("4. stat_scores branches")
    # confusion_matrix at both path shapes: the plan's launch in turns with the earlier design (a zeroed output
    # plus integer atomics, the same run), beside the other branch, the plain version, torch.bincount over C^2
    # bins and the bound; launches by branch and shape as the wrapper counted them on the main paths. Three
    # calls at each shape must be three device kernels and no memset or fill: held on a CUDA graph of the
    # calls and the host's operators, and on torch.profiler's device activities where a capture is whole.
    seg_t32, seg_p32 = (x[0].reshape(-1).to(torch.int32) for x in (seg_target, seg_pred))
    confmat_shapes = {
        "ImageNet batch": (t32, p32, NUM_CLASSES,
                           merged(confmat_slice_by_shape, coll_confmat_by_shape, engine_by_shape["confusion_matrix"],
                                  slice13_by_shape["confusion_matrix"])),
        "Cityscapes image": (seg_t32, seg_p32, SEG_CLASSES, seg_by_shape),
    }
    confmat_path_by_shape = merged(confmat_slice_by_shape, seg_by_shape, coll_confmat_by_shape,
                                   engine_by_shape["confusion_matrix"], slice13_by_shape["confusion_matrix"])
    confmat_rows = []
    for launch, (ct, cp, c, path_by_shape) in confmat_shapes.items():
        cn = ct.shape[0]
        ref = _confmat_plain(ct, cp, c)
        other = "split" if confusion_plan(cn, c, *registry.device_limits(dev, confusion_lib(), "confusion"))[0] == "band" \
            else "band"
        other_fits = other == "band" or split_shared_bytes(c) <= confmat_optin
        runs = {"the plan": lambda: confusion_matrix_counts(ct, cp, c), "the earlier design": lambda: confmat_earlier(ct, cp, c)}
        if other_fits:
            runs[other] = lambda: _confmat_kernel(ct, cp, c, branch=other)
        for what, run in runs.items():
            check(torch.equal(run(), ref), f"confusion_matrix ({what}) differs from its plain version at the {launch} shape")
        # the activities five captures of three calls recorded, in each way of taking them, and each kernel's
        # start less its launch call's (µs) in the captures taken as device_kernels takes them
        capture_ways = {"warm_up_and_padding": dict(), "warm_up_only": dict(pad_s=0.0),
                        "bare": dict(warmup=False, pad_s=0.0)}
        captured = {way: [profiled(torch, lambda: confusion_matrix_counts(ct, cp, c), 3, **kw)
                          for _ in range(5)] for way, kw in capture_ways.items()}
        capture_check = {way: [len(a) for a, _, _ in caps] for way, caps in captured.items()}
        capture_check["kernel_less_launch_us"] = [lag for _, _, lag in captured["warm_up_and_padding"]]
        print(f"profiler captures at the {launch} shape: " + json.dumps(capture_check))
        # what three calls hand the card, from a CUDA graph they are captured into: one kernel node each, of one
        # kernel, and else only the tickets a capture zeroes by design for a split launch on several blocks
        # (ops/confusion.py::_ticket; an eager launch reuses its stream's ticket); and no tensor filled on the
        # host's side of an eager call
        nodes, written = graph_launches(torch, lambda: confusion_matrix_counts(ct, cp, c))
        graph_kernels = [n for kind, n in nodes if kind == "kernel" and any(
            d in n for d in DEVICE_KERNELS["confusion_matrix"])]
        rest = [(kind, n) for kind, n in nodes if kind != "kernel" or n not in graph_kernels]
        tickets = 3 if confusion_branch(cn, c, dev).startswith("split, ") else 0
        check(len(graph_kernels) == 3 and len(set(graph_kernels)) == 1 and written == ["confusion_matrix"] * 3
              and len(rest) == tickets and all(kind == "memset" or "fill" in (n or "").lower() for kind, n in rest),
              f"three confusion_matrix calls at the {launch} shape, captured, gave the card {nodes} (launches written "
              f"down: {written}), not one kernel each and else only {tickets} ticket fills")
        eager_ops = host_ops(torch, lambda: confusion_matrix_counts(ct, cp, c))
        filled = sorted({o for o in eager_ops if any(w in o.lower() for w in ("fill", "zero", "memset"))})
        check(not filled, f"three eager confusion_matrix calls at the {launch} shape filled a tensor: {filled}")
        # the profiler's device activities of three eager calls: a capture can come back short late in a run
        # (device_kernels), so a short one proves nothing, and a whole one must show the same
        activities, captures = device_kernels(torch, lambda: confusion_matrix_counts(ct, cp, c), "confusion_matrix")
        check(len(activities) < 3 or (len(activities) == 3 and len(set(activities)) == 1
              and not any(w in a.lower() for a in activities for w in ("memset", "fill"))),
              f"three confusion_matrix calls at the {launch} shape made {activities}, not one kernel each and no "
              "memset or fill")
        new_a, old_a, old_b, new_b = (device_ms(torch, f) for f in (
            lambda: confusion_matrix_counts(ct, cp, c), lambda: confmat_earlier(ct, cp, c),
            lambda: confmat_earlier(ct, cp, c), lambda: confusion_matrix_counts(ct, cp, c)))
        c_flat = ct.long() * c + cp.long()
        c_bound, c_by = bound(cn * 8 + c * c * 4, cn)
        confmat_rows.append({
            "launch": launch, "shape": {"n": cn, "C": c}, "launches": at_shape(path_by_shape, (cn, c)),
            "branch": launched_branch("confusion_matrix", lambda: confusion_matrix_counts(ct, cp, c)),
            "ms": (new_a + new_b) / 2, "earlier_design_ms": (old_a + old_b) / 2,
            "other_branch": other, "other_branch_ms": device_ms(torch, lambda: _confmat_kernel(ct, cp, c, branch=other))
            if other_fits else None,
            "plain_ms": device_ms(torch, lambda: _confmat_plain(ct, cp, c)),
            "library_ms": device_ms(torch, lambda: torch.bincount(c_flat, minlength=c * c)),
            "library_call": "torch.bincount, C^2 bins", "bound_ms": c_bound, "bound_by": c_by,
            "graph_nodes_3_calls": nodes, "host_ops_3_calls": sorted(set(eager_ops)),
            "device_activities_3_calls": activities, "profiler_captures": captures,
            "profiler_capture_ways": capture_check,
            "launches_by_shape": by_shape(path_by_shape),
        })
    # where the branches cross: the band, and the split on 1, 8, 32 and 128 blocks and on the plan's count,
    # over C = 20 to 240 and 1,024 to 2,097,152 rows (labels right on 90% of rows)
    confmat_sweep = []
    for c in CONFMAT_SWEEP_CLASSES:
        for cn in CONFMAT_SWEEP_ROWS:
            ct = torch.randint(0, c, (cn,), generator=g, device=dev, dtype=torch.int32)
            cp = torch.where(torch.rand(cn, generator=g, device=dev) < 0.9, ct,
                             torch.randint(0, c, (cn,), generator=g, device=dev, dtype=torch.int32)).to(torch.int32)
            plan = confusion_plan(cn, c, *registry.device_limits(dev, confusion_lib(), "confusion"))
            point = {"C": c, "n": cn, "plan": confusion_branch(cn, c, dev),
                     "band_ms": device_ms(torch, lambda: _confmat_kernel(ct, cp, c, branch="band"), reps=5)}
            for blocks in sorted({1, 8, 32, 128} | ({plan[1]} if plan[0] == "split" else set())):
                if blocks == 1 or cn >= blocks * 1024:
                    point[f"split_{blocks}_ms"] = device_ms(
                        torch, lambda: _confmat_kernel(ct, cp, c, branch="split", blocks=blocks), reps=5)
            confmat_sweep.append(point)
    print(f"confusion_matrix by launch shape: {json.dumps(confmat_rows)}; branches against the rows and classes "
          f"(the split on 1 to 128 blocks): {json.dumps(confmat_sweep)}")
    laps.mark("4. confusion_matrix branches and earlier design")
    # binned_stats at both path shapes, and at COCO's width in batches of 4,096 and in one update of the whole
    # validation set (40,504 rows), where the plan splits each tile's rows over a cluster; the earlier design
    # (compare) needs its zeroed scratch and a second kernel. The plan's cluster size is timed in turns against
    # the other choice: clusters of 8 where the plan takes one block a tile, one block a tile where it clusters.
    cp0, ct0 = coco_batches[0]
    coco_y = (coco_target == 1).contiguous()
    binned_shapes = {
        "ImageNet batch": (p, y_onehot),
        "COCO batch": (cp0, (ct0 == 1).contiguous()),
        "COCO, batch of 4,096": (coco_scores[:4096], coco_y[:4096]),
        "COCO val in one update": (coco_scores, coco_y),
    }
    binned_path_by_shape = {}  # both binned paths' launches per (branch, shape)
    for path_by_shape in binned_by_shape.values():
        for key, count in path_by_shape.items():
            binned_path_by_shape[key] = binned_path_by_shape.get(key, 0) + count
    binned_rows = []
    for launch, (bp, by) in binned_shapes.items():
        bn, bc = bp.shape
        ref = _binned_stat_scores_plain(bp, by, thr_d)
        branch, cluster, wide = binned_branch(bn, bc, THRESHOLDS, dev)
        other = 8 if cluster == 1 else 1
        for kwargs in ({}, {"compare": True}, {"cluster": other}):
            check(all(torch.equal(a, b) for a, b in zip(_binned_stat_scores_kernel(bp, by, thr_d, **kwargs), ref)),
                  f"binned_stats ({kwargs}) differs from its plain version at the {launch} shape")
        hist_a, cmp_a, cmp_b, hist_b = (device_ms(torch, f) for f in (
            lambda: _binned_stat_scores_kernel(bp, by, thr_d), lambda: _binned_stat_scores_kernel(bp, by, thr_d, compare=True),
            lambda: _binned_stat_scores_kernel(bp, by, thr_d, compare=True), lambda: _binned_stat_scores_kernel(bp, by, thr_d)))
        plan_a, other_a, other_b, plan_b = (device_ms(torch, f) for f in (
            lambda: _binned_stat_scores_kernel(bp, by, thr_d), lambda: _binned_stat_scores_kernel(bp, by, thr_d, cluster=other),
            lambda: _binned_stat_scores_kernel(bp, by, thr_d, cluster=other), lambda: _binned_stat_scores_kernel(bp, by, thr_d)))
        b_bound, b_by = bound(bn * bc * (4 + 1) + 3 * bc * THRESHOLDS * 4, binned_ops(bn, bc, THRESHOLDS))
        binned_rows.append({
            "launch": launch, "shape": {"B": bn, "C": bc, "T": THRESHOLDS},
            "launches": at_shape(binned_path_by_shape, (bn, bc, THRESHOLDS)),
            "branch": launched_branch("binned_stats", lambda: binned_stat_scores(bp, by, thr_d)),
            "ms": (hist_a + hist_b) / 2, "compare_ms": (cmp_a + cmp_b) / 2,
            "plan_ms": (plan_a + plan_b) / 2, "other_cluster": other, "other_cluster_ms": (other_a + other_b) / 2,
            "plain_ms": device_ms(torch, lambda: _binned_stat_scores_plain(bp, by, thr_d)),
            "yardstick_ms": device_ms(torch, lambda: searchsorted_counts(torch, bp, by, thr_d)),
            "bound_ms": b_bound, "bound_by": b_by,
        })
    laps.mark("4. binned_stats branches and clusters")
    for row in rows:
        if row["name"] == "stat_scores":
            row.update(branch=stat_rows[0]["branch"], timings=stat_rows, one_block_sweep=one_block_sweep,
                       launches_by_shape=by_shape(stat_path_by_shape))
        if row["name"] == "confusion_matrix":
            row.update(branch=confmat_rows[0]["branch"], timings=confmat_rows, crossover=confmat_sweep,
                       launches_by_shape=by_shape(confmat_path_by_shape))
        if row["name"] == "binned_stats":
            row.update(branch=binned_rows[0]["branch"], timings=binned_rows, launches_by_shape=by_shape(binned_path_by_shape))
        if row["name"] == "retrieval_sort":
            row.update(branch=sort_rows[0]["branch"], timings=sort_rows, launches_by_shape=by_shape(sort_path_by_shape))
        if row["name"] == "countmin":
            row.update(branch=cm_rows[0]["branch"], timings=cm_rows, launches_by_shape=by_shape(click_by_shape))
    print("stat_scores by launch shape and branch: " + json.dumps(stat_rows))
    print("binned_stats by launch shape and branch: " + json.dumps(binned_rows))
    print("retrieval_sort by launch shape and branch: " + json.dumps(sort_rows))
    print("countmin by width and branch: " + json.dumps(cm_rows))

    upd_acc = Accuracy(num_classes=NUM_CLASSES, average="macro", device=dev)
    upd_cm = ConfusionMatrix(num_classes=NUM_CLASSES, update_method="matmul", device=dev)
    updates = {
        "accuracy_update_ms": host_ms(torch, lambda: upd_acc.update(p, t)),
        "confmat_update_ms": host_ms(torch, lambda: upd_cm.update(p, t)),
        "confmat_canonicalize_ms": host_ms(torch, lambda: _canonicalize_confmat_labels(p, t, NUM_CLASSES, 0.5)),
        "accuracy_syncs": syncs_per_call(torch, lambda: upd_acc.update(p, t)),
        "confmat_syncs": syncs_per_call(torch, lambda: upd_cm.update(p, t)),
    }
    for label in ("accuracy", "confmat"):
        updates[f"{label}_syncs_per_update"] = len(updates[f"{label}_syncs"])
    print("updates at B=1024 C=1000: " + json.dumps(updates))
    for label, fn in (("accuracy", lambda: upd_acc.update(p, t)), ("confmat", lambda: upd_cm.update(p, t))):
        print(f"{label} update under torch.profiler: " + json.dumps(device_busy(torch, fn)))
    warm_s = run_slice(dev, batches)[-1]
    print(f"slice on the card, warm: 49 batches in {warm_s * 1e3:.3f} ms")

    cp, ct = coco_batches[0]
    upd_ap = BinnedAveragePrecision(num_classes=NUM_CLASSES, thresholds=THRESHOLDS, device=dev)
    upd_rap = BinnedRecallAtFixedPrecision(
        num_classes=NUM_CLASSES, min_precision=MIN_PRECISION, thresholds=THRESHOLDS, device=dev
    )
    upd_coco = BinnedAveragePrecision(num_classes=COCO_CLASSES, thresholds=THRESHOLDS, device=dev)
    binned_updates = {
        "imagenet_ap_update_ms": (upd_ap, p, t),
        "imagenet_rap_update_ms": (upd_rap, p, t),
        "coco_ap_update_ms": (upd_coco, cp, ct),
    }
    binned = {}
    for label, (m, bp, bt) in binned_updates.items():
        binned[label] = host_ms(torch, lambda: m.update(bp, bt))
        binned[label.replace("update_ms", "compute_ms")] = host_ms(torch, m._compute_impl)
        syncs = syncs_per_call(torch, lambda: m.update(bp, bt))
        binned[label.replace("update_ms", "syncs_per_update")] = len(syncs)
        binned[label.replace("update_ms", "syncs")] = syncs
    print("binned updates (B=1024, T=100) and computes: " + json.dumps(binned))
    print("ImageNet BinnedAveragePrecision update under torch.profiler: "
          + json.dumps(device_busy(torch, lambda: upd_ap.update(p, t))))
    warm = {"imagenet_ms": run_imagenet_binned(dev, batches)[-1] * 1e3, "coco_ms": run_coco_binned(dev, coco_batches)[-1] * 1e3}
    print("binned paths on the card, warm: " + json.dumps(warm))

    mp, mt, mi = marco_batches[0]
    upd_map = metrics_tpu_torch.RetrievalMAP(device=dev)
    retrieval = {
        "map_update_ms": host_ms(torch, lambda: upd_map.update(mp, mt, mi)),
        "map_update_syncs": syncs_per_call(torch, lambda: upd_map.update(mp, mt, mi)),
        "pad_by_query_ms": host_ms(torch, lambda: _pad_by_query(*state)),
        "pad_by_query_syncs": syncs_per_call(torch, lambda: _pad_by_query(*state)),
    }
    for key, m in marco.items():
        retrieval[f"{key}_compute_ms"] = host_ms(torch, m._compute_impl)
        retrieval[f"{key}_compute_syncs"] = len(syncs_per_call(torch, m._compute_impl))
    print(f"retrieval at (Q, L) = ({q_rows}, {l_cols}), updates of {mp.numel()} rows: " + json.dumps(retrieval))
    print("RetrievalMAP compute under torch.profiler: "
          + json.dumps(device_busy(torch, marco["map"]._compute_impl, steps=5)))
    warm_marco = run_marco(dev, marco_batches)
    print(f"MS MARCO path on the card, warm: updates {warm_marco[2] * 1e3:.1f} ms, epoch {warm_marco[4] * 1e3:.1f} ms")

    upd_cm1, upd_cm64, upd_hll = (CountMinHeavyHitters(device=dev), CountMinHeavyHitters(width=65536, device=dev),
                                  HyperLogLog(precision=14, device=dev))
    streaming = {
        "countmin_update_ms": host_ms(torch, lambda: upd_cm1.update(cm_x)),
        "countmin_update_syncs": syncs_per_call(torch, lambda: upd_cm1.update(cm_x)),
        "countmin_65536_update_ms": host_ms(torch, lambda: upd_cm64.update(cm_x)),
        "hyperloglog_update_ms": host_ms(torch, lambda: upd_hll.update(cm_x)),
    }
    print(f"sketch updates of {cm_n} keys: " + json.dumps(streaming))
    print("CountMinHeavyHitters update under torch.profiler: " + json.dumps(device_busy(torch, lambda: upd_cm1.update(cm_x))))
    print(f"click stream on the card, warm: {run_sketches(dev, click_batches)[2] * 1e3:.1f} ms")

    h_acc = Accuracy(num_classes=HEADLINE_CLASSES, average="macro", device=dev)
    headline = {
        "shape": {"B": BATCH, "C": HEADLINE_CLASSES},
        "accuracy_update_ms": host_ms(torch, lambda: h_acc.update(hp, ht)),
        "stat_scores_kernel_ms": device_ms(torch, lambda: stat_scores_counts(*h_inputs, HEADLINE_CLASSES)),
    }
    print("bench.py headline shape: " + json.dumps(headline))

    laps.mark("4. updates, computes and warm epochs")
    slice13_profiler_ranges(torch, dev, batches)
    laps.mark("4. slice 13 profiler ranges")
    print(f"command time by part (s), {sum(laps.s.values()):.1f} in all after nvidia-smi: " + json.dumps(laps.s))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--slice14-worker"]:  # one process of slice 14's crash matrix (run_slice14)
        sys.exit(slice14_worker(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--slice15-worker"]:  # one shard process of slice 15's crash matrix (run_slice15)
        sys.exit(slice15_worker(*sys.argv[2:7]))
    sys.exit(main())
