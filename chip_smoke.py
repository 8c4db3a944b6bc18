"""Chip smoke test of the PyTorch/CUDA port (``alink_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX or ``alink_tpu``. Phases, any failure exits
non-zero:

1. environment: card name and power limit (nvidia-smi), torch and CUDA;
2. build: every kernel of the port from ``alink_tpu_torch/csrc`` into
   ``build/kernels``;
3. kernel vs plain version on the card: ``flash_block_update`` (one block
   through the fused kernel with nb = 1) against ``flash_block_update_ref``
   at the serving shape (B=32, H=12, Q=512, K=128, D=64) in bf16 and fp32,
   with a fully masked batch row, a causal ``qk_ok`` and a ragged K=100,
   each from an empty state (the first K/V block) and from a carried one
   (every later block); then ``blockwise_attention`` on the kernel route
   (``flash_blockwise``, one launch per call) against its plain route
   (``ALINK_ATTN_PALLAS=0``) at (B, H, D) = (32, 12, 64), blocks of 128, in
   bf16 and fp32: S = 512; S = 512 causal; a ragged S = 500; the last two on
   q/k/v taken as ``unbind`` views of one (B, S, 3, H, D) tensor, as the main
   path hands them over (every case has a fully masked batch row); the fused
   call timed beside its bound and the plain route in turns, one block
   update timed, and ``scaled_dot_product_attention`` over the whole
   512-key attention as a labelled yardstick (the port never calls it);
4. main path: BERT-base at full width (hidden 768, 12 layers, 12 heads,
   vocab 30522, maxSeqLength 512, attentionBlockSize 128, mean pool, 2
   labels) with seeded random weights in the reference's flax layout (q/k
   weights drawn so that attention scores spread about one unit, so the
   logits depend on the attention), encoded with the port's codec into a
   model table, written to ``.ak``, read back, and served to 4 requests of
   1, 8, 32 and 64 rows through ``AkSourceBatchOp`` + ``TableSourceBatchOp``
   → ``BertTextClassifierPredictBatchOp`` → ``collect()``; the kernel's
   launch counter must rise by 12 per forward chunk (one launch per layer),
   and the logits must
   agree with the same model run with plain attention and with full
   attention; the warm forward is timed on all three attention routes;
5. tree histogram vs plain version on the card: the fused level call
   ``level_histograms`` (one launch of ``tree_histogram`` for the level's
   g, h and count histograms, ids built in the kernel from the uint8 bins)
   against ``level_histograms_ref`` at n = 522,911 rows of Covertype-layout
   bins (10 continuous and 44 binary columns) at every level of a depth-12
   tree (L = 1 … 2,048 nodes, S = 64 … 131,072) on evenly spread nodes,
   with the forest's channels (integer g and counts, h the same tensor as
   c) and real ones (normal, g, counts: h != c), plus nodes at -1 and in
   [L, L+8) and bins in [64, 256) at L = 1, 64 and 2,048; each level timed
   (device time in CUDA graphs) beside its bound, the plain version and one
   ``index_add_`` over the flat cell index as a labelled yardstick (the
   port never calls it); then wide tables, more than one of the kernel's
   feature blocks: d = 300 and 784 on 60,000 rows of MNIST-layout bins
   (see ``mnist_layout``) at L = 1, 64 and 2,048, with the same channels
   and out-of-range cases, timed at L = 64;
6. forest path: seeded Covertype-layout data (sklearn's
   bench_covertype.py shape: 522,911 training and 58,101 held-out rows, 54
   features, class 1 against the rest) through ``TableSourceBatchOp`` →
   ``RandomForestTrainBatchOp(numTrees=20, maxDepth=12, maxBins=64,
   minSamplesPerLeaf=5)`` → ``collect()``; the kernel's launch counter must
   rise by 12·20 = 240, one per level (each level call timed with CUDA
   events), the first tree's 12 level calls are held against the plain
   version again and timed on their own inputs (the numbers of the kernels
   line); then the training walls in turns, plain
   (``ALINK_GBDT_PALLAS=0``), kernel, kernel, plain, none instrumented,
   each kernel run 240 launches and every run the same trees; the
   card's predict must match a numpy traversal, and
   the model goes to ``.ak`` and back into ``RandomForestPredictBatchOp``
   for requests of 1, 1,000 and 58,101 held-out rows; held-out accuracy
   must beat the majority class by 0.05; then a forest of 4 trees (depth
   10) on 60,000 MNIST-layout rows of 784 columns, one launch a level,
   timed in the same turns, must grow the plain route's trees;
7. GBDT path: ``GbdtTrainBatchOp(numTrees=20, maxDepth=6, maxBins=64)`` on
   the same data, then ``GbdtPredictBatchOp`` on the held-out requests,
   under the same accuracy floor;
8. SGNS gradients vs plain versions on the card: the gathered-rows entry
   ``sgns_block_grads`` against ``sgns_block_grads_ref`` at (B, negs, D) =
   (1024, 5, 100) (the main path's), (1000, 1, 37) and (1000, 15, 100), on
   the pulled rows of the 300th step of a plain-route training on a quarter
   of the corpus (realistic magnitudes) and on seeded N(0, 1) rows
   (saturated sigmoids); the fused entry ``sgns_pull_grads`` (the APS pull
   and the gradients in one launch) against ``sgns_pull_grads_ref`` on that
   step's tables and ids at the main path's shape, with 2 % sentinel and 2 %
   duplicated ids, the hot cache on (replicas that differ from the tables'
   prefix), off, and on one tied table, hits equal; both entries timed in a
   CUDA graph beside their bounds; then both entries at row widths D = 1100
   and 2048, past the kernel's register-held rows (``check_sgns_wide``);
9. Word2Vec path: 1,000,000 tokens in text8's layout (the corpus of
   word2vec's demo-word.sh: Zipf law over 71,290 types, sentences of 1,000
   tokens, a topic per sentence; see ``text8_corpus``) through
   ``TableSourceBatchOp`` → ``Word2VecTrainBatchOp`` (the op's defaults:
   vectorSize 100, window 5, negative 5, numIter 3, batchSize 1024; minCount
   1) → ``collect()``; the kernel's launch counter must rise by the step
   count (one fused launch per step), the table must agree with the
   ``ALINK_SGNS_PALLAS=0`` route's, the embedding must pass a learning gate
   on the topics, the steps/s and the device operations a step (both
   routes, ``torch.profiler``) are reported, and the model goes to ``.ak``
   and back into ``Word2VecPredictBatchOp`` for requests of 1, 1,000 and
   10,000 sentences, checked against a numpy mean of the table's rows;
10. BERT training: (10.1) ``blockwise_attention``'s kernel route forward
    and backward (the autograd Function around ``flash_blockwise``, whose
    backward is ``flash_blockwise_bwd`` in plain PyTorch) against the plain
    route's autograd at (32, 512, 12, 64), blocks of 128, bf16 and fp32, on
    phase 3's fused cases, with a seeded cotangent; forward + backward and
    backward alone timed on both routes, and SDPA's forward + backward as a
    labelled yardstick; (10.2) bench.py's configuration of the metric of
    record (``bench_bert``: BERT-base, 2 labels, dropout 0, bf16 compute
    with fp32 parameters, seq 128, batch 32, full attention, AdamW at a
    constant 2e-5 with weight decay 0.01, ids and labels from
    ``np.random.RandomState(0)``) through the port's one-step function
    (``make_train_step``): 3 warm-up and 3 × 10 timed steps, samples/s, ms a
    step, peak memory, MFU (see ``train_step_flops``) and the device time
    by kernel group; the loss must be finite and fall over the 33 steps;
    (10.3) the same model with attentionBlockSize 128 at seq 512: 5 steps,
    12 flash launches a step, losses within LOSS_ROUTE_ATOL of 5 plain-route
    steps from the same weights; (10.4) ``BertTextClassifierTrainBatchOp``
    on data/sst2_mini.csv from data/bert_tiny_sst and from scratch, the
    holdout through ``BertTextClassifierPredictBatchOp``: the pretrained
    run must reach SST2_FLOOR, and predict identically after ``.ak``;
11. the classical BSP path, which launches none of the port's kernels
    (``CLASSICAL_CASES``): (11.1) BASELINE #1 as bench.py:246-279 runs it,
    ``Pipeline(KMeans(k=3, maxIter=50))`` fit on data/iris.csv through
    ``CsvSourceBatchOp``, then ``transform`` + ``collect``, cold and warm;
    purity against the species must equal the reference's
    (``IRIS_REFERENCE_PURITY``), the centroids lie within 1e-4 of the
    port's CPU route (``ALINK_TORCH_DEVICE=cpu`` in this process) with the
    same numIters, and the model saved, loaded and served through
    ``LocalPredictor`` predicts the same; ``predict_row`` latency is the
    median of 20 calls; (11.2) KMeans k=10, maxIter=50 on 60,000
    MNIST-layout rows of 784 columns: walls, numIters, inertia, host syncs
    of a fit (``torch.cuda.set_sync_debug_mode``), device operations and
    idle share (``torch.profiler``), centroids within 1e-4 of the largest
    entry of the CPU route's, same numIters; (11.3) BASELINE #2 in
    bench.py:281-350's configuration, ``SoftmaxTrainBatchOp(maxIter=30)`` +
    ``SoftmaxPredictBatchOp`` on bench.py's seeded problem at n = 20,000
    and 60,000: samples/s (n·30 / warm wall), walls, numIters, host syncs,
    device busy time, idle share; at 20,000 the same numIters as the CPU
    route, and with l2 = SOFTMAX_GATE_L2 the weights against the CPU
    route's (``softmax_weight_gate``); the digits holdout as
    bench.py runs it, accuracy ≥ ``DIGITS_REFERENCE_ACC`` − 0.02; (11.4)
    examples/sparse_highdim_logistic.py's LR on 300 rows of
    1,000,000-dimensional SparseVectors: accuracy and numIters equal to the
    CPU route's, peak device memory under a dense block's 1.2 GB;
12. model families (``model_families``): (12.1) phase 4's BERT-base table
    served under ``inferencePrecision`` bf16 and int8 through
    ``BertTextClassifierPredictBatchOp`` on the 64-row request: 12 flash
    launches per forward chunk under each, the logits within LOGIT_ATOL of
    the same policy on the plain attention route, the int8 weights the card
    serves equal to the host's ``quantize_tree`` arithmetic, the output
    table inside the reference's accuracy band against phase 4's fp32 table
    (``QUANT_BAND``, ``QUANT_TOL``), the warm forward timed per policy;
    (12.2) the Softmax model of 11.3's configuration at n = 60,000 served at
    fp32, bf16 and int8 (calibrated with ``quant.calibration`` on 1,024
    training rows) in requests of 5,000 rows, under the mapper's 16 MiB
    threshold, so that int8 takes the W8A8 product; rows/s and the band
    per policy; the whole 60,000-row request under int8 (the chunked
    route, fp32 as in the reference) equal to fp32's; and the card's
    int32 accumulators (``torch._int_mm``) equal to the plain version's;
    (12.3) Cart, C45 and Id3 through the ops on the Covertype cell
    (maxDepth 12, maxBins 64), their trees on the first 60,000 rows at
    maxDepth 8 identical to the CPU route's, the held-out rows served at
    fp32, bf16 and int8 (int8's scores the dequantized leaves at fp32's
    leaf ids);
    (12.4) the held-out rows encoded with phase 7's GBDT through
    ``GbdtEncoderPredictBatchOp``, leaf ids equal to a numpy traversal;
    (12.5) KerasSequential with Keras's mnist_mlp layers: (a) the digits
    holdout through the ops, ≥ KERAS_DIGITS_REFERENCE_ACC − 0.02; (b) two
    epochs of 60,000 MNIST-layout rows through the ops, samples/s, ms a
    step, idle share; (c) one epoch with a BatchNorm after each (gelu)
    Dense and dropout 0, card against the CPU route
    (``keras_route_problems``);
13. foreign-model ingest (``ingest_path``; no kernel of the port: the
    launch counters, set to 0 first, must read 0 after it): (13.1)
    BASELINE #3 through torch.export, bench.py:355-513's ResNet-50 (1000
    classes, ``torch.manual_seed(0)``, its definition copied here as
    ``bench_resnet50``) exported at (256, 3, 224, 224) and run by
    ``load_torch_fn`` on the card at float32, with TF32 turned on for
    cuBLAS and cuDNN around it (the pinned route must not use it, and must
    leave the flags as it found them), and at bfloat16; the fp32 logits
    held against the same seeded model exported at 8 rows and run by its
    ``module()`` on the CPU in float64, beside the error of a TF32 run of
    ``ep.module()`` on the card, which the check must reject; bf16 against
    fp32 in a band, top-1 agreement out of 256; rows/s on batches staged
    on the card; then 1,000 seeded NCHW fp32 images (three full batches
    and a 232-row tail) through ``TableSourceBatchOp`` →
    ``TorchModelPredictBatchOp(predictBatchSize=256)`` → ``collect()`` per
    policy: request wall, warm rows/s of the loaded mapper, peak device
    memory, idle share (``torch.profiler``); (13.2) dl/resnet.py's
    ResNet-50 from seeded flax-layout variables carried by
    ``resnet_flax_to_torch``, NHWC batches of 256 at fp32 (held against the
    same module on the CPU) and bf16, then the bf16 module through
    ``torch.export`` → ``.pt2`` → ``TorchModelPredictBatchOp``, which must
    give the module's logits (the port's stand-in for the reference's
    StableHLO route); (13.3) 13.1's ResNet-50 written as ONNX by the
    port's proto writer (``onnx_resnet50``) through
    ``OnnxModelPredictBatchOp`` at fp32 (held to 13.1's fp32 op logits)
    and bf16; (13.4) BASELINE #5 as bench.py:549-582 runs it, the MLP
    16→64→1 as ``.pt2`` over 16,384 seeded rows, ``TableSourceStreamOp
    (chunkSize=4096)`` → ``TorchModelPredictStreamOp(predictBatchSize=
    4096)`` → ``collect()``, cold and warm rows/s, scores against the
    module on the CPU, and the same MLP as ONNX through
    ``OnnxModelPredictStreamOp``; (13.5) ``StableHloModelPredictBatchOp``
    raises as designed, and the SavedModel route is not driven (no
    TensorFlow on the card's machine); ``scripts/chip_phase_check.py
    ingest`` runs this phase alone;
14. BERT-base serving through ``ModelServer`` (``serving_path``; the
    flash kernel on every batch): phase 4's model table as a one-stage
    ``BertClassificationModel`` pipeline ``.ak`` (written in the
    background while 14.5 and 14.7, which serve in-memory pipelines, run
    first); (14.1) ``load`` with 8
    real texts warms the 8 rungs 8 … 64 (12 flash launches each) and
    writes the sidecar with its ladder and shape signatures; (14.2) 8
    client threads send 512 single-row requests beside 4 predict_many of
    32 rows: no new shape signature (``jit.trace``), 12 launches per batch
    the entry reports, every row against a serial predict of its text
    (rung 8) through a cached ``LocalPredictor`` — rows served at that
    rung bit-identical, the others counted and their logit gap within
    MARGIN_BOUND — and the first 8 serial rows against one rung-8 batch
    of ``cache_plan=False``, which decodes the model per predict; rows/s,
    the latency
    quantiles, the batch-size histogram, warm forward ms at rungs 8 and 64;
    (14.3) a queue of 16 under a burst of 200 submits sheds (counted in
    ``serving.shed``), every accepted request equal to its serial row, a
    1 ms deadline behind a full queue expires; (14.4) a hot-swap to a new
    head under 2 client threads: nothing dropped, rows after it the new
    model's; (14.5) bf16 and int8 loads calibrated on the warmup rows pass
    the band gate, build the quantized state once, and serve 12.1's
    request as 12.1's op does; (14.6) the HTTP surface (load by path from
    the sidecar, one-row and many-row predicts, ``/api/serving``,
    ``/metrics``, DELETE twice: 404); (14.7) a batch that raises fails its
    futures with that error and opens the breaker. ``scripts/
    chip_phase_check.py serving`` runs it after phase 4;
15. MLM pretraining (``pretraining_path``; no kernel of the port: the
    encoder takes ``full_attention``, and the launch counters, set to 0
    first, must read 0 after it): (15.1) ``pretrain_mlm`` at BERT-base
    width (hidden 768, 12 layers, 12 heads, 3072; seq 128, batch 32,
    vocab_size 30522 asked, the vocabulary the corpus reaches printed) on
    the first 1,024 lines of data/reviews_unlabeled.txt for 2 epochs:
    samples/s and the median ms a step from step 2 on (CUDA events around
    each step, no host sync), MFU (``train_step_flops`` plus the tied
    head's 6·B·S·H·V), peak memory, and the device ms by group and idle
    share from 6 profiled steps; every epoch's loss finite and the second
    below the first; (15.2) the same model over a ``CorpusStream`` of those
    lines (blocks of 256, a buffer of 512) with ``accum_steps=2`` and a
    checkpoint every 16 steps: rows/s, the registry's p50 of
    ``train.accum_flush_s``, ``train.feed_wait_s``, ``train.step_s``, and
    ``train.ckpt_saves``; loss finite, resident rows within the buffer;
    (15.3) at the CPU tests' configuration (hidden 32, 1 layer, 300 rows):
    async ≡ sync, streaming ≡ in-memory and a mid-epoch crash-resume ≡ the
    straight run, bitwise; the loss history against the port's CPU route
    from the same carried weights in bf16 and fp32; (15.4) bench.py's
    ``bench_bert_quality`` route (``bert_quality_route``): pretraining on
    all 4,400 lines, the HF checkpoint, the fine-tune through
    ``checkpointFilePath`` and the sst2_mini holdout accuracy, which must
    reach BERT_QUALITY_FLOOR; ``scripts/chip_phase_check.py pretrain``
    runs this phase alone;
16. one JSON line of kernels, then the device line last.

Tolerances. fp32 kernel vs plain: atol 1e-5 (the reference kernel's
contract); ``blockwise_attention`` routes: atol 2e-5 (the reference's
blockwise contract). bf16: kernel and plain version round s, p and p·v to
bf16 at the same points, so they differ where an fp32 sum taken in another
order lands on the other side of a bf16 rounding boundary. A score s_j
that does so moves by one bf16 ulp (≤ 2**-7·|s_j|), which scales its p_j by
up to 1 + expm1(2**-7·|s_j|); when s_j is the row max it also moves m by
that ulp and rescales the row's o and l by exp(Δm), which the final o/l
cancels. So m must lie within 2**-7·|m| of the plain version's, and the
kernel's o and l, rescaled to the plain version's m, must lie within
2**-7·(|x| + x_abs) + flip of it, element by element: x_abs is the plain
version's result on |v| and |o| (the size of the terms summed into x; for
l, l itself) and flip is the most that one flipped score of the row can
change x, max_j p_j·expm1(2**-7·|s_j|)·|v_j| for o and the same without
|v_j| for l. The kernel route of ``blockwise_attention`` is held against
its plain route at the same bound for the output o/l, with the flip terms
taken over all keys (those causal allows, where causal): 2**-7·(|out| +
out_abs) + (flip_o + |out|·flip_l)/l.
Served logits: max|Δ| ≤ 0.01 against the plain-attention route and against
full attention, about 4x the gaps measured on the card (see PERF.md).
Tree histogram: integer vals are summed exactly in any order (every
partial sum is an integer below 2**24), so kernel and plain version must
agree exactly, channel by channel; real vals within 2·count·2**-24·Σ|vals|
per cell, the worst-case fp32 error of a sum taken in any order, for both
sides (count and Σ|vals| from the plain version on ones and on |vals|).
SGNS gradients, both entries: atol 1e-5 (the reference kernel's
contract); the fused entry's hit count exactly. At D > 1,000 the gathered
rows are N(0, 100/D), not N(0, 1): the dot products then spread as those
of N(0, 1) rows at D = 100, while the fp32 rounding of a dot product of
2,048 N(0, 1) products (magnitude ~45) exceeds the atol in any summation
order. Word2Vec
tables, kernel route vs plain route: max|Δ| ≤ 1e-3, 100x the 9.8e-6 that a
rounding-level change of the block gradients (computed in float64) moved a
table of magnitude 1.4 over 3,700 steps on a quarter of the corpus on the
CPU; ``index_add_`` on the card adds a batch's duplicate ids in any order,
so two card runs are not bit-identical either. Learning gate: the in-topic
share of the top-10 cosine neighbours of vocabulary rows 100..1099 must be
≥ 0.32 (chance 0.01), half the 0.641 of the port's CPU run on a quarter of
the corpus.
Flash backward (phase 10.1), kernel route against the plain route's
autograd: fp32 within 1e-4 of the plain gradient's largest entry. bf16:
2**-6·(|g| + g_abs) element by element, g_abs the gradient's formula on
absolute values (``backward_mismatch``). Both routes round their products
to bf16 (≤ 2**-8 relative of each product) at different points: P before
P·dO (the plain route its unnormalised p), dS before dS·K and dSᵀ·Q, and
the plain route's dq sums its 4 blocks' bf16 gradients in bf16; each such
error is at most 2**-8 of a term of the absolute formula, and the
forward's own bf16 difference in O (within 2**-7 of O_abs) enters only
through rowsum(dO∘O), which g_abs also carries. Training losses (phase
10.3), kernel route against plain route: within 0.02, twice LOGIT_ATOL:
cross-entropy moves by at most twice the largest logit change, and the two
routes' logits agree within LOGIT_ATOL (phase 4); 4 AdamW steps of 2e-5
between them move the logits by far less. sst2 (phase 10.4): holdout
accuracy ≥ SST2_REFERENCE_ACC − 0.05, the reference's accuracy at the same
settings on the CPU (tests/test_torch_train_e2e.py).
Phase 11, card against the port's CPU route (``ALINK_TORCH_DEVICE=cpu``),
numIters always equal. KMeans centroids: iris within 1e-4, MNIST-layout
within 1e-4 of the largest entry; both routes take the argmin on float64
distances (operator/batch/clustering.py says why) and sum integer pixels
exactly in float32, so only the float32 division and rounding-level
differences of non-integer sums remain. Softmax at n = 20,000: bench.py's
problem is separable at that size (training accuracy 1.0, loss ~1e-6
where L-BFGS stops), so its loss has no minimizer and where the weights
stop depends on rounding: the CPU route on the same rows permuted lands
up to 2e-3 of the largest weight from itself, as far as a bf16 wire moves
them. So bench.py's fit is held to the CPU route's numIters only, and the
weights are held on the same rows with l2 = SOFTMAX_GATE_L2, which gives
the loss a minimizer (``softmax_weight_gate``). That gate is measured in
the same run: the CPU route on the rows under SOFTMAX_PERMUTATIONS seeded
permutations (another summation order, nothing else) gives the spread
that the order of the sums alone causes, and the card must lie within
SOFTMAX_SPREAD_FACTOR times the largest of those distances (each relative
to the CPU route's largest weight). The card sums in another order than
the CPU over the 784 columns as well as over the rows, so its distance may
exceed a permutation's (by 1.2x on an H100); 10 leaves room for that. Two
wrong routes run on the card in the same call must fall outside the gate,
or the gate fails: TF32 products, and the bf16 wire
(``ALINK_WIRE_PRECISION=bf16``). Iris purity equal to the
reference's; digits holdout accuracy ≥ DIGITS_REFERENCE_ACC − 0.02; the
sparse route's accuracy and numIters equal to the CPU route's.
Phase 12. Quantized BERT logits against the same policy's plain route:
LOGIT_ATOL, as phase 4 (both routes serve the same int8 or bf16 weights).
The int8 weights served: exactly the host's (q·s of the same fp32 values).
The band: the reference's ModelServer defaults, label columns agree on all
but 0.5 % of the rows, numeric columns within 5 % relative. int32
accumulators: exactly equal (integer sums). Impurity trees, card against
the CPU route: identical (count histograms are integers, the split search
is IEEE-exact on both devices: tree/grow.py says how). Tree int8 scores:
the dequantized leaf at fp32's leaf id exactly, within half a scale step
plus two fp32 roundings of fp32's; bf16 within 2**-8 of the largest leaf.
12.5(c), card against the CPU route, sgd at 0.01 from one carried init: the
per-step loss history within KERAS_LOSS_ATOL = 1e-5 (the products and
batch sums run in another order on the card, a rounding-level change per
step that sgd, linear in the gradient, carries through 469 steps without
the ±lr jumps adamw makes of zero gradients; three runs on an H100
measured 1.79e-7 each, so the limit is 56x the reading); each
BatchNorm's running mean and var with the initial values' share taken
out (``debiased_stats``: the momentum-weighted mean of the batch
statistics) within KERAS_STATS_RTOL = 2e-3 of its largest entry, which an
unbiased batch variance misses by n/(n−1) − 1 = 7.9e-3 at batch 128 (the
same three runs measured 6.9e-7); a training-mode forward of the first
batch from the initial weights within KERAS_PROBE_ATOL = 2e-5, which the
exact gelu misses by ~6e-4 (the two forms differ by up to 5e-4) while
fp32 reordering moves it by 1.5e-6 (the three runs)
(tests/test_torch_chip_smoke.py runs both mutants).
Phase 13. fp32 ingest routes against float64 on the CPU: max|Δ| ≤
INGEST_RTOL = 1e-4 of the largest |logit|. fp32 rounds each product and
sum at 2**-24; over ResNet-50's ~50 layers such errors grow as a random
walk to ~1e-6 of the logits, while TF32 rounds the products' inputs at
2**-11, ~2e-4 a layer and ~1e-3 over the network: the bound sits ~100x
above the first and ~10x below the second, and the run shows the TF32
error beside it. bf16 against fp32: INGEST_BF16_BAND = 0.05 of the
largest |logit| (2**-8 a rounding, ~0.03 as a random walk over the
layers). A ``.pt2`` route against the module it was exported from:
ROUTE_RTOL = 2**-8 of the largest |logit|, one bf16 rounding: the route
runs the module's own aten ops, so only the fp32 head (one fused product
and bias in the module, two ops in the route) or another cuDNN algorithm
could part them. A one-ulp change upstream is not small here: the route
once took aten.rsqrt as 1/sqrt, one ulp off in some BatchNorm scales, and
the bf16 network grew that to 2.5e-3 of the largest logit. The ONNX
ResNet-50 against 13.1's torch.export logits, both fp32: INGEST_RTOL.
MLP scores (13.4) against the module on the CPU: STREAM_ATOL = 1e-5.
Phase 14. Rows served at the rung of their serial predict (8 rows)
bit-identical: one batch shape, one cuBLAS algorithm and one reduction
order per output, and the flash kernel works row by row. At another rung
cuBLAS may choose another algorithm for the products (M = rows × 512
tokens): the row's logit gap log(p1/p0) must lie within MARGIN_BOUND =
2 × LOGIT_ATOL = 0.02 of the serial predict's (each logit within
LOGIT_ATOL, the bound phase 4 holds between attention routes), labels
equal wherever the serial gap exceeds it. Quantized loads against 12.1's
op outputs under the same policy: the same gap bound, and the band.
Phase 15. Feed, streaming and resume pairs on the card: bitwise (the same
batches and masks, the same kernels in the same order). The card's loss
history against the port's CPU route from the same carried weights: fp32
within PRETRAIN_FP32_ATOL = 1e-5 an epoch, the bound the CPU tests hold
the reference to (the products, softmax and LayerNorm sums run in another
order, ~1e-7 relative an op); bf16 within LOSS_ROUTE_ATOL, as phase 10.3
holds two bf16 routes (each rounds products to bf16 at the same points,
and a sum taken in another order can cross a rounding boundary).
Quality (15.4): real_holdout_accuracy ≥ BERT_QUALITY_REFERENCE_ACC − 0.05,
the reference's accuracy at the same settings on the CPU
(scripts/reference_bert_quality.py); the two packages start from
different seeded weights (JAX's threefry stream cannot be reproduced).
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

SEED = 0
REQUEST_ROWS = (1, 8, 32, 64)
WORDS = (5, 700)
SLICE = dict(B=32, H=12, Q=512, K=128, D=64)
FUSED_CASES = (          # (label, S, causal, q/k/v as the main path's views)
    ("S=512", 512, False, False),
    ("S=512, causal, views", 512, True, True),
    ("ragged S=500, views", 500, False, True),
)
BF16_ULP = 2.0 ** -7     # bf16's spacing, relative to the value, at most
FP32_ATOL = 1e-5
ATTN_FP32_ATOL = 2e-5    # the reference's blockwise-vs-full contract
LOGIT_ATOL = 0.01        # ~4x the gaps measured on an H100 (PERF.md)
NEG = -1e30              # the reference's finite mask value

# (HBM bytes/s, dense bf16 tensor FLOP/s, fp32 FLOP/s) by card; NVIDIA data
# sheets, SXM parts unless named
CARDS = {
    "H200": (4.8e12, 989e12, 67e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100": (3.35e12, 989e12, 67e12),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_peaks(name: str):
    for key, peaks in CARDS.items():
        if key in name:
            return key, peaks
    fail(f"no peak table for {name!r}: bound_ms would rest on a guessed peak")


def cuda_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain
# ---------------------------------------------------------------------------


def block_inputs(B, H, Q, K, D, dtype, *, causal, fresh, seed,
                 device="cuda"):
    """Seeded inputs of one block update: standard-normal q/k/v, random
    ``kvalid`` with batch row 0 fully masked, an all-ones or causal
    ``qk_ok``. ``fresh`` starts o/m/l empty, as the first K/V block does;
    otherwise they carry a random state, as every later block does: o
    normal, m ~ N(2, 1) (near a block's row max of scores, so corr spans
    (0, 1]) with every 8th row still at -1e30, l uniform in [0.5, 2]."""
    import torch

    g = np.random.default_rng(seed)
    q, k, v = (torch.tensor(g.standard_normal((B, H, n, D), np.float32),
                            device=device).to(dtype) for n in (Q, K, K))
    kvalid = torch.tensor(g.integers(0, 2, (B, K)), dtype=torch.int32,
                          device=device)
    kvalid[0] = 0                                   # a fully masked row
    ok = torch.ones((Q, K), dtype=torch.int32, device=device)
    if causal:
        ok = ok.tril()
    if fresh:
        o = np.zeros((B, H, Q, D), np.float32)
        m = np.full((B, H, Q), -1e30, np.float32)
        l = np.zeros((B, H, Q), np.float32)
    else:
        o = g.standard_normal((B, H, Q, D), np.float32)
        m = g.normal(2.0, 1.0, (B, H, Q)).astype(np.float32)
        m[:, :, ::8] = -1e30
        l = g.uniform(0.5, 2.0, (B, H, Q)).astype(np.float32)
    o, m, l = (torch.tensor(x, device=device) for x in (o, m, l))
    return q, k, v, kvalid, ok, o, m, l


def worst_ratio(err, bound) -> float:
    """Largest elementwise err / bound; NaN counts as out of bound."""
    import torch

    r = err / bound.clamp_min(1e-30)
    return float(torch.nan_to_num(r, nan=float("inf")).max())


def flip_allowance(s, m, v):
    """The largest change one score rounded to the other side of a bf16
    boundary can make, per row: max over keys j of
    p_j·expm1(2**-7·|s_j|)·|v_j| (per column of v) and of
    p_j·expm1(2**-7·|s_j|), with p = exp(s − m). s: (B, H, Q, K) scores as
    the plain version forms them, masked at -1e30 (a mask never flips);
    m: (B, H, Q); v: (B, H, K, D)."""
    import torch

    p = torch.exp(s - m[..., None])
    e = torch.where(s > NEG / 2, p * torch.expm1(BF16_ULP * s.abs()), 0.0)
    flip_v = torch.stack([(e[b, ..., None] * v[b, :, None].abs().float())
                          .amax(dim=2) for b in range(e.shape[0])])
    return flip_v, e.amax(dim=-1)


def block_mismatch(args, got, scale):
    """Holds a block update's ``got`` = (o, m, l) against the plain version
    on the same ``args``. Returns the raw max |Δ| of o, m and l, and for
    each its worst error over its bound (> 1 fails): fp32 atol 1e-5, bf16
    as in the module docstring."""
    import torch

    from alink_tpu_torch.dl.attn_cuda import flash_block_update_ref

    q, k, v, kvalid, ok, o_in, m_in, l_in = args
    ref = flash_block_update_ref(*args, scale=scale)
    if not all(bool(torch.isfinite(a).all()) for a in got):
        return [float("nan")] * 3, dict.fromkeys("oml", float("inf"))
    raw = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    if q.dtype != torch.bfloat16:
        return raw, {n: e / FP32_ATOL for n, e in zip("oml", raw)}
    (o, m, l), (o_r, m_r, l_r) = got, ref
    o_abs = flash_block_update_ref(q, k, v.abs(), kvalid, ok, o_in.abs(),
                                   m_in, l_in, scale=scale)[0]
    sc = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    sc = torch.where((kvalid[:, None, None, :] > 0) & (ok[None, None] > 0),
                     sc, NEG)
    flip_o, flip_l = flip_allowance(sc, m_r, v)
    f = torch.exp(m - m_r)          # the kernel's o and l at the plain m
    return raw, {
        "o": worst_ratio((o * f[..., None] - o_r).abs(),
                         BF16_ULP * (o_r.abs() + o_abs) + flip_o),
        "m": worst_ratio((m - m_r).abs(), BF16_ULP * m_r.abs()),
        "l": worst_ratio((l * f - l_r).abs(), 2 * BF16_ULP * l_r + flip_l)}


def blockwise_mismatch(q, k, v, mask, got, block_size, causal=False):
    """Holds ``blockwise_attention``'s output ``got`` from the kernel route
    against its plain route (``ALINK_ATTN_PALLAS=0``) on the same inputs.
    Returns the raw max |Δ| and the worst error over its bound (> 1 fails):
    fp32 atol 2e-5, bf16 as in the module docstring."""
    import torch

    from alink_tpu_torch.dl.attention import blockwise_attention

    def plain(vv):
        return blockwise_attention(q, k, vv, mask, block_size=block_size,
                                   causal=causal)

    ref, ref_abs = plain_route(plain, v), plain_route(plain, v.abs())
    if not bool(torch.isfinite(got).all()):
        return float("nan"), float("inf")
    err = (got.float() - ref.float()).abs()
    if q.dtype != torch.bfloat16:
        return float(err.max()), float(err.max()) / ATTN_FP32_ATOL
    # (B, S, H, D) -> (B, H, S, D); the flip terms over all keys
    vh, r, r_abs, err = (x.transpose(1, 2).float()
                         for x in (v, ref, ref_abs, err))
    sc = torch.einsum("bhqd,bhkd->bhqk", q.transpose(1, 2),
                      k.transpose(1, 2)).float() * q.shape[-1] ** -0.5
    sc = torch.where(mask[:, None, None, :] > 0, sc, NEG)
    if causal:
        sq, sk = sc.shape[-2:]
        sc = torch.where(torch.ones((sq, sk), dtype=torch.bool,
                                    device=sc.device).tril(), sc, NEG)
    m = sc.amax(dim=-1)
    l = torch.exp(sc - m[..., None]).sum(dim=-1)
    flip_o, flip_l = flip_allowance(sc, m, vh)
    bound = BF16_ULP * (r.abs() + r_abs) \
        + (flip_o + r.abs() * flip_l[..., None]) / l[..., None]
    return float(err.max()), worst_ratio(err, bound)


def attn_inputs(B, S, H, D, dtype, seed, device="cuda"):
    """Standard-normal q/k/v (B, S, H, D) and a key mask of seeded lengths:
    row 0 fully masked, row 1 full, row 2 of 100 keys (3 blocks all
    padding), the rest uniform in [1, S]."""
    import torch

    g = np.random.default_rng(seed)
    q, k, v = (torch.tensor(g.standard_normal((B, S, H, D), np.float32),
                            device=device).to(dtype) for _ in range(3))
    lens = g.integers(1, S + 1, B)
    lens[:3] = 0, S, 100
    mask = torch.tensor(np.arange(S)[None, :] < lens[:, None],
                        dtype=torch.int32, device=device)
    return q, k, v, mask


def qkv_views(q, k, v):
    """q, k, v as ``SelfAttention.forward`` hands them over: ``unbind``
    views of one (B, S, 3, H, D) tensor, S stride 3·H·D."""
    import torch

    return torch.stack((q, k, v), dim=2).unbind(dim=2)


def plain_route(fn, *a):
    """``fn(*a)`` with ``ALINK_ATTN_PALLAS=0``: attention's plain route."""
    from alink_tpu_torch.dl.attention import ATTN_KERNEL_ENV

    os.environ[ATTN_KERNEL_ENV] = "0"
    try:
        return fn(*a)
    finally:
        del os.environ[ATTN_KERNEL_ENV]


def call_bytes_flops(B, S, H, D, itemsize):
    """One attention call: q, k, v read once, the output written once, the
    (B, S) key mask; 4·B·H·S²·D operations (the two products)."""
    return 4 * B * S * H * D * itemsize + B * S * 4, 4.0 * B * H * S * S * D


def check_kernel(peaks):
    import torch

    from alink_tpu_torch.dl.attention import blockwise_attention
    from alink_tpu_torch.dl.attn_cuda import (flash_block_update,
                                              flash_block_update_ref)

    s = SLICE
    scale = s["D"] ** -0.5
    results = {}
    cases = [("bf16", torch.bfloat16, s["K"], False),
             ("fp32", torch.float32, s["K"], False),
             ("bf16 causal", torch.bfloat16, s["K"], True),
             ("fp32 causal", torch.float32, s["K"], True),
             ("bf16 ragged K=100", torch.bfloat16, 100, False),
             ("fp32 ragged K=100", torch.float32, 100, True)]
    for i, (label, dt, K, causal) in enumerate(cases):
        for fresh in (True, False):
            name = label + (", empty state" if fresh else ", carried state")
            args = block_inputs(s["B"], s["H"], s["Q"], K, s["D"], dt,
                                causal=causal, fresh=fresh, seed=SEED + i)
            got = flash_block_update(*args, scale=scale)
            raw, ratio = block_mismatch(args, got, scale)
            print(f"kernel vs plain [{name}] max|Δ| o={raw[0]:.3g} "
                  f"m={raw[1]:.3g} l={raw[2]:.3g}; worst error/bound " +
                  " ".join(f"{n}={r:.3g}" for n, r in ratio.items()),
                  flush=True)
            if not max(ratio.values()) <= 1.0:
                fail(f"flash_block_update [{name}] outside its tolerance")
            results[name] = max(raw)

    # the fused route (one launch per attention call) against the plain
    # route, with masked rows, causal, a ragged S and the main path's views
    B, H, D, bs = s["B"], s["H"], s["D"], s["K"]
    for dt in (torch.bfloat16, torch.float32):
        for label, S, causal, strided in FUSED_CASES:
            q, k, v, mask = attn_inputs(B, S, H, D, dt, SEED)
            if strided:
                q, k, v = qkv_views(q, k, v)
            got = blockwise_attention(q, k, v, mask, block_size=bs,
                                      causal=causal)
            err, worst = blockwise_mismatch(q, k, v, mask, got, bs, causal)
            name = f"fused vs plain route {str(dt)[6:]} [{label}]"
            print(f"{name} (B, S, H, D) = ({B}, {S}, {H}, {D}), block {bs}: "
                  f"max|Δ| {err:.3g}; worst error/bound {worst:.3g}",
                  flush=True)
            if not worst <= 1.0:
                fail(f"{name} outside its tolerance")
            results[name] = err

    bw, bf16_peak, _ = peaks
    # timings at the serving shape, bf16, in turns (plain, kernel, kernel,
    # plain): the fused call on the main path's views, then one block update
    S = s["Q"]
    q, k, v, mask = attn_inputs(B, S, H, D, torch.bfloat16, SEED)
    q, k, v = qkv_views(q, k, v)
    kern = lambda: blockwise_attention(q, k, v, mask, block_size=bs)  # noqa: E731
    t = [plain_route(cuda_ms, kern), cuda_ms(kern), cuda_ms(kern),
         plain_route(cuda_ms, kern)]
    plain_ms, kern_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    nbytes, flops = call_bytes_flops(B, S, H, D, itemsize=2)
    bound_s = max(nbytes / bw, flops / bf16_peak)
    bound_by = "bytes" if nbytes / bw >= flops / bf16_peak else "operations"

    args = block_inputs(B, H, S, bs, D, torch.bfloat16, causal=False,
                        fresh=False, seed=SEED)
    blk = [cuda_ms(lambda: flash_block_update_ref(*args, scale=scale)),
           cuda_ms(lambda: flash_block_update(*args, scale=scale))]

    # yardstick: one library call for the whole attention
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device="cuda").manual_seed(SEED)
    qf, kf, vf = (torch.randn((B, H, S, D), generator=g, device="cuda",
                              dtype=torch.bfloat16) for _ in range(3))
    lib_ms = cuda_ms(lambda: sdpa(qf, kf, vf))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_views_ms = cuda_ms(lambda: sdpa(qt, kt, vt))
    print(f"flash_blockwise bf16 (B, S, H, D) = ({B}, {S}, {H}, {D}), block "
          f"{bs}, one launch: kernel {kern_ms:.4f} ms, plain route "
          f"{plain_ms:.4f} ms, bound {bound_s * 1e6:.1f} us ({bound_by}: "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; kernel at "
          f"{bound_s * 1e3 / kern_ms:.3f} of it); turns plain,kernel,kernel,"
          f"plain = {[round(x, 4) for x in t]}", flush=True)
    print(f"flash_block_update one block B={B} H={H} Q={S} K={bs} D={D} "
          f"bf16, carried state: kernel {blk[1]:.4f} ms, plain "
          f"{blk[0]:.4f} ms", flush=True)
    print(f"yardstick: scaled_dot_product_attention over all {S} keys bf16 "
          f"{lib_ms:.4f} ms (contiguous (B, H, S, D)), {lib_views_ms:.4f} ms "
          f"(the same views, unmasked); the kernel takes "
          f"{kern_ms / lib_ms:.3f}x the first", flush=True)
    return dict(max_abs_err=max(results.values()), ms=kern_ms,
                plain_ms=plain_ms, bound_ms=bound_s * 1e3, bound_by=bound_by,
                library_ms=lib_ms, library_views_ms=lib_views_ms,
                block_ms=blk[1], block_plain_ms=blk[0], errors=results)


# ---------------------------------------------------------------------------
# phase 4: main path
# ---------------------------------------------------------------------------


SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def serving_config():
    """The served model: BERT-base at full width and depth, the op's
    long-document setting (attentionBlockSize 128, maxSeqLength 512)."""
    from alink_tpu_torch.dl.modules import BertConfig

    return BertConfig.base(max_position=512, num_labels=2, pool="mean",
                           attention_block_size=128)


def flax_params(cfg, rng):
    """A parameter tree of the reference's flax TransformerEncoder shapes:
    normal(0, 0.02) weights, except q and k at 1/sqrt(hidden), which gives
    attention scores (of LayerNorm'd inputs) a spread of about one unit."""
    h, inter = cfg.hidden_size, cfg.intermediate_size

    def normal(*shape):
        return (rng.standard_normal(shape, np.float32) * 0.02).astype(np.float32)

    def dense(i, o):
        return {"kernel": normal(i, o), "bias": normal(o)}

    def norm():
        return {"scale": np.ones(h, np.float32), "bias": np.zeros(h, np.float32)}

    def qkv():
        kernel = normal(h, 3, h)
        kernel[:, :2] *= h ** -0.5 / 0.02
        return {"kernel": kernel, "bias": normal(3, h)}

    p = {"tok_emb": {"embedding": normal(cfg.vocab_size, h)},
         "pos_emb": {"embedding": normal(cfg.max_position, h)},
         "type_emb": {"embedding": normal(cfg.type_vocab_size, h)},
         "ln_emb": norm()}
    for i in range(cfg.num_layers):
        p[f"layer_{i}"] = {
            "attention": {"qkv": qkv(), "out": dense(h, h)},
            "ln_att": norm(), "mlp_in": dense(h, inter),
            "mlp_out": dense(inter, h), "ln_mlp": norm()}
    p["pooler"] = dense(h, h)
    p["head"] = dense(h, cfg.num_labels)
    return {"params": p}


def synthetic_vocab(cfg):
    """``vocab_size`` wordpieces: the special tokens, then w0, w1, ..."""
    return SPECIALS + [f"w{i}" for i in range(cfg.vocab_size - len(SPECIALS))]


def request_texts(vocab, rng, n):
    """n texts of WORDS[0]..WORDS[1] seeded words: at maxSeqLength 512 their
    K blocks are full, partial or all padding."""
    lens = rng.integers(WORDS[0], WORDS[1] + 1, n)
    return [" ".join(vocab[j] for j in rng.integers(len(SPECIALS), len(vocab),
                                                    w))
            for w in lens]


def forward_ms(model, enc, reps: int = 3, precision=None) -> float:
    """Wall ms of one warm ``predict_model`` call under ``precision`` (host
    clock, synced)."""
    import torch

    from alink_tpu_torch.dl.train import predict_model

    predict_model(model, enc, precision=precision)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        predict_model(model, enc, precision=precision)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main_path(workdir, cfg):
    import dataclasses

    import torch

    from alink_tpu_torch.common.model import model_to_table
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.dl.modules import TransformerEncoder
    from alink_tpu_torch.dl.train import predict_model
    from alink_tpu_torch.mapper import softmax_np
    from alink_tpu_torch.native import kernels
    from alink_tpu_torch.operator.batch import (
        AkSinkBatchOp, AkSourceBatchOp, BertTextClassifierPredictBatchOp,
        BertTextModelMapper, TableSourceBatchOp)
    from alink_tpu_torch.operator.batch.dl import params_to_bytes

    rng = np.random.default_rng(SEED)
    vocab = synthetic_vocab(cfg)
    t0 = time.perf_counter()
    tree = flax_params(cfg, rng)
    meta = {"modelName": "BertTextModel",
            "bertConfig": {k: v for k, v in dataclasses.asdict(cfg).items()
                           if k != "dtype"},
            "textCol": "text", "textPairCol": None, "labelCol": "label",
            "labelType": "LONG", "labels": [0, 1], "regression": False,
            "maxSeqLength": 512, "vocab": vocab, "doLowerCase": True}
    model_table = model_to_table(meta, {"params": params_to_bytes(tree)})
    path = os.path.join(workdir, "bert_base.ak")
    AkSinkBatchOp(filePath=path, overwriteSink=True).link_from(
        TableSourceBatchOp(model_table)).collect()
    model_src = AkSourceBatchOp(filePath=path)
    print(f"model: BERT-base weights from seed {SEED}, encoded and written to "
          f".ak ({os.path.getsize(path) / 1e6:.1f} MB) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    requests = []
    for n in REQUEST_ROWS:
        texts = request_texts(vocab, rng, n)
        requests.append(MTable({"text": np.asarray(texts, dtype=object),
                                "label": rng.integers(0, 2, n)},
                               "text string, label long"))

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    outs, lat = [], []
    for table in requests:
        t0 = time.perf_counter()
        out = BertTextClassifierPredictBatchOp(
            predictionCol="pred", predictionDetailCol="detail").link_from(
            model_src, TableSourceBatchOp(table)).collect()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        outs.append(out)
    launches = kernels.launches()["flash_block_update"]
    peak = torch.cuda.max_memory_allocated()

    chunks = sum(-(-n // 256) for n in REQUEST_ROWS)
    expect = chunks * cfg.num_layers
    if launches != expect:
        fail(f"flash_block_update launched {launches} times on the main path, "
             f"expected {expect} (one per layer: 12 per forward chunk)")
    for n, out in zip(REQUEST_ROWS, outs):
        probs = np.asarray([[json.loads(d)[k] for k in ("0", "1")]
                            for d in out.col("detail")])
        if out.num_rows != n or probs.shape != (n, 2) \
                or not np.isfinite(probs).all() \
                or not np.allclose(probs.sum(1), 1.0, atol=1e-6) \
                or not set(np.asarray(out.col("pred")).tolist()) <= {0, 1}:
            fail(f"request of {n} rows: bad output table")
        print(f"request {n:3d} rows: {lat[REQUEST_ROWS.index(n)] * 1e3:.1f} ms "
              f"end to end (model load included), "
              f"{n / lat[REQUEST_ROWS.index(n)]:.1f} rows/s", flush=True)
    print(f"main path: {launches} flash_block_update launches over {chunks} "
          f"forward chunks; peak device memory {peak / 2**30:.2f} GiB",
          flush=True)

    # the same model, straight through predict_model: warm forward times
    # and the logits checks
    mapper = BertTextModelMapper(None, requests[-1].schema, None)
    mapper.load_model(model_src.collect())
    model = mapper.model
    enc = mapper.tokenizer.encode_batch(list(requests[-1].col("text")),
                                        max_len=512)
    lens = enc["attention_mask"].sum(1)
    full_blocks = int(((lens[:, None] - np.arange(4) * 128) >= 128).sum())
    empty_blocks = int(((lens[:, None] - np.arange(4) * 128) <= 0).sum())
    print(f"64-row request: token counts {int(lens.min())}..{int(lens.max())}; "
          f"K blocks full {full_blocks}, all padding {empty_blocks}, partial "
          f"{4 * len(lens) - full_blocks - empty_blocks}", flush=True)
    for n in REQUEST_ROWS:
        sub = {k: v[:n] for k, v in enc.items()}
        dt = forward_ms(model, sub)
        print(f"forward {n:3d} rows (warm, predict_model): {dt:.1f} ms, "
              f"{n / dt * 1e3:.1f} rows/s", flush=True)

    full_model = TransformerEncoder(
        dataclasses.replace(mapper.cfg, attention_block_size=0))
    full_model.load_state_dict(model.state_dict())

    routes = {"kernel": [], "plain": [], "full": []}
    for _ in range(2):
        routes["kernel"].append(forward_ms(model, enc))
        routes["plain"].append(plain_route(forward_ms, model, enc))
        routes["full"].append(forward_ms(full_model, enc))
    print("warm 64-row forward by attention route, ms (two turns each): "
          + ", ".join(f"{r} {t}" for r, t in routes.items()), flush=True)

    logits = predict_model(model, enc)
    plain = plain_route(predict_model, model, enc)
    full = predict_model(full_model, enc)
    if not np.isfinite(logits).all():
        fail("non-finite logits")
    for label, ref in (("plain attention", plain), ("full attention", full)):
        err = float(np.abs(logits - ref).max())
        agree = float(np.mean(logits.argmax(1) == ref.argmax(1)))
        print(f"served logits vs {label}: max|Δ| = {err:.4g} (tol "
              f"{LOGIT_ATOL}, max|logit| {float(np.abs(ref).max()):.4g}, "
              f"logit spread {float(ref.std()):.4g}), argmax agreement "
              f"{agree:.3f}", flush=True)
        if not err <= LOGIT_ATOL:
            fail(f"served logits differ from {label} by {err} > {LOGIT_ATOL}")
    served = np.asarray([[json.loads(d)[k] for k in ("0", "1")]
                         for d in outs[-1].col("detail")])
    gap = float(np.abs(served - softmax_np(logits)).max())
    print(f"64-row request probabilities vs predict_model softmax: max|Δ| = "
          f"{gap:.3g}", flush=True)
    if not gap <= 0.02:
        fail(f"operator output disagrees with predict_model ({gap})")
    return launches, dict(path=path, request=requests[-1], out=outs[-1])


# ---------------------------------------------------------------------------
# phases 5-7: the tree slice
# ---------------------------------------------------------------------------


COVTYPE_TRAIN, COVTYPE_TEST = 522_911, 58_101   # sklearn bench_covertype.py
COVTYPE_CONTINUOUS = (
    "Elevation", "Aspect", "Slope", "Horizontal_Distance_To_Hydrology",
    "Vertical_Distance_To_Hydrology", "Horizontal_Distance_To_Roadways",
    "Hillshade_9am", "Hillshade_Noon", "Hillshade_3pm",
    "Horizontal_Distance_To_Fire_Points")
COVTYPE_COLS = COVTYPE_CONTINUOUS \
    + tuple(f"Wilderness_Area{i}" for i in range(1, 5)) \
    + tuple(f"Soil_Type{i}" for i in range(1, 41))
FOREST = dict(numTrees=20, maxDepth=12, maxBins=64, minSamplesPerLeaf=5)
HIST_BINS = FOREST["maxBins"]
GBDT = dict(numTrees=20, maxDepth=6, maxBins=64)
TREE_REQUEST_ROWS = (1, 1000, COVTYPE_TEST)
FP32_EPS = 2.0 ** -24    # fp32 unit roundoff
ORACLE_ROWS = 1000       # held-out rows the predict traversal is held on


def covertype_data(n, seed):
    """n seeded rows in UCI Covertype's column layout (the file is not in the
    repository): 10 continuous columns in the file's ranges, rounded to
    integers as there, then 4 one-hot wilderness and 40 one-hot soil columns
    with skewed frequencies; the label (class 1 against the rest) is a fixed
    linear rule of the standardised continuous columns, wilderness and soil,
    plus noise. Returns X (n, 54) float32 and y (n,) int64."""
    g = np.random.default_rng(seed)
    rule = np.random.default_rng(seed + 1)   # the label rule, same for any n
    cont = np.stack([
        np.clip(g.normal(2959, 280, n), 1859, 3858),
        g.uniform(0, 360, n),
        np.clip(g.gamma(4.0, 3.5, n), 0, 66),
        np.clip(g.exponential(270, n), 0, 1397),
        np.clip(g.normal(46, 58, n), -173, 601),
        np.clip(g.exponential(2350, n), 0, 7117),
        np.clip(g.normal(212, 27, n), 0, 254),
        np.clip(g.normal(223, 20, n), 0, 254),
        np.clip(g.normal(143, 38, n), 0, 254),
        np.clip(g.exponential(1980, n), 0, 7173)], axis=1).round()
    wild = g.choice(4, n, p=[0.449, 0.051, 0.436, 0.064])
    soil_p = rule.permutation(1.0 / np.arange(1, 41) ** 1.1)
    soil = g.choice(40, n, p=soil_p / soil_p.sum())
    X = np.zeros((n, 54), np.float32)
    X[:, :10] = cont
    X[np.arange(n), 10 + wild] = 1.0
    X[np.arange(n), 14 + soil] = 1.0
    z = (cont - cont.mean(0)) / cont.std(0)
    wild_eff = np.array([0.4, 1.0, -0.3, -1.2])
    soil_eff = rule.normal(0.0, 0.8, 40)
    score = z @ np.array([1.2, 0.1, -0.6, -0.4, 0.2, 0.5, 0.2, 0.3, 0.0, 0.5]) \
        + wild_eff[wild] + soil_eff[soil] - 0.3 + g.normal(0.0, 0.5, n)
    return X, (score > 0).astype(np.int64)


def covertype_table(X, y):
    from alink_tpu_torch.common.mtable import MTable

    cols = {c: X[:, j].astype(np.float64) for j, c in enumerate(COVTYPE_COLS)}
    cols["label"] = y
    return MTable(cols)


def level_inputs(bins, level, seed, device="cuda", oob=False):
    """One level of the forest's level program on Covertype-layout bins
    (n, 54) uint8 (a numpy array, or a tensor already on ``device``):
    seeded node ids spread evenly over the level's L = 2**level nodes; with
    ``oob``, 1 % of the nodes set to -1 and 1 % to [L, L+8), and 1 % of the
    bins to [64, 256), where node·B + bin points past the node. Returns
    (bins, node int32, L, vals): vals maps "g" to the forest's integer
    g = -label·(bootstrap count), "count" to the counts, "normal" to
    standard-normal reals."""
    import torch

    g = np.random.default_rng(seed)
    n = bins.shape[0]
    L = 1 << level
    node = g.integers(0, L, n)
    if oob:
        r = g.random(n)
        node = np.where(r < 0.01, -1, node)
        node = np.where(r > 0.99, L + g.integers(0, 8, n), node)
        b = np.asarray(bins.cpu() if isinstance(bins, torch.Tensor) else bins)
        hi = g.random(b.shape) < 0.01
        bins = np.where(hi, g.integers(64, 256, b.shape), b).astype(np.uint8)
    if not isinstance(bins, torch.Tensor):
        bins = torch.tensor(bins, dtype=torch.uint8, device=device)
    w = g.multinomial(n, np.ones(n) / n).astype(np.float32)
    label = g.integers(0, 2, n).astype(np.float32)
    vals = {"g": -(label * w), "count": w,
            "normal": g.standard_normal(n).astype(np.float32)}
    return (bins, torch.tensor(node, dtype=torch.int32, device=device), L,
            {k: torch.tensor(v, device=device) for k, v in vals.items()})


def level_mismatch(bins, node, vals, L, got, exact):
    """Holds one level's histograms ``got`` (a tuple of C (L, d, B) tensors)
    against ``level_histograms_ref`` on the same inputs. ``exact``: per
    channel, integer vals. Returns (max|Δ|, worst error/bound; > 1 fails).
    Exact channels: any difference fails. Real vals: |Δ| ≤
    2·count·2**-24·Σ|vals| per cell, count and Σ|vals| from the plain
    version on ones and |vals| (the worst-case fp32 error of a sum in any
    order, for both sides)."""
    import torch

    from alink_tpu_torch.tree.hist_cuda import level_histograms_ref

    kw = dict(num_nodes=L, num_bins=HIST_BINS)
    ref = level_histograms_ref(bins, node, vals, **kw)
    if len(got) != len(ref) or any(
            a.shape != r.shape or not bool(torch.isfinite(a).all())
            for a, r in zip(got, ref)):
        return float("nan"), float("inf")
    raw, ratio = 0.0, 0.0
    for a, r, v, ex in zip(got, ref, vals, exact):
        err = (a - r).abs()
        raw = max(raw, float(err.max()))
        if ex:
            ratio = max(ratio, 0.0 if float(err.max()) == 0 else float("inf"))
            continue
        count, size = level_histograms_ref(bins, node,
                                           (torch.ones_like(v), v.abs()), **kw)
        ratio = max(ratio, worst_ratio(err, 2 * count * FP32_EPS * size))
    return raw, ratio


def level_bytes(n, d, L, channels, bin_bytes=1):
    """Bytes one level call must move: bins, node and the distinct channels'
    vals read once, their (L, d, B) histograms written once."""
    return n * d * bin_bytes + 4 * n + channels * (4 * n + 4 * L * d
                                                   * HIST_BINS)


def time_level(peaks, bins, node, vals, L, label):
    """Times one level call of ``level_histograms`` on (bins, node, vals) in
    turns with its plain version, and one
    ``index_add_`` over the flat cell index of the distinct channels as the
    yardstick, each as device time in a CUDA graph (the call's few
    launches issued from Python are timed at the host's pace otherwise);
    returns ms of each, the bound, the turns and the eager time."""
    import torch

    from alink_tpu_torch.tree.hist_cuda import (level_histograms,
                                                level_histograms_ref)

    n, d = bins.shape
    kw = dict(num_nodes=L, num_bins=HIST_BINS)
    plain = lambda: level_histograms_ref(bins, node, vals, **kw)  # noqa: E731
    kern = lambda: level_histograms(bins, node, vals, **kw)  # noqa: E731
    uniq = list({id(v): v for v in vals}.values())
    C = len(uniq)
    cell = (node.long()[:, None] * d + torch.arange(d, device="cuda")) \
        * HIST_BINS + bins.long()                            # (n, d)
    flat = torch.cat([cell.reshape(-1) + c * L * d * HIST_BINS
                      for c in range(C)])
    vflat = torch.cat([v[:, None].expand(n, d).reshape(-1) for v in uniq])
    lib = lambda: torch.zeros(C * L * d * HIST_BINS,  # noqa: E731
                              device="cuda").index_add_(0, flat, vflat)
    slow = dict(iters=3, reps=5)
    t = [graph_ms(plain, **slow), graph_ms(kern, 10, 20),
         graph_ms(kern, 10, 20), graph_ms(plain, **slow)]
    bw, _, fp32_peak = peaks
    nbytes = level_bytes(n, d, L, C)
    row = dict(ms=(t[1] + t[2]) / 2, plain_ms=(t[0] + t[3]) / 2,
               library_ms=graph_ms(lib, **slow), bound_ms=max(
                   nbytes / bw, C * n * d / fp32_peak) * 1e3, turns=t,
               eager_ms=cuda_ms(kern))
    del flat, vflat, cell
    print(f"tree_histogram level call {label} n={n} d={d} L={L} "
          f"(S = {L * HIST_BINS}), {len(vals)} channels ({C} distinct), "
          f"device time in CUDA graphs: kernel {row['ms']:.4f} ms (its sort "
          f"of the rows by node included), plain "
          f"{row['plain_ms']:.4f} ms, index_add_ yardstick "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms'] * 1e3:.1f} us "
          f"(bytes: {nbytes / 1e6:.1f} MB); turns plain,kernel,kernel,plain "
          f"= {[round(x, 4) for x in t]}; issued eagerly from Python "
          f"{row['eager_ms']:.4f} ms", flush=True)
    return row


LEVEL_CASES = (          # (label, the channels (g, h, c) by value kind)
    ("forest g, count, count (h is c)", ("g", "count", "count")),
    ("normal, g, count (h != c)", ("normal", "g", "count")),
)


def level_cases(bins, level, seed, device="cuda"):
    """Phase 5's inputs at one level: the forest's channels (h is c) and
    real-valued ones (h != c) on evenly spread nodes; at L = 1, 64 and 2,048
    both again with nodes and bins out of range. Yields (label, bins, node,
    L, vals, exact)."""
    cases = [(level_inputs(bins, level, seed, device), "")]
    if level in (0, 6, 11):
        cases.append((level_inputs(bins, level, seed + 100, device,
                                   oob=True), "oob "))
    for (b, node, L, vals), tag in cases:
        for label, names in LEVEL_CASES:
            if names[1] == names[2]:
                chans = (vals[names[0]], vals[names[1]], vals[names[1]])
            else:
                chans = tuple(vals[k] for k in names)
            yield (tag + label, b, node, L, chans,
                   tuple(k != "normal" for k in names))


def check_histogram(peaks, bins):
    """Phase 5: the fused level call ``level_histograms`` against
    ``level_histograms_ref`` on the card at every level of a depth-12 tree
    (L = 1 … 2,048, S = 64 … 131,072) with seeded node ids spread evenly
    over the level's nodes, then timed there. Returns the raw errors and the
    timings by S."""
    import torch

    from alink_tpu_torch.tree.hist_cuda import level_histograms

    staged = torch.tensor(bins, dtype=torch.uint8, device="cuda")
    by_segments, errors = {}, {}
    for level in range(FOREST["maxDepth"]):
        timed = None
        for label, b, node, L, vals, exact in level_cases(
                staged, level, SEED + level):
            got = level_histograms(b, node, vals, num_nodes=L,
                                   num_bins=HIST_BINS)
            raw, ratio = level_mismatch(b, node, vals, L, got, exact)
            S = L * HIST_BINS
            print(f"tree_histogram vs plain [S={S} {label}] max|Δ| "
                  f"{raw:.3g}; error/bound {ratio:.3g} (exact channels: "
                  f"{exact})", flush=True)
            if not ratio <= 1.0:
                fail(f"tree_histogram [S={S} {label}] outside its tolerance")
            errors[f"S={S} {label}"] = raw
            if timed is None:
                timed = (b, node, vals, L)
        by_segments[timed[3] * HIST_BINS] = time_level(
            peaks, *timed, "even nodes")
    return errors, by_segments


WIDE_ROWS = 60_000          # MNIST's training rows
WIDE_D = (300, 784)         # above the 256 features of one feature block
WIDE_LEVELS = (0, 6, 11)    # L = 1, 64, 2,048
WIDE_FOREST = dict(numTrees=4, maxDepth=10, maxBins=HIST_BINS,
                   minSamplesPerLeaf=5)


def mnist_layout(n, seed):
    """n seeded rows in MNIST's layout (the file is not in the repository):
    784 pixel columns of integer intensities in [0, 255], about a fifth of
    them non-zero and more often near the image's centre, and a binary
    label from a fixed linear rule of the pixels plus noise. Returns X (n,
    784) float32 and y (n,) int64."""
    g = np.random.default_rng(seed)
    rule = np.random.default_rng(seed + 1)
    r = np.hypot(*np.meshgrid(np.arange(28) - 13.5, np.arange(28) - 13.5))
    p_on = (0.45 * np.exp(-(r / 9.0) ** 2)).reshape(-1)   # mean ~0.19
    on = g.random((n, 784), dtype=np.float32) < p_on
    X = np.where(on, g.integers(1, 256, (n, 784)), 0).astype(np.float32)
    w = rule.normal(0.0, 1.0, 784) * p_on
    score = (X / 255.0) @ w
    score += g.normal(0.0, 0.3 * score.std(), n)
    return X, (score > np.median(score)).astype(np.int64)


def check_wide_histograms(peaks, bins, device="cuda"):
    """Phase 5, wide tables (more than one feature block of the kernel): the
    level call against ``level_histograms_ref`` at d = 300 and 784 on
    MNIST-layout bins (n = 60,000) at L = 1, 64 and 2,048, the forest's
    integer channels exactly and real ones within their bound, nodes and
    bins out of range included; timed at L = 64. Returns the raw errors and
    the times by d."""
    import torch

    from alink_tpu_torch.tree.hist_cuda import level_histograms

    staged = torch.tensor(bins, dtype=torch.uint8, device=device)
    errors, times = {}, {}
    for d in WIDE_D:
        b_d = staged[:, :d].contiguous()
        for level in WIDE_LEVELS:
            for label, b, node, L, vals, exact in level_cases(
                    b_d, level, SEED + 50 + level, device):
                got = level_histograms(b, node, vals, num_nodes=L,
                                       num_bins=HIST_BINS)
                raw, ratio = level_mismatch(b, node, vals, L, got, exact)
                name = f"d={d} L={L} {label}"
                print(f"tree_histogram vs plain [{name}] max|Δ| {raw:.3g}; "
                      f"error/bound {ratio:.3g} (exact channels: {exact})",
                      flush=True)
                if not ratio <= 1.0:
                    fail(f"tree_histogram [{name}] outside its tolerance")
                errors[name] = raw
        if device != "cuda":
            continue
        b, node, L, vals = level_inputs(b_d, 6, SEED + 56)
        times[d] = time_level(peaks, b, node,
                              (vals["g"], vals["count"], vals["count"]), L,
                              f"wide table d={d}")
    return errors, times


def wide_forest_path():
    """Phase 6, wide table: a forest of 4 trees (depth 10) through
    ``RandomForestTrainBatchOp`` on 60,000 MNIST-layout rows of 784 columns,
    one histogram launch a level, the same trees as the
    ``ALINK_GBDT_PALLAS=0`` route; the two routes timed in turns (plain,
    kernel, kernel, plain). Returns the launches and the walls."""
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import RandomForestTrainBatchOp
    from alink_tpu_torch.tree import grow

    X, y = mnist_layout(WIDE_ROWS, SEED)
    cols = {f"pixel{j}": X[:, j].astype(np.float64) for j in range(784)}
    cols["label"] = y
    table = MTable(cols)
    expect = WIDE_FOREST["numTrees"] * WIDE_FOREST["maxDepth"]
    turns = forest_turns(RandomForestTrainBatchOp, WIDE_FOREST, table, grow,
                         expect)
    same = same_trees(turns)
    print(f"wide forest ({WIDE_ROWS} rows x 784 columns, {WIDE_FOREST}) "
          f"in turns: walls {turn_walls(turns)} s; median kernel "
          f"{turns['kernel_median_s']:.3f} s, plain "
          f"{turns['plain_median_s']:.3f} s; {turns['launches']} "
          f"tree_histogram launches per kernel run (expected {expect}); "
          f"trees identical {same}", flush=True)
    if not all(same.values()):
        fail("the kernel route grew other trees than the plain route on the "
             "784-column table")
    return dict(launches=turns["launches"], walls_s=turn_walls(turns),
                wall_s=turns["kernel_median_s"],
                plain_wall_s=turns["plain_median_s"])


FOREST_TURNS = ("plain", "kernel", "kernel", "plain")


def forest_turns(op_cls, params, table, grow, expect):
    """Trains through ``op_cls`` in FOREST_TURNS order, the plain route under
    ``ALINK_GBDT_PALLAS=0``, none of the runs instrumented; each kernel run
    must launch ``tree_histogram`` ``expect`` times. Returns the turns as
    (route, wall s, model table), the median wall of each route and the
    kernel runs' launches."""
    from alink_tpu_torch.native import kernels

    turns = []
    for route in FOREST_TURNS:
        kernels.reset_launches()
        if route == "plain":
            os.environ[grow.HIST_KERNEL_ENV] = "0"
        try:
            model, wall = train_trees(op_cls, params, table)
        finally:
            os.environ.pop(grow.HIST_KERNEL_ENV, None)
        launches = kernels.launches()["tree_histogram"]
        if launches != (expect if route == "kernel" else 0):
            fail(f"tree_histogram launched {launches} times in a {route} "
                 f"run of {params}, expected "
                 f"{expect if route == 'kernel' else 0}")
        turns.append((route, wall, model))
    return dict(turns=turns, launches=expect, **{
        f"{r}_median_s": float(np.median([w for rt, w, _ in turns
                                          if rt == r]))
        for r in ("kernel", "plain")})


def turn_walls(turns):
    return [(route, round(wall, 3)) for route, wall, _ in turns["turns"]]


def same_trees(turns, model=None):
    """Whether every turn's trees (and ``model``'s) are the first turn's."""
    from alink_tpu_torch.common.model import table_to_model

    models = [m for _, _, m in turns["turns"]] + \
        ([model] if model is not None else [])
    first = table_to_model(models[0])[1]
    same = {k: True for k in ("feats", "thrs", "leaves")}
    for m in models[1:]:
        arrays = table_to_model(m)[1]
        for k in same:
            same[k] = same[k] and bool(np.array_equal(arrays[k], first[k]))
    return same


def main_path_histograms(peaks, kept):
    """The forest's first tree, level by level: its level calls' inputs as
    the main path made them (``kept``), held against the plain version
    (exact: integer vals) and timed. Returns the means over the levels, the
    raw errors and the timings by S."""
    from alink_tpu_torch.tree.hist_cuda import level_histograms

    rows, errors = {}, {}
    for bins, node, vals, L in kept:
        S = L * HIST_BINS
        got = level_histograms(bins, node, vals, num_nodes=L,
                               num_bins=HIST_BINS)
        raw, ratio = level_mismatch(bins, node, vals, L, got,
                                    (True,) * len(vals))
        if not ratio <= 1.0:
            fail(f"tree_histogram on the forest's level S={S}: max|Δ| {raw}")
        errors[f"forest level S={S}"] = raw
        rows[S] = time_level(peaks, bins, node, vals, L, "forest tree 1")
    mean = {k: sum(r[k] for r in rows.values()) / len(rows)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return mean, errors, rows


def predict_numpy(ens, X):
    """The reference's traversal (alink_tpu/tree/grow.py:189-213) in numpy,
    tree by tree: the oracle the card's predict is held against."""
    n = X.shape[0]
    out = np.tile(ens.base_score[None, :].astype(np.float64), (n, 1))
    for f, t, lv in zip(ens.feats, ens.thrs, ens.leaves):
        node = np.zeros(n, np.int64)
        pos = np.zeros(n, np.int64)
        for _ in range(ens.depth):
            fs, ts = f[pos], t[pos]
            x = X[np.arange(n), np.maximum(fs, 0)]
            right = (~((fs < 0) | (x <= ts))).astype(np.int64)
            node = node * 2 + right
            pos = 2 * pos + 1 + right
        out += lv[:, node].T
    return out


def instrument_forest(grow):
    """Wraps ``grow._level`` and ``grow.level_histograms`` so that each call
    records CUDA events, and keeps the first tree's level-call inputs.
    Returns (levels, launches, kept, restore): (level, start, end) per
    level program, (start, end) per level call of the histogram, (bins,
    node, vals, L) per level of the first tree, and the hook that undoes
    the wrapping."""
    import torch

    orig_level, orig_hist = grow._level, grow.level_histograms
    levels, launches, kept = [], [], []

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def level(*args, **kw):
        a, b = events()
        a.record()
        out = orig_level(*args, **kw)
        b.record()
        levels.append((args[6].bit_length() - 1, a, b))   # num_nodes
        return out

    def hist(bins, node, vals, *, num_nodes, num_bins):
        a, b = events()
        a.record()
        out = orig_hist(bins, node, vals, num_nodes=num_nodes,
                        num_bins=num_bins)
        b.record()
        if len(kept) < FOREST["maxDepth"]:
            kept.append((bins, node, tuple(vals), num_nodes))
        launches.append((a, b))
        return out

    def restore():
        grow._level, grow.level_histograms = orig_level, orig_hist

    grow._level, grow.level_histograms = level, hist
    return levels, launches, kept, restore


def train_trees(op_cls, params, table):
    """Train through ``TableSourceBatchOp`` → ``op_cls`` → ``collect()``;
    returns the model table and the wall seconds."""
    import torch

    from alink_tpu_torch.operator.batch import TableSourceBatchOp

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = op_cls(labelCol="label", **params).link_from(
        TableSourceBatchOp(table)).collect()
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def serve_trees(op_cls, model_src, X_test, y_test, label):
    """Serves held-out requests of TREE_REQUEST_ROWS rows; checks each
    output table; returns the predictions of the whole held-out set."""
    import torch

    from alink_tpu_torch.operator.batch import TableSourceBatchOp

    pred = None
    for n in TREE_REQUEST_ROWS:
        req = covertype_table(X_test[:n], y_test[:n])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = op_cls(predictionCol="pred", predictionDetailCol="detail") \
            .link_from(model_src, TableSourceBatchOp(req)).collect()
        dt = time.perf_counter() - t0
        probs = np.asarray([[json.loads(s)[k] for k in ("0", "1")]
                            for s in out.col("detail")])
        pred = np.asarray(out.col("pred"))
        if out.num_rows != n or not np.isfinite(probs).all() \
                or not np.allclose(probs.sum(1), 1.0, atol=1e-6) \
                or not set(pred.tolist()) <= {0, 1}:
            fail(f"{label} request of {n} rows: bad output table")
        print(f"{label} predict {n:5d} rows: {dt * 1e3:.1f} ms end to end, "
              f"{n / dt:.0f} rows/s", flush=True)
    from alink_tpu_torch.common.model import table_to_model
    from alink_tpu_torch.tree import TreeEnsemble

    ens = TreeEnsemble.from_arrays(*table_to_model(model_src.collect()))
    ens.raw_predict(X_test)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        ens.raw_predict(X_test)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 3
    print(f"{label} raw_predict alone (warm, {len(X_test)} rows, "
          f"{ens.feats.shape[0]} trees): {dt * 1e3:.2f} ms, "
          f"{len(X_test) / dt:.0f} rows/s", flush=True)
    return pred


def forest_path(workdir, X, y, peaks):
    """Phase 6: the forest at full size through the operators on the card:
    one instrumented kernel run (launches, CUDA events at every level, the
    first tree's level inputs), then the walls of both routes timed in
    turns without instrumentation (plain, kernel, kernel, plain). Returns
    the main path's tree_histogram launches, the device ms of its level
    calls and level programs there, the walls, and the kernel's timings on
    the first tree's inputs."""
    import torch

    from alink_tpu_torch.common.model import table_to_model
    from alink_tpu_torch.native import kernels
    from alink_tpu_torch.operator.batch import (
        AkSinkBatchOp, AkSourceBatchOp, RandomForestPredictBatchOp,
        RandomForestTrainBatchOp, TableSourceBatchOp)
    from alink_tpu_torch.tree import TreeEnsemble, grow

    n_tr = COVTYPE_TRAIN
    train = covertype_table(X[:n_tr], y[:n_tr])
    X_test, y_test = X[n_tr:], y[n_tr:]
    # the main path's run: CUDA events at every level and level call, and
    # the first tree's level inputs kept; its wall is not a timing (the
    # walls are timed below, in turns, with no instrumentation)
    levels, launch_ev, kept, restore = instrument_forest(grow)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    try:
        model, wall = train_trees(RandomForestTrainBatchOp, FOREST, train)
    finally:
        restore()
    launches = kernels.launches()["tree_histogram"]
    peak = torch.cuda.max_memory_allocated()
    expect = FOREST["maxDepth"] * FOREST["numTrees"]
    depth = FOREST["maxDepth"]
    first, rest = [0.0] * depth, [0.0] * depth
    for i, (lv, a, b) in enumerate(levels):
        (first if i < depth else rest)[lv] += a.elapsed_time(b)
    launch_ms = [a.elapsed_time(b) for a, b in launch_ev]
    print(f"forest train ({n_tr} rows, {FOREST}), the instrumented run: "
          f"{wall:.2f} s wall (not a timing); "
          f"{launches} tree_histogram launches, {sum(launch_ms):.1f} ms of "
          f"device time in the level calls, sort of node included (mean "
          f"{np.mean(launch_ms):.4f} ms, by level of the first tree "
          f"{[round(t, 4) for t in launch_ms[:depth]]}); peak "
          f"device memory {peak / 2**30:.2f} GiB; level program device ms "
          f"by level, first tree {[round(t, 2) for t in first]}, mean of "
          f"the other {FOREST['numTrees'] - 1} "
          f"{[round(t / (FOREST['numTrees'] - 1), 3) for t in rest]}; all "
          f"levels of all trees {sum(first) + sum(rest):.1f} ms",
          flush=True)
    if launches != expect:
        fail(f"tree_histogram launched {launches} times on the forest path, "
             f"expected {expect} (one per level)")
    stats = main_path_histograms(peaks, kept)
    del kept

    turns = forest_turns(RandomForestTrainBatchOp, FOREST, train, grow,
                         expect)
    same = same_trees(turns, model)
    arrays = table_to_model(model)[1]
    print(f"forest walls in turns, no instrumentation: "
          f"{turn_walls(turns)} s; median kernel "
          f"{turns['kernel_median_s']:.3f} s, plain (ALINK_GBDT_PALLAS=0) "
          f"{turns['plain_median_s']:.3f} s; trees of every run identical "
          f"{same}; split features sha1 "
          f"{hashlib.sha1(arrays['feats'].tobytes()).hexdigest()}",
          flush=True)
    if not all(same.values()):
        fail("the kernel route grew other trees than the plain route")

    path = os.path.join(workdir, "forest.ak")
    AkSinkBatchOp(filePath=path, overwriteSink=True).link_from(
        TableSourceBatchOp(model)).collect()
    model_src = AkSourceBatchOp(filePath=path)
    ens = TreeEnsemble.from_arrays(*table_to_model(model_src.collect()))
    got = ens.raw_predict(X_test[:ORACLE_ROWS])
    gap = float(np.abs(got - predict_numpy(ens, X_test[:ORACLE_ROWS])).max())
    print(f"forest raw_predict on the card vs numpy traversal "
          f"({ORACLE_ROWS} rows): max|Δ| {gap:.3g}", flush=True)
    if not gap <= 1e-6:
        fail(f"forest predict disagrees with the numpy traversal ({gap})")
    pred = serve_trees(RandomForestPredictBatchOp, model_src, X_test, y_test,
                       "forest")
    acc = float(np.mean(pred == y_test))
    base = max(np.mean(y_test), 1 - np.mean(y_test))
    print(f"forest held-out accuracy {acc:.4f} (majority class "
          f"{base:.4f})", flush=True)
    if not acc > base + 0.05:
        fail("forest held-out accuracy is no better than the majority class")
    return launches, dict(
        level_call_mean_ms=float(np.mean(launch_ms)),
        level_calls_total_ms=float(sum(launch_ms)),
        first_tree_level_call_ms=launch_ms[:depth],
        level_program_total_ms=sum(first) + sum(rest),
        level_program_first_tree_ms=first,
        instrumented_train_wall_s=wall,
        train_wall_s=turns["kernel_median_s"],
        plain_train_wall_s=turns["plain_median_s"],
        train_walls_in_turns_s=turn_walls(turns)), stats


def gbdt_path(X, y):
    """Phase 7: GBDT at full size through the operators on the card."""
    import torch

    from alink_tpu_torch.operator.batch import (GbdtPredictBatchOp,
                                                GbdtTrainBatchOp,
                                                TableSourceBatchOp)

    n_tr = COVTYPE_TRAIN
    torch.cuda.reset_peak_memory_stats()
    model, wall = train_trees(GbdtTrainBatchOp, GBDT,
                              covertype_table(X[:n_tr], y[:n_tr]))
    print(f"gbdt train ({n_tr} rows, {GBDT}): {wall:.2f} s wall, "
          f"{n_tr / wall:.0f} rows/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    X_test, y_test = X[n_tr:], y[n_tr:]
    pred = serve_trees(GbdtPredictBatchOp, TableSourceBatchOp(model), X_test,
                       y_test, "gbdt")
    acc = float(np.mean(pred == y_test))
    base = max(np.mean(y_test), 1 - np.mean(y_test))
    print(f"gbdt held-out accuracy {acc:.4f} (majority class {base:.4f})",
          flush=True)
    if not acc > base + 0.05:
        fail("gbdt held-out accuracy is no better than the majority class")
    return model


# ---------------------------------------------------------------------------
# phases 8-9: the embedding slice
# ---------------------------------------------------------------------------


TEXT8_TYPES = 71_290     # text8's word types at min_count 5
SENTENCE = 1_000         # word2vec.c's MAX_SENTENCE_LENGTH
TOPICS = 100
W2V_TOKENS = 1_000_000
W2V = dict(vectorSize=100, window=5, negative=5, numIter=3, batchSize=1024,
           learningRate=0.025, minCount=1)
W2V_REQUEST_ROWS = (1, 1000, 10000)
SGNS_SHAPES = ((1024, 5, 100), (1000, 1, 37), (1000, 15, 100))
SGNS_TRAINED_STEPS = 300
OPS_STEPS = 100          # traced steps of the operations count
OPS_DOCS = 50            # sentences whose pairs they take
TABLE_ATOL = 1e-3        # trained tables, kernel route vs plain route
TOPIC_FLOOR = 0.32       # in-topic share of top-10 neighbours (chance 0.01)


def text8_corpus(n_tokens, seed):
    """Sentences in text8's layout (the file is not in the repository):
    ``n_tokens`` tokens ``w<rank>`` drawn by a Zipf law of exponent 1 over
    71,290 types, in sentences of 1,000 tokens. Each sentence has one of 100
    topics, and half its tokens come from the Zipf law restricted to its
    topic's words (rank mod 100), which gives the embedding something to
    learn. Returns the sentences as space-separated strings."""
    g = np.random.default_rng(seed)
    n_sent = n_tokens // SENTENCE
    p = 1.0 / np.arange(1, TEXT8_TYPES + 1)
    ids = np.searchsorted(np.cumsum(p) / p.sum(),
                          g.random((n_sent, SENTENCE)), side="right")
    topic = g.integers(0, TOPICS, n_sent)
    from_topic = g.random((n_sent, SENTENCE)) < 0.5
    u = g.random((n_sent, SENTENCE))
    for t in range(TOPICS):
        words = np.arange(t, TEXT8_TYPES, TOPICS)
        cdf = np.cumsum(1.0 / (words + 1.0))
        m = from_topic & (topic == t)[:, None]
        ids[m] = words[np.minimum(np.searchsorted(cdf / cdf[-1], u[m],
                                                  side="right"),
                                  len(words) - 1)]
    ids = np.minimum(ids, TEXT8_TYPES - 1)
    names = np.asarray([f"w{i}" for i in range(TEXT8_TYPES)], object)
    return [" ".join(row) for row in names[ids]]


def topic_share(words, vecs, device="cuda"):
    """The learning gate: of the top-10 cosine neighbours of the 1,000 most
    frequent words outside the top 100 (vocabulary rows 100..1099), the
    share that lies in the query's topic (rank mod 100); chance is 0.01."""
    import torch

    e = torch.as_tensor(np.asarray(vecs, np.float32), device=device)
    e = e / e.norm(dim=1, keepdim=True).clamp_min(1e-12)
    rows = torch.arange(100, 1100, device=device)
    sims = e[rows] @ e.T
    sims[torch.arange(1000, device=device), rows] = -float("inf")
    nb = sims.topk(10, dim=1).indices.cpu().numpy()
    topic = np.asarray([int(w[1:]) % TOPICS for w in words])
    return float(np.mean(topic[nb] == topic[100:1100, None]))


def sgns_bytes_flops(B, negs, D):
    """Bytes the function must move (v, u_pos, u_neg read once; grad_v and
    grad_u written once) and its fp32 operations: per row, negs+1 dot
    products (2D), negs+1 grad_u rows (D) and grad_v's negs+1 products and
    sums (2D)."""
    rows_in, rows_out = (2 + negs) * B, (2 + negs) * B
    return (rows_in + rows_out) * D * 4, 5.0 * (negs + 1) * B * D


def graph_ms(fn, iters: int = 30, reps: int = 50) -> float:
    """Device ms of one call of ``fn``: ``iters`` warm calls captured in a
    CUDA graph, replayed 20 times to warm up and then ``reps`` times between
    CUDA events (a window of milliseconds, long enough for the card's
    clocks to settle). A launch of a few microseconds issued from Python
    back to back is timed at the host's issue rate; the graph replays it at
    the device's."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    for _ in range(20):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def sgns_mismatch(args, got):
    """Holds ``got`` = (grad_v, grad_u) against ``sgns_block_grads_ref`` on
    the same ``args``; returns max|Δ| (NaN, wrong shapes or a non-finite
    value count as infinite). Tolerance: FP32_ATOL."""
    import torch

    from alink_tpu_torch.embedding.sgns_cuda import sgns_block_grads_ref

    ref = sgns_block_grads_ref(*args)
    if any(a.shape != b.shape or not bool(torch.isfinite(a).all())
           for a, b in zip(got, ref)):
        return float("inf")
    return max(float((a - b).abs().max()) for a, b in zip(got, ref))


def sgns_normal_inputs(B, negs, D, seed, device="cuda"):
    """Seeded N(0, 1) rows: dot products of size √D, which saturate the
    sigmoid."""
    import torch

    g = np.random.default_rng(seed)
    return tuple(torch.tensor(g.standard_normal(s), dtype=torch.float32,
                              device=device)
                 for s in ((B, D), (B, D), (B, negs, D)))


def word_pairs(docs):
    """(vocab, counts, pairs) of space-separated ``docs`` with the op's
    defaults (minCount 1, window 5, subsample 1e-3)."""
    from alink_tpu_torch.embedding import skipgram

    docs = [d.split(" ") for d in docs]
    vocab, counts = skipgram.build_vocab(docs)
    cfg = skipgram.SkipGramConfig()
    return vocab, counts, skipgram.make_pairs(docs, vocab, counts, cfg.window,
                                              cfg.subsample, SEED)


def sgns_trained_step(corpus, B, negs, D, steps=SGNS_TRAINED_STEPS,
                      device="cuda"):
    """The pull inputs of the ``steps``-th step of the plain route
    (``ALINK_SGNS_PALLAS=0``) training on ``corpus`` = (vocab, counts,
    pairs) at (B, negs, D): the tables (copied) and replicas at the
    magnitudes training gives them, the step's ids, rows and hot. Returns
    a dict of ``sgns_pull_grads``' arguments (hits aside)."""
    from alink_tpu_torch.embedding import skipgram
    from alink_tpu_torch.embedding.sgns_cuda import SGNS_KERNEL_ENV

    vocab, counts, pairs = corpus
    cfg = skipgram.SkipGramConfig(dim=D, negatives=negs, batch_size=B)
    n_blocks = max(1, len(pairs) // B)
    pairs = pairs[:steps * B]              # no more steps than needed
    cfg.epochs = -(-steps // n_blocks)
    seen, orig = [], skipgram.sgns_pull_grads_ref

    def keep(win, w_ctx, center, uids, **kw):
        seen.append(None)
        if len(seen) == steps:
            copy = lambda t: None if t is None else t.clone()  # noqa: E731
            seen[-1] = dict(
                win=win.clone(), w_ctx=w_ctx.clone(), center=center.clone(),
                uids=uids.clone(), negs=kw["negs"], rows=kw["rows"],
                hot=kw["hot"], rep_in=copy(kw["rep_in"]),
                rep_ctx=copy(kw["rep_ctx"]))
        return orig(win, w_ctx, center, uids, **kw)

    skipgram.sgns_pull_grads_ref = keep
    os.environ[SGNS_KERNEL_ENV] = "0"
    try:
        skipgram.train_skipgram_sharded(pairs, len(vocab), counts, cfg,
                                        device=device)
    finally:
        skipgram.sgns_pull_grads_ref = orig
        del os.environ[SGNS_KERNEL_ENV]
    return seen[steps - 1]


def pull_cases(step, seed):
    """Phase 8's inputs of the fused entry from a trained ``step``: the
    step's ids with 2 % of them set to sentinels (rows, where the one-rank
    pull parks hot ids, and -1) and 2 % to copies of other ids (duplicates
    beyond the Zipf draw's own), in three cases: the hot cache on, with
    replicas that differ from the tables' prefix by N(0, 0.01) noise (so a
    read of the table for a hot id shows); the hot cache off; one tied
    table with the cache on. Returns [(label, args)]."""
    import torch

    g = np.random.default_rng(seed)
    ids = {}
    for key in ("center", "uids"):
        x = step[key].cpu().numpy().copy()
        r = g.random(x.shape)
        x = np.where(r < 0.01, step["rows"], x)
        x = np.where((r >= 0.01) & (r < 0.02), -1, x)
        dup = r > 0.98
        x[dup] = x[g.integers(0, len(x), int(dup.sum()))]
        ids[key] = torch.tensor(x, dtype=torch.int64,
                                device=step["win"].device)

    def noisy(t):
        return t + torch.tensor(g.normal(0.0, 0.01, tuple(t.shape)),
                                dtype=torch.float32, device=t.device)

    hot = step["hot"]
    on = dict(step, **ids, rep_in=noisy(step["rep_in"]),
              rep_ctx=noisy(step["rep_ctx"]))
    off = dict(step, **ids, hot=0, rep_in=None, rep_ctx=None)
    tied = dict(on, w_ctx=on["win"], rep_ctx=on["rep_in"])
    return [(f"hot cache on ({hot} rows)", on), ("hot cache off", off),
            (f"tied table, hot cache on ({hot} rows)", tied)]


def pull_mismatch(args, fn):
    """Runs ``fn`` (``sgns_pull_grads`` or a stand-in) and
    ``sgns_pull_grads_ref`` on the same ``args``, each with a hit counter
    from 7 when the cache is on; returns max|Δ| of the gradients (infinite
    on other hits, wrong shapes or a non-finite value). Tolerance:
    FP32_ATOL."""
    import torch

    from alink_tpu_torch.embedding.sgns_cuda import sgns_pull_grads_ref

    dev = args["win"].device
    counters = [torch.full((), 7, dtype=torch.int64, device=dev)
                if args["hot"] > 0 else None for _ in range(2)]
    got = fn(**args, hits=counters[0])
    ref = sgns_pull_grads_ref(**args, hits=counters[1])
    if args["hot"] > 0 and int(counters[0]) != int(counters[1]):
        return float("inf")
    if len(got) != 2 or any(
            a.shape != b.shape or not bool(torch.isfinite(a).all())
            for a, b in zip(got, ref)):
        return float("inf")
    return max(float((a - b).abs().max()) for a, b in zip(got, ref))


def pull_bytes(B, negs, D):
    """Bytes the fused call must move: the (negs+2)·B ids and their table
    or replica rows read once, grad_v and grad_u written once."""
    rows = (2 + negs) * B
    return rows * 8 + 2 * rows * D * 4


def check_sgns(peaks, docs):
    """Phase 8: the gathered-rows entry ``sgns_block_grads`` against
    ``sgns_block_grads_ref`` at the main path's shape and two ragged ones,
    on rows of tables the plain route trained on ``docs`` and on N(0, 1)
    rows; the fused entry ``sgns_pull_grads`` against
    ``sgns_pull_grads_ref`` on the 300th-step tables and ids at the main
    path's shape (cache on and off, tied, sentinel and duplicate ids, hits
    equal); then both entries timed in a CUDA graph beside their bounds."""
    import torch

    from alink_tpu_torch.embedding.sgns_cuda import (pull_rows,
                                                     sgns_block_grads,
                                                     sgns_block_grads_ref,
                                                     sgns_pull_grads,
                                                     sgns_pull_grads_ref)

    corpus = word_pairs(docs)
    errors = {}
    for i, (B, negs, D) in enumerate(SGNS_SHAPES):
        step = sgns_trained_step(corpus, B, negs, D)
        cases = (("trained rows", pull_rows(**step)[:3]),
                 ("N(0,1) rows", sgns_normal_inputs(B, negs, D, SEED + i)))
        for kind, args in cases:
            err = sgns_mismatch(args, sgns_block_grads(*args))
            mag = max(float(a.abs().max()) for a in args)
            print(f"sgns_block_grads vs plain [(B, negs, D) = ({B}, {negs}, "
                  f"{D}), {kind}, max|input| {mag:.3g}] max|Δ| {err:.3g} "
                  f"(tol {FP32_ATOL})", flush=True)
            if not err <= FP32_ATOL:
                fail(f"sgns_block_grads ({B}, {negs}, {D}) {kind} outside "
                     f"its tolerance")
            errors[f"({B}, {negs}, {D}) {kind}"] = err
        if i == 0:
            timed, main_step = cases[0][1], step

    B, negs, D = SGNS_SHAPES[0]
    for label, args in pull_cases(main_step, SEED):
        err = pull_mismatch(args, sgns_pull_grads)
        print(f"sgns_pull_grads vs plain [(B, negs, D) = ({B}, {negs}, {D}), "
              f"300th-step tables, {label}, sentinel and duplicate ids] "
              f"max|Δ| {err:.3g} (tol {FP32_ATOL}; hits equal)", flush=True)
        if not err <= FP32_ATOL:
            fail(f"sgns_pull_grads [{label}] outside its tolerance or "
                 f"counted other hits")
        errors[f"pull ({B}, {negs}, {D}) {label}"] = err

    run = dict(main_step, hits=torch.zeros((), dtype=torch.int64,
                                           device="cuda"))
    plain = lambda: sgns_pull_grads_ref(**run)  # noqa: E731
    kern = lambda: sgns_pull_grads(**run)  # noqa: E731
    t = [graph_ms(plain), graph_ms(kern), graph_ms(kern), graph_ms(plain)]
    gplain = lambda: sgns_block_grads_ref(*timed)  # noqa: E731
    gkern = lambda: sgns_block_grads(*timed)  # noqa: E731
    gt = [graph_ms(gplain), graph_ms(gkern), graph_ms(gkern),
          graph_ms(gplain)]
    eager = [cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)]
    bw, _, fp32_peak = peaks
    gbytes, flops = sgns_bytes_flops(B, negs, D)
    nbytes = pull_bytes(B, negs, D)
    bound_by = "bytes" if nbytes / bw >= flops / fp32_peak else "operations"
    row = dict(ms=(t[1] + t[2]) / 2, plain_ms=(t[0] + t[3]) / 2,
               bound_ms=max(nbytes / bw, flops / fp32_peak) * 1e3,
               bound_by=bound_by, library_ms=None, turns=t,
               gathered_ms=(gt[1] + gt[2]) / 2,
               gathered_plain_ms=(gt[0] + gt[3]) / 2,
               gathered_bound_ms=max(gbytes / bw, flops / fp32_peak) * 1e3,
               gathered_turns=gt,
               eager_ms=(eager[1] + eager[2]) / 2,
               eager_plain_ms=(eager[0] + eager[3]) / 2,
               hot_rows=main_step["hot"],
               errors=errors, max_abs_err=max(errors.values()))
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"sgns_pull_grads ({B}, {negs}, {D}) fp32, hot cache of "
          f"{main_step['hot']} rows, device time per call (CUDA graph of 30 "
          f"launches, 50 replays; SM clock, max after: {clocks}): kernel "
          f"{row['ms']:.5f} ms, plain (pull + gradients) "
          f"{row['plain_ms']:.5f} ms, bound {row['bound_ms'] * 1e3:.2f} us "
          f"({bound_by}: {nbytes / 1e6:.2f} MB, {flops / 1e6:.2f} MFLOP); "
          f"turns plain,kernel,kernel,plain = {[round(x, 5) for x in t]}; "
          f"issued eagerly from Python: kernel {row['eager_ms']:.4f} ms, "
          f"plain {row['eager_plain_ms']:.4f} ms per call; gathered-rows "
          f"entry sgns_block_grads: kernel {row['gathered_ms']:.5f} ms, "
          f"plain {row['gathered_plain_ms']:.5f} ms, bound "
          f"{row['gathered_bound_ms'] * 1e3:.2f} us ({gbytes / 1e6:.2f} MB), "
          f"turns {[round(x, 5) for x in gt]}; no single PyTorch call "
          f"computes this function (library: none)", flush=True)
    return row


SGNS_WIDE_D = (1100, 2048)   # above the kernel's 1,024 register-held lanes


def wide_step(B, negs, D, seed, rows=20_000, hot=1_024, device="cuda"):
    """A step's pull inputs at row width D: N(0, 0.05) tables of ``rows``
    rows (a trained table's scale: the dot products of 2,048 such entries
    spread about 0.1), replicas of the hot rows, and ids of which a third
    are hot; the shape of :func:`sgns_trained_step`'s result."""
    import torch

    g = np.random.default_rng(seed)

    def table(n):
        return torch.tensor(g.normal(0.0, 0.05, (n, D)), dtype=torch.float32,
                            device=device)

    def ids(n):
        x = np.where(g.random(n) < 1 / 3, g.integers(0, hot, n),
                     g.integers(0, rows, n))
        return torch.tensor(x, dtype=torch.int64, device=device)

    win, w_ctx = table(rows), table(rows)
    return dict(win=win, w_ctx=w_ctx, center=ids(B), uids=ids((negs + 1) * B),
                negs=negs, rows=rows, hot=hot, rep_in=win[:hot].clone(),
                rep_ctx=w_ctx[:hot].clone())


def check_sgns_wide(seed=SEED, B=1024, rows=20_000, device="cuda"):
    """Phase 8, wide rows (D > 1,024, the kernel's chunked instance): both
    entries against both plain versions at (B, negs) = (1024, 5), atol 1e-5:
    the gathered rows on N(0, 100/D) rows (dot products spread as those of
    the N(0, 1) rows at D = 100 above, which saturate the sigmoid; N(0, 1)
    rows of D > 1,000 entries give dot products whose fp32 rounding alone,
    in any summation order, exceeds the atol) and on table rows, the pull
    on :func:`wide_step` through :func:`pull_cases` (sentinel and duplicate
    ids; cache on, off, tied; hits equal). Returns the raw errors."""
    from alink_tpu_torch.embedding.sgns_cuda import (pull_rows,
                                                     sgns_block_grads,
                                                     sgns_pull_grads)

    negs = 5
    errors = {}
    for D in SGNS_WIDE_D:
        step = wide_step(B, negs, D, seed + D, rows=rows, device=device)
        scaled = tuple(x * (10.0 / D ** 0.5)
                       for x in sgns_normal_inputs(B, negs, D, seed + D,
                                                   device))
        for kind, args in (("N(0, 100/D) rows", scaled),
                           ("table rows", pull_rows(**step)[:3])):
            err = sgns_mismatch(args, sgns_block_grads(*args))
            print(f"sgns_block_grads vs plain [(B, negs, D) = ({B}, {negs}, "
                  f"{D}), {kind}] max|Δ| {err:.3g} (tol {FP32_ATOL})",
                  flush=True)
            if not err <= FP32_ATOL:
                fail(f"sgns_block_grads D={D} {kind} outside its tolerance")
            errors[f"({B}, {negs}, {D}) {kind}"] = err
        for label, args in pull_cases(step, seed):
            err = pull_mismatch(args, sgns_pull_grads)
            print(f"sgns_pull_grads vs plain [(B, negs, D) = ({B}, {negs}, "
                  f"{D}), {label}, sentinel and duplicate ids] max|Δ| "
                  f"{err:.3g} (tol {FP32_ATOL}; hits equal)", flush=True)
            if not err <= FP32_ATOL:
                fail(f"sgns_pull_grads D={D} [{label}] outside its tolerance "
                     f"or counted other hits")
            errors[f"pull ({B}, {negs}, {D}) {label}"] = err
    return errors


def step_operations(docs, steps=OPS_STEPS):
    """Device operations a step of the sharded loop (``torch.profiler``,
    CUDA activity, after an untraced warm run) on ``steps`` steps of the
    op's configuration over ``docs``, on the kernel route and on the plain
    route (``ALINK_SGNS_PALLAS=0``). Returns, per route, the operations,
    device µs and traced wall µs a step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from alink_tpu_torch.embedding import skipgram
    from alink_tpu_torch.embedding.sgns_cuda import SGNS_KERNEL_ENV

    vocab, counts, pairs = word_pairs(docs)
    cfg = skipgram.SkipGramConfig(epochs=1)
    window = pairs[:steps * cfg.batch_size]
    out = {}
    for route, knob in (("kernel", None), ("plain", "0")):
        if knob is not None:
            os.environ[SGNS_KERNEL_ENV] = knob
        try:
            skipgram.train_skipgram_sharded(window, len(vocab), counts, cfg)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                skipgram.train_skipgram_sharded(window, len(vocab), counts,
                                                cfg)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            if knob is not None:
                del os.environ[SGNS_KERNEL_ENV]
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and ev.self_device_time_total > 0]
        out[route] = dict(
            operations_per_step=sum(ev.count for ev in evs) / steps,
            device_us_per_step=sum(ev.self_device_time_total
                                   for ev in evs) / steps,
            traced_wall_us_per_step=wall * 1e6 / steps)
    print(f"device operations a step ({steps} traced steps of the sharded "
          f"loop, vocabulary {len(vocab)}, torch.profiler): kernel route "
          f"{out['kernel']['operations_per_step']:.1f} "
          f"({out['kernel']['device_us_per_step']:.1f} us of device work, "
          f"{out['kernel']['traced_wall_us_per_step']:.1f} us traced wall), "
          f"plain route {out['plain']['operations_per_step']:.1f} "
          f"({out['plain']['device_us_per_step']:.1f} us, "
          f"{out['plain']['traced_wall_us_per_step']:.1f} us)", flush=True)
    return out


def instrument_word2vec(huge, skipgram):
    """Wraps the op's ``build_vocab`` and ``make_pairs`` (host clock) and the
    sharded step loop ``_run_pairs_sharded`` (host clock and CUDA events).
    Returns (stats, restore)."""
    import torch

    stats = {}
    orig = (huge.build_vocab, huge.make_pairs, skipgram._run_pairs_sharded)

    def timed(key, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            stats[key] = time.perf_counter() - t0
            return out
        return run

    def loop(*args, **kw):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        out = orig[2](*args, **kw)
        b.record()
        torch.cuda.synchronize()
        stats.update(loop_s=time.perf_counter() - t0,
                     loop_device_ms=a.elapsed_time(b), steps=args[5],
                     n_blocks=args[6], batch=args[3])
        return out

    def restore():
        huge.build_vocab, huge.make_pairs, skipgram._run_pairs_sharded = orig

    huge.build_vocab = timed("vocab_s", orig[0])
    huge.make_pairs = timed("pairs_s", orig[1])
    skipgram._run_pairs_sharded = loop
    return stats, restore


def train_word2vec(table):
    """``TableSourceBatchOp`` → ``Word2VecTrainBatchOp`` → ``collect()``;
    returns the model table and the wall seconds."""
    import torch

    from alink_tpu_torch.operator.batch import (TableSourceBatchOp,
                                                Word2VecTrainBatchOp)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = Word2VecTrainBatchOp(selectedCol="doc", **W2V).link_from(
        TableSourceBatchOp(table)).collect()
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def model_vectors(model, dtype=np.float32):
    return np.stack([np.asarray(v.data, dtype) for v in model.col("vec")])


def word2vec_path(workdir, docs):
    """Phase 9: Word2Vec on the text8-layout corpus through the operators on
    the card. Returns the main path's sgns_block_grads launches and the
    path's numbers."""
    import torch

    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.embedding import skipgram
    from alink_tpu_torch.embedding.sgns_cuda import SGNS_KERNEL_ENV
    from alink_tpu_torch.native import kernels
    from alink_tpu_torch.operator.batch import (AkSinkBatchOp,
                                                AkSourceBatchOp,
                                                TableSourceBatchOp,
                                                Word2VecPredictBatchOp, huge)

    table = MTable({"doc": np.asarray(docs, object)})
    stats, restore = instrument_word2vec(huge, skipgram)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    try:
        model, wall = train_word2vec(table)
    finally:
        restore()
    launches = kernels.launches()["sgns_block_grads"]
    peak = torch.cuda.max_memory_allocated()
    steps, B = stats["steps"], stats["batch"]
    words = list(model.col("word"))
    vecs = model_vectors(model)
    print(f"word2vec train ({len(docs) * SENTENCE} tokens, {W2V}): "
          f"{wall:.2f} s wall; vocabulary {len(words)} types in "
          f"{stats['vocab_s']:.2f} s, pairs in {stats['pairs_s']:.2f} s "
          f"(host clock); step loop {steps} steps ({stats['n_blocks']} blocks "
          f"x {W2V['numIter']} epochs) in {stats['loop_s']:.2f} s: "
          f"{steps / stats['loop_s']:.0f} steps/s, "
          f"{steps * B / stats['loop_s']:.0f} pairs/s; device time per step "
          f"{stats['loop_device_ms'] / steps:.4f} ms (CUDA events around the "
          f"loop); {launches} sgns_block_grads launches; peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    if launches != steps or steps != stats["n_blocks"] * W2V["numIter"]:
        fail(f"sgns_block_grads launched {launches} times on the Word2Vec "
             f"path, expected one per step ({steps})")
    if vecs.shape != (len(words), W2V["vectorSize"]) \
            or not np.isfinite(vecs).all():
        fail("the Word2Vec model table has bad vectors")

    os.environ[SGNS_KERNEL_ENV] = "0"
    try:
        plain_model, plain_wall = train_word2vec(table)
    finally:
        del os.environ[SGNS_KERNEL_ENV]
    plain = model_vectors(plain_model)
    gap = float(np.abs(vecs - plain).max())
    print(f"word2vec table vs the ALINK_SGNS_PALLAS=0 route "
          f"({plain_wall:.2f} s wall): same words "
          f"{list(plain_model.col('word')) == words}, max|Δ| {gap:.3g} "
          f"(tol {TABLE_ATOL}; max|table| {float(np.abs(plain).max()):.3g})",
          flush=True)
    if list(plain_model.col("word")) != words or not gap <= TABLE_ATOL:
        fail(f"the kernel route's table differs from the plain route's "
             f"({gap})")
    ops = step_operations(docs[:OPS_DOCS])
    share = topic_share(words, vecs)
    print(f"learning gate: in-topic share of the top-10 neighbours of "
          f"vocabulary rows 100..1099 = {share:.4f} (chance 0.01, floor "
          f"{TOPIC_FLOOR})", flush=True)
    if not share >= TOPIC_FLOOR:
        fail(f"Word2Vec did not learn the topics ({share} < {TOPIC_FLOOR})")

    path = os.path.join(workdir, "word2vec.ak")
    AkSinkBatchOp(filePath=path, overwriteSink=True).link_from(
        TableSourceBatchOp(model)).collect()
    model_src = AkSourceBatchOp(filePath=path)
    loaded = model_src.collect()
    # .ak keeps a vector as text of 6 significant digits (both packages)
    back = model_vectors(loaded, np.float64)
    ak_err = float((np.abs(back - vecs) / np.maximum(np.abs(vecs),
                                                      1e-30)).max())
    print(f"word2vec model through .ak ({os.path.getsize(path) / 1e6:.1f} "
          f"MB): largest relative change of a vector entry {ak_err:.3g} "
          f"(6 significant digits: ≤ 5e-6)", flush=True)
    if list(loaded.col("word")) != words or not ak_err <= 5.001e-6:
        fail("the Word2Vec model changed through .ak")
    lookup = dict(zip(words, back))
    requests = text8_corpus(max(W2V_REQUEST_ROWS) * SENTENCE, SEED + 1)
    rates = {}
    for n in W2V_REQUEST_ROWS:
        req = MTable({"doc": np.asarray(requests[:n], object)})
        t0 = time.perf_counter()
        out = Word2VecPredictBatchOp(
            selectedCol="doc", predictionCol="v").link_from(
            model_src, TableSourceBatchOp(req)).collect()
        dt = time.perf_counter() - t0
        got = np.stack([np.asarray(v.data) for v in out.col("v")])
        want = np.stack([np.mean([lookup[w] for w in d.split(" ")
                                  if w in lookup], axis=0)
                         for d in requests[:min(n, 100)]])
        err = float(np.abs(got[:len(want)] - want).max())
        rates[n] = n / dt
        print(f"word2vec predict {n:5d} sentences: {dt * 1e3:.1f} ms end to "
              f"end (the mapper's model load included; the .ak file was "
              f"read once above), {n / dt:.0f} rows/s; first "
              f"{len(want)} rows vs numpy mean of the table's rows: max|Δ| "
              f"{err:.3g}", flush=True)
        if out.num_rows != n or got.shape[1] != W2V["vectorSize"] \
                or not np.isfinite(got).all() or not err <= 1e-6:
            fail(f"word2vec request of {n} sentences: bad output table")
    return launches, dict(stats, wall_s=wall, plain_wall_s=plain_wall,
                          steps_per_s=steps / stats["loop_s"],
                          operations=ops, vocab=len(words), table_gap=gap,
                          topic_share=share, peak_gib=peak / 2**30,
                          predict_rows_per_s=rates)


# ---------------------------------------------------------------------------
# phase 10: BERT training
# ---------------------------------------------------------------------------


TRAIN_SEQ, TRAIN_BATCH = 128, 32    # bench.py's SEQ and PER_CHIP_BATCH
TRAIN_WARMUP, TRAIN_REPS, TRAIN_STEPS = 3, 3, 10   # 3 + 30 timed steps
TRAIN_LR, TRAIN_WD = 2e-5, 0.01     # bench.py: optax.adamw(2e-5, 0.01)
KERNEL_TRAIN = dict(seq=512, batch=32, block=128, steps=5)
BWD_FP32_REL = 1e-4                 # of the plain route's largest entry
LOSS_ROUTE_ATOL = 2 * LOGIT_ATOL    # kernel vs plain route training losses
# phase 10.4: the operator's fine-tune on data/sst2_mini.csv
SST2 = dict(maxSeqLength=32, numEpochs=20, batchSize=32, learningRate=1e-3,
            randomSeed=0)
# alink_tpu's holdout accuracy at these settings on the CPU, 8 virtual
# devices (81 of 101 rows;
# tests/test_torch_train_e2e.py::test_sst2_holdout_accuracy_of_both_packages)
SST2_REFERENCE_ACC = 0.8020
SST2_FLOOR = SST2_REFERENCE_ACC - 0.05


def layer_matmul_params(cfg) -> int:
    """Weights of the encoder layers' products: 12 · (4·h² + 2·h·i) =
    84,934,656 at BERT-base."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    return cfg.num_layers * (4 * h * h + 2 * h * i)


def train_step_flops(cfg, batch, seq) -> float:
    """Model FLOPs of one training step: 6 · (layer product weights) ·
    tokens, plus attention's two products, 4·B·S²·h a layer forward and
    twice that backward: 12 · L · B · S² · h."""
    tokens = batch * seq
    return 6.0 * layer_matmul_params(cfg) * tokens \
        + 12.0 * cfg.num_layers * batch * seq * seq * cfg.hidden_size


def route_grads(q, k, v, mask, ct, block_size, causal=False, views=False):
    """``blockwise_attention`` forward and backward on the current route,
    with the cotangent ``ct``; ``views``: q, k and v as ``unbind`` views of
    one (B, S, 3, H, D) tensor, as the main path hands them over. Returns
    the output and (dq, dk, dv)."""
    import torch

    from alink_tpu_torch.dl.attention import blockwise_attention

    if views:
        base = torch.stack((q, k, v), dim=2).detach().requires_grad_()
        qq, kk, vv = base.unbind(dim=2)
        leaves = (base,)
    else:
        qq, kk, vv = leaves = tuple(x.detach().requires_grad_()
                                    for x in (q, k, v))
    out = blockwise_attention(qq, kk, vv, mask, block_size=block_size,
                              causal=causal)
    grads = torch.autograd.grad(out, leaves, ct)
    return out.detach(), (grads[0].unbind(dim=2) if views else grads)


def backward_mismatch(q, k, v, mask, ct, got, block_size, causal=False):
    """Holds ``got`` = (dq, dk, dv) of the kernel route against the plain
    route's autograd (``ALINK_ATTN_PALLAS=0``) on the same inputs and
    cotangent. Returns the raw max |Δ| of each and the worst error over its
    bound (> 1 fails). fp32: 1e-4 of the plain gradient's largest entry.
    bf16: 2**-6 · (|g| + g_abs) element by element, where g_abs is the
    gradient's formula on absolute values, P the plain softmax (uniform on
    a fully masked row): dv_abs = Pᵀ|dO|; A = P∘(|dO|·|V|ᵀ + rowsum(|dO∘O|));
    dq_abs = scale·A·|K|; dk_abs = scale·Aᵀ·|Q| (module docstring)."""
    import torch

    _, ref = plain_route(route_grads, q, k, v, mask, ct, block_size, causal)
    if any(a.shape != r.shape or not bool(torch.isfinite(a).all())
           for a, r in zip(got, ref)):
        return dict.fromkeys("qkv", float("nan")), float("inf")
    errs = [(a.float() - r.float()).abs() for a, r in zip(got, ref)]
    raw = {n: float(e.max()) for n, e in zip("qkv", errs)}
    if q.dtype != torch.bfloat16:
        return raw, max(float(e.max()) / (BWD_FP32_REL * float(
            r.float().abs().max()) + 1e-30) for e, r in zip(errs, ref))
    scale = q.shape[-1] ** -0.5
    qh, kh, vh, dh = (x.transpose(1, 2).float() for x in (q, k, v, ct))
    sc = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    ok = (mask[:, None, None, :] > 0).expand_as(sc)
    if causal:
        ok = ok & torch.ones(sc.shape[-2:], dtype=torch.bool,
                             device=sc.device).tril()
    p = torch.softmax(torch.where(ok, sc, NEG), dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vh)
    a = p * (torch.einsum("bhqd,bhkd->bhqk", dh.abs(), vh.abs())
             + (dh * o).abs().sum(-1, keepdim=True))
    g_abs = (scale * torch.einsum("bhqk,bhkd->bhqd", a, kh.abs()),
             scale * torch.einsum("bhqk,bhqd->bhkd", a, qh.abs()),
             torch.einsum("bhqk,bhqd->bhkd", p, dh.abs()))
    del sc, ok, p, a
    worst = 0.0
    for e, r, ga in zip(errs, ref, g_abs):
        bound = 2 * BF16_ULP * (r.float().abs() + ga.transpose(1, 2))
        worst = max(worst, worst_ratio(e, bound))
    return raw, worst


def check_backward(peaks):
    """Phase 10.1: the flash route's backward against the plain route's
    autograd at (B, S, H, D) = (32, 512, 12, 64), blocks of 128, bf16 and
    fp32, on the forward's cases (fully masked batch row, causal, ragged S =
    500, the main path's views), with a seeded N(0, 1) cotangent; then
    forward + backward and backward alone timed on both routes, and SDPA's
    forward + backward over the same attention as a yardstick."""
    import torch

    s = SLICE
    B, H, D, bs = s["B"], s["H"], s["D"], s["K"]
    errors = {}
    for dt in (torch.bfloat16, torch.float32):
        for label, S, causal, views in FUSED_CASES:
            q, k, v, mask = attn_inputs(B, S, H, D, dt, SEED)
            g = np.random.default_rng(SEED + S)
            ct = torch.tensor(g.standard_normal((B, S, H, D), np.float32),
                              device="cuda").to(dt)
            _, got = route_grads(q, k, v, mask, ct, bs, causal, views)
            raw, worst = backward_mismatch(q, k, v, mask, ct, got, bs, causal)
            name = f"backward {str(dt)[6:]} [{label}]"
            print(f"{name} kernel route vs plain route's autograd: max|Δ| " +
                  " ".join(f"d{n}={x:.3g}" for n, x in raw.items()) +
                  f"; worst error/bound {worst:.3g}", flush=True)
            if not worst <= 1.0:
                fail(f"{name} outside its tolerance")
            errors[name] = max(raw.values())

    S = s["Q"]
    q, k, v, mask = attn_inputs(B, S, H, D, torch.bfloat16, SEED)
    ct = torch.randn((B, S, H, D), device="cuda", dtype=torch.bfloat16,
                     generator=torch.Generator(device="cuda").manual_seed(SEED))
    fwd_bwd = lambda: route_grads(q, k, v, mask, ct, bs, views=True)  # noqa: E731
    base = torch.stack((q, k, v), dim=2).detach().requires_grad_()

    def bwd_only():
        from alink_tpu_torch.dl.attention import blockwise_attention

        out = blockwise_attention(*base.unbind(dim=2), mask, block_size=bs)
        return lambda: torch.autograd.grad(out, base, ct, retain_graph=True)

    t = [plain_route(cuda_ms, fwd_bwd), cuda_ms(fwd_bwd), cuda_ms(fwd_bwd),
         plain_route(cuda_ms, fwd_bwd)]
    bwd = [plain_route(lambda: cuda_ms(bwd_only())),
           cuda_ms(bwd_only()), cuda_ms(bwd_only()),
           plain_route(lambda: cuda_ms(bwd_only()))]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (torch.randn((B, H, S, D), device="cuda",
                              dtype=torch.bfloat16, requires_grad=True)
                  for _ in range(3))
    cts = ct.transpose(1, 2)
    lib = cuda_ms(lambda: torch.autograd.grad(sdpa(qs, ks, vs), (qs, ks, vs),
                                              cts))
    row = dict(fwd_bwd_ms=(t[1] + t[2]) / 2, fwd_bwd_plain_ms=(t[0] + t[3]) / 2,
               bwd_ms=(bwd[1] + bwd[2]) / 2,
               bwd_plain_ms=(bwd[0] + bwd[3]) / 2, library_fwd_bwd_ms=lib,
               fwd_bwd_turns=t, bwd_turns=bwd, errors=errors)
    print(f"flash route forward + backward bf16 (B, S, H, D) = ({B}, {S}, "
          f"{H}, {D}), block {bs}, views: kernel route "
          f"{row['fwd_bwd_ms']:.4f} ms (backward alone {row['bwd_ms']:.4f}), "
          f"plain route {row['fwd_bwd_plain_ms']:.4f} ms (backward alone "
          f"{row['bwd_plain_ms']:.4f}); turns plain,kernel,kernel,plain "
          f"{[round(x, 4) for x in t]} / {[round(x, 4) for x in bwd]}; "
          f"yardstick: scaled_dot_product_attention forward + backward "
          f"{lib:.4f} ms (contiguous, unmasked)", flush=True)
    return row


def bert_train_setup(seq, batch, block=0, device="cuda"):
    """bench.py's fine-tune: BERT-base, 2 labels, dropout 0, bf16 compute
    with fp32 parameters, freshly initialised from SEED, AdamW at a
    constant 2e-5 with weight decay 0.01, ids and labels from
    ``np.random.RandomState(0)``, all-ones mask. Returns (model, step,
    batch dict, y)."""
    import torch

    from alink_tpu_torch.dl.modules import BertConfig, TransformerEncoder
    from alink_tpu_torch.dl.train import (Optimizer, loss_fn,
                                          make_train_step)

    cfg = BertConfig.base(num_labels=2, dropout=0.0,
                          attention_block_size=block)
    model = TransformerEncoder(cfg).to(device).init_weights(SEED)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    y = rng.randint(0, 2, batch).astype(np.int32)
    opt = Optimizer("adamw", lambda count: TRAIN_LR,
                    dict(model.named_parameters()), TRAIN_WD)
    step = make_train_step(model, opt, loss_fn("softmax", False))
    tb = {"input_ids": torch.tensor(ids, device=device),
          "attention_mask": torch.ones((batch, seq), dtype=torch.int32,
                                       device=device)}
    return model, step, tb, torch.tensor(y, device=device)


def time_split(step, tb, y, steps=2):
    """Device ms a step by kernel group over ``steps`` profiled steps
    (``torch.profiler``, CUDA activity): the products (cuBLAS), the flash
    kernel, the optimizer's multi-tensor kernels, the rest; their sum
    (``busy``) and the 8 kernels of most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(tb, y)
        torch.cuda.synchronize()
    groups = {"products": 0.0, "flash kernel": 0.0, "optimizer": 0.0,
              "other": 0.0}
    top = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
            continue
        name = ev.key.lower()
        ms = ev.self_device_time_total / 1e3 / steps
        if "flash" in name:
            key = "flash kernel"
        elif any(t in name for t in ("gemm", "cutlass", "xmma", "nvjet",
                                     "cublas", "matmul")):
            key = "products"
        elif "multi_tensor" in name or "foreach" in name:
            key = "optimizer"
        else:
            key = "other"
        groups[key] += ms
        top.append((ms, ev.count / steps, ev.key[:60]))
    groups["busy"] = sum(groups.values())
    groups["top"] = [(round(ms, 3), n, k) for ms, n, k in sorted(top)[-8:]]
    return groups


def train_metric_of_record(peaks):
    """Phase 10.2: bench.py's configuration (seq 128, batch 32, full
    attention) through the port's one-step function: 3 warm-up steps, then
    3 repeats of 10 timed steps on the same batch (host clock, synced).
    Returns samples/s, ms a step (median of the repeats), peak memory, MFU,
    the losses and the device time split."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    model, step, tb, y = bert_train_setup(TRAIN_SEQ, TRAIN_BATCH)
    losses = [step(tb, y) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    reps = []
    for _ in range(TRAIN_REPS):
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            losses.append(step(tb, y))
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) / TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    split = time_split(step, tb, y)
    ms = float(np.median(reps)) * 1e3
    flops = train_step_flops(model.cfg, TRAIN_BATCH, TRAIN_SEQ)
    mfu = flops / (ms / 1e3) / peaks[1]
    split["idle_share"] = 1.0 - split["busy"] / ms
    row = dict(samples_per_s=TRAIN_BATCH / (ms / 1e3), ms_per_step=ms,
               ms_per_step_repeats=[r * 1e3 for r in reps],
               peak_gib=peak / 2**30, mfu=mfu, step_tflop=flops / 1e12,
               loss_first=losses[0], loss_last=losses[-1],
               steps=len(losses), device_ms_by_group=split)
    print(f"BERT-base fine-tune step (bench.py's configuration: seq "
          f"{TRAIN_SEQ}, batch {TRAIN_BATCH}, bf16 compute, fp32 params, "
          f"AdamW {TRAIN_LR} wd {TRAIN_WD}, full attention): "
          f"{row['samples_per_s']:.1f} samples/s, {ms:.2f} ms a step "
          f"(median of {TRAIN_REPS} repeats of {TRAIN_STEPS}: "
          f"{[round(r * 1e3, 2) for r in reps]}); peak device memory "
          f"{row['peak_gib']:.2f} GiB; {flops / 1e12:.3f} TFLOP a step, MFU "
          f"{mfu:.4f} of {peaks[1] / 1e12:.0f} TFLOP/s; loss {losses[0]:.4f} "
          f"at step 1, {losses[-1]:.4f} at step {len(losses)}; device ms a "
          f"step by group (torch.profiler) " +
          ", ".join(f"{k} {v}" for k, v in split.items()), flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"BERT-base training loss not finite or not falling: "
             f"{losses[0]} -> {losses[-1]}")
    return row


def train_kernel_route():
    """Phase 10.3: the same model on the flash kernel's route
    (attentionBlockSize 128) at seq 512, batch 32: 5 steps with the launch
    counter (12 a step: one per layer's attention, the backward launches
    none), then 5 steps of the plain route from the same weights and batch;
    the losses agree within LOSS_ROUTE_ATOL (bf16: cross-entropy moves by
    at most twice the largest logit change, and the routes' logits agree
    within LOGIT_ATOL, phase 4). Returns the launches and ms a step."""
    import torch

    from alink_tpu_torch.native import kernels

    kt = KERNEL_TRAIN
    model, step, tb, y = bert_train_setup(kt["seq"], kt["batch"], kt["block"])
    init = {n: t.detach().clone() for n, t in model.state_dict().items()}
    out = {}
    for route in ("kernel", "plain"):
        if route == "plain":
            del model, step
            model, step, tb, y = bert_train_setup(kt["seq"], kt["batch"],
                                                  kt["block"])
            model.load_state_dict(init)
            os.environ["ALINK_ATTN_PALLAS"] = "0"
        try:
            kernels.reset_launches()
            torch.cuda.synchronize()
            losses, marks = [], []
            for _ in range(kt["steps"]):
                losses.append(step(tb, y))
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
            launches = kernels.launches()["flash_block_update"]
            split = time_split(step, tb, y)
        finally:
            os.environ.pop("ALINK_ATTN_PALLAS", None)
        ms = (marks[-1] - marks[0]) / (len(marks) - 1) * 1e3
        split["idle_share"] = 1.0 - split["busy"] / ms
        out[route] = dict(losses=[float(x) for x in losses],
                          launches=launches, ms_per_step=ms,
                          device_ms_by_group=split)
    gap = max(abs(a - b) for a, b in zip(out["kernel"]["losses"],
                                         out["plain"]["losses"]))
    print(f"BERT-base training on the flash route (seq {kt['seq']}, batch "
          f"{kt['batch']}, attentionBlockSize {kt['block']}): "
          f"{out['kernel']['launches']} flash_block_update launches in "
          f"{kt['steps']} steps; ms a step kernel route "
          f"{out['kernel']['ms_per_step']:.1f}, plain route "
          f"{out['plain']['ms_per_step']:.1f}; losses kernel "
          f"{[round(x, 5) for x in out['kernel']['losses']]}, plain "
          f"{[round(x, 5) for x in out['plain']['losses']]}, max|Δ| "
          f"{gap:.3g} (tol {LOSS_ROUTE_ATOL}); device ms a step by group "
          f"(torch.profiler) kernel route " + ", ".join(
              f"{k} {v}" for k, v in out["kernel"]["device_ms_by_group"]
              .items()) + "; plain route " + ", ".join(
              f"{k} {v}" for k, v in out["plain"]["device_ms_by_group"]
              .items()), flush=True)
    expect = model.cfg.num_layers * kt["steps"]
    if out["kernel"]["launches"] != expect or out["plain"]["launches"] != 0:
        fail(f"flash_block_update launched {out['kernel']['launches']} times "
             f"in {kt['steps']} training steps, expected {expect} (12 a step)")
    if not all(np.isfinite(out["kernel"]["losses"])) \
            or not gap <= LOSS_ROUTE_ATOL:
        fail(f"training losses of the kernel and plain routes differ by {gap}")
    return dict(out, loss_gap=gap)


def finetune_sst2(workdir):
    """Phase 10.4: ``BertTextClassifierTrainBatchOp`` on the sst2_mini train
    split (``sst2_split(seed=0)``), from ``data/bert_tiny_sst`` and from
    scratch (``bertSize="tiny"``), predicted on the holdout through
    ``BertTextClassifierPredictBatchOp``; the pretrained run must reach
    SST2_FLOOR, and its model, written to ``.ak`` and read back, must
    predict identically."""
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.dl.data import data_path, sst2_split
    from alink_tpu_torch.operator.batch import (
        AkSinkBatchOp, AkSourceBatchOp, BertTextClassifierPredictBatchOp,
        BertTextClassifierTrainBatchOp, TableSourceBatchOp)

    tr_t, tr_y, ho_t, ho_y = sst2_split(seed=0)
    train = TableSourceBatchOp(MTable({"text": tr_t, "label": tr_y}))
    hold = TableSourceBatchOp(MTable({"text": ho_t, "label": ho_y}))

    def predict(model_op):
        out = BertTextClassifierPredictBatchOp(
            predictionCol="p", predictionDetailCol="d").link_from(
            model_op, hold).collect()
        return np.asarray(out.col("p")), list(out.col("d"))

    res = {}
    for label, extra in (("pretrained", dict(
            checkpointFilePath=data_path("bert_tiny_sst"))),
            ("scratch", dict(bertSize="tiny"))):
        t0 = time.perf_counter()
        model = BertTextClassifierTrainBatchOp(
            textCol="text", labelCol="label", **SST2, **extra).link_from(
            train).collect()
        wall = time.perf_counter() - t0
        pred, detail = predict(TableSourceBatchOp(model))
        res[label] = dict(acc=float(np.mean(pred == ho_y)), train_s=wall)
        if label == "pretrained":
            path = os.path.join(workdir, "bert_sst2.ak")
            AkSinkBatchOp(filePath=path, overwriteSink=True).link_from(
                TableSourceBatchOp(model)).collect()
            back, back_detail = predict(AkSourceBatchOp(filePath=path))
            same = bool(np.array_equal(back, pred) and back_detail == detail)
    print(f"sst2_mini fine-tune through the operators ({len(tr_t)} train, "
          f"{len(ho_t)} holdout rows, {SST2}): pretrained from "
          f"data/bert_tiny_sst accuracy {res['pretrained']['acc']:.4f} "
          f"(floor {SST2_FLOOR:.4f}; {res['pretrained']['train_s']:.1f} s), "
          f"from scratch {res['scratch']['acc']:.4f} "
          f"({res['scratch']['train_s']:.1f} s); .ak round trip predicts "
          f"identically: {same}", flush=True)
    if not res["pretrained"]["acc"] >= SST2_FLOOR:
        fail(f"the pretrained fine-tune's holdout accuracy "
             f"{res['pretrained']['acc']} is below {SST2_FLOOR}")
    if not same:
        fail("the fine-tuned model predicts otherwise after .ak")
    return res


# ---------------------------------------------------------------------------
# phase 11: the classical BSP path (KMeans, the optimizers, the pipeline)
# ---------------------------------------------------------------------------
IRIS_SCHEMA = "sl double, sw double, pl double, pw double, species string"
IRIS_FEATURES = ["sl", "sw", "pl", "pw"]
# alink_tpu's figures on the CPU (8 virtual devices, as the tests run it),
# measured by tests/test_torch_pipeline.py::test_reference_figures
IRIS_REFERENCE_PURITY = 134 / 150
DIGITS_REFERENCE_ACC = 346 / 360
DIGITS_SLACK = 0.02
CENTROID_ATOL = 1e-4       # iris centroids, card against the CPU route
CENTROID_RTOL = 1e-4       # 11.2, relative to the largest centroid entry
SOFTMAX_SPREAD_FACTOR = 10  # 11.3, card vs CPU, in permutation spreads
SOFTMAX_PERMUTATIONS = 2    # CPU fits on permuted rows that set the spread
SOFTMAX_GATE_L2 = 1e-3      # 11.3's weight gate fits with a minimizer
ROW_CALLS = 20             # predict_row calls timed
KMEANS_REAL = dict(k=10, maxIter=50)
SOFTMAX_ITERS = 30         # bench.py's maxIter
SOFTMAX_ROWS = (20_000, 60_000)
SPARSE_ROWS, SPARSE_DIM, SPARSE_ITERS = 300, 1_000_000, 20
CLASSICAL_CASES = (
    ("11.1 KMeans iris through Pipeline", "bench.py:246-279"),
    ("11.2 KMeans 60,000 x 784, k=10", "chip_smoke.mnist_layout"),
    ("11.3 Softmax n=20,000 and 60,000 x 784 x 10, L-BFGS",
     "bench.py:281-350"),
    ("11.4 sparse LR, 300 rows x 1,000,000 dims",
     "examples/sparse_highdim_logistic.py"),
)


class torch_device:
    """Run the port's entry points on ``name`` inside the block (the port
    reads ``ALINK_TORCH_DEVICE`` at each call)."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.old = os.environ.get("ALINK_TORCH_DEVICE")
        os.environ["ALINK_TORCH_DEVICE"] = self.name

    def __exit__(self, *exc):
        if self.old is None:
            del os.environ["ALINK_TORCH_DEVICE"]
        else:
            os.environ["ALINK_TORCH_DEVICE"] = self.old


def purity(pred, truth) -> float:
    """bench.py's cluster purity: the share of rows in their class's most
    common cluster."""
    pred, truth = np.asarray(pred), np.asarray(truth)
    return float(sum(np.unique(pred[truth == s], return_counts=True)[1].max()
                     for s in np.unique(truth)) / len(pred))


def fit_mismatch(got, want, got_iters, want_iters, tol, relative=False):
    """Why the card's fit (``got``, ``got_iters``) is not the CPU route's,
    or None: the iteration counts must be equal and the arrays within
    ``tol`` (of the CPU route's largest entry when ``relative``)."""
    if got_iters != want_iters:
        return f"numIters {got_iters} on the card, {want_iters} on the CPU"
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return f"shape {got.shape} on the card, {want.shape} on the CPU"
    err = float(np.abs(got - want).max())
    if relative:
        err /= max(float(np.abs(want).max()), 1e-30)
    if not err <= tol:
        return f"max |Δ|{' (relative)' if relative else ''} {err:.3g} > {tol}"
    return None


def rel_dist(got, want) -> float:
    """max |got − want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def softmax_weight_gate(W, iters, Wc, cpu_iters, permuted, controls):
    """11.3's check of the card's Softmax weights ``W`` (``iters``
    iterations) against the CPU route's ``Wc`` (``cpu_iters``).
    ``permuted``: the CPU route's weights on the rows permuted; the largest
    of their distances from ``Wc`` is the spread of the summation order
    alone, and the card must lie within SOFTMAX_SPREAD_FACTOR spreads of
    ``Wc`` with equal numIters. ``controls``: {name: (weights, iters)} of
    wrong routes on the card, each of which the gate must reject.
    Returns (tolerance, problems)."""
    tol = SOFTMAX_SPREAD_FACTOR * max(rel_dist(P, Wc) for P in permuted)
    problems = [p for p in (fit_mismatch(W, Wc, iters, cpu_iters, tol,
                                         relative=True),) if p]
    for name, (Wx, ix) in controls.items():
        if fit_mismatch(Wx, Wc, ix, cpu_iters, tol, relative=True) is None:
            problems.append(f"the gate ({tol:.3g}) does not reject the "
                            f"{name} route ({rel_dist(Wx, Wc):.3g}, "
                            f"numIters {ix})")
    return tol, problems


def below_floor(value, floor, what):
    """Why ``value`` fails its floor, or None."""
    if not value >= floor:
        return f"{what} {value} is below {floor}"
    return None


def count_syncs(fn):
    """(fn(), host syncs): the synchronizing CUDA calls made while ``fn``
    runs, as ``torch.cuda.set_sync_debug_mode`` reports them (reads of a
    device value and blocking copies, staging pushes included)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def device_profile(fn, warm_s):
    """Device activities (kernels and copies), their busy ms and the traced
    wall of one run of ``fn`` under ``torch.profiler``; the idle share is
    1 − busy / ``warm_s``, the untraced warm wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA
           and ev.self_device_time_total > 0]
    busy_ms = sum(ev.self_device_time_total for ev in evs) / 1e3
    return dict(operations=int(sum(ev.count for ev in evs)),
                busy_ms=busy_ms, traced_wall_ms=wall * 1e3,
                idle_share=max(0.0, 1.0 - busy_ms / (warm_s * 1e3)))


def timed(fn):
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def iris_path(workdir, problems):
    """11.1, BASELINE #1 as bench.py:246-279 runs it: KMeans(k=3,
    maxIter=50) through Pipeline on data/iris.csv, fit + transform +
    collect cold and warm; purity against species; save → load →
    LocalPredictor; predict_row latency; the CPU route's centroids and
    numIters."""
    from alink_tpu_torch.common.model import table_to_model
    from alink_tpu_torch.operator.batch import CsvSourceBatchOp
    from alink_tpu_torch.pipeline import (KMeans, LocalPredictor, Pipeline,
                                          PipelineModel)

    here = os.path.dirname(os.path.abspath(__file__))
    src = CsvSourceBatchOp(filePath=os.path.join(here, "data", "iris.csv"),
                           schemaStr=IRIS_SCHEMA)

    def fit_once():
        model = Pipeline(KMeans(k=3, maxIter=50, featureCols=IRIS_FEATURES,
                                predictionCol="pred")).fit(src)
        return model, model.transform(src).collect()

    cold, _ = timed(fit_once)
    warm, (model, out) = timed(fit_once)
    meta, arrays = table_to_model(model.stages[0].get_model_data())
    with torch_device("cpu"):
        cpu_model, cpu_out = fit_once()
    cmeta, carrays = table_to_model(cpu_model.stages[0].get_model_data())
    pred = np.asarray(out.col("pred"))
    pur = purity(pred, out.col("species"))
    path = os.path.join(workdir, "iris_kmeans.ak")
    model.save(path)
    table = src.collect()
    lp = LocalPredictor(PipelineModel.load(path), IRIS_SCHEMA)
    served = np.asarray(lp.predict_table(table).col("pred"))
    rows = table.to_rows()
    lat = []
    for i in range(ROW_CALLS):
        t0 = time.perf_counter()
        lp.predict_row(rows[i * 7 % len(rows)])
        lat.append(time.perf_counter() - t0)
    res = dict(wall_cold_s=cold, wall_warm_s=warm,
               num_iters=meta["numIters"], cpu_num_iters=cmeta["numIters"],
               purity=pur, reference_purity=IRIS_REFERENCE_PURITY,
               centroid_max_abs_err=float(np.abs(
                   arrays["centroids"] - carrays["centroids"]).max()),
               local_predictor_same=bool(np.array_equal(served, pred)),
               predict_row_median_ms=float(np.median(lat)) * 1e3)
    print(f"11.1 KMeans iris through Pipeline: cold {cold:.3f} s, warm "
          f"{warm:.3f} s, numIters {res['num_iters']} (CPU route "
          f"{res['cpu_num_iters']}), purity {pur:.4f} (reference "
          f"{IRIS_REFERENCE_PURITY:.4f}), centroids within "
          f"{res['centroid_max_abs_err']:.2e} of the CPU route; save → load "
          f"→ LocalPredictor same predictions: "
          f"{res['local_predictor_same']}; predict_row median "
          f"{res['predict_row_median_ms']:.3f} ms of {ROW_CALLS}",
          flush=True)
    for p in (fit_mismatch(arrays["centroids"], carrays["centroids"],
                           meta["numIters"], cmeta["numIters"],
                           CENTROID_ATOL),
              None if abs(pur - IRIS_REFERENCE_PURITY) < 1e-12 else
              f"purity {pur} is not the reference's {IRIS_REFERENCE_PURITY}",
              None if res["local_predictor_same"] else
              "LocalPredictor on the saved model predicts otherwise"):
        if p:
            problems.append(f"11.1: {p}")
    return res


def kmeans_real_path(problems):
    """11.2: KMeans k=10, maxIter=50, default tolerance on 60,000 seeded
    MNIST-layout rows of 784 columns: walls, numIters, inertia, host syncs
    and device operations of a fit, idle share; centroids against the
    CPU route."""
    from alink_tpu_torch.common.model import table_to_model
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import (KMeansTrainBatchOp,
                                                TableSourceBatchOp)
    from alink_tpu_torch.operator.batch.clustering import _kmeanspp_init

    X, _ = mnist_layout(WIDE_ROWS, SEED)
    feats = [f"p{i}" for i in range(X.shape[1])]
    src = TableSourceBatchOp(MTable({f: X[:, i] for i, f in
                                     enumerate(feats)}))
    del X

    def fit():
        return table_to_model(KMeansTrainBatchOp(
            featureCols=feats, **KMEANS_REAL).link_from(src).collect())

    cold, _ = timed(fit)
    warm, (meta, arrays) = timed(fit)
    _, syncs = count_syncs(fit)
    prof = device_profile(fit, warm)
    # the host's share: k-means++ seeding on a 10,000-row sample, numpy
    block = src.collect().to_numeric_block(feats)
    t0 = time.perf_counter()
    _kmeanspp_init(block, KMEANS_REAL["k"], 0)
    seed_s = time.perf_counter() - t0
    with torch_device("cpu"):
        t0 = time.perf_counter()
        cmeta, carrays = fit()
        cpu_s = time.perf_counter() - t0
    c, cc = arrays["centroids"], carrays["centroids"]
    res = dict(rows=WIDE_ROWS, cols=len(feats), wall_cold_s=cold,
               wall_warm_s=warm, num_iters=meta["numIters"],
               cpu_num_iters=cmeta["numIters"], inertia=meta["inertia"],
               cpu_inertia=cmeta["inertia"], host_syncs_per_fit=syncs,
               centroid_rel_err=float(np.abs(c - cc).max()
                                      / np.abs(cc).max()),
               cpu_route_s=cpu_s, kmeanspp_seed_s=seed_s, **prof)
    print(f"11.2 KMeans {WIDE_ROWS} x {len(feats)} MNIST-layout, k=10: cold "
          f"{cold:.3f} s, warm {warm:.3f} s, numIters {res['num_iters']} "
          f"(CPU route {res['cpu_num_iters']}, {cpu_s:.1f} s), inertia "
          f"{res['inertia']:.6g} (CPU {res['cpu_inertia']:.6g}), centroids "
          f"within {res['centroid_rel_err']:.2e} of the largest entry; a "
          f"warm fit: {syncs} host syncs, {prof['operations']} device "
          f"operations, {prof['busy_ms']:.1f} ms busy, idle share "
          f"{prof['idle_share']:.3f}; on the host k-means++ seeding "
          f"{seed_s:.3f} s",
          flush=True)
    p = fit_mismatch(c, cc, meta["numIters"], cmeta["numIters"],
                     CENTROID_RTOL, relative=True)
    if p:
        problems.append(f"11.2: {p}")
    return res


def softmax_table(n):
    """bench.py's seeded Softmax problem (:295-300): 784 N(0, 1) features, 10
    classes from a random linear rule plus noise."""
    from alink_tpu_torch.common.mtable import MTable

    rng = np.random.default_rng(1)
    d, k = 784, 10
    W_true = rng.normal(size=(d, k)).astype(np.float32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ W_true + 0.5 * rng.normal(size=(n, k))).argmax(1)
    cols = {f"p{i}": X[:, i] for i in range(d)}
    cols["label"] = y.astype(np.int64)
    return MTable(cols), [f"p{i}" for i in range(d)]


def softmax_path(n, problems, check_cpu):
    """11.3 at n rows: SoftmaxTrainBatchOp(maxIter=30) + SoftmaxPredictBatchOp
    as bench.py runs them, cold and warm (min of 2); samples/s =
    n·30 / warm wall; host syncs of a fit; device busy time and idle share
    of a fit + predict; with ``check_cpu`` the numIters against the CPU
    route's, and the weights of a fit with l2 = SOFTMAX_GATE_L2 against
    the CPU route's (``softmax_weight_gate``)."""
    import torch

    from alink_tpu_torch.common.model import table_to_model
    from alink_tpu_torch.operator.batch import (SoftmaxPredictBatchOp,
                                                SoftmaxTrainBatchOp,
                                                TableSourceBatchOp)

    table, feats = softmax_table(n)
    src = TableSourceBatchOp(table)

    def train():
        return SoftmaxTrainBatchOp(featureCols=feats, labelCol="label",
                                   maxIter=SOFTMAX_ITERS).link_from(src)

    def run_once():
        model = train()
        return model, SoftmaxPredictBatchOp().link_from(model, src).collect()

    cold, _ = timed(run_once)
    w1, (model, out) = timed(run_once)
    w2, _ = timed(run_once)
    warm = min(w1, w2)
    meta, arrays = table_to_model(model.collect())
    fit_s, _ = timed(lambda: train().collect())
    _, syncs = count_syncs(lambda: train().collect())
    prof = device_profile(run_once, warm)
    acc = float(np.mean(np.asarray(out.col("pred"))
                        == np.asarray(table.col("label"))))
    res = dict(rows=n, wall_cold_s=cold, wall_warm_s=warm,
               samples_per_s=n * SOFTMAX_ITERS / warm,
               samples_per_s_cold=n * SOFTMAX_ITERS / cold,
               num_iters=meta["numIters"], train_acc=acc,
               fit_warm_s=fit_s, host_syncs_per_fit=syncs, **prof)
    line = (f"11.3 Softmax n={n} x 784 x 10, maxIter {SOFTMAX_ITERS}: cold "
            f"{cold:.3f} s, warm {warm:.3f} s, {res['samples_per_s']:.1f} "
            f"samples/s (cold {res['samples_per_s_cold']:.1f}), numIters "
            f"{res['num_iters']}, train accuracy {acc:.4f}; a fit: "
            f"{fit_s:.3f} s, {syncs} host syncs; fit + predict: "
            f"{prof['operations']} device "
            f"operations, {prof['busy_ms']:.1f} ms busy, idle share "
            f"{prof['idle_share']:.3f}")
    if check_cpu:
        def weights(source, **kw):
            m, a = table_to_model(
                SoftmaxTrainBatchOp(featureCols=feats, labelCol="label",
                                    maxIter=SOFTMAX_ITERS, **kw)
                .link_from(source).collect())
            return a["weights"], m["numIters"]

        gated = dict(l2=SOFTMAX_GATE_L2)
        W, iters = weights(src, **gated)
        controls = {}
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            controls["TF32"] = weights(src, **gated)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        wire = os.environ.get("ALINK_WIRE_PRECISION")
        os.environ["ALINK_WIRE_PRECISION"] = "bf16"
        try:
            controls["bf16 wire"] = weights(src, **gated)
        finally:
            if wire is None:
                del os.environ["ALINK_WIRE_PRECISION"]
            else:
                os.environ["ALINK_WIRE_PRECISION"] = wire
        with torch_device("cpu"):
            t0 = time.perf_counter()
            W0c, cpu_iters0 = weights(src)
            res["cpu_route_s"] = time.perf_counter() - t0
            Wc, cpu_iters = weights(src, **gated)
            permuted = [weights(TableSourceBatchOp(table.take(
                np.random.default_rng(SEED + r).permutation(n))), **gated)
                for r in range(SOFTMAX_PERMUTATIONS)]
        tol, problems_w = softmax_weight_gate(
            W, iters, Wc, cpu_iters, [P for P, _ in permuted], controls)
        res.update(
            cpu_num_iters=cpu_iters0,
            weight_rel_err=rel_dist(arrays["weights"], W0c),
            gate=dict(l2=SOFTMAX_GATE_L2, num_iters=iters,
                      cpu_num_iters=cpu_iters, weight_rel_err=rel_dist(W, Wc),
                      tol=tol,
                      cpu_permuted=[dict(rel_err=rel_dist(P, Wc),
                                         num_iters=i) for P, i in permuted],
                      controls={k: dict(rel_err=rel_dist(Wx, Wc),
                                        num_iters=i)
                                for k, (Wx, i) in controls.items()}))
        g = res["gate"]
        line += (f"; CPU route numIters {cpu_iters0} "
                 f"({res['cpu_route_s']:.1f} s), weights "
                 f"{res['weight_rel_err']:.3g} of the largest apart "
                 f"(not gated: no minimizer); with l2 {SOFTMAX_GATE_L2}: "
                 f"numIters {iters} (CPU {cpu_iters}), weights within "
                 f"{g['weight_rel_err']:.3g} of the largest of the CPU "
                 f"route's, gate {tol:.3g} = {SOFTMAX_SPREAD_FACTOR} x the "
                 f"CPU route's on permuted rows ("
                 + ", ".join(f"{d['rel_err']:.3g} in {d['num_iters']}"
                             for d in g["cpu_permuted"])
                 + "); wrong routes on the card: "
                 + ", ".join(f"{k} {d['rel_err']:.3g} in {d['num_iters']}"
                             for k, d in g["controls"].items()))
        if meta["numIters"] != cpu_iters0:
            problems.append(f"11.3 n={n}: numIters {meta['numIters']} on "
                            f"the card, {cpu_iters0} on the CPU")
        problems += [f"11.3 n={n}, l2 {SOFTMAX_GATE_L2}: {p}"
                     for p in problems_w]
    print(line, flush=True)
    return res


def digits_holdout(problems):
    """11.3's accuracy as bench.py measures it: data/digits.csv, the 80/20
    split of ``shuffle(seed=0)``, Softmax maxIter=60."""
    from alink_tpu_torch.operator.batch import (CsvSourceBatchOp,
                                                SoftmaxPredictBatchOp,
                                                SoftmaxTrainBatchOp,
                                                TableSourceBatchOp)

    here = os.path.dirname(os.path.abspath(__file__))
    dcols = [f"p{i}" for i in range(64)]
    digits = CsvSourceBatchOp(
        filePath=os.path.join(here, "data", "digits.csv"),
        schemaStr=", ".join(f"{c} double" for c in dcols)
        + ", label long").collect()
    tr, te = digits.shuffle(seed=0).split_at(int(digits.num_rows * 0.8))
    model = SoftmaxTrainBatchOp(featureCols=dcols, labelCol="label",
                                maxIter=60).link_from(TableSourceBatchOp(tr))
    pred = SoftmaxPredictBatchOp().link_from(
        model, TableSourceBatchOp(te)).collect()
    acc = float(np.mean(np.asarray(pred.col("pred"))
                        == np.asarray(te.col("label"))))
    floor = DIGITS_REFERENCE_ACC - DIGITS_SLACK
    print(f"11.3 digits holdout ({tr.num_rows} train, {te.num_rows} test, "
          f"maxIter 60): accuracy {acc:.4f} (reference "
          f"{DIGITS_REFERENCE_ACC:.4f}, floor {floor:.4f})", flush=True)
    p = below_floor(acc, floor, "digits holdout accuracy")
    if p:
        problems.append(f"11.3: {p}")
    return acc


def sparse_table():
    """examples/sparse_highdim_logistic.py's problem: 300 rows of 8 seeded
    non-zeros in 1,000,000 dimensions, the label carried by dimension 0."""
    from alink_tpu_torch.common.linalg import SparseVector
    from alink_tpu_torch.common.mtable import MTable, TableSchema

    rng = np.random.default_rng(0)
    cells, labels = [], []
    for _ in range(SPARSE_ROWS):
        label = int(rng.integers(2))
        idx = np.sort(rng.choice(SPARSE_DIM, size=8, replace=False))
        val = rng.normal(size=8)
        val[0] = (1.0 if label else -1.0) + 0.1 * rng.normal()
        idx[0] = 0
        cells.append(SparseVector(SPARSE_DIM, np.sort(idx), val))
        labels.append(label)
    return MTable({"vec": np.asarray(cells, object),
                   "label": np.asarray(labels, np.int64)},
                  TableSchema(["vec", "label"], ["SPARSE_VECTOR", "LONG"]))


def sparse_path(problems):
    """11.4: the sparse route, LR on 1,000,000-dimensional SparseVectors;
    accuracy and numIters equal to the CPU route's, and the device's peak
    memory above its resident set far under a dense block's."""
    import torch

    from alink_tpu_torch.common.model import table_to_model
    from alink_tpu_torch.operator.batch import (
        LogisticRegressionPredictBatchOp, LogisticRegressionTrainBatchOp,
        TableSourceBatchOp)

    t = sparse_table()
    src = TableSourceBatchOp(t)

    def fit_predict():
        model = LogisticRegressionTrainBatchOp(
            vectorCol="vec", labelCol="label", maxIter=SPARSE_ITERS,
            standardization=False).link_from(src)
        out = LogisticRegressionPredictBatchOp(vectorCol="vec").link_from(
            model, src).collect()
        acc = float(np.mean(np.asarray(out.col("pred"))
                            == np.asarray(t.col("label"))))
        return acc, table_to_model(model.collect())[0]["numIters"]

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    wall, (acc, iters) = timed(fit_predict)
    peak = torch.cuda.max_memory_allocated() - base
    with torch_device("cpu"):
        cpu_acc, cpu_iters = fit_predict()
    dense = SPARSE_ROWS * SPARSE_DIM * 4
    res = dict(wall_s=wall, accuracy=acc, cpu_accuracy=cpu_acc,
               num_iters=iters, cpu_num_iters=cpu_iters,
               peak_bytes_above_resident=int(peak), dense_block_bytes=dense)
    print(f"11.4 sparse LR {SPARSE_ROWS} x {SPARSE_DIM}, maxIter "
          f"{SPARSE_ITERS}: {wall:.3f} s, accuracy {acc:.4f} (CPU route "
          f"{cpu_acc:.4f}), numIters {iters} (CPU {cpu_iters}), peak device "
          f"memory {peak / 1e6:.1f} MB above the resident set (a dense block "
          f"is {dense / 1e6:.0f} MB)", flush=True)
    for p in (None if acc == cpu_acc else
              f"accuracy {acc} on the card, {cpu_acc} on the CPU",
              None if iters == cpu_iters else
              f"numIters {iters} on the card, {cpu_iters} on the CPU",
              None if peak < dense else
              f"peak {peak} bytes reaches a dense block's {dense}"):
        if p:
            problems.append(f"11.4: {p}")
    return res


def staging_key_cost():
    """What a content key of the staging cache would cost against the push
    it saves, on the 60,000 × 784 float32 MNIST-layout block: a blake2b
    digest of the block on the host (the reference's key), and one push of
    it to the card (``push_block``, synced). Best of 3 each."""
    import torch

    from alink_tpu_torch.common.staging import push_block

    X, _ = mnist_layout(WIDE_ROWS, SEED)
    digest, push = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        hashlib.blake2b(X.view(np.uint8).reshape(-1).data,
                        digest_size=16).hexdigest()
        digest.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        push_block(X, "cuda")
        torch.cuda.synchronize()
        push.append(time.perf_counter() - t0)
    res = dict(bytes=X.nbytes, digest_s=min(digest), push_s=min(push))
    print(f"phase 11 staging key: a {X.shape[0]} x {X.shape[1]} float32 "
          f"block ({X.nbytes / 1e6:.1f} MB): blake2b digest "
          f"{res['digest_s']:.4f} s ({X.nbytes / 1e6 / res['digest_s']:.0f}"
          f" MB/s) on the host, push to the card {res['push_s']:.4f} s "
          f"({X.nbytes / 1e6 / res['push_s']:.0f} MB/s)", flush=True)
    return res


def classical_path(workdir):
    """Phase 11: every case of CLASSICAL_CASES; any failed gate fails the
    run after all have been reported. Returns their numbers."""
    from alink_tpu_torch.common.staging import (clear_staging_cache,
                                                staging_cache_stats)

    problems = []
    print("phase 11, the classical path: " + "; ".join(
        f"{label} ({source})" for label, source in CLASSICAL_CASES),
        flush=True)
    clear_staging_cache()
    out = dict(iris=iris_path(workdir, problems),
               kmeans_60000=kmeans_real_path(problems))
    out["softmax"] = [softmax_path(n, problems, check_cpu=n == 20_000)
                      for n in SOFTMAX_ROWS]
    out["digits_holdout_acc"] = digits_holdout(problems)
    out["sparse"] = sparse_path(problems)
    st = staging_cache_stats()
    out["staging"] = dict(hits=st["hits"], misses=st["misses"],
                          uncached=st["uncached"],
                          wire_bytes_sent=st["wire_bytes_sent"],
                          key_cost=staging_key_cost())
    print(f"phase 11 staging cache: {st['hits']} hits, {st['misses']} "
          f"misses, {st['uncached']} uncached pushes, "
          f"{st['wire_bytes_sent'] / 1e6:.0f} MB sent", flush=True)
    print("phase 11: " + json.dumps(out), flush=True)
    if problems:
        fail("phase 11: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# phase 12: model families (quantized serving, impurity trees, the tree
# encoder, KerasSequential)
# ---------------------------------------------------------------------------

QUANT_BAND = 0.005          # the reference's ServingConfig.quant_band
QUANT_TOL = 0.05            # ... and quant_tol (serving/router.py:123-124)
POLICIES = ("bf16", "int8")
CALIB_ROWS = 1_024          # real training rows of the calibration pass
SOFTMAX_REQUEST_ROWS = 5_000  # 12.2's requests: 15.7 MB, under 16 MiB
IMPURITY_OPS = (("Cart", "gini"), ("C45", "infoGainRatio"),
                ("Id3", "infoGain"))
IMPURITY = dict(maxDepth=12, maxBins=HIST_BINS, minSamplesPerLeaf=5)
IMPURITY_CHECK = dict(maxDepth=8, maxBins=HIST_BINS, minSamplesPerLeaf=5)
IMPURITY_CHECK_ROWS = 60_000
# Keras's mnist_mlp example (Dense 512 relu, Dropout 0.2, twice); the op
# adds the head of the label count
KERAS_LAYERS = ["Dense(512, activation=relu)", "Dropout(0.2)",
                "Dense(512, activation=relu)", "Dropout(0.2)"]
KERAS_DIGITS = dict(numEpochs=20, batchSize=128, learningRate=1e-3,
                    randomSeed=0)
KERAS_DIGITS_REFERENCE_ACC = 354 / 360  # tests/test_torch_keras_digits.py
KERAS_MNIST = dict(numEpochs=2, batchSize=128, learningRate=1e-3)
# 12.5(c): dropout 0, a BatchNorm after each Dense, gelu so that the
# activation's form is on the checked path
KERAS_BN_LAYERS = ["Dense(512, activation=gelu)", "BatchNorm()",
                   "Dropout(0.0)", "Dense(512, activation=gelu)",
                   "BatchNorm()", "Dropout(0.0)"]
KERAS_BN_TRAIN = dict(num_epochs=1, batch_size=128, learning_rate=0.01,
                      optimizer="sgd", seed=0, log_every=1, feed="sync")
KERAS_LOSS_ATOL = 1e-5      # the loss history, card vs CPU route
KERAS_STATS_RTOL = 2e-3     # debiased running statistics, card vs CPU
KERAS_PROBE_ATOL = 2e-5     # one training-mode forward from the init


def band_report(base, cand):
    """The reference's accuracy band of output table ``cand`` against the
    fp32 table ``base`` (label columns agree on all but QUANT_BAND of the
    rows, numeric columns within QUANT_TOL relative, detail JSON
    skipped)."""
    from alink_tpu_torch.common.quant import accuracy_band_report

    return accuracy_band_report(list(base.rows()), list(cand.rows()),
                                list(cand.schema.types), band=QUANT_BAND,
                                tol=QUANT_TOL)


def flash_rise_problem(launches, chunks, layers, label):
    """Why the flash kernel's launches do not show one launch per attention
    call (``layers`` per forward chunk), or None."""
    if launches != chunks * layers:
        return (f"{label}: flash_block_update launched {launches} times, "
                f"expected {chunks * layers} ({layers} per forward chunk)")
    return None


def dequant_mismatch(model, served):
    """Largest |Δ| between the int8 state the card serves, dequantized as
    its forward does (``q.float() * s``), and the reference's arithmetic on
    the host: ``quantize_tree`` of the flax variables, each leaf's q times
    its per-last-axis scale, carried to the state layout. 0 unless a scale
    sits on the wrong axis or the quantization differs."""
    import torch

    from alink_tpu_torch.common.quant import dequantize, quantize_tree
    from alink_tpu_torch.dl.convert import from_flax, to_flax

    q_tree, s_tree = quantize_tree(to_flax(model))

    def deq(q, s):
        if isinstance(q, dict):
            return {k: deq(q[k], s[k]) for k in q}
        return np.asarray(q, np.float32) if s is None else dequantize(q, s)

    want = from_flax(model, deq(q_tree, s_tree))
    worst = 0.0
    for name, (q, s) in served.items():
        got = (q if s is None else q.float() * s).cpu()
        if got.shape != want[name].shape:
            return float("inf")
        worst = max(worst, float((got - want[name].to(got.dtype)).abs()
                                 .max()) if got.numel() else 0.0)
    return worst


def quantized_bert(served_main):
    """12.1: phase 4's BERT-base table served under bf16 and int8 through
    ``BertTextClassifierPredictBatchOp`` on the 64-row request."""
    import torch

    from alink_tpu_torch.dl.train import (_int8_state, predict_model,
                                          served_state)
    from alink_tpu_torch.native import kernels
    from alink_tpu_torch.operator.batch import (
        AkSourceBatchOp, BertTextClassifierPredictBatchOp,
        BertTextModelMapper, TableSourceBatchOp)

    request, base = served_main["request"], served_main["out"]
    model_src = AkSourceBatchOp(filePath=served_main["path"])
    n = request.num_rows
    chunks = -(-n // 256)
    mapper = BertTextModelMapper(None, request.schema, None)
    mapper.load_model(model_src.collect())
    model = mapper.model
    layers = model.cfg.num_layers
    enc = mapper.tokenizer.encode_batch(
        list(request.col("text")), max_len=int(mapper.meta["maxSeqLength"]))
    out, problems = {}, []
    for policy in POLICIES:
        kernels.reset_launches()
        t0 = time.perf_counter()
        table = BertTextClassifierPredictBatchOp(
            predictionCol="pred", predictionDetailCol="detail",
            inferencePrecision=policy).link_from(
            model_src, TableSourceBatchOp(request)).collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launches()["flash_block_update"]
        p = flash_rise_problem(launches, chunks, layers, f"12.1 {policy}")
        if p:
            problems.append(p)
        band = band_report(base, table)
        if not band["ok"]:
            problems.append(f"12.1 {policy}: outside the band {band}")
        logits = predict_model(model, enc, precision=policy)
        plain = plain_route(lambda: predict_model(model, enc,
                                                  precision=policy))
        err = float(np.abs(logits - plain).max())
        if not (np.isfinite(logits).all() and err <= LOGIT_ATOL):
            problems.append(f"12.1 {policy}: logits {err} from the plain "
                            f"route (tol {LOGIT_ATOL})")
        out[policy] = dict(launches=launches, request_s=wall, band=band,
                           plain_route_max_abs_err=err)
        served_main.setdefault("policy_tables", {})[policy] = table
    fp32 = predict_model(model, enc)
    for policy in POLICIES:
        out[policy]["logits_vs_fp32_max_abs"] = float(np.abs(
            predict_model(model, enc, precision=policy) - fp32).max())
    worst = dequant_mismatch(model, served_state(model, "int8"))
    out["int8"]["dequant_vs_host_max_abs"] = worst
    if worst != 0.0:
        problems.append(f"12.1 int8: served weights {worst} from the "
                        "host's quantize_tree")
    for turn in range(2):
        for policy in (None,) + POLICIES:
            out.setdefault("forward_ms", {}).setdefault(
                policy or "fp32", []).append(
                forward_ms(model, enc, precision=policy))
    for policy in (None,) + POLICIES:    # device busy time of one forward
        warm = min(out["forward_ms"][policy or "fp32"]) / 1e3
        out.setdefault("forward_profile", {})[policy or "fp32"] = \
            device_profile(lambda: predict_model(model, enc,
                                                 precision=policy), warm)
    # the host's part of an int8 load: quantize_tree and the carry back
    out["int8"]["state_build_s"], _ = timed(lambda: _int8_state(model))
    return out, problems


def linear_policies():
    """12.2: the Softmax model of phase 11.3's configuration at n = 60,000
    (fitted again here) served at fp32, bf16 and int8, calibrated on
    CALIB_ROWS training rows, in requests of SOFTMAX_REQUEST_ROWS rows: a
    block under the mapper's STREAM_THRESHOLD_BYTES takes the single
    staged push, the only route where int8 is the W8A8 product, so their
    int8 scores must move from fp32's (the chunked route scores fp32 under
    int8, as the reference's does, and the whole 60,000-row int8 request
    must equal fp32's). Then the card's int32 accumulators against the
    plain version's (``int8_matmul_ref``: exact sums on the host)."""
    import torch

    from alink_tpu_torch.common import quant
    from alink_tpu_torch.common.model import table_to_model
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.common.params import Params
    from alink_tpu_torch.operator.batch import (LinearModelMapper,
                                                SoftmaxPredictBatchOp,
                                                SoftmaxTrainBatchOp,
                                                TableSourceBatchOp)

    n = SOFTMAX_ROWS[-1]
    table, feats = softmax_table(n)
    src = TableSourceBatchOp(table)
    model = SoftmaxTrainBatchOp(featureCols=feats, labelCol="label",
                                maxIter=SOFTMAX_ITERS).link_from(src).collect()
    site = "softmax"
    calib = {}
    with quant.calibration(calib):
        SoftmaxPredictBatchOp(quantSite=site).link_from(
            TableSourceBatchOp(model),
            TableSourceBatchOp(table.take(np.arange(CALIB_ROWS)))).collect()
    out, problems = {"calib": calib}, []
    block_bytes = SOFTMAX_REQUEST_ROWS * len(feats) * 4
    if block_bytes >= LinearModelMapper.STREAM_THRESHOLD_BYTES:
        problems.append(f"12.2: requests of {block_bytes} bytes take the "
                        "chunked route")
    parts = [TableSourceBatchOp(table.slice(i, i + SOFTMAX_REQUEST_ROWS))
             for i in range(0, n, SOFTMAX_REQUEST_ROWS)]

    def serve(extra, sources):      # the request's output columns only
        return MTable.concat([SoftmaxPredictBatchOp(
            predictionCol="pred", predictionDetailCol="detail",
            reservedCols=[], **extra).link_from(
            TableSourceBatchOp(model), part).collect() for part in sources])

    tables, whole = {}, {}
    for policy in (None,) + POLICIES:
        extra = {} if policy is None else dict(
            inferencePrecision=policy, quantCalib=calib, quantSite=site)
        walls = []
        for _ in range(2):
            wall, tables[policy] = timed(lambda: serve(extra, parts))
            walls.append(wall)
        out[policy or "fp32"] = dict(rows_per_s=n / min(walls),
                                     walls_s=walls,
                                     requests=len(parts))
        if policy != "bf16":
            whole[policy] = serve(extra, [src])
    for policy in POLICIES:
        band = band_report(tables[None], tables[policy])
        out[policy]["band"] = band
        if not band["ok"]:
            problems.append(f"12.2 {policy}: outside the band {band}")
    moved = sum(a != b for a, b in zip(tables[None].col("detail"),
                                       tables["int8"].col("detail")))
    out["int8"]["rows_moved_from_fp32"] = int(moved)
    if not moved:
        problems.append("12.2: the int8 requests scored as fp32 (no W8A8)")
    unequal = sum(a != b for a, b in zip(whole[None].col("detail"),
                                         whole["int8"].col("detail")))
    out["int8"]["chunked_rows_unequal_to_fp32"] = int(unequal)
    if unequal:
        problems.append(f"12.2: the chunked route scored {unequal} rows of "
                        "the whole int8 request otherwise than fp32")
    _, arrays = table_to_model(model)
    wq, _ = quant.quantize_per_channel(arrays["weights"])
    X = np.stack([np.asarray(table.col(f), np.float32) for f in feats], 1)
    sx = torch.tensor(quant.calib_scale(Params(quantCalib=calib),
                                        site + ".x"),
                      dtype=torch.float32, device="cuda")
    xq = quant.quantize_act(torch.as_tensor(X, device="cuda"), sx)
    wq_t = torch.as_tensor(wq, device="cuda")
    acc = quant.int8_matmul(xq, wq_t)
    want = quant.int8_matmul_ref(xq.cpu(), wq_t.cpu())
    out["int8"]["accumulators"] = dict(shape=list(acc.shape),
                                       unequal=accumulator_mismatch(acc, want))
    if out["int8"]["accumulators"]["unequal"]:
        problems.append(f"12.2: {out['int8']['accumulators']['unequal']} "
                        "int32 accumulators differ from the plain version")
    out["int8"]["int_mm_ms"] = cuda_ms(lambda: quant.int8_matmul(xq, wq_t))
    return out, problems


def accumulator_mismatch(got, want) -> int:
    """Entries of the card's int32 accumulators unequal to the plain
    version's."""
    got = got.cpu()
    if got.shape != want.shape or got.dtype != want.dtype:
        return max(got.numel(), want.numel())
    return int((got != want).sum())


def tree_mismatch(a, b):
    """Heap nodes whose split feature or raw threshold differ between two
    ensembles (both must have one tree of one depth)."""
    if a.feats.shape != b.feats.shape:
        return [-1]
    return np.nonzero((a.feats != b.feats) | (a.thrs != b.thrs))[1].tolist()


def leaf_ids_numpy(ens, X):
    """(n, T) leaf index of every row in every tree: the reference
    encoder's numpy traversal (alink_tpu/operator/batch/tree.py:393-406)."""
    n = X.shape[0]
    ids = np.zeros((n, ens.feats.shape[0]), np.int64)
    for t, (f, thr) in enumerate(zip(ens.feats, ens.thrs)):
        node = np.zeros(n, np.int64)
        pos = np.zeros(n, np.int64)
        for _ in range(ens.depth):
            fs, ts = f[pos], thr[pos]
            x = X[np.arange(n), np.maximum(fs, 0)]
            right = (~((fs < 0) | (x <= ts))).astype(np.int64)
            node = node * 2 + right
            pos = 2 * pos + 1 + right
        ids[:, t] = node
    return ids


def impurity_trees(X, y):
    """12.3: Cart, C45 and Id3 through the ops on the Covertype cell, the
    first IMPURITY_CHECK_ROWS rows at maxDepth 8 on the card and the CPU
    route (identical trees), and the held-out rows served at fp32, bf16 and
    int8 (int8 routes as fp32: its scores are the dequantized leaves at
    fp32's leaf ids, within half a scale step of fp32's)."""
    import torch

    import alink_tpu_torch.operator.batch as B
    from alink_tpu_torch.common.model import table_to_model
    from alink_tpu_torch.common.quant import quantize_last_axis
    from alink_tpu_torch.tree import TreeEnsemble

    n_tr = COVTYPE_TRAIN
    X_test, y_test = X[n_tr:], y[n_tr:]
    test = covertype_table(X_test, y_test)
    out, problems = {}, []
    check = covertype_table(X[:IMPURITY_CHECK_ROWS], y[:IMPURITY_CHECK_ROWS])
    full = covertype_table(X[:n_tr], y[:n_tr])
    for name, criterion in IMPURITY_OPS:
        train_op = getattr(B, f"{name}TrainBatchOp")
        model, wall = train_trees(train_op, IMPURITY, full)
        card, _ = train_trees(train_op, IMPURITY_CHECK, check)
        with torch_device("cpu"):
            cpu = train_op(labelCol="label", **IMPURITY_CHECK).link_from(
                B.TableSourceBatchOp(check)).collect()
        ens = [TreeEnsemble.from_arrays(*table_to_model(m))
               for m in (model, card, cpu)]
        diff = tree_mismatch(ens[1], ens[2])
        if diff:
            problems.append(f"12.3 {name}: {len(diff)} nodes differ from "
                            f"the CPU route (first {diff[0]})")
        scores, walls, preds = {}, {}, {}
        for policy in (None,) + POLICIES:
            extra = {} if policy is None else {"inferencePrecision": policy}
            walls[policy or "fp32"], t = timed(
                lambda: getattr(B, f"{name}PredictBatchOp")(
                    predictionCol="pred", **extra).link_from(
                    B.TableSourceBatchOp(model),
                    B.TableSourceBatchOp(test)).collect())
            preds[policy] = np.asarray(t.col("pred"))
            scores[policy] = ens[0].raw_predict(X_test, precision=policy)
        acc = float(np.mean(preds[None] == y_test))
        lq, ls = quantize_last_axis(ens[0].leaves)
        deq = lq.astype(np.float32) * ls[..., None]
        ids = ens[0].leaf_ids(X_test)[:, 0]
        routed = float(np.abs(scores["int8"][:, 0] - deq[0, 0, ids]
                              - ens[0].base_score[0]).max())
        dq_err = float(np.abs(scores["int8"] - scores[None]).max())
        # half a scale step, plus the fp32 roundings of q·s and of w / s
        dq_bound = float(ls.max()) / 2 + 2.0 ** -22 * float(
            np.abs(ens[0].leaves).max())
        if routed != 0.0 or not dq_err <= dq_bound:
            problems.append(f"12.3 {name} int8: routed {routed}, "
                            f"|Δ| {dq_err} vs its bound {dq_bound}")
        bf_err = float(np.abs(scores["bf16"] - scores[None]).max())
        if not bf_err <= 2.0 ** -8 * float(np.abs(ens[0].leaves).max()):
            problems.append(f"12.3 {name} bf16: |Δ| {bf_err}")
        out[name] = dict(criterion=criterion, train_s=wall,
                         check_nodes_differing=len(diff),
                         check_split_nodes=int((ens[1].feats >= 0).sum()),
                         serve_s=walls, held_out_acc=acc,
                         int8_max_abs=dq_err, int8_bound=dq_bound,
                         bf16_max_abs=bf_err)
    return out, problems


def gbdt_encoder(gbdt_model, X, y):
    """12.4: the held-out rows encoded with phase 7's GBDT through
    ``GbdtEncoderPredictBatchOp``; leaf ids against ``leaf_ids_numpy``."""
    from alink_tpu_torch.common.model import table_to_model
    from alink_tpu_torch.operator.batch import (GbdtEncoderPredictBatchOp,
                                                TableSourceBatchOp)
    from alink_tpu_torch.tree import TreeEnsemble

    X_test = X[COVTYPE_TRAIN:]
    ens = TreeEnsemble.from_arrays(*table_to_model(gbdt_model))
    wall, enc = timed(lambda: GbdtEncoderPredictBatchOp(
        encodeOutputCol="leaf").link_from(
        TableSourceBatchOp(gbdt_model),
        TableSourceBatchOp(covertype_table(X_test, y[COVTYPE_TRAIN:])))
        .collect())
    leaves = ens.leaves.shape[-1]
    T = ens.feats.shape[0]
    got = np.stack([np.asarray(v.indices) for v in enc.col("leaf")]) \
        - np.arange(T) * leaves
    want = leaf_ids_numpy(ens, X_test)
    unequal = int((got != want).sum()) if got.shape == want.shape \
        else want.size
    problems = [f"12.4: {unequal} leaf ids differ from the numpy "
                "traversal"] if unequal else []
    dims = {v.size() for v in enc.col("leaf")}
    if dims != {T * leaves}:
        problems.append(f"12.4: encoded dimensions {dims}")
    return dict(rows=len(X_test), trees=T, dim=T * leaves, wall_s=wall,
                rows_per_s=len(X_test) / wall, unequal=unequal), problems


def digits_table():
    """data/digits.csv with bench.py's 80/20 split of ``shuffle(seed=0)``."""
    from alink_tpu_torch.operator.batch import CsvSourceBatchOp

    here = os.path.dirname(os.path.abspath(__file__))
    dcols = [f"p{i}" for i in range(64)]
    digits = CsvSourceBatchOp(
        filePath=os.path.join(here, "data", "digits.csv"),
        schemaStr=", ".join(f"{c} double" for c in dcols)
        + ", label long").collect()
    return digits.shuffle(seed=0).split_at(int(digits.num_rows * 0.8))


def keras_digits_acc():
    """12.5(a): ``KerasSequentialClassifierTrainBatchOp`` with KERAS_LAYERS
    on the digits split, holdout accuracy through the predict op."""
    from alink_tpu_torch.operator.batch import (
        KerasSequentialClassifierPredictBatchOp,
        KerasSequentialClassifierTrainBatchOp, TableSourceBatchOp)

    tr, te = digits_table()
    model = KerasSequentialClassifierTrainBatchOp(
        layers=KERAS_LAYERS, labelCol="label", **KERAS_DIGITS).link_from(
        TableSourceBatchOp(tr))
    pred = KerasSequentialClassifierPredictBatchOp(
        predictionCol="pred").link_from(model, TableSourceBatchOp(te)) \
        .collect()
    return float(np.mean(np.asarray(pred.col("pred"))
                         == np.asarray(te.col("label"))))


def debiased_stats(state, steps, momentum=0.99):
    """Each BatchNorm's running mean and var with the initial values' share
    taken out: the momentum-weighted mean of the batch statistics, which an
    unbiased batch variance moves by n/(n - 1) however few the steps."""
    keep = momentum ** steps
    out = {}
    for k, v in state.items():
        if k.endswith(".mean"):
            out[k] = v.double().cpu().numpy() / (1 - keep)
        elif k.endswith(".var"):
            out[k] = (v.double().cpu().numpy() - keep) / (1 - keep)
    return out


def keras_route(X, y, init, device, steps_per_epoch):
    """12.5(c) on one route: ``train_model`` of KERAS_BN_LAYERS from the
    carried ``init`` state; the loss history, the debiased running
    statistics, and a training-mode forward of the first batch from
    ``init`` (its logits and debiased statistics after that one step)."""
    import torch

    from alink_tpu_torch.dl.convert import keras_torch_to_flax
    from alink_tpu_torch.dl.modules import KerasSequential
    from alink_tpu_torch.dl.train import TrainConfig, train_model

    dev = torch.device(device)
    probe = KerasSequential(KERAS_BN_LAYERS, 2, X.shape[1]).to(dev)
    probe.load_state_dict(init)
    with torch.no_grad():
        logits = probe(torch.as_tensor(X[:KERAS_BN_TRAIN["batch_size"]],
                                       device=dev), deterministic=False)
    model = KerasSequential(KERAS_BN_LAYERS, 2, X.shape[1])
    state, hist = train_model(model, {"x": X}, y.astype(np.int32),
                              TrainConfig(**KERAS_BN_TRAIN), device=dev,
                              init_params=keras_torch_to_flax(init))
    return dict(loss=list(hist["loss"]),
                stats=debiased_stats(state, steps_per_epoch),
                probe_logits=logits.cpu().numpy(),
                probe_stats=debiased_stats(probe.state_dict(), 1))


def keras_route_problems(card, cpu):
    """Where the card's 12.5(c) route parts from the CPU route's: the loss
    history beyond KERAS_LOSS_ATOL, a debiased running statistic beyond
    KERAS_STATS_RTOL of its largest entry, the probe's logits beyond
    KERAS_PROBE_ATOL or its debiased statistics beyond KERAS_STATS_RTOL."""
    problems = []
    if len(card["loss"]) != len(cpu["loss"]):
        return ["loss histories of different lengths"]
    err = float(np.abs(np.subtract(card["loss"], cpu["loss"])).max())
    if not err <= KERAS_LOSS_ATOL:
        problems.append(f"loss history {err} apart")
    for kind in ("stats", "probe_stats"):
        for k, want in cpu[kind].items():
            rel = float(np.abs(card[kind][k] - want).max()
                        / np.abs(want).max())
            if not rel <= KERAS_STATS_RTOL:
                problems.append(f"{kind} {k} {rel:.3g} apart (relative)")
    err = float(np.abs(card["probe_logits"] - cpu["probe_logits"]).max())
    if not err <= KERAS_PROBE_ATOL:
        problems.append(f"probe logits {err} apart")
    return problems


def keras_path():
    """12.5: (a) the digits holdout through the ops; (b) two epochs of
    60,000 MNIST-layout rows through the ops: samples/s, ms a step, idle
    share; (c) one epoch with BatchNorm, card against the CPU route."""
    import torch

    from alink_tpu_torch.dl.modules import KerasSequential
    from alink_tpu_torch.operator.batch import (
        KerasSequentialClassifierTrainBatchOp, TableSourceBatchOp)

    out, problems = {}, []
    out["digits_acc"] = keras_digits_acc()
    p = below_floor(out["digits_acc"],
                    KERAS_DIGITS_REFERENCE_ACC - DIGITS_SLACK,
                    "12.5 digits holdout accuracy")
    if p:
        problems.append(p)

    X, y = mnist_layout(WIDE_ROWS, SEED)
    X /= 255.0                       # mnist_mlp's scaling
    cols = {f"p{i}": X[:, i] for i in range(X.shape[1])}
    cols["label"] = y
    from alink_tpu_torch.common.mtable import MTable

    src = TableSourceBatchOp(MTable(cols))

    def fit():
        return KerasSequentialClassifierTrainBatchOp(
            layers=KERAS_LAYERS, labelCol="label", **KERAS_MNIST).link_from(
            src).collect()

    cold, _ = timed(fit)
    warm, _ = timed(fit)
    steps = KERAS_MNIST["numEpochs"] * -(-WIDE_ROWS
                                         // KERAS_MNIST["batchSize"])
    prof = device_profile(fit, warm)
    out["mnist"] = dict(cold_s=cold, warm_s=warm,
                        samples_per_s=WIDE_ROWS * KERAS_MNIST["numEpochs"]
                        / warm, ms_per_step=warm / steps * 1e3, steps=steps,
                        **prof)

    init = KerasSequential(KERAS_BN_LAYERS, 2, X.shape[1]).init_weights(
        SEED).state_dict()
    spe = -(-WIDE_ROWS // KERAS_BN_TRAIN["batch_size"])
    card = keras_route(X, y, init, "cuda", spe)
    with torch_device("cpu"):
        cpu = keras_route(X, y, init, "cpu", spe)
    bad = keras_route_problems(card, cpu)
    problems += [f"12.5(c): {p}" for p in bad]
    out["bn_route"] = dict(
        loss_max_abs=float(np.abs(np.subtract(card["loss"],
                                              cpu["loss"])).max()),
        stats_max_rel=max(float(np.abs(card["stats"][k] - v).max()
                                / np.abs(v).max())
                          for k, v in cpu["stats"].items()),
        probe_max_abs=float(np.abs(card["probe_logits"]
                                   - cpu["probe_logits"]).max()),
        final_loss=card["loss"][-1], losses=len(card["loss"]))
    return out, problems


def model_families(served_main, X, y, gbdt_model, card):
    """Phase 12; any failed check fails the run after all are reported.
    Returns the numbers and 12.1's flash launches."""
    t = {}
    out, problems = {}, []
    for label, fn, args in (
            ("12.1 quantized BERT-base", quantized_bert, (served_main,)),
            ("12.2 linear", linear_policies, ()),
            ("12.3 impurity trees", impurity_trees, (X, y)),
            ("12.4 GbdtEncoder", gbdt_encoder, (gbdt_model, X, y)),
            ("12.5 KerasSequential", keras_path, ())):
        t0 = time.perf_counter()
        res, bad = fn(*args)
        t[label] = time.perf_counter() - t0
        out[label.split()[0]] = res
        problems += bad
        print(f"[{card}] phase {label} ({t[label]:.1f} s): "
              + json.dumps(res, default=str), flush=True)
    out["seconds"] = t
    if problems:
        fail("phase 12: " + "; ".join(problems))
    launches = sum(out["12.1"][p]["launches"] for p in POLICIES)
    return out, launches


# ---------------------------------------------------------------------------
# phase 13: foreign-model ingest (BASELINE #3 and #5; no kernel of the port)
# ---------------------------------------------------------------------------

RESNET_BATCH = 256          # bench.py's bench_resnet50 batch
RESNET_ROWS = 1_000         # three full batches and a 232-row tail
RESNET_SIDE = 224
F64_ROWS = 8                # rows held against float64 on the CPU
INGEST_RTOL = 1e-4          # fp32 routes vs float64, of the largest |logit|
INGEST_BF16_BAND = 0.05     # bf16 vs fp32, of the largest |logit|
ROUTE_RTOL = 2.0 ** -8      # a .pt2 route vs the module it was exported from
STREAM_ROWS = 16_384        # bench.py:549-582
STREAM_CHUNK = 4_096
STREAM_ATOL = 1e-5          # MLP scores vs the module on the CPU, fp32
INGEST_CASES = (
    ("13.1 ResNet-50 through torch.export (BASELINE #3)", "bench.py:355-513"),
    ("13.2 flax-layout ResNet-50 through dl/resnet.py",
     "alink_tpu/dl/resnet.py"),
    ("13.3 ResNet-50 as ONNX, the port's proto writer",
     "chip_smoke.onnx_resnet50"),
    ("13.4 MLP 16-64-1 stream predict (BASELINE #5)", "bench.py:549-582"),
    ("13.5 the StableHLO and SavedModel departures", "ROADMAP.md"),
)


def bench_resnet50():
    """bench.py's ResNet-50 (``_resnet50_torch``, copied: this script
    imports nothing of bench.py), 1000 classes, ``torch.manual_seed(0)``."""
    import torch
    import torch.nn as nn

    class Bottleneck(nn.Module):
        def __init__(self, cin, planes, stride=1):
            super().__init__()
            cout = planes * 4
            self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(planes)
            self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                                   padding=1, bias=False)
            self.bn2 = nn.BatchNorm2d(planes)
            self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
            self.bn3 = nn.BatchNorm2d(cout)
            self.relu = nn.ReLU()
            self.down = None
            if stride != 1 or cin != cout:
                self.down = nn.Sequential(
                    nn.Conv2d(cin, cout, 1, stride=stride, bias=False),
                    nn.BatchNorm2d(cout))

        def forward(self, x):
            identity = self.down(x) if self.down is not None else x
            out = self.relu(self.bn1(self.conv1(x)))
            out = self.relu(self.bn2(self.conv2(out)))
            out = self.bn3(self.conv3(out))
            return self.relu(out + identity)

    class ResNet50(nn.Module):
        def __init__(self, num_classes=1000):
            super().__init__()
            self.stem = nn.Sequential(
                nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False),
                nn.BatchNorm2d(64), nn.ReLU(),
                nn.MaxPool2d(3, stride=2, padding=1))
            layers = []
            cin = 64
            for planes, blocks, stride in ((64, 3, 1), (128, 4, 2),
                                           (256, 6, 2), (512, 3, 2)):
                for b in range(blocks):
                    layers.append(Bottleneck(cin, planes,
                                             stride if b == 0 else 1))
                    cin = planes * 4
            self.layers = nn.Sequential(*layers)
            self.head = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Flatten(),
                                      nn.Linear(2048, num_classes))

        def forward(self, x):
            return self.head(self.layers(self.stem(x)))

    torch.manual_seed(0)
    return ResNet50().eval()


def resnet_images(n, side=RESNET_SIDE, seed=SEED, layout="NCHW"):
    shape = (n, 3, side, side) if layout == "NCHW" else (n, side, side, 3)
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def logit_check(got, want, rtol):
    """(max |got − want|, the bound rtol · max |want|): the check passes
    when the first is at most the second."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()), float(rtol * np.abs(want).max())


def check_logits(label, got, want, rtol, problems, out):
    err, bound = logit_check(got, want, rtol)
    out[label] = dict(max_abs_err=err, bound=bound)
    if not (np.isfinite(got).all() and err <= bound):
        problems.append(f"{label}: max|Δ| {err:.4g} above {bound:.4g}")


def top1_agreement(a, b) -> int:
    return int((np.argmax(a, axis=1) == np.argmax(b, axis=1)).sum())


def image_table(X):
    from alink_tpu_torch.common.mtable import MTable

    col = np.empty(len(X), dtype=object)
    col[:] = list(X)
    return MTable({"img": col})


def serve_images(op_cls, table, **params):
    """One predict op over ``table`` on the card: the cold request (model
    load included), then the loaded mapper's warm ``map_table``: rows/s,
    peak device memory and the idle share (``torch.profiler``). Returns
    the logits and the numbers."""
    import torch

    from alink_tpu_torch.operator.batch import TableSourceBatchOp

    op = op_cls(selectedCols=["img"], outputCols=["logits"],
                predictBatchSize=RESNET_BATCH, **params).link_from(
        TableSourceBatchOp(table))
    cold, out = timed(op.collect)
    mapper = op._mapper_cache[1]
    torch.cuda.reset_peak_memory_stats()
    warm, _ = timed(lambda: mapper.map_table(table))
    peak = torch.cuda.max_memory_allocated()
    prof = device_profile(lambda: mapper.map_table(table), warm)
    logits = np.stack(list(out.col("logits")))
    return logits, dict(request_s=cold, warm_s=warm,
                        rows_per_s=table.num_rows / warm,
                        peak_gb=peak / 1e9, **prof)


def staged_rows_per_s(fn, x_dev, reps=3):
    """Rows/s of the served function on a batch already on the card."""
    import torch

    fn(x_dev)
    torch.cuda.synchronize()
    wall, _ = timed(lambda: [fn(x_dev) for _ in range(reps)])
    return reps * x_dev.shape[0] / wall


def tf32_flags():
    import torch

    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def set_tf32(on: bool):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def resnet_export_route(workdir, X, problems):
    """13.1: bench.py's ResNet-50 exported at (256, 3, 224, 224), run by the
    port's ``load_torch_fn`` on the card under float32 and bfloat16, then
    1,000 rows through ``TorchModelPredictBatchOp``. Returns the numbers,
    the model and the fp32 op's logits (13.3 is held to them)."""
    import torch

    from alink_tpu_torch.onnx import load_torch_fn
    from alink_tpu_torch.operator.batch import TorchModelPredictBatchOp

    out = {}
    model = bench_resnet50()
    x = torch.from_numpy(X[:RESNET_BATCH])
    t0 = time.perf_counter()
    ep = torch.export.export(model, (x,))
    pt2 = os.path.join(workdir, "resnet50.pt2")
    torch.export.save(ep, pt2)
    out["export_s"] = time.perf_counter() - t0
    # the float64 reference: the same seeded model exported at F64_ROWS (an
    # exported program's module() checks its batch; a module's .to() and
    # .cuda() convert the parameters it shares with its program in place,
    # so each side gets its own), on the CPU
    t0 = time.perf_counter()
    ep_check = torch.export.export(bench_resnet50(), (x[:F64_ROWS],))
    with torch.no_grad():
        ref64 = ep_check.module().to(torch.float64)(
            x[:F64_ROWS].double()).numpy()
    out["float64_s"] = time.perf_counter() - t0

    # TF32 on for cuBLAS and cuDNN, as a user's process may have it: the
    # pinned fp32 route must not use it, and must hand it back as it was
    set_tf32(True)
    try:
        t0 = time.perf_counter()
        fn32, _ = load_torch_fn(ep)
        out["load_s"] = time.perf_counter() - t0
        xd = x.cuda()
        l32 = fn32(xd)[0].cpu().numpy()
        flags = tf32_flags()
        with torch.no_grad():
            tf32 = copy.deepcopy(ep.module()).cuda()(xd)[:F64_ROWS] \
                .cpu().numpy()
    finally:
        set_tf32(False)
    if flags != (True, True):
        problems.append(f"13.1: the fp32 route left TF32 at {flags}")
    check_logits("fp32 vs float64", l32[:F64_ROWS], ref64, INGEST_RTOL,
                 problems, out)
    tf32_err, bound = logit_check(tf32, ref64, INGEST_RTOL)
    out["tf32 control"] = dict(max_abs_err=tf32_err, bound=bound)
    if tf32_err <= bound:
        problems.append(f"13.1: a TF32 run ({tf32_err:.4g}) passes the fp32 "
                        f"check ({bound:.4g}): the check cannot see TF32")

    fn16, _ = load_torch_fn(ep, dtype="bfloat16")
    l16 = fn16(xd)[0].cpu().numpy()
    check_logits("bf16 vs fp32", l16, l32, INGEST_BF16_BAND, problems, out)
    out["bf16 top-1 agreement"] = f"{top1_agreement(l16, l32)}/{len(l32)}"
    out["staged_rows_per_s"] = {"float32": staged_rows_per_s(fn32, xd),
                                "bfloat16": staged_rows_per_s(fn16, xd)}
    del fn16, xd

    table = image_table(X)
    ops = {}
    for prec in ("float32", "bfloat16"):
        logits, ops[prec] = serve_images(TorchModelPredictBatchOp, table,
                                         modelPath=pt2, precision=prec)
        if logits.shape != (RESNET_ROWS, 1000):
            problems.append(f"13.1: op logits of shape {logits.shape}")
        if prec == "float32":
            op32 = logits
            check_logits("op fp32 vs float64", logits[:F64_ROWS], ref64,
                         INGEST_RTOL, problems, out)
        else:
            check_logits("op bf16 vs op fp32", logits, op32,
                         INGEST_BF16_BAND, problems, out)
    out["op"] = ops
    return out, model, op32


def flax_resnet50_variables(rng, classes=1000, width=64):
    """A variables tree of the reference's flax ResNet-50 (``params`` and
    ``batch_stats``, flax's names and HWIO kernels) drawn from ``rng``:
    He-normal kernels; BatchNorm scales in [0.5, 1] (the last of each block
    in [0.1, 0.3], so the residual stream grows slowly), biases and means
    N(0, 0.1²), variances in [0.5, 1.5]; a head of N(0, 1/2048)."""
    params, stats = {}, {}

    def conv(kh, kw, cin, cout):
        return {"kernel": (rng.standard_normal((kh, kw, cin, cout))
                           * np.sqrt(2.0 / (kh * kw * cin)))
                .astype(np.float32)}

    def norm(c, lo=0.5, hi=1.0):
        return ({"scale": rng.uniform(lo, hi, c).astype(np.float32),
                 "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)},
                {"mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, c).astype(np.float32)})

    params["conv_init"] = conv(7, 7, 3, width)
    params["bn_init"], stats["bn_init"] = norm(width)
    cin, k = width, 0
    for i, blocks in enumerate((3, 4, 6, 3)):
        f = width * 2 ** i
        for j in range(blocks):
            p, s = {}, {}
            p["Conv_0"] = conv(1, 1, cin, f)
            p["BatchNorm_0"], s["BatchNorm_0"] = norm(f)
            p["Conv_1"] = conv(3, 3, f, f)
            p["BatchNorm_1"], s["BatchNorm_1"] = norm(f)
            p["Conv_2"] = conv(1, 1, f, 4 * f)
            p["BatchNorm_2"], s["BatchNorm_2"] = norm(4 * f, 0.1, 0.3)
            if j == 0:
                p["conv_proj"] = conv(1, 1, cin, 4 * f)
                p["norm_proj"], s["norm_proj"] = norm(4 * f)
            params[f"BottleneckBlock_{k}"], stats[f"BottleneckBlock_{k}"] = \
                p, s
            cin, k = 4 * f, k + 1
    params["head"] = {
        "kernel": (rng.standard_normal((cin, classes)) / np.sqrt(cin))
        .astype(np.float32),
        "bias": np.zeros(classes, np.float32)}
    return {"params": params, "batch_stats": stats}


def flax_resnet_route(workdir, problems):
    """13.2: dl/resnet.py's ResNet-50 from seeded flax-layout variables
    (``dl/convert.py``'s carry) on NHWC batches of 256 at fp32 and bf16,
    fp32 held against the same module on the CPU; then the bf16 module
    through ``torch.export`` → ``TorchModelPredictBatchOp``, the port's
    stand-in for the reference's StableHLO route."""
    import torch

    from alink_tpu_torch.dl.convert import resnet_flax_to_torch
    from alink_tpu_torch.dl.resnet import resnet50
    from alink_tpu_torch.operator.batch import TorchModelPredictBatchOp

    out = {}
    state = resnet_flax_to_torch(flax_resnet50_variables(
        np.random.default_rng(SEED)))
    X = resnet_images(RESNET_BATCH, seed=SEED + 1, layout="NHWC")
    x = torch.from_numpy(X)
    mods = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        m = resnet50(dtype=dtype)
        m.load_state_dict(state)
        mods[name] = m.eval()
    with torch.no_grad():
        cpu32 = mods["float32"](x[:F64_ROWS]).numpy()
        logits = {}
        for name, m in mods.items():
            m.cuda()
            xd = x.cuda()
            logits[name] = m(xd).cpu().numpy()
            out[f"{name} staged_rows_per_s"] = staged_rows_per_s(m, xd)
    check_logits("fp32 card vs CPU", logits["float32"][:F64_ROWS], cpu32,
                 INGEST_RTOL, problems, out)
    check_logits("bf16 vs fp32", logits["bfloat16"], logits["float32"],
                 INGEST_BF16_BAND, problems, out)
    out["bf16 top-1 agreement"] = \
        f"{top1_agreement(logits['bfloat16'], logits['float32'])}/" \
        f"{RESNET_BATCH}"

    t0 = time.perf_counter()
    ep = torch.export.export(mods["bfloat16"], (x.cuda(),))
    pt2 = os.path.join(workdir, "resnet50_flax.pt2")
    torch.export.save(ep, pt2)
    out["export_s"] = time.perf_counter() - t0
    served, out["op"] = serve_images(TorchModelPredictBatchOp,
                                     image_table(X), modelPath=pt2)
    check_logits(".pt2 route vs module", served, logits["bfloat16"],
                 ROUTE_RTOL, problems, out)
    return out


def onnx_resnet50(model, path):
    """Write bench.py's ResNet-50 (``model``'s weights) as an ONNX graph with
    the port's proto writer: Conv (pads, strides), BatchNormalization,
    Relu, MaxPool, Add, GlobalAveragePool, Flatten, Gemm."""
    from alink_tpu_torch.onnx import NodeProto, OnnxGraph, OnnxModel, ValueInfo
    from alink_tpu_torch.onnx.proto import AttributeProto

    inits, nodes = {}, []

    def ints(name, v):
        return AttributeProto(name, ints=tuple(int(a) for a in v))

    def add(op, inputs, name, **attrs):
        nodes.append(NodeProto(op, inputs, [name], attrs=attrs))
        return name

    def weight(name, t):
        inits[name] = t.detach().float().cpu().numpy().copy()
        return name

    def conv(x, c, name):
        p, s = c.padding[0], c.stride[0]
        return add("Conv", [x, weight(name + ".w", c.weight)], name,
                   pads=ints("pads", (p,) * 4), strides=ints("strides", (s, s)))

    def bn(x, b, name):
        return add("BatchNormalization", [
            x, weight(name + ".g", b.weight), weight(name + ".b", b.bias),
            weight(name + ".m", b.running_mean),
            weight(name + ".v", b.running_var)], name,
            epsilon=AttributeProto("epsilon", f=b.eps))

    conv0, bn0, _, pool = model.stem
    h = add("Relu", [bn(conv("x", conv0, "c0"), bn0, "bn0")], "r0")
    h = add("MaxPool", [h], "pool", kernel_shape=ints("kernel_shape", (3, 3)),
            strides=ints("strides", (2, 2)), pads=ints("pads", (1,) * 4))
    for i, blk in enumerate(model.layers):
        p = f"l{i}"
        y = add("Relu", [bn(conv(h, blk.conv1, p + "c1"), blk.bn1, p + "b1")],
                p + "r1")
        y = add("Relu", [bn(conv(y, blk.conv2, p + "c2"), blk.bn2, p + "b2")],
                p + "r2")
        y = bn(conv(y, blk.conv3, p + "c3"), blk.bn3, p + "b3")
        if blk.down is not None:
            h = bn(conv(h, blk.down[0], p + "d"), blk.down[1], p + "db")
        h = add("Relu", [add("Add", [y, h], p + "add")], p + "out")
    h = add("Flatten", [add("GlobalAveragePool", [h], "gap")], "flat")
    fc = model.head[2]
    add("Gemm", [h, weight("fc.w", fc.weight), weight("fc.b", fc.bias)],
        "logits", transB=AttributeProto("transB", i=1))
    OnnxModel(OnnxGraph(
        nodes=nodes, initializers=inits,
        inputs=[ValueInfo("x", 1, (None, 3, RESNET_SIDE, RESNET_SIDE))],
        outputs=[ValueInfo("logits", 1, (None, 1000))])).save(path)
    return len(nodes)


def onnx_route(workdir, model, X, op32, problems):
    """13.3: 13.1's ResNet-50 as ONNX through ``OnnxModelPredictBatchOp`` at
    fp32 (held to 13.1's op logits at 13.1's tolerance) and bf16."""
    from alink_tpu_torch.operator.batch import OnnxModelPredictBatchOp

    out = {}
    path = os.path.join(workdir, "resnet50.onnx")
    t0 = time.perf_counter()
    out["nodes"] = onnx_resnet50(model, path)
    out["write_s"] = time.perf_counter() - t0
    out["file_mb"] = os.path.getsize(path) / 1e6
    table = image_table(X)
    ops, logits = {}, {}
    for prec in ("float32", "bfloat16"):
        logits[prec], ops[prec] = serve_images(
            OnnxModelPredictBatchOp, table, modelPath=path, precision=prec)
    out["op"] = ops
    check_logits("ONNX fp32 vs torch.export fp32", logits["float32"], op32,
                 INGEST_RTOL, problems, out)
    check_logits("ONNX bf16 vs ONNX fp32", logits["bfloat16"],
                 logits["float32"], INGEST_BF16_BAND, problems, out)
    return out


def stream_mlp_route(workdir, problems):
    """13.4: BASELINE #5 as bench.py:549-582 runs it — the MLP 16→64→1 from
    ``torch.manual_seed(0)``, exported at (4, 16); 16,384 seeded rows
    through ``TableSourceStreamOp(chunkSize=4096)`` →
    ``TorchModelPredictStreamOp(predictBatchSize=4096)`` → ``collect()``,
    cold and warm; then the same MLP as ONNX through
    ``OnnxModelPredictStreamOp``. Scores held against the module on the
    CPU within STREAM_ATOL."""
    import torch
    import torch.nn as nn

    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.onnx import NodeProto, OnnxGraph, OnnxModel, ValueInfo
    from alink_tpu_torch.onnx.proto import AttributeProto
    from alink_tpu_torch.operator.stream import (OnnxModelPredictStreamOp,
                                                 TableSourceStreamOp,
                                                 TorchModelPredictStreamOp)

    torch.manual_seed(0)
    model = nn.Sequential(nn.Linear(16, 64), nn.ReLU(),
                          nn.Linear(64, 1)).eval()
    pt2 = os.path.join(workdir, "mlp.pt2")
    torch.export.save(torch.export.export(model, (torch.randn(4, 16),)), pt2)
    tb = AttributeProto("transB", i=1)
    w = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    onnx = os.path.join(workdir, "mlp.onnx")
    OnnxModel(OnnxGraph(
        nodes=[NodeProto("Gemm", ["x", "0.weight", "0.bias"], ["h"],
                         attrs={"transB": tb}),
               NodeProto("Relu", ["h"], ["r"]),
               NodeProto("Gemm", ["r", "2.weight", "2.bias"], ["score"],
                         attrs={"transB": tb})],
        initializers=w, inputs=[ValueInfo("x", 1, (None, 16))],
        outputs=[ValueInfo("score", 1, (None, 1))])).save(onnx)

    X = np.random.RandomState(0).randn(STREAM_ROWS, 16).astype(np.float64)
    cols = {f"f{i}": X[:, i] for i in range(16)}
    with torch.no_grad():
        want = model(torch.from_numpy(X.astype(np.float32))).numpy()[:, 0]
    out = {}
    for label, op_cls, path in (("torch", TorchModelPredictStreamOp, pt2),
                                ("onnx", OnnxModelPredictStreamOp, onnx)):
        def run():
            src = TableSourceStreamOp(MTable(cols), chunkSize=STREAM_CHUNK)
            return op_cls(modelPath=path,
                          selectedCols=[f"f{i}" for i in range(16)],
                          outputCols=["score"],
                          predictBatchSize=STREAM_CHUNK).link_from(
                src).collect()

        cold, _ = timed(run)
        warm, res = timed(run)
        got = np.asarray(res.col("score"))
        err = float(np.abs(got - want).max()) if got.shape == want.shape \
            else float("inf")
        out[label] = dict(rows_per_s=STREAM_ROWS / warm,
                          rows_per_s_cold=STREAM_ROWS / cold,
                          max_abs_err=err)
        if not err <= STREAM_ATOL:
            problems.append(f"13.4 {label}: scores {err:.4g} from the "
                            f"module (atol {STREAM_ATOL})")
    return out


def departures(problems):
    """13.5: ``StableHloModelPredictBatchOp`` raises on the card as designed
    (a jax.export artifact runs only on XLA); the SavedModel route needs
    TensorFlow to load, which that machine lacks, so it is not driven."""
    from alink_tpu_torch.common.exceptions import \
        AkUnsupportedOperationException
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import (StableHloModelPredictBatchOp,
                                                TableSourceBatchOp)

    op = StableHloModelPredictBatchOp(modelPath="model.hlo",
                                      selectedCols=["a"]).link_from(
        TableSourceBatchOp(MTable({"a": np.zeros(2)})))
    try:
        op.collect()
    except AkUnsupportedOperationException as e:
        stablehlo = f"raises as designed: {e}"
    else:
        stablehlo = "did not raise"
        problems.append("13.5: StableHloModelPredictBatchOp served a model")
    return {"StableHloModelPredictBatchOp": stablehlo,
            "TFSavedModelPredictBatchOp": "not driven: no TensorFlow on this "
            "machine (held against the JAX package on the CPU, "
            "tests/test_torch_tfsaved.py)"}


def ingest_path(workdir, card):
    """Phase 13: every case of INGEST_CASES; none launches a kernel of the
    port (the counters, set to 0 first, are read after to show it). Any
    failed check fails the run after all are reported."""
    from alink_tpu_torch.native import kernels

    kernels.reset_launches()
    problems, out, t = [], {}, {}
    X = resnet_images(RESNET_ROWS)

    def step(n, fn, *args):
        label = INGEST_CASES[n][0]
        t0 = time.perf_counter()
        res = fn(*args)
        t[label] = time.perf_counter() - t0
        out[label.split()[0]] = res[0] if isinstance(res, tuple) else res
        print(f"[{card}] phase {label} ({t[label]:.1f} s): "
              + json.dumps(out[label.split()[0]], default=str), flush=True)
        return res

    _, model, op32 = step(0, resnet_export_route, workdir, X, problems)
    step(1, flax_resnet_route, workdir, problems)
    step(2, onnx_route, workdir, model, X, op32, problems)
    step(3, stream_mlp_route, workdir, problems)
    step(4, departures, problems)
    out["seconds"] = t
    out["launches"] = kernels.launches()
    print(f"[{card}] phase 13 kernel launches: {out['launches']}",
          flush=True)
    if any(out["launches"].values()):
        problems.append(f"phase 13 launched kernels of the port: "
                        f"{out['launches']}")
    if problems:
        fail("phase 13: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# phase 14: BERT-base serving through ModelServer
# ---------------------------------------------------------------------------

SERVING = dict(max_batch_rows=64, flush_deadline_s=0.005)
SERVING_RUNGS = [8, 16, 24, 32, 40, 48, 56, 64]
SERVING_CLIENTS = 8
SERVING_SINGLE = 512        # single-row requests, spread over the clients
SERVING_MANY = (4, 32)      # predict_many calls, rows each
SERVING_QUEUE = 16          # 14.3's queue depth
SERVING_BURST = 200         # 14.3's burst of submits
SWAP_ROWS = 16              # rows served after the hot-swap
UNCACHED_ROWS = 8           # one rung-8 batch also run with cache_plan=False
MARGIN_BOUND = 2 * LOGIT_ATOL   # cross-rung |Δ(logit1 − logit0)|
SERVING_CASES = (
    "14.1 load: 8 rungs warmed, 12 launches each, the sidecar",
    "14.2 mixed traffic: 8 clients x 64 rows + 4 predict_many of 32",
    "14.3 overload: queue 16, burst 200, shed; a 1 ms deadline",
    "14.4 hot-swap under traffic: 2 threads, a new head",
    "14.5 bf16 load", "14.5 int8 load",
    "14.6 HTTP: load by path, predicts, stats, metrics, delete",
    "14.7 a failing batch fails its futures and feeds the breaker")


def margin(row):
    """A served row's logit gap, log(p1 / p0), from its detail JSON."""
    d = json.loads(row[-1])
    return float(np.log(d["1"]) - np.log(d["0"]))


def rung_report(served, serial, label, bound=MARGIN_BOUND):
    """Served rows against serial predicts: ``served`` is (row, batch
    rows) pairs, ``serial`` the rows of serial predicts (each at the
    smallest rung). Rows served at that rung must be bit-identical; rows at
    other rungs are counted (bit-identical or not), their largest logit-gap
    difference must lie within ``bound``, and their labels must equal
    wherever the serial gap exceeds ``bound``. Returns (report,
    problems)."""
    from alink_tpu_torch.common.jitcache import bucket_rows

    rep = {"same_rung": 0, "same_rung_identical": 0, "cross_rung": 0,
           "cross_rung_identical": 0, "cross_rung_max_margin_diff": 0.0,
           "cross_rung_label_flips": 0, "by_rung": {}}
    for (row, n), want in zip(served, serial):
        rung = bucket_rows(n)
        rep["by_rung"][rung] = rep["by_rung"].get(rung, 0) + 1
        same = tuple(row) == tuple(want)
        if rung == bucket_rows(1):
            rep["same_rung"] += 1
            rep["same_rung_identical"] += same
            continue
        rep["cross_rung"] += 1
        rep["cross_rung_identical"] += same
        rep["cross_rung_max_margin_diff"] = max(
            rep["cross_rung_max_margin_diff"],
            abs(margin(row) - margin(want)))
        if abs(margin(want)) > bound and row[1] != want[1]:
            rep["cross_rung_label_flips"] += 1
    problems = []
    if rep["same_rung_identical"] != rep["same_rung"]:
        problems.append(
            f"{label}: {rep['same_rung'] - rep['same_rung_identical']} of "
            f"{rep['same_rung']} rows served at the serial predict's rung "
            "differ from it")
    if not rep["cross_rung_max_margin_diff"] <= bound:
        problems.append(f"{label}: a cross-rung row's logit gap moved "
                        f"{rep['cross_rung_max_margin_diff']} > {bound}")
    if rep["cross_rung_label_flips"]:
        problems.append(f"{label}: {rep['cross_rung_label_flips']} labels "
                        "differ where the serial gap exceeds the bound")
    return rep, problems


def failing_predictor(error):
    """A LocalPredictor whose every batch raises ``error``, as a CUDA fault
    inside the forward would."""
    from alink_tpu_torch.common.mtable import TableSchema
    from alink_tpu_torch.pipeline import LocalPredictor

    class Failing(LocalPredictor):
        def __init__(self):
            self.input_schema = TableSchema.parse("text string")
            self._cache_plan = False

        def predict_table(self, t):
            raise error

    return Failing()


def check_batch_errors(wait_s=30.0):
    """14.7: a batch that raises fails each of its requests' futures with
    that very error, counts in the entry's errors, and opens the breaker
    after ``breaker_threshold`` failures, after which requests are refused
    fast. Each answer is awaited ``wait_s``. Returns the problems: a server
    that swallows the error, or completes the futures some other way, has
    some."""
    from alink_tpu_torch.common.exceptions import (AkCircuitOpenException,
                                                   AkDeadlineExceededException)
    from alink_tpu_torch.serving import ModelServer, ServingConfig

    err = RuntimeError("CUDA error: an illegal memory access was "
                       "encountered (injected by chip_smoke 14.7)")
    srv = ModelServer(ServingConfig(max_batch_rows=8, flush_deadline_s=0.001,
                                    breaker_threshold=2,
                                    breaker_reset_s=3600.0))
    problems = []
    try:
        srv.load("failing", failing_predictor(err))
        for i in range(2):
            fut = srv.submit("failing", (f"row {i}",))
            try:
                fut.result(timeout=wait_s)
                problems.append("14.7: a failing batch completed its "
                                "request with a row")
            except AkDeadlineExceededException:
                problems.append("14.7: a failing batch left its request "
                                "hanging")
            except BaseException as e:  # noqa: BLE001 — the check itself
                if e is not err:
                    problems.append(f"14.7: the request failed with {e!r}, "
                                    "not the batch's error")
        st = srv.stats()["models"][0]
        if st["errors"] != 2 or not st["breaker_open"]:
            problems.append(f"14.7: errors {st['errors']} (expected 2), "
                            f"breaker open {st['breaker_open']}")
        try:
            srv.submit("failing", ("row 2",)).result(timeout=wait_s)
            problems.append("14.7: the open breaker let a request through")
        except AkCircuitOpenException:
            pass
        except BaseException as e:  # noqa: BLE001
            problems.append(f"14.7: the open breaker answered {e!r}")
    finally:
        srv.close()
    return problems


def http_json(port, path, method="GET", body=None, text=False):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        raw = r.read().decode()
    return raw if text else json.loads(raw)


def http_status(port, path, method="GET", body=None):
    import urllib.error

    try:
        http_json(port, path, method, body)
        return 200
    except urllib.error.HTTPError as e:
        return e.code


def serving_pipeline(model_table, path=None):
    """``model_table`` as a one-stage BertClassificationModel pipeline;
    with ``path``, saved there and any old sidecar removed."""
    from alink_tpu_torch.pipeline import BertClassificationModel, PipelineModel
    from alink_tpu_torch.serving import warmup_sidecar_path

    pm = PipelineModel(BertClassificationModel(
        predictionCol="pred", predictionDetailCol="detail").set_model_data(
        model_table))
    if path is not None:
        if os.path.exists(warmup_sidecar_path(path)):
            os.remove(warmup_sidecar_path(path))
        pm.save(path)
    return pm


def swapped_head(model_table, seed):
    """The same BERT-base table with the head drawn again from ``seed``."""
    from alink_tpu_torch.common.model import model_to_table, table_to_model
    from alink_tpu_torch.operator.batch.dl import (params_from_bytes,
                                                   params_to_bytes)

    meta, arrays = table_to_model(model_table)
    tree = params_from_bytes(arrays["params"])
    rng = np.random.default_rng(seed)
    tree["params"]["head"] = {
        k: (rng.standard_normal(np.shape(v), np.float32) * 0.02)
        .astype(np.float32) for k, v in tree["params"]["head"].items()}
    return model_to_table(meta, {"params": params_to_bytes(tree)})


def serve_mixed(srv, name, texts):
    """14.2's traffic: SERVING_CLIENTS threads send the single-row requests
    (each waits for its answer before its next), while SERVING_MANY's
    predict_many-shaped calls (all rows submitted, then awaited) go in
    from threads of their own. Returns ((text index, row, batch rows) per
    request in text order, window s)."""
    import threading

    out, errors = [], []
    lock = threading.Lock()
    n_single = len(texts) - SERVING_MANY[0] * SERVING_MANY[1]

    def single(c):
        for i in range(c, n_single, SERVING_CLIENTS):
            fut = srv.submit(name, texts[i])
            row = fut.result(timeout=120)
            with lock:
                out.append((i, row, fut.batch_rows))

    def many(k):
        lo = n_single + k * SERVING_MANY[1]
        futs = [(i, srv.submit(name, texts[i]))
                for i in range(lo, lo + SERVING_MANY[1])]
        got = [(i, f.result(timeout=120), f.batch_rows) for i, f in futs]
        with lock:
            out.extend(got)

    def guarded(fn, arg):
        def run():
            try:
                fn(arg)
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(e)
        return run

    threads = [threading.Thread(target=guarded(single, c))
               for c in range(SERVING_CLIENTS)]
    threads += [threading.Thread(target=guarded(many, k))
                for k in range(SERVING_MANY[0])]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    window = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads):
        fail(f"14.2: traffic failed: {errors[:3]}")
    return sorted(out, key=lambda r: r[0]), window


def kept_model(predictor):
    """The torch encoder a LocalPredictor's plan serves."""
    for op in predictor._plan[2]:
        kept = getattr(op, "_kept_mapper", None)
        if kept is not None:
            return kept[2].model, kept[2].tokenizer
    fail("14: no loaded mapper in the predictor's plan")


def serving_path(workdir, served_main, card):
    """Phase 14; any failed check fails the run after all are reported.
    Returns (flash launches, numbers)."""
    import threading

    import torch

    from alink_tpu_torch.common import quant
    from alink_tpu_torch.common.exceptions import (AkDeadlineExceededException,
                                                   AkServingOverloadException)
    from alink_tpu_torch.common.jitcache import clear_signatures
    from alink_tpu_torch.common.metrics import metrics
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.native import kernels
    from alink_tpu_torch.operator.batch import (
        AkSourceBatchOp, BertTextClassifierPredictBatchOp, TableSourceBatchOp)
    from alink_tpu_torch.pipeline import LocalPredictor
    from alink_tpu_torch.serving import (ModelServer, ServingConfig,
                                         load_warmup_spec)
    from alink_tpu_torch.webui import ExperimentStore, WebUIServer

    cfg = serving_config()
    layers = cfg.num_layers
    rng = np.random.default_rng(SEED + 14)
    texts = [(t,) for t in request_texts(
        synthetic_vocab(cfg), rng,
        SERVING_SINGLE + SERVING_MANY[0] * SERVING_MANY[1])]
    warm_rows = texts[:8]
    table = AkSourceBatchOp(filePath=served_main["path"]).collect()
    path = os.path.join(workdir, "bert_serving.ak")
    problems, out = [], {"bound_margin": MARGIN_BOUND, "load_s": {}}

    def check(cond, msg):
        if not cond:
            problems.append(msg)

    def flash():
        return kernels.launches()["flash_block_update"]

    # the deflated write of the 406 MB pipeline (about half a minute of
    # one core, in zlib, which releases the GIL) runs beside 14.5 and
    # 14.7, which serve pipelines held in memory; 14.1 loads it by path
    saved = []

    def save():
        t0 = time.perf_counter()
        try:
            serving_pipeline(table, path)
            saved.append(time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001 — reported on the join
            saved.append(e)

    saver = threading.Thread(target=save, daemon=True)
    saver.start()
    kernels.reset_launches()

    # 14.5: bf16 and int8 loads, calibrated on the warmup rows, gated
    request = served_main["request"]
    req_rows = [(t,) for t in request.col("text")]
    for policy in POLICIES:
        b0 = metrics.counter("dl.served_state_builds")
        q = ModelServer(ServingConfig(**SERVING))
        t0 = time.perf_counter()
        qi = q.load("bert", serving_pipeline(table), "text string",
                    warmup_rows=warm_rows, precision=policy)["precision"]
        out["load_s"][policy] = time.perf_counter() - t0
        got = q.predict_many("bert", req_rows, timeout=300)
        q.predict_many("bert", req_rows[:8], timeout=300)
        builds = metrics.counter("dl.served_state_builds") - b0
        op = served_main.get("policy_tables", {}).get(policy)
        if op is None:        # phase 12 did not run: the op as 12.1 runs it
            op = BertTextClassifierPredictBatchOp(
                predictionCol="pred", predictionDetailCol="detail",
                inferencePrecision=policy).link_from(
                AkSourceBatchOp(filePath=served_main["path"]),
                TableSourceBatchOp(request)).collect()
        want = [r[-2:] for r in op.rows()]
        gap = max(abs(margin(g) - margin(w)) for g, w in zip(got, want))
        band = quant.accuracy_band_report(
            [w[:1] for w in want], [g[1:2] for g in got],
            [op.schema.types[-2]], band=QUANT_BAND, tol=QUANT_TOL)
        out[f"14.5 {policy}"] = dict(
            precision={k: v for k, v in qi.items() if k != "calib"},
            state_builds=builds, margin_vs_op_max=gap, band_vs_op=band)
        check(qi["policy"] == policy and qi["band_report"]["ok"],
              f"14.5 {policy}: the load did not pass its gate: {qi}")
        check(builds == 1, f"14.5 {policy}: {builds} quantized state builds "
                           "for one load")
        check(gap <= MARGIN_BOUND and band["ok"],
              f"14.5 {policy}: served rows {gap} from phase 12.1's op "
              f"(bound {MARGIN_BOUND}), band {band}")
        q.close()
    torch.cuda.synchronize()

    # 14.7: a failing batch
    problems += check_batch_errors()
    saver.join(timeout=600)
    if saver.is_alive() or not saved or not isinstance(saved[0], float):
        fail(f"14: the serving pipeline was not written: {saved}")
    out["save_s"] = saved[0]

    # 14.1: load, the ladder warmup, the sidecar; the shape record and the
    # serving histograms (14.2's quantiles) start empty, as in a fresh
    # serving process
    clear_signatures()
    metrics.reset()
    srv = ModelServer(ServingConfig(**SERVING))
    l0 = flash()
    t0 = time.perf_counter()
    info = srv.load("bert", path, "text string", warmup_rows=warm_rows)
    out["load_s"]["fp32"] = time.perf_counter() - t0
    warm = flash() - l0
    out["14.1"] = dict(warmup=info["warmup"], launches=warm,
                       sidecar=info["warmup_sidecar"])
    check(info["warmup"]["rungs"] == len(SERVING_RUNGS),
          f"14.1: warmup ran {info['warmup']['rungs']} rungs")
    p = flash_rise_problem(warm, len(SERVING_RUNGS), layers, "14.1 warmup")
    if p:
        problems.append(p)
    spec = load_warmup_spec(path)
    check(spec is not None and spec["ladder"] == SERVING_RUNGS
          and sorted(s[0][0][0] for k, s in spec["kernels"]
                     if k == "dl.apply_logits") == SERVING_RUNGS,
          f"14.1: sidecar {None if spec is None else (spec['ladder'], spec['kernels'])}")

    # 14.2: mixed traffic; no new shape, 12 launches a batch
    traces0 = metrics.counter("jit.trace")
    before = srv.stats()["models"][0]["batches"]
    l0 = flash()
    served, window = serve_mixed(srv, "bert", texts)
    batches = srv.stats()["models"][0]["batches"] - before
    launches = flash() - l0
    st = srv.stats()
    hist = {h: st["histograms"].get(h) for h in (
        "serving.request_s", "serving.queue_s", "serving.batch_rows")}
    hist_state = metrics.histogram_states().get("serving.batch_rows")
    out["14.2"] = dict(rows=len(served), batches=batches, launches=launches,
                       window_s=window, rows_per_s=len(served) / window,
                       histograms=hist, batch_rows_buckets=hist_state,
                       new_signatures=metrics.counter("jit.trace") - traces0)
    check(len(served) == len(texts), f"14.2: {len(served)} rows answered")
    check(metrics.counter("jit.trace") == traces0,
          "14.2: traffic met a batch shape the warmup did not run")
    p = flash_rise_problem(launches, batches, layers, "14.2 traffic")
    if p:
        problems.append(p)
    serial_lp = LocalPredictor(path, "text string")
    t0 = time.perf_counter()
    serial = [serial_lp.predict_row(t) for t in texts]
    out["14.2"]["serial_s"] = time.perf_counter() - t0
    # one rung-8 batch through the route that rebuilds the plan and
    # decodes the model on every predict: the kept mapper changes nothing
    uncached = LocalPredictor(path, "text string", cache_plan=False)
    got = uncached.predict_table(
        MTable.from_rows(texts[:UNCACHED_ROWS], uncached.input_schema))
    same = sum(tuple(got.get_row(i)) == tuple(serial[i])
               for i in range(UNCACHED_ROWS))
    out["14.2"]["uncached_identical"] = [same, UNCACHED_ROWS]
    check(same == UNCACHED_ROWS,
          f"14.2: {UNCACHED_ROWS - same} of {UNCACHED_ROWS} rows of the "
          "kept-mapper predictor differ from cache_plan=False")
    del uncached
    rep, bad = rung_report([(r, n) for _, r, n in served], serial, "14.2")
    out["14.2"]["rows_vs_serial"] = rep
    problems += bad
    predictor = srv._entry("bert").predictor
    model, tok = kept_model(predictor)
    enc = tok.encode_batch([t for (t,) in texts[:64]], max_len=512)
    out["forward_ms"] = {n: [forward_ms(model, {k: v[:n] for k, v in
                                                 enc.items()})
                             for _ in range(2)] for n in (8, 64)}
    srv.close()

    # 14.3: overload and deadlines (14.1's predictor, warmed again)
    over = ModelServer(ServingConfig(queue_depth=SERVING_QUEUE, **SERVING))
    over.load("bert", predictor, warmup_rows=warm_rows)
    shed0 = metrics.counter("serving.shed")
    accepted, shed = [], 0
    for i in range(SERVING_BURST):
        try:
            accepted.append((i, over.submit("bert",
                                            texts[i % len(texts)])))
        except AkServingOverloadException:
            shed += 1
    rows = [(f.result(timeout=120), f.batch_rows) for _, f in accepted]
    rep, bad = rung_report(rows, [serial[i % len(texts)]
                                  for i, _ in accepted], "14.3")
    problems += bad
    check(shed > 0 and metrics.counter("serving.shed") - shed0 == shed
          and over.stats()["models"][0]["shed"] == shed,
          f"14.3: burst shed {shed}, counted "
          f"{metrics.counter('serving.shed') - shed0}")
    while over.stats()["models"][0]["queued"] >= SERVING_QUEUE:
        time.sleep(0.001)
    for i in range(SERVING_QUEUE - 1):
        over.submit("bert", texts[i])
    late = over.submit("bert", texts[0], deadline_s=0.001)
    try:
        late.result(timeout=120)
        deadline = "answered"
    except AkDeadlineExceededException:
        deadline = "expired"
    check(deadline == "expired", "14.3: the 1 ms request was answered")
    out["14.3"] = dict(accepted=len(accepted), shed=shed,
                       rows_vs_serial=rep, deadline=deadline,
                       expired=over.stats()["models"][0]["deadline_expired"])
    over.close()

    # 14.4: hot-swap under traffic, to a model held in memory
    t0 = time.perf_counter()
    model2 = serving_pipeline(swapped_head(table, SEED + 141))
    build_s = time.perf_counter() - t0
    swap = ModelServer(ServingConfig(**SERVING))
    swap.load("bert", predictor, warmup_rows=warm_rows)
    stop, errors, during = threading.Event(), [], []

    def hammer(c):
        i = c
        while not stop.is_set():
            try:
                during.append(swap.predict("bert", texts[i % 64],
                                           timeout=120))
            except BaseException as e:  # noqa: BLE001 — checked below
                errors.append(e)
            i += 2

    ths = [threading.Thread(target=hammer, args=(c,)) for c in range(2)]
    for th in ths:
        th.start()
    t0 = time.perf_counter()
    swap.load("bert", model2, "text string", warmup_rows=warm_rows)
    swap_s = time.perf_counter() - t0
    stop.set()
    for th in ths:
        th.join(timeout=120)
    after = []
    for i in range(SWAP_ROWS):
        fut = swap.submit("bert", texts[i])
        after.append((fut.result(timeout=120), fut.batch_rows))
    lp2 = LocalPredictor(model2, "text string")
    serial2 = [lp2.predict_row(texts[i]) for i in range(SWAP_ROWS)]
    rep, bad = rung_report(after, serial2, "14.4")
    problems += bad
    check(not errors, f"14.4: {len(errors)} requests failed across the "
                      f"swap: {errors[:2]}")
    check(any(a[0] != serial[i] for i, a in enumerate(after)),
          "14.4: the swapped model serves the old model's rows")
    out["14.4"] = dict(build_s=build_s, swap_load_s=swap_s,
                       served_during=len(during), errors=len(errors),
                       rows_vs_new_serial=rep)
    swap.close()
    del lp2, model2, predictor, model, serial_lp

    # 14.6: the HTTP surface
    hs = ModelServer(ServingConfig(**SERVING))
    web = WebUIServer(port=0, store=ExperimentStore(
        os.path.join(workdir, "experiments.json")), model_server=hs)
    web.start(background=True)
    try:
        loaded = http_json(web.port, "/api/serving/models", "POST",
                           {"name": "bert", "path": path})
        one = http_json(web.port, "/api/serving/predict/bert", "POST",
                        {"row": list(texts[0])})
        many = http_json(web.port, "/api/serving/predict/bert", "POST",
                         {"rows": [list(t) for t in texts[:8]]})
        stats = http_json(web.port, "/api/serving")
        text = http_json(web.port, "/metrics", text=True)
        gone = http_json(web.port, "/api/serving/models/bert", "DELETE")
        again = http_status(web.port, "/api/serving/models/bert", "DELETE")
    finally:
        web.stop()
        hs.close()
    series = ("alink_serving_request_seconds", "alink_serving_batch_rows",
              "alink_serving_completed_total")
    check(loaded.get("warmup_source") == "sidecar",
          f"14.6: the load by path did not warm from the sidecar: {loaded}")
    check(tuple(one["row"]) == tuple(serial[0]),
          "14.6: the one-row answer differs from its serial predict")
    check(len(many["rows"]) == 8 and all(
        r[1] == s[1] or abs(margin(s)) <= MARGIN_BOUND
        for r, s in zip(many["rows"], serial[:8])),
        "14.6: the many-row answer differs from the serial predicts")
    check(stats["models"] and stats["models"][0]["completed"] >= 9,
          f"14.6: /api/serving {stats.get('models')}")
    check(all(s in text for s in series), "14.6: /metrics lacks a series")
    check(gone == {"unloaded": "bert"} and again == 404,
          f"14.6: DELETE answered {gone}, then {again}")
    out["14.6"] = dict(warmup_source=loaded.get("warmup_source"),
                       completed=stats["models"][0]["completed"],
                       second_delete=again)

    launches = flash()
    out["launches"] = launches
    print(f"[{card}] phase 14 serving: " + json.dumps(out, default=str),
          flush=True)
    if problems:
        fail("phase 14: " + "; ".join(problems))
    return launches, out


# ---------------------------------------------------------------------------
# phase 15: MLM pretraining (no kernel of the port on the path)
# ---------------------------------------------------------------------------

# 15.1/15.2: BERT-base width on the first 1,024 review lines
PRETRAIN_BASE = dict(hidden_size=768, num_layers=12, num_heads=12,
                     intermediate_size=3072, max_len=128, batch_size=32,
                     vocab_size=30522, seed=SEED)
PRETRAIN_ROWS = 1_024
PRETRAIN_EPOCHS = 2
PRETRAIN_PROFILE_ROWS = 256            # 8 steps; steps 2-7 profiled
PRETRAIN_PROFILE_STEPS = (1, 6)        # first and last profiled, from 0
PRETRAIN_STREAM = dict(block_rows=256, buffer_rows=512, limit=PRETRAIN_ROWS)
PRETRAIN_CKPT_EVERY = 16               # 15.2: one mid-epoch save
# 15.3: the CPU tests' configuration (tests/test_torch_pretrain.py)
PRETRAIN_TINY = dict(hidden_size=32, num_layers=1, num_heads=2,
                     intermediate_size=64, max_len=24, epochs=2,
                     batch_size=32, seed=SEED)
PRETRAIN_TINY_ROWS = 300
PRETRAIN_TINY_VOCAB = 300
PRETRAIN_FP32_ATOL = 1e-5     # loss history, card vs CPU route, fp32
# 15.4: bench.py's bench_bert_quality configuration (bench.py:639-650)
BERT_QUALITY_PRETRAIN = dict(
    vocab_size=2000, hidden_size=96, num_layers=2, num_heads=4,
    intermediate_size=192, max_len=32, epochs=5, batch_size=64,
    learning_rate=3e-4, seed=0)
BERT_QUALITY_FINETUNE = dict(
    maxSeqLength=32, numEpochs=14, batchSize=32, learningRate=5e-4,
    randomSeed=0, poolingStrategy="mean")
# alink_tpu's real_holdout_accuracy at this configuration on the CPU, one
# device (77 of 101 rows; scripts/reference_bert_quality.py)
BERT_QUALITY_REFERENCE_ACC = 77 / 101
BERT_QUALITY_FLOOR = BERT_QUALITY_REFERENCE_ACC - 0.05


def pretrain_step_events(pre, prof=None):
    """Wraps ``pre.make_train_step`` (the in-memory loop's one-step
    function) so that each step records CUDA events around itself, on the
    stream, without a host sync; with ``prof`` (a ``torch.profiler``
    profile), the profiler runs over steps PRETRAIN_PROFILE_STEPS, synced
    at both ends, and the window's host seconds are appended to the events
    list's ``window_s``. Returns (events, restore)."""
    import torch

    orig = pre.make_train_step
    events = _Events()
    first, last = PRETRAIN_PROFILE_STEPS

    def make(*args, **kw):
        step = orig(*args, **kw)

        def timed(*a, **k):
            i = len(events)
            if prof is not None and i == first:
                torch.cuda.synchronize()
                prof.start()
                events.t_window = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(*a, **k)
            end.record()
            events.append((start, end))
            if prof is not None and i == last:
                torch.cuda.synchronize()
                events.window_s = time.perf_counter() - events.t_window
                prof.stop()
            return out
        return timed

    def restore():
        pre.make_train_step = orig

    pre.make_train_step = make
    return events, restore


class _Events(list):
    """A list of (start, end) CUDA events with the profiled window's host
    seconds beside it."""
    t_window = window_s = None


def pretrain_split(prof, steps):
    """Device ms a step by group from ``prof`` (a finished ``torch.profiler``
    run over ``steps`` steps, CUDA activity): products (cuBLAS), the
    optimizer's multi-tensor kernels, copies and fills, elementwise and the
    rest; their sum (``busy``) and the 8 kernels of most device time."""
    from torch.autograd import DeviceType

    groups = {"products": 0.0, "optimizer": 0.0, "copies": 0.0,
              "elementwise": 0.0}
    top = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
            continue
        name = ev.key.lower()
        ms = ev.self_device_time_total / 1e3 / steps
        if any(t in name for t in ("gemm", "cutlass", "xmma", "nvjet",
                                   "cublas", "matmul")):
            key = "products"
        elif "multi_tensor" in name or "foreach" in name:
            key = "optimizer"
        elif "memcpy" in name or "memset" in name:
            key = "copies"
        else:
            key = "elementwise"
        groups[key] += ms
        top.append((ms, ev.count / steps, ev.key[:60]))
    groups["busy"] = sum(groups.values())
    groups["top"] = [(round(ms, 3), n, k) for ms, n, k in sorted(top)[-8:]]
    return groups


def pretrain_full_width(peaks, problems):
    """15.1: ``pretrain_mlm`` at BERT-base width on the in-memory loop (2
    epochs of 1,024 rows, batch 32, seq 128): per-step device-clock times
    from CUDA events, samples/s, MFU, peak memory; then steps 2-7 of an
    8-step run of the same model under ``torch.profiler`` for the device
    time by group and the idle share (1 − busy / the main run's median
    step). Returns the row and the tokenizer."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import alink_tpu_torch.dl.pretrain as pre
    from alink_tpu_torch.dl.data import load_reviews
    from alink_tpu_torch.dl.tokenizer import Tokenizer

    texts = load_reviews(limit=PRETRAIN_ROWS)
    tok = Tokenizer.build(texts, vocab_size=PRETRAIN_BASE["vocab_size"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, restore = pretrain_step_events(pre)
    t0 = time.perf_counter()
    try:
        cfg, params, _, hist = pre.pretrain_mlm(
            texts, tokenizer=tok, epochs=PRETRAIN_EPOCHS, **PRETRAIN_BASE)
    finally:
        restore()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    starts = [a for a, _ in events]
    step_ms = [a.elapsed_time(b) for a, b in zip(starts[1:-1], starts[2:])]
    step_ms.append(events[-1][0].elapsed_time(events[-1][1]))
    span_s = starts[1].elapsed_time(events[-1][1]) / 1e3
    B, S = PRETRAIN_BASE["batch_size"], PRETRAIN_BASE["max_len"]
    ms = float(np.median(step_ms))
    enc_flops = train_step_flops(cfg, B, S)
    head_flops = 6.0 * B * S * cfg.hidden_size * cfg.vocab_size
    flops = enc_flops + head_flops
    # a short run of the same model with the profiler over 6 of its steps
    # (not the first, not the last)
    prof = profile(activities=[ProfilerActivity.CUDA])
    pevents, restore = pretrain_step_events(pre, prof)
    try:
        pre.pretrain_mlm(texts[:PRETRAIN_PROFILE_ROWS], tokenizer=tok,
                         epochs=1, **PRETRAIN_BASE)
    finally:
        restore()
    n_prof = PRETRAIN_PROFILE_STEPS[1] - PRETRAIN_PROFILE_STEPS[0] + 1
    split = pretrain_split(prof, n_prof)
    split["traced_ms_per_step"] = pevents.window_s * 1e3 / n_prof
    split["idle_share"] = 1.0 - split["busy"] / ms
    row = dict(
        rows=len(texts), vocab_reached=tok.vocab_size, steps=len(events),
        loss_by_epoch=hist, wall_s=wall,
        samples_per_s=B * (len(events) - 1) / span_s,
        ms_per_step_median=ms, ms_per_step_min=float(min(step_ms)),
        ms_per_step_max=float(max(step_ms)), peak_gib=peak / 2**30,
        step_tflop=flops / 1e12, head_tflop=head_flops / 1e12,
        mfu=flops / (ms / 1e3) / peaks[1], device_ms_by_group=split,
        params=sum(int(t.numel()) for t in params.values()))
    print(f"15.1 MLM pretraining (hidden {cfg.hidden_size}, "
          f"{cfg.num_layers} layers, {cfg.num_heads} heads, "
          f"{cfg.intermediate_size}; seq {S}, batch {B}, {len(texts)} rows, "
          f"{PRETRAIN_EPOCHS} epochs, vocab_size "
          f"{PRETRAIN_BASE['vocab_size']} asked, {tok.vocab_size} reached "
          f"by the corpus): {row['samples_per_s']:.1f} samples/s from step "
          f"2 on (device clock), {ms:.2f} ms a step (median of "
          f"{len(step_ms)}, {row['ms_per_step_min']:.2f}–"
          f"{row['ms_per_step_max']:.2f}); {flops / 1e12:.3f} TFLOP a step "
          f"(tied head {head_flops / 1e12:.4f}), MFU {row['mfu']:.4f} of "
          f"{peaks[1] / 1e12:.0f} TFLOP/s; peak device memory "
          f"{row['peak_gib']:.2f} GiB; loss by epoch {hist}; wall "
          f"{wall:.1f} s; device ms a step by group over steps "
          f"{PRETRAIN_PROFILE_STEPS[0] + 1}-{PRETRAIN_PROFILE_STEPS[1] + 1} "
          f"of a profiled run of {PRETRAIN_PROFILE_ROWS // B} " +
          ", ".join(f"{k} {v}" for k, v in split.items()), flush=True)
    if not (len(hist) == PRETRAIN_EPOCHS and all(np.isfinite(hist))
            and hist[1] < hist[0]):
        problems.append(f"15.1: the loss is not finite or not falling: {hist}")
    return row, tok


def pretrain_scale_loop(workdir, problems):
    """15.2: the same model over a ``CorpusStream`` of the first 1,024
    lines (blocks of 256, a buffer of 512) with ``accum_steps=2``, one
    epoch, checkpointing every 16 steps (one mid-epoch save and the epoch's;
    one kept): rows/s in the step loop and over the call, the registry's
    p50 of ``train.accum_flush_s``, ``train.feed_wait_s`` and
    ``train.step_s``, and ``train.ckpt_saves``."""
    import torch

    import alink_tpu_torch.dl.pretrain as pre
    from alink_tpu_torch.common.metrics import metrics
    from alink_tpu_torch.dl import checkpoint as ckpt_mod
    from alink_tpu_torch.dl.data import CorpusStream, data_path

    metrics.reset()   # the p50s below read this run alone
    cs = CorpusStream(data_path("reviews_unlabeled.txt"), **PRETRAIN_STREAM)
    real_save = ckpt_mod.TrainCheckpointManager.save
    save_s = []

    def timed_save(self, *a, **k):
        t = time.perf_counter()
        real_save(self, *a, **k)
        save_s.append(time.perf_counter() - t)

    ckpt_mod.TrainCheckpointManager.save = timed_save
    d = os.path.join(workdir, "pretrain_ckpt")
    t0 = time.perf_counter()
    try:
        _, _, tok, hist = pre.pretrain_mlm(
            cs, epochs=1, accum_steps=2, checkpoint_dir=d,
            checkpoint_every=PRETRAIN_CKPT_EVERY, checkpoint_keep=1,
            resume=False, **PRETRAIN_BASE)
    finally:
        ckpt_mod.TrainCheckpointManager.save = real_save
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    p50 = {k: metrics.histogram(k)["p50"] for k in (
        "train.accum_flush_s", "train.feed_wait_s", "train.step_s")}
    loop_s = metrics.histogram("train.step_s")["sum"]
    counters = {k: metrics.counter(k) for k in (
        "train.steps", "train.micro_steps", "train.rows", "train.ckpt_saves")}
    row = dict(rows=len(cs), wall_s=wall, save_s=save_s, loop_s=loop_s,
               rows_per_s=len(cs) / loop_s,
               rows_per_s_with_saves=len(cs) / wall,
               max_resident_rows=cs.max_resident_rows,
               buffer_rows=cs.buffer_rows, loss=hist, p50_s=p50,
               counters=counters, vocab_reached=tok.vocab_size)
    print(f"15.2 the corpus-scale loop, 15.1's model ({len(cs)} rows "
          f"streamed in blocks of {cs.block_rows}, buffer {cs.buffer_rows}, "
          f"accum_steps 2, checkpoint_every {PRETRAIN_CKPT_EVERY}): "
          f"{row['rows_per_s']:.1f} rows/s in the step loop (the sum of "
          f"train.step_s, {loop_s:.2f} s), {row['rows_per_s_with_saves']:.1f}"
          f" over the call's wall ({wall:.1f} s: set-up, the saves "
          f"{[round(t, 2) for t in save_s]} s); p50 (metrics "
          f"registry) {p50}; counters {counters}; max resident rows "
          f"{cs.max_resident_rows}; loss {hist}", flush=True)
    if not all(np.isfinite(hist)):
        problems.append(f"15.2: the loss is not finite: {hist}")
    if not cs.max_resident_rows <= cs.buffer_rows:
        problems.append(f"15.2: {cs.max_resident_rows} resident rows exceed "
                        f"the buffer of {cs.buffer_rows}")
    if counters["train.ckpt_saves"] != 2 or \
            counters["train.micro_steps"] != 2 * counters["train.steps"]:
        problems.append(f"15.2: counters {counters}")
    shutil.rmtree(d, ignore_errors=True)
    return row


def state_gap(a, b):
    """(bitwise equal, largest |Δ|) of two state dicts."""
    import torch

    if sorted(a) != sorted(b):
        return False, float("inf")
    gap = max(float((a[k].double() - b[k].double()).abs().max()) for k in a)
    return all(torch.equal(a[k], b[k]) for k in a), gap


def pretrain_contracts(workdir, problems):
    """15.3: at the CPU tests' configuration, on the card: async feed ≡
    sync; streaming ≡ in-memory under the same block schedule; a run
    resumed from a mid-epoch checkpoint ≡ the straight run, each bitwise;
    the card's loss history against the port's CPU route from the same
    carried weights, at the default bf16 compute (LOSS_ROUTE_ATOL) and in
    fp32 (PRETRAIN_FP32_ATOL)."""
    import functools

    import torch

    import alink_tpu_torch.dl.pretrain as pre
    from alink_tpu_torch.dl import checkpoint as ckpt_mod
    from alink_tpu_torch.dl.convert import torch_to_flax
    from alink_tpu_torch.dl.data import CorpusStream, load_reviews
    from alink_tpu_torch.dl.modules import BertConfig, TransformerEncoder
    from alink_tpu_torch.dl.tokenizer import Tokenizer

    texts = load_reviews(limit=PRETRAIN_TINY_ROWS)
    path = os.path.join(workdir, "pretrain_tiny.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(texts) + "\n")
    tok = Tokenizer.build(texts, vocab_size=PRETRAIN_TINY_VOCAB)

    def run(data, **kw):
        return pre.pretrain_mlm(data, tokenizer=tok, **{**PRETRAIN_TINY,
                                                        **kw})

    def stream():
        return CorpusStream(path, block_rows=48, buffer_rows=96)

    out = {}

    def bitwise(label, a, b):
        (_, pa, _, ha), (_, pb, _, hb) = a, b
        same, gap = state_gap(pa, pb)
        out[label] = dict(bitwise=same and ha == hb, max_abs_diff=gap,
                          loss=ha)
        if not (same and ha == hb):
            problems.append(f"15.3 {label}: not bitwise (parameters max|Δ| "
                            f"{gap}, histories {ha} / {hb})")

    bitwise("async = sync", run(texts, feed="async"), run(texts, feed="sync"))
    straight = run(stream())
    bitwise("streaming = in-memory", straight, run(texts, block_rows=48))

    d = os.path.join(workdir, "pretrain_resume")
    shutil.rmtree(d, ignore_errors=True)
    real_save = ckpt_mod.TrainCheckpointManager.save
    saves = []

    def crashing(self, step, params, opt_state, extra):
        real_save(self, step, params, opt_state, extra)
        saves.append(dict(extra))
        if len(saves) == 3:
            raise RuntimeError("injected mid-epoch crash")

    ckpt_mod.TrainCheckpointManager.save = crashing
    try:
        run(stream(), checkpoint_dir=d, checkpoint_every=3)
        problems.append("15.3: the injected crash did not happen")
    except RuntimeError as e:
        if "injected" not in str(e):
            raise
    finally:
        ckpt_mod.TrainCheckpointManager.save = real_save
    resumed = run(stream(), checkpoint_dir=d, checkpoint_every=3)
    bitwise("resumed mid-epoch = straight",
            (None, resumed[1], None, resumed[3][-1:]),
            (None, straight[1], None, straight[3][-1:]))
    out["resumed mid-epoch = straight"]["crash_after"] = saves[-1]
    shutil.rmtree(d, ignore_errors=True)

    # the card against the port's CPU route from the same carried weights
    for label, dtype, bound in (("bf16", torch.bfloat16, LOSS_ROUTE_ATOL),
                                ("fp32", torch.float32, PRETRAIN_FP32_ATOL)):
        cfg = BertConfig(vocab_size=tok.vocab_size, hidden_size=32,
                         num_layers=1, num_heads=2, intermediate_size=64,
                         max_position=24, dropout=0.0, pool="cls",
                         dtype=dtype)
        init = torch_to_flax(TransformerEncoder(cfg).init_weights(SEED)
                             .state_dict(), cfg)
        init["params"].pop("type_emb")
        real_cfg = pre.BertConfig
        pre.BertConfig = functools.partial(real_cfg, dtype=dtype)
        try:
            card = run(texts, init_params=init)[3]
            with torch_device("cpu"):
                cpu = run(texts, init_params=init)[3]
        finally:
            pre.BertConfig = real_cfg
        gap = float(np.max(np.abs(np.subtract(card, cpu))))
        out[f"card vs CPU, {label}"] = dict(card=card, cpu=cpu, gap=gap,
                                            bound=bound)
        if not gap <= bound:
            problems.append(f"15.3: the card's {label} loss history {card} "
                            f"is {gap} from the CPU route's {cpu} (bound "
                            f"{bound})")
    print("15.3 pretraining contracts on the card (hidden 32, 1 layer, "
          f"{PRETRAIN_TINY_ROWS} rows): " + json.dumps(out), flush=True)
    return out


def bert_quality_route(workdir):
    """15.4: bench.py's ``bench_bert_quality`` on the port: MLM pretraining
    on data/reviews_unlabeled.txt (``pretrain_and_save``), the fine-tune
    ``BertTextClassifierTrainBatchOp(checkpointFilePath=...)`` on
    ``sst2_split(seed=0)``'s train rows, and the holdout's accuracy through
    ``BertTextClassifierPredictBatchOp``. Runs on the port's default device
    (``ALINK_TORCH_DEVICE``). Returns the accuracy, the MLM losses and each
    stage's wall."""
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.dl.data import load_reviews, sst2_split
    from alink_tpu_torch.dl.pretrain import pretrain_and_save
    from alink_tpu_torch.operator.batch import (
        BertTextClassifierPredictBatchOp, BertTextClassifierTrainBatchOp,
        TableSourceBatchOp)

    d = os.path.join(workdir, "bert_quality_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    pre = pretrain_and_save(load_reviews(), d, **BERT_QUALITY_PRETRAIN)
    t1 = time.perf_counter()
    tr_t, tr_y, ho_t, ho_y = sst2_split(seed=0)
    model = BertTextClassifierTrainBatchOp(
        textCol="text", labelCol="label", checkpointFilePath=d,
        **BERT_QUALITY_FINETUNE).link_from(
        TableSourceBatchOp(MTable({"text": tr_t, "label": tr_y}))).collect()
    t2 = time.perf_counter()
    pred = BertTextClassifierPredictBatchOp(predictionCol="p").link_from(
        TableSourceBatchOp(model),
        TableSourceBatchOp(MTable({"text": ho_t, "label": ho_y}))).collect()
    t3 = time.perf_counter()
    shutil.rmtree(d, ignore_errors=True)
    return dict(
        real_holdout_accuracy=float(np.mean(np.asarray(pred.col("p"))
                                            == ho_y)),
        train_rows=len(tr_t), holdout_rows=len(ho_t),
        mlm_initial_loss=pre["initial_loss"],
        mlm_final_loss=pre["final_loss"], vocab_size=pre["vocab_size"],
        pretrain_s=t1 - t0, finetune_s=t2 - t1, predict_s=t3 - t2)


def pretraining_path(workdir, peaks, card):
    """Phase 15: 15.1–15.4. No kernel of the port runs here (the
    pretraining encoder takes ``full_attention``): the launch counters,
    set to 0 first, must read 0 after it."""
    from alink_tpu_torch.native import kernels

    problems = []
    kernels.reset_launches()
    out = {}
    t = time.perf_counter()
    out["15.1"], _ = pretrain_full_width(peaks, problems)
    out["15.2"] = pretrain_scale_loop(workdir, problems)
    out["15.3"] = pretrain_contracts(workdir, problems)
    q = bert_quality_route(workdir)
    out["15.4"] = q
    print(f"15.4 bench.py's quality route on the card: real_holdout_accuracy "
          f"{q['real_holdout_accuracy']:.4f} (floor {BERT_QUALITY_FLOOR:.4f},"
          f" the reference's {BERT_QUALITY_REFERENCE_ACC:.4f} on the CPU "
          f"less 0.05; {q['holdout_rows']} holdout rows); MLM loss "
          f"{q['mlm_initial_loss']} -> {q['mlm_final_loss']} (vocab "
          f"{q['vocab_size']}); walls: pretrain {q['pretrain_s']:.1f} s, "
          f"fine-tune {q['finetune_s']:.1f} s, predict "
          f"{q['predict_s']:.1f} s", flush=True)
    if not q["real_holdout_accuracy"] >= BERT_QUALITY_FLOOR:
        problems.append(f"15.4: holdout accuracy "
                        f"{q['real_holdout_accuracy']} is below "
                        f"{BERT_QUALITY_FLOOR}")
    out["launches"] = kernels.launches()
    out["seconds"] = time.perf_counter() - t
    print(f"[{card}] phase 15 kernel launches: {out['launches']}",
          flush=True)
    if any(out["launches"].values()):
        problems.append(f"phase 15 launched kernels of the port: "
                        f"{out['launches']}")
    if problems:
        fail("phase 15: " + "; ".join(problems))
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke test runs only on the card")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "alink_tpu_torch")):
        fail("alink_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    key, peaks = card_peaks(name)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {name} "
          f"(peaks used: {key}, {peaks[0] / 1e12:.2f} TB/s)", flush=True)

    from alink_tpu_torch.native import kernels

    kernels.build(verbose=False)
    print(f"build: {len(kernels.KERNELS)} kernel(s) + binding in "
          f"{kernels.build_seconds:.1f} s", flush=True)

    marks = [("setup and build", time.perf_counter())]
    stats = check_kernel(peaks)
    marks.append(("phase 3 flash kernel", time.perf_counter()))
    workdir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    launches, served_main = main_path(workdir, serving_config())
    marks.append(("phase 4 BERT serving", time.perf_counter()))

    from alink_tpu_torch.tree.binning import apply_bins, quantile_bins

    t0 = time.perf_counter()
    X, y = covertype_data(COVTYPE_TRAIN + COVTYPE_TEST, SEED)
    bins = apply_bins(X[:COVTYPE_TRAIN], quantile_bins(X[:COVTYPE_TRAIN], 64))
    print(f"Covertype-layout data: {X.shape[0]} rows x {X.shape[1]} features "
          f"from seed {SEED}, label 1 in {y.mean():.3f} of rows; binned in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    errors, even = check_histogram(peaks, bins)
    del bins
    t0 = time.perf_counter()
    Xw, _ = mnist_layout(WIDE_ROWS, SEED)
    wide_bins = apply_bins(Xw, quantile_bins(Xw, HIST_BINS))
    del Xw
    print(f"MNIST-layout data: {WIDE_ROWS} rows x 784 features from seed "
          f"{SEED}, binned in {time.perf_counter() - t0:.1f} s", flush=True)
    wide_errors, wide_times = check_wide_histograms(peaks, wide_bins)
    errors.update(wide_errors)
    del wide_bins
    tree_launches, forest, (hist, forest_errors, levels) = forest_path(
        workdir, X, y, peaks)
    errors.update(forest_errors)
    wide_forest = wide_forest_path()
    hist.update(errors=errors, max_abs_err=max(errors.values()),
                bound_by="bytes")
    gbdt_model = gbdt_path(X, y)
    marks.append(("phases 5-7 trees", time.perf_counter()))

    t0 = time.perf_counter()
    docs = text8_corpus(W2V_TOKENS, SEED)
    print(f"text8-layout corpus: {len(docs)} sentences of {SENTENCE} tokens "
          f"from seed {SEED} in {time.perf_counter() - t0:.1f} s", flush=True)
    sgns = check_sgns(peaks, docs[:250])
    sgns["errors"].update(check_sgns_wide())
    sgns["max_abs_err"] = max(sgns["errors"].values())
    sgns_launches, w2v = word2vec_path(workdir, docs)
    marks.append(("phases 8-9 Word2Vec", time.perf_counter()))
    del docs

    bwd = check_backward(peaks)
    record = train_metric_of_record(peaks)
    kernel_train = train_kernel_route()
    sst2 = finetune_sst2(workdir)
    marks.append(("phase 10 BERT training", time.perf_counter()))
    classical_path(workdir)
    marks.append(("phase 11 classical path", time.perf_counter()))
    families, quant_launches = model_families(served_main, X, y, gbdt_model,
                                              card)
    marks.append(("phase 12 model families", time.perf_counter()))
    del X, y
    ingest_path(workdir, card)
    marks.append(("phase 13 ingest", time.perf_counter()))
    serve_launches, _ = serving_path(workdir, served_main, card)
    marks.append(("phase 14 serving", time.perf_counter()))
    pretraining = pretraining_path(workdir, peaks, card)
    print(f"[{card}] phase 15: " + json.dumps(pretraining, default=str),
          flush=True)
    marks.append(("phase 15 pretraining", time.perf_counter()))

    def entry(name, launches, st, library_call, shape):
        spec = kernels.KERNELS[name]
        return {
            "name": spec.name, "route": spec.route,
            "source": "alink_tpu_torch/" + spec.source,
            "replaces": spec.replaces, "launches": launches,
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_us": st["bound_ms"] * 1e3, "bound_by": st["bound_by"],
            "library_ms": st["library_ms"], "library_call": library_call,
            "shape": shape, "errors": st["errors"]}

    line = {"kernels": [
        dict(entry("flash_block_update",
                   launches + quant_launches + serve_launches, stats,
                   "scaled_dot_product_attention over all 512 keys, "
                   "contiguous (B, H, S, D), unmasked (yardstick)",
                   "one attention call: (B, S, H, D) = (32, 512, 12, 64) "
                   "bf16, blocks of 128, q/k/v as unbind views of the qkv "
                   "product; ms is the fused launch, plain_ms the plain "
                   "route (ALINK_ATTN_PALLAS=0)"),
             launches_by_path={"phase 4 serving": launches,
                               **{f"12.1 {p}": families["12.1"][p]["launches"]
                                  for p in POLICIES},
                               "phase 14 serving": serve_launches},
             library_views_ms=stats["library_views_ms"],
             block_ms=stats["block_ms"],
             block_plain_ms=stats["block_plain_ms"],
             train_launches=kernel_train["kernel"]["launches"],
             backward_errors=bwd.pop("errors"), **bwd,
             bert_training=dict(metric_of_record=record,
                                kernel_route=kernel_train, sst2=sst2)),
        dict(entry("tree_histogram", tree_launches, hist,
                   "Tensor.index_add_ of the distinct channels over the "
                   "flat cell index (yardstick)",
                   f"one level call: n={COVTYPE_TRAIN} d=54 uint8 bins, "
                   f"int32 node, fp32 (g, count, count) with h is c; ms "
                   f"(device time in CUDA graphs), plain_ms, library_ms "
                   f"and bound_ms are means over the 12 levels (L = 1 ... "
                   f"2048, S = 64 ... 131072) of the forest's first tree, "
                   f"on its level calls' inputs"),
             forest=forest, forest_levels=levels,
             even_nodes=even, wide_tables=wide_times,
             wide_forest=wide_forest),
        dict(entry("sgns_block_grads", sgns_launches, sgns, "none",
                   "one fused pull-and-gradients call (sgns_pull_grads): "
                   "B=1024 negs=5 D=100 fp32, the tables, hot replicas "
                   f"({sgns['hot_rows']} rows) and ids of the 300th step of "
                   "a training; ms and plain_ms (pull + gradients) are "
                   "device time per call from a CUDA graph of 30 launches; "
                   "gathered_* the gathered-rows entry sgns_block_grads on "
                   "that step's pulled rows"),
             **{k: sgns[k] for k in (
                 "gathered_ms", "gathered_plain_ms", "gathered_bound_ms",
                 "eager_ms", "eager_plain_ms", "turns", "gathered_turns")},
             word2vec=w2v)]}
    print("seconds by phase: " + ", ".join(
        f"{name} {t1 - t0:.1f}" for (_, t0), (name, t1)
        in zip([("", t_start)] + marks[:-1], marks)), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
