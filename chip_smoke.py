#!/usr/bin/env python3
"""The PyTorch port's main path on one NVIDIA GPU, end to end.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero without the
final line:

1. Device: the card's name, count and power limit (``nvidia-smi``).
   Without CUDA the script fails.
2. Build: every CUDA source of ``paddle_tpu_torch/csrc`` with ``nvcc``
   for ``sm_90a`` (one process per source, all at once), printing
   ptxas's register and spill report; beside them this script's empty
   kernel (``FLOOR_SOURCE``), timed in phase 16 as the floor of a launch.
3. Kernels: each page-gather kernel at the decode shapes of phase 4
   (4096 pool rows, 4096 gathered rows, 512 wide, sentinel rows
   included) must equal its plain PyTorch version exactly; the
   dequantizing gather also at its edges (``DEQUANT_EDGES``: one row, a
   count off a block's rows, only sentinels, head widths 16 and 48 and,
   on the scalar kernel, 6). Each is timed with CUDA events (median per
   launch, L2 flushed before each launch as a decode step finds it) and
   by device time alone after the same flush (a profiler window),
   beside its plain version, one PyTorch library call computing the same
   function (by events and device time), and its bound: the bytes it
   must move over the card's 3.35 TB/s.
4. Slice: ``decoder_lm`` at Transformer-base width (vocab 32000,
   d_model 512, d_inner 2048, 8 heads, 6 layers; seeded random weights
   carried in through ``params_from_jax``) serves 24 requests through
   ``make_slot_model(...).generate`` over a paged pool (16 slots,
   256 pages of 16 rows, prompt buckets 32/64/128, cache_len 256), for
   ``kv_codec="none"`` and ``"int8"``. The launch counts are zeroed
   just before and read just after. Checks: fp32 greedy and sampled
   streams equal the ``full``-view recompute oracle (fp32, TF32 off;
   a divergence passes only at a near tie, top-2 gap < 1e-3), int8's
   first tokens equal the oracle's and a second int8 run replays the
   first exactly, and every decode step launched its kernel twice per
   layer. Then, per codec, a profiler window of 20 decode steps with
   every slot busy: device busy per step, idle share, and by profiler
   name that every page gather ran that codec's kernel.
4b. Speculative decoding: phase 4's model and requests through the spec
   engine (``make_slot_model(..., spec_k=4)``), per codec: (a) the
   n-gram drafter, (b) a scripted drafter proposing (a)'s own streams
   (full windows until a budget's end), each checked as phase 4 checks
   its streams (int8: a second scripted run replays), with tokens/s,
   verify dispatches, drafts proposed / accepted and the tokens
   committed per slot per dispatch; the page gathers launched twice per
   layer a verify dispatch (counts zeroed just before each run, read
   just after); (c) a profiler window of 20 verify dispatches of 16 full
   windows: device busy per dispatch and per committed token beside
   phase 4's decode step, idle share, ``token_sample``'s sort share, and
   by profiler name and launch count every page gather that codec's
   kernel; (d) fp32 only, the ``ModelDrafter`` over the target model on
   4 requests of budget 32, checked against the oracle.
5. Flash kernels: the flash-attention forward (on the tensor cores up to
   head width 128, fp32 through 3xTF32; a second call bit-equal), the
   one-pass backward (``flash_bwd``: dQ, dK and dV in one launch on the
   tensor cores) and the dQ and dK/dV kernels (which ``flash_bwd`` runs
   above its range: key length 512, head width 128) at the attention
   shapes of phase 7 (B*H 256, T 128, D 64), non-causal, causal, and
   non-causal with dropout 0.1, each against its plain PyTorch version on
   the same inputs (rtol 1e-4 / atol 1e-5 forward, rtol 1e-3 / atol 1e-4
   gradients; fp32 sums in another order), a second ``flash_bwd`` bit-equal
   to the first; timed as in phase 3 beside its plain version, two bounds
   (the larger of its FLOPs over the rate of its path -- 67 TFLOP/s fp32
   outside the tensor cores, or three TF32 products at 495 TFLOP/s for
   ``flash_bwd`` -- and its bytes over 3.35 TB/s; each row gives both) and
   a library yardstick: ``scaled_dot_product_attention`` for the forward
   (at p = 0: its dropout bits differ) and that call's backward, which
   computes dQ, dK and dV at once (against ``flash_bwd`` and the pair),
   held to allclose with the plain versions first. The library's times
   are its device time a call (a profiler window: its autograd calls are
   host-bound, so their CUDA events read the host's time), beside the
   kernel's own device time. The same shape in bf16
   and fp16 for the forward and ``flash_bwd``, full and causal with dropout
   0.1, against the plain versions in the working type (one step of the
   dtype at the largest magnitude plus one of each element), bf16 full
   timed beside plain, bound (989 TFLOP/s) and SDPA's bf16 backward. Then
   the whole ``FlashAttention.backward`` (delta and ``flash_bwd``) against
   SDPA's backward, fp32 full and causal and bf16 full, in turns over 4
   rounds, and by device time: the Function against SDPA's whole backward,
   ``flash_bwd`` alone against SDPA's longest kernel alone. q, k and v of
   mixed dtypes (q bf16 with k, v fp32; v fp16 with q, k fp32; dO in q's
   dtype), causal with dropout 0.1: the forward and ``flash_bwd`` against
   the plain versions, each output in the reference's dtype, within one
   step of the narrow dtype. The forward at key length 1024 (B*H 16),
   causal with dropout, fp32 and bf16. Then, causal,
   at head widths the wrappers pad or run on the widest tiles (48:
   d_model 96 over 2 heads, run at 64; 256) or take in
   256-wide chunks (257 and 320, run at 512), each kernel against its
   plain version, timed beside plain and bound; and one training step of
   a causal attention block at d_model 257 over 1 head and 640 over 2
   (head widths 257 and 320): the fused block (one launch of the forward,
   and of the dQ and dK/dV kernels) equals the composed block, output
   within rtol 1e-4, gradients of the input and the projections within
   rtol 1e-3.
6. Fused-CE kernels: the fused linear + cross-entropy forward and
   backward kernels (tensor cores: fp32 through 3xTF32, bf16 natively) at
   the vocabulary head of phase 7 (N 4096 rows, D 512, V 32000, label
   smoothing 0.1, every 50th row at ignore_index, a non-uniform per-row
   cotangent) and at an edge shape (N 1000, D 100, V 1003), fp32 and
   bf16, each against its plain PyTorch version (fp32: rtol 1e-4 / atol
   1e-5 loss and lse, rtol 1e-3 / atol 1e-4 dx and dW; bf16: the same
   for loss and lse, dx and dW within one bf16 step plus one step of
   every rounded dz term), a second call of each bit-equal to the first;
   timed as in phase 3 beside its plain version, the time of its
   operand copies (the prep kernel, inside the kernel's time), two bounds
   (the FLOPs at the tensor-core rate of its path: three TF32 products
   at 495 TFLOP/s for fp32, 989 TFLOP/s for bf16; and at 67 TFLOP/s fp32
   outside the tensor cores, as the earlier kernels' rows were bound;
   each against the bytes over 3.35 TB/s) and a library yardstick:
   ``F.cross_entropy`` of the matmul's fp32 logits for the forward and
   its autograd backward for the backward (held to allclose with the
   plain versions first in fp32). Then the smallest input that raised
   before (x [1, 513], through ``fused_linear_ce``), and
   ``transformer_big``'s head (N 4096, D 1024, V 32000; timed beside
   plain and bounds) with an edge shape (N 300, D 700, V 1003). Then x
   and w of two dtypes (bf16 / fp32, fp32 / bf16, fp16 / fp32, bf16 /
   fp16, as the JAX function takes them) at the edge shape and the head,
   each kernel against its plain version (loss and lse within the fp32
   tolerances; dx in x's dtype and dW in w's within one step of their
   dtype plus one step of x's dtype of every dz term where x is the
   narrower), a second backward bit-equal, timed at the head; and the
   same pairs through ``fused_linear_ce`` and its autograd backward at
   the edge shape.
7. Training: Transformer-base (vocab 32000, d_model 512, d_inner 2048,
   8 heads, 6 + 6 layers, max_len 128, label smoothing 0.1, Adam at
   1e-4; seeded random weights carried in through
   ``transformer_params_from_jax``) takes 10 steps of 32 sequences (4096
   tokens) of a seeded copy task three times from the same weights:
   ``fused_attention=True`` (the flash kernels), ``False`` (composed
   torch ops: the oracle) and ``fused_attention=True, fused_head=True``
   (the flash and the fused-CE kernels), dropout off. The launch counts
   are zeroed just before each run and read just after. Checks: the
   composed and the fused-head curves agree with the fused-attention
   curve within rtol 1e-3; every fused step launched the flash forward
   and ``flash_bwd`` 18 times each (6 encoder, 6 causal decoder and 6
   cross attentions), the dQ and dK/dV kernels never, and the composed
   run none; every fused-head step launched the fused-CE
   forward and backward once each and the other runs none. An
   evaluation forward (``is_train=False``) with the fused head must
   equal the unfused one within rtol 1e-4 and launch the forward kernel
   once. Then 10 fused
   steps at dropout 0.1 on one batch must give finite losses, the last
   below the first. Prints each run's step p50 (host clock around steps
   that end in a synchronize), tokens/s, peak memory, and a
   ``torch.profiler`` window of 3 steps: device busy per step, idle
   share, and the flash and fused-CE kernels' shares of device time, and
   by profiler name the forward's tensor-core kernel and ``flash_bwd``
   (each 18 a step, the SIMT forward none: checked) with their launches
   and device time a step; then the three runs' device busy side by side.
   Then mixed precision: the fused-attention and fused-head runs again
   from the same weights under pure AMP (``contrib.mixed_precision.
   rewrite_program_amp`` after ``build``, as the reference's ``--amp``),
   with the same checks of launches a step, the profiler window naming
   the bf16 flash forward and backward (18 a step each, their fp32
   kernels none) and the bf16 fused-CE forward (1 a step) and backward
   (its dz kernel once a slab of 2048 columns); the first 3 losses
   within rtol 0.05 of the fp32 run's (bf16 keeps 8 significant bits;
   the reference's own AMP test holds step 0 at 5 %); step p50, device
   busy, idle share and peak memory beside fp32's.
8. LSTM kernels: the whole-sequence LSTM forward and backward kernels
   at the shapes of phase 9 (T 100, B 64, H 512; seeded ``xproj`` x 0.4,
   ``peep`` x 0.1, ``h0, c0`` x 0.3, ``w`` x H**-0.5, ragged lengths
   1-100 with one full row, non-uniform cotangents on all four outputs)
   and at an edge shape (T 7, B 5, H 100): the forward's four outputs
   and the backward's five against the plain PyTorch versions (rtol 1e-4
   / atol 1e-5 forward, rtol 1e-3 / atol 1e-4 gradients; fp32 sums in
   another order, compounded over the steps), ``hidden`` and ``cell``
   exactly 0 past each length, zero peepholes with full lengths against
   a peephole-free cell loop, and two runs of the backward bit-equal.
   Timed as in phase 3 beside the plain versions (the step loop; the
   explicit backward formulae; autograd through the step loop) and the
   bound, whose operations count only the steps inside each row's
   length. No one PyTorch call computes this function (``nn.LSTM`` has
   no peepholes and owns its input projection): ``library_ms`` is null.
   The forward at B 1 gives the serial cost of a step (barrier, carry
   round trip, cell latency) with almost no arithmetic. Then above H 512
   (8 or 16 units a block, the slices of ``w`` in global scratch): T 16,
   B 64 at H 1024 (timed beside plain and bound) and H 700, and above
   16 units on every SM (groups of 16 units in passes): T 4, B 2 at
   H 2113, the same checks. Each shape prints which backward kernel ran
   (``fused_rnn.rnn_kernel_for``: the cluster kernel with its cluster
   size, units and blocks, or the grid kernel) in each direction. At the
   training shape and at the edge the forward (the cluster kernel) runs
   twice with the same bits and is held to the grid kernel in the same
   run (the plan emptied); at the training shape both are timed by events
   and by device time, bound at 3xTF32 and at the SIMT rate; the
   backward is also split by kernel in a profiler window (the
   time loop, the ``dw`` product, the rest), timed against the grid
   kernel in the same run (the plan emptied), and bound twice: its
   FLOPs as three TF32 products at 495 TFLOP/s and at 67 TFLOP/s fp32
   outside the tensor cores.
9. LSTM training: ``stacked_dynamic_lstm.build()`` at its defaults
   (dict 5000, emb 512, hid 512, 3 layers, max_len 100, peepholes on,
   Adam at 1e-3; seeded weights carried in through
   ``lstm_params_from_jax``) takes 10 steps on one seeded batch of 64
   ragged sequences whose label is a function of the words. The launch
   counts are zeroed just before and read just after. Checks: every
   step launched each LSTM kernel 3 times (one per layer); the first 3
   losses agree within rtol 1e-3 with the same model on the CPU (the
   plain versions) from the same weights and feeds; losses finite, the
   last below the first. Prints step p50, words/s (valid and padded),
   peak memory and a 3-step ``torch.profiler`` window with the LSTM
   kernels' share of device time, and by profiler name each LSTM kernel's
   launches and device time a step (the cluster forward and backward 3 a
   step each, the grid kernels none: checked). Then the same 10 steps
   from the same weights under ``rewrite_program_amp(pure=None)``, which
   picks conservative mode for a model with LSTMs: the products in bf16,
   the LSTM kernels fp32 (3 + 3 a step by count and by name, checked),
   the first 3 losses within rtol 0.05 of the fp32 run's; the same
   numbers beside fp32's.
10. GRU kernels: the whole-sequence GRU forward and backward kernels at
    the shapes of phase 11 (T 32, B 64, H 512; seeded ``xproj`` x 0.4,
    ``w`` x H**-0.5, ``h0`` x 0.3, ragged lengths 1-32 with one full row,
    non-uniform cotangents on both outputs) and at an edge shape (T 7,
    B 5, H 100): the forward's outputs (hidden, h_last and the ``rh``
    residual) and the backward's three against the plain PyTorch versions
    (rtol 1e-4 / atol 1e-5 forward, rtol 1e-3 / atol 1e-4 gradients),
    ``hidden`` exactly 0 past each length, two runs of the backward
    bit-equal. Timed as in phase 3 beside the plain versions (the step
    loop; the explicit backward formulae; autograd through the step loop)
    and the bound over the live (row, step) pairs. No one PyTorch call
    computes this function (``nn.GRU`` applies the reset after its
    product and owns the input projection): ``library_ms`` is null. The
    forward at B 1 gives the serial cost of a step. At the training shape
    and at the edge the forward (the cluster kernel up to H 512, as for
    the LSTM in phase 8) runs twice with the same bits and is held to the
    grid kernel run in the same process (the plan emptied) within the
    forward's tolerance; at the training shape both are timed by events
    and by device time (the call and the recurrent kernel alone, a
    profiler window) and bound at 3xTF32 and at the SIMT rate. The
    backward (the cluster kernel up to H 512) is also split by kernel
    in a profiler window (the loop, ``dw``, the rest), held to the grid
    kernel run in the same process (the plan emptied; timed) within the
    gradients' tolerance, and bound at 3xTF32 and at the SIMT rate; each
    shape prints which kernel each direction ran. Then above H 512: T
    16, B 64 at H 1024 (timed) and H 700, x [1, 1, 1539] (H 513, the
    least width above 512), and above 16 units on every SM (groups of 16
    units in passes) x [1, 1, 6339] and T 4, B 2 at H 2113, the same
    checks, each direction the grid kernel (checked).
11. MT training: ``machine_translation.build()`` at emb 512, hid 512,
    vocabularies 10000, max_len 32 (seeded weights carried in through
    ``mt_params_from_jax``) takes 10 steps of 64 fresh seeded pairs (the
    first target the first source id, then the chain ``(7 x + 3) % V``;
    ids over the whole vocabulary), lazy Adam over row-sparse table
    gradients. The launch counts of every kernel module are zeroed just
    before and read just after. Checks: every step launched each GRU
    kernel twice (encoder, decoder) and nothing else, by profiler name
    the forward's and the backward's cluster kernels both times (the grid
    kernels where the plan picks them); losses finite, the
    last below the first; the table rows no batch touched bit-equal to
    their start and every touched row moved; the first 3 losses within
    rtol 1e-3 of the same model on the CPU from the same weights and
    feeds. Prints step p50, words/s (2048 target words over it), peak
    memory and a 3-step ``torch.profiler`` window.
12. MT beam decode: ``generate`` (beam 4, 32 steps) on 64 seeded sources
    with the weights after phase 11; counts zeroed just before, read just
    after: one GRU forward launch (the encoder) and nothing else. Against
    the same call on a CPU copy of the model: equal token streams, where a
    row may diverge only at a near tie (at the first step whose selection
    differs, the CPU's candidate scores at the first differing rank and
    the next within 1e-4; counted), the other rows' lane scores within
    rtol 1e-4, all sorted descending. Prints the p50 of a call,
    sequences/s and a 3-call profiler window, in which the forward launch
    of each call is the cluster kernel by profiler name (the grid kernel
    where the plan picks it: checked).
13. Pooling kernels: the masked sequence pool at the classifier's pools
    of phase 14 (B 128, T 100, D 512, ragged lengths 1-100 with one full
    row; SUM, AVERAGE and SQRT) and at an edge shape (B 5, T 7, D 100,
    one zero length), and the embedding gather + pool at the op
    program's shape of phase 15 (V 5000, D 128, B 128, T 100, ragged) and
    at an edge shape (V 37, D 100, B 5, T 7, no lengths), each against its
    plain version (rtol 1e-5 of the same pool of the absolute values,
    atol 1e-6: fp32 sums in another order, whose error grows with the
    terms' magnitudes, not with the sum, which cancels; beside the max
    error it prints the element where an rtol of |plain| itself would be
    tightest: its error, |plain| and the pool of |x|); both
    kernels at the other dtypes the JAX op pools (fp64, fp16, bf16,
    int32, bool, complex64, float8 e4m3fn, e5m2, e4m3fnuz and e5m2fnuz
    (the fnuz pair bit for bit), uint16, uint32, uint64) at a small
    ragged shape; timed as in phase 3
    beside the plain version, the bound (bytes over 3.35 TB/s: the live
    rows of x, or each distinct row of the table that a live id names,
    the live ids, the lengths and the output) and, for the gather +
    pool, ``F.embedding_bag`` over the live ids (held to its plain
    version first; no one PyTorch call pools a padded batch by lengths:
    the pool's ``library_ms`` is null). The gather + pool and
    ``F.embedding_bag`` are timed in turns, kernel then library then
    library then kernel, in 6 rounds of 50 launches each: the medians
    and the spread of the rounds, the kernel's ``ms`` the median; and by
    their device time alone (a profiler window, each call after the same
    L2 flush). The sequence pool, too, by its device time alone after the
    same flush, in each mode.
14. Text-conv training: the PaddlePaddle book's understand_sentiment
    ``convolution_net`` from the port's entry points (``lookup_table``
    with a sparse table gradient, two ``nets.SequenceConvPool`` of filter
    sizes 3 and 4, tanh, ``"sqrt"`` pools, a softmax ``fc`` over both,
    ``cross_entropy``, ``mean``, ``optimizer.Adagrad`` at 0.002) at the
    book's widths (emb 128, 512 filters) over the repo's IMDB data
    configuration (dict 5000, max_len 100; seeded weights carried in
    through ``textconv_params_from_jax``) takes 10 steps, each on a
    fresh seeded batch of 128 ragged rows whose label is a function of
    the words (each row leans to one half of the vocabulary), TF32 off.
    Counts zeroed just before and read just after: every step
    launched the sequence-pool kernel twice and nothing else; losses
    finite, the last below the first; the first 3 losses within rtol 1e-3
    of the same model on the CPU. Prints step p50, words/s, peak memory
    and a 3-step profiler window (device busy, idle share).
15. The ``fused_embedding_seq_pool`` op program (the op, ``mean``, lazy
    Adam at 0.05 over its row-sparse table gradient) at V 5000, D 128,
    B 128, T 100, 10 steps of fresh seeded ids over the table's first
    four fifths: one gather + pool launch a step and nothing else; the
    rows read inside no length bit-equal, every row read inside one
    moved; the first 3 losses within rtol 1e-3 of the CPU's.
16. The hot-rows cache's kernels: the row gather and the in-place row
    scatter, each one launch over F families (``gather_rows_families``,
    ``scatter_rows_families``), bit-equal to their plain versions at F 1,
    2 and 3, at rows of 17, 16 and 18 fp32 and 7 uint8 (4-, 16-, 8- and
    1-byte words), with K 8192 distinct slots of 32769 rows and at an
    edge of K 5 (slots R - 1, R and R + 1 among them): every family
    written through its own storage, every other row unchanged; at F 1
    the single-family wrappers too. Timed at deepfm's cache [32769, 17]
    fp32, F 1 and F 3, at K 8192 and at phase 17's most used bucket (4096
    slots, 3719 live, the rest padding; ``CACHE_BUCKET``), each shape
    first held bit-equal to its plain version on the inputs it is timed
    on, as in phase 3: by events and by device time after the L2 flush,
    beside the plain version, F calls of ``index_select`` /
    ``index_copy_`` (device time summed), the bound (bytes over 3.35
    TB/s, all F families: the gather's slots, distinct rows read and K
    rows written; the scatter's slots and kept rows, read and written)
    and the device time of an empty kernel on the gather's grid (the
    floor of one launch).
17. deepfm over the hot-rows cache: ``deepfm.build()`` at its defaults
    (26 fields, V 100000, K 16, fc 400 x 3, lazy Adam 1e-3), batch 2048,
    seeded zipf(1.1) ids, seeded weights, TF32 off, the table on 2
    in-process row-range shards behind a 32768-row cache
    (``enable_sharded_table``), 30 steps: each translates the batch's ids
    on the host (pulls and installs the misses, writes dirty evicted rows
    back), then steps the model. Counts zeroed just before the steps and
    the final flush and read just after: the cache kernels and nothing
    else, 1 scatter launch a call that installed, 1 gather launch a call
    that wrote back (the flush's included; each for all three families),
    write-backs in at least 10 steps; the table's and the moments'
    storage unchanged; all losses within rtol 1e-4 of the same model on
    one table on the card (the twin), the first 3 within rtol 1e-3 of the
    CPU's; after the flush the shards hold the twin's rows (rtol 1e-4,
    atol 1e-6). Prints both arms' step p50 and examples/s, the host split
    of a step (translate, pull, write-back, install, model step), hit
    rates by unique id and by occurrence, misses and evictions a step,
    pull and push bytes a step, peak memory and a 3-step profiler window;
    a window over a warmup of the cache (its install and read at each
    bucket) names both cache kernels, no more often than they launched.
    The most used install and write-back buckets, with their median live
    rows, must be ``CACHE_BUCKET``, the shape phase 16 timed.
18. The image classifiers (no kernel of the port on this path: cuDNN's
    convs, PyTorch's pools and batch norms): the seven models of the
    reference's bench.py (mnist, smallnet, alexnet, resnet50, googlenet,
    vgg16, se_resnext50) at their ``build`` defaults (class_dim 1000 at
    224 px; mnist 28 px, smallnet 32 px and 10 classes) and bench.py's
    batches (2048, 512, 256, 128, 128, 64, 64), fp32 with TF32 off, seeded
    weights (``reset_parameters``) and 2 seeded batches of images and
    labels made on the card, 6 steps (the first also plans cuDNN's convs)
    and a 3-step profiler window each. Counts of every kernel module zeroed
    just before and read just after: none launched. Checks: losses finite;
    the first 3 losses at batch 8 (lr 1e-4, ``IMAGE_ORACLE_LR`` says why)
    within rtol 1e-3 of the same model on the CPU from the same weights and
    batches, dropouts on, their masks from the same seeds. ResNet-50 also
    under pure AMP (``rewrite_program_amp``): its first 3 losses within
    rtol 0.05 of fp32's. Prints per model images/s, step p50 (and the
    first step), device busy a step, idle share, peak memory, launches a
    step, the conv and GEMM kernels' share of device time, the top 8
    device kernels by name, and the model FLOPs a step beside their fp32
    and bf16 bounds (``image_flops``); for ResNet-50 AMP beside fp32.
19. The contiguous KV layout and the wave engine (no kernel of the port
    on these paths: they attend over the cache as it lies; run right
    after phase 4b, on phase 4's model and requests): (a)
    ``make_slot_model(layout="contiguous")`` (16 slots, buckets
    32/64/128) serves the 24 requests; its streams must pass the oracle
    as phase 4's do, and whether they equal phase 4's paged
    ``kv_codec="none"`` streams token for token is printed (a parting
    must be at a near tie, ``NEAR_TIE``); tokens/s, decode-step p50 and a
    profiler window of 20 decode steps (device busy, idle share) beside
    phase 4's paged step. (b) The same engine with ``spec_k`` 4 and the
    n-gram drafter: streams equal (a)'s up to near ties, tokens committed
    per slot per dispatch, a window of full verify dispatches (device
    busy per committed token beside (a)'s step). (c) ``GenerativeModel``
    (``BucketPolicy.pow2(16)``, the same prompt ladder) serves the 20
    greedy requests in waves of up to 16 at each wave's largest budget;
    each stream cut to its budget equals (a)'s up to near ties; tokens/s,
    prefill p50 by prompt bucket, decode-step p50, a profiler window of
    20 decode steps of a wave of 16; ``full_forward_generate`` on 4
    prompts at ``max_new`` 32 equals the wave's streams (near ties
    aside), its tokens/s beside the wave's (the KV cache's speedup), and
    ``decode_flops`` / ``full_forward_flops`` at batch bucket 4. The
    page-gather counts, zeroed just before each path and read just
    after, must stay 0, and no profiler window may name a page gather.
    Its JSON line is ``{"contiguous_layout": ...}``.
20. The model server (run last, on phase 4's model and requests, kept
    for it: its profiler window, opened on the server's scheduler thread,
    left phase 9's window one LSTM kernel record short when it ran right
    after phase 19): one ``ModelServer`` hosts (a) the paged slot engine with
    ``kv_codec="int8"``, (b) the same with ``"none"``, (c) the
    contiguous slot engine, (d) the paged spec engine (``spec_k`` 4, the
    n-gram drafter) and (e) the wave engine (``BucketPolicy.pow2(16)``),
    and serves on ``127.0.0.1:0``. From 8 client threads, each with its
    own ``ServingClient``, the 24 requests go to (a)-(d), one prompt a
    request with its seed, temperature, top-k and budget, and the 20
    greedy ones to (e). Each stream over the wire must equal the same
    engine's in-process stream of phases 4, 4b and 19 token for token;
    (e)'s, each equal to its wave replayed in process (the batcher forms
    its own waves), are held to phase 19's streams up to near ties. The
    page-gather counts, zeroed just before each run and read just after:
    that codec's kernel twice a layer a decode or verify dispatch for
    (a), (b), (d), none for (c), (e). In two turns (wire then in process,
    then the other way), (a)-(d) also take the 24 requests from 16
    clients, one a slot, so the pool can fill as in process, and the
    same requests go through a twin engine's in-process ``generate``:
    tokens/s and requests/s each way, and TTFT and inter-token p50 / p99
    from the histograms. Over the wire a
    request of budget 128 is cancelled after its first tokens: the
    client gets ``RequestCancelledError``, the slot is free within one
    scheduler step. A window of exactly 20 scheduler steps of (b), opened
    and closed on the scheduler thread, while one request of 16 prompts
    keeps every slot busy, timed alone and then under the profiler:
    device busy a step, the idle share against the host time a step with
    the profiler off, the page gathers by name, the host's top ops and the scheduler thread's
    top Python functions (sampled); as in every late window, the page
    gathers named there are a lower bound of the counters'.
    ``paddle_serving_requests_applied_
    total`` and ``..._tokens_generated_total`` of every model equal the
    requests sent and the tokens returned (the cancelled request's, the
    waves' padding to their longest budget, included); a scrape of a
    ``MetricsServer`` shows the latency, TTFT, inter-token and KV page
    families; ``readyz`` answers ready, ``drain`` drains, ``readyz`` then
    answers not ready. Its JSON line is ``{"server": ...}``.
21. The serving fleet (after phase 20): phase 4's seeded weights saved
    as an ``.npz`` under their JAX names, and a port ``Router`` over
    replicas spawned (``python -m paddle_tpu_torch.serving.replica``,
    one process each, loading the kernels phase 2 built) from one spec:
    phase 4's paged engine (16 slots, 256 pages of 16 rows, buckets
    32/64/128, codec none, ``device: "cuda"``). (a) One replica; an
    ``Autoscaler`` (queue-wait SLO 0.01 s) grows the pool to 2 under a
    burst of phase 20's 24 requests from 16 clients through the router;
    (b) those streams, and a second pass's over two replicas, equal
    phase 4's up to near ties, with tokens/s and requests/s beside phase
    20's direct to one server; (c) the replica with the most requests in
    flight is SIGKILLed under load: every request answered, the
    failovers counted, the slot restarted (the time from the kill to
    readyz); (d) ``rolling_restart`` under load: no failure but typed
    sheds, every replica a new process; (f) after a quiet period the
    autoscaler drains the pool back to 1 (its pool 1 -> 2 -> 1); (g) a
    replica whose spec sets ``oom_exit`` and a fault plan raising
    ``MemoryError`` at its first admission exits 42 without a reply,
    every request answered by the survivor; its memdump holds the
    card's allocated bytes (at least the weights' 198 MiB), and the
    router records ``cause="oom"`` and replaces it once with the
    fallback spec; (e) that replica SIGTERMed drains and exits 0; (h) a
    client process's spans chain client -> ``router.route`` -> replica
    in the merged spools (``tools/trace_collect.py``'s checks, the
    killed replicas' torn parents aside). The replicas' page-gather
    launches are not this process's to count. Its JSON line is
    ``{"fleet": ...}``.
22. Report: a ``{"kernels": [...]}`` line (sixteen kernels: the fifteen
    functions of the JAX package that reach ``pl.pallas_call``, with the
    flash backward's two as ``flash_bwd`` and as the dQ and dK/dV kernels
    that run above its range), then, last,
    ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12           # fp32 outside the tensor cores, same
TF32_FLOPS_PER_S = 495e12          # dense tensor cores, same
BF16_FLOPS_PER_S = 989e12
SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
FLASH_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cuh"
FCE_SOURCE = "paddle_tpu_torch/csrc/fused_ce.cu"
LM = dict(vocab=32000, d_model=512, d_inner=2048, n_head=8, n_layer=6)
SERVE = dict(n_slots=16, prompt_buckets=(32, 64, 128), page_size=16,
             n_pages=256)
CACHE_LEN = 256                    # largest bucket 128 + max_new 128
N_REQUESTS = 24
SPEC = dict(spec_k=4)              # phase 4b's verify window: K + 1 = 5
MODEL_DRAFTER_REQUESTS = 4
MODEL_DRAFTER_BUDGET = 32
DECODE_PROFILE_STEPS = 20
SAMPLED = (5, 11, 17, 23)          # request indices served with sampling
SAMPLING = dict(temperature=0.8, top_k=40)
NEAR_TIE = 1e-3
TRAIN = dict(src_vocab=32000, tgt_vocab=32000, max_len=128, d_model=512,
             d_inner=2048, n_head=8, n_layer=6)
BATCH = 32                         # sequences a step: 4096 tokens
TRAIN_STEPS = 10
PROFILE_STEPS = 3
CURVE_RTOL = 1e-3
FLASH_FWD_TOL = dict(rtol=1e-4, atol=1e-5)
FLASH_GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
FLASH_VARIANTS = {"full": (False, 0.0), "causal": (True, 0.0),
                  "dropout": (False, 0.1)}
FLASH_LOW_STEP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
FLASH_MIXED = (("bfloat16", "float32", "float32"),   # q, k, v as the CPU
               ("float32", "float32", "float16"))    # test mixes them
FLASH_LONG = 1024                  # a key length past flash_bwd's 512
FCE_FWD_TOL = dict(rtol=1e-4, atol=1e-5)
FCE_GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
FCE_EDGE = (1000, 100, 1003)       # N, D, V off every tile multiple
FCE_MANTISSA = {"bfloat16": 7, "float16": 10, "float32": 23}
FCE_MIXED = (("bfloat16", "float32"), ("float32", "bfloat16"),
             ("float16", "float32"), ("bfloat16", "float16"))
EVAL_RTOL = 1e-4
TRAIN_RUNS = {"fused_attention": dict(fused_attention=True),
              "composed": dict(fused_attention=False),
              "fused_head": dict(fused_attention=True, fused_head=True)}
# the same runs under pure AMP, each against its fp32 run
AMP_RUNS = {"amp_fused_attention": ("fused_attention",
                                    dict(fused_attention=True)),
            "amp_fused_head": ("fused_head",
                               dict(fused_attention=True, fused_head=True))}
AMP_RTOL = 0.05                    # bf16 against fp32, as the reference
AMP_CHECKED_STEPS = 3
IGNORE = -100
LSTM_SOURCE = "paddle_tpu_torch/csrc/fused_rnn.cu"
LSTM = dict(dict_dim=5000, max_len=100, emb_dim=512, hid_dim=512,
            stacked_num=3)
LSTM_BATCH = 64
LSTM_EDGE = (7, 5, 100)            # T, B, H off every tile multiple
LSTM_FWD_TOL = dict(rtol=1e-4, atol=1e-5)
LSTM_GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
LSTM_ORACLE_STEPS = 3
MT = dict(src_vocab=10000, tgt_vocab=10000, max_len=32, emb_dim=512,
          hid_dim=512)
MT_BATCH = 64
MT_GRU_PER_STEP = 2                # the encoder's and the decoder's GRU
MT_ORACLE_STEPS = 3
GRU_EDGE = (7, 5, 100)             # T, B, H off every tile multiple
GRU_FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRU_GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
BEAM_TIE = 1e-4
BEAM_RTOL = 1e-4
FLASH_WIDTHS = (48, 256, 257, 320)  # padded to 64 / at 256 / 2 chunks of 256
FLASH_BLOCKS = ((257, 1), (640, 2))   # d_model, n_head: head width 257, 320
FCE_WIDE = (4096, 1024, 32000)     # transformer_big's head: N, D, V
FCE_WIDE_EDGE = (300, 700, 1003)
LSTM_WIDE = ((16, 64, 1024), (16, 64, 700), (4, 2, 2113))  # T, B, H > 512
GRU_WIDE = ((16, 64, 1024), (16, 64, 700), (1, 1, 513), (1, 1, 2113),
            (4, 2, 2113))
SEQPOOL_SOURCE = "paddle_tpu_torch/csrc/seqpool.cu"
EMBED_SOURCE = "paddle_tpu_torch/csrc/embed_pool.cu"
POOL_TOL = dict(rtol=1e-5, atol=1e-6)
# the pooling kernels' other dtypes -> rtol of the pool of |x|
# (float8 rounds every partial sum at the same points in both: one float8
# step of the pool of |x| covers a conversion that rounds a tie the other
# way; the fnuz types' hand-written conversions round as torch's do, bit
# for bit: their steps are all above POOL_TOL's atol; unsigned sums are
# exact)
POOL_DTYPES = {"float64": 1e-12, "float16": 2e-3, "bfloat16": 1.6e-2,
               "int32": 0.0, "bool": 0.0, "complex64": 1e-5,
               "float8_e4m3fn": 2.0 ** -3, "float8_e5m2": 2.0 ** -2,
               "float8_e4m3fnuz": 0.0, "float8_e5m2fnuz": 0.0,
               "uint16": 0.0, "uint32": 0.0, "uint64": 0.0}
TEXTCONV = dict(dict_dim=5000, max_len=100, emb_dim=128, num_filters=512,
                classes=2)
TEXTCONV_BATCH = 128
TEXTCONV_LR = 0.002
TEXTCONV_POOLS_PER_STEP = 2        # the filter-3 and the filter-4 pool
TEXTCONV_ORACLE_STEPS = 3
SEQPOOL = (TEXTCONV_BATCH, TEXTCONV["max_len"], TEXTCONV["num_filters"])
SEQPOOL_EDGE = (5, 7, 100)         # B, T, D
OP_PROGRAM = dict(vocab=5000, dim=128, max_len=100)
OP_PROGRAM_BATCH = 128
EMBED_POOL = (OP_PROGRAM["vocab"], OP_PROGRAM["dim"], OP_PROGRAM_BATCH,
              OP_PROGRAM["max_len"])
EMBED_EDGE = (37, 100, 5, 7)       # V, D, B, T
EMBED_ROUNDS = 6                   # interleaved timing rounds
CACHE_SOURCE = "paddle_tpu_torch/csrc/embed_cache.cu"
DEEPFM = dict(num_fields=26, vocab_size=100000, embed_dim=16, lr=1e-3)
DEEPFM_BATCH = 2048                # README.md's DeepFM row
DEEPFM_STEPS = 30
DEEPFM_SHARDS = 2
CACHE_CAPACITY = 32768
CACHE_ROWS = (CACHE_CAPACITY + 1, DEEPFM["embed_dim"] + 1)
CACHE_K = 8192
ZIPF_A = 1.1
DEEPFM_RTOL = 1e-4                 # cached against the single-table twin
DEEPFM_ORACLE_STEPS = 3
DEEPFM_ROWS_TOL = dict(rtol=1e-4, atol=1e-6)
CACHE_FAMILIES = 3                 # param, moment1, moment2
CACHE_WIDTHS = ((17, "float32"), (16, "float32"), (18, "float32"),
                (7, "uint8"))      # 4-, 16-, 8- and 1-byte words
# phase 17's most used bucket, of installs and write-backs alike, and the
# median of its live rows (fixed by the seeds)
CACHE_BUCKET = (4096, 3719)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# an empty kernel, timed beside the cache kernels as the floor of one launch
FLOOR_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void launch_floor_kernel() {}
extern "C" int launch_floor(unsigned blocks, unsigned threads,
                            void* stream) {
  launch_floor_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
"""


def start_floor_build(build):
    """Start ``nvcc`` on ``FLOOR_SOURCE`` into the build directory, with
    the port's flags; returns a function that waits for it and returns
    the library's ``launch_floor(blocks, threads, stream)``."""
    out = build.BUILD_DIR.parent / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "launch_floor.cu", out / f"launch_floor.{os.getpid()}.so"
    src.write_text(FLOOR_SOURCE)
    proc = subprocess.Popen(
        [build.nvcc(), *[f for f in build.NVCC_FLAGS
                         if f not in ("-Xptxas", "-v")], "-o", str(lib),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)

    def finish():
        text, _ = proc.communicate()
        if proc.returncode:
            fail(f"the empty kernel did not build:\n{text[-4000:]}")
        launch = ctypes.CDLL(str(lib)).launch_floor
        launch.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
        launch.restype = ctypes.c_int
        return launch
    return finish


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# -- phase 3: kernels -------------------------------------------------------

def decode_rows(rng, n_slots, max_pages, n_pages, page_size):
    """A decode step's gather rows: each slot's page table holds a random
    span of distinct pages, then the sentinel ``n_pages``."""
    table = np.full((n_slots, max_pages), n_pages, np.int64)
    free = list(rng.permutation(n_pages))
    for s in range(n_slots):
        span = int(rng.randint(1, max_pages + 1))
        table[s, :span] = [free.pop() for _ in range(span)]
    j = np.arange(page_size)
    return (table[:, :, None] * page_size + j).reshape(-1).astype(np.int32)


def time_ms(torch, fn, flush, n=50, warm=5):
    """Median device time of one call, L2 flushed before each."""
    for _ in range(warm):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for a, b in ev:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def flushed_device_ms(torch, fn, flush, n=20, tries=3):
    """Device ms a call of ``fn`` alone, each call after the same L2 flush:
    its kernels' time in a profiler window, the flush's fill left out (CUDA
    events also count the host's launch where it outlasts the kernel). A
    window that saw none of its kernels is taken again; None (not measured)
    after ``tries`` such windows."""
    for _ in range(tries):
        split = kernel_split(torch, lambda: (flush.zero_(), fn()), n=n)
        ms = sum(v for k, v in split.items() if "FillFunctor" not in k)
        if ms > 0:
            return ms
    return None


def us(ms):
    """Milliseconds as printed microseconds, or "not measured"."""
    return "not measured" if ms is None else f"{ms * 1e3:.2f} us"


# the dequantizing gather's edge shapes: (pool rows, heads, head width,
# gathered rows, rows) -- one row; rows off a block's 32; only sentinels;
# head widths 16 and 48 (the row kernel) and 6 (the scalar kernel)
DEQUANT_EDGES = ((4096, 8, 64, 1, "random"), (4096, 8, 64, 37, "random"),
                 (300, 8, 64, 100, "sentinels"), (64, 4, 16, 50, "random"),
                 (64, 8, 48, 33, "random"), (64, 3, 6, 70, "random"))


def dequant_edges(torch, dev, card, pa):
    """The dequantizing gather bit-equal to its plain version at
    ``DEQUANT_EDGES``; returns the largest error (0)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    for r, heads, dk, k, kind in DEQUANT_EDGES:
        codes = torch.randint(-127, 128, (r, heads * dk), generator=gen,
                              device=dev, dtype=torch.int32).to(torch.int8)
        scales = torch.rand(r, heads, generator=gen, device=dev) + 1e-3
        rows = (torch.randint(0, r + 16, (k,), generator=gen, device=dev,
                              dtype=torch.int32) if kind == "random" else
                torch.full((k,), r + 3, dtype=torch.int32, device=dev))
        got = pa.gather_rows_dequant(codes, scales, rows, heads)
        want = pa.gather_rows_dequant_ref(codes, scales, rows, heads)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"gather_rows_dequant [{r}x{heads * dk}], {heads} heads, "
                 f"K {k} ({kind}) differs from its plain version (max abs "
                 f"err {float((got - want).abs().max())})")
    print(f"[{card}] gather_rows_dequant at the edges (pool rows, heads, "
          f"head width, K, rows: {[e for e in DEQUANT_EDGES]}): bit-equal")
    return 0.0


def kernel_phase(torch, dev, card):
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    g = SERVE
    r = g["n_pages"] * g["page_size"]
    width, heads = LM["d_model"], LM["n_head"]
    rng = np.random.RandomState(0)
    rows_np = decode_rows(rng, g["n_slots"], CACHE_LEN // g["page_size"],
                          g["n_pages"], g["page_size"])
    rows = torch.from_numpy(rows_np).to(dev)
    k = rows.shape[0]
    uniq = int(np.unique(np.minimum(rows_np, r - 1)).size)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    idx_bytes = k * 4
    results = {}

    def measure(name, fn, ref, lib, nbytes):
        got, want = fn(), ref()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{name}: kernel gives {tuple(got.shape)} {got.dtype}, "
                 f"plain version {tuple(want.shape)} {want.dtype}")
        err = float((got.float() - want.float()).abs().max())
        if not torch.equal(got, want):
            fail(f"{name}: kernel differs from its plain version "
                 f"(max abs err {err})")
        if not torch.equal(lib(), want):
            fail(f"{name}: the library yardstick computes another function")
        row = {"max_abs_err": err, "ms": time_ms(torch, fn, flush),
               "plain_ms": time_ms(torch, ref, flush),
               "library_ms": time_ms(torch, lib, flush),
               "device_ms": flushed_device_ms(torch, fn, flush),
               "library_device_ms": flushed_device_ms(torch, lib, flush),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "bytes": nbytes, "distinct_rows": uniq}
        print(f"[{card}] {name}: exact; kernel {row['ms'] * 1e3:.2f} us "
              f"(device {us(row['device_ms'])}), plain "
              f"{row['plain_ms'] * 1e3:.2f} us, library "
              f"{row['library_ms'] * 1e3:.2f} us (device "
              f"{us(row['library_device_ms'])}), bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({nbytes / 1e6:.2f} MB: "
              f"{uniq} distinct pool rows read)")
        return row

    for label, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        pool = torch.randn(r, width, generator=gen, device=dev).to(dt)
        row_b = width * pool.element_size()
        results[f"gather_rows/{label}"] = measure(
            f"gather_rows {label} [{r}x{width}] -> [{k}x{width}]",
            lambda: pa.gather_rows(pool, rows),
            lambda: pa.gather_rows_ref(pool, rows),
            lambda: pool.index_select(0, rows.clamp_max(r - 1)),
            uniq * row_b + idx_bytes + k * row_b)
    codes = torch.randint(-127, 128, (r, width), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
    scales = torch.rand(r, heads, generator=gen, device=dev) + 1e-3

    def dequant_lib():
        i = rows.clamp_max(r - 1)
        return (codes.index_select(0, i).float().view(k, heads, -1)
                * scales.index_select(0, i)[:, :, None]).view(k, width)
    results["gather_rows_dequant/int8"] = measure(
        f"gather_rows_dequant int8 [{r}x{width}], {heads} heads -> "
        f"[{k}x{width}] fp32",
        lambda: pa.gather_rows_dequant(codes, scales, rows, heads),
        lambda: pa.gather_rows_dequant_ref(codes, scales, rows, heads),
        dequant_lib, uniq * (width + heads * 4) + idx_bytes + k * width * 4)
    results["gather_rows_dequant/int8"]["edge_max_abs_err"] = dequant_edges(
        torch, dev, card, pa)
    del flush
    return results


# -- phase 4: the slice -----------------------------------------------------

def random_params(seed: int) -> dict:
    """Seeded weights under the JAX scope names of decoder_lm."""
    rng = np.random.RandomState(seed)
    m, i, v = LM["d_model"], LM["d_inner"], LM["vocab"]

    def normal(shape, fan_in):
        return rng.normal(0.0, fan_in ** -0.5, shape).astype(np.float32)
    p = {"lm_emb": normal((v, m), m), "lm_head_w": normal((m, v), m),
         "lm_lnf_scale": np.ones(m, np.float32),
         "lm_lnf_bias": np.zeros(m, np.float32)}
    for layer in range(LM["n_layer"]):
        pre = f"lm_l{layer}_"
        for w in ("wq", "wk", "wv", "wo"):
            p[f"{pre}attn.{w}"] = normal((m, m), m)
        for ln in ("ln1", "ln2"):
            p[f"{pre}{ln}_scale"] = np.ones(m, np.float32)
            p[f"{pre}{ln}_bias"] = np.zeros(m, np.float32)
        p[pre + "ffn1_w"] = normal((m, i), m)
        p[pre + "ffn1_b"] = np.zeros(i, np.float32)
        p[pre + "ffn2_w"] = normal((i, m), i)
        p[pre + "ffn2_b"] = np.zeros(m, np.float32)
    return p


def requests(seed: int):
    """24 prompts (lengths 5..128; requests 0-3 share a 64-token prefix),
    their budgets (32..128), temperatures and top-k, and seeds."""
    rng = np.random.RandomState(seed)
    v = LM["vocab"]
    prefix = rng.randint(1, v, 64)
    prompts, budgets = [], []
    for n in range(N_REQUESTS):
        if n < 4:
            tail = rng.randint(1, v, int(rng.randint(1, 33)))
            prompts.append(np.concatenate([prefix, tail]))
        else:
            prompts.append(rng.randint(1, v, int(rng.randint(5, 129))))
        budgets.append(int(rng.randint(32, 129)))
    temps = [SAMPLING["temperature"] if n in SAMPLED else 0.0
             for n in range(N_REQUESTS)]
    topks = [SAMPLING["top_k"] if n in SAMPLED else 0
             for n in range(N_REQUESTS)]
    seeds = [int(s) for s in rng.randint(0, 2 ** 62, N_REQUESTS)]
    return prompts, budgets, temps, topks, seeds


def serve(torch, engine, reqs, card, label):
    """One ``generate`` over the requests, timing each admission
    (prefill) and decode step on the host clock: both end in the one
    device wait of the call, the read of its tokens. A paged engine must
    have shared a prefix page."""
    prompts, budgets, temps, topks, seeds = reqs
    prefill_ms, step_ms, shared = {}, [], []
    admit, step = engine.admit, engine.step

    from paddle_tpu_torch.serving.engine import PagedSlotGenerativeModel
    pool = engine.pool if isinstance(engine, PagedSlotGenerativeModel) \
        else None

    def timed_admit(prompt, **kw):
        t = time.perf_counter()
        out = admit(prompt, **kw)
        bucket = engine.prompt_bucket_for(len(prompt))
        prefill_ms.setdefault(bucket, []).append(
            (time.perf_counter() - t) * 1e3)
        lease = pool.lease(out[0]) if pool is not None else None
        shared.append(lease.n_shared if lease is not None else 0)
        return out

    def timed_step():
        t = time.perf_counter()
        out = step()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out
    engine.admit, engine.step = timed_admit, timed_step
    before = counters(engine)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        streams = engine.generate(prompts, max_new=budgets,
                                  temperature=temps, top_k=topks,
                                  seeds=seeds)
    finally:
        del engine.admit, engine.step
    wall = time.perf_counter() - t0
    after = counters(engine)
    steps = after["decode_steps"] - before["decode_steps"]
    tokens = after["tokens_generated"] - before["tokens_generated"]
    for n, s in enumerate(streams):
        if s.shape != (budgets[n],) or s.min() < 0 or s.max() >= LM["vocab"]:
            fail(f"{label}: request {n} gave {s.shape} tokens in "
                 f"[{s.min()}, {s.max()}], want {budgets[n]} in "
                 f"[0, {LM['vocab']})")
    if pool is not None and sum(shared) == 0:
        fail(f"{label}: no admission shared a prefix page")
    stats = {"tokens": tokens, "decode_steps": steps, "wall_s": wall,
             "tokens_per_s": tokens / wall,
             "decode_step_p50_ms": float(np.median(step_ms)),
             "prefill_ms": {b: float(np.median(v))
                            for b, v in sorted(prefill_ms.items())},
             "shared_prefix_pages": int(sum(shared)),
             "peak_mem_bytes": int(torch.cuda.max_memory_allocated())}
    print(f"[{card}] {label}: {tokens} tokens in {wall:.3f} s = "
          f"{stats['tokens_per_s']:.1f} tokens/s; {steps} decode steps, "
          f"p50 {stats['decode_step_p50_ms']:.3f} ms; prefill p50 ms by "
          f"bucket {json.dumps(stats['prefill_ms'])}; "
          f"{stats['shared_prefix_pages']} prefix pages shared; peak "
          f"memory {stats['peak_mem_bytes'] / 2 ** 20:.1f} MiB")
    return streams, stats


def oracle_scores(torch, lm, reqs, n, stream):
    """The scores [len(stream), V] (fp64) that request ``n``'s tokens are
    chosen from by the ``full`` view recomputed over its prompt and
    ``stream`` (teacher forcing): the logits, for a sampled request
    scaled, top-k masked and with the request's Gumbel noise added."""
    from paddle_tpu_torch.ops import kv_attention as kva
    prompts, _, temps, topks, seeds = reqs
    prompt = prompts[n]
    seq = np.concatenate([prompt, stream[:-1]])
    logits = lm.full(torch.from_numpy(seq[None]))[0]
    p0 = len(prompt) - 1
    lg = logits[p0:p0 + len(stream)].double()
    if temps[n] <= 0:
        return lg
    steps = torch.arange(len(stream))
    scores = lg / temps[n]
    kth = scores.topk(topks[n], dim=-1).values[:, -1:]
    scores = scores.masked_fill(scores < kth, float("-inf"))
    noise = kva.gumbel_noise(torch.full_like(steps, seeds[n]), steps,
                             lg.shape[-1])
    return scores + noise.to(lg)


def near_tie(row, *tokens):
    """Whether the top-2 gap of a score row is under ``NEAR_TIE`` and
    every one of ``tokens`` scores within it of the top."""
    top2 = row.topk(2).values
    return float(top2[0] - top2[1]) < NEAR_TIE and all(
        float(top2[0] - row[int(t)]) < NEAR_TIE for t in tokens)


def oracle_check(torch, lm, reqs, streams, label, first_only=False):
    """Hold each stream against the ``full`` view recomputed over the
    prompt and the stream itself (teacher forcing: if every token is
    the oracle's choice given the tokens before it, the oracle's own
    generation is the same stream). Returns the near ties accepted."""
    ties = 0
    for n, stream in enumerate(streams):
        scores = oracle_scores(torch, lm, reqs, n, stream)
        want = scores.argmax(-1).cpu().numpy()
        n_check = 1 if first_only else len(stream)
        bad = np.flatnonzero(want[:n_check] != stream[:n_check])
        if bad.size:
            i = int(bad[0])
            if not near_tie(scores[i], stream[i]):
                top2 = scores[i].topk(2).values
                fail(f"{label}: request {n} token {i} is {stream[i]}, the "
                     f"oracle's is {want[i]} (top-2 gap "
                     f"{float(top2[0] - top2[1]):.3g})")
            ties += 1
    return ties


def streams_agree(torch, lm, reqs, want, got, label):
    """Two engines' streams of the same requests: equal, or parting first
    at a near tie of the ``full`` view (teacher-forced over the common
    prefix; after it the streams may differ). Returns (equal streams,
    near ties)."""
    equal = ties = 0
    for n, (a, b) in enumerate(zip(want, got)):
        if len(a) != len(b):
            fail(f"{label}: request {n} gave {len(b)} tokens, want {len(a)}")
        bad = np.flatnonzero(a != b)
        if not bad.size:
            equal += 1
            continue
        i = int(bad[0])
        row = oracle_scores(torch, lm, reqs, n, a[:i + 1])[i]
        if not near_tie(row, a[i], b[i]):
            fail(f"{label}: request {n} parts at token {i} ({a[i]} against "
                 f"{b[i]}) away from a near tie")
        ties += 1
    return equal, ties


GATHER_KERNELS = {"gather_rows": "gather_rows_kernel",
                  "gather_rows_dequant": "gather_rows_dequant_kernel"}


def check_gathers(kernels, kname, n, label, what):
    """By profiler name: the page gathers of a window (``what``) ran
    ``kname``'s kernel ``n`` times and no other; ``kname`` None (the
    contiguous layout): no page gather ran. Returns what was seen."""
    ran = {ev.key: ev.count for ev in kernels if "gather_rows" in ev.key}
    if kname is None:
        if ran:
            fail(f"{label}: {what} ran page gathers {ran}, want none")
        return "no page gather"
    want = GATHER_KERNELS[kname]
    if sum(ran.values()) != n or any(want not in key for key in ran):
        fail(f"{label}: the page gathers of {what} ran {ran}, want {n} of "
             f"{want}")
    return f"all {want}"


def decode_busy(torch, engine, card, label, kname, per_layer,
                steps=DECODE_PROFILE_STEPS):
    """Device busy per decode step of ``engine`` (every slot filled with
    a seeded 64-token prompt, 5 untraced steps, then ``steps`` in a
    profiler window), its idle share, and by profiler name that every page
    gather of the window ran ``kname``'s kernel (``per_layer`` a step;
    ``kname`` None: no page gather)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(3)
    for _ in range(engine.n_slots):
        engine.admit(rng.randint(1, LM["vocab"], 64), max_new=128)
    for _ in range(5):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    engine.reset()
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0]
    busy_us = sum(ev.self_device_time_total for ev in kernels)
    seen = check_gathers(kernels, kname, per_layer * steps, label,
                         f"{steps} decode steps")
    gather_us = sum(ev.self_device_time_total for ev in kernels
                    if "gather_rows" in ev.key)
    out = {"device_busy_ms_per_step": busy_us / steps / 1e3,
           "host_ms_per_step": wall_ms / steps,
           "gather_us_per_step": gather_us / steps,
           "launches_per_step": sum(ev.count for ev in kernels) / steps,
           "top_host_ops_us_per_step": host_top(torch, prof, steps)}
    out["idle_share"] = 1.0 - out["device_busy_ms_per_step"] / out[
        "host_ms_per_step"]
    print(f"[{card}] {label} profile ({steps} decode steps of "
          f"{engine.n_slots} slots): device busy "
          f"{out['device_busy_ms_per_step']:.3f} ms/step (as "
          f"tools/torch_decode_profile.py reads it), host "
          f"{out['host_ms_per_step']:.3f} ms/step "
          f"(profiler on), idle share {out['idle_share']:.3f}; page gathers "
          f"{out['gather_us_per_step']:.1f} us/step, {per_layer} a step, "
          f"{seen}; top host ops us/step (self CPU time) "
          f"{json.dumps(rounded(out['top_host_ops_us_per_step']))}")
    return out


def decoder_lm(dev):
    """Phase 4's model: Transformer-base width, seeded random weights."""
    from paddle_tpu_torch.models import convert
    from paddle_tpu_torch.models.transformer import DecoderLM
    lm = DecoderLM(**LM, cache_len=CACHE_LEN, device=dev)
    lm.load_state_dict(convert.params_from_jax(random_params(1)))
    return lm


def slice_phase(torch, dev, card):
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.serving.engine import make_slot_model
    lm = decoder_lm(dev)
    engines = {codec: make_slot_model(f"decoder_lm_{codec}", lm,
                                      layout="paged", kv_codec=codec,
                                      device=dev, **SERVE)
               for codec in ("none", "int8")}
    for e in engines.values():
        e.warmup()
    reqs = requests(2)
    per_layer = 2 * LM["n_layer"]            # K and V in every layer
    pa.reset_launches()
    streams, stats, launches = {}, {}, {}
    for codec, kname in (("none", "gather_rows"),
                         ("int8", "gather_rows_dequant")):
        before = dict(pa.LAUNCHES)
        streams[codec], stats[codec] = serve(
            torch, engines[codec], reqs, card, f"kv_codec={codec}")
        launches[codec] = {k: pa.LAUNCHES[k] - before[k]
                           for k in pa.LAUNCHES}
    main_path_launches = dict(pa.LAUNCHES)
    for codec, kname in (("none", "gather_rows"),
                         ("int8", "gather_rows_dequant")):
        want = per_layer * stats[codec]["decode_steps"]
        if launches[codec][kname] != want:
            fail(f"kv_codec={codec}: {kname} launched "
                 f"{launches[codec][kname]} times, want {want}")
    print(f"[{card}] launches on the main path: {main_path_launches} "
          f"({per_layer} per decode step)")
    ties = oracle_check(torch, lm, reqs, streams["none"], "kv_codec=none")
    print(f"[{card}] kv_codec=none: {N_REQUESTS} streams equal the fp32 "
          f"full-view oracle ({ties} near ties)")
    ties = oracle_check(torch, lm, reqs, streams["int8"], "kv_codec=int8",
                        first_only=True)
    again, _ = serve(torch, engines["int8"], reqs, card,
                     "kv_codec=int8 replay")
    if any(not np.array_equal(a, b) for a, b in zip(streams["int8"], again)):
        fail("kv_codec=int8: a second run gave other streams")
    print(f"[{card}] kv_codec=int8: first tokens equal the oracle's "
          f"({ties} near ties); a second run replays every stream")
    busy = {codec: decode_busy(torch, engines[codec], card,
                               f"kv_codec={codec}", kname, per_layer)
            for codec, kname in (("none", "gather_rows"),
                                 ("int8", "gather_rows_dequant"))}
    return main_path_launches, per_layer, busy, dict(lm=lm, reqs=reqs,
                                                     streams=streams)


# -- phase 4b: speculative decoding ------------------------------------------

class ScriptedDrafter:
    """Proposes the continuation of a known stream (prompt + tokens) of
    the request whose prompt begins the history, so windows are full
    until a budget's end; nothing where the history has left that stream
    (a near tie the verify step resolved otherwise)."""

    def __init__(self, prompts, streams):
        self.targets = {tuple(int(t) for t in p):
                        [int(t) for t in p] + [int(t) for t in s]
                        for p, s in zip(prompts, streams)}
        self.lengths = sorted({len(p) for p in self.targets}, reverse=True)

    def propose(self, tokens, k):
        n = len(tokens)
        for length in self.lengths:
            target = self.targets.get(tuple(tokens[:length]))
            if target is not None:
                return target[n:n + k] if target[:n] == list(tokens) \
                    else []
        return []


def spec_stats(engine, before, label, card):
    """The verify dispatches, proposed / accepted drafts and the mean
    tokens committed per slot per dispatch since ``before`` (a copy of
    :func:`counters` of the engine)."""
    now = counters(engine)
    commits = now["tokens_per_step"] - before["tokens_per_step"]
    out = {"verify_dispatches": now["decode_steps"] - before["decode_steps"],
           "proposed": now["spec_proposed"] - before["spec_proposed"],
           "accepted": now["spec_accepted"] - before["spec_accepted"],
           "committed_per_slot_dispatch":
               sum(n * c for n, c in commits.items())
               / max(1, sum(commits.values())),
           "commits": dict(sorted(commits.items()))}
    print(f"[{card}] {label}: {out['verify_dispatches']} verify dispatches, "
          f"{out['proposed']} drafts proposed, {out['accepted']} accepted; "
          f"{out['committed_per_slot_dispatch']:.3f} tokens committed per "
          f"slot per dispatch (by count: {json.dumps(out['commits'])})")
    return out


def per_value(hist):
    """A histogram child's observations by value: {upper bound: count}
    over its non-empty buckets (exact for ``paddle_serving_tokens_per_step``
    up to 6, whose buckets are one token wide there)."""
    from collections import Counter
    out, prev = Counter(), 0
    for ub, cum in hist.snapshot()[0]:
        if cum > prev:
            out[int(ub) if ub != float("inf") else ub] = cum - prev
        prev = cum
    return out


def counters(engine):
    """The engine's serving families, read as ``Family.labels(model=
    engine.name)`` (process-wide: callers take deltas): decode steps,
    tokens generated, prefills, drafts proposed and accepted, and the
    tokens committed a slot a dispatch by count."""
    from paddle_tpu_torch.serving import metrics as sm
    fams = {"decode_steps": sm.DECODE_STEPS,
            "tokens_generated": sm.TOKENS_GENERATED,
            "prefills": sm.PREFILLS, "spec_proposed": sm.SPEC_PROPOSED,
            "spec_accepted": sm.SPEC_ACCEPTED}
    out = {k: int(f.labels(model=engine.name).value)
           for k, f in fams.items()}
    out["tokens_per_step"] = per_value(
        sm.TOKENS_PER_STEP.labels(model=engine.name))
    return out


def spec_serve(torch, engine, reqs, card, label, pa, kname, per_layer):
    """One ``generate`` of ``reqs`` on the spec engine (timed as
    :func:`serve`), its speculation counters, and the page gathers: the
    launch counts zeroed just before and read just after, ``per_layer``
    a verify dispatch, all ``kname``."""
    before = counters(engine)
    timed = engine.drafter = TimedDrafter(engine.drafter)
    pa.reset_launches()
    try:
        streams, stats = serve(torch, engine, reqs, card, label)
    finally:
        engine.drafter = timed.drafter
    launches = dict(pa.LAUNCHES)
    stats.update(spec_stats(engine, before, label, card))
    stats["drafter_ms_per_dispatch"] = (timed.seconds * 1e3
                                        / stats["verify_dispatches"])
    print(f"[{card}] {label}: the drafter took "
          f"{stats['drafter_ms_per_dispatch']:.3f} ms of host time a "
          f"dispatch")
    want = {k: per_layer * stats["verify_dispatches"] if k == kname else 0
            for k in launches}
    if launches != want:
        fail(f"{label}: the page gathers launched {launches}, want {want}")
    stats["launches"] = launches
    return streams, stats


def verify_busy(torch, engine, card, label, kname, per_layer, decode,
                steps=DECODE_PROFILE_STEPS):
    """Device busy per verify dispatch and per committed token with every
    slot busy and every window full (16 seeded 64-token prompts, budget
    128: their streams first taken with the n-gram drafter, then drafted
    by :class:`ScriptedDrafter`; 5 untraced dispatches, then ``steps`` in
    a profiler window), beside the plain engine's decode step
    (``decode``); by profiler name and by the launch counts (zeroed just
    before the window, read just after) every page gather ran ``kname``'s
    kernel, ``per_layer`` a dispatch (``kname`` None: none ran); the sort
    of ``token_sample`` and the gathers' shares of device time."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, LM["vocab"], 64) for _ in range(engine.n_slots)]
    drafter = engine.drafter
    streams = engine.generate(prompts, max_new=128)
    engine.drafter = ScriptedDrafter(prompts, streams)
    try:
        for p in prompts:
            engine.admit(p, max_new=128)
        for _ in range(5):
            engine.step()
        before = counters(engine)
        torch.cuda.synchronize()
        pa.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                engine.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(pa.LAUNCHES)
        stats = spec_stats(engine, before, f"{label} profile window", card)
    finally:
        engine.drafter = drafter
        engine.reset()
    committed = stats["committed_per_slot_dispatch"] * engine.n_slots * steps
    if stats["proposed"] != stats["accepted"] or \
            committed != (SPEC["spec_k"] + 1) * engine.n_slots * steps:
        fail(f"{label}: the profile window's windows were not all full "
             f"and accepted: {stats}")
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0]
    busy_us = sum(ev.self_device_time_total for ev in kernels)
    seen = check_gathers(kernels, kname, per_layer * steps, label,
                         f"{steps} verify dispatches")
    if sum(launches.values()) != per_layer * steps or (
            kname is not None and launches.get(kname) != per_layer * steps):
        fail(f"{label}: the launch counts of {steps} verify dispatches are "
             f"{launches}, want {per_layer * steps} of {kname}")
    gather_us = sum(ev.self_device_time_total for ev in kernels
                    if "gather_rows" in ev.key)
    sort_us = sum(ev.self_device_time_total for ev in kernels
                  if "sort" in ev.key.lower())
    top = {}
    for ev in kernels:
        top[ev.key[:60]] = top.get(ev.key[:60], 0.0) + \
            ev.self_device_time_total / steps
    top = dict(sorted(top.items(), key=lambda kv: -kv[1])[:6])
    out = {"device_busy_ms_per_dispatch": busy_us / steps / 1e3,
           "host_ms_per_dispatch": wall_ms / steps,
           "tokens_per_dispatch": committed / steps,
           "gather_us_per_dispatch": gather_us / steps,
           "sort_share": sort_us / busy_us,
           "gather_share": gather_us / busy_us,
           "launches_per_dispatch": sum(ev.count for ev in kernels) / steps,
           "top_kernels_us_per_dispatch": top,
           "top_host_ops_us_per_dispatch": host_top(torch, prof, steps)}
    out["device_busy_ms_per_token"] = (out["device_busy_ms_per_dispatch"]
                                       / out["tokens_per_dispatch"])
    out["idle_share"] = 1.0 - out["device_busy_ms_per_dispatch"] / out[
        "host_ms_per_dispatch"]
    out["decode_busy_ms_per_token"] = (decode["device_busy_ms_per_step"]
                                       / engine.n_slots)
    print(f"[{card}] {label} profile ({steps} verify dispatches of "
          f"{engine.n_slots} full windows of {SPEC['spec_k'] + 1}): device "
          f"busy {out['device_busy_ms_per_dispatch']:.3f} ms/dispatch = "
          f"{out['device_busy_ms_per_token'] * 1e3:.2f} us/token (the plain "
          f"engine's decode step: {decode['device_busy_ms_per_step']:.3f} "
          f"ms/step = "
          f"{out['decode_busy_ms_per_token'] * 1e3:.2f} us/token), host "
          f"{out['host_ms_per_dispatch']:.3f} ms/dispatch (profiler on), "
          f"idle share {out['idle_share']:.3f}; page gathers "
          f"{out['gather_us_per_dispatch']:.1f} us/dispatch "
          f"({out['gather_share']:.3f} of device time), {per_layer} a "
          f"dispatch, {seen}; token_sample's sort "
          f"{out['sort_share']:.3f} of device time; "
          f"{out['launches_per_dispatch']:.1f} launches a dispatch; top "
          f"kernels us/dispatch {json.dumps(rounded(top))}; top host ops "
          f"us/dispatch (self CPU time) "
          f"{json.dumps(rounded(out['top_host_ops_us_per_dispatch']))}")
    return out


def rounded(d):
    return {k: round(v, 1) for k, v in d.items()}


def host_top(torch, prof, steps, n=6):
    """The ``n`` host ops of a profiler window with the most self CPU time,
    us a step."""
    ops = [ev for ev in prof.key_averages()
           if ev.device_type == torch.autograd.DeviceType.CPU
           and ev.self_cpu_time_total > 0]
    ops.sort(key=lambda ev: -ev.self_cpu_time_total)
    return {ev.key[:60]: ev.self_cpu_time_total / steps for ev in ops[:n]}


class TimedDrafter:
    """A drafter's proposals and the host time they take."""

    def __init__(self, drafter):
        self.drafter = drafter
        self.seconds = 0.0

    def propose(self, tokens, k):
        t = time.perf_counter()
        try:
            return self.drafter.propose(tokens, k)
        finally:
            self.seconds += time.perf_counter() - t


def spec_phase(torch, dev, card, served, per_layer, decode):
    """Phase 4b: phase 4's DecoderLM and requests through the spec
    engine (``spec_k`` 4) for both codecs: (a) the n-gram drafter, (b) a
    scripted drafter replaying (a)'s streams, (c) a profiler window of
    full windows, and (d), fp32 only, the ModelDrafter over the target
    itself on 4 requests of budget 32."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.serving.engine import (ModelDrafter, NgramDrafter,
                                                 make_slot_model)
    lm, reqs = served["lm"], served["reqs"]
    out = {}
    for codec, kname in (("none", "gather_rows"),
                         ("int8", "gather_rows_dequant")):
        engine = make_slot_model(f"decoder_lm_spec_{codec}", lm,
                                 layout="paged", kv_codec=codec, device=dev,
                                 **SERVE, **SPEC)
        engine.warmup()
        label = f"spec kv_codec={codec}"
        streams, ngram = spec_serve(torch, engine, reqs, card,
                                    f"{label} ngram", pa, kname, per_layer)
        if codec == "none":
            served["spec_streams"] = streams     # phase 20's reference
        engine.drafter = ScriptedDrafter(reqs[0], streams)
        scripted_streams, scripted = spec_serve(
            torch, engine, reqs, card, f"{label} scripted", pa, kname,
            per_layer)
        if codec == "none":
            for name, ss in (("ngram", streams),
                             ("scripted", scripted_streams)):
                ties = oracle_check(torch, lm, reqs, ss, f"{label} {name}")
                print(f"[{card}] {label} {name}: {N_REQUESTS} streams equal "
                      f"the fp32 full-view oracle ({ties} near ties)")
        else:
            again, _ = spec_serve(torch, engine, reqs, card,
                                  f"{label} scripted replay", pa, kname,
                                  per_layer)
            if any(not np.array_equal(a, b)
                   for a, b in zip(scripted_streams, again)):
                fail(f"{label}: a second scripted run gave other streams")
            for name, ss in (("ngram", streams),
                             ("scripted", scripted_streams)):
                ties = oracle_check(torch, lm, reqs, ss, f"{label} {name}",
                                    first_only=True)
                print(f"[{card}] {label} {name}: first tokens equal the "
                      f"oracle's ({ties} near ties)")
            print(f"[{card}] {label}: a second scripted run replays every "
                  f"stream")
        same = sum(np.array_equal(a, b)
                   for a, b in zip(streams, served["streams"][codec]))
        print(f"[{card}] {label}: {same} of {N_REQUESTS} streams equal "
              f"phase 4's (the verify products have M 80, not 16)")
        engine.drafter = NgramDrafter()
        busy = verify_busy(torch, engine, card, label, kname, per_layer,
                           decode[codec])
        out[codec] = {"ngram": ngram, "scripted": scripted, "busy": busy,
                      "same_as_phase_4": int(same)}
        if codec == "none":
            prompts, budgets, temps, topks, seeds = (
                r[:MODEL_DRAFTER_REQUESTS] for r in reqs)
            small = (prompts, [MODEL_DRAFTER_BUDGET] * len(prompts), temps,
                     topks, seeds)
            engine.drafter = ModelDrafter(lm)
            model_streams, model = spec_serve(
                torch, engine, small, card, f"{label} ModelDrafter", pa,
                kname, per_layer)
            ties = oracle_check(torch, lm, small, model_streams,
                                f"{label} ModelDrafter")
            print(f"[{card}] {label} ModelDrafter: "
                  f"{MODEL_DRAFTER_REQUESTS} streams equal the fp32 "
                  f"full-view oracle ({ties} near ties); acceptance "
                  f"{model['accepted']} / {model['proposed']}")
            out[codec]["model_drafter"] = model
        del engine
    return out


# -- phase 19: the contiguous layout and the wave engine ---------------------
# (run right after phase 4b, while phase 4's model is on the card)

def no_gathers(pa, label):
    """The page-gather launch counts, zeroed just before a path ran, read
    just after: the contiguous layout gathers nothing."""
    if any(pa.LAUNCHES.values()):
        fail(f"{label}: the page gathers launched {dict(pa.LAUNCHES)}, "
             f"want none")


def subset(reqs, idx):
    return tuple([r[i] for i in idx] for r in reqs)


def wave_serve(torch, engine, reqs, card, label):
    """The requests through the wave engine in waves of up to its largest
    batch bucket, each wave at its largest budget, the streams cut to
    each request's budget; each prefill (at its prompt bucket) and decode
    step timed on the host clock (each ends in its read of the tokens)."""
    prompts, budgets = reqs[0], reqs[1]
    prefill_ms, step_ms = {}, []
    prefill, decode = engine._prefill, engine._decode

    def timed_prefill(ids, lens):
        t = time.perf_counter()
        out = prefill(ids, lens)
        prefill_ms.setdefault(ids.shape[1], []).append(
            (time.perf_counter() - t) * 1e3)
        return out

    def timed_decode(*args):
        t = time.perf_counter()
        out = decode(*args)
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out
    engine._prefill, engine._decode = timed_prefill, timed_decode
    toks0 = counters(engine)["tokens_generated"]
    size = engine.policy.max_batch
    streams = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        for lo in range(0, len(prompts), size):
            part = range(lo, min(len(prompts), lo + size))
            got = engine.generate([prompts[i] for i in part],
                                  max_new=max(budgets[i] for i in part))
            streams += [g[:budgets[i]] for g, i in zip(got, part)]
    finally:
        del engine._prefill, engine._decode
    wall = time.perf_counter() - t0
    tokens = counters(engine)["tokens_generated"] - toks0
    stats = {"waves": -(-len(prompts) // size), "tokens": tokens,
             "tokens_delivered": int(sum(budgets)), "wall_s": wall,
             "tokens_per_s": tokens / wall,
             "delivered_tokens_per_s": sum(budgets) / wall,
             "decode_steps": len(step_ms),
             "decode_step_p50_ms": float(np.median(step_ms)),
             "prefill_ms": {b: float(np.median(v))
                            for b, v in sorted(prefill_ms.items())},
             "peak_mem_bytes": int(torch.cuda.max_memory_allocated())}
    print(f"[{card}] {label}: {len(prompts)} requests in {stats['waves']} "
          f"waves, {tokens} tokens generated in {wall:.3f} s = "
          f"{stats['tokens_per_s']:.1f} tokens/s "
          f"({stats['delivered_tokens_per_s']:.1f} tokens/s within the "
          f"budgets); {len(step_ms)} decode steps, p50 "
          f"{stats['decode_step_p50_ms']:.3f} ms; prefill p50 ms by bucket "
          f"{json.dumps(stats['prefill_ms'])}; peak memory "
          f"{stats['peak_mem_bytes'] / 2 ** 20:.1f} MiB")
    return streams, stats


def wave_busy(torch, engine, card, label, steps=DECODE_PROFILE_STEPS):
    """Device busy per decode step of a wave of the largest batch bucket
    (seeded 64-token prompts; 5 untraced steps, then ``steps`` in a
    profiler window), its idle share; no page gather by profiler name."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(3)
    b, p = engine.policy.max_batch, 64
    lens = np.full(b, p, np.int64)
    tok, cache = engine._prefill(rng.randint(1, LM["vocab"], (b, p)), lens)
    for s in range(5):
        tok = engine._decode(cache, tok, p + s, lens, p)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(5, 5 + steps):
            tok = engine._decode(cache, tok, p + s, lens, p)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0]
    seen = check_gathers(kernels, None, 0, label, f"{steps} decode steps")
    busy_us = sum(ev.self_device_time_total for ev in kernels)
    out = {"device_busy_ms_per_step": busy_us / steps / 1e3,
           "host_ms_per_step": wall_ms / steps,
           "launches_per_step": sum(ev.count for ev in kernels) / steps,
           "top_host_ops_us_per_step": host_top(torch, prof, steps)}
    out["idle_share"] = 1.0 - out["device_busy_ms_per_step"] / out[
        "host_ms_per_step"]
    print(f"[{card}] {label} profile ({steps} decode steps of a wave of "
          f"{b}): device busy {out['device_busy_ms_per_step']:.3f} ms/step, "
          f"host {out['host_ms_per_step']:.3f} ms/step (profiler on), idle "
          f"share {out['idle_share']:.3f}; "
          f"{out['launches_per_step']:.1f} launches a step; {seen}; top host "
          f"ops us/step (self CPU time) "
          f"{json.dumps(rounded(out['top_host_ops_us_per_step']))}")
    return out


def contiguous_phase(torch, dev, card, served, decode):
    """Phase 19: phase 4's DecoderLM and requests through (a) the
    contiguous slot engine, (b) the same with ``spec_k`` 4 and the n-gram
    drafter, and (c) the wave engine, with its ``full_forward_generate``
    on one wave of 4 prompts. No page gather may launch on any of them."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.serving.bucketing import BucketPolicy
    from paddle_tpu_torch.serving.engine import (GenerativeModel,
                                                 make_slot_model)
    lm, reqs = served["lm"], served["reqs"]
    slots = dict(n_slots=SERVE["n_slots"],
                 prompt_buckets=SERVE["prompt_buckets"])
    out = {}

    # (a) the contiguous slot engine
    engine = make_slot_model("decoder_lm_contiguous", lm,
                             layout="contiguous", device=dev, **slots)
    engine.warmup()
    label = "contiguous"
    pa.reset_launches()
    streams, stats = serve(torch, engine, reqs, card, label)
    no_gathers(pa, label)
    ties = oracle_check(torch, lm, reqs, streams, label)
    paged = served["streams"]["none"]
    same = [bool(np.array_equal(a, b)) for a, b in zip(streams, paged)]
    eq, paged_ties = streams_agree(torch, lm, reqs, paged, streams,
                                   f"{label} / paged")
    served["contiguous_streams"] = streams       # phase 20's reference
    stats.update(oracle_ties=ties, equal_to_paged=int(sum(same)),
                 sampled_equal_to_paged=int(sum(same[n] for n in SAMPLED)),
                 paged_near_ties=paged_ties)
    print(f"[{card}] {label}: {N_REQUESTS} streams equal the fp32 full-view "
          f"oracle ({ties} near ties), no page gather launched; "
          f"{sum(same)} of {N_REQUESTS} equal phase 4's paged kv_codec=none "
          f"streams token for token ({stats['sampled_equal_to_paged']} of "
          f"the {len(SAMPLED)} sampled), {paged_ties} part at a near tie")
    stats["busy"] = decode_busy(torch, engine, card, label, None, 0)
    print(f"[{card}] {label}: device busy "
          f"{stats['busy']['device_busy_ms_per_step']:.3f} ms a decode step "
          f"against phase 4's paged "
          f"{decode['none']['device_busy_ms_per_step']:.3f} ms (gathers "
          f"{decode['none']['gather_us_per_step']:.1f} us of it)")
    out[label] = stats
    del engine

    # (b) contiguous speculative decoding, the n-gram drafter
    engine = make_slot_model("decoder_lm_contiguous_spec", lm,
                             layout="contiguous", device=dev, **slots,
                             **SPEC)
    engine.warmup()
    label = "contiguous spec"
    spec_streams, spec = spec_serve(torch, engine, reqs, card,
                                    f"{label} ngram", pa, None, 0)
    eq, ties = streams_agree(torch, lm, reqs, streams, spec_streams,
                             f"{label} / contiguous")
    spec.update(equal_to_contiguous=eq, near_ties=ties)
    print(f"[{card}] {label}: {eq} of {N_REQUESTS} streams equal (a)'s, "
          f"{ties} part at a near tie")
    spec["busy"] = verify_busy(torch, engine, card, label, None, 0,
                               stats["busy"])
    out[label] = spec
    del engine

    # (c) the wave engine and the full-forward baseline
    wave = GenerativeModel("decoder_lm_wave", lm, SERVE["prompt_buckets"],
                           BucketPolicy.pow2(SERVE["n_slots"]))
    label = "wave"
    t = time.perf_counter()
    warm = wave.warmup()
    warm["seconds"] = time.perf_counter() - t
    greedy = [n for n in range(N_REQUESTS) if n not in SAMPLED]
    greqs = subset(reqs, greedy)
    pa.reset_launches()
    wave_streams, wstats = wave_serve(torch, wave, greqs, card, label)
    no_gathers(pa, label)
    served["wave_streams"], served["greedy"] = wave_streams, greedy
    eq, ties = streams_agree(torch, lm, greqs, [streams[n] for n in greedy],
                             wave_streams, f"{label} / contiguous")
    wstats.update(warmup=warm, equal_to_contiguous=eq, near_ties=ties)
    print(f"[{card}] {label}: warmup dispatched {warm['dispatched']} in "
          f"{warm['seconds']:.1f} s; {eq} of {len(greedy)} greedy streams "
          f"equal (a)'s, {ties} part at a near tie; no page gather launched")
    wstats["busy"] = wave_busy(torch, wave, card, label)
    four = subset(greqs, range(4))
    budget = MODEL_DRAFTER_BUDGET
    pa.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    kv = wave.generate(four[0], max_new=budget)
    kv_s = time.perf_counter() - t
    t = time.perf_counter()
    full = wave.full_forward_generate(four[0], max_new=budget)
    full_s = time.perf_counter() - t
    no_gathers(pa, f"{label} full forward")
    eq, ties = streams_agree(torch, lm, four, kv, full,
                             f"{label} full forward / wave")
    bucket = wave.policy.bucket_for(4)
    ff = {"requests": 4, "max_new": budget, "equal": eq, "near_ties": ties,
          "wave_tokens_per_s": 4 * budget / kv_s,
          "full_forward_tokens_per_s": 4 * budget / full_s,
          "decode_flops": wave.decode_flops(bucket),
          "full_forward_flops": wave.full_forward_flops(bucket)}
    ff["kv_cache_speedup"] = ff["wave_tokens_per_s"] / ff[
        "full_forward_tokens_per_s"]
    # device time of one token each way at that bucket: a full forward
    # over cache_len positions, a decode step over a cache prefilled at
    # the largest prompt bucket (the tokens do not change the time)
    p = wave.prompt_len
    lens = np.full(bucket, p, np.int64)
    tok, cache = wave._prefill(np.zeros((bucket, p), np.int64), lens)
    ids = torch.zeros((bucket, wave.cache_len), dtype=torch.int64)
    ff["full_forward_device_ms"] = device_ms(torch, lambda: lm.full(ids), 5)
    ff["decode_step_device_ms"] = device_ms(
        torch, lambda: wave._decode(cache, tok, p, lens, p), 5)
    ff["kv_cache_device_speedup"] = (ff["full_forward_device_ms"]
                                     / ff["decode_step_device_ms"])
    print(f"[{card}] {label} full_forward_generate (4 prompts, max_new "
          f"{budget}): {eq} of 4 streams equal the wave's, {ties} part at a "
          f"near tie; {ff['full_forward_tokens_per_s']:.1f} tokens/s against "
          f"the wave's {ff['wave_tokens_per_s']:.1f}: the KV cache's speedup "
          f"{ff['kv_cache_speedup']:.2f}x; by device time a token "
          f"{ff['full_forward_device_ms']:.3f} ms (full forward) against "
          f"{ff['decode_step_device_ms']:.3f} ms (decode step): "
          f"{ff['kv_cache_device_speedup']:.2f}x; at batch bucket {bucket} a "
          f"decode step {ff['decode_flops'] / 1e9:.3f} GFLOP, a full forward "
          f"({wave.cache_len} positions) {ff['full_forward_flops'] / 1e9:.3f} "
          f"GFLOP (products, FlopCounterMode)")
    wstats["full_forward"] = ff
    out[label] = wstats
    return out


# -- phase 20: the model server on the card ----------------------------------
# (run last, on phase 4's model and requests)

SERVER_CLIENTS = 8                 # client threads, one ServingClient each
SERVER_CLIENTS_FULL = 16           # one client a slot: a full pool
SERVER_TURNS = 2                   # wire / in-process rounds, in turns
SERVER_PROFILE = dict(skip=5, steps=DECODE_PROFILE_STEPS, prompt=64,
                      budget=32)   # the window of 16 busy slots
CANCEL_BUDGET = 128


def wire_run(torch, endpoint, name, reqs, idx, rid, greedy=False,
             clients=SERVER_CLIENTS):
    """Send requests ``idx`` of ``reqs`` to model ``name`` over the wire,
    one prompt a request, from ``clients`` threads, each with its own
    ``ServingClient`` (request ids ``rid-n``). Each request carries
    its own budget and, unless ``greedy``, its seed, temperature and
    top-k. Returns ({n: stream}, wall seconds, per-request latency s)."""
    import threading
    from paddle_tpu_torch.serving.client import ServingClient
    prompts, budgets, temps, topks, seeds = reqs
    todo = list(idx)[::-1]
    lock = threading.Lock()
    out, lat, errors = {}, {}, []

    def worker():
        client = ServingClient(endpoint)
        try:
            while True:
                with lock:
                    if not todo:
                        return
                    n = todo.pop()
                kw = {} if greedy else dict(temperature=temps[n],
                                            top_k=topks[n], seed=seeds[n])
                t = time.perf_counter()
                (out[n],) = client.generate(name, [prompts[n]],
                                            max_new=budgets[n],
                                            request_id=f"{rid}-{n}", **kw)
                lat[n] = time.perf_counter() - t
        except BaseException as e:          # noqa: BLE001 - re-raised below
            errors.append(e)
        finally:
            client.close()
    threads = [threading.Thread(target=worker) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return out, wall, lat


class WaveRecorder:
    """The waves a hosted wave engine's ``generate`` was called with
    (the prompts in order, the wave's budget)."""

    def __init__(self, engine):
        self.engine, self.generate, self.waves = engine, engine.generate, []

    def __call__(self, prompts, max_new=None):
        self.waves.append(([np.asarray(p).copy() for p in prompts],
                           max_new))
        return self.generate(prompts, max_new=max_new)


class StepWindow:
    """Wraps a hosted slot engine's ``step`` so that a window covers
    exactly ``steps`` scheduler steps after ``skip``, opened and closed on
    the scheduler thread itself, and timed. With ``profile``, a profiler
    records the window, and a sampler thread meanwhile reads that
    thread's innermost Python frame every ``every`` s (the host's top
    functions)."""

    def __init__(self, torch, engine, skip, steps, profile=True,
                 every=0.002):
        import threading
        self.torch, self.engine, self.step = torch, engine, engine.step
        self.skip, self.steps, self.every = skip, steps, every
        self.profile = profile
        self.n, self.prof, self.wall_ms = 0, None, None
        self.done, self.stop = threading.Event(), threading.Event()
        self.samples = {}

    def _sample(self, tid):
        import sys
        while not self.stop.wait(self.every):
            frame = sys._current_frames().get(tid)
            if frame is not None:
                code = frame.f_code
                key = (f"{os.path.basename(code.co_filename)}:"
                       f"{code.co_name}")
                self.samples[key] = self.samples.get(key, 0) + 1

    def __call__(self):
        import threading
        from torch.profiler import ProfilerActivity, profile
        n, self.n = self.n, self.n + 1
        if n == self.skip:
            self.torch.cuda.synchronize()
            if self.profile:
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.__enter__()
                threading.Thread(target=self._sample,
                                 args=(threading.get_ident(),),
                                 daemon=True).start()
            self.t0 = time.perf_counter()
        out = self.step()
        if n == self.skip + self.steps - 1:
            self.torch.cuda.synchronize()
            self.wall_ms = (time.perf_counter() - self.t0) * 1e3
            self.stop.set()
            if self.profile:
                self.prof.__exit__(None, None, None)
            self.done.set()
        return out


def served_window(torch, server, engine, label, kname, per_layer, profile):
    """One wire request of 16 seeded prompts keeps every slot of the
    hosted ``engine`` busy while a ``StepWindow`` covers exactly
    ``SERVER_PROFILE["steps"]`` of its scheduler's steps, with or without
    the profiler. Returns the window."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.serving.client import ServingClient
    p = SERVER_PROFILE
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, LM["vocab"], p["prompt"])
               for _ in range(engine.n_slots)]
    window = engine.step = StepWindow(torch, engine, p["skip"], p["steps"],
                                      profile=profile)
    client = ServingClient(server.endpoint)
    steps0 = counters(engine)["decode_steps"]
    pa.reset_launches()
    try:
        toks = client.generate(
            engine.name, prompts, max_new=p["budget"],
            request_id=f"{label}-{'profiled' if profile else 'timed'}")
    finally:
        client.close()
        del engine.step
    steps = counters(engine)["decode_steps"] - steps0
    want = {k: per_layer * steps if k == kname
            else 0 for k in pa.LAUNCHES}
    if dict(pa.LAUNCHES) != want:
        fail(f"{label}: the request of 16 launched {dict(pa.LAUNCHES)}, "
             f"want {want}")
    if not window.done.is_set():
        fail(f"{label}: the served run ended before its window")
    if any(len(t) != p["budget"] for t in toks):
        fail(f"{label}: the request of 16 gave {[len(t) for t in toks]}"
             f" tokens, want {p['budget']} each")
    return window


def served_busy(torch, server, engine, card, label, kname, per_layer):
    """The window of ``served_window`` twice: timed alone, then under the
    profiler: device busy a step, the idle share against the host time a
    step with the profiler off, the page gathers by profiler name, the
    host's top ops and top Python functions of the scheduler thread.
    Sends two requests of ``engine.n_slots`` prompts."""
    p = SERVER_PROFILE
    timed = served_window(torch, server, engine, label, kname, per_layer,
                          profile=False)
    window = served_window(torch, server, engine, label, kname, per_layer,
                           profile=True)
    prof, steps = window.prof, p["steps"]
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0]
    busy_us = sum(ev.self_device_time_total for ev in kernels)
    # the counters give the launches exactly; a late window may lose
    # kernel records, so its names bound them from below
    ran = {ev.key: ev.count for ev in kernels if "gather_rows" in ev.key}
    named, launched = sum(ran.values()), per_layer * steps
    if (not 0 < named <= launched
            or any(GATHER_KERNELS[kname] not in key for key in ran)):
        fail(f"{label}: the page gathers of {steps} served scheduler steps "
             f"ran {ran} by name, want up to {launched} of "
             f"{GATHER_KERNELS[kname]}")
    seen = f"{named} of {launched} named, all {GATHER_KERNELS[kname]}"
    total = sum(window.samples.values()) or 1
    top = sorted(window.samples.items(), key=lambda kv: -kv[1])[:8]
    out = {"steps": steps, "slots_busy": engine.n_slots,
           "gathers_named": named, "gathers_launched": launched,
           "device_busy_ms_per_step": busy_us / steps / 1e3,
           "host_ms_per_step": timed.wall_ms / steps,
           "host_ms_per_step_profiled": window.wall_ms / steps,
           "launches_per_step": sum(ev.count for ev in kernels) / steps,
           "top_host_ops_us_per_step": host_top(torch, prof, steps),
           "top_functions_share": {k: v / total for k, v in top},
           "samples": total}
    out["idle_share"] = 1.0 - out["device_busy_ms_per_step"] / out[
        "host_ms_per_step"]
    out["idle_share_profiled"] = 1.0 - out["device_busy_ms_per_step"] / out[
        "host_ms_per_step_profiled"]
    print(f"[{card}] {label} served profile ({steps} scheduler steps, all "
          f"{engine.n_slots} slots busy): device busy "
          f"{out['device_busy_ms_per_step']:.3f} ms/step, host "
          f"{out['host_ms_per_step']:.3f} ms/step with the profiler off "
          f"({out['host_ms_per_step_profiled']:.3f} on), idle share "
          f"{out['idle_share']:.3f} ({out['idle_share_profiled']:.3f} against "
          f"the profiled window); {out['launches_per_step']:.1f} launches "
          f"a step; {seen}; top host ops us/step "
          f"{json.dumps(rounded(out['top_host_ops_us_per_step']))}; top "
          f"functions of the scheduler thread (share of {total} samples) "
          f"{json.dumps({k: round(v, 3) for k, v in out['top_functions_share'].items()})}")
    return out


def wire_cancel(torch, server, engine, card, label):
    """Over the wire, a request with a budget of ``CANCEL_BUDGET`` is
    cancelled from a second client after its first tokens: the first
    client gets ``RequestCancelledError``, and the slot is free within one
    scheduler step. Returns the tokens the request generated."""
    import threading
    from paddle_tpu_torch.serving.client import ServingClient
    from paddle_tpu_torch.serving.server import RequestCancelledError
    from paddle_tpu_torch.serving import metrics as smetrics
    hosted = server.model(engine.name)
    rid = f"{label}-cancel"
    caught = []
    toks0 = counters(engine)["tokens_generated"]
    ev0 = smetrics.SLOT_EVICTIONS.labels(model=engine.name,
                                         cause="cancelled").value
    a, b = ServingClient(server.endpoint), ServingClient(server.endpoint)

    def run():
        try:
            a.generate(engine.name, [np.arange(1, 40)], max_new=CANCEL_BUDGET,
                       request_id=rid)
        except BaseException as e:          # noqa: BLE001 - checked below
            caught.append(e)
    t = threading.Thread(target=run)
    t.start()
    deadline = time.perf_counter() + 60
    while (counters(engine)["tokens_generated"] - toks0 < 4
           and time.perf_counter() < deadline):
        time.sleep(0.001)
    try:
        if not b.cancel(engine.name, rid):
            fail(f"{label}: the cancel found no request {rid!r}")
        steps0 = hosted.sched_steps
        t.join(60)
    finally:
        a.close()
        b.close()
    gone = hosted.sched_steps - steps0
    if len(caught) != 1 or not isinstance(caught[0], RequestCancelledError):
        fail(f"{label}: the cancelled request ended with {caught!r}, want "
             f"RequestCancelledError")
    if engine.active_count() != 0 or gone > 1:
        fail(f"{label}: {engine.active_count()} slots still busy "
             f"{gone} scheduler steps after the cancel")
    if smetrics.SLOT_EVICTIONS.labels(
            model=engine.name, cause="cancelled").value - ev0 != 1:
        fail(f"{label}: the cancel was not counted as a slot eviction")
    tokens = counters(engine)["tokens_generated"] - toks0
    print(f"[{card}] {label}: a request of budget {CANCEL_BUDGET} cancelled "
          f"over the wire after {tokens} tokens: RequestCancelledError "
          f"(kind cancelled), its slot free within {gone} scheduler step")
    return tokens


def server_phase(torch, dev, card, served, per_layer):
    """Phase 20: one ``ModelServer`` on the card hosts (a) the paged slot
    engine, int8 codec, (b) the same, no codec, (c) the contiguous slot
    engine, (d) the spec engine on the paged layout (``spec_k`` 4, n-gram
    drafter) and (e) the wave engine, all over phase 4's model; clients
    reach them over a real socket."""
    from paddle_tpu_torch.observability.exporters import MetricsServer
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.serving import metrics as smetrics
    from paddle_tpu_torch.serving.bucketing import BucketPolicy
    from paddle_tpu_torch.serving.client import ServingClient
    from paddle_tpu_torch.serving.engine import (GenerativeModel,
                                                 NgramDrafter,
                                                 make_slot_model)
    from paddle_tpu_torch.serving.server import ModelServer
    import urllib.request
    lm, reqs = decoder_lm(dev), served["reqs"]
    greedy = served["greedy"]
    greqs = subset(reqs, greedy)
    slots = dict(n_slots=SERVE["n_slots"],
                 prompt_buckets=SERVE["prompt_buckets"])

    def slot_engine(key, name):
        kw = {"a": dict(layout="paged", kv_codec="int8", **SERVE),
              "b": dict(layout="paged", kv_codec="none", **SERVE),
              "c": dict(layout="contiguous", **slots),
              "d": dict(layout="paged", kv_codec="none", drafter=NgramDrafter(),
                        **SERVE, **SPEC)}[key]
        return make_slot_model(name, lm, device=dev, **kw)
    cells = {  # key: (label, kernel, in-process streams of phases 4-19)
        "a": ("paged int8", "gather_rows_dequant", served["streams"]["int8"]),
        "b": ("paged none", "gather_rows", served["streams"]["none"]),
        "c": ("contiguous", None, served["contiguous_streams"]),
        "d": ("spec paged none", "gather_rows", served["spec_streams"])}
    engines = {k: slot_engine(k, f"srv_{k}") for k in cells}
    twins = {k: slot_engine(k, f"twin_{k}") for k in cells}
    wave = GenerativeModel("srv_e", lm, SERVE["prompt_buckets"],
                           BucketPolicy.pow2(SERVE["n_slots"]))
    twin_wave = GenerativeModel("twin_e", lm, SERVE["prompt_buckets"],
                                BucketPolicy.pow2(SERVE["n_slots"]))
    for e in twins.values():
        e.warmup()
    twin_wave.warmup()
    server = ModelServer()
    t = time.perf_counter()
    for e in (*engines.values(), wave):
        server.add_model(e)
    warm_s = time.perf_counter() - t
    endpoint = server.serve(host="127.0.0.1", port=0)
    names = [e.name for e in engines.values()] + [wave.name]
    fams = ("REQUESTS_APPLIED", "TOKENS_GENERATED")
    before = {n: {f: getattr(smetrics, f).labels(model=n).value
                  for f in fams} for n in names}
    sent = dict.fromkeys(names, 0)
    returned = dict.fromkeys(names, 0)
    print(f"[{card}] server: 5 engines hosted (warmup {warm_s:.1f} s), "
          f"serving at {endpoint}")
    out = {"endpoint_kind": "tcp 127.0.0.1", "clients": SERVER_CLIENTS,
           "clients_full": SERVER_CLIENTS_FULL,
           "warmup_s": warm_s, "cells": {}}
    everything = list(range(N_REQUESTS))
    launches_served = {k: 0 for k in pa.LAUNCHES}
    for turn in range(SERVER_TURNS):
        for key, (label, kname, want) in cells.items():
            engine, twin = engines[key], twins[key]
            cell = out["cells"].setdefault(key, {"label": label, "wire": [],
                                                 "wire_full": [],
                                                 "inproc": []})

            def wire(clients):
                steps0 = counters(engine)["decode_steps"]
                pa.reset_launches()
                got, wall, lat = wire_run(torch, endpoint, engine.name, reqs,
                                          everything, f"{key}{turn}c{clients}",
                                          clients=clients)
                launches = dict(pa.LAUNCHES)
                steps = counters(engine)["decode_steps"] - steps0
                streams = [got[n] for n in everything]
                bad = [n for n in everything
                       if not np.array_equal(streams[n], want[n])]
                if bad:
                    n = bad[0]
                    fail(f"server {label}: request {n} over the wire gave "
                         f"{streams[n].tolist()}, in process "
                         f"{want[n].tolist()}")
                wl = {k: per_layer * steps if k == kname else 0
                      for k in launches}
                if launches != wl:
                    fail(f"server {label}: the page gathers launched "
                         f"{launches}, want {wl} ({steps} dispatches)")
                if turn == 0:
                    for k in launches:
                        launches_served[k] += launches[k]
                tokens = int(sum(len(s) for s in streams))
                sent[engine.name] += len(everything)
                returned[engine.name] += tokens
                lat_s = sorted(lat.values())
                row = {"tokens": tokens, "wall_s": wall,
                       "requests_per_s": len(everything) / wall,
                       "tokens_per_s": tokens / wall, "dispatches": steps,
                       "ms_per_dispatch": wall * 1e3 / steps,
                       "launches": launches,
                       "latency_p50_s": float(np.percentile(lat_s, 50)),
                       "latency_p99_s": float(np.percentile(lat_s, 99))}
                cell["wire" if clients == SERVER_CLIENTS
                     else "wire_full"].append(row)
                print(f"[{card}] server {label} (turn {turn}): {N_REQUESTS} "
                      f"requests over the wire from {clients} clients "
                      f"equal phases 4-19's in-process streams token for "
                      f"token; {tokens} tokens in {wall:.3f} s = "
                      f"{row['tokens_per_s']:.1f} tokens/s, "
                      f"{row['requests_per_s']:.2f} requests/s; {steps} "
                      f"dispatches ({row['ms_per_dispatch']:.3f} ms of wall "
                      f"each), page gathers {launches}")

            def inproc():
                got, stats = serve(torch, twin, reqs, card,
                                   f"server {label} in process (twin, "
                                   f"turn {turn})")
                if any(not np.array_equal(a, b) for a, b in zip(got, want)):
                    fail(f"server {label}: the in-process twin gave other "
                         f"streams")
                cell["inproc"].append({k: stats[k] for k in (
                    "tokens", "wall_s", "tokens_per_s", "decode_steps")})
                cell["inproc"][-1]["ms_per_dispatch"] = (
                    stats["wall_s"] * 1e3 / stats["decode_steps"])
            runs = (lambda: wire(SERVER_CLIENTS),
                    lambda: wire(SERVER_CLIENTS_FULL), inproc)
            for run in runs if turn % 2 == 0 else runs[::-1]:
                run()
            if turn == 0:
                cell["ttft_p50_s"] = smetrics.histogram_percentile(
                    smetrics.TTFT, 0.5, model=engine.name)
                cell["ttft_p99_s"] = smetrics.histogram_percentile(
                    smetrics.TTFT, 0.99, model=engine.name)
                cell["inter_token_p50_s"] = smetrics.histogram_percentile(
                    smetrics.INTER_TOKEN, 0.5, model=engine.name)
                cell["inter_token_p99_s"] = smetrics.histogram_percentile(
                    smetrics.INTER_TOKEN, 0.99, model=engine.name)
                print(f"[{card}] server {label}: from the histograms (bucket "
                      f"bounds) TTFT p50 / p99 {cell['ttft_p50_s']} / "
                      f"{cell['ttft_p99_s']} s, inter-token p50 / p99 "
                      f"{cell['inter_token_p50_s']} / "
                      f"{cell['inter_token_p99_s']} s")

        # (e) the wave engine on the wave batcher, greedy requests
        cell = out["cells"].setdefault("e", {"label": "wave", "wire": [],
                                             "inproc": []})

        def wave_wire():
            rec = wave.generate = WaveRecorder(wave)
            pa.reset_launches()
            toks0 = counters(wave)["tokens_generated"]
            try:
                got, wall, lat = wire_run(torch, endpoint, wave.name, greqs,
                                          range(len(greedy)), f"e{turn}",
                                          greedy=True)
            finally:
                del wave.generate
            no_gathers(pa, "server wave")
            streams = [got[n] for n in range(len(greedy))]
            # the stream of a request depends on the wave it rode in (the
            # wave's prompt and batch buckets): replay each wave the
            # batcher formed, in process on the twin
            by_prompt = {tuple(int(x) for x in greqs[0][n]): n
                         for n in range(len(greedy))}
            for prompts, max_new in rec.waves:
                replay = twin_wave.generate(prompts, max_new=max_new)
                for p, r in zip(prompts, replay):
                    n = by_prompt[tuple(int(x) for x in p)]
                    if not np.array_equal(streams[n], r[:greqs[1][n]]):
                        fail(f"server wave: request {n} over the wire "
                             f"differs from its wave replayed in process")
            eq, ties = streams_agree(torch, lm, greqs, served["wave_streams"],
                                     streams, "server wave / phase 19")
            generated = sum(len(p) * m for p, m in rec.waves)
            made = counters(wave)["tokens_generated"] - toks0
            if made != generated:
                fail(f"server wave: {made} tokens "
                     f"generated, want {generated} (its waves at their "
                     f"budgets)")
            tokens = int(sum(len(s) for s in streams))
            sent[wave.name] += len(greedy)
            returned[wave.name] += generated
            row = {"tokens": tokens, "generated": generated, "wall_s": wall,
                   "requests_per_s": len(greedy) / wall,
                   "tokens_per_s": tokens / wall,
                   "waves": [len(p) for p, _ in rec.waves],
                   "equal_to_phase_19": eq, "near_ties": ties}
            cell["wire"].append(row)
            if turn == 0:
                for q in (0.5, 0.99):
                    cell[f"ttft_p{int(q * 100)}_s"] = \
                        smetrics.histogram_percentile(smetrics.TTFT, q,
                                                      model=wave.name)
            print(f"[{card}] server wave (turn {turn}): {len(greedy)} greedy "
                  f"requests over the wire in waves of {row['waves']}: each "
                  f"stream equals its wave replayed in process; {eq} of "
                  f"{len(greedy)} equal phase 19's (waves 16 + 4), {ties} "
                  f"part at a near tie; {tokens} tokens within the budgets in "
                  f"{wall:.3f} s = {row['tokens_per_s']:.1f} tokens/s, "
                  f"{row['requests_per_s']:.2f} requests/s; no page gather")

        def wave_inproc():
            got, stats = wave_serve(torch, twin_wave, greqs, card,
                                    f"server wave in process (twin, turn "
                                    f"{turn})")
            if any(not np.array_equal(a, b)
                   for a, b in zip(got, served["wave_streams"])):
                fail("server wave: the in-process twin gave other streams "
                     "than phase 19's")
            cell["inproc"].append({k: stats[k] for k in (
                "tokens_delivered", "wall_s", "delivered_tokens_per_s")})
        for run in ((wave_wire, wave_inproc) if turn % 2 == 0
                    else (wave_inproc, wave_wire)):
            run()

    # the cancel, and a window of 16 busy slots, on (b)
    eng_b = engines["b"]
    cancelled = wire_cancel(torch, server, eng_b, card, "server paged none")
    sent[eng_b.name] += 1
    returned[eng_b.name] += cancelled
    out["cancel"] = {"budget": CANCEL_BUDGET, "tokens_before_cancel":
                     cancelled}
    out["busy"] = served_busy(torch, server, eng_b, card, "server paged none",
                              "gather_rows", per_layer)
    sent[eng_b.name] += 2
    returned[eng_b.name] += 2 * eng_b.n_slots * SERVER_PROFILE["budget"]

    # the counters
    for n in names:
        got = {f: getattr(smetrics, f).labels(model=n).value - before[n][f]
               for f in fams}
        if got != {"REQUESTS_APPLIED": sent[n], "TOKENS_GENERATED": returned[n]}:
            fail(f"server {n}: applied / tokens {got}, want {sent[n]} "
                 f"requests and {returned[n]} tokens")
    print(f"[{card}] server: requests applied and tokens generated by model "
          f"equal the requests sent and the tokens returned (the cancelled "
          f"request's and the waves' padding to their longest budget "
          f"included): {json.dumps({n: [sent[n], returned[n]] for n in names})}")
    msrv = MetricsServer(port=0)
    try:
        body = urllib.request.urlopen(f"http://{msrv.endpoint}/metrics",
                                      timeout=30).read().decode()
    finally:
        msrv.stop()
    want = []
    for n in names:
        want += [f'paddle_serving_request_latency_seconds_bucket{{model="{n}"',
                 f'paddle_serving_ttft_seconds_bucket{{model="{n}"']
    for key in cells:
        n = engines[key].name
        want.append(f'paddle_serving_inter_token_latency_seconds_bucket'
                    f'{{model="{n}"')
        if key != "c":
            want += [f'paddle_kv_pages_total{{model="{n}"}}',
                     f'paddle_kv_pages_free{{model="{n}"}}',
                     f'paddle_kv_prefix_shared_pages{{model="{n}"}}']
    missing = [w for w in want if w not in body]
    if missing:
        fail(f"server: the scrape lacks {missing}")
    print(f"[{card}] server: the scrape shows the latency and TTFT families "
          f"of every model, inter-token of the slot engines, the KV page "
          f"gauges of the paged ones ({len(want)} series checked)")

    # lifecycle
    client = ServingClient(endpoint)
    try:
        rz = client._call({"method": "readyz"})
        dr = client._call({"method": "drain", "timeout_s": 30.0,
                           "exit": False})
        rz2 = client._call({"method": "readyz"})
    finally:
        client.close()
        server.stop()
    if not (rz["ready"] and dr["drained"] and not rz2["ready"]):
        fail(f"server: readyz {rz}, drain {dr}, then readyz {rz2}")
    print(f"[{card}] server: readyz ready; drain drained in "
          f"{dr['duration_s']:.3f} s; readyz then not ready")
    for key, cell in out["cells"].items():
        w = np.mean([r["tokens_per_s"] for r in cell["wire"]])
        i = np.mean([r.get("tokens_per_s", r.get("delivered_tokens_per_s"))
                     for r in cell["inproc"]])
        cell["wire_over_inproc"] = float(w / i)
        full = ""
        if cell.get("wire_full"):
            f = np.mean([r["tokens_per_s"] for r in cell["wire_full"]])
            cell["full_wire_over_inproc"] = float(f / i)
            full = (f"; from {SERVER_CLIENTS_FULL} clients {f:.1f}: "
                    f"{cell['full_wire_over_inproc']:.3f}x")
        print(f"[{card}] server {cell['label']}: over the wire from "
              f"{SERVER_CLIENTS} clients {w:.1f} tokens/s against {i:.1f} in "
              f"process: {cell['wire_over_inproc']:.3f}x{full}")
    out["launches"] = launches_served
    return out


# -- phase 21: the serving fleet ---------------------------------------------

FLEET_CLIENTS = 16                 # phase 20's full pool: one client a slot
FLEET_POLICY = dict(slo_queue_wait_p99_s=0.01, min_replicas=1,
                    max_replicas=2, breach_window_s=0.5,
                    clear_window_s=2.0, cooldown_s=2.0, window_s=5.0,
                    poll_interval_s=0.25)
# serving.dispatch hits of a paged replica's warmup: its three prompt
# buckets' prefills and the decode step; the next hit is an admission
FLEET_WARMUP_HITS = len(SERVE["prompt_buckets"]) + 1
FLEET_DEADLINE_S = 150.0
WEIGHT_BYTES_MIN = 198 * 2 ** 20   # phase 4's weights, fp32


def fleet_spec(weights, **top):
    """Phase 4's paged engine as a replica spec (the reference's
    ``decoder_lm`` params plus the port's ``weights`` and ``device``)."""
    p_len = SERVE["prompt_buckets"][-1]
    params = dict(prompt_len=p_len, max_new=CACHE_LEN - p_len, **LM,
                  n_slots=SERVE["n_slots"],
                  prompt_buckets=list(SERVE["prompt_buckets"]),
                  modes=["prefill_paged", "decode_paged"],
                  page_size=SERVE["page_size"], n_pages=SERVE["n_pages"],
                  kv_codec="none")
    return {"model": {"kind": "decoder_lm", "name": "fleet",
                      "weights": weights, "device": "cuda",
                      "params": params}, **top}


def wait_for(pred, what, timeout=FLEET_DEADLINE_S):
    """Poll ``pred`` until true; fail after ``timeout`` s. Returns the
    seconds waited."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            fail(f"fleet: no {what} within {timeout:.0f} s")
        time.sleep(0.05)
    return time.perf_counter() - t0


class LazyModel:
    """Phase 4's model for the near-tie oracle, rebuilt from its seed only
    if a stream comparison needs it."""

    def __init__(self, dev):
        self.dev, self.lm = dev, None

    def full(self, ids):
        if self.lm is None:
            self.lm = decoder_lm(self.dev)
        return self.lm.full(ids)


def fleet_load(endpoint, name, reqs, rid, stop=None):
    """Phase 20's requests through the router from ``FLEET_CLIENTS``
    threads, each with its own ``ServingClient``: one pass, or, with
    ``stop``, passes until it is set (the jobs taken by then finish).
    Returns ({(pass, n): stream}, typed sheds, other failures, wall s)."""
    import threading
    from paddle_tpu_torch.serving.client import ServingClient
    from paddle_tpu_torch.serving.server import RequestShedError
    prompts, budgets, temps, topks, seeds = reqs
    lock = threading.Lock()
    state = {"pass": 0, "todo": list(range(len(prompts)))[::-1]}
    out, sheds, errors = {}, [], []

    def take():
        with lock:
            if not state["todo"]:
                if stop is None or stop.is_set():
                    return None
                state["pass"] += 1
                state["todo"] = list(range(len(prompts)))[::-1]
            return state["pass"], state["todo"].pop()

    def worker():
        client = ServingClient(endpoint, timeout_s=FLEET_DEADLINE_S)
        try:
            while (job := take()) is not None:
                p, n = job
                try:
                    (out[p, n],) = client.generate(
                        name, [prompts[n]], max_new=budgets[n],
                        request_id=f"{rid}-{p}-{n}", temperature=temps[n],
                        top_k=topks[n], seed=seeds[n])
                except RequestShedError as e:
                    sheds.append((p, n, repr(e)))
                except Exception as e:        # noqa: BLE001 - counted
                    errors.append((p, n, repr(e)))
        finally:
            client.close()
    threads = [threading.Thread(target=worker) for _ in range(FLEET_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, sheds, errors, time.perf_counter() - t0


def fleet_check(torch, lm, reqs, want, run, label, sheds_ok=False):
    """Every request of ``run`` (``fleet_load``'s) answered -- no failure,
    no shed unless ``sheds_ok``, every full pass complete -- and every
    stream equal to phase 4's paged ``kv_codec="none"`` stream, up to
    near ties (phase 19's rule). Returns a summary row."""
    out, sheds, errors, wall = run
    if errors:
        fail(f"fleet {label}: {len(errors)} requests failed, first "
             f"{errors[0]}")
    if sheds and not sheds_ok:
        fail(f"fleet {label}: {len(sheds)} requests shed, first {sheds[0]}")
    n_req = len(reqs[0])
    passes = sorted({p for p, _ in out} | {p for p, _, _ in sheds})
    answered = {(p, n) for p, n in out} | {(p, n) for p, n, _ in sheds}
    full = passes if not sheds_ok else passes[:-1]   # the last may be cut
    if any((p, n) not in answered for p in full for n in range(n_req)):
        fail(f"fleet {label}: a request of a full pass was never answered")
    equal = ties = 0
    for p in passes:
        idx = [n for n in range(n_req) if (p, n) in out]
        e, t = streams_agree(torch, lm, subset(reqs, idx),
                             [want[n] for n in idx],
                             [out[p, n] for n in idx], f"fleet {label}")
        equal, ties = equal + e, ties + t
    tokens = int(sum(len(s) for s in out.values()))
    return {"requests": len(out), "passes": len(passes),
            "sheds": len(sheds), "failures": 0, "equal": equal,
            "near_ties": ties, "tokens": tokens, "wall_s": wall,
            "requests_per_s": len(out) / wall, "tokens_per_s": tokens / wall}


def replica_of(router, index):
    return next(r for r in router._replicas if r.index == index)


def ready_with_new_pid(router, index, old_pid):
    r = [r for r in router._replicas if r.index == index]
    return bool(r) and r[0].state == "ready" and r[0].proc is not None \
        and r[0].proc.pid != old_pid and r[0].proc.poll() is None


def fleet_phase(torch, dev, card, served, server):
    """Phase 21: the port's ``Router`` over replicas spawned from one
    spec (phase 4's paged engine, its seeded weights saved as the
    ``.npz`` under their JAX names, ``device: "cuda"``), in this order:
    (a) an ``Autoscaler`` grows the pool 1 -> 2 under a burst of phase
    20's requests from 16 clients, (b) whose streams (and a second
    pass's over 2 replicas) equal phase 4's; (c) a replica SIGKILLed
    under load: every request answered, the slot restarted; (d)
    ``rolling_restart`` under load: no failure but typed sheds; (f) after
    a quiet period the autoscaler drains the pool back to 1; (g) a
    replica whose spec sets ``oom_exit`` and a ``MemoryError`` fault plan
    at its first admission exits 42 without a reply, its memdump holds
    the card's allocated bytes, and the router replaces it once with the
    fallback spec; (e) that replica SIGTERMed drains and exits 0; (h) a
    client process's spans chain through ``router.route`` into replica
    spans in the merged spools (``tools/trace_collect.py``). The replicas
    launch rows 14's kernel in their own processes: this process's
    launch counters do not see them."""
    import importlib.util
    import shutil
    import signal
    import sys
    import tempfile
    import threading
    from paddle_tpu_torch.observability import spool
    from paddle_tpu_torch.serving import metrics as smetrics
    from paddle_tpu_torch.serving.autoscaler import (Autoscaler,
                                                     AutoscalePolicy)
    from paddle_tpu_torch.serving.router import Router
    reqs, want = served["reqs"], served["streams"]["none"]
    lm = LazyModel(dev)
    work = tempfile.mkdtemp(prefix="paddle-fleet-")
    weights = os.path.join(work, "decoder_lm.npz")
    np.savez(weights, **random_params(1))
    spools = os.path.join(work, "spools")
    os.environ["FLAGS_trace_spool_dir"] = spools     # the children's
    spool.ensure_started(spools, role="router")
    fallback = fleet_spec(weights, oom_exit=True)
    plan = f"serving.dispatch:raise@{FLEET_WARMUP_HITS + 1}:exc=MemoryError"
    doomed = fleet_spec(weights, oom_exit=True,
                        env={"FLAGS_fault_plan": plan})
    restarts = {c: smetrics.ROUTER_RESTARTS.labels(cause=c)
                for c in ("crash", "rolling", "oom")}
    restarts0 = {c: f.value for c, f in restarts.items()}

    def failovers():
        return sum(c.value for c in
                   smetrics.ROUTER_FAILOVERS.children().values())
    out = {"clients": FLEET_CLIENTS, "policy": FLEET_POLICY,
           "weights_bytes": os.path.getsize(weights)}
    router = Router(spec=fleet_spec(weights), replicas=1,
                    workdir=os.path.join(work, "fleet"),
                    ready_timeout_s=FLEET_DEADLINE_S)
    asc = None
    killed = []
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        router.start()
        if not router.wait_ready(timeout_s=FLEET_DEADLINE_S):
            fail(f"fleet: the first replica never passed readyz: "
                 f"{router.stats()}")
        out["spawn_to_ready_s"] = time.perf_counter() - t0
        endpoint = router.serve()
        print(f"[{card}] fleet: a replica of phase 4's paged engine (the "
              f"{out['weights_bytes'] / 2 ** 20:.1f} MiB .npz) went from "
              f"spawn to readyz in {out['spawn_to_ready_s']:.2f} s; the "
              f"router serves at {endpoint}")

        # (a) + (b): the burst, the scale-up, the streams
        asc = Autoscaler(router, AutoscalePolicy(
            model="fleet", oom_fallback=fallback, **FLEET_POLICY))
        asc.start()
        out["burst"] = fleet_check(torch, lm, reqs, want, fleet_load(
            endpoint, "fleet", reqs, "burst"), "burst (a, b)")
        wait_for(lambda: router.stats()["size"] >= 2,
                 "scale-up by the autoscaler")
        up = next(d for d in asc.decisions if d["action"] == "scale_up")
        wait_for(lambda: router.stats()["ready"] == 2,
                 "second replica ready")
        out["scale_up"] = {"p99_s": up["p99"], "decision": up,
                           "spawn_to_ready_s": time.monotonic() - up["t"]}
        asc.stop()
        out["two_replicas"] = fleet_check(torch, lm, reqs, want, fleet_load(
            endpoint, "fleet", reqs, "two"), "two replicas (b)")
        direct = server["cells"]["b"]["wire_full"]
        out["direct_one_server"] = {
            k: float(np.mean([r[k] for r in direct]))
            for k in ("tokens_per_s", "requests_per_s")}
        for key in ("burst", "two_replicas"):
            row = out[key]
            print(f"[{card}] fleet {key}: {row['requests']} requests from "
                  f"{FLEET_CLIENTS} clients through the router, "
                  f"{row['equal']} equal phase 4's streams, "
                  f"{row['near_ties']} part at a near tie; "
                  f"{row['tokens_per_s']:.1f} tokens/s, "
                  f"{row['requests_per_s']:.2f} requests/s (phase 20 "
                  f"direct to one server from 16 clients: "
                  f"{out['direct_one_server']['tokens_per_s']:.1f} / "
                  f"{out['direct_one_server']['requests_per_s']:.2f})")
        print(f"[{card}] fleet (a): the autoscaler saw a queue-wait p99 of "
              f"{up['p99']} s against the SLO "
              f"{FLEET_POLICY['slo_queue_wait_p99_s']} s and scaled 1 -> 2; "
              f"the new replica was ready "
              f"{out['scale_up']['spawn_to_ready_s']:.2f} s after the "
              f"decision")

        # (c) SIGKILL a replica under load
        f0 = failovers()
        res = {}
        load = threading.Thread(target=lambda: res.setdefault(
            "run", fleet_load(endpoint, "fleet", reqs, "kill")))
        load.start()
        wait_for(lambda: sum(r.inflight for r in router._replicas) >= 4,
                 "requests in flight")
        victim = max(router._replicas, key=lambda r: r.inflight)
        pid = victim.proc.pid
        inflight = victim.inflight
        t_kill = time.perf_counter()
        os.kill(pid, signal.SIGKILL)
        killed.append(pid)
        load.join()
        out["sigkill"] = fleet_check(torch, lm, reqs, want, res["run"],
                                     "SIGKILL (c)")
        restart_s = wait_for(lambda: ready_with_new_pid(
            router, victim.index, pid), "restart of the killed slot")
        out["sigkill"].update(
            victim=victim.index, inflight_at_kill=inflight,
            failovers=failovers() - f0,
            restart_s=time.perf_counter() - t_kill,
            restart_wait_after_load_s=restart_s,
            crash_restarts=restarts["crash"].value - restarts0["crash"])
        if out["sigkill"]["failovers"] < 1 or \
                out["sigkill"]["crash_restarts"] < 1:
            fail(f"fleet SIGKILL (c): {out['sigkill']}")
        print(f"[{card}] fleet (c): replica {victim.index} SIGKILLed with "
              f"{inflight} requests in flight: all {N_REQUESTS} answered "
              f"({out['sigkill']['equal']} equal phase 4's), "
              f"{out['sigkill']['failovers']:.0f} failovers; the slot was "
              f"ready again {out['sigkill']['restart_s']:.2f} s after the "
              f"kill")

        # (d) rolling restart under load
        pids = {r.index: r.proc.pid for r in router._replicas}
        stop = threading.Event()
        load = threading.Thread(target=lambda: res.__setitem__(
            "roll", fleet_load(endpoint, "fleet", reqs, "roll", stop=stop)))
        load.start()
        t_roll = time.perf_counter()
        rolled = router.rolling_restart()
        roll_s = time.perf_counter() - t_roll
        stop.set()
        load.join()
        if not rolled.get("ok"):
            fail(f"fleet rolling restart (d): {rolled}")
        out["rolling"] = fleet_check(torch, lm, reqs, want, res["roll"],
                                     "rolling restart (d)", sheds_ok=True)
        out["rolling"].update(seconds=roll_s, results=rolled["results"])
        if any(r.proc.pid == pids.get(r.index) for r in router._replicas):
            fail("fleet rolling restart (d): a replica kept its process")
        print(f"[{card}] fleet (d): rolling restart of "
              f"{len(rolled['results'])} replicas in {roll_s:.2f} s under "
              f"load: {out['rolling']['requests']} requests answered, 0 "
              f"failures, {out['rolling']['sheds']} typed sheds; every "
              f"replica has a new process")

        # (f) a quiet period: the autoscaler drains the pool back to 1
        t_quiet = time.perf_counter()
        asc.start()
        wait_for(lambda: router.stats()["size"] == 1,
                 "scale-down by the autoscaler")
        asc.stop()
        down = [d for d in asc.decisions if d["action"] == "scale_down"]
        sizes = [s["size"] for s in asc.fleet_trace]
        path = [s for i, s in enumerate(sizes) if i == 0 or s != sizes[i - 1]]
        if path != [1, 2, 1] or not down[-1].get("drained"):
            fail(f"fleet (f): the autoscaler's pool went {path}, "
                 f"decisions {asc.decisions}")
        out["scale_down"] = {"seconds_after_quiet":
                             time.perf_counter() - t_quiet,
                             "decision": down[-1], "pool": path}
        print(f"[{card}] fleet (f): after a quiet period the autoscaler "
              f"drained replica {down[-1]['removed']} "
              f"{out['scale_down']['seconds_after_quiet']:.2f} s in: the "
              f"pool went {' -> '.join(map(str, path))}")

        # (g) the OOM replica: exit 42, memdump, replaced once
        added = router.scale_up(spec=doomed)
        k = added["added"][0]
        slot = replica_of(router, k)
        wait_for(lambda: slot.state == "ready", "the oom_exit replica ready")
        oom_pid = slot.proc.pid
        f0 = failovers()
        t_oom = time.perf_counter()
        run = fleet_load(endpoint, "fleet", reqs, "oom")
        out["oom"] = fleet_check(torch, lm, reqs, want, run,
                                 "OOM replica (g)")
        killed.append(oom_pid)
        wait_for(lambda: ready_with_new_pid(router, k, oom_pid),
                 "the fallback replica ready")
        exit_ = slot.last_exit or {}
        memdump = exit_.get("memdump")
        if exit_.get("code") != 42 or exit_.get("cause") != "oom" \
                or not memdump:
            fail(f"fleet OOM (g): the replica's exit was {exit_}")
        with open(memdump) as f:
            doc = json.load(f)
        if doc["total_bytes"] < WEIGHT_BYTES_MIN or \
                doc["exc_type"] != "MemoryError" or doc["pid"] != oom_pid:
            fail(f"fleet OOM (g): memdump {memdump} holds {doc}")
        oom_restarts = restarts["oom"].value - restarts0["oom"]
        if oom_restarts != 1 or slot.spec != fallback \
                or not slot.oom_replaced:
            fail(f"fleet OOM (g): {oom_restarts} oom restarts, spec "
                 f"{slot.spec}")
        out["oom"].update(
            exit=exit_, failovers=failovers() - f0,
            memdump_total_bytes=doc["total_bytes"],
            memdump_device=doc["device"], oom_restarts=oom_restarts,
            fallback_ready_s=time.perf_counter() - t_oom)
        print(f"[{card}] fleet (g): replica {k} (oom_exit, fault plan "
              f"{plan!r}) exited 42 without a reply; every request "
              f"answered ({out['oom']['failovers']:.0f} failovers); its "
              f"memdump holds {doc['total_bytes'] / 2 ** 20:.1f} MiB "
              f"allocated on {doc['device'].get('device')} (peak "
              f"{doc['watermark_bytes'] / 2 ** 20:.1f}); the router "
              f"recorded cause=oom and replaced it once with the fallback "
              f"spec")

        # (e) SIGTERM: the replica drains and exits 0
        pid, before = slot.proc.pid, slot.last_exit
        t_term = time.perf_counter()
        os.kill(pid, signal.SIGTERM)
        wait_for(lambda: slot.last_exit is not before,
                 "the SIGTERMed replica's exit")
        if (slot.last_exit or {}).get("code") != 0:
            fail(f"fleet SIGTERM (e): the replica exited {slot.last_exit}")
        out["sigterm"] = {"exit": slot.last_exit,
                          "seconds": time.perf_counter() - t_term}
        print(f"[{card}] fleet (e): replica {k} SIGTERMed drained and "
              f"exited 0 in {out['sigterm']['seconds']:.2f} s")

        # (h) a client process's spans through router.route to replicas
        code = ("import sys\n"
                "from paddle_tpu_torch import flags\n"
                "flags.set('trace_role', 'client')\n"
                "from paddle_tpu_torch.observability import spool\n"
                "from paddle_tpu_torch.serving.client import ServingClient\n"
                "c = ServingClient(sys.argv[1])\n"
                "for i in range(2):\n"
                "    c.generate(sys.argv[2], [[1, 2, 3, 4, 5]], max_new=4,\n"
                "               request_id=f'trace-{i}')\n"
                "c.close()\n"
                "spool.shutdown()\n")
        subprocess.run([sys.executable, "-c", code, endpoint, "fleet"],
                       check=True, timeout=FLEET_DEADLINE_S)
        wait_for(lambda: router.stats()["ready"] == 2,
                 "the SIGTERMed slot's restart")
        out["stats"] = router.stats()
    finally:
        if asc is not None:
            asc.stop()
        router.stop()
        spool.shutdown()
        os.environ.pop("FLAGS_trace_spool_dir", None)
    out["seconds"] = time.perf_counter() - t_phase

    spec = importlib.util.spec_from_file_location(
        "trace_collect", os.path.join("tools", "trace_collect.py"))
    tc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tc)
    paths = tc.find_spools(spools)
    torn = {f"replica.{pid}.jsonl" for pid in killed}
    problems = [p for p in tc.check(paths, chain=["client", "router",
                                                  "replica"])
                if not (p.split("[")[0] in torn
                        and "unresolved parent" in p)]
    if problems:
        fail(f"fleet trace (h): {problems[:5]}")
    roles, routed = {}, 0
    spans = {}
    for path in paths:
        meta, recs, _ = tc.load_spool(path)
        roles[meta["role"]] = roles.get(meta["role"], 0) + len(recs)
        spans.update({r["span_id"]: (meta["role"], r) for r in recs
                      if r.get("span_id")})
    for role, rec in spans.values():
        parent = spans.get(rec.get("parent_id"))
        if role == "replica" and parent and parent[1]["name"] == \
                "router.route":
            routed += 1
    if not routed:
        fail("fleet trace (h): no replica span under a router.route span")
    out["trace"] = {"spools": len(paths), "spans_by_role": roles,
                    "replica_spans_under_router_route": routed}
    print(f"[{card}] fleet (h): {len(paths)} spools merged; a client "
          f"process's spans chain client -> router.route -> replica "
          f"({routed} replica spans under router.route; spans by role "
          f"{json.dumps(roles)}); the killed replicas' torn parents aside, "
          f"trace_collect's checks pass")
    print(f"[{card}] fleet: phase 21 took {out['seconds']:.1f} s")
    shutil.rmtree(work, ignore_errors=True)
    return out


# -- phase 5: flash kernels -------------------------------------------------

def flash_cost(bh, tq, tk, d, causal, elem=4):
    """(FLOPs, bytes) of the forward, dQ, dK/dV and the one-pass backward
    at these shapes: 4, 6, 8 and 10 FLOPs per visible (query, key) pair and
    head-dim element; each input read once and each output written once
    (``elem`` bytes an operand value; the rows are fp32)."""
    q_off = tk - tq
    pairs = sum(min(tk, max(0, q_off + i + 1)) for i in range(tq)) \
        if causal else tq * tk
    mat_q, mat_k, row = bh * tq * d * elem, bh * tk * d * elem, bh * tq * 4
    return {"flash_fwd": (4 * bh * pairs * d, mat_q + 2 * mat_k + mat_q
                          + row),
            "flash_dq": (6 * bh * pairs * d, 2 * mat_q + 2 * mat_k
                         + 2 * row + mat_q),
            "flash_dkv": (8 * bh * pairs * d, 2 * mat_q + 2 * mat_k
                          + 2 * row + 2 * mat_k),
            "flash_bwd": (10 * bh * pairs * d, 2 * mat_q + 2 * mat_k
                          + 2 * row + mat_q + 2 * mat_k)}


def bound_of(flops, nbytes, rate=FP32_FLOPS_PER_S):
    """(ms, what bounds it): the larger of the FLOPs at ``rate`` and the
    bytes at the card's memory rate."""
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def close(got, want, tol):
    import torch
    return torch.allclose(got, want, **tol) and bool(
        torch.isfinite(got).all())


def low_tol(torch, want):
    """bf16 / fp16 against the plain version in the same dtype: one step
    of the dtype at the largest magnitude plus one of each element (the
    forward's online softmax rounds p against a running max; sums in
    another order)."""
    step = FLASH_LOW_STEP[str(want.dtype).split(".")[1]]
    return dict(rtol=step, atol=step * float(want.float().abs().max()))


def flash_library_ms(torch, fa, q, k, v, g, heads, causal, scale, flush):
    """The library yardstick: one SDPA call (dropout off) and its
    backward, held to the plain versions first (fp32 within
    FLASH_GRAD_TOL, bf16 / fp16 within ``low_tol``); the device time a
    call of each (``kernel_split``: SDPA's calls are host-bound, so CUDA
    events would read the host's time), and under ``event_`` keys their
    CUDA-event times. The backward computes dQ, dK and dV in one call: it
    is the yardstick of ``flash_bwd`` and of the dQ + dK/dV pair together."""
    import torch.nn.functional as F
    bh, t, d = q.shape
    q4, k4, v4 = (x.view(bh // heads, heads, t, d).detach().requires_grad_()
                  for x in (q, k, v))
    g4 = g.view(bh // heads, heads, t, d)

    def lib_fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                              scale=scale)
    lib_out = lib_fwd()
    lib_grads = torch.autograd.grad(lib_out, (q4, k4, v4), g4,
                                    retain_graph=True)
    o0, lse0 = fa.flash_fwd_ref(q, k, v, causal, scale)
    d0 = (o0.float() * g.float()).sum(-1)
    want0 = (o0, *fa.flash_bwd_ref(q, k, v, g, lse0, d0, causal, scale))
    for name, got, want in zip(("o", "dq", "dk", "dv"),
                               (lib_out, *lib_grads), want0):
        tol = FLASH_GRAD_TOL if want.dtype == torch.float32 \
            else low_tol(torch, want)
        if not torch.allclose(got.reshape(want.shape).float(), want.float(),
                              **tol):
            fail(f"flash causal={causal} {q.dtype}: the library yardstick's "
                 f"{name} differs from the plain version at p = 0")

    def lib_bwd():
        return torch.autograd.grad(lib_out, (q4, k4, v4), g4,
                                   retain_graph=True)
    fwd_ms, bwd_ms = (device_ms(torch, fn) for fn in (lib_fwd, lib_bwd))
    ev_fwd, ev_bwd = (time_ms(torch, fn, flush) for fn in (lib_fwd, lib_bwd))
    return {"flash_fwd": fwd_ms, "flash_dq": bwd_ms, "flash_dkv": bwd_ms,
            "flash_bwd": bwd_ms, "event_flash_fwd": ev_fwd,
            "event_flash_dq": ev_bwd, "event_flash_dkv": ev_bwd,
            "event_flash_bwd": ev_bwd}


def device_ms(torch, fn, n=10):
    """Device ms a call of ``fn``: its kernels' time summed over a
    profiler window (``kernel_split``), the host's time left out."""
    return sum(kernel_split(torch, fn, n=n).values())


def flash_rows(torch, fa, card, label, qkvg, causal, p, seed, flush,
               lib_ms=None, kernels=("flash_fwd", "flash_dq", "flash_dkv",
                                     "flash_bwd"), timed=True):
    """Each flash kernel against its plain version at one shape (fp32
    within FLASH_FWD_TOL / FLASH_GRAD_TOL, bf16 / fp16 within ``low_tol``),
    the forward and ``flash_bwd`` twice with the same bits; then
    (``timed``) each timed beside plain, its bounds, its device time a call
    and (``lib_ms``) the library's device time (by events too). The
    forward runs its tensor-core kernel up to head width 128, ``flash_bwd``
    within its range (their bound: three TF32 products at 495 TFLOP/s for
    fp32, 989 TFLOP/s for bf16 / fp16), else the forward's SIMT kernel and
    the dQ and dK/dV kernels, which are fp32 SIMT (67 TFLOP/s). Every row
    also gives the other bound."""
    q, k, v, g = qkvg
    bh, t, d = q.shape
    args = (causal, d ** -0.5, p, seed)
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, *args)
    bwd = (q, k, v, g, lse_ref, (o_ref.float() * g.float()).sum(-1))
    runs = {"flash_fwd": (lambda: fa.flash_fwd(q, k, v, *args),
                          lambda: fa.flash_fwd_ref(q, k, v, *args),
                          ("o", "lse"), FLASH_FWD_TOL),
            "flash_dq": (lambda: fa.flash_dq(*bwd, *args),
                         lambda: fa.flash_dq_ref(*bwd, *args), ("dq",),
                         FLASH_GRAD_TOL),
            "flash_dkv": (lambda: fa.flash_dkv(*bwd, *args),
                          lambda: fa.flash_dkv_ref(*bwd, *args),
                          ("dk", "dv"), FLASH_GRAD_TOL),
            "flash_bwd": (lambda: fa.flash_bwd(*bwd, *args),
                          lambda: fa.flash_bwd_ref(*bwd, *args),
                          ("dq", "dk", "dv"), FLASH_GRAD_TOL)}
    low = q.dtype != torch.float32
    elem = q.element_size()
    cost = flash_cost(bh, t, t, d, causal, elem)
    tensor_rate = BF16_FLOPS_PER_S if low else TF32_FLOPS_PER_S / 3
    rows = {}
    for kname in kernels:
        fn, ref, names, tol = runs[kname]
        got, want = fn(), ref()
        torch.cuda.synchronize()
        got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
        err = 0.0
        for name, a, w in zip(names, got, want):
            wtol = low_tol(torch, w) if low and name != "lse" else tol
            err = max(err, float((a.float() - w.float()).abs().max()))
            if a.shape != w.shape or a.dtype != w.dtype or \
                    not close(a.float(), w.float(), wtol):
                fail(f"flash {label}: {name} differs from the plain version "
                     f"(max abs err {err}, tolerance {wtol})")
        route = kname
        if kname in ("flash_fwd", "flash_bwd"):
            route = fa.fwd_kernel(d) if kname == "flash_fwd" \
                else fa.bwd_kernel(t, d)
            again = fn()
            if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                fail(f"flash {label}: a second {kname} gave other bits")
        flops, nbytes = cost[kname]
        simt_ms, simt_by = bound_of(flops, nbytes)
        tc_ms, tc_by = bound_of(flops, nbytes, tensor_rate)
        on_tc = route in ("flash_bwd", "tensor_cores")
        row = rows[kname] = {
            "max_abs_err": err, "route": route,
            "bound_ms": tc_ms if on_tc else simt_ms,
            "bound_by": tc_by if on_tc else simt_by,
            "bound_simt_ms": simt_ms, "bound_tensor_ms": tc_ms,
            "flops": flops, "bytes": nbytes, "dtype": str(q.dtype),
            "kernel_width": fa.kernel_width(kname, d), "ms": None,
            "plain_ms": None, "library_ms": None, "device_ms": None,
            "library_event_ms": None}
        if not timed:
            continue
        row.update(ms=time_ms(torch, fn, flush),
                   plain_ms=time_ms(torch, ref, flush),
                   device_ms=device_ms(torch, fn))
        if lib_ms:
            row.update(library_ms=lib_ms[kname],
                       library_event_ms=lib_ms[f"event_{kname}"])
            one_call = " (dQ+dK+dV in one call)" if kname != "flash_fwd" \
                else ""
            lib = (f"; device time a call {row['device_ms'] * 1e3:.2f} us "
                   f"against the library's {row['library_ms'] * 1e3:.2f} us"
                   f"{one_call} (its events "
                   f"{row['library_event_ms'] * 1e3:.2f} us)")
        else:
            lib = f"; device time a call {row['device_ms'] * 1e3:.2f} us"
        print(f"[{card}] {kname} {label} [{bh}x{t}x{d}] {q.dtype} (run at "
              f"head width {row['kernel_width']}"
              f"{', as ' + route if route != kname else ''}): max abs err "
              f"{err:.3g}; kernel {row['ms'] * 1e3:.2f} us, plain "
              f"{row['plain_ms'] * 1e3:.2f} us{lib}, bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}: "
              f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; SIMT "
              f"{simt_ms * 1e3:.2f} us, tensor cores {tc_ms * 1e3:.2f} us)")
    if not timed:
        print(f"[{card}] flash {label} [{bh}x{t}x{d}] {q.dtype}: "
              + ", ".join(f"{k} max abs err {r['max_abs_err']:.3g}"
                          for k, r in rows.items()))
    return rows


def flash_function_ms(torch, fa, qkvg, heads, causal, flush, rounds=4,
                      bwd=None):
    """The whole ``FlashAttention.backward`` (delta = rowsum(o * dO) and
    one ``flash_bwd``) against SDPA's backward on the same inputs, in
    turns (ours, library, library, ours) over ``rounds`` rounds: the median
    of each by CUDA events (the host's time too where it exceeds the
    device's). Then the device time a call of each, of the backward kernel
    alone (``bwd(*args)`` with the arguments of ``flash_bwd``; by default
    ``flash_bwd``) and (fp32) of the dQ + dK/dV pair, from a profiler window
    (``kernel_split``): the sum over the kernels of the call. Like is held
    against like: the Function against SDPA's whole backward, the kernel
    alone against SDPA's longest kernel alone (``library_kernel``: its
    name and ms a call; the rest of SDPA's backward, its delta among it,
    is elementwise and reduction kernels)."""
    import torch.nn.functional as F
    q, k, v, g = qkvg
    bh, t, d = q.shape
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*(x.view(bh // heads, heads, t, d)
                               for x in leaves), causal)
    lib_leaves = [x.view(bh // heads, heads, t, d).detach().requires_grad_()
                  for x in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_leaves, is_causal=causal)
    g4 = g.view(bh // heads, heads, t, d)

    def ours():
        return torch.autograd.grad(out, leaves, g4, retain_graph=True)

    def lib():
        return torch.autograd.grad(lib_out, lib_leaves, g4, retain_graph=True)
    times = {"function": [], "library": []}
    for _ in range(rounds):
        for name, fn in (("function", ours), ("library", lib),
                         ("library", lib), ("function", ours)):
            times[name].append(time_ms(torch, fn, flush, n=20))
    res = {name: float(np.median(ts)) for name, ts in times.items()}
    o, lse = fa.flash_fwd(q, k, v, causal, d ** -0.5)
    args = (q, k, v, g, lse, (o.float() * g.float()).sum(-1), causal,
            d ** -0.5)
    bwd = bwd or fa.flash_bwd
    device = {"function": ours, "library": lib,
              "flash_bwd": lambda: bwd(*args)}
    if q.dtype == torch.float32:
        device["pair"] = lambda: (fa.flash_dq(*args), fa.flash_dkv(*args))
    for name, fn in device.items():
        split = kernel_split(torch, fn, n=10)
        res[f"{name}_device_ms"] = sum(split.values())
        res[f"{name}_kernels"] = split
    top = max(res["library_kernels"].items(), key=lambda kv: kv[1],
              default=("", 0.0))
    res["library_kernel"], res["library_kernel_ms"] = short_name(top[0]), \
        top[1]
    return res


def short_name(kernel):
    """A profiler kernel name up to its argument list, at most 60
    characters."""
    return kernel.split("(")[0][:60]


def flash_block_step(torch, fa, card, dev, d_model, n_head, b=4, t=64,
                     seed=31):
    """One training step of a causal self-attention block at ``d_model``
    over ``n_head`` heads: the fused block (``fused_attention_block``, one
    launch of each flash kernel) against the composed block
    (``multi_head_attention``, no kernel) on the same seeded input, weights
    and output gradient: the output within FLASH_FWD_TOL, the gradients of
    the input and of the four projections within FLASH_GRAD_TOL."""
    from types import SimpleNamespace
    from paddle_tpu_torch.models import transformer as tr
    from paddle_tpu_torch.ops import attention_block as ab
    gen = torch.Generator(device=dev).manual_seed(seed)
    x, g = (torch.randn(b, t, d_model, generator=gen, device=dev)
            for _ in range(2))
    ws = [torch.randn(d_model, d_model, generator=gen, device=dev)
          * d_model ** -0.5 for _ in range(4)]
    mask = torch.triu(torch.full((t, t), -1e9, device=dev), 1)

    def step(fused):
        leaves = [a.clone().requires_grad_() for a in (x, *ws)]
        if fused:
            out = ab.fused_attention_block(leaves[0], leaves[0], *leaves[1:],
                                           n_head, causal=True)
        else:
            w = SimpleNamespace(**dict(zip(("wq", "wk", "wv", "wo"),
                                           leaves[1:])))
            out = tr.multi_head_attention(leaves[0], leaves[0], w, n_head,
                                          mask=mask)
        return (out, *torch.autograd.grad(out, leaves, g))

    n0 = dict(fa.LAUNCHES)
    fused = step(True)
    torch.cuda.synchronize()
    launched = {k: fa.LAUNCHES[k] - n0[k] for k in n0}
    composed = step(False)
    torch.cuda.synchronize()
    label = (f"attention block d_model {d_model} / {n_head} head(s) (head "
             f"width {d_model // n_head}, run at "
             f"{fa.kernel_width('flash', d_model // n_head)})")
    one = fa.bwd_kernel(t, d_model // n_head) == "flash_bwd"
    want = {"flash_fwd": 1, "flash_dq": int(not one),
            "flash_dkv": int(not one), "flash_bwd": int(one)}
    if launched != want:
        fail(f"{label}: one step launched {launched}, want {want}")
    errs = {}
    for name, a, w, tol in zip(("out", "dx", "dwq", "dwk", "dwv", "dwo"),
                               fused, composed,
                               (FLASH_FWD_TOL,) + (FLASH_GRAD_TOL,) * 5):
        errs[name] = float((a - w).abs().max().detach())
        if not close(a, w, tol):
            fail(f"{label}: fused {name} differs from the composed block "
                 f"(max abs err {errs[name]}, tolerance {tol})")
    print(f"[{card}] {label}, B {b}, T {t}: one training step, fused equals "
          f"composed; max abs err "
          + ", ".join(f"{k} {e:.3g}" for k, e in errs.items()))
    return {"max_abs_err": errs, "launches": launched}


def flash_mixed(torch, fa, card, qkvg, seed):
    """q, k, v of mixed dtypes (FLASH_MIXED, the combinations of the CPU
    test ``test_mixed_dtypes_match_pallas``), dO in q's dtype, causal with
    dropout 0.1: the forward and ``flash_bwd`` against the plain versions
    on the same inputs, each output in the dtype the reference gives it
    (o and dq in q's, dk in k's, dv in v's), within one step of the narrow
    dtype at the largest magnitude plus one of each element (the kernels
    round p and dS to it where the reference does; a value at a rounding
    boundary may round the other way), lse within FLASH_FWD_TOL."""
    q, k, v, g = qkvg
    d = q.shape[-1]
    args = (True, d ** -0.5, 0.1, seed)
    out = {}
    for dtypes in FLASH_MIXED:
        dts = [getattr(torch, n) for n in dtypes]
        narrow = next(n for n in dtypes if n != "float32")
        step = FLASH_LOW_STEP[narrow]
        x = (q.to(dts[0]), k.to(dts[1]), v.to(dts[2]))
        gq = g.to(dts[0])
        o, lse = fa.flash_fwd(*x, *args)
        want_o, want_lse = fa.flash_fwd_ref(*x, *args)
        bwd = (*x, gq, want_lse, (want_o.float() * gq.float()).sum(-1))
        got = fa.flash_bwd(*bwd, *args)
        want = fa.flash_bwd_ref(*bwd, *args)
        torch.cuda.synchronize()
        label = f"flash q {dtypes[0]}, k {dtypes[1]}, v {dtypes[2]}"
        errs = {"lse": float((lse - want_lse).abs().max())}
        if not close(lse, want_lse, FLASH_FWD_TOL):
            fail(f"{label}: lse differs from the plain version")
        for name, a, w, dt in zip(("o", "dq", "dk", "dv"), (o, *got),
                                  (want_o, *want), (dts[0], *dts)):
            tol = dict(rtol=step, atol=step * float(w.float().abs().max()))
            errs[name] = float((a.float() - w.float()).abs().max())
            if a.dtype != dt or not close(a.float(), w.float(), tol):
                fail(f"{label}: {name} ({a.dtype}, want {dt}) differs from "
                     f"the plain version (max abs err {errs[name]}, "
                     f"tolerance {tol})")
        out["/".join(dtypes)] = errs
        print(f"[{card}] {label} [{q.shape[0]}x{q.shape[1]}x{d}] causal "
              f"dropout 0.1 (widened to fp32, rounded to {narrow} where the "
              f"reference rounds): max abs err "
              + ", ".join(f"{n} {e:.3g}" for n, e in errs.items()))
    return out


def flash_phase(torch, dev, card, b=BATCH, h=None, t=None, d=None,
                widths=FLASH_WIDTHS, blocks=FLASH_BLOCKS, rounds=4,
                long=FLASH_LONG):
    """Each flash kernel against its plain version at the training
    shapes, timed beside plain, bounds and library; the same in bf16 (timed)
    and fp16 for the forward and the one-pass backward; q, k, v of mixed
    dtypes; the forward at key length ``long`` (above flash_bwd's 512), fp32
    and bf16; the whole autograd backward against SDPA's in turns; then,
    causal, at the head ``widths``
    that the wrappers pad (d_model 96 over 2 heads: 48), run on the widest
    tiles (256) or take in 256-wide chunks (257, 320), timed beside plain
    and bound; then one training step of the attention ``blocks`` whose
    head width is above 256 against the composed block."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    h = h or TRAIN["n_head"]
    t = t or TRAIN["max_len"]
    d = d or TRAIN["d_model"] // TRAIN["n_head"]
    seed = 20260
    gen = torch.Generator(device=dev).manual_seed(5)
    qkvg = tuple(torch.randn(b * h, t, d, generator=gen, device=dev)
                 for _ in range(4))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    results = {}
    for variant, (causal, p) in FLASH_VARIANTS.items():
        lib_ms = flash_library_ms(torch, fa, *qkvg, h, causal, d ** -0.5,
                                  flush)
        for kname, row in flash_rows(torch, fa, card, variant, qkvg, causal,
                                     p, seed, flush, lib_ms).items():
            results[f"{kname}/{variant}"] = row
    low = {}
    for dt, timed in ((torch.bfloat16, True), (torch.float16, False)):
        name = str(dt).split(".")[1]
        low[name] = x = tuple(a.to(dt) for a in qkvg)
        lib_ms = flash_library_ms(torch, fa, *x, h, False, d ** -0.5,
                                  flush) if timed else None
        for label, causal, p in (("full", False, 0.0),
                                 ("causal dropout", True, 0.1)):
            rows = flash_rows(torch, fa, card, f"{label} {name}", x, causal,
                              p, seed, flush, lib_ms,
                              kernels=("flash_fwd", "flash_bwd"),
                              timed=timed and not causal)
            for kname, row in rows.items():
                results[f"{kname}/{label.replace(' ', '_')}_{name}"] = row
    results["mixed"] = flash_mixed(torch, fa, card, qkvg, seed)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        x = tuple(torch.randn(16, long, d, generator=gen, device=dev).to(dt)
                  for _ in range(4))
        results[f"flash_fwd/t{long}_{name}"] = flash_rows(
            torch, fa, card, f"causal dropout T {long} {name}", x, True,
            0.1, seed, flush, kernels=("flash_fwd",), timed=False)[
                "flash_fwd"]
    for label, x, causal in (("full", qkvg, False), ("causal", qkvg, True),
                             ("full bfloat16", low["bfloat16"], False)):
        r = results[f"function/{label.replace(' ', '_')}"] = \
            flash_function_ms(torch, fa, x, h, causal, flush, rounds)
        pair = (f", the dQ + dK/dV pair {r['pair_device_ms'] * 1e3:.2f} us"
                if "pair_device_ms" in r else "")
        print(f"[{card}] FlashAttention.backward {label} [{b * h}x{t}x{d}] "
              f"(delta and flash_bwd) {r['function'] * 1e3:.2f} us, SDPA "
              f"backward {r['library'] * 1e3:.2f} us ({rounds} rounds in "
              f"turns, medians by events); device time a call: the "
              f"Function {r['function_device_ms'] * 1e3:.2f} us against "
              f"SDPA's backward {r['library_device_ms'] * 1e3:.2f} us; "
              f"flash_bwd alone {r['flash_bwd_device_ms'] * 1e3:.2f} us "
              f"against SDPA's longest kernel alone "
              f"{r['library_kernel_ms'] * 1e3:.2f} us "
              f"({r['library_kernel']}){pair}; SDPA's backward by kernel: "
              + ", ".join(f"{short_name(k)} {v_ * 1e3:.2f} us" for k, v_ in
                          r["library_kernels"].items()))
    for dw in widths:
        wide = tuple(torch.randn(b * 2, t, dw, generator=gen, device=dev)
                     for _ in range(4))
        for kname, row in flash_rows(torch, fa, card, "causal", wide, True,
                                     0.0, seed, flush).items():
            results[f"{kname}/d{dw}"] = row
    del flush
    for d_model, heads in blocks:
        results[f"block/m{d_model}h{heads}"] = flash_block_step(
            torch, fa, card, dev, d_model, heads)
    return results


# -- phase 6: fused-CE kernels ----------------------------------------------

def fce_cost(n, d, v, elem=4):
    """(FLOPs, bytes) of the fused-CE forward and backward: 2*N*D*V for the
    forward's product; 6*N*D*V for the backward (one recompute of z and
    the two gradient products); each input read once, each output written
    once (``elem`` bytes an operand value)."""
    x_b, w_b, row_b = n * d * elem, d * v * elem, n * 4
    return {"fused_ce_fwd": (2 * n * d * v, x_b + w_b + row_b + 2 * row_b),
            "fused_ce_bwd": (6 * n * d * v,
                             2 * x_b + 2 * w_b + 3 * row_b)}


def fce_bounds(flops, nbytes, dtype_name):
    """(bound_ms, bound_by, simt_bound_ms): the bound at the tensor-core
    rate of the kernel's path (fp32 through 3xTF32: three TF32 products
    at 495 TFLOP/s; bf16 and fp16 at 989) and, for comparison with the
    earlier kernels, at 67 TFLOP/s fp32 outside the tensor cores; each
    against the bytes over 3.35 TB/s."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * flops / TF32_FLOPS_PER_S if dtype_name == "float32" \
        else flops / BF16_FLOPS_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            bound_of(flops, nbytes)[0])


def fce_inputs(torch, dev, n, d, v, seed, dtype=None):
    """x ~ N(0, 1) (a layer-normed decoder output), w ~ N(0, 1/D), labels
    with every 50th row at ignore_index, a per-row cotangent in
    [0.5, 1.5) (the kernels take any g; the mean's 1/N would put dx under
    the absolute tolerance); x and w rounded to ``dtype`` when given."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, d, generator=gen, device=dev)
    w = torch.randn(d, v, generator=gen, device=dev) * d ** -0.5
    labels = torch.randint(0, v, (n,), generator=gen, device=dev)
    labels[::50] = IGNORE
    g = torch.rand(n, generator=gen, device=dev) + 0.5
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    return x, w, labels, g


def fce_low_tol(torch, fc, x, w, labels, lse, g, eps):
    """Per-element slack of dx and dW for bf16 / fp16 operands (both sides
    round dz to the operand type and their fp32 sums once): one step of
    dz (2**-m |dz|, m mantissa bits) times its partner, summed, plus the
    fp32 order term; the comparison adds one step of the result
    (tests/test_torch_fused_ce.py ``_low_precision_tol``)."""
    m = FCE_MANTISSA[str(x.dtype).split(".")[-1]]
    step = 0.0 if x.dtype == torch.float32 else 2.0 ** -m   # dz not rounded
    xf, wf = x.float(), w.float()
    on, _, off, _ = fc._consts(eps, w.shape[1])
    cols = torch.arange(w.shape[1], device=x.device)
    t = torch.where(cols[None] == labels.long()[:, None], on, 0.0) + off
    dz = (torch.exp(xf @ wf - lse[:, None]) - t) * g[:, None]
    dz = torch.where((labels == IGNORE)[:, None], 0.0, dz).abs()
    n, v = dz.shape
    return ((step + v * 2.0 ** -24) * (dz @ wf.abs().t()),
            (step + n * 2.0 ** -24) * (xf.abs().t() @ dz))


def fce_within(torch, got, want, slack):
    """|got - want| <= one step of got's dtype at |want| + slack."""
    m = FCE_MANTISSA[str(got.dtype).split(".")[-1]]
    wf = want.float()
    step = torch.exp2(torch.floor(torch.log2(
        wf.abs().clamp_min(torch.finfo(got.dtype).tiny))) - m)
    err = (got.float() - wf).abs()
    return bool((err <= step + slack).all()), float(err.max())


def fce_check(torch, fc, x, w, labels, g, eps, label):
    """Each kernel against its plain version (fp32 within FCE_FWD_TOL /
    FCE_GRAD_TOL, bf16 and fp16 gradients within :func:`fce_low_tol`),
    and a second call bit-equal to the first; returns the max abs errors,
    the plain lse and the plain (loss, dx, dW)."""
    loss, lse = fc.fused_ce_fwd(x, w, labels, eps)
    want_loss, want_lse = fc.fused_ce_fwd_ref(x, w, labels, eps)
    dx, dw = fc.fused_ce_bwd(x, w, labels, want_lse, g, eps)
    want_dx, want_dw = fc.fused_ce_bwd_ref(x, w, labels, want_lse, g, eps)
    again = fc.fused_ce_fwd(x, w, labels, eps)[0], *fc.fused_ce_bwd(
        x, w, labels, want_lse, g, eps)
    torch.cuda.synchronize()
    errs = {}
    slack = fce_low_tol(torch, fc, x, w, labels, want_lse, g, eps) \
        if x.dtype != torch.float32 else (None, None)
    for name, got, want, tol, sl in (
            ("loss", loss, want_loss, FCE_FWD_TOL, None),
            ("lse", lse, want_lse, FCE_FWD_TOL, None),
            ("dx", dx, want_dx, FCE_GRAD_TOL, slack[0]),
            ("dw", dw, want_dw, FCE_GRAD_TOL, slack[1])):
        if sl is None:
            errs[name] = float((got - want).abs().max())
            ok = close(got, want, tol)
        else:
            ok, errs[name] = fce_within(torch, got, want, sl)
        if not ok:
            fail(f"fused CE {label}: {name} differs from the plain version "
                 f"(max abs err {errs[name]})")
    if not all(torch.equal(a, b) for a, b in zip(again, (loss, dx, dw))):
        fail(f"fused CE {label}: a second call gave other bits")
    if bool((loss[labels == IGNORE] != 0).any()):
        fail(f"fused CE {label}: an ignored row has a non-zero loss")
    return errs, want_lse, (want_loss, want_dx, want_dw)


def fce_library_ms(torch, fc, ins, eps, wants, flush, tol=True):
    """The library yardstick: the composed head in two calls (a matmul in
    the operands' dtype and F.cross_entropy on its fp32 logits) and their
    autograd backward, held to the plain versions (``wants``: loss, dx,
    dW) first where ``tol``; their times by kernel."""
    import torch.nn.functional as F
    x, w, labels, g = ins
    xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
    lab64 = labels.long()

    def lib_fwd():
        return F.cross_entropy((xr @ wr).float(), lab64, reduction="none",
                               label_smoothing=eps, ignore_index=IGNORE)
    lib_loss = lib_fwd()
    lib_dx, lib_dw = torch.autograd.grad(lib_loss, (xr, wr), g,
                                         retain_graph=True)
    for name, got, want, t in zip(
            ("loss", "dx", "dw"), (lib_loss, lib_dx, lib_dw), wants,
            (FCE_FWD_TOL, FCE_GRAD_TOL, FCE_GRAD_TOL)):
        if tol and not torch.allclose(got, want, **t):
            fail(f"fused CE: the library yardstick's {name} differs from "
                 f"the plain version (max abs err "
                 f"{float((got - want).abs().max())})")
    del lib_dx, lib_dw

    def lib_bwd():
        return torch.autograd.grad(lib_loss, (xr, wr), g, retain_graph=True)
    return {"fused_ce_fwd": time_ms(torch, lib_fwd, flush, n=20),
            "fused_ce_bwd": time_ms(torch, lib_bwd, flush, n=20)}


def fce_rows(torch, fc, card, ins, eps, errs, edge_errs, lse, flush,
             lib_ms=None, n=20, warm=5):
    """The fused-CE kernels at one shape timed beside plain, both bounds,
    the prep kernel's share and (``lib_ms``) library, with the errors of
    :func:`fce_check` there and at its edge shape."""
    x, w, labels, g = ins
    (nn, d), v = x.shape, w.shape[1]
    dtype_name = str(x.dtype).split(".")[-1]
    runs = {"fused_ce_fwd": (
                lambda: fc.fused_ce_fwd(x, w, labels, eps),
                lambda: fc.fused_ce_fwd_ref(x, w, labels, eps),
                lambda: (fc.prepare(x, False), fc.prepare(w, True)),
                ("loss", "lse")),
            "fused_ce_bwd": (
                lambda: fc.fused_ce_bwd(x, w, labels, lse, g, eps),
                lambda: fc.fused_ce_bwd_ref(x, w, labels, lse, g, eps),
                lambda: (fc.prepare(x, False), fc.prepare(w, True),
                         fc.prepare(w, False), fc.prepare(x, True)),
                ("dx", "dw"))}
    cost = fce_cost(nn, d, v, x.element_size())
    rows = {}
    for kname, (fn, ref, prep, outs) in runs.items():
        flops, nbytes = cost[kname]
        bound_ms, bound_by, simt_ms = fce_bounds(flops, nbytes, dtype_name)
        row = rows[kname] = {
            "max_abs_err": max(errs[o] for o in outs),
            "edge_max_abs_err": max(edge_errs[o] for o in outs),
            "ms": time_ms(torch, fn, flush, n=n, warm=warm),
            "plain_ms": time_ms(torch, ref, flush, n=n, warm=warm),
            "prep_ms": time_ms(torch, prep, flush, n=n, warm=warm),
            "library_ms": lib_ms[kname] if lib_ms else None,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "simt_bound_ms": simt_ms, "flops": flops, "bytes": nbytes,
            "dtype": dtype_name}
        lib = (f", library {row['library_ms']:.3f} ms" if lib_ms else "")
        print(f"[{card}] {kname} {dtype_name} [N {nn}, D {d}, V {v}]: max "
              f"abs err {row['max_abs_err']:.3g}; kernel {row['ms']:.3f} ms "
              f"(its operand copies {row['prep_ms']:.3f} ms), plain "
              f"{row['plain_ms']:.3f} ms{lib}, bound {bound_ms:.3f} ms "
              f"({bound_by}: {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} "
              f"MB; {simt_ms:.3f} ms at the fp32 SIMT rate)")
    return rows


def fce_mixed(torch, fc, dev, card, size, edge, eps, flush):
    """x and w of two dtypes (``FCE_MIXED``) at the edge shape and at
    ``size``: each kernel against its plain version, the gradients in
    x's and w's dtypes within :func:`fce_low_tol` at x's dtype, a second
    backward bit-equal; the head timed; then each pair through
    ``fused_linear_ce`` and autograd at the edge shape."""
    from paddle_tpu_torch.ops import nn_ops as tnn
    rows = {}
    for i, (xn, wn) in enumerate(FCE_MIXED):
        xdt, wdt = getattr(torch, xn), getattr(torch, wn)
        label = f"{xn}/{wn}"
        for sz, seed in ((edge, 60 + i), (size, 70 + i)):
            x, w, labels, g = fce_inputs(torch, dev, *sz, seed)
            x, w = x.to(xdt), w.to(wdt)
            loss, lse = fc.fused_ce_fwd(x, w, labels, eps)
            want_loss, want_lse = fc.fused_ce_fwd_ref(x, w, labels, eps)
            dx, dw = fc.fused_ce_bwd(x, w, labels, want_lse, g, eps)
            want_dx, want_dw = fc.fused_ce_bwd_ref(x, w, labels, want_lse, g,
                                                   eps)
            again = fc.fused_ce_bwd(x, w, labels, want_lse, g, eps)
            torch.cuda.synchronize()
            where = f"fused CE {label} N {sz[0]} D {sz[1]} V {sz[2]}"
            errs = {}
            for name, got, want in (("loss", loss, want_loss),
                                    ("lse", lse, want_lse)):
                errs[name] = float((got - want).abs().max())
                if not close(got, want, FCE_FWD_TOL):
                    fail(f"{where}: {name} differs from the plain version "
                         f"(max abs err {errs[name]})")
            if dx.dtype != xdt or dw.dtype != wdt:
                fail(f"{where}: gradients in {dx.dtype} / {dw.dtype}")
            sx, sw = fce_low_tol(torch, fc, x, w, labels, want_lse, g, eps)
            for name, got, want, sl in (("dx", dx, want_dx, sx),
                                        ("dw", dw, want_dw, sw)):
                ok, errs[name] = fce_within(torch, got, want, sl)
                if not ok:
                    fail(f"{where}: {name} differs from the plain version "
                         f"(max abs err {errs[name]})")
            if not (torch.equal(again[0], dx) and torch.equal(again[1], dw)):
                fail(f"{where}: a second backward gave other bits")
            del want_dx, want_dw, again
        row = rows[label] = {
            "max_abs_err": errs,
            "fwd_ms": time_ms(torch, lambda: fc.fused_ce_fwd(
                x, w, labels, eps), flush, n=5, warm=1),
            "bwd_ms": time_ms(torch, lambda: fc.fused_ce_bwd(
                x, w, labels, lse, g, eps), flush, n=5, warm=1)}
        xe, we, labe, ge = fce_inputs(torch, dev, *edge, 80 + i)
        xe = xe.to(xdt).requires_grad_()
        we = we.to(wdt).requires_grad_()
        out = tnn.fused_linear_ce(xe, we, labe[:, None], eps)
        out[:, 0].backward(ge)
        want_loss, want_lse = fc.fused_ce_fwd_ref(xe.detach(), we.detach(),
                                                  labe, eps)
        want_dx, want_dw = fc.fused_ce_bwd_ref(xe.detach(), we.detach(), labe,
                                               want_lse, ge, eps)
        sx, sw = fce_low_tol(torch, fc, xe.detach(), we.detach(), labe,
                             want_lse, ge, eps)
        if not (close(out[:, 0].detach(), want_loss, FCE_FWD_TOL)
                and fce_within(torch, xe.grad, want_dx, sx)[0]
                and fce_within(torch, we.grad, want_dw, sw)[0]
                and xe.grad.dtype == xdt and we.grad.dtype == wdt):
            fail(f"fused CE {label}: fused_linear_ce's autograd differs from "
                 f"the plain versions")
        print(f"[{card}] fused CE x {xn}, w {wn} [N {size[0]}, D {size[1]}, "
              f"V {size[2]}]: max abs err "
              + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
              + f"; forward {row['fwd_ms']:.3f} ms, backward "
              f"{row['bwd_ms']:.3f} ms (the fp32 path over the widened "
              f"operands); fused_linear_ce and its backward match at the "
              f"edge shape")
    return rows


def fused_ce_phase(torch, dev, card, n=BATCH * TRAIN["max_len"],
                   d=TRAIN["d_model"], v=TRAIN["tgt_vocab"], edge=FCE_EDGE,
                   wide=FCE_WIDE, wide_edge=FCE_WIDE_EDGE):
    """The fused-CE kernels against their plain versions at the head of
    the training slice and at an edge shape, fp32, then timed beside
    plain, both bounds, their operand copies and library; the same in
    bf16 (its own library yardstick); the smallest input that raised
    before (x [1, 513]); and ``transformer_big``'s head (``wide``, timed
    beside plain and bound) with its edge shape."""
    from paddle_tpu_torch.ops.kernels import fused_ce as fc
    eps = 0.1
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def shape(size, edge_size, seeds, lib=False, n_time=20, warm=5,
              dtype=None):
        edge_errs, _, _ = fce_check(
            torch, fc, *fce_inputs(torch, dev, *edge_size, seeds[0], dtype),
            eps, "edge N {} D {} V {}".format(*edge_size))
        print(f"[{card}] fused CE edge shape N {edge_size[0]} D "
              f"{edge_size[1]} V {edge_size[2]} ({dtype or torch.float32}): "
              f"max abs err "
              + ", ".join(f"{k} {e:.3g}" for k, e in edge_errs.items()))
        ins = fce_inputs(torch, dev, *size, seeds[1], dtype)
        errs, lse, wants = fce_check(torch, fc, *ins, eps,
                                     "N {} D {} V {}".format(*size))
        lib_ms = fce_library_ms(torch, fc, ins, eps, wants, flush,
                                tol=dtype is None) if lib else None
        del wants
        return fce_rows(torch, fc, card, ins, eps, errs, edge_errs, lse,
                        flush, lib_ms, n=n_time, warm=warm)

    results = shape((n, d, v), edge, (8, 9), lib=True)
    print(f"[{card}] fused CE: two calls of each kernel gave the same bits "
          f"at every shape checked")
    for kname, row in shape((n, d, v), edge, (12, 13), lib=True,
                            dtype=torch.bfloat16).items():
        results[f"{kname}/bf16"] = row

    x1 = torch.randn(1, 513, device=dev)
    w1 = torch.randn(513, 2, device=dev) * 513 ** -0.5
    lab1 = torch.zeros(1, dtype=torch.long, device=dev)
    got1 = fc.fused_linear_ce(x1, w1, lab1)[:, 0]
    want1 = fc.fused_ce_fwd_ref(x1, w1, lab1)[0]
    torch.cuda.synchronize()
    if not close(got1, want1, FCE_FWD_TOL):
        fail(f"fused CE x [1, 513]: loss {got1.tolist()}, plain "
             f"{want1.tolist()}")
    print(f"[{card}] fused CE x [1, 513] (raised before): loss "
          f"{float(got1[0]):.6f}, plain {float(want1[0]):.6f}")
    for kname, row in shape(wide, wide_edge, (10, 11), n_time=5,
                            warm=1).items():
        results[f"{kname}/d{wide[1]}"] = row
    results["mixed"] = fce_mixed(torch, fc, dev, card, (n, d, v), edge, eps,
                                 flush)
    del flush
    return results


# -- phase 7: training ------------------------------------------------------

def transformer_weights(model, seed: int) -> dict:
    """Seeded weights for every parameter of ``model``, by state key:
    embeddings and matrices N(0, fan_in**-0.5), layer-norm scales 1,
    biases 0."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, p in model.state_dict().items():
        shape = tuple(p.shape)
        if key.endswith("_scale"):
            out[key] = np.ones(shape, np.float32)
        elif len(shape) == 1:
            out[key] = np.zeros(shape, np.float32)
        else:
            fan_in = shape[1] if key.endswith("_emb") else shape[0]
            out[key] = rng.normal(0.0, fan_in ** -0.5, shape).astype(
                np.float32)
    return out


def copy_task(torch, dev, seed: int, steps: int, b: int, t: int, vocab: int):
    """Per step (src, tgt, lbl) [B, T, 1] int64 on the device: src random
    tokens, tgt = src shifted right behind a start token 1, lbl = src."""
    rng = np.random.RandomState(seed)
    feeds = []
    for _ in range(steps):
        src = rng.randint(3, vocab, (b, t))
        tgt = np.concatenate([np.ones((b, 1), np.int64), src[:, :-1]], 1)
        feeds.append(tuple(torch.from_numpy(x[:, :, None].astype(np.int64))
                           .to(dev) for x in (src, tgt, src)))
    return feeds


def train(torch, model, opt, feeds, launches=None):
    """One optimizer step per feed (the model returns its loss, or a tuple
    that starts with it); returns the losses, each step's host
    time (ending in a synchronize) and, with ``launches`` (a function
    returning the kernels' launch counts), each step's launches."""
    losses, step_ms, per_step = [], [], []
    for feed in feeds:
        before = launches() if launches is not None else None
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        out = model(*feed)
        loss = out[0] if isinstance(out, tuple) else out
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.detach()))
        if launches is not None:
            after = launches()
            per_step.append({k: after[k] - before[k] for k in after})
    return losses, step_ms, per_step


def profile_window(torch, model, opt, feeds):
    """:func:`profile_calls` over training steps on ``feeds``."""
    return profile_calls(torch, lambda: train(torch, model, opt, feeds),
                         len(feeds))


def profile_calls(torch, work, n):
    """(device busy ms per step, idle share, the flash, fused-CE,
    recurrent (LSTM or GRU loops and their products) and pooling kernels'
    shares of device time, the library's conv and GEMM kernels' share
    (``CONV_MARKS``), host ms per step) over a torch.profiler window of
    ``work()``, which does ``n`` steps and ends in a synchronize."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events only: a user annotation (Optimizer.step#Adam.step)
    # also carries device time, the sum of the kernels under it
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0
               and not getattr(ev, "is_user_annotation", False)
               and not ev.key.startswith("Optimizer.")]
    busy_us = sum(ev.self_device_time_total for ev in kernels)
    flash_us = sum(ev.self_device_time_total for ev in kernels
                   if "flash_" in ev.key)
    fce_us = sum(ev.self_device_time_total for ev in kernels
                 if "fused_ce_" in ev.key)
    rnn_us = sum(ev.self_device_time_total for ev in kernels
                 if any(k in ev.key for k in ("lstm_", "gru_", "rnn_")))
    pool_us = sum(ev.self_device_time_total for ev in kernels
                  if "seqpool" in ev.key or "embed_pool" in ev.key)
    conv_us = sum(ev.self_device_time_total for ev in kernels
                  if any(m in ev.key.lower() for m in CONV_MARKS))
    top = sorted(kernels, key=lambda ev: -ev.self_device_time_total)[:8]
    families = {}
    for ev in kernels:
        name = kernel_family(ev.key)
        if name:
            us, count = families.get(name, (0.0, 0.0))
            families[name] = (us + ev.self_device_time_total / n,
                              count + ev.count / n)
    return {"device_busy_ms_per_step": busy_us / n / 1e3,
            "host_ms_per_step": wall_ms / n,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms if wall_ms else None,
            "flash_share": flash_us / busy_us if busy_us else 0.0,
            "fused_ce_share": fce_us / busy_us if busy_us else 0.0,
            "rnn_share": rnn_us / busy_us if busy_us else 0.0,
            "pool_share": pool_us / busy_us if busy_us else 0.0,
            "conv_gemm_share": conv_us / busy_us if busy_us else 0.0,
            "launches_per_step": sum(ev.count for ev in kernels) / n,
            "families": families,
            "top_kernels": [(ev.key[:80], ev.self_device_time_total / n,
                             ev.count / n) for ev in top]}


# the port's kernels by profiler name: (family, what the name holds (one
# string, or several that it holds all), what it must not hold); the bf16
# instantiations (tc::BF16, Bf16) before the families that take any dtype
KERNEL_FAMILIES = (
    ("flash_fwd bf16", ("tc::flash_fwd_kernel", "BF16"), None),
    ("flash_bwd bf16", ("flash_bwd_kernel", "BF16"), None),
    ("fused_ce_fwd bf16", ("fused_ce_fwd_kernel", "Bf16"), None),
    ("fused_ce_dz bf16", ("fused_ce_dz_kernel", "Bf16"), None),
    ("fused_ce_fwd", "fused_ce_fwd_kernel", None),
    ("fused_ce_dz", "fused_ce_dz_kernel", None),
    ("flash_fwd tensor cores", "tc::flash_fwd_kernel", None),
    ("flash_fwd SIMT", "flash_fwd_kernel", "tc::"),
    ("flash_bwd", "flash_bwd_kernel", None),
    ("flash_dq", "flash_dq_kernel", None),
    ("flash_dkv", "flash_dkv_kernel", None),
    ("lstm_fwd cluster", "lstm_fwd_cluster_kernel", None),
    ("lstm_fwd grid", "lstm_fwd_kernel", None),
    ("lstm_bwd cluster", "lstm_bwd_cluster_kernel", None),
    ("lstm_bwd grid", "lstm_bwd_kernel", None),
    ("gru_fwd cluster", "gru_fwd_cluster_kernel", None),
    ("gru_fwd grid", "gru_fwd_kernel", None),
    ("gru_bwd cluster", "gru_bwd_cluster_kernel", None),
    ("gru_bwd grid", "gru_bwd_kernel", None),
    ("rnn_gemm", "rnn_gemm_kernel", None),
    ("rnn_dw", "rnn_dw_kernel", None),
    ("cache_gather", "cache_gather_kernel", None),
    ("cache_scatter", "cache_scatter_kernel", None))


def kernel_family(key):
    """The family of KERNEL_FAMILIES a profiler kernel name belongs to, or
    None."""
    for name, has, lacks in KERNEL_FAMILIES:
        has = (has,) if isinstance(has, str) else has
        if all(h in key for h in has) and (lacks is None or lacks not in key):
            return name
    return None


def named_launches(torch, work, counters):
    """(kernels by KERNEL_FAMILIES name in a profiler window of one call of
    ``work``, the launches that call added to each ``counters[family]``,
    an ``all_launches`` key). A profiler window late in this script can
    lose kernel records (24 of 26 in one window on an H100), so the names
    are lower bounds of the counts."""
    before = all_launches()
    prof = profile_calls(torch, lambda: (work(), torch.cuda.synchronize()),
                         1)
    after = all_launches()
    want = {fam: after[key] - before[key] for fam, key in counters.items()}
    named = {fam: round(prof["families"].get(fam, (0.0, 0.0))[1])
             for fam in counters}
    return named, want


def family_line(prof, busy_key="device_busy_ms_per_step"):
    """The families' launches and device share a step, as printed."""
    busy = prof[busy_key] * 1e3
    return ", ".join(f"{name} {count:.0f} a step, {us:.1f} us "
                     f"({us / busy:.4f} of device time)"
                     for name, (us, count) in sorted(prof["families"]
                                                     .items()))


def check_families(label, prof, want):
    """Fail unless each family of ``want`` launched that many kernels a step
    in the profiler window (0: none)."""
    got = {name: round(prof["families"].get(name, (0.0, 0.0))[1], 3)
           for name in want}
    if got != {name: float(n) for name, n in want.items()}:
        fail(f"{label}: kernels a step by family {got}, want {want}")


def train_phase(torch, dev, card, cfg=None, batch=BATCH, steps=TRAIN_STEPS,
                profile_steps=PROFILE_STEPS):
    """The training slice: fused attention (the flash kernels), composed
    (the oracle) and fused attention with the fused head (the flash and
    fused-CE kernels) from the same weights, the first and the last under
    pure AMP too (the bf16 kernels), launch counts per step, an evaluation
    forward of each head, a dropout run, and the step-time and profiler
    numbers."""
    from paddle_tpu_torch.contrib.mixed_precision import rewrite_program_amp
    from paddle_tpu_torch.models import convert
    from paddle_tpu_torch.models.transformer import build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_ce as fc
    cfg = dict(TRAIN if cfg is None else cfg)
    n_attn = 3 * cfg["n_layer"]          # encoder, causal decoder, cross
    tokens = batch * cfg["max_len"]
    weights = None
    feeds = copy_task(torch, dev, 3, steps + profile_steps, batch,
                      cfg["max_len"], cfg["tgt_vocab"])

    def counts():
        return {**fa.LAUNCHES, **fc.LAUNCHES}

    def reset():
        fa.reset_launches()
        fc.reset_launches()

    def load(model, kw):
        names = convert.transformer_jax_names(
            cfg["n_layer"], kw["fused_attention"], kw.get("fused_head", False))
        model.load_state_dict(convert.transformer_params_from_jax(
            {names[key]: w for key, w in weights.items()}))

    slabs = -(-cfg["tgt_vocab"] // fc.SLAB_COLS)    # dz launches a backward
    runs, launched = {}, {}
    for label, kw in {**TRAIN_RUNS, **{k: v[1] for k, v in
                                       AMP_RUNS.items()}}.items():
        amp = label in AMP_RUNS
        head = kw.get("fused_head", False)
        model, opt = build(**cfg, dropout=0.0, device=dev, **kw)
        if weights is None:
            weights = transformer_weights(model, 1)
        load(model, kw)
        if amp:
            tagged = rewrite_program_amp(model)
            if not model.amp["lookup_table"].keep_bf16:
                fail(f"{label}: the rewrite did not pick pure mode")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        losses, step_ms, per_step = train(torch, model, opt, feeds[:steps],
                                          counts)
        launched[label] = counts()
        one = fa.bwd_kernel(cfg["max_len"],
                            cfg["d_model"] // cfg["n_head"]) == "flash_bwd"
        per_kernel = {"flash_fwd": n_attn, "flash_bwd": n_attn * one,
                      "flash_dq": n_attn * (not one),
                      "flash_dkv": n_attn * (not one)}
        want = {k: per_kernel[k] if kw["fused_attention"] else 0
                for k in fa.LAUNCHES}
        want.update({k: int(kw.get("fused_head", False))
                     for k in fc.LAUNCHES})
        for i, c in enumerate(per_step):
            if c != want:
                fail(f"{label}: step {i} launched {c}, want {want}")
        if not all(np.isfinite(losses)):
            fail(f"{label}: non-finite loss curve {losses}")
        stats = {"losses": losses, "step_ms": step_ms,
                 "step_p50_ms": float(np.median(step_ms)),
                 "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
                 "launches": launched[label]}
        if amp:
            stats["amp_sites_tagged"] = tagged
        stats["tokens_per_s"] = tokens / stats["step_p50_ms"] * 1e3
        if profile_steps:
            stats["profile"] = prof = profile_window(torch, model, opt,
                                                     feeds[steps:])
            # against the step time without the profiler's own overhead
            prof["idle_share_at_p50"] = 1.0 - prof[
                "device_busy_ms_per_step"] / stats["step_p50_ms"]
        runs[label] = stats
        prof = stats.get("profile", {})
        print(f"[{card}] {label}: losses "
              f"{[round(x, 5) for x in losses]}; step p50 "
              f"{stats['step_p50_ms']:.3f} ms = {stats['tokens_per_s']:.0f} "
              f"tokens/s; peak memory "
              f"{stats['peak_mem_bytes'] / 2 ** 20:.1f} MiB; launches "
              f"{launched[label]}")
        if prof:
            print(f"[{card}] {label} profile ({profile_steps} steps): host "
                  f"{prof['host_ms_per_step']:.3f} ms/step, device busy "
                  f"{prof['device_busy_ms_per_step']:.3f} ms/step, idle "
                  f"share {prof['idle_share']:.3f} "
                  f"({prof['idle_share_at_p50']:.3f} against the step "
                  f"p50), flash kernels {prof['flash_share']:.4f} and "
                  f"fused-CE kernels {prof['fused_ce_share']:.4f} of device "
                  f"time, {prof['launches_per_step']:.0f} launches/step")
            for key, us, count in prof["top_kernels"]:
                print(f"    {us:10.1f} us/step {count:6.1f}/step  {key}")
            if kw["fused_attention"]:
                tc = n_attn if fa.fwd_kernel(
                    cfg["d_model"] // cfg["n_head"]) == "tensor_cores" \
                    else 0
                bf16 = {"flash_fwd bf16": tc, "flash_bwd bf16": n_attn * one,
                        "fused_ce_fwd bf16": int(head),
                        "fused_ce_dz bf16": slabs * head}
                fp32 = {"flash_fwd tensor cores": tc,
                        "flash_bwd": n_attn * one,
                        "fused_ce_fwd": int(head),
                        "fused_ce_dz": slabs * head}
                check_families(label, prof, {
                    **{k: v * amp for k, v in bf16.items()},
                    **{k: v * (not amp) for k, v in fp32.items()}})
                print(f"[{card}] {label}: the flash and fused-CE kernels a "
                      f"step: {family_line(prof)}")
        del model, opt
    a = runs["fused_attention"]["losses"]
    for label in ("composed", "fused_head"):
        b = runs[label]["losses"]
        if not np.allclose(b, a, rtol=CURVE_RTOL, atol=0.0):
            fail(f"{label} and fused_attention loss curves differ beyond "
                 f"rtol {CURVE_RTOL}: {b} vs {a}")
        print(f"[{card}] the {label} curve matches the fused_attention one "
              f"within rtol {CURVE_RTOL} (max rel diff "
              f"{max(abs(x - y) / abs(y) for x, y in zip(b, a)):.3g})")
    print(f"[{card}] each fused step launched the flash forward and "
          f"backward {n_attn} times each ({launched['fused_attention']}); "
          f"each fused-head step the fused-CE forward and backward once "
          f"each")
    for label, (base, _) in AMP_RUNS.items():
        a = runs[label]["losses"][:AMP_CHECKED_STEPS]
        b = runs[base]["losses"][:AMP_CHECKED_STEPS]
        if not np.allclose(a, b, rtol=AMP_RTOL, atol=0.0):
            fail(f"{label}: first losses {a} differ from the fp32 run's "
                 f"{b} beyond rtol {AMP_RTOL}")
        gap = max(abs(x - y) / abs(y) for x, y in zip(a, b))
        runs[label]["fp32_max_rel_diff"] = gap
        amp_run, fp32_run = runs[label], runs[base]
        print(f"[{card}] {label}: first {AMP_CHECKED_STEPS} losses within "
              f"rtol {AMP_RTOL} of {base}'s (max rel diff {gap:.3g}); "
              f"{amp_run['amp_sites_tagged']} op sites tagged; step p50 "
              f"{amp_run['step_p50_ms']:.3f} ms against "
              f"{fp32_run['step_p50_ms']:.3f} ms fp32; peak memory "
              f"{amp_run['peak_mem_bytes'] / 2 ** 20:.1f} MiB against "
              f"{fp32_run['peak_mem_bytes'] / 2 ** 20:.1f} MiB")
    if profile_steps:
        busy = {label: runs[label]["profile"]["device_busy_ms_per_step"]
                for label in runs}
        idle = {label: runs[label]["profile"]["idle_share_at_p50"]
                for label in runs}
        print(f"[{card}] device busy a step: fused head "
              f"{busy['fused_head']:.3f} ms, composed head (fused attention) "
              f"{busy['fused_attention']:.3f} ms, composed attention and head "
              f"{busy['composed']:.3f} ms; pure AMP: fused head "
              f"{busy['amp_fused_head']:.3f} ms (idle "
              f"{idle['amp_fused_head']:.3f} at p50, fp32 "
              f"{idle['fused_head']:.3f}), composed head "
              f"{busy['amp_fused_attention']:.3f} ms (idle "
              f"{idle['amp_fused_attention']:.3f}, fp32 "
              f"{idle['fused_attention']:.3f})")

    # the evaluation model (no smoothing) of each head, one forward
    eval_loss = {}
    for head in (False, True):
        kw = dict(fused_attention=True, fused_head=head)
        model, _ = build(**cfg, is_train=False, device=dev, **kw)
        load(model, kw)
        reset()
        with torch.no_grad():
            eval_loss[head] = float(model(*feeds[0]))
        want = {"fused_ce_fwd": int(head), "fused_ce_bwd": 0}
        if dict(fc.LAUNCHES) != want:
            fail(f"evaluation fused_head={head}: launched {fc.LAUNCHES}, "
                 f"want {want}")
        del model
    if not np.isclose(eval_loss[True], eval_loss[False], rtol=EVAL_RTOL,
                      atol=0.0):
        fail(f"evaluation losses differ beyond rtol {EVAL_RTOL}: fused head "
             f"{eval_loss[True]}, unfused {eval_loss[False]}")
    runs["eval"] = {"fused_head": eval_loss[True],
                    "unfused": eval_loss[False]}
    print(f"[{card}] evaluation loss: fused head {eval_loss[True]:.7f}, "
          f"unfused {eval_loss[False]:.7f} (within rtol {EVAL_RTOL})")

    kw = dict(fused_attention=True)
    model, opt = build(**cfg, dropout=0.1, device=dev, **kw,
                       generator=torch.Generator().manual_seed(7))
    load(model, kw)
    # one batch seen again every step: the loss must fall through the
    # dropout noise (fresh batches of random tokens differ by more than
    # ten steps at lr 1e-4 gain)
    losses, step_ms, _ = train(torch, model, opt, feeds[:1] * steps)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"dropout 0.1: losses {losses} are not finite and falling")
    runs["dropout"] = {"losses": losses,
                       "step_p50_ms": float(np.median(step_ms))}
    print(f"[{card}] fused_attention=True dropout=0.1: losses "
          f"{[round(x, 5) for x in losses]}; step p50 "
          f"{runs['dropout']['step_p50_ms']:.3f} ms")
    if profile_steps:
        prof = runs["dropout"]["profile"] = profile_window(
            torch, model, opt, feeds[:1] * profile_steps)
        print(f"[{card}] dropout=0.1 profile ({profile_steps} steps): "
              f"device busy {prof['device_busy_ms_per_step']:.3f} ms/step, "
              f"flash kernels {prof['flash_share']:.4f} of device time, "
              f"{prof['launches_per_step']:.0f} launches/step")
        for key, us, count in prof["top_kernels"]:
            print(f"    {us:10.1f} us/step {count:6.1f}/step  {key}")
    return launched, n_attn, runs


# -- phase 8: LSTM kernels --------------------------------------------------

def lstm_cost(t, b, h, lens_sum):
    """(FLOPs, bytes) of the LSTM forward and backward kernels: one
    [1, H] x [H, 4H] product per live (row, step) pair in the forward and
    three in the backward (the recompute, dgates @ w^T, h_prev^T @
    dgates), ``lens_sum`` pairs in all; each input read once, each output
    written once."""
    seq, state, x = t * b * h * 4, b * h * 4, t * b * 4 * h * 4
    small = h * 4 * h * 4 + 3 * h * 4 + b * 4 + 2 * state   # w peep lens h0 c0
    step = 2 * h * 4 * h
    return {"lstm_train_fwd": (step * lens_sum,
                               x + small + 2 * seq + 2 * state),
            "lstm_train_bwd": (3 * step * lens_sum,
                               x + small + 4 * seq + 2 * state
                               + x + h * 4 * h * 4 + 3 * h * 4 + 2 * state)}


def lstm_inputs(torch, dev, t, b, h, seed):
    """Seeded inputs of the LSTM kernels and cotangents of their four
    outputs. The recurrent weight is scaled by min(0.2, H**-0.5): at 0.2
    and H 512 the recurrence is chaotic, and over 100 steps a last-bit
    difference between two correct implementations grows to order 1."""
    rng = np.random.RandomState(seed)

    def normal(shape, scale):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).to(dev)
    lens = rng.randint(1, t + 1, size=b).astype(np.int32)
    lens[0] = t                                # at least one full row
    ins = (normal((t, b, 4 * h), 0.4), normal((h, 4 * h), min(0.2, h ** -0.5)),
           normal((1, 3 * h), 0.1), torch.from_numpy(lens).to(dev),
           normal((b, h), 0.3), normal((b, h), 0.3))
    cot = (normal((t, b, h), 0.1), normal((t, b, h), 0.1),
           normal((b, h), 1.0), normal((b, h), 1.0))
    return ins, cot, int(lens.sum())


def plain_cell_loop(torch, xproj, w, h, c):
    """The LSTM cell without peepholes or lengths, step by step."""
    hs, cs, hdim = [], [], w.shape[0]
    for xt in xproj:
        gates = xt + h @ w
        i, f = (torch.sigmoid(gates[:, k * hdim:(k + 1) * hdim])
                for k in (0, 1))
        c = f * c + i * torch.tanh(gates[:, 2 * hdim:3 * hdim])
        h = torch.sigmoid(gates[:, 3 * hdim:]) * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs), h, c


def lstm_check(torch, fr, ins, cot, label):
    """Each kernel against its plain version, the zeroed tail, the
    peephole-free reduction and the backward's repeatability; returns the
    max abs errors and the plain outputs."""
    xproj, w, peep, lens, h0, c0 = ins
    t = xproj.shape[0]
    got = fr.lstm_train_fwd(*ins)
    want = fr.lstm_train_fwd_plain(*ins)
    back = fr.lstm_train_bwd(*ins, want[0], want[1], *cot)
    again = fr.lstm_train_bwd(*ins, want[0], want[1], *cot)
    want_back = fr.lstm_train_bwd_plain(*ins, want[0], want[1], *cot)
    torch.cuda.synchronize()
    errs = {}
    names = ("hidden", "cell", "h_last", "c_last", "dx", "dw", "dpeep",
             "dh0", "dc0")
    for i, (name, a, b) in enumerate(zip(names, got + back,
                                         tuple(want) + tuple(want_back))):
        tol = LSTM_FWD_TOL if i < 4 else LSTM_GRAD_TOL
        errs[name] = float((a - b).abs().max())
        if a.shape != b.shape or not close(a, b, tol):
            fail(f"LSTM {label}: {name} differs from the plain version "
                 f"(max abs err {errs[name]}, tolerance {tol})")
    past = (torch.arange(t, device=lens.device)[:, None]
            >= lens[None, :])[:, :, None]
    for name, seq in (("hidden", got[0]), ("cell", got[1])):
        if bool((seq.masked_select(past) != 0).any()):
            fail(f"LSTM {label}: {name} is not 0 past a row's length")
    for name, a, b in zip(names[4:], back, again):
        if not torch.equal(a, b):
            fail(f"LSTM {label}: two runs of the backward give other bits "
                 f"in {name}")
    full = torch.full_like(lens, t)
    free = fr.lstm_train_fwd(xproj, w, torch.zeros_like(peep), full, h0, c0)
    for name, a, b in zip(names[:4], free,
                          plain_cell_loop(torch, xproj, w, h0, c0)):
        if not close(a, b, LSTM_FWD_TOL):
            fail(f"LSTM {label}: zero peepholes and full lengths differ "
                 f"from the peephole-free cell in {name} (max abs err "
                 f"{float((a - b).abs().max())})")
    return errs, want


# -- phase 9: LSTM training -------------------------------------------------

def lstm_weights(model, seed: int) -> dict:
    """Seeded weights for every parameter of ``model``, by state key:
    matrices and the table N(0, fan_in**-0.5), gate biases 0, peepholes
    (the last 3H of each LSTM bias) N(0, 0.1) so that they are live."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, p in model.state_dict().items():
        shape = tuple(p.shape)
        if key.endswith("lstm_b"):
            hid = shape[1] // 7
            out[key] = np.concatenate(
                [np.zeros((1, 4 * hid)), rng.normal(0, 0.1, (1, 3 * hid))],
                axis=1).astype(np.float32)
        elif len(shape) == 1:
            out[key] = np.zeros(shape, np.float32)
        else:
            fan_in = shape[1] if key == "emb" else shape[0]
            out[key] = rng.normal(0.0, fan_in ** -0.5, shape).astype(
                np.float32)
    return out


def lstm_batch(seed: int, b: int, t: int, vocab: int):
    """(words [B,T] int64, seq_lens [B] int32, label [B,1] int64) from
    numpy: ragged lengths 1..T with one full row; the label says whether
    most of a row's valid words lie in the upper half of the vocabulary."""
    rng = np.random.RandomState(seed)
    words = rng.randint(0, vocab, (b, t)).astype(np.int64)
    lens = rng.randint(1, t + 1, b).astype(np.int32)
    lens[0] = t
    valid = np.arange(t)[None, :] < lens[:, None]
    upper = ((words >= vocab // 2) & valid).sum(1)
    label = (2 * upper > lens).astype(np.int64)[:, None]
    return words, lens, label


def lstm_train_phase(torch, dev, card, cfg=None, batch=LSTM_BATCH,
                     steps=TRAIN_STEPS, profile_steps=PROFILE_STEPS,
                     oracle_steps=LSTM_ORACLE_STEPS):
    """The LSTM training slice on the card, its launch counts per step,
    the same steps under conservative AMP, the CPU oracle over the first
    steps, and the step-time and profiler numbers."""
    from paddle_tpu_torch.models import convert
    from paddle_tpu_torch.models.stacked_dynamic_lstm import build
    from paddle_tpu_torch.ops.kernels import fused_rnn as fr
    cfg = dict(LSTM if cfg is None else cfg)
    n_layer = cfg["stacked_num"]
    names = convert.lstm_jax_names(n_layer)
    arrays = lstm_batch(4, batch, cfg["max_len"], cfg["dict_dim"])
    lens_sum = int(arrays[1].sum())

    def make(device):
        model, opt, _ = build(**cfg, device=device)
        return model, opt

    model, opt = make(dev)
    weights = lstm_weights(model, 5)
    state = convert.lstm_params_from_jax(
        {names[key]: w for key, w in weights.items()}, n_layer)
    model.load_state_dict(state)
    feed = tuple(torch.from_numpy(a).to(dev) for a in arrays)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fr.reset_launches()
    losses, step_ms, per_step = train(torch, model, opt, [feed] * steps,
                                      lambda: dict(fr.LAUNCHES))
    launched = dict(fr.LAUNCHES)
    want = {k: n_layer if k.startswith("lstm_") else 0 for k in fr.LAUNCHES}
    for i, c in enumerate(per_step):
        if c != want:
            fail(f"LSTM training: step {i} launched {c}, want {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"LSTM training: losses {losses} are not finite and falling")
    stats = {"losses": losses, "step_ms": step_ms,
             "step_p50_ms": float(np.median(step_ms)),
             "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
             "launches": launched, "valid_words": lens_sum,
             "padded_words": batch * cfg["max_len"]}
    stats["words_per_s"] = lens_sum / stats["step_p50_ms"] * 1e3
    stats["padded_words_per_s"] = stats["padded_words"] \
        / stats["step_p50_ms"] * 1e3
    print(f"[{card}] stacked_dynamic_lstm: losses "
          f"{[round(x, 5) for x in losses]}; step p50 "
          f"{stats['step_p50_ms']:.3f} ms = {stats['words_per_s']:.0f} "
          f"words/s ({lens_sum} valid words a step; "
          f"{stats['padded_words_per_s']:.0f} padded positions/s); peak "
          f"memory {stats['peak_mem_bytes'] / 2 ** 20:.1f} MiB; launches "
          f"{launched} ({n_layer} of each per step)")
    if profile_steps:
        stats["profile"] = prof = profile_window(torch, model, opt,
                                                 [feed] * profile_steps)
        prof["idle_share_at_p50"] = 1.0 - prof[
            "device_busy_ms_per_step"] / stats["step_p50_ms"]
        print(f"[{card}] stacked_dynamic_lstm profile ({profile_steps} "
              f"steps): host {prof['host_ms_per_step']:.3f} ms/step, device "
              f"busy {prof['device_busy_ms_per_step']:.3f} ms/step, idle "
              f"share {prof['idle_share']:.3f} "
              f"({prof['idle_share_at_p50']:.3f} against the step p50), "
              f"LSTM kernels {prof['rnn_share']:.4f} of device time, "
              f"{prof['launches_per_step']:.0f} launches/step")
        for key, us, count in prof["top_kernels"]:
            print(f"    {us:10.1f} us/step {count:6.1f}/step  {key}")
        plans = {k: fr.rnn_kernel_for(k, cfg["hid_dim"], dev)["kernel"]
                 for k in ("lstm_train_fwd", "lstm_train_bwd")}
        check_families("LSTM training", prof, {
            f"lstm_{k[11:]} {plans[k]}": n_layer for k in plans})
        print(f"[{card}] stacked_dynamic_lstm: the LSTM kernels a step: "
              f"{family_line(prof)}")
    del model, opt
    stats["amp"] = amp_lstm_run(torch, card, make, state, feed, steps,
                                profile_steps, stats, want, n_layer)

    # the oracle: the same model on the CPU, where the wrappers take the
    # plain versions, from the same weights on the same feeds
    t0 = time.perf_counter()
    before = dict(fr.LAUNCHES)
    oracle, oracle_opt = make("cpu")
    oracle.load_state_dict(state)
    cpu_feed = tuple(torch.from_numpy(a) for a in arrays)
    want_losses = []
    for _ in range(oracle_steps):
        oracle_opt.zero_grad(set_to_none=True)
        loss, _ = oracle(*cpu_feed)
        loss.backward()
        oracle_opt.step()
        want_losses.append(float(loss.detach()))
    if dict(fr.LAUNCHES) != before:
        fail("LSTM training: the CPU oracle launched a kernel")
    if not np.allclose(losses[:oracle_steps], want_losses, rtol=CURVE_RTOL,
                       atol=0.0):
        fail(f"LSTM training: losses {losses[:oracle_steps]} differ from "
             f"the CPU oracle's {want_losses} beyond rtol {CURVE_RTOL}")
    gap = max(abs(x - y) / abs(y)
              for x, y in zip(losses[:oracle_steps], want_losses))
    stats["oracle_losses"] = want_losses
    stats["oracle_max_rel_diff"] = gap
    print(f"[{card}] stacked_dynamic_lstm: the first {oracle_steps} losses "
          f"match the CPU oracle's within rtol {CURVE_RTOL} (max rel diff "
          f"{gap:.3g}; oracle took {time.perf_counter() - t0:.1f} s)")
    return launched, n_layer, stats


def amp_lstm_run(torch, card, make, state, feed, steps, profile_steps,
                 fp32, want, n_layer):
    """Phase 9 under ``rewrite_program_amp(pure=None)``: conservative mode
    for a model with LSTMs (bf16 products, fp32 LSTM kernels); its
    launches a step, first losses against the fp32 run's and the same
    numbers beside fp32's."""
    from paddle_tpu_torch.contrib.mixed_precision import rewrite_program_amp
    from paddle_tpu_torch.ops.kernels import fused_rnn as fr
    model, opt = make(feed[0].device)
    model.load_state_dict(state)
    tagged = rewrite_program_amp(model)
    if any(t.keep_bf16 for t in model.amp.values()) \
            or not model.amp["mul"].bf16:
        fail(f"LSTM training AMP: not conservative mode: {model.amp}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fr.reset_launches()
    losses, step_ms, per_step = train(torch, model, opt, [feed] * steps,
                                      lambda: dict(fr.LAUNCHES))
    for i, c in enumerate(per_step):
        if c != want:
            fail(f"LSTM training AMP: step {i} launched {c}, want {want}")
    a, b = losses[:AMP_CHECKED_STEPS], fp32["losses"][:AMP_CHECKED_STEPS]
    if not all(np.isfinite(losses)) or not np.allclose(
            a, b, rtol=AMP_RTOL, atol=0.0):
        fail(f"LSTM training AMP: losses {losses} not finite or beyond "
             f"rtol {AMP_RTOL} of the fp32 run's {b}")
    run = {"losses": losses, "step_ms": step_ms,
           "step_p50_ms": float(np.median(step_ms)),
           "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
           "launches": dict(fr.LAUNCHES), "amp_sites_tagged": tagged,
           "fp32_max_rel_diff": max(abs(x - y) / abs(y)
                                    for x, y in zip(a, b))}
    run["words_per_s"] = fp32["valid_words"] / run["step_p50_ms"] * 1e3
    line = ""
    if profile_steps:
        run["profile"] = prof = profile_window(torch, model, opt,
                                               [feed] * profile_steps)
        prof["idle_share_at_p50"] = 1.0 - prof[
            "device_busy_ms_per_step"] / run["step_p50_ms"]
        plans = {k: fr.rnn_kernel_for(k, model.hid_dim,
                                      feed[0].device)["kernel"]
                 for k in ("lstm_train_fwd", "lstm_train_bwd")}
        check_families("LSTM training AMP", prof, {
            f"lstm_{k[11:]} {plans[k]}": n_layer for k in plans})
        base = fp32["profile"]
        line = (f"; device busy {prof['device_busy_ms_per_step']:.3f} ms a "
                f"step against {base['device_busy_ms_per_step']:.3f} fp32, "
                f"idle share {prof['idle_share_at_p50']:.3f} against "
                f"{base['idle_share_at_p50']:.3f} at p50; the LSTM kernels "
                f"a step: {family_line(prof)}")
        for key, us, count in prof["top_kernels"]:
            print(f"    {us:10.1f} us/step {count:6.1f}/step  {key}")
    print(f"[{card}] stacked_dynamic_lstm under conservative AMP ({tagged} "
          f"op sites tagged): losses {[round(x, 5) for x in losses]}, the "
          f"first {AMP_CHECKED_STEPS} within rtol {AMP_RTOL} of fp32's (max "
          f"rel diff {run['fp32_max_rel_diff']:.3g}); step p50 "
          f"{run['step_p50_ms']:.3f} ms against {fp32['step_p50_ms']:.3f} "
          f"fp32; peak memory {run['peak_mem_bytes'] / 2 ** 20:.1f} MiB "
          f"against {fp32['peak_mem_bytes'] / 2 ** 20:.1f}{line}")
    return run


# -- phase 10: GRU kernels --------------------------------------------------

def gru_cost(t, b, h, lens_sum):
    """(FLOPs, bytes) of the GRU forward and backward: per live (row, step)
    pair the forward's [1, H] x [H, 3H] products (6 H^2), the backward's
    recompute (6 H^2), d_rh (2 H^2), Dh (4 H^2) and dw (6 H^2); each input
    read once, each output written once."""
    seq, state, x = t * b * h * 4, b * h * 4, t * b * 3 * h * 4
    w_b = h * 3 * h * 4
    return {"gru_train_fwd": (6 * h * h * lens_sum,
                              x + w_b + b * 4 + state + 2 * seq + state),
            "gru_train_bwd": (18 * h * h * lens_sum,
                              x + w_b + b * 4 + state + 3 * seq + state
                              + x + w_b + state)}


def gru_inputs(torch, dev, t, b, h, seed):
    """Seeded inputs of the GRU kernels (``w`` x H**-0.5, as for the LSTM)
    and non-uniform cotangents of both outputs."""
    rng = np.random.RandomState(seed)

    def normal(shape, scale):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).to(dev)
    lens = rng.randint(1, t + 1, size=b).astype(np.int32)
    lens[0] = t                                # at least one full row
    ins = (normal((t, b, 3 * h), 0.4), normal((h, 3 * h), min(0.2, h ** -0.5)),
           torch.from_numpy(lens).to(dev), normal((b, h), 0.3))
    cot = (normal((t, b, h), 0.1), normal((b, h), 1.0))
    return ins, cot, int(lens.sum())


def gru_check(torch, fr, ins, cot, label):
    """Each kernel against its plain version, the zeroed tail and the
    backward's repeatability; returns the max abs errors and the plain
    forward's outputs."""
    t, lens = ins[0].shape[0], ins[2]
    got = fr.gru_train_fwd(*ins)
    want = fr.gru_train_fwd_plain(*ins)
    back = fr.gru_train_bwd(*ins, want[0], want[2], *cot)
    again = fr.gru_train_bwd(*ins, want[0], want[2], *cot)
    want_back = fr.gru_train_bwd_plain(*ins, want[0], want[2], *cot)
    torch.cuda.synchronize()
    errs = {}
    names = ("hidden", "h_last", "rh", "dx", "dw", "dh0")
    for i, (name, a, b) in enumerate(zip(names, tuple(got) + tuple(back),
                                         tuple(want) + tuple(want_back))):
        tol = GRU_FWD_TOL if i < 3 else GRU_GRAD_TOL
        errs[name] = float((a - b).abs().max())
        if a.shape != b.shape or not close(a, b, tol):
            fail(f"GRU {label}: {name} differs from the plain version "
                 f"(max abs err {errs[name]}, tolerance {tol})")
    past = (torch.arange(t, device=lens.device)[:, None]
            >= lens[None, :])[:, :, None]
    if bool((got[0].masked_select(past) != 0).any()):
        fail(f"GRU {label}: hidden is not 0 past a row's length")
    for name, a, b in zip(names[3:], back, again):
        if not torch.equal(a, b):
            fail(f"GRU {label}: two runs of the backward give other bits "
                 f"in {name}")
    return errs, want


def rnn_kinds():
    """What differs between the LSTM's and the GRU's kernel checks."""
    return {
        "LSTM": dict(
            names=("lstm_train_fwd", "lstm_train_bwd"), inputs=lstm_inputs,
            check=lstm_check, cost=lstm_cost,
            outs=(("hidden", "cell", "h_last", "c_last"),
                  ("dx", "dw", "dpeep", "dh0", "dc0")),
            residuals=(0, 1), batched=(3, 4, 5), seeds=(12, 13),
            shape=(LSTM["max_len"], LSTM_BATCH, LSTM["hid_dim"]),
            edge=LSTM_EDGE, wide=LSTM_WIDE,
            serial="barrier, carry round trip and cell latency"),
        "GRU": dict(
            names=("gru_train_fwd", "gru_train_bwd"), inputs=gru_inputs,
            check=gru_check, cost=gru_cost,
            outs=(("hidden", "h_last", "rh"), ("dx", "dw", "dh0")),
            residuals=(0, 2), batched=(2, 3), seeds=(14, 15),
            shape=(MT["max_len"], MT_BATCH, MT["hid_dim"]), edge=GRU_EDGE,
            wide=GRU_WIDE,
            serial="two barriers, the state and r * h round trips and cell "
                   "latency")}


def rnn_rows(torch, fr, card, kind, ins, cot, want, errs, lens_sum, flush):
    """A recurrent pair at one shape timed beside plain and bound (no one
    PyTorch call computes either), with the errors of its check."""
    spec = rnn_kinds()[kind]
    (t, b), h = ins[0].shape[:2], ins[1].shape[0]
    res = tuple(want[i] for i in spec["residuals"])
    fwd, bwd = (getattr(fr, n) for n in spec["names"])
    fwd_plain, bwd_plain = (getattr(fr, n + "_plain") for n in spec["names"])
    cost = spec["cost"](t, b, h, lens_sum)
    dense = spec["cost"](t, b, h, t * b)
    rows = {}
    for kname, fn, ref, outs in (
            (spec["names"][0], lambda: fwd(*ins), lambda: fwd_plain(*ins),
             spec["outs"][0]),
            (spec["names"][1], lambda: bwd(*ins, *res, *cot),
             lambda: bwd_plain(*ins, *res, *cot), spec["outs"][1])):
        flops, nbytes = cost[kname]
        bound_ms, bound_by = bound_of(flops, nbytes)
        row = rows[kname] = {
            "max_abs_err": max(errs[o] for o in outs),
            "ms": time_ms(torch, fn, flush, n=20),
            "plain_ms": time_ms(torch, ref, flush, n=3, warm=1),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "flops": flops, "bytes": nbytes,
            "dense_bound_ms": bound_of(*dense[kname])[0],
            "live_steps": lens_sum, "steps": t * b}
        row["us_per_step"] = row["ms"] / t * 1e3
        if kname in ("lstm_train_fwd", "gru_train_fwd"):
            rnn_fwd_extras(torch, fr, card, row, fn, flops, nbytes, h, flush,
                           kname)
        if kname in ("lstm_train_bwd", "gru_train_bwd"):
            rnn_bwd_extras(torch, fr, card, row, fn, flops, nbytes, h, flush,
                           kname)
        print(f"[{card}] {kname} [T {t}, B {b}, H {h}]: max abs err "
              f"{row['max_abs_err']:.3g}; kernel {row['ms']:.3f} ms "
              f"({row['us_per_step']:.2f} us a step), plain "
              f"{row['plain_ms']:.3f} ms, no library call, bound "
              f"{row['bound_ms']:.3f} ms ({row['bound_by']}: "
              f"{flops / 1e9:.2f} GFLOP over the {lens_sum} live of "
              f"{t * b} (row, step) pairs, "
              f"{nbytes / 1e6:.1f} MB; all pairs {row['dense_bound_ms']:.3f} "
              f"ms)")
    return rows


def kernel_split(torch, fn, n=5):
    """Device ms a call of ``fn`` by kernel name, from a profiler window of
    ``n`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {ev.key: ev.self_device_time_total / n / 1e3
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0}


def cluster_against_grid(torch, fr, name, fn, h, tol, label):
    """The forward ``name`` (its cluster kernel at width h) run twice,
    bit-equal, and held to its grid kernel run in the same process (the
    plan emptied) within ``tol``; returns the max abs difference."""
    got, again = fn(), fn()
    key = (torch.cuda.current_device(), name, h)
    saved = fr._plans[key]
    fr._plans[key] = None                  # the grid kernel, this run
    try:
        grid = fn()
    finally:
        fr._plans[key] = saved
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, again)):
        if not torch.equal(a, b):
            fail(f"{name} {label}: two runs give other bits in output {i}")
    for i, (a, b) in enumerate(zip(got, grid)):
        if not close(a, b, tol):
            fail(f"{name} {label}: the cluster kernel's output {i} differs "
                 f"from the grid kernel's (max abs diff "
                 f"{float((a - b).abs().max())}, tolerance {tol})")
    return max(float((a - b).abs().max()) for a, b in zip(got, grid))


def rnn_fwd_extras(torch, fr, card, row, fn, flops, nbytes, h, flush,
                   name):
    """The forward's kernel (cluster or grid) of ``name``
    ("lstm_train_fwd" or "gru_train_fwd") and bounds at width h: its FLOPs
    as three TF32 products at 495 TFLOP/s where it runs on the tensor
    cores (the cluster kernel), else at 67 TFLOP/s; both against the
    bytes. Where the cluster kernel runs: two calls bit-equal, and the
    grid kernel in the same run (the plan emptied) held to it within the
    forward's tolerance; both timed by events and by device time (a
    profiler window: every kernel of the call, and the recurrent kernel
    alone)."""
    dev = torch.device("cuda")
    plan = fr.rnn_kernel_for(name, h, dev)
    loop = name[:-len("_train_fwd")] + "_fwd"       # lstm_fwd, gru_fwd
    tol = LSTM_FWD_TOL if name.startswith("lstm") else GRU_FWD_TOL
    t_bytes = nbytes / HBM_BYTES_PER_S
    tc = 3 * flops / TF32_FLOPS_PER_S
    row["kernel"] = plan
    row["tf32x3_bound_ms"] = max(tc, t_bytes) * 1e3
    row["simt_bound_ms"] = bound_of(flops, nbytes)[0]
    if plan["kernel"] != "cluster":
        return
    row["bound_ms"] = row["tf32x3_bound_ms"]
    row["bound_by"] = "operations" if tc >= t_bytes else "bytes"
    split = kernel_split(torch, fn)
    row["device_ms"] = sum(split.values())
    row["loop_ms"] = sum(v for k, v in split.items() if loop in k)
    row["grid_max_abs_diff"] = cluster_against_grid(
        torch, fr, name, fn, h, tol, f"at H {h}")
    key = (torch.cuda.current_device(), name, h)
    saved = fr._plans[key]
    fr._plans[key] = None                  # the grid kernel, this run
    try:
        row["grid_ms"] = time_ms(torch, fn, flush, n=20)
        gsplit = kernel_split(torch, fn)
    finally:
        fr._plans[key] = saved
    row["grid_device_ms"] = sum(gsplit.values())
    row["grid_loop_ms"] = sum(v for k, v in gsplit.items() if loop in k)
    print(f"[{card}] {name} at H {h}: {plan}; device time a call "
          f"{row['device_ms']:.3f} ms (the cluster kernel "
          f"{row['loop_ms']:.3f}); two runs bit-equal; the grid kernel (the "
          f"earlier design) {row['grid_ms']:.3f} ms in this run (device "
          f"{row['grid_device_ms']:.3f} ms, the grid kernel "
          f"{row['grid_loop_ms']:.3f}), within "
          f"{row['grid_max_abs_diff']:.3g} of the cluster kernel; bounds "
          f"{row['tf32x3_bound_ms']:.3f} ms at 3xTF32, "
          f"{row['simt_bound_ms']:.3f} ms at the SIMT rate")


def rnn_bwd_extras(torch, fr, card, row, fn, flops, nbytes, h, flush,
                   name):
    """The backward's kernel (cluster or grid) of ``name``
    ("lstm_train_bwd" or "gru_train_bwd") and bounds at width h: its FLOPs
    as three TF32 products at 495 TFLOP/s where the loop runs on the tensor
    cores (the cluster kernel; the dw product does at every width), else
    the loop's two thirds at 67 TFLOP/s; both against the bytes. At the
    training shape also its time by kernel (the loop, dw, the rest), and
    the grid kernel run in the same process (the plan emptied): timed, by
    kernel, and held to the cluster kernel within the gradients'
    tolerance."""
    plan = fr.rnn_kernel_for(name, h, torch.device("cuda"))
    loop = name[:-len("_train_bwd")] + "_bwd"       # lstm_bwd, gru_bwd
    tol = LSTM_GRAD_TOL if name.startswith("lstm") else GRU_GRAD_TOL
    t_bytes = nbytes / HBM_BYTES_PER_S
    tc = 3 * flops / TF32_FLOPS_PER_S
    t_ops = tc if plan["kernel"] == "cluster" else \
        2 / 3 * flops / FP32_FLOPS_PER_S + tc / 3
    row["kernel"] = plan
    row["bound_ms"] = max(t_ops, t_bytes) * 1e3
    row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    row["tf32x3_bound_ms"] = max(tc, t_bytes) * 1e3
    row["simt_bound_ms"] = bound_of(flops, nbytes)[0]
    if plan["kernel"] != "cluster":
        return
    split = kernel_split(torch, fn)
    row["device_ms"] = sum(split.values())
    row["loop_ms"] = sum(v for k, v in split.items() if loop in k)
    row["dw_ms"] = sum(v for k, v in split.items() if "rnn_dw" in k)
    row["rest_ms"] = row["device_ms"] - row["loop_ms"] - row["dw_ms"]
    got = fn()
    key = (torch.cuda.current_device(), name, h)
    saved = fr._plans[key]
    fr._plans[key] = None                  # the grid kernel, this run
    try:
        grid = fn()
        row["grid_ms"] = time_ms(torch, fn, flush, n=20)
        gsplit = kernel_split(torch, fn)
    finally:
        fr._plans[key] = saved
    torch.cuda.synchronize()
    row["grid_device_ms"] = sum(gsplit.values())
    row["grid_loop_ms"] = sum(v for k, v in gsplit.items() if loop in k)
    row["grid_split_ms"] = gsplit
    row["grid_max_abs_diff"] = max(float((a - b).abs().max())
                                   for a, b in zip(got, grid))
    for a, b in zip(got, grid):
        if not close(a, b, tol):
            fail(f"{name} at H {h}: the cluster kernel differs from the "
                 f"grid kernel (max abs diff {row['grid_max_abs_diff']})")
    print(f"[{card}] {name} at H {h}: {plan}; by kernel: loop "
          f"{row['loop_ms']:.3f} ms, dw {row['dw_ms']:.3f} ms, the rest "
          f"{row['rest_ms']:.3f} ms (device {row['device_ms']:.3f} ms); the "
          f"grid kernel (the earlier design) {row['grid_ms']:.3f} ms in this "
          f"run (device {row['grid_device_ms']:.3f} ms, its loop "
          f"{row['grid_loop_ms']:.3f} ms), within "
          f"{row['grid_max_abs_diff']:.3g} of the cluster kernel; bounds "
          f"{row['tf32x3_bound_ms']:.3f} ms at 3xTF32, "
          f"{row['simt_bound_ms']:.3f} ms at the SIMT rate")


def rnn_plans(fr, names, h, dev):
    """Which kernel each direction runs at width h, as printed."""
    return " (forward: {}, backward: {})".format(
        *(fr.rnn_kernel_for(k, h, dev) for k in names))


def rnn_phase(torch, dev, card, kind, shape=None, edge=None, wide=None):
    """The LSTM or GRU kernels (``kind``) against their plain versions at
    an edge shape, at the training shape and at the ``wide`` shapes above
    H 512 (U 8 or 16 units a block, the slices of w in global scratch;
    the GRU's x [1, 1, 1539], H 513, the least width above 512; H 2113,
    above 16 units on every SM, runs groups of 16 units in passes:
    the GRU's x [1, 1, 6339] and both at T 4, B 2); the training shape and
    the first wide one timed beside plain
    and bound, the training shape also at B 1 and against the plain
    forward with its autograd backward."""
    from paddle_tpu_torch.ops.kernels import fused_rnn as fr
    spec = rnn_kinds()[kind]
    shape, edge = shape or spec["shape"], edge or spec["edge"]
    wide = spec["wide"] if wide is None else wide
    ins, cot, _ = spec["inputs"](torch, dev, *edge, spec["seeds"][0])
    edge_errs, _ = spec["check"](torch, fr, ins, cot,
                                 "edge T {} B {} H {}".format(*edge))
    ran = rnn_plans(fr, spec["names"], edge[2], dev)
    fwd_name, fwd = spec["names"][0], getattr(fr, spec["names"][0])
    if fr.rnn_kernel_for(fwd_name, edge[2], dev)["kernel"] == "cluster":
        diff = cluster_against_grid(
            torch, fr, fwd_name, lambda: fwd(*ins), edge[2],
            LSTM_FWD_TOL if kind == "LSTM" else GRU_FWD_TOL, "at the edge")
        ran += (f"; the forward's two runs bit-equal, within {diff:.3g} of "
                f"the grid kernel")
    print(f"[{card}] {kind} edge shape T {edge[0]} B {edge[1]} H {edge[2]}"
          f"{ran}: max abs err "
          + ", ".join(f"{k} {e:.3g}" for k, e in edge_errs.items()))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    results = {}
    for i, (t, b, h) in enumerate((shape,) + tuple(wide)):
        ins, cot, lens_sum = spec["inputs"](
            torch, dev, t, b, h, spec["seeds"][1] if i == 0 else 29 + i)
        errs, want = spec["check"](torch, fr, ins, cot, f"T {t} B {b} H {h}")
        ran = rnn_plans(fr, spec["names"], h, dev)
        if i and any(fr.rnn_kernel_for(n, h, dev)["kernel"] != "grid"
                     for n in spec["names"]):
            fail(f"{kind} at H {h}: a kernel other than the grid kernel "
                 f"ran{ran}")
        print(f"[{card}] {kind} T {t} B {b} H {h}{ran}: max abs err "
              + ", ".join(f"{k} {e:.3g}" for k, e in errs.items()))
        if i > 1:
            continue
        rows = rnn_rows(torch, fr, card, kind, ins, cot, want, errs,
                        lens_sum, flush)
        for kname, row in rows.items():
            results[kname if i == 0 else f"{kname}/h{h}"] = row
        if i:
            continue
        for kname, outs in zip(spec["names"], spec["outs"]):
            results[kname]["edge_max_abs_err"] = max(edge_errs[o]
                                                     for o in outs)
        one = tuple(x[:, :1].contiguous() if j == 0 else
                    x[:1].contiguous() if j in spec["batched"] else x
                    for j, x in enumerate(ins))
        fwd = getattr(fr, spec["names"][0])
        serial_ms = time_ms(torch, lambda: fwd(*one), flush, n=20)

        def autograd_pair():
            leaves = [x.detach().requires_grad_() if x.is_floating_point()
                      else x for x in ins]
            outs = getattr(fr, spec["names"][0] + "_plain")(*leaves)
            return torch.autograd.grad(
                outs[:len(cot)], [x for x in leaves if x.is_floating_point()],
                cot)
        fwd_row, bwd_row = (results[n] for n in spec["names"])
        fwd_row["serial_us_per_step"] = serial_ms / t * 1e3
        bwd_row["autograd_plain_ms"] = time_ms(torch, autograd_pair, flush,
                                               n=3, warm=1)
        print(f"[{card}] {kind} forward at B 1 ({spec['serial']}, almost no "
              f"arithmetic): {serial_ms:.3f} ms, {serial_ms / t * 1e3:.2f} us "
              f"a step; plain forward + autograd backward "
              f"{bwd_row['autograd_plain_ms']:.3f} ms")
    del flush
    return results


# -- phase 11: MT training --------------------------------------------------

def mt_weights(model, seed: int) -> dict:
    """Seeded weights for every parameter of ``model`` under its JAX scope
    name: tables N(0, emb_dim**-0.5), matrices N(0, fan_in**-0.5), biases
    0."""
    from paddle_tpu_torch.models import convert
    rng = np.random.RandomState(seed)
    state = model.state_dict()
    out = {}
    for name in convert.MT_NAMES:
        shape = tuple(state[convert.mt_state_key(name)].shape)
        if name.endswith(".b"):
            out[name] = np.zeros(shape, np.float32)
        else:
            fan_in = shape[1] if name.endswith("_emb") else shape[0]
            out[name] = rng.normal(0.0, fan_in ** -0.5, shape).astype(
                np.float32)
    return out


def mt_batches(seed: int, steps: int, b: int, t: int, vocab: int):
    """Per step (src, tgt_in, tgt_out) [B, T] int64 from numpy, ids over
    the whole vocabulary: src random; tgt_in starts at the start id 1;
    tgt_out[0] = src[0] (through the attention) and after that the chain
    tgt_out[k] = (7 tgt_in[k] + 3) % V with tgt_in[k] = tgt_out[k - 1]
    (through the decoder's own input)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        src = rng.randint(0, vocab, (b, t)).astype(np.int64)
        tgt_in = np.ones((b, t), np.int64)
        tgt_out = np.zeros((b, t), np.int64)
        tgt_out[:, 0] = src[:, 0]
        for k in range(1, t):
            tgt_in[:, k] = tgt_out[:, k - 1]
            tgt_out[:, k] = (7 * tgt_in[:, k] + 3) % vocab
        out.append((src, tgt_in, tgt_out))
    return out


def kernel_modules():
    from paddle_tpu_torch.ops.kernels import (embed_cache, embed_pool,
                                              flash_attention, fused_ce,
                                              fused_rnn, paged_attention,
                                              seqpool)
    return (flash_attention, fused_ce, fused_rnn, paged_attention, seqpool,
            embed_pool, embed_cache)


def all_launches():
    """Every kernel module's launch counts, by ``module.kernel``."""
    return {f"{m.__name__.rsplit('.', 1)[1]}.{k}": n
            for m in kernel_modules() for k, n in m.LAUNCHES.items()}


def reset_all_launches():
    for m in kernel_modules():
        m.reset_launches()


def mt_train_phase(torch, dev, card, cfg=None, batch=MT_BATCH,
                   steps=TRAIN_STEPS, profile_steps=PROFILE_STEPS,
                   oracle_steps=MT_ORACLE_STEPS):
    """The MT training slice on the card, its launch counts per step, the
    CPU oracle over the first steps, lazy Adam's untouched rows, and the
    step-time and profiler numbers. Returns the trained card model too."""
    from paddle_tpu_torch.models import convert
    from paddle_tpu_torch.models.machine_translation import build
    cfg = dict(MT if cfg is None else cfg)
    words = batch * cfg["max_len"]
    feeds_np = mt_batches(6, steps + profile_steps, batch, cfg["max_len"],
                          cfg["tgt_vocab"])

    def make(device):
        model, opt, _ = build(**cfg, device=device)
        return model, opt

    model, opt = make(dev)
    state = convert.mt_params_from_jax(mt_weights(model, 7))
    model.load_state_dict(state)
    feeds = [tuple(torch.from_numpy(a).to(dev) for a in f) for f in feeds_np]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    losses, step_ms, per_step = train(torch, model, opt, feeds[:steps],
                                      all_launches)
    launched = all_launches()
    want = {k: (MT_GRU_PER_STEP if k.startswith("fused_rnn.gru_") else 0)
            for k in launched}
    for i, c in enumerate(per_step):
        if c != want:
            fail(f"MT training: step {i} launched {c}, want {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"MT training: losses {losses} are not finite and falling")
    stats = {"losses": losses, "step_ms": step_ms,
             "step_p50_ms": float(np.median(step_ms)),
             "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
             "launches": {k: n for k, n in launched.items() if n},
             "words": words}
    stats["words_per_s"] = words / stats["step_p50_ms"] * 1e3
    print(f"[{card}] machine_translation: losses "
          f"{[round(x, 5) for x in losses]}; step p50 "
          f"{stats['step_p50_ms']:.3f} ms = {stats['words_per_s']:.0f} "
          f"words/s ({words} target words a step); peak memory "
          f"{stats['peak_mem_bytes'] / 2 ** 20:.1f} MiB; launches "
          f"{stats['launches']} ({MT_GRU_PER_STEP} of each GRU kernel a "
          f"step, no other kernel)")

    # lazy Adam: the table rows no batch touched are as they started
    for table, col in (("src_emb", 0), ("tgt_emb", 1)):
        used = np.unique(np.concatenate(
            [f[col].reshape(-1) for f in feeds_np[:steps]]))
        untouched = np.setdiff1d(np.arange(getattr(model, table).shape[0]),
                                 used)
        now = getattr(model, table).detach().cpu()
        if untouched.size == 0 or not torch.equal(
                now[untouched], state[table][untouched]):
            fail(f"MT training: {table} rows no batch touched moved "
                 f"({untouched.size} untouched)")
        if bool((now[used] == state[table][used]).all(dim=1).any()):
            fail(f"MT training: a touched {table} row did not move")
        stats[f"{table}_untouched_rows"] = int(untouched.size)
    print(f"[{card}] lazy Adam: {stats['src_emb_untouched_rows']} source and "
          f"{stats['tgt_emb_untouched_rows']} target table rows that no "
          f"batch touched are bit-equal to their start; every touched row "
          f"moved")
    if profile_steps:
        stats["profile"] = prof = profile_window(torch, model, opt,
                                                 feeds[steps:])
        prof["idle_share_at_p50"] = 1.0 - prof[
            "device_busy_ms_per_step"] / stats["step_p50_ms"]
        print(f"[{card}] machine_translation profile ({profile_steps} "
              f"steps): host {prof['host_ms_per_step']:.3f} ms/step, device "
              f"busy {prof['device_busy_ms_per_step']:.3f} ms/step, idle "
              f"share {prof['idle_share']:.3f} "
              f"({prof['idle_share_at_p50']:.3f} against the step p50), "
              f"GRU kernels {prof['rnn_share']:.4f} of device time, "
              f"{prof['launches_per_step']:.0f} launches/step")
        for key, us, count in prof["top_kernels"]:
            print(f"    {us:10.1f} us/step {count:6.1f}/step  {key}")
        want = {}
        for name in ("gru_fwd", "gru_bwd"):
            plan = gru_plan(name, cfg["hid_dim"], dev)
            want[f"{name} cluster"] = MT_GRU_PER_STEP * (plan == "cluster")
            want[f"{name} grid"] = MT_GRU_PER_STEP * (plan == "grid")
            stats[f"{name}_kernel"] = plan
        check_families("MT training", prof, want)
        print(f"[{card}] machine_translation: the GRU kernels a step: "
              f"{family_line(prof)}")

    # the oracle: the same model on the CPU, where the wrappers take the
    # plain versions, from the same weights on the same feeds
    t0 = time.perf_counter()
    before = all_launches()
    oracle, oracle_opt = make("cpu")
    oracle.load_state_dict(state)
    want_losses = []
    for f in feeds_np[:oracle_steps]:
        oracle_opt.zero_grad(set_to_none=True)
        loss = oracle(*(torch.from_numpy(a) for a in f))
        loss.backward()
        oracle_opt.step()
        want_losses.append(float(loss.detach()))
    if all_launches() != before:
        fail("MT training: the CPU oracle launched a kernel")
    if not np.allclose(losses[:oracle_steps], want_losses, rtol=CURVE_RTOL,
                       atol=0.0):
        fail(f"MT training: losses {losses[:oracle_steps]} differ from the "
             f"CPU oracle's {want_losses} beyond rtol {CURVE_RTOL}")
    gap = max(abs(x - y) / abs(y)
              for x, y in zip(losses[:oracle_steps], want_losses))
    stats["oracle_losses"] = want_losses
    stats["oracle_max_rel_diff"] = gap
    print(f"[{card}] machine_translation: the first {oracle_steps} losses "
          f"match the CPU oracle's within rtol {CURVE_RTOL} (max rel diff "
          f"{gap:.3g}; oracle took {time.perf_counter() - t0:.1f} s)")
    del oracle, oracle_opt, opt
    return launched, stats, model


def gru_plan(name, h, dev):
    """"cluster" or "grid": the kernel that the GRU's ``name`` ("gru_fwd"
    or "gru_bwd") runs at width h."""
    from paddle_tpu_torch.ops.kernels import fused_rnn as fr
    return fr.rnn_kernel_for(name.replace("_", "_train_"), h, dev)["kernel"]


# -- phase 12: MT beam decode -----------------------------------------------

def traced_generate(torch, model, src):
    """``model.generate(src)`` with every beam step recorded: (ids, scores,
    step records), each record the step's (selected ids, parents, the top
    K + 1 candidate scores in the selection's order) on the host."""
    from paddle_tpu_torch.ops import beam_ops
    step, records = beam_ops.beam_step, []

    def recording(pre_ids, pre_scores, scores, beam_size, end_id):
        out = step(pre_ids, pre_scores, scores, beam_size, end_id)
        # the next candidate the selection left out, as it ranks them
        nxt = step(pre_ids, pre_scores, scores, beam_size + 1, end_id)[1]
        records.append((out[0].cpu(), out[2].cpu(), nxt.cpu()))
        return out
    beam_ops.beam_step = recording
    try:
        ids, scores = model.generate(src)
    finally:
        beam_ops.beam_step = step
    return ids.cpu(), scores.cpu(), records


def mt_beam_phase(torch, dev, card, model, batch=MT_BATCH, reps=5):
    """``generate`` on the card against the same call on the CPU model
    with the same weights: token streams equal up to counted near ties,
    lane scores close and sorted; exactly one GRU forward launch a call."""
    from paddle_tpu_torch.models.machine_translation import build
    cfg = MT
    src_np = np.random.RandomState(8).randint(
        0, cfg["src_vocab"], (batch, cfg["max_len"])).astype(np.int64)
    src = torch.from_numpy(src_np).to(dev)
    model.eval()
    model.generate(src)                          # warm
    torch.cuda.synchronize()
    reset_all_launches()
    ids = model.generate(src)[0]
    torch.cuda.synchronize()
    launched = all_launches()
    want = {k: int(k == "fused_rnn.gru_train_fwd") for k in launched}
    if launched != want:
        fail(f"MT generate launched {launched}, want {want}")
    call_ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ids = model.generate(src)[0]
        ids.cpu()
        call_ms.append((time.perf_counter() - t0) * 1e3)
    got_ids, got_scores, got_steps = traced_generate(torch, model, src)
    cpu_model, _, _ = build(is_train=False, **cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    want_ids, want_scores, want_steps = traced_generate(
        torch, cpu_model, torch.from_numpy(src_np))
    w = model.beam_size
    if tuple(got_ids.shape) != (batch, w, cfg["max_len"]) or bool(
            (got_ids < 0).any() | (got_ids >= cfg["tgt_vocab"]).any()):
        fail(f"MT generate: ids {tuple(got_ids.shape)} out of shape or range")
    if not torch.isfinite(got_scores).all() or bool(
            (got_scores[:, 1:] > got_scores[:, :-1]).any()):
        fail("MT generate: lane scores are not finite and sorted")
    ties, gaps, agree = 0, [], []
    for b in range(batch):
        first = next((t for t, (g, p) in enumerate(zip(got_steps, want_steps))
                      if not (torch.equal(g[0][b], p[0][b])
                              and torch.equal(g[1][b], p[1][b]))), None)
        if first is None:
            if not torch.equal(got_ids[b], want_ids[b]):
                fail(f"MT generate: row {b} took the CPU's steps but "
                     f"backtracked to other ids")
            agree.append(b)
            continue
        # the first rank at which the two selections differ must be a near
        # tie in the CPU's candidates: its score and the next one's
        g, p = got_steps[first], want_steps[first]
        k = next(r for r in range(w) if not (g[0][b, r] == p[0][b, r]
                                             and g[1][b, r] == p[1][b, r]))
        gap = float(p[2][b, k] - p[2][b, k + 1])
        gaps.append(gap)
        if gap > BEAM_TIE:
            fail(f"MT generate: row {b} diverges from the CPU at step "
                 f"{first}, rank {k}, where the CPU's candidates are "
                 f"{gap:.3g} apart (near tie {BEAM_TIE})")
        ties += 1
    if agree and not torch.allclose(got_scores[agree], want_scores[agree],
                                    rtol=BEAM_RTOL, atol=0.0):
        fail(f"MT generate: lane scores differ from the CPU's beyond rtol "
             f"{BEAM_RTOL} (max abs diff "
             f"{float((got_scores[agree] - want_scores[agree]).abs().max())})")
    p50 = float(np.median(call_ms))

    def calls():
        for _ in range(PROFILE_STEPS):
            model.generate(src)
        torch.cuda.synchronize()
    prof = profile_calls(torch, calls, PROFILE_STEPS)
    plan = gru_plan("gru_fwd", cfg["hid_dim"], dev)
    check_families("MT generate", prof, {
        "gru_fwd cluster": int(plan == "cluster"),
        "gru_fwd grid": int(plan == "grid"), "gru_bwd cluster": 0,
        "gru_bwd grid": 0})
    stats = {"profile": prof, "call_ms": call_ms, "call_p50_ms": p50,
             "sequences_per_s": batch / p50 * 1e3, "near_ties": ties,
             "near_tie_gaps": gaps, "rows_equal": len(agree),
             "launches": {k: n for k, n in launched.items() if n},
             "gru_fwd_kernel": plan}
    print(f"[{card}] machine_translation generate (B {batch}, beam {w}, "
          f"{cfg['max_len']} steps): p50 {p50:.3f} ms = "
          f"{stats['sequences_per_s']:.1f} sequences/s; launches "
          f"{stats['launches']}; {len(agree)} of {batch} rows equal to the "
          f"CPU's (ids, and scores within rtol {BEAM_RTOL}), {ties} "
          f"diverge at a near tie (gaps {[f'{x:.2g}' for x in gaps]})")
    print(f"[{card}] generate profile ({PROFILE_STEPS} calls): host "
          f"{prof['host_ms_per_step']:.3f} ms/call, device busy "
          f"{prof['device_busy_ms_per_step']:.3f} ms/call, idle share "
          f"{prof['idle_share']:.3f}, GRU kernels {prof['rnn_share']:.4f} of "
          f"device time, {prof['launches_per_step']:.0f} launches/call; the "
          f"GRU kernels a call: {family_line(prof)}")
    for key, us, count in prof["top_kernels"]:
        print(f"    {us:10.1f} us/call {count:6.1f}/call  {key}")
    return launched, stats


# -- phase 13: pooling kernels ----------------------------------------------

def seqpool_cost(b, d, lens_sum):
    """Bytes of the masked pool: the live rows of x, the lengths and the
    output; one add a float read (operations never bound it)."""
    return lens_sum * d, lens_sum * d * 4 + b * 4 + b * d * 4


def embed_pool_cost(b, d, lens_sum, distinct):
    """Bytes of the gather + pool: each of the ``distinct`` rows of w that
    a live position names, read once (a row named again comes from L2:
    the op program's table is 2.56 MB), the ``lens_sum`` live ids, the
    lengths and the output; one add a live element."""
    return lens_sum * d, distinct * d * 4 + lens_sum * 4 + b * 4 + b * d * 4


def ragged_lens(rng, b, t, zero=False):
    """Lengths 1..T with one full row (and, with ``zero``, one empty)."""
    lens = rng.randint(1, t + 1, b).astype(np.int32)
    lens[0] = t
    if zero:
        lens[-1] = 0
    return lens


def pool_check(torch, label, got, want, scale, rtol=POOL_TOL["rtol"]):
    """|got - want| <= atol + rtol * scale, with ``scale`` the same pool of
    the absolute values: the error of a sum grows with the sum of its
    terms' magnitudes, not with the (cancelling) sum itself. Returns the
    max abs error and, at the element where an rtol of |want| itself
    would be tightest, that element's error, |want| and scale."""
    torch.cuda.synchronize()
    wide = torch.complex128 if got.is_complex() else torch.float64
    err = (got.to(wide) - want.to(wide)).abs().flatten()
    mag = want.to(wide).abs().flatten()
    at = int((err / (POOL_TOL["atol"] + rtol * mag)).argmax())
    worst = (float(err.max()), float(err[at]), float(mag[at]),
             float(scale.flatten()[at]))
    if got.shape != want.shape or got.dtype != want.dtype or not bool(
            torch.isfinite(got.to(wide)).all()) or bool(
            (err > POOL_TOL["atol"] + rtol * scale.flatten()).any()):
        fail(f"{label} differs from its plain version: max abs err "
             f"{worst[0]} (rtol {rtol} of the pool of |x|, atol "
             f"{POOL_TOL['atol']}); tightest against |plain|: err "
             f"{worst[1]} where |plain| is {worst[2]} and the pool of |x| "
             f"{worst[3]}")
    return worst


def pool_dtypes(torch, dev, card, sp, ep, rng):
    """Both pooling kernels at every other dtype that the JAX op pools,
    float8 and unsigned included, at a small ragged shape, against their
    plain versions (rtol of the pool of |x|: fp16 and bf16 round the sum
    once where the plain versions round it twice)."""
    b, t, d, v = 6, 9, 12, 23
    lens = torch.tensor([9, 0, 4, 1, 7, 3], device=dev)
    ids = torch.from_numpy(rng.randint(0, v, (b, t))).to(dev)
    errs = {}
    for name, rtol in POOL_DTYPES.items():
        dtype = getattr(torch, name)
        wide = torch.complex128 if dtype.is_complex else torch.float64
        x, w = (torch.from_numpy(rng.randn(*shape) * 4) for shape in
                ((b, t, d), (v, d)))
        if name.startswith("uint"):
            x, w = x.abs(), w.abs()
        if dtype.is_complex:
            x, w = (torch.complex(a, torch.from_numpy(rng.randn(*a.shape)))
                    for a in (x, w))
        x, w = (a.to(dtype).to(dev) for a in (x, w))
        err = max(pool_check(torch, f"seqpool {m} {dtype}",
                             sp.masked_seqpool_fwd(x, lens, m),
                             sp.masked_seqpool_ref(x, lens, m),
                             sp.masked_seqpool_ref(x.to(wide).abs(), lens, m),
                             rtol)[0] for m in sp.MODES)
        if dtype != torch.bool:
            err = max(err, pool_check(
                torch, f"embed_pool {dtype}",
                ep.fused_embed_seq_pool(w, ids, lens),
                ep.fused_embed_seq_pool_ref(w, ids, lens),
                ep.fused_embed_seq_pool_ref(w.to(wide).abs(), ids, lens),
                rtol)[0])
        errs[name] = err
    print(f"[{card}] pooling kernels at other dtypes [{b}x{t}x{d}], table "
          f"[{v}x{d}]: max abs err "
          + ", ".join(f"{k} {e:.3g}" for k, e in errs.items()))
    return errs


def pool_phase(torch, dev, card, seqpool=SEQPOOL, seqpool_edge=SEQPOOL_EDGE,
               embed=EMBED_POOL, embed_edge=EMBED_EDGE):
    """The masked sequence-pool kernel at the classifier's pools and the
    gather + pool kernel at the op program's shape, each at an edge shape
    and at the other dtypes too, against their plain versions; then timed
    beside plain, bound and, for the gather + pool,
    ``F.embedding_bag``."""
    from paddle_tpu_torch.ops.kernels import embed_pool as ep
    from paddle_tpu_torch.ops.kernels import seqpool as sp
    import torch.nn.functional as F
    rng = np.random.RandomState(16)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    results = {}

    def worst_text(worst):
        return (f"{worst[0]:.3g} (tightest against |plain|: err "
                f"{worst[1]:.3g} where |plain| is {worst[2]:.4g}, the pool "
                f"of |x| {worst[3]:.4g})")

    for (b, t, d), main in ((seqpool_edge, False), (seqpool, True)):
        x = torch.from_numpy(rng.randn(b, t, d).astype(np.float32)).to(dev)
        lens_np = ragged_lens(rng, b, t, zero=not main)
        lens = torch.from_numpy(lens_np).to(dev)
        worst = {m: pool_check(torch, f"seqpool {m} [{b}x{t}x{d}]",
                               sp.masked_seqpool_fwd(x, lens, m),
                               sp.masked_seqpool_ref(x, lens, m),
                               sp.masked_seqpool_ref(x.abs(), lens, m))
                 for m in sp.MODES}
        print(f"[{card}] seqpool [{b}x{t}x{d}], lengths {lens_np.min()}-"
              f"{lens_np.max()}: max abs err "
              + ", ".join(f"{m} {worst_text(w)}" for m, w in worst.items()))
        err = max(w[0] for w in worst.values())
        if not main:
            edge_err = err
            continue
        lens_sum = int(lens_np.sum())
        flops, nbytes = seqpool_cost(b, d, lens_sum)
        bound_ms, bound_by = bound_of(flops, nbytes)
        row = {"max_abs_err": err, "edge_max_abs_err": edge_err,
               "ms": time_ms(torch, lambda: sp.masked_seqpool_fwd(
                   x, lens, "SQRT"), flush),
               "plain_ms": time_ms(torch, lambda: sp.masked_seqpool_ref(
                   x, lens, "SQRT"), flush),
               "library_ms": None, "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes": nbytes, "flops": flops,
               "live_rows": lens_sum, "rows": b * t,
               "modes_ms": {m: time_ms(torch, lambda m=m: sp.masked_seqpool_fwd(
                   x, lens, m), flush) for m in ("SUM", "AVERAGE")},
               "warps": sp.pool_warps(t, 0)}
        # device time alone, each call after the same L2 flush (events
        # also count the host's launch on a grid this small)
        row["modes_device_ms"] = {m: flushed_device_ms(
            torch, lambda m=m: sp.masked_seqpool_fwd(x, lens, m), flush)
            for m in sp.MODES}
        row["device_ms"] = row["modes_device_ms"]["SQRT"]
        results["seqpool"] = row
        print(f"[{card}] seqpool SQRT [{b}x{t}x{d}] ({row['warps']} warps a "
              f"row): kernel "
              f"{row['ms'] * 1e3:.2f} us (SUM "
              f"{row['modes_ms']['SUM'] * 1e3:.2f}, AVERAGE "
              f"{row['modes_ms']['AVERAGE'] * 1e3:.2f}); device time alone "
              + ", ".join(f"{m} {us(v)}"
                          for m, v in row["modes_device_ms"].items())
              + f"; plain "
              f"{row['plain_ms'] * 1e3:.2f} us, no library call (no one "
              f"PyTorch call pools a padded batch by lengths), bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}: {nbytes / 1e6:.2f} MB, "
              f"{lens_sum} of {b * t} rows live)")

    for (v, d, b, t), main in ((embed_edge, False), (embed, True)):
        w = torch.from_numpy(rng.randn(v, d).astype(np.float32)).to(dev)
        ids_np = rng.randint(0, v, (b, t)).astype(np.int64)
        lens_np = ragged_lens(rng, b, t) if main else None
        ids = torch.from_numpy(ids_np).to(dev)
        lens = None if lens_np is None else torch.from_numpy(lens_np).to(dev)
        worst = pool_check(torch, f"embed_pool [{v}x{d}] [{b}x{t}]",
                           ep.fused_embed_seq_pool(w, ids, lens),
                           ep.fused_embed_seq_pool_ref(w, ids, lens),
                           ep.fused_embed_seq_pool_ref(w.abs(), ids, lens))
        print(f"[{card}] embed_pool table [{v}x{d}], ids [{b}x{t}], "
              f"{'ragged lengths' if main else 'no lengths'}: max abs err "
              f"{worst_text(worst)}")
        if not main:
            edge_err = worst[0]
            continue
        # the library yardstick: embedding_bag over the live ids, one bag
        # a row, held to the plain version first
        live = np.arange(t)[None, :] < lens_np[:, None]
        flat = torch.from_numpy(ids_np[live]).to(dev)
        offsets = torch.from_numpy(np.concatenate(
            [[0], np.cumsum(lens_np)[:-1]]).astype(np.int64)).to(dev)

        def lib():
            return F.embedding_bag(flat, w, offsets, mode="sum")
        pool_check(torch, "embed_pool: the library yardstick", lib(),
                   ep.fused_embed_seq_pool_ref(w, ids, lens),
                   ep.fused_embed_seq_pool_ref(w.abs(), ids, lens))
        lens_sum = int(lens_np.sum())
        distinct = int(np.unique(ids_np[live]).size)
        flops, nbytes = embed_pool_cost(b, d, lens_sum, distinct)
        bound_ms, bound_by = bound_of(flops, nbytes)
        # kernel and library in turns (K L L K ...): rows 10-11 swung 2-4x
        # between runs, so their comparison is made within one call
        rounds = {"kernel": [], "library": []}
        for r in range(EMBED_ROUNDS):
            for name in (("kernel", "library") if r % 2 == 0 else
                         ("library", "kernel")):
                rounds[name].append(time_ms(
                    torch, (lambda: ep.fused_embed_seq_pool(w, ids, lens))
                    if name == "kernel" else lib, flush))
        row = {"max_abs_err": worst[0], "edge_max_abs_err": edge_err,
               "ms": float(np.median(rounds["kernel"])),
               "plain_ms": time_ms(torch, lambda: ep.fused_embed_seq_pool_ref(
                   w, ids, lens), flush),
               "library_ms": float(np.median(rounds["library"])),
               "rounds_ms": rounds, "warps": ep.pool_warps(t, 0),
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "flops": flops, "live_rows": lens_sum, "rows": b * t,
               "distinct_rows": distinct}
        row["faster_than_library"] = row["ms"] < row["library_ms"]
        # device time alone (profiler: every kernel of the call but the
        # flush's fill), each call after the same flush: the events above
        # also count any wait for the host's launch
        for name, fn in (("kernel", lambda: ep.fused_embed_seq_pool(
                w, ids, lens)), ("library", lib)):
            row[f"{name}_device_ms"] = flushed_device_ms(torch, fn, flush)
        results["embed_pool"] = row
        spread = {k: f"{min(x) * 1e3:.2f}-{max(x) * 1e3:.2f}"
                  for k, x in rounds.items()}
        print(f"[{card}] embed_pool [{v}x{d}] [{b}x{t}] ({row['warps']} "
              f"warps a row): kernel {row['ms'] * 1e3:.2f} us (rounds "
              f"{spread['kernel']}), library {row['library_ms'] * 1e3:.2f} "
              f"us (F.embedding_bag; rounds {spread['library']}), medians of "
              f"{EMBED_ROUNDS} interleaved rounds; device time alone "
              f"{us(row['kernel_device_ms'])}, library "
              f"{us(row['library_device_ms'])}; plain "
              f"{row['plain_ms'] * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} "
              f"us ({bound_by}: {nbytes / 1e6:.2f} MB, {distinct} distinct "
              f"of {lens_sum} live rows, {b * t} in all)")
    results["dtypes_max_abs_err"] = pool_dtypes(torch, dev, card, sp, ep, rng)
    del flush
    return results


# -- phase 14: text-conv training -------------------------------------------

def textconv_model(torch, cfg, device):
    """The book's convolution_net from the port's entry points: a sparse
    table, two ``nets.SequenceConvPool`` (filter sizes 3 and 4, tanh,
    ``"sqrt"``), a softmax ``fc`` over both, ``cross_entropy`` and
    ``mean``; state keys those of ``convert.TEXTCONV_LAYOUT``."""
    from torch import nn
    from paddle_tpu_torch import nets
    from paddle_tpu_torch.ops import nn_ops as tnn
    v, e, f, c = (cfg["dict_dim"], cfg["emb_dim"], cfg["num_filters"],
                  cfg["classes"])

    class TextConv(nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = nn.Parameter(torch.zeros(v, e, device=device))
            self.conv3, self.conv4 = (nets.SequenceConvPool(
                e, f, k, act="tanh", pool_type="sqrt", device=device)
                for k in (3, 4))
            self.fc_w0 = nn.Parameter(torch.zeros(f, c, device=device))
            self.fc_w1 = nn.Parameter(torch.zeros(f, c, device=device))
            self.fc_b = nn.Parameter(torch.zeros(c, device=device))

        def forward(self, words, lens, label):
            x = tnn.lookup_table(self.emb, words, sparse=True)
            pred = tnn.fc([self.conv3(x, lens), self.conv4(x, lens)],
                          [self.fc_w0, self.fc_w1], self.fc_b, act="softmax")
            return tnn.mean(tnn.cross_entropy(pred, label))
    return TextConv()


def textconv_weights(cfg, seed: int) -> dict:
    """Seeded weights under the JAX program's auto names: the table and
    the matrices N(0, fan_in**-0.5), the biases 0."""
    rng = np.random.RandomState(seed)
    v, e, f, c = (cfg["dict_dim"], cfg["emb_dim"], cfg["num_filters"],
                  cfg["classes"])

    def normal(shape, fan_in):
        return rng.normal(0.0, fan_in ** -0.5, shape).astype(np.float32)
    return {"embedding_0.w_0": normal((v, e), e),
            "sequence_conv_0.w_0": normal((3 * e, f), 3 * e),
            "sequence_conv_0.b_0": np.zeros(f, np.float32),
            "sequence_conv_1.w_0": normal((4 * e, f), 4 * e),
            "sequence_conv_1.b_0": np.zeros(f, np.float32),
            "fc_0.w_0": normal((f, c), 2 * f), "fc_0.w_1": normal((f, c), 2 * f),
            "fc_0.b_0": np.zeros(c, np.float32)}


def textconv_batch(seed: int, b: int, t: int, vocab: int, lean=0.8):
    """(words [B,T] int64, seq_lens [B] int32, label [B,1] int64), fresh
    for each ``seed``: ragged lengths 1..T with one full row; each row
    draws its words from the upper half of the vocabulary with
    probability ``lean`` or 1 - ``lean``, and its label says whether most
    of its valid words lie in the upper half. (Words uniform over the
    vocabulary, as phase 9's, give a signal that 10 Adagrad steps at 0.002
    over fresh batches do not learn: the loss stays at ln 2.)"""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, t + 1, b).astype(np.int32)
    lens[0] = t
    half = vocab // 2
    upper = rng.rand(b, t) < np.where(rng.rand(b) < 0.5, lean,
                                      1 - lean)[:, None]
    words = np.where(upper, rng.randint(half, vocab, (b, t)),
                     rng.randint(0, half, (b, t))).astype(np.int64)
    valid = np.arange(t)[None, :] < lens[:, None]
    label = (2 * (upper & valid).sum(1) > lens).astype(np.int64)[:, None]
    return words, lens, label


def train_oracle(torch, make, state, feeds_np, steps):
    """The first ``steps`` losses of the same model on the CPU, where the
    wrappers take the plain versions, from the same weights and feeds."""
    before = all_launches()
    model, opt = make("cpu")
    if state is not None:
        model.load_state_dict(state)
    losses = []
    for feed in feeds_np[:steps]:
        opt.zero_grad(set_to_none=True)
        out = model(*(torch.from_numpy(a) for a in feed))
        loss = out[0] if isinstance(out, tuple) else out
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    if all_launches() != before:
        fail("the CPU oracle launched a kernel")
    return losses


def check_oracle(label, losses, want, card, t0):
    n = len(want)
    if not np.allclose(losses[:n], want, rtol=CURVE_RTOL, atol=0.0):
        fail(f"{label}: losses {losses[:n]} differ from the CPU oracle's "
             f"{want} beyond rtol {CURVE_RTOL}")
    gap = max(abs(x - y) / abs(y) for x, y in zip(losses[:n], want))
    print(f"[{card}] {label}: the first {n} losses match the CPU oracle's "
          f"within rtol {CURVE_RTOL} (max rel diff {gap:.3g}; oracle took "
          f"{time.perf_counter() - t0:.1f} s)")
    return gap


def textconv_phase(torch, dev, card, cfg=None, batch=TEXTCONV_BATCH,
                   steps=TRAIN_STEPS, profile_steps=PROFILE_STEPS,
                   oracle_steps=TEXTCONV_ORACLE_STEPS):
    """The text-conv classifier's training on the card: 2 seqpool launches
    a step and no other kernel, the CPU oracle over the first steps, and
    the step-time and profiler numbers."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import convert
    cfg = dict(TEXTCONV if cfg is None else cfg)
    t = cfg["max_len"]
    feeds_np = [textconv_batch(20 + i, batch, t, cfg["dict_dim"])
                for i in range(steps + profile_steps)]
    words = [int(f[1].sum()) for f in feeds_np]

    def make(device):
        model = textconv_model(torch, cfg, device)
        return model, topt.Adagrad(model.parameters(),
                                   learning_rate=TEXTCONV_LR)

    state = convert.textconv_params_from_jax(textconv_weights(cfg, 21))
    model, opt = make(dev)
    model.load_state_dict(state)
    feeds = [tuple(torch.from_numpy(a).to(dev) for a in f) for f in feeds_np]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    losses, step_ms, per_step = train(torch, model, opt, feeds[:steps],
                                      all_launches)
    launched = all_launches()
    want = {k: TEXTCONV_POOLS_PER_STEP if k == "seqpool.seqpool" else 0
            for k in launched}
    for i, c in enumerate(per_step):
        if c != want:
            fail(f"text-conv training: step {i} launched {c}, want {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"text-conv training: losses {losses} are not finite and "
             f"falling")
    p50 = float(np.median(step_ms))
    stats = {"losses": losses, "step_ms": step_ms, "step_p50_ms": p50,
             "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
             "launches": {k: n for k, n in launched.items() if n},
             "valid_words_per_step": float(np.mean(words[:steps])),
             "padded_words": batch * t}
    stats["words_per_s"] = stats["valid_words_per_step"] / p50 * 1e3
    print(f"[{card}] text-conv classifier: losses "
          f"{[round(x, 5) for x in losses]}; step p50 {p50:.3f} ms = "
          f"{stats['words_per_s']:.0f} words/s "
          f"({stats['valid_words_per_step']:.0f} valid words a step of "
          f"{batch * t}); peak memory "
          f"{stats['peak_mem_bytes'] / 2 ** 20:.1f} MiB; launches "
          f"{stats['launches']} ({TEXTCONV_POOLS_PER_STEP} seqpool a step, "
          f"no other kernel)")
    if profile_steps:
        stats["profile"] = prof = profile_window(torch, model, opt,
                                                 feeds[steps:])
        prof["idle_share_at_p50"] = 1.0 - prof[
            "device_busy_ms_per_step"] / p50
        print(f"[{card}] text-conv profile ({profile_steps} steps): host "
              f"{prof['host_ms_per_step']:.3f} ms/step, device busy "
              f"{prof['device_busy_ms_per_step']:.3f} ms/step, idle share "
              f"{prof['idle_share']:.3f} ({prof['idle_share_at_p50']:.3f} "
              f"against the step p50), pooling kernels "
              f"{prof['pool_share']:.4f} of device time, "
              f"{prof['launches_per_step']:.0f} launches/step")
        for key, us, count in prof["top_kernels"]:
            print(f"    {us:10.1f} us/step {count:6.1f}/step  {key}")
    del model, opt
    t0 = time.perf_counter()
    want_losses = train_oracle(torch, make, state, feeds_np, oracle_steps)
    stats["oracle_losses"] = want_losses
    stats["oracle_max_rel_diff"] = check_oracle(
        "text-conv classifier", losses, want_losses, card, t0)
    return launched, stats


# -- phase 15: the fused_embedding_seq_pool op program ----------------------

def op_program_feeds(cfg, batch, steps):
    """Per step (ids [B, T] int64, lens [B] int32): fresh seeded ids over
    the table but its last fifth (rows that no batch reads, where lazy
    Adam's untouched rows show), ragged lengths with one full row."""
    rng = np.random.RandomState(22)
    t = cfg["max_len"]
    return [(rng.randint(0, cfg["vocab"] * 4 // 5, (batch, t)).astype(
        np.int64), ragged_lens(rng, batch, t)) for _ in range(steps)]


def op_program_phase(torch, dev, card, cfg=None, batch=OP_PROGRAM_BATCH,
                     steps=TRAIN_STEPS, oracle_steps=TEXTCONV_ORACLE_STEPS):
    """``fused_embedding_seq_pool`` + ``mean`` + lazy Adam over the
    row-sparse table gradient: one embed_pool launch a step and no other
    kernel, the rows read inside no length bit-equal and every row read
    inside one moved, and the CPU oracle over the first steps."""
    from torch import nn
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import convert
    from paddle_tpu_torch.ops import lod_ops, nn_ops
    cfg = dict(OP_PROGRAM if cfg is None else cfg)
    table = (np.random.RandomState(23).rand(cfg["vocab"], cfg["dim"])
             * 0.2).astype(np.float32)     # mean 0.1: a loss far from 0
    init = convert.table_from_jax({"emb_w": table})
    feeds_np = op_program_feeds(cfg, batch, steps)

    class OpProgram(nn.Module):
        def __init__(self, device):
            super().__init__()
            self.w = nn.Parameter(init.clone().to(device))

        def forward(self, ids, lens):
            return nn_ops.mean(lod_ops.fused_embedding_seq_pool(
                self.w, ids, lens))

    def make(device):
        model = OpProgram(device)
        return model, topt.Adam(model.parameters(), learning_rate=0.05,
                                lazy_mode=True)

    model, opt = make(dev)
    feeds = [tuple(torch.from_numpy(a).to(dev) for a in f) for f in feeds_np]
    torch.cuda.synchronize()
    reset_all_launches()
    losses, step_ms, per_step = train(torch, model, opt, feeds, all_launches)
    launched = all_launches()
    want = {k: int(k == "embed_pool.embed_pool") for k in launched}
    for i, c in enumerate(per_step):
        if c != want:
            fail(f"op program: step {i} launched {c}, want {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"op program: losses {losses} are not finite and falling")
    t = cfg["max_len"]
    live = np.unique(np.concatenate([
        ids[np.arange(t)[None, :] < lens[:, None]] for ids, lens in feeds_np]))
    still = np.setdiff1d(np.arange(cfg["vocab"]), live)
    now = model.w.detach().cpu()
    if still.size == 0 or not torch.equal(now[still], init[still]):
        fail(f"op program: rows read inside no length moved ({still.size} "
             f"such rows)")
    if bool((now[live] == init[live]).all(dim=1).any()):
        fail("op program: a row read inside a length did not move")
    stats = {"losses": losses, "step_ms": step_ms,
             "step_p50_ms": float(np.median(step_ms)),
             "launches": {k: n for k, n in launched.items() if n},
             "rows_read": int(live.size), "rows_still": int(still.size)}
    print(f"[{card}] fused_embedding_seq_pool program: losses "
          f"{[round(x, 5) for x in losses]}; step p50 "
          f"{stats['step_p50_ms']:.3f} ms; launches {stats['launches']} (one "
          f"embed_pool a step, no other kernel); lazy Adam: {still.size} "
          f"rows read inside no length bit-equal, all {live.size} rows read "
          f"inside one moved")
    del model, opt
    t0 = time.perf_counter()
    want_losses = train_oracle(torch, make, None, feeds_np, oracle_steps)
    stats["oracle_losses"] = want_losses
    stats["oracle_max_rel_diff"] = check_oracle(
        "fused_embedding_seq_pool program", losses, want_losses, card, t0)
    return launched, stats


# -- phase 16: the hot-rows cache's kernels ---------------------------------

def cache_check(torch, ek, dev, gen, r, w, dtype, n_fam, kk):
    """The families kernels (and at F 1 the single-family wrappers) on F
    caches [r, w] of ``dtype`` and kk distinct slots (at K 5: R - 1, R and
    R + 1 among them): bit-equal to their plain versions, every family
    written in place, every other row unchanged."""
    label = f"cache kernels, {dtype} W {w}, F {n_fam}, K {kk}"
    caches = [(torch.rand(r, w, generator=gen, device=dev) * 100).to(dtype)
              for _ in range(n_fam)]
    slots = torch.randperm(r - 1, generator=gen, device=dev)[:kk] \
        .to(torch.int32)
    if kk == 5:
        slots[:3] = torch.tensor([r - 1, r, r + 1], device=dev)
    rows = (torch.rand(n_fam, kk, w, generator=gen, device=dev)
            * 100).to(dtype)
    orig = [c.clone() for c in caches]
    ptrs = [c.data_ptr() for c in caches]
    got = ek.gather_rows_families(caches, slots)
    out = ek.scatter_rows_families(caches, slots, rows)
    torch.cuda.synchronize()
    if not torch.equal(got, ek.gather_rows_families_ref(orig, slots)):
        fail(f"{label}: the gather differs from its plain version")
    if out is not caches or [c.data_ptr() for c in caches] != ptrs:
        fail(f"{label}: the scatter did not write in place")
    want = ek.scatter_rows_families_ref([o.clone() for o in orig], slots,
                                        rows)
    others = torch.ones(r, dtype=torch.bool, device=dev)
    others[slots[(slots >= 0) & (slots < r)].long()] = False
    for f, (c, wnt, o) in enumerate(zip(caches, want, orig)):
        if not torch.equal(c, wnt) or not torch.equal(c[others], o[others]):
            fail(f"{label}: family {f} after the scatter differs from its "
                 f"plain version")
    if n_fam == 1:
        one = orig[0].clone()
        g1 = ek.gather_rows(one, slots)
        ek.scatter_rows(one, slots, rows[0])
        torch.cuda.synchronize()
        if not (torch.equal(g1, got[0]) and torch.equal(one, caches[0])):
            fail(f"{label}: the single-family wrappers differ from the "
                 f"families kernels")


def cache_timing(torch, ek, dev, gen, flush, card, launch_floor, r, w,
                 n_fam, k, live):
    """Both families kernels on F fp32 caches [r, w] at a bucket of k slots
    whose first ``live`` are distinct and the rest padding (the gather's
    the pad slot R - 1, the scatter's the dropped R + 1), as the cache
    issues them: first held bit-equal to their plain versions on these
    inputs (the scatter on clones of the caches), then timed by events and
    by device time after the L2 flush, beside the plain version, F calls
    of the library (``index_select`` over the slots, ``index_copy_`` over
    the kept ones; device time summed), the bound (bytes over 3.35 TB/s,
    all F families: the gather's slots, distinct rows read and K rows
    written; the scatter's slots and kept rows, read and written) and the
    device time of ``launch_floor`` on the gather's grid."""
    label = f"F {n_fam} x [{r}x{w}] fp32, K {k} ({live} live)"
    caches = [torch.randn(r, w, generator=gen, device=dev)
              for _ in range(n_fam)]
    distinct = torch.randperm(r - 1, generator=gen, device=dev)[:live] \
        .to(torch.int32)
    g_slots = torch.full((k,), r - 1, dtype=torch.int32, device=dev)
    s_slots = torch.full((k,), r + 1, dtype=torch.int32, device=dev)
    g_slots[:live] = s_slots[:live] = distinct
    rows = torch.randn(n_fam, k, w, generator=gen, device=dev)
    pairs = {
        "cache_gather_rows": [(ek.gather_rows_families(caches, g_slots),
                               ek.gather_rows_families_ref(caches,
                                                           g_slots))],
        "cache_scatter_rows": list(zip(
            ek.scatter_rows_families([c.clone() for c in caches], s_slots,
                                     rows),
            ek.scatter_rows_families_ref([c.clone() for c in caches],
                                         s_slots, rows)))}
    torch.cuda.synchronize()
    gathered = g_slots.long()
    kept, kept_rows = distinct.long(), rows[:, :live]
    read = live + (1 if k > live else 0)           # the pad row once
    out = {}
    for name, fn, ref, lib, nbytes in (
            ("cache_gather_rows",
             lambda: ek.gather_rows_families(caches, g_slots),
             lambda: ek.gather_rows_families_ref(caches, g_slots),
             lambda: [c.index_select(0, gathered) for c in caches],
             k * 4 + n_fam * w * 4 * (read + k)),
            ("cache_scatter_rows",
             lambda: ek.scatter_rows_families(caches, s_slots, rows),
             lambda: ek.scatter_rows_families_ref(caches, s_slots, rows),
             lambda: [c.index_copy_(0, kept, kr)
                      for c, kr in zip(caches, kept_rows)],
             k * 4 + 2 * n_fam * w * 4 * live)):
        if not all(torch.equal(a, b) for a, b in pairs[name]):
            fail(f"{name} {label}: differs from its plain version on the "
                 f"inputs it is timed on")
        row = out[name] = {
            "max_abs_err": max((a - b).abs().max().item()
                               for a, b in pairs[name]),
            "ms": time_ms(torch, fn, flush),
            "device_ms": flushed_device_ms(torch, fn, flush),
            "plain_ms": time_ms(torch, ref, flush),
            "library_ms": time_ms(torch, lib, flush),
            "library_device_ms": flushed_device_ms(torch, lib, flush),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes": nbytes, "k": k, "live": live,
            "families": n_fam, "cache": [r, w]}
        print(f"[{card}] {name} {label}: bit-equal to its plain version; "
              f"kernel {row['ms'] * 1e3:.2f} us (device "
              f"{us(row['device_ms'])}), plain {row['plain_ms'] * 1e3:.2f} "
              f"us, library x {n_fam} {row['library_ms'] * 1e3:.2f} us "
              f"(device {us(row['library_device_ms'])}), bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({nbytes / 1e6:.3f} MB)")
    # the gather's grid at these 4-byte words: a thread a word, 256 a
    # block, below one wave
    blocks = -(-k * w // 256)

    def floor():
        err = launch_floor(blocks, 256,
                           torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"the empty kernel did not launch: CUDA error {err}")
    out["floor_device_ms"] = flushed_device_ms(torch, floor, flush)
    out["floor_blocks"] = blocks
    return out


def cache_kernel_phase(torch, dev, card, launch_floor, shape=CACHE_ROWS,
                       k=CACHE_K, widths=CACHE_WIDTHS, bucket=CACHE_BUCKET):
    """The cache's families gather and in-place scatter: held bit-equal to
    their plain versions at F 1, 2 and 3, every word width (``widths``), K
    5 (slots R - 1, R and R + 1 among them) and K distinct slots
    (``cache_check``); then timed at deepfm's cache [32769, 17] fp32, F 1
    and F 3, at K distinct slots and at phase 17's most used bucket
    (``cache_timing``, each shape first held bit-equal on the inputs it is
    timed on), beside ``launch_floor`` (the empty kernel of
    ``FLOOR_SOURCE``) on the gather's grid: the floor of one launch, device
    time. Returns the kernels' rows at F 3
    and the bucket (the main path's shape), each with every timed shape
    under ``shapes``."""
    from paddle_tpu_torch.ops.kernels import embed_cache as ek
    r, w = shape
    gen = torch.Generator(device=dev).manual_seed(16)
    for width, dtype in widths:
        for n_fam in (1, 2, 3):
            for kk in (5, k):
                cache_check(torch, ek, dev, gen, r, width,
                            getattr(torch, dtype), n_fam, kk)
    print(f"[{card}] cache kernels at R {r}: gather and scatter bit-equal "
          f"to their plain versions at F 1, 2, 3, W "
          f"{', '.join(f'{a} {b}' for a, b in widths)} (4-, 16-, 8- and "
          f"1-byte words), K 5 (slots R - 1, R, R + 1) and K {k}; every "
          f"family written in place, every other row unchanged; at F 1 the "
          f"single-family wrappers equal them")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    shapes = {}
    for kk, live in ((k, k), bucket):
        for n_fam in (1, CACHE_FAMILIES):
            shapes[f"K{kk}/F{n_fam}"] = cache_timing(
                torch, ek, dev, gen, flush, card, launch_floor, r, w, n_fam,
                kk, live)
    del flush
    main = shapes[f"K{bucket[0]}/F{CACHE_FAMILIES}"]
    results = {}
    for name in ("cache_gather_rows", "cache_scatter_rows"):
        results[name] = dict(main[name], floor_device_ms=main[
            "floor_device_ms"], shapes={
                key: dict(res[name], floor_device_ms=res["floor_device_ms"])
                for key, res in shapes.items()})
    print(f"[{card}] cache kernels: an empty kernel on the gather's grid "
          f"takes " + ", ".join(f"{key.split('/')[0]} "
                                f"({res['floor_blocks']} blocks) "
                                f"{us(res['floor_device_ms'])}"
                                for key, res in shapes.items()
                                if key.endswith("/F1"))
          + " of device time (the floor of one launch)")
    return results


# -- phase 17: deepfm over the hot-rows cache --------------------------------

def zipf_feeds(steps, batch, fields, vocab, a=ZIPF_A, seed=11):
    """Per step (ids [B, F, 1] int64, label [B, 1] fp32): truncated zipf(a)
    ids, rank r of [1, vocab] with probability ~ r**-a (id r - 1), and the
    label ``ids[:, 0, 0] % 2``."""
    rng = np.random.RandomState(seed)
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -a
    p /= p.sum()
    out = []
    for _ in range(steps):
        ids = rng.choice(vocab, size=(batch, fields, 1), p=p).astype(np.int64)
        out.append((ids, (ids[:, 0, 0] % 2).astype(np.float32)[:, None]))
    return out


def deepfm_weights(cfg, seed: int) -> dict:
    """Seeded weights under the JAX scope names of deepfm's build: the
    table uniform in [-0.01, 0.01], the fc weights Xavier-uniform, the
    biases 0."""
    from paddle_tpu_torch.models import deepfm
    rng = np.random.RandomState(seed)
    shapes = deepfm.param_shapes(cfg["num_fields"], cfg["vocab_size"],
                                 cfg["embed_dim"])
    out = {"deepfm_emb": rng.uniform(-0.01, 0.01, shapes["emb"]).astype(
        np.float32)}
    for i in range(len(deepfm.HIDDEN) + 1):
        w = shapes[f"fc_w{i}"]
        bound = (6.0 / (w[0] + w[1])) ** 0.5
        out[f"fc_{i}.w_0"] = rng.uniform(-bound, bound, w).astype(np.float32)
        out[f"fc_{i}.b_0"] = np.zeros(shapes[f"fc_b{i}"], np.float32)
    return out


def bucket_counts(calls):
    """{bucket: {"calls", "median_rows"}} of (bucket, rows) pairs."""
    return {str(b): {"calls": sum(1 for bb, _ in calls if bb == b),
                     "median_rows": int(np.median([n for bb, n in calls
                                                   if bb == b]))}
            for b in sorted({b for b, _ in calls})}


class Split:
    """Host time of the cache's parts inside a step: each wrapped call adds
    its wall time to ``ms[name]`` (pull and write-back end in host copies,
    so they include the waits on the card)."""

    def __init__(self, cache, client):
        self.ms = {"pull": 0.0, "write_back": 0.0, "install": 0.0}
        for obj, attr, name in ((client, "pull_rows", "pull"),
                                (cache, "_writeback", "write_back"),
                                (cache, "_device_set_rows", "install")):
            setattr(obj, attr, self._timed(getattr(obj, attr), name))

    def _timed(self, fn, name):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.ms[name] += (time.perf_counter() - t0) * 1e3
        return call


def deepfm_cached_steps(torch, dev, model, opt, cache, feeds, split=None):
    """Train steps over the cache: translate on the host, then the model
    step, ending in a synchronize. Per step: loss, ms of the translate,
    of the model step and of the cache's parts, and the cache's counters
    after it (its families' hits, misses and evictions since the call)."""
    from paddle_tpu_torch.ops import embed_cache as ec
    fams = {"hits": ec.CACHE_HITS, "misses": ec.CACHE_MISSES,
            "evictions": ec.CACHE_EVICTIONS}
    fams = {k: f.labels(param=cache.table) for k, f in fams.items()}
    base = {k: c.value for k, c in fams.items()}
    out = []
    for ids, label in feeds:
        before = dict(split.ms) if split else {}
        t0 = time.perf_counter()
        slots = cache.translate(ids)
        t1 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss, _ = model(torch.from_numpy(slots).to(dev),
                        torch.from_numpy(label).to(dev))
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rec = {"loss": float(loss.detach()), "translate_ms": (t1 - t0) * 1e3,
               "model_ms": (t2 - t1) * 1e3, "step_ms": (t2 - t0) * 1e3,
               **{k: int(c.value - base[k]) for k, c in fams.items()},
               "lookups": cache.lookups,
               "hit_lookups": cache.hit_lookups, "installs": cache.installs,
               "writebacks": cache.writebacks}
        if split:
            rec.update({f"{k}_ms": split.ms[k] - before[k] for k in split.ms})
        out.append(rec)
    return out


def deepfm_phase(torch, dev, card, cfg=None, batch=DEEPFM_BATCH,
                 steps=DEEPFM_STEPS, capacity=CACHE_CAPACITY,
                 shards=DEEPFM_SHARDS, profile_steps=PROFILE_STEPS,
                 oracle_steps=DEEPFM_ORACLE_STEPS):
    """deepfm's build() trained over the hot-rows cache of a table on
    ``shards`` in-process row-range shards (capacity ``capacity``), on
    seeded zipf ids, TF32 off, against the same model on one table on the
    card (the twin) and, for the first steps, on the CPU. Counts zeroed
    just before the steps and the final flush and read just after: every
    launch is a cache kernel, the scatter's 1 a call that installed, the
    gather's 1 a call that wrote back (the flush's included), each for all
    the families. Then the step time and host split of both arms, the
    cache's rates, memory and a profiler window; one over a warmup of the
    cache must name both cache kernels."""
    from paddle_tpu_torch.distributed import sharded_table as st
    from paddle_tpu_torch.models import convert, deepfm
    from paddle_tpu_torch.ops import embed_cache as ec
    cfg = dict(DEEPFM if cfg is None else cfg)
    v, k1 = cfg["vocab_size"], cfg["embed_dim"] + 1
    t0 = time.perf_counter()
    feeds = zipf_feeds(steps + profile_steps, batch, cfg["num_fields"], v)
    state = convert.deepfm_params_from_jax(deepfm_weights(cfg, 17))
    gen_s = time.perf_counter() - t0

    def make(device):
        model, opt, _ = deepfm.build(**cfg, device=device)
        model.load_state_dict(state)
        return model, opt

    # the twin: one [V, 1 + K] table on the card
    twin, twin_opt = make(dev)
    twin_feeds = [tuple(torch.from_numpy(a).to(dev) for a in f)
                  for f in feeds[:steps]]
    reset_all_launches()
    torch.cuda.synchronize()
    twin_losses, twin_ms, _ = train(torch, twin, twin_opt, twin_feeds)
    if any(all_launches().values()):
        fail(f"deepfm twin: launched {all_launches()}")

    # the cached arm
    model, opt = make(dev)
    client = st.in_process_fleet(v, shards)
    client.seed_from_value("deepfm_emb", state["emb"].numpy())
    t0 = time.perf_counter()
    cache = ec.enable_sharded_table(model.emb, opt, client, capacity)
    enable_s = time.perf_counter() - t0
    split = Split(cache, client)
    sizes = {"install": [], "write_back": []}      # (bucket, rows) a call

    def sized(fn, key):
        def call(slots, *args):
            sizes[key].append((ec.bucket(slots.size), int(slots.size)))
            return fn(slots, *args)
        return call
    cache._device_set_rows = sized(cache._device_set_rows, "install")
    cache._device_get_rows = sized(cache._device_get_rows, "write_back")
    ptrs = lambda: (model.emb.data_ptr(),  # noqa: E731
                    *(opt.state[model.emb][m].data_ptr()
                      for m in ("moment1", "moment2")))
    ptr0 = ptrs()
    bytes0 = dict(client.bytes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    recs = deepfm_cached_steps(torch, dev, model, opt, cache, feeds[:steps],
                               split)
    flushed = cache.flush()
    torch.cuda.synchronize()
    launched = all_launches()
    peak = int(torch.cuda.max_memory_allocated())
    gathers, scatters = (launched.pop(f"embed_cache.{n}")
                         for n in ("gather_rows", "scatter_rows"))
    if any(launched.values()):
        fail(f"deepfm over the cache: launched {launched} beside the cache "
             f"kernels")
    if scatters != cache.installs or gathers != cache.writebacks:
        fail(f"deepfm over the cache: {scatters} scatter and {gathers} "
             f"gather launches for {cache.installs} installs and "
             f"{cache.writebacks} write-backs (the flush's included)")
    if not scatters or not gathers:
        fail("deepfm over the cache: a cache kernel was never launched")
    wrote = sum(1 for a, b in zip([{"writebacks": 0}] + recs, recs)
                if b["writebacks"] > a["writebacks"])
    if wrote < 10:
        fail(f"deepfm over the cache: only {wrote} steps wrote back")
    if ptrs() != ptr0:
        fail("deepfm over the cache: the table or a moment changed storage")
    losses = [r["loss"] for r in recs]
    if not all(np.isfinite(losses)) or not np.allclose(
            losses, twin_losses, rtol=DEEPFM_RTOL, atol=0.0):
        fail(f"deepfm over the cache: losses {losses} differ from the "
             f"single-table twin's {twin_losses} beyond rtol {DEEPFM_RTOL}")
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, twin_losses))
    touched = np.unique(np.concatenate([f[0].reshape(-1)
                                        for f in feeds[:steps]]))
    pulled = torch.from_numpy(client.pull_rows(
        "deepfm_emb", touched, families=[("param", k1)])["param"])
    want_rows = twin.emb.detach()[torch.from_numpy(touched).to(dev)].cpu()
    rows_err = float((pulled - want_rows).abs().max())
    if not torch.allclose(pulled, want_rows, **DEEPFM_ROWS_TOL):
        fail(f"deepfm over the cache: after the flush the shards' rows "
             f"differ from the twin's table (max abs err {rows_err}, "
             f"tolerance {DEEPFM_ROWS_TOL})")
    n_steps = len(recs)
    per = lambda key: [b[key] - a[key] for a, b in  # noqa: E731
                       zip([dict.fromkeys(recs[0], 0)] + recs, recs)]
    hits, misses, evictions = per("hits"), per("misses"), per("evictions")
    lookups, hit_lookups = per("lookups"), per("hit_lookups")
    moved = {d: sum(n - bytes0[(d, sh)] for (dd, sh), n
                    in client.bytes.items() if dd == d)
             for d in ("pull", "push")}
    p50 = float(np.median([r["step_ms"] for r in recs]))
    twin_p50 = float(np.median(twin_ms))
    warm = recs[6:]                      # past the cold fill
    stats = {
        "losses": losses, "twin_losses": twin_losses,
        "max_rel_diff_to_twin": loss_gap, "rows_max_abs_err": rows_err,
        "touched_rows": int(touched.size), "step_ms": [r["step_ms"]
                                                       for r in recs],
        "step_p50_ms": p50, "examples_per_s": batch / p50 * 1e3,
        "twin_step_p50_ms": twin_p50,
        "twin_examples_per_s": batch / twin_p50 * 1e3,
        "host_split_p50_ms": {key: float(np.median([r[f"{key}_ms"]
                                                    for r in recs]))
                              for key in ("translate", "pull", "write_back",
                                          "install", "model")},
        "host_split_p50_ms_past_step_6": {
            key: float(np.median([r[f"{key}_ms"] for r in warm]))
            for key in ("translate", "pull", "write_back", "install",
                        "model")},
        "hit_rate_unique": sum(hits) / max(1, sum(hits) + sum(misses)),
        "hit_rate_occurrence": sum(hit_lookups) / max(1, sum(lookups)),
        "hit_rate_unique_past_step_6": sum(hits[6:]) / max(
            1, sum(hits[6:]) + sum(misses[6:])),
        "hit_rate_occurrence_past_step_6": sum(hit_lookups[6:]) / max(
            1, sum(lookups[6:])),
        "misses_per_step": misses, "evictions_per_step": evictions,
        "pull_bytes_per_step": moved["pull"] / n_steps,
        "push_bytes_per_step": moved["push"] / n_steps,
        "installs": cache.installs, "writebacks": cache.writebacks,
        "steps_that_wrote_back": wrote, "flushed_rows": flushed,
        "launches": {"gather_rows": gathers, "scatter_rows": scatters},
        **{f"{key}_buckets": bucket_counts(calls)
           for key, calls in sizes.items()},
        "peak_mem_bytes": peak, "feeds_s": gen_s, "enable_s": enable_s,
        "capacity": capacity, "shards": shards, "batch": batch,
        "occupancy": ec.CACHE_OCCUPANCY.labels(param=cache.table).value}
    for key in sizes:
        common = max(stats[f"{key}_buckets"],
                     key=lambda b: stats[f"{key}_buckets"][b]["calls"])
        stats[f"most_used_{key}_bucket"] = [
            int(common), stats[f"{key}_buckets"][common]["median_rows"]]
    print(f"[{card}] deepfm (26 fields, V {v}, K {k1 - 1}, fc 400 x 3, lazy "
          f"Adam {cfg['lr']}), batch {batch}, {steps} steps over a "
          f"{capacity}-row cache on {shards} shards: losses "
          f"{[round(x, 5) for x in losses]}; the single-table twin's within "
          f"rtol {DEEPFM_RTOL} (max rel diff {loss_gap:.3g}); after the "
          f"flush ({flushed} rows) the shards hold the twin's rows "
          f"({touched.size} touched, max abs err {rows_err:.3g}); storage "
          f"kept")
    print(f"[{card}] deepfm cache kernels: {scatters} scatter launches for "
          f"{cache.installs} installs, {gathers} gather launches for "
          f"{cache.writebacks} write-backs (flush included; all "
          f"{CACHE_FAMILIES} families a launch), {wrote} steps wrote back; "
          f"buckets (calls, median rows): install "
          f"{stats['install_buckets']}, write-back "
          f"{stats['write_back_buckets']}; most used (bucket, median rows): "
          f"install {stats['most_used_install_bucket']}, write-back "
          f"{stats['most_used_write_back_bucket']}")
    print(f"[{card}] deepfm step p50 {p50:.3f} ms = "
          f"{stats['examples_per_s']:.0f} examples/s over the cache, twin "
          f"{twin_p50:.3f} ms = {stats['twin_examples_per_s']:.0f} "
          f"examples/s; host split p50 (ms) "
          + ", ".join(f"{k} {x:.3f}" for k, x in
                      stats["host_split_p50_ms"].items())
          + "; past step 6 "
          + ", ".join(f"{k} {x:.3f}" for k, x in
                      stats["host_split_p50_ms_past_step_6"].items()))
    print(f"[{card}] deepfm cache: hit rate {stats['hit_rate_unique']:.4f} "
          f"by unique id, {stats['hit_rate_occurrence']:.4f} by occurrence "
          f"({stats['hit_rate_unique_past_step_6']:.4f} / "
          f"{stats['hit_rate_occurrence_past_step_6']:.4f} past step 6); "
          f"misses a step {misses}; evictions a step {evictions}; pull "
          f"{stats['pull_bytes_per_step'] / 1e6:.3f} MB, push "
          f"{stats['push_bytes_per_step'] / 1e6:.3f} MB a step; peak memory "
          f"{peak / 2 ** 20:.1f} MiB")
    if profile_steps:
        stats["profile"] = prof = profile_calls(
            torch, lambda: deepfm_cached_steps(torch, dev, model, opt, cache,
                                               feeds[steps:]),
            profile_steps)
        prof["idle_share_at_p50"] = 1.0 - prof[
            "device_busy_ms_per_step"] / p50
        # by name, the kernels of the cache's install and read at every
        # bucket (warmup: installs to the dropped slot, reads of the pad
        # slot; nothing resident changes), counted as they launch
        named, want = named_launches(
            torch, cache.warmup, {"cache_scatter": "embed_cache.scatter_rows",
                                  "cache_gather": "embed_cache.gather_rows"})
        if not all(want.values()) or not all(named.values()) or any(
                named[fam] > want[fam] for fam in want):
            fail(f"deepfm cache: kernels by profiler name {named} for the "
                 f"launches {want} of a warmup")
        print(f"[{card}] deepfm profile: " + family_line(prof)
              + f"; a warmup of the cache (its buckets 8 to "
              f"{ec.bucket(capacity)}, all {CACHE_FAMILIES} families a "
              f"launch): {named} kernels by name for {want} launches")
        print(f"[{card}] deepfm profile ({profile_steps} steps over the "
              f"cache): host {prof['host_ms_per_step']:.3f} ms/step, device "
              f"busy {prof['device_busy_ms_per_step']:.3f} ms/step, idle "
              f"share {prof['idle_share']:.3f} "
              f"({prof['idle_share_at_p50']:.3f} against the step p50), "
              f"{prof['launches_per_step']:.0f} launches/step")
        for key, us, count in prof["top_kernels"]:
            print(f"    {us:10.1f} us/step {count:6.1f}/step  {key}")
    del model, opt, twin, twin_opt
    t0 = time.perf_counter()
    want_losses = train_oracle(torch, make, None, feeds, oracle_steps)
    stats["oracle_losses"] = want_losses
    stats["oracle_max_rel_diff"] = check_oracle(
        "deepfm over the cache", losses, want_losses, card, t0)
    return {"gather_rows": gathers, "scatter_rows": scatters}, stats


# -- phase 18: the image classifiers ----------------------------------------

# (label, module of paddle_tpu_torch.models, build kwargs, bench.py's batch:
# bench.py:120-126), in the order the roadmap ports them
IMAGE_MODELS = (("mnist", "mnist", {}, 2048),
                ("smallnet", "smallnet", {}, 512),
                ("alexnet", "alexnet", {}, 256),
                ("resnet50", "resnet", {"depth": 50}, 128),
                ("googlenet", "googlenet", {}, 128),
                ("vgg16", "vgg", {}, 64),
                ("se_resnext50", "se_resnext", {}, 64))
IMAGE_STEPS = 6                    # the first also plans cuDNN's convs
IMAGE_BATCHES = 2                  # distinct seeded batches, in turn
IMAGE_ORACLE_BATCH = 8
IMAGE_ORACLE_STEPS = 3
# the card against the CPU at lr 1e-4: at the builds' rates (0.1 for the
# ResNets) the first step doubles the loss on random labels, and two
# correct fp32 runs whose sums differ in order part by 1e-3 to 3e-2 by the
# third loss (the CPU in fp32 against fp64 at batch 8, 224 px: vgg16 2.8e-2,
# resnet50 1.5e-3); at 1e-4 they agree within 3e-4
IMAGE_ORACLE_LR = 1e-4
IMAGE_AMP = "resnet50"             # the reference's headline (bench.py:15)
# what cuDNN's and cuBLAS's conv and GEMM kernels carry in their names
CONV_MARKS = ("conv", "xmma", "cudnn", "implicit", "wgrad", "dgrad",
              "fprop", "gemm", "cutlass")


def image_feeds(torch, dev, batch, shape, classes, seed, n=IMAGE_BATCHES):
    """``n`` seeded (images in [0, 1), labels of ``classes``) batches,
    made on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.rand((batch,) + shape, generator=gen, device=dev),
             torch.randint(0, classes, (batch, 1), generator=gen,
                           device=dev))
            for _ in range(n)]


def image_flops(torch, model, data):
    """FLOPs of one training step: 3x the forward's multiply-adds of every
    conv and fc, counted from the shapes (a conv's data and weight
    gradients each cost its forward), x2 for multiply and add."""
    from paddle_tpu_torch import layers
    macs = [0]

    def conv(m, inp, out):
        kh, kw = m.weight.shape[2:]
        macs[0] += out.numel() * (m.weight.shape[1]) * kh * kw

    def fc(m, inp, out):
        macs[0] += out.numel() * m.weight.shape[0]
    hooks = [m.register_forward_hook(conv if isinstance(m, layers.Conv2D)
                                     else fc)
             for m in model.modules()
             if isinstance(m, (layers.Conv2D, layers.FC))]
    try:
        with torch.no_grad():
            model.predict(data)
    finally:
        for h in hooks:
            h.remove()
    return 3 * 2 * macs[0]


def image_run(torch, dev, card, label, make, state, feeds, batch, steps,
              profile_steps, amp=False):
    """Train ``make(dev)``'s model from ``state`` for ``steps`` steps on
    ``feeds`` (in turn), then a profiler window; -> the run's numbers."""
    from paddle_tpu_torch.contrib.mixed_precision import rewrite_program_amp
    model, opt = make(dev)
    model.load_state_dict(state)
    if amp:
        rewrite_program_amp(model)
    feeds = [feeds[i % len(feeds)] for i in range(steps + profile_steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    losses, step_ms, _ = train(torch, model, opt, feeds[:steps])
    if any(all_launches().values()):
        fail(f"{label}: a kernel of the port launched: {all_launches()}")
    if not all(np.isfinite(losses)):
        fail(f"{label}: losses {losses} are not finite")
    p50 = float(np.median(step_ms[1:]))
    stats = {"batch": batch, "losses": losses, "step_ms": step_ms,
             "first_step_ms": step_ms[0], "step_p50_ms": p50,
             "images_per_s": batch / p50 * 1e3,
             "peak_mem_bytes": int(torch.cuda.max_memory_allocated())}
    prof = profile_window(torch, model, opt, feeds[steps:])
    busy = prof["device_busy_ms_per_step"]
    prof["idle_share_at_p50"] = 1.0 - busy / p50
    stats["profile"] = prof
    print(f"[{card}] {label}{' (pure AMP)' if amp else ''}, batch {batch}: "
          f"losses {[round(x, 4) for x in losses]}; first step "
          f"{step_ms[0]:.1f} ms, step p50 {p50:.3f} ms = "
          f"{stats['images_per_s']:.1f} images/s; device busy "
          f"{busy:.3f} ms/step, idle share {prof['idle_share']:.3f} "
          f"({prof['idle_share_at_p50']:.3f} against the step p50); peak "
          f"memory {stats['peak_mem_bytes'] / 2 ** 20:.1f} MiB; "
          f"{prof['launches_per_step']:.0f} launches/step; conv and GEMM "
          f"kernels {prof['conv_gemm_share']:.3f} of device time")
    for key, us_, count in prof["top_kernels"]:
        print(f"    {us_:10.1f} us/step {count:6.1f}/step  {key}")
    del model, opt
    return stats


def image_phase(torch, dev, card, models=IMAGE_MODELS, steps=IMAGE_STEPS,
                profile_steps=PROFILE_STEPS, oracle_batch=IMAGE_ORACLE_BATCH,
                oracle_steps=IMAGE_ORACLE_STEPS, image_size=None):
    """The seven image classifiers of bench.py trained on the card at their
    ``build`` defaults and bench.py's batches in fp32 (and ResNet-50 under
    pure AMP), each held against the same model on the CPU at a cut batch;
    no kernel of the port runs on this path. ``image_size`` (the CPU
    rehearsal) overrides the 224 of the ImageNet models."""
    import importlib
    from paddle_tpu_torch import layers
    out = {}
    for i, (label, module, kw, batch) in enumerate(models):
        mod = importlib.import_module(f"paddle_tpu_torch.models.{module}")
        kw = dict(kw)
        if image_size is not None and module not in ("mnist", "smallnet"):
            kw.update(image_size=image_size)
        size = {"mnist": 28, "smallnet": 32}.get(module,
                                                 kw.get("image_size", 224))
        shape = (1 if module == "mnist" else 3, size, size)
        classes = 10 if module in ("mnist", "smallnet") else 1000

        def make(device, lr=None, mod=mod, kw=kw):
            model, opt, _ = mod.build(device=device, **kw, **(
                {} if lr is None else {"lr": lr}))
            for j, m in enumerate(model.modules()):
                if isinstance(m, layers.Dropout):      # the same masks on
                    m.generator = torch.Generator()    # both devices
                    m.generator.manual_seed(100 + j)
            return model, opt
        cpu_model, _ = make("cpu")
        cpu_model.reset_parameters(torch.Generator().manual_seed(30 + i))
        state = {k: v.clone() for k, v in cpu_model.state_dict().items()}
        del cpu_model
        feeds = image_feeds(torch, dev, batch, shape, classes, 40 + i)
        flops = image_flops(torch, make(dev)[0], feeds[0][0])
        t0 = time.perf_counter()
        stats = image_run(torch, dev, card, label, make, state, feeds, batch,
                          steps, profile_steps)
        stats["flops_per_step"] = flops
        stats["tflops_per_s"] = flops / stats["step_p50_ms"] / 1e9
        stats["fp32_bound_ms"] = flops / FP32_FLOPS_PER_S * 1e3
        stats["bf16_bound_ms"] = flops / BF16_FLOPS_PER_S * 1e3
        print(f"[{card}] {label}: {flops / 1e12:.3f} TFLOP a step "
              f"(convs and fcs, 3x the forward) = "
              f"{stats['tflops_per_s']:.1f} TFLOP/s at the p50; bound "
              f"{stats['fp32_bound_ms']:.2f} ms at 67 TFLOP/s fp32, "
              f"{stats['bf16_bound_ms']:.3f} ms at 989 TFLOP/s bf16; "
              f"{time.perf_counter() - t0:.1f} s")
        if label == IMAGE_AMP:
            amp = image_run(torch, dev, card, label, make, state, feeds,
                            batch, steps, profile_steps, amp=True)
            n = AMP_CHECKED_STEPS
            if not np.allclose(amp["losses"][:n], stats["losses"][:n],
                               rtol=AMP_RTOL, atol=0.0):
                fail(f"{label} under AMP: losses {amp['losses'][:n]} differ "
                     f"from fp32's {stats['losses'][:n]} beyond rtol "
                     f"{AMP_RTOL}")
            amp["tflops_per_s"] = flops / amp["step_p50_ms"] / 1e9
            print(f"[{card}] {label} pure AMP against fp32: step p50 "
                  f"{amp['step_p50_ms']:.3f} / {stats['step_p50_ms']:.3f} ms,"
                  f" device busy {amp['profile']['device_busy_ms_per_step']:.3f}"
                  f" / {stats['profile']['device_busy_ms_per_step']:.3f} ms,"
                  f" idle share {amp['profile']['idle_share']:.3f} / "
                  f"{stats['profile']['idle_share']:.3f}, peak memory "
                  f"{amp['peak_mem_bytes'] / 2 ** 20:.1f} / "
                  f"{stats['peak_mem_bytes'] / 2 ** 20:.1f} MiB; the first "
                  f"{n} losses within rtol {AMP_RTOL}")
            stats["amp"] = amp
        del feeds
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        small = [tuple(a.cpu().numpy() for a in f) for f in image_feeds(
            torch, dev, oracle_batch, shape, classes, 50 + i,
            oracle_steps)]
        model, opt = make(dev, IMAGE_ORACLE_LR)
        model.load_state_dict(state)
        got, _, _ = train(torch, model, opt, [
            tuple(torch.from_numpy(a).to(dev) for a in f) for f in small])
        del model, opt
        want = train_oracle(torch, lambda d: make(d, IMAGE_ORACLE_LR),
                            state, small, oracle_steps)
        stats["oracle_batch"], stats["oracle_lr"] = oracle_batch, \
            IMAGE_ORACLE_LR
        stats["oracle_losses"], stats["card_losses"] = want, got
        stats["oracle_max_rel_diff"] = check_oracle(
            f"{label} at batch {oracle_batch}", got, want, card, t0)
        out[label] = stats
        torch.cuda.empty_cache()
    return out




def main():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from paddle_tpu_torch.ops.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    print(f"device: {name} x{count}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(card)

    t = time.perf_counter()
    floor_build = start_floor_build(build)
    try:
        reports = build.build()
    finally:
        launch_floor = floor_build()
    for src, rep in reports.items():
        keep = [ln.strip() for ln in rep.splitlines()
                if "registers" in ln or "spill" in ln
                or "Compiling entry" in ln]
        print(f"built {src} in {time.perf_counter() - t:.1f} s:\n  "
              + "\n  ".join(keep))

    measured = kernel_phase(torch, dev, card)
    flash = flash_phase(torch, dev, card)
    fce = fused_ce_phase(torch, dev, card)
    launches, per_layer, decode, served = slice_phase(torch, dev, card)
    spec = spec_phase(torch, dev, card, served, per_layer, decode)
    contiguous = contiguous_phase(torch, dev, card, served, decode)
    del served["lm"]         # phase 20 keeps only the host streams
    train_launches, per_step, runs = train_phase(torch, dev, card)
    lstm = rnn_phase(torch, dev, card, "LSTM")
    lstm_launches, lstm_per_step, lstm_run = lstm_train_phase(torch, dev,
                                                              card)
    gru = rnn_phase(torch, dev, card, "GRU")
    mt_launches, mt_run, mt_model = mt_train_phase(torch, dev, card)
    gen_launches, gen_run = mt_beam_phase(torch, dev, card, mt_model)
    del mt_model
    pools = pool_phase(torch, dev, card)
    tc_launches, tc_run = textconv_phase(torch, dev, card)
    op_launches, op_run = op_program_phase(torch, dev, card)
    cache_kernels = cache_kernel_phase(torch, dev, card, launch_floor)
    fm_launches, fm_run = deepfm_phase(torch, dev, card)
    image = image_phase(torch, dev, card)
    server = server_phase(torch, dev, card, served, per_layer)
    fleet = fleet_phase(torch, dev, card, served, server)
    del served
    for key in ("install", "write_back"):
        if fm_run[f"most_used_{key}_bucket"] != list(CACHE_BUCKET):
            fail(f"deepfm's most used {key} bucket (bucket, median rows) "
                 f"{fm_run[f'most_used_{key}_bucket']} is not the "
                 f"CACHE_BUCKET {list(CACHE_BUCKET)} that phase 16 timed")
    flash_launches = train_launches["fused_attention"]

    kernels = []
    for kname, key, line, codec in (
            ("gather_rows", "gather_rows/fp32", 78, "none"),
            ("gather_rows_dequant", "gather_rows_dequant/int8", 140,
             "int8")):
        m = measured[key]
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": f"paddle_tpu/ops/pallas/paged_attention.py:{line}",
            "launches": launches[kname],
            "max_abs_err": max(m["max_abs_err"],
                               m.get("edge_max_abs_err", 0.0)),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
            "kernel_us": m["ms"] * 1e3, "plain_us": m["plain_ms"] * 1e3,
            "library_us": m["library_ms"] * 1e3,
            "bound_us": m["bound_ms"] * 1e3,
            "device_ms": m["device_ms"],
            "library_device_ms": m["library_device_ms"],
            "launches_per_decode_step": per_layer,
            "decode_step": decode[codec],
            "launches_verify": spec[codec]["ngram"]["launches"][kname],
            "launches_server": server["launches"][kname],
            "launches_fleet": "not counted: phase 21's replicas launch "
                              "it in their own processes",
            "verify_step": spec[codec]["busy"],
            "launches_per_train_step": 0, "card": card})
    for kname, line in (("flash_fwd", "189"), ("flash_bwd", "481, :504"),
                        ("flash_dq", "481"), ("flash_dkv", "504")):
        m = flash[f"{kname}/full"]
        variants = list(FLASH_VARIANTS) + (
            ["full_bfloat16", "causal_dropout_bfloat16", "full_float16",
             "causal_dropout_float16"]
            if kname in ("flash_fwd", "flash_bwd") else [])
        entry = {
            "name": kname, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": flash_launches[kname],
            "launches_bf16":
                train_launches["amp_fused_attention"][kname],
            "max_abs_err": max(flash[f"{kname}/{v}"]["max_abs_err"]
                               for v in FLASH_VARIANTS),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
            "bound_simt_ms": m["bound_simt_ms"],
            "bound_tensor_ms": m["bound_tensor_ms"],
            "device_ms": m["device_ms"],
            "library_event_ms": m["library_event_ms"],
            "launches_per_train_step":
                flash_launches[kname] // TRAIN_STEPS, "kernel": m["route"],
            "card": card,
            "variants": {v: {key: flash[f"{kname}/{v}"][key] for key in
                             ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "device_ms", "max_abs_err",
                              "dtype")}
                         for v in variants}}
        if kname == "flash_bwd":
            entry["function_vs_library"] = {
                v: {key: flash[f"function/{v}"][key] for key in
                    ("function_device_ms", "library_device_ms",
                     "flash_bwd_device_ms", "library_kernel",
                     "library_kernel_ms")}
                for v in ("full", "causal", "full_bfloat16")}
        if kname in ("flash_dq", "flash_dkv"):
            entry["path"] = ("flash_bwd's route at key lengths above "
                             "512 or head widths above 128; timed here at "
                             "the main shape beside flash_bwd")
        kernels.append(entry)
    for kname, line in (("fused_ce_fwd", 185), ("fused_ce_bwd", 234)):
        m = fce[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": FCE_SOURCE,
            "replaces": f"paddle_tpu/ops/pallas/fused_ce.py:{line}",
            "launches": train_launches["fused_head"][kname],
            "launches_bf16": train_launches["amp_fused_head"][kname],
            "max_abs_err": max(m["max_abs_err"], m["edge_max_abs_err"]),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "launches_per_train_step": 1,
            "simt_bound_ms": m["simt_bound_ms"], "prep_ms": m["prep_ms"],
            "mixed": fce["mixed"],
            "bf16": {key: fce[f"{kname}/bf16"][key] for key in
                     ("ms", "plain_ms", "bound_ms", "library_ms", "prep_ms",
                      "max_abs_err")},
            "card": card})
    for kname, line in (("lstm_train_fwd", 171), ("lstm_train_bwd", 235)):
        m = lstm[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": LSTM_SOURCE,
            "replaces": f"paddle_tpu/ops/pallas/fused_rnn.py:{line}",
            "launches": lstm_launches[kname],
            "launches_under_amp": lstm_run["amp"]["launches"][kname],
            "max_abs_err": max(m["max_abs_err"], m["edge_max_abs_err"]),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None, "launches_per_train_step": lstm_per_step,
            "us_per_step": m["us_per_step"],
            "dense_bound_ms": m["dense_bound_ms"], "card": card,
            **{k: m[k] for k in ("kernel", "tf32x3_bound_ms",
                                 "simt_bound_ms", "loop_ms", "dw_ms",
                                 "grid_ms", "grid_loop_ms",
                                 "grid_max_abs_diff", "device_ms")
               if k in m}})
    for kname, line in (("gru_train_fwd", 379), ("gru_train_bwd", 424)):
        m = gru[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": LSTM_SOURCE,
            "replaces": f"paddle_tpu/ops/pallas/fused_rnn.py:{line}",
            "launches": mt_launches[f"fused_rnn.{kname}"],
            "max_abs_err": max(m["max_abs_err"], m["edge_max_abs_err"]),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None, "launches_per_train_step": MT_GRU_PER_STEP,
            "launches_per_generate": gen_launches[f"fused_rnn.{kname}"],
            "us_per_step": m["us_per_step"],
            "dense_bound_ms": m["dense_bound_ms"], "card": card,
            **{k: m[k] for k in ("kernel", "tf32x3_bound_ms",
                                 "simt_bound_ms", "device_ms", "loop_ms",
                                 "dw_ms", "rest_ms", "grid_ms",
                                 "grid_device_ms", "grid_loop_ms",
                                 "grid_max_abs_diff")
               if k in m}})
    for kname, source, path, line, launches, per_step in (
            ("seqpool", SEQPOOL_SOURCE, "seqpool", 94,
             tc_launches["seqpool.seqpool"], TEXTCONV_POOLS_PER_STEP),
            ("embed_pool", EMBED_SOURCE, "embed_pool", 100,
             op_launches["embed_pool.embed_pool"], 1)):
        m = pools[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": f"paddle_tpu/ops/pallas/{path}.py:{line}",
            "launches": launches,
            "max_abs_err": max(m["max_abs_err"], m["edge_max_abs_err"]),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
            "launches_per_train_step": per_step, "card": card,
            **{k: m[k] for k in ("rounds_ms", "warps", "faster_than_library",
                                 "kernel_device_ms", "library_device_ms",
                                 "device_ms", "modes_device_ms")
               if k in m}})
    for kname, key, line in (("cache_gather_rows", "gather_rows", 79),
                             ("cache_scatter_rows", "scatter_rows", 133)):
        m = cache_kernels[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": CACHE_SOURCE,
            "replaces": f"paddle_tpu/ops/pallas/embed_cache.py:{line}",
            "launches": fm_launches[key], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
            "launches_per_train_step": fm_launches[key] / DEEPFM_STEPS,
            "card": card, **{k: m[k] for k in (
                "device_ms", "library_device_ms", "floor_device_ms", "k",
                "live", "families", "shapes")}})
    wide = {key: row for res in (flash, fce, lstm, gru)
            for key, row in res.items()
            if key.split("/")[-1][1:].isdigit()}     # .../d48, .../h1024
    bf16 = measured["gather_rows/bf16"]
    print(json.dumps({"gather_rows_bf16": bf16, "decode_steps": decode,
                      "speculative": spec, "card": card}))
    print(json.dumps({"flash": {key: row for key, row in flash.items()
                                if not key.startswith("block/")},
                      "card": card}))
    print(json.dumps({"training": runs, "card": card}))
    print(json.dumps({"lstm_kernels": lstm, "lstm_training": lstm_run,
                      "card": card}))
    print(json.dumps({"gru_kernels": gru, "mt_training": mt_run,
                      "mt_generate": gen_run, "card": card}))
    print(json.dumps({"wide_kernels": wide, "pool_kernels": pools,
                      "textconv_training": tc_run, "op_program": op_run,
                      "card": card}))
    print(json.dumps({"attention_blocks": {
        key: row for key, row in flash.items() if key.startswith("block/")},
        "cache_kernels": cache_kernels, "deepfm_training": fm_run,
        "card": card}))
    print(json.dumps({"image_classifiers": image, "card": card}))
    print(json.dumps({"contiguous_layout": contiguous, "card": card}))
    print(json.dumps({"server": server, "card": card}))
    print(json.dumps({"fleet": fleet, "card": card}, default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
