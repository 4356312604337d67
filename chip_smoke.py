"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]
        [--only e1|swinir|w96|metasr|int8|xdata|zoo|convzoo|ckpt|parallel
         |bundle ...] [--dp-devices cuda:0 cuda:1 ...]

Drives the port's main paths -- the tester (``python -m
rdst_tpu_torch.test``) on the committed weights of the README quality
rows; the shipped RDST-E1 x4 config with its
committed weights, served over HTTP by ``rdst_tpu_torch.serving`` in
float32 and in bfloat16 (``inference_dtype='bfloat16'``) and trained in
bfloat16; the shipped SwinIR-std x4 configs, served and trained in
bfloat16; the shipped RDST-W96 x4 config, served in float32 as shipped
and in bfloat16 with int8 qkv; the shipped MetaSR config, tested, served
and trained at fractional scales, and RDST-E1 built scale-free on the
same MetaUpSampler tail -- and holds every CUDA kernel of those paths
against its plain PyTorch version on the card. Phases, each
printed with its seconds (the 20-phantom corpus is generated once,
after the build):

1. the card (``nvidia-smi`` name and power limit);
2. build every kernel source with ``nvcc`` (one process per source, all
   started together), with each ptxas report of registers and spills;
3. the f32 block kernel (six token-parallel kernels, 3xTF32 products)
   vs its plain version and the staged plain version of its phases at
   the main path's shapes (bucket 64: 64 slices x 20 windows): CUDA-event
   times, both bounds (f32 FMA and 3xTF32, the row taking the smaller),
   two launches bitwise equal, kernels a call and device time by phase
   (torch.profiler); then the same at C = 192 (RDST-W96's widest DSTL)
   and C = 180 (SwinIR-std's first RSTB), with their committed weights;
4. the f32 model on 8 seeded 40x32 LR slices: kernel path vs plain
   path, finite, and the launch count per forward;
5. f32 serving: an ``InferenceServer`` on 127.0.0.1, warmed over the
   bucket ladder, answers a 1-slice, an 8-slice and a burst of 8
   concurrent 1-slice requests (coalesced by the batcher), each equal to
   a direct ``predict``; then p50 latency and slices/s per bucket. Launch
   counts are set to 0 just before this phase and read just after it;
6. device time of one f32 bucket-64 forward by kernel group
   (torch.profiler) and the device's idle share;
7. the bf16 kernels vs their plain versions at bucket 64 with the
   flagship's own weights: the fast block at the six (C, shift) variants
   under 'clamp' (the flagship's resolved variant) and 'stable_bc', in
   the design its plan picks (the persistent window kernel up to C =
   120: two launches bitwise equal at every variant) and the
   token-parallel forward timed beside it, each with its kernels a call,
   bitwise repeat and device time by phase; at C = 60 the window kernel
   also without its tensor-core turns (bitwise the same, timed beside
   it); the ptxas report of the window kernel (spills and wgmma
   serialization refused); int8 qkv at C = 96 on a seeded block, which
   the plan routes to the token-parallel forward, against its plain
   version and timed; the pair at C = 60/90/120, the RDSTB on the flagship
   geometry; CUDA-event times of the launch alone, plain time, bound,
   max and mean relative error (bar 0.02); for the pair and the RDSTB
   (stage kernels on ``csrc/window_body.cuh``) also the error against
   their staged plain versions, kernels a call, two calls bitwise equal
   and device time per stage kernel (torch.profiler); then both at
   16-token windows (window 4, random weights, 8 images) against their
   plain and staged versions, and the fast block's window kernel there at
   C = 60 and 120, unshifted and shifted;
8. the bf16 model in modes rdstb, pair and swin on 8 slices: launches per
   forward (8 / 24 / 48, counts set to 0 just before each and read just
   after), the kernel path vs the plain bf16 path, and vs the f32 kernel
   path (relative error and PSNR); and per mode the wall and device time
   (torch.profiler) of one warm bucket-64 forward;
9. bf16 serving (mode rdstb, the default): as phase 5;
10. the profile of one warm bf16 bucket-64 forward, as phase 6;
11. the train-pair kernels (``kernels.pair_train``: the forward one
    persistent launch on the window body in its training form, blocks a
    and b chained; the backward) vs their plain version and its
    ``torch.autograd`` gradient, with the flagship's weights at the
    training geometry (32 images of 24x24, C = 60/90/120; RDST-W96's C =
    96 with its committed weights in phase 24), with and without
    stochastic-depth factor columns, under 'clamp' and 'stable' (and
    'stable_mm' once, at C = 60): relative max error of the output, the
    input cotangent and every weight and bias gradient (bar 0.02);
    CUDA-event times, plain times (the plain backward alone, through a
    graph built once) and bounds; for the timed variant the forward
    launch alone (two launches bitwise equal, output and block a's y;
    kernels a call, 1; its device time; at C = 60, where it runs without
    the tensor-core turns, also with them) and the backward launch alone:
    two launches on the same inputs bitwise equal, the kernels a call
    (26: 13 a block), the result against the staged plain VJP
    (``block_bwd_reference``, the two blocks chained through the
    relayout; bar 0.02), and the device time of each phase of the
    backward (torch.profiler); the forward's ptxas report (spills and
    wgmma serialization refused); the forward's mean time over C;
12. the bf16 training step: the 20-phantom corpus made by the port's
    generator, then ``python -m rdst_tpu_torch.train`` (in process) on
    ``config_files/rdst_e1_100k_oasis20_x4.ini`` for 10 steps with a
    quick evaluation every 5: 24 forward and 24 backward train-pair
    launches per step (counts set to 0 just before the run, read just
    after), a finite loss at every step, parameters that moved, the
    snapshot and its sidecar, the snapshot served by ``LiveModel``, a
    resume from the checkpoint that goes on for 2 more steps; the
    first step's loss and gradients on the kernel route against the
    plain bf16 route (loss rtol 2e-2, gradients relative max < 0.08);
13. steps/s on the wall clock over WALL_STEPS (5) warm steps queued back
    to back, and the profile of one warm training step with its kernel
    launches;
14. SwinIR-std (``config_files/swinir_std_40k_oasis20_x4.ini``, its
    committed weights, bf16, mode swin, int8 qkv; every block unshifted
    at the build resolution): the fast block at C = 180 with int8 qkv vs
    its plain version at bucket 64 (1280 windows), the path's unshifted
    block and a shifted case, 'clamp' and 'stable_bc': CUDA-event times
    of the token-parallel forward, plain time, bound (the qkv product at
    the int8 peak), relative error (bar 0.02), kernels a call, two
    launches bitwise equal and device time by phase;
15. the SwinIR-std model on 8 slices: 36 fast-block launches per forward
    (counts set to 0 just before, read just after), vs the same model on
    the CPU (the plain versions, bar 0.02) and vs the plain f32 path
    (``pallas_kernels='off'``): relative error and PSNR;
16. SwinIR-std bf16 serving over HTTP, as phase 5, and the profile of
    one warm bucket-64 forward, as phase 6;
17. the block-train kernels (``kernels.block_train``: the forward on
    the token-parallel forward, five kernels, with the exact division and
    the factor columns; the backward) vs the plain version and its
    autograd gradient at 288 windows, C = 180 (the committed weights; the
    path's unshifted block and a shifted case, with and without factor
    columns, 'clamp' and 'stable'): the output and every gradient
    (tokens, the 12 parameters through the fold, the bias), bar 0.02;
    CUDA-event times, plain times, bounds; the forward launch alone (two
    launches bitwise equal, kernels a call, device time by phase) and its
    GEMMs at 18,432 tokens in tiles of 64 and 128 rows; the ptxas report
    of its GEMM kernels; the backward's extras as phase 11 (13 kernels a
    call); then RDST-W96's block-train widths C = 144 and 192 with its
    committed weights (shift 0 and 4, with and without factor columns)
    and their forward times;
18. SwinIR-std bf16 training (``config_files/swinir_std_100k_oasis20_x4
    .ini``, 10 steps, a quick evaluation every 5): ``train_routes`` 36
    block / 0 pair, 36 + 36 block-train wrapper calls a step and none of
    the train pair (counts set to 0 just before the run), a finite loss
    that falls, the quick evaluations on the fast block, the snapshot
    served by ``LiveModel``; the first step on the kernel route vs the
    plain bf16 route from the same generator state (the same
    stochastic-depth draws; loss rtol 2e-2, gradients < 0.08);
19. steps/s and the profile of one warm SwinIR-std training step, as
    phase 13;
20. the token-parallel forward's GEMMs alone (``csrc/token_wgmma.cuh``,
    ``kernels.token_wgmma``: the qkv product in int8 and bf16, proj +
    residual + LN2, fc1 + GELU + fc2 + residual fused, the adapter pre-
    and post-norm) on seeded operands at C = 96 / 144 / 180 / 192 and
    960 / 1280 / 81920 tokens: int8 bitwise against the exact integer
    sums, bf16 within 0.02; at 81920 tokens each one's device time beside
    its byte floor and a library product of the same shapes
    (``torch.matmul``, ``torch._int_mm``: the products alone); the ptxas
    registers of its kernels, no spills and no wgmma serialization
    allowed. Then RDST-W96 (``config_files/rdst_w96_40k_oasis20_x4.ini``,
    its committed 40k weights) kernels at bucket 64: the f32 block at C =
    96 / 144 / 192 as phase 3; the RDSTB with int8 qkv (three DSTLs on
    the token-parallel stages, the conv 240 -> 96) and the pair at C =
    96 / 144 / 192 with int8 qkv, each against its plain and staged
    versions (bar 0.02), two calls bitwise equal, kernels a call,
    CUDA-event times beside the bound and the plain time, device time
    by stage kernel, each GEMM phase beside its byte floor; the pair at
    C = 96 with bf16 qkv in both stage designs (window body,
    token-parallel) side by side;
21. the W96 model on 8 slices: f32 as shipped (48 f32 block launches a
    forward) against the plain f32 path (bar 1e-4); bf16 with int8 qkv
    in modes swin, rdstb and pair (48 / 8 / 24 launches a forward, counts
    set to 0 just before each and read just after) against the f32
    model (< 0.05 max, < 0.005 mean, relative) and against mode swin;
    per mode (and f32) the wall and device time of one bucket-64
    forward;
22. W96 f32 serving over HTTP, as phase 5;
23. W96 bf16 serving (mode rdstb, int8 qkv) over HTTP, as phase 5; then
    the profile of one warm bucket-64 forward in each dtype, as phase 6;
24. the train-pair kernels at W96's C = 96 with its committed weights, as
    phase 11;
25. W96 bf16 training (``config_files/rdst_w96_100k_oasis20_x4.ini`` with
    ``training_dtype='bfloat16'``, 10 steps, a quick evaluation every 5):
    ``train_routes`` 8 pair / 32 block, 8 + 8 train-pair and 32 + 32
    block-train calls a step (counts set to 0 just before the run), a
    finite loss that falls, the snapshot served in bf16 by ``LiveModel``;
    the first step on the kernel route vs the plain bf16 route (loss rtol
    2e-2, gradients < 0.08);
26. the tester path, at the end of each model's phases (``--only``
    keeps each model's rows): first the kernels at the tester's batch
    sizes against their plain versions -- one whole held-out patient in
    one forward (57 and 58 slices of LR 16x12, padded to 16x16: 228 and
    232 windows; and the same counts at 40x32, 1140 and 1160 windows) for
    the f32 block (E1 C = 60, W96 C = 96 / 192), the E1 and W96 RDSTBs
    (W96 with int8 qkv) and the C = 180 fast block with int8 qkv, and one
    tiled chunk (128 LR patches of 24x24) through E1 in f32 (kernel vs
    plain, MODEL_TOL) and bf16 (vs f32) and through the E1 RDSTB; then
    ``cli.test_main`` (``python -m rdst_tpu_torch.test``) on the card
    over patients 19-20 of the corpus for each README quality row:
    bicubic, E1 f32 as shipped, E1 bf16, E1 f32 tiled at stride 12 (one
    24x24 patch a slice here) and, without a bar, at patch 12 stride 6
    (four overlapping patches a slice, chunks of 128), the HRL and the
    two RaGAN fine-tunes (with vifp and lpips), SwinIR-light
    (f32), SwinIR-std (bf16, int8 qkv, as shipped), W96 in f32 as shipped,
    in bf16 (int8 qkv, as shipped) and in bf16 without int8. Each row
    prints its mean scores beside its bar, the JAX tester's own number on
    this corpus (``TESTER_BARS``), and its README figure: a row more than
    0.02 dB / 0.002 SSIM (vifp 0.002, lpips 1e-4) off its bar fails; E1
    bf16 and W96 bf16 without int8 must also hold 0.02 dB / 0.002 of
    their f32 rows, and the tiled rows stay within 2 dB of whole-slice SR
    (the stride-12 row, one zero-padded 24x24 patch a slice, scores above
    it: checked from below only). Each row also prints the kernel
    launches of its run (counts set to 0 just before, read just after:
    per forward 48 / 8 / 24 / 36 / 48 / 8) and per patient the tester's
    inference wall time and one warm forward's wall and device time.

27. (after phase 13) the seg fine-tune: ``config_files/
    rdst_hrl_seg_ft_oasis20_x4.ini`` with ``--seg-loss`` as shipped (f32,
    warm start, L1 + UNet-F), with ``unet_native_ckpt`` naming the
    committed seg UNet ``weights/unet_tiny.pkl`` (checked: the term's
    UNet holds its weights), for 6 steps with a quick evaluation every 3
    (the f32 block kernel in each evaluation, 48 launches a forward): the
    UNet-F term finite and above 0, the snapshot written; then the repo's
    example recipe ``config_files/rdst_e1_oasis_x4.ini`` (WarmUP ->
    UNet-F from scratch, the same UNet) for 3 steps a state; steps/s over
    WALL_STEPS warm steps and one profiled step (device time by kernel
    group, idle share, launches);
28. the GAN fine-tune: ``config_files/rdst_gan_ft_oasis20_x4.ini`` as
    shipped (RaGAN, CNN discriminator, f32, ``eva_metrics`` with FID)
    for 6 steps with a quick evaluation every 3: every loss finite, the
    discriminator's loss moving, the G and D snapshots written; the resume
    for 2 more steps; FID of the final evaluation's images on the card
    against the CPU (relative 1e-3) with both times; steps/s, one
    profiled step and the D update's share of its device time;
29. both recipes in bf16 (``training_dtype='bfloat16'``) for 6 steps:
    24 train-pair backward launches a step and 24 forward launches a
    generator forward (one a seg step, two a GAN step), no single-block
    train launch; the first step (the discriminator's update included) on
    the kernel route against the plain bf16 route from the same state and
    batch: every loss rtol 2e-2, the generator's gradient < 0.08; steps/s
    and one profiled step.

30. (``--only metasr``, after the other models) the MetaSR tester:
    ``cli.test_main`` on the card with the committed
    ``weights/metasr_20k_best_oasis20_x4.msgpack`` at 1.5 / 2 / 3 / 4
    over patients 19-20, each scale's mean PSNR / SSIM within 0.02 dB /
    0.002 of the JAX tester's own number (``TESTER_BARS``, beside the
    README:185-187 figures); per patient and scale one whole-patient
    forward's wall and device time;
31. MetaSR served over HTTP (``POST /v1/predict?scale=1.5`` ...) at its
    four scales, at 40x32 and at 37x29, each response equal to a direct
    predict; one 8-slice forward's device time at each scale;
32. MetaSR training: ``config_files/metasr_20k_oasis20_x4.ini`` as
    shipped (f32, batch 32, EDSR 16 x 64) for 20 steps with a quick
    evaluation every 10: every loss finite, the scales the batches drew,
    the snapshot served at 1.5; steps/s and one profiled step;
33. RDST-E1 built scale-free (the shipped serving config with
    ``scale_free`` and scales 1.5 - 4 set; the committed E1 body, a seeded
    ``tail_meta``) served at 1.5 and 4 on 8 slices of 40x32 and of 37x29
    (padded to whole windows, cropped to ``int(orig * s)``): f32 through
    the f32 block kernel (48 launches a forward) against the plain path
    on the card (1e-4), bf16 mode rdstb (8 launches) against the same
    model on the CPU (the plain versions, 0.02), against its plain
    modules and against f32; the f32 block and the RDSTB alone at that
    geometry against their plain versions with both times and the bound;
    HTTP serving at both scales in both dtypes with the launches counted
    (counts set to 0 just before the requests, read just after); one
    bucket-64 forward's wall and device time at each scale beside the
    shipped E1's at x4;
34. scale-free E1 training in bf16 (``config_files/rdst_e1_100k_oasis20_x4
    .ini`` with the same keys): the train-pair kernels at the training
    geometry as phase 11, the first step on the kernel route against the
    plain bf16 route, then 10 steps at the scales the batches draw with 24
    + 24 train-pair launches a step (counts set to 0 just before the run,
    read just after), every loss finite; steps/s and one profiled step.

35. (``--only int8``, after the other models) the int8 groups
    (``pallas_quant``: 'mlp', 'proj', 'conv' beside 'qkv', or 'all'): each
    int8 design against its plain version at bucket 64 with the committed
    weights -- the fast block at C = 60 / 120 (E1) and 180 (SwinIR-std),
    the pair at E1's C = 60 / 90 / 120 and W96's 96 / 144 / 192, the RDSTB
    of E1 and of W96 -- with 'all' and each group alone: relative max
    error (bar 0.02) and mean error (bar 1e-3), and the share of each
    control's departure from the plain version that the launch carries
    (bar 0.5, the midpoint; the controls: the plain version with int8
    off, and with one scale group for the whole call where a group takes
    a dynamic scale); the same gate with each control in the plain version's
    place must refuse the launch. Two launches bitwise equal, kernels a
    call (the wrapper's count; for 'all' torch.profiler's count, its
    session padded with spin kernels, must equal it), CUDA-event times of
    the launch and of the plain version, the bound (the int8 groups'
    products at the int8 peak, the rest at the bf16 peak, or the bytes);
    then the model with 'all' on 8 slices in each mode (E1 rdstb / pair /
    swin, 8 / 24 / 48 launches a forward; W96 rdstb / pair, 8 / 24;
    SwinIR-std swin, 36; counts set to 0 just before each and read just
    after), finite, against the card's bf16 model without int8 (mean bar
    0.005), and each unit (RDSTB, RSTB) on the card's own input to it
    against the same unit on the CPU (the plain int8 versions, two
    slices): max 0.02, mean 0.005, and at least 0.75 as far from each
    control as the plain version is (dynamic int8 steps rounded apart
    spread through a unit's blocks, so a share is logged only there);
    the card's model without int8 must fail that gate in every unit (the
    whole output against the CPU's is logged only); one 8-slice HTTP
    request against a direct predict;
    and the tester row with 'all' (``E1 bf16 int8 all``, ``W96 bf16 int8
    all``, ``SwinIR-std int8 all``) against the JAX tester's own number,
    and for E1 and W96 outside the tolerance from the JAX tester's number
    for the shipped groups.

(``--only xdata``, after the other models) phase 26's cross-dataset rows,
then phases 36 and 37:
26. the f32 block (the first DSTL's two shifts) and the E1 RDSTB in bf16
    at COVID's whole-patient geometry (its test patient: LR 128x128,
    about 5,000 windows a call) against their plain versions (1e-4 /
    0.02) with CUDA-event times and bounds, the committed COVID weights;
    then ``cli.test_main`` on the card with the committed
    ``rdst_e1_10k_{brats8,acdc8,covid8}_best_x4.msgpack`` and their
    configs as shipped (f32), each on its 8-phantom corpus (only the
    testing patient 8 generated): BraTS a row a modality (t1ce, t1, t2,
    flair; 4 channels through the head and tail), ACDC (the 128 crop)
    and COVID (the 512 crop, whole-slice), each against the JAX tester's
    own number (``TESTER_BARS``, beside README:172-177; 0.02 dB / 0.002
    SSIM), and COVID in bf16 (mode rdstb) against its f32 row; each
    row's launches (48 / 8 a forward, counts set to 0 just before and
    read just after) and per patient the tester's wall time and one
    forward's device time;
36. ``runners.seg_eval`` on the card with the committed
    ``weights/unet_tiny.pkl`` over the SR volumes of the bicubic, E1 f32,
    HRL, SwinIR-light, SwinIR-std and W96 f32 rows (phase 26's, or run
    here with their bars where those phases did not run): each class's
    mean Dice over patients 19-20 within 0.005 of the JAX ``seg_eval``'s
    (``DICE_BARS``), printed beside the README figure (the README's c0 /
    c1 / c2 are the UNet's classes 0-2); the UNet on the card against the
    CPU on one
    patient (logits 1e-4 relative; a label may differ only at a near-tie,
    counted);
37. the auxiliary trainers on the 20-phantom corpus:
    ``runners.train_seg_unet`` (batch 8 of HR 96x96) and
    ``runners.train_vgg_features`` (width 0.25, batch 16 of 64x64),
    AUX_STEPS (25) steps each: the first three steps on the card against
    the CPU from the same variables and batches (the VGG autoencoder in float32, 1e-3;
    the seg UNet in float64, 1e-6, and its float32 first step, 1e-3: its
    train-mode BatchNorm makes two float32 runs drift apart within two
    Adam steps), the loss falling, the pickles reloading into
    ``seg_eval``, the UNet-F term and ``VGGLoss``; steps/s and one
    profiled step (device time, idle share); then phase 12's training
    run under ``stall_warn_s=2``: the heartbeat reaches the last step and
    the log holds no WATCHDOG line.

(``--only zoo``, after the other models) the Swin-based model zoo, built
from CONFIG / TRAIN_CONFIG with KEY=VALUE overrides on seeded weights
(``zoo_weights``; no committed weights), phases 38-41:
38. each ZOO family (RDST-N with both bottlenecks, ESTSR with both tails,
    WaveletSR haar / db2, Swin-MLP, RDST 3conv, RDST ape) at full width in
    f32 on 8 seeded slices: the kernel path against the JAX package's
    forward on the CPU (``ZOO_BARS``, ``tools/jax_zoo_bars.py``: mean,
    mean square and 64 pixels within 1e-4 of the largest magnitude) and
    against its plain path (MODEL_TOL), f32 block launches a forward (48
    / 144 / 8 / 0);
39. bf16: RDST-N and ESTSR in modes rdstb / pair / swin (8 / 24 / 48 and
    24 / 72 / 144 launches a forward), WaveletSR in mode swin (8; rdstb
    and pair refused at build), RDST 3conv in pair / swin (rdstb refused),
    each against its plain bf16 path (BF16_TOL) and its f32 output (the
    bf16-vs-f32 bars);
40. the kernels alone: WaveletSR's f32 and fast blocks at C = 64, 4 heads
    (head dim 16), shift 0 and 4, at 384 windows (bucket 64 of 40x32:
    DWT grid 24x16) and at the tester's 8x8 grid (the shift drops out),
    its train pair at 32 grids of 16x16; ESTSR's and RDST-N's f32 block,
    RDSTB and train pair at E1's geometries: each against its plain
    version, two launches bitwise equal, CUDA-event times and bounds;
41. ``cli.train_main`` of TRAIN_CONFIG for ZOO_STEPS steps of RDST-N,
    ESTSR and WaveletSR in bf16 (24 / 72 / 4 train-pair launches a step)
    and Swin-MLP in f32: the routes, the first step against the plain
    bf16 route, a finite, falling loss, steps/s and one profiled step;
    then each snapshot scored by ``cli.test_main`` on patients 19-20 (f32,
    48 / 144 / 8 / 0 launches a forward, no quality bar: the weights are
    ZOO_STEPS old) and served over HTTP at 1 / 8 / 64 slices, each
    response equal to a direct predict.

(``--only convzoo``, after the other models) the convolutional model
zoo, built from CONFIG / TRAIN_CONFIG / METASR_CONFIG with KEY=VALUE
overrides on seeded weights (``zoo_weights``), at the widths the
factories build; no kernel of the port is on this path (cuDNN
convolutions, plain PyTorch attention), and every port kernel counter
must stay 0 through it; phases 42-45:
42. each CONV_ZOO family (SRResNet, SRDenseNet, RDN, ESRGAN, MDSR at 2 /
    3 / 4, RCAN, HAN, ConvNeXt large / lite, ZSSR on its HR-size input,
    DBPN, IPT at 2 / 3 / 4 on 24x24, MetaSR on five extractors at 1.5 and
    4) in f32 on 8 seeded slices: against the JAX package's forward on
    the CPU (``CONV_ZOO_BARS``, ``tools/jax_zoo_bars.py --conv``) and
    against the port's CPU forward of one of them (MODEL_TOL); RCAN in
    float64 on both sides (CONV_ZOO_F64_TOL), its float32 gates that
    differ from the float64 run's counted; one forward's device time;
43. each family in bf16 against its f32 output (the bf16-vs-f32 bars;
    RCAN reports its gate flips and error against float64, no bar);
44. training: each CONV_ZOO_TRAIN family for CONV_ZOO_STEPS steps of
    TRAIN_CONFIG (bf16; ZSSR with ``lr_image_size_remain``, MDSR and IPT
    at scales 2 / 3 / 4, IPT at learning rate 1e-5) or METASR_CONFIG (MetaSR-RDN and -Meta_MDSR,
    f32): the set-up model's step on the card against the CPU's (loss and
    gradient norm; RCAN's in float64, every gradient), finite losses, a fixed batch's loss lower after the run, steps/s and one
    profiled step (device time, idle share);
45. each snapshot scored by ``cli.test_main`` on patients 19-20 (IPT
    tiled) and served over HTTP at 1 / 8 / 64 slices (ZSSR HR-size, IPT
    24x24), each response equal to a direct predict.

(``--only ckpt``, after the other models) reference torch checkpoints
and SwinIR's other heads; phases 46-48:
46. each family that ``checkpoint.torch_import`` maps (CKPT: the CONFIG
    families of CONV_ZOO and EDSR on seeded weights at their factory
    widths, RDST-E1 and SwinIR-std on their committed weights): its
    msgpack snapshot served by ``LiveModel`` (f32), written as the
    reference network's ``.pt`` (``torch_export.save_torch_checkpoint``
    with ``reference_template``), read back by the tester's loader and by
    ``LiveModel``: both forwards of 8 seeded slices equal the msgpack
    model's bit for bit, the manifests equal; CKPT_STEPS bf16 training steps from
    a ``pre_trained_g`` warm start on the ``.pt``, finite;
47. SwinIR-std (embed 180, 6 x 6 blocks) with ``sir_upsampler =
    'nearest+conv'`` (8 x LR 40x32) and with ``sir_ape`` (8 x 24x24, its
    table's size), seeded weights: f32 (36 f32 block launches a forward)
    against the JAX package's CPU forward (``SIR_BARS``, ``tools/
    jax_zoo_bars.py --swinir``) and the plain f32 path; bf16 int8 qkv (36
    fast-block launches) against the plain bf16 path; 6 bf16 training
    steps (36 + 36 block-train calls a step) and the block-train kernels
    alone at the step's geometry; the tester on patients 19-20 (ape
    tiled by its 24x24 patch) and HTTP at 1 / 8 / 64 slices;
48. the same for the denoise head (``sir_upsampler = ''``,
    ``lr_image_size_remain``) on 8 HR-size 160x128 slices, with the f32
    block and the fast block (int8 qkv) alone at its 2,560 windows
    against their plain versions and bounds; its training steps take one
    whole HR-size slice each.

(``--only parallel``, after the other models) data parallelism on the data
axis ``--dp-devices`` (default ``['cuda:0', 'cuda:0']``: two ranks or
replicas sharing the one card, over gloo); phases 49-51:
49. TRAIN_CONFIG (bf16, batch 32) for DP_STEPS steps through
    ``parallel.probe`` (the trainer's own run, every step recorded): (a) in
    this process on one device, twice (the card's run-to-run spread), (b)
    a rank a device, spawned (``parallel.launch.spawn``), (c) one NCCL rank;
    GAN_CONFIG (RaGAN, f32) for DP_GAN_STEPS steps on one device and on the
    axis. Every rank 24 + 24 train-pair launches a step on its share of the
    batch, the ranks' losses, parameters, Adam moments and discriminators
    bitwise equal; (b) and (c) against (a): the loss, the gradient (from
    Adam's first moment, as phase 12 measures it) and the parameters (2 lr
    a step) within the bf16 step bar, RaGAN within DP_F32_RTOL /
    DP_F32_GRAD, each bar at least twice the one-rank spread; host steps/s
    a rank, not a speed result where ranks share a card;
50. the tester (E1 f32 and bf16 on the held-out patients) over the axis,
    a replica a device, against one device: the printed digits equal, the
    SR slices within DP_TESTER_TOL of max|y|, each replica's launches (48
    f32 blocks / 8 RDSTBs a forward);
51. the HTTP server on a ``LiveModel`` over the axis against the
    one-replica server: 1-, 8- and 64-slice requests and a burst of 8
    concurrent 1-slice requests within SERVE_TOL, the manifest's ``mesh``,
    each replica's launches.

(``--only bundle``, after the other models) the serving bundle, one CUDA
graph an entry and bucket; phases 52-56:
52. each bundle of BUNDLES (E1 f32 as shipped, also at the tester's LR;
    E1 bf16 in modes rdstb, pair and swin; W96 bf16 with int8 qkv;
    SwinIR-std as shipped; MetaSR at its four scales, blend 0.5) exported
    by ``export_bundle`` into a fresh directory and loaded there, reading
    its two files and nothing else;
53. each bundle's graphs at buckets 1, 8 and 64 against the eager
    ``LiveModel`` built from the config: bitwise (or, where the eager
    model differs from itself, within its bar), the capture's launches
    those of an eager forward, capture seconds and memory, wall p50 each
    way, device time and idle share, device kernels and host launches a
    forward (torch.profiler); then every cached device table dropped and
    the freed blocks zeroed, and each graph's replay still bitwise its
    first (a graph holds the tables it read);
54. the E1 f32 bundle's predictions scored by the tester's protocol
    against the E1 f32 row of TESTER_BARS;
55. ``serving.server.main(['--bundle', ..., '--warmup'])``: health,
    metadata, a burst of 64 concurrent 1-slice requests coalesced; the
    volume CLI with ``--bundle`` against the live volume CLI.
56. a capture that meets a host-to-device copy raises, naming the line,
    and the bundle then captures and serves with the forward put back.

Each training run's final evaluation scores the config's ``eva_metrics``
as shipped (FID included; the zoo's runs score PSNR and SSIM). Any failed phase raises and the script exits
non-zero. It needs a CUDA
card: without one it exits non-zero and prints no result. The last two
lines of standard output are the kernel table (JSON) and the device
line (JSON).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

CONFIG = "config_files/rdst_e1_40k_oasis20_x4.ini"
WEIGHTS = "weights/rdst_e1_40k_best_oasis20_x4.msgpack"
W96_CONFIG = "config_files/rdst_w96_40k_oasis20_x4.ini"
W96_WEIGHTS = "weights/rdst_w96_40k_best_oasis20_x4.msgpack"
LR_HW = (40, 32)
SCALE = 4.0
SEED = 0
# H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores, dense bf16 on
# the tensor cores, HBM3 bandwidth
F32_FLOPS = 67e12
TF32_FLOPS = 494e12  # dense TF32 tensor cores: the f32 kernel's 3xTF32
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# Kernel vs plain, f32 on both sides: they differ only in summation order
# (K <= 240 terms) on O(1) activations.
KERNEL_TOL = 1e-4
# Whole model, kernel path vs plain path: 48 blocks of the above plus the
# same cuDNN convolutions on both sides.
MODEL_TOL = 1e-4
# A served response vs a direct predict of the same slices: equal batch
# shapes agree exactly; other batch shapes may take other cuDNN algorithms.
SERVE_TOL = 1e-5
# bf16 kernels vs their plain versions, relative max error max|k - p| /
# max|p|: both round to bf16 at the same places, so a difference is a
# bf16 rounding that landed the other way after f32 sums in another order
# (and the approximate reciprocal); test_kernels.py's bar for the JAX
# kernels.
BF16_TOL = 0.02
# bf16 model vs the f32 model (test_kernels.py:394-397): relative max and
# mean error.
BF16_VS_F32_MAX, BF16_VS_F32_MEAN = 0.05, 0.005
# the training step (phase 12): the shipped bf16 training config, cut to
# 10 steps; kernel route vs plain bf16 route on one step
# (tests/test_pair_train.py:192,209)
TRAIN_CONFIG = "config_files/rdst_e1_100k_oasis20_x4.ini"
TRAIN_STEPS, TRAIN_CHECK = 10, 5
WALL_STEPS = 5
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 2e-2, 0.08
# A bf16 response vs a direct predict of the same slices (HR values about
# 0..1): equal batch shapes agree exactly; at another batch shape the f32
# convolutions may take another cuDNN algorithm, and a bf16 rounding that
# moves by one ulp there travels through the model.
SERVE_TOL_BF16 = BF16_TOL


# cuDNN's convolution kernels by name, its FFT algorithms included
CONV_KERNELS = ("conv", "cudnn", "xmma", "implicit", "fft",
                "pointwise_mult_and_sum_complex")


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    """Decorator: run a phase, print its seconds, let failures raise."""
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            log(f"== phase {name}")
            out = fn(*a, **kw)
            log(f"== phase {name}: ok in {time.perf_counter() - t0:.3f} s")
            return out
        return run
    return wrap


def cuda_time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean device time of fn() over iters launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@phase("card")
def card_phase() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return line


@phase("build")
def build_phase() -> dict:
    from rdst_tpu_torch.kernels import _build

    with concurrent.futures.ThreadPoolExecutor(len(_build.SOURCES)) as ex:
        libs = dict(zip(_build.SOURCES, ex.map(_build.build, _build.SOURCES)))
    out = {}
    for src, path in libs.items():
        log(f"built {src} -> {path.name}")
        ptxas = [line.strip() for line in _build.build_log(src).splitlines()
                 if "registers" in line or "spill" in line]
        for line in ptxas:
            log(f"  ptxas: {line}")
        out[src] = {"library": str(path), "ptxas": ptxas}
    return out


def _block_work(block, c: int, windows: int):
    """Flops and bytes of one launch: 16C^2 + 4NC flops per token; the
    input and output rows, every weight and the bias, each once."""
    n = 64
    flops = windows * n * (16 * c * c + 4 * n * c)
    weights = sum(p.numel() for name, p in block.named_parameters()
                  if not name.endswith("relative_position_bias_table"))
    return flops, weights


def _f32_variant(block, shift: int, gen, kernels: int) -> dict:
    """The f32 block kernel's launch alone for one block of a model
    (weights split once, as the model keeps them) at bucket 64 (64 slices
    x 20 windows): against its plain version and the staged plain version
    of its phases (bar KERNEL_TOL), CUDA-event times, both bounds (f32 FMA
    and 3xTF32), kernels a call, two launches bitwise equal and device
    time by phase."""
    from rdst_tpu_torch.kernels import swin_block as sb

    ws, nw, images, nh = 8, 20, 64, block.num_heads
    c = block.dim
    params, bias = block.kernel_inputs(LR_HW, ws, shift)
    x = torch.randn(images * nw, ws * ws, c, device="cuda", generator=gen)
    kw = dict(num_heads=nh, windows_per_image=nw)
    with torch.inference_mode():
        plan = sb.plan_f32_block(params, bias, num_heads=nh)
        got = sb.run_f32_block(x, plan, **kw)
        want = sb.swin_block_reference(x, *plan.params, bias, **kw)
        staged = sb.swin_block_staged_f32(x, *plan.params, bias, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err_staged = (got - staged).abs().max().item()
        if not (max(err, err_staged) <= KERNEL_TOL
                and torch.isfinite(got).all()):
            raise AssertionError(
                f"fused_swin_block C={c} shift={shift}: max abs err {err} "
                f"(staged {err_staged}) > {KERNEL_TOL}")

        def call():
            return sb.run_f32_block(x, plan, **kw)

        ms = cuda_time_ms(call)
        plain_ms = cuda_time_ms(
            lambda: sb.swin_block_reference(x, *plan.params, bias, **kw))
        flops, weights = _block_work(block, c, images * nw)
        extras = _forward_extras(f"f32 block C={c} shift={shift}", call,
                                 kernels, F32_PHASES, flops)
    nbytes = 4 * (2 * x.numel() + weights + bias.numel())
    row = dict(c=c, shift=shift, windows=images * nw, max_abs_err=err,
               staged_max_abs_err=err_staged, ms=ms, plain_ms=plain_ms,
               **_f32_bound(flops, nbytes), **extras)
    log(f"fused_swin_block C={c:3d} shift={shift}: err {err:.3e} (staged "
        f"{err_staged:.3e}; tol {KERNEL_TOL}) kernel {ms:.4f} ms plain "
        f"{plain_ms:.4f} ms bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}, 3xTF32; f32 FMA {row['fma_bound_ms']:.4f} ms) "
        f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
    return row


def _f32_kernels() -> int:
    from rdst_tpu_torch.kernels import swin_block as sb

    return sb.kernels_per_call("swin_block.cu", "swin_block_f32_kernels")


def _rdst_blocks(model):
    """(block, shift) of the first RDSTB's DSTLs: block a unshifted,
    block b at shift 4, widths ascending."""
    return [(blk, k * 4) for dstl in model.body[0].body
            for k, blk in enumerate(dstl.body.blocks)]


@phase("kernel vs plain")
def kernel_phase(model) -> dict:
    """The f32 block kernel (``_f32_variant``) for the six (C, shift)
    variants of the flagship's first RDSTB, C = 60/90/120."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = _f32_kernels()
    rows = [_f32_variant(blk, shift, gen, kernels)
            for blk, shift in _rdst_blocks(model)]
    log("library yardstick: no single PyTorch call computes a whole Swin "
        "block (LN, qkv, biased softmax attention, proj, LN, GELU MLP)")
    return {"variants": rows}


@phase("kernel vs plain at C = 180 / 192")
def wide_kernel_phase() -> dict:
    """Phase 3 at the widths the f32 route admits since the kernel's own
    limits became its rule (``_f32_variant``): C = 192 (RDST-W96's widest
    DSTL, its committed weights) and C = 180 (SwinIR-std's first RSTB,
    its committed weights), each an unshifted and a shifted block."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    kernels = _f32_kernels()
    w96 = _build_f32(W96_CONFIG, W96_WEIGHTS)
    swinir = _build_f32(SWINIR_CONFIG, SWINIR_WEIGHTS, pallas_kernels="swin")
    cases = _rdst_blocks(w96)[4:] + [
        (blk, k * 4) for k, blk in
        enumerate(swinir.layers[0].residual_group.blocks[:2])]
    return {"variants": [_f32_variant(blk, shift, gen, kernels)
                         for blk, shift in cases]}


def _f32_bound(flops: float, nbytes: float) -> dict:
    """The f32 block's bounds: its work at the f32 FMA peak and at the
    TF32 tensor-core peak counted three times (3xTF32), each against the
    bytes; the row takes the smaller operations time."""
    t_fma = flops / F32_FLOPS * 1e3
    t_tf32 = 3 * flops / TF32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = min(t_fma, t_tf32)
    return dict(flops=flops, bytes=nbytes, fma_bound_ms=max(t_fma, t_bytes),
                tf32_bound_ms=max(t_tf32, t_bytes),
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def _build_f32(config: str, weights: str, **overrides):
    """A shipped config's float32 model with its committed weights on the
    card (``build_serving_model``)."""
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.serving.export import build_serving_model

    p = ParametersLoader(config)
    p.set("well_trained_single_scale_model_g", weights)
    p.set("inference_dtype", "float32")
    for k, v in overrides.items():
        p.set(k, v)
    model, meta = build_serving_model(p, device="cuda")
    if set(meta["routes"]) != {"fused_swin_block"}:
        raise AssertionError(f"{config} in f32: routes {meta['routes']}")
    return model


@phase("whole model")
def model_phase(live) -> dict:
    from rdst_tpu_torch.kernels import swin_block
    from rdst_tpu_torch.nn.swin import set_block_kernels

    rng = np.random.default_rng(SEED)
    x = rng.random((8,) + LR_HW + (1,), dtype=np.float32)
    swin_block.fused_swin_block.launches = 0
    y_kernel = live.predict(x, SCALE)
    launches = swin_block.fused_swin_block.launches
    # the plain path of this same model: its own blocks' flag, set back
    # before it serves
    set_block_kernels(live.model, False)
    try:
        y_plain = live.predict(x, SCALE)
    finally:
        set_block_kernels(live.model, True)
    if swin_block.fused_swin_block.launches != launches:
        raise AssertionError("the plain path launched the kernel")
    want_shape = (8, int(LR_HW[0] * SCALE), int(LR_HW[1] * SCALE), 1)
    err = float(np.abs(y_kernel - y_plain).max())
    log(f"8 slices {LR_HW} -> {y_kernel.shape}: kernel vs plain max abs err "
        f"{err:.3e} (tol {MODEL_TOL}); fused_swin_block launches per "
        f"forward {launches}")
    if y_kernel.shape != want_shape or not np.isfinite(y_kernel).all():
        raise AssertionError(f"bad output {y_kernel.shape}, finite="
                             f"{np.isfinite(y_kernel).all()}")
    if err > MODEL_TOL:
        raise AssertionError(f"kernel path vs plain path: {err} > {MODEL_TOL}")
    if launches != 48:
        raise AssertionError(f"{launches} block-kernel launches per forward, "
                             "expected 48 (8 RDSTBs x 3 DSTLs x 2 blocks)")
    return {"max_abs_err": err, "launches_per_forward": launches}


def _serve(live, counter=None, per_forward: int = 48,
           dtype: str = "float32", tol: float = SERVE_TOL) -> dict:
    """Serve ``live`` over HTTP; ``counter`` is the kernel wrapper whose
    ``launches`` the main path adds to (``per_forward`` a forward)."""
    from rdst_tpu_torch.serving.client import SRClient
    from rdst_tpu_torch.serving.server import InferenceServer

    if counter is None:
        from rdst_tpu_torch.kernels.swin_block import fused_swin_block

        counter = fused_swin_block
    name = counter.__name__

    srv = InferenceServer(live, "127.0.0.1", 0, max_batch=64,
                          batch_wait_ms=25.0)
    out = {}
    try:
        out["warmup_s"] = srv.warmup(lr_hw=LR_HW, scale=SCALE)
        log(f"warmed buckets {live.buckets} in {out['warmup_s']} s")
        srv.start_background()
        client = SRClient(f"http://127.0.0.1:{srv.port}")
        if client.health() != {"status": "ok"}:
            raise AssertionError("healthz")
        meta = client.metadata()
        if meta["pallas_kernels"] is None or meta["dtype"] != dtype:
            raise AssertionError(f"metadata {meta}")
        rng = np.random.default_rng(SEED + 1)
        x8 = rng.random((8,) + LR_HW, dtype=np.float32)
        # direct predictions first: the launch count below covers served
        # requests only
        direct_1 = live.predict(x8[:1], SCALE)
        direct_8 = live.predict(x8, SCALE)
        direct = [live.predict(x8[i:i + 1], SCALE) for i in range(8)]

        def check(name, got, want):
            err = float(np.abs(got - want).max())
            log(f"{name}: {got.shape} max abs err vs direct predict "
                f"{err:.3e} (tol {tol})")
            if got.shape != want.shape or err > tol:
                raise AssertionError(f"{name}: err {err}")
            return err

        counter.launches = 0  # main path starts here
        out["err_1"] = check("1-slice request", client.predict(x8[:1], SCALE),
                             direct_1)
        out["err_8"] = check("8-slice request", client.predict(x8, SCALE),
                             direct_8)
        before = counter.launches
        barrier = threading.Barrier(8)

        def one(i):
            barrier.wait()
            return client.predict(x8[i:i + 1], SCALE)

        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            burst = list(ex.map(one, range(8)))
        forwards = (counter.launches - before) // per_forward
        out["err_burst"] = max(check(f"burst request {i}", burst[i], direct[i])
                               for i in range(8))
        log(f"8 concurrent 1-slice requests ran as {forwards} forward(s)")
        if not 1 <= forwards < 8:
            raise AssertionError("the batcher did not coalesce the burst")
        out["burst_forwards"] = forwards

        lat = {}
        for b in live.buckets:
            xb = rng.random((b,) + LR_HW, dtype=np.float32)
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                y = client.predict(xb, SCALE)
                ts.append(time.perf_counter() - t0)
                if not np.isfinite(y).all():
                    raise AssertionError(f"non-finite response at bucket {b}")
            p50 = float(np.median(ts))
            lat[b] = {"p50_s": p50, "slices_per_s": b / p50, "times_s": ts}
            log(f"bucket {b:2d}: p50 {p50 * 1e3:.2f} ms, "
                f"{b / p50:.1f} slices/s over HTTP")
        out["latency"] = lat
        out["launches"] = counter.launches  # main path ends
        log(f"{name} launches while serving: {out['launches']}")
        if out["launches"] == 0:
            raise AssertionError(f"serving never launched {name}")
    finally:
        srv.close()
    return out


serving_phase = phase("serving")(_serve)


def _profile(live, kernels=None, group: str = "f32 block kernels") -> dict:
    """Device time of one warm bucket-64 forward by kernel group
    (torch.profiler / CUPTI), and the device's idle share of the
    forward's wall time (numpy in, numpy out); a kernel whose name holds
    one of ``kernels`` (default: the f32 block's, F32_PHASES) is in the
    port's group ``group``."""
    if kernels is None:
        kernels = tuple(key for key, _ in F32_PHASES)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = np.random.default_rng(SEED + 2).random((64,) + LR_HW,
                                               dtype=np.float32)
    live.predict(x, SCALE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        live.predict(x, SCALE)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {group: 0.0, "convolution": 0.0, "other": 0.0}
    top = []
    for e in prof.key_averages():
        # device kernels only: the CPU ops that launch them report the
        # same time again
        t = float(e.self_device_time_total or 0.0)
        if e.device_type != DeviceType.CUDA or t <= 0:
            continue
        name = e.key.lower()
        if any(k.lower() in name for k in kernels):
            groups[group] += t
        elif any(w in name for w in CONV_KERNELS):
            groups["convolution"] += t
        else:
            groups["other"] += t
        top.append((t, e.count, e.key[:90]))
    busy = sum(groups.values())
    out = {"wall_us": wall_us, "device_us": busy, "groups_us": groups,
           "top": sorted(top, reverse=True)[:10]}
    if busy == 0:
        log("torch.profiler recorded no device time: breakdown not measured")
        return out
    out["idle_share"] = 1.0 - busy / wall_us
    log(f"bucket-64 forward under the profiler: wall {wall_us / 1e3:.3f} ms, "
        f"device busy {busy / 1e3:.3f} ms, idle share {out['idle_share']:.3f}")
    for name, t in groups.items():
        log(f"  {name}: {t / 1e3:.3f} ms ({100 * t / busy:.1f} % of device time)")
    for t, count, key in out["top"]:
        log(f"  {t / 1e3:9.3f} ms x{count:4d} {key}")
    return out


profile_phase = phase("profile")(_profile)


def _rel(got, want):
    """(max, mean) of |got - want| / max|want|, in float32."""
    d = (got.float() - want.float()).abs()
    scale = want.float().abs().max()
    return (d.max() / scale).item(), (d.mean() / scale).item(), \
        d.max().item()


def _bound(flops: float, nbytes: float):
    """(bound ms, 'operations' or 'bytes') at the bf16 tensor-core peak."""
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _block_flops(windows: int, c: int, n: int = 64) -> float:
    """The block's work, not the kernels' padded form: 16C^2 + 4NC flops
    per token (qkv 6C^2, scores and P*V 4NC, proj 2C^2, MLP 8C^2)."""
    return windows * n * (16 * c * c + 4 * n * c)


def _plan_bytes(plan) -> int:
    """A block's weights and bias as the work reads them once: the
    kernel_layout arrays (the stage kernels' panels pad them further, and
    their fragment-ordered bias repeats the packed one) and the packed
    bias."""
    from rdst_tpu_torch.kernels.swin_block import kernel_layout

    layout = kernel_layout(plan.params) if plan.route != "tokens" \
        else plan.layout
    return sum(t.numel() * t.element_size() for t in layout) + \
        plan.bias.numel() * plan.bias.element_size()


def _rdstb_bound(plan, x, images: int, x_size):
    """An RDSTB call's (bound ms, its kind, flops): the blocks of its DSTLs
    (each DSTL's width is its adapter's input) and the 3x3 conv from the
    concatenated channels; bytes: tokens in and out, every weight and
    bias once."""
    h, w = x_size
    nw = (h // 8) * (w // 8)
    flops = sum(2 * _block_flops(images * nw, d.adapter.w.shape[0])
                for d in plan.dstls) \
        + images * h * w * 2 * plan.wc.shape[0] * plan.wc.shape[1]
    nbytes = 2 * 2 * x.numel() + sum(
        t.numel() * t.element_size() for d in plan.dstls
        for t in (*d.pa, *d.pb, d.bias_a, d.bias_b, *d.adapter)) + sum(
        t.numel() * t.element_size() for t in (plan.wc, plan.bc))
    return (*_bound(flops, nbytes), flops)


def _check(name, got, want):
    rel_max, rel_mean, abs_max = _rel(got, want)
    finite = bool(torch.isfinite(got.float()).all())
    if not (finite and rel_max <= BF16_TOL):
        raise AssertionError(f"{name}: relative max err {rel_max} > "
                             f"{BF16_TOL} (finite={finite})")
    return rel_max, rel_mean, abs_max


@phase("bf16 kernels vs plain")
def bf16_kernel_phase(model) -> dict:
    """Each bf16 kernel's launch alone (weights prepared once, as the
    model keeps them) against its plain version, at bucket 64 with the
    flagship's own weights from its first RDSTB."""
    from rdst_tpu_torch.kernels import rdstb_block, swin_block, swin_pair

    ws, nw, images, nh = 8, 20, 64, 6
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rdstb = model.body[0]
    out = {"block": [], "pair": [], "rdstb": []}
    tok_kernels = swin_block.kernels_per_call(
        "swin_block_fast.cu", "swin_block_fast_tokens_kernels")
    for softmax in ("clamp", "stable_bc"):
        for j, c in enumerate((60, 90, 120)):
            for k, shift in enumerate((0, ws // 2)):
                blk = rdstb.body[j].body.blocks[k]
                inputs = blk.fast_kernel_inputs(LR_HW, ws, shift)
                plan = swin_block.plan_fast_block(*inputs, num_heads=nh)
                if plan.route != "window":
                    raise AssertionError(f"fast block C={c}: route "
                                         f"{plan.route}")
                # the other design at this width, timed beside the plan's
                plan_o = swin_block.plan_fast_block(*inputs, num_heads=nh,
                                                    route="tokens")
                x = torch.randn(images * nw, ws * ws, c, device="cuda",
                                generator=gen).to(torch.bfloat16)
                kw = dict(num_heads=nh, windows_per_image=nw, softmax=softmax)
                with torch.inference_mode():
                    got = swin_block.run_fast_block(x, plan, **kw)
                    again = swin_block.run_fast_block(x, plan, **kw)
                    got_o = swin_block.run_fast_block(x, plan_o, **kw)
                    want = swin_block.swin_block_fast_reference(
                        x, plan.params, plan.bias, num_heads=nh,
                        softmax=softmax)
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise AssertionError(f"fast block C={c} shift="
                                             f"{shift} {softmax}: two "
                                             "launches differ")
                    err = _check(f"fast block C={c} shift={shift} {softmax}",
                                 got, want)
                    err_o = _check(f"fast block C={c} shift={shift} "
                                   f"{softmax} (tokens)", got_o, want)
                    ms = cuda_time_ms(lambda: swin_block.run_fast_block(
                        x, plan, **kw))
                    ms_o = cuda_time_ms(lambda: swin_block.run_fast_block(
                        x, plan_o, **kw))
                    plain_ms = cuda_time_ms(
                        lambda: swin_block.swin_block_fast_reference(
                            x, plan.params, plan.bias, num_heads=nh,
                            softmax=softmax))
                    flops = _block_flops(images * nw, c)
                    extras, free = {}, {}
                    if softmax == "clamp" and shift == 0:
                        extras = {
                            "window": _forward_extras(
                                f"fast block C={c} (window kernel)",
                                lambda: swin_block.run_fast_block(
                                    x, plan, **kw), 1, WINDOW_PHASES, flops),
                            "tokens": _forward_extras(
                                f"fast block C={c} (tokens)",
                                lambda: swin_block.run_fast_block(
                                    x, plan_o, **kw),
                                tok_kernels, FAST_PHASES, flops)}
                    if c == 60 and softmax == "clamp":
                        free = _without_turns(x, plan, nh, softmax, got, ms)
                bound_ms, by = _bound(flops, 2 * 2 * x.numel()
                                      + _plan_bytes(plan))
                row = dict(c=c, shift=shift, softmax=softmax, rel_max=err[0],
                           rel_mean=err[1], max_abs_err=err[2], ms=ms,
                           plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                           route=plan.route, other_route=plan_o.route,
                           other_ms=ms_o, other_rel_max=err_o[0],
                           extras=extras, without_turns=free)
                out["block"].append(row)
                log(f"fast block C={c:3d} shift={shift} {softmax:9s}: rel "
                    f"max {err[0]:.3e} mean {err[1]:.3e} (bar {BF16_TOL}) "
                    f"kernel ({plan.route}) {ms:.4f} ms, tokens {ms_o:.4f} "
                    f"ms (rel max {err_o[0]:.3e}); plain {plain_ms:.4f} ms "
                    f"bound {bound_ms:.4f} ms ({by}, "
                    f"{flops / ms / 1e9:.1f} TFLOP/s)")
    # every instantiation the source builds: 32 NT output columns, NT 2 /
    # 3 / 4 at C = 60 / 90 / 120 (NT 1, which serialized its wgmma, is not
    # built: C <= 32 takes the token-parallel forward)
    out["ptxas"] = _ptxas_check("swin_block_fast.cu", "fast_window_kernel")
    if any("ILi1E" in name for name in out["ptxas"]):
        raise AssertionError("fast_window_kernel<1> is built")
    out["int8_c96"] = _int8_window_case(gen)
    softmax = model.softmax
    for j, c in enumerate((60, 90, 120)):
        layer = rdstb.body[j].body
        a, b = layer.blocks
        plan_a = swin_block.plan_fast_block(
            *a.fast_kernel_inputs(LR_HW, ws, 0), num_heads=nh, route="stage")
        plan_b = swin_block.plan_fast_block(
            *b.fast_kernel_inputs(LR_HW, ws, ws // 2), num_heads=nh,
            route="stage")
        x = torch.randn(images * nw, ws * ws, c, device="cuda",
                        generator=gen).to(torch.bfloat16)
        kw = dict(num_heads=nh, x_size=LR_HW, window_size=ws, shift=ws // 2,
                  softmax=softmax)
        args = (x, plan_a.params, plan_a.bias, plan_b.params, plan_b.bias)
        with torch.inference_mode():
            got = swin_pair.run_swin_pair(x, plan_a, plan_b, **kw)
            want = swin_pair.swin_pair_reference(*args, **kw)
            staged = swin_pair.swin_pair_staged_reference(*args, **kw)
            torch.cuda.synchronize()
            err = _check(f"pair C={c}", got, want)
            err_s = _check(f"pair C={c} vs staged", got, staged)
            ms = cuda_time_ms(lambda: swin_pair.run_swin_pair(
                x, plan_a, plan_b, **kw))
            plain_ms = cuda_time_ms(lambda: swin_pair.swin_pair_reference(
                *args, **kw))
            nt = (c + 31) // 32
            extras = _stage_extras(
                f"pair C={c}",
                lambda: swin_pair.run_swin_pair(x, plan_a, plan_b, **kw),
                swin_pair.run_swin_pair,
                ((f"stage_kernel<{nt}, false>", f"stage A, C = {c}"),
                 (f"stage_kernel<{nt}, true>", f"stage B, C = {c}")))
        flops = 2 * _block_flops(images * nw, c)
        bound_ms, by = _bound(flops, 2 * 2 * x.numel() + _plan_bytes(plan_a)
                              + _plan_bytes(plan_b))
        out["pair"].append(dict(c=c, rel_max=err[0], rel_mean=err[1],
                                max_abs_err=err[2], staged_rel_max=err_s[0],
                                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=by, **extras))
        log(f"pair C={c:3d} {softmax}: rel max {err[0]:.3e} mean "
            f"{err[1]:.3e}, vs staged {err_s[0]:.3e}; kernels {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({by}, "
            f"{flops / ms / 1e9:.1f} TFLOP/s)")
    h, w = LR_HW
    plan = rdstb_block.plan_rdstb(
        *rdstb.rdstb_inputs(LR_HW, ws, ws // 2), num_heads=nh,
        growth=rdstb.growth_rate, adapter_prenorm=rdstb.pre_norm)
    x = torch.randn(images, h * w, 60, device="cuda",
                    generator=gen).to(torch.bfloat16)
    kw = dict(num_heads=nh, x_size=LR_HW, window_size=ws, shift=ws // 2,
              softmax=softmax)
    rkw = dict(growth=plan.growth, adapter_prenorm=plan.prenorm, **kw)
    with torch.inference_mode():
        got = rdstb_block.run_rdstb(x, plan, **kw)
        want = rdstb_block.rdstb_reference(x, plan.dstls, plan.wc, plan.bc,
                                           **rkw)
        staged = rdstb_block.rdstb_staged_reference(
            x, plan.dstls, plan.wc, plan.bc, **rkw)
        torch.cuda.synchronize()
        err = _check("rdstb", got, want)
        err_s = _check("rdstb vs staged", got, staged)
        ms = cuda_time_ms(lambda: rdstb_block.run_rdstb(x, plan, **kw))
        plain_ms = cuda_time_ms(lambda: rdstb_block.rdstb_reference(
            x, plan.dstls, plan.wc, plan.bc, **rkw), warmup=1, iters=5)
        phases = []
        for c in (60, 90, 120):
            nt = (c + 31) // 32
            phases += [(f"stage_kernel<{nt}, false>", f"stage A, C = {c}"),
                       (f"stage_kernel<{nt}, true>",
                        f"stage B + adapter, C = {c}")]
        extras = _stage_extras(
            "rdstb", lambda: rdstb_block.run_rdstb(x, plan, **kw),
            rdstb_block.run_rdstb, tuple(phases) + (("conv_kernel", "conv"),))
    bound_ms, by, flops = _rdstb_bound(plan, x, images, LR_HW)
    out["rdstb"].append(dict(rel_max=err[0], rel_mean=err[1],
                             max_abs_err=err[2], staged_rel_max=err_s[0],
                             ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=by, flops=flops, **extras))
    log(f"rdstb {softmax}: rel max {err[0]:.3e} mean {err[1]:.3e}, vs "
        f"staged {err_s[0]:.3e}; kernels {ms:.4f} ms plain {plain_ms:.4f} "
        f"ms bound {bound_ms:.4f} ms ({by}, {flops / ms / 1e9:.1f} TFLOP/s)")
    out["window16"] = _window16_cases(gen)
    log("library yardstick: no single PyTorch call computes a Swin block, "
        "a DSTL pair or an RDSTB")
    return out


@phase("bf16 whole model")
def bf16_model_phase(live16, live32, live_cpu) -> dict:
    """The bf16 model in each kernel mode: launches per forward; the card
    against the same model and route on the CPU, where every kernel
    wrapper takes its plain version (bar BF16_TOL); against the plain
    bf16 modules (mode off, the XLA-style path with other roundings:
    reported) and against the f32 kernel path (relative error, PSNR)."""
    from rdst_tpu_torch.kernels import rdstb_block, swin_block, swin_pair
    from rdst_tpu_torch.models.rdst import set_kernel_mode

    rng = np.random.default_rng(SEED + 4)
    x = rng.random((8,) + LR_HW + (1,), dtype=np.float32)
    x64 = rng.random((64,) + LR_HW, dtype=np.float32)
    model = live16.model
    softmax = model.softmax
    y32 = live32.predict(x, SCALE)
    set_kernel_mode(model, "", softmax)
    try:
        y_off = live16.predict(x, SCALE)
    finally:
        set_kernel_mode(model, "rdstb", softmax)
    counters = {"rdstb": (rdstb_block.run_rdstb, 8),
                "pair": (swin_pair.run_swin_pair, 24),
                "swin": (swin_block.run_fast_block, 48)}
    out = {}

    def versus(y, ref):
        r = _rel(torch.from_numpy(y), torch.from_numpy(ref))
        return r[0], r[1], float(10 * np.log10(1.0 / np.mean((y - ref) ** 2)))

    off = versus(y_off, y32)
    log(f"bf16 plain modules (mode off) vs f32 kernel path: rel max "
        f"{off[0]:.3e} mean {off[1]:.3e}, PSNR {off[2]:.2f} dB")
    if off[0] >= BF16_VS_F32_MAX or off[1] >= BF16_VS_F32_MEAN:
        raise AssertionError(f"bf16 plain modules vs f32: {off}")
    out["off"] = {"vs_f32_rel_max": off[0], "vs_f32_rel_mean": off[1],
                  "psnr_vs_f32_db": off[2]}
    try:
        for mode, (counter, want_launches) in counters.items():
            set_kernel_mode(model, mode, softmax)
            set_kernel_mode(live_cpu.model, mode, softmax)
            y_cpu = live_cpu.predict(x, SCALE)  # the plain versions
            for c, _ in counters.values():
                c.launches = 0  # this mode's path starts here
            y = live16.predict(x, SCALE)
            launches = {c.__name__: c.launches for c, _ in counters.values()}
            if launches[counter.__name__] != want_launches or sum(
                    launches.values()) != want_launches:
                raise AssertionError(f"mode {mode}: launches {launches}, "
                                     f"expected {want_launches} of "
                                     f"{counter.__name__}")
            if not np.isfinite(y).all():
                raise AssertionError(f"mode {mode}: non-finite output")
            kp, ko, kf = versus(y, y_cpu), versus(y, y_off), versus(y, y32)
            log(f"bf16 mode {mode}: {want_launches} launches of "
                f"{counter.__name__} per forward; vs its plain versions (the "
                f"CPU run) rel max {kp[0]:.3e} (bar {BF16_TOL}); vs plain "
                f"modules rel max {ko[0]:.3e}; vs f32 kernel path rel max "
                f"{kf[0]:.3e} mean {kf[1]:.3e}, PSNR {kf[2]:.2f} dB")
            if kp[0] > BF16_TOL:
                raise AssertionError(f"mode {mode} vs plain versions: {kp}")
            if kf[0] >= BF16_VS_F32_MAX or kf[1] >= BF16_VS_F32_MEAN:
                raise AssertionError(f"mode {mode} vs f32: {kf}")
            wall, busy = _device_ms(lambda: live16.predict(x64, SCALE))
            log(f"bf16 mode {mode}: one warm bucket-64 forward {wall:.3f} ms "
                "wall, device " + (f"{busy:.3f} ms" if busy is not None
                                   else "not measured (no profiler time)"))
            out[mode] = {"launches_per_forward": launches[counter.__name__],
                         "vs_plain_versions_rel_max": kp[0],
                         "vs_plain_modules_rel_max": ko[0],
                         "vs_f32_rel_max": kf[0], "vs_f32_rel_mean": kf[1],
                         "psnr_vs_f32_db": kf[2],
                         "bucket64_wall_ms": wall,
                         "bucket64_device_ms": busy}
    finally:
        set_kernel_mode(model, "rdstb", softmax)
    return out


bf16_serving_phase = phase("bf16 serving")(_serve)
bf16_profile_phase = phase("bf16 profile")(_profile)


def _pair_train_operands(model, j: int, c: int, gen):
    """Folded weights of the first RDSTB's DSTL j (width c) of ``model`` at
    the training geometry, with random bf16 tokens and cotangents."""
    from rdst_tpu_torch.kernels.swin_block import fast_params, pack_bias_fast

    ws, nh, images, nw = 8, 6, 32, 9
    a, b = model.body[0].body[j].body.blocks
    pa, ba = a.fast_kernel_inputs((24, 24), ws, 0)
    pb, bb = b.fast_kernel_inputs((24, 24), ws, ws // 2)
    with torch.no_grad():
        ops = [*fast_params(pa, c, nh), pack_bias_fast(ba, nh, 64),
               *fast_params(pb, c, nh), pack_bias_fast(bb, nh, 64)]
    x = torch.randn(images * nw, 64, c, device="cuda",
                    generator=gen).to(torch.bfloat16)
    dz = torch.randn(images * nw, 64, c, device="cuda",
                     generator=gen).to(torch.bfloat16)
    keep = 0.9
    cols = (torch.rand(images, 4, device="cuda", generator=gen) < keep)
    dpf = (cols.float() / keep).repeat_interleave(nw * 64, 0).contiguous()
    return [o.detach().contiguous() for o in ops], x, dz, dpf


def _pair_train_grads(fn, ops, x, dz, dpf, kw):
    """Output and gradients (input, then every operand) of fn."""
    from rdst_tpu_torch.kernels.swin_block import FastParams

    leaves = [t.detach().clone().requires_grad_(True) for t in [x] + ops]
    out = fn(leaves[0], FastParams(*leaves[1:9]), leaves[9],
             FastParams(*leaves[10:18]), leaves[18], dpf, **kw)
    out.backward(dz)
    return out.detach(), [t.grad for t in leaves]


# The backward's kernels by phase (csrc/block_bwd.cuh), as the profiler
# names them: (part of the kernel's name, phase)
BWD_PHASES = (
    ("prep_weights", "weights padded"),
    ("rows_kernel", "LN1 rows, fm dz"),
    ("EpiQkv", "qkv GEMM"),
    ("attn_fwd", "attention forward"),
    ("EpiProjLn", "proj GEMM + residual + LN2"),
    ("EpiFc1", "fc1 GEMM + GELU"),
    ("EpiDu", "dh2 W2^T GEMM -> du"),
    ("EpiLn2Bwd", "du W1^T GEMM + LN2 VJP"),
    ("EpiDout", "dy Wproj^T GEMM -> dO"),
    ("attn_vjp", "attention VJP"),
    ("EpiLn1Bwd", "dqkv Wqkv^T GEMM + LN1 VJP"),
    ("wgrad", "weight gradients (split K)"),
    ("reduce_kernel", "fixed-order sums"),
)


def _flat(tree):
    """The tensors of a nested tuple, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for part in tree for t in _flat(part)]


# The f32 block's kernels (csrc/swin_block.cu) and the token-parallel fast
# block's (csrc/swin_block_fast.cu), as the profiler names them
F32_PHASES = (
    ("ln1_kernel", "LN1 rows"),
    ("EpiQkv", "qkv GEMM (3xTF32) + bias, q scale"),
    ("attn_kernel", "attention (f32 FMA)"),
    ("EpiProjLn", "proj GEMM (3xTF32) + residual + LN2"),
    ("EpiFc1", "fc1 GEMM (3xTF32) + erf GELU"),
    ("EpiOut", "fc2 GEMM (3xTF32) + residual"),
)
FAST_PHASES = (
    ("ln1_rows_kernel", "LN1 rows (int8 or bf16)"),
    ("EpiQkvS8", "qkv GEMM (int8, wgmma .s8)"),
    ("EpiQkv", "qkv GEMM (bf16, wgmma)"),
    ("attn_fwd_kernel", "attention"),
    ("EpiProjLn", "proj GEMM + residual + LN2 (wgmma)"),
    ("mlp_kernel", "fc1 + tanh GELU + fc2 + residual (wgmma, fused)"),
)

# the persistent window kernel of the fast block at C <= 120
WINDOW_PHASES = (("fast_window_kernel", "persistent window kernel"),)


def _without_turns(x, plan, nh: int, softmax: str, got, ms: float) -> dict:
    """The persistent window kernel with its warpgroups free of the
    tensor-core turns (``window_kernel_without_turns``; every weight
    resident): bitwise the kernel's output, and its time beside the
    kernel's, which says what the turns overlap."""
    from rdst_tpu_torch.kernels import swin_block

    def call():
        return swin_block.window_kernel_without_turns(
            x, plan, num_heads=nh, softmax=softmax)

    free = call()
    torch.cuda.synchronize()
    if not torch.equal(free, got):
        raise AssertionError("the window kernel without turns differs from "
                             "the kernel")
    ms_free = cuda_time_ms(call)
    log(f"  without turns: {ms_free:.4f} ms against {ms:.4f} ms with them "
        f"({(ms_free - ms) / ms_free:+.1%} of the time taken off by the "
        "turns); bitwise equal")
    return {"ms": ms_free, "ms_with_turns": ms}


def _ptxas_check(source: str, key: str, path=None) -> dict:
    """The ptxas report of the kernels of ``source`` whose names hold
    ``key``: registers, spill bytes and wgmma serialization warnings,
    logged; a spill or a warning fails the phase for a kernel on the main
    path (every one, or those whose names hold an item of ``path``); one
    off the path is logged as such."""
    rep = {k: v for k, v in _ptxas_kernels(source).items() if key in k}
    if not rep:
        raise AssertionError(f"no ptxas report of {key} in {source}")
    for name, r in rep.items():
        on = path is None or any(p in name for p in path)
        log(f"  ptxas {source} {name}: {r['registers']} registers, "
            f"{r['spill_bytes']} spill bytes, {len(r['warnings'])} wgmma "
            "serialization warnings" + ("" if on else " (not on the path)"))
        r["on_path"] = on
        if on and (r["spill_bytes"] or r["warnings"]):
            raise AssertionError(f"{name} spills or serializes wgmma: {r}")
    return rep


def _int8_window_case(gen) -> dict:
    """int8 qkv at C = 96 (RDST-W96's first DSTL width in mode swin) on a
    seeded block, bucket 64: the plan routes it to the token-parallel
    forward (the window body has no int8 product); against the plain
    version with the same int8 operands, two launches bitwise equal, its
    time beside the plain time and the bound."""
    from rdst_tpu_torch.kernels import swin_block

    c, nh, ws, nw, images = 96, 6, 8, 20, 64
    rng = np.random.default_rng(SEED + 11)
    plan = swin_block.plan_fast_block(*_random_block(rng, c, nh, ws, False),
                                      num_heads=nh,
                                      quant=frozenset({"qkv"}))
    if plan.route != "tokens":
        raise AssertionError(f"int8 qkv at C = 96: route {plan.route}")
    x = torch.randn(images * nw, ws * ws, c, device="cuda",
                    generator=gen).to(torch.bfloat16)
    kw = dict(num_heads=nh, windows_per_image=nw, softmax="clamp")
    with torch.inference_mode():
        got = swin_block.run_fast_block(x, plan, **kw)
        again = swin_block.run_fast_block(x, plan, **kw)
        want = swin_block.swin_block_fast_reference(
            x, plan.params, plan.bias, num_heads=nh, softmax="clamp",
            qkv=plan.qkv)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("int8 C = 96: two launches differ")
        err = _check("fast block C=96 int8 qkv (tokens)", got, want)
        ms = cuda_time_ms(lambda: swin_block.run_fast_block(x, plan, **kw))
        plain_ms = cuda_time_ms(lambda: swin_block.swin_block_fast_reference(
            x, plan.params, plan.bias, num_heads=nh, softmax="clamp",
            qkv=plan.qkv))
    bound_ms, by = _int8_qkv_bound(images * nw * ws * ws, c,
                                   2 * 2 * x.numel() + _plan_bytes(plan))
    log(f"fast block C= 96 int8 qkv (tokens): rel max {err[0]:.3e}; "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({by}); two launches bitwise equal")
    return dict(rel_max=err[0], max_abs_err=err[2], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, route=plan.route)


def _phase_ms(call, iters: int = 5, phases=BWD_PHASES) -> dict:
    """Device time of one call by phase (torch.profiler, CUPTI; a kernel
    whose name holds a key of ``phases`` counts to its phase), ms per
    call; {} when the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = float(e.self_device_time_total or 0.0)
        if e.device_type != DeviceType.CUDA or t <= 0:
            continue
        label = next((ph for key, ph in phases if key in e.key), "other")
        out[label] = out.get(label, 0.0) + t / iters / 1e3
    return out


def _backward_extras(label: str, call, counter, vjp: int, staged) -> dict:
    """The backward launch alone at the timed variant: two launches on
    the same inputs bitwise equal; kernels per call (``reductions`` counts
    those beside the ``vjp`` attention VJP kernels of a call); the result
    against the staged plain VJP (``block_bwd_reference``), bar BF16_TOL;
    device time per phase."""
    counter.launches = counter.reductions = 0
    first = _flat(call())
    torch.cuda.synchronize()
    kernels = (counter.reductions + vjp * counter.launches) / counter.launches
    second = _flat(call())
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{label}: two backward launches on the same "
                             "inputs differ")
    want = _flat(staged())
    errs = [_rel(a, b)[0] for a, b in zip(first, want)]
    finite = all(bool(torch.isfinite(a.float()).all()) for a in first)
    if not finite or max(errs) > BF16_TOL:
        raise AssertionError(f"{label}: backward vs the staged plain VJP "
                             f"{errs} (finite={finite})")
    phases = _phase_ms(call)
    log(f"  {label} backward: two launches bitwise equal; {kernels:g} "
        f"kernels a call; vs the staged plain VJP rel max {max(errs):.3e} "
        f"(bar {BF16_TOL})")
    if phases:
        total = sum(phases.values())
        log(f"  {label} backward by phase (torch.profiler, ms a call; "
            f"{total:.4f} in all):")
        for ph, ms in phases.items():
            log(f"    {ms:8.4f}  {ph}")
    else:
        log("  torch.profiler recorded no device time: phases not measured")
    return {"deterministic": True, "kernels_per_call": kernels,
            "staged_rel_max": max(errs), "phases_ms": phases}


def _forward_extras(label: str, call, kernels: int, phases, flops: float):
    """A redesigned forward's launch alone: two launches on the same
    inputs bitwise equal, its kernels a call, device time per phase
    (torch.profiler) and the achieved rate of the block's work."""
    first = call()
    torch.cuda.synchronize()
    second = call()
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        raise AssertionError(f"{label}: two launches on the same inputs "
                             "differ")
    ms = _phase_ms(call, phases=phases)
    total = sum(ms.values())
    rate = flops / total / 1e9 if total else None
    if ms:
        log(f"  {label}: two launches bitwise equal; {kernels} kernels a "
            f"call; by phase (torch.profiler, ms a call; {total:.4f} in all, "
            f"{rate:.1f} TFLOP/s of block work):")
        for ph, t in ms.items():
            log(f"    {t:8.4f}  {ph}")
    else:
        log(f"  {label}: two launches bitwise equal; {kernels} kernels a "
            "call; torch.profiler recorded no device time: phases not "
            "measured")
    return {"deterministic": True, "kernels_per_call": kernels,
            "phases_ms": ms, "phase_tflops": rate}


def _stage_extras(label: str, call, counter, phases) -> dict:
    """A stage-kernel call alone (the pair's or the RDSTB's): two calls on
    the same inputs bitwise equal; the kernels a call (the wrapper's
    ``kernels`` count over its ``launches``); device time per stage
    kernel (torch.profiler)."""
    counter.launches = counter.kernels = 0
    first = call()
    torch.cuda.synchronize()
    kernels = counter.kernels / counter.launches
    second = call()
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        raise AssertionError(f"{label}: two calls on the same inputs differ")
    ms = _phase_ms(call, phases=phases)
    total = sum(ms.values())
    if ms:
        log(f"  {label}: two calls bitwise equal; {kernels:g} kernels a "
            f"call; by stage (torch.profiler, ms a call; {total:.4f} in "
            "all):")
        for ph, t in ms.items():
            log(f"    {t:8.4f}  {ph}")
    else:
        log(f"  {label}: two calls bitwise equal; {kernels:g} kernels a "
            "call; torch.profiler recorded no device time: stages not "
            "measured")
    return {"deterministic": True, "kernels_per_call": kernels,
            "stages_ms": ms}


def _random_block(rng, c: int, nh: int, ws: int, shifted: bool):
    """A seeded 12-param bundle (JAX layout) and head-major bf16 bias
    (rel-pos, + the shift mask per window when shifted) for window ws on
    the LR_HW image, on the card."""
    from rdst_tpu_torch.nn.swin import (relative_position_index,
                                        shift_attention_mask)

    n, hid = ws * ws, 2 * c
    h, w = LR_HW

    def f(*shape, scale=0.2):
        return torch.from_numpy(rng.normal(0.0, scale, shape).astype(
            np.float32)).cuda()

    params = [f(c, 3 * c, scale=c ** -0.5), f(3 * c),
              f(c, c, scale=c ** -0.5), f(c), 1.0 + f(c), f(c), 1.0 + f(c),
              f(c), f(c, hid, scale=c ** -0.5), f(hid),
              f(hid, c, scale=hid ** -0.5), f(c)]
    table = rng.normal(0.0, 1.0, ((2 * ws - 1) ** 2, nh)).astype(np.float32)
    rel = table[relative_position_index(ws, ws).reshape(-1)].reshape(
        n, n, nh).transpose(2, 0, 1)
    if shifted:
        rel = (rel[:, None] + shift_attention_mask(h, w, ws, ws // 2)[None]
               ).reshape(-1, n, n)
    bias = torch.from_numpy(np.ascontiguousarray(rel, np.float32)).cuda()
    return params, bias.to(torch.bfloat16)


def _window16_cases(gen) -> dict:
    """16-token windows (window 4, which both gates admit at the flagship
    widths) on seeded random weights, 8 images: the pair at C = 60 and a
    whole RDSTB (C0 = 60, growth 30, 3 DSTLs, pre-norm adapters), each
    against its plain and staged versions (bar BF16_TOL), two calls
    bitwise equal; then the fast block's window kernel at C = 60 and 120,
    unshifted and shifted, against its plain version."""
    from rdst_tpu_torch.kernels import rdstb_block, swin_block, swin_pair

    ws, nh, images, c0, g = 4, 6, 8, 60, 30
    h, w = LR_HW
    nw = (h // ws) * (w // ws)
    if not (swin_block.fast_kernel_supports(16, c0, nh, 2 * c0)
            and rdstb_block.rdstb_kernel_supports(16, c0, g, 3, nh, 2.0)):
        raise AssertionError("the gates refuse 16-token windows at C0 = 60")
    rng = np.random.default_rng(SEED + 7)
    kw = dict(num_heads=nh, x_size=LR_HW, window_size=ws, shift=ws // 2,
              softmax="clamp")
    out = {}
    plan_a = swin_block.plan_fast_block(*_random_block(rng, c0, nh, ws, False),
                                        num_heads=nh, route="stage")
    plan_b = swin_block.plan_fast_block(*_random_block(rng, c0, nh, ws, True),
                                        num_heads=nh, route="stage")
    x = torch.randn(images * nw, ws * ws, c0, device="cuda",
                    generator=gen).to(torch.bfloat16)
    args = (x, plan_a.params, plan_a.bias, plan_b.params, plan_b.bias)
    with torch.inference_mode():
        got = swin_pair.run_swin_pair(x, plan_a, plan_b, **kw)
        again = swin_pair.run_swin_pair(x, plan_a, plan_b, **kw)
        want = swin_pair.swin_pair_reference(*args, **kw)
        staged = swin_pair.swin_pair_staged_reference(*args, **kw)
        torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("pair, window 4: two calls differ")
    out["pair"] = {"rel_max": _check("pair window 4", got, want)[0],
                   "staged_rel_max": _check("pair window 4 vs staged", got,
                                            staged)[0]}
    dstls, c = [], c0
    for _ in range(3):
        blocks = [_random_block(rng, c, nh, ws, s) for s in (False, True)]

        def f(*shape, scale=0.2):
            return torch.from_numpy(rng.normal(0.0, scale, shape).astype(
                np.float32)).cuda()

        dstls.append({"blocks": blocks, "adapter": (
            f(c, g, scale=c ** -0.5), f(g), 1.0 + f(c), f(c))})
        c += g
    wconv = torch.from_numpy(rng.normal(0.0, (9 * c) ** -0.5, (3, 3, c, c0))
                             .astype(np.float32)).cuda()
    bconv = torch.from_numpy(rng.normal(0.0, 0.2, c0).astype(
        np.float32)).cuda()
    plan = rdstb_block.plan_rdstb(dstls, wconv, bconv, num_heads=nh,
                                  growth=g, adapter_prenorm=True)
    x = torch.randn(images, h * w, c0, device="cuda",
                    generator=gen).to(torch.bfloat16)
    rkw = dict(growth=g, adapter_prenorm=True, **kw)
    with torch.inference_mode():
        got = rdstb_block.run_rdstb(x, plan, **kw)
        again = rdstb_block.run_rdstb(x, plan, **kw)
        want = rdstb_block.rdstb_reference(x, plan.dstls, plan.wc, plan.bc,
                                           **rkw)
        staged = rdstb_block.rdstb_staged_reference(
            x, plan.dstls, plan.wc, plan.bc, **rkw)
        torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("rdstb, window 4: two calls differ")
    out["rdstb"] = {"rel_max": _check("rdstb window 4", got, want)[0],
                    "staged_rel_max": _check("rdstb window 4 vs staged", got,
                                             staged)[0]}
    out["block"] = {}
    for c in (60, 120):  # the window kernel, weights resident / streamed
        for shifted in (False, True):
            plan = swin_block.plan_fast_block(
                *_random_block(rng, c, nh, ws, shifted), num_heads=nh)
            if plan.route != "window":
                raise AssertionError(f"window 4, C={c}: route {plan.route}")
            x = torch.randn(images * nw, ws * ws, c, device="cuda",
                            generator=gen).to(torch.bfloat16)
            fkw = dict(num_heads=nh, windows_per_image=nw, softmax="clamp")
            with torch.inference_mode():
                got = swin_block.run_fast_block(x, plan, **fkw)
                again = swin_block.run_fast_block(x, plan, **fkw)
                want = swin_block.swin_block_fast_reference(
                    x, plan.params, plan.bias, num_heads=nh, softmax="clamp")
                torch.cuda.synchronize()
            label = f"fast block window 4 C={c} shift={ws // 2 * shifted}"
            if not torch.equal(got, again):
                raise AssertionError(f"{label}: two launches differ")
            out["block"][label] = _check(label, got, want)[0]
    log(f"window 4 (16-token windows, {images} images, random weights): "
        f"pair rel max {out['pair']['rel_max']:.3e} (staged "
        f"{out['pair']['staged_rel_max']:.3e}), rdstb rel max "
        f"{out['rdstb']['rel_max']:.3e} (staged "
        f"{out['rdstb']['staged_rel_max']:.3e}), fast block rel max "
        + ", ".join(f"{v:.3e}" for v in out["block"].values())
        + "; two calls bitwise equal")
    return out


def _profiled(fn, host: bool = True):
    """(wall us, the profiler's CUDA events) of one call of fn(); with
    ``host`` False the profiler records the device's activity only (the
    host's ops of a step of tens of thousands of launches cost the
    profiler tens of seconds to record and sum)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    return wall_us, events, [e for e in events
                             if e.device_type == DeviceType.CUDA]


def _device_ms(fn):
    """(wall ms, device ms) of one warm fn(): the host clock around it to
    a synchronize, and the sum of its kernels' device time by
    torch.profiler (None when the profiler records none)."""
    fn()
    torch.cuda.synchronize()
    wall, _, device = _profiled(fn)
    busy = sum(float(e.self_device_time_total or 0.0) for e in device)
    return wall / 1e3, (busy / 1e3 if busy else None)


# the train pair's forward (csrc/pair_train.cu), as the profiler names it
TRAIN_FWD_PHASES = (("pair_train_fwd_kernel", "persistent chained window "
                     "kernel"),)


# spin kernels (``torch.cuda._sleep``, about 0.5 us each) before and
# after the calls a profiler session counts. A session can lose the
# first kernel records it should hold: none early in a process, 2-3 after
# a few hundred sessions, and 71 once in a whole run (its 32 leading
# spins and 39 of the calls' 80 kernels); at times it loses its tail
# instead, trailing spins and the last call's kernels. The calls'
# kernels are all recorded when the first and last kernels recorded (in
# start order) are spins: such a session is whole. One that is not is
# opened again, up to PROFILE_TRIES sessions
PROFILE_PAD = 128
PROFILE_TRIES = 4


def _kernels_per_call(call, iters: int = 5) -> dict:
    """The CUDA kernels of a call by torch.profiler (memory sets, copies
    and the pad apart): ``kernels``, the distinct kernels launched (each
    call is the same), ``events``, the kernel events recorded a call,
    ``pad``, the share of the PROFILE_PAD spin kernels before and after
    the calls that the session recorded, ``whole``, whether the calls lie
    between recorded spins, and ``sessions``, the sessions opened to get
    a whole one (the last is returned when none was whole); 0 kernels and
    events when the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for n in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(1000)
            for _ in range(iters):
                call()
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        kernels = sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA
             and "memset" not in e.name.lower()
             and "memcpy" not in e.name.lower()),
            key=lambda e: e.time_range.start)
        spin = ["spin_kernel" in e.name for e in kernels]
        names = {}
        for e in kernels:
            if "spin_kernel" not in e.name:
                names[e.name] = names.get(e.name, 0) + 1
        out = {"kernels": len(names),
               "events": sum(names.values()) / iters, "names": sorted(names),
               "pad": sum(spin) / (2 * PROFILE_PAD),
               "whole": bool(spin) and spin[0] and spin[-1],
               "sessions": n}
        if out["whole"] or not kernels:
            return out
    return out


def _train_pair_widths(model, widths, label: str) -> list:
    """The train-pair kernels at the training geometry (32 images of 24x24,
    window 8, shift 4) with ``model``'s weights, the first RDSTB's DSTLs of
    the given widths: each variant's output and every gradient against
    the plain version and its autograd (bar BF16_TOL); at the timed variant
    ('clamp', no factor columns) the forward launch alone (two launches
    bitwise equal, output and y, kernels a call, device time), its time
    by CUDA events beside its bound and the plain version's, at C = 60
    also with the tensor-core turns; the backward's extras."""
    from rdst_tpu_torch.kernels import block_train as bt
    from rdst_tpu_torch.kernels import pair_train as pt
    from rdst_tpu_torch.kernels.swin_block import FastParams, softmax_code
    from rdst_tpu_torch.kernels.swin_pair import (shift_relayout,
                                                  unshift_relayout)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    names = (["x"] + [f"a.{f}" for f in FastParams._fields] + ["bias_a"]
             + [f"b.{f}" for f in FastParams._fields] + ["bias_b"])
    rows = []
    for j, c in widths:
        ops, x, dz, dpf0 = _pair_train_operands(model, j, c, gen)
        variants = [(s, d) for s in ("clamp", "stable") for d in (False, True)]
        if c == 60:  # the wrapper takes stable_mm too: hold it once
            variants.append(("stable_mm", False))
        for softmax, use_dpf in variants:
            dpf = dpf0 if use_dpf else None
            kw = dict(num_heads=6, x_size=(24, 24), window_size=8,
                      shift=4, softmax=softmax)
            got, g_got = _pair_train_grads(pt.run_pair_train, ops, x,
                                           dz, dpf, kw)
            want, g_want = _pair_train_grads(pt.pair_train_reference,
                                             ops, x, dz, dpf, kw)
            torch.cuda.synchronize()
            errs = {"out": _rel(got, want)}
            for nm, a, b in zip(names, g_got, g_want):
                errs[nm] = _rel(a, b)
            worst = max(errs, key=lambda k: errs[k][0])
            finite = all(bool(torch.isfinite(g.float()).all())
                         for g in g_got) and bool(
                             torch.isfinite(got.float()).all())
            log(f"train pair {label} C={c:3d} {softmax:9s} "
                f"dpf={use_dpf!s:5s}: out rel max {errs['out'][0]:.3e}, dx "
                f"{errs['x'][0]:.3e}, worst {worst} "
                f"{errs[worst][0]:.3e} (bar {BF16_TOL})")
            if not finite or errs[worst][0] > BF16_TOL:
                raise AssertionError(f"train pair {label} C={c} {softmax} "
                                     f"dpf={use_dpf}: {errs}")
            row = dict(c=c, model=label, softmax=softmax, dpf=use_dpf,
                       rel_max={k: v[0] for k, v in errs.items()},
                       out_abs_err=errs["out"][2],
                       grad_abs_err=max(v[2] for k, v in errs.items()
                                        if k != "out"))
            if softmax == "clamp" and not use_dpf:
                geom = ((24, 24), 8, 4, 6, softmax_code(softmax))
                pa, pb = FastParams(*ops[:8]), FastParams(*ops[9:17])
                ba, bb = ops[8], ops[17]
                # the launch alone: weights laid out once
                oa, ob = pt.forward_layout(pa, ba, pb, bb, 6)

                def fwd(turns=None):
                    return pt.launch_forward(x, oa, ob, None, geom, 2 * c,
                                             turns=turns)
                first, y = fwd()
                again, y2 = fwd()
                torch.cuda.synchronize()
                if not (torch.equal(first, again) and torch.equal(y, y2)
                        and torch.equal(first, got)):
                    raise AssertionError(f"train pair {label} C={c}: two "
                                         "forward launches differ")
                row["ms"] = cuda_time_ms(lambda: fwd(), iters=20)
                row["turns"] = pt.forward_turns(64, c, 6, 2 * c)
                if not row["turns"]:
                    with_turns = fwd(True)[0]
                    torch.cuda.synchronize()
                    if not torch.equal(with_turns, first):
                        raise AssertionError("the train pair with turns "
                                             "differs")
                    row["ms_with_turns"] = cuda_time_ms(
                        lambda: fwd(True), iters=20)
                kpc = _kernels_per_call(lambda: fwd())
                row["fwd_kernels_per_call"] = kpc["kernels"]
                if kpc["kernels"] not in (0, 1) or any(
                        "pair_train_fwd_kernel" not in k
                        for k in kpc["names"]):
                    raise AssertionError(f"the train-pair forward launches "
                                         f"{kpc}")
                row["forward_phases_ms"] = _phase_ms(
                    lambda: fwd(), phases=TRAIN_FWD_PHASES)
                row["bwd_ms"] = cuda_time_ms(lambda: pt.launch_backward(
                    x, dz, y, pa, ba, pb, bb, None, geom), warmup=1,
                    iters=5)
                with torch.no_grad():
                    row["plain_ms"] = cuda_time_ms(
                        lambda: pt.pair_train_reference(
                            x, pa, ba, pb, bb, None, **kw))

                # the plain backward alone: autograd through the
                # plain version's graph, built once
                leaves = [t.detach().clone().requires_grad_(True)
                          for t in [x] + ops]
                twin = pt.pair_train_reference(
                    leaves[0], FastParams(*leaves[1:9]), leaves[9],
                    FastParams(*leaves[10:18]), leaves[18], None, **kw)
                row["plain_bwd_ms"] = cuda_time_ms(
                    lambda: torch.autograd.grad(twin, leaves, dz,
                                                retain_graph=True),
                    warmup=1, iters=5)
                del twin, leaves

                def staged():  # block b's staged VJP, then block a's
                    ya = bt.block_train_reference(x, pa, ba, None,
                                                  num_heads=6,
                                                  softmax=softmax)
                    y2 = shift_relayout(ya, (24, 24), 8, 4)
                    dxb, gb, dbb = bt.block_bwd_reference(
                        y2, dz, pb, bb, None, num_heads=6, softmax=softmax)
                    dy = unshift_relayout(dxb, (24, 24), 8, 4)
                    dxa, ga, dba = bt.block_bwd_reference(
                        x, dy, pa, ba, None, num_heads=6, softmax=softmax)
                    return dxa, ga, dba, gb, dbb

                row.update(_backward_extras(
                    f"{label} C={c}", lambda: pt.launch_backward(
                        x, dz, y, pa, ba, pb, bb, None, geom),
                    pt.launch_backward, 2, staged))
                windows = x.shape[0]
                flops = 2 * _block_flops(windows, c)
                wbytes = sum(t.numel() * t.element_size() for t in ops)
                tok = x.numel() * 2
                # forward: x in, out and y (block a's output) written
                row["bound_ms"], row["bound_by"] = _bound(
                    flops, 3 * tok + wbytes)
                # backward: x, dz, y in, dx out, every gradient (f32)
                row["bwd_bound_ms"], row["bwd_bound_by"] = _bound(
                    2 * flops, 4 * tok + wbytes + 2 * wbytes)
                fp = row["forward_phases_ms"]
                log(f"  {label} C={c}: forward {row['ms']:.4f} ms (turns "
                    f"{row['turns']}"
                    + (f"; with turns {row['ms_with_turns']:.4f} ms, bitwise"
                       " the same" if "ms_with_turns" in row else "")
                    + f"; plain {row['plain_ms']:.4f}, bound "
                    f"{row['bound_ms']:.4f} {row['bound_by']}); two launches "
                    f"bitwise equal; {kpc['kernels']} kernel a call "
                    f"({kpc['events']:g} events recorded a call); device "
                    + (", ".join(f"{k} {v:.4f} ms" for k, v in fp.items())
                       if fp else "not measured")
                    + f"; backward {row['bwd_ms']:.4f} ms (plain "
                    f"{row['plain_bwd_ms']:.4f}, bound "
                    f"{row['bwd_bound_ms']:.4f} {row['bwd_bound_by']})")
            rows.append(row)
    return rows


@phase("train-pair kernels vs plain")
def train_kernel_phase(model) -> dict:
    """Forward and backward kernels against the plain version and its
    autograd gradient, at the training geometry of the flagship (C = 60 /
    90 / 120); the forward's ptxas report."""
    rows = _train_pair_widths(model, ((0, 60), (1, 90), (2, 120)), "E1")
    ptxas = _ptxas_check("pair_train.cu", "pair_train_fwd_kernel")
    timed = [r for r in rows if "ms" in r]
    mean = sum(r["ms"] for r in timed) / len(timed)
    log(f"train-pair forward, mean over C = 60/90/120 at 288 windows: "
        f"{mean:.4f} ms; library yardstick: no single PyTorch call computes "
        "a DSTL pair or its gradient")
    return {"variants": rows, "ptxas": ptxas, "forward_mean_ms": mean}


def _train_argv(data_dir: str, out_dir: str, steps: int,
                config: str = TRAIN_CONFIG) -> list:
    return ["--config-file", config,
            f"data_folder='{data_dir}'", f"output_dir='{out_dir}'",
            f"epochs_in_total={{'WarmUP': {steps}}}",
            f"check_every={TRAIN_CHECK}", "quick_eva_num_samples=8",
            "verbose=False"]


def _first_step_vs_plain(probe, batch, ts: str = "WarmUP") -> dict:
    """The first step (``train_step``: in a GAN state the discriminator's
    update, then the generator's) on the kernel route against the plain
    bf16 route (``set_train_mode(model, '')``), from the same parameters,
    optimizer and discriminator states, batch and stochastic-depth draws:
    the kernel route's factor columns take the generator's numbers in the
    order the plain route's DropPath layers take them. The generator's
    gradient is read from its fresh optimizer's first moment, (1 - b1) g.
    Loss and every reported term rtol TRAIN_LOSS_RTOL, gradients relative
    max < TRAIN_GRAD_TOL; leaves the probe on the plain route."""
    import copy

    from rdst_tpu_torch.models.routes import set_train_mode

    opt, adv = probe.opt, probe.loss.adversarial
    if opt.count:
        raise AssertionError("the probe's optimizer has stepped already")
    saved = copy.deepcopy({
        "model": probe.model.state_dict(), "opt": opt.state_dict(),
        "adv": adv.state_dict() if adv is not None else None,
        "gen": probe.generator.get_state()})

    def step():
        total, rep, ok = probe.train_step(batch, ts)
        grads = (opt.state["mu"] / (1.0 - opt.b1)).split(opt.numels)
        return (float(total), {k: float(v) for k, v in rep.items()},
                [g.clone() for g in grads], bool(ok))

    loss_k, rep_k, g_k, ok_k = step()
    probe.model.load_state_dict(saved["model"])
    opt.load_state_dict(saved["opt"])
    if adv is not None:
        adv.load_state_dict(saved["adv"])
    probe.generator.set_state(saved["gen"])
    set_train_mode(probe.model, "")
    loss_p, rep_p, g_p, ok_p = step()
    gmax = max(float(g.abs().max()) for g in g_p)
    rel = max(float((a - b).abs().max())
              / max(1e-5, float(b.abs().max()), 0.12 * gmax)
              for a, b in zip(g_k, g_p))
    log(f"first step: loss kernel route {loss_k:.6f} vs plain bf16 route "
        f"{loss_p:.6f} (rtol {TRAIN_LOSS_RTOL}); "
        + "".join(f"{k} {rep_k[k]:.6f} / {rep_p[k]:.6f}; " for k in rep_p)
        + f"gradients rel max {rel:.4f} (bar {TRAIN_GRAD_TOL})")
    if not (ok_k and ok_p) or rep_k.keys() != rep_p.keys() or any(
            abs(u - v) > TRAIN_LOSS_RTOL * abs(v)
            for u, v in [(loss_k, loss_p)]
            + [(rep_k[k], rep_p[k]) for k in rep_p]) or \
            rel >= TRAIN_GRAD_TOL:
        raise AssertionError("kernel route vs plain route on the first step")
    return {"first_loss_kernel": loss_k, "first_loss_plain": loss_p,
            "first_grad_rel_max": rel, "first_report_kernel": rep_k,
            "first_report_plain": rep_p}


def _serve_snapshot(config: str, trainer, **overrides) -> str:
    """The run's last snapshot served by ``LiveModel`` on the card (the
    config with ``overrides``): finite, of the x4 shape, on a validation
    LR slice; returns the snapshot's path."""
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.serving.export import LiveModel

    snap = os.path.join(trainer.dirs["models"], "WarmUP_model_g.msgpack")
    paras = ParametersLoader(config)
    paras.set("well_trained_single_scale_model_g", snap)
    for k, v in overrides.items():
        paras.set(k, v)
    live = LiveModel(paras, max_batch=1, device="cuda")
    lr = trainer.ds_valid.get_test_pair(0)[4.0]["in"]
    y = live.predict(lr, SCALE)
    if not np.isfinite(y).all() or y.shape[1:3] != (lr.shape[1] * 4,
                                                     lr.shape[2] * 4):
        raise AssertionError(f"served {y.shape}")
    log(f"the snapshot ({os.path.getsize(snap)} bytes) served by LiveModel "
        f"({live.manifest['dtype']}, routes {live.manifest['routes'][:1]}..., "
        f"int8 {live.manifest['pallas_quant']}): {lr.shape} -> {y.shape}")
    return snap


def _make_corpus(tmp: str) -> str:
    """The 20-phantom corpus the port's generator makes from seed 0."""
    from rdst_tpu_torch.data import synthetic

    data_dir = os.path.join(tmp, "OASIS", "example20")
    t0 = time.perf_counter()
    synthetic.make_oasis_example(
        data_dir, patient_ids=tuple(f"OAS1_{i:04d}_MR1" for i in range(1, 21)))
    log(f"generated the 20-phantom corpus in "
        f"{time.perf_counter() - t0:.3f} s")
    return data_dir


@phase("bf16 training step")
def train_phase(data_dir: str, tmp: str) -> dict:
    from rdst_tpu_torch.cli import build_trainer, train_main
    from rdst_tpu_torch.kernels import pair_train as pt

    out = {}

    # the first step's loss and gradients, kernel route vs plain route,
    # from the run's own initial parameters (same seed) and first batch
    probe = build_trainer(_train_argv(data_dir, os.path.join(tmp, "probe"),
                                      1))
    probe.setup()
    # the run below starts from these parameters (same seed, same init)
    init = {k: v.clone() for k, v in probe.model.state_dict().items()}
    batch = probe.ds_train.sample(np.random.default_rng(17))
    if probe.model.train_mode != "pair" or \
            probe.model.train_routes != {"pair": 24, "block": 0}:
        raise AssertionError(f"train route {probe.model.train_mode} "
                             f"{probe.model.train_routes}")
    out["train_routes"] = dict(probe.model.train_routes)
    log(f"train routes {probe.model.train_routes}")
    out.update(_first_step_vs_plain(probe, batch))
    del probe

    out_dir = os.path.join(tmp, "outputs")
    from rdst_tpu_torch.kernels import block_train as bt
    bt.launch_forward.launches = bt.launch_backward.launches = 0
    pt.launch_forward.launches = pt.launch_backward.launches = 0  # main path
    pt.launch_backward.reductions = 0
    t0 = time.perf_counter()
    trainer = train_main(_train_argv(data_dir, out_dir, TRAIN_STEPS))
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    fwd, bwd = pt.launch_forward.launches, pt.launch_backward.launches
    out.update(forward_launches=fwd, backward_launches=bwd,
               reduction_launches=pt.launch_backward.reductions)
    log(f"{TRAIN_STEPS} steps in {out['run_s']:.3f} s (evaluations "
        f"included): train-pair launches forward {fwd}, backward {bwd} "
        f"(+{pt.launch_backward.reductions} kernels beside the attention "
        "VJPs)")
    if fwd != 24 * TRAIN_STEPS or bwd != 24 * TRAIN_STEPS or \
            bt.launch_forward.launches or bt.launch_backward.launches:
        raise AssertionError(f"expected {24 * TRAIN_STEPS} forward and "
                             "backward launches (24 DSTL pairs a step) and "
                             "no single-block train launch")
    losses = trainer.training_loss_records.get("WarmUP", [])
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses}")
    costs = trainer.training_epoch_costs[1:]
    out["losses"] = losses
    out["host_steps_per_s"] = len(costs) / sum(costs)
    log(f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
        f"{out['host_steps_per_s']:.3f} steps/s of host time (the host "
        "queues steps without waiting for the card; steps 2..20, quick "
        "evaluations excluded)")
    final = trainer.model.state_dict()
    moved = sum(not torch.equal(init[k], final[k]) for k in init)
    trained = sum(p.numel() > 0 for p in trainer.params)
    out["tensors_moved"] = moved
    if moved != trained:
        raise AssertionError(f"{moved} of {trained} trained tensors moved")
    snap = os.path.join(trainer.dirs["models"], "WarmUP_model_g.msgpack")
    with open(os.path.splitext(snap)[0] + ".stats.json") as f:
        stats = json.load(f)
    log(f"snapshot {os.path.getsize(snap)} bytes, sidecar {stats}; "
        f"{moved} of {trained} trained tensors moved from the initial "
        "parameters")
    if "attn_logit_max" not in stats:
        raise AssertionError(f"sidecar {stats}")
    _serve_snapshot(TRAIN_CONFIG, trainer)
    # resume: the same command with 2 more steps goes on from step 20
    resumed = train_main(_train_argv(data_dir, out_dir, TRAIN_STEPS + 2))
    with open(resumed.log_file) as f:
        resumed_log = f.read()
    if resumed.step != TRAIN_STEPS + 2 or (
            f"Resumed from checkpoint: state_id=0 epoch={TRAIN_STEPS}"
            not in resumed_log):
        raise AssertionError(f"resume: step {resumed.step}")
    log(f"resumed from the step-{TRAIN_STEPS} checkpoint to step "
        f"{resumed.step}")
    out["resumed_step"] = resumed.step
    out["trainer"] = trainer
    return out


def _step_profile(trainer, ts: str = "WarmUP", seed: int = SEED + 6,
                  label: str = "training step",
                  wall_steps: int = WALL_STEPS, host: bool = True) -> dict:
    """Steps/s over WALL_STEPS warm steps of one batch on the wall clock;
    the device time of one profiled step by kernel group, and the
    device's idle share of the step's wall time; in a GAN state, the
    device time of the discriminator's update alone (the generator
    forward without gradient and ``d_step``, on the same batch) and its
    share of the step's."""
    from torch.autograd import DeviceType

    from rdst_tpu_torch.runners.trainer import pin_batch

    batch = pin_batch(trainer.ds_train.sample(np.random.default_rng(seed)))
    trainer.train_step(batch, ts)
    torch.cuda.synchronize()
    # steps/s on the wall clock: WALL_STEPS steps queued back to back, as
    # the training loop queues them, then one wait for the card
    t0 = time.perf_counter()
    for _ in range(wall_steps):
        trainer.train_step(batch, ts)
    torch.cuda.synchronize()
    steps_per_s = wall_steps / (time.perf_counter() - t0)
    log(f"{label}: {steps_per_s:.3f} steps/s over {wall_steps} warm steps "
        "(wall clock, one batch)")
    wall_us, events, device = _profiled(lambda: trainer.train_step(batch, ts),
                                        host)
    groups = {"train kernels forward": 0.0,
              "train kernels backward (13 kernels a block)": 0.0,
              "convolution": 0.0, "matmul (adapters, optimizer)": 0.0,
              "other (LayerNorms, casts, elementwise)": 0.0}
    top = []
    for e in device:
        t = float(e.self_device_time_total or 0.0)
        if t <= 0:
            continue
        name = e.key.lower()
        if ("pair_train_fwd" in name or "tokwg::" in name
                or "tokfwd::" in name):
            # the train pair's forward; the block-train forward's GEMMs and
            # LN1 rows (csrc/token_fwd.cuh)
            groups["train kernels forward"] += t
        elif "attn_fwd_kernel<false>" in name:
            # the block-train forward's attention and the backward's
            # recompute: one launch each a block, on the same shapes
            groups["train kernels forward"] += t / 2
            groups["train kernels backward (13 kernels a block)"] += t / 2
        elif "trainblk::" in name or "tokpar::" in name:
            # the backward's own kernels and those it shares with the
            # serving forward (csrc/token_gemm.cuh)
            groups["train kernels backward (13 kernels a block)"] += t
        elif any(w in name for w in CONV_KERNELS + ("wgrad", "dgrad")):
            groups["convolution"] += t
        elif any(w in name for w in ("gemm", "sm90", "cutlass")):
            groups["matmul (adapters, optimizer)"] += t
        else:
            groups["other (LayerNorms, casts, elementwise)"] += t
        top.append((t, e.count, e.key[:90]))
    busy = sum(groups.values())
    cpu = sorted(((float(e.self_cpu_time_total), e.count, e.key[:60])
                  for e in events
                  if e.device_type == DeviceType.CPU), reverse=True)
    # kernels the step launches (memory sets and copies apart)
    launches = sum(e.count for e in device
                   if "memset" not in e.key.lower()
                   and "memcpy" not in e.key.lower())
    out = {"steps_per_s": steps_per_s, "wall_us": wall_us,
           "device_us": busy, "groups_us": groups,
           "top": sorted(top, reverse=True)[:12], "host_top": cpu[:12],
           "host_ops": sum(n for _, n, _ in cpu),
           "kernel_launches": launches}
    if busy == 0:
        log("torch.profiler recorded no device time: breakdown not measured")
        return out
    out["idle_share"] = 1.0 - busy / wall_us
    log(f"{label} under the profiler: wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy / 1e3:.3f} ms, idle share {out['idle_share']:.3f}, "
        f"{launches} kernel launches")
    for name, t in groups.items():
        log(f"  {name}: {t / 1e3:.3f} ms ({100 * t / busy:.1f} % of device "
            "time)")
    for t, count, key in out["top"]:
        log(f"  {t / 1e3:9.3f} ms x{count:4d} {key}")
    if host:
        log(f"host: {out['host_ops']} profiled CPU ops; by self CPU time "
            "(the profiler's own overhead included):")
    for t, count, key in out["host_top"]:
        log(f"  {t / 1e3:9.3f} ms x{count:5d} {key}")
    adv = trainer.loss.adversarial
    if adv is not None and trainer.gan_active(ts):
        x = torch.as_tensor(batch["in"]).to(trainer.device)
        db = trainer.device_batch(batch)

        def d_update():
            with torch.no_grad():
                fake = trainer.model(x, trainer.batch_scale(batch)).float()
            adv.d_step(fake, db["out"], db["sr_scales"], trainer.generator)

        d_busy = _device_ms(d_update)[1] * 1e3
        out.update(d_update_us=d_busy, d_update_share=d_busy / busy)
        log(f"  D update (no-grad generator forward + d_step): "
            f"{d_busy / 1e3:.3f} ms = {d_busy / busy:.3f} of the step's "
            "device time")
    return out


train_profile_phase = phase("training profile")(_step_profile)


# ---------------------------------------------------------------------------
# The fine-tune recipes: the seg-UNet perceptual loss and the RaGAN
# discriminator, in f32 as shipped and in bf16 on the train-pair kernels
# ---------------------------------------------------------------------------

E1_RECIPE_CONFIG = "config_files/rdst_e1_oasis_x4.ini"
# the committed seg UNet (a full-width SegUNet(1, 4)), which the seg
# recipes name in place of their random UNet
UNET_CKPT = "weights/unet_tiny.pkl"
FT_STEPS, FT_CHECK, FT_BF16_STEPS = 6, 3, 6
# FID of the same images on the card against the CPU: f32 features on both
# sides (TF32 off), the Frechet distance in float64 on the host
FID_RTOL = 1e-3


def _card_line() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {line}")
    return line


def _ft_argv(config: str, data_dir: str, out_dir: str, epochs: dict,
             check: int = FT_CHECK, seg: bool = False, **over) -> list:
    """A shipped config with only the paths, the steps and the check
    interval overridden (and ``over``); a recipe with the UNet-F term
    names the committed seg UNet (``--seg-loss`` adds the segmentation
    labels)."""
    argv = ["--config-file", config] + (["--seg-loss"] if seg else [])
    argv += [f"data_folder='{data_dir}'", f"output_dir='{out_dir}'",
             f"epochs_in_total={epochs!r}", f"check_every={check}",
             "verbose=False"]
    if config in (HRL_CONFIG, E1_RECIPE_CONFIG):
        over = {"unet_native_ckpt": UNET_CKPT, **over}
    return argv + [f"{k}={v!r}" for k, v in over.items()]


def _committed_unet(trainer) -> None:
    """The UNet-F term scores with the committed seg UNet's weights."""
    import pickle

    with open(UNET_CKPT, "rb") as f:
        want = pickle.load(f)["params"]["encoder"]["conv1"]["kernel"]
    got = trainer.loss.terms["UNet-F"].model.encoder.conv1.weight
    if not np.array_equal(got.detach().cpu().numpy(),
                          np.transpose(want, (3, 2, 0, 1))):
        raise AssertionError(f"the UNet-F term does not use {UNET_CKPT}")


def _f32_forwards(label: str) -> int:
    """The f32 block kernel's launches since the last reset, as whole
    E1 forwards (48 blocks each)."""
    from rdst_tpu_torch.kernels import swin_block

    n = swin_block.fused_swin_block.launches
    if n <= 0 or n % 48:
        raise AssertionError(f"{label}: {n} f32 block launches, not a "
                             "positive multiple of 48")
    return n // 48


def _ft_records(trainer, ts: str, names) -> dict:
    rec = trainer.loss.records.get(ts, {})
    for n in names:
        v = rec.get(n) or []
        if not v or not np.isfinite(v).all():
            raise AssertionError(f"{ts} record {n}: {v}")
    return {n: list(rec[n]) for n in names}


def _snapshots(trainer, names) -> dict:
    out = {}
    for n in names:
        path = os.path.join(trainer.dirs["models"], n)
        if not os.path.isfile(path):
            raise AssertionError(f"missing snapshot {path}")
        out[n] = os.path.getsize(path)
    log(f"snapshots {out} (bytes)")
    return out


def _fid_card_vs_cpu(trainer) -> dict:
    """FID of the final evaluation's images (every validation slice, the
    largest scale) on the card and on the CPU, timed."""
    from rdst_tpu_torch.metrics.fid import FID

    recs, pairs = trainer._infer_pairs(
        list(range(trainer.ds_valid.test_len())))
    s = sorted(pairs[0])[-1]
    gts = [p[s]["gt"] for p in pairs]
    preds = [r[s] for r in recs]
    out = {}
    for name, gpu in (("card", 0), ("cpu", -1)):
        fid = FID(gpu_id=gpu)
        fid(gts[:2], preds[:2])  # the extractor built and warm
        if gpu >= 0:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fid(gts, preds)
        if gpu >= 0:
            torch.cuda.synchronize()
        out[f"{name}_s"] = time.perf_counter() - t0
    rel = abs(out["card"] - out["cpu"]) / max(abs(out["cpu"]), 1e-12)
    out.update(images=len(gts), rel=rel)
    log(f"FID of {len(gts)} validation slices (VGG substitute features): "
        f"card {out['card']:.6f} in {out['card_s']:.3f} s, CPU "
        f"{out['cpu']:.6f} in {out['cpu_s']:.3f} s, relative difference "
        f"{rel:.2e} (bar {FID_RTOL})")
    if not np.isfinite(out["card"]) or rel > FID_RTOL:
        raise AssertionError("FID on the card vs on the CPU")
    return out


@phase("seg fine-tune")
def seg_finetune_phase(data_dir: str, tmp: str) -> dict:
    """``config_files/rdst_hrl_seg_ft_oasis20_x4.ini`` with ``--seg-loss``
    (warm start from the 40k E1 weights, L1 + UNet-F, f32 as shipped) for
    FT_STEPS steps with a quick evaluation every FT_CHECK; then the repo's
    example recipe ``config_files/rdst_e1_oasis_x4.ini`` (WarmUP -> UNet-F
    from scratch) for 3 steps a state on the same corpus (its patients 1-4
    are the corpus's first four)."""
    from rdst_tpu_torch.cli import train_main
    from rdst_tpu_torch.kernels import swin_block

    out = {"card": _card_line()}
    swin_block.fused_swin_block.launches = 0
    t0 = time.perf_counter()
    trainer = train_main(_ft_argv(HRL_CONFIG, data_dir,
                                  os.path.join(tmp, "seg_ft"),
                                  {"UNet-F": FT_STEPS}, seg=True))
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    out["f32_forwards"] = _f32_forwards("seg fine-tune")
    _committed_unet(trainer)
    rec = _ft_records(trainer, "UNet-F", ("L1", "UNet-F"))
    if len(rec["UNet-F"]) != FT_STEPS or min(rec["UNet-F"]) <= 0:
        raise AssertionError(f"UNet-F records {rec['UNet-F']}")
    unet = trainer.loss.terms["UNet-F"]
    log(f"{FT_STEPS} steps in {out['run_s']:.3f} s (evaluations included): "
        f"UNet-F {rec['UNet-F'][0]:.6f} -> {rec['UNet-F'][-1]:.6f}, L1 "
        f"{rec['L1'][0]:.6f} -> {rec['L1'][-1]:.6f}; mode {unet.loss_mode} "
        f"{unet.loss_layers}; {out['f32_forwards']} f32 forwards "
        f"({48 * out['f32_forwards']} f32 block launches: the quick and "
        "final evaluations)")
    out["records"] = rec
    out["snapshots"] = _snapshots(trainer, ["UNet-F_model_g.msgpack"])
    out["profile"] = _step_profile(trainer, "UNet-F", SEED + 7,
                                   "E1 seg step (f32)")
    del trainer

    t0 = time.perf_counter()
    recipe = train_main(_ft_argv(E1_RECIPE_CONFIG, data_dir,
                                 os.path.join(tmp, "e1_recipe"),
                                 {"WarmUP": 3, "UNet-F": 3}, check=3))
    torch.cuda.synchronize()
    _committed_unet(recipe)
    warm = _ft_records(recipe, "WarmUP", ("L1",))
    seg = _ft_records(recipe, "UNet-F", ("L1", "UNet-F"))
    if "UNet-F" in recipe.loss.records["WarmUP"] or \
            len(warm["L1"]) != 3 or len(seg["UNet-F"]) != 3:
        raise AssertionError(f"recipe records {recipe.loss.records}")
    out["recipe"] = {"s": time.perf_counter() - t0, "WarmUP": warm,
                     "UNet-F": seg, "snapshots": _snapshots(
                         recipe, ["WarmUP_model_g.msgpack",
                                  "UNet-F_model_g.msgpack"])}
    log(f"{E1_RECIPE_CONFIG}: WarmUP L1 {warm['L1']}, then UNet-F L1 "
        f"{seg['L1']} UNet-F {seg['UNet-F']} in {out['recipe']['s']:.3f} s")
    return out


@phase("GAN fine-tune")
def gan_finetune_phase(data_dir: str, tmp: str) -> dict:
    """``config_files/rdst_gan_ft_oasis20_x4.ini`` (RaGAN, warm start from
    the 40k E1 weights, f32 as shipped, ``eva_metrics`` with FID) for
    FT_STEPS steps with a quick evaluation every FT_CHECK; the resume for 2
    more steps; the final evaluation's FID on the card against the CPU."""
    from rdst_tpu_torch.cli import train_main
    from rdst_tpu_torch.kernels import swin_block

    out = {"card": _card_line()}
    out_dir = os.path.join(tmp, "gan_ft")

    def argv(steps):
        return _ft_argv(GAN_CONFIG, data_dir, out_dir, {"GAN-FT": steps})

    swin_block.fused_swin_block.launches = 0
    t0 = time.perf_counter()
    trainer = train_main(argv(FT_STEPS))
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    out["f32_forwards"] = _f32_forwards("GAN fine-tune")
    rec = _ft_records(trainer, "GAN-FT",
                      ("L1", "GAN", "Adv_D", "Adv_D Real", "Adv_D Fake"))
    if len(rec["Adv_D"]) != FT_STEPS or len(set(rec["Adv_D"])) < 2:
        raise AssertionError(f"the discriminator's loss {rec['Adv_D']}")
    adv = trainer.loss.adversarial
    log(f"{FT_STEPS} steps in {out['run_s']:.3f} s (evaluations included): "
        f"L1 {rec['L1'][0]:.6f} -> {rec['L1'][-1]:.6f}, GAN "
        f"{rec['GAN'][0]:.6f} -> {rec['GAN'][-1]:.6f}, Adv_D "
        f"{rec['Adv_D'][0]:.6f} -> {rec['Adv_D'][-1]:.6f} (real "
        f"{rec['Adv_D Real'][-1]:.6f}, fake {rec['Adv_D Fake'][-1]:.6f}); "
        f"D {type(adv.discriminator).__name__} "
        f"{sum(p.numel() for p in adv.params)} parameters, {adv.opt.count} "
        f"updates; {out['f32_forwards']} f32 forwards")
    out["records"] = rec
    out["snapshots"] = _snapshots(trainer, ["GAN-FT_model_g.msgpack",
                                            "GAN-FT_loss_d.msgpack"])
    del trainer
    resumed = train_main(argv(FT_STEPS + 2))
    with open(resumed.log_file) as f:
        if f"Resumed from checkpoint: state_id=0 epoch={FT_STEPS}" \
                not in f.read() or resumed.step != FT_STEPS + 2:
            raise AssertionError(f"resume: step {resumed.step}")
    log(f"resumed from the step-{FT_STEPS} checkpoint to step "
        f"{resumed.step} (D updates {resumed.loss.adversarial.opt.count})")
    out["fid"] = _fid_card_vs_cpu(resumed)
    out["profile"] = _step_profile(resumed, "GAN-FT", SEED + 7,
                                   "E1 GAN step (f32)")
    return out


@phase("fine-tune bf16")
def finetune_bf16_phase(data_dir: str, tmp: str) -> dict:
    """Both recipes with ``training_dtype='bfloat16'`` for FT_BF16_STEPS
    steps: every DSTL pair on the train-pair kernels (24 pairs), 24
    backward calls a step and 24 forward calls a generator forward (the
    seg step runs one, the GAN step two: the discriminator's fakes without
    gradient, then the step); the first step's losses against the plain
    bf16 route."""
    from rdst_tpu_torch.cli import build_trainer, train_main
    from rdst_tpu_torch.kernels import block_train as bt
    from rdst_tpu_torch.kernels import pair_train as pt

    out = {"card": _card_line()}
    for label, config, ts, seg, forwards in (
            ("seg", HRL_CONFIG, "UNet-F", True, 1),
            ("GAN", GAN_CONFIG, "GAN-FT", False, 2)):
        def argv(sub, steps):
            return _ft_argv(config, data_dir,
                            os.path.join(tmp, f"{label}_bf16_{sub}"),
                            {ts: steps}, check=FT_BF16_STEPS, seg=seg,
                            training_dtype="bfloat16")

        probe = build_trainer(argv("probe", 1))
        probe.setup()
        if seg:
            _committed_unet(probe)
        routes = dict(probe.model.train_routes)
        if probe.model.train_mode != "pair" or routes != {"pair": 24,
                                                          "block": 0}:
            raise AssertionError(f"{label}: train routes {routes}")
        batch = probe.ds_train.sample(np.random.default_rng(SEED + 8))
        res = {"train_routes": routes,
               "first_step": _first_step_vs_plain(probe, batch, ts)}
        del probe
        bt.launch_forward.launches = bt.launch_backward.launches = 0
        pt.launch_forward.launches = pt.launch_backward.launches = 0
        t0 = time.perf_counter()
        trainer = train_main(argv("run", FT_BF16_STEPS))
        torch.cuda.synchronize()
        res["run_s"] = time.perf_counter() - t0
        fwd, bwd = pt.launch_forward.launches, pt.launch_backward.launches
        res.update(forward_launches=fwd, backward_launches=bwd)
        log(f"{label} bf16: {FT_BF16_STEPS} steps in {res['run_s']:.3f} s "
            f"(evaluations included): train-pair launches forward {fwd}, "
            f"backward {bwd}")
        if fwd != 24 * forwards * FT_BF16_STEPS or \
                bwd != 24 * FT_BF16_STEPS or bt.launch_forward.launches or \
                bt.launch_backward.launches:
            raise AssertionError(
                f"{label}: expected {24 * forwards} forward and 24 backward "
                "train-pair launches a step and no single-block train launch")
        names = ("L1", "UNet-F") if seg else ("L1", "GAN", "Adv_D")
        res["records"] = _ft_records(trainer, ts, names)
        res["profile"] = _step_profile(trainer, ts, SEED + 7,
                                       f"E1 {label} step (bf16)")
        out[label] = res
        del trainer
    return out


# ---------------------------------------------------------------------------
# SwinIR-std x4 (C = 180): the widened fast block with int8 qkv, the
# single-block train kernels, serving and training
# ---------------------------------------------------------------------------

SWINIR_CONFIG = "config_files/swinir_std_40k_oasis20_x4.ini"
SWINIR_WEIGHTS = "weights/swinir_std_40k_best_oasis20_x4.msgpack"
SWINIR_TRAIN_CONFIG = "config_files/swinir_std_100k_oasis20_x4.ini"
INT8_OPS = 1979e12  # dense int8 tensor-core peak (H100 SXM data sheet)


def _int8_qkv_bound(tokens: int, c: int, nbytes: float, n: int = 64):
    """Bound of a fast-block launch with int8 qkv: the qkv product (6C^2
    ops per token) at the int8 peak, the rest (10C^2 + 4NC) at the bf16
    peak."""
    t_ops = tokens * (6 * c * c / INT8_OPS + (10 * c * c + 4 * n * c)
                      / BF16_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


@phase("SwinIR-std bf16 kernels vs plain")
def swinir_kernel_phase(model) -> dict:
    """The fast block at C = 180 with int8 qkv, the launch alone (weights
    prepared once, as the model keeps them) against its plain version at
    bucket 64 (1280 windows), with the committed SwinIR-std weights: the
    path's unshifted block (shared bias), and a shifted case (the second
    block's weights at shift 4, per-window bias), under 'clamp' (the
    checkpoint's resolved variant) and 'stable_bc'."""
    from rdst_tpu_torch.kernels import swin_block

    ws, nw, images, nh, c = 8, 20, 64, 6, 180
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    quant = frozenset({"qkv"})
    tok_kernels = swin_block.kernels_per_call(
        "swin_block_fast.cu", "swin_block_fast_tokens_kernels")
    rows = []
    for k, shift in enumerate((0, ws // 2)):
        blk = model.layers[0].residual_group.blocks[k]
        inputs = blk.fast_kernel_inputs(LR_HW, ws, shift)
        plan = swin_block.plan_fast_block(*inputs, num_heads=nh, quant=quant)
        if plan.route != "tokens":
            raise AssertionError(f"C={c} planned for {plan.route}")
        x = torch.randn(images * nw, ws * ws, c, device="cuda",
                        generator=gen).to(torch.bfloat16)
        for softmax in ("clamp", "stable_bc"):
            kw = dict(num_heads=nh, windows_per_image=nw, softmax=softmax)
            with torch.inference_mode():
                got = swin_block.run_fast_block(x, plan, **kw)
                want = swin_block.swin_block_fast_reference(
                    x, plan.params, plan.bias, num_heads=nh,
                    softmax=softmax, qkv=plan.qkv)
                torch.cuda.synchronize()
                err = _check(f"fast block C={c} shift={shift} int8 qkv "
                             f"{softmax}", got, want)

                def call():
                    return swin_block.run_fast_block(x, plan, **kw)

                ms = cuda_time_ms(call)
                plain_ms = cuda_time_ms(
                    lambda: swin_block.swin_block_fast_reference(
                        x, plan.params, plan.bias, num_heads=nh,
                        softmax=softmax, qkv=plan.qkv), warmup=1, iters=5)
                flops = _block_flops(images * nw, c)
                extras = _forward_extras(
                    f"fast block C={c} shift={shift} {softmax} (tokens)",
                    call, tok_kernels, FAST_PHASES, flops)
            nbytes = 2 * 2 * x.numel() + _plan_bytes(plan) + sum(
                t.numel() * t.element_size() for t in plan.qkv_layout)
            bound_ms, by = _int8_qkv_bound(x.shape[0] * 64, c, nbytes)
            rows.append(dict(c=c, shift=shift, softmax=softmax,
                             rel_max=err[0], rel_mean=err[1],
                             max_abs_err=err[2], ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=by, **extras))
            log(f"fast block C={c} shift={shift} int8 qkv {softmax:9s}: rel "
                f"max {err[0]:.3e} mean {err[1]:.3e} (bar {BF16_TOL}) kernel "
                f"(tokens) {ms:.4f} ms; plain {plain_ms:.4f} ms bound "
                f"{bound_ms:.4f} ms ({by}; {flops / ms / 1e9:.1f} TFLOP/s of "
                "block work)")
    log("library yardstick: no single PyTorch call computes a Swin block")
    return {"variants": rows}


@phase("SwinIR-std bf16 whole model")
def swinir_model_phase(live16, live32, live_cpu) -> dict:
    """36 fast-block launches per forward (every RSTB block, none shifted);
    the card against the same model on the CPU, where the wrapper takes
    its plain version (bf16 + int8, bar BF16_TOL); and against the plain
    f32 path (``pallas_kernels='off'``): relative error and PSNR."""
    from rdst_tpu_torch.kernels import swin_block

    rng = np.random.default_rng(SEED + 8)
    x = rng.random((8,) + LR_HW + (1,), dtype=np.float32)
    y_cpu = live_cpu.predict(x, SCALE)
    y32 = live32.predict(x, SCALE)
    swin_block.run_fast_block.launches = 0  # the path starts here
    y = live16.predict(x, SCALE)
    launches = swin_block.run_fast_block.launches  # and ends here
    if launches != 36:
        raise AssertionError(f"{launches} fast-block launches per forward, "
                             "expected 36 (6 RSTBs x 6 blocks)")
    if not np.isfinite(y).all() or y.shape != (8, 160, 128, 1):
        raise AssertionError(f"output {y.shape}")

    def versus(a, ref):
        r = _rel(torch.from_numpy(a), torch.from_numpy(ref))
        return r[0], r[1], float(10 * np.log10(1.0 / np.mean((a - ref) ** 2)))

    kp, kf = versus(y, y_cpu), versus(y, y32)
    log(f"SwinIR-std bf16 + int8 qkv: {launches} launches of run_fast_block "
        f"per forward; vs its plain versions (the CPU run) rel max "
        f"{kp[0]:.3e} (bar {BF16_TOL}); vs the plain f32 path rel max "
        f"{kf[0]:.3e} mean {kf[1]:.3e}, PSNR {kf[2]:.2f} dB")
    if kp[0] > BF16_TOL:
        raise AssertionError(f"vs plain versions: {kp}")
    if kf[0] >= BF16_VS_F32_MAX or kf[1] >= BF16_VS_F32_MEAN:
        raise AssertionError(f"vs f32: {kf}")
    return {"launches_per_forward": launches,
            "vs_plain_versions_rel_max": kp[0], "vs_f32_rel_max": kf[0],
            "vs_f32_rel_mean": kf[1], "psnr_vs_f32_db": kf[2]}


swinir_serving_phase = phase("SwinIR-std bf16 serving")(_serve)
swinir_profile_phase = phase("SwinIR-std bf16 profile")(_profile)


def _block_train_case(blk, c: int, shift: int, gen):
    """A block at the training geometry (32 images of 24x24, 288
    windows): its raw 12 parameters and head-major bias (shift 4: rel-pos
    + mask per window), bf16 tokens, cotangents and factor columns."""
    params, bias = blk.fast_kernel_inputs((24, 24), 8, shift)
    ops = [p.detach().float().contiguous() for p in params] + \
        [bias.detach().float().contiguous()]
    x = torch.randn(288, 64, c, device="cuda",
                    generator=gen).to(torch.bfloat16)
    dz = torch.randn(288, 64, c, device="cuda",
                     generator=gen).to(torch.bfloat16)
    keep = 0.9
    cols = (torch.rand(32, 2, device="cuda", generator=gen) < keep)
    dpf = (cols.float() / keep).repeat_interleave(9 * 64, 0).contiguous()
    return ops, x, dz, dpf


def _block_train_grads(kernel: bool, ops, x, dz, dpf, softmax, nh=6, nw=9):
    """Output and gradients (x, the 12 raw parameters, the head-major
    bias) of the block through the fold, on the kernels or the plain
    version (``nw`` windows an image)."""
    from rdst_tpu_torch.kernels import block_train as bt
    from rdst_tpu_torch.kernels.swin_block import fast_params, pack_bias_fast

    c = x.shape[-1]
    leaves = [t.detach().clone().requires_grad_(True) for t in [x] + ops]
    p, bias = leaves[1:13], leaves[13]
    fp, pb = fast_params(p, c, nh), pack_bias_fast(bias.to(torch.bfloat16),
                                                   nh, 64)
    if kernel:
        out = bt.run_block_train(leaves[0], fp, pb, dpf, num_heads=nh,
                                 windows_per_image=nw, softmax=softmax)
    else:
        out = bt.block_train_reference(leaves[0], fp, pb, dpf, num_heads=nh,
                                       softmax=softmax)
    out.backward(dz)
    return out.detach(), [t.grad for t in leaves]


BLOCK_TRAIN_NAMES = ["x", "wqkv", "bqkv", "wproj", "bproj", "g1", "b1", "g2",
                     "b2", "w1", "bf1", "w2", "bf2", "bias"]


def _block_train_variant(label: str, ops, x, dz, dpf, softmax: str,
                         nh: int = 6, nw: int = 9) -> dict:
    """The kernels' output and every gradient against the plain version
    and its autograd, bar BF16_TOL."""
    got, g_got = _block_train_grads(True, ops, x, dz, dpf, softmax, nh, nw)
    want, g_want = _block_train_grads(False, ops, x, dz, dpf, softmax, nh,
                                      nw)
    torch.cuda.synchronize()
    errs = {"out": _rel(got, want)}
    for nm, a, b in zip(BLOCK_TRAIN_NAMES, g_got, g_want):
        if float(b.abs().max()) > 0:
            errs[nm] = _rel(a, b)
        elif float(a.abs().max()) > 0:
            errs[nm] = (float("inf"), float("inf"), float(a.abs().max()))
    worst = max(errs, key=lambda e: errs[e][0])
    finite = all(bool(torch.isfinite(g).all()) for g in g_got) \
        and bool(torch.isfinite(got.float()).all())
    log(f"{label}: out rel max {errs['out'][0]:.3e}, dx "
        f"{errs['x'][0]:.3e}, worst {worst} {errs[worst][0]:.3e} (bar "
        f"{BF16_TOL})")
    if not finite or errs[worst][0] > BF16_TOL:
        raise AssertionError(f"{label}: {errs}")
    return dict(rel_max={e: v[0] for e, v in errs.items()},
                out_abs_err=errs["out"][2],
                grad_abs_err=max(v[2] for e, v in errs.items()
                                 if e != "out"))


def _block_train_forward_times(x, ops, softmax: str, nh: int = 6) -> dict:
    """The forward launch alone (weights laid out once): its time, the
    plain time and the bound."""
    from rdst_tpu_torch.kernels import block_train as bt
    from rdst_tpu_torch.kernels.swin_block import (fast_params,
                                                   pack_bias_fast,
                                                   softmax_code)

    c = x.shape[-1]
    with torch.no_grad():
        fp = fast_params(ops[:12], c, nh)
        pb = pack_bias_fast(ops[12].to(torch.bfloat16), nh, 64)
        layout = bt.forward_layout(fp, nh)
    code = softmax_code(softmax)
    hidden = fp.w1.shape[1]
    out = {"ms": cuda_time_ms(lambda: bt.launch_forward(
        x, layout, pb, None, nh, hidden, code), iters=10)}
    with torch.no_grad():
        out["plain_ms"] = cuda_time_ms(lambda: bt.block_train_reference(
            x, fp, pb, None, num_heads=nh, softmax=softmax))
    wbytes = sum(t.numel() * t.element_size() for t in [*fp, pb])
    out["bound_ms"], out["bound_by"] = _bound(
        _block_flops(x.shape[0], c), 2 * x.numel() * 2 + wbytes)
    return out, fp, pb, layout, code


def _tile_rows_times(gen) -> dict:
    """The block-train forward's GEMMs alone at its geometry (18,432
    tokens, C = 180) in tiles of 64 and of 128 rows: the data for the
    schedule's rule (``token_tile_rows``)."""
    from rdst_tpu_torch.kernels.swin_block import token_tile_rows

    t, c, nh, hidden = 288 * 64, 180, 6, 360
    o = _gemm_operands(gen, t, c, nh, hidden, GEMM_GROWTH)
    out = {}
    for bm in (64, 128):
        launches = _gemm_launches(o, c, hidden, bm)
        out[bm] = {k: cuda_time_ms(launches[k], iters=20)
                   for k in ("qkv bf16", "proj + LN2", "fc1 + fc2")}
    log(f"  tile rows at {t} tokens, C = {c} (ms; the schedule takes "
        f"{token_tile_rows(t)}):")
    for k in out[64]:
        log(f"    {k:11s} 64 rows {out[64][k]:.4f}, 128 rows "
            f"{out[128][k]:.4f}")
    return {str(bm): v for bm, v in out.items()}


@phase("block-train kernels vs plain")
def block_train_kernel_phase(model) -> dict:
    """``fused_swin_block_train``'s forward (the token-parallel forward,
    exact division, factor columns) and backward kernels against the plain
    version and its autograd gradient at 288 windows, C = 180, with the
    committed SwinIR-std weights: the path's unshifted block and a
    shifted case, with and without factor columns, 'clamp' and 'stable';
    the output and every gradient (x, the 12 parameters through the fold,
    the bias), bar BF16_TOL. The forward launch alone: two launches
    bitwise equal, kernels a call, device time by phase; its GEMMs in
    tiles of 64 and 128 rows; the ptxas report of its GEMM kernels. Then
    RDST-W96's block-train widths, C = 144 and 192, with its committed
    weights, as the training step's routes would send them."""
    from rdst_tpu_torch.kernels import block_train as bt
    from rdst_tpu_torch.kernels.swin_block import kernels_per_call

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    rows = []
    fwd_kernels = kernels_per_call("block_train.cu",
                                   "block_train_fwd_kernels")
    for k, shift in enumerate((0, 4)):
        blk = model.layers[0].residual_group.blocks[k]
        ops, x, dz, dpf0 = _block_train_case(blk, 180, shift, gen)
        for softmax in ("clamp", "stable"):
            for use_dpf in (False, True):
                dpf = dpf0 if use_dpf else None
                row = _block_train_variant(
                    f"block train C=180 shift={shift} {softmax:6s} "
                    f"dpf={use_dpf!s:5s}", ops, x, dz, dpf, softmax)
                rows.append(dict(shift=shift, softmax=softmax, dpf=use_dpf,
                                 **row))
        if shift == 0:  # the path's case: times of the launches alone
            softmax = "clamp"
            times, fp, pb, layout, code = _block_train_forward_times(
                x, ops, softmax)
            row = rows[-4]
            row.update(times)
            row["forward"] = _forward_extras(
                "block train forward C=180",
                lambda: bt.launch_forward(x, layout, pb, dpf0, 6, 360, code),
                fwd_kernels, FAST_PHASES, _block_flops(288, 180))
            row["bwd_ms"] = cuda_time_ms(lambda: bt.launch_backward(
                x, dz, fp, pb, None, 6, code), warmup=1, iters=5)
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in [x, *fp, pb]]
            twin = bt.block_train_reference(
                leaves[0], type(fp)(*leaves[1:9]), leaves[9], None,
                num_heads=6, softmax=softmax)
            row["plain_bwd_ms"] = cuda_time_ms(
                lambda: torch.autograd.grad(twin, leaves, dz,
                                            retain_graph=True),
                warmup=1, iters=5)
            del twin, leaves
            row.update(_backward_extras(
                "C=180", lambda: bt.launch_backward(x, dz, fp, pb, None, 6,
                                                    code),
                bt.launch_backward, 1,
                lambda: bt.block_bwd_reference(x, dz, fp, pb, None,
                                               num_heads=6,
                                               softmax=softmax)))
            flops = _block_flops(288, 180)
            wbytes = sum(t.numel() * t.element_size() for t in [*fp, pb])
            tok = x.numel() * 2
            # backward: x, dz in, dx out, the weights in, f32 grads out
            row["bwd_bound_ms"], row["bwd_bound_by"] = _bound(
                2 * flops, 3 * tok + wbytes + 2 * wbytes)
            log(f"  C=180: forward {row['ms']:.4f} ms (plain "
                f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} "
                f"{row['bound_by']}), backward {row['bwd_ms']:.4f} ms "
                f"(plain {row['plain_bwd_ms']:.4f}, bound "
                f"{row['bwd_bound_ms']:.4f} {row['bwd_bound_by']})")
    tiles = _tile_rows_times(gen)
    ptxas = _ptxas_check("block_train.cu", "tokwg")
    w96 = []
    w96_model = _build_f32(W96_CONFIG, W96_WEIGHTS)
    rdstb = w96_model.body[0]
    for j, c in ((1, 144), (2, 192)):
        for k, shift in enumerate((0, 4)):
            blk = rdstb.body[j].body.blocks[k]
            ops, x, dz, dpf0 = _block_train_case(blk, c, shift, gen)
            for use_dpf in (False, True):
                row = _block_train_variant(
                    f"block train W96 C={c} shift={shift} clamp  "
                    f"dpf={use_dpf!s:5s}", ops, x, dz,
                    dpf0 if use_dpf else None, "clamp")
                w96.append(dict(c=c, shift=shift, softmax="clamp",
                                dpf=use_dpf, **row))
            if shift == 0:
                times = _block_train_forward_times(x, ops, "clamp")[0]
                w96[-2].update(times)
                log(f"  W96 C={c}: forward {times['ms']:.4f} ms (plain "
                    f"{times['plain_ms']:.4f}, bound {times['bound_ms']:.4f}"
                    f" {times['bound_by']})")
    del w96_model
    log("library yardstick: no single PyTorch call computes a Swin block or "
        "its gradient")
    return {"variants": rows, "tile_rows": tiles, "ptxas": ptxas,
            "w96": w96}


def _swinir_train_argv(data_dir: str, out_dir: str, steps: int) -> list:
    return ["--config-file", SWINIR_TRAIN_CONFIG,
            f"data_folder='{data_dir}'", f"output_dir='{out_dir}'",
            f"epochs_in_total={{'WarmUP': {steps}}}",
            f"check_every={TRAIN_CHECK}", "quick_eva_num_samples=8",
            "verbose=False"]


@phase("SwinIR-std bf16 training")
def swinir_train_phase(data_dir: str, tmp: str) -> dict:
    """``python -m rdst_tpu_torch.train`` (in process) on
    ``config_files/swinir_std_100k_oasis20_x4.ini`` for TRAIN_STEPS steps
    with a quick evaluation every TRAIN_CHECK: every block on the
    single-block train kernel (36 forward and 36 backward wrapper calls a
    step, none of the train pair), a finite loss that falls, the quick
    evaluations on the serving kernel, the snapshot served by
    ``LiveModel``; the first step on the kernel route against the plain
    bf16 route."""
    from rdst_tpu_torch.cli import build_trainer, train_main
    from rdst_tpu_torch.kernels import block_train as bt
    from rdst_tpu_torch.kernels import pair_train as pt
    from rdst_tpu_torch.kernels import swin_block

    out = {}
    probe = build_trainer(_swinir_train_argv(
        data_dir, os.path.join(tmp, "swinir_probe"), 1))
    probe.setup()
    routes = dict(probe.model.train_routes)
    out["train_routes"] = routes
    log(f"train routes {routes}, eval routes {probe.model.routes}, int8 "
        f"{sorted(probe.model.quant)}, softmax {probe.model.softmax}")
    if routes != {"pair": 0, "block": 36}:
        raise AssertionError(f"train routes {routes}")
    if probe.model.routes != ["fused_swin_block"] * 6 or \
            probe.model.quant != frozenset({"qkv"}):
        raise AssertionError(f"eval routes {probe.model.routes}")
    batch = probe.ds_train.sample(np.random.default_rng(17))
    out.update(_first_step_vs_plain(probe, batch))
    del probe

    out_dir = os.path.join(tmp, "swinir_outputs")
    counters = (bt.launch_forward, bt.launch_backward, pt.launch_forward,
                pt.launch_backward, swin_block.run_fast_block)
    for cnt in counters:
        cnt.launches = 0  # the main path starts here
    bt.launch_backward.reductions = 0
    t0 = time.perf_counter()
    trainer = train_main(_swinir_train_argv(data_dir, out_dir, TRAIN_STEPS))
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    fwd, bwd, pfwd, pbwd, evals = (cnt.launches for cnt in counters)
    out.update(forward_launches=fwd, backward_launches=bwd,
               reduction_launches=bt.launch_backward.reductions,
               pair_launches=pfwd + pbwd, eval_launches=evals)
    log(f"{TRAIN_STEPS} steps in {out['run_s']:.3f} s (evaluations "
        f"included): block-train wrapper calls forward {fwd}, backward "
        f"{bwd} (+{bt.launch_backward.reductions} kernels beside the "
        "attention VJPs), "
        f"train-pair {pfwd + pbwd}, fast-block launches in the quick "
        f"evaluations {evals}")
    if fwd != 36 * TRAIN_STEPS or bwd != 36 * TRAIN_STEPS or pfwd + pbwd:
        raise AssertionError(f"expected {36 * TRAIN_STEPS} block-train "
                             "forward and backward calls and no train pair")
    if evals == 0 or evals % 36:
        raise AssertionError(f"quick evaluations: {evals} fast launches")
    losses = trainer.training_loss_records.get("WarmUP", [])
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses}")
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    out["losses"] = losses
    log(f"loss {losses[0]:.5f} -> {losses[-1]:.5f} (first 3 mean "
        f"{first:.5f}, last 3 mean {last:.5f})")
    if not last < first:
        raise AssertionError("the loss did not fall")
    _serve_snapshot(SWINIR_TRAIN_CONFIG, trainer)
    out["trainer"] = trainer
    return out



W96_TRAIN_CONFIG = "config_files/rdst_w96_100k_oasis20_x4.ini"


@phase("W96 bf16 training step")
def w96_train_phase(data_dir: str, tmp: str) -> dict:
    """``python -m rdst_tpu_torch.train`` (in process) on
    ``config_files/rdst_w96_100k_oasis20_x4.ini`` in bf16 for TRAIN_STEPS
    steps with a quick evaluation every TRAIN_CHECK: the C = 96 DSTLs on
    the train pair (8 forward and 8 backward calls a step), the C = 144 /
    192 ones block by block (32 + 32 block-train calls), a finite loss that
    falls, the snapshot served by ``LiveModel``; the first step on the
    kernel route against the plain bf16 route."""
    from rdst_tpu_torch.cli import build_trainer, train_main
    from rdst_tpu_torch.kernels import block_train as bt
    from rdst_tpu_torch.kernels import pair_train as pt

    def argv(out_dir, steps):
        return _train_argv(data_dir, out_dir, steps, W96_TRAIN_CONFIG) + [
            "training_dtype='bfloat16'"]

    out = {}
    probe = build_trainer(argv(os.path.join(tmp, "w96_probe"), 1))
    probe.setup()
    routes = dict(probe.model.train_routes)
    out["train_routes"] = routes
    log(f"train routes {routes}, eval routes {probe.model.routes}, int8 "
        f"{sorted(probe.model.quant)}, softmax {probe.model.softmax}")
    if probe.model.train_mode != "pair" or routes != {"pair": 8,
                                                      "block": 32}:
        raise AssertionError(f"train routes {probe.model.train_mode} "
                             f"{routes}")
    batch = probe.ds_train.sample(np.random.default_rng(17))
    out.update(_first_step_vs_plain(probe, batch))
    del probe

    counters = (pt.launch_forward, pt.launch_backward, bt.launch_forward,
                bt.launch_backward)
    for cnt in counters:
        cnt.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    trainer = train_main(argv(os.path.join(tmp, "w96_outputs"), TRAIN_STEPS))
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    pfwd, pbwd, bfwd, bbwd = (cnt.launches for cnt in counters)
    out.update(forward_launches=pfwd, backward_launches=pbwd,
               block_forward_launches=bfwd, block_backward_launches=bbwd)
    log(f"{TRAIN_STEPS} steps in {out['run_s']:.3f} s (evaluations "
        f"included): train-pair calls forward {pfwd}, backward {pbwd}; "
        f"block-train forward {bfwd}, backward {bbwd}")
    if (pfwd, pbwd, bfwd, bbwd) != (8 * TRAIN_STEPS, 8 * TRAIN_STEPS,
                                    32 * TRAIN_STEPS, 32 * TRAIN_STEPS):
        raise AssertionError("expected 8 train-pair and 32 block-train "
                             "calls each way a step")
    losses = trainer.training_loss_records.get("WarmUP", [])
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses}")
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    out["losses"] = losses
    log(f"loss {losses[0]:.5f} -> {losses[-1]:.5f} (first 3 mean "
        f"{first:.5f}, last 3 mean {last:.5f})")
    if not last < first:
        raise AssertionError("the loss did not fall")
    _serve_snapshot(W96_TRAIN_CONFIG, trainer, inference_dtype="bfloat16")
    del trainer
    return out


# ---------------------------------------------------------------- RDST-W96

# The pair's and the RDSTB's kernels as the profiler names them: the
# token-parallel stages (csrc/token_fwd.cuh), the window body's stage
# kernels and the RDSTB's conv
STAGE_PHASES = (
    ("ln1_rows_kernel", "LN1 rows (int8 or bf16), pre-norm adapter rows"),
    ("EpiQkvS8", "qkv GEMM (int8, wgmma .s8)"),
    ("EpiQkv", "qkv GEMM (bf16, wgmma)"),
    ("attn_fwd_kernel", "attention"),
    ("EpiProjLn", "proj GEMM + residual + LN2 (wgmma)"),
    ("mlp_kernel", "fc1 + tanh GELU + fc2 + residual (wgmma, fused)"),
    ("EpiAdapter", "adapter GEMM + LN into the dense rows (wgmma)"),
    ("stage_kernel<", "window-body stage kernels"),
    ("rdstb_conv_kernel", "conv"),
)


def _gemm_floors(tokens: int, widths, growth: int, int8: bool) -> dict:
    """Byte floors (ms at HBM bandwidth) of the token-parallel GEMM phases
    of a call, by STAGE_PHASES label: two blocks a width, each phase's
    token-major inputs read once and outputs written once, and its
    weights (the f32 x1 4 bytes a value, the rest bf16, int8 rows 1);
    the adapter once a width when ``growth``."""
    t = tokens
    q = p = m = a = 0
    for c in widths:
        q += 2 * (t * c * (1 if int8 else 2) + 3 * c * c + 2 * t * 3 * c)
        p += 2 * (4 * t * c + 2 * c * c + 4 * t * c + 2 * t * (c + 16))
        m += 2 * (8 * t * c + 8 * c * c)
        if growth:
            a += 2 * t * c + 2 * growth * c + 2 * t * growth
    ms = 1e3 / HBM_BYTES_PER_S
    out = {STAGE_PHASES[1 if int8 else 2][1]: q * ms,
           STAGE_PHASES[4][1]: p * ms, STAGE_PHASES[5][1]: m * ms}
    if growth:
        out[STAGE_PHASES[6][1]] = a * ms
    return out


def _log_floors(label: str, stages_ms: dict, floors: dict) -> None:
    for ph, floor in floors.items():
        ms = stages_ms.get(ph)
        log(f"  {label} {ph}: " + (f"{ms:.4f} ms" if ms else "not measured")
            + f" against its byte floor {floor:.4f} ms"
            + (f" ({floor / ms:.2f} of HBM bandwidth)" if ms else ""))


def _stage_bound(tokens: int, widths, int8: bool, extra_flops: float,
                 nbytes: float, n: int = 64):
    """Bound of a pair or RDSTB launch: two blocks a width (16C^2 + 4NC
    flops a token), with int8 qkv their qkv products (6C^2) at the int8
    peak, the rest and ``extra_flops`` (adapters, conv) at the bf16
    peak."""
    q = sum(2 * 6 * c * c for c in widths) * tokens
    rest = sum(2 * (10 * c * c + 4 * n * c) for c in widths) * tokens
    if not int8:
        rest, q = rest + q, 0
    t_ops = ((rest + extra_flops) / BF16_FLOPS + q / INT8_OPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


# The token-parallel forward's GEMMs (csrc/token_wgmma.cuh) alone: the
# widths of RDST-W96's DSTLs and SwinIR-std's blocks; 15 windows (a
# partial last 128-row tile), bucket 1 and bucket 64 of 40x32 slices
GEMM_WIDTHS = (96, 144, 180, 192)
GEMM_TOKENS = (15 * 64, 1280, 81920)
GEMM_GROWTH = 48
INT8_OPS = 1979e12  # dense int8 tensor-core peak (TOP/s)


def _ptxas_kernels(source: str) -> dict:
    """The ptxas report of one library by kernel (mangled name): registers,
    spill bytes (stores + loads), and every wgmma serialization warning
    (C7515 / C7520) naming it."""
    from rdst_tpu_torch.kernels import _build

    out, cur = {}, None
    lines = _build.build_log(source).splitlines()
    for line in lines:
        if "Compiling entry function" in line:
            cur = line.split("'")[1]
            out[cur] = {"registers": None, "spill_bytes": 0, "warnings": []}
        elif cur and "Used" in line and "registers" in line:
            out[cur]["registers"] = int(line.split("Used")[1].split()[0])
        elif cur and "spill stores" in line:
            parts = line.replace(",", "").split()
            # "N bytes stack frame, S bytes spill stores, L bytes spill
            # loads"
            out[cur]["spill_bytes"] = (
                int(parts[parts.index("stores") - 3])
                + int(parts[parts.index("loads") - 3]))
    # ptxas prints its warnings before the kernels' reports: a second pass
    for line in lines:
        if "wgmma" in line and ("C7515" in line or "C7520" in line
                                or "serialized" in line):
            for name, rec in out.items():
                if f"'{name}'" in line:
                    rec["warnings"].append(line.strip())
    return out


def _gemm_operands(gen, t: int, c: int, nh: int, hidden: int, growth: int):
    """Seeded operands of one forward's GEMMs at (tokens, C) in the
    forward's buffer layouts (token_dims widths, zeros in the pads, ones
    at column C of the normalized rows) and K-major weights."""
    from rdst_tpu_torch.kernels.swin_block import token_dims

    kp, hp, _, n3, kq = token_dims(c, nh, hidden)
    c8 = -(-c // 8) * 8
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    def rows(width, ones):
        r = torch.zeros(t, width, dtype=bf, device="cuda")
        r[:, :c] = rn(t, c).to(bf)
        if ones:
            r[:, c] = 1.0
        return r

    def mat(n, k, nv, kv, dtype=bf):
        m = torch.zeros(n, k, dtype=dtype, device="cuda")
        m[:nv, :kv] = rn(nv, kv, scale=kv ** -0.5).to(dtype)
        return m

    def i8(n, k):
        m = torch.zeros(n, k, dtype=torch.int8, device="cuda")
        m[:, :c] = torch.randint(-127, 128, (n, c), device="cuda",
                                 generator=gen, dtype=torch.int8)
        return m

    return {
        "xq": i8(t, kq), "wq": i8(n3, kq), "ws": rn(n3).abs() * 1e-4,
        "bqkv": rn(n3, scale=0.1), "xn": rows(kp, True),
        "wqkv": mat(n3, kp, n3, c), "ao": rows(kp, True),
        "wproj": mat(kp, kp, c, c), "x": rn(t, c).to(bf),
        "bproj": rn(c, scale=0.1).to(bf), "x1n": rows(kp, True),
        "w1": mat(hp, kp, hidden, c), "w2": mat(kp, hp, c, hidden),
        "bf1": rn(hidden, scale=0.1), "x1": rn(t, c),
        "bf2": rn(c, scale=0.1).to(bf), "z": rows(c8, False),
        "wad": mat(growth, c8, growth, c), "bad": rn(growth, scale=0.1),
        "gad": 1.0 + rn(growth, scale=0.1), "bbad": rn(growth, scale=0.1),
    }


def _gemm_calls(o, c: int, hidden: int):
    """Each GEMM phase as (name, kernel call, plain call, bytes it must
    move, flops, int8, library yardstick of its products alone)."""
    from rdst_tpu_torch.kernels import token_wgmma as tw

    t, n3, growth = o["x"].shape[0], o["wq"].shape[0], o["wad"].shape[0]
    w = {k: v[:, :c] for k, v in o.items() if k in ("wqkv", "wad")}
    lib_w = {"qkv": w["wqkv"].t().contiguous(),
             "proj": o["wproj"][:c, :c].t().contiguous(),
             "fc1": o["w1"][:hidden, :c].t().contiguous(),
             "fc2": o["w2"][:c, :hidden].t().contiguous(),
             "adapter": w["wad"].t().contiguous()}
    a_c = {k: o[k][:, :c].contiguous() for k in ("xn", "ao", "x1n", "z")}
    h = torch.empty(t, hidden, dtype=torch.bfloat16, device="cuda")

    def int_mm():
        return torch._int_mm(o["xq"], o["wq"].t())

    def mlp_mm():
        torch.matmul(a_c["x1n"], lib_w["fc1"], out=h)
        return torch.matmul(h, lib_w["fc2"])

    return [
        ("qkv int8", lambda: tw.qkv_gemm(o["xq"], o["wq"], o["bqkv"],
                                         o["ws"], c=c),
         lambda: tw.qkv_gemm_reference(o["xq"], o["wq"], o["bqkv"], o["ws"],
                                       c=c),
         t * c + n3 * c + 2 * t * n3, 2 * t * c * n3, True, int_mm),
        ("qkv bf16", lambda: tw.qkv_gemm(o["xn"], o["wqkv"], o["bqkv"], c=c),
         lambda: tw.qkv_gemm_reference(o["xn"], o["wqkv"], o["bqkv"], c=c),
         2 * t * c + 2 * n3 * c + 2 * t * n3, 2 * t * c * n3, False,
         lambda: torch.matmul(a_c["xn"], lib_w["qkv"])),
        ("proj + LN2", lambda: tw.proj_ln(o["ao"], o["wproj"], o["x"],
                                          o["bproj"], c=c),
         lambda: tw.proj_ln_reference(o["ao"], o["wproj"], o["x"],
                                      o["bproj"], c=c),
         2 * t * c * 2 + 2 * c * c + 4 * t * c + 2 * t * o["ao"].shape[1],
         2 * t * c * c, False,
         lambda: torch.matmul(a_c["ao"], lib_w["proj"])),
        ("fc1 + fc2", lambda: tw.mlp(o["x1n"], o["w1"], o["w2"], o["bf1"],
                                     o["x1"], o["bf2"], c=c, hidden=hidden),
         lambda: tw.mlp_reference(o["x1n"], o["w1"], o["w2"], o["bf1"],
                                  o["x1"], o["bf2"], c=c, hidden=hidden),
         2 * t * c + 4 * t * c + 2 * t * c + 4 * c * hidden,
         4 * t * c * hidden, False, mlp_mm),
        ("adapter (pre-norm)", lambda: tw.adapter(
            o["z"], o["wad"], o["bad"], o["gad"], o["bbad"], c=c,
            prenorm=True),
         lambda: tw.adapter_reference(o["z"], o["wad"], o["bad"], o["gad"],
                                      o["bbad"], c=c, prenorm=True),
         2 * t * c + 2 * growth * c + 2 * t * growth, 2 * t * c * growth,
         False, lambda: torch.matmul(a_c["z"], lib_w["adapter"])),
        ("adapter (post-norm)", lambda: tw.adapter(
            o["z"], o["wad"], o["bad"], o["gad"], o["bbad"], c=c,
            prenorm=False),
         lambda: tw.adapter_reference(o["z"], o["wad"], o["bad"], o["gad"],
                                      o["bbad"], c=c, prenorm=False),
         2 * t * c + 2 * growth * c + 2 * t * growth, 2 * t * c * growth,
         False, lambda: torch.matmul(a_c["z"], lib_w["adapter"])),
    ]


def _gemm_launches(o, c: int, hidden: int, bm: int = 0) -> dict:
    """Each GEMM phase's kernel launch alone, by name (outputs allocated
    once, x1 packed once), for its CUDA-event time: the wrappers of
    ``kernels.token_wgmma`` add x1's layout copies and allocations. bm:
    the qkv, proj and MLP kernels' tile rows (64, 128; 0: the
    schedule's)."""
    from rdst_tpu_torch.kernels import _build
    from rdst_tpu_torch.kernels import token_wgmma as tw
    from rdst_tpu_torch.kernels.swin_block import launch

    lib = _build.load("swin_block_fast.cu")
    dev = o["x"].device
    t, kp = o["ao"].shape
    hp, n3, kq = o["w1"].shape[0], o["wq"].shape[0], o["wq"].shape[1]
    growth, ldz = o["wad"].shape
    bf = torch.bfloat16
    q = torch.empty(t, n3, dtype=bf, device=dev)
    x1 = tw.x1_pack(o["x1"])
    x1_out = torch.empty_like(x1)
    x1n = torch.empty(t, kp, dtype=bf, device=dev)
    out = torch.empty(t, c, dtype=bf, device=dev)
    ad = torch.empty(t, growth, dtype=bf, device=dev)

    def run(entry, ptrs, dims):
        return lambda: launch(lib, entry, ptrs, dims, dev)

    adapter = [o["z"], o["wad"], o["bad"], o["gad"], o["bbad"], ad]
    return {
        "qkv int8": run("tokwg_qkv", [o["xq"], o["wq"], o["ws"], o["bqkv"],
                                      q], [t, c, n3, kq, bm]),
        "qkv bf16": run("tokwg_qkv", [o["xn"], o["wqkv"], 0, o["bqkv"], q],
                        [t, c, n3, kp, bm]),
        "proj + LN2": run("tokwg_proj_ln", [o["ao"], o["wproj"], o["x"],
                                            o["bproj"], x1_out, x1n],
                          [t, c, kp, bm]),
        "fc1 + fc2": run("tokwg_mlp", [o["x1n"], o["w1"], o["w2"], o["bf1"],
                                       x1, o["bf2"], out],
                         [t, c, hidden, kp, hp, bm]),
        "adapter (pre-norm)": run("tokwg_adapter", adapter,
                                  [t, c, ldz, growth, 1]),
        "adapter (post-norm)": run("tokwg_adapter", adapter,
                                   [t, c, ldz, growth, 0]),
    }


@phase("token GEMMs vs plain")
def token_gemm_phase() -> dict:
    """The token-parallel forward's GEMMs (csrc/token_wgmma.cuh) one at a
    time on seeded operands, at C = 96 / 144 / 180 / 192 and 960 / 1280
    / 81920 tokens: the int8 qkv product bitwise against its plain
    version (exact integer sums, then the epilogue's roundings), the
    bf16 ones within BF16_TOL; at 81920 tokens each one's launch alone
    (CUDA events over 30) beside its byte floor and bound, and a library
    product of the same shapes as a yardstick of the products alone
    (``torch.matmul``, ``torch._int_mm``), without the fused epilogue.
    Then the ptxas report of the kernels: registers, spills (none
    allowed) and wgmma serialization warnings (none allowed)."""
    out = {"cases": [], "timed": [], "ptxas": {}}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    nh = 6
    for c in GEMM_WIDTHS:
        hidden = 2 * c
        for t in GEMM_TOKENS:
            o = _gemm_operands(gen, t, c, nh, hidden, GEMM_GROWTH)
            raw = _gemm_launches(o, c, hidden)
            for name, call, plain, nbytes, flops, int8, lib in _gemm_calls(
                    o, c, hidden):
                with torch.inference_mode():
                    got, want = call(), plain()
                    torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                if int8:
                    same = all(torch.equal(a, b) for a, b in zip(got, want))
                    if not same:
                        bad = int((got[0] != want[0]).sum())
                        raise AssertionError(
                            f"{name} C={c} T={t}: {bad} q/k/v values differ "
                            "from the exact plain sums")
                    err = (0.0, 0.0, 0.0)
                else:
                    errs = [_check(f"{name} C={c} T={t}", a, b)
                            for a, b in zip(got, want)]
                    err = tuple(max(e[i] for e in errs) for i in range(3))
                case = dict(name=name, c=c, tokens=t, rel_max=err[0],
                            rel_mean=err[1], max_abs_err=err[2],
                            bitwise=int8)
                out["cases"].append(case)
                if t != GEMM_TOKENS[-1]:
                    continue
                with torch.inference_mode():
                    ms = cuda_time_ms(raw[name], warmup=3, iters=30)
                    try:
                        lib_ms = cuda_time_ms(lib)
                    except RuntimeError as exc:
                        log(f"  {name} C={c}: library yardstick refused "
                            f"({exc})")
                        lib_ms = None
                floor = nbytes / HBM_BYTES_PER_S * 1e3
                ops = flops / (INT8_OPS if int8 else BF16_FLOPS) * 1e3
                row = dict(case, ms=ms, byte_floor_ms=floor,
                           bound_ms=max(floor, ops),
                           bound_by="bytes" if floor >= ops else "operations",
                           library_ms=lib_ms,
                           hbm_share=floor / ms if ms else None)
                out["timed"].append(row)
                log(f"  {name} C={c} T={t}: "
                    + (f"{ms:.4f} ms" if ms else "not measured")
                    + f", byte floor {floor:.4f} ms (ops {ops:.4f})"
                    + (f", {floor / ms:.2f} of HBM" if ms else "")
                    + "; library yardstick (products alone) "
                    + (f"{lib_ms:.4f} ms" if lib_ms else "none")
                    + ("; bitwise" if int8 else f"; rel max {err[0]:.2e}"))
            del o, raw
        log(f"token GEMMs C={c}: every case at T = {GEMM_TOKENS} agrees "
            "(int8 bitwise, bf16 within BF16_TOL)")
    for src in ("swin_block_fast.cu", "swin_pair.cu", "rdstb_block.cu"):
        kernels = {k: v for k, v in _ptxas_kernels(src).items()
                   if "tokwg" in k}
        out["ptxas"][src] = kernels
        for name, rec in kernels.items():
            log(f"  ptxas {src} {name}: {rec['registers']} registers, "
                f"{rec['spill_bytes']} spill bytes, "
                f"{len(rec['warnings'])} wgmma warnings")
            if rec["spill_bytes"] or rec["warnings"]:
                raise AssertionError(f"{src} {name}: {rec}")
        if not kernels:
            raise AssertionError(f"{src}: no token GEMM kernel in the "
                                 "ptxas report")
    return out


@phase("W96 kernels vs plain")
def w96_kernel_phase(model32, model16) -> dict:
    """RDST-W96's kernels at bucket 64 (64 images of 40x32) with its
    committed weights (the first RDSTB): the f32 block at C = 96 / 144 /
    192 (``_f32_variant``); the RDSTB with int8 qkv (its pre-norm
    adapters, shift 4, the checkpoint's resolved softmax) and the pair at
    C = 96 / 144 / 192 with int8 qkv, each against its plain and staged
    versions (bar BF16_TOL), two calls bitwise equal, kernels a call,
    CUDA-event ms of the launch alone beside its bound (the qkv products
    at the int8 peak) and the plain version's, device time per stage
    kernel; the pair at C = 96 with bf16 qkv in both stage designs (the
    window body, the token-parallel stages) side by side."""
    from rdst_tpu_torch.kernels import rdstb_block, swin_pair

    ws, nw, images, nh = 8, 20, 64, 6
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    quant = frozenset({"qkv"})
    softmax = model16.softmax
    f32_kernels = _f32_kernels()
    out = {"f32": [_f32_variant(blk, shift, gen, f32_kernels)
                   for blk, shift in _rdst_blocks(model32)],
           "pair": [], "rdstb": []}
    rdstb = model16.body[0]
    kw = dict(num_heads=nh, x_size=LR_HW, window_size=ws, shift=ws // 2,
              softmax=softmax)
    for c, dstl in zip((96, 144, 192), rdstb.body):
        a, b = dstl.body.blocks
        x = torch.randn(images * nw, ws * ws, c, device="cuda",
                        generator=gen).to(torch.bfloat16)
        designs = [("tokens", quant)] + ([("window", frozenset()),
                                          ("tokens", frozenset())]
                                         if c == 96 else [])
        for design, q in designs:
            route = {"window": "stage", "tokens": "tokens"}[design]
            plan_a = _pair_plan(a, LR_HW, ws, 0, q, route)
            plan_b = _pair_plan(b, LR_HW, ws, ws // 2, q, route)
            args = (x, plan_a.params, plan_a.bias, plan_b.params,
                    plan_b.bias)
            qkw = dict(qkv_a=plan_a.qkv, qkv_b=plan_b.qkv, **kw)
            label = f"pair C={c} {'int8' if q else 'bf16'} qkv ({design})"

            def call():
                return swin_pair.run_swin_pair(x, plan_a, plan_b, **kw)

            with torch.inference_mode():
                got = call()
                want = swin_pair.swin_pair_reference(*args, **qkw)
                staged = swin_pair.swin_pair_staged_reference(*args, **qkw)
                torch.cuda.synchronize()
                err = _check(label, got, want)
                err_s = _check(f"{label} vs staged", got, staged)
                ms = cuda_time_ms(call)
                plain_ms = cuda_time_ms(
                    lambda: swin_pair.swin_pair_reference(*args, **qkw),
                    warmup=1, iters=5)
                extras = _stage_extras(label, call, swin_pair.run_swin_pair,
                                       STAGE_PHASES)
            bound_ms, by = _stage_bound(
                images * nw * ws * ws, (c,), bool(q), 0.0,
                2 * 2 * x.numel() + _plan_bytes(plan_a) + _plan_bytes(plan_b)
                + _nbytes(*plan_a.qkv_layout, *plan_b.qkv_layout))
            floors = (_gemm_floors(images * nw * ws * ws, (c,), 0, bool(q))
                      if design == "tokens" else {})
            _log_floors(label, extras["stages_ms"], floors)
            row = dict(c=c, int8=bool(q), design=design, rel_max=err[0],
                       rel_mean=err[1], max_abs_err=err[2],
                       staged_rel_max=err_s[0], ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=by, gemm_floor_ms=floors,
                       **extras)
            out["pair"].append(row)
            log(f"{label} {softmax}: rel max {err[0]:.3e} mean {err[1]:.3e},"
                f" vs staged {err_s[0]:.3e}; kernels {ms:.4f} ms plain "
                f"{plain_ms:.4f} ms bound {bound_ms:.4f} ms ({by})")
    h, w = LR_HW
    plan = rdstb_block.plan_rdstb(
        *rdstb.rdstb_inputs(LR_HW, ws, ws // 2), num_heads=nh,
        growth=rdstb.growth_rate, adapter_prenorm=rdstb.pre_norm,
        quant=quant)
    if plan.routes != ["tokens"] * 3:
        raise AssertionError(f"W96 RDSTB with int8 qkv: routes {plan.routes}")
    x = torch.randn(images, h * w, 96, device="cuda",
                    generator=gen).to(torch.bfloat16)
    rkw = dict(growth=plan.growth, adapter_prenorm=plan.prenorm, **kw)

    def call():
        return rdstb_block.run_rdstb(x, plan, **kw)

    with torch.inference_mode():
        got = call()
        want = rdstb_block.rdstb_reference(x, plan.dstls, plan.wc, plan.bc,
                                           **rkw)
        staged = rdstb_block.rdstb_staged_reference(
            x, plan.dstls, plan.wc, plan.bc, **rkw)
        torch.cuda.synchronize()
        err = _check("W96 rdstb int8 qkv", got, want)
        err_s = _check("W96 rdstb int8 qkv vs staged", got, staged)
        ms = cuda_time_ms(call)
        plain_ms = cuda_time_ms(lambda: rdstb_block.rdstb_reference(
            x, plan.dstls, plan.wc, plan.bc, **rkw), warmup=1, iters=3)
        extras = _stage_extras("W96 rdstb int8 qkv", call,
                               rdstb_block.run_rdstb, STAGE_PHASES)
    ccat = 96 + 3 * 48
    adapter_conv = (sum(2 * c * 48 for c in (96, 144, 192)) * images * h * w
                    + images * h * w * 2 * 9 * ccat * 96)
    nbytes = 2 * 2 * x.numel() + sum(
        _nbytes(*d.pa, *d.pb, d.bias_a, d.bias_b, *d.adapter, *d.qa, *d.qb)
        for d in plan.dstls) + _nbytes(plan.wc, plan.bc)
    bound_ms, by = _stage_bound(images * h * w, (96, 144, 192), True,
                                adapter_conv, nbytes)
    floors = _gemm_floors(images * h * w, (96, 144, 192), 48, True)
    _log_floors("W96 rdstb int8 qkv", extras["stages_ms"], floors)
    out["rdstb"].append(dict(rel_max=err[0], rel_mean=err[1],
                             max_abs_err=err[2], staged_rel_max=err_s[0],
                             ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=by, gemm_floor_ms=floors, **extras))
    log(f"W96 rdstb int8 qkv {softmax}: rel max {err[0]:.3e} mean "
        f"{err[1]:.3e}, vs staged {err_s[0]:.3e}; kernels {ms:.4f} ms plain "
        f"{plain_ms:.4f} ms bound {bound_ms:.4f} ms ({by})")
    log("library yardstick: no single PyTorch call computes a DSTL pair or "
        "an RDSTB")
    return out


def _pair_plan(block, x_size, ws: int, shift: int, quant, route: str):
    """A model block's fast-branch plan for a pair stage design."""
    from rdst_tpu_torch.kernels.swin_block import plan_fast_block

    return plan_fast_block(*block.fast_kernel_inputs(x_size, ws, shift),
                           num_heads=block.num_heads, quant=quant,
                           route=route)


@phase("W96 whole model")
def w96_model_phase(live32, live16) -> dict:
    """RDST-W96 with its committed 40k weights on 8 seeded 40x32 slices:
    f32 as shipped on the f32 block kernel (48 launches a forward) against
    the plain f32 path (bar MODEL_TOL); bf16 with int8 qkv in modes rdstb
    (the default), pair and swin (8 / 24 / 48 launches a forward, counts
    set to 0 just before each and read just after), each against the f32
    model (< BF16_VS_F32_MAX max, < BF16_VS_F32_MEAN mean, relative) and
    modes rdstb and pair against mode swin, whose kernel was ported
    before; per mode the wall and device time of one warm bucket-64
    forward."""
    from rdst_tpu_torch.kernels import rdstb_block, swin_block, swin_pair
    from rdst_tpu_torch.models.rdst import set_kernel_mode
    from rdst_tpu_torch.nn.swin import set_block_kernels

    rng = np.random.default_rng(SEED + 13)
    x = rng.random((8,) + LR_HW + (1,), dtype=np.float32)
    x64 = rng.random((64,) + LR_HW, dtype=np.float32)
    swin_block.fused_swin_block.launches = 0  # the f32 path starts here
    y32 = live32.predict(x, SCALE)
    launches = swin_block.fused_swin_block.launches  # and ends here
    set_block_kernels(live32.model, False)
    try:
        y32_plain = live32.predict(x, SCALE)
    finally:
        set_block_kernels(live32.model, True)
    err = float(np.abs(y32 - y32_plain).max())
    log(f"W96 f32: {launches} fused_swin_block launches per forward; kernel "
        f"path vs plain path max abs err {err:.3e} (tol {MODEL_TOL})")
    if launches != 48 or err > MODEL_TOL or not np.isfinite(y32).all():
        raise AssertionError(f"W96 f32: {launches} launches, err {err}")
    wall, busy = _device_ms(lambda: live32.predict(x64, SCALE))
    out = {"f32": {"launches_per_forward": launches, "max_abs_err": err,
                   "bucket64_wall_ms": wall, "bucket64_device_ms": busy}}
    log(f"W96 f32: one warm bucket-64 forward {wall:.3f} ms wall, device "
        + (f"{busy:.3f} ms" if busy is not None else "not measured"))

    def versus(y, ref):
        r = _rel(torch.from_numpy(y), torch.from_numpy(ref))
        return r[0], r[1], float(10 * np.log10(1.0 / np.mean((y - ref) ** 2)))

    model, softmax, quant = live16.model, live16.model.softmax, \
        live16.model.quant
    counters = {"swin": (swin_block.run_fast_block, 48),
                "rdstb": (rdstb_block.run_rdstb, 8),
                "pair": (swin_pair.run_swin_pair, 24)}
    ys = {}
    try:
        for mode, (counter, want_launches) in counters.items():
            set_kernel_mode(model, mode, softmax, quant)
            for c, _ in counters.values():
                c.launches = 0  # this mode's path starts here
            y = live16.predict(x, SCALE)
            launches = {c.__name__: c.launches for c, _ in counters.values()}
            if launches[counter.__name__] != want_launches or sum(
                    launches.values()) != want_launches:
                raise AssertionError(f"W96 mode {mode}: launches {launches}")
            if not np.isfinite(y).all():
                raise AssertionError(f"W96 mode {mode}: non-finite output")
            ys[mode] = y
            kf = versus(y, y32)
            ks = versus(y, ys["swin"]) if mode != "swin" else (None, None)
            log(f"W96 bf16 int8 qkv mode {mode}: {want_launches} launches of "
                f"{counter.__name__} per forward; vs the f32 model rel max "
                f"{kf[0]:.3e} mean {kf[1]:.3e}, PSNR {kf[2]:.2f} dB" + (
                    f"; vs mode swin rel max {ks[0]:.3e} mean {ks[1]:.3e}"
                    if ks[0] is not None else ""))
            if kf[0] >= BF16_VS_F32_MAX or kf[1] >= BF16_VS_F32_MEAN:
                raise AssertionError(f"W96 mode {mode} vs f32: {kf}")
            wall, busy = _device_ms(lambda: live16.predict(x64, SCALE))
            log(f"W96 bf16 mode {mode}: one warm bucket-64 forward "
                f"{wall:.3f} ms wall, device " + (
                    f"{busy:.3f} ms" if busy is not None else "not measured"))
            out[mode] = {"launches_per_forward": want_launches,
                         "vs_f32_rel_max": kf[0], "vs_f32_rel_mean": kf[1],
                         "psnr_vs_f32_db": kf[2], "vs_swin_rel_max": ks[0],
                         "vs_swin_rel_mean": ks[1],
                         "bucket64_wall_ms": wall, "bucket64_device_ms": busy}
    finally:
        set_kernel_mode(model, "rdstb", softmax, quant)
    return out


w96_serving_phase = phase("W96 f32 serving")(_serve)
w96_bf16_serving_phase = phase("W96 bf16 serving")(_serve)
w96_profile_phase = phase("W96 f32 profile")(_profile)
w96_bf16_profile_phase = phase("W96 bf16 profile")(_profile)


@phase("W96 train-pair kernels vs plain")
def w96_train_kernel_phase(model) -> dict:
    """Phase 11 at RDST-W96's pair width, C = 96, with its committed
    weights (the first RDSTB's first DSTL)."""
    rows = _train_pair_widths(model, ((0, 96),), "W96")
    return {"variants": rows}


# ---------------------------------------------------------------------------
# The tester path (python -m rdst_tpu_torch.test): the README quality rows
# on the held-out patients of the 20-phantom corpus
# ---------------------------------------------------------------------------

# a row's PSNR (dB) and SSIM against its bar; a bf16 row against its f32
# row by the same amounts
TESTER_PSNR_TOL, TESTER_SSIM_TOL = 0.02, 0.002
# tiled inference against whole-slice SR (tests/test_e2e.py:229)
TILED_TOL_DB = 2.0
TILED_STRIDE = 12
HRL_CONFIG = "config_files/rdst_hrl_seg_ft_oasis20_x4.ini"
HRL_WEIGHTS = "weights/rdst_hrl_ft_best_oasis20_x4.msgpack"
GAN_CONFIG = "config_files/rdst_gan_ft_oasis20_x4.ini"
GAN_WEIGHTS = "weights/rdst_ganft_5k_best_oasis20_x4.msgpack"
GAN2_CONFIG = "config_files/rdst_gan_ft2_oasis20_x4.ini"
GAN2_WEIGHTS = "weights/rdst_ganft2_10k_best_oasis20_x4.msgpack"
LIGHT_CONFIG = "config_files/swinir_light_40k_oasis20_x4.ini"
LIGHT_WEIGHTS = "weights/swinir_light_40k_best_oasis20_x4.msgpack"
# The bars: the JAX tester's own numbers for each row on this corpus
# (``tools/jax_tester_bars.py``: ``rdst_tpu.runners.tester`` on the CPU,
# patients 19-20 of the same seeded corpus, the bf16 rows with the Pallas
# kernels in interpret mode, int8 qkv included, as on a TPU), each beside its
# README:83-90 figure (the GAN rows' vifp and lpips from the JAX package's
# record, git show d4572e2:PERF.md). SwinIR-std's README 28.49 / 0.886
# is 0.015 dB off the JAX tester's own number; the JAX tester is the bar.
TESTER_BARS = {
    "bicubic": {"readme": (23.93, 0.708), "psnr": 23.9326, "ssim": 0.7082},
    "E1 f32": {"readme": (27.39, 0.856), "psnr": 27.3906, "ssim": 0.8564},
    "E1 bf16": {"readme": None, "psnr": 27.3918, "ssim": 0.8565},
    "E1 f32 tiled": {"readme": None, "psnr": 29.7100, "ssim": 0.8994},
    "E1 f32 tiled 12/6": {"readme": None, "psnr": 26.7503, "ssim": 0.8176},
    "HRL fine-tune": {"readme": (27.46, 0.857), "psnr": 27.4596,
                      "ssim": 0.8573},
    "RaGAN fine-tune 5k": {"readme": (27.53, 0.8556, 0.8023, 0.00282),
                           "psnr": 27.5282, "ssim": 0.8556, "vifp": 0.8023,
                           "lpips": 0.002824},
    "RaGAN fine-tune 2 10k": {"readme": (27.41, 0.8564, 0.8063, 0.00285),
                              "psnr": 27.4143, "ssim": 0.8564,
                              "vifp": 0.8063, "lpips": 0.002851},
    "SwinIR-light": {"readme": (27.02, 0.848), "psnr": 27.0154,
                     "ssim": 0.8475},
    "SwinIR-std": {"readme": (28.49, 0.886), "psnr": 28.4746, "ssim": 0.8853},
    "W96 f32": {"readme": (28.21, 0.872), "psnr": 28.2068, "ssim": 0.8718},
    "W96 bf16": {"readme": None, "psnr": 28.1681, "ssim": 0.8710},
    # every int8 group (pallas_quant = 'all'): the JAX tester with its
    # kernels in interpret mode
    "E1 bf16 int8 all": {"readme": None, "psnr": 27.2630, "ssim": 0.8522},
    "W96 bf16 int8 all": {"readme": None, "psnr": 27.9857, "ssim": 0.8586},
    "SwinIR-std int8 all": {"readme": None, "psnr": 28.4583,
                            "ssim": 0.8848},
    # one MetaSR model at four scales (README:185-187)
    "MetaSR x1.5": {"readme": (27.34, 0.932), "psnr": 27.3448,
                    "ssim": 0.9323},
    "MetaSR x2.0": {"readme": (29.37, 0.945), "psnr": 29.3702,
                    "ssim": 0.9448},
    "MetaSR x3.0": {"readme": (27.70, 0.894), "psnr": 27.6993,
                    "ssim": 0.8936},
    "MetaSR x4.0": {"readme": (26.71, 0.843), "psnr": 26.7147,
                    "ssim": 0.8425},
    # the cross-dataset layouts (README:172-177), f32 as shipped, test
    # patient 8 of each 8-phantom corpus; BraTS a score a modality
    "BraTS": {"readme": {"t1ce": (24.50, 0.785), "t1": (24.65, 0.782),
                         "t2": (24.66, 0.767), "flair": (25.50, 0.789)},
              "t1ce psnr": 24.5027, "t1ce ssim": 0.7847,
              "t1 psnr": 24.6523, "t1 ssim": 0.7824,
              "t2 psnr": 24.6575, "t2 ssim": 0.7674,
              "flair psnr": 25.4983, "flair ssim": 0.7886},
    "ACDC": {"readme": (32.32, 0.940), "psnr": 32.3168, "ssim": 0.9397},
    "COVID": {"readme": (35.12, 0.937), "psnr": 35.1176, "ssim": 0.9370},
}
# vifp and lpips against their bars (host metrics on the card's outputs)
TESTER_VIFP_TOL, TESTER_LPIPS_TOL = 0.002, 1e-4


def _tester_patients(data_dir: str, config: str = CONFIG) -> dict:
    """{patient id: its test pairs}, as the tester builds them (every
    oasis20 config has the same data keys)."""
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.data.readers import (make_test_dataset,
                                             testing_patient_ids)

    p = ParametersLoader(config)
    p.set("data_folder", data_dir)
    out = {}
    for pid in testing_patient_ids(p):
        ds = make_test_dataset(p, [pid])
        out[pid] = [ds.get_test_pair(i) for i in range(ds.test_len())]
    return out


def _images(patients: dict) -> list:
    """Slices per patient: the batch of one whole-patient forward."""
    return [len(pairs) for pairs in patients.values()]


def _tester_geometries(patients: dict) -> list:
    """(slices, image size) of the kernel checks: each whole patient at
    its LR slice padded to whole windows of 8 (what the kernels see in
    the tester's forward), and at the serving geometry 40x32."""
    h, w = _lr_hw(patients)
    padded = (-(-h // 8) * 8, -(-w // 8) * 8)
    return [(n, hw) for hw in (padded, LR_HW) for n in _images(patients)]


def _lr_hw(patients: dict):
    return next(iter(patients.values()))[0][4.0]["in"].shape[1:3]


def _f32_block_at(block, shift: int, images: int, x_size, gen) -> dict:
    """The f32 block kernel against its plain version on ``images``
    images of ``x_size`` (one whole patient)."""
    from rdst_tpu_torch.kernels import swin_block as sb

    ws, nh, c = 8, block.num_heads, block.dim
    nw = (x_size[0] // ws) * (x_size[1] // ws)
    params, bias = block.kernel_inputs(x_size, ws, shift)
    x = torch.randn(images * nw, ws * ws, c, device="cuda", generator=gen)
    kw = dict(num_heads=nh, windows_per_image=nw)
    with torch.inference_mode():
        plan = sb.plan_f32_block(params, bias, num_heads=nh)
        got = sb.run_f32_block(x, plan, **kw)
        want = sb.swin_block_reference(x, *plan.params, bias, **kw)
        err = (got - want).abs().max().item()
        ms = cuda_time_ms(lambda: sb.run_f32_block(x, plan, **kw),
                          warmup=1, iters=5)
        plain_ms = cuda_time_ms(
            lambda: sb.swin_block_reference(x, *plan.params, bias, **kw),
            warmup=1, iters=5)
    flops, weights = _block_work(block, c, images * nw)
    bound = _f32_bound(flops, 4 * (2 * x.numel() + weights + bias.numel()))
    label = (f"f32 block C={c} shift={shift} at {images} x {x_size} "
             f"({images * nw} windows)")
    log(f"{label}: max abs err {err:.3e} (tol {KERNEL_TOL}), {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
        f"({bound['bound_by']})")
    if not (err <= KERNEL_TOL and torch.isfinite(got).all()):
        raise AssertionError(f"{label}: {err} > {KERNEL_TOL}")
    return dict(c=c, shift=shift, images=images, x_size=list(x_size),
                windows=images * nw, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, **bound)


def _rdstb_at(rdstb, images: int, x_size, gen, softmax: str,
              quant=frozenset()) -> dict:
    """The RDSTB kernel against its plain version on ``images`` images of
    ``x_size`` with ``rdstb``'s weights."""
    from rdst_tpu_torch.kernels import rdstb_block

    ws, nh = 8, 6
    h, w = x_size
    plan = rdstb_block.plan_rdstb(
        *rdstb.rdstb_inputs(x_size, ws, ws // 2), num_heads=nh,
        growth=rdstb.growth_rate, adapter_prenorm=rdstb.pre_norm,
        quant=quant)
    c0 = rdstb.body[0].body.blocks[0].dim
    x = torch.randn(images, h * w, c0, device="cuda",
                    generator=gen).to(torch.bfloat16)
    kw = dict(num_heads=nh, x_size=x_size, window_size=ws, shift=ws // 2,
              softmax=softmax)
    windows = images * (h // ws) * (w // ws)
    label = (f"rdstb C0={c0}{' int8 qkv' if quant else ''} at {images} x "
             f"{tuple(x_size)} ({windows} windows)")
    with torch.inference_mode():
        got = rdstb_block.run_rdstb(x, plan, **kw)
        want = rdstb_block.rdstb_reference(
            x, plan.dstls, plan.wc, plan.bc, growth=plan.growth,
            adapter_prenorm=plan.prenorm, **kw)
        torch.cuda.synchronize()
        err = _check(label, got, want)
        ms = cuda_time_ms(lambda: rdstb_block.run_rdstb(x, plan, **kw),
                          warmup=1, iters=5)
        plain_ms = cuda_time_ms(lambda: rdstb_block.rdstb_reference(
            x, plan.dstls, plan.wc, plan.bc, growth=plan.growth,
            adapter_prenorm=plan.prenorm, **kw), warmup=1, iters=3)
    bound_ms, by, _ = _rdstb_bound(plan, x, images, x_size)
    log(f"{label}: rel max {err[0]:.3e} mean {err[1]:.3e} (bar {BF16_TOL}), "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({by})")
    return dict(images=images, x_size=list(x_size), windows=windows,
                rel_max=err[0], rel_mean=err[1], max_abs_err=err[2], ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)


def _fast_block_at(block, images: int, x_size, gen, softmax: str,
                   quant, bound: bool = False) -> dict:
    """The fast block against its plain version on ``images`` images of
    ``x_size`` (one whole patient), unshifted (SwinIR-std's blocks at its
    build resolution); with ``bound`` also the plain version's time and
    the launch's bound."""
    from rdst_tpu_torch.kernels import swin_block

    ws, nh, c = 8, block.num_heads, block.dim
    nw = (x_size[0] // ws) * (x_size[1] // ws)
    plan = swin_block.plan_fast_block(*block.fast_kernel_inputs(x_size, ws, 0),
                                      num_heads=nh, quant=quant)
    x = torch.randn(images * nw, ws * ws, c, device="cuda",
                    generator=gen).to(torch.bfloat16)
    kw = dict(num_heads=nh, windows_per_image=nw, softmax=softmax)
    label = (f"fast block C={c}{' int8 qkv' if quant else ''} "
             f"({plan.route}) at {images} x {tuple(x_size)} "
             f"({images * nw} windows)")
    with torch.inference_mode():
        got = swin_block.run_fast_block(x, plan, **kw)
        want = swin_block.swin_block_fast_reference(
            x, plan.params, plan.bias, num_heads=nh, softmax=softmax,
            qkv=plan.qkv)
        torch.cuda.synchronize()
        err = _check(label, got, want)
        ms = cuda_time_ms(lambda: swin_block.run_fast_block(x, plan, **kw),
                          warmup=1, iters=5)
        extra = {}
        if bound:
            extra["plain_ms"] = cuda_time_ms(
                lambda: swin_block.swin_block_fast_reference(
                    x, plan.params, plan.bias, num_heads=nh,
                    softmax=softmax, qkv=plan.qkv), warmup=1, iters=3)
            nbytes = 2 * 2 * x.numel() + _plan_bytes(plan) + sum(
                t.numel() * t.element_size() for t in plan.qkv_layout)
            if quant:
                extra["bound_ms"], extra["bound_by"] = _int8_qkv_bound(
                    x.shape[0] * 64, c, nbytes)
            else:
                extra["bound_ms"], extra["bound_by"] = _bound(
                    _block_flops(x.shape[0], c), nbytes)
    log(f"{label}: rel max {err[0]:.3e} mean {err[1]:.3e} (bar {BF16_TOL}), "
        f"{ms:.4f} ms" + (f", plain {extra['plain_ms']:.4f} ms, bound "
                          f"{extra['bound_ms']:.4f} ms ({extra['bound_by']})"
                          if bound else ""))
    return dict(c=c, images=images, x_size=list(x_size), windows=images * nw,
                rel_max=err[0], rel_mean=err[1], max_abs_err=err[2], ms=ms,
                **extra)


def _tiled_chunk(model32, model16, gen, patches: int = 128) -> dict:
    """One chunk of the tester's tiled inference (``max(4 * batch_size,
    8)`` = 128 LR patches of 24x24) through the f32 model, kernel path
    against its plain path (bar MODEL_TOL), and through the bf16 model
    against the f32 kernel path (the bf16-vs-f32 bars)."""
    from rdst_tpu_torch.nn.swin import set_block_kernels

    x = torch.rand(patches, 24, 24, 1, device="cuda", generator=gen)
    with torch.inference_mode():
        y = model32(x)
        set_block_kernels(model32, False)
        try:
            y_plain = model32(x)
        finally:
            set_block_kernels(model32, True)
        y16 = model16(x).float()
    err = (y - y_plain).abs().max().item()
    r16 = _rel(y16, y)
    log(f"tiled chunk of {patches} LR 24x24 patches: f32 kernel vs plain max "
        f"abs err {err:.3e} (tol {MODEL_TOL}); bf16 ({model16.kernel_mode}) "
        f"vs f32 rel max {r16[0]:.3e} mean {r16[1]:.3e} (bars "
        f"{BF16_VS_F32_MAX}, {BF16_VS_F32_MEAN})")
    if y.shape != (patches, 96, 96, 1) or not torch.isfinite(y16).all():
        raise AssertionError(f"tiled chunk: {y.shape}")
    if err > MODEL_TOL:
        raise AssertionError(f"tiled chunk f32 kernel vs plain: {err}")
    if r16[0] >= BF16_VS_F32_MAX or r16[1] >= BF16_VS_F32_MEAN:
        raise AssertionError(f"tiled chunk bf16 vs f32: {r16}")
    return {"f32_max_abs_err": err, "bf16_vs_f32_rel_max": r16[0],
            "bf16_vs_f32_rel_mean": r16[1]}


def _tester_forwards(tester, patients: dict) -> int:
    """Model forwards of one tester run: one a patient, or its tiled
    chunks."""
    from rdst_tpu_torch.data.folding import ImageFolder

    if not tester.paras.get("tiled_inference", False):
        return len(patients)
    patch = int(tester.paras.patch_size)
    stride = int(tester.paras.get("test_lr_patch_stride", patch))
    chunk = max(tester.paras.batch_size * 4, 8)
    total = 0
    for n in _images(patients):
        folder = ImageFolder((n,) + tuple(_lr_hw(patients)) + (1,), patch,
                             stride)
        total += -(-n * folder.num_patches // chunk)
    return total


def _tester_row(label: str, config: str, weights, data_dir: str, tmp: str,
                patients: dict, counter=None, per_forward: int = 0,
                bar=None, **overrides) -> dict:
    """``cli.test_main`` on the card for one row (its own output tree):
    the mean scores over every held-out slice against ``bar`` ({metric:
    value}; PSNR and SSIM must hold TESTER_PSNR_TOL / TESTER_SSIM_TOL),
    ``counter``'s launches (set to 0 just before the run, read just after:
    ``per_forward`` a forward), and per patient the tester's inference
    wall time (its report) and one warm forward's wall and device time."""
    from rdst_tpu_torch.cli import test_main

    over = {"data_folder": data_dir, "verbose": False,
            "output_dir": os.path.join(tmp, "tester", label.replace(" ", "_")),
            **overrides}
    if weights:
        over["well_trained_single_scale_model_g"] = weights
    argv = ["--config-file", config] + [f"{k}={v!r}" for k, v in over.items()]
    if counter is not None:
        counter.launches = 0  # the tester's path starts here
    t0 = time.perf_counter()
    tester = test_main(argv)
    wall = time.perf_counter() - t0
    launches = counter.launches if counter is not None else 0  # and ends here
    stacked = np.load(os.path.join(tester.output_root,
                                   "stacked_eva_reports.npy"),
                      allow_pickle=True).item()
    metrics = tester.eva_func.basic_metrics
    if all(isinstance(v, dict) for v in stacked.values()):
        # BraTS: a report a modality, scored as "{modality} {metric}"
        scores = {f"{mod} {m}": float(np.mean(rep[f"{m}_4.0"]))
                  for mod, rep in stacked.items() for m in metrics}
        stacked = next(iter(stacked.values()))
    else:
        scores = {m: float(np.mean(stacked[f"{m}_4.0"])) for m in metrics}
    patients_out = []
    for pid in tester.patient_ids:
        rep = np.load(os.path.join(tester.dirs["eva_reports"],
                                   f"{pid}_eva_reports.npy"),
                      allow_pickle=True).item()
        row = {"pid": pid, "slices": rep["num_slices"],
               "inference_s": rep["inference_time_cost"]}
        if tester.model is not None:
            pairs = patients[pid]
            lr = np.concatenate([p[4.0]["in"] for p in pairs])
            if tester.paras.get("tiled_inference", False):
                def sr():
                    return tester._tiled_inference(lr, 4.0, pairs)
            else:
                def sr():
                    return tester.forward(lr).cpu().numpy()
            row["forward_ms"], row["device_ms"] = _device_ms(sr)
            # the host metrics of the patient's slices, alone
            recs = [{4.0: y} for y in sr()]
            t1 = time.perf_counter()
            tester.eva_func(recs, pairs)
            row["metrics_s"] = time.perf_counter() - t1
        patients_out.append(row)
    out = {"label": label, "config": config, "weights": weights,
           "scores": scores, "slices": len(stacked["psnr_4.0"]),
           "wall_s": wall, "patients": patients_out,
           "manifest": tester.manifest}
    if counter is not None:
        forwards = _tester_forwards(tester, patients)
        out["launches"] = launches
        if launches != per_forward * forwards:
            raise AssertionError(f"tester {label}: {launches} launches, "
                                 f"expected {per_forward} x {forwards}")
    text = " ".join(f"{m} {v:.6f}" if m.endswith("lpips") else
                    f"{m} {v:.4f}" for m, v in scores.items())
    per = "; ".join(
        f"{r['pid']} {r['slices']} slices inference {r['inference_s']:.3f} s"
        + (f", forward {r['forward_ms']:.3f} ms wall / "
           f"{r['device_ms'] or float('nan'):.3f} ms device, metrics "
           f"{r['metrics_s']:.3f} s" if "forward_ms" in r else "")
        for r in patients_out)
    shown = None if bar is None else {k: v for k, v in bar.items()
                                      if k != "readme"}
    readme = "" if bar is None or not bar.get("readme") else \
        f", README {bar['readme']}"
    log(f"tester {label}: {text} over {out['slices']} slices (bar "
        f"{shown}{readme}); {per}; run {wall:.3f} s"
        + (f"; {launches} launches of {counter.__name__}"
           if counter is not None else ""))
    if bar is not None:
        tols = {"psnr": TESTER_PSNR_TOL, "ssim": TESTER_SSIM_TOL,
                "vifp": TESTER_VIFP_TOL, "lpips": TESTER_LPIPS_TOL}
        out["delta"] = {m: scores[m] - bar[m] for m in bar
                        if m != "readme"}
        off = {m: d for m, d in out["delta"].items()
               if abs(d) > tols[m.split()[-1]]}
        if off:
            raise AssertionError(f"tester {label}: {scores} against bar "
                                 f"{bar}: {off} past {tols}")
    return out


def _versus_f32(label: str, row16: dict, row32: dict) -> dict:
    """A bf16 row against its f32 row: logged; past TESTER_PSNR_TOL /
    TESTER_SSIM_TOL it fails."""
    d = {m: row16["scores"][m] - row32["scores"][m] for m in ("psnr", "ssim")}
    log(f"{label} against f32: {d['psnr']:+.4f} dB, SSIM {d['ssim']:+.5f} "
        f"(tol {TESTER_PSNR_TOL}, {TESTER_SSIM_TOL})")
    if abs(d["psnr"]) > TESTER_PSNR_TOL or abs(d["ssim"]) > TESTER_SSIM_TOL:
        raise AssertionError(f"{label} against f32: {d}")
    row16["versus_f32"] = d
    return d


@phase("E1 tester")
def e1_tester_phase(data_dir: str, tmp: str, patients: dict, live32,
                    live16) -> dict:
    """The kernels at the tester's batch sizes against their plain
    versions (the f32 block and the RDSTB at one whole patient's windows,
    a tiled chunk in f32 and bf16), then ``cli.test_main`` on the card
    for the bicubic, E1 f32, E1 bf16, E1 f32 tiled (stride 12), HRL and
    the two RaGAN fine-tune rows."""
    from rdst_tpu_torch.kernels import rdstb_block, swin_block

    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    kern = {"f32": [], "rdstb": []}
    for images, x_size in _tester_geometries(patients):
        kern["f32"] += [_f32_block_at(blk, shift, images, x_size, gen)
                        for blk, shift in _rdst_blocks(live32.model)[:2]]
        kern["rdstb"].append(_rdstb_at(live16.model.body[0], images, x_size,
                                       gen, live16.model.softmax))
    kern["rdstb"].append(_rdstb_at(live16.model.body[0], 128, (24, 24), gen,
                                   live16.model.softmax))
    kern["tiled"] = _tiled_chunk(live32.model, live16.model, gen)
    f32, run = swin_block.fused_swin_block, rdstb_block.run_rdstb
    rows = {}

    def row(label, config, weights, counter=None, per_forward=0, bar=None,
            **kw):
        rows[label] = _tester_row(label, config, weights, data_dir, tmp,
                                  patients, counter, per_forward, bar, **kw)
        return rows[label]

    row("bicubic", CONFIG, None, bar=TESTER_BARS["bicubic"],
        feature_generator="bicubic")
    e1 = row("E1 f32", CONFIG, WEIGHTS, f32, 48, TESTER_BARS["E1 f32"])
    e1_16 = row("E1 bf16", CONFIG, WEIGHTS, run, 8, TESTER_BARS["E1 bf16"],
                inference_dtype="bfloat16")
    _versus_f32("E1 bf16", e1_16, e1)
    tiled = row("E1 f32 tiled", CONFIG, WEIGHTS, f32, 48,
                TESTER_BARS["E1 f32 tiled"], tiled_inference=True,
                test_lr_patch_stride=TILED_STRIDE)
    # the held-out slices are LR 16x12, one zero-padded 24x24 patch at the
    # config's patch size: the model sees 24x24, its training size, and
    # scores 2.3 dB above whole-slice SR, in the JAX tester as here
    d = tiled["scores"]["psnr"] - e1["scores"]["psnr"]
    log(f"tiled (stride {TILED_STRIDE}) against whole-slice: {d:+.4f} dB "
        f"(tol {TILED_TOL_DB} below)")
    if d < -TILED_TOL_DB:
        raise AssertionError(f"tiled row {d} dB below the whole-slice row")
    # 12x12 patches at stride 6 overlap, 4 a slice, in chunks of 128
    small = row("E1 f32 tiled 12/6", CONFIG, WEIGHTS, f32, 48,
                TESTER_BARS["E1 f32 tiled 12/6"], tiled_inference=True,
                patch_size=12, test_lr_patch_stride=6)
    d = small["scores"]["psnr"] - e1["scores"]["psnr"]
    log(f"tiled (patch 12, stride 6) against whole-slice: {d:+.4f} dB (tol "
        f"{TILED_TOL_DB})")
    if abs(d) > TILED_TOL_DB:
        raise AssertionError(f"tiled row {d} dB off the whole-slice row")
    row("HRL fine-tune", HRL_CONFIG, HRL_WEIGHTS, f32, 48,
        TESTER_BARS["HRL fine-tune"])
    row("RaGAN fine-tune 5k", GAN_CONFIG, GAN_WEIGHTS, f32, 48,
        TESTER_BARS["RaGAN fine-tune 5k"])
    row("RaGAN fine-tune 2 10k", GAN2_CONFIG, GAN2_WEIGHTS, f32, 48,
        TESTER_BARS["RaGAN fine-tune 2 10k"])
    return {"kernels": kern, "rows": rows}


@phase("SwinIR tester")
def swinir_tester_phase(data_dir: str, tmp: str, patients: dict,
                        live16) -> dict:
    """The C = 180 fast block with int8 qkv at one whole patient's
    windows against its plain version, then ``cli.test_main`` on the card
    for SwinIR-light (f32) and SwinIR-std (bf16, int8 qkv, as shipped)."""
    from rdst_tpu_torch.kernels import swin_block

    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    blk = live16.model.layers[0].residual_group.blocks[0]
    kern = [_fast_block_at(blk, images, x_size, gen, live16.model.softmax,
                           frozenset({"qkv"}))
            for images, x_size in _tester_geometries(patients)]
    light = _tester_row("SwinIR-light", LIGHT_CONFIG, LIGHT_WEIGHTS,
                        data_dir, tmp, patients,
                        swin_block.fused_swin_block, 24,
                        TESTER_BARS["SwinIR-light"])
    std = _tester_row("SwinIR-std", SWINIR_CONFIG, SWINIR_WEIGHTS, data_dir,
                      tmp, patients, swin_block.run_fast_block, 36,
                      TESTER_BARS["SwinIR-std"])
    return {"kernels": kern, "rows": {"SwinIR-light": light,
                                      "SwinIR-std": std}}


@phase("W96 tester")
def w96_tester_phase(data_dir: str, tmp: str, patients: dict, live32,
                     live16) -> dict:
    """W96's f32 blocks (C = 96 and 192) and its RDSTB with int8 qkv at
    one whole patient's windows against their plain versions, then
    ``cli.test_main`` on the card for W96 in f32 (as shipped) and in bf16
    (mode rdstb, int8 qkv)."""
    from rdst_tpu_torch.kernels import rdstb_block, swin_block

    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    blocks = _rdst_blocks(live32.model)
    kern = {"f32": [], "rdstb": []}
    for images, x_size in _tester_geometries(patients):
        kern["f32"] += [_f32_block_at(blk, shift, images, x_size, gen)
                        for blk, shift in blocks[:2] + blocks[4:]]
        kern["rdstb"].append(_rdstb_at(live16.model.body[0], images, x_size,
                                       gen, live16.model.softmax,
                                       frozenset({"qkv"})))
    f32 = _tester_row("W96 f32", W96_CONFIG, W96_WEIGHTS, data_dir, tmp,
                      patients, swin_block.fused_swin_block, 48,
                      TESTER_BARS["W96 f32"])
    bf16 = _tester_row("W96 bf16", W96_CONFIG, W96_WEIGHTS, data_dir, tmp,
                       patients, rdstb_block.run_rdstb, 8,
                       TESTER_BARS["W96 bf16"], inference_dtype="bfloat16")
    # the config's int8 qkv costs 0.04 dB in the JAX kernels as here; the
    # same bf16 kernels without it hold the bf16-vs-f32 bar
    d = bf16["scores"]["psnr"] - f32["scores"]["psnr"]
    log(f"W96 bf16 (int8 qkv, as shipped) against f32: {d:+.4f} dB")
    plain16 = _tester_row("W96 bf16 without int8", W96_CONFIG, W96_WEIGHTS,
                          data_dir, tmp, patients, rdstb_block.run_rdstb, 8,
                          inference_dtype="bfloat16", pallas_quant="off")
    _versus_f32("W96 bf16 without int8", plain16, f32)
    return {"kernels": kern, "rows": {"W96 f32": f32, "W96 bf16": bf16,
                                      "W96 bf16 without int8": plain16}}


def run_w96(data_dir: str, tmp: str, patients: dict):
    """Phases 20-25, RDST-W96; returns (results, kernel rows)."""
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.kernels import rdstb_block
    from rdst_tpu_torch.serving.export import LiveModel

    def paras(**kw):
        p = ParametersLoader(W96_CONFIG)
        p.set("well_trained_single_scale_model_g", W96_WEIGHTS)
        for k, v in kw.items():
            p.set(k, v)
        return p

    t0 = time.perf_counter()
    live32 = LiveModel(paras(), max_batch=64, device="cuda")
    live16 = LiveModel(paras(inference_dtype="bfloat16"), max_batch=64,
                       device="cuda")
    m32, m16 = live32.manifest, live16.manifest
    log(f"loaded {W96_CONFIG} + {W96_WEIGHTS} in f32 (routes "
        f"{m32['routes']}) and bf16 (kernel mode {m16['pallas_kernels']}, "
        f"softmax {m16['pallas_softmax']}, int8 {m16['pallas_quant']}) in "
        f"{time.perf_counter() - t0:.3f} s")
    if (m32["dtype"], m32["routes"]) != ("float32", ["fused_swin_block"] * 8):
        raise AssertionError(f"W96 f32 manifest {m32}")
    if (m16["dtype"], m16["pallas_kernels"], m16["pallas_quant"],
            m16["routes"]) != ("bfloat16", "rdstb", ["qkv"],
                               ["fused_rdstb"] * 8):
        raise AssertionError(f"W96 bf16 manifest {m16}")
    gemm = token_gemm_phase()
    kern = w96_kernel_phase(live32.model, live16.model)
    whole = w96_model_phase(live32, live16)
    serve32 = w96_serving_phase(live32)
    serve16 = w96_bf16_serving_phase(live16, rdstb_block.run_rdstb, 8,
                                     "bfloat16", SERVE_TOL_BF16)
    prof32 = w96_profile_phase(live32)
    prof16 = w96_bf16_profile_phase(
        live16, tuple(k for k, _ in STAGE_PHASES), "rdstb stage kernels")
    kern_train = w96_train_kernel_phase(live16.model)
    tester = w96_tester_phase(data_dir, tmp, patients, live32, live16)
    del live32, live16
    train = w96_train_phase(data_dir, tmp)
    kernels = [
        _row("fused_swin_block (W96 f32, C = 96/144/192)", "swin_block.cu",
             "rdst_tpu/kernels/swin_block.py:757", serve32["launches"],
             kern["f32"]),
        _row("fused_rdstb (W96, int8 qkv)", "rdstb_block.cu",
             "rdst_tpu/kernels/rdstb_block.py:334", serve16["launches"],
             kern["rdstb"]),
        _row("fused_swin_pair (W96, C = 96/144/192, int8 qkv)",
             "swin_pair.cu", "rdst_tpu/kernels/swin_block.py:1001",
             whole["pair"]["launches_per_forward"],
             [r for r in kern["pair"] if r["int8"]]),
    ] + _train_rows("fused_swin_pair_train (W96, C = 96)", "pair_train.cu",
                    "rdst_tpu/kernels/pair_train.py:293", kern_train, train)
    results = {"manifest": {"f32": m32, "bf16": m16}, "gemm": gemm,
               "train": {"kernel": kern_train, "step": train},
               "kernel": kern,
               "model": whole, "serving": {"f32": serve32, "bf16": serve16},
               "profile": {"f32": prof32, "bf16": prof16},
               "tester": tester}
    return results, kernels


# ---------------------------------------------------------------------------
# MetaSR and the scale-free tail: arbitrary scales on one model
# ---------------------------------------------------------------------------

METASR_CONFIG = "config_files/metasr_20k_oasis20_x4.ini"
METASR_WEIGHTS = "weights/metasr_20k_best_oasis20_x4.msgpack"
METASR_SCALES = (1.5, 2.0, 3.0, 4.0)
METASR_STEPS = 20
# RDST-E1 with the MetaUpSampler tail: the shipped serving config with
# scale_free and these scales on the command line; its body takes the
# committed E1 weights, its tail a seeded init
SF_OVER = {"scale_free": True, "all_sr_scales": [1.5, 2.0, 2.5, 3.0, 3.5, 4.0],
           "test_sr_scales": [1.5, 4.0],
           "sr_scales_for_final_testing": [1.5, 4.0]}
SF_SCALES = (1.5, 4.0)
SF_ODD_HW = (37, 29)  # an LR that is not a window multiple: padded, cropped
SF_STEPS = 10


@phase("MetaSR tester")
def metasr_tester_phase(data_dir: str, tmp: str) -> dict:
    """``cli.test_main`` on the card with the committed MetaSR weights at
    1.5 / 2 / 3 / 4 over patients 19-20: each scale's mean PSNR / SSIM
    against the JAX tester's own number (``TESTER_BARS``, within
    TESTER_PSNR_TOL / TESTER_SSIM_TOL) beside its README figure; per
    patient and scale one warm whole-patient forward's wall and device
    time."""
    from rdst_tpu_torch.cli import test_main
    from rdst_tpu_torch.data.readers import make_test_dataset

    over = {"data_folder": data_dir, "verbose": False,
            "output_dir": os.path.join(tmp, "tester", "MetaSR"),
            "well_trained_model_metasr": METASR_WEIGHTS}
    argv = ["--config-file", METASR_CONFIG] + [f"{k}={v!r}"
                                               for k, v in over.items()]
    t0 = time.perf_counter()
    tester = test_main(argv)
    wall = time.perf_counter() - t0
    m = tester.manifest
    log(f"MetaSR tester: {tester.paras.model_name}, manifest scales "
        f"{m['scales']}, scale_free {m['scale_free']}, routes {m['routes']}, "
        f"device {m['device']}; run {wall:.3f} s")
    if (m["scales"], m["scale_free"], m["routes"], m["device"][:4]) != (
            list(METASR_SCALES), True, [], "cuda"):
        raise AssertionError(f"MetaSR manifest {m}")
    stacked = np.load(os.path.join(tester.output_root,
                                   "stacked_eva_reports.npy"),
                      allow_pickle=True).item()
    rows, off = {}, {}
    tols = {"psnr": TESTER_PSNR_TOL, "ssim": TESTER_SSIM_TOL}
    for s in METASR_SCALES:
        bar = TESTER_BARS[f"MetaSR x{s}"]
        scores = {k: float(np.mean(stacked[f"{k}_{s}"])) for k in tols}
        delta = {k: scores[k] - bar[k] for k in tols}
        rows[s] = {"scores": scores, "delta": delta,
                   "slices": len(stacked[f"psnr_{s}"])}
        log(f"MetaSR x{s}: psnr {scores['psnr']:.4f} ssim "
            f"{scores['ssim']:.4f} over {rows[s]['slices']} slices (JAX "
            f"tester {bar['psnr']} / {bar['ssim']}, README "
            f"{bar['readme']}; delta {delta['psnr']:+.4f} dB, SSIM "
            f"{delta['ssim']:+.5f})")
        off.update({f"{k}_{s}": d for k, d in delta.items()
                    if abs(d) > tols[k]})
    times = []
    for pid in tester.patient_ids:
        ds = make_test_dataset(tester.paras, [pid])
        pairs = [ds.get_test_pair(i) for i in range(ds.test_len())]
        for s in METASR_SCALES:
            lr = np.concatenate([p[s]["in"] for p in pairs])
            scale = tester.model_scale(s, pairs)
            fwd, dev = _device_ms(lambda: tester.forward(lr, scale))
            times.append({"pid": pid, "scale": s, "model_scale": scale,
                          "slices": len(pairs), "lr_hw": list(lr.shape[1:3]),
                          "forward_ms": fwd, "device_ms": dev})
            log(f"  {pid} x{s} (model at {scale}): {len(pairs)} slices of "
                f"{lr.shape[1:3]}, one forward {fwd:.3f} ms wall / "
                + (f"{dev:.3f} ms device" if dev else "device not measured"))
    if off:
        raise AssertionError(f"MetaSR tester: {off} past {tols}")
    return {"rows": rows, "forwards": times, "wall_s": wall, "manifest": m}


@phase("MetaSR training")
def metasr_train_phase(data_dir: str, tmp: str) -> dict:
    """``config_files/metasr_20k_oasis20_x4.ini`` as shipped (f32, batch
    32, EDSR 16 x 64, a scale a batch from ``all_sr_scales``) for
    METASR_STEPS steps with a quick evaluation every TRAIN_CHECK: every
    loss finite, the scales the batches drew, the snapshot served at 1.5
    by ``LiveModel``; then steps/s and one profiled step."""
    from rdst_tpu_torch.cli import build_trainer
    from rdst_tpu_torch.serving.export import LiveModel

    trainer = build_trainer(_train_argv(
        data_dir, os.path.join(tmp, "metasr_train"), METASR_STEPS,
        config=METASR_CONFIG))
    p = trainer.paras
    if (type(trainer.model).__name__, trainer.dtype, p.batch_size,
            trainer.device.type) != ("MetaSR", torch.float32, 32, "cuda"):
        raise AssertionError(f"MetaSR trainer: {type(trainer.model)} "
                             f"{trainer.dtype} batch {p.batch_size}")
    trainer.setup()
    drawn = []
    step = trainer.train_step

    def counted(batch, ts):
        drawn.append((float(batch["sr_factor"]),
                      float(batch["real_sr_scale"]),
                      tuple(batch["out"].shape[1:3])))
        return step(batch, ts)

    trainer.train_step = counted
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    trainer.train_step = step
    losses = trainer.training_loss_records.get("WarmUP", [])
    scales = sorted({d[0] for d in drawn})
    log(f"{METASR_STEPS} steps in {run_s:.3f} s (quick evaluations "
        f"included); loss {losses[0]:.5f} -> {losses[-1]:.5f}; scales drawn "
        f"{[d[0] for d in drawn]} (HR patches "
        f"{sorted({d[2] for d in drawn})})")
    if len(losses) != METASR_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"MetaSR losses {losses}")
    if len(drawn) != METASR_STEPS or len(scales) < 2 or not set(
            scales) <= set(p.all_sr_scales):
        raise AssertionError(f"MetaSR scales drawn {drawn}")
    snap = os.path.join(trainer.dirs["models"], "WarmUP_model_g.msgpack")
    sp = type(p)(METASR_CONFIG)
    sp.set("well_trained_model_metasr", snap)
    live = LiveModel(sp, max_batch=1, device="cuda")
    lr = trainer.ds_valid.get_test_pair(0)[4.0]["in"]
    y = live.predict(lr, 1.5)
    want = (int(lr.shape[1] * 1.5), int(lr.shape[2] * 1.5))
    log(f"the snapshot ({os.path.getsize(snap)} bytes) served at 1.5: "
        f"{lr.shape} -> {y.shape}")
    if y.shape[1:3] != want or not np.isfinite(y).all():
        raise AssertionError(f"served {y.shape}, expected {want}")
    prof = _step_profile(trainer, label="MetaSR training step")
    return {"losses": losses, "scales_drawn": drawn, "run_s": run_s,
            "profile": prof}


def _scale_free_snapshot(tmp: str) -> str:
    """RDST-E1 built scale-free, its body from the committed E1 weights,
    its ``tail_meta`` from a seeded init, written as a flax snapshot with
    the E1 stats sidecar beside it (its audited logit bound resolves the
    bf16 softmax, as for E1)."""
    import shutil

    from rdst_tpu_torch.checkpoint.convert import export_rdstsr
    from rdst_tpu_torch.checkpoint.msgpack_reader import read_snapshot
    from rdst_tpu_torch.checkpoint.msgpack_writer import write_snapshot
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.models import build_generator
    from rdst_tpu_torch.runners.trainer import init_weights

    p = ParametersLoader(CONFIG)
    for k, v in SF_OVER.items():
        p.set(k, v)
    model = build_generator(p)
    init_weights(model.tail_meta, torch.Generator().manual_seed(SEED + 30))
    body = export_rdstsr(read_snapshot(WEIGHTS), model.mean, model.std)
    sd = model.state_dict()
    kept = {k: torch.from_numpy(np.array(v)) for k, v in body.items()
            if k in sd}
    if set(sd) - set(kept) != {k for k in sd if k.startswith("tail_meta.")}:
        raise AssertionError("the scale-free E1 body does not take the "
                             "committed E1 weights")
    sd.update(kept)
    model.load_state_dict(sd)
    path = os.path.join(tmp, "rdst_e1_scale_free.msgpack")
    write_snapshot(path, model.state_dict())
    shutil.copy(os.path.splitext(WEIGHTS)[0] + ".stats.json",
                os.path.splitext(path)[0] + ".stats.json")
    return path


def _sf_paras(snap: str, **kw):
    from rdst_tpu_torch.config import ParametersLoader

    p = ParametersLoader(CONFIG)
    p.set("well_trained_single_scale_model_g", snap)
    for k, v in {**SF_OVER, **kw}.items():
        p.set(k, v)
    return p


def _serve_scales(live, scales, counter=None, per_forward: int = 0,
                  tol: float = SERVE_TOL) -> dict:
    """``live`` over HTTP: warmed at 40x32 for each scale, then an 8-slice
    ``POST /v1/predict?scale=s`` at each scale, at 40x32 and at SF_ODD_HW,
    against a direct predict (``tol``); ``counter``'s launches (set to 0
    just before the requests, read just after) are ``per_forward`` a
    forward; p50 latency of a 1-slice request at each scale."""
    from rdst_tpu_torch.serving.client import SRClient
    from rdst_tpu_torch.serving.server import InferenceServer

    srv = InferenceServer(live, "127.0.0.1", 0, max_batch=64,
                          batch_wait_ms=5.0)
    rng = np.random.default_rng(SEED + 31)
    xs = {hw: rng.random((8,) + hw, dtype=np.float32)
          for hw in (LR_HW, SF_ODD_HW)}
    out = {"requests": []}
    try:
        for s in scales:
            srv.warmup(lr_hw=LR_HW, scale=s)
        srv.start_background()
        client = SRClient(f"http://127.0.0.1:{srv.port}")
        if client.metadata()["scales"] != [float(s) for s in scales]:
            raise AssertionError(f"metadata {client.metadata()}")
        direct = {(hw, s): live.predict(x, s) for hw, x in xs.items()
                  for s in scales}
        if counter is not None:
            counter.launches = 0  # the served path starts here
        for (hw, s), want in direct.items():
            got = client.predict(xs[hw], s)
            err = float(np.abs(got - want).max())
            shape = (8, int(hw[0] * s), int(hw[1] * s), 1)
            log(f"POST /v1/predict?scale={s}: 8 x {hw} -> {got.shape}, max "
                f"abs err vs direct predict {err:.3e} (tol {tol})")
            if got.shape != shape or err > tol:
                raise AssertionError(f"served x{s} at {hw}: {got.shape} "
                                     f"{err}")
            out["requests"].append({"scale": s, "lr_hw": list(hw),
                                    "max_abs_err": err})
        if counter is not None:
            out["launches"] = counter.launches  # and ends here
            want = per_forward * len(direct)
            log(f"{counter.__name__} launches while serving: "
                f"{out['launches']} ({per_forward} a forward)")
            if out["launches"] != want:
                raise AssertionError(f"served launches {out['launches']}, "
                                     f"expected {want}")
        for s in scales:
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                client.predict(xs[LR_HW][:1], s)
                ts.append(time.perf_counter() - t0)
            out[f"p50_ms_x{s}"] = float(np.median(ts)) * 1e3
            log(f"1-slice request at x{s}: p50 {out[f'p50_ms_x{s}']:.2f} ms")
    finally:
        srv.close()
    return out


@phase("MetaSR serving")
def metasr_serving_phase() -> dict:
    """The committed MetaSR served by ``LiveModel`` over HTTP at its four
    scales (no kernel: EDSR's convolutions are cuDNN's, the upsampler's
    product plain PyTorch, as the JAX package leaves them to XLA); the
    device time of one 8-slice forward at each scale."""
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.serving.export import LiveModel

    p = ParametersLoader(METASR_CONFIG)
    p.set("well_trained_model_metasr", METASR_WEIGHTS)
    live = LiveModel(p, max_batch=64, device="cuda")
    out = _serve_scales(live, METASR_SCALES)
    x = np.random.default_rng(SEED + 32).random((8,) + LR_HW,
                                                dtype=np.float32)
    for s in METASR_SCALES:
        wall, dev = _device_ms(lambda: live.predict(x, s))
        out[f"forward8_x{s}"] = {"wall_ms": wall, "device_ms": dev}
        log(f"MetaSR 8 x {LR_HW} at x{s}: {wall:.3f} ms wall, device "
            + (f"{dev:.3f} ms" if dev else "not measured"))
    return out


@phase("scale-free E1 forwards")
def scale_free_forward_phase(tmp: str) -> dict:
    """RDST-E1 built scale-free (``_scale_free_snapshot``) served at 1.5
    and 4 on 8 seeded slices of 40x32 and of SF_ODD_HW: f32 as shipped
    (48 f32 block launches a forward) against the same model's plain path
    on the card (MODEL_TOL); bf16 mode rdstb (8 RDSTB launches a forward,
    counts set to 0 just before each forward and read just after) against
    the same model on the CPU (the kernels' plain versions, BF16_TOL),
    against its plain modules on the card (mode off) and against the f32
    kernel path (the bf16-vs-f32 bars); the kernels alone at the
    forward's geometry; HTTP serving at both scales; and one bucket-64
    forward's wall and device time at each scale beside the shipped E1's
    at x4."""
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.kernels import rdstb_block, swin_block, swin_pair
    from rdst_tpu_torch.models.routes import set_kernel_mode
    from rdst_tpu_torch.nn.swin import set_block_kernels
    from rdst_tpu_torch.serving.export import LiveModel

    snap = _scale_free_snapshot(tmp)
    live32 = LiveModel(_sf_paras(snap), max_batch=64, device="cuda")
    live16 = LiveModel(_sf_paras(snap, inference_dtype="bfloat16"),
                       max_batch=64, device="cuda")
    live_cpu = LiveModel(_sf_paras(snap, inference_dtype="bfloat16"),
                         max_batch=8, device="cpu")
    m32, m16 = live32.manifest, live16.manifest
    log(f"scale-free E1: f32 routes {m32['routes']}, bf16 mode "
        f"{m16['pallas_kernels']} softmax {m16['pallas_softmax']}, scales "
        f"{m32['scales']}")
    if (m32["routes"], m32["scale_free"], m32["scales"]) != (
            ["fused_swin_block"] * 8, True, list(SF_SCALES)) or (
            m16["pallas_kernels"], m16["pallas_softmax"]) != ("rdstb",
                                                              "clamp"):
        raise AssertionError(f"scale-free E1 manifests {m32} {m16}")
    softmax = live16.model.softmax
    f32, run = swin_block.fused_swin_block, rdstb_block.run_rdstb
    counters = (f32, run, swin_pair.run_swin_pair, swin_block.run_fast_block)
    rng = np.random.default_rng(SEED + 33)
    out = {"forwards": []}
    for hw in (LR_HW, SF_ODD_HW):
        x = rng.random((8,) + hw, dtype=np.float32)
        for s in SF_SCALES:
            shape = (8, int(hw[0] * s), int(hw[1] * s), 1)
            for c in counters:
                c.launches = 0  # the f32 forward starts here
            y32 = live32.predict(x, s)
            n32 = f32.launches  # and ends here
            set_block_kernels(live32.model, False)
            try:
                y_plain = live32.predict(x, s)
            finally:
                set_block_kernels(live32.model, True)
            err = float(np.abs(y32 - y_plain).max())
            for c in counters:
                c.launches = 0  # the bf16 forward starts here
            y16 = live16.predict(x, s)
            n16 = {c.__name__: c.launches for c in counters}  # and ends
            y_cpu = live_cpu.predict(x, s)
            set_kernel_mode(live16.model, "", softmax)
            try:
                y_off = live16.predict(x, s)
            finally:
                set_kernel_mode(live16.model, "rdstb", softmax)

            def rel(a, b):
                return _rel(torch.from_numpy(a), torch.from_numpy(b))[:2]

            kp, ko, kf = rel(y16, y_cpu), rel(y16, y_off), rel(y16, y32)
            row = {"lr_hw": list(hw), "scale": s, "f32_launches": n32,
                   "f32_vs_plain_max_abs_err": err, "bf16_launches": n16,
                   "bf16_vs_plain_versions_rel_max": kp[0],
                   "bf16_vs_plain_modules_rel": ko,
                   "bf16_vs_f32_rel": kf}
            out["forwards"].append(row)
            log(f"scale-free E1 8 x {hw} at x{s} -> {y32.shape}: f32 "
                f"{n32} launches, kernel vs plain {err:.3e} (tol "
                f"{MODEL_TOL}); bf16 {n16[run.__name__]} RDSTB launches, vs "
                f"the plain versions (CPU) rel max {kp[0]:.3e} (bar "
                f"{BF16_TOL}), vs the plain modules rel max {ko[0]:.3e} mean "
                f"{ko[1]:.3e}, vs f32 rel max {kf[0]:.3e} mean {kf[1]:.3e} "
                f"(bars {BF16_VS_F32_MAX}, {BF16_VS_F32_MEAN})")
            if y32.shape != shape or y16.shape != shape or not (
                    np.isfinite(y32).all() and np.isfinite(y16).all()):
                raise AssertionError(f"x{s} at {hw}: {y32.shape} "
                                     f"{y16.shape}, expected {shape}")
            if n32 != 48 or n16 != {c.__name__: (8 if c is run else 0)
                                    for c in counters}:
                raise AssertionError(f"x{s} at {hw}: launches {n32} {n16}")
            if err > MODEL_TOL or kp[0] > BF16_TOL or max(
                    ko[0], kf[0]) >= BF16_VS_F32_MAX or max(
                    ko[1], kf[1]) >= BF16_VS_F32_MEAN:
                raise AssertionError(f"x{s} at {hw}: {row}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 34)
    out["kernels"] = {  # at the forward's geometry: 8 slices of 40x32
        "f32": [_f32_block_at(blk, shift, 8, LR_HW, gen)
                for blk, shift in _rdst_blocks(live32.model)],
        "rdstb": [_rdstb_at(live16.model.body[0], 8, LR_HW, gen, softmax)]}
    del live_cpu
    out["serving"] = {"f32": _serve_scales(live32, SF_SCALES, f32, 48),
                      "bf16": _serve_scales(live16, SF_SCALES, run, 8,
                                            SERVE_TOL_BF16)}
    x64 = rng.random((64,) + LR_HW, dtype=np.float32)
    times = {}
    shipped = {}
    for dt in ("float32", "bfloat16"):  # the shipped E1: fixed x4
        p = ParametersLoader(CONFIG)
        p.set("well_trained_single_scale_model_g", WEIGHTS)
        p.set("inference_dtype", dt)
        shipped[dt] = LiveModel(p, max_batch=64, device="cuda")
    for dt, live in (("float32", live32), ("bfloat16", live16)):
        for s in SF_SCALES:
            times[f"{dt} x{s}"] = _device_ms(lambda: live.predict(x64, s))
        times[f"{dt} shipped x4"] = _device_ms(
            lambda: shipped[dt].predict(x64, SCALE))
    for k, (wall, dev) in times.items():
        log(f"bucket-64 forward, {k}: {wall:.3f} ms wall, device "
            + (f"{dev:.3f} ms" if dev else "not measured"))
    out["bucket64"] = {k: {"wall_ms": w, "device_ms": d}
                       for k, (w, d) in times.items()}
    return out


@phase("scale-free E1 training")
def scale_free_train_phase(data_dir: str, tmp: str) -> dict:
    """``config_files/rdst_e1_100k_oasis20_x4.ini`` (bf16) with SF_OVER:
    the train-pair kernels at the training geometry (24x24 LR at every
    scale) against their plain version and autograd, as phase 11; the
    first step on the kernel route against the plain bf16 route; then
    SF_STEPS steps, each batch at its own scale: 24 forward and 24
    backward train-pair launches a step (counts set to 0 just before the
    run, read just after), every loss finite; steps/s and one profiled
    step."""
    from rdst_tpu_torch.cli import build_trainer
    from rdst_tpu_torch.kernels import block_train as bt
    from rdst_tpu_torch.kernels import pair_train as pt

    def argv(out_dir, steps):
        return _train_argv(data_dir, os.path.join(tmp, out_dir), steps) + [
            f"{k}={v!r}" for k, v in SF_OVER.items()]

    probe = build_trainer(argv("sf_probe", 1))
    probe.setup()
    if not probe.model.scale_free or probe.model.train_routes != {
            "pair": 24, "block": 0}:
        raise AssertionError(f"scale-free train routes "
                             f"{probe.model.train_routes}")
    kern = {"variants": _train_pair_widths(
        probe.model, ((0, 60), (1, 90), (2, 120)), "scale-free E1")}
    batch = probe.ds_train.sample(np.random.default_rng(17))
    log(f"first batch: x{batch['sr_factor']} (real "
        f"{batch['real_sr_scale']}), LR {batch['in'].shape[1:3]} -> HR "
        f"{batch['out'].shape[1:3]}")
    out = {"kernel": kern, **_first_step_vs_plain(probe, batch)}
    del probe
    trainer = build_trainer(argv("sf_train", SF_STEPS))
    trainer.setup()
    drawn = []
    step = trainer.train_step

    def counted(b, ts):
        drawn.append(float(b["real_sr_scale"]))
        return step(b, ts)

    trainer.train_step = counted
    bt.launch_forward.launches = bt.launch_backward.launches = 0
    pt.launch_forward.launches = pt.launch_backward.launches = 0  # main path
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    fwd, bwd = pt.launch_forward.launches, pt.launch_backward.launches  # ends
    trainer.train_step = step
    out.update(forward_launches=fwd, backward_launches=bwd, scales=drawn)
    losses = trainer.training_loss_records.get("WarmUP", [])
    log(f"{SF_STEPS} steps in {out['run_s']:.3f} s (evaluations at 1.5 and "
        f"4 included): scales {drawn}, train-pair launches forward {fwd}, "
        f"backward {bwd}; loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    if fwd != 24 * SF_STEPS or bwd != 24 * SF_STEPS or \
            bt.launch_forward.launches or bt.launch_backward.launches:
        raise AssertionError(f"expected {24 * SF_STEPS} train-pair launches "
                             f"each way, got {fwd} / {bwd}")
    if len(losses) != SF_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses}")
    out["losses"] = losses
    out["profile"] = _step_profile(trainer,
                                   label="scale-free E1 training step")
    return out


def run_metasr(data_dir: str, tmp: str):
    """Phases 30-34, MetaSR and the scale-free tail; returns (results,
    kernel rows: the kernels the scale-free E1 path runs)."""
    tester = metasr_tester_phase(data_dir, tmp)
    serve = metasr_serving_phase()
    train = metasr_train_phase(data_dir, tmp)
    fwd = scale_free_forward_phase(tmp)
    sf_train = scale_free_train_phase(data_dir, tmp)
    kern = fwd["kernels"]
    kernels = [
        _row("fused_swin_block (scale-free E1 f32)", "swin_block.cu",
             "rdst_tpu/kernels/swin_block.py:757",
             fwd["serving"]["f32"]["launches"], kern["f32"]),
        _row("fused_rdstb (scale-free E1 bf16)", "rdstb_block.cu",
             "rdst_tpu/kernels/rdstb_block.py:334",
             fwd["serving"]["bf16"]["launches"], kern["rdstb"]),
    ] + _train_rows("fused_swin_pair_train (scale-free E1)", "pair_train.cu",
                    "rdst_tpu/kernels/pair_train.py:293", sf_train["kernel"],
                    sf_train)
    return {"tester": tester, "serving": serve, "train": train,
            "scale_free": {"forward": fwd, "train": sf_train}}, kernels


def _row(name, source, replaces, launches, rs):
    """One kernel of the JSON line: per launch, averaged over the variants
    the main path runs."""
    n = len(rs)
    return {"name": name, "route": "cuda",
            "source": f"rdst_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs) / n,
            "plain_ms": sum(r["plain_ms"] for r in rs) / n,
            "bound_ms": sum(r["bound_ms"] for r in rs) / n,
            "bound_by": ("operations" if sum(
                r["bound_by"] == "operations" for r in rs) * 2 >= n
                else "bytes"),
            "library_ms": None}


def _train_rows(name, source, replaces, kern_train, train):
    """The forward and backward rows of a train kernel at the main path's
    timed variant (max_abs_err: the output for the forward, the largest
    absolute error of any gradient for the backward; relative errors are
    logged)."""
    timed = [r for r in kern_train["variants"] if "ms" in r]
    parts = {
        "forward": ("ms", "plain_ms", "bound_ms", "bound_by",
                    train["forward_launches"], "out_abs_err"),
        "backward": ("bwd_ms", "plain_bwd_ms", "bwd_bound_ms",
                     "bwd_bound_by", train["backward_launches"],
                     "grad_abs_err"),
    }
    return [_row(f"{name} ({part})", source, replaces, launches,
                 [dict(max_abs_err=max(v[err] for v in kern_train["variants"]),
                       ms=r[ms], plain_ms=r[plain], bound_ms=r[bound],
                       bound_by=r[by]) for r in timed])
            for part, (ms, plain, bound, by, launches, err) in parts.items()]


# --------------------------------------------------------------------------
# Phase 35: the int8 groups (pallas_quant), at the end of each model's run

INT8_ALL = frozenset(("qkv", "mlp", "proj", "conv"))


def _groups(name: str) -> frozenset:
    return INT8_ALL if name == "all" else frozenset({name})


def _dynamic(name: str) -> bool:
    """Whether the groups ``name`` take a scale over a scale group."""
    return bool(_groups(name) & {"mlp", "proj", "conv"})


def _int8_block_bound(tokens: int, c: int, quant, nbytes: float,
                      n: int = 64):
    """Bound of a block's work with int8 groups ``quant``: the products of
    the int8 groups (qkv 6C^2, proj 2C^2, MLP 8C^2 ops a token) at the
    int8 peak, the rest and the attention (4NC) at the bf16 peak."""
    int8 = {"qkv": 6, "proj": 2, "mlp": 8}
    q = sum(v for g, v in int8.items() if g in quant)
    t_ops = tokens * (q * c * c / INT8_OPS
                      + ((16 - q) * c * c + 4 * n * c) / BF16_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return t_ops, t_bytes


# An int8 design against its plain version: relative mean error (the max
# is held to BF16_TOL as every bf16 kernel is), and the share of a
# control's departure from the plain version that the launch may carry.
# A control is the plain version computed another way (int8 off, one
# scale group for the whole call); a launch that computed it would carry
# all of its departure (share 1), so the bar is the midpoint: the launch
# lies nearer its plain version than the control along the line between
# them. A right launch carries some of it: where it rounds an int8 step
# apart from the plain version, the value it quantized lay between the
# two steps, so the move is along the quantization error that int8 off
# undoes, and such steps spread through the blocks after them.
INT8_MEAN_TOL = 1e-3
INT8_SHARE_TOL = 0.5


def _share(got, want, alt) -> float:
    """<got - want, alt - want> / |alt - want|^2 in float64: the part of
    ``alt``'s departure from ``want`` that ``got`` carries."""
    d = (alt.double() - want.double()).flatten()
    return float((got.double() - want.double()).flatten().dot(d)
                 / d.dot(d))


def _int8_gate(got, want, controls: dict, mean_tol: float):
    """(passes, stats) of ``got`` against ``want``: finite, relative max
    within BF16_TOL, relative mean within ``mean_tol``, and a share of
    each control's departure within INT8_SHARE_TOL."""
    rel_max, rel_mean, abs_max = _rel(got, want)
    shares = {k: _share(got, want, v) for k, v in controls.items()}
    ok = (bool(torch.isfinite(got.float()).all()) and rel_max <= BF16_TOL
          and rel_mean <= mean_tol
          and all(v <= INT8_SHARE_TOL for v in shares.values()))
    return ok, {"rel_max": rel_max, "rel_mean": rel_mean,
                "max_abs_err": abs_max, "shares": shares}


def _int8_held(label: str, got, want, controls: dict,
               mean_tol: float = INT8_MEAN_TOL) -> dict:
    """The gate on ``got`` against its plain version ``want``, which must
    pass; then, for each control (``controls``: {name: tensor}; one equal
    to ``want`` is dropped), the same gate with the control in the plain
    version's place, which must refuse ``got``: the proof, on this run's
    data, that the gate tells the int8 design from that control."""
    controls = {k: v for k, v in controls.items() if not torch.equal(v, want)}
    ok, out = _int8_gate(got, want, controls, mean_tol)
    if not ok:
        raise AssertionError(f"{label}: against its plain version {out}")
    out["mean_tol"] = mean_tol
    out["controls"] = {}
    for name, ctl in controls.items():
        refused, st = _int8_gate(got, ctl, {"the plain version": want},
                                 mean_tol)
        refused = not refused
        st["refused"] = refused
        out["controls"][name] = st
        if not refused:
            raise AssertionError(f"{label}: the gate does not tell the "
                                 f"launch from the control '{name}': {st}")
    return out


def _int8_note(out: dict) -> str:
    """The gate's numbers for a log line."""
    s = (f"rel max {out['rel_max']:.3e} mean {out['rel_mean']:.3e} (bars "
         f"{BF16_TOL}, {out['mean_tol']})")
    for name, st in out["controls"].items():
        s += (f"; control '{name}': share {out['shares'][name]:+.4f} (bar "
              f"{INT8_SHARE_TOL}); the launch against it rel max "
              f"{st['rel_max']:.3e} mean {st['rel_mean']:.3e} share "
              f"{st['shares']['the plain version']:+.4f}: refused")
    return s


def _int8_case(label: str, call, plain, controls: dict, counter,
               t_ops: float, t_bytes: float, profile_kernels: bool) -> dict:
    """One int8 kernel case: the launch against its plain version and its
    controls (``_int8_held``; ``controls``: {name: callable}), two
    launches bitwise equal, CUDA-event times of both, the bound, the
    kernels a call (the wrapper's count; where asked also torch.profiler's
    count, which must equal it)."""
    with torch.inference_mode():
        before = counter.kernels
        got = call()
        kpc = counter.kernels - before
        again = call()
        want = plain()
        ctl = {k: f() for k, f in controls.items()}
        torch.cuda.synchronize()
        held = _int8_held(label, got, want, ctl)
        if not torch.equal(got, again):
            raise AssertionError(f"{label}: two launches differ")
        ms = cuda_time_ms(call, warmup=2, iters=10)
        plain_ms = cuda_time_ms(plain, warmup=0, iters=1)
        prof = _kernels_per_call(call) if profile_kernels else None
    # a whole session must count what the wrapper counted; one that
    # lost events can only count fewer
    if prof and (prof["events"] or prof["whole"]) and (
            prof["events"] != kpc if prof["whole"]
            else prof["events"] > kpc):
        raise AssertionError(f"{label}: the profiler recorded {prof} a "
                             f"call, the wrapper counted {kpc}")
    bound_ms = max(t_ops, t_bytes)
    by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"{label}: {_int8_note(held)}, bitwise repeat, {kpc} kernels a call"
        + (f" (the profiler: {prof['events']:g} kernel events a call of "
           f"{prof['kernels']} kinds; {prof['pad']:.2f} of its pad, "
           f"{prof['sessions']} session(s)"
           + ("" if prof["whole"] else
              f"; no whole session in {PROFILE_TRIES}: held to at most "
              f"{kpc}") + ")"
           if prof else "")
        + f"; {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({by})")
    return dict(case=label, **held, bitwise_repeat=True,
                kernels_per_call=kpc, profiler=prof, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)


def _int8_blocks(blocks, groups, gen, images: int = 64) -> list:
    """The fast block with int8 groups at bucket 64 (``images`` 40x32
    slices, 20 windows each) on model blocks (unshifted, the path's shared
    bias)."""
    from rdst_tpu_torch.kernels import quant as q8
    from rdst_tpu_torch.kernels import swin_block

    ws, nw = 8, 20
    rows = []
    for blk in blocks:
        c, nh = blk.dim, blk.num_heads
        inputs = blk.fast_kernel_inputs(LR_HW, ws, 0)
        x = torch.randn(images * nw, ws * ws, c, device="cuda",
                        generator=gen).to(torch.bfloat16)
        for name in groups:
            quant = _groups(name)
            plan = swin_block.plan_fast_block(*inputs, num_heads=nh,
                                              quant=quant)
            if plan.route != "tokens":
                raise AssertionError(f"C={c} int8 {name}: {plan.route}")
            kw = dict(num_heads=nh, windows_per_image=nw, softmax="clamp")
            gw = q8.block_group_windows(images * nw, nw, 64, c, nh, 2 * c, 1,
                                        softmax="clamp")

            def call():
                return swin_block.run_fast_block(x, plan, **kw)

            def plain(int8=True, gw=gw):
                q = dict(qkv=plan.qkv, mlp=plan.mlp, proj=plan.proj) \
                    if int8 else {}
                return swin_block.swin_block_fast_reference(
                    x, plan.params, plan.bias, num_heads=nh,
                    softmax="clamp", group_windows=gw, **q)

            controls = {"int8 off": lambda: plain(False)}
            if _dynamic(name):
                controls["one scale group"] = lambda: plain(gw=len(x))
            nbytes = 2 * 2 * x.numel() + _nbytes(*plan.layout, plan.bias,
                                                 *plan.qkv_layout,
                                                 *plan.int8_layout)
            rows.append(dict(c=c, groups=name, **_int8_case(
                f"fast block C={c} int8 {name}", call, plain, controls,
                swin_block.run_fast_block,
                *_int8_block_bound(images * nw * 64, c, quant, nbytes),
                name == "all")))
    return rows


def _int8_pairs(layers, groups, gen, images: int = 64) -> list:
    """The pair with int8 groups at bucket 64 on model layers (block a
    unshifted, block b at shift 4)."""
    from rdst_tpu_torch.kernels import quant as q8
    from rdst_tpu_torch.kernels import swin_pair

    ws, nw = 8, 20
    rows = []
    for layer in layers:
        a, b = layer.blocks[0], layer.blocks[1]
        c, nh = a.dim, a.num_heads
        ia, ib = a.fast_kernel_inputs(LR_HW, ws, 0), \
            b.fast_kernel_inputs(LR_HW, ws, ws // 2)
        x = torch.randn(images * nw, ws * ws, c, device="cuda",
                        generator=gen).to(torch.bfloat16)
        kw = dict(num_heads=nh, x_size=LR_HW, window_size=ws, shift=ws // 2,
                  softmax="clamp")
        for name in groups:
            quant = _groups(name)
            pa = swin_pair.plan_pair_block(*ia, num_heads=nh, quant=quant)
            pb = swin_pair.plan_pair_block(*ib, num_heads=nh, quant=quant)
            gw = q8.pair_group_windows(images * nw, nw, 64, c, nh, 2 * c,
                                       softmax="clamp")

            def call():
                return swin_pair.run_swin_pair(x, pa, pb, **kw)

            def plain(int8=True, gw=gw):
                return swin_pair.swin_pair_reference(
                    x, pa.params, pa.bias, pb.params, pb.bias,
                    quant_a=pa.quant if int8 else None,
                    quant_b=pb.quant if int8 else None, group_windows=gw,
                    **kw)

            controls = {"int8 off": lambda: plain(False)}
            if _dynamic(name):
                controls["one scale group"] = lambda: plain(gw=len(x))
            nbytes = 2 * 2 * x.numel() + sum(
                _nbytes(*p.layout, p.bias, *p.qkv_layout, *p.int8_layout)
                for p in (pa, pb))
            t_ops, t_bytes = _int8_block_bound(images * nw * 64, c, quant,
                                               nbytes)
            rows.append(dict(c=c, groups=name, **_int8_case(
                f"pair C={c} int8 {name}", call, plain, controls,
                swin_pair.run_swin_pair, 2 * t_ops, t_bytes,
                name == "all")))
    return rows


def _int8_rdstbs(rdstb, groups, gen, images: int = 64) -> list:
    """The RDSTB with int8 groups at bucket 64 on a model RDSTB."""
    from rdst_tpu_torch.kernels import quant as q8
    from rdst_tpu_torch.kernels import rdstb_block

    ws, nh = 8, 6
    c0 = rdstb.body[0].body.blocks[0].dim
    inputs = rdstb.rdstb_inputs(LR_HW, ws, ws // 2)
    x = torch.randn(images, LR_HW[0] * LR_HW[1], c0, device="cuda",
                    generator=gen).to(torch.bfloat16)
    kw = dict(num_heads=nh, x_size=LR_HW, window_size=ws, shift=ws // 2,
              softmax="clamp")
    rows = []
    off = rdstb_block.plan_rdstb(
        *inputs, num_heads=nh, growth=rdstb.growth_rate,
        adapter_prenorm=rdstb.pre_norm, quant=frozenset())
    for name in groups:
        quant = _groups(name)
        plan = rdstb_block.plan_rdstb(
            *inputs, num_heads=nh, growth=rdstb.growth_rate,
            adapter_prenorm=rdstb.pre_norm, quant=quant)
        gi = q8.rdstb_group_images(
            images, 20, 64, c0, rdstb.growth_rate, len(plan.dstls), nh,
            plan.dstls[0].pa.w1.shape[1] / c0, softmax="clamp")

        def call():
            return rdstb_block.run_rdstb(x, plan, **kw)

        def plain(p=plan, gi=gi):
            return rdstb_block.rdstb_reference(
                x, p.dstls, p.wc, p.bc, growth=p.growth,
                adapter_prenorm=p.prenorm, conv=p.conv, group_images=gi,
                **kw)

        controls = {"int8 off": lambda: plain(off)}
        if _dynamic(name):
            controls["one scale group"] = lambda: plain(gi=images)

        tokens = images * LR_HW[0] * LR_HW[1]
        t_ops = sum(2 * _int8_block_bound(tokens, d.adapter.w.shape[0],
                                          quant, 0)[0] for d in plan.dstls)
        conv_ops = tokens * 2 * plan.wc.shape[0] * plan.wc.shape[1]
        t_ops += conv_ops / (INT8_OPS if plan.conv is not None
                             else BF16_FLOPS) * 1e3
        nbytes = 2 * 2 * x.numel() + _nbytes(*[
            t for t in plan.kernel_args if isinstance(t, torch.Tensor)])
        rows.append(dict(c0=c0, groups=name, **_int8_case(
            f"rdstb C0={c0} int8 {name}", call, plain, controls,
            rdstb_block.run_rdstb,
            t_ops, nbytes / HBM_BYTES_PER_S * 1e3, name == "all")))
    return rows


# A model unit (an RDSTB, an RSTB) chains six or more blocks with dynamic
# int8 steps: where the card and the plain version round one step apart,
# the blocks after it see other inputs and round others apart, so over a
# unit the two decorrelate in part, and a right unit's share of a
# control's departure grows toward 1, the share of a re-drawn rounding
# (measured to 0.47 on the card). What stays is the size: a unit with
# int8 departs from its int8-off version as far as its plain version
# does, whatever its rounding (a ratio of 1); one without int8 departs by
# its bf16 rounding alone, which over a unit's blocks reaches about half
# the int8 departure (0.47 on the card). So a unit is held to the ratio
# of those distances, at the midpoint between the two.
INT8_UNIT_RATIO = 0.75


def _ratio(got, want, alt) -> float:
    """|got - alt| / |want - alt| in float64."""
    return float((got.double() - alt.double()).norm()
                 / (want.double() - alt.double()).norm())


def _int8_units(label: str, live, live_cpu, x, mode: str, softmax: str,
                refuse: bool = False, images: int = 2) -> dict:
    """Each unit of the model's kernel routes (``route_units``: the
    RDSTBs, the RSTBs) in the card's forward of ``x``, held against the
    same unit on the CPU with 'all' (the plain int8 versions) on the
    card's own input to it, the first ``images`` images (a scale group
    holds images of one run of the batch, so theirs are the card's
    groups): finite, relative max within BF16_TOL and mean within
    BF16_VS_F32_MEAN (a bf16 model's bar), and as far from each control
    (the unit with int8 off, and with one scale group for the ``images``
    where that differs) as INT8_UNIT_RATIO of the plain version's
    distance from it. Every unit must pass, or with ``refuse`` (the
    card's model without int8) every unit must fail. The shares of
    ``_int8_held`` are logged."""
    from rdst_tpu_torch.kernels import quant as q8
    from rdst_tpu_torch.models.routes import set_kernel_mode

    seen = []

    def hook(mod, args, out):
        seen.append((args[0][:images].cpu(), args[1], out[:images].cpu()))

    handles = [m.register_forward_hook(hook)
               for _, m in live.model.route_units()]
    try:
        live.predict(x, SCALE)
    finally:
        for h in handles:
            h.remove()
    units = [m for _, m in live_cpu.model.route_units()]
    if len(seen) != len(units):
        raise AssertionError(f"{label}: {len(seen)} units ran of "
                             f"{len(units)}")
    what = "without int8" if refuse else "int8 all"
    rows = []
    with torch.inference_mode():
        for i, ((xin, size, got), unit) in enumerate(zip(seen, units)):
            ctl = {}
            set_kernel_mode(live_cpu.model, mode, softmax, frozenset())
            ctl["int8 off"] = unit(xin, size)
            set_kernel_mode(live_cpu.model, mode, softmax, INT8_ALL)
            want = unit(xin, size)
            os.environ[q8.ENV_IPP] = str(images)
            try:
                one = unit(xin, size)
            finally:
                del os.environ[q8.ENV_IPP]
            if not torch.equal(one, want):
                ctl["one scale group"] = one
            rel_max, rel_mean, _ = _rel(got, want)
            r = {"rel_max": rel_max, "rel_mean": rel_mean,
                 "ratios": {k: _ratio(got, want, v) for k, v in ctl.items()},
                 "shares": {k: _share(got, want, v) for k, v in ctl.items()}}
            r["passes"] = (bool(torch.isfinite(got.float()).all())
                           and rel_max <= BF16_TOL
                           and rel_mean <= BF16_VS_F32_MEAN
                           and min(r["ratios"].values()) >= INT8_UNIT_RATIO)
            rows.append(r)
            if r["passes"] == refuse:
                raise AssertionError(f"{label} {what} mode {mode} unit {i}: "
                                     f"{'passes' if refuse else 'fails'} "
                                     f"the unit gate: {r}")
    worst = {"rel_max": max(r["rel_max"] for r in rows),
             "rel_mean": max(r["rel_mean"] for r in rows),
             "ratio": min(min(r["ratios"].values()) for r in rows),
             "ratio_max": max(min(r["ratios"].values()) for r in rows),
             "share": max(max(r["shares"].values()) for r in rows)}
    log(f"{label} {what}, mode {mode}: every one of {len(units)} units "
        f"{'refused by' if refuse else 'within'} the unit gate on the "
        f"card's own input to it (rel max to {worst['rel_max']:.3e}, mean "
        f"to {worst['rel_mean']:.3e} (bars {BF16_TOL}, {BF16_VS_F32_MEAN}); "
        f"distance from a control over the plain version's "
        f"{worst['ratio']:.3f}-{worst['ratio_max']:.3f} (bar >= "
        f"{INT8_UNIT_RATIO}); share of a control's departure to "
        f"{worst['share']:+.3f}; controls {sorted(rows[0]['ratios'])})")
    return worst


def _int8_model(label: str, lives: dict, modes: dict, default: str) -> dict:
    """A shipped model in bf16 with ``pallas_quant='all'`` (``lives``: the
    card's, the CPU's, and the card's without int8) on 8 slices, in each
    kernel mode of ``modes`` ({mode: (counter, launches a forward)}): its
    launches (counts set to 0 just before, read just after), finite, and
    within BF16_VS_F32_MEAN of the card's bf16 model without int8; each
    unit on two slices against its plain version (``_int8_units``), and
    the same for the card's model without int8, which that gate must
    refuse in every unit; then one HTTP request of the 8 slices against
    a direct predict.

    The whole output is also set beside the same model on the CPU (the
    plain int8 versions, the first two slices, whose scale groups are
    the card's) and logged only: a dynamic int8 step that the two round
    apart moves its value by 1/127 of its group's amax, and such steps
    compound over the model's blocks until the two differ about as much
    as int8 differs from bf16, so the per-unit check carries the proof."""
    from rdst_tpu_torch.models.routes import set_kernel_mode
    from rdst_tpu_torch.serving.client import SRClient
    from rdst_tpu_torch.serving.server import InferenceServer

    live, live_cpu, live_bf16 = lives["all"], lives["cpu"], lives["bf16"]
    rng = np.random.default_rng(SEED + 35)
    x = rng.random((8,) + LR_HW + (1,), dtype=np.float32)
    softmax = live.model.softmax
    out = {"manifest": live.manifest}
    counters = {c for c, _ in modes.values()}

    def versus(y, ref):
        r = _rel(torch.from_numpy(y), torch.from_numpy(ref))
        return r[0], r[1], float(10 * np.log10(1.0 / np.mean((y - ref) ** 2)))

    for mode, (counter, per_forward) in modes.items():
        for lv in (live, live_cpu, live_bf16):
            set_kernel_mode(lv.model, mode, softmax,
                            frozenset() if lv is live_bf16 else INT8_ALL)
        y_cpu = live_cpu.predict(x[:2], SCALE)
        y16 = live_bf16.predict(x, SCALE)
        for c in counters:
            c.launches = 0  # this mode's path starts here
        y = live.predict(x, SCALE)
        launches = {c.__name__: c.launches for c in counters}  # and ends
        if launches[counter.__name__] != per_forward or sum(
                launches.values()) != per_forward:
            raise AssertionError(f"{label} int8 all mode {mode}: "
                                 f"launches {launches}")
        if not np.isfinite(y).all():
            raise AssertionError(f"{label} int8 all mode {mode}: "
                                 "non-finite output")
        kp, kb = versus(y[:2], y_cpu), versus(y, y16)
        log(f"{label} int8 all, mode {mode}: {per_forward} launches of "
            f"{counter.__name__} a forward; whole output vs the plain int8 "
            f"versions (the CPU run, logged) rel max {kp[0]:.3e} mean "
            f"{kp[1]:.3e}, PSNR {kp[2]:.2f} dB; vs bf16 without int8 rel "
            f"max {kb[0]:.3e} mean {kb[1]:.3e} (bar {BF16_VS_F32_MEAN}), "
            f"PSNR {kb[2]:.2f} dB")
        if kb[1] >= BF16_VS_F32_MEAN:
            raise AssertionError(f"{label} mode {mode} vs bf16: {kb}")
        units = _int8_units(label, live, live_cpu, x, mode, softmax)
        units_bf16 = _int8_units(label, live_bf16, live_cpu, x, mode,
                                 softmax, refuse=True)
        out[mode] = {"launches_per_forward": per_forward,
                     "vs_plain_rel_max": kp[0], "vs_plain_rel_mean": kp[1],
                     "vs_bf16_rel_max": kb[0], "vs_bf16_rel_mean": kb[1],
                     "psnr_vs_bf16_db": kb[2], "units": units,
                     "units_without_int8": units_bf16}
    set_kernel_mode(live.model, default, softmax, INT8_ALL)
    srv = InferenceServer(live, "127.0.0.1", 0, max_batch=8,
                          batch_wait_ms=5.0)
    try:
        srv.start_background()
        direct = live.predict(x[..., 0], SCALE)
        got = SRClient(f"http://127.0.0.1:{srv.port}").predict(x[..., 0],
                                                              SCALE)
    finally:
        srv.close()
    err = float(np.abs(got - direct).max())
    log(f"{label} int8 all over HTTP: 8-slice request vs direct predict max "
        f"abs err {err:.3e} (tol {SERVE_TOL_BF16})")
    if got.shape != direct.shape or err > SERVE_TOL_BF16:
        raise AssertionError(f"{label} int8 all HTTP: {err}")
    out["http_err"] = err
    return out


@phase("int8 groups")
def int8_phase(label: str, config: str, weights: str, kernels,
               modes: dict, default: str, tester) -> dict:
    """Phase 35 for one shipped model: the model built in bf16 with
    ``pallas_quant='all'`` (and on the CPU, and without int8); its int8
    kernel cases (``kernels(model, gen)``: a dict of rows) on its
    committed weights; the model checks (``_int8_model``); the tester
    row (``tester()``)."""
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.serving.export import LiveModel

    def paras(quant):
        p = ParametersLoader(config)
        p.set("well_trained_single_scale_model_g", weights)
        p.set("inference_dtype", "bfloat16")
        p.set("pallas_quant", quant)
        return p

    lives = {"all": LiveModel(paras("all"), max_batch=8, device="cuda"),
             "cpu": LiveModel(paras("all"), max_batch=8, device="cpu"),
             "bf16": LiveModel(paras("off"), max_batch=8, device="cuda")}
    m = lives["all"].manifest
    log(f"{label} with pallas_quant='all': kernel mode "
        f"{m['pallas_kernels']}, softmax {m['pallas_softmax']}, int8 "
        f"{m['pallas_quant']}, routes {m['routes']}")
    if m["pallas_quant"] != sorted(INT8_ALL) or m["pallas_kernels"] != default:
        raise AssertionError(f"{label} int8 all manifest {m}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 36)
    out = kernels(lives["all"].model, gen)
    out["model"] = _int8_model(label, lives, modes, default)
    del lives
    out["tester"] = tester()
    return out


def run_int8(data_dir: str, tmp: str, patients: dict):
    """Phase 35, the int8 groups, for E1, SwinIR-std and W96; returns
    (results, kernel rows: each int8 design at 'all')."""
    from rdst_tpu_torch.kernels import rdstb_block, swin_block, swin_pair

    groups = ("all", "qkv", "mlp", "proj")
    rdstb, pair = rdstb_block.run_rdstb, swin_pair.run_swin_pair
    fast = swin_block.run_fast_block

    def row(label, config, weights, counter, per_forward, shipped=None):
        """The tester row with 'all'; where the JAX tester's number for the
        shipped groups (``shipped``) lies more than twice the tolerance
        from its 'all' number, the card's row must also lie outside the
        tolerance from the shipped number."""
        def run():
            out = _tester_row(label, config, weights, data_dir, tmp,
                              patients, counter, per_forward,
                              TESTER_BARS[label], inference_dtype="bfloat16",
                              pallas_quant="all")
            if shipped is None:
                return out
            bar = TESTER_BARS[shipped]
            gap = TESTER_BARS[label]["psnr"] - bar["psnr"]
            got = out["scores"]["psnr"] - bar["psnr"]
            log(f"tester {label}: {got:+.4f} dB from the JAX tester's "
                f"'{shipped}' (the shipped groups; its 'all' is {gap:+.4f})")
            if abs(gap) > 2 * TESTER_PSNR_TOL and \
                    abs(got) <= TESTER_PSNR_TOL:
                raise AssertionError(f"tester {label} does not tell 'all' "
                                     f"from '{shipped}': {got:+.4f} dB")
            out["vs_shipped_db"] = got
            return out
        return run

    def e1_kernels(model, gen):
        r = model.body[0]
        return {"block": _int8_blocks([r.body[j].body.blocks[0]
                                       for j in (0, 2)], groups, gen),
                "pair": _int8_pairs([d.body for d in r.body], groups, gen),
                "rdstb": _int8_rdstbs(r, groups + ("conv",), gen)}

    def std_kernels(model, gen):
        blk = model.layers[0].residual_group.blocks[0]
        return {"block": _int8_blocks([blk], groups, gen)}

    def w96_kernels(model, gen):
        r = model.body[0]
        return {"pair": _int8_pairs([d.body for d in r.body], groups, gen),
                "rdstb": _int8_rdstbs(r, groups + ("conv",), gen)}

    e1 = int8_phase("E1", CONFIG, WEIGHTS, e1_kernels,
                    {"rdstb": (rdstb, 8), "pair": (pair, 24),
                     "swin": (fast, 48)}, "rdstb",
                    row("E1 bf16 int8 all", CONFIG, WEIGHTS, rdstb, 8,
                        "E1 bf16"))
    std = int8_phase("SwinIR-std", SWINIR_CONFIG, SWINIR_WEIGHTS,
                     std_kernels, {"swin": (fast, 36)}, "swin",
                     row("SwinIR-std int8 all", SWINIR_CONFIG,
                         SWINIR_WEIGHTS, fast, 36))
    w96 = int8_phase("W96", W96_CONFIG, W96_WEIGHTS, w96_kernels,
                     {"rdstb": (rdstb, 8), "pair": (pair, 24)}, "rdstb",
                     row("W96 bf16 int8 all", W96_CONFIG, W96_WEIGHTS,
                         rdstb, 8, "W96 bf16"))
    src = "rdst_tpu/kernels/"
    kernels = [
        _int8_rows("fused_swin_block_fast (E1, C = 60 / 120, int8 all)",
                   "swin_block_fast.cu", src + "swin_block.py:757",
                   e1["model"]["swin"]["launches_per_forward"], e1["block"]),
        _int8_rows("fused_swin_block_fast (SwinIR-std, C = 180, int8 all)",
                   "swin_block_fast.cu", src + "swin_block.py:757",
                   std["tester"]["launches"], std["block"]),
        _int8_rows("fused_swin_pair (E1, int8 all)", "swin_pair.cu",
                   src + "swin_block.py:1001",
                   e1["model"]["pair"]["launches_per_forward"], e1["pair"]),
        _int8_rows("fused_swin_pair (W96, int8 all)", "swin_pair.cu",
                   src + "swin_block.py:1001",
                   w96["model"]["pair"]["launches_per_forward"], w96["pair"]),
        _int8_rows("fused_rdstb (E1, int8 all)", "rdstb_block.cu",
                   src + "rdstb_block.py:334", e1["tester"]["launches"],
                   e1["rdstb"]),
        _int8_rows("fused_rdstb (W96, int8 all)", "rdstb_block.cu",
                   src + "rdstb_block.py:334", w96["tester"]["launches"],
                   w96["rdstb"]),
    ]
    return {"E1": e1, "SwinIR-std": std, "W96": w96}, kernels


def _int8_rows(name: str, source: str, replaces: str, launches: int,
               rows: list) -> dict:
    """A kernel row of the JSON line for an int8 design: the 'all' cases
    (the main path's groups)."""
    return _row(name, source, replaces, launches,
                [r for r in rows if r["groups"] == "all"])


def run_e1(data_dir: str, tmp: str, patients: dict):
    """Phases 3-13, RDST-E1; returns (results, kernel rows)."""
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.kernels import rdstb_block
    from rdst_tpu_torch.serving.export import LiveModel

    paras = ParametersLoader(CONFIG)
    paras.set("well_trained_single_scale_model_g", WEIGHTS)
    t0 = time.perf_counter()
    live = LiveModel(paras, max_batch=64, device="cuda")
    log(f"loaded {CONFIG} + {WEIGHTS} on {live.device} in "
        f"{time.perf_counter() - t0:.3f} s (kernel mode "
        f"{live.manifest['pallas_kernels']}, softmax "
        f"{live.manifest['pallas_softmax']})")
    kern = kernel_phase(live.model)
    kern["wide"] = wide_kernel_phase()["variants"]
    whole = model_phase(live)
    serve = serving_phase(live)
    prof = profile_phase(live)

    paras16 = ParametersLoader(CONFIG)
    paras16.set("well_trained_single_scale_model_g", WEIGHTS)
    paras16.set("inference_dtype", "bfloat16")
    t0 = time.perf_counter()
    live16 = LiveModel(paras16, max_batch=64, device="cuda")
    log(f"loaded the bf16 model in {time.perf_counter() - t0:.3f} s (kernel "
        f"mode {live16.manifest['pallas_kernels']}, softmax "
        f"{live16.manifest['pallas_softmax']}, routes "
        f"{live16.manifest['routes']})")
    if (live16.manifest["pallas_kernels"], live16.manifest["pallas_softmax"],
            live16.manifest["dtype"]) != ("rdstb", "clamp", "bfloat16"):
        raise AssertionError(f"bf16 manifest {live16.manifest}")
    kern16 = bf16_kernel_phase(live16.model)
    live_cpu = LiveModel(paras16, max_batch=8, device="cpu")
    whole16 = bf16_model_phase(live16, live, live_cpu)
    serve16 = bf16_serving_phase(live16, rdstb_block.run_rdstb, 8,
                                 "bfloat16", SERVE_TOL_BF16)
    prof16 = bf16_profile_phase(live16, ("rdstb_stage_kernel",
                                         "rdstb_conv_kernel"),
                                "rdstb stage kernels")
    kern_train = train_kernel_phase(live16.model)
    train = train_phase(data_dir, tmp)
    prof_train = train_profile_phase(train.pop("trainer"))
    finetune = {"seg": seg_finetune_phase(data_dir, tmp),
                "gan": gan_finetune_phase(data_dir, tmp),
                "bf16": finetune_bf16_phase(data_dir, tmp)}
    tester = e1_tester_phase(data_dir, tmp, patients, live, live16)

    main_softmax = live16.model.softmax
    kernels = [
        # averaged over the six (C, shift) variants that each run 8 times
        # in one forward: the main path's own mix at bucket 64
        _row("fused_swin_block", "swin_block.cu",
             "rdst_tpu/kernels/swin_block.py:757", serve["launches"],
             kern["variants"]),
        _row("fused_swin_block_fast", "swin_block_fast.cu",
             "rdst_tpu/kernels/swin_block.py:757",
             whole16["swin"]["launches_per_forward"],
             [r for r in kern16["block"] if r["softmax"] == main_softmax]),
        _row("fused_swin_pair", "swin_pair.cu",
             "rdst_tpu/kernels/swin_block.py:1001",
             whole16["pair"]["launches_per_forward"], kern16["pair"]),
        _row("fused_rdstb", "rdstb_block.cu",
             "rdst_tpu/kernels/rdstb_block.py:334", serve16["launches"],
             kern16["rdstb"]),
    ] + _train_rows("fused_swin_pair_train", "pair_train.cu",
                    "rdst_tpu/kernels/pair_train.py:293", kern_train, train)
    results = {"kernel": kern, "model": whole, "serving": serve,
               "profile": prof,
               "bf16": {"manifest": live16.manifest, "kernel": kern16,
                        "model": whole16, "serving": serve16,
                        "profile": prof16},
               "train": {"kernel": kern_train, "step": train,
                         "profile": prof_train},
               "finetune": finetune,
               "tester": tester}
    return results, kernels


def run_swinir(data_dir: str, tmp: str, patients: dict):
    """Phases 14-19, SwinIR-std; returns (results, kernel rows)."""
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.kernels import swin_block
    from rdst_tpu_torch.serving.export import LiveModel

    def paras(**kw):
        p = ParametersLoader(SWINIR_CONFIG)
        p.set("well_trained_single_scale_model_g", SWINIR_WEIGHTS)
        for k, v in kw.items():
            p.set(k, v)
        return p

    t0 = time.perf_counter()
    live16 = LiveModel(paras(), max_batch=64, device="cuda")
    m = live16.manifest
    log(f"loaded {SWINIR_CONFIG} + {SWINIR_WEIGHTS} in "
        f"{time.perf_counter() - t0:.3f} s ({m['dtype']}, kernel mode "
        f"{m['pallas_kernels']}, softmax {m['pallas_softmax']}, int8 "
        f"{m['pallas_quant']}, routes {m['routes']})")
    if (m["dtype"], m["pallas_kernels"], m["pallas_softmax"],
            m["pallas_quant"]) != ("bfloat16", "swin", "clamp", ["qkv"]):
        raise AssertionError(f"SwinIR-std manifest {m}")
    shifts = {b.resolved_window(LR_HW)[1] for layer in live16.model.layers
              for b in layer.residual_group.blocks}
    log(f"block shifts at the build resolution: {sorted(shifts)}")
    if shifts != {0}:
        raise AssertionError("SwinIR-std blocks are built shifted")
    kern = swinir_kernel_phase(live16.model)
    live32 = LiveModel(paras(inference_dtype="float32",
                             pallas_kernels="off"), max_batch=8,
                       device="cuda")
    live_cpu = LiveModel(paras(), max_batch=8, device="cpu")
    whole = swinir_model_phase(live16, live32, live_cpu)
    del live32, live_cpu
    serve = swinir_serving_phase(live16, swin_block.run_fast_block, 36,
                                 "bfloat16", SERVE_TOL_BF16)
    prof = swinir_profile_phase(live16, tuple(k for k, _ in FAST_PHASES),
                                "fast block kernels")
    kern_train = block_train_kernel_phase(live16.model)
    tester = swinir_tester_phase(data_dir, tmp, patients, live16)
    del live16
    train = swinir_train_phase(data_dir, tmp)
    prof_train = train_profile_phase(train.pop("trainer"))
    kernels = [
        _row("fused_swin_block_fast (SwinIR-std, C = 180, int8 qkv)",
             "swin_block_fast.cu", "rdst_tpu/kernels/swin_block.py:757",
             serve["launches"],
             [r for r in kern["variants"] if r["softmax"] == "clamp"]),
    ] + _train_rows("fused_swin_block_train", "block_train.cu",
                    "rdst_tpu/kernels/block_train.py:307", kern_train, train)
    results = {"kernel": kern, "model": whole, "serving": serve,
               "profile": prof,
               "train": {"kernel": kern_train, "step": train,
                         "profile": prof_train},
               "tester": tester}
    return results, kernels


# --------------------------------------------------------------------------
# Phase 26's cross-dataset rows, phase 36 (Dice) and phase 37 (the
# auxiliary trainers): ``--only xdata``, after the other models

# dataset: (config, committed 10k snapshot, maker, id format); each is an
# 8-phantom corpus (train 1-6, valid 7, test 8) at the generator's sizes,
# of which only the testing patient is written
XDATA = {
    "BraTS": ("config_files/rdst_e1_10k_brats8_x4.ini",
              "weights/rdst_e1_10k_brats8_best_x4.msgpack",
              "make_brats_example", "HGG_Brats17_SYN_{:03d}_1"),
    "ACDC": ("config_files/rdst_e1_10k_acdc8_x4.ini",
             "weights/rdst_e1_10k_acdc8_best_x4.msgpack",
             "make_acdc_example", "patient{:03d}"),
    "COVID": ("config_files/rdst_e1_10k_covid8_x4.ini",
              "weights/rdst_e1_10k_covid8_best_x4.msgpack",
              "make_covid_example", "volume-covid19-A-{:04d}"),
}
# Dice: the rows with a Dice entry in README:81-89, each held to the JAX
# ``seg_eval``'s own mean per class over patients 19-20
# (``tools/jax_tester_bars.py --dice``: the JAX tester, then
# ``rdst_tpu.runners.seg_eval`` with the committed four-class
# ``weights/unet_tiny.pkl``, on the CPU; SwinIR-std's SR with the JAX
# kernels in interpret mode) and printed beside its README figure: the
# README's c0/c1/c2 are this UNet's classes 0-2 (equal to every printed
# digit); class 3 is in neither the GT's labels nor the SR's, a Dice of 1
UNET_DICE = "weights/unet_tiny.pkl"
DICE_TOL = 0.005
DICE_BARS = {
    "bicubic": {"readme": (0.967, 0.923, 0.938),
                "dice": (0.9671, 0.9226, 0.9379, 1.0)},
    "E1 f32": {"readme": (0.957, 0.901, 0.923),
               "dice": (0.9570, 0.9009, 0.9229, 1.0)},
    "HRL fine-tune": {"readme": (0.957, 0.901, 0.923),
                      "dice": (0.9568, 0.9011, 0.9231, 1.0)},
    "SwinIR-light": {"readme": (0.957, 0.915, 0.937),
                     "dice": (0.9574, 0.9150, 0.9368, 1.0)},
    "SwinIR-std": {"readme": (0.948, 0.886, 0.914),
                   "dice": (0.9482, 0.8862, 0.9143, 1.0)},
    "W96 f32": {"readme": (0.962, 0.898, 0.917),
                "dice": (0.9622, 0.8982, 0.9167, 1.0)},
}
# the UNet's logits on the card against the CPU's (relative to the
# largest logit)
UNET_LOGIT_RTOL = 1e-4
# the auxiliary trainers (phase 37): steps, and the card's first steps
# against the CPU's from the same variables and batches
AUX_STEPS, AUX_CHECK_STEPS = 25, 3
AUX_F32_RTOL = 1e-3
AUX_F64_RTOL = 1e-6
# the phase-13 training run under a small stall_warn_s
WATCHDOG_WARN_S = 2.0


def _make_xdata_corpus(name: str, tmp: str) -> str:
    """``name``'s corpus as the port's generator makes it from seed 0, its
    testing patient only (its own seed: ``only``)."""
    from rdst_tpu_torch.data import synthetic

    _, _, maker, fmt = XDATA[name]
    data_dir = os.path.join(tmp, name, "example8")
    t0 = time.perf_counter()
    getattr(synthetic, maker)(
        data_dir, patient_ids=tuple(fmt.format(i) for i in range(1, 9)),
        only=(fmt.format(8),))
    log(f"generated the {name} testing patient in "
        f"{time.perf_counter() - t0:.3f} s")
    return data_dir


def _xdata_kernels(config: str, weights: str, patients: dict,
                   gen) -> dict:
    """The f32 block (both shifts of the first DSTL) and the bf16 RDSTB at
    one whole patient of ``config``'s geometry against their plain
    versions, with the config's committed weights."""
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.serving.export import build_serving_model

    (images,) = _images(patients)
    h, w = _lr_hw(patients)
    x_size = (-(-h // 8) * 8, -(-w // 8) * 8)
    model32 = _build_f32(config, weights)
    f32 = [_f32_block_at(blk, shift, images, x_size, gen)
           for blk, shift in _rdst_blocks(model32)[:2]]
    del model32
    p = ParametersLoader(config)
    p.set("well_trained_single_scale_model_g", weights)
    p.set("inference_dtype", "bfloat16")
    model16, meta = build_serving_model(p, device="cuda")
    if meta["routes"] != ["fused_rdstb"] * 8:
        raise AssertionError(f"{config} bf16 routes {meta['routes']}")
    rdstb = [_rdstb_at(model16.body[0], images, x_size, gen,
                       model16.softmax)]
    return {"f32": f32, "rdstb": rdstb}


@phase("cross-dataset tester")
def xdata_tester_phase(tmp: str) -> dict:
    """Phase 26's cross-dataset rows: the f32 block and the RDSTB at
    COVID's whole-patient geometry against their plain versions, then
    ``cli.test_main`` on the card for BraTS (a row a modality), ACDC and
    COVID in f32 as shipped against the JAX tester's own numbers, and
    COVID in bf16 (mode rdstb) against its f32 row."""
    from rdst_tpu_torch.kernels import rdstb_block, swin_block

    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    f32, run = swin_block.fused_swin_block, rdstb_block.run_rdstb
    rows, kern = {}, {}
    for name, (config, weights, _, _) in XDATA.items():
        data_dir = _make_xdata_corpus(name, tmp)
        patients = _tester_patients(data_dir, config)
        log(f"{name} testing patients: "
            f"{dict(zip(patients, _images(patients)))} slices of LR "
            f"{tuple(_lr_hw(patients))}")
        if name == "COVID":
            kern = _xdata_kernels(config, weights, patients, gen)
        rows[name] = _tester_row(name, config, weights, data_dir, tmp,
                                 patients, f32, 48, TESTER_BARS[name])
        if name == "COVID":
            rows["COVID bf16"] = _tester_row(
                "COVID bf16", config, weights, data_dir, tmp, patients, run,
                8, inference_dtype="bfloat16")
            _versus_f32("COVID bf16", rows["COVID bf16"], rows["COVID"])
    return {"kernels": kern, "rows": rows}


# Dice rows: label -> (config, weights, counter name, launches a forward,
# overrides); their tester runs are phase 26's where those ran
DICE_ROWS = {
    "bicubic": (CONFIG, None, None, 0, {"feature_generator": "bicubic"}),
    "E1 f32": (CONFIG, WEIGHTS, "fused_swin_block", 48, {}),
    "HRL fine-tune": (HRL_CONFIG, HRL_WEIGHTS, "fused_swin_block", 48, {}),
    "SwinIR-light": (LIGHT_CONFIG, LIGHT_WEIGHTS, "fused_swin_block", 24,
                     {}),
    "SwinIR-std": (SWINIR_CONFIG, SWINIR_WEIGHTS, "run_fast_block", 36, {}),
    "W96 f32": (W96_CONFIG, W96_WEIGHTS, "fused_swin_block", 48, {}),
}


def _row_paras(label: str, data_dir: str, tmp: str):
    """The paras of a tester row's run (its own output tree), as
    ``_tester_row`` ran it."""
    from rdst_tpu_torch.config import ParametersLoader

    config, weights, _, _, over = DICE_ROWS[label]
    p = ParametersLoader(config)
    for k, v in {"data_folder": data_dir, "verbose": False,
                 "output_dir": os.path.join(tmp, "tester",
                                            label.replace(" ", "_")),
                 **over}.items():
        p.set(k, v)
    return p


def _unet_card_vs_cpu(sr_vol: np.ndarray) -> dict:
    """The committed UNet's logits and labels of one SR volume on the card
    against the CPU's: logits within UNET_LOGIT_RTOL of the largest; a
    label may differ only where the CPU's two largest logits lie within
    twice the largest logit difference of each other (a tie the card
    breaks the other way), and those pixels are counted."""
    import pickle

    from rdst_tpu_torch.runners.seg_eval import load_unet, unet_logits

    with open(UNET_DICE, "rb") as f:
        variables = pickle.load(f)
    card = unet_logits(load_unet(variables, 1, "cuda"), sr_vol).cpu()
    cpu = unet_logits(load_unet(variables, 1, "cpu"), sr_vol)
    diff = (card - cpu).abs().max().item()
    scale = cpu.abs().max().item()
    top2 = cpu.topk(2, dim=1).values
    flips = card.argmax(1) != cpu.argmax(1)
    near = (top2[:, 0] - top2[:, 1]) <= 2 * diff
    out = {"max_abs_diff": diff, "rel": diff / scale,
           "pixels": int(flips.numel()), "flips": int(flips.sum()),
           "flips_not_ties": int((flips & ~near).sum())}
    log(f"UNet on the card vs the CPU over {sr_vol.shape[0]} slices: "
        f"logits max abs diff {diff:.3e} ({out['rel']:.3e} of the largest, "
        f"bar {UNET_LOGIT_RTOL}); labels differ at {out['flips']} of "
        f"{out['pixels']} pixels, {out['flips_not_ties']} of them not "
        "near-ties")
    if out["rel"] > UNET_LOGIT_RTOL or out["flips_not_ties"]:
        raise AssertionError(f"UNet card vs CPU: {out}")
    return out


@phase("Dice of the tester's SR volumes")
def dice_phase(data_dir: str, tmp: str, patients: dict) -> dict:
    """``runners.seg_eval`` on the card over the SR volumes of phase 26's
    oasis20 rows (run here where phase 26's did not run), each class's
    mean Dice within DICE_TOL of the JAX ``seg_eval``'s; the UNet on the
    card against the CPU on one patient."""
    from rdst_tpu_torch.kernels import swin_block
    from rdst_tpu_torch.runners.seg_eval import seg_eval
    from rdst_tpu_torch.utils.figures import _load_sr_volume

    rows = {}
    for label, (config, weights, counter, per_fwd, over) in \
            DICE_ROWS.items():
        p = _row_paras(label, data_dir, tmp)
        pid = next(iter(patients))
        try:
            _load_sr_volume(p, pid, SCALE)
        except FileNotFoundError:
            _tester_row(label, config, weights, data_dir, tmp, patients,
                        getattr(swin_block, counter) if counter else None,
                        per_fwd, TESTER_BARS[label], **over)
        t0 = time.perf_counter()
        dice, table = seg_eval(p, UNET_DICE, verbose=False, device="cuda")
        seconds = time.perf_counter() - t0
        mean = [float(d) for d in dice.mean(axis=0)]
        bar = DICE_BARS[label]
        delta = [m - b for m, b in zip(mean, bar["dice"])]
        rows[label] = {"dice": mean, "per_patient": dice.tolist(),
                       "delta": delta, "seconds": seconds}
        log(f"Dice {label}: classes {' / '.join(f'{d:.4f}' for d in mean)} "
            f"(JAX seg_eval {' / '.join(f'{d:.4f}' for d in bar['dice'])}, "
            f"bar {DICE_TOL}; README c0/c1/c2 {bar['readme']}) in "
            f"{seconds:.3f} s")
        log(table)
        if max(abs(d) for d in delta) > DICE_TOL:
            raise AssertionError(f"Dice {label}: {mean} against "
                                 f"{bar['dice']}")
    sr = _load_sr_volume(_row_paras("E1 f32", data_dir, tmp),
                         next(iter(patients)), SCALE)
    return {"rows": rows, "unet_card_vs_cpu": _unet_card_vs_cpu(sr)}


def _aux_profile(step, label: str) -> dict:
    """Steps/s over WALL_STEPS warm steps on the wall clock, and one
    profiled step's wall and device time and idle share."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WALL_STEPS):
        step()
    torch.cuda.synchronize()
    steps_per_s = WALL_STEPS / (time.perf_counter() - t0)
    wall_us, _, device = _profiled(step)
    busy = sum(float(e.self_device_time_total or 0.0) for e in device)
    out = {"steps_per_s": steps_per_s, "wall_us": wall_us,
           "device_us": busy,
           "kernel_launches": sum(e.count for e in device
                                  if "memset" not in e.key.lower()
                                  and "memcpy" not in e.key.lower())}
    if busy:
        out["idle_share"] = 1.0 - busy / wall_us
    log(f"{label}: {steps_per_s:.3f} steps/s over {WALL_STEPS} warm steps; "
        f"one profiled step {wall_us / 1e3:.3f} ms wall, "
        + (f"{busy / 1e3:.3f} ms device, idle share {out['idle_share']:.3f}"
           if busy else "device time not measured")
        + f", {out['kernel_launches']} kernel launches")
    return out


def _first_steps(make, batches, steps: int, dtype=torch.float32):
    """The losses of ``steps`` updates of a fresh trainer (``make(device)``)
    on the card and on the CPU over the same batches, in ``dtype``."""
    from rdst_tpu_torch.utils.optim import adam

    losses, params = {}, {}
    for dev in ("cuda", "cpu"):
        t = make(dev)
        if dtype != torch.float32:
            t.model.to(dtype)
            t.params = list(t.model.parameters())
            t.opt = adam(t.params, t.opt.schedule(0))
        if t.params[0].device.type != dev:
            raise AssertionError(f"trainer for {dev} on {t.params[0].device}")
        losses[dev] = []
        for batch in batches[:steps]:
            loss = t.step(*batch)  # the seg UNet's: (loss, accuracy)
            losses[dev].append(
                (loss[0] if isinstance(loss, tuple) else loss).item())
        params[dev] = [p.detach().cpu() for p in t.params]
    diff = max((a - b).abs().max().item()
               for a, b in zip(params["cuda"], params["cpu"]))
    log(f"after {steps} {dtype} steps the card's parameters differ from "
        f"the CPU's by at most {diff:.3e}")
    return losses


def _held(label: str, losses: dict, rtol: float) -> float:
    err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    log(f"{label}: card {losses['cuda']} vs CPU {losses['cpu']}: relative "
        f"{err:.3e} (bar {rtol})")
    if err > rtol:
        raise AssertionError(f"{label}: {err} > {rtol}")
    return err


@phase("auxiliary trainers")
def aux_trainers_phase(data_dir: str, tmp: str) -> dict:
    """``train_seg_unet`` (batch 8 of HR 96x96, its defaults) and
    ``train_vgg_features`` (width 0.25, batch 16 of 64x64) on the card for
    AUX_STEPS steps each: the first AUX_CHECK_STEPS on the card against
    the CPU from the same initial variables and batches, the loss
    falling, the pickle reloading into seg_eval, the UNet-F term and
    VGGLoss; steps/s and one profiled step; then the phase-13 training
    run under a small ``stall_warn_s``."""
    import pickle

    from rdst_tpu_torch.cli import train_main
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.losses.seg_unet import SegUNetLoss
    from rdst_tpu_torch.losses.vgg import VGGLoss
    from rdst_tpu_torch.runners.seg_eval import seg_eval
    from rdst_tpu_torch.runners.train_seg_unet import SegUNetTrainer
    from rdst_tpu_torch.runners.train_vgg_features import VGGFeatureTrainer

    def paras(**kw):
        p = ParametersLoader(CONFIG)
        for k, v in {"data_folder": data_dir, "verbose": False,
                     "output_dir": os.path.join(tmp, "aux"), **kw}.items():
            p.set(k, v)
        return p

    out = {}
    # -- the seg UNet: init and batches from the trainer's own seed
    seg0 = SegUNetTrainer(paras(), device="cpu")
    init = seg0.variables()
    rng = np.random.default_rng(0)
    seg_batches = [(seg0.ds.sample(rng),) for _ in range(AUX_CHECK_STEPS)]

    def make_seg(dev):
        return SegUNetTrainer(paras(), device=dev, init_variables=init)

    # float32: the forward at the shared init within AUX_F32_RTOL (logged
    # after it: the train-mode BatchNorm of the deepest stages makes two
    # float32 runs drift apart by 1e-4 - 1e-3 in two Adam steps, in the
    # JAX package as here); float64 (cuDNN's and the CPU's convolutions in
    # double): every step within AUX_F64_RTOL
    f32 = _first_steps(make_seg, seg_batches, AUX_CHECK_STEPS)
    _held("seg UNet first step, float32", {k: v[:1] for k, v in f32.items()},
          AUX_F32_RTOL)
    log(f"seg UNet float32 steps 1-{AUX_CHECK_STEPS}: card {f32['cuda']}, "
        f"CPU {f32['cpu']}")
    f64 = _first_steps(make_seg, seg_batches, AUX_CHECK_STEPS,
                       torch.float64)
    out["seg_first_steps"] = {"f32": f32, "f64": f64,
                              "f64_rel": _held("seg UNet float64", f64,
                                               AUX_F64_RTOL)}
    seg = make_seg("cuda")
    t0 = time.perf_counter()
    losses = [seg.step(seg.ds.sample(rng))[0] for _ in range(AUX_STEPS)]
    losses = torch.stack(losses).tolist()
    out["seg_run_s"] = time.perf_counter() - t0
    log(f"seg UNet {AUX_STEPS} steps in {out['seg_run_s']:.3f} s: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    fifth = max(AUX_STEPS // 5, 1)  # the loss falls: last fifth vs first
    if not (np.isfinite(losses).all() and
            np.mean(losses[-fifth:]) < np.mean(losses[:fifth])):
        raise AssertionError(f"seg UNet losses {losses}")
    batch = seg.ds.sample(rng)
    out["seg_profile"] = _aux_profile(lambda: seg.step(batch),
                                      "seg UNet step")
    unet_pkl = os.path.join(tmp, "aux_unet.pkl")
    with open(unet_pkl, "wb") as f:
        pickle.dump(seg.variables(), f)
    # the pickle in the UNet-F term and in seg_eval
    term = SegUNetLoss(paras(unet_native_ckpt=unet_pkl,
                             unet_loss_layers={"encoder-L1": [1, 2]}))
    term = term.to("cuda")
    x = torch.from_numpy(batch["out"]).cuda()
    with torch.no_grad():
        value = term(x + 0.05, x).item()
    state = seg.model.state_dict()
    same = all(torch.equal(v.cpu(), state[k].cpu())
               for k, v in term.model.state_dict().items())
    log(f"UNet-F term of the trained UNet: {value:.6f}; weights reloaded "
        f"bitwise: {same}")
    if not (np.isfinite(value) and value > 0 and same):
        raise AssertionError("UNet-F term of the trained UNet")
    dice, _ = seg_eval(_row_paras("E1 f32", data_dir, tmp), unet_pkl,
                       verbose=False, device="cuda")
    log(f"seg_eval with the trained UNet over the E1 f32 row's SR volumes: "
        f"mean Dice {dice.mean(axis=0).round(4).tolist()}")
    out["seg_reload"] = {"unet_f": value, "dice": dice.tolist()}

    # -- the VGG feature stack
    def make_vgg(dev, seed=0):
        return VGGFeatureTrainer(paras(), device=dev, seed=seed,
                                 init_variables=vgg_init)

    vgg_init = VGGFeatureTrainer(paras(), device="cpu").model.variables()
    sampler = make_vgg("cpu", seed=1)
    vgg_batches = [sampler.sample_batch() for _ in range(AUX_CHECK_STEPS)]
    vf32 = _first_steps(make_vgg, vgg_batches, AUX_CHECK_STEPS)
    out["vgg_first_steps"] = {"f32": vf32, "rel": _held(
        "VGG autoencoder float32", vf32, AUX_F32_RTOL)}
    vgg = make_vgg("cuda")
    t0 = time.perf_counter()
    vl = torch.stack([vgg.step(*vgg.sample_batch())
                      for _ in range(AUX_STEPS)]).tolist()
    out["vgg_run_s"] = time.perf_counter() - t0
    log(f"VGG autoencoder {AUX_STEPS} steps in {out['vgg_run_s']:.3f} s: "
        f"mse {vl[0]:.5f} -> {vl[-1]:.5f}")
    if not (np.isfinite(vl).all() and
            np.mean(vl[-fifth:]) < np.mean(vl[:fifth])):
        raise AssertionError(f"VGG autoencoder losses {vl}")
    vb = vgg.sample_batch()
    out["vgg_profile"] = _aux_profile(lambda: vgg.step(*vb),
                                      "VGG autoencoder step")
    blob = {"width": vgg.width,
            "params": vgg.model.variables()["params"]["encoder"],
            "losses": vl}
    vgg_pkl = os.path.join(tmp, "aux_vgg.pkl")
    with open(vgg_pkl, "wb") as f:
        pickle.dump(blob, f)
    terms = {}
    # the stack in the committed substitute's place (no torchvision vgg19
    # in the repo)
    before = os.environ.get("RDST_TPU_VGG19_NATIVE")
    os.environ["RDST_TPU_VGG19_NATIVE"] = vgg_pkl
    try:
        for name in ("VGG22", "VGG54"):
            loss = VGGLoss(name).to("cuda")
            with torch.no_grad():
                terms[name] = loss(x + 0.05, x).item()
            if not (np.isfinite(terms[name]) and terms[name] > 0
                    and loss.model.width == vgg.width):
                raise AssertionError(f"{name} of the trained stack: {terms}")
    finally:
        if before is None:
            os.environ.pop("RDST_TPU_VGG19_NATIVE")
        else:
            os.environ["RDST_TPU_VGG19_NATIVE"] = before
    log(f"VGGLoss of the trained stack: {terms}")
    out["vgg_reload"] = terms

    # -- the watchdog over the phase-13 run: beats, and logs nothing
    wd_out = os.path.join(tmp, "watchdog")
    # (its final evaluation without FID: the watchdog is what this run
    # checks, and this phase reads no VGG substitute)
    trainer = train_main(_train_argv(data_dir, wd_out, TRAIN_STEPS)
                         + [f"stall_warn_s={WATCHDOG_WARN_S}",
                            "eva_metrics='psnr ssim'"])
    with open(trainer.log_file) as f:
        lines = [ln for ln in f if "WATCHDOG" in ln]
    log(f"training run under stall_warn_s={WATCHDOG_WARN_S}: "
        f"{trainer.step} steps, heartbeat at {trainer._wd_step}, "
        f"{len(lines)} WATCHDOG lines")
    if lines or trainer._wd_step != TRAIN_STEPS:
        raise AssertionError(f"watchdog: {lines}, {trainer._wd_step}")
    out["watchdog"] = {"stall_warn_s": WATCHDOG_WARN_S,
                       "steps": trainer.step, "lines": len(lines)}
    return out


def run_xdata(data_dir: str, tmp: str, patients: dict):
    """Phases 26 (the cross-dataset rows), 36 and 37; returns (results,
    kernel rows: the f32 block and the RDSTB at COVID's geometry)."""
    tester = xdata_tester_phase(tmp)
    dice = dice_phase(data_dir, tmp, patients)
    aux = aux_trainers_phase(data_dir, tmp)
    kern, rows = tester["kernels"], tester["rows"]
    kernels = [
        _row("fused_swin_block (COVID f32 tester, whole patient)",
             "swin_block.cu", "rdst_tpu/kernels/swin_block.py:757",
             rows["COVID"]["launches"], kern["f32"]),
        _row("fused_rdstb (COVID bf16 tester, whole patient)",
             "rdstb_block.cu", "rdst_tpu/kernels/rdstb_block.py:334",
             rows["COVID bf16"]["launches"], kern["rdstb"]),
    ]
    return {"tester": tester, "dice": dice, "aux": aux}, kernels


# ---------------------------------------------------------------------------
# The Swin-based model zoo (``--only zoo``): RDST-N, ESTSR, the wavelet
# transformers, Swin-MLP and RDST's 3conv / ape, at the full width the
# factories build from the E1 configs with KEY=VALUE overrides, on seeded
# weights (no committed weights)

ZOO_SEED = SEED + 40
# label: (overrides of CONFIG, LR size of the 8 seeded slices, scale)
ZOO = {
    "RDST-N": ({"rdst_global_bottleneck": True}, LR_HW, 4.0),
    "RDST-N conv": ({"rdst_global_bottleneck": True,
                     "rdst_global_bottleneck_mode": "conv"}, LR_HW, 4.0),
    "ESTSR": ({"feature_generator": "estsr"}, LR_HW, 4.0),
    "ESTSR meta": ({"feature_generator": "estsr", "scale_free": True},
                   LR_HW, 2.5),
    "WaveletSR": ({"feature_generator": "wtb"}, LR_HW, 4.0),
    "WaveletSR db2": ({"feature_generator": "wts",
                       "wavelet_kernel": "db2"}, LR_HW, 4.0),
    "SwinMLP": ({"feature_generator": "swinmlp"}, LR_HW, 4.0),
    "RDST 3conv": ({"rdst_res_connection": "3conv"}, LR_HW, 4.0),
    # the position table is sized by the token count at init: 24x24
    "RDST ape": ({"rdst_ape": True}, (24, 24), 4.0),
}
# f32 block launches a forward, each family (SwinMLP runs no kernel)
ZOO_F32_LAUNCHES = {"RDST-N": 48, "RDST-N conv": 48, "ESTSR": 144,
                    "ESTSR meta": 144, "WaveletSR": 8, "WaveletSR db2": 8,
                    "SwinMLP": 0, "RDST 3conv": 48, "RDST ape": 48}
# bf16 modes a family serves in, with the launches of the mode's kernel a
# forward; 'refused': the modes it raises in at build
ZOO_BF16 = {
    "RDST-N": {"rdstb": 8, "pair": 24, "swin": 48},
    "ESTSR": {"rdstb": 24, "pair": 72, "swin": 144},
    "WaveletSR": {"swin": 8, "refused": ("rdstb", "pair")},
    "RDST 3conv": {"pair": 24, "swin": 48, "refused": ("rdstb",)},
}
ZOO_TRAIN = {  # label: (overrides of TRAIN_CONFIG, train-pair launches a step)
    "RDST-N": ({"rdst_global_bottleneck": True}, 24),
    "ESTSR": ({"feature_generator": "estsr"}, 72),
    "WaveletSR": ({"feature_generator": "wtb", "pallas_kernels": "swin"}, 4),
    "SwinMLP": ({"feature_generator": "swinmlp",
                 "training_dtype": "float32"}, 0),
}
ZOO_STEPS = 6
# ZOO_BARS: the JAX package's float32 forward of each ZOO family on the
# CPU (XLA), from the same seeded weights and slices (zoo_weights,
# zoo_input): the output's shape, sum, sum of squares, largest magnitude
# and 64 sampled pixels (zoo_stats). Made by
#     JAX_PLATFORMS=cpu python tools/jax_zoo_bars.py
ZOO_BARS = {
    'RDST-N': {
        "shape": [8, 160, 128, 1], "sum": 2611.546962,
        "sumsq": 604.7943979, "absmax": 0.275234878,
        "pixels": [0.074802123, -0.0846270621, -0.00330077857, -0.0994790345, -0.0469144583, -0.0239890516, 0.0461135544, 0.082776159, 0.0715379417, -0.103147969, -0.0281101353, 0.0489880033, 0.0258558877, 0.0461288244, 0.0239431262, -0.00929092616, 0.038427107, -0.0287422687, 0.0886693522, 0.00581043307, 0.0590995625, 0.0535027385, 0.0630582795, -0.0354774594, 0.0515174195, 0.0565670952, -0.124749511, 0.0544081628, 0.0419148728, 0.000122344121, 0.184465945, 0.0955407172, -0.0935485885, 0.119012624, -0.0200651288, -0.0909274071, 0.0442534015, 0.108680174, 0.053054437, -0.0870625079, 0.0167767256, 0.0536471866, 0.0316850804, -0.00241426006, 0.0511222593, 0.0707871914, -0.0453589521, 0.0309127346, 0.0600819513, 0.0699158013, 0.0982564613, 0.0728816018, 0.00571500137, 0.00909139588, 0.0286561213, 0.105631948, -0.0177560654, 0.120044842, -0.0244953893, -0.00181455724, 0.0574098788, 0.0152326506, -0.0634028092, 0.0424058586]},
    'RDST-N conv': {
        "shape": [8, 160, 128, 1], "sum": -5592.239724,
        "sumsq": 1631.335544, "absmax": 0.347059608,
        "pixels": [-0.0629798546, 0.0641971976, 0.0816808566, -0.151200235, -0.079022482, 0.0111852325, 0.0573928356, -0.0489026494, -0.190008491, -0.0256113671, 0.0706507936, -0.15230976, 0.0789687037, -0.215043351, 0.00594373513, -0.0228890851, -0.0861796588, -0.162758008, -0.130380183, -0.163112402, 0.0438559055, -0.0982050002, -0.0608467162, 0.0503958538, 0.133998305, 0.0763676614, -0.0415121317, -0.113645673, -0.157782182, -0.0727594495, 0.119299725, -0.0677421466, -0.103464745, -0.00770078879, 0.17192252, 0.0323527679, 0.113568574, 0.0859173611, -0.106040478, 0.00740086474, -0.169484437, -0.124183267, -0.208549082, -0.184357747, 0.0210073031, -0.0452210344, -0.0256941468, 0.0116952844, -0.187479302, 0.122180752, -0.0349463113, -0.0181712694, -0.0594578683, -0.0130061088, -0.143070772, -0.16159308, -0.0998204872, 0.0316457264, -0.0618658066, 0.126064822, 0.143932283, -0.1017849, 0.13938272, -0.059551686]},
    'ESTSR': {
        "shape": [8, 160, 128, 1], "sum": -3314.300049,
        "sumsq": 7635.390292, "absmax": 0.752361476,
        "pixels": [-0.0568136573, 0.0138359666, -0.370326161, 0.0586178154, -0.0413576663, 0.367894888, 0.147925496, -0.208843887, -0.176037759, 0.00362914801, 0.155359566, -0.0680735707, 0.203233585, 0.029615432, 0.158944398, 0.237120762, -0.113163382, -0.215263069, -0.313728213, -0.306801647, -0.324571908, 0.0798663497, -0.277752489, 0.143695012, -0.398407787, -0.252735198, -0.196500361, 0.187737018, 0.12394689, 0.171930403, 0.0343437269, 0.214602977, -0.120497033, -0.00857015327, -0.208534107, 0.0478999019, -0.29670316, -0.0243806243, -0.0149532445, -0.0700350255, 0.406550348, 0.0559880733, -0.232036129, 0.4017542, -0.00973848253, 0.137680262, -0.117378421, -0.344131052, -0.0195299834, -0.299047291, 0.0926224142, 0.0849478915, 0.281909496, -0.138590574, -0.0180281717, -0.0743261352, -0.17826961, 0.156178266, 0.185352147, -0.415535003, -0.373955637, 0.367693305, 0.00710234046, -0.00856969878]},
    'ESTSR meta': {
        "shape": [8, 100, 80, 1], "sum": 5371.094502,
        "sumsq": 564.1425356, "absmax": 0.251549512,
        "pixels": [0.0712789595, 0.0364044197, 0.0943641067, 0.130295977, 0.0305725653, 0.122490913, 0.0915198103, 0.160789013, 0.0970451832, 0.0818147734, 0.10069298, 0.139280036, 0.104988515, 0.057067696, 0.0749154389, 0.0968479663, 0.0709878653, 0.0482767075, 0.127255842, 0.1345478, 0.094526194, 0.0724890083, 0.0397444665, 0.137355804, 0.0452863462, 0.0388890356, 0.0451033637, 0.107617974, 0.0623221099, 0.0538365692, 0.126198798, 0.126138434, 0.112260722, 0.0979555547, 0.0695946664, 0.121237442, 0.113557413, 0.00212758966, 0.0547753498, 0.120858297, 0.137093142, 0.0497284941, 0.11371772, 0.118534148, 0.14347361, 0.0101219658, 0.0599746406, 0.0670994967, 0.0415903777, 0.0987532139, 0.0431116633, 0.0273801703, 0.0675782934, 0.133700624, 0.0796282887, 0.0398319215, 0.00663380884, 0.131293803, 0.0875743777, 0.110938579, 0.0820765197, 0.161696464, 0.0680649132, 0.054779768]},
    'WaveletSR': {
        "shape": [8, 160, 128, 1], "sum": 1215.410231,
        "sumsq": 7395.036485, "absmax": 0.866038561,
        "pixels": [-0.026617581, -0.0351131856, 0.221440762, -0.00144551694, -0.0411440134, 0.0420819819, -0.35366863, -0.188582867, -0.285668999, 0.123258971, 0.163220689, -0.0235053077, -0.233006477, 0.0572781414, -0.17317827, 0.326851815, 0.266286075, -0.0647876561, 0.451460272, -0.00216257572, -0.254561484, 0.00992612541, 0.0530180112, -0.283785462, 0.221177399, -0.322119236, 0.153914362, -0.0298298076, 0.08154466, -0.271858037, 0.346301019, 0.260222256, 0.268556774, 0.188073665, 0.263640553, -0.172457203, 0.254431129, -0.138618857, 0.128419369, -0.0993561745, 0.152417034, -0.143532336, 0.307914615, -0.176654682, -0.195243791, 0.0753912926, -0.104075775, 0.632517874, 0.240559235, 0.339006126, -0.171915382, 0.307900369, -0.278085709, 0.00245545805, -0.582945108, -0.38630113, 0.130037457, -0.218500331, -0.144091249, -0.0151108876, -0.0910438374, 0.154447079, 0.185273468, -0.0178619698]},
    'WaveletSR db2': {
        "shape": [8, 160, 128, 1], "sum": 1263.761835,
        "sumsq": 7345.73562, "absmax": 0.997177482,
        "pixels": [-0.0869484246, 0.135747224, 0.251497895, 0.391759098, 0.2978127, -0.0259416252, -0.46103397, 0.0670274347, -0.121583402, -0.29848516, -0.0543162897, 0.280288637, 0.346488684, -0.0951332301, 0.0513342842, 0.185455129, 0.0096822232, 0.0531759523, -0.0768347681, 0.0441807993, -0.0404146984, 0.291781694, -0.19474487, 0.0561586954, 0.00366540253, -0.0596123822, -0.135018572, 0.0706023127, -0.0777079239, 0.161407173, 0.510108113, -0.199347541, 0.192517132, -0.00973977149, 0.0306635369, -0.206871688, -0.124122292, -0.210594326, -0.239576519, -0.192052811, 0.228363484, 0.173860192, 0.0645836294, -0.518484831, 0.385483086, 0.0928487033, -0.130493879, -0.0427392721, 0.0658167899, 0.24778378, 0.349534452, 0.218800634, -0.0365511253, -0.0568427183, -0.223087937, -0.483810931, 0.0169997625, -0.134834215, -0.0334171988, 0.056289956, -0.15767549, -0.317429006, 0.104196534, -0.416819632]},
    'SwinMLP': {
        "shape": [8, 160, 128, 1], "sum": -1290.32317,
        "sumsq": 2219.829345, "absmax": 0.500515163,
        "pixels": [-0.117743433, -0.120730542, 0.127319813, -0.0521223918, -0.0549109653, -0.0511825085, 0.042871125, -0.0842020512, -0.00180497766, -0.190003648, -0.0630429983, -0.149227172, -0.0543504171, -0.0716055855, 0.0233083367, 0.264974356, -0.0898450613, 0.359869987, -0.0460840203, -0.0728525519, -0.0463092886, -0.0389077663, -0.0206972174, -0.124309495, -0.169670582, 0.106726058, -0.165304556, -0.233561203, -0.131108969, -0.112231873, -0.0537540093, -0.00790350512, -0.120283589, -0.183875546, -0.0471056849, 0.0671029836, -0.0108417179, -0.12108288, -0.0166951194, -0.100243196, 0.108467296, -0.0607396886, 0.059186168, -0.00337101519, -0.178329676, 0.0134646371, -0.144436896, 0.104242109, -0.111814484, -0.0673542693, -0.126062095, -0.106902234, 0.0662616342, -0.0488748252, -0.121692136, -0.140534073, -0.113059163, 0.0785191357, -0.184744835, -0.0243479423, 0.0182021186, 0.192375347, -0.0816871971, 0.0266199633]},
    'RDST 3conv': {
        "shape": [8, 160, 128, 1], "sum": 4992.267928,
        "sumsq": 719.2173926, "absmax": 0.232417911,
        "pixels": [0.0898323059, 0.064570941, -0.0112200528, 0.00195507333, 0.013037377, -0.101345517, 0.0449780263, 0.000620711595, 0.00475599244, -0.0151393609, 0.0479968563, 0.0879049301, -0.0423128307, 0.0675410405, 0.0889306515, 0.066354461, 0.110744245, 0.0967253819, 0.0470481291, 0.125654474, 0.0468122289, 0.0673890263, -0.0841626078, 0.0590318367, -0.0139851794, -0.0164042041, -0.012911072, -0.0081751775, 0.0594152585, 0.00942211412, 0.0664667636, 0.00854550488, -0.048204273, 0.0524471216, 0.0170643553, 0.101079211, -0.0102635501, 0.118276313, 0.0618937016, 0.00381864421, 0.0960878357, 0.09838669, 0.0839608833, 0.0483884029, 0.00605543703, -0.0108162072, 0.0244972911, -0.0529546626, 0.0528919697, 0.0142916851, 0.0415629782, 0.0559846535, 0.0435191467, 0.000420378521, 0.0352663137, 0.011828728, 0.0114347488, 0.0284367763, 0.0530236065, 0.0100817662, 0.0186801814, 0.126688287, 0.0529542677, 0.0959445238]},
    'RDST ape': {
        "shape": [8, 96, 96, 1], "sum": 1013.244365,
        "sumsq": 612.8305791, "absmax": 0.388168663,
        "pixels": [0.0366858393, 0.191162482, 0.260479331, 0.206315875, 0.0246762484, -0.0121140983, 0.250495195, -0.0247706622, 0.226992607, -0.16327706, -0.0706846118, -0.035719879, -0.00422668085, -0.103318512, 0.00679339096, 0.0247792564, 0.085404858, 0.0138078164, -0.0777764544, 0.0296838805, 0.0705121905, 0.119493425, 0.0875919163, 0.140820593, 0.042235285, -0.0197874978, -0.0343315154, -0.0535788834, -0.0433662422, 0.00719868019, -0.121841073, 0.171534047, 0.144682601, 0.063960582, 0.255506545, -0.0531156994, 0.113619745, -0.0187131166, 0.252064049, 0.00576859713, 0.129241928, 0.0934976637, 0.0208459441, 0.000332501717, 0.198122188, 0.108442187, 0.0105602313, 0.0427615866, -0.0288327113, -0.0115174614, -0.145575762, 0.0588514283, 0.0291887745, 0.0609930232, 0.0274974089, 0.061040476, -0.0601632781, 0.0831940398, 0.0425671637, 0.0388975665, 0.0485743396, 0.105745554, -0.00767840818, 0.050820291]},
}
# the port's f32 kernel forward on the card against them: the mean, the
# mean square (over the largest magnitude squared) and each sampled pixel
# within ZOO_TOL of the largest magnitude
ZOO_TOL = 1e-4


def _trunc_normal(rng, shape):
    """Standard normal draws cut at 2 (redrawn), as flax's
    ``truncated_normal`` draws before its scale."""
    v = rng.standard_normal(shape)
    bad = np.abs(v) > 2.0
    while bad.any():
        v[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(v) > 2.0
    return v


def zoo_weights(shapes: dict, seed: int = ZOO_SEED) -> dict:
    """Seeded parameters of a fresh model, ``{flax path: array}``, drawn
    leaf by leaf in sorted flax-path order at the scales of the JAX
    package's initializers: a conv kernel (2-D, 3-D or transposed) uniform
    within 1 / sqrt(fan_in) (``torch_conv_init``), dense kernels,
    relative-position, absolute-position and IPT's position and query
    tables and Swin-MLP spatial kernels 0.02 x a normal cut at 2,
    LayerNorm scales 1, every bias 0; the layer scales ``gamma`` (HAN's
    LAM and CSAM, ConvNeXt's blocks) uniform in [0.5, 1), not at their
    init (0 or 1e-6), where the branches they scale would not show in the
    output. numpy only: ``tools/jax_zoo_bars.py`` draws the same arrays
    for the JAX package."""
    rng = np.random.default_rng(seed)
    out = {}
    for path in sorted(shapes):
        shape, leaf = tuple(shapes[path]), path[-1]
        if leaf == "kernel" and len(shape) >= 4:
            bound = float(np.prod(shape[:-1])) ** -0.5
            v = rng.uniform(-bound, bound, shape)
        elif leaf in ("kernel", "relative_position_bias_table",
                      "spatial_mlp_kernel", "absolute_pos_embed",
                      "position_encoding", "query_embed"):
            v = 0.02 * _trunc_normal(rng, shape)
        elif leaf == "gamma":
            v = rng.uniform(0.5, 1.0, shape)
        elif leaf == "scale":
            v = np.ones(shape)
        else:
            v = np.zeros(shape)
        out[path] = v.astype(np.float32)
    return out


def zoo_input(hw) -> np.ndarray:
    """The 8 seeded LR slices of a ZOO family (NHWC, values 0..1)."""
    return np.random.default_rng(ZOO_SEED).random((8,) + tuple(hw) + (1,),
                                                  dtype=np.float32)


def zoo_stats(y: np.ndarray) -> dict:
    """What ZOO_BARS holds of an output: its shape, sum, sum of squares,
    largest magnitude and 64 pixels at seeded flat indices."""
    y = np.asarray(y, np.float64)
    idx = np.random.default_rng(ZOO_SEED + 1).choice(y.size, 64,
                                                     replace=False)
    return {"shape": list(y.shape), "sum": float(y.sum()),
            "sumsq": float((y * y).sum()),
            "absmax": float(np.abs(y).max()),
            "pixels": [float(v) for v in y.reshape(-1)[idx]]}


def zoo_paras(label: str, config: str = CONFIG, **kw):
    from rdst_tpu_torch.config import ParametersLoader

    p = ParametersLoader(config)
    for k, v in {**ZOO[label][0], **kw}.items():
        p.set(k, v)
    return p


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _seeded_sd(model, generator: str) -> dict:
    """``zoo_weights`` over a built model's flax tree, as its state_dict."""
    from rdst_tpu_torch.checkpoint.convert import export_params
    from rdst_tpu_torch.checkpoint.msgpack_reader import flatten
    from rdst_tpu_torch.checkpoint.msgpack_writer import import_state_dict

    shapes = {k: v.shape for k, v in flatten(import_state_dict(
        model.state_dict())["params"]).items()}
    sd = export_params({"params": _nest(zoo_weights(shapes))}, generator,
                       getattr(model, "mean", (0.0,)),
                       getattr(model, "std", (1.0,)))
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _zoo_model(label: str, dtype=torch.float32, device="cuda", **kw):
    """A ZOO family built by ``build_generator`` from CONFIG with its
    overrides (and ``kw``), holding the seeded weights (``zoo_weights``
    over its flax tree, carried in by ``convert``), on ``device`` as the
    entry points resolve it (``device.resolve_device``)."""
    from rdst_tpu_torch.device import resolve_device
    from rdst_tpu_torch.models import build_generator

    device = resolve_device(device)  # float32 numerics: TF32 off
    p = zoo_paras(label, **kw)
    model = build_generator(p, dtype=dtype)
    model.load_state_dict(_seeded_sd(model, p.feature_generator))
    return model.to(device).eval()


def _zoo_counters():
    from rdst_tpu_torch.kernels import rdstb_block, swin_block, swin_pair

    return {"f32": swin_block.fused_swin_block,
            "swin": swin_block.run_fast_block,
            "pair": swin_pair.run_swin_pair, "rdstb": rdstb_block.run_rdstb}


def _zoo_forward(model, x: np.ndarray, scale) -> tuple:
    """(output as numpy float32, {counter: launches}) of one forward, the
    counts set to 0 just before and read just after."""
    counters = _zoo_counters()
    for c in counters.values():
        c.launches = 0
    with torch.inference_mode():
        y = model(torch.from_numpy(x).cuda(), scale)
        torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    return y.float().cpu().numpy(), launches


@phase("zoo f32 forwards")
def zoo_forward_phase() -> dict:
    """Each ZOO family at full width in float32 on 8 seeded slices: the
    kernel path against ZOO_BARS (the JAX package's forward on the CPU)
    and against the same model's plain path on the card (MODEL_TOL), its
    f32 block launches a forward."""
    from rdst_tpu_torch.nn.swin import set_block_kernels

    out = {}
    for label, (_, hw, scale) in ZOO.items():
        model = _zoo_model(label)
        x = zoo_input(hw)
        y, n = _zoo_forward(model, x, scale)
        set_block_kernels(model, False)
        y_plain, n_plain = _zoo_forward(model, x, scale)
        set_block_kernels(model, True)
        got, bar = zoo_stats(y), ZOO_BARS[label]
        big = bar["absmax"]
        size = float(np.prod(bar["shape"]))
        d = {"mean": abs(got["sum"] - bar["sum"]) / size / big,
             "mean_square": abs(got["sumsq"] - bar["sumsq"]) / size
             / big ** 2,
             "pixels": max(abs(a - b) for a, b in zip(got["pixels"],
                                                      bar["pixels"])) / big}
        err = float(np.abs(y - y_plain).max())
        row = {"routes": model.routes, "launches": n["f32"],
               "versus_jax": d, "kernel_vs_plain_max_abs_err": err,
               "absmax": got["absmax"], "params": sum(
                   p.numel() for p in model.parameters())}
        out[label] = row
        log(f"zoo {label} ({row['params']} params) f32 8 x {hw} -> "
            f"{y.shape}: vs the JAX forward (ZOO_BARS) mean {d['mean']:.2e}"
            f", mean square {d['mean_square']:.2e}, 64 pixels "
            f"{d['pixels']:.2e} of max|y| {big:.4f} (bar {ZOO_TOL}); kernel "
            f"vs plain {err:.3e} (tol {MODEL_TOL}); f32 block launches a "
            f"forward {n['f32']} (plain {n_plain['f32']})")
        if list(y.shape) != bar["shape"] or not np.isfinite(y).all():
            raise AssertionError(f"zoo {label}: {y.shape} vs {bar['shape']}")
        if max(d.values()) > ZOO_TOL or err > MODEL_TOL:
            raise AssertionError(f"zoo {label}: {row}")
        if n["f32"] != ZOO_F32_LAUNCHES[label] or n_plain["f32"] or any(
                n[k] for k in ("swin", "pair", "rdstb")):
            raise AssertionError(f"zoo {label}: launches {n} / {n_plain}")
        row["y"] = y
    return out


@phase("zoo bf16 forwards")
def zoo_bf16_phase(f32: dict) -> dict:
    """RDST-N and ESTSR in bf16 modes rdstb, pair and swin, WaveletSR in
    mode swin, RDST 3conv in modes pair and swin, each on the seeded
    weights: the kernel route against the same model's plain bf16 path on
    the card (BF16_TOL) and against the family's f32 output (the
    bf16-vs-f32 bars), launches of the mode's kernel a forward (counts
    set to 0 just before, read just after); the modes a family's kernel
    cannot take raise at build and name the mode to choose."""
    from rdst_tpu_torch.models.routes import set_kernel_mode

    out = {}
    for label, modes in ZOO_BF16.items():
        for mode in modes.get("refused", ()):
            try:
                _zoo_model(label, torch.bfloat16, "cpu",
                           pallas_kernels=mode)
            except ValueError as e:
                log(f"zoo {label} bf16 mode {mode}: refused at build ({e})")
                if "pallas_kernels=" not in str(e):
                    raise
            else:
                raise AssertionError(f"zoo {label}: mode {mode} built")
        served = [m for m in modes if m != "refused"]
        model = _zoo_model(label, torch.bfloat16, pallas_kernels=served[0])
        softmax = model.softmax
        _, hw, scale = ZOO[label]
        x = zoo_input(hw)
        set_kernel_mode(model, "", softmax)
        y_plain, n_plain = _zoo_forward(model, x, scale)
        y32 = f32[label]["y"]
        for mode in served:
            set_kernel_mode(model, mode, softmax)
            y, n = _zoo_forward(model, x, scale)
            kp = _rel(torch.from_numpy(y), torch.from_numpy(y_plain))[:2]
            kf = _rel(torch.from_numpy(y), torch.from_numpy(y32))[:2]
            row = {"routes": sorted(set(model.routes)), "launches": n[mode],
                   "vs_plain_rel": kp, "vs_f32_rel": kf, "softmax": softmax}
            out[f"{label} {mode}"] = row
            log(f"zoo {label} bf16 mode {mode} ({softmax}): {n[mode]} "
                f"launches a forward; vs the plain bf16 path rel max "
                f"{kp[0]:.3e} (bar {BF16_TOL}); vs f32 rel max {kf[0]:.3e} "
                f"mean {kf[1]:.3e} (bars {BF16_VS_F32_MAX}, "
                f"{BF16_VS_F32_MEAN})")
            if not np.isfinite(y).all() or n[mode] != modes[mode] or sum(
                    n.values()) != n[mode] or any(n_plain.values()):
                raise AssertionError(f"zoo {label} {mode}: launches {n}")
            if kp[0] > BF16_TOL or kf[0] >= BF16_VS_F32_MAX or \
                    kf[1] >= BF16_VS_F32_MEAN:
                raise AssertionError(f"zoo {label} {mode}: {row}")
        out[label] = {"model": model}
    return out


def _zoo_block(block, shift: int, images: int, grid, gen, bf16: bool,
               label: str) -> dict:
    """The f32 block kernel (``bf16`` False) or the fast block at
    ``images`` images of DWT grid ``grid`` with ``block``'s weights at
    ``shift``: against its plain version (KERNEL_TOL / BF16_TOL), two
    launches bitwise equal, CUDA-event times, the bound."""
    from rdst_tpu_torch.kernels import swin_block as sb

    ws, nh, c = 8, block.num_heads, block.dim
    nw = (grid[0] // ws) * (grid[1] // ws)
    x = torch.randn(images * nw, ws * ws, c, device="cuda", generator=gen)
    with torch.inference_mode():
        if bf16:
            x = x.to(torch.bfloat16)
            params, bias = block.fast_kernel_inputs(tuple(grid), ws, shift)
            plan = sb.plan_fast_block(params, bias, num_heads=nh)
            kw = dict(num_heads=nh, windows_per_image=nw, softmax="stable")

            def call():
                return sb.run_fast_block(x, plan, **kw)

            def plain():
                return sb.swin_block_fast_reference(
                    x, plan.params, plan.bias, num_heads=nh,
                    softmax="stable", qkv=plan.qkv)
        else:
            params, bias = block.kernel_inputs(tuple(grid), ws, shift)
            plan = sb.plan_f32_block(params, bias, num_heads=nh)
            kw = dict(num_heads=nh, windows_per_image=nw)

            def call():
                return sb.run_f32_block(x, plan, **kw)

            def plain():
                return sb.swin_block_reference(x, *plan.params, bias, **kw)
        got, again, want = call(), call(), plain()
        torch.cuda.synchronize()
        name = (f"{label} {'fast' if bf16 else 'f32'} block C={c} nH={nh} "
                f"shift={shift} at {images} x grid {tuple(grid)} "
                f"({images * nw} windows)")
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two launches differ")
        if bf16:
            err = _check(name, got, want)
        else:
            e = (got - want).abs().max().item()
            if not (e <= KERNEL_TOL and torch.isfinite(got).all()):
                raise AssertionError(f"{name}: {e} > {KERNEL_TOL}")
            err = (None, None, e)
        ms = cuda_time_ms(call, warmup=2, iters=10)
        plain_ms = cuda_time_ms(plain, warmup=1, iters=3)
    flops, weights = _block_work(block, c, images * nw)
    if bf16:
        bound_ms, by = _bound(flops, 2 * 2 * x.numel() + _plan_bytes(plan))
        bound = {"bound_ms": bound_ms, "bound_by": by}
    else:
        bound = _f32_bound(flops, 4 * (2 * x.numel() + weights
                                       + bias.numel()))
    row = dict(c=c, num_heads=nh, shift=shift, images=images,
               grid=list(grid), windows=images * nw, rel_max=err[0],
               max_abs_err=err[2], ms=ms, plain_ms=plain_ms, **bound)
    if bf16:
        row["route"] = plan.route
    log(f"{name}" + (f" ({plan.route})" if bf16 else "") + ": "
        + (f"rel max {err[0]:.3e} (bar {BF16_TOL})" if bf16 else
           f"max abs err {err[2]:.3e} (tol {KERNEL_TOL})")
        + f", two launches bitwise equal; {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})")
    return row


def _zoo_pair_train(layer, grid, images: int, gen, label: str) -> dict:
    """The train pair (forward and backward) with ``layer``'s first two
    blocks at ``images`` images of ``grid`` (window 8, shift 4, 'clamp'):
    output and every gradient against the plain version and its autograd
    (BF16_TOL); the forward and backward launches alone (two forward
    launches bitwise equal) timed by CUDA events beside their bounds and
    the plain version's times."""
    from rdst_tpu_torch.kernels import pair_train as pt
    from rdst_tpu_torch.kernels.swin_block import (FastParams, fast_params,
                                                   pack_bias_fast,
                                                   softmax_code)

    a, b = layer.blocks[0], layer.blocks[1]
    c, nh, ws = a.dim, a.num_heads, 8
    nw = (grid[0] // ws) * (grid[1] // ws)
    pa, ba = a.fast_kernel_inputs(tuple(grid), ws, 0)
    pb, bb = b.fast_kernel_inputs(tuple(grid), ws, ws // 2)
    with torch.no_grad():
        ops = [o.detach().contiguous() for o in (
            *fast_params(pa, c, nh), pack_bias_fast(ba, nh, 64),
            *fast_params(pb, c, nh), pack_bias_fast(bb, nh, 64))]
    x = torch.randn(images * nw, 64, c, device="cuda",
                    generator=gen).to(torch.bfloat16)
    dz = torch.randn(images * nw, 64, c, device="cuda",
                     generator=gen).to(torch.bfloat16)
    kw = dict(num_heads=nh, x_size=tuple(grid), window_size=ws, shift=4,
              softmax="clamp")
    got, g_got = _pair_train_grads(pt.run_pair_train, ops, x, dz, None, kw)
    want, g_want = _pair_train_grads(pt.pair_train_reference, ops, x, dz,
                                     None, kw)
    torch.cuda.synchronize()
    errs = [_rel(got, want)] + [_rel(u, v) for u, v in zip(g_got, g_want)]
    worst = max(e[0] for e in errs)
    name = f"{label} train pair C={c} nH={nh} at {images} x grid {grid}"
    if worst > BF16_TOL or not all(bool(torch.isfinite(g.float()).all())
                                   for g in g_got):
        raise AssertionError(f"{name}: rel max {worst} > {BF16_TOL}")
    geom = (tuple(grid), ws, 4, nh, softmax_code("clamp"))
    fa, fb = FastParams(*ops[:8]), FastParams(*ops[9:17])
    oa, ob = pt.forward_layout(fa, ops[8], fb, ops[17], nh)
    hidden = a.mlp.fc1.out_features

    def fwd():
        return pt.launch_forward(x, oa, ob, None, geom, hidden)

    first, y = fwd()
    again, y2 = fwd()
    torch.cuda.synchronize()
    if not (torch.equal(first, again) and torch.equal(y, y2)):
        raise AssertionError(f"{name}: two forward launches differ")

    def bwd():
        return pt.launch_backward(x, dz, y, fa, ops[8], fb, ops[17], None,
                                  geom)

    ms = cuda_time_ms(fwd, warmup=2, iters=10)
    bwd_ms = cuda_time_ms(bwd, warmup=1, iters=5)
    with torch.no_grad():
        plain_ms = cuda_time_ms(lambda: pt.pair_train_reference(
            x, fa, ops[8], fb, ops[17], None, **kw), warmup=1, iters=3)
    leaves = [t.detach().clone().requires_grad_(True) for t in [x] + ops]
    twin = pt.pair_train_reference(
        leaves[0], FastParams(*leaves[1:9]), leaves[9],
        FastParams(*leaves[10:18]), leaves[18], None, **kw)
    plain_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
        twin, leaves, dz, retain_graph=True), warmup=1, iters=3)
    del twin, leaves
    flops = 2 * _block_flops(images * nw, c)
    wbytes = sum(t.numel() * t.element_size() for t in ops)
    tok = x.numel() * 2
    bound_ms, by = _bound(flops, 3 * tok + wbytes)
    bwd_bound_ms, bwd_by = _bound(2 * flops, 4 * tok + 3 * wbytes)
    row = dict(c=c, num_heads=nh, images=images, grid=list(grid),
               windows=images * nw, rel_max=worst,
               out_abs_err=errs[0][2],
               grad_abs_err=max(e[2] for e in errs[1:]), ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
               bwd_ms=bwd_ms, plain_bwd_ms=plain_bwd_ms,
               bwd_bound_ms=bwd_bound_ms, bwd_bound_by=bwd_by)
    log(f"{name}: out and gradients rel max {worst:.3e} (bar {BF16_TOL}); "
        f"two forward launches bitwise equal; forward {ms:.4f} ms (plain "
        f"{plain_ms:.4f}, bound {bound_ms:.4f} {by}); backward "
        f"{bwd_ms:.4f} ms (plain {plain_bwd_ms:.4f}, bound "
        f"{bwd_bound_ms:.4f} {bwd_by})")
    return row


@phase("zoo kernels alone")
def zoo_kernel_phase(f32_models: dict, bf16: dict) -> dict:
    """The kernels at the zoo's geometries against their plain versions:
    WaveletSR's C = 64 / 4 heads (head dim 16) f32 and fast blocks, shift
    0 and 4, at bucket 64 of 40x32 (DWT grid 24x16: 384 windows), then at
    the tester's grid 8x8 where the shift drops out; its train pair at 32
    training patches (grid 16x16); ESTSR's and RDST-N's f32 blocks and
    RDSTB and their train pair at E1's geometries."""
    gen = torch.Generator(device="cuda").manual_seed(ZOO_SEED + 2)
    wt32, wt16 = f32_models["WaveletSR"], bf16["WaveletSR"]["model"]
    out = {"f32": [], "fast": []}
    for grid, shifts in (((24, 16), (0, 4)), ((8, 8), (0,))):
        for shift in shifts:
            out["f32"].append(_zoo_block(wt32.group_0.blocks[shift // 4],
                                         shift, 64, grid, gen, False,
                                         "WaveletSR"))
            out["fast"].append(_zoo_block(wt16.group_0.blocks[shift // 4],
                                          shift, 64, grid, gen, True,
                                          "WaveletSR"))
    out["train_pair"] = [_zoo_pair_train(wt16.group_0, (16, 16), 32, gen,
                                         "WaveletSR")]
    for label in ("ESTSR", "RDST-N"):
        m32, m16 = f32_models[label], bf16[label]["model"]
        first = m16.rdstbs()[0]
        out[label] = {
            "f32": [_f32_block_at(blk, k * 4, 8, LR_HW, gen)
                    for blk, k in zip(m32.rdstbs()[0].body[0].body.blocks,
                                      (0, 1))],
            "rdstb": [_rdstb_at(first, 8, LR_HW, gen, m16.softmax)],
            "train_pair": [_zoo_pair_train(first.body[0].body, (24, 24), 32,
                                           gen, label)]}
    return out


def _zoo_serve(live, counter, per_forward: int, hw=LR_HW,
               timed: int = 3) -> dict:
    """``live`` over HTTP: requests of 1, 8 and 64 seeded slices of ``hw``
    (default 40x32), each response against a direct predict (SERVE_TOL),
    ``counter``'s launches over the requests (set to 0 just before, read
    just after: ``per_forward`` a forward; or, a dict of counters, each
    0), p50 latency of ``timed`` requests a bucket."""
    from rdst_tpu_torch.serving.client import SRClient
    from rdst_tpu_torch.serving.server import InferenceServer

    srv = InferenceServer(live, "127.0.0.1", 0, max_batch=64,
                          batch_wait_ms=5.0)
    rng = np.random.default_rng(ZOO_SEED + 3)
    out = {}
    try:
        srv.warmup(lr_hw=hw, scale=SCALE)
        srv.start_background()
        client = SRClient(f"http://127.0.0.1:{srv.port}")
        xs = {b: rng.random((b,) + tuple(hw), dtype=np.float32)
              for b in (1, 8, 64)}
        direct = {b: live.predict(x, SCALE) for b, x in xs.items()}
        counters = counter if isinstance(counter, dict) else {}
        for c in counters.values():
            c.launches = 0  # the served path starts here
        if counter is not None and not counters:
            counter.launches = 0  # the served path starts here
        for b, x in xs.items():
            got = client.predict(x, SCALE)
            err = float(np.abs(got - direct[b]).max())
            if got.shape != direct[b].shape or err > SERVE_TOL:
                raise AssertionError(f"served {b}: {got.shape} {err}")
            out[f"err_{b}"] = err
        if counters:
            out["launches"] = {k: c.launches for k, c in counters.items()}
            if any(out["launches"].values()):  # and ends here
                raise AssertionError(f"served launches {out['launches']}")
        elif counter is not None:
            out["launches"] = counter.launches  # and ends here
            if out["launches"] != 3 * per_forward:
                raise AssertionError(f"served launches {out['launches']}, "
                                     f"expected 3 x {per_forward}")
        for b, x in xs.items():
            ts = []
            for _ in range(timed):
                t0 = time.perf_counter()
                client.predict(x, SCALE)
                ts.append(time.perf_counter() - t0)
            out[f"p50_ms_{b}"] = float(np.median(ts)) * 1e3
    finally:
        srv.close()
    log("served 1 / 8 / 64 slices, each equal to a direct predict (max "
        f"abs err {max(out[f'err_{b}'] for b in (1, 8, 64)):.3e}); "
        + (f"{out['launches']} launches; " if counter is not None else "")
        + "p50 " + " / ".join(f"{out[f'p50_ms_{b}']:.2f}" for b in
                              (1, 8, 64)) + " ms")
    return out


@phase("zoo training, tester and server")
def zoo_train_phase(data_dir: str, tmp: str, patients: dict) -> dict:
    """``python -m rdst_tpu_torch.train`` (``cli.train_main``) of the
    shipped bf16 recipe (TRAIN_CONFIG: batch 32 of LR 24x24) for ZOO_STEPS
    steps each of RDST-N, ESTSR and WaveletSR on the train-pair kernels,
    and of Swin-MLP in f32 (no kernel): the routes, the first step on the
    kernel route against the plain bf16 route, the train-pair launches of
    the run (counts set to 0 just before, read just after), a finite,
    falling loss, steps/s and one profiled step. Then each snapshot the
    run saved: ``cli.test_main`` on patients 19-20 (f32, the f32 block's
    launches a forward) and served over HTTP (``_zoo_serve``)."""
    from rdst_tpu_torch.cli import build_trainer, train_main
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.kernels import block_train as bt
    from rdst_tpu_torch.kernels import pair_train as pt
    from rdst_tpu_torch.kernels import swin_block as sb
    from rdst_tpu_torch.serving.export import LiveModel

    out = {}
    for label, (over, pairs) in ZOO_TRAIN.items():
        over = {**over, "eva_metrics": "psnr ssim"}

        def argv(name, steps):
            return _train_argv(data_dir, os.path.join(tmp, "zoo", name),
                               steps) + [f"{k}={v!r}"
                                         for k, v in over.items()]

        row = {}
        slug = label.replace(" ", "_")
        probe = build_trainer(argv(f"{slug}_probe", 1))
        probe.setup()
        row["train_routes"] = dict(probe.model.train_routes)
        log(f"zoo {label}: train routes {probe.model.train_routes} "
            f"({probe.model.train_mode or 'plain'})")
        if probe.model.train_routes != {"pair": pairs, "block": 0}:
            raise AssertionError(f"zoo {label}: train routes "
                                 f"{probe.model.train_routes}")
        if pairs:
            batch = probe.ds_train.sample(np.random.default_rng(17))
            row.update(_first_step_vs_plain(probe, batch))
        del probe
        bt.launch_forward.launches = bt.launch_backward.launches = 0
        pt.launch_forward.launches = pt.launch_backward.launches = 0
        t0 = time.perf_counter()
        trainer = train_main(argv(slug, ZOO_STEPS))  # the main path
        torch.cuda.synchronize()
        row["run_s"] = time.perf_counter() - t0
        fwd, bwd = pt.launch_forward.launches, pt.launch_backward.launches
        losses = trainer.training_loss_records.get("WarmUP", [])
        row.update(forward_launches=fwd, backward_launches=bwd,
                   losses=losses)
        log(f"zoo {label}: {ZOO_STEPS} steps in {row['run_s']:.3f} s "
            f"(evaluations included), train-pair launches forward {fwd}, "
            f"backward {bwd}; loss {losses[0]:.5f} -> {losses[-1]:.5f}")
        if fwd != pairs * ZOO_STEPS or bwd != pairs * ZOO_STEPS or \
                bt.launch_forward.launches or bt.launch_backward.launches:
            raise AssertionError(f"zoo {label}: launches {fwd} / {bwd}")
        if len(losses) != ZOO_STEPS or not np.isfinite(losses).all() or \
                not np.mean(losses[-3:]) < np.mean(losses[:3]):
            raise AssertionError(f"zoo {label}: losses {losses} (the mean "
                                 "of the last 3 must fall below the first "
                                 "3's)")
        row["profile"] = _step_profile(trainer,
                                       label=f"zoo {label} training step")
        snap = os.path.join(trainer.dirs["models"], "WarmUP_model_g.msgpack")
        del trainer
        f32_over = {**over, "training_dtype": "float32"}
        counter = sb.fused_swin_block if pairs else None
        per = ZOO_F32_LAUNCHES[label]
        row["tester"] = _tester_row(
            f"zoo {label}", TRAIN_CONFIG, snap, data_dir, tmp, patients,
            counter, per, **f32_over)
        p = ParametersLoader(TRAIN_CONFIG)
        for k, v in f32_over.items():
            p.set(k, v)
        p.set("well_trained_single_scale_model_g", snap)
        live = LiveModel(p, max_batch=64, device="cuda")
        row["serving"] = _zoo_serve(live, counter, per)
        del live
        out[label] = row
    return out


def run_zoo(data_dir: str, tmp: str, patients: dict):
    """The model-zoo phases; returns (results, kernel rows: the kernels at
    the zoo's geometries with the launches of its main path)."""
    fwd = zoo_forward_phase()
    bf16 = zoo_bf16_phase(fwd)
    models = {label: _zoo_model(label) for label in
              ("WaveletSR", "ESTSR", "RDST-N")}
    kern = zoo_kernel_phase(models, bf16)
    del models
    train = zoo_train_phase(data_dir, tmp, patients)
    for row in fwd.values():
        row.pop("y")
    for label in ZOO_BF16:
        bf16.pop(label)
    wt = train["WaveletSR"]
    kernels = [
        _row("fused_swin_block (WaveletSR f32, C = 64, 4 heads)",
             "swin_block.cu", "rdst_tpu/kernels/swin_block.py:757",
             fwd["WaveletSR"]["launches"], kern["f32"]),
        _row("fused_swin_block (WaveletSR bf16 mode swin, C = 64, 4 heads)",
             "swin_block_fast.cu", "rdst_tpu/kernels/swin_block.py:757",
             bf16["WaveletSR swin"]["launches"], kern["fast"]),
    ] + _train_rows("fused_swin_pair_train (WaveletSR, C = 64)",
                    "pair_train.cu", "rdst_tpu/kernels/pair_train.py:293",
                    {"variants": kern["train_pair"]}, wt)
    for label in ("ESTSR", "RDST-N"):
        k = kern[label]
        kernels += [
            _row(f"fused_swin_block ({label} f32)", "swin_block.cu",
                 "rdst_tpu/kernels/swin_block.py:757",
                 fwd[label]["launches"], k["f32"]),
            _row(f"fused_rdstb ({label} bf16)", "rdstb_block.cu",
                 "rdst_tpu/kernels/rdstb_block.py:334",
                 bf16[f"{label} rdstb"]["launches"], k["rdstb"]),
        ] + _train_rows(f"fused_swin_pair_train ({label})", "pair_train.cu",
                        "rdst_tpu/kernels/pair_train.py:293",
                        {"variants": k["train_pair"]}, train[label])
    return {"forward": fwd, "bf16": bf16, "kernels": kern,
            "train": train}, kernels


# ---------------------------------------------------------------------------
# The convolutional model zoo (``--only convzoo``): SRResNet, SRDenseNet,
# RDN, ESRGAN, MDSR, RCAN, HAN, ConvNeXt-SR, ZSSR, DBPN, IPT and MetaSR on
# five more extractors, at the full width the factories build from the E1
# and MetaSR configs with KEY=VALUE overrides, on seeded weights

# label: (overrides, config, LR size of the 8 seeded slices (ZSSR: its
# HR-size input), the scales each forward runs at)
CONV_ZOO = {
    "SRResNet": ({"feature_generator": "srresnet"}, CONFIG, LR_HW, (4.0,)),
    "SRDenseNet": ({"feature_generator": "srdensenet"}, CONFIG, LR_HW,
                   (4.0,)),
    "RDN": ({"feature_generator": "rdn"}, CONFIG, LR_HW, (4.0,)),
    "ESRGAN": ({"feature_generator": "esrgan"}, CONFIG, LR_HW, (4.0,)),
    "MDSR": ({"feature_generator": "mdsr", "all_sr_scales": [2.0, 3.0, 4.0]},
             CONFIG, LR_HW, (2.0, 3.0, 4.0)),
    "RCAN": ({"feature_generator": "rcan"}, CONFIG, LR_HW, (4.0,)),
    "HAN": ({"feature_generator": "han"}, CONFIG, LR_HW, (4.0,)),
    "ConvNeXt-large": ({"feature_generator": "convnet-large"}, CONFIG, LR_HW,
                       (4.0,)),
    "ConvNeXt-lite": ({"feature_generator": "convnet-lite"}, CONFIG, LR_HW,
                      (4.0,)),
    "ZSSR": ({"feature_generator": "zssr", "lr_image_size_remain": True},
             CONFIG, (4 * LR_HW[0], 4 * LR_HW[1]), (4.0,)),
    "DBPN": ({"feature_generator": "dbpn"}, CONFIG, LR_HW, (4.0,)),
    # the position and query tables are sized by the 24x24 training patch
    "IPT": ({"feature_generator": "ipt", "all_sr_scales": [2.0, 3.0, 4.0],
             "tiled_inference": True}, CONFIG, (24, 24), (2.0, 3.0, 4.0)),
    **{f"MetaSR {e}": ({"meta_feature_generator": e}, METASR_CONFIG, LR_HW,
                       (1.5, 4.0))
       for e in ("SRResNet", "SRDenseNet", "RDN", "ESRGAN", "Meta_MDSR")},
}
# held in float64 on both sides: RCAN's hard gate flips at near-ties of
# 0.5 under float32 rounding, and a flip swaps a whole 3x3 conv output
CONV_ZOO_F64 = ("RCAN",)


def conv_zoo_paras(label: str, config=None, **kw):
    """The ParametersLoader of a CONV_ZOO family (its config, or
    ``config``, with its overrides and ``kw``)."""
    from rdst_tpu_torch.config import ParametersLoader

    over, cfg, _, _ = CONV_ZOO[label]
    p = ParametersLoader(config or cfg)
    for k, v in {**over, **kw}.items():
        p.set(k, v)
    return p


# CONV_ZOO_BARS: the JAX package's forward of each CONV_ZOO family on the
# CPU (XLA; float64 for CONV_ZOO_F64), from the same seeded weights and
# slices (zoo_weights, zoo_input), at each of its scales: the output's
# shape, sum, sum of squares, largest magnitude and 64 sampled pixels
# (zoo_stats). Made by
#     JAX_PLATFORMS=cpu python tools/jax_zoo_bars.py --conv
CONV_ZOO_BARS = {
    'SRResNet @4': {
        "shape": [8, 160, 128, 1], "sum": -8181.010401,
        "sumsq": 1517.565188, "absmax": 0.351170927,
        "pixels": [-0.179588079, 0.0234142654, -0.138542295, -0.134594172, -0.00366903469, -0.133286417, -0.0569653213, -0.00637333468, -0.184215531, -0.106904231, 0.0221896693, 0.0591505803, -0.196944043, 0.00439146534, -0.0890201777, -0.0157615654, -0.0660681129, -0.0756572485, -0.117002949, -0.264874071, 0.00875191763, -0.057723403, 0.045944266, 0.0289603863, -0.144200921, 0.0838668197, -0.137038812, -0.0844302326, -0.0116599761, -0.209051013, -0.117249109, -0.162532389, -0.096038647, -0.101237513, -0.109756552, 0.0577846877, -0.15802674, -0.0208082367, -0.0512861237, -0.0939852297, -0.0224280115, 0.00245776027, -0.0506851748, -0.0274053551, -0.0574963726, -0.00800156593, 0.00998957083, 0.198740482, -0.138567001, -0.0688942522, 0.0307372846, -0.0969381034, -0.0671723932, 0.0849721283, -0.210045666, -0.0845509395, -0.0566179007, -0.112386569, 0.0530636013, -0.14624466, -0.0889949054, -0.0625859648, 0.00315024331, -0.139694467]},
    'SRDenseNet @4': {
        "shape": [8, 160, 128, 1], "sum": 257.8194067,
        "sumsq": 14.45556723, "absmax": 0.0328147002,
        "pixels": [-0.00039443979, -0.00112678204, 0.0125802625, -0.0102311503, 0.00217774813, -0.00727154547, 0.00959565118, 0.00398112508, 0.00809696876, -0.000642430037, -0.00185128208, 0.014025568, -0.00654179975, 0.00457927492, 0.0132003166, 0.00215019425, 0.0124346809, -0.00199732883, 0.00413929159, -0.00742461346, 0.00279236888, -0.0129948668, -0.0141814528, 0.00710920244, 0.0157619491, -0.0213174112, -0.000523634604, 0.00290377717, 0.00307458267, -0.00238900352, 0.00863933377, 0.000278112479, -0.00546164857, 0.0108849751, 0.0204023216, 0.00417916477, 0.0185595956, 0.00449123653, -0.00304282573, -0.0037286235, 0.00929636601, 0.00896130037, 0.0115256868, 0.00350898062, -0.0028265398, -0.016665183, -0.00392778125, -0.0143979173, -0.00513889734, 0.00752452621, -0.0041545704, -0.00783933606, 0.000167152844, -0.0165427625, -0.00785968173, 0.00752799679, 0.00109005556, 0.00479503116, 0.00339609268, 0.0166051611, 0.0162173286, 0.00707289204, -0.00033827126, -0.00366771035]},
    'RDN @4': {
        "shape": [8, 160, 128, 1], "sum": -1395.253316,
        "sumsq": 934.094923, "absmax": 0.294931233,
        "pixels": [0.0958241001, 0.0375020467, -0.0227177665, -0.0422630087, 0.0538741238, 0.108182855, 0.00376707129, -0.0497965328, -0.00872792397, 0.0583829209, -0.0377657413, -0.0339904986, 0.0857057273, 0.0256450921, -0.00215395726, -0.0266358107, 0.0251833424, -0.204404771, -0.0372430384, -0.00618870556, -0.0294122621, -0.0986060947, -0.0231528487, -0.019025322, -0.0670769811, 0.0489357859, 0.104463495, 0.0557286665, -0.0445437543, -0.00872460008, -0.0309832767, 0.163236797, 0.179472521, 0.0501224324, -0.106008366, -0.0113244019, -0.0842040926, 0.0247297026, -0.0784579664, 0.105258398, -0.0412284583, 0.0485405326, 0.0859469771, 0.029358305, -0.0911436081, -0.0499828868, -0.0148240542, 0.0528039336, 0.122589149, -0.200392246, -0.0702938437, -0.133835137, 0.152118951, 0.00684752688, 0.103284627, -0.0377965495, -0.0105110668, -0.0287412275, 0.0407866165, -0.0926926732, -0.134951398, -0.0670478418, -0.0678622723, -0.126380056]},
    'ESRGAN @4': {
        "shape": [8, 160, 128, 1], "sum": -2102.413297,
        "sumsq": 6697.589115, "absmax": 0.733086646,
        "pixels": [0.0680673569, -0.0158074424, -0.14308995, 0.279683143, -0.140323594, 0.267547458, -0.105812967, -0.307869107, -0.385220408, -0.00901950896, -0.0478328466, 0.179303512, 0.113880694, -0.061080806, -0.104881078, -0.336589873, 0.02548966, -0.494582832, -0.353974164, 0.320979565, -0.10992907, 0.02541437, 0.14725329, -0.0605379976, -0.275597453, 0.2559807, 0.046106942, 0.101481155, 0.0914450139, 0.064071022, -0.114119425, 0.0164791495, 0.130867764, -0.130803123, -0.105343223, 0.0274308026, -0.320283413, -0.126976579, -0.0882211775, 0.097051017, -0.323508948, -0.0979487598, -0.0690090209, -0.114392161, 0.0552773327, 0.229641974, 0.185884476, 0.246804506, -0.0944310278, -0.0850887299, -0.0340980962, 0.118017688, -0.179697186, 0.340209842, -0.0556244254, -0.304293066, 0.145958185, 0.00877435505, 0.0607242957, -0.169043988, -0.344243884, -0.111684725, -0.0922509655, 0.0143547952]},
    'MDSR @2': {
        "shape": [8, 80, 64, 1], "sum": -1685.323665,
        "sumsq": 554.1049663, "absmax": 0.434791505,
        "pixels": [-0.239312068, 0.00680753961, -0.0553828627, -0.268634439, 0.0291954018, -0.129282385, -0.111464396, -0.00150413439, -0.0178300291, -0.0288955197, -0.116702706, -0.0441637486, -0.129686967, -0.0892081857, 0.140766352, -0.214803606, 0.15903765, -0.0649338067, -0.0604969934, -0.0361374319, -0.19695209, -0.148527175, 0.0703661516, -0.0573365688, 0.00161132589, -0.0252439231, 0.242539108, -0.19165504, -0.0751406401, -0.0154146701, -0.0942768306, -0.0752872825, -0.00919290259, -0.029282093, -0.039912194, 0.144436121, -0.0788800418, -0.0220517311, 0.0430063829, -0.0411709547, -0.26510334, 0.001984559, 0.008962892, -0.124664396, -0.0275187269, -0.0864188969, 0.298369735, 0.0241600648, 0.0161883477, -0.0624644458, -0.0680648983, -0.116968676, -0.0526270978, -0.0216869004, -0.02979552, -0.11501652, 0.233952194, 0.115278594, -0.0661856607, 0.00677154213, -0.0721179992, -0.0989709347, -0.0347544253, -0.00675196946]},
    'MDSR @3': {
        "shape": [8, 120, 96, 1], "sum": -2275.380474,
        "sumsq": 2473.595397, "absmax": 0.563992858,
        "pixels": [0.0409722328, -0.00916996971, -0.0622576252, 0.0511471331, 0.110316612, -0.097739026, -0.019230511, 0.0200170726, 0.101280972, 0.0173623115, -0.111375079, -0.315251172, -0.087891534, -0.12502709, -0.244235411, -0.174825639, 0.116644517, -0.00885477662, 0.00486567616, 0.302771449, -0.355766356, 0.0853902102, -0.0267463997, 0.0670723692, 0.0622078963, -0.0290933214, -0.141483456, 0.0132880062, -0.142077118, -0.167721242, 0.257870167, 0.0999283344, -0.252775699, -0.269881815, 0.0151407793, -0.00230515748, -0.146888942, 0.193542823, -0.233627111, -0.129941806, 0.236552685, 0.047360152, 0.0604585372, 0.213680357, 0.170990676, 0.241794169, 0.00308771431, 0.114871293, 0.0412458926, 0.0583423078, 0.0836946368, 0.133328453, -0.286755681, -0.0154631436, -0.216533512, 0.0879409611, -0.281529874, -0.0369769521, -0.02108071, -0.0329381526, -0.0313114226, -0.0383871645, -0.0224902425, -0.0730182752]},
    'MDSR @4': {
        "shape": [8, 160, 128, 1], "sum": 2664.493674,
        "sumsq": 1396.309579, "absmax": 0.342477173,
        "pixels": [-0.00127146393, -0.208778009, 0.191458106, 3.49991024e-05, 0.027427759, -0.0395768397, 0.0159678254, 0.0512421243, -0.000504806638, -0.00627780706, -0.207922071, 0.0743128657, 0.00461820513, 0.167518213, 0.0657018572, 0.128861979, 0.143099189, -0.0930009335, 0.0161321908, 0.0825415403, 0.129607484, 0.00181760639, 0.0128926504, -0.134904504, 0.105129242, 0.0549243689, -0.058024399, -0.0695565939, 0.151253358, -0.0199974477, 0.0117212385, -0.0115418956, -0.0316104181, -0.00283331238, 0.237079769, -0.207322359, 0.220149457, -0.0258209351, -0.0086851418, 0.000601761043, 0.171087965, 0.0929994062, 0.148188174, 0.224561334, -0.0437548272, 0.0264412351, -0.0329026245, 0.0404211953, 0.00156326592, 0.147750854, -0.0298618823, -0.0363299251, 0.0510182939, -0.0831026584, -0.0606502667, 0.00548273325, 0.0242658649, -0.0786205754, 0.0499195457, 0.129231632, 0.135205552, 0.143608108, -0.153786957, 0.034240678]},
    'RCAN @4': {
        "shape": [8, 160, 128, 1], "sum": -4658.725423,
        "sumsq": 7862.607006, "absmax": 0.970685362,
        "pixels": [0.189348921, -0.472089793, 0.218204638, -0.0356751474, 0.12913229, 0.239486205, -0.202279306, 0.323628147, 0.212380507, -0.098943539, -0.00276705565, -0.309635769, -0.0827241988, -0.0908353359, 0.0491808508, -0.172105141, 0.301972712, -0.127189054, 0.359406665, -0.362235902, -0.24626963, 0.00661735674, -0.323977034, -0.470722993, 0.173514187, 0.0233181847, 0.0989646616, 0.123863743, 0.0828219752, 0.0180241065, -0.237990154, 0.48679735, 0.128495914, -0.0928914642, -0.0638408756, -0.0448407577, 0.565642421, 0.0296940872, -0.0947943947, -0.106560643, -0.216873107, -0.28212693, 0.0474527074, -0.148527839, 0.0184989011, 0.2399881, -0.0944889622, 0.375020667, 0.14967867, -0.0500787758, 0.354883918, -0.232604675, 0.0857941697, 0.352635819, 0.01608439, 0.188860369, -0.0522226983, -0.312473658, -0.361967994, 0.358547676, 0.148254578, -0.440711941, -0.213881521, 0.0861669765]},
    'HAN @4': {
        "shape": [8, 160, 128, 1], "sum": -1897.273116,
        "sumsq": 3879.272208, "absmax": 0.635212183,
        "pixels": [0.0755273402, -0.0899338871, -0.196953773, -0.000425860286, 0.101144046, -0.291939944, 0.188966557, 0.106672123, -0.0747318715, 0.0871164799, -0.034547776, -0.0255621523, -0.181248158, -0.0321157873, 0.0824718699, 0.0515035428, -0.0551911965, 0.150707155, -0.00193472952, 0.306402624, 0.0241291337, -0.197229013, -0.0302094668, 0.0876992121, -0.0756228417, -0.134553954, 0.0701052547, -0.0141138434, -0.0197468475, -0.135980636, 0.139719695, 0.0824384838, 0.134130359, -0.0487422049, -0.240375817, -0.16129522, -0.232708544, 0.0783158541, 0.0289394669, 0.0869796872, -0.0437285714, -0.108385839, -0.148286894, -0.206733733, -0.112431936, 0.0154101215, 0.0797034055, 0.0315719694, 0.00291886926, -0.107993066, 0.0434876159, 0.00771368295, -0.0962409973, -0.156464607, -0.0708936974, 0.0499123335, 0.124448791, 0.136469334, 0.28292498, -0.00731083751, -0.111030698, -0.0778183043, -0.160938144, -0.0177981369]},
    'ConvNeXt-large @4': {
        "shape": [8, 160, 128, 1], "sum": 2865.160261,
        "sumsq": 2936.908799, "absmax": 0.471277535,
        "pixels": [-0.0369695798, -0.23435232, -0.149963126, -0.00817402825, 0.0151346773, 0.194629788, -0.356755555, -0.0605664924, -0.0367578268, 0.151349902, -0.283598065, 0.158780783, 0.0308628604, 0.0370091647, -0.254441381, -0.00361797586, 0.03969175, 0.205641776, -0.0227170736, 0.184352741, -0.0237655491, 0.113411069, 0.0289134905, -0.0443368442, -0.183351308, 0.01959702, 0.15436922, -0.109754823, 0.0386411399, 0.0606447607, -0.285483956, -0.0618203282, 0.0666472018, -0.198750824, -0.0511847213, -0.284991562, -0.195025802, -0.151883334, 0.130303353, 0.126592308, 0.0434923917, 0.0316152573, -0.0185498707, 0.0565718189, 0.102983676, 0.113243639, 0.00317487679, 0.0372161828, 0.0835364759, -0.0304859579, 0.143829525, 0.0506430641, 0.0460758507, -0.0764191449, -0.0420398489, 0.0617311001, -0.0451420061, -0.146910757, 0.0205618851, -0.261434019, -0.0589349866, 0.0462304279, -0.171345666, 0.054828614]},
    'ConvNeXt-lite @4': {
        "shape": [8, 160, 128, 1], "sum": -356.4110673,
        "sumsq": 2956.579437, "absmax": 0.55923146,
        "pixels": [-0.0130877122, 0.0238155685, 0.206853345, -0.00568184629, -0.023500964, -0.223587543, -0.0948647335, -0.0501310155, -0.142769873, -0.141361043, -0.113860667, 0.189393193, -0.157585174, 0.193693131, 0.0737014562, -0.0838982016, 0.021664314, 0.0912414864, -0.132044733, -0.458102137, 0.210378632, 0.169063106, -0.0188433602, -0.0270557255, 0.059397541, 0.0751920193, -0.17810747, 0.175100327, 0.0521740466, -0.0657979548, -0.0583624095, 0.0444041863, -0.142506093, 0.180559248, -0.0854916275, -0.0274996534, 0.165347993, -0.0610181987, 0.0606801212, -0.16826871, 0.0724859834, 0.0921488404, 0.202317327, 0.10687688, 0.157882616, 0.0329047367, -0.275415719, 0.0712161809, 0.0450203903, -0.0298650898, 0.0511047952, 0.114681549, -0.0254133642, 0.0818714201, 0.102939568, -0.108773001, -0.214511737, 0.0746127889, -0.0811329931, 0.0904734805, 0.0707260296, -0.0204962157, -0.120305203, 0.128122181]},
    'ZSSR @4': {
        "shape": [8, 160, 128, 1], "sum": 82106.43399,
        "sumsq": 54859.62701, "absmax": 1.0006566,
        "pixels": [0.0982755423, 0.964255869, 0.932216346, 0.83725071, 0.547544301, 0.1678572, 0.875437081, 0.844487965, 0.0812387019, 0.850864768, 0.144994408, 0.0621370822, 0.420090437, 0.0704617351, 0.521218956, 0.795456767, 0.046395462, 0.0131525379, 0.214660615, 0.283212692, 0.250896007, 0.824806333, 0.522928536, 0.522354186, 0.652484596, 0.853701472, 0.0553771853, 0.705937922, 0.870447874, 0.702010095, 0.605229199, 0.347314268, 0.831850111, 0.577298582, 0.176076472, 0.895626962, 0.470170945, 0.98034668, 0.565327287, 0.0416522659, 0.680038571, 0.596269608, 0.191014215, 0.00636910275, 0.701463103, 0.180592299, 0.170050442, 0.946258485, 0.161054224, 0.545756698, 0.504227161, 0.0320843495, 0.829095423, 0.827680528, 0.659476995, 0.530615866, 0.297567606, 0.160031319, 0.910203755, 0.130696625, 0.786398649, 0.257133067, 0.14930895, 0.0588137656]},
    'DBPN @4': {
        "shape": [8, 160, 128, 1], "sum": -18.99080675,
        "sumsq": 1.238383924, "absmax": 0.0107257729,
        "pixels": [-0.00174239278, 0.00459642103, -0.0039130277, -0.000862129964, 0.000582187669, 0.00136688794, 0.00324790948, -0.000607080758, -0.00263159303, 4.01725993e-06, 0.00586657412, -0.00415978767, 0.0030179373, -0.00308737392, 0.00400835462, 0.000853874953, -0.00120860187, 0.00259247026, -0.00290555693, -0.00176993455, 0.000398649601, 0.0037224344, -0.000492671097, 0.00347820949, -0.00170603162, -0.000196231878, 0.000250250683, -0.000815152307, -0.000283956877, -0.000807672273, 0.00376213714, -0.00177902589, -0.000591752352, 0.00617235852, -0.00592774153, 0.00313278753, -0.00528882956, 0.00158008817, -0.00239678868, 0.000184554316, -0.000619045924, 0.000850528188, -0.00110646884, 0.000163742341, 0.000741122232, 0.00335631589, -0.00342930388, 0.00147748541, -0.000359840575, -0.00425334554, 0.000464159122, 0.00274978881, -0.00188080897, 0.00208542612, -0.00229518488, -0.00290849432, -0.00213980349, 0.0043356237, -0.000530347228, -0.00520009175, -0.00726465043, 0.000583735062, 0.00758364052, 0.00199877471]},
    'IPT @2': {
        "shape": [8, 48, 48, 1], "sum": 623.3446388,
        "sumsq": 7286.380628, "absmax": 1.9895463,
        "pixels": [-0.251952231, 0.101469606, 0.840331674, -1.01450336, -0.524758816, 0.988187015, 1.13305116, -1.13251936, -0.277889669, -0.127117991, -0.359757453, 0.183348835, -0.0137056112, 0.147224993, 1.36912727, 0.45432502, -0.435409725, 0.483737111, 1.06254029, 0.0554380417, -0.959906578, -0.862573683, 0.301415622, -0.302327067, 0.140323132, -0.850013852, 0.203360096, 0.234915912, 0.790545464, -0.554596663, -0.988211453, 1.43927968, -0.478855669, -0.00650440156, 0.654848695, -0.3540093, 0.0669222027, 0.172685981, -0.25516516, -0.327219248, 0.0715426132, 0.404250711, 1.22360539, -0.264118791, 0.992623806, -0.325453997, -0.349031359, -0.465955257, 0.541098535, 0.257995605, -0.953842103, -0.670503616, 0.373420477, -0.374069512, 1.16181123, 1.10798931, -0.770211101, 0.2581833, -0.477027386, -1.00383914, -0.0108895898, 0.0727100521, 0.642609239, 0.977136254]},
    'IPT @3': {
        "shape": [8, 72, 72, 1], "sum": -5116.701862,
        "sumsq": 15811.46649, "absmax": 2.60779619,
        "pixels": [0.140902236, 0.067390427, -1.47500193, -1.53296971, 0.302000761, 0.0297961086, 0.149069399, -0.302784026, -0.597305775, 0.0725039244, 0.675885081, -0.982084632, -0.561484933, -0.658006608, 0.0935980082, 0.711750388, -0.604292035, -1.07344913, -1.3493154, 1.14169312, -0.947882771, -0.883770406, -0.754144788, -0.70509994, 0.0521653816, 0.0564458817, 0.356612742, -0.427262902, -0.301963687, 0.211634874, 0.748064995, -0.00891772658, 0.0697372407, 0.343115747, -0.253949612, -0.161695674, 0.0977082103, -0.144463465, -1.7407155, 0.180990174, -1.84509337, 0.919397831, -0.258486181, 0.4987652, -0.745507896, -0.37457341, 0.0609047711, -0.250898063, 1.0113852, -0.649742901, -0.395685077, 0.0904255211, 0.470260143, -0.180973172, -0.804213405, -1.44063306, -0.646108627, -0.573935449, -0.123110741, -0.0875036716, -1.2221806, 0.338481694, -0.094568789, -1.73762429]},
    'IPT @4': {
        "shape": [8, 96, 96, 1], "sum": -1343.539928,
        "sumsq": 8665.667791, "absmax": 1.14687824,
        "pixels": [-0.0200242624, 0.0224978626, -0.251577049, -0.768761396, 0.237770289, -0.0318393335, -0.106172673, -0.0471296795, -0.148407891, -0.522402585, -0.167591274, 0.152768865, 0.0304991603, -0.0432939529, 0.146514028, 0.40065518, -0.44659996, -0.0976723433, -0.818006039, 0.0897804648, -0.293989688, -0.303919524, -0.341583878, -0.147575334, -0.499540895, -0.0752435625, 0.0626665801, -0.650015533, 0.190607741, -0.258104712, 0.0071952939, -0.558722734, 0.311238736, -0.527527034, -0.119798228, 0.161267966, -0.0545457304, 0.236745656, -0.740858912, -0.117017031, 0.0951013267, -0.324582338, -0.571130753, 0.305310249, -0.784042716, -0.20777452, -0.547781348, 0.303377807, -0.35356915, 0.0647915006, 0.792583585, -0.117719807, -0.315967262, -0.168017, -0.243001178, 0.0840881914, 0.383452892, -0.475096941, -0.156052634, -0.499527156, 0.783379674, -0.043472182, 0.517914295, 0.067174986]},
    'MetaSR SRResNet @1.5': {
        "shape": [8, 60, 48, 1], "sum": -64.27298521,
        "sumsq": 6.973758237, "absmax": 0.0749855191,
        "pixels": [0.00137061626, -0.0107877953, -0.0300397221, -0.0158809796, 0.0176170263, -0.0102939829, 0.0202448927, -0.0256677717, -0.00711931288, -0.0218143389, -0.0335502364, -0.0139422752, -0.0316814259, -0.0254371166, 0.021643009, 0.000153563917, -0.00199560821, 0.00613260642, -0.0420010388, -0.00822400674, 0.00662256684, -0.0079324916, -0.0174733251, 0.0267029386, -0.00353281014, -0.0130055845, 0.0324985273, -0.0134642683, 0.0250259973, -0.00660554832, -0.0249711554, -0.0163374692, -0.00258018821, -0.0382596105, -0.0203874167, 0.0124744475, 0.00962736085, -0.0207785405, 0.0240358002, -0.00542358123, -0.017275773, 0.0157258008, -0.0131121203, -0.0127945133, 0.00836381316, -0.00364715164, -0.0304771345, 0.0131226815, 0.0010903962, 0.0335125178, 0.000569790602, -8.45454633e-05, 0.00401985273, -0.0348412059, 0.0100266337, 0.00880111009, -0.0224479102, 0.00776470965, -0.0154310493, 0.0173968151, -0.00540748145, -0.0193243027, 0.011327045, 0.000761598349]},
    'MetaSR SRResNet @4': {
        "shape": [8, 160, 128, 1], "sum": -1200.285493,
        "sumsq": 33.92807887, "absmax": 0.0629610047,
        "pixels": [-0.0063073663, -0.00764613599, -0.0186387822, -0.0207093842, -0.0026544407, -0.0182976089, -0.000745013356, -0.00977440551, -0.0254888572, -0.00286919437, -0.0112862736, 0.00291176513, -0.00348845869, -0.0116963116, 0.0075077191, 0.0218920428, -0.0154334111, -0.0020272322, -0.0186562836, 0.00964975171, 0.00452614669, -0.00865250081, -0.00333027169, -0.00117405504, -0.0135187469, -0.00364320725, -0.00392808393, -0.0116146524, -0.00320733385, -0.0210153833, -0.0040964298, -0.01125516, -0.00575413182, -0.0187351182, -0.0134679005, -0.0111805275, -0.0113610066, -0.018084459, -0.0191429369, -0.0113966092, 0.000499472022, 0.00130820367, -0.000261309091, 0.00585727766, -0.0302655529, -0.0233363565, 0.0034512151, -0.0081572216, -0.00583301857, -0.00666799676, -0.0193587393, -0.0172107518, -0.0250089131, -0.00871035457, -0.00920221582, -0.0258613154, -0.00851095095, -0.00882087648, -0.0104742758, -0.0180893317, -0.0184591338, 0.00643137284, -0.0102321431, -0.0302516297]},
    'MetaSR SRDenseNet @1.5': {
        "shape": [8, 60, 48, 1], "sum": -86.1952604,
        "sumsq": 0.7256788675, "absmax": 0.0196607672,
        "pixels": [-0.00196785806, -0.00481472723, -0.00201048004, -0.00218983414, -0.00305887568, 0.00220562192, -0.00336425425, 0.00337855145, -0.0137992166, 0.000240471214, -0.00198240438, -0.00710101333, -0.00189381884, -0.00628522225, -0.00301595777, -0.00762794632, 0.00178377051, -0.00764369592, -0.0042519737, 0.00150237023, -0.00669288542, 0.00638355967, 0.00985931698, -0.0080738049, -0.00845756568, -0.00659343321, -0.00191608083, -0.00557607692, -0.00226738863, 0.00235391897, -0.00224706437, 0.00214498909, -0.0076072393, -0.00632511731, -0.00927569531, -0.00278576976, 0.000860569533, 0.00206347601, -0.00190730009, -0.00352135859, -0.00686084945, -0.00836961996, -0.00336748734, -0.00632639881, -0.00784255378, -0.00678857695, -0.00582134817, 0.00319952704, -0.010489285, -0.00328856753, -0.000535381958, -0.00179179385, -0.00169948, -0.00598414522, 0.00110841147, -0.0093883872, -0.00924595818, -0.00833434798, -0.00207346282, -0.00609473092, -0.00201057503, -0.00233922433, -0.000652004033, -0.0038070851]},
    'MetaSR SRDenseNet @4': {
        "shape": [8, 160, 128, 1], "sum": -296.4795455,
        "sumsq": 1.862194769, "absmax": 0.0162001718,
        "pixels": [-0.00507985428, -0.0046581286, -0.00651163049, -0.0056088157, -0.00493931212, -0.00443296274, -0.0022552195, -0.000205432996, 0.00046183262, 0.00142412726, 0.00180423399, -0.0031253784, -0.00654660352, -0.00364241609, -0.00652344944, -0.004558763, -0.00405809376, -0.000612206524, -0.00332998019, 0.000252693659, -0.00111343525, -0.000940893311, -0.00396373123, -0.000898888335, -0.001193756, -0.00360551709, -0.00170808192, 0.000146894716, -0.00352584478, 0.00258257845, -0.000869709998, 0.00200763205, -0.00169589766, -0.000749060418, -0.00365862111, -0.00784633681, -0.00304282992, 0.00439973734, -0.00301827863, 0.00119644776, -0.00360239763, -0.000740727875, -0.000502551906, -0.00227882597, -0.000233681407, 0.000332586002, -0.00112941477, -0.00283777085, -0.00515104458, -0.00154748524, -0.00024030311, 0.00565700559, 0.00255445205, -0.00131582003, -0.0037456064, 0.00217276346, 0.00201598043, -0.00409625145, 0.000608996488, -0.00303431577, -0.000494404929, 0.00317805377, 0.00484949909, -0.00406042906]},
    'MetaSR RDN @1.5': {
        "shape": [8, 60, 48, 1], "sum": -833.4396468,
        "sumsq": 39.18002162, "absmax": 0.117841505,
        "pixels": [-0.0172849186, -0.0543067567, 0.00806770846, -0.0410786793, -0.027765099, -0.0429132208, -0.0108438823, -0.0455285646, -0.044317387, -0.0785028785, -0.0202304069, -0.0416494161, -0.0389887877, -0.0566607565, -0.0360717252, -0.0342087038, -0.0379928239, -0.0272056293, -0.0559139289, -0.0344105065, -0.0222197119, -0.0249823537, -0.0588158704, -0.0189944617, -0.04363418, -0.0241387598, -0.0133886188, -0.0425520316, -0.038640894, -0.0161110628, -0.0644442886, -0.0343508311, -0.0477902107, -0.0521085449, -0.0364350155, -0.0498950407, -0.0302648712, -0.0288595445, -0.00809641182, -0.0310425237, -0.0453376099, -0.0248783175, -0.0513914041, -0.0391767621, -0.0543312952, -0.0321504883, -0.0475675352, -0.0130434185, -0.0492014736, -0.0176517908, -0.04565534, -0.0825381353, -0.0300846063, -0.0531660989, -0.0219179466, -0.0354884714, -0.030324759, -0.0412053727, -0.0299769174, -0.0106452703, 0.024243759, -0.02780772, -0.0264262706, -0.00829321146]},
    'MetaSR RDN @4': {
        "shape": [8, 160, 128, 1], "sum": -3619.328546,
        "sumsq": 118.230821, "absmax": 0.10337846,
        "pixels": [-0.0564866066, -0.0461760089, -0.0113207893, -0.0402615666, -0.0327376984, -0.0434703156, -0.0193719231, -0.0164929293, -0.0233115032, -0.00974475127, -0.0312262774, -0.0154520124, -0.0120982938, -0.0312708132, -0.0346575156, -0.00548600964, -0.0170722082, -0.0070229494, -0.0246268511, -0.00909713563, -0.00901375245, -0.0333217345, -0.0117461281, -0.0495266616, -0.029186137, -0.0107800663, -0.0111792237, -0.038679108, -0.0270100366, -0.0211604014, -0.0244673118, -0.0525903031, -0.0155086666, -0.0344372056, -0.0229841508, -0.0302064735, -0.0346256122, -0.026162697, -0.0765192956, -0.00924309343, -0.034468703, -0.0109513905, -0.0131262783, -0.0115924031, -0.0303285904, -0.0138173625, -0.0140554914, -0.0455809906, -0.0329143703, -0.0352367088, -0.0414501913, -0.0258223545, -0.00130866538, -0.0219003875, -0.0421366394, -0.0241192374, -0.0125893438, -0.0537906066, -0.0310890432, -0.0120281046, -0.0269304682, -0.00322852004, -0.0165785421, -0.00111704692]},
    'MetaSR ESRGAN @1.5': {
        "shape": [8, 60, 48, 1], "sum": 1515.863917,
        "sumsq": 128.171281, "absmax": 0.227306709,
        "pixels": [0.122463673, 0.0424769446, 0.0381959826, 0.0986074433, 0.0794078186, 0.118436955, 0.00649850816, 0.111769721, 0.0498842746, 0.128007188, 0.0733417645, 0.0775957704, 0.12417978, 0.0533036701, 0.028455887, 0.119886532, 0.0904130563, 0.0734404624, 0.105098695, 0.120526642, 0.0456037372, 0.142716944, 0.0923353806, -0.0236481279, 0.0606195107, 0.0306628719, 0.0661903471, 0.0790038779, 0.0525533631, 0.0330263898, 0.0755164623, 0.059342321, 0.0356336385, 0.0426279269, 0.0590357147, 0.0215500668, 0.078363955, -0.00190524757, 0.103742741, 0.0433166772, 0.106970437, 0.0798992813, 0.117193818, 0.0631114691, -0.000514235348, 0.0617016964, 0.0501423813, 0.114640005, 0.0797914341, 0.0140484944, 0.0601654947, 0.0115902126, 0.0780150369, 0.142282099, 0.0607866608, 0.084660545, 0.0419746861, 0.0313060693, 0.035395138, 0.0541016869, 0.0926421955, 0.139068484, 0.0626973212, 0.0799007416]},
    'MetaSR ESRGAN @4': {
        "shape": [8, 160, 128, 1], "sum": 8114.584026,
        "sumsq": 572.6703641, "absmax": 0.226792991,
        "pixels": [0.0258007422, 0.0582239702, 0.0390086174, 0.0741215348, 0.0273127146, 0.067994535, 0.0878733397, 0.0614063293, 0.177658781, 0.0575776733, 0.138065964, 0.0117397718, 0.0691386163, 0.0222701989, 0.0416109823, 0.0958607048, 0.0437840521, 0.0514116138, 0.0503171124, 0.0440456048, 0.0287933964, 0.0260181148, 0.0208854824, 0.0582168326, 0.0196614098, 0.0643389225, 0.0641210079, 0.088345781, 0.0200864021, 0.0440673232, 0.0594282188, 0.0802999288, 0.0247488767, 0.0683232993, 0.0292596277, 0.0776461661, 0.0302165076, 0.0247196574, 0.0453749001, 0.0333049595, 0.0764772445, 0.00991754234, 0.00935498066, 0.0789124146, 0.0425271876, 0.0526202396, 0.0263020433, 0.0575778708, 0.0913847685, 0.0318380147, 0.107904837, 0.159858853, 0.0346548706, 0.0867204517, -0.00850403868, 0.18749024, 0.0351259671, 0.102782845, 0.0129256165, 0.0365415402, 0.0793930367, 0.0499495901, 0.0595329851, 0.0875758529]},
    'MetaSR Meta_MDSR @1.5': {
        "shape": [8, 60, 48, 1], "sum": -536.8369568,
        "sumsq": 21.65817994, "absmax": 0.111926667,
        "pixels": [-0.0271730442, -0.0229292139, -0.0185724534, -0.0159372799, -0.0198389068, -0.0223982483, -0.00664353557, -0.0385489576, -0.0610919669, -0.0290571693, -0.0268050954, -0.0429533646, -0.013814887, -0.0421028212, -0.0199835096, -0.0469761416, -0.0439521074, -0.0334526449, 0.00265082344, 0.000939153135, -0.00904188398, -0.0197754707, -0.0215847939, -0.0308581889, -0.0368534513, -0.0153664192, -0.000694398768, -0.0186571553, -0.0114903841, -0.0032753041, -0.0263647698, -0.00724223256, -0.0040118224, 0.00565375201, -0.0169744119, -0.0465558022, -0.014338675, 0.00454795174, -0.00089516025, 0.00251759775, -0.0491741374, -0.013192256, -0.0129644144, -0.0557954423, -0.0370766968, -0.0213487782, -0.0104015376, -0.0115569597, -0.0455472916, -0.00858144183, 0.00342736766, -0.0331930295, -0.0052119894, -0.0434580669, -0.0333588645, 0.00227914285, -0.0172407161, -0.00207098387, -0.010616295, -0.0172368903, -0.0290400274, -0.0405253582, 0.0122493887, -0.0335296914]},
    'MetaSR Meta_MDSR @4': {
        "shape": [8, 160, 128, 1], "sum": 36.34778948,
        "sumsq": 48.54600812, "absmax": 0.0999821872,
        "pixels": [-0.0206981339, -0.0336660445, 0.00120363012, -0.00941348635, 0.0126328561, 0.00376873091, 0.0336280912, 0.0323559791, 0.0141333565, -0.00508218538, -0.000505562872, 0.00217268756, 0.00561835989, -0.0105592003, 0.00309517607, 0.0212638881, -0.0155569725, 0.00355647877, -0.0196109135, -0.00615582056, -0.000127017964, 0.0307838358, -0.00381159782, 0.0612094328, 0.00210977858, 0.0100514684, -0.00741752051, 0.00898822676, -0.00420104386, 0.0345669538, 0.0274184775, 0.0236676, -0.0119429091, -0.0116237607, -0.00732182618, 0.0246952847, -0.0134231746, 0.04530368, 0.00373800844, -0.00689201429, -0.014645569, 0.00599404611, -0.0159478672, -0.0106739774, 0.023671655, 0.000368280336, 0.0192164332, -0.00384150445, 0.0035992898, -0.0355727375, -0.00537116453, 0.0305214077, 0.00621218979, 0.015040881, -0.00256073382, -0.00746239349, 0.00246725883, 0.0360226743, -0.0105247563, 0.00494638644, -0.0390486866, -0.00429693051, -0.0145667624, 0.0533953756]},
}
# the float64 families' bar, in place of ZOO_TOL, and their card-vs-CPU bar
# in place of MODEL_TOL: cuDNN and XLA in float64 differ by summation order
# only
CONV_ZOO_F64_TOL = 1e-9
# the families trained, tested and served: the CONFIG families from
# TRAIN_CONFIG (bf16 as shipped), the MetaSR ones from METASR_CONFIG (f32
# as shipped), each with its CONV_ZOO overrides
CONV_ZOO_TRAIN = ("SRResNet", "SRDenseNet", "RDN", "ESRGAN", "MDSR", "RCAN",
                  "HAN", "ConvNeXt-large", "ConvNeXt-lite", "ZSSR", "DBPN",
                  "IPT", "MetaSR RDN", "MetaSR Meta_MDSR")
CONV_ZOO_STEPS = 4
# the training runs' own overrides: IPT trains at a transformer's rate; at
# the E1 recipe's 1e-4 its loss rises from the first step on, in float32
# as in bf16 (0.37 -> 2.15 in 4 steps on the card)
CONV_ZOO_TRAIN_OVER = {"IPT": {"learning_rate": 1e-5}}
# ZSSR's batches are one whole slice each (``lr_image_size_remain``): it
# takes half the slices of one batch-32 step, and its loss is checked over
# 8 fixed one-slice batches
CONV_ZOO_ONE_SLICE_STEPS, CONV_ZOO_FIXED_SLICES = 16, 8
# slices of the 8 that the port's CPU forward takes (the card's forward of
# all 8 is held against CONV_ZOO_BARS), and of a batch that the first
# step's card-vs-CPU check takes
CONV_ZOO_CPU_SLICES = 1
# the card's forward device time and steps/s: warm iterations
CONV_ZOO_ITERS, CONV_ZOO_WALL_STEPS = 2, 1


def _port_counters() -> dict:
    """Every launch counter of the port's kernel wrappers."""
    from rdst_tpu_torch.kernels import block_train as bt
    from rdst_tpu_torch.kernels import pair_train as pt
    from rdst_tpu_torch.kernels import token_wgmma as tw

    return {**_zoo_counters(), "pair_train_fwd": pt.launch_forward,
            "pair_train_bwd": pt.launch_backward,
            "block_train_fwd": bt.launch_forward,
            "block_train_bwd": bt.launch_backward,
            "token_qkv": tw.qkv_gemm, "token_proj": tw.proj_ln,
            "token_mlp": tw.mlp, "token_adapter": tw.adapter}


def _zero(counters: dict) -> None:
    for c in counters.values():
        c.launches = 0


def _launched(counters: dict) -> dict:
    return {k: c.launches for k, c in counters.items() if c.launches}


def _conv_zoo_model(label: str, dtype=torch.float32, device="cuda",
                    state_dict=None):
    """A CONV_ZOO family built by ``build_generator`` from its config with
    its overrides, holding the seeded weights (``zoo_weights`` over its
    flax tree, carried in by ``convert``; or ``state_dict``, another
    build's), on ``device`` as the entry points resolve it
    (``device.resolve_device``: TF32 off). A CONV_ZOO_F64 family's f32
    module is cast to float64 (here only: no float64 mode on the main
    path) when ``dtype`` is float64."""
    from rdst_tpu_torch.device import resolve_device
    from rdst_tpu_torch.models import build_generator

    device = resolve_device(device)
    p = conv_zoo_paras(label)
    f64 = dtype == torch.float64
    model = build_generator(p, dtype=torch.float32 if f64 else dtype)
    model.load_state_dict(state_dict if state_dict is not None
                          else _seeded_sd(model, p.feature_generator))
    if f64:
        model.double()
        model.dtype = torch.float64
    return model.to(device).eval()


def _conv_forward(model, x: np.ndarray, scale, counters: dict,
                  device="cuda") -> np.ndarray:
    """One forward of ``model`` on ``x`` (cast to the model's dtype) at
    ``scale``: the output as float64 numpy; the port's kernel launches
    (counts set to 0 just before, read just after) must be none."""
    _zero(counters)
    dt = torch.float64 if model.dtype == torch.float64 else torch.float32
    with torch.inference_mode():
        y = model(torch.from_numpy(x).to(device, dt), scale)
        if device == "cuda":
            torch.cuda.synchronize()
    if _launched(counters):
        raise AssertionError(f"kernel launches in a kernel-less forward: "
                             f"{_launched(counters)}")
    return y.double().cpu().numpy()


def _versus_bars(y: np.ndarray, bar: dict) -> dict:
    got, big = zoo_stats(y), bar["absmax"]
    size = float(np.prod(bar["shape"]))
    return {"mean": abs(got["sum"] - bar["sum"]) / size / big,
            "mean_square": abs(got["sumsq"] - bar["sumsq"]) / size
            / big ** 2,
            "pixels": max(abs(a - b) for a, b in zip(got["pixels"],
                                                     bar["pixels"])) / big}


def _gate_masks(model) -> tuple:
    """Forward hooks on each RCAN AdaConv's gate conv: the list the masks
    (sigmoid < 0.5) of the next forwards go into, and the hooks."""
    from rdst_tpu_torch.models.rcan import AdaConv

    masks = []

    def hook(mod, inp, out):  # as AdaConv computes its mask
        masks.append(torch.sigmoid(out) < 0.5)

    return masks, [m.conv0.register_forward_hook(hook)
                   for m in model.modules() if isinstance(m, AdaConv)]


def _flips(masks: list, ref: list) -> int:
    return int(sum(int((a != b).sum()) for a, b in zip(masks, ref)))


@phase("convzoo f32 forwards")
def conv_zoo_forward_phase() -> dict:
    """Each CONV_ZOO family at full width on 8 seeded slices at each of
    its scales, in float32 (CONV_ZOO_F64: float64): against CONV_ZOO_BARS
    (the JAX package's forward on the CPU: mean, mean square and 64 pixels
    within ZOO_TOL, or CONV_ZOO_F64_TOL, of the largest magnitude) and
    against the port's CPU forward of the first CONV_ZOO_CPU_SLICES
    slice(s) (MODEL_TOL); no kernel launch a forward; one forward's device time by
    CUDA events. RCAN also runs in float32: its gates that differ from the
    float64 run's are counted, and its output's relative error reported
    (no bar)."""
    import copy

    counters = _port_counters()
    card = _card_line()
    out = {}
    for label, (_, _, hw, scales) in CONV_ZOO.items():
        f64 = label in CONV_ZOO_F64
        dtype = torch.float64 if f64 else torch.float32
        model = _conv_zoo_model(label, dtype)
        cpu = copy.deepcopy(model).cpu()
        x = zoo_input(hw).astype(np.float64 if f64 else np.float32)
        tol, cpu_tol = (CONV_ZOO_F64_TOL, CONV_ZOO_F64_TOL) if f64 else \
            (ZOO_TOL, MODEL_TOL)
        masks = ref = None
        if f64:
            ref, hooks = _gate_masks(model)
        for s in scales:
            key = f"{label} @{s:g}"
            y = _conv_forward(model, x, s, counters)
            if f64:
                for h in hooks:
                    h.remove()
            y_cpu = _conv_forward(cpu, x[:CONV_ZOO_CPU_SLICES], s, counters,
                                  "cpu")
            bar = CONV_ZOO_BARS[key]
            d = _versus_bars(y, bar)
            err = float(np.abs(y[:CONV_ZOO_CPU_SLICES] - y_cpu).max())
            xt = torch.from_numpy(x).cuda()
            with torch.inference_mode():
                ms = cuda_time_ms(lambda: model(xt, s), warmup=1,
                                  iters=CONV_ZOO_ITERS)
            row = {"dtype": str(dtype).split(".")[-1], "versus_jax": d,
                   "card_vs_cpu_max_abs_err": err, "absmax": bar["absmax"],
                   "ms": ms, "params": sum(q.numel()
                                           for q in model.parameters())}
            log(f"convzoo {key} ({row['params']} params, {row['dtype']}) 8 "
                f"x {hw} -> {y.shape}: vs the JAX forward (CONV_ZOO_BARS) "
                f"mean {d['mean']:.2e}, mean square {d['mean_square']:.2e}, "
                f"64 pixels {d['pixels']:.2e} of max|y| {bar['absmax']:.4f} "
                f"(bar {tol}); card vs CPU ({CONV_ZOO_CPU_SLICES} slice(s)) "
                f"{err:.3e} (tol {cpu_tol}); no kernel launch; forward "
                f"{ms:.3f} ms device ({card})")
            if list(y.shape) != bar["shape"] or not np.isfinite(y).all():
                raise AssertionError(f"convzoo {key}: {y.shape} vs "
                                     f"{bar['shape']}")
            if max(d.values()) > tol or err > cpu_tol:
                raise AssertionError(f"convzoo {key}: {row}")
            if f64:
                m32 = _conv_zoo_model(label, state_dict=model.state_dict())
                masks, hooks = _gate_masks(m32)
                y32 = _conv_forward(m32, x.astype(np.float32), s, counters)
                for h in hooks:
                    h.remove()
                row["f32_gate_flips"] = _flips(masks, ref)
                row["gates"] = int(sum(m.numel() for m in ref))
                row["f32_rel"] = _rel(torch.from_numpy(y32),
                                      torch.from_numpy(y))[:2]
                with torch.inference_mode():
                    row["f32_ms"] = cuda_time_ms(
                        lambda: m32(xt.float(), s), warmup=1,
                        iters=CONV_ZOO_ITERS)
                log(f"convzoo {key} in float32: {row['f32_gate_flips']} of "
                    f"{row['gates']} gates differ from the float64 run's; "
                    f"output vs float64 rel max {row['f32_rel'][0]:.3e} mean "
                    f"{row['f32_rel'][1]:.3e} (no bar); forward "
                    f"{row['f32_ms']:.3f} ms device")
                row["y32"] = y32
                row["masks"] = ref
                del m32, masks
            row["y"] = y
            out[key] = row
        out[f"{label} @{scales[0]:g}"]["state_dict"] = model.state_dict()
        del model, cpu
    return out


@phase("convzoo bf16 forwards")
def conv_zoo_bf16_phase(f32: dict) -> dict:
    """Each CONV_ZOO family in bfloat16 (the f32 build's weights) at its
    first scale on the same slices: against its float32 output (BF16_VS_F32_MAX / _MEAN), no
    kernel launch, one forward's device time. RCAN only reports: its gates
    that differ from the float64 run's and its relative error against
    float64."""
    counters = _port_counters()
    out = {}
    for label, (_, _, hw, scales) in CONV_ZOO.items():
        s, f64 = scales[0], label in CONV_ZOO_F64
        key = f"{label} @{s:g}"
        model = _conv_zoo_model(label, torch.bfloat16,
                                state_dict=f32[key].pop("state_dict"))
        x = zoo_input(hw)
        masks = hooks = None
        if f64:
            masks, hooks = _gate_masks(model)
        y = _conv_forward(model, x, s, counters)
        if f64:
            for h in hooks:
                h.remove()
        ref = f32[key]["y32" if f64 else "y"]
        rel = _rel(torch.from_numpy(y), torch.from_numpy(ref))[:2]
        xt = torch.from_numpy(x).cuda()
        with torch.inference_mode():
            ms = cuda_time_ms(lambda: model(xt, s), warmup=1,
                              iters=CONV_ZOO_ITERS)
        row = {"vs_f32_rel": rel, "ms": ms,
               "f32_ms": f32[key].get("f32_ms", f32[key]["ms"])}
        if f64:
            row["gate_flips"] = _flips(masks, f32[key]["masks"])
            row["vs_f64_rel"] = _rel(torch.from_numpy(y),
                                     torch.from_numpy(f32[key]["y"]))[:2]
            log(f"convzoo {key} bf16: {row['gate_flips']} gates differ from "
                f"the float64 run's; vs float64 rel max "
                f"{row['vs_f64_rel'][0]:.3e} mean {row['vs_f64_rel'][1]:.3e},"
                f" vs float32 rel max {rel[0]:.3e} (no bar); forward "
                f"{ms:.3f} ms device (f32 {row['f32_ms']:.3f})")
        else:
            log(f"convzoo {key} bf16: vs f32 rel max {rel[0]:.3e} mean "
                f"{rel[1]:.3e} (bars {BF16_VS_F32_MAX}, {BF16_VS_F32_MEAN});"
                f" forward {ms:.3f} ms device (f32 {row['f32_ms']:.3f})")
            if not np.isfinite(y).all() or rel[0] >= BF16_VS_F32_MAX or \
                    rel[1] >= BF16_VS_F32_MEAN:
                raise AssertionError(f"convzoo {key} bf16: {row}")
        out[key] = row
        del model
    return out


def _conv_batch(batch, n: int = CONV_ZOO_CPU_SLICES):
    """The first ``n`` slices of a host batch: (LR input, HR target)."""
    return (torch.from_numpy(np.asarray(batch["in"][:n])),
            torch.from_numpy(np.asarray(batch["out"][:n])))


def _conv_step_card_vs_cpu(trainer, batch, f64: bool = False) -> dict:
    """A step of the trainer's model as set up (before any training step)
    on the card against the port's CPU step from the same weights and the
    first CONV_ZOO_CPU_SLICES slices of ``batch``: the trainer's loss
    (TRAIN_LOSS_RTOL) and the global gradient norm (TRAIN_GRAD_TOL,
    relative). Each tensor's gradient is compared too and the worst
    logged, with no bar: the set-up biases are 0, so a ReLU fed by a conv
    of an all-zero background region sits at an exact tie, and a cuDNN
    algorithm's rounding (FFT, Winograd) there moves a bias gradient by
    O(1) of itself (IPT's 5x5 head convs: in float32 too). With ``f64``
    (RCAN, whose gates also tie) both steps run on float64 copies of the
    model on one slice and every tensor is held to CONV_ZOO_F64_TOL."""
    import copy

    model = trainer.model
    n = CONV_ZOO_CPU_SLICES
    if f64:
        model = copy.deepcopy(model).double()
        model.dtype, n = torch.float64, 1
    cpu = copy.deepcopy(model).cpu()
    x, y = _conv_batch(batch, n)
    if f64:
        x, y = x.double(), y.double()
    scale = trainer.batch_scale(batch)
    res = {}
    for dev, m in ((trainer.device, model), ("cpu", cpu)):
        m.train()
        pred = m(x.to(dev), scale)
        total, _ = trainer.loss(pred if f64 else pred.float(),
                                {"out": y.to(dev)}, "WarmUP")
        named = [(k, q) for k, q in m.named_parameters() if q.requires_grad]
        grads = torch.autograd.grad(total, [q for _, q in named],
                                    allow_unused=True)
        res[dev] = (float(total.detach()),
                    {k: torch.zeros(q.shape) if g is None  # another branch
                     else g.detach().double().cpu()
                     for (k, q), g in zip(named, grads)})
    (lk, gk), (lp, gp) = res[trainer.device], res["cpu"]
    gmax = max(float(g.abs().max()) for g in gp.values())
    rel, worst = max((float((gk[k] - b).abs().max())
                      / max(1e-5, float(b.abs().max()), 0.12 * gmax), k)
                     for k, b in gp.items())
    norms = [float(torch.sqrt(sum((g ** 2).sum() for g in gs.values())))
             for gs in (gk, gp)]
    norm_rel = abs(norms[0] - norms[1]) / norms[1]
    loss_tol, grad_tol = ((CONV_ZOO_F64_TOL, CONV_ZOO_F64_TOL) if f64 else
                          (TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL))
    log(f"first step card vs CPU ({'float64, ' if f64 else ''}{len(x)} "
        f"slice(s), scale {scale}): loss {lk:.9f} / {lp:.9f} (rtol "
        f"{loss_tol}); gradient norm {norms[0]:.9e} / {norms[1]:.9e}, rel "
        f"{norm_rel:.3e} (bar {grad_tol}); a tensor's gradient rel max "
        f"{rel:.3e} ({worst}{'; bar ' + str(grad_tol) if f64 else ''})")
    if abs(lk - lp) > loss_tol * abs(lp) or norm_rel > grad_tol or (
            f64 and rel >= grad_tol) or not np.isfinite(norms).all():
        raise AssertionError("card vs CPU on the first step")
    return {"first_loss_card": lk, "first_loss_cpu": lp,
            "grad_norm_card": norms[0], "grad_norm_cpu": norms[1],
            "grad_norm_rel": norm_rel, "first_grad_rel_max": rel,
            "first_grad_worst": worst, "first_step_float64": f64}


def _conv_batch_loss(trainer, batches) -> float:
    """The trainer's loss of its model (eval mode) over ``batches``, each
    weighted by its slices."""
    total, n = 0.0, 0
    trainer.model.eval()
    for batch in batches:
        x, y = _conv_batch(batch, len(batch["in"]))
        with torch.no_grad():
            pred = trainer.model(x.to(trainer.device),
                                 trainer.batch_scale(batch)).float()
            total += len(x) * float(trainer.loss(
                pred, {"out": y.to(trainer.device)}, "WarmUP")[0])
        n += len(x)
    return total / n


def _conv_zoo_tester(label: str, config: str, snap: str, data_dir: str,
                     tmp: str, counters: dict, **over) -> dict:
    """``cli.test_main`` on the card of one snapshot on the held-out
    patients (f32): the mean of each score at each test scale, finite,
    and no kernel launch (counts set to 0 just before, read just
    after)."""
    from rdst_tpu_torch.cli import test_main

    over = {"data_folder": data_dir, "verbose": False,
            "inference_dtype": "float32",
            "output_dir": os.path.join(tmp, "tester", label.replace(" ", "_")),
            "well_trained_single_scale_model_g": snap, **over}
    argv = ["--config-file", config] + [f"{k}={v!r}" for k, v in over.items()]
    _zero(counters)  # the tester's path starts here
    t0 = time.perf_counter()
    tester = test_main(argv)
    wall = time.perf_counter() - t0
    launched = _launched(counters)  # and ends here
    stacked = np.load(os.path.join(tester.output_root,
                                   "stacked_eva_reports.npy"),
                      allow_pickle=True).item()
    scores = {k: float(np.mean(v)) for k, v in stacked.items()}
    log(f"tester {label}: " + " ".join(f"{k} {v:.4f}" for k, v in
                                       sorted(scores.items()))
        + f" over {tester.patient_ids} ({wall:.3f} s; the weights are "
        f"{CONV_ZOO_STEPS} steps old: no quality bar)")
    if launched or not all(np.isfinite(v) for v in scores.values()):
        raise AssertionError(f"tester {label}: {scores}, launches {launched}")
    return {"scores": scores, "wall_s": wall,
            "tiled": bool(tester.paras.get("tiled_inference", False))}


@phase("convzoo training, tester and server")
def conv_zoo_train_phase(data_dir: str, tmp: str) -> dict:
    """``python -m rdst_tpu_torch.train`` (``cli.train_main``'s build,
    set-up and training) of each CONV_ZOO_TRAIN family for CONV_ZOO_STEPS
    steps (TRAIN_CONFIG, bf16 batch 32 of LR 24x24, or METASR_CONFIG,
    f32): between set-up and training, a step of the set-up model on the
    card against the port's CPU step (a slice of a fixed batch: loss and
    gradient norm; RCAN in float64 on one slice, every gradient); no
    kernel launch in the run (counts set to 0
    just before, read just after), finite losses, the fixed batch's loss
    (ZSSR: 8 fixed one-slice batches', after CONV_ZOO_ONE_SLICE_STEPS
    steps) lower after the run;
    steps/s and one profiled step. Then the snapshot it saved: ``cli.test_main``
    on patients 19-20 (IPT tiled) and served over HTTP at 1 / 8 / 64
    slices (ZSSR HR-size slices, IPT 24x24 tiles), each response equal to
    a direct predict."""
    from rdst_tpu_torch.cli import build_trainer
    from rdst_tpu_torch.serving.export import LiveModel

    counters = _port_counters()
    out = {}
    for label in CONV_ZOO_TRAIN:
        over, cfg, hw, _ = CONV_ZOO[label]
        config = TRAIN_CONFIG if cfg == CONFIG else cfg
        over = {**over, **CONV_ZOO_TRAIN_OVER.get(label, {}),
                "eva_metrics": "psnr ssim"}
        slug = label.replace(" ", "_")
        steps = (CONV_ZOO_ONE_SLICE_STEPS if over.get("lr_image_size_remain")
                 else CONV_ZOO_STEPS)
        argv = _train_argv(data_dir, os.path.join(tmp, "convzoo", slug),
                           steps, config) + [
            f"{k}={v!r}" for k, v in over.items()]
        times = {}
        t0 = time.perf_counter()
        # cli.train_main's steps, with the checks on the set-up model
        # between its set-up and its training
        trainer = build_trainer(argv)
        trainer.setup()
        times["setup"] = time.perf_counter() - t0
        rng = np.random.default_rng(SEED + 7)
        fixed = [trainer.ds_train.sample(rng)]
        while len(fixed) * len(fixed[0]["in"]) < CONV_ZOO_FIXED_SLICES:
            fixed.append(trainer.ds_train.sample(rng))
        t0 = time.perf_counter()
        row = {"dtype": str(trainer.model.dtype).split(".")[-1],
               **_conv_step_card_vs_cpu(trainer, fixed[0],
                                        label in CONV_ZOO_F64),
               "init_loss": _conv_batch_loss(trainer, fixed)}
        times["card_vs_cpu"] = time.perf_counter() - t0
        _zero(counters)
        t0 = time.perf_counter()
        trainer.train()  # the main path
        torch.cuda.synchronize()
        row["run_s"] = times["run"] = time.perf_counter() - t0
        launched = _launched(counters)
        losses = trainer.training_loss_records.get("WarmUP", [])
        row["losses"] = losses
        row["trained_loss"] = _conv_batch_loss(trainer, fixed)
        log(f"convzoo {label}: {steps} {row['dtype']} steps in "
            f"{row['run_s']:.3f} s (evaluations included), no kernel "
            f"launch; loss {losses[0]:.5f} -> {losses[-1]:.5f} (each batch "
            "at its own scale where the scale is drawn a batch); on "
            f"{len(fixed)} fixed batch(es) at scale "
            f"{trainer.batch_scale(fixed[0])} {row['init_loss']:.5f} -> "
            f"{row['trained_loss']:.5f}")
        if launched:
            raise AssertionError(f"convzoo {label}: launches {launched}")
        if len(losses) != steps or not np.isfinite(losses).all() \
                or not row["trained_loss"] < row["init_loss"]:
            raise AssertionError(f"convzoo {label}: losses {losses}, on the "
                                 f"fixed batch {row['init_loss']} -> "
                                 f"{row['trained_loss']}")
        t0 = time.perf_counter()
        row["profile"] = _step_profile(
            trainer, label=f"convzoo {label} training step",
            wall_steps=CONV_ZOO_WALL_STEPS, host=False)
        times["profile"] = time.perf_counter() - t0
        snap = os.path.join(trainer.dirs["models"], "WarmUP_model_g.msgpack")
        del trainer
        t0 = time.perf_counter()
        row["tester"] = _conv_zoo_tester(label, config, snap, data_dir, tmp,
                                         counters, **over)
        times["tester"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        p = conv_zoo_paras(label, config, inference_dtype="float32",
                           well_trained_single_scale_model_g=snap)
        live = LiveModel(p, max_batch=64, device="cuda")
        row["serving"] = _zoo_serve(live, counters, 0, hw, timed=1)
        del live
        times["serving"] = time.perf_counter() - t0
        row["seconds"] = times
        log(f"convzoo {label}: seconds " + ", ".join(
            f"{k} {v:.2f}" for k, v in times.items()))
        out[label] = row
    return out


def run_conv_zoo(data_dir: str, tmp: str):
    """The convolutional model-zoo phases; returns (results, kernel rows:
    none, these families run no kernel of the port)."""
    fwd = conv_zoo_forward_phase()
    bf16 = conv_zoo_bf16_phase(fwd)
    for row in fwd.values():
        for k in ("y", "y32", "masks", "state_dict"):
            row.pop(k, None)
    torch.cuda.empty_cache()
    train = conv_zoo_train_phase(data_dir, tmp)
    return {"forward": fwd, "bf16": bf16, "train": train}, []


# ---------------------------------------------------------------------------
# Reference torch checkpoints and SwinIR's other heads (``--only ckpt``):
# phases 46-48

# the families whose reference torch layout ``checkpoint.torch_import``
# maps: label -> (overrides, config, LR size of the 8 seeded slices (ZSSR:
# its HR-size input), the scale each forward runs at, training config):
# the CONV_ZOO families of CONFIG at their factory widths and EDSR on
# seeded weights (``zoo_weights``), RDST-E1 and SwinIR-std on their
# committed weights (CKPT_WEIGHTS)
CKPT = {
    **{label: (over, CONFIG, hw, scales[-1], TRAIN_CONFIG)
       for label, (over, cfg, hw, scales) in CONV_ZOO.items()
       if cfg == CONFIG},
    "EDSR": ({"feature_generator": "edsr"}, CONFIG, LR_HW, 4.0,
             TRAIN_CONFIG),
    "RDST-E1": ({}, CONFIG, LR_HW, 4.0, TRAIN_CONFIG),
    "SwinIR-std": ({}, SWINIR_CONFIG, LR_HW, 4.0, SWINIR_TRAIN_CONFIG),
}
CKPT_WEIGHTS = {"RDST-E1": WEIGHTS, "SwinIR-std": SWINIR_WEIGHTS}
# bf16 training steps from each ``.pt`` warm start
CKPT_STEPS = 1
# SwinIR-std (embed 180, 6 x 6 blocks, 6 heads, window 8, MLP 2) with
# another head, on seeded weights: label -> (overrides of SWINIR_CONFIG /
# SWINIR_TRAIN_CONFIG, size of the 8 seeded slices). The ape table holds
# the 24x24 training patch's tokens: it runs at that size only (the tester
# tiles by it); the denoise head maps an HR-size slice (in = res) to its
# own size
SIR = {
    "SwinIR nearest+conv": ({"sir_upsampler": "nearest+conv"}, LR_HW),
    "SwinIR ape": ({"sir_ape": True, "tiled_inference": True}, (24, 24)),
    "SwinIR denoise": ({"sir_upsampler": "", "lr_image_size_remain": True},
                       (4 * LR_HW[0], 4 * LR_HW[1])),
}
SIR_STEPS = 6
# SIR_BARS: the JAX package's float32 forward of each SIR variant on the
# CPU (XLA), from the same seeded weights and slices (zoo_weights,
# zoo_input): zoo_stats of the output. Made by
#     JAX_PLATFORMS=cpu python tools/jax_zoo_bars.py --swinir
SIR_BARS = {
    'SwinIR nearest+conv': {
        "shape": [8, 160, 128, 1], "sum": -888.8633187,
        "sumsq": 8.220472248, "absmax": 0.0271553081,
        "pixels": [0.0035339552, -0.0086291898, -0.00556190126, -0.00306459353, -0.00183424761, -0.00353735918, -0.00249536708, -0.0143382307, 0.000685391482, -0.0160963926, -0.00829975307, -0.00257518794, -0.00385776255, -0.00341007393, -0.00820783526, -0.0137956571, -0.0075207036, -0.00755792623, -0.00243895408, -0.00530031789, -0.00251886155, -0.0105377696, 0.00495590363, -0.0192404967, -0.0125296535, -0.00972451549, -0.00478187157, -0.0138380341, -0.00458013033, -0.00559465447, -0.00376049662, -0.00371190812, -0.00321958726, 0.0012890622, -0.0106390379, -0.00395180145, -0.000856245868, -0.00238313247, -0.0116271451, -0.0037518898, -0.00677995989, 0.00356466975, -0.00809031166, -0.00678392686, -0.00805648789, -0.011780723, -0.00853987783, -0.00254592486, -0.00591307599, 0.00205292855, -0.000678928103, -0.00186407287, 0.00425634347, -0.000773173757, -0.00757876365, -0.00182991195, -0.00991445407, -0.00713126734, -0.00165558327, -0.0130957831, -0.0117825679, -0.00772671681, 0.00270214118, -0.00842527486]},
    'SwinIR ape': {
        "shape": [8, 96, 96, 1], "sum": 552.3927973,
        "sumsq": 166.3749774, "absmax": 0.186518744,
        "pixels": [0.0590303019, 0.0575623512, 0.0339336842, 0.0201113224, -0.0195352584, 0.04664547, 0.0151133817, 0.000163458288, 0.0122158695, -0.0234963633, 0.0751282722, 0.0789694935, 0.0321946256, -0.0143515132, 0.00659000501, 0.0037702173, -0.0500791594, 0.021211518, -0.0102653382, 0.00827559084, 0.0476918295, 0.0464990363, -0.025162911, 0.0210324526, 0.0903230309, 0.00522163324, 0.0677632019, -0.082932882, -0.0692233592, 0.0346651524, 0.00883214083, -0.0466390923, 0.0420414433, -0.00231983187, 0.038539838, -0.000514532439, -0.00847417116, 0.0393985659, 0.0509051904, 0.0065144971, 0.0228110794, -0.0456160009, 0.0328052007, -0.00886569172, 0.084706597, -0.0142539144, -0.0326915979, -0.109245509, -0.011431383, 0.0371735767, -0.0173679627, -0.0560494512, 0.0156422965, 0.05863408, -0.00595508516, 0.0153366607, 0.0381556973, 0.0364268571, 0.0453401469, 0.0860476047, 0.0478198975, 0.0259100106, -0.00206865557, 0.0849385336]},
    'SwinIR denoise': {
        "shape": [8, 160, 128, 1], "sum": 47203.45803,
        "sumsq": 35958.69325, "absmax": 1.56120682,
        "pixels": [0.00354389846, 0.849937975, 1.08806849, 0.974204719, 0.189178854, -0.236640215, 0.667575598, 0.6404652, -0.353642344, 0.446175545, -0.0697598457, -0.0348735526, 0.131037086, -0.204288274, 0.0362573862, 0.575449824, -0.14471969, -0.565179706, -0.25878796, 0.0625181049, 0.074352771, 0.532051206, 0.237461865, 0.312684655, 0.790530682, 0.584638298, -0.26723057, 0.619852662, 0.492959946, 0.396426201, 0.692207158, 0.175642163, 0.439824104, 0.64429915, 0.228776276, 0.736110687, 0.544927418, 0.598243773, 0.233426809, -0.388070554, 0.732549071, 0.444718003, -0.286969423, -0.486233592, 0.698521495, -0.0975131392, 0.0742995143, 0.611685514, -0.315099597, 0.423890054, 0.326488197, -0.384842992, 0.57563138, 0.220553577, 0.352350771, 0.332799256, 0.230384007, 0.0651903898, 1.09453881, -0.171855122, 0.438265979, -0.181664199, -0.317086995, -0.573765516]},
}


def _ckpt_paras(label: str, config=None, **kw):
    """The ParametersLoader of a CKPT or SIR label (its config, or
    ``config``, with its overrides and ``kw``)."""
    from rdst_tpu_torch.config import ParametersLoader

    over, cfg = (CKPT[label][:2] if label in CKPT
                 else (SIR[label][0], SWINIR_CONFIG))
    p = ParametersLoader(config or cfg)
    for k, v in {**over, **kw}.items():
        p.set(k, v)
    return p


def _seeded_snapshot(label: str, path: str) -> str:
    from rdst_tpu_torch.checkpoint.msgpack_writer import write_snapshot
    from rdst_tpu_torch.models import build_generator

    p = _ckpt_paras(label)
    model = build_generator(p)
    model.load_state_dict(_seeded_sd(model, p.feature_generator))
    write_snapshot(path, model.state_dict())
    return path


def _manifest(live) -> dict:
    return {k: v for k, v in live.manifest.items() if k != "entries"}


@phase("reference torch checkpoints")
def ckpt_reference_phase(data_dir: str, tmp: str) -> dict:
    """Each CKPT family: its msgpack snapshot served by ``LiveModel``
    (f32), written as the reference network's ``.pt`` by
    ``torch_export.save_torch_checkpoint`` (``reference_template``; the
    snapshot's ``.stats.json`` sidecar copied beside it), read
    back by the tester's loader (``load_well_trained_params``) and by
    ``LiveModel``: their weights and both forwards of 8 seeded slices on
    the card equal the msgpack-loaded model's bit for bit
    (``torch.equal``; on cuDNN's deterministic algorithms where two
    forwards of one model differ on its default ones), the manifests
    equal; then CKPT_STEPS bf16 training steps (``train_step`` of the
    trainer that ``cli.build_trainer`` builds) from a ``pre_trained_g``
    warm start on the ``.pt``: the set-up model holds the file's weights
    (bf16-rounded), the losses are finite."""
    from rdst_tpu_torch.checkpoint import torch_export, torch_import
    from rdst_tpu_torch.checkpoint.loading import load_well_trained_params
    from rdst_tpu_torch.cli import build_trainer
    from rdst_tpu_torch.models import build_generator
    from rdst_tpu_torch.serving.export import LiveModel

    out = {}
    for label, (over, _, hw, scale, train_config) in CKPT.items():
        t0 = time.perf_counter()
        d = os.path.join(tmp, "ckpt", label.replace(" ", "_"))
        os.makedirs(d, exist_ok=True)
        snap = CKPT_WEIGHTS.get(label) or _seeded_snapshot(
            label, os.path.join(d, "g.msgpack"))
        p = _ckpt_paras(label, inference_dtype="float32",
                        well_trained_single_scale_model_g=snap)
        live = LiveModel(p, max_batch=8, device="cuda")
        arch = torch_import.mapper_arch(p.feature_generator)
        pt = os.path.join(d, "g.pt")
        torch_export.save_torch_checkpoint(
            live.model, pt, arch, *torch_export.mean_std(live.model),
            template=torch_export.reference_template(live.model, arch),
            **torch_import.mapper_kwargs(p, arch))
        keys = len(torch.load(pt, weights_only=True))
        # the snapshot's stats sidecar travels with it (the audited logit
        # bound that resolves pallas_softmax='auto'; without it a .pt
        # resolves to the exact 'stable_bc')
        sidecar = os.path.splitext(snap)[0] + ".stats.json"
        if os.path.exists(sidecar):
            shutil.copy(sidecar, os.path.join(d, "g.stats.json"))
        p_pt = _ckpt_paras(label, inference_dtype="float32",
                           well_trained_single_scale_model_g=pt)
        tested = load_well_trained_params(
            build_generator(p_pt, *torch_export.mean_std(live.model)), p_pt,
            pt, live.manifest["scales"]).to(live.device).eval()
        live_pt = LiveModel(p_pt, max_batch=8, device="cuda")
        x = torch.from_numpy(zoo_input(hw)).cuda()
        sd = live.model.state_dict()
        weights = all(torch.equal(m[k], v)
                      for m in (tested.state_dict(), live_pt.model.state_dict())
                      for k, v in sd.items())
        # cuDNN's default algorithms may sum in a run-dependent order
        # (DBPN's transposed convolutions do): where two forwards of one
        # model differ, the forwards compared bit for bit run on its
        # deterministic algorithms
        with torch.inference_mode():
            want = live.model(x, scale)
            repeat = torch.equal(want, live.model(x, scale))
            torch.backends.cudnn.deterministic = not repeat
            try:
                if not repeat:
                    want = live.model(x, scale)
                got = [tested(x, scale), live_pt.model(x, scale)]
                torch.cuda.synchronize()
            finally:
                torch.backends.cudnn.deterministic = False
        equal = [torch.equal(g, want) for g in got]
        same = _manifest(live) == _manifest(live_pt)
        ref = {k: v.detach() for k, v in live.model.named_parameters()}
        del live, live_pt, tested
        row = {"arch": arch, "pt_keys": keys, "weights_equal": weights,
               "bitwise_equal": equal, "default_algorithms_repeat": repeat,
               "manifest_equal": same, "out_shape": list(want.shape),
               "absmax": float(want.abs().max())}
        t1 = time.perf_counter()
        argv = _train_argv(data_dir, os.path.join(d, "train"), CKPT_STEPS,
                           train_config) + [
            f"{k}={v!r}" for k, v in {
                **over, **CONV_ZOO_TRAIN_OVER.get(label, {}),
                "eva_metrics": "psnr ssim", "pre_trained_g": pt}.items()]
        trainer = build_trainer(argv)
        trainer.setup()
        warm = all(torch.equal(q.detach(), ref[k].to(q.dtype))
                   for k, q in trainer.model.named_parameters())
        rng = np.random.default_rng(SEED + 46)
        losses = []
        for _ in range(CKPT_STEPS):
            total, _, ok = trainer.train_step(trainer.ds_train.sample(rng),
                                              "WarmUP")
            losses.append(float(total))
        row.update(warm_start_equal=warm, losses=losses,
                   train_dtype=str(trainer.model.dtype).split(".")[-1],
                   seconds=[t1 - t0, time.perf_counter() - t1])
        del trainer
        torch.cuda.empty_cache()
        log(f"ckpt {label} ({arch}): {keys} reference keys; the .pt's "
            f"weights equal the msgpack model's {weights}; forward of 8 x "
            f"{hw} at x{scale:g} -> {row['out_shape']} bitwise equal to the "
            f"msgpack model's: tester loader {equal[0]}, LiveModel "
            f"{equal[1]} (on cuDNN's default algorithms: {repeat}, else its "
            f"deterministic ones); manifests equal {same}; "
            f"{CKPT_STEPS} "
            f"{row['train_dtype']} steps from pre_trained_g = the .pt "
            f"(weights as in the file: {warm}): losses "
            + ", ".join(f"{v:.5f}" for v in losses)
            + f" ({row['seconds'][0]:.2f} + {row['seconds'][1]:.2f} s)")
        if not (weights and all(equal) and same and warm
                and np.isfinite(losses).all()):
            raise AssertionError(f"ckpt {label}: {row}")
        out[label] = row
    return out


def _sir_model(label: str, dtype, sd=None, device="cuda", **kw):
    """A SIR variant built by ``build_generator`` from SWINIR_CONFIG with
    its overrides (and ``kw``), holding the seeded weights (or ``sd``), on
    ``device`` as the entry points resolve it."""
    from rdst_tpu_torch.device import resolve_device
    from rdst_tpu_torch.models import build_generator

    device = resolve_device(device)
    model = build_generator(_ckpt_paras(label, **kw), dtype=dtype)
    model.load_state_dict(sd if sd is not None else
                          _seeded_sd(model, "swinir"))
    return model.to(device).eval()


def _block_train_at(blk, images: int, x_size, gen, label: str) -> dict:
    """The block-train forward and backward kernels with ``blk``'s
    weights on ``images`` images of ``x_size`` (unshifted, 'clamp', no
    factor columns) against the plain version and its autograd
    (BF16_TOL); the forward and the backward launch alone timed beside
    their plain versions and bounds."""
    from rdst_tpu_torch.kernels import block_train as bt

    c, nw = blk.dim, (x_size[0] // 8) * (x_size[1] // 8)
    params, bias = blk.fast_kernel_inputs(tuple(x_size), 8, 0)
    ops = [q.detach().float().contiguous() for q in params] + \
        [bias.detach().float().contiguous()]
    x, dz = (torch.randn(images * nw, 64, c, device="cuda",
                         generator=gen).to(torch.bfloat16) for _ in range(2))
    row = _block_train_variant(f"{label} block train C={c} at {images} x "
                               f"{tuple(x_size)} ({images * nw} windows)",
                               ops, x, dz, None, "clamp", nw=nw)
    times, fp, pb, _, code = _block_train_forward_times(x, ops, "clamp")
    row.update(times)
    row["bwd_ms"] = cuda_time_ms(lambda: bt.launch_backward(
        x, dz, fp, pb, None, 6, code), warmup=1, iters=5)
    leaves = [t.detach().clone().requires_grad_(True) for t in [x, *fp, pb]]
    twin = bt.block_train_reference(leaves[0], type(fp)(*leaves[1:9]),
                                    leaves[9], None, num_heads=6,
                                    softmax="clamp")
    row["plain_bwd_ms"] = cuda_time_ms(lambda: torch.autograd.grad(
        twin, leaves, dz, retain_graph=True), warmup=1, iters=3)
    del twin, leaves
    wbytes = sum(t.numel() * t.element_size() for t in [*fp, pb])
    row["bwd_bound_ms"], row["bwd_bound_by"] = _bound(
        2 * _block_flops(x.shape[0], c), 3 * x.numel() * 2 + 3 * wbytes)
    row["windows"] = images * nw
    log(f"  forward {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, bound "
        f"{row['bound_ms']:.4f} {row['bound_by']}), backward "
        f"{row['bwd_ms']:.4f} ms (plain {row['plain_bwd_ms']:.4f}, bound "
        f"{row['bwd_bound_ms']:.4f} {row['bwd_bound_by']})")
    return row


def _sir_tester(label: str, snap: str, data_dir: str, tmp: str) -> dict:
    """``cli.test_main`` on the card (bf16, int8 qkv, as SWINIR_CONFIG
    ships) of a SIR variant's snapshot on the held-out patients: finite
    scores, the fast block's launches a whole number of forwards."""
    from rdst_tpu_torch.cli import test_main
    from rdst_tpu_torch.kernels import swin_block

    over = {**SIR[label][0], "data_folder": data_dir, "verbose": False,
            "eva_metrics": "psnr ssim",
            "output_dir": os.path.join(tmp, "tester", label.replace(" ", "_")),
            "well_trained_single_scale_model_g": snap}
    argv = ["--config-file", SWINIR_CONFIG] + [f"{k}={v!r}"
                                               for k, v in over.items()]
    swin_block.run_fast_block.launches = 0  # the tester's path starts here
    t0 = time.perf_counter()
    tester = test_main(argv)
    wall = time.perf_counter() - t0
    n = swin_block.run_fast_block.launches  # and ends here
    stacked = np.load(os.path.join(tester.output_root,
                                   "stacked_eva_reports.npy"),
                      allow_pickle=True).item()
    scores = {k: float(np.mean(v)) for k, v in stacked.items()}
    log(f"tester {label}: " + " ".join(f"{k} {v:.4f}" for k, v in
                                       sorted(scores.items()))
        + f" over {tester.patient_ids} ({wall:.3f} s, {n} fast-block "
        "launches; seeded weights: no quality bar)")
    if not n or n % 36 or not all(np.isfinite(v) for v in scores.values()):
        raise AssertionError(f"tester {label}: {scores}, launches {n}")
    return {"scores": scores, "wall_s": wall, "launches": n}


@phase("SwinIR heads at SwinIR-std width")
def sir_variant_phase(label: str, data_dir: str, tmp: str) -> dict:
    """A SIR variant on the seeded weights: in f32 (every block on the f32
    block kernel, 36 a forward) against SIR_BARS (the JAX package's CPU
    forward: ZOO_TOL of max|y|) and against the plain f32 path on the
    card (MODEL_TOL); in bf16 with int8 qkv (the fast block, 36 a
    forward) against its plain versions (the same model on the CPU, one
    slice: BF16_TOL) and against f32 (the bf16-vs-f32 bars), each
    forward's device time; the denoise head's f32 and fast blocks alone at its 2,560
    windows; SIR_STEPS bf16 training steps from SWINIR_TRAIN_CONFIG (the
    block-train kernels, 36 + 36 a step) and those kernels alone at the
    step's geometry; the tester on patients 19-20 and HTTP at 1 / 8 / 64
    slices from the seeded snapshot (bf16, int8 qkv)."""
    from rdst_tpu_torch.checkpoint.msgpack_writer import write_snapshot
    from rdst_tpu_torch.cli import build_trainer
    from rdst_tpu_torch.kernels import block_train as bt
    from rdst_tpu_torch.kernels import pair_train as pt
    from rdst_tpu_torch.kernels import swin_block
    from rdst_tpu_torch.nn.swin import set_block_kernels
    from rdst_tpu_torch.serving.export import LiveModel

    over, hw = SIR[label]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 47)
    x = zoo_input(hw)
    xt = torch.from_numpy(x).cuda()
    m32 = _sir_model(label, torch.float32, inference_dtype="float32",
                     pallas_kernels="swin")
    y32, n32 = _zoo_forward(m32, x, SCALE)
    set_block_kernels(m32, False)
    y_plain, n_plain = _zoo_forward(m32, x, SCALE)
    set_block_kernels(m32, True)
    bar = SIR_BARS[label]
    d = _versus_bars(y32, bar)
    err32 = float(np.abs(y32 - y_plain).max())
    with torch.inference_mode():
        ms32 = cuda_time_ms(lambda: m32(xt, SCALE), warmup=1, iters=3)
    row = {"f32": {"launches": n32["f32"], "versus_jax": d,
                   "kernel_vs_plain_max_abs_err": err32, "ms": ms32,
                   "absmax": bar["absmax"], "shape": list(y32.shape)}}
    log(f"{label} f32 8 x {hw} -> {y32.shape}: vs the JAX forward "
        f"(SIR_BARS) mean {d['mean']:.2e}, mean square "
        f"{d['mean_square']:.2e}, 64 pixels {d['pixels']:.2e} of max|y| "
        f"{bar['absmax']:.4f} (bar {ZOO_TOL}); kernel vs plain {err32:.3e} "
        f"(tol {MODEL_TOL}); f32 block launches a forward {n32['f32']} "
        f"(plain {n_plain['f32']}); {ms32:.3f} ms device")
    if list(y32.shape) != bar["shape"] or not np.isfinite(y32).all() or \
            max(d.values()) > ZOO_TOL or err32 > MODEL_TOL:
        raise AssertionError(f"{label} f32: {row['f32']}")
    if n32["f32"] != 36 or n_plain["f32"] or sum(n32.values()) != 36:
        raise AssertionError(f"{label} f32 launches {n32} / {n_plain}")
    sd = {k: v.detach().cpu() for k, v in m32.state_dict().items()}
    if label == "SwinIR denoise":
        blk = m32.layers[0].residual_group.blocks[0]
        row["f32_block"] = _f32_block_at(blk, 0, len(x), hw, gen)
    del m32

    m16 = _sir_model(label, torch.bfloat16, sd)
    softmax, quant = m16.softmax, m16.quant
    y16, n16 = _zoo_forward(m16, x, SCALE)
    # the kernels' plain versions: the same model on the CPU, where each
    # wrapper takes its plain version (bf16, int8 qkv); one slice
    cpu = _sir_model(label, torch.bfloat16, sd, device="cpu")
    with torch.inference_mode():
        y_cpu = cpu(torch.from_numpy(x[:CONV_ZOO_CPU_SLICES]),
                    SCALE).float().numpy()
    del cpu
    kp = _rel(torch.from_numpy(y16[:CONV_ZOO_CPU_SLICES]),
              torch.from_numpy(y_cpu))[:2]
    kf = _rel(torch.from_numpy(y16), torch.from_numpy(y32))[:2]
    with torch.inference_mode():
        ms16 = cuda_time_ms(lambda: m16(xt, SCALE), warmup=1, iters=3)
    row["bf16"] = {"launches": n16["swin"], "vs_plain_versions_rel": kp,
                   "vs_f32_rel": kf, "ms": ms16, "softmax": softmax,
                   "int8": sorted(quant)}
    log(f"{label} bf16 mode swin ({softmax}, int8 {sorted(quant)}): "
        f"{n16['swin']} fast-block launches a forward; vs the plain "
        f"versions (the same model on the CPU, {CONV_ZOO_CPU_SLICES} "
        f"slice(s)) rel max {kp[0]:.3e} mean {kp[1]:.3e} (bar {BF16_TOL}); "
        f"vs f32 rel max {kf[0]:.3e} mean {kf[1]:.3e} (bars "
        f"{BF16_VS_F32_MAX}, {BF16_VS_F32_MEAN}); {ms16:.3f} ms device")
    if not np.isfinite(y16).all() or kp[0] > BF16_TOL or n16["swin"] != 36 \
            or sum(n16.values()) != 36 or quant != frozenset({"qkv"}) or \
            kf[0] >= BF16_VS_F32_MAX or kf[1] >= BF16_VS_F32_MEAN:
        raise AssertionError(f"{label} bf16: {row['bf16']}, {n16}")
    if label == "SwinIR denoise":
        blk = m16.layers[0].residual_group.blocks[0]
        row["fast_block"] = _fast_block_at(blk, len(x), hw, gen, softmax,
                                           quant, bound=True)
    del m16
    torch.cuda.empty_cache()

    argv = _swinir_train_argv(data_dir, os.path.join(
        tmp, "sir", label.replace(" ", "_")), SIR_STEPS) + [
        f"{k}={v!r}" for k, v in {**over, "eva_metrics": "psnr ssim"}.items()]
    trainer = build_trainer(argv)
    trainer.setup()
    routes = dict(trainer.model.train_routes)
    rng = np.random.default_rng(SEED + 48)
    batches = [trainer.ds_train.sample(rng) for _ in range(SIR_STEPS)]
    counters = (bt.launch_forward, bt.launch_backward, pt.launch_forward,
                pt.launch_backward)
    for cnt in counters:
        cnt.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    losses = [trainer.train_step(b, "WarmUP")[0] for b in batches]
    losses = [float(v) for v in losses]
    train_s = time.perf_counter() - t0
    fwd, bwd, pfwd, pbwd = (cnt.launches for cnt in counters)  # ends here
    geo = tuple(batches[0]["in"].shape[:3])
    row["train"] = {"routes": routes, "forward_launches": fwd,
                    "backward_launches": bwd, "losses": losses,
                    "batch": list(geo), "seconds": train_s}
    log(f"{label} {SIR_STEPS} bf16 steps on {geo} batches in "
        f"{train_s:.3f} s: train routes {routes}, block-train calls "
        f"forward {fwd}, backward {bwd}, train pair {pfwd + pbwd}; losses "
        + ", ".join(f"{v:.5f}" for v in losses))
    if routes != {"pair": 0, "block": 36} or fwd != 36 * SIR_STEPS or \
            bwd != 36 * SIR_STEPS or pfwd + pbwd or \
            not np.isfinite(losses).all():
        raise AssertionError(f"{label} training: {row['train']}")
    blk = trainer.model.layers[0].residual_group.blocks[0]
    row["block_train"] = _block_train_at(blk, geo[0], geo[1:], gen, label)
    del trainer
    torch.cuda.empty_cache()

    snap = os.path.join(tmp, "sir", label.replace(" ", "_") + ".msgpack")
    write_snapshot(snap, sd)
    row["tester"] = _sir_tester(label, snap, data_dir, tmp)
    live = LiveModel(_ckpt_paras(label,
                                 well_trained_single_scale_model_g=snap),
                     max_batch=64, device="cuda")
    row["manifest"] = _manifest(live)
    row["serving"] = _zoo_serve(live, swin_block.run_fast_block, 36, hw,
                                timed=1)
    del live
    torch.cuda.empty_cache()
    return row


def run_ckpt(data_dir: str, tmp: str):
    """Phases 46-48; returns (results, kernel rows: the SwinIR heads'
    f32 and fast blocks at the denoise head's 2,560 windows, the
    block-train kernels at the heads' training geometries)."""
    ref = ckpt_reference_phase(data_dir, tmp)
    heads = {label: sir_variant_phase(label, data_dir, tmp) for label in SIR}
    dn = heads["SwinIR denoise"]
    rows = [
        _row("fused_swin_block (SwinIR denoise f32, C = 180, 2,560 windows)",
             "swin_block.cu", "rdst_tpu/kernels/swin_block.py:757",
             dn["f32"]["launches"], [dn["f32_block"]]),
        _row("fused_swin_block_fast (SwinIR denoise bf16, C = 180, int8 "
             "qkv, 2,560 windows)", "swin_block_fast.cu",
             "rdst_tpu/kernels/swin_block.py:757", dn["bf16"]["launches"],
             [dn["fast_block"]]),
    ]
    rows += _train_rows(
        "fused_swin_block_train (SwinIR heads)", "block_train.cu",
        "rdst_tpu/kernels/block_train.py:307",
        {"variants": [h["block_train"] for h in heads.values()]},
        {k: sum(h["train"][k] for h in heads.values())
         for k in ("forward_launches", "backward_launches")})
    return {"reference": ref, "heads": heads}, rows


# ----------------------------------------------------------------------------
# Data parallelism (``--only parallel``): the data axis of ``mesh_shape`` on
# an explicit device list that repeats the one card, ``['cuda:0',
# 'cuda:0']`` (``rdst_tpu_torch.parallel``): two trainer ranks over gloo,
# one over NCCL through the same code, two tester and server replicas

DP_DEVICES = ["cuda:0", "cuda:0"]
DP_STEPS = 5  # E1 recipe steps each way (phase 49)
DP_GAN_STEPS = 2  # RaGAN fine-tune steps each way
# the f32 RaGAN run on 2 ranks against 1: the loss within 1e-4 (PERF.md
# section 2's f32 bar); the gradient, from Adam's first moment, relative
# max as phase 12 measures it within 5e-3. The discriminator updates before
# the generator's loss, and its Adam moves each entry whose gradient is
# rounding noise by up to its learning rate either way: that alone moves
# the generator's gradient by ~1e-3 (a one-rank step against itself on the
# card 6.5e-4 in some calls, 2 ranks against 1 7.9e-4 - 9.3e-4), where a
# missing gather, sum or average moves it by O(1). Each bar is at least
# twice the one-rank run's difference from itself in the same call.
DP_F32_RTOL, DP_F32_GRAD = 1e-4, 5e-3
# SR slices of the 2-replica tester against one device's, of max|y|
DP_TESTER_TOL = 1e-6
# E1's kernel launches a forward: 48 f32 blocks, 8 RDSTBs in bf16
DP_PER_FORWARD = {"float32": 48, "bfloat16": 8}


def _dp_runs(runs, devices, spawned: bool = True):
    """``parallel.probe.record_runs`` of ``runs`` ((argv, out_dir) pairs)
    on ``devices``: spawned ranks of a new process group, or this process
    (one device, ``spawned`` False); returns each run's records by rank
    and the seconds."""
    from rdst_tpu_torch.parallel import probe
    from rdst_tpu_torch.parallel.launch import spawn

    t0 = time.perf_counter()
    if spawned:
        spawn(probe.record_runs, devices, runs, devices)
    else:
        probe.record_runs(runs, devices)
    world = len(devices)
    wall = time.perf_counter() - t0
    return [[probe.load(out, r) for r in range(world)] for _, out in runs], wall


def _dp_grads(rec, b1: float) -> np.ndarray:
    mu = rec["mu"]
    prev = np.concatenate([np.zeros_like(mu[:1]), mu[:-1]])
    return (mu - b1 * prev) / (1 - b1)


def _dp_delta(got: dict, want: dict, lr: float) -> dict:
    """A run's steps against another's: the largest relative loss
    difference, the gradient's relative max as phase 12 measures it
    (tensor by tensor, of max(its max, 0.12 x the step's max)), and the
    parameters' largest difference, also over their bar: 2 lr a step
    (Adam moves an entry by less than lr a step in each run, and one whose
    gradient is rounding noise may move either way) and float32
    rounding."""
    g, gw = _dp_grads(got, 0.9), _dp_grads(want, 0.9)
    dloss = float(np.max(np.abs(got["loss"] - want["loss"])
                         / np.abs(want["loss"])))
    cuts = np.cumsum(want["numels"])[:-1]
    rel = 0.0
    for a, b in zip(g, gw):
        gmax = float(np.abs(b).max())
        rel = max(rel, max(
            float(np.abs(x - y).max()) / max(1e-5, float(np.abs(y).max()),
                                             0.12 * gmax)
            for x, y in zip(np.split(a, cuts), np.split(b, cuts))))
    dp = np.abs(got["params"] - want["params"])
    steps = np.arange(1, len(want["loss"]) + 1)[:, None]
    pbar = 2 * lr * steps + 2.0 ** -22 * np.abs(want["params"])
    return {"loss_rel": dloss, "grad_rel": rel, "params_max": float(dp.max()),
            "params_over_bar": float((dp / pbar).max())}


def _dp_held(label: str, got: dict, want: dict, lr: float, bf16: bool,
             spread: dict) -> dict:
    """:func:`_dp_delta` against the one-rank run within the loss and
    gradient bars (bf16 TRAIN_LOSS_RTOL / TRAIN_GRAD_TOL, f32 DP_F32_RTOL /
    DP_F32_GRAD, each at least twice the one-rank run's own difference from
    itself on the card in this call, ``spread``) and the parameters within
    their bar."""
    out = _dp_delta(got, want, lr)
    loss_tol, grad_tol = ((TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL) if bf16
                          else (DP_F32_RTOL, DP_F32_GRAD))
    loss_tol = max(loss_tol, 2 * spread["loss_rel"])
    grad_tol = max(grad_tol, 2 * spread["grad_rel"])
    log(f"  {label}: loss rel {out['loss_rel']:.3e} (bar {loss_tol}), "
        f"gradient rel {out['grad_rel']:.3e} (bar {grad_tol}), parameters "
        f"max {out['params_max']:.3e} ({out['params_over_bar']:.3f} of 2 lr "
        "a step)")
    if out["loss_rel"] > loss_tol or out["grad_rel"] > grad_tol or \
            out["params_over_bar"] > 1:
        raise AssertionError(f"{label} against one rank: {out}")
    return out


def _dp_ranks(label: str, ranks: list, steps: int, pair_launches: int):
    """The ranks of one run: every step applied, the generator's flat
    parameters and Adam moment bitwise equal across ranks, each rank's
    train-pair launches (``pair_launches`` a step each way)."""
    for r in ranks:
        ln = r["launches"]
        log(f"  {label} rank {int(r['rank'])} of {int(r['world'])}: "
            f"train-pair launches forward {ln['pair_forward']}, backward "
            f"{ln['pair_backward']}; rows a step {r['rows'].tolist()}; "
            f"{float(r['steps_per_s']):.3f} steps/s of host time "
            "(ranks sharing one card: not a speed result)")
        if not r["ok"].all() or len(r["loss"]) != steps:
            raise AssertionError(f"{label}: steps {r['ok']}")
        if ln["pair_forward"] != pair_launches * steps or \
                ln["pair_backward"] != pair_launches * steps:
            raise AssertionError(f"{label}: launches {ln}")
    for key in ("loss", "params", "mu"):
        if any(not np.array_equal(r[key], ranks[0][key]) for r in ranks):
            raise AssertionError(f"{label}: ranks differ in {key}")
    if any(not np.array_equal(r["d_state"], ranks[0]["d_state"])
           for r in ranks):
        raise AssertionError(f"{label}: the ranks' discriminators differ")


@phase("data-parallel training")
def dp_train_phase(data_dir: str, tmp: str, devices) -> dict:
    """Phase 49: the shipped bf16 E1 recipe, DP_STEPS steps (a) in this
    process, (b) on a rank a device of ``devices`` (DP_DEVICES: 2 gloo
    ranks on the one card), (c) on 1 NCCL rank, the RaGAN fine-tune
    DP_GAN_STEPS steps on 1 rank and on ``devices``; the one-rank runs
    once more in this process for the card's own run-to-run spread
    (logged, no bar)."""
    from rdst_tpu_torch.parallel.mesh import backend_for

    e1_lr, gan_lr = 1e-4, 2e-5  # the two configs' learning_rate

    def e1(out):
        return _train_argv(data_dir, out, DP_STEPS) + [
            f"check_every={DP_STEPS}"], out

    def gan(out):
        return _ft_argv(GAN_CONFIG, data_dir, out,
                        {"GAN-FT": DP_GAN_STEPS}, check=DP_GAN_STEPS), out

    runs = {}
    log(f"backends: {len(devices)} ranks on {devices} "
        f"{backend_for(devices)}, 1 rank on {devices[:1]} "
        f"{backend_for(devices[:1])}")
    one = devices[:1]  # an explicit list: the default spans every GPU
    (runs["a"], runs["a_gan"]), t_a = _dp_runs(
        [e1(os.path.join(tmp, "dp_a")), gan(os.path.join(tmp, "dp_a_gan"))],
        one, spawned=False)
    (runs["a2"], runs["a2_gan"]), _ = _dp_runs(
        [e1(os.path.join(tmp, "dp_a2")),
         gan(os.path.join(tmp, "dp_a2_gan"))], one, spawned=False)
    (runs["b"], runs["b_gan"]), t_b = _dp_runs(
        [e1(os.path.join(tmp, "dp_b")), gan(os.path.join(tmp, "dp_b_gan"))],
        devices)
    (runs["c"],), t_c = _dp_runs([e1(os.path.join(tmp, "dp_c"))],
                                 devices[:1])
    log(f"runs (E1 {DP_STEPS} + RaGAN {DP_GAN_STEPS} steps, evaluations and "
        f"start-up included): one rank {t_a:.3f} s, {len(devices)} ranks "
        f"{t_b:.3f} s, 1 NCCL rank (E1 only) {t_c:.3f} s")
    out = {"seconds": {"a": t_a, "b": t_b, "c": t_c}}
    _dp_ranks("(a) E1 one rank", runs["a"], DP_STEPS, 24)
    _dp_ranks(f"(b) E1 {len(devices)} ranks", runs["b"], DP_STEPS, 24)
    _dp_ranks("(c) E1 1 NCCL rank", runs["c"], DP_STEPS, 24)
    _dp_ranks("RaGAN one rank", runs["a_gan"], DP_GAN_STEPS, 0)
    _dp_ranks(f"RaGAN {len(devices)} ranks", runs["b_gan"], DP_GAN_STEPS, 0)
    if any(list(r["rows"]) != [n // len(devices)
                               for n in runs["a"][0]["rows"]]
           for r in runs["b"]):  # 16 of the batch's 32 on each of 2 ranks
        raise AssertionError(f"rows {[r['rows'] for r in runs['b']]}")
    a = runs["a"][0]
    for key, (got, want, lr) in {
            "E1": (runs["a2"][0], a, e1_lr),
            "RaGAN": (runs["a2_gan"][0], runs["a_gan"][0], gan_lr)}.items():
        out[f"spread_{key}"] = d = _dp_delta(got, want, lr)
        log(f"  {key} one rank run twice (the card's run-to-run spread): "
            f"loss rel {d['loss_rel']:.3e}, gradient rel {d['grad_rel']:.3e}"
            f", parameters max {d['params_max']:.3e} "
            f"({d['params_over_bar']:.3f} of 2 lr a step)")
    out["b"] = _dp_held(f"(b) E1 {len(devices)} ranks vs (a)", runs["b"][0],
                        a, e1_lr, True, out["spread_E1"])
    out["c"] = _dp_held("(c) E1 1 NCCL rank vs (a)", runs["c"][0], a, e1_lr,
                        True, out["spread_E1"])
    out["gan"] = _dp_held(f"RaGAN {len(devices)} ranks vs 1", runs["b_gan"][0],
                          runs["a_gan"][0], gan_lr, False, out["spread_RaGAN"])
    out["launches"] = {k: [r["launches"] for r in v] for k, v in runs.items()}
    out["steps_per_s"] = {k: [float(r["steps_per_s"]) for r in v]
                          for k, v in runs.items()}
    return out


def _replica_launches(replicas, counter) -> list:
    """Per replica, the launches of ``counter`` its forwards make (forward
    hooks around each replica's call; the replicas run one after
    another)."""
    tally = [0] * len(replicas)
    state = {}
    for i, m in enumerate(replicas):
        m.register_forward_pre_hook(
            lambda mod, args: state.__setitem__("n", counter.launches))

        def post(mod, args, out, i=i):
            tally[i] += counter.launches - state["n"]
        m.register_forward_hook(post)
    return tally


@phase("data-parallel tester")
def dp_tester_phase(data_dir: str, tmp: str, devices) -> dict:
    """Phase 50: the tester over ``devices`` (a replica a device) against
    one device, E1 f32 and bf16 on the held-out patients."""
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.kernels import rdstb_block, swin_block
    from rdst_tpu_torch.runners.tester import SRTester

    out = {}
    for label, dtype, counter in (
            ("E1 f32", "float32", swin_block.fused_swin_block),
            ("E1 bf16", "bfloat16", rdstb_block.run_rdstb)):
        per, res = DP_PER_FORWARD[dtype], {}
        for name, devs in (("one", devices[:1]), ("two", devices)):
            p = ParametersLoader(CONFIG)
            for k, v in {"data_folder": data_dir, "verbose": False,
                         "output_dir": os.path.join(tmp, "dp_tester", name,
                                                    dtype),
                         "well_trained_single_scale_model_g": WEIGHTS,
                         "inference_dtype": dtype}.items():
                p.set(k, v)
            t = SRTester(p, device="cuda", devices=devs)
            t.setup()
            tally = _replica_launches(t.replicas, counter)
            counter.launches = 0  # the tester's path starts here
            t0 = time.perf_counter()
            stacked = t.test()
            wall = time.perf_counter() - t0
            vols = np.concatenate([np.load(os.path.join(
                t.dirs["inference_results"], f"{pid}_inference_results.npz"))
                ["x4.0"] for pid in t.patient_ids])
            res[name] = {"scores": {m: float(np.mean(stacked[f"{m}_4.0"]))
                                    for m in ("psnr", "ssim")},
                         "launches": tally, "wall_s": wall, "sr": vols}
            log(f"  tester {label} on {t.mesh}: PSNR "
                f"{res[name]['scores']['psnr']:.4f} SSIM "
                f"{res[name]['scores']['ssim']:.4f} over {len(vols)} slices, "
                f"{counter.__name__} launches by replica {tally} "
                f"({per} a forward), run {wall:.3f} s")
            if any(n != per * len(t.patient_ids) for n in tally):
                raise AssertionError(f"tester {label}: launches {tally}")
        one, two = res["one"], res["two"]
        err = float(np.abs(two["sr"] - one["sr"]).max()
                    / np.abs(one["sr"]).max())
        digits = all(f"{two['scores'][m]:.4f}" == f"{one['scores'][m]:.4f}"
                     for m in ("psnr", "ssim"))
        log(f"  tester {label}: {len(devices)} replicas against one device: "
            f"SR slices "
            f"max err {err:.3e} of max|y| (bar {DP_TESTER_TOL}); printed "
            f"digits equal: {digits}")
        if err > DP_TESTER_TOL or not digits:
            raise AssertionError(f"tester {label} on {devices}")
        out[label] = {k: {kk: vv for kk, vv in v.items() if kk != "sr"}
                      for k, v in res.items()}
        out[label]["sr_err"] = err
    return out


@phase("data-parallel serving")
def dp_serving_phase(devices) -> dict:
    """Phase 51: the HTTP server on a live model over ``devices`` against
    the one-replica server: 1-, 8- and 64-slice requests and a burst of 8
    concurrent 1-slice requests, E1 f32."""
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.kernels.swin_block import fused_swin_block
    from rdst_tpu_torch.serving.client import SRClient
    from rdst_tpu_torch.serving.export import LiveModel
    from rdst_tpu_torch.serving.server import InferenceServer

    p = ParametersLoader(CONFIG)
    p.set("well_trained_single_scale_model_g", WEIGHTS)
    rng = np.random.default_rng(SEED + 49)
    xs = {n: rng.random((n,) + LR_HW, dtype=np.float32) for n in (1, 8, 64)}
    got, out = {}, {}
    for name, devs in (("one", devices[:1]), ("two", devices)):
        live = LiveModel(p, max_batch=64, device="cuda", devices=devs)
        tally = _replica_launches(live.replicas, fused_swin_block)
        srv = InferenceServer(live, "127.0.0.1", 0, max_batch=64,
                              batch_wait_ms=25.0)
        try:
            srv.warmup(lr_hw=LR_HW, scale=SCALE)
            srv.start_background()
            client = SRClient(f"http://127.0.0.1:{srv.port}")
            meta = client.metadata()
            fused_swin_block.launches = 0  # the served path starts here
            tally[:] = [0] * len(tally)
            got[name] = {n: client.predict(x, SCALE) for n, x in xs.items()}
            barrier = threading.Barrier(8)

            def one(i):
                barrier.wait()
                return client.predict(xs[8][i:i + 1], SCALE)

            with concurrent.futures.ThreadPoolExecutor(8) as ex:
                got[name]["burst"] = np.concatenate(list(ex.map(one,
                                                               range(8))))
            out[name] = {"mesh": meta.get("mesh"), "launches": list(tally),
                         "total": fused_swin_block.launches}
            per = DP_PER_FORWARD["float32"]
            log(f"  server on {live.mesh}: manifest mesh {meta.get('mesh')}, "
                f"f32 block launches by replica {tally} ({per} a forward)")
            if meta.get("mesh") != {"data": len(devs)} or \
                    min(tally) == 0 or any(n % per for n in tally):
                raise AssertionError(f"server {name}: {out[name]}")
        finally:
            srv.close()
    for key, want in got["one"].items():
        err = float(np.abs(got["two"][key] - want).max())
        log(f"  {'8 concurrent 1-slice requests' if key == 'burst' else f'{key}-slice request'}: "
            f"{len(devices)} replicas against one, max abs err {err:.3e} "
            f"(tol {SERVE_TOL})")
        out[f"err_{key}"] = err
        if got["two"][key].shape != want.shape or err > SERVE_TOL:
            raise AssertionError(f"serving {key} on {devices}: {err}")
    return out


def run_parallel(data_dir: str, tmp: str, devices=tuple(DP_DEVICES)):
    """Phases 49-51 on ``devices``; no kernel row of its own (the kernels
    are the E1 group's, each held against its plain version there)."""
    devices = list(devices)
    return {"train": dp_train_phase(data_dir, tmp, devices),
            "tester": dp_tester_phase(data_dir, tmp, devices),
            "serving": dp_serving_phase(devices)}, []



# --------------------------------------------------------------------------
# Phases 52-56: the serving bundle (``--only bundle``, after the other
# models): export, load and serve a bundle, one CUDA graph an entry and
# bucket

# name -> (config, weights key, weights, overrides, scales); the MetaSR
# bundle blends at 0.5 (its config ships 0), so that the blend runs
BUNDLES = {
    "E1 f32": (CONFIG, "well_trained_single_scale_model_g", WEIGHTS, {},
               (SCALE,)),
    "E1 bf16 rdstb": (CONFIG, "well_trained_single_scale_model_g", WEIGHTS,
                      {"inference_dtype": "bfloat16",
                       "pallas_kernels": "rdstb"}, (SCALE,)),
    # the pair kernel and the persistent window kernel, captured too
    "E1 bf16 pair": (CONFIG, "well_trained_single_scale_model_g", WEIGHTS,
                     {"inference_dtype": "bfloat16",
                      "pallas_kernels": "pair"}, (SCALE,)),
    "E1 bf16 swin": (CONFIG, "well_trained_single_scale_model_g", WEIGHTS,
                     {"inference_dtype": "bfloat16",
                      "pallas_kernels": "swin"}, (SCALE,)),
    "W96 bf16 int8 qkv": (W96_CONFIG, "well_trained_single_scale_model_g",
                          W96_WEIGHTS, {"inference_dtype": "bfloat16"},
                          (SCALE,)),
    "SwinIR-std": (SWINIR_CONFIG, "well_trained_single_scale_model_g",
                   SWINIR_WEIGHTS, {}, (SCALE,)),
    "MetaSR": (METASR_CONFIG, "well_trained_model_metasr", METASR_WEIGHTS,
               {"residual_scale": 0.5}, METASR_SCALES),
}
BUNDLE_BUCKETS = (1, 8, 64)
BUNDLE_ITERS = 5  # timed predicts a point, each way
# the host's calls that put work on the device: a kernel launch (runtime
# or driver entry) or a graph launch
LAUNCH_CALLS = ("LaunchKernel", "LaunchCooperativeKernel", "GraphLaunch")
BURST = 64


def _bundle_paras(name: str, data_dir=None):
    from rdst_tpu_torch.config import ParametersLoader

    config, key, weights, over, _ = BUNDLES[name]
    p = ParametersLoader(config)
    p.set(key, weights)
    for k, v in over.items():
        p.set(k, v)
    if data_dir:
        p.set("data_folder", data_dir)
    return p


class _OpenedFiles:
    """Record every path ``open`` is given while active, and refuse the
    config loader's file read: a bundle must load from its own directory
    alone."""

    def __enter__(self):
        import builtins

        from rdst_tpu_torch.config import ParametersLoader

        self.paths, self._open = [], builtins.open
        self._load = ParametersLoader.load

        def opener(path, *a, **k):
            if isinstance(path, (str, bytes, os.PathLike)):
                self.paths.append(os.path.abspath(os.fsdecode(path)))
            return self._open(path, *a, **k)

        def no_config(loader, config_file):
            raise AssertionError(f"bundle load read the config {config_file}")

        builtins.open = opener
        ParametersLoader.load = no_config
        return self

    def __exit__(self, *exc):
        import builtins

        from rdst_tpu_torch.config import ParametersLoader

        builtins.open = self._open
        ParametersLoader.load = self._load
        return False


def _serving_counters() -> dict:
    """The serving kernels' wrappers, each counting its launches."""
    from rdst_tpu_torch.kernels import rdstb_block, swin_block, swin_pair

    return {"swin_block_f32": swin_block.fused_swin_block,
            "swin_block_fast": swin_block.run_fast_block,
            "swin_pair": swin_pair.run_swin_pair,
            "rdstb_block": rdstb_block.run_rdstb}


class _Captures:
    """While active, record each capture of a serving bundle: its seconds
    (the eager pass before it included), and in the captured forward the
    peak memory allocated beyond what was allocated before it (the static
    input included there), what the memory pools grew by, and each
    serving kernel's launches."""

    def __enter__(self):
        from rdst_tpu_torch.serving import export

        self.records = []
        self._capture = export.ServingBundle._capture
        self._held = export._held_forward

        def held(model, x, scale):
            counters = _serving_counters()
            before = {k: c.launches for k, c in counters.items()}
            allocated = torch.cuda.memory_allocated(x.device)
            reserved = torch.cuda.memory_reserved(x.device)
            torch.cuda.reset_peak_memory_stats(x.device)
            out = self._held(model, x, scale)
            self.records.append({
                "graph_bytes": torch.cuda.max_memory_allocated(x.device)
                - allocated,
                "pool_growth_bytes": torch.cuda.memory_reserved(x.device)
                - reserved,
                "launches": {k: c.launches - before[k]
                             for k, c in counters.items()
                             if c.launches != before[k]}})
            return out

        def capture(bundle, scale, shape):
            t0 = time.perf_counter()
            g = self._capture(bundle, scale, shape)
            torch.cuda.synchronize()
            self.records[-1]["capture_s"] = time.perf_counter() - t0
            return g

        export._held_forward, export.ServingBundle._capture = held, capture
        return self

    def __exit__(self, *exc):
        from rdst_tpu_torch.serving import export

        export._held_forward = self._held
        export.ServingBundle._capture = self._capture
        return False


@phase("bundle export and load")
def bundle_export_phase(tmp: str, tester_hw) -> dict:
    """Phase 52: each bundle of BUNDLES exported into a fresh directory
    (E1 f32 also at the tester's LR slice) and loaded there on the card,
    reading no file outside that directory (no .ini, nothing under
    weights/ or the corpus)."""
    from rdst_tpu_torch.serving.export import ServingBundle, export_bundle

    out, loaded = {}, {}
    for name, (_, _, _, _, scales) in BUNDLES.items():
        d = tempfile.mkdtemp(prefix="bundle_", dir=tmp)
        shapes = [LR_HW] + ([tuple(tester_hw)] if name == "E1 f32" else [])
        t0 = time.perf_counter()
        export_bundle(_bundle_paras(name), d, shapes, list(scales))
        t1 = time.perf_counter()
        with _OpenedFiles() as opened:
            b = ServingBundle.load(d, max_batch=64, device="cuda")
        t2 = time.perf_counter()
        outside = [f for f in opened.paths
                   if not f.startswith(os.path.abspath(d) + os.sep)]
        if outside or not opened.paths:
            raise AssertionError(f"{name}: loading read {outside or 'nothing'}")
        files = sorted(os.listdir(d))
        if files != ["MANIFEST.json", "params.msgpack"]:
            raise AssertionError(f"{name}: bundle holds {files}")
        m = b.manifest
        log(f"bundle {name}: exported in {t1 - t0:.3f} s, loaded in "
            f"{t2 - t1:.3f} s from {sorted(os.path.basename(f) for f in opened.paths)} "
            f"only; {m['dtype']}, mode {m['pallas_kernels']}, softmax "
            f"{m['pallas_softmax']}, int8 {m['pallas_quant']}, routes "
            f"{sorted(set(m['routes']))} x{len(m['routes'])}, "
            f"{len(m['entries'])} entries, "
            f"{os.path.getsize(os.path.join(d, 'params.msgpack'))} bytes of "
            "parameters")
        out[name] = {"dir": d, "export_s": t1 - t0, "load_s": t2 - t1,
                     "manifest": {k: v for k, v in m.items() if k != "config"},
                     "read": [os.path.basename(f) for f in opened.paths]}
        loaded[name] = b
    return out, loaded


def _wall_ms(fn, iters: int = BUNDLE_ITERS) -> list:
    """Host-clock milliseconds of ``iters`` warm calls, each to a
    synchronize."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


def _forward_profile(fn, iters: int = 3) -> dict:
    """One torch.profiler session over ``iters`` warm calls: per call the
    device time (kernels, copies and sets summed; one stream), the device
    kernels (copies and sets apart) and the host's launch calls
    (LAUNCH_CALLS)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev if "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    host = [e for e in events if e.device_type == DeviceType.CPU
            and any(k in e.name for k in LAUNCH_CALLS)]
    names = {}
    for e in host:
        names[e.name] = names.get(e.name, 0) + 1
    return {"device_ms": sum(e.time_range.elapsed_us() for e in dev)
            / iters / 1e3 if dev else None,
            "kernels": len(kernels) / iters, "host_launches": len(host) / iters,
            "host_calls": {k: v / iters for k, v in names.items()},
            "kernel_names": sorted({e.name for e in kernels})}


def _bundle_point(name: str, b, live, scale: float, bucket: int, gen,
                  kept: list) -> dict:
    """One (entry, bucket): the graph's replay against the eager live
    model on the same slices (bitwise, or where the eager model differs
    from itself run to run, within the model's bar), the capture's
    seconds, memory and kernel launches against an eager forward's, then
    wall p50 each way, device time and idle share, and launches a
    forward each way. The slices and the graph's prediction go to
    ``kept``."""
    x = gen.random((bucket,) + LR_HW, dtype=np.float32)
    counters = _serving_counters()
    before = {k: c.launches for k, c in counters.items()}
    want = live.predict(x, scale)
    eager = {k: c.launches - before[k] for k, c in counters.items()
             if c.launches != before[k]}
    with _Captures() as captures:
        got = b.predict(x, scale)  # captures this point's graph
    if len(captures.records) != 1:
        raise AssertionError(f"{name} x{scale} bucket {bucket}: "
                             f"{len(captures.records)} captures")
    g = captures.records[0]
    kept.append((scale, x, got))
    err = float(np.abs(got - want).max())
    out = {"scale": scale, "bucket": bucket, "capture_s": g["capture_s"],
           "graph_mb": g["graph_bytes"] / 2**20,
           "pool_growth_mb": g["pool_growth_bytes"] / 2**20,
           "captured_launches": g["launches"], "eager_launches": eager,
           "bitwise": bool(np.array_equal(got, want)), "max_abs_err": err}
    if g["launches"] != eager:
        raise AssertionError(f"{name} x{scale} bucket {bucket}: the graph "
                             f"captured {g['launches']} launches, an eager "
                             f"forward makes {eager}")
    if not out["bitwise"]:
        spread = float(np.abs(live.predict(x, scale) - want).max())
        bar = MODEL_TOL if b.manifest["dtype"] == "float32" else \
            BF16_TOL * float(np.abs(want).max())
        out.update(eager_spread=spread, bar=bar)
        log(f"  {name} x{scale} bucket {bucket}: graph vs eager {err:.3e}, "
            f"eager vs eager {spread:.3e} (bar {bar:.3e}; kernels "
            f"{sorted(eager)})")
        if spread == 0.0 or err > bar:
            raise AssertionError(f"{name} x{scale} bucket {bucket}: the "
                                 f"graph differs from the eager model by "
                                 f"{err} (eager run to run {spread})")
    graph_ms = _wall_ms(lambda: b.predict(x, scale))
    eager_ms = _wall_ms(lambda: live.predict(x, scale))
    out["graph_p50_ms"] = float(np.median(graph_ms))
    out["eager_p50_ms"] = float(np.median(eager_ms))
    for way, fn in (("graph", lambda: b.predict(x, scale)),
                    ("eager", lambda: live.predict(x, scale))):
        prof = _forward_profile(fn)
        dev = prof["device_ms"]
        prof["idle_share"] = (None if dev is None else
                              1.0 - dev / out[f"{way}_p50_ms"])
        out[way] = prof
    if out["graph"]["host_launches"] > 2:
        raise AssertionError(f"{name}: a replay made "
                             f"{out['graph']['host_calls']} host launches")
    log(f"  {name} x{scale} bucket {bucket:2d}: "
        f"{'bitwise' if out['bitwise'] else f'max abs err {err:.3e}'}; "
        f"capture {g['capture_s']:.3f} s, {out['graph_mb']:.1f} MiB (pool "
        f"+{out['pool_growth_mb']:.1f} MiB), launches {g['launches']}; wall "
        f"p50 "
        f"graph {out['graph_p50_ms']:.3f} / eager {out['eager_p50_ms']:.3f} "
        f"ms; device " + " / ".join(
            "not measured" if out[w]["device_ms"] is None else
            f"{out[w]['device_ms']:.3f} ms idle {out[w]['idle_share']:.3f}"
            for w in ("graph", "eager"))
        + f"; kernels a forward {out['graph']['kernels']:g} / "
        f"{out['eager']['kernels']:g}, host launches "
        f"{out['graph']['host_launches']:g} / "
        f"{out['eager']['host_launches']:g}")
    return out


def _replays_after_eviction(name: str, b, kept: list) -> dict:
    """The tables a graph reads outlive their caches: every cached device
    table dropped (``device.clear_device_tables``, as an eviction by later
    geometries would), the freed blocks of the allocator's cache taken and
    zeroed (largest first, each size until the cache grows), then each
    point of ``kept`` replayed again, bitwise its first replay."""
    import gc

    from rdst_tpu_torch.device import clear_device_tables

    clear_device_tables()
    gc.collect()
    fill = []
    for size in (1 << 20, 1 << 18, 1 << 16, 1 << 14, 1 << 12, 1 << 9):
        reserved = torch.cuda.memory_reserved()
        while len(fill) < 50000 and torch.cuda.memory_reserved() == reserved:
            fill.append(torch.zeros(size, dtype=torch.uint8, device="cuda"))
    graphs = len(b.graphs)
    same = [bool(np.array_equal(b.predict(x, s), y)) for s, x, y in kept]
    zeroed = sum(t.numel() for t in fill)
    del fill
    torch.cuda.empty_cache()
    log(f"bundle {name}: {len(kept)} replays after the device tables were "
        f"dropped and {zeroed / 2**20:.1f} MiB of freed blocks zeroed: "
        f"{sum(same)} bitwise their first replay")
    if not all(same) or len(b.graphs) != graphs:
        raise AssertionError(f"{name}: replays after eviction {same}, "
                             f"{len(b.graphs)} graphs of {graphs}")
    return {"replays": len(kept), "zeroed_mb": zeroed / 2**20}


@phase("bundle graphs vs eager")
def bundle_graph_phase(loaded: dict) -> dict:
    """Phase 53: each bundle's graphs at buckets 1, 8 and 64 (each served
    scale of MetaSR) against the eager ``LiveModel`` built from the config
    (``_bundle_point``); every wrapper count set to 0 just before the
    bundle's points and read just after (launches happen at capture);
    then the replays after an eviction (``_replays_after_eviction``)."""
    from rdst_tpu_torch.serving.export import LiveModel

    gen = np.random.default_rng(SEED + 52)
    out = {}
    for name, b in loaded.items():
        live = LiveModel(_bundle_paras(name), max_batch=64, device="cuda")
        if live.manifest["routes"] != b.manifest["routes"]:
            raise AssertionError(f"{name}: routes {b.manifest['routes']} "
                                 f"against live {live.manifest['routes']}")
        counters = _serving_counters()
        for c in counters.values():
            c.launches = 0  # the bundle's path starts here
        kept = []
        points = [_bundle_point(name, b, live, s, n, gen, kept)
                  for s in BUNDLES[name][4] for n in BUNDLE_BUCKETS]
        launched = {k: c.launches for k, c in counters.items()
                    if c.launches}  # and ends here
        del live
        evicted = _replays_after_eviction(name, b, kept)
        routed = any(r != "plain" for r in b.manifest["routes"])
        if routed and not launched:
            raise AssertionError(f"{name}: no kernel launched")
        log(f"bundle {name}: {len(b.graphs)} graphs, launches in the run "
            f"(captures and eager forwards) {launched}")
        out[name] = {"points": points, "launches": launched,
                     "graphs": len(b.graphs), "after_eviction": evicted}
    return out


@phase("bundle E1 f32 tester")
def bundle_tester_phase(bundle_dir: str, data_dir: str, tmp: str) -> dict:
    """Phase 54: the E1 f32 bundle's predictions of the held-out patients,
    whole slices at the tester's LR shape, scored by the tester's protocol
    (``TransSRTester.test`` with the bundle as its forward) against the
    E1 f32 row of TESTER_BARS."""
    from rdst_tpu_torch.runners.tester import TransSRTester
    from rdst_tpu_torch.serving.export import ServingBundle

    b = ServingBundle.load(bundle_dir, max_batch=64, device="cuda")
    p = _bundle_paras("E1 f32", data_dir)
    p.set("verbose", False)
    p.set("output_dir", os.path.join(tmp, "tester", "bundle_E1_f32"))
    tester = TransSRTester(p, device="cuda")
    tester.setup()
    calls = []

    def forward(x, sr_scale=None):
        calls.append(len(x))
        return torch.from_numpy(b.predict(np.asarray(x), sr_scale))

    tester.forward = forward
    t0 = time.perf_counter()
    stacked = tester.test()
    wall = time.perf_counter() - t0
    bar = TESTER_BARS["E1 f32"]
    scores = {m: float(np.mean(stacked[f"{m}_4.0"])) for m in ("psnr", "ssim")}
    delta = {m: scores[m] - bar[m] for m in scores}
    log(f"E1 f32 bundle by the tester's protocol: PSNR {scores['psnr']:.4f} "
        f"SSIM {scores['ssim']:.4f} over {len(stacked['psnr_4.0'])} slices "
        f"(bar {bar['psnr']} / {bar['ssim']}, tol {TESTER_PSNR_TOL} / "
        f"{TESTER_SSIM_TOL}); {len(calls)} patient batches {calls}, "
        f"{len(b.graphs)} graphs, {wall:.3f} s")
    if not calls or abs(delta["psnr"]) > TESTER_PSNR_TOL or \
            abs(delta["ssim"]) > TESTER_SSIM_TOL:
        raise AssertionError(f"bundle tester: {scores} against {bar}")
    return {"scores": scores, "delta": delta, "batches": calls,
            "wall_s": wall}


def _live_ini(tmp: str) -> str:
    """E1's shipped config with its committed weights named in it (the
    volume CLI takes no overrides)."""
    import re

    with open(CONFIG) as f:
        text = f.read()
    text = re.sub(r"^\[DEFAULT\]\n", "[DEFAULT]\nwell_trained_single_scale_"
                  f"model_g = '{os.path.abspath(WEIGHTS)}'\n", text, count=1,
                  flags=re.M)
    path = os.path.join(tmp, "e1_live.ini")
    with open(path, "w") as f:
        f.write(text)
    return path


@phase("bundle server and volume")
def bundle_serving_phase(bundle_dir: str, tmp: str, bar: float) -> dict:
    """Phase 55: ``serving.server.main(['--bundle', E1 f32, '--warmup'])``
    answering health, metadata and a burst of BURST concurrent one-slice
    requests (coalesced; each within SERVE_TOL of the bundle's own
    prediction of the burst as one batch), every wrapper count set to 0
    before the server starts and read after it stops (the warmup captures
    every graph: 48 f32 block launches in the eager forward before each
    capture, 48 in the capture); then the volume CLI with
    ``--bundle`` against the live volume CLI on one NIfTI volume (within
    ``bar``, phase 53's for E1 f32: 0 where the graphs were bitwise)."""
    from rdst_tpu_torch.data import io as nio
    from rdst_tpu_torch.serving import volume
    from rdst_tpu_torch.serving.client import SRClient
    from rdst_tpu_torch.serving.export import ServingBundle
    from rdst_tpu_torch.serving.server import InferenceServer, main

    rng = np.random.default_rng(SEED + 55)
    xs = rng.random((BURST,) + LR_HW, dtype=np.float32)
    out, runs = {}, []
    run = ServingBundle._run

    def counted(self, blk, scale):
        runs.append(len(blk))  # the bucket replayed
        return run(self, blk, scale)

    def serve(srv):
        srv.start_background()
        client = SRClient(f"http://127.0.0.1:{srv.port}")
        out["health"] = client.health()
        out["metadata"] = client.metadata()
        direct = srv.batcher.predictor.predict(xs, SCALE)
        runs.clear()
        barrier = threading.Barrier(BURST)

        def one(i):
            barrier.wait()
            return client.predict(xs[i:i + 1], SCALE)

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(BURST) as ex:
            got = np.concatenate(list(ex.map(one, range(BURST))))
        out["burst_s"] = time.perf_counter() - t0
        out["burst_dispatches"] = list(runs)
        out["burst_err"] = float(np.abs(got - direct).max())
        raise KeyboardInterrupt

    counters = _serving_counters()
    for c in counters.values():
        c.launches = 0  # the served path starts here
    forever = InferenceServer.serve_forever
    ServingBundle._run, InferenceServer.serve_forever = counted, serve
    try:
        main(["--bundle", bundle_dir, "--warmup", "--port", "0",
              "--max-batch", "64", "--batch-wait-ms", "25"])
    finally:
        ServingBundle._run, InferenceServer.serve_forever = run, forever
    launched = {k: c.launches for k, c in counters.items() if c.launches}
    out["launches"] = launched  # and ends here
    man = out["metadata"]
    graphs = len(man["entries"]) * 3
    log(f"server --bundle --warmup: health {out['health']}, metadata "
        f"{man['model_name']} {len(man['entries'])} entries on "
        f"{man['device']}; {BURST} concurrent 1-slice requests in "
        f"{out['burst_s']:.3f} s as {len(out['burst_dispatches'])} replays "
        f"of buckets {out['burst_dispatches']}, "
        f"max abs err {out['burst_err']:.3e} against one batch (tol "
        f"{SERVE_TOL}); launches {launched} ({graphs} graphs captured)")
    # each graph: the eager forward before its capture and the capture
    if out["health"] != {"status": "ok"} or man["runtime"] != "torch" or \
            launched != {"swin_block_f32": 2 * 48 * graphs}:
        raise AssertionError(f"bundle server: {out}")
    if not 1 <= len(out["burst_dispatches"]) < BURST or \
            out["burst_err"] > SERVE_TOL:
        raise AssertionError(f"bundle server burst: {out}")
    vol = 100 + 50 * rng.random(LR_HW + (24,), dtype=np.float32)
    src = os.path.join(tmp, "volume_in.nii")
    nio.save(src, vol)
    res = {}
    for way, args in (("bundle", ["--bundle", bundle_dir]),
                      ("live", ["--config-file", _live_ini(tmp)])):
        dst = os.path.join(tmp, f"volume_{way}.nii")
        volume.main(args + ["--in", src, "--out", dst, "--max-batch", "64"])
        res[way] = nio.load(dst).get_fdata()
    err = float(np.abs(res["bundle"] - res["live"]).max())
    out["volume_err"] = err
    log(f"volume CLI --bundle: {vol.shape} -> {res['bundle'].shape}, max abs "
        f"err against the live volume CLI {err:.3e} (bar {bar})")
    if res["bundle"].shape != (160, 128, 24) or err > bar * 50:
        raise AssertionError(f"volume CLI: {res['bundle'].shape}, {err}")
    return out


@phase("bundle capture fault")
def bundle_capture_fault_phase(bundle_dir: str) -> dict:
    """Phase 56: on the E1 bf16 bundle, a capture that meets a
    host-to-device copy (MeanShift's bf16 path making its mean and std
    from Python numbers on every call, as the port did before they became
    buffers) raises, naming that line, and nothing runs eagerly in its
    place; with the forward put back the same bundle captures and serves."""
    from rdst_tpu_torch.nn.common import MeanShift, mean_shift
    from rdst_tpu_torch.serving.export import ServingBundle

    b = ServingBundle.load(bundle_dir, max_batch=64, device="cuda")
    x = np.random.default_rng(SEED + 56).random((1,) + LR_HW,
                                                dtype=np.float32)
    fixed = MeanShift.forward

    def numbers_per_call(self, t):
        return mean_shift(t, torch.as_tensor(self.mean, device=t.device),
                          torch.as_tensor(self.std, device=t.device),
                          self.mode)

    MeanShift.forward = numbers_per_call
    try:
        b.predict(x, SCALE)
    except RuntimeError as e:
        msg = str(e)
    else:
        raise AssertionError("a capture with a host-to-device copy ran")
    finally:
        MeanShift.forward = fixed
    log(f"capture fault: {msg[:600]}")
    if "mean_shift" not in msg or b.graphs:
        raise AssertionError(f"capture fault not named or kept: {msg}")
    y = b.predict(x, SCALE)
    if y.shape != (1, LR_HW[0] * 4, LR_HW[1] * 4, 1) or \
            not np.isfinite(y).all() or len(b.graphs) != 1:
        raise AssertionError(f"after the fault: {y.shape}, {b.graphs}")
    return {"message": msg}


def run_bundle(data_dir: str, tmp: str, patients: dict):
    """Phases 52-56; no kernel row of its own (the kernels run in the
    graphs are each held against their plain version in their model's
    group)."""
    import gc

    card = _card_line()
    exported, loaded = bundle_export_phase(tmp, _lr_hw(patients))
    graphs = bundle_graph_phase(loaded)
    del loaded
    gc.collect()
    torch.cuda.empty_cache()
    e1 = exported["E1 f32"]["dir"]
    bar = max([p.get("bar", 0.0) for p in graphs["E1 f32"]["points"]]
              + [0.0])
    return {"card": card, "bundles": exported, "graphs": graphs,
            "tester": bundle_tester_phase(e1, data_dir, tmp),
            "serving": bundle_serving_phase(e1, tmp, bar),
            "fault": bundle_capture_fault_phase(
                exported["E1 bf16 rdstb"]["dir"])}, []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--only", choices=("e1", "swinir", "w96", "metasr",
                                       "int8", "xdata", "zoo", "convzoo",
                                       "ckpt", "parallel", "bundle"),
                    nargs="+", default=None,
                    help="run the card and build phases and these models' "
                    "phases only (default: every phase)")
    ap.add_argument("--dp-devices", nargs="+", default=DP_DEVICES,
                    help="the data axis of phases 49-51 (default: two ranks "
                    "or replicas sharing cuda:0)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    card = card_phase()
    libs = build_phase()
    results = {"card": card, "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "libs": libs}
    kernels = []
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = _make_corpus(tmp)
        patients = _tester_patients(data_dir)
        log(f"held-out patients: {dict(zip(patients, _images(patients)))} "
            "slices")
        if args.only is None or "e1" in args.only:
            results["e1"], rows = run_e1(data_dir, tmp, patients)
            kernels += rows
        if args.only is None or "swinir" in args.only:
            results["swinir"], rows = run_swinir(data_dir, tmp, patients)
            kernels += rows
        if args.only is None or "w96" in args.only:
            results["w96"], rows = run_w96(data_dir, tmp, patients)
            kernels += rows
        if args.only is None or "metasr" in args.only:
            results["metasr"], rows = run_metasr(data_dir, tmp)
            kernels += rows
        if args.only is None or "int8" in args.only:
            results["int8"], rows = run_int8(data_dir, tmp, patients)
            kernels += rows
        if args.only is None or "xdata" in args.only:
            results["xdata"], rows = run_xdata(data_dir, tmp, patients)
            kernels += rows
        if args.only is None or "zoo" in args.only:
            results["zoo"], rows = run_zoo(data_dir, tmp, patients)
            kernels += rows
        if args.only is None or "convzoo" in args.only:
            results["convzoo"], rows = run_conv_zoo(data_dir, tmp)
            kernels += rows
        if args.only is None or "ckpt" in args.only:
            results["ckpt"], rows = run_ckpt(data_dir, tmp)
            kernels += rows
        if args.only is None or "parallel" in args.only:
            results["parallel"], rows = run_parallel(data_dir, tmp,
                                                     args.dp_devices)
            kernels += rows
        if args.only is None or "bundle" in args.only:
            results["bundle"], rows = run_bundle(data_dir, tmp, patients)
            kernels += rows
    results["kernels"] = kernels
    results["total_s"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    log(f"total {results['total_s']:.3f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
