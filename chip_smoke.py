#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its main paths on one GPU.

    python3 chip_smoke.py [--profile DIR] [--kernels-only | --fused-only | --dispnet-only | --precision-only
                           | --cli-only | --train-only | --demo-only | --parallel-only | --spatial-only
                           | --tools-only | --kitti-only | --parity-only]

Phases, each of which raises on failure (nothing is caught):

1. The card's name and power limit (``nvidia-smi``) and the TF32 flags,
   which must be off: phases 3-7 run the JAX package's default precision,
   ``highest``, fp32.
2. Build every CUDA kernel from ``csrc/`` (one ``nvcc`` per source, all
   started together) and print the build time and the ptxas report, and
   apart the registers and spills of ``corr_fwd``, ``corr_bwd``, the two tiled forwards,
   the tiled offset and source gradients, K5's and K4's offset and source
   gradients (``feat_bwd_offset_kernel``, ``feat_bwd_source_kernel``,
   ``warp_bwd_offset_kernel``, ``warp_bwd_source_kernel``) and the wide
   correlation pair.
3. Each of the sixteen kernels at every shape the main paths give it, against
   its plain PyTorch version on the card, with offsets outside the clamp
   windows: the six forward kernels, and the six backward kernels
   (``dx``, ``dy``; ``dimg``, ``ddisp``; ``dfeats``, ``ddx``), each of
   which must also give bit-identical outputs in two runs. The wide
   correlation kernels (any radius) run at DispNet-Corr1D's call,
   [1,128,80,304] at radius 40, and are also checked where W < 2R+1
   ([1,128,5,19]) and at a width that is no multiple of their 64-column
   tile; for the record, the wide forward is also timed at MADNet's five
   radius-2 shapes beside ``corr_fwd``. The tiled
   one-hot warps (``csrc/warp_tile.cu``) are held against the one-hot
   products and against the clamped-window kernels, which compute the
   same function (the image warps bit for bit). Prints each kernel's
   time (median of CUDA-event-timed replays of a CUDA graph), its bound
   (bytes over 3.35 TB/s, or fp32 operations over 67 TFLOP/s, whichever
   is larger), the plain version's time and, for the warps, a yardstick
   that the port never calls, timed from a CUDA graph too. K1
   (``corr_fwd``, ``corr_fwd_wide`` and their bf16 instances), its
   backward (``corr_bwd``, ``corr_bwd_wide`` and their bf16 instances) and
   every variant of the four warp backward kernels are also timed
   with the L2 cold (``cold_ms``): each call in the graph follows a write
   over a buffer twice the card's 50 MB L2, whose own time, taken the same
   way, is subtracted. The yardsticks are
   ``F.grid_sample`` (forward) or its backward op
   ``aten.grid_sampler_2d_backward`` on the same sampling. A warp backward
   is timed in each variant, the gradients it is asked for: both, the
   offset's alone and the source's alone (MAD and FULL ask for one of
   these), each beside the op
   with the same output mask and its own byte bound, and each bit-identical
   to both gradients together. Per kernel it prints its time summed over
   its shapes as a ratio to that yardstick's sum, for a backward kernel
   that of every variant. At batch 4 the kernels are checked and timed
   again: K1 (fp32 and bf16, radius 2) and K3, the shapes of
   ``cli/evaluate.py``; ``corr_bwd`` at MADNet's five scales, K5 at K1's
   last four (every variant) and the wide pair at [4,128,80,304], radius
   40, the shapes of a ``cli/train.py`` step, each backward bit-identical
   in two runs; at batch 2, a data-parallel rank's piece of that step
   (phase 12), K1 and K3 and their backward kernels again. Last the five
   kernel Functions under ``torch.func.vmap`` over 2 and 4 streams at
   [N, 1, ...] of MADNet's shapes (phase 13), forward and backward (the
   warps' both gradients): one launch a vmapped call, against the plain
   version stream by stream, timed beside it on the folded batch. And the
   wide pair at the shapes of a rank of phase 13's width-sharded DispNet,
   [1,128,80,w_r+80] from the layout's cut (``w_r`` the rank's columns at
   1/4: [1,128,80,240] and [1,128,80,224] on two ranks), ``x`` zero on the
   pad columns, held and timed as at DispNet's call, the backward
   bit-identical in two runs. The correlation's bf16 instances too: under
   vmap at MADNet's shapes (one launch a vmapped call), and the wide pair
   at a rank's shapes, each within the bf16 tolerance of phase 8. Then
   at the tools' 384x1280 frame (phase 14; rows tagged ``frame``), whose
   width is a multiple of the tiled warps' 128-column tile, so K6/K7 run
   unpadded: every batch-1 kernel above at its scale of that frame, the
   wide pair at [1,128,96,320], and at batch 8 the offline tool's forward
   kernels (K1 fp32 and bf16, K3, the wide forward fp32 and bf16).
4. The NONE-mode online session of full-width MADNet at 320x1216, the
   ``cli/adapt.py`` default frame size: seeded weights made with numpy in
   the JAX layout and carried over with ``params_from_jax``, synthetic
   frames whose right image is the left one shifted by a known
   disparity. The launch counters are set to 0 just before the session
   and must read 5 / 1 / 4 forward launches per frame after it, and no
   backward launch. Then one frame runs again with the plain modes on
   the card, and the disparities must agree within 1e-4 of the largest.
5. MAD adaptation as ``cli/adapt.py`` runs it: MADNet with the bulkhead,
   momentum, lr 1e-4, ``block_config/MadNet_full.json``, the SEQUENTIAL
   sampler so that every block is trained, 10 frames. Per frame: 5 / 2 / 4
   forward launches (the image warp runs in the block loss and in the
   full loss) and, for block i, 1 correlation backward, 1 image-warp
   backward and 1 feature-warp backward (none for block 0); finite loss
   and disparity; exactly the sampled block's parameters change; the
   scores move. Then FULL adaptation without the bulkhead, 5 frames:
   5 / 1 / 4 forward and 5 / 1 / 4 backward launches per frame, a
   gradient reaches every parameter. Then one MAD step (block 4) and one FULL step from
   the same weights with the kernels and with the plain modes on the
   card: the parameter changes must agree within 1e-4 of the largest.
   Last, one frame with a loss threshold below every loss: the reset
   safeguard must restore the pristine weights.
6. The fused device session (``adapt/fused.py``: flat arena, controller
   on the device, one CUDA graph per branch) at 320x1216 with
   ``warp_mode='mxu'`` in model and loss, on smooth stereo pairs. MAD with
   the bulkhead, SEQUENTIAL, 20 frames: the first two rounds are checked
   frame by frame (5 correlation, 2 + 4 tiled forward, 1 correlation
   backward and 1 + 1 tiled backward launches, none of the latter for
   block 0, and none of the clamped-window kernels; exactly the sampled
   block's arena range moves; each graph holds its block's launches), the
   last two run with ``torch.cuda.set_sync_debug_mode("error")``, so a host
   sync in the steady state raises. ``finalize()``'s loss, EPE, fetch
   counter and scores and the adapted weights must agree with the host
   session over the same frames, weights and warp mode, and with the same
   fused session run eagerly (``use_graphs=False``); ``step_chunk`` over
   two chunks of 5 must equal 10 steps, and the ``shared_forward`` session
   (one graph) must follow the same trajectory. Then the sampled modes,
   whose block the device picks (a CUDA-graph SWITCH node over the
   branches' graphs, ``csrc/graph_switch.cu``): PROBABILITY, ARGMAX and
   RANDOM at one block a frame and PROBABILITY at two, 8 frames each,
   against the same session run eagerly, both on cuDNN's deterministic
   algorithms: the first frame captures every branch, the first 3 frames
   each add, read by the harness after a sync, the drawn blocks' MAD
   launches and one ``graph_switch``, the last 5 run with every host sync
   an error; the blocks drawn frame by frame (read by the harness from
   ``cur_blocks``), the launches after ``finalize`` (the twin's plus one
   ``graph_switch`` a frame), the trajectory, controller and weights must
   be the twin's. The same for MADNet under the proxy loss (the continual
   CLI's), PROBABILITY, against its eager twin. PROBABILITY is timed on
   cuDNN's default algorithms, and a switched launch against a direct
   replay of the same branch's graph, in turns, before the process's first
   profiler window and after it. Then FULL (5 / 1 + 4 / 5 / 1 + 4 launches a frame) against the host
   session, NONE with metrics (1 + 4) and NONE without through ``serve``
   (0 + 4; each served disparity is its own frame's), and the reset on the
   device under a threshold below every loss.
7. DispNet-Corr1D at full width (every width of the JAX model) at
   320x1216, seeded weights in the JAX layout carried over with
   ``params_from_jax``: the host NONE session, MAD as ``cli/adapt.py``
   runs it (momentum, lr 1e-4, ``block_config/dispnet_full_6.json``,
   SEQUENTIAL, no bulkhead: DispNet has none), FULL, the fused MAD session
   (``warp_mode='mxu'``) against the host session, the fused FULL session
   (``mxu``, 8 frames) against the host FULL session on the same frames
   and weights (loss and EPE at phase 6's trajectory bounds, the adapted
   weights within 1e-2 of the largest move), the fused MAD session under
   PROBABILITY, its block picked on the device over the six blocks'
   graphs, against its eager twin as in phase 6, and fused NONE serving.
   Launch counts are asserted frame by frame: one ``corr_fwd_wide`` a
   frame, one ``corr_bwd_wide`` for FULL and for MAD blocks 3 and 4 (conv2
   and conv1, before the correlation) and none for the other blocks, and
   the loss's image-warp kernels as in MADNet. One frame of NONE, of MAD
   (blocks 3 and 5) and of FULL also runs with the plain modes on the card:
   the disparities before and after the step agree within 1e-4 of the
   largest, a step's gradient within 5e-4 of its largest entry.
8. The precision modes ``default``, ``bf16`` and ``bf16_act``
   (``ops/conv.py``). Phase 3 also holds the four bf16 instances of the
   correlation kernels (``corr_fwd_bf16``, ``corr_bwd_bf16``,
   ``corr_fwd_wide_bf16``, ``corr_bwd_wide_bf16``) against their plain
   versions at the main-path shapes, on seeded values rounded to bf16:
   every entry within one bf16 ulp, the backward bit-identical in two runs,
   each timed beside its bound and the fp32 instance. Then, for each mode
   against ``highest`` on the same smooth frames and weights: the first
   frame's full-resolution disparity within a median relative error of
   0.05 (the bound of the JAX package's own drift test), fused MAD
   (SEQUENTIAL, bulkhead, ``mxu``, 15 frames, the first round counted frame
   by frame) with the first round's EPE within 5% of ``highest``'s a frame
   (every frame's printed), and fused NONE serving. Under ``bf16_act`` every correlation launches a bf16
   instance and none an fp32 one; under ``default`` and ``bf16`` none a
   bf16 one. Under ``bf16_act`` also host MAD against fused MAD (loss 1e-3,
   EPE 1e-2 a frame: cuDNN's bf16 weight gradients), fused FULL, and
   DispNet-Corr1D's host MAD over ``dispnet_full_6.json`` (blocks 3-4 run
   ``corr_bwd_wide_bf16``) and fused NONE serving, whose disparities must
   be bf16, as the reference's are. In every mode MADNet's fused and host
   FULL (8 frames, ``mxu``), and under ``bf16_act`` DispNet's fused FULL,
   each with its EPE over the first two frames within 5% of the same
   session's at ``highest``, fused against host over those two frames, and
   timed by CUDA events. The TF32 flags must be on for cuDNN
   under ``default`` only, and off again after the phase.
9. The native loader first (``runtime/``, built by ``g++`` from
   ``stereo_loader.cc``): whether it built, its decode route and its
   threads are printed, and the phase fails where it did not build; 32
   frames of the list below decode through it bit for bit as through the
   Python backend, each backend's frames/s printed. The CLIs below decode
   through it (``StereoDataset(backend="auto")``).
   Then the CLIs on real frames: ``cli/adapt.py`` and ``cli/evaluate.py``
   (``main``, in-process) over list files of 32 frames cycling two scenes
   of ``tests/fixtures/realworld`` at 320x1216 (the fixture's own size),
   from ``weights_scene01.npz``, SEQUENTIAL, lr 1e-4, SSIMTh 0.5: adapt
   NONE, MAD fused and MAD host on scenes 2-3; NONE, MAD and FULL on their
   photometrically asymmetric twins; evaluate at batch 4 under every
   precision mode; fused MAD under ``bf16_act``; DispNet-Corr1D's MAD over
   ``dispnet_full_6.json``, fused and host, 8 frames, seeded weights. Per
   run: the launch counts frame by frame summed (so no plain version ran),
   ``stats.csv`` and ``series.csv`` in the JAX CLI's format, finite
   metrics. D1 within 0.25 points of the JAX package's CLI on the same
   lists (``tests/fixtures/torch_cli_reference.json``, made on the CPU by
   ``tools/torch_cli_reference.py``), in every precision mode; evaluate's
   within 0.1 of the JAX CLI with every bf16 rounding kept (the file's
   ``strict_runs``, beside the port's own evaluate on the CPU); within 0.1
   points of ``highest`` wherever the JAX package is too (``check_drift``);
   fused MAD against host MAD frame by frame.
   Prints EPE, bad3 and D1, the first and last 8 frames' of MAD and FULL,
   wall ms/frame with reading, the fused session's device ms/frame on the
   same frames, and the PNG decode time on this host.
10. Continual adaptation and training on the same real frames, at
   ``highest``. First the TF1 fixture (``tests/fixtures/tf1_madnet_tiny``)
   into MADNet through ``restore_or_init``, read by the port's numpy
   reader: the count and every value bit for bit. Then
   ``cli/adapt_continual.py`` over 32 frames of scenes 2-3 whose proxy
   column is the scene's ground truth, from ``weights_scene01.npz``: MAD
   SEQUENTIAL fused and host, FIXED 2 3 fused (it must fetch blocks 2 and 3
   only), FULL ``--dilation 2`` fused; each run's D1 within 0.25 points of
   the JAX CLI's (``phase10_runs`` of ``torch_cli_reference.json``), the
   launches frame by frame summed (no image warp: the proxy loss warps
   none), MAD's last 8 frames' D1 below its first 8's, fused against host
   MAD within phase 9's bounds, and the fused session's device ms/frame.
   Then ``cli/train.py``, MADNet, 8 steps of 4 frames with ``--augment``,
   seed 0, and ``cli/evaluate.py`` on its checkpoint: D1 within 0.25 of
   the JAX CLIs' row, EPE below the untrained network's; 5 ``corr_fwd``,
   5 ``corr_bwd``, 4 K3 and 4 K5 a step; the step's device time at B = 4;
   one step's gradient with the kernels against the plain modes within
   5e-4 of its largest entry. Last DispNet-Corr1D, 4 steps at B = 4 from
   seeded weights: one ``corr_fwd_wide`` and one ``corr_bwd_wide`` a step,
   a finite loss, and one step's gradient against the plain modes.
11. The live demo, ``cli/demo.py`` (``main``, in-process), headless
   (``--camera folder --display none --outDir``), MADNet over
   ``MadNet_full.json`` from ``weights_scene01.npz``, Adam, on 32 frames
   of scenes 2-3: (a) its defaults, 480x640 rescaled and 320x512 cropped,
   MAD, PROBABILITY, the fused session with an fp16 disparity through
   ``step_pipelined``, its block switched on the device (one
   ``graph_switch`` a frame; the branches' launches read once the demo
   ends); (b) the full width (``--imageShape -1 --cropShape
   320 1216``), SEQUENTIAL, fused and then host: D1 of the written PNGs
   against the fixture's ground truth, against the JAX demo's on the same
   frames (``demo_runs`` of ``torch_cli_reference.json``), each from 8
   starting points (the weights, and 7 copies with each weight moved by at
   most one ulp, ``perturbed_weights``): within 0.25 points a frame over
   the first 3 frames from each, and the 32 frames' D1, averaged over the
   8, within 3.0 (Adam carries float32 noise into D1, by points a run: see
   ``DEMO_D1_BOUND``); the fused PNGs' EPE within phase 9's bound of the
   host's a frame over the first 3 frames, the mean D1 within 3.0; (c)
   ``--mode FULL``, fused, 8 frames. Per run: one PNG a frame, numbered
   from 1; the launches the sum of each frame's, by the blocks the session
   fetched; each CUDA graph holding its branch's launches; Adam's step
   count on the device one a frame; ``worker.fps`` and ``StepTimer``'s
   ``avg_ms`` printed.
12. Several streams and several processes, at 320x1216. (a) The fused
   session with ``num_streams`` N = 2 and 4, ``stream_impl`` "map" (a
   graph per stream and branch) and "unroll" (a graph of the N streams'
   steps per branch they all take), MADNet MAD with the bulkhead, ``warp_mode='mxu'``,
   SEQUENTIAL, seeds ``[0] * N``, each stream on smooth frames of its own,
   12 frame-batches: the first round counted frame-batch by frame-batch (5N
   correlations, the sampled block's backward in each stream), each
   graph's launches, the rest replayed with every host sync an error; each
   stream's loss, EPE, fetch counter, scores and weights against a
   single-stream session (seed 0) over its frames, at phase 6's bounds of a
   replayed session against the eager one. Prints the graphs captured, ms
   of device time (CUDA events) and wall time a frame-batch and a frame,
   the same frames through N single-stream sessions stepped in turn, and
   peak memory. Then PROBABILITY, N = 4, seeds ``[0, 1, 2, 3]``, 30
   frame-batches, the blocks switched on the device: under "map" and
   "unroll" alike one parent of N switches, launched once a frame-batch,
   whatever the streams drew; each frame-batch's launches, read after a sync, the
   drawn blocks' (read from ``cur_blocks``) and N ``graph_switch``; each
   stream against the single session with its seed, and the graphs at
   most 5N. (b) ``parallel.make_dp_train_step``
   on two ranks of a ``gloo`` group on the one card (this script with
   ``--dp-rank``, each with a time limit; the kernels built here first),
   MADNet, 3 steps of a global batch of 4 smooth frames whose ground truth
   has zeros spread unevenly over the two halves: at every step the loss
   within 1e-5 relative of one process's on the whole batch at the same
   weights (a mean of the ranks' own means must miss it), the gradient the
   step took within 1e-5 of its largest entry of one process's over the
   same two halves and within STEP_RTOL with the plain modes (the whole
   batch's printed beside them), the two ranks' weights,
   loss and gradient equal bit for bit, the losses within 1e-5 of a
   one-process run's, its weights after the 3 steps at the JAX package's
   tolerance (rtol 1e-3, atol 1e-6, where the gradient exceeds 1e-3 of its
   largest entry), each rank's launches counted; the same under NCCL, one
   GPU a rank, where the machine has two GPUs. (c) ``cli/train.py
   --dataParallel`` on two ``gloo`` ranks, phase 10's frames, B = 4, 2
   steps, against the one-process CLI: each step's loss within 1e-4
   relative, rank 0's one checkpoint, its weights as in (b), rank 0 alone
   logging. Prints each rank's ms a step beside one process's.
13. Batched streams and width sharding, at 320x1216, deterministic cuDNN.
   (a) ``stream_impl="vmap"``, MADNet MAD through the shared-forward step
   (bulkhead, ``mxu``, SEQUENTIAL, seeds ``[0] * N``, each stream on its
   own smooth frames), N = 2 and 4, 8 frame-batches: every frame-batch
   launching each kernel as one shared-forward frame does (K1 5, not 5N),
   one graph, the steady ones replayed with every host sync an error; each
   stream against a single shared-forward session over its first round
   (each block trained once) at phase 6's bounds, the later frames
   printed (``check_round``); ms a frame-batch by CUDA events beside
   "map" and "unroll" on the same frames, graphs and peak memory. Then
   PROBABILITY at N = 4 (seeds 0-3), FULL at N = 2 with dilation 2 (its
   forward-only graph), NONE serving at N = 4 against single sessions'
   disparities. (b) Two ``gloo`` ranks sharing the card (this script with
   ``--dp-rank``): ``parallel.make_spatial_adapt_step`` over 3 frames,
   each step against one process from the same weights (loss 1e-4, the
   gradient STEP_RTOL of its largest entry, the first update at the JAX
   package's rtol 1e-3 / atol 1e-6), the ranks bit for bit; the
   width-sharded fused MAD session over 5 frames against the single
   session at ``tests/test_parallel.py``'s bounds, its disparity pieces
   within 1e-3 of the largest; each rank's launches and its halo audit
   (every conv fetched its halo, all-gathers by the warps alone). (c)
   Four vmap streams over the two ranks against (a)'s single sessions,
   both ranks' gathered results equal. Then (b) for DispNet-Corr1D, phase
   7's weights: the step over 3 frames as MADNet's (one ``corr_fwd_wide``
   and one ``corr_bwd_wide`` a step a rank), the width-sharded fused MAD
   session over one SEQUENTIAL round of its six blocks, FULL over 3 frames
   and MAD on proxy labels over 4, each against the single-device fused
   session (every frame's sampled block equal, loss and EPE at
   ``tests/test_parallel.py``'s bounds, the weights at the JAX package's
   tolerance), each frame's launches, the halo audits (the transposed
   convolutions' one column a side, the correlation's 40). Prints ms a step
   and a frame a rank beside one process. (d) The same paths in the
   precision modes. On (b)'s ranks, under ``bf16_act``: the data-parallel
   step (B = 2 a rank), each model's width-sharded step and MAD session
   over 3 frames; under ``default`` each model's step; each against one
   process in the mode (loss 1e-3 relative, the gradient a bound of its
   largest entry) and against it at ``highest`` (under ``bf16_act`` at
   least half of the gradient's entries closer to the mode's), with their
   launches (the bf16 correlation under ``bf16_act``) and a bf16 halo
   through gloo's host staging, bit for bit. Then "vmap" and "unroll" at
   N = 2 under ``bf16_act`` on (a)'s frames, each stream against a single
   session in the mode and its first round's EPE against (a)'s at
   ``highest``. And the drift of the width-sharded MADNet step under
   ``bf16_act`` taken apart (``drift_parts``): each rank steps again with
   cuDNN's deterministic algorithms, with and without every weight's and
   bias's gradient summed in fp32 and never rounded to bf16
   (``exact_grad_sums``), and one process on the whole frame likewise;
   (a) the shapes' part, exact against exact, and (b) the rounding's
   part, the ranks' rounding less one process's; and one process with
   the algorithms cuDNN times and picks (``cudnn.benchmark``) against its
   usual ones at the same shapes, each printed.
14. The repository's tools on the port, through their functions: (a)
   ``tools/torch_validate_adaptation.py`` at its defaults (pretrain
   MADNet on scene A, 192x640, 400 steps; adapt on scene B, 60 frames) under
   ``highest`` and ``bf16_act``: each mode's EPE and D1 over the first and
   the last fifth printed, MAD and FULL ending below NONE in both; (b)
   ``tools/torch_probe_latency.py`` at 384x1280, the first run of the main
   path at that size: the wire, then every serving variant, each
   disparity handed back the session's own; (c)
   ``tools/torch_bench_offline.py`` at 384x1280 under ``bf16_act``, MADNet
   and DispNet-Corr1D at batches 1, 2, 4, 8, each batch's disparities
   within the mode's tolerance of batch 1's (the median relative
   difference within 0.05), then a short sweep at ``highest``, where each
   batch's must lie within 1e-4 of the largest of batch 1's. Each path's
   launches counted from 0 and held to the kernels it must run (the
   offline tool's exactly).
15. The papers' KITTI protocol runner, ``tools/torch_kitti_eval.py``
   (``main``, in-process), over a KITTI raw layout of the fixture scenes at
   320x1216 (``write_kitti_tree``: sequence ``city``, one drive of 17
   frames, and ``road``, two drives of 9 under two date directories; one
   frame of each drive without ground truth, dropped: 16 scored frames a
   sequence), from ``weights_scene01.npz``: (a) the CVPR table, MADNet
   NONE, MAD and FULL, SEQUENTIAL, and (b) the TPAMI one (``--proxyRoot``,
   the ground truth again), MAD SEQUENTIAL, each sequence's D1 within 0.25
   points of the JAX tool's row (``kitti_runs`` of
   ``torch_cli_reference.json``), the frames equal, EPE and resets printed
   beside the JAX row's; (c) the tool's defaults, MAD under PROBABILITY,
   the block switched on the device; (d) DispNet-Corr1D FULL over
   ``dispnet_full_6.json``, 8 frames a sequence, seeded weights, its FPS
   beside MADNet MAD's; (e) ``--listOnly``, and a TF1 checkpoint
   (``tf1_madnet_tiny``) imported into the tool's cache bit for bit and
   served, NONE, 2 frames. Every run's launches counted from 0 and summed
   by the blocks its fetch counter holds; the rows' frames, finite D1 and
   EPE and ``kitti_table.csv`` checked; FPS and the phase's wall time
   printed.
16. The accuracy-parity and precision-drift tools,
   ``tools/torch_parity_results.py`` and ``tools/torch_realworld_parity.py``
   (their ``main_parity``, ``main_realworld`` and ``main_drift``, in-process),
   MADNet's host session (``adapt/runner.py``), SEQUENTIAL, lr 1e-4, SSIMTh
   0.5: (a) the synthetic domain-shift sequence at 96x320, 50 frames, and (b)
   the fixture's scenes 2-3 and their photometrically asymmetric twins at
   320x1216, 16 frames, each from ``weights_scene01.npz``, NONE, MAD and FULL
   exact (gather warps, the plain correlation, ``highest``): each mode's
   mean D1 within 0.25 points of the JAX loop's on the same frames and
   weights (``tests/fixtures/torch_parity_reference.json``, made on the CPU
   by ``tools/torch_cli_reference.py --parity``), the resets equal, the
   largest per-frame D1 and EPE deltas and the north star's 0.5 verdict
   printed; (c) ``--drift`` at 96x320 and 384x1280, 50 frames, from MADNet
   pretrained for 200 steps at the run's size: each mode exact, then fast
   on the ``auto`` warps in ``default``, ``bf16`` and ``bf16_act``, at
   384x1280 also ``bf16_act`` on ``mxu`` (K6/K7); the tables in
   ``PARITY_RESULTS.md``'s form, each drift against the 0.1-point promotion
   bound, printed as a reading and not checked; every row finite. Every
   run's launches counted from 0: none in an exact run, in a fast one the
   sum of its frames' (the bf16 correlation instances under ``bf16_act``),
   and the TF32 flags those of the run's mode at every frame and off
   before and after each run.

Phase 3 also holds the graph switch (``graph_switch``, the counterpart of
the JAX session's ``lax.switch``) over bodies of one fill each, at 5 blocks
and 1 and 2 a draw: every ordered draw must run the body the plain lookup
names and be counted there, ids of no branch run none and raise; its
launch is timed beside a direct replay of a body and the plain lookup.

Prints the card line, the ms/frame of the host and the fused sessions by
mode and precision, a JSON line of the seventeen kernels, and as the last line
``{"ok": true, "device": {"platform": "gpu", ...}}``. Exits non-zero,
with no result, when no CUDA device is available or the port is missing.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

H, W = 320, 1216  # cli/adapt.py default frame size
N_FRAMES_NONE = 5
N_FRAMES_MAD = 10  # two SEQUENTIAL rounds; the first carries cuDNN's set-up of each block's backward
N_FRAMES_FUSED = 20  # four rounds: two checked frame by frame, two free-running
N_FRAMES_FULL = 5
LR = 1e-4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores, published
# H100 SXM bf16 tensor cores, dense, fp32 accumulate, published: the peak for
# products of bf16 operands summed in fp32, which the bf16 instances compute
BF16_FLOPS = 989e12
RADIUS = 2  # MADNet radius_d
MAX_DISP = 192  # warp_max_disp
MAX_POS = 4
# MADNet's main-path shapes (NCHW) at 320x1216: (level channels, downscale factor)
CORR_LEVELS = [(192, 64), (128, 32), (96, 16), (64, 8), (32, 4)]  # scales 6..2
FEAT_LEVELS = CORR_LEVELS[1:]  # the feature warp runs at scales 5..2
CORR_TOL = dict(rtol=1e-5, atol=1e-5)  # fp32 sums over C in another order
WARP_TOL = dict(rtol=0.0, atol=1e-6)  # same roundings as the plain version
# tiled kernels against the one-hot product, whose matmul may fuse the
# second product into the sum (one rounding of w1*b less): an ulp of the
# largest source value, which for unit-normal sources stays under 5
ONEHOT_TOL = dict(rtol=0.0, atol=2e-6)
MODEL_RTOL = 1e-4  # of the largest disparity; the JAX package's figure vs TF1
# backward kernels: of the largest entry of each gradient. They add in a
# fixed order; the plain versions (autograd, whose scatter uses atomics on
# the card) in another.
BWD_RTOL = 1e-5
# one step, kernels vs plain modes: the gradient and the parameter change,
# each of its largest entry
STEP_RTOL = 5e-4
# DispNet-Corr1D: its correlation's radius and the shape of that call
# (conv2's features at 1/4 resolution); two shapes that only check the
# wide kernels: W < 2R+1, and a width that is no multiple of the tile
DN_RADIUS = 40
DN_CORR_SHAPE = (1, 128, H // 4, W // 4)
WIDE_CHECK_SHAPES = [(1, 128, 5, 19), (1, 128, 12, 150)]
DN_BLOCK_CONFIG = str(Path(__file__).resolve().parent / "block_config" / "dispnet_full_6.json")
# phase 14: the frame of the tools (tools/torch_probe_latency.py,
# tools/torch_bench_offline.py) and of bench.py, whose width is a multiple
# of the tiled warps' 128-column tile; the offline tool's largest batch
TOOLS_H, TOOLS_W = 384, 1280
TOOLS_FRAME = f"{TOOLS_H}x{TOOLS_W}"
OFFLINE_BATCH = 8
# phase 9: the CLIs on the real frames of tests/fixtures/realworld (320x1216,
# the fixture's own size), from MADNet weights trained on scenes 0-1
ROOT = Path(__file__).resolve().parent
FIXTURE_DIR = ROOT / "tests" / "fixtures" / "realworld"
CLI_WEIGHTS = FIXTURE_DIR / "weights_scene01.npz"
CLI_REFERENCE = ROOT / "tests" / "fixtures" / "torch_cli_reference.json"
CLI_FRAMES = 32
CLI_DN_FRAMES = 8
CLI_SCENES = {"scene": ("scene2", "scene3"), "asym": ("asym2", "asym3")}
CLI_FLAGS = ["--imageShape", str(H), str(W), "--sampleMode", "SEQUENTIAL", "--lr", "1e-4", "--SSIMTh", "0.5"]
# the runs held against the JAX package's CLIs: name -> (CLI, scenes, mode,
# conv precision); tools/torch_cli_reference.py makes their rows on the CPU
CLI_REFERENCE_RUNS = {
    "adapt_scene_NONE": ("adapt", "scene", "NONE", "highest"),
    "adapt_scene_MAD": ("adapt", "scene", "MAD", "highest"),
    "adapt_asym_NONE": ("adapt", "asym", "NONE", "highest"),
    "adapt_asym_MAD": ("adapt", "asym", "MAD", "highest"),
    "adapt_asym_FULL": ("adapt", "asym", "FULL", "highest"),
    "evaluate_scene": ("evaluate", "scene", None, "highest"),
    "evaluate_scene_default": ("evaluate", "scene", None, "default"),
    "evaluate_scene_bf16": ("evaluate", "scene", None, "bf16"),
    "evaluate_scene_bf16_act": ("evaluate", "scene", None, "bf16_act"),
    "adapt_scene_MAD_bf16_act": ("adapt", "scene", "MAD", "bf16_act"),
}
# points of D1 against the JAX CLI: half the 0.5 of PARITY_RESULTS.md. On
# the H100 the port read at most 0.0153 from it at `highest` and 0.1643 in
# `evaluate --precision bf16`, where the JAX CLI on the CPU lets XLA carry
# fp32 across the mode's bf16 roundings (xla_allow_excess_precision)
CLI_D1_BOUND = 0.25
# the evaluate runs that also have witness rows (tools/torch_cli_reference.py
# --strict): the JAX CLI with every bf16 rounding kept, held to
# CLI_WITNESS_BOUND, and the port's own evaluate on the CPU, printed
CLI_WITNESS_RUNS = ("evaluate_scene", "evaluate_scene_default", "evaluate_scene_bf16", "evaluate_scene_bf16_act")
CLI_WITNESS_BOUND = 0.1
# points of D1 against `highest`, the JAX package's promotion bound: held
# where the JAX package meets it on these frames (check_drift)
CLI_DRIFT_BOUND = 0.1
EVAL_BATCH = 4  # cli/evaluate.py's default --batch
EVAL_PRECISIONS = ("highest", "default", "bf16", "bf16_act")
# phase 10: cli/adapt_continual.py and cli/train.py on the same frames,
# against the JAX package's CLIs (the file's "phase10_runs"): name ->
# (CLI, scenes, flags). The continual lists' 4th column, the proxy, is the
# scene's own ground truth: the repository holds no proxy maps
CONTINUAL_FLAGS = ["--imageShape", str(H), str(W), "--blockConfig", str(ROOT / "block_config" / "MadNet_full.json"),
                   "--lr", "1e-4", "--seed", "0"]
TRAIN_FLAGS = ["--imageShape", str(H), str(W), "--batchSize", "4", "--augment", "--numEpochs", "1",
               "--seed", "0"]
PHASE10_REFERENCE_RUNS = {
    "continual_scene_MAD": ("adapt_continual", "scene", ["--mode", "MAD", "--sampleMode", "SEQUENTIAL"]),
    "continual_scene_FIXED_2_3": ("adapt_continual", "scene",
                                  ["--mode", "MAD", "--sampleMode", "FIXED", "--fixedID", "2", "3"]),
    "continual_scene_FULL_dilation2": ("adapt_continual", "scene", ["--mode", "FULL", "--dilation", "2"]),
    # train (8 steps of 4 frames), then evaluate its last checkpoint at `highest`, batch 4
    "train_evaluate_scene": ("train", "scene", TRAIN_FLAGS),
}
TRAIN_STEPS = CLI_FRAMES // 4
# phase 11: the live demo (cli/demo.py), headless, on the same frames: (a)
# its defaults (rescale to 480x640, crop to 320x512, MAD, PROBABILITY,
# fused), (b) the full width against the JAX demo (the file's "demo_runs",
# made by tools/torch_cli_reference.py), fused and host, (c) FULL, fused
DEMO_FRAMES = 32
DEMO_FULL_FRAMES = 8
DEMO_FLAGS = ["--weights", str(CLI_WEIGHTS), "--blockConfig", str(ROOT / "block_config" / "MadNet_full.json"),
              "--camera", "folder", "--display", "none", "--seed", "0"]
# The demo adapts with Adam, which divides each weight's gradient by its
# own size, so where a gradient is near 0 float32 rounding picks the sign of
# a step of about lr: two correct runs part within a few frames, and their
# 32 frames' D1 differ by points. Moving each starting weight by at most
# one ulp does the same (perturbed_weights). Over seeds 0-7 the JAX demo's
# 32-frame D1 reads 58.555-62.922, the port's on the CPU 58.294-59.349, on
# the card 57.691-63.466 (56 runs in all, sd 1.38; tools/torch_demo_seeds.py),
# and the mean of 8 seeds on the card 60.434 in one call and 59.570 in the
# next. So the port is held to the JAX demo a frame at a time over the
# first DEMO_EARLY_FRAMES frames, before the runs part, at CLI_D1_BOUND,
# from each of DEMO_SEEDS starting points; and the mean over those
# starting points of the 32 frames' D1 at DEMO_D1_BOUND, some 4 sd of the
# difference of two such means (1.38 * sqrt(2 / 8)): it catches a fault of
# the later frames, not a drift
DEMO_EARLY_FRAMES = 3
DEMO_D1_BOUND = 3.0
DEMO_SEEDS = 8
DEMO_REFERENCE_RUNS = {
    "demo_scene_MAD": ["--imageShape", "-1", "--cropShape", str(H), str(W), "--mode", "MAD",
                       "--sampleMode", "SEQUENTIAL"],
}
# phase 15: tools/torch_kitti_eval.py over a KITTI raw layout of the fixture
# scenes (write_kitti_tree): drive -> (date directory, scenes cycled, frames,
# the frames without ground truth, which the tool drops)
KITTI_DRIVES = {
    "2011_09_26_drive_0001_sync": ("2011_09_26", CLI_SCENES["scene"], 17, (16,)),
    "2011_09_26_drive_0002_sync": ("2011_09_26", CLI_SCENES["asym"], 9, (4,)),
    "2011_09_28_drive_0003_sync": ("2011_09_28", CLI_SCENES["asym"], 9, (0,)),
}
KITTI_SEQUENCES = {"city": ("2011_09_26_drive_0001_sync",),
                   "road": ("2011_09_26_drive_0002_sync", "2011_09_28_drive_0003_sync")}
KITTI_FRAMES = 16  # the frames with ground truth, a sequence
KITTI_DN_FRAMES = 8
# the runs held against the JAX tool's rows (the file's "kitti_runs", made by
# tools/torch_cli_reference.py --kitti): name -> (proxy labels, flags); the
# tool's defaults otherwise (MADNet, MadNet_full.json, lr 1e-4, SSIMTh 0.5, seed 0)
KITTI_REFERENCE_RUNS = {
    "cvpr_NONE": (False, ["--mode", "NONE", "--sampleMode", "SEQUENTIAL"]),
    "cvpr_MAD": (False, ["--mode", "MAD", "--sampleMode", "SEQUENTIAL"]),
    "cvpr_FULL": (False, ["--mode", "FULL", "--sampleMode", "SEQUENTIAL"]),
    "tpami_MAD": (True, ["--mode", "MAD", "--sampleMode", "SEQUENTIAL"]),
}
# phase 16: the JAX loop's rows (tools/parity_results.py::run_our_loop, exact,
# NONE, MAD and FULL) that the parity tools are held to, made on a CPU by
# tools/torch_cli_reference.py --parity: name -> (sequence kind, height,
# width, frames, fixture scenes, weights; None: the JAX MADNet's PRNGKey(0)
# init, the CPU tests' set)
PARITY_REFERENCE = ROOT / "tests" / "fixtures" / "torch_parity_reference.json"
PARITY_SETS = {
    "synthetic": ("synthetic", 96, 320, 50, None, CLI_WEIGHTS),
    "realworld_scene": ("realworld", H, W, 16, CLI_SCENES["scene"], CLI_WEIGHTS),
    "realworld_asym": ("realworld", H, W, 16, CLI_SCENES["asym"], CLI_WEIGHTS),
    "small": ("synthetic", 64, 128, 4, None, None),
}


def write_cli_list(directory, scenes, n: int, proxy: bool = False) -> str:
    """A list file of ``n`` lines cycling the fixture ``scenes``
    (``left,right,gt``, absolute paths); with ``proxy``, a 4th column, the
    gt again, for the continual CLI's proxy labels."""
    parts = ("left", "right", "gt", "gt") if proxy else ("left", "right", "gt")
    path = Path(directory) / f"{'_'.join(scenes)}_{n}{'_proxy' if proxy else ''}.csv"
    lines = []
    for i in range(n):
        s = scenes[i % len(scenes)]
        lines.append(",".join(str(FIXTURE_DIR / f"{s}_{part}.png") for part in parts))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def write_kitti_tree(directory) -> dict:
    """A KITTI raw layout of the fixture scenes under ``directory``:
    ``raw/<date>/<drive>/image_02/data/0000000NNN.png`` (left, a link to
    the scene's), ``image_03/...`` (right), ``gt/<drive>/0000000NNN.png``
    (the 16-bit ground truth) and ``proxy/<drive>/...`` (the ground truth
    again: the repository holds no proxy maps), by ``KITTI_DRIVES``.
    Returns the roots and the ``--sequences`` spec of ``KITTI_SEQUENCES``."""
    root = Path(directory)
    tree = {k: str(root / k) for k in ("raw", "gt", "proxy")}
    for drive, (date, scenes, n, no_gt) in KITTI_DRIVES.items():
        ddir = root / "raw" / date / drive
        for j in range(n):
            name = f"{j:010d}.png"
            links = {ddir / "image_02" / "data": "left", ddir / "image_03" / "data": "right"}
            if j not in no_gt:
                links.update({root / "gt" / drive: "gt", root / "proxy" / drive: "gt"})
            for folder, part in links.items():
                folder.mkdir(parents=True, exist_ok=True)
                os.symlink(FIXTURE_DIR / f"{scenes[j % len(scenes)]}_{part}.png", folder / name)
    tree["sequences"] = ";".join(f"{k}={','.join(v)}" for k, v in KITTI_SEQUENCES.items())
    return tree


def kitti_argv(tree: dict, out: str, proxy: bool, flags, weights=CLI_WEIGHTS) -> list:
    """``tools/torch_kitti_eval.py``'s (and ``tools/kitti_eval.py``'s) flags
    over :func:`write_kitti_tree`'s ``tree``."""
    return ["--kittiRoot", tree["raw"], "--gtRoot", tree["gt"], *(["--proxyRoot", tree["proxy"]] if proxy else []),
            "--weights", str(weights), "--sequences", tree["sequences"], "--output", out, *flags]


def demo_png_metrics(out_dir, list_file, crop=(H, W)):
    """(file names, per-frame EPE, per-frame D1) of the demo's PNGs
    ``disparity_00001.png`` ... (frame i of the list is PNG i + 1) against
    the list's ground truth, centre-cropped to ``crop`` as the demo crops
    its frames; the metrics of ``adapt/engine.py::d1_metric`` on the PNGs'
    ``disp * 256`` steps."""
    from real_time_self_adaptive_deep_stereo_torch.data.png import read_png
    from real_time_self_adaptive_deep_stereo_torch.data.readers import center_crop_or_pad, read_list_file

    _, _, gts, _ = read_list_file(str(list_file))
    files = sorted(f for f in Path(out_dir).iterdir() if f.suffix == ".png")
    epe, d1 = [], []
    for i, f in enumerate(files):
        disp = read_png(str(f)).astype(np.float32) / 256.0
        gt = center_crop_or_pad(read_png(gts[i]).astype(np.float32)[..., None] / 256.0, *crop)[..., 0]
        valid = gt > 0
        err = np.abs(disp - gt)
        n = max(int(valid.sum()), 1)
        d1.append(100.0 * float((valid & (err > 3.0) & (err / np.maximum(gt, 1e-9) >= 0.05)).sum()) / n)
        epe.append(float(np.where(valid, err, 0.0).sum()) / n)
    return [f.name for f in files], np.asarray(epe), np.asarray(d1)


def perturbed_weights(seed: int, directory) -> str:
    """The demo's starting weights for ``seed``: ``CLI_WEIGHTS`` itself
    for seed 0, else a copy in ``directory`` in which each float32 weight
    is moved one ulp up, one ulp down or kept, drawn from
    ``numpy.random.default_rng(seed)`` over the arrays in name order."""
    if seed == 0:
        return str(CLI_WEIGHTS)
    rng = np.random.default_rng(seed)
    with np.load(CLI_WEIGHTS) as z:
        weights = {k: z[k] for k in sorted(z.files)}
    for k, w in weights.items():
        step = rng.integers(-1, 2, size=w.shape)
        weights[k] = np.where(step == 0, w, np.nextafter(w, np.where(step > 0, np.inf, -np.inf).astype(w.dtype)))
    path = Path(directory) / f"weights_scene01_seed{seed}.npz"
    np.savez(path, **weights)
    return str(path)

_JAX_OPS = "real_time_self_adaptive_deep_stereo_tpu/ops"
REPLACES = {
    "corr_fwd": f"{_JAX_OPS}/correlation.py:53",
    # the same Pallas kernel at any radius (DispNet's 40)
    "corr_fwd_wide": f"{_JAX_OPS}/correlation.py:53",
    "warp_image_fwd": f"{_JAX_OPS}/warp_pallas.py:69",
    "warp_features_fwd": f"{_JAX_OPS}/warp_pallas.py:247",
    # no Pallas kernel: the plain-jnp backward of the custom_vjp around _corr_fwd_kernel
    "corr_bwd": f"{_JAX_OPS}/correlation.py:117",
    "corr_bwd_wide": f"{_JAX_OPS}/correlation.py:117",
    "warp_image_bwd": f"{_JAX_OPS}/warp_pallas.py:99",
    "warp_features_bwd": f"{_JAX_OPS}/warp_pallas.py:271",
    # one Pallas kernel each way serves both samplings; the port gives each its entry point
    "warp_tile_image_fwd": f"{_JAX_OPS}/warp_pallas.py:460",
    "warp_tile_features_fwd": f"{_JAX_OPS}/warp_pallas.py:460",
    "warp_tile_image_bwd": f"{_JAX_OPS}/warp_pallas.py:495",
    "warp_tile_features_bwd": f"{_JAX_OPS}/warp_pallas.py:495",
    # the bf16 instances of K1 and of its backward: the features under the
    # JAX package's bf16_act precision mode
    "corr_fwd_bf16": f"{_JAX_OPS}/correlation.py:53",
    "corr_bwd_bf16": f"{_JAX_OPS}/correlation.py:117",
    "corr_fwd_wide_bf16": f"{_JAX_OPS}/correlation.py:53",
    "corr_bwd_wide_bf16": f"{_JAX_OPS}/correlation.py:117",
    # no Pallas kernel: the JAX fused session's lax.switch over the sampled
    # block's branches, which the port runs as a CUDA graph's SWITCH node
    "graph_switch": "real_time_self_adaptive_deep_stereo_tpu/adapt/fused.py:495",
}
_CSRC = "real_time_self_adaptive_deep_stereo_torch/csrc"
SOURCES = {
    name: f"{_CSRC}/{'correlation' if name.startswith('corr') else 'graph_switch' if name == 'graph_switch' else 'warp_tile' if 'tile' in name else 'warp'}.cu"
    for name in REPLACES
}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps: int = 20, inner: int = 20) -> float:
    """Device time of one call of ``fn``: ``inner`` calls are captured in a
    CUDA graph, and the median over ``reps`` CUDA-event-timed replays is
    divided by ``inner``. The graph takes the host's launch cost out, so
    kernel, plain version and library call are timed alike."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


L2_FLUSH_BYTES = 100 * 2**20  # twice the H100's 50 MB L2


def cold_ms(fn) -> float:
    """Device time of one call of ``fn`` with the L2 cold, as a call in a
    frame finds it after other kernels: :func:`time_ms` of a write over
    ``L2_FLUSH_BYTES`` followed by the call, less :func:`time_ms` of the
    write alone."""
    buf = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    flush = lambda: buf.fill_(1.0)  # noqa: E731
    return time_ms(lambda: (flush(), fn())) - time_ms(flush)


def call_ms(fn, reps: int = 200) -> float:
    """Time of one eager call as the main path makes it, launch cost
    included: ``reps`` calls between two CUDA events, per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_flops: float, peak_flops: float = FP32_FLOPS):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def seeded(shape, seed, lo=None, hi=None):
    r = np.random.default_rng(seed)
    a = r.standard_normal(shape) if lo is None else r.random(shape) * (hi - lo) + lo
    return torch.from_numpy(a.astype(np.float32)).cuda()


def grid_for(shift: torch.Tensor, sign: float) -> torch.Tensor:
    """grid_sample grid (align_corners=True) sampling row h at x + sign*shift."""
    b, _, h, w = shift.shape
    xs = torch.arange(w, device=shift.device, dtype=torch.float32)
    ys = torch.arange(h, device=shift.device, dtype=torch.float32)
    gx = (xs + sign * shift[:, 0]) * (2.0 / (w - 1)) - 1.0
    gy = (ys * (2.0 / (h - 1)) - 1.0)[None, :, None].expand(b, h, w)
    return torch.stack([gx, gy], dim=-1).contiguous()


PADDING_MODES = {"zeros": 0, "border": 1}  # aten's codes of grid_sample's padding_mode
# the variants of a warp backward: the gradients (dsrc, doff) asked for
VARIANTS = {"both": (True, True), "doff": (False, True), "dsrc": (True, False)}
# the variant each mode that runs a backward asks of a warp (NONE runs
# none): the right image never takes a gradient; the feature warp's offset
# takes none with MAD's bulkhead, and one in FULL, which has no bulkhead
IMAGE_MODES = {"MAD": "doff", "FULL": "doff"}
FEATURE_MODES = {"MAD": "dsrc", "FULL": "both"}


def grid_sample_bwd(g, src, grid, padding: str, mask):
    """The backward of ``F.grid_sample(src, grid, "bilinear", padding,
    align_corners=True)`` for the output gradient ``g``, as the one op that
    autograd runs for it: ``(dsrc, dgrid)``, where ``mask`` says which are
    asked for. Unlike ``torch.autograd.grad``, a CUDA graph captures it
    like any kernel. A gradient that is not asked for is None; the op
    computes the grid's all the same, on the CPU and on the card."""
    dsrc, dgrid = torch.ops.aten.grid_sampler_2d_backward(
        g, src, grid, 0, PADDING_MODES[padding], True, list(mask)
    )
    return (dsrc if mask[0] else None), (dgrid if mask[1] else None)


# ------------------------------------------------------------------ phase 3
def assert_grad_close(got, want, what):
    scale = float(want.abs().max())
    if not scale > 0:
        raise AssertionError(f"{what}: the plain gradient is all zero")
    err = float((got - want).abs().max())
    if not err <= BWD_RTOL * scale:
        raise AssertionError(f"{what}: max abs err {err:.3g} > {BWD_RTOL} * {scale:.3g}")
    return err


def assert_same_bits(first, second, what):
    for a, b in zip(first, second):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: two runs on the same input differ")


def check_kernels(ops):
    """Every kernel at its main-path shapes against its plain version."""
    rows = {name: [] for name in REPLACES}
    check_frame_kernels(ops, rows, H, W)
    check_wide_kernels(ops, rows)
    check_rank_wide_kernels(ops, rows)
    check_bf16_kernels(ops, rows)
    check_tool_kernels(ops, rows)
    check_batch_kernels(ops, rows)
    check_batch_kernels(ops, rows, DP_BATCH // DP_WORLD)
    for n in VMAP_COUNTS:
        check_vmap_kernels(rows, n)
    for m in SWITCH_DRAWS:
        check_switch_kernel(rows, m)
    log_kernel_rows(rows)
    return rows


# the graph switch at MADNet's 5 blocks, one and two blocks a frame (phase 6)
SWITCH_BLOCKS = 5
SWITCH_DRAWS = (1, 2)


def check_switch_kernel(rows, m: int, n: int = SWITCH_BLOCKS):
    """The graph switch (``csrc/graph_switch.cu``) over ``C(n, m)`` bodies,
    body k one fill that writes k + 1: every ordered draw of m distinct
    blocks must run the body that the plain lookup names, once, and be
    counted there; ids of no branch (repeated, out of range) run none and
    raise at the next read. Timed: one launch of the parent (CUDA events
    over back-to-back launches, the host's launch included, as the session
    launches it) beside one replay of a body's own graph taken the same
    way (``direct_ms``), and the plain lookup, from a graph (``plain_ms``)
    and called eagerly (``plain_call_ms``). Its bound: the m ids, one table
    entry and one count read and written, over the memory rate."""
    import itertools

    from real_time_self_adaptive_deep_stereo_torch.ops.graph_switch import (
        GraphSwitch,
        branch_sets,
        branch_table,
        switch_index_torch,
    )

    table = branch_table(n, m, "cuda")
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    ids = torch.zeros(m, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    bodies = []
    for k in range(len(branch_sets(n, m))):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g, stream=side):
            out.fill_(k + 1)
        bodies.append(g)
    switch = GraphSwitch([[g.raw_cuda_graph() for g in bodies]], [ids], n, table)
    draws = list(itertools.permutations(range(n), m))
    got, want = [], []
    for draw in draws:
        ids.copy_(torch.tensor(draw, dtype=torch.int32))
        out.zero_()
        switch.launch()
        got.append(out.clone())
        want.append(switch_index_torch(ids, table, n) + 1)
    got, want = torch.cat(got), torch.stack(want)
    err = int((got - want).abs().max())
    counts = switch.taken()[0]
    if err or counts.tolist() != torch.bincount(want.cpu().long() - 1, minlength=len(bodies)).tolist():
        raise AssertionError(f"graph_switch, {m} of {n}: bodies run {got.tolist()}, want {want.tolist()}; "
                             f"counts {counts.tolist()}")
    for bad in ([0] * m, [n] + list(range(m - 1))):
        if len(set(bad)) == m and max(bad) < n:
            continue  # m = 1: [0] names a branch
        ids.copy_(torch.tensor(bad, dtype=torch.int32))
        out.zero_()
        switch.launch()
        try:
            switch.taken()
        except RuntimeError:
            pass
        else:
            raise AssertionError(f"graph_switch: ids {bad} name no branch, and no error was raised")
        if int(out[0]):
            raise AssertionError(f"graph_switch: ids {bad} name no branch, and body {int(out[0]) - 1} ran")
        switch.status[-1].zero_()
    ids.copy_(torch.tensor(draws[len(draws) // 2], dtype=torch.int32))
    bodies[0].replay()  # instantiated by PyTorch at its first replay
    rows["graph_switch"].append(dict(
        shape=[m], blocks=n, branches=len(bodies),
        draws=len(draws), err=err, tol=0,
        ms=call_ms(switch.launch), direct_ms=call_ms(bodies[0].replay),
        plain_ms=time_ms(lambda: switch_index_torch(ids, table, n)),
        plain_call_ms=call_ms(lambda: switch_index_torch(ids, table, n)),
        library_ms=None,
        bound=bound(4.0 * (m + 3), 0.0),
    ))
    torch.cuda.synchronize()
    switch.close()


def check_frame_kernels(ops, rows, h, w, **tags):
    """At batch 1 on an ``h`` x ``w`` frame, against their plain versions
    and timed into ``rows`` (each row with ``tags``): K1 and its backward
    at MADNet's five scales, the image warps K2/K4 and K6/K7 on the frame,
    the feature warps K3/K5 and K6/K7 at K1's last four scales."""
    import torch.nn.functional as F

    k = 2 * RADIUS + 1
    for i, (c, f) in enumerate(CORR_LEVELS):
        shape = (1, c, h // f, w // f)
        n = shape[2] * shape[3]
        x, y = seeded(shape, 10 + i), seeded(shape, 20 + i)
        got, want = ops.correlation_cuda(x, y, RADIUS), ops.correlation_torch(x, y, RADIUS)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **CORR_TOL)
        rows["corr_fwd"].append(dict(
            shape=list(shape), err=float((got - want).abs().max()), tol=CORR_TOL, **tags,
            ms=time_ms(lambda: ops.correlation_cuda(x, y, RADIUS)),
            cold_ms=cold_ms(lambda: ops.correlation_cuda(x, y, RADIUS)),
            call_ms=call_ms(lambda: ops.correlation_cuda(x, y, RADIUS)),
            plain_ms=time_ms(lambda: ops.correlation_torch(x, y, RADIUS)),
            library_ms=None,
            bound=bound(4.0 * n * (2 * c + k), 2.0 * n * c * k),
            # for the record: the wide kernel forced at this radius
            wide_ms=time_ms(lambda: ops.correlation_cuda(x, y, RADIUS, wide=True)),
        ))
        torch.testing.assert_close(ops.correlation_cuda(x, y, RADIUS, wide=True), want, **CORR_TOL)

        g = seeded((1, k, *shape[2:]), 60 + i)
        got = ops.correlation_bwd_cuda(x, y, g, RADIUS)
        again = ops.correlation_bwd_cuda(x, y, g, RADIUS)
        want = ops.correlation_torch_bwd(x, y, g, RADIUS)
        torch.cuda.synchronize()
        errs = [assert_grad_close(a, b, f"corr_bwd {shape} {nm}") for a, b, nm in zip(got, want, ("dx", "dy"))]
        assert_same_bits(got, again, f"corr_bwd {shape}")
        rows["corr_bwd"].append(dict(
            shape=list(shape), err=max(errs), tol=f"{BWD_RTOL} of the largest entry", **tags,
            ms=time_ms(lambda: ops.correlation_bwd_cuda(x, y, g, RADIUS)),
            cold_ms=cold_ms(lambda: ops.correlation_bwd_cuda(x, y, g, RADIUS)),
            call_ms=call_ms(lambda: ops.correlation_bwd_cuda(x, y, g, RADIUS)),
            plain_ms=time_ms(lambda: ops.correlation_torch_bwd(x, y, g, RADIUS)),
            library_ms=None,
            # reads x, y, g once, writes dx, dy; 3 flops per (element, shift) and output
            bound=bound(4.0 * n * (4 * c + k), 6.0 * n * c * k),
        ))

    img = seeded((1, 3, h, w), 30)
    disp = seeded((1, 1, h, w), 31, -20.0, MAX_DISP + 40.0)  # crosses 0 and max_disp
    got, want = ops.warp_image_cuda(img, disp, MAX_DISP), ops.warp_image_clamped(img, disp, MAX_DISP)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **WARP_TOL)
    grid = grid_for(disp.clamp(0.0, MAX_DISP), -1.0)
    lib = lambda: F.grid_sample(img, grid, "bilinear", "border", align_corners=True)  # noqa: E731
    rows["warp_image_fwd"].append(dict(
        shape=list(img.shape), err=float((got - want).abs().max()), tol=WARP_TOL, **tags,
        lib_err=float((lib() - want).abs().max()),
        ms=time_ms(lambda: ops.warp_image_cuda(img, disp, MAX_DISP)),
        call_ms=call_ms(lambda: ops.warp_image_cuda(img, disp, MAX_DISP)),
        plain_ms=time_ms(lambda: ops.warp_image_clamped(img, disp, MAX_DISP)),
        library_ms=time_ms(lib),
        bound=bound(4.0 * h * w * (3 + 1 + 3), 3.0 * 3 * h * w),
    ))
    rows["warp_image_bwd"].append(dict(check_warp_bwd(
        "warp_image_bwd", img, disp, 70, grid, "border",
        lambda s, o, g, need=(True, True): ops.warp_image_bwd_cuda(s, o, g, MAX_DISP, *need),
        lambda s, o: ops.warp_image_clamped(s, o, MAX_DISP),
        IMAGE_MODES,
    ), **tags))

    # the tiled one-hot image warp: against its plain version (the one-hot
    # product over the padded row) and against warp_image_fwd / warp_image_bwd,
    # which compute the same function
    got = ops.warp_image_mxu(img, disp, MAX_DISP)
    want = ops.warp_image_onehot(img, disp, MAX_DISP, align=128)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ONEHOT_TOL)
    if not torch.equal(got, ops.warp_image_cuda(img, disp, MAX_DISP)):
        raise AssertionError("warp_tile_image_fwd: differs from warp_image_fwd, a gather of the same taps")
    rows["warp_tile_image_fwd"].append(dict(
        shape=list(img.shape), err=float((got - want).abs().max()), tol=ONEHOT_TOL, **tags,
        lib_err=float((lib() - want).abs().max()),
        ms=time_ms(lambda: ops.warp_image_mxu(img, disp, MAX_DISP)),
        call_ms=call_ms(lambda: ops.warp_image_mxu(img, disp, MAX_DISP)),
        plain_ms=time_ms(lambda: ops.warp_image_onehot(img, disp, MAX_DISP, align=128), inner=2),
        library_ms=time_ms(lib),
        bound=bound(4.0 * h * w * (3 + 1 + 3), 3.0 * 3 * h * w),
    ))
    rows["warp_tile_image_bwd"].append(dict(check_warp_bwd(
        "warp_tile_image_bwd", img, disp, 70, grid, "border",
        lambda s, o, g, need=(True, True): ops.warp_image_mxu_bwd(s, o, g, MAX_DISP, *need),
        lambda s, o: ops.warp_image_onehot(s, o, MAX_DISP, align=128),
        IMAGE_MODES,
        same_as=lambda s, o, g: ops.warp_image_bwd_cuda(s, o, g, MAX_DISP),
    ), **tags))

    for i, (c, f) in enumerate(FEAT_LEVELS):
        shape = (1, c, h // f, w // f)
        neg = -(-MAX_DISP // f)
        feats = seeded(shape, 40 + i)
        dx = seeded((1, 1, *shape[2:]), 50 + i, -neg - 10.0, MAX_POS + 6.0)  # outside the window
        got = ops.warp_features_cuda(feats, dx, neg, MAX_POS)
        want = ops.warp_features_clamped(feats, dx, neg, MAX_POS)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **WARP_TOL)
        grid = grid_for(dx.clamp(-neg, MAX_POS), 1.0)
        lib = lambda: F.grid_sample(feats, grid, "bilinear", "zeros", align_corners=True)  # noqa: E731
        n = shape[2] * shape[3]
        rows["warp_features_fwd"].append(dict(
            shape=list(shape), max_neg=neg, err=float((got - want).abs().max()), tol=WARP_TOL, **tags,
            lib_err=float((lib() - want).abs().max()),
            ms=time_ms(lambda: ops.warp_features_cuda(feats, dx, neg, MAX_POS)),
            call_ms=call_ms(lambda: ops.warp_features_cuda(feats, dx, neg, MAX_POS)),
            plain_ms=time_ms(lambda: ops.warp_features_clamped(feats, dx, neg, MAX_POS)),
            library_ms=time_ms(lib),
            bound=bound(4.0 * n * (2 * c + 1), 3.0 * c * n),
        ))
        rows["warp_features_bwd"].append(dict(check_warp_bwd(
            "warp_features_bwd", feats, dx, 80 + i, grid, "zeros",
            lambda s, o, g, need=(True, True), neg=neg: ops.warp_features_bwd_cuda(
                s, o, g, neg, MAX_POS, *need),
            lambda s, o, neg=neg: ops.warp_features_clamped(s, o, neg, MAX_POS),
            FEATURE_MODES,
        ), **tags))

        got = ops.warp_features_mxu(feats, dx, neg, MAX_POS)
        want = ops.warp_features_onehot(feats, dx, neg, MAX_POS, align=128)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **ONEHOT_TOL)
        torch.testing.assert_close(got, ops.warp_features_cuda(feats, dx, neg, MAX_POS), **WARP_TOL)
        rows["warp_tile_features_fwd"].append(dict(
            shape=list(shape), max_neg=neg, err=float((got - want).abs().max()), tol=ONEHOT_TOL, **tags,
            lib_err=float((lib() - want).abs().max()),
            ms=time_ms(lambda: ops.warp_features_mxu(feats, dx, neg, MAX_POS)),
            call_ms=call_ms(lambda: ops.warp_features_mxu(feats, dx, neg, MAX_POS)),
            plain_ms=time_ms(lambda: ops.warp_features_onehot(feats, dx, neg, MAX_POS, align=128)),
            library_ms=time_ms(lib),
            bound=bound(4.0 * n * (2 * c + 1), 3.0 * c * n),
        ))
        rows["warp_tile_features_bwd"].append(dict(check_warp_bwd(
            "warp_tile_features_bwd", feats, dx, 80 + i, grid, "zeros",
            lambda s, o, g, need=(True, True), neg=neg: ops.warp_features_mxu_bwd(
                s, o, g, neg, MAX_POS, *need),
            lambda s, o, neg=neg: ops.warp_features_onehot(s, o, neg, MAX_POS, align=128),
            FEATURE_MODES,
            same_as=lambda s, o, g, neg=neg: ops.warp_features_bwd_cuda(s, o, g, neg, MAX_POS),
        ), **tags))


def log_kernel_rows(rows):
    """Each row, then each kernel's sums: over the main-path shapes at 320x1216,
    on a rank, at each batch, under vmap and at the tools' frame."""
    for name, rs in rows.items():
        for r in rs:
            if "bound" in r:
                r["bound_ms"], r["bound_by"] = r.pop("bound")
            log(f"kernel {name} {r}")
    for name, all_rs in rows.items():  # summed over the main-path shapes
        rs = main_rows(all_rs)
        framed = [r for r in all_rs if r.get("frame") == TOOLS_FRAME and "batch" not in r]
        if framed:
            log(f"kernel {name} at {TOOLS_FRAME}: {sum(r['ms'] for r in framed):.5f} ms over "
                f"{len(framed)} shape(s), bound {sum(r['bound_ms'] for r in framed):.5f}, "
                f"plain {sum(r['plain_ms'] for r in framed):.5f}")
        ranked = [r for r in all_rs if "ranks" in r]
        if ranked:
            log(f"kernel {name} on a rank of {ranked[0]['ranks']}: {sum(r['ms'] for r in ranked):.5f} ms over "
                f"{len(ranked)} shape(s), bound {sum(r['bound_ms'] for r in ranked):.5f}, "
                f"plain {sum(r['plain_ms'] for r in ranked):.5f}")
        for b, batch in by_batch(all_rs).items():
            log(f"kernel {name} at batch {b}: {sum(r['ms'] for r in batch):.5f} ms over "
                f"{len(batch)} shape(s), bound {sum(r['bound_ms'] for r in batch):.5f}, "
                f"plain {sum(r['plain_ms'] for r in batch):.5f}")
        for n in VMAP_COUNTS:
            vr = [r for r in all_rs if r.get("vmap") == n]
            if vr:
                log(f"kernel {name} under vmap over {n} streams: {sum(r['ms'] for r in vr):.5f} ms over "
                    f"{len(vr)} shape(s), bound {sum(r['bound_ms'] for r in vr):.5f}, "
                    f"plain {sum(r['plain_ms'] for r in vr):.5f}")
        if not rs:
            continue
        ms, lib_ms = sum(r["ms"] for r in rs), [r["library_ms"] for r in rs]
        ratio = "no library call" if None in lib_ms else f"{ms / sum(lib_ms):.3f} of the library's {sum(lib_ms):.5f} ms"
        if rs and "cold_ms" in rs[0]:
            ratio += f"; cold {sum(r['cold_ms'] for r in rs):.5f} ms"
        for v, var in summed_variants(rs).items():
            modes = [m for m, mv in rs[0]["modes"].items() if mv == v]
            ratio += (f"; {v}{' (' + ', '.join(modes) + ')' if modes else ''} {var['ms']:.5f} ms"
                      f"{(' (cold ' + format(var['cold_ms'], '.5f') + ')') if 'cold_ms' in var else ''}, "
                      f"{var['ms'] / var['library_ms']:.3f} of the library's {var['library_ms']:.5f} ms, "
                      f"bound {var['bound_ms']:.5f}")
        log(f"kernel {name}: {ms:.5f} ms over {len(rs)} shape(s), {ratio}")


def main_rows(rs):
    """The rows at batch 1 on the 320x1216 frame, whole (no vmap, no rank):
    the sums of the kernels line."""
    return [r for r in rs if not {"batch", "vmap", "ranks", "frame"} & set(r)]


def dn_rank_corr_shapes(world: int = None):
    """The shapes of DispNet's correlation on the ranks of a 320x1216 frame
    width-sharded over ``world`` ranks (phase 13), from the layout's own
    cut: a rank's columns at 1/4 of the padded width, ``x`` zero-padded and
    ``y`` widened by the radius's halo on either side
    (``ops/correlation.py``)."""
    from real_time_self_adaptive_deep_stereo_torch.parallel.spatial import COARSE, Layout

    quarter = -(-W // COARSE) * COARSE // 4
    pieces = Layout.cut(W, world or SP_WORLD)[quarter]
    return sorted({(1, 128, H // 4, hi - lo + 2 * DN_RADIUS) for lo, hi in pieces})


def check_rank_wide_kernels(ops, rows):
    """``corr_fwd_wide`` and ``corr_bwd_wide`` at a width-sharded rank's
    shapes (phase 13's DispNet), as :func:`check_wide_kernels` holds them,
    and their bf16 instances (the rank under ``bf16_act``), the rows tagged
    ``ranks``: ``x`` zero in the pad columns, and the
    output's gradient zero where the call's crop drops the output. The
    bound is the rank's function's: ``x`` and the output at the rank's own
    columns, ``y`` with its halo; the call computes and crops 2 * radius
    output columns more."""
    for i, shape in enumerate(dn_rank_corr_shapes()):
        x, y = seeded(shape, 140 + i), seeded(shape, 150 + i)
        g = seeded((shape[0], 2 * DN_RADIUS + 1, *shape[2:]), 160 + i)
        for t in (x, g):
            t[..., :DN_RADIUS] = 0.0
            t[..., -DN_RADIUS:] = 0.0
        wide_pair(ops, x, y, g, rows, live=shape[3] - 2 * DN_RADIUS, ranks=SP_WORLD)
        wide_bf16_pair(ops, x, y, g, rows, live=shape[3] - 2 * DN_RADIUS, ranks=SP_WORLD)


def wide_bf16_pair(ops, xf, yf, gf, rows, live, **tags):
    """The wide pair's bf16 instances (a ``bf16_act`` rank's features) on
    ``xf``, ``yf`` and ``gf`` rounded to bf16, as :func:`check_bf16_kernels`
    holds them, each timed into ``rows`` (with ``tags``) beside the fp32
    instance; the bound as :func:`wide_pair`'s, at 2 bytes an element and
    the bf16 tensor cores' rate."""
    k = 2 * DN_RADIUS + 1
    shape = tuple(xf.shape)
    x, y, g = xf.bfloat16(), yf.bfloat16(), gf.bfloat16()
    got, want = ops.correlation_cuda(x, y, DN_RADIUS), ops.correlation_torch(x, y, DN_RADIUS)
    grads = ops.correlation_bwd_cuda(x, y, g, DN_RADIUS)
    again = ops.correlation_bwd_cuda(x, y, g, DN_RADIUS)
    want_grads = ops.correlation_torch_bwd(x, y, g, DN_RADIUS)
    xa, ya, ga = x.float().abs(), y.float().abs(), g.float().abs()
    abs_fwd, abs_grads = ops.correlation_torch(xa, ya, DN_RADIUS), ops.correlation_torch_bwd(xa, ya, ga, DN_RADIUS)
    torch.cuda.synchronize()
    tol = "one bf16 ulp of each entry, plus 2 (n + 2) 2^-24 of its terms' magnitudes (n terms)"
    err = bf16_err(got, want, abs_fwd, shape[1], f"corr_fwd_wide_bf16 {shape}")
    errs = [bf16_err(a, b, t, k, f"corr_bwd_wide_bf16 {shape} {nm}")
            for a, b, t, nm in zip(grads, want_grads, abs_grads, ("dx", "dy"))]
    assert_same_bits(grads, again, f"corr_bwd_wide_bf16 {shape}")
    n, n_y, c = shape[2] * live, shape[2] * shape[3], shape[1]  # x and the output; y
    rows["corr_fwd_wide_bf16"].append(dict(
        shape=list(shape), radius=DN_RADIUS, err=err, tol=tol, **tags,
        ms=time_ms(lambda: ops.correlation_cuda(x, y, DN_RADIUS)),
        fp32_ms=time_ms(lambda: ops.correlation_cuda(xf, yf, DN_RADIUS)),
        plain_ms=time_ms(lambda: ops.correlation_torch(x, y, DN_RADIUS), inner=2),
        library_ms=None,
        bound=bound(2.0 * (n * (c + k) + n_y * c), 2.0 * n * c * k, BF16_FLOPS),
    ))
    rows["corr_bwd_wide_bf16"].append(dict(
        shape=list(shape), radius=DN_RADIUS, err=max(errs), tol=tol, **tags,
        ms=time_ms(lambda: ops.correlation_bwd_cuda(x, y, g, DN_RADIUS)),
        fp32_ms=time_ms(lambda: ops.correlation_bwd_cuda(xf, yf, gf, DN_RADIUS)),
        plain_ms=time_ms(lambda: ops.correlation_torch_bwd(x, y, g, DN_RADIUS), inner=2),
        library_ms=None,
        bound=bound(2.0 * (n * (2 * c + k) + n_y * 2 * c), 4.0 * n * c * k, BF16_FLOPS),
    ))


def check_wide_kernels(ops, rows):
    """``corr_fwd_wide`` and ``corr_bwd_wide`` at DispNet-Corr1D's call
    (timed, into ``rows``) and at the shapes that only check them: forward
    within CORR_TOL, backward within BWD_RTOL of each gradient's largest
    entry and bit-identical in two runs."""
    k = 2 * DN_RADIUS + 1
    for i, shape in enumerate([DN_CORR_SHAPE, *WIDE_CHECK_SHAPES]):
        x, y = seeded(shape, 110 + i), seeded(shape, 120 + i)
        g = seeded((shape[0], k, *shape[2:]), 130 + i)
        wide_pair(ops, x, y, g, rows if i == 0 else None)


def wide_pair(ops, x, y, g, rows, live=None, **tags):
    """The wide pair on ``x``, ``y`` and the output gradient ``g`` against
    the plain versions; with ``rows``, each kernel timed into them (with
    ``tags``), else its check printed. The bound counts ``live`` columns
    (all by default) of ``x``, the output and their gradients."""
    k = 2 * DN_RADIUS + 1
    shape = tuple(x.shape)
    got, want = ops.correlation_cuda(x, y, DN_RADIUS), ops.correlation_torch(x, y, DN_RADIUS)
    grads = ops.correlation_bwd_cuda(x, y, g, DN_RADIUS)
    again = ops.correlation_bwd_cuda(x, y, g, DN_RADIUS)
    want_grads = ops.correlation_torch_bwd(x, y, g, DN_RADIUS)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **CORR_TOL)
    errs = [assert_grad_close(a, b, f"corr_bwd_wide {shape} {nm}")
            for a, b, nm in zip(grads, want_grads, ("dx", "dy"))]
    assert_same_bits(grads, again, f"corr_bwd_wide {shape}")
    fwd = dict(shape=list(shape), radius=DN_RADIUS, err=float((got - want).abs().max()), tol=CORR_TOL, **tags)
    bwd = dict(shape=list(shape), radius=DN_RADIUS, err=max(errs), tol=f"{BWD_RTOL} of the largest entry",
               **tags)
    if rows is None:
        log(f"kernel corr_fwd_wide check {fwd}")
        log(f"kernel corr_bwd_wide check {bwd}")
        return
    n, n_y = shape[2] * (live or shape[3]), shape[2] * shape[3]  # x and the output; y
    c = shape[1]
    rows["corr_fwd_wide"].append(dict(
        fwd,
        ms=time_ms(lambda: ops.correlation_cuda(x, y, DN_RADIUS)),
        cold_ms=cold_ms(lambda: ops.correlation_cuda(x, y, DN_RADIUS)),
        call_ms=call_ms(lambda: ops.correlation_cuda(x, y, DN_RADIUS)),
        plain_ms=time_ms(lambda: ops.correlation_torch(x, y, DN_RADIUS), inner=2),
        library_ms=None,
        bound=bound(4.0 * (n * (c + k) + n_y * c), 2.0 * n * c * k),
    ))
    rows["corr_bwd_wide"].append(dict(
        bwd,
        ms=time_ms(lambda: ops.correlation_bwd_cuda(x, y, g, DN_RADIUS)),
        cold_ms=cold_ms(lambda: ops.correlation_bwd_cuda(x, y, g, DN_RADIUS)),
        call_ms=call_ms(lambda: ops.correlation_bwd_cuda(x, y, g, DN_RADIUS)),
        plain_ms=time_ms(lambda: ops.correlation_torch_bwd(x, y, g, DN_RADIUS), inner=2),
        library_ms=None,
        # reads x, y, g once, writes dx, dy; a multiply-add per
        # (element, shift) for each of the two gradients
        bound=bound(4.0 * (n * (2 * c + k) + n_y * 2 * c), 4.0 * n * c * k),
    ))


def bf16_tol(got, want, abs_terms, n_terms):
    """What a bf16 instance may differ from its plain version by, entry by
    entry: one bf16 ulp (both round an fp32 sum once), plus what two fp32
    sums of the same ``n_terms`` terms in other orders may differ by,
    2 (n_terms + 2) 2^-24 times the sum of the terms' magnitudes
    (``abs_terms``, the plain version on |inputs|). Where a sum cancels,
    that second part is more than a bf16 ulp of the small result; elsewhere
    it is a few hundredths of one."""
    mag = torch.maximum(got.float().abs(), want.float().abs()).clamp(min=2.0**-126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7) + 2.0 * (n_terms + 2) * 2.0**-24 * abs_terms


def bf16_err(got, want, abs_terms, n_terms, what):
    """Max abs error of bf16 ``got`` against bf16 ``want``; raises unless
    every entry is within :func:`bf16_tol`. Logs how many entries are
    beyond one bf16 ulp of their value (the cancelling sums)."""
    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        raise AssertionError(f"{what}: dtypes {got.dtype}, {want.dtype}, want bfloat16")
    g, w = got.float(), want.float()
    err = (g - w).abs()
    tol = bf16_tol(got, want, abs_terms, n_terms)
    if not bool((err <= tol).all()):
        raise AssertionError(f"{what}: {int((err > tol).sum())} entries beyond the tolerance")
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp(min=2.0**-126))) - 7)
    beyond = int((err > ulp).sum())
    if beyond:
        log(f"{what}: {beyond} of {err.numel()} entries beyond one bf16 ulp, all within the fp32 reordering bound")
    return float(err.max())


def check_bf16_kernels(ops, rows):
    """The four bf16 instances at the main-path shapes (MADNet's five
    radius-2 calls, DispNet's radius-40 call; the wide pair also at the
    shapes that only check them) on seeded fp32 values rounded to bf16,
    against their plain versions: every entry within one bf16 ulp (both
    sum in fp32 and round once, in another order) but where the sum
    cancels (:func:`bf16_tol`), the backward bit-identical in two runs.
    Timed beside the fp32 instance on the fp32 values; the bound counts 2
    bytes an element and the fp32 rows' multiply-adds at the bf16 tensor
    cores' rate, the card's peak for bf16 products summed in fp32."""
    from real_time_self_adaptive_deep_stereo_torch.ops.correlation import MAX_REGISTER_RADIUS

    cases = [((1, c, H // f, W // f), RADIUS, True) for c, f in CORR_LEVELS]
    cases += [(DN_CORR_SHAPE, DN_RADIUS, True)] + [(sh, DN_RADIUS, False) for sh in WIDE_CHECK_SHAPES]
    for i, (shape, radius, timed) in enumerate(cases):
        wide = radius > MAX_REGISTER_RADIUS
        fwd_name, bwd_name = (("corr_fwd_wide_bf16", "corr_bwd_wide_bf16") if wide
                              else ("corr_fwd_bf16", "corr_bwd_bf16"))
        k = 2 * radius + 1
        xf, yf = seeded(shape, 140 + i), seeded(shape, 150 + i)
        gf = seeded((shape[0], k, *shape[2:]), 160 + i)
        x, y, g = xf.bfloat16(), yf.bfloat16(), gf.bfloat16()
        got, want = ops.correlation_cuda(x, y, radius), ops.correlation_torch(x, y, radius)
        grads = ops.correlation_bwd_cuda(x, y, g, radius)
        again = ops.correlation_bwd_cuda(x, y, g, radius)
        want_grads = ops.correlation_torch_bwd(x, y, g, radius)
        # the sums of the terms' magnitudes, for the tolerance
        xa, ya, ga = x.float().abs(), y.float().abs(), g.float().abs()
        abs_fwd = ops.correlation_torch(xa, ya, radius)
        abs_grads = ops.correlation_torch_bwd(xa, ya, ga, radius)
        torch.cuda.synchronize()
        tol = "one bf16 ulp of each entry, plus 2 (n + 2) 2^-24 of its terms' magnitudes (n terms)"
        fwd = dict(shape=list(shape), radius=radius, tol=tol,
                   err=bf16_err(got, want, abs_fwd, shape[1], f"{fwd_name} {shape}"))
        errs = [bf16_err(a, b, t, k, f"{bwd_name} {shape} {nm}")
                for a, b, t, nm in zip(grads, want_grads, abs_grads, ("dx", "dy"))]
        assert_same_bits(grads, again, f"{bwd_name} {shape}")
        bwd = dict(shape=list(shape), radius=radius, err=max(errs), tol=tol)
        if not timed:
            log(f"kernel {fwd_name} check {fwd}")
            log(f"kernel {bwd_name} check {bwd}")
            continue
        n, c = shape[2] * shape[3], shape[1]
        inner = 2 if wide else 20  # the plain versions at radius 40 are slow
        rows[fwd_name].append(dict(
            fwd,
            ms=time_ms(lambda: ops.correlation_cuda(x, y, radius)),
            cold_ms=cold_ms(lambda: ops.correlation_cuda(x, y, radius)),
            call_ms=call_ms(lambda: ops.correlation_cuda(x, y, radius)),
            fp32_ms=time_ms(lambda: ops.correlation_cuda(xf, yf, radius)),
            plain_ms=time_ms(lambda: ops.correlation_torch(x, y, radius), inner=inner),
            library_ms=None,
            bound=bound(2.0 * n * (2 * c + k), 2.0 * n * c * k, BF16_FLOPS),
        ))
        rows[bwd_name].append(dict(
            bwd,
            ms=time_ms(lambda: ops.correlation_bwd_cuda(x, y, g, radius)),
            cold_ms=cold_ms(lambda: ops.correlation_bwd_cuda(x, y, g, radius)),
            call_ms=call_ms(lambda: ops.correlation_bwd_cuda(x, y, g, radius)),
            fp32_ms=time_ms(lambda: ops.correlation_bwd_cuda(xf, yf, gf, radius)),
            plain_ms=time_ms(lambda: ops.correlation_torch_bwd(x, y, g, radius), inner=inner),
            library_ms=None,
            bound=bound(2.0 * n * (4 * c + k), (4.0 if wide else 6.0) * n * c * k, BF16_FLOPS),
        ))


def check_batch_kernels(ops, rows, b=EVAL_BATCH):
    """The kernels at the batch ``b`` of ``cli/evaluate.py`` and
    ``cli/train.py`` (B = 4; one launch takes the batch, on a grid axis of
    its own) or of a data-parallel rank (phase 12, B = 2) against their
    plain versions, timed as at B = 1: K1 (fp32, radius 2) and K3, the
    evaluation's; its backward ``corr_bwd`` at MADNet's five scales, K5
    (``warp_features_bwd``, every variant) at K1's last four, the training
    step's, each backward bit-identical in two runs. At B = 4 also K1's
    bf16 instance and the wide pair at DispNet-Corr1D's [4,128,80,304],
    radius 40 (phase 12 trains MADNet only). Rows carry ``batch``; the
    bounds count the ``b`` frames."""
    import torch.nn.functional as F

    k = 2 * RADIUS + 1
    full = b == EVAL_BATCH
    for i, (c, f) in enumerate(CORR_LEVELS):
        shape = (b, c, H // f, W // f)
        n = b * shape[2] * shape[3]
        x, y = seeded(shape, 210 + i), seeded(shape, 220 + i)
        got, want = ops.correlation_cuda(x, y, RADIUS), ops.correlation_torch(x, y, RADIUS)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **CORR_TOL)
        rows["corr_fwd"].append(dict(
            batch=b, shape=list(shape), err=float((got - want).abs().max()), tol=CORR_TOL,
            ms=time_ms(lambda: ops.correlation_cuda(x, y, RADIUS)),
            plain_ms=time_ms(lambda: ops.correlation_torch(x, y, RADIUS)),
            library_ms=None,
            bound=bound(4.0 * n * (2 * c + k), 2.0 * n * c * k),
        ))
        if full:
            xb, yb = x.bfloat16(), y.bfloat16()
            got, want = ops.correlation_cuda(xb, yb, RADIUS), ops.correlation_torch(xb, yb, RADIUS)
            abs_fwd = ops.correlation_torch(xb.float().abs(), yb.float().abs(), RADIUS)
            torch.cuda.synchronize()
            rows["corr_fwd_bf16"].append(dict(
                batch=b, shape=list(shape), radius=RADIUS,
                tol="one bf16 ulp of each entry, plus 2 (n + 2) 2^-24 of its terms' magnitudes (n terms)",
                err=bf16_err(got, want, abs_fwd, c, f"corr_fwd_bf16 {shape}"),
                ms=time_ms(lambda: ops.correlation_cuda(xb, yb, RADIUS)),
                fp32_ms=time_ms(lambda: ops.correlation_cuda(x, y, RADIUS)),
                plain_ms=time_ms(lambda: ops.correlation_torch(xb, yb, RADIUS)),
                library_ms=None,
                bound=bound(2.0 * n * (2 * c + k), 2.0 * n * c * k, BF16_FLOPS),
            ))
        g = seeded((b, k, *shape[2:]), 230 + i)
        got = ops.correlation_bwd_cuda(x, y, g, RADIUS)
        again = ops.correlation_bwd_cuda(x, y, g, RADIUS)
        want = ops.correlation_torch_bwd(x, y, g, RADIUS)
        torch.cuda.synchronize()
        errs = [assert_grad_close(a, w, f"corr_bwd {shape} {nm}") for a, w, nm in zip(got, want, ("dx", "dy"))]
        assert_same_bits(got, again, f"corr_bwd {shape}")
        rows["corr_bwd"].append(dict(
            batch=b, shape=list(shape), err=max(errs), tol=f"{BWD_RTOL} of the largest entry",
            ms=time_ms(lambda: ops.correlation_bwd_cuda(x, y, g, RADIUS)),
            plain_ms=time_ms(lambda: ops.correlation_torch_bwd(x, y, g, RADIUS)),
            library_ms=None,
            bound=bound(4.0 * n * (4 * c + k), 6.0 * n * c * k),
        ))
    for i, (c, f) in enumerate(FEAT_LEVELS):
        shape = (b, c, H // f, W // f)
        neg = -(-MAX_DISP // f)
        feats = seeded(shape, 240 + i)
        dx = seeded((b, 1, *shape[2:]), 250 + i, -neg - 10.0, MAX_POS + 6.0)
        got = ops.warp_features_cuda(feats, dx, neg, MAX_POS)
        want = ops.warp_features_clamped(feats, dx, neg, MAX_POS)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **WARP_TOL)
        grid = grid_for(dx.clamp(-neg, MAX_POS), 1.0)
        lib = lambda: F.grid_sample(feats, grid, "bilinear", "zeros", align_corners=True)  # noqa: E731
        n = b * shape[2] * shape[3]
        rows["warp_features_fwd"].append(dict(
            batch=b, shape=list(shape), max_neg=neg, err=float((got - want).abs().max()), tol=WARP_TOL,
            ms=time_ms(lambda: ops.warp_features_cuda(feats, dx, neg, MAX_POS)),
            plain_ms=time_ms(lambda: ops.warp_features_clamped(feats, dx, neg, MAX_POS)),
            library_ms=time_ms(lib),
            bound=bound(4.0 * n * (2 * c + 1), 3.0 * c * n),
        ))
        rows["warp_features_bwd"].append(dict(check_warp_bwd(
            "warp_features_bwd", feats, dx, 260 + i, grid, "zeros",
            lambda s, o, g, need=(True, True), neg=neg: ops.warp_features_bwd_cuda(s, o, g, neg, MAX_POS, *need),
            lambda s, o, neg=neg: ops.warp_features_clamped(s, o, neg, MAX_POS),
            FEATURE_MODES,
        ), batch=b))
    if not full:
        return

    shape, k = (b, *DN_CORR_SHAPE[1:]), 2 * DN_RADIUS + 1
    n, c = b * shape[2] * shape[3], shape[1]
    x, y, g = seeded(shape, 270), seeded(shape, 271), seeded((b, k, *shape[2:]), 272)
    got, want = ops.correlation_cuda(x, y, DN_RADIUS), ops.correlation_torch(x, y, DN_RADIUS)
    grads = ops.correlation_bwd_cuda(x, y, g, DN_RADIUS)
    again = ops.correlation_bwd_cuda(x, y, g, DN_RADIUS)
    want_grads = ops.correlation_torch_bwd(x, y, g, DN_RADIUS)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **CORR_TOL)
    errs = [assert_grad_close(a, w, f"corr_bwd_wide {shape} {nm}")
            for a, w, nm in zip(grads, want_grads, ("dx", "dy"))]
    assert_same_bits(grads, again, f"corr_bwd_wide {shape}")
    rows["corr_fwd_wide"].append(dict(
        batch=b, shape=list(shape), radius=DN_RADIUS, err=float((got - want).abs().max()), tol=CORR_TOL,
        ms=time_ms(lambda: ops.correlation_cuda(x, y, DN_RADIUS)),
        plain_ms=time_ms(lambda: ops.correlation_torch(x, y, DN_RADIUS), inner=2),
        library_ms=None,
        bound=bound(4.0 * n * (2 * c + k), 2.0 * n * c * k),
    ))
    rows["corr_bwd_wide"].append(dict(
        batch=b, shape=list(shape), radius=DN_RADIUS, err=max(errs), tol=f"{BWD_RTOL} of the largest entry",
        ms=time_ms(lambda: ops.correlation_bwd_cuda(x, y, g, DN_RADIUS)),
        plain_ms=time_ms(lambda: ops.correlation_torch_bwd(x, y, g, DN_RADIUS), inner=2),
        library_ms=None,
        bound=bound(4.0 * n * (4 * c + k), 4.0 * n * c * k),
    ))


def check_tool_kernels(ops, rows):
    """The kernels of phase 14's paths at the tools' 384x1280 frame, each
    row tagged ``frame``: at batch 1 every kernel of
    :func:`check_frame_kernels` (K1 and its backward at MADNet's five
    scales, the image warps on the frame, K6/K7 image on a width with no
    padding to the tile, the feature warps at K1's last four scales) and
    DispNet's radius-40 pair at [1,128,96,320]; at batch 8, the offline
    tool's largest, K1 in fp32 and bf16, K3 and the wide forward in fp32
    and bf16 at [8,128,96,320], forward only, as the offline tool runs
    them."""
    import torch.nn.functional as F

    tags = dict(frame=TOOLS_FRAME)
    check_frame_kernels(ops, rows, TOOLS_H, TOOLS_W, **tags)
    shape = (1, 128, TOOLS_H // 4, TOOLS_W // 4)
    x, y = seeded(shape, 310), seeded(shape, 311)
    wide_pair(ops, x, y, seeded((1, 2 * DN_RADIUS + 1, *shape[2:]), 312), rows, **tags)

    b, k = OFFLINE_BATCH, 2 * RADIUS + 1
    tol16 = "one bf16 ulp of each entry, plus 2 (n + 2) 2^-24 of its terms' magnitudes (n terms)"
    for i, (c, f) in enumerate(CORR_LEVELS):
        shape = (b, c, TOOLS_H // f, TOOLS_W // f)
        n = b * shape[2] * shape[3]
        x, y = seeded(shape, 320 + i), seeded(shape, 330 + i)
        xb, yb = x.bfloat16(), y.bfloat16()
        got, want = ops.correlation_cuda(x, y, RADIUS), ops.correlation_torch(x, y, RADIUS)
        got16, want16 = ops.correlation_cuda(xb, yb, RADIUS), ops.correlation_torch(xb, yb, RADIUS)
        abs16 = ops.correlation_torch(xb.float().abs(), yb.float().abs(), RADIUS)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **CORR_TOL)
        rows["corr_fwd"].append(dict(
            batch=b, shape=list(shape), err=float((got - want).abs().max()), tol=CORR_TOL, **tags,
            ms=time_ms(lambda: ops.correlation_cuda(x, y, RADIUS)),
            plain_ms=time_ms(lambda: ops.correlation_torch(x, y, RADIUS)),
            library_ms=None,
            bound=bound(4.0 * n * (2 * c + k), 2.0 * n * c * k),
        ))
        rows["corr_fwd_bf16"].append(dict(
            batch=b, shape=list(shape), radius=RADIUS, tol=tol16, **tags,
            err=bf16_err(got16, want16, abs16, c, f"corr_fwd_bf16 {shape}"),
            ms=time_ms(lambda: ops.correlation_cuda(xb, yb, RADIUS)),
            fp32_ms=time_ms(lambda: ops.correlation_cuda(x, y, RADIUS)),
            plain_ms=time_ms(lambda: ops.correlation_torch(xb, yb, RADIUS)),
            library_ms=None,
            bound=bound(2.0 * n * (2 * c + k), 2.0 * n * c * k, BF16_FLOPS),
        ))
    for i, (c, f) in enumerate(FEAT_LEVELS):
        shape = (b, c, TOOLS_H // f, TOOLS_W // f)
        neg = -(-MAX_DISP // f)
        feats = seeded(shape, 340 + i)
        dx = seeded((b, 1, *shape[2:]), 350 + i, -neg - 10.0, MAX_POS + 6.0)
        got = ops.warp_features_cuda(feats, dx, neg, MAX_POS)
        want = ops.warp_features_clamped(feats, dx, neg, MAX_POS)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **WARP_TOL)
        grid = grid_for(dx.clamp(-neg, MAX_POS), 1.0)
        n = b * shape[2] * shape[3]
        rows["warp_features_fwd"].append(dict(
            batch=b, shape=list(shape), max_neg=neg, err=float((got - want).abs().max()), tol=WARP_TOL, **tags,
            ms=time_ms(lambda: ops.warp_features_cuda(feats, dx, neg, MAX_POS)),
            plain_ms=time_ms(lambda: ops.warp_features_clamped(feats, dx, neg, MAX_POS)),
            library_ms=time_ms(lambda: F.grid_sample(feats, grid, "bilinear", "zeros", align_corners=True)),
            bound=bound(4.0 * n * (2 * c + 1), 3.0 * c * n),
        ))
    shape, k = (b, 128, TOOLS_H // 4, TOOLS_W // 4), 2 * DN_RADIUS + 1
    n, c = b * shape[2] * shape[3], shape[1]
    x, y = seeded(shape, 360), seeded(shape, 361)
    xb, yb = x.bfloat16(), y.bfloat16()
    got, want = ops.correlation_cuda(x, y, DN_RADIUS), ops.correlation_torch(x, y, DN_RADIUS)
    got16, want16 = ops.correlation_cuda(xb, yb, DN_RADIUS), ops.correlation_torch(xb, yb, DN_RADIUS)
    abs16 = ops.correlation_torch(xb.float().abs(), yb.float().abs(), DN_RADIUS)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **CORR_TOL)
    rows["corr_fwd_wide"].append(dict(
        batch=b, shape=list(shape), radius=DN_RADIUS, err=float((got - want).abs().max()), tol=CORR_TOL, **tags,
        ms=time_ms(lambda: ops.correlation_cuda(x, y, DN_RADIUS)),
        plain_ms=time_ms(lambda: ops.correlation_torch(x, y, DN_RADIUS), inner=2),
        library_ms=None,
        bound=bound(4.0 * n * (2 * c + k), 2.0 * n * c * k),
    ))
    rows["corr_fwd_wide_bf16"].append(dict(
        batch=b, shape=list(shape), radius=DN_RADIUS, tol=tol16, **tags,
        err=bf16_err(got16, want16, abs16, c, f"corr_fwd_wide_bf16 {shape}"),
        ms=time_ms(lambda: ops.correlation_cuda(xb, yb, DN_RADIUS)),
        fp32_ms=time_ms(lambda: ops.correlation_cuda(x, y, DN_RADIUS)),
        plain_ms=time_ms(lambda: ops.correlation_torch(xb, yb, DN_RADIUS), inner=2),
        library_ms=None,
        bound=bound(2.0 * n * (2 * c + k), 2.0 * n * c * k, BF16_FLOPS),
    ))


def by_batch(rs):
    """The rows of ``rs`` taken at a batch, by its size."""
    out = {}
    for r in rs:
        if "batch" in r:
            out.setdefault(r["batch"], []).append(r)
    return dict(sorted(out.items()))


def check_warp_bwd(name, src, off, seed, grid, padding, kernel, plain_fwd, modes, same_as=None):
    """One warp backward kernel at one shape: both gradients against
    autograd through the plain version (and against ``same_as``, another
    kernel of the same function, where given), two runs bit-identical,
    times. ``kernel(src, off, g, need)`` takes the pair (dsrc, doff) of
    gradients asked for; ``modes`` names the variant (``VARIANTS``) each
    mode asks for. Every variant (both gradients, and each alone) must
    give the bits of both gradients together in two
    runs, and is timed beside the yardstick ``grid_sample_bwd`` with the
    same mask and beside its own bound, warm and with the L2 cold
    (:func:`cold_ms`)."""
    nb, c, h, w = src.shape
    g = seeded(tuple(src.shape), seed)
    got = kernel(src, off, g)
    again = kernel(src, off, g)
    src_g, off_g = src.clone().requires_grad_(), off.clone().requires_grad_()
    plain_out = plain_fwd(src_g, off_g)
    plain = lambda: torch.autograd.grad(plain_out, (src_g, off_g), g, retain_graph=True)  # noqa: E731
    want = plain()
    torch.cuda.synchronize()
    errs = [assert_grad_close(a, b, f"{name} {tuple(src.shape)} {nm}")
            for a, b, nm in zip(got, want, ("dsrc", "doff"))]
    assert_same_bits(got, again, f"{name} {tuple(src.shape)}")
    if same_as is not None:
        for a, b, nm in zip(got, same_as(src, off, g), ("dsrc", "doff")):
            assert_grad_close(a, b, f"{name} {tuple(src.shape)} {nm} against the other kernel")
    n = nb * h * w
    variants = {}
    for v, mask in VARIANTS.items():
        for _ in range(2):
            part = kernel(src, off, g, mask)
            for a, b, asked in zip(part, got, mask):
                if (a is not None) != asked or (a is not None and not torch.equal(a, b)):
                    raise AssertionError(f"{name} {tuple(src.shape)}: variant {v} differs from both gradients together")
        # reads source (doff only), g and the offset once, writes what is
        # asked; per pixel and channel 4 flops in each gradient
        var_bound = bound(4.0 * n * ((mask[1] + 1) * c + mask[0] * c + 1 + mask[1]),
                          4.0 * c * n * (mask[0] + mask[1]))
        variants[v] = dict(
            ms=time_ms(lambda: kernel(src, off, g, mask)),
            cold_ms=cold_ms(lambda: kernel(src, off, g, mask)),
            library_ms=time_ms(lambda: grid_sample_bwd(g, src, grid, padding, mask)),
            bound_ms=var_bound[0], bound_by=var_bound[1],
        )
    # whether the yardstick's op skips the grid's gradient that is not asked for
    unasked_grid = torch.ops.aten.grid_sampler_2d_backward(
        g, src, grid, 0, PADDING_MODES[padding], True, [True, False])[1] is not None
    both = variants["both"]
    return dict(
        shape=list(src.shape), err=max(errs), tol=f"{BWD_RTOL} of the largest entry",
        ms=both["ms"],
        cold_ms=both["cold_ms"],
        call_ms=call_ms(lambda: kernel(src, off, g)),
        plain_ms=call_ms(plain, 50),
        library_ms=both["library_ms"],
        variants=variants,
        modes=dict(modes),  # the variant each mode asks for
        library_grid_grad_unasked=unasked_grid,
        bound=(both["bound_ms"], both["bound_by"]),
    )


def summed_variants(rs):
    """A warp backward's variants, each summed over the shapes of ``rs``;
    {} for any other kernel."""
    if "variants" not in rs[0]:
        return {}
    keys = [k for k in ("ms", "cold_ms", "library_ms", "bound_ms") if k in next(iter(rs[0]["variants"].values()))]
    return {v: {k: sum(r["variants"][v][k] for r in rs) for k in keys} for v in rs[0]["variants"]}


# ------------------------------------------------------------- phases 4 and 5
def seeded_jax_params(seed: int):
    """MADNet weights in the JAX layout (HWIO ``w``, ``b``), Xavier-uniform
    from a numpy seed, with small non-zero biases. The last conv of every
    estimator gets a bias of -1 (a disparity of 20 px) and, like the last
    conv of the context net, weights scaled by 0.02, so that the random
    part moves the prediction by a few pixels around it. Untamed, these
    random weights predict disparities of thousands of pixels: the final
    relu or the warps' clip then zeroes the gradient of most pixels, a
    block may get none at all, and the few pixels left make the gradient
    so rough that a rounding difference in the forward changes it by
    percents, which no comparison of kernels could see through."""
    from real_time_self_adaptive_deep_stereo_torch.models import MADNet

    shapes = {k: tuple(v.shape) for k, v in MADNet(device="cpu").state_dict().items()}
    r = np.random.default_rng(seed)
    tree = {}
    for key, shape in sorted(shapes.items()):
        group, layer, leaf = key.split(".")
        if leaf == "weight":
            cout, cin, kh, kw = shape
            lim = math.sqrt(6.0 / (kh * kw * (cin + cout)))
            arr = r.uniform(-lim, lim, (kh, kw, cin, cout))
            if layer in ("disp6", "context7"):
                arr *= 0.02
            tree.setdefault(group, {}).setdefault(layer, {})["w"] = arr.astype(np.float32)
        else:
            arr = 0.01 * r.standard_normal(shape) - (1.0 if layer == "disp6" else 0.0)
            tree.setdefault(group, {}).setdefault(layer, {})["b"] = arr.astype(np.float32)
    return tree


def make_frames(n: int, seed: int):
    """Textured left image, right = left shifted by a known disparity d
    (left(x) = right(x - d)), target = d with the first d columns invalid."""
    h, w = H, W
    r = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        d = 8 + 4 * i
        base = (r.random((1, h // 4, (w + d) // 4 + 1, 3)) * 255).astype(np.float32)
        base = np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)[:, :, : w + d]  # 4-pixel texture
        target = np.full((1, h, w, 1), float(d), np.float32)
        target[:, :, :d] = 0.0
        frames.append({"left": base[:, :, :w].copy(), "right": base[:, :, d:].copy(), "target": target})
    return frames


def make_smooth_frame(seed: int, d: int = 12):
    """A stereo pair of smooth texture (six sinusoids per channel), right =
    left shifted by ``d``. The warp's gradient with respect to the disparity,
    v0 - v1, jumps wherever a sample crosses a pixel; on the blocky frames
    of :func:`make_frames` a forward that differs in the seventh digit moves
    enough samples across to change a step's gradient by parts in a
    thousand. On a smooth image neighbouring pixel pairs differ little, and
    a comparison of two backward paths sees the paths."""
    r = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0 : W + d].astype(np.float32)
    base = np.zeros((H, W + d, 3), np.float32)
    for c in range(3):
        for _ in range(6):
            fx, fy = r.uniform(0.005, 0.06, 2)
            px, py = r.uniform(0, 2 * np.pi, 2)
            base[..., c] += r.uniform(10, 40) * np.sin(2 * np.pi * fx * xs + px) * np.cos(
                2 * np.pi * fy * ys + py
            )
    base = np.clip(base + 128, 0, 255).astype(np.float32)[None]
    target = np.full((1, H, W, 1), float(d), np.float32)
    target[:, :, :d] = 0.0
    return {"left": base[:, :, :W].copy(), "right": base[:, :, d:].copy(), "target": target}


def make_session(state, mode, plain=False, warp="auto", fused=False, model_name="MADNet",
                 adaptation="reprojection", **session_kw):
    """A session on the card from the weights ``state``, built through the
    entry points a user calls. MADNet's MAD gets the bulkhead, as
    ``cli/adapt.py`` builds it; DispNet takes ``dispnet_full_6.json``, as
    the JAX package's DispNet MAD runs. ``plain`` swaps the kernels for
    their plain versions; ``warp`` is the warp mode of model and loss;
    ``fused`` gives the device-resident session instead of the host one;
    ``adaptation`` is the engine's loss (``proxy``: the continual CLI's)."""
    from real_time_self_adaptive_deep_stereo_torch.adapt import (
        AdaptationEngine,
        FusedOnlineSession,
        OnlineAdaptationSession,
        default_block_config_path,
        load_block_config,
        make_blocks,
    )
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net

    warp = "clamped" if plain else warp
    modes = dict(corr_mode="torch") if plain else {}
    if model_name == "MADNet":
        model = get_stereo_net("MADNet", bulkhead=(mode == "MAD"), warp_mode=warp, **modes)  # device cuda
        config = default_block_config_path("MADNet")
    else:
        model = get_stereo_net(model_name, **modes)
        config = DN_BLOCK_CONFIG
    model.load_state_dict(state)
    blocks = make_blocks(load_block_config(config), model)
    engine = AdaptationEngine(model, blocks, lr=LR, optimizer="momentum", warp_mode=warp, adaptation=adaptation)
    if fused:
        return FusedOnlineSession(engine, mode=mode, max_steps=64, **session_kw)
    return OnlineAdaptationSession(engine, mode=mode, **session_kw)


def snapshot(session):
    return {k: v.detach().clone() for k, v in session.engine.model.named_parameters()}


def changed_names(session, before):
    return {k for k, v in session.engine.model.named_parameters() if not torch.equal(v, before[k])}


def check_results(mode, results, step_ms):
    for i, res in enumerate(results):
        vals = [res[k] for k in ("loss", "epe", "bad3", "d1")]
        log(f"{mode} frame {i}: ms {step_ms[i]:.3f} loss {vals[0]:.6f} epe {vals[1]:.4f} "
            f"bad3 {vals[2]:.4f} d1 {vals[3]:.3f}")
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{mode} frame {i}: non-finite result {vals}")
        if tuple(res["disp"].shape) != (1, H, W, 1) or not torch.isfinite(res["disp"]).all():
            raise AssertionError(f"{mode} frame {i}: bad disparity {tuple(res['disp'].shape)}")


def drive(session, frames, per_frame_launches, after_step=None, warm=1):
    """Step ``session`` over ``frames`` with the launch counters set to 0
    just before and read just after; ``per_frame_launches(i)`` is what
    frame i must add. The first ``warm`` frames carry cuDNN's first-call
    set-up and stay out of the median. Returns (results, ms per step,
    total launches, median ms per steady frame)."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    mode = session.mode
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    results, step_ms, want_total = [], [], dict.fromkeys(cuda_lib.LAUNCHES, 0)
    for i, f in enumerate(frames):
        before_counts = dict(cuda_lib.LAUNCHES)
        before_params = snapshot(session) if after_step else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(session.step(f))  # ends in the one host sync of the frame
        step_ms.append((time.perf_counter() - t0) * 1e3)
        added = {k: cuda_lib.LAUNCHES[k] - before_counts[k] for k in cuda_lib.LAUNCHES}
        want = {**dict.fromkeys(cuda_lib.LAUNCHES, 0), **per_frame_launches(i)}
        if added != want:
            raise AssertionError(f"{mode} frame {i}: launches {added}, want {want}")
        for k, v in want.items():
            want_total[k] += v
        if after_step:
            after_step(i, before_params)
    launches = dict(cuda_lib.LAUNCHES)
    if launches != want_total:
        raise AssertionError(f"{mode}: launch counts {launches}, want {want_total}")
    log(f"session {mode} launches {launches} over {len(frames)} frames")
    check_results(mode, results, step_ms)
    ms = statistics.median(step_ms[warm:])
    log(f"session {mode} {H}x{W}: median {ms:.3f} ms/frame over frames {warm}..{len(frames) - 1}, "
        f"{1e3 / ms:.2f} frames/s; frame 0 {step_ms[0]:.3f} ms; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return results, step_ms, launches, ms


FWD = {"corr_fwd": 5, "warp_image_fwd": 1, "warp_features_fwd": 4}


def run_none(state, profile_dir):
    from real_time_self_adaptive_deep_stereo_torch.adapt import AdaptationEngine
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net

    session = make_session(state, "NONE")
    frames = make_frames(N_FRAMES_NONE, 1)
    results, _, launches, ms = drive(session, frames, lambda i: FWD)

    # the same frame with the plain modes on the card
    model = session.engine.model
    plain = get_stereo_net("MADNet", corr_mode="torch", warp_mode="clamped")
    plain.load_state_dict(state)
    plain_engine = AdaptationEngine(plain, warp_mode="clamped")
    frame = frames[-1]
    with torch.no_grad():
        fast_out = model(*(torch.from_numpy(frame[k]).cuda() for k in ("left", "right")))
        plain_out = plain(*(torch.from_numpy(frame[k]).cuda() for k in ("left", "right")))
    for i, (a, b) in enumerate(zip(fast_out["disparities"], plain_out["disparities"])):
        scale = max(float(b.abs().max()), 1e-6)
        err = float((a - b).abs().max())
        log(f"disparities[{i}] kernels vs plain: max {scale:.4f}, "
            f"share > 0 {float((b > 0).float().mean()):.3f}, max abs err {err:.3g}")
        torch.testing.assert_close(a, b, rtol=MODEL_RTOL, atol=MODEL_RTOL * scale)
    plain_res = plain_engine.infer(frame)
    torch.testing.assert_close(
        torch.tensor(results[-1]["loss"]), plain_res["loss"].cpu(), rtol=1e-4, atol=0.0
    )
    log(f"loss kernels {results[-1]['loss']:.6f} plain {float(plain_res['loss']):.6f}")
    if profile_dir:
        profile_frames(session, [frame] * 3, Path(profile_dir), "none")
    return launches, ms


def run_mad(state, profile_dir):
    session = make_session(state, "MAD", sample_mode="SEQUENTIAL", ssim_th=1e9, seed=0)
    blocks = session.engine.blocks
    frames = make_frames(N_FRAMES_MAD, 2)

    def per_frame(i):
        k = i % len(blocks)  # SEQUENTIAL: block i mod 5
        return {
            "corr_fwd": 5, "warp_image_fwd": 2, "warp_features_fwd": 4,  # block loss + full loss
            "corr_bwd": 1, "warp_image_bwd": 1, "warp_features_bwd": 0 if k == 0 else 1,
        }

    def after_step(i, before):
        k = i % len(blocks)
        changed = changed_names(session, before)
        if not changed or not changed <= set(blocks[k].names):
            raise AssertionError(
                f"MAD frame {i}: block {k} was trained but {sorted(changed) or 'nothing'} changed"
            )

    _, step_ms, launches, ms = drive(session, frames, per_frame, after_step, warm=len(blocks))
    if session.stats.fetch_counter != [N_FRAMES_MAD // len(blocks)] * len(blocks):
        raise AssertionError(f"MAD: fetch counter {session.stats.fetch_counter}")
    if not np.all(session.scores[:-1] != 0.0):
        raise AssertionError(f"MAD: the scores did not move: {session.scores}")
    log(f"MAD scores {session.scores.tolist()}")
    by_block = {k: statistics.median(step_ms[k + len(blocks) :: len(blocks)]) for k in range(len(blocks))}
    log(f"MAD ms/frame by block trained (after the first round): {by_block}")
    if profile_dir:
        profile_frames(session, make_frames(len(blocks), 5), Path(profile_dir), "mad")
    return launches, ms


def run_full(state, profile_dir):
    session = make_session(state, "FULL", ssim_th=1e9)
    names = set(dict(session.engine.model.named_parameters()))
    frames = make_frames(N_FRAMES_FULL, 3)

    def per_frame(i):
        return {**FWD, "corr_bwd": 5, "warp_image_bwd": 1, "warp_features_bwd": 4}

    def after_step(i, before):
        # a gradient reaches every parameter; some tensors (scale 6, far from
        # the loss, and the biases of -1) take a step below their float32 spacing
        acc = session.engine.opt["acc"]
        dead = sorted(k for k in names if not bool(acc[k].any()))
        changed = changed_names(session, before)
        log(f"FULL frame {i}: {len(changed)} of {len(names)} tensors changed; "
            f"unchanged {sorted(names - changed)}")
        if dead or len(changed) < 0.5 * len(names):
            raise AssertionError(f"FULL frame {i}: no gradient for {dead}; changed {len(changed)}")

    _, _, launches, ms = drive(session, frames, per_frame, after_step)
    if profile_dir:
        profile_frames(session, frames[:3], Path(profile_dir), "full")
    return launches, ms


def check_steps_against_plain(state):
    """One MAD step (block 4) and one FULL step from the same weights, with
    the kernels and with the plain modes on the card: the parameter
    changes agree within STEP_RTOL of the largest."""
    frame = make_smooth_frame(4)
    for mode, kw in (("MAD", dict(sample_mode="FIXED", fixed_id=4)), ("FULL", {})):
        deltas = []
        for plain in (False, True, False):
            session = make_session(state, mode, plain=plain, ssim_th=1e9, **kw)
            before = snapshot(session)
            res = session.step(frame)
            deltas.append((
                {k: v.detach() - before[k] for k, v in session.engine.model.named_parameters()},
                session.engine.opt["acc"],  # after one momentum step: the gradient
                res["loss"],
            ))
        (fast, fast_acc, fast_loss), (plain_d, plain_acc, plain_loss), (_, again_acc, _) = deltas
        scale = max(float(v.abs().max()) for v in plain_d.values())
        # the change old - lr*acc is rounded to the parameter's float32
        # spacing in each run; the accumulator (the gradient) is not
        err = max(
            float(((fast[k] - plain_d[k]).abs() - torch.finfo(torch.float32).eps * before[k].abs())
                  .clamp(min=0).max())
            for k in plain_d
        )
        g_scale = max(float(v.abs().max()) for v in plain_acc.values())
        g_err = max(float((fast_acc[k] - plain_acc[k]).abs().max()) for k in plain_acc)
        n_moved = sum(bool(v.any()) for v in plain_d.values())
        # what two runs of the same path differ by (cuDNN's backward is not
        # run-to-run deterministic), and where the two paths differ most
        rerun = max(float((fast_acc[k] - again_acc[k]).abs().max()) for k in fast_acc)
        worst = sorted(fast_acc, key=lambda k: -float((fast_acc[k] - plain_acc[k]).abs().max()))[:3]
        log(f"{mode} step: two runs with the kernels differ by {rerun:.3g}; largest "
            f"kernels-vs-plain differences in {worst}")
        log(f"{mode} step kernels vs plain: largest gradient {g_scale:.3g}, max abs err "
            f"{g_err:.3g} ({g_err / g_scale:.3g} of it); largest parameter change {scale:.3g}, "
            f"max abs err beyond one rounding {err:.3g} ({err / scale:.3g} of it); "
            f"{n_moved} tensors moved, loss {fast_loss:.6f} vs {plain_loss:.6f}")
        if not (scale > 0 and err <= STEP_RTOL * scale and g_err <= STEP_RTOL * g_scale):
            raise AssertionError(f"{mode} step: kernels and plain modes disagree")


def check_reset(state):
    """A loss threshold below every loss: the step trains, then the reset
    restores the pristine weights in place and keeps the optimizer state."""
    session = make_session(state, "MAD", sample_mode="SEQUENTIAL", ssim_th=-1.0, seed=0)
    pristine = snapshot(session)
    session.step(make_frames(1, 6)[0])
    if session.stats.reset_counter != 1 or changed_names(session, pristine):
        raise AssertionError("reset: the pristine weights were not restored")
    if not any(bool(a.any()) for a in session.engine.opt["acc"].values()):
        raise AssertionError("reset: the step before it left no optimizer state")
    log("reset safeguard: weights restored, optimizer state kept")


# ------------------------------------------------------------------ phase 6
TILE_FWD_MAD = {"corr_fwd": 5, "warp_tile_image_fwd": 2, "warp_tile_features_fwd": 4}
# host and fused sessions, and replayed and eager fused sessions, run the
# same ops in the same order; cuDNN's backward is not run-to-run
# deterministic, so two runs of one path differ by 1e-6 of the loss after
# a step, and the difference is carried along the trajectory
TRAJ_LOSS_RTOL = 1e-4
TRAJ_EPE_RTOL = 1e-3
TRAJ_SCORE_ATOL = 1e-6  # a score is uf (0.01) times a difference of such losses


def smooth_frames(n: int, seed: int):
    return [make_smooth_frame(seed + i, d=8 + 2 * i) for i in range(n)]


def mad_tile_launches(k: int):
    return {**TILE_FWD_MAD, "corr_bwd": 1, "warp_tile_image_bwd": 1,
            "warp_tile_features_bwd": 0 if k == 0 else 1}


def step_counted(session, frame, want, what):
    """One fused step whose launch counts must be exactly ``want``."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    before = dict(cuda_lib.LAUNCHES)
    session.step(frame)
    added = {k: cuda_lib.LAUNCHES[k] - before[k] for k in cuda_lib.LAUNCHES}
    want = {**dict.fromkeys(cuda_lib.LAUNCHES, 0), **want}
    if added != want:
        raise AssertionError(f"{what}: launches {added}, want {want}")


def assert_trajectory(got, want, what, frames=None, loss_rtol=TRAJ_LOSS_RTOL, epe_rtol=TRAJ_EPE_RTOL):
    """``finalize()`` of a fused session against another's, or against the
    per-frame results of a host session."""
    n = len(want["loss"]) if frames is None else frames
    worst = {}
    for key, rtol in (("loss", loss_rtol), ("epe", epe_rtol)):
        a, b = np.asarray(got[key][:n], np.float64), np.asarray(want[key][:n], np.float64)
        if a.shape != b.shape or not np.isfinite(a).all():
            raise AssertionError(f"{what}: {key} {a} against {b}")
        worst[key] = float(np.max(np.abs(a - b) / np.abs(b)))
        if not worst[key] <= rtol:
            raise AssertionError(f"{what}: {key} differs by {worst[key]:.3g} > {rtol}: {a} against {b}")
    log(f"{what}: over {n} frames loss within {worst['loss']:.3g}, epe within {worst['epe']:.3g} (relative)")


def host_stats(session):
    st = session.stats
    return {"loss": st.loss, "epe": st.epe, "fetch_counter": st.fetch_counter, "scores": session.scores}


def assert_controller(got, want, what, score_atol=TRAJ_SCORE_ATOL):
    got = {**got, "fetch_counter": [int(c) for c in got["fetch_counter"]]}
    if got["fetch_counter"] != [int(c) for c in want["fetch_counter"]]:
        raise AssertionError(f"{what}: fetch counter {got['fetch_counter']} against {want['fetch_counter']}")
    err = float(np.max(np.abs(np.asarray(got["scores"], np.float64) - np.asarray(want["scores"], np.float64))))
    log(f"{what}: fetch counter {got['fetch_counter']}, scores within {err:.3g}")
    if not err <= score_atol:
        raise AssertionError(f"{what}: scores {got['scores']} against {want['scores']}")


def timed_host(session, frames, warm):
    """ms/frame of a host session (each step ends in its host sync)."""
    ms = []
    for f in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.step(f)
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms[warm:])


def device_activities(session, frame) -> int:
    """Kernels and copies the device runs for one step of ``session``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        session.step(frame)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


MAD_KW = dict(sample_mode="SEQUENTIAL", ssim_th=1e9, seed=0)
TILE_FULL = {"corr_fwd": 5, "warp_tile_image_fwd": 1, "warp_tile_features_fwd": 4,
             "corr_bwd": 5, "warp_tile_image_bwd": 1, "warp_tile_features_bwd": 4}
TILE_SERVE = {"corr_fwd": 5, "warp_tile_features_fwd": 4}  # no loss: no image warp


def fused_mad_in(session, frames, per_frame, checked, what, after_step=None):
    """A fused MAD session over ``frames``: the first ``checked`` frames (a
    round or more) one by one, frame i adding exactly ``per_frame(i)``
    launches, ``after_step(i)`` after each; then one graph per block,
    holding that block's launches; the rest replayed with every host sync
    an error, and timed. Returns (finalize(), launches, steady ms/frame)."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    n_blocks = len(session.engine.blocks)
    cuda_lib.reset_launches()
    first_ms = []
    for i, f in enumerate(frames[:checked]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_counted(session, f, per_frame(i), f"{what} frame {i}")
        torch.cuda.synchronize()
        first_ms.append((time.perf_counter() - t0) * 1e3)
        if after_step:
            after_step(i)
    want_graphs = {("mad", (k,)): {n: c for n, c in per_frame(k).items() if c} for k in range(n_blocks)}
    if session.graph_launches != want_graphs:
        raise AssertionError(f"{what}: graphs hold {session.graph_launches}, want {want_graphs}")
    log(f"{what} first round (eager step + capture) ms/frame {first_ms[:n_blocks]}")
    if checked > n_blocks:
        log(f"{what} checked replays (fenced by a sync) ms/frame {first_ms[n_blocks:]}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        for f in frames[checked:]:
            session.step(f)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / (len(frames) - checked)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (len(frames) - checked)
    log(f"{what} steady: {ms:.3f} ms/frame over {len(frames) - checked} frames with no host sync "
        f"(the host took {enqueue_ms:.3f} ms/frame to enqueue them)")
    launches = dict(cuda_lib.LAUNCHES)
    want = dict.fromkeys(cuda_lib.LAUNCHES, 0)
    for i in range(len(frames)):
        for name, c in per_frame(i).items():
            want[name] += c
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, want {want}")
    stats = session.finalize()
    if stats["steps"] != len(frames) or int(stats["reset_count"]) != 0 or not np.isfinite(stats["loss"]).all():
        raise AssertionError(f"{what}: {stats['steps']} steps, {stats['reset_count']} resets, loss {stats['loss']}")
    return stats, launches, ms


def fused_full_in(state, frames, per_frame, what, model_name="MADNet"):
    """A fused FULL session over ``frames``: two frames (eager step and
    capture, then a replay) each adding exactly ``per_frame`` launches, the
    rest timed. Returns (finalize(), launches, ms/frame, the session)."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    session = make_session(state, "FULL", warp="mxu", fused=True, model_name=model_name, ssim_th=1e9)
    cuda_lib.reset_launches()
    for i, f in enumerate(frames[:2]):
        step_counted(session, f, per_frame, f"{what} frame {i}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames[2:]:
        session.step(f)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (len(frames) - 2)
    launches = dict(cuda_lib.LAUNCHES)
    if launches != {**dict.fromkeys(cuda_lib.LAUNCHES, 0), **{k: v * len(frames) for k, v in per_frame.items()}}:
        raise AssertionError(f"{what}: launches {launches}")
    stats = session.finalize()
    if stats["steps"] != len(frames) or not np.isfinite(stats["loss"]).all():
        raise AssertionError(f"{what}: {stats['steps']} steps, loss {stats['loss']}")
    return stats, launches, ms, session


def fused_serve_in(state, frames, per_frame, what, model_name="MADNet"):
    """Fused NONE serving without metrics over ``frames``, each adding
    ``per_frame`` launches. Returns (launches, ms/frame, the served
    disparities, the session)."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    session = make_session(state, "NONE", warp="mxu", fused=True, model_name=model_name, compute_metrics=False)
    serve = [{k: f[k] for k in ("left", "right")} for f in frames]
    cuda_lib.reset_launches()
    disps = list(session.serve(serve[:2]))  # eager and capture, then a replay
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    disps += list(session.serve(serve[2:]))
    ms = (time.perf_counter() - t0) * 1e3 / (len(serve) - 2)
    launches = dict(cuda_lib.LAUNCHES)
    want = {**dict.fromkeys(cuda_lib.LAUNCHES, 0), **{k: v * len(serve) for k, v in per_frame.items()}}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, want {want}")
    if len(disps) != len(serve) or any(
        d.shape != (1, H, W, 1) or d.dtype != np.float32 or not np.isfinite(d).all() for d in disps
    ):
        raise AssertionError(f"{what}: bad served disparities")
    return launches, ms, disps, session


def assert_served(state, frames, disps, what, model_name="MADNet", rtol=MODEL_RTOL):
    """Each served disparity is its own frame's: the host session's, for
    the first frame and the last, within ``rtol`` of the largest."""
    host = make_session(state, "NONE", warp="mxu", model_name=model_name)
    for i in (0, len(disps) - 1):
        ref = host.step(frames[i])["disp"].float().cpu().numpy()
        err = float(np.abs(disps[i] - ref).max()) / float(np.abs(ref).max())
        log(f"{what}: served disparity {i} against the host session: {err:.3g} of the largest")
        if not err <= rtol:
            raise AssertionError(f"{what}: disparity {i} is not frame {i}'s")


N_FRAMES_SAMPLED = 8
SAMPLED_CHECKED = 3  # frames whose launches the harness reads after each step
# the sampled runs of phase 6, each against its eager twin: tag -> session keywords
SAMPLED_RUNS = {
    "FUSED_MAD_PROBABILITY": dict(sample_mode="PROBABILITY", seed=3),
    "FUSED_MAD_ARGMAX": dict(sample_mode="ARGMAX", seed=3),
    "FUSED_MAD_RANDOM": dict(sample_mode="RANDOM", seed=5),
    "FUSED_MAD_PROBABILITY_2": dict(sample_mode="PROBABILITY", num_blocks=2, seed=3),
    "FUSED_MAD_PROXY_PROBABILITY": dict(sample_mode="PROBABILITY", seed=3, adaptation="proxy"),
}


def proxy_tile_launches(k: int):
    """Fused MADNet MAD under the proxy loss on the tiled warps: the proxy
    loss warps no image, so :func:`mad_tile_launches` less its image warps."""
    return {"corr_fwd": 5, "warp_tile_features_fwd": 4, "corr_bwd": 1,
            "warp_tile_features_bwd": 0 if k == 0 else 1}


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, for two runs of one trajectory that
    must agree: its default backward does not add in a fixed order, and a
    sampled trajectory carries the difference far within a few frames (two
    eager runs of one session part as a switched run and an eager one do);
    on the deterministic algorithms the eager and the switched runs agree
    bit for bit."""
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def sampled_against_eager(state, frames, tag, per_block=mad_tile_launches, **kw):
    """A fused MAD session under a sampled mode, its branch picked on the
    device, against the same session run eagerly (``use_graphs=False``):
    the eager twin's launches counted frame by frame over ``frames``; then
    the switched session, whose first frame captures every branch (C(n, m)
    graphs of the model's n blocks) and launches the switch, the first
    ``SAMPLED_CHECKED`` frames each adding, once the harness syncs the
    counters (``sync_launches``), exactly the twin's launches of that frame
    and one ``graph_switch``, and at one block a frame ``per_block`` of the
    block it drew (read by the harness from ``cur_blocks``); the rest with
    every host sync an error, each frame's draw kept as a device copy.
    ``kw`` goes to :func:`make_session` (``model_name``, ``adaptation``:
    the proxy loss reads each frame's target as its proxy). ``finalize`` must
    leave the counters at the twin's launches plus one ``graph_switch`` a
    frame, and the draws, trajectory, controller and weights must be the
    twin's (within phase 6's bounds; printed, the largest differences,
    which cuDNN's deterministic algorithms keep at 0). Returns the
    session's launches."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    if kw.get("adaptation") == "proxy":
        frames = [{**f, "proxy": f["target"]} for f in frames]
    eager = make_session(state, "MAD", warp="mxu", fused=True, ssim_th=1e9, use_graphs=False, **kw)
    cuda_lib.reset_launches()
    eager_draws, eager_frames = [], []
    for f in frames:
        before = dict(cuda_lib.LAUNCHES)
        eager.step(f)
        eager_draws.append(sorted(eager.cur_blocks.tolist()))
        eager_frames.append({n: v - before[n] for n, v in cuda_lib.LAUNCHES.items() if v != before[n]})
    eager_launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    eager_stats = eager.finalize()

    session = make_session(state, "MAD", warp="mxu", fused=True, ssim_th=1e9, **kw)
    if not session._switching:
        raise AssertionError(f"{tag}: the fused session must switch on the device")
    cuda_lib.reset_launches()
    draws = []
    for i, f in enumerate(frames[:SAMPLED_CHECKED]):
        before = dict(cuda_lib.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.step(f)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        session.sync_launches()
        draws.append(session.cur_blocks.clone())
        ks = sorted(draws[-1].tolist())
        added = {n: cuda_lib.LAUNCHES[n] - before[n] for n in cuda_lib.LAUNCHES if cuda_lib.LAUNCHES[n] != before[n]}
        table = {n: v for n, v in per_block(ks[0]).items() if v} if len(ks) == 1 else eager_frames[i]
        if added.pop("graph_switch", 0) != 1 or added != eager_frames[i] or added != table:
            raise AssertionError(f"{tag} frame {i}: blocks {ks}, launches {added} and the switch's, want the "
                                 f"twin's {eager_frames[i]} and {table}")
        log(f"{tag} frame {i}: blocks {ks}, {ms:.1f} ms{' (every branch captured)' if i == 0 else ''}")
    if len(session._graphs) != math.comb(len(session.engine.blocks), session.num_blocks):
        raise AssertionError(f"{tag}: {len(session._graphs)} graphs captured")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for f in frames[SAMPLED_CHECKED:]:
            session.step(f)
            draws.append(session.cur_blocks.clone())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    stats = session.finalize()
    launches = dict(cuda_lib.LAUNCHES)
    draws = [sorted(d.tolist()) for d in draws]
    want = {**eager_launches, "graph_switch": len(frames)}
    log(f"{tag}: blocks {draws}, the last {len(frames) - SAMPLED_CHECKED} frames with every host sync an error; "
        f"launches after finalize {({k: v for k, v in launches.items() if v})}")
    if draws != eager_draws:
        raise AssertionError(f"{tag}: blocks {draws}, the eager twin's {eager_draws}")
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"{tag}: launches {launches}, want the eager twin's and a switch a frame: {want}")
    assert_trajectory(stats, eager_stats, f"{tag} switched against eager")
    assert_controller(stats, eager_stats, f"{tag} switched against eager")
    moved = float((eager.arena.flat - eager.arena.flat0).abs().max())
    err = float((session.arena.flat - eager.arena.flat).abs().max())
    d_err = float((session.last_disp - eager.last_disp).abs().max()) / float(eager.last_disp.abs().max())
    loss_err = float(np.max(np.abs(stats["loss"] - eager_stats["loss"])))
    log(f"{tag} switched against eager: weights differ by {err:.3g} of {moved:.3g} moved, last disparity by "
        f"{d_err:.3g} of its largest, the loss by {loss_err:.3g}")
    if not (moved > 0 and err <= 1e-2 * moved and d_err <= TRAJ_EPE_RTOL):
        raise AssertionError(f"{tag}: the switched trajectory differs from the eager one")
    return launches


def switched_against_direct(session, tag, k: int = 2, launches: int = 20, rounds: int = 3):
    """One switched launch of a single-block session (its SWITCH node)
    against one direct replay of the same branch's graph (block ``k``,
    ``cur_blocks`` set to it), each timed by CUDA events over ``launches``
    back-to-back launches of the real step, in turns, forward then
    backward (direct, switched, switched, direct), ``rounds`` times.
    Returns the medians, in ms a launch, and the overhead: the median of
    each switched reading less the direct one beside it in time, as the
    card's clock may move between rounds."""
    switch = session._switch[0]
    graph = session._graphs[("mad", (k,))][0]
    session.cur_blocks.fill_(k)
    ways = {"direct": graph.replay, "switched": switch.launch}
    for run in ways.values():
        run()  # PyTorch instantiates a kept graph at its first replay
    torch.cuda.synchronize()
    times = {way: [] for way in ways}
    for _ in range(rounds):
        for way in [*ways, *reversed(ways)]:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                ways[way]()
            end.record()
            end.synchronize()
            times[way].append(start.elapsed_time(end) / launches)
    switch.taken()  # these launches are the measurement's, not a path's
    med = {way: statistics.median(t) for way, t in times.items()}
    # reading i of each way is the other's neighbour in time
    overhead = statistics.median(s - d for s, d in zip(times["switched"], times["direct"]))
    log(f"{tag}: a switched launch {times['switched']} ms against a direct replay of the same branch's graph "
        f"{times['direct']} ms (block {k}, {launches} back-to-back launches each, {rounds} rounds in turns): "
        f"{overhead:+.4f} ms by neighbouring readings, {med['switched'] - med['direct']:+.4f} ms by medians")
    return {f"{tag}_DIRECT_REPLAY": med["direct"], f"{tag}_SWITCHED_LAUNCH": med["switched"],
            f"{tag}_SWITCH_OVERHEAD": overhead}


def run_fused(state, profile_dir):
    """Phase 6: the fused device session at 320x1216 with the tiled one-hot
    warps in model and loss. Returns (launches by path, ms/frame by path)."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    launches, frame_ms = {}, {}
    frames = smooth_frames(N_FRAMES_FUSED, 100)

    # --- MAD, SEQUENTIAL: two rounds checked frame by frame, then two rounds
    # free-running with every host sync turned into an error
    session = make_session(state, "MAD", warp="mxu", fused=True, **MAD_KW)
    if not session.use_graphs:
        raise AssertionError("the fused session must replay graphs on the card")
    n_blocks = len(session.engine.blocks)
    checked = 2 * n_blocks
    prev = [session.arena.flat.clone()]

    def owns_block(i):
        # the step moved the sampled block's arena range and nothing else
        k = i % n_blocks
        moved = (session.arena.flat != prev[0]).nonzero().flatten()
        prev[0] = session.arena.flat.clone()
        start, end = session.arena.block_ranges[k]
        if moved.numel() == 0 or int(moved.min()) < start or int(moved.max()) >= end:
            raise AssertionError(f"fused MAD frame {i}: block {k} owns [{start}, {end}) but the "
                                 f"arena moved in [{int(moved.min()) if moved.numel() else None}, "
                                 f"{int(moved.max()) if moved.numel() else None}]")

    torch.cuda.reset_peak_memory_stats()
    fused, launches["FUSED_MAD"], frame_ms["FUSED_MAD"] = fused_mad_in(
        session, frames, lambda i: mad_tile_launches(i % n_blocks), checked, "fused MAD", owns_block)
    log(f"fused MAD peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    fused_flat = session.arena.flat.clone()
    fused_disp = session.last_disp.clone()

    # the host session over the same frames and weights with the same warps
    host = make_session(state, "MAD", warp="mxu", **MAD_KW)
    frame_ms["HOST_MAD_MXU"] = timed_host(host, frames, warm=n_blocks)
    assert_trajectory(fused, host_stats(host), "fused MAD against the host session")
    assert_controller(fused, host_stats(host), "fused MAD against the host session")
    host_flat = torch.cat([dict(host.engine.model.named_parameters())[name].detach().flatten()
                           for name, *_ in session.arena.entries])
    moved = float((fused_flat - session.arena.flat0).abs().max())
    err = float((fused_flat - host_flat).abs().max())
    log(f"fused MAD against the host session: weights moved by up to {moved:.3g}, differ by {err:.3g}")
    if not (moved > 0 and err <= 1e-2 * moved):
        raise AssertionError("fused MAD: adapted weights differ from the host session's")

    # replay against eager: the same session class without graphs
    eager = make_session(state, "MAD", warp="mxu", fused=True, use_graphs=False, **MAD_KW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames:
        eager.step(f)
    torch.cuda.synchronize()
    frame_ms["FUSED_MAD_EAGER"] = (time.perf_counter() - t0) * 1e3 / len(frames)
    if eager._graphs:
        raise AssertionError("use_graphs=False captured a graph")
    assert_trajectory(fused, eager.finalize(), "fused MAD replayed against eager")
    assert_controller(fused, eager.finalize(), "fused MAD replayed against eager")
    err = float((fused_flat - eager.arena.flat).abs().max())
    d_err = float((fused_disp - eager.last_disp).abs().max()) / float(eager.last_disp.abs().max())
    log(f"fused MAD replayed against eager: weights differ by {err:.3g} of {moved:.3g} moved, "
        f"last disparity by {d_err:.3g} of its largest")
    # 20 steps of weights that differ in the seventh digit: measured 1.6e-4
    if not (err <= 1e-2 * moved and d_err <= TRAJ_EPE_RTOL):
        raise AssertionError("fused MAD: a replayed trajectory differs from the eager one")

    # the same session on the clamped-window kernels (warp_mode 'cuda'), for
    # the in-model comparison of the two warp routes: first round captures,
    # then both run the same steady frames, turn and turn about
    other = make_session(state, "MAD", warp="cuda", fused=True, **MAD_KW)
    for f in frames[:n_blocks]:
        other.step(f)
    by_route = {"mxu": [], "cuda": []}
    launches["FUSED_MAD_CUDA_WARPS"] = dict.fromkeys(cuda_lib.LAUNCHES, 0)
    for _ in range(2):
        for route, sess in (("mxu", session), ("cuda", other)):
            cuda_lib.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for f in frames[n_blocks : 3 * n_blocks]:
                sess.step(f)
            torch.cuda.synchronize()
            by_route[route].append((time.perf_counter() - t0) * 1e3 / (2 * n_blocks))
            if route == "cuda":
                for k, v in cuda_lib.LAUNCHES.items():
                    launches["FUSED_MAD_CUDA_WARPS"][k] += v
    got = launches["FUSED_MAD_CUDA_WARPS"]
    if any(v for k, v in got.items() if "tile" in k) or not all(
        got[k] for k in ("warp_image_fwd", "warp_features_fwd", "warp_image_bwd", "warp_features_bwd")
    ):
        raise AssertionError(f"fused MAD with warp_mode 'cuda': launches {got}")
    frame_ms["FUSED_MAD_CUDA_WARPS"] = min(by_route["cuda"])
    log(f"fused MAD steady ms/frame by warp route, two passes each: {by_route}")
    del other

    # --- MAD, the sampled modes: the device picks the block's graph (a
    # CUDA-graph switch); each against its eager twin on cuDNN's
    # deterministic algorithms, then, on its default ones, PROBABILITY timed
    # and a switched launch against a direct replay of the same branch's
    # graph, before the first profiler window of the process and after it
    for tag, kw in SAMPLED_RUNS.items():
        per_block = proxy_tile_launches if kw.get("adaptation") == "proxy" else mad_tile_launches
        with deterministic_cudnn():
            launches[tag] = sampled_against_eager(state, frames[:N_FRAMES_SAMPLED], tag, per_block, **kw)
    sampled = make_session(state, "MAD", warp="mxu", fused=True, ssim_th=1e9, **SAMPLED_RUNS["FUSED_MAD_PROBABILITY"])
    for f in frames[:SAMPLED_CHECKED]:
        sampled.step(f)
    steady = frames[SAMPLED_CHECKED:]
    dev, frame_ms["FUSED_MAD_PROBABILITY"] = events_ms(lambda i: sampled.step(steady[i]), len(steady), sync_error=True)
    frame_ms["FUSED_MAD_PROBABILITY_DEVICE"] = dev
    log(f"fused MAD PROBABILITY steady: {frame_ms['FUSED_MAD_PROBABILITY']:.3f} ms/frame ({dev:.3f} by CUDA events) "
        f"over {len(steady)} frames with every host sync an error")
    frame_ms.update(switched_against_direct(sampled, "FUSED_MAD_PROBABILITY"))

    # what each block's graph holds: device activities of one replay
    per_graph = [device_activities(session, frames[k]) for k in range(n_blocks)]
    log(f"fused MAD kernels and copies in one replay, by block trained: {per_graph}")
    # a profiler window leaves a conditional node's bodies slower for the
    # rest of the process (CUPTI): the same measurement again
    frame_ms.update(switched_against_direct(sampled, "FUSED_MAD_PROBABILITY_AFTER_PROFILER"))
    del sampled

    # the one-graph alternative: shared forward, block loss selected on the
    # device, full backward, update masked by block ownership
    shared = make_session(state, "MAD", warp="mxu", fused=True, shared_forward=True, **MAD_KW)
    for f in frames[:checked]:
        shared.step(f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames[checked:]:
        shared.step(f)
    torch.cuda.synchronize()
    frame_ms["FUSED_MAD_SHARED_FORWARD"] = (time.perf_counter() - t0) * 1e3 / (N_FRAMES_FUSED - checked)
    if set(shared._graphs) != {("shared",)}:
        raise AssertionError(f"shared_forward captured {set(shared._graphs)}")
    assert_trajectory(shared.finalize(), fused, "fused MAD shared_forward against per-block graphs")
    assert_controller(shared.finalize(), fused, "fused MAD shared_forward against per-block graphs")
    log(f"fused MAD shared_forward: {frame_ms['FUSED_MAD_SHARED_FORWARD']:.3f} ms/frame, "
        f"{device_activities(shared, frames[0])} kernels and copies in its one graph")
    del shared

    # step_chunk over K frames equals K steps
    chunked = make_session(state, "MAD", warp="mxu", fused=True, **MAD_KW)
    for c in range(2):
        chunk = frames[c * n_blocks : (c + 1) * n_blocks]
        chunked.step_chunk({k: np.stack([f[k] for f in chunk]) for k in chunk[0]})
    if tuple(chunked.last_disp.shape) != (n_blocks, 1, H, W, 1):
        raise AssertionError(f"step_chunk: last_disp {tuple(chunked.last_disp.shape)}")
    assert_trajectory(chunked.finalize(), fused, "step_chunk against steps", frames=checked)
    del chunked, eager, host


    # --- FULL
    full_kw = dict(ssim_th=1e9)
    fused, launches["FUSED_FULL"], frame_ms["FUSED_FULL"], _ = fused_full_in(
        state, frames[:N_FRAMES_FULL + 3], TILE_FULL, "fused FULL")
    host = make_session(state, "FULL", warp="mxu", **full_kw)
    frame_ms["HOST_FULL_MXU"] = timed_host(host, frames[:N_FRAMES_FULL + 3], warm=1)
    assert_trajectory(fused, host_stats(host), "fused FULL against the host session")
    del host

    # --- NONE: with metrics (the loss runs), then serving without
    none_launches = {**TILE_SERVE, "warp_tile_image_fwd": 1}
    session = make_session(state, "NONE", warp="mxu", fused=True)
    cuda_lib.reset_launches()
    for i, f in enumerate(frames[:3]):
        step_counted(session, f, none_launches, f"fused NONE frame {i}")
    host = make_session(state, "NONE", warp="mxu")
    for f in frames[:3]:
        host.step(f)
    assert_trajectory(session.finalize(), host_stats(host), "fused NONE against the host session")
    del session, host
    launches["FUSED_NONE"], frame_ms["FUSED_NONE_SERVE"], disps, session = fused_serve_in(
        state, frames[:N_FRAMES_NONE + 3], TILE_SERVE, "fused NONE serving")
    assert_served(state, frames, disps, "fused NONE serving")
    del session

    # --- the reset, on the device: a threshold below every loss
    session = make_session(state, "MAD", warp="mxu", fused=True, sample_mode="FIXED", fixed_id=2,
                           ssim_th=-1.0)
    for f in frames[:3]:  # eager, then two replays
        session.step(f)
    stats = session.finalize()
    if int(stats["reset_count"]) != 3 or not torch.equal(session.arena.flat, session.arena.flat0):
        raise AssertionError("fused reset: the pristine arena was not restored")
    if not bool(session.opt["acc"][0].any()):
        raise AssertionError("fused reset: the steps before it left no optimizer state")
    log("fused reset safeguard: arena restored on the device, optimizer state kept")

    if profile_dir:
        # the tiled warps (K6/K7), and FULL once more on the default route,
        # warp_mode 'auto': the clamped-window warps (K2-K5) on the card
        for mode, kw, warp, tag in (("MAD", MAD_KW, "mxu", "fused_mad"), ("FULL", full_kw, "mxu", "fused_full"),
                                    ("NONE", {}, "mxu", "fused_none"),
                                    ("FULL", full_kw, "auto", "fused_full_auto")):
            session = make_session(state, mode, warp=warp, fused=True, **kw)
            for f in frames[:n_blocks]:
                session.step(f)  # every branch captured
            torch.cuda.synchronize()
            profile_frames(session, frames[n_blocks : 2 * n_blocks], Path(profile_dir), tag)
    return launches, frame_ms


# ------------------------------------------------------------------ phase 7
N_FRAMES_DN = 12  # two SEQUENTIAL rounds of the six blocks
DN_CORR_BLOCKS = (3, 4)  # conv2 and conv1: the blocks before the correlation
DN_DISP = 20.0  # px that each tamed prediction layer predicts


def seeded_dispnet_params(seed: int):
    """DispNet-Corr1D weights in the JAX layout (``w`` HWIO, transposed
    kernels ``[kh, kw, out, in]``), Xavier-uniform from a numpy seed, with
    small non-zero biases. Each prediction layer (the five blocks'
    ``predict`` and the final ``prediction``) is tamed as MADNet's last
    estimator convs are: weights x0.02 and a bias that predicts DN_DISP px
    once ``_make_disp`` has scaled it by the padded width over its own. With
    Xavier weights alone the relu there zeroes a prediction everywhere and
    its block gets no gradient."""
    from real_time_self_adaptive_deep_stereo_torch.models import DispNet

    shapes = {k: tuple(v.shape) for k, v in DispNet(device="cpu").state_dict().items()}
    scale = {"prediction": 2, **{f"up{i}": 2 ** (i + 1) for i in range(1, 6)}}
    r = np.random.default_rng(seed)
    tree = {}
    for key, shape in sorted(shapes.items()):
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        tamed = path[-1] in ("predict", "prediction")
        if leaf == "weight":  # OIHW or [in, out, kh, kw]: the JAX layout reverses the axes
            s0, s1, kh, kw = shape
            lim = math.sqrt(6.0 / (kh * kw * (s0 + s1)))
            node["w"] = (r.uniform(-lim, lim, (kh, kw, s1, s0)) * (0.02 if tamed else 1.0)).astype(np.float32)
        else:
            bias = 0.01 * r.standard_normal(shape) + (DN_DISP / scale[path[0]] if tamed else 0.0)
            node["b"] = bias.astype(np.float32)
    return tree


def dn_launches(mode: str, k: int = 0, tiled: bool = False):
    """What one DispNet frame must launch: the wide correlation forward,
    and the loss's image warp (the tiled kernels on the fused route)."""
    img_fwd, img_bwd = ("warp_tile_image_fwd", "warp_tile_image_bwd") if tiled else (
        "warp_image_fwd", "warp_image_bwd")
    if mode == "NONE":
        return {"corr_fwd_wide": 1, img_fwd: 1}
    if mode == "FULL":
        return {"corr_fwd_wide": 1, "corr_bwd_wide": 1, img_fwd: 1, img_bwd: 1}
    # MAD: block loss + full loss; a gradient back through the correlation
    # for the blocks before it only
    return {"corr_fwd_wide": 1, img_fwd: 2, img_bwd: 1, **({"corr_bwd_wide": 1} if k in DN_CORR_BLOCKS else {})}


def check_dispnet_against_plain(state):
    """One frame of NONE, MAD (block 3, through the correlation, and block
    5) and FULL with the kernels and with the plain modes on the card: the
    disparities of the frame's forward and of a forward after the step
    within MODEL_RTOL of the largest, the gradient within STEP_RTOL of its
    largest entry; the plain sessions launch no kernel."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    frame = make_smooth_frame(8)
    images = [torch.from_numpy(frame[k]).cuda() for k in ("left", "right")]
    for mode, kw in (("NONE", {}), ("MAD", dict(sample_mode="FIXED", fixed_id=3)),
                     ("MAD", dict(sample_mode="FIXED", fixed_id=5)), ("FULL", {})):
        what = f"DispNet {mode}{' block %d' % kw['fixed_id'] if kw else ''}"
        runs = []
        for plain in (False, True):
            session = make_session(state, mode, plain=plain, model_name="Dispnet", ssim_th=1e9, **kw)
            cuda_lib.reset_launches()
            disp = session.step(frame)["disp"]
            launched = {n: c for n, c in cuda_lib.LAUNCHES.items() if c}
            want = {} if plain else dn_launches(mode, kw.get("fixed_id", 0))
            if launched != want:
                raise AssertionError(f"{what} {'plain' if plain else 'kernels'}: launches {launched}, want {want}")
            with torch.no_grad():
                after = session.engine.model(*images)["disparities"]
            acc = session.engine.opt["acc"] if mode != "NONE" else {}
            runs.append(([disp, *after], acc))
        (fast, fast_acc), (plain_d, plain_acc) = runs
        worst = 0.0
        for i, (a, b) in enumerate(zip(fast, plain_d)):
            scale = max(float(b.abs().max()), 1e-6)
            worst = max(worst, float((a - b).abs().max()) / scale)
            torch.testing.assert_close(a, b, rtol=MODEL_RTOL, atol=MODEL_RTOL * scale,
                                       msg=lambda m, i=i: f"{what} disparity {i}: {m}")
        msg = f"{what}, kernels vs plain modes: disparities within {worst:.3g} of the largest"
        if fast_acc:
            g_scale = max(float(v.abs().max()) for v in plain_acc.values())
            g_err = max(float((fast_acc[k] - plain_acc[k]).abs().max()) for k in plain_acc)
            msg += f"; gradient within {g_err / g_scale:.3g} of its largest entry {g_scale:.3g}"
            if not (g_scale > 0 and g_err <= STEP_RTOL * g_scale):
                raise AssertionError(msg)
        log(msg)


def run_dispnet(profile_dir):
    """Phase 7: DispNet-Corr1D's sessions at 320x1216. Returns (launches
    by path, ms/frame by path)."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import params_from_jax

    state = params_from_jax(seeded_dispnet_params(1))
    launches, frame_ms = {}, {}

    session = make_session(state, "NONE", model_name="Dispnet")
    _, _, launches["DISPNET_NONE"], frame_ms["DISPNET_NONE"] = drive(
        session, make_frames(N_FRAMES_NONE, 11), lambda i: dn_launches("NONE"))
    if profile_dir:
        profile_frames(session, make_frames(3, 12), Path(profile_dir), "dispnet_none")

    session = make_session(state, "MAD", model_name="Dispnet", sample_mode="SEQUENTIAL", ssim_th=1e9, seed=0)
    blocks = session.engine.blocks
    if len(blocks) != 6:
        raise AssertionError(f"DispNet MAD: {len(blocks)} blocks")

    def after_step(i, before):
        k = i % len(blocks)
        changed = changed_names(session, before)
        if not changed or not changed <= set(blocks[k].names):
            raise AssertionError(f"DispNet MAD frame {i}: block {k} was trained but "
                                 f"{sorted(changed) or 'nothing'} changed")

    _, step_ms, launches["DISPNET_MAD"], frame_ms["DISPNET_MAD"] = drive(
        session, make_frames(N_FRAMES_DN, 13), lambda i: dn_launches("MAD", i % len(blocks)),
        after_step, warm=len(blocks))
    by_block = {k: statistics.median(step_ms[k + len(blocks) :: len(blocks)]) for k in range(len(blocks))}
    log(f"DispNet MAD ms/frame by block trained (second round): {by_block}")
    if profile_dir:
        profile_frames(session, make_frames(len(blocks), 14), Path(profile_dir), "dispnet_mad")

    session = make_session(state, "FULL", model_name="Dispnet", ssim_th=1e9)
    _, _, launches["DISPNET_FULL"], frame_ms["DISPNET_FULL"] = drive(
        session, make_frames(N_FRAMES_FULL, 15), lambda i: dn_launches("FULL"))
    if profile_dir:
        profile_frames(session, make_frames(3, 16), Path(profile_dir), "dispnet_full")
    del session

    check_dispnet_against_plain(state)

    # the fused session, tiled warps in the loss: a round checked frame by
    # frame (eager step and capture), then replays, against the host session
    frames = smooth_frames(N_FRAMES_DN + 6, 200)
    session = make_session(state, "MAD", warp="mxu", fused=True, model_name="Dispnet", **MAD_KW)
    fused, launches["DISPNET_FUSED_MAD"], frame_ms["DISPNET_FUSED_MAD"] = fused_mad_in(
        session, frames, lambda i: dn_launches("MAD", i % len(blocks), tiled=True), N_FRAMES_DN, "DispNet fused MAD")
    host = make_session(state, "MAD", warp="mxu", model_name="Dispnet", **MAD_KW)
    frame_ms["DISPNET_HOST_MAD_MXU"] = timed_host(host, frames, warm=len(blocks))
    assert_trajectory(fused, host_stats(host), "DispNet fused MAD against the host session")
    assert_controller(fused, host_stats(host), "DispNet fused MAD against the host session")
    if profile_dir:
        profile_frames(session, frames[:len(blocks)], Path(profile_dir), "dispnet_fused_mad")
    del session, host

    # the fused MAD session under PROBABILITY, its block picked on the
    # device (a SWITCH node over the six blocks' graphs: transposed convs
    # and the radius-40 correlation in the bodies), against its eager twin
    with deterministic_cudnn():
        launches["DISPNET_FUSED_MAD_PROBABILITY"] = sampled_against_eager(
            state, frames[:N_FRAMES_SAMPLED], "DISPNET_FUSED_MAD_PROBABILITY",
            lambda k: dn_launches("MAD", k, tiled=True), model_name="Dispnet", sample_mode="PROBABILITY", seed=3)

    # the fused FULL session, tiled warps in the loss, against the host
    # FULL session on the same frames and weights
    full_frames = frames[:N_FRAMES_FULL + 3]
    fused, launches["DISPNET_FUSED_FULL"], frame_ms["DISPNET_FUSED_FULL"], session = fused_full_in(
        state, full_frames, dn_launches("FULL", tiled=True), "DispNet fused FULL", model_name="Dispnet")
    host = make_session(state, "FULL", warp="mxu", model_name="Dispnet", ssim_th=1e9)
    frame_ms["DISPNET_HOST_FULL_MXU"] = timed_host(host, full_frames, warm=1)
    assert_trajectory(fused, host_stats(host), "DispNet fused FULL against the host session")
    host_flat = torch.cat([dict(host.engine.model.named_parameters())[name].detach().flatten()
                           for name, *_ in session.arena.entries])
    moved = float((session.arena.flat - session.arena.flat0).abs().max())
    err = float((session.arena.flat - host_flat).abs().max())
    log(f"DispNet fused FULL against the host session: weights moved by up to {moved:.3g}, differ by {err:.3g}; "
        f"{frame_ms['DISPNET_FUSED_FULL']:.3f} ms/frame fused, {frame_ms['DISPNET_HOST_FULL_MXU']:.3f} host")
    if not (moved > 0 and err <= 1e-2 * moved):
        raise AssertionError("DispNet fused FULL: adapted weights differ from the host session's")
    if profile_dir:
        profile_frames(session, full_frames[:3], Path(profile_dir), "dispnet_fused_full")
    del session, host

    # fused NONE serving: no loss, so the correlation alone
    launches["DISPNET_FUSED_NONE"], frame_ms["DISPNET_FUSED_NONE_SERVE"], disps, _ = fused_serve_in(
        state, frames[:N_FRAMES_NONE + 3], {"corr_fwd_wide": 1}, "DispNet fused NONE serving", model_name="Dispnet")
    assert_served(state, frames, disps, "DispNet fused NONE serving", model_name="Dispnet")
    return launches, frame_ms


# ------------------------------------------------------------------ phase 8
PRECISIONS = ("default", "bf16", "bf16_act")
N_FRAMES_PREC = 15  # three SEQUENTIAL rounds; the first runs eagerly and captures
# JAX tests/test_adapt.py::test_bf16_act_forward_drift_bounded: the median
# of |d - d_highest| / max(|d_highest|, 1) over the first frame's full-res
# disparity
DRIFT_MEDIAN = 0.05
# the per-frame EPE of the first MAD round (each block trained once from
# the same weights) against highest's, relative: the same class of bound as
# the disparity's drift. Later rounds are printed, not bounded: on these
# random-weight trajectories each second step of block 0 moves the EPE by
# some 110 px in every mode (34 to 280 px over 15 frames at highest, with a
# flat loss), and a divergent trajectory amplifies any rounding difference
PREC_EPE_RTOL = 0.05
# fused against host MAD in a mode: the same ops on the same frames (under
# bf16_act they agreed exactly); cuDNN's bf16 backward rounds its weight
# gradient to bf16 and is not run to run deterministic, so a step's weights
# may differ in the last bf16 digit of a gradient where fp32 differs in the
# seventh decimal. Under default the two sessions' TF32 convolutions do not
# round alike (frame 0's loss, before any step, differed by 1.2e-5) and the
# random-weight trajectory amplifies that (1.5e-3 by frame 7), so there the
# first round (each block trained once) is bounded, in the bf16 modes every
# frame
PREC_TRAJ_LOSS_RTOL = 1e-3
PREC_TRAJ_EPE_RTOL = 1e-2
PREC_SCORE_ATOL = 1e-4
# a served disparity against the host session's, of the largest: one bf16
# ulp in the bf16 modes; under default 1e-2, as the two sessions' TF32
# convolutions round apart and 49 layers add it up (measured 1.3e-3). A
# frame served out of order is whole pixels off
PREC_SERVE_RTOL = {"default": 1e-2, "bf16": 2.0**-8, "bf16_act": 2.0**-8}
# bf16_act steps, kernels against plain modes: at least this share of the
# entries where the plain modes' bf16_act and highest results differ lies
# closer to the bf16_act one; the kernels run at highest (the control)
# score about 0
PREC_SHARE = 0.5


def in_precision(table, mode):
    """A launch table as ``mode`` runs it: the correlation's bf16 instances
    under bf16_act (the features are bf16), the fp32 ones otherwise."""
    if mode != "bf16_act":
        return dict(table)
    return {(f"{k}_bf16" if k.startswith("corr") else k): v for k, v in table.items()}


def assert_tf32(mode):
    got = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if got != (False, mode == "default"):
        raise AssertionError(f"{mode}: tf32 matmul/cudnn {got}, want (False, {mode == 'default'})")


def drift(got, want):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    return float(np.median(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


def closer_share(got, want, highest):
    """Among the entries where ``want`` (a mode's reference) and
    ``highest`` differ, the share at which ``got`` lies closer to ``want``."""
    differ = want != highest
    if not bool(differ.any()):
        raise AssertionError("the mode's reference equals highest's")
    return float(((got - want).abs()[differ] < (got - highest).abs()[differ]).float().mean())


def check_bf16_act_against_plain(mad_state, dn_state):
    """One bf16_act MAD step of MADNet (block 4) and of DispNet (block 3,
    back through the wide bf16 correlation) with the kernels and with the
    plain modes on the card. The plain modes' steps at bf16_act and at
    highest are the references: at the entries where the two differ, the
    kernels' disparity (the frame's forward) and gradient lie closer to the
    bf16_act one at PREC_SHARE of them or more, and the kernels run at
    highest, the control, at fewer. The plain runs launch no kernel; the
    kernels' runs launch the bf16 correlation under bf16_act only."""
    from real_time_self_adaptive_deep_stereo_torch.ops import conv_precision, cuda_lib

    frame = make_smooth_frame(4)
    for model_name, state, block in (("MADNet", mad_state, 4), ("Dispnet", dn_state, 3)):
        runs = {}
        for mode, plain in (("bf16_act", False), ("bf16_act", True), ("highest", True), ("highest", False)):
            with conv_precision(mode):
                session = make_session(state, "MAD", plain=plain, model_name=model_name, ssim_th=1e9,
                                       sample_mode="FIXED", fixed_id=block)
                cuda_lib.reset_launches()
                disp = session.step(frame)["disp"].float().flatten()
            launched = {n for n, c in cuda_lib.LAUNCHES.items() if c}
            corr = {n for n in launched if n.startswith("corr")}
            if (plain and launched) or (not plain and (not corr or any(
                    n.endswith("_bf16") != (mode == "bf16_act") for n in corr))):
                raise AssertionError(f"{model_name} {mode} {'plain' if plain else 'kernels'}: launched {launched}")
            acc = session.engine.opt["acc"]
            runs[mode, plain] = (disp, torch.cat([acc[k].flatten() for k in sorted(acc)]))
        ref, highest = runs["bf16_act", True], runs["highest", True]
        for i, what in enumerate(("disparity", "gradient")):
            scale = float(ref[i].abs().max())
            kernels = [runs[mode, False][i] for mode in ("bf16_act", "highest")]
            share, control = (closer_share(k, ref[i], highest[i]) for k in kernels)
            err, gap = (float((k - ref[i]).abs().max()) / scale for k in kernels)
            log(f"{model_name} bf16_act MAD block {block} {what}, kernels vs plain modes: within {err:.3g} of the "
                f"largest, closer to the plain bf16_act result at {share:.3f} of the entries where it differs from "
                f"highest's; the kernels at highest (control): {gap:.3g}, {control:.3f} (bound {PREC_SHARE})")
            if not (share >= PREC_SHARE > control):
                raise AssertionError(f"{model_name} bf16_act {what}: the kernels do not follow the plain modes")


def check_epe_drift(stats, ref, what, first):
    """A session's EPE per frame in a mode against highest's on the same
    frames: the first ``first`` frames (MAD's first round, each block
    trained once from the same weights; FULL's first update and the frame
    that sees it) within PREC_EPE_RTOL, the rest printed."""
    rel = np.abs(stats["epe"] - ref["epe"]) / ref["epe"]
    log(f"{what} EPE per frame {np.round(stats['epe'], 4).tolist()}; highest "
        f"{np.round(ref['epe'], 4).tolist()}; largest relative difference over the first {first} frames "
        f"{float(rel[:first].max()):.4g} (bound {PREC_EPE_RTOL}), over all {len(rel)} frames "
        f"{float(rel.max()):.4g} (not bounded); loss {np.round(stats['loss'], 6).tolist()}")
    if not float(rel[:first].max()) <= PREC_EPE_RTOL:
        raise AssertionError(f"{what}: EPE departs from highest's")


def full_in_mode(state, frames, per_frame, mode, tag, ref, launches, frame_ms, model_name="MADNet", host=True):
    """Fused FULL (and, with ``host``, host FULL) in ``mode`` over
    ``frames``: launches counted, the EPE against highest's ``ref``
    (:func:`check_epe_drift`, the first two frames), fused against host
    over the first two frames at phase 8's bounds (FULL steps every weight
    each frame, and the random-weight trajectory carries the two sessions'
    roundings on); ms/frame from CUDA events over the steady frames."""
    stats, launches[f"{tag}_FUSED_FULL"], frame_ms[f"{tag}_FUSED_FULL"], session = fused_full_in(
        state, frames, per_frame, f"{mode} {model_name} fused FULL", model_name=model_name)
    check_epe_drift(stats, ref, f"{mode} {model_name} fused FULL", 2)
    dev, wall = events_ms(lambda i: session.step(frames[2 + i]), len(frames) - 2)
    frame_ms[f"{tag}_FUSED_FULL_EVENTS"] = dev
    log(f"{mode} {model_name} fused FULL: {dev:.3f} ms/frame of device time (CUDA events, {wall:.3f} wall) over "
        f"{len(frames) - 2} replayed frames")
    if model_name == "Dispnet" and mode == "bf16_act" and session.last_disp.dtype != torch.bfloat16:
        raise AssertionError(f"DispNet fused FULL under bf16_act: {session.last_disp.dtype}, want bf16")
    del session
    if not host:
        return stats
    session = make_session(state, "FULL", warp="mxu", model_name=model_name, ssim_th=1e9)
    _, _, launches[f"{tag}_HOST_FULL"], frame_ms[f"{tag}_HOST_FULL"] = drive(session, frames, lambda i: per_frame)
    assert_trajectory(stats, host_stats(session), f"{mode} {model_name} fused FULL against the host session",
                      frames=2, loss_rtol=PREC_TRAJ_LOSS_RTOL, epe_rtol=PREC_TRAJ_EPE_RTOL)
    rest = np.abs(np.asarray(stats["loss"], np.float64) - session.stats.loss) / np.asarray(session.stats.loss)
    dev, wall = events_ms(lambda i: session.step(frames[i]), 3)
    frame_ms[f"{tag}_HOST_FULL_EVENTS"] = dev
    log(f"{mode} {model_name} host FULL: the fused loss within {float(rest.max()):.3g} of the host's over all "
        f"{len(frames)} frames (not bounded); {dev:.3f} ms/frame (CUDA events, {wall:.3f} wall, a sync each step)")
    del session
    return stats


def run_precision(state, profile_dir):
    """Phase 8: the precision modes on the card. MADNet's fused MAD, host
    MAD, fused and host FULL and fused NONE serving in every mode against
    highest on the same frames and weights, fused against host; under
    bf16_act also DispNet's host MAD (blocks 3-4 run the wide bf16
    backward), fused FULL against highest's and fused NONE serving, and
    one step of each model with the kernels against the plain modes.
    Returns (launches by path, ms/frame by path)."""
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.ops import conv_precision
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import params_from_jax
    from real_time_self_adaptive_deep_stereo_torch.utils.device import resolve_device

    launches, frame_ms = {}, {}
    dn_state = params_from_jax(seeded_dispnet_params(1))
    frames = smooth_frames(N_FRAMES_PREC, 300)
    first = [torch.from_numpy(frames[0][k]).cuda() for k in ("left", "right")]

    def first_frame_disp():
        model = get_stereo_net("MADNet", bulkhead=True, warp_mode="mxu")
        model.load_state_dict(state)
        with torch.no_grad():
            return model(*first)["full_res_disp"]

    def fused_mad(mode):
        session = make_session(state, "MAD", warp="mxu", fused=True, **MAD_KW)
        assert_tf32(mode)
        n = len(session.engine.blocks)
        stats, counts, ms = fused_mad_in(session, frames, lambda i: in_precision(mad_tile_launches(i % n), mode),
                                         n, f"{mode} fused MAD")
        return stats, counts, ms, session

    ref_disp = first_frame_disp()
    ref, _, frame_ms["PREC_HIGHEST_FUSED_MAD"], session = fused_mad("highest")
    n_blocks = len(session.engine.blocks)
    del session
    # FULL's references at highest, MADNet's and DispNet's, on the same frames
    full_frames = frames[:N_FRAMES_FULL + 3]
    dn_full = in_precision(dn_launches("FULL", tiled=True), "highest")
    ref_full, _, frame_ms["PREC_HIGHEST_FUSED_FULL"], session = fused_full_in(
        state, full_frames, TILE_FULL, "highest fused FULL")
    del session
    ref_dn_full, _, frame_ms["PREC_HIGHEST_DISPNET_FUSED_FULL"], session = fused_full_in(
        dn_state, full_frames, dn_full, "highest DispNet fused FULL", model_name="Dispnet")
    del session
    for mode in PRECISIONS:
        tag = f"PREC_{mode.upper()}"
        with conv_precision(mode):
            disp = first_frame_disp()
            if disp.dtype != torch.float32 or not bool(torch.isfinite(disp).all()):
                raise AssertionError(f"{mode}: first frame's disparity {disp.dtype}")
            d = drift(disp, ref_disp)
            log(f"{mode}: first frame's full-res disparity against highest: median relative error {d:.4g} "
                f"(bound {DRIFT_MEDIAN})")
            if not d < DRIFT_MEDIAN:
                raise AssertionError(f"{mode}: drift {d} from highest")

            stats, launches[f"{tag}_FUSED_MAD"], frame_ms[f"{tag}_FUSED_MAD"], session = fused_mad(mode)
            check_epe_drift(stats, ref, f"{mode} fused MAD", n_blocks)
            if profile_dir and mode == "bf16_act":
                profile_frames(session, frames[:5], Path(profile_dir), "fused_mad_bf16_act")
            del session

            # host MAD over the same frames, against the fused trajectory
            host = make_session(state, "MAD", warp="mxu", **MAD_KW)
            _, _, launches[f"{tag}_HOST_MAD"], frame_ms[f"{tag}_HOST_MAD"] = drive(
                host, frames, lambda i: in_precision(mad_tile_launches(i % n_blocks), mode), warm=n_blocks)
            assert_trajectory(stats, host_stats(host), f"{mode} fused MAD against the host session",
                              frames=n_blocks if mode == "default" else None,
                              loss_rtol=PREC_TRAJ_LOSS_RTOL, epe_rtol=PREC_TRAJ_EPE_RTOL)
            assert_controller(stats, host_stats(host), f"{mode} fused MAD against the host session",
                              score_atol=PREC_SCORE_ATOL)
            del host

            serve_rtol = PREC_SERVE_RTOL[mode]
            launches[f"{tag}_FUSED_NONE"], frame_ms[f"{tag}_FUSED_NONE_SERVE"], disps, session = fused_serve_in(
                state, frames[:N_FRAMES_NONE + 3], in_precision(TILE_SERVE, mode), f"{mode} fused NONE serving")
            assert_served(state, frames, disps, f"{mode} fused NONE serving", rtol=serve_rtol)
            if profile_dir and mode == "bf16_act":
                profile_frames(session, [{k: f[k] for k in ("left", "right")} for f in frames[:5]],
                               Path(profile_dir), "fused_none_bf16_act")
            del session

            full_in_mode(state, full_frames, in_precision(TILE_FULL, mode), mode, tag, ref_full, launches, frame_ms)
            if mode != "bf16_act":
                continue
            full_in_mode(dn_state, full_frames, in_precision(dn_full, mode), mode, f"{tag}_DISPNET", ref_dn_full,
                         launches, frame_ms, model_name="Dispnet", host=False)
            if profile_dir:
                session = make_session(state, "FULL", warp="mxu", fused=True, ssim_th=1e9)
                for f in frames[:2]:
                    session.step(f)  # the branch captured and replayed once
                torch.cuda.synchronize()
                profile_frames(session, frames[2:7], Path(profile_dir), "fused_full_bf16_act")
                del session

            # DispNet-Corr1D: host MAD over dispnet_full_6.json, fused NONE serving
            session = make_session(dn_state, "MAD", model_name="Dispnet", **MAD_KW)
            results, _, launches[f"{tag}_DISPNET_HOST_MAD"], frame_ms[f"{tag}_DISPNET_HOST_MAD"] = drive(
                session, make_frames(N_FRAMES_DN, 13), lambda i: in_precision(dn_launches("MAD", i % 6), mode), warm=6)
            if any(r["disp"].dtype != torch.bfloat16 for r in results):
                raise AssertionError("DispNet under bf16_act: the disparities must be bf16, as the reference's")
            del session
            launches[f"{tag}_DISPNET_FUSED_NONE"], frame_ms[f"{tag}_DISPNET_FUSED_NONE_SERVE"], disps, session = (
                fused_serve_in(dn_state, frames[:N_FRAMES_NONE + 3], in_precision({"corr_fwd_wide": 1}, mode),
                               "bf16_act DispNet fused NONE serving", model_name="Dispnet"))
            if session.last_disp.dtype != torch.bfloat16:
                raise AssertionError(f"DispNet fused serving under bf16_act: {session.last_disp.dtype}")
            assert_served(dn_state, frames, disps, "bf16_act DispNet fused NONE serving", model_name="Dispnet",
                          rtol=serve_rtol)
            del session

    check_bf16_act_against_plain(state, dn_state)
    resolve_device("cuda")
    assert_tf32("highest")
    log("precision phase done; back under highest, TF32 off")
    return launches, frame_ms


# ------------------------------------------------------------------ phase 9
# fused against host over 32 real frames: phase 6's bounds carry 20 frames;
# three H100 runs read 1.0e-5, 2.3e-5 and 7.5e-5 of the loss over 32
CLI_TRAJ_LOSS_RTOL = 3 * TRAJ_LOSS_RTOL
CLI_TRAJ_EPE_RTOL = TRAJ_EPE_RTOL
STATS_LINES = ("Metrics,cumulative,average", "EPE,", "bad3,", "time,", "FPS,", "#resets,", "Blocks", "fetch_counter")


def cli_launches(run: str, i: int, n_blocks: int = 5):
    """What frame (or, for ``evaluate``, batch) ``i`` of a phase-9 run must
    launch: MADNet on the default route (``cuda`` warps, K2-K5)."""
    if run == "evaluate":
        return {"corr_fwd": 5, "warp_features_fwd": 4}  # one launch takes the batch; no loss
    if run == "NONE":
        return dict(FWD)
    if run == "FULL":
        return {**FWD, "corr_bwd": 5, "warp_image_bwd": 1, "warp_features_bwd": 4}
    k = i % n_blocks  # MAD, SEQUENTIAL, with the bulkhead
    return {"corr_fwd": 5, "warp_image_fwd": 2, "warp_features_fwd": 4,
            "corr_bwd": 1, "warp_image_bwd": 1, "warp_features_bwd": 0 if k == 0 else 1}


def check_cli_outputs(out: Path, n: int, what: str):
    """stats.csv and series.csv in the JAX CLI's format, ``n`` frames,
    finite metrics."""
    stats = (out / "stats.csv").read_text().splitlines()
    for line, head in zip(stats, STATS_LINES):
        if not line.startswith(head):
            raise AssertionError(f"{what}: stats.csv line {line!r}, want {head!r}...")
    series = (out / "series.csv").read_text().strip().splitlines()
    if series[0] != "Iteration,Time,EPE,bad3" or len(series) != n + 1:
        raise AssertionError(f"{what}: series.csv has {len(series) - 1} frames, want {n}")
    rows = np.array([[float(v) for v in line.split(",")] for line in series[1:]])
    if rows[:, 0].tolist() != list(range(n)) or not np.isfinite(rows).all():
        raise AssertionError(f"{what}: series.csv {rows}")


def check_drift(what, drift_d1, jax_drift_d1):
    """A precision mode's D1 less ``highest``'s. The promotion bound holds
    the port wherever the JAX package meets it on the same frames (its
    drift, on the CPU, is ``jax_drift_d1``: for ``evaluate`` with every
    bf16 rounding kept); where the reference misses it too, the miss is the
    mode's, and the run is held to the reference in that mode instead
    (:func:`against_reference`, already passed)."""
    met = abs(drift_d1) <= CLI_DRIFT_BOUND
    log(f"cli {what}: D1 {drift_d1:+.4f} points from highest ({'within' if met else 'OUTSIDE'} the "
        f"promotion bound {CLI_DRIFT_BOUND}); the JAX package's in this mode {jax_drift_d1:+.4f}")
    if abs(jax_drift_d1) <= CLI_DRIFT_BOUND and not met:
        raise AssertionError(f"{what}: D1 drifts {drift_d1} points from highest, the JAX package {jax_drift_d1}")


def counted_run(tag, fn, per, what_launches, launches):
    """``fn()`` with the launch counters set to 0 just before and read just
    after: they must sum ``what_launches(i)`` over ``i < per`` (a frame, a
    batch or a step each), and go into ``launches[tag]``. Returns (the
    result of ``fn``, its wall time in s)."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    result = fn()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    want = {}
    for i in range(per):
        for k, v in what_launches(i).items():
            want[k] = want.get(k, 0) + v
    want = {k: v for k, v in want.items() if v}
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, want {want}")
    launches[tag] = dict(cuda_lib.LAUNCHES)
    return result, wall


def against_jax_cli(what, ref_name, result, ref):
    """A run's average D1 within CLI_D1_BOUND points of the JAX CLI's row
    ``ref`` (``tests/fixtures/torch_cli_reference.json``) over CLI_FRAMES."""
    delta = result["avg_d1"] - ref["avg_d1"]
    line = (f"{what} against the JAX CLI on the CPU ({ref_name}): D1 {result['avg_d1']:.3f} vs {ref['avg_d1']:.3f} "
            f"(delta {delta:+.4f}, bound {CLI_D1_BOUND}); EPE {result['avg_epe']:.4f} vs {ref['avg_epe']:.4f}")
    if "avg_bad3" in result and "avg_bad3" in ref:
        line += f"; bad3 {100 * result['avg_bad3']:.3f}% vs {100 * ref['avg_bad3']:.3f}%"
    log(line)
    if ref["frames"] != CLI_FRAMES or not abs(delta) <= CLI_D1_BOUND:
        raise AssertionError(f"{what}: D1 {result['avg_d1']} against the JAX CLI's {ref['avg_d1']}")


def first_last(series, k=8):
    return float(np.mean(series[:k])), float(np.mean(series[-k:]))


def check_loader(frame_ms):
    """The native loader on the card: its build, route and workers printed;
    it must build (the Python backend would hide it). Then 32 frames of
    phase 9's list at 320x1216 through it and through the Python backend:
    bit for bit, each backend's frames/s printed; and ``auto`` takes it."""
    import tempfile

    from real_time_self_adaptive_deep_stereo_torch.data.readers import StereoDataset
    from real_time_self_adaptive_deep_stereo_torch.runtime import native

    t0 = time.perf_counter()
    ok = native.available()
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = write_cli_list(tmp, CLI_SCENES["scene"], CLI_FRAMES)
        kw = dict(batch_size=1, crop_shape=(H, W), num_epochs=1, is_training=False, shuffle=False)
        auto = StereoDataset(path, **kw)
        log(f"native loader: available {ok}, build_error {native.build_error()!r}, route {native.route()!r}, "
            f"num_workers {auto.num_workers} ({max(2, auto.num_workers)} threads), 8 frames ahead; "
            f"build and load {build_s:.2f} s")
        if not ok:
            raise AssertionError(f"the native loader did not build on the card: {native.build_error()}")
        if auto.backend != "native":
            raise AssertionError(f"StereoDataset(backend='auto') took {auto.backend!r}")
        decoded = {}
        for backend in ("native", "python"):
            t0 = time.perf_counter()
            decoded[backend] = list(StereoDataset(path, backend=backend, **kw))
            frame_ms[f"LOADER_{backend.upper()}_FRAME"] = (time.perf_counter() - t0) * 1e3 / CLI_FRAMES
        for a, b in zip(decoded["native"], decoded["python"]):
            for k in ("left", "right", "target"):
                if not np.array_equal(a[k], b[k]):
                    raise AssertionError(f"native loader: {k} differs from the Python backend's")
        if len(decoded["native"]) != CLI_FRAMES:
            raise AssertionError(f"native loader: {len(decoded['native'])} frames, want {CLI_FRAMES}")
    log(f"native loader: {CLI_FRAMES} frames at {H}x{W} (left, right, 16-bit gt) bit for bit equal to the Python "
        f"backend's; {1e3 / frame_ms['LOADER_NATIVE_FRAME']:.1f} frames/s "
        f"({frame_ms['LOADER_NATIVE_FRAME']:.2f} ms a frame) against the Python backend's "
        f"{1e3 / frame_ms['LOADER_PYTHON_FRAME']:.1f} ({frame_ms['LOADER_PYTHON_FRAME']:.2f} ms)")


def run_cli_phase(state, profile_dir):
    """Phase 9: the ``adapt`` and ``evaluate`` CLIs (``main``, in-process)
    on the real frames of ``tests/fixtures/realworld`` at 320x1216, from
    ``weights_scene01.npz``, against the JAX package's CLIs
    (``tests/fixtures/torch_cli_reference.json``, made on the CPU by
    ``tools/torch_cli_reference.py``). Returns (launches by path, ms/frame
    by path)."""
    from real_time_self_adaptive_deep_stereo_torch.cli import adapt as adapt_cli
    from real_time_self_adaptive_deep_stereo_torch.cli import evaluate as eval_cli
    from real_time_self_adaptive_deep_stereo_torch.data.png import read_png, read_pngs

    del state, profile_dir  # the fixture's trained weights; nothing profiled
    doc = json.loads(CLI_REFERENCE.read_text())
    reference, witness = doc["runs"], (doc["strict_runs"], doc["port_cpu_runs"])
    launches, frame_ms = {}, {}
    check_loader(frame_ms)  # the CLIs below decode through it

    # PNG decoding on this host: a frame's three PNGs in one sweep, and one RGB image alone
    frame_pngs = [str(FIXTURE_DIR / f"scene2_{k}.png") for k in ("left", "right", "gt")]
    sweep_ms, one_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        read_pngs(frame_pngs)
        sweep_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        read_png(frame_pngs[0])
        one_ms.append((time.perf_counter() - t0) * 1e3)
    decode_ms = statistics.median(sweep_ms)
    log(f"PNG decode on this host: {decode_ms:.1f} ms a frame (left, right, gt in one sweep; "
        f"runs {np.round(sweep_ms, 1).tolist()}), {statistics.median(one_ms):.1f} ms one 320x1216 RGB image")
    frame_ms["CLI_PNG_DECODE_FRAME"] = decode_ms

    captured = {}
    write_stats = adapt_cli.write_stats

    def capture(output, stats):  # the per-frame series of a run, as the CLI hands them over
        captured["stats"] = stats
        write_stats(output, stats)

    adapt_cli.write_stats = capture  # evaluate imports it from cli.adapt when it runs
    try:
        launches, frame_ms = cli_runs(adapt_cli, eval_cli, reference, witness, captured, launches, frame_ms)
    finally:
        adapt_cli.write_stats = write_stats
    log("cli phase done; back under highest, TF32 off")
    return launches, frame_ms


def cli_runs(adapt_cli, eval_cli, reference, witness, captured, launches, frame_ms):
    """Phase 9's runs (see :func:`run_cli_phase`)."""
    import tempfile

    from real_time_self_adaptive_deep_stereo_torch.data.png import read_pngs
    from real_time_self_adaptive_deep_stereo_torch.ops import conv_precision, set_conv_precision
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import (
        load_params,
        params_from_jax,
        save_params,
    )
    from real_time_self_adaptive_deep_stereo_torch.utils.device import resolve_device

    strict, port_cpu = witness
    d1 = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        lists = {k: write_cli_list(tmp, scenes, CLI_FRAMES) for k, scenes in CLI_SCENES.items()}

        def run(tag, module, argv, n, per, what_launches):
            out = tmp / tag
            args = module.build_argparser().parse_args(["-o", str(out)] + argv)
            captured.clear()
            result, wall = counted_run(tag, lambda: module.main(args), per, what_launches, launches)
            counts = {k: v for k, v in launches[tag].items() if v}
            check_cli_outputs(out, n, tag)
            stats = captured["stats"]
            series = {k: np.asarray(getattr(stats, k), np.float64) for k in ("epe", "bad3", "d1")}
            if len(series["d1"]) != n or not all(np.isfinite(v).all() for v in series.values()):
                raise AssertionError(f"{tag}: {n} frames of finite metrics wanted, got {series}")
            if abs(result["avg_d1"] - float(series["d1"].mean())) > 1e-5:  # float32 means
                raise AssertionError(f"{tag}: the returned D1 is not the frames' mean")
            d1[tag] = result["avg_d1"]
            frame_ms[tag] = wall * 1e3 / n
            line = (f"cli {tag}: {n} frames, EPE {result['avg_epe']:.4f} bad3 {100 * result['avg_bad3']:.3f}% "
                    f"D1 {result['avg_d1']:.3f}% resets {result.get('resets', 0)}; wall {wall * 1e3 / n:.2f} "
                    f"ms/frame with reading and set-up, the CLI's own time "
                    f"{stats.exec_time * 1e3 / max(stats.steps, 1):.2f} ms/frame; launches {counts}")
            log(line)
            if "_MAD" in tag or "_FULL" in tag:
                for k in ("epe", "bad3", "d1"):
                    scale = 100.0 if k == "bad3" else 1.0
                    a, b = first_last(series[k])
                    log(f"cli {tag}: {k} first 8 frames {scale * a:.4f}, last 8 {scale * b:.4f}")
            return result, stats

        def against_reference(tag, ref_name, result):
            against_jax_cli(f"cli {tag}", ref_name, result, reference[ref_name])

        def against_witness(tag, ref_name, result):
            """The JAX CLI with every bf16 rounding of the mode kept, and the
            port's own evaluate on the CPU (tools/torch_cli_reference.py --strict)."""
            got, want, cpu = result["avg_d1"], strict[ref_name]["avg_d1"], port_cpu[ref_name]["avg_d1"]
            log(f"cli {tag} against the JAX CLI with the mode's roundings kept: D1 {got:.3f} vs {want:.3f} "
                f"(delta {got - want:+.4f}, bound {CLI_WITNESS_BOUND}); the port on the CPU {cpu:.3f} "
                f"(delta {got - cpu:+.4f})")
            if strict[ref_name]["frames"] != CLI_FRAMES or not abs(got - want) <= CLI_WITNESS_BOUND:
                raise AssertionError(f"{tag}: D1 {got} against the strict JAX CLI's {want}")

        def adapt_argv(scenes, mode, *extra):
            return ["-l", lists[scenes], "--weights", str(CLI_WEIGHTS), "--modelName", "MADNet",
                    "--blockConfig", str(ROOT / "block_config" / "MadNet_full.json"), "--mode", mode,
                    *CLI_FLAGS, *extra]

        n = CLI_FRAMES
        for scenes in ("scene", "asym"):
            modes = [("NONE", "fused"), ("MAD", "fused")] + (
                [("MAD", "host")] if scenes == "scene" else [("FULL", "fused")])
            runs = {}
            for mode, session in modes:
                tag = f"CLI_ADAPT_{scenes.upper()}_{mode}_{session.upper()}"
                runs[mode, session] = run(tag, adapt_cli, adapt_argv(scenes, mode, "--sessionMode", session),
                                          n, n, lambda i, mode=mode: cli_launches(mode, i))
                against_reference(tag, f"adapt_{scenes}_{mode}", runs[mode, session][0])
            if scenes == "scene":
                fused, host = runs["MAD", "fused"][1], runs["MAD", "host"][1]
                assert_trajectory({"loss": fused.loss, "epe": fused.epe}, {"loss": host.loss, "epe": host.epe},
                                  "cli fused MAD against host MAD", loss_rtol=CLI_TRAJ_LOSS_RTOL,
                                  epe_rtol=CLI_TRAJ_EPE_RTOL)
                if fused.fetch_counter != host.fetch_counter or fused.reset_counter != host.reset_counter:
                    raise AssertionError("cli fused MAD against host MAD: fetch counters or resets differ")
            mad = runs["MAD", "fused"][1].d1
            a, b = first_last(mad)
            log(f"cli {scenes} MAD: D1 first 8 frames {a:.3f} -> last 8 {b:.3f} "
                f"({'down' if b < a else 'NOT down'}, as the JAX package's is)")

        # evaluate in every precision mode, batch 4 (the last batch of 32 frames is full)
        eval_argv = ["-l", lists["scene"], "--weights", str(CLI_WEIGHTS), "--modelName", "MADNet",
                     "--imageShape", str(H), str(W), "--batch", str(EVAL_BATCH)]
        n_batches = -(-n // EVAL_BATCH)
        try:
            for mode in EVAL_PRECISIONS:
                tag = f"CLI_EVALUATE_{mode.upper()}"
                result, _ = run(tag, eval_cli, eval_argv + ["--precision", mode], n, n_batches,
                                lambda i, mode=mode: in_precision(cli_launches("evaluate", i), mode))
                name = "evaluate_scene" + ("" if mode == "highest" else f"_{mode}")
                against_reference(tag, name, result)
                against_witness(tag, name, result)
        finally:
            set_conv_precision("highest")
        for mode in EVAL_PRECISIONS[1:]:
            check_drift(f"evaluate {mode}", d1[f"CLI_EVALUATE_{mode.upper()}"] - d1["CLI_EVALUATE_HIGHEST"],
                        strict[f"evaluate_scene_{mode}"]["avg_d1"] - strict["evaluate_scene"]["avg_d1"])

        # fused MAD under bf16_act (the adapt CLI has no precision flag)
        tag = "CLI_ADAPT_SCENE_MAD_FUSED_BF16_ACT"
        with conv_precision("bf16_act"):
            result, _ = run(tag, adapt_cli, adapt_argv("scene", "MAD", "--sessionMode", "fused"), n, n,
                            lambda i: in_precision(cli_launches("MAD", i), "bf16_act"))
        against_reference(tag, "adapt_scene_MAD_bf16_act", result)
        check_drift("adapt MAD bf16_act", d1[tag] - d1["CLI_ADAPT_SCENE_MAD_FUSED"],
                    reference["adapt_scene_MAD_bf16_act"]["avg_d1"] - reference["adapt_scene_MAD"]["avg_d1"])
        resolve_device("cuda")
        assert_tf32("highest")

        # DispNet-Corr1D, seeded weights: MAD over dispnet_full_6.json, fused and host
        dn_weights = tmp / "dispnet_seeded.npz"
        save_params(str(dn_weights), seeded_dispnet_params(1))
        dn_list = write_cli_list(tmp, CLI_SCENES["scene"], CLI_DN_FRAMES)
        dn = {}
        for session in ("fused", "host"):
            tag = f"CLI_ADAPT_DISPNET_MAD_{session.upper()}"
            argv = ["-l", dn_list, "--weights", str(dn_weights), "--modelName", "Dispnet",
                    "--blockConfig", DN_BLOCK_CONFIG, "--mode", "MAD", "--sessionMode", session, *CLI_FLAGS]
            dn[session] = run(tag, adapt_cli, argv, CLI_DN_FRAMES, CLI_DN_FRAMES,
                              lambda i: dn_launches("MAD", i % 6))[1]
        assert_trajectory({"loss": dn["fused"].loss, "epe": dn["fused"].epe},
                          {"loss": dn["host"].loss, "epe": dn["host"].epe}, "cli DispNet fused MAD against host",
                          loss_rtol=CLI_TRAJ_LOSS_RTOL, epe_rtol=CLI_TRAJ_EPE_RTOL)

        # the fused MAD session's device time on the same frames, decoded beforehand
        scenes = [read_pngs([str(FIXTURE_DIR / f"{s}_{k}.png") for k in ("left", "right", "gt")])
                  for s in CLI_SCENES["scene"]]
        frames = [{"left": torch.from_numpy(left.astype(np.float32)[None]).cuda(),
                   "right": torch.from_numpy(right.astype(np.float32)[None]).cuda(),
                   "target": torch.from_numpy((gt.astype(np.float32) / 256.0)[None, :, :, None]).cuda()}
                  for left, right, gt in scenes]
        session = make_session(params_from_jax(load_params(str(CLI_WEIGHTS))), "MAD", fused=True,
                               sample_mode="SEQUENTIAL", ssim_th=0.5)
        for i in range(5):  # a round: every branch run and captured
            session.step(frames[i % 2])
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(5, n):
            session.step(frames[i % 2])
        end.record()
        end.synchronize()
        device_ms = start.elapsed_time(end) / (n - 5)
        frame_ms["CLI_FUSED_MAD_DEVICE"] = device_ms
        log(f"cli scene MAD fused: wall {frame_ms['CLI_ADAPT_SCENE_MAD_FUSED']:.2f} ms/frame with reading "
            f"and set-up, against {device_ms:.3f} ms/frame of the same session on frames already on the card "
            f"(CUDA events over frames 5..{n - 1})")
        del session
    return launches, frame_ms


# ----------------------------------------------------------------- phase 10
TF1_FIXTURE = ROOT / "tests" / "fixtures" / "tf1_madnet_tiny"
DN_TRAIN_STEPS = 4
# a training step: MADNet without the bulkhead (both K5 gradients in one
# launch) and DispNet-Corr1D; the supervised loss warps no image
TRAIN_LAUNCHES = {"MADNet": {"corr_fwd": 5, "corr_bwd": 5, "warp_features_fwd": 4, "warp_features_bwd": 4},
                  "Dispnet": {"corr_fwd_wide": 1, "corr_bwd_wide": 1}}
# the untrained `evaluate` row the trained network is held below: the one
# metric the supervised L1 loss minimizes (see run_train_phase)
UNTRAINED_RUN = "evaluate_scene"


def continual_launches(run: str, i: int):
    """What frame ``i`` of a phase-10 continual run must launch: MADNet on
    the `cuda` warps; the proxy loss warps no image, and one forward serves
    the block loss and the full loss. MAD (SEQUENTIAL, bulkhead): block
    ``i mod 5``'s backward, one ``corr_bwd`` and one K5 (``dfeats``; none for
    block 0); FIXED 2 3: both blocks' every frame; FULL with
    ``--dilation 2``: the whole backward on even frames, none on odd ones."""
    fwd = {"corr_fwd": 5, "warp_features_fwd": 4}
    if run == "MAD":
        return {**fwd, "corr_bwd": 1, "warp_features_bwd": 0 if i % 5 == 0 else 1}
    if run == "FIXED":
        return {**fwd, "corr_bwd": 2, "warp_features_bwd": 2}
    return {**fwd, "corr_bwd": 5, "warp_features_bwd": 4} if i % 2 == 0 else fwd


def smooth_batch(seeds):
    """:func:`make_smooth_frame` of each seed, stacked into one batch on the card."""
    frames = [make_smooth_frame(s) for s in seeds]
    return {k: torch.from_numpy(np.concatenate([f[k] for f in frames])).cuda() for k in frames[0]}


def check_tf1_import():
    """The TF1 fixture (``tools/torch_tf1_fixture.py``) into MADNet on the
    card through ``restore_or_init``, read by the port's numpy reader: the
    restored count and every value bit for bit."""
    import importlib.util

    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import (
        params_from_jax,
        params_to_jax,
        restore_or_init,
        tf1_checkpoint_to_params,
    )

    ckpt = str(TF1_FIXTURE / "model.ckpt")
    model = get_stereo_net("MADNet")
    base = params_to_jax(model.state_dict())
    _, n = tf1_checkpoint_to_params(ckpt, model, base)
    params, restored, step = restore_or_init(str(TF1_FIXTURE / "no_logdir"), base, ckpt, model)
    with np.load(TF1_FIXTURE / "values.npz") as v:
        values = {k: v[k] for k in v.files}
    if not (restored and step == 0 and n == len(values) == 6):
        raise AssertionError(f"TF1 import: restored {restored} at step {step}, {n} leaves of {len(values)}")
    model.load_state_dict(params_from_jax(params))
    state = model.state_dict()
    for name, value in values.items():
        *path, leaf = model.tf_name_map()[name]
        got = state[".".join([*path, {"w": "weight", "b": "bias"}[leaf]])].cpu().numpy()
        want = value.transpose(3, 2, 0, 1) if leaf == "w" else value
        if not np.array_equal(got, want):
            raise AssertionError(f"TF1 import: {name} differs on the card")
    if "tensorflow" in sys.modules:
        raise AssertionError("TF1 import: tensorflow was imported")
    log(f"TF1 import: {n} leaves of {TF1_FIXTURE.name} into MADNet on the card, bit for bit, by the numpy "
        f"reader (python {sys.version.split()[0]}; tensorflow "
        f"{'installed' if importlib.util.find_spec('tensorflow') else 'not installed'} here, not imported)")


def check_train_step_against_plain(name, state, batch):
    """One training step's gradient from ``state`` on ``batch``, with the
    kernels (twice) and with the plain modes on the card: within STEP_RTOL
    of its largest entry; the kernels' launches are TRAIN_LAUNCHES, the
    plain modes launch none."""
    from real_time_self_adaptive_deep_stereo_torch.cli.train import MAX_DISP, loss_and_grads
    from real_time_self_adaptive_deep_stereo_torch.losses import get_supervised_loss
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    loss_fn = get_supervised_loss("mean_l1", multiScale=True, max_disp=MAX_DISP)
    runs = []
    for plain in (False, True, False):
        modes = (dict(corr_mode="torch", warp_mode="clamped") if name == "MADNet" else dict(corr_mode="torch")
                 ) if plain else {}
        model = get_stereo_net(name, **modes)
        model.load_state_dict(state)
        cuda_lib.reset_launches()
        loss, grads = loss_and_grads(model, loss_fn, batch)
        torch.cuda.synchronize()
        launched = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
        if launched != ({} if plain else TRAIN_LAUNCHES[name]):
            raise AssertionError(f"{name} training step ({'plain' if plain else 'kernels'}): launches {launched}")
        runs.append((float(loss), grads))
    (fast_loss, fast), (plain_loss, plain), (_, again) = runs
    g_scale = max(float(g.abs().max()) for g in plain)
    g_err = max(float((a - b).abs().max()) for a, b in zip(fast, plain))
    rerun = max(float((a - b).abs().max()) for a, b in zip(fast, again))
    log(f"{name} training step at B = {batch['left'].shape[0]}, kernels vs plain modes: loss {fast_loss:.6f} vs "
        f"{plain_loss:.6f}; gradient within {g_err / g_scale:.3g} of its largest entry {g_scale:.3g} (two runs "
        f"with the kernels differ by {rerun:.3g})")
    if not (g_scale > 0 and g_err <= STEP_RTOL * g_scale and math.isfinite(fast_loss)):
        raise AssertionError(f"{name} training step: kernels and plain modes disagree")


def run_train_phase(state, profile_dir):
    """Phase 10: ``cli/adapt_continual.py`` and ``cli/train.py`` (``main``,
    in-process) on the real frames of phase 9, against the JAX package's
    CLIs (``phase10_runs`` of ``tests/fixtures/torch_cli_reference.json``),
    and the TF1 import. Returns (launches by path, ms by path)."""
    import tempfile

    from real_time_self_adaptive_deep_stereo_torch.cli import adapt_continual, evaluate, train
    from real_time_self_adaptive_deep_stereo_torch.cli.train import MAX_DISP, make_train_step
    from real_time_self_adaptive_deep_stereo_torch.data.png import read_pngs
    from real_time_self_adaptive_deep_stereo_torch.losses import get_supervised_loss
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import load_params, params_from_jax, save_params

    del state  # the fixture's trained weights
    doc = json.loads(CLI_REFERENCE.read_text())
    reference, untrained = doc["phase10_runs"], doc["runs"][UNTRAINED_RUN]
    launches, ms = {}, {}
    check_tf1_import()

    def counted(tag, fn, per, what_launches):
        return counted_run(tag, fn, per, what_launches, launches)

    def against_reference(tag, ref_name, result):
        against_jax_cli(tag, ref_name, result, reference[ref_name])

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        n = CLI_FRAMES
        proxy_list = write_cli_list(tmp, CLI_SCENES["scene"], n, proxy=True)

        # continual adaptation; the sessions' stats are taken as the CLI gets them
        captured = {}
        runners = {k: getattr(adapt_continual, k) for k in ("_run_fused", "_run_host")}

        def capturing(runner):
            def run(*a):
                captured["stats"], params = runner(*a)
                return captured["stats"], params
            return run

        for k, runner in runners.items():
            setattr(adapt_continual, k, capturing(runner))
        stats = {}
        try:
            for ref_name, run, session, extra in (
                ("continual_scene_MAD", "MAD", "fused", ["--mode", "MAD", "--sampleMode", "SEQUENTIAL"]),
                ("continual_scene_MAD", "MAD", "host", ["--mode", "MAD", "--sampleMode", "SEQUENTIAL"]),
                ("continual_scene_FIXED_2_3", "FIXED", "fused",
                 ["--mode", "MAD", "--sampleMode", "FIXED", "--fixedID", "2", "3"]),
                ("continual_scene_FULL_dilation2", "FULL", "fused", ["--mode", "FULL", "--dilation", "2"]),
            ):
                tag = f"CONTINUAL_{run}_{session.upper()}"
                out = tmp / tag
                argv = ["-l", proxy_list, "-o", str(out), "--weights", str(CLI_WEIGHTS), "--modelName", "MADNet",
                        "--sessionMode", session, *CONTINUAL_FLAGS, *extra]
                args = adapt_continual.build_argparser().parse_args(argv)
                result, wall = counted(tag, lambda: adapt_continual.main(args), n,
                                       lambda i, run=run: continual_launches(run, i))
                st = stats[tag] = captured.pop("stats")
                d1 = np.asarray(st.d1, np.float64)
                if len(d1) != n or not np.isfinite(d1).all() or abs(result["avg_d1"] - d1.mean()) > 1e-5:
                    raise AssertionError(f"{tag}: {n} frames of finite D1 wanted, got {st.d1}")
                for f in ("overall.csv", "series.csv", "histogram.csv"):
                    if not (out / f).exists():
                        raise AssertionError(f"{tag}: no {f}")
                hist = (out / "histogram.csv").read_text().splitlines()
                ms[tag] = wall * 1e3 / n
                a, b = first_last(d1)
                log(f"{tag}: {n} frames, EPE {result['avg_epe']:.4f} D1 {result['avg_d1']:.3f}% resets "
                    f"{result['resets']}, D1 first 8 frames {a:.3f} -> last 8 {b:.3f}; fetch counter {hist[-1]}; "
                    f"wall {ms[tag]:.2f} ms/frame with reading and set-up; launches {launches[tag]}")
                against_reference(tag, ref_name, result)
                if run == "MAD" and not b < a:
                    raise AssertionError(f"{tag}: D1 did not fall ({a} -> {b})")
                if run == "FIXED" and hist[-1] != str([0, 0, n, n, 0]):
                    raise AssertionError(f"{tag}: fetched {hist[-1]}, want blocks 2 and 3 only")
        finally:
            for k, runner in runners.items():
                setattr(adapt_continual, k, runner)
        fused, host = stats["CONTINUAL_MAD_FUSED"], stats["CONTINUAL_MAD_HOST"]
        assert_trajectory({"loss": fused.loss, "epe": fused.epe}, {"loss": host.loss, "epe": host.epe},
                          "continual fused MAD against host MAD", loss_rtol=CLI_TRAJ_LOSS_RTOL,
                          epe_rtol=CLI_TRAJ_EPE_RTOL)

        # the fused continual MAD session's device time on frames already on the card
        scenes = [read_pngs([str(FIXTURE_DIR / f"{s}_{k}.png") for k in ("left", "right", "gt")])
                  for s in CLI_SCENES["scene"]]
        frames = []
        for left, right, gt in scenes:
            target = torch.from_numpy((gt.astype(np.float32) / 256.0)[None, :, :, None]).cuda()
            frames.append({"left": torch.from_numpy(left.astype(np.float32)[None]).cuda(),
                           "right": torch.from_numpy(right.astype(np.float32)[None]).cuda(),
                           "target": target, "proxy": target})
        weights = params_from_jax(load_params(str(CLI_WEIGHTS)))
        session = make_session(weights, "MAD", fused=True, adaptation="proxy", sample_mode="SEQUENTIAL",
                               ssim_th=0.5)
        for i in range(5):  # a round: every branch run and captured
            session.step(frames[i % 2])
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(5, n):
            session.step(frames[i % 2])
        end.record()
        end.synchronize()
        ms["CONTINUAL_FUSED_MAD_DEVICE"] = start.elapsed_time(end) / (n - 5)
        log(f"continual MAD fused: wall {ms['CONTINUAL_MAD_FUSED']:.2f} ms/frame with reading and set-up, "
            f"against {ms['CONTINUAL_FUSED_MAD_DEVICE']:.3f} ms/frame of the same session on frames already on "
            f"the card (CUDA events over frames 5..{n - 1})")
        if profile_dir:  # a round of the five blocks
            profile_frames(session, [frames[i % 2] for i in range(5)], Path(profile_dir), "continual_mad_fused")
        del session

        # training, MADNet: 8 steps of 4 frames, then evaluate its checkpoint
        train_list = write_cli_list(tmp, CLI_SCENES["scene"], n)
        out = tmp / "train"
        args = train.build_argparser().parse_args(
            ["--trainingSet", train_list, "-o", str(out), "--weights", str(CLI_WEIGHTS), "--modelName", "MADNet",
             *TRAIN_FLAGS])
        trained, wall = counted("TRAIN_MADNET", lambda: train.main(args), TRAIN_STEPS,
                                lambda i: TRAIN_LAUNCHES["MADNet"])
        ms["TRAIN_MADNET_STEP"] = wall * 1e3 / TRAIN_STEPS
        ref = reference["train_evaluate_scene"]
        log(f"train MADNet: {trained['steps']} steps of 4 frames, step 0's loss {trained['final_loss']:.4f} (JAX CLI "
            f"{ref['final_loss']:.4f}); wall {ms['TRAIN_MADNET_STEP']:.1f} ms/step with reading, --augment and "
            f"set-up; launches {launches['TRAIN_MADNET']}")
        if trained["steps"] != TRAIN_STEPS or not math.isfinite(trained["final_loss"]):
            raise AssertionError(f"train MADNet: {trained}")
        eval_args = evaluate.build_argparser().parse_args(
            ["-l", train_list, "-o", str(out / "eval"), "--weights", str(out / f"weights-{TRAIN_STEPS}.npz"),
             "--modelName", "MADNet", "--imageShape", str(H), str(W), "--batch", str(EVAL_BATCH),
             "--precision", "highest"])
        result, _ = counted("TRAIN_MADNET_EVALUATE", lambda: evaluate.main(eval_args), n // EVAL_BATCH,
                            lambda i: cli_launches("evaluate", i))  # sets `highest`, the mode in force
        against_reference("train then evaluate", "train_evaluate_scene", result)
        log(f"train then evaluate: EPE {result['avg_epe']:.4f} bad3 {100 * result['avg_bad3']:.3f}% D1 "
            f"{result['avg_d1']:.3f}%; untrained (JAX CLI, {UNTRAINED_RUN}) EPE {untrained['avg_epe']:.4f} D1 "
            f"{untrained['avg_d1']:.3f}%")
        if not result["avg_epe"] < untrained["avg_epe"]:
            raise AssertionError(f"train MADNet: EPE {result['avg_epe']} not below the untrained "
                                 f"{untrained['avg_epe']} on its own frames")

        # a training step's device time at B = 4, on the first four frames decoded beforehand
        batch = {k: torch.cat([frames[i % 2][k] for i in range(4)]) for k in ("left", "right", "target")}
        model = get_stereo_net("MADNet")
        model.load_state_dict(weights)
        step = make_train_step(model, get_supervised_loss("mean_l1", multiScale=True, max_disp=MAX_DISP), 1e-4)
        for _ in range(3):
            step(batch)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            step(batch)
        end.record()
        end.synchronize()
        ms["TRAIN_MADNET_STEP_DEVICE"] = start.elapsed_time(end) / 10
        log(f"train MADNet: {ms['TRAIN_MADNET_STEP_DEVICE']:.3f} ms/step at B = 4 on frames already on the card "
            f"(CUDA events over 10 steps, the host enqueueing), against {ms['TRAIN_MADNET_STEP']:.1f} ms/step of "
            f"the CLI with reading")
        if profile_dir:
            profile_frames(types.SimpleNamespace(step=step), [batch] * 3, Path(profile_dir), "train_madnet_b4")
        del model, step
        check_train_step_against_plain("MADNet", weights, smooth_batch((20, 21, 22, 23)))

        # training, DispNet-Corr1D: 4 steps from seeded weights
        dn_weights = tmp / "dispnet_seeded.npz"
        dn_tree = seeded_dispnet_params(1)
        save_params(str(dn_weights), dn_tree)
        args = train.build_argparser().parse_args(
            ["--trainingSet", train_list, "-o", str(tmp / "train_dn"), "--weights", str(dn_weights),
             "--modelName", "Dispnet", "--maxSteps", str(DN_TRAIN_STEPS), *TRAIN_FLAGS])
        trained, wall = counted("TRAIN_DISPNET", lambda: train.main(args), DN_TRAIN_STEPS,
                                lambda i: TRAIN_LAUNCHES["Dispnet"])
        ms["TRAIN_DISPNET_STEP"] = wall * 1e3 / DN_TRAIN_STEPS
        log(f"train DispNet-Corr1D: {trained['steps']} steps of 4 frames, step 0's loss {trained['final_loss']:.4f}; "
            f"wall {ms['TRAIN_DISPNET_STEP']:.1f} ms/step; launches {launches['TRAIN_DISPNET']}")
        if trained["steps"] != DN_TRAIN_STEPS or not math.isfinite(trained["final_loss"]):
            raise AssertionError(f"train DispNet: {trained}")
        check_train_step_against_plain("Dispnet", params_from_jax(dn_tree), smooth_batch((24, 25, 26, 27)))
    log("phase 10 done")
    return launches, ms


# ----------------------------------------------------------------- phase 11
def run_demo(tag, argv, n, launches):
    """``cli/demo.py``'s ``main`` on ``argv`` with the launch counters set to
    0 just before and read just after; the frame loop (``RealTimeStereo``)
    is kept as ``main`` builds it. Returns (the worker, its FPS, wall s)."""
    from real_time_self_adaptive_deep_stereo_torch.cli import demo
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    captured = {}
    base = demo.RealTimeStereo

    class Kept(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            captured["worker"] = self

    demo.RealTimeStereo = Kept
    try:
        args = demo.build_argparser().parse_args(argv)
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        fps = demo.main(args)
        wall = time.perf_counter() - t0
    finally:
        demo.RealTimeStereo = base
    worker = captured["worker"]
    if hasattr(worker.session, "sync_launches"):
        worker.session.sync_launches()  # a switched session's branches, counted on the device
    launches[tag] = dict(cuda_lib.LAUNCHES)
    out = Path(args.outDir)
    names = sorted(f.name for f in out.iterdir())
    if names != [f"disparity_{i:05d}.png" for i in range(1, n + 1)] or len(worker.frame_times) != n:
        raise AssertionError(f"{tag}: {len(worker.frame_times)} frames gave {names}, want {n} PNGs")
    return worker, fps, wall


def check_demo_launches(tag, worker, n, per_frame, launched):
    """The run's launches ``launched`` are the sum of ``per_frame(block)`` over the
    frames, the blocks as the session counted them; each captured graph
    holds its branch's frame; Adam's step count on the device advanced once
    a training frame."""
    session = worker.session
    fused = hasattr(session, "graph_launches")
    fetched = session.fetch_counter.cpu().tolist() if fused else list(session.stats.fetch_counter)
    blocks = [k for k, c in enumerate(fetched) for _ in range(c)] or [None] * n
    want = {}
    for k in blocks:
        for name, v in per_frame(k).items():
            want[name] = want.get(name, 0) + v
    counts = {k: v for k, v in launched.items() if v}
    if counts != {k: v for k, v in want.items() if v} or len(blocks) != n:
        raise AssertionError(f"{tag}: launches {counts}, want {want} (blocks fetched {fetched})")
    if fused:
        for branch, got in session.graph_launches.items():
            want = per_frame(branch[1][0] if branch[0] == "mad" else None)
            if got != {k: v for k, v in want.items() if v and k != "graph_switch"}:
                raise AssertionError(f"{tag}: graph {branch} holds {got}")
        t = int(session.opt["t"].item())
        if t != n:
            raise AssertionError(f"{tag}: Adam's step count {t} after {n} training frames")
    return fetched


def run_demo_phase(state, profile_dir):
    """Phase 11: ``cli/demo.py`` headless (``--camera folder --display
    none``), MADNet, ``MadNet_full.json``, from ``weights_scene01.npz``, on
    the real frames of phase 9. Returns (launches by path, ms by path)."""
    import tempfile

    del state, profile_dir  # the fixture's trained weights; nothing profiled
    reference = json.loads(CLI_REFERENCE.read_text())["demo_runs"]
    launches, ms = {}, {}
    full = cli_launches("FULL", 0)
    mad = lambda k: cli_launches("MAD", k)  # noqa: E731  (MADNet with the bulkhead, `cuda` warps)
    switched = lambda k: {**mad(k), "graph_switch": 1}  # noqa: E731  (PROBABILITY: the device picks k)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        lst = write_cli_list(tmp, CLI_SCENES["scene"], DEMO_FRAMES)

        def demo(tag, extra, n, per_frame, record=True):
            argv = [*DEMO_FLAGS, "--list", lst, "--outDir", str(tmp / tag), "--maxFrames", str(n), *extra]
            counted = {}
            worker, fps, wall = run_demo(tag, argv, n, counted)
            fetched = check_demo_launches(tag, worker, n, per_frame, counted[tag])
            if not record:  # another starting point of a recorded run: checked, not printed
                return worker
            launches.update(counted)
            ms[f"{tag}_FRAME"] = 1e3 / float(fps)
            ms[f"{tag}_FRAME_MEDIAN"] = 1e3 * statistics.median(worker.frame_times)
            ms[f"{tag}_BETWEEN_FRAMES"] = worker.timer.avg_ms
            log(f"{tag}: {n} frames, {n} PNGs; worker.fps {fps:.2f} ({1e3 / fps:.2f} ms a frame after the first 3, "
                f"the rescale, crop, step and fetch; median {ms[f'{tag}_FRAME_MEDIAN']:.2f} ms), StepTimer avg_ms "
                f"{worker.timer.avg_ms:.2f} between frames "
                f"({worker.timer.fps:.2f} FPS, the grabber's decode included); wall {wall:.2f} s with set-up; "
                f"blocks fetched {fetched}; launches {({k: v for k, v in counted[tag].items() if v})}")
            return worker

        # (a) the defaults: 480x640 rescaled, 320x512 cropped, MAD, PROBABILITY, fused
        worker = demo("DEMO_DEFAULTS_MAD_FUSED", [], DEMO_FRAMES, switched)
        if worker.session.disp_dtype != torch.float16 or worker.session.compute_metrics:
            raise AssertionError("demo: the fused session must serve fp16 disparities without metrics")

        # (b) the full width, SEQUENTIAL, against the JAX demo; fused, then
        # host, each from the DEMO_SEEDS starting points of the JAX rows
        flags = DEMO_REFERENCE_RUNS["demo_scene_MAD"]
        ref = reference["demo_scene_MAD"]
        rows = ref["seeds"]
        if ref["frames"] != DEMO_FRAMES or [r["seed"] for r in rows] != list(range(DEMO_SEEDS)):
            raise AssertionError(f"demo: the JAX rows hold {ref['frames']} frames, seeds {[r['seed'] for r in rows]}")
        weights = [perturbed_weights(seed, tmp) for seed in range(DEMO_SEEDS)]
        jax_d1 = np.asarray([r["avg_d1"] for r in rows])
        early = slice(0, DEMO_EARLY_FRAMES)
        metrics = {}
        for session in ("fused", "host"):
            tag = f"DEMO_FULLWIDTH_MAD_{session.upper()}"
            epes, d1s = [], []
            for seed, row in enumerate(rows):
                run = tag if seed == 0 else f"{tag}_SEED{seed}"
                demo(run, [*flags, "--sessionMode", session, "--weights", weights[seed]], DEMO_FRAMES, mad,
                     record=seed == 0)
                _, epe, d1 = demo_png_metrics(tmp / run, lst)
                early_delta = float(np.max(np.abs(d1[early] - np.asarray(row["d1"])[early])))
                log(f"{tag} seed {seed} against the JAX demo's from the same weights: the first "
                    f"{DEMO_EARLY_FRAMES} frames within {early_delta:.4f} D1 a frame (bound {CLI_D1_BOUND}); "
                    f"D1 {d1.mean():.3f} vs {row['avg_d1']:.3f}, EPE {epe.mean():.4f} vs {row['avg_epe']:.4f}; "
                    f"per frame less the JAX demo's {np.round(d1 - np.asarray(row['d1']), 3).tolist()}")
                if not early_delta <= CLI_D1_BOUND:
                    raise AssertionError(f"{run}: D1 {d1.tolist()} against the JAX demo's {row['d1']}")
                epes.append(epe)
                d1s.append(d1)
            metrics[session] = (np.asarray(epes), np.asarray(d1s))
            port_d1 = metrics[session][1].mean(axis=1)
            delta = float(port_d1.mean() - jax_d1.mean())
            log(f"{tag} against the JAX demo (demo_scene_MAD, host, CPU) over {DEMO_SEEDS} starting points: mean "
                f"D1 {port_d1.mean():.3f} vs {jax_d1.mean():.3f} (delta {delta:+.4f}, bound {DEMO_D1_BOUND}); "
                f"median {np.median(port_d1):.3f} vs {np.median(jax_d1):.3f}; D1 by seed "
                f"{np.round(port_d1, 3).tolist()} against {np.round(jax_d1, 3).tolist()}")
            if not abs(delta) <= DEMO_D1_BOUND:
                raise AssertionError(f"{tag}: mean D1 by seed {port_d1.tolist()} against the JAX demo's "
                                     f"{jax_d1.tolist()}")
        (fe, fd), (he, hd) = metrics["fused"], metrics["host"]
        epe_err = float(np.max(np.abs(fe[:, early] - he[:, early]) / he[:, early]))
        d1_delta = float(fd.mean() - hd.mean())
        log(f"demo full width, fused (fp16 disparity) against host from the same weights: EPE within {epe_err:.3g} "
            f"relative a frame over the first {DEMO_EARLY_FRAMES} (bound {CLI_TRAJ_EPE_RTOL}), "
            f"{float(np.max(np.abs(fe - he) / he)):.3g} over all {DEMO_FRAMES}; mean D1 over the {DEMO_SEEDS} "
            f"starting points {fd.mean():.3f} vs {hd.mean():.3f} (delta {d1_delta:+.4f}, bound {DEMO_D1_BOUND})")
        if not (epe_err <= CLI_TRAJ_EPE_RTOL and abs(d1_delta) <= DEMO_D1_BOUND):
            raise AssertionError("demo full width: fused and host disagree")

        # (c) FULL, fused, at the defaults' shape
        demo("DEMO_DEFAULTS_FULL_FUSED", ["--mode", "FULL"], DEMO_FULL_FRAMES, lambda k: full)
    log("phase 11 done")
    return launches, ms


# ----------------------------------------------------------------- phase 12
STREAM_COUNTS = (2, 4)
STREAM_IMPLS = ("map", "unroll")
N_FRAMES_STREAMS = 12  # a round of the five blocks (eager steps and captures), then 7 replayed
N_FRAMES_STREAMS_PROB = 30  # at N = 4, more tuples of the streams' blocks than the graphs allowed
DP_WORLD = 2
DP_BATCH = 4  # two a rank
DP_STEPS = 3
DP_TIMED_STEPS = 5
# the share of each sample's ground truth set to 0: the halves' valid counts differ
DP_ZERO_SHARE = (0.05, 0.1, 0.5, 0.7)
DP_LOSS_RTOL = 1e-5
# of the largest entry, against one process over the ranks' halves of the
# batch with the kernels (the collectives); against it with the plain
# modes, STEP_RTOL (phase 10's bound of kernels against plain modes). The
# whole batch in one process is printed beside them, not bounded: cuDNN
# picks its algorithms by batch size, and its gradient of a batch of 4 and
# the sum of its halves' differed by 2.4e-5 to 3.2e-4 of the largest entry
# on an H100, its deterministic algorithms too, and by 1.5e-5 with cuDNN
# off; tests/test_torch_parallel.py holds the step to the JAX step on the
# whole batch at 1e-5, on the CPU
DP_GRAD_RTOL = 1e-5
DP_CLI_STEPS = 2
DP_CLI_LOSS_RTOL = 1e-4
# Adam's steps compared where, at every step, Adam's first moment (its
# step's numerator) exceeds DP_MOVED of its largest entry, at the tolerance
# of the JAX package's own test (tests/test_parallel.py). Adam's step is
# about lr * m / |m|: where m is float32 noise, or nearly cancels at a later
# step (0.9 m + 0.1 g with g against m), two correct runs step apart by up
# to 2*lr. After one step m is 0.1 of the gradient: the gradient's own mask
DP_WEIGHT_TOL = dict(rtol=1e-3, atol=1e-6)
DP_MOVED = 1e-3
DP_JOIN_S = 300  # a rank's time limit


def stream_frames(n_streams: int, n: int, seed: int):
    """``n`` smooth frames of each stream (stream s from seed ``seed + 100 s``)."""
    return [smooth_frames(n, seed + 100 * s) for s in range(n_streams)]


def stacked(per, n_streams: int):
    """Frame i of the first ``n_streams`` streams on a leading stream axis."""
    return [{k: np.stack([per[s][i][k] for s in range(n_streams)]) for k in per[0][i]} for i in range(len(per[0]))]


def events_ms(run, n: int, sync_error: bool = False):
    """(device ms, wall ms) per call of ``run(i)`` for i < n: CUDA events
    around the calls, and the host's clock to the last event; with
    ``sync_error`` every host sync in the calls raises."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    if sync_error:
        torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(n):
            run(i)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n, (time.perf_counter() - t0) * 1e3 / n


def check_stream(tag, flats, s, stats, ref, ref_flat, ref_flat0):
    """Stream ``s`` of a multi-stream session (its statistics ``stats``,
    its ``[N, P]`` weights ``flats``) against a single-stream session over
    its frames: phase 6's bounds of a replayed session against the eager
    one."""
    one = {k: stats[k][s] for k in ("loss", "epe", "fetch_counter", "scores")}
    assert_trajectory(one, ref, f"{tag} stream {s} against a single-stream session")
    assert_controller(one, ref, f"{tag} stream {s} against a single-stream session")
    moved = float((ref_flat - ref_flat0).abs().max())
    err = float((flats[s] - ref_flat).abs().max())
    log(f"{tag} stream {s}: weights differ by {err:.3g} of {moved:.3g} moved")
    if not (moved > 0 and err <= 1e-2 * moved):
        raise AssertionError(f"{tag} stream {s}: adapted weights differ from the single-stream session's")


def memory_base():
    """(allocated, reserved) bytes on the card once what earlier sessions
    left is freed; the peak statistics start again from here."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def memory_peak(base) -> str:
    """Peak allocated and reserved (the CUDA graphs' pools) above ``base``."""
    return (f"peak memory {(torch.cuda.max_memory_allocated() - base[0]) / 2**20:.1f} MiB allocated, "
            f"{(torch.cuda.max_memory_reserved() - base[1]) / 2**20:.1f} reserved above the "
            f"{base[0] / 2**20:.1f} allocated before")


def run_streams(state):
    """Phase 12 (a): multi-stream fused MAD sessions, N = 2 and 4, "map"
    and "unroll", against single-stream sessions over each stream's
    frames. cuDNN runs its deterministic algorithms throughout: the
    default ones sum the weight gradient in a varying order, and over 12
    frames two runs of one session then part by up to 1.1e-4 of the loss
    on some frames (measured on an H100), which would hide what the
    streams themselves do. Returns (launches by path, ms by path)."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return streams_in(state)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def streams_in(state):
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    launches, ms = {}, {}
    n_max = max(STREAM_COUNTS)
    per = stream_frames(n_max, N_FRAMES_STREAMS, 300)

    # the references: a single-stream session (seed 0) per stream, stepped in turn
    base = memory_base()
    singles = [make_session(state, "MAD", warp="mxu", fused=True, **MAD_KW) for _ in range(n_max)]
    n_blocks = len(singles[0].engine.blocks)
    for i in range(n_blocks):
        for s, single in enumerate(singles):
            single.step(per[s][i])
    single_ms = events_ms(lambda i: [sg.step(per[s][n_blocks + i]) for s, sg in enumerate(singles)],
                          N_FRAMES_STREAMS - n_blocks)
    log(f"{n_max} single-stream sessions in turn: {single_ms[0]:.3f} ms of device time a frame-batch "
        f"({single_ms[1]:.3f} wall), {memory_peak(base)}")
    refs = [(sg.finalize(), sg.arena.flat.clone(), sg.arena.flat0) for sg in singles]
    for n in STREAM_COUNTS:  # the first n of them in turn, for the timing only
        ms[f"SINGLES_IN_TURN_{n}_DEVICE"], ms[f"SINGLES_IN_TURN_{n}_WALL"] = events_ms(
            lambda i, n=n: [sg.step(per[s][n_blocks + i]) for s, sg in enumerate(singles[:n])],
            N_FRAMES_STREAMS - n_blocks)
    del singles

    for n in STREAM_COUNTS:
        frames = stacked(per, n)
        for impl in STREAM_IMPLS:
            tag = f"STREAMS_{n}_{impl.upper()}"
            base = memory_base()
            session = make_session(state, "MAD", warp="mxu", fused=True, num_streams=n, stream_impl=impl,
                                   **{**MAD_KW, "seed": [0] * n})
            if not session.use_graphs:
                raise AssertionError(f"{tag}: the session must replay graphs on the card")

            def per_batch(i):
                return {k: n * v for k, v in mad_tile_launches(i % n_blocks).items()}

            cuda_lib.reset_launches()
            first = []
            for i in range(n_blocks):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step_counted(session, frames[i], per_batch(i), f"{tag} frame-batch {i}")
                torch.cuda.synchronize()
                first.append((time.perf_counter() - t0) * 1e3)
            if impl == "map":
                want = {(s, ("mad", (k,))): {c: v for c, v in mad_tile_launches(k).items() if v}
                        for s in range(n) for k in range(n_blocks)}
            else:
                want = {(("mad", (k,)),) * n: {c: v for c, v in per_batch(k).items() if v} for k in range(n_blocks)}
            if session.graph_launches != want:
                raise AssertionError(f"{tag}: graphs hold {session.graph_launches}, want {want}")
            dev, wall = events_ms(lambda i: session.step(frames[n_blocks + i]), N_FRAMES_STREAMS - n_blocks,
                                  sync_error=True)
            total = dict.fromkeys(cuda_lib.LAUNCHES, 0)
            for i in range(N_FRAMES_STREAMS):
                for k, v in per_batch(i).items():
                    total[k] += v
            if dict(cuda_lib.LAUNCHES) != total:
                raise AssertionError(f"{tag}: launches {dict(cuda_lib.LAUNCHES)}, want {total}")
            launches[tag] = dict(cuda_lib.LAUNCHES)
            peak = memory_peak(base)
            stats = session.finalize()
            if stats["steps"] != N_FRAMES_STREAMS or stats["loss"].shape != (n, N_FRAMES_STREAMS) or (
                stats["reset_count"] != 0
            ).any():
                raise AssertionError(f"{tag}: {stats['steps']} steps, loss {stats['loss'].shape}, "
                                     f"resets {stats['reset_count']}")
            for s in range(n):
                check_stream(tag, session.arena.flat, s, stats, *refs[s])
            ms[f"{tag}_BATCH_DEVICE"], ms[f"{tag}_BATCH_WALL"] = dev, wall
            ms[f"{tag}_FRAME_DEVICE"], ms[f"{tag}_FRAME_WALL"] = dev / n, wall / n
            log(f"{tag}: {len(session._graphs)} graphs captured; launches a frame-batch {per_batch(1)} "
                f"(K1 {per_batch(1)['corr_fwd']}); first round (eager steps and captures) ms {first}; steady "
                f"{dev:.3f} ms of device time a frame-batch, {dev / n:.3f} a frame ({wall:.3f} and "
                f"{wall / n:.3f} wall), with every host sync an error; {n} single-stream sessions in turn "
                f"{ms[f'SINGLES_IN_TURN_{n}_DEVICE']:.3f} ({ms[f'SINGLES_IN_TURN_{n}_WALL']:.3f} wall) a "
                f"frame-batch; {peak}")
            del session

    # PROBABILITY at N = 4, seeds [0, 1, 2, 3]: each stream follows the
    # single session with its seed; the streams' branches differ, the device
    # picks each (under "map" and "unroll" alike one parent of N switches:
    # one launch a frame-batch, N switch kernels), and the graphs stay
    # bounded, one a (stream, block), where one a tuple of the streams'
    # blocks would grow towards n_blocks ** N
    per = stream_frames(n_max, N_FRAMES_STREAMS_PROB, 500)
    refs = []
    for s in range(n_max):
        sg = make_session(state, "MAD", warp="mxu", fused=True, sample_mode="PROBABILITY", ssim_th=1e9, seed=s)
        for f in per[s]:
            sg.step(f)
        refs.append((sg.finalize(), sg.arena.flat.clone(), sg.arena.flat0))
        del sg
    for impl in STREAM_IMPLS:
        n = n_max
        tag = f"STREAMS_{n}_{impl.upper()}_PROBABILITY"
        session = make_session(state, "MAD", warp="mxu", fused=True, num_streams=n, stream_impl=impl,
                               sample_mode="PROBABILITY", ssim_th=1e9, seed=list(range(n)))
        cuda_lib.reset_launches()
        picked = []
        for i, f in enumerate(stacked(per, n)):
            before = dict(cuda_lib.LAUNCHES)
            session.step(f)
            session.sync_launches()  # the harness's read, as is the blocks' below
            ks = [k for (k,) in session.cur_blocks.tolist()]
            # N switch kernels from one parent of N slots: one launch
            want = dict.fromkeys(cuda_lib.LAUNCHES, 0)
            want["graph_switch"] = n
            for k in ks:
                for c, v in mad_tile_launches(k).items():
                    want[c] += v
            added = {c: cuda_lib.LAUNCHES[c] - before[c] for c in cuda_lib.LAUNCHES}
            if added != want or session._switch[0].n_slots != n:
                raise AssertionError(f"{tag} frame-batch {i}: blocks {ks}, launches {added}, a parent of "
                                     f"{session._switch[0].n_slots} slots")
            picked.append(ks)
        launches[tag] = dict(cuda_lib.LAUNCHES)
        stats = session.finalize()
        tuples = len({tuple(p) for p in picked})
        most = n * n_blocks
        log(f"{tag}: blocks by frame {picked}; {len(session._graphs)} graphs captured (at most {most}; "
            f"{tuples} tuples of the streams' blocks seen); one launch a frame-batch of a parent of "
            f"{session._switch[0].n_slots} switches")
        if len(session._graphs) > most:
            raise AssertionError(f"{tag}: {len(session._graphs)} graphs, more than {most}")
        for s in range(n):
            check_stream(tag, session.arena.flat, s, stats, *refs[s])
        del session
    return launches, ms


def dp_batches(n: int, seed: int):
    """``n`` global batches of DP_BATCH smooth frames; sample i's ground
    truth with a share DP_ZERO_SHARE[i] of it set to 0."""
    r = np.random.default_rng(seed)
    out = []
    for j in range(n):
        frames = [make_smooth_frame(seed + 10 * j + i, d=8 + 2 * i) for i in range(DP_BATCH)]
        batch = {k: np.concatenate([f[k] for f in frames]) for k in frames[0]}
        for i, share in enumerate(DP_ZERO_SHARE):
            batch["target"][i][r.random((H, W, 1)) < share] = 0.0
        out.append(batch)
    return out


def flat_params(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def load_flat(model, flat) -> None:
    at = 0
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.as_tensor(flat[at : at + p.numel()]).view_as(p))
            at += p.numel()


def spawn_ranks(mode: str, workdir: Path, config: dict):
    """The DP_WORLD ranks of ``mode`` (``python3 chip_smoke.py --dp-rank R``),
    each killed after DP_JOIN_S seconds; a rank's failure fails the phase.
    Returns each rank's output."""
    (workdir / "config.json").write_text(json.dumps({"mode": mode, **config}))
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dp-rank", str(r), "--dp-dir",
                               str(workdir)], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(DP_WORLD)]
    deadline = time.monotonic() + DP_JOIN_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.strip().splitlines()[-12:]:
            log(f"  rank {r}: {line}")
        if p.returncode != 0:
            raise AssertionError(f"{mode}: rank {r} exited with {p.returncode}")
    return outs


def dp_rank_main(rank: int, workdir: Path) -> int:
    """One rank of phase 12's data-parallel runs or of phase 13's
    width-sharded ones (``--dp-rank``)."""
    import torch.distributed as dist

    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    config = json.loads((workdir / "config.json").read_text())
    device = torch.device(config["device"].format(rank=rank))
    torch.cuda.set_device(device)
    dist.init_process_group(config["backend"], init_method=f"file://{workdir / 'pg'}", rank=rank,
                            world_size=DP_WORLD)
    try:
        out = {}
        if config["mode"] == "spatial":
            out = spatial_rank(rank, workdir, device)
        elif config["mode"] == "step":
            from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
            from real_time_self_adaptive_deep_stereo_torch.parallel import (
                batch_sharded,
                make_dp_train_step,
                make_mesh,
                shard_batch,
            )

            mesh = make_mesh(device_type="cuda")
            model = get_stereo_net("MADNet", device=device, seed=100 + rank)
            if rank == 0:  # the other rank starts elsewhere: the broadcast must bring it over
                with np.load(workdir / "weights.npz") as w:
                    load_flat(model, w["flat"])
            with np.load(workdir / "batches.npz") as b:
                batches = [{k: torch.from_numpy(b[f"{j}_{k}"]).to(device) for k in ("left", "right", "target")}
                           for j in range(DP_STEPS)]
            sharding = batch_sharded(mesh)
            step = make_dp_train_step(model, mesh, lr=LR)
            cuda_lib.reset_launches()
            for j, batch in enumerate(batches):
                out[f"w{j}"] = flat_params(model).cpu().numpy()
                out[f"loss{j}"] = np.float32(float(step(shard_batch(batch, sharding))))
                out[f"g{j}"] = torch.cat([g.reshape(-1) for g in step.grads]).cpu().numpy()
            out["w_final"] = flat_params(model).cpu().numpy()
            out["launches"] = json.dumps(dict(cuda_lib.LAUNCHES))
            piece = shard_batch(batches[0], sharding)
            out["step_ms"] = np.float64(events_ms(lambda i: step(piece), DP_TIMED_STEPS)[0])
        else:
            from real_time_self_adaptive_deep_stereo_torch.cli import train

            args = train.build_argparser().parse_args(config["argv"])
            cuda_lib.reset_launches()
            t0 = time.perf_counter()
            result = train.main(args, device=device)
            out["wall_ms"] = np.float64((time.perf_counter() - t0) * 1e3 / result["steps"])
            out["losses"] = np.asarray(result["losses"], np.float64)
            out["launches"] = json.dumps(dict(cuda_lib.LAUNCHES))
        np.savez(workdir / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
    return 0


def adam_moments(grads):
    """Adam's first moment after each step of the flat gradients ``grads``
    (``utils/optim.py``'s b1 0.9), in float64."""
    m, out = 0.0, []
    for g in grads:
        m = 0.9 * m + 0.1 * np.asarray(g, np.float64)
        out.append(m)
    return out


def assert_weights_close(got, want, moments, what):
    """Adam's steps: ``got`` against ``want`` at DP_WEIGHT_TOL where every
    first moment of ``moments`` (one a step) exceeds DP_MOVED of its
    largest entry; the worst entries printed."""
    moved = np.logical_and.reduce([np.abs(m) > DP_MOVED * float(np.abs(m).max()) for m in moments])
    bad = ~np.isclose(got, want, **DP_WEIGHT_TOL) & moved
    log(f"{what}: {int(moved.sum())} weights compared (Adam's first moment over {DP_MOVED} of its largest at each "
        f"of {len(moments)} steps), {int(bad.sum())} beyond rtol {DP_WEIGHT_TOL['rtol']} / atol "
        f"{DP_WEIGHT_TOL['atol']}; largest difference anywhere {float(np.abs(got - want).max()):.3g}")
    for i in np.flatnonzero(bad)[:5]:
        log(f"  weight {i}: {got[i]!r} against {want[i]!r}; first moments, of their largest: "
            f"{[float(abs(m[i]) / np.abs(m).max()) for m in moments]}")
    if bad.any() or moved.sum() < 1000:
        raise AssertionError(f"{what}: weights differ")


def run_dp_step(launches, ms, workdir: Path, backend: str, device: str):
    """Phase 12 (b): ``make_dp_train_step`` on DP_WORLD ranks against the
    one-process step on the whole batch."""
    from real_time_self_adaptive_deep_stereo_torch.cli.train import MAX_DISP, loss_and_grads, make_train_step
    from real_time_self_adaptive_deep_stereo_torch.losses import get_supervised_loss
    from real_time_self_adaptive_deep_stereo_torch.losses.factory import supervised_invalid
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    tag = f"DP_STEP_{backend.upper()}"
    model = get_stereo_net("MADNet", seed=0)
    start = flat_params(model).cpu().numpy()
    batches = dp_batches(DP_STEPS, 700)
    np.savez(workdir / "weights.npz", flat=start)
    np.savez(workdir / "batches.npz", **{f"{j}_{k}": v for j, b in enumerate(batches) for k, v in b.items()})
    counts = [[int((b["target"][r * 2 : r * 2 + 2] != 0).sum()) for r in range(DP_WORLD)] for b in batches]
    log(f"{tag}: valid pixels of each rank's half, by step: {counts}")
    spawn_ranks("step", workdir, {"backend": backend, "device": device})
    ranks = [dict(np.load(workdir / f"rank{r}.npz")) for r in range(DP_WORLD)]
    per_step = {k: DP_STEPS * v for k, v in TRAIN_LAUNCHES["MADNet"].items()}
    for r, got in enumerate(ranks):
        counted = {k: v for k, v in json.loads(str(got["launches"])).items() if v}
        if counted != per_step:
            raise AssertionError(f"{tag} rank {r}: launches {counted}, want {per_step}")
        launches[f"{tag}_RANK{r}"] = json.loads(str(got["launches"]))

    loss_fn = get_supervised_loss("mean_l1", multiScale=True, max_disp=MAX_DISP)
    sum_fn = get_supervised_loss("sum_l1", multiScale=True, max_disp=MAX_DISP)
    plain = get_stereo_net("MADNet", corr_mode="torch", warp_mode="clamped")
    cuda_batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()} for b in batches]
    for j, batch in enumerate(cuda_batches):
        for key in (f"w{j}", f"g{j}", f"loss{j}"):
            if not np.array_equal(ranks[0][key], ranks[1][key]):
                raise AssertionError(f"{tag} step {j}: the ranks' {key} differ")
        # one process at the ranks' weights before step j: the loss and
        # gradient of the whole batch, and the sum of the gradients of the
        # ranks' two halves, each divided by the batch's valid count, with
        # the kernels and with the plain modes
        for net in (model, plain):
            load_flat(net, torch.from_numpy(ranks[0][f"w{j}"]).cuda())
        cuda_lib.reset_launches()
        loss, g = loss_and_grads(model, loss_fn, batch)
        count = float((~supervised_invalid(batch["target"], MAX_DISP)).sum())
        halves, plain_halves = [], []
        for r in range(DP_WORLD):
            half = {k: v[r * 2 : r * 2 + 2] for k, v in batch.items()}
            halves.append(loss_and_grads(model, lambda d, b: sum_fn(d, b) / count, half)[1])
            plain_halves.append(loss_and_grads(plain, lambda d, b: sum_fn(d, b) / count, half)[1])
        torch.cuda.synchronize()
        launched = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
        if launched != {k: 3 * v for k, v in TRAIN_LAUNCHES["MADNet"].items()}:  # B = 4, then the halves
            raise AssertionError(f"{tag} step {j}: one process launched {launched}")
        g, halves, plain_halves = (torch.cat([v.reshape(-1) for v in grads]).cpu().numpy() for grads in (
            g, [a + b for a, b in zip(*halves)], [a + b for a, b in zip(*plain_halves)]))
        g_scale = float(np.abs(g).max())

        def rel(a, b):
            return float(np.abs(a - b).max()) / g_scale

        got = ranks[0][f"g{j}"]
        loss_err = abs(float(ranks[0][f"loss{j}"]) - float(loss)) / float(loss)
        g_err, g_err_plain = rel(got, halves), rel(got, plain_halves)
        means = []
        for r in range(DP_WORLD):  # what a mean of the ranks' own means would have read
            half = {k: v[r * 2 : r * 2 + 2] for k, v in batch.items()}
            with torch.no_grad():
                means.append(float(loss_fn(model(half["left"], half["right"])["disparities"], half)))
        miss = abs(np.mean(means) - float(loss)) / float(loss)
        log(f"{tag} step {j}: loss {float(ranks[0][f'loss{j}']):.6f} against one process {float(loss):.6f} "
            f"({loss_err:.3g} relative; a mean of the ranks' means would miss by {miss:.3g}); gradient, of its "
            f"largest entry {g_scale:.3g}: against one process over the same halves {g_err:.3g} (bound "
            f"{DP_GRAD_RTOL}), with the plain modes {g_err_plain:.3g} (bound {STEP_RTOL}); against the whole "
            f"batch {rel(got, g):.3g} (one process: the whole batch against its halves {rel(g, halves):.3g}); "
            f"the two ranks' weights, loss and gradient bit for bit equal")
        if not (loss_err <= DP_LOSS_RTOL and g_err <= DP_GRAD_RTOL and g_err_plain <= STEP_RTOL
                and miss > DP_LOSS_RTOL):
            raise AssertionError(f"{tag} step {j}: the data-parallel step is not the one-process step")
    if not np.array_equal(ranks[0]["w_final"], ranks[1]["w_final"]):
        raise AssertionError(f"{tag}: the ranks' weights differ after the last step")

    # the one-process run from the same weights over the same batches
    load_flat(model, torch.from_numpy(start).cuda())
    step = make_train_step(model, loss_fn, LR)
    losses = [float(step(b)) for b in cuda_batches]
    got = [float(ranks[0][f"loss{j}"]) for j in range(DP_STEPS)]
    traj = max(abs(a - b) / b for a, b in zip(got, losses))
    log(f"{tag}: losses {got} against the one-process run's {losses} ({traj:.3g} relative)")
    if not traj <= DP_LOSS_RTOL:
        raise AssertionError(f"{tag}: the losses part from the one-process run's")
    assert_weights_close(ranks[0]["w_final"], flat_params(model).cpu().numpy(),
                         adam_moments(ranks[0][f"g{j}"] for j in range(DP_STEPS)),
                         f"{tag}: weights after {DP_STEPS} steps against one process")
    one_ms = events_ms(lambda i: step(cuda_batches[0]), DP_TIMED_STEPS)[0]
    ms[f"{tag}_MS"] = [float(r["step_ms"]) for r in ranks]
    ms["DP_ONE_PROCESS_STEP_MS"] = one_ms
    log(f"{tag}: {ms[f'{tag}_MS']} ms a step by rank (B = 2 each, CUDA events over {DP_TIMED_STEPS} steps), "
        f"against {one_ms:.3f} ms of one process at B = {DP_BATCH}")


def run_dp_cli(launches, ms, workdir: Path):
    """Phase 12 (c): ``cli/train.py --dataParallel`` on two ``gloo`` ranks
    on the card against the one-process CLI, on phase 10's fixture frames."""
    from real_time_self_adaptive_deep_stereo_torch.cli import train
    from real_time_self_adaptive_deep_stereo_torch.data import StereoDataset
    from real_time_self_adaptive_deep_stereo_torch.losses import get_supervised_loss
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.runtime import native
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import load_params, params_from_jax

    tag = "DP_TRAIN_CLI_GLOO"
    native.available()  # the loader built here, once, before the ranks load it
    data = write_cli_list(workdir, CLI_SCENES["scene"], DP_BATCH * DP_CLI_STEPS)
    argv = ["--trainingSet", data, "--weights", str(CLI_WEIGHTS), "--modelName", "MADNet", "--imageShape", str(H),
            str(W), "--batchSize", str(DP_BATCH), "--numEpochs", "1", "--seed", "0", "--dataParallel"]
    dp_out = workdir / "train_dp"
    outs = spawn_ranks("cli", workdir, {"backend": "gloo", "device": "cuda:0", "argv": argv + ["-o", str(dp_out)]})
    ranks = [dict(np.load(workdir / f"rank{r}.npz")) for r in range(DP_WORLD)]
    per_step = {k: DP_CLI_STEPS * v for k, v in TRAIN_LAUNCHES["MADNet"].items()}
    for r, got in enumerate(ranks):
        counted = {k: v for k, v in json.loads(str(got["launches"])).items() if v}
        if counted != per_step:
            raise AssertionError(f"{tag} rank {r}: launches {counted}, want {per_step}")
        launches[f"{tag}_RANK{r}"] = json.loads(str(got["launches"]))
    if "Data-parallel over 2 ranks (gloo)" not in outs[0] or "Step:" in outs[1] or "All Done" in outs[1]:
        raise AssertionError(f"{tag}: rank 0 alone logs")
    if sorted(os.listdir(dp_out)) != [f"weights-{DP_CLI_STEPS}.npz"]:
        raise AssertionError(f"{tag}: {sorted(os.listdir(dp_out))} in the output, want rank 0's one checkpoint")

    args = train.build_argparser().parse_args(argv + ["-o", str(workdir / "train_one")])
    t0 = time.perf_counter()
    one = train.main(args)
    one_ms = (time.perf_counter() - t0) * 1e3 / one["steps"]
    errs = [float(np.max(np.abs(r["losses"] - one["losses"]) / np.abs(one["losses"]))) for r in ranks]
    log(f"{tag}: losses {ranks[0]['losses'].tolist()} against one process {one['losses']} "
        f"({max(errs):.3g} relative); {[float(r['wall_ms']) for r in ranks]} ms a step by rank against {one_ms:.1f} "
        f"in one process (wall, with reading and set-up)")
    if not (len(one["losses"]) == DP_CLI_STEPS and max(errs) <= DP_CLI_LOSS_RTOL):
        raise AssertionError(f"{tag}: the losses part from the one-process CLI's")
    ms[f"{tag}_STEP_WALL"] = [float(r["wall_ms"]) for r in ranks]
    ms["TRAIN_CLI_ONE_PROCESS_STEP_WALL"] = one_ms

    # Adam's steps compared where its first moment is not noise at either
    # step: the gradients of a one-process run over the same batches
    model = get_stereo_net("MADNet")
    model.load_state_dict(params_from_jax(load_params(str(CLI_WEIGHTS))))
    step = train.make_train_step(
        model, get_supervised_loss("mean_l1", multiScale=True, max_disp=train.MAX_DISP), args.lr)
    grads = []
    for batch in StereoDataset(data, batch_size=DP_BATCH, crop_shape=(H, W), num_epochs=1, augment=False,
                               is_training=True, shuffle=True, seed=0):
        step({k: torch.from_numpy(v).cuda() for k, v in batch.items()})
        grads.append(torch.cat([v.reshape(-1) for v in step.grads]).cpu().numpy())
    got, want = (get_stereo_net("MADNet") for _ in range(2))
    got.load_state_dict(params_from_jax(load_params(str(dp_out / f"weights-{DP_CLI_STEPS}.npz"))))
    want.load_state_dict(params_from_jax(load_params(str(workdir / "train_one" / f"weights-{DP_CLI_STEPS}.npz"))))
    assert_weights_close(flat_params(got).cpu().numpy(), flat_params(want).cpu().numpy(), adam_moments(grads),
                         f"{tag}: the checkpoint against the one-process CLI's")


def run_parallel(state, profile_dir):
    """Phase 12: multi-stream fused sessions and data-parallel training.
    Returns (launches by path, ms by path)."""
    import tempfile

    del profile_dir
    t0 = time.perf_counter()
    launches, ms = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "gloo").mkdir()
        run_dp_step(launches, ms, tmp / "gloo", "gloo", "cuda:0")
        if torch.cuda.device_count() >= DP_WORLD:
            (tmp / "nccl").mkdir()
            run_dp_step(launches, ms, tmp / "nccl", "nccl", "cuda:{rank}")
        else:
            log(f"DP_STEP_NCCL not run: NCCL takes one GPU a rank, and this machine has "
                f"{torch.cuda.device_count()} GPU(s) for {DP_WORLD} ranks")
        (tmp / "cli").mkdir()
        run_dp_cli(launches, ms, tmp / "cli")
    stream_launches, stream_ms = run_streams(state)
    launches.update(stream_launches)
    ms.update(stream_ms)
    log(f"phase 12 done in {time.perf_counter() - t0:.1f} s")
    return launches, ms


# ----------------------------------------------------------------- phase 13
VMAP_COUNTS = (2, 4)
N_FRAMES_VMAP = 8  # a SEQUENTIAL round of the five blocks (eager steps and captures), then 3 replayed
N_TIMED_VMAP = 3
# the loss of every frame of a vmap stream against its single session: a
# grouped convolution (the stream axis) rounds apart from a plain one, and
# the random-weight network carries that along an adapting trajectory (on
# an H100, 8 frames part by up to 1.65e-3 under FULL, 6.7e-4 under MAD,
# where the first rounds agree within 1e-4); about three times that
LATER_LOSS_RTOL = 5e-3
SP_WORLD = 2
SP_STEPS = 3
SP_FRAMES = 5
SP_STREAMS = 4
SP_JOIN_S = 420  # a rank's time limit
# the width-sharded step and session against one process on the whole
# frame, at tests/test_parallel.py's bounds (as tests/test_torch_spatial.py)
SP_LOSS_RTOL = 1e-4
SP_WEIGHT_TOL = dict(rtol=1e-3, atol=1e-6)
SP_MESH_LOSS = dict(rtol=5e-4, atol=1e-6)
SP_MESH_EPE = dict(rtol=5e-4, atol=1e-5)
SP_DISP_RTOL = 1e-3  # of the largest disparity, the pieces against one process's
# DispNet-Corr1D width-sharded (phase 13 (b)): the step's frames, one
# SEQUENTIAL round of its six blocks for MAD, FULL's frames, and the proxy
# session's (through block 3, the first whose gradient crosses the
# correlation)
SP_DN_STEPS = 3
SP_DN_FRAMES = 6
SP_DN_FULL = 3
SP_DN_PROXY = 4
# a FULL step of every rank with the default (cuda) warps
FULL_CUDA = {"corr_fwd": 5, "corr_bwd": 5, "warp_image_fwd": 1, "warp_image_bwd": 1,
             "warp_features_fwd": 4, "warp_features_bwd": 4}


def mad_cuda_launches(k: int):
    """``mad_tile_launches`` on the default (cuda) warps."""
    return {name.replace("warp_tile_", "warp_"): v for name, v in mad_tile_launches(k).items()}


def check_vmap_kernels(rows, n: int):
    """Phase 13: the five kernel Functions under ``torch.func.vmap`` over
    ``n`` streams at MADNet's main-path shapes ([n, 1, ...]), forward and
    backward (its rule of its own): each vmapped call one launch, against
    the plain version stream by stream, timed beside the plain version on
    the folded [n, ...] batch, which is what the rule launches. The warp
    backward asks for both gradients. The correlation's bf16 instances
    (the features of a ``bf16_act`` stream) likewise, within
    :func:`bf16_tol` of the plain version. Rows carry ``vmap``: n."""
    import importlib

    import torch.nn.functional as F
    from torch.func import vmap

    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib
    from real_time_self_adaptive_deep_stereo_torch.ops import warp as pw

    corr = importlib.import_module("real_time_self_adaptive_deep_stereo_torch.ops.correlation")
    wk = importlib.import_module("real_time_self_adaptive_deep_stereo_torch.ops.warp_kernels")
    k = 2 * RADIUS + 1

    def once(name, call):
        before = cuda_lib.LAUNCHES[name]
        out = call()
        if cuda_lib.LAUNCHES[name] - before != 1:
            raise AssertionError(f"{name} under vmap over {n} streams: "
                                 f"{cuda_lib.LAUNCHES[name] - before} launches, want 1")
        return out

    def row(name, shape, err, call, plain_ms, bytes_flops, library=None, tol=None):
        rows[name].append(dict(
            vmap=n, shape=[n, *shape], err=err, tol=tol or f"{BWD_RTOL} of the largest entry",
            ms=time_ms(call), plain_ms=plain_ms, library_ms=None if library is None else time_ms(library),
            bound=bound(*bytes_flops),
        ))

    def stacked_corr(fn, *ts):
        return [torch.stack(t) for t in zip(*[fn(*(a[s] for a in ts), RADIUS) for s in range(n)])]

    fold = lambda t: t.flatten(0, 1)  # noqa: E731
    for i, (c, f) in enumerate(CORR_LEVELS):
        shape = (1, c, H // f, W // f)
        m = n * shape[2] * shape[3]
        x, y = seeded((n, *shape), 610 + i), seeded((n, *shape), 620 + i)
        g = seeded((n, 1, k, *shape[2:]), 630 + i)
        fwd = lambda: vmap(lambda a, b: corr._CorrelationCUDA.apply(a, b, RADIUS, False))(x, y)  # noqa: E731
        bwd = lambda: vmap(  # noqa: E731
            lambda a, b, d: corr._CorrelationBwdCUDA.apply(a, b, d, RADIUS, False))(x, y, g)
        got = once("corr_fwd", fwd)
        want = torch.stack([corr.correlation_torch(x[s], y[s], RADIUS) for s in range(n)])
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **CORR_TOL)
        row("corr_fwd", shape, float((got - want).abs().max()), fwd,
            time_ms(lambda: corr.correlation_torch(fold(x), fold(y), RADIUS)),
            (4.0 * m * (2 * c + k), 2.0 * m * c * k),
            tol=CORR_TOL)
        got = once("corr_bwd", bwd)
        want = [torch.stack(t) for t in zip(*[corr.correlation_torch_bwd(x[s], y[s], g[s], RADIUS)
                                               for s in range(n)])]
        errs = [assert_grad_close(a, b, f"corr_bwd under vmap {shape} {nm}") for a, b, nm in zip(got, want, "xy")]
        row("corr_bwd", shape, max(errs), bwd,
            time_ms(lambda: corr.correlation_torch_bwd(fold(x), fold(y), fold(g), RADIUS)),
            (4.0 * m * (4 * c + k), 6.0 * m * c * k))

        # the bf16 instances on the same values rounded to bf16
        xb, yb, gb = x.bfloat16(), y.bfloat16(), g.bfloat16()
        xa, ya, ga = (t.float().abs() for t in (xb, yb, gb))  # the terms' magnitudes, for the tolerance
        fwd_b = lambda: vmap(lambda a, b: corr._CorrelationCUDA.apply(a, b, RADIUS, False))(xb, yb)  # noqa: E731
        bwd_b = lambda: vmap(  # noqa: E731
            lambda a, b, d: corr._CorrelationBwdCUDA.apply(a, b, d, RADIUS, False))(xb, yb, gb)
        got = once("corr_fwd_bf16", fwd_b)
        want = torch.stack([corr.correlation_torch(xb[s], yb[s], RADIUS) for s in range(n)])
        abs_fwd = torch.stack([corr.correlation_torch(xa[s], ya[s], RADIUS) for s in range(n)])
        torch.cuda.synchronize()
        tol = "one bf16 ulp of each entry, plus 2 (n + 2) 2^-24 of its terms' magnitudes (n terms)"
        row("corr_fwd_bf16", shape, bf16_err(got, want, abs_fwd, c, f"corr_fwd_bf16 under vmap {shape}"), fwd_b,
            time_ms(lambda: corr.correlation_torch(fold(xb), fold(yb), RADIUS)),
            (2.0 * m * (2 * c + k), 2.0 * m * c * k, BF16_FLOPS), tol=tol)
        got = once("corr_bwd_bf16", bwd_b)
        want = stacked_corr(corr.correlation_torch_bwd, xb, yb, gb)
        abs_grads = stacked_corr(corr.correlation_torch_bwd, xa, ya, ga)
        torch.cuda.synchronize()
        errs = [bf16_err(a, b, t, k, f"corr_bwd_bf16 under vmap {shape} {nm}")
                for a, b, t, nm in zip(got, want, abs_grads, "xy")]
        row("corr_bwd_bf16", shape, max(errs), bwd_b,
            time_ms(lambda: corr.correlation_torch_bwd(fold(xb), fold(yb), fold(gb), RADIUS)),
            (2.0 * m * (4 * c + k), 6.0 * m * c * k, BF16_FLOPS), tol=tol)

    # the image warp at full resolution (the loss's), the feature warp at
    # K1's last four levels; the default and the tiled kernels
    img = seeded((n, 1, 3, H, W), 640, 0.0, 1.0)
    disp = seeded((n, 1, 1, H, W), 641, -8.0, 200.0)
    cases = [("image", img, disp, (MAX_DISP,), 3, "border", -1.0, 642)]
    for i, (c, f) in enumerate(FEAT_LEVELS):
        neg = -(-MAX_DISP // f)
        cases.append(("features", seeded((n, 1, c, H // f, W // f), 650 + i),
                      seeded((n, 1, 1, H // f, W // f), 660 + i, -neg - 10.0, MAX_POS + 6.0),
                      (neg, MAX_POS), c, "zeros", 1.0, 670 + i))
    for kind, src, off, bounds, c, padding, sign, seed in cases:
        m = n * src.shape[3] * src.shape[4]
        g = seeded(tuple(src.shape), seed)
        lo, hi = (0.0, bounds[0]) if kind == "image" else (-bounds[0], bounds[1])
        grid = grid_for(fold(off).clamp(lo, hi), sign)
        for tiled in (False, True):
            if kind == "image":
                fn = wk._WarpImageTile if tiled else wk._WarpImageCUDA
                plain = (lambda s, o: pw.warp_image_onehot(s, o, *bounds, align=128)) if tiled else (
                    lambda s, o: pw.warp_image_clamped(s, o, *bounds))
            else:
                fn = wk._WarpFeaturesTile if tiled else wk._WarpFeaturesCUDA
                plain = (lambda s, o: pw.warp_features_onehot(s, o, *bounds, align=128)) if tiled else (
                    lambda s, o: pw.warp_features_clamped(s, o, *bounds))
            name = fn.FWD
            fwd = lambda fn=fn: vmap(lambda s, o: fn.apply(s, o, *bounds))(src, off)  # noqa: E731
            got = once(name, fwd)
            want = torch.stack([plain(src[s], off[s]) for s in range(n)])
            torch.cuda.synchronize()
            tol = ONEHOT_TOL if tiled else WARP_TOL
            torch.testing.assert_close(got, want, **tol)
            row(name, tuple(src.shape[1:]), float((got - want).abs().max()), fwd,
                time_ms(lambda: plain(fold(src), fold(off)), inner=2 if tiled else 20),
                (4.0 * m * (2 * c + 1), 3.0 * c * m),
                library=lambda: F.grid_sample(fold(src), grid, "bilinear", padding, align_corners=True), tol=tol)
            fbounds = tuple(float(b) for b in bounds)
            bwd = lambda fn=fn: vmap(  # noqa: E731
                lambda s, o, d: wk._WarpBwd.apply(fn.LIB, fn.BWD, s, o, d, True, True, fbounds))(src, off, g)
            got = once(fn.BWD, bwd)
            want = []
            for s in range(n):
                s_g, o_g = src[s].clone().requires_grad_(), off[s].clone().requires_grad_()
                want.append(torch.autograd.grad(plain(s_g, o_g), (s_g, o_g), g[s]))
            want = [torch.stack(t) for t in zip(*want)]
            errs = [assert_grad_close(a, b, f"{fn.BWD} under vmap {nm}")
                    for a, b, nm in zip(got, want, ("dsrc", "doff"))]
            plain_out_src, plain_out_off = fold(src).clone().requires_grad_(), fold(off).clone().requires_grad_()
            plain_out = plain(plain_out_src, plain_out_off)
            row(fn.BWD, tuple(src.shape[1:]), max(errs), bwd,
                call_ms(lambda: torch.autograd.grad(plain_out, (plain_out_src, plain_out_off), fold(g),
                                                    retain_graph=True), 50),
                (4.0 * m * (3 * c + 2), 8.0 * c * m),
                library=lambda: grid_sample_bwd(fold(g), fold(src), grid, padding, (True, True)))


def vmap_session(state, mode, n, impl="vmap", **kw):
    """An n-stream fused session of MADNet on the tiled warps (phase 12's
    configuration)."""
    return make_session(state, mode, warp="mxu", fused=True, num_streams=n, stream_impl=impl, **kw)


def record_draw(trail, session):
    """Append the blocks a session's streams took in the frame it just
    stepped, and their scores after it (device copies; read at the end)."""
    if trail is not None:
        trail.append((session.cur_blocks.clone(), session.scores.clone()))


def host_trail(trail):
    """(blocks ``[frames, ...]``, scores ``[frames, ...]``) of a trail."""
    return tuple(np.stack([t[j].cpu().numpy() for t in trail]) for j in (0, 1))


def counted_steps(session, frames, per_batch, tag, at=0, trail=None):
    """Step ``session`` over ``frames`` frame-batch by frame-batch, each
    adding exactly ``per_batch`` launches (a dict, or a function of the
    frame's index), each frame's draw appended to ``trail``; returns the
    wall ms of each."""
    out = []
    for i, f in enumerate(frames, start=at):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_counted(session, f, per_batch(i) if callable(per_batch) else per_batch, f"{tag} frame-batch {i}")
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        record_draw(trail, session)
    return out


def single_refs(state, mode, per, seeds, n_round, **kw):
    """A single-stream session per stream over its frames: ((finalize,
    weights, pristine weights) after the first ``n_round`` frames, the
    final finalize, the blocks and scores of every frame) each, and one
    frame's launches."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    refs, per_frame = [], None
    for s, seed in enumerate(seeds):
        sg = make_session(state, mode, warp="mxu", fused=True, seed=seed, **kw)
        cuda_lib.reset_launches()
        trail = []
        for i, f in enumerate(per[s]):
            sg.step(f)
            per_frame = per_frame or {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
            record_draw(trail, sg)
            if i + 1 == n_round:
                first = (sg.finalize(), sg.arena.flat.clone(), sg.arena.flat0)
        refs.append((first, sg.finalize(), host_trail(trail)))
        del sg
    return refs, per_frame


def explain_flip(tag, s, i, seed, got_scores, ref_scores, got, want):
    """A block that a vmap stream drew at frame ``i`` where its single
    session drew another: a PROBABILITY draw (``seed`` the stream's) with
    the same Gumbel noise on scores that differ by rounding can fall on
    either side of the draw's boundary, and only then. Raises unless the
    single session's two best candidates were within twice the scores'
    difference of each other."""
    what = f"{tag} stream {s} frame {i}: blocks {got.tolist()} where the single session drew {want.tolist()}"
    if seed is None:
        raise AssertionError(f"{what} (no random draw)")
    n = ref_scores.shape[-1]
    before_ref = ref_scores[i - 1] if i else np.zeros(n, np.float32)
    before_got = got_scores[i - 1] if i else np.zeros(n, np.float32)
    gen = torch.Generator(device="cuda").manual_seed(int(seed))
    for _ in range(i + 1):  # one draw a frame, as the session's sampler
        u = torch.rand(n, generator=gen, device="cuda", dtype=torch.float32)
    gumbel = (-torch.log(-torch.log(u + 1e-20) + 1e-20)).cpu().numpy()
    top = np.sort(np.asarray(before_ref, np.float64) + gumbel)[::-1]
    margin, diff = float(top[0] - top[1]), float(np.abs(before_got - before_ref).max())
    log(f"{what}: the draw's best two candidates {margin:.3g} apart, the scores {diff:.3g}")
    if not margin <= 2 * diff:
        raise AssertionError(f"{what}, a margin of {margin:.3g} that scores within {diff:.3g} cannot flip")


def check_round(tag, first, flats, final, refs, trail, seeds=None):
    """Each stream of a vmap session against its single session. Over the
    first round (each block trained once from the same weights, or FULL's
    first update) at phase 6's bounds, the weights at its end too. Over
    every frame: the sampled blocks equal (``trail``, the vmap session's
    blocks and scores by frame), the fetch counters equal, the loss
    within LATER_LOSS_RTOL. Where a PROBABILITY draw (``seeds``, the
    streams' seeds) flipped by rounding (:func:`explain_flip`), the frames
    from the flip on are not compared: the trajectories part there."""
    blocks, scores = trail
    for s, (ref_first, ref_final, (ref_blocks, ref_scores)) in enumerate(refs):
        check_stream(tag, flats, s, first, *ref_first)
        n = len(ref_blocks)
        flip = next((i for i in range(n) if not np.array_equal(blocks[i][s], ref_blocks[i])), None)
        if flip is not None:
            explain_flip(tag, s, flip, None if seeds is None else seeds[s], scores[:, s], ref_scores,
                         blocks[flip][s], ref_blocks[flip])
            n = flip
        elif not np.array_equal(final["fetch_counter"][s], ref_final["fetch_counter"]):
            raise AssertionError(f"{tag} stream {s}: fetch counters {final['fetch_counter'][s].tolist()} against "
                                 f"{np.asarray(ref_final['fetch_counter']).tolist()}")
        a, b = np.asarray(final["loss"][s][:n], np.float64), np.asarray(ref_final["loss"][:n], np.float64)
        rel = float(np.max(np.abs(a - b) / np.abs(b)))
        log(f"{tag} stream {s}: the blocks of {n} frames equal, "
            f"{'the draw of frame ' + str(flip) + ' flipped by rounding, ' if flip is not None else ''}"
            f"loss within {rel:.3g} (bound {LATER_LOSS_RTOL}) by frame "
            f"{np.round(np.abs(a - b) / np.abs(b), 9).tolist()}")
        if not rel <= LATER_LOSS_RTOL:
            raise AssertionError(f"{tag} stream {s}: the loss of the later frames differs by {rel:.3g}")


def run_vmap_streams(state, launches, ms):
    """Phase 13 (a): ``stream_impl="vmap"`` at 320x1216. Shared-forward MAD
    (SEQUENTIAL, the bulkhead, the tiled warps, seeds [0] * N, each stream
    on frames of its own) at N = 2 and 4: a frame-batch launches each kernel
    as one frame of a single shared-forward session does (K1 5 times, not
    5N), one graph (the shared branch) replayed with every host sync an
    error, each stream against a single shared-forward session
    (:func:`check_round`); timed by CUDA events beside "map" and "unroll"
    on the same frames, with the graphs captured and the peak memory.
    Then PROBABILITY at N = 4 (seeds 0-3), FULL at N = 2 with dilation 2
    (the forward-only graph of the frames between train steps), NONE
    serving at N = 4 through ``serve``. cuDNN runs its deterministic
    algorithms, as in phase 12. Returns the single-stream references of
    the SEQUENTIAL streams, and their frames."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    n_max = max(VMAP_COUNTS)
    per = stream_frames(n_max, N_FRAMES_VMAP, 700)
    n_blocks = 5
    mad_kw = {k: v for k, v in MAD_KW.items() if k != "seed"}
    refs, per_frame = single_refs(state, "MAD", per, [0] * n_max, n_blocks, shared_forward=True, **mad_kw)
    if per_frame.get("corr_fwd") != 5:
        raise AssertionError(f"a shared-forward frame launches {per_frame}")
    log(f"VMAP: a single shared-forward frame launches {per_frame}")
    for n in VMAP_COUNTS:
        frames = stacked(per, n)
        for impl in ("vmap", "map", "unroll"):
            tag = f"VMAP_{n}_{impl.upper()}"
            base = memory_base()
            session = vmap_session(state, "MAD", n, impl, **{**MAD_KW, "seed": [0] * n})
            cuda_lib.reset_launches()
            trail = [] if impl == "vmap" else None
            if impl == "vmap":
                first = counted_steps(session, frames[:n_blocks], per_frame, tag, trail=trail)
                round_stats, round_flat = session.finalize(), session.arena.flat.clone()
            else:
                first = []
                for f in frames[:n_blocks]:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    session.step(f)
                    torch.cuda.synchronize()
                    first.append((time.perf_counter() - t0) * 1e3)
            dev, wall = events_ms(lambda i: (session.step(frames[n_blocks + i]), record_draw(trail, session)),
                                  N_TIMED_VMAP, sync_error=True)
            peak = memory_peak(base)
            ms[f"{tag}_BATCH_DEVICE"], ms[f"{tag}_BATCH_WALL"] = dev, wall
            log(f"{tag}: {len(session._graphs)} graphs captured; first round (eager steps and captures) ms "
                f"{[round(t, 1) for t in first]}; steady {dev:.3f} ms of device time a frame-batch, {dev / n:.3f} "
                f"a frame ({wall:.3f} and {wall / n:.3f} wall), every host sync an error; {peak}")
            if impl == "vmap":
                total = {k: v * N_FRAMES_VMAP for k, v in per_frame.items()}
                got = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
                if got != total or set(session._graphs) != {("shared",)}:
                    raise AssertionError(f"{tag}: launches {got}, want {total}; graphs {list(session._graphs)}")
                launches[tag] = dict(cuda_lib.LAUNCHES)
                check_round(tag, round_stats, round_flat, session.finalize(), refs[:n], host_trail(trail))
            del session

    # PROBABILITY, seeds 0-3: each stream follows the single session with its seed
    seeds = list(range(n_max))
    kw = dict(sample_mode="PROBABILITY", ssim_th=1e9)
    prob_refs, _ = single_refs(state, "MAD", per, seeds, n_blocks, shared_forward=True, **kw)
    tag = f"VMAP_{n_max}_PROBABILITY"
    session = vmap_session(state, "MAD", n_max, seed=seeds, **kw)
    cuda_lib.reset_launches()
    frames = stacked(per, n_max)
    trail = []
    counted_steps(session, frames[:n_blocks], per_frame, tag, trail=trail)
    round_stats, round_flat = session.finalize(), session.arena.flat.clone()
    counted_steps(session, frames[n_blocks:], per_frame, tag, at=n_blocks, trail=trail)
    launches[tag] = dict(cuda_lib.LAUNCHES)
    final = session.finalize()
    log(f"{tag}: fetch counters {final['fetch_counter'].tolist()}; graphs {list(session._graphs)}")
    if set(session._graphs) != {("shared",)}:
        raise AssertionError(f"{tag}: graphs {list(session._graphs)}")
    check_round(tag, round_stats, round_flat, final, prob_refs, host_trail(trail), seeds)
    del session, prob_refs

    # FULL with dilation 2: the full step on even frames, the forward-only
    # graph on odd ones; the first round is the first update and the frame
    # that sees it
    n = min(VMAP_COUNTS)
    full_refs, full_frame = single_refs(state, "FULL", per, [0] * n, 2, dilation=2, ssim_th=1e9)
    tag = f"VMAP_{n}_FULL"
    session = vmap_session(state, "FULL", n, dilation=2, ssim_th=1e9)
    cuda_lib.reset_launches()
    frames = stacked(per, n)
    per_batch = lambda i: full_frame if i % 2 == 0 else {**TILE_SERVE, "warp_tile_image_fwd": 1}  # noqa: E731
    trail = []
    counted_steps(session, frames[:2], per_batch, tag, trail=trail)
    round_stats, round_flat = session.finalize(), session.arena.flat.clone()
    counted_steps(session, frames[2:], per_batch, tag, at=2, trail=trail)
    launches[tag] = dict(cuda_lib.LAUNCHES)
    if set(session._graphs) != {("full",), ("none",)}:
        raise AssertionError(f"{tag}: graphs {list(session._graphs)}")
    check_round(tag, round_stats, round_flat, session.finalize(), full_refs, host_trail(trail))
    del session, full_refs

    # NONE serving: each stream's disparities are its single session's
    tag = f"VMAP_{n_max}_SERVE"
    serve_frames = [{k: f[k] for k in ("left", "right")} for f in stacked(per, n_max)]
    session = vmap_session(state, "NONE", n_max, compute_metrics=False)
    cuda_lib.reset_launches()
    served = list(session.serve(serve_frames))
    want = {k: v * len(serve_frames) for k, v in TILE_SERVE.items()}
    if {k: v for k, v in cuda_lib.LAUNCHES.items() if v} != want:
        raise AssertionError(f"{tag}: launches {dict(cuda_lib.LAUNCHES)}, want {want}")
    launches[tag] = dict(cuda_lib.LAUNCHES)
    dev, wall = events_ms(lambda i: session.step(serve_frames[i]), N_TIMED_VMAP, sync_error=True)
    ms[f"{tag}_BATCH_DEVICE"], ms[f"{tag}_BATCH_WALL"] = dev, wall
    worst = 0.0
    for s in range(n_max):
        single = make_session(state, "NONE", warp="mxu", fused=True, compute_metrics=False)
        for i, d in enumerate(single.serve({k: f[k] for k in ("left", "right")} for f in per[s])):
            worst = max(worst, float(np.abs(served[i][s] - d).max()) / float(np.abs(d).max()))
        del single
    log(f"{tag}: {dev:.3f} ms of device time a frame-batch ({wall:.3f} wall); disparities within {worst:.3g} "
        f"of the largest of the single sessions'")
    if not worst <= MODEL_RTOL:
        raise AssertionError(f"{tag}: served disparities differ from the single sessions' by {worst:.3g}")
    del session
    return refs, per


def spatial_rank(rank: int, workdir: Path, device) -> dict:
    """One rank of phase 13 (b), (c) and (d) (``--dp-rank`` with mode
    ``spatial``): ``make_spatial_adapt_step`` over SP_STEPS frames, the
    width-sharded fused MAD session over SP_FRAMES, with the reprojection
    loss and then with the proxy labels, then SP_STREAMS vmap streams
    sharded over the ranks; DispNet's parts; the modes' parts."""
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib
    from real_time_self_adaptive_deep_stereo_torch.parallel import (
        batch_sharded,
        make_mesh,
        make_spatial_adapt_step,
        shard_batch,
        width_sharded,
    )

    out = {}
    mesh = make_mesh(device_type="cuda")
    with np.load(workdir / "state.npz") as w:
        state = {k: torch.from_numpy(w[k]) for k in w.files}
    with np.load(workdir / "frames.npz") as f:
        frames = [{k: torch.from_numpy(f[f"{i}_{k}"]).to(device) for k in ("left", "right", "target", "proxy")}
                  for i in range(SP_FRAMES)]
    pieces = [shard_batch({k: v for k, v in f.items() if k != "proxy"}, width_sharded(mesh)) for f in frames]

    model = get_stereo_net("MADNet", device=device, seed=100 + rank)
    if rank == 0:  # the other rank starts elsewhere: the broadcast must bring it over
        model.load_state_dict(state)
    step = make_spatial_adapt_step(model, mesh, lr=LR)
    cuda_lib.reset_launches()
    for j in range(SP_STEPS):
        out[f"w{j}"] = flat_params(model).cpu().numpy()
        out[f"loss{j}"] = np.float32(float(step(pieces[j])))
        out[f"g{j}"] = torch.cat([g.reshape(-1) for g in step.grads]).cpu().numpy()
    out["step_launches"] = json.dumps(dict(cuda_lib.LAUNCHES))
    out["step_audit"] = json.dumps([[*k, v] for k, v in sorted(step.layout.audit.items())])
    out["w_final"] = flat_params(model).cpu().numpy()
    out["step_ms"] = np.float64(events_ms(lambda i: step(pieces[i]), 2)[0])

    session = make_session(state, "MAD", fused=True, mesh=mesh, **MAD_KW)
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    for i, piece in enumerate(pieces):
        if i == len(pieces) - 1:
            session._layout.audit.clear()
        session.step(piece)
        out[f"disp{i}"] = session.last_disp.cpu().numpy()
    out["mesh_ms"] = np.float64((time.perf_counter() - t0) * 1e3 / len(pieces))
    out["mesh_launches"] = json.dumps(dict(cuda_lib.LAUNCHES))
    out["mesh_audit"] = json.dumps([[*k, v] for k, v in sorted(session._layout.audit.items())])
    for k, v in session.finalize().items():
        out[f"mesh_{k}"] = np.asarray(v)
    out["mesh_flat"] = session.arena.flat.cpu().numpy()
    out["mesh_graphs"] = np.int64(session.use_graphs)
    del session

    session = make_session(state, "MAD", fused=True, mesh=mesh, adaptation="proxy", **MAD_KW)
    for f in frames:
        session.step(shard_batch(f, width_sharded(mesh)))
    for k, v in session.finalize().items():
        out[f"proxy_{k}"] = np.asarray(v)
    out["proxy_flat"] = session.arena.flat.cpu().numpy()
    del session

    with np.load(workdir / "streams.npz") as f:
        streams = [{k: torch.from_numpy(f[f"{i}_{k}"]).to(device) for k in ("left", "right", "target")}
                   for i in range(N_FRAMES_VMAP)]
    session = vmap_session(state, "MAD", SP_STREAMS, "auto", mesh=mesh, **{**MAD_KW, "seed": [0] * SP_STREAMS})
    cuda_lib.reset_launches()
    trail = []
    for i, f in enumerate(streams):
        session.step(shard_batch(f, batch_sharded(mesh)))
        # every rank's streams' blocks and scores after the frame
        trail.append([session._gather_rows(t).cpu().numpy() for t in (session.cur_blocks, session.scores)])
        if i == 4:  # the first round: each block trained once
            for k, v in session.finalize().items():
                out[f"round_{k}"] = np.asarray(v)
            out["round_flat"] = session._gather_rows(session.arena.flat).cpu().numpy()
    out["streams_launches"] = json.dumps(dict(cuda_lib.LAUNCHES))
    out["streams_graphs"] = json.dumps([list(map(str, k)) for k in session._graphs])
    for k, v in session.finalize().items():
        out[f"streams_{k}"] = np.asarray(v)
    out["streams_flat"] = session._gather_rows(session.arena.flat).cpu().numpy()
    out["streams_rows"] = np.int64(session.arena.flat.shape[0])
    out["trail_blocks"], out["trail_scores"] = (np.stack([t[j] for t in trail]) for j in (0, 1))
    del session
    log(f"rank {rank}: MADNet's parts done, {memory_line()}")
    out.update(spatial_dispnet_rank(workdir, device, mesh))
    log(f"rank {rank}: DispNet's parts done, {memory_line()}")
    out.update(modes_rank(workdir, device, mesh))
    log(f"rank {rank}: the modes' parts done, {memory_line()}")
    return out


def memory_line() -> str:
    """The card's memory as this process sees it, once its cache is
    emptied: allocated and reserved here, and in use by every process."""
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    return (f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} "
            f"reserved, {(total - free) / 2**30:.2f} in use on the card")


def audit_json(layout) -> str:
    return json.dumps([[*k, v] for k, v in sorted(layout.audit.items())])


def spatial_dispnet_rank(workdir: Path, device, mesh) -> dict:
    """DispNet-Corr1D on one rank of phase 13 (b), from the weights and
    frames in ``dn_state.npz`` and ``dn_frames.npz``:
    ``make_spatial_adapt_step`` over SP_DN_STEPS frames, then the
    width-sharded fused sessions, MAD over one SEQUENTIAL round of the six
    blocks (each frame's sampled block), FULL over SP_DN_FULL frames and
    MAD on the proxy labels over SP_DN_PROXY; each frame's launches, the
    fetches of the step and of each session's last frame."""
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib
    from real_time_self_adaptive_deep_stereo_torch.parallel import make_spatial_adapt_step, shard_batch, width_sharded

    out = {}
    with np.load(workdir / "dn_state.npz") as w:
        state = {k: torch.from_numpy(w[k]) for k in w.files}
    with np.load(workdir / "dn_frames.npz") as f:
        frames = [{k: torch.from_numpy(f[f"{i}_{k}"]).to(device) for k in ("left", "right", "target", "proxy")}
                  for i in range(SP_DN_FRAMES)]
    pieces = [shard_batch({k: v for k, v in f.items() if k != "proxy"}, width_sharded(mesh)) for f in frames]

    model = get_stereo_net("Dispnet", device=device)
    model.load_state_dict(state)
    step = make_spatial_adapt_step(model, mesh, lr=LR)
    cuda_lib.reset_launches()
    for j in range(SP_DN_STEPS):
        out[f"dn_w{j}"] = flat_params(model).cpu().numpy()
        out[f"dn_loss{j}"] = np.float32(float(step(pieces[j])))
        out[f"dn_g{j}"] = torch.cat([g.reshape(-1) for g in step.grads]).cpu().numpy()
    out["dn_step_launches"] = json.dumps(dict(cuda_lib.LAUNCHES))
    out["dn_step_audit"] = audit_json(step.layout)
    out["dn_step_ms"] = np.float64(events_ms(lambda i: step(pieces[i]), 2)[0])
    del model, step

    for tag, mode, adaptation, n in (("dn_mesh", "MAD", "reprojection", SP_DN_FRAMES),
                                     ("dn_full", "FULL", "reprojection", SP_DN_FULL),
                                     ("dn_proxy", "MAD", "proxy", SP_DN_PROXY)):
        session = make_session(state, mode, fused=True, mesh=mesh, model_name="Dispnet", adaptation=adaptation,
                               **(MAD_KW if mode == "MAD" else dict(ssim_th=1e9)))
        cuda_lib.reset_launches()
        per_frame, frame_ms, blocks = [], [], []
        for i in range(n):
            if i == n - 1:
                session._layout.audit.clear()
            before = dict(cuda_lib.LAUNCHES)
            t0 = time.perf_counter()
            session.step(pieces[i] if adaptation == "reprojection" else shard_batch(frames[i], width_sharded(mesh)))
            out[f"{tag}_disp{i}"] = session.last_disp.cpu().numpy()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            per_frame.append({k: v - before[k] for k, v in cuda_lib.LAUNCHES.items() if v - before[k]})
            blocks.append(int(session.cur_blocks.reshape(-1)[0]) if mode == "MAD" else -1)
        out[f"{tag}_launches"] = json.dumps(per_frame)
        out[f"{tag}_audit"] = audit_json(session._layout)
        out[f"{tag}_blocks"] = np.asarray(blocks)
        out[f"{tag}_ms"] = np.float64(statistics.median(frame_ms[1:]))
        for k, v in session.finalize().items():
            out[f"{tag}_{k}"] = np.asarray(v)
        out[f"{tag}_flat"] = session.arena.flat.cpu().numpy()
        del session
    return out


def deconv_halo(k: int, stride: int):
    """(left, right): the input columns beyond a rank's own that its output
    columns of a TF SAME transposed convolution read, by enumerating the
    taps (full output column i*stride + t, tap t < k, is output column
    i*stride + t - (k-1)//2), as tests/test_torch_spatial_dispnet.py does."""
    lo, hi = 10, 13
    reads = [i for o in range(lo * stride, hi * stride) for i in range(lo - k, hi + k)
             if 0 <= o + (k - 1) // 2 - i * stride < k]
    return lo - min(reads), max(reads) + 1 - hi


def check_audit(records, what, radius=RADIUS, convs=49, deconvs=0):
    """tests/test_torch_spatial.py's halo audit on one rank's fetches (and
    tests/test_torch_spatial_dispnet.py's, for DispNet: ``radius`` 40, 22
    SAME and 10 transposed convolutions a forward)."""
    from real_time_self_adaptive_deep_stereo_torch.ops.conv import _same_1d

    tags = {}
    for tag, w, left, right, whole, n in records:
        kind = tag.split()[0]
        tags[kind] = tags.get(kind, 0) + n
        if kind == "conv":
            k_eff, stride = (int(t[1:]) for t in tag.split()[1:])
            pad_left, _ = _same_1d(w, k_eff, stride, 1)
            ok = (left, right) == (pad_left, k_eff - stride - pad_left)
        elif kind == "deconv":
            k_eff, stride = (int(t[1:]) for t in tag.split()[1:])
            ok = (left, right) == deconv_halo(k_eff, stride)
        elif kind == "correlation":
            ok = (left, right) == (radius, radius)
        elif kind == "ssim":
            ok = (left, right) == (1, 1)
        elif kind == "resize":
            ok = left == 0 and 0 <= right <= 1
        else:
            ok = kind in ("warp_features", "warp_image", "enter", "leave")
        if not ok or (whole and kind not in ("warp_features", "warp_image")):
            raise AssertionError(f"{what}: {tag} at width {w} fetched {left} left, {right} right (whole {whole})")
    forwards = tags.get("conv", 0) // convs
    if tags.get("conv", 0) % convs or not forwards or tags.get("deconv", 0) != forwards * deconvs:
        raise AssertionError(f"{what}: fetches by caller {tags}")
    log(f"{what}: fetches by caller {tags}; every conv its halo, all-gathers by the warps alone")


def run_spatial(state, launches, ms, refs, per):
    """Phase 13 (b) and (c): two ``gloo`` ranks sharing the card (this
    script with ``--dp-rank``, mode ``spatial``). (b) ``make_spatial_adapt_step``
    over SP_STEPS frames against one process's unsharded step from the
    rank's weights before each step (the loss within SP_LOSS_RTOL, the
    gradient within STEP_RTOL of its largest entry, the first update at
    SP_WEIGHT_TOL), the ranks' weights, losses and gradients bit for bit,
    its launches, its halo audit; the
    width-sharded fused MAD session (bulkhead, SEQUENTIAL, the default
    warps, eager) over SP_FRAMES against the single-device session at
    tests/test_parallel.py's bounds, the ranks bit for bit, the disparity
    pieces against the single session's; the same session adapting to
    proxy labels (noisy disparities, 10-60% invalid, more on rank 0's
    side) against the single-device one at the same bounds. (c)
    SP_STREAMS vmap streams over the two ranks on (a)'s frames: each
    stream against (a)'s single shared-forward sessions
    (:func:`check_round`, every frame's blocks), both ranks' gathered
    results equal. Prints
    ms a step a rank beside one process: a correctness check, not a speed
    one (one card, gloo through host memory, eager)."""
    import tempfile

    from real_time_self_adaptive_deep_stereo_torch.losses import get_reprojection_loss
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.utils import optim
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import params_from_jax

    frames = with_proxies(smooth_frames(SP_FRAMES, 900), 910)
    dn_frames = with_proxies(smooth_frames(SP_DN_FRAMES, 950), 960)
    dn_state = params_from_jax(seeded_dispnet_params(1))  # phase 7's weights
    # (a)'s graph pools and cached blocks back to the card: the ranks share it
    memory_base()
    log(f"phase 13 (b): before the ranks, {memory_line()}")
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        np.savez(work / "state.npz", **{k: v.cpu().numpy() for k, v in state.items()})
        np.savez(work / "frames.npz", **{f"{i}_{k}": v for i, f in enumerate(frames) for k, v in f.items()})
        np.savez(work / "streams.npz", **{f"{i}_{k}": v for i, f in enumerate(stacked(per, SP_STREAMS))
                                          for k, v in f.items()})
        np.savez(work / "dn_state.npz", **{k: v.cpu().numpy() for k, v in dn_state.items()})
        np.savez(work / "dn_frames.npz", **{f"{i}_{k}": v for i, f in enumerate(dn_frames) for k, v in f.items()})
        np.savez(work / "batch.npz", **modes_batch())
        (work / "config.json").write_text(json.dumps({"mode": "spatial", "backend": "gloo", "device": "cuda:0"}))
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dp-rank", str(r), "--dp-dir",
                                   str(work)], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(SP_WORLD)]
        deadline = time.monotonic() + SP_JOIN_S
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, text) in enumerate(zip(procs, outs)):
            for line in text.strip().splitlines()[-(12 if p.returncode == 0 else 60):]:
                log(f"  rank {r}: {line}")
            if p.returncode != 0:
                raise AssertionError(f"spatial: rank {r} exited with {p.returncode}")
        ranks = []
        for r in range(SP_WORLD):
            with np.load(work / f"rank{r}.npz") as f:
                ranks.append({k: f[k] for k in f.files})
    r0, r1 = ranks

    # (b) the step, against one process on the whole frame, at every step
    # from the rank's weights before it (as phase 12's DP step): a FULL
    # step moves every weight, and the random-weight network carries the
    # rounding of the sharded sums along a trajectory (3 steps part by
    # 1.1e-3 of the loss on an H100)
    model = get_stereo_net("MADNet")
    model.load_state_dict(state)
    params = list(model.parameters())
    loss_fn = get_reprojection_loss("mean_SSIM_l1", reduced=True)
    dev = [{k: torch.from_numpy(v).cuda() for k, v in f.items()} for f in frames]

    def loss_and_grad(f):
        loss = loss_fn(model(f["left"], f["right"])["disparities"], f)
        grads = torch.autograd.grad(loss, params)
        return float(loss), torch.cat([g.reshape(-1) for g in grads])

    for key in [f"{k}{j}" for j in range(SP_STEPS) for k in ("w", "loss", "g")] + ["w_final"]:
        if not np.array_equal(r0[key], r1[key]):
            raise AssertionError(f"SPATIAL_STEP: the ranks differ in {key}")
    for j in range(SP_STEPS):
        load_flat(model, r0[f"w{j}"])
        loss, g = loss_and_grad(dev[j])
        g = g.cpu().numpy()
        rel = abs(float(r0[f"loss{j}"]) - loss) / abs(loss)
        g_err = float(np.abs(r0[f"g{j}"] - g).max()) / float(np.abs(g).max())
        log(f"SPATIAL_STEP step {j}: loss {float(r0[f'loss{j}'])!r} against one process's {loss!r} ({rel:.3g}); "
            f"gradient within {g_err:.3g} of its largest entry")
        if not (rel <= SP_LOSS_RTOL and g_err <= STEP_RTOL):
            raise AssertionError(f"SPATIAL_STEP step {j}: loss {rel:.3g}, gradient {g_err:.3g}")
        if j == 0:  # the first update, from the same weights and a zero momentum
            first = float(np.abs(r0["w1"] - (r0["w0"] - LR * g)).max())
            if not np.allclose(r0["w1"], r0["w0"] - LR * g, **SP_WEIGHT_TOL):
                raise AssertionError(f"SPATIAL_STEP: the first update differs by {first:.3g}")
    log(f"SPATIAL_STEP: the ranks' weights, losses and gradients equal bit for bit; the first update within "
        f"{first:.3g} of one process's")
    acc = optim.momentum_init(params)

    def one_step(f):
        loss = loss_fn(model(f["left"], f["right"])["disparities"], f)
        optim.momentum_update(params, acc, torch.autograd.grad(loss, params), LR)

    one_ms = events_ms(lambda i: one_step(dev[i]), 2)[0]
    for r, rk in enumerate(ranks):
        got_launches = {k: v for k, v in json.loads(str(rk["step_launches"])).items() if v}
        if got_launches != {k: v * SP_STEPS for k, v in FULL_CUDA.items()}:
            raise AssertionError(f"SPATIAL_STEP rank {r}: launches {got_launches}")
        check_audit(json.loads(str(rk["step_audit"])), f"SPATIAL_STEP rank {r}")
    launches["SPATIAL_STEP"] = json.loads(str(r0["step_launches"]))
    ms["SPATIAL_STEP_RANK"], ms["SPATIAL_STEP_ONE_PROCESS"] = float(r0["step_ms"]), one_ms
    log(f"SPATIAL_STEP: {float(r0['step_ms']):.3f} ms a step on rank 0 ({float(r1['step_ms']):.3f} on rank 1), "
        f"one process on the whole frame {one_ms:.3f} ms")
    del model

    # (b) the width-sharded session, against the single-device session
    single = make_session(state, "MAD", fused=True, **MAD_KW)
    disps = []
    for f in frames:
        single.step({k: v for k, v in f.items() if k != "proxy"})
        disps.append(single.last_disp.cpu().numpy())
    want = single.finalize()
    for key in ("mesh_loss", "mesh_epe", "mesh_fetch_counter", "mesh_flat", "mesh_scores"):
        if not np.array_equal(r0[key], r1[key]):
            raise AssertionError(f"SPATIAL_MESH: the ranks differ in {key}")
    if int(r0["mesh_graphs"]):
        raise AssertionError("SPATIAL_MESH: a gloo mesh session must run eagerly")
    np.testing.assert_allclose(r0["mesh_loss"], want["loss"], **SP_MESH_LOSS)
    np.testing.assert_allclose(r0["mesh_epe"], want["epe"], **SP_MESH_EPE)
    np.testing.assert_array_equal(r0["mesh_fetch_counter"], want["fetch_counter"])
    spec = {name: (off, size) for name, _, off, size in single.spec.entries}
    off, size = spec["estimator_6.disp1.weight"]
    np.testing.assert_allclose(r0["mesh_flat"][off : off + size],
                               single.arena.flat[off : off + size].cpu().numpy(), **SP_WEIGHT_TOL)
    worst = 0.0
    for i, d in enumerate(disps):
        whole = np.concatenate([r0[f"disp{i}"], r1[f"disp{i}"]], axis=2)
        worst = max(worst, float(np.abs(whole - d).max()) / float(np.abs(d).max()))
    log(f"SPATIAL_MESH: loss {r0['mesh_loss'].tolist()} against {want['loss'].tolist()}; epe "
        f"{r0['mesh_epe'].tolist()} against {want['epe'].tolist()}; weights within "
        f"{float(np.abs(r0['mesh_flat'] - single.arena.flat.cpu().numpy()).max()):.3g}; disparity pieces within "
        f"{worst:.3g} of the largest")
    if not worst <= SP_DISP_RTOL:
        raise AssertionError(f"SPATIAL_MESH: the disparity pieces differ by {worst:.3g}")
    for r, rk in enumerate(ranks):
        total = dict.fromkeys(FULL_CUDA, 0)
        for i in range(SP_FRAMES):
            for k, v in mad_cuda_launches(i % 5).items():
                total[k] = total.get(k, 0) + v
        got_launches = {k: v for k, v in json.loads(str(rk["mesh_launches"])).items() if v}
        if got_launches != {k: v for k, v in total.items() if v}:
            raise AssertionError(f"SPATIAL_MESH rank {r}: launches {got_launches}, want {total}")
        check_audit(json.loads(str(rk["mesh_audit"])), f"SPATIAL_MESH rank {r} (its last frame)")
    launches["SPATIAL_MESH"] = json.loads(str(r0["mesh_launches"]))
    ms["SPATIAL_MESH_RANK_FRAME"] = float(r0["mesh_ms"])
    log(f"SPATIAL_MESH: {float(r0['mesh_ms']):.3f} ms a frame on rank 0 (wall, eager)")
    del single

    # (b) the width-sharded session adapting to proxy labels (each rank's
    # masked L1 sum over the frame's valid count), against the single-device one
    single = make_session(state, "MAD", fused=True, adaptation="proxy", **MAD_KW)
    for f in frames:
        single.step(f)
    want = single.finalize()
    for key in ("proxy_loss", "proxy_epe", "proxy_fetch_counter", "proxy_flat"):
        if not np.array_equal(r0[key], r1[key]):
            raise AssertionError(f"SPATIAL_MESH_PROXY: the ranks differ in {key}")
    np.testing.assert_allclose(r0["proxy_loss"], want["loss"], **SP_MESH_LOSS)
    np.testing.assert_allclose(r0["proxy_epe"], want["epe"], **SP_MESH_EPE)
    np.testing.assert_array_equal(r0["proxy_fetch_counter"], want["fetch_counter"])
    moved = float(np.abs(r0["proxy_flat"] - single.arena.flat0.cpu().numpy()).max())
    np.testing.assert_allclose(r0["proxy_flat"][off : off + size],
                               single.arena.flat[off : off + size].cpu().numpy(), **SP_WEIGHT_TOL)
    log(f"SPATIAL_MESH_PROXY: loss {r0['proxy_loss'].tolist()} against {want['loss'].tolist()}; epe "
        f"{r0['proxy_epe'].tolist()} against {want['epe'].tolist()}; weights within "
        f"{float(np.abs(r0['proxy_flat'] - single.arena.flat.cpu().numpy()).max()):.3g} of {moved:.3g} moved")
    if not moved > 0:
        raise AssertionError("SPATIAL_MESH_PROXY: the weights did not move")
    del single

    # (c) the streams over the mesh, against (a)'s single sessions
    for key in ("streams_loss", "streams_epe", "streams_fetch_counter", "streams_flat", "trail_blocks"):
        if not np.array_equal(r0[key], r1[key]):
            raise AssertionError(f"SPATIAL_STREAMS: the ranks' gathered {key} differ")
    if int(r0["streams_rows"]) != SP_STREAMS // SP_WORLD:
        raise AssertionError(f"SPATIAL_STREAMS: rank 0 holds {int(r0['streams_rows'])} streams")
    round_stats = {k[len("round_"):]: r0[k] for k in r0 if k.startswith("round_")}
    final = {k[len("streams_"):]: r0[k] for k in r0 if k.startswith("streams_")}
    check_round("SPATIAL_STREAMS", round_stats, torch.from_numpy(r0["round_flat"]).cuda(), final, refs,
                (r0["trail_blocks"], r0["trail_scores"]))
    launches["SPATIAL_STREAMS"] = json.loads(str(r0["streams_launches"]))
    log(f"SPATIAL_STREAMS: rank 0's graphs {json.loads(str(r0['streams_graphs']))}; launches "
        f"{ {k: v for k, v in launches['SPATIAL_STREAMS'].items() if v} }")
    check_spatial_dispnet(ranks, launches, ms, dn_state, dn_frames)
    return ranks


def with_proxies(frames, seed):
    """The frames with proxy labels: each disparity with noise, 0 (invalid)
    where it has none and at random elsewhere, more often on the left (the
    ranks hold different counts of valid pixels)."""
    rng = np.random.default_rng(seed)
    for f in frames:
        t = f["target"]
        drop = rng.random(t.shape) < np.linspace(0.6, 0.1, t.shape[2])[None, None, :, None]
        f["proxy"] = np.where(drop | (t == 0), 0.0, t + rng.normal(0.0, 0.5, t.shape)).astype(np.float32)
    return frames


def check_spatial_dispnet(ranks, launches, ms, state, frames):
    """Phase 13 (b) for DispNet-Corr1D (:func:`spatial_dispnet_rank`): the
    ranks bit for bit; each step against one process on the whole frame
    from the rank's weights before it, as MADNet's; each session against
    the single-device fused session over the same frames (loss and EPE at
    SP_MESH_LOSS and SP_MESH_EPE, every frame's sampled block, the weights
    at SP_WEIGHT_TOL, MAD's disparity pieces within SP_DISP_RTOL); each
    frame's launches; the halo audits."""
    from real_time_self_adaptive_deep_stereo_torch.losses import get_reprojection_loss
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib
    from real_time_self_adaptive_deep_stereo_torch.utils import optim

    r0, r1 = ranks
    # the same on both ranks but for each rank's own pieces and fetches
    for key in sorted(k for k in r0 if k.startswith("dn_") and not re.search(r"_ms$|_audit$|_disp\d+$", k)):
        if not np.array_equal(r0[key], r1[key]):
            raise AssertionError(f"SPATIAL_DN: the ranks differ in {key}")
    model = get_stereo_net("Dispnet")
    model.load_state_dict(state)
    params = list(model.parameters())
    loss_fn = get_reprojection_loss("mean_SSIM_l1", reduced=True)
    dev = [{k: torch.from_numpy(v).cuda() for k, v in f.items()} for f in frames]

    def loss_and_grad(f):
        loss = loss_fn(model(f["left"], f["right"])["disparities"], f)
        grads = torch.autograd.grad(loss, params)
        return float(loss), torch.cat([g.reshape(-1) for g in grads])

    for j in range(SP_DN_STEPS):
        load_flat(model, r0[f"dn_w{j}"])
        loss, g = loss_and_grad(dev[j])
        g = g.cpu().numpy()
        rel = abs(float(r0[f"dn_loss{j}"]) - loss) / abs(loss)
        g_err = float(np.abs(r0[f"dn_g{j}"] - g).max()) / float(np.abs(g).max())
        log(f"SPATIAL_DN_STEP step {j}: loss {float(r0[f'dn_loss{j}'])!r} against one process's {loss!r} "
            f"({rel:.3g}); gradient within {g_err:.3g} of its largest entry")
        if not (rel <= SP_LOSS_RTOL and g_err <= STEP_RTOL):
            raise AssertionError(f"SPATIAL_DN_STEP step {j}: loss {rel:.3g}, gradient {g_err:.3g}")
        if j == 0:  # the first update, from the same weights and a zero momentum
            first = float(np.abs(r0["dn_w1"] - (r0["dn_w0"] - LR * g)).max())
            if not np.allclose(r0["dn_w1"], r0["dn_w0"] - LR * g, **SP_WEIGHT_TOL):
                raise AssertionError(f"SPATIAL_DN_STEP: the first update differs by {first:.3g}")
    log(f"SPATIAL_DN_STEP: the ranks bit for bit; the first update within {first:.3g} of one process's")
    load_flat(model, r0["dn_w0"])
    acc = optim.momentum_init(params)

    def one_step(f):
        loss = loss_fn(model(f["left"], f["right"])["disparities"], f)
        optim.momentum_update(params, acc, torch.autograd.grad(loss, params), LR)

    one_ms = events_ms(lambda i: one_step(dev[i]), 2)[0]
    step_want = {k: SP_DN_STEPS for k in ("corr_fwd_wide", "corr_bwd_wide", "warp_image_fwd", "warp_image_bwd")}
    for r, rk in enumerate(ranks):
        got = {k: v for k, v in json.loads(str(rk["dn_step_launches"])).items() if v}
        if got != step_want:
            raise AssertionError(f"SPATIAL_DN_STEP rank {r}: launches {got}, want {step_want}")
        check_audit(json.loads(str(rk["dn_step_audit"])), f"SPATIAL_DN_STEP rank {r}", DN_RADIUS, 22, 10)
    launches["SPATIAL_DN_STEP"] = json.loads(str(r0["dn_step_launches"]))
    ms["SPATIAL_DN_STEP_RANK"], ms["SPATIAL_DN_STEP_ONE_PROCESS"] = float(r0["dn_step_ms"]), one_ms
    log(f"SPATIAL_DN_STEP: {float(r0['dn_step_ms']):.3f} ms a step on rank 0 ({float(r1['dn_step_ms']):.3f} on "
        f"rank 1), one process on the whole frame {one_ms:.3f} ms")
    del model

    for tag, mode, adaptation, n in (("dn_mesh", "MAD", "reprojection", SP_DN_FRAMES),
                                     ("dn_full", "FULL", "reprojection", SP_DN_FULL),
                                     ("dn_proxy", "MAD", "proxy", SP_DN_PROXY)):
        what = f"SPATIAL_{tag.upper()}"
        single = make_session(state, mode, fused=True, model_name="Dispnet", adaptation=adaptation,
                              **(MAD_KW if mode == "MAD" else dict(ssim_th=1e9)))
        disps, blocks = [], []
        for f in frames[:n]:
            single.step({k: v for k, v in f.items() if adaptation == "proxy" or k != "proxy"})
            disps.append(single.last_disp.cpu().numpy())
            blocks.append(int(single.cur_blocks.reshape(-1)[0]) if mode == "MAD" else -1)
        want = single.finalize()
        np.testing.assert_allclose(r0[f"{tag}_loss"], want["loss"], **SP_MESH_LOSS)
        np.testing.assert_allclose(r0[f"{tag}_epe"], want["epe"], **SP_MESH_EPE)
        np.testing.assert_array_equal(r0[f"{tag}_fetch_counter"], want["fetch_counter"])
        if r0[f"{tag}_blocks"].tolist() != blocks:
            raise AssertionError(f"{what}: sampled blocks {r0[f'{tag}_blocks'].tolist()} against {blocks}")
        flat, ref = r0[f"{tag}_flat"], single.arena.flat.cpu().numpy()
        moved = float(np.abs(ref - single.arena.flat0.cpu().numpy()).max())
        np.testing.assert_allclose(flat, ref, **SP_WEIGHT_TOL)
        worst = 0.0
        for i, d in enumerate(disps):
            whole = np.concatenate([r0[f"{tag}_disp{i}"], r1[f"{tag}_disp{i}"]], axis=2)
            worst = max(worst, float(np.abs(whole - d).max()) / float(np.abs(d).max()))
        log(f"{what}: loss {r0[f'{tag}_loss'].tolist()} against {want['loss'].tolist()}; epe "
            f"{r0[f'{tag}_epe'].tolist()} against {want['epe'].tolist()}; blocks {blocks}; weights within "
            f"{float(np.abs(flat - ref).max()):.3g} of {moved:.3g} moved; disparity pieces within {worst:.3g} "
            f"of the largest; {float(r0[f'{tag}_ms']):.3f} ms a frame on rank 0 (wall, eager)")
        if not (moved > 0 and worst <= SP_DISP_RTOL):
            raise AssertionError(f"{what}: weights moved {moved:.3g}, disparity pieces differ by {worst:.3g}")
        for r, rk in enumerate(ranks):
            per_frame = json.loads(str(rk[f"{tag}_launches"]))
            for i, got in enumerate(per_frame):
                k = blocks[i]
                if adaptation == "proxy":  # the proxy loss warps nothing
                    want_l = {"corr_fwd_wide": 1, **({"corr_bwd_wide": 1} if k in DN_CORR_BLOCKS else {})}
                else:
                    want_l = dn_launches(mode, k)
                if got != want_l:
                    raise AssertionError(f"{what} rank {r} frame {i}: launches {got}, want {want_l}")
            check_audit(json.loads(str(rk[f"{tag}_audit"])), f"{what} rank {r} (its last frame)", DN_RADIUS, 22, 10)
        launches[what] = dict.fromkeys(cuda_lib.LAUNCHES, 0)
        for got in json.loads(str(r0[f"{tag}_launches"])):
            for k, v in got.items():
                launches[what][k] = launches[what].get(k, 0) + v
        ms[f"{what}_RANK_FRAME"] = float(r0[f"{tag}_ms"])
        del single


# ----------------------------------------------- phase 13 (d): the modes
# the paths of phases 12-13 under bf16_act (and the width-sharded step
# under default): N = 2 streams, "vmap" and "unroll", over a round of the
# five blocks and a replayed frame; the ranks' data-parallel step, and each
# model's width-sharded step on one frame and MAD session over three
MODE_STREAMS = 2
N_FRAMES_MODE = 6
SP_MODE_FRAMES = 3
# the bounds of one bf16 step (tests/test_torch_precision.py): the loss
# within 1e-3 relative, a gradient within 1e-2 of its largest entry for
# MADNet and 3e-2 for DispNet, against one process in the same mode
MODE_LOSS_RTOL = 1e-3
MODE_GRAD_RTOL = {"MADNet": 1e-2, "Dispnet": 3e-2}
# but a width-sharded MADNet step: a rank's half-width convolutions round
# apart from the whole frame's, and each rank rounds its part of a weight's
# and a bias's gradient to bf16 before the ranks' sum. Measured on an H100
# under bf16_act: 6.5e-3 and 2.2e-2 of the largest entry on two sets of
# frames (0.15 and 0.25 from the highest twin); the bound about twice the
# larger. Taken apart (drift_parts): the shapes' part alone 2.2e-2, the
# rounding's 4.6e-3, deterministic cuDNN on the ranks no change
SP_MODE_GRAD_RTOL = {"MADNet": 5e-2, "Dispnet": 3e-2}


class _ExactWeightGrad(torch.autograd.Function):
    """A bf16 convolution as ``ops/conv.py`` runs it (bf16 operands, the
    output rounded to bf16), whose weight gradient is the fp32 sum of the
    bf16 products, never rounded to bf16; the input gradient cuDNN's, as
    autograd takes it. Phase 13 (d)'s diagnostic alone."""

    @staticmethod
    def forward(ctx, x, weight, stride, rate, groups):
        wb = weight.to(torch.bfloat16)
        ctx.save_for_backward(x, wb)
        ctx.conf = ([stride] * 2, [0, 0], [rate] * 2, False, [0, 0], groups)
        return torch.nn.functional.conv2d(x, wb, None, stride=stride, dilation=rate, groups=groups)

    @staticmethod
    def backward(ctx, gy):
        x, wb = ctx.saved_tensors
        dx = torch.ops.aten.convolution_backward(gy, x, wb, None, *ctx.conf, [True, False, False])[0]
        dw = torch.ops.aten.convolution_backward(gy.float(), x.float(), wb.float(), None, *ctx.conf,
                                                 [False, True, False])[1]
        return dx, dw, None, None, None


class _ExactBiasGrad(torch.autograd.Function):
    """``y + bias`` in ``y``'s dtype (bf16 under bf16_act), the bias's
    gradient summed in fp32 and not rounded to bf16."""

    @staticmethod
    def forward(ctx, y, bias):
        return y + bias.to(y.dtype).view(1, -1, 1, 1)

    @staticmethod
    def backward(ctx, g):
        return g, g.float().sum((0, 2, 3))


@contextlib.contextmanager
def exact_grad_sums():
    """Within the block, the bf16 modes' convolutions (``ops/conv.py::_conv``,
    MADNet's every conv) keep their forward but sum each weight's and
    bias's gradient in fp32 without the bf16 rounding: a diagnostic of the
    width-sharded MADNet step's drift under bf16_act (phase 13 (d))."""
    from real_time_self_adaptive_deep_stereo_torch.ops import conv

    original = conv._conv

    def exact_conv(x, weight, bias, stride, rate, activation, padding, groups=1):
        dt = conv._bf16_epilogue(x)
        if dt is None:
            return original(x, weight, bias, stride, rate, activation, padding, groups)
        x = x.to(torch.bfloat16)
        if padding == "SAME":
            x = conv.same_pad(x, weight.shape[2:], stride, rate)
        y = _ExactWeightGrad.apply(x, weight, stride, rate, groups).to(dt)
        return activation(y if bias is None else _ExactBiasGrad.apply(y, bias))

    conv._conv = exact_conv
    try:
        yield
    finally:
        conv._conv = original


def drift_parts(r0, g_one, g_one_exact, g_one_tuned, names):
    """Phase 13 (d)'s diagnostics of the width-sharded MADNet step's drift
    under bf16_act from one process's gradient: of the gradient's largest
    entry, the check's total; the same with cuDNN's deterministic
    algorithms on the ranks; (a) the shapes' part, the ranks' gradient
    against one process's with every weight's and bias's gradient summed in
    fp32 and never rounded to bf16 (:func:`exact_grad_sums`), so only the
    rank's shapes (cuDNN's algorithms by shape, the halos' order) part
    them; (b) the rounding's part, the ranks' rounding of their partial
    gradients to bf16 before the fp32 sum (their gradient less their exact
    one) less one process's rounding of the whole (its gradient less its
    exact one); and one process on the whole frame with the algorithms
    cuDNN times and picks (``cudnn.benchmark``) against its usual ones, at
    the same shapes. Each printed with the parameter of its largest entry."""
    key = "bf16_act_MADNet_step"
    g, g_det, g_det_exact = r0[f"{key}_g"], r0[f"{key}_det_g"], r0[f"{key}_det_exact_g"]
    scale = float(np.abs(g_one).max())
    at = np.cumsum([size for _, size in names])
    figures = {}
    for what, diff in (("the check's total", g - g_one),
                       ("the total with deterministic cuDNN on the ranks", g_det - g_one),
                       ("(a) the shapes' part", g_det_exact - g_one_exact),
                       ("(b) the rounding's part", (g_det - g_det_exact) - (g_one - g_one_exact)),
                       ("the ranks' own rounding", g_det - g_det_exact),
                       ("one process's own rounding", g_one - g_one_exact),
                       ("one process with cuDNN's timed algorithms, the same shapes", g_one_tuned - g_one)):
        worst = int(np.argmax(np.abs(diff)))
        figures[what] = float(np.abs(diff).max()) / scale
        log(f"MODES_SPATIAL_MADNET_STEP_BF16_ACT drift, {what}: {figures[what]:.3g} of the gradient's largest "
            f"entry, the largest in {names[int(np.searchsorted(at, worst, side='right'))][0]}")
    return figures


def modes_batch():
    """The data-parallel step's global batch in (d): phase 12's form."""
    return dp_batches(1, 720)[0]


def modes_rank(workdir: Path, device, mesh) -> dict:
    """One rank's phase 13 (d), in the processes of (b): under bf16_act the
    data-parallel step (B = 2 a rank), then for MADNet and DispNet
    ``make_spatial_adapt_step`` on the first of (b)'s frames and the
    width-sharded fused MAD session over the first SP_MODE_FRAMES; under
    default the two steps again; each with its launches; then a halo of
    a bf16 tensor that both ranks make from one seed, staged through host
    memory by gloo, against that tensor's columns."""
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.ops import conv_precision, cuda_lib
    from real_time_self_adaptive_deep_stereo_torch.parallel import (
        batch_sharded,
        make_dp_train_step,
        make_spatial_adapt_step,
        shard_batch,
        width_sharded,
    )
    from real_time_self_adaptive_deep_stereo_torch.parallel.spatial import Layout

    out = {}
    states, pieces = {}, {}
    for name, prefix in (("MADNet", ""), ("Dispnet", "dn_")):
        with np.load(workdir / f"{prefix}state.npz") as w:
            states[name] = {k: torch.from_numpy(w[k]) for k in w.files}
        with np.load(workdir / f"{prefix}frames.npz") as f:
            pieces[name] = [shard_batch({k: torch.from_numpy(f[f"{i}_{k}"]).to(device)
                                         for k in ("left", "right", "target")}, width_sharded(mesh))
                            for i in range(SP_MODE_FRAMES)]
    with np.load(workdir / "batch.npz") as b:
        batch = shard_batch({k: torch.from_numpy(b[k]).to(device) for k in b.files}, batch_sharded(mesh))

    def counted(key):
        out[f"{key}_launches"] = json.dumps({k: v for k, v in cuda_lib.LAUNCHES.items() if v})
        cuda_lib.reset_launches()

    for mode in ("bf16_act", "default"):
        with conv_precision(mode):
            assert_tf32(mode)
            cuda_lib.reset_launches()
            if mode == "bf16_act":
                model = get_stereo_net("MADNet", device=device)
                model.load_state_dict(states["MADNet"])
                step = make_dp_train_step(model, mesh, lr=LR)
                out[f"{mode}_dp_loss"] = np.float32(float(step(batch)))
                out[f"{mode}_dp_g"] = torch.cat([g.reshape(-1) for g in step.grads]).cpu().numpy()
                out[f"{mode}_dp_w"] = flat_params(model).cpu().numpy()
                counted(f"{mode}_dp")
                del model, step
            for name in ("MADNet", "Dispnet"):
                key = f"{mode}_{name}"
                model = get_stereo_net(name, device=device)
                model.load_state_dict(states[name])
                step = make_spatial_adapt_step(model, mesh, lr=LR)
                out[f"{key}_step_loss"] = np.float32(float(step(pieces[name][0])))
                out[f"{key}_step_g"] = torch.cat([g.reshape(-1) for g in step.grads]).cpu().numpy()
                counted(f"{key}_step")
                del model, step
                if mode != "bf16_act":
                    continue
                if name == "MADNet":  # the drift's diagnostics (drift_parts), with cuDNN's deterministic algorithms
                    deterministic = torch.backends.cudnn.deterministic
                    torch.backends.cudnn.deterministic = True
                    try:
                        for tag, sums in (("det", contextlib.nullcontext), ("det_exact", exact_grad_sums)):
                            model = get_stereo_net(name, device=device)
                            model.load_state_dict(states[name])
                            step = make_spatial_adapt_step(model, mesh, lr=LR)
                            with sums():
                                step(pieces[name][0])
                            out[f"{key}_step_{tag}_g"] = torch.cat([g.reshape(-1) for g in step.grads]).cpu().numpy()
                            del model, step
                    finally:
                        torch.backends.cudnn.deterministic = deterministic
                    cuda_lib.reset_launches()
                session = make_session(states[name], "MAD", fused=True, mesh=mesh, model_name=name, **MAD_KW)
                t0 = time.perf_counter()
                for i, piece in enumerate(pieces[name]):
                    session.step(piece)
                    out[f"{key}_disp{i}"] = session.last_disp.float().cpu().numpy()
                out[f"{key}_mesh_ms"] = np.float64((time.perf_counter() - t0) * 1e3 / SP_MODE_FRAMES)
                out[f"{key}_disp_dtype"] = str(session.last_disp.dtype)
                for k, v in session.finalize().items():
                    out[f"{key}_mesh_{k}"] = np.asarray(v)
                out[f"{key}_mesh_flat"] = session.arena.flat.cpu().numpy()
                counted(f"{key}_mesh")
                del session

    whole = seeded((1, 8, 4, W // 4), 990).bfloat16()
    layout = Layout(mesh.get_group("data"), W // 4)
    lo, hi = layout.range(W // 4)
    got = layout.halo(whole[..., lo:hi].clone(), 3, 3, 5, "probe")
    want = torch.nn.functional.pad(whole, (3, 5))[..., lo : hi + 8]
    out["probe"] = json.dumps({"dtype": str(got.dtype), "equal": bool(torch.equal(got, want)),
                               "columns": [lo - 3, hi + 5]})
    return out


def run_streams_in_mode(state, launches, ms, per, refs, mode="bf16_act"):
    """Phase 13 (d): N = MODE_STREAMS streams in ``mode``, "vmap" and
    "unroll", shared-forward MAD (vmap) and MAD (unroll), SEQUENTIAL,
    seeds [0] * N, on (a)'s frames: each frame-batch's launches (the bf16
    correlation under bf16_act); each stream against a single session in
    the mode over the same frames (the first round's loss and EPE at phase
    8's fused-against-host bounds, every frame's sampled block, the
    weights within 1e-2 of their move), and its first round's EPE against
    (a)'s single session at highest (:func:`check_epe_drift`)."""
    from real_time_self_adaptive_deep_stereo_torch.ops import conv_precision, cuda_lib

    n, n_blocks = MODE_STREAMS, 5
    frames = stacked(per, n)[:N_FRAMES_MODE]
    with conv_precision(mode):
        assert_tf32(mode)
        for impl, shared in (("vmap", True), ("unroll", False)):
            tag = f"VMAP_{n}_{impl.upper()}_{mode.upper()}"
            singles, shared_frame = [], None
            for s in range(n):
                single = make_session(state, "MAD", warp="mxu", fused=True, shared_forward=shared, **MAD_KW)
                cuda_lib.reset_launches()
                for f in per[s][:N_FRAMES_MODE]:
                    single.step(f)
                    shared_frame = shared_frame or {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
                singles.append((single.finalize(), single.arena.flat.clone(), single.arena.flat0))
                del single
            session = vmap_session(state, "MAD", n, impl, **{**MAD_KW, "seed": [0] * n})
            cuda_lib.reset_launches()
            for i, f in enumerate(frames):
                # vmap: one shared-forward frame's launches, whatever N; unroll: N frames' of the block
                want = shared_frame if impl == "vmap" else in_precision(
                    {k: n * v for k, v in mad_tile_launches(i % n_blocks).items()}, mode)
                step_counted(session, f, want, f"{tag} frame-batch {i}")
            launched = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
            stats, flats = session.finalize(), session.arena.flat.clone()
            dev, wall = events_ms(lambda i: session.step(frames[n_blocks + i]), 1, sync_error=True)
            launches[tag] = {**dict.fromkeys(cuda_lib.LAUNCHES, 0), **launched}
            ms[f"{tag}_BATCH_DEVICE"], ms[f"{tag}_BATCH_WALL"] = dev, wall
            for s in range(n):
                one = {k: stats[k][s] for k in ("loss", "epe")}
                ref, flat, flat0 = singles[s]
                assert_trajectory(one, ref, f"{tag} stream {s} against a single session in {mode}",
                                  frames=n_blocks, loss_rtol=PREC_TRAJ_LOSS_RTOL, epe_rtol=PREC_TRAJ_EPE_RTOL)
                if not np.array_equal(np.asarray(stats["fetch_counter"][s]), np.asarray(ref["fetch_counter"])):
                    raise AssertionError(f"{tag} stream {s}: fetch counters {stats['fetch_counter'][s]}")
                moved = float((flat - flat0).abs().max())
                err = float((flats[s] - flat).abs().max())
                log(f"{tag} stream {s}: weights within {err:.3g} of the single session's, {moved:.3g} moved")
                if not (moved > 0 and err <= 1e-2 * moved):
                    raise AssertionError(f"{tag} stream {s}: weights differ from the single session's")
                check_epe_drift({k: stats[k][s][:n_blocks] for k in ("loss", "epe")}, refs[s][0][0],
                                f"{tag} stream {s} against highest's single session", n_blocks)
            log(f"{tag}: {dev:.3f} ms of device time a frame-batch, replayed ({wall:.3f} wall); launches "
                f"{launched} over {N_FRAMES_MODE} frame-batches")
            del session


def run_modes_ranks(state, launches, ms, ranks):
    """Phase 13 (d): :func:`modes_rank`'s results on (b)'s two ``gloo``
    ranks, against one process in the same mode and at highest (the
    twin): the ranks bit for bit; the data-parallel step against one
    process over the same halves (the loss within MODE_LOSS_RTOL, the
    gradient within MODE_GRAD_RTOL of its largest entry), each
    width-sharded step against one process on the whole frame (the same,
    the gradient within SP_MODE_GRAD_RTOL), under bf16_act PREC_SHARE of
    the gradient's entries or more closer to the mode's than to
    highest's (printed under default); each MAD session against the single-device session in the
    mode (phase 8's fused-against-host bounds over its frames, every
    frame's block, DispNet's disparities bf16) and its EPE against
    highest's; each path's launches (the bf16 correlation under
    bf16_act, the fp32 one under default, whose TF32 flags each rank
    asserts); the bf16 halo bit for bit."""
    from real_time_self_adaptive_deep_stereo_torch.cli.train import MAX_DISP, loss_and_grads
    from real_time_self_adaptive_deep_stereo_torch.losses import get_reprojection_loss, get_supervised_loss
    from real_time_self_adaptive_deep_stereo_torch.losses.factory import supervised_invalid
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.ops import conv_precision, cuda_lib
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import params_from_jax

    states = {"MADNet": state, "Dispnet": params_from_jax(seeded_dispnet_params(1))}
    # (b)'s first frames, without the proxy labels
    frames = {"MADNet": smooth_frames(SP_FRAMES, 900)[:SP_MODE_FRAMES],
              "Dispnet": smooth_frames(SP_DN_FRAMES, 950)[:SP_MODE_FRAMES]}
    batch = modes_batch()
    r0, r1 = ranks
    for key in sorted(k for k in r0 if re.match(r"(bf16_act|default)_", k) and not re.search(r"_disp\d+$|_ms$", k)):
        if not np.array_equal(r0[key], r1[key]):
            raise AssertionError(f"MODES: the ranks differ in {key}")
    for r, rk in enumerate(ranks):
        probe = json.loads(str(rk["probe"]))
        log(f"MODES rank {r}: a bf16 halo of columns {probe['columns']} through gloo's host staging: {probe}")
        if probe["dtype"] != "torch.bfloat16" or not probe["equal"]:
            raise AssertionError(f"MODES rank {r}: the bf16 halo did not arrive as the neighbour's columns")

    def flat_grads(grads):
        return torch.cat([g.reshape(-1) for g in grads]).cpu().numpy()

    def counts(nonzero):
        return {**dict.fromkeys(cuda_lib.LAUNCHES, 0), **nonzero}

    def compare(what, loss, g, want, twin, grad_rtol, names, share_min):
        """(loss, gradient) against one process in the mode, ``want``, and
        at highest, ``twin``; ``names`` the parameters' (name, size) in the
        flat gradient's order; at least ``share_min`` of the entries closer
        to the mode's gradient than to highest's."""
        scale = float(np.abs(want[1]).max())
        loss_err = abs(loss - want[0]) / abs(want[0])
        g_err = float(np.abs(g - want[1]).max()) / scale
        worst = int(np.argmax(np.abs(g - want[1])))
        at = np.cumsum([size for _, size in names])
        where = names[int(np.searchsorted(at, worst, side="right"))][0]
        twin_loss, twin_g = abs(loss - twin[0]) / abs(twin[0]), float(np.abs(g - twin[1]).max()) / scale
        differ = want[1] != twin[1]
        share = float(np.mean((np.abs(g - want[1]) < np.abs(g - twin[1]))[differ])) if differ.any() else 0.0
        log(f"{what}: loss {loss!r} against one process's {want[0]!r}: {loss_err:.3g} (bound {MODE_LOSS_RTOL}); "
            f"gradient within {g_err:.3g} of its largest entry (bound {grad_rtol}; the largest difference in "
            f"{where}); the highest twin: loss {twin_loss:.3g}, gradient {twin_g:.3g}; closer to the mode's gradient "
            f"than to highest's at {share:.3f} of the entries where the two differ (bound {share_min})")
        if not (loss_err <= MODE_LOSS_RTOL and g_err <= grad_rtol and share >= share_min):
            raise AssertionError(f"{what}: loss {loss_err:.3g}, gradient {g_err:.3g}, share {share:.3f}")

    # the data-parallel step: one process over the ranks' halves, each
    # half's sum over the batch's valid count
    model = get_stereo_net("MADNet")
    model.load_state_dict(state)
    sum_fn = get_supervised_loss("sum_l1", multiScale=True, max_disp=MAX_DISP)
    dev = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    count = float((~supervised_invalid(dev["target"], MAX_DISP)).sum())
    one = {}
    for mode in ("bf16_act", "highest"):
        with conv_precision(mode):
            parts = [loss_and_grads(model, lambda d, b: sum_fn(d, b) / count,
                                    {k: v[r * 2 : r * 2 + 2] for k, v in dev.items()}) for r in range(DP_WORLD)]
            one[mode] = (float(sum(p[0] for p in parts)), flat_grads([a + b for a, b in zip(parts[0][1], parts[1][1])]))
    param_sizes = [(n, p.numel()) for n, p in model.named_parameters()]
    compare("MODES_DP_STEP bf16_act", float(r0["bf16_act_dp_loss"]), r0["bf16_act_dp_g"], one["bf16_act"],
            one["highest"], MODE_GRAD_RTOL["MADNet"], param_sizes, PREC_SHARE)
    want = in_precision(TRAIN_LAUNCHES["MADNet"], "bf16_act")
    for r, rk in enumerate(ranks):
        if json.loads(str(rk["bf16_act_dp_launches"])) != want:
            raise AssertionError(f"MODES_DP_STEP rank {r}: launches {rk['bf16_act_dp_launches']}, want {want}")
    launches["MODES_DP_STEP_BF16_ACT"] = counts(want)
    del model

    loss_fn = get_reprojection_loss("mean_SSIM_l1", reduced=True)
    step_launches = {"MADNet": FULL_CUDA, "Dispnet": {k: 1 for k in ("corr_fwd_wide", "corr_bwd_wide",
                                                                      "warp_image_fwd", "warp_image_bwd")}}
    for name in ("MADNet", "Dispnet"):
        model = get_stereo_net(name)
        model.load_state_dict(states[name])
        params = list(model.parameters())
        f0 = {k: torch.from_numpy(v).cuda() for k, v in frames[name][0].items()}
        one = {}
        for mode in ("bf16_act", "default", "highest"):
            with conv_precision(mode):
                loss = loss_fn(model(f0["left"], f0["right"])["disparities"], f0)
                one[mode] = (float(loss), flat_grads(torch.autograd.grad(loss, params)))
        if name == "MADNet":
            with conv_precision("bf16_act"), exact_grad_sums():
                loss = loss_fn(model(f0["left"], f0["right"])["disparities"], f0)
                exact = flat_grads(torch.autograd.grad(loss, params))
            benchmark = torch.backends.cudnn.benchmark
            torch.backends.cudnn.benchmark = True  # cuDNN times its algorithms and takes the fastest
            try:
                with conv_precision("bf16_act"):
                    for _ in range(2):  # the first call tunes
                        loss = loss_fn(model(f0["left"], f0["right"])["disparities"], f0)
                        tuned = flat_grads(torch.autograd.grad(loss, params))
            finally:
                torch.backends.cudnn.benchmark = benchmark
            drift_parts(r0, one["bf16_act"][1], exact, tuned, [(n, p.numel()) for n, p in model.named_parameters()])
        for mode in ("bf16_act", "default"):
            key = f"{mode}_{name}"
            tag = f"MODES_SPATIAL_{name.upper()}_STEP_{mode.upper()}"
            # under default TF32 moves the gradient by little more than the
            # ranks' own rounding: the share is printed, the TF32 flags asserted
            compare(tag, float(r0[f"{key}_step_loss"]), r0[f"{key}_step_g"], one[mode], one["highest"],
                    SP_MODE_GRAD_RTOL[name], [(n, p.numel()) for n, p in model.named_parameters()],
                    PREC_SHARE if mode == "bf16_act" else 0.0)
            want = in_precision(step_launches[name], mode)
            for r, rk in enumerate(ranks):
                if json.loads(str(rk[f"{key}_step_launches"])) != want:
                    raise AssertionError(f"{tag} rank {r}: launches {rk[f'{key}_step_launches']}, want {want}")
            launches[tag] = counts(want)
        del model

        # the width-sharded MAD session under bf16_act against the single-device one, and highest's
        key, tag = f"bf16_act_{name}", f"MODES_SPATIAL_{name.upper()}_MESH_BF16_ACT"
        stats = {k: r0[f"{key}_mesh_{k}"] for k in ("loss", "epe", "fetch_counter", "scores")}
        singles = {}
        for mode in ("bf16_act", "highest"):
            with conv_precision(mode):
                single = make_session(states[name], "MAD", fused=True, model_name=name, **MAD_KW)
                disps = []
                for f in frames[name]:
                    single.step(f)
                    disps.append(single.last_disp.float().cpu().numpy())
                singles[mode] = (single.finalize(), disps, str(single.last_disp.dtype))
                del single
        want, disps, dtype = singles["bf16_act"]
        assert_trajectory(stats, want, f"{tag} against the single-device session in the mode",
                          loss_rtol=PREC_TRAJ_LOSS_RTOL, epe_rtol=PREC_TRAJ_EPE_RTOL)
        assert_controller(stats, want, f"{tag} against the single-device session in the mode",
                          score_atol=PREC_SCORE_ATOL)
        check_epe_drift(stats, singles["highest"][0], f"{tag} against highest's single-device session",
                        SP_MODE_FRAMES)
        worst = max(float(np.abs(np.concatenate([r0[f"{key}_disp{i}"], r1[f"{key}_disp{i}"]], axis=2) - d).max())
                    / float(np.abs(d).max()) for i, d in enumerate(disps))
        log(f"{tag}: disparity pieces within {worst:.3g} of the largest of the single session's; dtype "
            f"{r0[f'{key}_disp_dtype']} (single {dtype}); {float(r0[f'{key}_mesh_ms']):.3f} ms a frame on rank 0 "
            f"(wall, eager)")
        if str(r0[f"{key}_disp_dtype"]) != dtype or (name == "Dispnet") != (dtype == "torch.bfloat16"):
            raise AssertionError(f"{tag}: disparities {r0[f'{key}_disp_dtype']}, the single session's {dtype}")
        launches[tag] = counts(json.loads(str(r0[f"{key}_mesh_launches"])))
        ms[f"{tag}_RANK_FRAME"] = float(r0[f"{key}_mesh_ms"])


def run_phase13(state, profile_dir):
    """Phase 13: batched streams, the width-sharded step and session, and
    streams over a mesh; then (d) the paths of phases 12-13 in the
    precision modes. Returns (launches by path, ms by path)."""
    del profile_dir
    t0 = time.perf_counter()
    launches, ms = {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        refs, per = run_vmap_streams(state, launches, ms)
        ranks = run_spatial(state, launches, ms, refs, per)
        t1 = time.perf_counter()
        run_modes_ranks(state, launches, ms, ranks)
        run_streams_in_mode(state, launches, ms, per, refs)
        log(f"phase 13 (d), the modes, checked in {time.perf_counter() - t1:.1f} s after the ranks")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"phase 13 done in {time.perf_counter() - t0:.1f} s")
    return launches, ms


# ------------------------------------------------------------------ phase 14
# the kernels the adaptation tools' paths launch at highest: the fused
# sessions (and the probe's) on the default warps, with the reprojection
# loss's image warp and its offset gradient; pretraining's supervised
# steps, K1's and K5's backward
TOOL_ADAPT_KERNELS = ("corr_fwd", "corr_bwd", "warp_image_fwd", "warp_image_bwd", "warp_features_fwd",
                      "warp_features_bwd")
VALIDATE_MODES = ("highest", "bf16_act")


def load_tool(name: str) -> types.ModuleType:
    """``tools/<name>.py``, a script of the repository, as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launched(want, what):
    """The launches since the last reset, a full table; raises unless the
    kernels launched are exactly ``want``'s keys and, where ``want`` gives
    a count (not None), that many times."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    got = dict(cuda_lib.LAUNCHES)
    nonzero = {k: v for k, v in got.items() if v}
    if set(nonzero) != set(want) or any(n is not None and nonzero[k] != n for k, n in want.items()):
        raise AssertionError(f"{what}: launches {nonzero}, want {want}")
    cuda_lib.reset_launches()
    return got


def run_tools_phase(state, profile_dir):
    """Phase 14: the repository's tools on the port, through their own
    functions. (a) ``tools/torch_validate_adaptation.py`` at its defaults
    (192x640, 400 pretraining steps, 60 frames of scene B) under highest
    and bf16_act: MAD and FULL must end below NONE's EPE in both. (b)
    ``tools/torch_probe_latency.py`` at 384x1280: the wire, then every
    variant, each disparity checked against the session's own. (c)
    ``tools/torch_bench_offline.py`` at 384x1280 under bf16_act, MADNet
    and DispNet-Corr1D at batches 1, 2, 4, 8, each batch's disparities
    checked against batch 1's, then at highest. Each path's launches
    counted from 0."""
    del state, profile_dir
    from real_time_self_adaptive_deep_stereo_torch.ops import conv_precision, cuda_lib

    t0 = time.perf_counter()
    launches, ms = {}, {}
    validate = load_tool("torch_validate_adaptation")
    probe = load_tool("torch_probe_latency")
    offline = load_tool("torch_bench_offline")

    for mode in VALIDATE_MODES:
        tag = f"TOOLS_VALIDATE_{mode.upper()}"
        t1 = time.perf_counter()
        cuda_lib.reset_launches()
        with conv_precision(mode):
            assert_tf32(mode)
            rows = validate.validate(log=lambda line, tag=tag: log(f"{tag}: {line}"))
        launches[tag] = launched({**in_precision(dict.fromkeys(TOOL_ADAPT_KERNELS), mode), "graph_switch": None}, tag)
        for r in rows:
            log(f"{tag} {r['mode']}: EPE first fifth {r['epe_first']!r}, last fifth {r['epe_last']!r}; "
                f"D1 {r['d1_first']!r} -> {r['d1_last']!r}; loss (last fifth) {r['loss_last']!r}")
        bad = validate.failures(rows)
        if bad:
            raise AssertionError(f"{tag}: {bad}")
        log(f"{tag}: MAD and FULL end below NONE's EPE; {time.perf_counter() - t1:.1f} s")
    assert_tf32("highest")

    cuda_lib.reset_launches()
    recs = probe.probe(TOOLS_H, TOOLS_W, log=lambda line: log(f"TOOLS_PROBE {line}"))
    launches["TOOLS_PROBE"] = launched(dict.fromkeys((*TOOL_ADAPT_KERNELS, "graph_switch")), "TOOLS_PROBE")
    got = [r["variant"] for r in recs if not r["variant"].startswith("wire")]
    if got != list(probe.VARIANTS) or any("skipped" in r for r in recs):
        raise AssertionError(f"TOOLS_PROBE: variants {got}, some skipped: {recs}")
    for r in recs:
        ms[f"TOOLS_PROBE_{r['variant'].upper()}_P50"] = r["p50_ms"]
        if "enqueue_p50_ms" in r:
            ms[f"TOOLS_PROBE_{r['variant'].upper()}_ENQUEUE_P50"] = r["enqueue_p50_ms"]
    log(f"TOOLS_PROBE: every variant handed back the session's own disparities at {TOOLS_FRAME}")

    # the tool's sweep under bf16_act, then a short one at highest, where a
    # batch must give batch 1's disparities within 1e-4 of the largest
    for name, per_forward in (("MADNet", {"corr_fwd": 5, "warp_features_fwd": 4}), ("Dispnet", {"corr_fwd_wide": 1})):
        for mode, iters, passes in (("bf16_act", 32, 3), ("highest", 4, 1)):
            tag = f"TOOLS_OFFLINE_{name.upper()}_{mode.upper()}"
            cuda_lib.reset_launches()
            recs = offline.run(name, offline.BATCHES, iters, passes, TOOLS_H, TOOLS_W, mode,
                               log=lambda line, tag=tag: log(f"{tag} {line}"))
            # a batch's forwards: run()'s counted one, its warm ones, its passes
            forwards = len(offline.BATCHES) * (1 + offline.WARM + iters * passes)
            launches[tag] = launched({k: v * forwards for k, v in in_precision(per_forward, mode).items()}, tag)
            for r in recs:
                ms[f"{tag}_B{r['batch']}_FRAME"] = 1e3 / r["value"]
            log(f"{tag}: frames/s by batch {[(r['batch'], r['value']) for r in recs]}; each batch's disparities "
                f"from batch 1's: {[(r['batch'], r['batch_err']) for r in recs]} ({recs[0]['batch_err_kind']}, bound "
                f"{recs[0]['batch_err_bound']}), the largest difference "
                f"{max(r['batch_max_rel_err'] for r in recs):.3g} of the largest disparity")
    assert_tf32("highest")
    log(f"phase 14 done in {time.perf_counter() - t0:.1f} s")
    return launches, ms


# ----------------------------------------------------------------- phase 15
KITTI_TABLE_HEADER = "sequence,mode,frames,avg_d1,avg_epe,fps,resets"


def fetched_blocks(out: Path) -> list:
    """The fetch counter of a run of the tool's runner: the ``fetch_counter``
    line of ``cli/adapt.py``'s stats.csv, or the last line of
    ``cli/adapt_continual.py``'s histogram.csv."""
    import ast

    stats = out / "stats.csv"
    if stats.exists():
        line = next(x for x in stats.read_text().splitlines() if x.startswith("fetch_counter,"))
        return [int(v) for v in line.split(",")[1:]]
    return list(ast.literal_eval((out / "histogram.csv").read_text().strip().splitlines()[-1]))


def kitti_run(tool, tag, argv, launches, per_frame, sampled, frames=KITTI_FRAMES):
    """``tools/torch_kitti_eval.py``'s ``main`` on ``argv``, the launch
    counters set to 0 just before and read just after: they must sum
    ``per_frame(block)`` over each sequence's frames, the blocks
    ``0, 1, .., 4, 0, ..`` in turn, or, where ``sampled``, as the run's fetch
    counter has them (``None`` for NONE and FULL). Each sequence of
    ``KITTI_SEQUENCES`` must give a row of ``frames`` frames with finite D1
    and EPE, and the table its header and rows. Returns {sequence: row}."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    args = tool.build_argparser().parse_args(argv)
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    rows = tool.main(args)
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    want = {}
    for r in rows:
        out = Path(args.output) / f"{r['sequence']}__{args.mode.lower()}"
        got = fetched_blocks(out)
        if args.mode != "MAD":
            blocks = [None] * r["frames"]
        elif sampled:
            blocks = [k for k, c in enumerate(got) for _ in range(c)]
        else:
            blocks = [i % len(got) for i in range(r["frames"])]
            if got != [blocks.count(k) for k in range(len(got))]:
                raise AssertionError(f"{tag} {r['sequence']}: fetch counter {got}, SEQUENTIAL wants {blocks}")
        if len(blocks) != r["frames"]:
            raise AssertionError(f"{tag} {r['sequence']}: {len(blocks)} blocks fetched over {r['frames']} frames")
        for k in blocks:
            for name, v in per_frame(k).items():
                want[name] = want.get(name, 0) + v
    want = {k: v for k, v in want.items() if v}
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, want {want}")
    launches[tag] = dict(cuda_lib.LAUNCHES)
    by_seq = {r["sequence"]: r for r in rows}
    if list(by_seq) != list(KITTI_SEQUENCES):
        raise AssertionError(f"{tag}: rows {rows}")
    for seq, r in by_seq.items():
        if r["frames"] != frames or r["mode"] != args.mode or not np.isfinite([r["avg_d1"], r["avg_epe"]]).all():
            raise AssertionError(f"{tag} {seq}: row {r}, want {frames} frames of finite D1 and EPE")
    table = (Path(args.output) / "kitti_table.csv").read_text().splitlines()
    if table[0] != KITTI_TABLE_HEADER or len(table) != 1 + len(rows):
        raise AssertionError(f"{tag}: kitti_table.csv {table}")
    log(f"{tag}: {[(s, r['frames'], r['avg_d1'], r['avg_epe'], r['fps'], r['resets']) for s, r in by_seq.items()]}"
        f" (sequence, frames, D1 %, EPE, FPS, resets); wall {wall:.2f} s with set-up; launches {counts}")
    return by_seq


def run_kitti_phase(state, profile_dir):
    """Phase 15: ``tools/torch_kitti_eval.py``, the papers' per-sequence
    protocol, through its ``main`` on the card over a KITTI raw layout of
    the fixture scenes at 320x1216 (:func:`write_kitti_tree`: ``city`` 16
    scored frames of one drive, ``road`` 16 of two drives under two dates),
    from ``weights_scene01.npz``. (a) The CVPR table, MADNet NONE, MAD and
    FULL, SEQUENTIAL, and (b) the TPAMI one, proxy labels, MAD SEQUENTIAL:
    each sequence's D1 within CLI_D1_BOUND points of the JAX tool's row
    (``kitti_runs`` of ``torch_cli_reference.json``), the frames equal. (c)
    The tool's defaults, MAD under PROBABILITY, the block switched on the
    device; (d) DispNet-Corr1D FULL over ``dispnet_full_6.json``, 8 frames
    a sequence, seeded weights; (e) ``--listOnly``, then a TF1 checkpoint
    (``tests/fixtures/tf1_madnet_tiny``) imported into the tool's cache, bit
    for bit, and served (NONE, 2 frames). Each run's launches counted from
    0. Returns (launches by run, ms a frame by run and sequence)."""
    import tempfile

    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import save_params

    del state, profile_dir  # the fixture's trained weights; nothing profiled
    t0 = time.perf_counter()
    reference = json.loads(CLI_REFERENCE.read_text())["kitti_runs"]
    tool = load_tool("torch_kitti_eval")
    launches, ms, rows = {}, {}, {}
    mad = lambda k: cli_launches("MAD", k)  # noqa: E731  (MADNet with the bulkhead, `cuda` warps)
    per_frame = {
        "cvpr_NONE": lambda k: cli_launches("NONE", 0),
        "cvpr_MAD": mad,
        "cvpr_FULL": lambda k: cli_launches("FULL", 0),
        "tpami_MAD": lambda k: continual_launches("MAD", k),  # the proxy loss warps no image
    }
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        tree = write_kitti_tree(tmp / "kitti")

        def run(name, proxy, flags, per, sampled=False, frames=KITTI_FRAMES, weights=CLI_WEIGHTS):
            tag = f"KITTI_{name.upper()}"
            argv = kitti_argv(tree, str(tmp / name), proxy, flags, weights)
            rows[name] = kitti_run(tool, tag, argv, launches, per, sampled, frames)
            for seq, r in rows[name].items():
                ms[f"{tag}_{seq.upper()}_FRAME"] = 1e3 / r["fps"]
            return rows[name]

        # (a), (b): against the JAX tool's rows
        for name, (proxy, flags) in KITTI_REFERENCE_RUNS.items():
            got, ref = run(name, proxy, flags, per_frame[name]), reference[name]["rows"]
            for seq, r in got.items():
                want = ref[seq]
                delta = r["avg_d1"] - want["avg_d1"]
                log(f"KITTI {name} {seq}: D1 {r['avg_d1']:.3f} vs the JAX tool's {want['avg_d1']:.3f} (delta "
                    f"{delta:+.4f}, bound {CLI_D1_BOUND}); EPE {r['avg_epe']:.3f} vs {want['avg_epe']:.3f}; resets "
                    f"{r['resets']} vs {want['resets']}; frames {r['frames']} vs {want['frames']}; "
                    f"{r['fps']:.2f} FPS")
                if r["frames"] != want["frames"] or not abs(delta) <= CLI_D1_BOUND:
                    raise AssertionError(f"KITTI {name} {seq}: {r} against the JAX tool's {want}")

        # (c) the papers' default configuration: MAD, PROBABILITY, the block picked on the device
        run("default_MAD_PROBABILITY", False, ["--mode", "MAD"], lambda k: {**mad(k), "graph_switch": 1},
            sampled=True)

        # (d) DispNet-Corr1D, FULL, 8 frames a sequence, beside MADNet's MAD
        dn_weights = tmp / "dispnet_seeded.npz"
        save_params(str(dn_weights), seeded_dispnet_params(1))
        run("dispnet_FULL", False, ["--mode", "FULL", "--modelName", "Dispnet", "--blockConfig", DN_BLOCK_CONFIG,
                                    "--maxFrames", str(KITTI_DN_FRAMES)],
            lambda k: dn_launches("FULL"), frames=KITTI_DN_FRAMES, weights=dn_weights)
        for seq in KITTI_SEQUENCES:
            dn, mn = rows["dispnet_FULL"][seq], rows["cvpr_MAD"][seq]
            log(f"KITTI {seq}, the CVPR paper's comparison on the card: DispNet-Corr1D FULL {dn['fps']:.2f} "
                f"FPS (D1 {dn['avg_d1']:.3f}, seeded weights, {dn['frames']} frames) against MADNet MAD "
                f"{mn['fps']:.2f} FPS (D1 {mn['avg_d1']:.3f}, {mn['frames']} frames)")

        # (e) --listOnly: the lists alone, nothing launched
        out = tmp / "list_only"
        cuda_lib.reset_launches()
        listed = tool.main(tool.build_argparser().parse_args(kitti_argv(tree, str(out), True, ["--listOnly"])))
        lines = {seq: len((out / f"{seq}.csv").read_text().splitlines()) for seq in KITTI_SEQUENCES}
        if listed != [] or any(cuda_lib.LAUNCHES.values()) or set(lines.values()) != {KITTI_FRAMES}:
            raise AssertionError(f"KITTI --listOnly: rows {listed}, lines {lines}, launches {dict(cuda_lib.LAUNCHES)}")
        log(f"KITTI --listOnly: lists of {lines} frames (left, right, gt, proxy), no run, nothing launched")

        # (e) the TF1 route: the checkpoint imported into the tool's cache, then served
        got = run("tf1_NONE", False, ["--mode", "NONE", "--maxFrames", "2"], per_frame["cvpr_NONE"], frames=2,
                  weights=TF1_FIXTURE / "model.ckpt")
        name_map = get_stereo_net("MADNet", device="cpu").tf_name_map()
        with np.load(TF1_FIXTURE / "values.npz") as v, np.load(tmp / "tf1_NONE" / "imported_weights.npz") as cache:
            for name in v.files:
                if not np.array_equal(cache["/".join(name_map[name])], v[name]):
                    raise AssertionError(f"KITTI TF1: {name} differs in the tool's cache")
            log(f"KITTI TF1: {len(v.files)} variables of {TF1_FIXTURE.name} in the tool's cache "
                f"imported_weights.npz ({len(cache.files)} arrays, the rest the port's seeded init) bit for bit; "
                f"served {[(s, r['frames'], r['avg_d1']) for s, r in got.items()]}")
    assert_tf32("highest")

    log("KITTI table on the card (320x1216; run, sequence, frames, D1 %, EPE, FPS, resets | the JAX tool's frames, "
        "D1, EPE, resets on the CPU):")
    for name, by_seq in rows.items():
        for seq, r in by_seq.items():
            ref = reference.get(name, {}).get("rows", {}).get(seq)
            tail = f" | {ref['frames']} {ref['avg_d1']:.3f} {ref['avg_epe']:.3f} {ref['resets']}" if ref else ""
            log(f"KITTI {name:<24} {seq:<5} {r['frames']:>3} {r['avg_d1']:>8.3f} {r['avg_epe']:>7.3f} "
                f"{r['fps']:>8.2f} {r['resets']:>3}{tail}")
    log(f"phase 15 done in {time.perf_counter() - t0:.1f} s")
    return launches, ms


# ----------------------------------------------------------------- phase 16
DRIFT_SIZES = ((96, 320), (TOOLS_H, TOOLS_W))
DRIFT_FRAMES = 50
DRIFT_PRETRAIN_STEPS = 200
DRIFT_MXU = ("bf16_act", "mxu")  # the fused serving path's warps (K6/K7), at the bench's frame


def parity_launches(mode: str, i: int, warp_mode: str):
    """What frame ``i`` of a fast run of ``run_our_loop`` (MADNet's host
    session, the bulkhead for MAD, SEQUENTIAL) must launch at fp32: K2-K5 on
    the ``auto`` (cuda) warps, K6/K7 on ``mxu``."""
    if warp_mode != "mxu":
        return cli_launches(mode, i)
    if mode == "MAD":
        return mad_tile_launches(i % 5)
    return TILE_FULL if mode == "FULL" else {"corr_fwd": 5, "warp_tile_image_fwd": 1, "warp_tile_features_fwd": 4}


def counted_parity_loop(tool, prefix: str, launches, ms):
    """``tool.run_our_loop`` for the parity tools' ``loop``: the launch
    counters set to 0 just before each run and read just after, none for an
    exact run, for a fast one the sum of :func:`parity_launches` over its
    frames in its precision's correlation instances; the TF32 flags those of
    the run's mode at every frame (``highest``'s for an exact run, after
    whatever ran before it) and ``highest``'s before and after; every row
    finite. Records the launches and ms a frame (the host's metrics
    included) under ``<prefix>_<mode>_<EXACT | precision[_warp]>``."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    def loop(mode, seq, params, fast=False, precision="default", warp_mode="auto", device=None):
        run = precision.upper() + ("" if warp_mode == "auto" else f"_{warp_mode.upper()}") if fast else "EXACT"
        tag = f"{prefix}_{mode}_{run}"
        seq = list(seq)

        def checked():
            for frame in seq:
                assert_tf32(precision if fast else "highest")
                yield frame

        assert_tf32("highest")
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        rows, resets = tool.run_our_loop(mode, checked(), params, fast=fast, precision=precision,
                                         warp_mode=warp_mode, device=device)
        wall = time.perf_counter() - t0
        want = {}
        for i in range(len(seq) if fast else 0):
            for k, v in in_precision(parity_launches(mode, i, warp_mode), precision).items():
                want[k] = want.get(k, 0) + v
        launches[tag] = launched({k: v for k, v in want.items() if v}, tag)
        assert_tf32("highest")
        if rows.shape != (len(seq), 3) or not np.isfinite(rows).all():
            raise AssertionError(f"{tag}: rows of shape {rows.shape}, finite {np.isfinite(rows).all()}")
        ms[f"{tag}_FRAME"] = 1e3 * wall / len(seq)
        log(f"{tag}: {len(seq)} frames, {ms[f'{tag}_FRAME']:.2f} ms a frame with the host's metrics, resets "
            f"{resets}; launches {({k: v for k, v in launches[tag].items() if v}) or 'none'}")
        return rows, resets

    return loop


def check_parity(name: str, results, north_star: float):
    """Phase 16 (a), (b): each mode's mean D1 within CLI_D1_BOUND points of
    the JAX loop's, the resets equal; the largest per-frame deltas and the
    north star's verdict printed."""
    for mode, r in results.items():
        ours, ref = r["rows"].mean(axis=0), r["ref_rows"].mean(axis=0)
        delta = ours[2] - ref[2]
        log(f"PARITY {name} {mode}: D1 {ours[2]:.4f} vs the JAX loop's {ref[2]:.4f} (delta {delta:+.4f}, bound "
            f"{CLI_D1_BOUND}; north star < {north_star}: {'PASS' if abs(delta) < north_star else 'FAIL'}); EPE "
            f"{ours[0]:.4f} vs {ref[0]:.4f}; largest per-frame |delta| D1 {r['max_frame_d1']:.4f}, EPE "
            f"{r['max_frame_epe']:.4f}; resets {r['resets']} vs {r['ref_resets']}")
        if not abs(delta) <= CLI_D1_BOUND or r["resets"] != r["ref_resets"]:
            raise AssertionError(f"PARITY {name} {mode}: D1 delta {delta}, resets {r['resets']} vs {r['ref_resets']}")


def run_parity_phase(state, profile_dir):
    """Phase 16: the accuracy-parity and precision-drift tools through their
    functions, each run of ``run_our_loop`` counted (:func:`counted_parity_loop`).
    (a) ``tools/torch_parity_results.py``, the synthetic sequence at 96x320,
    50 frames, and (b) ``tools/torch_realworld_parity.py``, the fixture's
    scenes 2-3 and their asym twins at 320x1216, 16 frames, each from
    ``weights_scene01.npz``, NONE, MAD and FULL exact, held to the JAX loop's
    rows (``PARITY_REFERENCE``, :func:`check_parity`). (c) ``--drift`` at
    96x320 and 384x1280, 50 frames, from MADNet pretrained for 200 steps at
    the run's size: each mode exact, then fast on the ``auto`` warps in
    ``default``, ``bf16`` and ``bf16_act``, at 384x1280 also ``bf16_act`` on
    ``mxu``; the drift is printed against the 0.1-point promotion bound, a
    reading and not a check. Returns (launches by run, ms a frame by run)."""
    del state, profile_dir  # the fixture's weights, or pretrained ones; nothing profiled
    t0 = time.perf_counter()
    parity = load_tool("torch_parity_results")
    realworld = load_tool("torch_realworld_parity")
    launches, ms = {}, {}

    # (a), (b): exact, against the JAX loop's rows
    for name, (kind, h, w, frames, scenes, weights) in PARITY_SETS.items():
        if weights is None:  # the CPU tests' set
            continue
        tool = parity if kind == "synthetic" else realworld
        argv = ["--height", str(h), "--width", str(w), "--frames", str(frames), "--paramsNpz", str(weights),
                "--reference", str(PARITY_REFERENCE)]
        argv += ["--scenes", ",".join(scenes), "--full"] if scenes else []
        t1 = time.perf_counter()
        run = tool.main_parity if kind == "synthetic" else tool.main_realworld
        section, results = run(tool.build_argparser().parse_args(argv),
                               loop=counted_parity_loop(parity, f"PARITY_{name.upper()}", launches, ms))
        log(section)
        check_parity(name, results, parity.NORTH_STAR)
        log(f"PARITY {name}: {time.perf_counter() - t1:.1f} s")

    # (c) the drift of the fast path, a reading of the precision modes
    for h, w in DRIFT_SIZES:
        t1 = time.perf_counter()
        runs = parity.DRIFT_RUNS + ((DRIFT_MXU,) if (h, w) == (TOOLS_H, TOOLS_W) else ())
        args = parity.build_argparser().parse_args(
            ["--drift", "--height", str(h), "--width", str(w), "--frames", str(DRIFT_FRAMES),
             "--pretrainSteps", str(DRIFT_PRETRAIN_STEPS)])
        section, results = parity.main_drift(args, runs=runs,
                                             loop=counted_parity_loop(parity, f"DRIFT_{h}X{w}", launches, ms))
        log(section)
        for mode, r in results.items():
            for label, d in r["drift"].items():
                log(f"DRIFT {h}x{w} {label} {mode}: D1 {d[2]:+.4f} points, EPE {d[0]:+.5f} (promotion bound "
                    f"{parity.PROMOTION_BOUND}: {'within' if abs(d[2]) <= parity.PROMOTION_BOUND else 'beyond'}; "
                    "a reading of the precision mode, not a check: the phase does not fail on it)")
        log(f"DRIFT {h}x{w}: {time.perf_counter() - t1:.1f} s, pretraining included")
    assert_tf32("highest")
    log(f"phase 16 done in {time.perf_counter() - t0:.1f} s")
    return launches, ms


def profile_frames(session, frames, out: Path, tag: str):
    """Kernel time by name over a few steady frames (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for f in frames:
            session.step(f)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=45)
    (out / f"profile_{tag}_frame.txt").write_text(table)
    trace = out / f"profile_{tag}_frame.json"
    prof.export_chrome_trace(str(trace))
    log(f"profile of {len(frames)} {tag} frames")
    log(table)
    summarise_trace(trace, tag, len(frames))


_GROUPS = (  # first match wins
    ("the port's kernels",
     r"corr_fwd|corr_bwd|warp_fwd_kernel|feat_gather_fwd|warp_bwd_|feat_bwd_|tile_image_fwd|tile_feat_fwd|tile_bwd_"),
    ("cuDNN backward (dgrad, wgrad)", r"dgrad|wgrad"),
    ("cuDNN/cuBLAS convolutions and matmuls, incl. FFT and layout transforms",
     r"fprop|convolve|region_transform|fft|DSE::|gemm|gemv|cudnn|flip_filter|xmma|cutlass"),
    ("PyTorch elementwise, reduce, pad, cat, copy", r"."),
)


def summarise_trace(trace: Path, tag: str, n_frames: int):
    """Device time a frame by kind of kernel (``utils.profiling.summarize_trace``'s
    op families, grouped), and the host's side, from the Chrome trace that
    torch.profiler wrote."""
    from real_time_self_adaptive_deep_stereo_torch.utils.profiling import summarize_trace

    groups, ours = {}, {}
    for family, n, ms in summarize_trace(str(trace), top=None):
        if family.startswith(("Memcpy", "Memset")):
            name = "memcpy and memset (the frame's upload from pageable memory)"
        else:
            name = next(g for g, pat in _GROUPS if re.search(pat, family))
            if name == _GROUPS[0][0]:  # the port's kernels, by kernel and instance
                ours[family] = (n, ms)
        count, total_ms = groups.get(name, (0, 0.0))
        groups[name] = (count + n, total_ms + ms)
    total = sum(ms for _, ms in groups.values())
    log(f"profile {tag}: device time {total / n_frames:.3f} ms/frame in "
        f"{sum(n for n, _ in groups.values()) / n_frames:.0f} launches/frame")
    for name, (n, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        log(f"profile {tag}: {ms / n_frames:8.3f} ms/frame {100 * ms / total:5.1f}% "
            f"{n / n_frames:7.1f} launches/frame  {name}")
    for name, (n, ms) in sorted(ours.items(), key=lambda kv: -kv[1][1]):
        log(f"profile {tag}:   {ms / n_frames:8.4f} ms/frame {n / n_frames:5.1f} launches/frame  {name}")
    events = [e for e in json.loads(trace.read_text())["traceEvents"] if e.get("ph") == "X"]
    cpu = [e for e in events if e.get("cat") == "cpu_op"]
    span = max(e["ts"] + e["dur"] for e in cpu) - min(e["ts"] for e in cpu)
    by_thread = {}
    for e in cpu:
        by_thread.setdefault(e["tid"], []).append(e)
    busy = []  # per thread: time inside top-level ops (the autograd thread is the second)
    for es in by_thread.values():
        end = t = 0.0
        for e in sorted(es, key=lambda e: (e["ts"], -e["dur"])):
            if e["ts"] >= end:
                t += e["dur"]
                end = e["ts"] + e["dur"]
        busy.append(t / 1e3 / n_frames)
    log(f"profile {tag}: host span under the profiler {span / 1e3 / n_frames:.2f} ms/frame, "
        f"{len(cpu) / n_frames:.0f} PyTorch ops/frame, busy per thread {sorted(busy, reverse=True)} ms/frame")


# ------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default=None, help="write torch.profiler tables and traces here")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernels' checks (phase 3), without the result lines")
    ap.add_argument("--fused-only", action="store_true",
                    help="run the fused-session phase (6) alone, without the result lines")
    ap.add_argument("--dispnet-only", action="store_true",
                    help="run the DispNet phase (7) alone, without the result lines")
    ap.add_argument("--precision-only", action="store_true",
                    help="check the bf16 kernels and run the precision phase (8) alone, "
                         "without the result lines")
    ap.add_argument("--cli-only", action="store_true",
                    help="run the CLI phase (9) alone, without the result lines")
    ap.add_argument("--train-only", action="store_true",
                    help="run the continual-adaptation and training phase (10) alone, without the result lines")
    ap.add_argument("--demo-only", action="store_true",
                    help="run the live demo's phase (11) alone, without the result lines")
    ap.add_argument("--parallel-only", action="store_true",
                    help="run the streams' and data-parallel phase (12) alone, without the result lines")
    ap.add_argument("--spatial-only", action="store_true",
                    help="run the batched streams' and width sharding's phase (13) alone, without the result lines")
    ap.add_argument("--tools-only", action="store_true",
                    help="check the kernels at the tools' 384x1280 and run the tools' phase (14) alone, "
                         "without the result lines")
    ap.add_argument("--kitti-only", action="store_true",
                    help="run the KITTI protocol runner's phase (15) alone, without the result lines")
    ap.add_argument("--parity-only", action="store_true",
                    help="run the parity and drift tools' phase (16) alone, without the result lines")
    ap.add_argument("--dp-rank", type=int, default=None, help=argparse.SUPPRESS)  # a rank of phase 12 or 13
    ap.add_argument("--dp-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.dp_rank is not None:
        return dp_rank_main(args.dp_rank, Path(args.dp_dir))
    t_script = time.perf_counter()

    from real_time_self_adaptive_deep_stereo_torch import ops
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import params_from_jax
    from real_time_self_adaptive_deep_stereo_torch.utils.device import resolve_device

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    resolve_device("cuda")  # sets TF32 off for cuDNN and cuBLAS
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; tf32 matmul/cudnn {tf32}")
    if any(tf32):
        raise AssertionError("TF32 must be off")

    t0 = time.perf_counter()
    cuda_lib.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(cuda_lib.BUILD_LOGS) or 'cached'}")
    for name, text in cuda_lib.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    for lib, kernel in (("correlation", "corr_fwd_kernel"), ("correlation", "corr_bwd_kernel"),
                        ("warp_tile", "tile_image_fwd_kernel"), ("warp_tile", "tile_feat_fwd_kernel"),
                        ("warp_tile", "tile_bwd_offset_kernel"), ("warp_tile", "tile_bwd_source_kernel"),
                        ("warp", "feat_bwd_offset_kernel"), ("warp", "feat_bwd_source_kernel"),
                        ("warp", "warp_bwd_offset_kernel"), ("warp", "warp_bwd_source_kernel"),
                        ("correlation", "corr_fwd_wide_kernel"), ("correlation", "corr_bwd_wide_kernel")):
        usage = cuda_lib.ptxas_usage(cuda_lib.BUILD_LOGS.get(lib, ""), kernel) or ["cached build, no report"]
        log(f"ptxas {kernel}: {'; '.join(usage)}")

    if args.precision_only:
        rows = {name: [] for name in REPLACES}
        check_bf16_kernels(ops, rows)
        for name, rs in rows.items():
            for r in rs:
                log(f"kernel {name} {r}")
        _, frame_ms = run_precision(params_from_jax(seeded_jax_params(0)), args.profile)
        for mode, ms in frame_ms.items():
            log(f"session {mode} ms/frame {ms!r}")
        log(card)
        log("precision checked; no result lines (--precision-only)")
        return 0
    if args.cli_only or args.train_only or args.demo_only or args.kitti_only or args.parity_only:
        phase = (run_cli_phase if args.cli_only else run_train_phase if args.train_only
                 else run_demo_phase if args.demo_only else run_kitti_phase if args.kitti_only
                 else run_parity_phase)
        _, frame_ms = phase(None, args.profile)
        for path, ms in frame_ms.items():
            log(f"session {path} ms {ms!r}")
        log(card)
        log("CLIs checked; no result lines (--cli-only, --train-only, --demo-only, --kitti-only, --parity-only)")
        return 0
    if args.parallel_only:
        rows = {name: [] for name in REPLACES}
        check_batch_kernels(ops, rows, DP_BATCH // DP_WORLD)
        for name, rs in rows.items():
            for r in rs:
                r["bound_ms"], r["bound_by"] = r.pop("bound")
                log(f"kernel {name} {r}")
        _, frame_ms = run_parallel(params_from_jax(seeded_jax_params(0)), args.profile)
        for path, ms in frame_ms.items():
            log(f"session {path} ms {ms!r}")
        log(card)
        log("streams and data-parallel training checked; no result lines (--parallel-only)")
        return 0
    if args.spatial_only:
        rows = {name: [] for name in REPLACES}
        for n in VMAP_COUNTS:
            check_vmap_kernels(rows, n)
        check_rank_wide_kernels(ops, rows)
        for name, rs in rows.items():
            for r in rs:
                r["bound_ms"], r["bound_by"] = r.pop("bound")
                log(f"kernel {name} {r}")
        _, frame_ms = run_phase13(params_from_jax(seeded_jax_params(0)), args.profile)
        for path, ms in frame_ms.items():
            log(f"session {path} ms {ms!r}")
        log(card)
        log("batched streams and width sharding checked; no result lines (--spatial-only)")
        return 0
    if args.tools_only:
        rows = {name: [] for name in REPLACES}
        check_tool_kernels(ops, rows)
        log_kernel_rows(rows)
        _, frame_ms = run_tools_phase(None, args.profile)
        for path, ms in frame_ms.items():
            log(f"session {path} ms {ms!r}")
        log(card)
        log("the tools checked; no result lines (--tools-only)")
        return 0
    if args.fused_only or args.dispnet_only:
        if args.fused_only:
            _, frame_ms = run_fused(params_from_jax(seeded_jax_params(0)), args.profile)
        else:
            _, frame_ms = run_dispnet(args.profile)
        for mode, ms in frame_ms.items():
            log(f"session {mode} ms/frame {ms!r}")
        log("sessions checked; no result lines (--fused-only, --dispnet-only)")
        return 0
    rows = check_kernels(ops)
    if args.kernels_only:
        log("kernels checked; stopping before the sessions (--kernels-only)")
        return 0

    state = params_from_jax(seeded_jax_params(0))
    launches, frame_ms = {}, {}
    for mode, run in (("NONE", run_none), ("MAD", run_mad), ("FULL", run_full)):
        launches[mode], frame_ms[mode] = run(state, args.profile)
    check_steps_against_plain(state)
    check_reset(state)
    for phase in (run_fused, lambda _, profile: run_dispnet(profile), run_precision, run_cli_phase,
                  run_train_phase, run_demo_phase, run_parallel, run_phase13, run_tools_phase, run_kitti_phase,
                  run_parity_phase):
        phase_launches, phase_ms = phase(state, args.profile)
        launches.update(phase_launches)
        frame_ms.update(phase_ms)

    kernels = []
    for name, all_rs in rows.items():
        # batch 1, no vmap, the whole frame: the sums keep their meaning
        rs = main_rows(all_rs)
        lib_ms = [r["library_ms"] for r in rs]
        shape_keys = ("ranks", "frame", "shape", "radius", "ms", "cold_ms", "call_ms", "fp32_ms", "plain_ms", "bound_ms",
                      "library_ms", "variants", "wide_ms")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            # every path driven, MADNet's and DispNet's, host and fused, the
            # counters set to 0 before each and read after it
            "launches": sum(launches[path][name] for path in launches),
            "launches_by_path": {path: launches[path][name] for path in launches},
            "max_abs_err": max(r["err"] for r in all_rs),
            # one call at each main-path shape: the sums over the shapes
            "ms": sum(r["ms"] for r in rs),
            # K1, its backward and the warp backward: the same with the L2 cold
            **({"cold_ms": sum(r["cold_ms"] for r in rs)} if "cold_ms" in rs[0] else {}),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rs) else "operations",
            "library_ms": None if None in lib_ms else sum(lib_ms),
            # warp backward kernels: each variant (the gradients asked for)
            # summed over the shapes, and the variant each mode runs
            **({"variants": summed_variants(rs), "modes": rs[0]["modes"]} if "variants" in rs[0] else {}),
            # bf16 instances: the fp32 instance's time at the same shapes
            **({"fp32_ms": sum(r["fp32_ms"] for r in rs)} if "fp32_ms" in rs[0] else {}),
            # at the batch of cli/evaluate.py and cli/train.py (4) and of a
            # data-parallel rank (2): the same sums over those shapes
            **{f"batch{b}": {
                **{k: sum(r[k] for r in batch) for k in ("ms", "plain_ms", "bound_ms")},
                "library_ms": None if any(r["library_ms"] is None for r in batch)
                else sum(r["library_ms"] for r in batch),
            } for b, batch in by_batch(all_rs).items()},
            # under vmap over n streams ([n, 1, ...], one launch): the same sums
            **{f"vmap{n}": {
                **{k: sum(r[k] for r in vr) for k in ("ms", "plain_ms", "bound_ms")},
                "library_ms": None if any(r["library_ms"] is None for r in vr)
                else sum(r["library_ms"] for r in vr),
            } for n in VMAP_COUNTS for vr in [[r for r in all_rs if r.get("vmap") == n]] if vr},
            # on a rank of a width-sharded frame (phase 13's DispNet): the same sums
            **{f"ranks{SP_WORLD}": {
                **{k: sum(r[k] for r in rr) for k in ("ms", "plain_ms", "bound_ms")},
                "library_ms": None,
            } for rr in [[r for r in all_rs if "ranks" in r]] if rr},
            # at batch 1 on the tools' frame (phase 14): the same sums
            **{f"frame{TOOLS_FRAME}": {
                **{k: sum(r[k] for r in fr) for k in ("ms", "plain_ms", "bound_ms")},
                "library_ms": None if any(r["library_ms"] is None for r in fr)
                else sum(r["library_ms"] for r in fr),
            } for fr in [[r for r in all_rs if r.get("frame") == TOOLS_FRAME and "batch" not in r]] if fr},
            "shapes": [{k: r[k] for k in ("batch", *shape_keys) if k in r} for r in all_rs],
        })
    idle = [k["name"] for k in kernels if not any(k["launches_by_path"].values())]
    if idle:
        raise AssertionError(f"no main path launched {idle}")
    for mode, ms in frame_ms.items():
        log(f"session {mode} ms/frame {ms!r}")
    log(f"every phase done in {time.perf_counter() - t_script:.1f} s, the build included")
    log(card)  # name, power limit
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
